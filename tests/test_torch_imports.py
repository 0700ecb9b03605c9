"""The port stands alone: no module of nfai_tpu_torch, and not chip_smoke.py,
imports JAX or anything of the JAX package (nfai_tpu), directly or through
another module. Checked in a fresh interpreter, so this test process's own
JAX import cannot hide or cause a hit."""
import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "nfai_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_every_port_module_imports_without_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import nfai_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(nfai_tpu_torch.__path__, 'nfai_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(json.dumps({'modules': names, 'loaded': sorted(sys.modules)}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"nfai_tpu_torch.ops.fused_mlp", "nfai_tpu_torch.ops.qmatmul",
            "nfai_tpu_torch.models.llama", "nfai_tpu_torch.cli",
            "nfai_tpu_torch.runtime.paged_cache", "nfai_tpu_torch.runtime.scheduler",
            "nfai_tpu_torch.ops.paged_attention", "nfai_tpu_torch.server",
            "nfai_tpu_torch.testing", "nfai_tpu_torch.models.registry",
            "nfai_tpu_torch.tokenizer.spm", "nfai_tpu_torch.eval",
            "nfai_tpu_torch.grammar", "nfai_tpu_torch.constrained",
            "nfai_tpu_torch.tools", "nfai_tpu_torch.gguf.native"} <= set(res["modules"])
    assert [m for m in res["loaded"] if _forbidden(m)] == []


def _imported(path: Path) -> set[str]:
    """Every module an import statement of `path` names, those inside
    functions included (absolute names; relative imports stay in the port)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def test_chip_smoke_imports_no_jax():
    names = _imported(ROOT / "chip_smoke.py")
    assert "nfai_tpu_torch.models" in names  # the walk sees the imports inside functions
    assert sorted(n for n in names if _forbidden(n)) == []


def test_no_port_source_imports_jax_even_inside_a_function():
    """The import-time check above cannot see an import that runs only when
    a function is called (eval.main's, the kernels' build functions)."""
    files = sorted((ROOT / "nfai_tpu_torch").rglob("*.py"))
    assert ROOT / "nfai_tpu_torch" / "eval.py" in files
    hits = {str(f.relative_to(ROOT)): sorted(n for n in _imported(f) if _forbidden(n)) for f in files}
    assert {f: n for f, n in hits.items() if n} == {}
