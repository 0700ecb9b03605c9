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
            "nfai_tpu_torch.models.llama", "nfai_tpu_torch.cli"} <= set(res["modules"])
    assert [m for m in res["loaded"] if _forbidden(m)] == []


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert "nfai_tpu_torch.models" in names  # the walk sees the imports inside functions
    assert sorted(n for n in names if _forbidden(n)) == []
