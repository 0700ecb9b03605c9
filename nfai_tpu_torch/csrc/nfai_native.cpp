// nfai_tpu_torch native host library: multithreaded GGUF block dequantization.
//
// The port's copy of the JAX package's native/nfai_native.cpp (the port
// imports nothing of that package and builds its own library). The GPU
// compute path is the CUDA kernels of this directory; this library is the
// host side of a model load: the reader decodes every tensor the load does
// not keep quantized (norms, biases, untied token tables, dense weights)
// with one parallel pass per tensor.
//
// A plain C ABI, loaded with ctypes by nfai_tpu_torch/gguf/native.py, which
// builds it at first use with g++ into nfai_tpu_torch/_build/. Semantics
// mirror nfai_tpu_torch/gguf/quants.py (which mirrors ggml) bit for bit;
// the build passes -ffp-contract=off so that no a*b - c product is fused
// into an FMA, which would round differently from the numpy codecs.
//
// Changes against the JAX copy: every per-type loop takes its parallel
// region only outside one (`if(!omp_in_parallel())`), so the per-row calls
// of nfai_dequant_transpose run serially inside its own region whatever
// OMP_MAX_ACTIVE_LEVELS says, instead of nesting a team per row.

#include <cstdint>
#include <cstring>
#include <cmath>

#if defined(_OPENMP)
#include <omp.h>
#define NFAI_PARALLEL_FOR _Pragma("omp parallel for schedule(static) if(!omp_in_parallel())")
#else
#define NFAI_PARALLEL_FOR
#endif

namespace {

inline float f16_to_f32(uint16_t h) {
    // IEEE half -> float (handles subnormals and inf/nan)
    uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t mant = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (mant == 0) {
            bits = sign;
        } else {  // subnormal: normalize
            // value = mant * 2^-24; with the leading 1 shifted up to bit 10
            // the f32 biased exponent is 127 - 24 + (10 - shift) = 113 - shift
            int shift = 0;
            while (!(mant & 0x400)) { mant <<= 1; ++shift; }
            mant &= 0x3FF;
            bits = sign | ((uint32_t)(113 - shift) << 23) | (mant << 13);
        }
    } else if (exp == 31) {
        bits = sign | 0x7F800000u | (mant << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    float out;
    std::memcpy(&out, &bits, sizeof(out));
    return out;
}

inline float bf16_to_f32(uint16_t h) {
    uint32_t bits = (uint32_t)h << 16;
    float out;
    std::memcpy(&out, &bits, sizeof(out));
    return out;
}

// 6-bit scale/min unpack for Q4_K / Q5_K (ggml get_scale_min_k4)
inline void scale_min_k4(int j, const uint8_t* q, uint8_t* sc, uint8_t* m) {
    if (j < 4) {
        *sc = q[j] & 63;
        *m = q[j + 4] & 63;
    } else {
        *sc = (q[j + 4] & 0x0F) | ((q[j - 4] >> 6) << 4);
        *m = (q[j + 4] >> 4) | ((q[j] >> 6) << 4);
    }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// simple dtypes

void nfai_dequant_f16(const uint8_t* src, float* dst, int64_t n) {
    const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
NFAI_PARALLEL_FOR
    for (int64_t i = 0; i < n; ++i) dst[i] = f16_to_f32(s[i]);
}

void nfai_dequant_bf16(const uint8_t* src, float* dst, int64_t n) {
    const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
NFAI_PARALLEL_FOR
    for (int64_t i = 0; i < n; ++i) dst[i] = bf16_to_f32(s[i]);
}

// ---------------------------------------------------------------------------
// 32-element blocks

void nfai_dequant_q8_0(const uint8_t* src, float* dst, int64_t n) {
    const int64_t nb = n / 32;
NFAI_PARALLEL_FOR
    for (int64_t b = 0; b < nb; ++b) {
        const uint8_t* p = src + b * 34;
        const float d = f16_to_f32(*reinterpret_cast<const uint16_t*>(p));
        const int8_t* q = reinterpret_cast<const int8_t*>(p + 2);
        float* o = dst + b * 32;
        for (int i = 0; i < 32; ++i) o[i] = d * q[i];
    }
}

void nfai_dequant_q4_0(const uint8_t* src, float* dst, int64_t n) {
    const int64_t nb = n / 32;
NFAI_PARALLEL_FOR
    for (int64_t b = 0; b < nb; ++b) {
        const uint8_t* p = src + b * 18;
        const float d = f16_to_f32(*reinterpret_cast<const uint16_t*>(p));
        const uint8_t* q = p + 2;
        float* o = dst + b * 32;
        for (int i = 0; i < 16; ++i) {
            o[i] = d * (int)((q[i] & 0x0F) - 8);
            o[i + 16] = d * (int)((q[i] >> 4) - 8);
        }
    }
}

void nfai_dequant_q4_1(const uint8_t* src, float* dst, int64_t n) {
    const int64_t nb = n / 32;
NFAI_PARALLEL_FOR
    for (int64_t b = 0; b < nb; ++b) {
        const uint8_t* p = src + b * 20;
        const float d = f16_to_f32(*reinterpret_cast<const uint16_t*>(p));
        const float m = f16_to_f32(*reinterpret_cast<const uint16_t*>(p + 2));
        const uint8_t* q = p + 4;
        float* o = dst + b * 32;
        for (int i = 0; i < 16; ++i) {
            o[i] = d * (q[i] & 0x0F) + m;
            o[i + 16] = d * (q[i] >> 4) + m;
        }
    }
}

void nfai_dequant_q5_0(const uint8_t* src, float* dst, int64_t n) {
    const int64_t nb = n / 32;
NFAI_PARALLEL_FOR
    for (int64_t b = 0; b < nb; ++b) {
        const uint8_t* p = src + b * 22;
        const float d = f16_to_f32(*reinterpret_cast<const uint16_t*>(p));
        uint32_t qh;
        std::memcpy(&qh, p + 2, 4);
        const uint8_t* q = p + 6;
        float* o = dst + b * 32;
        for (int i = 0; i < 16; ++i) {
            const int hb_lo = (qh >> i) & 1;
            const int hb_hi = (qh >> (i + 16)) & 1;
            o[i] = d * (((q[i] & 0x0F) | (hb_lo << 4)) - 16);
            o[i + 16] = d * (((q[i] >> 4) | (hb_hi << 4)) - 16);
        }
    }
}

void nfai_dequant_q5_1(const uint8_t* src, float* dst, int64_t n) {
    const int64_t nb = n / 32;
NFAI_PARALLEL_FOR
    for (int64_t b = 0; b < nb; ++b) {
        const uint8_t* p = src + b * 24;
        const float d = f16_to_f32(*reinterpret_cast<const uint16_t*>(p));
        const float m = f16_to_f32(*reinterpret_cast<const uint16_t*>(p + 2));
        uint32_t qh;
        std::memcpy(&qh, p + 4, 4);
        const uint8_t* q = p + 8;
        float* o = dst + b * 32;
        for (int i = 0; i < 16; ++i) {
            const int hb_lo = (qh >> i) & 1;
            const int hb_hi = (qh >> (i + 16)) & 1;
            o[i] = d * ((q[i] & 0x0F) | (hb_lo << 4)) + m;
            o[i + 16] = d * ((q[i] >> 4) | (hb_hi << 4)) + m;
        }
    }
}

// ---------------------------------------------------------------------------
// K-quants (256-element super-blocks)

void nfai_dequant_q4_k(const uint8_t* src, float* dst, int64_t n) {
    const int64_t nb = n / 256;
NFAI_PARALLEL_FOR
    for (int64_t b = 0; b < nb; ++b) {
        const uint8_t* p = src + b * 144;
        const float d = f16_to_f32(*reinterpret_cast<const uint16_t*>(p));
        const float dmin = f16_to_f32(*reinterpret_cast<const uint16_t*>(p + 2));
        const uint8_t* scales = p + 4;
        const uint8_t* q = p + 16;
        float* o = dst + b * 256;
        for (int j = 0; j < 4; ++j) {  // 64 elements per chunk
            uint8_t sc1, m1, sc2, m2;
            scale_min_k4(2 * j, scales, &sc1, &m1);
            scale_min_k4(2 * j + 1, scales, &sc2, &m2);
            const float d1 = d * sc1, mm1 = dmin * m1;
            const float d2 = d * sc2, mm2 = dmin * m2;
            const uint8_t* qc = q + 32 * j;
            float* oc = o + 64 * j;
            for (int l = 0; l < 32; ++l) {
                oc[l] = d1 * (qc[l] & 0x0F) - mm1;
                oc[l + 32] = d2 * (qc[l] >> 4) - mm2;
            }
        }
    }
}

void nfai_dequant_q5_k(const uint8_t* src, float* dst, int64_t n) {
    const int64_t nb = n / 256;
NFAI_PARALLEL_FOR
    for (int64_t b = 0; b < nb; ++b) {
        const uint8_t* p = src + b * 176;
        const float d = f16_to_f32(*reinterpret_cast<const uint16_t*>(p));
        const float dmin = f16_to_f32(*reinterpret_cast<const uint16_t*>(p + 2));
        const uint8_t* scales = p + 4;
        const uint8_t* qh = p + 16;
        const uint8_t* q = p + 48;
        float* o = dst + b * 256;
        for (int j = 0; j < 4; ++j) {
            uint8_t sc1, m1, sc2, m2;
            scale_min_k4(2 * j, scales, &sc1, &m1);
            scale_min_k4(2 * j + 1, scales, &sc2, &m2);
            const float d1 = d * sc1, mm1 = dmin * m1;
            const float d2 = d * sc2, mm2 = dmin * m2;
            const uint8_t* qc = q + 32 * j;
            float* oc = o + 64 * j;
            const uint8_t u1 = 1u << (2 * j), u2 = 2u << (2 * j);
            for (int l = 0; l < 32; ++l) {
                oc[l] = d1 * ((qc[l] & 0x0F) + ((qh[l] & u1) ? 16 : 0)) - mm1;
                oc[l + 32] = d2 * ((qc[l] >> 4) + ((qh[l] & u2) ? 16 : 0)) - mm2;
            }
        }
    }
}

void nfai_dequant_q6_k(const uint8_t* src, float* dst, int64_t n) {
    const int64_t nb = n / 256;
NFAI_PARALLEL_FOR
    for (int64_t b = 0; b < nb; ++b) {
        const uint8_t* p = src + b * 210;
        const uint8_t* ql = p;
        const uint8_t* qh = p + 128;
        const int8_t* sc = reinterpret_cast<const int8_t*>(p + 192);
        const float d = f16_to_f32(*reinterpret_cast<const uint16_t*>(p + 208));
        float* o = dst + b * 256;
        for (int half = 0; half < 2; ++half) {
            const uint8_t* qlh = ql + 64 * half;
            const uint8_t* qhh = qh + 32 * half;
            const int8_t* sch = sc + 8 * half;
            float* oh = o + 128 * half;
            for (int l = 0; l < 32; ++l) {
                const int q1 = (int)((qlh[l] & 0x0F) | (((qhh[l] >> 0) & 3) << 4)) - 32;
                const int q2 = (int)((qlh[l + 32] & 0x0F) | (((qhh[l] >> 2) & 3) << 4)) - 32;
                const int q3 = (int)((qlh[l] >> 4) | (((qhh[l] >> 4) & 3) << 4)) - 32;
                const int q4 = (int)((qlh[l + 32] >> 4) | (((qhh[l] >> 6) & 3) << 4)) - 32;
                oh[l] = d * sch[l / 16] * q1;
                oh[l + 32] = d * sch[2 + l / 16] * q2;
                oh[l + 64] = d * sch[4 + l / 16] * q3;
                oh[l + 96] = d * sch[6 + l / 16] * q4;
            }
        }
    }
}

void nfai_dequant_q2_k(const uint8_t* src, float* dst, int64_t n) {
    const int64_t nb = n / 256;
NFAI_PARALLEL_FOR
    for (int64_t b = 0; b < nb; ++b) {
        const uint8_t* p = src + b * 84;
        const uint8_t* scales = p;
        const uint8_t* q = p + 16;
        const float d = f16_to_f32(*reinterpret_cast<const uint16_t*>(p + 80));
        const float dmin = f16_to_f32(*reinterpret_cast<const uint16_t*>(p + 82));
        float* o = dst + b * 256;
        int is = 0;
        for (int half = 0; half < 2; ++half) {
            const uint8_t* qc = q + 32 * half;
            for (int shift = 0; shift < 4; ++shift) {
                for (int part = 0; part < 2; ++part) {
                    const uint8_t s8 = scales[is++];
                    const float dl = d * (s8 & 0x0F);
                    const float ml = dmin * (s8 >> 4);
                    float* oo = o + 128 * half + 32 * shift + 16 * part;
                    const uint8_t* qq = qc + 16 * part;
                    for (int l = 0; l < 16; ++l)
                        oo[l] = dl * ((qq[l] >> (2 * shift)) & 3) - ml;
                }
            }
        }
    }
}

void nfai_dequant_q3_k(const uint8_t* src, float* dst, int64_t n) {
    constexpr uint32_t kmask1 = 0x03030303u, kmask2 = 0x0F0F0F0Fu;
    const int64_t nb = n / 256;
NFAI_PARALLEL_FOR
    for (int64_t b = 0; b < nb; ++b) {
        const uint8_t* p = src + b * 110;
        const uint8_t* hm = p;
        const uint8_t* q = p + 32;
        const float d = f16_to_f32(*reinterpret_cast<const uint16_t*>(p + 108));
        uint32_t aux[4];
        std::memcpy(aux, p + 96, 12);
        uint32_t tmp = aux[2];
        aux[2] = ((aux[0] >> 4) & kmask2) | (((tmp >> 4) & kmask1) << 4);
        aux[3] = ((aux[1] >> 4) & kmask2) | (((tmp >> 6) & kmask1) << 4);
        aux[0] = (aux[0] & kmask2) | (((tmp >> 0) & kmask1) << 4);
        aux[1] = (aux[1] & kmask2) | (((tmp >> 2) & kmask1) << 4);
        const int8_t* scales = reinterpret_cast<const int8_t*>(aux);
        float* o = dst + b * 256;
        int is = 0;
        uint8_t m = 1;
        for (int half = 0; half < 2; ++half) {
            const uint8_t* qc = q + 32 * half;
            for (int shift = 0; shift < 4; ++shift) {
                for (int part = 0; part < 2; ++part) {
                    const float dl = d * (scales[is++] - 32);
                    float* oo = o + 128 * half + 32 * shift + 16 * part;
                    const uint8_t* qq = qc + 16 * part;
                    const uint8_t* hh = hm + 16 * part;
                    for (int l = 0; l < 16; ++l) {
                        const int v = (int)((qq[l] >> (2 * shift)) & 3) -
                                      ((hh[l] & m) ? 0 : 4);
                        oo[l] = dl * v;
                    }
                }
                m <<= 1;
            }
        }
    }
}

void nfai_dequant_q8_k(const uint8_t* src, float* dst, int64_t n) {
    const int64_t nb = n / 256;
NFAI_PARALLEL_FOR
    for (int64_t b = 0; b < nb; ++b) {
        const uint8_t* p = src + b * 292;
        float d;
        std::memcpy(&d, p, 4);
        const int8_t* q = reinterpret_cast<const int8_t*>(p + 4);
        float* o = dst + b * 256;
        for (int i = 0; i < 256; ++i) o[i] = d * q[i];
    }
}

// ---------------------------------------------------------------------------
// fused dequant + transpose: GGUF row-major (out, in) -> (in, out) f32
// (the layout model weights are stored in on device; saves a second pass)

typedef void (*dequant_fn)(const uint8_t*, float*, int64_t);

void nfai_dequant_transpose(
    int32_t type_id,
    const uint8_t* src,
    float* dst,          // [k_in, n_out] output
    int64_t n_out,
    int64_t k_in,
    int64_t row_bytes    // bytes per (quantized) source row
) {
    dequant_fn fn = nullptr;
    switch (type_id) {
        case 1: fn = nfai_dequant_f16; break;
        case 2: fn = nfai_dequant_q4_0; break;
        case 3: fn = nfai_dequant_q4_1; break;
        case 6: fn = nfai_dequant_q5_0; break;
        case 7: fn = nfai_dequant_q5_1; break;
        case 8: fn = nfai_dequant_q8_0; break;
        case 10: fn = nfai_dequant_q2_k; break;
        case 11: fn = nfai_dequant_q3_k; break;
        case 12: fn = nfai_dequant_q4_k; break;
        case 13: fn = nfai_dequant_q5_k; break;
        case 14: fn = nfai_dequant_q6_k; break;
        case 15: fn = nfai_dequant_q8_k; break;
        case 30: fn = nfai_dequant_bf16; break;
        default: return;  // caller validates; 0 (=F32) handled in python
    }
#pragma omp parallel
    {
        float* row = new float[k_in];
#pragma omp for schedule(static)
        for (int64_t r = 0; r < n_out; ++r) {
            fn(src + r * row_bytes, row, k_in);
            float* col = dst + r;
            for (int64_t c = 0; c < k_in; ++c) col[c * n_out] = row[c];
        }
        delete[] row;
    }
}

int32_t nfai_num_threads(void) {
#if defined(_OPENMP)
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
