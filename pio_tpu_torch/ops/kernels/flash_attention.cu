// Blockwise online-softmax attention forward (flash attention), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` -> `_flash_kernel`
// (pio_tpu/ops/attention.py):
//
//   o[b, i, h] = sum_j p_ij v[b, j, h] / sum_j p_ij,
//   p_ij = exp(s_ij - max_j s_ij),  s_ij = (scale * q[b, i, h]) . k[b, j, h]
//
// over the keys j that row i may see: j < Sk and, when causal, j <= i (the
// mask is aligned top-left, also when Sq != Sk). q (B, Sq, H, D) and k, v
// (B, Sk, H, D) are f32 or bf16, read through their strides (the
// transformer block hands in views of one qkv tensor, so nothing is
// copied); o (B, Sq, H, D) is contiguous, in q's type. A row that sees no
// key comes out as zeros (acc / max(l, 1e-30)), as in the reference.
//
// Design. One CTA of 256 threads takes one (batch, head) and a tile of 64
// query rows; the scaled q tile stays in shared memory while the K/V tiles
// of 64 keys stream through it, so Sk is bounded by nothing on chip (the
// reference's K/V segments are a VMEM budget and have no counterpart here).
// Each tile: S = Q K^T as a 4x4 micro-tile per thread (thread (ty, tx)
// holds rows 4ty..4ty+3 and keys tx, tx+16, tx+32, tx+48), the masks, the
// online-softmax update of (m, l, acc), all in f32, with row maxima and
// sums reduced across the 16 threads of a row by shuffles; P goes to shared
// memory and acc += P V, each thread owning D/16 output columns of its four
// rows. Key tiles wholly above the diagonal are not visited, and the query
// tiles are launched last-first so the longest causal rows start first.
// Shared-memory rows are padded by 4 floats, so the 16-byte reads of a warp
// fall in distinct banks.
//
// Precision: every product is an f32 FMA on the CUDA cores, bf16 inputs
// widened on load, P kept in f32 for P V, as the reference computes it
// (no TF32, no bf16 MMA).
//
// Bound. Operations: the (q, k) pairs that the masks keep, 4 D flops each
// (Q K^T and P V), at the f32 rate; bytes: q, k, v read once, o written
// once. At the repository's long-context shapes (causal, D = 64) it is the
// operations, at the serving shapes (63 rows) neither: a launch's latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 64;          // keys per K/V tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kLDP = kBK + 4;    // padded row of P in shared memory
constexpr float kNegInf = -1e30f;

template <int D>
struct Dims {
    static constexpr int LD = D + 4;                 // padded row of Q, K, V
    static constexpr int VEC = D >= 64 ? 4 : 2;      // output columns a run
    static constexpr int NG = D / (16 * VEC);        // runs per thread
    static constexpr size_t kSmem =
        (static_cast<size_t>(kBQ + 2 * kBK) * LD + kBQ * kLDP) *
        sizeof(float);
};

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&x)[4]) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

// Rows [0, n_rows) of a 64 x D tile (row r at src + r * row_stride), times
// `mul`, into shared memory as f32 with row pitch LD; rows past n_rows are
// zeros.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int n_rows,
                                          float mul) {
    constexpr int kPerRow = D / 4;
    for (int e = threadIdx.x; e < kBQ * kPerRow; e += kThreads) {
        const int r = e / kPerRow;
        const int c = (e - r * kPerRow) * 4;
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        if (r < n_rows) {
            load4(src + r * row_stride + c, x);
        }
        *reinterpret_cast<float4*>(dst + r * Dims<D>::LD + c) =
            make_float4(x[0] * mul, x[1] * mul, x[2] * mul, x[3] * mul);
    }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int H, int Sq, int Sk,
                       long long qsb, long long qss, long long qsh,
                       long long ksb, long long kss, long long ksh,
                       long long vsb, long long vss, long long vsh,
                       float scale, int causal) {
    using Dm = Dims<D>;
    constexpr int LD = Dm::LD;
    constexpr int VEC = Dm::VEC;
    constexpr int NG = Dm::NG;
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);
    float* Ks = Qs + kBQ * LD;
    float* Vs = Ks + kBK * LD;
    float* Ps = Vs + kBK * LD;

    const int b = blockIdx.x / H;
    const int h = blockIdx.x - b * H;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;

    // q is scaled in f32 before the products, as the reference scales it
    load_tile<D>(Qs, q + b * qsb + q0 * qss + h * qsh, qss,
                 min(kBQ, Sq - q0), scale);

    // keys past the tile's last row are masked for all of its rows
    const int kv_end = causal ? min(Sk, q0 + kBQ) : Sk;
    const int n_tiles = (kv_end + kBK - 1) / kBK;

    float m[4], l[4], acc[4][NG][VEC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = kNegInf;
        l[i] = 0.f;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
#pragma unroll
            for (int c = 0; c < VEC; ++c) {
                acc[i][g][c] = 0.f;
            }
        }
    }

    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * kBK;
        const int n_keys = min(kBK, Sk - k0);
        __syncthreads();   // the previous tile's K, V and P are consumed
        load_tile<D>(Ks, k + b * ksb + k0 * kss + h * ksh, kss, n_keys, 1.f);
        load_tile<D>(Vs, v + b * vsb + k0 * vss + h * vsh, vss, n_keys, 1.f);
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = 0.f;
            }
        }
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
            float4 qa[4], kb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                qa[i] = *reinterpret_cast<const float4*>(
                    Qs + (4 * ty + i) * LD + d);
                kb[i] = *reinterpret_cast<const float4*>(
                    Ks + (tx + 16 * i) * LD + d);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
                    s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
                    s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
                    s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
                }
            }
        }

        // masks and the online-softmax update, row by row
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = q0 + 4 * ty + i;
            bool keep[4];
            float mx = kNegInf;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = k0 + tx + 16 * j;
                keep[j] = col < Sk && (!causal || col <= row);
                if (!keep[j]) {
                    s[i][j] = kNegInf;
                }
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off /= 2) {
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            }
            const float m_new = fmaxf(m[i], mx);
            float rs = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
                Ps[(4 * ty + i) * kLDP + tx + 16 * j] = p;
                rs += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off /= 2) {
                rs += __shfl_xor_sync(0xffffffffu, rs, off);
            }
            const float alpha = expf(m[i] - m_new);
            l[i] = l[i] * alpha + rs;
            m[i] = m_new;
#pragma unroll
            for (int g = 0; g < NG; ++g) {
#pragma unroll
                for (int c = 0; c < VEC; ++c) {
                    acc[i][g][c] *= alpha;
                }
            }
        }
        __syncthreads();

        // acc += P V over the tile's keys
#pragma unroll 2
        for (int kk = 0; kk < kBK; kk += 4) {
            float4 pa[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                pa[i] = *reinterpret_cast<const float4*>(
                    Ps + (4 * ty + i) * kLDP + kk);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float* vrow = Vs + (kk + e) * LD + tx * VEC;
#pragma unroll
                for (int g = 0; g < NG; ++g) {
                    float vv[VEC];
                    if constexpr (VEC == 4) {
                        const float4 x = *reinterpret_cast<const float4*>(
                            vrow + g * 16 * VEC);
                        vv[0] = x.x; vv[1] = x.y; vv[2] = x.z; vv[3] = x.w;
                    } else {
                        const float2 x = *reinterpret_cast<const float2*>(
                            vrow + g * 16 * VEC);
                        vv[0] = x.x; vv[1] = x.y;
                    }
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float p = e == 0 ? pa[i].x
                                      : e == 1 ? pa[i].y
                                      : e == 2 ? pa[i].z : pa[i].w;
#pragma unroll
                        for (int c = 0; c < VEC; ++c) {
                            acc[i][g][c] = fmaf(p, vv[c], acc[i][g][c]);
                        }
                    }
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + 4 * ty + i;
        if (row >= Sq) {
            continue;
        }
        const float den = fmaxf(l[i], 1e-30f);
        T* orow = o + ((static_cast<long long>(b) * Sq + row) * H + h) * D;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
#pragma unroll
            for (int c = 0; c < VEC; ++c) {
                store1(orow + g * 16 * VEC + tx * VEC + c,
                       acc[i][g][c] / den);
            }
        }
    }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Sq, int Sk, const long long* st, float scale,
           int causal, cudaStream_t stream) {
    constexpr size_t smem = Dims<D>::kSmem;
    static bool configured = false;   // idempotent: races are harmless
    if (!configured) {
        const cudaError_t err = cudaFuncSetAttribute(
            flash_attention_kernel<D, T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) {
            return static_cast<int>(err);
        }
        configured = true;
    }
    const dim3 grid(static_cast<unsigned>(B * H),
                    static_cast<unsigned>((Sq + kBQ - 1) / kBQ));
    flash_attention_kernel<D, T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), H, Sq, Sk,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        scale, causal);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             int B, int H, int Sq, int Sk, const long long* st, float scale,
             int causal, cudaStream_t stream) {
    switch (D) {
        case 32:
            return launch<32, T>(q, k, v, o, B, H, Sq, Sk, st, scale, causal,
                                 stream);
        case 64:
            return launch<64, T>(q, k, v, o, B, H, Sq, Sk, st, scale, causal,
                                 stream);
        case 128:
            return launch<128, T>(q, k, v, o, B, H, Sq, Sk, st, scale,
                                  causal, stream);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Plain C entry point for ctypes. q (B, Sq, H, D), k and v (B, Sk, H, D) in
// device memory, element strides (batch, position, head) in `strides` order
// q, k, v (the last dim contiguous; every stride a multiple of 4 and every
// pointer aligned to 4 elements); o (B, Sq, H, D) contiguous. `dtype` 0 is
// f32, 1 bf16; D is 32, 64 or 128. `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch.
extern "C" int pio_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int Sq, int Sk, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, float scale, int causal,
    void* stream) {
    const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        return dispatch<float>(D, q, k, v, o, B, H, Sq, Sk, st, scale,
                               causal, s);
    }
    if (dtype == 1) {
        return dispatch<__nv_bfloat16>(D, q, k, v, o, B, H, Sq, Sk, st,
                                       scale, causal, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* pio_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
