// Quantized candidate scan of two-stage retrieval, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `quantized_scores_pallas`
// (pio_tpu/ops/retrieval.py), and with it the probed-cluster gather and
// the pad mask around it in `_clustered_topk_jit`. For a whole query batch:
//
//   qs[b, p*Lmax + l] = (sum_j float(table[c, l, j]) * u[b, j]) * scales[c, l]
//                       if gidx[c, l] >= 0 else -inf,     c = top_c[b, p]
//
// Bound: latency. By bytes the scan needs well under a microsecond (a
// probed block of int8/bf16 rows, 2 flops per element), and the whole
// int8 table (1.7 MB at the MovieLens-20M shape) stays in L2 between
// queries. What a query waits for is the chain of dependent memory round
// trips: top_c, then gidx and the scale, then the rows.
//
// Layout. A CTA takes kRowsPerCta consecutive rows of one (b, p) block
// (grid (B*P, ceil(Lmax / kRowsPerCta)), 1024 rows: the whole block at the
// MovieLens-20M shape); u[b] is staged in shared memory while top_c is
// read. Each thread loads gidx of kRows rows (coalesced across the warp,
// all in flight at once) and writes -inf where a row is a pad, wherever
// in the block the pads lie. The real rows are then compacted into a list
// in shared memory (a ballot per warp, a prefix over the warps), and
// thread t takes the t-th real row: it loads the whole row at once as
// 16-byte vectors (4 for int8 at k 64, 8 for bf16) and its scale, so every
// real row of the CTA is in flight together, one round trip however the
// real rows are placed. FMAs in f32 against u broadcast from shared
// memory, no shuffles; the scale is applied after the dot, as the
// reference does. Where a row's bytes are not a multiple of 16 or the
// table is not 16-byte aligned, rows are read element by element instead.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                         // gidx loads a thread
constexpr int kRowsPerCta = kThreads * kRows;
constexpr int kVecs = 8;   // 16-byte vectors a thread loads at once

__device__ __forceinline__ float to_float(int8_t v) {
    return static_cast<float>(v);
}

__device__ __forceinline__ float to_float(uint16_t bits) {
    // bf16 is the high half of an f32
    return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// acc += the 16 bytes of one vector (16 int8 or 8 bf16) against u[j0..]
__device__ __forceinline__ float dot_vec(uint4 v, const float* u, float acc,
                                         int8_t) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float4 uu = *reinterpret_cast<const float4*>(u + 4 * q);
        const int32_t x = static_cast<int32_t>(w[q]);
        acc = fmaf(static_cast<float>((x << 24) >> 24), uu.x, acc);
        acc = fmaf(static_cast<float>((x << 16) >> 24), uu.y, acc);
        acc = fmaf(static_cast<float>((x << 8) >> 24), uu.z, acc);
        acc = fmaf(static_cast<float>(x >> 24), uu.w, acc);
    }
    return acc;
}

__device__ __forceinline__ float dot_vec(uint4 v, const float* u, float acc,
                                         uint16_t) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float2 uu = *reinterpret_cast<const float2*>(u + 2 * q);
        acc = fmaf(__uint_as_float(w[q] << 16), uu.x, acc);
        acc = fmaf(__uint_as_float(w[q] & 0xffff0000u), uu.y, acc);
    }
    return acc;
}

// acc = the dot of one real row with u_s
template <typename T>
__device__ __forceinline__ float row_dot(const T* q, const float* u_s, int K,
                                         int vec) {
    float acc = 0.0f;
    if (vec) {
        // per vector: 16 int8 or 8 bf16 elements
        constexpr int kPer = 16 / sizeof(T);
        const int n_vec = K / kPer;
        const uint4* qv = reinterpret_cast<const uint4*>(q);
        for (int v0 = 0; v0 < n_vec; v0 += kVecs) {
            uint4 buf[kVecs];
#pragma unroll
            for (int i = 0; i < kVecs; ++i) {
                if (v0 + i < n_vec) {
                    buf[i] = __ldg(qv + v0 + i);
                }
            }
#pragma unroll
            for (int i = 0; i < kVecs; ++i) {
                if (v0 + i < n_vec) {
                    acc = dot_vec(buf[i], u_s + (v0 + i) * kPer, acc, T());
                }
            }
        }
    } else {
#pragma unroll 4
        for (int j = 0; j < K; ++j) {
            acc = fmaf(to_float(q[j]), u_s[j], acc);
        }
    }
    return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantized_scan_kernel(const T* __restrict__ table,
                      const float* __restrict__ scales,
                      const int32_t* __restrict__ gidx,
                      const int32_t* __restrict__ top_c,
                      const float* __restrict__ u,
                      float* __restrict__ out,
                      int P, int Lmax, int K, int vec) {
    extern __shared__ float4 u_s4[];
    float* u_s = reinterpret_cast<float*>(u_s4);
    __shared__ int16_t real_s[kRowsPerCta];   // the CTA's real rows, in order
    __shared__ int warp_n_s[kWarps];
    const int bp = blockIdx.x;          // b * P + p
    const int b = bp / P;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int l0 = blockIdx.y * kRowsPerCta;
    const int c = top_c[bp];
    for (int j = threadIdx.x; j < K; j += kThreads) {
        u_s[j] = u[static_cast<size_t>(b) * K + j];
    }
    const size_t block = static_cast<size_t>(c) * Lmax + l0;
    float* o = out + static_cast<size_t>(bp) * Lmax + l0;
    const int n_rows = min(kRowsPerCta, Lmax - l0);

    // row warp * 32 * kRows + r * 32 + lane of the CTA's rows
    bool real[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int l = (warp * kRows + r) * 32 + lane;
        real[r] = l < n_rows && gidx[block + l] >= 0;
    }
    unsigned mask[kRows];
    int n = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int l = (warp * kRows + r) * 32 + lane;
        if (l < n_rows && !real[r]) {
            o[l] = -INFINITY;
        }
        mask[r] = __ballot_sync(0xffffffffu, real[r]);
        n += __popc(mask[r]);
    }
    if (lane == 0) {
        warp_n_s[warp] = n;
    }
    __syncthreads();
    int pos = 0;
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        pos += w < warp ? warp_n_s[w] : 0;
        total += warp_n_s[w];
    }
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        if (real[r]) {
            real_s[pos + __popc(mask[r] & below)] =
                static_cast<int16_t>((warp * kRows + r) * 32 + lane);
        }
        pos += __popc(mask[r]);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < total; t += kThreads) {
        const int l = real_s[t];
        const float scale = scales[block + l];
        o[l] = row_dot(table + (block + l) * K, u_s, K, vec) * scale;
    }
}

// The same grid and block with no work: the launch floor of the scan.
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

dim3 scan_grid(int B, int P, int Lmax) {
    return dim3(B * P, (Lmax + kRowsPerCta - 1) / kRowsPerCta);
}

template <typename T>
int launch(const void* table, const float* scales, const int32_t* gidx,
           const int32_t* top_c, const float* u, float* out,
           int B, int P, int Lmax, int K, void* stream) {
    // rows move as 16-byte vectors when every row starts 16-byte aligned
    const int vec = (static_cast<size_t>(K) * sizeof(T)) % 16 == 0
                    && reinterpret_cast<uintptr_t>(table) % 16 == 0;
    // u_s is read as float4 past K up to the vector's end: round up
    const size_t smem = static_cast<size_t>((K + 15) / 16 * 16)
                        * sizeof(float);
    quantized_scan_kernel<T><<<scan_grid(B, P, Lmax), kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(table), scales, gidx, top_c, u, out,
        P, Lmax, K, vec);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Every pointer is device memory on the
// current device; `stream` is a cudaStream_t. Returns the cudaError_t of
// the launch (0 on success). Shapes: table (C, Lmax, K), scales and gidx
// (C, Lmax), top_c (B, P) with values in [0, C), u (B, K), out (B, P*Lmax).
// B * P must not exceed 2^31 - 1 and Lmax / 1024 must not exceed 65535.
extern "C" int pio_quantized_scan_int8(
        const void* table, const float* scales, const int32_t* gidx,
        const int32_t* top_c, const float* u, float* out,
        int B, int P, int Lmax, int K, void* stream) {
    return launch<int8_t>(table, scales, gidx, top_c, u, out,
                          B, P, Lmax, K, stream);
}

extern "C" int pio_quantized_scan_bf16(
        const void* table, const float* scales, const int32_t* gidx,
        const int32_t* top_c, const float* u, float* out,
        int B, int P, int Lmax, int K, void* stream) {
    return launch<uint16_t>(table, scales, gidx, top_c, u, out,
                            B, P, Lmax, K, stream);
}

// An empty kernel on the scan's grid for (B, P, Lmax): what any kernel of
// that launch shape costs, a practical floor beside the byte bound.
extern "C" int pio_quantized_scan_empty(int B, int P, int Lmax,
                                        void* stream) {
    empty_kernel<<<scan_grid(B, P, Lmax), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pio_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
