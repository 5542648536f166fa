// Quantized candidate scan of two-stage retrieval, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `quantized_scores_pallas`
// (pio_tpu/ops/retrieval.py), and with it the probed-cluster gather and
// the pad mask around it in `_clustered_topk_jit`. For a whole query batch:
//
//   qs[b, p*Lmax + l] = (sum_j float(table[c, l, j]) * u[b, j]) * scales[c, l]
//                       if gidx[c, l] >= 0 else -inf,     c = top_c[b, p]
//
// Bound: bytes. Each (b, p) streams one cluster block of int8/bf16 rows and
// does 2 flops per element, far below the card's ratio of compute to
// memory rate. So the design keeps the block in its storage type all the
// way to the registers (1-2 bytes per element move, not 4), reads clusters
// straight from `table` through `top_c` instead of materialising
// table[top_c], and never loads the row of a pad slot: clusters are padded
// to a shared pow2 width Lmax, and most of a block can be padding.
//
// Layout: a CTA per (b, p, chunk of kRowsPerCta rows), so that even one
// query fills the card; u[b] is staged in shared memory. Each warp owns 32
// consecutive rows: lane i loads gidx and the scale of row i (coalesced),
// a ballot tells the warp which rows are real, and the warp then takes the
// real rows kUnroll at a time, lanes striding over k, so several row loads
// are in flight at once; f32 FMA accumulation, a shuffle reduction, and
// the scale applied after the dot, as the reference does. Lane i keeps the
// dot of row i, and the warp writes its 32 outputs in one coalesced store.
// Vector loads, several probes per CTA and TMA are later work.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerCta = kWarps * 32;
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_float(int8_t v) {
    return static_cast<float>(v);
}

__device__ __forceinline__ float to_float(uint16_t bits) {
    // bf16 is the high half of an f32
    return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantized_scan_kernel(const T* __restrict__ table,
                      const float* __restrict__ scales,
                      const int32_t* __restrict__ gidx,
                      const int32_t* __restrict__ top_c,
                      const float* __restrict__ u,
                      float* __restrict__ out,
                      int P, int Lmax, int K) {
    extern __shared__ float u_s[];
    const int bp = blockIdx.x;          // b * P + p
    const int b = bp / P;
    const int c = top_c[bp];
    for (int j = threadIdx.x; j < K; j += kThreads) {
        u_s[j] = u[static_cast<size_t>(b) * K + j];
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int l0 = blockIdx.y * kRowsPerCta + warp * 32;
    if (l0 >= Lmax) {
        return;
    }
    const size_t row0 = static_cast<size_t>(c) * Lmax + l0;
    const bool in_block = l0 + lane < Lmax;
    const int g = in_block ? gidx[row0 + lane] : -1;
    const float scale = in_block ? scales[row0 + lane] : 0.0f;
    unsigned real = __ballot_sync(0xffffffffu, g >= 0);

    float mine = 0.0f;
    while (real) {
        int rows[kUnroll];
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
            rows[i] = real ? __ffs(real) - 1 : -1;
            real &= real - 1;
        }
        float acc[kUnroll];
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
            acc[i] = 0.0f;
        }
        for (int j = lane; j < K; j += 32) {
            const float uj = u_s[j];
#pragma unroll
            for (int i = 0; i < kUnroll; ++i) {
                if (rows[i] >= 0) {
                    const T* q = table + (row0 + rows[i]) * K;
                    acc[i] = fmaf(to_float(q[j]), uj, acc[i]);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
            }
            if (lane == rows[i]) {
                mine = acc[i];
            }
        }
    }
    if (in_block) {
        out[static_cast<size_t>(bp) * Lmax + l0 + lane] =
            g >= 0 ? mine * scale : -INFINITY;
    }
}

template <typename T>
int launch(const void* table, const float* scales, const int32_t* gidx,
           const int32_t* top_c, const float* u, float* out,
           int B, int P, int Lmax, int K, void* stream) {
    const dim3 grid(B * P, (Lmax + kRowsPerCta - 1) / kRowsPerCta);
    const size_t smem = static_cast<size_t>(K) * sizeof(float);
    quantized_scan_kernel<T><<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(table), scales, gidx, top_c, u, out,
        P, Lmax, K);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Every pointer is device memory on the
// current device; `stream` is a cudaStream_t. Returns the cudaError_t of
// the launch (0 on success). Shapes: table (C, Lmax, K), scales and gidx
// (C, Lmax), top_c (B, P) with values in [0, C), u (B, K), out (B, P*Lmax).
// B * P must not exceed 2^31 - 1 and Lmax / 256 must not exceed 65535.
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

extern "C" const char* pio_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
