// Batched block matvec on lane-packed A, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `packed_block_matvec` ->
// `_packed_matvec_kernel` (pio_tpu/ops/als_pallas.py), the matvec inside
// every iteration of ALS's Jacobi-CG on packed normal equations:
//
//   out[b, i] = sum_j A[b, i*k + j] * x[b, j]     A (n, k*k), x (n, k) f32
//
// The TPU kernel tiles x k times across the lanes and sums the k-lane groups
// with a 0/1 selection matrix on the MXU. Here the products are f32 FMAs on
// the CUDA cores (no tensor cores and no TF32: the reference forces
// Precision.HIGHEST for this product).
//
// Bound: bytes. Each A_b (16 KB at k = 64) is read once and used for one
// product, 2 flops per 4 bytes. One warp takes one b: x_b is staged in
// shared memory, and the warp walks A_b's rows i in order, `lpr` lanes to a
// row, each lane taking 16-byte vectors of the row at a stride of `lpr`, so
// one warp load reads 512 contiguous bytes of A (k = 64: 16 lanes a row, two
// rows at a time). Each row's partial sums meet in a shuffle reduction over
// its lanes. A is read with streaming loads: no call reads it twice. Where k
// is not a multiple of 4, or A is not 16-byte aligned, the same walk runs
// on single floats. The kernel takes any n (the reference pads n to its
// row block).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
packed_matvec_kernel(const float* __restrict__ A, const float* __restrict__ x,
                     float* __restrict__ out, int n, int k, int lpr) {
    extern __shared__ float xs[];                   // kWarps x k
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const long long b = static_cast<long long>(blockIdx.x) * kWarps + warp;
    if (b >= n) {
        return;                                     // whole warps only
    }
    float* xw = xs + warp * k;
    for (int j = lane; j < k; j += 32) {
        xw[j] = x[b * k + j];
    }
    __syncwarp();
    const float* Ab = A + b * static_cast<long long>(k) * k;
    const int seg = lane / lpr;                     // which row of the step
    const int c0 = lane - seg * lpr;                // first piece of the row
    const int rows_per_step = 32 / lpr;
#pragma unroll 4
    for (int i0 = 0; i0 < k; i0 += rows_per_step) {
        const int i = i0 + seg;
        float s = 0.f;
        if (i < k) {
            if (VEC) {
                const float4* row =
                    reinterpret_cast<const float4*>(Ab + i * k);
                const float4* xv = reinterpret_cast<const float4*>(xw);
                for (int c = c0; c < k / 4; c += lpr) {
                    const float4 a = __ldcs(row + c);
                    const float4 v = xv[c];
                    s = fmaf(a.x, v.x, s);
                    s = fmaf(a.y, v.y, s);
                    s = fmaf(a.z, v.z, s);
                    s = fmaf(a.w, v.w, s);
                }
            } else {
                const float* row = Ab + i * k;
                for (int j = c0; j < k; j += lpr) {
                    s = fmaf(__ldcs(row + j), xw[j], s);
                }
            }
        }
        // segments of lpr lanes are aligned, so xor offsets below lpr stay
        // inside one row's lanes
        for (int off = lpr / 2; off > 0; off /= 2) {
            s += __shfl_xor_sync(0xffffffffu, s, off);
        }
        if (c0 == 0 && i < k) {
            out[b * k + i] = s;
        }
    }
}

}  // namespace

// Plain C entry point for ctypes. A (n, k*k), x (n, k), out (n, k): f32
// device memory on the current device, `stream` a cudaStream_t. `vec` is 1
// when k is a multiple of 4 and A is 16-byte aligned (x is staged in shared
// memory by single floats). Returns the cudaError_t of the launch.
extern "C" int pio_packed_matvec(const float* A, const float* x, float* out,
                                 int n, int k, int vec, void* stream) {
    const int pieces = vec ? k / 4 : k;             // per row of A_b
    int lpr = 1;                                    // lanes per row: pow2
    while (lpr < pieces && lpr < 32) {
        lpr *= 2;
    }
    const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
    const size_t smem = static_cast<size_t>(kWarps) * k * sizeof(float);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec) {
        packed_matvec_kernel<true><<<blocks, kThreads, smem, st>>>(
            A, x, out, n, k, lpr);
    } else {
        packed_matvec_kernel<false><<<blocks, kThreads, smem, st>>>(
            A, x, out, n, k, lpr);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pio_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
