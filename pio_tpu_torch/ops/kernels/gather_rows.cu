// Row gathers of the ALS block build, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of pio_tpu/ops/als_pallas.py. Both compute
//
//   out[m, :] = table[idx[m], :]      table (N, k) f32 or bf16, idx (M,) int32
//
// in the table's own type (the f32 cast stays with the caller, as in the
// reference, so a launch can be held bytewise to `table[idx]`):
//
//  - K5, `gather_rows_stream` -> `_gather_kernel_stream` (ALS
//    gather="stream"), for a table of any size. The TPU kernel double-buffers
//    per-row HBM->VMEM copies in mini-groups. Here each CTA loads its own
//    block of indices into shared memory, then copies rows with 16-byte
//    `cp.async` into a two-slot shared-memory ring of `group` rows: the
//    copies of group g+1 are in flight while group g is stored. A group's
//    rows are consecutive rows of `out`, so its store is one contiguous,
//    coalesced run of 16-byte writes. The ragged tail is masked (no padding
//    with index 0 and no slice afterwards).
//  - K4, `gather_rows_pallas` -> `_gather_kernel_copy` / `_gather_kernel_take`
//    (gather="pallas-copy" / "pallas-take"). The TPU kernel keeps the whole
//    table in VMEM when it fits a 10 MiB budget. Hopper has no on-chip store
//    of that size (227 KB of shared memory a CTA), but any table that passes
//    the budget fits its 50 MB L2, so here "resident" means resident in L2,
//    and both variants read the table straight from global memory:
//      copy: one warp per group of 8 rows, lanes moving 16-byte pieces;
//      take: the output seen as one flat run of 16-byte vectors, a CTA
//      per 1024 of them and four a thread, all four loads in flight before
//      the first store; the CTA reads the row indices its vectors need
//      once into shared memory (not once per element or vector), and
//      consecutive threads store consecutive vectors.
//
// Bound: bytes. A gather does no arithmetic; the least it must move is the
// output (M rows written), the indices, and the table read once. Rows are
// 16-byte vectors wherever the row width and the pointers allow (k = 64 bf16
// is 128 B a row, 8 vectors); where they do not (k = 5 bf16 is 10 B), the
// entry points launch the element-per-thread kernel, which any width and
// alignment can use.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kGroupsPerCta = 16;     // stream: groups of rows one CTA walks
constexpr int kMaxGroup = 64;         // stream: rows of one ring slot, at most
constexpr int kMaxVecs = 1024;        // stream: widest row, 16 KB
constexpr int kCopyGroup = 8;         // copy: rows per warp (the reference's)
constexpr int kTakePer = 4;           // take: vectors a thread
constexpr int kTakeVecs = kThreads * kTakePer;   // take: vectors a CTA

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// K5. CTA c takes rows [c * group * kGroupsPerCta, ...) of `out`. `vecs` is
// the row width in 16-byte vectors, `group` rows fill one ring slot.
__global__ void __launch_bounds__(kThreads)
gather_stream_kernel(const uint4* __restrict__ table,
                     const int32_t* __restrict__ idx,
                     uint4* __restrict__ out, int m, int vecs, int group) {
    extern __shared__ uint4 ring[];                 // 2 slots x group x vecs
    __shared__ int32_t rows_s[kMaxGroup * kGroupsPerCta];
    const int per_cta = group * kGroupsPerCta;
    const long long row0 = static_cast<long long>(blockIdx.x) * per_cta;
    const int n_rows = static_cast<int>(
        min(static_cast<long long>(per_cta), m - row0));
    for (int r = threadIdx.x; r < n_rows; r += kThreads) {
        rows_s[r] = idx[row0 + r];
    }
    __syncthreads();
    const int n_groups = (n_rows + group - 1) / group;
    const int slot_vecs = group * vecs;

    auto fetch = [&](int g) {
        uint4* slot = ring + (g & 1) * slot_vecs;
        const int g_rows = min(group, n_rows - g * group);
        for (int t = threadIdx.x; t < g_rows * vecs; t += kThreads) {
            const int r = t / vecs;
            const int v = t - r * vecs;
            cp_async16(slot + t,
                       table + static_cast<size_t>(rows_s[g * group + r])
                               * vecs + v);
        }
        cp_async_commit();
    };

    fetch(0);
    for (int g = 0; g < n_groups; ++g) {
        if (g + 1 < n_groups) {
            fetch(g + 1);
        } else {
            cp_async_commit();        // an empty group keeps the count even
        }
        cp_async_wait_one();          // group g has landed, g+1 may fly
        __syncthreads();
        const uint4* slot = ring + (g & 1) * slot_vecs;
        const int g_rows = min(group, n_rows - g * group);
        uint4* dst = out + (row0 + static_cast<long long>(g) * group) * vecs;
        for (int t = threadIdx.x; t < g_rows * vecs; t += kThreads) {
            dst[t] = slot[t];
        }
        __syncthreads();              // slot g&1 is refilled by fetch(g+2)
    }
}

// K4 copy: warp w moves rows [w * kCopyGroup, (w + 1) * kCopyGroup).
__global__ void __launch_bounds__(kThreads)
gather_copy_kernel(const uint4* __restrict__ table,
                   const int32_t* __restrict__ idx, uint4* __restrict__ out,
                   int m, int vecs) {
    const long long warp =
        (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    const long long row0 = warp * kCopyGroup;
    if (row0 >= m) {
        return;
    }
    const int g_rows = static_cast<int>(
        min(static_cast<long long>(kCopyGroup), m - row0));
    for (int t = lane; t < g_rows * vecs; t += 32) {
        const int r = t / vecs;
        const int v = t - r * vecs;
        const int32_t src_row = __ldg(idx + row0 + r);
        out[(row0 + r) * vecs + v] =
            __ldg(table + static_cast<size_t>(src_row) * vecs + v);
    }
}

// K4 take: CTA c takes vectors [c * kTakeVecs, (c + 1) * kTakeVecs) of
// the flat output, whose rows are `vecs` 16-byte vectors each; thread i
// moves vectors i, i + kThreads, ... of that run.
__global__ void __launch_bounds__(kThreads)
gather_take_kernel(const uint4* __restrict__ table,
                   const int32_t* __restrict__ idx, uint4* __restrict__ out,
                   long long total, int vecs) {
    __shared__ int32_t rows_s[kTakeVecs + 1];
    const long long v0 = static_cast<long long>(blockIdx.x) * kTakeVecs;
    const long long row0 = v0 / vecs;
    const int n_rows = static_cast<int>(
        (min(v0 + kTakeVecs, total) - 1) / vecs - row0 + 1);
    for (int r = threadIdx.x; r < n_rows; r += kThreads) {
        rows_s[r] = __ldg(idx + row0 + r);
    }
    __syncthreads();
    // the run starts `skip` vectors into row row0
    const int skip = static_cast<int>(v0 - row0 * vecs);
    const int n_vecs = static_cast<int>(min(static_cast<long long>(kTakeVecs),
                                            total - v0));
    uint4 x[kTakePer];
#pragma unroll
    for (int i = 0; i < kTakePer; ++i) {
        const int e = threadIdx.x + i * kThreads;
        if (e < n_vecs) {
            const int r = (skip + e) / vecs;
            const int col = skip + e - r * vecs;
            x[i] = __ldg(table + static_cast<size_t>(rows_s[r]) * vecs + col);
        }
    }
#pragma unroll
    for (int i = 0; i < kTakePer; ++i) {
        const int e = threadIdx.x + i * kThreads;
        if (e < n_vecs) {
            out[v0 + e] = x[i];
        }
    }
}

// The K5/K4 path for rows that are not whole 16-byte vectors: one thread
// per output element of `esize` bytes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_elems_kernel(const T* __restrict__ table,
                    const int32_t* __restrict__ idx, T* __restrict__ out,
                    long long total, int k) {
    const long long e =
        static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (e >= total) {
        return;
    }
    const long long row = e / k;
    const int col = static_cast<int>(e - row * k);
    out[e] = table[static_cast<size_t>(__ldg(idx + row)) * k + col];
}

int launch_elems(const void* table, const int32_t* idx, void* out, int m,
                 int k, int esize, cudaStream_t st) {
    const long long total = static_cast<long long>(m) * k;
    const unsigned blocks =
        static_cast<unsigned>((total + kThreads - 1) / kThreads);
    if (esize == 2) {
        gather_elems_kernel<uint16_t><<<blocks, kThreads, 0, st>>>(
            static_cast<const uint16_t*>(table), idx,
            static_cast<uint16_t*>(out), total, k);
    } else {
        gather_elems_kernel<uint32_t><<<blocks, kThreads, 0, st>>>(
            static_cast<const uint32_t*>(table), idx,
            static_cast<uint32_t*>(out), total, k);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device memory on the current
// device, `stream` a cudaStream_t. table (N, k) and out (M, k) hold elements
// of `esize` bytes (2: bf16, 4: f32); idx (M,) int32 with 0 <= idx < N.
// `vec` is 1 when a row is a whole number of 16-byte vectors and table and
// out are 16-byte aligned. Each returns the cudaError_t of its launch.

// K5, gather="stream". A ring slot holds about one 16-byte vector per
// thread (32 rows at k = 64 bf16); rows wider than 16 KB take the element
// kernel.
extern "C" int pio_gather_stream(const void* table, const int32_t* idx,
                                 void* out, int m, int k, int esize, int vec,
                                 void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int vecs = k * esize / 16;
    if (!vec || vecs > kMaxVecs) {
        return launch_elems(table, idx, out, m, k, esize, st);
    }
    const int group = max(1, min(kMaxGroup, kThreads / vecs));
    const int per_cta = group * kGroupsPerCta;
    const unsigned blocks = static_cast<unsigned>((m + per_cta - 1) / per_cta);
    const size_t smem = 2 * static_cast<size_t>(group) * vecs * 16;
    gather_stream_kernel<<<blocks, kThreads, smem, st>>>(
        static_cast<const uint4*>(table), idx, static_cast<uint4*>(out), m,
        vecs, group);
    return static_cast<int>(cudaGetLastError());
}

// K4, gather="pallas-copy" (variant 0) or "pallas-take" (variant 1); rows
// that are not whole 16-byte vectors take the element kernel in both.
extern "C" int pio_gather_resident(const void* table, const int32_t* idx,
                                   void* out, int m, int k, int esize,
                                   int vec, int variant, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (!vec) {
        return launch_elems(table, idx, out, m, k, esize, st);
    }
    const int vecs = k * esize / 16;
    if (variant == 1) {
        const long long total = static_cast<long long>(m) * vecs;
        const unsigned blocks =
            static_cast<unsigned>((total + kTakeVecs - 1) / kTakeVecs);
        gather_take_kernel<<<blocks, kThreads, 0, st>>>(
            static_cast<const uint4*>(table), idx, static_cast<uint4*>(out),
            total, vecs);
        return static_cast<int>(cudaGetLastError());
    }
    const long long warps = (static_cast<long long>(m) + kCopyGroup - 1)
                            / kCopyGroup;
    const unsigned blocks =
        static_cast<unsigned>((warps * 32 + kThreads - 1) / kThreads);
    gather_copy_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const uint4*>(table), idx, static_cast<uint4*>(out), m,
        vecs);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pio_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
