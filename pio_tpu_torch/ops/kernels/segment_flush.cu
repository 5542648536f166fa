// Segment flush of the ALS normal equations, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_segment_kernel` with `_flush_slot_fn`
// (pio_tpu/ops/als_pallas.py, reached from `normal_equations_hybrid`), with
// the trail fold of `_chain_groups` around it. Slots are sorted by row; each
// carries a precomputed (k, k) block and a (k,) right-hand side:
//
//   A[r] = sum of a_blk[s], b[r] = sum of b_blk[s], over the slots s with
//   rows[s] == r; a slot whose row lies outside [0, n_self) is padding.
//
// Bound: bytes. Each slot's block is read once and added once, far below
// the card's ratio of compute to memory rate. So the kernel reads each real
// block exactly once, never reads a pad block (rows is sorted, so a CTA
// stops at its first pad slot), and writes each finished row once; it uses
// no float atomics, so two runs give bit-identical A and b.
//
// Layout. A CTA takes a tile of kTile consecutive slots and one column chunk
// of kCols floats of either the k*k block or the k-vector (grid.y walks the
// chunks of A, then those of b); each thread owns 4 consecutive floats of
// the chunk, loaded as one float4 where alignment allows. The CTA walks its
// tile in slot order, kUnroll slots' loads in flight at a time, and sums in
// registers. A segment that starts inside the tile is written straight to
// its row (`=`): the tile holds that row's first slot of this call. The
// tile's head segment, when it continues a row from the tile before (and
// always in tile 0, whose row may continue from an earlier call), goes to a
// per-tile partial buffer instead; a second small kernel adds each run of
// equal partial rows, in tile order, onto its row (`+=`). This is the
// reference's flush-plus-trail algebra, with tiles in place of groups.
//
// Contract of one launch over slots [0, S): rows[0]'s sum is added onto
// A[rows[0]], every other row touched is assigned. Callers pass A and b
// zeroed at the rows this call assigns (ops/kernels/segment_flush.py).
//
// K3, the overlapped flush (`pio_segment_flush_stream`), replaces the Pallas
// TPU kernel `_segment_kernel_stream` (same file, reached from
// `normal_equations_hybrid(overlap=True[, packed=True])`, ALS
// accum="stream"). Its algebra is K2's, add for add: the same tiles, the
// same column chunks, the same slot order and the same fold, so its A and b
// are bit-identical to K2's. What changes is how a finished row leaves the
// CTA. The TPU kernel copies the row into one of two VMEM staging slots and
// starts its HBM write without waiting; the wait comes when the slot is
// next needed. Here the CTA's column chunk of the row is staged in one of
// two shared-memory slots (2 x 4 KB) and written with one TMA bulk store
// (`cp.async.bulk.global.shared::cta`, a bulk group per row); before a slot
// is filled again, one thread waits until the store that read it two rows
// back has read it (`cp.async.bulk.wait_group.read 1`). So the write of one
// row overlaps the accumulation of the next, and a row leaves in one
// transfer, not in 256 thread stores. Bulk copies need 16-byte-aligned
// addresses and sizes: where k*k or k is not a multiple of 4 (odd k), or a
// pointer is not aligned, K3 stores rows as K2 does. A packed A, (n, k*k),
// is the same bytes as (n, k, k) here (the port never pads lanes), so
// packing is the output's shape, not a kernel of its own.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = kThreads * 4;   // floats of one column chunk
constexpr int kTile = 64;             // slots of one CTA
constexpr int kUnroll = 4;            // slot loads in flight per thread

template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int rem) {
    if (VEC) {
        return __ldcs(reinterpret_cast<const float4*>(p));
    }
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rem > 0) v.x = __ldcs(p);
    if (rem > 1) v.y = __ldcs(p + 1);
    if (rem > 2) v.z = __ldcs(p + 2);
    if (rem > 3) v.w = __ldcs(p + 3);
    return v;
}

template <bool VEC>
__device__ __forceinline__ float4 read4(const float* p, int rem) {
    if (VEC) {
        return *reinterpret_cast<const float4*>(p);
    }
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rem > 0) v.x = p[0];
    if (rem > 1) v.y = p[1];
    if (rem > 2) v.z = p[2];
    if (rem > 3) v.w = p[3];
    return v;
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, float4 v, int rem) {
    if (VEC) {
        *reinterpret_cast<float4*>(p) = v;
        return;
    }
    if (rem > 0) p[0] = v.x;
    if (rem > 1) p[1] = v.y;
    if (rem > 2) p[2] = v.z;
    if (rem > 3) p[3] = v.w;
}

__device__ __forceinline__ void add4(float4& a, const float4& v) {
    a.x += v.x;
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
}

// Which tensor and column chunk CTA row `y` works on.
struct Chunk {
    const float* blk;   // (slots, D) blocks
    float* out;         // (n_self, D)
    float* part;        // (n_tiles, D) head partials
    int D;
    int col;            // this thread's first column
    bool vec;
};

__device__ __forceinline__ Chunk chunk_of(
        int y, int ya, const float* a_blk, const float* b_blk, float* A,
        float* b, float* part_a, float* part_b, int Da, int Db, int vec_a,
        int vec_b) {
    Chunk c;
    const bool is_a = y < ya;
    c.blk = is_a ? a_blk : b_blk;
    c.out = is_a ? A : b;
    c.part = is_a ? part_a : part_b;
    c.D = is_a ? Da : Db;
    c.col = (is_a ? y : y - ya) * kCols + threadIdx.x * 4;
    c.vec = is_a ? vec_a != 0 : vec_b != 0;
    return c;
}

template <bool VEC>
__device__ void flush_tile(const Chunk& c, const int32_t* rows_s, int n_real,
                           bool head_is_partial, int tile) {
    const int rem = c.D - c.col;
    if (rem <= 0) {
        return;
    }
    int cur = rows_s[0];
    bool partial = head_is_partial;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_real; s0 += kUnroll) {
        float4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            v[u] = s0 + u < n_real
                ? load4<VEC>(c.blk + static_cast<size_t>(s0 + u) * c.D
                             + c.col, rem)
                : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            if (s0 + u < n_real) {
                const int r = rows_s[s0 + u];
                if (r != cur) {
                    float* dst = partial
                        ? c.part + static_cast<size_t>(tile) * c.D
                        : c.out + static_cast<size_t>(cur) * c.D;
                    store4<VEC>(dst + c.col, acc, rem);
                    acc = make_float4(0.f, 0.f, 0.f, 0.f);
                    cur = r;
                    partial = false;
                }
                add4(acc, v[u]);
            }
        }
    }
    float* dst = partial ? c.part + static_cast<size_t>(tile) * c.D
                         : c.out + static_cast<size_t>(cur) * c.D;
    store4<VEC>(dst + c.col, acc, rem);
}

// -- K3's row stores: a two-slot staging ring and TMA bulk stores ----------

__device__ __forceinline__ void bulk_store(float* gdst, const float* ssrc,
                                           int bytes) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(ssrc));
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
        :: "l"(gdst), "r"(s), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read_one() {
    asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// flush_tile<true> with each finished row's column chunk leaving through a
// staging slot and one bulk store. Threads whose columns lie past D still
// take part in the CTA's barriers. Row changes are the same for every
// thread (rows_s is shared), so the whole CTA reaches each barrier.
__device__ void flush_tile_staged(const Chunk& c, const int32_t* rows_s,
                                  int n_real, bool head_is_partial, int tile,
                                  int col0, float* stage) {
    const int rem = c.D - c.col;
    const bool active = rem > 0;
    const int chunk_bytes = min(kCols, c.D - col0) * 4;
    int n_flushed = 0;
    auto emit = [&](int row, bool partial, const float4& acc) {
        float* dst = partial ? c.part + static_cast<size_t>(tile) * c.D
                             : c.out + static_cast<size_t>(row) * c.D;
        float* slot = stage + (n_flushed & 1) * kCols;
        if (threadIdx.x == 0) {
            bulk_wait_read_one();   // the store two rows back has read slot
        }
        __syncthreads();
        if (active) {
            *reinterpret_cast<float4*>(slot + threadIdx.x * 4) = acc;
        }
        fence_proxy_async();        // the bulk copy reads through the async
        __syncthreads();            // proxy: order the slot's writes first
        if (threadIdx.x == 0) {
            bulk_store(dst + col0, slot, chunk_bytes);
        }
        ++n_flushed;
    };

    int cur = rows_s[0];
    bool partial = head_is_partial;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_real; s0 += kUnroll) {
        float4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            v[u] = active && s0 + u < n_real
                ? load4<true>(c.blk + static_cast<size_t>(s0 + u) * c.D
                              + c.col, rem)
                : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            if (s0 + u < n_real) {
                const int r = rows_s[s0 + u];
                if (r != cur) {
                    emit(cur, partial, acc);
                    acc = make_float4(0.f, 0.f, 0.f, 0.f);
                    cur = r;
                    partial = false;
                }
                add4(acc, v[u]);
            }
        }
    }
    emit(cur, partial, acc);
    if (threadIdx.x == 0) {
        bulk_wait_all();            // every row written before the CTA ends
    }
}

// Grid (n_tiles, ya + yb): tile of kTile slots x column chunk. STAGED (K3)
// writes rows through flush_tile_staged where the chunk moves as float4, and
// as K2 elsewhere.
template <bool STAGED>
__global__ void __launch_bounds__(kThreads)
segment_flush_kernel(const int32_t* __restrict__ rows,
                     const float* __restrict__ a_blk,
                     const float* __restrict__ b_blk,
                     float* __restrict__ A, float* __restrict__ b,
                     int32_t* __restrict__ part_row,
                     float* __restrict__ part_a, float* __restrict__ part_b,
                     int S, int n_self, int Da, int Db, int ya,
                     int vec_a, int vec_b) {
    __shared__ int32_t rows_s[kTile];
    __shared__ int n_real_s;
    __shared__ __align__(128) float stage[STAGED ? 2 * kCols : 4];
    const int tile = blockIdx.x;
    const size_t s_begin = static_cast<size_t>(tile) * kTile;
    const int n = min(kTile, static_cast<int>(S - s_begin));
    if (threadIdx.x < n) {
        rows_s[threadIdx.x] = rows[s_begin + threadIdx.x];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        // rows is sorted: the real slots are a prefix, pads the rest
        int m = 0;
        while (m < n && rows_s[m] >= 0 && rows_s[m] < n_self) {
            ++m;
        }
        n_real_s = m;
    }
    __syncthreads();
    const int n_real = n_real_s;
    // the tile's first row continues from before it: from the slot before
    // the tile, or, in tile 0, possibly from an earlier call
    const bool head_is_partial =
        n_real > 0 && (tile == 0 || rows[s_begin - 1] == rows_s[0]);
    if (blockIdx.y == 0 && threadIdx.x == 0) {
        part_row[tile] = head_is_partial ? rows_s[0] : -1;
    }
    if (n_real == 0) {
        return;
    }
    Chunk c = chunk_of(blockIdx.y, ya, a_blk, b_blk, A, b, part_a, part_b,
                       Da, Db, vec_a, vec_b);
    c.blk += s_begin * c.D;   // this tile's first slot
    if (STAGED && c.vec) {
        const int col0 = c.col - threadIdx.x * 4;   // the chunk's first
        flush_tile_staged(c, rows_s, n_real, head_is_partial, tile, col0,
                          stage);
    } else if (c.vec) {
        flush_tile<true>(c, rows_s, n_real, head_is_partial, tile);
    } else {
        flush_tile<false>(c, rows_s, n_real, head_is_partial, tile);
    }
}

template <bool VEC>
__device__ void fold_run(const Chunk& c, const int32_t* part_row, int t,
                         int n_tiles, int r) {
    const int rem = c.D - c.col;
    if (rem <= 0) {
        return;
    }
    int end = t + 1;
    while (end < n_tiles && part_row[end] == r) {
        ++end;
    }
    float4 acc = read4<VEC>(c.out + static_cast<size_t>(r) * c.D + c.col,
                            rem);
    for (int p0 = t; p0 < end; p0 += kUnroll) {
        float4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            v[u] = p0 + u < end
                ? read4<VEC>(c.part + static_cast<size_t>(p0 + u) * c.D
                             + c.col, rem)
                : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            add4(acc, v[u]);
        }
    }
    store4<VEC>(c.out + static_cast<size_t>(r) * c.D + c.col, acc, rem);
}

// Grid (n_tiles, ya + yb): the CTA of the first tile of each run of equal
// partial rows adds the run, in tile order, onto its row.
__global__ void __launch_bounds__(kThreads)
segment_fold_kernel(const int32_t* __restrict__ part_row,
                    const float* __restrict__ part_a,
                    const float* __restrict__ part_b,
                    float* __restrict__ A, float* __restrict__ b,
                    int n_tiles, int Da, int Db, int ya, int vec_a,
                    int vec_b) {
    const int t = blockIdx.x;
    const int r = part_row[t];
    if (r < 0 || (t > 0 && part_row[t - 1] == r)) {
        return;
    }
    const Chunk c = chunk_of(blockIdx.y, ya, nullptr, nullptr, A, b,
                             const_cast<float*>(part_a),
                             const_cast<float*>(part_b), Da, Db, vec_a,
                             vec_b);
    if (c.vec) {
        fold_run<true>(c, part_row, t, n_tiles, r);
    } else {
        fold_run<false>(c, part_row, t, n_tiles, r);
    }
}

template <bool STAGED>
int launch_flush(const int32_t* rows, const float* a_blk, const float* b_blk,
                 float* A, float* b, int32_t* part_row, float* part_a,
                 float* part_b, int S, int n_self, int k, int vec_a,
                 int vec_b, void* stream) {
    const int Da = k * k;
    const int Db = k;
    const int ya = (Da + kCols - 1) / kCols;
    const int yb = (Db + kCols - 1) / kCols;
    const int n_tiles = (S + kTile - 1) / kTile;
    const dim3 grid(n_tiles, ya + yb);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    segment_flush_kernel<STAGED><<<grid, kThreads, 0, st>>>(
        rows, a_blk, b_blk, A, b, part_row, part_a, part_b, S, n_self,
        Da, Db, ya, vec_a, vec_b);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    segment_fold_kernel<<<grid, kThreads, 0, st>>>(
        part_row, part_a, part_b, A, b, n_tiles, Da, Db, ya, vec_a, vec_b);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pio_segment_flush_tile() { return kTile; }

// Plain C entry points for ctypes. Every pointer is device memory on the
// current device; `stream` is a cudaStream_t. Shapes: rows (S,) sorted,
// a_blk (S, k*k), b_blk (S, k), A (n_self, k*k), b (n_self, k); scratch
// part_row (n_tiles,), part_a (n_tiles, k*k), part_b (n_tiles, k) with
// n_tiles = ceil(S / kTile). vec_a / vec_b: 1 when the A / b tensors'
// rows can be read as float4 (k*k resp. k a multiple of 4, 16-byte aligned
// pointers; the same condition allows K3's bulk stores). Each launches the
// flush and the fold on the stream and returns the cudaError_t of the
// launches (0 on success).

// K2, accum="hybrid".
extern "C" int pio_segment_flush(
        const int32_t* rows, const float* a_blk, const float* b_blk,
        float* A, float* b, int32_t* part_row, float* part_a,
        float* part_b, int S, int n_self, int k, int vec_a, int vec_b,
        void* stream) {
    return launch_flush<false>(rows, a_blk, b_blk, A, b, part_row, part_a,
                               part_b, S, n_self, k, vec_a, vec_b, stream);
}

// K3, accum="stream": the same sums, rows written by bulk stores.
extern "C" int pio_segment_flush_stream(
        const int32_t* rows, const float* a_blk, const float* b_blk,
        float* A, float* b, int32_t* part_row, float* part_a,
        float* part_b, int S, int n_self, int k, int vec_a, int vec_b,
        void* stream) {
    return launch_flush<true>(rows, a_blk, b_blk, A, b, part_row, part_a,
                              part_b, S, n_self, k, vec_a, vec_b, stream);
}

extern "C" const char* pio_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
