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
//
// K1, the fused normal equations (`pio_normal_equations_fused`), replaces
// the Pallas TPU kernel `_segment_kernel` with `_ne_slot_fn` (same file,
// reached from `normal_equations_pallas`, ALS accum="pallas"). It takes the
// slot layout itself, not precomputed blocks: rows (S,) sorted with pad
// slots at row n_self, idx/val (S, W), lens (S,), and the opposing factors
// Y (n_other, k) in f32 or bf16. For every row r,
//
//   A[r] = sum over its slots s and entries w < lens[s] of
//          w_outer[s,w] * y[idx[s,w]] (x) y[idx[s,w]]
//   b[r] = the same sum of w_rhs[s,w] * y[idx[s,w]]
//
// with w_outer, w_rhs = alpha*v, 1 + alpha*v (implicit) or 1, v (explicit).
// It gathers, weighs, multiplies and flushes in one pass: the gathered rows
// and the per-slot blocks never reach device memory.
//
// Bound: bytes. At the ML-20M users half (20.0 M ratings, k = 64) the
// function needs, per entry, the k(k+1)/2 products of A's upper triangle (A
// is symmetric) and the k of b: (k(k+1) + 2k)*nnz = 8.58e10 flop, 1.28 ms
// at the f32 FMA rate (67 TFLOP/s) but 0.52 ms as 3xTF32 on the tensor
// cores, under the 0.74 ms of writing A's 2.27 GB at 3.35 TB/s.
//
// Design. Each slot is one small GEMM: A_blk = Y_s^T (w_outer o Y_s), with
// M = N = k and the slot's entries as the reduction dimension. It runs on
// the tensor cores (`mma.sync` m16n8k8, TF32) with the products kept
// f32-accurate by splitting each operand x into hi = x with its low 13
// mantissa bits cleared and lo = x - hi (exact), and summing lo*hi + hi*lo
// + hi*hi (3xTF32; lo*lo is dropped, ~2^-22 of a product). A single TF32 or
// bf16 pass would lose ~3e-3 relative on A, which the CG solve cannot
// recover. Where Y is bf16, y is exact in TF32, so only the weighted
// operand w_outer*y is split: two passes.
//
// Layout. K2's tiles: a CTA takes K2's tile of kTile consecutive slots and
// one kBlk x kBlk block (ib, jb) of A with ib <= jb (grid.y walks the upper
// triangle's blocks). The tile's entries are one stream, slot after slot
// (entries at or past lens[s] are not in it), taken kEnt at a time whatever
// slots they come from, in steps with one barrier each:
//  - the metadata of each entry (index, weights, row) is fetched by one of
//    two groups of kEnt threads four steps ahead and staged two ahead;
//  - the entries' rows of Y are copied raw into a ring of two stages by
//    cp.async a step ahead (16 bytes a copy; element by element where a
//    row is not 16-byte aligned or passes k);
//  - ten warps each own 16 x 16 tiles of the block (in a diagonal block
//    the ten on or above its diagonal, in an off-diagonal block all
//    sixteen) and build their fragments straight from the raw rows: y on
//    the row side, w_outer * y on the column side, split into hi and lo;
//    an eleventh warp sums b, in the diagonal blocks, in f32 FMAs.
// A step is walked in sub-steps of kSub entries and, inside one, in runs of
// one row; an 8-entry fragment that a run covers only in part has its other
// entries zeroed. Each run is summed apart and then added to the open row,
// so no f32 sum runs over more than kSub products. A finished row's tiles
// and their mirrors go through a shared stage (two, alternating) and leave
// as coalesced row stores, so A comes out exactly symmetric. Rows leave as
// in K2: a row that starts in the tile is written (`=`) and flagged, the
// tile's head segment goes to the per-tile partial; then a small kernel
// zeroes every row that no CTA wrote (rows with no entry), and K2's fold
// adds the partials in tile order onto their rows. No float atomics, so two
// runs are bit-identical, and A and b need no zero-fill before the launch.
// A CTA stops at its first pad slot.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>
#include <type_traits>

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

// Loads the row ids of tile `tile` into rows_s and returns how many of its
// slots are real. Sets *head_is_partial when the tile's first row continues
// from before it, and the CTA of grid row 0 records that row in part_row
// (-1 when not). Every thread of the CTA calls it.
__device__ int load_tile_rows(const int32_t* rows, int S, int n_self,
                              int tile, int32_t* rows_s, int32_t* part_row,
                              bool* head_is_partial) {
    __shared__ int n_real_s;
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
    // from the slot before the tile, or, in tile 0, possibly from an
    // earlier call
    *head_is_partial =
        n_real > 0 && (tile == 0 || rows[s_begin - 1] == rows_s[0]);
    if (blockIdx.y == 0 && threadIdx.x == 0) {
        part_row[tile] = *head_is_partial ? rows_s[0] : -1;
    }
    return n_real;
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
    __shared__ __align__(128) float stage[STAGED ? 2 * kCols : 4];
    const int tile = blockIdx.x;
    const size_t s_begin = static_cast<size_t>(tile) * kTile;
    bool head_is_partial;
    const int n_real = load_tile_rows(rows, S, n_self, tile, rows_s, part_row,
                                      &head_is_partial);
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

// -- K1: the fused normal equations -----------------------------------------

constexpr int kBlk = 64;                     // a CTA's block of A: kBlk^2
constexpr int kWt = 16;                      // a warp's tile: kWt x kWt
constexpr int kMmaWarps = 10;                // warps on the tensor cores
constexpr int kNeThreads = (kMmaWarps + 1) * 32;   // + the warp that sums b
constexpr int kSub = 32;                     // entries of one sub-step
constexpr int kEnt = 4 * kSub;               // entries of one step
constexpr int kRing = 2;                     // steps of rows of Y in shared
constexpr int kMeta = kRing + 1;             // steps of metadata in shared
constexpr int kMetaGroups = 2;               // steps of metadata in flight
constexpr int kStrideY = kBlk + 8;           // a staged row, in elements
constexpr int kStrideA = kBlk + 4;           // a row of the flush stage
constexpr uint32_t kTf32Hi = 0xffffe000u;    // sign, exponent, 10 mantissa
// A sub-step's new-row mask is one warp's ballot over its entries; each
// group of kEnt / 32 warps fetches one step's metadata, a thread an entry.
static_assert(kSub == 32, "a sub-step's new-row mask is one 32-bit ballot");
static_assert(kMetaGroups * kEnt <= kMmaWarps * 32,
              "a thread per entry of the steps in flight");
static_assert(kMetaGroups == kRing, "metadata is staged kRing steps ahead");

// the 16 x 16 tiles on or above a diagonal block's diagonal, by warp
__constant__ int8_t kDiagR[kMmaWarps] = {0, 0, 0, 0, 1, 1, 1, 2, 2, 3};
__constant__ int8_t kDiagC[kMmaWarps] = {0, 1, 2, 3, 1, 2, 3, 2, 3, 3};

// The reference's weights, rounded as it rounds them: __fmul_rn keeps nvcc
// from contracting 1 + alpha*v into one FMA.
__device__ __forceinline__ float weight_outer(float v, int implicit,
                                              float alpha) {
    return implicit ? __fmul_rn(alpha, v) : 1.0f;
}

__device__ __forceinline__ float weight_rhs(float v, int implicit,
                                            float alpha) {
    return implicit ? __fadd_rn(1.0f, __fmul_rn(alpha, v)) : v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ float to_f32(uint16_t bf16_bits) {
    return __uint_as_float(static_cast<uint32_t>(bf16_bits) << 16);
}

__device__ __forceinline__ uint32_t tf32_bits(float x) {
    return __float_as_uint(x) & kTf32Hi;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// d += a * b on the tensor cores, TF32 operands (as f32 bits), f32 sum
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// T: float, or uint16_t holding bf16 bits.
template <typename T>
struct NeArgs {
    const int32_t* rows;
    const int32_t* idx;
    const float* val;
    const int32_t* lens;
    const T* src;
    float* A;
    float* b;
    int32_t* part_row;
    float* part_a;
    float* part_b;
    uint8_t* written;   // (n_self,) zeroed: 1 where a CTA assigned the row
    int S, W, n_self, k;
    int n_blk;          // blocks of A along a side
    int vec;            // rows of src can be copied 16 bytes at a time
    int vec_a;          // rows of A (and the partials) take float4 stores
    int implicit;
    float alpha;
};

// K1's dynamic shared memory: two stages of a finished 64 x 64 block on
// its way out, and the ring of staged rows of Y, as stored (f32 or bf16
// bits): the block's row-side columns, and its column-side ones (present
// only when the grid has off-diagonal blocks).
template <typename T>
struct NeSmem {
    float stage[2][kBlk][kStrideA];
    T yi[kRing][kEnt][kStrideY];
    T yj[kRing][kEnt][kStrideY];
};

// The tile's entries form one stream: slot by slot, entries [0, lens[s]).
// Entry g lies in the last slot whose first entry is at or before it
// (empty slots share their start with the next slot).
__device__ __forceinline__ int slot_of(const int32_t* start_s, int n, int g) {
    int lo = 0;
    int hi = n - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (start_s[mid] <= g) {
            lo = mid;
        } else {
            hi = mid - 1;
        }
    }
    return lo;
}

// Grid (n_tiles, n_blk (n_blk + 1) / 2): tile of kTile slots x block
// (ib, jb), ib <= jb, of A. Warps [0, kMmaWarps) sum 16 x 16 tiles of the
// block on the tensor cores (two m16n8 accumulators each); in diagonal
// blocks the last warp sums b's entries [ib * kBlk, (ib + 1) * kBlk), two a
// lane. A step is kEnt entries, walked in sub-steps of kSub. Its metadata
// (index, row, weights) is fetched by one of kMetaGroups groups of threads
// four steps ahead and staged two steps ahead; its rows of Y are copied raw
// into the ring by cp.async a step ahead. One barrier a step, and one a
// finished row, whose block leaves through a shared stage.
template <typename T, int kTiles>
__global__ void __launch_bounds__(kNeThreads, 2)
normal_equations_kernel(const NeArgs<T> p) {
    constexpr bool kSplitY = sizeof(T) == 4;   // f32 y is not exact in TF32
    constexpr int kPer = 16 / sizeof(T);       // elements of a 16-byte copy
    constexpr int kChunks = kBlk / kPer;       // copies of one side's row
    __shared__ int32_t rows_s[kTile];
    __shared__ int32_t start_s[kTile];
    __shared__ int total_s;
    __shared__ int32_t id_s[kMeta][kEnt];
    __shared__ int32_t row_s[kMeta][kEnt];   // the row of each staged entry
    __shared__ float wo_s[kMeta][kEnt];
    __shared__ float wr_s[kMeta][kEnt];
    extern __shared__ __align__(16) unsigned char ne_smem[];
    NeSmem<T>& sm = *reinterpret_cast<NeSmem<T>*>(ne_smem);

    const int tile = blockIdx.x;
    const size_t s_begin = static_cast<size_t>(tile) * kTile;
    bool head_is_partial;
    const int n_real = load_tile_rows(p.rows, p.S, p.n_self, tile, rows_s,
                                      p.part_row, &head_is_partial);
    if (n_real == 0) {
        return;
    }
    if (threadIdx.x < n_real) {
        start_s[threadIdx.x] = max(0, min(p.lens[s_begin + threadIdx.x],
                                          p.W));
    }
    __syncthreads();
    if (threadIdx.x == 0) {                 // lens -> first entry of each slot
        int sum = 0;
        for (int s = 0; s < n_real; ++s) {
            const int len = start_s[s];
            start_s[s] = sum;
            sum += len;
        }
        total_s = sum;
    }
    __syncthreads();
    const int total = total_s;
    const int n_steps = (total + kEnt - 1) / kEnt;

    int ib = 0;
    int q = blockIdx.y;
    while (q >= p.n_blk - ib) {
        q -= p.n_blk - ib;
        ++ib;
    }
    const int jb = ib + q;
    // a grid of one tile a warp has diagonal blocks alone
    const bool diag = kTiles == 1 || ib == jb;
    const int i0 = ib * kBlk;
    const int j0 = jb * kBlk;
    const int k = p.k;
    const size_t k2 = static_cast<size_t>(k) * k;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int grp = lane >> 2;          // the fragments' groupID
    const int tig = lane & 3;           // and thread in group
    const bool rhs_warp = warp == kMmaWarps && diag;

    // this warp's tiles (row, column of 16 x 16 tiles inside the block),
    // the ones wholly past k dropped
    int tr[kTiles], tc[kTiles];
    bool has[kTiles];
#pragma unroll
    for (int x = 0; x < kTiles; ++x) {
        const int t = warp + x * kMmaWarps;
        if (diag) {
            has[x] = warp < kMmaWarps && x == 0;
            tr[x] = has[x] ? kDiagR[t] : 0;
            tc[x] = has[x] ? kDiagC[t] : 0;
        } else {
            has[x] = warp < kMmaWarps && t < 16;
            tr[x] = t / 4;
            tc[x] = t % 4;
        }
        has[x] = has[x] && i0 + tr[x] * kWt < k && j0 + tc[x] * kWt < k;
    }

    // One entry's metadata in registers: thread t < kMetaGroups * kEnt
    // holds entry t % kEnt of the steps congruent to t / kEnt (index and
    // value come from device memory, so each is fetched kMetaGroups steps
    // before it is staged).
    const int meta_group = threadIdx.x < kMetaGroups * kEnt
                           ? threadIdx.x / kEnt : -1;
    const int meta_e = threadIdx.x % kEnt;
    int32_t id_r = 0;
    int32_t row_r = 0;
    float v_r = 0.f;
    auto fetch = [&](int step) {
        const int g = step * kEnt + meta_e;
        if (g < total) {
            const int s = slot_of(start_s, n_real, g);
            const size_t off = (s_begin + s) * p.W + (g - start_s[s]);
            id_r = p.idx[off];
            v_r = p.val[off];
            row_r = rows_s[s];
        }
    };
    auto put_meta = [&](int step) {
        const int m = step % kMeta;
        id_s[m][meta_e] = id_r;
        row_s[m][meta_e] = row_r;
        wo_s[m][meta_e] = weight_outer(v_r, p.implicit, p.alpha);
        wr_s[m][meta_e] = weight_rhs(v_r, p.implicit, p.alpha);
    };
    // The rows of Y of one step into its ring slot, 16 bytes a copy, as one
    // cp.async group (empty past the last step). Where a copy would pass k
    // or src is not 16-byte aligned, plain loads fill it, zeros past k.
    auto issue_y = [&](int step) {
        if (step < n_steps) {
            const int slot = step % kRing;
            const int m = step % kMeta;
            const int ne = min(kEnt, total - step * kEnt);
            const int per = (diag ? 1 : 2) * kChunks;
            for (int c = threadIdx.x; c < ne * per; c += kNeThreads) {
                const int e = c / per;
                const int u = c % per;
                const bool col_side = u >= kChunks;
                const int cc = (col_side ? u - kChunks : u) * kPer;
                const int col = (col_side ? j0 : i0) + cc;
                T* dst = col_side ? &sm.yj[slot][e][cc] : &sm.yi[slot][e][cc];
                const T* row = p.src + static_cast<size_t>(id_s[m][e]) * k;
                if (p.vec && col + kPer <= k) {
                    cp_async16(dst, row + col);
                } else {
                    __align__(16) T v[kPer];
#pragma unroll
                    for (int z = 0; z < kPer; ++z) {
                        v[z] = col + z < k ? row[col + z] : T(0);
                    }
                    *reinterpret_cast<uint4*>(dst) =
                        *reinterpret_cast<const uint4*>(v);
                }
            }
        }
        cp_async_commit();
    };

    // mma warps: blk (hi * hi) and blo (the small terms) as the m16n8
    // accumulator fragments of a run, acc the open row's sum; the rhs
    // warp: b's columns 2 * lane + {0, 1} in blk[0][0] and acc[0][0]
    float acc[kTiles][2][4] = {};
    float blk[kTiles][2][4] = {};
    float blo[kTiles][2][4] = {};
    int cur = rows_s[0];
    bool partial = head_is_partial;
    int n_flushed = 0;
    // The open row's block leaves: every warp puts its tiles (and their
    // mirrors) into a stage, then the CTA writes the block's rows with
    // coalesced stores. Stages alternate, so the barrier of the next
    // flush orders this one's reads before the stage is written again.
    // Every thread calls it at the same point (rows are the same for all).
    auto flush = [&]() {
        if (rhs_warp) {
            float* dst = partial ? p.part_b + static_cast<size_t>(tile) * k
                                 : p.b + static_cast<size_t>(cur) * k;
#pragma unroll
            for (int z = 0; z < 2; ++z) {
                const int c = i0 + 2 * lane + z;
                if (c < k) {
                    dst[c] = acc[0][0][z];
                }
            }
        }
        float (*st)[kStrideA] = sm.stage[n_flushed & 1];
#pragma unroll
        for (int x = 0; x < kTiles; ++x) {
            if (!has[x]) {
                continue;
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
                for (int z = 0; z < 4; ++z) {
                    const int i = tr[x] * kWt + grp + 8 * (z >> 1);
                    const int j = tc[x] * kWt + 8 * nt + 2 * tig + (z & 1);
                    // in a diagonal block (i, j) and (j, i) are one
                    // element: the one on or above the diagonal writes both
                    if (!diag || i <= j) {
                        const float v = acc[x][nt][z];
                        st[i][j] = v;
                        if (diag) {
                            st[j][i] = v;
                        }
                    }
                }
            }
        }
        __syncthreads();
        float* dst = partial ? p.part_a + tile * k2 : p.A + cur * k2;
        const int n_i = min(kBlk, k - i0);
        const int n_j = min(kBlk, k - j0);
        if (p.vec_a) {
            // rows of float4: k and both blocks' starts are multiples of 4
            const int q4 = (n_j + 3) / 4;
            for (int t = threadIdx.x; t < n_i * q4; t += kNeThreads) {
                const int i = t / q4;
                const int j = 4 * (t % q4);
                const float4 v = *reinterpret_cast<const float4*>(&st[i][j]);
                *reinterpret_cast<float4*>(
                    dst + static_cast<size_t>(i0 + i) * k + j0 + j) = v;
                if (!diag) {     // the mirror block, column by column
                    float* m = dst + static_cast<size_t>(j0 + j) * k + i0 + i;
                    m[0] = v.x;
                    m[k] = v.y;
                    m[2 * k] = v.z;
                    m[3 * k] = v.w;
                }
            }
        } else {
            for (int t = threadIdx.x; t < n_i * n_j; t += kNeThreads) {
                const int i = t / n_j;
                const int j = t % n_j;
                const float v = st[i][j];
                dst[static_cast<size_t>(i0 + i) * k + j0 + j] = v;
                if (!diag) {
                    dst[static_cast<size_t>(j0 + j) * k + i0 + i] = v;
                }
            }
        }
        if (!partial && blockIdx.y == 0 && threadIdx.x == 0) {
            p.written[cur] = 1;
        }
        ++n_flushed;
#pragma unroll
        for (int x = 0; x < kTiles; ++x)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int z = 0; z < 4; ++z) acc[x][nt][z] = 0.f;
    };

    // Entries [e, end) of a step, all of one row. Fragments come straight
    // from the raw rows: y on the row side (split where f32), w_outer * y
    // on the column side, split into hi and lo; entries outside the run
    // are zero in both operands. A group of 8 wholly inside the run (the
    // common case) takes a copy of the body without the masks.
    auto mma_group = [&](int slot, int m, int g8, int e, int end,
                         auto whole) {
        constexpr bool kWhole = decltype(whole)::value;
        const T (*yi)[kStrideY] = sm.yi[slot];
        const T (*yj)[kStrideY] = diag ? sm.yi[slot] : sm.yj[slot];
        const int e0 = g8 + tig;
        const int e1 = e0 + 4;
        const bool in0 = kWhole || (e0 >= e && e0 < end);
        const bool in1 = kWhole || (e1 >= e && e1 < end);
        const float wo0 = wo_s[m][e0];
        const float wo1 = wo_s[m][e1];
#pragma unroll
        for (int x = 0; x < kTiles; ++x) {
            if (!has[x]) {
                continue;
            }
            const int ia = tr[x] * kWt + grp;
            const float av[4] = {to_f32(yi[e0][ia]), to_f32(yi[e0][ia + 8]),
                                 to_f32(yi[e1][ia]), to_f32(yi[e1][ia + 8])};
            const bool in[4] = {in0, in0, in1, in1};
            uint32_t a_hi[4], a_lo[4];
#pragma unroll
            for (int z = 0; z < 4; ++z) {
                const uint32_t hi = tf32_bits(av[z]);
                a_hi[z] = in[z] ? hi : 0u;
                a_lo[z] = in[z] && kSplitY
                    ? tf32_bits(av[z] - __uint_as_float(hi)) : 0u;
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                const int jn = tc[x] * kWt + 8 * nt + grp;
                const float w0 = __fmul_rn(to_f32(yj[e0][jn]), wo0);
                const float w1 = __fmul_rn(to_f32(yj[e1][jn]), wo1);
                const uint32_t h0 = tf32_bits(w0);
                const uint32_t h1 = tf32_bits(w1);
                const uint32_t bh0 = in0 ? h0 : 0u;
                const uint32_t bh1 = in1 ? h1 : 0u;
                const uint32_t bl0 =
                    in0 ? tf32_bits(w0 - __uint_as_float(h0)) : 0u;
                const uint32_t bl1 =
                    in1 ? tf32_bits(w1 - __uint_as_float(h1)) : 0u;
                if (kSplitY) {
                    mma_tf32(blo[x][nt], a_lo, bh0, bh1);
                }
                mma_tf32(blo[x][nt], a_hi, bl0, bl1);
                mma_tf32(blk[x][nt], a_hi, bh0, bh1);
            }
        }
    };
    auto mma_run = [&](int slot, int m, int e, int end) {
#pragma unroll 4
        for (int g8 = e & ~7; g8 < end; g8 += 8) {
            if (g8 >= e && g8 + 8 <= end) {
                mma_group(slot, m, g8, e, end, std::true_type());
            } else {
                mma_group(slot, m, g8, e, end, std::false_type());
            }
        }
    };
    auto rhs_run = [&](int slot, int m, int e, int end) {
        for (; e < end; ++e) {
            const float w = wr_s[m][e];
#pragma unroll
            for (int z = 0; z < 2; ++z) {
                const float y = to_f32(sm.yi[slot][e][2 * lane + z]);
                blk[0][0][z] = fmaf(y, w, blk[0][0][z]);
            }
        }
    };

    // prologue: steps [0, kRing) of metadata staged, the next kMetaGroups
    // in registers, the rows of Y of step 0 in flight
    if (meta_group >= 0) {
        fetch(meta_group);
        put_meta(meta_group);
        fetch(meta_group + kMetaGroups);
    }
    __syncthreads();
    issue_y(0);

    for (int step = 0; step < n_steps; ++step) {
        const int slot = step % kRing;
        const int m = step % kMeta;
        const int ne = min(kEnt, total - step * kEnt);
        cp_async_wait<0>();   // this thread's copies of the step
        __syncthreads();      // everyone's; the step before is done
        issue_y(step + 1);
        if (meta_group == step % kMetaGroups) {
            put_meta(step + kRing);
            fetch(step + kRing + kMetaGroups);
        }
        for (int e_sub = 0; e_sub < ne; e_sub += kSub) {
            const int ns = min(kSub, ne - e_sub);
            const uint32_t starts = __ballot_sync(
                0xffffffffu,
                lane > 0 && lane < ns
                    && row_s[m][e_sub + lane] != row_s[m][e_sub + lane - 1]);
            for (int e = 0; e < ns;) {
                const uint32_t later = e + 1 < 32 ? starts >> (e + 1) : 0u;
                const int end = later ? e + __ffs(later) : ns;
                if (row_s[m][e_sub + e] != cur) {
                    flush();
                    cur = row_s[m][e_sub + e];
                    partial = false;
                }
                if (rhs_warp) {
                    rhs_run(slot, m, e_sub + e, e_sub + end);
                } else if (warp < kMmaWarps) {
                    mma_run(slot, m, e_sub + e, e_sub + end);
                }
#pragma unroll
                for (int x = 0; x < kTiles; ++x)
#pragma unroll
                    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                        for (int z = 0; z < 4; ++z) {
                            // the run's sum, small terms first, joins the row
                            acc[x][nt][z] += blo[x][nt][z] + blk[x][nt][z];
                            blk[x][nt][z] = 0.f;
                            blo[x][nt][z] = 0.f;
                        }
                e = end;
            }
        }
    }
    cp_async_wait<0>();
    flush();
}

// Rows that no CTA of K1 assigned (no entry in the layout, or none in the
// tile of their first slot) become zero, before the fold adds partials onto
// them. A warp per row.
__global__ void __launch_bounds__(kThreads)
zero_unwritten_kernel(const uint8_t* __restrict__ written,
                      float* __restrict__ A, float* __restrict__ b,
                      int n_self, int k) {
    const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
    if (r >= n_self || written[r]) {
        return;
    }
    const int lane = threadIdx.x & 31;
    const size_t k2 = static_cast<size_t>(k) * k;
    float* a = A + r * k2;
    for (size_t x = lane; x < k2; x += 32) {
        a[x] = 0.f;
    }
    for (int x = lane; x < k; x += 32) {
        b[static_cast<size_t>(r) * k + x] = 0.f;
    }
}

// A, b and the partials are the wrapper's own allocations, so their rows
// move as float4 in the fold wherever the row length is a multiple of 4.
template <typename T>
int launch_fused(const NeArgs<T>& p, void* stream) {
    const int n_tiles = (p.S + kTile - 1) / kTile;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    // the column side of the ring only where there are off-diagonal blocks
    const int smem = static_cast<int>(
        p.n_blk > 1 ? sizeof(NeSmem<T>) : offsetof(NeSmem<T>, yj));
    // a warp owns one tile of a diagonal block and two of an off-diagonal
    // one: grids of diagonal blocks alone (k <= 64) keep one in registers
    auto kernel = p.n_blk > 1 ? normal_equations_kernel<T, 2>
                              : normal_equations_kernel<T, 1>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    kernel<<<dim3(n_tiles, p.n_blk * (p.n_blk + 1) / 2), kNeThreads, smem,
             st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const int rows_per_cta = kThreads / 32;
    zero_unwritten_kernel<<<(p.n_self + rows_per_cta - 1) / rows_per_cta,
                            kThreads, 0, st>>>(p.written, p.A, p.b,
                                               p.n_self, p.k);
    err = cudaGetLastError();
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    // K2's fold, over K2's column chunks of the same partials
    const int Da = p.k * p.k;
    const int ya = (Da + kCols - 1) / kCols;
    const int yb = (p.k + kCols - 1) / kCols;
    segment_fold_kernel<<<dim3(n_tiles, ya + yb), kThreads, 0, st>>>(
        p.part_row, p.part_a, p.part_b, p.A, p.b, n_tiles, Da, p.k, ya,
        Da % 4 == 0, p.k % 4 == 0);
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

// K1, accum="pallas". rows (S,), idx (S, W) int32, val (S, W) f32, lens (S,)
// int32; src (n_other, k) f32, or bf16 when src_bf16; A (n_self, k*k) and
// b (n_self, k), which need not be zeroed: every element is written;
// scratch as for K2, and written (n_self,) uint8 zeroed. The wrapper checks
// the shapes and 1 <= k <= 1024 (its MAX_K_FUSED).
extern "C" int pio_normal_equations_fused(
        const int32_t* rows, const int32_t* idx, const float* val,
        const int32_t* lens, const void* src, float* A, float* b,
        int32_t* part_row, float* part_a, float* part_b, uint8_t* written,
        int S, int W, int n_self, int k, int src_bf16, int implicit,
        float alpha, void* stream) {
    const int n_blk = (k + kBlk - 1) / kBlk;
    // rows copied 16 bytes at a time: every row starts 16-byte aligned
    const int vec = (static_cast<size_t>(k) * (src_bf16 ? 2 : 4)) % 16 == 0
                    && reinterpret_cast<uintptr_t>(src) % 16 == 0;
    // A and the partials are the wrapper's own 16-byte aligned allocations
    const int vec_a = k % 4 == 0;
    if (src_bf16) {
        const NeArgs<uint16_t> p{rows, idx, val, lens,
                                 static_cast<const uint16_t*>(src), A, b,
                                 part_row, part_a, part_b, written, S, W,
                                 n_self, k, n_blk, vec, vec_a, implicit,
                                 alpha};
        return launch_fused(p, stream);
    }
    const NeArgs<float> p{rows, idx, val, lens, static_cast<const float*>(src),
                          A, b, part_row, part_a, part_b, written, S, W,
                          n_self, k, n_blk, vec, vec_a, implicit, alpha};
    return launch_fused(p, stream);
}

extern "C" const char* pio_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
