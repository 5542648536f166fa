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
// Bound: operations. At the ML-20M users half (20.0 M ratings, k = 64) the
// function needs, per entry, the k(k+1)/2 products of A's upper triangle (A
// is symmetric) and the k of b: (k(k+1) + 2k)*nnz = 8.58e10 flop, 1.28 ms
// at the f32 FMA rate (67 TFLOP/s), 0.52 ms as 3xTF32 on the tensor cores;
// writing A is 2.27 GB, 0.74 ms at 3.35 TB/s. K1 computes the whole k x k
// block, twice the products. They run as f32 FMAs on the CUDA cores (no
// single-pass TF32 or bf16 MMA: that loses ~3e-3 relative on A, which the
// CG solve cannot recover).
//
// Layout. K2's tiles: a CTA takes K2's tile of kTile consecutive slots and
// one kBlk x kBlk block of A (grid.y walks the blocks); 256 threads each sum
// a 4 x 4 micro-tile of the block in registers, and in the blocks of the
// first block column a ninth warp sums the matching 64 entries of b. The
// tile's entries are one stream, slot after slot (entries at or past
// lens[s] are not in it), which the CTA stages kEnt at a time whatever
// slots they come from, so a short slot costs no round trip of its own:
// each entry's index, weights and row, with the next step's already loaded
// into registers, then the kBlk columns of its row of Y on the block's row
// side and (weighted) on its column side, as f32 in shared memory. A staged
// entry then costs a thread two float4 reads for 16 FMAs. Each step is
// summed apart and then added to the open row, so no f32 sum runs over more
// than kEnt products. Rows leave as in K2: a row that starts in the tile is
// written (`=`), the tile's head segment goes to the per-tile partial, and
// K2's fold kernel adds the partials in tile order; no float atomics, so two
// runs are bit-identical. Callers pass A and b zeroed (rows with no entry
// are never written, and tile 0's head is folded onto its row). A CTA stops
// at its first pad slot.

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
constexpr int kMicro = 4;                    // a thread's micro-tile: 4 x 4
constexpr int kSide = kBlk / kMicro;         // threads along a block's side
constexpr int kBlockThreads = kSide * kSide;
constexpr int kNeThreads = kBlockThreads + 32;   // + the warp that sums b
constexpr int kEnt = 64;                     // entries staged at a time
// A step's new-row mask is two warps' ballots read as one 64-bit word. With
// fewer entries its high word would not be written each step, and a stale
// bit there could end a run past the staged entries: a row id read out of
// bounds, then a store of A to that row.
static_assert(kEnt == 64, "a step's new-row mask is one 64-bit word");

__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ float to_f32(uint16_t bf16_bits) {
    return __uint_as_float(static_cast<uint32_t>(bf16_bits) << 16);
}

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
    int S, W, n_self, k;
    int n_blk;          // blocks of A along a side
    int implicit;
    float alpha;
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

using Micro = float[kMicro][kMicro];

// acc += blk; blk = 0
__device__ __forceinline__ void add_into(Micro& acc, Micro& blk) {
#pragma unroll
    for (int x = 0; x < kMicro; ++x) {
#pragma unroll
        for (int y = 0; y < kMicro; ++y) {
            acc[x][y] += blk[x][y];
            blk[x][y] = 0.f;
        }
    }
}

__device__ __forceinline__ void zero(Micro& acc) {
#pragma unroll
    for (int x = 0; x < kMicro; ++x) {
#pragma unroll
        for (int y = 0; y < kMicro; ++y) {
            acc[x][y] = 0.f;
        }
    }
}

// Rows i..i+3, columns j..j+3 of the (k, k) row block at dst.
__device__ __forceinline__ void store_micro(float* dst, int k, int i, int j,
                                            const Micro& v, bool vec) {
    if (j >= k) {
        return;
    }
#pragma unroll
    for (int x = 0; x < kMicro; ++x) {
        if (i + x < k) {
            float* row = dst + static_cast<size_t>(i + x) * k + j;
            if (vec) {
                *reinterpret_cast<float4*>(row) =
                    make_float4(v[x][0], v[x][1], v[x][2], v[x][3]);
            } else {
#pragma unroll
                for (int y = 0; y < kMicro; ++y) {
                    if (j + y < k) {
                        row[y] = v[x][y];
                    }
                }
            }
        }
    }
}

// Grid (n_tiles, n_blk * n_blk): tile of kTile slots x block (ib, jb) of A.
// Threads [0, kBlockThreads) sum the block's 4 x 4 micro-tiles; in the CTAs
// with jb == 0, lanes [0, kSide) of the last warp sum b's entries
// [ib * kBlk, (ib + 1) * kBlk) from the same staged rows, in the same
// registers. Each step stages kEnt entries of the tile's stream, whatever
// slots they belong to, with the next step's indices and values already in
// flight, and walks them in runs of one row (a bit mask of the entries
// where a new row starts), so the FMA loop has no branch. Every thread sums
// a step's run in `blk` before adding it to the open row's `acc`, so no f32
// sum runs over more than kEnt products.
template <typename T>
__global__ void __launch_bounds__(kNeThreads, 3)
normal_equations_kernel(const NeArgs<T> p) {
    __shared__ int32_t rows_s[kTile];
    __shared__ int32_t start_s[kTile];
    __shared__ int total_s;
    __shared__ int32_t id_s[kEnt];
    __shared__ int32_t row_s[kEnt];      // the row of each staged entry
    __shared__ uint32_t new_row_s[kEnt / 32];   // bit e: row_s[e] starts a row
    __shared__ float wo_s[kEnt];
    __shared__ float wr_s[kEnt];
    __shared__ __align__(16) float yi_s[kEnt][kBlk];   // y, the block's rows
    __shared__ __align__(16) float yj_s[kEnt][kBlk];   // w_outer * y, columns
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

    const int ib = blockIdx.y / p.n_blk;
    const int jb = blockIdx.y % p.n_blk;
    const int i0 = ib * kBlk;
    const int j0 = jb * kBlk;
    const bool block_thread = threadIdx.x < kBlockThreads;
    const int lane = threadIdx.x - kBlockThreads;
    const bool rhs_thread = !block_thread && jb == 0 && lane < kSide;
    const int ti = block_thread ? threadIdx.x / kSide : lane;
    const int tj = block_thread ? threadIdx.x % kSide : 0;
    const size_t k2 = static_cast<size_t>(p.k) * p.k;

    // one staged entry, fetched into registers a step ahead
    int32_t id_r = 0;
    int32_t row_r = 0;
    float v_r = 0.f;
    auto fetch = [&](int g) {
        const int s = slot_of(start_s, n_real, g);
        const size_t off = (s_begin + s) * p.W + (g - start_s[s]);
        id_r = p.idx[off];
        v_r = p.val[off];
        row_r = rows_s[s];
    };
    if (threadIdx.x < min(kEnt, total)) {
        fetch(threadIdx.x);
    }

    // block threads: the micro-tile; rhs threads: b in row 0
    Micro acc = {};
    Micro blk = {};
    int cur = rows_s[0];
    bool partial = head_is_partial;
    auto flush = [&]() {
        add_into(acc, blk);
        if (block_thread) {
            float* dst = partial ? p.part_a + tile * k2 : p.A + cur * k2;
            store_micro(dst, p.k, i0 + ti * kMicro, j0 + tj * kMicro, acc,
                        p.k % 4 == 0);
        } else if (rhs_thread) {
            float* dst = partial ? p.part_b + static_cast<size_t>(tile) * p.k
                                 : p.b + static_cast<size_t>(cur) * p.k;
            const int j = i0 + ti * kMicro;
#pragma unroll
            for (int y = 0; y < kMicro; ++y) {
                if (j + y < p.k) {
                    dst[j + y] = acc[0][y];
                }
            }
        }
        zero(acc);
    };

    for (int e0 = 0; e0 < total; e0 += kEnt) {
        const int ne = min(kEnt, total - e0);
        __syncthreads();                    // the step before read the stage
        if (threadIdx.x < ne) {
            id_s[threadIdx.x] = id_r;
            row_s[threadIdx.x] = row_r;
            wo_s[threadIdx.x] = weight_outer(v_r, p.implicit, p.alpha);
            wr_s[threadIdx.x] = weight_rhs(v_r, p.implicit, p.alpha);
        }
        __syncthreads();
        if (threadIdx.x < kEnt) {
            const int t = threadIdx.x;
            const uint32_t starts = __ballot_sync(
                0xffffffffu, t > 0 && t < ne && row_s[t] != row_s[t - 1]);
            if (t % 32 == 0) {
                new_row_s[t / 32] = starts;
            }
            if (e0 + kEnt + t < total) {
                fetch(e0 + kEnt + t);
            }
        }
        for (int t = threadIdx.x; t < ne * kBlk; t += kNeThreads) {
            const int e = t / kBlk;
            const int c = t % kBlk;
            const T* y = p.src + static_cast<size_t>(id_s[e]) * p.k;
            const float yi = i0 + c < p.k ? to_f32(y[i0 + c]) : 0.f;
            const float yj = ib == jb ? yi
                : (j0 + c < p.k ? to_f32(y[j0 + c]) : 0.f);
            yi_s[e][c] = yi;
            yj_s[e][c] = __fmul_rn(yj, wo_s[e]);
        }
        __syncthreads();
        if (!block_thread && !rhs_thread) {
            continue;
        }
        const uint64_t starts = (static_cast<uint64_t>(new_row_s[1]) << 32)
                                | new_row_s[0];
        for (int e = 0; e < ne;) {
            const uint64_t later = e + 1 < 64 ? starts >> (e + 1) : 0;
            const int end = later ? e + __ffsll(later) : ne;
            if (row_s[e] != cur) {
                flush();
                cur = row_s[e];
                partial = false;
            }
            if (block_thread) {
#pragma unroll 4
                for (; e < end; ++e) {
                    const float4 a = *reinterpret_cast<const float4*>(
                        &yi_s[e][ti * kMicro]);
                    const float4 c = *reinterpret_cast<const float4*>(
                        &yj_s[e][tj * kMicro]);
                    const float av[kMicro] = {a.x, a.y, a.z, a.w};
                    const float cv[kMicro] = {c.x, c.y, c.z, c.w};
#pragma unroll
                    for (int x = 0; x < kMicro; ++x) {
#pragma unroll
                        for (int y = 0; y < kMicro; ++y) {
                            blk[x][y] = fmaf(av[x], cv[y], blk[x][y]);
                        }
                    }
                }
            } else {
#pragma unroll 4
                for (; e < end; ++e) {
                    const float4 a = *reinterpret_cast<const float4*>(
                        &yi_s[e][ti * kMicro]);
                    const float w = wr_s[e];
                    blk[0][0] = fmaf(a.x, w, blk[0][0]);
                    blk[0][1] = fmaf(a.y, w, blk[0][1]);
                    blk[0][2] = fmaf(a.z, w, blk[0][2]);
                    blk[0][3] = fmaf(a.w, w, blk[0][3]);
                }
            }
            add_into(acc, blk);
        }
    }
    flush();
}

// A, b and the partials are the wrapper's own allocations, so their rows
// move as float4 wherever the row length is a multiple of 4.
template <typename T>
int launch_fused(const NeArgs<T>& p, void* stream) {
    const int n_tiles = (p.S + kTile - 1) / kTile;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    normal_equations_kernel<T>
        <<<dim3(n_tiles, p.n_blk * p.n_blk), kNeThreads, 0, st>>>(p);
    cudaError_t err = cudaGetLastError();
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
// b (n_self, k) zeroed; scratch as for K2. The wrapper checks the shapes
// and 1 <= k <= 1024 (its MAX_K_FUSED).
extern "C" int pio_normal_equations_fused(
        const int32_t* rows, const int32_t* idx, const float* val,
        const int32_t* lens, const void* src, float* A, float* b,
        int32_t* part_row, float* part_a, float* part_b, int S, int W,
        int n_self, int k, int src_bf16, int implicit, float alpha,
        void* stream) {
    const int n_blk = (k + kBlk - 1) / kBlk;
    if (src_bf16) {
        const NeArgs<uint16_t> p{rows, idx, val, lens,
                                 static_cast<const uint16_t*>(src), A, b,
                                 part_row, part_a, part_b, S, W, n_self, k,
                                 n_blk, implicit, alpha};
        return launch_fused(p, stream);
    }
    const NeArgs<float> p{rows, idx, val, lens, static_cast<const float*>(src),
                          A, b, part_row, part_a, part_b, S, W, n_self, k,
                          n_blk, implicit, alpha};
    return launch_fused(p, stream);
}

extern "C" const char* pio_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
