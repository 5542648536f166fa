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
// Masked scores are -1e30 and their probabilities 0, as in the reference.
// Key tiles wholly above the diagonal are not visited, and the query tiles
// are launched last-first so the longest causal rows start first. No
// atomics and no row split across CTAs: two launches are bit-identical.
// Each input type has its own kernel.
//
// f32: `flash_attention_f32_kernel`, on the tensor cores (`wgmma`) in
// 3xTF32. A CTA of two warpgroups (one at D 128, for shared memory) takes
// one (batch, head) and 64 query rows a warpgroup. One of its threads
// loads the q tiles once and streams 64-key K and V tiles by TMA through
// a ring of two stages (one at D 128), over the same strided views as
// the bf16 kernel, in boxes of 32 f32 columns (128 B a row) swizzled
// 128 B; rows past Sq or Sk arrive as zeros. Each tile:
//   split       the CTA's threads split every f32 x into TF32 hi = x with
//               its low 13 mantissa bits cleared and lo = x - hi (exact):
//               q once a CTA and K in place (lo beside it), V into hi and
//               lo tiles of v^T, because wgmma reads a TF32 B operand
//               K-major only and TMA cannot transpose; shared by both
//               warpgroups;
//   S = Q K^T   wgmma m64n64k8 from shared memory, lo hi + hi lo + hi hi
//               summed in f32 (lo lo, ~2^-22 of a product, dropped): each
//               product f32-accurate; the scale (base 2) applied after;
//   softmax     on the accumulator fragment, as in the bf16 kernel: masks
//               only on the tiles at a warp's diagonal or past Sk, the
//               scale folded into one FMA before each exp2 elsewhere;
//   O += P V    register-A wgmma, p split into hi and lo in registers,
//               the same three products. The A fragment takes the
//               accumulator's registers as they are, which orders each
//               group of 8 keys 0, 2, 4, 6, 1, 3, 5, 7; v^T is written in
//               that order, so no shuffle is needed.
// A barrier after each tile's split, and one before every split but the
// first (q's split joins tile 0's), order the ring and the split tiles; a
// warpgroup whose rows see no key of a tile (causal) skips its products.
// One TF32 pass (10 mantissa bits) would put outputs ~2e-3 from the f32
// attention, a hundred times the f32 tolerance (2e-5); the split keeps
// each product to about 2^-21. Bound: 4 D flops a kept pair at the TF32
// rate over 3 (each product is three), or q, k, v and o moved once; at
// the serving shapes (63 rows, two CTAs) a launch's latency.
//
// bf16: `flash_attention_bf16_kernel`, on the tensor cores. A CTA of three
// warpgroups takes one (batch, head) and 128 query rows: warpgroups 0 and
// 1 (the consumers, 240 registers each thread by `setmaxnreg`) own 64 rows
// each; one thread of warpgroup 2 (the producer, 24 registers) loads the
// q tile once and streams 128-key K and V tiles by TMA through a ring of
// three stages, completed on mbarriers and released by the consumers.
// The tensor maps are encoded on the host at each launch over the strided
// (B, S, H, D) views (boxes of D x 1 x rows x 1, or of 64 columns each at
// D 128), swizzled 128 B (64 B at D 32) as the wgmma descriptors read them;
// rows past Sq or Sk arrive as zeros. Per tile and consumer:
//   S = Q K^T   wgmma m64n128k16, bf16 q and k unscaled from shared memory,
//               so each product is exact, summed in f32; the scale (base 2)
//               applied in f32 afterwards;
//   softmax     on the accumulator fragment: a thread holds two rows of 32
//               scores, a row lies in 4 threads (2 shuffles for its max);
//               l is summed from the f32 p. Only the tiles on the diagonal
//               or past Sk compute masks; the others fold the scale into
//               one FMA before each exp2;
//   O += P V    p split into bf16 hi = bf16(p) and lo = bf16(p - hi), two
//               register-A wgmma each (hi V + lo V), V read MN-major
//               (transposed) from shared memory, f32 accumulation.
// The products are asynchronous: while a consumer runs the softmax of
// tile t, its P V of tile t - 1 runs on the tensor cores, and the other
// consumer's work fills the gaps.
// A single bf16 rounding of p would put a quarter of the outputs outside
// 2^-8 |o| of the f32 attention; the split keeps p to about 16 bits.
// Bound: 4 D flops a kept pair at the dense bf16 rate (the split makes it
// 6 D on the tensor cores), and one exp2 a pair on the SFUs, whose rate
// is about 1/250 of the tensor cores' flops: at D 64 the two are close.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;

// -- bf16: warp-specialized, TMA-fed, on wgmma -------------------------------

constexpr int kWgRows = 64;        // query rows of a consumer
constexpr int kKeys = 128;         // keys of a K/V tile
constexpr int kConsumers = 2;      // consumer warpgroups
constexpr int kWgThreads = 128;
constexpr int kBf16Threads = kWgThreads * (kConsumers + 1);
constexpr int kCtaRows = kConsumers * kWgRows;
constexpr int kProducerRegs = 24;  // 128 x 24 + 256 x 240 <= 65,536
constexpr int kConsumerRegs = 240;

// error codes of the bf16 launch besides cudaError_t's
constexpr int kErrNoEncoder = -1;  // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = -2;     // cuTensorMapEncodeTiled refused a map

// Shared memory of one CTA: the q tiles of both consumers (64 rows of D),
// then the K and V rings (tiles of 128 keys), each tile one or two TMA
// boxes of up to 64 columns (a box row is the swizzle span, 64 or 128
// bytes), then the mbarriers. Tiles are 1024-byte aligned, as the swizzle
// patterns repeat.
template <int D>
struct Bf16Tile {
    static constexpr int kBox = D < 64 ? D : 64;   // columns per TMA box
    static constexpr int kBoxes = D / kBox;
    static constexpr int kRowBytes = 2 * kBox;
    static constexpr int kQBoxBytes = kWgRows * kRowBytes;
    static constexpr int kQBytes = kBoxes * kQBoxBytes;
    static constexpr int kBoxBytes = kKeys * kRowBytes;
    static constexpr int kBytes = kBoxes * kBoxBytes;   // a K or V tile
    static constexpr int kStages = 3;                   // K/V ring depth
    static constexpr int kKSteps = kRowBytes / 32;      // k16 steps a box
    static constexpr uint32_t kGroupBytes = 8 * kRowBytes;   // 8-row group
    // wgmma descriptor layout: 1 = 128-byte swizzle, 2 = 64-byte
    static constexpr uint64_t kLayout = D < 64 ? 2 : 1;
    static constexpr int kKOff = kConsumers * kQBytes;
    static constexpr int kVOff = kKOff + kStages * kBytes;
    static constexpr int kBarOff = kVOff + kStages * kBytes;
    static constexpr size_t kSmem = 1024 + kBarOff + 8 * (2 * kStages + 1);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// One TMA box of a (D, H, S, B) map at coordinates (c0, c1, c2, c3) into
// shared memory, completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
           "r"(c2), "r"(c3), "r"(bar)
        : "memory");
}

// wgmma shared-memory descriptor: start, leading and stride byte offsets
// (16-byte units), swizzle layout
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint64_t layout,
                                              uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32)
         | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous products' issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        asm volatile("" : "+f"(r[i]) :: "memory");
    }
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// bf16 hi = bf16(x), lo = bf16(x - hi) of two f32 values, each packed as
// the low (x) and high (y) halves of a 32-bit register
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

// S (+)= A B^T, m64n128k16: A (64 x 16) and B (128 x 16) K-major in
// shared memory; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63 "
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
}

// d += A B, m64n32k16: A (64 x 16) in registers, B (16 x 32) MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15 "
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B, m64n64k16: A (64 x 16) in registers, B (16 x 64) MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
    if constexpr (N == 32) {
        wgmma_rs_n32(d, a, b);
    } else {
        wgmma_rs_n64(d, a, b);
    }
}

// Issues S = Q K^T of one key tile into `sc` (not waited for): q (this
// warpgroup's 64 rows) and k (128 keys) K-major in shared memory.
template <int D>
__device__ __forceinline__ void issue_scores(float (&sc)[kKeys / 2],
                                             uint32_t q_wg, uint32_t k_t) {
    using T = Bf16Tile<D>;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < T::kBoxes; ++x) {
#pragma unroll
        for (int kk = 0; kk < T::kKSteps; ++kk) {
            wgmma_ss_n128(
                sc,
                smem_desc(q_wg + x * T::kQBoxBytes + kk * 32, T::kLayout, 16,
                          T::kGroupBytes),
                smem_desc(k_t + x * T::kBoxBytes + kk * 32, T::kLayout, 16,
                          T::kGroupBytes),
                x + kk > 0);
        }
    }
    wgmma_commit();
}

// The masks and the online-softmax update of one key tile of N keys
// starting at k0, on the accumulator fragment: this thread's rows r0 and
// r0 + 8 hold N / 4 scores each, columns k0 + 8 j + c0 + {0, 1}. Turns
// `sc` into p (f32), updates the running max m (base 2) and this thread's
// part of l, and gives the factor by which each row's output is rescaled.
// kMask: the tile holds keys past Sk or above some row's diagonal; only
// such tiles pay for the masks, and scale their scores first. Other tiles
// take the max of the raw scores (of their negation when kNeg, the scale
// being negative) and fold the scale into one FMA a score.
template <int N, bool kMask, bool kNeg>
__device__ __forceinline__ void softmax_tile(float (&sc)[N / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0,
                                             int r0, int c0, int Sk,
                                             bool causal, float scale_log2) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        // four partial maxima and sums: short dependent chains
        const int row = r0 + 8 * r;
        const auto keep = [&](int j, int e) {
            const int col = k0 + 8 * j + c0 + e;
            return !kMask || (col < Sk && (!causal || col <= row));
        };
        float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                float& x = sc[4 * j + 2 * r + e];
                if constexpr (kMask) {
                    x = keep(j, e) ? x * scale_log2 : kNegInf;
                }
                mx[j % 4] = fmaxf(mx[j % 4], kNeg ? -x : x);
            }
        }
        float m_tile = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
        m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
        m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
        if constexpr (!kMask) {
            m_tile = (kNeg ? -m_tile : m_tile) * scale_log2;
        }
        const float m_new = fmaxf(m[r], m_tile);
        float rs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                float& x = sc[4 * j + 2 * r + e];
                if constexpr (kMask) {
                    x = keep(j, e) ? ex2(x - m_new) : 0.f;
                } else {
                    x = ex2(fmaf(x, scale_log2, -m_new));
                }
                rs[j % 4] += x;
            }
        }
        alpha[r] = ex2(m[r] - m_new);
        l[r] = l[r] * alpha[r] + ((rs[0] + rs[1]) + (rs[2] + rs[3]));
        m[r] = m_new;
    }
}

// p (f32) as bf16 hi and lo A fragments of P V: keys 16 kk.. of the
// accumulator fragment are its registers 8 kk .. 8 kk + 7, in the order of
// A's.
__device__ __forceinline__ void split_p(const float (&p)[kKeys / 2],
                                        uint32_t (&ph)[kKeys / 16][4],
                                        uint32_t (&pl)[kKeys / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            split_bf16(p[8 * kk + 2 * i], p[8 * kk + 2 * i + 1], ph[kk][i],
                       pl[kk][i]);
        }
    }
}

// Issues acc += P V of one key tile (not waited for): P as hi and lo A
// fragments, V (128 keys x D) MN-major from shared memory, one or two
// 64-column boxes.
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&acc)[Bf16Tile<D>::kBoxes][Bf16Tile<D>::kBox / 2],
    const uint32_t (&ph)[kKeys / 16][4], const uint32_t (&pl)[kKeys / 16][4],
    uint32_t v_t) {
    using T = Bf16Tile<D>;
#pragma unroll
    for (int x = 0; x < T::kBoxes; ++x) {
        fence_regs(acc[x]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x) {
            const uint64_t vd = smem_desc(
                v_t + x * T::kBoxBytes + kk * 16 * T::kRowBytes, T::kLayout,
                T::kBoxBytes, T::kGroupBytes);
            wgmma_rs<T::kBox>(acc[x], ph[kk], vd);
            wgmma_rs<T::kBox>(acc[x], pl[kk], vd);
        }
    }
    wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_attention_bf16_kernel(__grid_constant__ const CUtensorMap qmap,
                            __grid_constant__ const CUtensorMap kmap,
                            __grid_constant__ const CUtensorMap vmap,
                            __nv_bfloat16* __restrict__ o, int H, int Sq,
                            int Sk, float scale_log2, int causal) {
    using T = Bf16Tile<D>;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
    const uint32_t q_s = base;
    const uint32_t k_s = base + T::kKOff;
    const uint32_t v_s = base + T::kVOff;
    constexpr int kStages = T::kStages;
    const uint32_t full = base + T::kBarOff;     // kStages barriers
    const uint32_t empty = full + 8 * kStages;   // kStages barriers
    const uint32_t qbar = empty + 8 * kStages;

    const int b = blockIdx.x / H;
    const int h = blockIdx.x - b * H;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * kCtaRows;
    // keys past the CTA's last row are masked for all of its rows
    const int kv_end = causal ? min(Sk, min(Sq, q0 + kCtaRows)) : Sk;
    const int n_tiles = (kv_end + kKeys - 1) / kKeys;

    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, 4 * kConsumers);   // one per warp
        }
        mbar_init(qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / kWgThreads;
    if (wg == kConsumers) {
        // the producer: one thread issues every copy
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(kProducerRegs));
        if (threadIdx.x == kConsumers * kWgThreads && n_tiles > 0) {
            mbar_expect_tx(qbar, kConsumers * T::kQBytes);
            for (int g = 0; g < kConsumers; ++g) {
                for (int x = 0; x < T::kBoxes; ++x) {
                    tma_load(q_s + g * T::kQBytes + x * T::kQBoxBytes, &qmap,
                             x * T::kBox, h, q0 + g * kWgRows, b, qbar);
                }
            }
            for (int t = 0; t < n_tiles; ++t) {
                const int s = t % kStages;
                if (t >= kStages) {
                    mbar_wait(empty + 8 * s, (t / kStages - 1) & 1);
                }
                mbar_expect_tx(full + 8 * s, 2 * T::kBytes);
                for (int x = 0; x < T::kBoxes; ++x) {
                    const uint32_t off = s * T::kBytes + x * T::kBoxBytes;
                    tma_load(k_s + off, &kmap, x * T::kBox, h, t * kKeys, b,
                             full + 8 * s);
                    tma_load(v_s + off, &vmap, x * T::kBox, h, t * kKeys, b,
                             full + 8 * s);
                }
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(kConsumerRegs));
        const int warp = (threadIdx.x / 32) % 4;
        const int lane = threadIdx.x % 32;
        const int row_lo = q0 + wg * kWgRows;    // this warpgroup's rows
        const int wg_kv_end =
            causal ? min(Sk, min(Sq, row_lo + kWgRows)) : Sk;
        const int wg_tiles =
            row_lo < Sq ? (wg_kv_end + kKeys - 1) / kKeys : 0;
        // the accumulator fragment: this thread holds rows r0 and r0 + 8,
        // columns c0, c0 + 1 of every group of 8
        const int r0 = row_lo + 16 * warp + lane / 4;
        const int c0 = 2 * (lane % 4);
        const uint32_t q_wg = q_s + wg * T::kQBytes;
        // this warp is done with a stage
        auto release = [&](int t) {
            __syncwarp();
            if (lane == 0) {
                mbar_arrive(empty + 8 * (t % kStages));
            }
        };

        float acc[T::kBoxes][T::kBox / 2];
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x) {
#pragma unroll
            for (int i = 0; i < T::kBox / 2; ++i) {
                acc[x][i] = 0.f;
            }
        }
        float m[2] = {kNegInf, kNegInf};   // running max, in base 2
        float l[2] = {0.f, 0.f};           // this thread's part of the sum
        float sc[kKeys / 2];               // a tile's scores, then p
        uint32_t ph[kKeys / 16][4];        // the last tile's p: hi
        uint32_t pl[kKeys / 16][4];        // and lo
        auto acc_done = [&]() {
#pragma unroll
            for (int x = 0; x < T::kBoxes; ++x) {
                fence_regs(acc[x]);
            }
        };
        // scores to p for tile t; only tiles at the diagonal or past Sk
        // pay for the masks
        auto softmax = [&](int t, float (&alpha)[2]) {
            const int k0 = t * kKeys;
            if (k0 + kKeys > Sk || (causal && k0 + kKeys - 1 > row_lo)) {
                softmax_tile<kKeys, true, false>(
                    sc, m, l, alpha, k0, r0, c0, Sk, causal, scale_log2);
            } else if (scale_log2 >= 0.f) {
                softmax_tile<kKeys, false, false>(
                    sc, m, l, alpha, k0, r0, c0, Sk, causal, scale_log2);
            } else {
                softmax_tile<kKeys, false, true>(
                    sc, m, l, alpha, k0, r0, c0, Sk, causal, scale_log2);
            }
        };
        // acc rescaled, and p as the next P V's A fragments (once the last
        // P V is in: it reads acc, ph and pl)
        auto rescale_split = [&](const float (&alpha)[2]) {
#pragma unroll
            for (int x = 0; x < T::kBoxes; ++x) {
#pragma unroll
                for (int j = 0; j < T::kBox / 8; ++j) {
#pragma unroll
                    for (int r = 0; r < 2; ++r) {
                        acc[x][4 * j + 2 * r] *= alpha[r];
                        acc[x][4 * j + 2 * r + 1] *= alpha[r];
                    }
                }
            }
            split_p(sc, ph, pl);
        };

        // Software pipeline, per tile t >= 1: S of tile t, then P V of
        // tile t - 1 are issued; once S is in, the softmax of tile t runs
        // on the CUDA cores and SFUs while P V runs on the tensor cores. A
        // stage is released once P V has read its V. Every wgmma is issued
        // and waited for on one straight path (no product in flight across
        // a branch), so ptxas keeps them asynchronous.
        float alpha[2];
        if (wg_tiles > 0) {
            mbar_wait(qbar, 0);
            mbar_wait(full, 0);
            issue_scores<D>(sc, q_wg, k_s);
            wgmma_wait<0>();
            fence_regs(sc);
            softmax(0, alpha);
            rescale_split(alpha);
        }
        for (int t = 1; t < wg_tiles; ++t) {
            const int s = t % kStages;
            mbar_wait(full + 8 * s, (t / kStages) & 1);
            issue_scores<D>(sc, q_wg, k_s + s * T::kBytes);
            issue_pv<D>(acc, ph, pl, v_s + ((t - 1) % kStages) * T::kBytes);
            wgmma_wait<1>();    // S of tile t
            fence_regs(sc);
            softmax(t, alpha);
            wgmma_wait<0>();    // P V of tile t - 1
            acc_done();
            release(t - 1);
            rescale_split(alpha);
        }
        if (wg_tiles > 0) {
            issue_pv<D>(acc, ph, pl,
                        v_s + ((wg_tiles - 1) % kStages) * T::kBytes);
            wgmma_wait<0>();
            acc_done();
            release(wg_tiles - 1);
        }
        // tiles the CTA's other rows need and these do not
        for (int t = wg_tiles; t < n_tiles; ++t) {
            mbar_wait(full + 8 * (t % kStages), (t / kStages) & 1);
            release(t);
        }

#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float sum = l[r];
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            const float den = fmaxf(sum, 1e-30f);
            const int row = r0 + 8 * r;
            if (row >= Sq) {
                continue;
            }
            __nv_bfloat16* orow =
                o + ((static_cast<long long>(b) * Sq + row) * H + h) * D;
#pragma unroll
            for (int x = 0; x < T::kBoxes; ++x) {
#pragma unroll
                for (int j = 0; j < T::kBox / 8; ++j) {
                    *reinterpret_cast<__nv_bfloat162*>(
                        orow + x * T::kBox + 8 * j + c0) =
                        __floats2bfloat162_rn(acc[x][4 * j + 2 * r] / den,
                                              acc[x][4 * j + 2 * r + 1] / den);
                }
            }
        }
    }
}

// -- f32: 3xTF32 on wgmma, TMA-fed -------------------------------------------

constexpr int kF32Keys = 64;                  // keys of a K/V tile
constexpr uint32_t kTf32Hi = 0xffffe000u;     // sign, exponent, 10 mantissa

// A CTA is one or two consumer warpgroups of 64 query rows (two share
// each K/V tile's copy and split; one at D 128, for shared memory); one
// thread of it issues the TMA copies. Shared memory, every tile in
// 128-byte rows swizzled 128 B (the 16-byte chunk c of row r at chunk
// c ^ (r % 8)), as TMA writes them and the wgmma descriptors read them;
// tiles 1024-byte aligned:
//  q      each warpgroup's q tile as TMA lands it (D / 32 boxes of 64 rows
//         x 32 f32), then its hi parts in place; q_lo beside them;
//  K, V   the ring (tiles of 64 keys, D / 32 boxes each); K's hi parts
//         are written in place, the lo parts into k_lo;
//  vt     v^T as hi and lo tiles, K-major for P V: D rows of keys, in
//         atoms of 32 keys (128 B) a row. A key group of 8 keeps the
//         order the accumulator fragment of S gives P's A fragment: key
//         2 i at position i, key 2 i + 1 at position 4 + i.
// 88 KB at D 32 (two CTAs an SM), 176 KB at D 64, 224 KB at D 128 with a
// ring of one stage.
template <int D>
struct F32Tile {
    static constexpr int kWgs = D == 128 ? 1 : 2;
    static constexpr int kRows = kWgs * kWgRows;        // query rows of a CTA
    static constexpr int kThreads = kWgs * kWgThreads;
    static constexpr int kBoxes = D / 32;
    static constexpr int kQBoxBytes = kWgRows * 128;
    static constexpr int kQWgBytes = kBoxes * kQBoxBytes;   // a warpgroup's q
    static constexpr int kQBytes = kWgs * kQWgBytes;
    static constexpr int kBoxBytes = kF32Keys * 128;
    static constexpr int kBytes = kBoxes * kBoxBytes;   // a K, V or vt tile
    static constexpr int kVtAtom = D * 128;             // 32 keys of vt
    static constexpr int kStages = D == 128 ? 1 : 2;    // K/V ring depth
    static constexpr int kQLoOff = kQBytes;
    static constexpr int kKOff = 2 * kQBytes;
    static constexpr int kVOff = kKOff + kStages * kBytes;
    static constexpr int kKLoOff = kVOff + kStages * kBytes;
    static constexpr int kVtHiOff = kKLoOff + kBytes;
    static constexpr int kVtLoOff = kVtHiOff + kBytes;
    static constexpr int kBarOff = kVtLoOff + kBytes;
    static constexpr size_t kSmem = 1024 + kBarOff + 8 * (kStages + 1);
};

// S (+)= A B^T, m64n64k8, TF32: A (64 x 8) and B (64 x 8) K-major in
// shared memory; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t a,
                                                uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
}

// d += A B, m64n32k8, TF32: A (64 x 8) in registers, B (8 x 32) K-major
// in shared memory
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15 "
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B, m64n64k8, TF32: A (64 x 8) in registers, B (8 x 64) K-major
// in shared memory
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B, m64n128k8, TF32: A (64 x 8) in registers, B (8 x 128) K-major
// in shared memory
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63 "
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
    if constexpr (N == 32) {
        wgmma_tf32_rs_n32(d, a, b);
    } else if constexpr (N == 64) {
        wgmma_tf32_rs_n64(d, a, b);
    } else {
        wgmma_tf32_rs_n128(d, a, b);
    }
}

// 128-byte swizzled, K-major: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t tf32_desc(uint32_t addr) {
    return smem_desc(addr, 1, 16, 1024);
}

__device__ __forceinline__ float tf32_hi(float x) {
    return __uint_as_float(__float_as_uint(x) & kTf32Hi);
}

// x as TF32 hi = x with its low 13 mantissa bits cleared and lo = x - hi
// (exact in f32; the tensor core drops lo's own low bits, ~2^-21 of x)
__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
    hi = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
    lo = make_float4(x.x - hi.x, x.y - hi.y, x.z - hi.z, x.w - hi.w);
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
    const float h = tf32_hi(x);
    hi = __float_as_uint(h);
    lo = __float_as_uint(x - h);
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` of f32 at `src` as hi in place and lo at `lo`, 16 bytes a
// thread of the CTA at a time (a chunk keeps its swizzled place).
template <int kThreads>
__device__ __forceinline__ void split_in_place(uint8_t* src, uint8_t* lo,
                                               int bytes, int tid) {
    for (int c = 16 * tid; c < bytes; c += 16 * kThreads) {
        float4 h, l;
        split4(*reinterpret_cast<const float4*>(src + c), h, l);
        *reinterpret_cast<float4*>(src + c) = h;
        *reinterpret_cast<float4*>(lo + c) = l;
    }
}

// A V tile (keys x D, as TMA lands it) into vt as hi and lo. Lane l of a
// unit takes column d = 32 x + l and the four keys of one parity h of key
// group j (keys 8 j + h + 2 i, i < 4), read along their rows (a warp
// reads a whole row at once), and writes them as one 16-byte chunk of
// vt's row d at positions 8 j + 4 h + i.
template <int D>
__device__ __forceinline__ void split_v(const uint8_t* vs, uint8_t* vth,
                                        uint8_t* vtl, int warp, int lane) {
    using T = F32Tile<D>;
    constexpr int kPerBox = kF32Keys / 4;     // (group, parity) units
#pragma unroll 2
    for (int u = warp; u < T::kBoxes * kPerBox; u += T::kThreads / 32) {
        const int x = u / kPerBox;
        const int j = (u % kPerBox) / 2;
        const int h = u % 2;
        float4 v;
        float* vv = &v.x;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = h + 2 * i;              // the key's row mod 8
            vv[i] = *reinterpret_cast<const float*>(
                vs + x * T::kBoxBytes + (8 * j + r) * 128
                + (((lane / 4) ^ r) << 4) + 4 * (lane % 4));
        }
        float4 hi, lo;
        split4(v, hi, lo);
        const int d = 32 * x + lane;
        const int off = (j / 4) * T::kVtAtom + d * 128
                      + (((2 * (j % 4) + h) ^ (lane % 8)) << 4);
        *reinterpret_cast<float4*>(vth + off) = hi;
        *reinterpret_cast<float4*>(vtl + off) = lo;
    }
}

// Issues S = Q K^T of one key tile into `sc` (not waited for), each
// product as lo hi + hi lo + hi hi.
template <int D>
__device__ __forceinline__ void f32_issue_scores(float (&sc)[kF32Keys / 2],
                                                 uint32_t q_hi, uint32_t q_lo,
                                                 uint32_t k_hi,
                                                 uint32_t k_lo) {
    using T = F32Tile<D>;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < T::kBoxes; ++x) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint32_t oq = x * T::kQBoxBytes + kk * 32;
            const uint32_t ok = x * T::kBoxBytes + kk * 32;
            wgmma_tf32_ss_n64(sc, tf32_desc(q_lo + oq), tf32_desc(k_hi + ok),
                              x + kk > 0);
            wgmma_tf32_ss_n64(sc, tf32_desc(q_hi + oq), tf32_desc(k_lo + ok),
                              1);
            wgmma_tf32_ss_n64(sc, tf32_desc(q_hi + oq), tf32_desc(k_hi + ok),
                              1);
        }
    }
    wgmma_commit();
}

// Issues acc += P V of one key tile (not waited for): p as hi and lo A
// fragments, one k-step of 8 keys each, vt as hi and lo.
template <int D>
__device__ __forceinline__ void f32_issue_pv(
    float (&acc)[D / 2], const uint32_t (&ph)[kF32Keys / 8][4],
    const uint32_t (&pl)[kF32Keys / 8][4], uint32_t vt_hi, uint32_t vt_lo) {
    using T = F32Tile<D>;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kF32Keys / 8; ++j) {
        const uint32_t o = (j / 4) * T::kVtAtom + (j % 4) * 32;
        wgmma_tf32_rs<D>(acc, pl[j], tf32_desc(vt_hi + o));
        wgmma_tf32_rs<D>(acc, ph[j], tf32_desc(vt_lo + o));
        wgmma_tf32_rs<D>(acc, ph[j], tf32_desc(vt_hi + o));
    }
    wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(F32Tile<D>::kThreads)
flash_attention_f32_kernel(__grid_constant__ const CUtensorMap qmap,
                           __grid_constant__ const CUtensorMap kmap,
                           __grid_constant__ const CUtensorMap vmap,
                           float* __restrict__ o, int H, int Sq, int Sk,
                           float scale_log2, int causal) {
    using T = F32Tile<D>;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_addr(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    uint8_t* sbase = smem_raw + (base - raw);   // generic, aligned
    constexpr int kStages = T::kStages;
    const uint32_t full = base + T::kBarOff;     // kStages barriers
    const uint32_t qbar = full + 8 * kStages;

    const int b = blockIdx.x / H;
    const int h = blockIdx.x - b * H;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * T::kRows;
    // keys past the CTA's last row are masked for all of its rows
    const int kv_end = causal ? min(Sk, min(Sq, q0 + T::kRows)) : Sk;
    const int n_tiles = (kv_end + kF32Keys - 1) / kF32Keys;
    const int tid = threadIdx.x;

    // thread 0 issues every copy: q and the first tiles now, each later
    // tile once the tile before it in its stage is done with
    auto load_tile = [&](int t) {
        const int s = t % kStages;
        mbar_expect_tx(full + 8 * s, 2 * T::kBytes);
        for (int x = 0; x < T::kBoxes; ++x) {
            const uint32_t off = s * T::kBytes + x * T::kBoxBytes;
            tma_load(base + T::kKOff + off, &kmap, 32 * x, h, t * kF32Keys,
                     b, full + 8 * s);
            tma_load(base + T::kVOff + off, &vmap, 32 * x, h, t * kF32Keys,
                     b, full + 8 * s);
        }
    };
    if (tid == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full + 8 * s, 1);
        }
        mbar_init(qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        if (n_tiles > 0) {
            mbar_expect_tx(qbar, T::kQBytes);
            for (int g = 0; g < T::kWgs; ++g) {
                for (int x = 0; x < T::kBoxes; ++x) {
                    tma_load(base + g * T::kQWgBytes + x * T::kQBoxBytes,
                             &qmap, 32 * x, h, q0 + g * kWgRows, b, qbar);
                }
            }
            for (int t = 0; t < min(kStages, n_tiles); ++t) {
                load_tile(t);
            }
        }
    }
    __syncthreads();

    // warpgroup wg owns rows wg_lo.. and warp w of it rows row_lo..; the
    // accumulator fragment gives this thread rows r0 and r0 + 8, columns
    // c0, c0 + 1 of every group of 8
    const int wg = tid / kWgThreads;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int wg_lo = q0 + wg * kWgRows;
    const int wg_kv_end = causal ? min(Sk, min(Sq, wg_lo + kWgRows)) : Sk;
    const int wg_tiles =
        wg_lo < Sq ? (wg_kv_end + kF32Keys - 1) / kF32Keys : 0;
    const int row_lo = wg_lo + 16 * (warp % 4);
    const int r0 = row_lo + lane / 4;
    const int c0 = 2 * (lane % 4);
    const uint32_t q_hi = base + wg * T::kQWgBytes;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
        acc[i] = 0.f;
    }
    float m[2] = {kNegInf, kNegInf};   // running max, in base 2
    float l[2] = {0.f, 0.f};           // this thread's part of the sum
    float sc[kF32Keys / 2];            // a tile's scores, then p
    uint32_t ph[kF32Keys / 8][4];      // p as hi and lo A fragments
    uint32_t pl[kF32Keys / 8][4];
    for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t == 0) {
            mbar_wait(qbar, 0);
            split_in_place<T::kThreads>(sbase, sbase + T::kQLoOff,
                                        T::kQBytes, tid);
        } else {
            // every warpgroup's products of the last tile are in: its
            // stage, k_lo and vt are free
            __syncthreads();
            if (tid == 0 && t - 1 + kStages < n_tiles) {
                load_tile(t - 1 + kStages);
            }
        }
        mbar_wait(full + 8 * s, (t / kStages) & 1);
        split_in_place<T::kThreads>(sbase + T::kKOff + s * T::kBytes,
                                    sbase + T::kKLoOff, T::kBytes, tid);
        split_v<D>(sbase + T::kVOff + s * T::kBytes, sbase + T::kVtHiOff,
                   sbase + T::kVtLoOff, warp, lane);
        fence_proxy_async();
        __syncthreads();
        if (t >= wg_tiles) {
            continue;   // keys past this warpgroup's rows (causal)
        }
        f32_issue_scores<D>(sc, q_hi, q_hi + T::kQLoOff,
                            base + T::kKOff + s * T::kBytes,
                            base + T::kKLoOff);
        wgmma_wait<0>();
        fence_regs(sc);
        // only tiles at the warp's diagonal or past Sk pay for the masks
        const int k0 = t * kF32Keys;
        float alpha[2];
        if (k0 + kF32Keys > Sk || (causal && k0 + kF32Keys - 1 > row_lo)) {
            softmax_tile<kF32Keys, true, false>(
                sc, m, l, alpha, k0, r0, c0, Sk, causal, scale_log2);
        } else if (scale_log2 >= 0.f) {
            softmax_tile<kF32Keys, false, false>(
                sc, m, l, alpha, k0, r0, c0, Sk, causal, scale_log2);
        } else {
            softmax_tile<kF32Keys, false, true>(
                sc, m, l, alpha, k0, r0, c0, Sk, causal, scale_log2);
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
            acc[i] *= alpha[(i / 2) % 2];
        }
        // the accumulator's registers as P's A fragments: a0 (g, 2 t),
        // a1 (g + 8, 2 t), a2 (g, 2 t + 1), a3 (g + 8, 2 t + 1), keys
        // taken in vt's order
#pragma unroll
        for (int j = 0; j < kF32Keys / 8; ++j) {
            split_tf32(sc[4 * j], ph[j][0], pl[j][0]);
            split_tf32(sc[4 * j + 2], ph[j][1], pl[j][1]);
            split_tf32(sc[4 * j + 1], ph[j][2], pl[j][2]);
            split_tf32(sc[4 * j + 3], ph[j][3], pl[j][3]);
        }
        f32_issue_pv<D>(acc, ph, pl, base + T::kVtHiOff, base + T::kVtLoOff);
        wgmma_wait<0>();
        fence_regs(acc);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float sum = l[r];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float den = fmaxf(sum, 1e-30f);
        const int row = r0 + 8 * r;
        if (row >= Sq) {
            continue;
        }
        float* orow = o + ((static_cast<long long>(b) * Sq + row) * H + h) * D;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
            *reinterpret_cast<float2*>(orow + 8 * n + c0) =
                make_float2(acc[4 * n + 2 * r] / den,
                            acc[4 * n + 2 * r + 1] / den);
        }
    }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime's entry-point query
// so the library needs no -lcuda.
EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;   // idempotent: races are harmless
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
            fn = reinterpret_cast<EncodeTiled>(p);
        }
    }
    return fn;
}

// A map over the (B, S, H, D) view at `ptr` with element strides (sb, ss,
// sh), elements of `esize` bytes (4: f32, 2: bf16), dims innermost first
// (D, H, S, B), box (box_cols, 1, box_rows, 1); rows past S read as zeros.
int encode_view(EncodeTiled fn, CUtensorMap* map, const void* ptr, int esize,
                int D, int H, int S, int B, long long sb, long long ss,
                long long sh, int box_cols, int box_rows,
                CUtensorMapSwizzle swizzle) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                                static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh * esize),
                                   static_cast<cuuint64_t>(ss * esize),
                                   static_cast<cuuint64_t>(sb * esize)};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1,
                               static_cast<cuuint32_t>(box_rows), 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUresult r = fn(map, esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          4, const_cast<void*>(ptr), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// The three maps of a launch: q in boxes of q_rows rows, k and v of
// kv_rows. With no keys the maps of k and v are never read and are left
// unencoded (a zero dim is refused).
int encode_qkv(CUtensorMap (&maps)[3], const void* q, const void* k,
               const void* v, int esize, int B, int H, int Sq, int Sk, int D,
               const long long* st, int box_cols, int q_rows, int kv_rows,
               CUtensorMapSwizzle swizzle) {
    const EncodeTiled fn = encoder();
    if (fn == nullptr) {
        return kErrNoEncoder;
    }
    int err = encode_view(fn, &maps[0], q, esize, D, H, Sq, B, st[0], st[1],
                          st[2], box_cols, q_rows, swizzle);
    if (err == 0 && Sk > 0) {
        err = encode_view(fn, &maps[1], k, esize, D, H, Sk, B, st[3], st[4],
                          st[5], box_cols, kv_rows, swizzle);
    }
    if (err == 0 && Sk > 0) {
        err = encode_view(fn, &maps[2], v, esize, D, H, Sk, B, st[6], st[7],
                          st[8], box_cols, kv_rows, swizzle);
    }
    return err;
}

// Raises a kernel's dynamic shared-memory limit once; `done` is the
// launch's own flag (idempotent: races are harmless).
template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem, bool& done) {
    if (!done) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) {
            return err;
        }
        done = true;
    }
    return cudaSuccess;
}

float log2_scale(float scale) {
    return static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int Sq, int Sk, const long long* st, float scale,
               int causal, cudaStream_t stream) {
    using T = F32Tile<D>;
    static bool configured = false;
    const cudaError_t cerr = configure(flash_attention_f32_kernel<D>,
                                       T::kSmem, configured);
    if (cerr != cudaSuccess) {
        return static_cast<int>(cerr);
    }
    CUtensorMap maps[3] = {};
    const int err = encode_qkv(maps, q, k, v, 4, B, H, Sq, Sk, D, st, 32,
                               kWgRows, kF32Keys, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != 0) {
        return err;
    }
    const dim3 grid(static_cast<unsigned>(B * H),
                    static_cast<unsigned>((Sq + T::kRows - 1) / T::kRows));
    flash_attention_f32_kernel<D><<<grid, T::kThreads, T::kSmem, stream>>>(
        maps[0], maps[1], maps[2], static_cast<float*>(o), H, Sq, Sk,
        log2_scale(scale), causal);
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int H, int Sq, int Sk, const long long* st, float scale,
                int causal, cudaStream_t stream) {
    using T = Bf16Tile<D>;
    static bool configured = false;
    const cudaError_t cerr = configure(flash_attention_bf16_kernel<D>,
                                       T::kSmem, configured);
    if (cerr != cudaSuccess) {
        return static_cast<int>(cerr);
    }
    const CUtensorMapSwizzle swizzle = T::kRowBytes == 128
        ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
    CUtensorMap maps[3] = {};
    const int err = encode_qkv(maps, q, k, v, 2, B, H, Sq, Sk, D, st,
                               T::kBox, kWgRows, kKeys, swizzle);
    if (err != 0) {
        return err;
    }
    const dim3 grid(static_cast<unsigned>(B * H),
                    static_cast<unsigned>((Sq + kCtaRows - 1) / kCtaRows));
    flash_attention_bf16_kernel<D><<<grid, kBf16Threads, T::kSmem, stream>>>(
        maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), H, Sq, Sk,
        log2_scale(scale), causal);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, void* o,
                 int B, int H, int Sq, int Sk, const long long* st,
                 float scale, int causal, cudaStream_t stream) {
    if constexpr (std::is_same<T, float>::value) {
        return launch_f32<D>(q, k, v, o, B, H, Sq, Sk, st, scale, causal,
                             stream);
    } else {
        return launch_bf16<D>(q, k, v, o, B, H, Sq, Sk, st, scale, causal,
                              stream);
    }
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             int B, int H, int Sq, int Sk, const long long* st, float scale,
             int causal, cudaStream_t stream) {
    switch (D) {
        case 32:
            return launch_typed<T, 32>(q, k, v, o, B, H, Sq, Sk, st, scale,
                                       causal, stream);
        case 64:
            return launch_typed<T, 64>(q, k, v, o, B, H, Sq, Sk, st, scale,
                                       causal, stream);
        case 128:
            return launch_typed<T, 128>(q, k, v, o, B, H, Sq, Sk, st, scale,
                                        causal, stream);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Plain C entry point for ctypes. q (B, Sq, H, D), k and v (B, Sk, H, D) in
// device memory, element strides (batch, position, head) in `strides` order
// q, k, v (the last dim contiguous, every stride a multiple of 16 bytes and
// every pointer 16-byte aligned, as TMA reads them); o (B, Sq, H, D)
// contiguous. `dtype` 0 is f32, 1 bf16; D is 32, 64 or 128. `stream` is a
// cudaStream_t. Returns the cudaError_t of the launch, or a negative code
// of `pio_cuda_error_string`'s.
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
    if (code == kErrNoEncoder) {
        return "cuTensorMapEncodeTiled was not found";
    }
    if (code == kErrEncode) {
        return "cuTensorMapEncodeTiled refused a tensor map of q, k or v";
    }
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
