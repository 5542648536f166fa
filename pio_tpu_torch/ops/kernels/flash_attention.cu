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
// f32: `flash_attention_kernel`. One CTA of 256 threads takes one
// (batch, head) and a tile of 64 query rows; the scaled q tile stays in
// shared memory while the K/V tiles of 64 keys stream through it, so Sk is
// bounded by nothing on chip (the reference's K/V segments are a VMEM
// budget and have no counterpart here). Each tile: S = Q K^T as a 4x4
// micro-tile per thread (thread (ty, tx) holds rows 4ty..4ty+3 and keys
// tx, tx+16, tx+32, tx+48), the masks, the online-softmax update of
// (m, l, acc), all in f32, with row maxima and sums reduced across the 16
// threads of a row by shuffles; P goes to shared memory and acc += P V,
// each thread owning D/16 output columns of its four rows. Shared-memory
// rows are padded by 4 floats, so the 16-byte reads of a warp fall in
// distinct banks. Every product is an f32 FMA on the CUDA cores, P kept in
// f32 for P V, as the reference computes it (no TF32). Bound: the (q, k)
// pairs the masks keep, 4 D flops each, at the f32 rate; at the serving
// shapes (63 rows) a launch's latency.
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

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

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

// The masks and the online-softmax update of one key tile starting at k0,
// on the accumulator fragment: this thread's rows r0 and r0 + 8 hold 32
// scores each, columns k0 + 8 j + c0 + {0, 1}. Turns `sc` into p (f32),
// updates the running max m (base 2) and this thread's part of l, and
// gives the factor by which each row's output is rescaled.
// kMask: the tile holds keys past Sk or above some row's diagonal; only
// such tiles pay for the masks, and scale their scores first. Other tiles
// take the max of the raw scores (of their negation when kNeg, the scale
// being negative) and fold the scale into one FMA a score.
template <bool kMask, bool kNeg>
__device__ __forceinline__ void softmax_tile(float (&sc)[kKeys / 2],
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
        for (int j = 0; j < kKeys / 8; ++j) {
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
        for (int j = 0; j < kKeys / 8; ++j) {
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
                softmax_tile<true, false>(sc, m, l, alpha, k0, r0, c0, Sk,
                                          causal, scale_log2);
            } else if (scale_log2 >= 0.f) {
                softmax_tile<false, false>(sc, m, l, alpha, k0, r0, c0, Sk,
                                           causal, scale_log2);
            } else {
                softmax_tile<false, true>(sc, m, l, alpha, k0, r0, c0, Sk,
                                          causal, scale_log2);
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
// sh), dims innermost first (D, H, S, B), box (box_cols, 1, box_rows, 1);
// rows past S read as zeros.
int encode_view(EncodeTiled fn, CUtensorMap* map, const void* ptr, int D,
                int H, int S, int B, long long sb, long long ss,
                long long sh, int box_cols, int box_rows,
                CUtensorMapSwizzle swizzle) {
    constexpr long long kEsize = 2;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                                static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh * kEsize),
                                   static_cast<cuuint64_t>(ss * kEsize),
                                   static_cast<cuuint64_t>(sb * kEsize)};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1,
                               static_cast<cuuint32_t>(box_rows), 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int H, int Sq, int Sk, const long long* st, float scale,
                int causal, cudaStream_t stream) {
    using T = Bf16Tile<D>;
    static bool configured = false;   // idempotent: races are harmless
    if (!configured) {
        const cudaError_t err = cudaFuncSetAttribute(
            flash_attention_bf16_kernel<D>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(T::kSmem));
        if (err != cudaSuccess) {
            return static_cast<int>(err);
        }
        configured = true;
    }
    const EncodeTiled fn = encoder();
    if (fn == nullptr) {
        return kErrNoEncoder;
    }
    const CUtensorMapSwizzle swizzle = T::kRowBytes == 128
        ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
    // no keys: the maps of k and v are never read (a zero dim is refused)
    CUtensorMap maps[3] = {};
    int err = encode_view(fn, &maps[0], q, D, H, Sq, B, st[0], st[1], st[2],
                          T::kBox, kWgRows, swizzle);
    if (err == 0 && Sk > 0) {
        err = encode_view(fn, &maps[1], k, D, H, Sk, B, st[3], st[4], st[5],
                          T::kBox, kKeys, swizzle);
    }
    if (err == 0 && Sk > 0) {
        err = encode_view(fn, &maps[2], v, D, H, Sk, B, st[6], st[7], st[8],
                          T::kBox, kKeys, swizzle);
    }
    if (err != 0) {
        return err;
    }
    const dim3 grid(static_cast<unsigned>(B * H),
                    static_cast<unsigned>((Sq + kCtaRows - 1) / kCtaRows));
    const float scale_log2 =
        static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
    flash_attention_bf16_kernel<D><<<grid, kBf16Threads, T::kSmem, stream>>>(
        maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), H, Sq, Sk,
        scale_log2, causal);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, void* o,
                 int B, int H, int Sq, int Sk, const long long* st,
                 float scale, int causal, cudaStream_t stream) {
    if constexpr (std::is_same<T, float>::value) {
        return launch<D, float>(q, k, v, o, B, H, Sq, Sk, st, scale, causal,
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
// q, k, v (the last dim contiguous; for f32 every stride a multiple of 4
// and every pointer aligned to 4 elements, for bf16 every stride a
// multiple of 8 elements and every pointer 16-byte aligned, as TMA reads
// them); o (B, Sq, H, D) contiguous. `dtype` 0 is f32, 1 bf16; D is 32, 64
// or 128. `stream` is a cudaStream_t. Returns the cudaError_t of the
// launch, or for bf16 a negative code of `pio_cuda_error_string`'s.
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
