// Flash attention forward and backward in bf16 on Hopper's tensor cores
// (sm_90a): blockwise causal / sliding-window grouped-query attention
// with an online softmax, and the recompute backward from the saved
// per-row logsumexp.  The fp32 kernels stay in flash_attention.cu; the
// wrapper (ops.py) sends bf16 tensors here and fp32 tensors there.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py
//   * flash_attention_fwd (Pallas body _fwd_kernel :30, pallas_call :99)
//                                                       -> fwd_kernel
//   * flash_attention_bwd (bodies _bwd_dq_kernel :135 and
//     _bwd_dkv_kernel :179, pallas_call :244 and :264)  -> dq_kernel,
//                                                          dkv_kernel
// and, in the dK/dV kernel, the GQA group sum of kernels/flash_attention/
// ops.py:63-65 (the Pallas kernel writes dK/dV per query head).
//
// It computes what flash_attention.cu:13-34 states: for batch b, query
// head h (KV head h / n_rep), query i and key j, s_ij = (q_i . k_j) *
// scale, masked to the finite -1e30 where (causal && j > i) or (window >
// 0 && j <= i - window); o_i = softmax_j(s_ij) v_j, lse_i = m_i +
// log(max(l_i, 1e-30)); p_ij = allowed ? exp(s_ij - lse_i) : 0, delta_i =
// o_i . do_i (one PyTorch reduction), ds_ij = p_ij (do_i . v_j - delta_i)
// * scale, dq_i = sum_j ds_ij k_j, dk_j and dv_j summed over the GQA
// group.  q, k, v, dO and the outputs are bf16, lse and delta fp32.  The
// products take bf16 operands and accumulate in fp32; P (forward, dQ,
// dK/dV) and dS (dQ, dK/dV) are rounded to bf16 in registers before they
// feed the next product, as FlashAttention-2/3 do, and that is the only
// rounding besides the outputs'.  Row maxima, sums and the rescaling stay
// fp32, in the base-2 domain (scores times scale * log2(e)), with the
// reference's order: scale, then mask, then max.  The mask value -1e30 is
// used as is in that domain, so a masked score of a row that has seen an
// allowed key gives exp2(-1e30 - m) = 0 and a row with no allowed key
// gives exp2(0) = 1 for every key: the mean of V and lse = -1e30, as the
// dense softmax gives (the forward then visits every key tile).  Key
// positions past the sequence, or at or past kv_len (the count of valid
// keys the wrapper passes for a padded non-causal call), are -inf: never
// counted, even there; their dK/dV rows are zeros.
//
// Head dim 80 (stablelm-3b) runs head dim 128's tiles: TMA fills columns
// 80-127 with zeros (the tensor map's inner extent is 80), the products
// over head_dim (Q K^T, dO V^T) stop after five 16-column steps, the
// products along it (P V, dS K, P^T dO, dS^T Q) run at N = 128 on zero
// columns, and stores stop at column 80.  The 160-byte rows do not fit
// the 128-byte swizzle's chunks, so this padding is the simple route.
//
// Bound on this card: operations.  Per (batch, query head) the forward
// does 2 products over the allowed (i, j) pairs (4 * head_dim flops a
// pair) and the backward 5 (10 * head_dim); at qwen3-1.7b's width in
// train_4k (B=2, S=4,096, 16 query heads over 8 KV heads of 128, causal)
// that is 137 GFLOP forward, 0.139 ms at the 989 TFLOP/s of bf16 dense
// tensor cores, and 344 GFLOP backward, 0.348 ms; the inputs are ~34 MB,
// ~0.01 ms at 3.35 TB/s.
//
// Design.  Every product is a wgmma.mma_async (m64nNk16, bf16 in, fp32
// accumulators in registers); a warpgroup (128 threads) owns 64 query rows
// in the forward and dQ, 64 key rows in dK/dV, and a block holds two.
//   forward: S = Q K^T (A = Q, B = K, both K-major in shared memory), then
//            O += P V (A = P from registers, B = V read MN-major);
//   dQ:      S = Q K^T, dP = dO V^T, then dQ += dS K (A = dS in registers,
//            B = K MN-major);
//   dK/dV:   S^T = K Q^T and dP^T = V dO^T, computed transposed so that no
//            operand needs a transpose in registers, then dV += P^T dO and
//            dK += dS^T Q (A in registers, B = the dO / Q tiles MN-major).
// The accumulator layout of one product is the register layout of the
// next one's A operand, so P and dS never leave registers.  Tiles reach
// shared memory through TMA (cp.async.bulk.tensor, 4-d tensor maps over
// (head_dim, sequence, head, batch) built per call from the wrapper's
// strides, so the model layout and strided views need no copy) into a
// ring of two stages with mbarriers, in the layout the wgmma descriptors
// read (128-byte swizzle, 64-byte at head_dim 32): tile i+1's copy runs
// under tile i's products.  The ragged last tile is zero-filled by TMA and
// masked; stores are masked per row.  Tiles that causality and the window
// leave out are skipped whole, and tiles that need no mask skip the
// per-element test.  Tiles: forward 128 query rows x 128 keys (64 keys at
// head_dim 256, where one warpgroup's 64 x 256 fp32 O is 128 registers a
// thread); dQ 128 x 64 (128 x 32 at 256); dK/dV 128 keys x 64 queries,
// and at head_dim 256, where dK and dV together would need 256 registers
// a thread, 128 keys x 32 queries with dV and then dK accumulated in two
// passes over the query tiles (one more product per tile: S^T again).
// No atomics: dQ is its own kernel and every sum runs in a fixed order,
// so two runs are bitwise equal.  Not done yet: warp specialisation (a
// producer warp and consumer warpgroups), persistent blocks, setmaxnreg.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the reference's masked score
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// the order of the pointers and strides the host passes
enum Slot { kQ, kK, kV, kDO, kLse, kDelta, kOut0, kOut1 };

struct Params {
  float* lse;                 // written by the forward, read by the backward
  const float* delta;         // rowsum(o * dO) (backward)
  __nv_bfloat16* out0;        // o (forward), dQ, or dK
  __nv_bfloat16* out1;        // dV
  int batch, heads, kv_heads, n_rep, sq, sk, causal, window;
  int sk_rows;                // K/V rows; keys at or past sk (kv_len) masked
  int64_t st[8][3];           // element strides, as flash_attention.cu
  float scale;                // 1 / sqrt(head_dim)
  float scale_log2;           // scale * log2(e)
};

__device__ __forceinline__ bool tile_runs(const Params& p, int q0, int q1,
                                          int k0, int k1) {
  // the Pallas kernels' block skip (kernel.py:45-49), at this kernel's tiles
  return (!p.causal || k0 <= q1) && (p.window <= 0 || k1 > q0 - p.window);
}

__device__ __forceinline__ bool allowed(const Params& p, int i, int j) {
  return (!p.causal || j <= i) && (p.window <= 0 || j > i - p.window);
}

// every (i, j) with i in [qa, qb], j in [ka, kb] allowed, and kb < sk
__device__ __forceinline__ bool tile_full(const Params& p, int qa, int qb,
                                          int ka, int kb) {
  return kb < p.sk && (!p.causal || kb <= qa) &&
         (p.window <= 0 || ka > qb - p.window);
}

// ---------------------------------------------------------------------------
// shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of this parity has completed; a copy
// that never lands traps (a launch error) instead of spinning forever
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, tries = 0;
  do {
    if (++tries == (1u << 26)) asm volatile("trap;\n");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of accumulators across
// the asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// a shared-memory matrix descriptor: start address, leading and stride
// byte offsets, layout (1 = 128-byte swizzle, 2 = 64-byte swizzle)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// A tile of `rows` rows of head_dim HD in shared memory, as TMA writes it:
// HD / CW chunks of rows x CW columns, each row of a chunk CW * 2 bytes
// (the swizzle's span), chunk c at c * rows * CW * 2.
template <int HD>
struct Tile {
  static constexpr int CW = HD < 64 ? HD : 64;
  static constexpr int ROWB = CW * 2;
  static constexpr int NCH = HD / CW;
  static constexpr uint64_t LAYOUT = CW == 64 ? 1 : 2;
  // K-major operand (K = head_dim): rows r0.. of the tile, k-step kk
  __device__ static __forceinline__ uint64_t kmajor(uint32_t base, int rows,
                                                    int r0, int kk) {
    const int col = kk * 16;
    return make_desc(base + (col / CW) * rows * ROWB + r0 * ROWB +
                         (col % CW) * 2,
                     16, 8 * ROWB, LAYOUT);
  }
  // MN-major B operand: K = tile rows k0..k0+15, N = all HD columns
  __device__ static __forceinline__ uint64_t mnmajor(uint32_t base, int rows,
                                                     int k0) {
    return make_desc(base + k0 * ROWB, rows * ROWB, 8 * ROWB, LAYOUT);
  }
  // one thread: copy rows row0.. of (batch b, head h) into the tile
  __device__ static __forceinline__ void load(const CUtensorMap* map,
                                              uint32_t base, int rows,
                                              uint32_t bar, int row0, int h,
                                              int b) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      tma_load(base + c * rows * ROWB, map, bar, c * CW, row0, h, b);
  }
};

template <int N>
struct MMA;

// The operands of a 64 x N product's fp32 accumulator d[N / 2], as the asm
// text names them ("%0, %1, ...") and as the operand list passes them.
#define WG_ACC16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_ACC32                                                         \
  WG_ACC16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
           "%28, %29, %30, %31"
#define WG_ACC64                                                         \
  WG_ACC32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
           "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "   \
           "%56, %57, %58, %59, %60, %61, %62, %63"
#define WG_ACC128                                                          \
  WG_ACC64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, "  \
           "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, "    \
           "%88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "    \
           "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "    \
           "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "    \
           "%120, %121, %122, %123, %124, %125, %126, %127"
#define WG_D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D16(i) WG_D8(i), WG_D8(i + 8)
#define WG_D32(i) WG_D16(i), WG_D16(i + 16)
#define WG_D64(i) WG_D32(i), WG_D32(i + 32)
#define WG_D128(i) WG_D64(i), WG_D64(i + 64)

// MMA<N>: R = N / 2 accumulators a thread; o0..o5 are the numbers of the
// operands after them (R .. R + 5).
#define WG_MMA(N, R, ACC, D, o0, o1, o2, o3, o4, o5)                        \
  template <>                                                               \
  struct MMA<N> {                                                           \
    /* d (64 x N, fp32) += a (64 x 16) . b (16 x N); a and b K-major in    \
       shared memory */                                                     \
    static __device__ __forceinline__ void ss(float (&d)[R], uint64_t a,   \
                                              uint64_t b, int scale_d) {   \
      asm volatile(                                                         \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #o2 ", 0;\n"                 \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" ACC  \
          "}, %" #o0 ", %" #o1 ", p, 1, 1, 0, 0;\n}\n"                      \
          : D(0)                                                            \
          : "l"(a), "l"(b), "r"(scale_d));                                  \
    }                                                                       \
    /* d += a . b with a in registers (the fragment of a 64 x 16 tile) and \
       b MN-major in shared memory (transposed) */                          \
    static __device__ __forceinline__ void rs(float (&d)[R],               \
                                              const uint32_t (&a)[4],      \
                                              uint64_t b, int scale_d) {   \
      asm volatile(                                                         \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #o5 ", 0;\n"                 \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" ACC  \
          "}, {%" #o0 ", %" #o1 ", %" #o2 ", %" #o3 "}, %" #o4              \
          ", p, 1, 1, 1;\n}\n"                                              \
          : D(0)                                                            \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),             \
            "r"(scale_d));                                                  \
    }                                                                       \
  };

WG_MMA(32, 16, WG_ACC16, WG_D16, 16, 17, 18, 19, 20, 21)
WG_MMA(64, 32, WG_ACC32, WG_D32, 32, 33, 34, 35, 36, 37)
WG_MMA(128, 64, WG_ACC64, WG_D64, 64, 65, 66, 67, 68, 69)
WG_MMA(256, 128, WG_ACC128, WG_D128, 128, 129, 130, 131, 132, 133)


// ---------------------------------------------------------------------------
// accumulator fragments
// ---------------------------------------------------------------------------
// Element e of a warpgroup's 64 x N fp32 accumulator lies in row
// 16 * warp + lane / 4 + 8 * ((e >> 1) & 1) and column 8 * (e >> 2) +
// 2 * (lane & 3) + (e & 1): a thread holds two rows, r = 0 and 1.

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the 64 x 16 A fragments of a 64 x N accumulator, rounded to bf16
template <int N>
__device__ __forceinline__ void to_a(const float (&d)[N / 2],
                                     uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// the thread's rows row0 and row0 + 8 (those below n) of a 64 x HD
// accumulator, times mul0 / mul1, to bf16 rows row_stride apart; columns
// at or past D (the head dim, when HD pads it) are not stored
template <int HD, int D>
__device__ __forceinline__ void store_rows(const float (&d)[HD / 2],
                                           __nv_bfloat16* base,
                                           int64_t row_stride, int row0, int n,
                                           float mul0, float mul1) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    const float mul = r ? mul1 : mul0;
    __nv_bfloat16* dst = base + row * row_stride + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          d[4 * j + 2 * r] * mul, d[4 * j + 2 * r + 1] * mul);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the contiguous range [lo, lo + n) of tiles of `blk` positions along a
// sequence of `len` that a tile of the other side needs
struct Range {
  int lo, n;
};

constexpr int kThreads = 256;   // two warpgroups

// ---------------------------------------------------------------------------
// forward: one block per (128 query rows, query head, batch)
// ---------------------------------------------------------------------------

template <int HD, int BK, int D>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const Params p, const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv) {
  using T = Tile<HD>;
  constexpr int BQ = 128, QB = BQ * HD * 2, KB = BK * HD * 2;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[3];   // K/V stages 0 and 1; Q
  const uint32_t sQ = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sKV = sQ + QB;   // stage s: K at sKV + 2 s KB, V after it
  const uint32_t bar = smem_u32(bars);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;   // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z, g = h / p.n_rep;
  const int q0 = qt * BQ, q1 = min(q0 + BQ, p.sq) - 1;
  // a query row with no allowed key averages V over every key
  const bool every = p.window > 0 && q1 - p.window >= p.sk - 1;
  Range kr{0, 0};
  for (int kt = 0, nk = (p.sk + BK - 1) / BK; kt < nk; ++kt) {
    const int k0 = kt * BK;
    if (every || tile_runs(p, q0, q1, k0, min(k0 + BK, p.sk) - 1)) {
      if (kr.n == 0) kr.lo = kt;
      kr.n = kt - kr.lo + 1;
    }
  }
  auto issue = [&](int i) {
    const uint32_t st = i & 1, s = sKV + st * 2 * KB;
    mbar_expect_tx(bar + 8 * st, 2 * KB);
    T::load(&tk, s, BK, bar + 8 * st, (kr.lo + i) * BK, g, b);
    T::load(&tv, s + KB, BK, bar + 8 * st, (kr.lo + i) * BK, g, b);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar + 16, QB);
    T::load(&tq, sQ, BQ, bar + 16, q0, h, b);
    for (int i = 0; i < 2 && i < kr.n; ++i) issue(i);
  }

  float o[HD / 2];
  zero(o);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int qa = q0 + wg * 64, row = qa + warp * 16 + (lane >> 2);
  mbar_wait(bar + 16, 0);
  for (int i = 0; i < kr.n; ++i) {
    const int st = i & 1, k0 = (kr.lo + i) * BK;
    const uint32_t sK = sKV + st * 2 * KB;
    mbar_wait(bar + 8 * st, (i >> 1) & 1);
    float s[BK / 2];
    zero(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < (D + 15) / 16; ++kk)
      MMA<BK>::ss(s, T::kmajor(sQ, BQ, wg * 64, kk), T::kmajor(sK, BK, 0, kk),
                  1);
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    // scale (base 2), then mask, then max
    const bool full = tile_full(p, qa, qa + 63, k0, k0 + BK - 1);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int r = (e >> 1) & 1;
      float x = s[e] * p.scale_log2;
      if (!full) {
        const int kj = k0 + (e >> 2) * 8 + 2 * (lane & 3) + (e & 1);
        if (kj >= p.sk)
          x = neg_inf();
        else if (!allowed(p, row + 8 * r, kj))
          x = kNegInf;
      }
      s[e] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float corr[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int r = (e >> 1) & 1;
      s[e] = exp2f(s[e] - m[r]);
      ps[r] += s[e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) o[e] *= corr[(e >> 1) & 1];
    uint32_t a[BK / 16][4];
    to_a<BK>(s, a);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      MMA<HD>::rs(o, a[kk], T::mnmajor(sK + KB, BK, kk * 16), 1);
    wg_commit();
    wg_wait_all();
    fence_regs(o);
    __syncthreads();   // both warpgroups are done with this stage
    if (tid == 0 && i + 2 < kr.n) issue(i + 2);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = fmaxf(quad_sum(l[r]), 1e-30f);
    inv[r] = 1.f / l[r];
  }
  store_rows<HD, D>(o, p.out0 + b * p.st[kOut0][0] + h * p.st[kOut0][2],
                 p.st[kOut0][1], row, p.sq, inv[0], inv[1]);
  if ((lane & 3) == 0) {
    float* lb = p.lse + b * p.st[kLse][0] + h * p.st[kLse][1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row + 8 * r;
      // m is in base 2; a row that never saw an allowed key keeps -1e30
      if (qi < p.sq)
        lb[qi * p.st[kLse][2]] =
            (m[r] == kNegInf ? kNegInf : m[r] * kLn2) + logf(l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (128 query rows, query head, batch), key tiles inner
// ---------------------------------------------------------------------------

template <int HD, int BK, int D>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const Params p, const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo) {
  using T = Tile<HD>;
  constexpr int BQ = 128, QB = BQ * HD * 2, KB = BK * HD * 2;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[3];   // K/V stages 0 and 1; Q, dO
  const uint32_t sQ = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sDO = sQ + QB, sKV = sDO + QB;
  const uint32_t bar = smem_u32(bars);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, g = h / p.n_rep;
  const int q0 = qt * BQ, q1 = min(q0 + BQ, p.sq) - 1;
  Range kr{0, 0};
  for (int kt = 0, nk = (p.sk + BK - 1) / BK; kt < nk; ++kt) {
    const int k0 = kt * BK;
    if (tile_runs(p, q0, q1, k0, min(k0 + BK, p.sk) - 1)) {
      if (kr.n == 0) kr.lo = kt;
      kr.n = kt - kr.lo + 1;
    }
  }
  auto issue = [&](int i) {
    const uint32_t st = i & 1, s = sKV + st * 2 * KB;
    mbar_expect_tx(bar + 8 * st, 2 * KB);
    T::load(&tk, s, BK, bar + 8 * st, (kr.lo + i) * BK, g, b);
    T::load(&tv, s + KB, BK, bar + 8 * st, (kr.lo + i) * BK, g, b);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar + 16, 2 * QB);
    T::load(&tq, sQ, BQ, bar + 16, q0, h, b);
    T::load(&tdo, sDO, BQ, bar + 16, q0, h, b);
    for (int i = 0; i < 2 && i < kr.n; ++i) issue(i);
  }

  const int qa = q0 + wg * 64, row = qa + warp * 16 + (lane >> 2);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row + 8 * r;
    const bool in = qi < p.sq;
    lse2[r] = in ? p.lse[b * p.st[kLse][0] + h * p.st[kLse][1] +
                         qi * p.st[kLse][2]] * kLog2e
                 : 0.f;
    dl[r] = in ? p.delta[b * p.st[kDelta][0] + h * p.st[kDelta][1] +
                         qi * p.st[kDelta][2]]
               : 0.f;
  }
  float dq[HD / 2];
  zero(dq);
  mbar_wait(bar + 16, 0);
  for (int i = 0; i < kr.n; ++i) {
    const int st = i & 1, k0 = (kr.lo + i) * BK;
    const uint32_t sK = sKV + st * 2 * KB;
    mbar_wait(bar + 8 * st, (i >> 1) & 1);
    float s[BK / 2], dp[BK / 2];
    zero(s);
    zero(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < (D + 15) / 16; ++kk)
      MMA<BK>::ss(s, T::kmajor(sQ, BQ, wg * 64, kk), T::kmajor(sK, BK, 0, kk),
                  1);
#pragma unroll
    for (int kk = 0; kk < (D + 15) / 16; ++kk)
      MMA<BK>::ss(dp, T::kmajor(sDO, BQ, wg * 64, kk),
                  T::kmajor(sK + KB, BK, 0, kk), 1);
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);
    const bool full = tile_full(p, qa, qa + 63, k0, k0 + BK - 1);
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int r = (e >> 1) & 1;
      float pv = exp2f(s[e] * p.scale_log2 - lse2[r]);
      if (!full) {
        const int kj = k0 + (e >> 2) * 8 + 2 * (lane & 3) + (e & 1);
        if (kj >= p.sk || !allowed(p, row + 8 * r, kj)) pv = 0.f;
      }
      dp[e] = pv * (dp[e] - dl[r]) * p.scale;   // dS
    }
    uint32_t a[BK / 16][4];
    to_a<BK>(dp, a);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      MMA<HD>::rs(dq, a[kk], T::mnmajor(sK, BK, kk * 16), 1);
    wg_commit();
    wg_wait_all();
    fence_regs(dq);
    __syncthreads();
    if (tid == 0 && i + 2 < kr.n) issue(i + 2);
  }
  store_rows<HD, D>(dq, p.out0 + b * p.st[kOut0][0] + h * p.st[kOut0][2],
                 p.st[kOut0][1], row, p.sq, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (128 key rows, KV head, batch); the group's query
// heads and their query tiles inner.  SPLIT (head_dim 256): dV over every
// tile, then dK over every tile again, in one accumulator.
// ---------------------------------------------------------------------------

template <int HD, int BQ, bool SPLIT, int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const Params p, const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo) {
  using T = Tile<HD>;
  constexpr int BKV = 128, KVB = BKV * HD * 2, QB = BQ * HD * 2;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[3];   // Q/dO stages 0 and 1; K, V
  __shared__ float s_lse[2][BQ], s_delta[2][BQ];
  const uint32_t sK = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sV = sK + KVB, sQD = sV + KVB;   // stage s: Q, then dO
  const uint32_t bar = smem_u32(bars);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BKV, k1 = min(k0 + BKV, p.sk) - 1;
  const int ka = k0 + wg * 64, krow = ka + warp * 16 + (lane >> 2);
  const int n_rows = p.sk_rows;        // dK/dV rows stored
  __nv_bfloat16* kout = p.out0 + b * p.st[kOut0][0] + g * p.st[kOut0][2];
  __nv_bfloat16* vout = p.out1 + b * p.st[kOut1][0] + g * p.st[kOut1][2];
  float acc0[HD / 2];                  // dV (SPLIT: dV, then dK)
  float acc1[SPLIT ? 2 : HD / 2];      // dK
  zero(acc0);
  zero(acc1);
  if (k0 >= p.sk) {   // every key of the tile at or past kv_len: zeros
    store_rows<HD, D>(acc0, vout, p.st[kOut1][1], krow, n_rows, 1.f, 1.f);
    store_rows<HD, D>(acc0, kout, p.st[kOut0][1], krow, n_rows, 1.f, 1.f);
    return;
  }
  Range qr{0, 0};
  for (int qt = 0, nq = (p.sq + BQ - 1) / BQ; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    if (tile_runs(p, q0, min(q0 + BQ, p.sq) - 1, k0, k1)) {
      if (qr.n == 0) qr.lo = qt;
      qr.n = qt - qr.lo + 1;
    }
  }
  const int per_pass = p.n_rep * qr.n;
  const int total = SPLIT ? 2 * per_pass : per_pass;
  // tile t: query head g * n_rep + u / qr.n, query rows from q0
  auto head_of = [&](int t) { return g * p.n_rep + (t % per_pass) / qr.n; };
  auto q0_of = [&](int t) { return (qr.lo + (t % per_pass) % qr.n) * BQ; };
  auto issue = [&](int t) {
    const uint32_t st = t & 1, s = sQD + st * 2 * QB;
    mbar_expect_tx(bar + 8 * st, 2 * QB);
    T::load(&tq, s, BQ, bar + 8 * st, q0_of(t), head_of(t), b);
    T::load(&tdo, s + QB, BQ, bar + 8 * st, q0_of(t), head_of(t), b);
  };
  auto stats = [&](int t, int buf) {
    const int h = head_of(t), q0 = q0_of(t);
    const float* lb = p.lse + b * p.st[kLse][0] + h * p.st[kLse][1];
    const float* db = p.delta + b * p.st[kDelta][0] + h * p.st[kDelta][1];
    for (int i = tid; i < BQ; i += kThreads) {
      const int qi = q0 + i;
      s_lse[buf][i] = qi < p.sq ? lb[qi * p.st[kLse][2]] * kLog2e : 0.f;
      s_delta[buf][i] = qi < p.sq ? db[qi * p.st[kDelta][2]] : 0.f;
    }
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar + 16, 2 * KVB);
    T::load(&tk, sK, BKV, bar + 16, k0, g, b);
    T::load(&tv, sV, BKV, bar + 16, k0, g, b);
    for (int t = 0; t < 2 && t < total; ++t) issue(t);
  }
  if (total > 0) stats(0, 0);
  __syncthreads();

  mbar_wait(bar + 16, 0);
  for (int t = 0; t < total; ++t) {
    const int st = t & 1, q0 = q0_of(t);
    const uint32_t sQ = sQD + st * 2 * QB, sDO = sQ + QB;
    const bool dv_pass = !SPLIT || t < per_pass;
    const bool dk_pass = !SPLIT || t >= per_pass;
    if (t + 1 < total) stats(t + 1, st ^ 1);
    if constexpr (SPLIT) {
      if (t == per_pass) {
        store_rows<HD, D>(acc0, vout, p.st[kOut1][1], krow, n_rows, 1.f, 1.f);
        zero(acc0);
      }
    }
    mbar_wait(bar + 8 * st, (t >> 1) & 1);
    float s[BQ / 2], dp[BQ / 2];
    zero(s);
    zero(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < (D + 15) / 16; ++kk)
      MMA<BQ>::ss(s, T::kmajor(sK, BKV, wg * 64, kk),
                  T::kmajor(sQ, BQ, 0, kk), 1);
    if (dk_pass) {
#pragma unroll
      for (int kk = 0; kk < (D + 15) / 16; ++kk)
        MMA<BQ>::ss(dp, T::kmajor(sV, BKV, wg * 64, kk),
                    T::kmajor(sDO, BQ, 0, kk), 1);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);
    // rows: this thread's keys krow, krow + 8; columns: queries
    const bool full = q0 + BQ <= p.sq && tile_full(p, q0, q0 + BQ - 1, ka,
                                                   ka + 63);
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) {
      const int r = (e >> 1) & 1;
      const int c = (e >> 2) * 8 + 2 * (lane & 3) + (e & 1);
      float pv = exp2f(s[e] * p.scale_log2 - s_lse[st][c]);
      if (!full) {
        const int qi = q0 + c, kj = krow + 8 * r;
        if (qi >= p.sq || kj >= p.sk || !allowed(p, qi, kj)) pv = 0.f;
      }
      s[e] = pv;
      if (dk_pass) dp[e] = pv * (dp[e] - s_delta[st][c]) * p.scale;   // dS^T
    }
    uint32_t ap[BQ / 16][4], ad[BQ / 16][4];
    if (dv_pass) to_a<BQ>(s, ap);
    if (dk_pass) to_a<BQ>(dp, ad);
    wg_fence();
    if (dv_pass) {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        MMA<HD>::rs(acc0, ap[kk], T::mnmajor(sDO, BQ, kk * 16), 1);
    }
    if (dk_pass) {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        if constexpr (SPLIT)
          MMA<HD>::rs(acc0, ad[kk], T::mnmajor(sQ, BQ, kk * 16), 1);
        else
          MMA<HD>::rs(acc1, ad[kk], T::mnmajor(sQ, BQ, kk * 16), 1);
      }
    }
    wg_commit();
    wg_wait_all();
    fence_regs(acc0);
    fence_regs(acc1);
    __syncthreads();   // this stage and s_lse / s_delta[st] are free
    if (tid == 0 && t + 2 < total) issue(t + 2);
  }
  if constexpr (SPLIT) {
    if (per_pass == 0)
      store_rows<HD, D>(acc0, vout, p.st[kOut1][1], krow, n_rows, 1.f, 1.f);
    store_rows<HD, D>(acc0, kout, p.st[kOut0][1], krow, n_rows, 1.f, 1.f);
  } else {
    store_rows<HD, D>(acc0, vout, p.st[kOut1][1], krow, n_rows, 1.f, 1.f);
    store_rows<HD, D>(acc1, kout, p.st[kOut0][1], krow, n_rows, 1.f, 1.f);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

constexpr int kNoDriver = -999;

// the driver's cuTensorMapEncodeTiled, from the libcuda the process has
// loaded (this library links only the CUDA runtime)
EncodeTiled encode_fn() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A 4-d map over (head_dim d, sequence s, head, batch) of a bf16 tensor
// with element strides st = (batch, sequence, head), copying boxes of
// `rows` rows by cw columns (Tile<HD>::CW); columns at or past d and rows
// at or past s land as zeros.  Returns 0 or minus the CUresult.
int tensor_map(CUtensorMap* map, const void* ptr, int cw, int d, int s,
               int h, int b, const int64_t* st, int rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return kNoDriver;
  const cuuint64_t dim[4] = {static_cast<cuuint64_t>(d),
                             static_cast<cuuint64_t>(s),
                             static_cast<cuuint64_t>(h),
                             static_cast<cuuint64_t>(b)};
  const int64_t el[3] = {st[1], st[2], st[0]};   // sequence, head, batch
  cuuint64_t stride[3];
  for (int i = 0; i < 3; ++i) {
    // a dimension of extent 1 is never stepped: any valid stride will do
    const int64_t e = dim[i + 1] == 1 ? 8 : el[i];
    if (e <= 0) return -static_cast<int>(CUDA_ERROR_INVALID_VALUE);
    stride[i] = static_cast<cuuint64_t>(e) * 2;
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cw),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dim,
      stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

template <typename Kern, typename... Maps>
int run(Kern kern, dim3 grid, int smem, cudaStream_t stream, const Params& p,
        const Maps&... maps) {
  if (grid.x == 0) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, kThreads, smem, stream>>>(p, maps...);
  return static_cast<int>(cudaGetLastError());
}

// HD: the kernels' head dim; D: the tensors' (D < HD: the columns from D
// on are zeros in shared memory, the products over head_dim stop at the
// 16-column step that holds D, and nothing past D is stored)
template <int HD, int D = HD>
int launch(int which, const Params& p, const void* const* ptrs,
           cudaStream_t stream) {
  constexpr int BQ = 128;                          // forward and dQ rows
  constexpr int BK = HD == 256 ? 64 : 128;         // forward key tile
  constexpr int BKQ = HD == 256 ? 32 : 64;         // dQ key tile
  constexpr int BQV = HD == 256 ? 32 : 64;         // dK/dV query tile
  constexpr int BKV = 128;                         // dK/dV key rows
  constexpr int ROW = HD * 2, ALIGN = 1024;        // bytes
  CUtensorMap mq, mk, mv, mdo;
  const int rows_q = which == 2 ? BQV : BQ;
  const int rows_k = which == 0 ? BK : which == 1 ? BKQ : BKV;
  constexpr int CW = Tile<HD>::CW;
  int err = tensor_map(&mq, ptrs[kQ], CW, D, p.sq, p.heads, p.batch,
                       p.st[kQ], rows_q);
  if (!err)   // keys at or past kv_len are read as zeros
    err = tensor_map(&mk, ptrs[kK], CW, D, p.sk, p.kv_heads, p.batch,
                     p.st[kK], rows_k);
  if (!err)
    err = tensor_map(&mv, ptrs[kV], CW, D, p.sk, p.kv_heads, p.batch,
                     p.st[kV], rows_k);
  if (!err && which != 0)
    err = tensor_map(&mdo, ptrs[kDO], CW, D, p.sq, p.heads, p.batch,
                     p.st[kDO], rows_q);
  if (err) return err;
  if (which == 0) {
    const dim3 grid((p.sq + BQ - 1) / BQ, p.heads, p.batch);
    return run(fwd_kernel<HD, BK, D>, grid, ALIGN + (BQ + 4 * BK) * ROW, stream,
               p, mq, mk, mv);
  }
  if (which == 1) {
    const dim3 grid((p.sq + BQ - 1) / BQ, p.heads, p.batch);
    return run(dq_kernel<HD, BKQ, D>, grid, ALIGN + (2 * BQ + 4 * BKQ) * ROW,
               stream, p, mq, mk, mv, mdo);
  }
  if (which == 2) {
    const dim3 grid((p.sk_rows + BKV - 1) / BKV, p.kv_heads, p.batch);
    return run(dkv_kernel<HD, BQV, (HD > 128), D>, grid,
               ALIGN + (2 * BKV + 4 * BQV) * ROW, stream, p, mq, mk, mv, mdo);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The entry point of flash_attention.cu's shape, for bf16 only (dtype 1):
// which 0 = forward (out0 = o, and lse), 1 = dQ (out0 = dq), 2 = dK/dV
// (out0 = dk, out1 = dv, one per KV head); ptrs q, k, v, dO, lse, delta,
// out0, out1; dims batch, heads, kv_heads, sq, sk, head_dim, causal,
// window, kv_len (1 <= kv_len <= sk: keys at or past it are masked and
// their dK/dV rows are zero); head_dim in {32, 64, 80, 128, 256} (80 on
// head dim 128's tiles, padded with zeros); strides 8 x 3 element strides
// in the order of ptrs, (batch, sequence, head) for the tensors and
// (batch, head, sequence) for lse and delta.  Head_dim is contiguous and
// every row start 16-byte aligned (the wrapper checks both).  Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for what it
// does not take, or a negative value when a tensor map cannot be built
// (minus the driver's CUresult; -999: no cuTensorMapEncodeTiled).
extern "C" int flash_attention(int which, const void* const* ptrs,
                               const int64_t* dims, const int64_t* strides,
                               int dtype, float scale, void* stream) {
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.lse = static_cast<float*>(const_cast<void*>(ptrs[kLse]));
  p.delta = static_cast<const float*>(ptrs[kDelta]);
  p.out0 = static_cast<__nv_bfloat16*>(const_cast<void*>(ptrs[kOut0]));
  p.out1 = static_cast<__nv_bfloat16*>(const_cast<void*>(ptrs[kOut1]));
  p.batch = static_cast<int>(dims[0]);
  p.heads = static_cast<int>(dims[1]);
  p.kv_heads = static_cast<int>(dims[2]);
  p.sq = static_cast<int>(dims[3]);
  p.sk = static_cast<int>(dims[4]);
  const int head_dim = static_cast<int>(dims[5]);
  p.causal = static_cast<int>(dims[6]);
  p.window = static_cast<int>(dims[7]);
  p.sk_rows = p.sk;
  if (p.batch == 0 || p.heads == 0 || p.sq == 0 || p.sk == 0) return 0;
  if (p.kv_heads <= 0 || p.heads % p.kv_heads || dims[8] < 1 ||
      dims[8] > p.sk)
    return static_cast<int>(cudaErrorInvalidValue);
  p.sk = static_cast<int>(dims[8]);
  p.n_rep = p.heads / p.kv_heads;
  for (int t = 0; t < 8; ++t)
    for (int d = 0; d < 3; ++d) p.st[t][d] = strides[3 * t + d];
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch<32>(which, p, ptrs, s);
    case 64: return launch<64>(which, p, ptrs, s);
    case 80: return launch<128, 80>(which, p, ptrs, s);   // stablelm-3b
    case 128: return launch<128>(which, p, ptrs, s);
    case 256: return launch<256>(which, p, ptrs, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
