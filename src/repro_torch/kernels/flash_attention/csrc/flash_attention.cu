// Flash attention forward and backward in fp32 for Hopper (sm_90a): blockwise
// causal / sliding-window grouped-query attention with an online softmax,
// and the recompute backward from the saved per-row logsumexp.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py
//   * flash_attention_fwd (Pallas body _fwd_kernel)         -> fwd_kernel
//   * flash_attention_bwd (bodies _bwd_dq_kernel and
//     _bwd_dkv_kernel)                                      -> dq_kernel,
//                                                              dkv_kernel
// and, in the dK/dV kernel, the GQA group sum of kernels/flash_attention/
// ops.py:63-65 (the Pallas kernel writes dK/dV per query head).
//
// For batch b, query head h (KV head g = h / n_rep, as _repeat_kv lays out
// grouped-query attention), query position i and key position j:
//     s_ij = (q_i . k_j) * scale,  scale = 1/sqrt(head_dim),
//     allowed(i, j) = (!causal || j <= i) && (window <= 0 || j > i - window)
//     forward:  o_i = sum_j softmax_j(s_ij masked to -1e30) v_j,
//               lse_i = m_i + log(max(l_i, 1e-30))
//     backward: p_ij = allowed ? exp(s_ij - lse_i) : 0,
//               delta_i = o_i . do_i (one PyTorch reduction, as
//               kernel.py:241 computes it outside the Pallas kernels),
//               ds_ij = p_ij (do_i . v_j - delta_i) * scale,
//               dq_i = sum_j ds_ij k_j,
//               dk_j = sum_{h in group} sum_i ds_ij q_i,
//               dv_j = sum_{h in group} sum_i p_ij do_i.
// Everything is computed in fp32 (the Pallas bodies cast their blocks to
// f32, kernel.py:53-55); inputs, outputs and lse are fp32.  bf16 goes to
// flash_attention_sm90.cu (tensor cores), never here.
// Masked scores are the finite -1e30 of the reference, never -inf: a row
// accumulates exp(0) = 1 per masked entry until its first allowed score,
// whose correction exp(-1e30 - m) = 0 then wipes them (kernel.py:65-69);
// with -inf that step would be exp(-inf + inf) = NaN.  A row with no
// allowed key at all (causal=False or a window, with Sq > Sk + window - 1)
// gets the mean of V, as the dense reference softmax gives: the forward
// then visits every key tile of that query tile.
//
// Bound on this card: operations.  Per (batch, query head) the forward
// does 2 products over the allowed (i, j) pairs (4 * head_dim flops per
// pair) and the backward 5 (10 * head_dim); q, k, v are read once.  At
// qwen3-1.7b's width in train_4k (B=2, S=4,096, 16 query heads over 8 KV
// heads of 128, causal) that is 137 GFLOP forward, 2.05 ms at the 67
// TFLOP/s of fp32 outside the tensor cores, and 344 GFLOP backward, 5.13
// ms; the inputs are ~67 MB, ~0.02 ms at 3.35 TB/s.
//
// Design (SIMT fp32: TF32 is off, so no tensor cores).  Forward: a block
// of 256 threads owns (batch, query head, 64 query rows); key tiles are
// staged in shared memory as fp32 rows padded by 4 floats, so 16-byte reads
// of eight consecutive rows hit distinct banks.  Threads form a 16 x 16
// grid: thread (rg, cg) computes the scores of rows rg*R..rg*R+R-1 against
// columns cg, cg+16, ... with float4 reads along head_dim, and owns the
// output elements of its rows in columns (m*16 + cg)*4..+3; the 16
// threads of a row are one half-warp, so row maxima and sums are warp
// shuffles.  Tiles: 64 x 64 up to head_dim 128, key tiles of 32 at 256.
// Backward: two kernels on one pipeline (see "backward" below): dQ per
// query tile, and dK/dV per key tile with the n_rep query heads of its
// group summed in fp32 registers, so dK/dV are written once per KV head in
// (B, Sk, Hkv, hd), with no per-query-head intermediates, no reduction
// pass and no atomics (dQ recomputes S and dP: 7 products where the bound
// counts 5).  Tiles that causality and the window leave out are skipped
// whole.  Every sum runs in a fixed order, so two runs are bitwise equal.
// Every tensor is read and written through its (batch, sequence, head)
// element strides with head_dim contiguous, so the model layout
// (B, S, H, hd) needs no transpose.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;   // the reference's masked score

// the order of the pointers and strides the host passes
enum Slot { kQ, kK, kV, kDO, kLse, kDelta, kOut0, kOut1 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;     // dO (backward)
  float* lse;           // written by the forward, read by the backward
  const float* delta;   // rowsum(o * dO) (backward)
  void* out0;           // o (forward), dQ, or dK
  void* out1;           // dV
  int batch, heads, kv_heads, n_rep, sq, sk, causal, window;
  // element strides by Slot: (batch, sequence, head) for q, k, v, dO,
  // out0, out1; (batch, head, sequence) for lse and delta
  int64_t st[8][3];
  float scale;
};

// 16 bytes of a row: 4 floats
__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ bool tile_runs(const Params& p, int q0, int q1,
                                          int k0, int k1) {
  // the Pallas kernels' block skip (kernel.py:45-49), at this kernel's
  // tiles: q0..q1 and k0..k1 are the tiles' first and last positions
  return (!p.causal || k0 <= q1) && (p.window <= 0 || k1 > q0 - p.window);
}

__device__ __forceinline__ bool allowed(const Params& p, int i, int j) {
  return (!p.causal || j <= i) && (p.window <= 0 || j > i - p.window);
}

// Stage ROWS rows of head_dim HD (rows row0.. of a tensor whose rows are
// row_stride elements apart, from base) in shared memory as fp32 rows of
// HD + 4; rows at or past n are zeros.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* sm, const T* base,
                                          int64_t row_stride, int row0,
                                          int n) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int VPR = HD / VE;
  for (int i = threadIdx.x; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR;
    const int c = (i % VPR) * VE;
    float x[VE];
    if (row0 + r < n) {
      load16(base + static_cast<int64_t>(row0 + r) * row_stride + c, x);
    } else {
#pragma unroll
      for (int u = 0; u < VE; ++u) x[u] = 0.f;
    }
    float* dst = sm + r * (HD + 4) + c;
#pragma unroll
    for (int u = 0; u < VE; u += 4)
      *reinterpret_cast<float4*>(dst + u) =
          make_float4(x[u], x[u + 1], x[u + 2], x[u + 3]);
  }
}

// s[i][j] = a[ra + i] . b[cb + 16 j] over HD, rows of shared tiles with
// leading dimension HD + 4.
template <int HD, int R, int C>
__device__ __forceinline__ void dots(const float* sa, const float* sb, int ra,
                                     int cb, float (&s)[R][C]) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[R], b[C];
#pragma unroll
    for (int i = 0; i < R; ++i)
      a[i] = *reinterpret_cast<const float4*>(sa + (ra + i) * LD + d);
#pragma unroll
    for (int j = 0; j < C; ++j)
      b[j] = *reinterpret_cast<const float4*>(sb + (cb + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) {
        float x = s[i][j];
        x = fmaf(a[i].x, b[j].x, x);
        x = fmaf(a[i].y, b[j].y, x);
        x = fmaf(a[i].z, b[j].z, x);
        x = fmaf(a[i].w, b[j].w, x);
        s[i][j] = x;
      }
  }
}

// Columns a thread owns of a head_dim-wide output row: EPT = HD / 16 of
// them, in VEC-wide groups at (m * 16 + cg) * VEC.
template <int HD>
struct Cols {
  static constexpr int EPT = HD / 16;
  static constexpr int VEC = EPT >= 4 ? 4 : EPT;
  static constexpr int NV = EPT / VEC;
  __device__ static __forceinline__ int col(int cg, int e) {
    return ((e / VEC) * 16 + cg) * VEC + e % VEC;
  }
};

// acc[i][e] += sum_{c < NC} w[ra + i][c] * b[c][col(e)], w a shared tile
// of leading dimension LDW, b one of leading dimension HD + 4.
template <int HD, int R, int NC, int LDW>
__device__ __forceinline__ void accum(const float* sw, const float* sb, int ra,
                                      int cg,
                                      float (&acc)[R][Cols<HD>::EPT]) {
  using C = Cols<HD>;
  constexpr int LD = HD + 4;
#pragma unroll 2
  for (int c = 0; c < NC; c += 4) {
    float4 w[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      w[i] = *reinterpret_cast<const float4*>(sw + (ra + i) * LDW + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float bv[C::EPT];
      const float* row = sb + (c + cc) * LD;
#pragma unroll
      for (int m = 0; m < C::NV; ++m) {
        const float* src = row + (m * 16 + cg) * C::VEC;
        if constexpr (C::VEC == 4) {
          const float4 t = *reinterpret_cast<const float4*>(src);
          bv[4 * m] = t.x;
          bv[4 * m + 1] = t.y;
          bv[4 * m + 2] = t.z;
          bv[4 * m + 3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(src);
          bv[2 * m] = t.x;
          bv[2 * m + 1] = t.y;
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float wi = cc == 0 ? w[i].x : cc == 1 ? w[i].y
                       : cc == 2 ? w[i].z : w[i].w;
#pragma unroll
        for (int e = 0; e < C::EPT; ++e) acc[i][e] = fmaf(wi, bv[e], acc[i][e]);
      }
    }
  }
}

// reductions over the 16 threads of a row (one half-warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// forward: one block per (query tile, query head, batch)
// ---------------------------------------------------------------------------

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Params p) {
  constexpr int LD = HD + 4, LDP = BK + 4, R = BQ / 16, C = BK / 16;
  constexpr int EPT = Cols<HD>::EPT;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int h = blockIdx.y, b = blockIdx.z, g = h / p.n_rep;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int q0 = blockIdx.x * BQ, q1 = min(q0 + BQ, p.sq) - 1;
  const T* qb = static_cast<const T*>(p.q) + b * p.st[kQ][0] + h * p.st[kQ][2];
  const T* kb = static_cast<const T*>(p.k) + b * p.st[kK][0] + g * p.st[kK][2];
  const T* vb = static_cast<const T*>(p.v) + b * p.st[kV][0] + g * p.st[kV][2];
  load_tile<T, HD, BQ>(sQ, qb, p.st[kQ][1], q0, p.sq);

  float m[R], l[R], acc[R][EPT];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[i][e] = 0.f;
  }
  // a query row with no allowed key averages V over every key
  const bool every = p.window > 0 && q1 - p.window >= p.sk - 1;
  const int nk = (p.sk + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK, k1 = min(k0 + BK, p.sk) - 1;
    if (!every && !tile_runs(p, q0, q1, k0, k1)) continue;
    __syncthreads();                  // the last tile's readers are done
    load_tile<T, HD, BK>(sK, kb, p.st[kK][1], k0, p.sk);
    load_tile<T, HD, BK>(sV, vb, p.st[kV][1], k0, p.sk);
    __syncthreads();
    float s[R][C];
    dots<HD, R, C>(sQ, sK, rg * R, cg, s);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + rg * R + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int kj = k0 + cg + 16 * j;
        const float x = s[i][j] * p.scale;
        s[i][j] = kj < p.sk && allowed(p, qi, kj) ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float corr = expf(m[i] - mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int kj = k0 + cg + 16 * j;
        const float pij = kj < p.sk ? expf(s[i][j] - mx) : 0.f;
        psum += pij;
        sP[(rg * R + i) * LDP + cg + 16 * j] = pij;
      }
      l[i] = l[i] * corr + row_sum(psum);
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[i][e] *= corr;
      m[i] = mx;
    }
    __syncthreads();
    accum<HD, R, BK, LDP>(sP, sV, rg * R, cg, acc);
  }

  T* ob = static_cast<T*>(p.out0) + b * p.st[kOut0][0] + h * p.st[kOut0][2];
  float* lb = p.lse + b * p.st[kLse][0] + h * p.st[kLse][1];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + rg * R + i;
    if (qi >= p.sq) continue;
    const float ll = fmaxf(l[i], 1e-30f);
    T* orow = ob + qi * p.st[kOut0][1];
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      store(orow + Cols<HD>::col(cg, e), acc[i][e] / ll);
    if (cg == 0) lb[qi * p.st[kLse][2]] = m[i] + logf(ll);
  }
}

// ---------------------------------------------------------------------------
// backward: dQ and dK/dV on one pipeline
// ---------------------------------------------------------------------------
//
// A block of 256 threads owns BM = 64 rows (queries for dQ, keys for
// dK/dV) and streams the other side's rows in tiles of BN = 64 ("items":
// key tiles for dQ; (query head of the group, query tile) for dK/dV).  The
// block's own tiles (Q and dO, or K and V) stay in shared memory; the
// streamed ones (K and V, or Q and dO) arrive in depth chunks of DC = 32
// columns through a cp.async ring, two chunks in flight while one is
// multiplied.  At head dim 128 an item's chunks stay in the ring until its
// products have read them; at 256 (and below 128) the products stream
// them again (a second pass through L2: at 256 the full streamed tiles
// would not fit beside the own ones).  Per item:
//   scores   group 0 (threads 0-127): S = A0 B0^T, group 1: dP = A1 B1^T
//            (A the own tiles, B the streamed chunk; depth hd, chunk by
//            chunk), each thread 8 rows x 4 columns of the 64 x 64 tile;
//            both are written to shared memory, transposed [streamed][own];
//   softmax  all 256 threads, 16 elements each: P = exp(S scale - lse) (0
//            where masked; only tiles on the diagonal or the window's edge
//            test allowed()), dS = P (dP - delta) scale, in place;
//   products dQ += dS K (group g: key-chunk pair g when resident, else
//            chunk 2p + g of each streamed pair); dV += P^T dO (group 0)
//            and dK += dS^T Q (group 1); each thread 8 rows x 4 columns
//            of a chunk pair (resident) or 4 x 4 of a chunk, summed in
//            registers over every item (dK/dV over the GQA group too).
// Per 16-byte shared-memory read: 10.7 FMAs in the scores, 10.7 or 8 in
// the products.  An SM's shared memory hands out 32 floats a cycle
// against 128 FMAs, so these tile shapes cap the phases at 67% (and 50%)
// of the FMA rate; larger tiles need more streamed rows than fp32 fits.
// Registers at head dim 256: 128 accumulators for dK/dV (one of dK and
// dV per thread: the two products are split between the warp groups,
// the head dim is not), 64 for dQ.  Blocks are issued heaviest first:
// dQ's last query tiles, dK/dV's first key tiles (the tile is the
// slowest grid index).  No atomics, fixed orders: bitwise repeatable.

constexpr int kBM = 64, kBN = 64;
constexpr int kLdX = kBM + 4;                 // P / dS rows: [streamed][own]

// A thread's 8 own rows: ra..ra+3 and ra+8..ra+11, ra = (rg / 2) * 16 +
// (rg % 2) * 4, so that the two row groups of a warp read disjoint banks.
__device__ __forceinline__ int own_row(int ra, int i) {
  return ra + (i & 3) + (i >> 2) * 8;
}

template <int HD>
struct Bwd {
  static constexpr int LD = HD + 4;           // own tiles
  static constexpr int DC = HD >= 64 ? 32 : 16;
  static constexpr int NC = HD / DC;          // depth chunks
  static constexpr int LDC = DC + 4;
  static constexpr int CPT = DC / 8;          // product columns a thread
  static constexpr int STAGE = 2 * kBN * LDC; // floats: two chunk tiles
  // At head dim 128 an item's chunks stay in the ring until its products
  // have read them (NC slots + 2 in flight); at 256 they would not fit
  // beside the own tiles, so the products stream them again (and below
  // 128 the shared memory is not worth the second tile shape).
  static constexpr bool RESIDENT = HD == 128;
  static constexpr int AHEAD = 2;             // stages in flight
  static constexpr int SLOTS = RESIDENT ? NC + AHEAD : AHEAD + 1;
  // products: with resident chunks a thread takes 8 rows x 4 columns of
  // a chunk pair (2.67 FMAs a loaded float); streamed, 4 rows x CPT
  // columns of one chunk (2)
  static constexpr int PR = RESIDENT ? 8 : 4;
  static constexpr int PC = RESIDENT ? 4 : CPT;
  // unrolling of the score and product loops, by measurement (the
  // registers left beside 128 accumulators at 256 favour short loops)
  static constexpr int SCORE_UNROLL = HD <= 128 ? 4 : 1;
  static constexpr int PRODUCT_UNROLL = HD <= 128 ? 8 : 2;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows row0..row0+ROWS-1 (zeros at or past n), columns col0..col0+COLS-1
// of a tensor with rows row_stride elements apart, into shared memory
// with leading dimension LDS
template <int ROWS, int COLS, int LDS>
__device__ __forceinline__ void stage_rows(float* sm, const float* base,
                                           int64_t row_stride, int row0,
                                           int n, int col0) {
  constexpr int VPR = COLS / 4;
  for (int e = threadIdx.x; e < ROWS * VPR; e += kThreads) {
    const int r = e / VPR, v = (e % VPR) * 4;
    const bool ok = row0 + r < n;
    cp_async16(sm + r * LDS + v,
               base + (ok ? static_cast<int64_t>(row0 + r) * row_stride : 0)
                   + col0 + v, ok);
  }
}

template <int N>
__device__ __forceinline__ void stage_stats(float* sm, const float* base,
                                            int64_t stride, int row0,
                                            int n) {
  for (int e = threadIdx.x; e < N; e += kThreads) {
    const bool ok = row0 + e < n;
    cp_async4(sm + e, base + (ok ? static_cast<int64_t>(row0 + e) * stride
                                 : 0), ok);
  }
}

// s[i][j] += a[own_row(ra, i)] . b[cb + 16 j] over one chunk of DC columns
// (a: own tile of leading dimension LD at column c0; b: chunk tile)
template <int DC, int LD, int LDC, int UNROLL>
__device__ __forceinline__ void score_chunk(const float* sa, const float* sb,
                                            int ra, int cb, int c0,
                                            float (&s)[8][4]) {
#pragma unroll UNROLL
  for (int d = 0; d < DC; d += 4) {
    float4 b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(sb + (cb + 16 * j) * LDC + d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(
          sa + own_row(ra, i) * LD + c0 + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(a.x, b[j].x, x);
        x = fmaf(a.y, b[j].y, x);
        x = fmaf(a.z, b[j].z, x);
        x = fmaf(a.w, b[j].w, x);
        s[i][j] = x;
      }
    }
  }
}

// acc[i][e] += sum_n x[n][r0 + i] * b[n][e] over the BN streamed rows (x:
// P or dS, [streamed][own]; b: this thread's columns of a chunk tile)
template <int ROWS, int COLS, int LDC, int UNROLL>
__device__ __forceinline__ void product_chunk(const float* sx, const float* sb,
                                              int r0,
                                              float (&acc)[ROWS][COLS]) {
#pragma unroll UNROLL
  for (int n = 0; n < kBN; ++n) {
    float xs[ROWS], bv[COLS];
#pragma unroll
    for (int i = 0; i < ROWS; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(sx + n * kLdX + r0 + i);
      xs[i] = x.x;
      xs[i + 1] = x.y;
      xs[i + 2] = x.z;
      xs[i + 3] = x.w;
    }
    if constexpr (COLS == 4) {
      const float4 t = *reinterpret_cast<const float4*>(sb + n * LDC);
      bv[0] = t.x;
      bv[1] = t.y;
      bv[2] = t.z;
      bv[3] = t.w;
    } else {
      const float2 t = *reinterpret_cast<const float2*>(sb + n * LDC);
      bv[0] = t.x;
      bv[1] = t.y;
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int e = 0; e < COLS; ++e) acc[i][e] = fmaf(xs[i], bv[e], acc[i][e]);
  }
}

// This thread's 8 x 4 scores (S in group 0, dP in group 1) into sx
// transposed, [streamed][own]: rows own_row(ra, i), columns cb + 16 j.
__device__ __forceinline__ void put_scores(const float (&s)[8][4], float* sx,
                                           int ra, int cb) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float* dst = sx + (cb + 16 * j) * kLdX + ra;
    *reinterpret_cast<float4*>(dst) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    *reinterpret_cast<float4*>(dst + 8) =
        make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
  }
}

// P = exp(S scale - lse) (0 where masked) over sP and dS = P (dP - delta)
// scale over sDS, in place, all 256 threads: streamed row tid / 4, own
// columns (tid % 4) * 16..+15.  Own o and streamed t are (query, key) for
// dQ and (key, query) for dK/dV; lse and delta are indexed by the query.
// full: no element of the tile is masked or out of range, so only tiles on
// the diagonal or the window's edge test allowed().
template <bool DQ>
__device__ __forceinline__ void softmax_grad(const Params& p, float* sP,
                                             float* sDS, int own0, int str0,
                                             bool full, const float* lse,
                                             const float* dlt) {
  const int n = threadIdx.x >> 2, o0 = (threadIdx.x & 3) * 16;
  const int t = str0 + n;
#pragma unroll
  for (int y = 0; y < 16; y += 4) {
    float4* ps = reinterpret_cast<float4*>(sP + n * kLdX + o0 + y);
    float4* pd = reinterpret_cast<float4*>(sDS + n * kLdX + o0 + y);
    const float4 sv = *ps, dv = *pd;
    const float ss[4] = {sv.x, sv.y, sv.z, sv.w};
    const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
    float pv[4], ds[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int oo = o0 + y + x, o = own0 + oo;
      const bool ok = full || (DQ ? o < p.sq && t < p.sk && allowed(p, o, t)
                                  : t < p.sq && o < p.sk && allowed(p, t, o));
      pv[x] = ok ? expf(ss[x] * p.scale - (DQ ? lse[oo] : lse[n])) : 0.f;
      ds[x] = pv[x] * (dd[x] - (DQ ? dlt[oo] : dlt[n])) * p.scale;
    }
    *ps = make_float4(pv[0], pv[1], pv[2], pv[3]);
    *pd = make_float4(ds[0], ds[1], ds[2], ds[3]);
  }
}

// dQ: one block per (query tile, query head, batch); blockIdx.x = rank *
// heads * batch + head-and-batch, query tiles issued last first
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(Params p) {
  using B = Bwd<HD>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);         // own: Q, dO
  float* sDO = sQ + kBM * B::LD;
  float* ring = sDO + kBM * B::LD;
  float* sP = ring + B::SLOTS * B::STAGE;              // S, then P
  float* sDS = sP + kBN * kLdX;                        // dP, then dS
  float* sLse = sDS + kBN * kLdX;
  float* sDelta = sLse + kBM;

  const int hb = blockIdx.x % (p.heads * p.batch);
  const int h = hb % p.heads, b = hb / p.heads, g = h / p.n_rep;
  const int nq = (p.sq + kBM - 1) / kBM, nk = (p.sk + kBN - 1) / kBN;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x / (p.heads * p.batch));
  const int q0 = qt * kBM, q1 = min(q0 + kBM, p.sq) - 1;
  const int tid = threadIdx.x, grp = tid >> 7;
  const int rg = (tid & 127) >> 4, cg = tid & 15;
  const int ra = (rg >> 1) * 16 + (rg & 1) * 4;        // scores: own rows
  // products: rows pr.., columns pc: 8 x 4 of a chunk pair (resident)
  // or 4 x CPT of a chunk
  const int pr = B::RESIDENT ? ((tid & 127) >> 4) * 8 : ((tid & 127) >> 3) * 4;
  const int pc = B::RESIDENT ? (tid & 15) * 4 : (tid & 7) * B::CPT;

  // the key tiles that run: an interval
  const int kt_hi = p.causal ? min(nk - 1, q1 / kBN) : nk - 1;
  int kt_lo = 0;
  while (kt_lo <= kt_hi &&
         !tile_runs(p, q0, q1, kt_lo * kBN, min(kt_lo * kBN + kBN, p.sk) - 1))
    ++kt_lo;
  const int n_items = max(0, kt_hi - kt_lo + 1);
  constexpr int SPI = B::RESIDENT ? B::NC : B::NC + B::NC / 2;  // an item
  const int n_stages = n_items * SPI;

  const float* kb = static_cast<const float*>(p.k) + b * p.st[kK][0] +
                    g * p.st[kK][2];
  const float* vb = static_cast<const float*>(p.v) + b * p.st[kV][0] +
                    g * p.st[kV][2];
  auto issue = [&](int idx) {
    if (idx < n_stages) {
      const int item = idx / SPI, m = idx % SPI;
      const int k0 = (kt_lo + item) * kBN;
      float* st = ring + (idx % B::SLOTS) * B::STAGE;
      const int c0 = m < B::NC ? m * B::DC : (m - B::NC) * 2 * B::DC;
      stage_rows<kBN, B::DC, B::LDC>(st, kb, p.st[kK][1], k0, p.sk, c0);
      if (m < B::NC)
        stage_rows<kBN, B::DC, B::LDC>(st + kBN * B::LDC, vb, p.st[kV][1], k0,
                                       p.sk, c0);
      else
        stage_rows<kBN, B::DC, B::LDC>(st + kBN * B::LDC, kb, p.st[kK][1], k0,
                                       p.sk, c0 + B::DC);
    }
    cp_async_commit();
  };

  stage_rows<kBM, HD, B::LD>(
      sQ, static_cast<const float*>(p.q) + b * p.st[kQ][0] + h * p.st[kQ][2],
      p.st[kQ][1], q0, p.sq, 0);
  stage_rows<kBM, HD, B::LD>(
      sDO,
      static_cast<const float*>(p.dout) + b * p.st[kDO][0] + h * p.st[kDO][2],
      p.st[kDO][1], q0, p.sq, 0);
  stage_stats<kBM>(sLse, p.lse + b * p.st[kLse][0] + h * p.st[kLse][1],
                   p.st[kLse][2], q0, p.sq);
  stage_stats<kBM>(sDelta, p.delta + b * p.st[kDelta][0] +
                               h * p.st[kDelta][1],
                   p.st[kDelta][2], q0, p.sq);
#pragma unroll
  for (int i = 0; i < B::AHEAD; ++i) issue(i);

  // resident: the chunk pair grp; streamed: chunks 2c + grp
  constexpr int NA = B::RESIDENT ? 1 : B::NC / 2;
  float acc[NA][B::PR][B::PC];
#pragma unroll
  for (int c = 0; c < NA; ++c)
#pragma unroll
    for (int i = 0; i < B::PR; ++i)
#pragma unroll
      for (int e = 0; e < B::PC; ++e) acc[c][i][e] = 0.f;

  int seq = 0;
  auto next = [&]() -> const float* {          // the next stage, landed
    cp_async_wait<B::AHEAD - 1>();
    __syncthreads();
    issue(seq + B::AHEAD);
    return ring + (seq++ % B::SLOTS) * B::STAGE;
  };
  const float* own = grp ? sDO : sQ;
  for (int item = 0; item < n_items; ++item) {
    const int k0 = (kt_lo + item) * kBN;
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int c = 0; c < B::NC; ++c) {
      const float* st = next();
      score_chunk<B::DC, B::LD, B::LDC, B::SCORE_UNROLL>(
          own, st + grp * kBN * B::LDC, ra, cg, c * B::DC, s);
    }
    const bool full = q0 + kBM <= p.sq && k0 + kBN <= p.sk &&
                      (!p.causal || k0 + kBN - 1 <= q0) &&
                      (p.window <= 0 || k0 > q0 + kBM - 1 - p.window);
    put_scores(s, grp ? sDS : sP, ra, cg);
    __syncthreads();                            // S, dP written
    softmax_grad<true>(p, sP, sDS, q0, k0, full, sLse, sDelta);
    __syncthreads();                            // P, dS written
#pragma unroll
    for (int c = 0; c < NA; ++c) {
      // K columns: of chunk 2 grp + pc / 32, still in the ring; or of
      // chunk 2c + grp, streamed again in pairs
      const float* st =
          B::RESIDENT ? ring + ((item * SPI + 2 * grp + pc / B::DC) %
                                B::SLOTS) * B::STAGE + pc % B::DC
                      : next() + grp * kBN * B::LDC + pc;
      product_chunk<B::PR, B::PC, B::LDC, B::PRODUCT_UNROLL>(sDS, st, pr,
                                                             acc[c]);
    }
  }
  cp_async_wait<0>();

  float* ob = static_cast<float*>(p.out0) + b * p.st[kOut0][0] +
              h * p.st[kOut0][2];
#pragma unroll
  for (int i = 0; i < B::PR; ++i) {
    const int qi = q0 + pr + i;
    if (qi >= p.sq) continue;
#pragma unroll
    for (int c = 0; c < NA; ++c)
#pragma unroll
      for (int e = 0; e < B::PC; ++e) {
        const int col = B::RESIDENT ? 2 * grp * B::DC + pc + e
                                    : (2 * c + grp) * B::DC + pc + e;
        ob[qi * p.st[kOut0][1] + col] = acc[c][i][e];
      }
  }
}

// dK/dV: one block per (key tile, KV head, batch), the group's query heads
// and their query tiles streamed; blockIdx.x = key tile * kv_heads * batch
// + head-and-batch (the first key tiles, the heaviest when causal, first)
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) dkv_kernel(Params p) {
  using B = Bwd<HD>;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);         // own: K, V
  float* sV = sK + kBM * B::LD;
  float* ring = sV + kBM * B::LD;
  float* sP = ring + B::SLOTS * B::STAGE;
  float* sDS = sP + kBN * kLdX;
  float* sStat = sDS + kBN * kLdX;                     // [item & 1][lse, delta]

  const int gb = blockIdx.x % (p.kv_heads * p.batch);
  const int g = gb % p.kv_heads, b = gb / p.kv_heads;
  const int kt = static_cast<int>(blockIdx.x / (p.kv_heads * p.batch));
  const int k0 = kt * kBM, k1 = min(k0 + kBM, p.sk) - 1;
  const int nq = (p.sq + kBN - 1) / kBN;
  const int tid = threadIdx.x, grp = tid >> 7;
  const int rg = (tid & 127) >> 4, cg = tid & 15;
  const int ra = (rg >> 1) * 16 + (rg & 1) * 4;        // scores: own rows
  // products: rows pr.., columns pc: 8 x 4 of a chunk pair (resident)
  // or 4 x CPT of a chunk
  const int pr = B::RESIDENT ? ((tid & 127) >> 4) * 8 : ((tid & 127) >> 3) * 4;
  const int pc = B::RESIDENT ? (tid & 15) * 4 : (tid & 7) * B::CPT;

  // the query tiles that run: an interval
  int qt_lo = 0, qt_hi = nq - 1;
  while (qt_lo <= qt_hi &&
         !tile_runs(p, qt_lo * kBN, min(qt_lo * kBN + kBN, p.sq) - 1, k0, k1))
    ++qt_lo;
  while (qt_hi >= qt_lo &&
         !tile_runs(p, qt_hi * kBN, min(qt_hi * kBN + kBN, p.sq) - 1, k0, k1))
    --qt_hi;
  const int n_qt = max(0, qt_hi - qt_lo + 1);
  const int n_items = n_qt * p.n_rep;
  constexpr int SPI = B::RESIDENT ? B::NC : 2 * B::NC;
  const int n_stages = n_items * SPI;

  auto issue = [&](int idx) {
    if (idx < n_stages) {
      const int item = idx / SPI, m = idx % SPI;
      const int h = g * p.n_rep + item / n_qt;
      const int q0 = (qt_lo + item % n_qt) * kBN;
      float* st = ring + (idx % B::SLOTS) * B::STAGE;
      const int c0 = (m % B::NC) * B::DC;
      stage_rows<kBN, B::DC, B::LDC>(
          st, static_cast<const float*>(p.q) + b * p.st[kQ][0] +
                  h * p.st[kQ][2],
          p.st[kQ][1], q0, p.sq, c0);
      stage_rows<kBN, B::DC, B::LDC>(
          st + kBN * B::LDC, static_cast<const float*>(p.dout) +
                                 b * p.st[kDO][0] + h * p.st[kDO][2],
          p.st[kDO][1], q0, p.sq, c0);
      if (m == 0) {
        float* ss = sStat + (item & 1) * 2 * kBN;
        stage_stats<kBN>(ss, p.lse + b * p.st[kLse][0] + h * p.st[kLse][1],
                         p.st[kLse][2], q0, p.sq);
        stage_stats<kBN>(ss + kBN, p.delta + b * p.st[kDelta][0] +
                                       h * p.st[kDelta][1],
                         p.st[kDelta][2], q0, p.sq);
      }
    }
    cp_async_commit();
  };

  stage_rows<kBM, HD, B::LD>(
      sK, static_cast<const float*>(p.k) + b * p.st[kK][0] + g * p.st[kK][2],
      p.st[kK][1], k0, p.sk, 0);
  stage_rows<kBM, HD, B::LD>(
      sV, static_cast<const float*>(p.v) + b * p.st[kV][0] + g * p.st[kV][2],
      p.st[kV][1], k0, p.sk, 0);
#pragma unroll
  for (int i = 0; i < B::AHEAD; ++i) issue(i);

  // group 0 sums dV, group 1 dK
  // resident: chunk pairs; streamed: chunks
  constexpr int NA = B::RESIDENT ? B::NC / 2 : B::NC;
  float acc[NA][B::PR][B::PC];
#pragma unroll
  for (int c = 0; c < NA; ++c)
#pragma unroll
    for (int i = 0; i < B::PR; ++i)
#pragma unroll
      for (int e = 0; e < B::PC; ++e) acc[c][i][e] = 0.f;

  int seq = 0;
  auto next = [&]() -> const float* {          // the next stage, landed
    cp_async_wait<B::AHEAD - 1>();
    __syncthreads();
    issue(seq + B::AHEAD);
    return ring + (seq++ % B::SLOTS) * B::STAGE;
  };
  const float* own = grp ? sV : sK;
  for (int item = 0; item < n_items; ++item) {
    const int q0 = (qt_lo + item % n_qt) * kBN;
    const float* stat = sStat + (item & 1) * 2 * kBN;
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int c = 0; c < B::NC; ++c) {
      const float* st = next();
      score_chunk<B::DC, B::LD, B::LDC, B::SCORE_UNROLL>(
          own, st + grp * kBN * B::LDC, ra, cg, c * B::DC, s);
    }
    const bool full = k0 + kBM <= p.sk && q0 + kBN <= p.sq &&
                      (!p.causal || k0 + kBM - 1 <= q0) &&
                      (p.window <= 0 || k0 > q0 + kBN - 1 - p.window);
    put_scores(s, grp ? sDS : sP, ra, cg);
    __syncthreads();                            // S, dP written
    softmax_grad<false>(p, sP, sDS, k0, q0, full, stat, stat + kBN);
    __syncthreads();                            // P, dS written
    const float* sx = grp ? sDS : sP;
#pragma unroll
    for (int c = 0; c < NA; ++c) {
      // columns of chunk 2c + pc / 32 still in the ring, or of chunk c
      // streamed again
      const float* st = B::RESIDENT
          ? ring + ((item * SPI + 2 * c + pc / B::DC) % B::SLOTS) * B::STAGE +
                pc % B::DC
          : next() + pc;
      // dV += P^T dO (dO: second tile), dK += dS^T Q (Q: first tile)
      product_chunk<B::PR, B::PC, B::LDC, B::PRODUCT_UNROLL>(
          sx, st + (1 - grp) * kBN * B::LDC, pr, acc[c]);
    }
  }
  cp_async_wait<0>();

  const int slot = grp ? kOut0 : kOut1;               // dK : dV
  float* out = static_cast<float*>(grp ? p.out0 : p.out1) +
               b * p.st[slot][0] + g * p.st[slot][2];
#pragma unroll
  for (int i = 0; i < B::PR; ++i) {
    const int kj = k0 + pr + i;
    if (kj >= p.sk) continue;
#pragma unroll
    for (int c = 0; c < NA; ++c)
#pragma unroll
      for (int e = 0; e < B::PC; ++e) {
        const int col = (B::RESIDENT ? 2 * B::DC : B::DC) * c + pc + e;
        out[kj * p.st[slot][1] + col] = acc[c][i][e];
      }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kern>
int run(Kern kern, dim3 grid, int smem, const Params& p, cudaStream_t stream) {
  if (grid.x == 0) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(int which, const Params& p, cudaStream_t stream) {
  constexpr int LD = HD + 4;
  constexpr int BQ = 64, BK = HD <= 128 ? 64 : 32;       // forward
  constexpr int F = sizeof(float);
  if (which == 0) {
    const dim3 grid((p.sq + BQ - 1) / BQ, p.heads, p.batch);
    const int smem = ((BQ + 2 * BK) * LD + BQ * (BK + 4)) * F;
    return run(fwd_kernel<T, HD, BQ, BK>, grid, smem, p, stream);
  }
  using B = Bwd<HD>;
  const int ring = B::SLOTS * B::STAGE;
  if (which == 1) {
    const int64_t blocks =
        static_cast<int64_t>((p.sq + kBM - 1) / kBM) * p.heads * p.batch;
    const int smem = (2 * kBM * B::LD + ring + 2 * kBN * kLdX + 2 * kBM) * F;
    return run(dq_kernel<HD>, dim3(static_cast<unsigned>(blocks)), smem, p,
               stream);
  }
  if (which == 2) {
    const int64_t blocks =
        static_cast<int64_t>((p.sk + kBM - 1) / kBM) * p.kv_heads * p.batch;
    const int smem = (2 * kBM * B::LD + ring + 2 * kBN * kLdX + 4 * kBN) * F;
    return run(dkv_kernel<HD>, dim3(static_cast<unsigned>(blocks)), smem, p,
               stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int by_head_dim(int which, int head_dim, const Params& p,
                cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(which, p, stream);
    case 64: return launch<T, 64>(which, p, stream);
    case 128: return launch<T, 128>(which, p, stream);
    case 256: return launch<T, 256>(which, p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// which: 0 = forward (writes out0 = o and lse), 1 = dQ (out0 = dq),
// 2 = dK/dV (out0 = dk, out1 = dv, one per KV head).
// ptrs: q, k, v, dO, lse, delta, out0, out1 (unused ones may be null).
// dims: batch, heads, kv_heads, sq, sk, head_dim, causal, window.
// strides: 8 x 3 element strides in the order of ptrs, (batch, sequence,
// head) for the tensors and (batch, head, sequence) for lse and delta;
// head_dim is contiguous and every row start is 16-byte aligned (the
// Python wrapper checks both).  dtype 0 = float32 (bfloat16, 1, is
// flash_attention_sm90.cu's); lse and delta are float32.  head_dim in
// {32, 64, 128, 256}, heads a multiple of kv_heads.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for what it does not take.
extern "C" int flash_attention(int which, const void* const* ptrs,
                               const int64_t* dims, const int64_t* strides,
                               int dtype, float scale, void* stream) {
  Params p;
  p.q = ptrs[0];
  p.k = ptrs[1];
  p.v = ptrs[2];
  p.dout = ptrs[3];
  p.lse = static_cast<float*>(const_cast<void*>(ptrs[4]));
  p.delta = static_cast<const float*>(ptrs[5]);
  p.out0 = const_cast<void*>(ptrs[6]);
  p.out1 = const_cast<void*>(ptrs[7]);
  p.batch = static_cast<int>(dims[0]);
  p.heads = static_cast<int>(dims[1]);
  p.kv_heads = static_cast<int>(dims[2]);
  p.sq = static_cast<int>(dims[3]);
  p.sk = static_cast<int>(dims[4]);
  const int head_dim = static_cast<int>(dims[5]);
  p.causal = static_cast<int>(dims[6]);
  p.window = static_cast<int>(dims[7]);
  if (p.batch == 0 || p.heads == 0 || p.sq == 0 || p.sk == 0) return 0;
  if (p.kv_heads <= 0 || p.heads % p.kv_heads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.n_rep = p.heads / p.kv_heads;
  for (int t = 0; t < 8; ++t)
    for (int d = 0; d < 3; ++d) p.st[t][d] = strides[3 * t + d];
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_head_dim<float>(which, head_dim, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
