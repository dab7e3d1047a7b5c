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
// Design (SIMT fp32, no tensor cores yet).  A block of 256 threads owns
// one tile: (batch, query head, 64 query rows) for the forward and dQ,
// (batch, KV head, key rows) for dK/dV.  Tiles are staged in shared
// memory as fp32 rows padded by 4 floats, so 16-byte reads of eight
// consecutive rows hit distinct banks.  Threads form a 16 x 16 grid:
// thread (rg, cg) computes the scores of rows rg*R..rg*R+R-1 against
// columns cg, cg+16, ... with float4 reads along head_dim, and owns the
// output elements of its rows in columns (m*16 + cg)*4..+3; the 16
// threads of a row are one half-warp, so row maxima and sums are warp
// shuffles.  Tiles that causality and the window leave out are skipped
// whole.  The dK/dV block loops over the n_rep query heads of its group
// and every query tile in range and keeps the group's sums in fp32
// registers, so dK/dV are written once per KV head in (B, Sk, Hkv, hd),
// with no per-query-head intermediates and no reduction pass.  No
// atomics: every sum runs in a fixed order, so two runs are bitwise
// equal.  Every tensor is read and written through its (batch, sequence,
// head) element strides with head_dim contiguous, so the model layout
// (B, S, H, hd) needs no transpose.  Tiles: 64 x 64 up to head_dim 128;
// at 256, key tiles of 32 (forward, dQ) and 32 x 32 (dK/dV) keep shared
// memory within the 227 KB a block may use and the accumulators in
// registers.  fp32 has no tensor-core route while TF32 is off.

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

// Row statistics of one tile row: lse / delta of rows row0.., 0 past n.
__device__ __forceinline__ void load_rows(float* sm, const float* base,
                                          int64_t stride, int row0, int n,
                                          int rows) {
  for (int i = threadIdx.x; i < rows; i += kThreads)
    sm[i] = row0 + i < n ? base[static_cast<int64_t>(row0 + i) * stride]
                         : 0.f;
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
// dQ: one block per (query tile, query head, batch), key tiles inner
// ---------------------------------------------------------------------------

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) dq_kernel(Params p) {
  constexpr int LD = HD + 4, LDP = BK + 4, R = BQ / 16, C = BK / 16;
  constexpr int EPT = Cols<HD>::EPT;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sDO = sQ + BQ * LD;
  float* sK = sDO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sDS = sV + BK * LD;
  float* sLse = sDS + BQ * LDP;
  float* sDelta = sLse + BQ;

  const int h = blockIdx.y, b = blockIdx.z, g = h / p.n_rep;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int q0 = blockIdx.x * BQ, q1 = min(q0 + BQ, p.sq) - 1;
  const T* kb = static_cast<const T*>(p.k) + b * p.st[kK][0] + g * p.st[kK][2];
  const T* vb = static_cast<const T*>(p.v) + b * p.st[kV][0] + g * p.st[kV][2];
  load_tile<T, HD, BQ>(
      sQ, static_cast<const T*>(p.q) + b * p.st[kQ][0] + h * p.st[kQ][2],
      p.st[kQ][1], q0, p.sq);
  load_tile<T, HD, BQ>(
      sDO, static_cast<const T*>(p.dout) + b * p.st[kDO][0] + h * p.st[kDO][2],
      p.st[kDO][1], q0, p.sq);
  load_rows(sLse, p.lse + b * p.st[kLse][0] + h * p.st[kLse][1],
            p.st[kLse][2], q0, p.sq, BQ);
  load_rows(sDelta, p.delta + b * p.st[kDelta][0] + h * p.st[kDelta][1],
            p.st[kDelta][2], q0, p.sq, BQ);

  float acc[R][EPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[i][e] = 0.f;
  const int nk = (p.sk + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK, k1 = min(k0 + BK, p.sk) - 1;
    if (!tile_runs(p, q0, q1, k0, k1)) continue;
    __syncthreads();
    load_tile<T, HD, BK>(sK, kb, p.st[kK][1], k0, p.sk);
    load_tile<T, HD, BK>(sV, vb, p.st[kV][1], k0, p.sk);
    __syncthreads();
    float s[R][C], dp[R][C];
    dots<HD, R, C>(sQ, sK, rg * R, cg, s);
    dots<HD, R, C>(sDO, sV, rg * R, cg, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = rg * R + i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int kj = k0 + cg + 16 * j;
        const bool ok = qi < p.sq && kj < p.sk && allowed(p, qi, kj);
        const float pij = ok ? expf(s[i][j] * p.scale - sLse[r]) : 0.f;
        sDS[r * LDP + cg + 16 * j] = pij * (dp[i][j] - sDelta[r]) * p.scale;
      }
    }
    __syncthreads();
    accum<HD, R, BK, LDP>(sDS, sK, rg * R, cg, acc);
  }

  T* ob = static_cast<T*>(p.out0) + b * p.st[kOut0][0] + h * p.st[kOut0][2];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + rg * R + i;
    if (qi >= p.sq) continue;
    T* orow = ob + qi * p.st[kOut0][1];
#pragma unroll
    for (int e = 0; e < EPT; ++e) store(orow + Cols<HD>::col(cg, e), acc[i][e]);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (key tile, KV head, batch); the group's query heads
// and their query tiles inner, summed in fp32 registers
// ---------------------------------------------------------------------------

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Params p) {
  constexpr int LD = HD + 4, LDW = BQ + 4, R = BK / 16, C = BQ / 16;
  constexpr int EPT = Cols<HD>::EPT;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sDO = sQ + BQ * LD;
  float* sPT = sDO + BQ * LD;
  float* sDST = sPT + BK * LDW;
  float* sLse = sDST + BK * LDW;
  float* sDelta = sLse + BQ;

  const int g = blockIdx.y, b = blockIdx.z;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int k0 = blockIdx.x * BK, k1 = min(k0 + BK, p.sk) - 1;
  load_tile<T, HD, BK>(
      sK, static_cast<const T*>(p.k) + b * p.st[kK][0] + g * p.st[kK][2],
      p.st[kK][1], k0, p.sk);
  load_tile<T, HD, BK>(
      sV, static_cast<const T*>(p.v) + b * p.st[kV][0] + g * p.st[kV][2],
      p.st[kV][1], k0, p.sk);

  float dk[R][EPT], dv[R][EPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < EPT; ++e) dk[i][e] = dv[i][e] = 0.f;
  const int nq = (p.sq + BQ - 1) / BQ;
  for (int rep = 0; rep < p.n_rep; ++rep) {
    const int h = g * p.n_rep + rep;
    const T* qb = static_cast<const T*>(p.q) + b * p.st[kQ][0] + h * p.st[kQ][2];
    const T* db =
        static_cast<const T*>(p.dout) + b * p.st[kDO][0] + h * p.st[kDO][2];
    const float* lb = p.lse + b * p.st[kLse][0] + h * p.st[kLse][1];
    const float* eb = p.delta + b * p.st[kDelta][0] + h * p.st[kDelta][1];
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * BQ, q1 = min(q0 + BQ, p.sq) - 1;
      if (!tile_runs(p, q0, q1, k0, k1)) continue;
      __syncthreads();
      load_tile<T, HD, BQ>(sQ, qb, p.st[kQ][1], q0, p.sq);
      load_tile<T, HD, BQ>(sDO, db, p.st[kDO][1], q0, p.sq);
      load_rows(sLse, lb, p.st[kLse][2], q0, p.sq, BQ);
      load_rows(sDelta, eb, p.st[kDelta][2], q0, p.sq, BQ);
      __syncthreads();
      float s[R][C], dp[R][C];
      dots<HD, R, C>(sK, sQ, rg * R, cg, s);
      dots<HD, R, C>(sV, sDO, rg * R, cg, dp);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = rg * R + i, kj = k0 + r;
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int c = cg + 16 * j, qi = q0 + c;
          const bool ok = qi < p.sq && kj < p.sk && allowed(p, qi, kj);
          const float pij = ok ? expf(s[i][j] * p.scale - sLse[c]) : 0.f;
          sPT[r * LDW + c] = pij;
          sDST[r * LDW + c] = pij * (dp[i][j] - sDelta[c]) * p.scale;
        }
      }
      __syncthreads();
      accum<HD, R, BQ, LDW>(sPT, sDO, rg * R, cg, dv);
      accum<HD, R, BQ, LDW>(sDST, sQ, rg * R, cg, dk);
    }
  }

  T* kout = static_cast<T*>(p.out0) + b * p.st[kOut0][0] + g * p.st[kOut0][2];
  T* vout = static_cast<T*>(p.out1) + b * p.st[kOut1][0] + g * p.st[kOut1][2];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + rg * R + i;
    if (kj >= p.sk) continue;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int col = Cols<HD>::col(cg, e);
      store(kout + kj * p.st[kOut0][1] + col, dk[i][e]);
      store(vout + kj * p.st[kOut1][1] + col, dv[i][e]);
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
  constexpr int BQ = 64, BK = HD <= 128 ? 64 : 32;       // forward and dQ
  constexpr int BKV = HD <= 128 ? 64 : 32;               // dK/dV tiles
  constexpr int BQV = HD <= 128 ? 64 : 32;
  constexpr int F = sizeof(float);
  if (which == 0) {
    const dim3 grid((p.sq + BQ - 1) / BQ, p.heads, p.batch);
    const int smem = ((BQ + 2 * BK) * LD + BQ * (BK + 4)) * F;
    return run(fwd_kernel<T, HD, BQ, BK>, grid, smem, p, stream);
  }
  if (which == 1) {
    const dim3 grid((p.sq + BQ - 1) / BQ, p.heads, p.batch);
    const int smem = ((2 * BQ + 2 * BK) * LD + BQ * (BK + 4) + 2 * BQ) * F;
    return run(dq_kernel<T, HD, BQ, BK>, grid, smem, p, stream);
  }
  if (which == 2) {
    const dim3 grid((p.sk + BKV - 1) / BKV, p.kv_heads, p.batch);
    const int smem =
        ((2 * BKV + 2 * BQV) * LD + 2 * BKV * (BQV + 4) + 2 * BQV) * F;
    return run(dkv_kernel<T, HD, BQV, BKV>, grid, smem, p, stream);
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
