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
// Design (SIMT fp32: TF32 is off, so no tensor cores).  What caps a SIMT
// product here is shared memory, not the FMA pipe: an SM's shared memory
// hands out 32 floats a cycle against 128 FMAs, so a thread tile must do
// 4 FMAs per float it loads to run at the FMA rate.  Every kernel streams
// the tiles it does not own through a cp.async ring, so that the next
// chunk lands while the current one is multiplied, and skips the tiles
// that causality and the window leave out whole; only tiles on the
// diagonal, the window's edge or a ragged end test allowed().  Forward
// (see "forward" below): a block owns 128 query rows (64 at head dim
// 256) and walks its key tiles of 128 with 8 x 8 thread tiles (8 x 4 in
// the scores at 256).
// Backward: two kernels on one pipeline (see "backward" below): dQ per
// query tile, and dK/dV per key tile with the n_rep query heads of its
// group summed in fp32 registers, so dK/dV are written once per KV head in
// (B, Sk, Hkv, hd), with no per-query-head intermediates, no reduction
// pass and no atomics (dQ recomputes S and dP: 7 products where the bound
// counts 5).  Every sum runs in a fixed order, so two runs are bitwise equal.
// Every tensor is read and written through its (batch, sequence, head)
// element strides with head_dim contiguous, so the model layout
// (B, S, H, hd) needs no transpose.  Head dim 80 (stablelm-3b) runs head
// dim 128's kernels: columns 80-127 are staged as zeros and never stored,
// so the arithmetic is the same and 1.6x the work.  Keys at or past
// kv_len (the count of valid keys of a call padded to whole tiles) are
// masked as keys past the sequence are, and their dK/dV rows are zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;   // the reference's masked score
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

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
  int sk_rows;          // K/V rows; keys at or past sk (kv_len) are masked
  int d;                // head_dim (the instance's HD, or 80 in HD 128's)
  // element strides by Slot: (batch, sequence, head) for q, k, v, dO,
  // out0, out1; (batch, head, sequence) for lse and delta
  int64_t st[8][3];
  float scale;
};

__device__ __forceinline__ bool tile_runs(const Params& p, int q0, int q1,
                                          int k0, int k1) {
  // the Pallas kernels' block skip (kernel.py:45-49), at this kernel's
  // tiles: q0..q1 and k0..k1 are the tiles' first and last positions
  return (!p.causal || k0 <= q1) && (p.window <= 0 || k1 > q0 - p.window);
}

__device__ __forceinline__ bool allowed(const Params& p, int i, int j) {
  return (!p.causal || j <= i) && (p.window <= 0 || j > i - p.window);
}

// ---------------------------------------------------------------------------
// the cp.async pipeline that every kernel here streams its tiles through
// ---------------------------------------------------------------------------

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
// (zeros at or past the row's width d) of a tensor with rows row_stride
// elements apart, into shared memory with leading dimension LDS
template <int ROWS, int COLS, int LDS>
__device__ __forceinline__ void stage_rows(float* sm, const float* base,
                                           int64_t row_stride, int row0,
                                           int n, int col0, int d) {
  constexpr int VPR = COLS / 4;
  for (int e = threadIdx.x; e < ROWS * VPR; e += kThreads) {
    const int r = e / VPR, v = (e % VPR) * 4;
    const bool ok = row0 + r < n && col0 + v < d;
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


// A thread's 8 own rows: ra..ra+3 and ra+8..ra+11, ra = (rg / 2) * 16 +
// (rg % 2) * 4, so that the two row groups of a warp read disjoint banks.
__device__ __forceinline__ int own_row(int ra, int i) {
  return ra + (i & 3) + (i >> 2) * 8;
}

// ---------------------------------------------------------------------------
// forward: one block per (query tile, query head, batch)
// ---------------------------------------------------------------------------
//
// A block of 256 threads owns BQ query rows, whose Q stays in shared
// memory, and walks the key tiles that run (all of them when a row of the
// tile has no allowed key), BK keys a tile, in ascending order.  Per key
// tile it streams K in depth chunks of DC columns and then V in chunks of
// VK whole rows through one cp.async ring, AHEAD stages in flight:
//   scores   S = Q K^T, each thread SR x SC (8 x 8; 8 x 4 at head dim
//            256) of the BQ x BK tile,
//            rows own_row(ra, i), columns cg + NCG j, summed over the K
//            chunks in registers;
//   softmax  the online softmax in the same registers: the NCG threads
//            of a row (one half-warp, or a warp at 256) reduce its max
//            and sum by shuffles; P goes to shared memory transposed,
//            [key][query], and each row's rescale factor beside it; only
//            tiles on the diagonal, the window's edge or the ragged end
//            test allowed();
//   products O = O corr + P V, each thread PR consecutive rows x PC
//            columns (8 x 8 at head dims 128 and 256), over the V chunks.
// Per 16-byte shared-memory read both products do 16 FMAs at 8 x 8, so
// their operands no longer cap them below the FMA rate (4 x 4 tiles
// did 8; 8 x 4 does 10.7).  Tiles: BQ x BK = 128 x 128 up to head dim
// 128 (Q, P and four ring slots: 205 KB); 64 x 128 at 256, three slots
// (197 KB; key tiles of 256 with 8 x 8 scores were slower: the keys a
// window's edge and the diagonal waste grow with the tile).  Blocks are
// issued heaviest first (the last query tiles under causal masking).  Every sum
// runs in a fixed order: bitwise repeatable.

template <int HD>
struct Fwd {
  static constexpr int BQ = HD <= 128 ? 128 : 64;   // query rows
  static constexpr int BK = 128;                    // keys a tile
  static constexpr int NCG = HD <= 128 ? 16 : 32;   // threads of a row
  static constexpr int DC = 32;                     // K chunk: columns
  static constexpr int VK = 32;                     // V chunk: rows
  static constexpr int PR = HD <= 32 ? 4 : 8;       // product rows
  static constexpr int AHEAD = HD <= 128 ? 3 : 2;   // stages in flight
  static constexpr int SC = BK / NCG;               // score columns
  static constexpr int SR = BQ * NCG / kThreads;    // score rows
  static constexpr int PCG = kThreads / (BQ / PR);  // product col groups
  static constexpr int PC = HD / PCG;               // product columns
  static constexpr int NC = HD / DC, NV = BK / VK;  // chunks a tile
  static constexpr int LDQ = HD + 4, LDK = DC + 4, LDP = BQ + 4;
  static constexpr int SLOT = BK * LDK > VK * LDQ ? BK * LDK : VK * LDQ;
  static constexpr int SLOTS = AHEAD + 1;
  static constexpr int SMEM = (BQ * LDQ + BK * LDP + SLOTS * SLOT + 3 * BQ)
                              * static_cast<int>(sizeof(float));
  static_assert(SR == 8 && PC % 4 == 0 && HD % DC == 0 && BK % VK == 0,
                "forward tile shapes");
};

// reductions over the W threads that share a row (W = 16 or 32, lanes
// aligned to W)
template <int W>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
template <int W>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// s[i][j] += q[own_row(ra, i)] . k[cg + NCG j] over one K chunk of DC
// columns (q: resident at column c0; k: the chunk)
template <int HD>
__device__ __forceinline__ void fwd_scores(
    const float* sq, const float* sk, int ra, int cg, int c0,
    float (&s)[Fwd<HD>::SR][Fwd<HD>::SC]) {
  using F = Fwd<HD>;
#pragma unroll
  for (int d = 0; d < F::DC; d += 4) {
    float4 b[F::SC];
#pragma unroll
    for (int j = 0; j < F::SC; ++j)
      b[j] = *reinterpret_cast<const float4*>(sk + (cg + F::NCG * j) * F::LDK
                                              + d);
#pragma unroll
    for (int i = 0; i < F::SR; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(
          sq + own_row(ra, i) * F::LDQ + c0 + d);
#pragma unroll
      for (int j = 0; j < F::SC; ++j) {
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

// The online softmax of one key tile on this thread's scores, in place
// and in base 2: s becomes P = 2^(S log2(e) - m), masked scores -1e30;
// each row's running max m (base 2) and sum l live in sM and sL (written
// by the row's first thread), and its factor 2^(m_old - m_new) goes to
// sCorr.  full: every (row, key) of the tile is allowed and in range, so
// nothing is tested.
template <int HD>
__device__ __forceinline__ void fwd_softmax(
    const Params& p, float (&s)[Fwd<HD>::SR][Fwd<HD>::SC], float* sM,
    float* sL, float* sCorr, int q0, int k0, int ra, int cg, bool full) {
  using F = Fwd<HD>;
  const float c = p.scale * kLog2e;
#pragma unroll
  for (int i = 0; i < F::SR; ++i) {
    const int r = own_row(ra, i), qi = q0 + r;
    const float m_old = sM[r], l_old = sL[r];
    float mx = m_old;
#pragma unroll
    for (int j = 0; j < F::SC; ++j) {
      const int kj = k0 + cg + F::NCG * j;
      const float x = s[i][j] * c;
      s[i][j] = full || (kj < p.sk && allowed(p, qi, kj)) ? x : kNegInf;
      mx = fmaxf(mx, s[i][j]);
    }
    mx = group_max<F::NCG>(mx);
    const float corr = exp2f(m_old - mx);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < F::SC; ++j) {
      const int kj = k0 + cg + F::NCG * j;
      s[i][j] = full || kj < p.sk ? exp2f(s[i][j] - mx) : 0.f;
      psum += s[i][j];
    }
    const float l = l_old * corr + group_sum<F::NCG>(psum);
    __syncwarp();                      // the row's threads have read m, l
    if (cg == 0) {
      sM[r] = mx;
      sL[r] = l;
      sCorr[r] = corr;
    }
  }
}

// This thread's P into sP transposed, [key][query]
template <int HD>
__device__ __forceinline__ void fwd_put(
    const float (&s)[Fwd<HD>::SR][Fwd<HD>::SC], float* sP, int ra, int cg) {
  using F = Fwd<HD>;
#pragma unroll
  for (int j = 0; j < F::SC; ++j) {
    float* dst = sP + (cg + F::NCG * j) * F::LDP + ra;
    *reinterpret_cast<float4*>(dst) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    *reinterpret_cast<float4*>(dst + 8) =
        make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
  }
}

// acc[i][e] += sum_n P[n][pr + i] V[n][col(e)] over one V chunk of VK
// rows (sp: P's rows of these keys; columns (m PCG + cgp) 4 + e % 4)
template <int HD>
__device__ __forceinline__ void fwd_products(
    const float* sp, const float* sv, int pr, int cgp,
    float (&acc)[Fwd<HD>::PR][Fwd<HD>::PC]) {
  using F = Fwd<HD>;
#pragma unroll 16
  for (int n = 0; n < F::VK; ++n) {
    float xs[F::PR], bv[F::PC];
#pragma unroll
    for (int i = 0; i < F::PR; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(sp + n * F::LDP + pr
                                                        + i);
      xs[i] = x.x;
      xs[i + 1] = x.y;
      xs[i + 2] = x.z;
      xs[i + 3] = x.w;
    }
#pragma unroll
    for (int c = 0; c < F::PC; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(
          sv + n * F::LDQ + ((c / 4) * F::PCG + cgp) * 4);
      bv[c] = t.x;
      bv[c + 1] = t.y;
      bv[c + 2] = t.z;
      bv[c + 3] = t.w;
    }
#pragma unroll
    for (int i = 0; i < F::PR; ++i)
#pragma unroll
      for (int e = 0; e < F::PC; ++e) acc[i][e] = fmaf(xs[i], bv[e], acc[i][e]);
  }
}

// blockIdx.x = rank * heads * batch + head-and-batch, query tiles issued
// last first
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) fwd_kernel(Params p) {
  using F = Fwd<HD>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sP = sQ + F::BQ * F::LDQ;                  // [key][query]
  float* ring = sP + F::BK * F::LDP;
  float* sCorr = ring + F::SLOTS * F::SLOT;         // per row: rescale,
  float* sM = sCorr + F::BQ;                        // running max (base 2)
  float* sL = sM + F::BQ;                           // and running sum

  const int hb = blockIdx.x % (p.heads * p.batch);
  const int h = hb % p.heads, b = hb / p.heads, g = h / p.n_rep;
  const int nq = (p.sq + F::BQ - 1) / F::BQ, nk = (p.sk + F::BK - 1) / F::BK;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x / (p.heads * p.batch));
  const int q0 = qt * F::BQ, q1 = min(q0 + F::BQ, p.sq) - 1;
  const int tid = threadIdx.x;
  const int rg = tid / F::NCG, cg = tid % F::NCG;  // scores
  const int ra = (rg >> 1) * 16 + (rg & 1) * 4;
  const int pr = (tid / F::PCG) * F::PR, cgp = tid % F::PCG;  // products

  // the key tiles that run, an interval; every tile when a row of this
  // query tile has no allowed key (it averages V over every key)
  const bool every = p.window > 0 && q1 - p.window >= p.sk - 1;
  int kt_lo = 0, kt_hi = nk - 1;
  if (!every) {
    if (p.causal) kt_hi = min(kt_hi, q1 / F::BK);
    while (kt_lo <= kt_hi &&
           !tile_runs(p, q0, q1, kt_lo * F::BK,
                      min(kt_lo * F::BK + F::BK, p.sk) - 1))
      ++kt_lo;
  }
  const int n_tiles = max(0, kt_hi - kt_lo + 1);
  constexpr int SPT = F::NC + F::NV;                // stages a tile
  const int n_stages = n_tiles * SPT;

  const float* kb = static_cast<const float*>(p.k) + b * p.st[kK][0] +
                    g * p.st[kK][2];
  const float* vb = static_cast<const float*>(p.v) + b * p.st[kV][0] +
                    g * p.st[kV][2];
  auto issue = [&](int idx) {
    if (idx < n_stages) {
      const int k0 = (kt_lo + idx / SPT) * F::BK, m = idx % SPT;
      float* st = ring + (idx % F::SLOTS) * F::SLOT;
      if (m < F::NC)
        stage_rows<F::BK, F::DC, F::LDK>(st, kb, p.st[kK][1], k0, p.sk,
                                         m * F::DC, p.d);
      else
        stage_rows<F::VK, HD, F::LDQ>(st, vb, p.st[kV][1],
                                      k0 + (m - F::NC) * F::VK, p.sk, 0, p.d);
    }
    cp_async_commit();
  };

  stage_rows<F::BQ, HD, F::LDQ>(
      sQ, static_cast<const float*>(p.q) + b * p.st[kQ][0] + h * p.st[kQ][2],
      p.st[kQ][1], q0, p.sq, 0, p.d);
#pragma unroll
  for (int i = 0; i < F::AHEAD; ++i) issue(i);

  if (tid < F::BQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  float acc[F::PR][F::PC];
#pragma unroll
  for (int i = 0; i < F::PR; ++i)
#pragma unroll
    for (int e = 0; e < F::PC; ++e) acc[i][e] = 0.f;

  int seq = 0;
  auto next = [&]() -> const float* {          // the next stage, landed
    cp_async_wait<F::AHEAD - 1>();
    __syncthreads();
    issue(seq + F::AHEAD);
    return ring + (seq++ % F::SLOTS) * F::SLOT;
  };
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = (kt_lo + t) * F::BK;
    float s[F::SR][F::SC];
#pragma unroll
    for (int i = 0; i < F::SR; ++i)
#pragma unroll
      for (int j = 0; j < F::SC; ++j) s[i][j] = 0.f;
#pragma unroll 1
    for (int c = 0; c < F::NC; ++c) {
      const float* st = next();
      fwd_scores<HD>(sQ, st, ra, cg, c * F::DC, s);
    }
    const bool full = q0 + F::BQ <= p.sq && k0 + F::BK <= p.sk &&
                      (!p.causal || k0 + F::BK - 1 <= q0) &&
                      (p.window <= 0 || k0 > q0 + F::BQ - 1 - p.window);
    fwd_softmax<HD>(p, s, sM, sL, sCorr, q0, k0, ra, cg, full);
    fwd_put<HD>(s, sP, ra, cg);
#pragma unroll 1
    for (int c = 0; c < F::NV; ++c) {
      const float* st = next();                // also: P and sCorr written
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < F::PR; ++i) {
          const float corr = sCorr[pr + i];
#pragma unroll
          for (int e = 0; e < F::PC; ++e) acc[i][e] *= corr;
        }
      }
      fwd_products<HD>(sP + c * F::VK * F::LDP, st, pr, cgp, acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                             // the last tile's m and l

  // lse in natural units; a row with no allowed key keeps -1e30
  if (tid < F::BQ && q0 + tid < p.sq) {
    const float mt = sM[tid];
    p.lse[b * p.st[kLse][0] + h * p.st[kLse][1] + (q0 + tid) * p.st[kLse][2]]
        = (mt == kNegInf ? mt : mt * kLn2) + logf(fmaxf(sL[tid], 1e-30f));
  }
  float* ob = static_cast<float*>(p.out0) + b * p.st[kOut0][0] +
              h * p.st[kOut0][2];
#pragma unroll
  for (int i = 0; i < F::PR; ++i) {
    const int qi = q0 + pr + i;
    if (qi >= p.sq) continue;
    const float ll = fmaxf(sL[pr + i], 1e-30f);
#pragma unroll
    for (int c = 0; c < F::PC; c += 4) {
      const int col = ((c / 4) * F::PCG + cgp) * 4;
      if (col < p.d)
        *reinterpret_cast<float4*>(ob + qi * p.st[kOut0][1] + col) =
            make_float4(acc[i][c] / ll, acc[i][c + 1] / ll,
                        acc[i][c + 2] / ll, acc[i][c + 3] / ll);
    }
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
      stage_rows<kBN, B::DC, B::LDC>(st, kb, p.st[kK][1], k0, p.sk, c0,
                                     p.d);
      if (m < B::NC)
        stage_rows<kBN, B::DC, B::LDC>(st + kBN * B::LDC, vb, p.st[kV][1], k0,
                                       p.sk, c0, p.d);
      else
        stage_rows<kBN, B::DC, B::LDC>(st + kBN * B::LDC, kb, p.st[kK][1], k0,
                                       p.sk, c0 + B::DC, p.d);
    }
    cp_async_commit();
  };

  stage_rows<kBM, HD, B::LD>(
      sQ, static_cast<const float*>(p.q) + b * p.st[kQ][0] + h * p.st[kQ][2],
      p.st[kQ][1], q0, p.sq, 0, p.d);
  stage_rows<kBM, HD, B::LD>(
      sDO,
      static_cast<const float*>(p.dout) + b * p.st[kDO][0] + h * p.st[kDO][2],
      p.st[kDO][1], q0, p.sq, 0, p.d);
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
        if (col < p.d) ob[qi * p.st[kOut0][1] + col] = acc[c][i][e];
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
  // a key tile wholly at or past kv_len has no work: it writes zeros
  const int n_qt = k0 >= p.sk ? 0 : max(0, qt_hi - qt_lo + 1);
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
          p.st[kQ][1], q0, p.sq, c0, p.d);
      stage_rows<kBN, B::DC, B::LDC>(
          st + kBN * B::LDC, static_cast<const float*>(p.dout) +
                                 b * p.st[kDO][0] + h * p.st[kDO][2],
          p.st[kDO][1], q0, p.sq, c0, p.d);
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
      p.st[kK][1], k0, p.sk, 0, p.d);
  stage_rows<kBM, HD, B::LD>(
      sV, static_cast<const float*>(p.v) + b * p.st[kV][0] + g * p.st[kV][2],
      p.st[kV][1], k0, p.sk, 0, p.d);
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
    if (kj >= p.sk_rows) continue;
#pragma unroll
    for (int c = 0; c < NA; ++c)
#pragma unroll
      for (int e = 0; e < B::PC; ++e) {
        const int col = (B::RESIDENT ? 2 * B::DC : B::DC) * c + pc + e;
        if (col < p.d) out[kj * p.st[slot][1] + col] = acc[c][i][e];
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

template <int HD>
int launch(int which, const Params& p, cudaStream_t stream) {
  constexpr int F = sizeof(float);
  if (which == 0) {
    using W = Fwd<HD>;
    const int64_t blocks =
        static_cast<int64_t>((p.sq + W::BQ - 1) / W::BQ) * p.heads * p.batch;
    return run(fwd_kernel<HD>, dim3(static_cast<unsigned>(blocks)), W::SMEM,
               p, stream);
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
        static_cast<int64_t>((p.sk_rows + kBM - 1) / kBM) * p.kv_heads *
        p.batch;
    const int smem = (2 * kBM * B::LD + ring + 2 * kBN * kLdX + 4 * kBN) * F;
    return run(dkv_kernel<HD>, dim3(static_cast<unsigned>(blocks)), smem, p,
               stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int by_head_dim(int which, int head_dim, const Params& p,
                cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<32>(which, p, stream);
    case 64: return launch<64>(which, p, stream);
    case 80: return launch<128>(which, p, stream);   // columns 80.. zero
    case 128: return launch<128>(which, p, stream);
    case 256: return launch<256>(which, p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// which: 0 = forward (writes out0 = o and lse), 1 = dQ (out0 = dq),
// 2 = dK/dV (out0 = dk, out1 = dv, one per KV head).
// ptrs: q, k, v, dO, lse, delta, out0, out1 (unused ones may be null).
// dims: batch, heads, kv_heads, sq, sk, head_dim, causal, window, kv_len
// (1 <= kv_len <= sk: keys at or past it are masked, and dK/dV are zero
// there).  strides: 8 x 3 element strides in the order of ptrs, (batch,
// sequence, head) for the tensors and (batch, head, sequence) for lse
// and delta; head_dim is contiguous and every row start is 16-byte
// aligned (the Python wrapper checks both).  dtype 0 = float32
// (bfloat16, 1, is flash_attention_sm90.cu's); lse and delta are float32.
// head_dim in {32, 64, 80, 128, 256} (80 runs head dim 128's kernels with
// columns 80.. loaded as zeros and never stored), heads a multiple of
// kv_heads.  Returns cudaGetLastError()
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
  p.sk_rows = p.sk;
  p.d = head_dim;
  if (p.batch == 0 || p.heads == 0 || p.sq == 0 || p.sk == 0) return 0;
  if (p.kv_heads <= 0 || p.heads % p.kv_heads || dims[8] < 1 ||
      dims[8] > p.sk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.sk = static_cast<int>(dims[8]);
  p.n_rep = p.heads / p.kv_heads;
  for (int t = 0; t < 8; ++t)
    for (int d = 0; d < 3; ++d) p.st[t][d] = strides[3 * t + d];
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_head_dim(which, head_dim, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
