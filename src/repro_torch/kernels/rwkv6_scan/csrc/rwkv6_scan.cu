// Chunked RWKV-6 WKV scan for Hopper (sm_90a), chunk-parallel with a
// carried state.
//
// Replaces: src/repro/kernels/rwkv6_scan/kernel.py::rwkv6_scan (Pallas
// body _wkv_kernel), the time-mix recurrence of every rwkv6 layer, which
// the port's serving prefill (models/rwkv6.py::prefill, through
// ops.py::wkv) runs here.
//
// For each (batch, head) row bh, with a zero state S (dk x dv) at the
// start, per chunk of c tokens (d = log_decay clipped to [-5, 0], cum its
// inclusive cumulative sum over the chunk, total = cum[c-1],
// cum_prev = cum - d, all per key channel):
//     qh = r * exp(cum_prev - total),   kh = k * exp(total - cum)
//     o  = (r * exp(cum_prev)) S + strict_lower(qh kh^T) v + (sum r*u*k) v
//     S <- exp(total)^T (.) S + kh^T v
// accumulated in fp32 for fp32 and bf16 inputs; o is written in r's type
// and the final S once, in fp32.  exp(cum_prev - total) is >= 1 (up to
// e^(5 (c - 1)), e^75 at the model's chunk of 16; fp32 ends at e^88.7),
// so the kernel uses expf (no fast-math) and never forms an entry of the
// upper triangle, whose products may overflow.  Chunks of 1 to 32 tokens
// are accepted (the reference's tests use 8, 16 and 32; the model uses
// the largest divisor of the prompt length up to 16).
//
// Bound on this card: memory at the serving prefill's shape.  A call must
// read r, k, v and log_decay once, u once, and write o and the state
// once; it does 2 (c dk + c dv + 2 dk dv) flops per token and head.  At
// rwkv6-3b's prefill of 8 x 128 tokens (320 rows, dk = dv = 64, c = 16,
// fp32) that is 57.7 MB against 0.84 GFLOP: 0.017 ms at 3.35 TB/s, more
// than the 0.013 ms at 67 TFLOP/s.  At 32,768 tokens and batch 1 the two
// are 0.50 and 0.40 ms.  A walk over a row's chunks is a chain of
// dependent chunk steps, so a row that one block walks alone is bound by
// the latency of a step, not by bytes or flops.
//
// Design.  A row of S tokens is cut into segments of L tokens, L a
// multiple of c (ops.py's plan: one segment per row when the rows alone
// fill the card, else enough segments to give every SM many blocks).  A
// block of 256 threads owns one (row, segment, tile of 64 dv columns).
// With one segment a call is one launch of walk_kernel<OUT=true> from a
// zero state.  With several it is three launches on one stream:
//   1. walk_kernel<OUT=false>: each block walks its segment from a zero
//      state and writes the segment's local state S_loc and its decay
//      exp(sum of totals) (per key channel) to a workspace;
//   2. carry_kernel: per row, in segment order, S_in[s] = A[s-1] (.)
//      S_in[s-1] + S_loc[s-1], one thread per state element;
//   3. walk_kernel<OUT=true>: each block re-walks its segment from S_in
//      and writes o (and the last segment the final state).
// Only non-positive exponents cross a chunk or segment boundary (A and
// exp(cum_prev) are at most 1), so segments add no overflow.  Extra bytes
// over one walk: k, v and log_decay read again by pass 1 (3/4 of the
// inputs at fp32) and 3 x 16 KB of state per block through the workspace.
//
// A chunk step (per block, 256 threads): the chunk's r, k, log_decay and v
// rows arrive through a 2-stage cp.async ring of 16-byte copies (the next
// chunk is in flight while this one is computed).  Prefix phase (all
// threads): a thread takes 4 consecutive tokens of a channel; the
// cumulative sum is handed from token group to token group by warp
// shuffles and adds in token order, then each element takes its three
// expf, writing r*exp(cum_prev), qh, kh and r*u*k as fp32 tiles.  Then the
// block splits: threads 128-255 update the state (8 rows x 4 columns each,
// in registers, double-buffered in shared memory) while threads 0-127 form
// the scores (2 x 2 blocks of (t, s) at or below the diagonal, four chains
// a thread) and, after a barrier of their own, the outputs (2 rows x 4
// columns each: 8 FMAs per 16-byte read of the state).  Every sum is an
// fp32 chain in the order of the plain version's matmuls (ascending
// channel, ascending token, the bonus diagonal last): the prefill's logits
// of random-weight rwkv6 move by more than 1e-3 under other orders.  Three
// barriers per chunk step (two in pass 1).  Inputs are read through their
// strides (batch, head, token; channels contiguous), so the model's
// (B, S, H, dk) layout and the kernel layout (BH, S, dk) take the same
// launch without a copy.  No atomics and fixed orders: runs repeat
// bitwise.  No tensor cores: the products run on exp-scaled fp32 operands
// up to e^75, which bf16 would round, and TF32 is off.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLogDecayFloor = -5.0f;
constexpr int kMaxChunk = 32;
constexpr int kDk = 64;        // key channels a block holds (zeros past dk)
constexpr int kCols = 64;      // dv columns a block owns
constexpr int kThreads = 256;
constexpr int kLd = kDk + 4;   // fp32 tiles: 16-byte rows, 2-way banks at most
constexpr int kState = kDk * kCols;

struct Strides {
  int64_t b, h, t;             // elements
};

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* d;
  const float* u;
  void* o;
  float* state;
  float* loc;                  // pass 1: S_loc per block (kState floats)
  float* decay;                // pass 1: exp(sum of totals) per block (kDk)
  float* carry;                // pass 2: S_in per block (kState floats)
  int n_heads, seq, dk, dv, chunk, col_tiles, n_seg, seg_len;
  Strides sr, sk, sv, sd, so;
  int64_t su_b, su_h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// four consecutive elements as fp32 (16 bytes of fp32, 8 of bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

__device__ __forceinline__ void set_zero(float* p) { *p = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16* p) {
  *reinterpret_cast<unsigned short*>(p) = 0;
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 w;
  w.x = *reinterpret_cast<const unsigned int*>(&lo);
  w.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Raw rows in the ring: 64 elements plus 16 bytes, so that 16-byte copies
// stay aligned and the prefix phase's column reads conflict at most 2-way.
template <typename X>
__host__ __device__ constexpr int raw_ld() {
  return kDk + 16 / static_cast<int>(sizeof(X));
}

// Byte offsets of the shared-memory regions for chunk c.
template <typename T, typename D, bool OUT>
struct Layout {
  int stage, r, k, d, v, qh, kh, rq, ruk, att, s0, s1, a, u, logsum, bytes;
  __host__ __device__ explicit Layout(int c) {
    const int lt = raw_ld<T>() * static_cast<int>(sizeof(T));
    const int ld = raw_ld<D>() * static_cast<int>(sizeof(D));
    const int tile = c * kLd * 4;
    r = 0;
    k = r + (OUT ? c * lt : 0);
    d = k + c * lt;
    v = d + c * ld;
    stage = v + c * lt;                        // one ring stage; two follow
    kh = 2 * stage;
    qh = kh + tile;
    rq = qh + (OUT ? tile : 0);
    ruk = rq + (OUT ? tile : 0);
    att = ruk + (OUT ? tile : 0);
    s0 = att + (OUT ? (c * (c + 1) * 4 + 15) / 16 * 16 : 0);
    s1 = s0 + (OUT ? kState * 4 : 0);
    a = s1 + (OUT ? kState * 4 : 0);
    u = a + kDk * 4;
    logsum = u + kDk * 4;
    bytes = logsum + kDk * 4;
  }
};

// One block walks the chunks of one (row, segment, column tile).
// OUT = false: pass 1, from a zero state, writes S_loc and the decay.
// OUT = true: from S_in (or zero), writes o and, in the row's last
// segment, the final state.
template <typename T, typename D, bool OUT>
__global__ void __launch_bounds__(kThreads, 2) walk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<T, D, OUT> L(a.chunk);
  const int tid = threadIdx.x;
  // With OUT, threads 0-127 take the scores and outputs while 128-255
  // update the state; pass 1 updates the state with all 256.
  constexpr int UR = OUT ? 8 : 4;               // state rows a thread
  const bool upd = !OUT || tid >= 128;
  const int ut = OUT ? tid - 128 : tid;
  const int uc = ut & 15, ur = ut >> 4;         // columns 4 uc.., rows UR ur..
  const int seg = blockIdx.x % a.n_seg;
  const int rc = blockIdx.x / a.n_seg;         // row * col_tiles + tile
  const int bh = rc / a.col_tiles;
  const int col0 = (rc % a.col_tiles) * kCols;
  const int ncol = min(kCols, a.dv - col0);
  const int b = bh / a.n_heads, h = bh % a.n_heads;
  const int dk = a.dk, c = a.chunk;
  const int t_begin = seg * a.seg_len;
  const int n_chunks = (min(t_begin + a.seg_len, a.seq) - t_begin) / c;

  const T* r = static_cast<const T*>(a.r) + b * a.sr.b + h * a.sr.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h + col0;
  const D* d = static_cast<const D*>(a.d) + b * a.sd.b + h * a.sd.h;

  float* s_a = reinterpret_cast<float*>(smem + L.a);
  float* s_u = reinterpret_cast<float*>(smem + L.u);
  float* s_logsum = reinterpret_cast<float*>(smem + L.logsum);
  float* s_kh = reinterpret_cast<float*>(smem + L.kh);
  float* s_qh = reinterpret_cast<float*>(smem + L.qh);
  float* s_rq = reinterpret_cast<float*>(smem + L.rq);
  float* s_ruk = reinterpret_cast<float*>(smem + L.ruk);
  float* s_att = reinterpret_cast<float*>(smem + L.att);

  // the chunk's rows into ring stage `st`: 16-byte copies
  auto issue = [&](int chunk_idx, int st) {
    unsigned char* base = smem + st * L.stage;
    const int64_t t0 = t_begin + static_cast<int64_t>(chunk_idx) * c;
    constexpr int VT = 16 / sizeof(T), VD = 16 / sizeof(D);
    const int nk = dk / VT, nd = dk / VD, nv = ncol / VT;
    const int per = (OUT ? 2 * nk : nk) + nd + nv;   // copies per token
    for (int e = tid; e < c * per; e += kThreads) {
      const int t = e / per;
      int x = e % per;
      const int64_t tok = t0 + t;
      if (OUT && x < nk) {
        cp_async16(base + L.r + (t * raw_ld<T>() + x * VT) * sizeof(T),
                   r + tok * a.sr.t + x * VT);
        continue;
      }
      if (OUT) x -= nk;
      if (x < nk) {
        cp_async16(base + L.k + (t * raw_ld<T>() + x * VT) * sizeof(T),
                   k + tok * a.sk.t + x * VT);
      } else if ((x -= nk) < nd) {
        cp_async16(base + L.d + (t * raw_ld<D>() + x * VD) * sizeof(D),
                   d + tok * a.sd.t + x * VD);
      } else {
        x -= nd;
        cp_async16(base + L.v + (t * raw_ld<T>() + x * VT) * sizeof(T),
                   v + tok * a.sv.t + x * VT);
      }
    }
    cp_async_commit();
  };

  if (n_chunks > 0) issue(0, 0);

  // columns of v past ncol: zeros, so that S's unused columns stay finite
  if (ncol < kCols) {
    for (int e = tid; e < 2 * kMaxChunk * kCols; e += kThreads) {
      const int st = e / (kMaxChunk * kCols), rest = e % (kMaxChunk * kCols);
      const int t = rest / kCols, j = rest % kCols;
      if (t < c && j >= ncol)
        set_zero(reinterpret_cast<T*>(smem + st * L.stage + L.v) +
                 t * raw_ld<T>() + j);
    }
  }
  for (int i = tid; i < kDk; i += kThreads) {
    if (OUT) s_u[i] = i < dk ? a.u[b * a.su_b + h * a.su_h + i] : 0.f;
    s_logsum[i] = 0.f;
  }

  // the state: UR x 4 per updating thread in registers, and with OUT a
  // copy in shared memory for the outputs
  const int64_t blk = blockIdx.x;
  float sreg[UR][4];
  const bool from_carry = OUT && seg > 0;
#pragma unroll
  for (int x = 0; x < UR; ++x) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (upd && from_carry)
      s = load4(a.carry + blk * kState + (UR * ur + x) * kCols + 4 * uc);
    sreg[x][0] = s.x;
    sreg[x][1] = s.y;
    sreg[x][2] = s.z;
    sreg[x][3] = s.w;
    if (OUT && upd)
      store4(reinterpret_cast<float*>(smem + L.s0) + (UR * ur + x) * kCols +
                 4 * uc, s);
  }

  // prefix phase geometry: a thread takes 4 consecutive tokens of one
  // channel; the G >= ceil(c / 4) token groups of a channel are adjacent
  // lanes, so the cumulative sum is handed from group to group by shuffles
  // and adds in token order, as a sequential cumulative sum does.
  int G = 1;
  while (4 * G < c) G <<= 1;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp4 = lane & (G - 1);
  const int n_pass = max(1, G / 4);            // channels: 256 / G a pass
  // scores: 2 x 2 blocks of (t, s); outputs: rows 2 orow.., columns 4 oc..
  const int nb = (c + 1) / 2;
  const int oc = tid & 15, orow = tid >> 4;

  for (int n = 0; n < n_chunks; ++n) {
    const int st = n & 1;
    cp_async_wait_all();
    __syncthreads();        // B1: chunk n staged; chunk n-1's readers done
    if (n + 1 < n_chunks) issue(n + 1, st ^ 1);
    const unsigned char* base = smem + st * L.stage;
    const T* sr_ = reinterpret_cast<const T*>(base + L.r);
    const T* sk_ = reinterpret_cast<const T*>(base + L.k);
    const D* sd_ = reinterpret_cast<const D*>(base + L.d);
    const T* sv_ = reinterpret_cast<const T*>(base + L.v);

    // prefix phase
    for (int pass = 0; pass < n_pass; ++pass) {
      const int ch = pass * (kThreads / G) + warp * (32 / G) + lane / G;
      const bool okc = ch < dk;
      float dd[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int t = 4 * grp4 + x;
        dd[x] = okc && t < c ? fminf(fmaxf(to_f32(sd_[t * raw_ld<D>() + ch]),
                                           kLogDecayFloor), 0.f)
                             : 0.f;
      }
      float start = 0.f;                       // cum before this group
      for (int g = 1; g < G; ++g) {
        float end = start;
#pragma unroll
        for (int x = 0; x < 4; ++x) end += dd[x];
        const float from = __shfl_up_sync(0xffffffffu, end, 1, G);
        if (grp4 == g) start = from;
      }
      float cum[4];
      float run = start;
#pragma unroll
      for (int x = 0; x < 4; ++x) cum[x] = run += dd[x];
      const int last = (c - 1) & 3;
      const float mine = last == 0 ? cum[0] : last == 1 ? cum[1]
                       : last == 2 ? cum[2] : cum[3];
      const float total = __shfl_sync(0xffffffffu, mine, (c - 1) >> 2, G);
      if (ch < kDk) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int t = 4 * grp4 + x;
          if (t >= c) break;
          const float kk = okc ? to_f32(sk_[t * raw_ld<T>() + ch]) : 0.f;
          s_kh[t * kLd + ch] = kk * expf(total - cum[x]);
          if (OUT) {
            const float rr = okc ? to_f32(sr_[t * raw_ld<T>() + ch]) : 0.f;
            const float cum_prev = cum[x] - dd[x];
            s_qh[t * kLd + ch] = rr * expf(cum_prev - total);
            s_rq[t * kLd + ch] = rr * expf(cum_prev);
            s_ruk[t * kLd + ch] = rr * s_u[ch] * kk;
          }
        }
        if (grp4 == 0) {
          s_a[ch] = expf(total);
          s_logsum[ch] += total;
        }
      }
    }
    __syncthreads();        // B2: derived tiles and decay ready

    if (OUT && !upd) {
      // Scores and outputs as fp32 chains in the plain matmuls' order
      // (ascending channel, then ascending token, the bonus diagonal last):
      // random-weight rwkv6 logits move by more than 1e-3 under other
      // orders of these sums.  Scores: 2 x 2 blocks of (t, s) at or below
      // the diagonal, four independent chains a thread; never an upper
      // entry, and r*u*k summed on the diagonal.
      for (int e = tid; e < nb * nb; e += 128) {
        const int bt = e / nb, bs = e % nb;
        if (bs > bt) continue;
        const int t0 = 2 * bt, s0 = 2 * bs;
        float p00 = 0.f, p01 = 0.f, p10 = 0.f, p11 = 0.f;
#pragma unroll 4
        for (int i = 0; i < kDk; i += 4) {
          const float4 q1 = load4(s_qh + (t0 + 1) * kLd + i);
          const float4 k0 = load4(s_kh + s0 * kLd + i);
          if (bs < bt) {
            const float4 q0 = load4(s_qh + t0 * kLd + i);
            const float4 k1 = load4(s_kh + (s0 + 1) * kLd + i);
            p00 = fmaf(q0.w, k0.w, fmaf(q0.z, k0.z,
                  fmaf(q0.y, k0.y, fmaf(q0.x, k0.x, p00))));
            p01 = fmaf(q0.w, k1.w, fmaf(q0.z, k1.z,
                  fmaf(q0.y, k1.y, fmaf(q0.x, k1.x, p01))));
            p11 = fmaf(q1.w, k1.w, fmaf(q1.z, k1.z,
                  fmaf(q1.y, k1.y, fmaf(q1.x, k1.x, p11))));
          } else {
            const float4 d0 = load4(s_ruk + t0 * kLd + i);
            const float4 d1 = load4(s_ruk + (t0 + 1) * kLd + i);
            p00 = (((p00 + d0.x) + d0.y) + d0.z) + d0.w;
            p11 = (((p11 + d1.x) + d1.y) + d1.z) + d1.w;
          }
          p10 = fmaf(q1.w, k0.w, fmaf(q1.z, k0.z,
                fmaf(q1.y, k0.y, fmaf(q1.x, k0.x, p10))));
        }
        const float pv[2][2] = {{p00, p01}, {p10, p11}};
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int y = 0; y < 2; ++y) {
            const int t = t0 + x, s = s0 + y;
            if (t < c && s <= t) s_att[t * (c + 1) + s] = pv[x][y];
          }
      }
      asm volatile("bar.sync 1, 128;\n" ::: "memory");  // B3: scores

      // outputs: rows 2 orow + x (+ 16 m), columns 4 oc..4 oc + 3
      const float* scur =
          reinterpret_cast<const float*>(smem + (n & 1 ? L.s1 : L.s0));
      T* o = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h + col0 + 4 * oc;
      for (int m = 0; 16 * m + 2 * orow < c; ++m) {
        const int t_lo = 16 * m + 2 * orow;
        float inter[2][4], intra[2][4];
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) inter[x][y] = intra[x][y] = 0.f;
#pragma unroll 2
        for (int i = 0; i < kDk; i += 4) {
          const float4 w0 = load4(s_rq + t_lo * kLd + i);
          const float4 w1 = load4(s_rq + (t_lo + 1) * kLd + i);
#pragma unroll
          for (int z = 0; z < 4; ++z) {
            const float4 sv = load4(scur + (i + z) * kCols + 4 * oc);
            const float ws[2] = {z == 0 ? w0.x : z == 1 ? w0.y
                                 : z == 2 ? w0.z : w0.w,
                                 z == 0 ? w1.x : z == 1 ? w1.y
                                 : z == 2 ? w1.z : w1.w};
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              inter[x][0] = fmaf(ws[x], sv.x, inter[x][0]);
              inter[x][1] = fmaf(ws[x], sv.y, inter[x][1]);
              inter[x][2] = fmaf(ws[x], sv.z, inter[x][2]);
              inter[x][3] = fmaf(ws[x], sv.w, inter[x][3]);
            }
          }
        }
        for (int s = 0; s <= min(t_lo + 1, c - 1); ++s) {
          const float4 vv = load4(sv_ + s * raw_ld<T>() + 4 * oc);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int t = t_lo + x;
            if (t >= c || s > t) continue;
            const float w = s_att[t * (c + 1) + s];
            intra[x][0] = fmaf(w, vv.x, intra[x][0]);
            intra[x][1] = fmaf(w, vv.y, intra[x][1]);
            intra[x][2] = fmaf(w, vv.z, intra[x][2]);
            intra[x][3] = fmaf(w, vv.w, intra[x][3]);
          }
        }
        if (4 * oc < ncol) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int t = t_lo + x;
            if (t >= c) continue;
            store4(o + (t_begin + static_cast<int64_t>(n) * c + t) * a.so.t,
                   make_float4(inter[x][0] + intra[x][0],
                               inter[x][1] + intra[x][1],
                               inter[x][2] + intra[x][2],
                               inter[x][3] + intra[x][3]));
          }
        }
      }
    }

    if (upd) {
      // S <- exp(total) (.) S + kh^T v, this thread's UR x 4 block
      float acc[UR][4];
#pragma unroll
      for (int x = 0; x < UR; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
      for (int t = 0; t < c; ++t) {
        const float4 vv = load4(sv_ + t * raw_ld<T>() + 4 * uc);
        const float vs[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int x4 = 0; x4 < UR; x4 += 4) {
          const float4 kk = load4(s_kh + t * kLd + UR * ur + x4);
          const float ks[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int y = 0; y < 4; ++y)
              acc[x4 + x][y] = fmaf(ks[x], vs[y], acc[x4 + x][y]);
        }
      }
      float* snext = reinterpret_cast<float*>(smem + (n & 1 ? L.s0 : L.s1));
#pragma unroll
      for (int x = 0; x < UR; ++x) {
        const float dec = s_a[UR * ur + x];
#pragma unroll
        for (int y = 0; y < 4; ++y)
          sreg[x][y] = fmaf(dec, sreg[x][y], acc[x][y]);
        if (OUT)
          store4(snext + (UR * ur + x) * kCols + 4 * uc,
                 make_float4(sreg[x][0], sreg[x][1], sreg[x][2], sreg[x][3]));
      }
    }
  }
  cp_async_wait_all();

  if (!OUT) {
#pragma unroll
    for (int x = 0; x < UR; ++x)
      store4(a.loc + blk * kState + (UR * ur + x) * kCols + 4 * uc,
             make_float4(sreg[x][0], sreg[x][1], sreg[x][2], sreg[x][3]));
    __syncthreads();        // s_logsum's last additions
    for (int i = tid; i < kDk; i += kThreads)
      a.decay[blk * kDk + i] = expf(s_logsum[i]);
  } else if (upd && seg == a.n_seg - 1) {
    float* st = a.state + static_cast<int64_t>(bh) * dk * a.dv + col0;
#pragma unroll
    for (int x = 0; x < UR; ++x) {
      const int i = UR * ur + x;
      if (i >= dk) continue;
#pragma unroll
      for (int y = 0; y < 4; ++y)
        if (4 * uc + y < ncol)
          st[static_cast<int64_t>(i) * a.dv + 4 * uc + y] = sreg[x][y];
    }
  }
}

// Pass 2: per (row, column tile) and state element, in segment order,
// S_in[0] = 0 and S_in[s] = A[s-1] (.) S_in[s-1] + S_loc[s-1].
__global__ void __launch_bounds__(kThreads) carry_kernel(const Args a,
                                                         int64_t n) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) return;
  const int64_t rc = e / kState;
  const int ij = static_cast<int>(e % kState);
  const int64_t first = rc * a.n_seg;
  const float* __restrict__ loc = a.loc + first * kState + ij;
  const float* __restrict__ dec = a.decay + first * kDk + ij / kCols;
  float* __restrict__ out = a.carry + first * kState + ij;
  float carry = 0.f;
#pragma unroll 4
  for (int s = 0; s < a.n_seg; ++s) {
    out[s * kState] = carry;
    carry = fmaf(dec[s * kDk], carry, loc[s * kState]);
  }
}

template <typename K>
int set_smem(K kern, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T, typename D>
int launch(const Args& a, int n_rows, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(n_rows) * a.col_tiles;
  const int64_t blocks = rows * a.n_seg;
  if (blocks >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  if (a.n_seg > 1) {
    auto walk = walk_kernel<T, D, false>;
    const int smem = Layout<T, D, false>(a.chunk).bytes;
    int err = set_smem(walk, smem);
    if (err) return err;
    walk<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
    const int64_t n = rows * kState;
    carry_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                   kThreads, 0, stream>>>(a, n);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  auto walk = walk_kernel<T, D, true>;
  const int smem = Layout<T, D, true>(a.chunk).bytes;
  const int err = set_smem(walk, smem);
  if (err) return err;
  walk<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, log_decay: (n_rows, seq, dk) rows of n_heads heads each, element
// (row b * n_heads + h, token t, channel i) at base + b*s_b + h*s_h +
// t*s_t + i (strides in elements, channels contiguous); v and o the same
// with dv channels; u: fp32, (b, h) at u + b*u_sb + h*u_sh; state: fp32
// contiguous (n_rows, dk, dv).  dtype 0/1: r, k, v and o fp32/bf16;
// d_dtype 0/1: log_decay fp32/bf16.  1 <= chunk <= 32, seq % chunk == 0,
// 1 <= dk <= 64; every row of r, k, v, log_decay and o starts 16-byte
// aligned and dk, dv fill whole 16-byte vectors.  n_seg segments of
// seg_len tokens (a multiple of chunk) per row; with n_seg > 1, ws is an
// fp32 workspace of n_rows * ceil(dv / 64) * n_seg * (2 * 64 * 64 + 64)
// floats (the Python wrapper checks all of it and allocates ws).  Returns
// cudaGetLastError() after the last launch.
extern "C" int rwkv6_scan(
    const void* r, const void* k, const void* v, const void* d,
    const void* u, void* o, void* state, void* ws, int dtype, int d_dtype,
    int n_rows, int n_heads, int seq, int dk, int dv, int chunk, int n_seg,
    int seg_len, int64_t r_sb, int64_t r_sh, int64_t r_st, int64_t k_sb,
    int64_t k_sh, int64_t k_st, int64_t v_sb, int64_t v_sh, int64_t v_st,
    int64_t d_sb, int64_t d_sh, int64_t d_st, int64_t o_sb, int64_t o_sh,
    int64_t o_st, int64_t u_sb, int64_t u_sh, void* stream) {
  if (n_rows == 0 || dv == 0) return 0;
  if (chunk < 1 || chunk > kMaxChunk || seq < 1 || seq % chunk ||
      dk < 1 || dk > kDk || dv < 1 || n_heads < 1 || n_seg < 1 ||
      seg_len < chunk || seg_len % chunk ||
      static_cast<int64_t>(n_seg - 1) * seg_len >= seq ||
      static_cast<int64_t>(n_seg) * seg_len < seq || (n_seg > 1 && !ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const int col_tiles = (dv + kCols - 1) / kCols;
  const int64_t blocks = static_cast<int64_t>(n_rows) * col_tiles * n_seg;
  float* w = static_cast<float*>(ws);
  const Args a{r, k, v, d, static_cast<const float*>(u), o,
               static_cast<float*>(state), w,
               w ? w + blocks * kState : nullptr,
               w ? w + blocks * (kState + kDk) : nullptr,
               n_heads, seq, dk, dv, chunk, col_tiles, n_seg, seg_len,
               {r_sb, r_sh, r_st}, {k_sb, k_sh, k_st}, {v_sb, v_sh, v_st},
               {d_sb, d_sh, d_st}, {o_sb, o_sh, o_st}, u_sb, u_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d_dtype == 0) return launch<float, float>(a, n_rows, s);
  if (dtype == 0 && d_dtype == 1)
    return launch<float, __nv_bfloat16>(a, n_rows, s);
  if (dtype == 1 && d_dtype == 0)
    return launch<__nv_bfloat16, float>(a, n_rows, s);
  if (dtype == 1 && d_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, n_rows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
