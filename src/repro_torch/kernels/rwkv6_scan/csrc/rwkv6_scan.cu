// Chunked RWKV-6 WKV scan for Hopper (sm_90a).
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
// are 0.50 and 0.40 ms.
//
// Design.  One block of 256 threads per (row bh, tile of 16 state columns
// of dv): the dv columns of S evolve independently given r, k and the
// decay, so the split is exact and gives 4x the blocks at dv = 64 (160 at
// batch 1, where there are only 40 heads).  The block walks its row's
// chunks in order, with its 64 x 16 slice of S in shared memory.  Per
// chunk: the r, k, decay tiles (c x dk) and the block's v columns are
// staged in shared memory as fp32 (the next chunk's tiles are loaded into
// registers while this one is computed); 64 threads, one per key channel,
// take the cumulative sum and rewrite the tiles in place into
// r*exp(cum_prev), kh and qh while c others form the bonus diagonal; the
// strictly-lower scores, the outputs (inter + intra) and the state update
// are SIMT FMAs, each thread owning whole dot products.  The four column
// blocks of a row are adjacent in the grid, so they read the row's r, k
// and decay tiles while those are in L2.  Inputs are read through their
// strides (batch, head, token; channels contiguous), so the model's
// (B, S, H, dk) layout and the kernel layout (BH, S, dk) take the same
// launch without a copy.  No atomics: runs repeat bitwise.  wgmma, TMA
// and a parallel scan over chunks are not used here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLogDecayFloor = -5.0f;
constexpr int kMaxChunk = 32;
constexpr int kMaxDk = 64;
constexpr int kCols = 16;                                // dv columns a block
constexpr int kThreads = 256;
constexpr int kPad = kMaxDk + 1;                         // no bank conflicts
constexpr int kPerThread = kMaxChunk * kMaxDk / kThreads;  // staged r/k/d
constexpr int kPerThreadV = kMaxChunk * kCols / kThreads;  // staged v

struct Strides {
  int64_t b, h, t;                                       // elements
};

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* d;
  const float* u;
  void* o;
  float* state;
  int n_heads, seq, dk, dv, chunk, col_tiles;
  Strides sr, sk, sv, sd, so;
  int64_t su_b, su_h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// T: r, k, v and o (float or bf16); D: log_decay (float or bf16).
template <typename T, typename D>
__global__ void __launch_bounds__(kThreads) wkv_kernel(const Args a) {
  __shared__ float s_r[kMaxChunk][kPad];   // r, then r * exp(cum_prev)
  __shared__ float s_k[kMaxChunk][kPad];   // k, then kh
  __shared__ float s_q[kMaxChunk][kPad];   // clipped decay, then qh
  __shared__ float s_v[kMaxChunk][kCols];
  __shared__ float s_att[kMaxChunk][kMaxChunk + 1];
  __shared__ float s_state[kMaxDk][kCols];
  __shared__ float s_u[kMaxDk];
  __shared__ float s_total[kMaxDk];        // total, then exp(total)
  __shared__ float s_diag[kMaxChunk];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / a.col_tiles;
  const int col0 = (blockIdx.x % a.col_tiles) * kCols;
  const int ncol = min(kCols, a.dv - col0);
  const int b = bh / a.n_heads, h = bh % a.n_heads;
  const int dk = a.dk, c = a.chunk;

  const T* r = static_cast<const T*>(a.r) + b * a.sr.b + h * a.sr.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h + col0;
  const D* d = static_cast<const D*>(a.d) + b * a.sd.b + h * a.sd.h;
  T* o = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h + col0;
  const float* u = a.u + b * a.su_b + h * a.su_h;

  for (int i = tid; i < dk; i += kThreads) s_u[i] = u[i];
  for (int e = tid; e < kMaxDk * kCols; e += kThreads)
    s_state[e / kCols][e % kCols] = 0.f;

  // the next chunk's tiles, held in registers while this one is computed
  float pr[kPerThread], pk[kPerThread], pd[kPerThread], pv[kPerThreadV];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int e = tid + q * kThreads;
      if (e < c * dk) {
        const int64_t t = t0 + e / dk;
        const int i = e % dk;
        pr[q] = to_f32(r[t * a.sr.t + i]);
        pk[q] = to_f32(k[t * a.sk.t + i]);
        pd[q] = to_f32(d[t * a.sd.t + i]);
      }
    }
#pragma unroll
    for (int q = 0; q < kPerThreadV; ++q) {
      const int e = tid + q * kThreads;
      if (e < c * kCols) {
        const int j = e % kCols;
        pv[q] = j < ncol ? to_f32(v[(t0 + e / kCols) * a.sv.t + j]) : 0.f;
      }
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < a.seq; t0 += c) {
    // stage the chunk in shared memory
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int e = tid + q * kThreads;
      if (e < c * dk) {
        const int t = e / dk, i = e % dk;
        s_r[t][i] = pr[q];
        s_k[t][i] = pk[q];
        s_q[t][i] = fminf(fmaxf(pd[q], kLogDecayFloor), 0.f);
      }
    }
#pragma unroll
    for (int q = 0; q < kPerThreadV; ++q) {
      const int e = tid + q * kThreads;
      if (e < c * kCols) s_v[e / kCols][e % kCols] = pv[q];
    }
    __syncthreads();
    if (t0 + c < a.seq) fetch(t0 + c);

    // per-channel totals; the bonus diagonal sum_i r*u*k on c other threads
    if (tid < dk) {
      float cum = 0.f;
      for (int t = 0; t < c; ++t) cum += s_q[t][tid];
      s_total[tid] = cum;
    } else if (tid - dk < c) {
      const int t = tid - dk;
      float acc = 0.f;
      for (int i = 0; i < dk; ++i)
        acc = fmaf(s_r[t][i] * s_u[i], s_k[t][i], acc);
      s_diag[t] = acc;
    }
    __syncthreads();

    // channel i rewritten in place: r*exp(cum_prev), kh, qh
    if (tid < dk) {
      const int i = tid;
      const float total = s_total[i];
      float cum = 0.f;
      for (int t = 0; t < c; ++t) {
        const float dt = s_q[t][i];
        cum += dt;
        const float cum_prev = cum - dt;
        const float rt = s_r[t][i];
        s_q[t][i] = rt * expf(cum_prev - total);
        s_k[t][i] = s_k[t][i] * expf(total - cum);
        s_r[t][i] = rt * expf(cum_prev);
      }
      s_total[i] = expf(total);
    }
    __syncthreads();

    // strictly-lower scores qh[t] . kh[s], s < t; the rest never formed
    for (int e = tid; e < c * c; e += kThreads) {
      const int t = e / c, s = e % c;
      if (s < t) {
        float acc = 0.f;
        for (int i = 0; i < dk; ++i) acc = fmaf(s_q[t][i], s_k[s][i], acc);
        s_att[t][s] = acc;
      }
    }
    __syncthreads();

    // outputs: inter (from the state before the chunk) + intra
    for (int e = tid; e < c * kCols; e += kThreads) {
      const int t = e / kCols, j = e % kCols;
      float inter = 0.f;
      for (int i = 0; i < dk; ++i)
        inter = fmaf(s_r[t][i], s_state[i][j], inter);
      float intra = 0.f;
      for (int s = 0; s < t; ++s) intra = fmaf(s_att[t][s], s_v[s][j], intra);
      intra = fmaf(s_diag[t], s_v[t][j], intra);
      if (j < ncol)
        o[static_cast<int64_t>(t0 + t) * a.so.t + j] =
            from_f32<T>(inter + intra);
    }
    __syncthreads();

    // S <- exp(total) (.) S + kh^T v
    for (int e = tid; e < dk * kCols; e += kThreads) {
      const int i = e / kCols, j = e % kCols;
      float acc = 0.f;
      for (int t = 0; t < c; ++t) acc = fmaf(s_k[t][i], s_v[t][j], acc);
      s_state[i][j] = fmaf(s_total[i], s_state[i][j], acc);
    }
    __syncthreads();
  }

  float* st = a.state + static_cast<int64_t>(bh) * dk * a.dv + col0;
  for (int e = tid; e < dk * kCols; e += kThreads) {
    const int i = e / kCols, j = e % kCols;
    if (j < ncol) st[static_cast<int64_t>(i) * a.dv + j] = s_state[i][j];
  }
}

template <typename T, typename D>
int launch(const Args& a, int n_rows, cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(n_rows) * a.col_tiles;
  if (blocks >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  wkv_kernel<T, D><<<static_cast<unsigned int>(blocks), kThreads, 0,
                     stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, log_decay: (n_rows, seq, dk) rows of n_heads heads each, element
// (row b * n_heads + h, token t, channel i) at base + b*s_b + h*s_h +
// t*s_t + i (strides in elements, channels contiguous); v and o the same
// with dv channels; u: fp32, (b, h) at u + b*u_sb + h*u_sh; state: fp32
// contiguous (n_rows, dk, dv).  dtype 0/1: r, k, v and o fp32/bf16;
// d_dtype 0/1: log_decay fp32/bf16.  1 <= chunk <= 32, seq % chunk == 0,
// 1 <= dk <= 64 (the Python wrapper checks all of it).  Returns
// cudaGetLastError() after the launch.
extern "C" int rwkv6_scan(
    const void* r, const void* k, const void* v, const void* d,
    const void* u, void* o, void* state, int dtype, int d_dtype, int n_rows,
    int n_heads, int seq, int dk, int dv, int chunk, int64_t r_sb,
    int64_t r_sh, int64_t r_st, int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st, int64_t d_sb, int64_t d_sh,
    int64_t d_st, int64_t o_sb, int64_t o_sh, int64_t o_st, int64_t u_sb,
    int64_t u_sh, void* stream) {
  if (n_rows == 0 || dv == 0) return 0;
  if (chunk < 1 || chunk > kMaxChunk || seq < 1 || seq % chunk ||
      dk < 1 || dk > kMaxDk || dv < 1 || n_heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{r, k, v, d, static_cast<const float*>(u), o,
               static_cast<float*>(state), n_heads, seq, dk, dv, chunk,
               (dv + kCols - 1) / kCols,
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
