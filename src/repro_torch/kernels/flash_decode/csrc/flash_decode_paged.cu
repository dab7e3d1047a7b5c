// Paged flash decode for Hopper (sm_90a): one query token per sequence
// against a KV cache held in a shared page pool.
//
// Replaces: src/repro/kernels/flash_decode/kernel.py::flash_decode_paged
// (Pallas body _paged_decode_kernel), the attention of the serving
// engine's decode step (models/transformer.py::decode_step_paged), and
// kernel.py::flash_decode (body _decode_kernel), the dense decode over a
// contiguous cache.  The two Pallas bodies are the same online-softmax
// combine and differ only in how a program finds its K/V rows, so this
// one source serves both: a dense cache (B, S, Hkv, hd) is a pool of B
// pages of (S // blk_k) * blk_k tokens behind the table [[0], [1], ...],
// read through the cache's own strides (ops.py::decode_attention and
// ::flash_decode).  The page size also reproduces the dense kernel's
// contract that positions at or past (S // blk_k) * blk_k are never read.
//
// For sequence b and query head h (KV head h / n_rep, as _repeat_kv lays
// out grouped-query attention), with K and V read through page_table[b]:
//     o[b, h] = softmax(q[b, h] . K^T * scale, masked to positions
//               < valid[b, h]) . V,           scale = 1/sqrt(head_dim)
// accumulated in fp32, written in q's dtype (fp32 or bf16).  The scale
// multiplies the finished dot product, as at kernel.py:92-93.  The sum
// of the softmax weights is floored at 1e-30, so a head with valid
// length 0 gets zeros, as the TPU kernel gives.
//
// Bound on this card: memory.  A call must read K and V of the valid
// tokens once per KV head (2 * valid * head_dim * elem bytes per
// (sequence, KV head)), q once and write o once; it does about
// 4 * n_rep * head_dim flops per token and KV head, far below what would
// make the ALUs the limit.  At the serving shape of qwen3-1.7b (8
// sequences of ~150 tokens, 8 KV heads of 128, fp32) that is ~10 MB,
// ~3 us at 3.35 TB/s, so there the launch itself costs more than the
// bytes; at 8 x 4,096 tokens it is ~270 MB, ~80 us.
//
// Design.  One block per (sequence, KV head) holds the n_rep query
// vectors of that group in registers, so each K/V byte is read once per
// group (the Pallas grid reads each page once per query head).  The
// block reads its own valid lengths and page ids (no scalar prefetch)
// and walks only the tokens below the group's largest valid length, so
// no page at or past ceil(valid / page_size), and no table entry there,
// is ever read: the trash page 0 behind unallocated entries and pages
// the sequence does not own cannot reach the output.  Its 8 warps take
// 4 tokens at a time each, loading the 4 K and V rows before using them
// (16-byte loads where head_dim allows: a lane holds head_dim/32
// elements of a row), take each dot product as per-lane partial sums
// and a butterfly of warp shuffles, and keep a partial online softmax
// (m, l, acc) per query head.  At the end the warps' partials merge in
// shared memory in a fixed order.  No atomics, so runs repeat bitwise.
// Pools are read through their strides (page, token, KV head; head_dim
// contiguous), so the model's (P, ps, Hkv, hd) layer view and the TPU
// kernel's (Hkv, P, ps, hd) layout take the same launch without a copy.
// Splitting one long sequence over several blocks (flash-decoding), TMA
// and cp.async rings are not used here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;          // tokens per warp per iteration
constexpr float kNegInf = -1e30f;   // the reference's masked score

template <int N>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
      x[4 * i] = v.x;
      x[4 * i + 1] = v.y;
      x[4 * i + 2] = v.z;
      x[4 * i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = v.x;
    x[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = __ldg(p + i);
  }
}

__device__ __forceinline__ void bf16x2_to(unsigned int w, float* x) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w);
  const float2 f = __bfloat1622float2(h);
  x[0] = f.x;
  x[1] = f.y;
}

template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p,
                                         float (&x)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      bf16x2_to(v.x, x + 8 * i);
      bf16x2_to(v.y, x + 8 * i + 2);
      bf16x2_to(v.z, x + 8 * i + 4);
      bf16x2_to(v.w, x + 8 * i + 6);
    }
  } else if constexpr (N == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    bf16x2_to(v.x, x);
    bf16x2_to(v.y, x + 2);
  } else if constexpr (N == 2) {
    bf16x2_to(__ldg(reinterpret_cast<const unsigned int*>(p)), x);
  } else {
    x[0] = __bfloat162float(p[0]);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* page_table;     // (batch, max_pages) int32, contiguous
  const int* valid;          // valid[b * v_sb + h * v_sh]
  void* out;
  int head_dim, n_rep, batch, n_kv_heads, max_pages, page_size;
  int64_t q_sb, q_sh;        // q element (b, h, 0)
  int64_t p_sp, p_st, p_sh;  // pool element (page, token, kv head, 0)
  int64_t o_sb, o_sh;        // out element (b, h, 0)
  int64_t v_sb, v_sh;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD, int NREP>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ pt,
                    const int* __restrict__ valid, T* __restrict__ out,
                    int n_kv_heads, int max_pages, int page_size,
                    int64_t q_sb, int64_t q_sh, int64_t p_sp, int64_t p_st,
                    int64_t p_sh, int64_t o_sb, int64_t o_sh, int64_t v_sb,
                    int64_t v_sh, float scale) {
  constexpr int EPT = HD / 32;      // elements of a row per lane
  extern __shared__ float smem[];
  float* sm_m = smem;                         // [kWarps][NREP]
  float* sm_l = sm_m + kWarps * NREP;         // [kWarps][NREP]
  float* sm_acc = sm_l + kWarps * NREP;       // [kWarps][NREP][HD]

  const int b = blockIdx.x / n_kv_heads;
  const int g = blockIdx.x % n_kv_heads;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cap = max_pages * page_size;

  int vlen[NREP];
  int tmax = 0;
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    const int h = g * NREP + r;
    int v = valid[b * v_sb + h * v_sh];
    v = min(max(v, 0), cap);
    vlen[r] = v;
    tmax = max(tmax, v);
  }

  float qr[NREP][EPT], acc[NREP][EPT], m[NREP], l[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    load_row<EPT>(q + b * q_sb + (g * NREP + r) * q_sh + lane * EPT, qr[r]);
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < EPT; ++i) acc[r][i] = 0.f;
  }

  const int* row = pt + static_cast<int64_t>(b) * max_pages;
  const int64_t head_off = g * p_sh + lane * EPT;
  for (int t0 = warp * kUnroll; t0 < tmax; t0 += kWarps * kUnroll) {
    float kx[kUnroll][EPT], vx[kUnroll][EPT];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < tmax) {
        const int page = __ldg(row + t / page_size);
        const int64_t off = page * p_sp + (t % page_size) * p_st + head_off;
        load_row<EPT>(kp + off, kx[u]);
        load_row<EPT>(vp + off, vx[u]);
      } else {
#pragma unroll
        for (int i = 0; i < EPT; ++i) kx[u][i] = vx[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float s[kUnroll];
      bool ok[kUnroll];
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < EPT; ++i) d = fmaf(qr[r][i], kx[u][i], d);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[u] = d * scale;
        ok[u] = t0 + u < vlen[r];
        if (ok[u]) mx = fmaxf(mx, s[u]);
      }
      const float corr = expf(m[r] - mx);
      float p[kUnroll], psum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = ok[u] ? expf(s[u] - mx) : 0.f;
        psum += p[u];
      }
      l[r] = l[r] * corr + psum;
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        float a = acc[r][i] * corr;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          a = ok[u] ? fmaf(p[u], vx[u][i], a) : a;   // masked rows never mix in
        acc[r][i] = a;
      }
      m[r] = mx;
    }
  }

#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    if (lane == 0) {
      sm_m[warp * NREP + r] = m[r];
      sm_l[warp * NREP + r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < EPT; ++i)
      sm_acc[(warp * NREP + r) * HD + lane * EPT + i] = acc[r][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < NREP * HD; idx += blockDim.x) {
    const int r = idx / HD;
    const int e = idx % HD;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w * NREP + r]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w * NREP + r] - mm);
      ll += sm_l[w * NREP + r] * c;
      aa += sm_acc[(w * NREP + r) * HD + e] * c;
    }
    store(out + b * o_sb + (g * NREP + r) * o_sh + e, aa / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int HD, int NREP>
int launch(const Args& a) {
  auto kern = paged_decode_kernel<T, HD, NREP>;
  const int smem = kWarps * NREP * (HD + 2) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<a.batch * a.n_kv_heads, kWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), a.page_table, a.valid,
      static_cast<T*>(a.out), a.n_kv_heads, a.max_pages, a.page_size, a.q_sb,
      a.q_sh, a.p_sp, a.p_st, a.p_sh, a.o_sb, a.o_sh, a.v_sb, a.v_sh,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int by_rep(const Args& a) {
  switch (a.n_rep) {
    case 1: return launch<T, HD, 1>(a);
    case 2: return launch<T, HD, 2>(a);
    case 4: return launch<T, HD, 4>(a);
    case 8: return launch<T, HD, 8>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int by_head_dim(const Args& a) {
  switch (a.head_dim) {
    case 32: return by_rep<T, 32>(a);
    case 64: return by_rep<T, 64>(a);
    case 128: return by_rep<T, 128>(a);
    case 256: return by_rep<T, 256>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (q, both pools and out share it).
// head_dim in {32, 64, 128, 256}; n_rep in {1, 2, 4, 8}.  Strides are in
// elements; head_dim is contiguous everywhere, every row start is aligned
// to head_dim/32 elements and page ids lie in [0, pages of the pool) (the
// Python wrapper checks all but the last, which the engine's allocator
// guarantees).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unsupported dtype, head_dim or n_rep.
extern "C" int flash_decode_paged(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* valid, void* out, int dtype,
    int head_dim, int n_rep, int batch, int n_kv_heads, int max_pages,
    int page_size, int64_t q_sb, int64_t q_sh, int64_t p_sp, int64_t p_st,
    int64_t p_sh, int64_t o_sb, int64_t o_sh, int64_t v_sb, int64_t v_sh,
    float scale, void* stream) {
  if (batch == 0 || n_kv_heads == 0) return 0;
  const Args a{q, k_pool, v_pool, static_cast<const int*>(page_table),
               static_cast<const int*>(valid), out, head_dim, n_rep, batch,
               n_kv_heads, max_pages, page_size, q_sb, q_sh, p_sp, p_st, p_sh,
               o_sb, o_sh, v_sb, v_sh, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return by_head_dim<float>(a);
  if (dtype == 1) return by_head_dim<__nv_bfloat16>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
