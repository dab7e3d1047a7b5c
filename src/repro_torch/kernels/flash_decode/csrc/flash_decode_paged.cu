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
// 4 * n_rep * head_dim flops per token and KV head (~n_rep flops per
// byte in bf16), far below the ~295 flops per byte at which the tensor
// cores would matter, so it stays on CUDA cores.  At decode_32k (8
// caches of up to 32,768 positions, 8 KV heads of 128) that is ~1 GB in
// fp32, ~0.3 ms at 3.35 TB/s; at the serving shape of qwen3-1.7b (8
// sequences of ~150 tokens) ~10 MB, ~3 us, where the launches cost more
// than the bytes.
//
// Design (flash-decoding).
// * Split-KV.  The grid is one block per (sequence, KV head, split); a
//   split is a fixed span of `span` tokens, a multiple of the ring tile
//   (ops.py::_plan_splits works it out on the host from the batch, the
//   KV heads, the table's capacity and the SM count, never from the
//   valid lengths, which live on the card).  A block reads its group's
//   valid lengths itself; one whose span starts at or past the group's
//   longest valid length exits before it touches the table, so no page
//   at or past ceil(valid / page_size), and no table entry there, is
//   ever read: the trash page 0 behind unallocated entries and pages the
//   sequence does not own cannot reach the output.
// * 16-byte rows.  A thread owns 16 bytes of a row (4 fp32 or 8 bf16
//   elements; two such chunks for fp32 at head_dim 256), so a row takes
//   head_dim * elem / 16 lanes (at most 32; rounded up to a power of two,
//   so at head_dim 80 a row's 20 fp32 / 10 bf16 chunks take 32 / 16 lanes
//   and the rest hold zeros) and a warp-wide step covers 32 / that many
//   tokens; each dot product reduces over only those lanes (4 shuffle
//   steps for bf16 at head_dim 128, one per two tokens).
// * Loads in flight.  K and V tiles of TILE tokens (16 KB a stage for K
//   and V together, 32 KB for fp32 at head_dim 256) pass through a ring
//   of kStages stages in shared memory, filled with cp.async.cg 16-byte
//   copies, so the next two tiles' bytes are on their way while one is
//   computed.  Each of the kWarps warps takes kSteps steps of a tile.
// * Online softmax.  Per step a warp takes the scores of its kSteps
//   tokens, their maximum, one rescale exp per query head and one expf
//   per token and query head (as the Pallas kernel); tiles that lie
//   wholly below every head's valid length skip the masks.
// * Combine.  Each block merges its warps' and lane groups' (m, l, acc)
//   in a fixed order.  With one split it writes o itself; with more it
//   writes its partial (m, l, acc[hd]) per query head to an fp32
//   workspace that the wrapper allocates, and a second kernel, enqueued
//   on the same stream, merges the working splits in split order 0, 1,
//   ... (the splits past the group's longest valid length are not read)
//   and writes o.  It is a programmatic dependent launch: scheduled once
//   every split block has started, it reads its valid lengths, then waits
//   (griddepcontrol.wait) for the split kernel to finish and its writes
//   to be visible.  No atomics and no arrival order, so runs repeat
//   bitwise.
// Pools are read through their strides (page, token, KV head; head_dim
// contiguous, every row start 16-byte aligned), so the model's
// (P, ps, Hkv, hd) layer view and the TPU kernel's (Hkv, P, ps, hd)
// layout take the same launch without a copy.  TMA is not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSteps = 4;           // warp-wide steps per warp per tile
constexpr int kStages = 3;          // ring depth
constexpr float kNegInf = -1e30f;   // the reference's masked score

__host__ __device__ constexpr int pow2_ceil(int x) {
  return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2);
}

// The constants of one (dtype, head_dim) instance.  ops.py::_tile_tokens
// computes the same TILE.  A row takes a power of two of lanes (the dot
// product's shuffle tree and the lane groups' merge need one): at head
// dim 80 a row's 20 (fp32) or 10 (bf16) chunks sit on 32 or 16 lanes, and
// the lanes past the row's last chunk (PART) hold zeros and load nothing.
template <typename T, int HD>
struct Shape {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int CPR = HD / VEC;              // 16-byte chunks a row
  static constexpr int LPR = CPR < 32 ? pow2_ceil(CPR) : 32;  // lanes a row
  static constexpr int C = (CPR + LPR - 1) / LPR;   // chunks a lane
  static constexpr bool PART = C * LPR != CPR;      // lanes without a chunk
  static constexpr int EL = C * VEC;                // elements a lane
  static constexpr int TPW = 32 / LPR;              // tokens a warp step
  static constexpr int TILE = kWarps * kSteps * TPW;
  static constexpr int COPIES = TILE * CPR;         // 16-byte copies a tile
  static constexpr int LOADS = (COPIES + kThreads - 1) / kThreads;
  static constexpr int ROWB = HD * static_cast<int>(sizeof(T));
  static constexpr int RING = kStages * 2 * TILE * ROWB;
  // whether chunk c of lane li lies in the row
  __device__ static __forceinline__ bool has(int c, int li) {
    return !PART || c * LPR + li < CPR;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void bf16x2_to(unsigned int w, float* x) {
  x[0] = __uint_as_float(w << 16);
  x[1] = __uint_as_float(w & 0xffff0000u);
}

// 16 bytes -> 4 or 8 floats.
__device__ __forceinline__ void unpack(uint4 w, const float*, float* x) {
  x[0] = __uint_as_float(w.x);
  x[1] = __uint_as_float(w.y);
  x[2] = __uint_as_float(w.z);
  x[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(uint4 w, const __nv_bfloat16*,
                                       float* x) {
  bf16x2_to(w.x, x);
  bf16x2_to(w.y, x + 2);
  bf16x2_to(w.z, x + 4);
  bf16x2_to(w.w, x + 6);
}

// A lane's EL elements of a row: chunk c*LPR + li of the row, c < C
// (zeros for a chunk past the row's end).
template <typename T, int HD>
__device__ __forceinline__ void lane_row(const T* row, int li, float* x) {
  using S = Shape<T, HD>;
#pragma unroll
  for (int c = 0; c < S::C; ++c) {
    if (S::has(c, li)) {
      unpack(*reinterpret_cast<const uint4*>(row + (c * S::LPR + li) * S::VEC),
             row, x + c * S::VEC);
    } else {
#pragma unroll
      for (int v = 0; v < S::VEC; ++v) x[c * S::VEC + v] = 0.f;
    }
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Params {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* page_table;     // (batch, max_pages) int32, contiguous
  const int* valid;          // valid[b * v_sb + h * v_sh]
  void* out;
  float* ws;                 // partials; null with one split
  int n_kv_heads, max_pages, page_size, n_splits, span;
  int64_t q_sb, q_sh;        // q element (b, h, 0)
  int64_t p_sp, p_st, p_sh;  // pool element (page, token, kv head, 0)
  int64_t o_sb, o_sh;        // out element (b, h, 0)
  int64_t v_sb, v_sh;
  float scale;
};

// The group's valid lengths, clamped to the table, and their max / min.
template <int NREP>
__device__ __forceinline__ void group_lengths(const Params& p, int b, int g,
                                              int (&vlen)[NREP], int& tmax,
                                              int& tmin) {
  const int cap = p.max_pages * p.page_size;
  tmax = 0;
  tmin = cap;
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    const int v = min(max(p.valid[b * p.v_sb + (g * NREP + r) * p.v_sh], 0),
                      cap);
    vlen[r] = v;
    tmax = max(tmax, v);
    tmin = min(tmin, v);
  }
}

// One tile from shared memory into a warp's online softmax.  MASKED:
// some token of the tile lies at or past some head's valid length (or
// past the split), so each score and each V row is selected by its head's
// mask; rows not loaded this tile hold stale bytes that never mix in.
template <typename T, int HD, int NREP, bool MASKED>
__device__ __forceinline__ void tile_step(
    const T* sk, const T* sv, int tok0, int row0, int li,
    const int (&vlen)[NREP], const float (&qr)[NREP][Shape<T, HD>::EL],
    float (&acc)[NREP][Shape<T, HD>::EL], float (&m)[NREP], float (&l)[NREP],
    float scale) {
  using S = Shape<T, HD>;
  float s[NREP][kSteps];
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    float kx[S::EL];
    lane_row<T, HD>(sk + (row0 + u * S::TPW) * HD, li, kx);
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < S::EL; ++i) d = fmaf(qr[r][i], kx[i], d);
#pragma unroll
      for (int off = S::LPR / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      s[r][u] = d * scale;
    }
  }
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    float mx = m[r];
#pragma unroll
    for (int u = 0; u < kSteps; ++u)
      if (!MASKED || tok0 + u * S::TPW < vlen[r]) mx = fmaxf(mx, s[r][u]);
    const float corr = expf(m[r] - mx);
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const bool ok = !MASKED || tok0 + u * S::TPW < vlen[r];
      s[r][u] = ok ? expf(s[r][u] - mx) : 0.f;    // now the weight p
      psum += s[r][u];
    }
    l[r] = l[r] * corr + psum;
#pragma unroll
    for (int i = 0; i < S::EL; ++i) acc[r][i] *= corr;
    m[r] = mx;
  }
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    float vx[S::EL];
    lane_row<T, HD>(sv + (row0 + u * S::TPW) * HD, li, vx);
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const bool ok = !MASKED || tok0 + u * S::TPW < vlen[r];
#pragma unroll
      for (int i = 0; i < S::EL; ++i)   // masked rows never mix in
        acc[r][i] = ok ? fmaf(s[r][u], vx[i], acc[r][i]) : acc[r][i];
    }
  }
}

template <typename T, int HD, int NREP>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const Params p) {
  using S = Shape<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const T* __restrict__ kp = static_cast<const T*>(p.k_pool);
  const T* __restrict__ vp = static_cast<const T*>(p.v_pool);
  const T* __restrict__ q = static_cast<const T*>(p.q);

  // Lets the combine kernel (launched as a programmatic dependent) be
  // scheduled once every block here has started; it waits for this grid
  // to finish before it reads the partials.
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int split = blockIdx.x % p.n_splits;
  const int grp = blockIdx.x / p.n_splits;
  const int b = grp / p.n_kv_heads;
  const int g = grp % p.n_kv_heads;
  int vlen[NREP], tmax, tmin;
  group_lengths<NREP>(p, b, g, vlen, tmax, tmin);
  const int t0 = split * p.span;
  if (p.n_splits > 1 && t0 >= tmax) return;   // no work, no table read
  const int t1 = min(t0 + p.span, tmax);
  const int n_tiles = t1 > t0 ? (t1 - t0 + S::TILE - 1) / S::TILE : 0;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lg = lane / S::LPR;              // the warp step's token
  const int li = lane % S::LPR;              // lane within the row
  const int row0 = warp * kSteps * S::TPW + lg;

  float qr[NREP][S::EL], acc[NREP][S::EL], m[NREP], l[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    const T* qrow = q + b * p.q_sb + (g * NREP + r) * p.q_sh;
#pragma unroll
    for (int c = 0; c < S::C; ++c) {
      if (S::has(c, li)) {
        unpack(__ldg(reinterpret_cast<const uint4*>(
                   qrow + (c * S::LPR + li) * S::VEC)),
               qrow, qr[r] + c * S::VEC);
      } else {
#pragma unroll
        for (int v = 0; v < S::VEC; ++v) qr[r][c * S::VEC + v] = 0.f;
      }
    }
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < S::EL; ++i) acc[r][i] = 0.f;
  }

  T* ring = reinterpret_cast<T*>(smem);
  const int* table = p.page_table + static_cast<int64_t>(b) * p.max_pages;
  const int64_t head_off = g * p.p_sh;
  // Tile i's K and V rows into stage i % kStages; rows at or past t1 are
  // not copied.  Each thread copies LOADS chunks of each (kSteps * C
  // when every lane holds a chunk).
  auto load_tile = [&](int i) {
    T* sk = ring + (i % kStages) * 2 * S::TILE * HD;
    T* sv = sk + S::TILE * HD;
    const int ts = t0 + i * S::TILE;
#pragma unroll
    for (int j = 0; j < S::LOADS; ++j) {
      const int c = threadIdx.x + j * kThreads;
      if (S::PART && c >= S::COPIES) break;
      const int tt = c / S::CPR;
      const int e = (c % S::CPR) * S::VEC;
      const int t = ts + tt;
      if (t < t1) {
        const int page = __ldg(table + t / p.page_size);
        const int64_t off = page * p.p_sp + (t % p.page_size) * p.p_st
                            + head_off + e;
        cp_async16(sk + tt * HD + e, kp + off);
        cp_async16(sv + tt * HD + e, vp + off);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();   // this thread's copies of tile i
    __syncthreads();                // everyone's; tile i - 1 is consumed
    if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);
    cp_async_commit();
    const T* sk = ring + (i % kStages) * 2 * S::TILE * HD;
    const int ts = t0 + i * S::TILE;
    if (ts + S::TILE <= tmin && ts + S::TILE <= t1)
      tile_step<T, HD, NREP, false>(sk, sk + S::TILE * HD, ts + row0, row0,
                                    li, vlen, qr, acc, m, l, p.scale);
    else
      tile_step<T, HD, NREP, true>(sk, sk + S::TILE * HD, ts + row0, row0,
                                   li, vlen, qr, acc, m, l, p.scale);
  }

  // Merge the warp's lane groups (tokens of one step), lower group first.
#pragma unroll
  for (int off = S::LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mm = fmaxf(m[r], mo);
      const float c = expf(m[r] - mm), co = expf(mo - mm);
      l[r] = l[r] * c + lo * co;
#pragma unroll
      for (int i = 0; i < S::EL; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][i], off);
        acc[r][i] = acc[r][i] * c + ao * co;
      }
      m[r] = mm;
    }
  }

  // Merge the warps in shared memory, warp 0 first.
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  float* sm_m = reinterpret_cast<float*>(smem);    // [kWarps][NREP]
  float* sm_l = sm_m + kWarps * NREP;              // [kWarps][NREP]
  float* sm_acc = sm_l + kWarps * NREP;            // [kWarps][NREP][HD]
  if (lg == 0) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      if (li == 0) {
        sm_m[warp * NREP + r] = m[r];
        sm_l[warp * NREP + r] = l[r];
      }
#pragma unroll
      for (int c = 0; c < S::C; ++c)
        if (S::has(c, li))
#pragma unroll
          for (int v = 0; v < S::VEC; ++v)
            sm_acc[(warp * NREP + r) * HD + (c * S::LPR + li) * S::VEC + v] =
                acc[r][c * S::VEC + v];
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out);
  const int64_t part = static_cast<int64_t>(grp) * p.n_splits + split;
  for (int idx = threadIdx.x; idx < NREP * HD; idx += kThreads) {
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
    if (p.n_splits == 1) {
      store(out + b * p.o_sb + (g * NREP + r) * p.o_sh + e,
            aa / fmaxf(ll, 1e-30f));
    } else {
      p.ws[(part * NREP + r) * HD + e] = aa;
      if (e == 0) {
        float* ml = p.ws + static_cast<int64_t>(gridDim.x) * NREP * HD;
        ml[(part * NREP + r) * 2] = mm;
        ml[(part * NREP + r) * 2 + 1] = ll;
      }
    }
  }
}

// One block per (sequence, query head), one thread per element: the
// working splits' partials merged in split order, as the warps were.
template <typename T, int HD, int NREP>
__global__ void __launch_bounds__(HD)
paged_decode_combine_kernel(const Params p) {
  const int grp = blockIdx.x / NREP;
  const int r = blockIdx.x % NREP;
  const int b = grp / p.n_kv_heads;
  const int g = grp % p.n_kv_heads;
  const int e = threadIdx.x;
  int vlen[NREP], tmax, tmin;
  group_lengths<NREP>(p, b, g, vlen, tmax, tmin);
  const int n_work = min(p.n_splits, (tmax + p.span - 1) / p.span);
  const int64_t n_parts =
      static_cast<int64_t>(gridDim.x / NREP) * p.n_splits;
  const float* acc = p.ws + static_cast<int64_t>(grp) * p.n_splits * NREP * HD;
  const float* ml = p.ws + n_parts * NREP * HD
                    + static_cast<int64_t>(grp) * p.n_splits * NREP * 2;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the split kernel
  float mm = kNegInf;
  for (int s = 0; s < n_work; ++s) mm = fmaxf(mm, ml[(s * NREP + r) * 2]);
  float ll = 0.f, aa = 0.f;
  for (int s = 0; s < n_work; ++s) {
    const float c = expf(ml[(s * NREP + r) * 2] - mm);
    ll += ml[(s * NREP + r) * 2 + 1] * c;
    aa += acc[(s * NREP + r) * HD + e] * c;
  }
  store(static_cast<T*>(p.out) + b * p.o_sb + (g * NREP + r) * p.o_sh + e,
        aa / fmaxf(ll, 1e-30f));
}

template <typename T, int HD, int NREP>
int launch(const Params& p, int groups, cudaStream_t stream) {
  using S = Shape<T, HD>;
  if (p.span % S::TILE != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = paged_decode_split_kernel<T, HD, NREP>;
  const int merge = kWarps * NREP * (HD + 2) * static_cast<int>(sizeof(float));
  const int smem = S::RING > merge ? S::RING : merge;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<groups * p.n_splits, kThreads, smem, stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.n_splits == 1) return static_cast<int>(e);
  // The combine kernel as a programmatic dependent launch: it may start
  // while the split kernel runs and waits for it (griddepcontrol.wait),
  // which hides its launch behind the split kernel's tail.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * NREP);
  cfg.blockDim = dim3(HD);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, paged_decode_combine_kernel<T, HD, NREP>, p));
}

template <typename T, int HD>
int by_rep(const Params& p, int n_rep, int groups, cudaStream_t s) {
  switch (n_rep) {
    case 1: return launch<T, HD, 1>(p, groups, s);
    case 2: return launch<T, HD, 2>(p, groups, s);
    case 4: return launch<T, HD, 4>(p, groups, s);
    case 5: return launch<T, HD, 5>(p, groups, s);
    case 6: return launch<T, HD, 6>(p, groups, s);
    case 8: return launch<T, HD, 8>(p, groups, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int by_head_dim(const Params& p, int hd, int n_rep, int groups,
                cudaStream_t s) {
  switch (hd) {
    case 32: return by_rep<T, 32>(p, n_rep, groups, s);
    case 64: return by_rep<T, 64>(p, n_rep, groups, s);
    case 80: return by_rep<T, 80>(p, n_rep, groups, s);   // stablelm-3b
    case 128: return by_rep<T, 128>(p, n_rep, groups, s);
    case 256: return by_rep<T, 256>(p, n_rep, groups, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (q, both pools and out share it).
// head_dim in {32, 64, 80, 128, 256} (80: stablelm-3b); n_rep in {1, 2, 4,
// 5, 6, 8} (5: hymba-1.5b, qwen2.5-14b, llama4; 6: internvl2-26b).
// Strides are in elements;
// head_dim is contiguous everywhere, q and the pools start
// 16-byte aligned with strides that keep every row 16-byte aligned, and
// page ids lie in [0, pages of the pool) (the Python wrapper checks all
// but the last, which the engine's allocator guarantees).  The split
// plan: n_splits blocks per (sequence, KV head), each over `span` tokens,
// a multiple of the ring tile, n_splits * span >= max_pages * page_size.
// With n_splits > 1, ws holds batch * n_kv_heads * n_splits * n_rep *
// (head_dim + 2) floats.  Returns cudaGetLastError() after the launches,
// or cudaErrorInvalidValue for an unsupported dtype, head_dim, n_rep or
// plan.
extern "C" int flash_decode_paged(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* valid, void* out, void* ws,
    int dtype, int head_dim, int n_rep, int batch, int n_kv_heads,
    int max_pages, int page_size, int n_splits, int span, int64_t q_sb,
    int64_t q_sh, int64_t p_sp, int64_t p_st, int64_t p_sh, int64_t o_sb,
    int64_t o_sh, int64_t v_sb, int64_t v_sh, float scale, void* stream) {
  if (batch == 0 || n_kv_heads == 0) return 0;
  if (n_splits < 1 || span < 1 ||
      static_cast<int64_t>(n_splits) * span <
          static_cast<int64_t>(max_pages) * page_size ||
      (n_splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k_pool, v_pool, static_cast<const int*>(page_table),
                 static_cast<const int*>(valid), out, static_cast<float*>(ws),
                 n_kv_heads, max_pages, page_size, n_splits, span, q_sb, q_sh,
                 p_sp, p_st, p_sh, o_sb, o_sh, v_sb, v_sh, scale};
  const int groups = batch * n_kv_heads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_head_dim<float>(p, head_dim, n_rep, groups, s);
  if (dtype == 1)
    return by_head_dim<__nv_bfloat16>(p, head_dim, n_rep, groups, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
