// Stochastic-rounding quantize-pack for Hopper (sm_90a), a list of leaves
// in one launch.
//
// Replaces: src/repro/kernels/codec/kernel.py::quantize_pack (Pallas
// bodies _q8_kernel and _q4_kernel, shared row math _scale_round), the
// encode half of the qint8 / qint4 uplink codecs on the packed round path,
// which the reference calls once per leaf (core/codecs.py:144).  This
// kernel computes the same function for every leaf of a list.
//
// For every row r of a leaf's x (R, P) float32, with pre-drawn uniforms u
// (R, P):
//     absmax = max_j |x[r, j]|
//     scale  = absmax * inv_qmax            (inv_qmax: float32 of 1/qmax)
//     inv    = scale > 0 ? 1 / scale : 0
//     q[j]   = clip(floor(x[r, j] * inv + u[r, j]), -qmax, qmax)
// 8 bits: codes (R, P) int8 = q.  4 bits: codes (R, ceil(P/2)) uint8, byte
// k = (q[2k] + 8) | (q[2k+1] + 8) << 4; an odd row ends in a padded element
// with x = 0 and u = 0 (q = 0, high nibble 8), as the reference pads.
// scale[r] is written once per row.
//
// Exact rounding, so that the codes equal the plain PyTorch version
// (ref.py) bit for bit: inv_qmax comes from the caller as the float32 the
// reference multiplies by; the multiply and the add are rounded separately
// (__fmul_rn, __fadd_rn: nvcc would otherwise contract x*inv + u into one
// fma); 1/scale is the correctly rounded reciprocal (__frcp_rn); a NaN q
// (a NaN or infinite x) packs as 0, as the plain version's cast of its NaN
// gives on the card.  The row maximum is exact and does not depend on the
// order of the reduction, and it keeps a NaN, as torch.amax does.
//
// Bound on this card: memory.  A call must read x and u once (8 bytes an
// element) and write the codes once (1 byte, or half a byte, an element)
// and the scales (4 bytes a row); it does a handful of operations an
// element.  On the main path (VGG16 at full width, 8 clients) a round
// quantizes 8 x 14,736,714 elements over 80 leaves: 1.061 GB for int8,
// 1.002 GB for int4, 0.317 / 0.299 ms at the H100 SXM's 3.35 TB/s.
//
// Design: one launch for the whole list (up to kMaxLeaves leaves; a longer
// list is cut into launches of whole leaves).  The leaves' descriptors
// travel in the kernel's parameters (__grid_constant__, up to 32,764
// bytes from CUDA 12.1).  A work item is (leaf, row, chunk of 8192
// elements); each block takes one, in the order of an atomic ticket, so a
// few long rows (8 rows of 2,359,296 elements on the largest VGG16 leaves)
// still fill all 132 SMs and the 80 leaves' small rows share one grid.  A
// block loads its chunk of x into registers (32 floats a thread, 16-byte
// loads where the row allows them) and starts copying its uniforms into
// shared memory (cp.async).  A row of one chunk then quantizes and packs
// at once.  A row of up to kWaitChunks (8) chunks reads x once: each
// block takes its chunk's max of |x|, writes it to the row's partials,
// raises the row's arrival count (release), waits for the count to reach
// the row's chunk total (acquire), reduces the partials and quantizes
// from its registers.  A longer row takes two visits: its chunk maxima,
// then its quantize items, which wait only on the maxima and load x
// again, mostly from L2.  Holding a long row's chunks while its last ones
// load idles most of the card's blocks; holding every row in place
// measured slower on the 80 VGG16 leaves (PERF.md).  No wait can
// deadlock: tickets are taken in order, so every item of an earlier row
// has been taken and arrives; a second visit waits only on items with
// earlier tickets; and a row that waits in place has at most 8 chunks,
// fewer blocks than two SMs hold at once, so its last chunks always find
// a block.  No atomics touch data, only the counters, and the max is
// exact: a run is bitwise repeatable.  The kernel allocates nothing (the
// wrapper passes the partials and the zeroed counters) and launches on
// the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8192;               // elements of one row an item
constexpr int kPer = kChunk / kThreads;    // elements a thread holds
constexpr int kMaxLeaves = 256;            // leaves a launch
constexpr int kWaitChunks = 8;             // a row this long waits in place

struct Leaf {
  const float* x;
  const float* u;
  uint8_t* codes;
  float* scale;
  int64_t p;         // row length
  int64_t part0;     // the leaf's first (row, chunk) partial
  int64_t row0;      // the leaf's first row counter
  int rows;
  int n_chunks;      // ceil(p / kChunk)
  int item0;         // the leaf's first work item in its launch
  int two_visits;    // rows longer than kWaitChunks chunks: two visits
  int vec4;          // 16-byte loads: p % 4 == 0, x and u 16-byte aligned
};

struct Group {
  int* ticket;       // zeroed: the next work item
  int* arrived;      // zeroed: per row, chunks whose max is in partial
  float* partial;
  float inv_qmax;
  int n_leaves;
  Leaf leaf[kMaxLeaves];
};

// max that keeps a NaN, as jnp.max and torch.amax do
__device__ __forceinline__ float max_keep_nan(float m, float v) {
  return (v > m || v != v) ? v : m;
}

__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = max_keep_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                         // red's last readers are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) v = max_keep_nan(v, red[w]);
  return v;
}

__device__ __forceinline__ int quantize(float x, float u, float inv,
                                        float qmax) {
  const float q = floorf(__fadd_rn(__fmul_rn(x, inv), u));
  return q != q ? 0 : static_cast<int>(fminf(fmaxf(q, -qmax), qmax));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

template <int BITS>
__global__ void __launch_bounds__(kThreads, 5)
    quantize_pack_group_kernel(const __grid_constant__ Group g) {
  constexpr float qmax = BITS == 8 ? 127.f : 7.f;
  __shared__ __align__(16) float su[kChunk];  // this item's uniforms
  __shared__ float red[kThreads / 32];
  __shared__ int s_item;
  const int tid = threadIdx.x;
  if (tid == 0) s_item = atomicAdd(g.ticket, 1);
  __syncthreads();
  const int item = s_item;

  // the leaf: the last whose first item is at or before this one
  int lo = 0, hi = g.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (g.leaf[mid].item0 <= item) lo = mid; else hi = mid - 1;
  }
  const Leaf& L = g.leaf[lo];
  const int nc = L.n_chunks;
  const int local = item - L.item0;
  // a row of two visits: its nc maxima, then its nc quantize items
  const int per_row = L.two_visits ? 2 * nc : nc;
  const int r = local / per_row, w = local % per_row, c = w % nc;
  const bool max_only = L.two_visits && w < nc;
  const bool quantize_only = L.two_visits && w >= nc;
  const int64_t p = L.p;
  const int64_t lo_e = static_cast<int64_t>(c) * kChunk;
  const int64_t hi_e = lo_e + kChunk < p ? lo_e + kChunk : p;
  const float* xr = L.x + r * p;
  const float* ur = L.u + r * p;

  // x into registers; with 16-byte rows, u into shared memory meanwhile.
  // Element layout: float4 f = lo_e / 4 + tid + k * kThreads (vec4); or
  // element lo_e + tid + k * kThreads (8 bits); or the pair lo_e / 2 +
  // tid + k * kThreads, elements 2 pair and 2 pair + 1 (4 bits).
  float xv[kPer];
  float m = 0.f;
  if (L.vec4) {
#pragma unroll
    for (int k = 0; k < kPer / 4; ++k) {
      const int64_t f = lo_e / 4 + tid + k * kThreads;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (4 * f < hi_e) {
        v = L.two_visits ? __ldcg(reinterpret_cast<const float4*>(xr) + f)
                         : __ldcs(reinterpret_cast<const float4*>(xr) + f);
        if (!max_only) cp_async16(su + 4 * (tid + k * kThreads), ur + 4 * f);
      }
      xv[4 * k] = v.x;
      xv[4 * k + 1] = v.y;
      xv[4 * k + 2] = v.z;
      xv[4 * k + 3] = v.w;
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else if (BITS == 8) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int64_t e = lo_e + tid + k * kThreads;
      xv[k] = e < hi_e ? __ldcs(xr + e) : 0.f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer / 2; ++k) {
      const int64_t e = lo_e + 2 * (tid + k * kThreads);
      xv[2 * k] = e < hi_e ? __ldcs(xr + e) : 0.f;
      xv[2 * k + 1] = e + 1 < hi_e ? __ldcs(xr + e + 1) : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) m = max_keep_nan(m, fabsf(xv[k]));

  const int64_t part = L.part0 + static_cast<int64_t>(r) * nc;
  int* arrived = g.arrived + L.row0 + r;
  if (nc > 1) {
    if (!quantize_only) {
      m = block_max(m, red);
      if (tid == 0) {
        g.partial[part + c] = m;
        __threadfence();                   // the partial before the count
        atomicAdd(arrived, 1);
      }
    }
    if (max_only) return;
    if (tid == 0) {
      while (load_acquire(arrived) < nc) __nanosleep(100);
    }
    __syncthreads();
    m = 0.f;
    for (int i = tid; i < nc; i += kThreads)
      m = max_keep_nan(m, __ldcg(g.partial + part + i));
  }
  m = block_max(m, red);
  const float scale = __fmul_rn(m, g.inv_qmax);
  const float inv = scale > 0.f ? __frcp_rn(scale) : 0.f;
  if (c == 0 && tid == 0) L.scale[r] = scale;

  if (L.vec4) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer / 4; ++k) {
      const int64_t f = lo_e / 4 + tid + k * kThreads;
      if (4 * f >= hi_e) continue;
      const float4 uv =
          *reinterpret_cast<const float4*>(su + 4 * (tid + k * kThreads));
      const int q0 = quantize(xv[4 * k], uv.x, inv, qmax);
      const int q1 = quantize(xv[4 * k + 1], uv.y, inv, qmax);
      const int q2 = quantize(xv[4 * k + 2], uv.z, inv, qmax);
      const int q3 = quantize(xv[4 * k + 3], uv.w, inv, qmax);
      if (BITS == 8) {
        const uint32_t word = (static_cast<uint32_t>(q0) & 0xffu) |
                              (static_cast<uint32_t>(q1) & 0xffu) << 8 |
                              (static_cast<uint32_t>(q2) & 0xffu) << 16 |
                              (static_cast<uint32_t>(q3) & 0xffu) << 24;
        reinterpret_cast<uint32_t*>(L.codes + r * p)[f] = word;
      } else {
        const uint32_t b0 = static_cast<uint32_t>(q0 + 8) |
                            static_cast<uint32_t>(q1 + 8) << 4;
        const uint32_t b1 = static_cast<uint32_t>(q2 + 8) |
                            static_cast<uint32_t>(q3 + 8) << 4;
        reinterpret_cast<uint16_t*>(L.codes + r * (p / 2))[f] =
            static_cast<uint16_t>(b0 | b1 << 8);
      }
    }
  } else if (BITS == 8) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int64_t e = lo_e + tid + k * kThreads;
      if (e < hi_e)
        L.codes[r * p + e] = static_cast<uint8_t>(
            quantize(xv[k], __ldcs(ur + e), inv, qmax) & 0xff);
    }
  } else {
    // one byte a pair; kChunk is even, so an item owns whole pairs, and
    // the pair past an odd row's end is (0, 0)
    const int64_t cols = (p + 1) / 2;
#pragma unroll
    for (int k = 0; k < kPer / 2; ++k) {
      const int64_t e = lo_e + 2 * (tid + k * kThreads);
      if (e >= hi_e) continue;
      const int q0 = quantize(xv[2 * k], __ldcs(ur + e), inv, qmax);
      const int q1 = e + 1 < p
                         ? quantize(xv[2 * k + 1], __ldcs(ur + e + 1), inv,
                                    qmax)
                         : quantize(0.f, 0.f, inv, qmax);
      L.codes[r * cols + e / 2] =
          static_cast<uint8_t>((q0 + 8) | (q1 + 8) << 4);
    }
  }
}

}  // namespace

// Leaves are rows of desc, 6 int64 each: x, u, codes, scale (pointers),
// rows, p.  x, u: (rows, p) f32 contiguous; codes: (rows, p) int8 for
// bits 8, (rows, (p + 1) / 2) uint8 for bits 4, contiguous; scale: (rows,)
// f32.  partial: f32 scratch, one per (leaf, row, chunk of 8192) in leaf
// order; counters: int32, zeroed, one ticket per launch (ceil(n_leaves /
// 256) of them) then one per row of every leaf in leaf order.  Returns
// the number of kernels launched, or minus the first cudaError that is
// not cudaSuccess (minus cudaErrorInvalidValue for what it does not take).
extern "C" int quantize_pack_group_f32(const int64_t* desc, int n_leaves,
                                       int bits, float inv_qmax,
                                       void* partial, void* counters,
                                       void* stream) {
  if (bits != 8 && bits != 4) return -static_cast<int>(cudaErrorInvalidValue);
  const int n_launches = (n_leaves + kMaxLeaves - 1) / kMaxLeaves;
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t part0 = 0, row0 = 0;
  int launched = 0;
  for (int first = 0; first < n_leaves; first += kMaxLeaves) {
    Group g;
    g.ticket = cnt + first / kMaxLeaves;
    g.arrived = cnt + n_launches;
    g.partial = static_cast<float*>(partial);
    g.inv_qmax = inv_qmax;
    g.n_leaves = 0;
    int64_t items = 0;
    for (int i = first; i < n_leaves && i < first + kMaxLeaves; ++i) {
      const int64_t* d = desc + 6 * i;
      const int64_t rows = d[4], p = d[5];
      const int64_t nc = (p + kChunk - 1) / kChunk;
      const int64_t per_visit = rows * nc;
      Leaf& L = g.leaf[g.n_leaves];
      L.x = reinterpret_cast<const float*>(d[0]);
      L.u = reinterpret_cast<const float*>(d[1]);
      L.codes = reinterpret_cast<uint8_t*>(d[2]);
      L.scale = reinterpret_cast<float*>(d[3]);
      L.p = p;
      L.part0 = part0;
      L.row0 = row0;
      L.rows = static_cast<int>(rows);
      L.n_chunks = static_cast<int>(nc);
      L.item0 = static_cast<int>(items);
      L.two_visits = nc > kWaitChunks;
      L.vec4 = p % 4 == 0 && d[0] % 16 == 0 && d[1] % 16 == 0 &&
               d[2] % 4 == 0;
      part0 += per_visit;
      row0 += rows;
      if (rows == 0 || p == 0) continue;          // nothing to do
      if (rows >= (1 << 30) || nc >= (1 << 30))
        return -static_cast<int>(cudaErrorInvalidValue);
      items += L.two_visits ? 2 * per_visit : per_visit;  // row by row
      if (items >= (int64_t{1} << 31) - 1)
        return -static_cast<int>(cudaErrorInvalidValue);
      ++g.n_leaves;
    }
    if (items == 0) continue;
    const dim3 grid(static_cast<unsigned>(items));
    if (bits == 8)
      quantize_pack_group_kernel<8><<<grid, kThreads, 0, st>>>(g);
    else
      quantize_pack_group_kernel<4><<<grid, kThreads, 0, st>>>(g);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return -static_cast<int>(e);
    ++launched;
  }
  return launched;
}
