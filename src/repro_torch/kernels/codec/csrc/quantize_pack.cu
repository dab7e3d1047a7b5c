// Stochastic-rounding quantize-pack for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/codec/kernel.py::quantize_pack (Pallas
// bodies _q8_kernel and _q4_kernel, shared row math _scale_round), the
// encode half of the qint8 / qint4 uplink codecs on the packed round path.
//
// For every row r of x (R, P) float32, with pre-drawn uniforms u (R, P):
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
// fma); 1/scale is the correctly rounded reciprocal (__frcp_rn).  The row
// maximum is exact and does not depend on the order of the reduction.
//
// Bound on this card: memory.  A call must read x and u once (8 bytes an
// element) and write the codes once (1 byte, or half a byte, an element)
// and the scales (4 bytes a row); it does a handful of operations an
// element.  On the main path (VGG16 at full width, 8 clients) a round
// quantizes 8 x 14,736,714 elements: 1.061 GB for int8, 1.002 GB for int4,
// 0.317 / 0.299 ms at the H100 SXM's 3.35 TB/s.
//
// Design: two launches over a flat (row, chunk) grid of blocks, so that a
// few long rows (8 rows of 2,359,296 elements on the largest VGG16 leaves)
// still fill all 132 SMs.  Pass 1: each block takes the max of |x| over its
// chunk of one row (16-byte loads where the row allows them, a warp-shuffle
// block reduction) and writes it to partial[row, chunk].  Pass 2: each block
// reduces its row's partials (a few hundred floats, from L2), derives scale
// and inv, and quantizes and packs its chunk.  x is read twice, so a call
// moves 13 (int8) or 12.5 (int4) bytes an element, not the 9 or 8.5 of the
// bound.  No atomics: a run is bitwise repeatable.  The kernels allocate
// nothing (the wrapper passes the partial buffer) and launch on the
// caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 8192;  // elements of one row per block

// max that keeps a NaN, as jnp.max and torch.amax do
__device__ __forceinline__ float max_keep_nan(float m, float v) {
  return (v > m || v != v) ? v : m;
}

__device__ float block_max(float v) {
  __shared__ float warp_max[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1)
    v = max_keep_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_max[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      v = max_keep_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) warp_max[0] = v;
  }
  __syncthreads();
  return warp_max[0];
}

__device__ __forceinline__ int quantize(float x, float u, float inv,
                                        float qmax) {
  float q = floorf(__fadd_rn(__fmul_rn(x, inv), u));
  q = fminf(fmaxf(q, -qmax), qmax);
  return static_cast<int>(q);
}

// VEC = 4: P % 4 == 0 and x is 16-byte aligned; VEC = 1 otherwise.
template <int VEC>
__global__ void absmax_partial_kernel(const float* __restrict__ x,
                                      float* __restrict__ partial, int64_t p,
                                      int64_t n_chunks) {
  const int64_t r = blockIdx.x / n_chunks;
  const int64_t chunk = blockIdx.x % n_chunks;
  const float* row = x + r * p;
  const int64_t lo = chunk * kChunk;
  const int64_t hi = lo + kChunk < p ? lo + kChunk : p;
  float m = 0.f;
  if (VEC == 4) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    for (int64_t i = lo / 4 + threadIdx.x; i < hi / 4; i += kThreads) {
      const float4 v = row4[i];
      m = max_keep_nan(m, fabsf(v.x));
      m = max_keep_nan(m, fabsf(v.y));
      m = max_keep_nan(m, fabsf(v.z));
      m = max_keep_nan(m, fabsf(v.w));
    }
  } else {
    for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads)
      m = max_keep_nan(m, fabsf(row[i]));
  }
  m = block_max(m);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

template <int BITS, int VEC>
__global__ void quantize_pack_kernel(const float* __restrict__ x,
                                     const float* __restrict__ u,
                                     uint8_t* __restrict__ codes,
                                     float* __restrict__ scale_out,
                                     const float* __restrict__ partial,
                                     int64_t p, int64_t n_chunks,
                                     float inv_qmax) {
  constexpr float qmax = BITS == 8 ? 127.f : 7.f;
  const int64_t r = blockIdx.x / n_chunks;
  const int64_t chunk = blockIdx.x % n_chunks;

  float m = 0.f;
  for (int64_t i = threadIdx.x; i < n_chunks; i += kThreads)
    m = max_keep_nan(m, partial[r * n_chunks + i]);
  m = block_max(m);
  const float scale = __fmul_rn(m, inv_qmax);
  const float inv = scale > 0.f ? __frcp_rn(scale) : 0.f;
  if (chunk == 0 && threadIdx.x == 0) scale_out[r] = scale;

  const float* xr = x + r * p;
  const float* ur = u + r * p;
  const int64_t lo = chunk * kChunk;
  const int64_t hi = lo + kChunk < p ? lo + kChunk : p;
  if (VEC == 4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* u4 = reinterpret_cast<const float4*>(ur);
    for (int64_t i = lo / 4 + threadIdx.x; i < hi / 4; i += kThreads) {
      const float4 xv = x4[i];
      const float4 uv = u4[i];
      const int q0 = quantize(xv.x, uv.x, inv, qmax);
      const int q1 = quantize(xv.y, uv.y, inv, qmax);
      const int q2 = quantize(xv.z, uv.z, inv, qmax);
      const int q3 = quantize(xv.w, uv.w, inv, qmax);
      if (BITS == 8) {
        const uint32_t w = (static_cast<uint32_t>(q0) & 0xffu) |
                           (static_cast<uint32_t>(q1) & 0xffu) << 8 |
                           (static_cast<uint32_t>(q2) & 0xffu) << 16 |
                           (static_cast<uint32_t>(q3) & 0xffu) << 24;
        reinterpret_cast<uint32_t*>(codes + r * p)[i] = w;
      } else {
        const uint32_t b0 = static_cast<uint32_t>(q0 + 8) |
                            static_cast<uint32_t>(q1 + 8) << 4;
        const uint32_t b1 = static_cast<uint32_t>(q2 + 8) |
                            static_cast<uint32_t>(q3 + 8) << 4;
        reinterpret_cast<uint16_t*>(codes + r * (p / 2))[i] =
            static_cast<uint16_t>(b0 | b1 << 8);
      }
    }
  } else if (BITS == 8) {
    for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads)
      codes[r * p + i] =
          static_cast<uint8_t>(quantize(xr[i], ur[i], inv, qmax) & 0xff);
  } else {
    // one byte per pair of elements; kChunk is even, so a chunk owns
    // whole pairs, and the pair past an odd row's end is (0, 0)
    const int64_t cols = (p + 1) / 2;
    for (int64_t k = lo / 2 + threadIdx.x; 2 * k < hi; k += kThreads) {
      const int q0 = quantize(xr[2 * k], ur[2 * k], inv, qmax);
      const int q1 = 2 * k + 1 < p
                         ? quantize(xr[2 * k + 1], ur[2 * k + 1], inv, qmax)
                         : quantize(0.f, 0.f, inv, qmax);
      codes[r * cols + k] = static_cast<uint8_t>((q0 + 8) | (q1 + 8) << 4);
    }
  }
}

template <int BITS, int VEC>
int launch(const float* x, const float* u, uint8_t* codes, float* scale,
           float* partial, int64_t rows, int64_t p, float inv_qmax,
           cudaStream_t stream) {
  const int64_t n_chunks = (p + kChunk - 1) / kChunk;
  const unsigned int blocks = static_cast<unsigned int>(rows * n_chunks);
  absmax_partial_kernel<VEC><<<blocks, kThreads, 0, stream>>>(
      x, partial, p, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quantize_pack_kernel<BITS, VEC><<<blocks, kThreads, 0, stream>>>(
      x, u, codes, scale, partial, p, n_chunks, inv_qmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, u: (rows, p) f32 contiguous; codes: (rows, p) int8 for bits 8, (rows,
// (p + 1) / 2) uint8 for bits 4, contiguous; scale: (rows,) f32; partial:
// rows * ceil(p / 8192) f32 of scratch.  rows * ceil(p / 8192) < 2^31 (the
// Python wrapper checks it).  Returns the first cudaGetLastError() that is
// not cudaSuccess, or cudaSuccess.
extern "C" int quantize_pack_f32(const void* x, const void* u, void* codes,
                                 void* scale, void* partial, int64_t rows,
                                 int64_t p, int bits, float inv_qmax,
                                 void* stream) {
  if (rows == 0 || p == 0) return 0;
  const bool vec4 = p % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                    (reinterpret_cast<uintptr_t>(u) % 16) == 0 &&
                    (reinterpret_cast<uintptr_t>(codes) % 4) == 0;
  const float* xf = static_cast<const float*>(x);
  const float* uf = static_cast<const float*>(u);
  uint8_t* c = static_cast<uint8_t*>(codes);
  float* s = static_cast<float*>(scale);
  float* part = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 8)
    return vec4 ? launch<8, 4>(xf, uf, c, s, part, rows, p, inv_qmax, st)
                : launch<8, 1>(xf, uf, c, s, part, rows, p, inv_qmax, st);
  if (bits == 4)
    return vec4 ? launch<4, 4>(xf, uf, c, s, part, rows, p, inv_qmax, st)
                : launch<4, 1>(xf, uf, c, s, part, rows, p, inv_qmax, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
