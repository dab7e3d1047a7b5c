// Fused participation-weighted masked FedAvg for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/masked_agg/kernel.py::masked_agg (Pallas
// body _agg_kernel), the server-side aggregation of the paper's hub round.
//
// For every tile row t of the packed unit tiles:
//     out[t, :] = g[t, :] + (sum_c w[t, c] * d[c, t, :]) / max(sum_c w[t, c], 1e-9)
// or g[t, :] where the denominator is <= 0 (a unit nobody trained keeps
// its global value exactly).  Accumulation is fp32.
//
// Layout: g and out are (T, tile); w is (T, C); the deltas are read as
// C client planes of (T, tile) rows, client c starting at
// d + c * client_stride.  The client-stacked (C, T, tile) buffer that the
// round step writes each client's delta into is therefore read in place,
// without the (T, C, tile) transpose copy the TPU wrapper makes.
//
// Bound on this card: memory.  Each call must read the deltas once
// (4*T*tile*C bytes), the global tiles once (4*T*tile), the weights once
// (4*T*C) and write the output once (4*T*tile); it does 2*C flops per
// element, far below the ratio at which an H100's ALUs would limit it.
// For VGG16 at full width (T = 7,252 rows of 2048: 14,736,714 params
// plus tile padding) and C = 8 that is 594.3 MB, 0.177 ms at the H100
// SXM's 3.35 TB/s.
//
// Design: one block per tile row, threads striding the row with 16-byte
// (float4) loads so neighbouring threads read neighbouring addresses; the
// loop over clients runs in registers, and each delta element is read
// exactly once.  The denominator is computed once per row (every thread
// sums the row's C weights, which hit in L1).  No atomics and no
// cross-block reduction, so a run is bitwise repeatable.  The kernel
// allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float combine(float g, float num, float denom) {
  return g + (denom > 0.f ? num / fmaxf(denom, 1e-9f) : 0.f);
}

__global__ void masked_agg_kernel(const float* __restrict__ g,
                                  const float* __restrict__ d,
                                  const float* __restrict__ w,
                                  float* __restrict__ out,
                                  int64_t n_clients, int64_t tile,
                                  int64_t client_stride) {
  const int64_t t = blockIdx.x;
  const float* wr = w + t * n_clients;
  float denom = 0.f;
  for (int64_t c = 0; c < n_clients; ++c) denom += wr[c];

  const int64_t n4 = tile / 4;
  const float4* g4 = reinterpret_cast<const float4*>(g + t * tile);
  float4* o4 = reinterpret_cast<float4*>(out + t * tile);
  const float* drow = d + t * tile;
  for (int64_t i = threadIdx.x; i < n4; i += blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t c = 0; c < n_clients; ++c) {
      const float wc = wr[c];
      const float4 x =
          reinterpret_cast<const float4*>(drow + c * client_stride)[i];
      acc.x = fmaf(wc, x.x, acc.x);
      acc.y = fmaf(wc, x.y, acc.y);
      acc.z = fmaf(wc, x.z, acc.z);
      acc.w = fmaf(wc, x.w, acc.w);
    }
    const float4 gv = g4[i];
    float4 r;
    r.x = combine(gv.x, acc.x, denom);
    r.y = combine(gv.y, acc.y, denom);
    r.z = combine(gv.z, acc.z, denom);
    r.w = combine(gv.w, acc.w, denom);
    o4[i] = r;
  }
}

}  // namespace

// g, out: (n_rows, tile) f32 contiguous; w: (n_rows, n_clients) f32
// contiguous; d: n_clients planes of (n_rows, tile) f32, plane c at
// d + c * client_stride.  tile and client_stride are multiples of 4 and
// every pointer is 16-byte aligned (the Python wrapper checks all of it).
// Returns cudaGetLastError() after the launch.
extern "C" int masked_agg_f32(const void* g, const void* d, const void* w,
                              void* out, int64_t n_rows, int64_t n_clients,
                              int64_t tile, int64_t client_stride,
                              void* stream) {
  if (n_rows == 0 || tile == 0) return 0;
  const int64_t n4 = tile / 4;
  int threads = 256;
  if (n4 < threads) threads = static_cast<int>(((n4 + 31) / 32) * 32);
  masked_agg_kernel<<<static_cast<unsigned int>(n_rows), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(d),
      static_cast<const float*>(w), static_cast<float*>(out), n_clients,
      tile, client_stride);
  return static_cast<int>(cudaGetLastError());
}
