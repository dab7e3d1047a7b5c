// Fused participation-weighted masked FedAvg for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/masked_agg/kernel.py::masked_agg (Pallas
// body _agg_kernel), the server-side aggregation of the paper's hub round
// and of the hierarchical hub combine.
//
// For every tile row t of the packed unit tiles, with u = row_unit[t] and
// the weight of client c  w[c] = sel[c, u] * wc[c]:
//     out[t, :] = g[t, :] + (sum_c w[c] * d[c, t, :]) / max(sum_c w[c], 1e-9)
// or g[t, :] where the denominator is <= 0 (a unit nobody trained keeps
// its global value exactly).  Accumulation is fp32.  The numerator reads
// only the client planes whose selection of the row's unit is non-zero:
// a frozen unit's delta is an exact zero by construction, so skipping it
// changes no finite result (up to the sign of a zero).  A plane that is
// selected but weighs 0 (a crashed client) is still read, so a NaN there
// reaches the output as in the plain version (0 * NaN).
//
// Layout: g and out are (T, tile); sel is (C, U), wc (C,), row_unit (T,)
// int32 (the tiling plan's row -> unit table, built once); the deltas
// are read as C client planes of (T, tile) rows, client c starting at
// d + c * client_stride, so the client-stacked buffer the round step
// writes each delta into is read in place.
//
// Bound on this card: memory.  A call must read the global tiles once,
// the selected client planes once (L planes a row on average), the
// (C, U) selection, the C weights and the row table once, and write the
// output once: 4*T*tile*(2 + L) + 4*(C*U + C + T) bytes.  It does 2*L
// flops an element, far below the ratio at which the ALUs would limit it.
//
// Design.  Work items are (row, chunk) pairs, one block each: a chunk is
// blockDim.x * V float4s of a row, so a plan of few rows (CASA's 44)
// still spreads over the 132 SMs, and the hardware scheduler balances
// rows whose units have many live planes against rows with few.  Each
// warp builds the row's live-client list itself, 32 clients at a time:
// every lane loads one client's selection and weight, a ballot gives the
// live mask, and the weights are passed round by shuffles (no shared
// memory, no block barrier).  A thread owns V float4 positions of the
// chunk and issues the 16-byte loads of G live clients for all of them
// before their FMAs, so G * V loads are in flight a thread rather than
// one dependent load an iteration.  Clients are summed in ascending
// order, the denominator too, with no atomics: a run is bitwise
// repeatable.  Loads are streaming (ld.global.cs): nothing is read twice.
// Launch shape: 64 threads a block, each owning V float4s of the chunk.
// The wrapper (ops.py, launch_vec) takes V = 2 (512 floats a block, 4
// blocks a 2,048-float row) wherever that gives the card 8 blocks an SM,
// else V = 1 (CASA's 44 rows: 352 blocks).  A sweep of nine shapes from
// 32 x 1 to 512 x 1 at the nine plans K1 runs, on an H100 with a build
// of this kernel that took the shape as an argument, put 64 x 2 best or
// within 0.2% of the best at every plan of 1,293 rows or more, and every
// V of 2 or 4 behind V = 1 at CASA; 64 threads with V = 1 or 2 are the
// only shapes built.  K1 does 2 flops a 4-byte load, so wgmma has no
// role, and staging through shared memory would only add a copy.  The
// kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int G = 4;  // live clients whose loads are issued together
constexpr int THREADS = 64;

__device__ __forceinline__ float combine(float g, float num, float denom) {
  return g + (denom > 0.f ? num / fmaxf(denom, 1e-9f) : 0.f);
}

__device__ __forceinline__ void fma4(float w, const float4& x, float4& a) {
  a.x = fmaf(w, x.x, a.x);
  a.y = fmaf(w, x.y, a.y);
  a.z = fmaf(w, x.z, a.z);
  a.w = fmaf(w, x.w, a.w);
}

template <int V>
__global__ void masked_agg_kernel(const float* __restrict__ g,
                                  const float* __restrict__ d,
                                  const float* __restrict__ sel,
                                  const float* __restrict__ wc,
                                  const int32_t* __restrict__ row_unit,
                                  float* __restrict__ out,
                                  int64_t n_clients, int64_t n_units,
                                  int64_t tile, int64_t client_stride,
                                  int64_t chunks_per_row) {
  const int64_t item = blockIdx.x;
  const int64_t t = item / chunks_per_row;
  const int64_t chunk = item - t * chunks_per_row;
  const int64_t n4 = tile / 4;
  const int lane = threadIdx.x & 31;

  int64_t pos[V];
  bool ok[V];
  float4 gv[V], acc[V];
  const float4* g4 = reinterpret_cast<const float4*>(g + t * tile);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    pos[j] = (chunk * V + j) * THREADS + threadIdx.x;
    ok[j] = pos[j] < n4;
    gv[j] = ok[j] ? __ldcs(g4 + pos[j]) : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int64_t u = row_unit[t];
  const float* drow = d + t * tile;
  float denom = 0.f;
  for (int64_t base = 0; base < n_clients; base += 32) {
    const int64_t c = base + lane;
    float s = 0.f, wl = 0.f;
    if (c < n_clients) {
      s = sel[c * n_units + u];
      wl = s * wc[c];
    }
    unsigned live = __ballot_sync(FULL, s != 0.f);
    const int64_t rest = n_clients - base;
    const int n = rest < 32 ? static_cast<int>(rest) : 32;
    for (int j = 0; j < n; ++j) denom += __shfl_sync(FULL, wl, j);
    while (live) {  // warp-uniform: every lane holds the same mask
      int cl[G];
      float wk[G];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        cl[k] = live ? __ffs(live) - 1 : -1;
        live &= live - 1;
        wk[k] = __shfl_sync(FULL, wl, cl[k] < 0 ? 0 : cl[k]);
      }
      float4 x[G][V];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const float4* p = reinterpret_cast<const float4*>(
            drow + (base + (cl[k] < 0 ? 0 : cl[k])) * client_stride);
#pragma unroll
        for (int j = 0; j < V; ++j)
          x[k][j] = (cl[k] >= 0 && ok[j]) ? __ldcs(p + pos[j])
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (cl[k] < 0) break;
#pragma unroll
        for (int j = 0; j < V; ++j) fma4(wk[k], x[k][j], acc[j]);
      }
    }
  }

  float4* o4 = reinterpret_cast<float4*>(out + t * tile);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (!ok[j]) continue;
    float4 r;
    r.x = combine(gv[j].x, acc[j].x, denom);
    r.y = combine(gv[j].y, acc[j].y, denom);
    r.z = combine(gv[j].z, acc[j].z, denom);
    r.w = combine(gv[j].w, acc[j].w, denom);
    o4[pos[j]] = r;
  }
}

template <int V>
cudaError_t launch(const float* g, const float* d, const float* sel,
                   const float* wc, const int32_t* row_unit, float* out,
                   int64_t n_rows, int64_t n_clients, int64_t n_units,
                   int64_t tile, int64_t client_stride,
                   cudaStream_t stream) {
  const int64_t chunk = static_cast<int64_t>(THREADS) * V;
  const int64_t chunks_per_row = (tile / 4 + chunk - 1) / chunk;
  const int64_t blocks = n_rows * chunks_per_row;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  masked_agg_kernel<V><<<static_cast<unsigned int>(blocks), THREADS, 0,
                         stream>>>(g, d, sel, wc, row_unit, out, n_clients,
                                   n_units, tile, client_stride,
                                   chunks_per_row);
  return cudaGetLastError();
}

}  // namespace

// g, out: (n_rows, tile) f32 contiguous; d: n_clients planes of
// (n_rows, tile) f32, plane c at d + c * client_stride; sel: (n_clients,
// n_units) f32 contiguous; wc: (n_clients,) f32; row_unit: (n_rows,)
// int32, every entry below n_units.  tile and client_stride are multiples
// of 4 and g, d, out are 16-byte aligned (the Python wrapper checks all of
// it).  vec is 1 or 2: a block of 64 threads covers 64 * vec float4s of
// one row.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for another vec.
extern "C" int masked_agg_f32(const void* g, const void* d, const void* sel,
                              const void* wc, const void* row_unit,
                              void* out, int64_t n_rows, int64_t n_clients,
                              int64_t n_units, int64_t tile,
                              int64_t client_stride, int64_t vec,
                              void* stream) {
  if (n_rows == 0 || tile == 0) return 0;
  const auto* gp = static_cast<const float*>(g);
  const auto* dp = static_cast<const float*>(d);
  const auto* sp = static_cast<const float*>(sel);
  const auto* wp = static_cast<const float*>(wc);
  const auto* rp = static_cast<const int32_t*>(row_unit);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 1:
      return static_cast<int>(launch<1>(gp, dp, sp, wp, rp, op, n_rows,
                                        n_clients, n_units, tile,
                                        client_stride, st));
    case 2:
      return static_cast<int>(launch<2>(gp, dp, sp, wp, rp, op, n_rows,
                                        n_clients, n_units, tile,
                                        client_stride, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
