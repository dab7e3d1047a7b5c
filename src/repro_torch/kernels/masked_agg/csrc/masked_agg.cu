// Fused participation-weighted masked FedAvg for Hopper (sm_90a), in fp32
// (masked_agg_f32) and bf16 (masked_agg_bf16).
//
// Replaces: src/repro/kernels/masked_agg/kernel.py::masked_agg (Pallas
// body _agg_kernel), the server-side aggregation of the paper's hub round
// and of the hierarchical hub combine.
//
// For every tile row t of the packed unit tiles, with u = row_unit[t] and
// the weight of client c  w[c] = sel[c, u] * wc[c]:
//     out[t, :] = g[t, :] + (sum_c w[c] * d[c, t, :]) / max(sum_c w[c], 1e-9)
// or g[t, :] where the denominator is <= 0 (a unit nobody trained keeps
// its global value exactly).  Accumulation is fp32 in both instances; the
// bf16 one reads bf16 tiles and planes (8 elements a 16-byte load,
// widened by __bfloat1622float2) and rounds once at the store,
// round-to-nearest-even, as the Pallas body's .astype(o_ref.dtype) does.
// The numerator reads only the client planes whose selection of the
// row's unit is non-zero: a frozen unit's delta is an exact zero by
// construction, so skipping it changes no finite result (up to the sign
// of a zero).  A plane that is selected but weighs 0 (a crashed client)
// is still read, so a NaN there reaches the output as in the plain
// version (0 * NaN).
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
// output once: E*T*tile*(2 + L) + 4*(C*U + C + T) bytes, E the element's
// 4 (fp32) or 2 (bf16) bytes.  It does 2*L flops an element, far below
// the ratio at which the ALUs would limit it.
//
// Design.  Work items are (row, chunk) pairs, one block each: a chunk is
// blockDim.x * V 16-byte vectors of a row, so a plan of few rows (CASA's 44)
// still spreads over the 132 SMs, and the hardware scheduler balances
// rows whose units have many live planes against rows with few.  Each
// warp builds the row's live-client list itself, 32 clients at a time:
// every lane loads one client's selection and weight, a ballot gives the
// live mask, and the weights are passed round by shuffles (no shared
// memory, no block barrier).  A thread owns V vector positions of the
// chunk and issues the 16-byte loads of G live clients for all of them
// before their FMAs, so G * V loads are in flight a thread rather than
// one dependent load an iteration.  Clients are summed in ascending
// order, the denominator too, with no atomics: a run is bitwise
// repeatable.  Loads are streaming (ld.global.cs): nothing is read twice.
// Launch shape: 64 threads a block, each owning V 16-byte vectors of the
// chunk (float4s in fp32, 8 bf16s in bf16), so a block moves the same
// bytes in either instance.  The wrapper (ops.py, launch_vec) takes V = 2
// (2 KB a block: 4 blocks a 2,048-element fp32 row, 2 a bf16 one)
// wherever that gives the card 8 blocks an SM, else V = 1 (CASA's 44
// rows: 352 blocks in fp32).  A sweep of nine shapes from
// 32 x 1 to 512 x 1 at the nine plans K1 runs, on an H100 with a build
// of this kernel that took the shape as an argument, put 64 x 2 best or
// within 0.2% of the best at every plan of 1,293 rows or more, and every
// V of 2 or 4 behind V = 1 at CASA; 64 threads with V = 1 or 2 are the
// only shapes built; the sweep ran the fp32 instance only, and the bf16
// one takes the same rule in blocks.  K1 does 2 flops an element loaded,
// so wgmma has no role, and staging through shared memory would only add
// a copy.  The kernel allocates nothing and launches on the caller's
// stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int G = 4;  // live clients whose loads are issued together
constexpr int THREADS = 64;

// One 16-byte vector of the element type: the type it is loaded as, its
// N elements, and their conversions to and from fp32.  The bf16 pairs
// are copied out of and into the loaded words with memcpy, never read
// through a pointer of another type, which C++'s aliasing rules leave
// undefined.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  using Raw = float4;
  static constexpr int N = 4;
  __device__ __forceinline__ static Raw zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ static void widen(const Raw& r, float (&f)[N]) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  __device__ __forceinline__ static Raw narrow(const float (&f)[N]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr int N = 8;
  __device__ __forceinline__ static Raw zero() {
    return make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ static void widen(const Raw& r, float (&f)[N]) {
    __nv_bfloat162 h[N / 2];
    memcpy(h, &r, sizeof(h));
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  __device__ __forceinline__ static Raw narrow(const float (&f)[N]) {
    __nv_bfloat162 h[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);  // nearest even
    Raw r;
    memcpy(&r, h, sizeof(r));
    return r;
  }
};

__device__ __forceinline__ float combine(float g, float num, float denom) {
  return g + (denom > 0.f ? num / fmaxf(denom, 1e-9f) : 0.f);
}

template <typename T, int V>
__global__ void masked_agg_kernel(const T* __restrict__ g,
                                  const T* __restrict__ d,
                                  const float* __restrict__ sel,
                                  const float* __restrict__ wc,
                                  const int32_t* __restrict__ row_unit,
                                  T* __restrict__ out,
                                  int64_t n_clients, int64_t n_units,
                                  int64_t tile, int64_t client_stride,
                                  int64_t chunks_per_row) {
  using W = Vec<T>;
  using Raw = typename W::Raw;
  constexpr int N = W::N;
  const int64_t item = blockIdx.x;
  const int64_t t = item / chunks_per_row;
  const int64_t chunk = item - t * chunks_per_row;
  const int64_t nv = tile / N;
  const int lane = threadIdx.x & 31;

  int64_t pos[V];
  bool ok[V];
  Raw gv[V];
  float acc[V][N];
  const Raw* gr = reinterpret_cast<const Raw*>(g + t * tile);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    pos[j] = (chunk * V + j) * THREADS + threadIdx.x;
    ok[j] = pos[j] < nv;
    gv[j] = ok[j] ? __ldcs(gr + pos[j]) : W::zero();
#pragma unroll
    for (int e = 0; e < N; ++e) acc[j][e] = 0.f;
  }

  const int64_t u = row_unit[t];
  const T* drow = d + t * tile;
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
      Raw x[G][V];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const Raw* p = reinterpret_cast<const Raw*>(
            drow + (base + (cl[k] < 0 ? 0 : cl[k])) * client_stride);
#pragma unroll
        for (int j = 0; j < V; ++j)
          x[k][j] = (cl[k] >= 0 && ok[j]) ? __ldcs(p + pos[j]) : W::zero();
      }
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (cl[k] < 0) break;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float f[N];
          W::widen(x[k][j], f);
#pragma unroll
          for (int e = 0; e < N; ++e) acc[j][e] = fmaf(wk[k], f[e], acc[j][e]);
        }
      }
    }
  }

  Raw* o = reinterpret_cast<Raw*>(out + t * tile);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (!ok[j]) continue;
    float gf[N], r[N];
    W::widen(gv[j], gf);
#pragma unroll
    for (int e = 0; e < N; ++e) r[e] = combine(gf[e], acc[j][e], denom);
    o[pos[j]] = W::narrow(r);
  }
}

template <typename T, int V>
cudaError_t launch(const T* g, const T* d, const float* sel, const float* wc,
                   const int32_t* row_unit, T* out, int64_t n_rows,
                   int64_t n_clients, int64_t n_units, int64_t tile,
                   int64_t client_stride, cudaStream_t stream) {
  const int64_t chunk = static_cast<int64_t>(THREADS) * V;  // vectors
  const int64_t chunks_per_row = (tile / Vec<T>::N + chunk - 1) / chunk;
  const int64_t blocks = n_rows * chunks_per_row;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  masked_agg_kernel<T, V><<<static_cast<unsigned int>(blocks), THREADS, 0,
                            stream>>>(g, d, sel, wc, row_unit, out, n_clients,
                                      n_units, tile, client_stride,
                                      chunks_per_row);
  return cudaGetLastError();
}

template <typename T>
int run(const void* g, const void* d, const void* sel, const void* wc,
        const void* row_unit, void* out, int64_t n_rows, int64_t n_clients,
        int64_t n_units, int64_t tile, int64_t client_stride, int64_t vec,
        void* stream) {
  if (n_rows == 0 || tile == 0) return 0;
  const auto* gp = static_cast<const T*>(g);
  const auto* dp = static_cast<const T*>(d);
  const auto* sp = static_cast<const float*>(sel);
  const auto* wp = static_cast<const float*>(wc);
  const auto* rp = static_cast<const int32_t*>(row_unit);
  auto* op = static_cast<T*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 1:
      return static_cast<int>(launch<T, 1>(gp, dp, sp, wp, rp, op, n_rows,
                                           n_clients, n_units, tile,
                                           client_stride, st));
    case 2:
      return static_cast<int>(launch<T, 2>(gp, dp, sp, wp, rp, op, n_rows,
                                           n_clients, n_units, tile,
                                           client_stride, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// g, out: (n_rows, tile) contiguous, of the entry point's element type;
// d: n_clients planes of (n_rows, tile) of that type, plane c at d + c *
// client_stride (in elements); sel: (n_clients, n_units) f32 contiguous;
// wc: (n_clients,) f32; row_unit: (n_rows,) int32, every entry below
// n_units.  tile and client_stride are multiples of a 16-byte vector's
// elements (4 fp32, 8 bf16) and g, d, out are 16-byte aligned (the
// Python wrapper checks all of it).  vec is 1 or 2: a block of 64 threads
// covers 64 * vec vectors of one row.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for another vec.
extern "C" int masked_agg_f32(const void* g, const void* d, const void* sel,
                              const void* wc, const void* row_unit,
                              void* out, int64_t n_rows, int64_t n_clients,
                              int64_t n_units, int64_t tile,
                              int64_t client_stride, int64_t vec,
                              void* stream) {
  return run<float>(g, d, sel, wc, row_unit, out, n_rows, n_clients, n_units,
                    tile, client_stride, vec, stream);
}

extern "C" int masked_agg_bf16(const void* g, const void* d, const void* sel,
                               const void* wc, const void* row_unit,
                               void* out, int64_t n_rows, int64_t n_clients,
                               int64_t n_units, int64_t tile,
                               int64_t client_stride, int64_t vec,
                               void* stream) {
  return run<__nv_bfloat16>(g, d, sel, wc, row_unit, out, n_rows, n_clients,
                            n_units, tile, client_stride, vec, stream);
}
