// The float64 cluster walk: one CTA a 512-ray tile, one thread a ray,
// float64 throughout (the search of RenderConfig(f64_exact=True), the
// render CLI's --d-exact).
//
// It replaces no TPU kernel: the JAX package's float64 walk
// (ceres_tpu/ops/walk_f64.py, _walk) is plain JAX, a lockstep frontier
// over chunks of tiles. Its plain PyTorch counterpart
// (ceres_tpu_torch/ops/walk_f64.py, _walk_plain) advances a chunk one
// candidate a step and reads each step's activity on the host, thousands
// of times a frame on a large mesh, so it can be neither captured nor
// fast. Here each tile walks its own sorted candidate list in one CTA
// with the plain loop's exact rule:
//     k < counts[tile]  &&  ent[tile, k] <= prune,
// prune the tile's maximum over its rays of min(best t, root exit)
// (closest) or of the root exit of its unoccluded rays (occlusion), dead
// rays counting -1, recomputed after every visit (a block reduction). A
// tile's walk is then uniform, so the barriers in the loop are safe, and
// its visits equal the plain loop's: entries ascend and the prune only
// falls, so a tile the plain loop drops never walks again.
//
// Per visit the CTA copies the cluster's weight planes to shared memory
// (K x C doubles, K = 10 for rays from a common origin: cu, cv, n, tn of
// the triangles relative to it; 16 for rays with their own origins: and
// e2, e1), and each live thread runs the plain loop's Möller-Trumbore on
// the C triangles in lane order, in its operation order. --fmad=false
// (ops/_build.py) keeps every multiply and add separately rounded, so the
// winner slots (closest: the first lane of the smallest t, kept only
// where strictly below the ray's best) and the occlusion flags are the
// plain loop's bit for bit. Modes: closest, with or without a per-ray
// [tmin, tmax] window; any (rays with their own origins, t >= 0); any_dest
// (segments from a common origin, t in [0, 1 - eps] by the window test).
//
// Bound: float64 operations. A visit is R x C ray-triangle tests of ~30
// float64 operations (the H100 runs float64 at half its float32 rate,
// outside the tensor cores), against K x C x 8 bytes of weights and two
// entries; the rays are read once. Shadow rays stop at their first
// occluder and occluded or dead rays test nothing.
//
// Built by ops/_build.py (nvcc for sm_90a, --fmad=false, a plain C
// interface bound with ctypes); launched on the caller's stream, with no
// allocation and no synchronisation, so a CUDA graph captures it.

#include <cuda_runtime.h>

namespace {

constexpr int kR = 512;        // rays a tile, one a thread
constexpr int kWarps = kR / 32;
constexpr int kMaxC = 128;     // triangles a cluster, at most
constexpr int kCommonPlanes = 10;
constexpr int kGenericPlanes = 16;
// The any_dest window's scale, 1 - _DEST_EPS (ops/walk.py), in float64 as
// the plain loop's (1.0 - _DEST_EPS) * nd takes it.
constexpr double kDestScale = 1.0 - 4e-6;

enum Mode { kClosest = 0, kAny = 1, kAnyDest = 2 };

// torch.minimum / torch.maximum: NaN propagates.
__device__ __forceinline__ double tmin(double a, double b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ double tmax(double a, double b) {
  return (a > b || a != a) ? a : b;
}

// x0 w0 + x1 w1 + x2 w2, left to right, as the plain loop's _dots.
__device__ __forceinline__ double dot3(double x0, double x1, double x2,
                                       double w0, double w1, double w2) {
  return __dadd_rn(__dadd_rn(__dmul_rn(x0, w0), __dmul_rn(x1, w1)),
                   __dmul_rn(x2, w2));
}

// The maximum of v over the CTA's rays, in every thread.
__device__ __forceinline__ double block_max(double v, double* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = tmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double m = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) m = tmax(m, red[i]);
  return m;
}

// One tile a CTA. Inputs per tile (n_c candidates, R rays): ent sorted
// ascending and order the cluster of each entry, counts the real
// entries; rays d (and o) as (R, 3); alive, tcap, tmin/tmax (WINDOW),
// occ0 (occlusion modes) per ray; w (N_c, K, C) the weight planes.
// Out: packed winner slot ids (cluster * C + lane, -1 for a miss) or
// occlusion flags, and the tile's executed visits.
template <int M, bool WINDOW, bool GENERIC>
__global__ void __launch_bounds__(kR)
    walk_f64_kernel(const double* __restrict__ ent,
                    const long long* __restrict__ order,
                    const long long* __restrict__ counts,
                    const double* __restrict__ dirs,
                    const double* __restrict__ origins,
                    const unsigned char* __restrict__ alive,
                    const double* __restrict__ tcap,
                    const double* __restrict__ tlo,
                    const double* __restrict__ thi,
                    const int* __restrict__ occ0,
                    const double* __restrict__ w, int* __restrict__ out,
                    long long* __restrict__ visits, int n_c, int C) {
  constexpr int K = GENERIC ? kGenericPlanes : kCommonPlanes;
  __shared__ double planes[K * kMaxC];
  __shared__ double red[kWarps];
  const long long tile = blockIdx.x;
  const long long ray = tile * kR + threadIdx.x;
  const double d0 = dirs[3 * ray], d1 = dirs[3 * ray + 1],
               d2 = dirs[3 * ray + 2];
  double o0 = 0.0, o1 = 0.0, o2 = 0.0, c0 = 0.0, c1 = 0.0, c2 = 0.0;
  if (GENERIC) {
    o0 = origins[3 * ray];
    o1 = origins[3 * ray + 1];
    o2 = origins[3 * ray + 2];
    // d x o, as the plain loop's _cross(d, o).
    c0 = __dsub_rn(__dmul_rn(d1, o2), __dmul_rn(d2, o1));
    c1 = __dsub_rn(__dmul_rn(d2, o0), __dmul_rn(d0, o2));
    c2 = __dsub_rn(__dmul_rn(d0, o1), __dmul_rn(d1, o0));
  }
  const bool live = alive[ray] != 0;
  const double cap = live ? tcap[ray] : -1.0;
  double lo = 0.0, hi = 0.0;
  if (WINDOW) {
    lo = tlo[ray];
    hi = thi[ray];
  }
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  double best = inf;
  long long slot = -1;
  bool occ = false;
  if (M != kClosest) occ = occ0[ray] > 0;

  const long long count = counts[tile];
  const double* ent_t = ent + tile * n_c;
  const long long* order_t = order + tile * n_c;
  long long k = 0;
  for (;; ++k) {
    const double mine = M == kClosest ? tmin(best, cap) : (occ ? -1.0 : cap);
    const double prune = block_max(mine, red);
    if (!(k < count && ent_t[k] <= prune)) break;
    const long long cid = order_t[k];
    const double* wc = w + cid * K * C;
    for (int i = threadIdx.x; i < K * C; i += kR) planes[i] = wc[i];
    __syncthreads();
    if (live && !(M != kClosest && occ)) {
      for (int j = 0; j < C; ++j) {
        const double* p = planes + j;
        double nu = dot3(d0, d1, d2, p[0 * C], p[1 * C], p[2 * C]);
        double nv = dot3(d0, d1, d2, p[3 * C], p[4 * C], p[5 * C]);
        const double nd = dot3(d0, d1, d2, p[6 * C], p[7 * C], p[8 * C]);
        double nt = p[9 * C];
        if (GENERIC) {
          nu = __dsub_rn(nu, dot3(c0, c1, c2, p[13 * C], p[14 * C],
                                  p[15 * C]));
          nv = __dsub_rn(nv, dot3(c0, c1, c2, p[10 * C], p[11 * C],
                                  p[12 * C]));
          nt = __dsub_rn(nt, dot3(o0, o1, o2, p[6 * C], p[7 * C], p[8 * C]));
        }
        const double s = nd >= 0.0 ? 1.0 : -1.0;
        const double uvw =
            tmin(tmin(__dmul_rn(nu, s), __dmul_rn(nv, s)),
                 __dmul_rn(__dsub_rn(__dsub_rn(nd, nu), nv), s));
        bool ok;
        if (M == kAnyDest) {
          const double far = __dsub_rn(nt, __dmul_rn(kDestScale, nd));
          const bool win = __dmul_rn(far, s) <= 0.0 && __dmul_rn(nt, s) >= 0.0;
          ok = uvw >= 0.0 && nd != 0.0 && win;
        } else {
          ok = tmin(uvw, __dmul_rn(nt, s)) >= 0.0 && nd != 0.0;
        }
        if (M == kClosest) {
          if (ok) {
            const double t = __ddiv_rn(nt, nd);
            if ((!WINDOW || (t >= lo && t <= hi)) && t < best) {
              best = t;
              slot = cid * C + j;
            }
          }
        } else if (ok) {
          occ = true;
          break;
        }
      }
    }
  }
  out[ray] = M == kClosest ? static_cast<int>(slot) : (occ ? 1 : 0);
  if (threadIdx.x == 0) visits[tile] = k;
}

template <int M, bool WINDOW, bool GENERIC>
cudaError_t launch(const double* ent, const long long* order,
                   const long long* counts, const double* dirs,
                   const double* origins, const unsigned char* alive,
                   const double* tcap, const double* tlo, const double* thi,
                   const int* occ0, const double* w, int* out,
                   long long* visits, int n_tiles, int n_c, int C,
                   cudaStream_t stream) {
  walk_f64_kernel<M, WINDOW, GENERIC><<<n_tiles, kR, 0, stream>>>(
      ent, order, counts, dirs, origins, alive, tcap, tlo, thi, occ0, w, out,
      visits, n_c, C);
  return cudaGetLastError();
}

}  // namespace

// One launch of the float64 walk: mode 0 closest (window: tmin and tmax
// given), 1 any (origins given), 2 any_dest; returns a cudaError_t, or
// cudaErrorInvalidValue for a mode, origins or cluster size it does not
// take. n_tiles CTAs of 512 threads.
extern "C" int ceres_walk_f64(const double* ent, const long long* order,
                              const long long* counts, const double* dirs,
                              const double* origins,
                              const unsigned char* alive, const double* tcap,
                              const double* tlo, const double* thi,
                              const int* occ0, const double* w, int* out,
                              long long* visits, int n_tiles, int n_c, int C,
                              int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C < 1 || C > kMaxC || n_tiles < 0) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kClosest && origins == nullptr && tlo == nullptr) {
    err = launch<kClosest, false, false>(ent, order, counts, dirs, origins,
                                        alive, tcap, tlo, thi, occ0, w, out,
                                        visits, n_tiles, n_c, C, st);
  } else if (mode == kClosest && origins == nullptr && tlo != nullptr &&
             thi != nullptr) {
    err = launch<kClosest, true, false>(ent, order, counts, dirs, origins,
                                       alive, tcap, tlo, thi, occ0, w, out,
                                       visits, n_tiles, n_c, C, st);
  } else if (mode == kAny && origins != nullptr && occ0 != nullptr) {
    err = launch<kAny, false, true>(ent, order, counts, dirs, origins, alive,
                                   tcap, tlo, thi, occ0, w, out, visits,
                                   n_tiles, n_c, C, st);
  } else if (mode == kAnyDest && origins == nullptr && occ0 != nullptr) {
    err = launch<kAnyDest, false, false>(ent, order, counts, dirs, origins,
                                        alive, tcap, tlo, thi, occ0, w, out,
                                        visits, n_tiles, n_c, C, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* ceres_walk_f64_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
