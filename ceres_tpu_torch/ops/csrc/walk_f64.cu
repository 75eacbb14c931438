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
// The walk's input, each tile's sorted candidate list, comes from the
// float64 prepass kernel further down (prepass_f64_kernel): the slab test
// of every (tile, cluster) pair, the survivors compacted and sorted in
// the same CTA, in place of some forty whole-tensor float64 passes, a
// stable argsort of every pair and its gathers (ops/walk_f64.py,
// _prepass_plain).
//
// Built by ops/_build.py (nvcc for sm_90a, --fmad=false, a plain C
// interface bound with ctypes); launched on the caller's stream, with no
// allocation and no synchronisation, so a CUDA graph captures them.

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

// ---------------------------------------------------------------------------
// The float64 prepass: one CTA a tile.
//
// It replaces no TPU kernel: the JAX package's float64 prepass
// (ceres_tpu/ops/walk_f64.py, _prepass) is plain JAX, which XLA fuses;
// its plain PyTorch counterpart (ops/walk_f64.py, _prepass_plain) runs
// the slab test as ~40 whole-tensor float64 passes over every (tile,
// cluster) pair, then a stable argsort of all of them, though ~0.1% of
// the pairs survive on a large mesh. Here a CTA takes one tile and:
//   1. slab-tests every cluster box against the tile's ray hull as
//      prepass._interval_entry does, operation for operation, with
//      IEEE division in _safe_inverse and the signed-zero min and max of
//      utils/minmax.py (the entry of a tile with no alive ray is _BIG);
//   2. compacts the survivors (entry < _VALID_CUT) in cluster order by a
//      block-wide prefix count of ballots, no atomics; the others go to
//      the row's tail from its end backward, as (_BIG, their id);
//   3. sorts the survivors by (entry bits, cluster id). An entry is +0
//      or positive, so its bits order like its value, and the id breaks
//      ties toward the lower cluster: the order of a stable sort by
//      entry, which torch.argsort(stable=True) gives the plain version.
//      The keys are distinct, so a bitonic network (all comparators
//      ascending, the first step of each merge mirrored, indices past the
//      count standing for +inf and never touched) gives that one order.
//      Up to kSortCap survivors sort in shared memory; a row beyond it
//      sorts in place in its own row of the outputs, which always has n_c
//      slots: chunks of kSortCap sorted in shared memory, then each merge
//      level's strides of kSortCap and more in device memory and the rest
//      again chunk by chunk in shared memory.
// The rows up to counts[tile] equal the plain version's bit for bit; the
// tail holds _BIG and the other clusters' ids, so that every row of
// order is a permutation of the clusters, as the plain version's is.
//
// Bound: bytes. A pair is ~40 float64 operations (~46 with an origin
// hull), against 16 bytes of outputs a pair written once; the boxes are
// read from L2 by every CTA.

constexpr int kPrepassThreads = 256;
constexpr int kPrepassWarps = kPrepassThreads / 32;
constexpr int kSortCap = 2048;      // survivors a tile sorted in shared memory
constexpr double kBig = 3.0e37;     // prepass._BIG
constexpr double kValidCut = 1.0e37;  // prepass._VALID_CUT
constexpr double kInvClamp = 1e30;  // prepass._INV_CLAMP
constexpr double kUlpPad = 4e-6;    // prepass._ULP_PAD

// utils/minmax.py's fmax and fmin (XLA's signed zeros), NaN propagating
// as torch.maximum and torch.minimum do.
__device__ __forceinline__ double xla_max(double a, double b) {
  return (a == 0.0 && b == 0.0) ? __dadd_rn(a, b) : tmax(a, b);
}
__device__ __forceinline__ double xla_min(double a, double b) {
  return (a == 0.0 && b == 0.0) ? -__dadd_rn(-a, -b) : tmin(a, b);
}

// prepass._safe_inverse.
__device__ __forceinline__ double safe_inverse(double d) {
  const double sign = d >= 0.0 ? 1.0 : -1.0;
  return fabs(d) < 1e-30 ? __dmul_rn(sign, kInvClamp) : __ddiv_rn(1.0, d);
}

// prepass._interval_entry of one box for a tile whose hull constants are
// inv (1/dlo by axis, then 1/dhi), org (olo, then ohi; GENERIC only) and
// straddle.
template <bool GENERIC>
__device__ __forceinline__ double interval_entry(const double* lo,
                                                 const double* hi,
                                                 const double* inv,
                                                 const double* org,
                                                 const bool* straddle) {
  double tn = 0.0, tf = 0.0;
  bool empty = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    double la = lo[a], ha = hi[a];
    empty = empty || ha < la;
    if (GENERIC) {
      la = __dsub_rn(la, org[3 + a]);
      ha = __dsub_rn(ha, org[a]);
    }
    const double c0 = __dmul_rn(la, inv[a]), c1 = __dmul_rn(la, inv[3 + a]);
    const double c2 = __dmul_rn(ha, inv[a]), c3 = __dmul_rn(ha, inv[3 + a]);
    double emin = xla_min(xla_min(c0, c1), xla_min(c2, c3));
    double emax = xla_max(xla_max(c0, c1), xla_max(c2, c3));
    if (straddle[a]) {
      emin = -kBig;
      emax = kBig;
    }
    tn = a == 0 ? emin : xla_max(tn, emin);
    tf = a == 0 ? emax : xla_min(tf, emax);
  }
  tn = xla_max(tn, 0.0);
  const bool hit = __dmul_rn(tn, 1.0 - kUlpPad) <=
                   __dmul_rn(tmin(tf, kBig), 1.0 + kUlpPad);
  return hit && !empty ? tn : kBig;
}

// The sort's order: (entry bits, cluster id), lexicographic.
__device__ __forceinline__ bool sorts_before(unsigned long long ka,
                                             long long ia,
                                             unsigned long long kb,
                                             long long ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// One comparator of the sort: (key, id) pairs at i < l put in ascending
// order.
__device__ __forceinline__ void order_pair(unsigned long long* key, int* id,
                                           int i, int l) {
  const unsigned long long a = key[i], b = key[l];
  const int ia = id[i], ib = id[l];
  if (sorts_before(b, ib, a, ia)) {
    key[i] = b;
    key[l] = a;
    id[i] = ib;
    id[l] = ia;
  }
}

// The comparator of the pair's index p in one step of the network over
// P = 2^m slots: step j of merge level k (j = k / 2 mirrors the k-block,
// i against i ^ (k - 1); smaller j pairs i with i + j). Returns (i, l).
__device__ __forceinline__ int2 network_pair(int p, int k, int j) {
  const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
  return make_int2(i, j == k / 2 ? i ^ (k - 1) : i + j);
}

__device__ __forceinline__ int ceil_pow2(int n) {
  int P = 1;
  while (P < n) P <<= 1;
  return P;
}

// Steps j = from, from / 2, ..., 1 of merge level k on the n slots in
// shared memory (from = k / 2: the whole level).
__device__ void network_steps_shared(unsigned long long* key, int* id, int n,
                                     int k, int from) {
  const int pairs = ceil_pow2(n) / 2;
  for (int j = from; j > 0; j >>= 1) {
    for (int p = threadIdx.x; p < pairs; p += kPrepassThreads) {
      const int2 il = network_pair(p, k, j);
      if (il.y < n) order_pair(key, id, il.x, il.y);
    }
    __syncthreads();
  }
}

// Sorts the n <= kSortCap slots in shared memory.
__device__ void sort_shared(unsigned long long* key, int* id, int n) {
  const int P = ceil_pow2(n);
  for (int k = 2; k <= P; k <<= 1) network_steps_shared(key, id, n, k, k / 2);
}

// Sorts the n > kSortCap survivors in a row of the outputs in place, with
// the CTA's shared arrays as the chunk buffer.
__device__ void sort_row(double* ent, long long* order, int n,
                         unsigned long long* key, int* id) {
  // Run fn on each chunk of kSortCap slots, loaded into shared memory
  // and stored back.
  auto chunks = [&](auto fn) {
    for (int c0 = 0; c0 < n; c0 += kSortCap) {
      const int m = min(kSortCap, n - c0);
      for (int i = threadIdx.x; i < m; i += kPrepassThreads) {
        key[i] = static_cast<unsigned long long>(
            __double_as_longlong(ent[c0 + i]));
        id[i] = static_cast<int>(order[c0 + i]);
      }
      __syncthreads();
      fn(m);
      for (int i = threadIdx.x; i < m; i += kPrepassThreads) {
        ent[c0 + i] = __longlong_as_double(static_cast<long long>(key[i]));
        order[c0 + i] = id[i];
      }
      __syncthreads();
    }
  };
  chunks([&](int m) { sort_shared(key, id, m); });
  const int P = ceil_pow2(n);
  for (int k = 2 * kSortCap; k <= P; k <<= 1) {
    for (int j = k / 2; j >= kSortCap; j >>= 1) {
      for (int p = threadIdx.x; p < P / 2; p += kPrepassThreads) {
        const int2 il = network_pair(p, k, j);
        if (il.y >= n) continue;
        const double a = ent[il.x], b = ent[il.y];
        const long long ia = order[il.x], ib = order[il.y];
        if (sorts_before(__double_as_longlong(b), ib, __double_as_longlong(a),
                         ia)) {
          ent[il.x] = b;
          ent[il.y] = a;
          order[il.x] = ib;
          order[il.y] = ia;
        }
      }
      __syncthreads();
    }
    chunks([&](int m) {
      network_steps_shared(key, id, m, k, kSortCap / 2);
    });
  }
}

// One tile a CTA. Inputs: lo, hi (n_c, 3) the cluster boxes relative to
// the rays' shift; dlo, dhi (n_t, 3) each tile's direction hull; olo, ohi
// (n_t, 3) its origin hull (GENERIC: rays with their own origins, which
// are relative to the shift); live (n_t,) whether the tile has an alive
// ray. Out: the tile's rows of ent and order (n_t, n_c) and its count.
template <bool GENERIC>
__global__ void __launch_bounds__(kPrepassThreads)
    prepass_f64_kernel(const double* __restrict__ lo,
                       const double* __restrict__ hi,
                       const double* __restrict__ dlo,
                       const double* __restrict__ dhi,
                       const double* __restrict__ olo,
                       const double* __restrict__ ohi,
                       const unsigned char* __restrict__ live,
                       double* __restrict__ ent, long long* __restrict__ order,
                       long long* __restrict__ counts, int n_c) {
  __shared__ unsigned long long key[kSortCap];
  __shared__ int id[kSortCap];
  __shared__ int warp_kept[kPrepassWarps];
  __shared__ double inv[6], org[6];
  __shared__ bool straddle[3];
  const long long tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < 3) {
    const int a = threadIdx.x;
    const double d0 = dlo[3 * tile + a], d1 = dhi[3 * tile + a];
    inv[a] = safe_inverse(d0);
    inv[3 + a] = safe_inverse(d1);
    straddle[a] = d0 < 0.0 && d1 > 0.0;
    if (GENERIC) {
      org[a] = olo[3 * tile + a];
      org[3 + a] = ohi[3 * tile + a];
    }
  }
  __syncthreads();
  const bool any_live = live[tile] != 0;
  double* ent_t = ent + tile * n_c;
  long long* order_t = order + tile * n_c;

  int kept = 0;  // survivors in the clusters before this round's
  for (int base = 0; base < n_c; base += kPrepassThreads) {
    const int c = base + threadIdx.x;
    double e = kBig;
    if (c < n_c && any_live)
      e = interval_entry<GENERIC>(lo + 3 * c, hi + 3 * c, inv, org, straddle);
    const bool keep = c < n_c && e < kValidCut;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_kept[warp] = __popc(ballot);
    __syncthreads();
    int before = kept + __popc(ballot & ((1u << lane) - 1u)), round = 0;
#pragma unroll
    for (int w = 0; w < kPrepassWarps; ++w) {
      before += w < warp ? warp_kept[w] : 0;
      round += warp_kept[w];
    }
    if (keep) {
      if (before < kSortCap) {
        key[before] = static_cast<unsigned long long>(__double_as_longlong(e));
        id[before] = c;
      } else {
        ent_t[before] = e;
        order_t[before] = c;
      }
    } else if (c < n_c) {
      // c - before clusters before this one did not survive.
      const int slot = n_c - 1 - (c - before);
      ent_t[slot] = kBig;
      order_t[slot] = c;
    }
    kept += round;
    __syncthreads();
  }
  if (threadIdx.x == 0) counts[tile] = kept;
  if (kept <= kSortCap) {
    sort_shared(key, id, kept);
    for (int i = threadIdx.x; i < kept; i += kPrepassThreads) {
      ent_t[i] = __longlong_as_double(static_cast<long long>(key[i]));
      order_t[i] = id[i];
    }
    return;
  }
  for (int i = threadIdx.x; i < kSortCap; i += kPrepassThreads) {
    ent_t[i] = __longlong_as_double(static_cast<long long>(key[i]));
    order_t[i] = id[i];
  }
  __syncthreads();
  sort_row(ent_t, order_t, kept, key, id);
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

// One launch of the float64 prepass: origin hulls olo and ohi given for
// rays with their own origins, else both null; returns a cudaError_t, or
// cudaErrorInvalidValue for hulls it does not take. n_tiles CTAs of 256
// threads.
extern "C" int ceres_prepass_f64(const double* lo, const double* hi,
                                 const double* dlo, const double* dhi,
                                 const double* olo, const double* ohi,
                                 const unsigned char* live, double* ent,
                                 long long* order, long long* counts,
                                 int n_tiles, int n_c, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles < 0 || n_c < 1 || (olo == nullptr) != (ohi == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (olo != nullptr) {
    prepass_f64_kernel<true><<<n_tiles, kPrepassThreads, 0, st>>>(
        lo, hi, dlo, dhi, olo, ohi, live, ent, order, counts, n_c);
  } else {
    prepass_f64_kernel<false><<<n_tiles, kPrepassThreads, 0, st>>>(
        lo, hi, dlo, dhi, olo, ohi, live, ent, order, counts, n_c);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ceres_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
