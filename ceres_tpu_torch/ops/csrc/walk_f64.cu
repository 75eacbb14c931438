// The float64 cluster walk: each 512-ray tile on a thread-block cluster of
// kK CTAs, one thread a ray in every CTA, float64 throughout (the search
// of RenderConfig(f64_exact=True), the render CLI's --d-exact); on short
// rows one CTA a tile (below).
//
// It replaces no TPU kernel: the JAX package's float64 walk
// (ceres_tpu/ops/walk_f64.py, _walk) is plain JAX, a lockstep frontier
// over chunks of tiles. Its plain PyTorch counterpart
// (ceres_tpu_torch/ops/walk_f64.py, _walk_plain) advances a chunk one
// candidate a step and reads each step's activity on the host, thousands
// of times a frame on a large mesh, so it can be neither captured nor
// fast. Here each tile walks its own sorted candidate list with the plain
// loop's exact rule:
//     k < counts[tile]  &&  ent[tile, k] <= prune,
// prune the tile's maximum over its rays of min(best t, root exit)
// (closest) or of the root exit of its unoccluded rays (occlusion), dead
// rays counting -1, renewed after every visit. Entries ascend and the
// prune only falls, so a tile the rule stops never walks again.
//
// A visit: the cluster's weight planes in shared memory (P x C doubles,
// P = 10 for rays from a common origin: cu, cv, n, tn of the triangles
// relative to it; 16 for rays with their own origins: and e2, e1), and
// each live thread runs the plain loop's Möller-Trumbore on the C
// triangles in lane order, in its operation order. --fmad=false
// (utils/native.py) keeps every multiply and add separately rounded, so
// the outcomes are the plain loop's bit for bit: closest, the first lane
// of the smallest t (inside the ray's [tmin, tmax] window where given),
// kept only where strictly below the ray's best; any (rays with their own
// origins, t >= 0) and any_dest (segments from a common origin, t in [0,
// 1 - eps] by the window test), the occlusion flag.
//
// Bound: float64 operations. A visit is R x C ray-triangle tests of ~30
// float64 operations (the H100 runs float64 at half its float32 rate,
// outside the tensor cores), ~3.4 us of one SM's peak at 512 x 64,
// against P x C x 8 bytes of weights and two entries; the rays are read
// once. A tile's walk is a chain of visits, each a CTA's whole work, and
// a frame waits for its longest chain: on the 4x bunny's 1080p closest
// walk a tile whose ray hull straddles an axis makes 2,625 visits (of
// 17,007 candidates) while the mean walking tile makes ~36, and one CTA
// a tile left that chain on one SM for ~71 ms, ~27 us a visit, while the
// others idled (PERF.md).
//
// So the chain itself is cut: the walk goes in rounds of kK candidates.
// In the round from k0, CTA c visits candidate k0 + c (staged with
// cp.async during the round before, into the other of two plane buffers)
// for all the tile's rays, where the round's opening prune admits it, and
// publishes each ray's outcome in its shared memory (a ballot word a warp
// of which rays it hit; closest, each ray's t and slot too), two buffers
// for alternate rounds. After a cluster barrier every CTA reads the kK
// outcomes of its rays from the others' shared memory (distributed shared
// memory) and replays the plain rule over the round's candidates in
// order: per ray the running best (strict <, so an equal t keeps the
// earlier candidate) or the running OR of the flag; after candidate j the
// bit "this ray's part of the prune admits candidate j + 1"; a block
// reduction ORs the bits over the rays and takes the prune after the
// whole round. The walk ends at the first candidate no ray admits:
// outcomes past it are dropped and not counted (a closest outcome past
// the plain stop can hold a hit that the plain loop never sees), so the
// winner slots, flags and each tile's visits are the plain loop's. Within
// a walk nothing is NaN (a NaN root exit makes the opening prune NaN, and
// that tile walks nothing), so "some ray's part >= entry" is "entry <=
// prune". Every CTA holds every ray's state and merges the same outcomes
// in the same order, so all reach the same stop: the trip count is
// uniform and the barriers are safe. A tile whose opening prune admits
// nothing returns before any cluster barrier. The only work beyond the
// plain loop's is at most kK - 1 dropped visits at the end of a tile's
// walk. kK is a constant, from the card's times (PERF.md).
//
// A row of n_c candidates chains at most n_c visits. Where rows are short
// the chains are too, and a cluster's CTAs that wait on the others'
// visits cost more than the chains they cut, so the caller asks for the
// form by the row length (ops/walk_f64.py, _SOLO_ROW): the same body at
// K = 1, one CTA a tile, exchanges nothing.
//
// The walk's input, each tile's sorted candidate list, comes from the
// float64 prepass kernel further down (prepass_f64_kernel): the slab test
// of every (tile, cluster) pair, the survivors compacted and sorted in
// the same CTA, in place of some forty whole-tensor float64 passes, a
// stable argsort of every pair and its gathers (ops/walk_f64.py,
// _prepass_plain).
//
// Built by utils/native.py (nvcc for sm_90a, --fmad=false, a plain C
// interface bound with ctypes); launched on the caller's stream, with no
// allocation and no synchronisation, so a CUDA graph captures them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kR = 512;        // rays a tile, one a thread
constexpr int kWarps = kR / 32;
constexpr int kMaxC = 128;     // triangles a cluster, at most
constexpr int kCommonPlanes = 10;
constexpr int kGenericPlanes = 16;
constexpr int kK = 8;          // CTAs a tile's cluster: candidates a round
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

// Copy n doubles from global src to shared dst with cp.async (8 bytes a
// copy, so any cluster size and offset), as one group.
__device__ __forceinline__ void stage_async(double* dst, const double* src,
                                            int n) {
  for (int i = threadIdx.x; i < n; i += kR) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(
                        dst + i))),
                    "l"(src + i) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// What a CTA keeps in shared memory (P weight planes a cluster, K CTAs a
// cluster).
template <int P, int K>
struct WalkShared {
  static constexpr int kX = K > 1 ? kR : 1;  // no exchange on one CTA
  // The planes of this CTA's candidate: one round's visit reads one
  // buffer while the next round's candidate is copied into the other.
  double planes[2][P * kMaxC];
  // This CTA's outcome of a round, which the cluster's CTAs read; rounds
  // alternate between the two buffers. hit: a bit a ray, a word a warp;
  // closest, each ray's smallest t and its packed slot id.
  double t[2][kX];
  int slot[2][kX];
  unsigned hit[2][kWarps];
  // The block reductions'.
  double red[kWarps];
  unsigned red_bits[kWarps];
};

// One tile on a cluster of K CTAs (K = 1: one CTA, no exchange). Inputs
// per tile (n_c candidates, R rays): ent sorted ascending and order the
// cluster of each entry, counts the real entries; rays d (and o) as (R,
// 3); alive, tcap, tmin/tmax (WINDOW), occ0 (occlusion modes) per ray; w
// (N_c, P, C) the weight planes. Out: packed winner slot ids (cluster * C
// + lane, -1 for a miss) or occlusion flags, and the tile's executed
// visits.
template <int M, bool WINDOW, bool GENERIC, int K>
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
  static_assert(K == 1 || K == 2 || K == 4 || K == 8,
                "one CTA or a portable cluster size");
  constexpr int P = GENERIC ? kGenericPlanes : kCommonPlanes;
  constexpr bool kOcc = M != kClosest;
  __shared__ WalkShared<P, K> sh;
  const int rank = K > 1 ? static_cast<int>(cg::this_cluster().block_rank())
                         : 0;
  const long long tile = blockIdx.x / K;
  const long long ray = tile * kR + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool live = alive[ray] != 0;
  const double cap = live ? tcap[ray] : -1.0;
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  double best = inf;
  int slot = -1;
  bool occ = false;
  if (kOcc) occ = occ0[ray] > 0;
  // This ray's part of the prune.
  auto part = [&](double b, bool o) {
    return kOcc ? (o ? -1.0 : cap) : tmin(b, cap);
  };

  const long long count = counts[tile];
  const double* ent_t = ent + tile * n_c;
  const long long* order_t = order + tile * n_c;
  const int span = P * C;  // doubles of a cluster's planes
  double prune = block_max(part(best, occ), sh.red);
  long long nvis = 0;
  if (count > 0 && ent_t[0] <= prune) {
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
    double lo = 0.0, hi = 0.0;
    if (WINDOW) {
      lo = tlo[ray];
      hi = thi[ray];
    }
    if (rank < count && ent_t[rank] <= prune)
      stage_async(sh.planes[0], w + order_t[rank] * span, span);
    for (long long k0 = 0, r = 0;; k0 += K, ++r) {
      // Round r: candidates k0 .. k0 + K - 1, this CTA's k0 + rank.
      const int b = static_cast<int>(r & 1);
      const long long k = k0 + rank;
      const bool go = k < count && ent_t[k] <= prune;
      wait_async();
      __syncthreads();  // its planes are in; the other buffer is free
      if (k + K < count && ent_t[k + K] <= prune)
        stage_async(sh.planes[b ^ 1], w + order_t[k + K] * span, span);

      // The visit: this ray's outcome of candidate k.
      double ct = inf;
      int cslot = -1;
      bool hit = false;
      if (go && live && !(kOcc && occ)) {
        const long long cid = order_t[k];
        const double* pl = sh.planes[b];
        for (int j = 0; j < C; ++j) {
          const double* p = pl + j;
          double nu = dot3(d0, d1, d2, p[0 * C], p[1 * C], p[2 * C]);
          double nv = dot3(d0, d1, d2, p[3 * C], p[4 * C], p[5 * C]);
          const double nd = dot3(d0, d1, d2, p[6 * C], p[7 * C], p[8 * C]);
          double nt = p[9 * C];
          if (GENERIC) {
            nu = __dsub_rn(nu, dot3(c0, c1, c2, p[13 * C], p[14 * C],
                                    p[15 * C]));
            nv = __dsub_rn(nv, dot3(c0, c1, c2, p[10 * C], p[11 * C],
                                    p[12 * C]));
            nt = __dsub_rn(nt, dot3(o0, o1, o2, p[6 * C], p[7 * C],
                                    p[8 * C]));
          }
          const double s = nd >= 0.0 ? 1.0 : -1.0;
          const double uvw =
              tmin(tmin(__dmul_rn(nu, s), __dmul_rn(nv, s)),
                   __dmul_rn(__dsub_rn(__dsub_rn(nd, nu), nv), s));
          bool ok;
          if (M == kAnyDest) {
            const double far = __dsub_rn(nt, __dmul_rn(kDestScale, nd));
            const bool win =
                __dmul_rn(far, s) <= 0.0 && __dmul_rn(nt, s) >= 0.0;
            ok = uvw >= 0.0 && nd != 0.0 && win;
          } else {
            ok = tmin(uvw, __dmul_rn(nt, s)) >= 0.0 && nd != 0.0;
          }
          if (M == kClosest) {
            if (ok) {
              const double t = __ddiv_rn(nt, nd);
              if ((!WINDOW || (t >= lo && t <= hi)) && t < ct) {
                ct = t;
                cslot = static_cast<int>(cid * C + j);
              }
            }
          } else if (ok) {
            hit = true;
            break;
          }
        }
        if (M == kClosest) hit = cslot >= 0;
      }

      // The round's outcomes of this ray: bit j of hits, candidate k0 + j
      // hit it (closest: with t tj[j] at slot sj[j]).
      unsigned hits = hit ? 1u : 0u;
      double tj[K];
      int sj[K];
      if constexpr (K == 1) {
        tj[0] = ct;
        sj[0] = cslot;
      } else {
        cg::cluster_group cluster = cg::this_cluster();
        const unsigned word = __ballot_sync(0xffffffffu, hit);
        if (lane == 0) sh.hit[b][warp] = word;
        if (!kOcc) {
          sh.t[b][threadIdx.x] = ct;
          sh.slot[b][threadIdx.x] = cslot;
        }
        cluster.sync();  // every CTA's outcomes are in
        unsigned mine = 0;
        if (lane < K) mine = *cluster.map_shared_rank(&sh.hit[b][warp], lane);
        hits = 0;
#pragma unroll
        for (int j = 0; j < K; ++j)
          hits |= ((__shfl_sync(0xffffffffu, mine, j) >> lane) & 1u) << j;
        if (!kOcc) {
#pragma unroll
          for (int j = 0; j < K; ++j) {
            if ((hits >> j) & 1u) {
              tj[j] = *cluster.map_shared_rank(&sh.t[b][threadIdx.x], j);
              sj[j] = *cluster.map_shared_rank(&sh.slot[b][threadIdx.x], j);
            }
          }
        }
      }

      // The plain rule over the round's candidates in order: bit j + 1 of
      // admit, this ray's part after candidates k0 .. k0 + j admits
      // candidate k0 + j + 1.
      double rbest = best;
      int rslot = slot;
      bool rocc = occ;
      unsigned admit = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if ((hits >> j) & 1u) {
          if (kOcc) {
            rocc = true;
          } else if (tj[j] < rbest) {
            rbest = tj[j];
            rslot = sj[j];
          }
        }
        if (j + 1 < K && k0 + j + 1 < count &&
            part(rbest, rocc) >= ent_t[k0 + j + 1])
          admit |= 1u << (j + 1);
      }
      // Over the tile's rays: the prune after the whole round, and which
      // candidates the rule admits.
      double m = part(rbest, rocc);
      for (int off = 16; off > 0; off >>= 1)
        m = tmax(m, __shfl_xor_sync(0xffffffffu, m, off));
      admit = __reduce_or_sync(0xffffffffu, admit);
      if (lane == 0) {
        sh.red[warp] = m;
        sh.red_bits[warp] = admit;
      }
      __syncthreads();
      m = sh.red[0];
      admit = sh.red_bits[0];
#pragma unroll
      for (int i = 1; i < kWarps; ++i) {
        m = tmax(m, sh.red[i]);
        admit |= sh.red_bits[i];
      }
      // Visited: candidates k0 .. k0 + n - 1, up to the first one not
      // admitted.
      const unsigned stops = ~admit & ((1u << K) - 2u);
      const int n = stops ? __ffs(static_cast<int>(stops)) - 1 : K;
      nvis += n;
      if (n < K) {  // the walk ends inside the round: drop the rest
#pragma unroll
        for (int j = 0; j < K; ++j) {
          if (j < n && ((hits >> j) & 1u)) {
            if (kOcc) {
              occ = true;
            } else if (tj[j] < best) {
              best = tj[j];
              slot = sj[j];
            }
          }
        }
        break;
      }
      best = rbest;
      slot = rslot;
      occ = rocc;
      prune = m;
      if (!(k0 + K < count && ent_t[k0 + K] <= prune)) break;
    }
    wait_async();  // drain a copy left behind
    // No CTA leaves while another may still read its outcomes.
    if constexpr (K > 1) cg::this_cluster().sync();
  }
  if (rank == 0) {
    out[ray] = kOcc ? (occ ? 1 : 0) : slot;
    if (threadIdx.x == 0) visits[tile] = nvis;
  }
}

// Launch walk_f64_kernel on n_tiles clusters of K CTAs (K = 1: n_tiles
// CTAs, no cluster).
template <int M, bool WINDOW, bool GENERIC, int K>
cudaError_t launch_k(const double* ent, const long long* order,
                     const long long* counts, const double* dirs,
                     const double* origins, const unsigned char* alive,
                     const double* tcap, const double* tlo, const double* thi,
                     const int* occ0, const double* w, int* out,
                     long long* visits, int n_tiles, int n_c, int C,
                     cudaStream_t stream) {
  const auto kernel = walk_f64_kernel<M, WINDOW, GENERIC, K>;
  if (K == 1) {
    kernel<<<n_tiles, kR, 0, stream>>>(ent, order, counts, dirs, origins,
                                       alive, tcap, tlo, thi, occ0, w, out,
                                       visits, n_c, C);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = K;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * K);
  cfg.blockDim = dim3(kR);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, ent, order, counts, dirs, origins, alive, tcap, tlo, thi,
      occ0, w, out, visits, n_c, C);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The cluster form (kK CTAs a tile) or one CTA a tile.
template <int M, bool WINDOW, bool GENERIC>
cudaError_t launch(const double* ent, const long long* order,
                   const long long* counts, const double* dirs,
                   const double* origins, const unsigned char* alive,
                   const double* tcap, const double* tlo, const double* thi,
                   const int* occ0, const double* w, int* out,
                   long long* visits, int n_tiles, int n_c, int C,
                   bool cluster, cudaStream_t stream) {
  return cluster ? launch_k<M, WINDOW, GENERIC, kK>(
                       ent, order, counts, dirs, origins, alive, tcap, tlo,
                       thi, occ0, w, out, visits, n_tiles, n_c, C, stream)
                 : launch_k<M, WINDOW, GENERIC, 1>(
                       ent, order, counts, dirs, origins, alive, tcap, tlo,
                       thi, occ0, w, out, visits, n_tiles, n_c, C, stream);
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
// given), 1 any (origins given), 2 any_dest; cluster 1 for the cluster
// form (n_tiles clusters of kK CTAs of 512 threads), 0 for one CTA a tile
// (the caller's choice by the row length, ops/walk_f64.py); returns a
// cudaError_t, or cudaErrorInvalidValue for a mode, origins or cluster
// size it does not take.
extern "C" int ceres_walk_f64(const double* ent, const long long* order,
                              const long long* counts, const double* dirs,
                              const double* origins,
                              const unsigned char* alive, const double* tcap,
                              const double* tlo, const double* thi,
                              const int* occ0, const double* w, int* out,
                              long long* visits, int n_tiles, int n_c, int C,
                              int mode, int cluster, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C < 1 || C > kMaxC || n_tiles < 0 || cluster < 0 || cluster > 1)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kClosest && origins == nullptr && tlo == nullptr) {
    err = launch<kClosest, false, false>(ent, order, counts, dirs, origins,
                                        alive, tcap, tlo, thi, occ0, w, out,
                                        visits, n_tiles, n_c, C, cluster,
                                        st);
  } else if (mode == kClosest && origins == nullptr && tlo != nullptr &&
             thi != nullptr) {
    err = launch<kClosest, true, false>(ent, order, counts, dirs, origins,
                                       alive, tcap, tlo, thi, occ0, w, out,
                                       visits, n_tiles, n_c, C, cluster,
                                       st);
  } else if (mode == kAny && origins != nullptr && occ0 != nullptr) {
    err = launch<kAny, false, true>(ent, order, counts, dirs, origins, alive,
                                   tcap, tlo, thi, occ0, w, out, visits,
                                   n_tiles, n_c, C, cluster, st);
  } else if (mode == kAnyDest && origins == nullptr && occ0 != nullptr) {
    err = launch<kAnyDest, false, false>(ent, order, counts, dirs, origins,
                                        alive, tcap, tlo, thi, occ0, w, out,
                                        visits, n_tiles, n_c, C, cluster,
                                        st);
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
