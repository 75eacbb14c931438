// Per-tile front-to-back cluster walk: the closest-hit and shadow kernels,
// flat or two-level, with weights staged synchronously or streamed.
//
// Replaces the variants of the JAX package's Pallas walk kernel
// (ceres_tpu/ops/megakernel.py, _make_walk_kernel launched by _walk_pallas).
// The mode M is a template parameter:
//   kClosest        closest hit of common-origin rays (the final `else`
//                   branch with mt_accept and winner_update): the primary
//                   wavefront, from _closest_search.
//   kClosestWindow  the same with a per-ray [tmin, tmax] accept window
//                   (window=True: rows tcap+1/+2, the accept mask in
//                   winner_update), from closest_hit_common_origin(tmin=,
//                   tmax=).
//   kAnyDest        occlusion of segments from a common origin (the
//                   any-hit branch with the any_dest accept): the shadow
//                   wavefront cast from the sun, from any_hit_to_point.
//   kAny            occlusion of rays with their own origins, t >= 0 and
//                   no upper bound (the any-hit branch with the generic
//                   accept; features [d, d x o, o, 1]): the
//                   reference-exact shadow rays, from any_hit.
// Each as
//   walk_flat<M, false>   flat, resident;
//   walk_flat<M, true>    flat, streamed weights (stream=True: _copy /
//                         start_fetch / wait_fetch, fetch_wait and the drain
//                         at early exit);
//   walk_hier<M, *>       two-level (S > 1: block_entries, the in-super
//                         priority walk).
// The plain PyTorch versions that define the exact results are in
// ceres_tpu_torch/ops/walk.py (_walk_closest_plain, _walk_any_dest_plain,
// _walk_any_plain).
//
// What one block computes. One block per tile of kR = 512 rays, one ray per
// thread. The tile's candidates arrive as one sorted int32 key row
// (entry-bound f32 bits with the low cid bits cleared | candidate id). The
// block walks the row front to back while
//     k < count  &&  (key_k & ~cmask) <= prune,
// where prune is the tile's maximum over rays of min(best t key, root exit)
// (closest) or of the root exit of the still unoccluded rays (occlusion),
// plus kPrunePad int ulps. The prune is block-uniform, so every thread takes
// the same trip count and the barriers in the loops are safe. Per visit the
// block has a cluster's weight planes in shared memory (10 x 128 floats, 5
// KB, for common-origin rays; 16 x 128, 8 KB, for generic rays) and each
// thread runs Möller-Trumbore against the 128 triangles.
//
// Generic rays (kAny). With o the ray origin and c = d x o (both taken
// relative to the scene centre), the numerators are u = d.cu - c.e2,
// v = d.cv - c.e1, det = d.n and t = tn - o.n: the common-origin planes
// plus six planes [e2.xyz, e1.xyz]. A ray reads 10 rows [d, c, o, tcap].
// The tile hull's origin columns (hull 9..14) now hold a real origin hull;
// the two-level gate (member_entry) already subtracts it.
//
// Flat walk: a candidate is one cluster. Two-level walk: a candidate is a
// super of up to S <= 32 consecutive clusters (first[sid] + s). Lanes
// 0..S-1 of warp 0 slab-test the tile's ray hull (hull row) against the S
// member boxes (bbox) into S entry bounds in shared memory; then every
// thread repeatedly takes the live member with the smallest entry (ties to
// the lowest slot), visits it while that entry is <= the live prune, and
// refreshes the prune after every member visit. Executed member visits are
// the traversal statistic.
//
// Streamed weights. The TPU kernel fetched each visit's block by DMA from
// HBM into VMEM and prefetched visit k + 1 during visit k. Here the block
// goes into one of two shared-memory buffers as 16-byte cp.async copies
// (320 for 10 planes, 512 for 16: one per thread at most), the next visit's
// block is copied into the other buffer while the current one is walked,
// and cp.async.wait_group orders the two. In the flat walk "the next visit"
// is candidate k + 1; in the two-level walk it is the next live member in
// priority order, fetched speculatively when its entry is within the
// current prune (the prune only falls). A copy still in flight at an early
// exit is drained. The resident variants stage each block synchronously, as
// the bunny kernels always did. Both forms give the same outputs.
//
// What bounds it on an H100. Each member visit is 512 x 128 ray-triangle
// pairs at about 25 fp32 operations each (about 43 for generic rays), on the
// CUDA cores, plus a block-wide barrier: ~18 us for one block. One block
// walks one tile, so on big scenes the kernel takes as long as its slowest
// tile (at 1.27M triangles one tile runs 3,120 member visits). Weights are 5
// KB (8 KB generic) per visit per block; a 1.27M-triangle scene holds 100
// MB of them (160 MB generic), more than the 50 MB L2. Streaming hides their
// fetch behind the previous visit, and measured no faster than staging: the
// fetch is small against the arithmetic. Tensor cores are no use here: the
// search needs full fp32.
//
// What the design does about it. One thread per ray keeps each visit free
// of cross-thread reductions except the block max for the prune (warp
// shuffles plus 16 shared-memory slots). Shared-memory weight reads are
// warp broadcasts (all threads read the same triangle). The shadow kernels
// skip rays already occluded and leave a ray at its first occluder. A
// super's member entries are one warp's work, once per super visit.
// Splitting a heavy tile over several blocks, several rays per thread and
// FMA contraction are later work.
//
// Exactness. Built with --fmad=false and written in the plain version's
// operation order, so kernel and plain version agree bit for bit on the
// card. Comparisons of t, prune and entry bounds are signed int32 on f32 bit
// patterns: dead and occluded rays carry negative bits (-1.0f). t = nt *
// (1/nd) with a correctly rounded reciprocal (two roundings, as in the JAX
// kernel). Ties go to the lower lane (the key min) and to the earlier visit
// (the strict < on the best key). The in-kernel slab test uses XLA's min and
// max (xmin/xmax: -0 below +0), not fminf/fmaxf, so entry keys keep the
// sign of a zero exactly as the plain version and the JAX package do.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kC = 128;            // triangles per cluster (CLUSTER_SIZE)
constexpr int kIdxMask = kC - 1;   // lane bits of a winner key
constexpr int kR = 512;            // rays per tile (TILE) = threads per block
constexpr int kWarps = kR / 32;
constexpr int kPlanes = 10;        // common-origin planes: cu.xyz, cv.xyz, n.xyz, tn
constexpr int kPlanesGeneric = 16; // generic planes: those 10, e2.xyz, e1.xyz
constexpr int kSuperMax = 32;      // _SUPER_MAX: member slots in one uint32
constexpr int kHullCols = 16;      // _tile_hulls row
constexpr int kBoxRows = 8;        // bbox rows: lo.xyz, hi.xyz, empty, pad
constexpr int kPrunePad = 256;     // _PRUNE_PAD
constexpr int kBigI = 0x7DB48E52;        // bits of f32(3e37) (_BIG)
constexpr int kBigCleanI = 0x7DB48E00;   // bits of f32(3e37) & ~127: no hit
constexpr int kNegI = -1082130432;       // bits of -1.0f: drops out of a max
constexpr float kDestScale = (float)(1.0 - 4e-6);  // 1 - _DEST_EPS
constexpr float kPadLo = (float)(1.0 - 4e-6);      // 1 - _ULP_PAD
constexpr float kPadHi = (float)(1.0 + 4e-6);      // 1 + _ULP_PAD

// Walk modes (walk.py RAY_ROWS).
constexpr int kClosest = 0;
constexpr int kClosestWindow = 1;
constexpr int kAnyDest = 2;
constexpr int kAny = 3;

__host__ __device__ constexpr bool occlusion(int m) {
  return m == kAnyDest || m == kAny;
}
__host__ __device__ constexpr int planes_of(int m) {
  return m == kAny ? kPlanesGeneric : kPlanes;
}
__host__ __device__ constexpr int tcap_row(int m) { return m == kAny ? 9 : 3; }

// One ray's inputs: its rows of the (rows, n_rays) ray tensor.
template <int M>
struct Ray {
  float dx, dy, dz;
  float cx = 0.f, cy = 0.f, cz = 0.f;  // d x o (kAny)
  float ox = 0.f, oy = 0.f, oz = 0.f;  // o (kAny)
  float tmin = 0.f, tmax = 0.f;        // accept window (kClosestWindow)
  int tcap;                            // root-exit cap bits

  __device__ __forceinline__ Ray(const float* rays, int n_rays, int ray) {
    dx = rays[ray];
    dy = rays[n_rays + ray];
    dz = rays[2 * n_rays + ray];
    if (M == kAny) {
      cx = rays[3 * n_rays + ray];
      cy = rays[4 * n_rays + ray];
      cz = rays[5 * n_rays + ray];
      ox = rays[6 * n_rays + ray];
      oy = rays[7 * n_rays + ray];
      oz = rays[8 * n_rays + ray];
    }
    if (M == kClosestWindow) {
      tmin = rays[4 * n_rays + ray];
      tmax = rays[5 * n_rays + ray];
    }
    tcap = __float_as_int(rays[tcap_row(M) * n_rays + ray]);
  }
};

// XLA's min / max: as fminf / fmaxf except that -0 orders below +0.
__device__ __forceinline__ float xmin(float a, float b) {
  if (a == 0.f && b == 0.f) return __int_as_float(__float_as_int(a) | __float_as_int(b));
  return a < b ? a : b;
}
__device__ __forceinline__ float xmax(float a, float b) {
  if (a == 0.f && b == 0.f) return __int_as_float(__float_as_int(a) & __float_as_int(b));
  return a > b ? a : b;
}

// Max of v over the block, returned to every thread. Its first barrier also
// orders every thread's reads of the current weight buffer before any later
// write to it.
__device__ __forceinline__ int block_max(int v, int* sred) {
  for (int off = 16; off > 0; off >>= 1) {
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  __syncthreads();  // earlier readers of sred are done
  if ((threadIdx.x & 31) == 0) sred[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = sred[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) m = max(m, sred[i]);
  return m;
}

// Synchronous staging of one cluster's kFloats weights (every thread takes
// part; the caller orders it with barriers).
template <int kFloats>
__device__ __forceinline__ void stage_sync(float* dst, const float* src) {
  for (int i = threadIdx.x; i < kFloats; i += kR) dst[i] = src[i];
}

// Asynchronous staging: threads 0..kFloats/4-1 each start one 16-byte copy,
// and every thread commits a group, so all threads count the same groups.
template <int kFloats>
__device__ __forceinline__ void stage_async(float* dst, const float* src) {
  static_assert(kFloats % 4 == 0 && kFloats / 4 <= kR,
                "one 16-byte copy per thread at most");
  if (threadIdx.x < kFloats / 4) {
    const unsigned s = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + 4 * threadIdx.x));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src + 4 * threadIdx.x) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Möller-Trumbore terms of this ray against triangle j of the staged block
// sw, in the plain version's order: det and t numerators, the sign s of
// det, and uvw = min(u, v, det - u - v) * s, the barycentric sign test.
template <int M>
__device__ __forceinline__ void numerators(const float* sw, int j,
                                           const Ray<M>& r, float& nd,
                                           float& nt, float& s, float& uvw) {
  float nu = r.dx * sw[0 * kC + j] + r.dy * sw[1 * kC + j] + r.dz * sw[2 * kC + j];
  float nv = r.dx * sw[3 * kC + j] + r.dy * sw[4 * kC + j] + r.dz * sw[5 * kC + j];
  nd = r.dx * sw[6 * kC + j] + r.dy * sw[7 * kC + j] + r.dz * sw[8 * kC + j];
  nt = sw[9 * kC + j];
  if (M == kAny) {
    nu = nu - (r.cx * sw[10 * kC + j] + r.cy * sw[11 * kC + j] + r.cz * sw[12 * kC + j]);
    nv = nv - (r.cx * sw[13 * kC + j] + r.cy * sw[14 * kC + j] + r.cz * sw[15 * kC + j]);
    nt = nt - (r.ox * sw[6 * kC + j] + r.oy * sw[7 * kC + j] + r.oz * sw[8 * kC + j]);
  }
  s = nd >= 0.f ? 1.f : -1.f;
  uvw = fminf(fminf(nu * s, nv * s), (nd - nu - nv) * s);
}

// Closest-hit visit of one cluster (weights sw, packed id base cid * kC):
// update this ray's best t key and winner slot. With the window, a pair
// with t outside [tmin, tmax] is a miss.
template <int M>
__device__ __forceinline__ void visit_closest(const float* sw, int cid,
                                              const Ray<M>& r, int& best,
                                              int& pid) {
  int kmin = INT_MAX;
  for (int j = 0; j < kC; ++j) {
    float nd, nt, s, uvw;
    numerators<M>(sw, j, r, nd, nt, s, uvw);
    int key = kBigCleanI | j;
    if (fminf(uvw, nt * s) >= 0.f && nd != 0.f) {
      const float t = nt * __frcp_rn(nd);
      if (M != kClosestWindow || (t >= r.tmin && t <= r.tmax)) {
        key = (__float_as_int(t) & ~kIdxMask) | j;
      }
    }
    kmin = min(kmin, key);
  }
  const int t_new = kmin & ~kIdxMask;
  if (t_new < best) {
    best = t_new;
    pid = cid * kC + (kmin & kIdxMask);
  }
}

// Shadow visit of one cluster. kAnyDest: set occ if a triangle lies between
// the sun (t = 0) and the receiving point (t = 1), short of the point by
// _DEST_EPS. kAny: set occ if a triangle lies at t >= 0, however far.
// Occluded rays skip the loop; the loop stops at the first occluder.
template <int M>
__device__ __forceinline__ void visit_occlusion(const float* sw,
                                                const Ray<M>& r, int& occ) {
  if (occ != 0) return;
  for (int j = 0; j < kC; ++j) {
    float nd, nt, s, uvw;
    numerators<M>(sw, j, r, nd, nt, s, uvw);
    bool ok;
    if (M == kAny) {
      ok = fminf(uvw, nt * s) >= 0.f && nd != 0.f;
    } else {
      const bool win = ((nt - kDestScale * nd) * s <= 0.f) && (nt * s >= 0.f);
      ok = uvw >= 0.f && nd != 0.f && win;
    }
    if (ok) {
      occ = 1;
      return;
    }
  }
}

template <int M>
__device__ __forceinline__ void visit(const float* sw, int cid,
                                      const Ray<M>& r, int& best, int& pid,
                                      int& occ) {
  if (occlusion(M)) {
    visit_occlusion<M>(sw, r, occ);
  } else {
    visit_closest<M>(sw, cid, r, best, pid);
  }
}

template <int M>
__device__ __forceinline__ int tile_prune(int best, int occ, int tcap,
                                          int* sred) {
  return block_max(occlusion(M) ? (occ > 0 ? kNegI : tcap) : min(best, tcap),
                   sred) + kPrunePad;
}

template <int M, bool kStream>
__global__ void __launch_bounds__(kR)
walk_flat(const int* __restrict__ counts, const int* __restrict__ keys,
          const float* __restrict__ rays, const float* __restrict__ w,
          const int* __restrict__ occ0, int* __restrict__ out,
          int* __restrict__ visits, int n_rays, int n_c, int cmask) {
  constexpr int kFloats = planes_of(M) * kC;
  __shared__ __align__(16) float sw[2][kFloats];
  __shared__ int sred[kWarps];

  const int tile = blockIdx.x;
  const int ray = tile * kR + threadIdx.x;
  const Ray<M> r(rays, n_rays, ray);
  const int count = counts[tile];
  const int* krow = keys + (size_t)tile * n_c;

  int best = kBigCleanI;  // closest: best t key (low lane bits clear)
  int pid = -1;           // closest: packed slot id of the winner
  int occ = occlusion(M) ? occ0[ray] : 0;
  int prune = tile_prune<M>(best, occ, r.tcap, sred);

  if (kStream && count > 0) {
    stage_async<kFloats>(sw[0], w + (size_t)(krow[0] & cmask) * kFloats);
  }
  int k = 0;
  while (k < count && (krow[k] & ~cmask) <= prune) {
    const int cid = krow[k] & cmask;
    const float* cur = sw[0];
    __syncthreads();  // every thread is done with the previous cluster
    if (kStream) {
      if (k + 1 < count) {  // prefetch visit k + 1, wait for visit k
        stage_async<kFloats>(sw[(k + 1) & 1],
                             w + (size_t)(krow[k + 1] & cmask) * kFloats);
        wait_async<1>();
      } else {
        wait_async<0>();
      }
      cur = sw[k & 1];
    } else {
      stage_sync<kFloats>(sw[0], w + (size_t)cid * kFloats);
    }
    __syncthreads();

    visit<M>(cur, cid, r, best, pid, occ);
    prune = tile_prune<M>(best, occ, r.tcap, sred);
    ++k;
  }
  if (kStream) wait_async<0>();  // drain the prefetch an early exit left
  out[ray] = occlusion(M) ? occ : pid;
  if (threadIdx.x == 0) visits[tile] = k;
}

// Entry bound (int bits) of the tile hull against member slot s of one
// super's boxes bb (kBoxRows x S): the _interval_entry slab test, the box
// widened by the tile's origin hull (zero for common-origin wavefronts).
__device__ __forceinline__ int member_entry(const float* hl, const float* bb,
                                            int s, int S) {
  float tn = 0.f, tf = 0.f;
  for (int a = 0; a < 3; ++a) {
    const float la = bb[a * S + s] - hl[12 + a];        // lo - origin hull hi
    const float ha = bb[(3 + a) * S + s] - hl[9 + a];   // hi - origin hull lo
    const float c0 = la * hl[a];
    const float c1 = la * hl[3 + a];
    const float c2 = ha * hl[a];
    const float c3 = ha * hl[3 + a];
    float emin = xmin(xmin(c0, c1), xmin(c2, c3));
    float emax = xmax(xmax(c0, c1), xmax(c2, c3));
    if (hl[6 + a] > 0.f) {  // the direction interval straddles zero
      emin = -__int_as_float(kBigI);
      emax = __int_as_float(kBigI);
    }
    tn = a == 0 ? emin : xmax(tn, emin);
    tf = a == 0 ? emax : xmin(tf, emax);
  }
  tn = xmax(tn, 0.f);
  const bool ok = (tn * kPadLo <= xmin(tf, __int_as_float(kBigI)) * kPadHi)
                  && bb[6 * S + s] == 0.f;
  return ok ? __float_as_int(tn) : kBigI;
}

// The live slot (bit set in rem) with the smallest entry, ties to the lowest
// slot; *m gets that entry, INT_MAX if no slot is live.
__device__ __forceinline__ int next_member(const int* sent, unsigned rem,
                                           int S, int* m) {
  int best = INT_MAX, slot = 0;
  for (int j = 0; j < S; ++j) {
    if (((rem >> j) & 1u) && sent[j] < best) {
      best = sent[j];
      slot = j;
    }
  }
  *m = best;
  return slot;
}

template <int M, bool kStream>
__global__ void __launch_bounds__(kR)
walk_hier(const int* __restrict__ counts, const int* __restrict__ keys,
          const float* __restrict__ rays, const float* __restrict__ w,
          const int* __restrict__ occ0, const float* __restrict__ hull,
          const float* __restrict__ bbox, const int* __restrict__ first,
          int* __restrict__ out, int* __restrict__ visits, int n_rays,
          int n_s, int cmask, int S) {
  constexpr int kFloats = planes_of(M) * kC;
  __shared__ __align__(16) float sw[2][kFloats];
  __shared__ int sred[kWarps];
  __shared__ int sent[kSuperMax];
  __shared__ float shl[kHullCols];

  const int tile = blockIdx.x;
  const int ray = tile * kR + threadIdx.x;
  const Ray<M> r(rays, n_rays, ray);
  const int count = counts[tile];
  const int* krow = keys + (size_t)tile * n_s;
  if (threadIdx.x < kHullCols) {
    shl[threadIdx.x] = hull[(size_t)tile * kHullCols + threadIdx.x];
  }

  int best = kBigCleanI;
  int pid = -1;
  int occ = occlusion(M) ? occ0[ray] : 0;
  int prune = tile_prune<M>(best, occ, r.tcap, sred);  // syncs shl too
  const unsigned all = S == kSuperMax ? 0xffffffffu : ((1u << S) - 1u);

  int nvis = 0;
  for (int k = 0; k < count && (krow[k] & ~cmask) <= prune; ++k) {
    const int sid = krow[k] & cmask;
    const int fs = first[sid];
    __syncthreads();  // every thread is done with sent and the buffers
    if (threadIdx.x < S) {
      sent[threadIdx.x] = member_entry(shl, bbox + (size_t)sid * kBoxRows * S,
                                       threadIdx.x, S);
    }
    __syncthreads();

    unsigned rem = all;
    int m;
    int s = next_member(sent, rem, S, &m);
    if (m > prune) continue;
    if (kStream) stage_async<kFloats>(sw[0], w + (size_t)(fs + s) * kFloats);
    int b = 0;
    while (true) {
      rem &= ~(1u << s);
      int m2;
      const int s2 = next_member(sent, rem, S, &m2);
      const float* cur = sw[0];
      bool ahead = false;
      if (kStream) {
        ahead = m2 <= prune;  // speculative: the prune may fall first
        if (ahead) {
          stage_async<kFloats>(sw[b ^ 1], w + (size_t)(fs + s2) * kFloats);
          wait_async<1>();
        } else {
          wait_async<0>();
        }
        cur = sw[b];
      } else {
        __syncthreads();  // every thread is done with the previous member
        stage_sync<kFloats>(sw[0], w + (size_t)(fs + s) * kFloats);
      }
      __syncthreads();

      visit<M>(cur, fs + s, r, best, pid, occ);
      prune = tile_prune<M>(best, occ, r.tcap, sred);
      ++nvis;
      if (m2 > prune) {
        if (ahead) wait_async<0>();  // drain the speculative fetch
        break;
      }
      s = s2;
      b ^= 1;
    }
  }
  out[ray] = occlusion(M) ? occ : pid;
  if (threadIdx.x == 0) visits[tile] = nvis;
}

template <int M>
int launch_flat(bool stream_w, const int* counts, const int* keys,
                const float* rays, const float* w, const int* occ0, int* out,
                int* visits, int n_tiles, int n_c, int cmask, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rays = n_tiles * kR;
  if (stream_w) {
    walk_flat<M, true><<<n_tiles, kR, 0, st>>>(
        counts, keys, rays, w, occ0, out, visits, n_rays, n_c, cmask);
  } else {
    walk_flat<M, false><<<n_tiles, kR, 0, st>>>(
        counts, keys, rays, w, occ0, out, visits, n_rays, n_c, cmask);
  }
  return (int)cudaGetLastError();
}

template <int M>
int launch_hier(bool stream_w, const int* counts, const int* keys,
                const float* rays, const float* w, const int* occ0,
                const float* hull, const float* bbox, const int* first,
                int* out, int* visits, int n_tiles, int n_s, int cmask, int S,
                int device, void* stream) {
  if (S < 2 || S > kSuperMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rays = n_tiles * kR;
  if (stream_w) {
    walk_hier<M, true><<<n_tiles, kR, 0, st>>>(
        counts, keys, rays, w, occ0, hull, bbox, first, out, visits, n_rays,
        n_s, cmask, S);
  } else {
    walk_hier<M, false><<<n_tiles, kR, 0, st>>>(
        counts, keys, rays, w, occ0, hull, bbox, first, out, visits, n_rays,
        n_s, cmask, S);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Flat walks. counts (n_tiles,) int32; keys (n_tiles, n_c) int32 sorted
// ascending; rays (rows, n_tiles * 512) f32 (walk.py RAY_ROWS); w (n_c,
// planes, 128) f32, 16-byte aligned; occ0 (n_tiles * 512,) int32 the rays
// that start occluded (occlusion modes); out (n_tiles * 512,) int32, the
// packed slot id or -1 (closest) or the occlusion flag; visits (n_tiles,)
// int32 executed visits; stream_w selects the streamed form. Each returns
// a cudaError_t.
extern "C" int ceres_walk_closest(const int* counts, const int* keys,
                                  const float* rays, const float* w, int* out,
                                  int* visits, int n_tiles, int n_c,
                                  int cmask, int stream_w, int device,
                                  void* stream) {
  return launch_flat<kClosest>(stream_w != 0, counts, keys, rays, w, nullptr,
                               out, visits, n_tiles, n_c, cmask, device,
                               stream);
}

extern "C" int ceres_walk_closest_window(const int* counts, const int* keys,
                                         const float* rays, const float* w,
                                         int* out, int* visits, int n_tiles,
                                         int n_c, int cmask, int stream_w,
                                         int device, void* stream) {
  return launch_flat<kClosestWindow>(stream_w != 0, counts, keys, rays, w,
                                     nullptr, out, visits, n_tiles, n_c,
                                     cmask, device, stream);
}

extern "C" int ceres_walk_any_dest(const int* counts, const int* keys,
                                   const float* rays, const float* w,
                                   const int* occ0, int* out, int* visits,
                                   int n_tiles, int n_c, int cmask,
                                   int stream_w, int device, void* stream) {
  return launch_flat<kAnyDest>(stream_w != 0, counts, keys, rays, w, occ0,
                               out, visits, n_tiles, n_c, cmask, device,
                               stream);
}

extern "C" int ceres_walk_any(const int* counts, const int* keys,
                              const float* rays, const float* w,
                              const int* occ0, int* out, int* visits,
                              int n_tiles, int n_c, int cmask, int stream_w,
                              int device, void* stream) {
  return launch_flat<kAny>(stream_w != 0, counts, keys, rays, w, occ0, out,
                           visits, n_tiles, n_c, cmask, device, stream);
}

// Two-level walks. keys (n_tiles, n_s) are super candidates; w
// (n_c + S, planes, 128) the fine blocks, zero-padded by S; hull
// (n_tiles, 16) f32 per-tile hull scalars; bbox (n_s, 8, S) f32 member
// boxes; first (n_s,) int32 first member of each super; 2 <= S <= 32.
extern "C" int ceres_walk_closest_hier(const int* counts, const int* keys,
                                       const float* rays, const float* w,
                                       const float* hull, const float* bbox,
                                       const int* first, int* out,
                                       int* visits, int n_tiles, int n_s,
                                       int cmask, int S, int stream_w,
                                       int device, void* stream) {
  return launch_hier<kClosest>(stream_w != 0, counts, keys, rays, w, nullptr,
                               hull, bbox, first, out, visits, n_tiles, n_s,
                               cmask, S, device, stream);
}

extern "C" int ceres_walk_closest_window_hier(
    const int* counts, const int* keys, const float* rays, const float* w,
    const float* hull, const float* bbox, const int* first, int* out,
    int* visits, int n_tiles, int n_s, int cmask, int S, int stream_w,
    int device, void* stream) {
  return launch_hier<kClosestWindow>(stream_w != 0, counts, keys, rays, w,
                                     nullptr, hull, bbox, first, out, visits,
                                     n_tiles, n_s, cmask, S, device, stream);
}

extern "C" int ceres_walk_any_dest_hier(const int* counts, const int* keys,
                                        const float* rays, const float* w,
                                        const int* occ0, const float* hull,
                                        const float* bbox, const int* first,
                                        int* out, int* visits, int n_tiles,
                                        int n_s, int cmask, int S,
                                        int stream_w, int device,
                                        void* stream) {
  return launch_hier<kAnyDest>(stream_w != 0, counts, keys, rays, w, occ0,
                               hull, bbox, first, out, visits, n_tiles, n_s,
                               cmask, S, device, stream);
}

extern "C" int ceres_walk_any_hier(const int* counts, const int* keys,
                                   const float* rays, const float* w,
                                   const int* occ0, const float* hull,
                                   const float* bbox, const int* first,
                                   int* out, int* visits, int n_tiles,
                                   int n_s, int cmask, int S, int stream_w,
                                   int device, void* stream) {
  return launch_hier<kAny>(stream_w != 0, counts, keys, rays, w, occ0, hull,
                           bbox, first, out, visits, n_tiles, n_s, cmask, S,
                           device, stream);
}

extern "C" const char* ceres_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
