// Per-tile front-to-back cluster walk: the closest-hit and shadow kernels,
// flat or two-level, with weights resident or streamed.
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
//   walk_solo<M, R>                   flat, resident: one CTA a tile;
//   walk_tile<M, true, K, false, R>   flat, streamed weights (stream=True:
//                                     _copy / start_fetch / wait_fetch,
//                                     fetch_wait and the drain at early
//                                     exit);
//   walk_tile<M, *, K, true, R>       two-level (S > 1: block_entries, the
//                                     in-super priority walk);
// walk_tile walks one tile on a thread-block cluster of K CTAs (below).
// R is the tile's rays: kR = 512 for every mode, and kR128 = 128 for
// kAnyDest in all three forms, the shadow wavefront regrouped by receiver
// (_REGROUP_TILE, from any_hit_to_point(regroup=True); ceres_walk with
// tile = 128). A block has R threads. At 128 rays every form is the
// split walk (split_walk, split_list, split_more, split_replay; below).
// The plain PyTorch versions that define the exact results are in
// ceres_tpu_torch/ops/walk.py (_walk_closest_plain, _walk_any_dest_plain,
// _walk_any_plain).
//
// What one tile's walk computes. A tile is R rays (512, or 128 regrouped):
// one block with one ray per thread (the resident flat walk, walk_solo,
// below), or a cluster of blocks (the streamed flat walk and the two-level
// walk, below). The
// tile's candidates arrive as one sorted int32 key row (entry-bound f32
// bits with the low cid bits cleared | candidate id). The walk takes the row front to back while
//     k < count  &&  (key_k & ~cmask) <= prune,
// where prune is the tile's maximum over rays of min(best t key, root exit)
// (closest) or of the root exit of the still unoccluded rays (occlusion),
// plus kPrunePad int ulps. The prune is tile-uniform, so every thread takes
// the same trip count and the barriers in the loops are safe. Per visit a
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
// super of up to S <= 32 consecutive clusters (first[sid] + s). Lane s of
// every warp slab-tests the tile's ray hull (hull row) against member box s
// (bbox) into its entry bound; the warp then repeatedly takes the live
// member with the smallest entry (ties to the lowest slot: a warp min and a
// ballot), visits it while that entry is <= the live prune, and refreshes
// the prune after every member visit. Executed member visits are the
// traversal statistic.
//
// The streamed flat walk and the two-level walk (walk_tile) run one tile on
// a thread-block cluster of K CTAs (Hopper clusters, each CTA on its own
// SM; K = kKFlat and kK, kK128 at 128 rays). CTA c holds R / K of the
// tile's rays, each on K
// neighbouring threads of a warp, and every block visit's 128 triangles:
// thread g of a ray takes lanes j = i K + g, and the ray's threads combine their key minima (or occlusion flags) with
// xor shuffles. A key keeps its lane in its low bits, so the combined min
// is the whole block's key min exactly (ties to the lower lane) and the
// strict < on the best key keeps the earlier visit. So the state of a ray
// lives in one CTA, and all a visit exchanges across the cluster is each
// CTA's part of the tile prune: one int, sent with st.async into every
// other CTA's shared memory (distributed shared memory), which counts the
// bytes on an mbarrier of the receiving CTA. Every CTA takes the max of the
// K parts, so all compute the same prune and take the same trip count. No
// cluster barrier and no memory fence per visit (a cluster barrier costs a
// GPU-wide fence and an L1 invalidation each time): two part buffers
// alternate, and a CTA sends visit n + 1's part only after it has read
// visit n's, so buffer reuse needs no handshake of its own. Between
// sending and waiting each CTA visits the next block in visiting order
// (the next candidate of the key row, or the next member in entry order;
// the prune can only fall, so that visit is speculative, and dropped
// uncounted if the prune falls below its entry) and prefetches the one
// after it, so the exchange overlaps the next visit's arithmetic. One loop
// (TileWalk::run) serves both walks, fed by the key row (Row) or by a
// super's live members (Members). The first prune needs no exchange: every
// CTA takes it over all the tile's R rays. A tile that it lets visit
// nothing (most tiles of a frame see no candidate) returns before any
// cluster barrier, and the opening cluster barrier's wait comes after the
// first visit. kK and kKFlat are constants, from the card's times of K6
// and K7a on the 4x bunny and of K5 on the 3x bunny (PERF.md, with the
// designs that measured slower there: CTAs that split each block's lanes
// and exchange every ray's key per visit, faster on the closest walk and
// slower on the shadow walk; a ray's threads in separate warps).
//
// The split walk (the shadow walk at kR128 rays, flat or two-level,
// resident or streamed). A regrouped tile holds a compact patch of
// receivers, but where the morton order jumps it holds two distant ones,
// and with one receiver that no block occludes its prune stays at t = 1
// + pad: such a tile walks its whole key row (on the 4x bunny 14,997
// member visits, the screen tiles' heaviest 1,587), and a walk that keeps
// the tile's visits in one chain is as slow as that tile (PERF.md). But a
// ray's flag needs only its own first occluder, and the sequential walk's
// visits follow from every ray's first occluding position. So:
//   split_walk    one CTA for each of the tile's kK128 ray groups (R / K
//                 rays, K threads a ray, lanes split as in walk_tile),
//                 with no cluster and no exchange: the group walks the
//                 first segment of the key row (kSeg128 block visits;
//                 two-level, kSeg128 / S supers) in order while an
//                 entry is within the group's own prune, and stores the
//                 position of each ray's first occluder (flat: the
//                 candidate's index; two-level: kSuperMax x the super's
//                 index + the member's rank in entry order);
//   split_list    one warp a tile: a tile with rays still live and a
//                 candidate left within their prune takes the later
//                 segments, each on units of R / K of those rays, so
//                 the groups whose rays the first segment occluded walk
//                 no further;
//   split_more    the listed units, all at once on the CTAs the card
//                 holds: each starts with its rays that no earlier
//                 segment has found occluded (the first segment's finds,
//                 and those of later ones already stored), and takes the
//                 min of its finds with atomicMin;
//   split_replay  one CTA a tile: flags (start flags, or an occluder
//                 found), and the executed visits of the sequential
//                 walk: before position q its live rays are those whose
//                 first occluder is at q or later, which gives its prune
//                 there, and both that prune and the entries are
//                 monotone, so the candidates taken are found by
//                 bisection (a super over which the prune does not move
//                 takes every member within it).
// It is exact because a unit's live rays include every one of its rays
// that the sequential walk still has live, so its prune is never below
// their caps + pad and each such ray meets every block the sequential
// walk shows it; and a block the sequential prune excludes has entry >
// tcap + pad for every live ray, so it cannot occlude one (the invariant
// the prune pad keeps, _PRUNE_PAD in ops/walk.py): a unit's first find
// for a ray is never before the sequential one, and the segment holding
// the sequential one finds it. Visits a unit makes past the sequential
// walk's are not counted; the replay counts. kK128 and kSeg128 are
// constants from the card's times of the regrouped K5 and K7a on the 3x
// and 4x bunny (PERF.md; hier_sweep.py --k128s, --segs).
//
// Streamed weights. The TPU kernel fetched each visit's block by DMA from
// HBM into VMEM and prefetched visit k + 1 during visit k. Here a block
// goes into one of three shared-memory buffers as 4-byte cp.async copies,
// which lay it out as triangle records: the block being visited, the next
// in visiting order (visited ahead of the prune exchange) and the one
// after it, fetched when its entry is within the current prune (the prune
// only falls) while the other two are walked. A copy still in flight at an
// early exit is drained. The resident two-level variants fill the same
// buffers with plain copies; the resident flat walk (walk_solo) copies each
// block with cp.async into one of two buffers while the block before it is
// visited; a unit of the split walk copies the two blocks after the one it
// visits into the other two of three buffers (cp.async when streamed, and
// in the flat walk on resident weights too). All forms give the same
// outputs.
//
// What bounds it on an H100. Each visit is 512 x 128 ray-triangle pairs at
// 26-30 fp32 operations each (44 for generic rays), on the CUDA cores: the
// work is compute-bound (weights are 5 KB, 8 KB generic, per visit). One
// tile's walk is one sequence under one tile-wide prune, and visits per
// tile are heavy-tailed: at 1.27M triangles one tile runs 3,120 member
// visits (at 318k, flat, 698), at ~18 us each for one 512-thread block, so
// with one block per tile that tile alone was the whole kernel while the
// other SMs idled.
// Tensor cores are no use here: the search needs full fp32.
//
// What the design does about it. Every walk stages each block
// triangle-major, so a pair reads 3 float4 (4 generic) instead of 10 (16)
// scalars, and runs a thread's sign tests in chunks with no branch per pair
// (a hit mask first, then t and the key only for the few hits: one visit
// body, visit_result, for every variant). The shadow kernels leave a ray at
// its first occluder. The cluster walk spreads each tile over a cluster of
// K SMs (above) with K threads a ray, so a warp idles once its 32 / K rays
// are occluded, takes the next member with a warp min instead of a scan,
// reads each super's key, first member and boxes a candidate ahead (the
// flat walk its row's keys two ahead), and synchronises a visit with one
// block barrier and one mbarrier wait (hidden behind the next visit). The
// resident flat walk keeps a light tile (most make one to three visits) on
// one CTA, one ray a thread: weight reads are warp broadcasts (every thread
// reads the same record), the next block is copied during the visit, a
// visit has one block barrier (the prune max), and the shadow walks hand
// the live rays to the leading warps at each prune max, so no warp walks
// occluded rays. The split walk (128-ray tiles) takes a heavy tile's
// visits out of one chain: its segments run at once on separate CTAs, a
// ray group stops with its own rays, and a visit has one block barrier
// (the unit's prune max) and no exchange; at 128 rays a visit of one ray
// a thread is a chain of 128 pairs, of a ray group 16 (PERF.md: on the
// bunny's regrouped 1080p wavefront one ray a thread took 0.62 ms on one
// H100, the split walk 0.37). FMA contraction and several rays per thread
// are later work.
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
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr int kC = 128;            // triangles per cluster (CLUSTER_SIZE)
constexpr int kIdxMask = kC - 1;   // lane bits of a winner key
constexpr int kR = 512;            // rays per tile (TILE) = threads per block
constexpr int kR128 = 128;         // regrouped shadow tiles (_REGROUP_TILE)
constexpr int kK = 8;              // two-level walk: CTAs a tile, threads a ray
constexpr int kKFlat = 8;          // streamed flat walk: the same
constexpr int kK128 = 8;           // split walk: ray groups a tile, threads a ray
constexpr int kSeg128 = 256;       // split walk: block visits a segment
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

// Max of v over a block of R threads, returned to every thread: a warp
// redux, the R / 32 warps' maxima through sred and a second redux. One
// barrier: the caller puts a barrier of its own between two calls on one
// sred, or alternates two sred buffers.
template <int R>
__device__ __forceinline__ int block_max(int v, int* sred) {
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) sred[threadIdx.x >> 5] = v;
  __syncthreads();
  return __reduce_max_sync(0xffffffffu, sred[threadIdx.x & (R / 32 - 1)]);
}

// This ray's part of the tile prune: min(best t key, root exit) (closest),
// or the root exit while unoccluded (occlusion; -1.0f's bits once
// occluded, which drop out of the max).
template <int M>
__device__ __forceinline__ int prune_part(int best, int occ, int tcap) {
  return occlusion(M) ? (occ > 0 ? kNegI : tcap) : min(best, tcap);
}

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The sign s of det and uvw = min(u, v, det - u - v) * s, the barycentric
// sign test, from the u, v and det numerators.
__device__ __forceinline__ void sign_test(float nu, float nv, float nd,
                                          float& s, float& uvw) {
  s = nd >= 0.f ? 1.f : -1.f;
  uvw = fminf(fminf(nu * s, nv * s), (nd - nu - nv) * s);
}

// The cluster walk's staged block, triangle-major: one record of
// rec_floats(M) floats per triangle, read as float4s
//   [cu.xyz, tn] [cv.xyz, e2.x] [n.xyz, e2.y] ([e1.xyz, e2.z] generic),
// so a pair takes 3 (generic 4) shared-memory loads instead of 10 (16).
// The threads of a warp read K neighbouring records at once; at 12 floats
// (generic: 16 and 4 of padding) those fall in distinct banks.
__host__ __device__ constexpr int rec_floats(int m) {
  return m == kAny ? 20 : 12;
}
// Where plane q (walk.py's plane order) sits in a record, and all 16 as
// 4-bit fields of one constant (a shift and a mask at run time).
__host__ __device__ constexpr int rec_slot(int q) {
  return q < 3 ? q : q < 6 ? q + 1 : q < 9 ? q + 2 : q == 9 ? 3
         : q == 10 ? 7 : q == 11 ? 11 : q == 12 ? 15 : q - 1;
}
__host__ __device__ constexpr unsigned long long rec_slots() {
  unsigned long long t = 0;
  for (int q = 0; q < kPlanesGeneric; ++q) {
    t |= static_cast<unsigned long long>(rec_slot(q)) << (4 * q);
  }
  return t;
}

template <int M>
struct Records {
  const float* p;

  __device__ __forceinline__ void terms(int j, const Ray<M>& r, float& nd,
                                        float& nt, float& s,
                                        float& uvw) const {
    const float4* q = reinterpret_cast<const float4*>(p) + j * (rec_floats(M) / 4);
    const float4 a = q[0], b = q[1], c = q[2];
    float nu = r.dx * a.x + r.dy * a.y + r.dz * a.z;
    float nv = r.dx * b.x + r.dy * b.y + r.dz * b.z;
    nd = r.dx * c.x + r.dy * c.y + r.dz * c.z;
    nt = a.w;
    if (M == kAny) {
      const float4 e = q[3];
      nu = nu - (r.cx * b.w + r.cy * c.w + r.cz * e.w);
      nv = nv - (r.cx * e.x + r.cy * e.y + r.cz * e.z);
      nt = nt - (r.ox * c.x + r.oy * c.y + r.oz * c.z);
    }
    sign_test(nu, nv, nd, s, uvw);
  }

  // Only the det and t numerators of terms, bit for bit the same.
  __device__ __forceinline__ void t_terms(int j, const Ray<M>& r, float& nd,
                                          float& nt) const {
    const float4* q = reinterpret_cast<const float4*>(p) + j * (rec_floats(M) / 4);
    const float4 a = q[0], c = q[2];
    nd = r.dx * c.x + r.dy * c.y + r.dz * c.z;
    nt = a.w;
    if (M == kAny) nt = nt - (r.ox * c.x + r.oy * c.y + r.oz * c.z);
  }
};

// Whether a pair is a hit in front of the origin (closest modes, kAny):
// inside the triangle, t >= 0, det != 0.
__device__ __forceinline__ bool front_hit(float nd, float nt, float s,
                                          float uvw) {
  return fminf(uvw, nt * s) >= 0.f && nd != 0.f;
}

// Whether a pair occludes: kAnyDest, between the sun (t = 0) and the
// receiving point (t = 1), short of the point by _DEST_EPS; kAny, at
// t >= 0, however far.
template <int M>
__device__ __forceinline__ bool occludes(float nd, float nt, float s,
                                         float uvw) {
  if (M == kAny) return front_hit(nd, nt, s, uvw);
  const bool win = ((nt - kDestScale * nd) * s <= 0.f) && (nt * s >= 0.f);
  return uvw >= 0.f && nd != 0.f && win;
}

// The winner key of a front hit of triangle lane j: (t bits with the lane
// bits cleared) | j, t = nt * rcp(nd). False if the window rejects t (a
// t outside [tmin, tmax] is a miss).
template <int M>
__device__ __forceinline__ bool hit_key(float nd, float nt, int j,
                                        const Ray<M>& r, int& key) {
  const float t = nt * __frcp_rn(nd);
  key = (__float_as_int(t) & ~kIdxMask) | j;
  return M != kClosestWindow || (t >= r.tmin && t <= r.tmax);
}

// Take the key min of a visit of block cid: a strictly smaller t key
// updates this ray's best key and winner slot.
__device__ __forceinline__ void take_key(int kmin, int cid, int& best,
                                         int& pid) {
  const int t_new = kmin & ~kIdxMask;
  if (t_new < best) {
    best = t_new;
    pid = cid * kC + (kmin & kIdxMask);
  }
}

// One super candidate of a tile's key row, read a candidate ahead: its key,
// its first member and, in lane s of each warp, member s's box (bbox rows
// lo.xyz, hi.xyz, empty).
struct Head {
  int key, fs;
  float box[kBoxRows - 1];
};

__device__ __forceinline__ void load_head(Head& h, const int* krow, int k,
                                          const float* bbox,
                                          const int* first, int cmask,
                                          int S) {
  const int lane = threadIdx.x & 31;
  h.key = krow[k];
  const int sid = h.key & cmask;
  h.fs = first[sid];
  const float* bb = bbox + (size_t)sid * kBoxRows * S + lane;
#pragma unroll
  for (int a = 0; a < kBoxRows - 1; ++a) h.box[a] = lane < S ? bb[a * S] : 0.f;
}

// Entry bound (int bits) of the tile hull against one member box (Head):
// the _interval_entry slab test, the box widened by the tile's origin hull
// (zero for common-origin wavefronts).
__device__ __forceinline__ int member_entry(const float* hl,
                                            const float* box) {
  float tn = 0.f, tf = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float la = box[a] - hl[12 + a];        // lo - origin hull hi
    const float ha = box[3 + a] - hl[9 + a];     // hi - origin hull lo
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
                  && box[6] == 0.f;
  return ok ? __float_as_int(tn) : kBigI;
}

// The live member (bit set in rem; lane s of the warp holds member s's
// entry ent) with the smallest entry, ties to the lowest slot, returned to
// every lane of the warp; *m gets that entry, INT_MAX if none is live.
__device__ __forceinline__ int next_member(int ent, unsigned rem, int* m) {
  const int lane = threadIdx.x & 31;
  const bool live = (rem >> lane) & 1u;
  const int v = live ? ent : INT_MAX;
  *m = __reduce_min_sync(0xffffffffu, v);
  const unsigned at = __ballot_sync(0xffffffffu, live && v == *m);
  return at ? __ffs(at) - 1 : 0;
}

// Copy block blk (planes x kC, plane-major) into dst as triangle records
// (Records), on a block of R threads. Streamed: 4-byte cp.async copies and
// one committed group per thread; else plain copies.
template <int M, bool kAsync, int R>
__device__ __forceinline__ void stage_block(float* dst, const float* w,
                                            int blk) {
  constexpr int kN = planes_of(M) * kC;
  const float* src = w + (size_t)blk * kN;
#pragma unroll
  for (int base = 0; base < kN; base += R) {
    const int i = base + threadIdx.x;
    if (kN % R != 0 && i >= kN) break;
    const int q = i / kC, j = i % kC;
    float* d = dst + j * rec_floats(M) + ((rec_slots() >> (4 * q)) & 15);
    if (kAsync) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(d))),
                      "l"(src + i) : "memory");
    } else {
      *d = src[i];
    }
  }
  if (kAsync) asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One block visit (weights sw) for ray r, whose K threads take lanes
// j = i K + g, i < kC / K (g = this thread's place among them): the smallest
// hit_key over the block, INT_MAX if none (a miss never updates best, so
// its key need not be kept), or the occlusion flag (0 for a ray already
// occluded: the flags are OR-ed into occ). A thread's lanes go in chunks of
// up to 32 without a branch per pair: the sign tests of a chunk first, into
// a mask, then only the hits. The K threads of a ray are neighbours in
// their warp and combine their parts with xor shuffles, so all of them
// return the ray's result.
template <int M, int K>
__device__ __forceinline__ int visit_result(const float* sw, int occ,
                                            const Ray<M>& r, int g) {
  constexpr int kL = kC / K;
  constexpr int kChunk = kL < 32 ? kL : 32;
  const Records<M> blk{sw};
  int v = occlusion(M) ? 0 : INT_MAX;
  if (!(occlusion(M) && occ != 0)) {
#pragma unroll
    for (int base = 0; base < kL; base += kChunk) {
      unsigned hits = 0;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        float nd, nt, s, uvw;
        blk.terms((base + i) * K + g, r, nd, nt, s, uvw);
        const bool hit = occlusion(M) ? occludes<M>(nd, nt, s, uvw)
                                      : front_hit(nd, nt, s, uvw);
        hits |= hit ? 1u << i : 0u;
      }
      if (occlusion(M)) {
        if (hits) {
          v = 1;
          break;
        }
        continue;
      }
      for (; hits; hits &= hits - 1) {
        const int j = (base + __ffs(hits) - 1) * K + g;
        float nd, nt;
        int key;
        blk.t_terms(j, r, nd, nt);
        if (hit_key<M>(nd, nt, j, r, key)) v = min(v, key);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < K; off <<= 1) {
    const int y = __shfl_xor_sync(0xffffffffu, v, off);
    v = occlusion(M) ? (v | y) : min(v, y);
  }
  return v;
}

// Distributed shared memory. A shared address of this CTA mapped into the
// cluster window of CTA `rank`.
__device__ __forceinline__ unsigned cta_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned cluster_addr(unsigned a, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(a), "r"(rank));
  return out;
}

// Store v at a (another CTA's shared memory) and count its 4 bytes on the
// mbarrier at bar in that CTA: no fence and no cluster barrier.
__device__ __forceinline__ void store_remote(unsigned a, int v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
      :: "r"(a), "r"(v), "r"(bar) : "memory");
}

// Arm this CTA's mbarrier at bar for its next phase: one arrival, and
// `bytes` to come from other CTAs' store_remote.
__device__ __forceinline__ void expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` of the mbarrier at bar is over.
// A phase that does not end within ~2^34 cycles (seconds) is a fault: trap
// (the launch fails) rather than hang the card.
__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  const long long t0 = clock64();
  while (true) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// The cluster barrier in its two halves, so that work can sit between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Where a run of block visits comes from. pop() takes the next block in
// visiting order and returns its id, with its entry bound in *m (INT_MAX
// once none is left, which no prune reaches); it may be called past the end.
//
// The flat walk: the candidates of the tile's sorted key row, each key read
// two candidates ahead of its use.
struct Row {
  const int* krow;
  int count, cmask, pos, k0, k1;

  __device__ __forceinline__ Row(const int* krow, int count, int cmask)
      : krow(krow), count(count), cmask(cmask), pos(0) {
    k0 = 0 < count ? krow[0] : 0;
    k1 = 1 < count ? krow[1] : 0;
  }

  __device__ __forceinline__ int pop(int* m) {
    const int key = k0;
    *m = pos < count ? (key & ~cmask) : INT_MAX;
    k0 = k1;
    k1 = pos + 2 < count ? krow[pos + 2] : 0;
    ++pos;
    return key & cmask;
  }
};

// The two-level walk: the members of one super (first block fs) still to
// visit (bit set in rem), smallest entry first; lane s of each warp holds
// member s's entry ent.
struct Members {
  int ent;
  unsigned rem;
  int fs;

  __device__ __forceinline__ int pop(int* m) {
    const int s = next_member(ent, rem, m);
    rem &= ~(1u << s);
    return fs + s;
  }
};

// What the CTAs of a tile's cluster keep in shared memory (R threads a CTA).
template <int M, int K, int R>
struct TileShared {
  // Three block buffers: the block being visited, the next one (computed
  // while the prune exchange completes) and the one after it (prefetched
  // meanwhile).
  alignas(16) float sw[3][kC * rec_floats(M)];
  // Every CTA's part of the prune, in two buffers (visits alternate), each
  // with the mbarrier that counts the other CTAs' bytes into it.
  alignas(8) unsigned long long bar[2];
  int part[2][K];
  // block_max's buffers: a visit has one barrier, so calls alternate.
  int red[2][R / 32];
  float hull[kHullCols];  // two-level walk: the tile's hull row
};

// One CTA's state of a tile walk of R rays on a cluster of K CTAs.
template <int M, bool kStream, int K, int R>
struct TileWalk {
  static_assert(K == 2 || K == 4 || K == 8, "a portable cluster size");
  static constexpr unsigned kExchangeBytes = (K - 1) * sizeof(int);

  TileShared<M, K, R>& sh;
  const float* w;
  const Ray<M>& r;
  int rank, g;         // this CTA in its cluster; this thread among its ray's
  int occ, prune;
  int best = kBigCleanI;  // closest: best t key (low lane bits clear)
  int pid = -1;           // closest: packed slot id of the winner
  int red = 1;            // which red buffer the next block_max uses
  int nvis = 0;           // executed block visits of the tile
  bool joined = false;    // past the opening cluster barrier's wait

  // Visit src's blocks in order while the next entry is within the tile
  // prune, which every visit renews across the cluster.
  template <class Src>
  __device__ __forceinline__ void run(Src& src) {
    const int lane = threadIdx.x & 31;
    // Blocks in visiting order: cur (being visited), nxt after it.
    int m, m2;
    int cur = src.pop(&m);
    if (m > prune) return;
    int nxt = src.pop(&m2);
    __syncthreads();  // the last run's speculative reads of sw are done
    int b = 0;  // sw[b] holds cur, sw[(b + 1) % 3] nxt
    stage_block<M, kStream, R>(sh.sw[b], w, cur);
    if (m2 <= prune) stage_block<M, kStream, R>(sh.sw[(b + 1) % 3], w, nxt);
    if (kStream) wait_async<0>();
    __syncthreads();
    int x = visit_result<M, K>(sh.sw[b], occ, r, g);
    if (!joined) {  // every CTA of the cluster runs, its mbarriers armed
      cluster_wait();
      joined = true;
    }
    bool ahead = false;  // a prefetch is in flight
    while (true) {
      // Take visit cur, then send this CTA's part of the new prune to the
      // other CTAs. Buffer p was last read two visits ago: every CTA has
      // read it, as each sent its previous part only after reading it.
      if (occlusion(M)) {
        occ |= x;
      } else {
        take_key(x, cur, best, pid);
      }
      if (kStream && ahead) wait_async<0>();  // block_max's barrier publishes it
      const int part = block_max<R>(prune_part<M>(best, occ, r.tcap), sh.red[red]);
      red ^= 1;
      const int p = nvis & 1;
      if (threadIdx.x == 0) {
        const unsigned a = cta_addr(&sh.part[p][rank]);
        const unsigned bar = cta_addr(&sh.bar[p]);
#pragma unroll
        for (int c = 1; c < K; ++c) {
          const int to = (rank + c) % K;
          store_remote(cluster_addr(a, to), part, cluster_addr(bar, to));
        }
      }
      // Meanwhile: prefetch the block after nxt, and visit nxt, both
      // speculatively (the prune may fall below their entries). sw[(b + 2)
      // % 3] was last read before the barrier above.
      int m3;
      const int after = src.pop(&m3);
      const bool go2 = m2 <= prune;
      ahead = go2 && m3 <= prune;
      if (ahead) stage_block<M, kStream, R>(sh.sw[(b + 2) % 3], w, after);
      int x2 = 0;
      if (go2) x2 = visit_result<M, K>(sh.sw[(b + 1) % 3], occ, r, g);

      {  // the other CTAs' parts are in; re-arm
        const unsigned bar = cta_addr(&sh.bar[p]);
        wait_phase(bar, (nvis >> 1) & 1);
        if (threadIdx.x == 0) expect_bytes(bar, kExchangeBytes);
      }
      const int v = lane < K && lane != rank ? sh.part[p][lane] : part;
      prune = __reduce_max_sync(0xffffffffu, v) + kPrunePad;
      ++nvis;
      if (m2 > prune) break;  // nxt's visit, if made, is dropped
      cur = nxt;
      nxt = after;
      m2 = m3;
      x = x2;
      b = (b + 1) % 3;
    }
    if (kStream && ahead) wait_async<0>();  // drain a prefetch left behind
  }
};

// CTAs of walk_tile that an SM should hold at once, which sets the
// kernel's register budget: the shadow walks, bound by the fixed cost of a
// CTA's visit and not by its arithmetic, run faster two 512-thread CTAs to
// an SM (64 registers a thread); the closest walks with the registers of
// one. A CTA of R < 512 threads keeps the same registers a thread.
__host__ __device__ constexpr int min_ctas(int m, int r) {
  return (occlusion(m) ? 2 : 1) * (kR / r);
}

// One tile of R rays on a cluster of K CTAs: the streamed flat walk (kHier
// false; hull, bbox and first unused) and the two-level walk.
template <int M, bool kStream, int K, bool kHier, int R>
__global__ void __launch_bounds__(R, min_ctas(M, R))
walk_tile(const int* __restrict__ counts, const int* __restrict__ keys,
          const float* __restrict__ rays, const float* __restrict__ w,
          const int* __restrict__ occ0, const float* __restrict__ hull,
          const float* __restrict__ bbox, const int* __restrict__ first,
          int* __restrict__ out, int* __restrict__ visits, int n_rays,
          int n_k, int cmask, int S) {
  __shared__ TileShared<M, K, R> sh;

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tile = blockIdx.x / K;
  const int lane = threadIdx.x & 31;
  const int ray = tile * R + rank * (R / K) + threadIdx.x / K;
  const int count = counts[tile];
  const int* krow = keys + (size_t)tile * n_k;
  const int occ = occlusion(M) ? occ0[ray] : 0;

  // The first prune, over all the tile's rays (thread t reads ray t's
  // part), so every CTA of the cluster has it without an exchange; and
  // whether it lets the walk start at all. A tile that visits nothing
  // (most tiles of a frame see no candidate) ends here, in every CTA of
  // its cluster alike, before any cluster barrier.
  bool walks = count > 0;
  int prune = 0;
  if (walks) {
    if (kHier && threadIdx.x < kHullCols) {
      sh.hull[threadIdx.x] = hull[(size_t)tile * kHullCols + threadIdx.x];
    }
    const int t = tile * R + threadIdx.x;
    const int part = prune_part<M>(
        kBigCleanI, occlusion(M) ? occ0[t] : 0,
        __float_as_int(rays[tcap_row(M) * n_rays + t]));
    prune = block_max<R>(part, sh.red[0]) + kPrunePad;  // syncs sh.hull
    walks = (krow[0] & ~cmask) <= prune;
  }
  if (!walks) {
    if (threadIdx.x % K == 0) out[ray] = occlusion(M) ? occ : -1;
    if (rank == 0 && threadIdx.x == 0) visits[tile] = 0;
    return;
  }

  if (threadIdx.x == 0) {
    for (int p = 0; p < 2; ++p) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(cta_addr(&sh.bar[p])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int p = 0; p < 2; ++p) {
      expect_bytes(cta_addr(&sh.bar[p]), TileWalk<M, kStream, K, R>::kExchangeBytes);
    }
  }
  // The opening cluster barrier: no CTA sends before every CTA has armed
  // its mbarriers. Its wait comes after the first visit (TileWalk::run).
  cluster_arrive();

  const Ray<M> r(rays, n_rays, ray);
  TileWalk<M, kStream, K, R> t{sh, w, r, rank,
                               static_cast<int>(threadIdx.x % K), occ, prune};
  if (kHier) {
    const unsigned all = S == kSuperMax ? 0xffffffffu : ((1u << S) - 1u);
    Head h;
    load_head(h, krow, 0, bbox, first, cmask, S);
    for (int k = 0; k < count && (h.key & ~cmask) <= t.prune; ++k) {
      Members src{lane < S ? member_entry(sh.hull, h.box) : INT_MAX, all, h.fs};
      if (k + 1 < count) {  // in flight while this super's members are walked
        load_head(h, krow, k + 1, bbox, first, cmask, S);
      }
      t.run(src);
    }
  } else {
    Row src(krow, count, cmask);
    t.run(src);
  }
  if (!t.joined) cluster_wait();
  // No CTA leaves while another may still send to it.
  cluster_arrive();
  cluster_wait();
  if (t.g == 0) out[ray] = occlusion(M) ? t.occ : t.pid;
  if (rank == 0 && threadIdx.x == 0) visits[tile] = t.nvis;
}

// The position of the k-th set bit (from 0) of m, which has more than k.
__device__ __forceinline__ int nth_bit(unsigned m, int k) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (k >= c) {
      k -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// The u-th set bit of the kW warps' ballots msk taken in order (warp v's
// bit l stands for thread 32 v + l): that thread, or -1 past the last.
template <int kW>
__device__ __forceinline__ int live_entry(const unsigned* msk, int u) {
  int before = 0;
#pragma unroll
  for (int v = 0; v < kW; ++v) {
    const int c = __popc(msk[v]);
    if (u >= before && u < before + c) return 32 * v + nth_bit(msk[v], u - before);
    before += c;
  }
  return -1;
}

// The split walk: the shadow walk at kR128 rays a tile (split_walk,
// split_list, split_more and split_replay; the design is in the header
// comment). A unit is up to R / K of a tile's rays (K threads a ray, one
// CTA) over one segment of the tile's key row: it visits the segment's
// blocks in order while their entry is within the unit's own prune, and
// notes for each of its rays the position of its first occluder (flat:
// the candidate's index in the row; two-level: kSuperMax x the super's
// index + the member's rank in entry order).

// Candidates [pos, end) of a tile's key row, each key read two ahead;
// pop() also gives the candidate's position.
struct SegRow {
  const int* krow;
  int end, cmask, pos, k0, k1;

  __device__ __forceinline__ SegRow(const int* krow, int begin, int end,
                                    int cmask)
      : krow(krow), end(end), cmask(cmask), pos(begin) {
    k0 = pos < end ? krow[pos] : 0;
    k1 = pos + 1 < end ? krow[pos + 1] : 0;
  }

  __device__ __forceinline__ int pop(int* m, int* q) {
    const int key = k0;
    *m = pos < end ? (key & ~cmask) : INT_MAX;
    *q = pos;
    k0 = k1;
    k1 = pos + 2 < end ? krow[pos + 2] : 0;
    ++pos;
    return key & cmask;
  }
};

// The members of one super (first block fs) in entry order, as Members;
// the member of rank j has position pos + j.
struct SegMembers {
  int ent;
  unsigned rem;
  int fs, pos;

  __device__ __forceinline__ int pop(int* m, int* q) {
    const int s = next_member(ent, rem, m);
    rem &= ~(1u << s);
    *q = pos++;
    return fs + s;
  }
};

template <int M, int R>
struct SplitShared {
  // The block being visited and the next two in visiting order.
  alignas(16) float sw[3][kC * rec_floats(M)];
  int red[2][R / 32];     // block_max's buffers, alternating
  float hull[kHullCols];  // two-level walk: the tile's hull row
};

// Stage block blk into dst if go; a streamed walk commits a copy group
// either way, so that wait_async<1> always waits for the block before.
template <int M, bool kStream, int R>
__device__ __forceinline__ void stage_if(float* dst, const float* w, int blk,
                                         bool go) {
  if (go) {
    stage_block<M, kStream, R>(dst, w, blk);
  } else if (kStream) {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
}

// One unit's walk state: a ray on K threads (g its thread among them).
// Its prune is the max over its own rays only.
template <int M, bool kStream, int K, int R>
struct GroupWalk {
  SplitShared<M, R>& sh;
  const float* w;
  const Ray<M>& r;
  int g, occ;
  int prune = 0;
  int found = INT_MAX;  // position of this ray's first occluder here
  int red = 0;

  // The unit's prune: the max of its rays' parts (block_max's barrier).
  __device__ __forceinline__ void renew() {
    prune = block_max<R>(prune_part<M>(kBigCleanI, occ, r.tcap),
                         sh.red[red]) + kPrunePad;
    red ^= 1;
  }

  // Visit src's blocks in order while the next entry is within the
  // unit's prune, renewed after every visit. Two blocks are copied ahead
  // of the one visited, each if its entry is within the prune of its
  // copy (the prune only falls, so a block it excludes is never visited).
  template <class Src>
  __device__ __forceinline__ void run(Src& src) {
    int m, q, m2, q2;
    const int cur = src.pop(&m, &q);
    if (m > prune) return;
    const int nxt = src.pop(&m2, &q2);
    __syncthreads();  // the last run's reads of sw are done
    int b = 0;        // sw[b] holds the block visited, sw[b + 1] the next
    stage_block<M, kStream, R>(sh.sw[0], w, cur);
    stage_if<M, kStream, R>(sh.sw[1], w, nxt, m2 <= prune);
    if (kStream) wait_async<1>();
    __syncthreads();
    while (true) {
      if (visit_result<M, K>(sh.sw[b], occ, r, g)) {  // 0 once occluded
        occ = 1;
        found = q;
      }
      // sw[(b + 2) % 3] was last read before the last renew's barrier.
      int m3, q3;
      const int after = src.pop(&m3, &q3);
      stage_if<M, kStream, R>(sh.sw[(b + 2) % 3], w, after, m3 <= prune);
      if (kStream) wait_async<1>();  // the next block; renew publishes it
      renew();
      if (m2 > prune) break;
      q = q2;
      m2 = m3;
      q2 = q3;
      b = (b + 1) % 3;
    }
    if (kStream) wait_async<0>();  // drain copies left behind
  }
};

// One unit over candidates [k0, k1) of tile `tile`'s key row (supers for
// the two-level walk), this thread on ray `ray` of the tile (-1: none)
// with the other K - 1 threads of that ray. A ray starts live unless it
// starts occluded or, after the first segment, a unit has already found
// an occluder of it before k0's position (pstar). The first segment
// stores each ray's first occluding position (INT_MAX: none); a later
// one takes the min with it.
template <int M, bool kStream, int K, bool kHier, int R>
__device__ __forceinline__ void walk_unit(
    SplitShared<M, R>& sh, int tile, int ray, int k0, int k1, bool opening,
    const int* keys, const float* rays, const float* w, const int* occ0,
    const float* hull, const float* bbox, const int* first, int* pstar,
    int n_rays, int n_k, int cmask, int S) {
  const int lane = threadIdx.x & 31;
  const int at = tile * R + max(ray, 0);
  int occ = ray < 0 || occ0[at] != 0;
  if (!opening && !occ
      && __ldcg(&pstar[at]) < (kHier ? k0 * kSuperMax : k0)) {
    occ = 1;
  }
  const Ray<M> r(rays, n_rays, at);
  GroupWalk<M, kStream, K, R> t{sh, w, r, static_cast<int>(threadIdx.x % K),
                                occ};
  __syncthreads();  // the last unit's reads of sh are done
  if (kHier && threadIdx.x < kHullCols) {
    sh.hull[threadIdx.x] = hull[(size_t)tile * kHullCols + threadIdx.x];
  }
  t.renew();  // its barrier publishes sh.hull
  const int* krow = keys + (size_t)tile * n_k;
  if (kHier) {
    const unsigned all = S == kSuperMax ? 0xffffffffu : ((1u << S) - 1u);
    Head h;
    if (k0 < k1) load_head(h, krow, k0, bbox, first, cmask, S);
    for (int k = k0; k < k1 && (h.key & ~cmask) <= t.prune; ++k) {
      SegMembers src{lane < S ? member_entry(sh.hull, h.box) : INT_MAX, all,
                     h.fs, k * kSuperMax};
      if (k + 1 < k1) {  // in flight while this super's members are walked
        load_head(h, krow, k + 1, bbox, first, cmask, S);
      }
      t.run(src);
    }
  } else {
    SegRow src(krow, k0, k1, cmask);
    t.run(src);
  }
  if (t.g == 0 && ray >= 0) {
    if (opening) {
      pstar[at] = t.found;
    } else if (t.found != INT_MAX) {
      atomicMin(&pstar[at], t.found);
    }
  }
}

// Pass 1: the first segment (seg candidates) of every ray group, one CTA
// each: group c of a tile is its rays c R / K to (c + 1) R / K - 1.
template <int M, bool kStream, int K, bool kHier, int R>
__global__ void __launch_bounds__(R, min_ctas(M, R))
split_walk(const int* __restrict__ counts, const int* __restrict__ keys,
           const float* __restrict__ rays, const float* __restrict__ w,
           const int* __restrict__ occ0, const float* __restrict__ hull,
           const float* __restrict__ bbox, const int* __restrict__ first,
           int* __restrict__ pstar, int n_rays, int n_k, int cmask, int S,
           int seg) {
  __shared__ SplitShared<M, R> sh;
  const int tile = blockIdx.x / K;
  const int ray = blockIdx.x % K * (R / K) + threadIdx.x / K;
  const int count = counts[tile];
  if (count == 0) {  // most tiles of a frame see no candidate
    if (threadIdx.x % K == 0) pstar[tile * R + ray] = INT_MAX;
    return;
  }
  walk_unit<M, kStream, K, kHier, R>(sh, tile, ray, 0, min(count, seg),
                                     true, keys, rays, w, occ0, hull, bbox,
                                     first, pstar, n_rays, n_k, cmask, S);
}

// Between the passes, one warp a tile. A tile with candidates past its
// first segment, rays that no unit has found occluded (nor started so)
// and the next candidate within their prune takes the later segments,
// each on units of R / K of those rays: the tile is listed in list with
// its units, at off the index of its first unit-segment among all tiles'
// (one 64-bit atomic on ctr counts tiles and unit-segments, so off rises
// with the list).
template <int K, int R>
__global__ void __launch_bounds__(kR128)
split_list(const int* __restrict__ counts, const int* __restrict__ keys,
           const float* __restrict__ rays, const int* __restrict__ occ0,
           const int* __restrict__ pstar, unsigned long long* __restrict__ ctr,
           int* __restrict__ list, int* __restrict__ units,
           int* __restrict__ off, int n_tiles, int n_rays, int n_k,
           int cmask, int seg) {
  const int tile = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (tile >= n_tiles) return;
  const int count = counts[tile];
  if (count <= seg) return;
  int live = 0, part = kNegI;
#pragma unroll
  for (int i = lane; i < R; i += 32) {
    const int ray = tile * R + i;
    if (!occ0[ray] && pstar[ray] == INT_MAX) {
      ++live;
      part = max(part,
                 __float_as_int(rays[tcap_row(kAnyDest) * n_rays + ray]));
    }
  }
  live = __reduce_add_sync(0xffffffffu, live);
  part = __reduce_max_sync(0xffffffffu, part) + kPrunePad;
  if (lane == 0 && live > 0
      && (keys[(size_t)tile * n_k + seg] & ~cmask) <= part) {
    const int n = (live + R / K - 1) / (R / K);
    const unsigned items = n * ((count - 1) / seg);  // later segments
    const unsigned long long at = atomicAdd(ctr, (1ull << 32) | items);
    list[at >> 32] = tile;
    units[at >> 32] = n;
    off[at >> 32] = static_cast<int>(at & 0xffffffffu);
  }
}

// Pass 2: the later segments of the listed tiles, on a grid of the CTAs
// the card holds at once; CTA c takes unit-segments c, c + gridDim.x, ...
// Unit j of a segment walks the rays live after the first segment from
// the (j R / K)-th on, in ray order; it drops those that an earlier
// segment has since found occluded.
template <int M, bool kStream, int K, bool kHier, int R>
__global__ void __launch_bounds__(R, min_ctas(M, R))
split_more(const int* __restrict__ counts, const int* __restrict__ keys,
           const float* __restrict__ rays, const float* __restrict__ w,
           const int* __restrict__ occ0, const float* __restrict__ hull,
           const float* __restrict__ bbox, const int* __restrict__ first,
           int* __restrict__ pstar, const unsigned long long* __restrict__ ctr,
           const int* __restrict__ list, const int* __restrict__ units,
           const int* __restrict__ off, int n_rays, int n_k, int cmask, int S,
           int seg) {
  __shared__ SplitShared<M, R> sh;
  __shared__ unsigned ballots[R / 32];  // the rays live after segment 0
  const unsigned long long c = *ctr;
  const int n_list = static_cast<int>(c >> 32);
  const int total = static_cast<int>(c & 0xffffffffu);
  // Later segments find occluders at this position or past it only, so
  // a ray live after the first segment stays at or past it.
  const int q1 = kHier ? seg * kSuperMax : seg;
  for (int i = blockIdx.x; i < total; i += gridDim.x) {
    int lo = 0, hi = n_list - 1;  // the last listed tile with off <= i
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (off[mid] <= i) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const int tile = list[lo], n = units[lo], j = i - off[lo];
    const int k0 = (1 + j / n) * seg;
    const int ray = tile * R + threadIdx.x;
    const unsigned b = __ballot_sync(
        0xffffffffu, !occ0[ray] && __ldcg(&pstar[ray]) >= q1);
    // The last unit read ballots before walk_unit's first barrier.
    if ((threadIdx.x & 31) == 0) ballots[threadIdx.x >> 5] = b;
    __syncthreads();
    walk_unit<M, kStream, K, kHier, R>(
        sh, tile,
        live_entry<R / 32>(ballots, j % n * (R / K) + threadIdx.x / K), k0,
        min(counts[tile], k0 + seg), false, keys, rays, w, occ0, hull, bbox,
        first, pstar, n_rays, n_k, cmask, S);
  }
}

// Pass 3, one CTA of kReplay threads a tile: the flags (start flags, or a
// first occluder found) and the executed visits of the tile's
// sequential walk, replayed from its rays' first occluding positions:
// before position q the rays live are those not started occluded whose
// first occluder is at q or later, so the tile prune there is the max of
// their caps + kPrunePad, and the walk takes candidates in order while
// their entry is within it (two-level: each super's members in entry
// order while within it). Both sides of that test are monotone in q, so
// the candidates taken are found by bisection, and a super over which
// the prune does not move takes every member within it.
constexpr int kReplay = 256;

template <bool kHier, int R>
__global__ void __launch_bounds__(kReplay)
split_replay(const int* __restrict__ counts, const int* __restrict__ keys,
             const float* __restrict__ rays, const int* __restrict__ occ0,
             const float* __restrict__ hull, const float* __restrict__ bbox,
             const int* __restrict__ first, const int* __restrict__ pstar,
             int* __restrict__ out, int* __restrict__ visits, int n_rays,
             int n_k, int cmask, int S) {
  constexpr int kW = kReplay / 32;
  __shared__ int at[R], part[R];  // each ray: live before at, its cap
  __shared__ float hl[kHullCols];
  __shared__ int taken, sum[kW];
  const int tile = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t < R) {
    const int ray = tile * R + t;
    const int p = pstar[ray], o = occ0[ray];
    out[ray] = o | (p != INT_MAX);
    at[t] = o ? -1 : p;
    part[t] = __float_as_int(rays[tcap_row(kAnyDest) * n_rays + ray]);
  }
  if (kHier && t < kHullCols) hl[t] = hull[(size_t)tile * kHullCols + t];
  __syncthreads();
  // The tile prune before position q, on one warp.
  auto prune_at = [&](int q) {
    int v = kNegI;
#pragma unroll
    for (int i = lane; i < R; i += 32) v = max(v, at[i] >= q ? part[i] : kNegI);
    return __reduce_max_sync(0xffffffffu, v) + kPrunePad;
  };
  const int* krow = keys + (size_t)tile * n_k;
  const int step = kHier ? kSuperMax : 1;
  if (warp == 0) {
    int lo = 0, hi = counts[tile];
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((krow[mid] & ~cmask) <= prune_at(mid * step)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lane == 0) taken = lo;
  }
  __syncthreads();
  const int n = taken;
  if (!kHier) {
    if (t == 0) visits[tile] = n;
    return;
  }
  const unsigned all = S == kSuperMax ? 0xffffffffu : ((1u << S) - 1u);
  int v = 0;
  Head h;
  if (warp < n) load_head(h, krow, warp, bbox, first, cmask, S);
  for (int k = warp; k < n; k += kW) {
    const int ent = lane < S ? member_entry(hl, h.box) : INT_MAX;
    if (k + kW < n) load_head(h, krow, k + kW, bbox, first, cmask, S);
    const int p0 = prune_at(k * kSuperMax);
    if (p0 == prune_at(k * kSuperMax + kSuperMax - 1)) {
      v += __popc(__ballot_sync(0xffffffffu, ent <= p0));
    } else {
      unsigned rem = all;
      for (int j = 0; j < S; ++j) {
        int m;
        const int s = next_member(ent, rem, &m);
        if (m > prune_at(k * kSuperMax + j)) break;
        rem &= ~(1u << s);
        ++v;
      }
    }
  }
  if (lane == 0) sum[warp] = v;
  __syncthreads();
  if (t == 0) {
    int total = 0;
#pragma unroll
    for (int i = 0; i < kW; ++i) total += sum[i];
    visits[tile] = total;
  }
}

// The resident flat walk: one CTA a tile (walk_solo). One CTA walks the
// whole tile, so the new prune is known right after each visit's block
// max: there is no exchange and no visit ahead of it. Each visit's block
// is staged with cp.async into one of two buffers as triangle records
// while the block before it is visited (Row reads the key row two
// candidates ahead), and one block barrier a visit, the prune max, follows
// the copy wait. A prefetched block whose entry the new prune excludes is
// dropped uncounted.
//
// The shadow walks hand the tile's live rays to the leading threads: at
// every prune max the R / 32 warps also publish the ballot of their still
// unoccluded rays and the ray each thread walked, and thread u takes the
// u-th live ray of that list (live_entry), in list order. So a warp walks
// only live rays, and warps past the live count skip the visit; the
// occlusion flags go into an R-bit mask, read once at the end.
template <int M, int R>
struct SoloShared {
  alignas(16) float sw[2][kC * rec_floats(M)];  // the block and the next
  // Alternating with the visits (one barrier each): the warps' maxima of
  // the prune, and (shadow walks) their live ballots and each thread's ray.
  int red[2][R / 32];
  unsigned live[2][R / 32];
  int ids[2][occlusion(M) ? R : 1];
  unsigned occm[R / 32];  // shadow walks: rays occluded during the walk
};

// One 512-thread CTA an SM as the launch bound (R / 512 of an SM a CTA of R
// threads): the compiler gives a thread 72-90 registers, and the kernels
// ran up to 16% faster than at two CTAs an SM (64 registers) on the card
// (PERF.md, PR 6).
template <int M, int R>
__global__ void __launch_bounds__(R, kR / R)
walk_solo(const int* __restrict__ counts, const int* __restrict__ keys,
          const float* __restrict__ rays, const float* __restrict__ w,
          const int* __restrict__ occ0, int* __restrict__ out,
          int* __restrict__ visits, int n_rays, int n_k, int cmask) {
  constexpr int kW = R / 32;  // warps
  __shared__ SoloShared<M, R> sh;

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int base = tile * R;
  const int count = counts[tile];
  const int occ = occlusion(M) ? occ0[base + t] : 0;
  if (count == 0) {  // most tiles of a frame see no candidate
    out[base + t] = occlusion(M) ? occ : -1;
    if (t == 0) visits[tile] = 0;
    return;
  }

  // Closest walks: thread t walks ray t throughout. Shadow walks: thread
  // t walks ray rid of the tile (-1: none), chosen at every prune max.
  int rid = t;
  Ray<M> r(rays, n_rays, base + t);
  int best = kBigCleanI;  // closest: best t key (low lane bits clear)
  int pid = -1;           // closest: packed slot id of the winner
  int red = 0;            // the buffers of the next prune max
  if (occlusion(M) && t < kW) sh.occm[t] = 0;

  // The prune max: the part of each thread's ray (live: a shadow ray not
  // yet occluded), and for the shadow walks the handover of live rays.
  auto prune_max = [&](bool live) {
    const int part = occlusion(M) ? (live ? r.tcap : kNegI)
                                  : min(best, r.tcap);
    const int v = __reduce_max_sync(0xffffffffu, part);
    if (lane == 0) sh.red[red][t >> 5] = v;
    if (occlusion(M)) {
      const unsigned bal = __ballot_sync(0xffffffffu, live);
      if (lane == 0) sh.live[red][t >> 5] = bal;
      sh.ids[red][t] = rid;
    }
    __syncthreads();
    const int prune = __reduce_max_sync(0xffffffffu, sh.red[red][lane & (kW - 1)]);
    if (occlusion(M)) {
      const int at = live_entry<kW>(sh.live[red], t);
      rid = at < 0 ? -1 : sh.ids[red][at];
    }
    red ^= 1;
    return prune + kPrunePad;
  };

  int prune = prune_max(occ == 0);
  Row src(keys + (size_t)tile * n_k, count, cmask);
  int m, m2;
  int cur = src.pop(&m);
  int nvis = 0;
  if (m <= prune) {
    int nxt = src.pop(&m2);
    bool ahead = m2 <= prune;
    int b = 0;  // sh.sw[b] holds cur, sh.sw[b ^ 1] nxt
    stage_block<M, true, R>(sh.sw[b], w, cur);
    if (ahead) {
      stage_block<M, true, R>(sh.sw[b ^ 1], w, nxt);
      wait_async<1>();
    } else {
      wait_async<0>();
    }
    int held = t;  // the ray in r
    auto hold = [&] {
      if (occlusion(M) && rid >= 0 && rid != held) {
        r = Ray<M>(rays, n_rays, base + rid);
        held = rid;
      }
    };
    hold();
    __syncthreads();
    while (true) {
      bool live = true;  // closest walks: unused
      if (occlusion(M)) {
        const int x = rid >= 0 ? visit_result<M, 1>(sh.sw[b], 0, r, 0) : 0;
        if (x) atomicOr(&sh.occm[rid >> 5], 1u << (rid & 31));
        live = rid >= 0 && !x;
      } else {
        take_key(visit_result<M, 1>(sh.sw[b], 0, r, 0), cur, best, pid);
      }
      if (ahead) wait_async<0>();  // the prune max's barrier publishes it
      prune = prune_max(live);
      ++nvis;
      if (m2 > prune) break;  // nxt, if copied ahead, is dropped
      cur = nxt;
      b ^= 1;
      nxt = src.pop(&m2);
      ahead = m2 <= prune;  // sh.sw[b ^ 1] was last read before the barrier
      if (ahead) stage_block<M, true, R>(sh.sw[b ^ 1], w, nxt);
      hold();
    }
  }
  if (occlusion(M)) {
    out[base + t] = occ | ((sh.occm[t >> 5] >> lane) & 1);
  } else {
    out[base + t] = pid;
  }
  if (t == 0) visits[tile] = nvis;
}

// The cluster size K of walk_tile: the two-level walk (kHier) or the
// streamed flat walk.
constexpr int cluster_k(bool hier) { return hier ? kK : kKFlat; }

// The launch of walk_tile on n_tiles clusters of K CTAs of R threads (attr
// is the caller's, and must outlive the configuration).
inline cudaLaunchConfig_t tile_launch(int n_tiles, int K, int R,
                                      cudaStream_t st,
                                      cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = K;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * K);
  cfg.blockDim = dim3(R);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch walk_tile. A launch the card cannot place is refused, and the
// error is returned.
template <int M, bool kStream, bool kHier, int R>
int launch_tile(cudaStream_t st, const int* counts, const int* keys,
                const float* rays, const float* w, const int* occ0,
                const float* hull, const float* bbox, const int* first,
                int* out, int* visits, int n_tiles, int n_k, int cmask,
                int S) {
  constexpr int K = cluster_k(kHier);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = tile_launch(n_tiles, K, R, st, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, walk_tile<M, kStream, K, kHier, R>, counts, keys, rays, w, occ0,
      hull, bbox, first, out, visits, n_tiles * R, n_k, cmask, S);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// How many clusters of walk_tile the card holds at once (its registers and
// shared memory against the SMs of a cluster), or -cudaError_t.
template <int M, bool kStream, bool kHier, int R>
int resident_clusters() {
  constexpr int K = cluster_k(kHier);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = tile_launch(1, K, R, nullptr, &attr);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &n, walk_tile<M, kStream, K, kHier, R>, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

// How many CTAs of `threads` threads of kernel the card holds at once,
// or -cudaError_t.
template <class Kernel>
int card_ctas(Kernel kernel, int threads, int device) {
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, 0);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  return err != cudaSuccess ? -(int)err : per_sm * sms;
}

// How many CTAs of walk_solo the card holds at once, or -cudaError_t.
template <int M, int R>
int resident_solo(int device) {
  return card_ctas(walk_solo<M, R>, R, device);
}

// Tiles of the split walk the card holds at once: the CTAs of its first
// pass, K a tile.
template <int M, bool kStream, bool kHier>
int resident_split(int device) {
  const int n = card_ctas(split_walk<M, kStream, kK128, kHier, kR128>,
                          kR128, device);
  return n < 0 ? n : n / kK128;
}

template <int M, int R>
int resident_clusters(bool hier, bool stream_w, int device) {
  if (hier) {
    return stream_w ? resident_clusters<M, true, true, R>()
                    : resident_clusters<M, false, true, R>();
  }
  // The resident flat walk runs on single CTAs.
  return stream_w ? resident_clusters<M, true, false, R>()
                  : resident_solo<M, R>(device);
}

// The walks of 512-ray tiles: the flat walk (S = 1) on single CTAs
// (walk_solo) with resident weights, on clusters (walk_tile) streamed;
// the two-level walk on clusters in both forms.
template <int M>
int launch_walk(bool stream_w, const int* counts, const int* keys,
                const float* rays, const float* w, const int* occ0,
                const float* hull, const float* bbox, const int* first,
                int* out, int* visits, int n_tiles, int n_k, int cmask, int S,
                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S > 1) {
    return stream_w ? launch_tile<M, true, true, kR>(
                          st, counts, keys, rays, w, occ0, hull, bbox, first,
                          out, visits, n_tiles, n_k, cmask, S)
                    : launch_tile<M, false, true, kR>(
                          st, counts, keys, rays, w, occ0, hull, bbox, first,
                          out, visits, n_tiles, n_k, cmask, S);
  }
  if (stream_w) {
    return launch_tile<M, true, false, kR>(st, counts, keys, rays, w, occ0,
                                           hull, bbox, first, out, visits,
                                           n_tiles, n_k, cmask, 1);
  }
  walk_solo<M, kR><<<n_tiles, kR, 0, st>>>(counts, keys, rays, w, occ0, out,
                                           visits, n_tiles * kR, n_k, cmask);
  return (int)cudaGetLastError();
}

// The split walk on n_tiles tiles of kR128 rays: its passes, the later
// segments' (the list's counter cleared first) only where a key row is
// longer than a segment. scratch holds the counter (8 bytes), each
// ray's first occluding position, and the list of tiles with later
// segments, their units and offsets (n_tiles each at most). seg: block
// visits a segment (0: kSeg128); the two-level walk takes seg / S supers
// a segment (at least one).
template <int M, bool kStream, bool kHier>
int launch_split(const int* counts, const int* keys, const float* rays,
                 const float* w, const int* occ0, const float* hull,
                 const float* bbox, const int* first, int* out, int* visits,
                 int* scratch, int n_tiles, int n_k, int cmask, int S,
                 int seg, int device, void* stream) {
  constexpr int R = kR128, K = kK128;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rays = n_tiles * R;
  auto* ctr = reinterpret_cast<unsigned long long*>(scratch);
  int* pstar = scratch + 2;
  int* list = pstar + n_rays;
  int* units = list + n_tiles;
  int* off = units + n_tiles;
  seg = seg > 0 ? seg : kSeg128;
  if (kHier) seg = max(1, seg / S);
  split_walk<M, kStream, K, kHier, R><<<n_tiles * K, R, 0, st>>>(
      counts, keys, rays, w, occ0, hull, bbox, first, pstar, n_rays, n_k,
      cmask, S, seg);
  err = cudaGetLastError();
  // Later segments exist only where a key row is longer than a segment.
  if (err == cudaSuccess && n_k > seg) {
    // Pass 2's grid: the CTAs the card holds at once (one card a process).
    static const int ctas =
        card_ctas(split_more<M, kStream, K, kHier, R>, R, device);
    if (ctas < 0) return -ctas;
    err = cudaMemsetAsync(ctr, 0, sizeof(*ctr), st);
    if (err == cudaSuccess) {
      split_list<K, R><<<(n_tiles + 3) / 4, 128, 0, st>>>(
          counts, keys, rays, occ0, pstar, ctr, list, units, off, n_tiles,
          n_rays, n_k, cmask, seg);
      err = cudaGetLastError();
    }
    if (err == cudaSuccess) {
      split_more<M, kStream, K, kHier, R><<<ctas, R, 0, st>>>(
          counts, keys, rays, w, occ0, hull, bbox, first, pstar, ctr, list,
          units, off, n_rays, n_k, cmask, S, seg);
      err = cudaGetLastError();
    }
  }
  if (err == cudaSuccess) {
    split_replay<kHier, R><<<n_tiles, kReplay, 0, st>>>(
        counts, keys, rays, occ0, hull, bbox, first, pstar, out, visits,
        n_rays, n_k, cmask, S);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace

// One launch of a walk. counts (n_tiles,) int32; keys (n_tiles, n_k)
// int32 sorted ascending, n_k clusters (flat) or supers (two-level); rays
// (rows, n_tiles * tile) f32 (walk.py RAY_ROWS); w (n_c [+ S], planes,
// 128) f32, 16-byte aligned, zero-padded by S blocks for the two-level
// walk; occ0 (n_tiles * tile,) int32 the rays that start occluded
// (occlusion modes; null otherwise); hull (n_tiles, 16) f32 per-tile hull
// scalars, bbox (n_k, 8, S) f32 member boxes and first (n_k,) int32 first
// member of each super (two-level; null for the flat walk); out (n_tiles
// * tile,) int32, the packed slot id or -1 (closest) or the occlusion
// flag; visits (n_tiles,) int32 executed visits. mode as walk.py orders
// RAY_ROWS; S = 1 for the flat walk, 2..32 for the two-level walk;
// stream_w selects the streamed form. tile = 512, or 128 for any_dest
// (the shadow wavefront regrouped by receiver, megakernel.any_hit_to_point
// with regroup): the split walk, with scratch (2 + 131 n_tiles int32; null
// at 512) and seg (block visits a segment, 0: kSeg128). There the flat
// form stages blocks with cp.async either way: on resident weights plain
// copies were slower on the card (PERF.md). Returns a cudaError_t, or
// cudaErrorInvalidValue for a combination it does not take.
extern "C" int ceres_walk(const int* counts, const int* keys,
                          const float* rays, const float* w, const int* occ0,
                          const float* hull, const float* bbox,
                          const int* first, int* out, int* visits,
                          int* scratch, int mode, int tile, int stream_w,
                          int n_tiles, int n_k, int cmask, int S, int seg,
                          int device, void* stream) {
  const bool hier = S > 1, split = tile == kR128;
  if (mode < kClosest || mode > kAny || S < 1 || S > kSuperMax ||
      (tile != kR && !(split && mode == kAnyDest)) ||
      (occ0 != nullptr) != occlusion(mode) || (hull != nullptr) != hier ||
      (bbox != nullptr) != hier || (first != nullptr) != hier ||
      (scratch != nullptr) != split) {
    return (int)cudaErrorInvalidValue;
  }
  if (split) {
    if (!hier) {
      return launch_split<kAnyDest, true, false>(
          counts, keys, rays, w, occ0, hull, bbox, first, out, visits,
          scratch, n_tiles, n_k, cmask, S, seg, device, stream);
    }
    return stream_w
        ? launch_split<kAnyDest, true, true>(
              counts, keys, rays, w, occ0, hull, bbox, first, out, visits,
              scratch, n_tiles, n_k, cmask, S, seg, device, stream)
        : launch_split<kAnyDest, false, true>(
              counts, keys, rays, w, occ0, hull, bbox, first, out, visits,
              scratch, n_tiles, n_k, cmask, S, seg, device, stream);
  }
  switch (mode) {
    case kClosest:
      return launch_walk<kClosest>(stream_w != 0, counts, keys, rays, w,
                                   occ0, hull, bbox, first, out, visits,
                                   n_tiles, n_k, cmask, S, device, stream);
    case kClosestWindow:
      return launch_walk<kClosestWindow>(stream_w != 0, counts, keys, rays, w,
                                         occ0, hull, bbox, first, out, visits,
                                         n_tiles, n_k, cmask, S, device,
                                         stream);
    case kAnyDest:
      return launch_walk<kAnyDest>(stream_w != 0, counts, keys, rays, w,
                                   occ0, hull, bbox, first, out, visits,
                                   n_tiles, n_k, cmask, S, device, stream);
    default:
      return launch_walk<kAny>(stream_w != 0, counts, keys, rays, w, occ0,
                               hull, bbox, first, out, visits, n_tiles, n_k,
                               cmask, S, device, stream);
  }
}

// Tiles a walk (mode as walk.py orders RAY_ROWS, tiles of `tile` rays) has
// on the card at once: clusters of a cluster walk (two-level or streamed
// flat), or CTAs of the resident flat walk; or -cudaError_t. Tiles of 128
// rays exist for the any_dest walk only.
extern "C" int ceres_walk_resident_clusters(int mode, int hier, int stream_w,
                                            int tile, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  if (tile == kR128 && mode == kAnyDest) {
    if (hier) {
      return stream_w ? resident_split<kAnyDest, true, true>(device)
                      : resident_split<kAnyDest, false, true>(device);
    }
    return resident_split<kAnyDest, true, false>(device);
  }
  if (tile != kR) return -(int)cudaErrorInvalidValue;
  switch (mode) {
    case kClosest:
      return resident_clusters<kClosest, kR>(hier, stream_w, device);
    case kClosestWindow:
      return resident_clusters<kClosestWindow, kR>(hier, stream_w, device);
    case kAnyDest:
      return resident_clusters<kAnyDest, kR>(hier, stream_w, device);
    case kAny: return resident_clusters<kAny, kR>(hier, stream_w, device);
  }
  return -(int)cudaErrorInvalidValue;
}

// Span stamps (utils/spans.py). One thread writes the card's global timer
// (ns) into slots[k]; captured in a CUDA graph, it is one of the graph's
// nodes and each replay writes its own time. It replaces no TPU kernel:
// it times the phases of a replayed frame or step without a profiler.
// extern "C" keeps its name whole in a profiler trace.
extern "C" __global__ void ceres_span_stamp_kernel(long long* slots, int k) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  slots[k] = static_cast<long long>(t);
}

// Launch the stamp on `stream`; returns a cudaError_t.
extern "C" int ceres_span_stamp(long long* slots, int k, int device,
                                void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ceres_span_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      slots, k);
  return (int)cudaGetLastError();
}

// The nodes of a captured CUDA graph by type: counts[0] kernels, [1]
// copies, [2] fills, [3] any other; returns a cudaError_t.
extern "C" int ceres_graph_nodes(void* graph, long long* counts) {
  const cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return (int)err;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0) {
    err = cudaGraphGetNodes(g, nodes.data(), &n);
    if (err != cudaSuccess) return (int)err;
  }
  for (int i = 0; i < 4; ++i) counts[i] = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return (int)err;
    switch (type) {
      case cudaGraphNodeTypeKernel: ++counts[0]; break;
      case cudaGraphNodeTypeMemcpy: ++counts[1]; break;
      case cudaGraphNodeTypeMemset: ++counts[2]; break;
      default: ++counts[3];
    }
  }
  return (int)cudaSuccess;
}

extern "C" const char* ceres_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
