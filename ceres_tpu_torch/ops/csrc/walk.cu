// Per-tile front-to-back cluster walk: the closest-hit and shadow kernels,
// flat or two-level, with weights staged synchronously or streamed.
//
// Replaces the variants of the JAX package's Pallas walk kernel
// (ceres_tpu/ops/megakernel.py, _make_walk_kernel launched by _walk_pallas):
//   walk_flat<false, false>   closest, flat, resident (the final `else` branch
//                             with mt_accept and winner_update): the primary
//                             wavefront, from _closest_search.
//   walk_flat<true, false>    any_dest, flat, resident (the any-hit branch):
//                             the shadow wavefront cast from the sun, from
//                             any_hit_to_point.
//   walk_flat<*, true>        the same with streamed weights (stream=True:
//                             _copy / start_fetch / wait_fetch, fetch_wait
//                             and the drain at early exit).
//   walk_hier<false, *>       two-level closest (S > 1: block_entries, the
//                             in-super priority walk, winner_update).
//   walk_hier<true, *>        two-level any_dest.
// The plain PyTorch versions that define the exact results are in
// ceres_tpu_torch/ops/walk.py (_walk_closest_plain, _walk_any_dest_plain).
//
// What one block computes. One block per tile of kR = 512 rays, one ray per
// thread. The tile's candidates arrive as one sorted int32 key row
// (entry-bound f32 bits with the low cid bits cleared | candidate id). The
// block walks the row front to back while
//     k < count  &&  (key_k & ~cmask) <= prune,
// where prune is the tile's maximum over rays of min(best t key, root exit)
// (closest) or of the root exit of the still unoccluded rays (any_dest),
// plus kPrunePad int ulps. The prune is block-uniform, so every thread takes
// the same trip count and the barriers in the loops are safe. Per visit the
// block has a cluster's 10 x 128 weight floats (5 KB) in shared memory and
// each thread runs Möller-Trumbore against the 128 triangles.
//
// Flat walk: a candidate is one cluster. Two-level walk: a candidate is a
// super of up to S <= 32 consecutive clusters (first[sid] + s). Lanes
// 0..S-1 of warp 0 slab-test the tile's direction hull (hull row) against
// the S member boxes (bbox) into S entry bounds in shared memory; then every
// thread repeatedly takes the live member with the smallest entry (ties to
// the lowest slot), visits it while that entry is <= the live prune, and
// refreshes the prune after every member visit. Executed member visits are
// the traversal statistic.
//
// Streamed weights. The TPU kernel fetched each visit's block by DMA from
// HBM into VMEM and prefetched visit k + 1 during visit k. Here the block
// goes into one of two shared-memory buffers as 320 16-byte cp.async copies
// (threads 0..319), the next visit's block is copied into the other buffer
// while the current one is walked, and cp.async.wait_group orders the two.
// In the flat walk "the next visit" is candidate k + 1; in the two-level
// walk it is the next live member in priority order, fetched speculatively
// when its entry is within the current prune (the prune only falls). A copy
// still in flight at an early exit is drained. The resident variants stage
// each block synchronously, as the bunny kernels always did. Both forms give
// the same outputs.
//
// What bounds it on an H100. Each member visit is 512 x 128 ray-triangle
// pairs at about 25 fp32 operations each, on the CUDA cores, plus a
// block-wide barrier: ~18 us for one block. One block walks one tile, so
// on big scenes the kernel takes as long as its slowest tile (at 1.27M
// triangles one tile runs 3,120 member visits). Weights are 5 KB per visit
// per block; a 1.27M-triangle scene holds 100 MB of them, more than the
// 50 MB L2. Streaming hides their fetch behind the previous visit, and
// measured no faster than staging: the fetch is small against the
// arithmetic. Tensor cores are no use here: the search needs full fp32.
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
constexpr int kPlanes = 10;        // weight rows: cu.xyz, cv.xyz, n.xyz, tn
constexpr int kBlockFloats = kPlanes * kC;   // 1,280 floats = 5,120 bytes
constexpr int kCopies = kBlockFloats / 4;    // 320 16-byte cp.async copies
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

// Synchronous staging of one cluster's weights (every thread takes part;
// the caller orders it with barriers).
__device__ __forceinline__ void stage_sync(float* dst, const float* src) {
  for (int i = threadIdx.x; i < kBlockFloats; i += kR) dst[i] = src[i];
}

// Asynchronous staging: threads 0..319 each start one 16-byte copy, and
// every thread commits a group, so all threads count the same groups.
__device__ __forceinline__ void stage_async(float* dst, const float* src) {
  if (threadIdx.x < kCopies) {
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

// Closest-hit visit of one cluster (weights sw, packed id base cid * kC):
// update this ray's best t key and winner slot.
__device__ __forceinline__ void visit_closest(const float* sw, int cid,
                                              float dx, float dy, float dz,
                                              int& best, int& pid) {
  int kmin = INT_MAX;
  for (int j = 0; j < kC; ++j) {
    const float nu = dx * sw[0 * kC + j] + dy * sw[1 * kC + j] + dz * sw[2 * kC + j];
    const float nv = dx * sw[3 * kC + j] + dy * sw[4 * kC + j] + dz * sw[5 * kC + j];
    const float nd = dx * sw[6 * kC + j] + dy * sw[7 * kC + j] + dz * sw[8 * kC + j];
    const float nt = sw[9 * kC + j];
    const float s = nd >= 0.f ? 1.f : -1.f;
    const float uvw = fminf(fminf(nu * s, nv * s), (nd - nu - nv) * s);
    int key = kBigCleanI | j;
    if (fminf(uvw, nt * s) >= 0.f && nd != 0.f) {
      key = (__float_as_int(nt * __frcp_rn(nd)) & ~kIdxMask) | j;
    }
    kmin = min(kmin, key);
  }
  const int t_new = kmin & ~kIdxMask;
  if (t_new < best) {
    best = t_new;
    pid = cid * kC + (kmin & kIdxMask);
  }
}

// Shadow visit of one cluster: set occ if a triangle lies between the sun
// (t = 0) and the receiving point (t = 1), short of the point by _DEST_EPS.
// Occluded rays skip the loop; the loop stops at the first occluder.
__device__ __forceinline__ void visit_any_dest(const float* sw, float dx,
                                               float dy, float dz, int& occ) {
  if (occ != 0) return;
  for (int j = 0; j < kC; ++j) {
    const float nu = dx * sw[0 * kC + j] + dy * sw[1 * kC + j] + dz * sw[2 * kC + j];
    const float nv = dx * sw[3 * kC + j] + dy * sw[4 * kC + j] + dz * sw[5 * kC + j];
    const float nd = dx * sw[6 * kC + j] + dy * sw[7 * kC + j] + dz * sw[8 * kC + j];
    const float nt = sw[9 * kC + j];
    const float s = nd >= 0.f ? 1.f : -1.f;
    const float uvw = fminf(fminf(nu * s, nv * s), (nd - nu - nv) * s);
    const bool win = ((nt - kDestScale * nd) * s <= 0.f) && (nt * s >= 0.f);
    if (uvw >= 0.f && nd != 0.f && win) {
      occ = 1;
      return;
    }
  }
}

template <bool kAnyDest>
__device__ __forceinline__ int tile_prune(int best, int occ, int tcap,
                                          int* sred) {
  return block_max(kAnyDest ? (occ > 0 ? kNegI : tcap) : min(best, tcap),
                   sred) + kPrunePad;
}

template <bool kAnyDest, bool kStream>
__global__ void __launch_bounds__(kR)
walk_flat(const int* __restrict__ counts, const int* __restrict__ keys,
          const float* __restrict__ rays, const float* __restrict__ w,
          const int* __restrict__ occ0, int* __restrict__ out,
          int* __restrict__ visits, int n_rays, int n_c, int cmask) {
  __shared__ __align__(16) float sw[2][kBlockFloats];
  __shared__ int sred[kWarps];

  const int tile = blockIdx.x;
  const int ray = tile * kR + threadIdx.x;
  const float dx = rays[ray];
  const float dy = rays[n_rays + ray];
  const float dz = rays[2 * n_rays + ray];
  const int tcap = __float_as_int(rays[3 * n_rays + ray]);
  const int count = counts[tile];
  const int* krow = keys + (size_t)tile * n_c;

  int best = kBigCleanI;  // closest: best t key (low lane bits clear)
  int pid = -1;           // closest: packed slot id of the winner
  int occ = kAnyDest ? occ0[ray] : 0;
  int prune = tile_prune<kAnyDest>(best, occ, tcap, sred);

  if (kStream && count > 0) {
    stage_async(sw[0], w + (size_t)(krow[0] & cmask) * kBlockFloats);
  }
  int k = 0;
  while (k < count && (krow[k] & ~cmask) <= prune) {
    const int cid = krow[k] & cmask;
    const float* cur = sw[0];
    __syncthreads();  // every thread is done with the previous cluster
    if (kStream) {
      if (k + 1 < count) {  // prefetch visit k + 1, wait for visit k
        stage_async(sw[(k + 1) & 1],
                    w + (size_t)(krow[k + 1] & cmask) * kBlockFloats);
        wait_async<1>();
      } else {
        wait_async<0>();
      }
      cur = sw[k & 1];
    } else {
      stage_sync(sw[0], w + (size_t)cid * kBlockFloats);
    }
    __syncthreads();

    if (kAnyDest) {
      visit_any_dest(cur, dx, dy, dz, occ);
    } else {
      visit_closest(cur, cid, dx, dy, dz, best, pid);
    }
    prune = tile_prune<kAnyDest>(best, occ, tcap, sred);
    ++k;
  }
  if (kStream) wait_async<0>();  // drain the prefetch an early exit left
  out[ray] = kAnyDest ? occ : pid;
  if (threadIdx.x == 0) visits[tile] = k;
}

// Entry bound (int bits) of the tile hull against member slot s of one
// super's boxes bb (kBoxRows x S): the _interval_entry slab test.
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

template <bool kAnyDest, bool kStream>
__global__ void __launch_bounds__(kR)
walk_hier(const int* __restrict__ counts, const int* __restrict__ keys,
          const float* __restrict__ rays, const float* __restrict__ w,
          const int* __restrict__ occ0, const float* __restrict__ hull,
          const float* __restrict__ bbox, const int* __restrict__ first,
          int* __restrict__ out, int* __restrict__ visits, int n_rays,
          int n_s, int cmask, int S) {
  __shared__ __align__(16) float sw[2][kBlockFloats];
  __shared__ int sred[kWarps];
  __shared__ int sent[kSuperMax];
  __shared__ float shl[kHullCols];

  const int tile = blockIdx.x;
  const int ray = tile * kR + threadIdx.x;
  const float dx = rays[ray];
  const float dy = rays[n_rays + ray];
  const float dz = rays[2 * n_rays + ray];
  const int tcap = __float_as_int(rays[3 * n_rays + ray]);
  const int count = counts[tile];
  const int* krow = keys + (size_t)tile * n_s;
  if (threadIdx.x < kHullCols) {
    shl[threadIdx.x] = hull[(size_t)tile * kHullCols + threadIdx.x];
  }

  int best = kBigCleanI;
  int pid = -1;
  int occ = kAnyDest ? occ0[ray] : 0;
  int prune = tile_prune<kAnyDest>(best, occ, tcap, sred);  // syncs shl too
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
    if (kStream) stage_async(sw[0], w + (size_t)(fs + s) * kBlockFloats);
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
          stage_async(sw[b ^ 1], w + (size_t)(fs + s2) * kBlockFloats);
          wait_async<1>();
        } else {
          wait_async<0>();
        }
        cur = sw[b];
      } else {
        __syncthreads();  // every thread is done with the previous member
        stage_sync(sw[0], w + (size_t)(fs + s) * kBlockFloats);
      }
      __syncthreads();

      if (kAnyDest) {
        visit_any_dest(cur, dx, dy, dz, occ);
      } else {
        visit_closest(cur, fs + s, dx, dy, dz, best, pid);
      }
      prune = tile_prune<kAnyDest>(best, occ, tcap, sred);
      ++nvis;
      if (m2 > prune) {
        if (ahead) wait_async<0>();  // drain the speculative fetch
        break;
      }
      s = s2;
      b ^= 1;
    }
  }
  out[ray] = kAnyDest ? occ : pid;
  if (threadIdx.x == 0) visits[tile] = nvis;
}

template <bool kAnyDest>
int launch_flat(bool stream_w, const int* counts, const int* keys,
                const float* rays, const float* w, const int* occ0, int* out,
                int* visits, int n_tiles, int n_c, int cmask, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rays = n_tiles * kR;
  if (stream_w) {
    walk_flat<kAnyDest, true><<<n_tiles, kR, 0, st>>>(
        counts, keys, rays, w, occ0, out, visits, n_rays, n_c, cmask);
  } else {
    walk_flat<kAnyDest, false><<<n_tiles, kR, 0, st>>>(
        counts, keys, rays, w, occ0, out, visits, n_rays, n_c, cmask);
  }
  return (int)cudaGetLastError();
}

template <bool kAnyDest>
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
    walk_hier<kAnyDest, true><<<n_tiles, kR, 0, st>>>(
        counts, keys, rays, w, occ0, hull, bbox, first, out, visits, n_rays,
        n_s, cmask, S);
  } else {
    walk_hier<kAnyDest, false><<<n_tiles, kR, 0, st>>>(
        counts, keys, rays, w, occ0, hull, bbox, first, out, visits, n_rays,
        n_s, cmask, S);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Flat walk. counts (n_tiles,) int32; keys (n_tiles, n_c) int32 sorted
// ascending; rays (4, n_tiles * 512) f32 rows [d.x, d.y, d.z, root-exit cap];
// w (n_c, 10, 128) f32, 16-byte aligned; out (n_tiles * 512,) int32 packed
// slot id or -1; visits (n_tiles,) int32 executed visits; stream_w selects
// the streamed form. Returns a cudaError_t.
extern "C" int ceres_walk_closest(const int* counts, const int* keys,
                                  const float* rays, const float* w, int* out,
                                  int* visits, int n_tiles, int n_c,
                                  int cmask, int stream_w, int device,
                                  void* stream) {
  return launch_flat<false>(stream_w != 0, counts, keys, rays, w, nullptr,
                            out, visits, n_tiles, n_c, cmask, device, stream);
}

// As ceres_walk_closest, with occ0 (n_tiles * 512,) int32 the rays that
// start occluded (skipped); out is the occlusion flag.
extern "C" int ceres_walk_any_dest(const int* counts, const int* keys,
                                   const float* rays, const float* w,
                                   const int* occ0, int* out, int* visits,
                                   int n_tiles, int n_c, int cmask,
                                   int stream_w, int device, void* stream) {
  return launch_flat<true>(stream_w != 0, counts, keys, rays, w, occ0, out,
                           visits, n_tiles, n_c, cmask, device, stream);
}

// Two-level walk. keys (n_tiles, n_s) are super candidates; w
// (n_c + S, 10, 128) the fine blocks, zero-padded by S; hull (n_tiles, 16)
// f32 per-tile hull scalars; bbox (n_s, 8, S) f32 member boxes; first (n_s,)
// int32 first member of each super; 2 <= S <= 32.
extern "C" int ceres_walk_closest_hier(const int* counts, const int* keys,
                                       const float* rays, const float* w,
                                       const float* hull, const float* bbox,
                                       const int* first, int* out,
                                       int* visits, int n_tiles, int n_s,
                                       int cmask, int S, int stream_w,
                                       int device, void* stream) {
  return launch_hier<false>(stream_w != 0, counts, keys, rays, w, nullptr,
                            hull, bbox, first, out, visits, n_tiles, n_s,
                            cmask, S, device, stream);
}

extern "C" int ceres_walk_any_dest_hier(const int* counts, const int* keys,
                                        const float* rays, const float* w,
                                        const int* occ0, const float* hull,
                                        const float* bbox, const int* first,
                                        int* out, int* visits, int n_tiles,
                                        int n_s, int cmask, int S,
                                        int stream_w, int device,
                                        void* stream) {
  return launch_hier<true>(stream_w != 0, counts, keys, rays, w, occ0, hull,
                           bbox, first, out, visits, n_tiles, n_s, cmask, S,
                           device, stream);
}

extern "C" const char* ceres_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
