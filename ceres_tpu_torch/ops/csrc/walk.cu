// Per-tile front-to-back cluster walk: the closest-hit and shadow kernels.
//
// Replaces the flat, VMEM-resident variants of the JAX package's Pallas
// walk kernel (ceres_tpu/ops/megakernel.py, _make_walk_kernel launched by
// _walk_pallas):
//   ceres_walk_closest  <- mode="closest"  (the final `else` branch with
//                          mt_accept and winner_update), called from
//                          _closest_search: the primary wavefront.
//   ceres_walk_any_dest <- mode="any_dest" (the any-hit branch), called
//                          from any_hit_to_point: the shadow wavefront,
//                          cast from the sun.
// The plain PyTorch versions that define the exact results are
// ceres_tpu_torch/ops/walk.py (_walk_closest_plain, _walk_any_dest_plain).
//
// What one block computes. One block per tile of kR = 512 rays, one ray per
// thread. The tile's candidate clusters arrive as one sorted int32 key row
// (entry-bound f32 bits with the low cid bits cleared | cluster id). The
// block walks the row front to back while
//     k < count  &&  (key_k & ~cmask) <= prune,
// where prune is the tile's maximum over rays of min(best t key, root exit)
// (closest) or of the root exit of the still unoccluded rays (any_dest),
// plus kPrunePad int ulps. The prune is block-uniform, so every thread takes
// the same trip count and the barriers in the loop are safe. Per visit the
// block stages the cluster's 10 x 128 weight floats (5 KB) in shared memory
// and each thread runs Möller-Trumbore against the 128 triangles.
//
// What bounds it on an H100. Each visit is 512 x 128 ray-triangle pairs at
// about 25 fp32 operations each, on the CUDA cores: the walk is bound by
// fp32 issue. Weights are read once per visit per block (5 KB, L2-resident:
// a bunny-sized scene holds 61 clusters, 305 KB) and keys once per visit,
// so memory traffic is small. Tensor cores are no use here: the search
// needs full fp32, and TF32 keeps only 10 mantissa bits.
//
// What the design does about it. One thread per ray keeps the per-visit
// work free of cross-thread reductions except the one block max for the
// prune (warp shuffles plus 16 shared-memory slots). Shared-memory weight
// reads are warp broadcasts (all threads read the same triangle). The
// shadow kernel skips the triangle loop for rays already occluded and
// leaves it at the first occluder. Making it faster (several rays per
// thread, FMA contraction, vectorised weight reads) is later work.
//
// Exactness. Built with --fmad=false and written in the plain version's
// operation order, so kernel and plain version agree bit for bit on the
// card. Comparisons of t, prune and entry bounds are signed int32 on f32
// bit patterns: dead and occluded rays carry negative bits (-1.0f).
// t = nt * (1/nd) with a correctly rounded reciprocal (two roundings, as in
// the JAX kernel), not nt / nd. Ties go to the lower lane (the key min) and
// to the earlier cluster (the strict < on the best key).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kC = 128;            // triangles per cluster (CLUSTER_SIZE)
constexpr int kIdxMask = kC - 1;   // lane bits of a winner key
constexpr int kR = 512;            // rays per tile (TILE) = threads per block
constexpr int kWarps = kR / 32;
constexpr int kPlanes = 10;        // weight rows: cu.xyz, cv.xyz, n.xyz, tn
constexpr int kPrunePad = 256;     // _PRUNE_PAD
constexpr int kBigCleanI = 0x7DB48E00;   // bits of f32(3e37) & ~127: no hit
constexpr int kNegI = -1082130432;       // bits of -1.0f: drops out of a max
constexpr float kDestScale = (float)(1.0 - 4e-6);  // 1 - _DEST_EPS

// Max of v over the block, returned to every thread.
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

template <bool kAnyDest>
__global__ void __launch_bounds__(kR)
walk_kernel(const int* __restrict__ counts, const int* __restrict__ keys,
            const float* __restrict__ rays, const float* __restrict__ w,
            const int* __restrict__ occ0, int* __restrict__ out,
            int* __restrict__ visits, int n_rays, int n_c, int cmask) {
  __shared__ float sw[kPlanes * kC];
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
  int prune = block_max(kAnyDest && occ > 0 ? kNegI : tcap, sred) + kPrunePad;

  int k = 0;
  while (k < count && (krow[k] & ~cmask) <= prune) {
    const int cid = krow[k] & cmask;
    __syncthreads();  // every thread is done with the previous cluster
    const float* wc = w + (size_t)cid * (kPlanes * kC);
    for (int i = threadIdx.x; i < kPlanes * kC; i += kR) sw[i] = wc[i];
    __syncthreads();

    if (kAnyDest) {
      if (occ == 0) {
        for (int j = 0; j < kC; ++j) {
          const float nu = dx * sw[0 * kC + j] + dy * sw[1 * kC + j] + dz * sw[2 * kC + j];
          const float nv = dx * sw[3 * kC + j] + dy * sw[4 * kC + j] + dz * sw[5 * kC + j];
          const float nd = dx * sw[6 * kC + j] + dy * sw[7 * kC + j] + dz * sw[8 * kC + j];
          const float nt = sw[9 * kC + j];
          const float s = nd >= 0.f ? 1.f : -1.f;
          const float uvw = fminf(fminf(nu * s, nv * s), (nd - nu - nv) * s);
          // Occluder iff it lies between the sun (t = 0) and the
          // receiving point (t = 1), short of the point by _DEST_EPS.
          const bool win = ((nt - kDestScale * nd) * s <= 0.f) && (nt * s >= 0.f);
          if (uvw >= 0.f && nd != 0.f && win) {
            occ = 1;
            break;
          }
        }
      }
      prune = block_max(occ > 0 ? kNegI : tcap, sred) + kPrunePad;
    } else {
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
      prune = block_max(min(best, tcap), sred) + kPrunePad;
    }
    ++k;
  }
  out[ray] = kAnyDest ? occ : pid;
  if (threadIdx.x == 0) visits[tile] = k;
}

int launch(bool any_dest, const int* counts, const int* keys,
           const float* rays, const float* w, const int* occ0, int* out,
           int* visits, int n_tiles, int n_c, int cmask, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rays = n_tiles * kR;
  if (any_dest) {
    walk_kernel<true><<<n_tiles, kR, 0, s>>>(counts, keys, rays, w, occ0, out,
                                             visits, n_rays, n_c, cmask);
  } else {
    walk_kernel<false><<<n_tiles, kR, 0, s>>>(counts, keys, rays, w, nullptr,
                                              out, visits, n_rays, n_c, cmask);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// counts (n_tiles,) int32; keys (n_tiles, n_c) int32 sorted ascending;
// rays (4, n_tiles * 512) f32 rows [d.x, d.y, d.z, root-exit cap];
// w (n_c, 10, 128) f32; out (n_tiles * 512,) int32 packed slot id or -1;
// visits (n_tiles,) int32 executed visits. Returns a cudaError_t.
extern "C" int ceres_walk_closest(const int* counts, const int* keys,
                                  const float* rays, const float* w, int* out,
                                  int* visits, int n_tiles, int n_c,
                                  int cmask, int device, void* stream) {
  return launch(false, counts, keys, rays, w, nullptr, out, visits, n_tiles,
                n_c, cmask, device, stream);
}

// As ceres_walk_closest, with occ0 (n_tiles * 512,) int32 the rays that
// start occluded (skipped); out is the occlusion flag.
extern "C" int ceres_walk_any_dest(const int* counts, const int* keys,
                                   const float* rays, const float* w,
                                   const int* occ0, int* out, int* visits,
                                   int n_tiles, int n_c, int cmask, int device,
                                   void* stream) {
  return launch(true, counts, keys, rays, w, occ0, out, visits, n_tiles, n_c,
                cmask, device, stream);
}

extern "C" const char* ceres_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
