// Native binned-SAH BVH builder: the C++ host-side build path of the port.
//
// A copy of ceres_tpu/accel/_native/bvh_build.cpp. Semantics are IDENTICAL
// to BinnedSahBuilder (ceres_tpu_torch/accel/golden_builders.py, itself a
// copy of the JAX package's): K centroid bins per axis, prefix/suffix SAH
// sweeps, leaf when the best split cost does not beat the leaf cost and the
// node fits max_leaf, forced largest-axis median split otherwise, stable
// partition, child pairs allocated adjacently, bounds stored interleaved
// [minx,maxx,miny,maxy,minz,maxz]. All scoring math in double so the
// emitted tree matches the NumPy builder node for node
// (tests/test_torch_builders.py asserts this).
//
// Single-threaded (determinism and parity are the point). C ABI only,
// consumed via ctypes (ceres_tpu_torch/accel/native.py), which compiles
// this file with g++ at first use into ceres_tpu_torch/_build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kMaxDepth = 64;        // top_down_builder.hpp:36
constexpr double kTraversalCost = 1.0;

struct Vec3 {
    double x[3];
};

struct Builder {
    const float* lo;       // (T, 3)
    const float* hi;       // (T, 3)
    const float* centers;  // (T, 3)
    int T;
    int bin_count;
    int max_leaf;

    std::vector<float> bounds;        // (cap, 6)
    std::vector<uint32_t> prim_count;
    std::vector<uint32_t> first_child;
    std::vector<uint32_t> order;
    int node_count = 1;

    double lo_d(int tri, int a) const { return lo[3 * tri + a]; }
    double hi_d(int tri, int a) const { return hi[3 * tri + a]; }
    double c_d(int tri, int a) const { return centers[3 * tri + a]; }
};

inline double half_area(const double* blo, const double* bhi) {
    double d0 = std::max(bhi[0] - blo[0], 0.0);
    double d1 = std::max(bhi[1] - blo[1], 0.0);
    double d2 = std::max(bhi[2] - blo[2], 0.0);
    return d0 * (d1 + d2) + d1 * d2;
}

void set_bounds(Builder& b, int node, const uint32_t* ids, int n) {
    double blo[3] = {1e300, 1e300, 1e300};
    double bhi[3] = {-1e300, -1e300, -1e300};
    for (int i = 0; i < n; ++i)
        for (int a = 0; a < 3; ++a) {
            blo[a] = std::min(blo[a], b.lo_d(ids[i], a));
            bhi[a] = std::max(bhi[a], b.hi_d(ids[i], a));
        }
    for (int a = 0; a < 3; ++a) {
        b.bounds[6 * node + 2 * a] = static_cast<float>(blo[a]);
        b.bounds[6 * node + 2 * a + 1] = static_cast<float>(bhi[a]);
    }
}

void node_union(Builder& b, const uint32_t* ids, int n, double* blo,
                double* bhi) {
    for (int a = 0; a < 3; ++a) { blo[a] = 1e300; bhi[a] = -1e300; }
    for (int i = 0; i < n; ++i)
        for (int a = 0; a < 3; ++a) {
            blo[a] = std::min(blo[a], b.lo_d(ids[i], a));
            bhi[a] = std::max(bhi[a], b.hi_d(ids[i], a));
        }
}

// Returns true and fills (axis, mid) when a paying SAH split exists; the
// partitioned order is written back into ids. Mirrors
// golden_builders.BinnedSahBuilder._find_split exactly.
bool find_split(Builder& b, uint32_t* ids, int size, int* out_axis,
                int* out_mid, std::vector<uint32_t>& scratch,
                std::vector<int32_t>& which_buf) {
    const int K = b.bin_count;
    double blo[3], bhi[3];
    node_union(b, ids, size, blo, bhi);
    double node_area = half_area(blo, bhi);

    double best_cost = std::numeric_limits<double>::infinity();
    int best_axis = -1;
    int best_bin = -1;

    std::vector<double> bin_lo(K * 3), bin_hi(K * 3);
    std::vector<int64_t> counts(K);

    for (int axis = 0; axis < 3; ++axis) {
        double cmin = 1e300, cmax = -1e300;
        for (int i = 0; i < size; ++i) {
            double c = b.c_d(ids[i], axis);
            cmin = std::min(cmin, c);
            cmax = std::max(cmax, c);
        }
        if (cmax <= cmin) continue;
        std::fill(counts.begin(), counts.end(), 0);
        for (int k = 0; k < K; ++k)
            for (int a = 0; a < 3; ++a) {
                bin_lo[3 * k + a] = 1e300;
                bin_hi[3 * k + a] = -1e300;
            }
        int32_t* which = which_buf.data();
        for (int i = 0; i < size; ++i) {
            double c = b.c_d(ids[i], axis);
            int64_t w = static_cast<int64_t>((c - cmin) / (cmax - cmin) * K);
            if (w > K - 1) w = K - 1;
            which[i] = static_cast<int32_t>(w);
            counts[w] += 1;
            for (int a = 0; a < 3; ++a) {
                bin_lo[3 * w + a] = std::min(bin_lo[3 * w + a],
                                             b.lo_d(ids[i], a));
                bin_hi[3 * w + a] = std::max(bin_hi[3 * w + a],
                                             b.hi_d(ids[i], a));
            }
        }
        // Suffix (right) sweep of areas + counts, then prefix walk.
        std::vector<double> right_area(K);
        std::vector<int64_t> right_cnt(K);
        {
            double rlo[3] = {1e300, 1e300, 1e300};
            double rhi[3] = {-1e300, -1e300, -1e300};
            int64_t rc = 0;
            for (int k = K - 1; k >= 0; --k) {
                for (int a = 0; a < 3; ++a) {
                    rlo[a] = std::min(rlo[a], bin_lo[3 * k + a]);
                    rhi[a] = std::max(rhi[a], bin_hi[3 * k + a]);
                }
                rc += counts[k];
                right_area[k] = half_area(rlo, rhi);
                right_cnt[k] = rc;
            }
        }
        double llo[3] = {1e300, 1e300, 1e300};
        double lhi[3] = {-1e300, -1e300, -1e300};
        int64_t lc = 0;
        for (int k = 0; k + 1 < K; ++k) {
            for (int a = 0; a < 3; ++a) {
                llo[a] = std::min(llo[a], bin_lo[3 * k + a]);
                lhi[a] = std::max(lhi[a], bin_hi[3 * k + a]);
            }
            lc += counts[k];
            if (lc == 0 || lc == size) continue;
            double cost = half_area(llo, lhi) * static_cast<double>(lc)
                        + right_area[k + 1]
                              * static_cast<double>(right_cnt[k + 1]);
            if (cost < best_cost) {
                best_cost = cost;
                best_axis = axis;
                best_bin = k;
            }
        }
    }

    if (best_axis < 0) return false;
    if (best_cost / node_area + kTraversalCost >= static_cast<double>(size)
        && size <= b.max_leaf)
        return false;

    // Stable partition: left bins (<= best_bin) first, original order kept
    // within each side — matches np.concatenate([ids[sel], ids[~sel]]).
    double cmin = 1e300, cmax = -1e300;
    for (int i = 0; i < size; ++i) {
        double c = b.c_d(ids[i], best_axis);
        cmin = std::min(cmin, c);
        cmax = std::max(cmax, c);
    }
    uint32_t* left = scratch.data();
    uint32_t* right = scratch.data() + size;
    int nl = 0, nr = 0;
    const int K2 = b.bin_count;
    for (int i = 0; i < size; ++i) {
        double c = b.c_d(ids[i], best_axis);
        int64_t w = static_cast<int64_t>((c - cmin) / (cmax - cmin) * K2);
        if (w > K2 - 1) w = K2 - 1;
        if (w <= best_bin) left[nl++] = ids[i];
        else right[nr++] = ids[i];
    }
    if (nl == 0 || nl == size) return false;
    std::memcpy(ids, left, nl * sizeof(uint32_t));
    std::memcpy(ids + nl, right, nr * sizeof(uint32_t));
    *out_axis = best_axis;
    *out_mid = nl;
    return true;
}

void build_range(Builder& b, int node, int begin, int end, int depth,
                 std::vector<uint32_t>& scratch,
                 std::vector<int32_t>& which_buf) {
    int size = end - begin;
    if (size <= 1 || depth >= kMaxDepth) {
        b.prim_count[node] = static_cast<uint32_t>(size);
        b.first_child[node] = static_cast<uint32_t>(begin);
        return;
    }
    uint32_t* ids = b.order.data() + begin;
    int axis = -1, mid = -1;
    if (!find_split(b, ids, size, &axis, &mid, scratch, which_buf)) {
        if (size <= b.max_leaf) {
            b.prim_count[node] = static_cast<uint32_t>(size);
            b.first_child[node] = static_cast<uint32_t>(begin);
            return;
        }
        // Forced largest-axis median split (binned_sah_builder.hpp:180-196
        // fallback semantics, as in the golden builder): stable sort by
        // centroid on the largest extent axis, split at size/2.
        double blo[3], bhi[3];
        node_union(b, ids, size, blo, bhi);
        int fa = 0;
        double ext = -1.0;
        for (int a = 0; a < 3; ++a)
            if (bhi[a] - blo[a] > ext) { ext = bhi[a] - blo[a]; fa = a; }
        std::stable_sort(ids, ids + size, [&](uint32_t u, uint32_t v) {
            return b.c_d(u, fa) < b.c_d(v, fa);
        });
        mid = size / 2;
    }
    int left = b.node_count;
    b.node_count += 2;
    b.first_child[node] = static_cast<uint32_t>(left);
    b.prim_count[node] = 0;
    set_bounds(b, left, ids, mid);
    set_bounds(b, left + 1, ids + mid, size - mid);
    build_range(b, left, begin, begin + mid, depth + 1, scratch, which_buf);
    build_range(b, left + 1, begin + mid, end, depth + 1, scratch, which_buf);
}

struct Handle {
    std::vector<float> bounds;
    std::vector<uint32_t> prim_count;
    std::vector<uint32_t> first_child;
    std::vector<uint32_t> order;
};

}  // namespace

extern "C" {

// Build a binned-SAH BVH over T primitive boxes. Outputs live until
// ceres_bvh_free(handle). Returns 0 on success.
int ceres_bvh_build_binned(const float* tri_lo, const float* tri_hi,
                           const float* centers, int T, int bin_count,
                           int max_leaf, float** out_bounds,
                           uint32_t** out_prim_count,
                           uint32_t** out_first_child,
                           uint32_t** out_prim_indices, int* out_node_count,
                           void** out_handle) {
    if (T <= 0 || bin_count < 2 || max_leaf < 1) return 1;
    Builder b;
    b.lo = tri_lo;
    b.hi = tri_hi;
    b.centers = centers;
    b.T = T;
    b.bin_count = bin_count;
    b.max_leaf = max_leaf;
    size_t cap = 2 * static_cast<size_t>(T) + 1;
    b.bounds.assign(cap * 6, 0.0f);
    b.prim_count.assign(cap, 0);
    b.first_child.assign(cap, 0);
    b.order.resize(T);
    for (int i = 0; i < T; ++i) b.order[i] = static_cast<uint32_t>(i);

    std::vector<uint32_t> scratch(2 * static_cast<size_t>(T));
    std::vector<int32_t> which(T);
    set_bounds(b, 0, b.order.data(), T);
    build_range(b, 0, 0, T, 0, scratch, which);

    int n = b.node_count;
    auto* h = new Handle();
    h->bounds.assign(b.bounds.begin(), b.bounds.begin() + 6 * n);
    h->prim_count.assign(b.prim_count.begin(), b.prim_count.begin() + n);
    h->first_child.assign(b.first_child.begin(), b.first_child.begin() + n);
    h->order = std::move(b.order);
    *out_bounds = h->bounds.data();
    *out_prim_count = h->prim_count.data();
    *out_first_child = h->first_child.data();
    *out_prim_indices = h->order.data();
    *out_node_count = n;
    *out_handle = h;
    return 0;
}

void ceres_bvh_free(void* handle) {
    delete static_cast<Handle*>(handle);
}

}  // extern "C"
