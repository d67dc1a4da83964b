// Nearest-neighbour knot assignment on the host, for point-cloud meshes,
// and the closed-form binning of a regular lattice.
//
// The port's own copy of the kd-tree and brute-force scans of the repo's
// native/mvtv_native.cpp, built by multivartv_tpu_torch/native/loader.py
// with g++ (no -march=native, so the library runs on any x86-64 host):
//
//   * mvtv_nearest_kdtree: the nearest mesh row of every query point, a
//     kd-tree over the mesh (O(n log ntheta) typical), OpenMP-parallel over
//     the queries where built with OpenMP (the loader builds it without);
//     it replaces the reference's O(n * ntheta * p) scan
//     (nearest1, utils.cpp:280-287).  Ties go to the lowest row index, as
//     the reference's index_min does (utils.cpp:275);
//   * mvtv_nearest_brute: that exact scan, for validation;
//   * mvtv_bin_regular: the closed-form nearest knot of a regular lattice
//     (a C-order flat index), the JAX package's native binning; on no path
//     of the port, which bins on the device (mesh.py).
//
// ABI: plain C, loaded with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <numeric>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct KDNode {
    int32_t split_dim;
    double split_val;
    int32_t left;    // node index or -1
    int32_t right;   // node index or -1
    int32_t begin;   // leaf range into point index array
    int32_t end;
};

struct KDTree {
    const double* pts;  // (n, p) row-major
    int p;
    std::vector<KDNode> nodes;
    std::vector<int32_t> order;  // point indices, leaf-partitioned

    static constexpr int LEAF = 16;

    int32_t build(int32_t begin, int32_t end, int depth) {
        KDNode node;
        node.begin = begin;
        node.end = end;
        node.left = node.right = -1;
        node.split_dim = -1;
        node.split_val = 0.0;
        if (end - begin > LEAF) {
            // pick the widest dimension of this subset
            int best_dim = 0;
            double best_spread = -1.0;
            for (int d = 0; d < p; ++d) {
                double lo = std::numeric_limits<double>::infinity();
                double hi = -lo;
                for (int32_t i = begin; i < end; ++i) {
                    double v = pts[(size_t)order[i] * p + d];
                    lo = std::min(lo, v);
                    hi = std::max(hi, v);
                }
                if (hi - lo > best_spread) {
                    best_spread = hi - lo;
                    best_dim = d;
                }
            }
            int32_t mid = (begin + end) / 2;
            std::nth_element(
                order.begin() + begin, order.begin() + mid,
                order.begin() + end,
                [&](int32_t a, int32_t b) {
                    double va = pts[(size_t)a * p + best_dim];
                    double vb = pts[(size_t)b * p + best_dim];
                    if (va != vb) return va < vb;
                    return a < b;  // deterministic
                });
            node.split_dim = best_dim;
            node.split_val = pts[(size_t)order[mid] * p + best_dim];
            int32_t self = (int32_t)nodes.size();
            nodes.push_back(node);
            int32_t l = build(begin, mid, depth + 1);
            int32_t r = build(mid, end, depth + 1);
            nodes[self].left = l;
            nodes[self].right = r;
            return self;
        }
        int32_t self = (int32_t)nodes.size();
        nodes.push_back(node);
        return self;
    }

    void init(const double* points, int32_t n, int dims) {
        pts = points;
        p = dims;
        order.resize(n);
        std::iota(order.begin(), order.end(), 0);
        nodes.reserve((size_t)(2.2 * n / LEAF) + 8);
        build(0, n, 0);
    }

    inline double dist_sq(const double* q, int32_t idx) const {
        const double* row = pts + (size_t)idx * p;
        double acc = 0.0;
        for (int d = 0; d < p; ++d) {
            double t = q[d] - row[d];
            acc += t * t;
        }
        return acc;
    }

    // Nearest with lowest-index tie-break (strict < on distance, then <
    // on index).
    void query(const double* q, int32_t node_id, double& best_d,
               int32_t& best_i) const {
        const KDNode& node = nodes[node_id];
        if (node.split_dim < 0) {
            for (int32_t i = node.begin; i < node.end; ++i) {
                int32_t idx = order[i];
                double d = dist_sq(q, idx);
                if (d < best_d || (d == best_d && idx < best_i)) {
                    best_d = d;
                    best_i = idx;
                }
            }
            return;
        }
        double diff = q[node.split_dim] - node.split_val;
        int32_t near_child = diff < 0 ? node.left : node.right;
        int32_t far_child = diff < 0 ? node.right : node.left;
        query(q, near_child, best_d, best_i);
        // <= (not <): equal-distance points on the far side may hold a
        // lower index, which the reference tie-break prefers.
        if (diff * diff <= best_d) {
            query(q, far_child, best_d, best_i);
        }
    }
};

}  // namespace

extern "C" {

// data: (n, p) row-major float64; mesh: (ntheta, p); out: (n,) int32 of
// mesh row indices.  Returns 0 on success.
int mvtv_nearest_kdtree(const double* data, int64_t n, const double* mesh,
                        int64_t ntheta, int32_t p, int32_t* out) {
    if (n < 0 || ntheta <= 0 || p <= 0) return 1;
    KDTree tree;
    tree.init(mesh, (int32_t)ntheta, p);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        double best_d = std::numeric_limits<double>::infinity();
        int32_t best_i = 0;
        tree.query(data + (size_t)i * p, 0, best_d, best_i);
        out[i] = best_i;
    }
    return 0;
}

// The reference's exact brute-force scan (nearest1, utils.cpp:280-287).
int mvtv_nearest_brute(const double* data, int64_t n, const double* mesh,
                       int64_t ntheta, int32_t p, int32_t* out) {
    if (n < 0 || ntheta <= 0 || p <= 0) return 1;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        const double* q = data + (size_t)i * p;
        double best_d = std::numeric_limits<double>::infinity();
        int32_t best_i = 0;
        for (int64_t k = 0; k < ntheta; ++k) {
            const double* row = mesh + (size_t)k * p;
            double acc = 0.0;
            for (int32_t d = 0; d < p; ++d) {
                double t = q[d] - row[d];
                acc += t * t;
            }
            if (acc < best_d) {
                best_d = acc;
                best_i = (int32_t)k;
            }
        }
        out[i] = best_i;
    }
    return 0;
}

// Closed-form regular-lattice binning, C-order flat index.
// knot0[j], inv_h[j]: first knot and 1/spacing per axis; dims[j]: m_j.
// A tie at a midpoint goes to the lower index (frac > 0.5 strictly to
// round up); indices are clipped to the lattice.
int mvtv_bin_regular(const double* data, int64_t n, int32_t p, const double* knot0,
                     const double* inv_h, const int64_t* dims, int64_t* out) {
    if (n < 0 || p <= 0) return 1;
    std::vector<int64_t> strides(p);
    strides[p - 1] = 1;
    for (int32_t j = p - 2; j >= 0; --j)
        strides[j] = strides[j + 1] * dims[j + 1];
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        const double* q = data + (size_t)i * p;
        int64_t flat = 0;
        for (int32_t j = 0; j < p; ++j) {
            int64_t idx = 0;
            if (dims[j] > 1) {
                double t = (q[j] - knot0[j]) * inv_h[j];
                double fl = std::floor(t);
                idx = (int64_t)fl + ((t - fl) > 0.5 ? 1 : 0);
                idx = std::max((int64_t)0, std::min(dims[j] - 1, idx));
            }
            flat += idx * strides[j];
        }
        out[i] = flat;
    }
    return 0;
}

}  // extern "C"
