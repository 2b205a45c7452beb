// Binned-SAH mesh BVH build on the host (the port's own copy).
//
// The same builder as the JAX package's native asset pipeline: a binary
// BVH over a triangle mesh, binned SAH over the widest centroid axis,
// leaves of at most leaf_size triangles (the reference's
// MeshBVHBuilder::build, src/common/mesh_bvh_builder.cpp). Host code,
// not a kernel: assets/bvh.py builds it with g++ at first use and binds
// bvh_build / bvh_free through ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// Binned SAH binary BVH (MeshBVHBuilder equivalent). Output layout:
// per node: bounds_min[3], bounds_max[3], left, right (negative right =
// leaf: left = first tri index into tri_order, -right = count).

struct BVHOut {
    float *node_min;     // [num_nodes * 3]
    float *node_max;     // [num_nodes * 3]
    int32_t *node_left;  // [num_nodes]
    int32_t *node_right; // [num_nodes]  (right < 0 -> leaf of -right tris)
    int32_t *tri_order;  // [num_tris]
    int64_t num_nodes;
};

struct BuildTri {
    float bmin[3], bmax[3], centroid[3];
    int32_t idx;
};

static void node_bounds(const std::vector<BuildTri> &tris,
                        const std::vector<int32_t> &order, int64_t lo,
                        int64_t hi, float *bmin, float *bmax) {
    for (int c = 0; c < 3; c++) { bmin[c] = 3e38f; bmax[c] = -3e38f; }
    for (int64_t i = lo; i < hi; i++) {
        const BuildTri &t = tris[order[i]];
        for (int c = 0; c < 3; c++) {
            bmin[c] = std::min(bmin[c], t.bmin[c]);
            bmax[c] = std::max(bmax[c], t.bmax[c]);
        }
    }
}

static int64_t build_node(const std::vector<BuildTri> &tris,
                          std::vector<int32_t> &order, int64_t lo,
                          int64_t hi, BVHOut *out, int64_t leaf_size,
                          std::vector<int64_t> &nodes_left,
                          std::vector<int64_t> &nodes_right,
                          std::vector<float> &nmin,
                          std::vector<float> &nmax) {
    int64_t node = (int64_t)nodes_left.size();
    nodes_left.push_back(0);
    nodes_right.push_back(0);
    float bmin[3], bmax[3];
    node_bounds(tris, order, lo, hi, bmin, bmax);
    for (int c = 0; c < 3; c++) { nmin.push_back(bmin[c]); nmax.push_back(bmax[c]); }

    int64_t n = hi - lo;
    if (n <= leaf_size) {
        nodes_left[node] = lo;
        nodes_right[node] = -(int64_t)n;
        return node;
    }

    // binned SAH over the widest centroid axis
    float cmin[3] = {3e38f, 3e38f, 3e38f};
    float cmax[3] = {-3e38f, -3e38f, -3e38f};
    for (int64_t i = lo; i < hi; i++) {
        const BuildTri &t = tris[order[i]];
        for (int c = 0; c < 3; c++) {
            cmin[c] = std::min(cmin[c], t.centroid[c]);
            cmax[c] = std::max(cmax[c], t.centroid[c]);
        }
    }
    int axis = 0;
    float ext = -1;
    for (int c = 0; c < 3; c++) {
        float e = cmax[c] - cmin[c];
        if (e > ext) { ext = e; axis = c; }
    }
    int64_t mid;
    if (ext <= 1e-12f) {
        mid = lo + n / 2;   // degenerate: median split
    } else {
        constexpr int NBINS = 16;
        int64_t counts[NBINS] = {};
        float bbmin[NBINS][3], bbmax[NBINS][3];
        for (int b = 0; b < NBINS; b++)
            for (int c = 0; c < 3; c++) { bbmin[b][c] = 3e38f; bbmax[b][c] = -3e38f; }
        auto bin_of = [&](const BuildTri &t) {
            int b = (int)((t.centroid[axis] - cmin[axis]) / ext * NBINS);
            return std::min(b, NBINS - 1);
        };
        for (int64_t i = lo; i < hi; i++) {
            const BuildTri &t = tris[order[i]];
            int b = bin_of(t);
            counts[b]++;
            for (int c = 0; c < 3; c++) {
                bbmin[b][c] = std::min(bbmin[b][c], t.bmin[c]);
                bbmax[b][c] = std::max(bbmax[b][c], t.bmax[c]);
            }
        }
        auto area = [](const float *mn, const float *mx) {
            float d[3] = {std::max(mx[0] - mn[0], 0.f),
                          std::max(mx[1] - mn[1], 0.f),
                          std::max(mx[2] - mn[2], 0.f)};
            return 2.f * (d[0] * d[1] + d[1] * d[2] + d[0] * d[2]);
        };
        float best_cost = 3e38f;
        int best_split = -1;
        for (int s = 1; s < NBINS; s++) {
            float lmin[3] = {3e38f, 3e38f, 3e38f},
                  lmax[3] = {-3e38f, -3e38f, -3e38f};
            float rmin[3] = {3e38f, 3e38f, 3e38f},
                  rmax[3] = {-3e38f, -3e38f, -3e38f};
            int64_t ln = 0, rn = 0;
            for (int b = 0; b < s; b++) {
                if (!counts[b]) continue;
                ln += counts[b];
                for (int c = 0; c < 3; c++) {
                    lmin[c] = std::min(lmin[c], bbmin[b][c]);
                    lmax[c] = std::max(lmax[c], bbmax[b][c]);
                }
            }
            for (int b = s; b < NBINS; b++) {
                if (!counts[b]) continue;
                rn += counts[b];
                for (int c = 0; c < 3; c++) {
                    rmin[c] = std::min(rmin[c], bbmin[b][c]);
                    rmax[c] = std::max(rmax[c], bbmax[b][c]);
                }
            }
            if (!ln || !rn) continue;
            float cost = area(lmin, lmax) * ln + area(rmin, rmax) * rn;
            if (cost < best_cost) { best_cost = cost; best_split = s; }
        }
        if (best_split < 0) {
            mid = lo + n / 2;
        } else {
            auto it = std::partition(
                order.begin() + lo, order.begin() + hi,
                [&](int32_t ti) { return bin_of(tris[ti]) < best_split; });
            mid = it - order.begin();
            if (mid == lo || mid == hi) mid = lo + n / 2;
        }
    }
    if (mid == lo || mid == hi) {
        std::nth_element(
            order.begin() + lo, order.begin() + lo + n / 2,
            order.begin() + hi, [&](int32_t a, int32_t b) {
                return tris[a].centroid[axis] < tris[b].centroid[axis];
            });
        mid = lo + n / 2;
    }
    int64_t l = build_node(tris, order, lo, mid, out, leaf_size,
                           nodes_left, nodes_right, nmin, nmax);
    int64_t r = build_node(tris, order, mid, hi, out, leaf_size,
                           nodes_left, nodes_right, nmin, nmax);
    nodes_left[node] = l;
    nodes_right[node] = r;
    return node;
}

BVHOut *bvh_build(const float *positions, int64_t num_verts,
                  const int32_t *indices, int64_t num_tris,
                  int64_t leaf_size) {
    (void)num_verts;
    auto *out = static_cast<BVHOut *>(calloc(1, sizeof(BVHOut)));
    if (num_tris <= 0) return out;
    if (leaf_size <= 0) leaf_size = 4;

    std::vector<BuildTri> tris(num_tris);
    for (int64_t i = 0; i < num_tris; i++) {
        BuildTri &t = tris[i];
        t.idx = (int32_t)i;
        for (int c = 0; c < 3; c++) { t.bmin[c] = 3e38f; t.bmax[c] = -3e38f; }
        for (int k = 0; k < 3; k++) {
            const float *p = positions + indices[i * 3 + k] * 3;
            for (int c = 0; c < 3; c++) {
                t.bmin[c] = std::min(t.bmin[c], p[c]);
                t.bmax[c] = std::max(t.bmax[c], p[c]);
            }
        }
        for (int c = 0; c < 3; c++)
            t.centroid[c] = 0.5f * (t.bmin[c] + t.bmax[c]);
    }
    std::vector<int32_t> order(num_tris);
    for (int64_t i = 0; i < num_tris; i++) order[i] = (int32_t)i;

    std::vector<int64_t> nl, nr;
    std::vector<float> nmin, nmax;
    build_node(tris, order, 0, num_tris, out, leaf_size, nl, nr, nmin, nmax);

    int64_t nn = (int64_t)nl.size();
    out->num_nodes = nn;
    out->node_min = static_cast<float *>(malloc(nn * 3 * sizeof(float)));
    out->node_max = static_cast<float *>(malloc(nn * 3 * sizeof(float)));
    out->node_left = static_cast<int32_t *>(malloc(nn * sizeof(int32_t)));
    out->node_right = static_cast<int32_t *>(malloc(nn * sizeof(int32_t)));
    out->tri_order = static_cast<int32_t *>(
        malloc(num_tris * sizeof(int32_t)));
    memcpy(out->node_min, nmin.data(), nn * 3 * sizeof(float));
    memcpy(out->node_max, nmax.data(), nn * 3 * sizeof(float));
    for (int64_t i = 0; i < nn; i++) {
        out->node_left[i] = (int32_t)nl[i];
        out->node_right[i] = (int32_t)nr[i];
    }
    memcpy(out->tri_order, order.data(), num_tris * sizeof(int32_t));
    return out;
}

void bvh_free(BVHOut *b) {
    if (!b) return;
    free(b->node_min);
    free(b->node_max);
    free(b->node_left);
    free(b->node_right);
    free(b->tri_order);
    free(b);
}

}  // extern "C"
