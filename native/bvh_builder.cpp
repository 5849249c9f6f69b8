// Native binned-SAH BVH builder.
//
// Native analogue of the reference's host-side acceleration-structure
// build (src/kdtree.h:141-292 BuildTree/FlattenTree — there a duplicating
// kd-tree, here the binned-SAH BVH its bvh.h:14 stub asked for). Large scenes
// (the 100K-triangle Stanford dragon) builds in milliseconds here vs seconds
// in the numpy reference builder; the output contract is identical and tested
// for agreement (tests/test_native.py).
//
// Exported C ABI (ctypes):
//   int tracy_build_bvh(const float* tri_min, const float* tri_max, int t,
//                       int leaf_size, int max_depth,
//                       float* node_bounds /* [2t][6] */,
//                       int*   node_meta   /* [2t][3] */,
//                       int*   tri_order   /* [t] */,
//                       int*   out_max_depth);
//   returns node count (<= 2t-1), or -1 on error.
//
// node_meta rows: leaf -> (first_slot, count, -1); inner -> (left, 0, right).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kNumBins = 64;  // keep equal to bvh_build.NUM_BINS
constexpr float kTraversalCost = 1.0f;
constexpr float kIntersectCost = 2.0f;

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void extend(const Vec3& a, const Vec3& b) {
    lo = vmin(lo, a);
    hi = vmax(hi, b);
  }
  void extend(const AABB& o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  // SAH areas in double so split decisions match the numpy reference
  // builder bit-for-bit (it promotes float32 bounds to float64).
  double area() const {
    double dx = std::max(static_cast<double>(hi.x) - lo.x, 0.0);
    double dy = std::max(static_cast<double>(hi.y) - lo.y, 0.0);
    double dz = std::max(static_cast<double>(hi.z) - lo.z, 0.0);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Task {
  int node;
  int start;
  int end;
  int depth;
};

}  // namespace

extern "C" int tracy_build_bvh(const float* tri_min_f, const float* tri_max_f,
                               int t_count, int leaf_size, int max_depth,
                               int cost_mode,  // 0 = per-triangle SAH,
                               // 1 = per-chunk (ceil(count/leaf_size)),
                               // for traversals that test a whole
                               // fixed-width leaf at one cost
                               float* node_bounds, int* node_meta,
                               int* tri_order, int* out_max_depth) {
  if (t_count <= 0 || leaf_size < 1) return -1;
  // Must match the numpy builder's float64 arithmetic bit-for-bit
  // (np.ceil of an exact integer ratio == integer ceil).
  const auto icost = [&](int n) {
    return cost_mode ? static_cast<double>((n + leaf_size - 1) / leaf_size)
                     : static_cast<double>(n);
  };

  const Vec3* tri_min = reinterpret_cast<const Vec3*>(tri_min_f);
  const Vec3* tri_max = reinterpret_cast<const Vec3*>(tri_max_f);

  std::vector<Vec3> centroid(t_count);
  for (int i = 0; i < t_count; ++i) {
    centroid[i] = {0.5f * (tri_min[i].x + tri_max[i].x),
                   0.5f * (tri_min[i].y + tri_max[i].y),
                   0.5f * (tri_min[i].z + tri_max[i].z)};
  }
  for (int i = 0; i < t_count; ++i) tri_order[i] = i;

  int node_count = 1;
  int deepest = 0;
  std::vector<Task> stack;
  stack.push_back({0, 0, t_count, 0});

  std::vector<int> tmp(t_count);

  while (!stack.empty()) {
    Task task = stack.back();
    stack.pop_back();
    deepest = std::max(deepest, task.depth);
    const int count = task.end - task.start;

    AABB bounds;
    for (int i = task.start; i < task.end; ++i) {
      const int id = tri_order[i];
      bounds.extend(tri_min[id], tri_max[id]);
    }
    float* nb = node_bounds + 6 * task.node;
    nb[0] = bounds.lo.x; nb[1] = bounds.lo.y; nb[2] = bounds.lo.z;
    nb[3] = bounds.hi.x; nb[4] = bounds.hi.y; nb[5] = bounds.hi.z;
    int* nm = node_meta + 3 * task.node;

    if (count <= leaf_size || task.depth >= max_depth) {
      nm[0] = task.start; nm[1] = count; nm[2] = -1;
      continue;
    }

    // Centroid bounds.
    AABB cb;
    for (int i = task.start; i < task.end; ++i) {
      const Vec3& c = centroid[tri_order[i]];
      cb.extend(c, c);
    }
    const float cext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    const float clo[3] = {cb.lo.x, cb.lo.y, cb.lo.z};
    const double parent_area = std::max(bounds.area(), 1e-30);

    int best_axis = -1, best_bin = -1;
    double best_cost = static_cast<double>(kIntersectCost) * icost(count);

    for (int axis = 0; axis < 3; ++axis) {
      if (cext[axis] <= 1e-12f) continue;
      // Bin ids in double to match the numpy builder's float64 promotion.
      const double scale = kNumBins * (1.0 - 1e-6) / cext[axis];

      int bcount[kNumBins] = {};
      AABB bbox[kNumBins];
      for (int i = task.start; i < task.end; ++i) {
        const int id = tri_order[i];
        const float c = axis == 0 ? centroid[id].x : axis == 1 ? centroid[id].y : centroid[id].z;
        int b = static_cast<int>(static_cast<double>(c - clo[axis]) * scale);
        b = std::min(std::max(b, 0), kNumBins - 1);
        ++bcount[b];
        bbox[b].extend(tri_min[id], tri_max[id]);
      }

      // Suffix sweep.
      AABB racc;
      double rarea[kNumBins] = {};
      int rcount[kNumBins] = {};
      int rc = 0;
      for (int b = kNumBins - 1; b >= 1; --b) {
        racc.extend(bbox[b]);
        rc += bcount[b];
        rarea[b] = racc.area();
        rcount[b] = rc;
      }
      // Prefix sweep + cost.
      AABB lacc;
      int lc = 0;
      for (int b = 0; b < kNumBins - 1; ++b) {
        lacc.extend(bbox[b]);
        lc += bcount[b];
        if (lc == 0 || rcount[b + 1] == 0) continue;
        const double cost = kTraversalCost +
                            kIntersectCost *
                                (lacc.area() * icost(lc) +
                                 rarea[b + 1] * icost(rcount[b + 1])) /
                                parent_area;
#ifdef TRACY_BVH_DEBUG
        std::fprintf(stderr, "n=%d axis=%d bin=%d lc=%d cost=%.17g\n",
                     count, axis, b, lc, cost);
#endif
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = b;
        }
      }
    }

    int mid;
    if (best_axis < 0) {
      // Degenerate or leaf-favored but over max leaf size: median split on
      // the largest centroid-extent axis to guarantee progress.
      // NOTE: numpy builder picks the largest *node bounds* extent here,
      // and uses a stable sort; match both for bit-identical trees.
      const float next[3] = {bounds.hi.x - bounds.lo.x,
                             bounds.hi.y - bounds.lo.y,
                             bounds.hi.z - bounds.lo.z};
      int axis = 0;
      if (next[1] > next[axis]) axis = 1;
      if (next[2] > next[axis]) axis = 2;
      std::stable_sort(tri_order + task.start, tri_order + task.end,
                       [&](int a, int b) {
                         const float ca = axis == 0 ? centroid[a].x : axis == 1 ? centroid[a].y : centroid[a].z;
                         const float cbv = axis == 0 ? centroid[b].x : axis == 1 ? centroid[b].y : centroid[b].z;
                         return ca < cbv;
                       });
      mid = task.start + count / 2;
    } else {
      const double scale = kNumBins * (1.0 - 1e-6) / cext[best_axis];
      // Stable partition (matches numpy concatenate([left, right]) order).
      int nl = 0, nr = 0;
      for (int i = task.start; i < task.end; ++i) {
        const int id = tri_order[i];
        const float c = best_axis == 0 ? centroid[id].x
                      : best_axis == 1 ? centroid[id].y
                                       : centroid[id].z;
        int b = static_cast<int>(static_cast<double>(c - clo[best_axis]) * scale);
        b = std::min(std::max(b, 0), kNumBins - 1);
        if (b <= best_bin) {
          tri_order[task.start + nl++] = id;
        } else {
          tmp[nr++] = id;
        }
      }
      std::memcpy(tri_order + task.start + nl, tmp.data(), nr * sizeof(int));
      mid = task.start + nl;
      if (nl == 0 || nr == 0) {
        // One-sided partition preserved the original order (stable), so a
        // stable centroid sort here matches the numpy builder's fallback.
        const int axis = best_axis;
        std::stable_sort(tri_order + task.start, tri_order + task.end,
                         [&](int a, int b) {
                           const float ca = axis == 0 ? centroid[a].x : axis == 1 ? centroid[a].y : centroid[a].z;
                           const float cbv = axis == 0 ? centroid[b].x : axis == 1 ? centroid[b].y : centroid[b].z;
                           return ca < cbv;
                         });
        mid = task.start + count / 2;
      }
    }

    const int left = node_count++;
    const int right = node_count++;
    nm[0] = left; nm[1] = 0; nm[2] = right;
    stack.push_back({right, mid, task.end, task.depth + 1});
    stack.push_back({left, task.start, mid, task.depth + 1});
  }

  *out_max_depth = deepest;
  return node_count;
}
