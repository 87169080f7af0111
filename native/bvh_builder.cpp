// Binned-SAH BVH builder (host side).
//
// Replaces the device-side OptiX BLAS build the reference delegates to
// (reference `src/base/mgr/geometry.cpp:36-53`): the hierarchy is built
// once on the host in C++ and shipped to the device as flat arrays that the
// GPU traversal kernel walks (native/trace.cu, vision_tpu/accel/sah.py).
//
// Output layout (DFS preorder):
//   nodes: lo[3] hi[3] (f32), first (i32: child id if inner, tri start if
//   leaf), count (i32: 0 inner, else #tris), skip (i32 DFS miss link, -1 end),
//   axis (i32: split axis 0/1/2 for inner nodes, -1 for leaves)
//   order: i32 triangle permutation (leaf ranges are contiguous in `order`)
//
// Standard binned SAH: 16 bins on the centroid extent's longest axis,
// leaf <= max_leaf prims, full-sweep SAH cost with surface-area heuristic.
//
// Two invariants the traversal relies on:
//   * the LEFT child always covers the LOWER side of the split axis, so a
//     ray whose direction is positive along `axis` traverses front-to-back
//     by visiting left first (and right first otherwise);
//   * tree depth is bounded (< kMaxDepth + log2(n)): past kMaxDepth the
//     builder forces median splits, so the kernel's fixed stack cannot
//     overflow.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct AABB {
  float lo[3] = {3e38f, 3e38f, 3e38f};
  float hi[3] = {-3e38f, -3e38f, -3e38f};
  void grow(const float* p) {
    for (int i = 0; i < 3; ++i) {
      lo[i] = std::min(lo[i], p[i]);
      hi[i] = std::max(hi[i], p[i]);
    }
  }
  void grow(const AABB& b) {
    for (int i = 0; i < 3; ++i) {
      lo[i] = std::min(lo[i], b.lo[i]);
      hi[i] = std::max(hi[i], b.hi[i]);
    }
  }
  float area() const {
    float dx = std::max(hi[0] - lo[0], 0.f);
    float dy = std::max(hi[1] - lo[1], 0.f);
    float dz = std::max(hi[2] - lo[2], 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

struct Node {
  AABB box;
  int32_t first = 0;  // child id (inner) or tri start (leaf)
  int32_t count = 0;  // 0 = inner
  int32_t skip = -1;
};

constexpr int kBins = 16;
constexpr int kMaxDepth = 48;  // force median splits past this depth

struct Builder {
  const AABB* prim_box;
  const float* cent;  // [n, 3]
  std::vector<int32_t> idx;
  std::vector<Node> nodes;
  std::vector<int32_t> sub_end;  // [node] preorder index just past subtree
  std::vector<int32_t> axes;     // [node] split axis (inner) or -1 (leaf)
  int max_leaf;

  // Spatially-ordered median split along `axis`: left half = lower
  // centroids. Used for degenerate/fallback splits so the left-is-lower
  // invariant holds on every inner node.
  int32_t median(int32_t begin, int32_t end, int axis) {
    int32_t mid = begin + (end - begin) / 2;
    std::nth_element(idx.begin() + begin, idx.begin() + mid,
                     idx.begin() + end, [&](int32_t a, int32_t b) {
                       return cent[3 * a + axis] < cent[3 * b + axis];
                     });
    return mid;
  }

  // Choose the split point for [begin, end). Returns mid; writes the split
  // axis to *out_axis.
  int32_t split(int32_t begin, int32_t end, const AABB& box,
                const AABB& cbox, int depth, int* out_axis) {
    int32_t n = end - begin;
    int axis = 0;
    float ext[3];
    for (int i = 0; i < 3; ++i) ext[i] = cbox.hi[i] - cbox.lo[i];
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    *out_axis = axis;
    if (ext[axis] <= 1e-12f || depth >= kMaxDepth)
      return median(begin, end, axis);
    float scale = kBins / ext[axis];
    float base = cbox.lo[axis];
    AABB bbox[kBins];
    int32_t bcnt[kBins] = {0};
    for (int32_t i = begin; i < end; ++i) {
      int b = std::min(kBins - 1,
                       (int)((cent[3 * idx[i] + axis] - base) * scale));
      bcnt[b]++;
      bbox[b].grow(prim_box[idx[i]]);
    }
    // sweep SAH
    float rarea[kBins];
    AABB acc;
    int32_t rcount = 0;
    for (int b = kBins - 1; b > 0; --b) {
      acc.grow(bbox[b]);
      rcount += bcnt[b];
      rarea[b] = (rcount > 0) ? acc.area() * rcount : 0.f;
    }
    acc = AABB();
    int32_t lcount = 0;
    float best_cost = 3e38f;
    int best_b = -1;
    for (int b = 0; b < kBins - 1; ++b) {
      acc.grow(bbox[b]);
      lcount += bcnt[b];
      if (lcount == 0 || lcount == n) continue;
      float cost = acc.area() * lcount + rarea[b + 1];
      if (cost < best_cost) {
        best_cost = cost;
        best_b = b;
      }
    }
    if (best_b < 0 || best_cost >= box.area() * n) {
      // SAH prefers a leaf, but leaves hold at most max_leaf prims: fall
      // back to a (spatially ordered) median split.
      return median(begin, end, axis);
    }
    auto it = std::partition(
        idx.begin() + begin, idx.begin() + end, [&](int32_t p) {
          int b = std::min(kBins - 1,
                           (int)((cent[3 * p + axis] - base) * scale));
          return b <= best_b;
        });
    int32_t mid = (int32_t)(it - idx.begin());
    if (mid == begin || mid == end) mid = median(begin, end, axis);
    return mid;
  }

  // Preorder build with an explicit frame stack (recursion would be O(n)
  // deep for adversarial splits and overflow the host stack).
  void build() {
    struct Frame {
      int32_t begin, end, me, mid;
      int stage;  // 0 = create node, 1 = left done, 2 = right done
      int depth;
    };
    std::vector<Frame> st;
    st.push_back({0, (int32_t)idx.size(), -1, 0, 0, 0});
    while (!st.empty()) {
      Frame& f = st.back();
      if (f.stage == 0) {
        f.me = (int32_t)nodes.size();
        nodes.emplace_back();
        sub_end.push_back(-1);
        axes.push_back(-1);
        AABB box, cbox;
        for (int32_t i = f.begin; i < f.end; ++i) {
          box.grow(prim_box[idx[i]]);
          cbox.grow(&cent[3 * idx[i]]);
        }
        nodes[f.me].box = box;
        int32_t n = f.end - f.begin;
        if (n <= max_leaf) {
          nodes[f.me].first = f.begin;
          nodes[f.me].count = n;
          sub_end[f.me] = f.me + 1;
          st.pop_back();
          continue;
        }
        // preorder: left child is emitted immediately after this node
        nodes[f.me].first = f.me + 1;
        int ax = 0;
        f.mid = split(f.begin, f.end, box, cbox, f.depth, &ax);
        axes[f.me] = ax;
        f.stage = 1;
        st.push_back({f.begin, f.mid, -1, 0, 0, f.depth + 1});
      } else if (f.stage == 1) {
        f.stage = 2;
        st.push_back({f.mid, f.end, -1, 0, 0, f.depth + 1});
      } else {
        sub_end[f.me] = (int32_t)nodes.size();
        st.pop_back();
      }
    }
  }

  // DFS skip links: node i's skip = next subtree in preorder after i's.
  // Iterative (same stack-depth rationale as build()).
  void link() {
    std::vector<std::pair<int32_t, int32_t>> st;  // (node, skip)
    st.emplace_back(0, -1);
    while (!st.empty()) {
      auto [node, skip] = st.back();
      st.pop_back();
      nodes[node].skip = skip;
      if (nodes[node].count == 0) {
        int32_t l = nodes[node].first;
        int32_t r = sub_end[l];  // right child follows left's subtree
        st.emplace_back(r, skip);
        st.emplace_back(l, r);
      }
    }
  }
};

}  // namespace

namespace {

int64_t run_build(Builder& b, int64_t n, float* out_lo, float* out_hi,
                  int32_t* out_first, int32_t* out_count, int32_t* out_skip,
                  int32_t* out_order, int32_t* out_axis) {
  b.idx.resize(n);
  for (int64_t i = 0; i < n; ++i) b.idx[i] = (int32_t)i;
  b.nodes.reserve(2 * n);
  b.build();
  b.link();
  int64_t nn = (int64_t)b.nodes.size();
  for (int64_t i = 0; i < nn; ++i) {
    std::memcpy(&out_lo[3 * i], b.nodes[i].box.lo, 12);
    std::memcpy(&out_hi[3 * i], b.nodes[i].box.hi, 12);
    out_first[i] = b.nodes[i].first;
    out_count[i] = b.nodes[i].count;
    out_skip[i] = b.nodes[i].skip;
    out_axis[i] = b.axes[i];
  }
  std::memcpy(out_order, b.idx.data(), n * 4);
  return nn;
}

}  // namespace

extern "C" {

// Build. tris are given as p0/p1/p2 [n*3] f32 each. Returns node count.
// Caller passes preallocated output arrays sized for 2n nodes (a binary
// tree over n prims has < 2n nodes; see build_bvh_native's `cap`).
int64_t vt_build_bvh(const float* p0, const float* p1, const float* p2,
                     int64_t n, int32_t max_leaf, float* out_lo,
                     float* out_hi, int32_t* out_first, int32_t* out_count,
                     int32_t* out_skip, int32_t* out_order,
                     int32_t* out_axis) {
  if (n <= 0) return 0;
  std::vector<AABB> boxes(n);
  std::vector<float> cent(3 * n);
  for (int64_t i = 0; i < n; ++i) {
    boxes[i].grow(&p0[3 * i]);
    boxes[i].grow(&p1[3 * i]);
    boxes[i].grow(&p2[3 * i]);
    for (int c = 0; c < 3; ++c)
      cent[3 * i + c] = (boxes[i].lo[c] + boxes[i].hi[c]) * 0.5f;
  }
  Builder b;
  b.prim_box = boxes.data();
  b.cent = cent.data();
  b.max_leaf = std::max(1, (int)max_leaf);
  return run_build(b, n, out_lo, out_hi, out_first, out_count, out_skip,
                   out_order, out_axis);
}

}  // extern "C"
