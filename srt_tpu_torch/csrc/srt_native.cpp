// srt_native: the port's host runtime, the C++ BVH builder that
// utils/bvh.build_bvh takes at 1,024 or more primitives (chip_smoke.py's
// phases 3 and 6 time it against the numpy builder).
//
// Counterpart of the BVH builder of the JAX package's native/srt_native.cpp,
// the same algorithm and the same trees.  Its OBJ/MTL parser is not carried
// over: no path of the port loads OBJ files at scale (ROADMAP.md, queue A).
//
// Host code with a C interface, loaded with ctypes (utils/native.py builds
// it with the host C++ compiler at first use); it is not part of the nvcc
// kernel library of ops/cuda_lib.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// ----------------------------- BVH building -------------------------------

// Midpoint-split binary BVH identical to utils/bvh.build_bvh's numpy
// builder: longest axis with y/z winning ties, a stable partition, a
// degenerate split becomes a leaf, children adjacent.  Caller allocates
// 2n-1 capacity; returns the node count.
int64_t srt_bvh_build(const float* centers, const float* bmin,
                      const float* bmax, int64_t n, int64_t leaf_size,
                      float* node_min, float* node_max, uint32_t* node_first,
                      uint32_t* node_count, uint32_t* order) {
  if (n <= 0) return 0;
  for (int64_t i = 0; i < n; ++i) order[i] = static_cast<uint32_t>(i);

  int64_t next_free = 1;
  node_first[0] = 0;
  node_count[0] = static_cast<uint32_t>(n);

  std::vector<int64_t> stack = {0};
  std::vector<uint32_t> scratch(static_cast<size_t>(n));
  while (!stack.empty()) {
    const int64_t ni = stack.back();
    stack.pop_back();
    const int64_t first = node_first[ni];
    const int64_t count = node_count[ni];

    float mn[3] = {HUGE_VALF, HUGE_VALF, HUGE_VALF};
    float mx[3] = {-HUGE_VALF, -HUGE_VALF, -HUGE_VALF};
    for (int64_t k = first; k < first + count; ++k) {
      const uint32_t p = order[k];
      for (int a = 0; a < 3; ++a) {
        mn[a] = std::min(mn[a], bmin[p * 3 + a]);
        mx[a] = std::max(mx[a], bmax[p * 3 + a]);
      }
    }
    std::memcpy(node_min + ni * 3, mn, 12);
    std::memcpy(node_max + ni * 3, mx, 12);

    if (count <= leaf_size) continue;

    // Longest axis; y/z win ties.
    const float ext[3] = {mx[0] - mn[0], mx[1] - mn[1], mx[2] - mn[2]};
    int axis = 0;
    if (ext[1] > ext[0]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    const float split = mn[axis] + ext[axis] * 0.5f;

    // Stable partition (numpy's boolean-mask concatenate).
    int64_t left = 0;
    for (int64_t k = first; k < first + count; ++k)
      if (centers[order[k] * 3 + axis] < split) scratch[left++] = order[k];
    int64_t right = left;
    for (int64_t k = first; k < first + count; ++k)
      if (!(centers[order[k] * 3 + axis] < split)) scratch[right++] = order[k];
    if (left == 0 || left == count) continue;  // degenerate -> leaf
    std::memcpy(order + first, scratch.data(),
                static_cast<size_t>(count) * 4);

    const int64_t li = next_free, ri = next_free + 1;
    next_free += 2;
    node_first[li] = static_cast<uint32_t>(first);
    node_count[li] = static_cast<uint32_t>(left);
    node_first[ri] = static_cast<uint32_t>(first + left);
    node_count[ri] = static_cast<uint32_t>(count - left);
    node_first[ni] = static_cast<uint32_t>(li);
    node_count[ni] = 0;
    stack.push_back(ri);
    stack.push_back(li);
  }
  return next_free;
}

}  // extern "C"
