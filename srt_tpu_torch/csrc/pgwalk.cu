// B7: the mask-scan walk.  Replaces _pgwalk_kernel
// (srt_tpu/ops/traversal_pallas.py:937, launched by _launch_pgwalk).
//
// Per group of 8 rays: scan the group's S cluster words (cull_gmask.cu)
// and evaluate every cluster whose bit is set against the group's rays.
// Three things differ from B4 (pgwalk2.cu), and each changes bits of the
// output: the Woop affine rows fold left to right (B2's order); the best
// t starts at t_max itself, with no BIG cap, so a miss returns t_max; and
// there is no list.  Any-hit adds t > t_lo and does not end early.  The
// result is the lexicographic min of (t, triangle index) over the valid
// candidates with t < t_max, which does not depend on the order of
// evaluation, so the work may be split any way.
//
// What bounds it: ~52 operations (43 multiplies and adds, a division, and
// eight compares, minima and sign operations) per (ray, triangle) over
// the group's footprint, in a loop
// whose length depends on the data.  Design: one warp per group, not one
// 8-thread block (B4's shape at G = 8 would leave three quarters of each
// warp idle): lane = 4 * ray + quarter, and each quarter evaluates the
// cluster's triangles quarter, quarter + 4, ..., so a warp-wide read of
// one Woop row is 16 contiguous bytes broadcast to the 8 rays (read from
// global memory through L1; no shared memory, no barrier).  The words are
// read 32 at a time, one per lane, and a ballot skips the zero ones.  Each
// lane keeps its own (t, index) minimum, visiting its triangles in
// ascending index with a strict t <; two shuffle steps take the
// lexicographic minimum over the ray's four lanes.
#include "traversal_common.cuh"

namespace {

using namespace srt;

constexpr int GROUP = 8;
constexpr int WARPS = 4;   // groups per block

__global__ void pgwalk_kernel(const int* __restrict__ mask, int S,
                              const float* __restrict__ rays8,
                              const float* __restrict__ woop, int n_groups,
                              int any_hit, float* __restrict__ out_t,
                              int* __restrict__ out_i) {
  const size_t g = (size_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (g >= (size_t)n_groups) return;  // whole warps only
  const int lane = threadIdx.x & 31;
  const int q = lane & 3;
  const size_t ray = g * GROUP + (lane >> 2);
  const Ray r = load_ray(rays8, ray);
  float bt = r.t_max;
  int bi = MISS_IDX;
  const int* row = mask + g * S;

  for (int s0 = 0; s0 < S; s0 += 32) {
    const unsigned w = (s0 + lane < S) ? (unsigned)row[s0 + lane] : 0u;
    unsigned nz = __ballot_sync(FULL, w != 0u);
    while (nz) {
      const int j = __ffs(nz) - 1;
      nz &= nz - 1;
      unsigned word = __shfl_sync(FULL, w, j);
      const int s = s0 + j;
      while (word) {
        const int c = s * SUPER + __ffs(word) - 1;
        word &= word - 1;
        const float* wc = woop + (size_t)c * WOOP_STRIDE;
        const int base = c * CLUSTER;
        for (int l = q; l < CLUSTER; l += 4) {
          float t;
          bool valid = woop_eval<false>(wc, l, r, &t);
          if (any_hit) valid = valid && (t > r.t_lo);
          if (valid && t < bt) {
            bt = t;
            bi = base + l;
          }
        }
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float ot = __shfl_xor_sync(FULL, bt, off);
    const int oi = __shfl_xor_sync(FULL, bi, off);
    if (ot < bt || (ot == bt && oi < bi)) {
      bt = ot;
      bi = oi;
    }
  }
  if (q == 0) {
    out_t[ray] = bt;
    out_i[ray] = (bt < r.t_max) ? bi : -1;
  }
}

}  // namespace

extern "C" int srt_pgwalk(const int* mask, int S, const float* rays8,
                          const float* woop, int n_groups, int any_hit,
                          float* out_t, int* out_i, void* stream) {
  const int grid = (n_groups + WARPS - 1) / WARPS;
  if (grid > 0)
    pgwalk_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        mask, S, rays8, woop, n_groups, any_hit, out_t, out_i);
  return (int)cudaGetLastError();
}
