// B5: per-group super entries of the pair-binned walk.  Replaces
// _cull_perray_kernel (srt_tpu/ops/traversal_pallas.py:284, launched by
// _launch_cull_perray at :337).
//
// Per group of 8 consecutive rays: slab-test every ray against every
// supercluster AABB in B1's (box - o) * inv form and write, per super, the
// minimum entry max(t_near, 0) over the group's rays that enter it before
// their t_max, else BIG: e [Np/8, S] f32.
//
// What bounds it: S slab tests (14.6 ALU-pipe instructions each in the
// SASS, ALU-bound; chip_smoke.py phase 2) per live ray, above the
// rays read and 4 bytes written per group and super even at the
// headline's S = 50.  What held the
// first design (one thread per ray, a three-step shuffle-and-fminf chain
// per super, one lane in eight storing S scattered floats, and 16 blocks
// on 132 SMs for a 4,096-ray launch) back, and what this one does:
//
// 1. A thread per (group, super) item, no reduction: a warp takes gpw
//    consecutive groups (1, 2 or 4: traversal.group_cull_shape), each lane
//    loads one of their rays and its IEEE reciprocals once into shared
//    memory, and lane i takes items i, i + 32, ... of the warp's gpw * S
//    (group-major, so consecutive lanes hold consecutive supers).  An item
//    reads its group's 8 rays from shared memory (broadcasts), tests them
//    as independent chains with no branch (a dead ray passes no test) and
//    keeps the minimum in a register.  (A thread per ray with one
//    redux.sync minimum per group and super was slower on every launch
//    of the binned frame; PERF.md.)
// 2. Scattered stores: item i of the warp is float i of its groups' rows,
//    so each store instruction covers 32 consecutive floats and a block's
//    rows are one span.
// 3. Few rays filled few SMs: launches of few groups take one group a
//    warp, so a 4,096-ray launch is 512 warps over the card; large ones
//    take four, whose rays load together.
//
// Groups whose rays are all dead skip the slab tests and store BIG, the
// same result (the TPU skips all-dead tile rows).
#include "traversal_common.cuh"

namespace {

using namespace srt;

constexpr int GROUP = 8;
constexpr int MAX_WARPS = 16;  // warps a block, at most

__global__ void __launch_bounds__(32 * MAX_WARPS)
    cull_perray_kernel(const float* __restrict__ rays8,
                       const float* __restrict__ sb, int n_groups, int S,
                       int gpw, float* __restrict__ e) {
  extern __shared__ float4 ray_sh[];  // [warps][32 rays][2]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t g0 = ((size_t)blockIdx.x * (blockDim.x >> 5) + warp) * gpw;
  if (g0 >= (size_t)n_groups) return;  // warp-uniform; no block barrier
  const int ng = (int)min((size_t)gpw, (size_t)n_groups - g0);
  float4* rs = ray_sh + warp * 2 * 32;
  const unsigned live =
      stage_group_rays(rays8, g0 * GROUP, ng * GROUP, rs);
  float* out = e + g0 * S;
  // Item i = gl * S + s: lane's first item, then 32 on.
  int gl = lane / S, s = lane - gl * S;
  for (int i = lane; gl < ng; i += 32) {
    float v = BIG;
    if ((live >> (GROUP * gl)) & 0xffu) {
      const float lx = sb[s], ly = sb[S + s], lz = sb[2 * S + s],
                  hx = sb[3 * S + s], hy = sb[4 * S + s], hz = sb[5 * S + s];
      const float4* r = rs + 2 * GROUP * gl;
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        const float4 o = r[2 * k], iv = r[2 * k + 1];
        float sel;  // a dead ray (t_max <= 0) passes no test
        if (slab<false>(lx, ly, lz, hx, hy, hz, o.x, o.y, o.z, iv.x, iv.y,
                        iv.z, o.w, &sel))
          v = fminf(v, sel);
      }
    }
    out[i] = v;
    for (s += 32; s >= S; s -= S) ++gl;
  }
}

}  // namespace

extern "C" int srt_cull_perray(const float* rays8, const float* sbounds,
                               int n_rays, int S, int groups_per_warp,
                               int warps_per_block, float* e, void* stream) {
  if (groups_per_warp < 1 || groups_per_warp > 32 / GROUP ||
      warps_per_block < 1 || warps_per_block > MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  const int n_groups = n_rays / GROUP;
  const int n_warps = (n_groups + groups_per_warp - 1) / groups_per_warp;
  const int grid = (n_warps + warps_per_block - 1) / warps_per_block;
  const size_t smem = (size_t)warps_per_block * 2 * 32 * sizeof(float4);
  if (grid > 0 && S > 0)
    cull_perray_kernel<<<grid, 32 * warps_per_block, smem,
                         (cudaStream_t)stream>>>(rays8, sbounds, n_groups, S,
                                                 groups_per_warp, e);
  return (int)cudaGetLastError();
}
