// B6: per-group cluster masks of the mask-scan walk.  Replaces
// _cull_gmask_kernel (srt_tpu/ops/traversal_pallas.py:436, launched by
// _launch_cull_gmask at :501).
//
// Per group of 8 consecutive rays: slab-test every ray against every
// cluster AABB in B1's (box - o) * inv form (not B3's box * inv - o * inv:
// the two round differently), OR the occupancy over the group, and write
// it uncompacted as one 16-bit word per super (bit k of word s is cluster
// 16*s + k): mask [Np/8, S] int32.  Padding clusters carry NaN boxes and
// set no bit.
//
// What bounds it: the slab tests (14.4 ALU-pipe instructions each in
// the SASS, ALU-bound; chip_smoke.py phase 2) a two-level cull
// needs, S super tests per live ray and 16 cluster tests per (live ray,
// super it enters); on launches of few live rays, the rays read and the S
// words written per group.  What held the first design (one thread per
// ray testing all 16*S clusters, six scalar global loads per box, a
// three-step shuffle chain per super for the group OR, and one lane in
// eight storing S scattered words) back, and what this one does:
//
// 1. Every ray tested every cluster, though bounce and shadow rays enter
//    few supers.  Now a warp takes gpw consecutive groups (1 or 2:
//    traversal.group_cull_shape), each lane loads one of their rays and
//    its IEEE reciprocals once into shared memory, and the warp culls the
//    groups one after the other, reading the group's 8 rays from shared
//    memory at each test (broadcasts), tested as independent chains with
//    no branch (a dead ray passes no cluster test; its super test is
//    masked by its liveness).  Per 32 supers, lane j pre-tests super
//    s0 + j (sbounds, may_enter<false>) and a ballot gives the supers the
//    group may enter; only those get cluster tests.  (The rays copied to
//    registers took the pg frame 5% longer; PERF.md.)
// 2. The group OR was a shuffle chain per super.  Now each lane tests one
//    cluster against all of the group's rays, so the OR is the lane's
//    own; the two halves of the warp take two entered supers at a time
//    (cluster lane & 15 of each), and one ballot holds both 16-bit words.
//    No shuffle chain, no reduction.
// 3. Scattered stores: now lane j keeps super s0 + j's word and stores
//    it, so a group's row is written 32 consecutive ints at a time and a
//    block's rows are one span.  Groups with no live ray store zeros the
//    same way.
// 4. The boxes are read from device memory through the L1 cache (each
//    lane a different cluster, consecutive lanes consecutive clusters,
//    so each load is two 64-byte segments), not staged: a block holds
//    only a few groups, and the headline's 25 KB table stays in L1.
//    (Staging the entered supers' cluster boxes per block and 32-super
//    chunk in shared memory, two block barriers a chunk, took the pg
//    frame 5-30% longer at every launch shape; PERF.md.)
// 5. Few rays filled few SMs.  Launches of few groups take one group a
//    warp, so a 4,096-ray launch is 512 warps over the card and its few
//    live groups run side by side; large ones take two, whose rays load
//    together.
//
// Why the pre-test is exact in this form.  Rounding of box - o is
// monotone in the box bound, multiplying by a fixed inv keeps or reverses
// the order, and min/max undo the reversal; so a super's t_near is <= and
// its t_far >= those of every cluster it holds (sbounds is the exact
// min/max of the super's real clusters, NaN padding excluded), and a
// super that fails fails every cluster.  x - o is 0 only when x == o, so
// 0 * +-inf = NaN arises on the super only where some cluster shares that
// bound; a NaN super test counts as entering.  Dead rays (t_max <= 0)
// enter nothing.
#include "traversal_common.cuh"

namespace {

using namespace srt;

constexpr int GROUP = 8;
constexpr int MAX_WARPS = 16;  // warps a block, at most

__global__ void __launch_bounds__(32 * MAX_WARPS)
    cull_gmask_kernel(const float* __restrict__ rays8,
                      const float* __restrict__ cb8, int stride,
                      const float* __restrict__ sb, int n_groups, int S,
                      int gpw, int* __restrict__ mask) {
  extern __shared__ float4 ray_sh[];  // [warps][32 rays][2]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t g0 = ((size_t)blockIdx.x * (blockDim.x >> 5) + warp) * gpw;
  if (g0 >= (size_t)n_groups) return;  // warp-uniform; no block barrier
  const int ng = (int)min((size_t)gpw, (size_t)n_groups - g0);
  float4* rs = ray_sh + warp * 2 * 32;
  const unsigned live_all =
      stage_group_rays(rays8, g0 * GROUP, ng * GROUP, rs);

  for (int gl = 0; gl < ng; ++gl) {  // warp-uniform
    int* row = mask + (g0 + gl) * S;
    const unsigned live = (live_all >> (GROUP * gl)) & 0xffu;
    if (!live) {
      for (int s = lane; s < S; s += 32) row[s] = 0;
      continue;
    }
    const float4* r = rs + 2 * GROUP * gl;  // (origin, t_max), reciprocals
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      bool enter = false;
      if (s < S) {
        const float4 a = make_float4(sb[s], sb[S + s], sb[2 * S + s],
                                     sb[3 * S + s]);
        const float4 b = make_float4(sb[4 * S + s], sb[5 * S + s], 0.f, 0.f);
#pragma unroll
        for (int k = 0; k < GROUP; ++k) {
          const float4 o = r[2 * k], iv = r[2 * k + 1];
          enter |= ((live >> k) & 1u) &&
                   may_enter<false>(a, b, o.x, o.y, o.z, iv.x, iv.y, iv.z,
                                    o.w);
        }
      }
      unsigned todo = __ballot_sync(FULL, enter);
      unsigned word = 0;
      while (todo) {  // warp-uniform
        const int ja = __ffs(todo) - 1;
        todo &= todo - 1;
        const int jb = todo ? __ffs(todo) - 1 : -1;
        todo &= todo - 1;
        const int j = lane < 16 ? ja : jb;
        bool occ = false;
        if (j >= 0) {
          const int c = (s0 + j) * SUPER + (lane & 15);
          const float lx = __ldg(cb8 + c), ly = __ldg(cb8 + stride + c),
                      lz = __ldg(cb8 + 2 * stride + c),
                      hx = __ldg(cb8 + 3 * stride + c),
                      hy = __ldg(cb8 + 4 * stride + c),
                      hz = __ldg(cb8 + 5 * stride + c);
#pragma unroll
          for (int k = 0; k < GROUP; ++k) {
            const float4 o = r[2 * k], iv = r[2 * k + 1];
            float sel;  // a dead ray (t_max <= 0) passes no test
            occ |= slab<false>(lx, ly, lz, hx, hy, hz, o.x, o.y, o.z, iv.x,
                               iv.y, iv.z, o.w, &sel);
          }
        }
        const unsigned w = __ballot_sync(FULL, occ);
        if (lane == ja) word = w & 0xffffu;
        if (lane == jb) word = w >> 16;
      }
      if (s < S) row[s] = (int)word;
    }
  }
}

}  // namespace

extern "C" int srt_cull_gmask(const float* rays8, const float* cb8,
                              int stride, const float* sbounds, int n_rays,
                              int S, int groups_per_warp, int warps_per_block,
                              int* mask, void* stream) {
  if (groups_per_warp < 1 || groups_per_warp > 32 / GROUP ||
      warps_per_block < 1 || warps_per_block > MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  const int n_groups = n_rays / GROUP;
  const int n_warps = (n_groups + groups_per_warp - 1) / groups_per_warp;
  const int grid = (n_warps + warps_per_block - 1) / warps_per_block;
  const size_t smem = (size_t)warps_per_block * 2 * 32 * sizeof(float4);
  if (grid > 0 && S > 0)
    cull_gmask_kernel<<<grid, 32 * warps_per_block, smem,
                        (cudaStream_t)stream>>>(rays8, cb8, stride, sbounds,
                                                n_groups, S, groups_per_warp,
                                                mask);
  return (int)cudaGetLastError();
}
