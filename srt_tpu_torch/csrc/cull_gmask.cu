// B6: per-group cluster masks of the mask-scan walk.  Replaces
// _cull_gmask_kernel (srt_tpu/ops/traversal_pallas.py:436, launched by
// _launch_cull_gmask).
//
// Per group of 8 consecutive rays: slab-test every ray against every
// cluster AABB in B1's (box - o) * inv form (not B3's box * inv - o * inv:
// the two round differently), OR the occupancy over the group, and write
// it uncompacted as one 16-bit word per super (bit k of word s is cluster
// 16*s + k): mask [Np/8, S] int32.  Padding clusters carry NaN boxes and
// set no bit.
//
// What bounds it: 16*S slab tests (~26 operations each) per ray, reading
// the cluster boxes as warp-wide broadcasts; no data-dependent loop.
// Design: one thread per ray, each super's word built in a register
// (no super pre-test, unlike cull_pg2.cu), the group OR a
// shuffle-xor over offsets 4, 2, 1, the group's first lane writing.  The
// TPU's 256-cluster chunks and MXU bitpack matmul have no counterpart.
// Warps whose rays are all dead skip the slab tests and write 0, the same
// result.
#include "traversal_common.cuh"

namespace {

using namespace srt;

constexpr int BLOCK = 128;

__global__ void cull_gmask_kernel(const float* __restrict__ rays8,
                                  const float* __restrict__ cb8, int stride,
                                  int n_rays, int S, int* __restrict__ mask) {
  const size_t ray = (size_t)blockIdx.x * BLOCK + threadIdx.x;
  Ray r = {0.f, 0.f, 0.f, 1.f, 1.f, 1.f, 0.f, 0.f};
  if (ray < (size_t)n_rays) r = load_ray(rays8, ray);
  const float ix = 1.f / r.dx, iy = 1.f / r.dy, iz = 1.f / r.dz;
  const bool live = __any_sync(FULL, r.t_max > 0.f);  // warp-uniform
  const bool writer = (threadIdx.x & 7) == 0 && ray < (size_t)n_rays;
  int* row = mask + (ray / 8) * S;

  for (int s = 0; s < S; ++s) {
    unsigned word = 0;
    if (live) {
#pragma unroll 4
      for (int k = 0; k < SUPER; ++k) {
        const int c = s * SUPER + k;
        float sel;
        if (slab<false>(cb8[c], cb8[stride + c], cb8[2 * stride + c],
                        cb8[3 * stride + c], cb8[4 * stride + c],
                        cb8[5 * stride + c], r.ox, r.oy, r.oz, ix, iy, iz,
                        r.t_max, &sel))
          word |= 1u << k;
      }
      word |= __shfl_xor_sync(FULL, word, 4);
      word |= __shfl_xor_sync(FULL, word, 2);
      word |= __shfl_xor_sync(FULL, word, 1);
    }
    if (writer) row[s] = (int)word;
  }
}

}  // namespace

extern "C" int srt_cull_gmask(const float* rays8, const float* cb8,
                              int stride, int n_rays, int S, int* mask,
                              void* stream) {
  const int grid = (n_rays + BLOCK - 1) / BLOCK;
  if (grid > 0 && S > 0)
    cull_gmask_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        rays8, cb8, stride, n_rays, S, mask);
  return (int)cudaGetLastError();
}
