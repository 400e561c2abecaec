// B5: per-group super entries of the pair-binned walk.  Replaces
// _cull_perray_kernel (srt_tpu/ops/traversal_pallas.py:284, launched by
// _launch_cull_perray).
//
// Per group of 8 consecutive rays: slab-test every ray against every
// supercluster AABB in B1's (box - o) * inv form and write, per super, the
// minimum entry max(t_near, 0) over the group's rays that enter it before
// their t_max, else BIG: e [Np/8, S] f32.
//
// What bounds it: S slab tests (~26 operations each) per ray against 4
// bytes written per group and super, so at the headline's S = 50 it is
// bound by operations on paper and by its scattered 4-byte stores in
// practice (no data-dependent loop).  Design: one thread per ray, blocks
// of 256; the super bounds are staged in shared memory in chunks of 256
// supers and read as broadcasts; the group minimum is a shuffle-xor over
// offsets 4, 2, 1 (every value is BIG or a passing entry, never NaN), and
// the group's first lane writes.  Warps whose rays are all dead skip the
// slab tests and write BIG, the same result (the TPU skips all-dead tile
// rows).
#include "traversal_common.cuh"

namespace {

using namespace srt;

constexpr int BLOCK = 256;
constexpr int CHUNK = 256;   // supers staged per pass

__global__ void cull_perray_kernel(const float* __restrict__ rays8,
                                   const float* __restrict__ sb, int n_rays,
                                   int S, float* __restrict__ e) {
  __shared__ float box[6][CHUNK];
  const size_t ray = (size_t)blockIdx.x * BLOCK + threadIdx.x;
  Ray r = {0.f, 0.f, 0.f, 1.f, 1.f, 1.f, 0.f, 0.f};
  if (ray < (size_t)n_rays) r = load_ray(rays8, ray);
  const float ix = 1.f / r.dx, iy = 1.f / r.dy, iz = 1.f / r.dz;
  const bool live = __any_sync(FULL, r.t_max > 0.f);  // warp-uniform
  const bool writer = (threadIdx.x & 7) == 0 && ray < (size_t)n_rays;
  float* row = e + (ray / 8) * S;

  for (int s0 = 0; s0 < S; s0 += CHUNK) {
    const int len = min(CHUNK, S - s0);
    __syncthreads();  // the previous chunk's reads are done
    for (int i = threadIdx.x; i < 6 * len; i += BLOCK)
      box[i / len][i % len] = sb[(i / len) * S + s0 + i % len];
    __syncthreads();
    for (int k = 0; k < len; ++k) {
      float v = BIG;
      if (live) {
        float sel;
        if (slab<false>(box[0][k], box[1][k], box[2][k], box[3][k],
                        box[4][k], box[5][k], r.ox, r.oy, r.oz, ix, iy, iz,
                        r.t_max, &sel))
          v = sel;
        v = fminf(v, __shfl_xor_sync(FULL, v, 4));
        v = fminf(v, __shfl_xor_sync(FULL, v, 2));
        v = fminf(v, __shfl_xor_sync(FULL, v, 1));
      }
      if (writer) row[s0 + k] = v;
    }
  }
}

}  // namespace

extern "C" int srt_cull_perray(const float* rays8, const float* sbounds,
                               int n_rays, int S, float* e, void* stream) {
  const int grid = (n_rays + BLOCK - 1) / BLOCK;
  if (grid > 0 && S > 0)
    cull_perray_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        rays8, sbounds, n_rays, S, e);
  return (int)cudaGetLastError();
}
