// The two kernels of the launch-cost and occupancy micro-benchmark
// (srt_tpu_torch/tools/micro_occ.py; replaces tools/micro_occ.py's
// triv_kernel, :45, and make_cf's kern, :76).
//
// K1 add_one: o = x + 1 on one [8, 128] float32 block, one block of 256
// threads: a probe of the fixed cost of one launch.  Its 8 KiB move in a
// few ns at 3.35 TB/s, so its time is the launch and nothing else; it
// stays one block on purpose.
//
// K2 occupancy_cf: rays component-first rays_cf [8, N] (rows ox oy oz dx dy
// dz t_max, row 7 unused), boxes bounds [8, C] (rows 0-2 lo, 3-5 hi) ->
// occ [N / tile, C] int32: 1 where some ray of the tile hits box c,
//   inv = 1 / d;  t0 = (lo - o) * inv;  t1 = (hi - o) * inv
//   t_near = max(min(t0, t1)) over xyz, t_far = min(max(t0, t1))
//   sel = t_near >= 0 ? t_near : t_far
//   hit = t_near <= t_far && t_far >= 0 && sel < t_max
// with NaN-propagating min/max as jnp.minimum/maximum.  A thread a ray
// computes a C-bit mask of its hits; the tile's OR comes from one warp
// reduction and shared-memory atomics; a block takes g tiles.  The output
// does not depend on g.  What bounds it: the 7 used rows of rays_cf
// (28 bytes a ray) against ~26 slab operations a (ray, box): at C = 10 it
// is bound by bytes, so a ray is read once, coalesced, row by row.
#include <cuda_runtime.h>
#include <stdint.h>

#include "traversal_common.cuh"

namespace {

constexpr int ADD_ONE_THREADS = 256;
constexpr int OCC_THREADS = 256;
constexpr int OCC_MAX_BOXES = 32;   // one bit a box in the ray's mask

__global__ void add_one_kernel(const float* __restrict__ x,
                               float* __restrict__ o, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) o[i] = x[i] + 1.0f;
}

__global__ void occupancy_cf_kernel(const float* __restrict__ rays_cf,
                                    const float* __restrict__ bounds,
                                    int n, int c_count, int tile, int g,
                                    int* __restrict__ occ) {
  extern __shared__ unsigned char smem[];
  float* box = reinterpret_cast<float*>(smem);                // [6][C]
  unsigned* tile_mask =
      reinterpret_cast<unsigned*>(box + 6 * c_count);          // [g]
  for (int i = threadIdx.x; i < 6 * c_count; i += blockDim.x)
    box[i] = bounds[i];
  for (int i = threadIdx.x; i < g; i += blockDim.x) tile_mask[i] = 0u;
  __syncthreads();

  const int span = g * tile;
  const size_t first = (size_t)blockIdx.x * span;
  // A warp's 32 rays lie in one tile when tiles are whole warps.
  const bool warp_in_tile = tile % 32 == 0;
  for (int r = threadIdx.x; r < span; r += blockDim.x) {
    const size_t i = first + r;
    const float ox = rays_cf[i], oy = rays_cf[(size_t)n + i],
                oz = rays_cf[2 * (size_t)n + i];
    const float ix = 1.0f / rays_cf[3 * (size_t)n + i];
    const float iy = 1.0f / rays_cf[4 * (size_t)n + i];
    const float iz = 1.0f / rays_cf[5 * (size_t)n + i];
    const float t_max = rays_cf[6 * (size_t)n + i];
    unsigned mask = 0u;
    for (int c = 0; c < c_count; ++c) {
      const float t0x = (box[c] - ox) * ix;
      const float t1x = (box[3 * c_count + c] - ox) * ix;
      const float t0y = (box[c_count + c] - oy) * iy;
      const float t1y = (box[4 * c_count + c] - oy) * iy;
      const float t0z = (box[2 * c_count + c] - oz) * iz;
      const float t1z = (box[5 * c_count + c] - oz) * iz;
      const float t_near =
          srt::max_nan(srt::max_nan(srt::min_nan(t0x, t1x),
                                    srt::min_nan(t0y, t1y)),
                       srt::min_nan(t0z, t1z));
      const float t_far =
          srt::min_nan(srt::min_nan(srt::max_nan(t0x, t1x),
                                    srt::max_nan(t0y, t1y)),
                       srt::max_nan(t0z, t1z));
      const float sel = t_near >= 0.0f ? t_near : t_far;
      if (t_near <= t_far && t_far >= 0.0f && sel < t_max) mask |= 1u << c;
    }
    const int t = r / tile;
    if (warp_in_tile) {
      mask = __reduce_or_sync(srt::FULL, mask);
      if ((threadIdx.x & 31) == 0 && mask) atomicOr(&tile_mask[t], mask);
    } else if (mask) {
      atomicOr(&tile_mask[t], mask);
    }
  }
  __syncthreads();
  int* out = occ + (size_t)blockIdx.x * g * c_count;
  for (int i = threadIdx.x; i < g * c_count; i += blockDim.x)
    out[i] = (int)((tile_mask[i / c_count] >> (i % c_count)) & 1u);
}

}  // namespace

extern "C" int srt_add_one(const float* x, float* o, int n, void* stream) {
  add_one_kernel<<<1, ADD_ONE_THREADS, 0, (cudaStream_t)stream>>>(x, o, n);
  return (int)cudaGetLastError();
}

// n rays in n / tile tiles, a multiple of g (the wrapper checks).  Tiles
// of a multiple of 32 rays reduce a warp first; others take a shared
// atomic a ray that hits.
extern "C" int srt_occupancy_cf(const float* rays_cf, const float* bounds,
                                int n, int c_count, int tile, int g,
                                int* occ, void* stream) {
  if (c_count < 1 || c_count > OCC_MAX_BOXES || tile < 1 || g < 1 ||
      n % (tile * g) != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = n / (tile * g);
  const size_t shared = (6 * (size_t)c_count + g) * 4;
  if (shared > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (blocks > 0)
    occupancy_cf_kernel<<<blocks, OCC_THREADS, shared,
                          (cudaStream_t)stream>>>(rays_cf, bounds, n, c_count,
                                                  tile, g, occ);
  return (int)cudaGetLastError();
}
