// The two kernels of the launch-cost and occupancy micro-benchmark
// (srt_tpu_torch/tools/micro_occ.py; replaces tools/micro_occ.py's
// triv_kernel, :45, and make_cf's kern, :76).  Neither keeps the TPU's
// shapes: JAX's one [8, 128] block and its grid of n / (tile * g) blocks
// fit the TPU's lanes and sequential grid, not 132 SMs.
//
// K1 add_one: o = x + 1 on n float32.  One float4 a thread (16-byte loads
// and stores, neighbouring threads on neighbouring addresses), in
// ceil(n / 1024) blocks of 256 threads; two or four float4 a thread, a
// block apart, measured no faster at [8192, 8192].  A length that is not a
// multiple of 4, or a pointer that is not 16-byte aligned, takes a scalar
// kernel, a float a thread; srt_add_one decides once from n and the
// pointers.  What bounds it: at [8, 128] (one block, 8 KiB that move in
// 2.4 ns at 3.35 TB/s) the launch alone, so K1 measures the fixed cost of a
// launch; at [8192, 8192] bytes (256 MiB each way, 0.160 ms at 3.35 TB/s).
//
// K2 occupancy_cf: rays component-first rays_cf [8, N] (rows ox oy oz dx dy
// dz t_max, row 7 unused), boxes bounds [8, C] (rows 0-2 lo, 3-5 hi) ->
// occ [N / tile, C] int32: 1 where some ray of the tile hits box c,
//   inv = 1 / d;  t0 = (lo - o) * inv;  t1 = (hi - o) * inv
//   t_near = max(min(t0, t1)) over xyz, t_far = min(max(t0, t1))
//   sel = t_near >= 0 ? t_near : t_far
//   hit = t_near <= t_far && t_far >= 0 && sel < t_max
// with NaN-propagating min/max as jnp.minimum/maximum.  The launch shape
// comes from (n, tile) and the SM count (micro_occ.occupancy_launch), not
// from JAX's g: a block takes whole tiles, never part of one, so a tile's
// OR stays in the block (no global atomics, no zeroed output), and at the
// tool's shape (262,144 rays, tile 512) the grid has 512 blocks for 132
// SMs.  A thread takes OCC_RAYS = 4 consecutive rays (two measured no
// faster): one float4 a used row when tile % 4 == 0 and rays_cf is 16-byte
// aligned (then n % 4 == 0 as well), else scalar loads.
// The boxes are staged in shared memory as two float4 (lo, hi), read as
// broadcasts, box outer and rays inner, so a box is read once for 4 rays.
// The OR: over the thread's rays in registers, then __reduce_or_sync when
// a warp's rays lie in one tile (tile % 128 == 0, or one tile a block),
// then one shared atomicOr a warp or a thread; the scalar path ORs by ray,
// since its rays may cross tiles.  What bounds it: at the tool's shape
// the 7 used rows (7.3 MB, 2.2 us at 3.35 TB/s) against the slab tests'
// min.NaN / max.NaN, compares and selects, which issue on the ALU pipe at
// 64 lanes an SM a clock (chip_smoke.py counts them in the SASS, about 16
// a test: 2.5 us); so a test takes two compares and a select, a thread
// keeps one mask for its 4 rays, and the grid fills every SM.  No tensor
// cores (there is no product) and no TMA (one pass over 7 rows, which
// 16-byte coalesced loads serve).
#include <cuda_runtime.h>
#include <stdint.h>

#include "traversal_common.cuh"

namespace {

constexpr int ADD_ONE_THREADS = 256;
constexpr int OCC_RAYS = 4;          // consecutive rays a thread
constexpr int OCC_MAX_BOXES = 32;    // one bit a box in a mask
constexpr int OCC_MAX_THREADS = 512;
constexpr int OCC_MAX_TILES = 512;   // tiles a block (shared masks)

__global__ void __launch_bounds__(ADD_ONE_THREADS)
    add_one_vec(const float4* __restrict__ x, float4* __restrict__ o,
                long long n4) {
  const long long i = (long long)blockIdx.x * ADD_ONE_THREADS + threadIdx.x;
  if (i < n4) {
    const float4 v = x[i];
    o[i] = make_float4(v.x + 1.0f, v.y + 1.0f, v.z + 1.0f, v.w + 1.0f);
  }
}

__global__ void __launch_bounds__(ADD_ONE_THREADS)
    add_one_scalar(const float* __restrict__ x, float* __restrict__ o,
                   long long n) {
  const long long i = (long long)blockIdx.x * ADD_ONE_THREADS + threadIdx.x;
  if (i < n) o[i] = x[i] + 1.0f;
}

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The plain version's hit in two compares and a select:
// max.NaN(t_near, 0) <= t_far holds exactly when t_near <= t_far and
// t_far >= 0 both do (t_near >= 0: the first gives the second; t_near < 0:
// the second gives the first), and a NaN end fails both forms.
__device__ __forceinline__ bool occ_hit(float t_near, float t_far,
                                        float t_max) {
  const float sel = t_near >= 0.0f ? t_near : t_far;
  return srt::max_nan(t_near, 0.0f) <= t_far && sel < t_max;
}

// The 7 used rows of rays base .. base + 3 of the block into v; a ray
// past the block's span gets t_max < 0, which no box passes.
template <bool VEC>
__device__ __forceinline__ void load_rays(const float* __restrict__ rows,
                                          int n, int base, int span,
                                          float (&v)[7][OCC_RAYS]) {
  if constexpr (VEC) {
    if (base >= span) return;
#pragma unroll
    for (int r = 0; r < 7; ++r) {
      const float4 w =
          *reinterpret_cast<const float4*>(rows + (size_t)r * n + base);
#pragma unroll
      for (int j = 0; j < OCC_RAYS; ++j) v[r][j] = lane_of(w, j);
    }
  } else {
#pragma unroll
    for (int j = 0; j < OCC_RAYS; ++j) {
      const bool live = base + j < span;
#pragma unroll
      for (int r = 0; r < 7; ++r)
        v[r][j] = live ? rows[(size_t)r * n + base + j]
                       : (r == 6 ? -1.0f : 1.0f);
    }
  }
}

// OCC_RAYS consecutive rays a thread.  VEC: tile % 4 == 0 and rows
// 16-byte aligned, so a thread's rays lie in one tile and load as one
// float4 a row.  The launch gives a block one tile, or tiles that one
// pass of its threads covers (srt_occupancy_cf checks), so a thread's
// rays lie in one tile for the whole kernel.  The first rays are loaded before the
// boxes are staged, so the two loads' latencies overlap.
template <bool VEC>
__global__ void __launch_bounds__(OCC_MAX_THREADS)
    occupancy_cf_kernel(const float* __restrict__ rays_cf,
                        const float* __restrict__ bounds, int n, int c_count,
                        int tile, int tiles_per_block,
                        int* __restrict__ occ) {
  __shared__ float4 box[2 * OCC_MAX_BOXES];
  __shared__ unsigned tile_mask[OCC_MAX_TILES];
  const int first_tile = blockIdx.x * tiles_per_block;
  const int tiles = min(tiles_per_block, n / tile - first_tile);
  const int span = tiles * tile;
  constexpr int R = OCC_RAYS;
  const int step = blockDim.x * R;
  const float* rows = rays_cf + (size_t)first_tile * tile;
  int base = threadIdx.x * R;
  float v[7][R];
  load_rays<VEC>(rows, n, base, span, v);
  for (int c = threadIdx.x; c < c_count; c += blockDim.x) {
    box[2 * c] = make_float4(bounds[c], bounds[c_count + c],
                             bounds[2 * c_count + c], 0.0f);
    box[2 * c + 1] = make_float4(bounds[3 * c_count + c],
                                 bounds[4 * c_count + c],
                                 bounds[5 * c_count + c], 0.0f);
  }
  for (int t = threadIdx.x; t < tiles_per_block; t += blockDim.x)
    tile_mask[t] = 0u;
  __syncthreads();

  unsigned mask = 0u;   // VEC: the thread's tile's boxes
  int cur = -1;         // scalar: the tile mask holds, block-local
  for (; base < span; base += step) {
    float inv[3][R];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < R; ++j) inv[k][j] = 1.0f / v[3 + k][j];
    unsigned ray_mask[VEC ? 1 : R] = {};
#pragma unroll 1
    for (int c = 0; c < c_count; ++c) {
      const float4 lo = box[2 * c], hi = box[2 * c + 1];
      bool hit[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float t_near, t_far;
        srt::slab_span<false>(lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, v[0][j],
                              v[1][j], v[2][j], inv[0][j], inv[1][j],
                              inv[2][j], &t_near, &t_far);
        hit[j] = occ_hit(t_near, t_far, v[6][j]);
      }
      if constexpr (VEC) {
        bool any = hit[0];
#pragma unroll
        for (int j = 1; j < R; ++j) any |= hit[j];
        if (any) ray_mask[0] |= 1u << c;
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j)
          if (hit[j]) ray_mask[j] |= 1u << c;
      }
    }
    if constexpr (VEC) {
      mask |= ray_mask[0];
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (base + j >= span) break;
        const int t = (base + j) / tile;
        if (t != cur) {
          if (mask) atomicOr(&tile_mask[cur], mask);
          cur = t;
          mask = 0u;
        }
        mask |= ray_mask[j];
      }
    }
    if (base + step < span) load_rays<VEC>(rows, n, base + step, span, v);
  }
  if constexpr (VEC) {
    // A thread's tile; a thread past the block's rays has mask 0.
    cur = threadIdx.x * R / tile;
    if (tiles_per_block == 1 || tile % (32 * R) == 0) {
      mask = __reduce_or_sync(srt::FULL, mask);
      if ((threadIdx.x & 31) == 0 && mask) atomicOr(&tile_mask[cur], mask);
    } else if (mask) {
      atomicOr(&tile_mask[cur], mask);
    }
  } else if (mask) {
    atomicOr(&tile_mask[cur], mask);
  }
  __syncthreads();
  int* out = occ + (size_t)first_tile * c_count;
  for (int i = threadIdx.x; i < tiles * c_count; i += blockDim.x)
    out[i] = (int)((tile_mask[i / c_count] >> (i % c_count)) & 1u);
}

}  // namespace

extern "C" int srt_add_one(const float* x, float* o, int n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return (int)cudaGetLastError();
  if (n % 4 != 0 || ((uintptr_t)x | (uintptr_t)o) % 16 != 0) {
    const long long blocks = ((long long)n + ADD_ONE_THREADS - 1) /
                             ADD_ONE_THREADS;
    add_one_scalar<<<(unsigned)blocks, ADD_ONE_THREADS, 0, s>>>(x, o, n);
    return (int)cudaGetLastError();
  }
  const long long n4 = n / 4;
  const unsigned blocks = (unsigned)((n4 + ADD_ONE_THREADS - 1) /
                                     ADD_ONE_THREADS);
  add_one_vec<<<blocks, ADD_ONE_THREADS, 0, s>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(o), n4);
  return (int)cudaGetLastError();
}

// n rays in n / tile tiles; (blocks, threads, tiles a block) from
// micro_occ.occupancy_launch: every tile in one block, and a block of one
// tile or of tiles that one pass of its threads covers.
extern "C" int srt_occupancy_cf(const float* rays_cf, const float* bounds,
                                int n, int c_count, int tile, int blocks,
                                int threads, int tiles_per_block, int* occ,
                                void* stream) {
  if (c_count < 1 || c_count > OCC_MAX_BOXES || tile < 1 || n < 0 ||
      n % tile != 0 || threads < 32 || threads > OCC_MAX_THREADS ||
      threads % 32 != 0 || tiles_per_block < 1 ||
      tiles_per_block > OCC_MAX_TILES || blocks < 0)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = n / tile;
  if ((long long)blocks * tiles_per_block < n_tiles ||
      (blocks > 0 && (long long)(blocks - 1) * tiles_per_block >= n_tiles) ||
      (tiles_per_block > 1 &&
       (long long)tiles_per_block * tile > (long long)threads * OCC_RAYS))
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (tile % OCC_RAYS == 0 && (uintptr_t)rays_cf % 16 == 0)
    occupancy_cf_kernel<true><<<blocks, threads, 0, s>>>(
        rays_cf, bounds, n, c_count, tile, tiles_per_block, occ);
  else
    occupancy_cf_kernel<false><<<blocks, threads, 0, s>>>(
        rays_cf, bounds, n, c_count, tile, tiles_per_block, occ);
  return (int)cudaGetLastError();
}
