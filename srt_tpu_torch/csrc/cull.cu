// B1: tiled-walk cull.  Replaces _cull_kernel
// (srt_tpu/ops/traversal_pallas.py:134, launched by _launch_cull).
//
// Per tile of rays: slab-test every ray against every supercluster AABB,
// take the tile minimum of the entry distance max(t_near, 0) over the rays
// that enter before their t_max, and write the entered supers ordered by
// (entry, index) with a count.  Unused list slots hold 0.
//
// What bounds it: S slab tests (~20 flops each) per ray plus an O(S^2)
// rank per tile; at S = 50 it is a small fraction of the walk that
// follows.  Design: one block per tile, one thread per ray; the tile
// minimum is a warp shuffle min, then a shared-memory atomicMin on the
// float bits, which order like the floats because entries are +0 or
// positive; the rank is one thread per super counting the entries before
// it.  The TPU's 8-tile SMEM windows and MXU rank/select matmuls have no
// counterpart here.  All-dead tiles skip the slab work (same result).
#include "traversal_common.cuh"

namespace {

using namespace srt;

__global__ void cull_kernel(const float* __restrict__ rays8,
                            const float* __restrict__ sb, int S, int tile,
                            int* __restrict__ clist, float* __restrict__ elist,
                            int* __restrict__ counts) {
  extern __shared__ unsigned e_bits[];  // [S] tile-min entry, float bits
  __shared__ int n_active;
  const int tile_id = blockIdx.x;
  const unsigned big_bits = __float_as_uint(BIG);
  for (int s = threadIdx.x; s < S; s += blockDim.x) e_bits[s] = big_bits;
  if (threadIdx.x == 0) n_active = 0;

  const Ray r = load_ray(rays8, (size_t)tile_id * tile + threadIdx.x);
  const float ix = 1.f / r.dx, iy = 1.f / r.dy, iz = 1.f / r.dz;
  const bool live = __syncthreads_or(r.t_max > 0.f);
  if (live) {
    for (int s = 0; s < S; ++s) {
      float sel;
      const bool hit = slab<false>(sb[s], sb[S + s], sb[2 * S + s],
                                   sb[3 * S + s], sb[4 * S + s], sb[5 * S + s],
                                   r.ox, r.oy, r.oz, ix, iy, iz, r.t_max, &sel);
      unsigned v = hit ? __float_as_uint(sel) : big_bits;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = min(v, __shfl_xor_sync(FULL, v, off));
      if ((threadIdx.x & 31) == 0 && v < big_bits) atomicMin(&e_bits[s], v);
    }
  }
  __syncthreads();

  int* crow = clist + (size_t)tile_id * S;
  float* erow = elist + (size_t)tile_id * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const unsigned es = e_bits[s];
    if (es < big_bits) {
      int rank = 0;  // active supers nearer than s, ties by index
      for (int q = 0; q < S; ++q) {
        const unsigned eq = e_bits[q];
        rank += (eq < es) || (eq == es && q < s);
      }
      crow[rank] = s;
      erow[rank] = __uint_as_float(es);
      atomicAdd(&n_active, 1);
    }
  }
  __syncthreads();
  const int cnt = n_active;
  for (int slot = cnt + threadIdx.x; slot < S; slot += blockDim.x) {
    crow[slot] = 0;
    erow[slot] = 0.f;
  }
  if (threadIdx.x == 0) counts[tile_id] = cnt;
}

}  // namespace

extern "C" int srt_cull(const float* rays8, const float* sbounds, int n_tiles,
                        int tile, int S, int* clist, float* elist, int* counts,
                        void* stream) {
  if (n_tiles > 0)
    cull_kernel<<<n_tiles, tile, S * sizeof(unsigned),
                  (cudaStream_t)stream>>>(rays8, sbounds, S, tile, clist,
                                          elist, counts);
  return (int)cudaGetLastError();
}

extern "C" const char* srt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
