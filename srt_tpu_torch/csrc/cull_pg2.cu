// B3: per-group cull.  Replaces _cull_pg2_kernel
// (srt_tpu/ops/traversal_pallas.py:527, launched by _launch_cull_pg2).
//
// Per group of G consecutive rays: slab-test every ray against every
// cluster AABB (entry max(t_near, 0) below the ray's t_max), OR the
// occupancy over the group, pack it as one 16-bit word per super, and
// list the supers with a nonzero word in ascending index, with the words
// and a count.  Unused slots hold 0.
//
// What bounds it: 16*S slab tests (~20 flops each) per ray, reading the
// cluster boxes as warp-wide broadcasts; no data-dependent loop.  Design:
// one thread per ray, blocks of max(G, 128) threads; the group OR is a
// shuffle-xor reduction inside aligned segments of min(G, 32) lanes, plus
// a shared atomicOr across the warps of a group when G > 32; the group's
// first thread appends each nonzero word as the supers go by in index
// order, so the list needs no sort.  The TPU's 256-cluster chunks and MXU
// bitpack/rank matmuls have no counterpart.  Dead warps (G <= 32) or dead
// blocks skip the slab work (same result).
#include "traversal_common.cuh"

namespace {

using namespace srt;

__global__ void cull_pg2_kernel(const float* __restrict__ rays8,
                                const float* __restrict__ cb8, int stride,
                                int n_rays, int S, int group,
                                int* __restrict__ clist,
                                int* __restrict__ bits,
                                int* __restrict__ counts) {
  extern __shared__ unsigned sw[];  // [2][groups per block], G > 32 only
  const int tid = threadIdx.x;
  const int gpb = blockDim.x / group;
  const size_t ray = (size_t)blockIdx.x * blockDim.x + tid;
  const size_t n_groups = (size_t)n_rays / group;
  const int gl = tid / group;
  const size_t g = (size_t)blockIdx.x * gpb + gl;
  const bool leader = (tid % group) == 0 && g < n_groups;
  Ray r = {0.f, 0.f, 0.f, 1.f, 1.f, 1.f, 0.f, 0.f};
  if (ray < (size_t)n_rays) r = load_ray(rays8, ray);
  const float ix = 1.f / r.dx, iy = 1.f / r.dy, iz = 1.f / r.dz;
  const float px = r.ox * ix, py = r.oy * iy, pz = r.oz * iz;
  const int seg = group < 32 ? group : 32;

  for (int i = tid; i < 2 * gpb; i += blockDim.x) sw[i] = 0;
  // Block-uniform when G > 32 (the loop below synchronises the block);
  // warp-uniform otherwise.
  const bool block_live = __syncthreads_or(r.t_max > 0.f);
  const bool run = group > 32 ? block_live : __any_sync(FULL, r.t_max > 0.f);
  int cnt = 0;
  int* crow = clist + g * S;
  int* brow = bits + g * S;
  if (run) {
    for (int s = 0; s < S; ++s) {
      unsigned word = 0;
#pragma unroll 4
      for (int k = 0; k < SUPER; ++k) {
        const int c = s * SUPER + k;
        float sel;
        if (slab<true>(cb8[c], cb8[stride + c], cb8[2 * stride + c],
                       cb8[3 * stride + c], cb8[4 * stride + c],
                       cb8[5 * stride + c], px, py, pz, ix, iy, iz, r.t_max,
                       &sel))
          word |= 1u << k;
      }
      for (int off = seg >> 1; off > 0; off >>= 1)
        word |= __shfl_xor_sync(FULL, word, off);
      if (group > 32) {
        // Double-buffered by super parity: the leader clears the buffer it
        // read before the next barrier, and it is not written again until
        // two supers later.
        unsigned* buf = sw + (s & 1) * gpb;
        if ((tid & 31) == 0 && word) atomicOr(&buf[gl], word);
        __syncthreads();
        if (tid % group == 0) {
          word = buf[gl];
          buf[gl] = 0;
        }
      }
      if (leader && word) {
        crow[cnt] = s;
        brow[cnt] = (int)word;
        ++cnt;
      }
    }
  }
  if (leader) {
    for (int q = cnt; q < S; ++q) {
      crow[q] = 0;
      brow[q] = 0;
    }
    counts[g] = cnt;
  }
}

}  // namespace

extern "C" int srt_cull_pg2(const float* rays8, const float* cb8, int stride,
                            int n_rays, int S, int group, int* clist,
                            int* bits, int* counts, void* stream) {
  const int block = group > 128 ? group : 128;
  const int gpb = block / group;
  const int n_groups = n_rays / group;
  const int grid = (n_groups + gpb - 1) / gpb;
  if (grid > 0)
    cull_pg2_kernel<<<grid, block, 2 * gpb * sizeof(unsigned),
                      (cudaStream_t)stream>>>(rays8, cb8, stride, n_rays, S,
                                              group, clist, bits, counts);
  return (int)cudaGetLastError();
}
