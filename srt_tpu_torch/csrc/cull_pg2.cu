// B3: per-group cull.  Replaces _cull_pg2_kernel
// (srt_tpu/ops/traversal_pallas.py:527, launched by _launch_cull_pg2 at
// :649).
//
// Per group of G consecutive rays: slab-test every ray against every
// cluster AABB (entry max(t_near, 0) below the ray's t_max), OR the
// occupancy over the group, pack it as one 16-bit word per super, and
// list the supers with a nonzero word in ascending index, with the words
// and a count.  Unused slots hold 0.
//
// What bounds it: the slab tests (15.5 ALU-pipe instructions each in the
// SASS, ALU-bound; chip_smoke.py phase 2) the rays need, and
// for groups with few live rays the 2*S list and word slots written per
// group.  What held the first design (one thread per ray testing all 16*S
// clusters, a block barrier and a shared atomicOr per super when G > 32,
// one leader thread per group appending and zero-filling the row, six
// scalar loads per box) back, and what this one does:
//
// 1. Every ray tested every cluster, though bounce and shadow rays enter
//    few supers.  Now each warp slab-tests the supers' bounds (sbounds,
//    the exact min/max of their real clusters) first, a chunk's worth of
//    independent tests into one bit mask per lane, in the cluster test's
//    FMA form, and skips a super's 16 cluster tests when no lane enters
//    it before its t_max.  This is exact: rounding is monotone, so a
//    cluster's t_near is >= and its t_far <= the super's, and a super that
//    fails fails every cluster.  A super test that yields NaN (a zero
//    bound times an infinite reciprocal, where a cluster's nonzero bound
//    gives an infinity) counts as a pass.  Dead lanes pass nothing.
// 2. A barrier per super: now each warp ORs its word over its segment of
//    min(G, 32) lanes with shuffles and keeps it in shared memory; groups
//    wider than a warp combine their warps' words once per chunk of
//    CHUNK supers, where the block synchronises anyway.
// 3. A serial list: now, per chunk, the group's list builder (its lanes
//    when G <= 32, its first warp when G > 32) ranks the nonzero words by
//    a ballot and a popcount prefix and writes them at consecutive
//    positions, and the whole block zero-fills the rest of its rows at
//    the end, so each store instruction covers consecutive addresses.
// 4. Six scalar loads per box: now the chunk's super and cluster boxes
//    are staged in shared memory as two float4 each and read as
//    broadcasts.  (An array-of-structures copy read from device memory
//    instead was slower on every frame of the main path.)
//
// Blocks whose rays are all dead only zero-fill their rows.
#include "traversal_common.cuh"

namespace {

using namespace srt;

constexpr int CHUNK = 64;    // supers staged in shared memory at a time
constexpr int BLOCK = 256;   // threads per block when G <= BLOCK, else G

// Dynamic shared memory of a launch: cluster boxes, super boxes, warp
// liveness, group counts, and one 16-bit word per (slot, super) of the
// chunk, a slot being a group (G <= 32) or a warp.
size_t smem_bytes(int threads, int group) {
  const int seg = group < 32 ? group : 32;
  return (size_t)CHUNK * SUPER * 2 * sizeof(float4) +
         CHUNK * 2 * sizeof(float4) + 32 * sizeof(int) +
         BLOCK * sizeof(int) +
         (size_t)(threads / seg) * CHUNK * sizeof(unsigned short);
}

// MAX_THREADS: the launch's block size bound, BLOCK or 1024 (G > BLOCK);
// ptxas then keeps the registers that many threads may use.
template <int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    cull_pg2_kernel(const float* __restrict__ rays8,
                    const float* __restrict__ cb8, int stride,
                    const float* __restrict__ sbounds, int n_rays, int S,
                    int group, int* __restrict__ clist,
                    int* __restrict__ bits, int* __restrict__ counts) {
  extern __shared__ float4 smem[];
  float4* cbox = smem;                                  // [CHUNK*16][2]
  float4* sbox = cbox + CHUNK * SUPER * 2;               // [CHUNK][2]
  int* wlive = reinterpret_cast<int*>(sbox + CHUNK * 2);   // [32]
  int* gcnt = wlive + 32;                                  // [BLOCK]
  unsigned short* words =
      reinterpret_cast<unsigned short*>(gcnt + BLOCK);     // [slots][CHUNK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg = group < 32 ? group : 32;
  const int gpb = blockDim.x / group;
  const size_t g0 = (size_t)blockIdx.x * gpb;
  const int ng = (int)min((size_t)gpb, (size_t)n_rays / group - g0);
  const int gl = tid / group;
  const size_t ray = g0 * group + tid;
  Ray r = {0.f, 0.f, 0.f, 1.f, 1.f, 1.f, 0.f, 0.f};
  if (ray < (size_t)n_rays) r = load_ray(rays8, ray);
  const float ix = 1.f / r.dx, iy = 1.f / r.dy, iz = 1.f / r.dz;
  const float px = r.ox * ix, py = r.oy * iy, pz = r.oz * iz;
  const bool live = r.t_max > 0.f;
  const bool warp_live = __any_sync(FULL, live);
  int* crow0 = clist + g0 * S;
  int* brow0 = bits + g0 * S;
  const size_t row_len = (size_t)ng * S;

  if (!__syncthreads_or(live)) {  // block-uniform
    for (size_t q = tid; q < row_len; q += blockDim.x) {
      crow0[q] = 0;
      brow0[q] = 0;
    }
    for (int q = tid; q < ng; q += blockDim.x) counts[g0 + q] = 0;
    return;
  }
  if (lane == 0) wlive[warp] = warp_live;
  const int slot = tid / seg;
  const int sl = lane & (seg - 1);
  // The list builder: a live warp's segments (G <= 32), or the group's
  // first warp (G > 32); each lane holds the group's entry count.
  const bool builder = group <= 32 ? warp_live : (tid % group) < 32;
  const unsigned seg_mask =
      seg == 32 ? FULL : ((1u << seg) - 1) << (lane & ~(seg - 1));
  int* crow = clist + (g0 + gl) * S;
  int* brow = bits + (g0 + gl) * S;
  int cnt = 0;

  for (int s0 = 0; s0 < S; s0 += CHUNK) {
    const int ns = min(CHUNK, S - s0);
    for (int i = tid; i < ns * SUPER; i += blockDim.x) {
      const int c = s0 * SUPER + i;
      cbox[2 * i] = make_float4(cb8[c], cb8[stride + c], cb8[2 * stride + c],
                                cb8[3 * stride + c]);
      cbox[2 * i + 1] =
          make_float4(cb8[4 * stride + c], cb8[5 * stride + c], 0.f, 0.f);
    }
    for (int i = tid; i < ns; i += blockDim.x) {
      const int s = s0 + i;
      sbox[2 * i] = make_float4(sbounds[s], sbounds[S + s],
                                sbounds[2 * S + s], sbounds[3 * S + s]);
      sbox[2 * i + 1] =
          make_float4(sbounds[4 * S + s], sbounds[5 * S + s], 0.f, 0.f);
    }
    __syncthreads();
    if (warp_live) {  // warp-uniform
      // The chunk's super pre-tests first (independent tests, one bit
      // each), OR-ed over the warp; then the cluster tests of the supers
      // some lane may enter.
      unsigned long long todo = 0;
      if (live) {
#pragma unroll 4
        for (int j = 0; j < ns; ++j)
          todo |= (unsigned long long)may_enter<true>(
                      sbox[2 * j], sbox[2 * j + 1], px, py, pz, ix, iy, iz,
                      r.t_max)
                  << j;
      }
      todo = (unsigned long long)__reduce_or_sync(FULL, (unsigned)(todo >> 32))
                 << 32 |
             __reduce_or_sync(FULL, (unsigned)todo);
      for (int j = 0; j < ns; ++j) {
        unsigned word = 0;
        if ((todo >> j) & 1) {
          const float4* bj = cbox + j * SUPER * 2;
#pragma unroll 8
          for (int k = 0; k < SUPER; ++k) {
            const float4 a = bj[2 * k], b = bj[2 * k + 1];
            float sel;
            if (slab<true>(a.x, a.y, a.z, a.w, b.x, b.y, px, py, pz, ix, iy,
                           iz, r.t_max, &sel))
              word |= 1u << k;
          }
          if (seg == 32) {
            word = __reduce_or_sync(FULL, word);
          } else {
            for (int off = seg >> 1; off > 0; off >>= 1)
              word |= __shfl_xor_sync(FULL, word, off);
          }
        }
        if (sl == 0) words[slot * CHUNK + j] = (unsigned short)word;
      }
    }
    __syncthreads();
    if (builder) {  // warp-uniform
      for (int j0 = 0; j0 < ns; j0 += seg) {
        const int j = j0 + sl;
        unsigned w = 0;
        if (j < ns) {
          if (group <= 32) {
            w = words[slot * CHUNK + j];
          } else {
            const int wpg = group >> 5;
            for (int q = gl * wpg; q < (gl + 1) * wpg; ++q)
              if (wlive[q]) w |= words[q * CHUNK + j];
          }
        }
        const unsigned ball = __ballot_sync(FULL, w != 0) & seg_mask;
        if (w) {
          const int pos = cnt + __popc(ball & ((1u << lane) - 1));
          crow[pos] = s0 + j;
          brow[pos] = (int)w;
        }
        cnt += __popc(ball);
      }
    }
  }
  if (tid % group == 0 && gl < ng) {
    gcnt[gl] = builder ? cnt : 0;
    counts[g0 + gl] = builder ? cnt : 0;
  }
  __syncthreads();
  for (size_t q = tid; q < row_len; q += blockDim.x) {
    const int gq = (int)(q / S);
    if ((int)(q - (size_t)gq * S) >= gcnt[gq]) {
      crow0[q] = 0;
      brow0[q] = 0;
    }
  }
}

}  // namespace

extern "C" int srt_cull_pg2(const float* rays8, const float* cb8, int stride,
                            const float* sbounds, int n_rays, int S,
                            int group, int* clist, int* bits, int* counts,
                            void* stream) {
  if (group < 1 || group > 1024 || (group & (group - 1)))
    return (int)cudaErrorInvalidValue;
  const int block = group > BLOCK ? group : BLOCK;
  const int gpb = block / group;
  const int n_groups = n_rays / group;
  const int grid = (n_groups + gpb - 1) / gpb;
  if (grid <= 0 || S <= 0) return 0;
  const auto kernel =
      block > BLOCK ? cull_pg2_kernel<1024> : cull_pg2_kernel<BLOCK>;
  const size_t smem = smem_bytes(block, group);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      rays8, cb8, stride, sbounds, n_rays, S, group, clist, bits, counts);
  return (int)cudaGetLastError();
}
