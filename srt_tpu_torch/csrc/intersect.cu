// B2: tiled walk.  Replaces _intersect_kernel (srt_tpu/ops/traversal_pallas
// .py:1061, launched by _launch) in its three modes: resident (B2),
// stream=True (B2s) and count_evals=True (B2c), as template<STREAM, COUNT>.
//
// Per tile: walk the tile's ordered super list.  A super is processed only
// while its entry distance is below the tile gate (the max over the tile's
// rays of their best t) and, in any-hit mode, until every ray is resolved
// (hit inside t_max, or dead).  A processed super admits each of its 16
// clusters that some ray of the tile enters before its current best t;
// every admitted cluster's 128 triangles get a Woop evaluation.  Output:
// the candidate t and local triangle id of the lexicographic min of
// (t, index) (t_max and -1 on a miss).  Tie rule: smallest index; the TPU
// gives same-lane cross-super exact-t ties to the nearest-entry super
// instead (ROADMAP.md section C, measure zero).
//
// What bounds it: ~24 FMA-equivalents and one division per (ray,
// triangle), 128 triangles per admitted cluster, in a per-thread loop
// whose length depends on the data: latency-bound walks, not bandwidth.
// Design: one block per tile, one thread per ray; each admitted cluster's
// 13x128 Woop rows are staged in shared memory and read as broadcasts by
// every thread; the cluster word is a warp OR reduction plus a shared
// atomicOr; the tile gate is a block max; the any-hit early-out is
// __syncthreads_and.  The cluster gate uses each ray's best t at the
// start of the super, as the TPU's does.
//
// STREAM (B2s): the TPU copies a whole super (16 clusters, 128 KB) per
// list entry into two VMEM buffers; two such buffers exceed the 227 KB of
// shared memory a block may use on the H100.  Here the stage is per
// admitted cluster (6,656 bytes): a 1-D bulk copy (cp.async.bulk
// completing on an mbarrier, traversal_common.cuh) of cluster i+1 is
// issued while cluster i is evaluated.  The next cluster is known only
// within a super (the next super's gate and word depend on this super's
// results), so the pipeline restarts at each processed super and every
// copy it issues is waited before the super ends: no copy is in flight
// when the any-hit early-out skips the rest of the list or the block
// exits (the TPU needs its pend/drain logic, traversal_pallas.py:1145-
// 1178, 1296-1308, because it prefetches the next list entry).
//
// COUNT (B2c): thread 0 counts the supers processed and the popcount of
// each processed super's cluster word, written to ctr[tile] at the end.
#include "traversal_common.cuh"

namespace {

using namespace srt;

template <bool STREAM, bool COUNT>
__global__ void intersect_kernel(const int* __restrict__ counts,
                                 const int* __restrict__ clist,
                                 const float* __restrict__ elist, int list_w,
                                 const float* __restrict__ rays8,
                                 const float* __restrict__ cb,
                                 const float* __restrict__ woop, int tile,
                                 int any_hit, float* __restrict__ out_t,
                                 int* __restrict__ out_i,
                                 int* __restrict__ ctr) {
  __shared__ __align__(128) float w_sh[(STREAM ? 2 : 1) * WOOP_ROWS * CLUSTER];
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ unsigned word_sh;
  __shared__ float wmax_sh[32];
  __shared__ float tbm_sh;
  const int tile_id = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t ray = (size_t)tile_id * tile + tid;
  const Ray r = load_ray(rays8, ray);
  const float ix = 1.f / r.dx, iy = 1.f / r.dy, iz = 1.f / r.dz;
  float bt = r.t_max;
  int bi = MISS_IDX;
  float tbm = BIG;
  bool done = false;
  int n_super = 0, n_cluster = 0;
  const int cnt = counts[tile_id];
  Stage st;
  if (STREAM) st = stage_init(w_sh, bars);

  for (int j = 0; j < cnt; ++j) {
    // Block-uniform gate: tbm and done come from block reductions.
    if (!(elist[(size_t)tile_id * list_w + j] < tbm) || done) continue;
    const int s = clist[(size_t)tile_id * list_w + j];
    const float* b = cb + (size_t)s * 8 * SUPER;
    unsigned mine = 0;
#pragma unroll 4
    for (int k = 0; k < SUPER; ++k) {
      float sel;
      if (slab<false>(b[k], b[SUPER + k], b[2 * SUPER + k], b[3 * SUPER + k],
                      b[4 * SUPER + k], b[5 * SUPER + k], r.ox, r.oy, r.oz,
                      ix, iy, iz, bt, &sel))
        mine |= 1u << k;
    }
    if (tid == 0) word_sh = 0;
    __syncthreads();
    mine = __reduce_or_sync(FULL, mine);
    if ((tid & 31) == 0 && mine) atomicOr(&word_sh, mine);
    __syncthreads();
    unsigned word = word_sh;
    if (COUNT) {
      ++n_super;
      n_cluster += __popc(word);
    }
    int slot = 0;
    if (STREAM && word && tid == 0)
      stage_issue(st, 0, woop, s * SUPER + __ffs(word) - 1);
    while (word) {
      const int k = __ffs(word) - 1;
      word &= word - 1;
      const int c = s * SUPER + k;
      const float* w;
      if (STREAM) {
        if (word && tid == 0)
          stage_issue(st, slot ^ 1, woop, s * SUPER + __ffs(word) - 1);
        stage_wait(st, slot);
        w = st.buffer(slot);
      } else {
        stage_cluster(w_sh, woop, c);
        __syncthreads();
        w = w_sh;
      }
      const int base = c * CLUSTER;
      for (int l = 0; l < CLUSTER; ++l) {
        float t;
        bool valid = woop_eval<false>(w, l, r, &t);
        if (any_hit) valid = valid && (t > r.t_lo);
        if (valid && (t < bt || (t == bt && base + l < bi))) {
          bt = t;
          bi = base + l;
        }
      }
      __syncthreads();  // the buffer is free again
      slot ^= 1;
    }
    // Tighten the gates: block max of the per-ray best t.
    float m = bt;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    if ((tid & 31) == 0) wmax_sh[tid >> 5] = m;
    __syncthreads();
    if (tid == 0) {
      float mm = wmax_sh[0];
      for (int w = 1; w < (int)(blockDim.x >> 5); ++w) mm = fmaxf(mm, wmax_sh[w]);
      tbm_sh = mm;
    }
    if (any_hit) {
      // Resolved: some hit inside t_max, or dead (t_max <= 0).
      done = __syncthreads_and((bt < r.t_max) || (r.t_max <= 0.f)) != 0;
    } else {
      __syncthreads();
    }
    tbm = tbm_sh;
  }
  out_t[ray] = bt;
  out_i[ray] = (bt < r.t_max) ? bi : -1;
  if (COUNT && tid == 0) {
    ctr[2 * tile_id] = n_super;
    ctr[2 * tile_id + 1] = n_cluster;
  }
}

template <bool STREAM, bool COUNT>
int launch(const int* counts, const int* clist, const float* elist,
           int list_w, const float* rays8, const float* cb, const float* woop,
           int n_tiles, int tile, int any_hit, float* out_t, int* out_i,
           int* ctr, void* stream) {
  if (n_tiles > 0)
    intersect_kernel<STREAM, COUNT><<<n_tiles, tile, 0, (cudaStream_t)stream>>>(
        counts, clist, elist, list_w, rays8, cb, woop, tile, any_hit, out_t,
        out_i, ctr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int srt_intersect(const int* counts, const int* clist,
                             const float* elist, int list_w,
                             const float* rays8, const float* cb,
                             const float* woop, int n_tiles, int tile,
                             int any_hit, float* out_t, int* out_i,
                             void* stream) {
  return launch<false, false>(counts, clist, elist, list_w, rays8, cb, woop,
                              n_tiles, tile, any_hit, out_t, out_i, nullptr,
                              stream);
}

extern "C" int srt_intersect_stream(const int* counts, const int* clist,
                                    const float* elist, int list_w,
                                    const float* rays8, const float* cb,
                                    const float* woop, int n_tiles, int tile,
                                    int any_hit, float* out_t, int* out_i,
                                    void* stream) {
  return launch<true, false>(counts, clist, elist, list_w, rays8, cb, woop,
                             n_tiles, tile, any_hit, out_t, out_i, nullptr,
                             stream);
}

extern "C" int srt_intersect_count(const int* counts, const int* clist,
                                   const float* elist, int list_w,
                                   const float* rays8, const float* cb,
                                   const float* woop, int n_tiles, int tile,
                                   int any_hit, float* out_t, int* out_i,
                                   int streamed, int* ctr, void* stream) {
  if (streamed)
    return launch<true, true>(counts, clist, elist, list_w, rays8, cb, woop,
                              n_tiles, tile, any_hit, out_t, out_i, ctr,
                              stream);
  return launch<false, true>(counts, clist, elist, list_w, rays8, cb, woop,
                             n_tiles, tile, any_hit, out_t, out_i, ctr,
                             stream);
}
