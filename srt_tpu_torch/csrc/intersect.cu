// B2: tiled walk.  Replaces _intersect_kernel (srt_tpu/ops/traversal_pallas
// .py:1061, launched by _launch at :1327) in its three modes: resident
// (B2), stream=True (B2s) and count_evals=True (B2c).  B2 and B2s run one
// kernel and differ only in the table they are given (B2s's is padded to
// whole supers, which the TPU's per-super copies need); B2c is the same
// kernel with counters, template<COUNT>.
//
// Per tile: walk the tile's ordered super list.  A super is processed only
// while its entry distance is below the tile gate (the max over the tile's
// rays of their best t) and, in any-hit mode, until every ray is resolved
// (hit inside t_max, or dead).  A processed super admits each of its 16
// clusters that some ray of the tile enters before its best t at the
// start of the super; every admitted cluster's 128 triangles get a Woop
// evaluation.  Output: the candidate t and local triangle id of the
// lexicographic min of (t, index) (t_max and -1 on a miss).  Tie rule:
// smallest index; the TPU gives same-lane cross-super exact-t ties to the
// nearest-entry super instead (ROADMAP.md section C, measure zero).
//
// What bounds it: 47 FMA-pipe instructions per (ray, triangle) of the
// admitted clusters (FADD, FMUL and the division's FFMA in the SASS,
// FMA-bound; chip_smoke.py phase 2) and 17 ALU-pipe per cluster slab
// test; each admitted cluster's 13 Woop rows (6,656 bytes) are read once
// per tile.  What held the first design
// (one block of `tile` threads, one thread per ray evaluating all 128
// triangles of every admitted cluster as one serial chain; a cooperative
// copy between two barriers per cluster in the resident mode, a
// double-buffered copy restarted at every super in the streamed one)
// back, and what this one does:
//
// 1. One serial chain per ray, and launches of few tiles (the 65,536-ray
//    cases, 256 tiles; config8's primaries, 1,024) left the card under-
//    filled.  Now a tile's block has L * tile threads (L lanes per ray,
//    chosen by the wrapper, at most 1024 threads); thread t takes ray
//    t mod tile and, in each admitted cluster, every L-th pair of
//    triangles as two independent chains, from 8-byte broadcast reads of
//    shared memory (a warp's 32 threads share one lane).  The 16 cluster
//    slab tests of a super are split over the lanes too.  The gates need
//    each ray's best t only at the start of each super and the any-hit
//    test only at its end, and the (t, index) minimum does not depend on
//    the order of evaluation, so the lanes keep private minima and meet
//    in shared memory once per processed super that admitted a cluster.
// 2. Copies did not overlap the evaluation.  Now both tables go through a
//    ring of RING bulk-copy buffers (traversal_common.cuh): as soon as a
//    super's cluster word is known, one thread issues the copies of its
//    first RING admitted clusters, and each buffer freed by an evaluation
//    takes the super's next admitted cluster.  The next super's clusters
//    depend on this super's results, so every copy a super issues is
//    waited within the super: none is in flight at the any-hit early-out
//    or when the block exits.
// 3. One block per SM and tiles of very different work: a long tile
//    started last held the end of the launch.  order, when given, maps
//    block b to tile order[b]; the streamed walk's wrapper passes its
//    tiles longest list first.
//
// COUNT (B2c): thread 0 counts the supers processed and the popcount of
// each processed super's cluster word, written to ctr[tile] at the end.
#include "traversal_common.cuh"

namespace {

using namespace srt;

constexpr int RING = 4;       // cluster buffers
constexpr int PAIRS = CLUSTER / 2;
constexpr int MAX_THREADS = 1024;

// Lexicographic (t, index) update of a lane's running minimum.
__device__ __forceinline__ void lex_take(float t, int i, float& bt, int& bi) {
  if (t < bt || (t == bt && i < bi)) {
    bt = t;
    bi = i;
  }
}

template <bool COUNT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    intersect_kernel(const int* __restrict__ counts,
                     const int* __restrict__ clist,
                     const float* __restrict__ elist, int list_w,
                     const float* __restrict__ rays8,
                     const float* __restrict__ cb,
                     const float* __restrict__ woop,
                     const int* __restrict__ order, int tile, int any_hit,
                     float* __restrict__ out_t, int* __restrict__ out_i,
                     int* __restrict__ ctr) {
  __shared__ __align__(128) float ring[RING * WOOP_ROWS * CLUSTER];
  __shared__ __align__(8) uint64_t bars[RING];
  __shared__ float red_t[MAX_THREADS];
  __shared__ int red_i[MAX_THREADS];
  __shared__ unsigned word_sh[2][32];  // per warp, by processed-super parity
  __shared__ float wmax_sh[32];
  const int tid = threadIdx.x;
  const int lanes = blockDim.x / tile;
  const int lane = tid / tile;
  const int rid = tid - lane * tile;
  const int warp = tid >> 5, n_warps = blockDim.x >> 5;
  const int tile_id = order ? order[blockIdx.x] : blockIdx.x;
  const size_t ray = (size_t)tile_id * tile + rid;
  const size_t row = (size_t)tile_id * list_w;
  const Ray r = load_ray(rays8, ray);
  const float ix = 1.f / r.dx, iy = 1.f / r.dy, iz = 1.f / r.dz;
  float bt = r.t_max;
  int bi = MISS_IDX;
  float tbm = BIG;
  bool done = false, gated = false;
  int parity = 0, next = 0;  // next: ring position of the next copy
  int n_super = 0, n_cluster = 0;
  const int cnt = counts[tile_id];
  Stage st = stage_init(ring, bars, RING);  // synchronises the block

  for (int j = 0; j < cnt && !done; ++j) {
    // Block-uniform gate: tbm and done come from block reductions.
    if (!(elist[row + j] < tbm)) continue;
    const int s = clist[row + j];
    const float* b = cb + (size_t)s * 8 * SUPER;
    unsigned mine = 0;
    for (int k = lane; k < SUPER; k += lanes) {
      float sel;
      if (slab<false>(b[k], b[SUPER + k], b[2 * SUPER + k], b[3 * SUPER + k],
                      b[4 * SUPER + k], b[5 * SUPER + k], r.ox, r.oy, r.oz,
                      ix, iy, iz, bt, &sel))
        mine |= 1u << k;
    }
    mine = __reduce_or_sync(FULL, mine);
    if ((tid & 31) == 0) word_sh[parity][warp] = mine;
    __syncthreads();
    unsigned word = 0;
    for (int w = 0; w < n_warps; ++w) word |= word_sh[parity][w];
    parity ^= 1;
    const int n = __popc(word);
    if (COUNT) {
      ++n_super;
      n_cluster += n;
    }
    // Nothing admitted: the best t, so the gates, are as the last
    // processed super left them.
    if (n == 0 && gated) continue;

    unsigned pend = word;  // thread 0: admitted clusters not yet issued
    if (tid == 0)
      for (int m = 0; m < n && m < RING; ++m) {
        stage_issue(st, (next + m) % RING, woop, s * SUPER + __ffs(pend) - 1);
        pend &= pend - 1;
      }
    unsigned rest = word;
    for (int m = 0; m < n; ++m) {
      const int c = s * SUPER + __ffs(rest) - 1;
      rest &= rest - 1;
      const int slot = (next + m) % RING;
      stage_wait(st, slot);
      const float* w = st.buffer(slot);
      const int base = c * CLUSTER;
      for (int v = lane; v < PAIRS; v += lanes) {
        float qa[WOOP_ROWS], qb[WOOP_ROWS];
#pragma unroll
        for (int k = 0; k < WOOP_ROWS; ++k) {
          const float2 q2 = reinterpret_cast<const float2*>(w + k * CLUSTER)[v];
          qa[k] = q2.x;
          qb[k] = q2.y;
        }
        float ta, tb;
        bool va = woop_test<false>(qa, r, &ta);
        bool vb = woop_test<false>(qb, r, &tb);
        if (any_hit) {
          va = va && (ta > r.t_lo);
          vb = vb && (tb > r.t_lo);
        }
        if (va) lex_take(ta, base + 2 * v, bt, bi);
        if (vb) lex_take(tb, base + 2 * v + 1, bt, bi);
      }
      __syncthreads();  // the buffer is free again
      if (tid == 0 && pend) {
        stage_issue(st, slot, woop, s * SUPER + __ffs(pend) - 1);
        pend &= pend - 1;
      }
    }
    next = (next + n) % RING;

    // The lanes of a ray meet: every lane takes the ray's minimum.
    if (lanes > 1 && n > 0) {
      red_t[tid] = bt;
      red_i[tid] = bi;
      __syncthreads();
      for (int l = 0; l < lanes; ++l)
        lex_take(red_t[rid + l * tile], red_i[rid + l * tile], bt, bi);
    }
    // Tighten the gates: block max of the per-ray best t.
    float mx = bt;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    if ((tid & 31) == 0) wmax_sh[warp] = mx;
    if (any_hit) {
      // Resolved: some hit inside t_max, or dead (t_max <= 0).
      done = __syncthreads_and((bt < r.t_max) || (r.t_max <= 0.f)) != 0;
    } else {
      __syncthreads();
    }
    tbm = wmax_sh[0];
    for (int w = 1; w < n_warps; ++w) tbm = fmaxf(tbm, wmax_sh[w]);
    gated = true;
  }
  if (lane == 0) {
    out_t[ray] = bt;
    out_i[ray] = (bt < r.t_max) ? bi : -1;
  }
  if (COUNT && tid == 0) {
    ctr[2 * tile_id] = n_super;
    ctr[2 * tile_id + 1] = n_cluster;
  }
}

template <bool COUNT>
int launch(const int* counts, const int* clist, const float* elist,
           int list_w, const float* rays8, const float* cb, const float* woop,
           const int* order, int n_tiles, int tile, int threads, int any_hit,
           float* out_t, int* out_i, int* ctr, void* stream) {
  if (tile < 32 || tile % 32 || threads % tile || threads > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0)
    intersect_kernel<COUNT><<<n_tiles, threads, 0, (cudaStream_t)stream>>>(
        counts, clist, elist, list_w, rays8, cb, woop, order, tile, any_hit,
        out_t, out_i, ctr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int srt_intersect(const int* counts, const int* clist,
                             const float* elist, int list_w,
                             const float* rays8, const float* cb,
                             const float* woop, const int* order,
                             int n_tiles, int tile, int threads, int any_hit,
                             float* out_t, int* out_i, void* stream) {
  return launch<false>(counts, clist, elist, list_w, rays8, cb, woop, order,
                       n_tiles, tile, threads, any_hit, out_t, out_i, nullptr,
                       stream);
}

extern "C" int srt_intersect_stream(const int* counts, const int* clist,
                                    const float* elist, int list_w,
                                    const float* rays8, const float* cb,
                                    const float* woop, const int* order,
                                    int n_tiles, int tile, int threads,
                                    int any_hit, float* out_t, int* out_i,
                                    void* stream) {
  return launch<false>(counts, clist, elist, list_w, rays8, cb, woop, order,
                       n_tiles, tile, threads, any_hit, out_t, out_i, nullptr,
                       stream);
}

extern "C" int srt_intersect_count(const int* counts, const int* clist,
                                   const float* elist, int list_w,
                                   const float* rays8, const float* cb,
                                   const float* woop, const int* order,
                                   int n_tiles, int tile, int threads,
                                   int any_hit, float* out_t, int* out_i,
                                   int* ctr, void* stream) {
  return launch<true>(counts, clist, elist, list_w, rays8, cb, woop, order,
                      n_tiles, tile, threads, any_hit, out_t, out_i, ctr,
                      stream);
}
