// B4 and B4s: the per-group walk.  Replaces _pgwalk2_kernel (srt_tpu/ops/
// traversal_pallas.py:697, launched by _launch_pgwalk2 at :888) in its
// resident (B4) and stream=True (B4s) modes; both entry points run the
// same kernel, and differ only in the table they are given (B4s's is
// padded to whole supers, which the TPU's per-super copies need).
//
// Per group of G rays: every cluster of the group's list of (super,
// 16-bit cluster word) entries is evaluated against every ray of the
// group, and each ray keeps the lexicographic minimum of (t, triangle
// index) over the valid candidates with t < min(t_max, BIG); a ray
// without one writes min(t_max, BIG) and -1.  That minimum does not
// depend on the order of evaluation, so the work of a group may be split
// any way; the TPU's W-wide unrolled evaluation (an ILP knob) has no
// counterpart.
//
// What bounds it: 46 FMA-pipe instructions (a Woop evaluation in the
// SASS, FMA-bound; chip_smoke.py phase 2) per (ray, triangle) over
// the group's listed clusters; each cluster's 13 Woop rows (6,656 bytes)
// are read once per group.  What held the first
// design (one block of G threads per group, each thread all 128
// triangles of every cluster in series) back, and what this one does:
//
// 1. Too few threads, too long a chain: a G = 32 block was one warp, one
//    serial 128-triangle chain per thread.  Now a group's block has
//    T = min(1024, max(4G, 128)) threads (at most 64 per ray); thread t
//    takes ray t mod G and every L-th pair of triangles (L = T / G), two
//    independent chains per step from one 8-byte shared-memory read per
//    row.  A warp holds 32 consecutive rays at one pair (G >= 32), so
//    each read is a broadcast.  Lanes keep their own minimum; the block
//    combines a ray's L lanes in shared memory.
// 2. Few groups leave the card idle: a launch of a handful of groups with
//    long lists (the deep bounces' batches, 3 live groups of 32 rays) ran
//    on a handful of SMs.  Now the wrapper splits each group's list over
//    P blocks (chosen from the group count alone, no read of the counts
//    on the host); block p walks the listed clusters p, p + P, ... and
//    writes each ray's key (t bits << 32 | index; a candidate has
//    t > T_EPS > 0, so the key orders as (t, index) does) to its own
//    slice of a [P, Np] scratch, and pgwalk2_merge takes the minimum key
//    per ray.  Each slice is written whole, so no init pass is needed.
// 3. Copies did not overlap the evaluation: the resident walk staged each
//    cluster with a cooperative copy between two barriers, the streamed
//    one kept one copy ahead.  Now both walk a ring of RING buffers: one
//    thread issues each cluster's 1-D bulk copy (traversal_common.cuh)
//    RING - 1 clusters ahead and publishes its id beside it; an end
//    marker (a plain arrive) closes the walk, so every issued copy has
//    been waited when the block leaves the loop, and no copy is in
//    flight when the block exits.  The group's list is staged in shared
//    memory first, so the issuing thread scans it without global loads.
#include "traversal_common.cuh"

namespace {

using namespace srt;

constexpr int RING = 3;        // cluster buffers: copies RING - 1 ahead
constexpr int LIST_SH = 256;   // list entries staged in shared memory
constexpr int PAIRS = CLUSTER / 2;

// The issuing thread's cursor over the group's listed clusters, in list
// order; it yields list positions target, target + parts, ...
struct Cursor {
  int j;          // current entry
  unsigned rest;  // its set bits not yet passed
  int k;          // list position of rest's lowest bit
  int target;     // next list position to yield
  int super_id;   // current entry's super
};

__device__ __forceinline__ int next_cluster(Cursor& cu, const int* l_sup,
                                            const int* l_word,
                                            const int* __restrict__ clist,
                                            const int* __restrict__ bits,
                                            size_t row, int cnt, int parts) {
  for (;;) {
    const int n = __popc(cu.rest);
    if (cu.k + n > cu.target) break;
    cu.k += n;
    if (++cu.j >= cnt) return -1;
    const bool sh = cu.j < LIST_SH;
    cu.rest = (unsigned)(sh ? l_word[cu.j] : bits[row + cu.j]);
    cu.super_id = sh ? l_sup[cu.j] : clist[row + cu.j];
  }
  unsigned w = cu.rest;
  for (int d = cu.target - cu.k; d > 0; --d) w &= w - 1;
  const int b = __ffs(w) - 1;
  cu.rest = w & (w - 1);
  cu.k = cu.target + 1;
  cu.target += parts;
  return cu.super_id * SUPER + b;
}

__global__ void __launch_bounds__(1024)
    pgwalk2_kernel(const int* __restrict__ clist, const int* __restrict__ bits,
                   const int* __restrict__ counts, int list_w,
                   const float* __restrict__ rays8,
                   const float* __restrict__ woop, int group, int parts,
                   int any_hit, float* __restrict__ out_t,
                   int* __restrict__ out_i, uint64_t* __restrict__ keys) {
  __shared__ __align__(128) float ring[RING * WOOP_ROWS * CLUSTER];
  __shared__ __align__(8) uint64_t bars[RING];
  __shared__ int cid[RING];
  __shared__ int l_sup[LIST_SH], l_word[LIST_SH];
  const int tid = threadIdx.x;
  const int lanes = blockDim.x / group;
  const int lane = tid / group;
  const size_t g = blockIdx.x / parts;
  const int p = blockIdx.x % parts;
  const size_t ray = g * group + tid % group;
  const Ray r = load_ray(rays8, ray);
  const float t_cap = nmin(r.t_max, BIG);
  const int cnt = counts[g];
  const size_t row = g * list_w;
  for (int e = tid; e < min(cnt, LIST_SH); e += blockDim.x) {
    l_sup[e] = clist[row + e];
    l_word[e] = bits[row + e];
  }
  Stage st = stage_init(ring, bars, RING);  // synchronises the block

  // Thread 0 fills slot s with the next cluster (or the end marker).
  Cursor cu{-1, 0u, 0, p, 0};
  bool ended = false;
  auto produce = [&](int s) {
    const int c = next_cluster(cu, l_sup, l_word, clist, bits, row, cnt,
                               parts);
    cid[s] = c;
    if (c >= 0) {
      stage_issue(st, s, woop, c);
    } else {
      stage_arrive(st, s);
      ended = true;
    }
  };
  if (tid == 0)
    for (int s = 0; s < RING - 1 && !ended; ++s) produce(s);

  float bt = t_cap;
  int bi = MISS_IDX;
  for (int i = 0;; ++i) {
    const int slot = i % RING;
    if (tid == 0 && !ended) produce((i + RING - 1) % RING);
    stage_wait(st, slot);
    const int c = cid[slot];
    if (c < 0) break;  // block-uniform: every thread read the end marker
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
      bool va = woop_test<true>(qa, r, &ta);
      bool vb = woop_test<true>(qb, r, &tb);
      if (any_hit) {
        va = va && (ta > r.t_lo);
        vb = vb && (tb > r.t_lo);
      }
      // Ascending index with a strict t <: the lane's lexicographic min.
      if (va && ta < bt) {
        bt = ta;
        bi = base + 2 * v;
      }
      if (vb && tb < bt) {
        bt = tb;
        bi = base + 2 * v + 1;
      }
    }
    __syncthreads();  // the buffer is free again
  }

  // Lanes of a ray: lexicographic min in shared memory.  No copy is in
  // flight and every thread has passed its last read of the ring.
  if (lanes > 1) {
    float* red_t = ring;
    int* red_i = reinterpret_cast<int*>(ring + blockDim.x);
    red_t[tid] = bt;
    red_i[tid] = bi;
    __syncthreads();
    if (tid < group) {
      for (int l = 1; l < lanes; ++l) {
        const float ot = red_t[tid + l * group];
        const int oi = red_i[tid + l * group];
        if (ot < bt || (ot == bt && oi < bi)) {
          bt = ot;
          bi = oi;
        }
      }
    }
  }
  if (tid < group) {
    const bool hit = bt < t_cap;
    if (parts == 1) {
      out_t[ray] = bt;
      out_i[ray] = hit ? bi : -1;
    } else {
      const size_t n_rays = (size_t)(gridDim.x / parts) * group;
      keys[p * n_rays + ray] = hit ? hit_key(bt, bi) : NO_KEY;
    }
  }
}

// Per ray: the minimum key over the P slices (merge_keys, no key gives
// min(t_max, BIG) and -1).
__global__ void pgwalk2_merge(const uint64_t* __restrict__ keys, int parts,
                              size_t n_rays, const float* __restrict__ rays8,
                              float* __restrict__ out_t,
                              int* __restrict__ out_i) {
  const size_t ray = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (ray < n_rays) merge_keys<true>(keys, parts, n_rays, rays8, out_t, out_i,
                                     ray);
}

int launch(const int* clist, const int* bits, const int* counts, int list_w,
           const float* rays8, const float* woop, int n_groups, int group,
           int threads, int parts, uint64_t* keys, int any_hit, float* out_t,
           int* out_i, void* stream) {
  if (n_groups <= 0) return 0;
  if (threads % group || threads / group > PAIRS || threads > 1024 ||
      parts < 1 || (parts > 1 && !keys))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  pgwalk2_kernel<<<(unsigned)n_groups * parts, threads, 0, s>>>(
      clist, bits, counts, list_w, rays8, woop, group, parts, any_hit, out_t,
      out_i, keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return (int)err;
  const size_t n_rays = (size_t)n_groups * group;
  pgwalk2_merge<<<(unsigned)((n_rays + 255) / 256), 256, 0, s>>>(
      keys, parts, n_rays, rays8, out_t, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int srt_pgwalk2(const int* clist, const int* bits,
                           const int* counts, int list_w, const float* rays8,
                           const float* woop, int n_groups, int group,
                           int threads, int parts, uint64_t* keys,
                           int any_hit, float* out_t, int* out_i,
                           void* stream) {
  return launch(clist, bits, counts, list_w, rays8, woop, n_groups, group,
                threads, parts, keys, any_hit, out_t, out_i, stream);
}

extern "C" int srt_pgwalk2_stream(const int* clist, const int* bits,
                                  const int* counts, int list_w,
                                  const float* rays8, const float* woop,
                                  int n_groups, int group, int threads,
                                  int parts, uint64_t* keys, int any_hit,
                                  float* out_t, int* out_i, void* stream) {
  return launch(clist, bits, counts, list_w, rays8, woop, n_groups, group,
                threads, parts, keys, any_hit, out_t, out_i, stream);
}
