// B4: per-group walk.  Replaces _pgwalk2_kernel (srt_tpu/ops/
// traversal_pallas.py:697, launched by _launch_pgwalk2) in its resident
// (B4) and stream=True (B4s) modes, as template<STREAM>.
//
// Per group of G rays: walk the group's list of (super, 16-bit cluster
// word) entries in order and, for every set bit (lowest first), evaluate
// that cluster's 128 triangles against each ray of the group.  Strict
// t < merge in ascending index order, starting from min(t_max, BIG): the
// winner is the smallest index among the nearest valid candidates, as on
// the TPU.  Groups with an empty list write min(t_max, BIG) and -1.  The
// TPU's W-wide unrolled evaluation (an ILP knob) does not change the
// result and has no counterpart.
//
// What bounds it: ~24 FMA-equivalents and one division per (ray,
// triangle) over the group's union footprint, in a latency-bound loop.
// Design: one block per group, one thread per ray; the block walks one
// list, so control flow is uniform and each cluster's 13x128 Woop rows
// are staged once in shared memory and read as broadcasts.  Small groups
// (G = 16, 32) give small blocks; packing several groups per block is
// later tuning work.
//
// STREAM (B4s): the TPU double-buffers whole supers (128 KB each) per
// list entry; here the stage is per listed cluster (6,656 bytes, a 1-D
// bulk copy on an mbarrier, traversal_common.cuh).  The group's whole
// (super, word) list is known before the walk, so the pipeline runs
// across list entries: cluster i+1's copy is issued by thread 0 while
// cluster i is evaluated, and the walk ends only after waiting the last
// issued copy, so no copy is in flight when the block exits.  One thread
// issues each copy, so blocks of 32 (or fewer) threads work unchanged.
#include "traversal_common.cuh"

namespace {

using namespace srt;

// The group's next listed cluster after cursor (j, rest): -1 when the
// list is exhausted.  Every thread runs it on the same data.
__device__ __forceinline__ int next_cluster(const int* __restrict__ clist,
                                            const int* __restrict__ bits,
                                            size_t row, int cnt, int& j,
                                            unsigned& rest) {
  while (rest == 0) {
    if (++j >= cnt) return -1;
    rest = (unsigned)bits[row + j];
  }
  const int k = __ffs(rest) - 1;
  rest &= rest - 1;
  return clist[row + j] * SUPER + k;
}

template <bool STREAM>
__global__ void pgwalk2_kernel(const int* __restrict__ clist,
                               const int* __restrict__ bits,
                               const int* __restrict__ counts, int list_w,
                               const float* __restrict__ rays8,
                               const float* __restrict__ woop, int group,
                               int any_hit, float* __restrict__ out_t,
                               int* __restrict__ out_i) {
  __shared__ __align__(128) float w_sh[(STREAM ? 2 : 1) * WOOP_ROWS * CLUSTER];
  __shared__ __align__(8) uint64_t bars[2];
  const size_t g = blockIdx.x;
  const size_t ray = g * group + threadIdx.x;
  const Ray r = load_ray(rays8, ray);
  const float t_cap = nmin(r.t_max, BIG);
  float bt = t_cap;
  int bi = MISS_IDX;
  const int cnt = counts[g];
  const size_t row = g * list_w;
  int j = -1;
  unsigned rest = 0;
  int c = next_cluster(clist, bits, row, cnt, j, rest);
  Stage st;
  if (STREAM) {
    st = stage_init(w_sh, bars);
    if (c >= 0 && threadIdx.x == 0) stage_issue(st, 0, woop, c);
  }
  int slot = 0;
  while (c >= 0) {
    const int c_next = next_cluster(clist, bits, row, cnt, j, rest);
    const float* w;
    if (STREAM) {
      if (c_next >= 0 && threadIdx.x == 0)
        stage_issue(st, slot ^ 1, woop, c_next);
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
      bool valid = woop_eval<true>(w, l, r, &t);
      if (any_hit) valid = valid && (t > r.t_lo);
      if (valid && t < bt) {
        bt = t;
        bi = base + l;
      }
    }
    __syncthreads();  // the buffer is free again
    slot ^= 1;
    c = c_next;
  }
  out_t[ray] = bt;
  out_i[ray] = (bt < t_cap) ? bi : -1;
}

template <bool STREAM>
int launch(const int* clist, const int* bits, const int* counts, int list_w,
           const float* rays8, const float* woop, int n_groups, int group,
           int any_hit, float* out_t, int* out_i, void* stream) {
  if (n_groups > 0)
    pgwalk2_kernel<STREAM><<<n_groups, group, 0, (cudaStream_t)stream>>>(
        clist, bits, counts, list_w, rays8, woop, group, any_hit, out_t,
        out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int srt_pgwalk2(const int* clist, const int* bits,
                           const int* counts, int list_w, const float* rays8,
                           const float* woop, int n_groups, int group,
                           int any_hit, float* out_t, int* out_i,
                           void* stream) {
  return launch<false>(clist, bits, counts, list_w, rays8, woop, n_groups,
                       group, any_hit, out_t, out_i, stream);
}

extern "C" int srt_pgwalk2_stream(const int* clist, const int* bits,
                                  const int* counts, int list_w,
                                  const float* rays8, const float* woop,
                                  int n_groups, int group, int any_hit,
                                  float* out_t, int* out_i, void* stream) {
  return launch<true>(clist, bits, counts, list_w, rays8, woop, n_groups,
                      group, any_hit, out_t, out_i, stream);
}
