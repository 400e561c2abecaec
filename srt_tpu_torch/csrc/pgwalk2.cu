// B4: per-group walk.  Replaces _pgwalk2_kernel in resident mode
// (srt_tpu/ops/traversal_pallas.py:697, launched by _launch_pgwalk2).
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
#include "traversal_common.cuh"

namespace {

using namespace srt;

__global__ void pgwalk2_kernel(const int* __restrict__ clist,
                               const int* __restrict__ bits,
                               const int* __restrict__ counts, int list_w,
                               const float* __restrict__ rays8,
                               const float* __restrict__ woop, int group,
                               int any_hit, float* __restrict__ out_t,
                               int* __restrict__ out_i) {
  __shared__ float w_sh[WOOP_ROWS * CLUSTER];
  const size_t g = blockIdx.x;
  const size_t ray = g * group + threadIdx.x;
  const Ray r = load_ray(rays8, ray);
  const float t_cap = nmin(r.t_max, BIG);
  float bt = t_cap;
  int bi = MISS_IDX;
  const int cnt = counts[g];
  for (int j = 0; j < cnt; ++j) {
    const int s = clist[g * list_w + j];
    unsigned word = (unsigned)bits[g * list_w + j];
    while (word) {
      const int k = __ffs(word) - 1;
      word &= word - 1;
      const int c = s * SUPER + k;
      __syncthreads();  // the previous cluster's evaluation is done
      stage_cluster(w_sh, woop, c);
      __syncthreads();
      const int base = c * CLUSTER;
      for (int l = 0; l < CLUSTER; ++l) {
        float t;
        bool valid = woop_eval<true>(w_sh, l, r, &t);
        if (any_hit) valid = valid && (t > r.t_lo);
        if (valid && t < bt) {
          bt = t;
          bi = base + l;
        }
      }
    }
  }
  out_t[ray] = bt;
  out_i[ray] = (bt < t_cap) ? bi : -1;
}

}  // namespace

extern "C" int srt_pgwalk2(const int* clist, const int* bits,
                           const int* counts, int list_w, const float* rays8,
                           const float* woop, int n_groups, int group,
                           int any_hit, float* out_t, int* out_i,
                           void* stream) {
  if (n_groups > 0)
    pgwalk2_kernel<<<n_groups, group, 0, (cudaStream_t)stream>>>(
        clist, bits, counts, list_w, rays8, woop, group, any_hit, out_t,
        out_i);
  return (int)cudaGetLastError();
}
