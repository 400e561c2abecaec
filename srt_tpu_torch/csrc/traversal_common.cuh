// Shared device code of the walk kernels (cull.cu, intersect.cu,
// cull_pg2.cu, pgwalk2.cu, cull_perray.cu, cull_gmask.cu, pgwalk.cu):
// constants, NaN-propagating min/max, the slab test and the culls' super
// pre-test, the group culls' ray staging, the Woop unit-triangle
// evaluation, the walks' bulk-copy stage and the split walks' key merge.
// The arithmetic matches the plain PyTorch versions in
// srt_tpu_torch/ops/traversal.py operation for operation; the library is
// built with -fmad=false, so every multiply and add rounds separately on
// both sides and candidate t agrees bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace srt {

// Double constants rounded once to float, as the JAX package's Python
// float constants are when they meet a float32 array.
constexpr float BIG = (float)3.0e37;
constexpr float EDGE_EPS = (float)1e-4;
constexpr float EDGE_HI = (float)(1.0 + 2 * 1e-4);
constexpr float T_EPS = (float)1e-5;
constexpr int CLUSTER = 128;
constexpr int SUPER = 16;
constexpr int WOOP_ROWS = 13;        // rows used of the [C, 16, 128] table
constexpr int WOOP_STRIDE = 16 * 128;
constexpr int MISS_IDX = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;

// Parity trap 1 (NaN): jnp.minimum/maximum propagate NaN, CUDA fminf/fmaxf
// return the other operand.  NaN boxes pad the cluster tables and 0*inf
// kills on-boundary axis-parallel rays only if NaN fails every compare.
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
// The same in one instruction each (PTX min.NaN / max.NaN, sm_80 and
// later, where the selects above take three), for values that meet only
// compares or nmax(x, 0): the two forms differ at most in the sign of a
// zero result, which neither can see.
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, t_max, t_lo;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays8,
                                        size_t i) {
  const float4 a = reinterpret_cast<const float4*>(rays8)[2 * i];
  const float4 b = reinterpret_cast<const float4*>(rays8)[2 * i + 1];
  return Ray{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

// The slab interval [t_near, t_far] of a box (NaN-propagating; its users
// only compare the ends and take nmax(t_near, 0)).  FMA_FORM
// is the pg2 cull's box*inv - o*inv, with (px, py, pz) = o*inv; otherwise
// (box - o)*inv with (px, py, pz) = o.
template <bool FMA_FORM>
__device__ __forceinline__ void slab_span(float lx, float ly, float lz,
                                          float hx, float hy, float hz,
                                          float px, float py, float pz,
                                          float ix, float iy, float iz,
                                          float* t_near, float* t_far) {
  float t0x, t1x, t0y, t1y, t0z, t1z;
  if (FMA_FORM) {
    t0x = lx * ix - px; t1x = hx * ix - px;
    t0y = ly * iy - py; t1y = hy * iy - py;
    t0z = lz * iz - pz; t1z = hz * iz - pz;
  } else {
    t0x = (lx - px) * ix; t1x = (hx - px) * ix;
    t0y = (ly - py) * iy; t1y = (hy - py) * iy;
    t0z = (lz - pz) * iz; t1z = (hz - pz) * iz;
  }
  *t_near = max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)),
                    min_nan(t0z, t1z));
  *t_far = min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)),
                   max_nan(t0z, t1z));
}

// The group culls' (B5, B6) ray staging: lanes l < n of the warp load ray
// first + l into rs[2l], rs[2l + 1] as (origin, t_max) and the IEEE
// reciprocals (0 in w).  Returns the warp's ballot of live rays (t_max >
// 0), bit l for ray first + l; the warp's lanes may read rs on return.
__device__ __forceinline__ unsigned stage_group_rays(
    const float* __restrict__ rays8, size_t first, int n, float4* rs) {
  const int lane = threadIdx.x & 31;
  bool live = false;
  if (lane < n) {
    const Ray r = load_ray(rays8, first + lane);
    live = r.t_max > 0.f;
    rs[2 * lane] = make_float4(r.ox, r.oy, r.oz, r.t_max);
    rs[2 * lane + 1] = make_float4(1.f / r.dx, 1.f / r.dy, 1.f / r.dz, 0.f);
  }
  const unsigned ballot = __ballot_sync(FULL, live);
  __syncwarp();
  return ballot;
}

// Slab test, entry bound max(t_near, 0) (not exit-if-inside: a box entered
// from inside can still hold candidates nearer than its exit).  *sel is +0
// or positive when the test passes (nmax(-0, +0) returns +0).  The plain
// versions' t_near <= t_far && t_far >= 0 && sel < bound, in two compares:
// sel <= t_far holds exactly when both of the first two do, and a NaN end
// fails both forms.
template <bool FMA_FORM>
__device__ __forceinline__ bool slab(float lx, float ly, float lz, float hx,
                                     float hy, float hz, float px, float py,
                                     float pz, float ix, float iy, float iz,
                                     float bound, float* sel) {
  float t_near, t_far;
  slab_span<FMA_FORM>(lx, ly, lz, hx, hy, hz, px, py, pz, ix, iy, iz,
                      &t_near, &t_far);
  *sel = nmax(t_near, 0.f);
  return (*sel <= t_far) && (*sel < bound);
}

// The two-level culls' super pre-test (B3 in the FMA form, B6 in the
// (box - o) * inv form): false only when the ray enters none of the
// super's clusters before t_max.  A NaN end counts as entering: it arises
// only where some cluster shares the super's bound (see the culls'
// headers for why the test is exact).  (px, py, pz) as in slab_span.
template <bool FMA_FORM>
__device__ __forceinline__ bool may_enter(const float4& a, const float4& b,
                                          float px, float py, float pz,
                                          float ix, float iy, float iz,
                                          float t_max) {
  float tn, tf;
  slab_span<FMA_FORM>(a.x, a.y, a.z, a.w, b.x, b.y, px, py, pz, ix, iy, iz,
                      &tn, &tf);
  const float sel = nmax(tn, 0.f);
  return (tn != tn) || (tf != tf) || ((sel <= tf) && (sel < t_max));
}

// Woop unit-triangle test of one triangle's 13 rows q.  NESTED folds the
// affine rows right to left (the per-group walk's order), else left to
// right (the tiled walk's).  About 24 multiply-adds per (ray, triangle)
// plus one division.
template <bool NESTED>
__device__ __forceinline__ bool woop_test(const float (&q)[WOOP_ROWS],
                                          const Ray& r, float* t_out) {
  float zo, zd, xo, xd, yo, yd;
  if (NESTED) {
    zo = r.ox * q[8] + (r.oy * q[9] + (r.oz * q[10] + q[11]));
    zd = r.dx * q[8] + (r.dy * q[9] + r.dz * q[10]);
    xo = r.ox * q[0] + (r.oy * q[1] + (r.oz * q[2] + q[3]));
    xd = r.dx * q[0] + (r.dy * q[1] + r.dz * q[2]);
    yo = r.ox * q[4] + (r.oy * q[5] + (r.oz * q[6] + q[7]));
    yd = r.dx * q[4] + (r.dy * q[5] + r.dz * q[6]);
  } else {
    zo = r.ox * q[8] + r.oy * q[9] + r.oz * q[10] + q[11];
    zd = r.dx * q[8] + r.dy * q[9] + r.dz * q[10];
    xo = r.ox * q[0] + r.oy * q[1] + r.oz * q[2] + q[3];
    xd = r.dx * q[0] + r.dy * q[1] + r.dz * q[2];
    yo = r.ox * q[4] + r.oy * q[5] + r.oz * q[6] + q[7];
    yd = r.dx * q[4] + r.dy * q[5] + r.dz * q[6];
  }
  const bool parallel = fabsf(zd) <= q[12];
  const float den = parallel ? 1.f : zd;
  // Parity trap 2 (reciprocal): exact IEEE 1/den, then the TPU kernel's
  // Newton step in its operation order.
  float inv = 1.f / den;
  inv = inv * (2.f - den * inv);
  const float t = -zo * inv;
  const float u = xo + t * xd;
  const float v = yo + t * yd;
  const float m = min_nan(min_nan(u, v), (EDGE_HI - u) - v);
  *t_out = t;
  return (m >= -EDGE_EPS) && !parallel && (t > T_EPS);
}

// woop_test of lane l of a cluster's [13][128] rows (staged in shared
// memory, or the table in global memory).
template <bool NESTED>
__device__ __forceinline__ bool woop_eval(const float* __restrict__ w, int l,
                                          const Ray& r, float* t_out) {
  float q[WOOP_ROWS];
#pragma unroll
  for (int k = 0; k < WOOP_ROWS; ++k) q[k] = w[k * CLUSTER + l];
  return woop_test<NESTED>(q, r, t_out);
}

// The walks' bulk-copy stage (B2/B2s, B4/B4s and B7: a ring): shared-
// memory buffers of one cluster's 13 used Woop rows (13 x 128 x 4 = 6,656
// bytes, contiguous and 16-byte aligned in the table), each filled by one
// 1-D bulk copy (cp.async.bulk, the Hopper form of pltpu.make_async_copy)
// issued by one thread and completed on that buffer's mbarrier.  Every
// thread tracks the barriers' phase bits; control flow around the stage
// is block-uniform, so the bits agree across the block.
constexpr unsigned STAGE_BYTES = WOOP_ROWS * CLUSTER * sizeof(float);

struct Stage {
  float* buf;      // n buffers of WOOP_ROWS * CLUSTER floats, back to back
  unsigned bar;    // shared address of buffer 0's mbarrier; buffer s's at +8s
  unsigned phase;  // bit s: parity of buffer s's next completion
  __device__ __forceinline__ float* buffer(int s) const {
    return buf + s * (WOOP_ROWS * CLUSTER);
  }
};

// Thread 0 initialises n <= 32 barriers (one arrival each: the issuing
// thread's arrive); the block synchronises before first use.  buf:
// 16-byte aligned shared memory for n buffers; bars: n uint64.
__device__ __forceinline__ Stage stage_init(float* buf, uint64_t* bars,
                                            unsigned n = 2) {
  Stage st;
  st.buf = buf;
  st.bar = (unsigned)__cvta_generic_to_shared(bars);
  st.phase = 0;
  if (threadIdx.x == 0) {
    for (unsigned s = 0; s < n; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       st.bar + 8u * s),
                   "r"(1u)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return st;
}

// One thread only: start the copy of cluster c into buffer s.  The caller
// guarantees every thread has finished reading buffer s (a __syncthreads
// after its last evaluation) and that no copy into s is in flight.  The
// arrive releases the thread's earlier shared-memory writes to the
// threads that wait on buffer s.
__device__ __forceinline__ void stage_issue(const Stage& st, int s,
                                            const float* __restrict__ woop,
                                            int c) {
  const float* src = woop + (size_t)c * WOOP_STRIDE;
  const unsigned dst = (unsigned)__cvta_generic_to_shared(st.buffer(s));
  const unsigned bar = st.bar + 8u * s;
  // Order the block's earlier generic-proxy reads of the buffer before
  // the async-proxy write.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(STAGE_BYTES)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(STAGE_BYTES), "r"(bar)
      : "memory");
}

// One thread only: complete buffer s's phase with no copy (an end marker
// for the threads that wait on it), releasing the thread's earlier
// shared-memory writes to them.
__device__ __forceinline__ void stage_arrive(const Stage& st, int s) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(st.bar +
                                                               8u * s)
               : "memory");
}

// Every thread: wait until buffer s's phase has completed.
__device__ __forceinline__ void stage_wait(Stage& st, int s) {
  const unsigned parity = (st.phase >> s) & 1u;
  const unsigned bar = st.bar + 8u * s;
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
  st.phase ^= 1u << s;
}

// The split walks' per-ray keys (B4/B4s, B7): (t bits << 32) | index.  A
// candidate has t > T_EPS > 0, and float bits of non-negative floats order
// as the floats do, so the minimum key is the lexicographic minimum of
// (t, index); NO_KEY means no candidate.
constexpr uint64_t NO_KEY = ~0ull;

__device__ __forceinline__ uint64_t hit_key(float t, int i) {
  return ((uint64_t)__float_as_uint(t) << 32) | (unsigned)i;
}

// One ray of the split walks' merge: the minimum key over the P slices
// of keys [P, n_rays], decoded; no key gives t_max (min(t_max, BIG) with
// CAP) and -1.  Each walk's merge kernel calls it once per ray.
template <bool CAP>
__device__ __forceinline__ void merge_keys(const uint64_t* __restrict__ keys,
                                           int parts, size_t n_rays,
                                           const float* __restrict__ rays8,
                                           float* __restrict__ out_t,
                                           int* __restrict__ out_i,
                                           size_t ray) {
  uint64_t key = NO_KEY;
  for (int p = 0; p < parts; ++p) {
    const uint64_t k = keys[p * n_rays + ray];
    if (k < key) key = k;
  }
  if (key == NO_KEY) {
    const float t_max = rays8[8 * ray + 6];
    out_t[ray] = CAP ? nmin(t_max, BIG) : t_max;
    out_i[ray] = -1;
  } else {
    out_t[ray] = __uint_as_float((unsigned)(key >> 32));
    out_i[ray] = (int)(key & 0xffffffffu);
  }
}

}  // namespace srt
