// B7: the mask-scan walk.  Replaces _pgwalk_kernel
// (srt_tpu/ops/traversal_pallas.py:937, launched by _launch_pgwalk).
//
// Per group of 8 rays: scan the group's S cluster words (cull_gmask.cu)
// and evaluate every cluster whose bit is set against the group's rays.
// Three things differ from B4 (pgwalk2.cu), and each changes bits of the
// output: the Woop affine rows fold left to right (B2's order); the best
// t starts at t_max itself, with no BIG cap, so a miss returns t_max; and
// there is no list.  Any-hit adds t > t_lo and does not end early.  The
// result is the lexicographic min of (t, triangle index) over the valid
// candidates with t < t_max, which does not depend on the order of
// evaluation, so the work may be split any way.
//
// What bounds it: 46 FMA-pipe instructions (FADD, FMUL and the
// division's FFMA in the SASS, FMA-bound; chip_smoke.py phase 2) per
// (ray, triangle) over the group's set clusters.  What held the first design (one warp per
// group, every set cluster of its mask one serial chain per lane, Woop
// rows read from global memory through L1 by each group alone) back, and
// what this one does:
//
// 1. Launches of a few live groups (the deep bounces: 41 to 91 live rays)
//    ran on a handful of warps, one long chain each.  Now the work is
//    split on the device, with no read on the host: pgwalk_count ORs the
//    words of each tile of K consecutive groups and counts the tile's
//    clusters; pgwalk_plan (one block) picks a chunk size so that the
//    launch has about `target` work items of at most `chunk` clusters
//    (at least min_chunk) and scans the items per tile; a persistent grid
//    of blocks then takes items from a counter in device memory.  An item
//    is (tile, chunk of the tile's clusters in ascending order); its block
//    writes each ray's best key (traversal_common.cuh) with a 64-bit
//    atomicMin (a plain store when the item is its tile's only one), and
//    pgwalk_merge decodes the keys (no key: t_max and -1).  The four kernels
//    run in one C call.
// 2. Each group read a cluster's 13 Woop rows (6,656 bytes) alone, for 8
//    rays.  Now a block takes a tile of K neighbouring groups (the pg
//    frame's rays are Morton- and bounce-sorted, so neighbours share most
//    of their footprint), walks the clusters of the OR of their words and
//    stages each once through a ring of RING bulk copies; only the warps
//    of groups whose own bit is set evaluate it, so each ray's candidate
//    set, and its result, is exactly the plain version's.
// 3. One chain per lane.  Now a group has `lanes` lanes per ray (lanes / 4
//    warps: a warp is one group's 8 rays times 4 lanes, so the own-bit
//    test is warp-uniform), and each lane evaluates every lanes-th pair of
//    triangles as two independent chains from 8-byte shared-memory reads
//    (four addresses a warp, no bank conflict).  A lane visits ascending
//    indices with a strict t <, so its (t, index) minimum is exact; the
//    lanes of a ray meet by shuffle, the warps of a group in shared memory.
#include "traversal_common.cuh"

namespace {

using namespace srt;

constexpr int GROUP = 8;
constexpr int RING = 3;             // cluster buffers: copies RING - 1 ahead
constexpr int PAIRS = CLUSTER / 2;
constexpr int MAX_TILE_RAYS = 128;  // K * GROUP
constexpr int PLAN_THREADS = 1024;
// work[]: [0] item counter, [1] chunk, [2] items; then cnt[n_tiles] and
// offs[n_tiles + 1] (first item of each tile; offs[n_tiles] = items).
constexpr int CTL = 4;

// One warp per tile of K groups: the popcount of the OR of their words,
// and the tile's rays' keys set to NO_KEY.
__global__ void pgwalk_count(const int* __restrict__ mask, int S,
                             int n_groups, int K, int n_tiles,
                             int* __restrict__ cnt,
                             uint64_t* __restrict__ keys) {
  const int tile = (int)(((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (tile >= n_tiles) return;  // whole warps
  const size_t g0 = (size_t)tile * K;
  const size_t g1 = g0 + K < (size_t)n_groups ? g0 + K : (size_t)n_groups;
  int n = 0;
  for (int s = lane; s < S; s += 32) {
    unsigned w = 0;
    for (size_t g = g0; g < g1; ++g) w |= (unsigned)mask[g * S + s];
    n += __popc(w & 0xffffu);
  }
  n = __reduce_add_sync(FULL, n);
  if (lane == 0) cnt[tile] = n;
  for (size_t ray = g0 * GROUP + lane; ray < g1 * GROUP; ray += 32)
    keys[ray] = NO_KEY;
}

// One block: chunk = max(min_chunk, ceil(total / target)); items of tile
// b = ceil(cnt[b] / chunk), scanned into offs; the counter zeroed.
__global__ void __launch_bounds__(PLAN_THREADS)
    pgwalk_plan(int n_tiles, int min_chunk, int target,
                int* __restrict__ work) {
  __shared__ long long part[PLAN_THREADS];
  const int* cnt = work + CTL;
  int* offs = work + CTL + n_tiles;
  const int tid = threadIdx.x, T = blockDim.x;
  const int per = (n_tiles + T - 1) / T;
  const int b0 = min(tid * per, n_tiles), b1 = min(b0 + per, n_tiles);
  long long mine = 0;
  for (int b = b0; b < b1; ++b) mine += cnt[b];
  part[tid] = mine;
  __syncthreads();
  for (int off = T / 2; off > 0; off >>= 1) {
    if (tid < off) part[tid] += part[tid + off];
    __syncthreads();
  }
  const long long total = part[0];
  const long long even = (total + target - 1) / target;
  const int chunk = even > min_chunk ? (int)even : min_chunk;
  __syncthreads();
  int items = 0;
  for (int b = b0; b < b1; ++b) items += (cnt[b] + chunk - 1) / chunk;
  part[tid] = items;
  __syncthreads();
  for (int off = 1; off < T; off <<= 1) {  // inclusive scan
    const long long v = tid >= off ? part[tid - off] : 0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  int base = (int)(part[tid] - items);
  for (int b = b0; b < b1; ++b) {
    offs[b] = base;
    base += (cnt[b] + chunk - 1) / chunk;
  }
  if (tid == T - 1) {
    offs[n_tiles] = base;
    work[0] = 0;
    work[1] = chunk;
    work[2] = base;
  }
}

// The issuing thread's cursor over an item's clusters: the OR words orw
// from super s on, rest being s's bits not yet passed, left to yield.
struct Cursor {
  int s;
  unsigned rest;
  int left;
};

__device__ __forceinline__ int next_cluster(Cursor& cu, const int* orw) {
  if (cu.left == 0) return -1;
  while (cu.rest == 0) cu.rest = (unsigned)orw[++cu.s];
  const int b = __ffs(cu.rest) - 1;
  cu.rest &= cu.rest - 1;
  --cu.left;
  return cu.s * SUPER + b;
}

__global__ void __launch_bounds__(1024)
    pgwalk_kernel(const int* __restrict__ mask, int S,
                  const float* __restrict__ rays8,
                  const float* __restrict__ woop, int n_groups, int K,
                  int lanes, int any_hit, int n_tiles, int* __restrict__ work,
                  uint64_t* __restrict__ keys) {
  __shared__ __align__(128) float ring[RING * WOOP_ROWS * CLUSTER];
  __shared__ __align__(8) uint64_t bars[RING];
  __shared__ uint64_t best[MAX_TILE_RAYS];
  __shared__ int cid[RING];
  __shared__ int item_sh, tile_sh, first_sh, sole_sh;
  extern __shared__ int dyn[];
  int* words = dyn;          // [K][S] the tile's words (low 16 bits)
  int* orw = dyn + K * S;    // [S] their OR
  int* pre = orw + S;        // [S] clusters of the OR before super s
  const int* cnt = work + CTL;
  const int* offs = work + CTL + n_tiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wpg = lanes / 4;                       // warps per group
  const int k = warp / wpg;                        // the warp's group
  const int q = (warp % wpg) * 4 + (lane >> 3);    // its lane of the ray
  const int rr = lane & 7;                         // its ray
  const int chunk = work[1], n_items = work[2];
  Stage st = stage_init(ring, bars, RING);  // synchronises the block
  int seq = 0;  // ring position of the next slot, block-uniform

  for (;;) {
    if (tid == 0) {
      const int item = atomicAdd(&work[0], 1);
      item_sh = item;
      if (item < n_items) {
        int lo = 0, hi = n_tiles - 1;  // the last tile with offs <= item
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (offs[mid] <= item) lo = mid; else hi = mid - 1;
        }
        tile_sh = lo;
        first_sh = (item - offs[lo]) * chunk;
        sole_sh = offs[lo + 1] - offs[lo] == 1;
      }
    }
    __syncthreads();
    const int item = item_sh;
    if (item >= n_items) break;  // block-uniform
    const int b = tile_sh, first = first_sh;
    const bool sole = sole_sh;
    const size_t g0 = (size_t)b * K;
    const int n_k = n_groups - g0 < (size_t)K ? (int)(n_groups - g0) : K;
    for (int i = tid; i < K * S; i += blockDim.x)
      words[i] = i / S < n_k ? mask[g0 * S + i] & 0xffff : 0;
    if (tid < K * GROUP) best[tid] = NO_KEY;
    __syncthreads();
    if (warp == 0) {
      int run = 0;
      for (int s0 = 0; s0 < S; s0 += 32) {
        const int s = s0 + lane;
        unsigned w = 0;
        if (s < S)
          for (int kk = 0; kk < K; ++kk) w |= (unsigned)words[kk * S + s];
        const int c = __popc(w);
        int incl = c;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int o = __shfl_up_sync(FULL, incl, off);
          if (lane >= off) incl += o;
        }
        if (s < S) {
          orw[s] = (int)w;
          pre[s] = run + incl - c;
        }
        run += __shfl_sync(FULL, incl, 31);
      }
    }
    __syncthreads();

    // Thread 0 fills slot s with the next cluster (or the end marker).
    Cursor cu{0, 0u, 0};
    bool ended = false;
    auto produce = [&](int s) {
      const int c = next_cluster(cu, orw);
      cid[s] = c;
      if (c >= 0) {
        stage_issue(st, s, woop, c);
      } else {
        stage_arrive(st, s);
        ended = true;
      }
    };
    if (tid == 0) {
      int lo = 0, hi = S - 1;  // the last super with pre <= first
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (pre[mid] <= first) lo = mid; else hi = mid - 1;
      }
      unsigned rest = (unsigned)orw[lo];
      for (int d = first - pre[lo]; d > 0; --d) rest &= rest - 1;
      cu = Cursor{lo, rest, min(chunk, cnt[b] - first)};
      for (int m = 0; m < RING - 1 && !ended; ++m) produce((seq + m) % RING);
    }

    Ray r{0.f, 0.f, 0.f, 1.f, 1.f, 1.f, 0.f, 0.f};
    if (k < n_k) r = load_ray(rays8, (g0 + k) * GROUP + rr);
    float bt = r.t_max;
    int bi = MISS_IDX;
    for (int i = 0;; ++i) {
      const int slot = (seq + i) % RING;
      if (tid == 0 && !ended) produce((seq + i + RING - 1) % RING);
      stage_wait(st, slot);
      const int c = cid[slot];
      if (c < 0) {  // block-uniform: every thread read the end marker
        seq += i + 1;
        break;
      }
      if ((words[k * S + (c >> 4)] >> (c & 15)) & 1) {  // warp-uniform
        const float* w = st.buffer(slot);
        const int base = c * CLUSTER;
        for (int v = q; v < PAIRS; v += lanes) {
          float qa[WOOP_ROWS], qb[WOOP_ROWS];
#pragma unroll
          for (int kk = 0; kk < WOOP_ROWS; ++kk) {
            const float2 q2 =
                reinterpret_cast<const float2*>(w + kk * CLUSTER)[v];
            qa[kk] = q2.x;
            qb[kk] = q2.y;
          }
          float ta, tb;
          bool va = woop_test<false>(qa, r, &ta);
          bool vb = woop_test<false>(qb, r, &tb);
          if (any_hit) {
            va = va && (ta > r.t_lo);
            vb = vb && (tb > r.t_lo);
          }
          if (va && ta < bt) {
            bt = ta;
            bi = base + 2 * v;
          }
          if (vb && tb < bt) {
            bt = tb;
            bi = base + 2 * v + 1;
          }
        }
      }
      __syncthreads();  // the buffer is free again
    }

    // The lanes of a ray meet: shuffles within the warp, then the warps
    // of the group in shared memory; then one thread per ray.
    uint64_t key = bi != MISS_IDX ? hit_key(bt, bi) : NO_KEY;
#pragma unroll
    for (int off = 8; off < 32; off <<= 1) {
      const uint64_t other = __shfl_xor_sync(FULL, key, off);
      if (other < key) key = other;
    }
    if (lane < GROUP && key != NO_KEY)
      atomicMin((unsigned long long*)&best[k * GROUP + rr],
                (unsigned long long)key);
    __syncthreads();
    if (tid < n_k * GROUP) {
      const uint64_t mk = best[tid];
      if (mk != NO_KEY) {
        uint64_t* dst = keys + g0 * GROUP + tid;
        if (sole)
          *dst = mk;
        else
          atomicMin((unsigned long long*)dst, (unsigned long long)mk);
      }
    }
  }
}

// Per ray: its key decoded (merge_keys; no key gives t_max and -1).
__global__ void pgwalk_merge(const uint64_t* __restrict__ keys,
                             size_t n_rays, const float* __restrict__ rays8,
                             float* __restrict__ out_t,
                             int* __restrict__ out_i) {
  const size_t ray = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (ray < n_rays) merge_keys<false>(keys, 1, n_rays, rays8, out_t, out_i,
                                      ray);
}

int launch(const int* mask, int S, const float* rays8, const float* woop,
           int n_groups, int any_hit, int K, int lanes, int min_chunk,
           int target, int* work, uint64_t* keys, float* out_t, int* out_i,
           cudaStream_t stream) {
  if (n_groups <= 0) return 0;
  const int threads = K * GROUP * lanes;
  if (K < 1 || K * GROUP > MAX_TILE_RAYS || lanes < 4 || lanes % 4 ||
      lanes > PAIRS || threads > 1024 || min_chunk < 1 || target < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (n_groups + K - 1) / K;
  const size_t dyn = (size_t)(K + 2) * S * sizeof(int);
  cudaError_t err;
  if (dyn > 48 * 1024) {
    err = cudaFuncSetAttribute(pgwalk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, pgwalk_kernel, threads, dyn)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;

  pgwalk_count<<<(unsigned)((n_tiles + 7) / 8), 256, 0, stream>>>(
      mask, S, n_groups, K, n_tiles, work + CTL, keys);
  pgwalk_plan<<<1, PLAN_THREADS, 0, stream>>>(n_tiles, min_chunk, target,
                                               work);
  pgwalk_kernel<<<(unsigned)(sms * per_sm), threads, dyn, stream>>>(
      mask, S, rays8, woop, n_groups, K, lanes, any_hit, n_tiles, work, keys);
  const size_t n_rays = (size_t)n_groups * GROUP;
  pgwalk_merge<<<(unsigned)((n_rays + 255) / 256), 256, 0, stream>>>(
      keys, n_rays, rays8, out_t, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

// work: int32 scratch of 4 + 2 * ceil(n_groups / K) + 1 entries; keys:
// uint64 scratch of 8 * n_groups entries.  Neither needs initialising.
extern "C" int srt_pgwalk(const int* mask, int S, const float* rays8,
                          const float* woop, int n_groups, int any_hit,
                          int groups_per_block, int lanes, int min_chunk,
                          int target_items, int* work, uint64_t* keys,
                          float* out_t, int* out_i, void* stream) {
  return launch(mask, S, rays8, woop, n_groups, any_hit, groups_per_block,
                lanes, min_chunk, target_items, work, keys, out_t, out_i,
                (cudaStream_t)stream);
}
