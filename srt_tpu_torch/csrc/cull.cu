// B1: tiled-walk cull.  Replaces _cull_kernel
// (srt_tpu/ops/traversal_pallas.py:134, launched by _launch_cull).
//
// Per tile of rays: slab-test every ray against every supercluster AABB,
// take the tile minimum of the entry distance max(t_near, 0) over the rays
// that enter before their t_max, and write the entered supers ordered by
// (entry, index) with a count.  Unused list slots hold 0.
//
// What bounds it: S slab tests per live ray (14 ALU-pipe instructions
// each in the SASS, ALU-bound; chip_smoke.py phase 2); the
// rank of S supers per tile and the lists' bytes are small beside them.
// What held the first design (one thread per ray; per super, six global
// box loads, a five-step shuffle minimum and a shared atomicMin; then one
// thread per super counting over all S supers) back, and what this one
// does:
//
// 1. Each super's box was six dependent global loads per ray, and each
//    super one serial chain.  Now the block stages the S boxes in shared
//    memory once, as two float4 a super (two broadcast reads), and each
//    thread tests U = 4 supers for each of its RPT rays (1 or 2, chosen by
//    the wrapper) as independent chains.  The slab's eleven minima and
//    maxima are one min.NaN / max.NaN instruction each
//    (traversal_common.cuh), not three.
// 2. The tile minimum took five shuffles and an atomic per (warp, super).
//    Now one redux.sync minimum (__reduce_min_sync) per (warp, super) on
//    the entry's float bits, which order like the floats because an entry
//    that passes is +0 or positive (nmax(-0, +0) gives +0; NaN never
//    passes); each warp writes its minima to its own row of a shared
//    [warps][S] array, combined once per super after one barrier.  No
//    atomic anywhere.
// 3. The rank was O(S^2) per tile (60,516 compares at S = 246).  Now each
//    active super becomes a 64-bit key (entry bits << 32 | index), so ties
//    go to the lower index by construction, and the block sorts the keys
//    with a bitonic network over the next power of two >= S, inactive
//    supers and padding as ~0 (after every real key); the lists are
//    written with consecutive stores and the count is where the real keys
//    end.  All-dead tiles skip the slab work (same result).
#include "traversal_common.cuh"

namespace {

using namespace srt;

constexpr int U = 4;  // supers per thread in flight

template <int RPT>
__global__ void cull_kernel(const float* __restrict__ rays8,
                            const float* __restrict__ sb, int S, int P2,
                            int tile, int* __restrict__ clist,
                            float* __restrict__ elist,
                            int* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem);    // [P2]
  float4* box = reinterpret_cast<float4*>(keys + P2);    // [S][2]
  unsigned* wmin = reinterpret_cast<unsigned*>(box + 2 * S);  // [warps][S]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const int tile_id = blockIdx.x;
  const unsigned big_bits = __float_as_uint(BIG);
  for (int s = tid; s < S; s += blockDim.x) {
    box[2 * s] = make_float4(sb[s], sb[S + s], sb[2 * S + s], sb[3 * S + s]);
    box[2 * s + 1] = make_float4(sb[4 * S + s], sb[5 * S + s], 0.f, 0.f);
  }

  Ray r[RPT];
  float ix[RPT], iy[RPT], iz[RPT];
  bool any = false;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    r[k] = load_ray(rays8, (size_t)tile_id * tile + k * blockDim.x + tid);
    ix[k] = 1.f / r[k].dx;
    iy[k] = 1.f / r[k].dy;
    iz[k] = 1.f / r[k].dz;
    any = any || r[k].t_max > 0.f;
  }
  const bool live = __syncthreads_or(any);  // also publishes the boxes

  // Tile-min entry bits of super s over this thread's rays, then the warp.
  auto warp_entry = [&](int s) {
    const float4 a = box[2 * s], b = box[2 * s + 1];
    unsigned v = big_bits;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      float sel;
      if (slab<false>(a.x, a.y, a.z, a.w, b.x, b.y, r[k].ox, r[k].oy,
                      r[k].oz, ix[k], iy[k], iz[k], r[k].t_max, &sel))
        v = min(v, __float_as_uint(sel));
    }
    return __reduce_min_sync(FULL, v);
  };
  if (live) {
    int s = 0;
    for (; s + U <= S; s += U) {
      unsigned v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = warp_entry(s + u);
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < U; ++u) wmin[warp * S + s + u] = v[u];
      }
    }
    for (; s < S; ++s) {
      const unsigned v = warp_entry(s);
      if (lane == 0) wmin[warp * S + s] = v;
    }
  }
  __syncthreads();

  // Combine the warps' minima once; one key per super, ~0 when inactive.
  for (int s = tid; s < P2; s += blockDim.x) {
    uint64_t key = NO_KEY;
    if (live && s < S) {
      unsigned e = wmin[s];
      for (int w = 1; w < n_warps; ++w) e = min(e, wmin[w * S + s]);
      if (e < big_bits) key = ((uint64_t)e << 32) | (unsigned)s;
    }
    keys[s] = key;
  }
  __syncthreads();

  // Bitonic sort of the P2 keys, ascending.
  for (int k = 2; k <= P2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P2; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t a = keys[i], b = keys[ixj];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  int* crow = clist + (size_t)tile_id * S;
  float* erow = elist + (size_t)tile_id * S;
  for (int slot = tid; slot < S; slot += blockDim.x) {
    const uint64_t key = keys[slot];
    const bool used = key != NO_KEY;
    crow[slot] = used ? (int)(key & 0xffffffffu) : 0;
    erow[slot] = used ? __uint_as_float((unsigned)(key >> 32)) : 0.f;
    // The count is where the real keys end (slot + 1 < P2 when S < P2).
    if (used && (slot + 1 == P2 || keys[slot + 1] == NO_KEY))
      counts[tile_id] = slot + 1;
  }
  if (tid == 0 && keys[0] == NO_KEY) counts[tile_id] = 0;
}

template <int RPT>
int launch(const float* rays8, const float* sbounds, int n_tiles, int tile,
           int S, int* clist, float* elist, int* counts,
           cudaStream_t stream) {
  const int threads = tile / RPT;
  if (tile % RPT || threads % 32 || threads > 1024 || S < 1)
    return (int)cudaErrorInvalidValue;
  int p2 = 2;  // the keys' slots: a power of two >= S, keeping box aligned
  while (p2 < S) p2 <<= 1;
  const size_t smem = (size_t)p2 * sizeof(uint64_t) +
                      (size_t)(8 + threads / 32) * S * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cull_kernel<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_tiles > 0)
    cull_kernel<RPT><<<n_tiles, threads, smem, stream>>>(
        rays8, sbounds, S, p2, tile, clist, elist, counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int srt_cull(const float* rays8, const float* sbounds, int n_tiles,
                        int tile, int S, int rays_per_thread, int* clist,
                        float* elist, int* counts, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (rays_per_thread == 1)
    return launch<1>(rays8, sbounds, n_tiles, tile, S, clist, elist, counts,
                     s);
  if (rays_per_thread == 2)
    return launch<2>(rays8, sbounds, n_tiles, tile, S, clist, elist, counts,
                     s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* srt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
