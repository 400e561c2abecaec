// The backward of the small-table row gather out = table[idx] (table
// [K, C], idx [N]; ops/gather.gather_rows): d table[k, c] = the sum, over
// the positions i with idx[i] == k, of grad[c, i], the incoming gradient
// read component-first ([C, N], with any strides, as it lies).  Not a TPU
// kernel: the JAX package leaves this scatter-add to XLA (the backward of
// _tri_record(scene)[idx].T, srt_tpu/models/mesh.py:633, and of
// with_positions' corner gathers).
//
// The wrapper sorts the indices first (stable, int32 keys), so each row's
// entries form one run, in ray order.  PyTorch's index_put_ backward for a
// row wider than 32 walks each run with one warp, one dependent load, add
// and store an entry; the path tracer sends every missed ray to row 0, so
// one warp walks millions of entries.  Here the work is cut by position,
// not by row:
//
// gather_bwd_chunks: one block a chunk of CHUNK = 2,048 sorted entries, 8
//   consecutive entries a thread.  For COLS columns at a time, each thread
//   loads its entries' gradients (a run in ray order reads neighbouring
//   addresses), sums them along its runs, and a segmented scan (warp
//   shuffles, then the 8 warps' totals through shared memory) carries the
//   sums across threads.  The last entry of each run then holds the run's
//   sum within the chunk.  A run that starts and ends inside the chunk,
//   and is neither its first nor its last, has this block as its only
//   writer: it is stored straight into the zeroed output.  The first and
//   the last run of the chunk go to a scratch row each, slots 2b and 2b+1,
//   with their table row (zeros in slot 2b+1 when the chunk is one run).
// gather_bwd_merge: the slots' rows are sorted too.  One block a slot; the
//   block at the first slot of each row sums that row's slots (columns
//   across threads, slots across groups of threads, the groups in a fixed
//   order) and stores the row.  No row has a writer in both kernels.
//
// No atomics: every sum is taken in an order fixed by the sorted positions
// alone, so two calls on the same inputs give the same bits.  The order is
// not PyTorch's sequential one.  What bounds it: bytes.  It reads the
// gradient (4 C N), the sorted keys and positions (12 N) and writes the
// table (4 K C); the path tracer's record gather (C = 36, N = 2^20, K =
// 101,760) moves about 180 MB, 0.05 ms at 3.35 TB/s.  The design keeps the
// gradient's one read coalesced on long runs and spends no pass on a
// transpose; rows of scattered hits read one sector an entry and column.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK_THREADS = 256;
constexpr int PER = 8;                           // sorted entries a thread
constexpr int CHUNK = CHUNK_THREADS * PER;       // 2,048 entries a block
constexpr int CHUNK_WARPS = CHUNK_THREADS / 32;
constexpr int COLS = 4;                          // columns a pass
constexpr int MERGE_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(CHUNK_THREADS)
    gather_bwd_chunks(const int* __restrict__ keys,
                      const int64_t* __restrict__ pos,
                      const float* __restrict__ grad, long long sc,
                      long long sn, int cols, int n, float* __restrict__ out,
                      float* __restrict__ part, int* __restrict__ part_row) {
  __shared__ int s_first_tail;
  __shared__ int s_wf[CHUNK_WARPS];
  __shared__ float s_wv[CHUNK_WARPS][COLS];

  const int base = blockIdx.x * CHUNK;
  const int end = min(base + CHUNK, n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e0 = base + threadIdx.x * PER;

  int key[PER];
  long long off[PER];
  bool head[PER], tail[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const bool live = e0 + j < end;
    key[j] = live ? keys[e0 + j] : -1;
    off[j] = live ? pos[e0 + j] * sn : 0;
  }
  const int before = (e0 > base && e0 < end) ? keys[e0 - 1] : -1;
  const int after = (e0 + PER < end) ? keys[e0 + PER] : -1;
  bool any_head = false;
  int first_tail = end;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = e0 + j;
    const bool live = e < end;
    const int prev = j == 0 ? before : key[j - 1];
    const int next = j == PER - 1 ? after : key[j + 1];
    head[j] = live && (e == base || prev != key[j]);
    tail[j] = live && (e == end - 1 || next != key[j]);
    any_head = any_head || head[j];
    if (tail[j]) first_tail = min(first_tail, e);
  }
  if (threadIdx.x == 0) s_first_tail = end;
  __syncthreads();
  if (first_tail < end) atomicMin(&s_first_tail, first_tail);
  __syncthreads();
  const int ft = s_first_tail;   // the tail of the chunk's first run
  float* const first_slot = part + (size_t)(2 * blockIdx.x) * cols;
  float* const last_slot = first_slot + cols;

  for (int c0 = 0; c0 < cols; c0 += COLS) {
    float x[PER][COLS];
#pragma unroll
    for (int j = 0; j < PER; ++j)
#pragma unroll
      for (int q = 0; q < COLS; ++q)
        x[j][q] = (e0 + j < end && c0 + q < cols)
                      ? grad[(c0 + q) * sc + off[j]]
                      : 0.0f;
    // Sums along the thread's runs, restarted at each head.
#pragma unroll
    for (int j = 1; j < PER; ++j)
#pragma unroll
      for (int q = 0; q < COLS; ++q)
        if (!head[j]) x[j][q] = x[j - 1][q] + x[j][q];

    // Segmented inclusive scan of (a head seen, the sum since it) over the
    // lanes, earlier lanes' sums on the left.
    int f = any_head;
    float v[COLS];
#pragma unroll
    for (int q = 0; q < COLS; ++q) v[q] = x[PER - 1][q];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int pf = __shfl_up_sync(FULL, f, d);
      float pv[COLS];
#pragma unroll
      for (int q = 0; q < COLS; ++q) pv[q] = __shfl_up_sync(FULL, v[q], d);
      if (lane >= d) {
        if (!f) {
#pragma unroll
          for (int q = 0; q < COLS; ++q) v[q] = pv[q] + v[q];
        }
        f = f | pf;
      }
    }
    const int ef = __shfl_up_sync(FULL, f, 1);
    float ev[COLS];
#pragma unroll
    for (int q = 0; q < COLS; ++q) ev[q] = __shfl_up_sync(FULL, v[q], 1);
    if (lane == 31) {
      s_wf[warp] = f;
#pragma unroll
      for (int q = 0; q < COLS; ++q) s_wv[warp][q] = v[q];
    }
    __syncthreads();

    // The carry into this thread: the earlier warps' totals in order, then
    // the earlier lanes' sum.
    float carry[COLS];
    bool have = false;
    for (int w = 0; w < warp; ++w) {
      const bool restart = s_wf[w] || !have;
#pragma unroll
      for (int q = 0; q < COLS; ++q)
        carry[q] = restart ? s_wv[w][q] : carry[q] + s_wv[w][q];
      have = true;
    }
    if (lane > 0) {
      const bool restart = ef || !have;
#pragma unroll
      for (int q = 0; q < COLS; ++q)
        carry[q] = restart ? ev[q] : carry[q] + ev[q];
      have = true;
    }
    if (have) {
      bool open = true;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        open = open && !head[j];
        if (open) {
#pragma unroll
          for (int q = 0; q < COLS; ++q) x[j][q] = carry[q] + x[j][q];
        }
      }
    }

    // Each run's tail holds the run's sum within the chunk.
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (!tail[j]) continue;
      const int e = e0 + j;
      float* dst = e == ft         ? first_slot
               : e == end - 1 ? last_slot
                              : out + (size_t)key[j] * cols;
#pragma unroll
      for (int q = 0; q < COLS; ++q)
        if (c0 + q < cols) dst[c0 + q] = x[j][q];
      if (e == ft && e == end - 1) {
#pragma unroll
        for (int q = 0; q < COLS; ++q)
          if (c0 + q < cols) last_slot[c0 + q] = 0.0f;
      }
    }
    __syncthreads();   // s_wf and s_wv are rewritten by the next pass
  }
  if (threadIdx.x == 0) {
    part_row[2 * blockIdx.x] = keys[ft];
    part_row[2 * blockIdx.x + 1] = keys[end - 1];
  }
}

__global__ void __launch_bounds__(MERGE_THREADS)
    gather_bwd_merge(const int* __restrict__ part_row,
                     const float* __restrict__ part, int cols, int slots,
                     float* __restrict__ out) {
  __shared__ int s_stop;
  __shared__ float s_sum[MERGE_THREADS];
  const int j = blockIdx.x;
  const int row = part_row[j];
  if (j > 0 && part_row[j - 1] == row) return;   // not the row's first slot
  if (threadIdx.x < 32) {
    int stop = slots;
    for (int s = j + 1; s < slots; s += 32) {
      const int i = s + threadIdx.x;
      const unsigned m =
          __ballot_sync(FULL, i >= slots || part_row[i] != row);
      if (m) {
        stop = s + __ffs(m) - 1;
        break;
      }
    }
    if (threadIdx.x == 0) s_stop = stop;
  }
  __syncthreads();
  const int stop = s_stop;
  const int width = min(cols, MERGE_THREADS);
  const int groups = MERGE_THREADS / width;
  const int g = threadIdx.x / width, cl = threadIdx.x % width;
  for (int c0 = 0; c0 < cols; c0 += width) {
    const int c = c0 + cl;
    float acc = 0.0f;
    if (g < groups && c < cols) {
#pragma unroll 4
      for (int i = j + g; i < stop; i += groups)
        acc += part[(size_t)i * cols + c];
    }
    s_sum[threadIdx.x] = acc;
    __syncthreads();
    if (g == 0 && c < cols) {
      float total = s_sum[cl];
      for (int h = 1; h < groups; ++h) total += s_sum[h * width + cl];
      out[(size_t)row * cols + c] = total;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int srt_gather_bwd(const int* keys, const int64_t* pos,
                              const float* grad, long long sc, long long sn,
                              int cols, int n, int slots, float* out,
                              float* part, int* part_row, void* stream) {
  // The caller sizes part and part_row for two slots a chunk of CHUNK.
  const long long blocks = ((long long)n + CHUNK - 1) / CHUNK;
  if (n < 0 || cols < 0 || slots != 2 * blocks)
    return (int)cudaErrorInvalidValue;
  if (n > 0 && cols > 0)
    gather_bwd_chunks<<<(unsigned)blocks, CHUNK_THREADS, 0,
                        (cudaStream_t)stream>>>(keys, pos, grad, sc, sn, cols,
                                                n, out, part, part_row);
  return (int)cudaGetLastError();
}

extern "C" int srt_gather_bwd_merge(const int* part_row, const float* part,
                                    int cols, int slots, float* out,
                                    void* stream) {
  if (slots > 0 && cols > 0)
    gather_bwd_merge<<<slots, MERGE_THREADS, 0, (cudaStream_t)stream>>>(
        part_row, part, cols, slots, out);
  return (int)cudaGetLastError();
}
