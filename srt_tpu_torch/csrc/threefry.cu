// Threefry-2x32 counter lattice of JAX's partitionable random bits (not a
// TPU kernel: the JAX package leaves this to XLA; see
// srt_tpu/ops/rng.py:48-101, SlotBlock and KeyStream).
//
// Element (r, c) of a [rows, m] block is lattice point
//   j = (lo + r) * n + col(c)        (uint32 arithmetic, as JAX's rows_at)
// with col(c) = cols[c], or c when cols is null.  With raw == 0 it becomes
// the float32 uniform of bits = w0 ^ w1 of threefry2x32(key, (0, j)),
// mapped as ((bits >> 9) | 0x3F800000) - 1; with raw == 1 (fold_in) the
// block must be one element and out receives (w0, w1) as two int64.
//
// What bounds it: ~170 integer operations per element and no memory but
// the column indices, the two key words and the output: compute-bound, one
// thread per element.  The plain PyTorch version costs ~170 elementwise
// launches per block on a host-bound frame; this is one.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int ROT[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, ROT[i & 1][q]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__global__ void threefry_kernel(const int64_t* __restrict__ key,
                                const int64_t* __restrict__ cols, int m,
                                uint32_t lo, int rows, uint32_t n, int raw,
                                void* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)rows * m) return;
  const int r = (int)(e / m);
  const int c = (int)(e % m);
  const uint32_t col = cols ? (uint32_t)cols[c] : (uint32_t)c;
  uint32_t x0 = 0u;
  uint32_t x1 = (lo + (uint32_t)r) * n + col;
  threefry2x32((uint32_t)key[0], (uint32_t)key[1], x0, x1);
  if (raw) {
    static_cast<int64_t*>(out)[0] = (int64_t)x0;
    static_cast<int64_t*>(out)[1] = (int64_t)x1;
  } else {
    static_cast<float*>(out)[e] =
        __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
  }
}

}  // namespace

extern "C" int srt_threefry(const int64_t* key, const int64_t* cols, int m,
                            unsigned lo, int rows, unsigned n, int raw,
                            void* out, void* stream) {
  const size_t total = (size_t)rows * m;
  if (total > 0) {
    const int block = 256;
    threefry_kernel<<<(unsigned)((total + block - 1) / block), block, 0,
                      (cudaStream_t)stream>>>(key, cols, m, lo, rows, n, raw,
                                              out);
  }
  return (int)cudaGetLastError();
}
