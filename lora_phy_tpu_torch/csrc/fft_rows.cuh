// Register FFT helpers shared by the kernels that take an FFT of each row
// and its first-max argmax (fused_demod.cu, scan.cu), and their launch
// sizing. Every transform is a radix-2 decimation-in-frequency FFT over
// arrays held in registers: every index is a compile-time constant, so
// the arrays never reach local memory. Twiddles come from one [N] complex
// table (cos, -sin)(2*pi*m/N), built in numpy in double, cast to float32,
// with exact 0 / +-1 at the quarter points.

#pragma once

#include <atomic>

#include <cuda_runtime.h>

namespace {

// The first-max rule: the larger value wins, a tie goes to the smaller bin.
__device__ __forceinline__ void take_max(float& m, int& idx, float om, int oi) {
  if (om > m || (om == m && oi < idx)) {
    m = om;
    idx = oi;
  }
}

__host__ __device__ constexpr int bit_reverse(int v, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((v >> b) & 1) << (bits - 1 - b);
  return r;
}

__host__ __device__ constexpr int log2i(int v) { return v <= 1 ? 0 : 1 + log2i(v >> 1); }

// One stage of an M-point radix-2 decimation-in-frequency FFT over
// re/im[OFF .. OFF+M): butterflies HALF apart, then the next stage. Every
// index is a compile-time constant, so the arrays stay in registers.
// w[e] = W_M^e = (cos, -sin)(2*pi*e/M) for e < M/2.
template <int M, int HALF, int OFF, int LEN>
__device__ __forceinline__ void dif_stage(float (&re)[LEN], float (&im)[LEN],
                                          const float2 (&w)[M / 2]) {
#pragma unroll
  for (int blk = 0; blk < M / (2 * HALF); ++blk) {
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const int a = OFF + 2 * HALF * blk + i;
      const int b = a + HALF;
      const int e = i * (M / (2 * HALF));
      const float dr = re[a] - re[b];
      const float di = im[a] - im[b];
      re[a] += re[b];
      im[a] += im[b];
      if (e == 0) {
        re[b] = dr;
        im[b] = di;
      } else if (4 * e == M) {  // W = -j, exactly
        re[b] = di;
        im[b] = -dr;
      } else {
        re[b] = dr * w[e].x - di * w[e].y;
        im[b] = dr * w[e].y + di * w[e].x;
      }
    }
  }
  if constexpr (HALF > 1) dif_stage<M, HALF / 2, OFF, LEN>(re, im, w);
}

// In-place M-point radix-2 DIF FFT over re/im[OFF .. OFF+M) with natural
// input order; output position p holds bin bit_reverse(p).
template <int M, int OFF, int LEN>
__device__ __forceinline__ void fft_dif(float (&re)[LEN], float (&im)[LEN],
                                        const float2 (&w)[M / 2]) {
  dif_stage<M, M / 2, OFF, LEN>(re, im, w);
}

// fft_dif over each of the K consecutive M-point groups of re/im.
template <int M, int K, int LEN>
__device__ __forceinline__ void fft_each(float (&re)[LEN], float (&im)[LEN],
                                         const float2 (&w)[M / 2]) {
  if constexpr (K > 0) {
    fft_each<M, K - 1, LEN>(re, im, w);
    fft_dif<M, (K - 1) * M, LEN>(re, im, w);
  }
}

// first-max argmax over natural bins K.. of a bit-reversed DIF output
template <int N, int K = 1>
__device__ __forceinline__ void scan_bins(const float (&re)[N], const float (&im)[N],
                                          float& best, int& best_k) {
  if constexpr (K < N) {
    constexpr int p = bit_reverse(K, log2i(N));
    const float v = re[p] * re[p] + im[p] * im[p];
    if (v > best) {
      best = v;
      best_k = K;
    }
    scan_bins<N, K + 1>(re, im, best, best_k);
  }
}

// Blocks of `kernel` (`threads` a block, `smem` bytes of dynamic shared
// memory, which it is allowed) resident on the current device's SMs at
// once, queried once per device and kept in `cache`.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem,
                            std::atomic<long long>* cache, long long* blocks) {
  constexpr int kMaxDevices = 64;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices) {
    *blocks = cache[device].load(std::memory_order_relaxed);
    if (*blocks > 0) return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  *blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (device < kMaxDevices) cache[device].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace
