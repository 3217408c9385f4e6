// Block FFT helpers shared by the kernels that take an N-point FFT of each
// row at N = 256 .. 4096 and its first-max argmax (scan.cu, decide.cu): a
// row is spread over N / 16 threads of a 256-thread block, 16 samples a
// thread, and transformed in three passes of radix 16 with padded
// shared-memory transposes between them. The register FFTs and the
// first-max rule are fft_rows.cuh's.

#pragma once

#include <cuda_runtime.h>

#include "fft_rows.cuh"

namespace {

constexpr int kR = 16;        // samples (and bins) a thread holds in a pass
constexpr int kWarps = 8;     // warps a block
constexpr int kThreads = 32 * kWarps;

// Samples J.. of a thread's share of both planes: ar[J] = a[J * sa],
// ai[J] = b[J * sb]. The recursion keeps every array index a compile-time
// constant.
template <int K, int J = 0>
__device__ __forceinline__ void load_share(const float* a, long long sa, const float* b,
                                           long long sb, float (&ar)[K], float (&ai)[K]) {
  if constexpr (J < K) {
    ar[J] = __ldg(a + J * sa);
    ai[J] = __ldg(b + J * sb);
    load_share<K, J + 1>(a, sa, b, sb, ar, ai);
  }
}

template <int K, int J = 0>
__device__ __forceinline__ void zero_share(float (&ar)[K], float (&ai)[K]) {
  if constexpr (J < K) {
    ar[J] = 0.0f;
    ai[J] = 0.0f;
    zero_share<K, J + 1>(ar, ai);
  }
}

// ---------------------------------------------------------------------------
// N = 256 .. 4096: N / 16 threads a row, 4096 / N rows a block
// ---------------------------------------------------------------------------
//
// N = 16 * M, M = 16 * L. Thread t < M of a window holds samples
// t + M*j (j < 16). With k = k1 + 16*k2, k2 = c + 16*d:
//   pass 1: y[t][k1] = W_N^(t*k1) * sum_j x[t + M*j] W_16^(j*k1);
//   pass 2, thread (k1, ta) = (t / L, t % L):
//           z[k1][ta][c] = W_M^(ta*c) * sum_tb y[ta + L*tb][k1] W_16^(tb*c);
//   pass 3, thread (k1, r) = (t / L, t % L), for c = r + L*q (q < 16 / L):
//           X[k1 + 16*c + 256*d] = sum_ta z[k1][ta][c] W_L^(ta*d).
// Shared layouts (float2 units; a 64-bit access is served a half-warp at a
// time, and every half-warp below meets 16 distinct banks pairs):
//   S1[w][k1][t] at w*S1W + k1*17L + t (17L = L mod 16 spreads the k1 of a
//   half-warp in pass 2's reads);
//   S2[w][k1][c][ta] at w*S2W + k1*A + c*B + ta, B = L + 1 (odd; 1 at
//   L = 1), A = 16B + (L*B mod 16), so that (k1, r) -> (k1*L + r)*B mod 16
//   in pass 3's reads and (k1, ta) -> k1*L*B + ta mod 16 in pass 2's
//   writes are distinct.

template <int N>
struct Block {
  static constexpr int M = N / kR;                 // threads a window
  static constexpr int L = M / kR;                 // third-pass FFT size
  static constexpr int W = kThreads / M;           // windows a block tile
  static constexpr int S1R = 17 * L;               // S1 k1-row stride
  static constexpr int S1W = kR * S1R;             // S1 window stride
  static constexpr int B = L == 1 ? 1 : L + 1;     // S2 c-row stride
  static constexpr int A = kR * B + (L * B) % kR;  // S2 k1 stride
  static constexpr int S2W = L == 1 ? 0 : kR * A;  // S2 window stride
  static constexpr int BUF = W * (S1W > S2W ? S1W : S2W);  // float2 a transform
  static_assert(N >= 256 && N <= 4096 && L >= 1 && W >= 1, "N in 256 .. 4096");
};

// Pass 1 of one transform on the thread's share (samples t + M*j, already
// dechirped or derotated): the 16-point FFT over j, the twiddles
// W_N^(t*k1), into S1.
template <int N>
__device__ __forceinline__ void block_pass1_fft(float (&re)[kR], float (&im)[kR],
                                                const float2* __restrict__ twiddle,
                                                const float2 (&w16)[kR / 2], float2* s1, int t) {
  using D = Block<N>;
  fft_dif<kR, 0, kR>(re, im, w16);
#pragma unroll
  for (int p = 0; p < kR; ++p) {
    const int k1 = bit_reverse(p, log2i(kR));
    float vr = re[p], vi = im[p];
    if (k1 != 0) {
      const float2 w = __ldg(twiddle + t * k1);
      const float r2 = vr * w.x - vi * w.y;
      vi = vr * w.y + vi * w.x;
      vr = r2;
    }
    s1[k1 * D::S1R + t] = make_float2(vr, vi);
  }
}

// |.|^2 and the first-max over a thread's bins, then across the window's
// lanes of the warp by shuffles (M >= 32: the whole warp; M = 16: each
// half).
template <int N>
__device__ __forceinline__ void warp_first_max(float& best, int& best_k) {
  constexpr int M = Block<N>::M;
#pragma unroll
  for (int off = (M < 32 ? M : 32) / 2; off >= 1; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, best, off);
    const int ok = __shfl_xor_sync(0xffffffffu, best_k, off);
    take_max(best, best_k, om, ok);
  }
}

// Passes 2 (and, at L = 1, the argmax) of one transform. At L > 1 the
// result goes back into the same buffer as S2, after the block has read
// S1 (the barrier inside).
template <int N>
__device__ __forceinline__ void block_pass2(float2* s, int lw, int t,
                                            const float2* __restrict__ twiddle,
                                            const float2 (&w16)[kR / 2], float& best, int& best_k) {
  using D = Block<N>;
  constexpr int L = D::L;
  const int k1 = t / L, ta = t % L;
  float re[kR], im[kR];
  const float2* src = s + lw * D::S1W + k1 * D::S1R + ta;
#pragma unroll
  for (int tb = 0; tb < kR; ++tb) {
    const float2 v = src[L * tb];
    re[tb] = v.x;
    im[tb] = v.y;
  }
  fft_dif<kR, 0, kR>(re, im, w16);
  if constexpr (L == 1) {
    // bins k1 + 16*c
    best = re[0] * re[0] + im[0] * im[0];
    best_k = k1;
#pragma unroll
    for (int p = 1; p < kR; ++p)
      take_max(best, best_k, re[p] * re[p] + im[p] * im[p],
               k1 + kR * bit_reverse(p, log2i(kR)));
  } else {
    __syncthreads();  // every thread has read S1
    float2* dst = s + lw * D::S2W + k1 * D::A + ta;
#pragma unroll
    for (int p = 0; p < kR; ++p) {
      const int c = bit_reverse(p, log2i(kR));
      float vr = re[p], vi = im[p];
      if (c != 0 && ta != 0) {
        const float2 w = __ldg(twiddle + kR * ta * c);  // W_M^(ta*c)
        const float r2 = vr * w.x - vi * w.y;
        vi = vr * w.y + vi * w.x;
        vr = r2;
      }
      dst[c * D::B] = make_float2(vr, vi);
    }
  }
}

// Pass 3 of one transform (L > 1): the L-point FFTs over ta and the
// thread's first-max over bins k1 + 16*c + 256*d.
template <int N>
__device__ __forceinline__ void block_pass3(const float2* s, int lw, int t,
                                            const float2 (&w_l)[Block<N>::L / 2], float& best,
                                            int& best_k) {
  using D = Block<N>;
  constexpr int L = D::L, Q = kR / L;  // Q L-point FFTs a thread
  const int k1 = t / L, r = t % L;
  float re[kR], im[kR];
  const float2* src = s + lw * D::S2W + k1 * D::A + r * D::B;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int ta = 0; ta < L; ++ta) {
      const float2 v = src[L * q * D::B + ta];
      re[q * L + ta] = v.x;
      im[q * L + ta] = v.y;
    }
  }
  fft_each<L, Q, kR>(re, im, w_l);
  best = re[0] * re[0] + im[0] * im[0];
  best_k = k1 + kR * r;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int p = 0; p < L; ++p) {
      const int k = k1 + kR * (r + L * q) + 256 * bit_reverse(p, log2i(L));
      if (q + p > 0) take_max(best, best_k, re[q * L + p] * re[q * L + p] +
                                                im[q * L + p] * im[q * L + p], k);
    }
  }
}

}  // namespace
