// Gateway scan kernel for Hopper (sm_90a): for every symbol window of the
// (re, im) planes, the up-dechirp (x times the base downchirp) and the
// down-dechirp (x times its conjugate) of the window's decimated samples,
// an N-point FFT of each, |.|^2 and the first-max argmax, in one pass. Per
// window it writes the two peak bins (int32) and the two peak powers
// (float32); no [.., W, N] plane is written. Bound to Python through a
// plain C interface (ctypes); see lora_phy_tpu_torch/ops/scan.py for the
// wrapper and the plain PyTorch twin it is checked against.
//
// Replaces no TPU kernel: the JAX twin (lora_phy_tpu/models/sync.py
// frame_sync_scan_planar) is jnp products and the planar DFT as matmuls,
// which XLA fuses. In eager PyTorch the same code is four dechirp planes,
// two stacks and a dense f32 DFT GEMM (N <= 128) or the torch four-step
// (N > 128), over [2, .., W, N] intermediates.
//
// What bounds it on an H100: both planes read once, 8 bytes a sample, and
// 16 bytes a window written. At the gateway cells' shape (134.2 M samples
// a plane) that is 1.074 GB, 0.321 ms at 3.35 TB/s; the two FFTs are
// 10 N log2 N flops a window (9.4e9 at N = 128, 0.14 ms at the 67 TFLOP/s
// f32 peak), so the bytes bound it, and instruction issue comes next.
//
// Arithmetic: exact float32. The dechirp rounds each product and each sum
// on its own (__fmul_rn, __fadd_rn, __fsub_rn, never contracted), as the
// eager twin's ops do, so the dechirped samples are the twin's floats:
//   up:   yr = xr*dr - xi*di,  yi = xr*di + xi*dr
//   down: yr = xr*dr + xi*di,  yi = xi*dr - xr*di
// The FFT differs from the twin's dense sums only in rounding, so the bins
// agree except where two powers lie within float32 rounding of each other.
// Ties go to the lowest natural bin (fft_rows.cuh take_max). No TF32, no
// bf16, no intrinsics of reduced precision; the chirp is read from its
// table, never recomputed.
//
// Designs, each with the FFT helpers of fft_rows.cuh (radix-2 DIF in
// registers) and the twiddles of one [N] complex table:
// - N = 4, 8, 16: one thread a window (scan_small_kernel), as
//   fused_demod_small: the window's N samples in registers, both FFTs and
//   argmaxes there.
// - N = 32, 64, 128: G = N / 16 threads a window holding 16 samples at
//   stride G (scan_rows_kernel), fused_demod_kernel's row design: a
//   16-point FFT over j, the twiddles W_N^(t*k1), a transpose within the
//   warp through shared memory, G-point FFTs over t, the shuffle
//   first-max. One load of the window feeds both transforms.
// - N = 256 .. 4096: N / 16 threads a window, 4096 / N windows a block of
//   256 threads (scan_block_kernel), three passes of radix 16 over
//   N = 16 * 16 * L (L = N / 256 = 1 .. 16; the third pass is L-point
//   FFTs, none at L = 1), with padded shared-memory transposes between
//   them, then a shuffle first-max and one across warps. Blocks walk the
//   tiles in a persistent grid-stride loop; each thread loads its next
//   tile's samples into registers as soon as the current tile's first
//   pass has read them, so the loads are in flight during the other
//   passes.
// Windows are read through the planes' row and element strides; the tail
// of a row past its last whole window is never read.

#include <atomic>

#include <cuda_runtime.h>

#include "fft_rows.cuh"

namespace {

constexpr int kR = 16;        // samples (and bins) a thread holds in a pass
constexpr int kLaneStride = kR + 1;
constexpr int kWarps = 8;     // warps a block
constexpr int kThreads = 32 * kWarps;

struct Plane {
  const float* p;
  long long row_stride;   // elements
  long long elem_stride;  // elements
};

struct Out {
  int* ub;
  int* db;
  float* up;
  float* dn;
};

struct Geom {
  long long windows;  // rows * nwin
  long long nwin;     // windows a row
  long long step;     // samples a window, n * osr
  int osr;
  int dph;            // decimation phase
};

// The element offsets of window gw's first decimated sample in both planes.
__device__ __forceinline__ void window_base(const Geom& g, long long gw, const Plane& a,
                                            const Plane& b, long long& oa, long long& ob) {
  long long row;
  if (g.windows <= 0xffffffffLL)
    row = static_cast<unsigned>(gw) / static_cast<unsigned>(g.nwin);
  else
    row = gw / g.nwin;
  const long long c = (gw - row * g.nwin) * g.step + g.dph;
  oa = row * a.row_stride + c * a.elem_stride;
  ob = row * b.row_stride + c * b.elem_stride;
}

// One dechirped sample, each product and sum rounded on its own: x * d
// (up) or x * conj(d) (down).
template <bool kDown>
__device__ __forceinline__ void dechirp_one(float ar, float ai, float2 d, float& yr, float& yi) {
  if (kDown) {
    yr = __fadd_rn(__fmul_rn(ar, d.x), __fmul_rn(ai, d.y));
    yi = __fsub_rn(__fmul_rn(ai, d.x), __fmul_rn(ar, d.y));
  } else {
    yr = __fsub_rn(__fmul_rn(ar, d.x), __fmul_rn(ai, d.y));
    yi = __fadd_rn(__fmul_rn(ar, d.y), __fmul_rn(ai, d.x));
  }
}

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

// The dechirp of samples J.. of a thread's share; sample J's chirp value
// is d[J * stride].
template <bool kDown, int K, int J = 0>
__device__ __forceinline__ void dechirp_share(const float (&ar)[K], const float (&ai)[K],
                                              const float2* d, int stride, float (&re)[K],
                                              float (&im)[K]) {
  if constexpr (J < K) {
    dechirp_one<kDown>(ar[J], ai[J], d[J * stride], re[J], im[J]);
    dechirp_share<kDown, K, J + 1>(ar, ai, d, stride, re, im);
  }
}

// The same with the chirp read from the [step] tables at decimated
// indices: sample J's value is (dr, di)[J * stride].
template <bool kDown, int K, int J = 0>
__device__ __forceinline__ void dechirp_share_ldg(const float (&ar)[K], const float (&ai)[K],
                                                  const float* dr, const float* di,
                                                  long long stride, float (&re)[K],
                                                  float (&im)[K]) {
  if constexpr (J < K) {
    dechirp_one<kDown>(ar[J], ai[J], make_float2(__ldg(dr + J * stride), __ldg(di + J * stride)),
                       re[J], im[J]);
    dechirp_share_ldg<kDown, K, J + 1>(ar, ai, dr, di, stride, re, im);
  }
}

// The decimated chirp (dr, di)[n * osr + dph] and the twiddles, n < N, into
// shared memory.
template <int N>
__device__ __forceinline__ void stage_tables(const float* dr, const float* di,
                                             const float2* twiddle, const Geom& g,
                                             float2* chirp_s, float2* tw_s) {
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    tw_s[i] = twiddle[i];
    const long long j = static_cast<long long>(i) * g.osr + g.dph;
    chirp_s[i] = make_float2(dr[j], di[j]);
  }
  __syncthreads();
}

__device__ __forceinline__ void write_out(const Out& out, long long gw, int ku, float bu,
                                          int kd, float bd) {
  out.ub[gw] = ku;
  out.db[gw] = kd;
  out.up[gw] = bu;
  out.dn[gw] = bd;
}

// ---------------------------------------------------------------------------
// N = 4, 8, 16: one thread a window
// ---------------------------------------------------------------------------

template <bool kDown, int N>
__device__ __forceinline__ void small_transform(const float (&ar)[N], const float (&ai)[N],
                                                const float2* chirp_s, const float2 (&w)[N / 2],
                                                float& best, int& best_k) {
  float re[N], im[N];
  dechirp_share<kDown>(ar, ai, chirp_s, 1, re, im);
  fft_dif<N, 0, N>(re, im, w);
  best = re[0] * re[0] + im[0] * im[0];
  best_k = 0;
  scan_bins<N>(re, im, best, best_k);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    scan_small_kernel(Plane xr, Plane xi, const float* __restrict__ dr,
                      const float* __restrict__ di, const float2* __restrict__ twiddle, Out out,
                      Geom geo) {
  static_assert(N == 4 || N == 8 || N == 16, "N in 4 / 8 / 16");
  __shared__ float2 tw_s[N];
  __shared__ float2 chirp_s[N];
  stage_tables<N>(dr, di, twiddle, geo, chirp_s, tw_s);
  float2 w[N / 2];  // W_N^e
#pragma unroll
  for (int e = 0; e < N / 2; ++e) w[e] = tw_s[e];

  const long long sa = geo.osr * xr.elem_stride, sb = geo.osr * xi.elem_stride;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long gw = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       gw < geo.windows; gw += stride) {
    long long oa, ob;
    window_base(geo, gw, xr, xi, oa, ob);
    float ar[N], ai[N];
    load_share<N>(xr.p + oa, sa, xi.p + ob, sb, ar, ai);
    float bu, bd;
    int ku, kd;
    small_transform<false, N>(ar, ai, chirp_s, w, bu, ku);
    small_transform<true, N>(ar, ai, chirp_s, w, bd, kd);
    write_out(out, gw, ku, bu, kd, bd);
  }
}

// ---------------------------------------------------------------------------
// N = 32, 64, 128: G = N / 16 threads a window (fused_demod_kernel's rows)
// ---------------------------------------------------------------------------

// Steps 2-6 of fused_demod_kernel on one dechirped share (thread t of the
// window's G in lane `lane`, window g of the warp): the 16-point FFT over
// j, the twiddles W_N^(t*k1) and the transpose through the warp's buffer,
// the G-point FFTs over t, then |.|^2 and the first-max argmax on natural
// bins k1 + 16*k2, reduced across the window's G lanes by shuffles.
template <int N>
__device__ __forceinline__ void row_transform(float (&re)[kR], float (&im)[kR],
                                              const float2* tw_s, const float2 (&w_r)[kR / 2],
                                              const float2 (&w_g)[N / kR / 2], float2* my_buf,
                                              int lane, int g, int t, float& best, int& best_k) {
  constexpr int G = N / kR;
  constexpr int kM = kR / G;  // G-point transforms a thread
  fft_dif<kR, 0, kR>(re, im, w_r);
  __syncwarp();
#pragma unroll
  for (int p = 0; p < kR; ++p) {
    const int k1 = bit_reverse(p, log2i(kR));
    float vr = re[p], vi = im[p];
    if (k1 != 0) {
      const float2 w = tw_s[t * k1];
      const float r2 = vr * w.x - vi * w.y;
      vi = vr * w.y + vi * w.x;
      vr = r2;
    }
    my_buf[lane * kLaneStride + k1] = make_float2(vr, vi);
  }
  __syncwarp();
  // thread t now takes k1 = t + G*m (m < kM) from the window's G lanes
  float ur[kR], ui[kR];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int src = 0; src < G; ++src) {
      const float2 v = my_buf[(g * G + src) * kLaneStride + t + G * m];
      ur[m * G + src] = v.x;
      ui[m * G + src] = v.y;
    }
  }
  fft_each<G, kM, kR>(ur, ui, w_g);
  best = ur[0] * ur[0] + ui[0] * ui[0];
  best_k = t;
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int p = 0; p < G; ++p) {
      const int k = t + G * m + kR * bit_reverse(p, log2i(G));
      const float vr = ur[m * G + p], vi = ui[m * G + p];
      if (m + p > 0) take_max(best, best_k, vr * vr + vi * vi, k);
    }
  }
#pragma unroll
  for (int off = G / 2; off >= 1; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, best, off);
    const int ok = __shfl_xor_sync(0xffffffffu, best_k, off);
    take_max(best, best_k, om, ok);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
    scan_rows_kernel(Plane xr, Plane xi, const float* __restrict__ dr,
                     const float* __restrict__ di, const float2* __restrict__ twiddle, Out out,
                     Geom geo) {
  constexpr int G = N / kR;  // threads a window
  constexpr int kWindowsPerWarp = 32 / G;
  static_assert(N % kR == 0 && G >= 2 && G <= 8, "N in 32 / 64 / 128");

  __shared__ float2 tw_s[N];
  __shared__ float2 chirp_s[N];
  __shared__ float2 buf[kWarps][32 * kLaneStride];
  stage_tables<N>(dr, di, twiddle, geo, chirp_s, tw_s);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / G;  // window within the warp's tile
  const int t = lane % G;  // thread within the window
  float2 w_r[kR / 2];      // W_16^e
  float2 w_g[G / 2];       // W_G^e
#pragma unroll
  for (int e = 0; e < kR / 2; ++e) w_r[e] = tw_s[e * G];
#pragma unroll
  for (int e = 0; e < G / 2; ++e) w_g[e] = tw_s[e * kR];

  float2* my_buf = buf[warp];
  const long long sa = geo.osr * xr.elem_stride, sb = geo.osr * xi.elem_stride;
  const long long tiles = (geo.windows + kWindowsPerWarp - 1) / kWindowsPerWarp;
  const long long warp_stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long tile = static_cast<long long>(blockIdx.x) * kWarps + warp; tile < tiles;
       tile += warp_stride) {
    const long long gw = tile * kWindowsPerWarp + g;
    const bool live = gw < geo.windows;
    // a window past the end reads zeros: its bins are computed (the whole
    // warp takes part in the shuffles) and not written
    float ar[kR], ai[kR];
    if (live) {
      long long oa, ob;
      window_base(geo, gw, xr, xi, oa, ob);
      load_share<kR>(xr.p + oa + t * sa, G * sa, xi.p + ob + t * sb, G * sb, ar, ai);
    } else {
      zero_share<kR>(ar, ai);
    }
    float re[kR], im[kR];
    float bu, bd;
    int ku, kd;
    dechirp_share<false>(ar, ai, chirp_s + t, G, re, im);
    row_transform<N>(re, im, tw_s, w_r, w_g, my_buf, lane, g, t, bu, ku);
    dechirp_share<true>(ar, ai, chirp_s + t, G, re, im);
    row_transform<N>(re, im, tw_s, w_r, w_g, my_buf, lane, g, t, bd, kd);
    if (live && t == 0) write_out(out, gw, ku, bu, kd, bd);
  }
}

// ---------------------------------------------------------------------------
// N = 256 .. 4096: N / 16 threads a window, 4096 / N windows a block
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
  static constexpr int BUF = W * (S1W > S2W ? S1W : S2W);  // float2 a direction
  static constexpr size_t kSmem = 2 * BUF * sizeof(float2);
  static_assert(N >= 256 && N <= 4096 && L >= 1 && W >= 1, "N in 256 .. 4096");
};

// Pass 1 of one direction: dechirp the share, the 16-point FFT over j, the
// twiddles W_N^(t*k1), into S1.
template <bool kDown, int N>
__device__ __forceinline__ void block_pass1(const float (&ar)[kR], const float (&ai)[kR],
                                            const float* dr, const float* di, long long cs,
                                            const float2* __restrict__ twiddle,
                                            const float2 (&w16)[kR / 2], float2* s1, int t) {
  using D = Block<N>;
  float re[kR], im[kR];
  dechirp_share_ldg<kDown>(ar, ai, dr, di, cs, re, im);
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

// Passes 2 (and, at L = 1, the argmax) of one direction. At L > 1 the
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

// Pass 3 of one direction (L > 1): the L-point FFTs over ta and the
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

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
    scan_block_kernel(Plane xr, Plane xi, const float* __restrict__ dr,
                      const float* __restrict__ di, const float2* __restrict__ twiddle, Out out,
                      Geom geo) {
  using D = Block<N>;
  constexpr int M = D::M, L = D::L;
  constexpr int kWarpsPerWindow = M >= 32 ? M / 32 : 1;
  extern __shared__ float2 smem[];
  float2* bu_s = smem;           // up-dechirp's S1 / S2
  float2* bd_s = smem + D::BUF;  // down-dechirp's
  __shared__ float red_v[2][kWarps];
  __shared__ int red_k[2][kWarps];

  const int lw = threadIdx.x / M;  // window within the tile
  const int t = threadIdx.x % M;   // thread within the window
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float2 w16[kR / 2];  // W_16^e = W_N^(e*M)
#pragma unroll
  for (int e = 0; e < kR / 2; ++e) w16[e] = __ldg(twiddle + e * M);
  constexpr int kLHalf = L / 2 > 0 ? L / 2 : 1;
  float2 w_l[kLHalf];  // W_L^e = W_N^(e*N/L)
#pragma unroll
  for (int e = 0; e < L / 2; ++e) w_l[e] = __ldg(twiddle + e * (N / L));

  const long long sa = geo.osr * xr.elem_stride, sb = geo.osr * xi.elem_stride;
  const long long cs = static_cast<long long>(geo.osr) * M;  // chirp index stride over j
  const float* drt = dr + static_cast<long long>(t) * geo.osr + geo.dph;
  const float* dit = di + static_cast<long long>(t) * geo.osr + geo.dph;
  const long long tiles = (geo.windows + D::W - 1) / D::W;

  // the thread's share of a tile: samples t + M*j of its window (zeros
  // past the last window)
  auto load = [&](long long tile, float (&ar)[kR], float (&ai)[kR]) {
    const long long gw = tile * D::W + lw;
    if (gw < geo.windows) {
      long long oa, ob;
      window_base(geo, gw, xr, xi, oa, ob);
      load_share<kR>(xr.p + oa + t * sa, M * sa, xi.p + ob + t * sb, M * sb, ar, ai);
    } else {
      zero_share<kR>(ar, ai);
    }
  };

  float ar[kR], ai[kR];
  long long tile = blockIdx.x;
  if (tile < tiles) load(tile, ar, ai);
  for (; tile < tiles; tile += gridDim.x) {
    const long long gw = tile * D::W + lw;
    block_pass1<false, N>(ar, ai, drt, dit, cs, twiddle, w16, bu_s + lw * D::S1W, t);
    block_pass1<true, N>(ar, ai, drt, dit, cs, twiddle, w16, bd_s + lw * D::S1W, t);
    // the share is read: load the next tile's while the passes below run
    if (tile + gridDim.x < tiles) load(tile + gridDim.x, ar, ai);
    __syncthreads();  // S1 of both directions written

    float bu, bd;
    int ku, kd;
    block_pass2<N>(bu_s, lw, t, twiddle, w16, bu, ku);
    block_pass2<N>(bd_s, lw, t, twiddle, w16, bd, kd);
    if constexpr (L > 1) {
      __syncthreads();  // S2 of both directions written
      block_pass3<N>(bu_s, lw, t, w_l, bu, ku);
      block_pass3<N>(bd_s, lw, t, w_l, bd, kd);
    }
    warp_first_max<N>(bu, ku);
    warp_first_max<N>(bd, kd);
    if constexpr (kWarpsPerWindow > 1) {
      if (lane == 0) {
        red_v[0][warp] = bu;
        red_k[0][warp] = ku;
        red_v[1][warp] = bd;
        red_k[1][warp] = kd;
      }
      __syncthreads();  // the warps' maxima written; every buffer read
      if (t == 0) {
        const int w0 = warp;  // the window's first warp
#pragma unroll
        for (int i = 1; i < kWarpsPerWindow; ++i) {
          take_max(bu, ku, red_v[0][w0 + i], red_k[0][w0 + i]);
          take_max(bd, kd, red_v[1][w0 + i], red_k[1][w0 + i]);
        }
        if (gw < geo.windows) write_out(out, gw, ku, bu, kd, bd);
      }
    } else {
      if (t == 0 && gw < geo.windows) write_out(out, gw, ku, bu, kd, bd);
      __syncthreads();  // every buffer read before the next tile's pass 1
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int N>
constexpr auto kernel_for() {
  if constexpr (N <= 16)
    return scan_small_kernel<N>;
  else if constexpr (N <= 128)
    return scan_rows_kernel<N>;
  else
    return scan_block_kernel<N>;
}

// windows a block takes in one step of its loop
template <int N>
constexpr long long windows_per_block() {
  if constexpr (N <= 16)
    return kThreads;
  else if constexpr (N <= 128)
    return kWarps * 32 / (N / kR);
  else
    return Block<N>::W;
}

template <int N>
constexpr size_t dynamic_smem() {
  if constexpr (N <= 128)
    return 0;
  else
    return Block<N>::kSmem;
}

template <int N>
int launch(Plane xr, Plane xi, const float* dr, const float* di, const float2* twiddle, Out out,
           Geom geo, cudaStream_t stream) {
  static std::atomic<long long> cache[64];  // 0: not queried yet
  auto kernel = kernel_for<N>();
  constexpr size_t kSmem = dynamic_smem<N>();
  long long resident = 0;
  const cudaError_t err = resident_blocks(kernel, kThreads, kSmem, cache, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long needed = (geo.windows + windows_per_block<N>() - 1) / windows_per_block<N>();
  const long long blocks = needed < resident ? needed : resident;
  kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem, stream>>>(xr, xi, dr, di, twiddle,
                                                                      out, geo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xr, xi: the input planes, `rows` rows, row r sample c at
// p[r * row_stride + c * elem_stride] (elements), each row at least
// nwin * n * osr samples long; dr, di: the [n * osr] downchirp planes;
// twiddle: [n] complex f32 (cos, -sin)(2*pi*m/n); ub, db: [rows, nwin]
// int32 outputs (the up- and down-dechirp's first-max bins), up, dn:
// [rows, nwin] float32 (their peak powers). Window w of row r is samples
// w * n * osr + j * osr + dph (j < n). Launches on `stream` and returns
// the CUDA error code (0 on success); does not synchronise.
extern "C" int lora_scan(const float* xr, long long xr_row_stride, long long xr_elem_stride,
                         const float* xi, long long xi_row_stride, long long xi_elem_stride,
                         const float* dr, const float* di, const float* twiddle, int* ub,
                         int* db, float* up, float* dn, long long rows, long long nwin, int n,
                         int osr, int dph, void* stream) {
  if (osr < 1 || dph < 0 || dph >= osr || rows < 0 || nwin < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || nwin == 0) return 0;
  const Plane a{xr, xr_row_stride, xr_elem_stride}, b{xi, xi_row_stride, xi_elem_stride};
  const Out out{ub, db, up, dn};
  const Geom geo{rows * nwin, nwin, static_cast<long long>(n) * osr, osr, dph};
  const float2* tw = reinterpret_cast<const float2*>(twiddle);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4: return launch<4>(a, b, dr, di, tw, out, geo, s);
    case 8: return launch<8>(a, b, dr, di, tw, out, geo, s);
    case 16: return launch<16>(a, b, dr, di, tw, out, geo, s);
    case 32: return launch<32>(a, b, dr, di, tw, out, geo, s);
    case 64: return launch<64>(a, b, dr, di, tw, out, geo, s);
    case 128: return launch<128>(a, b, dr, di, tw, out, geo, s);
    case 256: return launch<256>(a, b, dr, di, tw, out, geo, s);
    case 512: return launch<512>(a, b, dr, di, tw, out, geo, s);
    case 1024: return launch<1024>(a, b, dr, di, tw, out, geo, s);
    case 2048: return launch<2048>(a, b, dr, di, tw, out, geo, s);
    case 4096: return launch<4096>(a, b, dr, di, tw, out, geo, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
