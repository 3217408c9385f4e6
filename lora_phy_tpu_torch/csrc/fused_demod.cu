// Fused dechirp-detection kernel for Hopper (sm_90a): per-row amplitude
// scale, CFO derotation, window, N-point FFT, |.|^2 and first-max argmax,
// one int32 bin per row. Bound to Python through a plain C interface
// (ctypes); see lora_phy_tpu_torch/ops/fused_demod.py for the wrapper and
// the plain PyTorch twin it is checked against.
//
// Replaces: lora_phy_tpu/ops/pallas_demod.py::_kernel (the Pallas/Mosaic
// kernel launched by fused_detect_rows), which derotates each row by
// exp(j*(start + rate*col)), runs the DFT as four real f32 matmuls against
// resident [N, N] cos / -sin tables with the window folded into the table
// rows, and takes min(where(mag == rowmax, col, N)). The JAX caller
// multiplies the rows by the per-frame amplitude scale first; here that
// multiply happens at load.
//
// What bounds it on an H100: at the bench shape (8 channels x 8192 frames
// x 66 symbols = 4.33 M rows of N = 128) the rows are 4.4 GB, read once,
// and one int32 per row is written: 1.34 ms at 3.35 TB/s. The FFT is
// 5 N log2 N = 4,480 flop per row (2.6e10 per call, 0.4 ms at the 67
// TFLOP/s f32 peak), so the function is bound by bytes; a dense
// [rows x N] x [N x N] product (8 N^2 flop per row) would instead be held
// by f32 FMA throughput at >= 8.5 ms.
//
// Design (N = 32, 64, 128; N = 4, 8 and 16 take fused_demod_small below,
// one thread per row through the same step 1, fft_dif and argmax rule):
// G = N / 16 threads per row, each holding R = 16 samples at
// stride G (n = t + G*j), so a warp covers 32 / G rows and every load
// instruction reads whole 32-byte sectors. With k = k1 + R*k2:
//   X[k1 + R*k2] = sum_t W_G^(t*k2) * W_N^(t*k1) * sum_j x[t + G*j] W_R^(j*k1)
// 1. at load: x * scale (rounded on its own), the phase start + rate*n,
//    full-precision sincosf (the phase reaches hundreds of radians, where
//    the __sinf intrinsics lose accuracy) and the rotation, all with
//    __fmul_rn / __fadd_rn so the derotated samples are the same floats as
//    the twin's; then the window;
// 2. an R-point radix-2 DIF FFT in registers over j (twiddles W_R);
// 3. the twiddles W_N^(t*k1);
// 4. a transpose of (re, im) pairs through shared memory within the warp
//    (stride 17 pairs per lane: no bank conflicts), after which thread t'
//    holds k1 = t' + G*m;
// 5. G-point DIF FFTs in registers over t (twiddles W_G);
// 6. |.|^2 and the first-max argmax on natural bin indices (the DIF
//    outputs are bit-reversed; the index map is compile-time), then a
//    shuffle reduction across the row's G lanes: larger value wins, a tie
//    goes to the smaller bin.
// All twiddles come from one [N] complex table built in numpy (double,
// cast to f32, exact 0 / +-1 at the quarter points), staged in shared
// memory. Warps walk the rows in a grid-stride loop, two blocks of eight
// warps per SM, each warp loading its next tile's samples into registers
// before it computes the current one, so the loads are in flight while
// the arithmetic runs. What is left above the bytes is instruction issue:
// sincosf (~25 instructions a sample, kept for bit-equal derotation) and
// the FFT. The kernel is instantiated with and without the window, so
// the main path (no window) issues none of its loads and multiplies; an
// absent scale is a scale of 1, which leaves every sample as it is.

#include <atomic>

#include <cuda_runtime.h>

#include "fft_rows.cuh"

namespace {

constexpr int kR = 16;        // samples (and bins) per thread
constexpr int kLaneStride = kR + 1;
constexpr int kWarps = 8;     // warps per block
constexpr int kThreads = 32 * kWarps;

// Step 1 for sample n (as an exact float) of a row: x * scale, rounded on
// its own as torch's yr * scale; the phase start + rate*n and its
// full-precision sincosf; the rotation and the window, each op rounded
// on its own, so the samples are the twin's floats.
template <bool kWindow>
__device__ __forceinline__ void load_step(float& re, float& im, float sc, float st, float rt,
                                          float n, float w) {
  const float a = __fmul_rn(re, sc);
  const float b = __fmul_rn(im, sc);
  const float ph = __fadd_rn(st, __fmul_rn(rt, n));
  float s, c;
  sincosf(ph, &s, &c);
  float fr = __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, s));
  float fi = __fadd_rn(__fmul_rn(a, s), __fmul_rn(b, c));
  if (kWindow) {
    fr = __fmul_rn(fr, w);
    fi = __fmul_rn(fi, w);
  }
  re = fr;
  im = fi;
}

template <int N, bool kWindow>
__global__ void __launch_bounds__(kThreads, 2)
fused_demod_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   const float* __restrict__ start, const float* __restrict__ rate,
                   const float* __restrict__ scale, const float* __restrict__ window,
                   const float2* __restrict__ twiddle, int* __restrict__ out,
                   long long rows) {
  constexpr int G = N / kR;        // threads per row
  constexpr int kRowsPerWarp = 32 / G;
  constexpr int kM = kR / G;       // G-point transforms per thread in step 5
  static_assert(N % kR == 0 && G >= 2 && G <= 32 && 32 % G == 0, "N in 32 / 64 / 128");

  __shared__ float2 tw_s[N];
  __shared__ float win_s[N];
  __shared__ float2 buf[kWarps][32 * kLaneStride];

  for (int i = threadIdx.x; i < N; i += kThreads) {
    tw_s[i] = twiddle[i];
    if (kWindow) win_s[i] = window[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / G;          // row within the warp's tile
  const int t = lane % G;          // thread within the row
  const float t_f = static_cast<float>(t);

  float2 w_r[kR / 2];              // W_R^e
  float2 w_g[G / 2];               // W_G^e
#pragma unroll
  for (int e = 0; e < kR / 2; ++e) w_r[e] = tw_s[e * G];
#pragma unroll
  for (int e = 0; e < G / 2; ++e) w_g[e] = tw_s[e * kR];

  float2* my_buf = buf[warp];
  const long long tiles = (rows + kRowsPerWarp - 1) / kRowsPerWarp;
  const long long warp_stride = static_cast<long long>(gridDim.x) * kWarps;

  // the raw samples of the warp's next tile, loaded one tile ahead so
  // that the loads are in flight while the current tile computes
  float next_r[kR], next_i[kR];
#pragma unroll
  for (int j = 0; j < kR; ++j) next_r[j] = next_i[j] = 0.0f;
  long long tile = static_cast<long long>(blockIdx.x) * kWarps + warp;
  {
    const long long row = tile * kRowsPerWarp + g;
    if (row < rows) {
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        next_r[j] = __ldg(xr + row * N + t + G * j);
        next_i[j] = __ldg(xi + row * N + t + G * j);
      }
    }
  }

  for (; tile < tiles; tile += warp_stride) {
    const long long row = tile * kRowsPerWarp + g;
    const bool live = row < rows;
    // a row past the end keeps the previous tile's finite samples: its
    // bin is computed and not written
    float re[kR], im[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      re[j] = next_r[j];
      im[j] = next_i[j];
    }
    const long long next_row = row + warp_stride * kRowsPerWarp;
    if (next_row < rows) {
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        next_r[j] = __ldg(xr + next_row * N + t + G * j);
        next_i[j] = __ldg(xi + next_row * N + t + G * j);
      }
    }

    // 1. scale, derotate, window: sample n = t + G*j
    if (live) {
      const float st = start[row];
      const float rt = rate[row];
      const float sc = scale != nullptr ? scale[row] : 1.0f;
#pragma unroll
      for (int j = 0; j < kR; ++j)
        // n = t + G*j as a float, exactly (t_f + G*j is an integer < 2^24)
        load_step<kWindow>(re[j], im[j], sc, st, rt, t_f + static_cast<float>(G * j),
                           win_s[t + G * j]);
    }

    // 2. R-point FFT over j; position p holds k1 = bit_reverse(p)
    fft_dif<kR, 0, kR>(re, im, w_r);

    // 3. twiddles W_N^(t*k1), and 4. the transpose: lane writes k1 in
    // natural order at lane*17 + k1
    __syncwarp();
#pragma unroll
    for (int p = 0; p < kR; ++p) {
      constexpr int kBits = log2i(kR);
      const int k1 = bit_reverse(p, kBits);
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
    // thread t' now takes k1 = t' + G*m (m < kM) from the row's G lanes
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

    // 5. G-point FFTs over t; position m*G + p holds k2 = bit_reverse(p)
    fft_each<G, kM, kR>(ur, ui, w_g);

    // 6. |.|^2 and the first-max argmax on natural bins k1 + R*k2
    float best = ur[0] * ur[0] + ui[0] * ui[0];
    int best_k = t;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
#pragma unroll
      for (int p = 0; p < G; ++p) {
        constexpr int kBits = log2i(G);
        const int k = t + G * m + kR * bit_reverse(p, kBits);
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
    if (live && t == 0) out[row] = best_k;
  }
}

// step 1 (load_step) for samples J.. of a row held in registers; the
// recursion keeps every array index a compile-time constant, so the arrays
// stay in registers whatever the unroller decides
template <bool kWindow, int N, int J = 0>
__device__ __forceinline__ void load_steps(float (&re)[N], float (&im)[N], float sc, float st,
                                           float rt, const float (&win)[N]) {
  if constexpr (J < N) {
    load_step<kWindow>(re[J], im[J], sc, st, rt, static_cast<float>(J), win[J]);
    load_steps<kWindow, N, J + 1>(re, im, sc, st, rt, win);
  }
}

// One thread's whole row: step 1, fft_dif<N> and the first-max argmax over
// the natural bins (position p holds bin bit_reverse(p); the scan meets the
// bins in natural order, so a strict > keeps the first maximum)
template <bool kWindow, int N>
__device__ __forceinline__ int decide_row(float (&re)[N], float (&im)[N], float sc, float st,
                                          float rt, const float (&win)[N],
                                          const float2 (&w)[N / 2]) {
  load_steps<kWindow>(re, im, sc, st, rt, win);
  fft_dif<N, 0, N>(re, im, w);
  float best = re[0] * re[0] + im[0] * im[0];
  int best_k = 0;
  scan_bins<N>(re, im, best, best_k);
  return best_k;
}

// N = 4, 8 and 16 (SF2-4): one thread per row. The thread loads the row's
// N samples into registers with float4 loads and decides it there
// (decide_row): no transpose, no shuffle. A warp reads 32 whole rows
// (N <= 16 floats each). On an H100 (PERF.md section 6) a first version,
// with unrolled loops in place of decide_row's recursion, reached 0.84
// and 0.88 of the bytes bound at N = 4 and 16 but 0.343 at N = 8, where
// the loops left the row's arrays in local memory (a 96-byte stack frame,
// 38 local loads and 38 local stores in the SASS against none at N = 4;
// tools/torch_kernel_resources.py). With the arrays in registers N = 8
// reaches about 0.89 of its bound: the loads' 32-byte stride a lane costs
// little once a row's two float4 loads are issued back to back. A
// variant that staged a warp's 32 rows through shared memory by cp.async,
// one tile ahead, was 3-4 % slower than this one in turns on one card
// and was dropped.
template <int N, bool kWindow>
__global__ void __launch_bounds__(kThreads)
fused_demod_small(const float* __restrict__ xr, const float* __restrict__ xi,
                  const float* __restrict__ start, const float* __restrict__ rate,
                  const float* __restrict__ scale, const float* __restrict__ window,
                  const float2* __restrict__ twiddle, int* __restrict__ out, long long rows) {
  static_assert(N == 4 || N == 8 || N == 16, "N in 4 / 8 / 16");
  __shared__ float2 tw_s[N];
  __shared__ float win_s[N];
  for (int i = threadIdx.x; i < N; i += kThreads) {
    tw_s[i] = twiddle[i];
    if (kWindow) win_s[i] = window[i];
  }
  __syncthreads();
  float2 w[N / 2];  // W_N^e
#pragma unroll
  for (int e = 0; e < N / 2; ++e) w[e] = tw_s[e];

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       row < rows; row += stride) {
    float re[N], im[N];
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(xr + row * N) + q);
      const float4 b = __ldg(reinterpret_cast<const float4*>(xi + row * N) + q);
      re[4 * q] = a.x, re[4 * q + 1] = a.y, re[4 * q + 2] = a.z, re[4 * q + 3] = a.w;
      im[4 * q] = b.x, im[4 * q + 1] = b.y, im[4 * q + 2] = b.z, im[4 * q + 3] = b.w;
    }
    const float st = start[row];
    const float rt = rate[row];
    const float sc = scale != nullptr ? scale[row] : 1.0f;
    out[row] = decide_row<kWindow>(re, im, sc, st, rt, win_s, w);
  }
}

// The kernel of N: one thread per row at N <= 16, G = N / 16 above.
template <int N, bool kWindow>
constexpr auto kernel_for() {
  if constexpr (N <= 16)
    return fused_demod_small<N, kWindow>;
  else
    return fused_demod_kernel<N, kWindow>;
}

template <int N>
constexpr int rows_per_block() {
  if constexpr (N <= 16)
    return kThreads;
  else
    return kWarps * 32 / (N / kR);
}

template <int N, bool kWindow>
int launch_variant(const float* xr, const float* xi, const float* start, const float* rate,
                   const float* scale, const float* window, const float2* twiddle, int* out,
                   long long rows, cudaStream_t stream) {
  static std::atomic<long long> cache[64];  // 0: not queried yet
  constexpr int kRowsPerBlock = rows_per_block<N>();
  auto kernel = kernel_for<N, kWindow>();
  long long resident = 0;
  const cudaError_t err = resident_blocks(kernel, kThreads, 0, cache, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long needed = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long blocks = needed < resident ? needed : resident;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      xr, xi, start, rate, scale, window, twiddle, out, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch(const float* xr, const float* xi, const float* start, const float* rate,
           const float* scale, const float* window, const float2* twiddle, int* out,
           long long rows, cudaStream_t stream) {
  if (window != nullptr)
    return launch_variant<N, true>(xr, xi, start, rate, scale, window, twiddle, out, rows,
                                   stream);
  return launch_variant<N, false>(xr, xi, start, rate, scale, window, twiddle, out, rows,
                                  stream);
}

}  // namespace

// xr, xi: [rows, n] f32; start, rate: [rows] f32; scale: [rows] f32 or
// null (no amplitude scale); window: [n] f32 or null; twiddle: [n]
// complex f32 (cos, -sin)(2*pi*m/n); out: [rows] int32. Launches on
// `stream` and returns the CUDA error code (0 on success); does not
// synchronise.
extern "C" int lora_fused_demod(const float* xr, const float* xi, const float* start,
                                const float* rate, const float* scale, const float* window,
                                const float* twiddle, int* out, long long rows, int n,
                                void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* tw = reinterpret_cast<const float2*>(twiddle);
  switch (n) {
    case 4: return launch<4>(xr, xi, start, rate, scale, window, tw, out, rows, s);
    case 8: return launch<8>(xr, xi, start, rate, scale, window, tw, out, rows, s);
    case 16: return launch<16>(xr, xi, start, rate, scale, window, tw, out, rows, s);
    case 32: return launch<32>(xr, xi, start, rate, scale, window, tw, out, rows, s);
    case 64: return launch<64>(xr, xi, start, rate, scale, window, tw, out, rows, s);
    case 128: return launch<128>(xr, xi, start, rate, scale, window, tw, out, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* lora_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
