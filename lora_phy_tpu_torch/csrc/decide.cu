// Per-symbol decision kernel of the exact float32 demodulator above
// N = 128, for Hopper (sm_90a): for every symbol row of the (re, im)
// window planes, the derotation exp(j*rate*i) with the frame's amplitude
// scale and the window folded in, an N-point FFT, |.|^2 and the first-max
// argmax, in one pass. Per row it writes one int32 bin; no [.., S, N]
// plane is written. Bound to Python through a plain C interface (ctypes);
// see lora_phy_tpu_torch/ops/decide.py for the wrapper and the plain
// PyTorch twin it is checked against.
//
// Replaces no TPU kernel: the JAX twin (lora_phy_tpu/ops/planar.py
// demodulate_planar, precision "f32") is the derotation's products and the
// four-step DFT as matmuls, which XLA fuses. In eager PyTorch the same code
// is the rotation planes, four products and two sums over [.., S, N]
// planes, the four-step's cats, transposes and two f32 GEMMs, and the
// argmax's reorder.
//
// What bounds it on an H100: both planes read once, 8 bytes a sample, and
// 4 bytes a row written. At the SF12 bulk cell's shape (106,496 rows of
// 4096) that is 3.49 GB, 1.04 ms at 3.35 TB/s; the FFT is 5 N log2 N flops
// a row (2.6e10, 0.39 ms at the 67 TFLOP/s f32 peak), so the bytes bound
// it, and instruction issue comes next.
//
// Arithmetic: exact float32, the twin's floats up to the FFT. The phase is
// rate * i (one rounding), its cosine and sine full-precision sincosf
// (never __sinf), times the scale, then times the window, each rounded;
// the rotation rounds each product and each sum on its own (__fmul_rn,
// __fadd_rn, __fsub_rn, never contracted), as the eager twin's ops do:
//   fr = yr*c - yi*s,  fi = yr*s + yi*c
// The FFT differs from the twin's four-step only in rounding, so the bins
// agree except where two powers lie within float32 rounding of each other.
// Ties go to the lowest natural bin (fft_rows.cuh take_max). No TF32, no
// bf16, no intrinsics of reduced precision.
//
// Design (N = 256 .. 4096, scan.cu's scan_block_kernel with one transform
// a row in place of two): N / 16 threads a row holding samples t + M*j,
// 4096 / N rows a block of 256 threads, the three radix-16 passes of
// fft_block.cuh with padded shared-memory transposes, a shuffle first-max
// and one across warps. A tile is one row of each of W = 4096 / N frames,
// the same symbol s; a block takes a contiguous run of tiles, s fastest,
// so a thread keeps its frame for S tiles and works out its 16 rotation
// factors once a frame. They live in shared memory, in slots only their
// own thread reads and writes (no barrier): with the next tile's samples
// in registers, in flight during the current tile's passes 2 and 3, 32
// more registers a thread would cost the second block an SM. Rows are
// read through the planes' frame, row and element strides, so strided
// window views are read in place.

#include <atomic>

#include <cuda_runtime.h>

#include "fft_block.cuh"
#include "fft_rows.cuh"

namespace {

struct Rows {
  const float* p;
  long long frame_stride;  // elements
  long long row_stride;    // elements
  long long elem_stride;   // elements
};

struct Geom {
  long long frames;  // F
  long long rows;    // S, rows a frame
  long long tiles;   // ceil(F / W) * S
};

// The thread's rotation factors of frame rate `rt`, scale `sc` (1 for
// none: a product by 1 is exact) and the window (when not null), sample
// t + M*j in rot[j * kThreads]: (cos, sin)(rate * i), times the scale,
// then times the window, each product rounded.
template <int M>
__device__ __forceinline__ void make_rotation(float rt, float sc, const float* __restrict__ window,
                                              int t, float2* rot) {
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const int i = t + M * j;
    float s, c;
    sincosf(__fmul_rn(rt, static_cast<float>(i)), &s, &c);
    c = __fmul_rn(c, sc);
    s = __fmul_rn(s, sc);
    if (window != nullptr) {
      const float w = __ldg(window + i);
      c = __fmul_rn(c, w);
      s = __fmul_rn(s, w);
    }
    rot[j * kThreads] = make_float2(c, s);
  }
}

// The derotation of a thread's share by its rotation factors.
__device__ __forceinline__ void derotate_share(const float (&ar)[kR], const float (&ai)[kR],
                                               const float2* rot, float (&re)[kR],
                                               float (&im)[kR]) {
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const float2 r = rot[j * kThreads];
    re[j] = __fsub_rn(__fmul_rn(ar[j], r.x), __fmul_rn(ai[j], r.y));
    im[j] = __fadd_rn(__fmul_rn(ar[j], r.y), __fmul_rn(ai[j], r.x));
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
    decide_block_kernel(Rows xr, Rows xi, const float* __restrict__ rate,
                        const float* __restrict__ scale, const float* __restrict__ window,
                        const float2* __restrict__ twiddle, int* __restrict__ out, Geom geo) {
  using D = Block<N>;
  constexpr int M = D::M, L = D::L;
  constexpr int kWarpsPerRow = M >= 32 ? M / 32 : 1;
  extern __shared__ float2 smem[];
  float2* buf = smem;                            // S1 / S2
  float2* rot = smem + D::BUF + threadIdx.x;     // the thread's rotation slots
  __shared__ float red_v[kWarps];
  __shared__ int red_k[kWarps];

  const int lw = threadIdx.x / M;  // frame within the tile
  const int t = threadIdx.x % M;   // thread within the row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float2 w16[kR / 2];  // W_16^e = W_N^(e*M)
#pragma unroll
  for (int e = 0; e < kR / 2; ++e) w16[e] = __ldg(twiddle + e * M);
  constexpr int kLHalf = L / 2 > 0 ? L / 2 : 1;
  float2 w_l[kLHalf];  // W_L^e = W_N^(e*N/L)
#pragma unroll
  for (int e = 0; e < L / 2; ++e) w_l[e] = __ldg(twiddle + e * (N / L));

  // tile -> (frame, symbol) of this thread's row; a frame past the last is
  // not live: its row reads zeros, and its bin is computed and not written
  auto locate = [&](long long tile, long long& f, long long& s) {
    const long long group = tile / geo.rows;
    s = tile - group * geo.rows;
    f = group * D::W + lw;
  };
  auto load = [&](long long tile, float (&ar)[kR], float (&ai)[kR]) {
    long long f, s;
    locate(tile, f, s);
    if (f < geo.frames) {
      load_share<kR>(xr.p + f * xr.frame_stride + s * xr.row_stride + t * xr.elem_stride,
                     M * xr.elem_stride,
                     xi.p + f * xi.frame_stride + s * xi.row_stride + t * xi.elem_stride,
                     M * xi.elem_stride, ar, ai);
    } else {
      zero_share<kR>(ar, ai);
    }
  };

  // the block's contiguous run of tiles
  const long long first = geo.tiles * blockIdx.x / gridDim.x;
  const long long last = geo.tiles * (blockIdx.x + 1) / gridDim.x;
  long long held = -1;  // the frame whose rotation factors the slots hold
  float ar[kR], ai[kR];
  if (first < last) load(first, ar, ai);
  for (long long tile = first; tile < last; ++tile) {
    long long f, s;
    locate(tile, f, s);
    const bool live = f < geo.frames;
    if (live && f != held) {
      make_rotation<M>(__ldg(rate + f), scale != nullptr ? __ldg(scale + f) : 1.0f, window, t,
                       rot);
      held = f;
    }
    float re[kR], im[kR];
    derotate_share(ar, ai, rot, re, im);
    block_pass1_fft<N>(re, im, twiddle, w16, buf + lw * D::S1W, t);
    // the share is read: load the next tile's while the passes below run
    if (tile + 1 < last) load(tile + 1, ar, ai);
    __syncthreads();  // S1 written

    float best;
    int best_k;
    block_pass2<N>(buf, lw, t, twiddle, w16, best, best_k);
    if constexpr (L > 1) {
      __syncthreads();  // S2 written
      block_pass3<N>(buf, lw, t, w_l, best, best_k);
    }
    warp_first_max<N>(best, best_k);
    if constexpr (kWarpsPerRow > 1) {
      if (lane == 0) {
        red_v[warp] = best;
        red_k[warp] = best_k;
      }
      __syncthreads();  // the warps' maxima written; the buffer read
      if (t == 0) {
#pragma unroll
        for (int i = 1; i < kWarpsPerRow; ++i)
          take_max(best, best_k, red_v[warp + i], red_k[warp + i]);
        if (live) out[f * geo.rows + s] = best_k;
      }
    } else {
      if (t == 0 && live) out[f * geo.rows + s] = best_k;
      __syncthreads();  // the buffer read before the next tile's pass 1
    }
  }
}

template <int N>
int launch(Rows xr, Rows xi, const float* rate, const float* scale, const float* window,
           const float2* twiddle, int* out, long long frames, long long rows,
           cudaStream_t stream) {
  static std::atomic<long long> cache[64];  // 0: not queried yet
  auto kernel = decide_block_kernel<N>;
  // the transform's buffer and every thread's 16 rotation slots
  constexpr size_t kSmem = (Block<N>::BUF + kR * kThreads) * sizeof(float2);
  long long resident = 0;
  const cudaError_t err = resident_blocks(kernel, kThreads, kSmem, cache, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geom geo{frames, rows, (frames + Block<N>::W - 1) / Block<N>::W * rows};
  const long long blocks = geo.tiles < resident ? geo.tiles : resident;
  kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem, stream>>>(xr, xi, rate, scale, window,
                                                                      twiddle, out, geo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xr, xi: the [frames, rows, n] window planes, row s of frame f sample i at
// p[f * frame_stride + s * row_stride + i * elem_stride] (elements); rate:
// [frames] float32, the derotation's radians a sample; scale: [frames]
// float32 amplitude scales, or null for none; window: [n] float32, or null
// for none; twiddle: [n] complex f32 (cos, -sin)(2*pi*m/n); out:
// [frames, rows] int32, each row's first-max bin. n in 256 .. 4096, a power
// of two. Launches on `stream` and returns the CUDA error code (0 on
// success); does not synchronise.
extern "C" int lora_decide(const float* xr, long long xr_frame_stride, long long xr_row_stride,
                           long long xr_elem_stride, const float* xi, long long xi_frame_stride,
                           long long xi_row_stride, long long xi_elem_stride, const float* rate,
                           const float* scale, const float* window, const float* twiddle,
                           int* out, long long frames, long long rows, int n, void* stream) {
  if (frames < 0 || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (frames == 0 || rows == 0) return 0;
  const Rows a{xr, xr_frame_stride, xr_row_stride, xr_elem_stride};
  const Rows b{xi, xi_frame_stride, xi_row_stride, xi_elem_stride};
  const float2* tw = reinterpret_cast<const float2*>(twiddle);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 256: return launch<256>(a, b, rate, scale, window, tw, out, frames, rows, s);
    case 512: return launch<512>(a, b, rate, scale, window, tw, out, frames, rows, s);
    case 1024: return launch<1024>(a, b, rate, scale, window, tw, out, frames, rows, s);
    case 2048: return launch<2048>(a, b, rate, scale, window, tw, out, frames, rows, s);
    case 4096: return launch<4096>(a, b, rate, scale, window, tw, out, frames, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
