// Per-lane spectra of the gateway's circular block receiver for Hopper
// (sm_90a): for every lane (a candidate frame of one channel) its sync
// rows and its payload rows, each derotated by the lane's residual CFO at
// the true sample index (j - q) mod n of its section, an N-point FFT, |.|^2
// and the first-max bin; for the payload rows also the peak power and the
// row's power sum (the SNR estimate), and the FFT of the row as it is,
// before the derotation, with its first-max bin and the powers at that bin
// and its two circular neighbours (the clock-drift estimate). One pass:
// the payload row is read once for both transforms, and no [.., R, N]
// plane is written. Bound to Python through a plain C interface (ctypes);
// see lora_phy_tpu_torch/ops/lanes.py for the wrapper and the plain
// PyTorch twin it is checked against.
//
// Replaces no TPU kernel: the JAX twin (lora_phy_tpu/models/sync.py, the
// circular path's demod and clock-drift stages) is jnp products and the
// four-step DFT as matmuls, which XLA fuses. In eager PyTorch the same
// code is the rotation planes, four products and two sums a section, a
// cat, the torch four-step twice (the derotated rows and the raw payload
// rows), the whole |.|^2 planes, the argmaxes, maxima, sums and gathers.
//
// What bounds it on an H100: the sync and payload rows read once, 8 bytes
// a sample, and a few values a row written. At the SF12 gateway cell's
// shape (1,024 lanes of 2 sync and 32 payload rows of 4096) that is
// 1.14 GB, 0.34 ms at 3.35 TB/s; the 66 FFTs a lane are 5 N log2 N flops
// each (1.7e10, 0.25 ms at the 67 TFLOP/s f32 peak), so the bytes bound
// it, and instruction issue comes next.
//
// Arithmetic: exact float32, the twin's floats up to the FFT. The true
// index is idx = j - q + (j < q ? n : 0) in integers, as the twin takes
// it; the phase rate * idx (one rounding), its cosine and sine
// full-precision sincosf (never __sinf); the rotation rounds each product
// and each sum on its own (__fmul_rn, __fadd_rn, __fsub_rn, never
// contracted), as the eager twin's ops do:
//   fr = yr*c - yi*s,  fi = yr*s + yi*c
// The FFT differs from the twin's four-step only in rounding, so the bins
// agree except where two powers lie within float32 rounding of each other;
// so do the powers, and the sums also by their order. Ties go to the
// lowest natural bin (fft_rows.cuh take_max), as torch.argmax. No TF32,
// no bf16, no intrinsics of reduced precision.
//
// Design (N = 256 .. 4096, decide.cu's decide_block_kernel with scan.cu's
// two transforms of one load): N / 16 threads a row holding samples
// t + M*j, 4096 / N rows a block of 256 threads, the three radix-16 passes
// of fft_block.cuh with padded shared-memory transposes. A tile is row s
// of each of W = 4096 / N lanes; a block takes a contiguous run of tiles,
// s fastest, so a thread keeps its lane for R tiles and works out its 16
// rotation factors once a section (sync, then payload) in shared-memory
// slots that only it reads and writes. A payload tile runs both
// transforms of the same samples, each in a buffer of its own, between
// the same barriers. The last pass keeps each thread's 16 powers in
// registers: the first max, the sum, and after the row's first max is
// known, the powers of its two neighbours, written by the threads that
// hold them. Rows are read through the planes' lane, row and element
// strides, so the receiver's slices are read in place.

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

struct Lanes {
  const float* rate;  // [F] the derotation's radians a sample
  const int* q;       // [F] the sync rows' offset into their grid window, 0 <= q < n
  const int* qp;      // [F] the payload rows'
};

struct Out {
  int* bins;       // [F, RS + S] each derotated row's first-max bin
  float* peak;     // [F, S] the derotated payload rows' peak powers
  float* total;    // [F, S] their power sums
  int* sro_bin;    // [F, S] each raw payload row's first-max bin
  float* sro_pow;  // [F, S, 3] its powers at bin - 1, bin, bin + 1 (circular)
};

struct Geom {
  long long frames;  // F
  int sync_rows;     // RS
  int pay_rows;      // S
  long long tiles;   // ceil(F / W) * (RS + S)
};

// The thread's rotation factors for rate `rt` and section offset `qs`:
// sample i = t + M*j in rot[j * kThreads], (cos, sin)(rate * idx) at the
// true index idx = (i - qs) mod N, as the twin forms it.
template <int N>
__device__ __forceinline__ void make_rotation(float rt, int qs, int t, float2* rot) {
  constexpr int M = Block<N>::M;
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const int i = t + M * j;
    const int idx = i - qs + (i < qs ? N : 0);
    float s, c;
    sincosf(__fmul_rn(rt, static_cast<float>(idx)), &s, &c);
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

// The natural bin of power i of thread t after final_powers (i a
// compile-time constant once unrolled): k1 + 16*c at L = 1, else
// k1 + 16*c + 256*d with c = r + L*q.
template <int N>
__device__ __forceinline__ int bin_of(int t, int i) {
  constexpr int L = Block<N>::L;
  if constexpr (L == 1) {
    return t + kR * bit_reverse(i, log2i(kR));
  } else {
    const int k1 = t / L, r = t % L, q = i / L, p = i % L;
    return k1 + kR * (r + L * q) + 256 * bit_reverse(p, log2i(L));
  }
}

// The last pass of one transform with the thread's 16 powers kept in pw:
// at L = 1 pass 2's 16-point FFTs on S1 (fft_block.cuh block_pass2's
// argmax branch), else pass 3's L-point FFTs on S2 (block_pass3). The
// barrier before it is the caller's.
template <int N>
__device__ __forceinline__ void final_powers(const float2* s, int lw, int t,
                                             const float2 (&w16)[kR / 2],
                                             const float2 (&w_l)[Block<N>::L / 2 > 0
                                                                     ? Block<N>::L / 2
                                                                     : 1],
                                             float (&pw)[kR]) {
  using D = Block<N>;
  constexpr int L = D::L;
  float re[kR], im[kR];
  if constexpr (L == 1) {
    const float2* src = s + lw * D::S1W + t * D::S1R;
#pragma unroll
    for (int tb = 0; tb < kR; ++tb) {
      const float2 v = src[tb];
      re[tb] = v.x;
      im[tb] = v.y;
    }
    fft_dif<kR, 0, kR>(re, im, w16);
  } else {
    constexpr int Q = kR / L;
    const int k1 = t / L, r = t % L;
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
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) pw[i] = re[i] * re[i] + im[i] * im[i];
}

// The thread's first max over its powers.
template <int N>
__device__ __forceinline__ void thread_first_max(const float (&pw)[kR], int t, float& best,
                                                 int& best_k) {
  best = pw[0];
  best_k = bin_of<N>(t, 0);
#pragma unroll
  for (int i = 1; i < kR; ++i) take_max(best, best_k, pw[i], bin_of<N>(t, i));
}

// The sum across the row's lanes of the warp (warp_first_max's shuffles).
template <int N>
__device__ __forceinline__ float warp_sum(float v) {
  constexpr int M = Block<N>::M;
#pragma unroll
  for (int off = (M < 32 ? M : 32) / 2; off >= 1; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
    lanes_block_kernel(Rows sr, Rows si, Rows pr, Rows pi, Lanes lanes,
                       const float2* __restrict__ twiddle, Out out, Geom geo) {
  using D = Block<N>;
  constexpr int M = D::M, L = D::L;
  constexpr int kWarpsPerRow = M >= 32 ? M / 32 : 1;
  extern __shared__ float2 smem[];
  float2* buf_a = smem;                           // the derotated row's S1 / S2
  float2* buf_b = smem + D::BUF;                  // the raw payload row's
  float2* rot = smem + 2 * D::BUF + threadIdx.x;  // the thread's rotation slots
  __shared__ float red_v[2][kWarps];
  __shared__ int red_k[2][kWarps];
  __shared__ float red_s[kWarps];

  const int lw = threadIdx.x / M;  // lane within the tile
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

  const int rows = geo.sync_rows + geo.pay_rows;
  // tile -> (lane, row) of this thread's row; a lane past the last is not
  // live: its row reads zeros, and its values are computed and not written
  auto locate = [&](long long tile, long long& f, int& s) {
    const long long group = tile / rows;
    s = static_cast<int>(tile - group * rows);
    f = group * D::W + lw;
  };
  auto load = [&](long long tile, float (&ar)[kR], float (&ai)[kR]) {
    long long f;
    int s;
    locate(tile, f, s);
    if (f < geo.frames) {
      const bool pay = s >= geo.sync_rows;
      const Rows a = pay ? pr : sr;
      const Rows b = pay ? pi : si;
      const long long row = pay ? s - geo.sync_rows : s;
      load_share<kR>(a.p + f * a.frame_stride + row * a.row_stride + t * a.elem_stride,
                     M * a.elem_stride,
                     b.p + f * b.frame_stride + row * b.row_stride + t * b.elem_stride,
                     M * b.elem_stride, ar, ai);
    } else {
      zero_share<kR>(ar, ai);
    }
  };

  // the block's contiguous run of tiles
  const long long first = geo.tiles * blockIdx.x / gridDim.x;
  const long long last = geo.tiles * (blockIdx.x + 1) / gridDim.x;
  long long held = -1;  // 2 * lane + section of the rotation factors in the slots
  float ar[kR], ai[kR];
  if (first < last) load(first, ar, ai);
  for (long long tile = first; tile < last; ++tile) {
    long long f;
    int s;
    locate(tile, f, s);
    const bool live = f < geo.frames;
    const bool pay = s >= geo.sync_rows;  // the same for every row of the tile
    if (live && 2 * f + pay != held) {
      make_rotation<N>(__ldg(lanes.rate + f), __ldg((pay ? lanes.qp : lanes.q) + f), t, rot);
      held = 2 * f + pay;
    }
    {
      float re[kR], im[kR];
      derotate_share(ar, ai, rot, re, im);
      block_pass1_fft<N>(re, im, twiddle, w16, buf_a + lw * D::S1W, t);
    }
    if (pay) {
      float re[kR], im[kR];
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        re[j] = ar[j];
        im[j] = ai[j];
      }
      block_pass1_fft<N>(re, im, twiddle, w16, buf_b + lw * D::S1W, t);
    }
    // the share is read: load the next tile's while the passes below run
    if (tile + 1 < last) load(tile + 1, ar, ai);
    __syncthreads();  // S1 written

    if constexpr (L > 1) {
      float unused_v;
      int unused_k;
      block_pass2<N>(buf_a, lw, t, twiddle, w16, unused_v, unused_k);
      if (pay) block_pass2<N>(buf_b, lw, t, twiddle, w16, unused_v, unused_k);
      __syncthreads();  // S2 written
    }
    float best_a, sum_a = 0.0f;
    int k_a;
    {
      float pw[kR];
      final_powers<N>(buf_a, lw, t, w16, w_l, pw);
      thread_first_max<N>(pw, t, best_a, k_a);
#pragma unroll
      for (int i = 0; i < kR; ++i) sum_a += pw[i];
    }
    float pw_b[kR];
    float best_b = 0.0f;
    int k_b = 0;
    if (pay) {
      final_powers<N>(buf_b, lw, t, w16, w_l, pw_b);
      thread_first_max<N>(pw_b, t, best_b, k_b);
    }
    warp_first_max<N>(best_a, k_a);
    sum_a = warp_sum<N>(sum_a);
    if (pay) warp_first_max<N>(best_b, k_b);
    if constexpr (kWarpsPerRow > 1) {
      if (lane == 0) {
        red_v[0][warp] = best_a;
        red_k[0][warp] = k_a;
        red_s[warp] = sum_a;
        red_v[1][warp] = best_b;
        red_k[1][warp] = k_b;
      }
      __syncthreads();  // the warps' values written; every buffer read
      // every thread of the row combines its warps, in order
      const int w0 = lw * kWarpsPerRow;
      best_a = red_v[0][w0];
      k_a = red_k[0][w0];
      sum_a = red_s[w0];
      best_b = red_v[1][w0];
      k_b = red_k[1][w0];
#pragma unroll
      for (int i = 1; i < kWarpsPerRow; ++i) {
        take_max(best_a, k_a, red_v[0][w0 + i], red_k[0][w0 + i]);
        sum_a += red_s[w0 + i];
        take_max(best_b, k_b, red_v[1][w0 + i], red_k[1][w0 + i]);
      }
    } else {
      __syncthreads();  // every buffer read before the next tile's pass 1
    }
    if (live) {
      if (t == 0) out.bins[f * rows + s] = k_a;
      if (pay) {
        const long long o = f * geo.pay_rows + (s - geo.sync_rows);
        if (t == 0) {
          out.peak[o] = best_a;
          out.total[o] = sum_a;
          out.sro_bin[o] = k_b;
          out.sro_pow[3 * o + 1] = best_b;
        }
        // the neighbours' powers, from the threads that hold them
        const int kl = (k_b - 1) & (N - 1), kr = (k_b + 1) & (N - 1);
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const int k = bin_of<N>(t, i);
          if (k == kl) out.sro_pow[3 * o] = pw_b[i];
          if (k == kr) out.sro_pow[3 * o + 2] = pw_b[i];
        }
      }
    }
  }
}

template <int N>
int launch(Rows sr, Rows si, Rows pr, Rows pi, Lanes lanes, const float2* twiddle, Out out,
           long long frames, int sync_rows, int pay_rows, cudaStream_t stream) {
  static std::atomic<long long> cache[64];  // 0: not queried yet
  auto kernel = lanes_block_kernel<N>;
  // both transforms' buffers and every thread's 16 rotation slots
  constexpr size_t kSmem = (2 * Block<N>::BUF + kR * kThreads) * sizeof(float2);
  long long resident = 0;
  const cudaError_t err = resident_blocks(kernel, kThreads, kSmem, cache, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geom geo{frames, sync_rows, pay_rows,
                 (frames + Block<N>::W - 1) / Block<N>::W * (sync_rows + pay_rows)};
  const long long blocks = geo.tiles < resident ? geo.tiles : resident;
  kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem, stream>>>(sr, si, pr, pi, lanes,
                                                                      twiddle, out, geo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sr, si: the [frames, sync_rows, n] sync-row planes and pr, pi the
// [frames, pay_rows, n] payload-row planes, row s of lane f sample i at
// p[f * frame_stride + s * row_stride + i * elem_stride] (elements);
// rate: [frames] float32, the derotation's radians a sample; q, qp:
// [frames] int32 offsets of the sync and the payload rows into their grid
// windows (0 <= q < n); twiddle: [n] complex f32 (cos, -sin)(2*pi*m/n).
// Outputs: bins [frames, sync_rows + pay_rows] int32, each derotated row's
// first-max bin (the sync rows first); peak, total [frames, pay_rows]
// float32, the derotated payload rows' peak powers and power sums;
// sro_bin [frames, pay_rows] int32 and sro_pow [frames, pay_rows, 3]
// float32, each raw payload row's first-max bin and its powers at bin - 1,
// bin and bin + 1 (mod n). n in 256 .. 4096, a power of two. Launches on
// `stream` and returns the CUDA error code (0 on success); does not
// synchronise.
extern "C" int lora_lanes(const float* sr, long long sr_frame_stride, long long sr_row_stride,
                          long long sr_elem_stride, const float* si, long long si_frame_stride,
                          long long si_row_stride, long long si_elem_stride, const float* pr,
                          long long pr_frame_stride, long long pr_row_stride,
                          long long pr_elem_stride, const float* pi, long long pi_frame_stride,
                          long long pi_row_stride, long long pi_elem_stride, const float* rate,
                          const int* q, const int* qp, const float* twiddle, int* bins,
                          float* peak, float* total, int* sro_bin, float* sro_pow,
                          long long frames, int sync_rows, int pay_rows, int n, void* stream) {
  if (frames < 0 || sync_rows < 0 || pay_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (frames == 0 || sync_rows + pay_rows == 0) return 0;
  const Rows a{sr, sr_frame_stride, sr_row_stride, sr_elem_stride};
  const Rows b{si, si_frame_stride, si_row_stride, si_elem_stride};
  const Rows c{pr, pr_frame_stride, pr_row_stride, pr_elem_stride};
  const Rows d{pi, pi_frame_stride, pi_row_stride, pi_elem_stride};
  const Lanes lanes{rate, q, qp};
  const Out out{bins, peak, total, sro_bin, sro_pow};
  const float2* tw = reinterpret_cast<const float2*>(twiddle);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 256: return launch<256>(a, b, c, d, lanes, tw, out, frames, sync_rows, pay_rows, s);
    case 512: return launch<512>(a, b, c, d, lanes, tw, out, frames, sync_rows, pay_rows, s);
    case 1024: return launch<1024>(a, b, c, d, lanes, tw, out, frames, sync_rows, pay_rows, s);
    case 2048: return launch<2048>(a, b, c, d, lanes, tw, out, frames, sync_rows, pay_rows, s);
    case 4096: return launch<4096>(a, b, c, d, lanes, tw, out, frames, sync_rows, pay_rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
