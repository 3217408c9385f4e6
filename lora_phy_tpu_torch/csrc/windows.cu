// Shifted symbol windows for Hopper (sm_90a): the demodulator's guarded
// per-symbol timing shift of both (re, im) planes in one pass. Bound to
// Python through a plain C interface (ctypes); see
// lora_phy_tpu_torch/ops/windows.py for the wrapper and the plain PyTorch
// twin it is checked against.
//
// Replaces no TPU kernel: the JAX twin (lora_phy_tpu/models/modem.py
// _shifted_symbol_gather) is a pad, an index gather and a select in jnp,
// which XLA fuses. In eager PyTorch the same code pads each plane, builds
// an int64 index as large as the plane, gathers and selects: about seven
// passes over each plane.
//
// What it computes, for row r of `length` = S * step samples (step = n *
// osr), symbol s and bin i, with t = t_off[r]:
//   shifted(s) = (t > 0 && s*step + t + step <= length) || (t < 0 && -t <= s*step)
//   out[r, s, i] = x[r, s*step + i*osr + dec_phase + (shifted(s) ? d : 0)],
// zero where that index leaves [0, length). d is the start of the twin's
// slice of the row padded by `step` zeros on both sides, less the pad:
// start = t + step, plus the padded length if negative, clamped into
// [0, 2*step] (the JAX twin's dynamic_slice for offsets beyond one
// symbol). The guard is evaluated in 32-bit wrapping arithmetic, as the
// twin's int32 tensors evaluate it. A pure copy with zero fill: the planes
// equal the twin's bit for bit.
//
// What bounds it on an H100: 4 bytes read and 4 written a window sample a
// plane (t_off is 4 bytes a row). At the bulk decoder's shape (8 x 8192
// frames x 52 symbols x 128, 436.2 M samples a plane) that is 6.98 GB,
// 2.08 ms at 3.35 TB/s; there is no arithmetic to speak of.
//
// Design: a block covers kChunk consecutive outputs of one row (a row is
// split into ceil(S*n / kChunk) chunks); it reads the row's t_off once and
// each thread finds the guard and the source of its kUnroll outputs in
// registers, so there is no index tensor, no padded copy and no select.
// Neighbouring threads take neighbouring outputs: at osr 1 a symbol's n
// outputs are one contiguous source run at any offset, so both the loads
// and the stores of a warp are coalesced whatever the shift (a misaligned
// run costs one more 32-byte sector, which the L2 serves to the next
// warp). At osr > 1 the loads are strided by osr, as the twin's are. Every
// thread issues all its loads of both planes before its first store. The
// inputs are read through their row and element strides (a slice of longer
// rows, a complex tensor's .real / .imag view) and never written; the
// outputs are new contiguous [rows, S, n] planes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kChunk = kThreads * kUnroll;
constexpr long long kMaxBlocks = 0x7fffffff;

struct Plane {
  const float* p;
  long long row_stride;   // elements
  long long elem_stride;  // elements
};

// The twin's guard, in its int32 arithmetic (wrapping as the tensors do).
__device__ __forceinline__ bool shifted(int t, int base, int step, int length) {
  const int end = static_cast<int>(static_cast<unsigned>(base) + static_cast<unsigned>(t) +
                                   static_cast<unsigned>(step));
  const int neg = static_cast<int>(0u - static_cast<unsigned>(t));
  return (t > 0 && end <= length) || (t < 0 && neg <= base);
}

__global__ void __launch_bounds__(kThreads)
    shifted_windows_kernel(Plane xr, Plane xi, const int* __restrict__ t_off,
                           float* __restrict__ yr, float* __restrict__ yi, long long blocks,
                           int chunks, int row_len, int log2n, int step, int osr, int dec_phase,
                           int length) {
  const int mask = (1 << log2n) - 1;
  for (long long b = blockIdx.x; b < blocks; b += gridDim.x) {
    const long long row = b / chunks;
    const int first = static_cast<int>(b - row * chunks) * kChunk + threadIdx.x;
    const int t = __ldg(t_off + row);
    long long start = static_cast<long long>(t) + step;
    if (start < 0) start += length + 2LL * step;
    start = start < 0 ? 0 : (start > 2LL * step ? 2LL * step : start);
    const int d = static_cast<int>(start - step);
    const float* pr = xr.p + row * xr.row_stride;
    const float* pi = xi.p + row * xi.row_stride;
    float vr[kUnroll], vi[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int e = first + k * kThreads;
      vr[k] = 0.f;
      vi[k] = 0.f;
      if (e < row_len) {
        const int base = (e >> log2n) * step;
        const bool sh = shifted(t, base, step, length);
        const int src = base + (e & mask) * osr + dec_phase + (sh ? d : 0);
        if (!sh || (src >= 0 && src < length)) {
          vr[k] = pr[src * xr.elem_stride];
          vi[k] = pi[src * xi.elem_stride];
        }
      }
    }
    float* outr = yr + row * row_len;
    float* outi = yi + row * row_len;
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int e = first + k * kThreads;
      if (e < row_len) {
        outr[e] = vr[k];
        outi[e] = vi[k];
      }
    }
  }
}

}  // namespace

// xr, xi: the input planes, `rows` rows of at least total_symbols * n * osr
// samples, row r sample c at p[r * row_stride + c * elem_stride]
// (elements); t_off: [rows] int32, contiguous; yr, yi: [rows, total_symbols,
// n] contiguous outputs. n is a power of two, 0 <= dec_phase < osr, and a
// row's samples number under 2^31. Launches on `stream` and returns the
// CUDA error code (0 on success); does not synchronise.
extern "C" int lora_windows(const float* xr, long long xr_row_stride, long long xr_elem_stride,
                            const float* xi, long long xi_row_stride, long long xi_elem_stride,
                            const int* t_off, float* yr, float* yi, long long rows,
                            long long total_symbols, long long n, long long osr,
                            long long dec_phase, void* stream) {
  if (rows <= 0 || total_symbols <= 0) return 0;
  const long long step = n * osr;
  const long long length = total_symbols * step;
  if (n <= 0 || (n & (n - 1)) != 0 || osr <= 0 || dec_phase < 0 || dec_phase >= osr ||
      length + 2 * step >= 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int log2n = 0;
  while ((1LL << log2n) < n) ++log2n;
  const long long row_len = total_symbols * n;
  const long long chunks = (row_len + kChunk - 1) / kChunk;
  const long long blocks = rows * chunks;
  const unsigned grid = static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  shifted_windows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      Plane{xr, xr_row_stride, xr_elem_stride}, Plane{xi, xi_row_stride, xi_elem_stride}, t_off,
      yr, yi, blocks, static_cast<int>(chunks), static_cast<int>(row_len), log2n,
      static_cast<int>(step), static_cast<int>(osr), static_cast<int>(dec_phase),
      static_cast<int>(length));
  return static_cast<int>(cudaGetLastError());
}
