// Planar dechirp kernel for Hopper (sm_90a): every symbol period of the
// (re, im) planes times the base downchirp, in one pass. Bound to Python
// through a plain C interface (ctypes); see lora_phy_tpu_torch/ops/dechirp.py
// for the wrapper and the plain PyTorch twin it is checked against.
//
// Replaces no TPU kernel: the JAX twin (lora_phy_tpu/ops/planar.py
// dechirp_planar) is four products and two sums in jnp, which XLA fuses
// into one loop. In eager PyTorch the same expression is six passes, each
// with a temporary plane.
//
// What bounds it on an H100: 8 bytes read and 8 written a sample (both
// planes in, both out; the [step] downchirp table stays in L1 / L2). At the
// bulk decoder's shape (8 x 8192 frames x 6,656 samples, 436.2 M samples a
// plane) that is 6.98 GB, 2.08 ms at 3.35 TB/s; the arithmetic is 6 flop a
// sample. The kernel meets the bound with one pass and no temporaries.
//
// Each product and each sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, which nvcc never contracts into an FMA), exactly as the
// eager ops round them:
//   yr = xr * dr - xi * di,  yi = xr * di + xi * dr,
// so the planes are the twin's bit for bit.
//
// Design: one thread a float4 of each plane, 256-thread blocks, 64-bit
// indices, neighbouring threads on neighbouring addresses. That takes both
// inputs at unit element stride, with row strides and bases on 16-byte
// boundaries (the row length, a multiple of the step, is a multiple of 4
// by construction); the row of a vector is found by a division only where
// a row stride differs from the row length (a slice of longer rows). Every
// other input (a complex tensor's .real / .imag view, an offset view)
// takes the scalar path, one thread a sample. The outputs are new
// contiguous [rows, length] planes; the inputs are never written.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 0x7fffffff;

struct Plane {
  const float* p;
  long long row_stride;   // elements
  long long elem_stride;  // elements
};

__device__ __forceinline__ void rotate(float xr, float xi, float dr, float di, float& yr,
                                       float& yi) {
  yr = __fsub_rn(__fmul_rn(xr, dr), __fmul_rn(xi, di));
  yi = __fadd_rn(__fmul_rn(xr, di), __fmul_rn(xi, dr));
}

// kDense: both inputs' rows are the contiguous length (row stride ==
// length), so vector v of the flat output is vector v of each input.
template <bool kDense>
__global__ void __launch_bounds__(kThreads)
    dechirp_vec_kernel(const float4* __restrict__ xr, const float4* __restrict__ xi,
                       long long rs_r, long long rs_i, const float4* __restrict__ dr,
                       const float4* __restrict__ di, float4* __restrict__ yr,
                       float4* __restrict__ yi, long long vecs, long long row_vecs,
                       long long step_vecs) {
  // a step of 2^k vectors (every osr that is a power of two) takes a mask
  const long long mask = (step_vecs & (step_vecs - 1)) == 0 ? step_vecs - 1 : -1;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; v < vecs;
       v += stride) {
    long long ar = v, ai = v, c = v;
    if (!kDense) {
      const long long row = v / row_vecs;
      c = v - row * row_vecs;
      ar = row * rs_r + c;
      ai = row * rs_i + c;
    }
    const float4 a = xr[ar];
    const float4 b = xi[ai];
    const long long t = mask >= 0 ? (c & mask) : c % step_vecs;
    const float4 cr = __ldg(dr + t);
    const float4 ci = __ldg(di + t);
    float4 outr, outi;
    rotate(a.x, b.x, cr.x, ci.x, outr.x, outi.x);
    rotate(a.y, b.y, cr.y, ci.y, outr.y, outi.y);
    rotate(a.z, b.z, cr.z, ci.z, outr.z, outi.z);
    rotate(a.w, b.w, cr.w, ci.w, outr.w, outi.w);
    yr[v] = outr;
    yi[v] = outi;
  }
}

__global__ void __launch_bounds__(kThreads)
    dechirp_scalar_kernel(Plane xr, Plane xi, const float* __restrict__ dr,
                          const float* __restrict__ di, float* __restrict__ yr,
                          float* __restrict__ yi, long long total, long long length,
                          long long step) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j < total;
       j += stride) {
    const long long row = j / length;
    const long long c = j - row * length;
    const float a = xr.p[row * xr.row_stride + c * xr.elem_stride];
    const float b = xi.p[row * xi.row_stride + c * xi.elem_stride];
    const long long t = c % step;
    rotate(a, b, __ldg(dr + t), __ldg(di + t), yr[j], yi[j]);
  }
}

// One thread a vector (or a sample): a grid of every block the work needs,
// up to the grid's limit, past which the loops stride. On an H100 at the
// bulk shape this reaches 0.905 of the bytes bound, as torch's copy of
// both planes does; one resident wave walking a grid-stride loop reached
// 0.85.
unsigned blocks_for(long long work) {
  const long long needed = (work + kThreads - 1) / kThreads;
  return static_cast<unsigned>(needed < kMaxBlocks ? needed : kMaxBlocks);
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15u) == 0; }

}  // namespace

// xr, xi: the input planes, `rows` rows of `length` samples, row r sample
// c at p[r * row_stride + c * elem_stride] (elements); dr, di: the [step]
// downchirp planes; yr, yi: [rows, length] contiguous outputs. `length`
// is a multiple of `step`. Launches on `stream` and returns the CUDA
// error code (0 on success); does not synchronise.
extern "C" int lora_dechirp(const float* xr, long long xr_row_stride, long long xr_elem_stride,
                            const float* xi, long long xi_row_stride, long long xi_elem_stride,
                            const float* dr, const float* di, float* yr, float* yi,
                            long long rows, long long length, long long step, void* stream) {
  if (rows <= 0 || length <= 0) return 0;
  if (step <= 0 || length % step != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = xr_elem_stride == 1 && xi_elem_stride == 1 && length % 4 == 0 &&
                   step % 4 == 0 && (rows == 1 || (xr_row_stride % 4 == 0 &&
                                                   xi_row_stride % 4 == 0)) &&
                   aligned16(xr) && aligned16(xi) && aligned16(dr) && aligned16(di) &&
                   aligned16(yr) && aligned16(yi);
  if (vec) {
    const bool dense = rows == 1 || (xr_row_stride == length && xi_row_stride == length);
    const long long vecs = rows * length / 4;
    auto kernel = dense ? dechirp_vec_kernel<true> : dechirp_vec_kernel<false>;
    kernel<<<blocks_for(vecs), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(xr), reinterpret_cast<const float4*>(xi),
        xr_row_stride / 4, xi_row_stride / 4, reinterpret_cast<const float4*>(dr),
        reinterpret_cast<const float4*>(di), reinterpret_cast<float4*>(yr),
        reinterpret_cast<float4*>(yi), vecs, length / 4, step / 4);
  } else {
    dechirp_scalar_kernel<<<blocks_for(rows * length), kThreads, 0, s>>>(
        Plane{xr, xr_row_stride, xr_elem_stride}, Plane{xi, xi_row_stride, xi_elem_stride},
        dr, di, yr, yi, rows * length, length, step);
  }
  return static_cast<int>(cudaGetLastError());
}
