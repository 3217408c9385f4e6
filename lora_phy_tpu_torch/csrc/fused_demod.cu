// Fused dechirp-detection kernel for Hopper (sm_90a): per-row CFO
// derotation, N-point DFT, |.|^2 and first-max argmax, one int32 bin per
// row. Bound to Python through a plain C interface (ctypes); see
// lora_phy_tpu_torch/ops/fused_demod.py for the wrapper and the plain
// PyTorch twin it is checked against.
//
// Replaces: lora_phy_tpu/ops/pallas_demod.py::_kernel (the Pallas/Mosaic
// kernel launched by fused_detect_rows), which derotates each row by
// exp(j*(start + rate*col)), runs the DFT as four real f32 matmuls against
// resident [N, N] cos / -sin tables with the window folded into the table
// rows, and takes min(where(mag == rowmax, col, N)).
//
// What bounds it on an H100: at the bench shape (8 channels x 8192 frames x
// 66 symbols = 4.33 M rows of N = 128) the DFT is 8*N^2*B = 5.7e11 f32
// flops, while the rows are read once (about 4.4 GB) and one int32 per
// row is written. Without tensor cores this design is held by f32 FMA
// throughput: ~67 TFLOP/s of f32 gives >= 8.5 ms. The function itself
// needs only an N-point DFT per row (an FFT: 5*N*log2(N) flops), so its
// least time is the HBM traffic, 3.35 TB/s giving 1.3 ms (chip_smoke.py
// phase 4 computes that bound).
//
// Design (simple and correct first): a block of N threads takes kRows rows.
// Thread k derotates column k of each row into shared memory (sincosf,
// full precision: the phase reaches hundreds of radians, where the __sinf
// intrinsics lose accuracy), then accumulates bin k of all kRows rows in
// registers in f32 FMA, reading the tables coalesced along k from global
// memory (L1/L2-resident: 128 KB at N = 128) and the rows as float4
// broadcasts from shared memory, so each table load feeds kRows rows. The
// argmax is a warp-shuffle reduction on (value, index) pairs — larger
// value wins, a tie goes to the smaller index — combined across warps in
// shared memory: exactly the first maximum. Making it fast is later work:
// 3xTF32 or a split-precision mma on the tensor cores, or an FFT in shared
// memory.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;  // rows per block

__device__ __forceinline__ void take_max(float& m, int& idx, float om, int oi) {
  if (om > m || (om == m && oi < idx)) {
    m = om;
    idx = oi;
  }
}

template <int N>
__global__ void __launch_bounds__(N)
fused_demod_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   const float* __restrict__ start,
                   const float* __restrict__ rate,
                   const float* __restrict__ wr, const float* __restrict__ wi,
                   int* __restrict__ out, long long rows) {
  static_assert(N % 32 == 0 && N >= kRows, "N must be a multiple of 32");
  constexpr int kWarps = N / 32;
  __shared__ __align__(16) float sfr[kRows][N];
  __shared__ __align__(16) float sfi[kRows][N];
  __shared__ float warp_max[kRows][kWarps];
  __shared__ int warp_idx[kRows][kWarps];

  const int k = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;

  // 1. derotation: thread k forms column k of every row. Rounded
  // operations (no FMA contraction) so the phase and the derotated
  // samples are the same floats as the plain twin's.
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long row = row0 + r;
    float fr = 0.f, fi = 0.f;
    if (row < rows) {
      const float ph = __fadd_rn(start[row], __fmul_rn(rate[row], static_cast<float>(k)));
      float s, c;
      sincosf(ph, &s, &c);
      const float a = xr[row * N + k];
      const float b = xi[row * N + k];
      fr = __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, s));
      fi = __fadd_rn(__fmul_rn(a, s), __fmul_rn(b, c));
    }
    sfr[r][k] = fr;
    sfi[r][k] = fi;
  }
  __syncthreads();

  // 2. DFT: bin k of every row, zr = sum fr*wr - fi*wi, zi = sum fr*wi + fi*wr
  float zr[kRows], zi[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    zr[r] = 0.f;
    zi[r] = 0.f;
  }
  for (int i = 0; i < N; i += 4) {
    float w_r[4], w_i[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w_r[j] = __ldg(wr + (i + j) * N + k);
      w_i[j] = __ldg(wi + (i + j) * N + k);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&sfr[r][i]);
      const float4 b = *reinterpret_cast<const float4*>(&sfi[r][i]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        zr[r] = fmaf(av[j], w_r[j], zr[r]);
        zr[r] = fmaf(-bv[j], w_i[j], zr[r]);
        zi[r] = fmaf(av[j], w_i[j], zi[r]);
        zi[r] = fmaf(bv[j], w_r[j], zi[r]);
      }
    }
  }

  // 3. first-max argmax of |z|^2 per row: within each warp, then across warps
  const int lane = k & 31;
  const int warp = k >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float m = zr[r] * zr[r] + zi[r] * zi[r];
    int idx = k;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float om = __shfl_down_sync(0xffffffffu, m, off);
      const int oi = __shfl_down_sync(0xffffffffu, idx, off);
      take_max(m, idx, om, oi);
    }
    if (lane == 0) {
      warp_max[r][warp] = m;
      warp_idx[r][warp] = idx;
    }
  }
  __syncthreads();
  if (k < kRows && row0 + k < rows) {
    float m = warp_max[k][0];
    int idx = warp_idx[k][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) take_max(m, idx, warp_max[k][w], warp_idx[k][w]);
    out[row0 + k] = idx;
  }
}

template <int N>
void launch(const float* xr, const float* xi, const float* start, const float* rate,
            const float* wr, const float* wi, int* out, long long rows,
            cudaStream_t stream) {
  const long long blocks = (rows + kRows - 1) / kRows;
  fused_demod_kernel<N><<<static_cast<unsigned>(blocks), N, 0, stream>>>(
      xr, xi, start, rate, wr, wi, out, rows);
}

}  // namespace

// xr, xi: [rows, n] f32; start, rate: [rows] f32; wr, wi: [n, n] f32 (the
// window folded into the rows); out: [rows] int32. Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronise.
extern "C" int lora_fused_demod(const float* xr, const float* xi, const float* start,
                                const float* rate, const float* wr, const float* wi,
                                int* out, long long rows, int n, void* stream) {
  if (rows <= 0) return 0;
  if ((rows + kRows - 1) / kRows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 32: launch<32>(xr, xi, start, rate, wr, wi, out, rows, s); break;
    case 64: launch<64>(xr, xi, start, rate, wr, wi, out, rows, s); break;
    case 128: launch<128>(xr, xi, start, rate, wr, wi, out, rows, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lora_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
