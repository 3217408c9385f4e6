// bf16 tensor-core decision kernel for Hopper (sm_90a): per row, optional
// CFO derotation, an N-point DFT with bf16 operands and float32 sums,
// |.|^2 and the first-max argmax over the natural bins, N = 4..4096. One
// int32 bin (and optionally the float32 peak |.|^2) per row. Bound to
// Python through a plain C interface (ctypes); see
// lora_phy_tpu_torch/ops/bf16_decide.py for the wrapper and the plain
// PyTorch version it is checked against.
//
// Replaces: no Pallas kernel. It is the card's implementation of the jnp
// code that JAX leaves to XLA for precision="bf16" decisions:
// lora_phy_tpu/ops/planar.py::_mm (:40), dft_mag2_planar /
// _dft_mag2_scrambled (:127-167), argmax_bins_planar (:179) and its use in
// demodulate_planar (:557-560), after _rotated_windows_planar (:629).
//
// Function, with the roundings of the plain version:
//   fr = yr*cr - yi*si, fi = yr*si + yi*cr   (each op rounded on its own;
//        cr/si are the per-frame rotation planes with the amplitude scale
//        and the window folded in; without them fr = yr, fi = yi)
//   N <= 128:  y = bf16([fr | fi]) @ bf16(M), M = [[Wr, Wi], [-Wi, Wr]]
//   N > 128:   the four-step N = n1*n2 of _dft_mag2_scrambled: stage 1
//              bf16(xst[n1, 2n2]) @ bf16(M(n2)), the twiddle in float32,
//              stage 2 bf16(bs[n2, 2n1]) @ bf16(M1R), bin k = k1*n2 + k2
//   |y|^2 = yr*yr + yi*yi (each op rounded on its own), first-max argmax:
//   ties go to the lowest natural bin.
// Products of two bf16 values are exact in float32; only the order of the
// float32 sums differs from the plain version (the tensor cores'
// accumulation is not IEEE-sequential), which moves near-ties only.
//
// What bounds it on an H100: the rows are read once (8 bytes a sample) and
// 4-8 bytes a row are written; the DFT is 8 N^2 bf16 flop a row at
// N <= 128 (SF7: 131,072 flop against 1,024 bytes, 128 flop a byte) and
// 8 N (n1 + n2) in the four-step (SF12: 4.2 Mflop against 32 KiB, 128 flop
// a byte), both under the card's ~295 bf16 flop a byte, so the function is
// bound by bytes. Design: no derotated plane and no spectrum is written to
// device memory. A block walks tiles of rows; per tile it loads the f32
// rows (float4, coalesced), derotates and rounds them to bf16 into shared
// memory, then each warp runs mma.sync.m16n8k16 (bf16 in, f32 accumulate)
// on a 16-row x 32-bin task with the DFT tables resident in shared memory
// (only Wr and Wi: the -fi @ Wi term negates the A fragment, exactly), and
// reduces |.|^2 to a (value, bin) pair per row in registers and shuffles.
// In the four-step the stage-1 accumulators are twiddled in registers and
// written transposed, as bf16, straight into stage 2's shared operand.
// Fragments are read with 32-bit shared loads; every row stride is an odd
// multiple of 16 bytes, so they are free of bank conflicts. N < 16 pads K
// to 16 and the bins to 8 with zeros, which change no sum. A simple first
// kernel: wgmma and TMA, and overlapping a tile's loads with the previous
// tile's products, are later work.

#include <atomic>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;  // bf16 elements of padding per shared row
constexpr int kChunk = 32;  // bins per warp task

__device__ __forceinline__ void take_max(float& m, int& idx, float om, int oi) {
  if (om > m || (om == m && oi < idx)) {
    m = om;
    idx = oi;
  }
}

// -infinity, below every |.|^2
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a @ b for one m16n8k16 tile, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows row0..row0+15, columns k..k+15 of a row-major
// shared tile with row stride LDA.
template <int LDA>
__device__ __forceinline__ void load_a(const __nv_bfloat16* a, int row0, int k, int g, int t,
                                       uint32_t (&f)[4]) {
  const __nv_bfloat16* p = a + (row0 + g) * LDA + k + 2 * t;
  f[0] = ld32(p);
  f[1] = ld32(p + 8 * LDA);
  f[2] = ld32(p + 8);
  f[3] = ld32(p + 8 * LDA + 8);
}

// One warp task of the complex product [A_re | A_im] @ [[Wr, Wi], [-Wi, Wr]]:
// rows row0..row0+15 of the shared tile `a` (real part in columns [0, KP),
// imaginary in [KP, 2KP)), bins col0..col0+8*NT-1. `br` / `bi` hold Wr / Wi
// transposed ([bin][k], row stride LDB). On return acc_r / acc_i hold the
// real / imaginary sums in the m16n8 accumulator layout: element c of
// n-tile j is row row0 + g + 8*(c >> 1), bin col0 + 8*j + 2*t + (c & 1).
template <int KP, int NT, int LDA, int LDB>
__device__ __forceinline__ void complex_mma(const __nv_bfloat16* a, const __nv_bfloat16* br,
                                            const __nv_bfloat16* bi, int row0, int col0,
                                            int g, int t, float (&acc_r)[NT][4],
                                            float (&acc_i)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_r[j][c] = acc_i[j][c] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < KP; k += 16) {
    uint32_t fr[4], fi[4], nfi[4];
    load_a<LDA>(a, row0, k, g, t, fr);
    load_a<LDA>(a, row0, KP + k, g, t, fi);
#pragma unroll
    for (int q = 0; q < 4; ++q) nfi[q] = fi[q] ^ 0x80008000u;  // -fi, exactly
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int off = (col0 + 8 * j + g) * LDB + k + 2 * t;
      const uint32_t r0 = ld32(br + off), r1 = ld32(br + off + 8);
      const uint32_t i0 = ld32(bi + off), i1 = ld32(bi + off + 8);
      mma_bf16(acc_r[j], fr, r0, r1);   // fr @ Wr
      mma_bf16(acc_r[j], nfi, i0, i1);  // - fi @ Wi
      mma_bf16(acc_i[j], fr, i0, i1);   // fr @ Wi
      mma_bf16(acc_i[j], fi, r0, r1);   // fi @ Wr
    }
  }
}

// |.|^2 as the plain version rounds it: two products and a sum, no FMA
__device__ __forceinline__ float mag2(float re, float im) {
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

// fr = yr*cr - yi*si, fi = yr*si + yi*cr, each op rounded on its own
__device__ __forceinline__ void derotate(float yr, float yi, float c, float s, float& fr,
                                         float& fi) {
  fr = __fsub_rn(__fmul_rn(yr, c), __fmul_rn(yi, s));
  fi = __fadd_rn(__fmul_rn(yr, s), __fmul_rn(yi, c));
}

// Load one float4 of samples [row][col..col+3] (zeros past the last row),
// derotated by the row's rotation planes when kRot.
template <int N, bool kRot>
__device__ __forceinline__ void load_samples(const float* __restrict__ yr,
                                             const float* __restrict__ yi,
                                             const float* __restrict__ cr,
                                             const float* __restrict__ si, long long row,
                                             long long rows, long long rows_per_rot, int col,
                                             float4& fr, float4& fi) {
  fr = fi = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= rows) return;
  const float4 a = __ldg(reinterpret_cast<const float4*>(yr + row * N + col));
  const float4 b = __ldg(reinterpret_cast<const float4*>(yi + row * N + col));
  if (!kRot) {
    fr = a;
    fi = b;
    return;
  }
  const long long rot = row / rows_per_rot;
  const float4 c = __ldg(reinterpret_cast<const float4*>(cr + rot * N + col));
  const float4 s = __ldg(reinterpret_cast<const float4*>(si + rot * N + col));
  derotate(a.x, b.x, c.x, s.x, fr.x, fi.x);
  derotate(a.y, b.y, c.y, s.y, fr.y, fi.y);
  derotate(a.z, b.z, c.z, s.z, fr.z, fi.z);
  derotate(a.w, b.w, c.w, s.w, fr.w, fi.w);
}

// Copy a [NP][KP] bf16 table from device memory into shared rows of LDB.
template <int NP, int KP, int LDB>
__device__ __forceinline__ void stage_table(const __nv_bfloat16* __restrict__ src,
                                            __nv_bfloat16* dst) {
  for (int i = threadIdx.x; i < NP * KP; i += kThreads) dst[(i / KP) * LDB + i % KP] = src[i];
}

// ---------------------------------------------------------------------------
// N <= 128: one combined product per tile of R rows
// ---------------------------------------------------------------------------

template <int N>
struct Direct {
  static constexpr int KP = N < 16 ? 16 : N;  // K per part, padded to the MMA depth
  static constexpr int NP = N < 8 ? 8 : N;    // bins, padded to the MMA width
  static constexpr int CH = NP < kChunk ? NP : kChunk;
  static constexpr int NT = CH / 8;
  static constexpr int NCH = NP / CH;
  static constexpr int R = 16 * kWarps / NCH;  // rows per tile: one task per warp
  static constexpr int LDA = 2 * KP + kPad;
  static constexpr int LDB = KP + kPad;
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * (2 * NP * LDB + R * LDA) + (sizeof(float) + sizeof(int)) * R * NCH;
};

template <int N, bool kRot>
__global__ void __launch_bounds__(kThreads)
bf16_decide_direct(const float* __restrict__ yr, const float* __restrict__ yi,
                   const float* __restrict__ cr, const float* __restrict__ si, long long rows,
                   long long rows_per_rot, const __nv_bfloat16* __restrict__ wr,
                   const __nv_bfloat16* __restrict__ wi, int* __restrict__ out,
                   float* __restrict__ peak) {
  using D = Direct<N>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_br = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_bi = s_br + D::NP * D::LDB;
  __nv_bfloat16* s_a = s_bi + D::NP * D::LDB;
  float* s_pv = reinterpret_cast<float*>(s_a + D::R * D::LDA);
  int* s_pk = reinterpret_cast<int*>(s_pv + D::R * D::NCH);

  stage_table<D::NP, D::KP, D::LDB>(wr, s_br);
  stage_table<D::NP, D::KP, D::LDB>(wi, s_bi);
  if constexpr (D::KP > N) {  // the padded K columns stay zero
    for (int i = threadIdx.x; i < D::R * (D::KP - N); i += kThreads) {
      const int r = i / (D::KP - N), c = N + i % (D::KP - N);
      s_a[r * D::LDA + c] = __float2bfloat16_rn(0.0f);
      s_a[r * D::LDA + D::KP + c] = __float2bfloat16_rn(0.0f);
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp / D::NCH, ch = warp % D::NCH;
  constexpr int kQuads = D::R * N / 4;  // float4 per plane per tile
  constexpr int kIters = (kQuads + kThreads - 1) / kThreads;
  const long long tiles = (rows + D::R - 1) / D::R;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * D::R;
    // 1. load, derotate, round to bf16 into the shared tile
    float4 fr[kIters], fi[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int q = threadIdx.x + it * kThreads;
      if (q < kQuads)
        load_samples<N, kRot>(yr, yi, cr, si, row0 + q / (N / 4), rows, rows_per_rot,
                              (q % (N / 4)) * 4, fr[it], fi[it]);
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int q = threadIdx.x + it * kThreads;
      if (q < kQuads) {
        __nv_bfloat16* p = s_a + (q / (N / 4)) * D::LDA + (q % (N / 4)) * 4;
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(fr[it].x, fr[it].y);
        *reinterpret_cast<__nv_bfloat162*>(p + 2) = __floats2bfloat162_rn(fr[it].z, fr[it].w);
        *reinterpret_cast<__nv_bfloat162*>(p + D::KP) = __floats2bfloat162_rn(fi[it].x, fi[it].y);
        *reinterpret_cast<__nv_bfloat162*>(p + D::KP + 2) =
            __floats2bfloat162_rn(fi[it].z, fi[it].w);
      }
    }
    __syncthreads();

    // 2. the product, |.|^2 and each row's best bin over the task's bins
    float acc_r[D::NT][4], acc_i[D::NT][4];
    complex_mma<D::KP, D::NT, D::LDA, D::LDB>(s_a, s_br, s_bi, mt * 16, ch * D::CH, g, t, acc_r,
                                              acc_i);
    float bv[2] = {neg_inf(), neg_inf()};
    int bk[2] = {D::NP, D::NP};
#pragma unroll
    for (int j = 0; j < D::NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int bin = ch * D::CH + 8 * j + 2 * t + (c & 1);
        if (bin < N) take_max(bv[c >> 1], bk[c >> 1], mag2(acc_r[j][c], acc_i[j][c]), bin);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv[h], off);
        const int ok = __shfl_xor_sync(0xffffffffu, bk[h], off);
        take_max(bv[h], bk[h], ov, ok);
      }
    if (t == 0) {
      const int r = mt * 16 + g;
      s_pv[r * D::NCH + ch] = bv[0];
      s_pk[r * D::NCH + ch] = bk[0];
      s_pv[(r + 8) * D::NCH + ch] = bv[1];
      s_pk[(r + 8) * D::NCH + ch] = bk[1];
    }
    __syncthreads();

    // 3. combine the bin chunks of each row
    for (int r = threadIdx.x; r < D::R; r += kThreads) {
      const long long row = row0 + r;
      if (row >= rows) break;
      float v = s_pv[r * D::NCH];
      int k = s_pk[r * D::NCH];
      for (int c = 1; c < D::NCH; ++c) take_max(v, k, s_pv[r * D::NCH + c], s_pk[r * D::NCH + c]);
      out[row] = k;
      if (peak != nullptr) peak[row] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// N > 128: the four-step over tiles of RB rows stacked along M
// ---------------------------------------------------------------------------

template <int N1, int N2, int RB>
struct FourStep {
  static constexpr int N = N1 * N2;
  static constexpr int CH1 = N2 < kChunk ? N2 : kChunk;
  static constexpr int NCH1 = N2 / CH1;
  static constexpr int TASKS1 = RB * N1 / 16 * NCH1;
  static constexpr int CH2 = N1 < kChunk ? N1 : kChunk;
  static constexpr int NCH2 = N1 / CH2;
  static constexpr int PARTS = N2 / 16 * NCH2;  // (value, bin) pairs per row
  static constexpr int TASKS2 = RB * PARTS;
  static constexpr int LDA1 = 2 * N2 + kPad, LDA2 = 2 * N1 + kPad;
  static constexpr int LDB2 = N2 + kPad, LDB1 = N1 + kPad;
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * (2 * N2 * LDB2 + 2 * N1 * LDB1 + RB * N1 * LDA1 + RB * N2 * LDA2) +
      sizeof(float) * 2 * N1 * N2 + (sizeof(float) + sizeof(int)) * TASKS2;
  static_assert(N1 % 16 == 0 && N2 % 16 == 0, "four-step factors are multiples of 16");
};

template <int N1, int N2, int RB, bool kRot>
__global__ void __launch_bounds__(kThreads)
bf16_decide_fourstep(const float* __restrict__ yr, const float* __restrict__ yi,
                     const float* __restrict__ cr, const float* __restrict__ si, long long rows,
                     long long rows_per_rot, const __nv_bfloat16* __restrict__ w2r,
                     const __nv_bfloat16* __restrict__ w2i, const __nv_bfloat16* __restrict__ w1r,
                     const __nv_bfloat16* __restrict__ w1i, const float* __restrict__ twr,
                     const float* __restrict__ twi, int* __restrict__ out,
                     float* __restrict__ peak) {
  using F = FourStep<N1, N2, RB>;
  constexpr int N = F::N;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_b2r = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_b2i = s_b2r + N2 * F::LDB2;
  __nv_bfloat16* s_b1r = s_b2i + N2 * F::LDB2;
  __nv_bfloat16* s_b1i = s_b1r + N1 * F::LDB1;
  __nv_bfloat16* s_a1 = s_b1i + N1 * F::LDB1;     // [RB*N1][LDA1]: xst rows (rb, i1)
  __nv_bfloat16* s_a2 = s_a1 + RB * N1 * F::LDA1;  // [RB*N2][LDA2]: bs rows (rb, k2)
  float* s_twr = reinterpret_cast<float*>(s_a2 + RB * N2 * F::LDA2);  // [N1][N2]
  float* s_twi = s_twr + N1 * N2;
  float* s_pv = s_twi + N1 * N2;
  int* s_pk = reinterpret_cast<int*>(s_pv + F::TASKS2);

  stage_table<N2, N2, F::LDB2>(w2r, s_b2r);
  stage_table<N2, N2, F::LDB2>(w2i, s_b2i);
  stage_table<N1, N1, F::LDB1>(w1r, s_b1r);
  stage_table<N1, N1, F::LDB1>(w1i, s_b1i);
  for (int i = threadIdx.x; i < N1 * N2; i += kThreads) {
    s_twr[i] = twr[i];
    s_twi[i] = twi[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  constexpr int kQuads = RB * N / 4;
  constexpr int kIters = (kQuads + kThreads - 1) / kThreads;
  const long long tiles = (rows + RB - 1) / RB;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * RB;
    // 1. load, derotate, round; sample i = i2*N1 + i1 goes to xst[i1][i2]
    float4 fr[kIters], fi[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int q = threadIdx.x + it * kThreads;
      if (q < kQuads)
        load_samples<N, kRot>(yr, yi, cr, si, row0 + q / (N / 4), rows, rows_per_rot,
                              (q % (N / 4)) * 4, fr[it], fi[it]);
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int q = threadIdx.x + it * kThreads;
      if (q < kQuads) {
        const int rb = q / (N / 4), i = (q % (N / 4)) * 4;
        const int i2 = i / N1, i1 = i % N1;
        __nv_bfloat16* p = s_a1 + (rb * N1 + i1) * F::LDA1 + i2;
        const float re[4] = {fr[it].x, fr[it].y, fr[it].z, fr[it].w};
        const float im[4] = {fi[it].x, fi[it].y, fi[it].z, fi[it].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e * F::LDA1] = __float2bfloat16_rn(re[e]);
          p[e * F::LDA1 + N2] = __float2bfloat16_rn(im[e]);
        }
      }
    }
    __syncthreads();

    // 2. stage 1, a[(rb, i1)][k2], twiddled in f32 and written transposed
    //    as bs[(rb, k2)][i1 | N1 + i1] in bf16
    for (int task = warp; task < F::TASKS1; task += kWarps) {
      const int mt = task / F::NCH1, ch = task % F::NCH1;
      float acc_r[F::CH1 / 8][4], acc_i[F::CH1 / 8][4];
      complex_mma<N2, F::CH1 / 8, F::LDA1, F::LDB2>(s_a1, s_b2r, s_b2i, mt * 16, ch * F::CH1, g,
                                                    t, acc_r, acc_i);
#pragma unroll
      for (int j = 0; j < F::CH1 / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = mt * 16 + g + 8 * (c >> 1);
          const int rb = r / N1, i1 = r % N1;
          const int k2 = ch * F::CH1 + 8 * j + 2 * t + (c & 1);
          const float wr_ = s_twr[i1 * N2 + k2], wi_ = s_twi[i1 * N2 + k2];
          float br, bi;
          derotate(acc_r[j][c], acc_i[j][c], wr_, wi_, br, bi);
          __nv_bfloat16* p = s_a2 + (rb * N2 + k2) * F::LDA2 + i1;
          p[0] = __float2bfloat16_rn(br);
          p[N1] = __float2bfloat16_rn(bi);
        }
    }
    __syncthreads();

    // 3. stage 2, c[(rb, k2)][k1]; |.|^2 and the best natural bin
    //    k1*N2 + k2 of each 16-row x CH2-bin task (one frame row per task)
    for (int task = warp; task < F::TASKS2; task += kWarps) {
      const int mt = task / F::NCH2, ch = task % F::NCH2;
      float acc_r[F::CH2 / 8][4], acc_i[F::CH2 / 8][4];
      complex_mma<N1, F::CH2 / 8, F::LDA2, F::LDB1>(s_a2, s_b1r, s_b1i, mt * 16, ch * F::CH2, g,
                                                    t, acc_r, acc_i);
      float bv = neg_inf();
      int bk = N;
#pragma unroll
      for (int j = 0; j < F::CH2 / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k2 = (mt * 16 + g + 8 * (c >> 1)) % N2;
          const int k1 = ch * F::CH2 + 8 * j + 2 * t + (c & 1);
          take_max(bv, bk, mag2(acc_r[j][c], acc_i[j][c]), k1 * N2 + k2);
        }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int ok = __shfl_xor_sync(0xffffffffu, bk, off);
        take_max(bv, bk, ov, ok);
      }
      if (lane == 0) {
        s_pv[task] = bv;  // task = rb * PARTS + part
        s_pk[task] = bk;
      }
    }
    __syncthreads();

    // 4. combine each row's parts
    for (int rb = threadIdx.x; rb < RB; rb += kThreads) {
      const long long row = row0 + rb;
      if (row >= rows) break;
      float v = s_pv[rb * F::PARTS];
      int k = s_pk[rb * F::PARTS];
      for (int q = 1; q < F::PARTS; ++q)
        take_max(v, k, s_pv[rb * F::PARTS + q], s_pk[rb * F::PARTS + q]);
      out[row] = k;
      if (peak != nullptr) peak[row] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// Launch: a persistent grid of the blocks the card holds at once
// ---------------------------------------------------------------------------

// Blocks of `kernel` resident on the current device at once (with its
// dynamic shared memory allowed), queried once per device and kept.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, std::atomic<long long>* cache,
                            long long* blocks) {
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  *blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (device < kMaxDevices) cache[device].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

struct Args {
  const float *yr, *yi, *cr, *si;
  long long rows, rows_per_rot;
  const __nv_bfloat16 *wa_r, *wa_i, *wb_r, *wb_i;
  const float *twr, *twi;
  int* out;
  float* peak;
  cudaStream_t stream;
};

template <int N, bool kRot>
int launch_direct(const Args& a) {
  static std::atomic<long long> cache[64];
  auto kernel = bf16_decide_direct<N, kRot>;
  constexpr size_t smem = Direct<N>::kSmem;
  long long resident = 0;
  cudaError_t err = resident_blocks(kernel, smem, cache, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (a.rows + Direct<N>::R - 1) / Direct<N>::R;
  const long long blocks = tiles < resident ? tiles : resident;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, a.stream>>>(
      a.yr, a.yi, a.cr, a.si, a.rows, a.rows_per_rot, a.wa_r, a.wa_i, a.out, a.peak);
  return static_cast<int>(cudaGetLastError());
}

template <int N1, int N2, int RB, bool kRot>
int launch_fourstep(const Args& a) {
  static std::atomic<long long> cache[64];
  auto kernel = bf16_decide_fourstep<N1, N2, RB, kRot>;
  constexpr size_t smem = FourStep<N1, N2, RB>::kSmem;
  long long resident = 0;
  cudaError_t err = resident_blocks(kernel, smem, cache, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (a.rows + RB - 1) / RB;
  const long long blocks = tiles < resident ? tiles : resident;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, a.stream>>>(
      a.yr, a.yi, a.cr, a.si, a.rows, a.rows_per_rot, a.wa_r, a.wa_i, a.wb_r, a.wb_i, a.twr,
      a.twi, a.out, a.peak);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRot>
int dispatch(int n, const Args& a) {
  switch (n) {
    case 4: return launch_direct<4, kRot>(a);
    case 8: return launch_direct<8, kRot>(a);
    case 16: return launch_direct<16, kRot>(a);
    case 32: return launch_direct<32, kRot>(a);
    case 64: return launch_direct<64, kRot>(a);
    case 128: return launch_direct<128, kRot>(a);
    // (n1, n2) of the four-step split (ops/fft.py::_split); rows per tile
    // chosen so that each stage has at least one task per warp
    case 256: return launch_fourstep<16, 16, 8, kRot>(a);
    case 512: return launch_fourstep<16, 32, 8, kRot>(a);
    case 1024: return launch_fourstep<32, 32, 4, kRot>(a);
    case 2048: return launch_fourstep<32, 64, 2, kRot>(a);
    case 4096: return launch_fourstep<64, 64, 1, kRot>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// yr, yi: [rows, n] f32; cr, si: [rows / rows_per_rot, n] f32 rotation
// planes or both null (no derotation); row r uses rotation
// r / rows_per_rot. wa_r, wa_i: the bf16 DFT tables Wr, Wi transposed,
// [bin][k] — for n <= 128 [max(n, 8)][max(n, 16)] zero-padded, for n > 128
// stage 1's [n2][n2]; wb_r, wb_i: stage 2's [n1][n1] (null for n <= 128);
// twr, twi: the [n1][n2] f32 twiddles (null for n <= 128). out: [rows]
// int32 bins; peak: [rows] f32 peak |.|^2 or null. Launches on `stream`
// and returns the CUDA error code (0 on success); does not synchronise.
extern "C" int lora_bf16_decide(const float* yr, const float* yi, const float* cr,
                                const float* si, long long rows, long long rows_per_rot, int n,
                                const void* wa_r, const void* wa_i, const void* wb_r,
                                const void* wb_i, const float* twr, const float* twi, int* out,
                                float* peak, void* stream) {
  if (rows <= 0) return 0;
  if ((cr == nullptr) != (si == nullptr) || rows_per_rot <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{yr, yi, cr, si, rows, rows_per_rot,
               static_cast<const __nv_bfloat16*>(wa_r), static_cast<const __nv_bfloat16*>(wa_i),
               static_cast<const __nv_bfloat16*>(wb_r), static_cast<const __nv_bfloat16*>(wb_i),
               twr, twi, out, peak, static_cast<cudaStream_t>(stream)};
  return cr != nullptr ? dispatch<true>(n, a) : dispatch<false>(n, a);
}
