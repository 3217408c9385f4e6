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
// N <= 128 and 8 N (n1 + n2) in the four-step, 128 flop a byte at SF7 and
// SF12, under the card's ~295 bf16 flop a byte, so the function is bound
// by bytes. At the SF7 main path (4,325,376 rows x 128, with rotation)
// that is 4.514e9 B, 1.347 ms at 3.35 TB/s; the tensor cores' share is
// 5.67e11 flop, 0.573 ms at the 989 TFLOP/s dense peak. At SF12 (67,584
// rows x 4096) 2.248e9 B, 0.671 ms. No derotated plane and no spectrum is
// written to device memory.
//
// N = 32, 64, 128 (bf16_decide_wgmma): two warpgroups of 128 threads per
// block, a persistent grid of the blocks the card holds: two an SM at N =
// 32 and 64 (launch bounds cap registers at 128 a thread; 53 / 98 KB of
// shared memory a block), one at N = 128 (208 KB); each warpgroup walks
// its own 64-row tiles, so one's CUDA-core work (derotation, epilogue,
// copies) runs while another's products hold the tensor cores.
// - B: Wr^T and Wi^T ([bin][k], K-major) stay in shared memory for the
//   whole call, 64 KB at N = 128, built on the host in the no-swizzle
//   canonical wgmma layout (ops/bf16_decide.py::wgmma_layout), so the
//   kernel copies bytes and computes no swizzle.
// - A from registers: warp w owns tile rows 16w..16w+15 in the m16n8k16
//   A-fragment layout; a thread derotates its rows' samples (op by op)
//   and rounds them straight into its bf16x2 A registers. The host
//   permutes k inside each 16-deep step so that a thread's four columns
//   of a row are one float4. Per k-step four m64nNk16 products feed two
//   accumulators: acc_r += fr Wr, acc_r += -fi Wi (the instruction's A
//   scale of -1: exact), acc_i += fr Wi, acc_i += fi Wr; at N = 128 the
//   two f32 accumulators take 128 registers a thread.
// - Overlap: rows come in through a two-stage ring, one stage per
//   warpgroup, of cp.async copies (16 bytes each, zero-filled past the
//   last row; row stride N + 16 floats, so the float4 fragment reads are
//   free of bank conflicts). A warpgroup starts its next tile's copies as
//   soon as its last k-step is in registers, under its last products,
//   its epilogue and the other warpgroup's tile; the rotation-plane rows
//   of its next tile are pulled into L1 (prefetch) when a tile starts.
//   A third stage does not fit beside the 64 KB of tables at N = 128.
//   Inside a tile wgmma is asynchronous: k-step s + 1 is derotated on the
//   CUDA cores while k-step s's products run on the tensor cores
//   (wgmma.wait_group 1). The epilogue is in registers: a row's N bins
//   lie in one quad of one warp, so |.|^2, a strict-> scan in bin order
//   and two shuffles finish it, with no cross-warp combine.
// - Rotation rows: a thread's tile rows r0 and r0 + 8 find their plane
//   rows r / rows_per_rot by adds (RotIndex): one 64-bit division each when
//   the walk starts, then the tile step's own quotient and remainder.
// On an H100 (PERF.md section 6, chip_smoke.py phase 19 (b)), one
// warpgroup per block left a tile's loads, products and epilogue in
// series; the second warpgroup and the L1 prefetch of the rotation planes
// brought the N = 128 kernel near its bound. Refilling a stage one k-step
// at a time (a barrier per k-step) was slower, and is not used. At N = 32
// a tile is two k-steps, so its fixed costs weigh four times what they do
// at N = 128: with one block an SM (152 registers) and four 64-bit
// divisions a thread a tile the rotated kernel took 2.056 ms on phase 20
// (c)'s rows against 1.571 unrotated; two blocks an SM alone gave 1.569,
// the divisions by a constant alone 1.743 (tools/torch_kernel_resources.py
// --ablate on the sources before; H100 80GB HBM3, 700 W). With both
// changes it takes 1.533 ms rotated and 1.494 unrotated, N = 64 1.556 and
// 1.454 (--compare in turns, the same card).
//
// N = 256..4096 (bf16_decide_fourstep, one template over the (n1, n2) of
// ops/fft.py::_split): warpgroups of 128 threads, each on its own tiles of
// RB frame rows (16 at N = 256, else 64 / n1: 4, 2, 2, 1), so that stage
// 1's M, RB n1 rows (rb, i1), is one m64 tile (four at N = 256); two
// warpgroups a block and two blocks an SM at N <= 1024, three and one
// above. A block takes a contiguous run of tiles, so frame rows that share
// a rotation row stay on one SM.
// - Both operands of both stages come from shared memory, in the one
//   no-swizzle K-major core-matrix layout (LBO 128 B, SBO 16 K B; checked
//   on the card for A and B, n = 16..64, by a one-off probe): stage 1 A =
//   xst [(rb, i1)][i2] against M(n2)'s Wr^T, Wi^T [k2][i2]; stage 2 A = bs
//   [(rb, k2)][i1] (RB n2 rows: one to four m64 chains) against M1R's
//   [k1][i1]. The host builds the four tables in that layout
//   (wgmma_layout without the k permutation) and the twiddles in the order
//   a thread reads them (fourstep_twiddles: one float4 an n-tile), so the
//   kernel copies bytes. Four products a k-step into two f32
//   accumulators, -im @ Wi through the A scale of -1; the first product of
//   each accumulator ignores what its registers hold, so they live only
//   through their stage.
// - Rows: a tile's RB frame rows are contiguous, copied by cp.async into
//   the warpgroup's f32 stage; as soon as the tile is derotated into xst
//   the stage is free and the next tile's copies start, so they run under
//   both stages' products and epilogues and the other warpgroups' tiles.
//   The derotation reads eight samples i2 n1 + i1 of one xst row (lanes on
//   consecutive i1, so the f32 stage and the rotation planes are read
//   without bank conflicts or waste) and writes them as one 16-byte core
//   row. The next tile's new rotation rows are prefetched into L1.
// - Stage 1's epilogue twiddles its accumulators in f32 (op by op) and
//   writes them as bf16 straight into bs, which takes xst's place (a
//   warp's stores of one n-tile land in one 128-byte core matrix). Stage
//   2's epilogue takes |.|^2 and a first maximum over natural bins
//   k1 n2 + k2: a thread meets its bins in increasing order (a strict >),
//   a warp's 16 rows of a chain lie in one frame row (shuffles), and a
//   frame row's warps meet in shared memory under the warpgroup's
//   barrier. Shared memory at N = 4096: 32 KB of tables, 32 KB of
//   twiddles and 48 KB a warpgroup (the f32 stage, xst / bs).
// On an H100 (PERF.md section 6, chip_smoke.py phase 19 (c)): 1024-sample
// tiles at N = 256 were held by a tile's fixed costs (four barriers, two
// product round trips), which 4096-sample tiles spread; at N >= 2048 a
// third warpgroup beat two with the twiddles in registers.
//
// N = 16 (bf16_decide_n16): mma.sync.m16n8k16 with A from registers;
// every warp walks its own 32-row tasks (two m16 tiles) of a persistent
// grid, with no barrier. The host permutes k as for wgmma, so a thread
// (g, t) needs of each tile's rows g and g + 8 one float4 per plane at
// column 4t (a warp's eight rows are 512 contiguous bytes). It copies
// exactly those float4s (and its rows' rotation-plane float4s, found by
// RotIndex adds) with cp.async into a two-stage ring of its own in shared
// memory, so the next task is in flight under this task's products and
// epilogue and a wait on its own copies is the only synchronisation. It
// derotates them op by op and rounds them straight into its bf16x2 A
// registers; B (Wr^T, Wi^T: two n-tiles each, 8 registers) is loaded once.
// A row's 16 bins lie in one quad, so two shuffles finish its argmax and
// one lane writes it. On an H100 (PERF.md section 6; tools/
// torch_kernel_resources.py --compare in turns on phase 20 (c)'s rows,
// against bf16_decide_direct<16>, which served N = 16 before) the next
// task's loads held in registers instead (96 registers rotated, two blocks
// an SM) took 0.912 of its time rotated and 1.011 unrotated; this ring
// takes 0.901 and 0.994.
//
// N = 4, 8 (bf16_decide_direct) stay on mma.sync.m16n8k16: a block
// walks tiles of rows; per tile it loads the f32 rows (float4), derotates
// and rounds them to bf16 into shared memory, then each warp runs
// mma.sync on a 16-row task with the tables resident in shared memory,
// and reduces |.|^2 to a (value, bin) pair per row in registers, shuffles
// and shared memory. Fragments are read with 32-bit shared loads; every
// row stride is an odd multiple of 16 bytes, so they are free of bank
// conflicts. N < 16 pads K to 16 and the bins to 8 with zeros, which
// change no sum.

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
// N = 4, 8: one combined product per tile of R rows
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
// N = 32, 64, 128: wgmma with A from registers, rows through a two-stage
// cp.async ring
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;  // threads of a warpgroup
constexpr int kWgs = 2;          // warpgroups per block, each on its own tiles
constexpr int kWgRows = 64;      // rows per tile: the wgmma M

template <int N>
struct Wg {
  // f32 per staged row: N + 16 makes the fragment reads (float4 at columns
  // 4t of rows g and g+1 in one quarter warp) hit 32 distinct banks
  static constexpr int LD = N + 16;
  static constexpr int kStage = 2 * kWgRows * LD;  // f32 per stage (yr, yi of a tile)
  static constexpr int kTable = N * N;              // bf16 per table
  static constexpr size_t kSmem =
      2 * sizeof(__nv_bfloat16) * kTable + kWgs * sizeof(float) * kStage;
  // the tables' canonical no-swizzle K-major layout (ops/bf16_decide.py::
  // wgmma_layout): 8 x 8 core matrices of 128 contiguous bytes, the two
  // 8-deep halves of a k-step side by side (LBO), 8-bin groups 16 N bytes
  // apart (SBO); k-step s starts 256 s bytes in
  static constexpr uint32_t kLbo = 128;
  static constexpr uint32_t kSbo = 16 * N;
  // blocks an SM: two at N <= 64 (four warpgroups, registers capped at 128
  // a thread), one at N = 128 (its tables and stages take 208 KB)
  static constexpr int kMinBlocks = N <= 64 ? 2 : 1;
};

// row / rows_per_rot (q) and row % rows_per_rot (m) of a row that moves on
// by a fixed step: one division when the walk starts, then adds
struct RotIndex {
  long long q, m;
  __device__ __forceinline__ static RotIndex at(long long row, long long rows_per_rot) {
    const long long q = row / rows_per_rot;
    return {q, row - q * rows_per_rot};
  }
  // the index `step` rows on, from the step's own index d
  __device__ __forceinline__ RotIndex advanced(RotIndex d, long long rows_per_rot) const {
    RotIndex r{q + d.q, m + d.m};
    if (r.m >= rows_per_rot) {
      r.m -= rows_per_rot;
      ++r.q;
    }
    return r;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma shared-memory descriptor: start address, LBO and SBO in 16-byte
// units, base offset 0, layout type 0 (no swizzle)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending));
}
// generic-proxy writes to shared memory (the tables) made visible to the
// async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes global -> shared, asynchronous; zero-filled when !live
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// this thread's cp.async groups but the newest kPending have landed
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
// 16 bytes global -> shared through L1, asynchronous
__device__ __forceinline__ void cp_async16_ca(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
// a barrier of the 128 threads of warpgroup `wg` (named barrier 1 + wg)
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWgThreads) : "memory");
}

// d = (scale_d ? d : 0) + kScaleA * a @ B for one m64nNk16 wgmma: bf16
// operands, f32 accumulators in registers. `a` is this thread's A fragment
// (warp w of the warpgroup holds rows 16w..16w+15 in the m16n8k16 A layout);
// B is [N bins][16 k] K-major in shared memory, read through `desc`. kScaleA
// = -1 negates A, exactly. Asynchronous: the result is there after
// wgmma_commit() and a wgmma_wait<> that covers it.
template <int N, int kScaleA>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma widths of the N <= 128 path");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, %22, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(kScaleA));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, %38, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(kScaleA));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, %70, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(kScaleA));
  }
}

// Start the copies of one 64-row tile (both planes, rows past `rows`
// zero-filled) into a stage [plane][64][LD], by the 128 threads of one
// warpgroup (`tid` = thread within it).
template <int N>
__device__ __forceinline__ void copy_tile(const float* __restrict__ yr,
                                          const float* __restrict__ yi, long long rows,
                                          long long tile, float* dst, int tid) {
  constexpr int kChunks = N / 4;  // 16-byte chunks per row
#pragma unroll 4
  for (int i = tid; i < kWgRows * kChunks; i += kWgThreads) {
    const int r = i / kChunks, q = i % kChunks;
    const long long row = tile * kWgRows + r;
    const bool live = row < rows;
    const long long off = (live ? row : 0) * N + 4 * q;
    float* d = dst + r * Wg<N>::LD + 4 * q;
    cp_async16(d, yr + off, live);
    cp_async16(d + kWgRows * Wg<N>::LD, yi + off, live);
  }
}

// Pull a rotation-plane row into L1 ahead of its tile: thread t touches
// its 128-byte line t.
template <int N>
__device__ __forceinline__ void prefetch_plane(const float* p, int t) {
  if (32 * t < N) asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p + 32 * t));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One row's four samples of a k-step as read from the ring (and its
// rotation planes' four values when kRot)
struct Quad {
  float4 yr, yi, c, s;
};

template <bool kRot>
__device__ __forceinline__ Quad load_quad(const float* yr, const float* yi, const float* c,
                                          const float* s) {
  Quad q;
  q.yr = *reinterpret_cast<const float4*>(yr);
  q.yi = *reinterpret_cast<const float4*>(yi);
  if (kRot) {
    q.c = __ldg(reinterpret_cast<const float4*>(c));
    q.s = __ldg(reinterpret_cast<const float4*>(s));
  }
  return q;
}

// Derotate a quad op by op and round it to bf16: the low and high A
// registers of its row (k-step columns 4t, 4t+1 and 4t+2, 4t+3, which the
// host's k permutation puts at the fragment's k slots 2t, 2t+1 and 2t+8,
// 2t+9), real and imaginary.
template <bool kRot>
__device__ __forceinline__ void quad_fragment(const Quad& q, uint32_t& r_lo, uint32_t& r_hi,
                                              uint32_t& i_lo, uint32_t& i_hi) {
  float4 fr = q.yr, fi = q.yi;
  if (kRot) {
    derotate(q.yr.x, q.yi.x, q.c.x, q.s.x, fr.x, fi.x);
    derotate(q.yr.y, q.yi.y, q.c.y, q.s.y, fr.y, fi.y);
    derotate(q.yr.z, q.yi.z, q.c.z, q.s.z, fr.z, fi.z);
    derotate(q.yr.w, q.yi.w, q.c.w, q.s.w, fr.w, fi.w);
  }
  r_lo = pack_bf16(fr.x, fr.y);
  r_hi = pack_bf16(fr.z, fr.w);
  i_lo = pack_bf16(fi.x, fi.y);
  i_hi = pack_bf16(fi.z, fi.w);
}

template <int N, bool kRot>
__global__ void __launch_bounds__(kWgs * kWgThreads, Wg<N>::kMinBlocks)
bf16_decide_wgmma(const float* __restrict__ yr, const float* __restrict__ yi,
                  const float* __restrict__ cr, const float* __restrict__ si, long long rows,
                  long long rows_per_rot, const __nv_bfloat16* __restrict__ wr,
                  const __nv_bfloat16* __restrict__ wi, int* __restrict__ out,
                  float* __restrict__ peak) {
  using W = Wg<N>;
  constexpr int kSteps = N / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_wr = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_wi = s_wr + W::kTable;
  const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
  float* stage = reinterpret_cast<float*>(s_wi + W::kTable) + wg * W::kStage;

  // warpgroup wg walks tiles blockIdx.x * kWgs + wg + k * gridDim.x * kWgs
  const long long tiles = (rows + kWgRows - 1) / kWgRows;
  const long long stride = static_cast<long long>(gridDim.x) * kWgs;
  long long tile = static_cast<long long>(blockIdx.x) * kWgs + wg;
  // the first tile's rows in flight, then the tables, copied as bytes
  if (tile < tiles) copy_tile<N>(yr, yi, rows, tile, stage, tid);
  cp_async_commit();
  for (int i = threadIdx.x; i < W::kTable / 8; i += kWgs * kWgThreads) {
    reinterpret_cast<uint4*>(s_wr)[i] = __ldg(reinterpret_cast<const uint4*>(wr) + i);
    reinterpret_cast<uint4*>(s_wi)[i] = __ldg(reinterpret_cast<const uint4*>(wi) + i);
  }
  fence_proxy_async();
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;  // this thread's tile rows: r0 and r0 + 8
  const uint32_t wr_addr = smem_u32(s_wr), wi_addr = smem_u32(s_wi);
  float acc_r[N / 2], acc_i[N / 2];
#pragma unroll
  for (int c = 0; c < N / 2; ++c) acc_r[c] = acc_i[c] = 0.0f;
  // the rotation rows of this thread's two tile rows, moved on by adds from
  // tile to tile; rows past the end take the last row's (never written)
  const long long step = stride * kWgRows;
  RotIndex rot0{0, 0}, rot1{0, 0}, d{0, 0};
  long long last_rot = 0;
  if (kRot) {
    rot0 = RotIndex::at(tile * kWgRows + r0, rows_per_rot);
    rot1 = RotIndex::at(tile * kWgRows + r0 + 8, rows_per_rot);
    d = RotIndex::at(step, rows_per_rot);
    last_rot = (rows - 1) / rows_per_rot;
  }

  for (; tile < tiles; tile += stride) {
    // this tile's rows have landed (every thread's copies of the warpgroup)
    cp_async_wait_all();
    wg_barrier(wg);

    const float* y0r = stage + r0 * W::LD + 4 * t;
    const float* y0i = y0r + kWgRows * W::LD;
    const float* y1r = y0r + 8 * W::LD;
    const float* y1i = y0i + 8 * W::LD;
    const long long row0 = tile * kWgRows + r0, row1 = row0 + 8;
    const float *c0 = nullptr, *s0 = nullptr, *c1 = nullptr, *s1 = nullptr;
    if (kRot) {
      const long long p0 = (row0 < rows ? rot0.q : last_rot) * N + 4 * t;
      const long long p1 = (row1 < rows ? rot1.q : last_rot) * N + 4 * t;
      c0 = cr + p0;
      s0 = si + p0;
      c1 = cr + p1;
      s1 = si + p1;
      rot0 = rot0.advanced(d, rows_per_rot);
      rot1 = rot1.advanced(d, rows_per_rot);
      if (tile + stride < tiles) {  // the next tile's planes, into L1 meanwhile
        const long long nrot0 = row0 + step < rows ? rot0.q : last_rot;
        const long long nrot1 = row1 + step < rows ? rot1.q : last_rot;
        prefetch_plane<N>(cr + nrot0 * N, t);
        prefetch_plane<N>(si + nrot0 * N, t);
        prefetch_plane<N>(cr + nrot1 * N, t);
        prefetch_plane<N>(si + nrot1 * N, t);
      }
    }

    // k-step s: derotate it into A registers while k-step s - 1's products
    // run, issue its four products, load k-step s + 1's samples, then wait
    // for k-step s - 1 (whose A registers the next derotation reuses).
    // Once the last k-step is in registers the stage is free: the next
    // tile's copies start there, under the last products and the epilogue
    // (and the other warpgroup's work).
    Quad q0 = load_quad<kRot>(y0r, y0i, c0, s0);
    Quad q1 = load_quad<kRot>(y1r, y1i, c1, s1);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t ar[4], ai[4];
      quad_fragment<kRot>(q0, ar[0], ar[2], ai[0], ai[2]);
      quad_fragment<kRot>(q1, ar[1], ar[3], ai[1], ai[3]);
      if (s + 1 < kSteps) {
        const int k = 16 * (s + 1);
        q0 = load_quad<kRot>(y0r + k, y0i + k, c0 + k, s0 + k);
        q1 = load_quad<kRot>(y1r + k, y1i + k, c1 + k, s1 + k);
      } else {
        wg_barrier(wg);
        if (tile + stride < tiles) copy_tile<N>(yr, yi, rows, tile + stride, stage, tid);
        cp_async_commit();
      }
      const uint64_t dr = smem_desc(wr_addr + 256 * s, W::kLbo, W::kSbo);
      const uint64_t di = smem_desc(wi_addr + 256 * s, W::kLbo, W::kSbo);
      const int keep = s > 0;
      wgmma_fence();
      wgmma_bf16<N, 1>(acc_r, ar, dr, keep);  // fr @ Wr
      wgmma_bf16<N, 1>(acc_i, ar, di, keep);  // fr @ Wi
      wgmma_bf16<N, -1>(acc_r, ai, di, 1);    // - fi @ Wi
      wgmma_bf16<N, 1>(acc_i, ai, dr, 1);     // fi @ Wr
      wgmma_commit();
      if (s + 1 < kSteps)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
    }

    // |.|^2 and each row's best bin: element c of n-tile j is row
    // r0 + 8 (c >> 1), bin 8j + 2t + (c & 1); a thread meets its bins in
    // increasing order, so a strict > keeps the first maximum
    float bv[2] = {neg_inf(), neg_inf()};
    int bk[2] = {N, N};
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float v = mag2(acc_r[4 * j + c], acc_i[4 * j + c]);
        if (v > bv[c >> 1]) {
          bv[c >> 1] = v;
          bk[c >> 1] = 8 * j + 2 * t + (c & 1);
        }
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
      if (row0 < rows) {
        out[row0] = bk[0];
        if (peak != nullptr) peak[row0] = bv[0];
      }
      if (row1 < rows) {
        out[row1] = bk[1];
        if (peak != nullptr) peak[row1] = bv[1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// N = 16: mma.sync with A from registers, one warp per 32-row task, rows
// through a cp.async ring of each thread's own
// ---------------------------------------------------------------------------

constexpr int kN16Warps = 8;              // warps per block, each on its own tasks
constexpr int kN16Tiles = 2;              // m16 tiles per task
constexpr int kN16Rows = 16 * kN16Tiles;  // rows per task
constexpr int kN16Stages = 2;             // ring stages: one task in flight

template <bool kRot>
struct N16 {
  // float4 per thread per stage: (tile, row half) x (yr, yi[, cr, si])
  static constexpr int kPlanes = kRot ? 4 : 2;
  static constexpr int kPer = 2 * kN16Tiles * kPlanes;
  static constexpr size_t kSmem = sizeof(float4) * kN16Stages * kPer * 32 * kN16Warps;
};

template <bool kRot>
__global__ void __launch_bounds__(32 * kN16Warps)
bf16_decide_n16(const float* __restrict__ yr, const float* __restrict__ yi,
                const float* __restrict__ cr, const float* __restrict__ si, long long rows,
                long long rows_per_rot, const __nv_bfloat16* __restrict__ wr,
                const __nv_bfloat16* __restrict__ wi, int* __restrict__ out,
                float* __restrict__ peak) {
  using C = N16<kRot>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this thread's ring: float4 k of stage s at ring[(s * kPer + k) * 32], so
  // a warp's copies and reads of one k are 512 contiguous bytes
  float4* ring = reinterpret_cast<float4*>(smem) +
                 (threadIdx.x >> 5) * (kN16Stages * C::kPer * 32) + lane;
  // warp w walks tasks w, w + W, ... (W warps in the grid)
  const long long tasks = (rows + kN16Rows - 1) / kN16Rows;
  const long long stride = static_cast<long long>(gridDim.x) * kN16Warps;
  const long long task = static_cast<long long>(blockIdx.x) * kN16Warps + (threadIdx.x >> 5);
  if (task >= tasks) return;

  // B of n-tile j: bin 8j + g, k slots 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1)
  // of the [bin][16] tables
  uint32_t br[2][2], bi[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int off = (8 * j + g) * 16 + 2 * t;
    br[j][0] = __ldg(reinterpret_cast<const unsigned int*>(wr + off));
    br[j][1] = __ldg(reinterpret_cast<const unsigned int*>(wr + off + 8));
    bi[j][0] = __ldg(reinterpret_cast<const unsigned int*>(wi + off));
    bi[j][1] = __ldg(reinterpret_cast<const unsigned int*>(wi + off + 8));
  }

  // Row half k (tile k / 2) of a task holds this thread's row 8k + g. The
  // rotation rows of the next task to copy move on by adds; rows past the
  // end copy the last row (their results are never written).
  const long long step = stride * kN16Rows, last = rows - 1;
  const long long last_rot = kRot ? last / rows_per_rot : 0;
  RotIndex rot[2 * kN16Tiles], d{0, 0};
  if (kRot) {
#pragma unroll
    for (int k = 0; k < 2 * kN16Tiles; ++k)
      rot[k] = RotIndex::at(task * kN16Rows + 8 * k + g, rows_per_rot);
    d = RotIndex::at(step, rows_per_rot);
  }
  // Copy the next task into the next stage, one commit group (empty past
  // the last task). A thread reads back only what it copied, so a wait
  // on its own groups is all the synchronisation there is.
  long long next = task;
  int s_next = 0;
  auto copy_next = [&]() {
    if (next < tasks) {
#pragma unroll
      for (int k = 0; k < 2 * kN16Tiles; ++k) {
        const long long row = next * kN16Rows + 8 * k + g;
        const long long r = row < rows ? row : last;
        float* dst = reinterpret_cast<float*>(ring + (s_next * C::kPer + k * C::kPlanes) * 32);
        cp_async16(dst, yr + r * 16 + 4 * t, true);
        cp_async16(dst + 128, yi + r * 16 + 4 * t, true);
        if (kRot) {  // through L1: the frame's other rows read them again
          const long long q = row < rows ? rot[k].q : last_rot;
          cp_async16_ca(dst + 256, cr + q * 16 + 4 * t);
          cp_async16_ca(dst + 384, si + q * 16 + 4 * t);
          rot[k] = rot[k].advanced(d, rows_per_rot);
        }
      }
    }
    cp_async_commit();
    next += stride;
    s_next = s_next + 1 == kN16Stages ? 0 : s_next + 1;
  };
#pragma unroll
  for (int i = 0; i < kN16Stages - 1; ++i) copy_next();

  int s_cur = 0;
  for (long long tk = task; tk < tasks; tk += stride) {
    // the task kN16Stages - 1 ahead in flight, then this one's copies landed
    copy_next();
    cp_async_wait<kN16Stages - 1>();
    const float4* st = ring + s_cur * C::kPer * 32;
    s_cur = s_cur + 1 == kN16Stages ? 0 : s_cur + 1;
#pragma unroll
    for (int m = 0; m < kN16Tiles; ++m) {
      // rows g and g + 8 of tile m: derotated op by op, rounded straight
      // into the A registers
      const float4* e0 = st + 2 * m * C::kPlanes * 32;
      const float4* e1 = e0 + C::kPlanes * 32;
      Quad q0, q1;
      q0.yr = e0[0];
      q0.yi = e0[32];
      q1.yr = e1[0];
      q1.yi = e1[32];
      if (kRot) {
        q0.c = e0[64];
        q0.s = e0[96];
        q1.c = e1[64];
        q1.s = e1[96];
      }
      uint32_t ar[4], ai[4], nai[4];
      quad_fragment<kRot>(q0, ar[0], ar[2], ai[0], ai[2]);
      quad_fragment<kRot>(q1, ar[1], ar[3], ai[1], ai[3]);
#pragma unroll
      for (int q = 0; q < 4; ++q) nai[q] = ai[q] ^ 0x80008000u;  // -fi, exactly
      float acc_r[2][4], acc_i[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc_r[j][c] = acc_i[j][c] = 0.0f;
        mma_bf16(acc_r[j], ar, br[j][0], br[j][1]);   // fr @ Wr
        mma_bf16(acc_r[j], nai, bi[j][0], bi[j][1]);  // - fi @ Wi
        mma_bf16(acc_i[j], ar, bi[j][0], bi[j][1]);   // fr @ Wi
        mma_bf16(acc_i[j], ai, br[j][0], br[j][1]);   // fi @ Wr
      }

      // |.|^2 and each row's best bin: element c of n-tile j is row g +
      // 8 (c >> 1), bin 8j + 2t + (c & 1); a thread meets its bins in
      // increasing order, so a strict > keeps the first maximum
      float bv[2] = {neg_inf(), neg_inf()};
      int bk[2] = {16, 16};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float v = mag2(acc_r[j][c], acc_i[j][c]);
          if (v > bv[c >> 1]) {
            bv[c >> 1] = v;
            bk[c >> 1] = 8 * j + 2 * t + (c & 1);
          }
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv[h], off);
          const int ok = __shfl_xor_sync(0xffffffffu, bk[h], off);
          take_max(bv[h], bk[h], ov, ok);
        }
      // every lane of a quad holds its rows' results: lane t = 0 writes row
      // g, t = 1 row g + 8
      if (t < 2) {
        const long long row = tk * kN16Rows + 16 * m + 8 * t + g;
        if (row < rows) {
          out[row] = t == 0 ? bk[0] : bk[1];
          if (peak != nullptr) peak[row] = t == 0 ? bv[0] : bv[1];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// N = 256..4096: the four-step on wgmma, both operands from shared memory
// ---------------------------------------------------------------------------

// d = (scale_d ? d : 0) + kScaleA * A @ B for one m64nNBk16 wgmma with both
// operands in shared memory (no-swizzle K-major, read through `da` / `db`):
// bf16 operands, f32 accumulators in registers (element 4j + c is row
// 16 warp + g + 8 (c >> 1), column 8j + 2t + (c & 1)). kScaleA = -1 negates
// A, exactly. Asynchronous, as wgmma_bf16.
template <int NB, int kScaleA>
__device__ __forceinline__ void wgmma_ss(float (&d)[NB / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(NB == 16 || NB == 32 || NB == 64, "wgmma widths of the four-step");
  if constexpr (NB == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, %11, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kScaleA));
  } else if constexpr (NB == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, %19, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kScaleA));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, %35, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kScaleA));
  }
}

// Offset (in elements) of (row, k) in a [rows][K] bf16 operand in the
// no-swizzle K-major core-matrix layout: 8 x 8 core matrices of 128
// contiguous bytes, k groups side by side (LBO 128 B), 8-row groups 16 K
// bytes apart (SBO); k-step s starts 256 s bytes in.
template <int K>
__device__ __forceinline__ int core_offset(int row, int k) {
  return ((row >> 3) * (K / 8) + (k >> 3)) * 64 + (row & 7) * 8 + (k & 7);
}

template <int N1, int N2>
struct Fs {
  static constexpr int N = N1 * N2;
  // (RB, WGS, kMinBlocks) are ops/bf16_decide.py's FOURSTEP_TILE, which
  // the tests use to land on tile edges: change both together.
  // warpgroups a block, each on its own tiles, and blocks an SM: two and
  // two at N <= 1024 (128 registers a thread), three and one above
  static constexpr int WGS = N >= 2048 ? 3 : 2;
  static constexpr int kMinBlocks = N >= 2048 ? 1 : 2;
  // frame rows per tile: stage 1's M (RB N1) is one m64 tile, four at N =
  // 256 (where a 1024-sample tile was held by its fixed costs)
  static constexpr int RB = N == 256 ? 16 : kWgRows / N1;
  static constexpr int M1 = RB * N1;        // stage 1's rows (rb, i1)
  static constexpr int MT = M1 / kWgRows;   // its m64 chains
  static constexpr int M2 = RB * N2;        // stage 2's rows (rb, k2)
  static constexpr int CH2 = M2 / kWgRows;  // its m64 chains
  // f32 per staged frame row: + 16 puts the two frame rows a warp reads at
  // N1 = 16 on disjoint banks
  static constexpr int LDS = N + 16;
  static constexpr int kPlane = RB * LDS;    // f32 per staged plane
  static constexpr int kT1 = N2 * N2;        // bf16 per stage-1 table [k2][i2]
  static constexpr int kT2 = N1 * N1;        // bf16 per stage-2 table [k1][i1]
  static constexpr int kA1 = M1 * N2;        // bf16 per xst plane [(rb, i1)][i2]
  static constexpr int kA2 = M2 * N1;        // bf16 per bs plane [(rb, k2)][i1]
  static constexpr int kA = kA1 > kA2 ? kA1 : kA2;  // xst, then bs in its place
  static constexpr int kTw = kWgRows * N2;   // f32 per twiddle plane, fragment order
  static constexpr int kSlots = 4 * CH2;     // (value, bin) of each warp and chain
  static constexpr size_t kWgBytes =
      (sizeof(float) * 2 * kPlane + sizeof(__nv_bfloat16) * 2 * kA +
       (sizeof(float) + sizeof(int)) * kSlots + 127) / 128 * 128;
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * 2 * (kT1 + kT2) + sizeof(float) * 2 * kTw + WGS * kWgBytes;
  static_assert(N1 % 16 == 0 && N2 % 16 == 0 && M1 % kWgRows == 0 && M2 % kWgRows == 0,
                "four-step shape");
  static_assert(kMinBlocks * kSmem <= 227 * 1024, "shared memory of an SM");
};

// Start the copies of tile `tile` (RB frame rows, contiguous in device
// memory; rows past `rows` zero-filled) into a stage [plane][RB][LDS], by
// the 128 threads of one warpgroup.
template <int N1, int N2>
__device__ __forceinline__ void copy_frames(const float* __restrict__ yr,
                                            const float* __restrict__ yi, long long rows,
                                            long long tile, float* dst, int tid) {
  using F = Fs<N1, N2>;
  constexpr int kChunks = F::RB * F::N / 4;  // 16-byte chunks per plane
#pragma unroll 4
  for (int i = tid; i < kChunks; i += kWgThreads) {
    const int rb = i / (F::N / 4), q = i % (F::N / 4);
    const long long row = tile * F::RB + rb;
    const bool live = row < rows;
    const long long off = (live ? row : 0) * F::N + 4 * q;
    float* d = dst + rb * F::LDS + 4 * q;
    cp_async16(d, yr + off, live);
    cp_async16(d + F::kPlane, yi + off, live);
  }
}

// The rotation-plane row of frame row `row` (rows past the end take the
// last row's; never written)
__device__ __forceinline__ long long rot_of(long long row, long long rows,
                                            long long rows_per_rot) {
  return (row < rows ? row : rows - 1) / rows_per_rot;
}

template <int N1, int N2, bool kRot>
__global__ void __launch_bounds__(Fs<N1, N2>::WGS * kWgThreads, Fs<N1, N2>::kMinBlocks)
bf16_decide_fourstep(const float* __restrict__ yr, const float* __restrict__ yi,
                     const float* __restrict__ cr, const float* __restrict__ si, long long rows,
                     long long rows_per_rot, const __nv_bfloat16* __restrict__ w1r,
                     const __nv_bfloat16* __restrict__ w1i, const __nv_bfloat16* __restrict__ w2r,
                     const __nv_bfloat16* __restrict__ w2i, const float* __restrict__ twr,
                     const float* __restrict__ twi, int* __restrict__ out,
                     float* __restrict__ peak) {
  using F = Fs<N1, N2>;
  constexpr int N = F::N, RB = F::RB, M1 = F::M1, WGS = F::WGS;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_w1r = reinterpret_cast<__nv_bfloat16*>(smem);  // stage 1: M(N2)
  __nv_bfloat16* s_w1i = s_w1r + F::kT1;
  __nv_bfloat16* s_w2r = s_w1i + F::kT1;  // stage 2: M1R
  __nv_bfloat16* s_w2i = s_w2r + F::kT2;
  float* s_twr = reinterpret_cast<float*>(s_w2i + F::kT2);
  float* s_twi = s_twr + F::kTw;
  const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
  unsigned char* mine = reinterpret_cast<unsigned char*>(s_twi + F::kTw) + wg * F::kWgBytes;
  float* stage = reinterpret_cast<float*>(mine);
  // xst [(rb, i1)][i2] (real plane, then imaginary) until stage 1 has read
  // it, then bs [(rb, k2)][i1] in its place
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(stage + 2 * F::kPlane);
  float* s_pv = reinterpret_cast<float*>(s_x + 2 * F::kA);
  int* s_pk = reinterpret_cast<int*>(s_pv + F::kSlots);

  // block b takes a contiguous run of tiles (frames that share a rotation
  // row stay on one SM); its warpgroups alternate through it
  const long long tiles = (rows + RB - 1) / RB;
  const long long per = (tiles + gridDim.x - 1) / gridDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * per;
  const long long end = first + per < tiles ? first + per : tiles;
  long long tile = first + wg;
  // the first tile's rows in flight, then the tables and twiddles, as bytes
  if (tile < end) copy_frames<N1, N2>(yr, yi, rows, tile, stage, tid);
  cp_async_commit();
  for (int i = threadIdx.x; i < F::kT1 / 8; i += WGS * kWgThreads) {
    reinterpret_cast<uint4*>(s_w1r)[i] = __ldg(reinterpret_cast<const uint4*>(w1r) + i);
    reinterpret_cast<uint4*>(s_w1i)[i] = __ldg(reinterpret_cast<const uint4*>(w1i) + i);
  }
  for (int i = threadIdx.x; i < F::kT2 / 8; i += WGS * kWgThreads) {
    reinterpret_cast<uint4*>(s_w2r)[i] = __ldg(reinterpret_cast<const uint4*>(w2r) + i);
    reinterpret_cast<uint4*>(s_w2i)[i] = __ldg(reinterpret_cast<const uint4*>(w2i) + i);
  }
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int i = threadIdx.x; i < F::kTw / 4; i += WGS * kWgThreads) {
    reinterpret_cast<float4*>(s_twr)[i] = __ldg(reinterpret_cast<const float4*>(twr) + i);
    reinterpret_cast<float4*>(s_twi)[i] = __ldg(reinterpret_cast<const float4*>(twi) + i);
  }
  fence_proxy_async();
  __syncthreads();

  const uint32_t x_addr = smem_u32(s_x);
  const uint32_t w1r_addr = smem_u32(s_w1r), w1i_addr = smem_u32(s_w1i);
  const uint32_t w2r_addr = smem_u32(s_w2r), w2i_addr = smem_u32(s_w2i);
  // the xst rows this thread derotates: M1 / 128 whole rows, or at M1 = 64
  // every other k group of row tid % 64
  constexpr int kXRows = M1 >= kWgThreads ? M1 / kWgThreads : 1;
  constexpr int kKgStep = M1 >= kWgThreads ? 1 : kWgThreads / M1;

  for (; tile < end; tile += WGS) {
    // this tile's rows have landed (every thread's copies of the warpgroup)
    cp_async_wait_all();
    wg_barrier(wg);
    const long long row0 = tile * RB;
    if (kRot && tile + WGS < end) {  // the next tile's new planes, into L1 meanwhile
      const long long cur = rot_of(row0 + RB - 1, rows, rows_per_rot);
      const long long nf = rot_of(row0 + WGS * RB, rows, rows_per_rot);
      const long long nl = rot_of(row0 + WGS * RB + RB - 1, rows, rows_per_rot);
      for (int l = tid; l < N / 32; l += kWgThreads) {
        if (nf != cur) {
          prefetch_plane<N>(cr + nf * N, l);
          prefetch_plane<N>(si + nf * N, l);
        }
        if (nl != nf) {
          prefetch_plane<N>(cr + nl * N, l);
          prefetch_plane<N>(si + nl * N, l);
        }
      }
    }

    // 1. derotate and round: sample i = i2 N1 + i1 of frame row rb goes to
    //    xst[(rb, i1)][i2], eight i2 (one 16-byte core-matrix row) at a
    //    time; the lanes of a warp take consecutive rows
#pragma unroll
    for (int xr = 0; xr < kXRows; ++xr) {
      const int xrow = M1 >= kWgThreads ? tid + kWgThreads * xr : tid % M1;
      const int xrb = xrow / N1, xi1 = xrow % N1;
      const float* pr = stage + xrb * F::LDS + xi1;
      const float* pc = nullptr;
      const float* ps = nullptr;
      if (kRot) {
        const long long rot = rot_of(row0 + xrb, rows, rows_per_rot);
        pc = cr + rot * N + xi1;
        ps = si + rot * N + xi1;
      }
#pragma unroll
      for (int kg = M1 >= kWgThreads ? 0 : tid / M1; kg < N2 / 8; kg += kKgStep) {
        float fr[8], fi[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = (8 * kg + e) * N1;
          fr[e] = pr[i];
          fi[e] = pr[i + F::kPlane];
          if (kRot) derotate(fr[e], fi[e], __ldg(pc + i), __ldg(ps + i), fr[e], fi[e]);
        }
        __nv_bfloat16* px = s_x + core_offset<N2>(xrow, 8 * kg);
        *reinterpret_cast<uint4*>(px) =
            make_uint4(pack_bf16(fr[0], fr[1]), pack_bf16(fr[2], fr[3]),
                       pack_bf16(fr[4], fr[5]), pack_bf16(fr[6], fr[7]));
        *reinterpret_cast<uint4*>(px + F::kA) =
            make_uint4(pack_bf16(fi[0], fi[1]), pack_bf16(fi[2], fi[3]),
                       pack_bf16(fi[4], fi[5]), pack_bf16(fi[6], fi[7]));
      }
    }
    fence_proxy_async();
    wg_barrier(wg);
    // the stage is free: the next tile's rows come in under the rest of
    // this tile (and the other warpgroups' work)
    if (tile + WGS < end) copy_frames<N1, N2>(yr, yi, rows, tile + WGS, stage, tid);
    cp_async_commit();

    // 2. stage 1: a[(rb, i1)][k2] = xst @ M(N2), one m64 chain per 64 rows,
    //    four products a k-step (the first of each accumulator ignores what
    //    the registers hold)
    float acc_r[F::MT][N2 / 2], acc_i[F::MT][N2 / 2];
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < F::MT; ++m)
#pragma unroll
      for (int s = 0; s < N2 / 16; ++s) {
        const uint32_t a0 = 128 * N2 * m + 256 * s;  // 8 row groups of 16 N2 bytes
        const uint64_t ar = smem_desc(x_addr + a0, 128, 16 * N2);
        const uint64_t ai = smem_desc(x_addr + 2 * F::kA + a0, 128, 16 * N2);
        const uint64_t wr = smem_desc(w1r_addr + 256 * s, 128, 16 * N2);
        const uint64_t wi = smem_desc(w1i_addr + 256 * s, 128, 16 * N2);
        wgmma_ss<N2, 1>(acc_r[m], ar, wr, s > 0);  // xr @ Wr
        wgmma_ss<N2, 1>(acc_i[m], ar, wi, s > 0);  // xr @ Wi
        wgmma_ss<N2, -1>(acc_r[m], ai, wi, 1);  // - xi @ Wi
        wgmma_ss<N2, 1>(acc_i[m], ai, wr, 1);   // xi @ Wr
      }
    wgmma_commit();
    wgmma_wait<0>();
    wg_barrier(wg);  // every warp's share of stage 1 has read xst

    // 3. the twiddle in f32, op by op, rounded to bf16 into bs[(rb, k2)][i1]
    //    (row r = 64 m + 16 warp + g + 8 (c >> 1) of stage 1 is (rb, i1))
#pragma unroll
    for (int j = 0; j < N2 / 8; ++j) {
      // this thread's four twiddles of n-tile j (its rows' i1 are the same
      // in every chain and tile)
      const int tw = ((warp * (N2 / 8) + j) * 32 + lane) * 4;
      const float4 tr = *reinterpret_cast<const float4*>(s_twr + tw);
      const float4 ti = *reinterpret_cast<const float4*>(s_twi + tw);
      const float twr4[4] = {tr.x, tr.y, tr.z, tr.w}, twi4[4] = {ti.x, ti.y, ti.z, ti.w};
#pragma unroll
      for (int m = 0; m < F::MT; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = kWgRows * m + 16 * warp + g + 8 * (c >> 1);
          const int k2 = 8 * j + 2 * t + (c & 1);
          float br, bi;
          derotate(acc_r[m][4 * j + c], acc_i[m][4 * j + c], twr4[c], twi4[c], br, bi);
          const int off = core_offset<N1>((r / N1) * N2 + k2, r % N1);
          s_x[off] = __float2bfloat16_rn(br);
          s_x[off + F::kA] = __float2bfloat16_rn(bi);
        }
    }
    fence_proxy_async();
    wg_barrier(wg);

    // 4. stage 2: c[(rb, k2)][k1] = bs @ M1R, one m64 chain per 64 rows
    float acc2_r[F::CH2][N1 / 2], acc2_i[F::CH2][N1 / 2];
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < F::CH2; ++h)
#pragma unroll
      for (int s = 0; s < N1 / 16; ++s) {
        const uint32_t a0 = 128 * N1 * h + 256 * s;  // 8 row groups of 16 N1 bytes
        const uint64_t ar = smem_desc(x_addr + a0, 128, 16 * N1);
        const uint64_t ai = smem_desc(x_addr + 2 * F::kA + a0, 128, 16 * N1);
        const uint64_t wr = smem_desc(w2r_addr + 256 * s, 128, 16 * N1);
        const uint64_t wi = smem_desc(w2i_addr + 256 * s, 128, 16 * N1);
        wgmma_ss<N1, 1>(acc2_r[h], ar, wr, s > 0);  // br @ Wr
        wgmma_ss<N1, 1>(acc2_i[h], ar, wi, s > 0);  // br @ Wi
        wgmma_ss<N1, -1>(acc2_r[h], ai, wi, 1);  // - bi @ Wi
        wgmma_ss<N1, 1>(acc2_i[h], ai, wr, 1);   // bi @ Wr
      }
    wgmma_commit();
    wgmma_wait<0>();

    // 5. |.|^2 and the first maximum over natural bins k1 N2 + k2: a thread
    //    meets its bins in increasing order (k1 = 8j + 2t + e, then row k2
    //    before k2 + 8), so a strict > keeps the first; a warp's 16 rows of a
    //    chain lie in one frame row, so then the warp's (shuffles), then the
    //    frame row's over its warps' slots
#pragma unroll
    for (int h = 0; h < F::CH2; ++h) {
      const int k2 = (kWgRows * h + 16 * warp + g) % N2;
      float bv = neg_inf();
      int bk = N;
#pragma unroll
      for (int j = 0; j < N1 / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int c = 2 * hh + e;
            const float v = mag2(acc2_r[h][4 * j + c], acc2_i[h][4 * j + c]);
            if (v > bv) {
              bv = v;
              bk = (8 * j + 2 * t + e) * N2 + k2 + 8 * hh;
            }
          }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int ok = __shfl_xor_sync(0xffffffffu, bk, off);
        take_max(bv, bk, ov, ok);
      }
      if (lane == 0) {
        s_pv[4 * h + warp] = bv;  // slot 4h + warp holds stage-2 rows from 16 (4h + warp)
        s_pk[4 * h + warp] = bk;
      }
    }
    wg_barrier(wg);
    if (tid < RB && row0 + tid < rows) {
      constexpr int kPer = N2 / 16;  // slots per frame row
      float v = s_pv[tid * kPer];
      int k = s_pk[tid * kPer];
#pragma unroll
      for (int q = 1; q < kPer; ++q) take_max(v, k, s_pv[tid * kPer + q], s_pk[tid * kPer + q]);
      out[row0 + tid] = k;
      if (peak != nullptr) peak[row0 + tid] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// Launch: a persistent grid of the blocks the card holds at once
// ---------------------------------------------------------------------------

// Blocks of `kernel` resident on the current device at once (with its
// dynamic shared memory allowed), queried once per device and kept.
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
  cudaError_t err = resident_blocks(kernel, kThreads, smem, cache, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (a.rows + Direct<N>::R - 1) / Direct<N>::R;
  const long long blocks = tiles < resident ? tiles : resident;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, a.stream>>>(
      a.yr, a.yi, a.cr, a.si, a.rows, a.rows_per_rot, a.wa_r, a.wa_i, a.out, a.peak);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRot>
int launch_n16(const Args& a) {
  static std::atomic<long long> cache[64];
  auto kernel = bf16_decide_n16<kRot>;
  constexpr int threads = 32 * kN16Warps;
  constexpr size_t smem = N16<kRot>::kSmem;
  long long resident = 0;
  cudaError_t err = resident_blocks(kernel, threads, smem, cache, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tasks = (a.rows + kN16Rows - 1) / kN16Rows;
  const long long groups = (tasks + kN16Warps - 1) / kN16Warps;
  const long long blocks = groups < resident ? groups : resident;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, a.stream>>>(
      a.yr, a.yi, a.cr, a.si, a.rows, a.rows_per_rot, a.wa_r, a.wa_i, a.out, a.peak);
  return static_cast<int>(cudaGetLastError());
}

template <int N, bool kRot>
int launch_wgmma(const Args& a) {
  static std::atomic<long long> cache[64];
  auto kernel = bf16_decide_wgmma<N, kRot>;
  constexpr size_t smem = Wg<N>::kSmem;
  long long resident = 0;
  cudaError_t err = resident_blocks(kernel, kWgs * kWgThreads, smem, cache, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pairs = (a.rows + kWgs * kWgRows - 1) / (kWgs * kWgRows);
  const long long blocks = pairs < resident ? pairs : resident;
  kernel<<<static_cast<unsigned>(blocks), kWgs * kWgThreads, smem, a.stream>>>(
      a.yr, a.yi, a.cr, a.si, a.rows, a.rows_per_rot, a.wa_r, a.wa_i, a.out, a.peak);
  return static_cast<int>(cudaGetLastError());
}

template <int N1, int N2, bool kRot>
int launch_fourstep(const Args& a) {
  using F = Fs<N1, N2>;
  static std::atomic<long long> cache[64];
  auto kernel = bf16_decide_fourstep<N1, N2, kRot>;
  constexpr int threads = F::WGS * kWgThreads;
  long long resident = 0;
  cudaError_t err = resident_blocks(kernel, threads, F::kSmem, cache, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (a.rows + F::RB - 1) / F::RB;
  const long long groups = (tiles + F::WGS - 1) / F::WGS;
  const long long blocks = groups < resident ? groups : resident;
  kernel<<<static_cast<unsigned>(blocks), threads, F::kSmem, a.stream>>>(
      a.yr, a.yi, a.cr, a.si, a.rows, a.rows_per_rot, a.wa_r, a.wa_i, a.wb_r, a.wb_i, a.twr,
      a.twi, a.out, a.peak);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRot>
int dispatch(int n, const Args& a) {
  switch (n) {
    case 4: return launch_direct<4, kRot>(a);
    case 8: return launch_direct<8, kRot>(a);
    case 16: return launch_n16<kRot>(a);
    case 32: return launch_wgmma<32, kRot>(a);
    case 64: return launch_wgmma<64, kRot>(a);
    case 128: return launch_wgmma<128, kRot>(a);
    // (n1, n2) of the four-step split (ops/fft.py::_split)
    case 256: return launch_fourstep<16, 16, kRot>(a);
    case 512: return launch_fourstep<16, 32, kRot>(a);
    case 1024: return launch_fourstep<32, 32, kRot>(a);
    case 2048: return launch_fourstep<32, 64, kRot>(a);
    case 4096: return launch_fourstep<64, 64, kRot>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// yr, yi: [rows, n] f32; cr, si: [rows / rows_per_rot, n] f32 rotation
// planes or both null (no derotation); row r uses rotation
// r / rows_per_rot. wa_r, wa_i: the bf16 DFT tables Wr, Wi transposed,
// [bin][k] — for n = 32..128 [n][n] in the wgmma layout
// (ops/bf16_decide.py::wgmma_layout), for n = 16 [16][16] with k permuted
// as in it (ops/bf16_decide.py::_wgmma_columns), for n = 4, 8 [8][16]
// zero-padded, for n > 128 stage 1's [n2][n2] in the layout without the k
// permutation; wb_r, wb_i: stage 2's [n1][n1] in it (null for n <= 128);
// twr, twi: the f32 twiddles, [64 n2] in the order of
// ops/bf16_decide.py::fourstep_twiddles (null for n <= 128). out: [rows]
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
