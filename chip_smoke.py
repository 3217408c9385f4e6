#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (lora_phy_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout (the kernels are built
from ``lora_phy_tpu_torch/csrc`` into ``build/lora_phy_tpu_torch/``).
Imports no JAX. Phases, one line each (or a few):

0. the card: ``nvidia-smi`` name and power limit, and torch's device name;
1. build and load the CUDA kernels (seconds: one nvcc per source, in parallel);
2. the kernel against its plain PyTorch twin on the card: SF2-7 (one
   thread per row at SF2-4), with and without the Hann window, at random
   nonzero start/rate and a per-row amplitude scale — clean chirp rows
   bit-equal, noise rows (a ragged count) differing only at float32
   near-ties — and the equal-power tie row (bin 0); then
   demodulate_planar(fused=True) at SF2, 3 and 4 over 8 x 1024 frames of
   32-byte payloads packed into SF-bit symbols (known zero offsets: the
   2-symbol estimator reads the wrapped sync word 0x12 as an offset at
   N < 32, in both packages): one launch per call, every payload
   decoded bit-exact, sync 0x12, the plain path's symbols;
3. the main path at bench.py's headline size: 8 channels x 8192 frames of
   32-byte SF7 BW125 payloads (66 symbols x 128 samples per frame, 554 M IQ
   samples), encode -> modulate_planar -> dechirp_planar ->
   demodulate_planar(fused=True) -> decode on the card; every payload
   decoded bit-exact, sync 0x12, the kernel launched; per-stage times
   (CUDA events, median after a warm-up);
4. the same demod with fused=False (the plain torch path): the same
   symbols; both times, the kernel against its twin on the main path's
   own rows and scale, its bound, the time of cuFFT's DFT alone over the
   same rows (a yardstick the port never calls), and one torch.profiler
   pass of the fused demod;
5. the block receiver at bench.py's block-receive width: 8 channels x 512
   frames of one 16-byte SF7 BW125 payload each (32 symbols, 4 zero
   windows after every frame: 25.3 M IQ samples per plane) through
   models.sync.receive_block_planar on its circular path; at least
   8 x 511 frames found, every found frame bit-exact with sync 0x12,
   starts increasing per channel; the median time, Gsamples/s and
   frames/s, and one torch.profiler pass (top device ops, idle share);
6. the barrel path and the stream receiver at reduced width (8 channels
   x 64 frames): the same stream at osr 2 and at osr 1 with the Hann
   window, every frame bit-exact; BatchStreamDemodulator over one
   phase-5 channel in fixed blocks, every frame once at its true start;
7. the block receiver on the card against the same call on the CPU
   (2 channels x 16 frames): equal found / start / cfo_bins / symbols /
   sync;
8. the coded main path (explicit-header chain's payload coding: CRC16,
   whitening, CR 4/5 parity, interleaving) at the headline width: 8
   channels x 8192 frames of 32-byte payloads, 50 coded symbols each
   (436 M IQ samples), encode_payload -> modulate_planar ->
   dechirp_planar -> demodulate_planar(fused=True) -> decode_payload
   through the kernel; every payload bit-exact, crc_ok, fec_errors 0,
   sync 0x12, fused=False the same symbols; then CR 4/6-4/8 and LDRO at
   1 x 1024 frames; decode_payload_soft on one channel's spectra (its
   peak memory); CUDA-event times of encode_payload, decode_payload and
   decode_payload_soft;
9. the gateway stream: AdaptiveStreamDemodulator, hard and soft, over
   256 frame_encode frames (lengths 1-255, CR 1-4, CRC on and off, gaps
   of 0-3 symbols) of one SF7 channel in blocks of 65,536 samples, every
   frame once at its true start with its length, CR, CRC flag and bytes;
   frames/s and host seconds per frame; a profile of one block; then 8
   SF12 LDRO frames in blocks of 1 << 20;
10. soft vs hard under AWGN (the first 64 frames of phase 9 at
   PHASE10_SNR_DB): soft decodes at least as many CRC-clean frames, no
   wrong frame passes its CRC; the adaptive receiver on the card against
   the CPU on a 16-frame prefix; the block receiver's soft path
   (receive_block_planar with spectra -> hamming84_ml_decode) on phase
   5's stream;
11. the wideband gateway at bench.py's shape: channelize_planar (K=8, bench's
   default 7 taps per branch) over 2**25 seeded Gaussian samples, timed, its
   first 2**16 samples against the CPU (atol 1e-5); receive_wideband_planar
   (15 taps per branch) over 8 channels x 512 frames of phase 5's payloads
   synthesised by synthesize_channels_planar (25.3 M wideband samples): at least 8 x 511 frames, all bit-exact, sync 0x12;
   its time with and without spectra, a profile, and card vs CPU decisions on
   a 2-frame-per-channel prefix;
12. the other block modes: pre_acc=3 (lora-rx-stream --robust) on phase 5's
   stream, every decision equal to pre_acc=1's, timed; the near-equal-power
   two-ray channel (apply_multipath_planar, numpy AWGN at 5 dB, 15 trials as
   channels) decoded on the card as on the CPU; loud noise gives no frame;
   cad_planar over phase 5's stream (active) and silence (inactive), timed
   against the receiver; receive_blind_planar over one stream holding one frame
   at each of SF7-12, all six found with their SF and bytes; the
   --frontend-correct loop (apply_frontend, estimate, compensate, decode);
13. SIC at lora-rx-stream --sic's settings (SF7, 65,536-sample blocks,
   max_frames 8): two overlapping frames at sic_sweep.py's gaps of 3-15 dB, 20
   dB SNR (numpy noise), weak-frame recovery per gap and host ms per peel; one
   profile; the card's frame lists against the CPU's on one trial per gap;
14. the command line (lora_phy_tpu_torch.runners) on the card: tx_stream
   writes 4096 frames of 16-byte SF7 payloads (gap 1024) as cf32 and as
   ci16, rx_stream reads each in 65,536-sample blocks (--max-frames=16: a
   buffer holds up to 10.7 frames): every frame once at its true start
   with its bytes; wall s, frames/s, host ms per block, beside
   receive_block_planar alone over the same buffers; --adaptive and
   --adaptive --soft over 256 tx_stream --coded --crc frames of 1-255
   bytes (all crc=ok); --channels=8 over phase 11's wideband traffic as
   cf32 (all 4096 frames); a real shell pipe `python -m ...tx_stream |
   python -m ...rx_stream` in which neither process imports jax or
   lora_phy_tpu; a checkpoint written by the card run resumed with
   --device=cpu; --robust, --sf=auto, --sic, --cad and --soft against the
   port's own --device=cpu run; gr_interop frames
   (SF7 explicit, SF12 LDRO implicit, hard and soft) equal on card and CPU;
   tx_runner / rx_runner and gr_decode on the card against the CPU;
15. the AWGN Monte Carlo (models.awgn.simulate_planar) at sweep scale: SF7
   CR 4/5 with 65,536 packets of 16 bytes per point and SF12 with 4096,
   over -20..0 dB in 2 dB steps plus 12 and -25 dB: device ms and
   packets/s per point, peak memory, a profile of one point; PER 0 at 12
   dB, above 0.5 at -25 dB, weakly monotone; a 256-packet prefix with the
   same injected draws, at the point nearest PER 0.5, gives the same error
   counts on the card and the CPU; awgn_sweep's default run and its CSV
   header;
16. the flowgraph (models/flowgraph.py): test_flowgraph.py's simulation
   graph (test_gen, encoder, modulator, numpy-seeded noise, adder,
   demodulator, decoder, probe) for 16 ticks at SF7 (at the knee) and SF12
   on the card and on the CPU: the same messages, drop counts and CFO
   signals, snr within 1e-2 dB; host ms per tick; topology_runner on a
   .pth the phase writes (topology_doc: a breaker net, a disabled block,
   signal wires, an implicit decoder with dataLength), its lines equal to
   --device=cpu's;
17. the mesh receivers (parallel/) on meshes of shards sharing the card:
   (a) demodulate_stream_planar over the main path's traffic (8 channels x
   8192 frames laid end to end, 553.6 M samples) at 1x1, 1x4 and 2x4,
   payloads bit-exact and symbols equal across meshes, CUDA-event ms with
   comm=True and comm=False, peak memory; (b) receive_stream_block_planar
   over phase 5's stream at the same meshes, the single-device receiver's
   frames, ms and a profile; (c) rx_stream --mesh=1 over phase 14's file,
   the lines of plain rx_stream, --mesh beyond the cards refused, a mesh
   checkpoint from the card resumed on the CPU; (d) the mesh's soft
   spectra against the single device's (2e-5 of the peak), the blind mesh
   receiver over phase 12's stream, the adaptive one over phase 9's; (e)
   two gloo processes of two shards each and one NCCL process at world
   size 1 (this script with --mesh-worker), symbols equal to the single
   device; (f) bench_scaling --devices=1;
18. the last slice of runners: (a) vector_generate on the card against
   the CPU (both the port) over VECTOR_CELLS at 255-byte payloads (SF7-12,
   and the tests' oversampled, windowed and impaired cells): the decision
   files hash-equal, each IQ CSV by hash or within the TX / injector
   tolerance plus one printed digit; comprehensive_vector_generate's two
   corpus files equal; vector_dump and compare_vectors as CLIs; (b)
   perf_test --packets=1000 over its default profiles and over
   profiles/perf_matrix.yaml, compare_perf of each CSV against itself (exit
   0) and against a copy with one pps halved (exit 1); (c) roofline at its
   defaults (8 x 8192 SF7 frames, 1 x 1024 SF12): dispatch overhead,
   bandwidth, each SF's time against its floors; (d) sic_sweep over its
   default gaps with 16 trials per gap (a cut from its 40, for time): the
   weak frame recovered by SIC at least as often as by the plain pass, the
   strong one every time; (e) scope's panels and rows on the card against
   the CPU over phase 14's cf32 file, and its PNG where matplotlib is
   installed (else the CLI's exit 1); (f) utils.profiling.trace around one
   demodulate_planar call: a Chrome trace naming CUDA kernels;
19. the bf16 decision kernel (csrc/bf16_decide.cu, the precision="bf16"
   path): the bf16_decide launches of every path of phases 3-18 (0 each);
   (a) the kernel against its plain PyTorch version at SF2-12, with and
   without the Hann window: clean tones (a random bin, CFO and amplitude
   per frame) equal with and without their rotation planes and at their
   bins; 4095 noise rows equal outside bf16_decide.near_tie, the excluded
   rows counted; tie rows to the lowest natural bin; (b) the SF7 main path
   at bench.py's shape (8 x 8192 frames) through
   demodulate_planar(precision="bf16") (the wgmma design; (a) and (b)
   print the design that serves each N): every payload bit-exact, sync 0x12,
   one launch per call (counted), offsets equal to float32's; its time
   against plain f32 and fused=True; the kernel alone on the path's rows
   against its bound, its plain version and cuBLAS's bf16 GEMM on the same
   operands (a yardstick the port never calls); where the kernel's time
   goes (copies of its source without the products, the epilogue, the
   row copies, the derotation or the rotation prefetch); a profile; (c) the same at
   SF8-12 (the four-step on wgmma) over one channel of 1024 x 2^(12 - SF)
   frames (276.8 M samples each, SF12's being roofline's), where the time
   goes taken at SF12 (copies without either stage's products, the row
   copies, the bs writes, the combine or the derotation); (d) bf16
   against f32 decisions under AWGN at SF7 (393,216 data symbols at 0, -6
   and -9 dB per sample); (e) card against CPU decisions on 16 frames with
   CFOs at SF7 and SF12; (f) the SF5 path (N = 32, the wgmma kernel): 8 x
   32,768 frames of 32-byte payloads packed into 52 five-bit symbols
   (pack_symbols; 453.0 M samples) through demodulate_planar(precision=
   'bf16') with the estimator: the sent symbols back, every payload
   unpacked bit-exact, sync 0x12, one launch per call; the demod against
   plain f32 and fused=True, the kernel alone as in (b), and where its time
   goes (BF16_N32_ABLATIONS: constant planes, no derotation, no prefetch,
   a division per tile, one block an SM); (g) the same at SF4 (N = 16, the
   mma.sync kernel with A in registers: 8 x 65,536 frames of 64 four-bit
   symbols, 553.6 M samples, known zero offsets) and SF6 (N = 64: 8 x
   19,648 frames of 43 six-bit symbols, 452.7 M samples, the estimator).
   (b), (f) and (g) count one fused=True call each too (one fused_demod
   launch, every payload bit-exact);
20. (a) bench.py on the port (lora_phy_tpu_torch.runners.bench.main, in
   this process) three ways: f32 plain, --fused and --precision=bf16, each
   line printed: rc 0, every value non-null (its decode and coverage gates
   raise inside), fused_demod launched once per headline call under
   --fused and never otherwise, bf16_decide once per headline and SF12
   call under --precision=bf16 and never otherwise; (b) the block
   receiver's stage profile at bench shape (tools/torch_profile_block_rx.py:
   device ms, host ms and launches of each record_function range), the
   stages' device ms within 10 % of the call's busy time, the untraced
   stage markers under 2 % of the call; the bulk coded call (dechirp_planar
   -> demodulate_planar(fused=True) -> decode_payload, 8 x 8192 frames at
   a 0.3-bin CFO) untraced with its stage ranges and host-sync counters
   against the same call with them patched to no-ops, in turns: at most
   2 % slower, two host syncs a call, one dechirp launch a call; then one
   bulk call at the SF12 cell's shape (phybench bulk-sf12-b3328: 8 x 416
   frames, fused=False): 106,496 rows decided (30 data symbols and the sync
   pair a frame), every payload back, two host syncs, one launch of the
   decide kernel and none of fused_demod or bf16_decide, 72 CR 4/5
   codewords a frame counted (coded.CODEWORDS); then one bulk call of the
   SF9 cell's shape on its traffic (phybench bulk-sf9-b13312: 8 x 1664
   frames of 66 symbols of 512 at -15..5 dB, CR 4/8): one decide launch,
   958,464 codewords counted (coded.CODEWORDS[4]), flagged codewords in
   some frames, bytes, crc_ok and fec_errors equal to the benchmark
   reference's decode of the same symbols; (c) both kernels
   alone at N = 4, 8, 16, 32 and 64 over rows x N = 553,648,128 samples (the
   SF7 main path's): fused_demod without and with the Hann window,
   bf16_decide with and without rotation, on tone rows whose CFO and
   amplitude the call takes out: bins equal to the plain version's outside
   near-ties and at the tones' bins; time, bound and share, the plain
   version's time and the library yardstick's (cuFFT's DFT alone, cuBLAS's
   bf16 GEMM alone); (d) the dechirp kernel (csrc/dechirp.cu) at the bulk
   cell's shape, 8 x 8192 x 6,656 samples: its planes bit-equal to its
   eager twin's, both times, its bytes bound and share, the memory a call
   takes beyond its inputs; then on an offset view (its scalar path),
   bit-equal too; (e) the windows kernel (csrc/windows.cu) at the same
   shape, 52 x 128 windows a frame, random nonzero offsets: its planes
   bit-equal to its eager twin's (pad, int64 index, gather, select), both
   times, its bytes bound and share, the memory a call takes; its launches
   and zero-offset views on each path (1 and 0 a bulk call, no launch on
   the block receiver's paths); (f) the gateway scan kernel (csrc/scan.cu)
   at both gateway cells' shapes, the benchmark's traffic (2048 x 65,536
   samples at SF7, 128 x 2^20 at SF12): its bins against its twin's
   (scan_peaks_reference: four dechirp planes, two stacks, the planar DFT)
   equal outside near-ties, the near-ties counted, its peaks within a
   relative 2e-5, both times, the benchmark's frozen count's bound
   (phybench/metrics/scan_bound.py) and the share, the memory a call takes;
   the scan's launches and spectra calls on each path (one launch a scan at
   pre_acc 1 on the card, none on the bulk path); (g) the f32 decide kernel
   (csrc/decide.cu) at both wide bulk cells' shapes, their traffic (8 x 416
   frames x 32 rows of 4096; 8 x 1664 frames x 66 rows of 512): its bins
   against its twin's (decide_reference:
   the derotated planes, the torch four-step's argmax) equal outside
   near-ties, the near-ties counted, both times, the benchmark's frozen
   count's bound (phybench/metrics/kernel_bound.py) and the share, the
   memory a call takes; its launches on each path; (h) the lanes kernel
   (csrc/lanes.cu) on one call of the SF12 gateway cell's lanes (its
   traffic, 128 x 2^20 samples: 1,024 lanes x 34 derotated and 32 raw rows
   of 4096, taken from the receiver as it calls the kernel): one launch in
   that call and none with the spectra, its bins against its twin's
   (lane_spectra_reference) equal outside near-ties, the near-ties counted,
   peaks, sums and the clock drift's powers within a relative 1e-5; both
   times, the bound (every row read once, 66 FFTs a lane) and the share;
   the peak memory of the receiver's call with the kernel and with the
   twin; its launches on each path;
21. the repo-level twins of the files that drive the JAX package: (a)
   torch_graft_entry.entry's forward on the card, its decisions equal to
   the same forward on the CPU, the payloads back, sync 0x12, its CUDA-event
   ms; (b) torch_graft_entry.dryrun_multichip(8) on 8 shards of the card
   (the streaming demod planar and complex, the seam-straddling scan,
   wideband, SIC, blind SF, adaptive, soft, robust), its 8 lines equal to
   the CPU's; (c) examples/torch_end_to_end.py and
   examples/torch_mesh_gateway.py, each run in this process on the card
   (its launches counted) and as a script with --device=cuda:0 and
   --device=cpu, the scripts at once, stdout equal (the gateway's
   checkpoint path aside); (d) the sweep twins at one cell each (the soft
   waterfall's losses, the sync sweep's cell plain and --soft) on draws
   made on the CPU from a seed, counts on the card equal to the CPU's.
   Both kernels' launches are counted on every path (0: none reaches
   them).

Phases 9-10 are serial host loops (the adaptive receiver scans its buffer
again for every frame, as the JAX twin's): 15-20 s of host time; so are the
SIC loop and the blind receiver's six SFs (phases 12-13), the flowgraph and
phase 18's sweep. Phases 14-18 write their files to a temporary directory. Then a JSON
line of the kernels (with the launches counted on each path) and, last,
``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero before the last line.
"""

import contextlib
import io
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from lora_phy_tpu_torch import Bandwidth, LoraParams, Window, _build, device_table
from lora_phy_tpu_torch.models import coded, modem, sic, soft, stream, sync
from lora_phy_tpu_torch.ops import channelizer, fft, impair, planar
from lora_phy_tpu_torch.ops.chirp import base_downchirp_planar
from lora_phy_tpu_torch.ops import bf16_decide as bf16
from lora_phy_tpu_torch.ops import dechirp as dechirp_k
from lora_phy_tpu_torch.ops import decide as decide_k
from lora_phy_tpu_torch.ops import fused_demod as fused
from lora_phy_tpu_torch.ops import lanes as lanes_k
from lora_phy_tpu_torch.ops import scan as scan_k
from lora_phy_tpu_torch.ops import windows as windows_k
# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores,
# HBM bandwidth; one definition, in the port's profiling module
from lora_phy_tpu_torch.utils.profiling import H100_F32_FLOPS as PEAK_F32_FLOPS
from lora_phy_tpu_torch.utils.profiling import H100_HBM_BPS as PEAK_HBM_BYTES

CHANNELS, FRAMES, PAYLOAD_LEN, POOL = 8, 8192, 32, 64
NEAR_TIE_REL = 1e-5
# frames per channel of phase 2's SF2-4 demod
SMALL_SF_FRAMES = 1024
# bench.py's block-receive workload: frames per channel, payload bytes,
# zero windows after each frame
BLOCK_FRAMES, BLOCK_PAYLOAD, BLOCK_GAP = 512, 16, 4
# the gateway path: frames of the adaptive stream, per-channel frames at
# reduced width, the stream's block size, the phase 10 SNR (per sample,
# dB: the hard receiver loses ~28 % of the 64 frames there)
GATEWAY_FRAMES, CODED_SMALL_FRAMES, GATEWAY_BLOCK = 256, 1024, 65536
PHASE10_FRAMES, PHASE10_SNR_DB, PHASE10_CPU_FRAMES = 64, -8.5, 16
# the wideband gateway (bench.py's flagship path): channels, FIR taps per
# branch of the wideband receiver, the channelizer-alone input length and
# its taps per branch (bench.py's channelizer row: the default 7)
WIDEBAND_K, WIDEBAND_TAPS, CHANNELIZE_SAMPLES, CHANNELIZE_TAPS = 8, 15, 1 << 25, 7
# the robust mode's two-ray channel: trials (one per channel), SNR per sample
TWO_RAY_TRIALS, TWO_RAY_SNR_DB = 15, 5.0
# SIC at lora-rx-stream --sic's settings and sic_sweep.py's collisions
SIC_GAPS_DB, SIC_SNR_DB, SIC_TRIALS = (3.0, 6.0, 9.0, 12.0, 15.0), 20.0, 8
SIC_BLOCK, SIC_MAX_FRAMES, SIC_PAYLOAD = 65536, 8, 6
REPO = pathlib.Path(__file__).resolve().parent
GOLDEN_TIE = REPO / "tests" / "fixtures" / "golden" / "sf7_bw250000_osr2_win0.npz"
# the command line (phase 14): frames, payload bytes, gap samples and block
# size of tx_stream / rx_stream at their defaults' width; the gateway
# mode's coded frames, the shell pipe's frames, the small streams of the
# card-against-CPU checks
CLI_FRAMES, CLI_PAYLOAD, CLI_GAP, CLI_BLOCK = 4096, 16, 1024, 65536
# frames a receive buffer (carry ++ block) can hold at that gap: 10.7, over
# rx_stream's default --max-frames=8, which drops the rest (as the JAX twin)
CLI_MAX_FRAMES = 16
CLI_CODED_FRAMES, CLI_PIPE_FRAMES, CLI_SMALL_FRAMES = 256, 256, 16
# the AWGN Monte Carlo (phase 15): (SF, packets per point) at CR 4/5 and
# 16-byte payloads, the SNR points (dB), the card-against-CPU prefix
AWGN_CELLS, AWGN_PAYLOAD, AWGN_PREFIX = ((7, 65536), (12, 4096)), 16, 256
AWGN_SNRS = tuple(float(s) for s in range(-20, 1, 2))
# the flowgraph (phase 16): (SF, noise amplitude) of the simulation graph,
# ticks per run (SF7 at 3.0 sits at the knee: some frames drop)
FLOW_CASES, FLOW_TICKS = ((7, 3.0), (12, 4.0)), 16
# the mesh (phase 17): frames per channel of the streaming demod (the main
# path's), the (channel, time) layouts, frames per channel of the
# cross-process workers, frames of bench_scaling's one-card row
MESH_FRAMES, MESH_LAYOUTS = FRAMES, ((1, 1), (1, 4), (2, 4))
WORKER_FRAMES, SCALING_FRAMES = 1024, 8192
# the last slice (phase 18): vector_generate's payload bytes and cells
# (sf, osr, window, cfo_bins, time_offset): SF7-12 plain, then the tests'
# grid cells with osr 2, Hann and the injectors; perf_test's packets (its
# default); sic_sweep's trials per gap (its default 40, cut for time)
VECTOR_BYTES = 255
VECTOR_CELLS = tuple((sf, 1, Window.NONE, 0.0, 0.0) for sf in range(7, 13)) + (
    (7, 2, Window.HANN, 0.25, 2.0), (9, 2, Window.NONE, 0.25, -3.0),
    (12, 1, Window.NONE, 0.5, 0.0), (12, 2, Window.HANN, 0.0, 2.0))
PERF_PACKETS, SWEEP_TRIALS = 1000, 16
# the bf16 decision kernel (phase 19): noise rows per SF (585 frames of 7
# windows, a count no tile size divides), clean-tone frames per SF; frames
# of the SF12 path (roofline's 1 x 1024; SF8-11 run 2^(12 - SF) times as
# many, the same samples); the AWGN probe's per-sample SNRs
# and frames per channel (8 x 768 frames x 64 data symbols = 393,216 per
# SNR); frames of the card-against-CPU prefix
BF16_NOISE_FRAMES, BF16_WINDOWS, BF16_TONE_FRAMES = 585, 7, 64
BF16_SF12_FRAMES = 1024
BF16_FOURSTEP_SFS = (8, 9, 10, 11, 12)
BF16_AWGN_SNRS, BF16_AWGN_FRAMES = (0.0, -6.0, -9.0), 768
BF16_CPU_FRAMES = 16
# frames per channel of phase 19 (f)'s SF5 path: 8 x 32,768 frames of 54
# windows x 32 samples (52 packed symbols and the sync pair), 453.0 M samples
BF16_SF5_FRAMES = 32768
# frames per channel of phase 19 (g)'s paths: SF4, 8 x 65,536 frames of 66
# windows x 16 samples (64 packed symbols and the sync pair), the SF7 main
# path's 553.6 M samples; SF6, 8 x 19,648 frames of 45 windows x 64 (43
# packed symbols and the sync pair), 452.7 M samples, about SF5's
BF16_SF4_FRAMES, BF16_SF6_FRAMES = 65536, 19648


# the bf16 decision kernel's, fused_demod's, the dechirp kernel's, the
# windows kernel's, the scan kernel's, the f32 decide kernel's and the
# lanes kernel's launches on each path, the window gather's calls that took
# the zero-offset view and the scans that kept whole spectra (pre_acc > 1),
# read by read_launches
BF16_BY_PATH, FUSED_BY_PATH, DECHIRP_BY_PATH = {}, {}, {}
WINDOWS_BY_PATH, ALIGNED_BY_PATH = {}, {}
SCAN_BY_PATH, SPECTRA_BY_PATH = {}, {}
DECIDE_BY_PATH, LANES_BY_PATH = {}, {}


def reset_launches():
    """Set the kernels' launch counters to 0 just before a path."""
    fused.LAUNCHES = 0
    bf16.LAUNCHES = 0
    dechirp_k.LAUNCHES = 0
    windows_k.LAUNCHES = windows_k.ALIGNED = 0
    scan_k.LAUNCHES = scan_k.SPECTRA = 0
    decide_k.LAUNCHES = 0
    lanes_k.LAUNCHES = 0


def read_launches(path):
    """Read the counters just after ``path``: each kernel's launches are
    added to its BF16_BY_PATH / FUSED_BY_PATH / DECHIRP_BY_PATH /
    WINDOWS_BY_PATH / SCAN_BY_PATH / DECIDE_BY_PATH / LANES_BY_PATH entry, the aligned
    window gathers to
    ALIGNED_BY_PATH, the spectra scans to SPECTRA_BY_PATH; fused_demod's
    are returned."""
    BF16_BY_PATH[path] = BF16_BY_PATH.get(path, 0) + bf16.LAUNCHES
    FUSED_BY_PATH[path] = FUSED_BY_PATH.get(path, 0) + fused.LAUNCHES
    DECHIRP_BY_PATH[path] = DECHIRP_BY_PATH.get(path, 0) + dechirp_k.LAUNCHES
    WINDOWS_BY_PATH[path] = WINDOWS_BY_PATH.get(path, 0) + windows_k.LAUNCHES
    ALIGNED_BY_PATH[path] = ALIGNED_BY_PATH.get(path, 0) + windows_k.ALIGNED
    SCAN_BY_PATH[path] = SCAN_BY_PATH.get(path, 0) + scan_k.LAUNCHES
    SPECTRA_BY_PATH[path] = SPECTRA_BY_PATH.get(path, 0) + scan_k.SPECTRA
    DECIDE_BY_PATH[path] = DECIDE_BY_PATH.get(path, 0) + decide_k.LAUNCHES
    LANES_BY_PATH[path] = LANES_BY_PATH.get(path, 0) + lanes_k.LAUNCHES
    return fused.LAUNCHES


def check(ok, msg):
    """Raise unless ``ok`` (kept under ``python -O``, unlike assert)."""
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(fn, iters=5, calls=1):
    """Median CUDA-event time of ``fn()`` in ms, after one warm-up call.
    With ``calls`` > 1 each sample spans that many back-to-back calls and
    is divided by it, so a call's host time before its launch hides
    behind the previous call's device work: the device time of a kernel
    rather than the latency of one call on an idle card."""
    fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def profile_once(fn, label, calls=5):
    """One torch.profiler window of ``calls`` back-to-back calls of
    ``fn()`` after a warm-up (``utils/profiling.range_profile``): per call,
    the top five device kernels by time and the device busy time (the
    union of kernel intervals); the idle share is one minus busy over the
    host wall time of the same window, so it includes the profiler's own
    host cost (an upper bound)."""
    from lora_phy_tpu_torch.utils.profiling import range_profile

    # the block receiver's ranges named, so their device-side spans are not
    # counted as device work
    prof = range_profile(fn, sync.CIRCULAR_STAGES, calls)
    if not prof.events:
        print(f"{label}: profiler recorded no device events (not measured)", flush=True)
        return
    print(f"{label}: profiler, {calls} calls in one window, per call: wall "
          f"{prof.wall_ms:.3f} ms, device busy {prof.busy_ms:.3f} ms, idle share "
          f"{prof.idle_share:.3f}, {prof.events:.0f} device events", flush=True)
    for name, ms in sorted(prof.kernels.items(), key=lambda kv: -kv[1])[:5]:
        print(f"{label}:   {ms:.3f} ms  {name[:110]}", flush=True)


def twin_top2_gap(rows, params, scale_rows):
    """Relative gap between the twin's two largest |DFT|^2 per row."""
    xr, xi, start, rate = rows
    xr, xi = xr * scale_rows[:, None], xi * scale_rows[:, None]
    top2 = fused.reference_power(xr, xi, start, rate, params).topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]) / top2[:, 0]


def uniform_rows(gen, b, lo, hi, dev):
    return torch.from_numpy(gen.uniform(lo, hi, b).astype(np.float32)).to(dev)


def phase2_kernel_vs_twin(dev):
    gen = np.random.RandomState(7)
    for sf in range(2, 8):
        for window in (Window.NONE, Window.HANN):
            p = LoraParams(sf=sf, window=window)
            n = p.n
            # clean rows: dechirped chirps (tones), derotated at a random
            # start phase and a rate of at most 0.3 bin
            payload = torch.from_numpy(gen.randint(0, 256, (64, 32)).astype(np.uint8)).to(dev)
            dr, di = planar.dechirp_planar(*planar.modulate_planar(modem.encode(payload), p), p)
            cr, ci = dr.reshape(-1, n).contiguous(), di.reshape(-1, n).contiguous()
            b = cr.shape[0]
            start = uniform_rows(gen, b, -300, 300, dev)
            rate = uniform_rows(gen, b, -0.3, 0.3, dev) * (2 * np.pi / n)
            # amplitudes above 1, brought back by the per-row scale
            gain = uniform_rows(gen, b, 1.0, 8.0, dev)
            cr, ci = cr * gain[:, None], ci * gain[:, None]
            scale = 1.0 / gain
            k = fused.fused_detect_rows(cr, ci, start, rate, p, scale)
            r = fused.fused_detect_rows_reference(cr, ci, start, rate, p, scale)
            clean_diff = int((k != r).sum())
            check(clean_diff == 0, f"SF{sf} {window.name}: {clean_diff} clean rows differ")
            # noise rows, a count that does not fill the kernel's blocks
            b = 65536 + 7
            rows = [torch.from_numpy(a).to(dev) for a in (
                gen.randn(b, n).astype(np.float32), gen.randn(b, n).astype(np.float32),
                gen.uniform(-300, 300, b).astype(np.float32),
                gen.uniform(-0.5, 0.5, b).astype(np.float32))]
            scale = uniform_rows(gen, b, 0.2, 1.0, dev)
            k = fused.fused_detect_rows(*rows, p, scale)
            r = fused.fused_detect_rows_reference(*rows, p, scale)
            differ = (k != r).nonzero().flatten()
            near_ties = 0
            if differ.numel():
                gap = twin_top2_gap([t[differ] for t in rows], p, scale[differ])
                near_ties = int((gap <= NEAR_TIE_REL).sum())
                check(near_ties == differ.numel(),
                      f"SF{sf} {window.name}: {differ.numel() - near_ties} noise rows "
                      f"differ beyond a {NEAR_TIE_REL:g} near-tie")
            print(f"phase 2: SF{sf} window={window.name}: {cr.shape[0]} clean rows equal "
                  f"(scaled); {b} scaled noise rows, {differ.numel()} differ, all at near-ties "
                  f"(top-2 within {NEAR_TIE_REL:g} relative)", flush=True)
    p = LoraParams(sf=7)
    x = torch.zeros(1, p.n, device=dev)
    x[0, ::2] = 1.0
    z = torch.zeros(1, device=dev)
    tie = int(fused.fused_detect_rows(x, torch.zeros_like(x), z, z, p)[0])
    check(tie == 0, f"tie row gave bin {tie}")
    print("phase 2: alternating-impulse tie row -> bin 0", flush=True)


def pack_symbols(payload, sf):
    """[..., B] uint8 payloads -> [..., ceil(8B / sf)] int32 symbols of sf
    bits each (the payload's bits LSB first, zero-padded)."""
    bits = (payload[..., None].to(torch.int32) >> torch.arange(8, device=payload.device)) & 1
    bits = bits.reshape(*payload.shape[:-1], -1)
    pad = -bits.shape[-1] % sf
    bits = torch.nn.functional.pad(bits, (0, pad)).reshape(*bits.shape[:-1], -1, sf)
    return (bits << torch.arange(sf, device=payload.device)).sum(-1).to(torch.int32)


def unpack_symbols(symbols, sf, nbytes):
    """The inverse of pack_symbols: the first ``nbytes`` bytes."""
    bits = (symbols[..., None] >> torch.arange(sf, device=symbols.device)) & 1
    bits = bits.reshape(*symbols.shape[:-1], -1)[..., :8 * nbytes]
    bits = bits.reshape(*bits.shape[:-1], nbytes, 8)
    return (bits << torch.arange(8, device=symbols.device)).sum(-1).to(torch.uint8)


def phase2_small_sf_demod(dev):
    """demodulate_planar(fused=True) at SF2-4 (the kernel's one-thread-per-
    row design): payloads packed into SF-bit symbols, one launch per call,
    decoded bit-exact; the plain path's symbols. Returns the launches per
    path for the JSON line."""
    launches = {}
    for sf in (2, 3, 4):
        p = LoraParams(sf=sf)
        pay = torch.from_numpy(np.random.RandomState(sf).randint(
            0, 256, (CHANNELS, SMALL_SF_FRAMES, PAYLOAD_LEN)).astype(np.uint8)).to(dev)
        syms = pack_symbols(pay, sf)
        xr, xi = planar.dechirp_planar(*planar.modulate_planar(syms, p), p)
        zero = torch.zeros(CHANNELS, SMALL_SF_FRAMES, device=dev)
        torch.cuda.synchronize()
        reset_launches()
        res = planar.demodulate_planar(xr, xi, p, fused=True, known_offsets=(zero, zero))
        got = unpack_symbols(res.symbols, sf, PAYLOAD_LEN)
        torch.cuda.synchronize()
        path = f"small_sf{sf}"
        launches[path] = read_launches(path)
        check(launches[path] == 1, f"phase 2 SF{sf}: {launches[path]} fused_demod launches")
        check(torch.equal(res.symbols, syms), f"phase 2 SF{sf}: symbols differ from the sent")
        check(torch.equal(got, pay), f"phase 2 SF{sf}: decoded payloads differ")
        check(bool((res.sync_word == 0x12).all()), f"phase 2 SF{sf}: sync word is not 0x12")
        plain = planar.demodulate_planar(xr, xi, p, known_offsets=(zero, zero))
        check(torch.equal(plain.symbols, res.symbols), f"phase 2 SF{sf}: fused=False differs")
        print(f"phase 2: SF{sf}: demodulate_planar(fused=True) over {CHANNELS} x "
              f"{SMALL_SF_FRAMES} frames ({syms.shape[-1]} symbols of {sf} bits each): "
              f"{launches[path]} fused_demod launch, every payload decoded bit-exact, sync "
              f"0x12, the plain path's symbols", flush=True)
    return launches


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return smi.splitlines()[0]


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is false")
    # phase 0: the card
    card = card_line()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"phase 0: torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}", flush=True)

    # phase 1: build and load
    t0 = time.perf_counter()
    _build.build(force=True, verbose=True)
    _build.load_library()
    print(f"phase 1: built {_build.LIBRARY.name} for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # phase 2: the kernel against its plain twin
    phase2_kernel_vs_twin(dev)
    small_sf = phase2_small_sf_demod(dev)
    record = phase3_4_main_path(dev, card)
    torch.cuda.empty_cache()
    xr, xi, pay = phase5_block_receiver(dev, card)
    phase6_barrel_and_stream(dev, xr, xi, pay)
    phase7_card_vs_cpu(dev, xr, xi)
    torch.cuda.empty_cache()
    coded_launches = phase8_coded_main_path(dev, card)
    torch.cuda.empty_cache()
    sig, truth = phase9_gateway_stream(dev, card)
    phase10_noise_and_soft(dev, card, sig, truth, xr, xi, pay)
    del sig
    torch.cuda.empty_cache()
    other = phase11_wideband(dev, card)
    torch.cuda.empty_cache()
    other.update(phase12_block_modes(dev, card, xr, xi, pay))
    del xr, xi
    torch.cuda.empty_cache()
    other.update(phase13_sic(dev, card))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        cli_launches, cli_truth, cli_out = phase14_cli(dev, card, tmp)
        other.update(cli_launches)
        torch.cuda.empty_cache()
        other["awgn"] = phase15_awgn(dev, card, tmp)
        torch.cuda.empty_cache()
        other.update(phase16_flowgraph(dev, card, tmp))
        torch.cuda.empty_cache()
        other.update(phase17_mesh(dev, card, tmp, cli_truth, cli_out))
        torch.cuda.empty_cache()
        other.update(phase18_last_slice(dev, card, tmp))
    torch.cuda.empty_cache()
    earlier = dict(BF16_BY_PATH)
    check(not any(earlier.values()), f"bf16_decide launched on an earlier path: {earlier}")
    print(f"phase 19: bf16_decide launches on each path of phases 3-18: {earlier}", flush=True)
    record19 = phase19_bf16(dev, card)
    torch.cuda.empty_cache()
    phase20a_bench(dev, card)
    torch.cuda.empty_cache()
    phase20b_stage_profile(dev, card)
    torch.cuda.empty_cache()
    record20 = phase20d_dechirp(dev, card)
    torch.cuda.empty_cache()
    record20e = phase20e_windows(dev, card)
    torch.cuda.empty_cache()
    record20f = phase20f_scan(dev, card)
    torch.cuda.empty_cache()
    record20g = [phase20g_decide(dev, card, cell) for cell in DECIDE_CELLS]
    torch.cuda.empty_cache()
    record20h = phase20h_lanes(dev, card)
    torch.cuda.empty_cache()
    record["small_n"], record19["small_n"] = phase20c_small_n(dev, card)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase21_repo_twins(dev, card)
    print(f"phase 21: {card}: {time.perf_counter() - t0:.2f} s in all", flush=True)
    other.update({k: v for k, v in FUSED_BY_PATH.items()
                  if k.startswith(("bf16_", "bench_", "block_profile", "twin_"))})

    check("jax" not in sys.modules, "the port imported JAX")
    # every path but the main and coded ones reaches no fused_demod launch
    # (none calls demodulate_planar(fused=True), as in JAX): their counts are
    # read from the counter all the same
    record["launches_by_path"] = {"main": record["launches"], "coded": coded_launches,
                                  **small_sf, **other}
    record["launches"] += coded_launches
    record19["launches_by_path"] = dict(BF16_BY_PATH)
    record20["launches_by_path"] = dict(DECHIRP_BY_PATH)
    record20e["launches_by_path"] = dict(WINDOWS_BY_PATH)
    record20e["aligned_by_path"] = dict(ALIGNED_BY_PATH)
    record20f["launches_by_path"] = dict(SCAN_BY_PATH)
    record20f["spectra_by_path"] = dict(SPECTRA_BY_PATH)
    record20g[0]["launches_by_path"] = dict(DECIDE_BY_PATH)
    record20h["launches_by_path"] = dict(LANES_BY_PATH)
    print(json.dumps({"kernels": [record, record19, record20, record20e, record20f,
                                  *record20g, record20h]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


def phase3_4_main_path(dev, card):
    """Phases 3 and 4; returns the kernel's record for the JSON line."""
    p = LoraParams(sf=7)
    pool = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (POOL, PAYLOAD_LEN)).astype(np.uint8)).to(dev)
    reps = CHANNELS * FRAMES // POOL
    full = pool.repeat(reps, 1).reshape(CHANNELS, FRAMES, PAYLOAD_LEN)
    total_samples = CHANNELS * FRAMES * (2 * PAYLOAD_LEN + 2) * p.step
    torch.cuda.synchronize()

    reset_launches()
    syms = modem.encode(full)
    re, im = planar.modulate_planar(syms, p)
    xr, xi = planar.dechirp_planar(re, im, p)
    del re, im                          # one 4.4 GB batch live, as bench.py
    res = planar.demodulate_planar(xr, xi, p, fused=True)
    decoded = modem.decode(res.symbols)
    torch.cuda.synchronize()
    launches = read_launches("main")

    check(tuple(xr.shape) == (CHANNELS, FRAMES, total_samples // (CHANNELS * FRAMES)),
          f"dechirped planes have shape {tuple(xr.shape)}")
    check(tuple(res.symbols.shape) == (CHANNELS, FRAMES, 2 * PAYLOAD_LEN),
          f"symbols have shape {tuple(res.symbols.shape)}")
    check(torch.equal(decoded, full), "fused demod: decoded payloads differ")
    check(bool((res.sync_word == 0x12).all()), "fused demod: sync word is not 0x12")
    check(bool(torch.isfinite(res.cfo).all() and torch.isfinite(res.time_offset).all()),
          "fused demod: non-finite cfo / time_offset")
    check(launches > 0, "the main path did not launch the fused kernel")
    print(f"phase 3: {CHANNELS * FRAMES} frames ({total_samples / 1e6:.1f} M IQ samples) "
          f"decoded bit-exact through fused=True, sync 0x12 everywhere, "
          f"kernel launches {launches}", flush=True)

    t_enc = cuda_ms(lambda: modem.encode(full))
    t_tx = cuda_ms(lambda: planar.modulate_planar(syms, p))
    re, im = planar.modulate_planar(syms, p)
    t_dech = cuda_ms(lambda: planar.dechirp_planar(re, im, p))
    del re, im
    t_fused = cuda_ms(lambda: planar.demodulate_planar(xr, xi, p, fused=True))
    t_dec = cuda_ms(lambda: modem.decode(res.symbols))
    print(f"phase 3: {card}: encode {t_enc:.3f} ms, modulate_planar {t_tx:.3f} ms "
          f"({total_samples / t_tx / 1e6:.3f} Gsamples/s), dechirp_planar {t_dech:.3f} ms, "
          f"demodulate_planar(fused=True) {t_fused:.3f} ms "
          f"({total_samples / t_fused / 1e6:.3f} Gsamples/s), decode {t_dec:.3f} ms",
          flush=True)

    # phase 4: the plain path, and the kernel against its twin on the main
    # path's own rows
    plain = planar.demodulate_planar(xr, xi, p, fused=False)
    check(torch.equal(plain.symbols, res.symbols), "fused=False symbols differ")
    check(torch.equal(plain.sync_word, res.sync_word), "fused=False sync words differ")
    t_plain = cuda_ms(lambda: planar.demodulate_planar(xr, xi, p, fused=False))
    print(f"phase 4: {card}: demodulate_planar fused=True {t_fused:.3f} ms, "
          f"fused=False (plain torch) {t_plain:.3f} ms "
          f"({total_samples / t_plain / 1e6:.3f} Gsamples/s); same symbols", flush=True)
    profile_once(lambda: planar.demodulate_planar(xr, xi, p, fused=True),
                 f"phase 4: {card}: demodulate_planar(fused=True)")

    yr, yi, rate, t_off, scale, _, _ = planar._demod_stage_planar(xr, xi, p, False, None)
    *rows, scale_rows = fused.symbol_rows(yr, yi, rate, t_off, p, scale)
    del yr, yi, xr, xi
    k = fused.fused_detect_rows(*rows, p, scale_rows)
    r = fused.fused_detect_rows_reference(*rows, p, scale_rows)
    max_abs_err = int((k.to(torch.int64) - r.to(torch.int64)).abs().max())
    check(max_abs_err == 0, f"kernel vs twin on the main-path rows: {max_abs_err}")
    t_kernel = cuda_ms(lambda: fused.fused_detect_rows(*rows, p, scale_rows), calls=10)
    t_kernel_one = cuda_ms(lambda: fused.fused_detect_rows(*rows, p, scale_rows), iters=10)
    t_twin = cuda_ms(lambda: fused.fused_detect_rows_reference(*rows, p, scale_rows),
                     calls=10)
    n_rows = rows[0].shape[0]
    # least time for the same work (fused_bound)
    n = p.n
    fft_flops = n_rows * 5 * n * (n.bit_length() - 1)
    bound_ms, bound_by, flops, nbytes = fused_bound(n_rows, n)
    print(f"phase 4: {card}: fused_detect_rows on {n_rows} rows x N={n} with the "
          f"frames' scale: CUDA kernel {t_kernel:.3f} ms ({nbytes / t_kernel / 1e6:.0f} GB/s; "
          f"{fft_flops / t_kernel / 1e9:.2f} TFLOP/s of FFT; one call on an idle card "
          f"{t_kernel_one:.3f} ms), plain twin {t_twin:.3f} ms; "
          f"bins equal; bound "
          f"{bound_ms:.3f} ms by {bound_by} ({flops:.4g} flop, {nbytes:.4g} B), "
          f"{bound_ms / t_kernel:.3f} of it; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB", flush=True)

    # yardstick the port never calls: cuFFT's complex64 DFT alone over
    # the same rows (no scale, derotation, |.|^2 or argmax)
    z = torch.complex(rows[0], rows[1])
    del rows
    t_fft = cuda_ms(lambda: torch.fft.fft(z, dim=-1), calls=10)
    print(f"phase 4: {card}: torch.fft.fft (cuFFT) over the same {n_rows} x {n} rows as "
          f"complex64, the DFT alone: {t_fft:.3f} ms ({2 * z.numel() * 8 / t_fft / 1e6:.0f} "
          f"GB/s read + written)", flush=True)
    del z

    return {"name": "fused_demod", "route": "cuda",
            "source": "lora_phy_tpu_torch/csrc/fused_demod.cu",
            "replaces": "lora_phy_tpu/ops/pallas_demod.py:53",
            "launches": launches, "max_abs_err": max_abs_err,
            "ms": t_kernel, "plain_ms": t_twin,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes derotate + DFT + |.|^2 + argmax
            "library_ms": None, "cufft_dft_only_ms": t_fft}


def block_stream(dev, params, channels, frames):
    """bench.py's block-receive stream built by the port: per channel one
    16-byte payload framed by frame_modulate_planar and repeated
    ``frames`` times, each frame followed by BLOCK_GAP zero windows.
    Returns the planes [C, frames * period], the payloads and the period."""
    pay = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (channels, BLOCK_PAYLOAD)).astype(np.uint8)).to(dev)
    fr, fi = stream.frame_modulate_planar(modem.encode(pay), params)
    gap = torch.zeros(channels, BLOCK_GAP * params.step, device=dev)
    xr = torch.cat([fr, gap], -1).repeat(1, frames)
    xi = torch.cat([fi, gap], -1).repeat(1, frames)
    return xr, xi, pay, fr.shape[-1] + gap.shape[-1]


def check_block(blk, pay, min_found, label):
    """Every found frame decodes to its channel's payload with sync 0x12,
    starts strictly increase per channel, and at least ``min_found``
    frames are found. Returns the found count."""
    found = blk.found
    n_found = int(found.sum())
    check(n_found >= min_found, f"{label}: {n_found} frames found, need {min_found}")
    ok = (modem.decode(blk.symbols) == pay[:, None, :]).all(-1)
    check(bool(ok[found].all()), f"{label}: {int((~ok[found]).sum())} found frames "
          "do not decode to their payload")
    check(bool((blk.sync[found] == 0x12).all()), f"{label}: sync word is not 0x12")
    big = torch.iinfo(torch.int32).max
    st = torch.where(found, blk.start, big)
    inc = (st[:, 1:] > st[:, :-1]) | ~found[:, 1:]
    check(bool(inc.all()), f"{label}: starts do not increase per channel")
    return n_found


def phase5_block_receiver(dev, card):
    """The block receiver at bench.py's block-receive width; returns the
    stream and payloads for phases 6-7."""
    p = LoraParams(sf=7)
    xr, xi, pay, period = block_stream(dev, p, CHANNELS, BLOCK_FRAMES)
    n_pay = 2 * BLOCK_PAYLOAD
    total = xr.numel()

    def run():
        return sync.receive_block_planar(xr, xi, p, n_pay, max_frames=BLOCK_FRAMES,
                                         min_power_db=-30.0)

    torch.cuda.synchronize()
    reset_launches()
    blk = run()
    torch.cuda.synchronize()
    launches = read_launches("block")
    n_found = check_block(blk, pay, CHANNELS * (BLOCK_FRAMES - 1), "phase 5")
    starts = blk.start[blk.found]
    true = torch.remainder(starts, period) == 0
    print(f"phase 5: block receiver (circular path) on {CHANNELS} x {xr.shape[-1]} "
          f"samples ({total / 1e6:.1f} M IQ samples per plane): {n_found} of "
          f"{CHANNELS * BLOCK_FRAMES} frames found, all decoded bit-exact, sync 0x12, "
          f"starts increasing, {int(true.sum())} at their true start; fused_demod "
          f"launches in this run {launches} (the receiver does not call "
          f"demodulate_planar)", flush=True)
    t = cuda_ms(run, iters=10)
    print(f"phase 5: {card}: receive_block_planar {t:.3f} ms median of 10 "
          f"({total / t / 1e6:.3f} Gsamples/s, {n_found / t * 1e3:.0f} frames/s); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB", flush=True)
    scan_t = cuda_ms(lambda: sync.frame_sync_scan_planar(xr, xi, p, min_power_db=-30.0),
                     iters=10)
    print(f"phase 5: {card}: of which frame_sync_scan_planar {scan_t:.3f} ms "
          f"median of 10", flush=True)
    profile_once(run, f"phase 5: {card}: receive_block_planar")
    return xr, xi, pay


def phase6_barrel_and_stream(dev, xr1, xi1, pay1):
    """The barrel path (osr 2; osr 1 with the Hann window) at reduced
    width, and BatchStreamDemodulator over one phase-5 channel."""
    frames = 64
    n_pay = 2 * BLOCK_PAYLOAD
    for p, label, path in ((LoraParams(sf=7, osr=2), "osr 2", "barrel_osr2"),
                           (LoraParams(sf=7, window=Window.HANN), "osr 1 Hann",
                            "barrel_hann")):
        xr, xi, pay, _ = block_stream(dev, p, CHANNELS, frames)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        blk = sync.receive_block_planar(xr, xi, p, n_pay, max_frames=frames,
                                        min_power_db=-30.0)
        torch.cuda.synchronize()
        read_launches(path)
        n_found = check_block(blk, pay, CHANNELS * frames, f"phase 6 {label}")
        print(f"phase 6: barrel path {label}: {n_found} of {CHANNELS * frames} frames "
              f"found and decoded bit-exact, sync 0x12 "
              f"({(time.perf_counter() - t0) * 1e3:.1f} ms, first call)", flush=True)

    p = LoraParams(sf=7)
    demod = stream.BatchStreamDemodulator(p, n_pay, max_frames=24, device=dev)
    period = xr1.shape[-1] // BLOCK_FRAMES
    block = 16 * period + 777                 # blocks do not align with frames
    st = demod.init_state()
    got = []
    t0 = time.perf_counter()
    for off in range(0, xr1.shape[-1], block):
        st, out = demod.process(st, xr1[0, off:off + block], xi1[0, off:off + block])
        got.extend(out)
    dt = time.perf_counter() - t0
    starts = [g[0] for g in got]
    check(starts == [k * period for k in range(BLOCK_FRAMES)],
          f"phase 6 stream: {len(got)} frames reported, not each of the "
          f"{BLOCK_FRAMES} once at its true start")
    syms = torch.stack([g[1] for g in got])
    check(bool((modem.decode(syms) == pay1[0]).all()),
          "phase 6 stream: a reported frame does not decode to its payload")
    check(all(g[2] == 0x12 for g in got), "phase 6 stream: sync word is not 0x12")
    print(f"phase 6: BatchStreamDemodulator over one phase-5 channel in blocks of "
          f"{block} samples: all {len(got)} frames once, at their true starts, "
          f"bit-exact ({dt:.2f} s host clock for "
          f"{-(-xr1.shape[-1] // block)} blocks)", flush=True)


def phase7_card_vs_cpu(dev, xr, xi):
    """The receiver on the card and on the CPU, same input and process."""
    p = LoraParams(sf=7)
    period = xr.shape[-1] // BLOCK_FRAMES
    xr, xi = xr[:2, :16 * period], xi[:2, :16 * period]
    args = (p, 2 * BLOCK_PAYLOAD)
    kw = {"max_frames": 16, "min_power_db": -30.0}
    gpu = sync.receive_block_planar(xr, xi, *args, **kw)
    cpu = sync.receive_block_planar(xr.cpu(), xi.cpu(), *args, **kw)
    for f in ("found", "start", "cfo_bins", "symbols", "sync"):
        check(torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)),
              f"phase 7: {f} differs between the card and the CPU")
    print(f"phase 7: receive_block_planar on 2 x {xr.shape[-1]} samples: found, "
          f"start, cfo_bins, symbols, sync equal on the card and the CPU "
          f"({int(cpu.found.sum())} frames)", flush=True)
    # the golden cell whose sync tones tie exactly across the osr phases:
    # the estimator keeps the tie (the reference's cfo and time offset)
    g = np.load(GOLDEN_TIE)
    pt = LoraParams(sf=7, bw=Bandwidth.BW_250, osr=2)
    iq = torch.from_numpy(g["iq"]).to(dev)
    dr, di = planar.dechirp_planar(iq.real.contiguous(), iq.imag.contiguous(), pt)
    res = planar.demodulate_planar(dr, di, pt)
    cfo, to = float(res.cfo), float(res.time_offset)
    check(abs(cfo - float(g["cfo"])) <= 1e-6 and to == float(g["time_offset"]),
          f"phase 7: {GOLDEN_TIE.name}: cfo {cfo} time_offset {to}, golden "
          f"{float(g['cfo'])} {float(g['time_offset'])}")
    check(torch.equal(res.symbols.cpu(), torch.from_numpy(g["demod"].astype(np.int32))),
          f"phase 7: {GOLDEN_TIE.name}: symbols differ from the golden")
    print(f"phase 7: {GOLDEN_TIE.stem} on the card: cfo {cfo:.6f}, time_offset {to}, "
          f"symbols as the golden (the osr-phase tie holds)", flush=True)


def coded_chain(dev, cfg, channels, frames, seed):
    """encode_payload -> modulate_planar -> dechirp_planar of random
    payloads [channels, frames, PAYLOAD_LEN]; returns the payloads, the
    coded symbols and the dechirped planes."""
    p = LoraParams(sf=cfg.sf)
    full = torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, (channels, frames, PAYLOAD_LEN)).astype(np.uint8)).to(dev)
    syms = coded.encode_payload(full, cfg)
    re, im = planar.modulate_planar(syms, p)
    xr, xi = planar.dechirp_planar(re, im, p)
    return full, syms, xr, xi


def check_coded(res, full, cfg, label):
    """Every frame's payload bit-exact, crc_ok, fec_errors 0, sync 0x12."""
    payload, crc_ok, fec = coded.decode_payload(res.symbols, PAYLOAD_LEN, cfg)
    check(torch.equal(payload, full), f"{label}: decoded payloads differ")
    check(bool(crc_ok.all()), f"{label}: {int((~crc_ok).sum())} frames fail their CRC")
    check(int(fec.sum()) == 0, f"{label}: {int(fec.sum())} codewords flagged by the FEC")
    check(bool((res.sync_word == 0x12).all()), f"{label}: sync word is not 0x12")


def phase8_coded_main_path(dev, card):
    """The coded main path through the kernel; returns its launches."""
    p = LoraParams(sf=7)
    cfg = coded.CodedConfig(sf=7, cr=1)
    torch.cuda.synchronize()
    reset_launches()
    full, syms, xr, xi = coded_chain(dev, cfg, CHANNELS, FRAMES, seed=8)
    res = planar.demodulate_planar(xr, xi, p, fused=True)
    check_coded(res, full, cfg, "phase 8")
    torch.cuda.synchronize()
    launches = read_launches("coded")
    nsym = coded.payload_symbol_count(PAYLOAD_LEN, cfg)
    check(tuple(syms.shape) == (CHANNELS, FRAMES, nsym), f"coded symbols {tuple(syms.shape)}")
    check(launches > 0, "the coded main path did not launch the fused kernel")
    total = xr.numel()
    print(f"phase 8: coded main path, CR 4/5 + CRC16 + whitening: {CHANNELS * FRAMES} "
          f"frames of {PAYLOAD_LEN} bytes ({nsym} coded symbols + 2 sync, "
          f"{total / 1e6:.1f} M IQ samples) decoded bit-exact through fused=True, crc_ok "
          f"and fec_errors 0 everywhere, sync 0x12; kernel launches {launches}", flush=True)
    plain = planar.demodulate_planar(xr, xi, p, fused=False)
    check(torch.equal(plain.symbols, res.symbols), "phase 8: fused=False symbols differ")
    t_enc = cuda_ms(lambda: coded.encode_payload(full, cfg))
    t_dec = cuda_ms(lambda: coded.decode_payload(res.symbols, PAYLOAD_LEN, cfg))
    t_fused = cuda_ms(lambda: planar.demodulate_planar(xr, xi, p, fused=True))
    print(f"phase 8: {card}: encode_payload {t_enc:.3f} ms, decode_payload {t_dec:.3f} ms "
          f"({CHANNELS * FRAMES / t_dec / 1e3:.2f} M frames/s), demodulate_planar(fused=True) "
          f"{t_fused:.3f} ms ({total / t_fused / 1e6:.3f} Gsamples/s); fused=False gives the "
          f"same symbols", flush=True)

    # soft decoding of one channel from its |DFT|^2 spectra
    mag2 = planar.demodulate_spectrum_planar(xr[0], xi[0], p)[0]
    del xr, xi, plain
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    payload, crc_ok, margin = soft.decode_payload_soft(mag2, PAYLOAD_LEN, cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    check(torch.equal(payload, full[0]), "phase 8 soft: decoded payloads differ")
    check(bool(crc_ok.all()) and bool((margin > 0).all()), "phase 8 soft: crc or margin")
    t_soft = cuda_ms(lambda: soft.decode_payload_soft(mag2, PAYLOAD_LEN, cfg))
    print(f"phase 8: {card}: decode_payload_soft on {FRAMES} frames' spectra "
          f"{tuple(mag2.shape)}: bytes and crc_ok equal to the payloads, {t_soft:.3f} ms, "
          f"peak memory above its inputs {peak / 2 ** 30:.2f} GiB (bin_llrs' "
          f"[frames, S, ppm, N] temporary)", flush=True)
    del mag2, res

    for cr, ldro in ((2, False), (3, False), (4, False), (1, True)):
        cfg = coded.CodedConfig(sf=7, cr=cr, ldro=ldro)
        full, syms, xr, xi = coded_chain(dev, cfg, 1, CODED_SMALL_FRAMES, seed=80 + cr)
        res = planar.demodulate_planar(xr, xi, p, fused=True)
        label = f"phase 8 CR 4/{4 + cr}{' LDRO' if ldro else ''}"
        check_coded(res, full, cfg, label)
        plain = planar.demodulate_planar(xr, xi, p, fused=False)
        check(torch.equal(plain.symbols, res.symbols), f"{label}: fused=False differs")
        print(f"{label}: 1 x {CODED_SMALL_FRAMES} frames ({syms.shape[-1]} symbols) "
              f"bit-exact, crc_ok, fec_errors 0, sync 0x12, fused=False equal", flush=True)
    return launches


def gateway_stream(dev, p, count, max_len, seed, ldro=False):
    """One channel of ``count`` frame_encode frames after 313 zero
    samples: payload lengths drawn from 1..max_len (the first two 1 and
    max_len), CR cycling 1-4, CRC on for even frames, 0-3 zero symbols
    after each frame. Returns the complex64 stream and the true
    (start, payload bytes, cr, crc) of every frame."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(1, max_len + 1, count)
    lengths[:2] = 1, max_len
    lead = 313
    parts, truth, pos = [torch.zeros(lead, dtype=torch.complex64, device=dev)], [], lead
    for k in range(count):
        cr, crc = 1 + k % 4, k % 2 == 0
        payload = rng.randint(0, 256, lengths[k]).astype(np.uint8)
        iq = stream.frame_encode(payload, coded.CodedConfig(sf=p.sf, cr=cr, crc=crc, ldro=ldro),
                                 p, device=dev)
        gap = int(rng.randint(0, 4)) * p.step
        truth.append((pos, payload.tobytes(), cr, crc))
        parts += [iq, torch.zeros(gap, dtype=torch.complex64, device=dev)]
        pos += iq.numel() + gap
    parts.append(torch.zeros(4 * p.step, dtype=torch.complex64, device=dev))
    return torch.cat(parts), truth


def run_adaptive(sig, p, block, soft_mode, ldro=False, device=None):
    """AdaptiveStreamDemodulator over ``sig`` in blocks; returns the
    frames and the host seconds."""
    demod = stream.AdaptiveStreamDemodulator(p, soft=soft_mode, ldro=ldro,
                                             device=device or sig.device)
    st, got = demod.init_state(), []
    t0 = time.perf_counter()
    for off in range(0, sig.numel(), block):
        st, out = demod.process(st, sig[off:off + block])
        got.extend(out)
    return got, time.perf_counter() - t0


def check_gateway(got, truth, label):
    """Every frame reported once, at its true start, with its length, CR,
    CRC flag and bytes, header_ok, and crc_ok where CRC is on."""
    rows = [(g[0], g[1], g[2]["cr"], g[2]["crc"]) for g in got]
    bad = [k for k, (r, t) in enumerate(zip(rows, truth)) if r != t]
    check(len(rows) == len(truth) and not bad,
          f"{label}: {len(rows)} frames reported for {len(truth)}; first mismatch "
          f"{bad[:1] or 'count'}")
    check(all(g[2]["header_ok"] and g[2]["length"] == len(g[1]) for g in got),
          f"{label}: header fields differ")
    check(all(g[2]["crc_ok"] for g in got if g[2]["crc"]), f"{label}: a CRC failed")


def phase9_gateway_stream(dev, card):
    """The adaptive receiver (hard and soft) over the SF7 gateway stream
    and over SF12 LDRO frames; returns the SF7 stream and its truth."""
    p = LoraParams(sf=7)
    sig, truth = gateway_stream(dev, p, GATEWAY_FRAMES, 255, seed=9)
    for soft_mode in (False, True):
        got, dt = run_adaptive(sig, p, GATEWAY_BLOCK, soft_mode)
        label = f"phase 9 {'soft' if soft_mode else 'hard'}"
        check_gateway(got, truth, label)
        print(f"{label}: {card}: AdaptiveStreamDemodulator over {sig.numel()} SF7 samples in "
              f"blocks of {GATEWAY_BLOCK}: all {len(got)} frames once at their true starts, "
              f"lengths 1-255, CR 4/5-4/8, CRC on/off, bytes exact; {dt:.2f} s host clock, "
              f"{len(got) / dt:.1f} frames/s, {dt / len(got) * 1e3:.2f} ms host per frame",
              flush=True)
    # where a block's host time goes: one block from mid-stream, replayed
    # from the same carry (process() is a function of state and block)
    demod = stream.AdaptiveStreamDemodulator(p, device=dev)
    st = demod.init_state()
    for off in range(0, 8 * GATEWAY_BLOCK, GATEWAY_BLOCK):
        st, _ = demod.process(st, sig[off:off + GATEWAY_BLOCK])
    block = sig[8 * GATEWAY_BLOCK: 9 * GATEWAY_BLOCK]
    n_frames = len(demod.process(st, block)[1])
    profile_once(lambda: demod.process(st, block),
                 f"phase 9: {card}: AdaptiveStreamDemodulator.process, one block of "
                 f"{GATEWAY_BLOCK} samples ({n_frames} frames)")
    p12 = LoraParams(sf=12)
    sig12, truth12 = gateway_stream(dev, p12, 8, 64, seed=12, ldro=True)
    for soft_mode in (False, True):
        got, dt = run_adaptive(sig12, p12, 1 << 20, soft_mode, ldro=True)
        label = f"phase 9 SF12 LDRO {'soft' if soft_mode else 'hard'}"
        check_gateway(got, truth12, label)
        print(f"{label}: {card}: {len(got)} frames of 1-64 bytes over {sig12.numel()} samples "
              f"in blocks of {1 << 20}: all once at their true starts, bytes exact; "
              f"{dt:.2f} s host clock, {dt / len(got) * 1e3:.1f} ms per frame", flush=True)
    return sig, truth


def awgn(sig, snr_db, seed):
    """``sig`` plus numpy-seeded complex AWGN at ``snr_db`` per sample."""
    rng = np.random.RandomState(seed)
    sigma = np.sqrt(10.0 ** (-snr_db / 10.0) / 2.0)
    noise = (sigma * (rng.randn(sig.numel()) + 1j * rng.randn(sig.numel()))).astype(np.complex64)
    return sig + torch.from_numpy(noise).to(sig.device)


def same_frames(a, b, label):
    """Equal (start, bytes, info) lists; soft_margin within 1e-4 relative
    (plus 1e-4 absolute for margins near zero)."""
    check(len(a) == len(b), f"{label}: {len(a)} frames against {len(b)}")
    for (s, pay, info), (rs, rpay, rinfo) in zip(a, b):
        info, rinfo = dict(info), dict(rinfo)
        m, rm = info.pop("soft_margin", 0.0), rinfo.pop("soft_margin", 0.0)
        check((s, pay, info) == (rs, rpay, rinfo), f"{label}: frame at {s} differs")
        check(abs(m - rm) <= 1e-4 * abs(rm) + 1e-4, f"{label}: soft_margin {m} vs {rm}")


def phase10_noise_and_soft(dev, card, sig, truth, xr5, xi5, pay5):
    """Soft vs hard under AWGN, card vs CPU, and the block receiver's
    soft path."""
    p = LoraParams(sf=7)
    end = truth[PHASE10_FRAMES][0]
    tail = torch.zeros(4 * p.step, dtype=torch.complex64, device=dev)
    noisy = awgn(torch.cat([sig[:end], tail]), PHASE10_SNR_DB, seed=10)
    tmap = {t[0]: t for t in truth[:PHASE10_FRAMES]}
    counts = {}
    for soft_mode in (False, True):
        got, dt = run_adaptive(noisy, p, GATEWAY_BLOCK, soft_mode)
        right = [g for g in got if g[0] in tmap and tmap[g[0]][1] == g[1]]
        clean = [g for g in got if g[2]["crc"] and g[2]["crc_ok"]]
        wrong_pass = [g[0] for g in clean if g not in right]
        label = f"phase 10 {'soft' if soft_mode else 'hard'}"
        check(not wrong_pass, f"{label}: frames at {wrong_pass} pass the CRC with wrong bytes")
        counts[soft_mode] = len(clean)
        lost = PHASE10_FRAMES - len(right)
        print(f"{label}: {PHASE10_FRAMES} frames at {PHASE10_SNR_DB} dB SNR: {len(got)} "
              f"reported, {len(right)} bit-exact, {lost} lost ({lost / PHASE10_FRAMES:.0%}), "
              f"{len(clean)} CRC-clean, none wrong with crc_ok; {dt:.2f} s host", flush=True)
        if not soft_mode:
            check(0.05 <= lost / PHASE10_FRAMES <= 0.5,
                  f"{label}: the hard receiver loses {lost} frames, outside 5-50 %")
    check(counts[True] >= counts[False],
          f"phase 10: soft {counts[True]} CRC-clean frames < hard {counts[False]}")

    prefix = noisy[: truth[PHASE10_CPU_FRAMES][0]]
    for soft_mode in (False, True):
        on_card, dt_card = run_adaptive(prefix, p, GATEWAY_BLOCK, soft_mode)
        on_cpu, dt_cpu = run_adaptive(prefix.cpu(), p, GATEWAY_BLOCK, soft_mode)
        label = f"phase 10 card vs CPU {'soft' if soft_mode else 'hard'}"
        same_frames(on_card, on_cpu, label)
        print(f"{label}: {PHASE10_CPU_FRAMES}-frame noisy prefix: equal frame lists "
              f"({len(on_cpu)} frames); host clock: card {dt_card:.2f} s, the machine's "
              f"CPU {dt_cpu:.2f} s", flush=True)

    # the block receiver's soft path (lora-rx-stream --soft)
    n_pay = 2 * BLOCK_PAYLOAD
    blk, spectra = sync.receive_block_planar(xr5, xi5, p, n_pay, max_frames=BLOCK_FRAMES,
                                             min_power_db=-30.0, with_spectra=True)
    decoded = soft.hamming84_ml_decode(spectra)
    ok = (decoded == pay5[:, None, :]).all(-1)
    n_found = int(blk.found.sum())
    check(n_found >= CHANNELS * (BLOCK_FRAMES - 1) and bool(ok[blk.found].all()),
          f"phase 10 block soft: {n_found} found, {int((~ok[blk.found]).sum())} differ")
    t_rx = cuda_ms(lambda: sync.receive_block_planar(
        xr5, xi5, p, n_pay, max_frames=BLOCK_FRAMES, min_power_db=-30.0, with_spectra=True))
    t_ml = cuda_ms(lambda: soft.hamming84_ml_decode(spectra))
    print(f"phase 10: {card}: block receiver soft path on phase 5's stream: {n_found} frames "
          f"found, all bit-exact through hamming84_ml_decode; receive_block_planar("
          f"with_spectra=True) {t_rx:.3f} ms, hamming84_ml_decode {t_ml:.3f} ms", flush=True)


def same_blocks(a, b, label):
    """Equal found on every lane; equal start / cfo_bins / symbols / sync on
    the found lanes (a lane that found nothing carries unspecified
    values)."""
    check(torch.equal(a.found.cpu(), b.found.cpu()), f"{label}: found differs")
    f = b.found.cpu()
    for name in ("start", "cfo_bins", "symbols", "sync"):
        check(torch.equal(getattr(a, name).cpu()[f], getattr(b, name).cpu()[f]),
              f"{label}: {name} differs")


def phase11_wideband(dev, card):
    """The channelizer alone and the wideband receiver at bench.py's shape;
    returns the kernel launch counts of both paths."""
    p = LoraParams(sf=7)
    k, taps = WIDEBAND_K, CHANNELIZE_TAPS
    gen = torch.Generator(device=dev).manual_seed(11)
    n = CHANNELIZE_SAMPLES
    xr = torch.randn(n, generator=gen, device=dev)
    xi = torch.randn(n, generator=gen, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    cr, ci = channelizer.channelize_planar(xr, xi, k, taps)
    torch.cuda.synchronize()
    chan_launches = read_launches("channelize")
    head = 1 << 16
    hr, hi = channelizer.channelize_planar(xr[:head].cpu(), xi[:head].cpu(), k, taps)
    m = head // k - taps                      # frames whose windows lie in the head
    err = max(float((cr[:, :m].cpu() - hr[:, :m]).abs().max()),
              float((ci[:, :m].cpu() - hi[:, :m]).abs().max()))
    check(tuple(cr.shape) == (k, n // k), f"phase 11: channelized shape {tuple(cr.shape)}")
    check(err <= 1e-5, f"phase 11: channelizer differs from the CPU by {err}")
    t_chan = cuda_ms(lambda: channelizer.channelize_planar(xr, xi, k, taps), iters=10)
    del cr, ci, xr, xi
    # least time: both planes read and both written once; or its multiply-
    # adds, 2K outputs x 2*taps*K terms per output frame
    nbytes = 4 * 2 * n * 2
    flops = 2 * (n // k) * (2 * k) * (2 * taps * k)
    t_bound = max(nbytes / PEAK_HBM_BYTES, flops / PEAK_F32_FLOPS) * 1e3
    print(f"phase 11: {card}: channelize_planar K={k}, {taps} taps per branch, over {n} "
          f"samples: {t_chan:.3f} ms ({n / t_chan / 1e6:.3f} Gsamples/s, "
          f"{nbytes / t_chan / 1e6:.0f} GB/s); bound {t_bound:.3f} ms ({nbytes:.4g} B, "
          f"{flops:.4g} flop); the first {head} samples' channels within {err:.2e} of the "
          f"CPU's; fused_demod launches {chan_launches}", flush=True)

    # the wideband receiver: phase 5's traffic on every channel, through the
    # synthesis bank into one stream at K times the rate
    taps = WIDEBAND_TAPS
    xr_c, xi_c, pay, period = block_stream(dev, p, k, BLOCK_FRAMES)
    wr, wi = channelizer.synthesize_channels_planar(xr_c, xi_c, k, taps)
    del xr_c, xi_c
    n_pay = 2 * BLOCK_PAYLOAD
    kw = {"max_frames": BLOCK_FRAMES, "taps_per_branch": taps, "min_power_db": -30.0}

    def run(spectra=False):
        return sync.receive_wideband_planar(wr, wi, k, p, n_pay, with_spectra=spectra, **kw)

    torch.cuda.synchronize()
    reset_launches()
    blk = run()
    torch.cuda.synchronize()
    wb_launches = read_launches("wideband")
    n_found = check_block(blk, pay, k * (BLOCK_FRAMES - 1), "phase 11")
    total = wr.numel()
    t_wb = cuda_ms(run, iters=5)
    t_spec = cuda_ms(lambda: run(True), iters=5)
    print(f"phase 11: {card}: receive_wideband_planar over {total} wideband samples "
          f"({k} channels x {BLOCK_FRAMES} frames): {n_found} found, all bit-exact, sync "
          f"0x12; {t_wb:.3f} ms ({total / t_wb / 1e6:.3f} Gsamples/s, "
          f"{n_found / t_wb * 1e3:.0f} frames/s), with_spectra=True {t_spec:.3f} ms; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; fused_demod "
          f"launches {wb_launches}", flush=True)
    profile_once(run, f"phase 11: {card}: receive_wideband_planar")

    # the card against the CPU on a 2-frame-per-channel prefix
    cut = (2 * period + 4 * p.step) * k
    kw_cut = dict(kw, max_frames=2)
    on_card = sync.receive_wideband_planar(wr[:cut], wi[:cut], k, p, n_pay, **kw_cut)
    on_cpu = sync.receive_wideband_planar(wr[:cut].cpu(), wi[:cut].cpu(), k, p, n_pay,
                                          **kw_cut)
    same_blocks(on_card, on_cpu, "phase 11 card vs CPU")
    check(int(on_cpu.found.sum()) == 2 * k, f"phase 11: the CPU found "
          f"{int(on_cpu.found.sum())} of {2 * k} prefix frames")
    print(f"phase 11: receive_wideband_planar on a {cut}-sample prefix: equal decisions on "
          f"the card and the CPU ({int(on_cpu.found.sum())} frames)", flush=True)
    return {"channelize": chan_launches, "wideband": wb_launches}


def two_ray_trials(p, payload, trials, seed, dev):
    """One frame at 3 windows through the near-equal-power two-ray channel
    (a 0.95 echo 3 samples late) plus numpy AWGN, one trial per channel."""
    iq = stream.frame_modulate(modem.encode(torch.from_numpy(payload).to(dev)), p)
    s = torch.zeros(3 * p.step + iq.numel() + 4 * p.step, dtype=torch.complex64, device=dev)
    s[3 * p.step: 3 * p.step + iq.numel()] = iq
    taps = np.array([1.0, 0, 0, 0.95 * np.exp(2.0j)], np.complex64)
    yr, yi = impair.apply_multipath_planar(s.real, s.imag, taps.real, taps.imag)
    rng = np.random.RandomState(seed)
    sigma = np.sqrt(0.5 * 10.0 ** (-TWO_RAY_SNR_DB / 10.0))
    noise = torch.from_numpy((sigma * rng.randn(2, trials, s.numel())).astype(np.float32))
    return yr + noise[0].to(dev), yi + noise[1].to(dev)


def blind_stream(dev, payload_len, seed):
    """One stream holding one frame at each of SF7-12, 4 windows of its own
    SF after the previous one, and their (sf, start, payload)."""
    rng = np.random.RandomState(seed)
    parts, truth, pos = [], [], 0
    for sf in range(7, 13):
        p = LoraParams(sf=sf)
        pl = rng.randint(0, 256, payload_len).astype(np.uint8)
        fr, fi = stream.frame_modulate_planar(modem.encode(torch.from_numpy(pl).to(dev)), p)
        gap = torch.zeros(2, 4 * p.step, device=dev)
        pos += gap.shape[-1]
        truth.append((sf, pos, pl))
        parts += [gap, torch.stack([fr, fi])]
        pos += fr.numel()
    parts.append(torch.zeros(2, 14 * LoraParams(sf=12).step, device=dev))
    x = torch.cat(parts, dim=-1)
    return x[0].contiguous(), x[1].contiguous(), truth


def phase12_block_modes(dev, card, xr5, xi5, pay5):
    """The robust mode, CAD, blind SF and the front-end correction; returns
    the kernel launch counts of each path."""
    p = LoraParams(sf=7)
    n_pay = 2 * BLOCK_PAYLOAD
    launches = {}

    def counted(name, fn):
        torch.cuda.synchronize()
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = read_launches(name)
        return out

    def receive(pre_acc):
        return sync.receive_block_planar(xr5, xi5, p, n_pay, max_frames=BLOCK_FRAMES,
                                         min_power_db=-30.0, pre_acc=pre_acc)

    # --robust: pre_acc=3 on phase 5's stream gives pre_acc=1's decisions
    robust = counted("robust", lambda: receive(3))
    plain = receive(1)
    same_blocks(robust, plain, "phase 12 pre_acc=3 vs pre_acc=1")
    n_found = check_block(robust, pay5, CHANNELS * (BLOCK_FRAMES - 1), "phase 12 robust")
    t3 = cuda_ms(lambda: receive(3), iters=5)
    t1 = cuda_ms(lambda: receive(1), iters=5)
    print(f"phase 12: {card}: receive_block_planar(pre_acc=3) on phase 5's stream: {n_found} "
          f"frames, every decision equal to pre_acc=1's; {t3:.3f} ms against {t1:.3f} ms at "
          f"pre_acc=1 ({xr5.numel() / t3 / 1e6:.3f} Gsamples/s); fused_demod launches "
          f"{launches['robust']}", flush=True)
    profile_once(lambda: receive(3), f"phase 12: {card}: receive_block_planar(pre_acc=3)")

    # the two-ray channel that defeats the plain receiver
    pl = np.random.RandomState(26).randint(0, 256, 8).astype(np.uint8)
    yr, yi = two_ray_trials(p, pl, TWO_RAY_TRIALS, seed=4000, dev=dev)
    decoded = {}
    for acc in (1, 3):
        blk = sync.receive_block_planar(yr, yi, p, 16, min_power_db=-30.0, pre_acc=acc)
        ref = sync.receive_block_planar(yr.cpu(), yi.cpu(), p, 16, min_power_db=-30.0,
                                        pre_acc=acc)
        same_blocks(blk, ref, f"phase 12 two-ray pre_acc={acc} card vs CPU")
        ok = (modem.decode(blk.symbols) == torch.from_numpy(pl).to(dev)).all(-1)
        near = (blk.start - 3 * p.step).abs() <= p.step
        decoded[acc] = int((ok & near & blk.found).any(-1).sum())
    check(decoded[3] >= TWO_RAY_TRIALS * 2 // 3 and decoded[1] <= TWO_RAY_TRIALS // 3,
          f"phase 12 two-ray: robust decodes {decoded[3]}, plain {decoded[1]} of "
          f"{TWO_RAY_TRIALS}")
    print(f"phase 12: two-ray channel (0.95 echo, 3 samples), {TWO_RAY_SNR_DB} dB, "
          f"{TWO_RAY_TRIALS} trials: pre_acc=3 decodes {decoded[3]}, pre_acc=1 {decoded[1]}; "
          f"card and CPU decisions equal", flush=True)
    rng = np.random.RandomState(99)
    loud = torch.from_numpy((np.sqrt(0.5) * rng.randn(2, 20000)).astype(np.float32)).to(dev)
    blk = sync.receive_block_planar(loud[0], loud[1], p, 16, min_power_db=-30.0, pre_acc=3)
    check(not bool(blk.found.any()), "phase 12: pre_acc=3 found a frame in loud noise")
    print("phase 12: pre_acc=3 on 20000 samples of 0 dB noise: no frame", flush=True)

    # CAD over the same stream and over silence
    active, peak_db = counted("cad", lambda: sync.cad_planar(xr5, xi5, p))
    quiet, _ = sync.cad_planar(torch.zeros_like(xr5), torch.zeros_like(xi5), p)
    check(bool(active.all()) and not bool(quiet.any()),
          f"phase 12: CAD active {active.tolist()}, silence {quiet.tolist()}")
    t_cad = cuda_ms(lambda: sync.cad_planar(xr5, xi5, p), iters=10)
    print(f"phase 12: {card}: cad_planar over phase 5's {CHANNELS} channels: all active "
          f"(peak {float(peak_db.min()):.2f} dB), silence inactive; {t_cad:.3f} ms against "
          f"{t1:.3f} ms for the full receive; fused_demod launches {launches['cad']}",
          flush=True)

    # blind SF: one frame at each of SF7-12 in one stream
    br, bi, truth = blind_stream(dev, BLOCK_PAYLOAD, seed=12)
    t0 = time.perf_counter()
    res = counted("blind", lambda: sync.receive_blind_planar(br, bi, p, n_pay))
    rows = sync.blind_frames(res)
    dt = time.perf_counter() - t0
    got = [(r["sf"], r["start"], bytes(modem.decode(r["symbols"]).cpu().numpy()))
           for r in rows]
    want = [(sf, st, pl.tobytes()) for sf, st, pl in truth]
    check(sorted(got) == sorted(want) and all(r["sync"] == 0x12 for r in rows),
          f"phase 12 blind: {[(g[0], g[1]) for g in got]} against "
          f"{[(w[0], w[1]) for w in want]}")
    def blind():
        return sync.blind_frames(sync.receive_blind_planar(br, bi, p, n_pay))

    t0 = time.perf_counter()
    blind()
    dt2 = time.perf_counter() - t0
    print(f"phase 12: {card}: receive_blind_planar over {br.numel()} samples: all six "
          f"frames (SF7-12) found at their SF and start, bytes exact, sync 0x12; host clock "
          f"for six SFs and the rows {dt * 1e3:.1f} ms (first call), {dt2 * 1e3:.1f} ms "
          f"(second); fused_demod launches {launches['blind']}", flush=True)
    profile_once(blind, f"phase 12: {card}: receive_blind_planar + blind_frames", calls=3)

    # --frontend-correct: DC and IQ imbalance, blind estimate, compensate, decode
    frames = min(16, BLOCK_FRAMES)
    period = xr5.shape[-1] // BLOCK_FRAMES
    clean = torch.complex(xr5[0, :frames * period], xi5[0, :frames * period])
    bad = impair.apply_frontend(clean, dc=0.05 + 0.03j, gain_imbalance=1.1,
                                phase_skew_deg=5.0)

    def corrected():
        est = impair.estimate_frontend_planar(bad.real.contiguous(), bad.imag.contiguous())
        return est, impair.compensate_frontend_planar(bad.real, bad.imag, *est)

    (dc_i, dc_q, g, sin_phi), (cr, ci) = counted("frontend", corrected)
    blk = sync.receive_block_planar(cr, ci, p, n_pay, max_frames=frames, min_power_db=-30.0)
    n_ok = int(((modem.decode(blk.symbols) == pay5[0]).all(-1) & blk.found).sum())
    check(n_ok == frames, f"phase 12 frontend: {n_ok} of {frames} frames decoded")
    print(f"phase 12: --frontend-correct on {frames} frames (dc 0.05+0.03j, gain 1.1, 5 "
          f"degrees): estimated dc {float(dc_i):.4f}{float(dc_q):+.4f}j, gain "
          f"{float(g):.4f}, sin(phi) {float(sin_phi):.4f} (true "
          f"{np.sin(np.radians(5.0)):.4f}); all {frames} frames bit-exact after "
          f"compensation", flush=True)
    return launches


def sic_trial(dev, p, gap_db, rng):
    """sic_sweep.py's collision in a SIC_BLOCK-sample block: the weak frame
    5 windows after the strong one, ``gap_db`` under it, numpy AWGN at
    SIC_SNR_DB relative to the strong frame. Returns the planes, the two
    starts and the two payloads."""
    off_a = 2 * p.step
    off_b = off_a + 5 * p.step
    pay_a = rng.randint(0, 256, SIC_PAYLOAD).astype(np.uint8)
    pay_b = rng.randint(0, 256, SIC_PAYLOAD).astype(np.uint8)
    fa = stream.frame_modulate(modem.encode(torch.from_numpy(pay_a).to(dev)), p)
    fb = 10.0 ** (-gap_db / 20.0) * stream.frame_modulate(
        modem.encode(torch.from_numpy(pay_b).to(dev)), p)
    s = torch.zeros(SIC_BLOCK, dtype=torch.complex64, device=dev)
    s[off_a: off_a + fa.numel()] += fa
    s[off_b: off_b + fb.numel()] += fb
    sigma = 10.0 ** (-SIC_SNR_DB / 20.0) / np.sqrt(2.0)
    noise = torch.from_numpy((sigma * rng.randn(2, SIC_BLOCK)).astype(np.float32)).to(dev)
    return s.real + noise[0], s.imag + noise[1], (off_a, off_b), (pay_a, pay_b)


def same_sic_frames(a, b, label):
    """Equal frame lists (start, sync, cfo_bins, sic_pass, symbols); cfo
    within 1e-5 bins and gains within 1e-4 relative."""
    check(len(a) == len(b), f"{label}: {len(a)} frames against {len(b)}")
    for x, y in zip(a, b):
        check(all(x[key] == y[key] for key in ("start", "sync", "cfo_bins", "sic_pass"))
              and torch.equal(x["symbols"].cpu(), y["symbols"].cpu()),
              f"{label}: frame at {x['start']} differs")
        gx, gy = complex(*x["gain"]), complex(*y["gain"])
        check(abs(x["cfo"] - y["cfo"]) <= 1e-5 and abs(gx - gy) <= 1e-4 * abs(gy),
              f"{label}: frame at {x['start']}: cfo {x['cfo']} / {y['cfo']}, "
              f"gain {gx} / {gy}")


def phase13_sic(dev, card):
    """SIC over sic_sweep.py's collisions at --sic's settings; returns the
    kernel launch count of the SIC path."""
    p = LoraParams(sf=7)
    n_pay = 2 * SIC_PAYLOAD
    rng = np.random.RandomState(13)
    kw = {"max_frames": SIC_MAX_FRAMES, "min_power_db": -30.0, "max_iters": SIC_MAX_FRAMES}
    launches = 0

    def hit(rows, off, pay):
        return any(abs(r["start"] - off) <= 2 and bytes(
            modem.decode(r["symbols"]).cpu().numpy()) == pay.tobytes() for r in rows)

    for gap in SIC_GAPS_DB:
        weak_plain = weak_sic = strong_sic = peels = 0
        host = 0.0
        for t in range(SIC_TRIALS):
            xr, xi, (off_a, off_b), (pay_a, pay_b) = sic_trial(dev, p, gap, rng)
            plain = sync.block_rows(sync.receive_block_planar(xr, xi, p, n_pay,
                                                              min_power_db=-30.0))
            weak_plain += hit(plain, off_b, pay_b)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            frames, _ = sic.receive_sic_planar(xr, xi, p, n_pay, **kw)
            host += time.perf_counter() - t0
            launches += read_launches("sic")
            peels += len(frames)
            weak_sic += hit(frames, off_b, pay_b)
            strong_sic += hit(frames, off_a, pay_a)
            if t == 0:
                on_cpu, _ = sic.receive_sic_planar(xr.cpu(), xi.cpu(), p, n_pay, **kw)
                same_sic_frames(frames, on_cpu, f"phase 13 gap {gap:g} dB card vs CPU")
        check(strong_sic == SIC_TRIALS and weak_sic >= weak_plain,
              f"phase 13 gap {gap:g} dB: strong {strong_sic}, weak {weak_sic} (plain "
              f"{weak_plain}) of {SIC_TRIALS}")
        print(f"phase 13: {card}: gap {gap:g} dB, {SIC_TRIALS} trials at {SIC_SNR_DB} dB SNR "
              f"in {SIC_BLOCK}-sample blocks: weak frame {weak_sic} of {SIC_TRIALS} with SIC, "
              f"{weak_plain} in one plain pass; strong {strong_sic}; "
              f"{host / SIC_TRIALS * 1e3:.1f} ms host per call, "
              f"{host / max(peels, 1) * 1e3:.1f} ms per peeled frame; card and CPU frame lists "
              f"equal on the first trial", flush=True)
    xr, xi, _, _ = sic_trial(dev, p, 9.0, rng)
    profile_once(lambda: sic.receive_sic_planar(xr, xi, p, n_pay, **kw),
                 f"phase 13: {card}: receive_sic_planar, one {SIC_BLOCK}-sample block, "
                 f"two frames", calls=3)
    return {"sic": launches}


# ---------------------------------------------------------------------------
# Phase 14: the command line on the card
# ---------------------------------------------------------------------------

def run_main(main_fn, args):
    """``main_fn(args)`` with stdout and stderr captured: (rc, out, err,
    host seconds)."""
    out, err = (io.TextIOWrapper(io.BytesIO(), encoding="utf-8", write_through=True)
                for _ in range(2))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main_fn(list(args))
        except SystemExit as e:
            rc = e.code
    dt = time.perf_counter() - t0
    return rc, out.buffer.getvalue().decode(), err.buffer.getvalue().decode(), dt


def frame_fields(line):
    """(start, {key: value}) of a receiver's text line."""
    toks = line.split()
    at = [t for t in toks if t.startswith("@")][0]
    return int(at[1:].rstrip(":")), dict(t.split("=", 1) for t in toks if "=" in t)


def same_lines(a, b, label):
    """Two receivers' stdout lines agree one for one: every decision field
    exactly; the printed snr / sro within one printed digit (0.1: the
    values agree within 1e-2 dB and 0.05 ppm); margin= within one printed
    digit plus 1e-4 relative."""
    la, lb = a.splitlines(), b.splitlines()
    check(len(la) == len(lb), f"{label}: {len(la)} lines against {len(lb)}")
    for x, y in zip(la, lb):
        (sx, fx), (sy, fy) = frame_fields(x), frame_fields(y)
        ok = sx == sy and fx.keys() == fy.keys()
        for key in fx if ok else ():
            if key in ("snr", "sro"):
                unit = "dB" if key == "snr" else "ppm"
                ok &= abs(float(fx[key][:-len(unit)]) - float(fy[key][:-len(unit)])) <= 0.1 + 1e-9
            elif key == "margin":
                ok &= abs(float(fx[key]) - float(fy[key])) <= 0.1 + 1e-4 * abs(float(fy[key]))
            else:
                ok &= fx[key] == fy[key]
        check(ok, f"{label}: {x!r} against {y!r}")


def write_cf32(path, re, im):
    """Planes (tensors) -> an interleaved cf32 file through the runtime."""
    from lora_phy_tpu_torch import runtime

    runtime.from_planar(re.cpu().numpy(), im.cpu().numpy()).tofile(path)


def check_cli_frames(out, err, truth, label):
    """Every frame of ``truth`` [(start, payload hex)] reported once, in
    order, at its true start with its bytes; the count on stderr."""
    got = [(frame_fields(l)[0], l.split("payload=")[1]) for l in out.splitlines()]
    bad = [k for k, (g, t) in enumerate(zip(got, truth)) if g != t]
    check(len(got) == len(truth) and not bad,
          f"{label}: {len(got)} frames reported for {len(truth)}; first mismatch "
          f"{bad[:1] or 'count'}")
    check(f"{len(truth)} frames" in err, f"{label}: stderr says {err.strip()!r}")


def phase14_cli(dev, card, tmp):
    """The port's runners on the card (tx_stream / rx_stream in this
    process, a shell pipe in two): returns the kernel launch counts, the
    4096-frame file's truth and rx_stream's lines over its cf32 copy
    (``tmp / "stream_cf32.iq"``, kept for phase 17)."""
    from lora_phy_tpu_torch.runners import rx_stream, tx_stream

    p = LoraParams(sf=7)
    rng = np.random.RandomState(14)
    launches = {}
    dev_flag = f"--device={dev}"
    blk = f"--block={CLI_BLOCK}"
    maxf = f"--max-frames={CLI_MAX_FRAMES}"

    # 1-2: the block path at bench width, cf32 and ci16
    pays = rng.randint(0, 256, (CLI_FRAMES, CLI_PAYLOAD)).astype(np.uint8)
    plist = tmp / "payloads.txt"
    plist.write_text("".join(x.tobytes().hex() + "\n" for x in pays))
    period = CLI_GAP + stream.frame_overhead_samples(p) + 2 * CLI_PAYLOAD * p.step
    truth = [(CLI_GAP + k * period, x.tobytes().hex()) for k, x in enumerate(pays)]
    cli_lines = {}
    for fmt in ("cf32", "ci16"):
        path = tmp / f"stream_{fmt}.iq"
        rc, _, err, t_tx = run_main(tx_stream.main, [
            f"--payloads={plist}", f"--out={path}", f"--gap={CLI_GAP}",
            f"--format={fmt}", dev_flag])
        check(rc == 0, f"phase 14 tx_stream {fmt}: rc {rc}: {err}")
        n_samples = CLI_FRAMES * period
        torch.cuda.synchronize()
        reset_launches()
        rc, out, err, t_rx = run_main(rx_stream.main, [
            f"--in={path}", f"--format={fmt}", "--payload-len=16", blk, maxf, dev_flag])
        torch.cuda.synchronize()
        launches[f"cli_block_{fmt}"] = read_launches(f"cli_block_{fmt}")
        check(rc == 0, f"phase 14 rx_stream {fmt}: rc {rc}: {err}")
        check_cli_frames(out, err, truth, f"phase 14 rx_stream {fmt}")
        cli_lines[fmt] = out
        n_blocks = -(-n_samples // CLI_BLOCK)
        print(f"phase 14: {card}: tx_stream --format={fmt}: {CLI_FRAMES} frames of "
              f"{CLI_PAYLOAD} bytes, gap {CLI_GAP}, {n_samples} samples in {t_tx:.2f} s; "
              f"rx_stream over it in {CLI_BLOCK}-sample blocks: all {CLI_FRAMES} frames once "
              f"at their true starts with their bytes; {t_rx:.2f} s wall, "
              f"{CLI_FRAMES / t_rx:.0f} frames/s, {n_samples / t_rx / 1e6:.2f} Msamples/s, "
              f"{t_rx / n_blocks * 1e3:.2f} ms host per block ({n_blocks} blocks); "
              f"fused_demod launches {launches[f'cli_block_{fmt}']}", flush=True)

    # the receiver alone on the same buffers (carry ++ block, device-resident):
    # what the CLI adds is ingest, the H2D copy and the report loop
    from lora_phy_tpu_torch import runtime

    re, im = runtime.read_iq_file(tmp / "stream_cf32.iq")
    carry = stream.frame_overhead_samples(p) + 2 * CLI_PAYLOAD * p.step + p.step
    xr = torch.cat([torch.zeros(carry), torch.from_numpy(re)]).to(dev)
    xi = torch.cat([torch.zeros(carry), torch.from_numpy(im)]).to(dev)
    bufs = [(xr[off: off + carry + CLI_BLOCK], xi[off: off + carry + CLI_BLOCK])
            for off in range(0, re.size, CLI_BLOCK)]

    def library_pass():
        for br, bi in bufs:
            sync.receive_block_planar(br, bi, p, 2 * CLI_PAYLOAD, max_frames=CLI_MAX_FRAMES,
                                      min_power_db=-30.0)

    library_pass()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    library_pass()
    torch.cuda.synchronize()
    t_lib = time.perf_counter() - t0
    print(f"phase 14: {card}: receive_block_planar alone over the same {len(bufs)} buffers "
          f"(device-resident, one sync at the end): {t_lib:.2f} s, "
          f"{CLI_FRAMES / t_lib:.0f} frames/s, {t_lib / len(bufs) * 1e3:.2f} ms per block",
          flush=True)
    mid = bufs[len(bufs) // 2]
    profile_once(lambda: sync.receive_block_planar(*mid, p, 2 * CLI_PAYLOAD,
                                                   max_frames=CLI_MAX_FRAMES,
                                                   min_power_db=-30.0),
                 f"phase 14: {card}: receive_block_planar, one CLI buffer")
    del xr, xi, bufs, mid

    # 3: the gateway mode over coded frames of 1-255 bytes
    lengths = rng.randint(1, 256, CLI_CODED_FRAMES)
    lengths[:2] = 1, 255
    coded_pays = [rng.randint(0, 256, n).astype(np.uint8) for n in lengths]
    clist = tmp / "coded.txt"
    clist.write_text("".join(x.tobytes().hex() + "\n" for x in coded_pays))
    cpath = tmp / "coded.iq"
    rc, _, err, _ = run_main(tx_stream.main, [f"--payloads={clist}", f"--out={cpath}",
                                              "--coded", "--crc", "--cr=1", dev_flag])
    check(rc == 0, f"phase 14 tx_stream --coded: rc {rc}: {err}")
    for extra in ([], ["--soft"]):
        label = f"phase 14 --adaptive{' --soft' if extra else ''}"
        torch.cuda.synchronize()
        reset_launches()
        rc, out, err, t_rx = run_main(rx_stream.main, [
            f"--in={cpath}", "--adaptive", blk, dev_flag] + extra)
        launches["cli_adaptive" + ("_soft" if extra else "")] = read_launches(
            "cli_adaptive" + ("_soft" if extra else ""))
        lines = out.splitlines()
        check(rc == 0 and len(lines) == CLI_CODED_FRAMES, f"{label}: rc {rc}, "
              f"{len(lines)} frames of {CLI_CODED_FRAMES}")
        check(all("crc=ok" in l for l in lines), f"{label}: a CRC failed")
        check([l.split("payload=")[1] for l in lines] == [x.tobytes().hex() for x in coded_pays],
              f"{label}: payloads differ")
        print(f"{label}: {card}: {CLI_CODED_FRAMES} tx_stream --coded --crc frames of 1-255 "
              f"bytes: all once, crc=ok, bytes exact; {t_rx:.2f} s wall, "
              f"{CLI_CODED_FRAMES / t_rx:.1f} frames/s, {t_rx / CLI_CODED_FRAMES * 1e3:.2f} ms "
              f"per frame", flush=True)

    # 4: --channels=8 over phase 11's wideband traffic written as cf32
    k = WIDEBAND_K
    xr_c, xi_c, wpay, wperiod = block_stream(dev, p, k, BLOCK_FRAMES)
    wr, wi = channelizer.synthesize_channels_planar(xr_c, xi_c, k, WIDEBAND_TAPS)
    del xr_c, xi_c
    wpath = tmp / "wideband.iq"
    write_cf32(wpath, wr, wi)
    n_wide = wr.numel()
    del wr, wi
    torch.cuda.synchronize()
    reset_launches()
    rc, out, err, t_rx = run_main(rx_stream.main, [
        f"--in={wpath}", "--payload-len=16", f"--channels={k}", f"--taps={WIDEBAND_TAPS}",
        blk, dev_flag])
    torch.cuda.synchronize()
    launches["cli_wideband"] = read_launches("cli_wideband")
    check(rc == 0, f"phase 14 --channels: rc {rc}: {err}")
    wpay = wpay.cpu().numpy()
    per_ch = {c: [] for c in range(k)}
    for line in out.splitlines():
        at, f = frame_fields(line)
        c = int(f["ch"])
        check(f["payload"] == wpay[c].tobytes().hex(), f"phase 14 --channels: {line!r}")
        per_ch[c].append(at)
    for c, starts in per_ch.items():
        want = [m * wperiod * k for m in range(BLOCK_FRAMES)]
        check(len(starts) == BLOCK_FRAMES and all(abs(a - b) <= k for a, b in zip(starts, want)),
              f"phase 14 --channels: channel {c}: {len(starts)} frames, starts "
              f"{starts[:3]} against {want[:3]}")
    check(f"{k * BLOCK_FRAMES} frames" in err, f"phase 14 --channels: {err.strip()!r}")
    n_blocks = -(-n_wide // CLI_BLOCK)
    print(f"phase 14: {card}: rx_stream --channels={k} --taps={WIDEBAND_TAPS} over "
          f"{n_wide} wideband samples ({k} x {BLOCK_FRAMES} frames): all {k * BLOCK_FRAMES} "
          f"frames once, each with its channel's bytes, at its channel start x {k}; "
          f"{t_rx:.2f} s wall, {k * BLOCK_FRAMES / t_rx:.0f} frames/s, "
          f"{t_rx / n_blocks * 1e3:.2f} ms host per block; fused_demod launches "
          f"{launches['cli_wideband']}", flush=True)
    wpath.unlink()

    # 5: a real shell pipe, tx_stream | rx_stream, two processes of their own
    n_pipe = CLI_PIPE_FRAMES
    env = dict(os.environ, PYTHONPATH=str(REPO))
    py = sys.executable
    cmd = (f"{py} -X importtime -m lora_phy_tpu_torch.runners.tx_stream --payloads=- "
           f"--gap={CLI_GAP} --format=ci16 {dev_flag} | {py} -X importtime -m "
           f"lora_phy_tpu_torch.runners.rx_stream --format=ci16 --payload-len=16 {maxf} "
           f"{dev_flag}")
    pipe_in = "".join(plist.read_text().splitlines(True)[:n_pipe])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, shell=True, input=pipe_in, env=env, cwd=tmp,
                          capture_output=True, text=True, timeout=600)
    t_pipe = time.perf_counter() - t0
    check(proc.returncode == 0, f"phase 14 pipe: rc {proc.returncode}: {proc.stderr[-2000:]}")
    check_cli_frames(proc.stdout, proc.stderr, truth[:n_pipe], "phase 14 pipe")
    mods = {l.rsplit("|", 1)[1].strip() for l in proc.stderr.splitlines()
            if l.startswith("import time:") and "|" in l}
    check("lora_phy_tpu_torch.runners._cli" in mods, "phase 14 pipe: no import report")
    jaxy = sorted(m for m in mods if m.split(".")[0] in ("jax", "lora_phy_tpu"))
    check(not jaxy, f"phase 14 pipe: the runners imported {jaxy[:5]}")
    print(f"phase 14: {card}: shell pipe python -m ...tx_stream | python -m ...rx_stream "
          f"{dev_flag}, {n_pipe} frames as ci16 through stdin: all decoded at their true "
          f"starts; neither process imported jax or lora_phy_tpu ({len(mods)} modules); "
          f"{t_pipe:.2f} s wall for both processes", flush=True)

    # 6: a checkpoint written by the card run resumes on the CPU
    small = truth[:CLI_SMALL_FRAMES]
    spath = tmp / "stream_cf32.iq"
    raw = spath.read_bytes()[: (small[-1][0] + period) * 8]
    cut = (small[len(small) // 2][0] + 400) * 8           # inside a frame
    (tmp / "small.iq").write_bytes(raw)
    (tmp / "a.iq").write_bytes(raw[:cut])
    (tmp / "b.iq").write_bytes(raw[cut:])
    ck = tmp / "ck.npz"
    args = ["--payload-len=16", "--block=8192"]
    rc_full, full, _, _ = run_main(rx_stream.main, [f"--in={tmp / 'small.iq'}"] + args
                                   + [dev_flag])
    rc_a, out_a, _, _ = run_main(rx_stream.main, [f"--in={tmp / 'a.iq'}", f"--checkpoint={ck}"]
                                 + args + [dev_flag])
    rc_b, out_b, err_b, _ = run_main(rx_stream.main, [f"--in={tmp / 'b.iq'}",
                                                      f"--checkpoint={ck}"] + args
                                     + ["--device=cpu"])
    check(rc_full == rc_a == rc_b == 0, "phase 14 checkpoint: a run failed")
    n_a = len(out_a.splitlines())
    same_lines(out_b, "\n".join(full.splitlines()[n_a:]), "phase 14 checkpoint card -> CPU")
    check_cli_frames(out_a + out_b, err_b, small, "phase 14 checkpoint card -> CPU")
    print(f"phase 14: a checkpoint written mid-frame by the card run ({n_a} frames) resumes "
          f"on --device=cpu: the remaining {len(small) - n_a} lines equal the card's own "
          f"full run, {len(small)} frames in all", flush=True)

    # 7: the other block modes, the card's lines against the CPU's
    xr_b, xi_b, _ = blind_stream(dev, 8, seed=14)
    write_cf32(tmp / "blind.iq", xr_b, xi_b)
    sic_r, sic_i, _, _ = sic_trial(dev, p, 9.0, np.random.RandomState(15))
    write_cf32(tmp / "sic.iq", sic_r, sic_i)
    modes = [("--robust", [f"--in={tmp / 'small.iq'}", "--payload-len=16", "--robust", maxf],
              16),
             ("--sf=auto", [f"--in={tmp / 'blind.iq'}", "--payload-len=8", "--sf=auto"], 6),
             ("--sic", [f"--in={tmp / 'sic.iq'}", f"--payload-len={SIC_PAYLOAD}", "--sic"], 2),
             ("--cad", [f"--in={tmp / 'small.iq'}", "--payload-len=16", "--cad",
                        "--block=8192"], 16),
             ("--soft", [f"--in={tmp / 'small.iq'}", "--payload-len=16", "--soft", maxf], 16)]
    launches["cli_modes"] = 0
    for name, margs, want in modes:
        torch.cuda.synchronize()
        reset_launches()
        rc_c, out_c, err_c, t_c = run_main(rx_stream.main, margs + [dev_flag])
        torch.cuda.synchronize()
        launches["cli_modes"] += read_launches("cli_modes")
        rc_h, out_h, err_h, _ = run_main(rx_stream.main, margs + ["--device=cpu"])
        check(rc_c == rc_h == 0, f"phase 14 {name}: rc {rc_c} / {rc_h}")
        same_lines(out_c, out_h, f"phase 14 {name} card vs CPU")
        check(len(out_c.splitlines()) == want and err_c == err_h,
              f"phase 14 {name}: {len(out_c.splitlines())} frames, want {want}; "
              f"{err_c.strip()!r} / {err_h.strip()!r}")
        print(f"phase 14: {card}: rx_stream {name}: {want} frames, the card's lines equal "
              f"the CPU's (decisions exact, snr/sro within a printed digit); {t_c:.2f} s "
              f"wall on the card", flush=True)

    # 9: gr-lora_sdr interop frames on the card against the CPU
    from lora_phy_tpu_torch.models import gr_interop

    torch.cuda.synchronize()
    reset_launches()
    for sf, ldro, implicit in ((7, False, False), (12, True, True)):
        pg = LoraParams(sf=sf)
        payload = b"hello world: %d" % sf
        z = torch.zeros(3 * pg.step, dtype=torch.complex64, device=dev)
        sig = torch.cat([z, gr_interop.encode_frame(payload, pg, cr=2, ldro=ldro,
                                                    implicit=implicit, device=dev), z])
        kw = dict(length=len(payload), cr=2, crc=True) if implicit else {}
        for soft in (False, True):
            on_card, on_cpu = (gr_interop.decode_frame(x, pg, ldro=ldro, implicit=implicit,
                                                       soft=soft, tx_phase_step=None, **kw)
                               for x in (sig, sig.cpu()))
            check(on_card is not None and on_card.payload == payload and on_card.crc_ok
                  and vars(on_card) == vars(on_cpu),
                  f"phase 14 gr interop SF{sf} soft={soft}: {on_card} / {on_cpu}")
    torch.cuda.synchronize()
    launches["gr_interop"] = read_launches("gr_interop")
    print("phase 14: gr_interop encode_frame -> decode_frame on the card, SF7 explicit and "
          "SF12 LDRO implicit, hard and soft: bytes exact, crc_ok, every field equal to the "
          "CPU's", flush=True)

    # 10: tx_runner / rx_runner and gr_decode, the card's output against the CPU's
    from lora_phy_tpu_torch.runners import gr_decode, rx_runner, tx_runner

    torch.cuda.synchronize()
    reset_launches()
    for flags in ([], ["--sf=9", "--bw=250000", "--osr=2"]):
        files = {}
        for d in (dev_flag, "--device=cpu"):
            files[d] = tmp / f"tx{len(files)}.iq"
            rc, _, err, _ = run_main(tx_runner.main, ["--payload=deadbeefcafe",
                                                      f"--out={files[d]}", d] + flags)
            check(rc == 0, f"phase 14 tx_runner {flags}: {err}")
        check(files[dev_flag].read_bytes() == files["--device=cpu"].read_bytes(),
              f"phase 14 tx_runner {flags}: the card's IQ differs from the CPU's")
        outs = [run_main(rx_runner.main, [f"--in={files[dev_flag]}", d] + flags)
                for d in (dev_flag, "--device=cpu")]
        check(outs[0][0] == outs[1][0] == 0 and outs[0][1] == outs[1][1],
              f"phase 14 rx_runner {flags}: {outs[0][:3]} / {outs[1][:3]}")
        # BW250 at osr 2 decodes the aliased bins, as the reference binary does
        check(outs[0][1].strip() == "deadbeefcafe" if not flags
              else len(outs[0][1].strip()) == 12, f"phase 14 rx_runner: {outs[0][1]!r}")
    # two frames in gr-lora_sdr's convention (each symbol chirp from phase 0,
    # as gr's modulator builds it), which gr_decode's default expects
    lattice = gr_interop.stream.frame_modulate
    gr_interop.stream.frame_modulate = (
        lambda symbols, params, preamble_len=8, **kw: lattice(
            symbols, params, preamble_len, symbol_phase_carry=False))
    try:
        gap = torch.zeros(900, dtype=torch.complex64, device=dev)
        cap = torch.cat([gap] + [x for k, cr in enumerate((1, 3)) for x in (
            gr_interop.encode_frame(b"hello world: %d" % k, p, cr=cr, device=dev), gap)])
    finally:
        gr_interop.stream.frame_modulate = lattice
    write_cf32(tmp / "gr.iq", cap.real, cap.imag)
    outs = [run_main(gr_decode.main, [f"--in={tmp / 'gr.iq'}", d] + extra)
            for extra in ([], ["--soft"]) for d in (dev_flag, "--device=cpu")]
    check(all(o[0] == 0 and o[1] == outs[0][1] for o in outs)
          and outs[0][1].count("crc=ok") == 2 and "hello world: 1" in outs[0][1],
          f"phase 14 gr_decode: {[o[:2] for o in outs]}")
    torch.cuda.synchronize()
    launches["cli_runners"] = read_launches("cli_runners")
    print("phase 14: tx_runner / rx_runner (SF7; SF9 BW250 osr 2) and gr_decode (two gr-"
          "convention frames, hard and soft) on the card: IQ bytes and printed lines equal "
          "to the CPU's, both gr frames crc=ok", flush=True)
    return launches, truth, cli_lines["cf32"]


# ---------------------------------------------------------------------------
# Phase 15: the AWGN Monte Carlo on the card
# ---------------------------------------------------------------------------

def phase15_awgn(dev, card, tmp):
    """models.awgn's planar Monte Carlo at sweep scale, its gates, the card
    against the CPU on injected draws, and awgn_sweep's default run;
    returns the kernel launch count."""
    from lora_phy_tpu_torch.models import awgn as awgn_model
    from lora_phy_tpu_torch.runners import awgn_sweep

    launches = 0
    for sf, packets in AWGN_CELLS:
        nsym = -(-(AWGN_PAYLOAD * 2 * 5) // sf)                # CR 4/5 bits over sf
        plane = packets * nsym * (1 << sf)
        # least traffic of a point that materialises its noise: both noise
        # planes written once by the generator and read once
        bound_ms = 2 * 2 * 4 * plane / PEAK_HBM_BYTES * 1e3
        gen = torch.Generator(device=dev).manual_seed(sf)

        def point(snr):
            return awgn_model._simulate_point_planar(snr, sf, "4/5", packets, AWGN_PAYLOAD, gen)

        torch.cuda.synchronize()
        reset_launches()
        point(0.0)
        torch.cuda.reset_peak_memory_stats()
        pers, rows, times = {}, [], []
        for snr in AWGN_SNRS + (12.0, -25.0):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            bit_err, pkt_err = point(snr)
            b.record()
            b.synchronize()
            host = time.perf_counter() - t0
            ms = a.elapsed_time(b)
            times.append(ms)
            pers[snr] = int(pkt_err) / packets
            rows.append(f"{card}: {snr:g} dB PER {pers[snr]:.6f} BER "
                        f"{int(bit_err) / (packets * AWGN_PAYLOAD * 8):.6f} {ms:.3f} ms")
            if snr == AWGN_SNRS[0]:
                first = (ms, host)
        torch.cuda.synchronize()
        launches += read_launches("awgn")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        med = statistics.median(times)
        check(pers[12.0] == 0.0, f"phase 15 SF{sf}: PER {pers[12.0]} at 12 dB")
        check(pers[-25.0] > 0.5, f"phase 15 SF{sf}: PER {pers[-25.0]} at -25 dB")
        sweep = [pers[s] for s in AWGN_SNRS]
        check(all(x >= y for x, y in zip(sweep, sweep[1:])),
              f"phase 15 SF{sf}: the waterfall is not monotone: {sweep}")
        print(f"phase 15: {card}: simulate_planar SF{sf} CR 4/5, {AWGN_PAYLOAD}-byte "
              f"payloads, {packets} packets x {nsym} symbols x {1 << sf} samples "
              f"({plane} per plane) per point: median {med:.3f} ms device per point "
              f"({packets / med * 1e3:.0f} packets/s; first point {first[0]:.3f} ms, host "
              f"{first[1] * 1e3:.1f} ms); bound {bound_ms:.3f} ms by bytes (the noise planes "
              f"written and read once); peak memory {peak:.2f} GiB; PER 0 at 12 dB, "
              f"{pers[-25.0]:.4f} at -25 dB, weakly monotone over {AWGN_SNRS[0]:g}..."
              f"{AWGN_SNRS[-1]:g} dB", flush=True)
        for r in rows:
            print(f"phase 15: SF{sf}:   {r}", flush=True)
        profile_once(lambda: point(AWGN_SNRS[len(AWGN_SNRS) // 2]),
                     f"phase 15: {card}: one SF{sf} point", calls=2)

        # the card against the CPU on the same injected draws, at the point
        # nearest PER 0.5, where the decoders see the most mixed decisions
        g = torch.Generator(device=dev).manual_seed(100 + sf)
        payload = torch.randint(0, 256, (AWGN_PREFIX, AWGN_PAYLOAD), generator=g,
                                dtype=torch.int32, device=dev).to(torch.uint8)
        shape = (AWGN_PREFIX, nsym, 1 << sf)
        noise = (torch.randn(shape, generator=g, device=dev),
                 torch.randn(shape, generator=g, device=dev))
        snr = min(pers, key=lambda x: abs(pers[x] - 0.5))          # nearest the knee
        on_card = [int(v) for v in awgn_model._simulate_point_planar(
            snr, sf, "4/5", AWGN_PREFIX, AWGN_PAYLOAD, payload=payload, noise=noise)]
        on_cpu = [int(v) for v in awgn_model._simulate_point_planar(
            snr, sf, "4/5", AWGN_PREFIX, AWGN_PAYLOAD, payload=payload.cpu(),
            noise=tuple(n.cpu() for n in noise), device="cpu")]
        check(on_card == on_cpu, f"phase 15 SF{sf}: card {on_card} vs CPU {on_cpu}")
        print(f"phase 15: SF{sf} at {snr:g} dB, {AWGN_PREFIX} packets with the same injected "
              f"payloads and noise: bit / packet errors {on_card} on the card and the CPU",
              flush=True)
        del noise, payload
        torch.cuda.empty_cache()

    out = tmp / "awgn_sweep"
    rc, _, err, t = run_main(awgn_sweep.main, [f"--out={out}", f"--device={dev}"])
    header = (out / "awgn_sweep.csv").read_text().splitlines()
    check(rc == 0 and header[0] == "sf,bw,cr,snr_db,ber,per" and len(header) == 1 + 3 * 25,
          f"phase 15 awgn_sweep: rc {rc}, {header[:1]}, {len(header)} lines: {err}")
    print(f"phase 15: {card}: awgn_sweep with its default profiles (3 x 25 points of 100 "
          f"packets): CSV header {header[0]}, {len(header) - 1} rows, {t:.2f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 16: the flowgraph runtime on the card
# ---------------------------------------------------------------------------

def topology_doc(noise_db=-30.0):
    """A Pothos ``.pth`` document in the layout load_topology reads: the
    simulation chain (test_gen -> pacer -> encoder -> mod -> breaker net
    "air" -> adder with the noise source -> rotate -> demod -> decoder ->
    chat box) with the noise amplitude set through a numeric entry, an
    evaluator and two signal wires; a plotter tap through freq_demod; a
    disabled source; and an implicit-header chain whose decoder carries
    ``dataLength``. Globals SF=10, MTU=20, SYNC=0x12 (runners override)."""
    def block(bid, path, enabled=True, **props):
        return {"what": "Block", "id": bid, "path": path, "enabled": enabled,
                "properties": [{"key": k, "value": v} for k, v in props.items()]}

    def wire(src, dst, sk="0", dk="0", enabled=True):
        return {"what": "Connection", "outputId": src, "outputKey": sk,
                "inputId": dst, "inputKey": dk, "enabled": enabled}

    def signal(src, dst, sig, slot):
        return {"what": "Connection", "signalId": src, "slotId": dst,
                "sigSlots": [[sig, slot]]}

    sf = {"sf": "SF"}
    objs = [
        block("TestGen0", "/lora/test_gen"),
        block("TestGenOff", "/lora/test_gen", enabled=False),
        block("Pacer0", "/blocks/pacer"),
        block("Encoder0", "/lora/lora_encoder", cr='"4/8"', explicit="true",
              crc="true", **sf),
        block("Mod0", "/lora/lora_mod", sync="SYNC", padding="2", ampl="1.0", **sf),
        {"what": "Breaker", "id": "BreakTx", "nodeName": "air"},
        {"what": "Breaker", "id": "BreakRx", "nodeName": "air"},
        block("NoiseSource1", "/comms/noise_source", ampl="0.0"),
        block("Adder0", "/comms/arithmetic", operation='"ADD"'),
        block("Rotate0", "/comms/rotate", phase="pi / 8"),
        block("Demod0", "/lora/lora_demod", sync="SYNC", thresh="-30.0", **sf),
        block("Decoder0", "/lora/lora_decoder", cr='"4/8"', explicit="true", **sf),
        block("ChatBox1", "/widgets/chat_box"),
        block("NumericEntry0", "/widgets/numeric_entry", value=f"{noise_db:g}"),
        block("Evaluator0", "/blocks/evaluator", expr='"pow(10, db / 20.0)"',
              vars='["db"]'),
        block("FreqDemod0", "/comms/freq_demod"),
        block("WaveMonitor1", "/plotters/wave_monitor"),
        block("SnrDisplay", "/widgets/text_display"),
        block("EncoderImpl", "/lora/lora_encoder", cr='"4/5"', explicit="false",
              crc="true", **sf),
        block("ModImpl", "/lora/lora_mod", sync="SYNC", **sf),
        block("DemodImpl", "/lora/lora_demod", sync="SYNC", **sf),
        block("DecoderImpl", "/lora/lora_decoder", cr='"4/5"', explicit="false",
              dataLength="19", **sf),
        block("ChatImpl", "/widgets/chat_box"),
        wire("TestGen0", "Pacer0"), wire("TestGenOff", "Pacer0"),
        wire("Pacer0", "Encoder0"), wire("Encoder0", "Mod0"),
        wire("Mod0", "BreakTx"), wire("BreakRx", "Adder0", dk="1"),
        wire("NoiseSource1", "Adder0"), wire("Adder0", "Rotate0"),
        wire("Rotate0", "Demod0"), wire("Demod0", "Decoder0"),
        wire("Decoder0", "ChatBox1", dk="in"),
        wire("Demod0", "FreqDemod0", sk="raw"),
        wire("FreqDemod0", "WaveMonitor1"),
        wire("Adder0", "WaveMonitor1", dk="1", enabled=False),
        signal("NumericEntry0", "Evaluator0", "valueChanged", "setDb"),
        signal("Evaluator0", "NoiseSource1", "triggered", "setAmplitude"),
        signal("Demod0", "SnrDisplay", "snr", "setText"),
        wire("Pacer0", "EncoderImpl"), wire("EncoderImpl", "ModImpl"),
        wire("ModImpl", "DemodImpl"), wire("DemodImpl", "DecoderImpl"),
        wire("DecoderImpl", "ChatImpl", dk="in"),
    ]
    return {"globals": [{"name": "SF", "value": "10"}, {"name": "MTU", "value": "20"},
                        {"name": "SYNC", "value": "0x12"}],
            "pages": [{"graphObjects": objs}]}


def sim_topology(device, sf, noise_ampl, seed):
    """test_flowgraph.py's simulation graph on ``device``: test_gen ->
    pacer -> encoder (CR 4/8) -> modulator (padding 2) -> + noise (numpy
    RandomState(seed)) -> demodulator -> decoder -> chat probe, with the
    demod's snr signal on a display probe."""
    from lora_phy_tpu_torch.models import flowgraph as fg

    t = fg.Topology(device=device)
    cfg = coded.CodedConfig(sf=sf, cr=4)
    p = LoraParams(sf=sf)
    t.add(fg.make_test_gen("gen"))
    t.add(fg.make_pacer("pacer"))
    t.add(fg.make_encoder("enc", cfg))
    t.add(fg.make_modulator("mod", p, padding=2))
    noise = t.add(fg.make_noise_source("noise", ampl=noise_ampl, seed=seed))
    t.add(fg.make_arithmetic("add"))
    t.add(fg.make_demodulator("demod", p))
    t.add(fg.make_decoder("dec", cfg))
    t.add(fg.make_probe("chat"))
    t.add(fg.make_probe("snr_disp"))
    for w in (("gen", "0", "pacer", "0"), ("pacer", "0", "enc", "0"), ("enc", "0", "mod", "0"),
              ("mod", "0", "add", "1"), ("noise", "0", "add", "0"), ("add", "0", "demod", "0"),
              ("demod", "0", "dec", "0"), ("dec", "0", "chat", "in")):
        t.connect(*w)
    t.connect_signal("demod", "snr", "snr_disp", "setFloatValue")
    # the longest frame of the 16 ticks: 20-byte messages, CRC, CR 4/8
    nsym = 8 + coded.payload_symbol_count(20, cfg)
    noise.state["length"] = stream.frame_overhead_samples(p) + (nsym + 4) * p.step
    return t


def flow_summary(log):
    """(messages, dropped counts, error signals, snr signals) of a run."""
    msgs = [bytes(o["0"].cpu().numpy()) if o.get("0") is not None else None
            for o in log["dec"]]
    return (msgs, [o.get("dropped") for o in log["dec"]],
            [o.get("error") for o in log["demod"]], [o.get("snr") for o in log["demod"]])


def phase16_flowgraph(dev, card, tmp):
    """The flowgraph runtime on the card against the CPU: the simulation
    graph for FLOW_TICKS ticks at SF7 and SF12, and topology_runner on a
    written .pth file. Returns the kernel launch count."""
    from lora_phy_tpu_torch.runners import topology_runner

    torch.cuda.synchronize()
    reset_launches()
    for sf, ampl in FLOW_CASES:
        sim_topology(dev, sf, ampl, seed=sf).run(1)          # warm-up (plans, handles)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_log = sim_topology(dev, sf, ampl, seed=sf).run(FLOW_TICKS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        cpu_log = sim_topology(torch.device("cpu"), sf, ampl, seed=sf).run(FLOW_TICKS)
        (cm, cd, ce, cs), (hm, hd, he, hs) = flow_summary(card_log), flow_summary(cpu_log)
        check(cm == hm and cd == hd and ce == he, f"phase 16 SF{sf}: card {cm, cd, ce} "
              f"against CPU {hm, hd, he}")
        check(all((a is None) == (b is None) and (a is None or abs(a - b) <= 1e-2)
                  for a, b in zip(cs, hs)), f"phase 16 SF{sf}: snr {cs} against {hs}")
        n_ok = sum(m is not None for m in cm)
        check(n_ok > 0 and all(m == b"lora test message %d" % i
                               for i, m in enumerate(cm) if m is not None),
              f"phase 16 SF{sf}: messages {cm}")
        print(f"phase 16: {card}: flowgraph simulation SF{sf}, noise amplitude {ampl}, "
              f"{FLOW_TICKS} ticks: {n_ok} messages decoded, dropped {cd[-1]}, equal to the "
              f"CPU's run (messages, drops, CFO errors; snr within 1e-2 dB); "
              f"{dt / FLOW_TICKS * 1e3:.1f} ms host per tick on the card", flush=True)
    pth = tmp / "sim.pth"
    pth.write_text(json.dumps(topology_doc()))
    args = [f"--file={pth}", "--ticks=4", "--sf=7"]
    rc_c, out_c, err_c, t_c = run_main(topology_runner.main, args + [f"--device={dev}"])
    rc_h, out_h, _, _ = run_main(topology_runner.main, args + ["--device=cpu"])
    check(rc_c == rc_h == 0, f"phase 16 topology_runner: rc {rc_c} / {rc_h}: {err_c}")
    lc, lh = out_c.splitlines(), out_h.splitlines()
    check(len(lc) == len(lh) and all(
        a == b or (" snr=" in a and a.split()[0] == b.split()[0] and a.split()[2:] == b.split()[2:]
                   and abs(float(a.split()[1][4:]) - float(b.split()[1][4:])) <= 0.1 + 1e-9)
        for a, b in zip(lc, lh)), f"phase 16 topology_runner: {lc} against {lh}")
    check("ChatBox1 <- b'lora test message 3'" in out_c
          and "ChatImpl <- b'lora test message 3'" in out_c, f"phase 16: {out_c}")
    torch.cuda.synchronize()
    launches = read_launches("flowgraph")
    print(f"phase 16: {card}: topology_runner --ticks=4 on a written .pth (breaker net, disabled "
          f"block, signal wires, implicit decoder with dataLength): {lc[0]}; its lines equal "
          f"--device=cpu's; {t_c:.2f} s on the card; fused_demod launches {launches}",
          flush=True)
    return {"flowgraph": launches}


# ---------------------------------------------------------------------------
# Phase 17: the time-sharded mesh receivers, shards sharing the card
# ---------------------------------------------------------------------------

def mesh_of(dev, n_c, n_t):
    from lora_phy_tpu_torch.parallel import mesh as meshlib

    return meshlib.make_mesh(n_c, n_t, devices=[dev] * (n_c * n_t))


def same_mesh_frames(blk, ref, label):
    """The mesh's found frames equal the single-device receiver's: the same
    (channel, start) set, symbols and sync exact, cfo within 1e-5 bins,
    snr_db 1e-2 dB, sro_ppm 0.05 ppm. Returns the count."""
    def rows(b):
        f = b.found.cpu()
        ch, k = torch.nonzero(f, as_tuple=True)
        key = torch.stack([ch.to(torch.int64), b.start.cpu()[ch, k].to(torch.int64)], 1)
        vals = {n: getattr(b, n).cpu()[ch, k] for n in ("symbols", "sync", "cfo_bins", "cfo",
                                                        "snr_db", "sro_ppm")}
        order = torch.argsort(key[:, 0] * (1 << 40) + key[:, 1])
        return key[order], {n: v[order] for n, v in vals.items()}

    (ka, va), (kb, vb) = rows(blk), rows(ref)
    check(torch.equal(ka, kb), f"{label}: {len(ka)} frames against {len(kb)}, or other starts")
    for n in ("symbols", "sync", "cfo_bins"):
        check(torch.equal(va[n].to(torch.int64), vb[n].to(torch.int64)), f"{label}: {n} differ")
    for n, tol in (("cfo", 1e-5), ("snr_db", 1e-2), ("sro_ppm", 0.05)):
        err = float((va[n] - vb[n]).abs().max()) if len(ka) else 0.0
        check(err <= tol, f"{label}: {n} differs by {err}")
    return len(ka)


def phase17_mesh(dev, card, tmp, cli_truth, cli_out):
    """The mesh receivers on meshes of shards sharing the card; returns the
    kernel launch counts of each path."""
    from lora_phy_tpu_torch.parallel import stream as pstream

    launches = {}

    def counted(name, fn):
        torch.cuda.synchronize()
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = launches.get(name, 0) + read_launches(name)
        return out

    # (a) the streaming demod at the main path's width: each channel's
    # 8192 frames end to end as one dechirped stream
    p = LoraParams(sf=7)
    pool = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (POOL, PAYLOAD_LEN)).astype(np.uint8)).to(dev)
    full = pool.repeat(CHANNELS * MESH_FRAMES // POOL, 1).reshape(CHANNELS, MESH_FRAMES,
                                                                  PAYLOAD_LEN)
    re, im = planar.modulate_planar(modem.encode(full), p)
    xr, xi = planar.dechirp_planar(re, im, p)
    del re, im
    xr, xi = xr.reshape(CHANNELS, -1), xi.reshape(CHANNELS, -1)
    total = xr.numel()
    first = None
    for layout in MESH_LAYOUTS:
        m = mesh_of(dev, *layout)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        syms, sync_w, _, _ = counted("mesh_demod", lambda: pstream.demodulate_stream_planar(
            xr, xi, p, m))
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        frames = syms.reshape(CHANNELS, MESH_FRAMES, 2 * PAYLOAD_LEN + 2)
        check(torch.equal(modem.decode(frames[..., 2:]), full),
              f"phase 17 (a) {layout}: decoded payloads differ")
        check(bool((sync_w == 0x12).all()), f"phase 17 (a) {layout}: sync {sync_w.tolist()}")
        if first is None:
            first = syms
        check(torch.equal(syms, first), f"phase 17 (a) {layout}: symbols differ across meshes")
        t_full = cuda_ms(lambda: pstream.demodulate_stream_planar(xr, xi, p, m))
        t_stub = cuda_ms(lambda: pstream.demodulate_stream_planar(xr, xi, p, m, comm=False))
        print(f"phase 17 (a): {card}: demodulate_stream_planar on mesh {layout[0]}x{layout[1]} "
              f"(shards share cuda:0) over {CHANNELS} x {xr.shape[-1]} samples "
              f"({total / 1e6:.1f} M): {CHANNELS * MESH_FRAMES} payloads bit-exact, symbols equal "
              f"across meshes; comm=True {t_full:.3f} ms ({total / t_full / 1e6:.3f} "
              f"Gsamples/s), comm=False {t_stub:.3f} ms; peak memory above its inputs "
              f"{peak:.2f} GiB", flush=True)
    del xr, xi, first, syms, frames, full
    torch.cuda.empty_cache()

    # (b) the sharded block receiver over phase 5's stream
    xr, xi, pay, period = block_stream(dev, p, CHANNELS, BLOCK_FRAMES)
    n_pay = 2 * BLOCK_PAYLOAD
    ref = sync.receive_block_planar(xr, xi, p, n_pay, max_frames=BLOCK_FRAMES,
                                    min_power_db=-30.0)
    for layout in MESH_LAYOUTS:
        m = mesh_of(dev, *layout)
        k = BLOCK_FRAMES // layout[1] + 2

        def run():
            return pstream.receive_stream_block_planar(xr, xi, p, n_pay, m, max_frames=k,
                                                       min_power_db=-30.0)

        blk = counted("mesh_block", run)
        n = same_mesh_frames(blk, ref, f"phase 17 (b) {layout}")
        t = cuda_ms(run, iters=5)
        print(f"phase 17 (b): {card}: receive_stream_block_planar on mesh "
              f"{layout[0]}x{layout[1]}, {k} slots per shard, over phase 5's {CHANNELS} x "
              f"{xr.shape[-1]} samples: {n} frames, the single-device receiver's (starts, "
              f"symbols, sync exact; floats within tolerance); {t:.3f} ms "
              f"({xr.numel() / t / 1e6:.3f} Gsamples/s)", flush=True)
        profile_once(run, f"phase 17 (b): {card}: receive_stream_block_planar "
                          f"{layout[0]}x{layout[1]}", calls=3)

    # (d) the soft spectra on the mesh against the single device
    m = mesh_of(dev, 2, 4)
    blk, spec = counted("mesh_soft", lambda: pstream.receive_stream_block_planar(
        xr, xi, p, n_pay, m, max_frames=BLOCK_FRAMES // 4 + 2, min_power_db=-30.0,
        with_spectra=True))
    rblk, rspec = sync.receive_block_planar(xr, xi, p, n_pay, max_frames=BLOCK_FRAMES,
                                            min_power_db=-30.0, with_spectra=True)
    same_mesh_frames(blk, rblk, "phase 17 (d) soft")
    ms, rs = spec[blk.found], rspec[rblk.found]       # both in (channel, start) order
    rel = float(((ms - rs).abs().amax(dim=-1) / rs.amax(dim=-1)).max())
    check(rel <= 2e-5, f"phase 17 (d): mesh spectra differ by {rel} of the peak")
    soft_bytes = soft.hamming84_ml_decode(ms, scale=1)
    check(bool((soft_bytes == pay.repeat_interleave(rblk.found.sum(-1), 0)).all()),
          "phase 17 (d): ML decode of the mesh spectra")
    print(f"phase 17 (d): with_spectra on mesh 2x4: {ms.shape[0]} frames' spectra within "
          f"{rel:.3g} of the peak of the single device's (bound 2e-5), Hamming84 ML bytes "
          f"exact", flush=True)
    del xr, xi, ref, blk, spec, rblk, rspec, ms, rs
    torch.cuda.empty_cache()

    # (c) rx_stream --mesh over phase 14's 4096-frame file
    from lora_phy_tpu_torch.runners import rx_stream

    path = tmp / "stream_cf32.iq"
    args = [f"--in={path}", "--payload-len=16", f"--block={CLI_BLOCK}",
            f"--max-frames={CLI_MAX_FRAMES}"]
    torch.cuda.synchronize()
    reset_launches()
    rc, out, err, t_rx = run_main(rx_stream.main, args + ["--mesh=1", f"--device={dev}"])
    torch.cuda.synchronize()
    launches["mesh_cli"] = read_launches("mesh_cli")
    check(rc == 0, f"phase 17 (c) --mesh=1: rc {rc}: {err}")
    check_cli_frames(out, err, cli_truth, "phase 17 (c) --mesh=1")
    same_lines(out, cli_out, "phase 17 (c) --mesh=1 against rx_stream")
    n_blocks = -(-path.stat().st_size // 8 // CLI_BLOCK)
    print(f"phase 17 (c): {card}: rx_stream --mesh=1 over the {len(cli_truth)}-frame file: "
          f"every frame once at its true start with its bytes, the lines of plain rx_stream; "
          f"{t_rx:.2f} s wall, {len(cli_truth) / t_rx:.0f} frames/s, "
          f"{t_rx / n_blocks * 1e3:.2f} ms host per block", flush=True)
    n_cards = torch.cuda.device_count()
    rc, out, err, _ = run_main(rx_stream.main, args + [f"--mesh={n_cards + 1}",
                                                       f"--device={dev}"])
    check(rc == 1 and out == "" and f"--mesh={n_cards + 1} exceeds {n_cards} devices" in err,
          f"phase 17 (c): --mesh={n_cards + 1}: rc {rc}, {err!r}")
    raw = path.read_bytes()[: (cli_truth[CLI_SMALL_FRAMES][0]) * 8]
    cut = (cli_truth[CLI_SMALL_FRAMES // 2][0] + 400) * 8          # inside a frame
    (tmp / "ma.iq").write_bytes(raw[:cut])
    (tmp / "mb.iq").write_bytes(raw[cut:])
    margs = ["--payload-len=16", "--mesh=1"]
    ck_card, ck_cpu = tmp / "mesh_card.ck", tmp / "mesh_cpu.ck"
    rc_a, _, _, _ = run_main(rx_stream.main, [f"--in={tmp / 'ma.iq'}", f"--checkpoint={ck_card}"]
                             + margs + [f"--device={dev}"])
    ck_cpu.write_bytes(ck_card.read_bytes())
    rc_b, out_b, _, _ = run_main(rx_stream.main, [f"--in={tmp / 'mb.iq'}",
                                                  f"--checkpoint={ck_card}"] + margs
                                 + [f"--device={dev}"])
    rc_c, out_c, _, _ = run_main(rx_stream.main, [f"--in={tmp / 'mb.iq'}",
                                                  f"--checkpoint={ck_cpu}"] + margs
                                 + ["--device=cpu"])
    check(rc_a == rc_b == rc_c == 0 and out_b.strip(), "phase 17 (c) checkpoint: a run failed")
    same_lines(out_c, out_b, "phase 17 (c) mesh checkpoint card -> CPU")
    print(f"phase 17 (c): rx_stream --mesh=2 on {n_cards} card(s) exits 1 with the 'exceeds' "
          f"line; a mesh checkpoint written mid-frame on the card resumes on --device=cpu with "
          f"the card's own {len(out_b.splitlines())} remaining lines", flush=True)

    # (d) the blind and adaptive mesh receivers
    br, bi, truth = blind_stream(dev, BLOCK_PAYLOAD, seed=12)
    pad = (-br.numel()) % (2 * LoraParams(sf=12).step)
    br = torch.cat([br, br.new_zeros(pad)])[None]
    bi = torch.cat([bi, bi.new_zeros(pad)])[None]
    res = counted("mesh_blind", lambda: pstream.receive_blind_stream_planar(
        br, bi, p, n_pay, mesh_of(dev, 1, 2)))
    rows = sync.blind_frames(res)
    ref_rows = sync.blind_frames(sync.receive_blind_planar(br, bi, p, n_pay))

    def key(rs):
        return [(r["sf"], r["start"], r["sync"], tuple(r["symbols"].tolist())) for r in rs]

    check(key(rows) == key(ref_rows) and sorted((r["sf"], r["start"]) for r in rows)
          == sorted((sf, st) for sf, st, _ in truth), f"phase 17 (d) blind: {key(rows)[:6]}")
    print(f"phase 17 (d): receive_blind_stream_planar on mesh 1x2 over {br.numel()} samples: "
          f"the six frames (SF7-12) at their SF and start, rows equal to receive_blind_planar's",
          flush=True)
    sig, gtruth = gateway_stream(dev, p, GATEWAY_FRAMES, 255, seed=9)
    # pass 2 runs at the longest decoded length and defers a frame whose
    # extent at that length overruns the buffer to the next block (the
    # JAX twin's contract): the last call of a stream ends in one longest
    # frame of silence
    longest = stream.frame_overhead_samples(p) + (8 + coded.payload_symbol_count(
        255, coded.CodedConfig(sf=7, cr=4))) * p.step
    pad = longest + (-(sig.numel() + longest)) % (2 * p.step)
    sig = torch.cat([sig, sig.new_zeros(pad)])[None]
    t0 = time.perf_counter()
    res = counted("mesh_adaptive", lambda: pstream.receive_adaptive_stream_planar(
        sig.real.contiguous(), sig.imag.contiguous(), p, mesh_of(dev, 1, 2),
        max_frames=GATEWAY_FRAMES))
    dt = time.perf_counter() - t0
    got = [(r["start"], r["payload"]) for r in res]
    check(got == [(st, b) for st, b, _, _ in gtruth] and all(r["info"]["crc_ok"] for r in res),
          f"phase 17 (d) adaptive: {len(got)} frames of {len(gtruth)}")
    print(f"phase 17 (d): {card}: receive_adaptive_stream_planar on mesh 1x2 over phase 9's "
          f"{sig.shape[-1]}-sample gateway stream: all {len(res)} frames crc_ok with their "
          f"bytes at their starts; {dt:.2f} s host clock", flush=True)
    del sig, br, bi
    torch.cuda.empty_cache()

    # (e) across processes: two gloo ranks x two time shards on the card,
    # and one NCCL rank at world size 1
    import socket

    def free_port():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    env = dict(os.environ, PYTHONPATH=str(REPO))
    gloo_addr, nccl_addr = f"localhost:{free_port()}", f"localhost:{free_port()}"
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--mesh-worker",
                               str(r), str(n), addr, backend],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r, n, addr, backend in ((0, 2, gloo_addr, "gloo"), (1, 2, gloo_addr, "gloo"),
                                         (0, 1, nccl_addr, "nccl"))]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=300))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, (out, err) in zip(procs, outs):
        check(proc.returncode == 0 and "MESH WORKER OK" in out,
              f"phase 17 (e): worker rc {proc.returncode}: {err[-2000:]}")
        for line in out.splitlines():
            print(f"phase 17 (e): {card}: {line}", flush=True)
    launches["mesh_multiprocess"] = sum(
        int(line.split("launches=")[1].split()[0]) for out, _ in outs
        for line in out.splitlines() if "launches=" in line)
    BF16_BY_PATH["mesh_multiprocess"] = sum(
        int(line.split("bf16_launches=")[1].split()[0]) for out, _ in outs
        for line in out.splitlines() if "bf16_launches=" in line)

    # (f) bench_scaling on the visible cards
    from lora_phy_tpu_torch.runners import bench_scaling

    torch.cuda.synchronize()
    reset_launches()
    rc, out, err, t_b = run_main(bench_scaling.main, ["--devices=1", f"--frames={SCALING_FRAMES}",
                                                      f"--device={dev}"])
    torch.cuda.synchronize()
    launches["bench_scaling"] = read_launches("bench_scaling")
    check(rc == 0, f"phase 17 (f) bench_scaling: rc {rc}: {err}")
    doc = json.loads(out)
    row = doc["rows"][0]
    check(row["devices"] == 1 and "below_noise" in row and doc["platform"] == "gpu",
          f"phase 17 (f): {doc}")
    print(f"phase 17 (f): {card}: bench_scaling --devices=1 --frames={SCALING_FRAMES}: "
          f"{json.dumps(row)} ({t_b:.1f} s)", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 18: the last slice of runners on the card
# ---------------------------------------------------------------------------

VECTOR_DECISION_FILES = ("payload.bin", "pre_interleave.csv", "post_interleave.csv",
                         "demod_symbols.csv", "deinterleave.csv", "decoded.bin")
# an IQ CSV that is not hash-equal is held by its values: the trig-path TX
# tolerance 5e-7 (plus the injectors' 1e-6 for the impaired file) and one
# printed digit at %g (1e-6 for a value below 1)
IQ_CSV_TOL = 5e-7 + 1e-6
OFFSET_CSV_TOL = 5e-7 + 1e-6 + 1e-6


def counted(fn, path):
    """``fn()`` with the kernel counters set to 0 just before it and read
    just after (as ``path``): (its result, the fused_demod launches, host
    seconds)."""
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, read_launches(path), time.perf_counter() - t0


def same_iq_csv(a, b, tol, label):
    """Two IQ CSVs: hash-equal, or equal in shape and within ``tol``;
    returns a note for the output."""
    from lora_phy_tpu_torch.utils.manifest import sha256_file

    if sha256_file(a) == sha256_file(b):
        return f"{a.name} hash-equal"
    x, y = (np.loadtxt(f, delimiter=",", dtype=np.float64, ndmin=2) for f in (a, b))
    check(x.shape == y.shape, f"{label}: {a.name} has {x.shape} against {y.shape}")
    err = float(np.abs(x - y).max())
    check(err <= tol, f"{label}: {a.name} differs by {err} > {tol}")
    return (f"{a.name} {int((x != y).any(axis=1).sum())} of {len(x)} lines differ, "
            f"max {err:.3g}")


def phase18a_vectors(dev, card, tmp):
    """vector_generate card vs CPU over VECTOR_CELLS, the comprehensive
    corpus card vs CPU, vector_dump and compare_vectors as CLIs; returns the
    kernel launch counts."""
    import shutil

    from lora_phy_tpu_torch.runners import (compare_vectors, comprehensive_vector_generate,
                                            vector_dump, vector_generate)
    from lora_phy_tpu_torch.utils.manifest import compare_dirs, sha256_file

    launches = {"vector_generate": 0}
    for k, (sf, osr, window, cfo, shift) in enumerate(VECTOR_CELLS):
        p = LoraParams(sf=sf, osr=osr, window=window)
        kw = dict(seed=k + 1, byte_count=VECTOR_BYTES, cfo_bins=cfo, time_offset=shift,
                  b64=False)
        label = f"phase 18 (a) SF{sf} osr {osr} {window.name} cfo {cfo:g} shift {shift:g}"
        on_card, n, t_card = counted(
            lambda: vector_generate.generate(tmp / "vg_card", p, device=dev, **kw),
            "vector_generate")
        launches["vector_generate"] += n
        t0 = time.perf_counter()
        on_cpu = vector_generate.generate(tmp / "vg_cpu", p, device="cpu", **kw)
        t_cpu = time.perf_counter() - t0
        names = sorted(f.name for f in on_card.iterdir())
        check(names == sorted(f.name for f in on_cpu.iterdir()), f"{label}: files {names}")
        for name in VECTOR_DECISION_FILES:
            check(sha256_file(on_card / name) == sha256_file(on_cpu / name),
                  f"{label}: {name} differs between the card and the CPU")
        notes = [same_iq_csv(on_card / name, on_cpu / name, tol, label)
                 for name, tol in (("iq_samples.csv", IQ_CSV_TOL),
                                   ("iq_samples_offset.csv", OFFSET_CSV_TOL))
                 if name in names]
        print(f"{label}: {card}: vector_generate, {VECTOR_BYTES}-byte payload, "
              f"{t_card:.2f} s with the chain on the card, {t_cpu:.2f} s on the CPU (host "
              f"clock, CSV writing included); decision files hash-equal; "
              f"{'; '.join(notes)}", flush=True)
        shutil.rmtree(on_card)
        shutil.rmtree(on_cpu)

    dev_flag = f"--device={dev}"
    (rc, _, err, _), n, t_cv = counted(lambda: run_main(
        comprehensive_vector_generate.main, [f"--out={tmp / 'cv_card'}", dev_flag]),
        "comprehensive_vectors")
    launches["comprehensive_vectors"] = n
    rc_h, _, err_h, t_h = run_main(comprehensive_vector_generate.main,
                                   [f"--out={tmp / 'cv_cpu'}", "--device=cpu"])
    check(rc == rc_h == 0, f"phase 18 (a) comprehensive: rc {rc} / {rc_h}: {err}{err_h}")
    diff = compare_dirs(tmp / "cv_card", tmp / "cv_cpu")
    check(diff == [], f"phase 18 (a) comprehensive: {diff}")
    print(f"phase 18 (a): {card}: comprehensive_vector_generate (144 Hamming records, 30 "
          f"modulation records at SF7-12): {t_cv:.2f} s, the CPU {t_h:.2f} s; both files "
          f"hash-equal", flush=True)

    dump = ["--sf=9", f"--bytes={VECTOR_BYTES}"]
    (rc, _, err, _), n, t_d = counted(lambda: run_main(
        vector_dump.main, dump + [f"--out={tmp / 'dump_card'}", dev_flag]), "vector_dump")
    launches["vector_dump"] = n
    rc_h = run_main(vector_dump.main, dump + [f"--out={tmp / 'dump_cpu'}", "--device=cpu"])[0]
    rc_s = run_main(vector_dump.main, dump + ["--seed=2", f"--out={tmp / 'dump_seed2'}",
                                              dev_flag])[0]
    rc_eq, _, err_eq, _ = run_main(compare_vectors.main,
                                   [str(tmp / "dump_card"), str(tmp / "dump_cpu")])
    rc_ne, _, err_ne, _ = run_main(compare_vectors.main,
                                   [str(tmp / "dump_card"), str(tmp / "dump_seed2")])
    check(rc == rc_h == rc_s == 0, f"phase 18 (a) vector_dump: rc {rc} / {rc_h} / {rc_s}: {err}")
    check(rc_eq == 0 and rc_ne == 1, f"phase 18 (a) compare_vectors: rc {rc_eq} "
          f"({err_eq.strip()}) / {rc_ne} ({err_ne.strip()[-200:]})")
    print(f"phase 18 (a): {card}: vector_dump --sf=9 --bytes={VECTOR_BYTES} (all stages) "
          f"{t_d:.2f} s; compare_vectors: the card's dump against the CPU's exit 0, against "
          f"another seed's exit 1", flush=True)
    return launches


def phase18b_perf(dev, card, tmp):
    """perf_test over its default profiles and the perf matrix, compare_perf
    on each CSV; returns the kernel launch count."""
    from lora_phy_tpu_torch.runners import compare_perf, perf_test

    launches = 0
    out_dir = tmp / "perf"
    saved = os.environ.get("RUN_ID")
    for run_id, extra in (("chip_default", []),
                          ("chip_matrix", [f"--profiles={REPO / 'profiles' / 'perf_matrix.yaml'}"])):
        os.environ["RUN_ID"] = run_id
        (rc, _, err, _), n, t = counted(lambda: run_main(perf_test.main, [
            f"--packets={PERF_PACKETS}", f"--out-dir={out_dir}", f"--device={dev}"] + extra),
            "perf_test")
        launches += n
        path = out_dir / f"performance_{run_id}.csv"
        check(rc == 0 and path.exists(), f"phase 18 (b) perf_test {run_id}: rc {rc}: {err}")
        lines = path.read_text().splitlines()
        check(lines[0] == "run_id,profile,sf,N,pps,us_per_symbol" and len(lines) == 4,
              f"phase 18 (b) perf_test {run_id}: {lines}")
        print(f"phase 18 (b): {card}: perf_test --packets={PERF_PACKETS} "
              f"{extra[0] if extra else '(default profiles)'}: {t:.1f} s host; rows:", flush=True)
        for row in lines[1:]:
            print(f"phase 18 (b): {card}:   {row}", flush=True)
        rows = [line.split(",") for line in lines]
        rows[1][4] = f"{float(rows[1][4]) / 2:.3f}"
        halved = out_dir / f"halved_{run_id}.csv"
        halved.write_text("\n".join(",".join(r) for r in rows) + "\n")
        rc_same = run_main(compare_perf.main, [str(path), str(path)])[0]
        rc_half, _, err_half, _ = run_main(compare_perf.main, [str(path), str(halved)])
        check(rc_same == 0 and rc_half == 1,
              f"phase 18 (b) compare_perf {run_id}: rc {rc_same} / {rc_half}: {err_half}")
        print(f"phase 18 (b): compare_perf of {path.name} against itself exit 0, against a "
              f"copy with {rows[1][1]}'s pps halved exit 1 ({err_half.splitlines()[0]})",
              flush=True)
    if saved is None:
        del os.environ["RUN_ID"]
    else:
        os.environ["RUN_ID"] = saved
    return launches


def phase18_last_slice(dev, card, tmp):
    """Phase 18 (a)-(f); returns the kernel launch count of each path."""
    import importlib.util

    from lora_phy_tpu_torch import runtime
    from lora_phy_tpu_torch.runners import roofline, scope, sic_sweep
    from lora_phy_tpu_torch.utils import profiling

    dev_flag = f"--device={dev}"
    launches = phase18a_vectors(dev, card, tmp)
    launches["perf_test"] = phase18b_perf(dev, card, tmp)
    torch.cuda.empty_cache()

    # (c) roofline at its defaults
    (rc, out, err, _), n, t = counted(lambda: run_main(roofline.main, [dev_flag]), "roofline")
    launches["roofline"] = n
    lines = out.splitlines()
    check(rc == 0 and len(lines) == 4 and lines[0].startswith("dispatch overhead: ")
          and lines[1].startswith("effective bandwidth") and lines[2].startswith("SF7:")
          and lines[3].startswith("SF12:"), f"phase 18 (c) roofline: rc {rc}: {out}{err}")
    for line in err.strip().splitlines() + lines:
        print(f"phase 18 (c): {card}: roofline: {line}", flush=True)
    print(f"phase 18 (c): roofline at its defaults (8 x 8192 SF7 frames, 1 x 1024 SF12): "
          f"{t:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # (d) sic_sweep over its default gaps, cut to SWEEP_TRIALS trials per gap
    (rc, out, err, _), n, t = counted(lambda: run_main(
        sic_sweep.main, [f"--trials={SWEEP_TRIALS}", dev_flag]), "sic_sweep")
    launches["sic_sweep"] = n
    lines = out.splitlines()
    check(rc == 0 and lines[0] == sic_sweep.HEADER and len(lines) == 6,
          f"phase 18 (d) sic_sweep: rc {rc}: {out}{err}")
    for row in lines[1:]:
        gap, trials, wp, ws, ss = row.split(",")[:5]
        check(int(trials) == SWEEP_TRIALS and int(ws) >= int(wp) and int(ss) == SWEEP_TRIALS,
              f"phase 18 (d) sic_sweep gap {gap}: {row}")
    print(f"phase 18 (d): {card}: sic_sweep --trials={SWEEP_TRIALS} (a cut from its default "
          f"40, for time) over gaps 3-15 dB at 20 dB SNR: {t:.1f} s host, "
          f"{t / (5 * SWEEP_TRIALS) * 1e3:.0f} ms per trial (one plain pass and SIC); SIC "
          f"recovers the weak frame at least as often as the plain pass at every gap, the "
          f"strong frame every time:", flush=True)
    for row in lines:
        print(f"phase 18 (d):   {row}", flush=True)

    # (e) scope over phase 14's cf32 file: the card's panels and rows against
    # the CPU's, then the PNG
    path = tmp / "stream_cf32.iq"
    re, im = runtime.to_planar(np.fromfile(path, np.float32)[: 2 * (1 << 21)])
    p = LoraParams(sf=7)
    (st, up, rows), n, t = counted(lambda: scope.panels(
        torch.from_numpy(re).to(dev), torch.from_numpy(im).to(dev), p, CLI_PAYLOAD), "scope")
    launches["scope"] = n
    hst, hup, hrows = scope.panels(torch.from_numpy(re), torch.from_numpy(im), p, CLI_PAYLOAD)
    errs = [float((got.cpu() - ref).abs().max() / ref.max()) for got, ref in
            ((st, hst), (up, hup))]
    check(max(errs) <= 1e-5, f"phase 18 (e) scope: panels differ by {errs} of the peak")
    check(len(rows) == len(hrows) == 16, f"phase 18 (e) scope: {len(rows)} / {len(hrows)} rows")
    for r, h in zip(rows, hrows):
        check((r["start"], r["cfo_bins"], r["sync"]) == (h["start"], h["cfo_bins"], h["sync"])
              and torch.equal(r["symbols"].cpu(), h["symbols"])
              and abs(r["cfo"] - h["cfo"]) <= 1e-6 and abs(r["snr_db"] - h["snr_db"]) <= 1e-2
              and abs(r["sro_ppm"] - h["sro_ppm"]) <= 0.05,
              f"phase 18 (e) scope: row {r['k']} at {r['start']} differs from the CPU's")
    print(f"phase 18 (e): {card}: scope.panels over {re.size} samples of phase 14's file "
          f"({re.size // p.step} windows): {t * 1e3:.1f} ms host; STFT and up-dechirped panels "
          f"within {max(errs):.3g} of the CPU's peak, {len(rows)} rows equal to the CPU's",
          flush=True)
    png = tmp / "scope.png"
    args = [f"--in={path}", f"--payload-len={CLI_PAYLOAD}", f"--out={png}", dev_flag]
    rc, _, err, t = run_main(scope.main, args)
    if importlib.util.find_spec("matplotlib") is not None:
        check(rc == 0 and png.stat().st_size > 10000 and f"({len(rows)} frames annotated)" in err,
              f"phase 18 (e) scope: rc {rc}: {err}")
        print(f"phase 18 (e): {card}: scope wrote a {png.stat().st_size}-byte PNG in {t:.1f} s: "
              f"{err.strip()}", flush=True)
    else:
        check(rc == 1 and not png.exists() and "matplotlib" in err,
              f"phase 18 (e) scope without matplotlib: rc {rc}: {err}")
        print("scope: PNG not rendered: no matplotlib on this machine", flush=True)
        print(f"phase 18 (e): scope's CLI without matplotlib: exit 1, {err.strip()!r}", flush=True)

    # (f) utils.profiling.trace around one demodulate_planar call
    pay = torch.from_numpy(np.random.RandomState(18).randint(
        0, 256, (CHANNELS, BLOCK_FRAMES, PAYLOAD_LEN)).astype(np.uint8)).to(dev)
    xr, xi = planar.dechirp_planar(*planar.modulate_planar(modem.encode(pay), p), p)
    torch.cuda.synchronize()
    reset_launches()
    with profiling.trace(tmp / "trace") as log_dir:
        res = planar.demodulate_planar(xr, xi, p)
    launches["trace"] = read_launches("trace")
    check(torch.equal(modem.decode(res.symbols), pay), "phase 18 (f): decoded payloads differ")
    events = json.loads((log_dir / "trace.json").read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    check(kernels, "phase 18 (f): the trace names no CUDA kernel")
    print(f"phase 18 (f): {card}: profiling.trace around demodulate_planar over "
          f"{CHANNELS} x {BLOCK_FRAMES} frames: trace.json with {len(events)} events, "
          f"{len(kernels)} CUDA kernels, e.g. {sorted(set(kernels))[:3]}", flush=True)

    check(not any(launches.values()), f"phase 18: fused_demod launched on {launches}")
    print(f"phase 18: fused_demod launches on each path: {launches} (none of these paths "
          f"calls demodulate_planar(fused=True), as in JAX)", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 19: the bf16 decision kernel
# ---------------------------------------------------------------------------

def bf16_top2_gap(yr, yi, n, cr, si, rows_per_rot):
    """Relative gap between the plain version's two largest |.|^2 per row."""
    fr, fi = bf16._derotate(yr, yi, n, cr, si, rows_per_rot)
    top2 = planar.dft_mag2_planar(fr, fi, n, mxu_dtype=torch.bfloat16).topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]) / top2[:, 0]


def bf16_tone_rows(gen, p, frames, windows, dev):
    """Clean tones [frames*windows, N], a random bin per window, with a
    random per-frame CFO (within half a bin) and amplitude (1-8), and the
    per-frame rotation planes (with the window) that take both out."""
    n = p.n
    bins = gen.randint(0, n, (frames, windows))
    cfo = gen.uniform(-0.5, 0.5, frames)
    gain = gen.uniform(1.0, 8.0, frames)
    ph = 2 * np.pi * (bins[..., None] + cfo[:, None, None]) * np.arange(n) / n
    y = (gain[:, None, None] * np.exp(1j * ph)).reshape(-1, n)
    rate = torch.from_numpy((-2 * np.pi * cfo / n).astype(np.float32)).to(dev)
    scale = torch.from_numpy((1.0 / gain).astype(np.float32)).to(dev)
    cr, si = planar._rotation_planes(rate, scale, p)
    return (torch.from_numpy(y.real.astype(np.float32)).to(dev),
            torch.from_numpy(y.imag.astype(np.float32)).to(dev),
            cr.contiguous(), si.contiguous(), bins.reshape(-1))


def bf16_compare(label, yr, yi, n, rot, rows_per_rot, clean):
    """The kernel against its plain version on the same rows: equal bins
    (clean rows), or equal outside bf16.near_tie (noise rows); peaks within
    bf16.near_tie relative. Returns (differing, excluded, max peak error)."""
    k, kp = bf16.bf16_decide_rows(yr, yi, n, *rot, rows_per_rot=rows_per_rot, with_peak=True)
    r, rp = bf16.bf16_decide_rows_reference(yr, yi, n, *rot, rows_per_rot=rows_per_rot,
                                            with_peak=True)
    differ = (k != r).nonzero().flatten()
    excluded = 0
    if clean:
        check(differ.numel() == 0, f"{label}: {differ.numel()} clean rows differ")
    elif differ.numel():
        args = [t[differ] if t is not None else None for t in (yr, yi)]
        rot_d = rot
        if rot[0] is not None:
            rot_d = (rot[0][differ // rows_per_rot], rot[1][differ // rows_per_rot])
        gap = bf16_top2_gap(*args, n, *rot_d, 1)
        excluded = int((gap <= bf16.near_tie(n)).sum())
        check(excluded == differ.numel(),
              f"{label}: {differ.numel() - excluded} rows differ beyond a "
              f"{bf16.near_tie(n):g} near-tie (gaps {gap.tolist()[:8]})")
    peak_err = float(((kp - rp).abs() / rp.clamp_min(1e-30)).max())
    check(peak_err <= bf16.near_tie(n),
          f"{label}: peak |.|^2 {peak_err:.3g} relative from the plain version")
    return differ.numel(), excluded, peak_err


def phase19a_kernel_vs_plain(dev):
    """The kernel against its plain version at every SF, with and without
    the window and the rotation: clean tones equal, noise rows equal
    outside a near-tie, crafted ties to the lowest natural bin."""
    gen = np.random.RandomState(19)
    for sf in range(2, 13):
        for window in (Window.NONE, Window.HANN):
            p = LoraParams(sf=sf, window=window)
            n = p.n
            yr, yi, cr, si, bins = bf16_tone_rows(gen, p, BF16_TONE_FRAMES, BF16_WINDOWS, dev)
            bf16_compare(f"phase 19 (a) SF{sf} {window.name} tones", yr, yi, n, (cr, si),
                         BF16_WINDOWS, clean=True)
            k = bf16.bf16_decide_rows(yr, yi, n, cr, si, rows_per_rot=BF16_WINDOWS)
            check(np.array_equal(k.cpu().numpy(), bins), f"phase 19 (a) SF{sf} "
                  f"{window.name}: tones decided at the wrong bin")
            # the same tones without their CFO, without rotation
            ph = 2 * np.pi * bins[:, None] * np.arange(n) / n
            tr = torch.from_numpy(np.cos(ph).astype(np.float32)).to(dev)
            ti = torch.from_numpy(np.sin(ph).astype(np.float32)).to(dev)
            bf16_compare(f"phase 19 (a) SF{sf} tones, no rotation", tr, ti, n, (None, None), 1,
                         clean=True)
            # noise rows, with and without rotation
            b = BF16_NOISE_FRAMES * BF16_WINDOWS
            nr = torch.from_numpy(gen.randn(b, n).astype(np.float32)).to(dev)
            ni = torch.from_numpy(gen.randn(b, n).astype(np.float32)).to(dev)
            rate = uniform_rows(gen, BF16_NOISE_FRAMES, -0.5, 0.5, dev) * (2 * np.pi / n)
            scale = uniform_rows(gen, BF16_NOISE_FRAMES, 0.2, 1.0, dev)
            rot = tuple(t.contiguous() for t in planar._rotation_planes(rate, scale, p))
            stats = [bf16_compare(f"phase 19 (a) SF{sf} {window.name} noise{tag}", nr, ni, n,
                                  r, BF16_WINDOWS, clean=False)
                     for tag, r in ((" rotated", rot), ("", (None, None)))]
            print(f"phase 19 (a): SF{sf} window={window.name} ({bf16.design(n)}): "
                  f"{bins.size} clean tone rows "
                  f"equal, rotated and not, at their bins; {b} noise rows rotated / not: "
                  f"{stats[0][0]} / {stats[1][0]} differ, {stats[0][1]} / {stats[1][1]} "
                  f"excluded as near-ties (top-2 within {bf16.near_tie(n):g}); peaks within "
                  f"{max(st[2] for st in stats):.3g} relative", flush=True)
        # crafted ties (no rotation): delta(0) - delta(N/2) ties every odd
        # bin exactly (bin 1); at N <= 128 the alternating impulse ties bins
        # 0 and N/2 (bin 0)
        ties = torch.zeros(2, n, device=dev)
        ties[:, 0], ties[0, n // 2] = 1.0, -1.0
        want = [1, 0]
        if n <= 128:
            ties[1, ::2] = 1.0
        else:
            ties, want = ties[:1], want[:1]
        z = torch.zeros_like(ties)
        k = bf16.bf16_decide_rows(ties, z, n)
        r = bf16.bf16_decide_rows_reference(ties, z, n)
        check(k.tolist() == want and r.tolist() == want,
              f"phase 19 (a) SF{sf}: tie rows gave {k.tolist()} (plain {r.tolist()}), want {want}")
    print("phase 19 (a): tie rows -> the lowest natural bin at every SF (odd-bin tie -> 1; "
          "alternating impulse -> 0 at N <= 128)", flush=True)


def bf16_bound(rows, frames, n):
    """(bound ms, by, flop, bytes) of one bf16 decision call: the rows and
    rotation planes read once, the bins written once; the dense products
    of the bf16 function, 8 N^2 flop a row (N <= 128) or 8 N (n1 + n2) in
    the four-step, at the bf16 tensor-core peak."""
    from lora_phy_tpu_torch.ops.fft import _split
    from lora_phy_tpu_torch.utils.profiling import H100_BF16_FLOPS

    if n <= 128:
        flops = rows * 8 * n * n
    else:
        n1, n2 = _split(n)
        flops = rows * 8 * n * (n1 + n2)
    nbytes = 4 * (2 * rows * n + 2 * frames * n + rows)
    t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def bf16_library_ms(fr, fi, n):
    """cuBLAS's bf16 GEMM (bf16 out) alone on the same bf16 operands as the
    kernel's products: the combined [rows, 2N] @ [2N, 2N] at N <= 128, the
    four-step's two stage products (stage 2 on the plain version's own
    twiddled operand) above. A yardstick the port never calls."""
    bf = torch.bfloat16
    if n <= 128:
        a = torch.cat([fr, fi], dim=-1).to(bf)
        m = torch.from_numpy(fft._combined_dft_mat(n)).to(fr.device).to(bf)
        return cuda_ms(lambda: torch.matmul(a, m), calls=10)
    m2, m1r, twr, twi, n1, n2 = device_table(fft._scrambled_mats, n, device=fr.device)
    lead = fr.shape[:-1]
    xst = torch.cat([fr.reshape(*lead, n2, n1).swapaxes(-1, -2),
                     fi.reshape(*lead, n2, n1).swapaxes(-1, -2)], dim=-1)
    a1 = xst.to(bf).reshape(-1, 2 * n2)
    ar_ai = fft._mm(xst, m2, bf)
    ar, ai = ar_ai[..., :n2], ar_ai[..., n2:]
    a2 = torch.cat([(ar * twr - ai * twi).swapaxes(-1, -2),
                    (ar * twi + ai * twr).swapaxes(-1, -2)], dim=-1).to(bf).reshape(-1, 2 * n1)
    del xst, ar_ai, ar, ai
    b2, b1 = m2.to(bf), m1r.to(bf)
    return cuda_ms(lambda: (torch.matmul(a1, b2), torch.matmul(a2, b1)), calls=10)


# where bf16_decide's time goes (phase 19 (b) at N = 128, (c) at N = 4096):
# copies of its source with parts taken out, each anchor found exactly once
# (an edit of the kernel that moves one fails the run rather than timing the
# wrong thing; tests/test_torch_bf16.py checks the anchors on the CPU)
BF16_MMA = """      wgmma_bf16<N, 1>(acc_r, ar, dr, keep);  // fr @ Wr
      wgmma_bf16<N, 1>(acc_i, ar, di, keep);  // fr @ Wi
      wgmma_bf16<N, -1>(acc_r, ai, di, 1);    // - fi @ Wi
      wgmma_bf16<N, 1>(acc_i, ai, dr, 1);     // fi @ Wr"""
BF16_ABLATIONS = {
    # the four products of each k-step (their fence, commit and wait stay)
    "no_mma": [(BF16_MMA, "")],
    # |.|^2 and the argmax over 4 of each thread's N / 2 accumulator pairs
    "no_epilogue": [("for (int j = 0; j < N / 8; ++j)", "for (int j = 0; j < 1; ++j)")],
    # every copy after a warpgroup's first tile: no row traffic
    "no_copy": [("if (tile + stride < tiles) copy_tile<N>(yr, yi, rows, tile + stride, "
                 "stage, tid);", "")],
    # the derotation arithmetic (the rotation planes are still read)
    "no_derotate": [(f"derotate(q.yr.{c}, q.yi.{c}, q.c.{c}, q.s.{c}, fr.{c}, fi.{c});",
                     f"fr.{c} = q.c.{c}; fi.{c} = q.s.{c};") for c in "xyzw"],
    # the L1 prefetch of the next tile's rotation planes
    "no_prefetch": [("  if (32 * t < N) asm volatile(\"prefetch.global.L1 [%0];\\n\" "
                     "::\"l\"(p + 32 * t));", "")],
}
# the same for the four-step (N = 256..4096, bf16_decide_fourstep)
FOURSTEP_ABLATIONS = {
    # stage 1's four products of each k-step (fence, commit and wait stay)
    "no_stage1": [("""        wgmma_ss<N2, 1>(acc_r[m], ar, wr, s > 0);  // xr @ Wr
        wgmma_ss<N2, 1>(acc_i[m], ar, wi, s > 0);  // xr @ Wi
        wgmma_ss<N2, -1>(acc_r[m], ai, wi, 1);  // - xi @ Wi
        wgmma_ss<N2, 1>(acc_i[m], ai, wr, 1);   // xi @ Wr""", "")],
    # stage 2's
    "no_stage2": [("""        wgmma_ss<N1, 1>(acc2_r[h], ar, wr, s > 0);  // br @ Wr
        wgmma_ss<N1, 1>(acc2_i[h], ar, wi, s > 0);  // br @ Wi
        wgmma_ss<N1, -1>(acc2_r[h], ai, wi, 1);  // - bi @ Wi
        wgmma_ss<N1, 1>(acc2_i[h], ai, wr, 1);   // bi @ Wr""", "")],
    # every copy after a warpgroup's first tile: no row traffic
    "no_copy": [("if (tile + WGS < end) copy_frames<N1, N2>(yr, yi, rows, tile + WGS, "
                 "stage, tid);", "")],
    # the twiddle and the bs writes (stage 2 reads what is there)
    "no_bs_writes": [("""          s_x[off] = __float2bfloat16_rn(br);
          s_x[off + F::kA] = __float2bfloat16_rn(bi);""", "")],
    # the combine of a frame row's bins across lanes and warps
    "no_combine": [("for (int off = 1; off < 32; off <<= 1) {",
                    "for (int off = 1; off < 1; off <<= 1) {"),
                   ("for (int q = 1; q < kPer; ++q)", "for (int q = 1; q < 1; ++q)")],
    # the derotation and the rotation planes' reads
    "no_derotate": [("if (kRot) derotate(fr[e], fi[e], __ldg(pc + i), __ldg(ps + i), fr[e], "
                     "fi[e]);", "")],
}
# the same for the wgmma kernel at N = 32, on phase 19 (f)'s SF5 rows: what
# the rotation costs there, and the residency and the per-tile division
# that once made it slow (PERF.md section 6)
BF16_N32_ABLATIONS = {
    # the rotation planes' reads: constant planes (cos 1, sin 0)
    "const_planes": [("q.c = __ldg(reinterpret_cast<const float4*>(c));",
                      "q.c = make_float4(1.f, 1.f, 1.f, 1.f);"),
                     ("q.s = __ldg(reinterpret_cast<const float4*>(s));",
                      "q.s = make_float4(0.f, 0.f, 0.f, 0.f);")],
    # the derotation arithmetic (the rotation planes are still read)
    "no_derotate": BF16_ABLATIONS["no_derotate"],
    # the L1 prefetch of the next tile's rotation planes
    "no_prefetch": BF16_ABLATIONS["no_prefetch"],
    # the rotation rows by a 64-bit division per tile row again, as before
    # the incremental RotIndex
    "divide": [(f"const long long {p} = ({r} < rows ? {q}.q : last_rot) * N + 4 * t;",
                f"const long long {p} = ({r} < rows ? {r} : rows - 1) / rows_per_rot * N "
                f"+ 4 * t;") for p, r, q in (("p0", "row0", "rot0"), ("p1", "row1", "rot1"))],
    # one block an SM (two warpgroups), as before
    "one_block": [("static constexpr int kMinBlocks = N <= 64 ? 2 : 1;",
                   "static constexpr int kMinBlocks = 1;")],
}
# the path whose kernel each set takes apart: SF5 (N = 32), SF7 (N = 128),
# SF12 (N = 4096)
BF16_PATH_ABLATIONS = {5: BF16_N32_ABLATIONS, 7: BF16_ABLATIONS, 12: FOURSTEP_ABLATIONS}


def bf16_ablation_source(edits):
    """bf16_decide.cu with ``edits`` ((old, new) pairs) applied."""
    src = _build.SOURCES[1].read_text()
    for old, new in edits:
        check(src.count(old) == 1, f"anchor {old!r} is not in bf16_decide.cu once")
        src = src.replace(old, new)
    return src


def bf16_ablation(card, label, yr, yi, cr, si, rows_per_rot, ablations):
    """Time bf16_decide against its ``ablations`` copies on the path's rows
    (built in parallel, launched through their own C entry point with all
    of the kernel's tables: no LAUNCHES), in interleaved rounds; returns
    the medians in ms."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    label_tag = f"n{yr.shape[1]}"

    def build(item):
        name, edits = item
        cu = out_dir / f"bf16_decide_{label_tag}_{name}.cu"
        cu.write_text(bf16_ablation_source(edits))
        return name, _build.declare(ctypes.CDLL(str(
            _build.compile_library([cu], out_dir / f"bf16_decide_{label_tag}_{name}.so"))),
            bf16.ENTRY)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(ablations)) as pool:
        libs = {"kernel": _build.declare(_build.load_library(), bf16.ENTRY),
                **dict(pool.map(build, ablations.items()))}
    t_build = time.perf_counter() - t0
    n = yr.shape[1]
    tables = [None if t is None else t.data_ptr() for t in bf16._kernel_tables(n, yr.device)]
    out = torch.empty(yr.shape[0], dtype=torch.int32, device=yr.device)
    stream_ = torch.cuda.current_stream(yr.device).cuda_stream

    def launcher(lib):
        def call():
            rc = lib.lora_bf16_decide(yr.data_ptr(), yi.data_ptr(), cr.data_ptr(),
                                      si.data_ptr(), yr.shape[0], rows_per_rot, n, *tables,
                                      out.data_ptr(), None, stream_)
            check(rc == 0, f"{label}: ablation launch failed ({rc})")
        return call

    times = {name: [] for name in libs}
    for _ in range(3):
        for name, lib in libs.items():
            times[name].append(cuda_ms(launcher(lib), iters=3, calls=10))
    med = {name: statistics.median(v) for name, v in times.items()}
    print(f"{label}: {card}: where bf16_decide's time goes (copies of its source with parts "
          f"taken out, built in {t_build:.1f} s; ms, median of 3 interleaved rounds): "
          + ", ".join(f"{name} {ms:.3f}" for name, ms in med.items()), flush=True)
    return med


def bf16_path(dev, card, label, p, channels, frames, path, pack=False,
              known_offsets=False):
    """One bf16 decision path at full width: encode -> modulate -> dechirp
    -> demodulate_planar(precision='bf16') -> decode, every payload
    bit-exact, sync 0x12, one kernel launch per call (counted); the demod
    against plain f32 and, at N <= 128, fused=True (one fused_demod launch,
    counted under ``path + '_fused'``, every payload bit-exact); the kernel
    alone, its bound, its plain version and cuBLAS's bf16 GEMM on the same
    rows; a profile. With ``pack`` the payloads are packed into SF-bit
    symbols (pack_symbols; modem.encode's 8-bit codewords do not round-trip
    below SF6) and the demodulated symbols must be the sent ones. With
    ``known_offsets`` every demod takes zero offsets instead of the
    estimator (which reads the sync word, wrapped at N < 32, as an
    offset). Returns the numbers for the JSON line."""
    pool = torch.from_numpy(np.random.RandomState(p.sf).randint(
        0, 256, (POOL, PAYLOAD_LEN)).astype(np.uint8)).to(dev)
    full = pool.repeat(channels * frames // POOL, 1).reshape(channels, frames, PAYLOAD_LEN)
    syms = pack_symbols(full, p.sf) if pack else modem.encode(full)
    re, im = planar.modulate_planar(syms, p)
    xr, xi = planar.dechirp_planar(re, im, p)
    del re, im
    total = xr.numel()
    zero = torch.zeros(channels, frames, device=dev)
    known = (zero, zero) if known_offsets else None

    def decode(symbols):
        return unpack_symbols(symbols, p.sf, PAYLOAD_LEN) if pack else modem.decode(symbols)

    torch.cuda.synchronize()
    reset_launches()
    res = planar.demodulate_planar(xr, xi, p, precision="bf16", known_offsets=known)
    decoded = decode(res.symbols)
    torch.cuda.synchronize()
    fused_n = read_launches(path)
    launches = BF16_BY_PATH[path]
    check(launches == 1 and fused_n == 0, f"{label}: {launches} bf16 / {fused_n} fused "
          f"launches in one demodulate_planar(precision='bf16') call")
    check(not pack or torch.equal(res.symbols, syms), f"{label}: symbols differ from the sent")
    check(torch.equal(decoded, full), f"{label}: decoded payloads differ")
    check(bool((res.sync_word == 0x12).all()), f"{label}: sync word is not 0x12")
    check(bool(torch.isfinite(res.cfo).all() and torch.isfinite(res.time_offset).all()),
          f"{label}: non-finite cfo / time_offset")
    f32 = planar.demodulate_planar(xr, xi, p, known_offsets=known)
    check(torch.equal(res.cfo, f32.cfo) and torch.equal(res.time_offset, f32.time_offset),
          f"{label}: the float32 front's offsets differ between precisions")
    if p.n <= 128:
        torch.cuda.synchronize()
        reset_launches()
        fz = planar.demodulate_planar(xr, xi, p, fused=True, known_offsets=known)
        fz_decoded = decode(fz.symbols)
        torch.cuda.synchronize()
        fused_n = read_launches(f"{path}_fused")
        check(fused_n == 1 and BF16_BY_PATH[f"{path}_fused"] == 0,
              f"{label}: {fused_n} fused launches in one demodulate_planar(fused=True) call")
        check(torch.equal(fz_decoded, full), f"{label}: fused=True decoded payloads differ")
        del fz, fz_decoded
    t_bf16 = cuda_ms(lambda: planar.demodulate_planar(xr, xi, p, precision="bf16",
                                                      known_offsets=known))
    t_f32 = cuda_ms(lambda: planar.demodulate_planar(xr, xi, p, known_offsets=known))
    t_fused = (cuda_ms(lambda: planar.demodulate_planar(xr, xi, p, fused=True,
                                                        known_offsets=known))
               if p.n <= 128 else None)
    fused_txt = "" if t_fused is None else f", fused=True {t_fused:.3f} ms"
    print(f"{label}: {card}: {channels * frames} frames ({total / 1e6:.1f} M IQ samples"
          f"{', packed SF-bit symbols, the sent ones back' if pack else ''}"
          f"{', known zero offsets' if known_offsets else ''}) "
          f"decoded bit-exact through demodulate_planar(precision='bf16'), sync 0x12, "
          f"{launches} bf16_decide launch per call; precision='bf16' {t_bf16:.3f} ms "
          f"({total / t_bf16 / 1e6:.3f} Gsamples/s), plain f32 {t_f32:.3f} ms{fused_txt}",
          flush=True)
    profile_once(lambda: planar.demodulate_planar(xr, xi, p, precision="bf16",
                                                  known_offsets=known),
                 f"{label}: {card}: demodulate_planar(precision='bf16')")

    # the kernel alone on the path's own rows and rotation planes
    n = p.n
    yr, yi, rate, _, scale, _, _ = planar._demod_stage_planar(xr, xi, p, False, known)
    s_count = yr.shape[-2]
    del xr, xi, res, f32
    cr, si = (t.reshape(-1, n).contiguous() for t in planar._rotation_planes(rate, scale, p))
    yr, yi = yr.reshape(-1, n).contiguous(), yi.reshape(-1, n).contiguous()
    rows, nframes = yr.shape[0], cr.shape[0]
    k = bf16.bf16_decide_rows(yr, yi, n, cr, si, rows_per_rot=s_count)
    r = bf16.bf16_decide_rows_reference(yr, yi, n, cr, si, rows_per_rot=s_count)
    max_abs_err = int((k.to(torch.int64) - r.to(torch.int64)).abs().max())
    check(max_abs_err == 0, f"{label}: kernel vs plain version on the path's rows: "
          f"{int((k != r).sum())} rows differ")
    del r
    t_kernel = cuda_ms(lambda: bf16.bf16_decide_rows(yr, yi, n, cr, si, rows_per_rot=s_count),
                       calls=10)
    t_plain = cuda_ms(lambda: bf16.bf16_decide_rows_reference(yr, yi, n, cr, si,
                                                              rows_per_rot=s_count),
                      iters=3)
    ablations = BF16_PATH_ABLATIONS.get(p.sf)
    ablation = (bf16_ablation(card, label, yr, yi, cr, si, s_count, ablations)
                if ablations else None)
    bound_ms, bound_by, flops, nbytes = bf16_bound(rows, nframes, n)
    fr, fi = bf16._derotate(yr, yi, n, cr, si, s_count)
    del yr, yi
    t_lib = bf16_library_ms(fr, fi, n)
    del fr, fi
    print(f"{label}: {card}: bf16_decide_rows on {rows} rows x N={n} with the frames' "
          f"rotation: CUDA kernel ({bf16.design(n)}) {t_kernel:.3f} ms ({nbytes / t_kernel / 1e6:.0f} GB/s, "
          f"{flops / t_kernel / 1e9:.1f} TFLOP/s bf16), plain version {t_plain:.3f} ms; bins "
          f"equal; bound {bound_ms:.3f} ms by {bound_by} ({flops:.4g} flop, {nbytes:.4g} B), "
          f"{bound_ms / t_kernel:.3f} of it; cuBLAS bf16 GEMM alone on the same operands "
          f"(yardstick) {t_lib:.3f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB", flush=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": max_abs_err, "ms": t_kernel,
            "plain_ms": t_plain, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": t_lib, "demod_bf16_ms": t_bf16, "demod_f32_ms": t_f32,
            "demod_fused_ms": t_fused, "rows": rows, "n": n, "ablation_ms": ablation}


def phase19d_awgn(dev, card):
    """bf16 against f32 decisions under AWGN at SF7: mismatches and symbol
    errors against the clean frames' decisions, per per-sample SNR."""
    p = LoraParams(sf=7)
    pool = torch.from_numpy(np.random.RandomState(23).randint(
        0, 256, (POOL, PAYLOAD_LEN)).astype(np.uint8)).to(dev)
    full = pool.repeat(CHANNELS * BF16_AWGN_FRAMES // POOL, 1).reshape(
        CHANNELS, BF16_AWGN_FRAMES, PAYLOAD_LEN)
    cr0, ci0 = planar.dechirp_planar(*planar.modulate_planar(modem.encode(full), p), p)
    truth = planar.demodulate_planar(cr0, ci0, p).symbols       # the clean decisions
    check(torch.equal(modem.decode(truth), full), "phase 19 (d): clean frames")
    gen = torch.Generator(device=dev)
    for snr in BF16_AWGN_SNRS:
        gen.manual_seed(int(1000 - snr))
        sigma = float(np.sqrt(0.5 * 10.0 ** (-snr / 10.0)))
        xr = cr0 + sigma * torch.randn(cr0.shape, generator=gen, device=dev)
        xi = ci0 + sigma * torch.randn(ci0.shape, generator=gen, device=dev)
        torch.cuda.synchronize()
        reset_launches()
        b = planar.demodulate_planar(xr, xi, p, precision="bf16")
        torch.cuda.synchronize()
        read_launches("bf16_awgn")
        f = planar.demodulate_planar(xr, xi, p)
        mism = int((b.symbols != f.symbols).sum())
        err_b = int((b.symbols != truth).sum())
        err_f = int((f.symbols != truth).sum())
        print(f"phase 19 (d): {card}: SF7 AWGN at {snr:g} dB per sample, "
              f"{b.symbols.numel()} data symbols: bf16 against f32 decisions differ in "
              f"{mism}; symbol errors against the clean decisions: bf16 {err_b}, f32 {err_f}",
              flush=True)
    check(BF16_BY_PATH["bf16_awgn"] == len(BF16_AWGN_SNRS), "phase 19 (d): launches")


def phase19e_card_vs_cpu(dev):
    """demodulate_planar(precision='bf16') on a 16-frame prefix: the card's
    decisions (the kernel) equal the CPU's (the plain version)."""
    cpu = torch.device("cpu")
    for sf in (7, 12):
        p = LoraParams(sf=sf)
        pay = torch.from_numpy(np.random.RandomState(sf).randint(
            0, 256, (BF16_CPU_FRAMES, PAYLOAD_LEN)).astype(np.uint8))
        xr, xi = planar.dechirp_planar(*planar.modulate_planar(modem.encode(pay), p), p)
        # a per-frame CFO, so the rotation planes are not trivial (within the
        # 2-symbol estimator's reach: it reads larger ones as timing)
        cfo = torch.linspace(-0.2, 0.2, BF16_CPU_FRAMES)
        ph = 2 * np.pi * cfo[:, None] * torch.arange(xr.shape[-1]) / p.n
        xr, xi = xr * torch.cos(ph) - xi * torch.sin(ph), xr * torch.sin(ph) + xi * torch.cos(ph)
        torch.cuda.synchronize()
        reset_launches()
        card_res = planar.demodulate_planar(xr.to(dev), xi.to(dev), p, precision="bf16")
        torch.cuda.synchronize()
        read_launches("bf16_card_vs_cpu")
        cpu_res = planar.demodulate_planar(xr.to(cpu), xi.to(cpu), p, precision="bf16")
        check(torch.equal(card_res.symbols.cpu(), cpu_res.symbols)
              and torch.equal(card_res.sync_word.cpu(), cpu_res.sync_word),
              f"phase 19 (e) SF{sf}: card and CPU decisions differ")
        check(torch.equal(modem.decode(cpu_res.symbols), pay), f"phase 19 (e) SF{sf}: bytes")
    print(f"phase 19 (e): demodulate_planar(precision='bf16') on {BF16_CPU_FRAMES} frames with "
          f"CFOs of -0.2..0.2 bin at SF7 and SF12: the card's decisions equal the CPU's, "
          f"payloads decoded", flush=True)


def phase19c_fourstep(dev, card):
    """Phase 19 (c): the four-step's paths, SF8-12, each over one channel of
    BF16_SF12_FRAMES << (12 - SF) frames (~277 M samples); SF12 last.
    Returns each SF's numbers. To hold two versions of the kernel on one
    card, unpack the other tree (``git archive``) into a directory that
    .gitignore lists and time both trees' kernels in turns with
    ``tools/torch_kernel_resources.py --compare OTHER_CSRC``."""
    return {sf: bf16_path(dev, card, f"phase 19 (c) SF{sf}", LoraParams(sf=sf), 1,
                          BF16_SF12_FRAMES << (12 - sf), f"bf16_sf{sf}")
            for sf in BF16_FOURSTEP_SFS}


def phase19_bf16(dev, card):
    """Phase 19 (a)-(g); returns the bf16 kernel's record for the JSON line."""
    phase19a_kernel_vs_plain(dev)
    torch.cuda.empty_cache()
    sf7 = bf16_path(dev, card, "phase 19 (b) SF7", LoraParams(sf=7), CHANNELS, FRAMES,
                    "bf16_sf7")
    paths = phase19c_fourstep(dev, card)
    sf12 = paths[12]
    phase19d_awgn(dev, card)
    torch.cuda.empty_cache()
    phase19e_card_vs_cpu(dev)
    torch.cuda.empty_cache()
    sf5 = bf16_path(dev, card, "phase 19 (f) SF5", LoraParams(sf=5), CHANNELS,
                    BF16_SF5_FRAMES, "bf16_sf5", pack=True)
    # (g) SF4 (the N = 16 kernel, known zero offsets) and SF6 (N = 64)
    sf4 = bf16_path(dev, card, "phase 19 (g) SF4", LoraParams(sf=4), CHANNELS,
                    BF16_SF4_FRAMES, "bf16_sf4", pack=True, known_offsets=True)
    sf6 = bf16_path(dev, card, "phase 19 (g) SF6", LoraParams(sf=6), CHANNELS,
                    BF16_SF6_FRAMES, "bf16_sf6", pack=True)
    paths = {4: sf4, 5: sf5, 6: sf6, **paths}
    return {"name": "bf16_decide", "route": "cuda",
            "source": "lora_phy_tpu_torch/csrc/bf16_decide.cu",
            # no Pallas kernel: the jnp code XLA fuses for precision="bf16"
            "replaces": "lora_phy_tpu/ops/planar.py:179",
            **{k: sf7[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")},
            **{f"sf{sf}": {k: rec[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                                "bound_ms", "bound_by", "library_ms",
                                                "demod_bf16_ms", "rows", "n")}
               for sf, rec in paths.items()},
            # the design that serves each N (the top-level numbers are SF7's)
            "design": {str(n): bf16.design(n) for n in bf16.KERNEL_N},
            "ablation_ms": sf7["ablation_ms"], "fourstep_ablation_ms": sf12["ablation_ms"],
            "n32_ablation_ms": sf5["ablation_ms"],
            "demod_ms": {"sf7_bf16": sf7["demod_bf16_ms"], "sf7_f32": sf7["demod_f32_ms"],
                         "sf7_fused": sf7["demod_fused_ms"],
                         **{f"sf{sf}_{k}": rec[f"demod_{k}_ms"] for sf, rec in
                            ((4, sf4), (5, sf5), (6, sf6)) for k in ("bf16", "f32", "fused")},
                         "sf12_bf16": sf12["demod_bf16_ms"], "sf12_f32": sf12["demod_f32_ms"]}}


# ---------------------------------------------------------------------------
# phase 20: bench.py on the port, the block receiver's stage profile, and
# both kernels alone at N = 4..64
# ---------------------------------------------------------------------------

# the bench's three runs: label, arguments
BENCH_RUNS = (("f32", []), ("fused", ["--fused"]), ("bf16", ["--precision=bf16"]))
# phase 20 (c): the N of SF2-6 and the samples of every row set (rows x N),
# the SF7 main path's (8 x 8192 frames x 66 windows x 128)
SMALL_N, SMALL_N_SAMPLES = (4, 8, 16, 32, 64), 553_648_128
# symbol windows per frame (one rotation plane each) of phase 20 (c)
SMALL_N_WINDOWS = 2 * PAYLOAD_LEN + 2
# the paths that reach each kernel at N < 128: phase 2's SF2-4 demods and
# the counted fused=True calls of phase 19 (f), (g) (fused_demod), phase 19
# (f), (g)'s SF4-6 demods (bf16_decide)
SMALL_SF_PATH = {4: ("small_sf2",), 8: ("small_sf3",), 16: ("small_sf4", "bf16_sf4_fused"),
                 32: ("bf16_sf5_fused",), 64: ("bf16_sf6_fused",)}
BF16_SMALL_PATH = {16: ("bf16_sf4",), 32: ("bf16_sf5",), 64: ("bf16_sf6",)}


def phase20a_bench(dev, card):
    """lora_phy_tpu_torch.runners.bench.main three ways in this process:
    rc 0, one JSON line with every value non-null (its decode and coverage
    gates raise inside), and each kernel launched once per call of the
    stages that reach it (counted per stage by the bench, and per run by
    the counters)."""
    from lora_phy_tpu_torch.runners import bench

    for label, args in BENCH_RUNS:
        out, err = io.StringIO(), io.StringIO()
        torch.cuda.synchronize()
        reset_launches()
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = bench.main(args)
        finally:                        # the bench's log, also when a stage raised
            for msg in err.getvalue().splitlines():
                print(f"phase 20 (a) {label}: {msg}", flush=True)
        torch.cuda.synchronize()
        path = f"bench_{label}"
        fused_n = read_launches(path)
        bf16_n = BF16_BY_PATH[path]
        check(rc == 0, f"phase 20 (a) {label}: bench exited {rc}")
        json_lines = [s for s in out.getvalue().splitlines() if s.startswith("{")]
        check(len(json_lines) == 1, f"phase 20 (a) {label}: {len(json_lines)} JSON lines")
        line = json.loads(json_lines[0])
        nulls = sorted(k for k, v in line.items() if v is None)
        check(not nulls, f"phase 20 (a) {label}: null values {nulls}")
        stages = bench.LAST_RUN
        head, sf12 = stages["headline"], stages["sf12"]
        want_fused = head["calls"] if label == "fused" else 0
        want_bf16 = head["calls"] + sf12["calls"] if label == "bf16" else 0
        check(fused_n == want_fused and head["fused_demod"] == want_fused,
              f"phase 20 (a) {label}: {fused_n} fused_demod launches ({head['fused_demod']} in "
              f"{head['calls']} headline calls), want {want_fused}")
        check(bf16_n == want_bf16 and (label != "bf16" or (
            head["bf16_decide"] == head["calls"] and sf12["bf16_decide"] == sf12["calls"])),
              f"phase 20 (a) {label}: {bf16_n} bf16_decide launches, want {want_bf16} "
              f"(headline {head}, SF12 {sf12})")
        want_decide = 0 if label == "bf16" else sf12["calls"]
        check(sf12["decide"] == want_decide,
              f"phase 20 (a) {label}: {sf12['decide']} decide launches in {sf12['calls']} SF12 "
              f"calls, want {want_decide}")
        print(f"phase 20 (a) {label}: {card}: {json.dumps(line)}", flush=True)
        print(f"phase 20 (a) {label}: launches fused_demod {fused_n} ({head['calls']} headline "
              f"calls), bf16_decide {bf16_n} ({head['calls']} headline + {sf12['calls']} SF12 "
              f"calls), decide {DECIDE_BY_PATH[path]} ({sf12['decide']} in the SF12 stage); "
              f"regressed {line['regressed']} (reported, not a gate here: "
              f"the floors hold for one card and power limit)", flush=True)
        torch.cuda.empty_cache()


def phase20b_stage_profile(dev, card):
    """The block receiver at bench shape under torch.profiler, each device
    event attributed to its record_function range (the stages of
    tools/torch_profile_block_rx.py); the stages' device ms add up to
    within 10 % of the call's busy time, and the stage markers cost the
    untraced call under 2 % of its time."""
    import importlib.util

    from lora_phy_tpu_torch.utils.profiling import range_profile

    spec = importlib.util.spec_from_file_location(
        "torch_profile_block_rx", REPO / "tools" / "torch_profile_block_rx.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    call, total = tool.block_rx_call(dev, BLOCK_FRAMES)
    torch.cuda.synchronize()
    reset_launches()
    prof = range_profile(call, sync.CIRCULAR_STAGES, calls=tool.CALLS)
    torch.cuda.synchronize()
    read_launches("block_profile")
    for line in prof.lines(f"phase 20 (b): {card}: block receiver, {total / 1e6:.1f} M samples"):
        print(line, flush=True)
    print(f"phase 20 (b): scan kernel launches {SCAN_BY_PATH['block_profile']} in "
          f"{tool.CALLS + 1} receiver calls", flush=True)
    check(SCAN_BY_PATH["block_profile"] == tool.CALLS + 1 and
          SPECTRA_BY_PATH["block_profile"] == 0,
          f"phase 20 (b): {SCAN_BY_PATH['block_profile']} scan launches, "
          f"{SPECTRA_BY_PATH['block_profile']} spectra scans in {tool.CALLS + 1} receiver calls")
    staged = sum(v[0] for v in prof.stages.values())
    check(prof.busy_ms > 0, "phase 20 (b): the profiler recorded no device time")
    check(abs(staged - prof.busy_ms) <= 0.1 * prof.busy_ms,
          f"phase 20 (b): the stages' device ms {staged:.3f} are not within 10 % of the busy "
          f"{prof.busy_ms:.3f} ms")
    t = cuda_ms(call, iters=10)
    # what the stage markers cost the receiver when no profiler runs: each
    # is one stage_range call (a no-op range), eight a call
    markers_ms = len(sync.CIRCULAR_STAGES) * tool.range_cost_us() / 1e3
    print(f"phase 20 (b): {card}: receive_block_planar {t:.3f} ms median of 10 without the "
          f"profiler; the stages' device ms {staged:.3f} of {prof.busy_ms:.3f} busy; its "
          f"{len(sync.CIRCULAR_STAGES)} stage markers cost {markers_ms:.4f} ms of host time "
          f"untraced ({markers_ms / t:.5f} of the call)", flush=True)
    check(markers_ms <= 0.02 * t, f"phase 20 (b): the stage markers cost {markers_ms:.4f} ms, "
          f"over 2 % of the {t:.3f} ms call")
    phase20b_bulk_markers(dev, card)


# the modules whose stage ranges and host syncs the bulk call passes
BULK_MARKED = (planar, windows_k, modem, coded)


@contextlib.contextmanager
def markers_off():
    """``stage_range`` and ``host_sync`` as no-ops (no range, no count) in
    the modules of the bulk call, for the length of the block."""
    null = contextlib.nullcontext()
    saved = [(m, name, getattr(m, name)) for m in BULK_MARKED
             for name in ("stage_range", "host_sync") if hasattr(m, name)]
    try:
        for m, name, _ in saved:
            setattr(m, name, lambda *a: null)
        yield
    finally:
        for m, name, f in saved:
            setattr(m, name, f)


def phase20b_bulk_markers(dev, card, rounds=6, calls=5):
    """What the stage ranges and host-sync counters cost the untraced bulk
    coded call: host wall ms of ``calls`` back-to-back calls ending in a
    synchronize, with the markers and with them patched to no-ops, in
    turns (on, off, off, on); at most 2 % apart by the medians. Each call
    passes two host syncs (the estimate's, and the window gather's one
    read of the offsets for both planes)."""
    from lora_phy_tpu_torch.utils import profiling

    p, cfg, full, xr, xi = coded_frames_at_cfo(dev, 7, (CHANNELS, FRAMES), seed=20)

    def call():
        dr, di = planar.dechirp_planar(xr, xi, p)
        res = planar.demodulate_planar(dr, di, p, fused=True)
        return res, coded.decode_payload(res.symbols, PAYLOAD_LEN, cfg)

    reset_launches()
    res, (payload, crc_ok, _) = call()
    torch.cuda.synchronize()
    read_launches("bulk")
    check(DECHIRP_BY_PATH["bulk"] == 1,
          f"phase 20 (b) bulk: {DECHIRP_BY_PATH['bulk']} dechirp launches in one call, want 1")
    check(torch.equal(payload, full) and bool(crc_ok.all()),
          "phase 20 (b) bulk: the payloads do not decode at a 0.3-bin CFO")
    check(not bool((torch.round(res.time_offset) == 0).all()),
          "phase 20 (b) bulk: every timing offset rounds to 0; the window gather is not driven")
    del res, payload, crc_ok
    before = profiling.HOST_SYNCS
    call()
    syncs = profiling.HOST_SYNCS - before

    def wall_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / calls

    on, off = [], []
    for _ in range(rounds // 2):
        on.append(wall_ms())
        with markers_off():
            off += [wall_ms(), wall_ms()]
        on.append(wall_ms())
    t_on, t_off = statistics.median(on), statistics.median(off)
    print(f"phase 20 (b): {card}: bulk coded call, {CHANNELS * FRAMES} frames: "
          f"{t_on:.3f} ms with the stage ranges and host-sync counters, {t_off:.3f} ms with "
          f"them patched to no-ops (medians of {len(on)} x {calls} calls in turns; "
          f"{t_on / t_off - 1:+.4f}); {syncs} host syncs a call", flush=True)
    print(f"phase 20 (b): bulk call's kernel launches: dechirp {DECHIRP_BY_PATH['bulk']}, "
          f"fused_demod {FUSED_BY_PATH['bulk']}, bf16_decide {BF16_BY_PATH['bulk']}, scan "
          f"{SCAN_BY_PATH['bulk']}, decide {DECIDE_BY_PATH['bulk']}", flush=True)
    check(SCAN_BY_PATH["bulk"] == 0 and DECIDE_BY_PATH["bulk"] == 0,
          "phase 20 (b) bulk: the SF7 bulk call launched the scan or the decide kernel")
    check(syncs == 2, f"phase 20 (b) bulk: {syncs} host syncs a call, want 2")
    check(t_on <= 1.02 * t_off, f"phase 20 (b) bulk: the markers cost {t_on - t_off:.3f} ms, "
          f"over 2 % of the {t_off:.3f} ms call")
    del xr, xi
    torch.cuda.empty_cache()
    phase20b_bulk_sf12(dev, card)
    phase20b_bulk_sf9(dev, card)


def coded_frames_at_cfo(dev, sf, batch, seed):
    """Frame-aligned coded frames of random 32-byte payloads (CR 4/5, CRC,
    whitening) at a 0.3-bin CFO: ``(params, coding, payloads, xr, xi)``."""
    p = LoraParams(sf=sf)
    cfg = coded.CodedConfig(sf=sf, cr=1, crc=True, whiten=True)
    full = torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, (*batch, PAYLOAD_LEN)).astype(np.uint8)).to(dev)
    xr, xi = planar.modulate_planar(coded.encode_payload(full, cfg), p)
    ph = (2 * np.pi * 0.3 / p.n) * torch.arange(xr.shape[-1], device=dev, dtype=torch.float32)
    c, s = torch.cos(ph), torch.sin(ph)
    return p, cfg, full, xr * c - xi * s, xr * s + xi * c


# the SF12 bulk cell's call (phybench bulk-sf12-b3328): 8 x 416 frames of
# 32 SF12 symbol periods (2 sync + 30 coded), 131,072 samples
SF12_BULK_BATCH = (8, 416)


def phase20b_bulk_sf12(dev, card):
    """One bulk coded call at the SF12 cell's shape, as
    ``phybench/paths/bulk_wide.py`` makes it (``fused=False``, the exact
    float32 route): the rows it decided (from the outputs' shape), one
    launch of the decide kernel and none of ``fused_demod`` or
    ``bf16_decide``, the payloads decoded at a 0.3-bin CFO, the host
    syncs (still 2: the kernel adds none)."""
    from lora_phy_tpu_torch.utils import profiling

    p, cfg, full, xr, xi = coded_frames_at_cfo(dev, 12, SF12_BULK_BATCH, seed=26)
    reset_launches()
    syncs_before = profiling.HOST_SYNCS
    words_before = coded.CODEWORDS.get(1, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dr, di = planar.dechirp_planar(xr, xi, p)
    res = planar.demodulate_planar(dr, di, p, fused=False)
    payload, crc_ok, _ = coded.decode_payload(res.symbols, PAYLOAD_LEN, cfg)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    read_launches("bulk_sf12")
    syncs = profiling.HOST_SYNCS - syncs_before
    words = coded.CODEWORDS.get(1, 0) - words_before
    # a row a symbol window: the data symbols and the sync pair of each frame
    rows = res.symbols.numel() + 2 * res.sync_word.numel()
    want = SF12_BULK_BATCH[0] * SF12_BULK_BATCH[1] * xr.shape[-1] // p.n
    print(f"phase 20 (b): {card}: bulk coded call at SF12, {SF12_BULK_BATCH[0]} x "
          f"{SF12_BULK_BATCH[1]} frames of {xr.shape[-1]} samples: {rows} rows decided; "
          f"{words} CR 4/5 codewords decoded; "
          f"{syncs} host syncs; launches dechirp {DECHIRP_BY_PATH['bulk_sf12']}, "
          f"fused_demod {FUSED_BY_PATH['bulk_sf12']}, bf16_decide {BF16_BY_PATH['bulk_sf12']}, "
          f"scan {SCAN_BY_PATH['bulk_sf12']}, decide {DECIDE_BY_PATH['bulk_sf12']}; "
          f"{first_ms:.1f} ms host wall, first call", flush=True)
    check(rows == want, f"phase 20 (b) bulk SF12: {rows} rows decided, want {want}")
    check(torch.equal(payload, full) and bool(crc_ok.all()),
          "phase 20 (b) bulk SF12: the payloads do not decode at a 0.3-bin CFO")
    check(FUSED_BY_PATH["bulk_sf12"] == 0 and BF16_BY_PATH["bulk_sf12"] == 0,
          "phase 20 (b) bulk SF12: the exact float32 route launched fused_demod or bf16_decide")
    check(DECIDE_BY_PATH["bulk_sf12"] == 1,
          f"phase 20 (b) bulk SF12: {DECIDE_BY_PATH['bulk_sf12']} decide launches, want 1")
    check(syncs == 2, f"phase 20 (b) bulk SF12: {syncs} host syncs a call, want 2")
    # 2 CRC bytes with the 32: 68 nibbles in 6 blocks of 12 codewords a frame
    check(words == SF12_BULK_BATCH[0] * SF12_BULK_BATCH[1] * 72,
          f"phase 20 (b) bulk SF12: {words} codewords counted in one call")
    del xr, xi, dr, di, res, payload, crc_ok
    torch.cuda.empty_cache()


# the SF9 bulk cell (phybench bulk-sf9-b13312): the configuration, the
# traffic mix and a seed of one pool item
SF9_BULK_CELL = ("bulk-sf9-bw250-cr48", "bulk-sf9-b13312", 2 ** 33 + 28)
# CR 4/8 codewords a 32-byte SF9 frame carries: 2 CRC bytes with the 32 are
# 68 nibbles, 8 interleaver blocks of 9 codewords
SF9_CODEWORDS = 72


def phase20b_bulk_sf9(dev, card):
    """One bulk coded call of the SF9 cell's shape on its traffic (one pool
    item of the benchmark's generator: 8 x 1,664 frames of 66 symbols of
    512 samples, -15..5 dB), as ``phybench/paths/bulk_wide.py`` makes it
    (``fused=False``): one launch of the decide kernel and none of
    ``fused_demod`` or ``bf16_decide``, the codewords the CR 4/8 decoder
    counts (``coded.CODEWORDS[4]``, 72 a frame), the host syncs (2), the
    frames whose Hamming(8,4) decode flagged a codeword, and the bytes,
    ``crc_ok`` and ``fec_errors`` equal to the benchmark reference's decode
    of the program's own symbols."""
    from lora_phy_tpu_torch.utils import profiling
    from phybench.reference import bulk as rbulk
    from phybench.traffic import generator

    name, mix, seed = SF9_BULK_CELL
    cfg_json = json.loads((REPO / "phybench" / "configs" / f"{name}.json").read_text())
    traffic = dict(json.loads((REPO / "phybench" / "traffic" / f"{mix}.json").read_text()),
                   pool=1)
    item = generator.make_pool(cfg_json, traffic, seed, dev)[0]
    p = LoraParams(sf=cfg_json["sf"], sync_word=cfg_json["sync_word"])
    cfg = coded.CodedConfig(sf=cfg_json["sf"], cr=cfg_json["cr"], crc=cfg_json["crc"],
                            whiten=cfg_json["whiten"])
    frames = item.payloads.shape[0] * item.payloads.shape[1]
    reset_launches()
    syncs_before = profiling.HOST_SYNCS
    words_before = coded.CODEWORDS.get(4, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dr, di = planar.dechirp_planar(item.xr, item.xi, p)
    res = planar.demodulate_planar(dr, di, p, fused=False)
    payload, crc_ok, fec = coded.decode_payload(res.symbols, cfg_json["payload_bytes"], cfg)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    read_launches("bulk_sf9")
    syncs = profiling.HOST_SYNCS - syncs_before
    words = coded.CODEWORDS.get(4, 0) - words_before
    rows = res.symbols.numel() + 2 * res.sync_word.numel()
    sent = item.payloads.reshape(frames, -1)
    got = payload.cpu().numpy().reshape(frames, -1)
    ok, fec = crc_ok.cpu().numpy().reshape(-1), fec.cpu().numpy().reshape(-1)
    ref_pay, ref_ok, ref_fec = rbulk.decode(
        res.symbols.cpu().numpy().reshape(frames, -1).astype(np.int64), cfg_json)
    mismatch = int((np.any(ref_pay != got, axis=-1) | (ref_ok != ok) | (ref_fec != fec)).sum())
    right = int(np.all(got == sent, axis=-1).sum())
    flagged = int((fec > 0).sum())
    print(f"phase 20 (b): {card}: bulk coded call at SF9 CR 4/8 on {mix}'s traffic, "
          f"{frames} frames of {item.xr.shape[-1]} samples: {rows} rows decided; {words} "
          f"codewords decoded ({SF9_CODEWORDS} a frame), {int(fec.sum())} flagged in {flagged} "
          f"frames; {right} frames with the bytes sent, {int(ok.sum())} with crc_ok; "
          f"{mismatch} frames whose decode differs from the reference's; {syncs} host syncs; "
          f"launches dechirp {DECHIRP_BY_PATH['bulk_sf9']}, fused_demod "
          f"{FUSED_BY_PATH['bulk_sf9']}, bf16_decide {BF16_BY_PATH['bulk_sf9']}, scan "
          f"{SCAN_BY_PATH['bulk_sf9']}, decide {DECIDE_BY_PATH['bulk_sf9']}; "
          f"{first_ms:.1f} ms host wall, first call", flush=True)
    check(rows == frames * item.xr.shape[-1] // p.n,
          f"phase 20 (b) bulk SF9: {rows} rows decided for {frames} frames")
    check(words == frames * SF9_CODEWORDS,
          f"phase 20 (b) bulk SF9: {words} codewords counted in one call, want "
          f"{frames * SF9_CODEWORDS}")
    check(DECIDE_BY_PATH["bulk_sf9"] == 1,
          f"phase 20 (b) bulk SF9: {DECIDE_BY_PATH['bulk_sf9']} decide launches, want 1")
    check(FUSED_BY_PATH["bulk_sf9"] == 0 and BF16_BY_PATH["bulk_sf9"] == 0,
          "phase 20 (b) bulk SF9: the exact float32 route launched fused_demod or bf16_decide")
    check(syncs == 2, f"phase 20 (b) bulk SF9: {syncs} host syncs a call, want 2")
    check(flagged > 0, "phase 20 (b) bulk SF9: no frame's Hamming(8,4) decode flagged a codeword")
    check(mismatch == 0, f"phase 20 (b) bulk SF9: {mismatch} frames decode otherwise than the "
          f"reference's decoder of their symbols")
    check(right >= 0.9 * frames, f"phase 20 (b) bulk SF9: {right} of {frames} frames decoded")
    del item, dr, di, res, payload, crc_ok
    torch.cuda.empty_cache()


# the bulk cell's planes (phybench bulk-b65536): 8 x 8192 frames of 52
# SF7 symbol periods, 6,656 samples
DECHIRP_SHAPE = (CHANNELS, FRAMES, 52 * 128)


def phase20d_dechirp(dev, card):
    """The dechirp kernel at the bulk cell's shape against its eager twin
    (``dechirp_reference``, six passes): bit-equal planes, both times, the
    bytes bound (both planes read and written once) and the share; then on
    a view whose base is off a 16-byte boundary (the scalar path), bit-equal
    too. Returns the kernel's record for the JSON line."""
    p = LoraParams(sf=7)
    gen = torch.Generator(device=dev).manual_seed(2021)
    xr = torch.randn(DECHIRP_SHAPE, generator=gen, device=dev)
    xi = torch.randn(DECHIRP_SHAPE, generator=gen, device=dev)
    dr, di = device_table(base_downchirp_planar, p.sf, p.scale, p.osr, device=dev)
    reset_launches()
    yr, yi = planar.dechirp_planar(xr, xi, p)
    torch.cuda.synchronize()
    check(dechirp_k.LAUNCHES == 1, f"phase 20 (d): {dechirp_k.LAUNCHES} launches in one call")
    wr, wi = dechirp_k.dechirp_reference(xr, xi, dr, di)
    check(torch.equal(yr, wr) and torch.equal(yi, wi),
          "phase 20 (d): the kernel's planes differ from the twin's")
    del yr, yi, wr, wi
    t_kernel = cuda_ms(lambda: planar.dechirp_planar(xr, xi, p), iters=10, calls=5)
    t_twin = cuda_ms(lambda: dechirp_k.dechirp_reference(xr, xi, dr, di), iters=5, calls=3)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    planar.dechirp_planar(xr, xi, p)
    peak_kernel = torch.cuda.max_memory_allocated(dev) - base
    torch.cuda.reset_peak_memory_stats(dev)
    dechirp_k.dechirp_reference(xr, xi, dr, di)
    peak_twin = torch.cuda.max_memory_allocated(dev) - base
    samples = xr.numel()
    nbytes = 16 * samples
    bound_ms = nbytes / PEAK_HBM_BYTES * 1e3
    print(f"phase 20 (d): {card}: dechirp_planar on {DECHIRP_SHAPE} ({samples / 1e6:.1f} M "
          f"samples a plane): CUDA kernel {t_kernel:.3f} ms ({nbytes / t_kernel / 1e9:.3f} "
          f"TB/s), eager twin {t_twin:.3f} ms; planes bit-equal; bound {bound_ms:.3f} ms by "
          f"bytes ({nbytes:.4g} B), {bound_ms / t_kernel:.3f} of it; memory a call beyond the "
          f"inputs {peak_kernel / 1e9:.3f} GB (twin {peak_twin / 1e9:.3f} GB)", flush=True)
    # an offset view: base 4 bytes past a 16-byte boundary, rows of 6,657
    wide = torch.zeros(2, CHANNELS, 64, DECHIRP_SHAPE[-1] + 1, device=dev)
    wide[0, ..., 1:], wide[1, ..., 1:] = xr[:, :64], xi[:, :64]
    vr, vi = wide[0, ..., 1:], wide[1, ..., 1:]
    check(vr.data_ptr() % 16 != 0, "phase 20 (d): the offset view is aligned")
    reset_launches()
    yr, yi = planar.dechirp_planar(vr, vi, p)
    wr, wi = dechirp_k.dechirp_reference(vr, vi, dr, di)
    check(dechirp_k.LAUNCHES == 1 and torch.equal(yr, wr) and torch.equal(yi, wi),
          "phase 20 (d): the scalar path's planes differ from the twin's")
    t_view = cuda_ms(lambda: planar.dechirp_planar(vr, vi, p), iters=5)
    t_view_twin = cuda_ms(lambda: dechirp_k.dechirp_reference(vr, vi, dr, di), iters=5)
    print(f"phase 20 (d): {card}: the scalar path on an offset view of {tuple(vr.shape)}: "
          f"bit-equal, {t_view:.3f} ms (eager twin {t_view_twin:.3f} ms)", flush=True)
    del xr, xi, wide, vr, vi, yr, yi, wr, wi
    return {"name": "dechirp", "route": "cuda", "source": "lora_phy_tpu_torch/csrc/dechirp.cu",
            "replaces": None, "launches": 1, "max_abs_err": 0,
            "ms": t_kernel, "plain_ms": t_twin, "bound_ms": bound_ms, "bound_by": "bytes",
            # the eager twin is the only PyTorch yardstick; no library call
            "library_ms": None}


def phase20e_windows(dev, card):
    """The windows kernel at the bulk cell's shape (8 x 8192 frames of 52
    SF7 symbols, random nonzero offsets within a symbol) against its eager
    twin (``shifted_windows_reference``: pad, int64 index, gather and
    select a plane): bit-equal planes, both times, the bytes bound (both
    planes read and written once) and the share; the kernel's launches and
    the zero-offset views on each path of this run (1 and 0 a bulk call, 0
    and 0 or more on the gateway paths). Returns the kernel's record for
    the JSON line."""
    n, nsym = 128, 52
    gen = torch.Generator(device=dev).manual_seed(2023)
    xr = torch.randn(DECHIRP_SHAPE, generator=gen, device=dev)
    xi = torch.randn(DECHIRP_SHAPE, generator=gen, device=dev)
    mag = torch.randint(1, n, DECHIRP_SHAPE[:-1], generator=gen, device=dev, dtype=torch.int32)
    sign = torch.randint(0, 2, DECHIRP_SHAPE[:-1], generator=gen, device=dev, dtype=torch.int32)
    t_off = mag * (2 * sign - 1)
    del mag, sign
    reset_launches()
    yr, yi = windows_k.shifted_windows(xr, xi, nsym, n, 1, t_off)
    torch.cuda.synchronize()
    check(windows_k.LAUNCHES == 1 and windows_k.ALIGNED == 0,
          f"phase 20 (e): {windows_k.LAUNCHES} launches, {windows_k.ALIGNED} aligned in one call")
    wr, wi = windows_k.shifted_windows_reference(xr, xi, nsym, n, 1, t_off)
    check(torch.equal(yr, wr) and torch.equal(yi, wi),
          "phase 20 (e): the kernel's planes differ from the twin's")
    del yr, yi, wr, wi
    t_kernel = cuda_ms(lambda: windows_k.shifted_windows_kernel(xr, xi, nsym, n, 1, t_off),
                       iters=10, calls=5)
    t_call = cuda_ms(lambda: windows_k.shifted_windows(xr, xi, nsym, n, 1, t_off), iters=10)
    t_twin = cuda_ms(lambda: windows_k.shifted_windows_reference(xr, xi, nsym, n, 1, t_off),
                     iters=5, calls=3)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    windows_k.shifted_windows_kernel(xr, xi, nsym, n, 1, t_off)
    peak_kernel = torch.cuda.max_memory_allocated(dev) - base
    torch.cuda.reset_peak_memory_stats(dev)
    windows_k.shifted_windows_reference(xr, xi, nsym, n, 1, t_off)
    peak_twin = torch.cuda.max_memory_allocated(dev) - base
    samples = xr.numel()
    nbytes = 16 * samples + 4 * t_off.numel()
    bound_ms = nbytes / PEAK_HBM_BYTES * 1e3
    print(f"phase 20 (e): {card}: shifted windows on {DECHIRP_SHAPE} ({samples / 1e6:.1f} M "
          f"samples a plane, offsets within +-{n - 1}, none 0): CUDA kernel {t_kernel:.3f} ms "
          f"({nbytes / t_kernel / 1e9:.3f} TB/s), the wrapper's call with its offset read "
          f"{t_call:.3f} ms, eager twin {t_twin:.3f} ms; planes bit-equal; bound "
          f"{bound_ms:.3f} ms by bytes ({nbytes:.4g} B), {bound_ms / t_kernel:.3f} of it; "
          f"memory a call beyond the inputs {peak_kernel / 1e9:.3f} GB (twin "
          f"{peak_twin / 1e9:.3f} GB)", flush=True)
    del xr, xi, t_off
    print(f"phase 20 (e): windows kernel launches by path: {WINDOWS_BY_PATH}; zero-offset "
          f"views by path: {ALIGNED_BY_PATH}", flush=True)
    check(WINDOWS_BY_PATH.get("bulk") == 1 and ALIGNED_BY_PATH.get("bulk") == 0,
          "phase 20 (e): the bulk call does not launch the windows kernel once")
    for path in ("block", "block_profile", "barrel_osr2", "barrel_hann"):
        check(WINDOWS_BY_PATH.get(path, 0) == 0,
              f"phase 20 (e): the gateway path {path} launched the windows kernel")
    print(f"phase 20 (e): scan kernel launches by path: {SCAN_BY_PATH}; spectra scans "
          f"(pre_acc > 1) by path: {SPECTRA_BY_PATH}", flush=True)
    check(SCAN_BY_PATH.get("block") == 1 and SPECTRA_BY_PATH.get("block") == 0,
          "phase 20 (e): the block receiver does not launch the scan kernel once")
    check(SCAN_BY_PATH.get("robust") == 0 and SPECTRA_BY_PATH.get("robust") == 1,
          "phase 20 (e): pre_acc=3 does not keep the spectra path once")
    return {"name": "windows", "route": "cuda", "source": "lora_phy_tpu_torch/csrc/windows.cu",
            "replaces": None, "launches": 1, "max_abs_err": 0,
            "ms": t_kernel, "plain_ms": t_twin, "bound_ms": bound_ms, "bound_by": "bytes",
            # the eager twin is the only PyTorch yardstick; no library call
            "library_ms": None}


# the gateway cells' blocks (phybench gw-dr5-pool2048, gw-dr0-pool128):
# (configuration, traffic mix, channels, seed of the pool item)
SCAN_CELLS = (("gw-eu868-dr5", "gw-pool2048", 2048, 2 ** 33 + 41),
              ("gw-eu868-dr0", "gw-pool128-dr0", 128, 2 ** 33 + 43))


def phase20f_scan(dev, card):
    """The scan kernel at both gateway cells' shapes on the benchmark's
    traffic (one pool item of each cell's generator): bins equal to the
    twin's (``scan_peaks_reference``) outside near-ties, the near-ties
    and any bin that differs there counted, peaks within a relative 2e-5;
    the kernel's and the twin's times, the bound by the benchmark's frozen
    count (both planes read once, four values a window written), the
    share, and the memory a call takes beyond its inputs. Returns the
    kernel's record (the SF12 cell's numbers) for the JSON line."""
    from phybench.metrics.scan_bound import scan_bound_s, scan_count
    from phybench.traffic import generator

    record = None
    for name, mix, channels, seed in SCAN_CELLS:
        cfg = json.loads((REPO / "phybench" / "configs" / f"{name}.json").read_text())
        traffic = dict(json.loads((REPO / "phybench" / "traffic" / f"{mix}.json").read_text()),
                       channels=channels, pool=1)
        item = generator.make_pool(cfg, traffic, seed, dev)[0]
        xr, xi = item.xr, item.xi
        del item
        p = LoraParams(sf=cfg["sf"], sync_word=cfg["sync_word"])
        args = (*sync._downchirp(p, dev), p.n, p.osr, planar._decimation_phase(p))
        reset_launches()
        got = scan_k.scan_peaks(xr, xi, *args)
        torch.cuda.synchronize()
        check(scan_k.LAUNCHES == 1, f"phase 20 (f) {name}: {scan_k.LAUNCHES} launches in a call")
        want = scan_k.scan_peaks_reference(xr, xi, *args)
        windows = near = differ = differ_near = 0
        gap = 0.0
        spectra = scan_k.scan_spectra(xr, xi, *args)
        for direction in range(2):
            top2 = spectra[direction].topk(2, dim=-1).values
            tie = (top2[..., 0] - top2[..., 1]) <= NEAR_TIE_REL * top2[..., 0]
            diff = got[direction] != want[direction]
            windows += tie.numel()
            near += int(tie.sum())
            differ += int((diff & ~tie).sum())
            differ_near += int((diff & tie).sum())
            rel = (got[2 + direction] - want[2 + direction]).abs() / want[2 + direction]
            gap = max(gap, float(rel.max()))
            del top2, tie, diff, rel
        del spectra
        check(differ == 0 and gap <= 2e-5,
              f"phase 20 (f) {name}: {differ} bins differ outside near-ties, peaks {gap:.3g} apart")
        del got, want
        t_kernel = cuda_ms(lambda: scan_k.scan_peaks(xr, xi, *args), iters=10, calls=5)
        t_twin = cuda_ms(lambda: scan_k.scan_peaks_reference(xr, xi, *args), iters=3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        scan_k.scan_peaks(xr, xi, *args)
        peak_kernel = torch.cuda.max_memory_allocated(dev) - base
        torch.cuda.reset_peak_memory_stats(dev)
        scan_k.scan_peaks_reference(xr, xi, *args)
        peak_twin = torch.cuda.max_memory_allocated(dev) - base
        samples = xr.numel()
        flops, nbytes = scan_count(samples, p.n)
        bound_s, bound_by = scan_bound_s(samples, p.n)
        bound_ms = bound_s * 1e3
        print(f"phase 20 (f): {card}: scan on {name}'s block {tuple(xr.shape)} (SF{p.sf}, "
              f"{windows // 2} windows): CUDA kernel {t_kernel:.3f} ms, twin {t_twin:.3f} ms; "
              f"bins equal outside near-ties ({near} of {windows} window-directions within "
              f"{NEAR_TIE_REL:g} of a tie, {differ_near} of them differ), peaks within "
              f"{gap:.3g}; bound {bound_ms:.3f} ms by {bound_by} ({nbytes:.4g} B, {flops:.4g} "
              f"flop), {bound_ms / t_kernel:.3f} of it; memory a call beyond the inputs "
              f"{peak_kernel / 1e9:.4f} GB (twin {peak_twin / 1e9:.3f} GB)", flush=True)
        record = {"name": "scan", "route": "cuda", "source": "lora_phy_tpu_torch/csrc/scan.cu",
                  "replaces": None, "launches": 1, "max_abs_err": None, "cell": name,
                  "ms": t_kernel, "plain_ms": t_twin, "bound_ms": bound_ms,
                  "bound_by": bound_by, "near_ties": near, "differ_near_ties": differ_near,
                  # the twin is the only PyTorch yardstick; no library call
                  "library_ms": None}
        del xr, xi
        torch.cuda.empty_cache()
    return record

# the SF12 bulk cell's configuration, traffic mix and one pool item's seed
# (phase 20 (g))
DECIDE_CELLS = (("bulk-sf12-bw500-cr45", "bulk-sf12-b3328", 2 ** 33 + 77),
                ("bulk-sf9-bw250-cr48", "bulk-sf9-b13312", 2 ** 33 + 79))


def phase20g_decide(dev, card, cell):
    """The f32 decide kernel at a bulk cell's shape on its traffic (``cell``
    an entry of ``DECIDE_CELLS``: one pool item of the generator, dechirped,
    through the demodulator's front): bins equal to the twin's
    (``decide_reference``) outside
    near-ties, the near-ties and any bin that differs there counted; the
    kernel's and the twin's times, the bound by the benchmark's frozen
    count (every row derotated, FFT'd and decided, both planes read once),
    the share, and the memory a call takes beyond its inputs. Returns the
    kernel's record for the JSON line."""
    from phybench.metrics.kernel_bound import fused_demod_bound_s, fused_demod_count
    from phybench.traffic import generator

    name, mix, seed = cell
    cfg = json.loads((REPO / "phybench" / "configs" / f"{name}.json").read_text())
    traffic = dict(json.loads((REPO / "phybench" / "traffic" / f"{mix}.json").read_text()),
                   pool=1)
    item = generator.make_pool(cfg, traffic, seed, dev)[0]
    p = LoraParams(sf=cfg["sf"], sync_word=cfg["sync_word"])
    xr, xi = planar.dechirp_planar(item.xr, item.xi, p)
    del item
    yr, yi, rate, _, scale, _, _ = planar._demod_stage_planar(xr, xi, p, False, None)
    yr, yi = yr.contiguous(), yi.contiguous()
    del xr, xi
    args = (yr, yi, rate, scale, p)
    reset_launches()
    got = decide_k.decide_rows(*args)
    torch.cuda.synchronize()
    check(decide_k.LAUNCHES == 1, f"phase 20 (g): {decide_k.LAUNCHES} launches in a call")
    want = decide_k.decide_reference(*args)
    fr, fi = decide_k._rotated_windows_planar(yr, yi, rate, None, scale, p)
    top2 = fft.dft_mag2_planar(fr, fi, p.n).topk(2, dim=-1).values
    del fr, fi
    tie = (top2[..., 0] - top2[..., 1]) <= NEAR_TIE_REL * top2[..., 0]
    diff = got != want
    rows, near = tie.numel(), int(tie.sum())
    differ, differ_near = int((diff & ~tie).sum()), int((diff & tie).sum())
    del top2, tie, diff, got, want
    torch.cuda.empty_cache()
    check(differ == 0, f"phase 20 (g): {differ} bins differ outside near-ties")
    t_kernel = cuda_ms(lambda: decide_k.decide_rows(*args), iters=10, calls=5)
    t_twin = cuda_ms(lambda: decide_k.decide_reference(*args), iters=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    decide_k.decide_rows(*args)
    peak_kernel = torch.cuda.max_memory_allocated(dev) - base
    torch.cuda.reset_peak_memory_stats(dev)
    decide_k.decide_reference(*args)
    peak_twin = torch.cuda.max_memory_allocated(dev) - base
    flops, nbytes = fused_demod_count(rows, p.n)
    bound_s, bound_by = fused_demod_bound_s(rows, p.n)
    bound_ms = bound_s * 1e3
    print(f"phase 20 (g): {card}: decide on {name}'s call {tuple(yr.shape)} (SF{p.sf}, {rows} "
          f"rows): CUDA kernel {t_kernel:.3f} ms, twin {t_twin:.3f} ms; bins equal outside "
          f"near-ties ({near} of {rows} rows within {NEAR_TIE_REL:g} of a tie, {differ_near} "
          f"of them differ); bound {bound_ms:.3f} ms by {bound_by} ({nbytes:.4g} B, "
          f"{flops:.4g} flop), {bound_ms / t_kernel:.3f} of it; memory a call beyond the "
          f"inputs {peak_kernel / 1e9:.4f} GB (twin {peak_twin / 1e9:.3f} GB)", flush=True)
    del yr, yi, args
    torch.cuda.empty_cache()
    return {"name": "decide", "route": "cuda", "source": "lora_phy_tpu_torch/csrc/decide.cu",
            "replaces": None, "launches": 1, "max_abs_err": None, "cell": name,
            "ms": t_kernel, "plain_ms": t_twin, "bound_ms": bound_ms, "bound_by": bound_by,
            "near_ties": near, "differ_near_ties": differ_near,
            # the twin is the only PyTorch yardstick; no library call
            "library_ms": None}


# the SF12 gateway cell's configuration, traffic mix, channels and one pool
# item's seed (phase 20 (h))
LANES_CELL = ("gw-eu868-dr0", "gw-pool128-dr0", 128, 2 ** 33 + 47)


def lanes_count(frames, sync_rows, pay_rows, n):
    """(flops, bytes) of the lanes kernel's work: every row derotated (4
    products and 2 sums a sample), a 5 N log2 N FFT and |.|² (3 flops a
    bin) of each derotated row and of each raw payload row; the rows read
    once, 8 bytes a sample, and what is written (a bin a row, 6 values a
    payload row)."""
    rows = sync_rows + pay_rows
    ffts = rows + pay_rows
    flops = frames * (rows * 6 * n + ffts * (5 * n * math.log2(n) + 3 * n))
    nbytes = frames * (rows * n * 8 + rows * 4 + pay_rows * 6 * 4)
    return flops, nbytes


def phase20h_lanes(dev, card):
    """The lanes kernel on one call of the SF12 gateway cell's lanes: the
    receiver runs once on one pool item of the cell's traffic with a spy
    on ``lane_spectra`` (one launch; none with the spectra), then the
    kernel alone on the rows it was handed against its twin
    (``lane_spectra_reference``): bins equal outside near-ties, the
    near-ties and any bin that differs there counted, peaks, sums and the
    clock drift's powers within a relative 1e-5; both times, the bound
    and the share; the receiver call's peak memory with the kernel and
    with the twin. Returns the kernel's record for the JSON line."""
    from phybench.traffic import generator

    name, mix, channels, seed = LANES_CELL
    cfg = json.loads((REPO / "phybench" / "configs" / f"{name}.json").read_text())
    traffic = dict(json.loads((REPO / "phybench" / "traffic" / f"{mix}.json").read_text()),
                   channels=channels, pool=1)
    item = generator.make_pool(cfg, traffic, seed, dev)[0]
    p = LoraParams(sf=cfg["sf"], sync_word=cfg["sync_word"])

    def receive(**kw):
        return sync.receive_block_planar(
            item.xr, item.xi, p, 2 * cfg["payload_bytes"], max_frames=cfg["max_frames"],
            preamble_len=cfg["preamble_len"], min_power_db=cfg["min_power_db"], **kw)

    seen = []

    def spy(*a, **kw):
        seen.append(a)
        return lanes_k.lane_spectra(*a, **kw)

    sync.lane_spectra = spy
    try:
        reset_launches()
        receive()
        torch.cuda.synchronize()
        check(lanes_k.LAUNCHES == 1, f"phase 20 (h): {lanes_k.LAUNCHES} lanes launches in a "
              "DR0 call")
        receive(with_spectra=True)
        torch.cuda.synchronize()
        check(lanes_k.LAUNCHES == 1, "phase 20 (h): a lanes launch in a DR0 call with spectra")
        read_launches("lanes_dr0")
    finally:
        sync.lane_spectra = lanes_k.lane_spectra
    args = seen[0]
    frames = math.prod(args[0].shape[:-2])
    sync_rows, pay_rows = args[0].shape[-2], args[2].shape[-2]
    got = lanes_k.lane_spectra(*args)
    want = lanes_k.lane_spectra_reference(*args)
    planes = (lanes_k.derotated_rows(*args[:7], p.n), (args[2], args[3]))
    rows = near = differ = differ_near = 0
    gap = 0.0
    for (fr, fi), kb, tb in zip(planes, (got.raw, got.sro[0]), (want.raw, want.sro[0])):
        top2 = fft.dft_mag2_planar(fr, fi, p.n).topk(2, dim=-1).values
        tie = (top2[..., 0] - top2[..., 1]) <= NEAR_TIE_REL * top2[..., 0]
        diff = kb != tb
        rows += tie.numel()
        near += int(tie.sum())
        differ += int((diff & ~tie).sum())
        differ_near += int((diff & tie).sum())
        del top2, tie, diff
    del planes, fr, fi
    same = got.sro[0] == want.sro[0]
    for a, b, ref, m in ((got.peak, want.peak, want.peak, None),
                         (got.total, want.total, want.total, None),
                         *((got.sro[i], want.sro[i], want.sro[2], same) for i in (1, 2, 3))):
        rel = (a - b).abs() / ref
        gap = max(gap, float((rel if m is None else rel[m]).max()))
    torch.cuda.empty_cache()
    check(differ == 0 and gap <= 1e-5,
          f"phase 20 (h): {differ} bins differ outside near-ties, powers {gap:.3g} apart")
    del got, want
    t_kernel = cuda_ms(lambda: lanes_k.lane_spectra(*args), iters=10, calls=5)
    t_twin = cuda_ms(lambda: lanes_k.lane_spectra_reference(*args), iters=3)
    flops, nbytes = lanes_count(frames, sync_rows, pay_rows, p.n)
    bound_ms = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    bound_by = "bytes" if nbytes / PEAK_HBM_BYTES >= flops / PEAK_F32_FLOPS else "flops"
    del args, seen
    peaks = {}
    for route in ("kernel", "twin"):
        if route == "twin":
            sync.lane_spectra = lambda *a, **kw: lanes_k.lane_spectra_reference(
                *a, with_sro=False, **kw)
        try:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            receive()
            torch.cuda.synchronize()
            peaks[route] = torch.cuda.max_memory_allocated(dev) - base
        finally:
            sync.lane_spectra = lanes_k.lane_spectra
    print(f"phase 20 (h): {card}: lanes on {name}'s call ({frames} lanes x {sync_rows} + "
          f"{pay_rows} rows of {p.n}): CUDA kernel {t_kernel:.3f} ms, twin {t_twin:.3f} ms; "
          f"bins equal outside near-ties ({near} of {rows} rows within {NEAR_TIE_REL:g} of a "
          f"tie, {differ_near} of them differ), powers within {gap:.3g}; bound "
          f"{bound_ms:.3f} ms by {bound_by} ({nbytes:.4g} B, {flops:.4g} flop), "
          f"{bound_ms / t_kernel:.3f} of it; the receiver call's peak memory beyond its inputs "
          f"{peaks['kernel'] / 1e9:.3f} GB with the kernel, {peaks['twin'] / 1e9:.3f} GB with "
          f"the twin", flush=True)
    del item
    torch.cuda.empty_cache()
    return {"name": "lanes", "route": "cuda", "source": "lora_phy_tpu_torch/csrc/lanes.cu",
            "replaces": None, "launches": 1, "max_abs_err": None, "cell": name,
            "ms": t_kernel, "plain_ms": t_twin, "bound_ms": bound_ms, "bound_by": bound_by,
            "near_ties": near, "differ_near_ties": differ_near,
            # the twin is the only PyTorch yardstick; no library call
            "library_ms": None}


def fused_bound(n_rows, n, window=False):
    """(bound ms, by, flop, bytes) of one fused_detect_rows call: per row
    the N-point DFT as an FFT (5 N log2 N flops) plus the scale,
    derotation, |.|^2 and the compare (14 N; the window 2 N more); each
    input read once (the rows, start, rate, scale, the [N] complex twiddle
    table and the window), the bins written once."""
    log2n = n.bit_length() - 1
    flops = n_rows * (5 * n * log2n + (16 if window else 14) * n)
    nbytes = 4 * (2 * n_rows * n + 3 * n_rows + 2 * n + n_rows + (n if window else 0))
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def tone_planes(gen, rows, n, cfo, gain, dev):
    """[rows, N] planes of gain * exp(j 2 pi (bin + cfo) k / N) at a random
    bin per row (cfo and gain [rows] or None); returns them and the bins."""
    bins = torch.randint(0, n, (rows,), generator=gen, device=dev)
    f = bins.to(torch.float32) if cfo is None else bins.to(torch.float32) + cfo
    ph = f[:, None] * ((2 * np.pi / n) * torch.arange(n, device=dev, dtype=torch.float32))
    yr, yi = torch.cos(ph), torch.sin(ph)
    del ph
    if gain is not None:
        yr.mul_(gain[:, None])
        yi.mul_(gain[:, None])
    return yr, yi, bins.to(torch.int32)


def same_bins(label, k, r, bins, gap_fn):
    """Kernel bins ``k`` against the plain version's ``r``: equal outside
    rows whose top-2 gap (``gap_fn(rows)``) lies within the near-tie, and
    equal to the tones' ``bins`` where the two agree. Returns (differing,
    max abs error)."""
    differ = (k != r).nonzero().flatten()
    if differ.numel():
        gap, tie = gap_fn(differ)
        check(bool((gap <= tie).all()), f"{label}: {int((gap > tie).sum())} rows differ from "
              f"the plain version beyond a {tie:g} near-tie")
    agree = k == r
    wrong = int((k[agree] != bins[agree]).sum())
    check(wrong == 0, f"{label}: {wrong} tone rows decided off their bin")
    return differ.numel(), int((k.to(torch.int64) - r.to(torch.int64)).abs().max())


def small_n_fused_rows(gen, n, dev):
    """SMALL_N_SAMPLES / N tone rows with a per-row CFO (<= 0.3 bin), a
    random start phase and amplitude: (xr, xi, start, rate, scale, bins),
    the rate and scale taking the CFO and amplitude out."""
    rows = SMALL_N_SAMPLES // n
    cfo = (torch.rand(rows, generator=gen, device=dev) - 0.5) * 0.6
    gain = 1.0 + 7.0 * torch.rand(rows, generator=gen, device=dev)
    xr, xi, bins = tone_planes(gen, rows, n, cfo, gain, dev)
    start = (torch.rand(rows, generator=gen, device=dev) - 0.5) * 600.0
    return xr, xi, start, cfo * (-2 * np.pi / n), 1.0 / gain, bins


def small_n_bf16_rows(gen, n, rotated, dev):
    """SMALL_N_SAMPLES / N tone rows in frames of SMALL_N_WINDOWS, with a
    per-frame CFO and amplitude and the rotation planes that take them out
    (rotated) or without: (yr, yi, (cr, si) or (None, None), bins, frames)."""
    p = LoraParams(sf=n.bit_length() - 1)
    rows = SMALL_N_SAMPLES // n
    frames = rows // SMALL_N_WINDOWS
    rot, cfo, gain = (None, None), None, None
    if rotated:
        f_cfo = (torch.rand(frames, generator=gen, device=dev) - 0.5)
        f_gain = 1.0 + 7.0 * torch.rand(frames, generator=gen, device=dev)
        cfo = f_cfo.repeat_interleave(SMALL_N_WINDOWS)
        gain = f_gain.repeat_interleave(SMALL_N_WINDOWS)
        rot = tuple(t.contiguous() for t in planar._rotation_planes(
            f_cfo * (-2 * np.pi / n), 1.0 / f_gain, p))
    yr, yi, bins = tone_planes(gen, rows, n, cfo, gain, dev)
    return yr, yi, rot, bins, frames


def phase20c_fused_row(dev, card, gen, n, window):
    """fused_detect_rows alone at N over small_n_fused_rows; timed against
    its bound, its plain twin and cuFFT's DFT alone. Returns the numbers."""
    p = LoraParams(sf=n.bit_length() - 1, window=window)
    xr, xi, start, rate, scale, bins = small_n_fused_rows(gen, n, dev)
    rows = xr.shape[0]
    args = (xr, xi, start, rate, p, scale)
    k = fused.fused_detect_rows(*args)
    r = fused.fused_detect_rows_reference(*args)
    label = f"phase 20 (c) fused_demod N={n} {window.name}"
    differ, max_abs_err = same_bins(label, k, r, bins, lambda d: (twin_top2_gap(
        [t[d] for t in (xr, xi, start, rate)], p, scale[d]), NEAR_TIE_REL))
    del k, r
    t_kernel = cuda_ms(lambda: fused.fused_detect_rows(*args), calls=10)
    t_plain = cuda_ms(lambda: fused.fused_detect_rows_reference(*args), iters=3)
    bound_ms, bound_by, flops, nbytes = fused_bound(rows, n, window != Window.NONE)
    z = torch.complex(xr, xi)
    del args, xr, xi
    t_lib = cuda_ms(lambda: torch.fft.fft(z, dim=-1), calls=10)
    del z
    print(f"{label}: {card}: {rows} rows: CUDA kernel {t_kernel:.3f} ms "
          f"({nbytes / t_kernel / 1e6:.0f} GB/s), bound {bound_ms:.3f} ms by {bound_by} "
          f"({flops:.4g} flop, {nbytes:.4g} B), {bound_ms / t_kernel:.3f} of it; plain twin "
          f"{t_plain:.3f} ms; cuFFT's DFT alone (yardstick) {t_lib:.3f} ms; {differ} rows "
          f"differ from the twin (near-ties), every other row at its tone's bin", flush=True)
    torch.cuda.empty_cache()
    return {"ms": t_kernel, "plain_ms": t_plain, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": t_lib, "max_abs_err": max_abs_err, "rows": rows}


def phase20c_bf16_row(dev, card, gen, n, rotated):
    """bf16_decide_rows alone at N over small_n_bf16_rows, rotated or not;
    timed against its bound, its plain version and cuBLAS's bf16 GEMM
    alone. Returns the numbers."""
    yr, yi, rot, bins, frames = small_n_bf16_rows(gen, n, rotated, dev)
    rows = yr.shape[0]
    k = bf16.bf16_decide_rows(yr, yi, n, *rot, rows_per_rot=SMALL_N_WINDOWS)
    r = bf16.bf16_decide_rows_reference(yr, yi, n, *rot, rows_per_rot=SMALL_N_WINDOWS)
    label = f"phase 20 (c) bf16_decide N={n} {'rotated' if rotated else 'no rotation'}"

    def gap(d):
        rot_d = rot if rot[0] is None else tuple(t[d // SMALL_N_WINDOWS] for t in rot)
        return bf16_top2_gap(yr[d], yi[d], n, *rot_d, 1), bf16.near_tie(n)

    differ, max_abs_err = same_bins(label, k, r, bins, gap)
    del k, r
    t_kernel = cuda_ms(lambda: bf16.bf16_decide_rows(yr, yi, n, *rot,
                                                    rows_per_rot=SMALL_N_WINDOWS), calls=10)
    t_plain = cuda_ms(lambda: bf16.bf16_decide_rows_reference(
        yr, yi, n, *rot, rows_per_rot=SMALL_N_WINDOWS), iters=3)
    bound_ms, bound_by, flops, nbytes = bf16_bound(rows, frames if rotated else 0, n)
    fr, fi = bf16._derotate(yr, yi, n, *rot, SMALL_N_WINDOWS)
    del yr, yi
    t_lib = bf16_library_ms(fr, fi, n)
    del fr, fi
    print(f"{label}: {card}: {rows} rows ({bf16.design(n)}): CUDA kernel {t_kernel:.3f} ms "
          f"({nbytes / t_kernel / 1e6:.0f} GB/s, {flops / t_kernel / 1e9:.1f} TFLOP/s bf16), "
          f"bound {bound_ms:.3f} ms by {bound_by} ({flops:.4g} flop, {nbytes:.4g} B), "
          f"{bound_ms / t_kernel:.3f} of it; plain version {t_plain:.3f} ms; cuBLAS bf16 GEMM "
          f"alone (yardstick) {t_lib:.3f} ms; {differ} rows differ from the plain version "
          f"(near-ties), every other row at its tone's bin", flush=True)
    torch.cuda.empty_cache()
    return {"ms": t_kernel, "plain_ms": t_plain, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": t_lib, "max_abs_err": max_abs_err, "rows": rows}


def phase20c_small_n(dev, card):
    """Both kernels alone at N = 4..64 (SF2-6) over rows x N = the SF7 main
    path's samples: fused_demod without and with the Hann window,
    bf16_decide with and without rotation. Returns ({N: fused numbers},
    {N: bf16 numbers}); the first configuration's numbers are the rows'."""
    gen = torch.Generator(device=dev).manual_seed(20)
    fused_rows, bf16_rows = {}, {}
    for n in SMALL_N:
        a = phase20c_fused_row(dev, card, gen, n, Window.NONE)
        b = phase20c_fused_row(dev, card, gen, n, Window.HANN)
        fused_rows[str(n)] = {**a, "ms_hann": b["ms"], "bound_ms_hann": b["bound_ms"],
                              "launches": sum(FUSED_BY_PATH.get(path, 0)
                                              for path in SMALL_SF_PATH.get(n, ()))}
        a = phase20c_bf16_row(dev, card, gen, n, True)
        b = phase20c_bf16_row(dev, card, gen, n, False)
        bf16_rows[str(n)] = {**a, "ms_no_rotation": b["ms"],
                             "bound_ms_no_rotation": b["bound_ms"],
                             "library_ms_no_rotation": b["library_ms"],
                             "launches": sum(BF16_BY_PATH.get(path, 0)
                                             for path in BF16_SMALL_PATH.get(n, ())),
                             "design": bf16.design(n)}
    return fused_rows, bf16_rows


def mesh_worker(rank, nproc, addr, backend):
    """One process of phase 17 (e): joins the group, holds two time shards
    on cuda:0, and checks the streaming demod and the seam scan against the
    single-device functions on the full stream."""
    from lora_phy_tpu_torch.parallel import mesh as meshlib, multihost
    from lora_phy_tpu_torch.parallel import stream as pstream

    rank, nproc = int(rank), int(nproc)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if nproc > 1:
        multihost.initialize(addr, nproc, rank, backend=backend)
    else:
        torch.distributed.init_process_group(backend, init_method=f"tcp://{addr}",
                                             world_size=1, rank=0)
    m = meshlib.make_mesh(1, 2 * nproc, devices=[dev] * 2)
    p = LoraParams(sf=7)
    fused.LAUNCHES = bf16.LAUNCHES = 0
    pool = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (POOL, PAYLOAD_LEN)).astype(np.uint8)).to(dev)
    full = pool.repeat(CHANNELS * WORKER_FRAMES // POOL, 1).reshape(
        CHANNELS, WORKER_FRAMES, PAYLOAD_LEN)
    xr, xi = planar.dechirp_planar(*planar.modulate_planar(modem.encode(full), p), p)
    xr, xi = xr.reshape(CHANNELS, -1), xi.reshape(CHANNELS, -1)
    t_loc = xr.shape[-1] // nproc
    lr = multihost.global_stream_array(m, xr[:, rank * t_loc:(rank + 1) * t_loc])
    li = multihost.global_stream_array(m, xi[:, rank * t_loc:(rank + 1) * t_loc])
    syms, sync_w, _, _ = pstream.demodulate_stream_planar(lr, li, p, m)
    all_syms = multihost.process_allgather(syms, m)
    ref = planar.demodulate_planar(xr, xi, p)
    check(torch.equal(all_syms[:, 2:], ref.symbols) and torch.equal(sync_w, ref.sync_word),
          "worker: symbols differ from the single device")
    frames = all_syms.reshape(CHANNELS, WORKER_FRAMES, -1)[..., 2:]
    check(torch.equal(modem.decode(frames), full), "worker: payloads differ")
    t_ms = cuda_ms(lambda: pstream.demodulate_stream_planar(lr, li, p, m), iters=3)
    # the seam scan: a frame straddling the process seam
    n_pay = 8
    frame_len = stream.frame_overhead_samples(p) + n_pay * p.step
    total = 8192 * m.n_time
    sr, si = torch.zeros(2, 1, total, device=dev)
    pl = torch.arange(n_pay // 2, dtype=torch.uint8, device=dev)
    fr, fi = stream.frame_modulate_planar(modem.encode(pl), p)
    offs = (500, total // 2 - frame_len // 2)
    for off in offs:
        sr[0, off:off + frame_len], si[0, off:off + frame_len] = fr, fi
    t_loc = total // nproc
    blk = pstream.receive_stream_block_planar(
        multihost.global_stream_array(m, sr[:, rank * t_loc:(rank + 1) * t_loc]),
        multihost.global_stream_array(m, si[:, rank * t_loc:(rank + 1) * t_loc]),
        p, n_pay, m, max_frames=2)
    gf = multihost.process_allgather(blk.found, m)
    gs = multihost.process_allgather(blk.start, m)
    check(sorted(gs[gf].tolist()) == list(offs), f"worker: scan found {gs[gf].tolist()}")
    torch.cuda.synchronize()
    print(f"MESH WORKER OK rank {rank}/{nproc} {backend}: {CHANNELS} x {xr.shape[-1]} samples "
          f"over a 1x{m.n_time} mesh (2 shards here), symbols and payloads equal to the single "
          f"device; {t_ms:.3f} ms per call; the seam frame found once; launches="
          f"{fused.LAUNCHES} bf16_launches={bf16.LAUNCHES}", flush=True)
    torch.distributed.destroy_process_group()
    return 0


# the examples phase 21 (c) runs as scripts, each on the card and on the CPU
TWIN_EXAMPLES = ("examples/torch_end_to_end.py", "examples/torch_mesh_gateway.py")
# phase 21 (d)'s cells: the waterfall's (CR, SNR dB, frames) and the sync
# sweep's (SF, SNR dB, trials, chunk)
TWIN_WATERFALL_CELL = (4, -10.0, 64)
TWIN_SYNC_CELL = (7, -9, 16, 8)


def load_tool(rel):
    """A script of the repository (``tools/*.py``) as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(pathlib.Path(rel).stem, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase21_repo_twins(dev, card):
    """The repo-level twins on the card: (a) torch_graft_entry.entry's
    forward, (b) its dryrun_multichip(8) on 8 shards of the card, (c) both
    example twins in this process on the card and as scripts on the card
    and on the CPU, (d) each sweep
    twin at one cell on injected noise, card against CPU. Every path's
    launches are counted (0 for both kernels: none reaches them)."""
    import torch_graft_entry as graft

    paths = {}

    def counted(name, fn):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        paths[name] = time.perf_counter() - t0
        read_launches(name)
        return out

    # (a) the entry's single-card forward: decisions equal to the CPU's,
    # the payloads back, sync 0x12
    def entry():
        fwd, planes = graft.entry(device=dev)
        return fwd, planes, fwd(*planes)

    fwd, (xr, xi), (syms, sync) = counted("twin_entry", entry)
    cfwd, (cxr, cxi) = graft.entry(device="cpu")
    csyms, csync = cfwd(cxr, cxi)
    check(torch.equal(syms.cpu(), csyms) and torch.equal(sync.cpu(), csync),
          "phase 21 (a): entry's decisions differ between the card and the CPU")
    payloads = np.random.RandomState(0).randint(0, 256, (2, 8)).astype(np.uint8)
    check(np.array_equal(modem.decode(syms).cpu().numpy(), payloads),
          "phase 21 (a): entry's payloads do not decode")
    check(bool((sync == 0x12).all()), "phase 21 (a): sync word is not 0x12")
    fwd_ms = cuda_ms(lambda: fwd(xr, xi))
    print(f"phase 21 (a): {card}: torch_graft_entry.entry forward (2 x 8 bytes, SF7, "
          f"{tuple(xr.shape)} planes): decisions equal to the CPU's, payloads bit-exact, sync "
          f"0x12; {fwd_ms:.3f} ms a forward (CUDA events); entry + first forward "
          f"{paths['twin_entry']:.2f} s host clock", flush=True)

    # (b) the dryrun on 8 shards of the card: its lines, equal to the CPU's
    def dryrun(device):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            graft.dryrun_multichip(8, device=device)
        return out.getvalue().splitlines()

    lines = counted("twin_dryrun", lambda: dryrun(dev))
    t0 = time.perf_counter()
    cpu_lines = dryrun("cpu")
    cpu_s = time.perf_counter() - t0
    check(len(lines) == 8 and lines[-1].startswith("dryrun_multichip OK: mesh=4x2 (8 devices)"),
          f"phase 21 (b): dryrun lines {lines}")
    check(lines == cpu_lines, f"phase 21 (b): card lines {lines} against CPU {cpu_lines}")
    for line in lines:
        print(f"phase 21 (b): {line}", flush=True)
    print(f"phase 21 (b): {card}: dryrun_multichip(8) on 8 shards of the card "
          f"{paths['twin_dryrun']:.2f} s host clock (the CPU's 8 shards {cpu_s:.2f} s), "
          "lines equal to the CPU's", flush=True)

    # (c) the examples: each run in this process on the card, its launches
    # counted, then as a script on the card and on the CPU, all four at once
    def strip_ckpt(text):
        # the gateway's checkpoint lies in a fresh temporary directory per run
        return [line.split(" checkpointed to ")[0] for line in text.splitlines()]

    def in_process(rel):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            check(load_tool(rel).main([f"--device={dev}"]) == 0, f"phase 21 (c) {rel}: rc")
        return strip_ckpt(out.getvalue())

    got = {rel: counted("twin_" + pathlib.Path(rel).stem.removeprefix("torch_"),
                        lambda: in_process(rel)) for rel in TWIN_EXAMPLES}
    runs = [(rel, d) for rel in TWIN_EXAMPLES for d in (str(dev), "cpu")]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(REPO / rel), f"--device={d}"], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rel, d in runs]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=300))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    wall = time.perf_counter() - t0
    for (rel, d), proc, (out, err) in zip(runs, procs, outs):
        check(proc.returncode == 0, f"phase 21 (c) {rel} --device={d}: rc "
              f"{proc.returncode}: {err[-2000:]}")
        check(strip_ckpt(out) == got[rel], f"phase 21 (c) {rel} --device={d}: stdout "
              f"{strip_ckpt(out)} against the card's in-process run {got[rel]}")
    for rel in TWIN_EXAMPLES:
        name = "twin_" + pathlib.Path(rel).stem.removeprefix("torch_")
        print(f"phase 21 (c): {rel} --device={dev}: {len(got[rel])} lines, in this process "
              f"({paths[name]:.2f} s host clock) and as a script, equal to --device=cpu's "
              f"(the checkpoint path aside); last: {got[rel][-1]}", flush=True)
    print(f"phase 21 (c): {card}: the four script runs at once {wall:.2f} s host clock",
          flush=True)

    # (d) each sweep twin at one cell: counts on the card equal the CPU's on
    # the same injected draws (made on the CPU from a seed)
    waterfall = load_tool("tools/torch_soft_waterfall_sweep.py")
    sweep = load_tool("tools/torch_sync_sensitivity_sweep.py")
    cr, snr, frames = TWIN_WATERFALL_CELL
    n_sym = coded.payload_symbol_count(12, coded.CodedConfig(sf=7, cr=cr))
    gen = torch.Generator().manual_seed(21)
    draws = tuple(torch.randn((frames, (n_sym + 2) * 128), generator=gen) for _ in range(2))
    w_card = counted("twin_waterfall", lambda: waterfall.losses(
        cr, snr, frames, device=dev, noise=draws))
    w_cpu = waterfall.losses(cr, snr, frames, device="cpu", noise=draws)
    check(w_card == w_cpu, f"phase 21 (d): waterfall {w_card} on the card, {w_cpu} on the CPU")

    def sync_noise(sf, snr_db, ci, b, t):
        g = torch.Generator().manual_seed(sf * 1000003 + (snr_db + 64) * 911 + ci)
        return torch.randn((b, t), generator=g), torch.randn((b, t), generator=g)

    sf, s_snr, trials, chunk = TWIN_SYNC_CELL
    sync_counts = {}
    for soft_mode in (False, True):
        name = "twin_sync_sweep" + ("_soft" if soft_mode else "")
        on_card = counted(name, lambda: sweep.cell(sf, s_snr, trials, chunk, soft=soft_mode,
                                                   device=dev, noise=sync_noise))
        on_cpu = sweep.cell(sf, s_snr, trials, chunk, soft=soft_mode, device="cpu",
                            noise=sync_noise)
        check(on_card == on_cpu, f"phase 21 (d) {name}: {on_card} on the card, {on_cpu} "
              "on the CPU")
        sync_counts[name] = on_card
    print(f"phase 21 (d): {card}: soft waterfall CR 4/{4 + cr} at {snr} dB, {frames} frames: "
          f"(hard, soft) lost {w_card} on card and CPU, {paths['twin_waterfall']:.2f} s; sync "
          f"sweep SF{sf} at {s_snr} dB, {trials} trials in chunks of {chunk}: (synced, "
          f"hard, ml) {sync_counts['twin_sync_sweep']} ({paths['twin_sync_sweep']:.2f} s), "
          f"--soft (synced, hard, soft) {sync_counts['twin_sync_sweep_soft']} "
          f"({paths['twin_sync_sweep_soft']:.2f} s), each equal to the CPU's", flush=True)

    twin = {k: (FUSED_BY_PATH[k], BF16_BY_PATH[k]) for k in paths}
    check(not any(a or b for a, b in twin.values()),
          f"phase 21: a kernel launched on a twin's path: {twin}")
    print(f"phase 21: (fused_demod, bf16_decide) launches on each path: {twin}", flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == "--mesh-worker":
        sys.exit(mesh_worker(*sys.argv[2:]))
    main()
