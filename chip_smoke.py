#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one GPU and check them.

Six paths of the port, yagi_tpu_torch, each at its real size:

* BASELINE config[0]: 64-tap Kaiser FIR → 2× polyphase interpolator → u32
  NCO mix-down, 16 channels, blocks of 2^17 complex samples (FusedRxChain,
  kernel K1, csrc/chain.cu: step on interleaved complex64, step_planar on
  planes);
* BASELINE config[4]: 64-channel polyphase channelizer (Kaiser prototype,
  m = 4, 60 dB) → FM discriminator (kf = 0.1) per channel, blocks of 2^21
  complex samples (FusedChannelizer → Freqdem, kernel K2,
  csrc/channelizer.cu);
* the u32 NCO mix-down of blocks of 2^21 complex samples, phase carried
  (mix_down_apply, kernel K5, csrc/mix.cu);
* BASELINE config[1]: arbitrary-rate MsResamp (rate 2/2.0663, "farrow",
  whose decimation stage is the 256-branch PFB gather, the kernel
  resamp_u32_apply, csrc/resamp.cu) → Symsync (RRCOS k = 2, m = 7, β = 0.3,
  32 filters, loop bandwidth 0.02) over 1024 channels, blocks of 4096
  complex samples, the resampler's count fed on as n_valid (kernel K3 for
  backend "auto", K4 for "pallas", csrc/symscan.cu);
* BASELINE config[3]: the 16-QAM receiver QamRx (AGC, bandwidth 1e-3 →
  Symsync RRCOS k = 2, m = 7, β = 0.3 at 2 samples/symbol out, two slots →
  7-tap LMS equalizer and carrier PLL → nearest-point decisions and EVM)
  over 2048 channels, blocks of 4096 complex samples: kernels agc_scan
  (csrc/agc.cu), K3 at k_out = 2 and qam_eq_scan (csrc/qam.cu), once each
  per block; besides the noise blocks, an impaired 16-QAM signal decoded
  in every channel;
* BASELINE config[2]: the FM stereo receiver FmStereoRx (Freqdem, kf 0.5 →
  four 129-tap FIRs → pilot-tone stereo matrix → two first-order
  de-emphasis IIRs, alpha 0.05) over 512 channels, blocks of 2^14 complex
  samples (bench.py's draw, seed 3): kernel fir_block (csrc/fir.cu, the
  direct-form FIR of every FirFilter block) four times a block and kernel
  iir_chunked (csrc/iir.cu, body csrc/iir.cuh) twice; iir_chunked's
  sequential form iir_scan serves every filter that is not parallelize()d;
* the distributed layer yagi_tpu_torch.parallel over NCCL, one rank a card
  (in this process at world size 1 on a one-card machine, one spawned
  process a card on more): config[4] at full width streamed through
  sharded_channelize_stream_fm_to_channels (the plain Firpfbch analyzer,
  as in yagi_tpu: no kernel lies on this path), the other channelizer
  functions and time_sharded_fir at config[0]'s width;
* the FFT layer yagi_tpu_torch.fft (torch.fft, liquid's conventions);
* the streaming filters of layer L4 at config[1]'s width (1024 channels,
  blocks of 4096 complex samples): the Kaiser interpolator and decimator,
  FftFilt, Rresamp, Fdelay, OrdFilt, Dds, and an interpolating farrow
  MsResamp (plain torch: no kernel lies on this path);
* a capture file onto the card: config[4]'s stream as a ci16 file read by
  the native loader yagi_tpu_torch.native.IqStreamLoader (native/*.cpp,
  built with g++ into build/) into pinned buffers, copied to the card and
  fed to FusedChannelizer (K2) → Freqdem;
* the tensor-valued parts of layer L0: the samplers of
  yagi_tpu_torch.random on a CUDA generator, dotprod, Modem.random_symbols,
  and OrdFilt on complex samples;
* layers L3, L5 and L6 with the channel models over 1024 channels: a
  16-QAM link (Modem → Channel with multipath, a carrier offset and 30 dB
  AWGN → a 12-bit Quantizer → an "nco" Osc → demodulate, demodulate_soft,
  demodulate_with_stats), DPSK, π/4-DQPSK and QPSK, GMSK, CPFSK and FSK
  over Channel, AmpModem of every type (its carrier tracker on kernel
  iir_chunked), Osc "nco"/"vco" mixing and 1024 PLLs, the RLS equalizer
  over 256 channels, and one OFDM frame through Channel into
  OfdmFrameSync;
* forward error correction and the packet layer (every FecScheme, frame64
  bursts, QDSync → QPilotSync, SymStreamR);
* the frame formats, the codec and checkpoints: flexframe bursts in eight
  liquid configurations, GMSK, FSK and DSSS frames, OFDM flexible frames,
  a 2^20-sample capture through the streaming Detector, BSync at
  [1024, 2^16], MSource's 64 sources into FusedChannelizer (K2), Cvsd over
  1024 channels, and save_state / load_state round trips of 27 state types
  (FusedRxChain on K1, FusedChannelizer on K2, QamRx on K3 and the loops).

Fifteen phases:

1. device: the card's name and power limit;
2. build: the CUDA kernels, compiled with nvcc from this checkout;
3. default device: an entry point called with no device builds on the card;
4. kernel vs plain: each kernel against its plain torch version on the same
   CUDA tensors, at a small shape and at its path's shape (fir_block at
   config[2]'s four filters, and a block cut in two bit for bit; K3 and K4 also
   at tap counts that are not a multiple of 4, y and the state compared as
   their bits; K3's chain-slot counter against its valid mask, and its skip
   share printed; qam_eq_scan also on ties
   and NaNs with 4-, 16- and 64-point tables), and at the shapes that take
   a kernel's second instance: K1 at rates 16, 32 and 256 and at 65,600
   channels, K2 at 66 taps a branch, at 1 tap and at 20,002 steps (its
   persistent blocks split unevenly), qam_eq_scan at 17 and 31 taps and
   in rounds (k_eq 1, 2, 3; h_len 1, 7, 16; 4-, 16- and 64-point tables;
   zero, NaN, quiet and sparse slots; C not a multiple of its 16 channels a
   block, S of its 64-slot tile, S = 1; its round counter against the plain
   loop's state-changing slots),
   agc_scan at tile edges, K4 at P = 256, 1024, 7262 (smaller staged
   layouts) and 7263 (the direct instance), and a Symsync bank past K3's
   shared memory, which "auto" hands to K4; iir_scan bit for bit at TF
   lengths 1, 2 and 3 (its order-specialised instances), 5, 7 and 9 (the
   generic register instance), 10 and 3200 (the shared-memory and
   device-memory rings), SOS with 1 to 4 sections (specialised), 5 and 7
   and the integrator, real, complex and complex-coefficient, C = 1, 3, 5,
   9, 512, T = 1 to 2^14, across slabs and ragged; iir_chunked within 2e-5
   (TF) / 1e-4 (SOS) of its plain version and of iir_scan at orders 0, 1,
   2, 4 and 8 (its order-1, order-2 and generic instances), T = 1 to 12,389
   (three segments and a ragged fourth) and 2^14, C = 3, 5, 512 and 1001
   (a second wave of blocks);
5. main paths: each streams 16 blocks with its state carried, held against
   the plain oracle (RxChain, Firpfbch → Freqdem, Osc.mix_block_down, and
   for config[1] the resampler's plain version from each block's state
   (counts, phase and window exact; values within 2e-6 of the rms of the
   plain version in float64) and the XLA-form scan
   over its first 4 blocks; config[3] streams
   8, the first 2 held bit for bit against the chain with every stage on
   its plain version; config[2] against the chain with its de-emphasis on
   the plain version, within 2e-5, then 4 blocks with the de-emphasis on
   iir_scan); every launch count is set to 0 just before a path and read
   just after it; block-split invariance;
6. signal: config[3] decodes an impaired 16-QAM signal in all 2048
   channels (tail symbol error rate 0, tail EVM below −25 dB); config[2]
   decodes FM stereo tones in 4 channels (amplitudes within 5%,
   separation above 40 dB);
7. parallel: sharded_channelize_stream_fm_to_channels over 16 config[4]
   blocks of 2^21 samples against Firpfbch → Freqdem block by block with
   carried state, bit for bit where it holds, else config[4]'s gates (each
   line says which held); sharded_channelize, sharded_channelize_fm and
   sharded_channelize_to_channels once each; time_sharded_fir over 16 ×
   2^17 with 64 Kaiser taps, with and without history, against
   FirFilter.execute_block; the gather_to_hosts round trip; the streamed
   path's eager rate beside the unsharded Firpfbch → Freqdem step;
8. fft: fft_run / ifft_run on the card against tests/golden/fft.npz (2e-4),
   and a Spgram (nfft 1024) over a config[4] block against the CPU's;
9. filters: FirInterpolationFilter (kaiser, 2x, m 7, 60 dB) then
   FirDecimationFilter back, FftFilt (64 Kaiser taps, n 4096), Rresamp
   (P/Q 3/2), Fdelay (nmax 16, delay 3.7), OrdFilt (median, m 3), Dds
   (2 stages, fc 0.1) decim and interp, and MsResamp at 2.0663/2 with
   arbitrary_interp "farrow", each over 1024 channels in blocks
   [4096, 0, 4096, 4096] with the state carried: every output and state
   tensor on the card, the streamed output equal to one long block and the
   first 64 channels equal to the CPU run (1e-5 of max(1, |y|), OrdFilt
   exactly; the Farrow values 1e-4 against the CPU, 0.03 against one long
   block), and each object's device time a block;
10. capture: 16 config[4] blocks of 2^21 samples as a 128 MiB ci16 file
   (bench.py's seed 1, ×1/8) through IqStreamLoader → K2 → Freqdem, every
   block, output and the carried state equal bit for bit to the same
   samples fed from memory, total_read exact, K2's launches on the file
   feed (printed on their own line; the kernels line keeps config[4]'s);
   the loader's rate alone and the chain's from memory and from the file;
   a 7,000-sample round trip in cf32, ci16 and cu8 (an EOF tail);
11. l0: every sampler of random/ at 2^22 draws on a CUDA generator against
   its cdf at the deciles (0.02), the same seed equal and another not,
   cawgn's power (5%), dotprod against the CPU, Modem.random_symbols for
   M = 16 (range, chi-square), OrdFilt on complex64 at 1024 × [4096, 0,
   4096] against the CPU bit for bit; the phase's time;
12. modems: each modem, channel or equalizer at 1024 channels over 4 blocks, the
   state carried (the channel's noise drawn once on the card and fed to
   both sides): its first 16 channels against the port's CPU run of the
   same blocks (float32 within 1e-5, cumulative products and sums over n
   samples within 8·√n ulps of their magnitude, decisions exactly, ADC
   codes and soft bytes within one),
   blocks [N, 0, N] against one of 2N, zero symbol errors at 30 dB with no
   multipath for QPSK, DPSK, π/4-DQPSK, GMSK, CPFSK and FSK, the 16-QAM
   link's symbol error rate, every AmpModem type's message back and its
   iir_chunked launches (one a block, none when the carrier is
   suppressed), iir_chunked against its plain version on the tracker's
   shape, the PLLs' lock, the equalizer's error, the OFDM frame's timing,
   EVM (every symbol under −20 dB: the port's pilot fit keeps a symbol
   whose common phase sits at ±π) and card = CPU; each object's device
   time a block;
13. framing: every FecScheme, 64 impaired frame64 bursts, 16 QDSync →
   QPilotSync bursts and SymStreamR against the CPU, with the times of a
   frame by stage;
14. frames: 32 impaired flexframe bursts (8 configurations, 15–30 dB), 16
   GMSK, 16 FSK and 32 DSSS frames (sf 8 at 20 dB, sf 16 at 2 dB), 20 OFDM
   flexible frames through multipath and a carrier offset, every one
   CRC-valid and as sent, flexframe card = CPU and noise undetected; the
   Detector over 64 bursts in a 2^20-sample capture (each found once
   within half a sample, card = CPU); BSync real and complex (the peak,
   a split and card = CPU bit for bit); MSource → K2 against Firpfbch and
   each tone's channel power; Cvsd over [1024, 8000] (SNR, a split and card
   = CPU bit for bit); save_state / load_state mid-stream on the card,
   outputs and every leaf bit-identical; the times of a frame by stage;
15. timing with CUDA events: K2's FM instance (ChannelizerFmRx's step in
   one launch) against its plain version, the plain instance and the torch
   discriminator, checked (channels and state bit for bit, fm within 1e-6)
   and timed in turns at config[4]'s block and at the benchmark cell's
   (2^24 samples); each kernel by CUDA-graph replay, each plain
   version by graph replay (eager calls for the plain loops: the symsync
   scans, the AGC and the eq/carrier loop), K4's direct instance (its first
   version) in turns with its staged one, and the plain iir_scan_reference
   by one eager call at config[2]'s shape (the benchmark's cells time the
   config[0] to [4] entries).

Prints one line per check, the seconds spent by stretch of phases, a JSON
line of per-kernel results (with each kernel's bound at its path's shape:
bytes at 3.35 TB/s or fp32 operations at 67 TFLOP/s, whichever is longer),
the card's name and power limit, and last ``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero; so does a machine without a CUDA device. Run it from
anywhere: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from yagi_tpu_torch._src.struct import U32  # noqa: E402
from yagi_tpu_torch.agc import Agc, AgcSquelchMode  # noqa: E402
from yagi_tpu_torch.chains import FmStereoRx, QamRx, RxChain  # noqa: E402
from yagi_tpu_torch.design import FirFilterShape, fir_design_kaiser, fir_design_prototype  # noqa: E402,E501
from yagi_tpu_torch.design import iir as iirdes  # noqa: E402
from yagi_tpu_torch.kernels.agc import agc_scan_apply, agc_scan_reference  # noqa: E402
from yagi_tpu_torch.kernels import _build  # noqa: E402
from yagi_tpu_torch.kernels.chain import (  # noqa: E402
    fused_chain_apply,
    fused_chain_apply_c64,
    fused_chain_reference,
)
from yagi_tpu_torch.kernels.channelizer import (  # noqa: E402
    channelizer_tables,
    fused_channelizer_apply,
    fused_channelizer_reference,
    halo_rows,
)
from yagi_tpu_torch.fft import Spgram, fft_run, ifft_run  # noqa: E402
from yagi_tpu_torch.filter import (  # noqa: E402
    FftFilt,
    FirFarrow,
    FirFilter,
    IirFilter,
    IirFilterSos,
    MsResamp,
    MsResamp2,
    OrdFilt,
    Resamp,
    Resamp2,
    Symsync,
)
from yagi_tpu_torch.kernels.fir import fir_block_apply, fir_block_reference  # noqa: E402
from yagi_tpu_torch.kernels.iir import (  # noqa: E402
    chunked_fits,
    chunked_instance,
    iir_chunked_apply,
    iir_chunked_reference,
    iir_scan_apply,
    iir_scan_reference,
    scan_instance,
)
from yagi_tpu_torch.kernels.mix import mix_down_apply, mix_down_reference  # noqa: E402
from yagi_tpu_torch.kernels.resamp import resamp_u32_reference  # noqa: E402
from yagi_tpu_torch.kernels.qam import (  # noqa: E402
    ROUND_SLOTS, ROUND_TILE, qam_eq_scan_apply, qam_eq_scan_reference)
from yagi_tpu_torch.errors import ConfigError  # noqa: E402
from yagi_tpu_torch.kernels.symscan import (  # noqa: E402
    FUSED_SMEM_LIMIT,
    branch_outputs,
    fused_chain_slots,
    fused_fits,
    fused_smem_bytes,
    scan_layout,
    symsync_fused_apply,
    symsync_fused_reference,
    symsync_scan_apply,
    symsync_scan_launch,
    symsync_scan_reference,
)
from yagi_tpu_torch.math import dotprod  # noqa: E402
from yagi_tpu_torch.channel import Channel  # noqa: E402
from yagi_tpu_torch.equalization import Eqlms, Eqrls  # noqa: E402
from yagi_tpu_torch import fec as tfec  # noqa: E402
from yagi_tpu_torch import trace  # noqa: E402
from yagi_tpu_torch.fec import Fec, FecScheme, fec_get_enc_msg_length  # noqa: E402
from yagi_tpu_torch.framing import (  # noqa: E402
    BSync,
    Detector,
    DsssFrameGen64,
    DsssFrameSync64,
    FlexFrameGen,
    FlexFrameSync,
    FrameGen64,
    FrameSync64,
    FskFrameGen,
    FskFrameSync,
    GmskFrameGen,
    GmskFrameSync,
    MSource,
    QDSync,
    QPilotGen,
    QPilotSync,
    SymStreamR,
    frame64_len,
)
from yagi_tpu_torch.framing._carrier import dd_track  # noqa: E402
from yagi_tpu_torch.framing.flexframe import _payload_pm as flex_payload_pm  # noqa: E402
from yagi_tpu_torch.framing.flexframe import _props as flex_props  # noqa: E402
from yagi_tpu_torch.audio import Cvsd  # noqa: E402
from yagi_tpu_torch.sequence import MSequence  # noqa: E402
from yagi_tpu_torch.utils import load_state, save_state, state_leaves  # noqa: E402
from yagi_tpu_torch.modem import (  # noqa: E402
    AmpModem,
    CpfskDem,
    CpfskMod,
    Freqdem,
    Freqmod,
    Fskdem,
    Fskmod,
    GmskDem,
    GmskMod,
    Modem,
)
from yagi_tpu_torch.multichannel import (  # noqa: E402
    Firpfbch,
    Firpfbch2,
    Firpfbchr,
    FusedChannelizer,
    OfdmFlexFrameGen,
    OfdmFlexFrameSync,
    OfdmFrameGen,
    OfdmFrameSync,
)
from yagi_tpu_torch.native import IqStreamLoader  # noqa: E402
from yagi_tpu_torch.nco import Osc  # noqa: E402
from yagi_tpu_torch.quantization import Quantizer  # noqa: E402
from yagi_tpu_torch.parallel import (  # noqa: E402
    make_stream_mesh,
    sharded_channelize,
    sharded_channelize_fm,
    sharded_channelize_stream_fm_to_channels,
    sharded_channelize_to_channels,
    time_sharded_fir,
)
from yagi_tpu_torch.parallel.multihost import (  # noqa: E402
    distribute_time_stream,
    gather_to_hosts,
    global_time_mesh,
    initialize_multihost,
)
from yagi_tpu_torch.tools.paths import (  # noqa: E402
    AM_N,
    C0 as C,
    C1,
    C2,
    C3,
    CHAIN,
    CHZ,
    CHZ_SEED,
    BSYNC_SHAPE,
    CPFSK_SYMS,
    CVSD_C,
    CVSD_N,
    DET_BLOCK,
    DET_BURSTS,
    DET_JITTER,
    DET_N,
    DET_SPACING,
    DSSS_CASES,
    DSSS_PER,
    EQRLS_C,
    EQRLS_N,
    EQRLS_P,
    FEC_LEN,
    FEC_SEED,
    FRAME_BUF,
    FRAME_DPHI_MAX,
    FRAME_GAIN,
    FRAME_N,
    FRAME_SEED,
    FRAME_SNR_DB,
    FRAMES_SEED,
    FLEX_BUF,
    FLEX_CASES,
    FLEX_PER,
    FSK_SYMS,
    GF_BURSTS,
    GF_PAYLOAD,
    GF_SNR_DB,
    GMSK_BITS,
    KF,
    M4,
    MIX_FREQ,
    MOD_C,
    MSRC_N,
    OFDM_FLEX_FRAMES,
    OFDM_FLEX_LONG,
    OFDM_FLEX_PAYLOAD,
    FM_SEED,
    OSC_N,
    QAM_SEED,
    QAM_SYMS,
    QD_BURSTS,
    QD_PAYLOAD,
    QD_PRE,
    QD_SPACING,
    STREAM_BW,
    STREAM_N,
    T0 as T,
    T1,
    T2,
    T3,
    T4,
    T4_CELL,
    chzfm_calls,
    complex_block,
    draw_impairments,
    fm_block,
    frame_bursts,
    impair,
    impaired_burst,
    make_fmstereo,
    make_filters,
    make_fused,
    make_msresamp,
    make_qamrx,
    make_symsync,
)
from yagi_tpu_torch import random as yr  # noqa: E402
from yagi_tpu_torch.tools.timing import cuda_ms, graph_ms  # noqa: E402
from yagi_tpu_torch.utils import compact_valid  # noqa: E402

# config[0] (C channels, T samples per block) and its constructor come from
# yagi_tpu_torch/tools/paths.py, like config[1]'s and config[3]'s below
N_BLOCKS = 16
N_ROT = 4  # input sets cycled in the timing phase
SEED = 0
# K1's other shapes, each small: (channels, samples per block, rate). Rates
# past 8 run in phase groups; 65,600 channels pass a grid's second dimension
CHAIN_SHAPES = ((3, 2048, 2), (5, 1024, 1), (3, 512, 4), (3, 512, 8), (3, 2048, 16),
                (3, 1024, 32), (2, 256, 256), (65600, 128, 2))
# the fused chain's combined taps are built in float64 and summed in another
# order than the staged chain: relative error below 1e-4 against |a| + 1e-3,
# as tests/test_fused_chain.py holds the TPU kernel
REL_TOL = 1e-4
SPLIT_ATOL = 1e-5
# K2's FM instance against the torch discriminator on the same planes: two
# float32 ulps of |fm| ≤ 5 (tests/test_torch_chzfm.py's Freqdem bound)
FM_PLAIN_TOL = 1e-6

# config[4] (M4 channels, T4 analyzer steps per block, the bank CHZ, the FM
# factor KF) comes from yagi_tpu_torch/tools/paths.py too. K2's other
# shapes, each against its plain version: (m of the Kaiser bank, or None for
# p = 1 random taps; steps). 20,002 steps are 626 tiles of 32, 2 or 3 a
# persistent block, the last tile 2 steps long
CHZ_SHAPES = ((4, 256), (33, 256), (33, 768), (None, 2), (None, 20002), (4, 20002),
              (33, 20002))
# The channelizer's outputs have an rms of ~11 and fp32 sums leave ~1e-5 of
# absolute error, so error is held relative to the block's rms: at 2^21
# outputs a few lie within 0.01 of 0, where |a − b| / (|a| + 1e-3) reaches
# ~1e-3 without any fault (PERF.md). The per-sample figure is printed too.
CHZ_TOL = 1e-4
# FM outputs compare by wrapped phase (radians) where both discriminator
# inputs are at least 5% of the block's rms: arg() is ill-conditioned near 0
FM_TOL, FM_MAG = 1e-4, 0.05
# K5 (tests/test_native_kernels.py): |a − b| <= MIX_TOL·(1 + |b|)
N_MIX = 1 << 21
MIX_TOL = 1e-6
MIX_PHASE = 1.1

# config[1] (bench.py:160-192) and config[3] (bench.py:221-242): the shapes
# and constructors of yagi_tpu_torch/tools/paths.py, shared with the tools
# that time these paths
N_SYM_CHECK = 4  # config[1] blocks held against the XLA-form scan
N_PALLAS = 4  # config[1] blocks through K4
SYM_SPLIT = 2000  # where the block-split check cuts a resampled block
# the resampler's kernel against its plain version computed in float64: the
# kernel's float32 sums of 14 taps, like the plain version's own, read up to
# ~1e-6 of the rms from it over these 16 blocks of random input (64M outputs)
RESAMP_TOL = 2e-6
# K3 sums its dots in the order branch_outputs reproduces, and K4 and the
# XLA-form scan read branch_outputs' stream, so all three are held to bit
# identity (kernels/symscan.py says why one order: through the loop's
# feedback, dots an ulp apart part whole channels).

QAM_SMALL = (64, 512)  # the kernels' small check shape (C, n)
QAM_LONG = (64, 512)  # (C, n) of the long-equalizer checks: 1024 slots
N_QAM = 8  # main-path blocks
N_QAM_PLAIN = 2  # of them held against the all-plain chain (~10 s a block)
QAM_SPLIT = 2000  # where the block-split check cuts a block
N_QAM_SIG = 3  # blocks of the impaired 16-QAM signal
# the impaired channel of tests/test_qamrx.py:69-88, and its pass marks
QAM_GAIN, QAM_PHASE, QAM_CFO, QAM_NOISE = 0.5, 0.3, 1e-4, 0.002
QAM_ECHO, QAM_ECHO_DELAY = 0.1 * np.exp(1j * 1.1), 3
QAM_EVM_DB, QAM_THETA_MIN, QAM_TAIL = -25.0, 0.05, 800
# A few channels in a thousand acquire wrongly: the equalizer settles between
# symbol instants (tail EVM stuck near −12 dB) or the carrier loop locks a
# quarter turn off (SER ~0.92 at a good EVM). yagi_tpu's QamRx does the same
# on the same input, and which channels do is chaotic, an ulp in the
# acquisition can decide it (PERF.md §6); so up to this share of the
# channels may miss the SER and EVM marks, each one printed.
QAM_FALSE_LOCK_MAX = 0.005

# config[2] (bench.py:199-218): FmStereoRx over C2 channels, blocks of T2
# (tools/paths.py), its two de-emphasis IIRs on iir_chunked. iir_scan rounds
# every op alone in one order, so it is held to bit identity; iir_chunked
# runs the same recurrence in another summation order and is held as
# tests/test_iir_parallel.py holds yagi_tpu's parallel route: max |a − b| /
# max |a| below 2e-5 (TF, first order included) or 1e-4 (Butterworth and
# integrator SOS), a block split below 1e-5.
IIR_TF_TOL, IIR_SOS_TOL, IIR_SPLIT_TOL = 2e-5, 1e-4, 1e-5
# fir_block against its plain version (the banded matmul, cuBLAS, TF32 off):
# L float32 products summed in two orders, over the plain output's largest
# magnitude; the chain's pilot level, a mean of 2^14 magnitudes, over its own
FIR_TOL, FM_LEVEL_TOL = 1e-5, 1e-6
FIR_SPLIT = 1000  # where the block-split check cuts a config[2] block
N_FM_SEQ = 4  # config[2] blocks on the sequential route (iir_scan)
# iir_scan's checks: (form, taps (TF) or sections (SOS), type, C, T). Every
# instance runs: TF lengths 1, 2, 3 (orders 0, 1, 2, specialised) in each
# signal type, 4 to 9 (the generic register instance, 9 its largest), 10
# (the ring in shared memory) and 3200 (complex: the ring in device memory);
# SOS 1 to 4 sections (specialised; the 8th-order integrator is 4) and 5, 7
# (the ring). T below a 16-byte group, not a multiple of one, across slabs
# (256 samples) with a ragged last one, and T2.
IIR_SCAN_CASES = (("tf", 2, "rrrf", C2, T2), ("tf", 2, "rrrf", 1, 1), ("tf", 2, "crcf", 3, 1001),
                  ("tf", 2, "cccf", 5, 517),
                  ("tf", 1, "rrrf", 3, 1001), ("tf", 1, "crcf", 3, 130), ("tf", 1, "cccf", 3, 129),
                  ("tf", 3, "rrrf", 3, 1001), ("tf", 3, "crcf", 3, 127), ("tf", 3, "crcf", C2, 1),
                  ("tf", 3, "cccf", 9, 600),
                  ("tf", 5, "cccf", 3, 129), ("tf", 7, "rrrf", C2, 129), ("tf", 7, "cccf", 1, 127),
                  ("tf", 9, "crcf", 3, 1001), ("tf", 10, "rrrf", 3, 129),
                  ("tf", 10, "cccf", 3, 127), ("tf", 3200, "cccf", 2, 3),
                  ("sos", 1, "rrrf", 3, 129), ("sos", 1, "crcf", C2, 127),
                  ("sos", 2, "rrrf", 3, 1001), ("sos", 3, "crcf", 3, 600),
                  ("sos", "integrator", "rrrf", 3, 129), ("sos", 4, "crcf", 1, 127),
                  ("sos", 4, "rrrf", 9, 1001), ("sos", 5, "rrrf", 3, 129),
                  ("sos", 7, "crcf", 3, 127))
# iir_chunked's checks: (form, taps or sections, type, C, T): orders 1 and 2
# (specialised) in each signal type, 0, 4 and 8 (generic); T = 1, T below
# one chunk (32), T not a multiple of the chunk, of a 16-byte group or of the
# 4096-sample segment, T across three segments and more with a ragged last
# one, T2; C not a multiple of any grouping, and 1001 channels, more blocks
# than the card holds at once (a second wave); a pole at
# radius 0.995 ("tfslow", first order: at order 2 such poles part the two
# float32 plain versions by 5.7e-5, more than the tolerance), whose carry
# reaches across warps; SOS stages of order 2 (the integrator's poles lie on
# the unit circle); TF order 9 is past the chunked kernel and runs iir_scan
IIR_CHUNK_CASES = (("tf", 2, "rrrf", C2, T2), ("tf", 2, "rrrf", 3, 1), ("tf", 2, "crcf", 3, 20),
                   ("tf", 2, "cccf", 5, 12389), ("tf", 2, "rrrf", 1001, 300),
                   ("tf", 1, "rrrf", 3, 1000),
                   ("tf", 3, "rrrf", 3, 8292), ("tf", 3, "crcf", 5, 12389),
                   ("tf", 3, "cccf", 3, 1000), ("tf", 5, "crcf", 3, 5000),
                   ("tf", 9, "rrrf", 3, 1000), ("tf", 9, "cccf", 2, T2),
                   ("tfslow", 2, "rrrf", 3, 12389), ("tfslow", 2, "crcf", 5, 9000),
                   ("tfslow", 2, "cccf", 3, 5000),
                   ("sos", "lowpass7", "rrrf", 3, 8292), ("sos", "lowpass7", "crcf", 5, T2),
                   ("sos", "integrator", "rrrf", 3, 1000), ("tf", 10, "rrrf", 3, 300))
# The FFT layer: the reference's golden vectors (tests/test_fft.py:38's sizes)
# at its tolerance 2e-4; a Spgram of a config[4] block (8192 frames summed)
# on the card against the CPU: cuFFT and pocketfft and two summation orders
# part the PSD by ~1e-6 relative, held to 1e-4 per bin
FFT_SIZES = (2, 3, 4, 5, 6, 7, 8, 9, 10, 16, 17, 20, 21, 22, 24, 26, 30, 32, 35, 36,
             43, 48, 63, 64, 79, 92, 96, 120, 130, 157, 192, 317, 509)
FFT_TOL = 2e-4
SPGRAM_NFFT, SPGRAM_TOL = 1024, 1e-4
# The streaming filters of layer L4 at config[1]'s width (C1 channels,
# blocks of T1 samples; one of them empty, the state carried), seed 2:
# the streamed run against one long block on the card, and its first
# FILTER_CUT channels against the CPU, each within its CPU test's
# tolerance: 1e-5 of max(1, |y|) (tests/test_torch_filters_l4.py); the
# Farrow values 1e-4 against the same split on the CPU, and 0.03 against one
# long block, whose emissions at the block edges take the exact branch dot
# in the split run and the Farrow values in the long one: the Farrow-vs-PFB
# tolerance (tests/test_torch_farrow.py, tests/test_farrow_resamp.py)
FILTER_BLOCKS = (T1, 0, T1, T1)
FILTER_CUT = 64
FILTER_TOL, FARROW_TOL, FARROW_SPLIT_TOL = 1e-5, 1e-4, 0.03
# The empty-block repairs (tests/test_torch_empty_block.py's objects, batch
# (2,), seed 3): blocks [0, EMPTY_N] equal the block of EMPTY_N alone
EMPTY_N = 64
N_FILTER_TIMED = 10  # eager calls timed per object
# [capture]: config[4]'s stream (bench.py's seed 1, N_BLOCKS blocks of
# M4·T4 = 2^21 samples) quantized to ci16 as tests/test_native_kernels.py
# does, full scale at 8σ of the samples (×1/8, exact), written to a file under
# build/ and streamed through IqStreamLoader into K2 → Freqdem; the same
# dequantized samples also fed from memory. Each feed bit-identical to the
# other. The loader's round trip in every format at CAPTURE_TAIL samples in
# blocks of CAPTURE_TAIL_BLOCK (an EOF tail); rates over N_CAPTURE_TIMED runs.
CAPTURE_SCALE = 1.0 / 8
CAPTURE_TAIL, CAPTURE_TAIL_BLOCK = 7000, 2048
N_CAPTURE_TIMED = 3
# [l0]: the samplers of yagi_tpu_torch.random at L0_N draws on a CUDA
# generator, held to their own cdf at the deciles within L0_DECILE_TOL
# (tests/test_aux.py:80-87); cawgn's power within 5%; dotprod on the card
# against the CPU at tests/test_aux.py:523-560's lengths within
# L0_DOT_RTOL·Σ|a·b|; Modem.random_symbols for M = 16 at L0_N, a chi-square
# of its 16 counts below the 0.001 point of 15 degrees of freedom; OrdFilt
# on complex64 at config[1]'s width, card equal to CPU bit for bit.
L0_N = 1 << 22
L0_DECILE_TOL, L0_CAWGN_TOL, L0_DOT_RTOL = 0.02, 0.05, 1e-6
L0_CHI2_15_999 = 37.697
L0_DOT_LENGTHS = (1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 32, 35, 64, 79)
L0_ORD_BLOCKS = (T1, 0, T1)
# [modems]: layers L3, L5 and L6 and the channel models at full width, MOD_C
# channels (EQRLS_C for the RLS equalizer), MOD_BLOCKS blocks each with the
# state carried, inputs from numpy seed MOD_SEED and the noise drawn once on
# the card (fed to the CPU side as well); MOD_CUT channels held against the
# port's CPU run of the same blocks, and blocks [N, 0, N] against one of 2N.
# Float32 streams within MOD_TOL (the CPU tests' 1e-5); decisions exactly;
# 12-bit ADC codes within one code; soft bytes within one, on the same side
# of 127. What a float32 cumulative product or sum over n samples makes (the
# differential modulators' rotation, the GMSK and CPFSK phases) within
# 1e-6 + 8·√n ulps of its largest magnitude (cum_tol: the CPU's sequential
# order and the card's scan round apart as a random walk; decisions exact).
# The widths (MOD_C, QAM_SYMS, GMSK_BITS, CPFSK_SYMS, FSK_SYMS, AM_N, OSC_N,
# EQRLS_*) come from tools/paths.py; GMSK k 2, m 3, bt 0.3; CPFSK bps 2,
# h 0.5, k 4, square pulse; FSK M 4, k 8, bandwidth 0.2.
MOD_CUT, MOD_BLOCKS, MOD_SEED = 16, 4, 13
MOD_SNR_DB = 30.0
MOD_TAPS = (1.0, 0.1j, -0.05)  # the 16-QAM link's 3-tap multipath (and OFDM's)
MOD_DPHI, MOD_PHI = 0.01, 0.3  # the link's carrier offset (rad/sample) and phase
MOD_ADC_BITS, MOD_ADC_GAIN = 12, 0.5  # the link's quantizer, I and Q at 0.5 of the samples
MOD_TOL = 1e-5
QAM_SER_MAX = 1e-4  # the link's symbol error rate (ISI 0.2 < the 0.32 half distance)
EPS32 = float(np.finfo(np.float32).eps)
AM_MU, AM_M, AM_BW = 0.5, 25, 0.01
# the message follows the carrier's phase at gain (1 + mu)/mu: twice the
# carrier tracker's IIR_TF_TOL through that gain
AM_TOL = 2 * IIR_TF_TOL * (1 + AM_MU) / AM_MU
AM_SETTLE, AM_MSG_TOL = 2048, 0.05  # samples before the message is held; rms error
PLL_STEPS, PLL_BW, PLL_MAX_F, PLL_LOCK_TOL = 4096, 0.02, 0.05, 1e-3
EQRLS_TOL, EQRLS_RMS_MAX = 1e-4, 0.1  # tests/test_torch_eqrls_quant.py's 1e-4
OFDM_M, OFDM_CP, OFDM_SYMS, OFDM_LEAD, OFDM_CFO = 64, 16, 256, 137, 0.004
OFDM_TOL, OFDM_EVM_MAX = 1e-6, -20.0  # complex128 inside, complex64 out
N_MOD_TIMED = 5  # eager calls timed per object
# [framing]: fec/ and framing/'s packet layer (no kernel). Sizes, seeds and
# the impaired bursts come from tools/paths.py. FEC: a flipped bit every
# FEC_CONV_GAP coded bits of a convolutional code (its free distance 10 at
# rate 1/2 and 3 at rate 7/8 correct one such error per window), soft levels
# at FEC_SOFT_DB Es/N0 per coded bit; card equal to CPU exactly (the
# Viterbi's float32 arithmetic is the same on both). frame64: FRAME_CUT
# frames against the CPU, bytes and flags exactly; the stats within
# FRAME_STAT_TOL: the correlation surfaces are complex64 FFTs from two
# libraries (cuFFT, pocketfft), which round apart by ~log2(nfft)·2^-24 ≈
# 8e-7 of the peak, and the quadratic interpolation divides that by the
# peak's curvature (~0.1 of the peak and more for these pulses): tau within
# 1e-4 samples, dphi 1e-6 rad/sample (the hypothesis spacing 3.3e-3 times
# that error), phi 1e-5 rad, gamma and rxy 1e-5 relative, evm_db 1e-3 dB
# (tests/test_torch_framing.py's, measured against yagi_tpu at ~1e-7).
# SymStreamR against the CPU within STREAM_TOL (float32 filters in two
# summation orders, the CPU tests' 1e-5), its block split within
# STREAM_SPLIT_TOL.
FEC_CONV_GAP, FEC_SOFT_DB = 96, 6.0
FRAME_CUT, FRAME_NOISE, N_FRAME_TIMED = 8, 8, 4
FRAME_DPHI_TOL = 1e-3  # tests/test_framing2.py's bound
FRAME_STAT_TOL = {"tau": 1e-4, "dphi": 1e-6, "phi": 1e-5, "gamma": 1e-5, "rxy": 1e-5,
                  "evm_db": 1e-3}
STREAM_CUT, STREAM_SPLIT = 1 << 14, 1 << 16
STREAM_TOL, STREAM_SPLIT_TOL = 1e-5, 1e-6

# The AGC and eq/carrier loops feed their decisions back, so kernel and plain
# version are held to bit identity (kernels/agc.py, kernels/qam.py): every
# op rounded alone, one evaluation order.

# Peak rates of one H100 SXM (NVIDIA's data sheet): HBM3 bytes/s, and fp32
# FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

_COUNTS_FROM: dict = {}  # each kernel wrapper's launches at the last reset_counts()


def reset_counts() -> None:
    _COUNTS_FROM.update(trace.launches())


def read_counts() -> dict:
    """Each kernel wrapper's launches since :func:`reset_counts`, from the
    program's registry of kernel wrappers."""
    return {k: n - _COUNTS_FROM.get(k, 0) for k, n in trace.launches().items()}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs() / (a.abs() + 1e-3)).max().item()


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| over the rms of a."""
    return ((a - b).abs().max() / a.abs().square().mean().sqrt()).item()


def planes(rng, shape, device) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)


def fm_phase_err(fm_a, fm_b, y, y_prev_last) -> tuple[float, float]:
    """Largest wrapped phase difference (rad) between two FM outputs where
    both discriminator inputs have magnitude >= FM_MAG of the block's rms,
    and the share of samples that qualify."""
    mag = y.abs()
    mag_prev = torch.cat([y_prev_last.abs()[:, None], mag[:, :-1]], dim=1)
    floor = FM_MAG * mag.square().mean().sqrt()
    keep = (mag >= floor) & (mag_prev >= floor)
    d = torch.remainder((fm_a - fm_b).double() * (2 * np.pi * KF) + np.pi, 2 * np.pi) - np.pi
    return d.abs()[keep].max().item(), keep.double().mean().item()


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(work: tuple[float, float]) -> tuple[float, str]:
    """The least time (ms) the card could take for (bytes, operations): each
    input byte read once and each output byte written once at the HBM rate,
    or the operations at the fp32 rate, whichever is longer, and which."""
    t_bytes, t_ops = work[0] / HBM_BYTES_PER_S * 1e3, work[1] / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensors_of(obj) -> list[torch.Tensor]:
    """Every tensor of a state object, nested state objects included."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out += tensors_of(v)
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out


def phase_device() -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] torch: {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    path, log = _build.build()
    _build.library()
    dt = time.perf_counter() - t0
    print(f"[build] {path.name} in {dt:.2f} s ({' '.join(_build.NVCC_FLAGS)})")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"[build] {line.strip()}")


def phase_default_device() -> None:
    """Entry points called without a device build on the current card."""
    want = str(torch.device("cuda", torch.cuda.current_device()))
    for name, rx in (("QamRx", QamRx.create(batch_shape=(4,))),
                     ("FmStereoRx", FmStereoRx.create(batch_shape=(4,)))):
        devices = sorted({str(t.device) for t in tensors_of(rx)})
        print(f"[default-device] {name}.create() with no device: its {len(tensors_of(rx))} "
              f"tensors lie on {devices}")
        require(devices == [want], f"{name}: default device {devices}, want [{want}]")


def kernel_inputs(rng, c: int, t: int, mix_freq: float, device, rate: float = 2.0):
    """Arguments of fused_chain_apply with random planes and history and a
    nonzero start phase; the rate; the compact taps the kernel reads."""
    chain = make_fused(c, device, mix_freq=mix_freq, rate=rate)
    xr, xi, hr, hi = (planes(rng, s, device) for s in [(c, t), (c, t), (c, 128), (c, 128)])
    theta0 = torch.tensor(0x9E3779B9, dtype=torch.int64, device=device)
    return (xr, xi, chain.g, hr, hi, theta0, chain.d_theta), chain.p, chain.taps


def phase_kernel_vs_plain(device) -> dict:
    """K1 against fused_chain_reference, on planes and on interleaved
    complex64 (whose values must equal the planar kernel's bit for bit), at
    CHAIN_SHAPES and at config[0]; returns max |error| at config[0] per layout."""
    rng = np.random.default_rng(SEED)
    max_abs = {"chain_fp32": 0.0, "chain_c64": 0.0}
    for c, t, rate in CHAIN_SHAPES + ((C, T, 2),):
        for mix in (0.0, MIX_FREQ) if (c, t) in ((3, 2048), (C, T)) else (MIX_FREQ,):
            args, p, taps = kernel_inputs(rng, c, t, mix, device, rate)
            kr, ki = fused_chain_apply(*args, p=p, taps=taps)
            kc = fused_chain_apply_c64(torch.complex(args[0], args[1]), *args[2:], p=p, taps=taps)
            rr, ri = fused_chain_reference(*args, p=p)
            a, b = torch.complex(rr, ri), torch.complex(kr, ki)
            err = rel_err(a, b)
            abs_err = (a - b).abs().max().item()
            require(tuple(b.shape) == tuple(kc.shape) == (c, t * p),
                    f"kernel output shape {tuple(b.shape)}")
            require(bool(torch.isfinite(b).all()), "kernel output finite")
            same = torch.equal(torch.view_as_real(kc), torch.view_as_real(b))
            print(f"[kernel-vs-plain] chain_fp32 C={c} T={t} P={p} mix={mix}: "
                  f"max rel err {err:.3e} (< {REL_TOL}), max abs err {abs_err:.3e}; "
                  f"complex64 layout bit-identical to the planar {same}")
            require(err < REL_TOL, f"kernel vs plain at C={c} T={t} P={p} mix={mix}: {err}")
            require(same, f"complex64 layout vs planar at C={c} T={t} P={p}")
            if (c, t) == (C, T):
                max_abs = {k: max(v, abs_err) for k, v in max_abs.items()}
    return max_abs


def phase_main_path(device) -> dict:
    """Stream N_BLOCKS config[0] blocks through FusedRxChain.step (the
    interleaved kernel), then through step_planar (the planar one); returns
    each kernel's launches in its own run."""
    rng = np.random.default_rng(SEED + 1)
    blocks = [complex_block(rng, (C, T), device) for _ in range(N_BLOCKS)]
    fused = make_fused(C, device)
    rx = RxChain.create(**CHAIN, mix_freq=MIX_FREQ, batch_shape=(C,), device=device)

    torch.cuda.synchronize()
    reset_counts()
    outs = []
    for x in blocks:
        y, k, fused = fused.step(x)
        outs.append((y, k))
    torch.cuda.synchronize()
    counts = read_counts()
    launches = {"chain_c64": counts["fused_chain_apply_c64"]}
    print(f"[main-path] FusedRxChain.step: {N_BLOCKS} steps of [{C}, {T}] complex64, "
          f"kernel launches {counts}")
    require(launches["chain_c64"] == N_BLOCKS and counts["fused_chain_apply"] == 0,
            f"launches {counts}: want {N_BLOCKS} of fused_chain_apply_c64 only")

    # the same blocks as planes through step_planar: the same values
    planar = make_fused(C, device)
    split = [(x.real.contiguous(), x.imag.contiguous()) for x in blocks]
    torch.cuda.synchronize()
    reset_counts()
    p_outs = []
    for xr, xi in split:
        yr, yi, _, planar = planar.step_planar(xr, xi)
        p_outs.append((yr, yi))
    torch.cuda.synchronize()
    counts = read_counts()
    launches["chain_fp32"] = counts["fused_chain_apply"]
    same = all(torch.equal(y.real, yr) and torch.equal(y.imag, yi)
               for (y, _), (yr, yi) in zip(outs, p_outs))
    print(f"[main-path] FusedRxChain.step_planar: {N_BLOCKS} steps, kernel launches {counts}; "
          f"step's values bit-identical to step_planar's {same}")
    require(launches["chain_fp32"] == N_BLOCKS and counts["fused_chain_apply_c64"] == 0,
            f"launches {counts}: want {N_BLOCKS} of fused_chain_apply only")
    require(same and not state_diff(fused, planar), "step vs step_planar, values and state")
    del p_outs, split

    worst = 0.0
    for i, (x, (y, k)) in enumerate(zip(blocks, outs)):
        y_ref, k_ref, rx = rx.step(x)
        k_ref = int(k_ref)
        require(k == k_ref == 2 * T, f"block {i}: counts {k}, {k_ref}, want {2 * T}")
        require(tuple(y.shape) == (C, 2 * T), f"block {i}: shape {tuple(y.shape)}")
        require(bool(torch.isfinite(y).all()), f"block {i}: finite output")
        err = rel_err(y_ref[:, :k_ref], y)
        require(err < REL_TOL, f"block {i}: fused vs RxChain rel err {err}")
        require(bool((y_ref[:, k_ref:] == 0).all()), f"block {i}: RxChain zero tail")
        worst = max(worst, err)
    print(f"[main-path] FusedRxChain vs RxChain over {N_BLOCKS} blocks: "
          f"max rel err {worst:.3e} (< {REL_TOL}), k = 2T = {2 * T}")

    # one 2T block equals two T blocks: the carried state is exact
    x2 = torch.cat(blocks[:2], dim=-1)
    mk = lambda: make_fused(C, device)  # noqa: E731
    y_all, _, _ = mk().step(x2)
    y_a, _, c2 = mk().step(blocks[0])
    y_b, _, _ = c2.step(blocks[1])
    split = (y_all - torch.cat([y_a, y_b], dim=-1)).abs().max().item()
    print(f"[main-path] block split 2T vs T+T: max abs diff {split:.3e} (<= {SPLIT_ATOL})")
    require(split <= SPLIT_ATOL, f"block split {split}")
    return launches


def phase_timing(device, card: str) -> dict:
    """CUDA-event times at config[0]; returns {name: (kernel ms, plain ms)}
    for the planar and the interleaved kernel, device time per call from
    graph replay."""
    rng = np.random.default_rng(SEED + 2)
    # N_ROT input sets (64 MB of input) so the 50 MB L2 cannot hold the
    # input between calls, as in a stream of fresh blocks
    sets = [kernel_inputs(rng, C, T, MIX_FREQ, device) for _ in range(N_ROT)]
    p, taps = sets[0][1:]
    csets = [(torch.complex(a[0], a[1]),) + a[2:] for a, _, _ in sets]
    kernel = [lambda a=a: fused_chain_apply(*a, p=p, taps=taps) for a, _, _ in sets] * 5
    kernel_c = [lambda a=a: fused_chain_apply_c64(*a, p=p, taps=taps) for a in csets] * 5
    plain = [lambda a=a: fused_chain_reference(*a, p=p) for a, _, _ in sets] * 5
    # the interleaved kernel's plain version: the planes' views, then a join
    plain_c = [lambda a=a: torch.complex(*fused_chain_reference(a[0].real, a[0].imag, *a[1:],
                                                                p=p)) for a in csets] * 5
    # alternate plain, kernel, kernel, plain so drift hits both alike
    p1, k1, c1, c2, k2, p2 = (graph_ms(f) for f in (plain, kernel, kernel_c, kernel_c, kernel,
                                                     plain))
    pc_ms = graph_ms(plain_c)
    k_ms, c_ms, p_ms = (k1 + k2) / 2, (c1 + c2) / 2, (p1 + p2) / 2
    k_eager = cuda_ms(kernel[0], 200)
    print(f"[timing] {card}: chain_fp32 kernel {k_ms:.4f} ms/step ({k1:.4f}, {k2:.4f}), on "
          f"complex64 {c_ms:.4f} ({c1:.4f}, {c2:.4f}); fused_chain_reference {p_ms:.4f} ms/step "
          f"({p1:.4f}, {p2:.4f}), on complex64 views {pc_ms:.4f}; device time from graph "
          f"replay at [{C}, {T}] P={p}. Eager kernel calls: {k_eager:.4f} ms/call")
    return {"chain_fp32": (k_ms, p_ms), "chain_c64": (c_ms, pc_ms)}


def phase_kernel_vs_plain_channelizer(device) -> float:
    """K2 against fused_channelizer_reference with a random history, at
    config[4]'s bank (p = 8), at p = 66, which runs the instance that walks
    the taps in tiles, at p = 1 (random taps), and at T = 20,002 steps, which
    the persistent blocks split unevenly with a short last tile; returns max
    |error| at config[4]."""
    rng = np.random.default_rng(SEED + 10)
    max_abs = 0.0
    for m, t in CHZ_SHAPES + ((4, T4),):
        if m is None:  # one random tap a branch
            tables = channelizer_tables(rng.standard_normal((M4, 1)), 1.0)
            taps, hr, hi = (torch.from_numpy(a).to(device) for a in tables)
            p, r2, nh = 1, 1, halo_rows(1) * 128
        else:
            fz = FusedChannelizer.create_kaiser(**{**CHZ, "m": m}, device=device)
            taps, hr, hi, p, nh = fz.taps, fz.hr, fz.hi, fz.p, fz.hist_r.shape[0]
            r2 = fz.r2 if t == T4 else 1
        n = t * M4
        args = (planes(rng, n, device), planes(rng, n, device), taps, hr, hi,
                planes(rng, nh, device), planes(rng, nh, device))
        kr, ki = fused_channelizer_apply(*args, p=p, r2=r2)
        rr, ri = fused_channelizer_reference(*args, p=p)
        a, b = torch.complex(rr, ri), torch.complex(kr, ki)
        require(tuple(b.shape) == (t, M4), f"channelizer output shape {tuple(b.shape)}")
        require(bool(torch.isfinite(b).all()), "channelizer output finite")
        err, abs_err = rel_rms(a, b), (a - b).abs().max().item()
        print(f"[kernel-vs-plain] channelizer_fp32 T={t} p={p}: max abs err {abs_err:.3e} "
              f"= {err:.3e} of the rms (< {CHZ_TOL}); per-sample rel err (|a| + 1e-3) "
              f"{rel_err(a, b):.3e}")
        require(err < CHZ_TOL, f"channelizer kernel vs plain at T={t}, p={p}: {err}")
        require(m != 33 or p == 66, f"m = 33 gives p = {p}")
        if t == T4:
            max_abs = abs_err
    return max_abs


def phase_kernel_vs_plain_mix(device) -> float:
    """K5 against mix_down_reference from a nonzero phase; returns max
    |error| at n = N_MIX."""
    rng = np.random.default_rng(SEED + 11)
    osc = Osc.create("exact", device=device).set_frequency(MIX_FREQ).set_phase(MIX_PHASE)
    max_abs = 0.0
    for n in (32768, N_MIX):
        x = complex_block(rng, (n,), device)
        y = mix_down_apply(x, osc.theta, osc.d_theta)
        ref = mix_down_reference(x, osc.theta, osc.d_theta)
        require(tuple(y.shape) == (n,) and y.dtype == torch.complex64, "mix-down output")
        abs_err = (y - ref).abs().max().item()
        over = ((y - ref).abs() - MIX_TOL * (1 + ref.abs())).max().item()
        print(f"[kernel-vs-plain] mix_down n={n} theta0={int(osc.theta)}: max abs err "
              f"{abs_err:.3e} (<= {MIX_TOL}·(1 + |a|))")
        require(over <= 0, f"mix-down kernel vs plain at n={n}: {abs_err}")
        max_abs = abs_err
    return max_abs


def phase_main_path_config4(device) -> int:
    """Stream N_BLOCKS config[4] blocks through FusedChannelizer → Freqdem;
    returns the K2 launches of that run."""
    rng = np.random.default_rng(SEED + 12)
    n = T4 * M4
    blocks = [(planes(rng, n, device), planes(rng, n, device)) for _ in range(N_BLOCKS)]
    fz = FusedChannelizer.create_kaiser(**CHZ, device=device)
    dem = Freqdem.create(KF, batch_shape=(M4,), device=device)

    torch.cuda.synchronize()
    reset_counts()
    outs = []
    for xr, xi in blocks:
        yr, yi, fz = fz.analyzer_execute_planar(xr, xi)
        fm, dem = dem.demodulate(torch.complex(yr, yi).T)  # channel-major view
        outs.append((yr, yi, fm))
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["fused_channelizer_apply"]
    print(f"[main-path] FusedChannelizer -> Freqdem: {N_BLOCKS} blocks of {n} complex "
          f"samples (M={M4}, T={T4}, kf={KF}), kernel launches {counts}")
    require(launches == N_BLOCKS, f"launches {launches} != blocks {N_BLOCKS}")

    ref = Firpfbch.create_kaiser(M4, CHZ["m"], CHZ["as_"], device=device)
    dem_ref = Freqdem.create(KF, batch_shape=(M4,), device=device)
    prev = torch.zeros(M4, dtype=torch.complex64, device=device)
    worst, worst_fm, kept = 0.0, 0.0, 1.0
    for i, ((xr, xi), (yr, yi, fm)) in enumerate(zip(blocks, outs)):
        y = torch.complex(yr, yi).T
        y_ref, ref = ref.analyzer_execute(torch.complex(xr, xi))
        fm_ref, dem_ref = dem_ref.demodulate(y_ref)
        require(tuple(y.shape) == tuple(fm.shape) == (M4, T4), f"block {i}: shapes")
        require(bool(torch.isfinite(y).all() & torch.isfinite(fm).all()), f"block {i}: finite")
        err = rel_rms(y_ref, y)
        require(err < CHZ_TOL, f"block {i}: FusedChannelizer vs Firpfbch {err}")
        fm_err, share = fm_phase_err(fm, fm_ref, y_ref, prev)
        require(fm_err <= FM_TOL, f"block {i}: FM phase error {fm_err} rad")
        worst, worst_fm, kept = max(worst, err), max(worst_fm, fm_err), min(kept, share)
        prev = y_ref[:, -1]
    print(f"[main-path] FusedChannelizer vs Firpfbch over {N_BLOCKS} blocks: max abs err "
          f"{worst:.3e} of the rms (< {CHZ_TOL}); FM vs Firpfbch -> Freqdem: max wrapped "
          f"phase err {worst_fm:.3e} rad (<= {FM_TOL}) over >= {kept:.4f} of the samples "
          f"(both inputs >= {FM_MAG} of the rms)")

    # one 2N block equals two N blocks: the carried state is exact
    def run(chunks):
        fz = FusedChannelizer.create_kaiser(**CHZ, device=device)
        dem = Freqdem.create(KF, batch_shape=(M4,), device=device)
        ys, fms = [], []
        for xr, xi in chunks:
            yr, yi, fz = fz.analyzer_execute_planar(xr, xi)
            fm, dem = dem.demodulate(torch.complex(yr, yi).T)
            ys.append(torch.complex(yr, yi).T)
            fms.append(fm)
        return torch.cat(ys, dim=-1), torch.cat(fms, dim=-1)

    y_all, fm_all = run([(torch.cat([blocks[0][0], blocks[1][0]]),
                          torch.cat([blocks[0][1], blocks[1][1]]))])
    y_two, fm_two = run(blocks[:2])
    split = (y_all - y_two).abs().max().item()
    fm_split = (fm_all - fm_two).abs().max().item()
    print(f"[main-path] block split 2N vs N+N: channels max abs diff {split:.3e} "
          f"(<= {SPLIT_ATOL}), FM max abs diff {fm_split:.3e}")
    require(split <= SPLIT_ATOL, f"block split {split}")
    fm_err, _ = fm_phase_err(fm_all, fm_two, y_all, torch.zeros_like(prev))
    require(fm_err <= FM_TOL, f"FM block split {fm_err} rad")
    return launches


def phase_mix_path(device) -> int:
    """Stream N_BLOCKS blocks of N_MIX samples through mix_down_apply with
    the u32 phase carried; returns the K5 launches of that run."""
    rng = np.random.default_rng(SEED + 13)
    blocks = [complex_block(rng, (N_MIX,), device) for _ in range(N_BLOCKS)]
    osc = Osc.create("exact", device=device).set_frequency(MIX_FREQ).set_phase(MIX_PHASE)
    theta, dtheta = osc.theta, osc.d_theta

    torch.cuda.synchronize()
    reset_counts()
    outs = []
    for x in blocks:
        outs.append(mix_down_apply(x, theta, dtheta))
        theta = (theta + N_MIX * dtheta) & U32
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["mix_down_apply"]
    print(f"[main-path] mix_down_apply: {N_BLOCKS} blocks of {N_MIX} complex samples, "
          f"phase carried, kernel launches {counts}")
    require(launches == N_BLOCKS, f"launches {launches} != blocks {N_BLOCKS}")

    worst = 0.0
    for i, (x, y) in enumerate(zip(blocks, outs)):
        y_ref, osc = osc.mix_block_down(x)
        require(bool(((y - y_ref).abs() <= MIX_TOL * (1 + y_ref.abs())).all()),
                f"block {i}: mix_down_apply vs Osc.mix_block_down")
        worst = max(worst, (y - y_ref).abs().max().item())
    require(int(theta) == int(osc.theta), "carried phase")
    print(f"[main-path] mix_down_apply vs Osc.mix_block_down over {N_BLOCKS} blocks: "
          f"max abs err {worst:.3e}; carried phase equal")
    return launches


def phase_timing_config4(device, card: str) -> tuple[float, float]:
    """config[4]: K2 and its plain version by graph replay; returns (kernel
    ms, plain ms)."""
    rng = np.random.default_rng(SEED + 14)
    fz = FusedChannelizer.create_kaiser(**CHZ, device=device)
    n, nh = T4 * M4, fz.hist_r.shape[0]
    # N_ROT input sets (64 MB) so the 50 MB L2 cannot hold the input
    sets = [(planes(rng, n, device), planes(rng, n, device), fz.taps, fz.hr, fz.hi,
             planes(rng, nh, device), planes(rng, nh, device)) for _ in range(N_ROT)]
    kernel = [lambda a=a: fused_channelizer_apply(*a, p=fz.p, r2=fz.r2) for a in sets] * 5
    plain = [lambda a=a: fused_channelizer_reference(*a, p=fz.p) for a in sets] * 5
    p1, k1, k2, p2 = graph_ms(plain), graph_ms(kernel), graph_ms(kernel), graph_ms(plain)
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    k_eager = cuda_ms(kernel[0], 200)
    print(f"[timing] {card}: channelizer_fp32 kernel {k_ms:.4f} ms/block ({k1:.4f}, {k2:.4f}); "
          f"fused_channelizer_reference {p_ms:.4f} ms/block ({p1:.4f}, {p2:.4f}); device "
          f"time from graph replay at T={T4}, M={M4}, p={fz.p}. Eager kernel calls: "
          f"{k_eager:.4f} ms/call")
    return k_ms, p_ms


def phase_fm_epilogue(device, card: str) -> dict:
    """K2's FM instance (ChannelizerFmRx's step in one launch: the channels,
    the discriminator and the carried state) against its plain version (K2's
    plain instance, the torch discriminator ``fm_reference`` and the state's
    copies) from a random state, at config[4]'s block (N_ROT input sets) and
    at the benchmark cell's (2 sets): the channel planes and the state equal
    bit for bit, fm within FM_PLAIN_TOL; then both timed by graph replay in
    turns (plain, fm, fm, plain). Returns {steps: (fm ms, plain ms)}."""
    out = {}
    for t, sets in ((T4, N_ROT), (T4_CELL, 2)):
        fused, plain = chzfm_calls(device, t, sets)
        gap = 0.0
        for f, p in zip(fused, plain):
            got, want = f(), p()
            require(all(torch.equal(a, b) for i, (a, b) in enumerate(zip(got, want)) if i != 2),
                    f"FM instance at T={t}: channels or state differ from the plain instance's")
            gap = max(gap, (got[2] - want[2]).abs().max().item())
        print(f"[fm-epilogue] T={t}: channels and state bit for bit; largest |fm − plain| "
              f"{gap:.3e} (<= {FM_PLAIN_TOL})")
        require(gap <= FM_PLAIN_TOL, f"FM instance at T={t}: fm gap {gap}")
        reps = max(1, 20 // sets)
        p1, f1, f2, p2 = (graph_ms(calls * reps, reps=5) for calls in (plain, fused, fused, plain))
        out[t] = ((f1 + f2) / 2, (p1 + p2) / 2)
        print(f"[timing] {card}: config[4] step at T={t} (M={M4}, {M4 * t} samples): FM instance "
              f"{out[t][0]:.4f} ms ({f1:.4f}, {f2:.4f}); plain instance + torch discriminator "
              f"{out[t][1]:.4f} ms ({p1:.4f}, {p2:.4f}); graph replay in turns")
        del fused, plain
        torch.cuda.empty_cache()
    return out


def phase_timing_mix(device, card: str) -> tuple[float, float]:
    """K5 and its plain version by graph replay at n = N_MIX; returns
    (kernel ms, plain ms)."""
    rng = np.random.default_rng(SEED + 15)
    osc = Osc.create("exact", device=device).set_frequency(MIX_FREQ).set_phase(MIX_PHASE)
    xs = [complex_block(rng, (N_MIX,), device) for _ in range(N_ROT)]  # 64 MB
    kernel = [lambda x=x: mix_down_apply(x, osc.theta, osc.d_theta) for x in xs] * 5
    plain = [lambda x=x: mix_down_reference(x, osc.theta, osc.d_theta) for x in xs] * 5
    p1, k1, k2, p2 = graph_ms(plain), graph_ms(kernel), graph_ms(kernel), graph_ms(plain)
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"[timing] {card}: mix_down kernel {k_ms:.4f} ms/block ({k1:.4f}, {k2:.4f}); "
          f"mix_down_reference {p_ms:.4f} ms/block ({p1:.4f}, {p2:.4f}); device time from "
          f"graph replay at n={N_MIX}")
    return k_ms, p_ms


def as_bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 or complex64 tensor's bits as int32 (+0 and −0 apart);
    another tensor as it is."""
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def sym_same(what: str, got, want) -> bool:
    """Print and return whether (y, valid[, state]) equal bit for bit (y and
    the state as their bits), with the number of channels whose emission
    mask differs."""
    same = [torch.equal(as_bits(a), as_bits(b)) for a, b in zip(got, want)]
    masks = int((got[1] != want[1]).flatten(1).any(1).sum())
    err = (got[0] - want[0]).abs().max().item()
    print(f"{what}: bit-identical (values, valid[, state]) {same}; channels whose mask "
          f"differs {masks}; max abs err {err:.3e}; {int(got[1].sum())} emissions")
    return all(same)


def k3_counted(what: str, xa, g, n_valid, **kw):
    """K3 on these inputs, its chain-slot counter read around the call: the
    slots it ran its chain for must equal ``fused_chain_slots`` of its valid
    (slot 0, and a later slot where either channel of the warp emits); prints
    the skip share, the slots it did not run the chain for. Returns K3's
    result."""
    counter = trace.device_counter("symsync_fused.chain_slots", xa.device)
    before = int(counter.item())
    got = symsync_fused_apply(xa, g, n_valid, **kw)
    ran = int(counter.item()) - before
    want, slots = fused_chain_slots(got[1]), got[1].numel()
    print(f"{what}: K3 ran its chain in {ran} of {slots} slots (skip share "
          f"{1 - ran / slots:.4f}), {want} by its valid mask")
    require(ran == want, f"{what}: K3's chain-slot counter {ran}, its valid mask says {want}")
    return got


def sym_inputs(rng, ss: Symsync, c: int, n: int, device):
    """A random L-sample window and block, xa [c, n + L], and the taps."""
    L = ss.mf.shape[1]
    return complex_block(rng, (c, n + L), device), ss.taps()


def phase_kernel_vs_plain_symsync(device) -> tuple[float, float]:
    """K3 and K4 against their plain versions at C = 5, n = 9 (a partial
    K3 block, a short tile), C = 128, n = 256, three shapes with random taps
    whose L is not a multiple of 4 (C = 13, n = 300, L = 13: C not a
    multiple of K3's 8 channels per block, 3 tiles; C = 9, n = 129, L = 3:
    lanes with no tap; C = 13, n = 300, L = 37: taps past K3's unrolled 32,
    through its tail loop) and at config[1]'s C = 1024, n = 3976, with
    n_valid < n, bit for bit; returns (K3, K4) max |error| at config[1]."""
    rng = np.random.default_rng(SEED + 20)
    n1 = make_msresamp(C1, device).out_capacity(T1)
    errs = (0.0, 0.0)
    for c, n, n_valid, taps in [(5, 9, 6, None), (128, 256, None, None), (13, 300, None, 13),
                                (9, 129, 100, 3), (13, 300, 250, 37), (C1, n1, n1 - 11, None)]:
        ss = make_symsync(c, device)
        if taps is None:
            xa, g = sym_inputs(rng, ss, c, n, device)
        else:  # random taps of another length, the same loop
            xa = complex_block(rng, (c, n + taps), device)
            g = 0.3 * planes(rng, (2 * ss.npfb, taps), device)
        nv = None if n_valid is None else torch.tensor(n_valid, device=device)
        kw = dict(E=2, **ss.kernel_args())
        xs4 = branch_outputs(xa, g)
        k4 = symsync_scan_apply(xs4, nv, **kw), symsync_scan_reference(xs4, nv, **kw)
        del xs4
        k3 = (k3_counted(f"[kernel-vs-plain] symsync_fused (K3) C={c} n={n}", xa, g, nv, **kw),
              symsync_fused_reference(xa, g, nv, **kw))
        for name, (got, want) in (("symsync_fused (K3)", k3), ("symsync_scan (K4)", k4)):
            require(tuple(got[0].shape) == (c, n, 2) and bool(torch.isfinite(got[0]).all()),
                    f"{name} output shape and finiteness")
            require(sym_same(f"[kernel-vs-plain] {name} C={c} n={n} L={g.shape[1]} "
                             f"n_valid={n_valid}", got, want), f"{name} vs plain at C={c} n={n}")
        errs = tuple((got[0] - want[0]).abs().max().item() for got, want in (k3, k4))
    phase_symsync_scan_layouts(device)
    return errs


# K4 at P where its staged layout shrinks: (P, C, n); 7262 is the last P with
# a staged layout at E = 2, 7263 the first the direct instance takes
SCAN_SHAPES = ((256, 24, 300), (1024, 9, 70), (7262, 3, 40), (7263, 3, 40))


def phase_symsync_scan_layouts(device) -> None:
    """K4 against its plain version on random streams at SCAN_SHAPES, where
    scan_layout gives fewer rows a tile, fewer channels a block, one row of
    one channel, and None (the direct instance), bit for bit; the loop's
    arguments are config[1]'s with P replaced."""
    rng = np.random.default_rng(SEED + 24)
    for P, c, n in SCAN_SHAPES:
        kw = dict(E=2, **{**make_symsync(c, device).kernel_args(), "P": P})
        xs4 = 0.3 * planes(rng, (c, n, 4 * P), device)
        nv = torch.tensor(n - 5, device=device)
        got = symsync_scan_apply(xs4, nv, **kw)
        want = symsync_scan_reference(xs4, nv, **kw)
        require(tuple(got[0].shape) == (c, n, 2) and bool(torch.isfinite(got[0]).all()),
                "K4 output shape and finiteness")
        require(sym_same(f"[kernel-vs-plain] symsync_scan (K4) P={P} C={c} n={n} layout "
                         f"(chans, w, bytes) {scan_layout(P, 2)}", got, want),
                f"K4 vs plain at P={P}")


def phase_symsync_gate(device) -> None:
    """A bank past K3's shared memory (64 filters, k = 4, m = 22: L = 176) on
    backend "auto": taken by K4 by its shape, bit-identical to the XLA-form
    scan; "fused" refuses it before any launch."""
    rng = np.random.default_rng(SEED + 23)
    c, n = 24, 256
    ss = Symsync.create_rnyquist("rrcos", k=4, m=22, beta=0.3, num_filters=64, batch_shape=(c,),
                                 device=device).set_lf_bw(0.02)
    L, P = ss.mf.shape[1], ss.npfb
    require(not fused_fits(L, P) and fused_fits(28, 32), "the gate's arithmetic")
    x = complex_block(rng, (c, n), device)
    torch.cuda.synchronize()
    reset_counts()
    got = ss.execute_slots(x, backend="auto")
    torch.cuda.synchronize()
    counts = read_counts()
    want = ss.execute_slots(x, backend="xla")
    require(sym_same(f"[kernel-vs-plain] Symsync auto at L={L}, P={P} ({fused_smem_bytes(L, P)} "
                     f"bytes for K3 > {FUSED_SMEM_LIMIT}) C={c} n={n}, launches {counts}, vs the "
                     f"XLA-form scan", got[:2], want[:2]), "auto past K3's limit vs the XLA form")
    require(not state_diff(got[2], want[2]), "auto past K3's limit: carried state")
    require(counts["symsync_scan_apply"] == 1 and counts["symsync_fused_apply"] == 0,
            f"launches {counts}: want K4 once, K3 never")
    try:
        ss.execute_slots(x, backend="fused")
    except ConfigError as e:
        print(f"[kernel-vs-plain] Symsync fused at L={L}, P={P}: ConfigError: {e}")
    else:
        raise RuntimeError("check failed: backend='fused' past K3's limit did not raise")


def phase_main_path_config1(device) -> tuple[int, int, float]:
    """Stream N_BLOCKS config[1] blocks through MsResamp → Symsync (K3), then
    N_PALLAS through backend "pallas" (K4); returns (K3 launches, K4
    launches), each from its own run, and the emissions per K3 launch (the
    mean over the blocks)."""
    rng = np.random.default_rng(SEED + 21)
    blocks = [complex_block(rng, (C1, T1), device) for _ in range(N_BLOCKS)]

    def make():
        return make_msresamp(C1, device), make_symsync(C1, device)

    ms, ss = make()
    torch.cuda.synchronize()
    reset_counts()
    outs, states = [], []
    for x in blocks:
        states.append(ms.arbitrary)
        y, cnt, ms = ms.execute_block(x)
        slots, valid, ss = ss.execute_slots(y, n_valid=cnt)
        outs.append((y, cnt, slots, valid))
    states.append(ms.arbitrary)
    torch.cuda.synchronize()
    counts = read_counts()
    k3, rk = counts["symsync_fused_apply"], counts["resamp_u32_apply"]
    print(f"[main-path] MsResamp -> Symsync: {N_BLOCKS} blocks of [{C1}, {T1}] complex64, "
          f"kernel launches {counts}")
    require(k3 == N_BLOCKS and counts["symsync_scan_apply"] == 0,
            f"K3 launches {k3} != blocks {N_BLOCKS}")
    require(rk == N_BLOCKS, f"resamp_u32_apply launches {rk} != blocks {N_BLOCKS}")

    # the resampler's kernel against its plain version from the same state,
    # on the same CUDA tensors (its counts also held against the host-side
    # replay of the u32 schedule), its values against the plain version in
    # float64; then the XLA-form scan on the kernel's resampled blocks
    ss_p = make_symsync(C1, device)
    plain, worst, plain_gap, c128 = [], 0.0, 0.0, torch.complex128
    cap = make_msresamp(C1, device).out_capacity(T1)
    for i, (x, (y, cnt, slots, _)) in enumerate(zip(blocks, outs)):
        st, nxt = states[i], states[i + 1]
        want = st.get_num_output(T1)
        y_p, cnt_p, ph_p, win_p = resamp_u32_reference(x, st.window, st.branches, st.phase,
                                                       st.step, T1, out_capacity=cap)
        y64 = resamp_u32_reference(x.to(c128), st.window.to(c128), st.branches.double(),
                                   st.phase, st.step, T1, out_capacity=cap)[0]
        require(int(cnt) == int(cnt_p) == want,
                f"block {i}: counts {int(cnt)}, {int(cnt_p)}, host replay {want}")
        require(int(nxt.phase) == int(ph_p) and torch.equal(as_bits(nxt.window), as_bits(win_p)),
                f"block {i}: the resampler's carried phase and window")
        c = int(cnt)
        require(not as_bits(y)[:, c:].any(), f"block {i}: resampler zeros past the count")
        worst = max(worst, rel_rms(y64[:, :c], y[:, :c].to(c128)))
        plain_gap = max(plain_gap, rel_rms(y64[:, :c], y_p[:, :c].to(c128)))
        require(worst <= RESAMP_TOL, f"block {i}: resampler output {worst:.3e} of its rms")
        require(tuple(slots.shape) == (C1, y.shape[1], 2), f"block {i}: slot shape")
        require(bool(torch.isfinite(slots).all()), f"block {i}: finite slots")
        if i < N_SYM_CHECK:
            y_s, v_s, ss_p = ss_p.execute_slots(y, n_valid=cnt, backend="xla")
            plain.append((y_s, v_s))
    print(f"[main-path] MsResamp on resamp_u32_apply: counts equal the plain version and the "
          f"host replay over {N_BLOCKS} blocks ({int(outs[0][1])}..{int(outs[-1][1])} per "
          f"block), carried phase and window exact; largest |y - float64| {worst:.3e} of the "
          f"rms (limit {RESAMP_TOL}), the plain version's own {plain_gap:.3e}")
    got = [torch.cat([o[j] for o in outs[:N_SYM_CHECK]], 1) for j in (2, 3)]
    want = [torch.cat([p[j] for p in plain], 1) for j in (0, 1)]
    require(sym_same(f"[main-path] Symsync K3 vs the XLA-form scan over {N_SYM_CHECK} blocks",
                     got, want), "K3 route vs XLA-form scan")

    # one resampled block as one Symsync block and as two: bit-identical
    y0, cnt0 = outs[0][0], outs[0][1]
    for backend in ("auto", "pallas"):
        one, _, s1 = make_symsync(C1, device).execute_slots(y0, n_valid=cnt0, backend=backend)
        a, _, s2 = make_symsync(C1, device).execute_slots(y0[:, :SYM_SPLIT], backend=backend)
        b, _, s2 = s2.execute_slots(y0[:, SYM_SPLIT:], n_valid=cnt0 - SYM_SPLIT, backend=backend)
        same = torch.equal(one, torch.cat([a, b], 1)) and torch.equal(s1.tau, s2.tau)
        print(f"[main-path] Symsync {backend}: one block of {y0.shape[1]} (n_valid {int(cnt0)}) "
              f"vs {SYM_SPLIT} + rest: bit-identical {same}")
        require(same, f"Symsync block split ({backend})")

    # K4's route over the first N_PALLAS blocks: the same loop and stream as
    # the XLA-form scan, so bit-identical to it
    ms, ss = make()
    torch.cuda.synchronize()
    reset_counts()
    k4_outs = []
    for x in blocks[:N_PALLAS]:
        y, cnt, ms = ms.execute_block(x)
        slots, valid, ss = ss.execute_slots(y, n_valid=cnt, backend="pallas")
        k4_outs.append((slots, valid))
    torch.cuda.synchronize()
    counts = read_counts()
    k4 = counts["symsync_scan_apply"]
    print(f"[main-path] MsResamp -> Symsync(backend='pallas'): {N_PALLAS} blocks, kernel "
          f"launches {counts}")
    require(k4 == N_PALLAS and counts["symsync_fused_apply"] == 0,
            f"K4 launches {k4} != blocks {N_PALLAS}")
    got = [torch.cat([o[j] for o in k4_outs], 1) for j in (0, 1)]
    want = [torch.cat([p[j] for p in plain[:N_PALLAS]], 1) for j in (0, 1)]
    require(sym_same(f"[main-path] Symsync K4 vs the XLA-form scan over {N_PALLAS} blocks",
                     got, want), "K4 route vs XLA-form scan")
    return k3, k4, sum(int(o[3].sum()) for o in outs) / len(outs)


def phase_timing_config1(device, card: str) -> dict:
    """K3 and K4 by graph replay and their plain versions by eager calls at
    config[1]'s shape; returns {name: (kernel ms, plain ms)}."""
    rng = np.random.default_rng(SEED + 22)
    ms = make_msresamp(C1, device)
    n1 = ms.out_capacity(T1)
    ss = make_symsync(C1, device)
    kw = dict(E=2, **ss.kernel_args())
    kw_loop = [kw[k] for k in ("state", "locked", "radj", "pll_a", "pll_b")]
    kw_k = {k: kw[k] for k in ("P", "E", "k_out", "k")}
    nv = torch.tensor(n1 - 11, device=device)
    sets = [sym_inputs(rng, ss, C1, n1, device) for _ in range(N_ROT)]  # 130 MB of input
    k3 = [lambda a=a: symsync_fused_apply(*a, nv, **kw) for a in sets]
    k3_1, k3_2 = graph_ms(k3, reps=3), graph_ms(k3, reps=3)
    v = k3[0]()[1]
    skip = 1 - fused_chain_slots(v) / v.numel()
    xs4 = [branch_outputs(*sets[i]) for i in range(2)]  # 2.1 GB each
    k4 = [lambda x=x: symsync_scan_apply(x, nv, **kw) for x in xs4]
    # the direct instance (K4's first version, reading its rows from device
    # memory) in turns with the staged one
    direct = [lambda x=x: symsync_scan_launch(x, nv, *kw_loop, **kw_k, layout=None) for x in xs4]
    d_1, k4_1, k4_2, d_2 = (graph_ms(f, reps=3) for f in (direct, k4, k4, direct))
    p3 = cuda_ms(lambda: symsync_fused_reference(*sets[0], nv, **kw), iters=2, warmup=1)
    p4 = cuda_ms(lambda: symsync_scan_reference(xs4[0], nv, **kw), iters=2, warmup=1)
    del xs4
    print(f"[timing] {card}: symsync_fused (K3) {(k3_1 + k3_2) / 2:.4f} ms/block ({k3_1:.4f}, "
          f"{k3_2:.4f}), graph replay, skip share {skip:.4f}; symsync_fused_reference "
          f"{p3:.2f} ms/block, eager (2 calls after one); at C={C1}, n={n1}, "
          f"n_valid={n1 - 11}")
    print(f"[timing] {card}: symsync_scan (K4) {(k4_1 + k4_2) / 2:.4f} ms/block ({k4_1:.4f}, "
          f"{k4_2:.4f}) in layout (chans, w, bytes) {scan_layout(ss.npfb, 2)}, its direct "
          f"instance {(d_1 + d_2) / 2:.4f} ({d_1:.4f}, {d_2:.4f}), graph replay in turns; "
          f"symsync_scan_reference {p4:.2f} ms/block, eager (2 calls after one)")
    return {"symsync_fused": ((k3_1 + k3_2) / 2, p3),
            "symsync_scan": ((k4_1 + k4_2) / 2, p4, (d_1 + d_2) / 2)}


def state_diff(a, b, prefix: str = "") -> list[str]:
    """The fields of two state objects (nested ones included) whose tensors
    differ in any bit, or whose static values differ."""
    diff = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            diff += state_diff(x, y, f"{prefix}{f.name}.")
        elif not (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y):
            diff.append(prefix + f.name)
    return diff


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN equal to NaN wherever both hold one."""
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    if not a.is_floating_point():
        return torch.equal(a, b)
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def agc_inputs(rng, c: int, n: int, device) -> tuple:
    """agc_scan's arguments with the loop's branches all taken: levels from
    −60 to +20 dB that drop by 60 dB halfway in half the channels, loop
    bandwidths 1e-3 (QamRx's), 0.02 and 0.25, the squelch enabled in three
    channels of four with thresholds from −40 to +40 dB, every seventh channel
    locked, scales 1 and 2."""
    level = 10 ** rng.uniform(-3, 1, (c, 1)) * np.where(
        (np.arange(n) >= n // 2) & (rng.random((c, 1)) < 0.5), 1e-3, 1.0)
    x = complex_block(rng, (c, n), device) * torch.from_numpy(level.astype(np.float32)).to(device)

    def f32(v):
        return torch.from_numpy(np.asarray(v, np.float32)).to(device)

    def i32(v):
        return torch.from_numpy(np.asarray(v, np.int32)).to(device)

    ch = np.arange(c)
    mode = np.where(ch % 4 == 3, AgcSquelchMode.DISABLED, AgcSquelchMode.ENABLED)
    return (x, f32(np.ones(c)), f32(np.ones(c)), f32(np.array([1e-3, 0.02, 0.25])[ch % 3]),
            f32(1.0 + (ch % 2)), f32(rng.uniform(-40, 40, c)),
            torch.from_numpy(ch % 7 == 0).to(device), i32(mode), i32(np.full(c, 100)))


def eq_case(rng, c: int, n: int, k_eq: int, h_len: int, m: int, traffic: str, device) -> tuple:
    """qam_eq_scan's arguments: random slots (valid about ½, 0.2 for
    ``sparse``) and state (a count on either side of h_len, one channel's
    sym_phase out of range); ``zeros`` puts a run of zero slots in, ``nan``
    NaN slots in half the channels, ``quiet`` keeps Σ|x|² under ½·h_len."""
    def cplx(*shape):
        return torch.from_numpy(((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                                 / np.sqrt(2)).astype(np.complex64)).to(device)

    y = cplx(c, n)
    valid = torch.from_numpy(rng.random((c, n)) < (0.2 if traffic == "sparse" else 0.5)).to(device)
    if traffic == "zeros":
        y[:, n // 5: n // 2] = 0
    elif traffic == "nan":
        y[::2, n // 3] = complex("nan+nanj")
    elif traffic == "quiet":
        y = y * 0.05
    table = Modem.create({4: "qpsk", 16: "qam16", 64: "qam64"}[m], device=device).table
    x2 = torch.from_numpy(rng.random((c, h_len)).astype(np.float32)
                          * (0.1 if traffic == "quiet" else 2)).to(device)
    w = cplx(c, h_len) * 0.1
    w[:, h_len // 2] += 1
    state = dict(w=w, buffer=cplx(c, h_len), x2=x2, x2_sum=x2.sum(1),
                 count=torch.from_numpy(rng.integers(0, 2 * h_len + 2, c).astype(np.int32)).to(device),
                 theta=torch.from_numpy(rng.uniform(-3, 3, c).astype(np.float32)).to(device),
                 dtheta=torch.from_numpy(rng.uniform(-1e-3, 1e-3, c).astype(np.float32)).to(device),
                 sym_phase=torch.from_numpy(rng.integers(0, k_eq, c).astype(np.int32)).to(device),
                 evm_accum=torch.zeros(c, device=device), evm_count=torch.zeros(c, device=device))
    state["sym_phase"][0] = -7
    vec = torch.full((c,), 0.02, dtype=torch.float32, device=device)
    return y, valid, table, vec, vec, vec * 0.01, state


def eq_rounds(y, valid, table, mu, alpha, beta, state, *, k_eq: int) -> int:
    """The rounds qam_eq_scan's register instance runs, from its plain
    version alone: run one slot at a time, the loop's state (w, θ, dθ, the
    EVM sums) moves after some slots; cut each channel's slots there, at
    every ROUND_TILE slots and every ROUND_SLOTS slots."""
    C, S = y.shape
    moved = torch.zeros(C, S, dtype=torch.bool, device=y.device)
    for s in range(S):
        *_, new = qam_eq_scan_reference(y[:, s:s + 1], valid[:, s:s + 1], table, mu, alpha, beta,
                                        state, k_eq=k_eq)
        for f in ("w", "theta", "dtheta", "evm_accum", "evm_count"):
            moved[:, s] |= ~((new[f] == state[f]) | (new[f].isnan() & state[f].isnan())
                             ).reshape(C, -1).all(1)
        state = new
    moved = moved.cpu()
    total = 0
    for c in range(C):
        cuts = sorted({s + 1 for s in range(S) if moved[c, s]}
                      | set(range(ROUND_TILE, S, ROUND_TILE)) | {S})
        total += sum(-(-(b - a) // ROUND_SLOTS) for a, b in zip([0] + cuts, cuts))
    return total


def phase_kernel_vs_plain_qam(device) -> dict:
    """K3 at QamRx's k_out = 2 against symsync_fused_reference, then
    qam_eq_scan on K3's slots and agc_scan on a level-stepped block against
    their plain versions, at QAM_SMALL and at config[3]'s C = 2048, n = 4096,
    bit for bit (outputs and every state field); returns max |error| and the
    plain versions' eager time (ms) at config[3], each from one call."""
    rng = np.random.default_rng(SEED + 30)
    out = {}
    for c, n in (QAM_SMALL, (C3, T3)):
        big = (c, n) == (C3, T3)
        rx = make_qamrx(c, device)
        ss = rx.symsync
        xa, g = sym_inputs(rng, ss, c, n, device)
        kw = dict(E=rx.slots, **ss.kernel_args())
        got = k3_counted(f"[kernel-vs-plain] symsync_fused (K3) k_out=2 C={c} n={n}", xa, g,
                         None, **kw)
        want = symsync_fused_reference(xa, g, None, **kw)
        require(tuple(got[0].shape) == (c, n, 2) and bool(torch.isfinite(got[0]).all()),
                "K3 (k_out = 2) output shape and finiteness")
        require(sym_same(f"[kernel-vs-plain] symsync_fused (K3) k_out=2 C={c} n={n} (values, "
                         f"valid, state, deferral count {int(got[3].sum())})", got, want),
                f"K3 at k_out = 2 vs plain at C={c} n={n}")
        del xa, want

        slots = (got[0].reshape(c, n * 2), got[1].reshape(c, n * 2))
        args = rx.eq_scan_args()
        k = qam_eq_scan_apply(*slots, *args, k_eq=rx.k_eq)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = qam_eq_scan_reference(*slots, *args, k_eq=rx.k_eq)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        same = [torch.equal(a, b) for a, b in zip(k[:3], p[:3])]
        bad = [f for f in k[3] if not torch.equal(k[3][f], p[3][f])]
        err = (k[1] - p[1]).abs().max().item()
        print(f"[kernel-vs-plain] qam_eq_scan C={c} S={n * 2}: bit-identical (syms, soft, "
              f"mask) {same}, state fields that differ {bad}; max abs err {err:.3e}; "
              f"{int(k[2].sum())} symbols")
        require(all(same) and not bad, f"qam_eq_scan vs plain at C={c} n={n}")
        if big:
            out["qam_eq_scan"] = (err, p_ms)
        else:  # other tables (M = 4 and 64 split over the lanes unevenly and
            # in several rounds) and NaN slots, which take the first-NaN rule;
            # then the fresh equalizer on zero slots, whose output 0 is
            # equidistant from the nearest 4 points (a tie, to the first)
            # except where a NaN slot sits in its window (every distance NaN)
            yn = slots[0].clone()
            yn[::7, 100::97] = float("nan")
            y0 = torch.zeros_like(slots[0])
            y0[::5, 50::61] = float("nan")
            for scheme, y_in in (("qpsk", slots[0]), ("qam64", slots[0]), ("qam16", yn),
                                 ("qpsk", y0), ("qam16", y0), ("qam64", y0)):
                table = Modem.create(scheme, device=device).table
                k = qam_eq_scan_apply(y_in, slots[1], table, *args[1:], k_eq=rx.k_eq)
                p = qam_eq_scan_reference(y_in, slots[1], table, *args[1:], k_eq=rx.k_eq)
                same = [same_bits(a, b) for a, b in zip(k[:3], p[:3])]
                bad = [f for f in k[3] if not same_bits(k[3][f], p[3][f])]
                what = {id(yn): " with NaN slots", id(y0): " on zero and NaN slots (ties)"}
                print(f"[kernel-vs-plain] qam_eq_scan C={c} S={n * 2} M={table.shape[0]}"
                      f"{what.get(id(y_in), '')}: bit-identical (syms, soft, mask) {same}, "
                      f"state fields that differ {bad}")
                require(all(same) and not bad, f"qam_eq_scan vs plain, {scheme}")
                if y_in is y0:
                    first = int(torch.argmin(table.real ** 2 + table.imag ** 2))  # nearest 0
                    want = torch.where(k[1].isnan(), 0, first)
                    ties = int((k[1] == 0).sum())
                    print(f"[kernel-vs-plain] qam_eq_scan M={table.shape[0]}: {ties} tied "
                          f"decisions all index {first}, {int(k[1].isnan().sum())} NaN ones "
                          f"index 0")
                    require(ties > 0 and bool((k[0] == want).all()), "ties and NaNs decided")
        del got, slots, k, p

        a_args = agc_inputs(rng, c, n, device)
        k = agc_scan_apply(*a_args, timeout=100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = agc_scan_reference(*a_args, timeout=100)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        same = [torch.equal(a, b) for a, b in zip(k, p)]
        err = (k[0] - p[0]).abs().max().item()
        modes = torch.bincount(k[3].long(), minlength=7).tolist()
        print(f"[kernel-vs-plain] agc_scan C={c} n={n}: bit-identical (y, g, y2', mode, timer) "
              f"{same}; max abs err {err:.3e}; final squelch modes {modes}")
        require(all(same) and bool(torch.isfinite(k[0]).all()), f"agc_scan vs plain at C={c}")
        if big:
            out["agc_scan"] = (err, p_ms)

    # equalizers past the 16 taps that live in registers: the shared-memory
    # instance, on K3's slots, every state field
    c, n = QAM_LONG
    for eq_len in (17, 31):
        rx = QamRx.create(eq_len=eq_len, batch_shape=(c,), device=device)
        xa, g = sym_inputs(rng, rx.symsync, c, n, device)
        y, v, _, _ = symsync_fused_apply(xa, g, None, E=rx.slots, **rx.symsync.kernel_args())
        slots = (y.reshape(c, n * 2), v.reshape(c, n * 2))
        args = rx.eq_scan_args()
        k = qam_eq_scan_apply(*slots, *args, k_eq=rx.k_eq)
        p = qam_eq_scan_reference(*slots, *args, k_eq=rx.k_eq)
        same = [torch.equal(a, b) for a, b in zip(k[:3], p[:3])]
        bad = [f for f in k[3] if not torch.equal(k[3][f], p[3][f])]
        moved = float((k[3]["w"] - args[4]["w"]).abs().max())
        print(f"[kernel-vs-plain] qam_eq_scan h_len={eq_len} C={c} S={n * 2}: bit-identical "
              f"(syms, soft, mask) {same}, state fields that differ {bad}; {int(k[2].sum())} "
              f"symbols, weights moved by up to {moved:.3e}")
        require(all(same) and not bad and moved > 0, f"qam_eq_scan vs plain at h_len={eq_len}")
        x = complex_block(rng, (c, n), device)
        got, want = rx.step_masked(x), rx._step_masked(x, plain=True)
        same = [torch.equal(a, b) for a, b in zip(got[:3], want[:3])]
        bad = state_diff(got[3], want[3])
        print(f"[kernel-vs-plain] QamRx(eq_len={eq_len}).step_masked vs the all-plain chain: "
              f"bit-identical (syms, soft, mask) {same}, state fields that differ {bad}")
        require(all(same) and not bad, f"QamRx at eq_len={eq_len} vs the all-plain chain")

    # qam_eq_scan in rounds (the register instance): every state field bit
    # for bit, and its round counter against the plain loop's segments (cut
    # where the loop's state moved, one slot at a time, at every tile and
    # every ROUND_SLOTS slots)
    for (c, n), (k_eq, h_len, m, traffic) in zip(
            [(13, 165), (37, 300), (5, 1), (16, 128), (13, 165), (37, 300), (16, 165), (13, 165),
             (13, 165), (13, 165), (13, 165)],
            [(2, 7, 16, "random"), (1, 7, 16, "random"), (3, 7, 16, "random"),
             (2, 1, 16, "random"), (2, 16, 16, "random"), (2, 7, 4, "random"),
             (2, 7, 64, "random"), (2, 7, 16, "zeros"), (2, 7, 16, "nan"), (2, 7, 16, "quiet"),
             (3, 16, 64, "sparse")]):
        args = eq_case(rng, c, n, k_eq, h_len, m, traffic, device)
        counts = trace.device_counter("qam_eq_scan.rounds", torch.device(device))
        before = int(counts.item())
        k = qam_eq_scan_apply(*args, k_eq=k_eq)
        rounds = int(counts.item()) - before
        p = qam_eq_scan_reference(*args, k_eq=k_eq)
        same = [same_bits(a, b) for a, b in zip(k[:3], p[:3])]
        bad = [f for f in k[3] if not same_bits(k[3][f], p[3][f])]
        want = eq_rounds(*args, k_eq=k_eq)
        print(f"[kernel-vs-plain] qam_eq_scan in rounds C={c} S={n} k_eq={k_eq} h_len={h_len} "
              f"M={m} {traffic}: bit-identical (syms, soft, mask) {same}, state fields that "
              f"differ {bad}; {rounds} rounds (the plain loop's segments: {want})")
        require(all(same) and not bad and rounds == want,
                f"qam_eq_scan in rounds vs plain, {(c, n, k_eq, h_len, m, traffic)}")

    # agc_scan at the edges of its tiles and channel groups
    for c, n in ((13, 1), (13, 127), (37, 129), (5, 300)):
        a_args = agc_inputs(rng, c, n, device)
        k, p = agc_scan_apply(*a_args, timeout=100), agc_scan_reference(*a_args, timeout=100)
        same = [torch.equal(a, b) for a, b in zip(k, p)]
        print(f"[kernel-vs-plain] agc_scan C={c} n={n}: bit-identical (y, g, y2', mode, timer) "
              f"{same}")
        require(all(same), f"agc_scan vs plain at C={c} n={n}")
    return out


def phase_main_path_config3(device) -> dict:
    """Stream N_QAM config[3] blocks through QamRx.step_masked; the first
    N_QAM_PLAIN against the chain with every stage on its plain version,
    outputs and whole state bit for bit; a block split. Returns the
    launches of that run per kernel."""
    rng = np.random.default_rng(QAM_SEED)
    blocks = [complex_block(rng, (C3, T3), device) for _ in range(N_QAM)]
    rx = make_qamrx(C3, device)

    torch.cuda.synchronize()
    reset_counts()
    outs, states = [], []
    for x in blocks:
        syms, soft, mask, rx = rx.step_masked(x)
        outs.append((syms, soft, mask))
        states.append(rx)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"[main-path] QamRx.step_masked: {N_QAM} blocks of [{C3}, {T3}] complex64, kernel "
          f"launches {counts}")
    path = ("agc_scan_apply", "symsync_fused_apply", "qam_eq_scan_apply")
    require(all(counts[k] == (N_QAM if k in path else 0) for k in counts),
            f"launches {counts}: want {N_QAM} of each of {path}, no other")

    S = 2 * T3
    for i, (syms, soft, mask) in enumerate(outs):
        require(tuple(syms.shape) == tuple(soft.shape) == tuple(mask.shape) == (C3, S),
                f"block {i}: shapes")
        require(syms.dtype == torch.int64 and soft.dtype == torch.complex64
                and mask.dtype == torch.bool, f"block {i}: dtypes")
        require(bool(torch.isfinite(soft).all()) and bool(((syms >= 0) & (syms < 16)).all()),
                f"block {i}: finite soft values, symbols in [0, 16)")
    per_block = [int(o[2].sum()) for o in outs]
    print(f"[main-path] symbols per block {per_block} (about C·n/2 = {C3 * T3 // 2}); "
          f"overflow_count total {int(rx.overflow_count.sum())}")

    plain = make_qamrx(C3, device)
    for i in range(N_QAM_PLAIN):
        p = plain._step_masked(blocks[i], plain=True)
        plain = p[3]
        same = [torch.equal(a, b) for a, b in zip(outs[i], p[:3])]
        print(f"[main-path] QamRx block {i} vs the all-plain chain (agc_scan_reference, the "
              f"XLA-form scan, qam_eq_scan_reference): bit-identical (syms, soft, mask) {same}")
        require(all(same), f"block {i}: QamRx vs the all-plain chain")
    bad = state_diff(states[N_QAM_PLAIN - 1], plain)
    print(f"[main-path] QamRx state after {N_QAM_PLAIN} blocks vs the all-plain chain: fields "
          f"that differ {bad} (overflow_count included)")
    require(not bad, f"carried state vs the all-plain chain: {bad}")

    one = make_qamrx(C3, device).step_masked(blocks[0])
    a = make_qamrx(C3, device).step_masked(blocks[0][:, :QAM_SPLIT])
    b = a[3].step_masked(blocks[0][:, QAM_SPLIT:])
    same = [torch.equal(o, torch.cat([u, v], -1)) for o, u, v in zip(one[:3], a[:3], b[:3])]
    bad = state_diff(one[3], b[3])
    print(f"[main-path] QamRx one block of {T3} vs {QAM_SPLIT} + rest: bit-identical (syms, "
          f"soft, mask) {same}, state fields that differ {bad}")
    require(all(same) and not bad, "QamRx block split")
    return {"agc_scan": counts["agc_scan_apply"], "qam_eq_scan": counts["qam_eq_scan_apply"]}


def qam_signal(rng, c: int, n: int, device):
    """c channels of 16-QAM at k = 2, n samples each, every channel with its
    own symbols and noise: the RRCOS (m = 7, β = 0.3) interpolation, then
    tests/test_qamrx.py's impairments (gain 0.5, echo 0.1·e^{j1.1} at 3
    samples, phase 0.3, CFO 1e-4 rad/sample, complex noise 0.002 per part).
    Returns (symbols int64 [c, n/2], x complex64 [c, n]) on the device."""
    syms = torch.from_numpy(rng.integers(0, 16, (c, n // 2))).to(device)
    pts, _ = Modem.create("qam16", device=device).modulate(syms)
    h = torch.from_numpy(fir_design_prototype(FirFilterShape.RRCOS, 2, 7, 0.3)).to(device)
    up = torch.zeros((c, n), dtype=torch.complex128, device=device)
    up[:, ::2] = pts
    sig = torch.zeros_like(up)
    for j in range(h.shape[0]):  # causal FIR over the zero-stuffed symbols
        sig[:, j:] += h[j] * up[:, : n - j]
    s = sig + QAM_ECHO * torch.roll(sig, QAM_ECHO_DELAY, dims=1)
    t = torch.arange(n, dtype=torch.float64, device=device)
    s = QAM_GAIN * s * torch.polar(torch.ones_like(t), QAM_PHASE + QAM_CFO * t)
    noise = torch.complex(torch.from_numpy(rng.standard_normal((c, n))),
                          torch.from_numpy(rng.standard_normal((c, n)))).to(device)
    return syms, (s + QAM_NOISE * noise).to(torch.complex64)


def tail_ser(got, cnt, want, offsets: int = 40):
    """tests/test_qamrx.py::_tail_ser per channel: the symbol error rate over
    the last quarter of the stream, at the best of ``offsets`` alignments of
    the decisions ``got`` [c, cap] (the first ``cnt`` valid) against the sent
    symbols ``want`` [c, m]."""
    m = want.shape[1]
    i = torch.arange(m, device=got.device)
    best = torch.ones(got.shape[0], dtype=torch.float64, device=got.device)
    for off in range(offsets):
        L = torch.clamp(torch.minimum(cnt - off, torch.full_like(cnt, m)), min=0)
        tail = (i >= (3 * L // 4)[:, None]) & (i < L[:, None])
        g = got[:, off:off + m]
        g = torch.nn.functional.pad(g, (0, m - g.shape[1]), value=-1)
        err = ((g != want) & tail).sum(1).double() / tail.sum(1).clamp(min=1)
        best = torch.where(tail.any(1), torch.minimum(best, err), best)
    return best


def phase_signal_config3(device) -> None:
    """The impaired 16-QAM signal through QamRx over N_QAM_SIG blocks, all
    C3 channels: tail symbol error rate 0 and tail EVM < QAM_EVM_DB in all
    but at most QAM_FALSE_LOCK_MAX of them; in every channel no deferral and
    the carrier loop moved off 0."""
    rng = np.random.default_rng(QAM_SEED + 1)
    want, x = qam_signal(rng, C3, N_QAM_SIG * T3, device)
    rx = make_qamrx(C3, device)
    parts = []
    chain = trace.device_counter("symsync_fused.chain_slots", device)
    before = int(chain.item())
    for blk in torch.split(x, T3, dim=1):
        syms, soft, mask, rx = rx.step_masked(blk)
        parts.append((syms, soft, mask))
    skip = 1 - (int(chain.item()) - before) / (C3 * x.shape[1] * rx.slots)
    syms, soft, mask = (torch.cat([p[j] for p in parts], -1) for j in range(3))
    got, cnt = compact_valid(syms, mask)
    soft_c, _ = compact_valid(soft, mask)
    ser = tail_ser(got, cnt, want)
    require(bool((cnt >= QAM_TAIL).all()), "every channel decided enough symbols")
    idx = cnt[:, None] - QAM_TAIL + torch.arange(QAM_TAIL, device=device)
    ts = soft_c.gather(1, idx)
    d2 = (ts[:, :, None] - rx.table).abs().square().amin(-1)
    evm = 10 * torch.log10(d2.mean(1))
    theta = torch.remainder(rx.theta, 2 * np.pi).abs()
    ovf = rx.overflow_count
    ok = (ser == 0) & (evm < QAM_EVM_DB)
    bad = torch.nonzero(~ok).flatten().tolist()
    print(f"[signal] 16-QAM over {C3} channels, {N_QAM_SIG} blocks of {T3} (gain {QAM_GAIN}, "
          f"echo 0.1·e^(j1.1) at {QAM_ECHO_DELAY}, phase {QAM_PHASE}, CFO {QAM_CFO}, noise "
          f"{QAM_NOISE}): symbols decided {int(cnt.min())}..{int(cnt.max())} of "
          f"{want.shape[1]} sent; tail SER 0 and tail EVM < {QAM_EVM_DB} dB in "
          f"{C3 - len(bad)} of {C3} channels; among them worst tail EVM "
          f"{(evm[ok].max().item() if ok.any() else float('nan')):.2f} dB (median {evm.median().item():.2f} dB); smallest "
          f"|theta| mod 2pi {theta.min().item():.4f}, overflow_count max {int(ovf.max())}; "
          f"K3's skip share {skip:.4f}")
    for c in bad:
        print(f"[signal] wrong lock in channel {c}: tail SER {ser[c].item():.4f}, tail EVM "
              f"{evm[c].item():.2f} dB, theta {rx.theta[c].item():.4f}, dtheta "
              f"{rx.dtheta[c].item():.3e}")
    require(len(bad) <= QAM_FALSE_LOCK_MAX * C3,
            f"tail SER 0 and EVM < {QAM_EVM_DB} dB: {len(bad)} channels miss")
    require(bool((ovf == 0).all()), "no deferred emission")
    require(bool((theta > QAM_THETA_MIN).all()), f"|theta| mod 2pi > {QAM_THETA_MIN}")


def phase_timing_config3(device, card: str, plain_ms: dict) -> dict:
    """agc_scan, qam_eq_scan and K3 (k_out = 2) by graph replay at config[3]'s
    shape; returns {name: (kernel ms, plain ms)}, the plain versions' times
    from their checks (``plain_ms``)."""
    rng = np.random.default_rng(SEED + 31)
    rx = make_qamrx(C3, device)
    ss = rx.symsync
    kw = dict(E=rx.slots, **ss.kernel_args())
    sets = [sym_inputs(rng, ss, C3, T3, device) for _ in range(2)]  # 134 MB of input
    k3 = [lambda a=a: symsync_fused_apply(*a, None, **kw) for a in sets]
    k3_1, k3_2 = graph_ms(k3, reps=5), graph_ms(k3, reps=5)
    slots = []
    for a in sets:
        y, v, _, _ = symsync_fused_apply(*a, None, **kw)
        slots.append((y.reshape(C3, 2 * T3), v.reshape(C3, 2 * T3)))
    skip = 1 - fused_chain_slots(v) / v.numel()
    args = rx.eq_scan_args()
    eq = [lambda s=s: qam_eq_scan_apply(*s, *args, k_eq=rx.k_eq) for s in slots]
    eq_1, eq_2 = graph_ms(eq, reps=5), graph_ms(eq, reps=5)
    a = rx.agc  # the path's AGC: bandwidth 1e-3, squelch disabled
    agc_sets = [(complex_block(rng, (C3, T3), device), a.g, a.y2_prime, a.alpha, a.scale,
                 a.squelch_threshold, a.locked, a.squelch_mode, a.squelch_timer)
                for _ in range(2)]
    agc = [lambda a=a: agc_scan_apply(*a, timeout=100) for a in agc_sets]
    agc_1, agc_2 = graph_ms(agc, reps=5), graph_ms(agc, reps=5)
    del sets, slots, agc_sets
    print(f"[timing] {card}: symsync_fused (K3) k_out=2 {(k3_1 + k3_2) / 2:.4f} ms/block "
          f"({k3_1:.4f}, {k3_2:.4f}) at C={C3}, n={T3}, skip share {skip:.4f} (random input); "
          f"qam_eq_scan {(eq_1 + eq_2) / 2:.4f} "
          f"ms/block ({eq_1:.4f}, {eq_2:.4f}), qam_eq_scan_reference "
          f"{plain_ms['qam_eq_scan']:.2f} ms/block; agc_scan {(agc_1 + agc_2) / 2:.4f} ms/block "
          f"({agc_1:.4f}, {agc_2:.4f}), agc_scan_reference {plain_ms['agc_scan']:.2f} ms/block. "
          f"Kernels by graph replay, plain versions by one eager call")
    return {"agc_scan": ((agc_1 + agc_2) / 2, plain_ms["agc_scan"]),
            "qam_eq_scan": ((eq_1 + eq_2) / 2, plain_ms["qam_eq_scan"])}


def rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| / max |a| (tests/test_iir_parallel.py's measure); 0 for
    empty tensors (the state of a filter with no feedback)."""
    if a.numel() == 0:
        return 0.0
    return ((a - b).abs().max() / (a.abs().max() + 1e-12)).item()


def iir_case(rng, form, n, typ: str, c: int, t: int, device) -> tuple:
    """(x, b, a, scale, v) of a stable filter: TF with n taps (random poles
    within 0.6/order of 0, random numerator; for ``"tfslow"`` poles at radius
    0.995, whose state lasts ~200 samples, so a chunked carry across chunks
    and warps shows in the output), SOS with n Butterworth
    sections, ``"lowpass7"`` (IirFilter.create_lowpass(7, 0.1)) or
    ``"integrator"``; a random [c, t] signal of ``typ`` (rrrf, crcf: real
    coefficients; cccf: complex), a scale other than 1 and a random state."""
    cx, cc = typ != "rrrf", typ == "cccf"
    sig = torch.complex64 if cx else torch.float32

    def rand(shape, complex_):
        z = rng.standard_normal(shape)
        return z + 1j * rng.standard_normal(shape) if complex_ else z

    if form in ("tf", "tfslow"):
        m = n - 1
        poles = 0.6 * rand(m, cc) / max(m, 1) / (np.sqrt(2) if cc else 1)
        if form == "tfslow":  # conjugate pairs (and one real pole) for real coefficients
            ang = rng.uniform(0.05, 3.0, m if cc else m // 2)
            poles = 0.995 * (np.exp(1j * ang) if cc else np.concatenate(
                [np.exp(1j * ang), np.exp(-1j * ang), np.ones(m % 2)]))
        a = np.atleast_1d(np.poly(poles))
        f = IirFilter.create(0.3 * rand(n, cc), a if cc else a.real, device=device)
        b, a = f.b, f.a
        v = 0.5 * rand((c, m), cx)
    else:
        if n == "integrator":
            f = IirFilter.create_integrator(device=device)
        elif n == "lowpass7":
            f = IirFilter.create_lowpass(7, 0.1, device=device)
        else:
            f = IirFilter.create_prototype(iirdes.IirFilterShape.BUTTER, iirdes.IirBandType.LOWPASS,
                                           iirdes.IirFormat.SECOND_ORDER_SECTIONS, 2 * n, 0.1,
                                           device=device)
        b, a = f.b, f.a
        v = 0.5 * rand((c, f.nsos, 2), cx)
    scale = torch.tensor(0.7 + 0.2j if cc else 0.7, dtype=b.dtype, device=device)
    x = torch.from_numpy(rand((c, t), cx)).to(sig).to(device)
    return x, b, a, scale, torch.from_numpy(v).to(sig).to(device)


def phase_kernel_vs_plain_iir(device) -> dict:
    """iir_scan against iir_scan_reference bit for bit at IIR_SCAN_CASES,
    and iir_chunked against iir_chunked_reference (the log-depth form) and
    against iir_scan within IIR_TF_TOL / IIR_SOS_TOL at IIR_CHUNK_CASES,
    each from a nonzero state; returns max |error| at config[2]'s shape (the
    de-emphasis's form, [C2, T2])."""
    rng = np.random.default_rng(SEED + 40)
    out = {}
    for form, n, typ, c, t in IIR_SCAN_CASES:
        x, b, a, scale, v = iir_case(rng, form, n, typ, c, t, device)
        sos = form == "sos"
        state_len = v.shape[1] * v.shape[2] if sos else v.shape[1]
        got = iir_scan_apply(x, b, a, scale, v, sos=sos)
        want = iir_scan_reference(x, b, a, scale, v, sos=sos)
        same = [same_bits(p, q) for p, q in zip(got, want)]
        err = (got[0] - want[0]).abs().max().item()
        print(f"[kernel-vs-plain] iir_scan {form} {n} {typ} C={c} T={t} (instance "
              f"{scan_instance(state_len, x.is_complex(), sos)[0]}): bit-identical (y, state) "
              f"{same}; "
              f"max abs err {err:.3e}")
        require(all(same) and bool(torch.isfinite(got[0]).all()),
                f"iir_scan vs plain, {form} {n} {typ} C={c} T={t}")
        if (form, n, c, t) == ("tf", 2, C2, T2):
            out["iir_scan"] = err
    for form, n, typ, c, t in IIR_CHUNK_CASES:
        x, b, a, scale, v = iir_case(rng, form, n, typ, c, t, device)
        sos = form == "sos"
        order, nst = (2, v.shape[1]) if sos else (v.shape[1], 1)
        fits = chunked_fits(order, nst, x.is_complex(), b.is_complex())
        tol = IIR_SOS_TOL if sos else IIR_TF_TOL
        torch.cuda.synchronize()
        reset_counts()
        got = iir_chunked_apply(x, b, a, scale, v, sos=sos)
        torch.cuda.synchronize()
        counts = read_counts()
        want = iir_chunked_reference(x, b, a, scale, v, sos=sos)
        seq = iir_scan_apply(x, b, a, scale, v, sos=sos)
        errs = [rel_max(w, g) for w, g in zip(want, got)]
        errs_seq = [rel_max(w, g) for w, g in zip(seq, got)]
        print(f"[kernel-vs-plain] iir_chunked {form} {n} {typ} C={c} T={t} (order {order}, "
              f"{nst} stage(s), chunked kernel {fits}, instance {chunked_instance(order)}): "
              f"max |a - b| / max |a| (y, state) vs the "
              f"log-depth form {errs[0]:.3e}, {errs[1]:.3e}; vs iir_scan {errs_seq[0]:.3e}, "
              f"{errs_seq[1]:.3e} (< {tol}); launches {counts['iir_chunked_apply']} chunked, "
              f"{counts['iir_scan_apply']} sequential")
        require(max(errs + errs_seq) < tol and bool(torch.isfinite(got[0]).all()),
                f"iir_chunked vs plain, {form} {n} {typ} C={c} T={t}")
        require((counts["iir_chunked_apply"], counts["iir_scan_apply"]) == ((1, 0) if fits else (0, 1)),
                f"iir_chunked's shape gate: {counts}")
        if (form, n, c, t) == ("tf", 2, C2, T2):
            out["iir_chunked"] = (got[0] - want[0]).abs().max().item()
    return out


def fir_sets(device) -> dict:
    """config[2]'s four FIRs (``FmStereoRx``'s pilot bandpass, delay, sum
    and difference lowpasses at [C2, T2]), each with N_ROT (block, window)
    pairs of random samples of its signal type."""
    rng = np.random.default_rng(SEED + 42)
    rx = make_fmstereo(C2, device)
    out = {}
    for name in ("pilot_bp", "align", "mono_lp", "diff_lp"):
        f = getattr(rx, name)

        def draw(shape, cx=f.window.is_complex()):
            x = planes(rng, shape, device)
            return torch.complex(x, planes(rng, shape, device)) if cx else x

        out[name] = (f, [(draw((C2, T2)), draw((C2, f.h_len))) for _ in range(N_ROT)])
    return out


def phase_kernel_vs_plain_fir(device) -> float:
    """fir_block against fir_block_reference (the banded matmul) at config[2]'s
    four FIRs within FIR_TOL of the plain output's largest magnitude, one
    launch each; a FirFilter block cut at FIR_SPLIT bit for bit against the
    whole block. Returns the largest error."""
    worst = 0.0
    for name, (f, sets) in fir_sets(device).items():
        x, w = sets[0]
        torch.cuda.synchronize()
        reset_counts()
        y = fir_block_apply(x, w, f.h, f.scale)
        torch.cuda.synchronize()
        launched = read_counts()["fir_block_apply"]
        want = fir_block_reference(x, w, f.h, f.scale)
        err = rel_max(want, y)
        g = f.replace(window=w)
        y1, g1 = g.execute_block(x[:, :FIR_SPLIT])
        y2, g2 = g1.execute_block(x[:, FIR_SPLIT:])
        whole, gw = g.execute_block(x)
        split = torch.equal(torch.cat([y1, y2], -1), whole) and torch.equal(g2.window, gw.window)
        print(f"[kernel-vs-plain] fir_block {name}: [{C2}, {T2}] {x.dtype} through {f.h_len} "
              f"{f.h.dtype} taps, {launched} launch: max |a - b| / max |a| {err:.3e} (< {FIR_TOL}); "
              f"{FIR_SPLIT} + {T2 - FIR_SPLIT} bit-identical to the whole block {split}")
        require(err < FIR_TOL and launched == 1 and split and bool(torch.isfinite(y).all()),
                f"fir_block vs plain, {name}")
        worst = max(worst, err)
    return worst


def phase_timing_fir(device, card: str) -> tuple[float, float, float]:
    """A config[2] step's four FIRs by graph replay over N_ROT input sets (the
    50 MB L2 cannot hold them): fir_block, its plain version (frames, cuBLAS
    gemms, scale), and cuBLAS's banded gemms alone on frames made before
    (the library yardstick, which the port never calls); ms a step each."""
    from yagi_tpu_torch.filter import _conv

    sets = fir_sets(device)
    kernel = [lambda f=f, s=s: fir_block_apply(s[0], s[1], f.h, f.scale)
              for f, ss in sets.values() for s in ss]
    plain = [lambda f=f, s=s: fir_block_reference(s[0], s[1], f.h, f.scale)
             for f, ss in sets.values() for s in ss]
    gemms = []
    for f, ss in sets.values():
        for x, w in ss:
            xa = torch.cat([w[..., 1:], x], -1)
            parts = ([xa.real.contiguous(), xa.imag.contiguous()]
                     if xa.is_complex() and not f.h.is_complex() else [xa])
            for part in parts:  # what _conv._banded hands to the gemm
                dt = torch.promote_types(part.dtype, f.h.dtype)
                fr, _ = _conv._band_frames(part.to(dt), f.h_len)
                k, valid = _conv._band_index(fr.shape[-1], f.h_len, f.h.device)
                g = torch.where(valid, f.h.to(dt)[k], 0)
                gemms.append(lambda fr=fr, g=g: fr @ g)
    per_step = [len(c) / N_ROT for c in (kernel, plain, gemms)]
    p1, k1, l1, l2, k2, p2 = (graph_ms(c) * n for c, n in zip(
        (plain, kernel, gemms, gemms, kernel, plain),
        (per_step[1], per_step[0], per_step[2], per_step[2], per_step[0], per_step[1])))
    k_ms, p_ms, l_ms = (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2
    print(f"[timing] {card}: fir_block {k_ms:.4f} ms a config[2] step ({k1:.4f}, {k2:.4f}; four "
          f"launches), plain (banded matmul) {p_ms:.4f} ({p1:.4f}, {p2:.4f}), cuBLAS's banded "
          f"gemms alone {l_ms:.4f} ({l1:.4f}, {l2:.4f}), by graph replay at [{C2}, {T2}], 129 taps")
    return k_ms, p_ms, l_ms


def fm_chain(device, parallel: bool = True) -> FmStereoRx:
    """config[2]'s chain; with ``parallel`` False its de-emphasis filters run
    the sequential recurrence (iir_scan)."""
    rx = make_fmstereo(C2, device)
    return rx if parallel else rx.replace(deemph_l=rx.deemph_l.replace(parallel=False),
                                          deemph_r=rx.deemph_r.replace(parallel=False))


def phase_main_path_config2(device) -> dict:
    """Stream N_BLOCKS config[2] blocks through FmStereoRx.step (iir_chunked
    twice a block), held against the same chain with the de-emphasis on its
    plain version; then N_FM_SEQ blocks with the de-emphasis on iir_scan;
    block splits. Returns each kernel's launches from its run."""
    rng = np.random.default_rng(FM_SEED)
    blocks = [fm_block(rng, (C2, T2), device) for _ in range(N_BLOCKS)]
    rx = fm_chain(device)
    torch.cuda.synchronize()
    reset_counts()
    outs = []
    for x in blocks:
        left, right, level, rx = rx.step(x)
        outs.append((left, right, level))
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"[main-path] FmStereoRx.step: {N_BLOCKS} blocks of [{C2}, {T2}] complex64, kernel "
          f"launches {counts}")
    want_n = {"iir_chunked_apply": 2 * N_BLOCKS, "fir_block_apply": 4 * N_BLOCKS}
    require(all(v == want_n.get(k, 0) for k, v in counts.items()),
            f"launches {counts}: want {want_n}, no other")
    launches = {"iir_chunked": counts["iir_chunked_apply"], "fir_block": counts["fir_block_apply"]}

    plain = fm_chain(device)
    worst = [0.0, 0.0, 0.0]
    for i, (x, (left, right, level)) in enumerate(zip(blocks, outs)):
        lp, rp, pp, plain = plain._step(x, plain=True)
        require(tuple(left.shape) == tuple(right.shape) == (C2, T2) and tuple(level.shape) == (C2,)
                and left.dtype == right.dtype == level.dtype == torch.float32, f"block {i}: shapes")
        require(bool(torch.isfinite(left).all() & torch.isfinite(right).all()), f"block {i}: finite")
        errs = [rel_max(lp, left), rel_max(rp, right), rel_max(pp, level)]
        require(max(errs[:2]) < IIR_TF_TOL and errs[2] < FM_LEVEL_TOL,
                f"block {i}: vs the plain chain {errs}")
        worst = [max(w, e) for w, e in zip(worst, errs)]
    # the FIRs' windows: copies of the composite (pilot, delay) and of its
    # delay (sum, exact on both routes: one unit tap), and of the mix, which
    # the pilot's two routes round apart
    state_errs = [rel_max(getattr(plain, f).v, getattr(rx, f).v) for f in ("deemph_l", "deemph_r")]
    state_errs.append(rel_max(plain.diff_lp.window, rx.diff_lp.window))
    other = [d for d in state_diff(rx, plain)
             if not d.startswith("deemph_") and not d.startswith("diff_lp.window")]
    print(f"[main-path] FmStereoRx vs the chain with its FIRs and de-emphasis on their plain "
          f"versions over {N_BLOCKS} blocks: max |a - b| / max |a| L {worst[0]:.3e}, R "
          f"{worst[1]:.3e} (< {IIR_TF_TOL}), pilot level {worst[2]:.3e} (< {FM_LEVEL_TOL}); "
          f"de-emphasis states {state_errs[0]:.3e}, {state_errs[1]:.3e}, the difference's window "
          f"{state_errs[2]:.3e}; other state fields that differ {other}; pilot level "
          f"{outs[-1][2].mean().item():.4f} (mean)")
    require(max(state_errs) < IIR_TF_TOL and not other, "carried state vs the plain chain")

    seq = fm_chain(device, parallel=False)
    torch.cuda.synchronize()
    reset_counts()
    s_outs = []
    for x in blocks[:N_FM_SEQ]:
        left, right, _, seq = seq.step(x)
        s_outs.append((left, right))
    torch.cuda.synchronize()
    counts = read_counts()
    launches["iir_scan"] = counts["iir_scan_apply"]
    errs = [max(rel_max(o[j], so[j]) for o, so in zip(outs, s_outs)) for j in (0, 1)]
    print(f"[main-path] FmStereoRx, de-emphasis sequential: {N_FM_SEQ} blocks, kernel launches "
          f"{counts}; vs the chunked route max |a - b| / max |a| L {errs[0]:.3e}, R {errs[1]:.3e}")
    require(counts["iir_scan_apply"] == 2 * N_FM_SEQ and counts["iir_chunked_apply"] == 0
            and counts["fir_block_apply"] == 4 * N_FM_SEQ,
            f"launches {counts}: want {2 * N_FM_SEQ} of iir_scan_apply, {4 * N_FM_SEQ} of "
            "fir_block_apply")
    require(max(errs) < IIR_TF_TOL, "sequential route vs the chunked one")

    # one 2T block equals two T blocks, the chain and a 5th-order Butterworth
    # lowpass alone (tests/test_iir_parallel.py::test_block_split_invariance)
    x2 = torch.cat(blocks[:2], -1)
    one = fm_chain(device).step(x2)
    a = fm_chain(device).step(blocks[0])
    b = a[3].step(blocks[1])
    split = [rel_max(one[j], torch.cat([a[j], b[j]], -1)) for j in (0, 1)]
    lp = IirFilter.create_lowpass(5, 0.2, batch_shape=(C2,), device=device).parallelize()
    r2 = planes(rng, (C2, 2 * T2), device)
    y_all, _ = lp.execute_block(r2)
    y_a, lp2 = lp.execute_block(r2[:, :T2])
    y_b, _ = lp2.execute_block(r2[:, T2:])
    split.append(rel_max(y_all, torch.cat([y_a, y_b], -1)))
    print(f"[main-path] block split 2T vs T+T: FmStereoRx L {split[0]:.3e}, R {split[1]:.3e}; "
          f"Butterworth 5 on iir_chunked {split[2]:.3e} (< {IIR_SPLIT_TOL})")
    require(max(split) < IIR_SPLIT_TOL, f"block split {split}")
    return launches


def phase_signal_config2(device) -> None:
    """tests/test_aux.py's stereo test in 4 channels: L and R tones (0.8 at
    0.010, 0.5 at 0.021, each channel its own phase) pilot-stereo encoded, FM
    modulated (kf 0.25), decoded by FmStereoRx (kf 0.125, no de-emphasis):
    tone amplitudes within 5%, separation above 40 dB."""
    n, c, fp, d = 1 << 15, 4, 0.095, 600
    t = np.arange(n)
    ph = np.arange(c)[:, None] * 0.7
    L = 0.8 * np.sin(2 * np.pi * 0.010 * t + ph)
    R = 0.5 * np.sin(2 * np.pi * 0.021 * t + ph)
    comp = (0.5 * (L + R) + 0.1 * np.cos(2 * np.pi * fp * t)
            + 0.5 * (L - R) * np.cos(2 * np.pi * 2 * fp * t))
    iq, _ = Freqmod.create(0.25, batch_shape=(c,), device=device).modulate(
        torch.from_numpy((comp * 0.5).astype(np.float32)).to(device))
    rx = FmStereoRx.create(kf=0.125, f_pilot=fp, deemph_alpha=1.0, batch_shape=(c,), device=device)
    left, right, _, _ = rx.step(iq)
    e = torch.from_numpy(np.exp(-2j * np.pi * np.outer([0.010, 0.021], t[d:]))).to(device)

    def amp(x):  # [c, 2]: 2·|mean(x·e^{−j2πft})| at the two tones
        return 2 * (x[:, d:].to(torch.complex128) @ e.T / (n - d)).abs()

    al, ar = amp(left), amp(right)
    sep_l = 20 * torch.log10(al[:, 0] / al[:, 1])
    sep_r = 20 * torch.log10(ar[:, 1] / ar[:, 0])
    print(f"[signal] FM stereo in {c} channels, n = {n}: L tone {al[:, 0].tolist()} (0.8), R tone "
          f"{ar[:, 1].tolist()} (0.5); separation L {sep_l.min().item():.1f} dB, R "
          f"{sep_r.min().item():.1f} dB (> 40)")
    require(bool(((al[:, 0] - 0.8).abs() <= 0.04).all() & ((ar[:, 1] - 0.5).abs() <= 0.025).all()),
            "tone amplitudes within 5%")
    require(bool((sep_l > 40).all() & (sep_r > 40).all()), "stereo separation > 40 dB")


def config4_blocks(n_blocks: int, device) -> torch.Tensor:
    """config[4]'s input as bench.py:85-125 draws it (seed 1, float64
    standard-normal real parts, then imaginary parts, as complex64), block
    after block from one generator: [n_blocks, T4·M4] on ``device``."""
    rng = np.random.default_rng(CHZ_SEED)
    n = T4 * M4
    return torch.stack([torch.from_numpy(
        (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)).to(device)
        for _ in range(n_blocks)])


def held(what: str, got: torch.Tensor, want: torch.Tensor, gate) -> str:
    """Bit identity, or where that fails the path's tolerance gate (a
    callable that returns (error, passed)); which of the two held."""
    require(got.shape == want.shape, f"{what}: shape {tuple(got.shape)}, want {tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), f"{what}: finite")
    if torch.equal(got, want):
        return "bit-identical"
    err, ok = gate()
    require(ok, f"{what}: not bit-identical, and outside the gate ({err:.3e})")
    return f"not bit-identical (max |a - b| {(got - want).abs().max().item():.3e}); gate {err:.3e}"


def phase_parallel(device, card: str) -> None:
    """yagi_tpu_torch.parallel over NCCL, one rank a card: in this process
    at world size 1 where there is one card, one
    spawned process a card where there are more. config[4] at full width
    streamed through sharded_channelize_stream_fm_to_channels, held against
    Firpfbch → Freqdem block by block with carried state; the other three
    channelizer functions once; time_sharded_fir at config[0]'s width against
    FirFilter.execute_block, with and without history; the gather_to_hosts
    round trip; then the streamed path's eager rate beside the unsharded
    Firpfbch → Freqdem step. Every rank checks the gathered outputs, so a
    failure stops all of them."""
    with socket.socket() as sk:  # a free port on this host: no network
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n > 1:
        torch.multiprocessing.spawn(parallel_rank, args=(n, port, card), nprocs=n, join=True)
    else:
        parallel_rank(0, 1, port, card, device)


def parallel_rank(rank: int, world: int, port: int, card: str, device=None) -> None:
    """One rank of phase_parallel; ``device`` None is this rank's card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device is None or device.type == "cuda"  # a CPU rehearsal runs gloo
    initialize_multihost(f"tcp://127.0.0.1:{port}", world, rank,
                         backend=None if on_card else "gloo")
    try:
        if device is None:
            device = torch.device("cuda", torch.cuda.current_device())
        want = "nccl" if on_card else "gloo"
        require(dist.get_backend() == want, f"backend {dist.get_backend()}")
        mesh = make_stream_mesh(device_type=None if on_card else "cpu")  # the card by default
        require(mesh.device_type == device.type and tuple(mesh.shape) == (1, world)
                and tuple(global_time_mesh(device_type=mesh.device_type).shape) == (1, world),
                f"mesh {mesh}")
        say(f"[parallel] {want} world of {world} rank(s), one a card ({torch.cuda.device_count()} "
            f"card(s)); mesh {mesh.mesh_dim_names} {tuple(mesh.shape)} on {mesh.device_type}")
        parallel_config4(device, mesh, card)
        parallel_fir(device, mesh)
    finally:
        dist.destroy_process_group()


def say(msg: str) -> None:
    """Print on rank 0 only."""
    if dist.get_rank() == 0:
        print(msg, flush=True)


def fm_gate(fm, fm_ref, y_ref, prev) -> tuple[float, bool]:
    err, _ = fm_phase_err(fm, fm_ref, y_ref, prev)
    return err, err <= FM_TOL


def gathered(y_local: torch.Tensor, dim: int) -> torch.Tensor:
    """gather_to_hosts, back on y_local's device."""
    return torch.from_numpy(gather_to_hosts(y_local, dim)).to(y_local.device)


def parallel_config4(device, mesh, card: str) -> None:
    rank, world = dist.get_rank(), dist.get_world_size()
    blocks = config4_blocks(N_BLOCKS, device)  # every rank draws the stream, keeps its share
    n = T4 * M4
    per = n // world
    mine = blocks[:, rank * per:(rank + 1) * per].contiguous()
    chz = Firpfbch.create_kaiser(M4, CHZ["m"], CHZ["as_"], device=device)
    p = chz.p
    m = gathered(sharded_channelize_stream_fm_to_channels(chz, KF, mine, mesh), 1)

    ref = Firpfbch.create_kaiser(M4, CHZ["m"], CHZ["as_"], device=device)
    dem = Freqdem.create(KF, (M4,), device=device)
    ys, fms = [], []
    for x in blocks:
        y, ref = ref.analyzer_execute(x)
        fm, dem = dem.demodulate(y)
        ys.append(y)
        fms.append(fm)
    y_ref, fm_ref = torch.stack(ys), torch.stack(fms)
    whole = torch.equal(m, fm_ref)
    prev = torch.cat([torch.zeros_like(y_ref[:1, :, -1]), y_ref[:-1, :, -1]])

    def gate():
        worst = max(fm_gate(m[i], fm_ref[i], y_ref[i], prev[i])[0] for i in range(N_BLOCKS))
        return worst, worst <= FM_TOL

    how = held("stream FM, blocks 1..", m[1:], fm_ref[1:], gate)
    how0 = held("stream FM, block 0 past the transient", m[0][:, p + 1:], fm_ref[0][:, p + 1:],
                gate)
    say(f"[parallel] sharded_channelize_stream_fm_to_channels: {N_BLOCKS} blocks of {n} "
        f"complex64 (M={M4}, T={T4}, p={p}, kf={KF}, bench.py's seed {CHZ_SEED}) over {world} "
        f"rank(s), gathered, against Firpfbch -> Freqdem block by block: blocks 1..{N_BLOCKS - 1} "
        f"{how}; block 0 from step {p + 1} {how0}; all {N_BLOCKS} blocks whole bit-identical "
        f"{whole}")

    y0, fm0 = y_ref[0], fm_ref[0]
    x_local = distribute_time_stream(mine[0], mesh)
    require(x_local.data_ptr() == mine[0].data_ptr(), "distribute_time_stream copied the block")

    def rms_gate(got):
        return lambda: (rel_rms(y0[:, p:], got[:, p:]), rel_rms(y0[:, p:], got[:, p:]) < CHZ_TOL)

    y2_local = sharded_channelize_to_channels(chz, x_local, mesh)
    y1 = gathered(sharded_channelize(chz, x_local, mesh), -1)
    y2 = gathered(y2_local, 0)
    m1 = gathered(sharded_channelize_fm(chz, KF, x_local, mesh), -1)
    h1 = held("sharded_channelize", y1[:, p:], y0[:, p:], rms_gate(y1))
    h2 = held("sharded_channelize_to_channels", y2[:, p:], y0[:, p:], rms_gate(y2))
    h3 = held("sharded_channelize_fm", m1[:, p + 2:], fm0[:, p + 2:],
              lambda: fm_gate(m1[:, p + 2:], fm0[:, p + 2:], y0[:, p + 2:], y0[:, p + 1]))
    say(f"[parallel] one block of {n}: sharded_channelize {h1}; sharded_channelize_to_channels "
        f"(all_to_all) {h2}; sharded_channelize_fm ((p+1)·M halo) {h3}; against Firpfbch "
        f"(-> Freqdem) from step p (FM p + 2); FM gate {FM_TOL} rad, channels {CHZ_TOL} of the rms")
    group = M4 // world
    require(torch.equal(y2[rank * group:(rank + 1) * group], y2_local), "gather_to_hosts round trip")
    say(f"[parallel] gather_to_hosts round trip: {tuple(y2.shape)} {y2.dtype}, each rank's group "
        f"in place; distribute_time_stream kept the block in place on {x_local.device}")

    def stream():
        return sharded_channelize_stream_fm_to_channels(chz, KF, mine, mesh)

    state = [Firpfbch.create_kaiser(M4, CHZ["m"], CHZ["as_"], device=device),
             Freqdem.create(KF, (M4,), device=device), 0]

    def step():
        y, state[0] = state[0].analyzer_execute(blocks[state[2] % N_BLOCKS])
        _, state[1] = state[1].demodulate(y)
        state[2] += 1

    s_ms = cuda_ms(stream, 3, warmup=1)
    u_ms = cuda_ms(step, 2 * N_BLOCKS)
    say(f"[timing] {card}: parallel/ streamed config[4] over {world} rank(s) "
        f"(sharded_channelize_stream_fm_to_channels, {N_BLOCKS} blocks of {n}, {per} a rank): "
        f"{N_BLOCKS * n / (s_ms * 1e-3) / 1e6:.1f} Msps ({s_ms:.3f} ms a call, rank 0); "
        f"unsharded Firpfbch -> Freqdem step on one card {n / (u_ms * 1e-3) / 1e6:.1f} Msps "
        f"({u_ms:.3f} ms a block); input complex Msamples/s, eager calls between CUDA events")


def parallel_fir(device, mesh) -> None:
    rank, world = dist.get_rank(), dist.get_world_size()
    rng = np.random.default_rng(SEED + 20)
    h = fir_design_kaiser(CHAIN["n_taps"], CHAIN["fc"], CHAIN["as_"], 0.0)
    L = len(h)
    x = complex_block(rng, (C, T), device)
    hist = complex_block(rng, (C, L - 1), device)
    step = T // world
    base = FirFilter.create(h, batch_shape=(C,), dtype=torch.complex64, device=device)
    for name, hh, f in (("without history", None, base), ("with history", hist, base.write(hist))):
        y = gathered(time_sharded_fir(h, x[:, rank * step:(rank + 1) * step], mesh, history=hh),
                     -1)
        parts = []
        for b in range(world):  # the same time blocks in sequence
            yb, f = f.execute_block(x[:, b * step:(b + 1) * step])
            parts.append(yb)
        want = torch.cat(parts, dim=-1)
        how = held(f"time_sharded_fir {name}", y, want,
                   lambda: (rel_err(want, y), rel_err(want, y) < REL_TOL))
        say(f"[parallel] time_sharded_fir {name}: [{C}, {T}] complex64 over {world} rank(s), "
            f"{L} Kaiser taps, against FirFilter.execute_block over the same blocks: {how}")


def phase_fft(device) -> None:
    """fft_run / ifft_run on the card against the reference's golden vectors
    (tests/golden/fft.npz, tolerance 2e-4 as tests/test_fft.py), and one
    Spgram (nfft 1024) over a config[4] block against the same object on
    the CPU."""
    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tests", "golden", "fft.npz"))
    worst = [0.0, 0.0]
    for n in FFT_SIZES:
        x = torch.from_numpy(golden[f"FFT_TEST_X{n}"]).to(device)
        y = fft_run(x)
        z = ifft_run(y) / n
        worst = [max(worst[0], (y.cpu() - torch.from_numpy(golden[f"FFT_TEST_Y{n}"])).abs()
                     .max().item()), max(worst[1], (z - x).abs().max().item())]
    print(f"[fft] fft_run / ifft_run on {device} at the {len(FFT_SIZES)} golden sizes "
          f"{FFT_SIZES[0]}..{FFT_SIZES[-1]}: max abs err forward {worst[0]:.3e}, round trip "
          f"{worst[1]:.3e} (< {FFT_TOL})")
    require(max(worst) < FFT_TOL, f"fft against the golden vectors {worst}")

    x = config4_blocks(1, device)[0]
    sp = Spgram.create(SPGRAM_NFFT, device=device).write(x)
    sp_cpu = Spgram.create(SPGRAM_NFFT, device="cpu").write(x.cpu())
    a, b = sp.get_psd_mag().cpu(), sp_cpu.get_psd_mag()
    err = ((a - b).abs() / b).max().item()
    print(f"[fft] Spgram(nfft={SPGRAM_NFFT}) over a config[4] block ({x.numel()} samples, "
          f"{sp.num_transforms} transforms) on the card against the CPU: max relative err of "
          f"the PSD {err:.3e} (< {SPGRAM_TOL}); {10 * np.log10(a.mean().item()):.2f} dB mean")
    require(sp.num_transforms == sp_cpu.num_transforms and err < SPGRAM_TOL,
            f"Spgram card vs CPU {err}")


def filter_tols(name: str) -> tuple[float, float]:
    """An L4 object's tolerances: against one long block, against the CPU."""
    if name.startswith("OrdFilt"):
        return 0.0, 0.0
    if "farrow" in name:
        return FARROW_SPLIT_TOL, FARROW_TOL
    return FILTER_TOL, FILTER_TOL


def filter_stream(st, step, x, blocks) -> tuple:
    """x through ``step`` in the given blocks, the state carried: the
    concatenated valid output (read back by its count) and the final
    state."""
    ys, pos = [], 0
    for n in blocks:
        y, k, st = step(st, x[..., pos : pos + n])
        ys.append(y if k is None else y[..., : int(k)])
        pos += n
    return torch.cat(ys, dim=-1), st


def empty_block_objects(device) -> dict:
    """tests/test_torch_empty_block.py's objects on ``device``: name →
    (object, step(obj, x) → (outputs..., state), real input?)."""
    b = dict(batch_shape=(2,), device=device)
    return {
        "Agc": (Agc.create(bandwidth=0.01, **b), lambda o, x: o.execute_block(x), False),
        "Symsync": (Symsync.create_rnyquist(FirFilterShape.RRCOS, 2, 7, 0.3, num_filters=32, **b),
                    lambda o, x: o.execute_slots(x), False),
        "QamRx": (QamRx.create(**b), lambda o, x: o.step_masked(x), False),
        "Firpfbch2": (Firpfbch2.create(8, 3, 60.0, **b), lambda o, x: o.analyzer_execute(x),
                      False),
        "Firpfbchr": (Firpfbchr.create_kaiser(8, 2, 3, **b), lambda o, x: o.analyzer_execute(x),
                      False),
        "Resamp 1.37": (Resamp.create(1.37, **b),
                        lambda o, x: o.execute_block(x, out_capacity=96), False),
        "Resamp 2.0": (Resamp.create(2.0, **b),
                       lambda o, x: o.execute_block(x, out_capacity=136), False),
        "MsResamp 1.37": (MsResamp.create(1.37, **b), lambda o, x: o.execute_block(x), False),
        "FirFilter": (FirFilter.create_kaiser(21, 0.2, 60.0, **b),
                      lambda o, x: o.execute_block(x), False),
        "RxChain": (RxChain.create(**b), lambda o, x: o.step(x), False),
        "Freqmod": (Freqmod.create(0.3, **b), lambda o, x: o.modulate(x), True),
        "Freqdem": (Freqdem.create(0.3, **b), lambda o, x: o.demodulate(x), False),
        "FmStereoRx": (FmStereoRx.create(kf=0.125, f_pilot=0.095, **b),
                       lambda o, x: o.step(x), False),
    }


def phase_empty_blocks(device) -> None:
    """Every repaired object on the card: a block of 0 samples returns no
    samples (or a count of 0 and zeros) and keeps the state, so [0, 64]
    equals the block of 64 alone, state included."""
    rng = np.random.default_rng(3)
    x = complex_block(rng, (2, EMPTY_N), device)
    for name, (obj, step, real) in empty_block_objects(device).items():
        xi = x.real.contiguous() if real else x
        *y0, o0 = step(obj, xi[..., :0])
        for y in y0:  # no samples, zeros, a count of 0, or a level over no samples
            require(y.numel() == 0 or not y.any() or (y.is_floating_point() and y.shape == (2,)),
                    f"{name}: the empty block's output {tuple(y.shape)}")
        *ya, oa = step(o0, xi)
        *yb, ob = step(obj, xi)
        err = 0.0
        for a, b in zip(ya + tensors_of(oa), yb + tensors_of(ob)):
            if a.is_floating_point() or a.is_complex():
                err = max(err, filter_err(a, b))
            else:
                require(torch.equal(a, b), f"{name}: [0, {EMPTY_N}] vs [{EMPTY_N}] integers")
        print(f"[filters] empty block, {name} on {device}: [0, {EMPTY_N}] = [{EMPTY_N}] within "
              f"{err:.3e}, outputs and state (<= {FILTER_TOL})")
        require(err <= FILTER_TOL, f"{name}: [0, {EMPTY_N}] vs [{EMPTY_N}] {err}")


def filter_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| over max(1, max |b|)."""
    return ((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item()


def phase_filters(device, card: str) -> None:
    """The empty-block repairs on the card; then layer L4's streaming
    filters at config[1]'s width: each streamed over FILTER_BLOCKS (an empty
    block among them) against one long block, every output and state tensor
    on the card, and FILTER_CUT channels against the CPU; then each
    object's device time a block from CUDA events."""
    phase_empty_blocks(device)
    rng = np.random.default_rng(2)
    x = complex_block(rng, (C1, sum(FILTER_BLOCKS)), device)
    x_cut = x[:FILTER_CUT].cpu()
    objs = make_filters(C1, T1, device)
    objs_cpu = make_filters(FILTER_CUT, T1, torch.device("cpu"))
    for (name, st, step), (_, st_cpu, _) in zip(objs, objs_cpu):
        tol_split, tol_cpu = filter_tols(name)
        t0 = time.perf_counter()
        y, end = filter_stream(st, step, x, FILTER_BLOCKS)
        y_long, _ = filter_stream(st, step, x, (x.shape[-1],))
        parts = end if isinstance(end, tuple) else (end,)
        where = {t.device for p in parts for t in tensors_of(p)} | {y.device}
        require(where == {device}, f"{name}: tensors on {where}, want {device}")
        e_split = filter_err(y, y_long)
        require(y.shape == y_long.shape and e_split <= tol_split,
                f"{name}: streamed vs one long block {e_split} > {tol_split}")
        y_cpu, _ = filter_stream(st_cpu, step, x_cut, FILTER_BLOCKS)
        e_cpu = filter_err(y[:FILTER_CUT].cpu(), y_cpu)
        require(y_cpu.shape == y[:FILTER_CUT].shape and e_cpu <= tol_cpu,
                f"{name}: card vs CPU {e_cpu} > {tol_cpu}")
        torch.cuda.synchronize()
        check_s = time.perf_counter() - t0
        xb = x[..., : T1]
        ms = cuda_ms(lambda: step(st, xb), N_FILTER_TIMED)
        print(f"[filters] {name}: {C1} x {FILTER_BLOCKS} streamed = one long block within "
              f"{e_split:.3e} (<= {tol_split}), {FILTER_CUT} channels = the CPU within "
              f"{e_cpu:.3e} (<= {tol_cpu}); "
              f"{ms:.4f} ms a block of {C1} x {T1} between CUDA events ({card}); "
              f"checks {check_s:.1f} s")


def capture_chain(blocks, fz: FusedChannelizer, dem: Freqdem) -> tuple:
    """Planar (re, im) blocks through K2 → Freqdem with the state carried:
    [(re, im, yr, yi, fm)] and the final states."""
    outs = []
    for re, im in blocks:
        yr, yi, fz = fz.analyzer_execute_planar(re, im)
        fm, dem = dem.demodulate(torch.complex(yr, yi).T)  # channel-major view
        outs.append((re, im, yr, yi, fm))
    return outs, fz, dem


def write_capture(path: str, fmt: str, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (complex64 on the CPU) interleaved and quantized into ``path`` as
    tests/test_native_kernels.py:113-140 does; returns the planes the file
    holds, dequantized (the loader's arithmetic: q·2^-15, (q − 128)·2^-7)."""
    inter = torch.view_as_real(x).reshape(-1).numpy()
    if fmt == "cf32":
        inter.tofile(path)
        return x.real.contiguous(), x.imag.contiguous()
    if fmt == "ci16":
        q = np.clip(np.round(inter * 32768), -32768, 32767).astype(np.int16)
        q.tofile(path)
        deq = torch.from_numpy(q).float() * (1.0 / 32768)
    else:
        q = np.clip(np.round(inter * 128) + 128, 0, 255).astype(np.uint8)
        q.tofile(path)
        deq = (torch.from_numpy(q).float() - 128) * (1.0 / 128)
    return deq[0::2].contiguous(), deq[1::2].contiguous()


def phase_capture(device, card: str) -> None:
    """A capture file onto the card: config[4]'s stream as ci16 through
    IqStreamLoader (pinned buffers, copies on the stream) into
    FusedChannelizer (K2) → Freqdem, against the same samples fed from
    memory, every block, output and the carried state bit for bit; K2's
    launches on the file feed; the loader's round trip in every format; the
    loader's rate alone and the chain's from memory and from the file."""
    n = T4 * M4
    x = config4_blocks(N_BLOCKS, "cpu").reshape(-1) * CAPTURE_SCALE
    fz0 = FusedChannelizer.create_kaiser(**CHZ, device=device)
    dem0 = Freqdem.create(KF, batch_shape=(M4,), device=device)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, path = tempfile.mkstemp(suffix=".ci16", dir=_build.BUILD_DIR)
    os.close(fd)
    try:
        re, im = write_capture(path, "ci16", x)
        mem = [(re[k * n : (k + 1) * n].to(device), im[k * n : (k + 1) * n].to(device))
               for k in range(N_BLOCKS)]
        del x, re, im
        want, fz_m, dem_m = capture_chain(mem, fz0, dem0)
        torch.cuda.synchronize()
        reset_counts()
        with IqStreamLoader(path, "ci16", block_samples=n, device=device) as src:
            got, fz_f, dem_f = capture_chain(src, fz0, dem0)
            torch.cuda.synchronize()
            launches = read_counts()["fused_channelizer_apply"]
            total = src.total_read()
        require(len(got) == N_BLOCKS, f"capture: {len(got)} blocks from the file")
        for k, (g, w) in enumerate(zip(got, want)):
            require(all(a.device == device and torch.equal(a, b) for a, b in zip(g, w)),
                    f"capture block {k}: file feed vs memory feed (samples, K2, Freqdem)")
        for a, b in zip(tensors_of(fz_f) + tensors_of(dem_f), tensors_of(fz_m) + tensors_of(dem_m)):
            require(torch.equal(a, b), "capture: carried state, file feed vs memory feed")
        require(total == N_BLOCKS * n, f"capture: total_read {total} != {N_BLOCKS * n}")
        require(launches == N_BLOCKS, f"capture: K2 launches {launches} != {N_BLOCKS}")
        print(f"[capture] {N_BLOCKS} blocks of {n} ci16 samples ({os.path.getsize(path)} bytes, "
              f"config[4]'s stream ×{CAPTURE_SCALE}) file -> IqStreamLoader -> FusedChannelizer "
              f"-> Freqdem equal bit for bit to the memory feed: every block, K2's and Freqdem's "
              f"outputs, the carried state; total_read {total}")
        print(f"[capture] K2 (channelizer_fp32) launches on the file feed: {launches}")

        def drain(dev=device):
            with IqStreamLoader(path, "ci16", block_samples=n, device=dev) as src:
                for _ in src:
                    pass

        def from_file():
            with IqStreamLoader(path, "ci16", block_samples=n, device=device) as src:
                capture_chain(src, fz0, dem0)

        samples = N_BLOCKS * n
        rates = [samples / (cuda_ms(fn, N_CAPTURE_TIMED, warmup=1) * 1e-3) / 1e6
                 for fn in (drain, lambda: capture_chain(mem, fz0, dem0), from_file,
                            lambda: drain(torch.device("cpu")))]
        print(f"[capture] {card}: loader alone (read, deinterleave, host-to-device) "
              f"{rates[0]:.1f} Msps; K2 -> Freqdem fed from memory {rates[1]:.1f} Msps; fed from "
              f"the file {rates[2]:.1f} Msps; the loader into host tensors only (device cpu) "
              f"{rates[3]:.1f} Msps (complex Msamples/s over {N_BLOCKS} blocks of {n}, between "
              f"CUDA events, mean of {N_CAPTURE_TIMED} runs after one; the file in the page "
              f"cache)")
    finally:
        os.unlink(path)

    rng = np.random.default_rng(3)
    tail = complex_block(rng, (CAPTURE_TAIL,), "cpu") * 0.5
    for fmt in ("cf32", "ci16", "cu8"):
        fd, path = tempfile.mkstemp(suffix=f".{fmt}", dir=_build.BUILD_DIR)
        os.close(fd)
        try:
            re, im = write_capture(path, fmt, tail)
            with IqStreamLoader(path, fmt, block_samples=CAPTURE_TAIL_BLOCK, device=device) as src:
                blocks = list(src)
                end, total = src.next_block(), src.total_read()
        finally:
            os.unlink(path)
        sizes = [b[0].numel() for b in blocks]
        got_re = torch.cat([b[0] for b in blocks]).cpu()
        got_im = torch.cat([b[1] for b in blocks]).cpu()
        require(all(b[0].device == device for b in blocks) and end == (None, None)
                and total == CAPTURE_TAIL and torch.equal(got_re, re) and torch.equal(got_im, im),
                f"capture round trip {fmt}")
        print(f"[capture] {fmt} round trip on {device}: {CAPTURE_TAIL} samples in blocks {sizes}, "
              f"bit for bit, EOF (None, None)")


def phase_l0(device, card: str) -> None:
    """The tensor-valued parts of layer L0 on the card: every sampler of
    random/ on a CUDA generator against its cdf at the deciles, seeded
    reproducibility, cawgn's power, dotprod against the CPU,
    Modem.random_symbols' range and uniformity, OrdFilt on complex64 against
    the CPU; then the phase's time."""
    t0 = time.perf_counter()

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(seed)

    d = dict(device=device)
    samplers = {
        "randf": (lambda g, k: yr.randf(g, (k,), **d), yr.randf_cdf),
        "randuf": (lambda g, k: yr.randuf(g, -0.5, 2.5, (k,), **d),
                   lambda v: yr.randuf_cdf(v, -0.5, 2.5)),
        "randnf": (lambda g, k: yr.randnf(g, (k,), **d), lambda v: yr.randnf_cdf(v, 0.0, 1.0)),
        "crandnf re": (lambda g, k: yr.crandnf(g, (k,), **d).real,
                       lambda v: yr.randnf_cdf(v, 0.0, 1.0)),
        "crandnf im": (lambda g, k: yr.crandnf(g, (k,), **d).imag,
                       lambda v: yr.randnf_cdf(v, 0.0, 1.0)),
        "randexpf": (lambda g, k: yr.randexpf(g, 2.3, (k,), **d),
                     lambda v: yr.randexpf_cdf(v, 2.3)),
        "randgammaf": (lambda g, k: yr.randgammaf(g, 2.5, 1.2, (k,), **d),
                       lambda v: yr.randgammaf_cdf(v, 2.5, 1.2)),
        "randgammaf a<1": (lambda g, k: yr.randgammaf(g, 0.6, 0.8, (k,), **d),
                           lambda v: yr.randgammaf_cdf(v, 0.6, 0.8)),
        "randnakmf": (lambda g, k: yr.randnakmf(g, 1.5, 1.0, (k,), **d),
                      lambda v: yr.randnakmf_cdf(v, 1.5, 1.0)),
        "randricekf": (lambda g, k: yr.randricekf(g, 2.0, 1.0, (k,), **d),
                       lambda v: yr.randricekf_cdf(v, 2.0, 1.0)),
        "randweibf": (lambda g, k: yr.randweibf(g, 2.0, 1.5, 0.0, (k,), **d),
                      lambda v: yr.randweibf_cdf(v, 2.0, 1.5, 0.0)),
    }
    qs = (0.1, 0.25, 0.5, 0.75, 0.9)
    for name, (draw, cdf) in samplers.items():
        v = draw(gen(7), L0_N)
        require(v.shape == (L0_N,) and v.dtype == torch.float32 and v.device == device
                and bool(torch.isfinite(v).all()), f"{name}: {v.shape} {v.dtype} {v.device}")
        at = torch.sort(v).values[[int(q * L0_N) for q in qs]].double().cpu().numpy()
        err = max(abs(float(cdf(np.array([a]))[0]) - q) for a, q in zip(at, qs))
        a, b, c = draw(gen(11), 1 << 16), draw(gen(11), 1 << 16), draw(gen(12), 1 << 16)
        same = torch.equal(a, b) and not torch.equal(a, c)
        print(f"[l0] {name}: {L0_N} draws on {device}, max |cdf(decile) - q| {err:.4f} "
              f"(<= {L0_DECILE_TOL}); same seed equal, another seed not: {same}")
        require(err <= L0_DECILE_TOL and same, f"{name}: deciles {err}, seeded {same}")

    y = yr.cawgn(gen(0), torch.zeros(L0_N, dtype=torch.complex64, device=device), 0.5)
    power = y.abs().square().mean().item()
    print(f"[l0] cawgn sigma 0.5 over {L0_N}: power {power:.5f} (0.25 within {L0_CAWGN_TOL:.0%})")
    require(abs(power / 0.25 - 1) <= L0_CAWGN_TOL, f"cawgn power {power}")

    rng = np.random.default_rng(0)
    worst = 0.0
    for kind in ("rrrf", "crcf", "cccf"):
        for n in L0_DOT_LENGTHS:
            h = rng.standard_normal(n).astype(np.float32)
            v = rng.standard_normal(n).astype(np.float32)
            if kind == "cccf":
                h = (h + 1j * rng.standard_normal(n)).astype(np.complex64)
            if kind != "rrrf":
                v = (v + 1j * rng.standard_normal(n)).astype(np.complex64)
            ht, vt = torch.from_numpy(h), torch.from_numpy(v)
            got = dotprod(ht.to(device), vt.to(device))
            want = dotprod(ht, vt)
            require(got.device == device, "dotprod on the card")
            scale = (ht.abs().double() * vt.abs().double()).sum().item()
            worst = max(worst, (got.cpu() - want).abs().item() / scale)
    print(f"[l0] dotprod rrrf/crcf/cccf at lengths {L0_DOT_LENGTHS[0]}..{L0_DOT_LENGTHS[-1]}: card "
          f"vs CPU max |a - b| / sum|h x| {worst:.3e} (<= {L0_DOT_RTOL})")
    require(worst <= L0_DOT_RTOL, f"dotprod card vs CPU {worst}")

    m = Modem.create("qam16", device=device)
    s = m.random_symbols(gen(5), L0_N)
    counts = torch.bincount(s, minlength=16).double()
    chi2 = ((counts - L0_N / 16) ** 2 / (L0_N / 16)).sum().item()
    print(f"[l0] Modem.random_symbols qam16 x {L0_N}: range [{int(s.min())}, {int(s.max())}], "
          f"chi-square {chi2:.2f} (< {L0_CHI2_15_999}, 15 dof, p = 0.001)")
    require(s.dtype == torch.int64 and s.device == device and int(s.min()) >= 0
            and int(s.max()) < 16 and chi2 < L0_CHI2_15_999, f"random_symbols chi2 {chi2}")
    require(torch.equal(s[:4096], m.random_symbols(gen(5), L0_N)[:4096]), "random_symbols seeded")

    def ord_step(o, b):
        y, o = o.execute_block(b)
        return y, None, o

    x = complex_block(np.random.default_rng(2), (C1, sum(L0_ORD_BLOCKS)), device)
    outs = []
    for dev in (device, torch.device("cpu")):
        f = OrdFilt.create_medfilt(3, batch_shape=(C1,), device=dev)
        y, f = filter_stream(f, ord_step, x.to(dev), L0_ORD_BLOCKS)
        outs.append((y.cpu(), f.buf.cpu()))
    require(outs[0][0].dtype == torch.complex64 and torch.equal(outs[0][0], outs[1][0])
            and torch.equal(outs[0][1], outs[1][1]), "OrdFilt complex64: card vs CPU")
    print(f"[l0] OrdFilt medfilt(3) on complex64 {C1} x {L0_ORD_BLOCKS}: card = CPU bit for bit, "
          f"outputs and buf")
    torch.cuda.synchronize()
    print(f"[l0] {card}: the phase took {time.perf_counter() - t0:.2f} s")


def stream(obj, step, blocks) -> tuple[list, object]:
    """Each block (a tuple of tensors) through ``step(obj, *block) →
    (outputs..., obj)`` with the state carried: the outputs concatenated
    along time (dim 1) and the final state."""
    outs = []
    for b in blocks:
        *y, obj = step(obj, *b)
        outs.append(y)
    return [torch.cat(ys, 1) for ys in zip(*outs)], obj


def state_tensors(obj) -> list[torch.Tensor]:
    """The tensors of a state object, or of a tuple of them."""
    if isinstance(obj, tuple):
        return [t for o in obj for t in state_tensors(o)]
    return tensors_of(obj)


def state_kinds(obj) -> tuple:
    """:func:`held_to`'s kind of each of :func:`state_tensors`' tensors:
    "a" for a wrapped angle (the differential modem's ``phi`` in (−π, π]),
    "f" for other floats, "i" for integers."""
    if isinstance(obj, tuple):
        return tuple(k for o in obj for k in state_kinds(o))
    kinds = ()
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            kinds += state_kinds(v)
        elif isinstance(v, torch.Tensor):
            floating = v.is_floating_point() or v.is_complex()
            kinds += (("a" if f.name == "phi" else "f") if floating else "i",)
    return kinds


def held_to(got: list, want: list, kinds: tuple, tol: float, what: str) -> float:
    """Hold ``got`` to ``want`` tensor by tensor on got's device: kind "f"
    (floating) within ``tol`` of max |a − b|, "a" (angles) the same modulo
    2π, "i" (integers) equal, "q" (ADC codes) within one code, "s" (soft
    bytes) within one and on the same side of the 127 erasure value.
    Returns the largest float error."""
    err = 0.0
    for a, b, kind in zip(got, want, kinds):
        b = b.to(a.device)
        require(a.shape == b.shape and a.dtype == b.dtype,
                f"{what}: {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
        if a.numel() == 0:
            continue
        if kind == "f":
            err = max(err, (a - b).abs().max().item())
        elif kind == "a":
            err = max(err, torch.remainder(a - b + np.pi, 2 * np.pi).sub(np.pi).abs().max().item())
        elif kind == "i":
            require(torch.equal(a, b), f"{what}: {int((a != b).sum())} integers differ")
        else:
            d = (a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
            same_side = kind == "q" or torch.equal(torch.sign(a.to(torch.int64) - 127),
                                                   torch.sign(b.to(torch.int64) - 127))
            require(d <= 1 and same_side, f"{what}: codes {d} apart, same side {same_side}")
    require(err <= tol, f"{what}: {err:.3e} > {tol:.3e}")
    return err


def modem_run(name: str, make, step, blocks: list, kinds: tuple, tol, card: str,
              split_tol: float | None = None) -> tuple[list, object, dict]:
    """One object of layers L3, L5 and L6 (or a chain of them) at full width on
    the card:

    * ``blocks`` (tuples of [c, ...] card tensors) streamed with the state
      carried, every output and state tensor on the card; the launch counts
      set to 0 just before this stream and read just after;
    * the first MOD_CUT channels against the port's CPU run of the same
      blocks (``kinds`` per output; the state's floats within ``tol``, its
      integers equal); ``tol`` may be a function of the card's final state;
    * blocks [N, 0, N] against one block of 2N on the card (within
      ``split_tol`` where given, else ``tol``);
    * a block's device time between CUDA events.

    Returns the card's outputs, its final state and the launch counts."""
    c = blocks[0][0].shape[0]
    dev = blocks[0][0].device
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    reset_counts()
    outs, obj = stream(make(c, dev), step, blocks)
    torch.cuda.synchronize()
    counts = read_counts()
    where = {t.device for t in outs + state_tensors(obj)}
    require(where == {dev}, f"{name}: tensors on {where}, want {dev}")
    tol = tol(obj) if callable(tol) else tol
    st, st_kinds = state_tensors(obj), state_kinds(obj)

    def head(t):
        return t[:MOD_CUT] if t.dim() and t.shape[0] == c else t

    outs_c, obj_c = stream(make(MOD_CUT, cpu), step,
                           [tuple(x[:MOD_CUT].cpu() for x in b) for b in blocks])
    e_cpu = held_to([head(t) for t in outs + st], outs_c + state_tensors(obj_c),
                    kinds + st_kinds, tol, f"{name}: card vs CPU")
    two = tuple(torch.cat([x, y], 1) for x, y in zip(blocks[0], blocks[1]))
    split = [blocks[0], tuple(x[:, :0] for x in blocks[1]), blocks[1]]
    o_long, s_long = stream(make(c, dev), step, [two])
    o_split, s_split = stream(make(c, dev), step, split)
    split_tol = tol if split_tol is None else split_tol
    e_split = held_to(o_split + state_tensors(s_split), o_long + state_tensors(s_long),
                      kinds + st_kinds, split_tol, f"{name}: [N, 0, N] vs [2N]")
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    fresh = make(c, dev)
    ms = cuda_ms(lambda: step(fresh, *blocks[0]), N_MOD_TIMED, warmup=1)
    shape = "x".join(str(s) for s in blocks[0][0].shape)
    print(f"[modems] {name}: {len(blocks)} blocks of {shape}; {MOD_CUT} channels = the CPU "
          f"within {e_cpu:.3e} (<= {tol:.3e}), [N, 0, N] = [2N] within {e_split:.3e} (<= "
          f"{split_tol:.3e}); "
          f"{ms:.4f} ms a block between CUDA events ({card}); checks {check_s:.1f} s")
    return outs, obj, counts


def cum_tol(n: int, mag: float) -> float:
    """The tolerance of a float32 cumulative product or sum over n samples
    (the differential modulators' phase rotation, the CPM phases): computed
    in two orders, they round apart as a random walk, so 1e-6 + 8·√n ulps
    of the largest magnitude the stream reached."""
    return 1e-6 + 8 * np.sqrt(n) * EPS32 * max(1.0, mag)


def mod_blocks(*arrays) -> list:
    """Tensors [c, MOD_BLOCKS·n, ...] (n may differ between them) cut into
    MOD_BLOCKS tuples of blocks."""
    ns = [a.shape[1] // MOD_BLOCKS for a in arrays]
    return [tuple(a[:, i * n:(i + 1) * n] for a, n in zip(arrays, ns)) for i in range(MOD_BLOCKS)]


def errors_after(got: torch.Tensor, sent: torch.Tensor, delay: int) -> int:
    """Decisions that differ from the symbols sent ``delay`` symbols earlier."""
    n = got.shape[1] - delay
    return int((got[:, delay:].to(torch.int64) != sent[:, :n].to(torch.int64)).sum())


def phase_modems(device, card: str) -> None:
    """Layers L3, L5 and L6 and the channel models at full width, each
    object held against its CPU run, a block split and an empty block, the
    decisions at 30 dB, iir_chunked on AmpModem's shape against its plain
    version; each object's device time a block."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(MOD_SEED)
    gen = torch.Generator(device=device).manual_seed(MOD_SEED)

    def noise(shape) -> torch.Tensor:
        """A standard complex normal draw on the card (fed to both sides)."""
        re = torch.randn(shape, generator=gen, device=device)
        return torch.complex(re, torch.randn(shape, generator=gen, device=device))

    def ints(hi: int, shape) -> torch.Tensor:
        return torch.from_numpy(rng.integers(0, hi, shape)).to(device)

    c, nb = MOD_C, MOD_BLOCKS

    # 1. the 16-QAM link: modulate → Channel (multipath, carrier offset,
    # 30 dB) → 12-bit quantizer (I and Q); then the receiver on the card's
    # quantized samples: an "nco" Osc takes the known offset off, demodulate,
    # demodulate_soft, demodulate_with_stats
    q = Quantizer(MOD_ADC_BITS)
    sym = ints(16, (c, nb * QAM_SYMS))

    def tx_make(cc, dev):
        return (Modem.create("qam16", batch_shape=(cc,), device=dev),
                Channel.create(MOD_SNR_DB, MOD_DPHI, MOD_PHI, MOD_TAPS, batch_shape=(cc,),
                               device=dev))

    def tx_step(st, s, w):
        m, ch = st
        y, m = m.modulate(s)
        y, ch = ch.execute(None, y, noise=w)
        qr, qi = q.execute_adc(y.real * MOD_ADC_GAIN), q.execute_adc(y.imag * MOD_ADC_GAIN)
        return y, qr, qi, (m, ch)

    (_, qr, qi), _, _ = modem_run("16-QAM tx: Modem → Channel → Quantizer", tx_make, tx_step,
                                  mod_blocks(sym, noise((c, nb * QAM_SYMS))), ("f", "q", "q"),
                                  MOD_TOL, card)
    yq = torch.complex(q.execute_dac(qr), q.execute_dac(qi)) / MOD_ADC_GAIN

    def rx_make(cc, dev):
        osc = Osc.create("nco", batch_shape=(cc,), device=dev)
        return (osc.set_frequency(MOD_DPHI).set_phase(MOD_PHI),
                Modem.create("qam16", batch_shape=(cc,), device=dev))

    def rx_step(st, y):
        osc, m = st
        y, osc = osc.mix_block_down(y)
        s, m = m.demodulate(y)
        s_soft, soft, m = m.demodulate_soft(y)
        s_st, x_hat, pe, evm, m = m.demodulate_with_stats(y)
        require(torch.equal(s, s_soft) and torch.equal(s, s_st), "16-QAM: the three decisions")
        return s, soft, x_hat, pe, evm, (osc, m)

    (s, soft, _, _, evm), _, _ = modem_run(
        "16-QAM rx: Osc nco → demodulate, _soft, _with_stats", rx_make, rx_step,
        mod_blocks(yq), ("i", "s", "f", "f", "f"), MOD_TOL, card)
    ser = errors_after(s, sym, 0) / s.numel()
    print(f"[modems] 16-QAM link at {MOD_SNR_DB:g} dB, taps {MOD_TAPS}, offset {MOD_DPHI} "
          f"rad/sample, {MOD_ADC_BITS}-bit ADC: symbol error rate {ser:.2e} (<= {QAM_SER_MAX}) "
          f"over {s.numel()} symbols, mean EVM {evm.mean().item():.4f}")
    require(ser <= QAM_SER_MAX and soft.shape == (c, nb * QAM_SYMS, 4), f"16-QAM SER {ser}")

    # differential schemes through the differential demodulator, and QPSK,
    # over a channel with no multipath (carrier offset only for the
    # differential ones), at 30 dB
    for scheme, dphi in (("dpsk4", MOD_DPHI), ("pi4dqpsk", MOD_DPHI), ("qpsk", 0.0)):
        sym = ints(4, (c, nb * QAM_SYMS))

        def make(cc, dev, scheme=scheme, dphi=dphi):
            return (Modem.create(scheme, batch_shape=(cc,), device=dev),
                    Channel.create(MOD_SNR_DB, dphi, batch_shape=(cc,), device=dev),
                    Modem.create(scheme, batch_shape=(cc,), device=dev))

        def step(st, s, w):
            tx, ch, rx = st
            y, tx = tx.modulate(s)
            y, ch = ch.execute(None, y, noise=w)
            d, rx = rx.demodulate(y)
            return y, d, (tx, ch, rx)

        # a block restarts the rotation at unit magnitude from the carried
        # phase; one long block carries on the increments' float32 magnitude
        # error, n·max||inc| − 1| over the 2N samples
        inc = Modem.create(scheme, device=torch.device("cpu")).table.to(torch.complex128).abs()
        drift = 2 * QAM_SYMS * (inc - 1).abs().max().item()
        (_, d), _, _ = modem_run(f"{scheme}: Modem → Channel → demodulate", make, step,
                                 mod_blocks(sym, noise((c, nb * QAM_SYMS))), ("f", "i"),
                                 cum_tol(nb * QAM_SYMS, 1.0), card,
                                 split_tol=cum_tol(2 * QAM_SYMS, 1.0) + drift)
        errs = errors_after(d, sym, 0)
        print(f"[modems] {scheme} at {MOD_SNR_DB:g} dB, no multipath, offset {dphi}: "
              f"{errs} symbol errors in {d.numel()}")
        require(errs == 0, f"{scheme}: {errs} symbol errors")

    # 2.-4. GMSK, CPFSK and FSK over a channel with no multipath at 30 dB
    cpm = (
        ("GMSK k 2, m 3, bt 0.3", 2, GMSK_BITS,
         lambda cc, dev: (GmskMod.create(2, 3, 0.3, (cc,), device=dev),
                          Channel.create(MOD_SNR_DB, batch_shape=(cc,), device=dev),
                          GmskDem.create(2, 3, 0.3, (cc,), device=dev)), 2 * 3),
        ("CPFSK bps 2, h 0.5, k 4", 4, CPFSK_SYMS,
         lambda cc, dev: (CpfskMod.create(2, 0.5, 4, batch_shape=(cc,), device=dev),
                          Channel.create(MOD_SNR_DB, batch_shape=(cc,), device=dev),
                          CpfskDem.create(2, 0.5, 4, batch_shape=(cc,), device=dev)), None),
        ("FSK M 4, k 8, bandwidth 0.2", 4, FSK_SYMS,
         lambda cc, dev: (Fskmod.create(2, 8, 0.2, (cc,), device=dev),
                          Channel.create(MOD_SNR_DB, batch_shape=(cc,), device=dev),
                          Fskdem.create(2, 8, 0.2, (cc,), device=dev)), 0),
    )
    for name, m_size, n_sym, make, delay in cpm:
        sym = ints(m_size, (c, nb * n_sym))
        if delay is None:
            delay = make(1, torch.device("cpu"))[2].delay_syms
        k = make(1, torch.device("cpu"))[0].k

        def step(st, s, w):
            tx, ch, rx = st
            y, tx = tx.modulate(s)
            y, ch = ch.execute(None, y, noise=w)
            d, rx = rx.demodulate(y)
            return y, d, (tx, ch, rx)

        tol = MOD_TOL if name.startswith("FSK") else (
            lambda st, n=nb * n_sym * k: cum_tol(n, st[0].theta.abs().max().item()))
        (_, d), _, _ = modem_run(name, make, step,
                                 mod_blocks(sym, noise((c, nb * n_sym * k))), ("f", "i"), tol,
                                 card)
        errs = errors_after(d, sym, delay)
        print(f"[modems] {name} at {MOD_SNR_DB:g} dB, no multipath: {errs} symbol errors in "
              f"{d.numel() - c * delay} (decisions {delay} symbols late)")
        require(errs == 0, f"{name}: {errs} symbol errors")

    # 5. AmpModem, every type, carrier suppressed or not: modulate → demodulate
    t = torch.arange(nb * AM_N, device=device, dtype=torch.float32)
    f1 = torch.from_numpy(rng.uniform(0.002, 0.02, (c, 1)).astype(np.float32)).to(device)
    f2 = torch.from_numpy(rng.uniform(0.02, 0.05, (c, 1)).astype(np.float32)).to(device)
    audio = 0.5 * torch.sin(2 * np.pi * f1 * t) + 0.3 * torch.sin(2 * np.pi * f2 * t)
    am_launches = {}
    for typ in ("dsb", "usb", "lsb"):
        for suppressed in (False, True):
            def make(cc, dev, typ=typ, suppressed=suppressed):
                return AmpModem.create(AM_MU, typ, suppressed, m=AM_M, carrier_bw=AM_BW,
                                       batch_shape=(cc,), device=dev)

            def step(st, x):
                y, st = st.modulate(x)
                m, st = st.demodulate(y)
                return y, m, st

            name = f"AmpModem {typ}{' suppressed' if suppressed else ''}"
            (_, m), st, counts = modem_run(name, make, step, mod_blocks(audio), ("f", "f"),
                                           AM_TOL, card)
            am_launches[name] = counts["iir_chunked_apply"]
            fir = nb if st.hilb is not None else 0  # the SSB types' Hilbert FIR, fir_block
            require(counts["iir_chunked_apply"] == (0 if suppressed else nb)
                    and counts["fir_block_apply"] == fir
                    and sum(counts.values()) == counts["iir_chunked_apply"] + fir,
                    f"{name}: launches {counts}")
            lag = st.delay
            e = m[:, AM_SETTLE:] - audio[:, AM_SETTLE - lag: audio.shape[1] - lag]
            rel = (e.square().mean() / audio.square().mean()).sqrt().item()
            print(f"[modems] {name}: message back within rms {rel:.2e} of the audio's (<= "
                  f"{AM_MSG_TOL}) after {AM_SETTLE} samples")
            require(rel <= AM_MSG_TOL, f"{name}: message rms error {rel}")
    print(f"[modems] iir_chunked launches on AmpModem.demodulate, {nb} blocks each: "
          + ", ".join(f"{k} {v}" for k, v in am_launches.items()))

    # iir_chunked against its plain version on the carrier tracker's shape
    x = (audio.to(torch.complex64) * float(np.float32(AM_BW))).contiguous()
    f32 = dict(dtype=torch.float32, device=device)
    b = torch.tensor([1.0, 0.0], **f32)
    a = torch.tensor([1.0, -float(np.float32(1.0 - AM_BW))], **f32)
    v = (torch.ones(c, 1, dtype=torch.complex64, device=device) / (1 + AM_MU)).contiguous()
    one = torch.tensor(1.0, **f32)
    xb = x[:, :AM_N].contiguous()
    yk, vk = iir_chunked_apply(xb, b, a, one, v, sos=False)
    yp, vp = iir_chunked_reference(xb, b, a, one, v, sos=False)
    e = max(rel_max(yp, yk), rel_max(vp, vk))
    k_ms = graph_ms([lambda: iir_chunked_apply(xb, b, a, one, v, sos=False)] * 5)
    p_ms = graph_ms([lambda: iir_chunked_reference(xb, b, a, one, v, sos=False)] * 5)
    print(f"[modems] iir_chunked vs iir_chunked_reference on AmpModem's carrier tracker "
          f"[{c}, {AM_N}] complex64, TF [1, 0], [1, -(1 - {AM_BW})]: max |a - b| / max |a| "
          f"{e:.3e} (<= {IIR_TF_TOL}); {k_ms:.4f} ms against {p_ms:.4f} ms by graph replay "
          f"({card})")
    require(e <= IIR_TF_TOL, f"iir_chunked on AmpModem's shape {e}")

    # 6. Osc: "nco" and "vco" mixing; 1024 PLLs locking to their own offsets
    xo = complex_block(rng, (c, nb * OSC_N), device)
    for mode in ("nco", "vco"):
        def make(cc, dev, mode=mode):
            return Osc.create(mode, batch_shape=(cc,), device=dev).set_frequency(0.37).set_phase(
                -1.2)

        modem_run(f"Osc {mode} mix_block_up", make, lambda o, x: o.mix_block_up(x),
                  mod_blocks(xo), ("f",), MOD_TOL, card)
    freqs = torch.from_numpy(rng.uniform(-PLL_MAX_F, PLL_MAX_F, c).astype(np.float32))
    tone = torch.polar(torch.ones(c, PLL_STEPS), freqs[:, None] * torch.arange(PLL_STEPS) + 0.9)

    def pll(dev, cc):
        o = Osc.create("vco", batch_shape=(cc,), device=dev).pll_set_bandwidth(PLL_BW)
        tn = tone[:cc].to(dev)
        for i in range(PLL_STEPS):
            o = o.pll_step(torch.angle(tn[:, i] * o.cexp().conj())).step()
        return o

    t0 = time.perf_counter()
    o = pll(device, c)
    torch.cuda.synchronize()
    pll_s = time.perf_counter() - t0
    o_cpu = pll(torch.device("cpu"), MOD_CUT)
    lock = (o.get_frequency().cpu() - freqs).abs().max().item()
    vs_cpu = (o.get_frequency()[:MOD_CUT].cpu() - o_cpu.get_frequency()).abs().max().item()
    print(f"[modems] {c} PLLs (vco, bandwidth {PLL_BW}) over {PLL_STEPS} pll_steps: frequency "
          f"within {lock:.2e} rad/sample of each channel's offset (<= {PLL_LOCK_TOL}), the first "
          f"{MOD_CUT} within {vs_cpu:.2e} of the CPU's; {pll_s:.2f} s on the card ({card})")
    require(lock <= PLL_LOCK_TOL and vs_cpu <= PLL_LOCK_TOL, f"PLL lock {lock}, CPU {vs_cpu}")

    # 7. Eqrls: train_block on QPSK through a 3-tap channel
    d = torch.from_numpy(((2 * rng.integers(0, 2, (EQRLS_C, EQRLS_N)) - 1)
                          + 1j * (2 * rng.integers(0, 2, (EQRLS_C, EQRLS_N)) - 1)).astype(
        np.complex64) / np.float32(np.sqrt(2))).to(device)
    mp = FirFilter.create(np.asarray(MOD_TAPS, np.complex64), batch_shape=(EQRLS_C,),
                          device=device)
    xe = mp.execute_block(d)[0] + 0.01 * noise((EQRLS_C, EQRLS_N))

    def make(cc, dev):
        return Eqrls.create(p=EQRLS_P, batch_shape=(cc,), device=dev)

    (ye,), eq, _ = modem_run(f"Eqrls p {EQRLS_P} train_block", make,
                             lambda e, x, dd: e.train_block(x, dd), mod_blocks(xe, d), ("f",),
                             EQRLS_TOL, card)
    tail = (ye[:, -256:] - d[:, -256:]).abs().square().mean().sqrt().item()
    print(f"[modems] Eqrls: the last 256 outputs within rms {tail:.3e} of the symbols "
          f"(<= {EQRLS_RMS_MAX})")
    require(tail <= EQRLS_RMS_MAX, f"Eqrls rms {tail}")

    # 8. OFDM: one frame through Channel into OfdmFrameSync, card vs CPU
    gen_f = OfdmFrameGen(OFDM_M, OFDM_CP, device=device)
    data = torch.from_numpy(((2 * rng.integers(0, 2, (OFDM_SYMS, gen_f.n_data)) - 1) + 1j * (
        2 * rng.integers(0, 2, (OFDM_SYMS, gen_f.n_data)) - 1)) / np.sqrt(2)).to(device)
    frame = gen_f.assemble(data)
    buf = torch.cat([torch.zeros(OFDM_LEAD, dtype=torch.complex64, device=device), frame,
                     torch.zeros(300, dtype=torch.complex64, device=device)])
    ch = Channel.create(MOD_SNR_DB, OFDM_CFO, 0.3, MOD_TAPS, device=device)
    rx, _ = ch.execute(None, buf, noise=noise(buf.shape))
    outs = []
    for dev in (device, torch.device("cpu")):
        r = OfdmFrameSync(OFDM_M, OFDM_CP, device=dev).execute(rx.to(dev), OFDM_SYMS)
        require(r is not None, f"OFDM: no frame found on {dev}")
        outs.append(r)
    sync = OfdmFrameSync(OFDM_M, OFDM_CP, device=device)
    ms = cuda_ms(lambda: sync.execute(rx, OFDM_SYMS), 3, warmup=1)
    e = (outs[0]["symbols"].cpu() - outs[1]["symbols"]).abs().max().item()
    evm = 10 * torch.log10((outs[0]["symbols"] - data).abs().square().mean(1)).cpu()
    lost = int((evm > OFDM_EVM_MAX).sum())
    st = outs[0]["stats"]
    # the residual CFO's drift carries some symbols' common phase to ±π; the
    # port fits each symbol's pilot line about the pilots' circular mean, so
    # none is lost there (yagi_tpu's fit over the raw angles loses them:
    # ROADMAP queue 3, repaired in the port), and every symbol is gated
    print(f"[modems] OFDM M {OFDM_M}, cp {OFDM_CP}, {OFDM_SYMS} symbols through Channel "
          f"(taps {MOD_TAPS}, CFO {OFDM_CFO}, {MOD_SNR_DB:g} dB): tau {st['tau']:g} (sent "
          f"{OFDM_LEAD}, within 1), CFO {st['cfo']:.5f}; card = CPU within {e:.3e} (<= "
          f"{OFDM_TOL}), tau equal: {st['tau'] == outs[1]['stats']['tau']}; symbol EVM "
          f"{evm.min().item():.1f} to {evm.max().item():.1f} dB (median "
          f"{evm.median().item():.1f}), {lost} symbols above {OFDM_EVM_MAX} (0); {ms:.3f} ms a "
          f"frame between CUDA events ({card})")
    require(e <= OFDM_TOL and st["tau"] == outs[1]["stats"]["tau"]
            and abs(st["tau"] - OFDM_LEAD) <= 1 and lost == 0,
            f"OFDM: {e}, tau {st['tau']}, {lost} symbols above {OFDM_EVM_MAX} dB")
    torch.cuda.synchronize()
    print(f"[modems] {card}: the phase took {time.perf_counter() - t_phase:.2f} s")


def device_ops(fn) -> int | None:
    """Device operations (kernels, copies, fills) one call of ``fn`` puts on
    the card, counted in torch.profiler's trace; None where the trace holds
    no device event."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA) or None


def host_ms(fn, iters: int) -> float:
    """Mean wall time per call of ``fn`` in ms, the card synchronized before
    and after (for calls that end in a host read anyway)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def fec_corrupt(scheme: FecScheme, enc: np.ndarray, rng) -> np.ndarray:
    """``enc`` with errors within the scheme's correcting power: t bits of
    every codeword of a block code (rep3 1, rep5 2, Golay 3, Hamming and
    SECDED 1), one bit in every FEC_CONV_GAP coded bits of a convolutional
    code, 16 symbols of each RS block; none for "none"."""
    bits = np.unpackbits(enc)
    if scheme in (FecScheme.NONE,):
        return enc.copy()
    if scheme == FecScheme.RS8:
        out = enc.copy()
        pos = rng.choice(out.size, size=16, replace=False)  # one block at FEC_LEN bytes
        out[pos] ^= rng.integers(1, 256, 16).astype(np.uint8)
        return out
    if scheme.value.startswith("conv"):
        bits[rng.integers(0, FEC_CONV_GAP) + np.arange(0, bits.size - FEC_CONV_GAP,
                                                        FEC_CONV_GAP)] ^= 1
        return np.packbits(bits)
    code = getattr(tfec, scheme.value)()
    t = {"rep3": 1, "rep5": 2, "golay2412": 3}.get(scheme.value, 1)
    for j in range(-(-8 * FEC_LEN // code.k)):
        bits[j * code.n + rng.choice(code.n, size=t, replace=False)] ^= 1
    return np.packbits(bits)


def fec_soft(enc: np.ndarray, rng) -> np.ndarray:
    """Soft levels of the encoded bits at Es/N0 = FEC_SOFT_DB per coded bit:
    (r + 1)/2 clipped to [0, 1], r = ±1 plus Gaussian noise."""
    s = 2.0 * np.unpackbits(enc) - 1.0
    r = s + np.sqrt(0.5 / 10 ** (FEC_SOFT_DB / 10)) * rng.standard_normal(s.size)
    return np.clip(0.5 * (r + 1.0), 0.0, 1.0).astype(np.float32)


def framing_fec(device, card: str) -> None:
    """Every FecScheme on a FEC_LEN-byte message: the card's encoded bytes
    equal the CPU's; decoding hard bytes with errors within the code's
    power (and soft levels at FEC_SOFT_DB for the convolutional schemes) on
    the card gives the message and the CPU's bytes; conv615's Viterbi, Fec
    conv27 and rs8 encode and decode timed."""
    cpu = torch.device("cpu")
    rng = np.random.default_rng(FEC_SEED)
    msg = rng.integers(0, 256, FEC_LEN).astype(np.uint8)
    failed, cases = [], 0
    for scheme in FecScheme:
        fc, fh = Fec(scheme, device), Fec(scheme, cpu)
        enc = fc.encode(msg)
        require(np.array_equal(enc, fh.encode(msg)), f"[fec] {scheme.value}: card != CPU encode")
        inputs = [("hard", fec_corrupt(scheme, enc, rng))]
        if scheme.value.startswith("conv"):
            inputs.append((f"soft {FEC_SOFT_DB:g} dB", fec_soft(enc, rng)))
        for what, x in inputs:
            if what == "hard":
                got, want = fc.decode(x, FEC_LEN), fh.decode(x, FEC_LEN)
            else:
                got = fc.decode_soft(torch.from_numpy(x).to(device), FEC_LEN)
                want = fh.decode_soft(x, FEC_LEN)
            cases += 1
            if not (np.array_equal(got, msg) and np.array_equal(got, want)):
                failed.append(f"{scheme.value} {what}")
                print(f"[fec] FAILED {scheme.value} {what}: {int((got != msg).sum())} bytes off "
                      f"the message, {int((got != want).sum())} off the CPU's")
    print(f"[fec] {len(FecScheme)} schemes on a {FEC_LEN}-byte message (seed {FEC_SEED}): card "
          f"encode = CPU; {cases - len(failed)} of {cases} decodes (hard with errors within each "
          f"code's power, soft at {FEC_SOFT_DB:g} dB for the {cases - len(FecScheme)} conv "
          f"schemes) give the message and equal the CPU's")
    require(not failed, f"[fec] failed: {failed}")
    f615 = Fec("conv615", device)
    enc = f615.encode(msg)
    lv = torch.from_numpy(fec_soft(enc, rng)).to(device)
    ms615 = host_ms(lambda: f615.decode_soft(lv, FEC_LEN), 1)
    ops615 = device_ops(lambda: f615.decode_soft(lv, FEC_LEN))
    print(f"[fec] conv615 (16,384 states) Viterbi over {8 * FEC_LEN + 14} steps: {ms615:.1f} ms, "
          f"{ops615} device ops ({card})")
    for name in ("conv27", "rs8"):
        f = Fec(name, device)
        enc = f.encode(msg)
        e_ms = host_ms(lambda: f.encode(msg), 10)
        d_ms = host_ms(lambda: f.decode(enc, FEC_LEN), 5)
        print(f"[fec] Fec {name} on {FEC_LEN} bytes: encode {e_ms:.3f} ms (host), decode "
              f"{d_ms:.3f} ms ({card})")


def frame_ok(r, hdr, pld, dphi: float | None = None, props: dict | None = None) -> bool:
    """Header and payload CRC-valid and as sent; the props as sent and |dphi
    error| < FRAME_DPHI_TOL where given."""
    return (r is not None and r["header_valid"] and r["payload_valid"]
            and np.array_equal(r["header"], hdr) and np.array_equal(r["payload"], pld)
            and (props is None or r["props"] == props)
            and (dphi is None or abs(r["stats"]["dphi"] - dphi) < FRAME_DPHI_TOL))


def stat_errs(errs: dict, got: dict, want: dict) -> None:
    """Fold the differences of two stats dicts into ``errs`` (FRAME_STAT_TOL's
    keys they share): phi as a wrapped angle, gamma and rxy relative."""
    for k in errs:
        if k in got:
            d = got[k] - want[k]
            d = abs(np.angle(np.exp(1j * d))) if k == "phi" else abs(d) / (
                abs(want[k]) if k in ("gamma", "rxy") else 1.0)
            errs[k] = max(errs[k], d)


def same_frame(r, rc) -> bool:
    """Bytes, flags and props of two results equal."""
    return all(np.array_equal(r[k], rc[k]) if r[k] is not None else rc[k] is None
               for k in ("header", "payload")) and all(
        r[k] is rc[k] for k in ("header_valid", "payload_valid")) and r.get("props") == rc.get(
        "props")


def framing_frame64(device, card: str) -> None:
    """FRAME_N impaired frame64 bursts (tools/paths.py's frame_bursts) through
    FrameSync64 on the card: every header and payload CRC-valid and as sent,
    |dphi error| < FRAME_DPHI_TOL; FRAME_NOISE noise-only buffers not
    detected; the first FRAME_CUT against the CPU (bytes and flags equal,
    stats within FRAME_STAT_TOL); the times of a frame."""
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    bufs, hdrs, plds, draws = frame_bursts(FRAME_N, FRAME_SEED, device)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    sync, sync_cpu = FrameSync64(device=device), FrameSync64(device=cpu)
    t0 = time.perf_counter()
    results = [sync.execute(b) for b in bufs]
    run_s = time.perf_counter() - t0
    bad = [i for i, r in enumerate(results) if not frame_ok(r, hdrs[i], plds[i], draws[i]["dphi"])]
    for i in bad:
        r = results[i]
        print(f"[framing] frame {i} FAILED: draws {draws[i]}; "
              + ("not detected" if r is None else
                 f"header {r['header_valid']}, payload {r['payload_valid']}, stats {r['stats']}"))
    worst = max(abs(r["stats"]["dphi"] - d["dphi"]) for r, d in zip(results, draws) if r)
    evm = [r["stats"]["evm_db"] for r in results if r]
    print(f"[framing] frame64: {FRAME_N} bursts of {frame64_len()} samples, each in a "
          f"{FRAME_BUF}-sample buffer (seed {FRAME_SEED}, made in {make_s:.1f} s: lead, fractional "
          f"delay, CFO ±{FRAME_DPHI_MAX}, phase, gain {FRAME_GAIN}, AWGN {FRAME_SNR_DB:g} dB through "
          f"Channel): {FRAME_N - len(bad)} decoded with header and payload CRC-valid and as sent, "
          f"worst |dphi error| {worst:.2e} (< {FRAME_DPHI_TOL}); EVM {min(evm):.1f} to "
          f"{max(evm):.1f} dB; {run_s:.2f} s on the card")
    require(not bad, f"frame64: frames {bad} failed")
    gen = torch.Generator(device=device).manual_seed(FRAME_SEED)
    noise = torch.complex(torch.randn(FRAME_NOISE, FRAME_BUF, generator=gen, device=device),
                          torch.randn(FRAME_NOISE, FRAME_BUF, generator=gen, device=device))
    found = sum(sync.execute(x) is not None for x in noise)
    print(f"[framing] frame64 on {FRAME_NOISE} noise-only buffers: {found} detections (0)")
    require(found == 0, f"frame64: {found} detections on noise")
    errs = {k: 0.0 for k in FRAME_STAT_TOL}
    for i in range(FRAME_CUT):
        r, rc = results[i], sync_cpu.execute(bufs[i].cpu())
        require(rc is not None, f"frame64: frame {i} not detected on the CPU")
        require(same_frame(r, rc), f"frame64: frame {i}'s bytes or flags differ between card "
                "and CPU")
        stat_errs(errs, r["stats"], rc["stats"])
    print(f"[framing] frame64 card vs CPU on {FRAME_CUT} frames: bytes and flags equal; stats "
          + ", ".join(f"{k} {errs[k]:.2e} (<= {FRAME_STAT_TOL[k]:g})" for k in FRAME_STAT_TOL))
    require(all(errs[k] <= FRAME_STAT_TOL[k] for k in errs), f"frame64 stats: {errs}")
    # times of one frame, eager, between CUDA events / the host clock
    x = bufs[0]
    gen64 = FrameGen64(device=device)
    gen_ms = cuda_ms(lambda: gen64.execute(hdrs[0], plds[0]), N_FRAME_TIMED, warmup=1)
    total_ms = host_ms(lambda: sync.execute(x), N_FRAME_TIMED)
    # its three stages, each alone: detection (ends in its host read), sync
    # (timing and carrier recovery), decode (ends in the decoded bytes)
    det = sync.detector.detect(x)
    syms, b = sync._align(x, det)
    det_ms = host_ms(lambda: sync.detector.detect(x), N_FRAME_TIMED)
    sync_ms = host_ms(lambda: sync._align(x, det), N_FRAME_TIMED)
    dec_ms = host_ms(lambda: sync._decode(syms, b, det), N_FRAME_TIMED)
    # the payload's Viterbi alone: conv27p23 over the hamming128 code of
    # payload + CRC-32 key (64 + 4 bytes → 102)
    len1 = fec_get_enc_msg_length("hamming128", 64 + 4)
    levels = torch.rand(8 * fec_get_enc_msg_length("conv27p23", len1), device=device)
    vit = Fec("conv27p23", device)
    vit_ms = host_ms(lambda: vit.decode_soft(levels, len1), N_FRAME_TIMED)
    ops = {name: device_ops(fn) for name, fn in (("execute", lambda: sync.execute(x)),
                                                  ("viterbi", lambda: vit.decode_soft(
                                                      levels, len1)))}
    print(f"[framing] {card}: FrameSync64.execute {total_ms:.2f} ms a frame (detection "
          f"{det_ms:.2f}, sync {sync_ms:.2f}, decode {dec_ms:.2f}: the payload's "
          f"conv27p23 Viterbi over {8 * len1 + 6} steps {vit_ms:.2f} ms), "
          f"{ops['execute']} device ops a frame, {ops['viterbi']} in the Viterbi; "
          f"FrameGen64.execute {gen_ms:.3f} ms a frame between CUDA events")


def framing_qdsync(device) -> None:
    """QD_BURSTS bursts (a QD_PRE-symbol BPSK preamble, then QD_PAYLOAD QPSK
    symbols with a pilot every QD_SPACING, shaped as QDSync expects) through
    the frame64 impairments into QDSync → QPilotSync on the card: zero
    symbol errors."""
    rng = np.random.default_rng(FRAME_SEED + 1)
    gen = torch.Generator(device=device).manual_seed(FRAME_SEED + 1)
    pre = (1.0 - 2.0 * rng.integers(0, 2, QD_PRE)).astype(np.complex64)
    qd = QDSync(pre, k=2, m=7, beta=0.3, device=device)
    pg = QPilotGen(QD_PAYLOAD, QD_SPACING, device=device)
    ps = QPilotSync(QD_PAYLOAD, QD_SPACING, device=device)
    qpsk = Modem.create("qpsk", device=device)
    n_sym = QD_PRE + pg.get_frame_len()
    errors, bad = 0, []
    for b in range(QD_BURSTS):
        sent = torch.from_numpy(rng.integers(0, 4, QD_PAYLOAD)).to(device)
        frame = pg.execute(qpsk.modulate(sent)[0]).cpu().numpy()
        allsyms = np.concatenate([pre, frame, np.zeros(16, np.complex64)])
        up = np.zeros(2 * allsyms.size, np.complex64)
        up[::2] = allsyms
        tx = torch.from_numpy(np.convolve(up, qd._h).astype(np.complex64)).to(device)
        draw = draw_impairments(rng, tx.shape[0], FRAME_BUF)
        r = qd.execute(impair(tx, draw, FRAME_BUF, gen), n_symbols=n_sym)
        if r is None:
            bad.append(b)
            print(f"[framing] QDSync burst {b} not detected: draws {draw}")
            continue
        payload, info = ps.execute(r[0][QD_PRE:])
        e = int((qpsk.demodulate(payload)[0] != sent).sum())
        errors += e
        if e:
            bad.append(b)
            print(f"[framing] QDSync -> QPilotSync burst {b}: {e} symbol errors; draws {draw}, "
                  f"QDSync {r[1]}, QPilotSync {info}")
    print(f"[framing] QDSync -> QPilotSync: {QD_BURSTS} bursts of {QD_PRE} BPSK + {QD_PAYLOAD} "
          f"QPSK symbols, a pilot every {QD_SPACING}, under the frame64 impairments: {errors} "
          f"symbol errors (0)")
    require(not bad, f"QDSync -> QPilotSync: bursts {bad} failed")


def framing_symstream(device, card: str) -> None:
    """SymStreamR at bandwidth STREAM_BW: STREAM_N samples on the card, the
    first STREAM_CUT held against the CPU; write_samples(n) twice equal to
    write_samples(2n) on the card; its rate."""
    cpu = torch.device("cpu")
    s = SymStreamR(bw=STREAM_BW, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = s.write_samples(STREAM_N)
    torch.cuda.synchronize()
    msps = STREAM_N / (time.perf_counter() - t0) / 1e6
    y_cpu = SymStreamR(bw=STREAM_BW, device=cpu).write_samples(STREAM_CUT)
    e_cpu = (y[:STREAM_CUT].cpu() - y_cpu).abs().max().item()
    a, b = SymStreamR(bw=STREAM_BW, device=device), SymStreamR(bw=STREAM_BW, device=device)
    two = torch.cat([a.write_samples(STREAM_SPLIT), a.write_samples(STREAM_SPLIT)])
    e_split = (two - b.write_samples(2 * STREAM_SPLIT)).abs().max().item()
    print(f"[framing] SymStreamR bw {STREAM_BW}: {STREAM_N} samples on the card at {msps:.2f} "
          f"Msps ({card}); the first {STREAM_CUT} = the CPU's within {e_cpu:.2e} (<= "
          f"{STREAM_TOL}); write_samples({STREAM_SPLIT}) twice = write_samples({2 * STREAM_SPLIT})"
          f" within {e_split:.2e} (<= {STREAM_SPLIT_TOL})")
    require(y.shape[0] == STREAM_N and y.device == device and e_cpu <= STREAM_TOL
            and e_split <= STREAM_SPLIT_TOL, f"SymStreamR: {e_cpu}, {e_split}")


def phase_framing(device, card: str) -> None:
    """fec/ and framing/'s packet layer on the card (no kernel lies on this
    path: yagi_tpu's fec/ and framing/ reach no pallas_call)."""
    t_phase = time.perf_counter()
    spent = {}
    for name, part in (("fec", framing_fec), ("frame64", framing_frame64),
                       ("qdsync", lambda d, c: framing_qdsync(d)),
                       ("symstream", framing_symstream)):
        t0 = time.perf_counter()
        part(device, card)
        torch.cuda.synchronize()
        spent[name] = time.perf_counter() - t0
    print(f"[framing] {card}: the phase took {time.perf_counter() - t_phase:.2f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()) + ")")


# [frames]: the frame formats, the codec and checkpoint / restore (no kernel
# of their own: yagi_tpu's framing/, multichannel/ofdmflexframe.py, audio/
# and utils/ reach no pallas_call). Sizes, seeds and the impaired bursts come
# from tools/paths.py. Flexframe: every burst CRC-valid and as sent, props
# as sent, |dphi error| < FRAME_DPHI_TOL, FRAMES_NOISE noise buffers not
# detected, the first burst of each case against the CPU (bytes, flags and
# props exactly, stats within FRAME_STAT_TOL). The other frames: every
# burst CRC-valid and as sent. Detector: every burst once, |tau error| <=
# DET_TAU_TOL, nothing else, card = CPU (stats within FRAME_STAT_TOL).
# BSync and Cvsd: split and card = CPU bit for bit (sums of ±1; every Cvsd
# op rounded alone on both). MSource → K2: config[4]'s gate (CHZ_TOL of the
# rms) against the plain Firpfbch, each tone's channel power within
# MSRC_DB_TOL of its gain (the analyzer's centre gain taken from a 0-dB
# tone). Checkpoints: outputs and every leaf bit-identical.
FRAMES_NOISE, N_FRAMES_TIMED, DET_TAU_TOL = 8, 3, 0.5
OFDM_FLEX_SNR_DB, OFDM_FLEX_CFO = 30.0, 0.004  # through MOD_TAPS, as [modems]' OFDM frame
MSRC_DB_TOL, MSRC_SKIP = 1.0, 64  # dB; analyzer steps left out (the filter's transient)
CVSD_SNR_MIN, CVSD_CUT, CVSD_SPLIT, CVSD_OPS_N = 12.0, 16, (4000, 1, 3999), 256
CKPT_N = 600  # samples of each of the 24 types' stream (tests/test_checkpoint.py's)


def flex_stages(sync: FlexFrameSync, x: torch.Tensor) -> tuple[float, float, float]:
    """ms of FlexFrameSync.execute's three stages on ``x``, each alone:
    detection (ends in its host read), sync (both passes' timing and
    carrier recovery), decode (the header, the payload's phase tracking and
    decode)."""
    det = sync.detector.detect(x)
    npre, hlen = 64, sync.header_pm.get_frame_len()
    syms, _ = sync._symbols(x, det, npre + hlen)
    header_all, _ = sync.header_pm.decode_soft(syms[npre: npre + hlen])
    props = flex_props(header_all[sync.header_len:])
    ppm = flex_payload_pm(props, x.device)
    n_all = npre + hlen + ppm.get_frame_len()
    known = (npre + torch.arange(hlen, device=x.device), sync.header_pm.encode(header_all))
    syms2, _ = sync._symbols(x, det, n_all, known=known)
    modem = Modem.create(props["mod_scheme"], device=x.device)

    def decode():
        sync.header_pm.decode_soft(syms[npre: npre + hlen])
        pld = syms2[npre + hlen: n_all]
        if not (props["mod_scheme"].startswith("dpsk") or props["mod_scheme"] == "pi4dqpsk"):
            pld = dd_track(pld, modem)
        return ppm.decode_soft(pld)

    return (host_ms(lambda: sync.detector.detect(x), N_FRAMES_TIMED),
            host_ms(lambda: (sync._symbols(x, det, npre + hlen),
                             sync._symbols(x, det, n_all, known=known)), N_FRAMES_TIMED),
            host_ms(decode, N_FRAMES_TIMED))


def frames_flex(device, card: str) -> None:
    """FLEX_PER impaired flexframe bursts of each FLEX_CASES through
    FlexFrameSync on the card, noise buffers, the first burst of each case
    against the CPU, and the times of a frame by stage."""
    cpu = torch.device("cpu")
    rng = np.random.default_rng(FRAMES_SEED)
    gen = torch.Generator(device=device).manual_seed(FRAMES_SEED)
    fg, sync = FlexFrameGen(14, device=device), FlexFrameSync(14, device=device)
    bursts = []
    for ci, (mod, crc, fec0, fec1, plen, snr) in enumerate(FLEX_CASES):
        props = {"mod_scheme": mod, "crc": crc, "fec0": fec0, "fec1": fec1, "payload_len": plen}
        for _ in range(FLEX_PER):
            hdr = rng.integers(0, 256, 14).astype(np.uint8)
            pld = rng.integers(0, 256, plen).astype(np.uint8)
            tx = fg.assemble(hdr, pld, mod, crc, fec0, fec1)
            buf, draw = impaired_burst(tx, rng, gen, FLEX_BUF, snr)
            bursts.append((ci, buf, hdr, pld, props, draw, tx.shape[0]))
    t0 = time.perf_counter()
    results = [sync.execute(b[1]) for b in bursts]
    run_s = time.perf_counter() - t0
    bad = []
    for (ci, _, hdr, pld, props, draw, n), r in zip(bursts, results):
        if not frame_ok(r, hdr, pld, draw["dphi"], props):
            bad.append(ci)
            print(f"[frames] flexframe {FLEX_CASES[ci]} FAILED: draws {draw}; " + (
                "not detected" if r is None else f"header {r['header_valid']}, payload "
                f"{r['payload_valid']}, props {r['props']}, stats {r['stats']}"))
    worst = max(abs(r["stats"]["dphi"] - b[5]["dphi"]) for r, b in zip(results, bursts) if r)
    for ci, case in enumerate(FLEX_CASES):
        evm = [r["stats"]["evm_db"] for r, b in zip(results, bursts) if r and b[0] == ci]
        n = next(b[6] for b in bursts if b[0] == ci)
        print(f"[frames] flexframe {case[0]}, {case[1]}, {case[2]}, {case[3]}, {case[4]} bytes at "
              f"{case[5]:g} dB: {sum(1 for b in bursts if b[0] == ci) - bad.count(ci)} of "
              f"{FLEX_PER} decoded as sent ({n} samples a frame; preamble EVM {min(evm):.1f} to "
              f"{max(evm):.1f} dB)")
    print(f"[frames] flexframe: {len(bursts) - len(bad)} of {len(bursts)} bursts in {FLEX_BUF}-"
          f"sample buffers (seed {FRAMES_SEED}: lead, fractional delay, CFO ±{FRAME_DPHI_MAX}, "
          f"phase, gain {FRAME_GAIN} through Channel) CRC-valid with header, payload and props as "
          f"sent, worst |dphi error| {worst:.2e} (< {FRAME_DPHI_TOL}); {run_s:.2f} s on the card")
    require(not bad, f"flexframe: bursts of cases {bad} failed")
    noise = torch.complex(*(torch.randn(2, FRAMES_NOISE, FLEX_BUF, generator=gen, device=device)))
    found = sum(sync.execute(x) is not None for x in noise)
    print(f"[frames] flexframe on {FRAMES_NOISE} noise-only buffers: {found} detections (0)")
    require(found == 0, f"flexframe: {found} detections on noise")
    sync_cpu = FlexFrameSync(14, device=cpu)
    errs = {k: 0.0 for k in FRAME_STAT_TOL}
    firsts = [i for i, b in enumerate(bursts) if i == 0 or bursts[i - 1][0] != b[0]]
    for i in firsts:
        rc = sync_cpu.execute(bursts[i][1].cpu())
        require(rc is not None and same_frame(results[i], rc),
                f"flexframe: burst {i}'s bytes, flags or props differ between card and CPU")
        stat_errs(errs, results[i]["stats"], rc["stats"])
    print(f"[frames] flexframe card vs CPU on {len(firsts)} bursts (one a case): bytes, flags and "
          "props equal; stats " + ", ".join(f"{k} {errs[k]:.2e} (<= {FRAME_STAT_TOL[k]:g})"
                                             for k in FRAME_STAT_TOL))
    require(all(errs[k] <= FRAME_STAT_TOL[k] for k in errs), f"flexframe stats: {errs}")
    for ci in (0, 2):  # qpsk 1024 bytes; psk8 under hamming74 and conv27p23
        x = next(b[1] for b in bursts if b[0] == ci)
        total = host_ms(lambda: sync.execute(x), N_FRAMES_TIMED)
        d_ms, s_ms, c_ms = flex_stages(sync, x)
        ops = device_ops(lambda: sync.execute(x))
        print(f"[frames] {card}: FlexFrameSync.execute ({FLEX_CASES[ci][:5]}) {total:.2f} ms a "
              f"frame (detection {d_ms:.2f}, sync {s_ms:.2f}, decode {c_ms:.2f}), {ops} device "
              f"ops a frame; FlexFrameGen.assemble "
              f"{host_ms(lambda: fg.assemble(bursts[0][2], bursts[0][3]), N_FRAMES_TIMED):.2f} ms")


def frame_run(tag: str, items: list, card: str) -> None:
    """Bursts ``items`` = (sync, buffer, header, payload, draws) through their
    synchronizers on the card: every one CRC-valid and as sent; the worst
    |dphi error| and a frame's time (host clock) printed."""
    t0 = time.perf_counter()
    results = [s.execute(b) for s, b, *_ in items]
    run_s = time.perf_counter() - t0
    bad = [i for i, (r, it) in enumerate(zip(results, items)) if not frame_ok(r, it[2], it[3])]
    for i in bad:
        r = results[i]
        print(f"[frames] {tag} burst {i} FAILED: draws {items[i][4]}; " + (
            "not detected" if r is None else f"header {r['header_valid']}, payload "
            f"{r['payload_valid']}, stats {r['stats']}"))
    worst = max((abs(r["stats"]["dphi"] - it[4]["dphi"]) for r, it in zip(results, items)
                 if r and "dphi" in r["stats"] and "dphi" in it[4]), default=float("nan"))
    s, b = items[0][0], items[0][1]
    ms = host_ms(lambda: s.execute(b), N_FRAMES_TIMED)
    print(f"[frames] {tag}: {len(items) - len(bad)} of {len(items)} bursts CRC-valid and as sent "
          f"(worst |dphi error| {worst:.2e}); {run_s:.2f} s on the card, {ms:.2f} ms a frame "
          f"({card})")
    require(not bad, f"{tag}: bursts {bad} failed")


def frames_gmsk_fsk_dsss(device, card: str) -> None:
    """GF_BURSTS GMSK and GF_BURSTS FSK frames (half at m 1, half at m 2) at
    GF_SNR_DB, and DSSS_PER DSSS frames at each DSSS_CASES, impaired as
    flexframe's; each frame alone in a buffer 4096 samples longer."""
    rng = np.random.default_rng(FRAMES_SEED + 1)
    gen = torch.Generator(device=device).manual_seed(FRAMES_SEED + 1)

    def burst(tx, snr):
        return impaired_burst(tx, rng, gen, tx.shape[0] + 4096, snr)

    def payload():
        return (rng.integers(0, 256, 8).astype(np.uint8),
                rng.integers(0, 256, int(rng.integers(*GF_PAYLOAD, endpoint=True))).astype(np.uint8))

    def items(gen_, sync, count):
        out = []
        for _ in range(count):
            hdr, pld = payload()
            buf, draw = burst(gen_.assemble(hdr, pld, "crc32", "hamming128"), GF_SNR_DB)
            out.append((sync, buf, hdr, pld, draw))
        return out

    frame_run(f"GMSK frame (k 2, m 3, bt 0.5, hamming128, {GF_PAYLOAD} bytes, {GF_SNR_DB:g} dB)",
              items(GmskFrameGen(2, 3, 0.5, device=device), GmskFrameSync(2, 3, 0.5, device=device),
                    GF_BURSTS), card)
    for m in (1, 2):
        frame_run(f"FSK frame (m {m}, k 8, bandwidth 0.25, hamming128, {GF_PAYLOAD} bytes, "
                  f"{GF_SNR_DB:g} dB)", items(FskFrameGen(m, 8, 0.25, device=device),
                                              FskFrameSync(m, 8, 0.25, device=device),
                                              GF_BURSTS // 2), card)
    for sf, snr, thr in DSSS_CASES:
        dg = DsssFrameGen64(sf, device=device)
        ds = DsssFrameSync64(sf, threshold=thr, device=device)
        items = []
        for _ in range(DSSS_PER):
            hdr = rng.integers(0, 256, 8).astype(np.uint8)
            pld = rng.integers(0, 256, 64).astype(np.uint8)
            buf, draw = burst(dg.execute(hdr, pld), snr)
            items.append((ds, buf, hdr, pld, draw))
        frame_run(f"DSSS frame64 (sf {sf}, {snr:g} dB, threshold {thr})", items, card)


def frames_ofdm(device, card: str) -> None:
    """OFDM_FLEX_FRAMES OFDM flexible frames (M 64, cp 16; half qpsk, half
    qam16, OFDM_FLEX_PAYLOAD bytes), then OFDM_FLEX_LONG's long qpsk ones,
    each at a random lead through Channel with MOD_TAPS, a carrier offset
    OFDM_FLEX_CFO and OFDM_FLEX_SNR_DB: every frame CRC-valid and as sent,
    tau within 1 of the lead. The long frames carry some symbols' common
    phase past ±π, where the port's repaired pilot fit keeps them (ROADMAP
    queue 3; yagi_tpu's fit loses such frames)."""
    rng = np.random.default_rng(FRAMES_SEED + 2)
    gen = torch.Generator(device=device).manual_seed(FRAMES_SEED + 2)
    og = OfdmFlexFrameGen(64, 16, device=device)
    os_ = OfdmFlexFrameSync(64, 16, device=device)
    bad, n_sym, leads, bufs = [], [], [], []
    t_run = 0.0
    n_long, long_len = OFDM_FLEX_LONG
    for i in range(OFDM_FLEX_FRAMES + n_long):
        mod = "qpsk" if i < OFDM_FLEX_FRAMES // 2 or i >= OFDM_FLEX_FRAMES else "qam16"
        hdr = rng.integers(0, 256, 14).astype(np.uint8)
        plen = long_len if i >= OFDM_FLEX_FRAMES else int(
            rng.integers(*OFDM_FLEX_PAYLOAD, endpoint=True))
        pld = rng.integers(0, 256, plen).astype(np.uint8)
        tx = og.assemble(hdr, pld, mod)
        lead = int(rng.integers(64, 1024))
        buf = torch.zeros(lead + tx.shape[0] + 300, dtype=torch.complex64, device=device)
        buf[lead: lead + tx.shape[0]] = tx
        power = float(tx.abs().square().mean())
        ch = Channel.create(OFDM_FLEX_SNR_DB - 10 * np.log10(power), OFDM_FLEX_CFO,
                            float(rng.uniform(-np.pi, np.pi)), MOD_TAPS, device=device)
        rx, _ = ch.execute(gen, buf)
        t0 = time.perf_counter()
        r = os_.execute(rx)
        t_run += time.perf_counter() - t0
        props = {"mod_scheme": mod, "crc": "crc32", "fec0": "none", "fec1": "none",
                 "payload_len": pld.size}
        n_sym.append(-(-(tx.shape[0] - 3 * 80) // 80))
        leads.append(lead)
        bufs.append(rx)
        if not (frame_ok(r, hdr, pld, props=props) and abs(r["stats"]["tau"] - lead) <= 1):
            bad.append(i)
            print(f"[frames] OFDM flexframe {i} ({mod}, {pld.size} bytes, lead {lead}) FAILED: "
                  + ("not detected" if r is None else f"header {r['header_valid']}, payload "
                     f"{r['payload_valid']}, stats {r['stats']}"))
    ms = host_ms(lambda: os_.execute(bufs[-1]), N_FRAMES_TIMED)
    print(f"[frames] OFDM flexframe M 64, cp 16, {OFDM_FLEX_FRAMES} frames (qpsk and qam16, "
          f"{OFDM_FLEX_PAYLOAD} bytes: {min(n_sym[:OFDM_FLEX_FRAMES])} to "
          f"{max(n_sym[:OFDM_FLEX_FRAMES])} OFDM symbols) and {n_long} of qpsk {long_len} bytes "
          f"({n_sym[-1]} OFDM symbols) through Channel (taps {MOD_TAPS}, CFO {OFDM_FLEX_CFO}, "
          f"{OFDM_FLEX_SNR_DB:g} dB): {len(n_sym) - len(bad)} of {len(n_sym)} CRC-valid and as "
          f"sent, tau within 1 of the lead; {t_run:.2f} s on the card, {ms:.2f} ms a long frame "
          f"({card})")
    require(not bad, f"OFDM flexframe: frames {bad} failed")


def frames_detector(device, card: str) -> None:
    """A DET_N-sample capture of DET_BURSTS frame64 bursts (one every
    DET_SPACING ± 2·DET_JITTER samples, each with its own delay, CFO,
    phase and gain at FRAME_SNR_DB) fed to a streaming Detector in
    DET_BLOCK-sample blocks: each burst found once within DET_TAU_TOL,
    nothing else; the CPU's detections the same."""
    cpu = torch.device("cpu")
    rng = np.random.default_rng(FRAMES_SEED + 3)
    gen = torch.Generator(device=device).manual_seed(FRAMES_SEED + 3)
    fg = FrameGen64(device=device)
    template = FrameSync64(device=device).detector.s
    parts, truth = [], []
    for i in range(DET_BURSTS):
        tx = fg.execute(rng.integers(0, 256, 8).astype(np.uint8),
                        rng.integers(0, 256, 64).astype(np.uint8))
        lead = DET_SPACING // 2 + int(rng.integers(-DET_JITTER, DET_JITTER, endpoint=True))
        buf, draw = impaired_burst(tx, rng, gen, DET_SPACING, FRAME_SNR_DB, lead=lead)
        parts.append(buf)
        truth.append(i * DET_SPACING + lead + draw["tau"])
    x = torch.cat(parts)
    require(x.shape[0] == DET_N, f"capture of {x.shape[0]} samples")

    def run(dev):
        det = Detector(template, threshold=0.5, dphi_max=0.02, n_dphi=9, device=dev)
        xs = x.to(dev)
        return [h for b in range(0, DET_N, DET_BLOCK) for h in det.execute(xs[b: b + DET_BLOCK])]

    t0 = time.perf_counter()
    hits = run(device)
    run_s = time.perf_counter() - t0
    err = [abs(h["tau"] - t) for h, t in zip(hits, truth)]
    print(f"[frames] Detector over a {DET_N}-sample capture of {DET_BURSTS} frame64 bursts (one "
          f"every {DET_SPACING} ± {2 * DET_JITTER}, {FRAME_SNR_DB:g} dB) in {DET_BLOCK}-sample "
          f"blocks: {len(hits)} detections, worst |tau error| {max(err):.3f} (<= {DET_TAU_TOL}); "
          f"{run_s / (DET_N // DET_BLOCK) * 1e3:.2f} ms a block ({card})")
    require(len(hits) == DET_BURSTS and max(err) <= DET_TAU_TOL,
            f"Detector: {len(hits)} detections, tau errors {max(err) if err else None}")
    hits_cpu = run(cpu)
    errs = {k: 0.0 for k in FRAME_STAT_TOL}
    require(len(hits_cpu) == len(hits), f"Detector: {len(hits_cpu)} detections on the CPU")
    for h, hc in zip(hits, hits_cpu):
        stat_errs(errs, h, hc)
    print(f"[frames] Detector card vs CPU: {len(hits_cpu)} detections each; "
          + ", ".join(f"{k} {errs[k]:.2e}" for k in errs if k in hits[0]))
    require(all(errs[k] <= FRAME_STAT_TOL[k] for k in errs), f"Detector stats: {errs}")


def frames_bsync(device, card: str) -> None:
    """BSync against a 63-chip m-sequence over BSYNC_SHAPE ±1 streams, real
    and complex, the sequence at a random position in each channel: the
    peak there at exactly 1 (1 + 1j); blocks [n₁, 1, rest] equal one block
    and the CPU's first 64 channels equal the card's, bit for bit."""
    cpu = torch.device("cpu")
    c, n = BSYNC_SHAPE
    gen = torch.Generator(device=device).manual_seed(FRAMES_SEED + 4)
    seq = torch.from_numpy(2.0 * MSequence.create_default(6).generate_bits(63).astype(
        np.float32) - 1.0).to(device)
    pos = torch.randint(0, n - 63, (c,), generator=gen, device=device)
    idx = pos[:, None] + torch.arange(63, device=device)

    def signs():
        x = 2.0 * torch.randint(0, 2, (c, n), generator=gen, device=device).to(torch.float32) - 1
        return x.scatter(1, idx, seq.expand(c, 63))

    sync = BSync.from_msequence(MSequence.create_default(6), device=device)
    sync_cpu = BSync.from_msequence(MSequence.create_default(6), device=cpu)
    for kind, x in (("real", signs()), ("complex", torch.complex(signs(), signs()))):
        r, st = sync.execute_block(x)
        mag = r.abs()
        peak = mag.argmax(1)
        top = r.gather(1, peak[:, None])[:, 0]
        want_top = 1.0 + 1.0j if kind == "complex" else 1.0
        n1 = n // 2 - 1
        parts, s = [], None
        for blk in (x[:, :n1], x[:, n1: n1 + 1], x[:, n1 + 1:]):
            y, s = sync.execute_block(blk, s)
            parts.append(y)
        split_ok = torch.equal(torch.cat(parts, 1), r) and all(
            torch.equal(a, b) for a, b in zip(s if kind == "complex" else (s,),
                                              st if kind == "complex" else (st,)))
        rc, _ = sync_cpu.execute_block(x[:64].cpu())
        cpu_ok = torch.equal(r[:64].cpu(), rc)
        ms = cuda_ms(lambda: sync.execute_block(x), 3, warmup=1)
        print(f"[frames] BSync {kind} [{c}, {n}] against a 63-chip m-sequence: peak at the "
              f"sequence's end in {int((peak == pos + 62).sum())} of {c} channels, at "
              f"{want_top} in {int((top == want_top).sum())}; [{n1}, 1, {n - n1 - 1}] = one block "
              f"bit for bit: {split_ok}; card = CPU (64 channels) bit for bit: {cpu_ok}; "
              f"{ms:.3f} ms a block ({card})")
        require(bool((peak == pos + 62).all()) and bool((top == want_top).all()) and split_ok
                and cpu_ok, f"BSync {kind}")


def frames_msource(device, card: str) -> None:
    """MSource over MSRC_N samples, one source at each channel centre k/M of
    FusedChannelizer's M = 64 (Firpfbch's convention): tones, 8 noise
    sources, 4 chirps and 4 QPSK modem sources, gains from −20 to 0 dB;
    K2 against the plain Firpfbch (config[4]'s gate), each tone's channel
    power within MSRC_DB_TOL of its gain."""
    rng = np.random.default_rng(FRAMES_SEED + 5)
    kinds = ["noise"] * 8 + ["chirp"] * 4 + ["modem"] * 4 + ["tone"] * (M4 - 16)
    order = rng.permutation(M4)
    gains = np.round(rng.uniform(-20.0, 0.0, M4), 2)
    src = MSource(seed=FRAMES_SEED + 5, device=device)
    bw = 0.5 / M4
    for k in range(M4):
        fc = k / M4 if k < M4 // 2 else k / M4 - 1
        kind, g = kinds[order[k]], float(gains[k])
        if kind == "tone":
            src.add_tone(fc, g)
        elif kind == "noise":
            src.add_noise(fc, bw, g)
        elif kind == "chirp":
            src.add_chirp(fc, bw, g, duration=4096.0)
        else:
            src.add_modem("qpsk", fc, bw, g)
    t0 = time.perf_counter()
    x = src.write_samples(MSRC_N)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    fz = FusedChannelizer.create_kaiser(**CHZ, device=device)
    reset_counts()
    y, _ = fz.analyzer_execute(x)
    torch.cuda.synchronize()
    launches = read_counts()["fused_channelizer_apply"]
    ref = Firpfbch.create_kaiser(M4, CHZ["m"], CHZ["as_"], device=device)
    y_ref, _ = ref.analyzer_execute(x)
    err = rel_rms(y_ref, y)
    cal = MSource(device=device)
    cal.add_tone(0.0, 0.0)
    y0, _ = ref.analyzer_execute(cal.write_samples(M4 * 4 * MSRC_SKIP))
    p0 = y0[0, MSRC_SKIP:].abs().square().mean().item()
    p = y[:, MSRC_SKIP:].abs().square().mean(1).cpu().numpy()
    tones = [k for k in range(M4) if kinds[order[k]] == "tone"]
    off = [10 * np.log10(p[k] / p0) - gains[k] for k in tones]
    print(f"[frames] MSource {M4} sources at the channel centres ({len(tones)} tones, 8 noise, 4 "
          f"chirps, 4 QPSK; gains {gains.min():g} to {gains.max():g} dB), {MSRC_N} samples in "
          f"{gen_s:.2f} s ({card}) -> FusedChannelizer: {launches} K2 launch(es); K2 vs Firpfbch "
          f"{err:.3e} of the rms (< {CHZ_TOL}); tone channel power - gain {min(off):+.3f} to "
          f"{max(off):+.3f} dB (within {MSRC_DB_TOL})")
    require(launches == 1 and err < CHZ_TOL and max(abs(o) for o in off) <= MSRC_DB_TOL,
            f"MSource -> K2: launches {launches}, err {err}, tone offsets {off}")


def frames_cvsd(device, card: str) -> None:
    """Cvsd over CVSD_C channels of CVSD_N samples (tones of 100–250 Hz at
    8 kHz, amplitudes 0.2–0.6, where a 1-bit 8-kHz delta codec holds
    tests/test_audio.py's 12 dB): encode → decode SNR above CVSD_SNR_MIN in
    every channel; blocks CVSD_SPLIT equal one block bit for bit (bits,
    audio, state); the CPU's first CVSD_CUT channels equal the card's."""
    cpu = torch.device("cpu")
    rng = np.random.default_rng(FRAMES_SEED + 6)
    f = rng.uniform(100.0, 250.0, (CVSD_C, 1))
    a = rng.uniform(0.2, 0.6, (CVSD_C, 1))
    ph = rng.uniform(0.0, 2 * np.pi, (CVSD_C, 1))
    x = torch.from_numpy((a * np.sin(2 * np.pi * f * np.arange(CVSD_N) / 8000.0 + ph)).astype(
        np.float32)).to(device)

    def codec(dev, xs, blocks):
        enc = Cvsd.create(batch_shape=(xs.shape[0],), device=dev)
        dec = Cvsd.create(batch_shape=(xs.shape[0],), device=dev)
        bits, ys, o = [], [], 0
        for n in blocks:
            b, enc = enc.encode(xs[:, o: o + n])
            y, dec = dec.decode(b)
            bits.append(b)
            ys.append(y)
            o += n
        return torch.cat(bits, 1), torch.cat(ys, 1), enc, dec

    reset_counts()
    t0 = time.perf_counter()
    bits, y, enc, dec = codec(device, x, (CVSD_N,))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = {k: v for k, v in read_counts().items() if v}
    err = y[:, 500:] - x[:, 500:]
    snr = 10 * torch.log10(x[:, 500:].square().mean(1) / err.square().mean(1))
    bits_s, y_s, enc_s, dec_s = codec(device, x, CVSD_SPLIT)
    split_ok = torch.equal(bits_s, bits) and torch.equal(y_s, y) and all(
        torch.equal(u, v) for u, v in zip(tensors_of(enc_s) + tensors_of(dec_s),
                                          tensors_of(enc) + tensors_of(dec)))
    bits_c, y_c, enc_c, dec_c = codec(cpu, x[:CVSD_CUT].cpu(), (CVSD_N,))
    cpu_ok = torch.equal(bits_c, bits[:CVSD_CUT].cpu()) and torch.equal(y_c, y[:CVSD_CUT].cpu())
    ops = device_ops(lambda: Cvsd.create(batch_shape=(CVSD_C,), device=device).encode(
        x[:, :CVSD_OPS_N]))
    print(f"[frames] Cvsd (4 bits, zeta 1.5, alpha 0.9) over [{CVSD_C}, {CVSD_N}]: encode + "
          f"decode {run_s:.2f} s ({card}; {run_s / CVSD_N * 1e3:.3f} ms a sample of all "
          f"channels), kernel launches {counts or 'none'}; SNR {snr.min().item():.2f} to "
          f"{snr.max().item():.2f} dB (> {CVSD_SNR_MIN}); {CVSD_SPLIT} = one block bit for bit: "
          f"{split_ok}; card = CPU ({CVSD_CUT} channels, bits and audio) bit for bit: {cpu_ok}; "
          f"encode {ops} device ops over {CVSD_OPS_N} samples ({(ops or 0) / CVSD_OPS_N:.1f} a "
          "sample)")
    require(snr.min().item() > CVSD_SNR_MIN and split_ok and cpu_ok,
            f"Cvsd: SNR {snr.min().item()}, split {split_ok}, CPU {cpu_ok}")


def ckpt_cases(device) -> dict:
    """tests/test_checkpoint.py's 24 types on the port at its shapes (600
    samples), and FusedRxChain (K1), FusedChannelizer (K2) and QamRx at
    their paths' shapes: name → (factory, step(state, x) → (outputs,
    state), input)."""
    rng = np.random.default_rng(42)

    def cx(n):
        return torch.complex(*torch.from_numpy(rng.standard_normal((2, n)).astype(
            np.float32))).to(device)

    def outs(*r):
        return tuple(r[:-1]), r[-1]

    def ex(method, *args):
        return lambda s, x: outs(*getattr(s, method)(*args, x))

    h9 = np.arange(1, 10, dtype=np.float32) / 10.0
    d = dict(device=device)
    return {
        "resamp_arbitrary": (lambda: Resamp.create(0.7153, **d), ex("execute_block"), cx(600)),
        "resamp_fastpath": (lambda: Resamp.create(2.0, **d), ex("execute_block"), cx(600)),
        "resamp2_analyzer": (lambda: Resamp2.create(7, **d), ex("analyzer_execute_block"),
                             cx(600)),
        "msresamp": (lambda: MsResamp.create(0.37, 60.0, **d), ex("execute_block"), cx(600)),
        "msresamp2_decim": (lambda: MsResamp2.create(False, 2, 0.4, 0.0, 60.0, **d),
                            ex("execute_block"), cx(600)),
        "symsync": (lambda: Symsync.create_rnyquist(FirFilterShape.RRCOS, 2, 7, 0.3, **d)
                    .set_lf_bw(0.02), ex("execute"), cx(600)),
        "agc": (lambda: Agc.create(**d).set_bandwidth(0.01), ex("execute_block"), cx(600)),
        "osc_mix": (lambda: Osc.create("nco", **d).set_frequency(0.31), ex("mix_block_down"),
                    cx(600)),
        "eqlms": (lambda: Eqlms.create(h_len=7, **d).set_bw(0.02),
                  lambda s, x: outs(*s.execute_block(2, x)), cx(600)),
        "eqrls": (lambda: Eqrls.create(p=5, **d), lambda s, x: outs(*s.train_block(x, 0.5 * x)),
                  cx(600)),
        "firfilt": (lambda: FirFilter.create(h9, dtype=torch.complex64, **d), ex("execute_block"),
                    cx(600)),
        "fftfilt": (lambda: FftFilt.create(h9, 64, dtype=torch.complex64, **d),
                    ex("execute_blocks"), cx(512)),
        "firfarrow": (lambda: FirFarrow.create(9, 4, 0.45, 40.0, **d).set_delay(0.3),
                      ex("execute_block"), cx(600)),
        "iirfilt": (lambda: IirFilter.create_lowpass(5, 0.1, dtype=torch.complex64, **d),
                    ex("execute_block"), cx(600)),
        "iirfiltsos": (lambda: IirFilterSos.create([0.2, 0.4, 0.2], [1.0, -0.5, 0.1],
                                                   dtype=torch.complex64, **d),
                       ex("execute_block"), cx(600)),
        "spgram": (lambda: Spgram.create(64, **d), lambda s, x: ((), s.write(x)), cx(600)),
        "firpfbch_analyzer": (lambda: Firpfbch.create_kaiser(4, 5, 60.0, **d),
                              ex("analyzer_execute"), cx(600)),
        "firpfbch2_analyzer": (lambda: Firpfbch2.create(4, 3, 60.0, **d), ex("analyzer_execute"),
                               cx(600)),
        "qamrx": (lambda: QamRx.create(**d), ex("step"), cx(600)),
        "fm_stereo": (lambda: FmStereoRx.create(**d), ex("step"), 0.1 * cx(592)),
        "freqdem": (lambda: Freqdem.create(0.1, **d), ex("demodulate"), cx(600)),
        "freqmod": (lambda: Freqmod.create(0.1, **d), ex("modulate"), cx(600).real.contiguous()),
        "gmskdem": (lambda: GmskDem.create(4, 3, 0.3, **d), ex("demodulate"), cx(600)),
        "fskdem": (lambda: Fskdem.create(2, 8, 0.25, **d), ex("demodulate"), cx(600)),
        f"FusedRxChain [{C}, 2x{T}]": (lambda: make_fused(C, device), ex("step"),
                                       complex_block(rng, (C, 2 * T), device)),
        f"FusedChannelizer [2x{M4 * T4}]": (lambda: FusedChannelizer.create_kaiser(**CHZ, **d),
                                            ex("analyzer_execute"), cx(2 * M4 * T4)),
        f"QamRx [{C3}, 2x{T3}]": (lambda: make_qamrx(C3, device), ex("step"),
                                  complex_block(rng, (C3, 2 * T3), device)),
    }


def frames_checkpoint(device, card: str) -> None:
    """Every ckpt_cases object on the card: half its input, save_state to a
    file, load_state into a fresh card object, the other half: outputs and
    every leaf bit-identical to the uninterrupted run, on the card. The
    kernel launches of each case, counted from 0, printed."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, path = tempfile.mkstemp(suffix=".npz", dir=_build.BUILD_DIR)
    os.close(fd)
    launched = {}
    try:
        for name, (factory, step, x) in ckpt_cases(device).items():
            reset_counts()
            b1, b2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
            _, s = step(factory(), b1)
            ref_out, ref_state = step(s, b2)
            _, s2 = step(factory(), b1)
            save_state(path, s2)
            restored = load_state(path, factory())
            got_out, got_state = step(restored, b2)
            torch.cuda.synchronize()
            counts = {k: v for k, v in read_counts().items() if v}
            for k, v in counts.items():
                launched[k] = launched.get(k, 0) + v
            leaves = tensors_of(ref_state)
            same = len(ref_out) == len(got_out) and all(
                (a.device == b.device == device and torch.equal(a, b))
                if isinstance(a, torch.Tensor) else a == b
                for a, b in zip(ref_out, got_out)) and all(
                a.device == device and torch.equal(a, b) for a, b in zip(
                    leaves, tensors_of(got_state))) and len(state_leaves(ref_state)) == len(
                state_leaves(got_state)) and all(np.array_equal(a, b) for a, b in zip(
                    state_leaves(ref_state), state_leaves(got_state)))
            if not same or name.startswith(("Fused", "QamRx")):
                print(f"[frames] checkpoint {name}: {len(state_leaves(ref_state))} leaves; "
                      f"outputs and leaves bit-identical: {same}; launches {counts or 'none'}")
            require(same, f"checkpoint {name}: the restored run differs")
    finally:
        os.unlink(path)
    print(f"[frames] checkpoint: tests/test_checkpoint.py's 24 types and the three paths' "
          f"objects saved mid-stream on the card, restored into fresh card objects: outputs "
          f"and every leaf bit-identical; kernel launches over these runs {launched}")
    for k in ("fused_chain_apply_c64", "fused_channelizer_apply", "symsync_fused_apply",
              "agc_scan_apply", "qam_eq_scan_apply", "iir_scan_apply", "fir_block_apply"):
        require(launched.get(k, 0) > 0, f"checkpoint: {k} never launched")


def phase_frames(device, card: str) -> None:
    """The frame formats, the codec and checkpoint / restore on the card (no
    kernel of their own; the MSource and checkpoint parts run K1, K2, K3,
    agc_scan, qam_eq_scan and the IIR kernels)."""
    t_phase = time.perf_counter()
    spent = {}
    for name, part in (("flexframe", frames_flex), ("gmsk, fsk, dsss", frames_gmsk_fsk_dsss),
                       ("ofdm flexframe", frames_ofdm), ("detector", frames_detector),
                       ("bsync", frames_bsync), ("msource", frames_msource),
                       ("cvsd", frames_cvsd), ("checkpoint", frames_checkpoint)):
        t0 = time.perf_counter()
        part(device, card)
        torch.cuda.synchronize()
        spent[name] = time.perf_counter() - t0
    print(f"[frames] {card}: the phase took {time.perf_counter() - t_phase:.2f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()) + ")")


def phase_timing_config2(device, card: str) -> dict:
    """iir_chunked, iir_scan and iir_chunked_reference by graph replay at
    config[2]'s de-emphasis ([C2, T2] float32, TF [α], [1, −(1 − α)]),
    iir_scan_reference by one eager call at the same shape; returns {name:
    (kernel ms, plain ms)}."""
    rng = np.random.default_rng(SEED + 41)
    f = make_fmstereo(1, device).deemph_l
    # N_ROT input sets (134 MB) so the 50 MB L2 cannot hold the input
    sets = [(planes(rng, (C2, T2), device), f.b, f.a, f.scale, planes(rng, (C2, 1), device))
            for _ in range(N_ROT)]
    chunk = [lambda a=a: iir_chunked_apply(*a, sos=False) for a in sets] * 5
    scan = [lambda a=a: iir_scan_apply(*a, sos=False) for a in sets] * 5
    plain = [lambda a=a: iir_chunked_reference(*a, sos=False) for a in sets] * 5
    p1, c1, s1, s2, c2, p2 = (graph_ms(fn) for fn in (plain, chunk, scan, scan, chunk, plain))
    c_ms, s_ms, p_ms = (c1 + c2) / 2, (s1 + s2) / 2, (p1 + p2) / 2
    ps_ms = cuda_ms(lambda: iir_scan_reference(*sets[0], sos=False), iters=1, warmup=1)
    print(f"[timing] {card}: iir_chunked {c_ms:.4f} ms/filter ({c1:.4f}, {c2:.4f}), iir_scan "
          f"{s_ms:.4f} ({s1:.4f}, {s2:.4f}), iir_chunked_reference (log-depth torch) {p_ms:.4f} "
          f"({p1:.4f}, {p2:.4f}), by graph replay; iir_scan_reference {ps_ms:.2f} ms (one eager "
          f"call after one); the de-emphasis at [{C2}, {T2}] float32")

    return {"iir_scan": (s_ms, ps_ms), "iir_chunked": (c_ms, p_ms)}


def kernel_work(device, sym_emitted: float) -> dict:
    """(bytes, operations) of one launch of each kernel at its path's shape:
    the bytes of its inputs and outputs, each once; the fewest real
    multiplies and adds that compute its function (a transcendental or a
    division counts as one), for the symsync loops the dots of the slots that
    emit (``sym_emitted`` per config[1] block) and ~20 loop ops per slot.
    K3 has a second entry, its work at config[3]'s shape."""
    fused = make_fused(C, device)
    pfb1 = 2 * 7  # taps of a polyphase branch of the interpolator (m = 7)
    fz = FusedChannelizer.create_kaiser(**CHZ, device=device)
    fft4 = 5 * M4 * int(np.log2(M4))  # real operations of a radix-2 64-point FFT
    ss = make_symsync(C1, device)
    n1 = make_msresamp(C1, device).out_capacity(T1)
    L, P = ss.mf.shape[1], ss.npfb
    sym_out = C1 * n1 * 2 * 9 + C1 * 9 * 4 * 2 + C1 * 4  # y, valid; state in and out; deferred
    sym_ops = sym_emitted * 8 * L + C1 * n1 * 2 * 20
    rx = make_qamrx(C3, device)
    # K3 on config[3]: 2 slots a sample, about one of them emitting (k_out = 2)
    sym3 = (C3 * (T3 + L) * 8 + 2 * P * L * 4 + C3 * T3 * 2 * 9 + C3 * 9 * 4 * 2 + C3 * 4,
            C3 * T3 * 8 * L + C3 * T3 * 2 * 20)
    S, h, m = 2 * T3, rx.eq.h_len, rx.table.shape[0]
    eq_state = nbytes(*rx.eq_scan_args()[4].values())
    iir = (C2 * T2 * 4 * 2 + C2 * 4 * 2 + 3 * 4, C2 * T2 * 3)
    L2 = make_fmstereo(1, device).align.h_len
    fir = [0, 0]  # config[2]'s four FIRs a step, each at its least form (the pilot's real input)
    for xc, hc in ((False, True), (False, False), (False, False), (True, False)):
        sx, sy, sh = 8 if xc else 4, 8 if xc or hc else 4, 8 if hc else 4
        fir[0] += C2 * (T2 + L2 - 1) * sx + C2 * T2 * sy + L2 * sh
        fir[1] += 2 * C2 * T2 * L2 * (2 if xc or hc else 1)
    chain = (4 * C * T * 2 * (1 + fused.p) + nbytes(fused.taps, fused.hist_r, fused.hist_i),
             C * T * (4 * CHAIN["n_taps"] + fused.p * (4 * pfb1 + 8)))
    return {
        # planar in, planar out at rate p; the FIR's 2·n_taps MACs per input
        # sample, then per output a branch's 2·pfb1 MACs, the rotation, sin and cos
        # (the taps once: the compact [P, Kp] the kernel reads)
        "chain_fp32": chain,
        "chain_c64": chain,  # the same samples interleaved: the same bytes and operations
        # per analyzer step 64 branches of p taps on both planes, a 64-point
        # FFT; of the tables the function needs the taps and the scale hr[0, 0]
        "channelizer_fp32": (2 * 4 * T4 * M4 * 2 + nbytes(fz.taps, fz.hist_r, fz.hist_i) + 4,
                             T4 * (M4 * fz.p * 4 + fft4)),
        "mix_down": (N_MIX * 8 * 2, N_MIX * 8),
        "symsync_fused": (C1 * (n1 + L) * 8 + 2 * P * L * 4 + sym_out, sym_ops),
        "symsync_fused config[3]": sym3,
        "symsync_scan": (C1 * n1 * 4 * P * 4 + sym_out, sym_ops),
        # y in and out, the AGC's state; per sample ~12 ops, an exp and a log
        "agc_scan": (C3 * T3 * 8 * 2 + C3 * 4 * 8 * 2, C3 * T3 * 14),
        # y, valid in; syms, soft, mask out; the eq state in and out; per slot
        # the dot, M distances, the LMS update, ~30 ops of PLL and derotation
        "qam_eq_scan": (C3 * S * (8 + 1 + 8 + 8 + 1) + 2 * eq_state + m * 8 + C3 * 3 * 4,
                        C3 * S * (8 * h + 5 * m + 10 * h + 30)),
        # config[2]'s de-emphasis: x in, y out (float32), the state in and
        # out, b0, a1, the scale; per sample v0 = x − a1·v1 and y = b0·v0
        "iir_scan": iir,
        "iir_chunked": iir,  # the same function
        # the block in with its window's L − 1 samples, the output, the taps;
        # 2·L·r flops an output, r the real multiply-adds a tap
        "fir_block": tuple(fir),
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch sees none")
    # plain oracles (matmuls, convolutions) in full fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    spent = {}  # seconds by stretch of phases, printed before the kernels line
    t_mark = [time.perf_counter()]

    def mark(what: str) -> None:
        t = time.perf_counter()
        spent[what] = t - t_mark[0]
        t_mark[0] = t

    name, smi = phase_device()
    phase_build()
    mark("build")
    phase_default_device()
    errs = {
        **phase_kernel_vs_plain(device),
        "channelizer_fp32": phase_kernel_vs_plain_channelizer(device),
        "mix_down": phase_kernel_vs_plain_mix(device),
    }
    errs["symsync_fused"], errs["symsync_scan"] = phase_kernel_vs_plain_symsync(device)
    phase_symsync_gate(device)
    launches = {
        **phase_main_path(device),
        "channelizer_fp32": phase_main_path_config4(device),
        "mix_down": phase_mix_path(device),
    }
    launches["symsync_fused"], launches["symsync_scan"], emitted = phase_main_path_config1(device)
    qam = phase_kernel_vs_plain_qam(device)
    errs.update({k: v[0] for k, v in qam.items()})
    launches.update(phase_main_path_config3(device))
    phase_signal_config3(device)
    errs.update(phase_kernel_vs_plain_iir(device))
    errs["fir_block"] = phase_kernel_vs_plain_fir(device)
    launches.update(phase_main_path_config2(device))
    phase_signal_config2(device)
    mark("kernel-vs-plain, main paths, signal")
    phase_parallel(device, smi)
    mark("parallel")
    phase_fft(device)
    phase_filters(device, smi)
    mark("fft, filters")
    phase_capture(device, smi)
    mark("capture")
    phase_l0(device, smi)
    mark("l0")
    phase_modems(device, smi)
    mark("modems")
    phase_framing(device, smi)
    mark("framing")
    phase_frames(device, smi)
    mark("frames")
    phase_fm_epilogue(device, smi)
    times = {
        **phase_timing(device, smi),
        "channelizer_fp32": phase_timing_config4(device, smi),
        "mix_down": phase_timing_mix(device, smi),
        **phase_timing_config1(device, smi),
        **phase_timing_config3(device, smi, {k: v[1] for k, v in qam.items()}),
        **phase_timing_config2(device, smi),
    }
    k_ms, p_ms, library_ms = phase_timing_fir(device, smi)
    times["fir_block"] = (k_ms, p_ms)
    sources = {
        "chain_fp32": ("yagi_tpu_torch/csrc/chain.cu", "yagi_tpu/kernels/chain.py:87"),
        # the same source's interleaved instance, FusedRxChain.step's
        "chain_c64": ("yagi_tpu_torch/csrc/chain.cu", "yagi_tpu/kernels/chain.py:87"),
        "channelizer_fp32": ("yagi_tpu_torch/csrc/channelizer.cu",
                             "yagi_tpu/kernels/channelizer.py:71"),
        "mix_down": ("yagi_tpu_torch/csrc/mix.cu", "yagi_tpu/kernels/mix.py:29"),
        "symsync_fused": ("yagi_tpu_torch/csrc/symscan.cu", "yagi_tpu/kernels/symscan.py:201"),
        "symsync_scan": ("yagi_tpu_torch/csrc/symscan.cu", "yagi_tpu/kernels/symscan.py:72"),
        # no pallas_call: the lax.scan bodies these loops stand for
        "agc_scan": ("yagi_tpu_torch/csrc/agc.cu", "yagi_tpu/agc/agc.py:260"),
        "qam_eq_scan": ("yagi_tpu_torch/csrc/qam.cu", "yagi_tpu/chains/qam.py:173"),
        "iir_scan": ("yagi_tpu_torch/csrc/iir.cu", "yagi_tpu/filter/iirfilt.py:317"),
        "iir_chunked": ("yagi_tpu_torch/csrc/iir.cu", "yagi_tpu/filter/_linrec.py:49"),
        # no pallas_call: the banded matmul in plain XLA (a step's four filters)
        "fir_block": ("yagi_tpu_torch/csrc/fir.cu", "yagi_tpu/filter/_conv.py:32"),
    }
    mark("timing")
    print("[time] " + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items())
          + f"; total {sum(spent.values()):.1f} s")
    bounds = {k: bound(w) for k, w in kernel_work(device, emitted).items()}
    b3 = bounds.pop("symsync_fused config[3]")
    print(f"[bound] symsync_fused (K3) at config[3] (C={C3}, n={T3}, k_out=2): {b3[0]:.4f} ms "
          f"({b3[1]}); at config[1]: {bounds['symsync_fused'][0]:.4f} ms")
    # no single PyTorch call computes any of these functions: FIR ⊛ PFB with
    # a u32 NCO, PFB + DFT, a u32-exact mix, loops that feed their
    # decisions back, and an IIR recurrence (PERF.md §6); fir_block's
    # yardstick is cuBLAS's banded gemms (a config[2] step's, frames made)
    # K4's first version stays in its source as the direct instance (for rows
    # too long to stage), so its time is taken in this run too, as v1_ms
    print(json.dumps({"kernels": [{
        "name": k,
        "route": "cuda",
        "source": src,
        "replaces": replaces,
        "launches": launches[k],
        "max_abs_err": errs[k],
        "ms": times[k][0],
        "plain_ms": times[k][1],
        "bound_ms": bounds[k][0],
        "bound_by": bounds[k][1],
        "library_ms": library_ms if k == "fir_block" else None,
        **({"v1_ms": times[k][2]} if len(times[k]) > 2 else {}),
    } for k, (src, replaces) in sources.items()]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
