"""The shapes and inputs of the config[0], config[4], config[1], config[3]
and config[2] paths, the streaming filters of layer L4 at config[1]'s
width, and the widths of the modems, in one place for ``chip_smoke.py`` and the tools that time those
paths on the card (:mod:`.kernel_ab`, :mod:`.step_profile`)."""

from __future__ import annotations

import numpy as np
import torch

from ..chains import FmStereoRx, FusedRxChain, QamRx
from ..design import fir_design_kaiser
from ..filter import (Dds, Fdelay, FftFilt, FirDecimationFilter, FirInterpolationFilter,
                      MsResamp, OrdFilt, Rresamp, Symsync)
from ..multichannel import FusedChannelizer

# config[0] (bench.py:44-82): 64-tap Kaiser FIR → 2× interpolator → mix-down
# over 16 channels, blocks of 2^17
C0, T0 = 16, 1 << 17
CHAIN = dict(n_taps=64, fc=0.2, as_=60.0, rate=2.0)
MIX_FREQ = 0.35

# config[4] (bench.py:85-125): 64-channel polyphase channelizer (Kaiser
# prototype, m = 4, 60 dB) → FM discriminator (kf = 0.1), 2^15 analyzer steps
# (2^21 complex samples) per block, seed 1
M4, T4 = 64, 1 << 15
CHZ = dict(num_channels=M4, m=4, as_=60.0, r2=128)
KF = 0.1
CHZ_SEED = 1

# config[1] (bench.py:160-192): MsResamp → Symsync over 1024 channels,
# blocks of 4096
C1, T1 = 1024, 1 << 12
MS_RATE = 2.0 / 2.0663
SYM = dict(ftype="rrcos", k=2, m=7, beta=0.3)
LF_BW = 0.02

# config[3] (bench.py:221-242): QamRx over 2048 channels, blocks of 4096,
# default_rng(4)-style standard-normal complex64 input
C3, T3 = 2048, 1 << 12
QAM_SEED = 4

# config[2] (bench.py:199-218): FmStereoRx with its defaults (kf 0.5, pilot
# 0.095, audio 0.075, de-emphasis alpha 0.05, 129 taps) over 512 channels,
# blocks of 2^14, default_rng(3) standard-normal complex × 0.1
C2, T2 = 512, 1 << 14
FM_SEED = 3
FM_SCALE = 0.1

# the modems, channel and equalizer (chip_smoke.py's [modems]) over 1024
# channels: 16-QAM
# (and DPSK, QPSK) blocks of 4096 symbols; GMSK, CPFSK and FSK blocks of
# 2048 symbols; AmpModem blocks of 2048 audio samples; Osc blocks of 2^14;
# the RLS equalizer (p 7) over 256 channels, 1024 samples in four blocks
MOD_C = 1024
QAM_SYMS, GMSK_BITS, CPFSK_SYMS, FSK_SYMS, AM_N, OSC_N = 4096, 2048, 2048, 2048, 2048, 1 << 14
EQRLS_C, EQRLS_N, EQRLS_P = 256, 1024, 7


def complex_block(rng, shape, device) -> torch.Tensor:
    """Standard-normal complex64 of ``shape`` from ``rng``, on ``device``."""
    re = rng.standard_normal(shape, dtype=np.float32)
    im = rng.standard_normal(shape, dtype=np.float32)
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)


def make_fused(c: int, device, **kw) -> FusedRxChain:
    return FusedRxChain.create(**{**CHAIN, "mix_freq": MIX_FREQ, **kw}, batch_shape=(c,),
                               device=device)


def make_channelizer(device, **kw) -> FusedChannelizer:
    return FusedChannelizer.create_kaiser(**{**CHZ, **kw}, device=device)


def make_msresamp(c: int, device) -> MsResamp:
    return MsResamp.create(MS_RATE, batch_shape=(c,), arbitrary_interp="farrow", device=device)


def make_symsync(c: int, device) -> Symsync:
    return Symsync.create_rnyquist(**SYM, batch_shape=(c,), device=device).set_lf_bw(LF_BW)


def make_qamrx(c: int, device) -> QamRx:
    return QamRx.create(batch_shape=(c,), device=device)


def make_fmstereo(c: int, device) -> FmStereoRx:
    return FmStereoRx.create(batch_shape=(c,), device=device)


def fm_block(rng, shape, device) -> torch.Tensor:
    """config[2]'s input as bench.py draws it: float64 standard-normal real
    parts, then imaginary parts, from ``rng``, as complex64 × 0.1."""
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return torch.from_numpy(x * FM_SCALE).to(device)


def make_filters(c: int, n: int, device) -> list:
    """Layer L4's streaming filters over c channels, for blocks of n complex
    samples (FftFilt's block size): (name, state, step), ``step(state, x) →
    (y, count, state)``, a resampler's fixed-capacity output and its count
    on the device, or the block's output and None. OrdFilt takes the real
    part of its block."""
    batch = (c,)

    def block(call):
        def step(st, x):
            y, st = call(st, x)
            return y, None, st
        return step

    def interp_decim(st, x):
        y, fi = st[0].execute_block(x)
        y, fd = st[1].execute_block(y)
        return y, (fi, fd)

    cplx = dict(batch_shape=batch, dtype=torch.complex64, device=device)
    return [
        ("FirInterpolationFilter -> FirDecimationFilter (kaiser, 2x, m 7, 60 dB)",
         (FirInterpolationFilter.create_kaiser(2, 7, 60.0, **cplx),
          FirDecimationFilter.create_kaiser(2, 7, 60.0, **cplx)),
         block(interp_decim)),
        (f"FftFilt (64-tap Kaiser, n {n})",
         FftFilt.create(fir_design_kaiser(64, 0.2, 60.0), n, **cplx),
         block(lambda st, x: st.execute_blocks(x))),
        ("Rresamp (P/Q 3/2)", Rresamp.create_kaiser(3, 2, batch_shape=batch, device=device),
         block(lambda st, x: st.execute_block(x))),
        ("Fdelay (nmax 16, delay 3.7)",
         Fdelay.create(16, batch_shape=batch, device=device).set_delay(3.7),
         block(lambda st, x: st.execute_block(x))),
        ("OrdFilt (medfilt, m 3)", OrdFilt.create_medfilt(3, batch_shape=batch, device=device),
         block(lambda st, x: st.execute_block(x.real))),
        ("Dds decim (2 stages, fc 0.1)", Dds.create(2, 0.1, batch_shape=batch, device=device),
         block(lambda st, x: st.decim_execute(x))),
        ("Dds interp (2 stages, fc 0.1)", Dds.create(2, 0.1, batch_shape=batch, device=device),
         block(lambda st, x: st.interp_execute(x))),
        ("MsResamp interp farrow (rate 2.0663/2)",
         MsResamp.create(2.0663 / 2, batch_shape=batch, arbitrary_interp="farrow",
                         device=device),
         lambda st, x: st.execute_block(x)),
    ]
