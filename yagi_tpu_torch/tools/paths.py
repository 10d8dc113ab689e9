"""The shapes and inputs of the config[0], config[4], config[1], config[3]
and config[2] paths, the streaming filters of layer L4 at config[1]'s
width, the widths of the modems, the sizes and impaired bursts of the FEC
and packet-framing layer, and those of the frame formats, codec and
checkpoints, in one place for ``chip_smoke.py`` and the tools that time
those paths on the card (:mod:`.kernel_ab`, :mod:`.step_profile`)."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..chains import ChannelizerFmRx, FmStereoRx, FusedRxChain, QamRx
from ..channel import Channel
from ..design import fir_design_kaiser
from ..filter import (Dds, Fdelay, FftFilt, FirDecimationFilter, FirInterpolationFilter,
                      MsResamp, OrdFilt, Rresamp, Symsync)
from ..framing import FrameGen64, frame64_len
from ..kernels.channelizer import fm_reference, fused_channelizer_apply
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
T4_CELL = 1 << 18  # the benchmark cell chz64fm.blk16m's block: 2^24 complex samples

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

# the FEC and packet-framing layer (chip_smoke.py's [framing]): every
# FecScheme on a FEC_LEN-byte message from numpy seed FEC_SEED; FRAME_N
# frame64 bursts (8-byte header, 64-byte payload), each alone in a
# FRAME_BUF-sample buffer, through tests/test_framing2.py:112-160's
# impairments at FRAME_SNR_DB (frame_bursts); QD_BURSTS bursts of a
# QD_PRE-symbol BPSK preamble and QD_PAYLOAD QPSK symbols with a pilot every
# QD_SPACING; SymStreamR at bandwidth STREAM_BW for STREAM_N samples
FEC_LEN, FEC_SEED = 64, 14
FRAME_N, FRAME_BUF, FRAME_SNR_DB, FRAME_SEED = 64, 4096, 20.0, 14
FRAME_DPHI_MAX, FRAME_GAIN = 0.012, (0.5, 1.3)  # rad/sample; linear
QD_BURSTS, QD_PRE, QD_PAYLOAD, QD_SPACING = 16, 64, 1024, 16
STREAM_BW, STREAM_N = 0.3, 1 << 20

# the frame formats, codec and checkpoints (chip_smoke.py's [frames]), from
# numpy seed FRAMES_SEED: FLEX_PER flexframe bursts of each FLEX_CASES
# (mod, crc, fec0, fec1, payload bytes, SNR dB; liquid's flexframe
# properties over its usual payload sizes), each in a FLEX_BUF-sample
# buffer; GF_BURSTS GMSK (k 2, m 3, bt 0.5) and GF_BURSTS FSK frames (k 8,
# bandwidth 0.25, m 1 and 2) of GF_PAYLOAD bytes under hamming128 at
# GF_SNR_DB; DSSS_PER frames at each DSSS_CASES (sf, SNR dB, threshold);
# OFDM_FLEX_FRAMES OFDM flexible frames (M 64, cp 16, qpsk and qam16,
# OFDM_FLEX_PAYLOAD bytes) and OFDM_FLEX_LONG[0] qpsk frames of
# OFDM_FLEX_LONG[1] bytes (~270 OFDM symbols, long enough for the residual
# carrier offset to carry a symbol's common phase past ±π); a DET_N-sample capture with DET_BURSTS frame64
# bursts, one every DET_SPACING ± 2·DET_JITTER samples, fed to Detector in
# DET_BLOCK-sample blocks; BSync over BSYNC_SHAPE; MSource → K2 over MSRC_N
# samples; Cvsd over CVSD_C channels of CVSD_N samples (one second at 8 kHz)
FRAMES_SEED = 16
FLEX_CASES = (("qpsk", "crc32", "none", "none", 1024, 20.0),
              ("qam16", "crc32", "hamming128", "none", 512, 25.0),
              ("psk8", "crc32", "hamming74", "conv27p23", 128, 20.0),
              ("qpsk", "crc16", "golay2412", "none", 256, 20.0),
              ("bpsk", "crc24", "none", "rep3", 64, 15.0),
              ("qam64", "crc32", "rs8", "none", 1024, 30.0),
              ("pi4dqpsk", "crc32", "hamming128", "none", 256, 25.0),
              ("sqam32", "crc32", "none", "none", 256, 28.0))
FLEX_PER, FLEX_BUF = 4, 1 << 14
GF_BURSTS, GF_PAYLOAD, GF_SNR_DB = 16, (64, 256), 25.0
DSSS_CASES, DSSS_PER = ((8, 20.0, 0.35), (16, 2.0, 0.25)), 16
OFDM_FLEX_FRAMES, OFDM_FLEX_PAYLOAD, OFDM_FLEX_LONG = 16, (512, 1024), (4, 3072)
DET_N, DET_BURSTS, DET_SPACING, DET_JITTER, DET_BLOCK = 1 << 20, 64, 1 << 14, 2048, 1 << 15
BSYNC_SHAPE = (1024, 1 << 16)
MSRC_N = 1 << 21
CVSD_C, CVSD_N = 1024, 8000


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


def make_chzfm(device) -> ChannelizerFmRx:
    """config[4]'s entry: the channelizer of :data:`CHZ` → the discriminator at :data:`KF`."""
    return ChannelizerFmRx.create(M4, CHZ["m"], CHZ["as_"], KF, device=device)


def chzfm_calls(device, t: int, sets: int, seed: int = CHZ_SEED):
    """config[4]'s step on ``sets`` random input sets of t analyzer steps,
    from a random history and random last outputs, two ways: K2's FM instance
    (one call of the wrapper with its FM argument) and its plain version (the
    plain instance, the torch discriminator ``fm_reference``, the state's
    copies). Each call returns ``(yr, yi, fm, r_prime', hist_r', hist_i')``;
    returns the two lists of calls, one call an input set."""
    rx = make_chzfm(device)
    chz = rx.chz
    g = torch.Generator().manual_seed(seed)

    def f32(n: int) -> torch.Tensor:
        return torch.randn(n, generator=g).to(device)

    nh = chz.hist_r.shape[0]
    hist = (f32(nh), f32(nh))
    r_prime = torch.complex(f32(M4), f32(M4))
    xs = [(f32(M4 * t), f32(M4 * t)) for _ in range(sets)]

    def fused(xr, xi):
        return fused_channelizer_apply(xr, xi, chz.taps, chz.hr, chz.hi, *hist, p=chz.p,
                                       r2=chz.r2, fm=(r_prime, rx.ref))

    def plain(xr, xi):
        yr, yi = fused_channelizer_apply(xr, xi, chz.taps, chz.hr, chz.hi, *hist, p=chz.p,
                                         r2=chz.r2)
        fm = fm_reference(yr, yi, r_prime, rx.ref)
        return (yr, yi, fm, torch.complex(yr[-1], yi[-1]), xr[-nh:].clone(),
                xi[-nh:].clone())

    return [lambda x=x: fused(*x) for x in xs], [lambda x=x: plain(*x) for x in xs]


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


def impair(x: torch.Tensor, draw: dict, buf_len: int, gen: torch.Generator,
           snr_db: float = FRAME_SNR_DB) -> torch.Tensor:
    """A burst ``x`` (complex, on the card) in a ``buf_len``-sample buffer as
    tests/test_framing2.py:112-135 impairs it: delayed by ``draw``'s
    fractional ``tau`` (an FFT phase ramp), at ``lead``, times ``gain``, then
    through :class:`Channel` with the carrier offset ``dphi``, phase ``phi``
    and AWGN ``snr_db`` below the burst's power (noise from ``gen``)."""
    n = x.shape[0]
    f = torch.fft.fftfreq(n, dtype=torch.float64, device=x.device)
    xd = torch.fft.ifft(torch.fft.fft(x.to(torch.complex128))
                        * torch.polar(torch.ones_like(f), -2 * math.pi * f * draw["tau"]))
    buf = torch.zeros(buf_len, dtype=torch.complex64, device=x.device)
    buf[draw["lead"]: draw["lead"] + n] = (draw["gain"] * xd).to(torch.complex64)
    power = draw["gain"] ** 2 * float(x.abs().square().mean())
    ch = Channel.create(snr_db=snr_db - 10 * math.log10(power), dphi=draw["dphi"],
                        phi=draw["phi"], device=x.device)
    return ch.execute(gen, buf)[0]


def impaired_burst(x: torch.Tensor, rng, gen: torch.Generator, buf_len: int, snr_db: float,
                   lead: int | None = None) -> tuple[torch.Tensor, dict]:
    """A burst ``x`` through :func:`impair` with draws from ``rng`` (the lead
    ``lead`` where given) in a ``buf_len``-sample buffer at ``snr_db``:
    (the buffer, the draws)."""
    draw = draw_impairments(rng, x.shape[0], buf_len)
    if lead is not None:
        draw["lead"] = lead
    return impair(x, draw, buf_len, gen, snr_db), draw


def draw_impairments(rng, n: int, buf_len: int) -> dict:
    """One burst's draws: lead in [64, buf_len − n − 64], tau in [0, 1),
    dphi in ±FRAME_DPHI_MAX, phi uniform, gain in FRAME_GAIN."""
    return {"lead": int(rng.integers(64, buf_len - n - 64 + 1)), "tau": float(rng.uniform(0, 1)),
            "dphi": float(rng.uniform(-FRAME_DPHI_MAX, FRAME_DPHI_MAX)),
            "phi": float(rng.uniform(-math.pi, math.pi)), "gain": float(rng.uniform(*FRAME_GAIN))}


def frame_bursts(count: int, seed: int, device) -> tuple:
    """``count`` impaired frame64 bursts from numpy seed ``seed``: (buffers
    [count, FRAME_BUF] complex64 on ``device``, headers [count, 8] and
    payloads [count, 64] uint8, the draws)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    fg = FrameGen64(device=device)
    hdrs = rng.integers(0, 256, (count, 8)).astype(np.uint8)
    plds = rng.integers(0, 256, (count, 64)).astype(np.uint8)
    draws = [draw_impairments(rng, frame64_len(), FRAME_BUF) for _ in range(count)]
    bufs = torch.stack([impair(fg.execute(h, p), d, FRAME_BUF, gen)
                        for h, p, d in zip(hdrs, plds, draws)])
    return bufs, hdrs, plds, draws
