"""yagi_tpu_torch — the PyTorch/CUDA port of yagi_tpu.

Same DSP objects, state carry and typed errors as :mod:`yagi_tpu`, in
PyTorch; each Pallas TPU kernel on a ported path becomes a hand-written
Hopper kernel (``csrc/``), built with nvcc at first use. Imports torch and
never jax. Ported so far: the BASELINE config[0] receive chain (Kaiser FIR →
2× polyphase interpolator → u32 NCO mix-down), as :class:`chains.RxChain`
(plain torch) and :class:`chains.FusedRxChain` (one kernel per block); and
the config[4] path, the 64-channel polyphase channelizer
(:class:`multichannel.Firpfbch`, plain torch, and
:class:`multichannel.FusedChannelizer`, one kernel per block) feeding the FM
discriminator :class:`modem.Freqdem`; the config[1] path, :class:`filter.MsResamp`
feeding :class:`filter.Symsync` (kernels K3 and K4); and the config[3] 16-QAM
receiver :class:`chains.QamRx` (AGC, symsync on K3, LMS equalizer and carrier
PLL, decisions), three kernels per block; the config[2] FM stereo receiver
:class:`chains.FmStereoRx` over the IIR family; the distributed layer
:mod:`parallel` (one process a card over ``torch.distributed``); the FFT
layer :mod:`fft`; the oversampled and arbitrary-rate channelizers; the
rest of the streaming filter layer L4 (interpolators, decimators, FftFilt,
Rresamp, Fdelay, OrdFilt, the Farrow filters and resampler values, Dds);
layers L0 and L1 (special functions, modular arithmetic, bits, sequences,
seeded samplers on a ``torch.Generator``, matrices, optimizers, buffers) and
the native capture-file loader, whose planar blocks go onto the card; and
layers L3, L5 and L6 with the channel models: all of FIR design and
Parks-McClellan, the oscillator's table modes and PLL, the RLS equalizer,
quantization, the rest of the linear modem (soft and differential
demodulation), FSK, GMSK/CPFSK, AM and OFDM framing, whose AM carrier
tracker runs the ``iir_chunked`` kernel; forward error correction and the
packet layer of framing (symbol streams, the packet modem, the burst
detector and synchronizers, frame64), whose Viterbi decoder and
synchronizers run in torch on the card; and the rest of framing (flexframe,
the GMSK, FSK and DSSS frames, the bit-level packet codec, the binary
correlator, the streaming detector, the multi-signal source), the OFDM
flexible frame, the CVSD codec, byte utilities and checkpoint / restore of
every state object. With these the port covers all of yagi_tpu but the
TPU-only code of ROADMAP's "Not to port" list.

Layer map (mirrors yagi_tpu):
  math/     host-side design math (float64 NumPy): special functions, windows,
            polynomials, modular arithmetic; complex helpers and dotprod on tensors
  sequence/ m-sequences and packed bit sequences (host)
  random/   seeded samplers on a torch.Generator, pdf/cdf (host), scramblers
  matrix/   dense and sparse matrices (host NumPy)
  optim/    1-D, gradient, quasi-Newton and genetic searches (host)
  buffer/   window, delay line, circular buffer (host)
  native/   ctypes loader of native/*.cpp (built with g++ into build/):
            NativeBSequence, IqStreamLoader (capture file -> planar blocks)
  fft/      transforms with liquid's conventions, periodograms, DCT/DST
  design/   FIR design: windowed-sinc, Parks-McClellan, the Nyquist and
            root-Nyquist families, GMSK, notch; IIR design
  filter/   streaming FIR and IIR filters, polyphase banks, resamplers,
            interpolators and decimators, symbol synchronizer
  nco/      oscillator (modes "nco", "vco", "exact"), PLL
  agc/      automatic gain control
  equalization/  LMS and RLS equalizers
  quantization/  mu-law companding, ADC/DAC quantizer
  modem/    linear modem (hard, soft, differential), analog FM and AM, FSK,
            GMSK and CPFSK
  channel/  multipath, carrier offset and AWGN
  multichannel/  polyphase channelizers, OFDM frame generator and synchronizer,
            the OFDM flexible frame
  fec/      CRC, block codes, Golay, Reed-Solomon, interleaver (host numpy),
            convolutional codes with the Viterbi decoder on the device,
            the packetizer
  framing/  symbol streams, packet modem, burst detector and synchronizers
            (QDetector, QDSync, QPilotGen/QPilotSync), frame64, flexframe,
            GMSK/FSK/DSSS frames, BPacket, BSync, Detector, MSource
  audio/    CVSD codec
  kernels/  Hopper kernels beside their plain torch versions
  chains/   composed receive chains
  parallel/ sharded streaming over torch.distributed (halo exchange,
            all_to_all channel redistribution, multi-host wiring)
  utils/    array helpers, bit and byte utilities, PSD-mask validators,
            checkpoint / restore
"""

__version__ = "0.1.0"

from . import errors  # noqa: F401
from . import math  # noqa: F401


def __getattr__(name):
    import importlib

    if name in ("design", "filter", "nco", "agc", "equalization", "modem", "multichannel",
                "kernels", "chains", "fft", "parallel", "utils", "sequence", "random", "matrix",
                "optim", "buffer", "native", "quantization", "channel", "fec", "framing",
                "audio"):
        return importlib.import_module(f"yagi_tpu_torch.{name}")
    raise AttributeError(f"module 'yagi_tpu_torch' has no attribute {name!r}")
