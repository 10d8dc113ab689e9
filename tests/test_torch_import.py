"""yagi_tpu_torch stands alone: it imports no jax and no yagi_tpu, and keeps
yagi_tpu's error taxonomy."""

import inspect
import os
import subprocess
import sys

import pytest
import torch

import yagi_tpu.errors as jerr
import yagi_tpu_torch.errors as terr

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_MODULES = (
    "yagi_tpu_torch",
    "yagi_tpu_torch.errors",
    "yagi_tpu_torch._src.struct",
    "yagi_tpu_torch.math",
    "yagi_tpu_torch.design",
    "yagi_tpu_torch.filter",
    "yagi_tpu_torch.nco",
    "yagi_tpu_torch.modem",
    "yagi_tpu_torch.multichannel",
    "yagi_tpu_torch.kernels",
    "yagi_tpu_torch.kernels._build",
    "yagi_tpu_torch.kernels.channelizer",
    "yagi_tpu_torch.kernels.mix",
    "yagi_tpu_torch.kernels.symscan",
    "yagi_tpu_torch.filter.msresamp",
    "yagi_tpu_torch.filter.symsync",
    "yagi_tpu_torch.design.pm",
    "yagi_tpu_torch.optim",
    "yagi_tpu_torch.utils",
    "yagi_tpu_torch.chains",
    "yagi_tpu_torch.agc",
    "yagi_tpu_torch.equalization",
    "yagi_tpu_torch.modem.modem",
    "yagi_tpu_torch.kernels.agc",
    "yagi_tpu_torch.kernels.qam",
    "yagi_tpu_torch.chains.qam",
    "yagi_tpu_torch._src.device",
    "yagi_tpu_torch.tools.timing",
    "yagi_tpu_torch.tools.paths",
    "yagi_tpu_torch.tools.kernel_ab",
    "yagi_tpu_torch.tools.step_profile",
    "yagi_tpu_torch.math.poly",
    "yagi_tpu_torch.design.iir",
    "yagi_tpu_torch.filter.iirfilt",
    "yagi_tpu_torch.filter.iirfiltsos",
    "yagi_tpu_torch.filter._linrec",
    "yagi_tpu_torch.filter.iirhilb",
    "yagi_tpu_torch.filter.firhilb",
    "yagi_tpu_torch.chains.fm",
    "yagi_tpu_torch.kernels.iir",
    "yagi_tpu_torch.parallel",
    "yagi_tpu_torch.parallel.stream",
    "yagi_tpu_torch.parallel.channelizer",
    "yagi_tpu_torch.parallel.multihost",
    "yagi_tpu_torch.fft",
    "yagi_tpu_torch.fft.r2r",
    "yagi_tpu_torch.fft.spgram",
    "yagi_tpu_torch.fft.spwaterfall",
    "yagi_tpu_torch.fft.asgram",
    "yagi_tpu_torch.multichannel.firpfbch",
    "yagi_tpu_torch.multichannel.firpfbchr",
    "yagi_tpu_torch.math.windows",
    "yagi_tpu_torch.utils.psd_validate",
    "yagi_tpu_torch.tools.multihost_worker",
    "yagi_tpu_torch._src.window",
    "yagi_tpu_torch.filter._conv",
    "yagi_tpu_torch.filter.firpfb",
    "yagi_tpu_torch.filter.firinterp",
    "yagi_tpu_torch.filter.firdecim",
    "yagi_tpu_torch.filter.fftfilt",
    "yagi_tpu_torch.filter.rresamp",
    "yagi_tpu_torch.filter.misc",
    "yagi_tpu_torch.filter.farrow",
    "yagi_tpu_torch.filter._farrow_resamp",
    "yagi_tpu_torch.filter.resamp",
    "yagi_tpu_torch.filter.resamp2",
    "yagi_tpu_torch.filter.msresamp2",
    "yagi_tpu_torch.nco.osc",
    "yagi_tpu_torch.math.special",
    "yagi_tpu_torch.math.modarith",
    "yagi_tpu_torch.math.complexm",
    "yagi_tpu_torch.math.dot",
    "yagi_tpu_torch.utils.bits",
    "yagi_tpu_torch.sequence",
    "yagi_tpu_torch.sequence.msequence",
    "yagi_tpu_torch.sequence.bsequence",
    "yagi_tpu_torch.native",
    "yagi_tpu_torch.random",
    "yagi_tpu_torch.random.distributions",
    "yagi_tpu_torch.random.scramble",
    "yagi_tpu_torch.matrix",
    "yagi_tpu_torch.matrix.dense",
    "yagi_tpu_torch.matrix.sparse",
    "yagi_tpu_torch.optim.qs1dsearch",
    "yagi_tpu_torch.optim.gradsearch",
    "yagi_tpu_torch.optim.gasearch",
    "yagi_tpu_torch.buffer",
    "yagi_tpu_torch.buffer.buffer",
    "yagi_tpu_torch.quantization",
    "yagi_tpu_torch.channel",
    "yagi_tpu_torch.modem.fsk",
    "yagi_tpu_torch.modem.cpm",
    "yagi_tpu_torch.modem.ampmodem",
    "yagi_tpu_torch.equalization.eqrls",
    "yagi_tpu_torch.multichannel.ofdm",
    "yagi_tpu_torch.fec",
    "yagi_tpu_torch.fec._bits",
    "yagi_tpu_torch.fec.crc",
    "yagi_tpu_torch.fec.block",
    "yagi_tpu_torch.fec.golay",
    "yagi_tpu_torch.fec.interleave",
    "yagi_tpu_torch.fec.rs",
    "yagi_tpu_torch.fec.conv",
    "yagi_tpu_torch.fec.api",
    "yagi_tpu_torch.fec.packetizer",
    "yagi_tpu_torch.framing",
    "yagi_tpu_torch.framing._sync",
    "yagi_tpu_torch.framing._carrier",
    "yagi_tpu_torch.framing.symstream",
    "yagi_tpu_torch.framing.qpacketmodem",
    "yagi_tpu_torch.framing.qdetector",
    "yagi_tpu_torch.framing.qdsync",
    "yagi_tpu_torch.framing.qpilot",
    "yagi_tpu_torch.framing.frame64",
    "yagi_tpu_torch.framing.flexframe",
    "yagi_tpu_torch.framing.gmskframe",
    "yagi_tpu_torch.framing.fskframe",
    "yagi_tpu_torch.framing.dsssframe",
    "yagi_tpu_torch.framing.bpacket",
    "yagi_tpu_torch.framing.bsync",
    "yagi_tpu_torch.framing.detector",
    "yagi_tpu_torch.framing.msource",
    "yagi_tpu_torch.multichannel.ofdmflexframe",
    "yagi_tpu_torch.audio",
    "yagi_tpu_torch.audio.cvsd",
    "yagi_tpu_torch.utils.byteops",
    "yagi_tpu_torch.utils.checkpoint",
    "yagi_tpu_torch.trace",
)


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'yagi_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=_ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_new_names_import_alone():
    """The slice-6 names resolve from the package root (lazy subpackages)."""
    import yagi_tpu_torch

    assert yagi_tpu_torch.parallel.sharded_channelize_stream_fm_to_channels
    assert yagi_tpu_torch.fft.Spgram and yagi_tpu_torch.utils.validate_psd_spgram
    assert yagi_tpu_torch.multichannel.Firpfbch2 and yagi_tpu_torch.multichannel.Firpfbchr


def test_l4_names_match_yagi_tpu():
    """Every streaming filter yagi_tpu.filter exports has its counterpart
    under the same name."""
    import yagi_tpu.filter as jf
    import yagi_tpu_torch.filter as tf

    public = sorted(n for n in vars(jf) if not n.startswith("_") and not inspect.ismodule(
        getattr(jf, n)))
    assert [n for n in public if not hasattr(tf, n)] == []


# layers L0 and L1 and the native loader: yagi_tpu's module → the port's
_L0_L1 = ("math", "math.special", "math.modarith", "math.complexm", "math.dot", "sequence",
          "random", "matrix", "optim", "buffer", "utils.bits", "native")


def _public(mod) -> list[str]:
    """A module's public names: its ``__all__`` and what it defines or
    re-exports from its own package (not the modules and helpers it imports)."""
    own = set(getattr(mod, "__all__", ()))
    for n, v in vars(mod).items():
        if not n.startswith("_") and not inspect.ismodule(v) and getattr(
                v, "__module__", "").startswith("yagi_tpu."):
            own.add(n)
    return sorted(own)


@pytest.mark.parametrize("name", _L0_L1)
def test_l0_l1_names_match_yagi_tpu(name):
    """Every public name of yagi_tpu's L0/L1 module has a counterpart of
    the same kind under the same name."""
    import importlib

    j = importlib.import_module(f"yagi_tpu.{name}")
    t = importlib.import_module(f"yagi_tpu_torch.{name}")
    public = _public(j)
    assert public, name
    assert [n for n in public if not hasattr(t, n)] == []
    assert [n for n in public if inspect.isclass(getattr(j, n)) != inspect.isclass(getattr(t, n))
            ] == []


# layers L3, L5 and L6 and the channel models: yagi_tpu's module → the port's
_L3_L5_L6 = ("design", "design.pm", "design.fir", "nco", "nco.osc", "quantization",
             "equalization", "equalization.eqrls", "modem", "modem.modem", "modem.fsk",
             "modem.cpm", "modem.ampmodem", "multichannel", "multichannel.ofdm", "channel")


@pytest.mark.parametrize("name", _L3_L5_L6)
def test_l3_l5_l6_names_match_yagi_tpu(name):
    """Every name in the ``__all__`` of yagi_tpu's L3/L5/L6 module (or, for
    a package without one, every public name it defines or re-exports) has
    a counterpart of the same kind in the port (the OFDM flex frames, which
    waited for the framing layer, too: slice 10)."""
    import importlib

    j = importlib.import_module(f"yagi_tpu.{name}")
    t = importlib.import_module(f"yagi_tpu_torch.{name}")
    public = list(j.__all__ if hasattr(j, "__all__") else _public(j))
    assert public, name
    assert [n for n in public if not hasattr(t, n)] == []
    assert [n for n in public if inspect.isclass(getattr(j, n)) != inspect.isclass(getattr(t, n))
            ] == []


# slice 9: fec/ and framing/'s packet layer; the frame formats built on it
# came in slice 10
_SLICE9 = ("fec", "fec._bits", "fec.crc", "fec.block", "fec.golay", "fec.interleave", "fec.rs",
           "fec.conv", "fec.api", "fec.packetizer", "framing", "framing._carrier",
           "framing.symstream", "framing.qpacketmodem", "framing.qdetector", "framing.qdsync",
           "framing.qpilot", "framing.frame64")
_SLICE10 = {"FlexFrameGen", "FlexFrameSync", "GmskFrameGen", "GmskFrameSync", "DsssFrameGen64",
            "DsssFrameSync64", "FskFrameGen", "FskFrameSync", "MSource", "BSync", "Detector",
            "BPacketGen", "BPacketSync"}


@pytest.mark.parametrize("name", _SLICE9)
def test_slice9_names_match_yagi_tpu(name):
    """The ``__all__`` of each slice-9 module equals yagi_tpu's (for
    ``framing``, which has none, every public name it defines or
    re-exports, slice 10's frame formats among them), each name of the
    same kind."""
    import importlib

    j = importlib.import_module(f"yagi_tpu.{name}")
    t = importlib.import_module(f"yagi_tpu_torch.{name}")
    if hasattr(j, "__all__"):
        assert list(t.__all__) == list(j.__all__)
        public = list(j.__all__)
    else:
        public = _public(j)
        assert _SLICE10 <= set(public)
    assert public, name
    assert [n for n in public if not hasattr(t, n)] == []
    assert [n for n in public if inspect.isclass(getattr(j, n)) != inspect.isclass(getattr(t, n))
            ] == []


# slice 10: the rest of framing/, ofdmflexframe, audio/ and utils' byteops
# and checkpoint
_SLICE10_MODULES = ("framing.flexframe", "framing.gmskframe", "framing.fskframe",
                    "framing.dsssframe", "framing.bpacket", "framing.bsync", "framing.detector",
                    "framing.msource", "multichannel.ofdmflexframe", "audio", "audio.cvsd",
                    "utils.byteops", "utils.checkpoint")


@pytest.mark.parametrize("name", _SLICE10_MODULES)
def test_slice10_names_match_yagi_tpu(name):
    """The ``__all__`` of each slice-10 module equals yagi_tpu's, each name
    of the same kind (a class, or a function)."""
    import importlib

    j = importlib.import_module(f"yagi_tpu.{name}")
    t = importlib.import_module(f"yagi_tpu_torch.{name}")
    assert list(t.__all__) == list(j.__all__) and j.__all__, name
    for n in j.__all__:
        assert inspect.isclass(getattr(j, n)) == inspect.isclass(getattr(t, n)), n
        assert callable(getattr(t, n)), n


def test_slice10_names_import_alone():
    """audio resolves from the package root (a lazy subpackage); utils
    exports byteops and the checkpoint functions, as yagi_tpu's does."""
    import yagi_tpu_torch

    assert yagi_tpu_torch.audio.Cvsd and yagi_tpu_torch.framing.MSource
    assert yagi_tpu_torch.multichannel.OfdmFlexFrameSync
    u = yagi_tpu_torch.utils
    assert u.byteops.pack_bytes and u.save_state and u.load_state and u.state_leaves


# yagi_tpu's files with no counterpart in the port, on purpose: ROADMAP's
# "Not to port" list (TPU-only code)
_NOT_TO_PORT = {"utils/planar.py", "utils/smallbatch.py"}


def test_every_yagi_tpu_file_has_a_port():
    """Every .py file under yagi_tpu/ has a file at the same path under
    yagi_tpu_torch/, or is on the not-to-port list (and that one has
    none)."""
    src, dst = os.path.join(_ROOT, "yagi_tpu"), os.path.join(_ROOT, "yagi_tpu_torch")
    files = sorted(os.path.relpath(os.path.join(d, f), src) for d, _, fs in os.walk(src)
                   for f in fs if f.endswith(".py") and "__pycache__" not in d)
    assert len(files) > 100
    missing = [f for f in files if f not in _NOT_TO_PORT
               and not os.path.exists(os.path.join(dst, f))]
    assert missing == []
    assert [f for f in _NOT_TO_PORT if os.path.exists(os.path.join(dst, f))] == []


def test_slice9_names_import_alone():
    """fec and framing resolve from the package root (lazy subpackages);
    FRAME64_LEN is evaluated lazily, on the host."""
    import yagi_tpu_torch

    assert yagi_tpu_torch.fec.Packetizer and yagi_tpu_torch.framing.FrameSync64
    assert yagi_tpu_torch.framing.FRAME64_LEN == 1588


def _error_classes(mod):
    return {
        name: cls for name, cls in vars(mod).items()
        if inspect.isclass(cls) and issubclass(cls, Exception) and cls.__module__ == mod.__name__
    }


# the port's own: no CUDA device for an entry point called without a device
_PORT_ONLY = {"DeviceError"}


def test_error_names_match():
    assert sorted(set(_error_classes(terr)) - _PORT_ONLY) == sorted(_error_classes(jerr))
    assert all(issubclass(getattr(terr, n), terr.YagiError) for n in _PORT_ONLY)


@pytest.mark.parametrize("name", sorted(_error_classes(jerr)))
def test_error_hierarchy_matches(name):
    def bases(cls):
        return [b.__name__ for b in cls.__mro__]

    assert bases(getattr(terr, name)) == bases(getattr(jerr, name))
