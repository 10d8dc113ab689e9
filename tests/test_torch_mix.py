"""yagi_tpu_torch's u32 NCO mix-down (kernel K5's plain version) against
yagi_tpu's Pallas mixer, and the kernels' build recipe.

mix_down_reference equals the port's Osc.mix_block_down bit for bit (the
same u32 ramp and rotation), and yagi_tpu's pallas_mix_down in interpret mode
within rtol/atol 1e-6, the tolerance of tests/test_native_kernels.py (XLA
and torch evaluate sin/cos and the complex product in other orders).

The CUDA kernel itself runs only on a GPU; chip_smoke.py holds it against
mix_down_reference there.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yagi_tpu.kernels import pallas_mix_down
from yagi_tpu.nco import Osc as JOsc
from yagi_tpu_torch.kernels import _build
from yagi_tpu_torch.kernels.mix import mix_down_apply, mix_down_reference
from yagi_tpu_torch.nco import Osc
from yagi_tpu_torch.tools import kernel_ab

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU

N = 32768  # the TPU kernel's tile: block lengths are multiples of it


def _cplx(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


@pytest.mark.parametrize("freq, phase", [(0.37, 1.1), (0.0, 0.0), (-2.9, 5.5), (3.1, -0.2)])
def test_reference_matches_pallas_and_osc(freq, phase):
    rng = np.random.default_rng(0)
    x = _cplx(rng, N)
    j = JOsc.create("exact").set_frequency(freq).set_phase(phase)
    t = Osc.create("exact", device=DEV).set_frequency(freq).set_phase(phase)
    y_pl = np.asarray(pallas_mix_down(jnp.asarray(x), j.theta, j.d_theta, interpret=True))
    y = mix_down_reference(torch.from_numpy(x), t.theta, t.d_theta)
    assert y.dtype == torch.complex64 and y.shape == (N,)
    np.testing.assert_allclose(y.numpy(), y_pl, rtol=1e-6, atol=1e-6)
    y_osc, _ = t.mix_block_down(torch.from_numpy(x))
    np.testing.assert_array_equal(y.numpy(), y_osc.numpy())


def test_streaming_with_carried_phase():
    """Two blocks with θ0' = θ0 + N·dθ (mod 2^32) equal one block of 2N."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_cplx(rng, 2 * N))
    osc = Osc.create("exact", device=DEV).set_frequency(0.91).set_phase(2.0)
    y_all = mix_down_apply(x, osc.theta, osc.d_theta)
    theta1 = (osc.theta + N * osc.d_theta) & 0xFFFFFFFF
    y_a = mix_down_apply(x[:N], osc.theta, osc.d_theta)
    y_b = mix_down_apply(x[N:], theta1, osc.d_theta)
    np.testing.assert_array_equal(y_all.numpy(), torch.cat([y_a, y_b]).numpy())


def test_cpu_routing_counts_no_launch():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_cplx(rng, N))
    osc = Osc.create("exact", device=DEV).set_frequency(0.2)
    before = mix_down_apply.launches
    y = mix_down_apply(x, osc.theta, osc.d_theta)
    assert mix_down_apply.launches == before
    np.testing.assert_array_equal(y.numpy(), mix_down_reference(x, osc.theta, osc.d_theta).numpy())


@pytest.mark.parametrize("n", [1000, N + 1, N // 2, 0])
def test_rejects_length_not_a_multiple_of_the_tile(n):
    osc = Osc.create("exact", device=DEV)
    with pytest.raises(ValueError):
        mix_down_apply(torch.zeros(n, dtype=torch.complex64), osc.theta, osc.d_theta)


@pytest.mark.parametrize("bad", ["dtype", "rank", "layout", "device", "phase"])
def test_rejects_bad_input(bad):
    osc = Osc.create("exact", device=DEV)
    x, theta0 = torch.zeros(N, dtype=torch.complex64), osc.theta
    if bad == "dtype":
        x = x.to(torch.complex128)
    elif bad == "rank":
        x = x.reshape(2, N // 2)
    elif bad == "layout":
        x = torch.zeros(2 * N, dtype=torch.complex64)[::2]
    elif bad == "device":
        x = x.to("meta")
    else:
        theta0 = theta0.to(torch.int32)
    with pytest.raises((ValueError, TypeError)):
        mix_down_apply(x, theta0, osc.d_theta)


# ------------------------------------------------------------ build recipe
_SOURCES = ["agc.cu", "chain.cu", "channelizer.cu", "fir.cu", "iir.cu", "mix.cu", "qam.cu",
            "resamp.cu", "symscan.cu"]


@pytest.mark.parametrize("name", _SOURCES)
def test_kernel_sources_are_plain_c(name):
    """A plain C interface (no PyTorch headers, so nvcc takes seconds), and
    every entry point the ctypes binding declares is defined."""
    src = (_build._CSRC / name).read_text()
    assert "torch/extension.h" not in src
    for entry in re.findall(r'extern "C" int (\w+)\(', src):
        assert entry in _build._SIGNATURES


@pytest.mark.parametrize("signatures, dirs", [
    (_build._SIGNATURES, (_build._CSRC,)),
    (kernel_ab.SIGNATURES, (_build._CSRC, kernel_ab.VARIANTS)),
], ids=["package", "kernel_ab"])
def test_every_bound_entry_point_has_a_source(signatures, dirs):
    """Every entry point a binding declares is defined in its sources: the
    A/B tool binds no interface that no source has any more."""
    text = "".join(src.read_text() for d in dirs for src in sorted(d.glob("*.cu")))
    for entry in signatures:
        assert f'extern "C" int {entry}(' in text
    assert sorted(p.name for p in _build._CSRC.glob("*.cu")) == sorted(_SOURCES)


@pytest.mark.parametrize("name", ["chain.cu", "mix.cu"])
def test_nco_step_is_shared(name):
    assert '#include "nco.cuh"' in (_build._CSRC / name).read_text()


def test_library_name_covers_headers(tmp_path):
    """An edit to a header alone must not reuse a library built before it."""
    (tmp_path / "a.cu").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one\n")
    before = _build.source_digest(tmp_path)
    assert _build.source_digest(tmp_path) == before
    (tmp_path / "b.cuh").write_text("// two\n")
    assert _build.source_digest(tmp_path) != before
    (tmp_path / "notes.txt").write_text("not a source\n")
    (tmp_path / "b.cuh").write_text("// one\n")
    assert _build.source_digest(tmp_path) == before
