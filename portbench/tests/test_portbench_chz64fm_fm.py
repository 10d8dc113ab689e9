"""K2's FM instance, the channelizer with the FM discriminator in its
epilogue, as ``chz64fm.blk16m`` reads it: the reader of
``kernel.channelizer.fm_epilogue_share``, the cell's share and ops a step on
the card, and the FM instance against its plain instance and the
discriminator's plain version. Its card tests run with
``python -m pytest portbench/tests -q -m card``."""

import sys

import pytest
import torch

from portbench.tests.test_portbench_chz64fm import _read, _record, _run


def test_fm_epilogue_share_reader(monkeypatch):
    from yagi_tpu_torch import trace

    def totals(counters, launches):
        return {"spans": {}, "counters": counters, "launches": launches}

    name = "kernel.channelizer.fm_epilogue_share"
    cases = [
        (totals({"channelizer.fm_epilogue": 24}, {"fused_channelizer_apply": 24}), 1.0),
        (totals({"channelizer.fm_epilogue": 6}, {"fused_channelizer_apply": 24}), 0.25),
        (totals({"channelizer.fm_epilogue": 0}, {"fused_channelizer_apply": 0}), None),  # CPU
        (totals({}, {"fused_channelizer_apply": 24}), None),  # a program without the counter
    ]
    for snap, want in cases:
        monkeypatch.setattr(trace, "snapshot", lambda snap=snap: snap)
        assert _read(name, _record()) == want
    monkeypatch.setitem(sys.modules, "yagi_tpu_torch.trace", None)  # a port without tracing
    assert _read(name, _record()) is None


def test_a_traced_cpu_run_reads_no_fm_epilogue_share():
    line = _run(trace=True).line
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    assert metrics["kernel.channelizer.launches_per_step"] == 0.0  # the CPU route
    assert "kernel.channelizer.fm_epilogue_share" not in metrics  # no K2 launch


@pytest.mark.card
def test_cell_runs_the_fm_instance_in_one_op_a_step_on_the_card(cuda_device, monkeypatch):
    """The readers count over the process, as in a run of the cell alone: the
    launches and counters that earlier tests left are set aside first."""
    from yagi_tpu_torch import trace
    from yagi_tpu_torch.kernels import channelizer as k2

    monkeypatch.setattr(k2.fused_channelizer_apply, "launches", 0)
    trace.reset()
    res = _run(device=cuda_device, trace=True, seconds=1.0)
    assert res.correct, res.checks
    metrics = {k: v["value"] for k, v in res.line["metrics"].items()}
    assert metrics["kernel.channelizer.launches_per_step"] == 1.0
    assert metrics["kernel.channelizer.fm_epilogue_share"] == 1.0
    assert metrics["dispatch.ops_per_step"] <= 2


def _fm_call(rx, xr, xi, r_prime=None, r2=128):
    """One call of the FM route from ``rx``'s state (or another ``r_prime``)."""
    from yagi_tpu_torch.kernels.channelizer import fused_channelizer_apply

    chz = rx.chz
    rp = rx.r_prime if r_prime is None else r_prime
    return fused_channelizer_apply(xr, xi, chz.taps, chz.hr, chz.hi, chz.hist_r, chz.hist_i,
                                   p=chz.p, r2=r2, fm=(rp, rx.ref))


def _noise(device, n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((2, n), generator=g).to(device)


@pytest.mark.card
@pytest.mark.parametrize("t", [512, 20_002, 262_144])
def test_fm_instance_against_the_plain_instance_and_the_discriminator(cuda_device, t):
    """K2's FM instance at config[4]'s bank from a random history and last
    outputs: its channel planes equal the plain instance's bit for bit, fm is
    within 1e-6 of the discriminator's plain version on the same planes (the
    bound of ``test_discriminator_against_freqdem``), the state is an exact
    copy in new tensors. 20,002 steps split unevenly over the blocks, with a
    short last tile."""
    from yagi_tpu_torch.chains import ChannelizerFmRx
    from yagi_tpu_torch.kernels import channelizer as k2
    from yagi_tpu_torch.trace import snapshot

    rx = ChannelizerFmRx.create(device=cuda_device)
    nh = rx.chz.hist_r.shape[0]
    hist, rp = _noise(cuda_device, nh, 1), _noise(cuda_device, 64, 2)
    rx = rx.replace(chz=rx.chz.replace(hist_r=hist[0].clone(), hist_i=hist[1].clone()),
                    r_prime=torch.complex(rp[0], rp[1]))
    x = _noise(cuda_device, 64 * t, 3)
    launches = k2.fused_channelizer_apply.launches
    fm_count = snapshot()["counters"].get("channelizer.fm_epilogue", 0)
    yr, yi, fm, r_new, hr_new, hi_new = _fm_call(rx, x[0], x[1], r2=1)
    assert k2.fused_channelizer_apply.launches == launches + 1
    assert snapshot()["counters"]["channelizer.fm_epilogue"] == fm_count + 1
    chz = rx.chz
    pr, pi = k2.fused_channelizer_apply(x[0], x[1], chz.taps, chz.hr, chz.hi, chz.hist_r,
                                        chz.hist_i, p=chz.p, r2=1)
    assert torch.equal(yr, pr) and torch.equal(yi, pi)
    gap = (fm - k2.fm_reference(pr, pi, rx.r_prime, rx.ref)).abs().max().item()
    print(f"T={t}: largest |fm − plain| {gap:.3e}")
    assert gap <= 1e-6
    assert torch.equal(r_new, torch.complex(yr[-1], yi[-1]))
    assert torch.equal(hr_new, x[0][-nh:]) and torch.equal(hi_new, x[1][-nh:])
    inputs = {v.data_ptr() for v in (x[0], x[1], chz.hist_r, chz.hist_i, rx.r_prime)}
    outputs = [yr, yi, fm, r_new, hr_new, hi_new]
    assert not inputs & {v.data_ptr() for v in outputs}
    assert len({v.data_ptr() for v in outputs}) == len(outputs)


@pytest.mark.card
def test_fm_instance_takes_row_0_against_the_carried_outputs(cuda_device):
    """At a stream's start row 0 is taken against zeros (a fresh state's
    ``r_prime``), later against the outputs carried in; the other rows do
    not depend on them."""
    from yagi_tpu_torch.chains import ChannelizerFmRx
    from yagi_tpu_torch.kernels.channelizer import fm_reference

    rx = ChannelizerFmRx.create(device=cuda_device)
    assert not rx.r_prime.abs().any()
    x = _noise(cuda_device, 64 * 4096, 4)
    yr, yi, fm, *_ = _fm_call(rx, x[0], x[1])
    assert (fm[:1] - fm_reference(yr[:1], yi[:1], rx.r_prime, rx.ref)).abs().max() <= 1e-6
    rp = _noise(cuda_device, 64, 5)
    rp = torch.complex(rp[0], rp[1])
    _, _, fm2, *_ = _fm_call(rx, x[0], x[1], r_prime=rp)
    assert (fm2[:1] - fm_reference(yr[:1], yi[:1], rp, rx.ref)).abs().max() <= 1e-6
    assert not torch.equal(fm2[0], fm[0]) and torch.equal(fm2[1:], fm[1:])


@pytest.mark.card
@pytest.mark.parametrize("steps, r2", [((16_384, 8_448, 16_896), 128), ((10_002, 6, 9_994), 1)],
                         ids=["entry_blocks", "ragged"])
def test_fm_instance_three_blocks_equal_one_long_call(cuda_device, steps, r2):
    """Bit for bit (channels, fm, ``r_prime``, history), each call from the
    state the one before left: the entry's blocks (multiples of 16,384
    samples; 2, 1 and 2 tiles a block of the grid against 5 in the long
    call, so the seams fall inside its blocks), and blocks that end inside a
    tile, one of 6 steps (a grid of one block, its row 0 against the carried
    outputs)."""
    from yagi_tpu_torch.chains import ChannelizerFmRx

    rx = ChannelizerFmRx.create(device=cuda_device)
    x = _noise(cuda_device, 64 * sum(steps), 6)

    def stream(parts):
        state, outs = rx, []
        for part in parts:
            yr, yi, fm, rp, hr, hi = _fm_call(state, part[0].contiguous(), part[1].contiguous(),
                                              r2=r2)
            state = state.replace(chz=state.chz.replace(hist_r=hr, hist_i=hi), r_prime=rp)
            outs.append((yr, yi, fm))
        return [torch.cat(o) for o in zip(*outs)], state

    (whole, one), (split, three) = stream([x]), stream(torch.split(x, [64 * t for t in steps], 1))
    assert all(torch.equal(a, b) for a, b in zip(whole, split))
    assert torch.equal(one.r_prime, three.r_prime)
    assert torch.equal(one.chz.hist_r, three.chz.hist_r)
    assert torch.equal(one.chz.hist_i, three.chz.hist_i)


@pytest.mark.card
def test_past_64_taps_the_fm_route_is_the_tiled_instance_and_the_plain_discriminator(
        cuda_device):
    """p = 66 (``m=33``): one launch of the tiled instance, no FM-instance
    count, and the outputs of that launch followed by the plain
    discriminator, bit for bit."""
    from yagi_tpu_torch.chains import ChannelizerFmRx
    from yagi_tpu_torch.kernels import channelizer as k2
    from yagi_tpu_torch.trace import snapshot

    rx = ChannelizerFmRx.create(m=33, device=cuda_device)
    assert rx.chz.p == 66
    x = _noise(cuda_device, 64 * 4096, 7)
    launches = k2.fused_channelizer_apply.launches
    fm_count = snapshot()["counters"].get("channelizer.fm_epilogue", 0)
    yr, yi, fm, new = rx.step(x[0], x[1])
    assert k2.fused_channelizer_apply.launches == launches + 1
    assert snapshot()["counters"].get("channelizer.fm_epilogue", 0) == fm_count
    chz = rx.chz
    pr, pi = k2.fused_channelizer_apply(x[0], x[1], chz.taps, chz.hr, chz.hi, chz.hist_r,
                                        chz.hist_i, p=chz.p)
    assert torch.equal(yr, pr) and torch.equal(yi, pi)
    assert torch.equal(fm, k2.fm_reference(pr, pi, rx.r_prime, rx.ref))
    assert torch.equal(new.r_prime, torch.complex(yr[-1], yi[-1]))
