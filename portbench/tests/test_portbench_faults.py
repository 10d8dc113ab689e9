"""The check fails what it should: the control (the reference in the next
precision below the configuration's, in the program's place) and the timed
path broken underneath, once for each fault a one-chip cell can have."""

import pytest
import torch

from portbench.tests.helpers import tiny_run

CELLS = ("rxchain16.blk1m", "qamrx2048.blk4k")


def stale_state(step):
    """A step that returns its state unchanged."""
    def run(state, x):
        out, _ = step(state, x)
        return out, state
    return run


def half_batch(step):
    """Half of the channels left out, each replaced by the mean of the rest
    (decisions and flags by the first channel's)."""
    def fill(t):
        t = t.clone()
        h = t.shape[0] // 2
        if t.is_floating_point() or t.is_complex():
            t[h:] = t[:h].mean(0)
        else:
            t[h:] = t[0]
        return t

    def run(state, x):
        out, new = step(state, x)
        return (tuple(fill(o) for o in out) if isinstance(out, tuple) else fill(out)), new
    return run


def altered_answer(step):
    """One answer altered where it is produced: the first output sample of
    channel 0, or its first decided symbol."""
    def run(state, x):
        out, new = step(state, x)
        if isinstance(out, tuple):
            syms, soft, mask = out
            syms = syms.clone()
            j = mask[0].to(torch.int8).argmax()
            syms[0, j] = (syms[0, j] + 1) % 16
            return (syms, soft, mask), new
        out = out.clone()
        out[0, 0] += 1.0
        return out, new
    return run


@pytest.mark.parametrize("fault", [stale_state, half_batch, altered_answer])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(cell, fault):
    res = tiny_run(cell, step_wrapper=fault)
    assert not res.correct, res.checks
    assert res.line["correct"] is False and res.line["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    res = tiny_run(cell, control=True)
    assert not res.correct, res.checks
