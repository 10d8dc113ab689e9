"""``FmStereoRx.step`` on complex64 blocks [C, T]: the discriminator's torch
ops, the four 129-tap FIRs as banded matmuls (``filter/_conv.py``), the
pilot's subcarrier, the two de-emphasis IIRs on ``iir_chunked`` and the
state's glue. The outputs are ``(left, right, pilot_level)``: [C, T], [C, T]
and [C].

On a CUDA device the step is captured once, at set-up, as a CUDA graph of
``FmStereoRx.step`` and replayed for every block, as a deployment at fixed
shapes runs it. The step is 60 to 100 small launches, and their host
dispatch on a shared host swings from run to run by more than the card's
~2.5 ms of work a block at 512 × 16,384 (an H100): eager, the cell's rate
followed the host. The replay runs every device operation ``step`` launches;
inside the graph the state's new values are copied back into its input
state. The block is copied into the graph's input, and the outputs and the
carried fields are cloned out, so that each block keeps its own (the check
reads blocks kept from anywhere in the window). On the CPU each block runs
``step`` itself."""

from __future__ import annotations

import dataclasses

import torch

from yagi_tpu_torch.chains import FmStereoRx


def _leaves(obj) -> list:
    """The tensors of a state object, field by field, nested states walked."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif dataclasses.is_dataclass(v):
            out.extend(_leaves(v))
    return out


def _rebuild(obj, tensors):
    """``obj`` with its tensors, in :func:`_leaves`' order, taken from the
    iterator ``tensors``."""
    upd = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            upd[f.name] = next(tensors)
        elif dataclasses.is_dataclass(v):
            upd[f.name] = _rebuild(v, tensors)
    return obj.replace(**upd)


class Driver:
    def __init__(self, cfg: dict, wl: dict, device):
        self.rx = FmStereoRx.create(kf=cfg["kf"], f_pilot=cfg["f_pilot"], f_audio=cfg["f_audio"],
                                    deemph_alpha=cfg["deemph_alpha"], n_taps=cfg["n_taps"],
                                    batch_shape=(cfg["channels"],), device=device)
        self.graph = None

    def initial_state(self):
        return self.rx

    def step(self, state, x):
        if x.device.type != "cuda":
            left, right, pilot_level, state = state.step(x)
            return (left, right, pilot_level), state
        if self.graph is None:
            self._capture(state, x)
        if state is not self.last:  # a state the graph's input does not hold
            given = _leaves(state)
            for i in self.moving:
                self.static_in[i].copy_(given[i])
        self.x.copy_(x)
        self.graph.replay()
        out = tuple(t.clone() for t in self.out)
        keep = set(self.moving)
        self.last = _rebuild(self.state, iter([t.clone() if i in keep else t
                                               for i, t in enumerate(self.static_in)]))
        return out, self.last

    def _capture(self, state, x) -> None:
        """The graph of one step from a copy of ``state`` on a copy of ``x``,
        warmed up first on a side stream, as CUDA graphs require."""
        self.x = x.clone()
        self.state = _rebuild(state, iter([t.clone() for t in _leaves(state)]))
        self.static_in = _leaves(self.state)
        side = torch.cuda.Stream(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self.state.step(self.x)
        torch.cuda.current_stream(x.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            left, right, pilot_level, new = self.state.step(self.x)
            after = _leaves(new)
            self.moving = [i for i, (d, s) in enumerate(zip(self.static_in, after)) if s is not d]
            for i in self.moving:
                self.static_in[i].copy_(after[i])
        self.out = (left, right, pilot_level)
        self.last = None

    @staticmethod
    def view(state) -> dict:
        """Every quantity the stream carries, by the reference's names."""
        return {"r_prime": state.demod.r_prime, "pilot_w": state.pilot_bp.window,
                "align_w": state.align.window, "mono_w": state.mono_lp.window,
                "diff_w": state.diff_lp.window, "deemph_l": state.deemph_l.v,
                "deemph_r": state.deemph_r.v}
