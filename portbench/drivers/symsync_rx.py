"""``ResampSymsyncRx.step_full`` on complex64 blocks [C, n]: the arbitrary
resampler's u32 PFB gather and its torch ops, then K3 at k_out = 1 over the
resampled block with the count as a device tensor, and the state's glue. The
outputs are ``(y, valid, r, count)``: the synchronizer's slots and mask, each
[C, cap, E], and the resampler's output [C, cap] with its 0-d count."""

from __future__ import annotations

from yagi_tpu_torch.chains import ResampSymsyncRx


class Driver:
    def __init__(self, cfg: dict, wl: dict, device):
        self.rx = ResampSymsyncRx.create(
            cfg["channels"], rate=cfg["rate"], as_=cfg["as"], ftype=cfg["ftype"], k=cfg["k"],
            m=cfg["m"], beta=cfg["beta"], npfb=cfg["npfb"], lf_bw=cfg["lf_bw"],
            k_out=cfg["k_out"], device=device)

    def initial_state(self):
        return self.rx

    @staticmethod
    def step(state, x):
        y, valid, r, count, state = state.step_full(x)
        return (y, valid, r, count), state

    @staticmethod
    def view(state) -> dict:
        """Every quantity the stream carries, by the reference's names."""
        ms, a, s = state.resamp, state.resamp.arbitrary, state.sync
        return {
            "rs_window": a.window, "rs_phase": a.phase, "rs_step": a.step,
            "ms_carry": ms.carry, "ms_carry_len": ms.carry_len,
            "ss_window": s.window, "ss_b": s.b, "ss_bf": s.bf, "ss_tau": s.tau,
            "ss_tau_d": s.tau_decim, "ss_rate": s.rate, "ss_delta": s.delta,
            "ss_dec": s.decim_counter, "ss_v0": s.pll_v[..., 0], "ss_v1": s.pll_v[..., 1],
        }
