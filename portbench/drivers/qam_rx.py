"""``QamRx.step_masked`` on complex64 blocks [C, n]: ``agc_scan``, K3 at
k_out = 2 and ``qam_eq_scan``, three launches and the state's glue. The
outputs are ``(syms, soft, mask)``, each [C, 2n]."""

from __future__ import annotations

from yagi_tpu_torch.chains import QamRx


class Driver:
    def __init__(self, cfg: dict, wl: dict, device):
        self.rx = QamRx.create(
            ftype=cfg["ftype"], k=cfg["k"], m=cfg["m"], beta=cfg["beta"], scheme=cfg["scheme"],
            eq_len=cfg["eq_len"], eq_bw=cfg["eq_bw"], pll_bw=cfg["pll_bw"],
            batch_shape=(cfg["channels"],), slots=cfg["slots"], device=device)

    def initial_state(self):
        return self.rx

    @staticmethod
    def step(state, x):
        syms, soft, mask, state = state.step_masked(x)
        return (syms, soft, mask), state

    @staticmethod
    def view(state) -> dict:
        """Every quantity the stream carries, by the reference's names."""
        a, s, e = state.agc, state.symsync, state.eq
        return {
            "agc_g": a.g, "agc_y2p": a.y2_prime, "agc_mode": a.squelch_mode,
            "agc_timer": a.squelch_timer,
            "ss_window": s.window, "ss_b": s.b, "ss_bf": s.bf, "ss_tau": s.tau,
            "ss_tau_d": s.tau_decim, "ss_rate": s.rate, "ss_delta": s.delta,
            "ss_dec": s.decim_counter, "ss_v0": s.pll_v[..., 0], "ss_v1": s.pll_v[..., 1],
            "eq_w": e.w, "eq_buffer": e.buffer, "eq_x2": e.x2, "eq_x2_sum": e.x2_sum,
            "eq_count": e.count, "theta": state.theta, "dtheta": state.dtheta,
            "sym_phase": state.sym_phase, "evm_accum": state.evm_accum,
            "evm_count": state.evm_count, "overflow": state.overflow_count,
        }
