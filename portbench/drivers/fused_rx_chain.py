"""``FusedRxChain.step`` on complex64 blocks [C, T]: one K1 launch
(``csrc/chain.cu``, its complex64 instance) and the state's advance."""

from __future__ import annotations

from yagi_tpu_torch.chains import FusedRxChain


class Driver:
    def __init__(self, cfg: dict, wl: dict, device):
        self.chain = FusedRxChain.create(
            n_taps=cfg["n_taps"], fc=cfg["fc"], as_=cfg["as"], rate=cfg["rate"],
            mix_freq=cfg["mix_freq"], m=cfg["m"], npfb=cfg["npfb"],
            batch_shape=(cfg["channels"],), device=device)

    def initial_state(self):
        return self.chain

    @staticmethod
    def step(state, x):
        y, _, state = state.step(x)
        return y, state

    @staticmethod
    def view(state) -> dict:
        return {"hist_r": state.hist_r, "hist_i": state.hist_i, "theta": state.theta,
                "d_theta": state.d_theta}
