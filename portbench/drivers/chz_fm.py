"""``ChannelizerFmRx.step`` on planar float32 blocks [2, N] (N = 64·T wideband
samples): one K2 launch (``csrc/channelizer.cu``), the FM discriminator's
torch ops on K2's step-major planes and the state's copies. The outputs are
``(yr, yi, fm)``, each [T, 64]."""

from __future__ import annotations

from yagi_tpu_torch.chains import ChannelizerFmRx


class Driver:
    def __init__(self, cfg: dict, wl: dict, device):
        self.rx = ChannelizerFmRx.create(num_channels=cfg["channels"], m=cfg["m"],
                                         as_=cfg["as"], kf=cfg["kf"], device=device)

    def initial_state(self):
        return self.rx

    @staticmethod
    def step(state, x):
        yr, yi, fm, state = state.step(x[0], x[1])
        return (yr, yi, fm), state

    @staticmethod
    def view(state) -> dict:
        """Every quantity the stream carries, by the reference's names."""
        return {"hist_r": state.chz.hist_r, "hist_i": state.chz.hist_i,
                "r_prime": state.r_prime}
