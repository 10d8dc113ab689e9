"""Plain reference of the resampler → symbol synchronizer farm
(``symsync1024``): liquid's ``msresamp_crcf`` at a rate in [0.5, 1) (no
halfband stage: its one arbitrary stage, ``resamp_crcf``) and then
``symsync_crcf`` at k_out = 1, per block.

**Resampler**, as yagi writes ``resamp_crcf`` (resamp.rs:141-154): for each
input sample, the sample enters the PFB window; while the u32 phase is below
2^24, an output through branch phase >> (24 − log2 npfb) and phase += step;
then phase −= 2^24. The phase is stepped a sample at a time in Python
integers. Each output is a float64 dot of the window with its branch,
y = Σ_j h[b + j·npfb]·x[s − j]. The prototype is designed again: a Kaiser
windowed-sinc of 2·m·npfb + 1 taps, cutoff min(0.515·r, 0.49)/npfb, ``as``
dB, scaled to npfb over its sum and stored in float32 (liquid's crcf
coefficients), its last tap dropped (14 taps a branch at m 7, 256 branches);
step = round(2^24 / r).

**Synchronizer**: a frozen float32 copy of the port's plain symsync loop at
k_out = 1 with a valid count (``yagi_tpu_torch/kernels/symscan.py::_loop``,
its kernels' output form), in the port's summation order, so that on the
card it equals K3 bit for bit; the RRCOS banks and the all-branch dots are
copies of ``qam_rx.py``'s (a reference imports nothing but numpy and
torch). It is fed the program's own resampler
output and count for the block: the loop feeds its decisions back, so an
input an ulp apart parts whole channels, and the resampler's float32 sums
are held to the float64 ones by ``resamp_gap`` on their own.

A window block is followed from the program's state before it
(``drivers/symsync_rx.py::view``); the stream's start from this module's own
initial state, which the program's must equal. Compared, block by block: the
resampler's count and u32 phase (``count_errors``), its outputs (``resamp_gap``:
largest |r − r_ref| over the rms of r_ref, the capacity past the count
included, where both are 0), the synchronizer's valid masks (``slot_errors``)
and outputs (``sym_gap``, over the rms of its valid outputs), its carried
floats (``state_gap``) and the carried windows, integers and phase
(``state_errors``: elements that differ).

The control (``control=True``) stands in the program's place: the
resampler's products with their operands rounded to TF32 and summed in
float32 (a contraction with TF32 on), and the synchronizer in bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

U32 = (1 << 32) - 1
ONE = 1 << 24  # a whole input sample of the u32 phase
LANES = 4  # the synchronizer's dots: lane l sums taps j ≡ l (mod 4), then (s0+s1)+(s2+s3)
FLOAT_LEAVES = ("ss_bf", "ss_tau", "ss_tau_d", "ss_rate", "ss_delta", "ss_v0", "ss_v1")
EXACT_LEAVES = ("rs_window", "rs_phase", "rs_step", "ms_carry", "ms_carry_len", "ss_window",
                "ss_b", "ss_dec")


# ----------------------------------------------------------------- designs
def kaiser_beta(as_: float) -> float:
    """Kaiser's β for a stop-band attenuation in dB (liquid kaiser.rs:62)."""
    a = abs(as_)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a > 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def rrcos(k: int, m: int, beta: float) -> np.ndarray:
    """Root-raised-cosine prototype of 2km+1 taps (liquid rrcos.rs:15; the
    arithmetic of yagi_tpu_torch/design/fir.py:247-271)."""
    z = np.arange(2 * k * m + 1, dtype=np.float64) / k - m
    h = np.empty_like(z)
    for i, zi in enumerate(z):
        if abs(zi) < 1e-5:
            h[i] = 1.0 - beta + 4.0 * beta / np.pi
            continue
        g = (1.0 - 16.0 * beta * beta * zi * zi) ** 2
        if abs(g) < 1e-5:
            g1, g2 = 1.0 + 2.0 / np.pi, np.sin(0.25 * np.pi / beta)
            g3, g4 = 1.0 - 2.0 / np.pi, np.cos(0.25 * np.pi / beta)
            h[i] = beta / np.sqrt(2.0) * (g1 * g2 + g3 * g4)
        else:
            t1 = np.cos((1.0 + beta) * np.pi * zi)
            t2 = np.sin((1.0 - beta) * np.pi * zi)
            t3 = 1.0 / (4.0 * beta * zi)
            t4 = 4.0 * beta / (np.pi * (1.0 - 16.0 * beta * beta * zi * zi))
            h[i] = t4 * (t1 + t2 * t3)
    return h


def sync_taps(k: int, m: int, beta: float, npfb: int) -> np.ndarray:
    """The synchronizer's banks as one [2·npfb, L] float32 array, row i of
    the matched (i < npfb) or derivative bank reversed, g[i, j] applied to
    the window's sample t+1+j: the RRCOS prototype at k·npfb, its circular
    centred difference scaled to 0.06/max|h·dh| (liquid symsync.rs:58-76),
    each cut into npfb branches h[i + l·npfb]."""
    h = rrcos(k * npfb, m, beta)
    dh = np.empty_like(h)
    dh[0] = h[1] - h[-1]
    dh[-1] = h[0] - h[-2]
    dh[1:-1] = h[2:] - h[:-2]
    dh *= 0.06 / np.max(np.abs(h * dh))
    sub = len(h) // npfb

    def bank(v):
        v = v.astype(np.float32)
        return np.stack([v[i: i + sub * npfb: npfb] for i in range(npfb)])

    return np.ascontiguousarray(np.concatenate([bank(h), bank(dh)])[:, ::-1])


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 (or complex64) values rounded to TF32: 10 mantissa bits,
    to nearest, ties away from zero."""
    if t.is_complex():
        return torch.complex(_tf32(t.real.contiguous()), _tf32(t.imag.contiguous()))
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


# -------------------------------------------------------------- resampler
def resamp_taps(cfg: dict) -> np.ndarray:
    """The PFB's branches [npfb, L] (float32 values in float64), branch i's
    tap j = h[i + j·npfb], applied to the sample j before the newest."""
    npfb, m, r = cfg["resamp_npfb"], cfg["resamp_m"], cfg["rate"]
    if not 0.5 <= r < 1.0:
        raise ValueError("the reference runs one decimating arbitrary stage: rate in [0.5, 1)")
    n = 2 * m * npfb + 1
    fc = min(0.515 * r, 0.49) / npfb
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    h = np.sinc(2.0 * fc * t) * np.kaiser(n, kaiser_beta(cfg["as"]))
    h = (h * (npfb / h.sum())).astype(np.float32).astype(np.float64)[: n - 1]
    return h.reshape(-1, npfb).T.copy()


def resamp_step(cfg: dict) -> int:
    return int(np.round(ONE / cfg["rate"]))


def schedule(phase: int, step: int, n: int, bits: int):
    """liquid's loop over n input samples from the u32 ``phase``: the source
    sample and branch of each output, and the phase after."""
    src, branch = [], []
    for i in range(n):
        while phase < ONE:
            src.append(i)
            branch.append(phase >> (24 - bits))
            phase += step
        phase -= ONE
    return np.array(src, dtype=np.int64), np.array(branch, dtype=np.int64), phase & U32


def resample(x, window, phase: int, cfg: dict, control: bool = False):
    """One block x [C, n] after the PFB window [C, L] from the u32 phase:
    (r [C, M], M, the phase after, the window after). float64 (complex128)
    outputs; the control's in float32 from TF32 operands."""
    h = resamp_taps(cfg)
    npfb, L = h.shape
    src, branch, new_phase = schedule(phase, resamp_step(cfg), x.shape[1], npfb.bit_length() - 1)
    dev = x.device
    xe = torch.cat([window, x], dim=1)  # x[i] at L + i
    if control:
        xe, taps = _tf32(xe.to(torch.complex64)), _tf32(torch.from_numpy(h).float().to(dev))
    else:
        xe, taps = xe.to(torch.complex128), torch.from_numpy(h).to(dev)
    s = torch.from_numpy(src).to(dev) + L
    b = torch.from_numpy(branch).to(dev)
    r = torch.zeros((x.shape[0], len(src)), dtype=xe.dtype, device=dev)
    for j in range(L):
        r += taps[b, j] * xe[:, s - j]
    return r, len(src), new_phase, torch.cat([window, x], 1)[:, -L:]


# ----------------------------------------------------------- synchronizer
def branch_outputs(xr, xi, g):
    """Every branch's matched and derivative outputs [C, n, 4P], groups
    [re·mf | re·dmf | im·mf | im·dmf], from the window-prefixed planes
    [C, n + L] (yagi_tpu_torch/kernels/symscan.py:135-164)."""
    L = g.shape[1]
    n = xr.shape[-1] - L
    planes = []
    for plane in (xr[..., 1:], xi[..., 1:]):
        lanes = []
        for lane in range(LANES):
            acc = None
            for j in range(lane, L, LANES):
                term = plane[..., j: j + n, None] * g[:, j]
                acc = term if acc is None else acc + term
            lanes.append(acc)
        while len(lanes) > 1:
            lanes = [lanes[i] + lanes[i + 1] for i in range(0, len(lanes), 2)]
        planes.append(lanes[0])
    return torch.cat(planes, dim=-1)


def sync_constants(cfg: dict, device) -> dict:
    """The synchronizer's fixed quantities, as ``Symsync.create_rnyquist``
    and ``set_lf_bw`` set them (symsync.rs:196-213)."""
    lf_bw = cfg["lf_bw"]
    a0 = 1.0 - 0.5 * (1.0 - lf_bw)
    f32 = np.float32
    return {
        "g": torch.from_numpy(sync_taps(cfg["k"], cfg["m"], cfg["beta"], cfg["npfb"])).to(device),
        "P": cfg["npfb"], "k": cfg["k"], "E": 2,
        "pll_a1": f32(-0.495 * (1.0 - lf_bw) / a0), "pll_b0": f32(0.22 * lf_bw / a0),
        "radj": f32(0.5 * lf_bw),
    }


def initial_state(cfg: dict, c: int, device) -> dict:
    """The state ``ResampSymsyncRx.create`` starts from, by ``view``'s names."""
    f32, i32 = torch.float32, torch.int32
    L = 2 * cfg["m"] * cfg["k"]  # taps a synchronizer branch: (2·k·npfb·m + 1 − 1) / npfb

    def full(v, dt=f32, shape=(c,)):
        return torch.full(shape, v, dtype=dt, device=device)

    return {
        "rs_window": torch.zeros((c, 2 * cfg["resamp_m"]), dtype=torch.complex64, device=device),
        "rs_phase": torch.zeros((), dtype=torch.int64, device=device),
        "rs_step": torch.tensor(resamp_step(cfg), dtype=torch.int64, device=device),
        "ms_carry": torch.zeros((c, 1), dtype=torch.complex64, device=device),
        "ms_carry_len": torch.zeros((), dtype=torch.int64, device=device),
        "ss_window": torch.zeros((c, L), dtype=torch.complex64, device=device),
        "ss_b": full(0, i32), "ss_bf": full(0.0), "ss_tau": full(0.0), "ss_tau_d": full(0.0),
        "ss_rate": full(float(cfg["k"])), "ss_delta": full(float(cfg["k"])),
        "ss_dec": full(0, i32), "ss_v0": full(0.0), "ss_v1": full(0.0),
    }


def sync_loop(xs4, n_valid: int, st: dict, const: dict, dt):
    """The timing loop over the block's samples, E slots each, the first
    ``n_valid`` samples valid (yagi_tpu_torch/kernels/symscan.py::_loop at
    k_out = 1 in its kernels' output form, never locked)."""
    dev = xs4.device
    P, E, k = const["P"], const["E"], const["k"]
    c, n = xs4.shape[:2]
    b, bf, tau, tau_d = st["ss_b"].to(dt), st["ss_bf"].to(dt), st["ss_tau"].to(dt), \
        st["ss_tau_d"].to(dt)
    rate, delta, dec = st["ss_rate"].to(dt), st["ss_delta"].to(dt), st["ss_dec"].to(dt)
    pv0, pv1 = st["ss_v0"].to(dt), st["ss_v1"].to(dt)
    pa1 = torch.tensor(float(const["pll_a1"]), dtype=dt, device=dev)
    pb0 = torch.tensor(float(const["pll_b0"]), dtype=dt, device=dev)
    radj = torch.full((c,), float(const["radj"]), dtype=dt, device=dev)
    notlocked = torch.ones(c, dtype=torch.bool, device=dev)
    kinv = torch.tensor(1.0 / k, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    offs = torch.arange(4, device=dev) * P
    vflags = torch.arange(n, device=dev) < n_valid
    yr_all, yi_all, act_all = [], [], []
    for t in range(n):
        vs = vflags[t]
        for _ in range(E):
            active = (b < P) & vs
            mr, dr, mi, di = xs4[:, t].gather(1, b.clamp(0, P - 1).long()[:, None] + offs).unbind(1)
            do_t = (dec == 1.0) & active & notlocked
            q = (mr * dr + mi * di).clamp(-1.0, 1.0)
            v0 = q - pa1 * pv0
            q_hat = pb0 * v0
            rate_new = rate + radj * q_hat
            delta_new = rate_new + q_hat

            pv1 = torch.where(do_t, pv0, pv1)
            pv0 = torch.where(do_t, v0, pv0)
            rate = torch.where(do_t, rate_new, rate)
            delta = torch.where(do_t, delta_new, delta)
            tau_d = torch.where(do_t, tau, tau_d)

            dec = torch.where(active, 1.0, dec)
            tau = torch.where(active, tau + delta, tau)
            bf = torch.where(active, tau * P, bf)
            b = torch.where(active, torch.round(bf), b)
            yr_all.append(torch.where(active, mr * kinv, zero))
            yi_all.append(torch.where(active, mi * kinv, zero))
            act_all.append(active)
        vsf = vs.to(dt)
        tau = tau - vsf
        bf = bf - vsf * P
        b = b - vsf * P
    y = torch.complex(torch.stack(yr_all, -1).float(), torch.stack(yi_all, -1).float())
    valid = torch.stack(act_all, -1)
    out = {"ss_b": b.to(torch.int32), "ss_bf": bf, "ss_tau": tau, "ss_tau_d": tau_d,
           "ss_rate": rate, "ss_delta": delta, "ss_dec": dec.to(torch.int32), "ss_v0": pv0,
           "ss_v1": pv1}
    return y.reshape(c, n, E), valid.reshape(c, n, E), out


def sync_block(r, n_valid: int, st: dict, const: dict, dt=torch.float32):
    """The synchronizer over one resampled block r [C, cap] of which the
    first ``n_valid`` samples are valid: (y, valid, state)."""
    win = st["ss_window"]
    L = win.shape[1]
    xa = torch.cat([win, r.to(torch.complex64)], -1)
    xs4 = branch_outputs(xa.real.to(dt), xa.imag.to(dt), const["g"].to(dt))
    y, valid, new = sync_loop(xs4, n_valid, st, const, dt)
    del xs4
    new["ss_window"] = xa[:, n_valid + torch.arange(L, device=xa.device)]
    return y, valid, new


# ------------------------------------------------------------------ check
def compare_state(got: dict, want: dict) -> dict:
    """The largest gap of a carried float, over the larger of its own largest
    magnitude and the median leaf's, and the carried windows, integers and
    phase that differ."""
    scale = {k: want[k].abs().max().item() for k in FLOAT_LEAVES}
    floor = float(np.median(list(scale.values())))
    gap = max((got[k].to(want[k].dtype) - want[k]).abs().max().item()
              / max(scale[k], floor, 1e-30) for k in FLOAT_LEAVES)
    errors = sum(int((got[k] != want[k].to(got[k].device)).sum().item()) for k in EXACT_LEAVES)
    return {"state_gap": gap, "state_errors": errors}


def block_row(x, before: dict, out, after: dict | None, cfg: dict, const: dict,
              control: bool = False) -> tuple[dict, int]:
    """The numbers compared for one block x [C, n] from the state ``before``:
    the program's outputs ``out`` = (y, valid, r, count) and state ``after``,
    or the control in their place. Returns (row, emitted slots)."""
    dev = x.device
    phase = int(before["rs_phase"].item())
    r_ref, count_ref, phase_ref, win_ref = resample(x, before["rs_window"], phase, cfg)
    cap = out[2].shape[1]  # the program's output capacity
    if control:
        r, count, phase_got, _ = resample(x, before["rs_window"], phase, cfg, control=True)
        r = torch.nn.functional.pad(r.to(torch.complex64), (0, cap - count))
        y, valid, ss = sync_block(r, count, before, const, torch.bfloat16)
        after = {**before, **ss, "rs_window": win_ref,
                 "rs_phase": torch.tensor(phase_got, device=dev)}
    else:
        y, valid, r, count = out
        count = int(count.item())
        phase_got = int(after["rs_phase"].item())
    # the synchronizer from the same state on the same resampled samples
    y_ref, valid_ref, ss_ref = sync_block(r, count, before, const)
    want = {**before, **ss_ref, "rs_window": win_ref,
            "rs_phase": torch.tensor(phase_ref, device=dev),
            "rs_step": torch.tensor(resamp_step(cfg), device=dev),
            "ms_carry": torch.zeros_like(before["ms_carry"]),  # no halfband stage: no carry
            "ms_carry_len": torch.zeros((), dtype=torch.int64, device=dev)}
    r_pad = torch.zeros((x.shape[0], max(cap, count_ref)), dtype=r_ref.dtype, device=dev)
    r_pad[:, :count_ref] = r_ref
    rms = r_ref.abs().square().mean().sqrt()
    gap = ((r.to(r_pad.dtype) - r_pad[:, :cap]).abs().max() / rms).item()
    y_rms = y_ref[valid_ref].to(torch.complex128).abs().square().mean().sqrt()
    row = {
        "count_errors": abs(count - count_ref) + int(phase_got != phase_ref),
        "resamp_gap": gap if cap >= count_ref else float("inf"),
        "slot_errors": int((valid != valid_ref).sum().item()),
        "sym_gap": ((y.to(torch.complex128) - y_ref.to(torch.complex128)).abs().max()
                    / y_rms).item(),
        **compare_state(after, want),
    }
    return row, int(valid_ref.sum().item())


def check(cfg, wl, blocks, start, kept, device, control: bool = False):
    const = sync_constants(cfg, device)
    c = blocks.shape[1]
    init = initial_state(cfg, c, device)
    per_block, emitted = [], []
    for item in [start] + list(kept):
        x = blocks[item.index % len(blocks)]
        # the stream's start runs from this module's own initial state
        before = init if item.index == 0 else item.before
        row, n_emit = block_row(x, before, item.out, item.after, cfg, const, control)
        if item.index == 0 and not control:  # the program's initial state is the reference's
            first = compare_state(item.before, init)
            row["state_errors"] += first["state_errors"]
            row["state_gap"] = max(row["state_gap"], first["state_gap"])
        per_block.append(row)
        emitted.append(n_emit)
    return per_block, {"compared_blocks": len(per_block),
                       "emitted_per_block": sum(emitted) / len(emitted)}
