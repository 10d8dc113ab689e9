"""Plain reference of the 16-QAM receiver (``qamrx2048``): liquid's
symtrack composition as ``QamRx.step_masked`` runs it, per block: the AGC
over the samples, the polyphase RRCOS symbol synchronizer emitting up to
E = 2 slots a sample at 2 samples a symbol out, then the decision-directed
LMS equalizer and carrier PLL over the slots in stream order.

The loops are frozen copies of the port's plain versions, op for op and in
their summation order (each source line is named at its copy), in float32 on
the device, so that on the card they equal the program's loop kernels bit for
bit. The designs and tables are worked out again here: the RRCOS prototype
and its derivative bank, the constellation, the loop constants.

The loops carry the whole stream's history, so a window block can only be
followed from the program's own state before it (``drivers/qam_rx.py::view``);
the stream's start is checked by itself, from this module's own initial
state over the first ``start_samples`` samples of block 0. Compared, block
by block: the decided symbols (after compaction, so a deferred emission does
not shift them; a count that differs counts each missing decision), the
soft outputs at the decisions, and every quantity the stream carries.

The control (``control=True``) runs the same loops in bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

LANES = 4  # the synchronizer's dots: lane l sums taps j ≡ l (mod 4), then (s0+s1)+(s2+s3)
# next squelch mode [mode, threshold exceeded] (yagi_tpu_torch/kernels/agc.py:31-43)
_NEXT_MODE = ((0, 0), (1, 2), (4, 3), (4, 3), (5, 3), (5, 3), (1, 1), (0, 0))
_SIGNAL_LO, _FALL, _TIMEOUT = 5, 4, 6
FLOAT_LEAVES = ("agc_g", "agc_y2p", "ss_window", "ss_bf", "ss_tau", "ss_tau_d", "ss_rate",
                "ss_delta", "ss_v0", "ss_v1", "eq_w", "eq_buffer", "eq_x2", "eq_x2_sum",
                "theta", "dtheta", "evm_accum", "evm_count")
INT_LEAVES = ("agc_mode", "agc_timer", "ss_b", "ss_dec", "eq_count", "sym_phase", "overflow")


# ----------------------------------------------------------------- designs
def rrcos(k: int, m: int, beta: float) -> np.ndarray:
    """Root-raised-cosine prototype of 2km+1 taps (liquid rrcos.rs:15; the
    arithmetic of yagi_tpu_torch/design/fir.py:247-271)."""
    n = np.arange(2 * k * m + 1, dtype=np.float64)
    z = n / k - m
    h = np.empty_like(z)
    for i, zi in enumerate(z):
        if abs(zi) < 1e-5:
            h[i] = 1.0 - beta + 4.0 * beta / np.pi
        else:
            g = (1.0 - 16.0 * beta * beta * zi * zi) ** 2
            if abs(g) < 1e-5:
                g1 = 1.0 + 2.0 / np.pi
                g2 = np.sin(0.25 * np.pi / beta)
                g3 = 1.0 - 2.0 / np.pi
                g4 = np.cos(0.25 * np.pi / beta)
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


def constellation(scheme: str, device) -> torch.Tensor:
    """A square QAM table, liquid's gray coding and unit mean energy
    (yagi_tpu_torch/modem/modem.py:155-165)."""
    if not scheme.startswith("qam"):
        raise ValueError(f"no reference table for {scheme!r}")
    M = int(scheme[3:])
    bps = int(np.log2(M))
    alpha = 1.0 / np.sqrt(2.0 * (M - 1) / 3.0)
    m_i = (bps + 1) // 2 if bps % 2 else bps // 2
    m_q = bps - m_i
    Mi, Mq = 1 << m_i, 1 << m_q

    def gray_decode(g):
        b = g
        for shift in range(1, 32):
            b = b ^ (g >> shift)
        return b

    syms = np.arange(M)
    s_i, s_q = gray_decode(syms >> m_q), gray_decode(syms & (Mq - 1))
    table = ((2 * s_i - Mi + 1) * alpha + 1j * (2 * s_q - Mq + 1) * alpha).astype(np.complex64)
    return torch.from_numpy(table).to(device)


def constants(cfg: dict, device) -> dict:
    """The receiver's fixed quantities, as ``QamRx.create`` sets them."""
    lf_bw = cfg["lf_bw"]  # Symsync.set_lf_bw (symsync.rs:196-213)
    a0 = 1.0 - 0.5 * (1.0 - lf_bw)
    f32 = np.float32
    return {
        "g": torch.from_numpy(sync_taps(cfg["k"], cfg["m"], cfg["beta"], cfg["npfb"])).to(device),
        "P": cfg["npfb"], "k": cfg["k"], "k_out": 2, "E": cfg["slots"], "h_len": cfg["eq_len"],
        "table": constellation(cfg["scheme"], device),
        "agc_alpha": f32(cfg["agc_bw"]), "agc_scale": f32(1.0), "agc_thr": f32(0.0),
        "timeout": 100,
        "pll_a1": f32(-0.495 * (1.0 - lf_bw) / a0), "pll_b0": f32(0.22 * lf_bw / a0),
        "radj": f32(0.5 * lf_bw),
        "mu": f32(cfg["eq_bw"]), "alpha": f32(cfg["pll_bw"]),
        "beta": f32(0.5 * cfg["pll_bw"] * cfg["pll_bw"]),
    }


def initial_state(const: dict, c: int, device) -> dict:
    """The state ``QamRx.create`` starts from, by ``view``'s names."""
    f32, i32 = torch.float32, torch.int32
    h_len = const["h_len"]
    L = const["g"].shape[1]

    def full(v, dt=f32, shape=(c,)):
        return torch.full(shape, v, dtype=dt, device=device)

    w = torch.zeros((c, h_len), dtype=torch.complex64, device=device)
    w[:, h_len // 2] = 1.0
    return {
        "agc_g": full(1.0), "agc_y2p": full(1.0), "agc_mode": full(0, i32),
        "agc_timer": full(100, i32),
        "ss_window": torch.zeros((c, L), dtype=torch.complex64, device=device),
        "ss_b": full(0, i32), "ss_bf": full(0.0), "ss_tau": full(0.0), "ss_tau_d": full(0.0),
        "ss_rate": full(const["k"] / const["k_out"]), "ss_delta": full(const["k"] / const["k_out"]),
        "ss_dec": full(0, i32), "ss_v0": full(0.0), "ss_v1": full(0.0),
        "eq_w": w, "eq_buffer": torch.zeros_like(w), "eq_x2": full(0.0, shape=(c, h_len)),
        "eq_x2_sum": full(0.0), "eq_count": full(0, i32), "theta": full(0.0),
        "dtheta": full(0.0), "sym_phase": full((-((h_len - 1) // 2)) % 2, i32),
        "evm_accum": full(0.0), "evm_count": full(0.0), "overflow": full(0, i32),
    }


# ------------------------------------------------------------------- loops
def agc_loop(xr, xi, st: dict, const: dict, dt):
    """The AGC over the block (yagi_tpu_torch/kernels/agc.py:61-87, with
    ``squelch_step`` :46-58; never locked, as QamRx runs it)."""
    dev = xr.device
    g, y2p, mode, timer = st["agc_g"].to(dt), st["agc_y2p"].to(dt), st["agc_mode"], st["agc_timer"]
    alpha = torch.full_like(g, float(const["agc_alpha"]))
    scale = torch.full_like(g, float(const["agc_scale"]))
    thr = torch.full_like(g, float(const["agc_thr"]))
    locked = torch.zeros(g.shape, dtype=torch.bool, device=dev)
    one_m_alpha = 1.0 - alpha
    neg_half_alpha = -0.5 * alpha
    s = torch.where(locked, 1.0, scale)
    table = torch.tensor(_NEXT_MODE, dtype=torch.int32, device=dev).flatten()
    timeout = const["timeout"]
    yr_all, yi_all = [], []
    for t in range(xr.shape[1]):
        yr = xr[:, t] * g
        yi = xi[:, t] * g
        y2 = yr * yr + yi * yi
        y2p = one_m_alpha * y2p + alpha * y2
        g_upd = g * torch.exp(neg_half_alpha * torch.log(torch.clamp(y2p, min=1e-30)))
        g_upd = torch.clamp(torch.where(y2p > 1e-6, g_upd, g), max=1e6)
        g = torch.where(locked, g, g_upd)
        te = -20.0 * torch.log10(g) > thr
        lo_t = timer - 1
        mode_new = table[mode.clamp(0, 7).long() * 2 + te.long()]
        mode_new = torch.where((mode == _SIGNAL_LO) & (lo_t == 0), _TIMEOUT, mode_new)
        timer_new = torch.where(mode == _FALL, timeout,
                                torch.where(mode == _SIGNAL_LO, lo_t, timer))
        mode = torch.where(locked, mode, mode_new)
        timer = torch.where(locked, timer, timer_new)
        yr_all.append(yr * s)
        yi_all.append(yi * s)
    out = {"agc_g": g, "agc_y2p": y2p, "agc_mode": mode, "agc_timer": timer}
    return torch.stack(yr_all, -1), torch.stack(yi_all, -1), out


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


def sync_loop(xs4, st: dict, const: dict, dt):
    """The timing loop over the block's samples, E slots each
    (yagi_tpu_torch/kernels/symscan.py:167-226 at k_out = 2 in its kernels'
    output form, all samples valid, never locked)."""
    dev = xs4.device
    P, E, k, k_out = const["P"], const["E"], const["k"], const["k_out"]
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
    deferred = torch.zeros(c, dtype=torch.int32, device=dev)
    yr_all, yi_all, act_all = [], [], []
    for t in range(n):
        for _ in range(E):
            active = b < P
            mr, dr, mi, di = xs4[:, t].gather(1, b.clamp(0, P - 1).long()[:, None] + offs).unbind(1)
            due = (dec == float(k_out)) & active
            do_t = due & notlocked
            dec = torch.where(due, zero, dec)
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

            dec = torch.where(active, dec + 1.0, dec)
            tau = torch.where(active, tau + delta, tau)
            bf = torch.where(active, tau * P, bf)
            b = torch.where(active, torch.round(bf), b)
            af = active.to(dt)
            yr_all.append(af * mr * kinv)
            yi_all.append(af * mi * kinv)
            act_all.append(active)
        deferred = deferred + (b < P).to(torch.int32)
        tau = tau - 1.0
        bf = bf - P
        b = b - P
    y_r = torch.stack(yr_all, -1).reshape(c, n * E)
    y_i = torch.stack(yi_all, -1).reshape(c, n * E)
    valid = torch.stack(act_all, -1).reshape(c, n * E)
    out = {"ss_b": b.to(torch.int32), "ss_bf": bf, "ss_tau": tau, "ss_tau_d": tau_d,
           "ss_rate": rate, "ss_delta": delta, "ss_dec": dec.to(torch.int32), "ss_v0": pv0,
           "ss_v1": pv1}
    return y_r, y_i, valid, deferred, out


def eq_loop(y_r, y_i, valid, st: dict, const: dict, dt):
    """The equalizer and carrier loop over the slots in stream order
    (yagi_tpu_torch/kernels/qam.py:72-146; ``_dot`` :65-70)."""
    h_len, k_eq = const["h_len"], 2
    c = y_r.shape[0]
    br, bi = st["eq_buffer"].real.to(dt), st["eq_buffer"].imag.to(dt)
    wr, wi = st["eq_w"].real.to(dt), st["eq_w"].imag.to(dt)
    x2t, x2s, cnt = st["eq_x2"].to(dt), st["eq_x2_sum"].to(dt), st["eq_count"]
    theta, dtheta, sph = st["theta"].to(dt), st["dtheta"].to(dt), st["sym_phase"]
    eacc, ecnt = st["evm_accum"].to(dt), st["evm_count"].to(dt)
    tr, ti = const["table"].real.to(dt), const["table"].imag.to(dt)
    mu = torch.full((c,), float(const["mu"]), dtype=dt, device=y_r.device)
    alpha = torch.full((c,), float(const["alpha"]), dtype=dt, device=y_r.device)
    beta = torch.full((c,), float(const["beta"]), dtype=dt, device=y_r.device)

    def dot(a):
        acc = a[:, 0]
        for j in range(1, a.shape[1]):
            acc = acc + a[:, j]
        return acc

    syms, soft_r, soft_i, mask = [], [], [], []
    for s in range(y_r.shape[1]):
        xr, xi, vi = y_r[:, s], y_i[:, s], valid[:, s]
        x2n = xr * xr + xi * xi
        br_p = torch.cat([br[:, 1:], xr[:, None]], 1)
        bi_p = torch.cat([bi[:, 1:], xi[:, None]], 1)
        x2_p = torch.cat([x2t[:, 1:], x2n[:, None]], 1)
        x2s_p = x2s + x2n - x2t[:, 0]
        cnt_p = cnt + 1
        yr = dot(wr * br_p + wi * bi_p)
        yi = dot(wr * bi_p - wi * br_p)
        is_sym = vi & (sph == 0)
        can_adapt = is_sym & (x2s_p > 0.5 * h_len)
        co, sn = torch.cos(theta), torch.sin(theta)
        vs_r = yr * co + yi * sn
        vs_i = yi * co - yr * sn
        dr = vs_r[:, None] - tr
        di = vs_i[:, None] - ti
        sym = torch.argmin(dr * dr + di * di, dim=1)
        sr, si = tr[sym], ti[sym]
        pe = (vs_i * sr - vs_r * si) / torch.clamp(sr * sr + si * si, min=1e-12)
        theta_n = theta + dtheta + alpha * pe
        dtheta_n = dtheta + beta * pe
        ar = (sr * co - si * sn) - yr
        ai = (si * co + sr * sn) - yi
        g = (mu / torch.clamp(x2s_p, min=1e-20))[:, None]
        wr_u = wr + g * (ar[:, None] * br_p + ai[:, None] * bi_p)
        wi_u = wi + g * (ar[:, None] * bi_p - ai[:, None] * br_p)
        adapt = (can_adapt & (cnt_p >= h_len))[:, None]
        vt = vi[:, None]
        br, bi, x2t = torch.where(vt, br_p, br), torch.where(vt, bi_p, bi), torch.where(vt, x2_p, x2t)
        x2s, cnt = torch.where(vi, x2s_p, x2s), torch.where(vi, cnt_p, cnt)
        wr, wi = torch.where(adapt, wr_u, wr), torch.where(adapt, wi_u, wi)
        theta = torch.where(can_adapt, theta_n, theta)
        dtheta = torch.where(can_adapt, dtheta_n, dtheta)
        sph = torch.where(vi, sph ^ 1 if k_eq == 2 else (sph + 1) % k_eq, sph)
        er, ei = vs_r - sr, vs_i - si
        eacc = torch.where(can_adapt, eacc + (er * er + ei * ei), eacc)
        ecnt = torch.where(can_adapt, ecnt + 1.0, ecnt)
        syms.append(sym)
        soft_r.append(vs_r)
        soft_i.append(vs_i)
        mask.append(is_sym)

    def cplx(re, im):
        return torch.complex(re.float(), im.float())

    out = {"eq_w": cplx(wr, wi), "eq_buffer": cplx(br, bi), "eq_x2": x2t, "eq_x2_sum": x2s,
           "eq_count": cnt, "theta": theta, "dtheta": dtheta, "sym_phase": sph,
           "evm_accum": eacc, "evm_count": ecnt}
    soft = cplx(torch.stack(soft_r, 1), torch.stack(soft_i, 1))
    return torch.stack(syms, 1), soft, torch.stack(mask, 1), out


def rx_block(x: torch.Tensor, st: dict, const: dict, dt=torch.float32):
    """One block x [C, n] from the state ``st``: ((syms, soft, mask), state)
    as ``QamRx.step_masked`` returns them (yagi_tpu_torch/chains/qam.py:177-202)."""
    n = x.shape[1]
    yr, yi, agc = agc_loop(x.real.to(dt), x.imag.to(dt), st, const, dt)
    win = st["ss_window"]
    xa_r = torch.cat([win.real.to(dt), yr], -1)
    xa_i = torch.cat([win.imag.to(dt), yi], -1)
    new_window = torch.complex(xa_r[:, n:].float(), xa_i[:, n:].float())
    xs4 = branch_outputs(xa_r, xa_i, const["g"].to(dt))
    y_r, y_i, valid, deferred, ss = sync_loop(xs4, st, const, dt)
    del xs4
    syms, soft, mask, eq = eq_loop(y_r, y_i, valid, st, const, dt)
    new = {**agc, **ss, **eq, "ss_window": new_window,
           "overflow": st["overflow"] + deferred}
    return (syms, soft, mask), new, int(valid.sum().item())


# ------------------------------------------------------------------- check
def _compact(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
    return v.gather(1, order)


def compare_outputs(got, want, table_rms: float) -> dict:
    """Decided symbols that differ (a count that differs counts each missing
    one) and the largest gap of the soft outputs at common decisions, over
    the table's rms."""
    (gs, gf, gm), (ws, wf, wm) = got, want
    cnt_g, cnt_w = gm.sum(1), wm.sum(1)
    common = torch.minimum(cnt_g, cnt_w)
    pos = torch.arange(gm.shape[1], device=gm.device)[None, :] < common[:, None]
    gs, ws = _compact(gs, gm), _compact(ws, wm)
    gf, wf = _compact(gf, gm), _compact(wf, wm)
    errors = ((gs != ws) & pos).sum() + (cnt_g - cnt_w).abs().sum()
    gap = torch.where(pos, (gf.to(torch.complex128) - wf.to(torch.complex128)).abs(), 0.0)
    return {"sym_errors": int(errors.item()), "soft_gap": gap.max().item() / table_rms}


def compare_state(got: dict, want: dict) -> dict:
    """The largest gap of a carried float quantity, over the larger of its
    own largest magnitude and the median leaf's, and the carried integers
    that differ."""
    scale = {k: want[k].abs().max().item() for k in FLOAT_LEAVES}
    floor = float(np.median(list(scale.values())))
    gap = max((got[k].to(want[k].dtype) - want[k]).abs().max().item()
              / max(scale[k], floor, 1e-30) for k in FLOAT_LEAVES)
    errors = sum(int((got[k] != want[k]).sum().item()) for k in INT_LEAVES)
    return {"state_gap": gap, "state_errors": errors}


def check(cfg, wl, blocks, start, kept, device, control: bool = False):
    const = constants(cfg, device)
    table_rms = const["table"].abs().square().mean().sqrt().item()
    low = torch.bfloat16
    c, t = blocks.shape[1], blocks.shape[2]
    per_block, emitted = [], []

    # the stream's start, from this module's own initial state
    n0 = min(wl["start_samples"], t)
    x0 = blocks[0][:, :n0]
    init = initial_state(const, c, device)
    want, want_st, _ = rx_block(x0, init, const)
    if control:
        got, got_st, _ = rx_block(x0, init, const, low)
    else:
        got = tuple(o[:, : n0 * const["E"]] for o in start.out)
        got_st = start.after
    row = {**compare_outputs(got, want, table_rms), "state_gap": 0.0, "state_errors": 0}
    if n0 == t:
        row.update(compare_state(got_st, want_st))
    per_block.append(row)

    # window blocks, from the program's state before each
    for item in kept:
        x = blocks[item.index % len(blocks)]
        want, want_st, n_valid = rx_block(x, item.before, const)
        emitted.append(n_valid)
        if control:
            got, got_st, _ = rx_block(x, item.before, const, low)
        else:
            got, got_st = item.out, item.after
        per_block.append({**compare_outputs(got, want, table_rms),
                          **compare_state(got_st, want_st)})
    info = {"compared_blocks": len(per_block)}
    if emitted:
        info["emitted_per_block"] = sum(emitted) / len(emitted)
    return per_block, info
