// The symbol synchronizer's timing loop for one channel, shared by the two
// symsync scan kernels in symscan.cu (symsync.rs:230-266; yagi_tpu's
// kernels/symscan.py::_kernel body, symscan.py:93-140, op for op).
//
// Per input sample the loop runs E emission slots. A slot reads the matched
// filter (mf) and derivative (dmf) outputs of branch bb = clip(b, 0, P−1) for
// both planes, forms the timing error q = clip(mr·dr + mi·di, −1, 1), runs the
// first-order loop filter and steps τ, and emits mr/k, mi/k while b < P and
// the sample is valid. The end of a valid sample wraps τ, bf and b.
//
// Every operation is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn:
// nvcc never contracts those into an FMA), as torch rounds each op of the
// plain versions, and b = rintf(bf) rounds half to even like torch.round and
// jnp.round (roundf would round half away from zero). So fed the same mf/dmf
// values, a kernel takes every decision its plain version takes, and its
// values and state are bit-identical. The loop's feedback makes that the
// only safe footing: one rounding difference can move an emission.
//
// State is f32, b and dec included (exact for their small integer range), as
// rows (b, bf, τ, τ_decim, rate, δ, dec, v0, v1) of a [9, C] array. Beside
// it, each kernel counts the samples after whose E slots an emission was
// still due (sym_pending) into an int32 per channel.

#pragma once

namespace yagi {

struct SymState {
  float b, bf, tau, tau_d, rate, delta, dec, pv0, pv1;
};

struct SymParams {
  float pa1, pb0, radj, kinv;  // pll_a[1], pll_b[0], rate adjustment, 1/k
  bool notlocked;
  int P, k_out;
};

__device__ __forceinline__ SymState sym_load(const float* st, int C, int c) {
  return SymState{st[0 * C + c], st[1 * C + c], st[2 * C + c], st[3 * C + c], st[4 * C + c],
                  st[5 * C + c], st[6 * C + c], st[7 * C + c], st[8 * C + c]};
}

__device__ __forceinline__ void sym_store(float* st, int C, int c, const SymState& s) {
  st[0 * C + c] = s.b;
  st[1 * C + c] = s.bf;
  st[2 * C + c] = s.tau;
  st[3 * C + c] = s.tau_d;
  st[4 * C + c] = s.rate;
  st[5 * C + c] = s.delta;
  st[6 * C + c] = s.dec;
  st[7 * C + c] = s.pv0;
  st[8 * C + c] = s.pv1;
}

// The branch the next slot reads.
__device__ __forceinline__ int sym_branch(const SymState& s, int P) {
  return (int)fminf(fmaxf(s.b, 0.0f), (float)(P - 1));
}

// One emission slot given branch bb's outputs; returns whether it emitted.
__device__ __forceinline__ bool sym_emit(SymState& s, const SymParams& p, bool vs, float mr,
                                         float dr, float mi, float di, float& yr, float& yi) {
  const bool active = s.b < (float)p.P && vs;
  bool do_t;
  if (p.k_out == 1) {
    do_t = s.dec == 1.0f && active && p.notlocked;
  } else {
    const bool due = s.dec == (float)p.k_out && active;
    do_t = due && p.notlocked;
    if (due) s.dec = 0.0f;
  }
  const float e = __fadd_rn(__fmul_rn(mr, dr), __fmul_rn(mi, di));
  const float q = fminf(fmaxf(e, -1.0f), 1.0f);
  const float v0 = __fsub_rn(q, __fmul_rn(p.pa1, s.pv0));
  const float q_hat = __fmul_rn(p.pb0, v0);
  const float rate_new = __fadd_rn(s.rate, __fmul_rn(p.radj, q_hat));
  const float delta_new = __fadd_rn(rate_new, q_hat);
  if (do_t) {
    s.pv1 = s.pv0;
    s.pv0 = v0;
    s.rate = rate_new;
    s.delta = delta_new;
    s.tau_d = s.tau;
  }
  if (active) {
    s.dec = p.k_out == 1 ? 1.0f : __fadd_rn(s.dec, 1.0f);
    s.tau = __fadd_rn(s.tau, s.delta);
    s.bf = __fmul_rn(s.tau, (float)p.P);
    s.b = rintf(s.bf);
  }
  const float af = active ? 1.0f : 0.0f;
  yr = __fmul_rn(__fmul_rn(af, mr), p.kinv);
  yi = __fmul_rn(__fmul_rn(af, mi), p.kinv);
  return active;
}

// After a sample's E slots, before the wrap: an emission is still due (b < P)
// on a valid sample. The bounded slots defer it to the next sample; the
// kernels count such samples per channel (yagi_tpu's `pending`,
// filter/symsync.py::_emit_sample).
__device__ __forceinline__ bool sym_pending(const SymState& s, int P, bool vs) {
  return vs && s.b < (float)P;
}

// End of an input sample: a valid one wraps τ, bf and b by one sample.
__device__ __forceinline__ void sym_wrap(SymState& s, int P, bool vs) {
  const float vsf = vs ? 1.0f : 0.0f;
  const float vsp = __fmul_rn(vsf, (float)P);
  s.tau = __fsub_rn(s.tau, vsf);
  s.bf = __fsub_rn(s.bf, vsp);
  s.b = __fsub_rn(s.b, vsp);
}

}  // namespace yagi
