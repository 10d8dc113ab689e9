// The IIR recurrence body that both launch forms of csrc/iir.cu run.
//
// The direct-form-II step of yagi_tpu/filter/iirfilt.py:295-316, in the
// order kernels/iir.py::iir_scan_reference takes it:
//
//   TF:  s = a1·v1 + a2·v2 + … + am·vm (left to right), v0 = x − s,
//        y = b0·v0 + (b1·v1 + … + bm·vm), the state shifted, newest first;
//   SOS: per section v0 = (y − a1·v1) − a2·v2, y = (b0·v0 + b1·v1) + b2·v2.
//
// Every product and sum is __fmul_rn/__fadd_rn/__fsub_rn (never contracted
// into an FMA, as torch rounds each op), and a complex product is written out
// as (cr·vr − ci·vi, cr·vi + ci·vr): the sequential kernel equals its plain
// version bit for bit.
//
// A value is a float2 in registers; for a real signal the imaginary part is
// never computed (kCx false). kCc: complex coefficients (a complex signal).
// The register bodies take the state's size kReg as a template parameter and
// the order m at run time, each term predicated on k <= m; an instance
// specialised to one order passes m = kReg, and the predicates fold away.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace yagi_iir {

template <bool kCx, bool kCc>
struct Ops {
  static_assert(kCx || !kCc, "complex coefficients need a complex signal");
  static constexpr bool kIsCx = kCx;
  using Elem = std::conditional_t<kCx, float2, float>;  // a sample in memory

  static __device__ __forceinline__ float2 load(Elem e) {
    if constexpr (kCx) {
      return e;
    } else {
      return make_float2(e, 0.0f);
    }
  }
  static __device__ __forceinline__ Elem pack(float2 v) {
    if constexpr (kCx) {
      return v;
    } else {
      return v.x;
    }
  }
  // coefficient k of a float32 or complex64 array
  static __device__ __forceinline__ float2 coef(const float* c, int k) {
    if constexpr (kCc) {
      return make_float2(c[2 * k], c[2 * k + 1]);
    } else {
      return make_float2(c[k], 0.0f);
    }
  }
  // c·v; a real coefficient's imaginary part is not read
  static __device__ __forceinline__ float2 mul(float2 c, float2 v) {
    if constexpr (kCc) {
      return make_float2(__fsub_rn(__fmul_rn(c.x, v.x), __fmul_rn(c.y, v.y)),
                         __fadd_rn(__fmul_rn(c.x, v.y), __fmul_rn(c.y, v.x)));
    } else if constexpr (kCx) {
      return make_float2(__fmul_rn(c.x, v.x), __fmul_rn(c.x, v.y));
    } else {
      return make_float2(__fmul_rn(c.x, v.x), 0.0f);
    }
  }
  static __device__ __forceinline__ float2 add(float2 p, float2 q) {
    if constexpr (kCx) {
      return make_float2(__fadd_rn(p.x, q.x), __fadd_rn(p.y, q.y));
    } else {
      return make_float2(__fadd_rn(p.x, q.x), 0.0f);
    }
  }
  static __device__ __forceinline__ float2 sub(float2 p, float2 q) {
    if constexpr (kCx) {
      return make_float2(__fsub_rn(p.x, q.x), __fsub_rn(p.y, q.y));
    } else {
      return make_float2(__fsub_rn(p.x, q.x), 0.0f);
    }
  }
};

// The all-pole half of a TF step on a register state of up to kReg values
// (m of them live): v0 = x − (a1·v1 + … + am·vm); returns v0, the state not
// yet shifted.
template <class O, int kReg>
__device__ __forceinline__ float2 tf_feedback(float2 x, int m, const float2 (&a)[kReg + 1],
                                              const float2 (&v)[kReg]) {
  float2 s = O::mul(a[1], v[0]);
#pragma unroll
  for (int k = 2; k <= kReg; ++k)
    if (k <= m) s = O::add(s, O::mul(a[k], v[k - 1]));
  return O::sub(x, s);
}

template <int kReg>
__device__ __forceinline__ void shift_in(float2 (&v)[kReg], float2 v0) {
#pragma unroll
  for (int k = kReg - 1; k > 0; --k) v[k] = v[k - 1];
  v[0] = v0;
}

// One TF step on a register state (m ≤ kReg): returns y.
template <class O, int kReg>
__device__ __forceinline__ float2 tf_step(float2 x, int m, const float2 (&a)[kReg + 1],
                                          const float2 (&b)[kReg + 1], float2 (&v)[kReg]) {
  if (m == 0) return O::mul(b[0], x);
  const float2 v0 = tf_feedback<O, kReg>(x, m, a, v);
  float2 t = O::mul(b[1], v[0]);
#pragma unroll
  for (int k = 2; k <= kReg; ++k)
    if (k <= m) t = O::add(t, O::mul(b[k], v[k - 1]));
  shift_in<kReg>(v, v0);
  return O::add(O::mul(b[0], v0), t);
}

// The all-pole step alone (the chunked form's first pass).
template <class O, int kReg>
__device__ __forceinline__ void allpole_step(float2 x, int m, const float2 (&a)[kReg + 1],
                                             float2 (&v)[kReg]) {
  if (m == 0) return;
  shift_in<kReg>(v, tf_feedback<O, kReg>(x, m, a, v));
}

// One SOS section (real coefficients a1, a2, b0, b1, b2) on its (v1, v2).
template <class O>
__device__ __forceinline__ float2 sos_section(float2 y, float a1, float a2, float b0, float b1,
                                              float b2, float2& v1, float2& v2) {
  const float2 v0 = O::sub(O::sub(y, O::mul(make_float2(a1, 0.0f), v1)),
                           O::mul(make_float2(a2, 0.0f), v2));
  const float2 out = O::add(O::add(O::mul(make_float2(b0, 0.0f), v0),
                                   O::mul(make_float2(b1, 0.0f), v1)),
                            O::mul(make_float2(b2, 0.0f), v2));
  v2 = v1;
  v1 = v0;
  return out;
}

}  // namespace yagi_iir
