// The u32 NCO step shared by the port's kernels: y = x·e^{−jθ} for a
// wrapping u32 phase θ (osc.rs:86-88, constrain osc.rs:191-200).
//
// Callers form θ_m = θ0 + m·dθ in uint32_t arithmetic, which wraps exactly
// as the oscillator's accumulator. The u32 → f32 step rounds to nearest and
// is scaled by float32(2π/2^32), as the plain torch versions do
// (yagi_tpu_torch/nco/osc.py), so the phase fed to sincosf is bit-identical
// to theirs. Build without --use_fast_math: it would turn sincosf into
// __sinf/__cosf, whose error is not the reference's.

#pragma once

#include <stdint.h>

namespace yagi {

// cos θ and sin θ of a u32 phase
__device__ __forceinline__ void nco_phasor(uint32_t theta, float& c, float& s) {
  constexpr float kPhaseToRad = (float)(6.283185307179586 / 4294967296.0);
  sincosf(__uint2float_rn(theta) * kPhaseToRad, &s, &c);
}

// (xr + j·xi)·(cos θ − j·sin θ)
__device__ __forceinline__ void nco_rotate_down(float xr, float xi, uint32_t theta,
                                                float& yr, float& yi) {
  float s, c;
  nco_phasor(theta, c, s);
  yr = xr * c + xi * s;
  yi = xi * c - xr * s;
}

}  // namespace yagi
