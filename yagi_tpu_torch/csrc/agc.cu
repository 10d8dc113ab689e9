// The AGC's gain loop over a block, one thread per channel (agc_scan).
//
// Replaces the lax.scan of yagi_tpu/agc/agc.py::Agc.execute_block (its
// per-sample body, agc.py:260-276): yagi_tpu has no Pallas kernel here, the
// scan is compiled by XLA into one device loop. In eager torch the loop is
// ~20 small ops per sample, a launch each; this kernel is the port's form of
// that compiled loop. Per channel and sample:
//
//   y = g·x;  y2' = (1 − α)·y2' + α·|y|²;
//   g ← min(g·exp(−½·α·ln max(y2', 1e-30)), 1e6) where y2' > 1e-6, held
//       when locked;
//   rssi = −20·log10 g, the squelch FSM (agc.rs:212-248), held when locked;
//   out = y·s, s = 1 when locked, else the scale.
//
// It must equal its plain version (kernels/agc.py::agc_scan_reference) bit
// for bit: every product and sum is __fmul_rn/__fadd_rn/__fsub_rn (never
// contracted into an FMA, as torch rounds each op), expf/logf/log10f are the
// functions torch's elementwise kernels call, and min/max are written as
// comparisons so a NaN propagates as torch.clamp lets it.
//
// What bounds it on an H100: the gain recurrence is serial per channel, a
// dependent chain of ~10 operations with a logf and an expf per sample, so
// with one thread per channel (2048 channels: 64 warps) it is latency-bound:
// 1.12 ms a config[3] block, ~480 cycles a sample, where the 64 MB in and
// out take ~40 µs of bandwidth. Where the squelch is disabled (QamRx's AGC)
// the RSSI's log10f and the FSM are skipped, which saved 21% (PERF.md §6).
// Each thread walks its own row; the loads do not depend on the loop, so
// the compiler issues them ahead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

// AgcSquelchMode (agc.py:26-35)
enum : int32_t { kDisabled, kEnabled, kRise, kSignalHi, kFall, kSignalLo, kTimeout };

__global__ void __launch_bounds__(kThreads)
agc_scan_kernel(const float2* __restrict__ x, const float* __restrict__ g_in,
                const float* __restrict__ y2p_in, const float* __restrict__ alpha_in,
                const float* __restrict__ scale_in, const float* __restrict__ thr_in,
                const uint8_t* __restrict__ locked_in, const int32_t* __restrict__ mode_in,
                const int32_t* __restrict__ timer_in, float2* __restrict__ y,
                float* __restrict__ g_out, float* __restrict__ y2p_out,
                int32_t* __restrict__ mode_out, int32_t* __restrict__ timer_out, int C, int n,
                int timeout) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const float alpha = alpha_in[c];
  const float one_m_alpha = __fsub_rn(1.0f, alpha);
  const float neg_half_alpha = __fmul_rn(-0.5f, alpha);
  const float thr = thr_in[c];
  const bool locked = locked_in[c] != 0;
  const float s = locked ? 1.0f : scale_in[c];
  float g = g_in[c], y2p = y2p_in[c];
  int32_t mode = mode_in[c], timer = timer_in[c];
  const float2* xr = x + (size_t)c * n;
  float2* yr = y + (size_t)c * n;
#pragma unroll 4
  for (int t = 0; t < n; ++t) {
    const float2 v = xr[t];
    const float a = __fmul_rn(v.x, g), b = __fmul_rn(v.y, g);
    const float y2 = __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
    y2p = __fadd_rn(__fmul_rn(one_m_alpha, y2p), __fmul_rn(alpha, y2));
    const float floor = y2p < 1e-30f ? 1e-30f : y2p;
    float g_upd = __fmul_rn(g, expf(__fmul_rn(neg_half_alpha, logf(floor))));
    if (!(y2p > 1e-6f)) g_upd = g;
    if (g_upd > 1e6f) g_upd = 1e6f;
    // DISABLED (and any value outside the FSM, which disables) stays
    // DISABLED with its timer: the RSSI is not needed then.
    if (!locked) {
      g = g_upd;
      if (mode != kDisabled) {
        const bool te = __fmul_rn(-20.0f, log10f(g)) > thr;
        int32_t next;
        switch (mode) {
          case kEnabled: next = te ? kRise : kEnabled; break;
          case kRise:
          case kSignalHi: next = te ? kSignalHi : kFall; break;
          case kFall: next = te ? kSignalHi : kSignalLo; timer = timeout; break;
          case kSignalLo:
            timer -= 1;
            next = timer == 0 ? kTimeout : (te ? kSignalHi : kSignalLo);
            break;
          case kTimeout: next = kEnabled; break;
          default: next = kDisabled;
        }
        mode = next;
      }
    }
    yr[t] = make_float2(__fmul_rn(a, s), __fmul_rn(b, s));
  }
  g_out[c] = g;
  y2p_out[c] = y2p;
  mode_out[c] = mode;
  timer_out[c] = timer;
}

}  // namespace

// x, y: [C, n] complex64; g, y2_prime, alpha, scale, squelch_threshold: [C]
// float32; locked: [C] uint8; squelch_mode, squelch_timer: [C] int32; the
// *_out arrays are fresh [C] arrays of the same types. Launches on `stream`;
// returns the launch's CUDA error (0 on success).
extern "C" int yagi_agc_scan(const void* x, const float* g, const float* y2p, const float* alpha,
                             const float* scale, const float* thr, const uint8_t* locked,
                             const int32_t* mode, const int32_t* timer, void* y, float* g_out,
                             float* y2p_out, int32_t* mode_out, int32_t* timer_out, int C, int n,
                             int timeout, void* stream) {
  const int blocks = (C + kThreads - 1) / kThreads;
  agc_scan_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), g, y2p, alpha, scale, thr, locked, mode, timer,
      static_cast<float2*>(y), g_out, y2p_out, mode_out, timer_out, C, n, timeout);
  return (int)cudaGetLastError();
}
