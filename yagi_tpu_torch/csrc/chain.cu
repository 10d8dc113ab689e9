// Fused receive-chain kernel: FIR ⊛ P× polyphase interpolation → NCO mix-down.
//
// Replaces yagi_tpu/kernels/chain.py::_chain_kernel (the Pallas TPU kernel of
// FusedRxChain, BASELINE config[0]). For each channel c and output sample
// m = P·n + δ:
//   z_m = Σ_{k<K} g_δ[k] · x[n − k]            (re and im planes, fp32 FMA)
//   y_m = z_m · e^{−jθ_m},  θ_m = θ0 + m·dθ      (wrapping u32)
// where g_δ = (scale·h_fir) ⊛ branch[δ·npfb/P] are the K ≤ 128 combined taps
// built in float64 on the host (yagi_tpu_torch/kernels/chain.py). The NCO
// step is nco.cuh's, shared with the mix-down kernel (mix.cu).
//
// What bounds it on an H100. Per output sample it does 2·K FMAs (K = 77 for
// config[0]) and moves about 12 bytes: 8 bytes of input per P = 2 outputs and
// 8 bytes of output. At ~26 FLOP/byte that sits close to the card's fp32
// CUDA-core ridge (67 TFLOP/s over 3.35 TB/s ≈ 20), so it is near balanced,
// not purely memory-bound.
//
// Design. The TPU kernel multiplies each 128-sample row pair by a dense
// banded [256, 128·P] matrix on the MXU, paying 256 MACs per output. Here a
// direct polyphase loop pays K: each block stages its input span plus a
// 128-sample left halo (from the stream history for the block's first tile)
// in shared memory; each thread keeps R consecutive inputs × P phases of
// accumulators in registers and walks the taps R at a time, so one window
// load of 2R samples feeds R·R·P FMA pairs. Taps past the last nonzero one
// are skipped (K is found per block from the tap table). A wgmma form over
// the banded matrix, and TF32 / bf16x3 tensor-core modes, are later work:
// every precision mode runs this fp32 kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nco.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kHalo = 128;  // one row of history: K ≤ 128 taps
constexpr int kTaps = 128;  // compact taps per phase δ

template <int P, int R>
__global__ void __launch_bounds__(kThreads)
chain_fp32_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  const float* __restrict__ g,  // [2, 128, 128·P] band matrices
                  const float* __restrict__ hist_r,
                  const float* __restrict__ hist_i,  // [C, 128]
                  const int64_t* __restrict__ theta0_p,
                  const int64_t* __restrict__ dtheta_p,
                  float* __restrict__ yr, float* __restrict__ yi, int T) {
  static_assert(R % 4 == 0 && kTaps % R == 0, "R must be a multiple of 4 dividing 128");
  constexpr int kTile = kThreads * R;  // input samples per block
  __shared__ __align__(16) float s_xr[kHalo + kTile];
  __shared__ __align__(16) float s_xi[kHalo + kTile];
  __shared__ __align__(16) float s_g[P][kTaps];
  __shared__ int s_k;

  const int c = blockIdx.y;
  const int n_start = blockIdx.x * kTile;
  const float* xr_c = xr + (size_t)c * T;
  const float* xi_c = xi + (size_t)c * T;

  if (threadIdx.x == 0) s_k = 0;
  __syncthreads();
  // compact taps: row 0 of the current-row band holds g_δ[t] at column P·t + δ
  const float* g_cur0 = g + (size_t)kTaps * kTaps * P;
  for (int u = threadIdx.x; u < P * kTaps; u += kThreads) {
    const float v = g_cur0[u];
    s_g[u % P][u / P] = v;
    if (v != 0.0f) atomicMax(&s_k, u / P + 1);
  }
  // s_x[i] holds x[n_start − kHalo + i]; the stream history is x[−128..−1]
  for (int i = threadIdx.x; i < kHalo + kTile; i += kThreads) {
    const int n = n_start - kHalo + i;
    float vr = 0.0f, vi = 0.0f;
    if (n < 0) {
      vr = hist_r[(size_t)c * kHalo + (n + kHalo)];
      vi = hist_i[(size_t)c * kHalo + (n + kHalo)];
    } else if (n < T) {
      vr = xr_c[n];
      vi = xi_c[n];
    }
    s_xr[i] = vr;
    s_xi[i] = vi;
  }
  __syncthreads();

  const int t0 = threadIdx.x * R;  // this thread's first input, tile-local
  if (n_start + t0 >= T) return;   // T % 128 == 0: a thread is all in or all out
  const int k_end = (s_k + R - 1) / R * R;

  float ar[R][P], ai[R][P];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int d = 0; d < P; ++d) ar[r][d] = ai[r][d] = 0.0f;

  for (int kc = 0; kc < k_end; kc += R) {
    // w[j] = x[n_start + t0 − kc − R + j]; x[n0 + r − k] for k = kc + kk is
    // w[R + r − kk]. base is a multiple of 4: float4 loads.
    const int base = kHalo + t0 - kc - R;
    float wr[2 * R], wi[2 * R];
#pragma unroll
    for (int j = 0; j < 2 * R; j += 4) {
      const float4 a = *reinterpret_cast<const float4*>(&s_xr[base + j]);
      const float4 b = *reinterpret_cast<const float4*>(&s_xi[base + j]);
      wr[j] = a.x; wr[j + 1] = a.y; wr[j + 2] = a.z; wr[j + 3] = a.w;
      wi[j] = b.x; wi[j + 1] = b.y; wi[j + 2] = b.z; wi[j + 3] = b.w;
    }
    float gv[P][R];
#pragma unroll
    for (int d = 0; d < P; ++d)
#pragma unroll
      for (int j = 0; j < R; j += 4) {
        const float4 g = *reinterpret_cast<const float4*>(&s_g[d][kc + j]);
        gv[d][j] = g.x; gv[d][j + 1] = g.y; gv[d][j + 2] = g.z; gv[d][j + 3] = g.w;
      }
#pragma unroll
    for (int kk = 0; kk < R; ++kk)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float vr = wr[R + r - kk], vi = wi[R + r - kk];
#pragma unroll
        for (int d = 0; d < P; ++d) {
          ar[r][d] = fmaf(gv[d][kk], vr, ar[r][d]);
          ai[r][d] = fmaf(gv[d][kk], vi, ai[r][d]);
        }
      }
  }

  // NCO epilogue: exact wrapping u32 ramp, then (zr + j·zi)·e^{−jθ}
  const uint32_t theta0 = (uint32_t)(*theta0_p);
  const uint32_t dtheta = (uint32_t)(*dtheta_p);
  const int m0 = (n_start + t0) * P;
  float out_r[R * P], out_i[R * P];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int d = 0; d < P; ++d) {
      const uint32_t th = theta0 + (uint32_t)(m0 + r * P + d) * dtheta;
      yagi::nco_rotate_down(ar[r][d], ai[r][d], th, out_r[r * P + d], out_i[r * P + d]);
    }
  // R·P is a multiple of 4 and the row offset is 16-byte aligned
  float* yr_o = yr + (size_t)c * T * P + m0;
  float* yi_o = yi + (size_t)c * T * P + m0;
#pragma unroll
  for (int j = 0; j < R * P; j += 4) {
    *reinterpret_cast<float4*>(yr_o + j) =
        make_float4(out_r[j], out_r[j + 1], out_r[j + 2], out_r[j + 3]);
    *reinterpret_cast<float4*>(yi_o + j) =
        make_float4(out_i[j], out_i[j + 1], out_i[j + 2], out_i[j + 3]);
  }
}

template <int P>
int launch(const float* xr, const float* xi, const float* g, const float* hist_r,
           const float* hist_i, const int64_t* theta0, const int64_t* dtheta,
           float* yr, float* yi, int C, int T, cudaStream_t stream) {
  // R = max(4, 16/P) inputs per thread: 16 or 32 accumulators per plane,
  // and R ≥ 4 keeps the window loads float4
  constexpr int R = 16 / P > 4 ? 16 / P : 4;
  constexpr int kTile = kThreads * R;
  const dim3 grid((T + kTile - 1) / kTile, C);
  chain_fp32_kernel<P, R><<<grid, kThreads, 0, stream>>>(
      xr, xi, g, hist_r, hist_i, theta0, dtheta, yr, yi, T);
  return (int)cudaGetLastError();
}

}  // namespace

// Planar fp32 chain step. xr/xi [C, T], g [2, 128, 128·P] from chain_matrices,
// hist_r/hist_i [C, 128],
// theta0/dtheta int64 scalars in [0, 2^32) on the device, yr/yi [C, T·P].
// T % 128 == 0, P ∈ {1, 2, 4, 8}. Launches on `stream` and returns the CUDA
// error of the launch (0 on success).
extern "C" int yagi_chain_fp32(const float* xr, const float* xi, const float* g,
                               const float* hist_r, const float* hist_i,
                               const int64_t* theta0, const int64_t* dtheta,
                               float* yr, float* yi, int C, int T, int P,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: return launch<1>(xr, xi, g, hist_r, hist_i, theta0, dtheta, yr, yi, C, T, s);
    case 2: return launch<2>(xr, xi, g, hist_r, hist_i, theta0, dtheta, yr, yi, C, T, s);
    case 4: return launch<4>(xr, xi, g, hist_r, hist_i, theta0, dtheta, yr, yi, C, T, s);
    case 8: return launch<8>(xr, xi, g, hist_r, hist_i, theta0, dtheta, yr, yi, C, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
