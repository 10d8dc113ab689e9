// Another formulation of the fused receive chain (K1), for tools/kernel_ab.py's
// A/B against csrc/chain.cu's direct form; the package does not call it.
//
// Two stages instead of the K = n_taps + L − 1 combined taps per output:
//   v[n]       = Σ_{k<n_taps} h[k]·x[n − k]          (the FIR, at the input rate)
//   z[2n + δ]  = Σ_{l<L} b_δ[l]·v[n − l]             (a polyphase branch per output)
//   y_m        = z_m·e^{−jθ_m}
// with v parked in shared memory: 64 + 2·14 = 92 multiply-adds per input
// sample and plane at P = 2 where the direct form pays 2·77 = 154. v is
// rounded to float32, as the staged RxChain rounds it, so the values differ
// from the direct form's (combined taps built in float64) by float32
// rounding. It needs h and the branches apart, which FusedRxChain's state
// (the banded g) does not hold. Planar float32, P = 2, n_taps ≤ 64, L ≤ 16.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nco.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int R = 8;                  // inputs per thread
constexpr int kTile = kThreads * R;   // input samples per block
constexpr int kFir = 64;              // FIR taps, zero padded
constexpr int kBr = 16;               // branch taps, zero padded
constexpr int kHaloV = 16;            // v samples before the tile (≥ L − 1)
constexpr int kHaloX = kFir + kHaloV;  // x samples before the tile
constexpr int P = 2;

__device__ __forceinline__ int padded(int i) { return i + ((i >> 5) << 2); }
__device__ __forceinline__ void unpack(const float4 v, float* d) {
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}

__global__ void __launch_bounds__(kThreads)
chain_twostage_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                      const float* __restrict__ h, const float* __restrict__ br,
                      const float* __restrict__ hist_r, const float* __restrict__ hist_i,
                      const int64_t* __restrict__ theta0_p, const int64_t* __restrict__ dtheta_p,
                      float* __restrict__ yr, float* __restrict__ yi, int T, int tiles) {
  constexpr int kX = kHaloX + kTile, kV = kHaloV + kTile;
  __shared__ __align__(16) float s_xr[kX + kX / 8];
  __shared__ __align__(16) float s_xi[kX + kX / 8];
  __shared__ __align__(16) float s_vr[kV + kV / 8];
  __shared__ __align__(16) float s_vi[kV + kV / 8];
  __shared__ __align__(16) float s_h[kFir];
  __shared__ __align__(16) float s_b[P][kBr];
  __shared__ float2 s_rot[R * P];  // the NCO's rotation by j steps, as csrc/chain.cu's
  constexpr int kOut = R * P, kOutWarp = 72 * kOut;  // and its staged, coalesced stores
  __shared__ __align__(16) float s_out[kThreads / 32 * kOutWarp];

  const int tid = threadIdx.x;
  const int n_start = (blockIdx.x % tiles) * kTile;
  const int c = blockIdx.x / tiles;
  if (tid < kFir) s_h[tid] = h[tid];
  if (tid < P * kBr) s_b[tid / kBr][tid % kBr] = br[tid];
  if (tid < R * P)
    yagi::nco_phasor((uint32_t)tid * (uint32_t)(*dtheta_p), s_rot[tid].x, s_rot[tid].y);
  // x plane index i holds x[n_start − kHaloX + i]
  const int count = kHaloX + min(kTile, T - n_start);
  for (int i = 4 * tid; i < kX; i += 4 * kThreads) {
    const int n = n_start - kHaloX + i;
    float4 vr = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vi = vr;
    if (n < 0) {
      vr = *reinterpret_cast<const float4*>(hist_r + (size_t)c * 128 + (n + 128));
      vi = *reinterpret_cast<const float4*>(hist_i + (size_t)c * 128 + (n + 128));
    } else if (i < count) {
      vr = *reinterpret_cast<const float4*>(xr + (size_t)c * T + n);
      vi = *reinterpret_cast<const float4*>(xi + (size_t)c * T + n);
    }
    *reinterpret_cast<float4*>(&s_xr[padded(i)]) = vr;
    *reinterpret_cast<float4*>(&s_xi[padded(i)]) = vi;
  }
  __syncthreads();

  // stage 1: v plane index j holds v[n_start − kHaloV + j]; an item is R of them
  for (int it = tid; it < kV / R; it += kThreads) {
    const int at = kFir + it * R;  // x plane index of the item's first sample
    float ar[R], ai[R], hr_[R], hi_[R], lr[R], li[R];
#pragma unroll
    for (int r = 0; r < R; ++r) ar[r] = ai[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < R; j += 4) {
      unpack(*reinterpret_cast<const float4*>(&s_xr[padded(at + j)]), hr_ + j);
      unpack(*reinterpret_cast<const float4*>(&s_xi[padded(at + j)]), hi_ + j);
    }
#pragma unroll 1
    for (int kc = 0; kc < kFir; kc += R) {
      float gv[R];
#pragma unroll
      for (int j = 0; j < R; j += 4) {
        unpack(*reinterpret_cast<const float4*>(&s_xr[padded(at - kc - R + j)]), lr + j);
        unpack(*reinterpret_cast<const float4*>(&s_xi[padded(at - kc - R + j)]), li + j);
        unpack(*reinterpret_cast<const float4*>(&s_h[kc + j]), gv + j);
      }
#pragma unroll
      for (int kk = 0; kk < R; ++kk)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          ar[r] = fmaf(gv[kk], r >= kk ? hr_[r - kk] : lr[R + r - kk], ar[r]);
          ai[r] = fmaf(gv[kk], r >= kk ? hi_[r - kk] : li[R + r - kk], ai[r]);
        }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        hr_[j] = lr[j];
        hi_[j] = li[j];
      }
    }
#pragma unroll
    for (int j = 0; j < R; j += 4) {
      *reinterpret_cast<float4*>(&s_vr[padded(it * R + j)]) =
          make_float4(ar[j], ar[j + 1], ar[j + 2], ar[j + 3]);
      *reinterpret_cast<float4*>(&s_vi[padded(it * R + j)]) =
          make_float4(ai[j], ai[j + 1], ai[j + 2], ai[j + 3]);
    }
  }
  __syncthreads();

  const int t0 = tid * R;
  const bool active = n_start + t0 < T;
  float out_r[R * P], out_i[R * P];
  if (active) {
    // stage 2: w[j] = v[n0 − kHaloV + j], so v[n0 + r − l] = w[kHaloV + r − l]
    float wr[kHaloV + R], wi[kHaloV + R];
#pragma unroll
    for (int j = 0; j < kHaloV + R; j += 4) {
      unpack(*reinterpret_cast<const float4*>(&s_vr[padded(t0 + j)]), wr + j);
      unpack(*reinterpret_cast<const float4*>(&s_vi[padded(t0 + j)]), wi + j);
    }
    const uint32_t theta0 = (uint32_t)(*theta0_p);
    const uint32_t dtheta = (uint32_t)(*dtheta_p);
    const int m0 = (n_start + t0) * P;
    float cb, sb;
    yagi::nco_phasor(theta0 + (uint32_t)m0 * dtheta, cb, sb);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int d = 0; d < P; ++d) {
        float zr = 0.0f, zi = 0.0f;
#pragma unroll
        for (int l = 0; l < kBr; ++l) {
          zr = fmaf(s_b[d][l], wr[kHaloV + r - l], zr);
          zi = fmaf(s_b[d][l], wi[kHaloV + r - l], zi);
        }
        const float2 o = s_rot[r * P + d];
        const float c = cb * o.x - sb * o.y, s = sb * o.x + cb * o.y;
        out_r[r * P + d] = zr * c + zi * s;
        out_i[r * P + d] = zi * c - zr * s;
      }
  }  // active
  const int warp = tid / 32, lane = tid % 32;
  float* so = s_out + warp * kOutWarp;
  float* so_i = so + kOutWarp / 2;
  const long long first = (long long)(n_start + warp * 32 * R) * P;
  const int valid = (int)min((long long)(32 * kOut), (long long)T * P - first);
  if (active) {
#pragma unroll
    for (int j = 0; j < kOut; j += 4) {
      *reinterpret_cast<float4*>(&so[padded(lane * kOut + j)]) =
          make_float4(out_r[j], out_r[j + 1], out_r[j + 2], out_r[j + 3]);
      *reinterpret_cast<float4*>(&so_i[padded(lane * kOut + j)]) =
          make_float4(out_i[j], out_i[j + 1], out_i[j + 2], out_i[j + 3]);
    }
  }
  __syncwarp();
  const size_t row = (size_t)c * T * P + first;
#pragma unroll
  for (int q = 0; q < kOut / 4; ++q) {
    const int i = 4 * lane + 128 * q;
    if (i < valid) {
      *reinterpret_cast<float4*>(yr + row + i) = *reinterpret_cast<const float4*>(&so[padded(i)]);
      *reinterpret_cast<float4*>(yi + row + i) =
          *reinterpret_cast<const float4*>(&so_i[padded(i)]);
    }
  }
}

}  // namespace

// xr/xi [C, T] float32; h [64] the scaled FIR taps, zero padded; br [2, 16]
// the two branches in convolution order, zero padded; hist_r/hist_i [C, 128];
// theta0/dtheta int64 scalars on the device; yr/yi [C, 2T]. T a multiple of
// 128, P = 2, n_taps ≤ 64, L ≤ 16. Returns the launch's CUDA error.
extern "C" int yagi_chain_twostage(const float* xr, const float* xi, const float* h,
                                   const float* br, const float* hist_r, const float* hist_i,
                                   const int64_t* theta0, const int64_t* dtheta, float* yr,
                                   float* yi, int C, int T, int p, int n_taps, int L,
                                   void* stream) {
  if (p != P || n_taps > kFir || L > kBr || T % 128) return (int)cudaErrorInvalidValue;
  const int tiles = (T + kTile - 1) / kTile;
  chain_twostage_kernel<<<C * tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, h, br, hist_r, hist_i, theta0, dtheta, yr, yi, T, tiles);
  return (int)cudaGetLastError();
}
