// Fused receive-chain kernel: FIR ⊛ P× polyphase interpolation → NCO mix-down.
//
// Replaces yagi_tpu/kernels/chain.py::_chain_kernel (the Pallas TPU kernel of
// FusedRxChain, BASELINE config[0]). For each channel c and output sample
// m = P·n + δ:
//   z_m = Σ_{k<K} g_δ[k] · x[n − k]            (re and im planes, fp32 FMA)
//   y_m = z_m · e^{−jθ_m},  θ_m = θ0 + m·dθ      (wrapping u32)
// where g_δ = (scale·h_fir) ⊛ branch[δ·npfb/P] are the K ≤ 128 combined taps
// built in float64 on the host. The host hands them over compact, [P, Kp]
// with Kp = K rounded up to 16 and zeros past K
// (yagi_tpu_torch/kernels/chain.py::compact_taps). The NCO step is nco.cuh's,
// shared with the mix-down kernel (mix.cu).
//
// What bounds it on an H100. The function is bytes-bound: 8 bytes in and 8·P
// out per input sample (50 MB a config[0] block, 0.0151 ms at 3.35 TB/s),
// where the fewest operations that compute it (the FIR at the input rate, a
// 14-tap branch per output) take less. This direct form pays Kp = 80 taps per
// output, 1.34 GFLOP a config[0] block, 0.0200 ms at 67 TFLOP/s, and the
// kernel is bound by that tap loop, which runs near the FMA rate
// (~0.029 ms of its 0.046 on an NVIDIA H100 80GB HBM3 at 700 W), plus the
// part of the memory traffic that does not overlap it; PERF.md §6 has the
// measurements, this form's and others'.
//
// Design. The TPU kernel multiplies each 128-sample row pair by a dense
// banded [256, 128·P] matrix on the MXU, paying 256 MACs per output. Here a
// direct polyphase loop pays Kp. The work is cut into items, (channel, tile,
// phase group), on one line, so neither the channel count nor P is bound by a
// grid dimension or a template list; the grid is as many blocks as the card
// holds at once, each taking every gridDim.x-th item. A block fetches its
// next item's input into registers before it computes this one, so the loads
// fly during the FMAs; then it parks them in shared memory as two planes,
// whichever layout the input has: the tile plus a halo of Kp samples (from the
// stream history for a channel's first tile). The planes are padded by 4
// floats every 32, so that the float4 window loads of threads R = 8 or 16
// floats apart fall on distinct banks. Each thread keeps R consecutive inputs
// × PG phases of accumulators in registers and walks the taps R at a time; the
// window slides, so a step loads R new samples per plane, not 2R, and feeds
// R·R·PG FMA pairs. The NCO costs one sincosf a thread (see the epilogue),
// and a warp's outputs go out as whole 512-byte rows through shared memory.
// PG = P for P ≤ 8; a larger P (a power of two, as 2^24 mod P = 0 demands)
// runs in groups of 8 phases, an item each. Two layouts, one source: planar
// float32 planes, and interleaved complex64 in and out (FusedRxChain.step),
// which saves the step its split and join passes. Every precision mode runs
// this fp32 kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nco.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTaps = 128;  // Kp ≤ 128: one row of history

// Index of sample i in a padded plane: 4 floats of padding after every 32.
__device__ __forceinline__ int padded(int i) { return i + ((i >> 5) << 2); }

__device__ __forceinline__ void unpack(const float4 v, float* d) {
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}

// A work item: one tile of one channel for one group of PG phases.
struct Item {
  int c, n_start, d0;
};

__device__ __forceinline__ Item item_of(int w, int tiles, int groups, int tile, int pg) {
  return Item{w / (groups * tiles), (w / groups) % tiles * tile, w % groups * pg};
}

// The arguments every part of the kernel reads. x0/x1: the planes xr, xi
// [C, T], or (interleaved) x0 complex64 [C, T] as floats and x1 unused; y0/y1
// likewise [C, T·P]. gc [P, Kp]; hist_r/hist_i [C, 128].
struct Args {
  const float *x0, *x1, *gc, *hist_r, *hist_i;
  const int64_t *theta0, *dtheta;
  float *y0, *y1;
  int T, P, Kp, tiles, items;
};

// An item's stage into registers, four samples a load: x[n_start − Kp + i]
// for i = 4·(tid + k·kThreads), from the stream history (x[−128..−1]) below 0
// and zeros past the block. n_start, Kp and T are multiples of 4, so the four
// lie together. The loads are only started here; park() is their first use.
template <int kFetch, bool kInterleaved>
__device__ __forceinline__ void fetch(const Args& a, const Item it, int tile, float4 (&fr)[kFetch],
                                      float4 (&fi)[kFetch]) {
  const int count = a.Kp + min(tile, a.T - it.n_start);
#pragma unroll
  for (int k = 0; k < kFetch; ++k) {
    const int i = 4 * (threadIdx.x + k * kThreads);
    const int n = it.n_start - a.Kp + i;
    fr[k] = fi[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i >= count) continue;
    if (n < 0) {
      const size_t at = (size_t)it.c * kMaxTaps + (n + kMaxTaps);
      fr[k] = *reinterpret_cast<const float4*>(a.hist_r + at);
      fi[k] = *reinterpret_cast<const float4*>(a.hist_i + at);
    } else if (kInterleaved) {
      const float4* p = reinterpret_cast<const float4*>(a.x0 + 2 * ((size_t)it.c * a.T + n));
      const float4 u = p[0], v = p[1];
      fr[k] = make_float4(u.x, u.z, v.x, v.z);
      fi[k] = make_float4(u.y, u.w, v.y, v.w);
    } else {
      fr[k] = *reinterpret_cast<const float4*>(a.x0 + (size_t)it.c * a.T + n);
      fi[k] = *reinterpret_cast<const float4*>(a.x1 + (size_t)it.c * a.T + n);
    }
  }
}

// Block b takes the items b, b + gridDim.x, ... For each it parks the stage
// it fetched one item ago, fetches the next, and computes.
// (Four blocks an SM where R ≤ 8: the interleaved instance then fits 128
// registers, and the grid below comes out even.)
template <int PG, int R, bool kInterleaved>
__global__ void __launch_bounds__(kThreads, R <= 8 ? 4 : 1) chain_kernel(const Args a) {
  static_assert(R == 4 || R == 8 || R == 16, "R divides Kp's step of 16; float4 loads");
  constexpr int kTile = kThreads * R;  // input samples per item
  constexpr int kStage = kMaxTaps + kTile;
  constexpr int kFetch = (kStage / 4 + kThreads - 1) / kThreads;
  constexpr int kOut = R * PG;                         // outputs per thread
  constexpr int kOutWarp = 64 * kOut + 64 * kOut / 8;  // a warp's outputs, both parts, padded
  __shared__ __align__(16) float s_xr[kStage + kStage / 8];
  __shared__ __align__(16) float s_xi[kStage + kStage / 8];
  __shared__ __align__(16) float s_g[PG][kMaxTaps];
  __shared__ __align__(16) float s_out[kThreads / 32 * kOutWarp];
  __shared__ float2 s_rot[kOut];

  const int T = a.T, P = a.P, Kp = a.Kp;
  const int groups = P / PG;
  const int tid = threadIdx.x;
  const uint32_t theta0 = (uint32_t)(*a.theta0);
  const uint32_t dtheta = (uint32_t)(*a.dtheta);

  // A thread's output j = r·PG + d lies (j / PG)·P + j % PG samples after its
  // first: the rotation by that many steps of the NCO, (cos, sin), once a block
  if (tid < kOut)
    yagi::nco_phasor((uint32_t)((tid / PG) * P + tid % PG) * dtheta, s_rot[tid].x, s_rot[tid].y);

  float4 fr[kFetch], fi[kFetch];
  int w = blockIdx.x;
  fetch<kFetch, kInterleaved>(a, item_of(w, a.tiles, groups, kTile, PG), kTile, fr, fi);
  for (; w < a.items; w += gridDim.x) {
    const Item it = item_of(w, a.tiles, groups, kTile, PG);
    if (w != blockIdx.x) __syncthreads();  // the last item's windows and taps are read
    // plane index i holds x[n_start − Kp + i]
#pragma unroll
    for (int k = 0; k < kFetch; ++k) {
      const int i = 4 * (tid + k * kThreads);
      if (i < kStage) {
        *reinterpret_cast<float4*>(&s_xr[padded(i)]) = fr[k];
        *reinterpret_cast<float4*>(&s_xi[padded(i)]) = fi[k];
      }
    }
    if (groups > 1 || w == blockIdx.x) {  // the taps of this item's phases
      for (int u = tid; u < PG * Kp; u += kThreads) {
        const int d = u / Kp, k = u % Kp;
        s_g[d][k] = a.gc[(size_t)(it.d0 + d) * Kp + k];
      }
    }
    __syncthreads();
    if (w + gridDim.x < a.items)  // in flight while this item computes
      fetch<kFetch, kInterleaved>(a, item_of(w + gridDim.x, a.tiles, groups, kTile, PG), kTile,
                                  fr, fi);

    const int t0 = tid * R;  // this thread's first input, tile-local
    const int n0 = it.n_start + t0;
    const bool active = n0 < T;  // T % 128 == 0: a thread is all in or all out
    float out_r[kOut], out_i[kOut];
    if (active) {
      float ar[R][PG], ai[R][PG];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int d = 0; d < PG; ++d) ar[r][d] = ai[r][d] = 0.0f;

      // The window: hi[j] = x[n0 − kc + j], lo[j] = x[n0 − kc − R + j], so
      // x[n0 + r − (kc + kk)] is hi[r − kk] or lo[R + r − kk]. Each step loads
      // lo and hands it on as the next hi.
      float hr[R], hi[R], lr[R], li[R];
#pragma unroll
      for (int j = 0; j < R; j += 4) {
        unpack(*reinterpret_cast<const float4*>(&s_xr[padded(Kp + t0 + j)]), hr + j);
        unpack(*reinterpret_cast<const float4*>(&s_xi[padded(Kp + t0 + j)]), hi + j);
      }
      for (int kc = 0; kc < Kp; kc += R) {
        const int base = Kp + t0 - kc - R;  // ≥ 0, a multiple of 4
#pragma unroll
        for (int j = 0; j < R; j += 4) {
          unpack(*reinterpret_cast<const float4*>(&s_xr[padded(base + j)]), lr + j);
          unpack(*reinterpret_cast<const float4*>(&s_xi[padded(base + j)]), li + j);
        }
        float gv[PG][R];
#pragma unroll
        for (int d = 0; d < PG; ++d)
#pragma unroll
          for (int j = 0; j < R; j += 4)
            unpack(*reinterpret_cast<const float4*>(&s_g[d][kc + j]), &gv[d][j]);
#pragma unroll
        for (int kk = 0; kk < R; ++kk)
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float vr = r >= kk ? hr[r - kk] : lr[R + r - kk];
            const float vi = r >= kk ? hi[r - kk] : li[R + r - kk];
#pragma unroll
            for (int d = 0; d < PG; ++d) {
              ar[r][d] = fmaf(gv[d][kk], vr, ar[r][d]);
              ai[r][d] = fmaf(gv[d][kk], vi, ai[r][d]);
            }
          }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          hr[j] = lr[j];
          hi[j] = li[j];
        }
      }

      // NCO epilogue, (zr + j·zi)·e^{−jθ_m} on the exact wrapping u32 ramp.
      // Output (r, d) is sample m = (n0 + r)·P + d0 + d of the channel's row.
      // The phases wrap mod 2^32, which is mod 2π, so e^{−jθ_m} is the thread's
      // first phasor times the block's rotation for (r, d): one sincosf a
      // thread, not one an output, at two more roundings of the phasor, ~2e-7.
      float cb, sb;
      yagi::nco_phasor(theta0 + (uint32_t)(n0 * P + it.d0) * dtheta, cb, sb);
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const float2 o = s_rot[j];
        const float c = cb * o.x - sb * o.y, s = sb * o.x + cb * o.y;
        out_r[j] = ar[j / PG][j % PG] * c + ai[j / PG][j % PG] * s;
        out_i[j] = ai[j / PG][j % PG] * c - ar[j / PG][j % PG] * s;
      }
    }

    const size_t row = (size_t)it.c * T * P;
    if (groups == 1) {
      // P = PG: a warp's 32·kOut outputs are one run of the channel's row. A
      // thread's own kOut outputs are a short run of it (64 or 128 bytes);
      // stored from registers that is 16 bytes of 32 different lines an
      // instruction. So the warp parks them in its part of s_out (padded like
      // the planes) and stores whole 512-byte rows.
      const int warp = tid / 32, lane = tid % 32;
      float* so = s_out + warp * kOutWarp;
      const long long first = (long long)(it.n_start + warp * 32 * R) * P;  // the run's start
      const int valid =  // of its 32·kOut outputs, those inside the block: ≤ 0 for a warp past it
          (int)min((long long)(32 * kOut), (long long)T * P - first);
      if (kInterleaved) {
        if (active) {
#pragma unroll
          for (int j = 0; j < kOut; j += 2)
            *reinterpret_cast<float4*>(&so[padded(2 * (lane * kOut + j))]) =
                make_float4(out_r[j], out_i[j], out_r[j + 1], out_i[j + 1]);
        }
        __syncwarp();
#pragma unroll
        for (int q = 0; q < kOut / 2; ++q) {
          const int i = 4 * lane + 128 * q;  // float index in the run of 64·kOut floats
          if (i < 2 * valid)
            *reinterpret_cast<float4*>(a.y0 + 2 * (row + first) + i) =
                *reinterpret_cast<const float4*>(&so[padded(i)]);
        }
      } else {
        float* so_i = so + kOutWarp / 2;
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
#pragma unroll
        for (int q = 0; q < kOut / 4; ++q) {
          const int i = 4 * lane + 128 * q;
          if (i < valid) {
            *reinterpret_cast<float4*>(a.y0 + row + first + i) =
                *reinterpret_cast<const float4*>(&so[padded(i)]);
            *reinterpret_cast<float4*>(a.y1 + row + first + i) =
                *reinterpret_cast<const float4*>(&so_i[padded(i)]);
          }
        }
      }
    } else if (active) {
      // P > PG: a thread's outputs lie in runs of 8 phases, P apart, stored
      // from registers. Outputs j .. j + 3 (planar) or j, j + 1 (interleaved)
      // are neighbours in memory, and every such run is 16-byte aligned.
      if (kInterleaved) {
#pragma unroll
        for (int j = 0; j < kOut; j += 2) {
          const size_t m = row + (size_t)(n0 + j / PG) * P + it.d0 + j % PG;
          *reinterpret_cast<float4*>(a.y0 + 2 * m) =
              make_float4(out_r[j], out_i[j], out_r[j + 1], out_i[j + 1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kOut; j += 4) {
          const size_t m = row + (size_t)(n0 + j / PG) * P + it.d0 + j % PG;
          *reinterpret_cast<float4*>(a.y0 + m) =
              make_float4(out_r[j], out_r[j + 1], out_r[j + 2], out_r[j + 3]);
          *reinterpret_cast<float4*>(a.y1 + m) =
              make_float4(out_i[j], out_i[j + 1], out_i[j + 2], out_i[j + 3]);
        }
      }
    }
  }
}

// The grid: as many blocks as the card holds at once, or fewer where that
// gives every block the same number of items (2048 items on 660 places run as
// 512 blocks of 4, not 3 or 4 each).
template <int PG, int R, bool kInterleaved>
int launch(Args a, int C, cudaStream_t stream) {
  constexpr int kTile = kThreads * R;
  a.tiles = (a.T + kTile - 1) / kTile;
  const long long items = (long long)C * a.tiles * (a.P / PG);
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.items = (int)items;
  static int places = 0;  // resident blocks of this instance on the current card
  if (places == 0) {
    int device, sms, per_sm;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, chain_kernel<PG, R, kInterleaved>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    places = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int each = (a.items + places - 1) / places;
  const int blocks = (a.items + each - 1) / each;
  chain_kernel<PG, R, kInterleaved><<<blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// R = max(4, 16/PG) inputs per thread: 16 or 32 accumulators per plane, and
// R ≥ 4 keeps the window loads float4.
template <bool kInterleaved>
int dispatch(const Args& a, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1 || a.T < 128 || a.T % 128 || a.P < 1 || (a.P & (a.P - 1)) || a.Kp < 16 ||
      a.Kp > kMaxTaps || a.Kp % 16)
    return (int)cudaErrorInvalidValue;
  switch (a.P) {
    case 1: return launch<1, 16, kInterleaved>(a, C, s);
    case 2: return launch<2, 8, kInterleaved>(a, C, s);
    case 4: return launch<4, 4, kInterleaved>(a, C, s);
    default: return launch<8, 4, kInterleaved>(a, C, s);  // P = 8, 16, 32, ...
  }
}

}  // namespace

// Planar fp32 chain step. xr/xi [C, T]; gc [P, Kp] compact taps, 16 ≤ Kp ≤
// 128 a multiple of 16; hist_r/hist_i [C, 128]; theta0/dtheta int64 scalars in
// [0, 2^32) on the device; yr/yi [C, T·P]. T a multiple of 128, P a power of
// two, T·P < 2^31. Launches on `stream` and returns the CUDA error of the
// launch (0 on success).
extern "C" int yagi_chain_planar(const float* xr, const float* xi, const float* gc,
                                 const float* hist_r, const float* hist_i,
                                 const int64_t* theta0, const int64_t* dtheta, float* yr,
                                 float* yi, int C, int T, int P, int Kp, void* stream) {
  return dispatch<false>(Args{xr, xi, gc, hist_r, hist_i, theta0, dtheta, yr, yi, T, P, Kp, 0, 0},
                         C, stream);
}

// The same step on interleaved complex64: x [C, T], y [C, T·P], 16-byte
// aligned; the history stays two planes.
extern "C" int yagi_chain_c64(const void* x, const float* gc, const float* hist_r,
                              const float* hist_i, const int64_t* theta0,
                              const int64_t* dtheta, void* y, int C, int T, int P, int Kp,
                              void* stream) {
  return dispatch<true>(Args{static_cast<const float*>(x), nullptr, gc, hist_r, hist_i, theta0,
                             dtheta, static_cast<float*>(y), nullptr, T, P, Kp, 0, 0},
                        C, stream);
}
