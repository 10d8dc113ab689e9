// Fused M = 64 polyphase analysis channelizer (BASELINE config[4]).
//
// Replaces yagi_tpu/kernels/channelizer.py::_chan_kernel (the Pallas TPU
// kernel of FusedChannelizer). For analyzer step t and channel k:
//   u_c[t]  = Σ_{j<p} taps[j, c] · s_c[t − j]          (branch FIR, fp32 FMA)
//   y[t, k] = Σ_{c<64} W'[c, k] · u_c[t]                (64-point IDFT)
// with W' = hr + j·hi, the first 64×64 block of the block-diagonal tables of
// channelizer_tables (yagi_tpu_torch/kernels/channelizer.py). The tables keep
// the TPU kernel's lane order, lane c carrying branch b(c) = (64 − c) mod 64,
// so the commutator is plain indexing:
//   s_c[i] = x[(i − 1)·64 + c]  (c ≥ 1),   s_0[i] = x[i·64].
// Samples before the block come from the history, the previous block's last
// nh = halo·128 ≥ 64·p samples (zeros at stream start).
//
// What bounds it on an H100. Per step the IDFT takes 64×64 complex MACs
// (32,768 FLOP) and the branch FIRs 64·p·4 (2,048 at p = 8), against 1,024
// bytes of traffic (64 complex samples in, 64 out): ~34 FLOP/byte, above the
// card's fp32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s ≈ 20). A direct DFT
// is therefore bound by its FMAs, not by device memory.
//
// Design. One block takes kSteps = 64 steps. It stages its input M-blocks plus
// p blocks of left halo (read from the history for the stream's first tile,
// from x otherwise), the taps and W' in shared memory (~104 KB at p = 8: two
// blocks per SM, so the size is set as dynamic shared memory). Each thread
// computes branch outputs for one lane into u, stored lane-major; then the
// [64, 64] × [64, 64] complex product runs register-blocked, each thread
// holding 4 steps × 4 channels of re/im accumulators, so per lane c two
// 16-byte loads of u and two of W' feed 64 FMAs. Threads map to channels
// within a step row, so the step-major [T, 64] stores are coalesced float4s.
// The TPU kernel's per-tile halo arrays and its [R2, 256] @ [256, 128] stacked
// dot are Mosaic devices and are not carried over. An in-kernel radix-4/8 FFT
// (fewer FLOP) or tensor cores with a 3×TF32 split are later work: TF32 alone
// would miss the 1e-4 bound. Every precision mode runs this fp32 kernel. A
// bank of more than kTapTile = 64 taps a branch runs a second instance that
// walks the taps in tiles of 64, so the shared memory does not grow with p.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kM = 64;         // channels
constexpr int kLane = 128;     // table row width: two copies of the 64 lanes
constexpr int kSteps = 64;     // analyzer steps per block
constexpr int kThreads = 256;  // a multiple of kM: each thread keeps one lane
constexpr int kUPitch = kSteps + 4;  // u row pitch: 16-byte rows, fewer bank conflicts
constexpr int kTapTile = 64;   // taps a branch staged at once; p beyond it runs in tiles

size_t smem_bytes(int p) {
  // W' (re, im), u (re, im), p taps, and kSteps + p input M-blocks (re, im);
  // the tiled instance stages kTapTile taps at a time
  return sizeof(float) *
         (2 * kM * kM + 2 * kM * kUPitch + (size_t)p * kM + 2 * (size_t)(kSteps + p) * kM);
}

// The 64-point IDFT of a block's kSteps steps, u [64][kUPitch] (re, im) times
// W' [64][64] (re, im), register-blocked, and the step-major stores.
__device__ __forceinline__ void idft_store(const float* s_wr, const float* s_wi,
                                           const float* s_ur, const float* s_ui,
                                           float* __restrict__ yr, float* __restrict__ yi,
                                           int t0, int T) {
  const int tid = threadIdx.x;
  // IDFT: thread (ty, tx) owns steps 4·ty .. 4·ty + 3 and channels 4·tx .. 4·tx + 3
  const int tx = tid % 16, ty = tid / 16;
  float accr[4][4], acci[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) accr[a][b] = acci[a][b] = 0.0f;

#pragma unroll 4
  for (int c = 0; c < kM; ++c) {
    const float4 wr4 = *reinterpret_cast<const float4*>(&s_wr[c * kM + 4 * tx]);
    const float4 wi4 = *reinterpret_cast<const float4*>(&s_wi[c * kM + 4 * tx]);
    const float4 ur4 = *reinterpret_cast<const float4*>(&s_ur[c * kUPitch + 4 * ty]);
    const float4 ui4 = *reinterpret_cast<const float4*>(&s_ui[c * kUPitch + 4 * ty]);
    const float wr[4] = {wr4.x, wr4.y, wr4.z, wr4.w};
    const float wi[4] = {wi4.x, wi4.y, wi4.z, wi4.w};
    const float ur[4] = {ur4.x, ur4.y, ur4.z, ur4.w};
    const float ui[4] = {ui4.x, ui4.y, ui4.z, ui4.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        accr[a][b] = fmaf(ur[a], wr[b], accr[a][b]);
        accr[a][b] = fmaf(-ui[a], wi[b], accr[a][b]);
        acci[a][b] = fmaf(ur[a], wi[b], acci[a][b]);
        acci[a][b] = fmaf(ui[a], wr[b], acci[a][b]);
      }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = t0 + 4 * ty + a;
    if (t < T) {
      const size_t at = (size_t)t * kM + 4 * tx;
      *reinterpret_cast<float4*>(yr + at) =
          make_float4(accr[a][0], accr[a][1], accr[a][2], accr[a][3]);
      *reinterpret_cast<float4*>(yi + at) =
          make_float4(acci[a][0], acci[a][1], acci[a][2], acci[a][3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
channelizer_fp32_kernel(const float* __restrict__ xr, const float* __restrict__ xi,  // [T·64]
                        const float* __restrict__ taps,                            // [p, 128]
                        const float* __restrict__ hr, const float* __restrict__ hi,  // [128, 128]
                        const float* __restrict__ hist_r,
                        const float* __restrict__ hist_i,  // [nh]
                        float* __restrict__ yr, float* __restrict__ yi,  // [T, 64]
                        int T, int p, int nh) {
  extern __shared__ __align__(16) float smem[];
  float* s_wr = smem;                         // [64][64]  W'[c][k]
  float* s_wi = s_wr + kM * kM;
  float* s_ur = s_wi + kM * kM;               // [64][kUPitch]  u_c[t0 + s] at [c][s]
  float* s_ui = s_ur + kM * kUPitch;
  float* s_taps = s_ui + kM * kUPitch;        // [p][64]
  float* s_xr = s_taps + p * kM;              // [kSteps + p][64]  M-block X[t0 − p + r]
  float* s_xi = s_xr + (kSteps + p) * kM;

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kSteps;

  for (int i = tid; i < kM * kM; i += kThreads) {
    const int src = (i / kM) * kLane + i % kM;
    s_wr[i] = hr[src];
    s_wi[i] = hi[src];
  }
  for (int i = tid; i < p * kM; i += kThreads) s_taps[i] = taps[(i / kM) * kLane + i % kM];
  // row r, lane c holds x[g], g = (t0 − p + r)·64 + c; g < 0 is history,
  // whose last sample is x[−1]; past the end of the stream reads zeros
  const int64_t g0 = (int64_t)(t0 - p) * kM;
  const int64_t n = (int64_t)T * kM;
  for (int i = tid; i < (kSteps + p) * kM; i += kThreads) {
    const int64_t g = g0 + i;
    float vr = 0.0f, vi = 0.0f;
    if (g < 0) {
      vr = hist_r[nh + g];
      vi = hist_i[nh + g];
    } else if (g < n) {
      vr = xr[g];
      vi = xi[g];
    }
    s_xr[i] = vr;
    s_xi[i] = vi;
  }
  __syncthreads();

  {  // branch FIRs: s_c[t0 + s − j] = X[t0 + s − j − lag][c] sits in row s − j − lag + p
    const int c = tid % kM;
    const int lag = c == 0 ? 0 : 1;
    for (int s = tid / kM; s < kSteps; s += kThreads / kM) {
      float ar = 0.0f, ai = 0.0f;
      for (int j = 0; j < p; ++j) {
        const int at = (s - j - lag + p) * kM + c;
        const float tap = s_taps[j * kM + c];
        ar = fmaf(tap, s_xr[at], ar);
        ai = fmaf(tap, s_xi[at], ai);
      }
      s_ur[c * kUPitch + s] = ar;
      s_ui[c * kUPitch + s] = ai;
    }
  }
  __syncthreads();

  idft_store(s_wr, s_wi, s_ur, s_ui, yr, yi, t0, T);
}

// The instance for p > kTapTile: the taps and the input rows they reach are
// staged kTapTile taps at a time, and u accumulates in shared memory across
// the tiles, in the same tap order as the one-pass instance.
__global__ void __launch_bounds__(kThreads)
channelizer_tiled_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                         const float* __restrict__ taps, const float* __restrict__ hr,
                         const float* __restrict__ hi, const float* __restrict__ hist_r,
                         const float* __restrict__ hist_i, float* __restrict__ yr,
                         float* __restrict__ yi, int T, int p, int nh) {
  extern __shared__ __align__(16) float smem[];
  float* s_wr = smem;
  float* s_wi = s_wr + kM * kM;
  float* s_ur = s_wi + kM * kM;
  float* s_ui = s_ur + kM * kUPitch;
  float* s_taps = s_ui + kM * kUPitch;        // [kTapTile][64]
  float* s_xr = s_taps + kTapTile * kM;       // [kSteps + kTapTile][64]
  float* s_xi = s_xr + (kSteps + kTapTile) * kM;

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kSteps;
  for (int i = tid; i < kM * kM; i += kThreads) {
    const int src = (i / kM) * kLane + i % kM;
    s_wr[i] = hr[src];
    s_wi[i] = hi[src];
  }
  const int64_t n = (int64_t)T * kM;
  const int c = tid % kM;
  const int lag = c == 0 ? 0 : 1;
  for (int j0 = 0; j0 < p; j0 += kTapTile) {
    const int pn = min(kTapTile, p - j0);
    if (j0) __syncthreads();  // the last tile's taps and rows are read
    for (int i = tid; i < pn * kM; i += kThreads)
      s_taps[i] = taps[(j0 + i / kM) * kLane + i % kM];
    // row r, lane c holds x[g], g = (t0 − j0 − kTapTile + r)·64 + c; history
    // below 0 (rows deeper than any tap reaches read as zero), zeros past the end
    const int64_t g0 = (int64_t)(t0 - j0 - kTapTile) * kM;
    for (int i = tid; i < (kSteps + kTapTile) * kM; i += kThreads) {
      const int64_t g = g0 + i;
      float vr = 0.0f, vi = 0.0f;
      if (g < 0) {
        if (nh + g >= 0) {
          vr = hist_r[nh + g];
          vi = hist_i[nh + g];
        }
      } else if (g < n) {
        vr = xr[g];
        vi = xi[g];
      }
      s_xr[i] = vr;
      s_xi[i] = vi;
    }
    __syncthreads();
    // s_c[t0 + s − j] for j = j0 + jj sits in row s − jj − lag + kTapTile
    for (int s = tid / kM; s < kSteps; s += kThreads / kM) {
      float ar = j0 ? s_ur[c * kUPitch + s] : 0.0f;
      float ai = j0 ? s_ui[c * kUPitch + s] : 0.0f;
      for (int jj = 0; jj < pn; ++jj) {
        const int at = (s - jj - lag + kTapTile) * kM + c;
        const float tap = s_taps[jj * kM + c];
        ar = fmaf(tap, s_xr[at], ar);
        ai = fmaf(tap, s_xi[at], ai);
      }
      s_ur[c * kUPitch + s] = ar;
      s_ui[c * kUPitch + s] = ai;
    }
  }
  __syncthreads();
  idft_store(s_wr, s_wi, s_ur, s_ui, yr, yi, t0, T);
}

}  // namespace

// Planar fp32 analysis of T steps. xr/xi [T·64]; taps [p, 128], hr/hi
// [128, 128] from channelizer_tables; hist_r/hist_i [nh], nh ≥ 64·p; yr/yi
// [T, 64] step-major, 16-byte aligned. T ≥ 1, T·64 < 2^31, p ≥ 1 (past 64
// taps a branch the tiled instance runs).
// Launches on `stream` and returns the CUDA error of the launch (0 on success).
extern "C" int yagi_channelizer_fp32(const float* xr, const float* xi, const float* taps,
                                     const float* hr, const float* hi, const float* hist_r,
                                     const float* hist_i, float* yr, float* yi, int T, int p,
                                     int nh, void* stream) {
  const bool tiled = p > kTapTile;
  const size_t smem = smem_bytes(tiled ? kTapTile : p);
  const auto kernel = tiled ? channelizer_tiled_kernel : channelizer_fp32_kernel;
  // past 48 KB, shared memory is dynamic only and must be allowed first
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kSteps - 1) / kSteps);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, taps, hr, hi, hist_r, hist_i, yr, yi, T, p, nh);
  return (int)cudaGetLastError();
}
