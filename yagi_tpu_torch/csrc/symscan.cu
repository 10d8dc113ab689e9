// The symbol synchronizer's scan over a block, two kernels around one loop
// body (symscan.cuh):
//
// * symsync_scan_kernel (K4) replaces yagi_tpu/kernels/symscan.py::_kernel
//   (behind symsync_scan): it is fed the precomputed all-branch stream
//   xs4 [C, n, 4P], groups [re·mf | re·dmf | im·mf | im·dmf], and reads the
//   four values of the selected branch. Same inputs, same ops: bit-identical
//   to its plain version.
// * symsync_fused_kernel (K3) replaces symscan.py::_kernel_fused (behind
//   symsync_scan_fused): it computes, per emission, only the selected
//   branch's four dots (re·mf, re·dmf, im·mf, im·dmf over L taps) from the
//   channel's raw samples. The TPU kernel forms all 2P branches as MXU dots
//   and picks one with a one-hot [4P, C] reduce, a stand-in for a gather;
//   here the pick is an index into the taps. The dots are summed in a fixed
//   order without FMA (per lane, then an xor butterfly), the order that
//   kernels/symscan.py::branch_outputs reproduces: K3 is bit-identical to
//   its plain version and to K4 on branch_outputs' stream. Through the
//   loop's feedback, dots an ulp apart would part whole channels.
//
// What bounds them on an H100: the loop is serial per channel, one chain of
// ~40 dependent operations per slot, 2·n slots per block; with one thread
// (K4) or four lanes (K3) per channel, C = 1024 gives 32 or 128 warps, so
// both are latency-bound, not bandwidth- or FLOP-bound. K3 splits each
// channel's dots over kLanes lanes (taps j ≡ lane mod kLanes, then an xor
// butterfly, which leaves all lanes the same bits since a + b = b + a, so
// the four run the loop in lockstep) and stages each 8-channel tile's samples in shared memory:
// coalesced loads along t, a row pitch ≡ 4 (mod 32) words so the 8 channels
// × 4 lanes of a warp read 32 distinct banks. K4 reads its four values
// straight from device memory: 2 GB per config[1] block of which each slot
// touches four 4-byte words.
//
// Outputs: y [C, n, E] complex64 (mr/k, mi/k, zero for an empty slot), valid
// [C, n, E] uint8 (bool), state' [9, C] into a fresh array, and deferred [C]
// int32, the samples after whose E slots an emission was still due. n_valid is read
// from a device int64 (or n when null): samples at t ≥ n_valid neither emit
// nor wrap.

#include <cuda_runtime.h>
#include <stdint.h>

#include "symscan.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kScanThreads = 32;  // K4: one channel per thread
constexpr int kLanes = 4;         // K3: lanes per channel
constexpr int kChans = 32 / kLanes;  // K3: channels per block (one warp)
constexpr int kTile = 128;        // K3: samples per shared-memory tile

__device__ __forceinline__ yagi::SymParams sym_params(const uint8_t* locked, const float* radj,
                                                      const float* pll_a, const float* pll_b,
                                                      float kinv, int c, int P, int k_out) {
  return yagi::SymParams{pll_a[1], pll_b[0], radj[c], kinv, locked[c] == 0, P, k_out};
}

__global__ void __launch_bounds__(kScanThreads)
symsync_scan_kernel(const float* __restrict__ xs4, const int64_t* __restrict__ n_valid,
                    const float* __restrict__ st_in, const uint8_t* __restrict__ locked,
                    const float* __restrict__ radj, const float* __restrict__ pll_a,
                    const float* __restrict__ pll_b, float2* __restrict__ y,
                    uint8_t* __restrict__ valid, float* __restrict__ st_out,
                    int32_t* __restrict__ deferred, int C, int n, int P, int E, int k_out,
                    float kinv) {
  const int c = blockIdx.x * kScanThreads + threadIdx.x;
  if (c >= C) return;
  const int64_t nv = n_valid ? *n_valid : n;
  const yagi::SymParams p = sym_params(locked, radj, pll_a, pll_b, kinv, c, P, k_out);
  yagi::SymState s = yagi::sym_load(st_in, C, c);
  const float* row = xs4 + (size_t)c * n * 4 * P;
  size_t o = (size_t)c * n * E;
  int32_t pend = 0;
  for (int t = 0; t < n; ++t, row += 4 * P) {
    const bool vs = t < nv;
    for (int e = 0; e < E; ++e, ++o) {
      const int bb = yagi::sym_branch(s, P);
      float yr, yi;
      const bool act = yagi::sym_emit(s, p, vs, row[bb], row[P + bb], row[2 * P + bb],
                                      row[3 * P + bb], yr, yi);
      y[o] = make_float2(yr, yi);
      valid[o] = act;
    }
    pend += yagi::sym_pending(s, P, vs);
    yagi::sym_wrap(s, P, vs);
  }
  yagi::sym_store(st_out, C, c, s);
  deferred[c] = pend;
}

// Shared memory: taps [2P][gpitch], then the re and im planes of the tile,
// [kChans][pitch] each.
__global__ void __launch_bounds__(32)
symsync_fused_kernel(const float2* __restrict__ xa, const float* __restrict__ g,
                     const int64_t* __restrict__ n_valid, const float* __restrict__ st_in,
                     const uint8_t* __restrict__ locked, const float* __restrict__ radj,
                     const float* __restrict__ pll_a, const float* __restrict__ pll_b,
                     float2* __restrict__ y, uint8_t* __restrict__ valid,
                     float* __restrict__ st_out, int32_t* __restrict__ deferred, int C, int n,
                     int L, int P, int E, int k_out, float kinv, int gpitch, int pitch) {
  extern __shared__ float smem[];
  float* gs = smem;
  float* xr = gs + 2 * P * gpitch;
  float* xi = xr + kChans * pitch;

  const int tid = threadIdx.x;
  const int ch = tid / kLanes;
  const int lane = tid % kLanes;
  const int c0 = blockIdx.x * kChans;
  const int c = c0 + ch;
  const bool live = c < C;  // a dead channel runs as the last one, for the shuffles
  const int nx = n + L;
  const int64_t nv = n_valid ? *n_valid : n;

  for (int i = tid; i < 2 * P * L; i += 32) gs[(i / L) * gpitch + i % L] = g[i];
  const yagi::SymParams p =
      sym_params(locked, radj, pll_a, pll_b, kinv, live ? c : C - 1, P, k_out);
  yagi::SymState s = yagi::sym_load(st_in, C, live ? c : C - 1);
  int32_t pend = 0;

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int tn = min(kTile, n - t0);
    const int w = tn + L;  // xa[t0 .. t0+tn+L): slot t reads xa[t+1 .. t+L]
    __syncthreads();  // the previous tile is read (and the taps written)
    for (int i = tid; i < kChans * w; i += 32) {
      const int r = i / w, col = i % w;
      float2 v = make_float2(0.0f, 0.0f);
      if (c0 + r < C && t0 + col < nx) v = xa[(size_t)(c0 + r) * nx + t0 + col];
      xr[r * pitch + col] = v.x;
      xi[r * pitch + col] = v.y;
    }
    __syncthreads();
    const float* pr = xr + ch * pitch + 1;
    const float* pi = xi + ch * pitch + 1;
    for (int tt = 0; tt < tn; ++tt) {
      const int t = t0 + tt;
      const bool vs = t < nv;
      for (int e = 0; e < E; ++e) {
        const int bb = yagi::sym_branch(s, P);
        const float* gm = gs + bb * gpitch;
        const float* gd = gs + (P + bb) * gpitch;
        // this lane's taps j ≡ lane (mod kLanes), first product then adds,
        // each rounded: the order branch_outputs reproduces in torch
        float mr = 0.0f, dr = 0.0f, mi = 0.0f, di = 0.0f;
        if (lane < L) {
          const float a = pr[tt + lane], b = pi[tt + lane];
          mr = __fmul_rn(gm[lane], a);
          dr = __fmul_rn(gd[lane], a);
          mi = __fmul_rn(gm[lane], b);
          di = __fmul_rn(gd[lane], b);
        }
        for (int j = lane + kLanes; j < L; j += kLanes) {
          const float a = pr[tt + j], b = pi[tt + j];
          mr = __fadd_rn(mr, __fmul_rn(gm[j], a));
          dr = __fadd_rn(dr, __fmul_rn(gd[j], a));
          mi = __fadd_rn(mi, __fmul_rn(gm[j], b));
          di = __fadd_rn(di, __fmul_rn(gd[j], b));
        }
#pragma unroll
        for (int off = 1; off < kLanes; off <<= 1) {
          mr = __fadd_rn(mr, __shfl_xor_sync(kFull, mr, off));
          dr = __fadd_rn(dr, __shfl_xor_sync(kFull, dr, off));
          mi = __fadd_rn(mi, __shfl_xor_sync(kFull, mi, off));
          di = __fadd_rn(di, __shfl_xor_sync(kFull, di, off));
        }
        float yr, yi;
        const bool act = yagi::sym_emit(s, p, vs, mr, dr, mi, di, yr, yi);
        if (live && lane == 0) {
          const size_t o = ((size_t)c * n + t) * E + e;
          y[o] = make_float2(yr, yi);
          valid[o] = act;
        }
      }
      pend += yagi::sym_pending(s, P, vs);
      yagi::sym_wrap(s, P, vs);
    }
  }
  if (live && lane == 0) {
    yagi::sym_store(st_out, C, c, s);
    deferred[c] = pend;
  }
}

// The smallest pitch ≥ len with pitch ≡ 4 (mod 32).
int bank_pitch(int len) { return len + ((4 - len) % 32 + 32) % 32; }

}  // namespace

// K4. xs4: [C, n, 4P] float32; n_valid: device int64 or null; st_in/st_out:
// [9, C] float32; locked: [C] uint8; radj: [C] float32; pll_a/pll_b: [3]
// float32 on the device; y: [C, n, E] complex64; valid: [C, n, E] uint8;
// deferred: [C] int32. Launches on `stream`; returns the launch's CUDA error
// (0 on success).
extern "C" int yagi_symsync_scan(const float* xs4, const int64_t* n_valid, const float* st_in,
                                 const uint8_t* locked, const float* radj, const float* pll_a,
                                 const float* pll_b, void* y, uint8_t* valid, float* st_out,
                                 int32_t* deferred, int C, int n, int P, int E, int k_out,
                                 float kinv, void* stream) {
  const int blocks = (C + kScanThreads - 1) / kScanThreads;
  symsync_scan_kernel<<<blocks, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xs4, n_valid, st_in, locked, radj, pll_a, pll_b, static_cast<float2*>(y), valid, st_out,
      deferred, C, n, P, E, k_out, kinv);
  return (int)cudaGetLastError();
}

// K3. xa: [C, n + L] complex64, the L-sample window then the block; g:
// [2P, L] float32 with g[i, j] = [mf; dmf][i, L−1−j], applied to xa[t+1+j];
// the rest as yagi_symsync_scan. Shared memory grows with L and P (~20 KB
// at L = 28, P = 32); past the block's limit the attribute call fails and
// its error is returned.
extern "C" int yagi_symsync_fused(const void* xa, const float* g, const int64_t* n_valid,
                                  const float* st_in, const uint8_t* locked, const float* radj,
                                  const float* pll_a, const float* pll_b, void* y,
                                  uint8_t* valid, float* st_out, int32_t* deferred, int C,
                                  int n, int L, int P, int E, int k_out, float kinv,
                                  void* stream) {
  const int smem =
      (int)sizeof(float) * (2 * P * bank_pitch(L) + 2 * kChans * bank_pitch(kTile + L));
  cudaError_t err = cudaFuncSetAttribute(symsync_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (C + kChans - 1) / kChans;
  symsync_fused_kernel<<<blocks, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(xa), g, n_valid, st_in, locked, radj, pll_a, pll_b,
      static_cast<float2*>(y), valid, st_out, deferred, C, n, L, P, E, k_out, kinv,
      bank_pitch(L), bank_pitch(kTile + L));
  return (int)cudaGetLastError();
}
