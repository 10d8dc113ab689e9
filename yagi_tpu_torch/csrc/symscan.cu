// The symbol synchronizer's scan over a block, two kernels around one loop
// body (symscan.cuh):
//
// * symsync_staged_kernel (K4) replaces yagi_tpu/kernels/symscan.py::_kernel
//   (behind symsync_scan): it is fed the precomputed all-branch stream
//   xs4 [C, n, 4P], groups [re·mf | re·dmf | im·mf | im·dmf], and reads the
//   four values of the selected branch from rows staged in shared memory.
//   Same inputs, same ops: bit-identical to its plain version. Rows too long
//   to stage run symsync_scan_kernel, which reads them from device memory.
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
// ~40 dependent operations per slot, 2·n slots per block, so both are
// latency-bound, not bandwidth- or FLOP-bound (K3 moves ~110 MB a config[1]
// block, ~33 µs of HBM time; K4 2 GB, ~0.64 ms).
//
// K4: memory off the loop's chain. Each slot picks its branch from the state
// the slot before it wrote, so a read of its four values from device memory
// (one channel's rows lie 4P·n floats apart: 32 sectors a warp load, a stream
// L2 cannot hold) put a DRAM round trip on the chain of every slot, ~1,260
// cycles a slot. A channel's rows for samples t0 .. t0 + w are one contiguous
// span of w·4P floats, so a block of `chans` channels splits its warps as
// agc.cu does: warp 0 runs the loops, one thread per channel, reading from a
// tile of w rows per channel in shared memory and parking y and valid there;
// warps 1–4 bring the next tile in by 16-byte cp.async and store the last
// tile's y and valid in coalesced rows; they meet at one barrier a tile. The
// host picks chans and w from P and E (kernels/symscan.py::scan_layout): 8
// channels (C = 1024: 128 blocks, about one per SM) and the widest tile of
// at most 32 rows that double buffers in a block's shared memory; past one
// row of 8 channels fewer channels; past one row of one channel, the direct
// kernel. Three or four tiles a block (smaller, more of them in flight) read
// within 3% of two (PERF.md §6): the loop, not the copies, sets the pace.
//
// K3 gives each channel kLanes = 16 lanes, four groups of kGroup = 4, one
// group per dot, so a lane does a quarter of the four dots' multiply-adds
// and C = 1024 gives 512 warps (the four dots on 4 lanes: 128 warps, ~750
// cycles a slot, PERF.md §6). Lane l of a group sums the taps j ≡ l (mod 4),
// and a 2-level xor butterfly in the group adds (s0 + s1) + (s2 + s3): the
// order branch_outputs reproduces, and a + b = b + a leaves all four lanes
// the same bits. Four shuffles hand the four dots to all 16 lanes, which run
// sym_emit in lockstep. A lane's taps are unrolled and predicated (up to
// kUnroll of them), so its tap and sample loads all issue at once: in a loop
// each load waits on the one before, ~30 cycles a tap on the slot's chain
// (32% of the time, PERF.md §6). Each block of 8 channels stages tiles of
// samples in shared memory by cp.async, double buffered so the next tile's
// copies fly while the loop runs, with pitches chosen so that a warp's tap
// and sample loads hit distinct banks.
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
constexpr int kScanThreads = 32;  // K4 direct: one channel per thread
constexpr int kCopiers = 128;     // K4 staged: threads that copy, warps 1 to 4
constexpr int kStagedThreads = 32 + kCopiers;
constexpr int kGroup = 4;         // K3: lanes per dot (taps j ≡ lane mod 4)
constexpr int kLanes = 4 * kGroup;  // K3: lanes per channel, one group per dot
constexpr int kFusedThreads = 128;  // K3: threads per block (4 warps)
constexpr int kChans = kFusedThreads / kLanes;  // K3: channels per block
constexpr int kTile = 128;        // K3: samples per shared-memory tile
constexpr int kUnroll = 8;        // K3: taps a lane takes unrolled (L ≤ 32)

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

// cp.async: a copy from device to shared memory that does not wait for the
// data; a commit_group closes the copies issued so far, and
// wait_group<N> waits until at most N of the newest groups are in flight.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// K4's tile: rows t0 .. t0 + tn of the block's channels (chans of them from
// c0), each channel's span of tn·4P floats into its w·4P floats of `dst`, by
// the copying threads (`who` of kCopiers), 16 bytes a copy; one commit.
__device__ __forceinline__ void staged_fill(float* dst, const float* __restrict__ xs4, int c0,
                                            int chans, int t0, int tn, int w, int C, int n,
                                            int P, int who) {
  const int row = 4 * P;
  for (int ch = 0; ch < chans && c0 + ch < C; ++ch) {
    const float* src = xs4 + ((size_t)(c0 + ch) * n + t0) * row;
    float* d = dst + (size_t)ch * w * row;
    for (int u = who; u < tn * P; u += kCopiers) cp_async16(d + 4 * u, src + 4 * u);
  }
  cp_async_commit();
}

// The tile's parked y and valid to device memory, channel by channel in
// coalesced spans of tn·E slots.
__device__ __forceinline__ void staged_drain(const float2* ys, const uint8_t* vs,
                                             float2* __restrict__ y, uint8_t* __restrict__ valid,
                                             int c0, int chans, int t0, int tn, int w, int C,
                                             int n, int E, int who) {
  for (int ch = 0; ch < chans && c0 + ch < C; ++ch) {
    const size_t o = ((size_t)(c0 + ch) * n + t0) * E;
    for (int u = who; u < tn * E; u += kCopiers) {
      y[o + u] = ys[ch * w * E + u];
      valid[o + u] = vs[ch * w * E + u];
    }
  }
}

// Shared memory: two tiles (double buffer) of x [chans][w][4P] floats, then
// two of y [chans][w·E] float2, then two of valid [chans][w·E] bytes:
// 2·chans·w·(16P + 9E) bytes (kernels/symscan.py::scan_layout mirrors it).
__global__ void __launch_bounds__(kStagedThreads)
symsync_staged_kernel(const float* __restrict__ xs4, const int64_t* __restrict__ n_valid,
                      const float* __restrict__ st_in, const uint8_t* __restrict__ locked,
                      const float* __restrict__ radj, const float* __restrict__ pll_a,
                      const float* __restrict__ pll_b, float2* __restrict__ y,
                      uint8_t* __restrict__ valid, float* __restrict__ st_out,
                      int32_t* __restrict__ deferred, int C, int n, int P, int E, int k_out,
                      float kinv, int chans, int w) {
  extern __shared__ __align__(16) float smem[];
  const int row = 4 * P;
  const size_t xtile = (size_t)chans * w * row, ytile = (size_t)chans * w * E;
  float* xs = smem;                                          // [2][chans][w][4P]
  float2* ys = reinterpret_cast<float2*>(xs + 2 * xtile);    // [2][chans][w·E]
  uint8_t* vs = reinterpret_cast<uint8_t*>(ys + 2 * ytile);  // [2][chans][w·E]
  const int tid = threadIdx.x;
  const bool copier = tid >= 32;
  const int who = tid - 32;
  const int c0 = blockIdx.x * chans;
  const bool loops = tid < chans && c0 + tid < C;  // this thread runs a channel's loop
  const int c = loops ? c0 + tid : c0;

  yagi::SymParams p{};
  yagi::SymState s{};
  int32_t pend = 0;
  int64_t nv = n;
  if (loops) {
    nv = n_valid ? *n_valid : n;
    p = sym_params(locked, radj, pll_a, pll_b, kinv, c, P, k_out);
    s = yagi::sym_load(st_in, C, c);
  }
  if (copier) {
    staged_fill(xs, xs4, c0, chans, 0, min(w, n), w, C, n, P, who);
    cp_async_wait<0>();
  }
  for (int t0 = 0, buf = 0; t0 < n; t0 += w, buf ^= 1) {
    const int tn = min(w, n - t0);
    // tile `buf` of x is in; the loop has parked the tile before it and reads
    // its x no more; the copiers have stored the tile before that
    __syncthreads();
    if (copier) {
      if (t0 > 0)
        staged_drain(ys + (buf ^ 1) * ytile, vs + (buf ^ 1) * ytile, y, valid, c0, chans,
                     t0 - w, w, w, C, n, E, who);
      if (t0 + w < n)
        staged_fill(xs + (buf ^ 1) * xtile, xs4, c0, chans, t0 + w, min(w, n - t0 - w), w, C,
                    n, P, who);
      cp_async_wait<0>();
    } else if (loops) {
      const float* xr = xs + buf * xtile + (size_t)tid * w * row;
      float2* yo = ys + buf * ytile + (size_t)tid * w * E;
      uint8_t* vo = vs + buf * ytile + (size_t)tid * w * E;
      for (int tt = 0; tt < tn; ++tt, xr += row) {
        const bool vs_t = t0 + tt < nv;
        for (int e = 0; e < E; ++e) {
          const int bb = yagi::sym_branch(s, P);
          float yr, yi;
          const bool act = yagi::sym_emit(s, p, vs_t, xr[bb], xr[P + bb], xr[2 * P + bb],
                                          xr[3 * P + bb], yr, yi);
          yo[tt * E + e] = make_float2(yr, yi);
          vo[tt * E + e] = act;
        }
        pend += yagi::sym_pending(s, P, vs_t);
        yagi::sym_wrap(s, P, vs_t);
      }
    }
  }
  __syncthreads();  // the last tile's y is parked
  if (copier) {
    const int last = (n - 1) / w;
    staged_drain(ys + (last & 1) * ytile, vs + (last & 1) * ytile, y, valid, c0, chans,
                 last * w, n - last * w, w, C, n, E, who);
  }
  if (loops) {
    yagi::sym_store(st_out, C, c, s);
    deferred[c] = pend;
  }
}

// K3's tile: xa[c0 + r][t0 .. t0 + w) of the block's kChans channels into
// rows of spitch float2, by asynchronous copies (zeros past C); then one
// commit. Neighbouring threads copy neighbouring samples of one row.
__device__ __forceinline__ void fused_fill(float2* dst, const float2* __restrict__ xa, int c0,
                                           int t0, int w, int C, int nx, int spitch) {
  for (int i = threadIdx.x; i < kChans * w; i += kFusedThreads) {
    const int r = i / w, col = i % w;
    float2* d = dst + r * spitch + col;
    if (c0 + r < C && t0 + col < nx) {
      cp_async8(d, xa + (size_t)(c0 + r) * nx + t0 + col);
    } else {
      *d = make_float2(0.0f, 0.0f);
    }
  }
  cp_async_commit();
}

// Shared memory: two copies of the taps, [cstride] floats each (copy k for
// the channels ch ≡ k (mod 2), the two of a warp), branch i's mf row at
// i·rpitch and its dmf row fpitch after it; then two tiles (double buffer)
// of [kChans][spitch] float2 samples.
//
// Banks: a warp's 32 lanes are 2 channels × 4 dots × 4 taps. Its tap loads
// touch 16 words (mf and dmf, taps j ≡ lane) per channel pair: cstride ≡ 8,
// rpitch ≡ 16, fpitch ≡ 4 (mod 32) put channel k's 8 words on banks
// 8k + 16·(i mod 2) + [0, 8), so the two channels never share a bank, for any
// two branches. Its sample loads touch 16 words (re and im, 4 taps, 2 rows):
// spitch ≡ 4 (mod 16) float2 puts them on 16 distinct banks.
__global__ void __launch_bounds__(kFusedThreads)
symsync_fused_kernel(const float2* __restrict__ xa, const float* __restrict__ g,
                     const int64_t* __restrict__ n_valid, const float* __restrict__ st_in,
                     const uint8_t* __restrict__ locked, const float* __restrict__ radj,
                     const float* __restrict__ pll_a, const float* __restrict__ pll_b,
                     float2* __restrict__ y, uint8_t* __restrict__ valid,
                     float* __restrict__ st_out, int32_t* __restrict__ deferred, int C, int n,
                     int L, int P, int E, int k_out, float kinv, int fpitch, int rpitch,
                     int cstride, int spitch) {
  extern __shared__ float smem[];
  float* gs = smem;
  float2* xs = reinterpret_cast<float2*>(gs + 2 * cstride);

  const int tid = threadIdx.x;
  const int ch = tid / kLanes;             // channel in the block
  const int grp = (tid % kLanes) / kGroup;  // dot: 0 re·mf, 1 re·dmf, 2 im·mf, 3 im·dmf
  const int lane = tid % kGroup;           // taps j ≡ lane (mod kGroup)
  const int head = (tid % 32) & ~(kLanes - 1);  // the channel's first lane in the warp
  const int c0 = blockIdx.x * kChans;
  const int c = c0 + ch;
  const bool live = c < C;  // a dead channel runs as the last one, for the shuffles
  const int nx = n + L;
  const int64_t nv = n_valid ? *n_valid : n;

  for (int i = tid; i < 2 * P * L; i += kFusedThreads) {
    const int row = i / L, j = i % L;  // g's row: mf of branch row, then dmf of row − P
    float* d = gs + (row % P) * rpitch + (row / P) * fpitch + j;
    d[0] = g[i];
    d[cstride] = g[i];
  }
  const float* taps = gs + (ch & 1) * cstride + (grp & 1) * fpitch;
  const int plane = grp >> 1;
  const yagi::SymParams p =
      sym_params(locked, radj, pll_a, pll_b, kinv, live ? c : C - 1, P, k_out);
  yagi::SymState s = yagi::sym_load(st_in, C, live ? c : C - 1);
  int32_t pend = 0;

  fused_fill(xs, xa, c0, 0, min(kTile, n) + L, C, nx, spitch);
  for (int t0 = 0, buf = 0; t0 < n; t0 += kTile, buf ^= 1) {
    const int tn = min(kTile, n - t0);
    if (t0 + kTile < n) {  // the next tile flies while this one runs
      fused_fill(xs + (buf ^ 1) * kChans * spitch, xa, c0, t0 + kTile,
                 min(kTile, n - t0 - kTile) + L, C, nx, spitch);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and the taps) are in
    // slot t reads xa[t+1 .. t+L]: this lane's plane, as floats
    const float* px =
        reinterpret_cast<const float*>(xs + buf * kChans * spitch + ch * spitch + 1) + plane;
    for (int tt = 0; tt < tn; ++tt) {
      const int t = t0 + tt;
      const bool vs = t < nv;
      for (int e = 0; e < E; ++e) {
        const float* gt = taps + yagi::sym_branch(s, P) * rpitch;
        // this lane's taps j ≡ lane (mod kGroup), first product then adds,
        // each rounded, then a 2-level butterfly in the dot's group: the
        // order branch_outputs reproduces in torch
        // (unrolled and predicated up to kUnroll taps a lane, so the loads
        // all issue before the adds; a loop takes the taps past that)
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int j = lane + k * kGroup;
          if (j < L) {
            const float prod = __fmul_rn(gt[j], px[2 * (tt + j)]);
            acc = k == 0 ? prod : __fadd_rn(acc, prod);
          }
        }
        for (int j = lane + kUnroll * kGroup; j < L; j += kGroup)
          acc = __fadd_rn(acc, __fmul_rn(gt[j], px[2 * (tt + j)]));
#pragma unroll
        for (int off = 1; off < kGroup; off <<= 1)
          acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
        // every lane of the channel takes the four dots, and runs the loop
        const float mr = __shfl_sync(kFull, acc, head);
        const float dr = __shfl_sync(kFull, acc, head + kGroup);
        const float mi = __shfl_sync(kFull, acc, head + 2 * kGroup);
        const float di = __shfl_sync(kFull, acc, head + 3 * kGroup);
        float yr, yi;
        const bool act = yagi::sym_emit(s, p, vs, mr, dr, mi, di, yr, yi);
        if (live && tid % kLanes == 0) {
          const size_t o = ((size_t)c * n + t) * E + e;
          y[o] = make_float2(yr, yi);
          valid[o] = act;
        }
      }
      pend += yagi::sym_pending(s, P, vs);
      yagi::sym_wrap(s, P, vs);
    }
    __syncthreads();  // this tile is read before the next fill overwrites it
  }
  if (live && tid % kLanes == 0) {
    yagi::sym_store(st_out, C, c, s);
    deferred[c] = pend;
  }
}

// The smallest pitch ≥ len with pitch ≡ rem (mod mod).
int pitch(int len, int rem, int mod) { return len + ((rem - len) % mod + mod) % mod; }

struct FusedLayout {
  int fpitch, rpitch, cstride, spitch, smem;
};

FusedLayout fused_layout(int L, int P) {
  FusedLayout f;
  f.fpitch = pitch(L, 4, 32);
  f.rpitch = pitch(f.fpitch + L, 16, 32);
  f.cstride = pitch(P * f.rpitch, 8, 32);
  f.spitch = pitch(kTile + L, 4, 16);
  f.smem = (int)(sizeof(float) * 2 * f.cstride + sizeof(float2) * 2 * kChans * f.spitch);
  return f;
}

}  // namespace

// K4, the direct instance. xs4: [C, n, 4P] float32; n_valid: device int64
// or null; st_in/st_out: [9, C] float32; locked: [C] uint8; radj: [C]
// float32; pll_a/pll_b: [3] float32 on the device; y: [C, n, E] complex64;
// valid: [C, n, E] uint8; deferred: [C] int32. Launches on `stream`; returns
// the launch's CUDA error (0 on success).
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

// K4, the staged instance: the arguments of yagi_symsync_scan (xs4 16-byte
// aligned), then the layout, `chans` channels a block (1 to 32) and tiles of
// w rows, which take 2·chans·w·(16P + 9E) bytes of shared memory.
extern "C" int yagi_symsync_scan_staged(const float* xs4, const int64_t* n_valid,
                                        const float* st_in, const uint8_t* locked,
                                        const float* radj, const float* pll_a,
                                        const float* pll_b, void* y, uint8_t* valid,
                                        float* st_out, int32_t* deferred, int C, int n, int P,
                                        int E, int k_out, float kinv, int chans, int w,
                                        void* stream) {
  if (chans < 1 || chans > 32 || w < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * chans * w * (16 * (size_t)P + 9 * (size_t)E);
  // past 48 KB, shared memory is dynamic only and must be allowed first
  cudaError_t err = cudaFuncSetAttribute(symsync_staged_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (C + chans - 1) / chans;
  symsync_staged_kernel<<<blocks, kStagedThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xs4, n_valid, st_in, locked, radj, pll_a, pll_b, static_cast<float2*>(y), valid, st_out,
      deferred, C, n, P, E, k_out, kinv, chans, w);
  return (int)cudaGetLastError();
}

// K3. xa: [C, n + L] complex64, the L-sample window then the block; g:
// [2P, L] float32 with g[i, j] = [mf; dmf][i, L−1−j], applied to xa[t+1+j];
// the rest as yagi_symsync_scan. Shared memory grows with L and P (~42 KB
// at L = 28, P = 32); past the block's limit the attribute call fails and
// its error is returned.
extern "C" int yagi_symsync_fused(const void* xa, const float* g, const int64_t* n_valid,
                                  const float* st_in, const uint8_t* locked, const float* radj,
                                  const float* pll_a, const float* pll_b, void* y,
                                  uint8_t* valid, float* st_out, int32_t* deferred, int C,
                                  int n, int L, int P, int E, int k_out, float kinv,
                                  void* stream) {
  const FusedLayout f = fused_layout(L, P);
  cudaError_t err = cudaFuncSetAttribute(symsync_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, f.smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (C + kChans - 1) / kChans;
  symsync_fused_kernel<<<blocks, kFusedThreads, f.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(xa), g, n_valid, st_in, locked, radj, pll_a, pll_b,
      static_cast<float2*>(y), valid, st_out, deferred, C, n, L, P, E, k_out, kinv, f.fpitch,
      f.rpitch, f.cstride, f.spitch);
  return (int)cudaGetLastError();
}
