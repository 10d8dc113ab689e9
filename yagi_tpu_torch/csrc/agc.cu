// The AGC's gain loop over a block, one loop thread per channel (agc_scan).
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
// dependent chain g → y → |y|² → y2' → logf → expf → g per sample, so one
// thread per channel is given (2048 channels: 64 warps on 528 schedulers) and
// the time is n × the cycles of a sample, where the 134 MB in and out take
// ~40 µs of bandwidth. PERF.md §6 has the chain's length from the SASS and
// the measured times. Where the squelch is disabled (QamRx's AGC) the RSSI's
// log10f and the FSM are skipped.
//
// Design: memory out of the chain. With each thread walking its own row of x
// and y, a warp's load touched 32 rows, one 32-byte sector each, and a
// one-warp block waited a DRAM round trip every few samples with nothing else
// to run. Here a block owns kChans channels and splits its warps: warp 0
// runs the loops, one thread per channel, out of shared memory (rows of
// kTile + 1 float2, so the loop threads fall on distinct banks) and parks y
// in shared memory; the other warps copy. While the loop runs slab k they
// store slab k − 1's y in coalesced rows and bring slab k + 1 of x in with
// coalesced cp.async, so the loop warp meets them at one barrier a slab and
// neither loads nor stores (with every thread copying between two barriers a
// slab, the loop waited ~7% of its time on the copies, PERF.md §6). The
// arithmetic is the same, op for op.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChans = 8;      // channels per block, one loop thread each (PERF.md §6)
constexpr int kCopiers = 128;  // threads that copy: warps 1 to 4
constexpr int kThreads = 32 + kCopiers;
constexpr int kTile = 128;     // samples per slab
constexpr int kPitch = kTile + 1;  // float2 per row: the loop threads on distinct banks
constexpr int kSlab = kChans * kPitch;
constexpr int kSmem = 4 * kSlab * (int)sizeof(float2);  // x and y, each double buffered
static_assert(kChans <= 32, "the loop threads are one warp");

// AgcSquelchMode (agc.py:26-35)
enum : int32_t { kDisabled, kEnabled, kRise, kSignalHi, kFall, kSignalLo, kTimeout };

// cp.async: a copy from device to shared memory that does not wait for the
// data; a commit_group closes the copies started so far, and wait_group<N>
// waits until at most N of the newest groups are in flight.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The slab x[c0 + r][t0 .. t0 + w) of the block's channels into rows of
// kPitch by the copying threads (`who` of kCopiers), neighbouring threads on
// neighbouring samples of one row; one commit.
__device__ __forceinline__ void fill(float2* dst, const float2* __restrict__ x, int c0, int t0,
                                     int w, int C, int n, int who) {
  for (int i = who; i < kChans * w; i += kCopiers) {
    const int r = i / w, col = i % w;
    if (c0 + r < C) cp_async8(dst + r * kPitch + col, x + (size_t)(c0 + r) * n + t0 + col);
  }
  cp_async_commit();
}

// The slab's y out of shared memory, in the same coalesced rows.
__device__ __forceinline__ void drain(const float2* src, float2* __restrict__ y, int c0, int t0,
                                      int w, int C, int n, int who) {
  for (int i = who; i < kChans * w; i += kCopiers) {
    const int r = i / w, col = i % w;
    if (c0 + r < C) y[(size_t)(c0 + r) * n + t0 + col] = src[r * kPitch + col];
  }
}

__global__ void __launch_bounds__(kThreads)
agc_scan_kernel(const float2* __restrict__ x, const float* __restrict__ g_in,
                const float* __restrict__ y2p_in, const float* __restrict__ alpha_in,
                const float* __restrict__ scale_in, const float* __restrict__ thr_in,
                const uint8_t* __restrict__ locked_in, const int32_t* __restrict__ mode_in,
                const int32_t* __restrict__ timer_in, float2* __restrict__ y,
                float* __restrict__ g_out, float* __restrict__ y2p_out,
                int32_t* __restrict__ mode_out, int32_t* __restrict__ timer_out, int C, int n,
                int timeout) {
  extern __shared__ float2 smem[];
  float2* xs = smem;              // [2][kSlab]
  float2* ys = smem + 2 * kSlab;  // [2][kSlab]
  const int tid = threadIdx.x;
  const bool copier = tid >= 32;
  const int who = tid - 32;
  const int c0 = blockIdx.x * kChans;
  const bool loops = tid < kChans && c0 + tid < C;  // this thread runs a channel's loop
  const int c = loops ? c0 + tid : c0;              // the others hold a valid channel's state
  const float alpha = alpha_in[c];
  const float one_m_alpha = __fsub_rn(1.0f, alpha);
  const float neg_half_alpha = __fmul_rn(-0.5f, alpha);
  const float thr = thr_in[c];
  const bool locked = locked_in[c] != 0;
  const float s = locked ? 1.0f : scale_in[c];
  float g = g_in[c], y2p = y2p_in[c];
  int32_t mode = mode_in[c], timer = timer_in[c];

  if (copier) {
    fill(xs, x, c0, 0, min(kTile, n), C, n, who);
    cp_async_wait<0>();
  }
  for (int t0 = 0, buf = 0; t0 < n; t0 += kTile, buf ^= 1) {
    const int tn = min(kTile, n - t0);
    // slab `buf` of x is in; the loop has parked the slab before it and reads
    // its x no more; the copiers have stored the slab before that
    __syncthreads();
    if (copier) {
      if (t0 > 0) drain(ys + (buf ^ 1) * kSlab, y, c0, t0 - kTile, kTile, C, n, who);
      if (t0 + kTile < n)
        fill(xs + (buf ^ 1) * kSlab, x, c0, t0 + kTile, min(kTile, n - t0 - kTile), C, n, who);
      cp_async_wait<0>();
    } else if (loops) {
      const float2* xr = xs + buf * kSlab + tid * kPitch;
      float2* yr = ys + buf * kSlab + tid * kPitch;
#pragma unroll 4
      for (int t = 0; t < tn; ++t) {
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
    }
  }
  __syncthreads();  // the last slab's y is parked
  if (copier) {
    const int last = (n - 1) / kTile;
    drain(ys + (last & 1) * kSlab, y, c0, last * kTile, n - last * kTile, C, n, who);
  }
  if (loops) {
    g_out[c] = g;
    y2p_out[c] = y2p;
    mode_out[c] = mode;
    timer_out[c] = timer;
  }
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
  // past 48 KB, shared memory is dynamic only and must be allowed first
  cudaError_t err = cudaFuncSetAttribute(agc_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (C + kChans - 1) / kChans;
  agc_scan_kernel<<<blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), g, y2p, alpha, scale, thr, locked, mode, timer,
      static_cast<float2*>(y), g_out, y2p_out, mode_out, timer_out, C, n, timeout);
  return (int)cudaGetLastError();
}
