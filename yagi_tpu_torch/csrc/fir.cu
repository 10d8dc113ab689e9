// The streaming FIR filter's block (every FirFilter.execute_block on the
// card; BASELINE config[2]'s four 129-tap filters): one launch computes
//   y[c, m] = scale · Σ_k h[k] · xa[c, m + L − 1 − k],   0 ≤ m < n,
// with xa = (window[c, 1:], x[c, :]), the carried window's L − 1 newest
// samples before the block. Signal and taps are float32 or complex64 in any
// of the four pairs; a tap costs 1 (real × real), 2 (one side complex) or 4
// (complex × complex) real multiply-adds an output.
//
// Replaces no Pallas kernel: yagi_tpu/filter/_conv.py's banded matmul is
// plain XLA (the stream cut into rows of 128 outputs, each row's window of
// ⌈(L + 127)/128⌉·128 samples written out as a frame, times a banded tap
// matrix). In eager torch that writes and reads back 403 MB of frames a
// config[2] step, and half of its gemms' multiply-adds are the band's
// zeros. The port's plain version, fir_block_reference in
// yagi_tpu_torch/kernels/fir.py, is that banded matmul.
//
// What bounds it on an H100: fp32 multiply-adds. At config[2]'s 129 taps
// every filter does ≥ 32 flops a byte of its input and output, against the
// card's 20 (67 TFLOP/s over 3.35 TB/s).
//
// Design:
// * Persistent blocks (as many as the card holds at once, from the
//   occupancy API); block i takes the tiles i, i + grid, … of kTile = 1536
//   consecutive outputs of a row, so every SM gets the same share within a
//   tile. A block stages the taps once, flipped (g[j] = h[L − 1 − j], zeros
//   past L), and each tile's inputs xa[m0 .. m0 + kTile + L − 1) by
//   cp.async into one of two buffers in shared memory: the next tile's
//   copies are in flight while this one's multiply-adds run. The history
//   comes from the carried window for a row's first tiles, from x after
//   that (16-byte copies where the rows and L − 1 allow), zeros past the
//   block. xa is never written to device memory.
// * Each thread keeps kR = 12 consecutive outputs in registers and slides
//   a window of 2·kR staged samples over the taps, kR taps a phase: each
//   16-byte read of samples or taps feeds 4·kR multiply-adds or more. A
//   real signal's thread starts 12 floats after its neighbour, 3 bank groups
//   of 16 bytes: a quarter-warp's 16-byte reads hit 8 distinct groups, free
//   of bank conflicts (a complex one's, 6 groups on, meet in pairs: its
//   reads take two passes, under its multiply-adds' time); the taps are
//   broadcast reads.
// * Every output sums its taps in one order, j = 0 … L − 1 (h from its last
//   tap to its first), with fmaf: the bits of an output do not depend on
//   the tile, the block or the place of the block's start, so a block split
//   anywhere gives the same bits as the whole block.
// * The scale is applied in the epilogue; the outputs go through their own
//   planes in shared memory and leave as whole rows (16-byte stores where
//   the rows allow).
//
// Measured on an H100 at 700 W (PERF.md §6): a first form, one tile a block
// with its inputs loaded before its multiply-adds, ran each of config[2]'s
// two real filters in 0.068 ms, of which its multiply-adds alone took 0.049
// and its copies alone 0.027: they hardly overlapped across an SM's blocks.
// This form runs them in 0.055 ms (59% of the fp32 peak); its multiply-adds
// alone reach 65% of it at 129 taps and 73% at 1024, where a tile's fixed
// work weighs less.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kR = 12;                    // outputs a thread; kR/4 odd: no bank conflicts
constexpr int kTile = kThreads * kR;      // outputs a block
constexpr int kSmemLimit = 232448;        // a block's shared memory on an H100

struct Args {
  const float* x;       // [C, n]: float32, or complex64 as (re, im) pairs
  const float* window;  // [C, L] in x's type
  const float* h;       // [L]: float32, or complex64 as pairs
  const float* scale;   // 0-d, in h's type
  float* y;             // [C, n]: complex64 where x or h is
  int C, n, L;
  int tiles;            // tiles a row
  int span;             // staged samples a plane, a multiple of 4
  int lg;               // staged taps a plane, a multiple of 4
  int vec_x;            // 16-byte copies of x: rows, base and L − 1 aligned to them
  int vec_y;            // rows and base 16-byte aligned: 16-byte stores
};

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// Staged samples a plane: every read of the tap loop below lies under
// kTile + L + kR (its last phase reads up to 2·kR past a thread's first
// output plus its taps).
__host__ __device__ constexpr int span_of(int L) { return round4(kTile + L + kR); }
__host__ __device__ constexpr int lg_of(int L) { return round4(L + 2 * kR); }

// cp.async: a copy of N bytes (4, 8 or 16) from device to shared memory
// that does not wait for the data; a commit_group closes the copies started
// so far, and wait_group<N> waits until at most N of the newest groups are
// in flight.
template <int N>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem), "n"(N));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copies of xa[m0 + u] of row c, u < a.span, into the staged
// tile s (a complex signal as (re, im) pairs): the window's samples, then
// x's (16 bytes a copy where a.vec_x, from the first sample on 16 bytes),
// then zeros, stored.
template <bool XC>
__device__ __forceinline__ void stage(const Args& a, int c, int m0, float* s) {
  constexpr int W = XC ? 2 : 1;  // floats a sample
  constexpr int V = 4 / W;       // samples a 16-byte copy
  const int head = a.L - 1;
  const float* win = a.window + (long long)c * a.L * W;
  const float* xr = a.x + ((long long)c * a.n + m0 - head) * W;  // at u
  const int u0 = min(max(head - m0, 0), a.span);         // [0, u0): the window
  const int u1 = min(max(head + a.n - m0, u0), a.span);  // [u0, u1): x; then zeros
  for (int u = threadIdx.x; u < u0; u += kThreads)
    cp_async<4 * W>(s + u * W, win + (long long)(m0 + u + 1) * W);
  int ua = u0, ub = u0;  // [ua, ub): 16-byte copies (u ≡ m0 + u − L + 1 (mod V) there)
  if (a.vec_x) {
    ua = min((u0 + V - 1) / V * V, u1);
    ub = ua + (u1 - ua) / V * V;
    for (int u = ua + threadIdx.x * V; u < ub; u += kThreads * V)
      cp_async<16>(s + u * W, xr + (long long)u * W);
  }
  for (int k = threadIdx.x; k < (ua - u0) + (u1 - ub); k += kThreads) {
    const int u = k < ua - u0 ? u0 + k : ub + k - (ua - u0);
    cp_async<4 * W>(s + u * W, xr + (long long)u * W);
  }
  for (int u = u1 + threadIdx.x; u < a.span; u += kThreads) {
    s[u * W] = 0.f;
    if (XC) s[u * W + 1] = 0.f;
  }
}

// kR staged samples from u (a multiple of 4) into registers, (re, im) split.
template <bool XC>
__device__ __forceinline__ void load_window(float (&wr)[kR], float (&wi)[kR], const float* s,
                                           int u) {
  if (XC) {
#pragma unroll
    for (int q = 0; q < kR; q += 2) {
      const float4 v = *reinterpret_cast<const float4*>(s + 2 * (u + q));
      wr[q] = v.x, wi[q] = v.y, wr[q + 1] = v.z, wi[q + 1] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kR; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(s + u + q);
      wr[q] = v.x, wr[q + 1] = v.y, wr[q + 2] = v.z, wr[q + 3] = v.w;
    }
  }
}

// acc += tap · sample, each real product rounded into the sum by fmaf, in
// one order.
template <bool XC, bool HC>
__device__ __forceinline__ void mac(float& ar, float& ai, float gr, float gi, float xr, float xi) {
  ar = fmaf(gr, xr, ar);
  if (XC && HC) {
    ar = fmaf(-gi, xi, ar);
    ai = fmaf(gr, xi, ai);
    ai = fmaf(gi, xr, ai);
  } else if (XC) {
    ai = fmaf(gr, xi, ai);
  } else if (HC) {
    ai = fmaf(gi, xr, ai);
  }
}

// One phase: the kR taps g[0 .. kR) (the first `rem` of them where GUARD)
// over the window (a, b) of 2·kR samples: output r takes sample r + i for
// tap i.
template <bool XC, bool HC, bool GUARD>
__device__ __forceinline__ void phase(float (&acr)[kR], float (&aci)[kR], const float (&ar)[kR],
                                      const float (&ai)[kR], const float (&br)[kR],
                                      const float (&bi)[kR], const float* g_re, const float* g_im,
                                      int rem) {
#pragma unroll
  for (int q = 0; q < kR; q += 4) {
    const float4 t = *reinterpret_cast<const float4*>(g_re + q);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (HC) s = *reinterpret_cast<const float4*>(g_im + q);
    const float tr[4] = {t.x, t.y, t.z, t.w};
    const float ti[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (GUARD && q + e >= rem) return;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int w = r + q + e;
        const float xr = w < kR ? ar[w] : br[w - kR];
        const float xi = XC ? (w < kR ? ai[w] : bi[w - kR]) : 0.f;
        mac<XC, HC>(acr[r], aci[r], tr[e], ti[e], xr, xi);
      }
    }
  }
}

// One tile's outputs at the thread's b = tid·kR, from the staged tile.
template <bool XC, bool HC>
__device__ __forceinline__ void tile_dots(float (&acr)[kR], float (&aci)[kR], const float* s,
                                          const float* g_re, const float* g_im, int b, int L) {
  // window (lo, hi) = s[b + j .. b + j + 2·kR) at tap j; phases alternate
  // the halves, each reloading the half it no longer needs
  float lr[kR], li[kR], hr[kR], hi[kR];
  load_window<XC>(lr, li, s, b);
  load_window<XC>(hr, hi, s, b + kR);
  int j = 0;
  for (; j + 2 * kR <= L; j += 2 * kR) {
    phase<XC, HC, false>(acr, aci, lr, li, hr, hi, g_re + j, g_im + j, 0);
    load_window<XC>(lr, li, s, b + j + 2 * kR);
    phase<XC, HC, false>(acr, aci, hr, hi, lr, li, g_re + j + kR, g_im + j + kR, 0);
    load_window<XC>(hr, hi, s, b + j + 3 * kR);
  }
  const int rem = L - j;  // 0 … 2·kR − 1 taps left
  if (rem > 0) {
    phase<XC, HC, true>(acr, aci, lr, li, hr, hi, g_re + j, g_im + j, rem);
    if (rem > kR) {
      load_window<XC>(lr, li, s, b + j + 2 * kR);
      phase<XC, HC, true>(acr, aci, hr, hi, lr, li, g_re + j + kR, g_im + j + kR, rem - kR);
    }
  }
}

template <bool XC, bool HC>
__global__ void __launch_bounds__(kThreads) fir_block_kernel(const Args a) {
  constexpr bool kOutC = XC || HC;
  constexpr int kIn = XC ? 2 : 1;  // floats a staged sample
  extern __shared__ float4 smem[];
  float* bufs = reinterpret_cast<float*>(smem);    // two staged tiles of span samples
  float* o_re = bufs + 2 * kIn * a.span;           // the scaled outputs
  float* o_im = o_re + kTile;
  float* g_re = o_re + (kOutC ? 2 : 1) * kTile;    // the flipped taps
  float* g_im = g_re + a.lg;
  const int tid = threadIdx.x, L = a.L;
  const int total = a.C * a.tiles;

  for (int j = tid; j < a.lg; j += kThreads) {
    const int k = L - 1 - j;
    g_re[j] = j < L ? a.h[HC ? 2 * k : k] : 0.f;
    if (HC) g_im[j] = j < L ? a.h[2 * k + 1] : 0.f;
  }
  const float sr = a.scale[0], si = HC ? a.scale[1] : 0.f;
  int tile = blockIdx.x;
  if (tile < total) {
    const int c = tile / a.tiles;
    stage<XC>(a, c, (tile - c * a.tiles) * kTile, bufs);
  }
  cp_async_commit();
  for (int k = 0; tile < total; ++k, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < total) {  // the next tile's copies, into the other buffer
      const int c = next / a.tiles;
      stage<XC>(a, c, (next - c * a.tiles) * kTile, bufs + ((k + 1) & 1) * kIn * a.span);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();

    const int c = tile / a.tiles;
    const int m0 = (tile - c * a.tiles) * kTile;
    const int n_tile = min(kTile, a.n - m0);
    const float* s = bufs + (k & 1) * kIn * a.span;
    const int b = tid * kR;  // the thread's first output in the tile
    if (b < n_tile) {
      float acr[kR], aci[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) acr[r] = aci[r] = 0.f;
      tile_dots<XC, HC>(acr, aci, s, g_re, g_im, b, L);
#pragma unroll
      for (int q = 0; q < kR; q += 4) {
        float o[4], p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float yr = acr[q + e], yi = aci[q + e];
          o[e] = HC ? yr * sr - yi * si : yr * sr;
          p[e] = HC ? yr * si + yi * sr : yi * sr;
        }
        *reinterpret_cast<float4*>(o_re + b + q) = make_float4(o[0], o[1], o[2], o[3]);
        if (kOutC) *reinterpret_cast<float4*>(o_im + b + q) = make_float4(p[0], p[1], p[2], p[3]);
      }
    }
    __syncthreads();

    // out as whole rows
    constexpr int V = kOutC ? 2 : 4;  // outputs a 16-byte store
    const int nv = a.vec_y ? n_tile / V * V : 0;
    float* yrow = a.y + ((long long)c * a.n + m0) * (kOutC ? 2 : 1);
    for (int v = tid * V; v < nv; v += kThreads * V) {
      if (kOutC) {
        const float2 re = *reinterpret_cast<const float2*>(o_re + v);
        const float2 im = *reinterpret_cast<const float2*>(o_im + v);
        *reinterpret_cast<float4*>(yrow + 2 * v) = make_float4(re.x, im.x, re.y, im.y);
      } else {
        *reinterpret_cast<float4*>(yrow + v) = *reinterpret_cast<const float4*>(o_re + v);
      }
    }
    for (int v = nv + tid; v < n_tile; v += kThreads) {
      if (kOutC) {
        yrow[2 * v] = o_re[v];
        yrow[2 * v + 1] = o_im[v];
      } else {
        yrow[v] = o_re[v];
      }
    }
    __syncthreads();  // both buffers and the outputs free for the next tile
  }
}

// Shared memory of a block: two staged tiles, the output planes, the taps.
template <bool XC, bool HC>
int smem_bytes(const Args& a) {
  return (2 * (XC ? 2 : 1) * a.span + (XC || HC ? 2 : 1) * kTile + (HC ? 2 : 1) * a.lg) *
         (int)sizeof(float);
}

// Blocks the card holds at once for this instance and shared memory: a
// static per instance, asked of the occupancy API on the first launch and
// whenever the bytes change (warm a shape up before capturing a graph).
template <bool XC, bool HC>
cudaError_t places(int bytes, int* out) {
  static int last_bytes = -1, last_places = 0;
  if (bytes == last_bytes) {
    *out = last_places;
    return cudaSuccess;
  }
  const auto kernel = fir_block_kernel<XC, HC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  if (err != cudaSuccess) return err;
  last_bytes = bytes;
  last_places = sms * (per_sm > 0 ? per_sm : 1);
  *out = last_places;
  return cudaSuccess;
}

template <bool XC, bool HC>
int run(const Args& a, cudaStream_t stream) {
  const int bytes = smem_bytes<XC, HC>(a);
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  int p = 0;
  const cudaError_t err = places<XC, HC>(bytes, &p);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)min((long long)p, (long long)a.C * a.tiles);
  fir_block_kernel<XC, HC><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x [C, n] float32 (xc 0) or complex64 (xc 1); window [C, L] in x's type; h
// [L] float32 (hc 0) or complex64 (hc 1); scale 0-d in h's type; y [C, n],
// complex64 where x or h is, else float32. All contiguous; C, n, L ≥ 1 with
// C·⌈n/1536⌉ and n + L below 2^31. Launches on `stream` and returns the
// CUDA error of the launch (0 on success), or cudaErrorInvalidValue without
// launching where a block's buffers pass its shared memory (L past 8,132
// with complex taps and signal, 17,816 with real: kernels/fir.py::smem_bytes
// mirrors the layout).
extern "C" int yagi_fir_block(const void* x, const void* window, const void* h, const void* scale,
                              void* y, int C, int n, int L, int xc, int hc, void* stream) {
  if (C < 1 || n < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const long long tiles = (n + (long long)kTile - 1) / kTile;
  if ((long long)C * tiles > 0x7fffffffLL || (long long)n + L + kTile > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(x), static_cast<const float*>(window),
         static_cast<const float*>(h), static_cast<const float*>(scale), static_cast<float*>(y),
         C, n, L, (int)tiles, span_of(L), lg_of(L), 0, 0};
  const int v = xc ? 2 : 4;  // samples a 16-byte copy
  a.vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && n % v == 0 && (L - 1) % v == 0;
  a.vec_y = reinterpret_cast<uintptr_t>(y) % 16 == 0 && n % (xc || hc ? 2 : 4) == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (xc && hc) return run<true, true>(a, s);
  if (xc) return run<true, false>(a, s);
  if (hc) return run<false, true>(a, s);
  return run<false, false>(a, s);
}
