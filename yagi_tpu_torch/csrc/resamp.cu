// The arbitrary resampler's u32 PFB step (BASELINE config[1]): one launch
// forms every output of a block straight from the schedule.
//
// Replaces no Pallas kernel: yagi_tpu/filter/resamp.py runs this step in
// plain XLA (the u32 schedule, a frame gather [..., cap, L] and one
// contraction). The port's plain version, resamp_u32_reference in
// yagi_tpu_torch/kernels/resamp.py, does the same in eager torch: at
// config[1]'s block (1024 × 4096 complex64, L = 14) its frame gather writes
// 456 MB to device memory and its contraction reads them back, about 40 ops a
// step. Semantics (resamp.rs:141-154), the schedule the same for every
// channel:
//   P_m = phase + m·step (64 bits),  n_m = P_m >> 24,
//   branch_m = (P_m & 0xffffff) >> (24 − bits),  valid while n_m < n_valid,
//   y[c, m] = Σ_l xa[c, n_m + l] · branches[branch_m, L − 1 − l],  0 past the count,
// with xa = (window[c, 1:], x[c, :]) and samples at or past n_valid read as 0.
// The count and the new phase are closed forms of the schedule:
//   count = min(cap, ⌈((n_valid << 24) − phase) / step⌉), 0 if that is ≤ 0,
//   phase' = ((phase + count·step) − (n_valid << 24)) mod 2^32,
// and the new window is the L samples of xa ending at the last consumed
// input, or the old window when n_valid is 0. The dots are float32, the even
// and the odd taps in two chains of fmaf added at the end: another order than
// the plain version's; each reads up to ~8e-7 of the rms from the exact dots
// over 16M outputs of random input.
//
// What bounds it on an H100: the block read once and the output written once,
// 16 bytes an output at a rate near 1 (33.6 + 32.6 MB at config[1]: 0.020 ms
// at 3.35 TB/s), against 4·L flops an output (~3.5 flop a byte): device
// memory. At config[1] its copies and stores alone take 0.037 ms on an H100,
// its dots alone about as long, and the kernel ~0.05: the two overlap only
// across the blocks of an SM.
//
// Design:
// * Persistent blocks (as many as the card holds at once, from the occupancy
//   API), each walking a contiguous run of items; an item is 32 channel rows
//   × kOut = 64 consecutive outputs. The branch table, flipped to the dot's
//   order and its rows padded to a multiple of 4 floats, is staged in shared
//   memory once a block (16 KB at config[1]); past kTableBudget it is read
//   through L1 instead.
// * A pass stages the input of an item's outputs, xa[n_m0 .. n_mlast + L) of
//   its 32 rows, by cp.async (8-byte copies, a warp's lanes on a row's
//   neighbouring samples: whole 128-byte lines; the window's part from the
//   window, the samples at or past n_valid zero-filled by the copy itself).
//   A rate below ~0.86 whose outputs need more than the staged span takes an
//   item in more than one pass. Three or four blocks share an SM, so one
//   block's copies are in flight while another computes; a second buffer a
//   block, to stage the next pass during this one's dots, halved that and
//   measured 9% slower.
// * Lane = channel: an output's schedule is the same for all 32 lanes of a
//   warp, so its branch row is broadcast reads (float4) and its samples are
//   read at one offset in 32 rows of an odd pitch, each half-warp on 16
//   distinct bank pairs. The outputs go to a shared tile (odd pitch again)
//   and leave it as whole rows, so every store to y is coalesced. 16-byte
//   copies would need 16-byte-aligned rows, which an odd pitch is not.
// * The count and the new phase are computed by every block (they bound its
//   items) and written by one thread; the new window is copied by the whole
//   grid, an element a thread, while the first pass's copies are in flight.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;             // channels of an item, one a lane
constexpr int kOut = 64;              // outputs of an item
constexpr int kOutPitch = kOut + 1;   // complex samples; odd: bank-pair free
constexpr int kSpanExtra = 8;         // staged samples past kOut + L
constexpr int kTableBudget = 96 * 1024;     // bytes of branch table staged in shared memory
constexpr int kSmemLimit = 232448;          // a block's shared memory on an H100

struct Args {
  const float2* x;        // [C, n]
  const float2* window;   // [C, L]
  const float* branches;  // [npfb, L], convolution order
  const int64_t* phase;   // u32 in int64
  const int64_t* step;    // u32 in int64
  const int64_t* nv_ptr;  // 0-d int64 on the device, or null: nv_host
  float2* y;              // [C, cap]
  float2* window_out;     // [C, L]
  int64_t* count_out;
  int64_t* phase_out;
  int C, n, cap, L, npfb, bits, nv_host;
  int Lp;      // shared table row pitch in floats, L rounded up to 4
  int pitch;   // staged row pitch in complex samples, odd
  int tiles;   // items along a row group
  int items;   // row groups × tiles
  int each;    // items a block
};

// cp.async: a copy of 4 or 8 bytes from device to shared memory that does
// not wait for the data, zero-filled where `bytes` is 0 (the source is then
// not read); a commit_group closes the copies started so far, and
// wait_group<N> waits until at most N of the newest groups are in flight.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, int bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// An item's rows and outputs: [m0, m_v) valid, [m_v, m_hi) past the count.
struct Item {
  int c0, rows, m0, m_v, m_hi;
};

__device__ __forceinline__ Item item_at(const Args& a, int it, int count) {
  const int g = it / a.tiles;
  Item I;
  I.c0 = g * kRows;
  I.rows = min(kRows, a.C - I.c0);
  I.m0 = (it - g * a.tiles) * kOut;
  I.m_hi = min(I.m0 + kOut, a.cap);
  I.m_v = max(I.m0, min(I.m_hi, count));
  return I;
}

// A pass: the outputs [m, m_fit) of an item whose taps lie in the staged
// span xa[s0, s0 + width).
struct Pass {
  int c0, rows, m, m_fit, width;
  long long s0;
};

__device__ __forceinline__ Pass pass_at(const Args& a, uint64_t phase, uint64_t step,
                                        const Item& I, int m) {
  Pass p;
  p.c0 = I.c0, p.rows = I.rows, p.m = m;
  p.s0 = (long long)((phase + (uint64_t)m * step) >> 24);
  p.m_fit = I.m_v;
  if (step != 0) {  // n_m' + L ≤ s0 + pitch ⇔ P_m' < (s0 + pitch − L + 1) << 24
    const uint64_t lim = (uint64_t)(p.s0 + a.pitch - a.L + 1) << 24;
    const uint64_t q = (lim - phase + step - 1) / step;
    if (q < (uint64_t)p.m_fit) p.m_fit = (int)q;
  }
  p.width = (int)((long long)((phase + (uint64_t)(p.m_fit - 1) * step) >> 24) + a.L - p.s0);
  return p;
}

// A pass's xa[c0 + r][s0 .. s0 + width) into rows of a.pitch, by cp.async:
// warp w takes rows w, w + kWarps, ..., its lanes neighbouring samples of a
// row; samples at or past nv zero-filled. One commit.
__device__ __forceinline__ void stage(float2* tin, const Args& a, const Pass& p, int nv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = a.L;
  for (int r = warp; r < p.rows; r += kWarps) {
    const float2* xrow = a.x + (size_t)(p.c0 + r) * a.n - (L - 1);  // xa's index
    const float2* wrow = a.window + (size_t)(p.c0 + r) * L + 1;
    float2* dst = tin + r * a.pitch;
    for (int i = lane; i < p.width; i += 32) {
      const long long q = p.s0 + i;
      cp_async8(dst + i, q < L - 1 ? wrow + q : xrow + (q < nv + L - 1 ? q : L - 1),
                q < nv + L - 1 ? 8 : 0);
    }
  }
  cp_async_commit();
}

// The outputs of pass p from its staged rows into tout: warp w takes outputs
// p.m + w, p.m + w + kWarps, ...; lane = channel. Each dot runs its even and
// its odd taps in two chains of fmaf.
__device__ __forceinline__ void dots(const Args& a, const float* tab, const float2* tin,
                                     float2* tout, uint64_t phase, uint64_t step,
                                     const Pass& p, int m0, bool shared_table) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = a.L;
  const float2* xrow = tin + lane * a.pitch - p.s0;
  for (int mm = p.m + warp; mm < p.m_fit; mm += kWarps) {
    const uint64_t pm = phase + (uint64_t)mm * step;
    const float2* xs = xrow + (long long)(pm >> 24);
    const int b = (int)(((uint32_t)pm & 0xffffffu) >> (24 - a.bits));
    float re0 = 0.f, im0 = 0.f, re1 = 0.f, im1 = 0.f;
    int l = 0;
    if (shared_table) {
      const float* h = tab + b * a.Lp;
      for (; l + 4 <= L; l += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(h + l);
        const float2 v0 = xs[l], v1 = xs[l + 1], v2 = xs[l + 2], v3 = xs[l + 3];
        re0 = fmaf(v0.x, hv.x, re0), im0 = fmaf(v0.y, hv.x, im0);
        re1 = fmaf(v1.x, hv.y, re1), im1 = fmaf(v1.y, hv.y, im1);
        re0 = fmaf(v2.x, hv.z, re0), im0 = fmaf(v2.y, hv.z, im0);
        re1 = fmaf(v3.x, hv.w, re1), im1 = fmaf(v3.y, hv.w, im1);
      }
      for (; l < L; ++l) {
        const float hv = h[l];
        if (l & 1) re1 = fmaf(xs[l].x, hv, re1), im1 = fmaf(xs[l].y, hv, im1);
        else re0 = fmaf(xs[l].x, hv, re0), im0 = fmaf(xs[l].y, hv, im0);
      }
    } else {
      const float* h = a.branches + (size_t)b * L + (L - 1);
      for (; l < L; ++l) {
        const float hv = __ldg(h - l);
        if (l & 1) re1 = fmaf(xs[l].x, hv, re1), im1 = fmaf(xs[l].y, hv, im1);
        else re0 = fmaf(xs[l].x, hv, re0), im0 = fmaf(xs[l].y, hv, im0);
      }
    }
    tout[lane * kOutPitch + (mm - m0)] = make_float2(re0 + re1, im0 + im1);
  }
}

template <bool kSharedTable>
__global__ void __launch_bounds__(kThreads)
resamp_u32_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tab = reinterpret_cast<float*>(smem);
  float2* tin = reinterpret_cast<float2*>(
      smem + (kSharedTable ? (size_t)a.npfb * a.Lp * sizeof(float) : 0));
  float2* tout = tin + kRows * a.pitch;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.L;

  const uint64_t phase = (uint64_t)*a.phase;
  const uint64_t step = (uint64_t)*a.step;
  int nv = a.nv_host;
  if (a.nv_ptr) {
    const int64_t v = *a.nv_ptr;
    nv = v < 0 ? 0 : v > a.n ? a.n : (int)v;
  }
  const uint64_t end = (uint64_t)nv << 24;
  int count;
  if (end <= phase) {
    count = 0;
  } else if (step == 0) {
    count = a.cap;
  } else {
    const uint64_t c = (end - phase - 1) / step + 1;
    count = c < (uint64_t)a.cap ? (int)c : a.cap;
  }
  if (blockIdx.x == 0 && tid == 0) {
    *a.count_out = count;
    *a.phase_out = (int64_t)((uint32_t)(phase + (uint64_t)count * step) -
                             ((uint32_t)(nv & 0xFF) << 24));
  }

  if (kSharedTable) {  // tab[b][l] = branches[b][L − 1 − l], rows padded with zeros
    for (int i = tid; i < a.npfb * a.Lp; i += kThreads) {
      const int b = i / a.Lp, l = i - b * a.Lp;
      cp_async4(tab + i, a.branches + (size_t)b * L + (l < L ? L - 1 - l : 0), l < L ? 4 : 0);
    }
    cp_async_commit();
  }

  // the new window: xa[c][nv − 1 + j], or the old window when nv is 0
  const long long wn = (long long)a.C * L;
  for (long long i = (long long)blockIdx.x * kThreads + tid; i < wn;
       i += (long long)gridDim.x * kThreads) {
    const int c = (int)(i / L), j = (int)(i - (long long)c * L);
    const int p = nv - 1 + j;
    a.window_out[i] = nv == 0 ? a.window[i]
                      : p < L - 1 ? a.window[(size_t)c * L + 1 + p]
                                  : a.x[(size_t)c * a.n + (p - (L - 1))];
  }

  const int first = blockIdx.x * a.each;
  const int last = min(first + a.each, a.items);
  for (int it = first; it < last; ++it) {
    const Item I = item_at(a, it, count);
    for (int m = I.m0; m < I.m_v;) {  // passes: the outputs whose taps lie in a staged span
      const Pass p = pass_at(a, phase, step, I, m);
      stage(tin, a, p, nv);
      cp_async_wait<0>();
      __syncthreads();
      dots(a, tab, tin, tout, phase, step, p, I.m0, kSharedTable);
      __syncthreads();  // tin is staged again by the next pass or item
      m = p.m_fit;
    }
    const int zc = I.m_hi - I.m_v;  // outputs past the count
    for (int i = tid; i < kRows * zc; i += kThreads) {
      const int r = i / zc;
      tout[r * kOutPitch + (I.m_v - I.m0) + (i - r * zc)] = make_float2(0.f, 0.f);
    }
    __syncthreads();
    const int cols = I.m_hi - I.m0;
    for (int r = warp; r < I.rows; r += kWarps) {
      float2* dst = a.y + (size_t)(I.c0 + r) * a.cap + I.m0;
      for (int col = lane; col < cols; col += 32) dst[col] = tout[r * kOutPitch + col];
    }
    __syncthreads();  // tout is written again by the next item
  }
  cp_async_wait<0>();  // a block with no pass has not waited for its table
}

// Blocks of one instance at `bytes` of dynamic shared memory that the card
// holds at once, sized once per instance and size.
template <bool kSharedTable>
cudaError_t places(int bytes, int* out) {
  static int last_bytes = -1, last_places = 0, attr_bytes = 48 * 1024;
  if (bytes == last_bytes) {
    *out = last_places;
    return cudaSuccess;
  }
  const auto kernel = resamp_u32_kernel<kSharedTable>;
  cudaError_t err = cudaSuccess;
  if (bytes > attr_bytes) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr_bytes = bytes;
  }
  int device, sms, per_sm;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  if (err != cudaSuccess) return err;
  last_bytes = bytes;
  last_places = sms * (per_sm > 0 ? per_sm : 1);
  *out = last_places;
  return cudaSuccess;
}

template <bool kSharedTable>
int run(Args a, int bytes, cudaStream_t stream) {
  int p = 0;
  cudaError_t err = places<kSharedTable>(bytes, &p);
  if (err != cudaSuccess) return (int)err;
  a.each = (a.items + p - 1) / p;
  const int blocks = (a.items + a.each - 1) / a.each;
  resamp_u32_kernel<kSharedTable><<<blocks, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x [C, n], window [C, L] complex64; branches [npfb, L] float32, npfb a power
// of two up to 2^16; phase, step int64 scalars holding u32 values; n_valid an
// int64 scalar on the device (clamped to [0, n]) or null, then nv; outputs y
// [C, cap] and window_out [C, L] complex64, count and new_phase int64
// scalars. C, n, cap ≥ 1 and below 2^31. Launches on `stream` and returns
// the CUDA error of the launch (0 on success), or cudaErrorInvalidValue
// without launching where an item's staged rows need more shared memory
// than a block has (L past ~830).
extern "C" int yagi_resamp_u32(const void* x, const void* window, const float* branches,
                               const int64_t* phase, const int64_t* step, const int64_t* n_valid,
                               void* y, void* window_out, int64_t* count, int64_t* new_phase,
                               int C, int n, int cap, int L, int npfb, int nv, void* stream) {
  if (C < 1 || n < 1 || cap < 1 || L < 1 || npfb < 2 || (npfb & (npfb - 1)) || npfb > 65536)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float2*>(x), static_cast<const float2*>(window), branches, phase, step,
         n_valid, static_cast<float2*>(y), static_cast<float2*>(window_out), count, new_phase,
         C, n, cap, L, npfb, 0, nv};
  while ((1 << a.bits) < npfb) ++a.bits;
  a.Lp = (L + 3) & ~3;
  a.pitch = (kOut + L + kSpanExtra) | 1;
  a.tiles = (cap + kOut - 1) / kOut;
  const long long items = (long long)((C + kRows - 1) / kRows) * a.tiles;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.items = (int)items;
  const long long tiles_bytes = (long long)kRows * (a.pitch + kOutPitch) * sizeof(float2);
  const long long table_bytes = (long long)npfb * a.Lp * sizeof(float);
  if (tiles_bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (table_bytes <= kTableBudget && tiles_bytes + table_bytes <= kSmemLimit)
    return run<true>(a, (int)(tiles_bytes + table_bytes), s);
  return run<false>(a, (int)tiles_bytes, s);
}
