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
// The IDFT is an FFT. With b(c) = (64 − c) mod 64, W'[c, k] =
// scale·e^{+2πi·b(c)k/64} = scale·e^{−2πi·ck/64}, so y[t, ·] = scale ·
// DFT64(u[t, ·]) in the lanes' own order. Of the tables the kernel reads
// `taps` and hr[0] = W'[0, 0] = scale; it reads no other entry of hr or hi.
// Its twiddles e^{−2πi·m/64} are f64 sincospi rounded to f32, made in the
// kernel, and the 8-point DFT's are the literal √2/2.
//
// What bounds it on an H100. Per step the branch FIRs take 64·p·4 FLOP (2,048
// at p = 8) and the radix-8 × 8 FFT ~1,300, against 1,024 bytes of traffic
// (64 complex samples in, 64 out): ~3 FLOP/byte, below the card's fp32 ridge
// (67 TFLOP/s over 3.35 TB/s ≈ 20), so the kernel is bound by device memory.
// (A direct 64×64 product, the first version of this kernel, took 32,768
// FLOP a step and restaged the 32 KB W' every 64 steps: 5.6× its bound.)
//
// Design: persistent blocks, the input read once, its fetch hidden.
// * The grid is as many blocks as the card holds at once; each block walks a
//   contiguous run of tiles of kTile = 32 steps. A ring of kRing = 128 input
//   M-blocks (rows) in shared memory holds the tile, its p rows of halo and
//   the next tile, which cp.async brings in while this one is computed: every
//   input sample leaves device memory once (a block's first tile also fetches
//   its p rows of halo), and no table is staged but the taps.
// * A step is 8 threads; thread j computes the branch outputs of lanes
//   8·c1 + j (c1 < 8), summing taps j = 0 .. p − 1 in order with fmaf, so a
//   step's arithmetic does not depend on where its block or tile starts (the
//   block-split gate holds it to 1e-5). Ring rows have a pitch of 72 floats,
//   so a warp's four steps read 32 distinct banks.
// * The DFT as 8 × 8: Y[k1 + 8·k2] = Σ_{c2} e^{−2πi·c2·k2/8} ·
//   e^{−2πi·c2·k1/64} · Σ_{c1} u[8·c1 + c2]·e^{−2πi·c1·k1/8}. Thread j runs
//   the inner 8-point DFT on its lanes (c2 = j), turns it by its twiddles,
//   hands the 8 × 8 values over through shared memory (pitch 9, bank-free),
//   and runs the outer one for k1 = j; it stores y[t, j + 8·k2], which a warp
//   writes as whole 32-byte sectors.
// * The FM instance (kFm, ChannelizerFmRx's step): the same kernel with
//   Freqdem's discriminator in its epilogue, fm[t, k] = arg(conj(y[t − 1, k])
//   · y[t, k])·ref, and the carried state (y[T − 1], the input's last nh
//   samples) written by the same launch. A step's y row is still in shared
//   memory when the step after it needs it, so fm costs its own 67 MB of
//   stores at 2^24 samples and no pass over the channel planes: the step
//   moves 335 MB in one launch, where K2 and six torch passes moved ~1.5 GB.
//   Each y[t − 1] is the value stored for step t − 1, and every fm is one
//   formula in one order, so a stream cut anywhere gives one call's bits.
// Every precision mode runs this fp32 kernel (TF32 would miss the 1e-4
// bound). A bank of more than kMaxOnePass = 64 taps a branch runs a second
// instance that stages kTapTile = 64 taps at a time per block of 64 steps,
// accumulates u in the same tap order, and runs the same FFT.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kM = 64;          // channels
constexpr int kLane = 128;      // table row width: two copies of the 64 lanes
constexpr int kThreads = 256;
constexpr int kGroup = 8;       // threads a step
constexpr int kTile = kThreads / kGroup;  // steps a tile: each thread takes one
constexpr int kRing = 128;      // ring rows, a power of two ≥ 2·kTile + p
constexpr int kRowPitch = 72;   // floats a ring row: 72 ≡ 8 (mod 32) banks a step
constexpr int kZPitch = 72;     // floats of a step's 8 × 8 exchange, rows of 9
constexpr int kMaxOnePass = kRing - 2 * kTile;  // taps a branch of the one-pass instance
constexpr int kSteps = 64;      // tiled instance: steps a block
constexpr int kUPitch = kSteps + 4;  // its u row pitch: 68 ≡ 4 (mod 32)
constexpr int kTapTile = 64;    // its taps staged at once
constexpr float kR2 = 0.70710678118654752440f;  // √2/2

// the ring, the exchange, the FM instance's carry rows, the taps
size_t onepass_smem_bytes(int p, bool fm) {
  return sizeof(float) *
         (2 * kRing * kRowPitch + 2 * kTile * kZPitch + (fm ? 4 * kM : 0) + (size_t)p * kM);
}

size_t tiled_smem_bytes() {  // u, a tile of taps, its input rows, the exchange
  return sizeof(float) * (2 * kM * kUPitch + kTapTile * kM + 2 * (kSteps + kTapTile) * kM +
                          2 * kTile * kZPitch);
}

// cp.async: a 16-byte copy from device to shared memory that does not wait
// for the data; commit_group closes the copies issued so far, and
// wait_group<N> waits until at most N of the newest groups are in flight.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The 4-point DFT of x0..x3 (re, im), X[k] = Σ x[n]·(−i)^{nk}.
__device__ __forceinline__ void dft4(const float* xr, const float* xi, float* yr, float* yi) {
  const float s0r = xr[0] + xr[2], s0i = xi[0] + xi[2];
  const float s1r = xr[0] - xr[2], s1i = xi[0] - xi[2];
  const float s2r = xr[1] + xr[3], s2i = xi[1] + xi[3];
  const float s3r = xi[1] - xi[3], s3i = xr[3] - xr[1];  // (x1 − x3)·(−i)
  yr[0] = s0r + s2r, yi[0] = s0i + s2i;
  yr[1] = s1r + s3r, yi[1] = s1i + s3i;
  yr[2] = s0r - s2r, yi[2] = s0i - s2i;
  yr[3] = s1r - s3r, yi[3] = s1i - s3i;
}

// In place: the 8-point DFT X[k] = Σ x[n]·e^{−2πi·nk/8}, natural order in and
// out. Radix-2 decimation in frequency: the sums a[n] + a[n+4] give the even
// outputs, the differences turned by e^{−2πi·n/8} the odd ones.
__device__ __forceinline__ void dft8(float* re, float* im) {
  float er[4], ei[4], orr[4], oi[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    er[n] = re[n] + re[n + 4];
    ei[n] = im[n] + im[n + 4];
    orr[n] = re[n] - re[n + 4];
    oi[n] = im[n] - im[n + 4];
  }
  const float r1 = orr[1], r2 = orr[2], r3 = orr[3];
  orr[1] = kR2 * (r1 + oi[1]);  // · e^{−iπ/4} = √2/2·(1 − i)
  oi[1] = kR2 * (oi[1] - r1);
  orr[2] = oi[2];  // · (−i)
  oi[2] = -r2;
  orr[3] = kR2 * (oi[3] - r3);  // · e^{−3iπ/4} = −√2/2·(1 + i)
  oi[3] = -kR2 * (r3 + oi[3]);
  float ar[4], ai[4], br[4], bi[4];
  dft4(er, ei, ar, ai);
  dft4(orr, oi, br, bi);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    re[2 * k] = ar[k], im[2 * k] = ai[k];
    re[2 * k + 1] = br[k], im[2 * k + 1] = bi[k];
  }
}

// Thread j's twiddles e^{−2πi·j·k1/64}, k1 < 8: f64 rounded to f32.
__device__ __forceinline__ void twiddles(int j, float* twr, float* twi) {
#pragma unroll
  for (int k1 = 0; k1 < 8; ++k1) {
    double s, c;
    sincospi(-(double)(j * k1) / 32.0, &s, &c);
    twr[k1] = (float)c;
    twi[k1] = (float)s;
  }
}

// One step's y = scale·DFT64(u) from the 8 branch outputs thread j of the
// step's group holds, a[c1] = u[8·c1 + j]; z is the step's exchange (re
// plane at zr, im plane at zi). Every thread of the group calls it; on return
// ar[k2], ai[k2] hold y[k] for its k = j + 8·k2.
__device__ __forceinline__ void fft64(float* ar, float* ai, const float* twr, const float* twi,
                                      float* zr, float* zi, int j, float scale) {
  dft8(ar, ai);  // over c1: A[k1] of branch set c2 = j
  __syncwarp();  // the group's reads of the last exchange are done
#pragma unroll
  for (int k1 = 0; k1 < 8; ++k1) {
    zr[j * 9 + k1] = ar[k1] * twr[k1] - ai[k1] * twi[k1];
    zi[j * 9 + k1] = ar[k1] * twi[k1] + ai[k1] * twr[k1];
  }
  __syncwarp();
#pragma unroll
  for (int c2 = 0; c2 < 8; ++c2) {
    ar[c2] = zr[c2 * 9 + j];
    ai[c2] = zi[c2 * 9 + j];
  }
  dft8(ar, ai);  // over c2, for k1 = j: Y[j + 8·k2]
#pragma unroll
  for (int k2 = 0; k2 < 8; ++k2) {
    ar[k2] *= scale;
    ai[k2] *= scale;
  }
}

// Thread j's share of a row of y, y[j + 8·k2] at `at`: a warp's four steps
// write whole 32-byte sectors.
__device__ __forceinline__ void store_row(const float* ar, const float* ai, float* __restrict__ yr,
                                          float* __restrict__ yi, int64_t at, int j) {
#pragma unroll
  for (int k2 = 0; k2 < 8; ++k2) {
    yr[at + j + 8 * k2] = ar[k2];
    yi[at + j + 8 * k2] = ai[k2];
  }
}

// Rows r0 ≤ r < r1 of the input M-blocks (r < 0 from the history) into their
// ring slots r mod kRing, by cp.async; no commit.
__device__ __forceinline__ void fetch(float* ring_r, float* ring_i, const float* __restrict__ xr,
                                      const float* __restrict__ xi,
                                      const float* __restrict__ hist_r,
                                      const float* __restrict__ hist_i, int nh, int r0, int r1) {
  constexpr int kChunks = kM / 4;  // 16-byte copies a row of a plane
  const int n = (r1 - r0) * kChunks;
  for (int q = threadIdx.x; q < 2 * n; q += kThreads) {
    const bool im = q >= n;
    const int qq = im ? q - n : q;
    const int r = r0 + qq / kChunks, col = (qq % kChunks) * 4;
    const float* src = r < 0 ? (im ? hist_i : hist_r) + nh + r * kM + col
                             : (im ? xi : xr) + (int64_t)r * kM + col;
    cp_async16((im ? ring_i : ring_r) + (r & (kRing - 1)) * kRowPitch + col, src);
  }
}

// Thread j's branch outputs of step t, a[c1] = u[8·c1 + j] (re, im): taps
// i = 0 .. p − 1 summed in order with fmaf, lane 8·c1 + j's tap i on ring row
// X[t − i − 1], or X[t − i] for lane 0. Nothing here depends on where the
// step's block or tile starts.
__device__ __forceinline__ void branch_sums(const float* ring_r, const float* ring_i,
                                            const float* s_taps, int t, int j, int p, float* ar,
                                            float* ai) {
  const int lag0 = j == 0 ? 0 : 1;
#pragma unroll
  for (int c1 = 0; c1 < 8; ++c1) ar[c1] = ai[c1] = 0.0f;
  for (int i = 0; i < p; ++i) {
    const int o1 = ((t - i - 1) & (kRing - 1)) * kRowPitch + j;
    const int o0 = ((t - i - lag0) & (kRing - 1)) * kRowPitch + j;
    const float* tp = s_taps + i * kM + j;
#pragma unroll
    for (int c1 = 0; c1 < 8; ++c1) {
      const int o = (c1 == 0 ? o0 : o1) + 8 * c1;
      const float tap = tp[8 * c1];
      ar[c1] = fmaf(tap, ring_r[o], ar[c1]);
      ai[c1] = fmaf(tap, ring_i[o], ai[c1]);
    }
  }
}

// Freqdem's phase step arg(conj(q)·r) = atan2(qr·ri − qi·rr, qr·rr + qi·ri),
// in the plain version's order (kernels/channelizer.py::phase_step): each
// first product rounded, the second added to it in one fused multiply-add.
__device__ __forceinline__ float phase_step(float qr, float qi, float rr, float ri) {
  return atan2f(fmaf(-qi, rr, __fmul_rn(qr, ri)), fmaf(qi, ri, __fmul_rn(qr, rr)));
}

// The one-pass instance. With kFm it is also the FM discriminator: each step's
// y row goes to its exchange row once the FFT is done, and after a barrier
// thread (s, j) forms fm[t, k] = phase_step(y[t − 1, k], y[t, k])·ref for its
// k = j + 8·k2 against the row before it. A tile's step 0 reads the tile
// before's last row, kept in `carry` (two rows by tile parity, so the tile
// that writes the next one never races the step that reads this one); a
// block's first tile reads step t0 − 1 computed again by its first warp
// before the loop (its arithmetic is that of the block that owns it, so the
// row is bit for bit the one stored there; the first fetch reaches one row
// further back for it), or at t0 = 0 the carried last outputs rp_in. The
// block that owns step T − 1 writes that row as rp_out (complex), and the
// last block copies the input's last nh samples into the new history.
// two blocks an SM: ≤ 128 registers
template <bool kFm>
__global__ void __launch_bounds__(kThreads, 2)
channelizer_fp32_kernel(const float* __restrict__ xr, const float* __restrict__ xi,  // [T·64]
                        const float* __restrict__ taps,                            // [p, 128]
                        const float* __restrict__ hr,                              // scale at [0]
                        const float* __restrict__ hist_r,
                        const float* __restrict__ hist_i,  // [nh]
                        float* __restrict__ yr, float* __restrict__ yi,  // [T, 64]
                        int T, int p, int nh, int each,
                        // kFm only:
                        const float* __restrict__ rp_in,  // [64] complex: y[−1]
                        float ref,                        // 1/(2π·kf) in float32
                        float* __restrict__ fm,           // [T, 64]
                        float* __restrict__ rp_out,       // [64] complex: y[T − 1]
                        float* __restrict__ hist_r_out, float* __restrict__ hist_i_out) {  // [nh]
  extern __shared__ __align__(16) float smem[];
  float* ring_r = smem;                      // [kRing][kRowPitch]  X[r] at slot r mod kRing
  float* ring_i = ring_r + kRing * kRowPitch;
  float* z_r = ring_i + kRing * kRowPitch;   // [kTile][kZPitch]  the steps' exchanges
  float* z_i = z_r + kTile * kZPitch;
  float* carry = z_i + kTile * kZPitch;      // kFm: [2][2][64]  (re, im) row by tile parity
  float* s_taps = carry + (kFm ? 4 * kM : 0);  // [p][64]

  const int tid = threadIdx.x;
  const int s = tid / kGroup, j = tid % kGroup;
  const int nt = (T + kTile - 1) / kTile;
  const int k0 = blockIdx.x * each, k1 = min(k0 + each, nt);

  for (int i = tid; i < p * kM; i += kThreads) s_taps[i] = taps[(i / kM) * kLane + i % kM];
  float twr[8], twi[8];
  twiddles(j, twr, twi);
  const float scale = hr[0];

  const int first = k0 * kTile - p - (kFm && k0 > 0 ? 1 : 0);
  fetch(ring_r, ring_i, xr, xi, hist_r, hist_i, nh, first, min((k0 + 1) * kTile, T));
  cp_async_commit();
  if constexpr (kFm) {  // y[t0 − 1] into the carry row tile k0 reads
    float* c = carry + ((k0 + 1) & 1) * 2 * kM;
    if (k0 == 0) {
      for (int i = tid; i < kM; i += kThreads) {
        c[i] = rp_in[2 * i];
        c[kM + i] = rp_in[2 * i + 1];
      }
    } else {
      cp_async_wait<0>();
      __syncthreads();  // the rows and the taps are in
      if (tid < 32) {   // the whole first warp (fft64's __syncwarp), each group alike
        float ar[8], ai[8];
        branch_sums(ring_r, ring_i, s_taps, k0 * kTile - 1, j, p, ar, ai);
        fft64(ar, ai, twr, twi, z_r + s * kZPitch, z_i + s * kZPitch, j, scale);
        if (s == 0) {
#pragma unroll
          for (int k2 = 0; k2 < 8; ++k2) {
            c[j + 8 * k2] = ar[k2];
            c[kM + j + 8 * k2] = ai[k2];
          }
        }
      }
    }
  }
  for (int k = k0; k < k1; ++k) {
    const int t0 = k * kTile;
    __syncthreads();  // the last tile is computed: the rows before it may be refilled
    if (k + 1 < k1)
      fetch(ring_r, ring_i, xr, xi, hist_r, hist_i, nh, t0 + kTile, min(t0 + 2 * kTile, T));
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of this tile (and the halo) are in
    __syncthreads();     // and everyone's

    const int t = t0 + s;
    float* zr = z_r + s * kZPitch;
    float* zi = z_i + s * kZPitch;
    float ar[8], ai[8];
    branch_sums(ring_r, ring_i, s_taps, t, j, p, ar, ai);
    fft64(ar, ai, twr, twi, zr, zi, j, scale);
    if (t < T) store_row(ar, ai, yr, yi, (int64_t)t * kM, j);
    if constexpr (kFm) {
      __syncwarp();  // the group's reads of its exchange are done: the row takes y[t]
      float* c = carry + (k & 1) * 2 * kM;
#pragma unroll
      for (int k2 = 0; k2 < 8; ++k2) {
        zr[j + 8 * k2] = ar[k2];
        zi[j + 8 * k2] = ai[k2];
        if (s == kTile - 1) {
          c[j + 8 * k2] = ar[k2];
          c[kM + j + 8 * k2] = ai[k2];
        }
      }
      __syncthreads();
      const float* qr = s ? zr - kZPitch : carry + ((k + 1) & 1) * 2 * kM;  // y[t − 1]
      const float* qi = s ? zi - kZPitch : qr + kM;
      if (t < T) {
        const int64_t at = (int64_t)t * kM + j;
#pragma unroll
        for (int k2 = 0; k2 < 8; ++k2) {
          const int col = j + 8 * k2;
          fm[at + 8 * k2] = __fmul_rn(phase_step(qr[col], qi[col], ar[k2], ai[k2]), ref);
        }
        if (t == T - 1) {
#pragma unroll
          for (int k2 = 0; k2 < 8; ++k2) {
            rp_out[2 * (j + 8 * k2)] = ar[k2];
            rp_out[2 * (j + 8 * k2) + 1] = ai[k2];
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (kFm) {
    if (blockIdx.x == gridDim.x - 1) {  // the new history: cat(hist, x)[−nh:]
      const int64_t n = (int64_t)T * kM;
      for (int e = tid; e < nh; e += kThreads) {
        const int64_t g = n - nh + e;
        hist_r_out[e] = g >= 0 ? xr[g] : hist_r[nh + g];
        hist_i_out[e] = g >= 0 ? xi[g] : hist_i[nh + g];
      }
    }
  }
}

// The instance for p > kMaxOnePass, one block per 64 steps: the taps and the
// input rows they reach are staged kTapTile taps at a time, and u accumulates
// in shared memory across the tiles, in the one-pass instance's tap order;
// then the same FFT, 32 steps at a time.
__global__ void __launch_bounds__(kThreads)
channelizer_tiled_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                         const float* __restrict__ taps, const float* __restrict__ hr,
                         const float* __restrict__ hist_r, const float* __restrict__ hist_i,
                         float* __restrict__ yr, float* __restrict__ yi, int T, int p, int nh) {
  extern __shared__ __align__(16) float smem[];
  float* s_ur = smem;                         // [64][kUPitch]  u_c[t0 + s] at [c][s]
  float* s_ui = s_ur + kM * kUPitch;
  float* s_taps = s_ui + kM * kUPitch;        // [kTapTile][64]
  float* s_xr = s_taps + kTapTile * kM;       // [kSteps + kTapTile][64]
  float* s_xi = s_xr + (kSteps + kTapTile) * kM;
  float* z_r = s_xi + (kSteps + kTapTile) * kM;  // [kTile][kZPitch]
  float* z_i = z_r + kTile * kZPitch;

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kSteps;
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

  const int j = tid % kGroup;
  float twr[8], twi[8];
  twiddles(j, twr, twi);
  const float scale = hr[0];
  for (int s0 = 0; s0 < kSteps; s0 += kTile) {
    const int s = s0 + tid / kGroup;
    float ar[8], ai[8];
#pragma unroll
    for (int c1 = 0; c1 < 8; ++c1) {
      ar[c1] = s_ur[(8 * c1 + j) * kUPitch + s];
      ai[c1] = s_ui[(8 * c1 + j) * kUPitch + s];
    }
    fft64(ar, ai, twr, twi, z_r + (tid / kGroup) * kZPitch, z_i + (tid / kGroup) * kZPitch, j,
          scale);
    if (t0 + s < T) store_row(ar, ai, yr, yi, (int64_t)(t0 + s) * kM, j);
  }
}

// The one-pass instance's launch: as many blocks as the card holds at once,
// or fewer where that gives every block the same number of tiles (the last
// block may have fewer).
template <bool kFm>
int launch_onepass(const float* xr, const float* xi, const float* taps, const float* hr,
                   const float* hist_r, const float* hist_i, float* yr, float* yi, int T, int p,
                   int nh, const float* rp_in, float ref, float* fm, float* rp_out,
                   float* hist_r_out, float* hist_i_out, cudaStream_t st) {
  const size_t smem = onepass_smem_bytes(p, kFm);
  // past 48 KB, shared memory is dynamic only and must be allowed first
  cudaError_t err = cudaFuncSetAttribute(channelizer_fp32_kernel<kFm>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, channelizer_fp32_kernel<kFm>,
                                                        kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int nt = (T + kTile - 1) / kTile;
  const int places = sms * (per_sm > 0 ? per_sm : 1);
  const int each = (nt + places - 1) / places;
  channelizer_fp32_kernel<kFm><<<(nt + each - 1) / each, kThreads, smem, st>>>(
      xr, xi, taps, hr, hist_r, hist_i, yr, yi, T, p, nh, each, rp_in, ref, fm, rp_out,
      hist_r_out, hist_i_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Planar fp32 analysis of T steps. xr/xi [T·64] and hist_r/hist_i [nh], each
// 16-byte aligned; taps [p, 128], hr/hi [128, 128] from channelizer_tables
// (of which hr[0] is read); nh ≥ 64·p a multiple of 128; yr/yi [T, 64]
// step-major. T ≥ 1, T·64 < 2^31, p ≥ 1 (past 64 taps a branch the tiled
// instance runs). Launches on `stream` and returns the CUDA error of the
// launch (0 on success).
extern "C" int yagi_channelizer_fp32(const float* xr, const float* xi, const float* taps,
                                     const float* hr, const float* hi, const float* hist_r,
                                     const float* hist_i, float* yr, float* yi, int T, int p,
                                     int nh, void* stream) {
  (void)hi;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p > kMaxOnePass) {
    const size_t smem = tiled_smem_bytes();
    // past 48 KB, shared memory is dynamic only and must be allowed first
    const cudaError_t err = cudaFuncSetAttribute(
        channelizer_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    channelizer_tiled_kernel<<<(T + kSteps - 1) / kSteps, kThreads, smem, st>>>(
        xr, xi, taps, hr, hist_r, hist_i, yr, yi, T, p, nh);
    return (int)cudaGetLastError();
  }
  return launch_onepass<false>(xr, xi, taps, hr, hist_r, hist_i, yr, yi, T, p, nh, nullptr,
                               0.0f, nullptr, nullptr, nullptr, nullptr, st);
}

// The same analysis with the FM discriminator in its epilogue, in one launch:
// as yagi_channelizer_fp32 (p ≤ 64 only), and besides fm [T, 64] step-major,
// fm[t, k] = arg(conj(y[t − 1, k])·y[t, k])·ref with y[−1] = rp_in [64]
// (complex64, interleaved); rp_out [64] (complex64) = y[T − 1]; hist_r_out,
// hist_i_out [nh] = the last nh samples of the history followed by the block.
// The outputs alias no input. Returns cudaErrorInvalidValue past 64 taps.
extern "C" int yagi_channelizer_fm(const float* xr, const float* xi, const float* taps,
                                   const float* hr, const float* hist_r, const float* hist_i,
                                   const float* rp_in, float* yr, float* yi, float* fm,
                                   float* rp_out, float* hist_r_out, float* hist_i_out, int T,
                                   int p, int nh, float ref, void* stream) {
  if (p > kMaxOnePass) return (int)cudaErrorInvalidValue;
  return launch_onepass<true>(xr, xi, taps, hr, hist_r, hist_i, yr, yi, T, p, nh, rp_in, ref, fm,
                              rp_out, hist_r_out, hist_i_out, static_cast<cudaStream_t>(stream));
}
