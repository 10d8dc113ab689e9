// QamRx's equalizer / carrier loop over a block's symsync slots
// (qam_eq_scan), kLanes lanes per channel.
//
// Replaces the eq-only lax.scan of yagi_tpu/chains/qam.py
// (_step_masked_decoupled, qam.py:294-302), whose body is eq_slot
// (qam.py:173-247): yagi_tpu has no Pallas kernel here, XLA compiles the scan
// into one device loop. In eager torch a slot is ~75 small ops, a launch
// each; this kernel is the port's form of that compiled loop. Per channel
// and slot, in stream order:
//
//   push the slot into the h_len window (buffer, |x|² window, Σ|x|², count);
//   y = Σ_j conj(w_j)·buf_j, left to right over the taps;
//   is_sym = valid ∧ sym_phase = 0; can_adapt = is_sym ∧ Σ|x|² > ½·h_len;
//   v = y·e^{−jθ}; ŝ = the first table index of the smallest |v − t_m|²;
//   pe = Im(v·ŝ*)/max(|ŝ|², 1e-12); θ += dθ + α·pe, dθ += β·pe (can_adapt);
//   w += μ/max(Σ|x|², 1e-20)·conj(ŝ·e^{jθ} − y)·buf (can_adapt, count ≥ h_len);
//   sym_phase steps on a valid slot; the EVM sums add |v − ŝ|² (can_adapt);
//   out: ŝ, v, is_sym.
//
// It must equal its plain version (kernels/qam.py::qam_eq_scan_reference) bit
// for bit, because the loop feeds its decisions back and one ulp parts a
// channel for good on noise: every product, sum and quotient is
// __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn (never contracted into an FMA, as
// torch rounds each op), cos and sin are the CUDA math library's, as torch's
// are (sincosf: one range reduction for both, the same bits as cosf and
// sinf, 8% faster, PERF.md §6), the decision is the first index of the
// smallest distance (a NaN counts as smallest, as torch.argmin), and the
// clamps are comparisons so a NaN propagates as torch.clamp lets it.
//
// What bounds it on an H100: the slots are serial per channel, and the
// ~430 MB a config[3] block moves take ~0.13 ms, so the loop's issue rate and
// its chain of dependent operations are the limit. One thread per channel
// gives 64 warps for 2048 channels, each issuing ~500 instructions a slot in
// order, half of them the 16-way argmin (~2,500 cycles a slot, PERF.md §6).
// So each channel has kLanes lanes: 8, 512 warps at C = 2048, one per
// scheduler (16 lanes, two warps per scheduler, and 4 lanes both measured
// slower, PERF.md §6):
//
// * the argmin is lane-parallel: lane ℓ takes the points m ≡ ℓ (mod kLanes)
//   in increasing m, then an xor butterfly over the channel's lanes takes
//   the smallest key (NaN first, then the distance, then the index). That
//   is the index the serial strict-< scan from 0 picks, ties and NaNs
//   included: distances are ≥ 0 or NaN, so their bits order as the floats.
//   Each distance is the plain version's __fsub_rn/__fmul_rn/__fadd_rn.
// * the h_len-tap dot, cos/sin, the PLL and the LMS update run on every lane
//   of the channel, the same ops in the same order, so every lane holds the
//   same bits and no sum changes order.
// * each block stages a tile of its channels' slots (y, valid) in shared
//   memory with coalesced loads, issued into registers one tile ahead so they
//   fly while the loop runs, and writes syms, soft and mask back from shared
//   memory in coalesced rows.
//
// Up to kMaxRegTaps taps the window and weights live in registers (h_len is a
// template parameter, so the push is a register rename); a longer equalizer
// runs qam_eq_scan_smem_kernel, the same lane map, dot order and argmin with
// the window, |x|² window and weights of a channel in shared memory (5·h_len
// floats, the window a ring, the LMS update's taps split over the lanes). The
// table sits in shared memory, and a
// lane's own points in registers too where the table has at most kPts·kLanes
// (16-QAM: 2 a lane), so its distances wait on no load (14% faster than the
// loop over shared memory; 8 points a lane, most of them predicated off,
// was 6% slower: PERF.md §6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 8;  // lanes per channel: a power of two ≤ 32 (8 beat 4 and 16: PERF.md §6)
static_assert(kLanes >= 1 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0, "lanes");
constexpr int kChans = 16;                  // channels per block
constexpr int kThreads = kChans * kLanes;   // 128 at 8 lanes: 4 warps
constexpr int kPre = 8;                     // tile elements each thread loads
constexpr int kTile = kPre * kThreads / kChans;  // slots per tile: 8·kLanes
constexpr int kPitch = kTile + 1;   // 4- and 8-byte rows: channels on distinct banks
constexpr int kBPitch = kTile + 4;  // byte rows
constexpr int kPts = 2;  // table points a lane holds in registers (M ≤ kPts·kLanes)
constexpr int kMaxRegTaps = 16;  // h_len up to which the window lives in registers

struct EqIn {
  const float2 *w, *buf;
  const float *x2, *x2s;
  const int32_t* cnt;
  const float *theta, *dtheta;
  const int32_t* sph;
  const float *eacc, *ecnt;
};

struct EqOut {
  float2 *w, *buf;
  float *x2, *x2s;
  int32_t* cnt;
  float *theta, *dtheta;
  int32_t* sph;
  float *eacc, *ecnt;
};

__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }
// torch.clamp(v, min=lo): a NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }

// The argmin's order as one integer: NaN first, then the distance (≥ 0, so
// its bits order as the float), then the index.
__device__ __forceinline__ unsigned long long arg_key(float d, int m) {
  const unsigned k = isnan(d) ? 0u : __float_as_uint(d) + 1u;
  return ((unsigned long long)k << 32) | (unsigned)m;
}

__device__ __forceinline__ unsigned long long key_min(unsigned long long a,
                                                      unsigned long long b) {
  return b < a ? b : a;
}

// Thread tid moves tile elements tid + k·kThreads (row r, column col), so
// neighbouring threads touch neighbouring slots of one channel: the block's
// tile of slots [s0, s0 + kTile) into registers, zero past C or S.
__device__ __forceinline__ void fetch_tile(const float2* __restrict__ y,
                                           const uint8_t* __restrict__ valid, int c0, int s0,
                                           int C, int S, float2 (&py)[kPre],
                                           uint8_t (&pv)[kPre]) {
#pragma unroll
  for (int k = 0; k < kPre; ++k) {
    const int i = threadIdx.x + k * kThreads, r = i / kTile, col = i % kTile;
    const bool in_range = c0 + r < C && s0 + col < S;
    const size_t o = (size_t)(c0 + r) * S + s0 + col;
    py[k] = in_range ? y[o] : make_float2(0.0f, 0.0f);
    pv[k] = in_range ? valid[o] : 0;
  }
}

// Shared memory: the table [M], then per tile y and soft [kChans][kPitch]
// float2, syms [kChans][kPitch] int32, valid and mask [kChans][kBPitch].
size_t smem_bytes(int M) {
  return sizeof(float2) * (M + 2 * kChans * kPitch) + sizeof(int32_t) * kChans * kPitch +
         2 * kChans * kBPitch;
}

template <int H>
__global__ void __launch_bounds__(kThreads)
qam_eq_scan_kernel(const float2* __restrict__ y, const uint8_t* __restrict__ valid,
                   const float2* __restrict__ table, const float* __restrict__ mu_in,
                   const float* __restrict__ alpha_in, const float* __restrict__ beta_in, EqIn in,
                   int64_t* __restrict__ syms, float2* __restrict__ soft,
                   uint8_t* __restrict__ mask, EqOut out, int C, int S, int M, int k_eq) {
  extern __shared__ float2 smem[];
  float2* tab = smem;
  float2* yt = tab + M;
  float2* st = yt + kChans * kPitch;
  int32_t* symt = reinterpret_cast<int32_t*>(st + kChans * kPitch);
  uint8_t* vt = reinterpret_cast<uint8_t*>(symt + kChans * kPitch);
  uint8_t* mt = vt + kChans * kBPitch;

  const int tid = threadIdx.x;
  const int ch = tid / kLanes;
  const int lane = tid % kLanes;
  const int c0 = blockIdx.x * kChans;
  const bool live = c0 + ch < C;
  const int c = live ? c0 + ch : C - 1;  // a dead channel runs the last one, for the shuffles

  for (int i = tid; i < M; i += kThreads) tab[i] = table[i];

  const float mu = mu_in[c], alpha = alpha_in[c], beta = beta_in[c];
  const float half_h = 0.5f * H;
  float br[H], bi[H], x2t[H], wr[H], wi[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float2 b = in.buf[c * H + j], w = in.w[c * H + j];
    br[j] = b.x;
    bi[j] = b.y;
    wr[j] = w.x;
    wi[j] = w.y;
    x2t[j] = in.x2[c * H + j];
  }
  float x2s = in.x2s[c], theta = in.theta[c], dtheta = in.dtheta[c];
  float eacc = in.eacc[c], ecnt = in.ecnt[c];
  int32_t cnt = in.cnt[c], sph = in.sph[c];
  // this lane's points m = lane + k·kLanes, for tables that fit in registers
  const bool held = M <= kPts * kLanes;
  float2 pts[kPts];
#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    const int m = lane + k * kLanes;
    pts[k] = held && m < M ? table[m] : make_float2(0.0f, 0.0f);
  }

  float2 py[kPre];
  uint8_t pv[kPre];
  fetch_tile(y, valid, c0, 0, C, S, py, pv);

  for (int s0 = 0; s0 < S; s0 += kTile) {
    const int tn = min(kTile, S - s0);
#pragma unroll
    for (int k = 0; k < kPre; ++k) {  // park the tile fetched one tile ago
      const int i = tid + k * kThreads, r = i / kTile, col = i % kTile;
      yt[r * kPitch + col] = py[k];
      vt[r * kBPitch + col] = pv[k];
    }
    __syncthreads();
    if (s0 + kTile < S) fetch_tile(y, valid, c0, s0 + kTile, C, S, py, pv);  // in flight now

    for (int tt = 0; tt < tn; ++tt) {
      const float2 v = yt[ch * kPitch + tt];
      const bool vi = vt[ch * kBPitch + tt] != 0;
      // push (eqlms.rs:125)
      const float x2n = fa(fm(v.x, v.x), fm(v.y, v.y));
      float brp[H], bip[H], x2p[H];
#pragma unroll
      for (int j = 0; j + 1 < H; ++j) {
        brp[j] = br[j + 1];
        bip[j] = bi[j + 1];
        x2p[j] = x2t[j + 1];
      }
      brp[H - 1] = v.x;
      bip[H - 1] = v.y;
      x2p[H - 1] = x2n;
      const float x2sp = fs(fa(x2s, x2n), x2t[0]);
      const int32_t cntp = cnt + 1;
      // execute (eqlms.rs:137)
      float yr = fa(fm(wr[0], brp[0]), fm(wi[0], bip[0]));
      float yi = fs(fm(wr[0], bip[0]), fm(wi[0], brp[0]));
#pragma unroll
      for (int j = 1; j < H; ++j) {
        yr = fa(yr, fa(fm(wr[j], brp[j]), fm(wi[j], bip[j])));
        yi = fa(yi, fs(fm(wr[j], bip[j]), fm(wi[j], brp[j])));
      }
      const bool is_sym = vi && sph == 0;
      const bool can_adapt = is_sym && x2sp > half_h;
      // derotation and decision: this lane's points, then the channel's lanes
      float sn, co;
      sincosf(theta, &sn, &co);
      const float vr = fa(fm(yr, co), fm(yi, sn));
      const float vim = fs(fm(yi, co), fm(yr, sn));
      unsigned long long key = ~0ull;
      if (held) {
#pragma unroll
        for (int k = 0; k < kPts; ++k) {
          const int m = lane + k * kLanes;
          if (m < M) {
            const float dr = fs(vr, pts[k].x), di = fs(vim, pts[k].y);
            key = key_min(key, arg_key(fa(fm(dr, dr), fm(di, di)), m));
          }
        }
      } else {
        for (int m = lane; m < M; m += kLanes) {
          const float dr = fs(vr, tab[m].x), di = fs(vim, tab[m].y);
          key = key_min(key, arg_key(fa(fm(dr, dr), fm(di, di)), m));
        }
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        key = key_min(key, __shfl_xor_sync(kFull, key, off));
      const int sym = (int)(unsigned)key;
      const float sr = tab[sym].x, si = tab[sym].y;
      // PLL
      const float pe = __fdiv_rn(fs(fm(vim, sr), fm(vr, si)),
                                 clamp_min(fa(fm(sr, sr), fm(si, si)), 1e-12f));
      // LMS toward ŝ·e^{jθ} (eqlms.rs:170-187)
      const float ar = fs(fs(fm(sr, co), fm(si, sn)), yr);
      const float ai = fs(fa(fm(si, co), fm(sr, sn)), yi);
      const float g = __fdiv_rn(mu, clamp_min(x2sp, 1e-20f));
      if (can_adapt && cntp >= H) {
#pragma unroll
        for (int j = 0; j < H; ++j) {
          const float ur = fm(g, fa(fm(ar, brp[j]), fm(ai, bip[j])));
          const float ui = fm(g, fs(fm(ar, bip[j]), fm(ai, brp[j])));
          wr[j] = fa(wr[j], ur);
          wi[j] = fa(wi[j], ui);
        }
      }
      if (vi) {
#pragma unroll
        for (int j = 0; j < H; ++j) {
          br[j] = brp[j];
          bi[j] = bip[j];
          x2t[j] = x2p[j];
        }
        x2s = x2sp;
        cnt = cntp;
        if (k_eq == 2) {
          sph ^= 1;
        } else {
          sph = (sph + 1) % k_eq;
          if (sph < 0) sph += k_eq;
        }
      }
      if (can_adapt) {
        const float theta_n = fa(fa(theta, dtheta), fm(alpha, pe));
        dtheta = fa(dtheta, fm(beta, pe));
        theta = theta_n;
        const float er = fs(vr, sr), ei = fs(vim, si);
        eacc = fa(eacc, fa(fm(er, er), fm(ei, ei)));
        ecnt = fa(ecnt, 1.0f);
      }
      if (lane == 0) {
        symt[ch * kPitch + tt] = sym;
        st[ch * kPitch + tt] = make_float2(vr, vim);
        mt[ch * kBPitch + tt] = is_sym;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPre; ++k) {  // the tile's outputs, in coalesced rows
      const int i = tid + k * kThreads, r = i / kTile, col = i % kTile;
      if (c0 + r < C && col < tn) {
        const size_t o = (size_t)(c0 + r) * S + s0 + col;
        syms[o] = symt[r * kPitch + col];
        soft[o] = st[r * kPitch + col];
        mask[o] = mt[r * kBPitch + col];
      }
    }
    // the next park writes yt and vt, which no thread reads any more; the
    // output tiles are written again only after the next __syncthreads
  }

  if (live && lane == 0) {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      out.buf[c * H + j] = make_float2(br[j], bi[j]);
      out.w[c * H + j] = make_float2(wr[j], wi[j]);
      out.x2[c * H + j] = x2t[j];
    }
    out.x2s[c] = x2s;
    out.cnt[c] = cnt;
    out.theta[c] = theta;
    out.dtheta[c] = dtheta;
    out.sph[c] = sph;
    out.eacc[c] = eacc;
    out.ecnt[c] = ecnt;
  }
}

// A channel's stride in the shared-memory instance: wr, wi, br, bi, x2 of H
// floats each, odd so a warp's 4 channels read distinct banks.
int win_stride(int H) { return (5 * H) | 1; }

// The instance for h_len > kMaxRegTaps. The window is a ring: logical tap j
// of the pushed window (buffer shifted by one, the new slot last) is physical
// (head + 1 + j) mod H for j < H − 1 and the slot itself for j = H − 1; a valid
// slot then overwrites the oldest sample at `head`. Every lane forms the whole
// dot left to right (the same bits on all of them); the LMS update touches
// each tap once, so the lanes split the taps j ≡ lane (mod kLanes). The
// decision, the PLL and the outputs are the register instance's, op for op.
__global__ void __launch_bounds__(kThreads)
qam_eq_scan_smem_kernel(const float2* __restrict__ y, const uint8_t* __restrict__ valid,
                        const float2* __restrict__ table, const float* __restrict__ mu_in,
                        const float* __restrict__ alpha_in, const float* __restrict__ beta_in,
                        EqIn in, int64_t* __restrict__ syms, float2* __restrict__ soft,
                        uint8_t* __restrict__ mask, EqOut out, int C, int S, int M, int k_eq,
                        int H, int stride) {
  extern __shared__ float2 smem[];
  float2* tab = smem;
  float2* yt = tab + M;
  float2* st = yt + kChans * kPitch;
  int32_t* symt = reinterpret_cast<int32_t*>(st + kChans * kPitch);
  uint8_t* vt = reinterpret_cast<uint8_t*>(symt + kChans * kPitch);
  uint8_t* mt = vt + kChans * kBPitch;
  float* win = reinterpret_cast<float*>(mt + kChans * kBPitch);

  const int tid = threadIdx.x;
  const int ch = tid / kLanes;
  const int lane = tid % kLanes;
  const int c0 = blockIdx.x * kChans;
  const bool live = c0 + ch < C;
  const int c = live ? c0 + ch : C - 1;  // a dead channel runs the last one, for the shuffles

  for (int i = tid; i < M; i += kThreads) tab[i] = table[i];

  const float mu = mu_in[c], alpha = alpha_in[c], beta = beta_in[c];
  const float half_h = 0.5f * H;
  float* wr = win + ch * stride;
  float* wi = wr + H;
  float* br = wi + H;
  float* bi = br + H;
  float* x2t = bi + H;
  for (int j = lane; j < H; j += kLanes) {
    const float2 b = in.buf[(size_t)c * H + j], w = in.w[(size_t)c * H + j];
    br[j] = b.x;
    bi[j] = b.y;
    wr[j] = w.x;
    wi[j] = w.y;
    x2t[j] = in.x2[(size_t)c * H + j];
  }
  int head = 0;  // the oldest sample's place
  float x2s = in.x2s[c], theta = in.theta[c], dtheta = in.dtheta[c];
  float eacc = in.eacc[c], ecnt = in.ecnt[c];
  int32_t cnt = in.cnt[c], sph = in.sph[c];

  float2 py[kPre];
  uint8_t pv[kPre];
  fetch_tile(y, valid, c0, 0, C, S, py, pv);

  for (int s0 = 0; s0 < S; s0 += kTile) {
    const int tn = min(kTile, S - s0);
#pragma unroll
    for (int k = 0; k < kPre; ++k) {  // park the tile fetched one tile ago
      const int i = tid + k * kThreads, r = i / kTile, col = i % kTile;
      yt[r * kPitch + col] = py[k];
      vt[r * kBPitch + col] = pv[k];
    }
    __syncthreads();  // also: the table and the windows are in
    if (s0 + kTile < S) fetch_tile(y, valid, c0, s0 + kTile, C, S, py, pv);  // in flight now

    for (int tt = 0; tt < tn; ++tt) {
      const float2 v = yt[ch * kPitch + tt];
      const bool vi = vt[ch * kBPitch + tt] != 0;
      // push (eqlms.rs:125)
      const float x2n = fa(fm(v.x, v.x), fm(v.y, v.y));
      const float x2sp = fs(fa(x2s, x2n), x2t[head]);
      const int32_t cntp = cnt + 1;
      // execute (eqlms.rs:137) on the pushed window
      int p = head + 1 == H ? 0 : head + 1;
      float yr = fa(fm(wr[0], br[p]), fm(wi[0], bi[p]));
      float yi = fs(fm(wr[0], bi[p]), fm(wi[0], br[p]));
      for (int j = 1; j + 1 < H; ++j) {
        p = p + 1 == H ? 0 : p + 1;
        yr = fa(yr, fa(fm(wr[j], br[p]), fm(wi[j], bi[p])));
        yi = fa(yi, fs(fm(wr[j], bi[p]), fm(wi[j], br[p])));
      }
      yr = fa(yr, fa(fm(wr[H - 1], v.x), fm(wi[H - 1], v.y)));
      yi = fa(yi, fs(fm(wr[H - 1], v.y), fm(wi[H - 1], v.x)));
      const bool is_sym = vi && sph == 0;
      const bool can_adapt = is_sym && x2sp > half_h;
      // derotation and decision: this lane's points, then the channel's lanes
      float sn, co;
      sincosf(theta, &sn, &co);
      const float vr = fa(fm(yr, co), fm(yi, sn));
      const float vim = fs(fm(yi, co), fm(yr, sn));
      unsigned long long key = ~0ull;
      for (int m = lane; m < M; m += kLanes) {
        const float dr = fs(vr, tab[m].x), di = fs(vim, tab[m].y);
        key = key_min(key, arg_key(fa(fm(dr, dr), fm(di, di)), m));
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        key = key_min(key, __shfl_xor_sync(kFull, key, off));
      const int sym = (int)(unsigned)key;
      const float sr = tab[sym].x, si = tab[sym].y;
      // PLL
      const float pe = __fdiv_rn(fs(fm(vim, sr), fm(vr, si)),
                                 clamp_min(fa(fm(sr, sr), fm(si, si)), 1e-12f));
      // LMS toward ŝ·e^{jθ} (eqlms.rs:170-187), this lane's taps
      const float ar = fs(fs(fm(sr, co), fm(si, sn)), yr);
      const float ai = fs(fa(fm(si, co), fm(sr, sn)), yi);
      const float g = __fdiv_rn(mu, clamp_min(x2sp, 1e-20f));
      if (can_adapt && cntp >= H) {
        for (int j = lane; j < H; j += kLanes) {
          const int q = head + 1 + j < H ? head + 1 + j : head + 1 + j - H;
          const float xr = j == H - 1 ? v.x : br[q], xi = j == H - 1 ? v.y : bi[q];
          const float ur = fm(g, fa(fm(ar, xr), fm(ai, xi)));
          const float ui = fm(g, fs(fm(ar, xi), fm(ai, xr)));
          wr[j] = fa(wr[j], ur);
          wi[j] = fa(wi[j], ui);
        }
      }
      __syncwarp();  // every lane has read the oldest sample before it is replaced
      if (vi) {
        if (lane == 0) {  // the new slot takes the oldest sample's place
          br[head] = v.x;
          bi[head] = v.y;
          x2t[head] = x2n;
        }
        head = head + 1 == H ? 0 : head + 1;
        x2s = x2sp;
        cnt = cntp;
        if (k_eq == 2) {
          sph ^= 1;
        } else {
          sph = (sph + 1) % k_eq;
          if (sph < 0) sph += k_eq;
        }
      }
      __syncwarp();  // the weights and the window are written before the next slot reads
      if (can_adapt) {
        const float theta_n = fa(fa(theta, dtheta), fm(alpha, pe));
        dtheta = fa(dtheta, fm(beta, pe));
        theta = theta_n;
        const float er = fs(vr, sr), ei = fs(vim, si);
        eacc = fa(eacc, fa(fm(er, er), fm(ei, ei)));
        ecnt = fa(ecnt, 1.0f);
      }
      if (lane == 0) {
        symt[ch * kPitch + tt] = sym;
        st[ch * kPitch + tt] = make_float2(vr, vim);
        mt[ch * kBPitch + tt] = is_sym;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPre; ++k) {  // the tile's outputs, in coalesced rows
      const int i = tid + k * kThreads, r = i / kTile, col = i % kTile;
      if (c0 + r < C && col < tn) {
        const size_t o = (size_t)(c0 + r) * S + s0 + col;
        syms[o] = symt[r * kPitch + col];
        soft[o] = st[r * kPitch + col];
        mask[o] = mt[r * kBPitch + col];
      }
    }
  }

  if (live) {  // the window goes out oldest first
    for (int j = lane; j < H; j += kLanes) {
      const int q = head + j < H ? head + j : head + j - H;
      out.buf[(size_t)c * H + j] = make_float2(br[q], bi[q]);
      out.x2[(size_t)c * H + j] = x2t[q];
      out.w[(size_t)c * H + j] = make_float2(wr[j], wi[j]);
    }
    if (lane == 0) {
      out.x2s[c] = x2s;
      out.cnt[c] = cnt;
      out.theta[c] = theta;
      out.dtheta[c] = dtheta;
      out.sph[c] = sph;
      out.eacc[c] = eacc;
      out.ecnt[c] = ecnt;
    }
  }
}

cudaError_t launch_smem(const float2* y, const uint8_t* valid, const float2* table,
                        const float* mu, const float* alpha, const float* beta, const EqIn& in,
                        int64_t* syms, float2* soft, uint8_t* mask, const EqOut& out, int C,
                        int S, int M, int k_eq, int H, cudaStream_t stream) {
  const int blocks = (C + kChans - 1) / kChans;
  const int stride = win_stride(H);
  const int smem = (int)(smem_bytes(M) + sizeof(float) * kChans * stride);
  cudaError_t err = cudaFuncSetAttribute(qam_eq_scan_smem_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  qam_eq_scan_smem_kernel<<<blocks, kThreads, smem, stream>>>(
      y, valid, table, mu, alpha, beta, in, syms, soft, mask, out, C, S, M, k_eq, H, stride);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch(const float2* y, const uint8_t* valid, const float2* table, const float* mu,
                   const float* alpha, const float* beta, const EqIn& in, int64_t* syms,
                   float2* soft, uint8_t* mask, const EqOut& out, int C, int S, int M, int k_eq,
                   cudaStream_t stream) {
  const int blocks = (C + kChans - 1) / kChans;
  const int smem = (int)smem_bytes(M);
  cudaError_t err = cudaFuncSetAttribute(qam_eq_scan_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  qam_eq_scan_kernel<H><<<blocks, kThreads, smem, stream>>>(y, valid, table, mu, alpha, beta, in,
                                                            syms, soft, mask, out, C, S, M, k_eq);
  return cudaGetLastError();
}

}  // namespace

// y: [C, S] complex64 slots in stream order; valid: [C, S] uint8; table: [M]
// complex64; mu, alpha, beta: [C] float32; then the state (w, buffer
// [C, h_len] complex64; x2 [C, h_len], x2_sum [C] float32; count [C] int32;
// theta, dtheta [C] float32; sym_phase [C] int32; evm_accum, evm_count [C]
// float32); syms: [C, S] int64; soft: [C, S] complex64; mask: [C, S] uint8;
// then fresh arrays for the new state in the same order. h_len ≥ 1; past 16
// the shared-memory instance runs, while its 16·(5·h_len | 1) floats fit the
// block's shared memory.
// Launches on `stream`; returns the launch's CUDA error (0 on success).
extern "C" int yagi_qam_eq_scan(const void* y, const uint8_t* valid, const void* table,
                                const float* mu, const float* alpha, const float* beta,
                                const void* w, const void* buf, const float* x2,
                                const float* x2s, const int32_t* cnt, const float* theta,
                                const float* dtheta, const int32_t* sph, const float* eacc,
                                const float* ecnt, int64_t* syms, void* soft, uint8_t* mask,
                                void* w_out, void* buf_out, float* x2_out, float* x2s_out,
                                int32_t* cnt_out, float* theta_out, float* dtheta_out,
                                int32_t* sph_out, float* eacc_out, float* ecnt_out, int C, int S,
                                int M, int h_len, int k_eq, void* stream) {
  const EqIn in{static_cast<const float2*>(w), static_cast<const float2*>(buf), x2, x2s, cnt,
                theta, dtheta, sph, eacc, ecnt};
  const EqOut out{static_cast<float2*>(w_out), static_cast<float2*>(buf_out), x2_out, x2s_out,
                  cnt_out, theta_out, dtheta_out, sph_out, eacc_out, ecnt_out};
  const auto* yy = static_cast<const float2*>(y);
  const auto* tt = static_cast<const float2*>(table);
  auto* ss = static_cast<float2*>(soft);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (h_len) {
#define YAGI_QAM_CASE(H)                                                                  \
  case H:                                                                                 \
    err = launch<H>(yy, valid, tt, mu, alpha, beta, in, syms, ss, mask, out, C, S, M, k_eq, \
                    st);                                                                  \
    break;
    YAGI_QAM_CASE(1) YAGI_QAM_CASE(2) YAGI_QAM_CASE(3) YAGI_QAM_CASE(4)
    YAGI_QAM_CASE(5) YAGI_QAM_CASE(6) YAGI_QAM_CASE(7) YAGI_QAM_CASE(8)
    YAGI_QAM_CASE(9) YAGI_QAM_CASE(10) YAGI_QAM_CASE(11) YAGI_QAM_CASE(12)
    YAGI_QAM_CASE(13) YAGI_QAM_CASE(14) YAGI_QAM_CASE(15) YAGI_QAM_CASE(16)
#undef YAGI_QAM_CASE
    default:
      err = h_len > kMaxRegTaps ? launch_smem(yy, valid, tt, mu, alpha, beta, in, syms, ss, mask,
                                              out, C, S, M, k_eq, h_len, st)
                                : cudaErrorInvalidValue;
  }
  return (int)err;
}
