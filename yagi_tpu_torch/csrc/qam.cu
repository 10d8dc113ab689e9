// QamRx's equalizer / carrier loop over a block's symsync slots
// (qam_eq_scan), in rounds over segments.
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
// What bounds it on an H100: the ~430 MB a config[3] block moves take
// ~0.13 ms, so the loop's chain of dependent operations and its instruction rate
// are the limit. Walking every slot on the chain cost ~890 cycles a slot
// (PERF.md §6). But the state the decisions feed (w, θ, dθ, the EVM sums)
// moves only on a slot where can_adapt holds, and can_adapt, the window and
// Σ|x|² depend on the inputs alone (valid, the slots, sym_phase, the count),
// never on a decision. So the register instance (h_len ≤ kMaxRegTaps) runs
// rounds, not slots:
//
// * a segment is the run of slots after an adapting slot up to and including
//   the next one (or the tile's end). Every slot of it is decided from the
//   state the segment starts with; only its last slot, where it adapts, runs
//   the PLL, the LMS update and the EVM sums. A round decides up to kRW slots
//   of a segment at once, kRL lanes a slot (kRW·kRL lanes a channel); a
//   longer segment takes more rounds from the same state, and one with no
//   adapting slot (zeros, NaNs, energy under ½·h_len) is all parallel. The
//   chain is one slot's dot, decision and update a round: 3.7 slots a round
//   on config[3]'s traffic (segments of 4 slots, cut at each tile's end).
// * a planner warp copies the block's tile t + 1 of slots into shared memory
//   (cp.async, coalesced rows) and plans tile t while the rounds run tile
//   t − 1; a barrier a tile hands the plan over. It plans from the inputs
//   alone, with lanes over a channel's slots: each valid slot's place among
//   the channel's valid slots (a prefix count by ballot), its sym_phase and
//   count from that place, the valid samples and their |x|² into the
//   channel's rings; then, a lane a channel, Σ|x|² after each valid slot in
//   the plain version's order ((x2_sum + |x|²) − x2[0], the only serial
//   part); then the adapting slots and those that update the taps as bit
//   masks (lanes over slots), and the rounds cut from them (a lane a
//   channel).
// * in a round, each slot's group forms the slot's pushed window (the h_len − 1
//   valid samples before it from the ring, whose first h_len − 1 places are
//   copied past its end so a window reads on, then the slot), the dot left to
//   right, the derotation by the segment's θ and the argmin: lane ℓ of the
//   group takes the points m ≡ ℓ (mod kRL) in increasing m, then an xor
//   butterfly over the group takes the smallest key (NaN first, then the
//   distance, then the index), the index the serial strict-< scan from 0
//   picks, ties and NaNs included (distances are ≥ 0 or NaN, so their bits
//   order as the floats). Its first lane writes the slot's outputs. The last
//   slot's decision, v and y reach the channel's lanes by shuffles, and
//   every lane runs the update, the same ops in the same order, so every
//   lane holds the same state bits.
// * the kernel adds its rounds, summed over live channels, to a device
//   counter (one atomicAdd a block), which trace.snapshot() reads.
//
// The table sits in shared memory, and a lane's own points in registers too
// where the table has at most kRPts·kRL points (16-QAM), so its distances
// wait on no load. A longer equalizer runs qam_eq_scan_smem_kernel, which
// walks every slot: kLanes lanes a channel split the argmin as above, the
// window, |x|² window and weights of a channel in shared memory (5·h_len
// floats, the window a ring, the LMS update's taps split over the lanes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// the shared-memory instance's lanes per channel: a power of two ≤ 32
constexpr int kLanes = 8;
static_assert(kLanes >= 1 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0, "lanes");
constexpr int kChans = 16;                  // channels per block
constexpr int kThreads = kChans * kLanes;   // 128 at 8 lanes: 4 warps
constexpr int kPre = 8;                     // tile elements each thread loads
constexpr int kTile = kPre * kThreads / kChans;  // slots per tile: 8·kLanes
constexpr int kPitch = kTile + 1;   // 4- and 8-byte rows: channels on distinct banks
constexpr int kBPitch = kTile + 4;  // byte rows
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

// The register instance (h_len ≤ kMaxRegTaps) runs rounds. A segment is the
// run of slots after an adapting slot up to and including the next adapting
// slot (or the tile's end); every slot of it is decided from the state the
// segment starts with, and only its last slot, where it adapts, moves the
// state. A round decides up to kRW slots of one segment at once, kRL lanes a
// slot; a longer segment takes more rounds from the same state. 4 slots of 2
// lanes (4 channels a warp, 512 warps at C = 2048, one a scheduler) beat 4
// of 4 and 4 of 8 lanes (more warps, each issuing a round's update for fewer
// channels) and 8 of 2; 64-slot tiles beat 128 (PERF.md §6).
constexpr int kRW = 4;  // slots a round
constexpr int kRL = 2;  // lanes a slot: a power of two
constexpr int kRG = kRW * kRL;  // lanes a channel
static_assert((kRL & (kRL - 1)) == 0 && kRG <= 32 && 32 % kRG == 0, "round lanes");
constexpr int kRChans = 16;                 // channels a block: one planner lane each
static_assert(kRChans <= 32, "one planner warp");
constexpr int kCompute = kRChans * kRG;     // threads that run the rounds
constexpr int kRThreads = kCompute + 32;    // and the planner warp
constexpr int kRT = 64;                     // slots a tile: whole warps of slots
static_assert(kRT % 32 == 0 && kRT <= 255 && kRChans * kRT % 256 == 0,
              "the planner's passes; a round's start is a byte; the planner's loads");
static_assert(kRW < 32, "a round's slots within a mask word");
constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }
// a channel's valid samples kept: the h_len − 1 before a tile, that tile's and the next's
constexpr int kRing = pow2_at_least(2 * kRT + kMaxRegTaps - 1);
static_assert(kRing <= 0x4000, "a slot's window start in 14 bits");
constexpr int kRPts = (16 + kRL - 1) / kRL;  // table points a lane holds (up to 16-QAM)
// a ring's row: its places, then copies of the first kMaxRegTaps − 1 so a window
// reads on past the end; odd, so the planner's lanes (channels) hit distinct banks
constexpr int kHP = kRing + kMaxRegTaps + 1;
constexpr int kYP = kRT + 1, kWP = kRT + 2, kVP = kRT + 4, kMW = kRT / 32;
constexpr unsigned kAdapt = 1u << 16, kLms = 1u << 17;  // a round entry's flags
constexpr int kIsSym = 0x8000, kCountOk = 0x4000;      // a slot's flags beside its window start

// Shared memory of the register instance: the table [M]; y [3][kRChans][kYP]
// (three tiles: the one the rounds run, the one the planner plans, the one
// landing); each channel's rings over its valid samples [kRChans][kHP]: the
// samples, their |x|², and Σ|x|² after each; the rounds [2][kRChans][kYP]
// (start | n << 8 | flags); the adapting and tap-updating slots as bit masks
// [kRChans][2][kMW]; the round counts [2][kRChans]; valid [3][kRChans][kVP];
// each slot's window start | flags [2][kRChans][kWP] uint16.
size_t round_smem_bytes(int M) {
  return sizeof(float2) * (M + 3 * kRChans * kYP + kRChans * kHP) +
         sizeof(float) * (2 * kRChans * kHP + 2 * kRChans * kYP + 2 * kRChans * kMW +
                          2 * kRChans) +
         3 * kRChans * kVP + sizeof(uint16_t) * 2 * kRChans * kWP;
}

// Asynchronous copies from device to shared memory (cp.async, sm_80 on),
// `bytes` of them from src and zeros after, so a slot past C or S lands as
// zero; a thread's copies are waited on by groups, in the order committed.
__device__ __forceinline__ void copy8_async(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void copy4_async(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::); }
// every committed group but the newest has landed
__device__ __forceinline__ void wait_copies_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// sym_phase after v valid slots from sph0, as the slot-by-slot steps leave it
// (k_eq = 2 flips the low bit; otherwise the first step brings it into
// [0, k_eq), each next adds one mod k_eq)
__device__ __forceinline__ int32_t sym_phase_at(int32_t sph0, int v, int k_eq) {
  if (k_eq == 2) return sph0 ^ (v & 1);
  if (v == 0) return sph0;
  int32_t r = (sph0 + 1) % k_eq;
  if (r < 0) r += k_eq;
  return (int32_t)(((long long)r + v - 1) % k_eq);
}

// A round's plan entry and one group's slot of it, fetched a round ahead of
// its use so the loads fly while the previous round's chain runs: the entry
// (start | n << 8 | flags), the slot's window start | is_sym << 15, and its
// pushed window (the h_len − 1 valid samples before it, then the slot).
template <int H>
struct RoundSlot {
  unsigned e;
  int s, wq;
  float br[H], bi[H];
};

template <int H>
__device__ __forceinline__ void fetch_round(RoundSlot<H>& o, const unsigned* rr, int r, int nr,
                                            const uint16_t* wpr, const float2* hr,
                                            const float2* ytr, int grp) {
  o.e = r < nr ? rr[r] : 0u;
  const int start = o.e & 255, n = (o.e >> 8) & 255;
  o.s = start + (grp < n ? grp : 0);
  o.wq = wpr[o.s];
  const float2* w0 = hr + (o.wq & (kRing - 1));
#pragma unroll
  for (int j = 0; j + 1 < H; ++j) {
    const float2 h = w0[j];
    o.br[j] = h.x;
    o.bi[j] = h.y;
  }
  const float2 ys = ytr[o.s];
  o.br[H - 1] = ys.x;
  o.bi[H - 1] = ys.y;
}

template <int H>
__global__ void __launch_bounds__(kRThreads, 1)
qam_eq_scan_kernel(const float2* __restrict__ y, const uint8_t* __restrict__ valid,
                   const float2* __restrict__ table, const float* __restrict__ mu_in,
                   const float* __restrict__ alpha_in, const float* __restrict__ beta_in, EqIn in,
                   int64_t* __restrict__ syms, float2* __restrict__ soft,
                   uint8_t* __restrict__ mask, EqOut out, int C, int S, int M, int k_eq,
                   int64_t* __restrict__ rounds_out) {
  extern __shared__ float2 smem[];
  float2* tab = smem;
  float2* yt = tab + M;
  float2* hist = yt + 3 * kRChans * kYP;
  float* x2c = reinterpret_cast<float*>(hist + kRChans * kHP);
  float* x2p = x2c + kRChans * kHP;
  unsigned* rl = reinterpret_cast<unsigned*>(x2p + kRChans * kHP);
  unsigned* msk = rl + 2 * kRChans * kYP;
  int* nrs = reinterpret_cast<int*>(msk + 2 * kRChans * kMW);
  uint8_t* vt = reinterpret_cast<uint8_t*>(nrs + 2 * kRChans);
  uint16_t* wp = reinterpret_cast<uint16_t*>(vt + 3 * kRChans * kVP);

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kRChans;
  const int nT = (S + kRT - 1) / kRT;
  const float half_h = 0.5f * H;
  for (int i = tid; i < M; i += kRThreads) tab[i] = table[i];

  if (tid >= kCompute) {  // ---- the planner: a tile ahead of the rounds
    // A lane is a channel for the carried scalars and the serial Σ|x|², a
    // slot in the passes over a channel's tile.
    const int pl = tid - kCompute;
    const bool live = pl < kRChans && c0 + pl < C;
    const int c = c0 + pl;
    const unsigned below = (1u << pl) - 1u;  // the lanes before this one
    float x2s = 0.0f;
    int32_t cnt0 = 0, sph0 = 0;
    int vidx = 0;  // the channel's valid slots so far: its rings' next place
    long long rounds = 0;
    if (live) {  // the window goes in oldest first, at places −H … −1
      for (int j = 0; j < H; ++j) {
        hist[pl * kHP + ((j - H) & (kRing - 1))] = in.buf[c * H + j];
        x2c[pl * kHP + ((j - H) & (kRing - 1))] = in.x2[c * H + j];
      }
      x2s = in.x2s[c];
      cnt0 = in.cnt[c];
      sph0 = in.sph[c];
    }
    // Step u copies tile u's slots of the block's channels into y and valid
    // buffer u % 3 (coalesced rows, asynchronous; valid 4 slots a copy where
    // S allows, else a byte at a time through registers), then plans tile
    // u − 1, whose copies have landed, before barrier u − 1: the first tile
    // before the rounds start, each next one while they run the one before.
    const bool words = S % 4 == 0;
    for (int u = 0; u <= nT + 1; ++u) {
      if (u < nT) {
        const int s0 = u * kRT, b = u % 3;
#pragma unroll
        for (int k = 0; k < kRChans * kRT / 32; ++k) {
          const int i = pl + k * 32, r = i / kRT, col = i % kRT;
          const bool in_range = c0 + r < C && s0 + col < S;
          copy8_async(&yt[(b * kRChans + r) * kYP + col],
                      in_range ? y + (size_t)(c0 + r) * S + s0 + col : y, in_range ? 8 : 0);
        }
        for (int i = pl; i < kRChans * kRT / 4; i += 32) {
          const int r = i / (kRT / 4), col = i % (kRT / 4) * 4;
          uint8_t* dst = &vt[(b * kRChans + r) * kVP + col];
          const size_t o = (size_t)(c0 + r) * S + s0 + col;
          if (words) {
            const bool in_range = c0 + r < C && s0 + col < S;
            copy4_async(dst, in_range ? valid + o : valid, in_range ? 4 : 0);
          } else {
            for (int k = 0; k < 4; ++k) dst[k] = c0 + r < C && s0 + col + k < S ? valid[o + k] : 0;
          }
        }
      }
      commit_copies();
      if (u == 0) continue;
      const int t = u - 1;
      if (t < nT) {
        const int s0 = t * kRT, b = t & 1, bt = t % 3, tn = min(kRT, S - s0);
        wait_copies_but_newest();
        __syncwarp();
        // lanes over slots, kBatch channels at a time (their loads ahead of
        // their stores): each valid slot's place among the channel's valid
        // slots (a prefix count), its sym_phase and count from that place,
        // the slot's window start and flags, and the valid samples and
        // their |x|² into the channel's rings
        const int v0 = vidx;
        constexpr int kBatch = 4;
        static_assert(kRChans % kBatch == 0, "whole batches of channels");
        for (int c1 = 0; c1 < kRChans; c1 += kBatch) {
          float2 v[kBatch][kMW];
          bool vi[kBatch][kMW];
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
#pragma unroll
            for (int h = 0; h < kMW; ++h) {
              const int ch = c1 + i, s = h * 32 + pl;
              v[i][h] = yt[(bt * kRChans + ch) * kYP + s];
              vi[i][h] = c0 + ch < C && s < tn && vt[(bt * kRChans + ch) * kVP + s] != 0;
            }
          }
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            const int ch = c1 + i;
            int vb = __shfl_sync(kFull, vidx, ch);
            const int32_t sp = __shfl_sync(kFull, sph0, ch), cn = __shfl_sync(kFull, cnt0, ch);
            const bool lv = c0 + ch < C;
#pragma unroll
            for (int h = 0; h < kMW; ++h) {
              const int s = h * 32 + pl;
              const unsigned bal = __ballot_sync(kFull, vi[i][h]);
              const int vid = vb + __popc(bal & below);
              const bool is_sym = vi[i][h] && sym_phase_at(sp, vid, k_eq) == 0;
              const bool count_ok = (int32_t)((uint32_t)cn + (uint32_t)vid + 1u) >= H;
              if (lv && s < tn)
                wp[(b * kRChans + ch) * kWP + s] =
                    (uint16_t)(((vid - (H - 1)) & (kRing - 1)) | (count_ok ? kCountOk : 0) |
                               (is_sym ? kIsSym : 0));
              if (vi[i][h]) {
                const int at = vid & (kRing - 1);
                hist[ch * kHP + at] = v[i][h];
                if (at < kMaxRegTaps - 1) hist[ch * kHP + kRing + at] = v[i][h];
                x2c[ch * kHP + (vid & (kRing - 1))] =
                    fa(fm(v[i][h].x, v[i][h].x), fm(v[i][h].y, v[i][h].y));
              }
              vb += __popc(bal);
            }
            if (pl == ch) vidx = vb;
          }
        }
        __syncwarp();
        // lane = channel: Σ|x|² after each of the tile's valid slots, the only
        // serial part, as (x2_sum + |x|²) − x2[0] in the plain version's
        // order, four at a time (their loads ahead of the chain)
        if (live) {
          const float* xc = x2c + pl * kHP;
          float* xp = x2p + pl * kHP;
          for (int k = v0; k < vidx; k += 4) {
            float xn[4], xo[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              xn[i] = xc[(k + i) & (kRing - 1)];
              xo[i] = xc[(k + i - H) & (kRing - 1)];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (k + i < vidx) {
                x2s = fs(fa(x2s, xn[i]), xo[i]);
                xp[(k + i) & (kRing - 1)] = x2s;
              }
            }
          }
        }
        __syncwarp();
        // lanes over slots, kBatch channels at a time: the adapting slots
        // (is_sym ∧ Σ|x|² > ½·h_len) and those that also update the taps
        // (count ≥ h_len), as bit masks
        for (int c1 = 0; c1 < kRChans; c1 += kBatch) {
          int wq[kBatch][kMW];
          float x2[kBatch][kMW];
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
#pragma unroll
            for (int h = 0; h < kMW; ++h) {
              const int s = h * 32 + pl;
              wq[i][h] = s < tn ? wp[(b * kRChans + c1 + i) * kWP + s] : 0;
            }
          }
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
#pragma unroll
            for (int h = 0; h < kMW; ++h)
              x2[i][h] = x2p[(c1 + i) * kHP + ((wq[i][h] + H - 1) & (kRing - 1))];
          }
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
#pragma unroll
            for (int h = 0; h < kMW; ++h) {
              const bool can_adapt = (wq[i][h] & kIsSym) && x2[i][h] > half_h;
              const unsigned ab = __ballot_sync(kFull, can_adapt);
              const unsigned lb = __ballot_sync(kFull, can_adapt && (wq[i][h] & kCountOk));
              if (pl == 0) {
                msk[((c1 + i) * 2) * kMW + h] = ab;
                msk[((c1 + i) * 2 + 1) * kMW + h] = lb;
              }
            }
          }
        }
        __syncwarp();
        // lane = channel: the rounds, cut at each adapting slot, every kRW
        // slots and at the tile's end
        if (pl < kRChans) {
          unsigned am[kMW + 1], lm[kMW];
#pragma unroll
          for (int h = 0; h < kMW; ++h) {
            am[h] = msk[(pl * 2) * kMW + h];
            lm[h] = msk[(pl * 2 + 1) * kMW + h];
          }
          am[kMW] = 0;
          unsigned* rr = rl + (b * kRChans + pl) * kYP;
          int nr = 0;
          for (int start = 0; live && start < tn;) {
            const int word = start >> 5, off = start & 31, reach = min(kRW, tn - start);
            unsigned lo = 0, hi = 0;  // the mask words at word and word + 1 (registers: unrolled picks)
#pragma unroll
            for (int h = 0; h < kMW; ++h) {
              if (h == word) lo = am[h];
              if (h == word + 1) hi = am[h];
            }
            unsigned bits = lo >> off;
            if (off + reach > 32) bits |= hi << (32 - off);
            bits &= (1u << reach) - 1u;
            const int n = bits ? __ffs(bits) : reach, last = start + n - 1;
            unsigned lw = 0;
#pragma unroll
            for (int h = 0; h < kMW; ++h)
              if (h == last >> 5) lw = lm[h];
            rr[nr++] = start | n << 8 | (bits ? kAdapt : 0u) | ((lw >> (last & 31)) & 1u ? kLms : 0u);
            start = last + 1;
          }
          nrs[b * kRChans + pl] = nr;
          rounds += nr;
        }
      }
      __syncthreads();
    }
    if (live) {  // the window goes out oldest first
      for (int j = 0; j < H; ++j) {
        out.buf[c * H + j] = hist[pl * kHP + ((vidx - H + j) & (kRing - 1))];
        out.x2[c * H + j] = x2c[pl * kHP + ((vidx - H + j) & (kRing - 1))];
      }
      out.x2s[c] = x2s;
      out.cnt[c] = (int32_t)((uint32_t)cnt0 + (uint32_t)vidx);
      out.sph[c] = sym_phase_at(sph0, vidx, k_eq);
    }
    if (rounds_out != nullptr) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) rounds += __shfl_xor_sync(kFull, rounds, off);
      if (pl == 0) atomicAdd(reinterpret_cast<unsigned long long*>(rounds_out),
                             (unsigned long long)rounds);
    }
    return;
  }

  // ---- the rounds: kRG lanes a channel, group g of kRL lanes on a round's slot g
  const int ch = tid / kRG, q = tid % kRG, grp = q / kRL, sub = q % kRL;
  const int base = (tid & 31) & ~(kRG - 1);  // the channel's first lane in the warp
  const bool live = c0 + ch < C;
  const int c = live ? c0 + ch : C - 1;  // a dead channel runs the last one's state, unwritten
  const float mu = mu_in[c], alpha = alpha_in[c], beta = beta_in[c];
  float wr[H], wi[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float2 w = in.w[c * H + j];
    wr[j] = w.x;
    wi[j] = w.y;
  }
  float theta = in.theta[c], dtheta = in.dtheta[c], eacc = in.eacc[c], ecnt = in.ecnt[c];
  float sn, co;
  sincosf(theta, &sn, &co);
  // this lane's points m = sub + k·kRL, for tables that fit in registers;
  // past M, point 0 at index m, which never wins: point 0's own key (in
  // lane 0) has the same distance and a smaller index
  const bool held = M <= kRPts * kRL;
  float2 pts[kRPts];
#pragma unroll
  for (int k = 0; k < kRPts; ++k) {
    const int m = sub + k * kRL;
    pts[k] = held ? table[m < M ? m : 0] : make_float2(0.0f, 0.0f);
  }
  const float2* hr = hist + ch * kHP;
  __syncthreads();  // the table, and the planner's first tile

  for (int t = 0; t < nT; ++t) {
    const int b = t & 1, s0 = t * kRT;
    const float2* ytr = yt + (t % 3 * kRChans + ch) * kYP;
    const uint16_t* wpr = wp + (b * kRChans + ch) * kWP;
    const unsigned* rr = rl + (b * kRChans + ch) * kYP;
    const int nr = nrs[b * kRChans + ch];
    const int rmax = kRG == 32 ? nr : __reduce_max_sync(kFull, nr);
    int64_t* srow = syms + (size_t)c * S + s0;  // the tile's outputs of this channel
    float2* frow = soft + (size_t)c * S + s0;
    uint8_t* mrow = mask + (size_t)c * S + s0;
    RoundSlot<H> cur;
    fetch_round(cur, rr, 0, nr, wpr, hr, ytr, grp);
    for (int r = 0; r < rmax; ++r) {
      RoundSlot<H> nxt;
      if (r + 1 < rmax) fetch_round(nxt, rr, r + 1, nr, wpr, hr, ytr, grp);
      const unsigned e = cur.e;
      const int start = e & 255, n = (e >> 8) & 255, last = start + n - 1;
      // the last slot's window and Σ|x|², for the LMS update
      float lr[H], li[H];
      const int we = wpr[last > 0 ? last : 0];
      const float2* w1 = hr + (we & (kRing - 1));
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float2 x = j + 1 < H ? w1[j] : ytr[last > 0 ? last : 0];
        lr[j] = x.x;
        li[j] = x.y;
      }
      const float x2e = x2p[ch * kHP + ((we + H - 1) & (kRing - 1))];
      // y = Σ_j conj(w_j)·buf_j left to right (eqlms.rs:137)
      float yr = fa(fm(wr[0], cur.br[0]), fm(wi[0], cur.bi[0]));
      float yi = fs(fm(wr[0], cur.bi[0]), fm(wi[0], cur.br[0]));
#pragma unroll
      for (int j = 1; j < H; ++j) {
        yr = fa(yr, fa(fm(wr[j], cur.br[j]), fm(wi[j], cur.bi[j])));
        yi = fa(yi, fs(fm(wr[j], cur.bi[j]), fm(wi[j], cur.br[j])));
      }
      // derotation by the segment's θ and decision: this lane's points, then the slot's lanes
      const float vr = fa(fm(yr, co), fm(yi, sn));
      const float vim = fs(fm(yi, co), fm(yr, sn));
      unsigned long long key = ~0ull;
      if (held) {
        unsigned long long k2[kRPts];
#pragma unroll
        for (int k = 0; k < kRPts; ++k) {
          const int m = sub + k * kRL;
          const float dr = fs(vr, pts[k].x), di = fs(vim, pts[k].y);
          k2[k] = arg_key(fa(fm(dr, dr), fm(di, di)), m);
        }
#pragma unroll
        for (int w = 1; w < kRPts; w *= 2) {  // a tree: the order of a min does not matter
#pragma unroll
          for (int k = 0; k + w < kRPts; k += 2 * w) k2[k] = key_min(k2[k], k2[k + w]);
        }
        key = k2[0];
      } else {
        for (int m = sub; m < M; m += kRL) {
          const float dr = fs(vr, tab[m].x), di = fs(vim, tab[m].y);
          key = key_min(key, arg_key(fa(fm(dr, dr), fm(di, di)), m));
        }
      }
#pragma unroll
      for (int off = kRL / 2; off > 0; off >>= 1)
        key = key_min(key, __shfl_xor_sync(kFull, key, off));
      const int sym = (int)(unsigned)key;
      if (live && grp < n && sub == 0) {
        srow[cur.s] = sym;
        frow[cur.s] = make_float2(vr, vim);
        mrow[cur.s] = (uint8_t)(cur.wq >> 15);
      }
      // the round's last slot, from its group's first lane, to the channel's lanes
      const int src = base + (n > 0 ? n - 1 : 0) * kRL;
      const int sym_e = __shfl_sync(kFull, sym, src);
      const float vr_e = __shfl_sync(kFull, vr, src), vi_e = __shfl_sync(kFull, vim, src);
      const float yr_e = __shfl_sync(kFull, yr, src), yi_e = __shfl_sync(kFull, yi, src);
      if (e & kAdapt) {
        const float sr = tab[sym_e].x, si = tab[sym_e].y;
        // PLL
        const float pe = __fdiv_rn(fs(fm(vi_e, sr), fm(vr_e, si)),
                                   clamp_min(fa(fm(sr, sr), fm(si, si)), 1e-12f));
        // LMS toward ŝ·e^{jθ} (eqlms.rs:170-187), on the last slot's window,
        // where it updates the taps
        const bool lms = e & kLms;
        const float ar = fs(fs(fm(sr, co), fm(si, sn)), yr_e);
        const float ai = fs(fa(fm(si, co), fm(sr, sn)), yi_e);
        const float g = __fdiv_rn(mu, clamp_min(x2e, 1e-20f));
#pragma unroll
        for (int j = 0; j < H; ++j) {
          const float ur = fm(g, fa(fm(ar, lr[j]), fm(ai, li[j])));
          const float ui = fm(g, fs(fm(ar, li[j]), fm(ai, lr[j])));
          wr[j] = lms ? fa(wr[j], ur) : wr[j];
          wi[j] = lms ? fa(wi[j], ui) : wi[j];
        }
        const float theta_n = fa(fa(theta, dtheta), fm(alpha, pe));
        dtheta = fa(dtheta, fm(beta, pe));
        theta = theta_n;
        const float er = fs(vr_e, sr), ei = fs(vi_e, si);
        eacc = fa(eacc, fa(fm(er, er), fm(ei, ei)));
        ecnt = fa(ecnt, 1.0f);
        sincosf(theta, &sn, &co);
      }
      cur = nxt;
    }
    __syncthreads();  // the planner's next tile is in; this one's buffers are free
  }

  if (live && q == 0) {
#pragma unroll
    for (int j = 0; j < H; ++j) out.w[c * H + j] = make_float2(wr[j], wi[j]);
    out.theta[c] = theta;
    out.dtheta[c] = dtheta;
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
                   int64_t* rounds, cudaStream_t stream) {
  const int blocks = (C + kRChans - 1) / kRChans;
  const int smem = (int)round_smem_bytes(M);
  cudaError_t err = cudaFuncSetAttribute(qam_eq_scan_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  qam_eq_scan_kernel<H><<<blocks, kRThreads, smem, stream>>>(
      y, valid, table, mu, alpha, beta, in, syms, soft, mask, out, C, S, M, k_eq, rounds);
  return cudaGetLastError();
}

}  // namespace

// y: [C, S] complex64 slots in stream order; valid: [C, S] uint8; table: [M]
// complex64; mu, alpha, beta: [C] float32; then the state (w, buffer
// [C, h_len] complex64; x2 [C, h_len], x2_sum [C] float32; count [C] int32;
// theta, dtheta [C] float32; sym_phase [C] int32; evm_accum, evm_count [C]
// float32); syms: [C, S] int64; soft: [C, S] complex64; mask: [C, S] uint8;
// then fresh arrays for the new state in the same order. h_len ≥ 1; up to 16
// the register instance runs, and adds the rounds it ran (summed over
// channels) to *rounds, a device int64, unless rounds is null; past 16 the
// shared-memory instance runs (rounds untouched), while its
// 16·(5·h_len | 1) floats fit the block's shared memory.
// Launches on `stream`; returns the launch's CUDA error (0 on success).
extern "C" int yagi_qam_eq_scan_counted(
    const void* y, const uint8_t* valid, const void* table, const float* mu, const float* alpha,
    const float* beta, const void* w, const void* buf, const float* x2, const float* x2s,
    const int32_t* cnt, const float* theta, const float* dtheta, const int32_t* sph,
    const float* eacc, const float* ecnt, int64_t* syms, void* soft, uint8_t* mask, void* w_out,
    void* buf_out, float* x2_out, float* x2s_out, int32_t* cnt_out, float* theta_out,
    float* dtheta_out, int32_t* sph_out, float* eacc_out, float* ecnt_out, int C, int S, int M,
    int h_len, int k_eq, int64_t* rounds, void* stream) {
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
                    rounds, st);                                                          \
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
