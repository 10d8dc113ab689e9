// The IIR recurrences over a block: iir_scan (sequential) and iir_chunked.
//
// They stand for the XLA loops of yagi_tpu's IIR filters, which have no
// Pallas kernel: the sequential per-sample scan (planar_scan,
// yagi_tpu/filter/iirfilt.py:317 and iirfiltsos.py:98) and the log-depth
// associative scan of parallelize()d filters (yagi_tpu/filter/_linrec.py:76
// and :89). The recurrence body is csrc/iir.cuh; the layouts and the shape
// gates are mirrored in kernels/iir.py (scan_instance, chunked_smem_bytes):
// change them together.
//
// iir_scan. One loop thread per channel runs the recurrence in the order of
// iir.cuh and equals kernels/iir.py::iir_scan_reference bit for bit. The
// recurrence is serial per channel (for a first-order filter the chain is
// x → a·v → v0 → b·v0 → ·scale, ~5 dependent operations a sample), so the
// time is T × that chain whatever the channel count; what the design keeps
// off the chain is memory. As in csrc/agc.cu, a block owns kChans channels:
// warp 0 loops out of shared memory (rows of kTile + 1 samples, the loop
// threads on distinct banks) and parks y there, warps 1–4 bring the next
// slab of x in with coalesced cp.async and store the last slab's y in
// coalesced rows; the two meet at one barrier a slab. A state of up to kReg
// values (TF order m, SOS 2·nsos) lives in registers; a longer one in a ring
// in shared memory, or in device memory where shared memory cannot hold it.
//
// iir_chunked. A parallelize()d filter on the card: with one thread per
// channel config[2]'s 512 channels would fill 4 of 132 SMs' worth of warps.
// One block per channel; its row is cut into segments of kCT chunks of kCL
// samples, one thread a chunk, held in shared memory (pitch kCL + 1: the
// chunk threads on distinct banks). Per segment and stage (a TF filter is one
// stage of order m, an SOS filter nsos stages of order 2, one after another):
//   1. each chunk runs the all-pole recurrence from a zero state (chunk 0
//      from the state carried into the segment): its end state;
//   2. the end states are carried along the segment by a doubling
//      (Kogge–Stone) scan, s_j ← s_j + Q_d·s_{j−2^d}, with Q_d = M^(kCL·2^d)
//      the companion matrix's chunk powers (_linrec.py's composition; formed
//      in float64 once per block), so s_j becomes chunk j's true end state;
//   3. each chunk reruns the whole DF-II step (iir.cuh's tf_step) from the
//      end state of the chunk before it, writing the stage's output over its
//      input.
// Then the segment is scaled and stored. This is the same recurrence in
// another summation order: it is held by tolerance to its plain version,
// kernels/iir.py::iir_chunked_reference (yagi_tpu's parallel route). The
// function is a streaming one (config[2]: 33.5 MB in, 33.5 MB out a filter,
// 0.020 ms at 3.35 TB/s; ~10 operations a sample); the design reads and
// writes each sample once, in coalesced rows, and keeps every pass and the
// scan in shared memory and registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "iir.cuh"

namespace {

using yagi_iir::Ops;

constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

// ------------------------------------------------------------------ iir_scan
constexpr int kChans = 8;      // loop threads (channels) a block
constexpr int kCopiers = 128;  // threads that copy: warps 1 to 4
constexpr int kThreads = 32 + kCopiers;
constexpr int kTile = 128;  // samples a slab
constexpr int kPitch = kTile + 1;
constexpr int kSlab = kChans * kPitch;
constexpr int kReg = 8;  // state values held in registers
enum : int { kInstRegister = 0, kInstShared = 1, kInstGlobal = 2 };

int scan_smem_bytes(int state_len, int elem, int inst) {
  return 4 * kSlab * elem + (inst == kInstShared ? kChans * state_len * elem : 0);
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem), "n"(kBytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// The slab x[c0 + r][t0 .. t0 + w) of the block's channels into rows of
// kPitch, neighbouring copying threads on neighbouring samples; one commit.
template <class E>
__device__ __forceinline__ void fill(E* dst, const E* __restrict__ x, int c0, int t0, int w,
                                     int C, int T, int who) {
  for (int i = who; i < kChans * w; i += kCopiers) {
    const int r = i / w, col = i % w;
    if (c0 + r < C) cp_async<sizeof(E)>(dst + r * kPitch + col, x + (size_t)(c0 + r) * T + t0 + col);
  }
  cp_async_commit();
}

template <class E>
__device__ __forceinline__ void drain(const E* src, E* __restrict__ y, int c0, int t0, int w,
                                      int C, int T, int who) {
  for (int i = who; i < kChans * w; i += kCopiers) {
    const int r = i / w, col = i % w;
    if (c0 + r < C) y[(size_t)(c0 + r) * T + t0 + col] = src[r * kPitch + col];
  }
}

// State value i of a ring in shared memory (stride kChans, one column a loop
// thread) or in device memory (stride C, one column a channel).
template <class E>
struct Ring {
  E* base;
  int stride;
  __device__ __forceinline__ E& at(int i) const { return base[(size_t)i * stride]; }
};

template <bool kCx, bool kCc, bool kSos, int kInst>
__global__ void __launch_bounds__(kThreads)
iir_scan_kernel(const typename Ops<kCx, kCc>::Elem* __restrict__ x, const float* __restrict__ b,
                const float* __restrict__ a, const float* __restrict__ scale,
                const typename Ops<kCx, kCc>::Elem* __restrict__ v_in,
                typename Ops<kCx, kCc>::Elem* __restrict__ y,
                typename Ops<kCx, kCc>::Elem* __restrict__ v_out,
                typename Ops<kCx, kCc>::Elem* __restrict__ scratch, int C, int T, int m) {
  using O = Ops<kCx, kCc>;
  using E = typename O::Elem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* xs = reinterpret_cast<E*>(smem_raw);  // [2][kSlab]
  E* ys = xs + 2 * kSlab;                  // [2][kSlab]
  const int tid = threadIdx.x;
  const bool copier = tid >= 32;
  const int who = tid - 32;
  const int c0 = blockIdx.x * kChans;
  const bool loops = tid < kChans && c0 + tid < C;  // this thread runs a channel's loop
  const int c = loops ? c0 + tid : c0;
  const int S = kSos ? 2 * m : m;  // state values
  const float2 sc = O::coef(scale, 0);

  // the register instance's state and coefficients (TF: ca, cb; SOS: so,
  // the sections' a1, a2, b0, b1, b2)
  float2 v[kReg], ca[kReg + 1], cb[kReg + 1];
  float so[5][kReg / 2];
  // the ring instances' state
  Ring<E> ring{kInst == kInstShared ? ys + 2 * kSlab + tid : scratch + c,
               kInst == kInstShared ? kChans : C};
  int head = 0;  // TF ring: value k (0 newest) is at (head + k) mod m
  if (loops) {
    if constexpr (kInst == kInstRegister) {
#pragma unroll
      for (int k = 0; k < kReg; ++k) v[k] = k < S ? O::load(v_in[(size_t)c * S + k]) : make_float2(0.f, 0.f);
      if constexpr (kSos) {
#pragma unroll
        for (int s = 0; s < kReg / 2; ++s) {
          const bool on = s < m;
          so[0][s] = on ? a[3 * s + 1] : 0.f;
          so[1][s] = on ? a[3 * s + 2] : 0.f;
          so[2][s] = on ? b[3 * s] : 0.f;
          so[3][s] = on ? b[3 * s + 1] : 0.f;
          so[4][s] = on ? b[3 * s + 2] : 0.f;
        }
      } else {
#pragma unroll
        for (int k = 0; k <= kReg; ++k) {
          ca[k] = k <= m ? O::coef(a, k) : make_float2(0.f, 0.f);
          cb[k] = k <= m ? O::coef(b, k) : make_float2(0.f, 0.f);
        }
      }
    } else {
      for (int k = 0; k < S; ++k) ring.at(k) = v_in[(size_t)c * S + k];
    }
  }

  if (copier) {
    fill(xs, x, c0, 0, min(kTile, T), C, T, who);
    cp_async_wait_all();
  }
  for (int t0 = 0, buf = 0; t0 < T; t0 += kTile, buf ^= 1) {
    const int tn = min(kTile, T - t0);
    // slab `buf` of x is in; the loop has parked the slab before it; the
    // copiers have stored the slab before that
    __syncthreads();
    if (copier) {
      if (t0 > 0) drain(ys + (buf ^ 1) * kSlab, y, c0, t0 - kTile, kTile, C, T, who);
      if (t0 + kTile < T) fill(xs + (buf ^ 1) * kSlab, x, c0, t0 + kTile, min(kTile, T - t0 - kTile), C, T, who);
      cp_async_wait_all();
    } else if (loops) {
      const E* xr = xs + buf * kSlab + tid * kPitch;
      E* yr = ys + buf * kSlab + tid * kPitch;
      for (int t = 0; t < tn; ++t) {
        float2 out = O::load(xr[t]);
        if constexpr (kSos && kInst == kInstRegister) {
#pragma unroll
          for (int s = 0; s < kReg / 2; ++s)
            if (s < m)
              out = yagi_iir::sos_section<O>(out, so[0][s], so[1][s], so[2][s], so[3][s],
                                             so[4][s], v[2 * s], v[2 * s + 1]);
        } else if constexpr (kSos) {
          for (int s = 0; s < m; ++s) {
            float2 v1 = O::load(ring.at(2 * s)), v2 = O::load(ring.at(2 * s + 1));
            out = yagi_iir::sos_section<O>(out, a[3 * s + 1], a[3 * s + 2], b[3 * s], b[3 * s + 1],
                                           b[3 * s + 2], v1, v2);
            ring.at(2 * s) = O::pack(v1);
            ring.at(2 * s + 1) = O::pack(v2);
          }
        } else if constexpr (kInst == kInstRegister) {
          out = yagi_iir::tf_step<O, kReg>(out, m, ca, cb, v);
        } else {  // TF ring, m > kReg: the loops of iir.cuh's tf_step, unbounded
          int i = head;
          float2 s = O::mul(O::coef(a, 1), O::load(ring.at(i)));
          for (int k = 2; k <= m; ++k) {
            if (++i == m) i = 0;
            s = O::add(s, O::mul(O::coef(a, k), O::load(ring.at(i))));
          }
          const float2 v0 = O::sub(out, s);
          i = head;
          float2 u = O::mul(O::coef(b, 1), O::load(ring.at(i)));
          for (int k = 2; k <= m; ++k) {
            if (++i == m) i = 0;
            u = O::add(u, O::mul(O::coef(b, k), O::load(ring.at(i))));
          }
          out = O::add(O::mul(O::coef(b, 0), v0), u);
          head = head == 0 ? m - 1 : head - 1;  // over the oldest value
          ring.at(head) = O::pack(v0);
        }
        yr[t] = O::pack(O::mul(sc, out));
      }
    }
  }
  __syncthreads();  // the last slab's y is parked
  if (copier) {
    const int last = (T - 1) / kTile;
    drain(ys + (last & 1) * kSlab, y, c0, last * kTile, T - last * kTile, C, T, who);
  }
  if (loops) {
    if constexpr (kInst == kInstRegister) {
#pragma unroll
      for (int k = 0; k < kReg; ++k)
        if (k < S) v_out[(size_t)c * S + k] = O::pack(v[k]);
    } else {
      for (int k = 0; k < S; ++k) {
        int i = kSos ? k : head + k;
        if (i >= S) i -= S;
        v_out[(size_t)c * S + k] = ring.at(i);
      }
    }
  }
}

template <bool kCx, bool kCc, bool kSos, int kInst>
int launch_scan(const void* x, const void* b, const void* a, const void* scale, const void* v_in,
                void* y, void* v_out, void* scratch, int C, int T, int m, cudaStream_t stream) {
  using E = typename Ops<kCx, kCc>::Elem;
  const int S = kSos ? 2 * m : m;
  const int smem = scan_smem_bytes(S, (int)sizeof(E), kInst);
  auto kernel = iir_scan_kernel<kCx, kCc, kSos, kInst>;
  // past 48 KB, shared memory is dynamic only and must be allowed first
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(C + kChans - 1) / kChans, kThreads, smem, stream>>>(
      static_cast<const E*>(x), static_cast<const float*>(b), static_cast<const float*>(a),
      static_cast<const float*>(scale), static_cast<const E*>(v_in), static_cast<E*>(y),
      static_cast<E*>(v_out), static_cast<E*>(scratch), C, T, m);
  return (int)cudaGetLastError();
}

template <bool kCx, bool kCc, bool kSos>
int launch_scan_inst(int inst, const void* x, const void* b, const void* a, const void* scale,
                     const void* v_in, void* y, void* v_out, void* scratch, int C, int T, int m,
                     cudaStream_t stream) {
  switch (inst) {
    case kInstRegister:
      return launch_scan<kCx, kCc, kSos, kInstRegister>(x, b, a, scale, v_in, y, v_out, scratch, C, T, m, stream);
    case kInstShared:
      return launch_scan<kCx, kCc, kSos, kInstShared>(x, b, a, scale, v_in, y, v_out, scratch, C, T, m, stream);
    default:
      return launch_scan<kCx, kCc, kSos, kInstGlobal>(x, b, a, scale, v_in, y, v_out, scratch, C, T, m, stream);
  }
}

// --------------------------------------------------------------- iir_chunked
constexpr int kCT = 256;  // chunks a segment, one thread each
constexpr int kCL = 32;   // samples a chunk
constexpr int kCP = kCL + 1;
constexpr int kCLog = 8;  // log2(kCT): the scan's steps
constexpr int kCPow = 5;  // log2(kCL): squarings from M to M^kCL
constexpr int kCMax = 8;  // the largest order of a stage
constexpr int kSeg = kCT * kCL;

int chunked_smem_bytes(int m, int nst, int cx, int cc) {
  const int e = cx ? 8 : 4, mm = m > 1 ? m : 1;
  return kCT * kCP * e + mm * kCT * e + 2 * nst * (m + 1) * 8 + nst * mm * 8 +
         nst * kCLog * m * m * (cc ? 8 : 4) + 2 * nst * m * m * (cc ? 16 : 8);
}

__device__ __forceinline__ double cmul_d(double p, double q) { return p * q; }
__device__ __forceinline__ double2 cmul_d(double2 p, double2 q) {
  return make_double2(p.x * q.x - p.y * q.y, p.x * q.y + p.y * q.x);
}
__device__ __forceinline__ double cadd_d(double p, double q) { return p + q; }
__device__ __forceinline__ double2 cadd_d(double2 p, double2 q) {
  return make_double2(p.x + q.x, p.y + q.y);
}
__device__ __forceinline__ float to_f(double v) { return (float)v; }
__device__ __forceinline__ float2 to_f(double2 v) { return make_float2((float)v.x, (float)v.y); }

// Q[st][d] = M_st^(kCL·2^d), d < kCLog, of every stage's companion matrix
// (first row −a1 … −am, ones below the diagonal), by squaring in float64.
template <bool kCc, class W, class QT>
__device__ void chunk_powers(const float2* ca, int m, int nst, W* work, QT* q) {
  const int mm2 = m * m, total = nst * mm2;
  W* cur = work;
  W* nxt = work + total;
  for (int i = threadIdx.x; i < total; i += kCT) {
    const int st = i / mm2, r = (i % mm2) / m, k = i % m;
    const float2 c = ca[st * (m + 1) + k + 1];
    W w{};
    if constexpr (kCc) {
      w = r == 0 ? make_double2(-(double)c.x, -(double)c.y) : make_double2(r == k + 1, 0.0);
    } else {
      w = r == 0 ? -(double)c.x : (double)(r == k + 1);
    }
    cur[i] = w;
  }
  __syncthreads();
  for (int it = 0; it < kCPow + kCLog - 1; ++it) {
    for (int i = threadIdx.x; i < total; i += kCT) {
      const int st = i / mm2, r = (i % mm2) / m, k = i % m;
      const W* p = cur + st * mm2;
      W s{};
      for (int l = 0; l < m; ++l) s = cadd_d(s, cmul_d(p[r * m + l], p[l * m + k]));
      nxt[i] = s;
    }
    __syncthreads();
    W* t = cur;
    cur = nxt;
    nxt = t;
    if (it >= kCPow - 1) {  // cur = M^(kCL·2^d)
      const int d = it - (kCPow - 1);
      for (int i = threadIdx.x; i < total; i += kCT)
        q[((i / mm2) * kCLog + d) * mm2 + i % mm2] = to_f(cur[i]);
    }
  }
  __syncthreads();
}

template <bool kCx, bool kCc>
__global__ void __launch_bounds__(kCT)
iir_chunked_kernel(const typename Ops<kCx, kCc>::Elem* __restrict__ x, const float* __restrict__ b,
                   const float* __restrict__ a, const float* __restrict__ scale,
                   const typename Ops<kCx, kCc>::Elem* __restrict__ v_in,
                   typename Ops<kCx, kCc>::Elem* __restrict__ y,
                   typename Ops<kCx, kCc>::Elem* __restrict__ v_out, int T, int m, int nst) {
  using O = Ops<kCx, kCc>;
  using E = typename O::Elem;
  using QT = std::conditional_t<kCc, float2, float>;
  using W = std::conditional_t<kCc, double2, double>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int mm = m > 1 ? m : 1, mm2 = m * m;
  W* work = reinterpret_cast<W*>(smem_raw);               // [2][nst][m][m]
  E* buf = reinterpret_cast<E*>(work + 2 * nst * mm2);    // [kCT][kCP]
  E* xch = buf + kCT * kCP;                               // [mm][kCT]
  float2* ca = reinterpret_cast<float2*>(xch + mm * kCT);  // [nst][m + 1]
  float2* cb = ca + nst * (m + 1);                        // [nst][m + 1]
  float2* carry = cb + nst * (m + 1);                     // [nst][mm]
  QT* q = reinterpret_cast<QT*>(carry + nst * mm);        // [nst][kCLog][m][m]
  const int j = threadIdx.x;
  const size_t c = blockIdx.x;

  for (int i = j; i < nst * (m + 1); i += kCT) {
    ca[i] = O::coef(a, i);
    cb[i] = O::coef(b, i);
  }
  for (int i = j; i < nst * m; i += kCT) carry[(i / m) * mm + i % m] = O::load(v_in[c * nst * m + i]);
  __syncthreads();
  chunk_powers<kCc>(ca, m, nst, work, q);
  const float2 sc = O::coef(scale, 0);

  for (int t0 = 0; t0 < T; t0 += kSeg) {
    const int seg = min(kSeg, T - t0);
    const int nch = (seg + kCL - 1) / kCL;
    const E* xr = x + c * T + t0;
#pragma unroll 8
    for (int n = j; n < seg; n += kCT) buf[(n / kCL) * kCP + n % kCL] = xr[n];
    __syncthreads();
    const int len = j < nch ? min(kCL, seg - j * kCL) : 0;
    E* row = buf + j * kCP;
    for (int st = 0; st < nst; ++st) {
      float2 av[kCMax + 1], bv[kCMax + 1], s[kCMax];
#pragma unroll
      for (int k = 0; k <= kCMax; ++k) {
        av[k] = k <= m ? ca[st * (m + 1) + k] : make_float2(0.f, 0.f);
        bv[k] = k <= m ? cb[st * (m + 1) + k] : make_float2(0.f, 0.f);
      }
      // 1. the chunk's all-pole recurrence from a zero state (chunk 0: the carried one)
#pragma unroll
      for (int k = 0; k < kCMax; ++k)
        s[k] = j == 0 && k < m ? carry[st * mm + k] : make_float2(0.f, 0.f);
      for (int i = 0; i < len; ++i) yagi_iir::allpole_step<O, kCMax>(O::load(row[i]), m, av, s);
      // 2. the end states carried along the segment
      const QT* qs = q + (size_t)st * kCLog * mm2;
      for (int d = 0; d < kCLog; ++d) {
#pragma unroll
        for (int k = 0; k < kCMax; ++k)
          if (k < m) xch[k * kCT + j] = O::pack(s[k]);
        __syncthreads();
        const int src = j - (1 << d);
        if (src >= 0) {
          float2 p[kCMax];
#pragma unroll
          for (int k = 0; k < kCMax; ++k)
            p[k] = k < m ? O::load(xch[k * kCT + src]) : make_float2(0.f, 0.f);
          const QT* qd = qs + d * mm2;
#pragma unroll
          for (int r = 0; r < kCMax; ++r) {
            if (r >= m) break;
#pragma unroll
            for (int k = 0; k < kCMax; ++k) {
              if (k >= m) break;
              float2 qv;
              if constexpr (kCc) {
                qv = qd[r * m + k];
              } else {
                qv = make_float2(qd[r * m + k], 0.f);
              }
              s[r] = O::add(s[r], O::mul(qv, p[k]));
            }
          }
        }
        __syncthreads();
      }
      // 3. the state entering each chunk is the end state of the one before
#pragma unroll
      for (int k = 0; k < kCMax; ++k)
        if (k < m) xch[k * kCT + j] = O::pack(s[k]);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kCMax; ++k) {
        if (k < m) s[k] = j > 0 ? O::load(xch[k * kCT + j - 1]) : carry[st * mm + k];
      }
      for (int i = 0; i < len; ++i) row[i] = O::pack(yagi_iir::tf_step<O, kCMax>(O::load(row[i]), m, av, bv, s));
      __syncthreads();  // carry[st] and xch are read
      if (j == nch - 1) {
#pragma unroll
        for (int k = 0; k < kCMax; ++k)
          if (k < m) carry[st * mm + k] = s[k];
      }
    }
    __syncthreads();
    E* yr = y + c * T + t0;
#pragma unroll 8
    for (int n = j; n < seg; n += kCT) yr[n] = O::pack(O::mul(sc, O::load(buf[(n / kCL) * kCP + n % kCL])));
    __syncthreads();
  }
  for (int i = j; i < nst * m; i += kCT) v_out[c * nst * m + i] = O::pack(carry[(i / m) * mm + i % m]);
}

template <bool kCx, bool kCc>
int launch_chunked(const void* x, const void* b, const void* a, const void* scale,
                   const void* v_in, void* y, void* v_out, int C, int T, int m, int nst,
                   cudaStream_t stream) {
  using E = typename Ops<kCx, kCc>::Elem;
  const int smem = chunked_smem_bytes(m, nst, kCx, kCc);
  if (m > kCMax || smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kernel = iir_chunked_kernel<kCx, kCc>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<C, kCT, smem, stream>>>(static_cast<const E*>(x), static_cast<const float*>(b),
                                   static_cast<const float*>(a), static_cast<const float*>(scale),
                                   static_cast<const E*>(v_in), static_cast<E*>(y),
                                   static_cast<E*>(v_out), T, m, nst);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: [C, T] float32 or complex64 (cx); b, a: TF [m + 1] (float32, or
// complex64 when cc) or SOS [m, 3] float32 (sos; m is then the number of
// sections); scale: one coefficient; v_in, v_out: [C, m] (TF) or [C, m, 2]
// (SOS) of the signal type; scratch: [state values, C] of the signal type for
// the device-memory ring (inst 2). inst: 0 registers, 1 shared-memory ring,
// 2 device-memory ring, as kernels/iir.py::scan_instance chooses. Launches on
// `stream`; returns the launch's CUDA error (0 on success).
extern "C" int yagi_iir_scan(const void* x, const void* b, const void* a, const void* scale,
                             const void* v_in, void* y, void* v_out, void* scratch, int C, int T,
                             int m, int sos, int cx, int cc, int inst, void* stream) {
  const int S = sos ? 2 * m : m;
  const int elem = cx ? 8 : 4;
  if ((cc && (!cx || sos)) || (inst == kInstRegister && S > kReg) || inst < 0 || inst > 2 ||
      scan_smem_bytes(S, elem, inst) > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sos) {
    return cx ? launch_scan_inst<true, false, true>(inst, x, b, a, scale, v_in, y, v_out, scratch, C, T, m, st)
              : launch_scan_inst<false, false, true>(inst, x, b, a, scale, v_in, y, v_out, scratch, C, T, m, st);
  }
  if (cc) return launch_scan_inst<true, true, false>(inst, x, b, a, scale, v_in, y, v_out, scratch, C, T, m, st);
  return cx ? launch_scan_inst<true, false, false>(inst, x, b, a, scale, v_in, y, v_out, scratch, C, T, m, st)
            : launch_scan_inst<false, false, false>(inst, x, b, a, scale, v_in, y, v_out, scratch, C, T, m, st);
}

// x, y, scale, cx, cc as for yagi_iir_scan; b, a: [nst, m + 1] (a TF filter
// is one stage of order m, an SOS filter nst stages of order 2); v_in,
// v_out: [C, nst, m] of the signal type. m ≤ 8 and the shared memory of
// kernels/iir.py::chunked_smem_bytes within the card's; returns the launch's
// CUDA error (0 on success).
extern "C" int yagi_iir_chunked(const void* x, const void* b, const void* a, const void* scale,
                                const void* v_in, void* y, void* v_out, int C, int T, int m,
                                int nst, int cx, int cc, void* stream) {
  if (cc && !cx) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cc) return launch_chunked<true, true>(x, b, a, scale, v_in, y, v_out, C, T, m, nst, st);
  return cx ? launch_chunked<true, false>(x, b, a, scale, v_in, y, v_out, C, T, m, nst, st)
            : launch_chunked<false, false>(x, b, a, scale, v_in, y, v_out, C, T, m, nst, st);
}
