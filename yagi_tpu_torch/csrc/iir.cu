// The IIR recurrences over a block: iir_scan (sequential) and iir_chunked.
//
// They stand for the XLA loops of yagi_tpu's IIR filters, which have no
// Pallas kernel: the sequential per-sample scan (planar_scan,
// yagi_tpu/filter/iirfilt.py:317 and iirfiltsos.py:98) and the log-depth
// associative scan of parallelize()d filters (yagi_tpu/filter/_linrec.py:76
// and :89). The recurrence body is csrc/iir.cuh; the layouts, the instances
// and the shape gates are mirrored in kernels/iir.py (scan_instance,
// chunked_instance, chunked_smem_bytes): change them together.
//
// iir_scan. One loop thread per channel runs the recurrence in the order of
// iir.cuh and equals kernels/iir.py::iir_scan_reference bit for bit. The
// recurrence is serial per channel, so the time is T × the sample's
// dependent chain whatever the channel count (first order: v0 = x − a1·v1,
// one multiply and one subtract); what the design keeps off that chain is
// everything else. As in csrc/agc.cu, a block owns kChans channels: warp 0
// loops out of shared memory and parks y there, warps 1–4 bring the next
// slab of x in with coalesced cp.async (the fetch issued before the stores)
// and store the last slab's y in coalesced rows, a row at a time, in 16-byte
// groups where the rows allow; the two meet at one barrier a slab. The loop
// thread reads its row a 16-byte group (4 real or 2 complex samples) ahead
// into registers and parks y in 16-byte groups, through distinct
// __restrict__ rows pitched 16 bytes past the slab, so the loop threads'
// reads fall on distinct banks and no store orders a later load. The state
// lives in registers in an instance
// specialised to the order (TF m = 0, 1, 2; SOS 1–4 sections), in a generic
// register instance for TF orders 3–8, in a ring in shared memory, or in
// device memory where shared memory cannot hold it; kernels/iir.py picks it.
//
// iir_chunked. A parallelize()d filter on the card: with one thread per
// channel config[2]'s 512 channels would fill 4 of 132 SMs' worth of warps.
// One block a channel (512 blocks of 128 threads are resident at once; a
// persistent grid over the channels measured the same there, PERF.md §6);
// the row is cut into segments of kCT chunks of kCL samples, one thread a
// chunk. The segments stream through two shared-memory buffers: the
// next one is fetched with 16-byte cp.async while this one computes (the
// block's first fetch is issued before its set-up), landing swizzled so that
// each thread reads its own chunk into registers as 16-byte groups without
// bank conflicts. Per segment and stage (a TF filter is one stage of order m,
// an SOS filter nsos stages of order 2, one after another), on registers:
//   1. each chunk runs the all-pole recurrence from a zero state (chunk 0
//      from the state carried into the segment): its end state;
//   2. the end states are carried along the segment: a doubling scan inside
//      each warp by shuffles, s_j ← s_j + Z(2^d)·s_{j−2^d}, then the warps'
//      end states by a doubling scan in one warp, then each chunk adds
//      Z(lane + 1) times the end state of the warp before it; Z(k) =
//      M^(kCL·k) are the companion matrix's chunk powers (_linrec.py's
//      composition), formed in float64 once a block. Two barriers a stage;
//   3. each chunk reruns the whole DF-II step (iir.cuh's tf_step) from the
//      end state of the chunk before it, its output the next stage's input.
// Then the segment is scaled, parked in its buffer and stored in 16-byte
// rows. The order is a template parameter for orders 1 and 2 (config[2]'s
// de-emphasis, every SOS stage); orders 0 and 3–8 run a generic instance.
// This is the same recurrence in another summation order: it is held by
// tolerance to its plain version, kernels/iir.py::iir_chunked_reference
// (yagi_tpu's parallel route). The function is a streaming one (config[2]:
// 33.5 MB in, 33.5 MB out a filter, 0.020 ms at 3.35 TB/s; ~10 operations a
// sample): the design reads and writes each sample once, with the next
// segment's bytes in flight while a segment computes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "iir.cuh"

namespace {

using yagi_iir::Ops;

constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem), "n"(kBytes));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// A 16-byte group of samples: 4 real or 2 complex.
__device__ __forceinline__ void unpack(float4 f, float (&e)[4]) {
  e[0] = f.x;
  e[1] = f.y;
  e[2] = f.z;
  e[3] = f.w;
}
__device__ __forceinline__ void unpack(float4 f, float2 (&e)[2]) {
  e[0] = make_float2(f.x, f.y);
  e[1] = make_float2(f.z, f.w);
}
__device__ __forceinline__ float4 pack(const float (&e)[4]) { return make_float4(e[0], e[1], e[2], e[3]); }
__device__ __forceinline__ float4 pack(const float2 (&e)[2]) {
  return make_float4(e[0].x, e[0].y, e[1].x, e[1].y);
}

// ------------------------------------------------------------------ iir_scan
constexpr int kChans = 8;      // loop threads (channels) a block
constexpr int kCopiers = 128;  // threads that copy: warps 1 to 4
constexpr int kThreads = 32 + kCopiers;
constexpr int kTile = 256;  // samples a slab
constexpr int kReg = 8;     // state values held in registers
enum : int {
  kInstRegister = 0,  // TF, order ≤ kReg read at run time
  kInstShared = 1,    // a ring in shared memory
  kInstGlobal = 2,    // a ring in device memory
  kInstTf0 = 3,       // TF of order 0, 1, 2: kInstTf0 + m
  kInstSos1 = 6,      // SOS of 1 to 4 sections: kInstSos1 + nsos − 1
};

// a row: the slab's samples and 16 bytes, so the loop threads' 16-byte
// reads at one column fall on distinct banks
template <class E>
constexpr int kPitch = kTile + 16 / (int)sizeof(E);

int scan_smem_bytes(int state_len, int elem, int inst) {
  return 4 * kChans * (kTile * elem + 16) + (inst == kInstShared ? kChans * state_len * elem : 0);
}

// The slab x[c0 + r][t0 .. t0 + w) of the block's channels into rows of
// kPitch, a row at a time, neighbouring copying threads on neighbouring
// 16-byte groups (vec: every row starts on 16 bytes and w is a whole number
// of groups) or samples; one commit.
template <class E>
__device__ __forceinline__ void fill(E* dst, const E* __restrict__ x, int c0, int t0, int w,
                                     int C, int T, bool vec, int who) {
  constexpr int G = 16 / sizeof(E);
#pragma unroll
  for (int r = 0; r < kChans; ++r) {
    if (c0 + r >= C) break;
    const E* src = x + (size_t)(c0 + r) * T + t0;
    E* row = dst + r * kPitch<E>;
    if (vec) {
      for (int u = who; u < w / G; u += kCopiers) cp_async<16>(row + u * G, src + u * G);
    } else {
      for (int i = who; i < w; i += kCopiers) cp_async<sizeof(E)>(row + i, src + i);
    }
  }
  cp_async_commit();
}

template <class E>
__device__ __forceinline__ void drain(const E* src, E* __restrict__ y, int c0, int t0, int w,
                                      int C, int T, bool vec, int who) {
  constexpr int G = 16 / sizeof(E);
#pragma unroll
  for (int r = 0; r < kChans; ++r) {
    if (c0 + r >= C) break;
    E* dst = y + (size_t)(c0 + r) * T + t0;
    const E* row = src + r * kPitch<E>;
    if (vec) {
      for (int u = who; u < w / G; u += kCopiers)
        reinterpret_cast<float4*>(dst)[u] = reinterpret_cast<const float4*>(row)[u];
    } else {
      for (int i = who; i < w; i += kCopiers) dst[i] = row[i];
    }
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

// The loop's bodies: init reads the coefficients and the channel's state,
// step runs one sample (before the scale), save writes the state back.
//
// TF on a register state of kR values: kFixed, the order is kR (an
// order-specialised instance, kR = 0 for no feedback); else the order m ≤ kR
// is read at run time and iir.cuh's terms are predicated on it.
template <class O, int kR, bool kFixed>
struct TfRegister {
  using E = typename O::Elem;
  static constexpr bool kSharedRing = false;
  float2 ca[kR + 1], cb[kR + 1], v[kR > 0 ? kR : 1];
  int m;
  __device__ __forceinline__ void init(const float* b, const float* a, const E* v_in, int c,
                                       int m_, Ring<E>) {
    m = kFixed ? kR : m_;
#pragma unroll
    for (int k = 0; k <= kR; ++k) {
      ca[k] = k <= m ? O::coef(a, k) : make_float2(0.f, 0.f);
      cb[k] = k <= m ? O::coef(b, k) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kR; ++k) v[k] = k < m ? O::load(v_in[(size_t)c * m + k]) : make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ float2 step(float2 x) {
    if constexpr (kR == 0) {
      return O::mul(cb[0], x);
    } else {
      return yagi_iir::tf_step<O, kR>(x, kFixed ? kR : m, ca, cb, v);
    }
  }
  __device__ __forceinline__ void save(E* v_out, int c) {
#pragma unroll
    for (int k = 0; k < kR; ++k)
      if (k < m) v_out[(size_t)c * m + k] = O::pack(v[k]);
  }
};

// kN SOS sections, each (a1, a2, b0, b1, b2) and (v1, v2) in registers.
template <class O, int kN>
struct SosRegister {
  using E = typename O::Elem;
  static constexpr bool kSharedRing = false;
  float so[5][kN];
  float2 v[2 * kN];
  __device__ __forceinline__ void init(const float* b, const float* a, const E* v_in, int c, int,
                                       Ring<E>) {
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      so[0][s] = a[3 * s + 1];
      so[1][s] = a[3 * s + 2];
      so[2][s] = b[3 * s];
      so[3][s] = b[3 * s + 1];
      so[4][s] = b[3 * s + 2];
    }
#pragma unroll
    for (int k = 0; k < 2 * kN; ++k) v[k] = O::load(v_in[(size_t)c * 2 * kN + k]);
  }
  __device__ __forceinline__ float2 step(float2 x) {
#pragma unroll
    for (int s = 0; s < kN; ++s)
      x = yagi_iir::sos_section<O>(x, so[0][s], so[1][s], so[2][s], so[3][s], so[4][s], v[2 * s],
                                   v[2 * s + 1]);
    return x;
  }
  __device__ __forceinline__ void save(E* v_out, int c) {
#pragma unroll
    for (int k = 0; k < 2 * kN; ++k) v_out[(size_t)c * 2 * kN + k] = O::pack(v[k]);
  }
};

// TF of any order, the state in a ring (value k, 0 newest, at (head + k)
// mod m): the loops of iir.cuh's tf_step, unbounded.
template <class O, bool kShared>
struct TfRing {
  using E = typename O::Elem;
  static constexpr bool kSharedRing = kShared;
  const float *b, *a;
  Ring<E> ring;
  int m, head;
  __device__ __forceinline__ void init(const float* b_, const float* a_, const E* v_in, int c,
                                       int m_, Ring<E> r) {
    b = b_;
    a = a_;
    ring = r;
    m = m_;
    head = 0;
    for (int k = 0; k < m; ++k) ring.at(k) = v_in[(size_t)c * m + k];
  }
  __device__ __forceinline__ float2 step(float2 x) {
    int i = head;
    float2 s = O::mul(O::coef(a, 1), O::load(ring.at(i)));
    for (int k = 2; k <= m; ++k) {
      if (++i == m) i = 0;
      s = O::add(s, O::mul(O::coef(a, k), O::load(ring.at(i))));
    }
    const float2 v0 = O::sub(x, s);
    i = head;
    float2 u = O::mul(O::coef(b, 1), O::load(ring.at(i)));
    for (int k = 2; k <= m; ++k) {
      if (++i == m) i = 0;
      u = O::add(u, O::mul(O::coef(b, k), O::load(ring.at(i))));
    }
    head = head == 0 ? m - 1 : head - 1;  // over the oldest value
    ring.at(head) = O::pack(v0);
    return O::add(O::mul(O::coef(b, 0), v0), u);
  }
  __device__ __forceinline__ void save(E* v_out, int c) {
    for (int k = 0; k < m; ++k) {
      int i = head + k;
      if (i >= m) i -= m;
      v_out[(size_t)c * m + k] = ring.at(i);
    }
  }
};

// SOS of any number of sections, (v1, v2) of section s at ring values 2s, 2s + 1.
template <class O, bool kShared>
struct SosRing {
  using E = typename O::Elem;
  static constexpr bool kSharedRing = kShared;
  const float *b, *a;
  Ring<E> ring;
  int n;
  __device__ __forceinline__ void init(const float* b_, const float* a_, const E* v_in, int c,
                                       int m, Ring<E> r) {
    b = b_;
    a = a_;
    ring = r;
    n = m;
    for (int k = 0; k < 2 * n; ++k) ring.at(k) = v_in[(size_t)c * 2 * n + k];
  }
  __device__ __forceinline__ float2 step(float2 x) {
    for (int s = 0; s < n; ++s) {
      float2 v1 = O::load(ring.at(2 * s)), v2 = O::load(ring.at(2 * s + 1));
      x = yagi_iir::sos_section<O>(x, a[3 * s + 1], a[3 * s + 2], b[3 * s], b[3 * s + 1],
                                   b[3 * s + 2], v1, v2);
      ring.at(2 * s) = O::pack(v1);
      ring.at(2 * s + 1) = O::pack(v2);
    }
    return x;
  }
  __device__ __forceinline__ void save(E* v_out, int c) {
    for (int k = 0; k < 2 * n; ++k) v_out[(size_t)c * 2 * n + k] = ring.at(k);
  }
};

// One loop thread's slab: tn samples of its row xr into yr, scaled. The next
// 16-byte group is read into registers before this one computes (the group
// past the last lies in the row's pitch), and y is parked a group at a time.
template <class O, class B>
__device__ __forceinline__ void run_slab(B& body, float2 sc,
                                         const typename O::Elem* __restrict__ xr,
                                         typename O::Elem* __restrict__ yr, int tn) {
  using E = typename O::Elem;
  constexpr int G = 16 / sizeof(E);
  const float4* x4 = reinterpret_cast<const float4*>(xr);
  float4* y4 = reinterpret_cast<float4*>(yr);
  float4 next = x4[0];
  int g = 0;
#pragma unroll 2
  for (; g < tn / G; ++g) {
    E e[G];
    unpack(next, e);
    next = x4[g + 1];
#pragma unroll
    for (int k = 0; k < G; ++k) e[k] = O::pack(O::mul(sc, body.step(O::load(e[k]))));
    y4[g] = pack(e);
  }
  for (int t = g * G; t < tn; ++t) yr[t] = O::pack(O::mul(sc, body.step(O::load(xr[t]))));
}

template <class O, class Body>
__global__ void __launch_bounds__(kThreads)
iir_scan_kernel(const typename O::Elem* __restrict__ x, const float* __restrict__ b,
                const float* __restrict__ a, const float* __restrict__ scale,
                const typename O::Elem* __restrict__ v_in, typename O::Elem* __restrict__ y,
                typename O::Elem* __restrict__ v_out, typename O::Elem* __restrict__ scratch,
                int C, int T, int m) {
  using E = typename O::Elem;
  constexpr int kSlab = kChans * kPitch<E>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* xs = reinterpret_cast<E*>(smem_raw);  // [2][kSlab]
  E* ys = xs + 2 * kSlab;                  // [2][kSlab]
  const int tid = threadIdx.x;
  const bool copier = tid >= 32;
  const int who = tid - 32;
  const int c0 = blockIdx.x * kChans;
  const bool loops = tid < kChans && c0 + tid < C;  // this thread runs a channel's loop
  const int c = loops ? c0 + tid : c0;
  const float2 sc = O::coef(scale, 0);
  // 16-byte copies where every row starts on 16 bytes
  const bool vec = T % (16 / (int)sizeof(E)) == 0 &&
                   (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;

  Body body;
  if (loops)
    body.init(b, a, v_in, c, m,
              Body::kSharedRing ? Ring<E>{ys + 2 * kSlab + tid, kChans} : Ring<E>{scratch + c, C});

  if (copier) {
    fill(xs, x, c0, 0, min(kTile, T), C, T, vec, who);
    cp_async_wait<0>();
  }
  for (int t0 = 0, buf = 0; t0 < T; t0 += kTile, buf ^= 1) {
    // slab `buf` of x is in; the loop has parked the slab before it; the
    // copiers have stored the slab before that
    __syncthreads();
    if (copier) {  // the next slab's fetch first, so it is in flight while the last is stored
      if (t0 + kTile < T) fill(xs + (buf ^ 1) * kSlab, x, c0, t0 + kTile, min(kTile, T - t0 - kTile), C, T, vec, who);
      if (t0 > 0) drain(ys + (buf ^ 1) * kSlab, y, c0, t0 - kTile, kTile, C, T, vec, who);
      cp_async_wait<0>();
    } else if (loops) {
      run_slab<O>(body, sc, xs + buf * kSlab + tid * kPitch<E>, ys + buf * kSlab + tid * kPitch<E>,
                  min(kTile, T - t0));
    }
  }
  __syncthreads();  // the last slab's y is parked
  if (copier) {
    const int last = (T - 1) / kTile;
    drain(ys + (last & 1) * kSlab, y, c0, last * kTile, T - last * kTile, C, T, vec, who);
  }
  if (loops) body.save(v_out, c);
}

template <class O, class Body>
int launch_scan(int smem, const void* x, const void* b, const void* a, const void* scale,
                const void* v_in, void* y, void* v_out, void* scratch, int C, int T, int m,
                cudaStream_t stream) {
  using E = typename O::Elem;
  auto kernel = iir_scan_kernel<O, Body>;
  // past 48 KB, shared memory is dynamic only and must be allowed first
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(C + kChans - 1) / kChans, kThreads, smem, stream>>>(
      static_cast<const E*>(x), static_cast<const float*>(b), static_cast<const float*>(a),
      static_cast<const float*>(scale), static_cast<const E*>(v_in), static_cast<E*>(y),
      static_cast<E*>(v_out), static_cast<E*>(scratch), C, T, m);
  return (int)cudaGetLastError();
}

// The body of instance `inst` (checked against the form and order by the caller).
template <bool kCx, bool kCc, bool kSos>
int launch_scan_inst(int inst, int smem, const void* x, const void* b, const void* a,
                     const void* scale, const void* v_in, void* y, void* v_out, void* scratch,
                     int C, int T, int m, cudaStream_t stream) {
  using O = Ops<kCx, kCc>;
#define YAGI_SCAN(...) \
  launch_scan<O, __VA_ARGS__>(smem, x, b, a, scale, v_in, y, v_out, scratch, C, T, m, stream)
  if constexpr (kSos) {
    if (inst == kInstShared) return YAGI_SCAN(SosRing<O, true>);
    if (inst == kInstGlobal) return YAGI_SCAN(SosRing<O, false>);
    switch (inst - kInstSos1) {
      case 0: return YAGI_SCAN(SosRegister<O, 1>);
      case 1: return YAGI_SCAN(SosRegister<O, 2>);
      case 2: return YAGI_SCAN(SosRegister<O, 3>);
      default: return YAGI_SCAN(SosRegister<O, 4>);
    }
  } else {
    if (inst == kInstShared) return YAGI_SCAN(TfRing<O, true>);
    if (inst == kInstGlobal) return YAGI_SCAN(TfRing<O, false>);
    switch (inst) {
      case kInstTf0: return YAGI_SCAN(TfRegister<O, 0, true>);
      case kInstTf0 + 1: return YAGI_SCAN(TfRegister<O, 1, true>);
      case kInstTf0 + 2: return YAGI_SCAN(TfRegister<O, 2, true>);
      default: return YAGI_SCAN(TfRegister<O, kReg, false>);
    }
  }
#undef YAGI_SCAN
}

// Whether instance `inst` takes this form and order (m: TF order, SOS sections).
bool scan_inst_takes(int inst, int m, int sos) {
  if (inst == kInstShared || inst == kInstGlobal) return true;
  if (inst == kInstRegister) return !sos && m <= kReg;
  if (inst >= kInstTf0 && inst < kInstSos1) return !sos && m == inst - kInstTf0;
  return sos && inst >= kInstSos1 && inst < kInstSos1 + kReg / 2 && m == inst - kInstSos1 + 1;
}

// --------------------------------------------------------------- iir_chunked
constexpr int kCT = 128;     // chunks a segment, one thread each
constexpr int kCL = 32;      // samples a chunk
constexpr int kWarpLog = 2;  // log2(kCT / 32): the scan's steps across warps
constexpr int kCMax = 8;     // the largest order of a stage
constexpr int kWarps = kCT / 32;
constexpr int kSeg = kCT * kCL;
constexpr int kCPow = 5;                 // log2(kCL): squarings from M to M^kCL
constexpr int kNPow = 32 + kWarpLog - 1;  // Z(k) for k = 1 … 32, then 64, 128, … (kWarps / 2 · 32)
static_assert(kWarps == 1 << kWarpLog && kWarps >= 2 && kWarps <= 32, "warps a block");
enum : int { kChunkGeneric = 0, kChunkOrder1 = 1, kChunkOrder2 = 2 };

int chunked_smem_bytes(int m, int nst, int cx, int cc) {
  const int e = cx ? 8 : 4, mm = m > 1 ? m : 1, m2 = m * m;
  return 2 * kSeg * e + nst * (kNPow + 2) * m2 * (cc ? 16 : 8) + 2 * nst * (m + 1) * 8 +
         nst * mm * 8 + kWarps * mm * 8 + nst * kNPow * m2 * (cc ? 8 : 4);
}

// the table index of Z(k): k = 1 … 32, then 64, 128, …
__device__ __forceinline__ int pow_index(int k) { return k <= 32 ? k - 1 : 31 + (31 - __clz(k)) - 5; }

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

// dst[i] = (p · q)[i] for the m × m products of every stage, element-parallel
template <class W>
__device__ __forceinline__ void matmul_d(W* dst, const W* p, const W* q, int m, int i) {
  const int r = i / m, k = i % m;
  W s{};
  for (int l = 0; l < m; ++l) s = cadd_d(s, cmul_d(p[r * m + l], q[l * m + k]));
  dst[i] = s;
}

// Z(k) = M_st^(kCL·k), k = 1 … 32 and 64, …, of every stage's companion
// matrix (first row −a1 … −am, ones below the diagonal), in float64: M^kCL by
// squaring, Z(1 … 32) by doubling (Z(k + h) = Z(k)·Z(h)), then squaring.
// work: [nst][kNPow + 2][m][m], slots 0 and 1 for the squarings of M.
template <bool kCc, class W, class QT>
__device__ void chunk_powers(const float2* ca, int m, int nst, W* work, QT* q) {
  const int m2 = m * m, per = (kNPow + 2) * m2;
  auto slot = [&](int st, int s) { return work + st * per + s * m2; };
  for (int i = threadIdx.x; i < nst * m2; i += kCT) {
    const int st = i / m2, r = (i % m2) / m, k = i % m;
    const float2 c = ca[st * (m + 1) + k + 1];
    W w{};
    if constexpr (kCc) {
      w = r == 0 ? make_double2(-(double)c.x, -(double)c.y) : make_double2(r == k + 1, 0.0);
    } else {
      w = r == 0 ? -(double)c.x : (double)(r == k + 1);
    }
    slot(st, 0)[i % m2] = w;
  }
  __syncthreads();
  for (int it = 0; it < kCPow; ++it) {  // M^(2^(it+1)); the last, M^kCL, is Z(1)
    for (int i = threadIdx.x; i < nst * m2; i += kCT) {
      const int st = i / m2;
      const W* p = slot(st, it & 1);
      matmul_d(it == kCPow - 1 ? slot(st, 2) : slot(st, (it + 1) & 1), p, p, m, i % m2);
    }
    __syncthreads();
  }
  for (int h = 1; h < 32; h *= 2) {  // Z(h + 1 … 2h)
    for (int i = threadIdx.x; i < nst * h * m2; i += kCT) {
      const int st = i / (h * m2), k = 1 + (i / m2) % h;
      matmul_d(slot(st, 2 + k + h - 1), slot(st, 2 + k - 1), slot(st, 2 + h - 1), m, i % m2);
    }
    __syncthreads();
  }
  for (int d = 32; d < kNPow; ++d) {  // Z(64), Z(128), …
    for (int i = threadIdx.x; i < nst * m2; i += kCT) {
      const int st = i / m2;
      const W* p = slot(st, 2 + d - 1);
      matmul_d(slot(st, 2 + d), p, p, m, i % m2);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nst * kNPow * m2; i += kCT)
    q[i] = to_f(slot(i / (kNPow * m2), 2)[i % (kNPow * m2)]);
  __syncthreads();
}

// The 16-byte group u of a segment lies at this group of its buffer: within
// a chunk's row the group index is xor-ed with the chunk's low 3 bits, so the
// threads reading their chunks' groups fall on distinct banks.
template <int U>
__device__ __forceinline__ int swz(int u) {
  return (u / U) * U + ((u % U) ^ ((u / U) & 7));
}

// The n samples at xrow into buf (16-byte copies where vec); one commit.
template <class E>
__device__ __forceinline__ void fetch(E* buf, const E* xrow, int n, bool vec) {
  constexpr int G = 16 / sizeof(E), U = kCL / G;
  if (vec) {
    for (int u = threadIdx.x; u < n / G; u += kCT) cp_async<16>(buf + swz<U>(u) * G, xrow + u * G);
  } else {
    for (int i = threadIdx.x; i < n; i += kCT) cp_async<sizeof(E)>(buf + swz<U>(i / G) * G + i % G, xrow + i);
  }
  cp_async_commit();
}

template <class E>
__device__ __forceinline__ void store(E* yrow, const E* buf, int n, bool vec) {
  constexpr int G = 16 / sizeof(E), U = kCL / G;
  if (vec) {
    for (int u = threadIdx.x; u < n / G; u += kCT)
      reinterpret_cast<float4*>(yrow)[u] = reinterpret_cast<const float4*>(buf)[swz<U>(u)];
  } else {
    for (int i = threadIdx.x; i < n; i += kCT) yrow[i] = buf[swz<U>(i / G) * G + i % G];
  }
}

template <class O>
__device__ __forceinline__ float2 shfl_up(float2 v, int d) {
  if constexpr (O::kIsCx) {
    return make_float2(__shfl_up_sync(0xffffffffu, v.x, d), __shfl_up_sync(0xffffffffu, v.y, d));
  } else {
    return make_float2(__shfl_up_sync(0xffffffffu, v.x, d), 0.f);
  }
}

// s ← s + Z·p, each row's terms added in order (Z row-major m × m)
template <class O, int kR, class QT>
__device__ __forceinline__ void carry_in(float2 (&s)[kR], const QT* z, const float2 (&p)[kR], int m) {
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r >= m) break;
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      if (k >= m) break;
      float2 zv;
      if constexpr (std::is_same_v<QT, float2>) {
        zv = z[r * m + k];
      } else {
        zv = make_float2(z[r * m + k], 0.f);
      }
      s[r] = O::add(s[r], O::mul(zv, p[k]));
    }
  }
}

// One stage over the thread's chunk xv (len samples live), in place: the
// all-pole pass, the carry of the end states, the rerun. kR: the register
// state's size; kFixed: the order is kR, else m ≤ kR at run time.
template <class O, int kR, bool kFixed, class QT>
__device__ __forceinline__ void chunk_stage(typename O::Elem (&xv)[kCL], int len, int m_,
                                            const float2* ca, const float2* cb, float2* carry,
                                            const QT* z, float2* tot, int nch) {
  const int m = kFixed ? kR : m_, m2 = m * m;
  const int j = threadIdx.x, lane = j & 31, w = j >> 5;
  float2 av[kR + 1], bv[kR + 1], s[kR], c0[kR], p[kR];
#pragma unroll
  for (int k = 0; k <= kR; ++k) {
    av[k] = k <= m ? ca[k] : make_float2(0.f, 0.f);
    bv[k] = k <= m ? cb[k] : make_float2(0.f, 0.f);
  }
  // 1. the chunk's all-pole recurrence from a zero state (chunk 0: the carried one)
#pragma unroll
  for (int k = 0; k < kR; ++k) s[k] = c0[k] = j == 0 && k < m ? carry[k] : make_float2(0.f, 0.f);
  if (len == kCL) {
#pragma unroll
    for (int i = 0; i < kCL; ++i) yagi_iir::allpole_step<O, kR>(O::load(xv[i]), m, av, s);
  } else {
#pragma unroll
    for (int i = 0; i < kCL; ++i)
      if (i < len) yagi_iir::allpole_step<O, kR>(O::load(xv[i]), m, av, s);
  }
  // 2. the end states carried along the warp, then across the warps
#pragma unroll
  for (int d = 0; d < 5; ++d) {
#pragma unroll
    for (int k = 0; k < kR; ++k) p[k] = shfl_up<O>(s[k], 1 << d);
    if (lane >= 1 << d) carry_in<O, kR>(s, z + ((1 << d) - 1) * m2, p, m);
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < kR; ++k)
      if (k < m) tot[w * m + k] = s[k];
  }
  __syncthreads();
  if (w == 0) {
    float2 t[kR];
#pragma unroll
    for (int k = 0; k < kR; ++k) t[k] = lane < kWarps && k < m ? tot[lane * m + k] : make_float2(0.f, 0.f);
#pragma unroll
    for (int d = 0; d < kWarpLog; ++d) {
#pragma unroll
      for (int k = 0; k < kR; ++k) p[k] = shfl_up<O>(t[k], 1 << d);
      if (lane >= 1 << d) carry_in<O, kR>(t, z + pow_index(32 << d) * m2, p, m);
    }
    if (lane < kWarps) {
#pragma unroll
      for (int k = 0; k < kR; ++k)
        if (k < m) tot[lane * m + k] = t[k];
    }
  }
  __syncthreads();
  // the chunk's true end state: Z(lane + 1) times the previous warp's added
  float2 sw[kR];
#pragma unroll
  for (int k = 0; k < kR; ++k) sw[k] = w > 0 && k < m ? tot[(w - 1) * m + k] : make_float2(0.f, 0.f);
  if (w > 0) carry_in<O, kR>(s, z + lane * m2, sw, m);
  // 3. the state entering each chunk is the end state of the one before
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const float2 e = shfl_up<O>(s[k], 1);
    s[k] = lane > 0 ? e : w > 0 ? sw[k] : c0[k];
  }
  if (len == kCL) {
#pragma unroll
    for (int i = 0; i < kCL; ++i) xv[i] = O::pack(yagi_iir::tf_step<O, kR>(O::load(xv[i]), m, av, bv, s));
  } else {
#pragma unroll
    for (int i = 0; i < kCL; ++i)
      if (i < len) xv[i] = O::pack(yagi_iir::tf_step<O, kR>(O::load(xv[i]), m, av, bv, s));
  }
  if (j == nch - 1) {  // every thread read carry before the barriers above
#pragma unroll
    for (int k = 0; k < kR; ++k)
      if (k < m) carry[k] = s[k];
  }
}

template <bool kCx, bool kCc, int kR, bool kFixed>
__global__ void __launch_bounds__(kCT)
iir_chunked_kernel(const typename Ops<kCx, kCc>::Elem* __restrict__ x, const float* __restrict__ b,
                   const float* __restrict__ a, const float* __restrict__ scale,
                   const typename Ops<kCx, kCc>::Elem* __restrict__ v_in,
                   typename Ops<kCx, kCc>::Elem* __restrict__ y,
                   typename Ops<kCx, kCc>::Elem* __restrict__ v_out, int C, int T, int m_, int nst) {
  using O = Ops<kCx, kCc>;
  using E = typename O::Elem;
  using QT = std::conditional_t<kCc, float2, float>;
  using W = std::conditional_t<kCc, double2, double>;
  constexpr int G = 16 / sizeof(E), U = kCL / G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m = kFixed ? kR : m_, mm = m > 1 ? m : 1, m2 = m * m;
  E* seg = reinterpret_cast<E*>(smem_raw);                  // [2][kSeg], swizzled (swz)
  W* work = reinterpret_cast<W*>(seg + 2 * kSeg);           // [nst][kNPow + 2][m][m]
  float2* ca = reinterpret_cast<float2*>(work + nst * (kNPow + 2) * m2);  // [nst][m + 1]
  float2* cb = ca + nst * (m + 1);                          // [nst][m + 1]
  float2* carry = cb + nst * (m + 1);                       // [nst][mm]
  float2* tot = carry + nst * mm;                           // [kWarps][mm]
  QT* q = reinterpret_cast<QT*>(tot + kWarps * mm);         // [nst][kNPow][m][m]
  const int j = threadIdx.x;
  // 16-byte copies where every row starts on 16 bytes
  const bool vec = T % G == 0 && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  const int nseg = (T + kSeg - 1) / kSeg;
  const size_t c = blockIdx.x;

  fetch(seg, x + c * T, min(kSeg, T), vec);
  for (int i = j; i < nst * (m + 1); i += kCT) {
    ca[i] = O::coef(a, i);
    cb[i] = O::coef(b, i);
  }
  __syncthreads();
  chunk_powers<kCc>(ca, m, nst, work, q);
  const float2 sc = O::coef(scale, 0);

  for (int i = j; i < nst * m; i += kCT) carry[(i / m) * mm + i % m] = O::load(v_in[c * nst * m + i]);
  for (int k = 0; k < nseg; ++k) {
    const int t0 = k * kSeg, n = min(kSeg, T - t0);
    E* buf = seg + (k & 1) * kSeg;
    __syncthreads();  // the other buffer's segment is stored
    if (k + 1 < nseg) {
      fetch(seg + ((k + 1) & 1) * kSeg, x + c * T + t0 + kSeg, min(kSeg, T - t0 - kSeg), vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // segment k is in
    const int nch = (n + kCL - 1) / kCL;
    const int len = j < nch ? min(kCL, n - j * kCL) : 0;
    E xv[kCL];
    const float4* b4 = reinterpret_cast<const float4*>(buf) + j * U;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      E e[G];
      unpack(b4[u ^ (j & 7)], e);
#pragma unroll
      for (int g = 0; g < G; ++g) xv[u * G + g] = e[g];
    }
    for (int st = 0; st < nst; ++st)
      chunk_stage<O, kR, kFixed>(xv, len, m, ca + st * (m + 1), cb + st * (m + 1), carry + st * mm,
                                 q + st * kNPow * m2, tot, nch);
    float4* o4 = reinterpret_cast<float4*>(buf) + j * U;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      E e[G];
#pragma unroll
      for (int g = 0; g < G; ++g) e[g] = O::pack(O::mul(sc, O::load(xv[u * G + g])));
      o4[u ^ (j & 7)] = pack(e);
    }
    __syncthreads();  // the segment's y is parked, the carried state written
    store(y + c * T + t0, buf, n, vec);
  }
  for (int i = j; i < nst * m; i += kCT) v_out[c * nst * m + i] = O::pack(carry[(i / m) * mm + i % m]);
}

template <bool kCx, bool kCc, int kR, bool kFixed>
int launch_chunked(const void* x, const void* b, const void* a, const void* scale,
                   const void* v_in, void* y, void* v_out, int C, int T, int m, int nst,
                   cudaStream_t stream) {
  using E = typename Ops<kCx, kCc>::Elem;
  const int smem = chunked_smem_bytes(m, nst, kCx, kCc);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kernel = iir_chunked_kernel<kCx, kCc, kR, kFixed>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<C, kCT, smem, stream>>>(static_cast<const E*>(x), static_cast<const float*>(b),
                                      static_cast<const float*>(a), static_cast<const float*>(scale),
                                      static_cast<const E*>(v_in), static_cast<E*>(y),
                                      static_cast<E*>(v_out), C, T, m, nst);
  return (int)cudaGetLastError();
}

template <bool kCx, bool kCc>
int launch_chunked_inst(int inst, const void* x, const void* b, const void* a, const void* scale,
                        const void* v_in, void* y, void* v_out, int C, int T, int m, int nst,
                        cudaStream_t stream) {
  switch (inst) {
    case kChunkOrder1:
      return launch_chunked<kCx, kCc, 1, true>(x, b, a, scale, v_in, y, v_out, C, T, m, nst, stream);
    case kChunkOrder2:
      return launch_chunked<kCx, kCc, 2, true>(x, b, a, scale, v_in, y, v_out, C, T, m, nst, stream);
    default:
      return launch_chunked<kCx, kCc, kCMax, false>(x, b, a, scale, v_in, y, v_out, C, T, m, nst, stream);
  }
}

}  // namespace

// x, y: [C, T] float32 or complex64 (cx); b, a: TF [m + 1] (float32, or
// complex64 when cc) or SOS [m, 3] float32 (sos; m is then the number of
// sections); scale: one coefficient; v_in, v_out: [C, m] (TF) or [C, m, 2]
// (SOS) of the signal type; scratch: [state values, C] of the signal type for
// the device-memory ring (inst 2). inst: 0 TF registers (order ≤ 8), 1
// shared-memory ring, 2 device-memory ring, 3 + m TF registers of order m ≤
// 2, 5 + m SOS registers of m ≤ 4 sections, as kernels/iir.py::scan_instance
// chooses. Launches on `stream`; returns the launch's CUDA error (0 on
// success).
extern "C" int yagi_iir_scan(const void* x, const void* b, const void* a, const void* scale,
                             const void* v_in, void* y, void* v_out, void* scratch, int C, int T,
                             int m, int sos, int cx, int cc, int inst, void* stream) {
  const int S = sos ? 2 * m : m;
  const int elem = cx ? 8 : 4;
  const int smem = scan_smem_bytes(S, elem, inst);
  if ((cc && (!cx || sos)) || !scan_inst_takes(inst, m, sos) || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define YAGI_ARGS inst, smem, x, b, a, scale, v_in, y, v_out, scratch, C, T, m, st
  if (sos) return cx ? launch_scan_inst<true, false, true>(YAGI_ARGS) : launch_scan_inst<false, false, true>(YAGI_ARGS);
  if (cc) return launch_scan_inst<true, true, false>(YAGI_ARGS);
  return cx ? launch_scan_inst<true, false, false>(YAGI_ARGS) : launch_scan_inst<false, false, false>(YAGI_ARGS);
#undef YAGI_ARGS
}

// x, y, scale, cx, cc as for yagi_iir_scan; b, a: [nst, m + 1] (a TF filter
// is one stage of order m, an SOS filter nst stages of order 2); v_in,
// v_out: [C, nst, m] of the signal type. inst: 1 or 2 for stages of that
// order, 0 for the generic instance (m ≤ 8), as
// kernels/iir.py::chunked_instance chooses; the shared memory of
// kernels/iir.py::chunked_smem_bytes within the card's. Returns the launch's
// CUDA error (0 on success).
extern "C" int yagi_iir_chunked(const void* x, const void* b, const void* a, const void* scale,
                                const void* v_in, void* y, void* v_out, int C, int T, int m,
                                int nst, int cx, int cc, int inst, void* stream) {
  const bool takes = inst == kChunkGeneric ? m <= kCMax : (inst == kChunkOrder1 || inst == kChunkOrder2) && m == inst;
  if ((cc && !cx) || !takes || m < 0 || nst < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cc) return launch_chunked_inst<true, true>(inst, x, b, a, scale, v_in, y, v_out, C, T, m, nst, st);
  return cx ? launch_chunked_inst<true, false>(inst, x, b, a, scale, v_in, y, v_out, C, T, m, nst, st)
            : launch_chunked_inst<false, false>(inst, x, b, a, scale, v_in, y, v_out, C, T, m, nst, st);
}
