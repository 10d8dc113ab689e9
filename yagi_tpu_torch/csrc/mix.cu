// u32 NCO mix-down: y[t] = x[t]·e^{−j(θ0 + t·dθ)} over interleaved complex64.
//
// Replaces yagi_tpu/kernels/mix.py::_mix_kernel (the Pallas TPU kernel behind
// pallas_mix_down). The phase ramp is formed per sample from θ0 and dθ, read
// from 0-d int64 device tensors, so no phase array touches device memory and
// nothing waits on the host. The phase and the rotation are nco.cuh's, the
// same step as the chain kernel's epilogue (chain.cu), and equal
// Osc.mix_block_down in mode "exact".
//
// What bounds it on an H100: 16 bytes of traffic per sample (8 in, 8 out)
// against one sincosf and four multiply-adds, so it is memory-bound. The TPU
// kernel splits re/im into planes (Mosaic has no complex type); here each
// thread moves two interleaved complex samples as one 16-byte float4 load and
// store, neighbouring threads on neighbouring addresses.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nco.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
mix_down_kernel(const float4* __restrict__ x,  // [n/2] pairs of complex64
                const int64_t* __restrict__ theta0_p, const int64_t* __restrict__ dtheta_p,
                float4* __restrict__ y, int n_pairs) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_pairs) return;
  const uint32_t theta0 = (uint32_t)(*theta0_p);
  const uint32_t dtheta = (uint32_t)(*dtheta_p);
  const uint32_t t = 2u * (uint32_t)i;
  const float4 v = x[i];
  float4 o;
  yagi::nco_rotate_down(v.x, v.y, theta0 + t * dtheta, o.x, o.y);
  yagi::nco_rotate_down(v.z, v.w, theta0 + (t + 1u) * dtheta, o.z, o.w);
  y[i] = o;
}

}  // namespace

// x, y: n complex64 samples, 16-byte aligned, n even and below 2^31;
// theta0/dtheta: int64 scalars in [0, 2^32) on the device. Launches on
// `stream` and returns the CUDA error of the launch (0 on success).
extern "C" int yagi_mix_down(const void* x, const int64_t* theta0, const int64_t* dtheta,
                             void* y, int n, void* stream) {
  const int n_pairs = n / 2;
  const int blocks = (n_pairs + kThreads - 1) / kThreads;
  mix_down_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), theta0, dtheta, static_cast<float4*>(y), n_pairs);
  return (int)cudaGetLastError();
}
