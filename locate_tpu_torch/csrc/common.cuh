// Device helpers shared by the port's kernels: dtype conversion, the
// activations of locate_tpu/ops/pallas/fused_attention.py:_act and their
// subgradients, the sigmoid gate, the (max, sum-exp) merge of per-tile
// softmax statistics, and the fixed-order reduction of per-block partial
// sums. Each .cu file includes this header and compiles into its own
// library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bfloat16)
}

// The compute-dtype rounding of a value before it enters a product.
template <typename T>
__device__ __forceinline__ float round_cd(float v) {
  return to_f32(from_f32<T>(v));
}

// Activations of locate_tpu/ops/pallas/fused_attention.py:_act.
enum Act { kLeakyRelu = 0, kRelu = 1, kSilu = 2, kGelu = 3 };

__device__ __forceinline__ float activate(float u, int act, float slope) {
  switch (act) {
    case kLeakyRelu: return u >= 0.f ? u : u * slope;
    case kRelu: return fmaxf(u, 0.f);
    case kSilu: return u / (1.f + expf(-u));
    default: {  // gelu, tanh approximation (jax.nn.gelu's default)
      const float k = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * u * (1.f + tanhf(k * (u + 0.044715f * u * u * u)));
    }
  }
}

// Subgradients of _act_grad (fused_attention.py:344): leaky_relu is 1 at
// u >= 0 (jax.nn.leaky_relu is where(u >= 0, ...)), relu is 0 at 0.
__device__ __forceinline__ float activate_grad(float u, int act, float slope) {
  if (act == kLeakyRelu) return u >= 0.f ? 1.f : slope;
  return u > 0.f ? 1.f : 0.f;  // relu
}

// jax.nn.sigmoid: 1 / (1 + exp(-l)).
__device__ __forceinline__ float logistic(float l) { return 1.f / (1.f + expf(-l)); }

// The residual sigmoid gate min(2 sigmoid(l), gate_max); gate_max 0 is no clamp.
__device__ __forceinline__ float sigmoid_gate_of(float l, float gate_max) {
  const float g = 2.f * logistic(l);
  return gate_max > 0.f && g > gate_max ? gate_max : g;
}

// Softmax statistics, part 2: one thread per (n, channel) merges the
// per-tile (max, sum-exp) pairs of part_m / part_s, each (N, tiles, Cout).
__global__ void softmax_stats_merge(const float* __restrict__ part_m,
                                    const float* __restrict__ part_s,
                                    float* __restrict__ m_out, float* __restrict__ se_out,
                                    int N, int tiles, int Cout) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * Cout) return;
  const int n = i / Cout, co = i - n * Cout;
  const float* pm = part_m + (size_t)n * tiles * Cout + co;
  const float* ps = part_s + (size_t)n * tiles * Cout + co;
  float m = -INFINITY;
  for (int k = 0; k < tiles; ++k) m = fmaxf(m, pm[(size_t)k * Cout]);
  float s = 0.f;
  for (int k = 0; k < tiles; ++k) s += ps[(size_t)k * Cout] * expf(pm[(size_t)k * Cout] - m);
  m_out[i] = m;
  se_out[i] = s;
}

cudaError_t launch_stats_merge(const float* part_m, const float* part_s, float* m, float* se,
                               int N, int tiles, int Cout, cudaStream_t stream) {
  const int total = N * Cout;
  softmax_stats_merge<<<(total + 255) / 256, 256, 0, stream>>>(part_m, part_s, m, se, N,
                                                                tiles, Cout);
  return cudaGetLastError();
}

// out[g*W + o] = sum over p < P of part[(g*P + p)*W + o], each sum in a
// fixed order: threadIdx.y takes every kRedY-th partial, then one thread
// adds the kRedY sums. Grid (ceil(W / 32), G), block (32, kRedY).
constexpr int kRedY = 8;

__global__ void reduce_partials(const float* __restrict__ part, float* __restrict__ out,
                                int P, int W) {
  __shared__ float acc[kRedY][33];
  const int o = blockIdx.x * 32 + threadIdx.x;
  const size_t g = blockIdx.y;
  float s = 0.f;
  if (o < W)
    for (int p = threadIdx.y; p < P; p += kRedY) s += part[(g * P + p) * W + o];
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && o < W) {
    float t = 0.f;
    for (int y = 0; y < kRedY; ++y) t += acc[y][threadIdx.x];
    out[g * W + o] = t;
  }
}

cudaError_t launch_reduce(const float* part, float* out, int G, int P, int W,
                          cudaStream_t stream) {
  reduce_partials<<<dim3((W + 31) / 32, G), dim3(32, kRedY), 0, stream>>>(part, out, P, W);
  return cudaGetLastError();
}

// Opt `kernel` in to `bytes` of dynamic shared memory. A refusal is
// returned and cleared, so that it does not resurface as a later launch's
// cudaGetLastError().
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace
