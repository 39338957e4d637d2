// Device helpers shared by the port's kernels: dtype conversion, the
// activations of locate_tpu/ops/pallas/fused_attention.py:_act and their
// subgradients, the sigmoid gate, the (max, sum-exp) merge of per-tile
// softmax statistics, the fixed-order reduction of per-block partial
// sums, and the bf16 tensor-core primitives (mma.sync m16n8k16, ldmatrix,
// cp.async) of the mma routes. Each .cu file includes this header and
// compiles into its own library.
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

// ---- bf16 tensor-core primitives (mma.sync m16n8k16, ldmatrix, cp.async) ----
// shared by the mma routes of flash_attention.cu, fused_stage.cu and
// fused_attention.cu

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (or 4) from device to shared memory, zero-filled where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// all but the most recently committed group
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b: one m16n8k16 product, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment (16 x 16, row-major) of rows row0.. and columns col0.. of
// a bf16 tile with row stride ld.
__device__ __forceinline__ void frag_a(uint32_t (&r)[4], const bf16* tile, int ld, int row0,
                                       int col0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, tile + (row0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + col0 +
                 ((lane >> 4) << 3));
}

// c[n] += A B for NT n-tiles of 8 columns and KS k-steps of 16, B read from
// a tile stored [n][k] (the operand transposed: K for Q K^T).
template <int KS, int NT>
__device__ __forceinline__ void mma_nk(float (&c)[NT][4], const uint32_t (&a)[KS][4],
                                       const bf16* tile, int ld) {
  const int lane = threadIdx.x & 31;
  const bf16* base = tile + ((lane & 7) + ((lane >> 4) << 3)) * ld + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, base + np * 16 * ld + kk * 16);
      mma16816(c[2 * np], a[kk], b[0], b[1]);
      mma16816(c[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// The same with A's fragments read from shared memory step by step (rows
// a_row0.. of a_tile), for operands too wide to keep in registers.
template <int KS, int NT>
__device__ __forceinline__ void mma_nk_smem(float (&c)[NT][4], const bf16* a_tile, int lda,
                                            int a_row0, const bf16* tile, int ld) {
  const int lane = threadIdx.x & 31;
  const bf16* base = tile + ((lane & 7) + ((lane >> 4) << 3)) * ld + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    frag_a(a, a_tile, lda, a_row0, kk * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, base + np * 16 * ld + kk * 16);
      mma16816(c[2 * np], a, b[0], b[1]);
      mma16816(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// c[n] += A B, B read transposed (ldmatrix.trans) from a tile stored
// [k][n], its columns from n0 (K for dS K, dO for P^T dO, Q for dS^T Q).
template <int KS, int NT>
__device__ __forceinline__ void mma_kn(float (&c)[NT][4], const uint32_t (&a)[KS][4],
                                       const bf16* tile, int ld, int n0) {
  const int lane = threadIdx.x & 31;
  const bf16* base =
      tile + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, base + kk * 16 * ld + np * 16);
      mma16816(c[2 * np], a[kk], b[0], b[1]);
      mma16816(c[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// The A fragments (4 k-steps of 16) of a 16 x 64 f32 accumulator tile,
// rounded to bf16: n-tiles 2kk and 2kk+1 make k-step kk.
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
}

// rows x width bf16 of a row-major matrix into shared memory with row
// stride ld, 16 bytes a copy (width % 8 == 0, src 16-byte aligned)
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int rows,
                                           int width, int ld) {
  const int chunks = width >> 3;
  for (int e = threadIdx.x; e < rows * chunks; e += blockDim.x) {
    const int r = e / chunks, c = (e - r * chunks) << 3;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * width + c));
  }
}

// The gate MLP's hidden width on the mma routes
constexpr int kGateHd = 16;

// The gate MLP of one warp's 16 locations on the tensor cores:
//     u = x W1 + pos_proj + b1,  h = (act(u))_cd,  l = h W2 + b2,
// x handed in as A fragments (KS k-steps of 16 channels), h handed on to
// W2 as one A fragment. W1 [KS * 16][kGateHd + 8] and W2 [kGateHd][NT * 8
// + 8] are staged bf16; pp_lo and pp_hi are pos_proj's rows (kGateHd f32)
// of this lane's two locations, lane / 4 and 8 + lane / 4. Out, in
// C-fragment layout (location lane / 4 + 8 (e >> 1), column nt * 8 +
// 2 (lane % 4) + (e & 1)): u and h (f32, h rounded to bf16), and l. The
// fused stage's forward passes (gate_logits_mma), the softmax gate's
// forward pair (softmax_stats_mma, softmax_apply_mma) and the gate's
// backward (softmax_bwd_mma, which also needs act'(u)) share it, so that
// they see one l at (64, 16, 64).
template <int KS, int NT>
__device__ __forceinline__ void gate_mlp_mma(const uint32_t (&xa)[KS][4], const bf16* W1,
                                             const bf16* W2, const float* __restrict__ pp_lo,
                                             const float* __restrict__ pp_hi,
                                             const float* __restrict__ b1,
                                             const float* __restrict__ b2, int act, float slope,
                                             float (&u)[2][4], float (&h)[2][4],
                                             float (&l)[NT][4]) {
  const int lane = threadIdx.x & 31, col = 2 * (lane & 3);
  zero(u);
  mma_kn<KS, 2>(u, xa, W1, kGateHd + 8, 0);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float* ppl = e >> 1 ? pp_hi : pp_lo;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int j = nt * 8 + col + (e & 1);
      u[nt][e] = u[nt][e] + ppl[j] + b1[j];
      h[nt][e] = round_cd<bf16>(activate(u[nt][e], act, slope));
    }
  }
  const uint32_t ha[1][4] = {{pack_bf16(h[0][0], h[0][1]), pack_bf16(h[0][2], h[0][3]),
                              pack_bf16(h[1][0], h[1][1]), pack_bf16(h[1][2], h[1][3])}};
  zero(l);
  mma_kn<1, NT>(l, ha, W2, NT * 8 + 8, 0);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) l[nt][e] += b2[nt * 8 + col + (e & 1)];
}

}  // namespace
