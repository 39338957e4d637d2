// Softmax location-attention gate, forward, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of locate_tpu/ops/pallas/fused_attention.py:
//   * _softmax_stats_kernel (:152)  -> softmax_stats_partial + softmax_stats_merge
//   * _softmax_apply_kernel (:179)  -> softmax_apply
//
// Both compute the per-location gate MLP
//     u = x.W1x + pos_proj + b1        (f32 accumulation of compute-dtype products)
//     h = act(u), rounded to the compute dtype
//     l = h.W2 + b2                    (f32)
// and then either the per-(n, channel) max m and sum-exp se of l over the
// H*W locations (stats), or y = x * min(exp(l - m) / se * HW, gate_max)
// (apply). x is (N, HW, C) in the compute dtype (bf16 or f32), y likewise;
// everything else is f32 except W1x (C, Hd) and W2 (Hd, Cout), which come
// in the compute dtype. Cout is C (per-channel gate) or 1 (one gate per
// location, broadcast over the channels).
//
// Bound: both passes are memory-bound on this card. The stats pass must
// read x once (2*N*HW*C bytes in bf16), the apply pass must read x and
// write y; the gate MLP is C*Hd + Hd*Cout multiply-adds per location,
// well under the card's operations-per-byte line. The logits are
// recomputed in the apply pass rather than stored, as on the TPU: storing
// l would cost another (N, HW, Cout) round trip through memory.
//
// Design: the TPU stats kernel carries (max, sum-exp) across a sequential
// grid axis in VMEM. Blocks on this card run in parallel and in no order,
// so each block, one (spatial tile, batch row), writes its tile's partial
// (max, sum-exp) per channel to a workspace, and a second small kernel
// merges the partials (se = sum_i se_i * exp(m_i - m)). Each block stages
// its x tile in shared memory as f32, transposed to [C][T] so that four
// consecutive locations of one channel load as one float4; the two small
// products run as f32 FMA loops with a 4-location register tile, the
// weights read through the read-only cache. This first version uses no
// tensor cores, TMA or wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bfloat16)
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

// Shared-memory layout of one block. ldt = T + 4 keeps every row of the
// transposed tiles float4-aligned.
struct Tile {
  int ldt;
  float* xs;   // [C][ldt]  x tile, transposed, f32
  float* hs;   // [Hd][ldt] hidden activations, transposed, rounded to cd
  float* ls;   // [T][Cout] logits, then gates
  float* red;  // [2][max(kThreads, Cout)] reduction scratch
};

__host__ __device__ inline size_t tile_floats(int C, int Hd, int Cout, int T) {
  const size_t ldt = T + 4;
  const size_t red = 2 * (size_t)(Cout > kThreads ? Cout : kThreads);
  return (size_t)C * ldt + (size_t)Hd * ldt + (size_t)T * Cout + red;
}

__device__ inline Tile make_tile(float* smem, int C, int Hd, int Cout, int T) {
  Tile L;
  L.ldt = T + 4;
  L.xs = smem;
  L.hs = L.xs + (size_t)C * L.ldt;
  L.ls = L.hs + (size_t)Hd * L.ldt;
  L.red = L.ls + (size_t)T * Cout;
  return L;
}

// The gate logits of `rows` locations starting at t0 of batch row n, into
// L.ls. rows4 = rows rounded up to a multiple of 4; the padding rows of the
// x tile are zero and never stored.
template <typename T>
__device__ void tile_logits(const T* __restrict__ x, const float* __restrict__ pp,
                            const T* __restrict__ w1, const float* __restrict__ b1,
                            const T* __restrict__ w2, const float* __restrict__ b2,
                            int n, int t0, int rows, int rows4, int HW, int C,
                            int Hd, int Cout, int act, float slope, const Tile& L) {
  // x tile -> shared, transposed; the tile is one contiguous run of rows*C
  const T* src = x + ((size_t)n * HW + t0) * C;
  for (int i = threadIdx.x; i < rows4 * C; i += blockDim.x) {
    const int t = i / C, c = i - t * C;
    L.xs[c * L.ldt + t] = t < rows ? to_f32(src[i]) : 0.f;
  }
  __syncthreads();

  // u = x.W1x + pos_proj + b1 ; h = act(u) rounded to the compute dtype
  const int tq_n = rows4 / 4;
  for (int o = threadIdx.x; o < tq_n * Hd; o += blockDim.x) {
    const int j = o % Hd, tq = o / Hd;
    const float* xp = L.xs + tq * 4;
    const T* wp = w1 + j;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int c = 0; c < C; ++c) {
      const float4 xv = *reinterpret_cast<const float4*>(xp + c * L.ldt);
      const float w = to_f32(wp[(size_t)c * Hd]);
      a0 = fmaf(xv.x, w, a0);
      a1 = fmaf(xv.y, w, a1);
      a2 = fmaf(xv.z, w, a2);
      a3 = fmaf(xv.w, w, a3);
    }
    const float acc[4] = {a0, a1, a2, a3};
    const float bj = b1[j];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = tq * 4 + r;
      float h = 0.f;
      if (t < rows) {
        const float u = acc[r] + pp[(size_t)(t0 + t) * Hd + j] + bj;
        h = to_f32(from_f32<T>(activate(u, act, slope)));
      }
      L.hs[j * L.ldt + t] = h;
    }
  }
  __syncthreads();

  // l = h.W2 + b2
  for (int o = threadIdx.x; o < tq_n * Cout; o += blockDim.x) {
    const int co = o % Cout, tq = o / Cout;
    const float* hp = L.hs + tq * 4;
    const T* wp = w2 + co;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int j = 0; j < Hd; ++j) {
      const float4 hv = *reinterpret_cast<const float4*>(hp + j * L.ldt);
      const float w = to_f32(wp[(size_t)j * Cout]);
      a0 = fmaf(hv.x, w, a0);
      a1 = fmaf(hv.y, w, a1);
      a2 = fmaf(hv.z, w, a2);
      a3 = fmaf(hv.w, w, a3);
    }
    const float acc[4] = {a0, a1, a2, a3};
    const float bc = b2[co];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = tq * 4 + r;
      if (t < rows) L.ls[t * Cout + co] = acc[r] + bc;
    }
  }
  __syncthreads();
}

// Stats pass, part 1: grid (tiles, N). Writes the tile's (max, sum-exp)
// per channel to part_m / part_s, each (N, tiles, Cout).
template <typename T>
__global__ void __launch_bounds__(kThreads) softmax_stats_partial(
    const T* __restrict__ x, const float* __restrict__ pp, const T* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ part_m, float* __restrict__ part_s, int HW, int C, int Hd,
    int Cout, int T_rows, int act, float slope) {
  extern __shared__ __align__(16) float smem[];
  const Tile L = make_tile(smem, C, Hd, Cout, T_rows);
  const int tile = blockIdx.x, n = blockIdx.y, tiles = gridDim.x;
  const int t0 = tile * T_rows;
  const int rows = min(T_rows, HW - t0);
  const int rows4 = (rows + 3) & ~3;
  tile_logits<T>(x, pp, w1, b1, w2, b2, n, t0, rows, rows4, HW, C, Hd, Cout, act,
                 slope, L);

  // `parts` threads per channel each reduce every parts-th row, then one
  // thread per channel merges the parts
  const int parts = max(1, (int)blockDim.x / Cout);
  float* red_m = L.red;
  float* red_s = L.red + parts * Cout;
  for (int o = threadIdx.x; o < parts * Cout; o += blockDim.x) {
    const int co = o % Cout, p = o / Cout;
    float m = -INFINITY;
    for (int t = p; t < rows; t += parts) m = fmaxf(m, L.ls[t * Cout + co]);
    float s = 0.f;
    for (int t = p; t < rows; t += parts) s += expf(L.ls[t * Cout + co] - m);
    red_m[o] = m;
    red_s[o] = s;
  }
  __syncthreads();
  for (int co = threadIdx.x; co < Cout; co += blockDim.x) {
    float m = -INFINITY;
    for (int p = 0; p < parts; ++p) m = fmaxf(m, red_m[p * Cout + co]);
    float s = 0.f;
    for (int p = 0; p < parts; ++p) {
      const float mp = red_m[p * Cout + co];
      if (mp != -INFINITY) s += red_s[p * Cout + co] * expf(mp - m);
    }
    const size_t off = ((size_t)n * tiles + tile) * Cout + co;
    part_m[off] = m;
    part_s[off] = s;
  }
}

// Stats pass, part 2: one thread per (n, channel) merges the tiles.
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

// Apply pass: grid (tiles, N). m, se are (N, Cout).
template <typename T>
__global__ void __launch_bounds__(kThreads) softmax_apply(
    const T* __restrict__ x, const float* __restrict__ pp, const T* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ m, const float* __restrict__ se, T* __restrict__ y, int HW,
    int C, int Hd, int Cout, int T_rows, int act, float slope, float hw_scale,
    float gate_max) {
  extern __shared__ __align__(16) float smem[];
  const Tile L = make_tile(smem, C, Hd, Cout, T_rows);
  const int tile = blockIdx.x, n = blockIdx.y;
  const int t0 = tile * T_rows;
  const int rows = min(T_rows, HW - t0);
  const int rows4 = (rows + 3) & ~3;
  tile_logits<T>(x, pp, w1, b1, w2, b2, n, t0, rows, rows4, HW, C, Hd, Cout, act,
                 slope, L);

  const float* mn = m + (size_t)n * Cout;
  const float* sn = se + (size_t)n * Cout;
  for (int o = threadIdx.x; o < rows * Cout; o += blockDim.x) {
    const int co = o % Cout;
    float g = expf(L.ls[o] - mn[co]) / sn[co] * hw_scale;
    if (gate_max > 0.f && g > gate_max) g = gate_max;
    L.ls[o] = g;
  }
  __syncthreads();
  T* dst = y + ((size_t)n * HW + t0) * C;
  const bool broadcast = Cout == 1;
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int t = i / C, c = i - t * C;
    const float g = L.ls[t * Cout + (broadcast ? 0 : c)];
    dst[i] = from_f32<T>(L.xs[c * L.ldt + t] * g);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
cudaError_t launch_stats(const void* x, const void* pp, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* part_m, void* part_s,
                         void* m, void* se, int N, int HW, int C, int Hd, int Cout,
                         int T_rows, int act, float slope, cudaStream_t stream) {
  const int tiles = (HW + T_rows - 1) / T_rows;
  const size_t smem = tile_floats(C, Hd, Cout, T_rows) * sizeof(float);
  cudaError_t err = allow_smem(softmax_stats_partial<T>, smem);
  if (err != cudaSuccess) return err;
  softmax_stats_partial<T><<<dim3(tiles, N), kThreads, smem, stream>>>(
      (const T*)x, (const float*)pp, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)b2, (float*)part_m, (float*)part_s, HW, C, Hd, Cout, T_rows, act,
      slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = N * Cout;
  softmax_stats_merge<<<(total + 255) / 256, 256, 0, stream>>>(
      (const float*)part_m, (const float*)part_s, (float*)m, (float*)se, N, tiles, Cout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_apply(const void* x, const void* pp, const void* w1, const void* b1,
                         const void* w2, const void* b2, const void* m, const void* se,
                         void* y, int N, int HW, int C, int Hd, int Cout, int T_rows,
                         int act, float slope, float hw_scale, float gate_max,
                         cudaStream_t stream) {
  const int tiles = (HW + T_rows - 1) / T_rows;
  const size_t smem = tile_floats(C, Hd, Cout, T_rows) * sizeof(float);
  cudaError_t err = allow_smem(softmax_apply<T>, smem);
  if (err != cudaSuccess) return err;
  softmax_apply<T><<<dim3(tiles, N), kThreads, smem, stream>>>(
      (const T*)x, (const float*)pp, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)b2, (const float*)m, (const float*)se, (T*)y, HW, C, Hd, Cout,
      T_rows, act, slope, hw_scale, gate_max);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. `is_bf16` selects the compute
// dtype (1: bfloat16, 0: float32). Returns a cudaError_t (0 = launched).
extern "C" {

size_t locate_softmax_smem_bytes(int C, int Hd, int Cout, int T_rows) {
  return tile_floats(C, Hd, Cout, T_rows) * sizeof(float);
}

int locate_softmax_stats(int is_bf16, const void* x, const void* pp, const void* w1,
                         const void* b1, const void* w2, const void* b2, void* part_m,
                         void* part_s, void* m, void* se, int N, int HW, int C, int Hd,
                         int Cout, int T_rows, int act, float slope, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch_stats<__nv_bfloat16>(x, pp, w1, b1, w2, b2, part_m, part_s, m, se,
                                            N, HW, C, Hd, Cout, T_rows, act, slope, s);
  return (int)launch_stats<float>(x, pp, w1, b1, w2, b2, part_m, part_s, m, se, N, HW, C,
                                  Hd, Cout, T_rows, act, slope, s);
}

int locate_softmax_apply(int is_bf16, const void* x, const void* pp, const void* w1,
                         const void* b1, const void* w2, const void* b2, const void* m,
                         const void* se, void* y, int N, int HW, int C, int Hd, int Cout,
                         int T_rows, int act, float slope, float hw_scale, float gate_max,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch_apply<__nv_bfloat16>(x, pp, w1, b1, w2, b2, m, se, y, N, HW, C, Hd,
                                            Cout, T_rows, act, slope, hw_scale, gate_max,
                                            s);
  return (int)launch_apply<float>(x, pp, w1, b1, w2, b2, m, se, y, N, HW, C, Hd, Cout,
                                  T_rows, act, slope, hw_scale, gate_max, s);
}

const char* locate_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
