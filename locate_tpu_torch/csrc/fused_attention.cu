// Softmax location-attention gate, forward and backward, for Hopper (sm_90a).
//
// Replaces the four TPU kernels of locate_tpu/ops/pallas/fused_attention.py:
//   * _softmax_stats_kernel (:152)  -> softmax_stats_partial + softmax_stats_merge
//   * _softmax_apply_kernel (:179)  -> softmax_apply
//   * _softmax_csum_kernel  (:358)  -> softmax_csum_partial + reduce_partials
//   * _bwd_kernel_softmax   (:397, body _bwd_body :408)
//                                   -> softmax_bwd + reduce_partials (twice)
//
// All compute the per-location gate MLP
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
// The backward of y with respect to everything, given dy, with
// g = exp(l - m) / se * HW, mask = [g <= gate_max] (all ones when the
// clamp is off) and dg = x * dy (summed over channels when Cout = 1):
//     c    = sum_s g * mask * dg                 per (n, channel)   (csum)
//     dl   = g * mask * dg - (g / HW) * c
//     du   = act'(u) * (dl_cd . W2^T)
//     dx   = min(g, gate_max) * dy + du_cd . W1x^T
//     dW1x = x^T du_cd, dW2 = h^T dl_cd, db1 = sum du, db2 = sum dl,
//     dpos_proj = sum_n du                                         (bwd)
// where _cd marks a value rounded to the compute dtype before a product,
// as the TPU kernel rounds it.
//
// Bound: every pass is memory-bound on this card. The stats pass must
// read x once (2*N*HW*C bytes in bf16), the apply pass must read x and
// write y, csum reads x and dy, bwd reads x and dy and writes dx; the gate
// MLP is C*Hd + Hd*Cout multiply-adds per location (three times that in
// the backward), well under the card's operations-per-byte line. The
// logits are recomputed in every pass rather than stored, as on the TPU:
// storing l would cost another (N, HW, Cout) round trip through memory.
//
// Design: the TPU carries sums across a sequential grid axis in VMEM
// (stats, csum) or in revisited output blocks (the weight gradients of
// bwd). Blocks on this card run in parallel and in no order, so each block
// writes its partial sums to a workspace and a second kernel reduces the
// partials: the stats merge folds (max, sum-exp) pairs, and
// reduce_partials adds partials in a fixed order, so two runs give
// bitwise-equal results (no float atomics). A bwd block owns one spatial
// tile and loops over R batch rows, adding its rows' weight gradients
// into its own slice of the workspace; R is chosen by the caller to keep
// a few hundred blocks in flight while shrinking the workspace. Each
// block stages its x tile in shared memory as f32, transposed to [C][T]
// so that four consecutive locations of one channel load as one float4;
// the small products run as f32 FMA loops with a 4-location register
// tile, the weights read through the read-only cache (C=512 x Hd=128
// weights would not fit in shared memory as f32). This first version uses
// no tensor cores, TMA or wgmma.

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

// Subgradients of _act_grad (fused_attention.py:344): leaky_relu is 1 at
// u >= 0 (jax.nn.leaky_relu is where(u >= 0, ...)), relu is 0 at 0.
__device__ __forceinline__ float activate_grad(float u, int act, float slope) {
  if (act == kLeakyRelu) return u >= 0.f ? 1.f : slope;
  return u > 0.f ? 1.f : 0.f;  // relu
}

// Shared-memory layout of one block. ldt = T + 4 keeps every row of the
// transposed tiles float4-aligned.
struct Tile {
  int ldt;
  float* xs;   // [C][ldt]  x tile, transposed, f32
  float* hs;   // [Hd][ldt] hidden activations, transposed, rounded to cd
  float* ls;   // [T][Cout] logits, then gates
  float* red;  // [2][max(kThreads, Cout)] reduction scratch
  float* ag;   // [Hd][ldt] act'(u), transposed (backward only, else null)
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
  L.ag = nullptr;
  return L;
}

// The gate logits of `rows` locations starting at t0 of batch row n, into
// L.ls (and act'(u) into L.ag when it is set). rows4 = rows rounded up to a
// multiple of 4; the padding rows of the x, h and act' tiles are zero and
// the logits of padding rows are never stored.
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
      float h = 0.f, dh_du = 0.f;
      if (t < rows) {
        const float u = acc[r] + pp[(size_t)(t0 + t) * Hd + j] + bj;
        h = to_f32(from_f32<T>(activate(u, act, slope)));
        if (L.ag) dh_du = activate_grad(u, act, slope);
      }
      L.hs[j * L.ldt + t] = h;
      if (L.ag) L.ag[j * L.ldt + t] = dh_du;
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

// dL/dg of a broadcast gate (Cout = 1): for each of `rows` locations the
// sum over channels of x * dy, one warp per location, into dg[t].
template <typename T>
__device__ void row_dots(const T* __restrict__ x, const T* __restrict__ dy, size_t row0,
                         int rows, int C, float* dg) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int t = warp; t < rows; t += warps) {
    const T* xr = x + (row0 + t) * C;
    const T* dr = dy + (row0 + t) * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s = fmaf(to_f32(xr[c]), to_f32(dr[c]), s);
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) dg[t] = s;
  }
}

// The compute-dtype rounding of a value before it enters a product.
template <typename T>
__device__ __forceinline__ float round_cd(float v) {
  return to_f32(from_f32<T>(v));
}

// Backward pass A, part 1: grid (tiles, N), the forward's tile. Writes the
// tile's partial c = sum_s g * mask * dg per channel to part_c
// (N, tiles, Cout); reduce_partials sums the tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads) softmax_csum_partial(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ pp,
    const T* __restrict__ w1, const float* __restrict__ b1, const T* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ m, const float* __restrict__ se,
    float* __restrict__ part_c, int HW, int C, int Hd, int Cout, int T_rows, int act,
    float slope, float hw_scale, float gate_max) {
  extern __shared__ __align__(16) float smem[];
  const Tile L = make_tile(smem, C, Hd, Cout, T_rows);
  const int tile = blockIdx.x, n = blockIdx.y, tiles = gridDim.x;
  const int t0 = tile * T_rows;
  const int rows = min(T_rows, HW - t0);
  const int rows4 = (rows + 3) & ~3;
  tile_logits<T>(x, pp, w1, b1, w2, b2, n, t0, rows, rows4, HW, C, Hd, Cout, act,
                 slope, L);

  const size_t row0 = (size_t)n * HW + t0;
  const bool broadcast = Cout == 1 && C != 1;
  if (broadcast) {
    row_dots<T>(x, dy, row0, rows, C, L.red);
    __syncthreads();
  }
  const float* mn = m + (size_t)n * Cout;
  const float* sn = se + (size_t)n * Cout;
  for (int o = threadIdx.x; o < rows * Cout; o += blockDim.x) {
    const int t = o / Cout, co = o - t * Cout;
    const float g = expf(L.ls[o] - mn[co]) / sn[co] * hw_scale;
    const size_t i = (row0 + t) * C + co;
    float dg = broadcast ? L.red[t] : to_f32(x[i]) * to_f32(dy[i]);
    if (gate_max > 0.f) dg *= g <= gate_max ? 1.f : 0.f;
    L.ls[o] = g * dg;
  }
  __syncthreads();

  // column sums: `parts` threads per channel, then one thread per channel
  const int parts = max(1, (int)blockDim.x / Cout);
  for (int o = threadIdx.x; o < parts * Cout; o += blockDim.x) {
    const int co = o % Cout, p = o / Cout;
    float s = 0.f;
    for (int t = p; t < rows; t += parts) s += L.ls[t * Cout + co];
    L.red[o] = s;
  }
  __syncthreads();
  for (int co = threadIdx.x; co < Cout; co += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += L.red[p * Cout + co];
    part_c[((size_t)n * tiles + tile) * Cout + co] = s;
  }
}

// Shared memory of one backward block, in floats: the x, h, act'(u) and du
// tiles (transposed, [*][ldt]), the dl and clamped-gate tiles ([T][Cout]),
// and the broadcast gate's dL/dg per location.
__host__ __device__ inline size_t bwd_tile_floats(int C, int Hd, int Cout, int T) {
  const size_t ldt = T + 4;
  return ((size_t)C + 3 * (size_t)Hd) * ldt + 2 * (size_t)T * Cout + ldt;
}

// Backward pass B: grid (tiles, nb). Block (tile, b) handles batch rows
// b*R .. b*R+R-1 of one spatial tile: it recomputes u, h and l, forms dl,
// du and dx (written out), and adds its rows' dW1x, dW2, db1, db2 into its
// own slice of part_w (blocks, C*Hd + Hd*Cout + Hd + Cout) and its rows'
// du into its slice of part_pp (nb, HW, Hd). Each output of a slice is
// owned by one thread for all R rows, so the sums are in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads) softmax_bwd(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ pp,
    const T* __restrict__ w1, const float* __restrict__ b1, const T* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ m, const float* __restrict__ se,
    const float* __restrict__ csum, T* __restrict__ dx, float* __restrict__ part_w,
    float* __restrict__ part_pp, int N, int HW, int C, int Hd, int Cout, int T_rows,
    int R, int act, float slope, float hw_scale, float gate_max) {
  extern __shared__ __align__(16) float smem[];
  Tile L;
  L.ldt = T_rows + 4;
  L.xs = smem;
  L.hs = L.xs + (size_t)C * L.ldt;
  L.ag = L.hs + (size_t)Hd * L.ldt;
  float* dus = L.ag + (size_t)Hd * L.ldt;  // [Hd][ldt] du, f32
  L.ls = dus + (size_t)Hd * L.ldt;         // [T][Cout] logits, then dl
  float* gs = L.ls + (size_t)T_rows * Cout;  // [T][Cout] clamped gate
  float* dgr = gs + (size_t)T_rows * Cout;   // [T] broadcast gate's dL/dg
  L.red = nullptr;

  const int tile = blockIdx.x, b = blockIdx.y, tiles = gridDim.x;
  const int t0 = tile * T_rows;
  const int rows = min(T_rows, HW - t0);
  const int rows4 = (rows + 3) & ~3;
  const int tq_n = rows4 / 4;
  const int ldt = L.ldt;
  const bool broadcast = Cout == 1 && C != 1;
  const size_t wtot = (size_t)C * Hd + (size_t)Hd * Cout + Hd + Cout;
  float* pw1 = part_w + ((size_t)b * tiles + tile) * wtot;
  float* pw2 = pw1 + (size_t)C * Hd;
  float* pb1 = pw2 + (size_t)Hd * Cout;
  float* pb2 = pb1 + Hd;
  float* ppp = part_pp + (size_t)b * HW * Hd + (size_t)t0 * Hd;

  for (int r = 0; r < R; ++r) {
    const int n = b * R + r;
    if (n >= N) break;
    const bool first = r == 0;
    tile_logits<T>(x, pp, w1, b1, w2, b2, n, t0, rows, rows4, HW, C, Hd, Cout, act,
                   slope, L);
    const size_t row0 = (size_t)n * HW + t0;
    if (broadcast) {
      row_dots<T>(x, dy, row0, rows, C, dgr);
      __syncthreads();
    }

    // dl and the clamped gate; padding rows are zero
    const float* mn = m + (size_t)n * Cout;
    const float* sn = se + (size_t)n * Cout;
    const float* cn = csum + (size_t)n * Cout;
    for (int o = threadIdx.x; o < rows4 * Cout; o += blockDim.x) {
      const int t = o / Cout, co = o - t * Cout;
      if (t >= rows) {
        L.ls[o] = 0.f;
        gs[o] = 0.f;
        continue;
      }
      const float g = expf(L.ls[o] - mn[co]) / sn[co] * hw_scale;
      const size_t i = (row0 + t) * C + co;
      float dg = broadcast ? dgr[t] : to_f32(x[i]) * to_f32(dy[i]);
      float ghat = g;
      if (gate_max > 0.f) {
        dg *= g <= gate_max ? 1.f : 0.f;
        if (g > gate_max) ghat = gate_max;
      }
      L.ls[o] = g * dg - (g / hw_scale) * cn[co];
      gs[o] = ghat;
    }
    __syncthreads();

    // du = act'(u) * (dl_cd . W2^T)
    for (int o = threadIdx.x; o < tq_n * Hd; o += blockDim.x) {
      const int j = o % Hd, tq = o / Hd;
      const T* wp = w2 + (size_t)j * Cout;
      const float* l0 = L.ls + (size_t)(tq * 4) * Cout;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int co = 0; co < Cout; ++co) {
        const float w = to_f32(wp[co]);
        a0 = fmaf(round_cd<T>(l0[co]), w, a0);
        a1 = fmaf(round_cd<T>(l0[Cout + co]), w, a1);
        a2 = fmaf(round_cd<T>(l0[2 * Cout + co]), w, a2);
        a3 = fmaf(round_cd<T>(l0[3 * Cout + co]), w, a3);
      }
      const float acc[4] = {a0, a1, a2, a3};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = tq * 4 + q;
        dus[j * ldt + t] = L.ag[j * ldt + t] * acc[q];
      }
    }
    __syncthreads();

    // dx = min(g, gate_max) * dy + du_cd . W1x^T
    for (int o = threadIdx.x; o < tq_n * C; o += blockDim.x) {
      const int c = o % C, tq = o / C;
      const T* wp = w1 + (size_t)c * Hd;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int j = 0; j < Hd; ++j) {
        const float4 dv = *reinterpret_cast<const float4*>(dus + j * ldt + tq * 4);
        const float w = to_f32(wp[j]);
        a0 = fmaf(round_cd<T>(dv.x), w, a0);
        a1 = fmaf(round_cd<T>(dv.y), w, a1);
        a2 = fmaf(round_cd<T>(dv.z), w, a2);
        a3 = fmaf(round_cd<T>(dv.w), w, a3);
      }
      const float acc[4] = {a0, a1, a2, a3};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = tq * 4 + q;
        if (t < rows) {
          const size_t i = (row0 + t) * C + c;
          const float g = gs[t * Cout + (broadcast ? 0 : c)];
          dx[i] = from_f32<T>(g * to_f32(dy[i]) + acc[q]);
        }
      }
    }

    // this row's weight gradients, added into the block's own slices
    for (int o = threadIdx.x; o < C * Hd; o += blockDim.x) {  // dW1x = x^T du_cd
      const int j = o % Hd, c = o / Hd;
      const float* xp = L.xs + (size_t)c * ldt;
      const float* dp = dus + (size_t)j * ldt;
      float s = 0.f;
      for (int tq = 0; tq < tq_n; ++tq) {
        const float4 xv = *reinterpret_cast<const float4*>(xp + tq * 4);
        const float4 dv = *reinterpret_cast<const float4*>(dp + tq * 4);
        s = fmaf(xv.x, round_cd<T>(dv.x), s);
        s = fmaf(xv.y, round_cd<T>(dv.y), s);
        s = fmaf(xv.z, round_cd<T>(dv.z), s);
        s = fmaf(xv.w, round_cd<T>(dv.w), s);
      }
      pw1[o] = first ? s : pw1[o] + s;
    }
    for (int o = threadIdx.x; o < Hd * Cout; o += blockDim.x) {  // dW2 = h^T dl_cd
      const int co = o % Cout, j = o / Cout;
      const float* hp = L.hs + (size_t)j * ldt;
      float s = 0.f;
      for (int t = 0; t < rows; ++t) s = fmaf(hp[t], round_cd<T>(L.ls[t * Cout + co]), s);
      pw2[o] = first ? s : pw2[o] + s;
    }
    for (int j = threadIdx.x; j < Hd; j += blockDim.x) {  // db1 = sum du
      float s = 0.f;
      for (int t = 0; t < rows; ++t) s += dus[j * ldt + t];
      pb1[j] = first ? s : pb1[j] + s;
    }
    for (int co = threadIdx.x; co < Cout; co += blockDim.x) {  // db2 = sum dl
      float s = 0.f;
      for (int t = 0; t < rows; ++t) s += L.ls[t * Cout + co];
      pb2[co] = first ? s : pb2[co] + s;
    }
    for (int o = threadIdx.x; o < rows * Hd; o += blockDim.x) {  // dpos_proj rows
      const int j = o % Hd, t = o / Hd;
      const float v = dus[j * ldt + t];
      ppp[o] = first ? v : ppp[o] + v;
    }
    __syncthreads();  // the next row overwrites the tiles
  }
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


template <typename T>
cudaError_t launch_csum(const void* x, const void* dy, const void* pp, const void* w1,
                        const void* b1, const void* w2, const void* b2, const void* m,
                        const void* se, void* part_c, void* c, int N, int HW, int C, int Hd,
                        int Cout, int T_rows, int act, float slope, float hw_scale,
                        float gate_max, cudaStream_t stream) {
  const int tiles = (HW + T_rows - 1) / T_rows;
  const size_t smem = tile_floats(C, Hd, Cout, T_rows) * sizeof(float);
  cudaError_t err = allow_smem(softmax_csum_partial<T>, smem);
  if (err != cudaSuccess) return err;
  softmax_csum_partial<T><<<dim3(tiles, N), kThreads, smem, stream>>>(
      (const T*)x, (const T*)dy, (const float*)pp, (const T*)w1, (const float*)b1,
      (const T*)w2, (const float*)b2, (const float*)m, (const float*)se, (float*)part_c, HW,
      C, Hd, Cout, T_rows, act, slope, hw_scale, gate_max);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce((const float*)part_c, (float*)c, N, tiles, Cout, stream);
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const void* pp, const void* w1,
                       const void* b1, const void* w2, const void* b2, const void* m,
                       const void* se, const void* c, void* dx, void* part_w, void* part_pp,
                       void* dw, void* dpp, int N, int HW, int C, int Hd, int Cout,
                       int T_rows, int R, int act, float slope, float hw_scale,
                       float gate_max, cudaStream_t stream) {
  const int tiles = (HW + T_rows - 1) / T_rows;
  const int nb = (N + R - 1) / R;
  const size_t smem = bwd_tile_floats(C, Hd, Cout, T_rows) * sizeof(float);
  cudaError_t err = allow_smem(softmax_bwd<T>, smem);
  if (err != cudaSuccess) return err;
  softmax_bwd<T><<<dim3(tiles, nb), kThreads, smem, stream>>>(
      (const T*)x, (const T*)dy, (const float*)pp, (const T*)w1, (const float*)b1,
      (const T*)w2, (const float*)b2, (const float*)m, (const float*)se, (const float*)c,
      (T*)dx, (float*)part_w, (float*)part_pp, N, HW, C, Hd, Cout, T_rows, R, act, slope,
      hw_scale, gate_max);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int wtot = C * Hd + Hd * Cout + Hd + Cout;
  err = launch_reduce((const float*)part_w, (float*)dw, 1, tiles * nb, wtot, stream);
  if (err != cudaSuccess) return err;
  return launch_reduce((const float*)part_pp, (float*)dpp, 1, nb, HW * Hd, stream);
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

size_t locate_softmax_bwd_smem_bytes(int C, int Hd, int Cout, int T_rows) {
  return bwd_tile_floats(C, Hd, Cout, T_rows) * sizeof(float);
}

// part_c: (N, tiles, Cout) workspace; c: (N, Cout) out.
int locate_softmax_csum(int is_bf16, const void* x, const void* dy, const void* pp,
                        const void* w1, const void* b1, const void* w2, const void* b2,
                        const void* m, const void* se, void* part_c, void* c, int N, int HW,
                        int C, int Hd, int Cout, int T_rows, int act, float slope,
                        float hw_scale, float gate_max, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch_csum<__nv_bfloat16>(x, dy, pp, w1, b1, w2, b2, m, se, part_c, c, N,
                                           HW, C, Hd, Cout, T_rows, act, slope, hw_scale,
                                           gate_max, s);
  return (int)launch_csum<float>(x, dy, pp, w1, b1, w2, b2, m, se, part_c, c, N, HW, C, Hd,
                                 Cout, T_rows, act, slope, hw_scale, gate_max, s);
}

// part_w: (ceil(HW/T_rows) * ceil(N/R), C*Hd + Hd*Cout + Hd + Cout) and
// part_pp: (ceil(N/R), HW, Hd) workspaces; dx: (N, HW, C) out; dw: the
// concatenated f32 [dW1x (C, Hd), dW2 (Hd, Cout), db1 (Hd), db2 (Cout)]
// out; dpp: (HW, Hd) out.
int locate_softmax_bwd(int is_bf16, const void* x, const void* dy, const void* pp,
                       const void* w1, const void* b1, const void* w2, const void* b2,
                       const void* m, const void* se, const void* c, void* dx, void* part_w,
                       void* part_pp, void* dw, void* dpp, int N, int HW, int C, int Hd,
                       int Cout, int T_rows, int R, int act, float slope, float hw_scale,
                       float gate_max, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch_bwd<__nv_bfloat16>(x, dy, pp, w1, b1, w2, b2, m, se, c, dx, part_w,
                                          part_pp, dw, dpp, N, HW, C, Hd, Cout, T_rows, R,
                                          act, slope, hw_scale, gate_max, s);
  return (int)launch_bwd<float>(x, dy, pp, w1, b1, w2, b2, m, se, c, dx, part_w, part_pp, dw,
                                dpp, N, HW, C, Hd, Cout, T_rows, R, act, slope, hw_scale,
                                gate_max, s);
}

const char* locate_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
