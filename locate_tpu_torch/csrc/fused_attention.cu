// Location-attention gate, softmax and sigmoid, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the six TPU kernels of locate_tpu/ops/pallas/fused_attention.py:
//   * _softmax_stats_kernel (:152)  -> softmax_stats_partial + softmax_stats_merge;
//                                      bf16 at (C, Hd, Cout) = (64, 16, 64):
//                                      softmax_stats_mma (the tensor cores)
//                                      + softmax_stats_merge
//   * _softmax_apply_kernel (:179)  -> softmax_apply; bf16 at (64, 16, 64):
//                                      softmax_apply_mma
//   * _softmax_csum_kernel  (:358)  -> softmax_csum_partial + reduce_partials;
//                                      bf16 at (64, 16, 64): softmax_csum_mma
//                                      + reduce_partials
//   * _bwd_kernel_softmax   (:397, body _bwd_body :408)
//                                   -> softmax_bwd + reduce_partials (twice);
//                                      bf16 at (C, Hd, Cout) = (64, 16, 64):
//                                      softmax_bwd_mma (the tensor cores);
//                                      bf16 at (512, 128, 512):
//                                      softmax_bwd_wide_mma +
//                                      gate_wgrad_wide_mma + reduce_partials
//   * _sigmoid_kernel       (:145)  -> sigmoid_gate; bf16 at (512, 128, 512):
//                                      sigmoid_gate_wide_mma
//   * _bwd_kernel_sigmoid   (:387, body _bwd_body :408)
//                                   -> sigmoid_bwd + reduce_partials (twice);
//                                      bf16 at (64, 16, 64): sigmoid_bwd_mma;
//                                      at (512, 128, 512):
//                                      sigmoid_bwd_wide_mma +
//                                      gate_wgrad_wide_mma + reduce_partials
// (softmax_stats_merge and reduce_partials live in common.cuh, which the
// fused-stage kernels share.) The sigmoid gate g = 2 sigmoid(l) is local to
// a location, so its forward is one pass (the apply pass with g in place of
// the softmax) and its backward is softmax_bwd's body with
// dl = 2p(1 - p) * mask * dg, p = sigmoid(l), in place of the softmax
// Jacobian: no statistics, no csum pass.
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
// read x once (2*N*HW*C bytes in bf16), the apply pass and the sigmoid
// gate must read x and write y, csum reads x and dy, bwd (either gate)
// reads x and dy and writes dx; the gate
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
// weights would not fit in shared memory as f32). These simt kernels use
// no tensor cores; the bf16 route of the softmax gate's passes does at the
// gate width of the 64-channel stages (softmax_bwd_mma and
// sigmoid_bwd_mma, on one body, gate_bwd_mma, below; softmax_stats_mma,
// softmax_apply_mma and softmax_csum_mma, on one body, gate_fwd_mma, on the
// same logit core), and the backward's and the sigmoid gate's at the
// 512-channel stages (the two passes of gate_bwd_wide, and
// sigmoid_gate_wide_mma on the sigmoid backward's logit code, further
// below).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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

// y = x * g for the tile's rows, from the gates in L.ls and x in L.xs.
template <typename T>
__device__ void store_gated(const Tile& L, T* __restrict__ y, int n, int HW, int t0,
                            int rows, int C, int Cout) {
  T* dst = y + ((size_t)n * HW + t0) * C;
  const bool broadcast = Cout == 1;
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int t = i / C, c = i - t * C;
    const float g = L.ls[t * Cout + (broadcast ? 0 : c)];
    dst[i] = from_f32<T>(L.xs[c * L.ldt + t] * g);
  }
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
  store_gated<T>(L, y, n, HW, t0, rows, C, Cout);
}

// Sigmoid gate, one pass: grid (tiles, N). y = x * min(2 sigmoid(l), gate_max).
template <typename T>
__global__ void __launch_bounds__(kThreads) sigmoid_gate(
    const T* __restrict__ x, const float* __restrict__ pp, const T* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ w2, const float* __restrict__ b2,
    T* __restrict__ y, int HW, int C, int Hd, int Cout, int T_rows, int act, float slope,
    float gate_max) {
  extern __shared__ __align__(16) float smem[];
  const Tile L = make_tile(smem, C, Hd, Cout, T_rows);
  const int tile = blockIdx.x, n = blockIdx.y;
  const int t0 = tile * T_rows;
  const int rows = min(T_rows, HW - t0);
  const int rows4 = (rows + 3) & ~3;
  tile_logits<T>(x, pp, w1, b1, w2, b2, n, t0, rows, rows4, HW, C, Hd, Cout, act,
                 slope, L);
  for (int o = threadIdx.x; o < rows * Cout; o += blockDim.x)
    L.ls[o] = sigmoid_gate_of(L.ls[o], gate_max);
  __syncthreads();
  store_gated<T>(L, y, n, HW, t0, rows, C, Cout);
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
// S selects the gate (_bwd_body's two modes): softmax, dl = g * mask * dg -
// (g / HW) * c from m, se and c; or sigmoid, dl = 2p(1 - p) * mask * dg
// with p = sigmoid(l) and g = 2p, where m, se and c are unused.
template <typename T, bool S>
__device__ __forceinline__ void gate_bwd(
    float* smem, const T* __restrict__ x, const T* __restrict__ dy,
    const float* __restrict__ pp, const T* __restrict__ w1, const float* __restrict__ b1,
    const T* __restrict__ w2, const float* __restrict__ b2, const float* __restrict__ m,
    const float* __restrict__ se, const float* __restrict__ csum, T* __restrict__ dx,
    float* __restrict__ part_w, float* __restrict__ part_pp, int N, int HW, int C, int Hd,
    int Cout, int T_rows, int R, int act, float slope, float hw_scale, float gate_max) {
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
    for (int o = threadIdx.x; o < rows4 * Cout; o += blockDim.x) {
      const int t = o / Cout, co = o - t * Cout;
      if (t >= rows) {
        L.ls[o] = 0.f;
        gs[o] = 0.f;
        continue;
      }
      const size_t s = (size_t)n * Cout + co;
      const float p = S ? logistic(L.ls[o]) : 0.f;
      const float g = S ? 2.f * p : expf(L.ls[o] - m[s]) / se[s] * hw_scale;
      const size_t i = (row0 + t) * C + co;
      float dg = broadcast ? dgr[t] : to_f32(x[i]) * to_f32(dy[i]);
      float ghat = g;
      if (gate_max > 0.f) {
        dg *= g <= gate_max ? 1.f : 0.f;
        if (g > gate_max) ghat = gate_max;
      }
      L.ls[o] = S ? 2.f * p * (1.f - p) * dg : g * dg - (g / hw_scale) * csum[s];
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

template <typename T>
__global__ void __launch_bounds__(kThreads) softmax_bwd(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ pp,
    const T* __restrict__ w1, const float* __restrict__ b1, const T* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ m, const float* __restrict__ se,
    const float* __restrict__ csum, T* __restrict__ dx, float* __restrict__ part_w,
    float* __restrict__ part_pp, int N, int HW, int C, int Hd, int Cout, int T_rows,
    int R, int act, float slope, float hw_scale, float gate_max) {
  extern __shared__ __align__(16) float smem[];
  gate_bwd<T, false>(smem, x, dy, pp, w1, b1, w2, b2, m, se, csum, dx, part_w, part_pp, N,
                     HW, C, Hd, Cout, T_rows, R, act, slope, hw_scale, gate_max);
}

// The sigmoid gate's backward, one pass: softmax_bwd's grid, tiles and
// workspace slices, without the softmax statistics and c.
template <typename T>
__global__ void __launch_bounds__(kThreads) sigmoid_bwd(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ pp,
    const T* __restrict__ w1, const float* __restrict__ b1, const T* __restrict__ w2,
    const float* __restrict__ b2, T* __restrict__ dx, float* __restrict__ part_w,
    float* __restrict__ part_pp, int N, int HW, int C, int Hd, int Cout, int T_rows,
    int R, int act, float slope, float gate_max) {
  extern __shared__ __align__(16) float smem[];
  gate_bwd<T, true>(smem, x, dy, pp, w1, b1, w2, b2, nullptr, nullptr, nullptr, dx, part_w,
                    part_pp, N, HW, C, Hd, Cout, T_rows, R, act, slope, 1.f, gate_max);
}

// ---- the gate backward on the tensor cores: bf16 at (C, Hd, Cout) = (64, 16, 64) ----
//
// gate_bwd_mma<S> computes what gate_bwd<bf16, S> computes, with its
// rounding points (h, dl and du rounded to bf16 before their products, dx
// rounded once, the weight gradients f32 sums), on mma.sync m16n8k16 (bf16
// operands through ldmatrix, f32 accumulators). Two kernels wrap it, as
// softmax_bwd and sigmoid_bwd wrap gate_bwd: softmax_bwd_mma (S false) and
// sigmoid_bwd_mma (S true, which reads no m, se or c). Grid (HW / 128, nb):
// block (tile, b) owns 128 locations and the batch rows b R .. b R + R - 1,
// as gate_bwd's grid does with a 128-location tile. Each of its 8 warps owns
// 16 consecutive locations and works alone until the block's end:
//   * x and dy of its 16 locations come by cp.async as bf16 [16][64 + 8],
//     the next batch row's a row ahead (two stages);
//   * u, h and l by gate_mlp_mma (the fused stage's gate core), act'(u)
//     from u;
//   * dl element-wise in l's C fragments: softmax, g = exp(l - m) / se HW
//     and dl = g mask dg - (g / HW) c, with m, se and c of (n, channel) read
//     once a row; sigmoid, p = logistic(l), g = 2p and dl = 2p(1 - p) mask
//     dg; mask is g <= gate_max. dl_cd as A fragments into du = act'(u)
//     (dl_cd W2^T), 4 k-steps into 2 n-tiles of Hd;
//   * dx = min(g, gate_max) dy + du_cd W1x^T: the accumulators start at
//     min(g, gate_max) dy, one k-step into 8 n-tiles of C; rounded once,
//     staged over dy and written with 16-byte stores;
//   * dW1x += x^T du_cd and dW2 += h^T dl_cd take the locations as k: h,
//     dl_cd and du_cd are staged per warp and read back, like x, by
//     ldmatrix.trans; the sums stay in registers (32 + 32 f32 a lane) over
//     the block's rows, beside db1 = sum du and db2 = sum dl (f32, summed
//     over the 16 locations by warp shuffles) and the warp's 16 x 16 of
//     dpos_proj;
//   * at the end the 8 warps' sums are added in a fixed order through
//     shared memory into the block's slice of part_w ([dW1x | dW2 | db1 |
//     db2], gate_bwd's layout, which launch_reduce sums), and dpos_proj
//     goes to the batch group's slice of part_pp. One owner per output and
//     no atomics: two runs are bitwise equal.
// Registers bound it to one block (8 warps) an SM; the prefetch a row ahead
// keeps 4 KB a warp in flight. Each instance is sized by its own occupancy
// (locate_softmax_bwd_mma_blocks_per_sm).
constexpr int kGateC = 64, kGateCout = 64;  // the template's widths (Hd: kGateHd)
constexpr int kBwdTile = 128;               // locations a block, 16 a warp
constexpr int kBwdWarps = kBwdTile / 16;
constexpr int kLX = kGateC + 8, kLH = kGateHd + 8, kLO = kGateCout + 8;
// bf16 of a warp's region: x and dy (two stages each), h, dl_cd, du_cd
constexpr int kWarpElems = 2 * 2 * 16 * kLX + 16 * kLH + 16 * kLO + 16 * kLH;
constexpr int kWTot = kGateC * kGateHd + kGateHd * kGateCout + kGateHd + kGateCout;
static_assert(kBwdWarps * 32 == kThreads, "a warp for each 16 locations of the tile");
static_assert(kWarpElems * sizeof(bf16) >= kWTot * sizeof(float),
              "a warp's sums must fit in its region");

__host__ __device__ constexpr size_t bwd_mma_bytes() {
  return (size_t)(kGateC * kLH + kGateHd * kLO + kBwdWarps * kWarpElems) * sizeof(bf16);
}

// x of a warp's 16 locations (rows row0.. of the (N HW, C) tensor) into
// Xs [16][kLX], by cp.async; the caller commits.
__device__ __forceinline__ void fetch_x(const bf16* __restrict__ x, size_t row0, bf16* Xs) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = lane + 32 * k, r = e >> 3, ch = (e & 7) << 3;
    cp_async16(Xs + r * kLX + ch, x + (row0 + r) * kGateC + ch, true);
  }
}

// x and dy of a warp's 16 locations into Xs and Ds; the caller commits.
__device__ __forceinline__ void fetch_rows(const bf16* __restrict__ x,
                                           const bf16* __restrict__ dy, size_t row0, bf16* Xs,
                                           bf16* Ds) {
  fetch_x(x, row0, Xs);
  fetch_x(dy, row0, Ds);
}

// the sum of v over the 8 lanes of one lane % 4 (the 16 locations of a
// C fragment, once v holds a lane's two), in a fixed order
__device__ __forceinline__ float sum_locations(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// S: the sigmoid gate (m, se and csum unused, hw_scale 1), else the softmax.
template <bool S>
__device__ __forceinline__ void gate_bwd_mma(
    const bf16* __restrict__ x, const bf16* __restrict__ dy, const float* __restrict__ pp,
    const bf16* __restrict__ w1, const float* __restrict__ b1, const bf16* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ m, const float* __restrict__ se,
    const float* __restrict__ csum, bf16* __restrict__ dx, float* __restrict__ part_w,
    float* __restrict__ part_pp, int N, int HW, int R, int act, float slope, float hw_scale,
    float gate_max) {
  extern __shared__ float4 smem4[];
  bf16* W1s = reinterpret_cast<bf16*>(smem4);  // [C][kLH]
  bf16* W2s = W1s + kGateC * kLH;              // [Hd][kLO]
  bf16* region = W2s + kGateHd * kLO;          // [warps][kWarpElems]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 2, col = 2 * (lane & 3);
  bf16* Xb = region + warp * kWarpElems;  // [2][16][kLX] x
  bf16* Db = Xb + 2 * 16 * kLX;           // [2][16][kLX] dy, then dx
  bf16* Hs = Db + 2 * 16 * kLX;           // [16][kLH] h
  bf16* DLs = Hs + 16 * kLH;              // [16][kLO] dl_cd
  bf16* DUs = DLs + 16 * kLO;             // [16][kLH] du_cd

  const int tile = blockIdx.x, b = blockIdx.y, tiles = gridDim.x;
  const int loc0 = tile * kBwdTile + 16 * warp;  // the warp's first location
  const int n0 = b * R, rows = min(R, N - n0);
  if (rows > 0) fetch_rows(x, dy, (size_t)n0 * HW + loc0, Xb, Db);
  cp_async_commit();
  stage_rows(W1s, w1, kGateC, kGateHd, kLH);
  stage_rows(W2s, w2, kGateHd, kGateCout, kLO);
  __syncthreads();

  float dw1[4][2][4], dw2[8][4], dpos[2][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) zero(dw1[mt]);
  zero(dw2);
  zero(dpos);
  float db1[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, db2[2] = {0.f, 0.f};
  const float inv_hw = 1.f / hw_scale;
  const float* ppl = pp + (size_t)(loc0 + q) * kGateHd;
  // ldmatrix.trans rows and columns: A = (x or h)^T, channels by locations;
  // B = (du_cd or dl_cd), locations by columns
  const int ka = (lane & 7) + ((lane >> 4) << 3), ac = ((lane >> 3) & 1) << 3;
  const int kb = (lane & 7) + (((lane >> 3) & 1) << 3), bc = (lane >> 4) << 3;

  for (int r = 0; r < rows; ++r) {
    const int n = n0 + r;
    const bf16* Xs = Xb + (r & 1) * 16 * kLX;
    bf16* Ds = Db + (r & 1) * 16 * kLX;
    if (r + 1 < rows)
      fetch_rows(x, dy, (size_t)(n + 1) * HW + loc0, Xb + ((r + 1) & 1) * 16 * kLX,
                 Db + ((r + 1) & 1) * 16 * kLX);
    cp_async_commit();
    cp_async_wait_one();  // this row's x and dy
    __syncwarp();

    // 1. u, h, l; h staged for dW2
    float u[2][4], h[2][4], l[8][4];
    {
      uint32_t xa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) frag_a(xa[kk], Xs, kLX, 0, kk * 16);
      gate_mlp_mma<4, 8>(xa, W1s, W2s, ppl, ppl + 8 * kGateHd, b1, b2, act, slope, u, h, l);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(Hs + (q + 8 * hh) * kLH + nt * 8 + col) =
            pack_bf16(h[nt][2 * hh], h[nt][2 * hh + 1]);

    // 2. dl (into l) and min(g, gate_max) dy (gd, dx's first term); db2
    float gd[8][4];
    const size_t s0 = (size_t)n * kGateCout + col;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float2 mv = make_float2(0.f, 0.f), sv = mv, cv = mv;
      if (!S) {
        mv = *reinterpret_cast<const float2*>(m + s0 + nt * 8);
        sv = *reinterpret_cast<const float2*>(se + s0 + nt * 8);
        cv = *reinterpret_cast<const float2*>(csum + s0 + nt * 8);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int o = (q + 8 * hh) * kLX + nt * 8 + col;
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Xs + o));
        const float2 dv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Ds + o));
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int e = 2 * hh + e1;
          const float de = e1 ? dv.y : dv.x;
          const float p = S ? logistic(l[nt][e]) : 0.f;
          const float g = S ? 2.f * p : expf(l[nt][e] - (e1 ? mv.y : mv.x)) /
                                            (e1 ? sv.y : sv.x) * hw_scale;
          float dg = (e1 ? xv.y : xv.x) * de;
          float ghat = g;
          if (gate_max > 0.f) {
            dg *= g <= gate_max ? 1.f : 0.f;
            if (g > gate_max) ghat = gate_max;
          }
          l[nt][e] = S ? 2.f * p * (1.f - p) * dg : g * dg - (g * inv_hw) * (e1 ? cv.y : cv.x);
          gd[nt][e] = ghat * de;
        }
      }
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const float v = sum_locations(l[nt][e1] + l[nt][2 + e1]);
        if (nt == q) db2[e1] += v;  // this lane keeps channels q * 8 + col, + 1
      }
    }
    uint32_t dla[4][4];
    to_a_frags(dla, l);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f)  // f: (row q or q + 8) x (n-tile 2kk or 2kk + 1)
        *reinterpret_cast<uint32_t*>(DLs + (q + 8 * (f & 1)) * kLO + (2 * kk + (f >> 1)) * 8 +
                                     col) = dla[kk][f];

    // 3. du = act'(u) (dl_cd W2^T); db1, dpos_proj; du_cd staged for dW1x
    float du[2][4];
    zero(du);
    mma_nk<4, 2>(du, dla, W2s, kLO);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        du[nt][e] *= activate_grad(u[nt][e], act, slope);
        dpos[nt][e] += du[nt][e];
      }
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) db1[nt][e1] += sum_locations(du[nt][e1] + du[nt][2 + e1]);
    }
    const uint32_t dua[1][4] = {{pack_bf16(du[0][0], du[0][1]), pack_bf16(du[0][2], du[0][3]),
                                 pack_bf16(du[1][0], du[1][1]), pack_bf16(du[1][2], du[1][3])}};
#pragma unroll
    for (int f = 0; f < 4; ++f)
      *reinterpret_cast<uint32_t*>(DUs + (q + 8 * (f & 1)) * kLH + (f >> 1) * 8 + col) =
          dua[0][f];

    // 4. dx = min(g, gate_max) dy + du_cd W1x^T, rounded once, staged over
    //    dy (each lane overwrites only the dy it read)
    mma_nk<1, 8>(gd, dua, W1s, kLH);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(Ds + (q + 8 * hh) * kLX + nt * 8 + col) =
            pack_bf16(gd[nt][2 * hh], gd[nt][2 * hh + 1]);
    __syncwarp();  // h, dl_cd, du_cd and dx staged

    // 5. dW1x += x^T du_cd (4 m-tiles of C), dW2 += h^T dl_cd (8 n-tiles of Cout)
    {
      uint32_t bf[4], af[4];
      ldsm_x4_t(bf, DUs + kb * kLH + bc);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        ldsm_x4_t(af, Xs + ka * kLX + mt * 16 + ac);
        mma16816(dw1[mt][0], af, bf[0], bf[1]);
        mma16816(dw1[mt][1], af, bf[2], bf[3]);
      }
      ldsm_x4_t(af, Hs + ka * kLH + ac);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        ldsm_x4_t(bf, DLs + kb * kLO + bc + np * 16);
        mma16816(dw2[2 * np], af, bf[0], bf[1]);
        mma16816(dw2[2 * np + 1], af, bf[2], bf[3]);
      }
    }

    // 6. dx out, 16 bytes a lane a store, the 16 rows contiguous
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = lane + 32 * k, rr = e >> 3, ch = (e & 7) << 3;
      *reinterpret_cast<uint4*>(dx + ((size_t)n * HW + loc0 + rr) * kGateC + ch) =
          *reinterpret_cast<const uint4*>(Ds + rr * kLX + ch);
    }
    __syncwarp();  // the fetch of row r + 2 overwrites this stage
  }

  // the warps' sums, [dW1x (C, Hd) | dW2 (Hd, Cout) | db1 | db2] each, then
  // added in warp order into the block's slice of part_w
  cp_async_wait_all();
  __syncthreads();  // every warp is done with its region
  float* red = reinterpret_cast<float*>(region);  // [warps][kWTot]
  float* rw = red + warp * kWTot;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(rw + (mt * 16 + q + 8 * hh) * kGateHd + nt * 8 + col) =
            make_float2(dw1[mt][nt][2 * hh], dw1[mt][nt][2 * hh + 1]);
  float* rw2 = rw + kGateC * kGateHd;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(rw2 + (q + 8 * hh) * kGateCout + nt * 8 + col) =
          make_float2(dw2[nt][2 * hh], dw2[nt][2 * hh + 1]);
  float* rb1 = rw2 + kGateHd * kGateCout;
  if (q == 0) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      *reinterpret_cast<float2*>(rb1 + nt * 8 + col) = make_float2(db1[nt][0], db1[nt][1]);
  }
  *reinterpret_cast<float2*>(rb1 + kGateHd + q * 8 + col) = make_float2(db2[0], db2[1]);
  __syncthreads();
  float* pw = part_w + ((size_t)b * tiles + tile) * kWTot;
  for (int o = threadIdx.x; o < kWTot; o += blockDim.x) {
    float s = red[o];
    for (int w = 1; w < kBwdWarps; ++w) s += red[w * kWTot + o];
    pw[o] = s;
  }
  // the warp's dpos_proj, summed over the block's rows
  float* ppp = part_pp + ((size_t)b * HW + loc0) * kGateHd;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(ppp + (q + 8 * hh) * kGateHd + nt * 8 + col) =
          make_float2(dpos[nt][2 * hh], dpos[nt][2 * hh + 1]);
}

__global__ void __launch_bounds__(kThreads, 1) softmax_bwd_mma(
    const bf16* __restrict__ x, const bf16* __restrict__ dy, const float* __restrict__ pp,
    const bf16* __restrict__ w1, const float* __restrict__ b1, const bf16* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ m, const float* __restrict__ se,
    const float* __restrict__ csum, bf16* __restrict__ dx, float* __restrict__ part_w,
    float* __restrict__ part_pp, int N, int HW, int R, int act, float slope, float hw_scale,
    float gate_max) {
  gate_bwd_mma<false>(x, dy, pp, w1, b1, w2, b2, m, se, csum, dx, part_w, part_pp, N, HW, R, act,
                      slope, hw_scale, gate_max);
}

// The sigmoid gate's backward on the tensor cores: softmax_bwd_mma's grid,
// tiles and workspace slices, without the softmax statistics and c.
__global__ void __launch_bounds__(kThreads, 1) sigmoid_bwd_mma(
    const bf16* __restrict__ x, const bf16* __restrict__ dy, const float* __restrict__ pp,
    const bf16* __restrict__ w1, const float* __restrict__ b1, const bf16* __restrict__ w2,
    const float* __restrict__ b2, bf16* __restrict__ dx, float* __restrict__ part_w,
    float* __restrict__ part_pp, int N, int HW, int R, int act, float slope, float gate_max) {
  gate_bwd_mma<true>(x, dy, pp, w1, b1, w2, b2, nullptr, nullptr, nullptr, dx, part_w, part_pp,
                     N, HW, R, act, slope, 1.f, gate_max);
}

// ---- the softmax gate's forward on the tensor cores: bf16 at (C, Hd, Cout) = (64, 16, 64) ----
//
// gate_fwd_mma<PASS> computes what softmax_stats_partial<bf16> (PASS
// kStatsPass), softmax_apply<bf16> (kApplyPass) and softmax_csum_partial<bf16>
// (kCsumPass) compute, with their rounding points (h rounded to bf16 before
// its product, the gate math in f32, y = (x g) rounded once), on mma.sync
// m16n8k16. Three kernels wrap it: softmax_stats_mma, softmax_apply_mma and
// softmax_csum_mma. Grid (ceil(HW / T_rows), N), T_rows a multiple of 128:
// block (b, n) owns locations b T_rows .. b T_rows + T_rows - 1 of batch
// row n and walks them 128 at a time (a tile). Each of its 8 warps owns 16
// consecutive locations of every tile and works alone until the block's
// end:
//   * x of its 16 locations (and dy beside it, csum) comes by cp.async as
//     bf16 [16][64 + 8], the next tile's a tile ahead (two stages);
//   * u, h and l by gate_mlp_mma, called as gate_bwd_mma calls it (x as 4
//     A fragments, W1x and W2 staged once a block, the rows of pos_proj of
//     the lane's two locations), so l is bit for bit the l of
//     softmax_bwd_mma and of the fused stage's stats pass
//     (gate_logits_mma): at this width the forward's m and se, the
//     backward's c and g and the fused stage's statistics come from one l;
//   * stats: per channel, the (max, sum-exp) of l over the warp's 16
//     locations, in l's C-fragment layout: each lane's pair over its two
//     locations, then a butterfly of warp shuffles in a fixed order
//     (reduce_scatter_stats) that merges the 8 lanes of a channel while it
//     halves the channels a lane holds, so that the lane that keeps the
//     channel (as db2 in gate_bwd_mma) ends with it after 14 merges of 28
//     shuffles, each merge one exp (merge_stats); that lane folds the pair
//     into its running (max, sum-exp) over the block's tiles; at the end
//     the 8 warps' pairs are merged in warp order through shared memory
//     into the block's entry of part_m / part_s, (N, blocks, Cout), which
//     softmax_stats_merge folds as it folds the simt kernel's tiles. Issue
//     slots, not bytes, bound this pass: with an all-reduce a channel (96
//     shuffles and 64 exps a lane a tile) it took as long as the apply
//     pass, which moves twice its bytes;
//   * apply: g = min(exp(l - m) / se HW, gate_max) on l's C fragments,
//     with m and se of the block's row staged once; y = (x g)_bf16, x read
//     from the staged tile, y staged over it (each lane overwrites only
//     the x it read) and written with 16-byte stores;
//   * csum: g = exp(l - m) / se HW (gate_bwd_mma's expression, in its
//     order) and g mask (x dy), mask = [g <= gate_max], on l's C fragments
//     with m and se staged as apply stages them; summed over the lane's two
//     locations, then over the 8 lanes of a channel by the stats pass's
//     butterfly with adds for merges (reduce_scatter_sums), into the
//     lane's running sum over the block's tiles; at the end the 8 warps'
//     sums are added in warp order through shared memory into the block's
//     entry of part_c, (N, blocks, Cout), which reduce_partials sums as it
//     sums the simt kernel's tiles. x and dy in flight double a warp's
//     region (78 KB a block): two blocks an SM.
// One owner per output and no atomics: two runs are bitwise equal. Bound:
// bytes, as the simt kernels' (stats reads x once, apply reads x and
// writes y, csum reads x and dy); the gate MLP is 16 HMMA a warp a tile.
// The grid is about one wave (ops/fused_attention.py:fwd_mma_rows, from
// locate_softmax_fwd_mma_blocks_per_sm).
enum FwdPass { kStatsPass = 0, kApplyPass = 1, kCsumPass = 2 };
constexpr int kFwdStage = 16 * kLX;  // bf16 of a warp's x tile, [16][kLX]
constexpr int kFwdBlocks = 3;        // blocks an SM the stats and apply passes are built for
constexpr int kCsumBlocks = 2;       // and the csum pass, whose stages hold x and dy
static_assert(kBwdWarps * 2 * kFwdStage * sizeof(bf16) >= kBwdWarps * kGateCout * sizeof(float2),
              "the warps' statistics must fit in their regions");

// bf16 of one of a warp's two stages: its x tile, and dy's beside it (csum)
__host__ __device__ constexpr int fwd_stage_elems(int pass) {
  return (pass == kCsumPass ? 2 : 1) * kFwdStage;
}

__host__ __device__ constexpr size_t fwd_mma_bytes(int pass) {
  return (size_t)(kGateC * kLH + kGateHd * kLO + kBwdWarps * 2 * fwd_stage_elems(pass)) *
             sizeof(bf16) +
         2 * kGateCout * sizeof(float);
}

// (m, s) <- the merge of the softmax statistics (m, s) and (m2, s2), (max,
// sum-exp) pairs, with one exp: the sum of the larger max is kept as it is
__device__ __forceinline__ void merge_stats(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2), e = expf(fminf(m, m2) - mx);
  s = m2 > m ? s2 + s * e : s + s2 * e;
  m = mx;
}

// The (max, sum-exp) over the 8 lanes of one lane % 4 (a C fragment's 16
// locations) of each of a lane's 16 channels, pm and ps [n-tile][column]
// holding the lane's pairs: three butterfly steps (lane bits 16, 8, 4)
// each merge a lane's pairs with its partner's while halving the n-tiles
// it keeps (the upper half to the lane with the bit set), so that lane
// (q, col) ends with n-tile q, channels q * 8 + col + e1, in pm[0][e1],
// ps[0][e1]. 14 merges and 28 shuffles, in a fixed order.
__device__ __forceinline__ void reduce_scatter_stats(float (&pm)[8][2], float (&ps)[8][2]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int step = 0; step < 3; ++step) {
    const int half = 4 >> step, bit = 16 >> step;
    const bool upper = lane & bit;
#pragma unroll
    for (int nt = 0; nt < half; ++nt)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        // send the half the partner keeps, keep the other
        const float om = __shfl_xor_sync(0xffffffffu, upper ? pm[nt][e1] : pm[nt + half][e1], bit);
        const float os = __shfl_xor_sync(0xffffffffu, upper ? ps[nt][e1] : ps[nt + half][e1], bit);
        float km = upper ? pm[nt + half][e1] : pm[nt][e1];
        float ks = upper ? ps[nt + half][e1] : ps[nt][e1];
        merge_stats(km, ks, om, os);
        pm[nt][e1] = km;
        ps[nt][e1] = ks;
      }
  }
}

// The sums over the 8 lanes of one lane % 4 of each of a lane's 16
// channels, v [n-tile][column] holding the lane's: reduce_scatter_stats'
// butterfly with an add for each merge, so that lane (q, col) ends with
// n-tile q, channels q * 8 + col + e1, in v[0][e1]. 14 adds and 14
// shuffles, in a fixed order.
__device__ __forceinline__ void reduce_scatter_sums(float (&v)[8][2]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int step = 0; step < 3; ++step) {
    const int half = 4 >> step, bit = 16 >> step;
    const bool upper = lane & bit;
#pragma unroll
    for (int nt = 0; nt < half; ++nt)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const float o = __shfl_xor_sync(0xffffffffu, upper ? v[nt][e1] : v[nt + half][e1], bit);
        v[nt][e1] = (upper ? v[nt + half][e1] : v[nt][e1]) + o;
      }
  }
}

// PASS: kStatsPass writes the statistics (dy, m, se, y unused, hw_scale
// and gate_max too); kApplyPass y from m and se (dy, part_m, part_s
// unused); kCsumPass c's partials into part_m from dy, m and se (y,
// part_s unused).
template <int PASS>
__device__ __forceinline__ void gate_fwd_mma(
    const bf16* __restrict__ x, const bf16* __restrict__ dy, const float* __restrict__ pp,
    const bf16* __restrict__ w1, const float* __restrict__ b1, const bf16* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ m, const float* __restrict__ se,
    bf16* __restrict__ y, float* __restrict__ part_m, float* __restrict__ part_s, int HW,
    int T_rows, int act, float slope, float hw_scale, float gate_max) {
  constexpr bool kCsum = PASS == kCsumPass;
  constexpr int kStage = fwd_stage_elems(PASS);
  extern __shared__ float4 smem4[];
  bf16* W1s = reinterpret_cast<bf16*>(smem4);  // [C][kLH]
  bf16* W2s = W1s + kGateC * kLH;              // [Hd][kLO]
  bf16* region = W2s + kGateHd * kLO;          // [warps][2][kStage]: x (and dy) [16][kLX]
  float* Ms = reinterpret_cast<float*>(region + kBwdWarps * 2 * kStage);  // m, then se [Cout]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 2, col = 2 * (lane & 3);
  bf16* Xb = region + warp * 2 * kStage;
  const int n = blockIdx.y, t0 = blockIdx.x * T_rows;
  const int tiles = min(T_rows, HW - t0) / kBwdTile;
  const size_t row0 = (size_t)n * HW + t0 + 16 * warp;  // the warp's first row of tile 0
  if (tiles > 0) {
    if constexpr (kCsum)
      fetch_rows(x, dy, row0, Xb, Xb + kFwdStage);
    else
      fetch_x(x, row0, Xb);
  }
  cp_async_commit();
  stage_rows(W1s, w1, kGateC, kGateHd, kLH);
  stage_rows(W2s, w2, kGateHd, kGateCout, kLO);
  if constexpr (PASS != kStatsPass)
    for (int i = threadIdx.x; i < kGateCout; i += blockDim.x) {
      Ms[i] = m[(size_t)n * kGateCout + i];
      Ms[kGateCout + i] = se[(size_t)n * kGateCout + i];
    }
  __syncthreads();

  // this lane's running (max, sum-exp), or sum (csum), of channels q * 8 +
  // col and + 1
  float rm[2] = {-INFINITY, -INFINITY}, rs[2] = {0.f, 0.f};
  for (int k = 0; k < tiles; ++k) {
    bf16* Xs = Xb + (k & 1) * kStage;
    if (k + 1 < tiles) {
      const size_t next = row0 + (size_t)(k + 1) * kBwdTile;
      bf16* Xn = Xb + ((k + 1) & 1) * kStage;
      if constexpr (kCsum)
        fetch_rows(x, dy, next, Xn, Xn + kFwdStage);
      else
        fetch_x(x, next, Xn);
    }
    cp_async_commit();
    cp_async_wait_one();  // this tile's x (and dy)
    __syncwarp();

    const float* ppl = pp + (size_t)(t0 + k * kBwdTile + 16 * warp + q) * kGateHd;
    float u[2][4], h[2][4], l[8][4];
    {
      uint32_t xa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) frag_a(xa[kk], Xs, kLX, 0, kk * 16);
      gate_mlp_mma<4, 8>(xa, W1s, W2s, ppl, ppl + 8 * kGateHd, b1, b2, act, slope, u, h, l);
    }
    if constexpr (PASS == kApplyPass) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 mv = *reinterpret_cast<const float2*>(Ms + nt * 8 + col);
        const float2 sv = *reinterpret_cast<const float2*>(Ms + kGateCout + nt * 8 + col);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          uint32_t* p = reinterpret_cast<uint32_t*>(Xs + (q + 8 * hh) * kLX + nt * 8 + col);
          const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
          float g0 = expf(l[nt][2 * hh] - mv.x) / sv.x * hw_scale;
          float g1 = expf(l[nt][2 * hh + 1] - mv.y) / sv.y * hw_scale;
          if (gate_max > 0.f) {
            if (g0 > gate_max) g0 = gate_max;
            if (g1 > gate_max) g1 = gate_max;
          }
          *p = pack_bf16(xv.x * g0, xv.y * g1);
        }
      }
      __syncwarp();  // y staged
      // y out, 16 bytes a lane a store, the 16 rows contiguous
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const int e = lane + 32 * kq, rr = e >> 3, ch = (e & 7) << 3;
        *reinterpret_cast<uint4*>(y + (row0 + (size_t)k * kBwdTile + rr) * kGateC + ch) =
            *reinterpret_cast<const uint4*>(Xs + rr * kLX + ch);
      }
    } else if constexpr (kCsum) {
      const bf16* Ds = Xs + kFwdStage;
      float v[8][2];  // the lane's g mask dg, summed over its locations q and q + 8
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 mv = *reinterpret_cast<const float2*>(Ms + nt * 8 + col);
        const float2 sv = *reinterpret_cast<const float2*>(Ms + kGateCout + nt * 8 + col);
        float t[2][2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int o = (q + 8 * hh) * kLX + nt * 8 + col;
          const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Xs + o));
          const float2 dv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Ds + o));
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const float g = expf(l[nt][2 * hh + e1] - (e1 ? mv.y : mv.x)) /
                            (e1 ? sv.y : sv.x) * hw_scale;
            float dg = (e1 ? xv.y : xv.x) * (e1 ? dv.y : dv.x);
            if (gate_max > 0.f) dg *= g <= gate_max ? 1.f : 0.f;
            t[hh][e1] = g * dg;
          }
        }
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) v[nt][e1] = t[0][e1] + t[1][e1];
      }
      reduce_scatter_sums(v);
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) rs[e1] += v[0][e1];
    } else {
      float pm[8][2], ps[8][2];  // the lane's pairs over its locations q and q + 8
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          pm[nt][e1] = l[nt][e1];
          ps[nt][e1] = 1.f;
          merge_stats(pm[nt][e1], ps[nt][e1], l[nt][2 + e1], 1.f);
        }
      reduce_scatter_stats(pm, ps);
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) merge_stats(rm[e1], rs[e1], pm[0][e1], ps[0][e1]);
    }
    __syncwarp();  // the fetch of tile k + 2 overwrites this stage
  }
  if constexpr (PASS == kApplyPass) return;

  cp_async_wait_all();
  __syncthreads();  // every warp is done with its region
  if constexpr (kCsum) {
    // the block's c: the warps' sums, added in warp order
    float* Cs = reinterpret_cast<float*>(region);  // [warps][Cout]
    Cs[warp * kGateCout + q * 8 + col] = rs[0];
    Cs[warp * kGateCout + q * 8 + col + 1] = rs[1];
    __syncthreads();
    for (int c = threadIdx.x; c < kGateCout; c += blockDim.x) {
      float s = Cs[c];
      for (int w = 1; w < kBwdWarps; ++w) s += Cs[w * kGateCout + c];
      part_m[((size_t)n * gridDim.x + blockIdx.x) * kGateCout + c] = s;
    }
  } else {
    // the block's statistics: the warps' pairs, merged in warp order
    float2* St = reinterpret_cast<float2*>(region);  // [warps][Cout]
    St[warp * kGateCout + q * 8 + col] = make_float2(rm[0], rs[0]);
    St[warp * kGateCout + q * 8 + col + 1] = make_float2(rm[1], rs[1]);
    __syncthreads();
    for (int c = threadIdx.x; c < kGateCout; c += blockDim.x) {
      float mm = St[c].x, s = St[c].y;
      for (int w = 1; w < kBwdWarps; ++w)
        merge_stats(mm, s, St[w * kGateCout + c].x, St[w * kGateCout + c].y);
      const size_t off = ((size_t)n * gridDim.x + blockIdx.x) * kGateCout + c;
      part_m[off] = mm;
      part_s[off] = s;
    }
  }
}

// Stats pass, part 1, on the tensor cores: the block's (max, sum-exp) per
// channel into part_m / part_s, (N, blocks, Cout).
__global__ void __launch_bounds__(kThreads, kFwdBlocks) softmax_stats_mma(
    const bf16* __restrict__ x, const float* __restrict__ pp, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ part_m, float* __restrict__ part_s, int HW, int T_rows, int act,
    float slope) {
  gate_fwd_mma<kStatsPass>(x, nullptr, pp, w1, b1, w2, b2, nullptr, nullptr, nullptr, part_m,
                           part_s, HW, T_rows, act, slope, 1.f, 0.f);
}

// Apply pass on the tensor cores: y = (x min(exp(l - m) / se HW, gate_max))_bf16.
__global__ void __launch_bounds__(kThreads, kFwdBlocks) softmax_apply_mma(
    const bf16* __restrict__ x, const float* __restrict__ pp, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ m, const float* __restrict__ se, bf16* __restrict__ y, int HW,
    int T_rows, int act, float slope, float hw_scale, float gate_max) {
  gate_fwd_mma<kApplyPass>(x, nullptr, pp, w1, b1, w2, b2, m, se, y, nullptr, nullptr, HW, T_rows,
                           act, slope, hw_scale, gate_max);
}

// Backward pass A, part 1, on the tensor cores: the block's partial c =
// sum_s g mask (x dy) per channel into part_c, (N, blocks, Cout).
__global__ void __launch_bounds__(kThreads, kCsumBlocks) softmax_csum_mma(
    const bf16* __restrict__ x, const bf16* __restrict__ dy, const float* __restrict__ pp,
    const bf16* __restrict__ w1, const float* __restrict__ b1, const bf16* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ m, const float* __restrict__ se,
    float* __restrict__ part_c, int HW, int T_rows, int act, float slope, float hw_scale,
    float gate_max) {
  gate_fwd_mma<kCsumPass>(x, dy, pp, w1, b1, w2, b2, m, se, nullptr, part_c, nullptr, HW, T_rows,
                          act, slope, hw_scale, gate_max);
}

// ---- the gate backward on the tensor cores at the wide gates: bf16 at (C, Hd, Cout) =
//      (512, 128, 512) ----
//
// gate_bwd_mma's plan does not carry over: W1x and W2 are 128 KB of bf16
// each, more than a block's shared memory together, and a 16-location
// m-tile of l or dx is 16 x 512 f32, too wide for a warp's registers; the
// weight gradients (131,072 f32) cannot stay in registers either. So the
// backward runs in two passes, computing what gate_bwd<bf16, S> computes
// with its rounding points (h, dl and du rounded to bf16 before their
// products, dx rounded once, the weight gradients f32 sums, db1, db2 and
// dpos_proj sums of the unrounded f32 du and dl):
//
// 1. The location pass, softmax_bwd_wide_mma (S false) or
//    sigmoid_bwd_wide_mma (S true, no m, se or c), both on gate_bwd_wide<C,
//    HD, CO, S>. Grid ceil(N HW / 32): a block owns 32 consecutive rows of
//    the flattened (N HW) locations, two m-tiles of 16 (HW % 16 == 0, so an
//    m-tile never crosses an image and (n, channel) is row / HW). Each of
//    its 8 warps owns one m-tile and a quarter of every product's columns.
//    x and dy of the 32 rows are staged once by cp.async; the weights
//    stream through a double buffer of 64-wide tiles that all 8 warps read
//    (W1x by rows, then W2 by columns, then W1x by rows again: 24 tiles,
//    each fetched under the previous one's products):
//      * u = x W1x + pos_proj + b1 over C in 8 k-chunks, staged in f32;
//        h = act(u)_bf16 staged for the sweep and written to a scratch;
//      * the Cout sweep, 8 chunks of 64 columns, each W2 chunk read twice:
//        l = h W2 + b2 (a warp: 16 x 16), dl element-wise (softmax: g =
//        exp(l - m) / se HW, dl = g mask dg - (g / HW) c; sigmoid: p =
//        sigmoid(l), g = 2p, dl = 2p(1 - p) mask dg; mask = [g <=
//        gate_max]), dx's first term min(g, gate_max) dy kept in registers
//        (64 f32 a lane over the sweep), db2's partial of the m-tile (f32
//        dl summed over its 16 rows by warp shuffles), dl_bf16 staged and
//        written to a scratch, and dh += dl_bf16 W2^T (a warp: 16 x 32);
//        so l is neither recomputed nor stored: the gate term is the one
//        product of l that dx needs, and it fits in registers;
//      * du = act'(u) dh, written in f32 (for db1 and dpos_proj) and as
//        bf16 (staged, and to a scratch);
//      * the C sweep, 8 chunks: dx = min(g, gate_max) dy + du_bf16
//        W1x^T, rounded once, written from the fragments.
//    The sigmoid's u and l run on the tensor cores (a warp: 16 x 32 of u;
//    each k-step of 16 products from a zero accumulator, summed in f32),
//    in the code its forward runs too (wide_u_mma, wide_h, wide_l_mma).
//    The softmax's u and l run as tile_logits' FMA chains, in its order,
//    on the CUDA cores: its g = exp(l - m) / se HW meets m, se and c from
//    the simt stats and csum passes, and where the gate saturates (D's
//    last stages: |x| up to 4,576 with random weights, |l| ~ 1e4, f32's
//    step there ~1e-3) any other summation order moves g at the argmax by
//    a few per mille, and dx, du and every weight gradient with it (100x
//    the plain version's error on the card), while db2 = c - c stops
//    cancelling. Bit for bit the stats pass's l, the route keeps simt's
//    consistency; 4 of its 6 products stay on the tensor cores.
// 2. The weight-gradient pass, gate_wgrad_wide_mma: dW1x = x^T du_bf16
//    and dW2 = h^T dl_bf16 as products with the N HW locations as k, read
//    by ldmatrix.trans (gate_bwd_mma's fragments). Grid (32 output tiles of
//    64 x 64, splits): k is split over a fixed number of blocks so that
//    the grid fills the card, each split writes its own partial.
// 3. Fixed-order reductions (reduce_partials): the splits' partials into
//    dW1x and dW2, the m-tiles' db2 partials into db2, du over the batch
//    into dpos_proj, and dpos_proj over the locations into db1.
// One owner per output and no atomics: two runs are bitwise equal. The
// workspace is a few MB (the simt kernel's per-block slices: 135 MB at
// (64, 512, 128), N = 64). Bound: bytes, as every pass of the gate. At
// these shapes (N HW = 256 to 4096 rows, 8 to 128 location blocks) a launch
// takes about one location block's time, whatever the grid: its 24 steps
// of weight tiles and, for the softmax, its FMA chains.
template <int C, int HD, int CO>
struct WideGate {
  static constexpr int kRows = 32;   // rows of a location block: two m-tiles
  static constexpr int kChunk = 64;  // columns of a weight tile
  static constexpr int kLX = C + 8, kLH = HD + 8, kLO = kChunk + 8;
  static constexpr int kXChunks = C / kChunk, kOChunks = CO / kChunk;
  static constexpr int kTiles = 2 * kXChunks + kOChunks;
  // a W1x row chunk [kChunk][kLH] or a W2 column chunk [HD][kLO]
  static constexpr int kWBuf = kChunk * kLH > HD * kLO ? kChunk * kLH : HD * kLO;
  static constexpr int kHG = HD / 4;  // the hidden columns a warp owns
  static constexpr int kLU = HD + 4;  // the f32 u tile's row stride
  static constexpr int kWT = C * HD + HD * CO;
  static constexpr size_t bytes =
      (size_t)(2 * kRows * kLX + 2 * kRows * kLH + kRows * kLO + 2 * kWBuf) * sizeof(bf16) +
      (size_t)kRows * kLU * sizeof(float);
  // the sigmoid gate's forward (sigmoid_gate_wide_mma): x (then y), h, the
  // weight tiles and u
  static constexpr size_t fwd_bytes =
      (size_t)(kRows * kLX + kRows * kLH + 2 * kWBuf) * sizeof(bf16) +
      (size_t)kRows * kLU * sizeof(float);
  static_assert(C == CO, "dx's gate term is per channel: Cout = C");
  static_assert(C % kChunk == 0 && HD % 64 == 0 && (kHG / 8) % 2 == 0,
                "64-wide chunks and an even number of hidden n-tiles a warp");
};
constexpr int kWideC = 512, kWideHd = 128, kWideCout = 512;
using Wide = WideGate<kWideC, kWideHd, kWideCout>;
constexpr int kWgRows = 64;  // the locations of a weight-gradient stage

// ROWS x WIDTH bf16 of a row-major matrix (row stride `stride`) into shared
// memory (row stride ld) by cp.async, the block's threads together; the
// caller commits
template <int ROWS, int WIDTH>
__device__ __forceinline__ void fetch_tile(bf16* dst, int ld, const bf16* __restrict__ src,
                                           int stride) {
  constexpr int kChunks = WIDTH / 8;
  for (int e = threadIdx.x; e < ROWS * kChunks; e += blockDim.x) {
    const int r = e / kChunks, c = (e - r * kChunks) * 8;
    cp_async16(dst + r * ld + c, src + (size_t)r * stride + c, true);
  }
}

// weight tile t of the location pass into `buf`: W1x rows for the u chunks
// and the dx chunks, W2 columns for the Cout sweep
template <int C, int HD, int CO>
__device__ __forceinline__ void fetch_weights(int t, bf16* buf, const bf16* __restrict__ w1,
                                              const bf16* __restrict__ w2) {
  using G = WideGate<C, HD, CO>;
  if (t >= G::kXChunks && t < G::kXChunks + G::kOChunks) {
    fetch_tile<HD, G::kChunk>(buf, G::kLO, w2 + (t - G::kXChunks) * G::kChunk, CO);
  } else {
    const int k = t < G::kXChunks ? t : t - G::kXChunks - G::kOChunks;
    fetch_tile<G::kChunk, HD>(buf, G::kLH, w1 + (size_t)k * G::kChunk * HD, HD);
  }
}

// the pipeline's step `step`, whose weight tile is in buffer step & 1:
// fetch tile `next` (none where it is negative) into the buffer the
// previous step left (one commit group a step, empty without a tile), wait
// for this step's tile, and hand it out
template <int C, int HD, int CO>
__device__ __forceinline__ const bf16* next_weights(int step, int next, bf16* Wb,
                                                    const bf16* __restrict__ w1,
                                                    const bf16* __restrict__ w2) {
  using G = WideGate<C, HD, CO>;
  if (next >= 0) fetch_weights<C, HD, CO>(next, Wb + ((step + 1) & 1) * G::kWBuf, w1, w2);
  cp_async_commit();
  cp_async_wait_one();
  __syncthreads();
  return Wb + (step & 1) * G::kWBuf;
}

// the backward's step to weight tile t, the tiles in order
template <int C, int HD, int CO>
__device__ __forceinline__ const bf16* next_weights(int t, bf16* Wb, const bf16* __restrict__ w1,
                                                    const bf16* __restrict__ w2) {
  return next_weights<C, HD, CO>(t, t + 1 < WideGate<C, HD, CO>::kTiles ? t + 1 : -1, Wb, w1, w2);
}

template <int N>
__device__ __forceinline__ void add_to(float (&acc)[N][4], const float (&part)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// The sigmoid gate's logit code at the wide gates, which its forward
// (sigmoid_gate_wide_mma) and its backward's location pass
// (gate_bwd_wide<..., true>) both run, so that the forward's l is the
// backward's bit for bit. A block's 8 warps split its two m-tiles of 16
// rows (warp & 1) and the hidden columns and each 64-column chunk of Cout
// in quarters (warp >> 1), as gate_bwd_wide splits them.
//
// wide_u_mma: u = x W1x + pos_proj + b1 of the warp's m-tile and hidden
// quarter, on the tensor cores, from x staged in Xs [kRows][kLX]: the
// pipeline's steps 0 .. kXChunks - 1 (W1x's row chunks, tile 0 already
// fetched), the last fetching tile `next`; each k-step of 16 products from
// a zero accumulator added to u in f32 (their own accumulation truncates).
// Staged in f32 into Us [kRows][kLU], pos_proj from location s0 on (the
// m-tile's first location; HW % 16 == 0, so it lies in one image).
template <int C, int HD, int CO>
__device__ __forceinline__ void wide_u_mma(const bf16* Xs, bf16* Wb, const bf16* __restrict__ w1,
                                           const bf16* __restrict__ w2,
                                           const float* __restrict__ pp,
                                           const float* __restrict__ b1, float* Us, int s0,
                                           int next) {
  using G = WideGate<C, HD, CO>;
  constexpr int HNT = G::kHG / 8;  // hidden n-tiles a warp owns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 2, col = 2 * (lane & 3);
  const int mt = warp & 1, hc = G::kHG * (warp >> 1);
  float u[HNT][4];
  zero(u);
  for (int t = 0; t < G::kXChunks; ++t) {
    const bf16* W = next_weights<C, HD, CO>(t, t + 1 < G::kXChunks ? t + 1 : next, Wb, w1, w2);
#pragma unroll
    for (int kk = 0; kk < G::kChunk / 16; ++kk) {
      uint32_t xa[1][4];
      frag_a(xa[0], Xs, G::kLX, 16 * mt, t * G::kChunk + kk * 16);
      float part[HNT][4];
      zero(part);
      mma_kn<1, HNT>(part, xa, W + kk * 16 * G::kLH, G::kLH, hc);
      add_to(u, part);
    }
    __syncthreads();  // the next fetch overwrites this buffer
  }
#pragma unroll
  for (int nt = 0; nt < HNT; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int j = hc + nt * 8 + col + e1, s = s0 + q + 8 * hh;
        Us[(16 * mt + q + 8 * hh) * G::kLU + j] = u[nt][2 * hh + e1] + pp[(size_t)s * HD + j] + b1[j];
      }
}

// wide_h: h = act(u)_bf16 of the warp's m-tile and hidden quarter from the
// staged u (after a barrier), into Hs [kRows][kLH] and, where h_cd is set,
// to its rows r0.. (the m-tile's first row of the (N HW, HD) scratch).
template <int C, int HD, int CO>
__device__ __forceinline__ void wide_h(const float* Us, bf16* Hs, bf16* __restrict__ h_cd, int r0,
                                       int act, float slope) {
  using G = WideGate<C, HD, CO>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 2, col = 2 * (lane & 3);
  const int mt = warp & 1, hc = G::kHG * (warp >> 1);
#pragma unroll
  for (int nt = 0; nt < G::kHG / 8; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = hc + nt * 8 + col, rr = 16 * mt + q + 8 * hh;
      const float2 uv = *reinterpret_cast<const float2*>(Us + rr * G::kLU + j);
      const uint32_t hp = pack_bf16(activate(uv.x, act, slope), activate(uv.y, act, slope));
      *reinterpret_cast<uint32_t*>(Hs + rr * G::kLH + j) = hp;
      if (h_cd) *reinterpret_cast<uint32_t*>(h_cd + (size_t)(r0 + q + 8 * hh) * HD + j) = hp;
    }
}

// wide_l_mma: l - b2 of the warp's m-tile at its 16 columns (16 (warp >> 1)
// ..) of the W2 column chunk W [HD][kLO], on the tensor cores from the
// staged h (after a barrier), k-steps summed as u's; b2 is added by the
// caller, in the same expression in both passes.
template <int C, int HD, int CO>
__device__ __forceinline__ void wide_l_mma(float (&l)[2][4], const bf16* Hs, const bf16* W) {
  using G = WideGate<C, HD, CO>;
  const int warp = threadIdx.x >> 5;
  zero(l);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t ha[1][4];
    frag_a(ha[0], Hs, G::kLH, 16 * (warp & 1), kk * 16);
    float part[2][4];
    zero(part);
    mma_kn<1, 2>(part, ha, W + kk * 16 * G::kLO, G::kLO, 16 * (warp >> 1));
    add_to(l, part);
  }
}

// S: the sigmoid gate (m, se and csum unused, hw_scale 1), else the softmax.
// Out: dx, the m-tiles' db2 partials (N HW / 16, CO), and the scratches du
// (f32), h_bf16, du_bf16 (N HW, HD) and dl_bf16 (N HW, CO).
template <int C, int HD, int CO, bool S>
__device__ __forceinline__ void gate_bwd_wide(
    const bf16* __restrict__ x, const bf16* __restrict__ dy, const float* __restrict__ pp,
    const bf16* __restrict__ w1, const float* __restrict__ b1, const bf16* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ m, const float* __restrict__ se,
    const float* __restrict__ csum, bf16* __restrict__ dx, float* __restrict__ db2_part,
    float* __restrict__ du_f32, bf16* __restrict__ h_cd, bf16* __restrict__ du_cd,
    bf16* __restrict__ dl_cd, int N, int HW, int act, float slope, float hw_scale,
    float gate_max) {
  using G = WideGate<C, HD, CO>;
  constexpr int HNT = G::kHG / 8;  // hidden n-tiles a warp owns
  extern __shared__ float4 smem4[];
  bf16* Xs = reinterpret_cast<bf16*>(smem4);  // [kRows][kLX] x
  bf16* Ds = Xs + G::kRows * G::kLX;          // [kRows][kLX] dy
  bf16* Hs = Ds + G::kRows * G::kLX;          // [kRows][kLH] h_bf16
  bf16* DUs = Hs + G::kRows * G::kLH;         // [kRows][kLH] du_bf16
  bf16* DLs = DUs + G::kRows * G::kLH;        // [kRows][kLO] dl_bf16 of a Cout chunk
  bf16* Wb = DLs + G::kRows * G::kLO;         // [2][kWBuf] weight tiles
  float* Us = reinterpret_cast<float*>(Wb + 2 * G::kWBuf);  // [kRows][kLU] u
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 2, col = 2 * (lane & 3);
  const int mt = warp & 1, g = warp >> 1;  // the warp's m-tile and column quarter
  const int M = N * HW, row0 = blockIdx.x * G::kRows;
  const int r0 = row0 + 16 * mt;  // the warp's first row
  const bool live = r0 < M;       // (the last block's second m-tile may lie past the end)
  const int img = live ? r0 / HW : 0;
  const int s0 = live ? r0 - img * HW : 0;  // its first location
  const int hc = G::kHG * g;                // its first hidden column

  for (int e = threadIdx.x; e < G::kRows * (C / 8); e += blockDim.x) {
    const int r = e / (C / 8), ch = (e - r * (C / 8)) * 8;
    const bool ok = row0 + r < M;
    const size_t src = (size_t)(ok ? row0 + r : 0) * C + ch;
    cp_async16(Xs + r * G::kLX + ch, x + src, ok);
    cp_async16(Ds + r * G::kLX + ch, dy + src, ok);
  }
  fetch_weights<C, HD, CO>(0, Wb, w1, w2);  // with x and dy, one group
  cp_async_commit();

  // 1. u = x W1x + pos_proj + b1 (staged in f32 for act'(u)); h =
  //    act(u)_bf16, staged and written
  if constexpr (S) {
    wide_u_mma<C, HD, CO>(Xs, Wb, w1, w2, pp, b1, Us, s0, G::kXChunks);
  } else {
    // tile_logits' FMA chains, in its order: bit for bit the u of the stats
    // and csum passes. A thread owns RT rows x 4 hidden columns.
    constexpr int RT = G::kRows * 32 / kThreads;
    const int rg = threadIdx.x >> 5, hg = lane;
    float ua[RT][4] = {};
    for (int t = 0; t < G::kXChunks; ++t) {
      const bf16* W = next_weights<C, HD, CO>(t, Wb, w1, w2) + 4 * hg;
      const bf16* xr = Xs + RT * rg * G::kLX + t * G::kChunk;
#pragma unroll 8
      for (int k = 0; k < G::kChunk; k += 2) {  // x read in pairs of k
        float2 xv[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r)
          xv[r] = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xr + r * G::kLX + k));
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint2 wv = *reinterpret_cast<const uint2*>(W + (k + kk) * G::kLH);
          const float2 w01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wv.x));
          const float2 w23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wv.y));
          const float w[4] = {w01.x, w01.y, w23.x, w23.y};
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              ua[r][jj] = fmaf(kk ? xv[r].y : xv[r].x, w[jj], ua[r][jj]);
        }
      }
      __syncthreads();  // the next fetch overwrites this buffer
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int row = RT * rg + r, s = row0 + row < M ? (row0 + row) % HW : 0;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        Us[row * G::kLU + 4 * hg + jj] = ua[r][jj] + pp[(size_t)s * HD + 4 * hg + jj] +
                                         b1[4 * hg + jj];
    }
  }
  __syncthreads();  // u staged
  wide_h<C, HD, CO>(Us, Hs, live ? h_cd : nullptr, r0, act, slope);

  // 2. the Cout sweep: l, dl, the gate term of dx, db2, dl_bf16, dh
  float dh[HNT][4], gd[G::kOChunks][2][4];
  zero(dh);
#pragma unroll
  for (int i = 0; i < G::kOChunks; ++i) {
    const bf16* W = next_weights<C, HD, CO>(G::kXChunks + i, Wb, w1, w2);
    float l[2][4];
    if constexpr (S) {
      wide_l_mma<C, HD, CO>(l, Hs, W);
    } else {  // tile_logits' FMA chains, in its order, in l's fragment layout
      zero(l);
      const bf16* hr = Hs + (16 * mt + q) * G::kLH;
      const bf16* wc = W + 16 * g + col;
#pragma unroll 8
      for (int j = 0; j < HD; j += 2) {  // h read in pairs of j
        const float2 h0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hr + j));
        const float2 h1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(hr + 8 * G::kLH + j));
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                wc + (j + jj) * G::kLO + nt * 8));
            const float a = jj ? h0.y : h0.x, b = jj ? h1.y : h1.x;
            l[nt][0] = fmaf(a, w.x, l[nt][0]);
            l[nt][1] = fmaf(a, w.y, l[nt][1]);
            l[nt][2] = fmaf(b, w.x, l[nt][2]);
            l[nt][3] = fmaf(b, w.y, l[nt][3]);
          }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int cc = 16 * g + nt * 8 + col;  // the column in the chunk
      const int co = i * G::kChunk + cc;
      const float2 bv = *reinterpret_cast<const float2*>(b2 + co);
      float2 mv = make_float2(0.f, 0.f), sv = mv, cv = mv;
      if (!S) {
        const size_t st = (size_t)img * CO + co;
        mv = *reinterpret_cast<const float2*>(m + st);
        sv = *reinterpret_cast<const float2*>(se + st);
        cv = *reinterpret_cast<const float2*>(csum + st);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int o = (16 * mt + q + 8 * hh) * G::kLX + co;
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Xs + o));
        const float2 dv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Ds + o));
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int e = 2 * hh + e1;
          const float lv = l[nt][e] + (e1 ? bv.y : bv.x), de = e1 ? dv.y : dv.x;
          const float p = S ? logistic(lv) : 0.f;
          const float gv =
              S ? 2.f * p : expf(lv - (e1 ? mv.y : mv.x)) / (e1 ? sv.y : sv.x) * hw_scale;
          float dg = (e1 ? xv.y : xv.x) * de;
          float ghat = gv;
          if (gate_max > 0.f) {
            dg *= gv <= gate_max ? 1.f : 0.f;
            if (gv > gate_max) ghat = gate_max;
          }
          l[nt][e] = S ? 2.f * p * (1.f - p) * dg
                       : gv * dg - (gv / hw_scale) * (e1 ? cv.y : cv.x);
          gd[i][nt][e] = ghat * de;
        }
      }
      const float v0 = sum_locations(l[nt][0] + l[nt][2]);
      const float v1 = sum_locations(l[nt][1] + l[nt][3]);
      if (live && q == 0)
        *reinterpret_cast<float2*>(db2_part + (size_t)(r0 / 16) * CO + co) = make_float2(v0, v1);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t dp = pack_bf16(l[nt][2 * hh], l[nt][2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(DLs + (16 * mt + q + 8 * hh) * G::kLO + cc) = dp;
        if (live) *reinterpret_cast<uint32_t*>(dl_cd + (size_t)(r0 + q + 8 * hh) * CO + co) = dp;
      }
    }
    __syncthreads();  // the m-tiles' dl_bf16 of the chunk staged
    mma_nk_smem<G::kChunk / 16, HNT>(dh, DLs, G::kLO, 16 * mt, W + hc * G::kLO, G::kLO);
    __syncthreads();  // DLs and this buffer are free again
  }

  // 3. du = act'(u) dh: f32 and bf16 out, bf16 staged for dx
#pragma unroll
  for (int nt = 0; nt < HNT; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = hc + nt * 8 + col, rr = q + 8 * hh;
      const float2 uv = *reinterpret_cast<const float2*>(Us + (16 * mt + rr) * G::kLU + j);
      const float d0 = activate_grad(uv.x, act, slope) * dh[nt][2 * hh];
      const float d1 = activate_grad(uv.y, act, slope) * dh[nt][2 * hh + 1];
      const uint32_t dp = pack_bf16(d0, d1);
      *reinterpret_cast<uint32_t*>(DUs + (16 * mt + rr) * G::kLH + j) = dp;
      if (live) {
        *reinterpret_cast<float2*>(du_f32 + (size_t)(r0 + rr) * HD + j) = make_float2(d0, d1);
        *reinterpret_cast<uint32_t*>(du_cd + (size_t)(r0 + rr) * HD + j) = dp;
      }
    }

  // 4. the C sweep: dx = min(g, gate_max) dy + du_bf16 W1x^T, rounded once
#pragma unroll
  for (int i = 0; i < G::kXChunks; ++i) {
    const bf16* W = next_weights<C, HD, CO>(G::kXChunks + G::kOChunks + i, Wb, w1, w2);
    mma_nk_smem<HD / 16, 2>(gd[i], DUs, G::kLH, 16 * mt, W + 16 * g * G::kLH, G::kLH);
    if (live) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<uint32_t*>(
              dx + (size_t)(r0 + q + 8 * hh) * C + i * G::kChunk + 16 * g + nt * 8 + col) =
              pack_bf16(gd[i][nt][2 * hh], gd[i][nt][2 * hh + 1]);
    }
    __syncthreads();
  }
  cp_async_wait_all();
}

template <int C, int HD, int CO>
__global__ void __launch_bounds__(kThreads, 1) softmax_bwd_wide_mma(
    const bf16* __restrict__ x, const bf16* __restrict__ dy, const float* __restrict__ pp,
    const bf16* __restrict__ w1, const float* __restrict__ b1, const bf16* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ m, const float* __restrict__ se,
    const float* __restrict__ csum, bf16* __restrict__ dx, float* __restrict__ db2_part,
    float* __restrict__ du_f32, bf16* __restrict__ h_cd, bf16* __restrict__ du_cd,
    bf16* __restrict__ dl_cd, int N, int HW, int act, float slope, float hw_scale,
    float gate_max) {
  gate_bwd_wide<C, HD, CO, false>(x, dy, pp, w1, b1, w2, b2, m, se, csum, dx, db2_part, du_f32,
                                  h_cd, du_cd, dl_cd, N, HW, act, slope, hw_scale, gate_max);
}

// The sigmoid gate's location pass: softmax_bwd_wide_mma's grid, tiles
// and scratches, without the softmax statistics and c.
template <int C, int HD, int CO>
__global__ void __launch_bounds__(kThreads, 1) sigmoid_bwd_wide_mma(
    const bf16* __restrict__ x, const bf16* __restrict__ dy, const float* __restrict__ pp,
    const bf16* __restrict__ w1, const float* __restrict__ b1, const bf16* __restrict__ w2,
    const float* __restrict__ b2, bf16* __restrict__ dx, float* __restrict__ db2_part,
    float* __restrict__ du_f32, bf16* __restrict__ h_cd, bf16* __restrict__ du_cd,
    bf16* __restrict__ dl_cd, int N, int HW, int act, float slope, float gate_max) {
  gate_bwd_wide<C, HD, CO, true>(x, dy, pp, w1, b1, w2, b2, nullptr, nullptr, nullptr, dx,
                                 db2_part, du_f32, h_cd, du_cd, dl_cd, N, HW, act, slope, 1.f,
                                 gate_max);
}

// The sigmoid gate's forward on the tensor cores at the wide gates: y =
// (x min(2 sigmoid(l), gate_max))_bf16 (sigmoid_gate<bf16>'s rounding
// points), u, h and l by the backward's own code (wide_u_mma, wide_h,
// wide_l_mma), so that the forward's l is the sigmoid backward's bit for
// bit. Grid (ceil(N HW / 32), splits): block (b, s) owns rows 32 b .. 32 b
// + 31 of the flattened (N HW) locations and the Cout chunks s per ..
// (s + 1) per - 1 (per = kOChunks / splits). It stages x of its rows by
// cp.async, computes u over all of W1x (8 weight tiles) and h, then for
// each of its chunks l (a warp: 16 x 16), g = min(2 sigmoid(l), gate_max)
// and y = (x g)_bf16, staged over the x it read; y leaves with 16-byte
// stores. No dy, no dh or dx: 8 + per weight tiles where the backward
// streams 24. Splitting Cout over blocks repeats u in each (W1x from L2)
// to put more blocks on the card: the two C = 512 shapes of the paths have
// 8 and 32 row blocks. Bound: bytes (x in, y out); about 20 HMMA a warp a
// weight tile.
template <int C, int HD, int CO>
__global__ void __launch_bounds__(kThreads, 2) sigmoid_gate_wide_mma(
    const bf16* __restrict__ x, const float* __restrict__ pp, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2, const float* __restrict__ b2,
    bf16* __restrict__ y, int N, int HW, int act, float slope, float gate_max) {
  using G = WideGate<C, HD, CO>;
  extern __shared__ float4 smem4[];
  bf16* Xs = reinterpret_cast<bf16*>(smem4);  // [kRows][kLX] x, then y
  bf16* Hs = Xs + G::kRows * G::kLX;          // [kRows][kLH] h_bf16
  bf16* Wb = Hs + G::kRows * G::kLH;          // [2][kWBuf] weight tiles
  float* Us = reinterpret_cast<float*>(Wb + 2 * G::kWBuf);  // [kRows][kLU] u
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 2, col = 2 * (lane & 3);
  const int mt = warp & 1, g = warp >> 1;
  const int M = N * HW, row0 = blockIdx.x * G::kRows;
  const int r0 = row0 + 16 * mt;                  // the warp's first row
  const int s0 = r0 < M ? r0 - r0 / HW * HW : 0;  // its first location
  const int per = G::kOChunks / gridDim.y, first = blockIdx.y * per;

  for (int e = threadIdx.x; e < G::kRows * (C / 8); e += blockDim.x) {
    const int r = e / (C / 8), ch = (e - r * (C / 8)) * 8;
    const bool ok = row0 + r < M;
    cp_async16(Xs + r * G::kLX + ch, x + (size_t)(ok ? row0 + r : 0) * C + ch, ok);
  }
  fetch_weights<C, HD, CO>(0, Wb, w1, w2);  // with x, one group
  cp_async_commit();

  wide_u_mma<C, HD, CO>(Xs, Wb, w1, w2, pp, b1, Us, s0, G::kXChunks + first);
  __syncthreads();  // u staged
  wide_h<C, HD, CO>(Us, Hs, nullptr, r0, act, slope);

  for (int i = 0; i < per; ++i) {
    const int chunk = first + i;
    const bf16* W = next_weights<C, HD, CO>(G::kXChunks + i,
                                            i + 1 < per ? G::kXChunks + chunk + 1 : -1, Wb, w1,
                                            w2);
    float l[2][4];
    wide_l_mma<C, HD, CO>(l, Hs, W);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int co = chunk * G::kChunk + 16 * g + nt * 8 + col;
      const float2 bv = *reinterpret_cast<const float2*>(b2 + co);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t* p = reinterpret_cast<uint32_t*>(Xs + (16 * mt + q + 8 * hh) * G::kLX + co);
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
        const float g0 = sigmoid_gate_of(l[nt][2 * hh] + bv.x, gate_max);
        const float g1 = sigmoid_gate_of(l[nt][2 * hh + 1] + bv.y, gate_max);
        *p = pack_bf16(xv.x * g0, xv.y * g1);
      }
    }
    __syncthreads();  // y of the chunk staged; the next fetch overwrites this buffer
  }

  // y out: the block's rows at its chunks' columns, 16 bytes a copy
  const int vecs = per * G::kChunk / 8;  // 16-byte vectors of a row
  for (int e = threadIdx.x; e < G::kRows * vecs; e += blockDim.x) {
    const int r = e / vecs, ch = first * G::kChunk + (e - r * vecs) * 8;
    if (row0 + r < M)
      *reinterpret_cast<uint4*>(y + (size_t)(row0 + r) * C + ch) =
          *reinterpret_cast<const uint4*>(Xs + r * G::kLX + ch);
  }
  cp_async_wait_all();
}

// The weight-gradient pass of both gates: grid (the 64 x 64 tiles of dW1x
// (C, HD) then of dW2 (HD, CO), splits). Block (tile, s) sums its tile over
// the location stages s * per_split .. (s + 1) * per_split - 1 of kWgRows
// rows (x and du_bf16, or h_bf16 and dl_bf16, by cp.async a stage ahead) and
// writes it to split s's partial [dW1x | dW2] in part; a split past the
// last stage writes zeros. Each of the 8 warps owns 16 x 32 of the tile.
template <int C, int HD, int CO>
__global__ void __launch_bounds__(kThreads) gate_wgrad_wide_mma(
    const bf16* __restrict__ x, const bf16* __restrict__ h_cd, const bf16* __restrict__ du_cd,
    const bf16* __restrict__ dl_cd, float* __restrict__ part, int M, int per_split) {
  constexpr int kT1 = (C / 64) * (HD / 64), kLd = 64 + 8;
  __shared__ __align__(16) bf16 Ps[2][kWgRows * kLd], Qs[2][kWgRows * kLd];
  int tile = blockIdx.x;
  const bf16 *P, *Q;
  int lp, lq, ldo;
  float* out = part + (size_t)blockIdx.y * WideGate<C, HD, CO>::kWT;
  if (tile < kT1) {  // dW1x = x^T du_bf16
    const int a0 = tile / (HD / 64) * 64, b0 = tile % (HD / 64) * 64;
    P = x + a0, lp = C, Q = du_cd + b0, lq = HD, ldo = HD;
    out += (size_t)a0 * HD + b0;
  } else {  // dW2 = h^T dl_bf16
    tile -= kT1;
    const int a0 = tile / (CO / 64) * 64, b0 = tile % (CO / 64) * 64;
    P = h_cd + a0, lp = HD, Q = dl_cd + b0, lq = CO, ldo = CO;
    out += (size_t)C * HD + (size_t)a0 * CO + b0;
  }
  const int stages = (M + kWgRows - 1) / kWgRows;
  const int k0 = blockIdx.y * per_split, k1 = min(k0 + per_split, stages);
  auto fetch = [&](int k, int buf) {
    for (int e = threadIdx.x; e < kWgRows * 8; e += blockDim.x) {
      const int r = e >> 3, ch = (e & 7) * 8, row = k * kWgRows + r;
      const bool ok = row < M;
      cp_async16(Ps[buf] + r * kLd + ch, P + (size_t)(ok ? row : 0) * lp + ch, ok);
      cp_async16(Qs[buf] + r * kLd + ch, Q + (size_t)(ok ? row : 0) * lq + ch, ok);
    }
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 2, col = 2 * (lane & 3);
  const int wm = warp & 3, wn = warp >> 2;
  // ldmatrix.trans rows and columns (gate_bwd_mma's): A = P^T, B = Q
  const int ka = (lane & 7) + ((lane >> 4) << 3), ac = ((lane >> 3) & 1) << 3;
  const int kb = (lane & 7) + (((lane >> 3) & 1) << 3), bc = (lane >> 4) << 3;
  float acc[4][4];
  zero(acc);
  if (k0 < k1) fetch(k0, 0);
  cp_async_commit();
  for (int k = k0; k < k1; ++k) {
    if (k + 1 < k1) fetch(k + 1, (k + 1 - k0) & 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* Pc = Ps[(k - k0) & 1];
    const bf16* Qc = Qs[(k - k0) & 1];
#pragma unroll
    for (int ks = 0; ks < kWgRows / 16; ++ks) {
      uint32_t af[4], bf[4];
      ldsm_x4_t(af, Pc + (ks * 16 + ka) * kLd + 16 * wm + ac);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        ldsm_x4_t(bf, Qc + (ks * 16 + kb) * kLd + 32 * wn + 16 * np + bc);
        mma16816(acc[2 * np], af, bf[0], bf[1]);
        mma16816(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the next fetch overwrites this stage
  }
  cp_async_wait_all();
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(out + (size_t)(16 * wm + q + 8 * hh) * ldo + 32 * wn + nt * 8 +
                                 col) = make_float2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
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
  return launch_stats_merge((const float*)part_m, (const float*)part_s, (float*)m, (float*)se,
                            N, tiles, Cout, stream);
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

// The forward pair on the tensor cores (softmax_stats_mma, softmax_apply_mma)
// on grid (ceil(HW / T_rows), N); the stats pass then merges its blocks'
// partials as launch_stats does.
cudaError_t launch_stats_mma(const void* x, const void* pp, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* part_m, void* part_s,
                             void* m, void* se, int N, int HW, int T_rows, int act,
                             float slope, cudaStream_t stream) {
  const int blocks = (HW + T_rows - 1) / T_rows;
  const size_t smem = fwd_mma_bytes(kStatsPass);
  cudaError_t err = allow_smem(softmax_stats_mma, smem);
  if (err != cudaSuccess) return err;
  softmax_stats_mma<<<dim3(blocks, N), kThreads, smem, stream>>>(
      (const bf16*)x, (const float*)pp, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (float*)part_m, (float*)part_s, HW, T_rows, act, slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_stats_merge((const float*)part_m, (const float*)part_s, (float*)m, (float*)se,
                            N, blocks, kGateCout, stream);
}

cudaError_t launch_apply_mma(const void* x, const void* pp, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* m, const void* se,
                             void* y, int N, int HW, int T_rows, int act, float slope,
                             float hw_scale, float gate_max, cudaStream_t stream) {
  const int blocks = (HW + T_rows - 1) / T_rows;
  const size_t smem = fwd_mma_bytes(kApplyPass);
  cudaError_t err = allow_smem(softmax_apply_mma, smem);
  if (err != cudaSuccess) return err;
  softmax_apply_mma<<<dim3(blocks, N), kThreads, smem, stream>>>(
      (const bf16*)x, (const float*)pp, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (const float*)m, (const float*)se, (bf16*)y, HW, T_rows, act, slope,
      hw_scale, gate_max);
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

// The csum pass on the tensor cores (softmax_csum_mma) on the forward
// pair's grid, then the fixed-order sum of its blocks' partials.
cudaError_t launch_csum_mma(const void* x, const void* dy, const void* pp, const void* w1,
                            const void* b1, const void* w2, const void* b2, const void* m,
                            const void* se, void* part_c, void* c, int N, int HW, int T_rows,
                            int act, float slope, float hw_scale, float gate_max,
                            cudaStream_t stream) {
  const int blocks = (HW + T_rows - 1) / T_rows;
  const size_t smem = fwd_mma_bytes(kCsumPass);
  cudaError_t err = allow_smem(softmax_csum_mma, smem);
  if (err != cudaSuccess) return err;
  softmax_csum_mma<<<dim3(blocks, N), kThreads, smem, stream>>>(
      (const bf16*)x, (const bf16*)dy, (const float*)pp, (const bf16*)w1, (const float*)b1,
      (const bf16*)w2, (const float*)b2, (const float*)m, (const float*)se, (float*)part_c, HW,
      T_rows, act, slope, hw_scale, gate_max);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce((const float*)part_c, (float*)c, N, blocks, kGateCout, stream);
}

template <typename T>
cudaError_t launch_sigmoid(const void* x, const void* pp, const void* w1, const void* b1,
                           const void* w2, const void* b2, void* y, int N, int HW, int C,
                           int Hd, int Cout, int T_rows, int act, float slope,
                           float gate_max, cudaStream_t stream) {
  const int tiles = (HW + T_rows - 1) / T_rows;
  const size_t smem = tile_floats(C, Hd, Cout, T_rows) * sizeof(float);
  cudaError_t err = allow_smem(sigmoid_gate<T>, smem);
  if (err != cudaSuccess) return err;
  sigmoid_gate<T><<<dim3(tiles, N), kThreads, smem, stream>>>(
      (const T*)x, (const float*)pp, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)b2, (T*)y, HW, C, Hd, Cout, T_rows, act, slope, gate_max);
  return cudaGetLastError();
}

// The sigmoid gate's forward on the tensor cores at the wide widths
// (sigmoid_gate_wide_mma) on grid (ceil(N HW / 32), splits).
cudaError_t launch_sigmoid_wide(const void* x, const void* pp, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* y, int N, int HW,
                                int splits, int act, float slope, float gate_max,
                                cudaStream_t stream) {
  constexpr int C = kWideC, HD = kWideHd, CO = kWideCout;
  const size_t smem = Wide::fwd_bytes;
  cudaError_t err = allow_smem(sigmoid_gate_wide_mma<C, HD, CO>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (N * HW + Wide::kRows - 1) / Wide::kRows;
  sigmoid_gate_wide_mma<C, HD, CO><<<dim3(blocks, splits), kThreads, smem, stream>>>(
      (const bf16*)x, (const float*)pp, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (bf16*)y, N, HW, act, slope, gate_max);
  return cudaGetLastError();
}

// S: the sigmoid gate's backward (m, se and c unused), else the softmax's.
template <typename T, bool S>
cudaError_t launch_bwd(const void* x, const void* dy, const void* pp, const void* w1,
                       const void* b1, const void* w2, const void* b2, const void* m,
                       const void* se, const void* c, void* dx, void* part_w, void* part_pp,
                       void* dw, void* dpp, int N, int HW, int C, int Hd, int Cout,
                       int T_rows, int R, int act, float slope, float hw_scale,
                       float gate_max, cudaStream_t stream) {
  const int tiles = (HW + T_rows - 1) / T_rows;
  const int nb = (N + R - 1) / R;
  const size_t smem = bwd_tile_floats(C, Hd, Cout, T_rows) * sizeof(float);
  cudaError_t err = S ? allow_smem(sigmoid_bwd<T>, smem) : allow_smem(softmax_bwd<T>, smem);
  if (err != cudaSuccess) return err;
  if (S)
    sigmoid_bwd<T><<<dim3(tiles, nb), kThreads, smem, stream>>>(
        (const T*)x, (const T*)dy, (const float*)pp, (const T*)w1, (const float*)b1,
        (const T*)w2, (const float*)b2, (T*)dx, (float*)part_w, (float*)part_pp, N, HW, C,
        Hd, Cout, T_rows, R, act, slope, gate_max);
  else
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

// softmax_bwd_mma (S false) or sigmoid_bwd_mma (S true, m, se and c
// unused) on grid (HW / 128, ceil(N / R)), then the two fixed-order
// reductions of its workspaces (gate_bwd's, with a 128-location tile).
template <bool S>
cudaError_t launch_bwd_mma(const void* x, const void* dy, const void* pp, const void* w1,
                           const void* b1, const void* w2, const void* b2, const void* m,
                           const void* se, const void* c, void* dx, void* part_w, void* part_pp,
                           void* dw, void* dpp, int N, int HW, int R, int act, float slope,
                           float hw_scale, float gate_max, cudaStream_t stream) {
  const int tiles = HW / kBwdTile, nb = (N + R - 1) / R;
  const size_t smem = bwd_mma_bytes();
  cudaError_t err = S ? allow_smem(sigmoid_bwd_mma, smem) : allow_smem(softmax_bwd_mma, smem);
  if (err != cudaSuccess) return err;
  if (S)
    sigmoid_bwd_mma<<<dim3(tiles, nb), kThreads, smem, stream>>>(
        (const bf16*)x, (const bf16*)dy, (const float*)pp, (const bf16*)w1, (const float*)b1,
        (const bf16*)w2, (const float*)b2, (bf16*)dx, (float*)part_w, (float*)part_pp, N, HW, R,
        act, slope, gate_max);
  else
    softmax_bwd_mma<<<dim3(tiles, nb), kThreads, smem, stream>>>(
        (const bf16*)x, (const bf16*)dy, (const float*)pp, (const bf16*)w1, (const float*)b1,
        (const bf16*)w2, (const float*)b2, (const float*)m, (const float*)se, (const float*)c,
        (bf16*)dx, (float*)part_w, (float*)part_pp, N, HW, R, act, slope, hw_scale, gate_max);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_reduce((const float*)part_w, (float*)dw, 1, tiles * nb, kWTot, stream);
  if (err != cudaSuccess) return err;
  return launch_reduce((const float*)part_pp, (float*)dpp, 1, nb, HW * kGateHd, stream);
}

// The wide gates' backward on the tensor cores, S as launch_bwd_mma's:
// the location pass on grid ceil(N HW / 32), the weight-gradient pass on
// (32 tiles, splits), then four fixed-order reductions. Workspaces (the
// sizes ops/fused_attention.py:bwd_wide_grid allocates): part_w holds
// the splits' [dW1x | dW2] partials, then the m-tiles' db2 partials
// (N HW / 16, Cout); part_pp holds du in f32 (N HW, Hd), then h_bf16 and
// du_bf16 (N HW, Hd) and dl_bf16 (N HW, Cout).
template <bool S>
cudaError_t launch_bwd_wide(const void* x, const void* dy, const void* pp, const void* w1,
                            const void* b1, const void* w2, const void* b2, const void* m,
                            const void* se, const void* c, void* dx, void* part_w,
                            void* part_pp, void* dw, void* dpp, int N, int HW, int splits,
                            int act, float slope, float hw_scale, float gate_max,
                            cudaStream_t stream) {
  constexpr int C = kWideC, HD = kWideHd, CO = kWideCout;
  const int M = N * HW;
  float* pw = static_cast<float*>(part_w);
  float* db2_part = pw + (size_t)splits * Wide::kWT;
  float* du_f32 = static_cast<float*>(part_pp);
  bf16* h_cd = reinterpret_cast<bf16*>(du_f32 + (size_t)M * HD);
  bf16* du_cd = h_cd + (size_t)M * HD;
  bf16* dl_cd = du_cd + (size_t)M * HD;
  const size_t smem = Wide::bytes;
  cudaError_t err = S ? allow_smem(sigmoid_bwd_wide_mma<C, HD, CO>, smem)
                      : allow_smem(softmax_bwd_wide_mma<C, HD, CO>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (M + Wide::kRows - 1) / Wide::kRows;
  if (S)
    sigmoid_bwd_wide_mma<C, HD, CO><<<blocks, kThreads, smem, stream>>>(
        (const bf16*)x, (const bf16*)dy, (const float*)pp, (const bf16*)w1, (const float*)b1,
        (const bf16*)w2, (const float*)b2, (bf16*)dx, db2_part, du_f32, h_cd, du_cd, dl_cd, N,
        HW, act, slope, gate_max);
  else
    softmax_bwd_wide_mma<C, HD, CO><<<blocks, kThreads, smem, stream>>>(
        (const bf16*)x, (const bf16*)dy, (const float*)pp, (const bf16*)w1, (const float*)b1,
        (const bf16*)w2, (const float*)b2, (const float*)m, (const float*)se, (const float*)c,
        (bf16*)dx, db2_part, du_f32, h_cd, du_cd, dl_cd, N, HW, act, slope, hw_scale, gate_max);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int stages = (M + kWgRows - 1) / kWgRows;
  const int per_split = (stages + splits - 1) / splits;
  constexpr int tiles = (C / 64) * (HD / 64) + (HD / 64) * (CO / 64);
  gate_wgrad_wide_mma<C, HD, CO><<<dim3(tiles, splits), kThreads, 0, stream>>>(
      (const bf16*)x, h_cd, du_cd, dl_cd, pw, M, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* dwf = static_cast<float*>(dw);
  err = launch_reduce(pw, dwf, 1, splits, Wide::kWT, stream);  // dW1x, dW2
  if (err != cudaSuccess) return err;
  err = launch_reduce(db2_part, dwf + Wide::kWT + HD, 1, M / 16, CO, stream);  // db2
  if (err != cudaSuccess) return err;
  err = launch_reduce(du_f32, (float*)dpp, 1, N, HW * HD, stream);  // dpos_proj
  if (err != cudaSuccess) return err;
  return launch_reduce((const float*)dpp, dwf + Wide::kWT, 1, HW, HD, stream);  // db1
}

// Whether the forward's mma route takes a call: bf16 at (64, 16, 64), HW
// a multiple of its 128-location tile, T_rows (a block's locations) a
// positive multiple of the tile.
bool fwd_mma_fits(int is_bf16, int HW, int C, int Hd, int Cout, int T_rows) {
  return is_bf16 && C == kGateC && Hd == kGateHd && Cout == kGateCout && HW % kBwdTile == 0 &&
         T_rows > 0 && T_rows % kBwdTile == 0;
}

// Whether the mma route takes a backward call: bf16 at the template's
// widths, its 128-location tile, an HW the tile divides.
bool bwd_mma_fits(int is_bf16, int HW, int C, int Hd, int Cout, int T_rows) {
  return is_bf16 && C == kGateC && Hd == kGateHd && Cout == kGateCout && T_rows == kBwdTile &&
         HW % kBwdTile == 0;
}

// Whether the wide template takes it: bf16 at (512, 128, 512), its
// 32-row location block, an HW that its 16-row m-tiles divide.
bool bwd_wide_fits(int is_bf16, int HW, int C, int Hd, int Cout, int T_rows) {
  return is_bf16 && C == kWideC && Hd == kWideHd && Cout == kWideCout && T_rows == Wide::kRows &&
         HW % 16 == 0;
}

// Whether the wide forward takes a sigmoid gate call: the wide template's
// conditions, and splits that divide Cout's 64-column chunks.
bool sigmoid_wide_fits(int is_bf16, int HW, int C, int Hd, int Cout, int T_rows, int splits) {
  return bwd_wide_fits(is_bf16, HW, C, Hd, Cout, T_rows) && splits >= 1 &&
         Wide::kOChunks % splits == 0;
}

// Blocks of `kernel` (kThreads threads, `smem` bytes of dynamic shared
// memory) that fit on an SM; -1 on an error.
template <typename K>
int blocks_per_sm(K kernel, size_t smem) {
  int n = -1;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return n;
}

}  // namespace

// Plain C interface, loaded with ctypes. `is_bf16` selects the compute
// dtype (1: bfloat16, 0: float32). Returns a cudaError_t (0 = launched).
extern "C" {

size_t locate_softmax_smem_bytes(int C, int Hd, int Cout, int T_rows) {
  return tile_floats(C, Hd, Cout, T_rows) * sizeof(float);
}

// part_m, part_s: (N, ceil(HW / T_rows), Cout) workspaces; m, se: (N, Cout)
// out. route 0 is the simt kernel (every dtype and width, T_rows from
// locate_softmax_smem_bytes' tile); route 1 the tensor cores'
// (softmax_stats_mma) for bf16 at (C, Hd, Cout) = (64, 16, 64) with 128
// dividing HW and T_rows; nothing else.
int locate_softmax_stats(int route, int is_bf16, const void* x, const void* pp,
                         const void* w1, const void* b1, const void* w2, const void* b2,
                         void* part_m, void* part_s, void* m, void* se, int N, int HW, int C,
                         int Hd, int Cout, int T_rows, int act, float slope, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (!fwd_mma_fits(is_bf16, HW, C, Hd, Cout, T_rows)) return (int)cudaErrorInvalidValue;
    return (int)launch_stats_mma(x, pp, w1, b1, w2, b2, part_m, part_s, m, se, N, HW, T_rows,
                                 act, slope, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch_stats<__nv_bfloat16>(x, pp, w1, b1, w2, b2, part_m, part_s, m, se,
                                            N, HW, C, Hd, Cout, T_rows, act, slope, s);
  return (int)launch_stats<float>(x, pp, w1, b1, w2, b2, part_m, part_s, m, se, N, HW, C,
                                  Hd, Cout, T_rows, act, slope, s);
}

// y: (N, HW, C) out; the routes as locate_softmax_stats' (route 1:
// softmax_apply_mma).
int locate_softmax_apply(int route, int is_bf16, const void* x, const void* pp,
                         const void* w1, const void* b1, const void* w2, const void* b2,
                         const void* m, const void* se, void* y, int N, int HW, int C, int Hd,
                         int Cout, int T_rows, int act, float slope, float hw_scale,
                         float gate_max, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (!fwd_mma_fits(is_bf16, HW, C, Hd, Cout, T_rows)) return (int)cudaErrorInvalidValue;
    return (int)launch_apply_mma(x, pp, w1, b1, w2, b2, m, se, y, N, HW, T_rows, act, slope,
                                 hw_scale, gate_max, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch_apply<__nv_bfloat16>(x, pp, w1, b1, w2, b2, m, se, y, N, HW, C, Hd,
                                            Cout, T_rows, act, slope, hw_scale, gate_max,
                                            s);
  return (int)launch_apply<float>(x, pp, w1, b1, w2, b2, m, se, y, N, HW, C, Hd, Cout,
                                  T_rows, act, slope, hw_scale, gate_max, s);
}

// Dynamic shared memory of a block of pass `pass` (0 stats, 1 apply, 2
// csum) of the forward body's mma route at (C, Hd, Cout); 0 where it does
// not take the widths or the pass.
size_t locate_softmax_fwd_mma_smem_bytes(int pass, int C, int Hd, int Cout) {
  if (C != kGateC || Hd != kGateHd || Cout != kGateCout || pass < kStatsPass || pass > kCsumPass)
    return 0;
  return fwd_mma_bytes(pass);
}

// Blocks of softmax_stats_mma (pass 0), softmax_apply_mma (1) or
// softmax_csum_mma (2) that fit on an SM; 0 where the mma route does not
// take (C, Hd, Cout) or the pass, -1 on an error.
int locate_softmax_fwd_mma_blocks_per_sm(int pass, int C, int Hd, int Cout) {
  if (C != kGateC || Hd != kGateHd || Cout != kGateCout) return 0;
  switch (pass) {
    case kStatsPass: return blocks_per_sm(softmax_stats_mma, fwd_mma_bytes(kStatsPass));
    case kApplyPass: return blocks_per_sm(softmax_apply_mma, fwd_mma_bytes(kApplyPass));
    case kCsumPass: return blocks_per_sm(softmax_csum_mma, fwd_mma_bytes(kCsumPass));
    default: return 0;
  }
}

size_t locate_softmax_bwd_smem_bytes(int C, int Hd, int Cout, int T_rows) {
  return bwd_tile_floats(C, Hd, Cout, T_rows) * sizeof(float);
}

// part_c: (N, ceil(HW / T_rows), Cout) workspace; c: (N, Cout) out. The
// routes as locate_softmax_stats' (route 1: softmax_csum_mma, its T_rows
// sized by its own occupancy).
int locate_softmax_csum(int route, int is_bf16, const void* x, const void* dy, const void* pp,
                        const void* w1, const void* b1, const void* w2, const void* b2,
                        const void* m, const void* se, void* part_c, void* c, int N, int HW,
                        int C, int Hd, int Cout, int T_rows, int act, float slope,
                        float hw_scale, float gate_max, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (!fwd_mma_fits(is_bf16, HW, C, Hd, Cout, T_rows)) return (int)cudaErrorInvalidValue;
    return (int)launch_csum_mma(x, dy, pp, w1, b1, w2, b2, m, se, part_c, c, N, HW, T_rows, act,
                                slope, hw_scale, gate_max, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch_csum<__nv_bfloat16>(x, dy, pp, w1, b1, w2, b2, m, se, part_c, c, N,
                                           HW, C, Hd, Cout, T_rows, act, slope, hw_scale,
                                           gate_max, s);
  return (int)launch_csum<float>(x, dy, pp, w1, b1, w2, b2, m, se, part_c, c, N, HW, C, Hd,
                                 Cout, T_rows, act, slope, hw_scale, gate_max, s);
}

// Dynamic shared memory of a block of the mma route's location kernel at
// (C, Hd, Cout), the same for both gates: softmax_bwd_mma's at (64, 16,
// 64), softmax_bwd_wide_mma's at (512, 128, 512); 0 where no template
// takes the widths.
size_t locate_softmax_bwd_mma_smem_bytes(int C, int Hd, int Cout) {
  if (C == kGateC && Hd == kGateHd && Cout == kGateCout) return bwd_mma_bytes();
  if (C == kWideC && Hd == kWideHd && Cout == kWideCout) return Wide::bytes;
  return 0;
}

// Blocks of a kernel of the mma route at (C, Hd, Cout) that fit on an SM:
// kind 0 the softmax's (softmax_bwd_mma, or softmax_bwd_wide_mma at the
// wide widths), 1 the sigmoid's, 2 the wide widths' weight-gradient pass
// (gate_wgrad_wide_mma); 0 where no template takes the call, -1 on an
// error.
int locate_softmax_bwd_mma_blocks_per_sm(int kind, int C, int Hd, int Cout) {
  constexpr int WC = kWideC, WH = kWideHd, WO = kWideCout;
  if (C == kGateC && Hd == kGateHd && Cout == kGateCout && kind < 2)
    return kind ? blocks_per_sm(sigmoid_bwd_mma, bwd_mma_bytes())
                : blocks_per_sm(softmax_bwd_mma, bwd_mma_bytes());
  if (C == kWideC && Hd == kWideHd && Cout == kWideCout) {
    if (kind == 0) return blocks_per_sm(softmax_bwd_wide_mma<WC, WH, WO>, Wide::bytes);
    if (kind == 1) return blocks_per_sm(sigmoid_bwd_wide_mma<WC, WH, WO>, Wide::bytes);
    if (kind == 2) return blocks_per_sm(gate_wgrad_wide_mma<WC, WH, WO>, 0);
  }
  return 0;
}

// part_w: (ceil(HW/T_rows) * ceil(N/R), C*Hd + Hd*Cout + Hd + Cout) and
// part_pp: (ceil(N/R), HW, Hd) workspaces; dx: (N, HW, C) out; dw: the
// concatenated f32 [dW1x (C, Hd), dW2 (Hd, Cout), db1 (Hd), db2 (Cout)]
// out; dpp: (HW, Hd) out. route 0 is the simt kernel (every dtype and
// width); route 1 the tensor cores': softmax_bwd_mma for bf16 at (C, Hd,
// Cout) = (64, 16, 64) with T_rows = 128 dividing HW, and
// softmax_bwd_wide_mma with its weight-gradient pass for bf16 at (512, 128,
// 512) with T_rows = 32 and 16 dividing HW, where R is the weight-gradient
// pass's splits and the workspaces are launch_bwd_wide's; nothing else.
int locate_softmax_bwd(int route, int is_bf16, const void* x, const void* dy, const void* pp,
                       const void* w1, const void* b1, const void* w2, const void* b2,
                       const void* m, const void* se, const void* c, void* dx, void* part_w,
                       void* part_pp, void* dw, void* dpp, int N, int HW, int C, int Hd,
                       int Cout, int T_rows, int R, int act, float slope, float hw_scale,
                       float gate_max, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (R < 1) return (int)cudaErrorInvalidValue;
    if (bwd_wide_fits(is_bf16, HW, C, Hd, Cout, T_rows))
      return (int)launch_bwd_wide<false>(x, dy, pp, w1, b1, w2, b2, m, se, c, dx, part_w,
                                         part_pp, dw, dpp, N, HW, R, act, slope, hw_scale,
                                         gate_max, s);
    if (!bwd_mma_fits(is_bf16, HW, C, Hd, Cout, T_rows)) return (int)cudaErrorInvalidValue;
    return (int)launch_bwd_mma<false>(x, dy, pp, w1, b1, w2, b2, m, se, c, dx, part_w, part_pp,
                                      dw, dpp, N, HW, R, act, slope, hw_scale, gate_max, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch_bwd<__nv_bfloat16, false>(x, dy, pp, w1, b1, w2, b2, m, se, c, dx,
                                                 part_w, part_pp, dw, dpp, N, HW, C, Hd, Cout,
                                                 T_rows, R, act, slope, hw_scale, gate_max, s);
  return (int)launch_bwd<float, false>(x, dy, pp, w1, b1, w2, b2, m, se, c, dx, part_w,
                                       part_pp, dw, dpp, N, HW, C, Hd, Cout, T_rows, R, act,
                                       slope, hw_scale, gate_max, s);
}

// y: (N, HW, C) out. route 0 is the simt kernel (every dtype and width, R
// unused); route 1 the tensor cores' (sigmoid_gate_wide_mma) for bf16 at
// (512, 128, 512) with T_rows = 32 and 16 dividing HW, R splits of Cout's
// 64-column chunks (1, 2, 4 or 8); nothing else.
int locate_sigmoid_gate(int route, int is_bf16, const void* x, const void* pp, const void* w1,
                        const void* b1, const void* w2, const void* b2, void* y, int N, int HW,
                        int C, int Hd, int Cout, int T_rows, int R, int act, float slope,
                        float gate_max, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (!sigmoid_wide_fits(is_bf16, HW, C, Hd, Cout, T_rows, R)) return (int)cudaErrorInvalidValue;
    return (int)launch_sigmoid_wide(x, pp, w1, b1, w2, b2, y, N, HW, R, act, slope, gate_max, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch_sigmoid<__nv_bfloat16>(x, pp, w1, b1, w2, b2, y, N, HW, C, Hd, Cout,
                                              T_rows, act, slope, gate_max, s);
  return (int)launch_sigmoid<float>(x, pp, w1, b1, w2, b2, y, N, HW, C, Hd, Cout, T_rows, act,
                                    slope, gate_max, s);
}

// Dynamic shared memory of a block, and blocks that fit on an SM, of the
// sigmoid gate's forward mma route at (C, Hd, Cout): sigmoid_gate_wide_mma
// at (512, 128, 512); 0 where it does not take the widths (-1 on an error).
size_t locate_sigmoid_gate_mma_smem_bytes(int C, int Hd, int Cout) {
  return C == kWideC && Hd == kWideHd && Cout == kWideCout ? Wide::fwd_bytes : 0;
}

int locate_sigmoid_gate_mma_blocks_per_sm(int C, int Hd, int Cout) {
  if (C != kWideC || Hd != kWideHd || Cout != kWideCout) return 0;
  return blocks_per_sm(sigmoid_gate_wide_mma<kWideC, kWideHd, kWideCout>, Wide::fwd_bytes);
}

// The workspaces and outputs of locate_softmax_bwd, without m, se and c.
// route 0 is the simt kernel (every dtype and width); route 1 the tensor
// cores' (sigmoid_bwd_mma, or sigmoid_bwd_wide_mma at the wide widths),
// under locate_softmax_bwd's conditions.
int locate_sigmoid_bwd(int route, int is_bf16, const void* x, const void* dy, const void* pp,
                       const void* w1, const void* b1, const void* w2, const void* b2, void* dx,
                       void* part_w, void* part_pp, void* dw, void* dpp, int N, int HW, int C,
                       int Hd, int Cout, int T_rows, int R, int act, float slope,
                       float gate_max, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (R < 1) return (int)cudaErrorInvalidValue;
    if (bwd_wide_fits(is_bf16, HW, C, Hd, Cout, T_rows))
      return (int)launch_bwd_wide<true>(x, dy, pp, w1, b1, w2, b2, nullptr, nullptr, nullptr, dx,
                                        part_w, part_pp, dw, dpp, N, HW, R, act, slope, 1.f,
                                        gate_max, s);
    if (!bwd_mma_fits(is_bf16, HW, C, Hd, Cout, T_rows)) return (int)cudaErrorInvalidValue;
    return (int)launch_bwd_mma<true>(x, dy, pp, w1, b1, w2, b2, nullptr, nullptr, nullptr, dx,
                                     part_w, part_pp, dw, dpp, N, HW, R, act, slope, 1.f,
                                     gate_max, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch_bwd<__nv_bfloat16, true>(x, dy, pp, w1, b1, w2, b2, nullptr, nullptr,
                                                nullptr, dx, part_w, part_pp, dw, dpp, N, HW,
                                                C, Hd, Cout, T_rows, R, act, slope, 1.f,
                                                gate_max, s);
  return (int)launch_bwd<float, true>(x, dy, pp, w1, b1, w2, b2, nullptr, nullptr, nullptr, dx,
                                      part_w, part_pp, dw, dpp, N, HW, C, Hd, Cout, T_rows, R,
                                      act, slope, 1.f, gate_max, s);
}

const char* locate_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
