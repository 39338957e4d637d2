// Fused stage group, forward and backward, for Hopper (sm_90a).
//
// Replaces five TPU kernels of locate_tpu/ops/pallas/fused_stage.py:
//   * _kernel_conv_only          (:366) -> stage_conv (bf16: stage_conv_mma)
//   * _kernel_sigmoid            (:378) -> stage_sigmoid (bf16: stage_sigmoid_mma)
//   * _kernel_softmax_stats      (:410) -> stage_softmax_stats (bf16: stage_softmax_stats_mma)
//                                          + softmax_stats_merge
//   * _kernel_softmax_apply_pool (:397) -> stage_softmax_apply_pool
//                                          (bf16: stage_softmax_apply_pool_mma)
//   * _kernel_conv_bwd           (:451) -> stage_conv_bwd (bf16: stage_conv_bwd_mma)
//                                          + reduce_partials
// (softmax_stats_merge and reduce_partials are the gate kernels' own, in common.cuh.)
//
// The conv block of one tile of the fine output, with the GroupNorm folded
// into a per-(n, c) affine (a, b) by the caller:
//     u = act(x*a + b), rounded to the compute dtype cd   (0 outside the image)
//     v = sum_k u[:, j+k-1] . Wr[k]                        (1,3) conv, f32 sums, -> cd
//     y = sum_k v[i+k-1, :] . Wc[k]                        (3,1) conv, f32 sums, -> cd
//     w = ((y + b_col) + skip) * cd(1/sqrt(2))             each step rounded to cd
// with skip = x (C == Co) or x . Wskip (f32 sums, -> cd). x, every weight
// and every output are NHWC / row-major in cd (bf16 or f32); a, b, b_col,
// the gate's pos_proj and biases, and all statistics are f32. Under
// `upsample` x is the coarse tensor: u, the skip and the 1x1 product are
// taken at the coarse pixel under each fine pixel, which is what expanding
// them gives. Under `downsample` the output is w averaged over 2x2 in f32.
//
// The sigmoid kernel takes the gate logits l (below) of the tile's w and
// writes only y = (w * min(2 sigmoid(l), gate_max))_cd, fine, or under
// `downsample` the 2x2 f32 average of those cd values: no w_pre and no
// statistics, since the sigmoid gate is local to a pixel.
//
// The softmax stats kernel also writes w (w_pre, always fine) and each
// tile's per-channel (max, sum-exp) of the gate logits
//     l = act(w . W1x + pos_proj + b1)_cd . W2 + b2
// which softmax_stats_merge folds. The apply-pool kernel recomputes l from w_pre,
// forms g = min(exp(l - m) / se * HW, gate_max), and writes the 2x2 f32
// average of (w * g)_cd.
//
// The backward kernel takes dL/dw (fine) and recomputes u and v; with
// dy0 = (dw * 1/sqrt(2))_cd it forms
//     dv   = sum_k dy0[i+1-k, :] . Wc[k]^T      -> cd
//     du   = sum_k dv[:, j+1-k] . Wr[k]^T       (2x2 sum-pooled under upsample) -> cd
//     dWc[k] += v[i+k-1]^T dy0,  dWr[k] += u[:, j+k-1]^T dv,  db_col += sum dw/sqrt(2)
//     dxs  = dy0_s (identity) or (dy0_s . Wskip^T)_cd,  dWskip += x^T dy0_s
// where dy0_s is dy0, or under upsample the 2x2 sum of dw/sqrt(2) rounded
// to cd. The caller passes the transposes with the taps reversed, so every
// transpose runs the forward's shifted product. The act' and GroupNorm
// backward is a plain epilogue in ops/fused_stage.py, as it is an XLA pass
// in the JAX package.
//
// Bound: the conv products are 2*3*(C*Co + Co*Co) flops per fine pixel
// (about 49 kflop at C = Co = 64; three times that in the backward) against
// about 2*(C + Co) bytes of traffic in bf16, so at the ffhq_512 shapes a
// pass is bound by operations on the tensor cores' 989 TFLOP/s where x is
// coarse (`up`) or y pooled (`down`), and by bytes where both are fine or
// the gate dominates (apply-pool).
//
// Two routes, chosen by the caller (ops/fused_stage.py:stage_route):
// * simt: every kernel below, f32 and bf16, runs its products as f32 FMAs
//   on the CUDA cores (67 TFLOP/s); f32 keeps it, since TF32 would miss
//   the f32 rule of 1e-4.
// * mma: bf16 at the widths of the templates, for the four kernels that
//   compute the conv block: stage_softmax_stats_mma, stage_conv_bwd_mma,
//   stage_conv_mma and stage_sigmoid_mma, and for the apply-pool pass at
//   (Co, Hd, Cout) = (64, 16, 64): stage_softmax_apply_pool_mma (their
//   design is with them, further down).
//
// Design of the simt route. The TPU tiles whole image rows; at 512 x 64 channels a bf16 row
// is 64 KB, so here a block's tile is TH rows x TW columns of the fine
// image, with a 1-row halo for the (3,1) conv and a 2-column halo (1 is
// needed, 2 keeps rows float4-aligned) for the (1,3) conv, zeroed outside
// the image as _row_shift_taps masks them. Every buffer in shared memory
// is f32, pixel-major with the channels contiguous, so that a thread's 4
// pixels x 8 output channels register tile loads four channels of a pixel
// as one float4; weights are read through the read-only cache. Blocks run
// in no order, so the softmax statistics are per-tile partials that a
// second kernel merges, and each backward block loops over a strided share
// of the tiles, adding its weight gradients into its own slice of a
// workspace (each element owned by one thread); reduce_partials sums the
// slices in a fixed order, so two runs give bitwise-equal gradients and no
// float atomics are used.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kSqrtHalf = 0.7071067811865476f;

enum Kind { kConv = 0, kStats = 1, kApplyPool = 2, kBwd = 3, kSigmoid = 4 };

// Shared-memory regions of one block, in floats (each a multiple of 4).
// Forward (conv, stats, sigmoid): R0 = u on the halo'd tile, then y; R1 =
// v, then the gate's h and l. Apply-pool: R0 = w, R1 = h and l. Backward: R0 = u, R1 = dy0 (both
// halo'd), R2 = v, then du before pooling; R3 = dv.
struct Layout {
  size_t r[4];
};

__host__ __device__ inline size_t maxz(size_t a, size_t b) { return a > b ? a : b; }

__host__ __device__ inline Layout layout(int kind, int C, int Co, int Hd, int Cout, int TH,
                                         int TW) {
  const size_t TWP = TW + 4, P = (size_t)TH * TW;
  Layout L = {{0, 0, 0, 0}};
  if (kind == kApplyPool) {
    L.r[0] = P * Co;
    L.r[1] = P * Hd + P * Cout;
  } else if (kind == kBwd) {
    L.r[0] = (TH + 2) * TWP * C;
    L.r[1] = (TH + 2) * TWP * Co;
    L.r[2] = maxz((TH + 2) * (size_t)TW * Co, P * C);
    L.r[3] = TH * TWP * Co;
  } else {
    L.r[0] = maxz((TH + 2) * TWP * C, P * Co);
    L.r[1] = (TH + 2) * (size_t)TW * Co;
    if (kind == kStats || kind == kSigmoid) L.r[1] = maxz(L.r[1], P * Hd + P * Cout);
  }
  for (int i = 0; i < 4; ++i) L.r[i] = (L.r[i] + 3) & ~(size_t)3;
  return L;
}

__host__ __device__ inline size_t smem_floats(int kind, int C, int Co, int Hd, int Cout,
                                              int TH, int TW) {
  const Layout L = layout(kind, C, Co, Hd, Cout, TH, TW);
  return L.r[0] + L.r[1] + L.r[2] + L.r[3];
}

// ---- loads -----------------------------------------------------------------

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// A bf16 pair packed in 32 bits (the lower address in the low half) as two
// f32: a bf16 is the high half of the f32 with the same value.
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y), bf16_hi(v.y));
}

// Eight consecutive weights (16-byte aligned) as f32.
__device__ __forceinline__ void ldg8(const float* p, float (&w)[8]) {
  const float4 a = ldg4(p), b = ldg4(p + 4);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

__device__ __forceinline__ void ldg8(const __nv_bfloat16* p, float (&w)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  w[0] = bf16_lo(v.x); w[1] = bf16_hi(v.x); w[2] = bf16_lo(v.y); w[3] = bf16_hi(v.y);
  w[4] = bf16_lo(v.z); w[5] = bf16_hi(v.z); w[6] = bf16_lo(v.w); w[7] = bf16_hi(v.w);
}

__device__ __forceinline__ void unpack(const float4 v, float* d) {
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}

// ---- the two small products ------------------------------------------------

// Out(i, j)[n] for i < R, j < CW, n < N (N % 8 == 0), summing NT taps of K
// input channels (K % 4 == 0) in f32:
//     acc = sum_{t < NT} sum_{c < K} A(i, j, t)[c] * Wt[(t*K + c)*N + n]
// in a fixed order (t, then c). `a(i, j, t, c)` returns channels c..c+3 of
// the tap-t input of pixel (i, j) as a float4. Each thread takes 4 pixels
// (i, j0..j0+3) x 8 channels at a time and hands the sums to
// `epi(i, j0, nq, n0, acc)`, nq of the 4 pixels being inside the tile.
template <int NT, typename T, typename ALoad, typename Epi>
__device__ __forceinline__ void tile_product(int R, int CW, int K, int N,
                                             const T* __restrict__ Wt, ALoad a, Epi epi) {
  const int ng = N / 8, jg = (CW + 3) / 4;
  const int total = R * jg * ng;
  for (int o = threadIdx.x; o < total; o += blockDim.x) {
    const int n0 = (o % ng) * 8;
    const int pg = o / ng;
    const int i = pg / jg, j0 = (pg % jg) * 4;
    const int nq = min(4, CW - j0);
    float acc[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[q][r] = 0.f;
    for (int t = 0; t < NT; ++t) {
      for (int c = 0; c < K; c += 4) {
        float av[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          unpack(q < nq ? a(i, j0 + q, t, c) : make_float4(0.f, 0.f, 0.f, 0.f), av[q]);
        const T* wp = Wt + ((size_t)t * K + c) * N + n0;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float w[8];
          ldg8(wp + (size_t)cc * N, w);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int r = 0; r < 8; ++r) acc[q][r] = fmaf(av[q][cc], w[r], acc[q][r]);
        }
      }
    }
    epi(i, j0, nq, n0, acc);
  }
}

// G[t][ka][kb] for t < NT, ka < KA, kb < KB (both % 4 == 0): the sum over
// pixels (i, j), i < R, j < CW, in a fixed order, of A(i, j, t)[ka] *
// B(i, j)[kb], written over G (`first`) or added to it. Each element is
// owned by one thread (4 x 4 of them per tap at a time).
template <int NT, typename ALoad, typename BLoad>
__device__ __forceinline__ void tile_wgrad(int R, int CW, int KA, int KB, ALoad a, BLoad b,
                                           float* __restrict__ G, bool first) {
  const int bg = KB / 4, total = (KA / 4) * bg;
  for (int o = threadIdx.x; o < total; o += blockDim.x) {
    const int a0 = (o / bg) * 4, b0 = (o % bg) * 4;
    float acc[NT][4][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[t][q][r] = 0.f;
    for (int i = 0; i < R; ++i) {
      for (int j = 0; j < CW; ++j) {
        float bv[4];
        unpack(b(i, j, b0), bv);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          float av[4];
          unpack(a(i, j, t, a0), av);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[t][q][r] = fmaf(av[q], bv[r], acc[t][q][r]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float4* g = reinterpret_cast<float4*>(G + ((size_t)t * KA + a0 + q) * KB + b0);
        float4 v = make_float4(acc[t][q][0], acc[t][q][1], acc[t][q][2], acc[t][q][3]);
        if (!first) {
          const float4 old = *g;
          v.x += old.x; v.y += old.y; v.z += old.z; v.w += old.w;
        }
        *g = v;
      }
  }
}

// ---- the tile ----------------------------------------------------------------

// Where a block's tile sits: batch row n, fine rows r0.., fine cols c0...
struct Geo {
  int n, r0, c0;
  int H, W, TH, TW, TWP;
  int Hx, Wx;  // x's grid (coarse under upsample)
  bool up;
  __device__ Geo(int n_, int r0_, int c0_, int H_, int W_, int TH_, int TW_, bool up_)
      : n(n_), r0(r0_), c0(c0_), H(H_), W(W_), TH(TH_), TW(TW_), TWP(TW_ + 4),
        Hx(up_ ? H_ / 2 : H_), Wx(up_ ? W_ / 2 : W_), up(up_) {}
  // offset of x's pixel under fine pixel (r, c), in pixels
  __device__ size_t xpix(int r, int c) const {
    return up ? ((size_t)n * Hx + (r >> 1)) * Wx + (c >> 1) : ((size_t)n * H + r) * W + c;
  }
  __device__ size_t fine(int r, int c) const { return ((size_t)n * H + r) * W + c; }
  __device__ bool inside(int r, int c) const { return r >= 0 && r < H && c >= 0 && c < W; }
};

// u on the halo'd tile: (TH + 2) rows x TWP cols, image pixel (r0 - 1 + br,
// c0 - 2 + bc), C channels; zero outside the image.
template <typename T>
__device__ void load_u(const T* __restrict__ x, const float* __restrict__ a,
                       const float* __restrict__ b, const Geo& g, int C, int act, float slope,
                       float* __restrict__ U) {
  const float* an = a + (size_t)g.n * C;
  const float* bn = b + (size_t)g.n * C;
  const int total = (g.TH + 2) * g.TWP * C;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int c = e % C, p = e / C;
    const int r = g.r0 - 1 + p / g.TWP, col = g.c0 - 2 + p % g.TWP;
    float u = 0.f;
    if (g.inside(r, col))
      u = round_cd<T>(activate(to_f32(x[g.xpix(r, col) * C + c]) * an[c] + bn[c], act, slope));
    U[e] = u;
  }
}

// The conv block of the tile (the forward's shared body, _stage_tile):
// leaves w, rounded to cd, in Y = U's region as [TH*TW][Co]. V is free after.
template <typename T>
__device__ void conv_tile(const T* __restrict__ x, const float* __restrict__ a,
                          const float* __restrict__ b, const T* __restrict__ wr,
                          const T* __restrict__ wc, const float* __restrict__ bc,
                          const T* __restrict__ ws, const Geo& g, int C, int Co, int act,
                          float slope, float* __restrict__ U, float* __restrict__ V) {
  const int TW = g.TW, TWP = g.TWP, TH = g.TH;
  load_u<T>(x, a, b, g, C, act, slope, U);
  __syncthreads();
  // v on TH + 2 rows: V(i, j) = sum_t U(i, j + 1 + t) . Wr[t]
  tile_product<3>(TH + 2, TW, C, Co, wr,
      [&](int i, int j, int t, int c) { return lds4(U + ((size_t)i * TWP + j + 1 + t) * C + c); },
      [&](int i, int j0, int nq, int n0, const float (&acc)[4][8]) {
        for (int q = 0; q < nq; ++q) {
          float* dst = V + ((size_t)i * TW + j0 + q) * Co + n0;
#pragma unroll
          for (int r = 0; r < 8; ++r) dst[r] = round_cd<T>(acc[q][r]);
        }
      });
  __syncthreads();
  // the skip into Y (U is free): x . Wskip rounded to cd, or x itself
  float* Y = U;
  if (ws) {
    tile_product<1>(TH, TW, C, Co, ws,
        [&](int i, int j, int, int c) { return ldg4(x + g.xpix(g.r0 + i, g.c0 + j) * C + c); },
        [&](int i, int j0, int nq, int n0, const float (&acc)[4][8]) {
          for (int q = 0; q < nq; ++q) {
            float* dst = Y + ((size_t)i * TW + j0 + q) * Co + n0;
#pragma unroll
            for (int r = 0; r < 8; ++r) dst[r] = round_cd<T>(acc[q][r]);
          }
        });
  } else {
    for (int e = threadIdx.x; e < TH * TW * Co; e += blockDim.x) {
      const int co = e % Co, p = e / Co;
      Y[e] = to_f32(x[g.xpix(g.r0 + p / TW, g.c0 + p % TW) * Co + co]);
    }
  }
  __syncthreads();
  // w = ((v-conv + b_col) + skip) * 1/sqrt(2), each step rounded to cd
  const float sqh = round_cd<T>(kSqrtHalf);
  tile_product<3>(TH, TW, Co, Co, wc,
      [&](int i, int j, int t, int c) { return lds4(V + ((size_t)(i + t) * TW + j) * Co + c); },
      [&](int i, int j0, int nq, int n0, const float (&acc)[4][8]) {
        for (int q = 0; q < nq; ++q) {
          float* dst = Y + ((size_t)i * TW + j0 + q) * Co + n0;
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float y = round_cd<T>(round_cd<T>(acc[q][r]) + round_cd<T>(bc[n0 + r]));
            dst[r] = round_cd<T>(round_cd<T>(y + dst[r]) * sqh);
          }
        }
      });
  __syncthreads();
}

// Y [TH*TW][Co] to out, at fine resolution or 2x2-averaged in f32.
template <typename T>
__device__ void store_tile(const float* __restrict__ Y, const Geo& g, int Co, bool pool,
                           T* __restrict__ out) {
  const int TW = g.TW;
  if (!pool) {
    for (int e = threadIdx.x; e < g.TH * TW * Co; e += blockDim.x) {
      const int co = e % Co, p = e / Co;
      out[g.fine(g.r0 + p / TW, g.c0 + p % TW) * Co + co] = from_f32<T>(Y[e]);
    }
    return;
  }
  const int hw = TW / 2, Wo = g.W / 2;
  for (int e = threadIdx.x; e < (g.TH / 2) * hw * Co; e += blockDim.x) {
    const int co = e % Co, p = e / Co;
    const int pi = p / hw, pj = p % hw;
    const float* y = Y + ((size_t)(2 * pi) * TW + 2 * pj) * Co + co;
    const float s = (y[0] + y[Co]) + (y[(size_t)TW * Co] + y[(size_t)TW * Co + Co]);
    const size_t o = (((size_t)g.n * (g.H / 2) + g.r0 / 2 + pi) * Wo + g.c0 / 2 + pj) * Co + co;
    out[o] = from_f32<T>(s * 0.25f);
  }
}

// The gate logits of the tile's P pixels of w (Y [P][Co]) into Ls [P][Cout],
// the hidden activations into Hs [P][Hd] (_gate_logits_of).
template <typename T>
__device__ void gate_logits(const float* __restrict__ Y, const Geo& g, int Co,
                            const float* __restrict__ pp, const T* __restrict__ w1,
                            const float* __restrict__ b1, const T* __restrict__ w2,
                            const float* __restrict__ b2, int Hd, int Cout, int act,
                            float slope, float* __restrict__ Hs, float* __restrict__ Ls) {
  const int P = g.TH * g.TW;
  for (int e = threadIdx.x; e < P * Hd; e += blockDim.x) {
    const int j = e % Hd, p = e / Hd;
    const float* y = Y + (size_t)p * Co;
    float acc = 0.f;
    for (int c = 0; c < Co; ++c) acc = fmaf(y[c], to_f32(w1[(size_t)c * Hd + j]), acc);
    const size_t loc = (size_t)(g.r0 + p / g.TW) * g.W + g.c0 + p % g.TW;
    Hs[e] = round_cd<T>(activate(acc + pp[loc * Hd + j] + b1[j], act, slope));
  }
  __syncthreads();
  for (int e = threadIdx.x; e < P * Cout; e += blockDim.x) {
    const int co = e % Cout, p = e / Cout;
    const float* h = Hs + (size_t)p * Hd;
    float acc = 0.f;
    for (int j = 0; j < Hd; ++j) acc = fmaf(h[j], to_f32(w2[(size_t)j * Cout + co]), acc);
    Ls[e] = acc + b2[co];
  }
  __syncthreads();
}

// ---- kernels ---------------------------------------------------------------

// stage_conv: grid (tiles, N). out is fine, or pooled under `down`.
template <typename T>
__global__ void __launch_bounds__(kThreads) stage_conv(
    const T* __restrict__ x, const float* __restrict__ a, const float* __restrict__ b,
    const T* __restrict__ wr, const T* __restrict__ wc, const float* __restrict__ bc,
    const T* __restrict__ ws, T* __restrict__ out, int H, int W, int C, int Co, int TH,
    int TW, int act, float slope, int up, int down) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(kConv, C, Co, 0, 0, TH, TW);
  float* U = smem;
  float* V = U + L.r[0];
  const int tx = W / TW;
  const Geo g(blockIdx.y, (blockIdx.x / tx) * TH, (blockIdx.x % tx) * TW, H, W, TH, TW, up);
  conv_tile<T>(x, a, b, wr, wc, bc, ws, g, C, Co, act, slope, U, V);
  store_tile<T>(U, g, Co, down, out);
}

// stage_sigmoid: grid (tiles, N). The conv block's w, the gate logits on
// it, then y = (w * min(2 sigmoid(l), gate_max))_cd, written fine or,
// under `down`, 2x2-averaged in f32 (_kernel_sigmoid).
template <typename T>
__global__ void __launch_bounds__(kThreads) stage_sigmoid(
    const T* __restrict__ x, const float* __restrict__ a, const float* __restrict__ b,
    const T* __restrict__ wr, const T* __restrict__ wc, const float* __restrict__ bc,
    const T* __restrict__ ws, const float* __restrict__ pp, const T* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ w2, const float* __restrict__ b2,
    T* __restrict__ out, int H, int W, int C, int Co, int Hd, int Cout, int TH, int TW,
    int act, float slope, float gate_max, int up, int down) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(kSigmoid, C, Co, Hd, Cout, TH, TW);
  float* U = smem;
  float* V = U + L.r[0];
  const int tx = W / TW;
  const Geo g(blockIdx.y, (blockIdx.x / tx) * TH, (blockIdx.x % tx) * TW, H, W, TH, TW, up);
  conv_tile<T>(x, a, b, wr, wc, bc, ws, g, C, Co, act, slope, U, V);
  const int P = TH * TW;
  float* Hs = V;
  float* Ls = V + (size_t)P * Hd;
  gate_logits<T>(U, g, Co, pp, w1, b1, w2, b2, Hd, Cout, act, slope, Hs, Ls);
  for (int e = threadIdx.x; e < P * Cout; e += blockDim.x)
    Ls[e] = sigmoid_gate_of(Ls[e], gate_max);
  __syncthreads();
  const bool broadcast = Cout == 1;
  for (int e = threadIdx.x; e < P * Co; e += blockDim.x) {
    const int co = e % Co, p = e / Co;
    U[e] = round_cd<T>(U[e] * Ls[(size_t)p * Cout + (broadcast ? 0 : co)]);
  }
  __syncthreads();
  store_tile<T>(U, g, Co, down, out);
}

// stage_softmax_stats: grid (tiles, N). Writes w_pre (fine) and the tile's
// per-channel (max, sum-exp) of the gate logits to part_m / part_s
// (N, tiles, Cout).
template <typename T>
__global__ void __launch_bounds__(kThreads) stage_softmax_stats(
    const T* __restrict__ x, const float* __restrict__ a, const float* __restrict__ b,
    const T* __restrict__ wr, const T* __restrict__ wc, const float* __restrict__ bc,
    const T* __restrict__ ws, const float* __restrict__ pp, const T* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ w2, const float* __restrict__ b2,
    T* __restrict__ w_pre, float* __restrict__ part_m, float* __restrict__ part_s, int H,
    int W, int C, int Co, int Hd, int Cout, int TH, int TW, int act, float slope, int up) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(kStats, C, Co, Hd, Cout, TH, TW);
  float* U = smem;
  float* V = U + L.r[0];
  const int tx = W / TW, tiles = gridDim.x, tile = blockIdx.x;
  const Geo g(blockIdx.y, (tile / tx) * TH, (tile % tx) * TW, H, W, TH, TW, up);
  conv_tile<T>(x, a, b, wr, wc, bc, ws, g, C, Co, act, slope, U, V);
  store_tile<T>(U, g, Co, false, w_pre);
  const int P = TH * TW;
  float* Hs = V;
  float* Ls = V + (size_t)P * Hd;
  gate_logits<T>(U, g, Co, pp, w1, b1, w2, b2, Hd, Cout, act, slope, Hs, Ls);
  for (int co = threadIdx.x; co < Cout; co += blockDim.x) {
    float m = -INFINITY;
    for (int p = 0; p < P; ++p) m = fmaxf(m, Ls[(size_t)p * Cout + co]);
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += expf(Ls[(size_t)p * Cout + co] - m);
    const size_t o = ((size_t)g.n * tiles + tile) * Cout + co;
    part_m[o] = m;
    part_s[o] = s;
  }
}

// stage_softmax_apply_pool: grid (tiles, N). m, se are (N, Cout).
template <typename T>
__global__ void __launch_bounds__(kThreads) stage_softmax_apply_pool(
    const T* __restrict__ w_pre, const float* __restrict__ pp, const T* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ m, const float* __restrict__ se, T* __restrict__ out, int H,
    int W, int Co, int Hd, int Cout, int TH, int TW, int act, float slope, float hw_scale,
    float gate_max) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(kApplyPool, Co, Co, Hd, Cout, TH, TW);
  float* Y = smem;
  float* Hs = Y + L.r[0];
  const int P = TH * TW;
  float* Ls = Hs + (size_t)P * Hd;
  const int tx = W / TW;
  const Geo g(blockIdx.y, (blockIdx.x / tx) * TH, (blockIdx.x % tx) * TW, H, W, TH, TW, false);
  for (int e = threadIdx.x; e < P * Co; e += blockDim.x) {
    const int co = e % Co, p = e / Co;
    Y[e] = to_f32(w_pre[g.fine(g.r0 + p / TW, g.c0 + p % TW) * Co + co]);
  }
  __syncthreads();
  gate_logits<T>(Y, g, Co, pp, w1, b1, w2, b2, Hd, Cout, act, slope, Hs, Ls);
  const float* mn = m + (size_t)g.n * Cout;
  const float* sn = se + (size_t)g.n * Cout;
  for (int e = threadIdx.x; e < P * Cout; e += blockDim.x) {
    const int co = e % Cout;
    float gate = expf(Ls[e] - mn[co]) / sn[co] * hw_scale;
    if (gate_max > 0.f && gate > gate_max) gate = gate_max;
    Ls[e] = gate;
  }
  __syncthreads();
  const bool broadcast = Cout == 1;
  for (int e = threadIdx.x; e < P * Co; e += blockDim.x) {
    const int co = e % Co, p = e / Co;
    Y[e] = round_cd<T>(Y[e] * Ls[(size_t)p * Cout + (broadcast ? 0 : co)]);
  }
  __syncthreads();
  store_tile<T>(Y, g, Co, true, out);
}

// dy0_s at x-side pixel (i, j) of the tile, channels c..c+3: dy0 itself
// (from D), or under upsample the 2x2 sum of dw/sqrt(2) over the fine
// pixels under coarse pixel (r0/2 + i, c0/2 + j), rounded to cd.
template <typename T>
__device__ __forceinline__ float4 dy0_skip(const T* __restrict__ dw, const float* D,
                                           const Geo& g, int Co, int i, int j, int c) {
  if (!g.up) return lds4(D + ((size_t)(i + 1) * g.TWP + j + 2) * Co + c);
  const int r = g.r0 + 2 * i, col = g.c0 + 2 * j;
  const float4 p0 = ldg4(dw + g.fine(r, col) * Co + c);
  const float4 p1 = ldg4(dw + g.fine(r, col + 1) * Co + c);
  const float4 p2 = ldg4(dw + g.fine(r + 1, col) * Co + c);
  const float4 p3 = ldg4(dw + g.fine(r + 1, col + 1) * Co + c);
  return make_float4(
      round_cd<T>(p0.x * kSqrtHalf + p1.x * kSqrtHalf + p2.x * kSqrtHalf + p3.x * kSqrtHalf),
      round_cd<T>(p0.y * kSqrtHalf + p1.y * kSqrtHalf + p2.y * kSqrtHalf + p3.y * kSqrtHalf),
      round_cd<T>(p0.z * kSqrtHalf + p1.z * kSqrtHalf + p2.z * kSqrtHalf + p3.z * kSqrtHalf),
      round_cd<T>(p0.w * kSqrtHalf + p1.w * kSqrtHalf + p2.w * kSqrtHalf + p3.w * kSqrtHalf));
}

// stage_conv_bwd: grid (blocks). Block k takes tiles k, k + blocks, ... and
// adds their weight gradients into its slice of part (blocks, wtot), laid
// out [dWr (3, C, Co) | dWc (3, Co, Co) | db_col (Co) | dWskip (C, Co)].
// du and dxs are written on x's grid (coarse under upsample).
template <typename T>
__global__ void __launch_bounds__(kThreads) stage_conv_bwd(
    const T* __restrict__ x, const T* __restrict__ dw, const float* __restrict__ a,
    const float* __restrict__ b, const T* __restrict__ wr, const T* __restrict__ wr_t,
    const T* __restrict__ wc_t, const T* __restrict__ ws_t, T* __restrict__ du,
    T* __restrict__ dxs, float* __restrict__ part, int N, int H, int W, int C, int Co,
    int TH, int TW, int act, float slope, int up) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(kBwd, C, Co, 0, 0, TH, TW);
  float* U = smem;
  float* D = U + L.r[0];
  float* V = D + L.r[1];
  float* DV = V + L.r[2];
  const int TWP = TW + 4;
  const size_t wtot =
      3 * (size_t)C * Co + 3 * (size_t)Co * Co + Co + (ws_t ? (size_t)C * Co : 0);
  float* pwr = part + blockIdx.x * wtot;
  float* pwc = pwr + 3 * (size_t)C * Co;
  float* pbc = pwc + 3 * (size_t)Co * Co;
  float* pws = pbc + Co;
  const int tx = W / TW, per_image = (H / TH) * tx, total = N * per_image;
  // the x side: TH x TW fine pixels, or (TH/2) x (TW/2) coarse ones
  const int XR = up ? TH / 2 : TH, XW = up ? TW / 2 : TW;

  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int rest = tile % per_image;
    const Geo g(tile / per_image, (rest / tx) * TH, (rest % tx) * TW, H, W, TH, TW, up);
    const size_t x0 = up ? ((size_t)g.n * (H / 2) + g.r0 / 2) * (W / 2) + g.c0 / 2
                         : g.fine(g.r0, g.c0);
    const int xrow = up ? W / 2 : W;  // x-side pixels per image row

    // 1. u and dy0 on the halo'd tile
    load_u<T>(x, a, b, g, C, act, slope, U);
    for (int e = threadIdx.x; e < (TH + 2) * TWP * Co; e += blockDim.x) {
      const int co = e % Co, p = e / Co;
      const int r = g.r0 - 1 + p / TWP, col = g.c0 - 2 + p % TWP;
      D[e] = g.inside(r, col) ? round_cd<T>(to_f32(dw[g.fine(r, col) * Co + co]) * kSqrtHalf)
                              : 0.f;
    }
    __syncthreads();

    // 2. v on TH + 2 rows (as the forward), dv on the halo'd columns
    tile_product<3>(TH + 2, TW, C, Co, wr,
        [&](int i, int j, int t, int c) { return lds4(U + ((size_t)i * TWP + j + 1 + t) * C + c); },
        [&](int i, int j0, int nq, int n0, const float (&acc)[4][8]) {
          for (int q = 0; q < nq; ++q) {
            float* dst = V + ((size_t)i * TW + j0 + q) * Co + n0;
#pragma unroll
            for (int r = 0; r < 8; ++r) dst[r] = round_cd<T>(acc[q][r]);
          }
        });
    tile_product<3>(TH, TWP, Co, Co, wc_t,
        [&](int i, int j, int t, int c) { return lds4(D + ((size_t)(i + t) * TWP + j) * Co + c); },
        [&](int i, int j0, int nq, int n0, const float (&acc)[4][8]) {
          for (int q = 0; q < nq; ++q) {
            float* dst = DV + ((size_t)i * TWP + j0 + q) * Co + n0;
#pragma unroll
            for (int r = 0; r < 8; ++r) dst[r] = round_cd<T>(acc[q][r]);
          }
        });
    __syncthreads();

    // 3. weight gradients of the two convs and the bias
    tile_wgrad<3>(TH, TW, Co, Co,
        [&](int i, int j, int t, int c) { return lds4(V + ((size_t)(i + t) * TW + j) * Co + c); },
        [&](int i, int j, int c) { return lds4(D + ((size_t)(i + 1) * TWP + j + 2) * Co + c); },
        pwc, first);
    tile_wgrad<3>(TH, TW, C, Co,
        [&](int i, int j, int t, int c) {
          return lds4(U + ((size_t)(i + 1) * TWP + j + 1 + t) * C + c);
        },
        [&](int i, int j, int c) { return lds4(DV + ((size_t)i * TWP + j + 2) * Co + c); },
        pwr, first);
    for (int co = threadIdx.x; co < Co; co += blockDim.x) {
      float s = 0.f;
      for (int i = 0; i < TH; ++i)
        for (int j = 0; j < TW; ++j)
          s += to_f32(dw[g.fine(g.r0 + i, g.c0 + j) * Co + co]) * kSqrtHalf;
      pbc[co] = first ? s : pbc[co] + s;
    }

    // 4. the skip path, on x's grid
    if (ws_t) {
      tile_wgrad<1>(XR, XW, C, Co,
          [&](int i, int j, int, int c) { return ldg4(x + (x0 + (size_t)i * xrow + j) * C + c); },
          [&](int i, int j, int c) { return dy0_skip<T>(dw, D, g, Co, i, j, c); },
          pws, first);
      tile_product<1>(XR, XW, Co, C, ws_t,
          [&](int i, int j, int, int c) { return dy0_skip<T>(dw, D, g, Co, i, j, c); },
          [&](int i, int j0, int nq, int n0, const float (&acc)[4][8]) {
            for (int q = 0; q < nq; ++q) {
              T* dst = dxs + (x0 + (size_t)i * xrow + j0 + q) * C + n0;
#pragma unroll
              for (int r = 0; r < 8; ++r) dst[r] = from_f32<T>(acc[q][r]);
            }
          });
    } else {
      for (int e = threadIdx.x; e < XR * XW * (Co / 4); e += blockDim.x) {
        const int c = (e % (Co / 4)) * 4, p = e / (Co / 4);
        const int i = p / XW, j = p % XW;
        float v[4];
        unpack(dy0_skip<T>(dw, D, g, Co, i, j, c), v);
        T* dst = dxs + (x0 + (size_t)i * xrow + j) * C + c;
#pragma unroll
        for (int r = 0; r < 4; ++r) dst[r] = from_f32<T>(v[r]);
      }
    }
    __syncthreads();  // V is read by step 3; under upsample du reuses it

    // 5. du = sum_t DV(i, j + 1 + t) . Wr[2 - t]^T, pooled to x's grid under upsample
    tile_product<3>(TH, TW, Co, C, wr_t,
        [&](int i, int j, int t, int c) {
          return lds4(DV + ((size_t)i * TWP + j + 1 + t) * Co + c);
        },
        [&](int i, int j0, int nq, int n0, const float (&acc)[4][8]) {
          for (int q = 0; q < nq; ++q) {
            if (up) {
              float* dst = V + ((size_t)i * TW + j0 + q) * C + n0;
#pragma unroll
              for (int r = 0; r < 8; ++r) dst[r] = acc[q][r];
            } else {
              T* dst = du + (x0 + (size_t)i * xrow + j0 + q) * C + n0;
#pragma unroll
              for (int r = 0; r < 8; ++r) dst[r] = from_f32<T>(acc[q][r]);
            }
          }
        });
    if (up) {
      __syncthreads();
      for (int e = threadIdx.x; e < XR * XW * C; e += blockDim.x) {
        const int c = e % C, p = e / C;
        const int i = p / XW, j = p % XW;
        const float* s = V + ((size_t)(2 * i) * TW + 2 * j) * C + c;
        const float v = (s[0] + s[C]) + (s[(size_t)TW * C] + s[(size_t)TW * C + C]);
        du[(x0 + (size_t)i * xrow + j) * C + c] = from_f32<T>(v);
      }
    }
    __syncthreads();  // the next tile overwrites every region
  }
}

// ---- bf16 on the tensor cores (the mma route) ------------------------------
//
// stage_conv_mma, stage_sigmoid_mma, stage_softmax_stats_mma and
// stage_conv_bwd_mma compute what the simt kernels above compute, for bf16
// at the (C, Co) of the templates (ops/fused_stage.py:STAGE_MMA_WIDTHS; the
// gate's Hd 16 and Cout = Co).
// Every product is mma.sync.m16n8k16 (bf16 in, f32 accumulate) on operands
// read by ldmatrix from bf16 tiles in shared memory, rows padded by 8
// elements against bank conflicts.
//
// * A conv is an implicit GEMM. M is 16 pixels (a tile row, or any 16
//   pixels: ldmatrix takes one address a row, so a tap's one-pixel or
//   one-row shift, and `upsample`'s coarse pixel under a fine one, cost only
//   an address); K is a tap's channels, summed over the 3 taps; N is Co.
//   u is held on x's grid (coarse under `upsample`) with a 1-pixel halo, so
//   an upsampled stage computes u once a coarse pixel. Each weight is
//   staged once per block as [K][N] and read either way: ldmatrix.trans for
//   the forward products, plain ldmatrix for the transposes (dv, du, dxs),
//   so the tap reversal is an index.
// * A weight gradient is a product with K = the tile's pixels: its
//   transposed operand comes from the same pixel-major tile by
//   ldmatrix.trans.
// * Blocks are persistent (8 warps; as many as fit on the card at once:
//   two an SM of the three forward passes, one of the backward), each
//   walking a strided share of the 8 x 16 tiles with the weights staged
//   once. A tile's loads overlap other work: a forward pass's in the other
//   block of the SM; the backward's are fetched by cp.async a tile ahead, under
//   the current tile's products (its registers allow one block). In the backward
//   every warp keeps its share of dWc, dWr and dWskip (three 16 x Co
//   blocks: a tap each, or the skip's one) in registers across all its
//   tiles and writes it once, at the end, to its block's slice of `part`:
//   no read-modify-write of the workspace a tile (the simt kernel's 98.5 KB
//   a tile at C = Co = 64). db_col is summed in f32 from the loads of dw.
// * The gate MLP runs on the tensor cores on w's fragments
//   (gate_logits_mma, shared by the stats and sigmoid passes).
// * stage_conv_mma and stage_sigmoid_mma stage each tile's output as bf16
//   in shared memory and write it with 16-byte stores, fine or pooled
//   2 x 2 (store_staged); the stats pass writes w_pre from its fragments.
// * Every rounding point is the simt kernels' (u, v, dy0, dv to cd; the
//   epilogue's acc -> cd, + b_col -> cd, + skip -> cd, x cd(1/sqrt 2) -> cd;
//   h to cd; the sigmoid pass's (w g) to cd; du and the `down` output
//   pooled in f32 before their rounding); only the order of the
//   f32 sums differs. One owner per output and fixed-order sums: two runs
//   are bitwise equal.
//
// Bound at ffhq_512 (batch 16, 512^2, C = Co = 64): the conv pass's 206
// GFLOP take 0.21 ms on the tensor cores' 989 TFLOP/s, its bytes 0.32 ms
// plain and 0.20 ms `up` or `down` (x or the output a quarter); the sigmoid
// pass adds the gate's 17 GFLOP; the stats pass's 223 GFLOP take 0.23 ms,
// its bytes 0.29 ms; the backward's 515 GFLOP 0.52 ms, its bytes 0.61 ms:
// the plain forms are bound by bytes, the `up` and `down` forward forms by
// operations. What holds these first mma versions from it: 8 or 16 warps an
// SM and the barriers between a tile's phases (a TMA ring with warp
// specialisation, and wgmma, are later work), and the v halo recomputed
// (10 rows for 8).

constexpr int kMmaTH = 8, kMmaTW = 16;  // a tile: 8 rows x 16 columns of fine pixels
constexpr int kMmaThreads = 256;        // 8 warps
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMmaHd = kGateHd;         // the gate's hidden width on this route
// the halo'd regions, in pixels: u (on x's grid, sized for the fine one)
// and dy0, (TH + 2) x (TW + 2); v, TH + 2 rows; dv, TW + 2 columns
constexpr int kUW = kMmaTW + 2, kUPix = (kMmaTH + 2) * kUW;
constexpr int kVPix = (kMmaTH + 2) * kMmaTW;
constexpr int kDvPix = kMmaTH * kUW;
constexpr int kTilePix = kMmaTH * kMmaTW;

__host__ __device__ constexpr bool mma_widths_ok(int C, int CO) {
  return CO == 64 && (C == 64 || C == 32);
}

// Shared-memory bytes of a block: the weights, then the tiles. The conv
// and sigmoid passes stage their output tile in v's region.
__host__ __device__ inline size_t conv_mma_bytes(int C, int CO, bool gate) {
  const size_t LC = C + 8, LO = CO + 8, LH = kMmaHd + 8;
  const size_t w = (3 * C + 3 * CO + (C != CO ? C : 0)) * LO + (gate ? CO * LH + kMmaHd * LO : 0);
  return (w + kUPix * LC + (C != CO ? kTilePix * LC : 0) + kVPix * LO) * sizeof(bf16);
}
__host__ __device__ inline size_t stats_mma_bytes(int C, int CO) {
  const size_t LC = C + 8, LO = CO + 8, LH = kMmaHd + 8;
  const size_t w = (3 * C + 3 * CO + (C != CO ? C : 0)) * LO + CO * LH + kMmaHd * LO;
  return (w + kUPix * LC + (C != CO ? kTilePix * LC : 0) + kVPix * LO) * sizeof(bf16) +
         kMmaWarps * CO * sizeof(float2);
}
__host__ __device__ inline size_t bwd_mma_bytes(int C, int CO) {
  const size_t LC = C + 8, LO = CO + 8;
  const size_t w = (3 * C + 3 * CO + (C != CO ? C : 0)) * LO;
  return (w + kUPix * C + kUPix * CO + kUPix * LC + kUPix * LO + kVPix * LO + kDvPix * LO +
          (C != CO ? kTilePix * LC : 0) + (kTilePix / 4) * LO) *
         sizeof(bf16);
}

// c[m][n] += sum over KS k-steps of A_m B, for MT m-tiles sharing B. A's
// 16 rows are pixels: this lane supplies row (lane & 15) of m-tile m as
// arow[m], at the step's channel 0. B comes from a [k][n] tile
// (ldmatrix.trans, `kn`) or from one stored [n][k] (`nk`, the transpose),
// its columns from `b`.
template <int MT, int KS, int NT>
__device__ __forceinline__ void mma_rows_kn(float (&c)[MT][NT][4], const bf16* const (&arow)[MT],
                                            const bf16* b, int ldb) {
  const int lane = threadIdx.x & 31;
  const bf16* bp = b + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ldb + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) ldsm_x4(a[m], arow[m] + ((lane >> 4) << 3) + kk * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t w[4];
      ldsm_x4_t(w, bp + kk * 16 * ldb + np * 16);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma16816(c[m][2 * np], a[m], w[0], w[1]);
        mma16816(c[m][2 * np + 1], a[m], w[2], w[3]);
      }
    }
  }
}
template <int MT, int KS, int NT>
__device__ __forceinline__ void mma_rows_nk(float (&c)[MT][NT][4], const bf16* const (&arow)[MT],
                                            const bf16* b, int ldb) {
  const int lane = threadIdx.x & 31;
  const bf16* bp = b + ((lane & 7) + ((lane >> 4) << 3)) * ldb + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) ldsm_x4(a[m], arow[m] + ((lane >> 4) << 3) + kk * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t w[4];
      ldsm_x4(w, bp + np * 16 * ldb + kk * 16);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma16816(c[m][2 * np], a[m], w[0], w[1]);
        mma16816(c[m][2 * np + 1], a[m], w[2], w[3]);
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&c)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[m][n][e] = 0.f;
}

// Eight bf16 (16 bytes) as f32, and eight f32 rounded to bf16 (to nearest even).
__device__ __forceinline__ void unpack8(const uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = bf16_lo(w[k]);
    f[2 * k + 1] = bf16_hi(w[k]);
  }
}
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}

// Where a block's tile sits, and the maps from its pixels to the tiles.
struct MmaTile {
  int n, r0, c0, H, W, sh;  // sh: 1 under upsample (x is coarse), else 0
  __device__ MmaTile(int tile, int H_, int W_, int up) : H(H_), W(W_), sh(up) {
    const int tx = W / kMmaTW, per_image = (H / kMmaTH) * tx;
    n = tile / per_image;
    const int rest = tile - n * per_image;
    r0 = (rest / tx) * kMmaTH;
    c0 = (rest - (rest / tx) * tx) * kMmaTW;
  }
  // the u tile's pixel (row-major, kUW wide) under fine pixel (R, Cc), at
  // most one pixel outside the tile (where outside the image: a zero pixel)
  __device__ int u_pix(int R, int Cc) const {
    return ((R >> sh) - (r0 >> sh) + 1) * kUW + (Cc >> sh) - (c0 >> sh) + 1;
  }
  // the x-side tile's pixel ((TH >> sh) x (TW >> sh), row-major) under
  // tile pixel (i, j)
  __device__ int x_pix(int i, int j) const { return (i >> sh) * (kMmaTW >> sh) + (j >> sh); }
  // pixel (i, j) of the x-side tile in x (and du, dxs), in pixels
  __device__ size_t x_global(int i, int j) const {
    return ((size_t)n * (H >> sh) + (r0 >> sh) + i) * (W >> sh) + (c0 >> sh) + j;
  }
  __device__ size_t fine(int r, int c) const { return ((size_t)n * H + r) * W + c; }
};

// The raw bf16 x of a tile on its halo'd tile of x's grid, ((TH >> sh) +
// 2) x ((TW >> sh) + 2) pixels (rows kUW apart, C unpadded), and the raw
// dw on the halo'd fine tile (TH + 2) x (TW + 2), by cp.async, zero-filled
// outside the image: started a tile ahead, so that the copy of the next
// tile runs under this tile's products. The caller commits and waits.
template <int C>
__device__ __forceinline__ void fetch_x(const bf16* __restrict__ x, const MmaTile& g, bf16* XR) {
  constexpr int CH = C / 8;
  const int uh = (kMmaTH >> g.sh) + 2, uw = (kMmaTW >> g.sh) + 2;
  const int xh = g.H >> g.sh, xw = g.W >> g.sh;
  const int xr0 = (g.r0 >> g.sh) - 1, xc0 = (g.c0 >> g.sh) - 1;
  for (int e = threadIdx.x; e < uh * uw * CH; e += blockDim.x) {
    const int p = e / CH, ch = (e - p * CH) * 8;
    const int ur = p / uw, uc = p - ur * uw;
    const int xr = xr0 + ur, xc = xc0 + uc;
    const bool inside = xr >= 0 && xr < xh && xc >= 0 && xc < xw;
    cp_async16(XR + (ur * kUW + uc) * C + ch,
               inside ? x + (((size_t)g.n * xh + xr) * xw + xc) * C + ch : x, inside);
  }
}
template <int CO>
__device__ __forceinline__ void fetch_dw(const bf16* __restrict__ dw, const MmaTile& g,
                                         bf16* DR) {
  constexpr int CH = CO / 8;
  for (int e = threadIdx.x; e < kUPix * CH; e += blockDim.x) {
    const int p = e / CH, ch = (e - p * CH) * 8;
    const int dr = p / kUW, dc = p - dr * kUW;
    const int r = g.r0 - 1 + dr, c = g.c0 - 1 + dc;
    const bool inside = r >= 0 && r < g.H && c >= 0 && c < g.W;
    cp_async16(DR + p * CO + ch, inside ? dw + g.fine(r, c) * CO + ch : dw, inside);
  }
}

// u = act(x a + b) rounded to bf16 on the halo'd tile (zero outside the
// image, where the fetch left zeros but act(b) need not be 0), and, where
// `X` is given, x itself on the x-side tile: from the tile fetched into XR
// (kGlobal false), or straight from x (kGlobal true; X by cp.async, which
// the caller commits and waits for).
template <int C, bool kGlobal>
__device__ void make_u(const bf16* XR, const bf16* __restrict__ x, const float* __restrict__ a,
                       const float* __restrict__ b, const MmaTile& g, int act, float slope,
                       bf16* U, bf16* X) {
  constexpr int LC = C + 8, CH = C / 8;
  const int uh = (kMmaTH >> g.sh) + 2, uw = (kMmaTW >> g.sh) + 2;
  const int xh = g.H >> g.sh, xw = g.W >> g.sh;
  const int xr0 = (g.r0 >> g.sh) - 1, xc0 = (g.c0 >> g.sh) - 1;
  const float* an = a + (size_t)g.n * C;
  const float* bn = b + (size_t)g.n * C;
  for (int e = threadIdx.x; e < uh * uw * CH; e += blockDim.x) {
    const int p = e / CH, ch = (e - p * CH) * 8;
    const int ur = p / uw, uc = p - ur * uw;
    const int xr = xr0 + ur, xc = xc0 + uc;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (xr >= 0 && xr < xh && xc >= 0 && xc < xw) {
      float f[8];
      if constexpr (kGlobal)
        unpack8(__ldg(reinterpret_cast<const uint4*>(
                    x + (((size_t)g.n * xh + xr) * xw + xc) * C + ch)), f);
      else
        unpack8(*reinterpret_cast<const uint4*>(XR + (ur * kUW + uc) * C + ch), f);
      const float4 a0 = __ldg(reinterpret_cast<const float4*>(an + ch));
      const float4 a1 = __ldg(reinterpret_cast<const float4*>(an + ch + 4));
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(bn + ch));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(bn + ch + 4));
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) f[k] = activate(f[k] * av[k] + bv[k], act, slope);
      out = pack8(f);
    }
    *reinterpret_cast<uint4*>(U + (ur * kUW + uc) * LC + ch) = out;
  }
  if (X) {
    const int xr = kMmaTH >> g.sh, xwt = kMmaTW >> g.sh;
    for (int e = threadIdx.x; e < xr * xwt * CH; e += blockDim.x) {
      const int p = e / CH, ch = (e - p * CH) * 8;
      const int i = p / xwt, j = p - i * xwt;
      if constexpr (kGlobal)
        cp_async16(X + p * LC + ch, x + g.x_global(i, j) * C + ch, true);
      else
        *reinterpret_cast<uint4*>(X + p * LC + ch) =
            *reinterpret_cast<const uint4*>(XR + ((i + 1) * kUW + j + 1) * C + ch);
    }
  }
}

// Row i of v (image row r0 - 1 + i; zero outside the image, as u is there)
// on the tile's 16 columns, the (1,3) conv of u, rounded to bf16 into
// V [(TH + 2) * TW][CO + 8]. One m-tile, by one warp.
template <int C, int CO>
__device__ __forceinline__ void v_row_mma(const bf16* U, const bf16* Wr, const MmaTile& g, int i,
                                          bf16* V) {
  constexpr int LC = C + 8, LO = CO + 8;
  const int lane = threadIdx.x & 31;
  float acc[1][CO / 8][4];
  zero_acc(acc);
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const bf16* const arow[1] = {U + g.u_pix(g.r0 - 1 + i, g.c0 + (lane & 15) + t - 1) * LC};
    mma_rows_kn<1, C / 16, CO / 8>(acc, arow, Wr + t * C * LO, LO);
  }
  const int q = lane >> 2, col = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < CO / 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(V + (i * kMmaTW + q + 8 * h) * LO + nt * 8 + col) =
          pack_bf16(acc[0][nt][2 * h], acc[0][nt][2 * h + 1]);
}

// The conv block's w on row i of the tile (the forward's body, _stage_tile,
// on the mma route), from v's rows i..i + 2 in V, into this warp's
// fragments w[nt][e] (pixel (i, (lane >> 2) + 8 (e >> 1)), channel nt * 8
// + 2 (lane & 3) + (e & 1)), rounded as conv_tile rounds. The skip is x
// itself (C == CO), read from x in device memory (in L2: the tile's u was
// just made from it), or (x . Ws)_cd with x from the x-side tile X. Written
// for the stats pass, and for stage_conv and stage_sigmoid to call
// unchanged.
template <int C, int CO>
__device__ __forceinline__ void w_row_mma(const bf16* V, const bf16* X,
                                          const bf16* __restrict__ x, const bf16* Wc,
                                          const bf16* Ws, const float* __restrict__ bc,
                                          const MmaTile& g, int i, float (&w)[CO / 8][4]) {
  constexpr int LC = C + 8, LO = CO + 8;
  const int lane = threadIdx.x & 31;
  float acc[1][CO / 8][4];
  zero_acc(acc);
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const bf16* const arow[1] = {V + ((i + t) * kMmaTW + (lane & 15)) * LO};
    mma_rows_kn<1, CO / 16, CO / 8>(acc, arow, Wc + t * CO * LO, LO);
  }
  float sk[1][CO / 8][4];
  if constexpr (C != CO) {
    zero_acc(sk);
    const bf16* const arow[1] = {X + g.x_pix(i, lane & 15) * LC};
    mma_rows_kn<1, C / 16, CO / 8>(sk, arow, Ws, LO);
  }
  const float sqh = round_cd<bf16>(kSqrtHalf);
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < CO / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = (lane >> 2) + 8 * (e >> 1), n = nt * 8 + col + (e & 1);
      float skip;
      if constexpr (C != CO) {
        skip = round_cd<bf16>(sk[0][nt][e]);
      } else {
        skip = __bfloat162float(x[g.x_global(i >> g.sh, q >> g.sh) * C + n]);
      }
      const float y = round_cd<bf16>(round_cd<bf16>(acc[0][nt][e]) + round_cd<bf16>(bc[n]));
      w[nt][e] = round_cd<bf16>(round_cd<bf16>(y + skip) * sqh);
    }
}

// The gate logits l = h W2 + b2, h = (act(w W1 + pos_proj + b1))_cd, of
// the warp's row i of the tile (16 pixels) on the tensor cores
// (gate_mlp_mma): w (in w_row_mma's layout) handed on as A fragments; l,
// f32, in w's layout. W1 [CO][Hd + 8] and W2 [Hd][CO + 8] are staged; pp
// is pos_proj (H W, Hd) at the fine resolution.
template <int CO>
__device__ __forceinline__ void gate_logits_mma(const float (&w)[CO / 8][4], const bf16* W1,
                                                const bf16* W2, const float* __restrict__ pp,
                                                const float* __restrict__ b1,
                                                const float* __restrict__ b2, const MmaTile& g,
                                                int i, int act, float slope,
                                                float (&l)[CO / 8][4]) {
  const int q = (threadIdx.x & 31) >> 2;
  uint32_t wa[CO / 16][4];
  to_a_frags(wa, w);
  const float* ppl = pp + ((size_t)(g.r0 + i) * g.W + g.c0 + q) * kMmaHd;
  float u[2][4], h[2][4];
  gate_mlp_mma<CO / 16, CO / 8>(wa, W1, W2, ppl, ppl + 8 * kMmaHd, b1, b2, act, slope, u, h, l);
}

// The block's output tile Y [kTilePix][CO + 8] (bf16, row-major pixels) to
// out, one thread a 16-byte chunk of an output pixel, consecutive threads
// on consecutive addresses: at the fine resolution, or under `down` pooled
// 2 x 2 in f32 in store_tile's order, ((y00 + y01) + (y10 + y11)) * 0.25
// with (y00, y01) the upper row, and rounded once.
template <int CO>
__device__ __forceinline__ void store_staged(const bf16* Y, const MmaTile& g, int down,
                                             bf16* __restrict__ out) {
  constexpr int LO = CO + 8, CH = CO / 8;
  if (!down) {
    for (int e = threadIdx.x; e < kTilePix * CH; e += blockDim.x) {
      const int p = e / CH, ch = (e - p * CH) * 8;
      *reinterpret_cast<uint4*>(out + g.fine(g.r0 + p / kMmaTW, g.c0 + p % kMmaTW) * CO + ch) =
          *reinterpret_cast<const uint4*>(Y + p * LO + ch);
    }
    return;
  }
  constexpr int PW = kMmaTW / 2;  // pooled pixels a tile row
  for (int e = threadIdx.x; e < (kTilePix / 4) * CH; e += blockDim.x) {
    const int p = e / CH, ch = (e - p * CH) * 8;
    const int pi = p / PW, pj = p - pi * PW;
    const bf16* y = Y + ((2 * pi) * kMmaTW + 2 * pj) * LO + ch;
    float y00[8], y01[8], y10[8], y11[8], s[8];
    unpack8(*reinterpret_cast<const uint4*>(y), y00);
    unpack8(*reinterpret_cast<const uint4*>(y + LO), y01);
    unpack8(*reinterpret_cast<const uint4*>(y + kMmaTW * LO), y10);
    unpack8(*reinterpret_cast<const uint4*>(y + (kMmaTW + 1) * LO), y11);
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = ((y00[k] + y01[k]) + (y10[k] + y11[k])) * 0.25f;
    const size_t o =
        (((size_t)g.n * (g.H / 2) + g.r0 / 2 + pi) * (g.W / 2) + g.c0 / 2 + pj) * CO + ch;
    *reinterpret_cast<uint4*>(out + o) = pack8(s);
  }
}

// stage_conv_mma (kGate false) and stage_sigmoid_mma (kGate true): block k
// takes tiles k, k + gridDim.x, ... Per tile: u and x in; v on 10 rows,
// spread over the 8 warps; then each warp's row of w through w_row_mma,
// as in the stats pass; under the gate its logits by gate_logits_mma and
// y = (w min(2 sigmoid(l), gate_max))_cd; once every warp is done with v,
// the rows go to a bf16 tile in v's region, which the block writes out
// (store_staged). The next tile's make_u writes U and X only, and its v
// comes after a barrier that every thread reaches only once its stores
// are issued, so the staged tile needs no barrier of its own at the end.
template <int C, int CO, bool kGate>
__device__ __forceinline__ void conv_tiles_mma(
    const bf16* __restrict__ x, const float* __restrict__ a, const float* __restrict__ b,
    const bf16* __restrict__ wr, const bf16* __restrict__ wc, const float* __restrict__ bc,
    const bf16* __restrict__ ws, const float* __restrict__ pp, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2, const float* __restrict__ b2,
    bf16* __restrict__ out, int N, int H, int W, int act, float slope, float gate_max, int up,
    int down) {
  static_assert(mma_widths_ok(C, CO), "no mma template for these widths");
  static_assert(kTilePix <= kVPix, "the output tile must fit in v's region");
  constexpr int LC = C + 8, LO = CO + 8, LH = kMmaHd + 8, NT = CO / 8;
  extern __shared__ float4 smem4[];
  bf16* Wr = reinterpret_cast<bf16*>(smem4);     // [3][C][LO]
  bf16* Wc = Wr + 3 * C * LO;                    // [3][CO][LO]
  bf16* Ws = Wc + 3 * CO * LO;                   // [C][LO] (1x1 skip)
  bf16* W1 = Ws + (C != CO ? C * LO : 0);        // [CO][LH] (gate)
  bf16* W2 = W1 + (kGate ? CO * LH : 0);         // [Hd][LO] (gate)
  bf16* U = W2 + (kGate ? kMmaHd * LO : 0);      // [kUPix][LC]
  bf16* X = U + kUPix * LC;                      // [kTilePix][LC] (1x1 skip)
  bf16* V = X + (C != CO ? kTilePix * LC : 0);   // [kVPix][LO]
  bf16* Y = V;                                   // [kTilePix][LO]: the output tile

  stage_rows(Wr, wr, 3 * C, CO, LO);
  stage_rows(Wc, wc, 3 * CO, CO, LO);
  if constexpr (C != CO) stage_rows(Ws, ws, C, CO, LO);
  if constexpr (kGate) {
    stage_rows(W1, w1, CO, kMmaHd, LH);
    stage_rows(W2, w2, kMmaHd, CO, LO);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 2, col = 2 * (lane & 3);
  const int total = N * (H / kMmaTH) * (W / kMmaTW);
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const MmaTile g(tile, H, W, up);
    make_u<C, true>(nullptr, x, a, b, g, act, slope, U, C != CO ? X : nullptr);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int i = warp; i < kMmaTH + 2; i += kMmaWarps) v_row_mma<C, CO>(U, Wr, g, i, V);
    __syncthreads();

    float w[NT][4];
    w_row_mma<C, CO>(V, X, x, Wc, Ws, bc, g, warp, w);
    if constexpr (kGate) {
      float l[NT][4];
      gate_logits_mma<CO>(w, W1, W2, pp, b1, b2, g, warp, act, slope, l);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[nt][e] = round_cd<bf16>(w[nt][e] * sigmoid_gate_of(l[nt][e], gate_max));
    }
    __syncthreads();  // every warp is done with V
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(Y + (warp * kMmaTW + q + 8 * h) * LO + nt * 8 + col) =
            pack_bf16(w[nt][2 * h], w[nt][2 * h + 1]);
    __syncthreads();
    store_staged<CO>(Y, g, down, out);
  }
}

// stage_conv on the tensor cores: out is fine, or pooled under `down`.
template <int C, int CO>
__global__ void __launch_bounds__(kMmaThreads, 2) stage_conv_mma(
    const bf16* __restrict__ x, const float* __restrict__ a, const float* __restrict__ b,
    const bf16* __restrict__ wr, const bf16* __restrict__ wc, const float* __restrict__ bc,
    const bf16* __restrict__ ws, bf16* __restrict__ out, int N, int H, int W, int act,
    float slope, int up, int down) {
  conv_tiles_mma<C, CO, false>(x, a, b, wr, wc, bc, ws, nullptr, nullptr, nullptr, nullptr,
                               nullptr, out, N, H, W, act, slope, 0.f, up, down);
}

// stage_sigmoid on the tensor cores (the gate per channel, Cout = CO).
template <int C, int CO>
__global__ void __launch_bounds__(kMmaThreads, 2) stage_sigmoid_mma(
    const bf16* __restrict__ x, const float* __restrict__ a, const float* __restrict__ b,
    const bf16* __restrict__ wr, const bf16* __restrict__ wc, const float* __restrict__ bc,
    const bf16* __restrict__ ws, const float* __restrict__ pp, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2, const float* __restrict__ b2,
    bf16* __restrict__ out, int N, int H, int W, int act, float slope, float gate_max, int up,
    int down) {
  conv_tiles_mma<C, CO, true>(x, a, b, wr, wc, bc, ws, pp, w1, b1, w2, b2, out, N, H, W, act,
                              slope, gate_max, up, down);
}

// (m, s) <- the merge of two partial softmax statistics
__device__ __forceinline__ void stats_merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

// stage_softmax_stats on the tensor cores. Per tile: u and x in; v on 10
// rows, spread over the 8 warps; then each warp takes one row of 16 pixels
// through w (stored as w_pre), the gate MLP h = (act(w W1 + pos_proj +
// b1))_cd, l = h W2 + b2 on the tensor cores (w and h handed on as A
// fragments in registers), and the per-channel (max, sum-exp) of its 16
// pixels by warp shuffles; the 8 warps' partials are merged in a fixed
// order into the tile's entry of (part_m, part_s), (N, tiles, CO), which
// softmax_stats_merge folds.
template <int C, int CO>
__global__ void __launch_bounds__(kMmaThreads, 2) stage_softmax_stats_mma(
    const bf16* __restrict__ x, const float* __restrict__ a, const float* __restrict__ b,
    const bf16* __restrict__ wr, const bf16* __restrict__ wc, const float* __restrict__ bc,
    const bf16* __restrict__ ws, const float* __restrict__ pp, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2, const float* __restrict__ b2,
    bf16* __restrict__ w_pre, float* __restrict__ part_m, float* __restrict__ part_s, int N,
    int H, int W, int act, float slope, int up) {
  static_assert(mma_widths_ok(C, CO), "no mma template for these widths");
  constexpr int LO = CO + 8, LH = kMmaHd + 8, NT = CO / 8;
  extern __shared__ float4 smem4[];
  bf16* Wr = reinterpret_cast<bf16*>(smem4);  // [3][C][LO]
  bf16* Wc = Wr + 3 * C * LO;                 // [3][CO][LO]
  bf16* Ws = Wc + 3 * CO * LO;                // [C][LO] (1x1 skip)
  bf16* W1 = Ws + (C != CO ? C * LO : 0);     // [CO][LH]
  bf16* W2 = W1 + CO * LH;                    // [Hd][LO]
  bf16* U = W2 + kMmaHd * LO;                 // [kUPix][C + 8]
  bf16* X = U + kUPix * (C + 8);              // [kTilePix][C + 8] (1x1 skip)
  bf16* V = X + (C != CO ? kTilePix * (C + 8) : 0);        // [kVPix][LO]
  float2* St = reinterpret_cast<float2*>(V + kVPix * LO);  // [warps][CO]

  stage_rows(Wr, wr, 3 * C, CO, LO);
  stage_rows(Wc, wc, 3 * CO, CO, LO);
  if constexpr (C != CO) stage_rows(Ws, ws, C, CO, LO);
  stage_rows(W1, w1, CO, kMmaHd, LH);
  stage_rows(W2, w2, kMmaHd, CO, LO);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 2, col = 2 * (lane & 3);
  const int total = N * (H / kMmaTH) * (W / kMmaTW);
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const MmaTile g(tile, H, W, up);
    make_u<C, true>(nullptr, x, a, b, g, act, slope, U, C != CO ? X : nullptr);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int i = warp; i < kMmaTH + 2; i += kMmaWarps) v_row_mma<C, CO>(U, Wr, g, i, V);
    __syncthreads();

    // this warp's row: w, stored as w_pre; the gate logits; their statistics
    const int i = warp;
    float w[NT][4];
    w_row_mma<C, CO>(V, X, x, Wc, Ws, bc, g, i, w);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(w_pre + g.fine(g.r0 + i, g.c0 + q + 8 * h) * CO + nt * 8 +
                                     col) = pack_bf16(w[nt][2 * h], w[nt][2 * h + 1]);
    float l[NT][4];
    gate_logits_mma<CO>(w, W1, W2, pp, b1, b2, g, i, act, slope, l);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nt * 8 + col + e;
        const float l0 = l[nt][e], l1 = l[nt][2 + e];
        float m = fmaxf(l0, l1);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        float s = expf(l0 - m) + expf(l1 - m);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane < 4) St[warp * CO + n] = make_float2(m, s);
      }
    __syncthreads();
    // the tile's statistics: the warps' partials in a fixed order. The
    // next tile writes U, X and V, which no warp reads now; St is written
    // again only after two more barriers.
    for (int n = threadIdx.x; n < CO; n += blockDim.x) {
      float m = St[n].x, s = St[n].y;
      for (int k = 1; k < kMmaWarps; ++k) stats_merge(m, s, St[k * CO + n].x, St[k * CO + n].y);
      part_m[(size_t)tile * CO + n] = m;  // (N, tiles, CO): tile = n * tiles + its index
      part_s[(size_t)tile * CO + n] = s;
    }
  }
}

// stage_softmax_apply_pool on the tensor cores, bf16 at (Co, Hd, Cout) =
// (64, 16, 64): what stage_softmax_apply_pool<bf16> computes, with its
// rounding points (h and y = (w g) to bf16, the 2 x 2 pool in f32 in
// store_tile's order, ((y00 + y01) + (y10 + y11)) * 0.25, rounded once).
// It reads w_pre (537 MB at batch 16 and 512^2) and writes a quarter of
// that: bound by bytes, so the design keeps loads in flight and the
// block's warps out of each other's way.
// * Persistent blocks of 8 warps walk the 8 x 16 tiles, tile t being
//   spatial tile t / N of image t % N: the images of one spatial tile run
//   side by side and read its pos_proj from L2 (it would be read from
//   device memory once an image with the images outermost).
// * A warp owns 2 rows x 8 columns of each tile (16 pixels, one m-tile:
//   fragment row r is pixel (r / 8, r % 8)), so a 2 x 2 pool is a lane
//   (rows r and r + 8) and its neighbour lane ^ 4 (the next column): no
//   block barrier after the weights are staged.
// * The warp's next tile is fetched by cp.async (its 16 pixels of w_pre,
//   2 KB, and of pos_proj, 1 KB) under the current tile's work, two stages
//   a warp.
// * w's A fragments by ldmatrix; gate_mlp_mma on them, pos_proj from the
//   staged rows; g = min(exp(l - m) / se HW, gate_max) and y = (w g)_cd on
//   l's C fragments, w read again from the staged tile in their layout
//   (the fragments would hold 16 registers through the gate MLP, and the
//   kernel fits three blocks an SM at 80), with (m, se) of the warp's
//   image staged in its region when the image changes.
// * The pooled 4 pixels x 64 channels (512 B, contiguous in out) are
//   staged in the warp's region and written with 16-byte stores.
// One owner per output: two runs are bitwise equal.
constexpr int kApCo = 64;                                     // Co = Cout; Hd: kMmaHd
constexpr int kApLO = kApCo + 8, kApLH = kMmaHd + 8, kApLP = kMmaHd + 4;
constexpr int kApStageBytes = 16 * kApLO * 2 + 16 * kApLP * 4;  // w [16][kApLO], pp [16][kApLP]
// two stages, (m, se) [Co], the pooled pixels [4][kApLO]
constexpr int kApWarpBytes = 2 * kApStageBytes + kApCo * 8 + 4 * kApLO * 2;
constexpr int kApBlocks = 3;                                    // blocks an SM it is built for

__host__ __device__ constexpr size_t apply_pool_mma_bytes() {
  return (size_t)(kApCo * kApLH + kMmaHd * kApLO) * sizeof(bf16) +
         (size_t)kMmaWarps * kApWarpBytes;
}

// w_pre and pos_proj of a warp's 16 pixels, rows r0 and r0 + 1 x columns
// c0..c0 + 7 of image n (row r of Ws and Ps: pixel (r0 + r / 8, c0 + r % 8)),
// by cp.async; the caller commits.
__device__ __forceinline__ void fetch_pool_pixels(const bf16* __restrict__ w_pre,
                                                  const float* __restrict__ pp, int n, int r0,
                                                  int c0, int H, int W, bf16* Ws, float* Ps) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = lane + 32 * k, r = e >> 3, ch = (e & 7) << 3;
    cp_async16(Ws + r * kApLO + ch,
               w_pre + (((size_t)n * H + r0 + (r >> 3)) * W + c0 + (r & 7)) * kApCo + ch, true);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int e = lane + 32 * k, r = e >> 2, ch = (e & 3) << 2;
    cp_async16(Ps + r * kApLP + ch,
               pp + ((size_t)(r0 + (r >> 3)) * W + c0 + (r & 7)) * kMmaHd + ch, true);
  }
}

__global__ void __launch_bounds__(kMmaThreads, kApBlocks) stage_softmax_apply_pool_mma(
    const bf16* __restrict__ w_pre, const float* __restrict__ pp, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ m, const float* __restrict__ se, bf16* __restrict__ out, int N,
    int H, int W, int act, float slope, float hw_scale, float gate_max) {
  extern __shared__ float4 smem4[];
  bf16* W1 = reinterpret_cast<bf16*>(smem4);  // [Co][kApLH]
  bf16* W2 = W1 + kApCo * kApLH;              // [Hd][kApLO]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 2, col = 2 * (lane & 3);
  char* region = reinterpret_cast<char*>(W2 + kMmaHd * kApLO) + warp * kApWarpBytes;
  float4* MS = reinterpret_cast<float4*>(region + 2 * kApStageBytes);  // (m, se) of channel pairs
  bf16* Os = reinterpret_cast<bf16*>(MS + kApCo / 2);                   // [4][kApLO] pooled
  const int dr = 2 * (warp >> 1), dc = 8 * (warp & 1);  // the warp's pixels in a tile
  const int tx = W / kMmaTW, tiles = N * (H / kMmaTH) * tx;
  const auto stage_w = [&](int k) {
    return reinterpret_cast<bf16*>(region + (k & 1) * kApStageBytes);
  };
  const auto stage_p = [&](int k) {
    return reinterpret_cast<float*>(region + (k & 1) * kApStageBytes + 16 * kApLO * 2);
  };
  const auto fetch = [&](int t, int k) {
    const int sp = t / N, n = t - sp * N, ty = sp / tx;
    fetch_pool_pixels(w_pre, pp, n, ty * kMmaTH + dr, (sp - ty * tx) * kMmaTW + dc, H, W,
                      stage_w(k), stage_p(k));
  };
  if ((int)blockIdx.x < tiles) fetch(blockIdx.x, 0);
  cp_async_commit();
  stage_rows(W1, w1, kApCo, kMmaHd, kApLH);
  stage_rows(W2, w2, kMmaHd, kApCo, kApLO);
  __syncthreads();

  int image = -1;
  for (int t = blockIdx.x, k = 0; t < tiles; t += gridDim.x, ++k) {
    if (t + (int)gridDim.x < tiles) fetch(t + gridDim.x, k + 1);
    cp_async_commit();
    const int sp = t / N, n = t - sp * N, ty = sp / tx;
    const int r0 = ty * kMmaTH + dr, c0 = (sp - ty * tx) * kMmaTW + dc;
    if (n != image) {  // lane: channels 2 lane and 2 lane + 1
      const float2 mv = __ldg(reinterpret_cast<const float2*>(m + (size_t)n * kApCo) + lane);
      const float2 sv = __ldg(reinterpret_cast<const float2*>(se + (size_t)n * kApCo) + lane);
      MS[lane] = make_float4(mv.x, sv.x, mv.y, sv.y);
      image = n;
    }
    cp_async_wait_one();  // this tile's w and pos_proj
    __syncwarp();
    bf16* Ws = stage_w(k);
    const float* Ps = stage_p(k);

    uint32_t wa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) frag_a(wa[kk], Ws, kApLO, 0, kk * 16);
    float u[2][4], h[2][4], l[8][4];
    gate_mlp_mma<4, 8>(wa, W1, W2, Ps + q * kApLP, Ps + (q + 8) * kApLP, b1, b2, act, slope, u,
                       h, l);

    // y = (w g)_cd on l's fragments (w of rows q and q + 8 from Ws), then
    // the pool with lane ^ 4; one lane of the two writes each n-tile
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float4 ms = MS[(nt * 8 + col) >> 1];
      const uint32_t wt = *reinterpret_cast<const uint32_t*>(Ws + q * kApLO + nt * 8 + col);
      const uint32_t wb = *reinterpret_cast<const uint32_t*>(Ws + (q + 8) * kApLO + nt * 8 + col);
      const float wv[4] = {bf16_lo(wt), bf16_hi(wt), bf16_lo(wb), bf16_hi(wb)};
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float g = expf(l[nt][e] - (e & 1 ? ms.z : ms.x)) / (e & 1 ? ms.w : ms.y) * hw_scale;
        if (gate_max > 0.f && g > gate_max) g = gate_max;
        y[e] = wv[e] * g;
      }
      const uint32_t top = pack_bf16(y[0], y[1]), bot = pack_bf16(y[2], y[3]);
      const uint32_t top2 = __shfl_xor_sync(0xffffffffu, top, 4);
      const uint32_t bot2 = __shfl_xor_sync(0xffffffffu, bot, 4);
      const float s0 = ((bf16_lo(top) + bf16_lo(top2)) + (bf16_lo(bot) + bf16_lo(bot2))) * 0.25f;
      const float s1 = ((bf16_hi(top) + bf16_hi(top2)) + (bf16_hi(bot) + bf16_hi(bot2))) * 0.25f;
      if ((q & 1) == (nt & 1))
        *reinterpret_cast<uint32_t*>(Os + (q >> 1) * kApLO + nt * 8 + col) = pack_bf16(s0, s1);
    }
    __syncwarp();
    {  // pooled row r0 / 2, columns c0 / 2..c0 / 2 + 3: 512 contiguous bytes
      const int p = lane >> 3, ch = (lane & 7) << 3;
      *reinterpret_cast<uint4*>(
          out + (((size_t)n * (H >> 1) + (r0 >> 1)) * (W >> 1) + (c0 >> 1) + p) * kApCo + ch) =
          *reinterpret_cast<const uint4*>(Os + p * kApLO + ch);
    }
    __syncwarp();  // the fetch two tiles on overwrites this stage, the next tile Os
  }
  cp_async_wait_all();
}

// stage_conv_bwd on the tensor cores: block k takes tiles k, k + gridDim.x,
// ... Per tile: u, x (1x1 skip), dy0 = (dw / sqrt 2)_cd on the halo'd tile
// (db_col summed from the same loads) and, under upsample, dy0_s in; v on
// 10 rows and dv on 8 rows x 18 columns (16, and the two halo columns of
// all 8 rows as one more m-tile), spread over the warps; the weight
// gradients into each warp's registers (warps 0-3: dWc, 16 of its input
// channels, all three taps; 4-7: dWr alike, or at C 32 two warps of dWr
// and two of dWskip); du by row pairs (pooled 2 x 2 in f32 between a lane
// and its neighbour under upsample); dxs. At the end each block writes
// [dWr | dWc | db_col | dWskip] once to its slice of part.
template <int C, int CO>
__global__ void __launch_bounds__(kMmaThreads, 1) stage_conv_bwd_mma(
    const bf16* __restrict__ x, const bf16* __restrict__ dw, const float* __restrict__ a,
    const float* __restrict__ b, const bf16* __restrict__ wr, const bf16* __restrict__ wc,
    const bf16* __restrict__ ws, bf16* __restrict__ du, bf16* __restrict__ dxs,
    float* __restrict__ part, int N, int H, int W, int act, float slope, int up) {
  static_assert(mma_widths_ok(C, CO), "no mma template for these widths");
  constexpr bool kSkip = C != CO;
  constexpr int LC = C + 8, LO = CO + 8, NT = CO / 8, CH = CO / 8;
  extern __shared__ float4 smem4[];
  bf16* Wr = reinterpret_cast<bf16*>(smem4);  // [3][C][LO]
  bf16* Wc = Wr + 3 * C * LO;                 // [3][CO][LO]
  bf16* Ws = Wc + 3 * CO * LO;                // [C][LO] (1x1 skip)
  bf16* U = Ws + (kSkip ? C * LO : 0);        // [kUPix][LC]
  bf16* D = U + kUPix * LC;                   // [kUPix][LO]: dy0, fine, halo'd
  bf16* V = D + kUPix * LO;                   // [kVPix][LO]
  bf16* DV = V + kVPix * LO;                  // [kDvPix][LO]
  bf16* X = DV + kDvPix * LO;                 // [kTilePix][LC] (1x1 skip)
  bf16* DS = X + (kSkip ? kTilePix * LC : 0); // [kTilePix / 4][LO]: dy0_s under upsample
  bf16* XR = DS + (kTilePix / 4) * LO;        // [kUPix][C]: the fetched x
  bf16* DR = XR + kUPix * C;                  // [kUPix][CO]: the fetched dw

  stage_rows(Wr, wr, 3 * C, CO, LO);
  stage_rows(Wc, wc, 3 * CO, CO, LO);
  if constexpr (kSkip) stage_rows(Ws, ws, C, CO, LO);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this warp's weight-gradient block: role 0 dWc, 1 dWr, 2 dWskip; its
  // input channels mt * 16..; taps 3 (the skip's one)
  const int role = warp < 4 ? 0 : (warp - 4 < C / 16 ? 1 : 2);
  const int mt = role == 0 ? warp : (role == 1 ? warp - 4 : warp - 4 - C / 16);
  const int ntap = role == 2 ? 1 : 3;
  float wacc[3][NT][4];
  zero(wacc[0]);
  zero(wacc[1]);
  zero(wacc[2]);
  float dbacc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // channels (tid % CH) * 8..

  const int total = N * (H / kMmaTH) * (W / kMmaTW);
  if ((int)blockIdx.x < total) {
    const MmaTile g(blockIdx.x, H, W, up);
    fetch_x<C>(x, g, XR);
    fetch_dw<CO>(dw, g, DR);
  }
  cp_async_commit();
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const MmaTile g(tile, H, W, up);
    const int xr = kMmaTH >> g.sh, xwt = kMmaTW >> g.sh;  // the x-side tile

    // 1. from the fetched x and dw: u (and x), dy0 on the halo'd fine tile
    //    (zero outside the image, as the fetch left it), dy0_s under upsample
    cp_async_wait_all();
    __syncthreads();
    make_u<C, false>(XR, x, a, b, g, act, slope, U, kSkip ? X : nullptr);
    for (int e = threadIdx.x; e < kUPix * CH; e += blockDim.x) {
      const int p = e / CH, ch = (e - p * CH) * 8;
      const int dr = p / kUW, dc = p - dr * kUW;
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(DR + p * CO + ch), f);
      const bool interior = dr >= 1 && dr <= kMmaTH && dc >= 1 && dc <= kMmaTW;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        f[k] *= kSqrtHalf;
        if (interior) dbacc[k] += f[k];
      }
      *reinterpret_cast<uint4*>(D + p * LO + ch) = pack8(f);
    }
    if (g.sh) {
      for (int e = threadIdx.x; e < xr * xwt * CH; e += blockDim.x) {
        const int p = e / CH, ch = (e - p * CH) * 8;
        const int i = p / xwt, j = p - i * xwt;
        const bf16* d = DR + ((2 * i + 1) * kUW + 2 * j + 1) * CO + ch;  // fine (2i, 2j)
        float f0[8], f1[8], f2[8], f3[8], s[8];
        unpack8(*reinterpret_cast<const uint4*>(d), f0);
        unpack8(*reinterpret_cast<const uint4*>(d + CO), f1);
        unpack8(*reinterpret_cast<const uint4*>(d + kUW * CO), f2);
        unpack8(*reinterpret_cast<const uint4*>(d + kUW * CO + CO), f3);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          s[k] = f0[k] * kSqrtHalf + f1[k] * kSqrtHalf + f2[k] * kSqrtHalf + f3[k] * kSqrtHalf;
        *reinterpret_cast<uint4*>(DS + p * LO + ch) = pack8(s);
      }
    }
    __syncthreads();
    // the next tile's x and dw, under this tile's products
    if (tile + (int)gridDim.x < total) {
      const MmaTile gn(tile + gridDim.x, H, W, up);
      fetch_x<C>(x, gn, XR);
      fetch_dw<CO>(dw, gn, DR);
    }
    cp_async_commit();

    // 2. v on 10 rows; dv on 8 rows x 18 columns, dv[i] = sum_t dy0[i + t - 1] . Wc[2 - t]^T
    for (int unit = warp; unit < (kMmaTH + 2) + kMmaTH + 1; unit += kMmaWarps) {
      if (unit < kMmaTH + 2) {
        v_row_mma<C, CO>(U, Wr, g, unit, V);
        continue;
      }
      const int k = unit - (kMmaTH + 2);  // dv row k, or (k == TH) the halo columns
      const int li = k < kMmaTH ? k : (lane & 7);  // this lane's A pixel: DV row, column
      const int lc = k < kMmaTH ? (lane & 15) + 1 : ((lane & 15) < 8 ? 0 : kUW - 1);
      float acc[1][NT][4];
      zero_acc(acc);
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const bf16* const arow[1] = {D + ((li + t) * kUW + lc) * LO};
        mma_rows_nk<1, CO / 16, NT>(acc, arow, Wc + (2 - t) * CO * LO, LO);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qq = (lane >> 2) + 8 * h;
        const int pi = k < kMmaTH ? k : (qq & 7);
        const int pc = k < kMmaTH ? qq + 1 : (qq < 8 ? 0 : kUW - 1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          *reinterpret_cast<uint32_t*>(DV + (pi * kUW + pc) * LO + nt * 8 + 2 * (lane & 3)) =
              pack_bf16(acc[0][nt][2 * h], acc[0][nt][2 * h + 1]);
      }
    }
    __syncthreads();

    // 3. the weight gradients, K = the tile's pixels 16 at a time:
    //    dWc[t] += v[i + t - 1]^T dy0, dWr[t] += u[:, j + t - 1]^T dv,
    //    dWskip += x^T dy0_s
    {
      const int kbs = role == 2 && g.sh ? (xr * xwt) / 16 : kMmaTH;
      const int ka = (lane & 7) + ((lane >> 4) << 3);         // A's pixel in the k-block
      const int kbp = (lane & 7) + (((lane >> 3) & 1) << 3);  // B's pixel
      const int ach = mt * 16 + (((lane >> 3) & 1) << 3);
      const int bch = (lane >> 4) << 3;
      for (int kb = 0; kb < kbs; ++kb) {
        const bf16* bp;
        if (role == 1) bp = DV + (kb * kUW + kbp + 1) * LO;
        else if (role == 2 && g.sh) bp = DS + (kb * 16 + kbp) * LO;
        else bp = D + ((kb + 1) * kUW + kbp + 1) * LO;
        uint32_t bf[NT / 2][4];
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) ldsm_x4_t(bf[np], bp + bch + np * 16);
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          if (t < ntap) {
            const bf16* ap;
            if (role == 0) ap = V + ((kb + t) * kMmaTW + ka) * LO + ach;
            else if (role == 1) ap = U + g.u_pix(g.r0 + kb, g.c0 + ka + t - 1) * LC + ach;
            else ap = X + (g.sh ? kb * 16 + ka : kb * kMmaTW + ka) * LC + ach;
            uint32_t af[4];
            ldsm_x4_t(af, ap);
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
              mma16816(wacc[t][2 * np], af, bf[np][0], bf[np][1]);
              mma16816(wacc[t][2 * np + 1], af, bf[np][2], bf[np][3]);
            }
          }
        }
      }
    }

    // 4. du = sum_t dv[:, j + t - 1] . Wr[2 - t]^T: warp w takes rows
    //    2 (w / 2) and 2 (w / 2) + 1, the half w % 2 of the channels; under
    //    upsample pooled 2 x 2 in f32, (left + right) + (left + right) below
    {
      constexpr int NH = C / 16;  // n-tiles of a half
      const int rp = warp >> 1, nh = warp & 1;
      float acc[2][NH][4];
      zero_acc(acc);
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const bf16* const arow[2] = {DV + ((2 * rp) * kUW + (lane & 15) + t) * LO,
                                     DV + ((2 * rp + 1) * kUW + (lane & 15) + t) * LO};
        mma_rows_nk<2, CO / 16, NH>(acc, arow, Wr + ((2 - t) * C + nh * (C / 2)) * LO, LO);
      }
      const int col0 = nh * (C / 2) + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qq = (lane >> 2) + 8 * h;
#pragma unroll
        for (int nt = 0; nt < NH; ++nt) {
          if (g.sh) {
            float s[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v0 = acc[0][nt][2 * h + e], v1 = acc[1][nt][2 * h + e];
              s[e] = (v0 + __shfl_xor_sync(0xffffffffu, v0, 4)) +
                     (v1 + __shfl_xor_sync(0xffffffffu, v1, 4));
            }
            if (!(qq & 1))
              *reinterpret_cast<uint32_t*>(du + g.x_global(rp, qq >> 1) * C + col0 + nt * 8) =
                  pack_bf16(s[0], s[1]);
          } else {
#pragma unroll
            for (int m = 0; m < 2; ++m)
              *reinterpret_cast<uint32_t*>(du + g.fine(g.r0 + 2 * rp + m, g.c0 + qq) * C + col0 +
                                           nt * 8) =
                  pack_bf16(acc[m][nt][2 * h], acc[m][nt][2 * h + 1]);
          }
        }
      }
    }

    // 5. dxs: dy0_s itself (identity skip), or (dy0_s . Ws^T)_cd
    if constexpr (kSkip) {
      const int mtiles = (xr * xwt) / 16;
      for (int m = warp; m < mtiles; m += kMmaWarps) {
        const bf16* const arow[1] = {g.sh ? DS + (m * 16 + (lane & 15)) * LO
                                          : D + ((m + 1) * kUW + (lane & 15) + 1) * LO};
        float acc[1][C / 8][4];
        zero_acc(acc);
        mma_rows_nk<1, CO / 16, C / 8>(acc, arow, Ws, LO);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pq = m * 16 + (lane >> 2) + 8 * h;
          const size_t o = g.x_global(pq / xwt, pq % xwt) * C + 2 * (lane & 3);
#pragma unroll
          for (int nt = 0; nt < C / 8; ++nt)
            *reinterpret_cast<uint32_t*>(dxs + o + nt * 8) =
                pack_bf16(acc[0][nt][2 * h], acc[0][nt][2 * h + 1]);
        }
      }
    } else {
      for (int e = threadIdx.x; e < xr * xwt * CH; e += blockDim.x) {
        const int p = e / CH, ch = (e - p * CH) * 8;
        const int i = p / xwt, j = p - i * xwt;
        const bf16* src = g.sh ? DS + p * LO : D + ((i + 1) * kUW + j + 1) * LO;
        *reinterpret_cast<uint4*>(dxs + g.x_global(i, j) * C + ch) =
            *reinterpret_cast<const uint4*>(src + ch);
      }
    }
    __syncthreads();  // the next tile overwrites every region
  }

  // this block's slice of part: [dWr (3, C, CO) | dWc (3, CO, CO) | db_col (CO) | dWskip (C, CO)]
  float* pwr = part + (size_t)blockIdx.x * (3 * C * CO + 3 * CO * CO + CO + (kSkip ? C * CO : 0));
  float* pwc = pwr + 3 * C * CO;
  float* pbc = pwc + 3 * CO * CO;
  float* pws = pbc + CO;
  {
    float* base = role == 0 ? pwc : (role == 1 ? pwr : pws);
    const int rows = role == 0 ? CO : C;  // a tap's input channels
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      if (t < ntap) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = mt * 16 + (lane >> 2) + 8 * h, n = nt * 8 + 2 * (lane & 3);
            *reinterpret_cast<float2*>(base + ((size_t)t * rows + m) * CO + n) =
                make_float2(wacc[t][nt][2 * h], wacc[t][nt][2 * h + 1]);
          }
      }
    }
  }
  // db_col: each thread's 8 channels, then a channel's threads in order
  float* red = reinterpret_cast<float*>(U);  // [threads][8]: U is free after the last barrier
#pragma unroll
  for (int k = 0; k < 8; ++k) red[threadIdx.x * 8 + k] = dbacc[k];
  __syncthreads();
  for (int n = threadIdx.x; n < CO; n += blockDim.x) {
    float s = 0.f;
    for (int t = n / 8; t < kMmaThreads; t += CH) s += red[t * 8 + (n & 7)];
    pbc[n] = s;
  }
}

// ---- launchers -------------------------------------------------------------

template <typename T>
cudaError_t launch_conv(const void* x, const void* a, const void* b, const void* wr,
                        const void* wc, const void* bc, const void* ws, void* out, int N, int H,
                        int W, int C, int Co, int TH, int TW, int act, float slope, int up,
                        int down, cudaStream_t stream) {
  const size_t smem = smem_floats(kConv, C, Co, 0, 0, TH, TW) * sizeof(float);
  cudaError_t err = allow_smem(stage_conv<T>, smem);
  if (err != cudaSuccess) return err;
  stage_conv<T><<<dim3((H / TH) * (W / TW), N), kThreads, smem, stream>>>(
      (const T*)x, (const float*)a, (const float*)b, (const T*)wr, (const T*)wc,
      (const float*)bc, (const T*)ws, (T*)out, H, W, C, Co, TH, TW, act, slope, up, down);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sigmoid(const void* x, const void* a, const void* b, const void* wr,
                           const void* wc, const void* bc, const void* ws, const void* pp,
                           const void* w1, const void* b1, const void* w2, const void* b2,
                           void* out, int N, int H, int W, int C, int Co, int Hd, int Cout,
                           int TH, int TW, int act, float slope, float gate_max, int up,
                           int down, cudaStream_t stream) {
  const size_t smem = smem_floats(kSigmoid, C, Co, Hd, Cout, TH, TW) * sizeof(float);
  cudaError_t err = allow_smem(stage_sigmoid<T>, smem);
  if (err != cudaSuccess) return err;
  stage_sigmoid<T><<<dim3((H / TH) * (W / TW), N), kThreads, smem, stream>>>(
      (const T*)x, (const float*)a, (const float*)b, (const T*)wr, (const T*)wc,
      (const float*)bc, (const T*)ws, (const float*)pp, (const T*)w1, (const float*)b1,
      (const T*)w2, (const float*)b2, (T*)out, H, W, C, Co, Hd, Cout, TH, TW, act, slope,
      gate_max, up, down);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stats(const void* x, const void* a, const void* b, const void* wr,
                         const void* wc, const void* bc, const void* ws, const void* pp,
                         const void* w1, const void* b1, const void* w2, const void* b2,
                         void* w_pre, void* part_m, void* part_s, void* m, void* se, int N,
                         int H, int W, int C, int Co, int Hd, int Cout, int TH, int TW, int act,
                         float slope, int up, cudaStream_t stream) {
  const int tiles = (H / TH) * (W / TW);
  const size_t smem = smem_floats(kStats, C, Co, Hd, Cout, TH, TW) * sizeof(float);
  cudaError_t err = allow_smem(stage_softmax_stats<T>, smem);
  if (err != cudaSuccess) return err;
  stage_softmax_stats<T><<<dim3(tiles, N), kThreads, smem, stream>>>(
      (const T*)x, (const float*)a, (const float*)b, (const T*)wr, (const T*)wc,
      (const float*)bc, (const T*)ws, (const float*)pp, (const T*)w1, (const float*)b1,
      (const T*)w2, (const float*)b2, (T*)w_pre, (float*)part_m, (float*)part_s, H, W, C, Co,
      Hd, Cout, TH, TW, act, slope, up);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_stats_merge((const float*)part_m, (const float*)part_s, (float*)m, (float*)se,
                            N, tiles, Cout, stream);
}

template <typename T>
cudaError_t launch_apply_pool(const void* w_pre, const void* pp, const void* w1, const void* b1,
                              const void* w2, const void* b2, const void* m, const void* se,
                              void* out, int N, int H, int W, int Co, int Hd, int Cout, int TH,
                              int TW, int act, float slope, float hw_scale, float gate_max,
                              cudaStream_t stream) {
  const size_t smem = smem_floats(kApplyPool, Co, Co, Hd, Cout, TH, TW) * sizeof(float);
  cudaError_t err = allow_smem(stage_softmax_apply_pool<T>, smem);
  if (err != cudaSuccess) return err;
  stage_softmax_apply_pool<T><<<dim3((H / TH) * (W / TW), N), kThreads, smem, stream>>>(
      (const T*)w_pre, (const float*)pp, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)b2, (const float*)m, (const float*)se, (T*)out, H, W, Co, Hd, Cout, TH, TW,
      act, slope, hw_scale, gate_max);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_conv_bwd(const void* x, const void* dw, const void* a, const void* b,
                            const void* wr, const void* wr_t, const void* wc_t, const void* ws_t,
                            void* du, void* dxs, void* part, void* grads, int N, int H, int W,
                            int C, int Co, int TH, int TW, int blocks, int act, float slope,
                            int up, cudaStream_t stream) {
  const size_t smem = smem_floats(kBwd, C, Co, 0, 0, TH, TW) * sizeof(float);
  cudaError_t err = allow_smem(stage_conv_bwd<T>, smem);
  if (err != cudaSuccess) return err;
  stage_conv_bwd<T><<<blocks, kThreads, smem, stream>>>(
      (const T*)x, (const T*)dw, (const float*)a, (const float*)b, (const T*)wr,
      (const T*)wr_t, (const T*)wc_t, (const T*)ws_t, (T*)du, (T*)dxs, (float*)part, N, H, W, C,
      Co, TH, TW, act, slope, up);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int wtot = 3 * C * Co + 3 * Co * Co + Co + (ws_t ? C * Co : 0);
  return launch_reduce((const float*)part, (float*)grads, 1, blocks, wtot, stream);
}

// The persistent grid of an mma kernel: at most `per_sm` blocks an SM.
template <typename K>
cudaError_t persistent_grid(K kernel, size_t smem, int tiles, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  return cudaSuccess;
}

template <int C, int CO>
cudaError_t launch_conv_mma(const void* x, const void* a, const void* b, const void* wr,
                            const void* wc, const void* bc, const void* ws, void* out, int N,
                            int H, int W, int act, float slope, int up, int down,
                            cudaStream_t stream) {
  const size_t smem = conv_mma_bytes(C, CO, false);
  cudaError_t err = allow_smem(stage_conv_mma<C, CO>, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(stage_conv_mma<C, CO>, smem, N * (H / kMmaTH) * (W / kMmaTW), &grid);
  if (err != cudaSuccess) return err;
  stage_conv_mma<C, CO><<<grid, kMmaThreads, smem, stream>>>(
      (const bf16*)x, (const float*)a, (const float*)b, (const bf16*)wr, (const bf16*)wc,
      (const float*)bc, (const bf16*)ws, (bf16*)out, N, H, W, act, slope, up, down);
  return cudaGetLastError();
}

template <int C, int CO>
cudaError_t launch_sigmoid_mma(const void* x, const void* a, const void* b, const void* wr,
                               const void* wc, const void* bc, const void* ws, const void* pp,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               void* out, int N, int H, int W, int act, float slope,
                               float gate_max, int up, int down, cudaStream_t stream) {
  const size_t smem = conv_mma_bytes(C, CO, true);
  cudaError_t err = allow_smem(stage_sigmoid_mma<C, CO>, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(stage_sigmoid_mma<C, CO>, smem, N * (H / kMmaTH) * (W / kMmaTW), &grid);
  if (err != cudaSuccess) return err;
  stage_sigmoid_mma<C, CO><<<grid, kMmaThreads, smem, stream>>>(
      (const bf16*)x, (const float*)a, (const float*)b, (const bf16*)wr, (const bf16*)wc,
      (const float*)bc, (const bf16*)ws, (const float*)pp, (const bf16*)w1, (const float*)b1,
      (const bf16*)w2, (const float*)b2, (bf16*)out, N, H, W, act, slope, gate_max, up, down);
  return cudaGetLastError();
}

template <int C, int CO>
cudaError_t launch_stats_mma(const void* x, const void* a, const void* b, const void* wr,
                             const void* wc, const void* bc, const void* ws, const void* pp,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             void* w_pre, void* part_m, void* part_s, void* m, void* se, int N,
                             int H, int W, int act, float slope, int up, cudaStream_t stream) {
  const size_t smem = stats_mma_bytes(C, CO);
  cudaError_t err = allow_smem(stage_softmax_stats_mma<C, CO>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (H / kMmaTH) * (W / kMmaTW);
  int grid = 0;
  err = persistent_grid(stage_softmax_stats_mma<C, CO>, smem, N * tiles, &grid);
  if (err != cudaSuccess) return err;
  stage_softmax_stats_mma<C, CO><<<grid, kMmaThreads, smem, stream>>>(
      (const bf16*)x, (const float*)a, (const float*)b, (const bf16*)wr, (const bf16*)wc,
      (const float*)bc, (const bf16*)ws, (const float*)pp, (const bf16*)w1, (const float*)b1,
      (const bf16*)w2, (const float*)b2, (bf16*)w_pre, (float*)part_m, (float*)part_s, N, H, W,
      act, slope, up);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_stats_merge((const float*)part_m, (const float*)part_s, (float*)m, (float*)se,
                            N, tiles, CO, stream);
}

template <int C, int CO>
cudaError_t launch_conv_bwd_mma(const void* x, const void* dw, const void* a, const void* b,
                                const void* wr, const void* wc, const void* ws, void* du,
                                void* dxs, void* part, void* grads, int N, int H, int W,
                                int blocks, int act, float slope, int up, cudaStream_t stream) {
  const size_t smem = bwd_mma_bytes(C, CO);
  cudaError_t err = allow_smem(stage_conv_bwd_mma<C, CO>, smem);
  if (err != cudaSuccess) return err;
  if (blocks < 1 || blocks > N * (H / kMmaTH) * (W / kMmaTW)) return cudaErrorInvalidValue;
  stage_conv_bwd_mma<C, CO><<<blocks, kMmaThreads, smem, stream>>>(
      (const bf16*)x, (const bf16*)dw, (const float*)a, (const float*)b, (const bf16*)wr,
      (const bf16*)wc, (const bf16*)ws, (bf16*)du, (bf16*)dxs, (float*)part, N, H, W, act, slope,
      up);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int wtot = 3 * C * CO + 3 * CO * CO + CO + (C != CO ? C * CO : 0);
  return launch_reduce((const float*)part, (float*)grads, 1, blocks, wtot, stream);
}

cudaError_t launch_apply_pool_mma(const void* w_pre, const void* pp, const void* w1,
                                  const void* b1, const void* w2, const void* b2, const void* m,
                                  const void* se, void* out, int N, int H, int W, int act,
                                  float slope, float hw_scale, float gate_max,
                                  cudaStream_t stream) {
  const size_t smem = apply_pool_mma_bytes();
  cudaError_t err = allow_smem(stage_softmax_apply_pool_mma, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(stage_softmax_apply_pool_mma, smem, N * (H / kMmaTH) * (W / kMmaTW),
                        &grid);
  if (err != cudaSuccess) return err;
  stage_softmax_apply_pool_mma<<<grid, kMmaThreads, smem, stream>>>(
      (const bf16*)w_pre, (const float*)pp, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (const float*)m, (const float*)se, (bf16*)out, N, H, W, act, slope,
      hw_scale, gate_max);
  return cudaGetLastError();
}

// Whether the mma route takes a call: bf16, a template's (C, Co), a 1x1
// skip exactly where C != Co, the route's tile, and (stats, sigmoid) its
// gate widths.
bool mma_call_ok(int is_bf16, int C, int Co, const void* ws, int TH, int TW, int Hd, int Cout) {
  return is_bf16 && mma_widths_ok(C, Co) && (ws != nullptr) == (C != Co) && TH == kMmaTH &&
         TW == kMmaTW && Hd == kMmaHd && Cout == Co;
}

// The blocks of `kernel` that fit on an SM with `smem` bytes of dynamic
// shared memory, into *n.
template <typename K>
cudaError_t occupancy(K kernel, int threads, size_t smem, int* n) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, threads, smem);
}
template <int C>
cudaError_t mma_occupancy(int kind, size_t smem, int* n) {
  switch (kind) {
    case kConv: return occupancy(stage_conv_mma<C, 64>, kMmaThreads, smem, n);
    case kSigmoid: return occupancy(stage_sigmoid_mma<C, 64>, kMmaThreads, smem, n);
    case kStats: return occupancy(stage_softmax_stats_mma<C, 64>, kMmaThreads, smem, n);
    case kApplyPool: return occupancy(stage_softmax_apply_pool_mma, kMmaThreads, smem, n);
    default: return occupancy(stage_conv_bwd_mma<C, 64>, kMmaThreads, smem, n);
  }
}
cudaError_t simt_occupancy(int kind, size_t smem, int* n) {
  switch (kind) {
    case kConv: return occupancy(stage_conv<bf16>, kThreads, smem, n);
    case kSigmoid: return occupancy(stage_sigmoid<bf16>, kThreads, smem, n);
    case kStats: return occupancy(stage_softmax_stats<bf16>, kThreads, smem, n);
    case kApplyPool: return occupancy(stage_softmax_apply_pool<bf16>, kThreads, smem, n);
    default: return occupancy(stage_conv_bwd<bf16>, kThreads, smem, n);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. `is_bf16` selects the compute
// dtype (1: bfloat16, 0: float32); (H, W) are the fine dims; `ws`/`ws_t`
// is null for an identity skip. Returns a cudaError_t (0 = launched).
extern "C" {

// Dynamic shared memory of a block of `kind` on `route` (0: simt, 1: mma);
// 0 where the mma route has no kernel for the widths, kind or tile.
size_t locate_stage_smem_bytes(int route, int kind, int C, int Co, int Hd, int Cout, int TH,
                               int TW) {
  if (route == 0) return smem_floats(kind, C, Co, Hd, Cout, TH, TW) * sizeof(float);
  if (!mma_widths_ok(C, Co) || TH != kMmaTH || TW != kMmaTW) return 0;
  const bool gate_ok = Hd == kMmaHd && Cout == Co;
  switch (kind) {
    case kConv: return conv_mma_bytes(C, Co, false);
    case kSigmoid: return gate_ok ? conv_mma_bytes(C, Co, true) : 0;
    case kStats: return gate_ok ? stats_mma_bytes(C, Co) : 0;
    case kApplyPool: return gate_ok && C == Co && Co == kApCo ? apply_pool_mma_bytes() : 0;
    case kBwd: return bwd_mma_bytes(C, Co);
    default: return 0;
  }
}

// Blocks of the bf16 kernel of `kind` on `route` that fit on an SM at the
// shared memory above; -1 where there is none.
int locate_stage_blocks_per_sm(int route, int kind, int C, int Co, int Hd, int Cout, int TH,
                               int TW) {
  const size_t smem = locate_stage_smem_bytes(route, kind, C, Co, Hd, Cout, TH, TW);
  if (smem == 0 || kind < kConv || kind > kSigmoid) return -1;
  int n = -1;
  const cudaError_t err = route == 0 ? simt_occupancy(kind, smem, &n)
                          : C == 64  ? mma_occupancy<64>(kind, smem, &n)
                                     : mma_occupancy<32>(kind, smem, &n);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return n;
}

// route 1 (mma) takes bf16 at a template's widths and tile only, as in
// locate_stage_softmax_stats.
int locate_stage_conv(int route, int is_bf16, const void* x, const void* a, const void* b,
                      const void* wr, const void* wc, const void* bc, const void* ws, void* out,
                      int N, int H, int W, int C, int Co, int TH, int TW, int act, float slope,
                      int up, int down, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (!mma_call_ok(is_bf16, C, Co, ws, TH, TW, kMmaHd, Co)) return (int)cudaErrorInvalidValue;
    if (C == 64)
      return (int)launch_conv_mma<64, 64>(x, a, b, wr, wc, bc, ws, out, N, H, W, act, slope, up,
                                          down, s);
    return (int)launch_conv_mma<32, 64>(x, a, b, wr, wc, bc, ws, out, N, H, W, act, slope, up,
                                        down, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch_conv<__nv_bfloat16>(x, a, b, wr, wc, bc, ws, out, N, H, W, C, Co, TH, TW,
                                           act, slope, up, down, s);
  return (int)launch_conv<float>(x, a, b, wr, wc, bc, ws, out, N, H, W, C, Co, TH, TW, act,
                                 slope, up, down, s);
}

// out: (N, H, W, Co), or (N, H/2, W/2, Co) under `down`.
// route 1 (mma) takes bf16 at a template's widths, tile and gate widths only.
int locate_stage_sigmoid(int route, int is_bf16, const void* x, const void* a, const void* b,
                         const void* wr, const void* wc, const void* bc, const void* ws,
                         const void* pp, const void* w1, const void* b1, const void* w2,
                         const void* b2, void* out, int N, int H, int W, int C, int Co, int Hd,
                         int Cout, int TH, int TW, int act, float slope, float gate_max, int up,
                         int down, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (!mma_call_ok(is_bf16, C, Co, ws, TH, TW, Hd, Cout)) return (int)cudaErrorInvalidValue;
    if (C == 64)
      return (int)launch_sigmoid_mma<64, 64>(x, a, b, wr, wc, bc, ws, pp, w1, b1, w2, b2, out, N,
                                             H, W, act, slope, gate_max, up, down, s);
    return (int)launch_sigmoid_mma<32, 64>(x, a, b, wr, wc, bc, ws, pp, w1, b1, w2, b2, out, N,
                                           H, W, act, slope, gate_max, up, down, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch_sigmoid<__nv_bfloat16>(x, a, b, wr, wc, bc, ws, pp, w1, b1, w2, b2, out,
                                              N, H, W, C, Co, Hd, Cout, TH, TW, act, slope,
                                              gate_max, up, down, s);
  return (int)launch_sigmoid<float>(x, a, b, wr, wc, bc, ws, pp, w1, b1, w2, b2, out, N, H, W,
                                    C, Co, Hd, Cout, TH, TW, act, slope, gate_max, up, down, s);
}

// part_m, part_s: (N, (H/TH)*(W/TW), Cout) workspaces; m, se: (N, Cout) out.
// route 1 (mma) takes bf16 at a template's widths and tile only.
int locate_stage_softmax_stats(int route, int is_bf16, const void* x, const void* a, const void* b,
                               const void* wr, const void* wc, const void* bc, const void* ws,
                               const void* pp, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* w_pre, void* part_m, void* part_s, void* m,
                               void* se, int N, int H, int W, int C, int Co, int Hd, int Cout,
                               int TH, int TW, int act, float slope, int up, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (!mma_call_ok(is_bf16, C, Co, ws, TH, TW, Hd, Cout)) return (int)cudaErrorInvalidValue;
    if (C == 64)
      return (int)launch_stats_mma<64, 64>(x, a, b, wr, wc, bc, ws, pp, w1, b1, w2, b2, w_pre,
                                           part_m, part_s, m, se, N, H, W, act, slope, up, s);
    return (int)launch_stats_mma<32, 64>(x, a, b, wr, wc, bc, ws, pp, w1, b1, w2, b2, w_pre,
                                         part_m, part_s, m, se, N, H, W, act, slope, up, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch_stats<__nv_bfloat16>(x, a, b, wr, wc, bc, ws, pp, w1, b1, w2, b2, w_pre,
                                            part_m, part_s, m, se, N, H, W, C, Co, Hd, Cout, TH,
                                            TW, act, slope, up, s);
  return (int)launch_stats<float>(x, a, b, wr, wc, bc, ws, pp, w1, b1, w2, b2, w_pre, part_m,
                                  part_s, m, se, N, H, W, C, Co, Hd, Cout, TH, TW, act, slope,
                                  up, s);
}

// m, se: (N, Cout); out: (N, H/2, W/2, Co). route 1 (mma) takes bf16 at
// (Co, Hd, Cout) = (64, 16, 64), the route's tile dividing (H, W), only.
int locate_stage_softmax_apply_pool(int route, int is_bf16, const void* w_pre, const void* pp,
                                    const void* w1, const void* b1, const void* w2,
                                    const void* b2, const void* m, const void* se, void* out,
                                    int N, int H, int W, int Co, int Hd, int Cout, int TH, int TW,
                                    int act, float slope, float hw_scale, float gate_max,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (!mma_call_ok(is_bf16, Co, Co, nullptr, TH, TW, Hd, Cout) || Co != kApCo ||
        H % kMmaTH != 0 || W % kMmaTW != 0)
      return (int)cudaErrorInvalidValue;
    return (int)launch_apply_pool_mma(w_pre, pp, w1, b1, w2, b2, m, se, out, N, H, W, act, slope,
                                      hw_scale, gate_max, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch_apply_pool<__nv_bfloat16>(w_pre, pp, w1, b1, w2, b2, m, se, out, N, H, W,
                                                 Co, Hd, Cout, TH, TW, act, slope, hw_scale,
                                                 gate_max, s);
  return (int)launch_apply_pool<float>(w_pre, pp, w1, b1, w2, b2, m, se, out, N, H, W, Co, Hd,
                                       Cout, TH, TW, act, slope, hw_scale, gate_max, s);
}

// part: (blocks, wtot) workspace; grads: (wtot,) f32 out, laid out as a slice.
// The simt route (0) takes wr and the tap-reversed transposes wr_t, wc_t,
// ws_t; the mma route (1) takes wr, wc and ws, bf16 at a template's widths
// and tile.
int locate_stage_conv_bwd(int route, int is_bf16, const void* x, const void* dw, const void* a,
                          const void* b, const void* wr, const void* wc, const void* ws,
                          const void* wr_t, const void* wc_t, const void* ws_t, void* du,
                          void* dxs, void* part, void* grads, int N, int H, int W, int C, int Co,
                          int TH, int TW, int blocks, int act, float slope, int up,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (!mma_call_ok(is_bf16, C, Co, ws, TH, TW, kMmaHd, Co)) return (int)cudaErrorInvalidValue;
    if (C == 64)
      return (int)launch_conv_bwd_mma<64, 64>(x, dw, a, b, wr, wc, ws, du, dxs, part, grads, N,
                                              H, W, blocks, act, slope, up, s);
    return (int)launch_conv_bwd_mma<32, 64>(x, dw, a, b, wr, wc, ws, du, dxs, part, grads, N, H,
                                            W, blocks, act, slope, up, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch_conv_bwd<__nv_bfloat16>(x, dw, a, b, wr, wr_t, wc_t, ws_t, du, dxs, part,
                                               grads, N, H, W, C, Co, TH, TW, blocks, act, slope,
                                               up, s);
  return (int)launch_conv_bwd<float>(x, dw, a, b, wr, wr_t, wc_t, ws_t, du, dxs, part, grads, N,
                                     H, W, C, Co, TH, TW, blocks, act, slope, up, s);
}

const char* locate_stage_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
