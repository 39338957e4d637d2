// Fused stage group, forward and backward, for Hopper (sm_90a).
//
// Replaces five TPU kernels of locate_tpu/ops/pallas/fused_stage.py:
//   * _kernel_conv_only          (:366) -> stage_conv
//   * _kernel_sigmoid            (:378) -> stage_sigmoid
//   * _kernel_softmax_stats      (:410) -> stage_softmax_stats + softmax_stats_merge
//   * _kernel_softmax_apply_pool (:397) -> stage_softmax_apply_pool
//   * _kernel_conv_bwd           (:451) -> stage_conv_bwd + reduce_partials
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
// the gate dominates (apply-pool). This first version runs the
// products as f32 FMAs on the CUDA cores (67 TFLOP/s): no tensor cores,
// TMA or wgmma.
//
// Design. The TPU tiles whole image rows; at 512 x 64 channels a bf16 row
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

}  // namespace

// Plain C interface, loaded with ctypes. `is_bf16` selects the compute
// dtype (1: bfloat16, 0: float32); (H, W) are the fine dims; `ws`/`ws_t`
// is null for an identity skip. Returns a cudaError_t (0 = launched).
extern "C" {

size_t locate_stage_smem_bytes(int kind, int C, int Co, int Hd, int Cout, int TH, int TW) {
  return smem_floats(kind, C, Co, Hd, Cout, TH, TW) * sizeof(float);
}

int locate_stage_conv(int is_bf16, const void* x, const void* a, const void* b, const void* wr,
                      const void* wc, const void* bc, const void* ws, void* out, int N, int H,
                      int W, int C, int Co, int TH, int TW, int act, float slope, int up,
                      int down, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch_conv<__nv_bfloat16>(x, a, b, wr, wc, bc, ws, out, N, H, W, C, Co, TH, TW,
                                           act, slope, up, down, s);
  return (int)launch_conv<float>(x, a, b, wr, wc, bc, ws, out, N, H, W, C, Co, TH, TW, act,
                                 slope, up, down, s);
}

// out: (N, H, W, Co), or (N, H/2, W/2, Co) under `down`.
int locate_stage_sigmoid(int is_bf16, const void* x, const void* a, const void* b,
                         const void* wr, const void* wc, const void* bc, const void* ws,
                         const void* pp, const void* w1, const void* b1, const void* w2,
                         const void* b2, void* out, int N, int H, int W, int C, int Co, int Hd,
                         int Cout, int TH, int TW, int act, float slope, float gate_max, int up,
                         int down, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch_sigmoid<__nv_bfloat16>(x, a, b, wr, wc, bc, ws, pp, w1, b1, w2, b2, out,
                                              N, H, W, C, Co, Hd, Cout, TH, TW, act, slope,
                                              gate_max, up, down, s);
  return (int)launch_sigmoid<float>(x, a, b, wr, wc, bc, ws, pp, w1, b1, w2, b2, out, N, H, W,
                                    C, Co, Hd, Cout, TH, TW, act, slope, gate_max, up, down, s);
}

// part_m, part_s: (N, (H/TH)*(W/TW), Cout) workspaces; m, se: (N, Cout) out.
int locate_stage_softmax_stats(int is_bf16, const void* x, const void* a, const void* b,
                               const void* wr, const void* wc, const void* bc, const void* ws,
                               const void* pp, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* w_pre, void* part_m, void* part_s, void* m,
                               void* se, int N, int H, int W, int C, int Co, int Hd, int Cout,
                               int TH, int TW, int act, float slope, int up, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch_stats<__nv_bfloat16>(x, a, b, wr, wc, bc, ws, pp, w1, b1, w2, b2, w_pre,
                                            part_m, part_s, m, se, N, H, W, C, Co, Hd, Cout, TH,
                                            TW, act, slope, up, s);
  return (int)launch_stats<float>(x, a, b, wr, wc, bc, ws, pp, w1, b1, w2, b2, w_pre, part_m,
                                  part_s, m, se, N, H, W, C, Co, Hd, Cout, TH, TW, act, slope,
                                  up, s);
}

int locate_stage_softmax_apply_pool(int is_bf16, const void* w_pre, const void* pp,
                                    const void* w1, const void* b1, const void* w2,
                                    const void* b2, const void* m, const void* se, void* out,
                                    int N, int H, int W, int Co, int Hd, int Cout, int TH, int TW,
                                    int act, float slope, float hw_scale, float gate_max,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch_apply_pool<__nv_bfloat16>(w_pre, pp, w1, b1, w2, b2, m, se, out, N, H, W,
                                                 Co, Hd, Cout, TH, TW, act, slope, hw_scale,
                                                 gate_max, s);
  return (int)launch_apply_pool<float>(w_pre, pp, w1, b1, w2, b2, m, se, out, N, H, W, Co, Hd,
                                       Cout, TH, TW, act, slope, hw_scale, gate_max, s);
}

// part: (blocks, wtot) workspace; grads: (wtot,) f32 out, laid out as a slice.
int locate_stage_conv_bwd(int is_bf16, const void* x, const void* dw, const void* a,
                          const void* b, const void* wr, const void* wr_t, const void* wc_t,
                          const void* ws_t, void* du, void* dxs, void* part, void* grads, int N,
                          int H, int W, int C, int Co, int TH, int TW, int blocks, int act,
                          float slope, int up, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
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
