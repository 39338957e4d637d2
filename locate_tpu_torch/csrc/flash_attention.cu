// Flash (memory-linear) dot-product attention for sm_90a: forward, dQ and
// dK/dV, the kernels behind attention.kind="self".
//
//   O = softmax(Q K^T * scale) V        q (B, T, dh), k (B, S, dh), v (B, S, dv)
//
// Replaces the three Pallas kernels of locate_tpu/ops/pallas/flash_attention.py:
// `_fwd_kernel` (flash_fwd), `_dq_kernel` (flash_dq) and `_dkv_kernel`
// (flash_dkv). The (T, S) score matrix never reaches device memory: a block
// holds one (q tile, kv tile) of it at a time in registers and shared memory.
//
// What bounds them on this card: operations. The operands are O(T) and stay
// in L2, the work is O(T S): 2 B T S (dh + dv) flops forward, (2 dh + dv)
// for dQ, (2 dh + 2 dv) for dK/dV, and B T S exponentials, which at dh = 8
// come second after the tensor cores' rate.
//
// What the design does about it:
//  * The TPU grid's sequential innermost dimension is a loop inside the
//    block. flash_fwd and flash_dq: one block owns one (batch, q tile) and
//    walks the kv tiles; flash_dkv: one block owns one (batch, kv tile) and
//    walks the q tiles. No output is shared between blocks, so there are no
//    atomics and two runs are bitwise equal.
//  * All six products run in the kernel body as f32 FMAs from shared
//    memory on register micro-tiles (RQ x 4 for the score tile, MR x 4 for
//    the accumulating products, MR chosen so that narrow outputs such as
//    dv = 32 still occupy every thread). Operands are staged as f32, in the
//    orientation each product reads with 16-byte loads (a tile is staged
//    twice where two products read it both ways). Tensor-core products
//    (mma / wgmma; dh = 8 needs padding to their depth) are later work.
//  * A kv tile is 64 wide; a q tile is 64 or 16 rows (template RQ), picked
//    by the caller for enough blocks to fill the card and for T as small as
//    16. Ragged edges are masked, nothing is padded in device memory.
//  * Accumulators (O, dQ, dK, dV) live in shared memory in f32, so dv = 256
//    fits and any dh, dv within 227 KB works without a template per width.
//  * Rounding as the TPU kernels: scores summed in f32 from compute-dtype
//    operands, scaled in f32, exp in f32, P and dS rounded to the compute
//    dtype before their second product, each tile's product added to the
//    f32 accumulator (dQ and dK scaled per tile), one cast at the store.
//    The running max starts at -1e30.
//  * ell (the per-row logsumexp) and delta are (B, T) f32: the TPU's
//    128-lane broadcast has no use here. delta = rowsum(dO * O) is computed
//    by the caller.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;          // kv rows of a score tile: 16 threads x 4
constexpr int kLK = kBK + 4;     // its padded stride, a multiple of 4
constexpr float kNegBig = -1e30f;

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

template <int N> struct Vec;
template <> struct Vec<1> {
  static __device__ __forceinline__ void load(float (&a)[1], const float* p) { a[0] = *p; }
  static __device__ __forceinline__ void store(float* p, const float (&a)[1]) { *p = a[0]; }
};
template <> struct Vec<2> {
  static __device__ __forceinline__ void load(float (&a)[2], const float* p) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a[0] = v.x; a[1] = v.y;
  }
  static __device__ __forceinline__ void store(float* p, const float (&a)[2]) {
    *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
  }
};
template <> struct Vec<4> {
  static __device__ __forceinline__ void load(float (&a)[4], const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&a)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  }
};

// rows x cols of a row-major (rows_total, cols) matrix, from row `row0`, into
// shared memory: `nat` as [r][c] with stride ld_nat, `tr` as [c][r] with
// stride ld_tr (either may be null). Rows past rows_total and the columns
// from cols to ld_nat are zero.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src, int row0, int rows_total,
                                           int rows, int cols, float* nat, int ld_nat,
                                           float* tr, int ld_tr) {
  const int width = nat ? ld_nat : cols;
  for (int e = threadIdx.x; e < rows * width; e += kThreads) {
    const int r = e / width, c = e - r * width;
    float val = 0.f;
    if (row0 + r < rows_total && c < cols) val = to_f32(src[(size_t)(row0 + r) * cols + c]);
    if (nat) nat[r * ld_nat + c] = val;
    if (tr && c < cols) tr[c * ld_tr + r] = val;
  }
}

// acc[i][j] += sum over d < depth of At[d][i0 + i] * Bt[d][j0 + j].
template <int RQ>
__device__ __forceinline__ void score_tile(const float* __restrict__ At, int lda,
                                           const float* __restrict__ Bt, int ldb, int depth,
                                           int i0, int j0, float (&acc)[RQ][4]) {
  for (int d = 0; d < depth; ++d) {
    float a[RQ], b[4];
    Vec<RQ>::load(a, At + d * lda + i0);
    Vec<4>::load(b, Bt + d * ldb + j0);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
  }
}

// C[i][j] = C[i][j] * row_scale[i] + mult * sum over k < depth of
// A[k][i] * B[k][j], for i < M and j < N4 (a multiple of 4): CG threads
// side by side take 4 columns each, 256 / CG groups of MR rows.
template <int MR>
__device__ __forceinline__ void accumulate_rows(const float* __restrict__ A, int lda,
                                                const float* __restrict__ B, int ldb,
                                                int depth, int M, int N4, int CG, float* C,
                                                int ldc, const float* row_scale, float mult) {
  const int cg = threadIdx.x & (CG - 1);
  const int i0 = (threadIdx.x / CG) * MR;
  if (i0 >= M) return;
  for (int jc = 4 * cg; jc < N4; jc += 4 * CG) {
    float r[MR][4];
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) r[i][j] = 0.f;
    for (int k = 0; k < depth; ++k) {
      float a[MR], b[4];
      Vec<MR>::load(a, A + k * lda + i0);
      Vec<4>::load(b, B + k * ldb + jc);
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) r[i][j] += a[i] * b[j];
    }
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      float* cp = C + (i0 + i) * ldc + jc;
      const float rs = row_scale ? row_scale[i0 + i] : 1.f;
      float c[4];
      Vec<4>::load(c, cp);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = c[j] * rs + r[i][j] * mult;
      Vec<4>::store(cp, c);
    }
  }
}

// The accumulating product on M (16 or 64) rows: the widest column split
// the output allows, and the rows a thread then has to take.
template <int M>
__device__ __forceinline__ void accumulate(const float* A, int lda, const float* B, int ldb,
                                           int depth, int N4, float* C, int ldc,
                                           const float* row_scale, float mult) {
  const int groups = N4 >> 2;
  int CG = 1;
  while (CG < groups && CG < 16) CG <<= 1;
  const int MR = (M * CG) / kThreads;
  if (MR >= 4)
    accumulate_rows<4>(A, lda, B, ldb, depth, M, N4, CG, C, ldc, row_scale, mult);
  else if (MR == 2)
    accumulate_rows<2>(A, lda, B, ldb, depth, M, N4, CG, C, ldc, row_scale, mult);
  else
    accumulate_rows<1>(A, lda, B, ldb, depth, M, N4, CG, C, ldc, row_scale, mult);
}

// Reductions over the 16 lanes that share a score row (tx = lane & 15).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Shared-memory floats of one block; BQ = 16 * RQ.
__host__ __device__ inline size_t fwd_floats(int dh, int dv, int BQ) {
  const int dvp = round4(dv), LQ = BQ + 4;
  return (size_t)dh * LQ + (size_t)dh * kLK + (size_t)kBK * dvp + (size_t)kBK * LQ +
         (size_t)BQ * dvp + 2 * BQ;
}
__host__ __device__ inline size_t dq_floats(int dh, int dv, int BQ) {
  const int dhp = round4(dh), LQ = BQ + 4;
  return (size_t)(dh + dv) * LQ + (size_t)(dh + dv) * kLK + (size_t)kBK * dhp +
         (size_t)kBK * LQ + (size_t)BQ * dhp;
}
__host__ __device__ inline size_t dkv_floats(int dh, int dv, int BQ) {
  const int dhp = round4(dh), dvp = round4(dv), LQ = BQ + 4;
  return (size_t)(dh + dv) * kLK + (size_t)(dh + dv) * LQ + (size_t)BQ * (dhp + dvp) +
         2 * (size_t)BQ * kLK + (size_t)kBK * (dhp + dvp);
}

// ---------------------------------------------------------------------------
// forward: block = (batch row, q tile), loop over kv tiles
// ---------------------------------------------------------------------------

template <typename T, int RQ>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, float* __restrict__ ell, int Tq, int S, int dh, int dv,
          int q_tiles, float scale) {
  constexpr int BQ = 16 * RQ, LQ = BQ + 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dvp = round4(dv);
  float* Qt = smem;                // [dh][LQ]
  float* Kt = Qt + dh * LQ;        // [dh][kLK]
  float* Vs = Kt + dh * kLK;       // [kBK][dvp]
  float* Pt = Vs + kBK * dvp;      // [kBK][LQ]
  float* Oa = Pt + kBK * LQ;       // [BQ][dvp]
  float* alpha_s = Oa + BQ * dvp;  // [BQ]
  float* l_s = alpha_s + BQ;       // [BQ]

  const int b = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - b * q_tiles) * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int i0 = ty * RQ, j0 = tx * 4;
  q += (size_t)b * Tq * dh;
  k += (size_t)b * S * dh;
  v += (size_t)b * S * dv;

  stage_tile<T>(q, q0, Tq, BQ, dh, nullptr, 0, Qt, LQ);
  for (int e = threadIdx.x; e < BQ * dvp; e += kThreads) Oa[e] = 0.f;
  float m_run[RQ], l_run[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) { m_run[i] = kNegBig; l_run[i] = 0.f; }

  for (int s0 = 0; s0 < S; s0 += kBK) {
    __syncthreads();  // the last tile's products have read Kt, Vs, Pt, alpha_s
    stage_tile<T>(k, s0, S, kBK, dh, nullptr, 0, Kt, kLK);
    stage_tile<T>(v, s0, S, kBK, dv, Vs, dvp, nullptr, 0);
    __syncthreads();

    float acc[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    score_tile<RQ>(Qt, LQ, Kt, kLK, dh, i0, j0, acc);

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = (s0 + j0 + j < S) ? acc[i][j] * scale : kNegBig;
        mx = fmaxf(mx, acc[i][j]);
      }
      const float m_next = fmaxf(m_run[i], row_max(mx));
      const float alpha = expf(m_run[i] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(acc[i][j] - m_next);
        sum += p;
        acc[i][j] = round_cd<T>(p);
      }
      l_run[i] = l_run[i] * alpha + row_sum(sum);
      m_run[i] = m_next;
      if (tx == 0) alpha_s[i0 + i] = alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float col[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) col[i] = acc[i][j];
      Vec<RQ>::store(Pt + (j0 + j) * LQ + i0, col);
    }
    __syncthreads();
    accumulate<BQ>(Pt, LQ, Vs, dvp, min(kBK, S - s0), dvp, Oa, dvp, alpha_s, 1.f);
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      l_s[i0 + i] = l_run[i];
      if (q0 + i0 + i < Tq) ell[(size_t)b * Tq + q0 + i0 + i] = m_run[i] + logf(l_run[i]);
    }
  }
  __syncthreads();
  o += ((size_t)b * Tq + q0) * dv;
  const int rows = min(BQ, Tq - q0);
  for (int e = threadIdx.x; e < rows * dv; e += kThreads) {
    const int r = e / dv, c = e - r * dv;
    o[e] = from_f32<T>(Oa[r * dvp + c] / l_s[r]);
  }
}

// p = exp(s * scale - ell) and ds = p * (dov - delta) of one score tile,
// both rounded to the compute dtype, zero outside (Tq, S).
template <typename T, int RQ>
__device__ __forceinline__ void p_and_ds(float (&s)[RQ][4], float (&dov)[RQ][4],
                                         const float (&ell_r)[RQ], const float (&delta_r)[RQ],
                                         int row0, int col0, int Tq, int S, float scale) {
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool valid = row0 + i < Tq && col0 + j < S;
      const float p = valid ? expf(s[i][j] * scale - ell_r[i]) : 0.f;
      const float ds = p * (dov[i][j] - delta_r[i]);
      s[i][j] = round_cd<T>(p);
      dov[i][j] = round_cd<T>(ds);
    }
}

// ---------------------------------------------------------------------------
// dQ: block = (batch row, q tile), loop over kv tiles
// ---------------------------------------------------------------------------

template <typename T, int RQ>
__global__ void __launch_bounds__(kThreads)
flash_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dout, const float* __restrict__ ell,
         const float* __restrict__ delta, T* __restrict__ dq, int Tq, int S, int dh, int dv,
         int q_tiles, float scale) {
  constexpr int BQ = 16 * RQ, LQ = BQ + 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dhp = round4(dh);
  float* Qt = smem;               // [dh][LQ]
  float* dOt = Qt + dh * LQ;      // [dv][LQ]
  float* Kt = dOt + dv * LQ;      // [dh][kLK]
  float* Vt = Kt + dh * kLK;      // [dv][kLK]
  float* Kn = Vt + dv * kLK;      // [kBK][dhp]
  float* dSt = Kn + kBK * dhp;    // [kBK][LQ]
  float* dQa = dSt + kBK * LQ;    // [BQ][dhp]

  const int b = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - b * q_tiles) * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int i0 = ty * RQ, j0 = tx * 4;
  q += (size_t)b * Tq * dh;
  dout += (size_t)b * Tq * dv;
  k += (size_t)b * S * dh;
  v += (size_t)b * S * dv;

  stage_tile<T>(q, q0, Tq, BQ, dh, nullptr, 0, Qt, LQ);
  stage_tile<T>(dout, q0, Tq, BQ, dv, nullptr, 0, dOt, LQ);
  for (int e = threadIdx.x; e < BQ * dhp; e += kThreads) dQa[e] = 0.f;
  float ell_r[RQ], delta_r[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const bool in = q0 + i0 + i < Tq;
    ell_r[i] = in ? ell[(size_t)b * Tq + q0 + i0 + i] : 0.f;
    delta_r[i] = in ? delta[(size_t)b * Tq + q0 + i0 + i] : 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += kBK) {
    __syncthreads();
    stage_tile<T>(k, s0, S, kBK, dh, Kn, dhp, Kt, kLK);
    stage_tile<T>(v, s0, S, kBK, dv, nullptr, 0, Vt, kLK);
    __syncthreads();

    float s[RQ][4], dov[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) { s[i][j] = 0.f; dov[i][j] = 0.f; }
    score_tile<RQ>(Qt, LQ, Kt, kLK, dh, i0, j0, s);
    score_tile<RQ>(dOt, LQ, Vt, kLK, dv, i0, j0, dov);
    p_and_ds<T, RQ>(s, dov, ell_r, delta_r, q0 + i0, s0 + j0, Tq, S, scale);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float col[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) col[i] = dov[i][j];
      Vec<RQ>::store(dSt + (j0 + j) * LQ + i0, col);
    }
    __syncthreads();
    accumulate<BQ>(dSt, LQ, Kn, dhp, min(kBK, S - s0), dhp, dQa, dhp, nullptr, scale);
  }

  __syncthreads();
  dq += ((size_t)b * Tq + q0) * dh;
  const int rows = min(BQ, Tq - q0);
  for (int e = threadIdx.x; e < rows * dh; e += kThreads) {
    const int r = e / dh, c = e - r * dh;
    dq[e] = from_f32<T>(dQa[r * dhp + c]);
  }
}

// ---------------------------------------------------------------------------
// dK, dV: block = (batch row, kv tile), loop over q tiles
// ---------------------------------------------------------------------------

template <typename T, int RQ>
__global__ void __launch_bounds__(kThreads)
flash_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ ell,
          const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dvo, int Tq,
          int S, int dh, int dv, int kv_tiles, float scale) {
  constexpr int BQ = 16 * RQ, LQ = BQ + 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dhp = round4(dh), dvp = round4(dv);
  float* Kt = smem;               // [dh][kLK]
  float* Vt = Kt + dh * kLK;      // [dv][kLK]
  float* Qt = Vt + dv * kLK;      // [dh][LQ]
  float* dOt = Qt + dh * LQ;      // [dv][LQ]
  float* Qn = dOt + dv * LQ;      // [BQ][dhp]
  float* dOn = Qn + BQ * dhp;     // [BQ][dvp]
  float* Pn = dOn + BQ * dvp;     // [BQ][kLK]
  float* dSn = Pn + BQ * kLK;     // [BQ][kLK]
  float* dKa = dSn + BQ * kLK;    // [kBK][dhp]
  float* dVa = dKa + kBK * dhp;   // [kBK][dvp]

  const int b = blockIdx.x / kv_tiles;
  const int s0 = (blockIdx.x - b * kv_tiles) * kBK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int i0 = ty * RQ, j0 = tx * 4;
  q += (size_t)b * Tq * dh;
  dout += (size_t)b * Tq * dv;
  k += (size_t)b * S * dh;
  v += (size_t)b * S * dv;
  ell += (size_t)b * Tq;
  delta += (size_t)b * Tq;

  stage_tile<T>(k, s0, S, kBK, dh, nullptr, 0, Kt, kLK);
  stage_tile<T>(v, s0, S, kBK, dv, nullptr, 0, Vt, kLK);
  for (int e = threadIdx.x; e < kBK * dhp; e += kThreads) dKa[e] = 0.f;
  for (int e = threadIdx.x; e < kBK * dvp; e += kThreads) dVa[e] = 0.f;

  for (int q0 = 0; q0 < Tq; q0 += BQ) {
    __syncthreads();
    stage_tile<T>(q, q0, Tq, BQ, dh, Qn, dhp, Qt, LQ);
    stage_tile<T>(dout, q0, Tq, BQ, dv, dOn, dvp, dOt, LQ);
    float ell_r[RQ], delta_r[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const bool in = q0 + i0 + i < Tq;
      ell_r[i] = in ? ell[q0 + i0 + i] : 0.f;
      delta_r[i] = in ? delta[q0 + i0 + i] : 0.f;
    }
    __syncthreads();

    float s[RQ][4], dov[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) { s[i][j] = 0.f; dov[i][j] = 0.f; }
    score_tile<RQ>(Qt, LQ, Kt, kLK, dh, i0, j0, s);
    score_tile<RQ>(dOt, LQ, Vt, kLK, dv, i0, j0, dov);
    p_and_ds<T, RQ>(s, dov, ell_r, delta_r, q0 + i0, s0 + j0, Tq, S, scale);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      Vec<4>::store(Pn + (i0 + i) * kLK + j0, s[i]);
      Vec<4>::store(dSn + (i0 + i) * kLK + j0, dov[i]);
    }
    __syncthreads();
    const int depth = min(BQ, Tq - q0);
    accumulate<kBK>(Pn, kLK, dOn, dvp, depth, dvp, dVa, dvp, nullptr, 1.f);
    accumulate<kBK>(dSn, kLK, Qn, dhp, depth, dhp, dKa, dhp, nullptr, scale);
  }

  __syncthreads();
  const int rows = min(kBK, S - s0);
  dk += ((size_t)b * S + s0) * dh;
  for (int e = threadIdx.x; e < rows * dh; e += kThreads) {
    const int r = e / dh, c = e - r * dh;
    dk[e] = from_f32<T>(dKa[r * dhp + c]);
  }
  dvo += ((size_t)b * S + s0) * dv;
  for (int e = threadIdx.x; e < rows * dv; e += kThreads) {
    const int r = e / dv, c = e - r * dv;
    dvo[e] = from_f32<T>(dVa[r * dvp + c]);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

inline int tiles_of(int n, int tile) { return (n + tile - 1) / tile; }

inline bool grid_fits(long long blocks) { return blocks > 0 && blocks <= 2147483647LL; }

template <typename T, int RQ>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* ell, int B,
                       int Tq, int S, int dh, int dv, float scale, cudaStream_t stream) {
  const int tiles = tiles_of(Tq, 16 * RQ);
  if (!grid_fits((long long)B * tiles)) return cudaErrorInvalidValue;
  const size_t smem = fwd_floats(dh, dv, 16 * RQ) * sizeof(float);
  cudaError_t err = allow_smem(flash_fwd<T, RQ>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd<T, RQ><<<B * tiles, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)ell, Tq, S, dh, dv, tiles, scale);
  return cudaGetLastError();
}

template <typename T, int RQ>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* ell, const void* delta, void* dq, int B, int Tq, int S,
                      int dh, int dv, float scale, cudaStream_t stream) {
  const int tiles = tiles_of(Tq, 16 * RQ);
  if (!grid_fits((long long)B * tiles)) return cudaErrorInvalidValue;
  const size_t smem = dq_floats(dh, dv, 16 * RQ) * sizeof(float);
  cudaError_t err = allow_smem(flash_dq<T, RQ>, smem);
  if (err != cudaSuccess) return err;
  flash_dq<T, RQ><<<B * tiles, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)ell,
      (const float*)delta, (T*)dq, Tq, S, dh, dv, tiles, scale);
  return cudaGetLastError();
}

template <typename T, int RQ>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* ell, const void* delta, void* dk, void* dvo, int B, int Tq,
                       int S, int dh, int dv, float scale, cudaStream_t stream) {
  const int tiles = tiles_of(S, kBK);
  if (!grid_fits((long long)B * tiles)) return cudaErrorInvalidValue;
  const size_t smem = dkv_floats(dh, dv, 16 * RQ) * sizeof(float);
  cudaError_t err = allow_smem(flash_dkv<T, RQ>, smem);
  if (err != cudaSuccess) return err;
  flash_dkv<T, RQ><<<B * tiles, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)ell,
      (const float*)delta, (T*)dk, (T*)dvo, Tq, S, dh, dv, tiles, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. `is_bf16` selects the compute
// dtype (1: bfloat16, 0: float32); `bq` is the q tile, 64 or 16 rows.
// Returns a cudaError_t (0 = launched).
#define FLASH_DISPATCH(fn, ...)                                             \
  do {                                                                      \
    if (bq == 64) {                                                         \
      if (is_bf16) return (int)fn<__nv_bfloat16, 4>(__VA_ARGS__);           \
      return (int)fn<float, 4>(__VA_ARGS__);                                \
    }                                                                       \
    if (bq == 16) {                                                         \
      if (is_bf16) return (int)fn<__nv_bfloat16, 1>(__VA_ARGS__);           \
      return (int)fn<float, 1>(__VA_ARGS__);                                \
    }                                                                       \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

extern "C" {

// kind 0: flash_fwd, 1: flash_dq, 2: flash_dkv.
size_t locate_flash_smem_bytes(int kind, int dh, int dv, int bq) {
  const size_t floats = kind == 0 ? fwd_floats(dh, dv, bq)
                        : kind == 1 ? dq_floats(dh, dv, bq) : dkv_floats(dh, dv, bq);
  return floats * sizeof(float);
}

// q (B, T, dh), k (B, S, dh), v (B, S, dv) in; o (B, T, dv) and ell (B, T) f32 out.
int locate_flash_fwd(int is_bf16, const void* q, const void* k, const void* v, void* o,
                     void* ell, int B, int T, int S, int dh, int dv, int bq, float scale,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  FLASH_DISPATCH(launch_fwd, q, k, v, o, ell, B, T, S, dh, dv, scale, s);
}

// dout (B, T, dv), ell and delta (B, T) f32 in; dq (B, T, dh) out.
int locate_flash_dq(int is_bf16, const void* q, const void* k, const void* v, const void* dout,
                    const void* ell, const void* delta, void* dq, int B, int T, int S, int dh,
                    int dv, int bq, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  FLASH_DISPATCH(launch_dq, q, k, v, dout, ell, delta, dq, B, T, S, dh, dv, scale, s);
}

// The inputs of locate_flash_dq; dk (B, S, dh) and dv_out (B, S, dv) out.
int locate_flash_dkv(int is_bf16, const void* q, const void* k, const void* v,
                     const void* dout, const void* ell, const void* delta, void* dk,
                     void* dv_out, int B, int T, int S, int dh, int dv, int bq, float scale,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  FLASH_DISPATCH(launch_dkv, q, k, v, dout, ell, delta, dk, dv_out, B, T, S, dh, dv, scale, s);
}

const char* locate_flash_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
