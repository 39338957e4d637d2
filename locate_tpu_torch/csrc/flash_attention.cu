// Flash (memory-linear) dot-product attention for sm_90a: forward, dQ and
// dK/dV, the kernels behind attention.kind="self".
//
//   O = softmax(Q K^T * scale) V        q (B, T, dh), k (B, S, dh), v (B, S, dv)
//
// Replaces the three Pallas kernels of locate_tpu/ops/pallas/flash_attention.py:
// `_fwd_kernel` (flash_fwd), `_dq_kernel` (flash_dq) and `_dkv_kernel`
// (flash_dkv), which share `_recompute_p_ds`. The (T, S) score matrix never
// reaches device memory: a block holds one (q tile, kv tile) of it at a time.
//
// What bounds them on this card: operations. The operands are O(T) and stay
// in L2, the work is O(T S): 2 B T S (dh + dv) flops forward, (2 dh + dv)
// for dQ, (2 dh + 2 dv) for dK/dV on the bf16 tensor cores, and B T S
// exponentials a pass on the 2,112 SFU lanes. At dh = 8 the exponentials
// are the larger floor, for the forward as for each backward pass (which
// recomputes P): the mma route keeps the other work of an element (its
// scale, max, sum and bf16 rounding) to a few FP32 instructions beside its
// one ex2, so that the SFU sets the pace.
//
// Two routes, chosen by the caller (ops/flash_attention.py:flash_route):
//
// * mma: bf16 forward, dQ and dK/dV on the tensor cores (flash_fwd_mma,
//   flash_dq_mma, flash_dkv_mma), templates on the padded head widths
//   (DH, DV) in FLASH_MMA_WIDTHS; the caller names the template a call runs
//   on (ops/flash_attention.py:mma_widths). dh and dv must be multiples of 8
//   and are zero-padded up to DH and DV in shared memory, never in device
//   memory (dh = 8 runs at the mma depth of 16).
//   - Every product is mma.sync.m16n8k16 (bf16 in, f32 accumulate) with
//     operands read by ldmatrix from bf16 tiles staged once each, in rows
//     padded by 8 elements so that the 8 rows of an ldmatrix fall in
//     distinct banks; ldmatrix.trans reads the same tile the other way.
//   - A block owns 16 rows a warp (q rows for the forward and dQ, kv rows
//     for dK/dV): 8 warps up to dv = 64, held to 128 registers so that two
//     blocks fit on an SM, 4 for the wider templates. It walks the other
//     side in tiles of 64 rows, double-buffered with cp.async, so that the
//     next tile's copy overlaps the current tile's products. Rows past the
//     end are zero-filled by the copy and masked out of P.
//   - flash_fwd_mma and flash_dq_mma keep the score tile with q along its
//     rows: the f32 fragment of P (forward) or dS (dQ), rounded to bf16, is
//     the A fragment of P V or dS K with no trip through shared memory.
//     flash_dkv_mma computes the transposed tile S^T = K Q^T (kv along its
//     rows), so P^T and dS^T are the A fragments of dV += P^T dO and
//     dK += dS^T Q; ell and delta are then per column and staged with each
//     q tile.
//   - Q (forward, dQ) or K (dK/dV) fragments, and dO (dQ, dv <= 64) or V
//     (dK/dV, dv <= 32), stay in registers for the whole walk, within the
//     128 registers of the 8-warp blocks; O, dQ, dK and dV accumulate in
//     registers, except O and dV at DV = 256 (T <= 64 on the model's path),
//     which accumulate in f32 shared memory, each warp over its own rows.
//   - The forward's online softmax lives in registers, in base 2: x = s *
//     scale * log2(e), the running row max m of x (from -1e30) and the sum
//     l of p = 2^(x - m) in f32, the accumulator rescaled by 2^(m_old -
//     m_new) a tile, o = acc / l and ell = m ln 2 + log l at the end. The
//     4 lanes that share a row reduce its max with two shuffles a tile and
//     its sum once, at the end. Scores past S are set to -1e30 before the
//     max.
//   - The backward's P = 2^(s * scale * log2(e) - ell * log2(e)): one FMA
//     and one ex2.approx an element; the ragged last tile alone masks P.
// * simt: every other call (f32, widths outside the templates): all
//   products as f32 FMAs on the CUDA cores from shared memory,
//   on register micro-tiles (RQ x 4 for the score tile, MR x 4 for the
//   accumulating products), operands staged as f32 in the orientation each
//   product reads with 16-byte loads, f32 accumulators in shared memory, so
//   dv = 256 fits and any dh, dv within 227 KB works; a q tile is 64 or 16
//   rows (template RQ), a kv tile 64. The bf16 kernels stay callable here
//   for comparison only.
//
// Both routes:
//  * The TPU grid's sequential innermost dimension is a loop inside the
//    block. Forward and dQ: one block owns one (batch, q tile) and walks
//    the kv tiles; dK/dV: one block owns one (batch, kv tile) and walks the
//    q tiles. No output is shared between blocks, so there are no atomics
//    and two runs are bitwise equal.
//  * Rounding as the TPU kernels: scores summed in f32 from compute-dtype
//    operands, exp in f32, P and dS rounded to the compute dtype before
//    their second product, f32 accumulation (dQ and dK scaled per tile on
//    the simt route, once at the end on the mma route), one cast at the
//    store. The running max starts at -1e30.
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
// bf16 forward, dQ and dK/dV on the tensor cores (the mma route)
// ---------------------------------------------------------------------------

// A block of the template (DH, DV) owns 16 rows a warp. Up to dv = 64 it
// is 8 warps (128 rows: each walked tile serves twice the rows of 4 warps)
// held to 128 registers a thread, so that two blocks fit on an SM; the wide
// templates, whose tiles would not fit twice, take 4.
__host__ __device__ constexpr int mma_warps(int DV) { return DV <= 64 ? 8 : 4; }
__host__ __device__ constexpr int mma_rows(int DV) { return 16 * mma_warps(DV); }
__host__ __device__ constexpr int mma_min_blocks(int DV) { return DV <= 64 ? 2 : 1; }
// Above DV = 128 an f32 accumulator of DV columns (O, dV) would take more
// registers than a thread has to spare: it lives in shared memory instead.
__host__ __device__ constexpr bool mma_acc_in_smem(int DV) { return DV > 128; }
constexpr int kMmaWalk = 64;  // rows of a walked tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x on the SFU (ex2.approx, subnormal results flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ROWS x width of a row-major (rows_total, width) bf16 matrix from row
// row0 into shared memory [ROWS][W + 8] by cp.async, 16 bytes a copy; rows
// past rows_total are zero-filled, columns width..W are left alone.
template <int ROWS, int W>
__device__ __forceinline__ void stage_async(bf16* dst, const bf16* src, int row0,
                                            int rows_total, int width) {
  const int chunks = width >> 3;
  for (int e = threadIdx.x; e < ROWS * chunks; e += blockDim.x) {
    const int r = e / chunks, c = (e - r * chunks) << 3;
    const bool valid = row0 + r < rows_total;
    cp_async16(dst + r * (W + 8) + c, valid ? src + (size_t)(row0 + r) * width + c : src, valid);
  }
}

// Zero the columns width..W of ROWS rows of a [ROWS][W + 8] tile: the
// padding up to the mma depth, written once and never copied over.
template <int ROWS, int W>
__device__ __forceinline__ void zero_pad(bf16* dst, int width) {
  const int chunks = (W - width) >> 3;
  for (int e = threadIdx.x; e < ROWS * chunks; e += blockDim.x) {
    const int r = e / chunks, c = width + ((e - r * chunks) << 3);
    *reinterpret_cast<uint4*>(dst + r * (W + 8) + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// ell and delta of the kMmaWalk rows from q0 into shared memory (zero past Tq).
__device__ __forceinline__ void stage_stats(float* ell_s, float* dl_s, const float* ell,
                                            const float* delta, int q0, int Tq) {
  for (int e = threadIdx.x; e < 2 * kMmaWalk; e += blockDim.x) {
    const int r = e & (kMmaWalk - 1);
    const bool valid = q0 + r < Tq;
    const float* src = e < kMmaWalk ? ell : delta;
    cp_async4((e < kMmaWalk ? ell_s : dl_s) + r, valid ? src + q0 + r : src, valid);
  }
}

// Rows row and row + 8 (those below `rows`) and the first `width` columns
// of a warp's accumulator fragments, times mult[0] (row) and mult[1]
// (row + 8), as bf16.
template <int NT>
__device__ __forceinline__ void store_frags(bf16* out, int ld, int row, int rows, int width,
                                            const float (&c)[NT][4], const float (&mult)[2]) {
  const int col = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n * 8 >= width) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row + 8 * h < rows)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row + 8 * h) * ld + n * 8 + col) =
            __floats2bfloat162_rn(c[n][2 * h] * mult[h], c[n][2 * h + 1] * mult[h]);
  }
}
template <int NT>
__device__ __forceinline__ void store_frags(bf16* out, int ld, int row, int rows, int width,
                                            const float (&c)[NT][4], float mult) {
  const float both[2] = {mult, mult};
  store_frags<NT>(out, ld, row, rows, width, c, both);
}

// acc (a warp's 16 rows, stride ld, f32 in shared memory) = acc * alpha0
// (rows 0-7) or alpha1 (rows 8-15) + fragments c, at columns col0..; each
// lane owns the positions of its fragments.
template <int NT>
__device__ __forceinline__ void add_frags(float* acc, int ld, const float (&c)[NT][4], int col0,
                                          float alpha0 = 1.f, float alpha1 = 1.f) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 2, col = col0 + 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float alpha = h ? alpha1 : alpha0;
      float2* p = reinterpret_cast<float2*>(acc + (r + 8 * h) * ld + n * 8 + col);
      float2 x = *p;
      x.x = x.x * alpha + c[n][2 * h];
      x.y = x.y * alpha + c[n][2 * h + 1];
      *p = x;
    }
}

// The fragments at columns col0.. of a warp's f32 accumulator in shared
// memory, from the positions add_frags gives this lane.
template <int NT>
__device__ __forceinline__ void load_frags(float (&c)[NT][4], const float* acc, int ld,
                                           int col0) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 2, col = col0 + 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 x = *reinterpret_cast<const float2*>(acc + (r + 8 * h) * ld + n * 8 + col);
      c[n][2 * h] = x.x;
      c[n][2 * h + 1] = x.y;
    }
}

// Max and sum over the 4 lanes that hold one row of an mma fragment.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Shared-memory bytes of one block of the mma kernels (kind 0: forward,
// 1: dQ, 2: dK/dV).
__host__ __device__ inline size_t fwd_mma_bytes(int DH, int DV) {
  return ((size_t)mma_rows(DV) * (DH + 8) + 2 * kMmaWalk * ((DH + 8) + (DV + 8))) *
             sizeof(bf16) +
         (mma_acc_in_smem(DV) ? (size_t)mma_rows(DV) * (DV + 8) * sizeof(float) : 0);
}
__host__ __device__ inline size_t dq_mma_bytes(int DH, int DV) {
  return (size_t)(mma_rows(DV) + 2 * kMmaWalk) * ((DH + 8) + (DV + 8)) * sizeof(bf16);
}
__host__ __device__ inline size_t dkv_mma_bytes(int DH, int DV) {
  return dq_mma_bytes(DH, DV) + 4 * kMmaWalk * sizeof(float) +
         (mma_acc_in_smem(DV) ? (size_t)mma_rows(DV) * (DV + 8) * sizeof(float) : 0);
}

// Forward: block = (batch row, mma_rows(DV) q rows), loop over kv tiles of
// 64 with the online softmax in registers (base 2, see the header).
template <int DH, int DV>
__global__ void __launch_bounds__(32 * mma_warps(DV), mma_min_blocks(DV))
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              bf16* __restrict__ o, float* __restrict__ ell, int Tq, int S, int dh, int dv,
              int q_tiles, float scale) {
  constexpr int LH = DH + 8, LV = DV + 8, LA = DV + 8, kRows = mma_rows(DV);
  constexpr bool kShared = mma_acc_in_smem(DV);  // O accumulates in shared memory
  extern __shared__ float4 smem4[];
  float* Oa = reinterpret_cast<float*>(smem4);                           // [kRows][LA] where kShared
  bf16* Qs = reinterpret_cast<bf16*>(Oa + (kShared ? kRows * LA : 0));  // [kRows][LH]
  bf16* Ks = Qs + kRows * LH;                                            // [2][kMmaWalk][LH]
  bf16* Vs = Ks + 2 * kMmaWalk * LH;                                     // [2][kMmaWalk][LV]

  const int b = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - b * q_tiles) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = q0 + warp * 16 + (lane >> 2);  // this lane's rows: row, row + 8
  const bool active = q0 + warp * 16 < Tq;
  float* Ow = Oa + warp * 16 * LA;  // this warp's rows of the shared accumulator
  q += (size_t)b * Tq * dh;
  k += (size_t)b * S * dh;
  v += (size_t)b * S * dv;

  zero_pad<kRows, DH>(Qs, dh);
  zero_pad<2 * kMmaWalk, DH>(Ks, dh);
  zero_pad<2 * kMmaWalk, DV>(Vs, dv);
  stage_async<kRows, DH>(Qs, q, q0, Tq, dh);
  stage_async<kMmaWalk, DH>(Ks, k, 0, S, dh);
  stage_async<kMmaWalk, DV>(Vs, v, 0, S, dv);
  cp_async_commit();
  if constexpr (kShared) {
    for (int e = lane; e < 16 * LA; e += 32) Ow[e] = 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) frag_a(qa[kk], Qs, LH, warp * 16, kk * 16);
  float acc[kShared ? 1 : DV / 8][4];
  zero(acc);
  // rows row and row + 8: the running max of x and this lane's part of the
  // running sum of p (the lane's 2 columns of each n-tile)
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};

  const float c = scale * kLog2e;
  const int kv_tiles = (S + kMmaWalk - 1) / kMmaWalk;
  for (int j = 0; j < kv_tiles; ++j) {
    if (j + 1 < kv_tiles) {  // the next tile's copy runs under this tile's products
      const int nb = (j + 1) & 1;
      stage_async<kMmaWalk, DH>(Ks + nb * kMmaWalk * LH, k, (j + 1) * kMmaWalk, S, dh);
      stage_async<kMmaWalk, DV>(Vs + nb * kMmaWalk * LV, v, (j + 1) * kMmaWalk, S, dv);
      cp_async_commit();
    }
    if (active) {
      const bf16* Kt = Ks + (j & 1) * kMmaWalk * LH;
      const bf16* Vt = Vs + (j & 1) * kMmaWalk * LV;
      float s[8][4];
      zero(s);
      mma_nk<DH / 16, 8>(s, qa, Kt, LH);  // S = Q K^T
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= c;  // x
      if ((j + 1) * kMmaWalk > S) {  // the last tile: no score past S
        const int col = j * kMmaWalk + 2 * (lane & 3);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + n * 8 + (e & 1) >= S) s[n][e] = kNegBig;
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegBig;
#pragma unroll
        for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
        const float m_next = fmaxf(m[h], quad_max(mx));
        alpha[h] = ex2(m[h] - m_next);
        m[h] = m_next;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = ex2(s[n][e] - m[e >> 1]);  // P, unrounded in the sum
          l[e >> 1] += s[n][e];
        }
      uint32_t pa[4][4];
      to_a_frags(pa, s);
      if constexpr (kShared) {
#pragma unroll
        for (int chunk = 0; chunk < DV / 64; ++chunk) {
          float part[8][4];
          zero(part);
          mma_kn<4, 8>(part, pa, Vt, LV, chunk * 64);  // O = O alpha + P V
          add_frags<8>(Ow, LA, part, chunk * 64, alpha[0], alpha[1]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < DV / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
        mma_kn<4, DV / 8>(acc, pa, Vt, LV, 0);  // O = O alpha + P V
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
  if (!active) return;
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    inv[h] = 1.f / l[h];
  }
  bf16* out = o + (size_t)b * Tq * dv;
  if constexpr (kShared) {
#pragma unroll
    for (int chunk = 0; chunk < DV / 64; ++chunk) {
      float part[8][4];
      load_frags<8>(part, Ow, LA, chunk * 64);
      store_frags<8>(out + chunk * 64, dv, row, Tq, dv - chunk * 64, part, inv);
    }
  } else {
    store_frags<DV / 8>(out, dv, row, Tq, dv, acc, inv);
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row + 8 * h < Tq) ell[(size_t)b * Tq + row + 8 * h] = m[h] * kLn2 + logf(l[h]);
  }
}

// dQ: block = (batch row, mma_rows(DV) q rows), loop over kv tiles of 64.
template <int DH, int DV>
__global__ void __launch_bounds__(32 * mma_warps(DV), mma_min_blocks(DV))
flash_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const bf16* __restrict__ dout, const float* __restrict__ ell,
             const float* __restrict__ delta, bf16* __restrict__ dq, int Tq, int S, int dh,
             int dv, int q_tiles, float scale) {
  constexpr int LH = DH + 8, LV = DV + 8, kRows = mma_rows(DV);
  constexpr bool kHold = DV <= 64;  // dO's fragments stay in registers
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // [kRows][LH]
  bf16* dOs = Qs + kRows * LH;                // [kRows][LV]
  bf16* Ks = dOs + kRows * LV;                // [2][kMmaWalk][LH]
  bf16* Vs = Ks + 2 * kMmaWalk * LH;          // [2][kMmaWalk][LV]

  const int b = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - b * q_tiles) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = q0 + warp * 16 + (lane >> 2);  // this lane's rows: row, row + 8
  const bool active = q0 + warp * 16 < Tq;
  q += (size_t)b * Tq * dh;
  dout += (size_t)b * Tq * dv;
  k += (size_t)b * S * dh;
  v += (size_t)b * S * dv;

  zero_pad<kRows, DH>(Qs, dh);
  zero_pad<kRows, DV>(dOs, dv);
  zero_pad<2 * kMmaWalk, DH>(Ks, dh);
  zero_pad<2 * kMmaWalk, DV>(Vs, dv);
  stage_async<kRows, DH>(Qs, q, q0, Tq, dh);
  stage_async<kRows, DV>(dOs, dout, q0, Tq, dv);
  stage_async<kMmaWalk, DH>(Ks, k, 0, S, dh);
  stage_async<kMmaWalk, DV>(Vs, v, 0, S, dv);
  cp_async_commit();

  const float c = scale * kLog2e;
  float ell_r[2], dl_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row + 8 * h < Tq;
    ell_r[h] = in ? ell[(size_t)b * Tq + row + 8 * h] * kLog2e : 0.f;
    dl_r[h] = in ? delta[(size_t)b * Tq + row + 8 * h] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  uint32_t qa[DH / 16][4];
  uint32_t oa[kHold ? DV / 16 : 1][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) frag_a(qa[kk], Qs, LH, warp * 16, kk * 16);
  if constexpr (kHold) {
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) frag_a(oa[kk], dOs, LV, warp * 16, kk * 16);
  }
  float acc[DH / 8][4];
  zero(acc);

  const int kv_tiles = (S + kMmaWalk - 1) / kMmaWalk;
  for (int j = 0; j < kv_tiles; ++j) {
    if (j + 1 < kv_tiles) {  // the next tile's copy runs under this tile's products
      const int nb = (j + 1) & 1;
      stage_async<kMmaWalk, DH>(Ks + nb * kMmaWalk * LH, k, (j + 1) * kMmaWalk, S, dh);
      stage_async<kMmaWalk, DV>(Vs + nb * kMmaWalk * LV, v, (j + 1) * kMmaWalk, S, dv);
      cp_async_commit();
    }
    if (active) {
      const bf16* Kt = Ks + (j & 1) * kMmaWalk * LH;
      const bf16* Vt = Vs + (j & 1) * kMmaWalk * LV;
      float s[8][4], dp[8][4];
      zero(s);
      zero(dp);
      mma_nk<DH / 16, 8>(s, qa, Kt, LH);  // S = Q K^T
      if constexpr (kHold)
        mma_nk<DV / 16, 8>(dp, oa, Vt, LV);  // dP = dO V^T
      else
        mma_nk_smem<DV / 16, 8>(dp, dOs, LV, warp * 16, Vt, LV);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = ex2(fmaf(s[n][e], c, -ell_r[e >> 1]));  // P
      if ((j + 1) * kMmaWalk > S) {  // the last tile: P is 0 past S
        const int col = j * kMmaWalk + 2 * (lane & 3);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + n * 8 + (e & 1) >= S) s[n][e] = 0.f;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * (dp[n][e] - dl_r[e >> 1]);  // dS
      uint32_t dsa[4][4];
      to_a_frags(dsa, dp);
      mma_kn<4, DH / 8>(acc, dsa, Kt, LH, 0);  // dQ += dS K
    }
    cp_async_wait_all();
    __syncthreads();
  }
  if (active) store_frags<DH / 8>(dq + (size_t)b * Tq * dh, dh, row, Tq, dh, acc, scale);
}

// dK, dV: block = (batch row, mma_rows(DV) kv rows), loop over q tiles of 64.
template <int DH, int DV>
__global__ void __launch_bounds__(32 * mma_warps(DV), mma_min_blocks(DV))
flash_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ dout, const float* __restrict__ ell,
              const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dvo,
              int Tq, int S, int dh, int dv, int kv_tiles, float scale) {
  constexpr int LH = DH + 8, LV = DV + 8, LA = DV + 8, kRows = mma_rows(DV);
  constexpr bool kHold = DV <= 32;    // V's fragments stay in registers
  constexpr bool kShared = mma_acc_in_smem(DV);  // dV accumulates in shared memory
  extern __shared__ float4 smem4[];
  float* ell_s = reinterpret_cast<float*>(smem4);  // [2][kMmaWalk]
  float* dl_s = ell_s + 2 * kMmaWalk;              // [2][kMmaWalk]
  float* dVa = dl_s + 2 * kMmaWalk;                // [kRows][LA] where kShared
  bf16* Ks = reinterpret_cast<bf16*>(dVa + (kShared ? kRows * LA : 0));  // [kRows][LH]
  bf16* Vs = Ks + kRows * LH;                      // [kRows][LV]
  bf16* Qs = Vs + kRows * LV;                      // [2][kMmaWalk][LH]
  bf16* dOs = Qs + 2 * kMmaWalk * LH;              // [2][kMmaWalk][LV]

  const int b = blockIdx.x / kv_tiles;
  const int s0 = (blockIdx.x - b * kv_tiles) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = s0 + warp * 16 + (lane >> 2);  // this lane's kv rows: row, row + 8
  const bool active = s0 + warp * 16 < S;
  q += (size_t)b * Tq * dh;
  dout += (size_t)b * Tq * dv;
  k += (size_t)b * S * dh;
  v += (size_t)b * S * dv;
  ell += (size_t)b * Tq;
  delta += (size_t)b * Tq;

  zero_pad<kRows, DH>(Ks, dh);
  zero_pad<kRows, DV>(Vs, dv);
  zero_pad<2 * kMmaWalk, DH>(Qs, dh);
  zero_pad<2 * kMmaWalk, DV>(dOs, dv);
  stage_async<kRows, DH>(Ks, k, s0, S, dh);
  stage_async<kRows, DV>(Vs, v, s0, S, dv);
  stage_async<kMmaWalk, DH>(Qs, q, 0, Tq, dh);
  stage_async<kMmaWalk, DV>(dOs, dout, 0, Tq, dv);
  stage_stats(ell_s, dl_s, ell, delta, 0, Tq);
  cp_async_commit();
  if constexpr (kShared) {
    for (int e = lane; e < 16 * LA; e += 32) dVa[warp * 16 * LA + e] = 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  uint32_t ka[DH / 16][4];
  uint32_t va[kHold ? DV / 16 : 1][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) frag_a(ka[kk], Ks, LH, warp * 16, kk * 16);
  if constexpr (kHold) {
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) frag_a(va[kk], Vs, LV, warp * 16, kk * 16);
  }
  float dka[DH / 8][4];
  float dva[kShared ? 2 : DV / 8][4];
  zero(dka);
  zero(dva);

  const float c = scale * kLog2e;
  const int q_tiles = (Tq + kMmaWalk - 1) / kMmaWalk;
  for (int i = 0; i < q_tiles; ++i) {
    if (i + 1 < q_tiles) {  // the next tile's copy runs under this tile's products
      const int nb = (i + 1) & 1, n0 = (i + 1) * kMmaWalk;
      stage_async<kMmaWalk, DH>(Qs + nb * kMmaWalk * LH, q, n0, Tq, dh);
      stage_async<kMmaWalk, DV>(dOs + nb * kMmaWalk * LV, dout, n0, Tq, dv);
      stage_stats(ell_s + nb * kMmaWalk, dl_s + nb * kMmaWalk, ell, delta, n0, Tq);
      cp_async_commit();
    }
    if (active) {
      const bf16* Qt = Qs + (i & 1) * kMmaWalk * LH;
      const bf16* dOt = dOs + (i & 1) * kMmaWalk * LV;
      const float* el = ell_s + (i & 1) * kMmaWalk;
      const float* dl = dl_s + (i & 1) * kMmaWalk;
      float s[8][4], dp[8][4];
      zero(s);
      zero(dp);
      mma_nk<DH / 16, 8>(s, ka, Qt, LH);  // S^T = K Q^T
      if constexpr (kHold)
        mma_nk<DV / 16, 8>(dp, va, dOt, LV);  // dP^T = V dO^T
      else
        mma_nk_smem<DV / 16, 8>(dp, Vs, LV, warp * 16, dOt, LV);
      const int cl = 2 * (lane & 3);  // this lane's first column of each n-tile
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 e2 = *reinterpret_cast<const float2*>(el + n * 8 + cl);
        const float lse[2] = {e2.x * kLog2e, e2.y * kLog2e};
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = ex2(fmaf(s[n][e], c, -lse[e & 1]));  // P^T
      }
      if ((i + 1) * kMmaWalk > Tq) {  // the last tile: P^T is 0 past Tq
        const int col = i * kMmaWalk + cl;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + n * 8 + (e & 1) >= Tq) s[n][e] = 0.f;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 d2 = *reinterpret_cast<const float2*>(dl + n * 8 + cl);
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * (dp[n][e] - (e & 1 ? d2.y : d2.x));
      }
      uint32_t pa[4][4], dsa[4][4];
      to_a_frags(pa, s);
      to_a_frags(dsa, dp);
      if constexpr (kShared) {
#pragma unroll
        for (int chunk = 0; chunk < DV / 64; ++chunk) {
          float part[8][4];
          zero(part);
          mma_kn<4, 8>(part, pa, dOt, LV, chunk * 64);  // dV += P^T dO
          add_frags<8>(dVa + warp * 16 * LA, LA, part, chunk * 64);
        }
      } else {
        mma_kn<4, DV / 8>(dva, pa, dOt, LV, 0);  // dV += P^T dO
      }
      mma_kn<4, DH / 8>(dka, dsa, Qt, LH, 0);  // dK += dS^T Q
    }
    cp_async_wait_all();
    __syncthreads();
  }
  if (!active) return;
  store_frags<DH / 8>(dk + (size_t)b * S * dh, dh, row, S, dh, dka, scale);
  if constexpr (kShared) {
    __syncwarp();
    const int r0 = s0 + warp * 16;
    bf16* out = dvo + ((size_t)b * S + r0) * dv;
    for (int e = lane; e < 16 * dv; e += 32) {
      const int r = e / dv, col = e - r * dv;
      if (r0 + r < S) out[e] = __float2bfloat16(dVa[(warp * 16 + r) * LA + col]);
    }
  } else {
    store_frags<DV / 8>(dvo + (size_t)b * S * dv, dv, row, S, dv, dva, 1.f);
  }
}

// (DH, DV) of the instantiated mma templates. Which one a call runs on is
// the caller's choice (ops/flash_attention.py:MMA_WIDTHS and mma_widths);
// the C interface takes that pair and dispatches it exactly.
#define FLASH_MMA_WIDTHS(X) X(16, 16) X(16, 32) X(16, 64) X(32, 128) X(64, 256)

// True where (DH, DV) is an instantiated template.
inline bool mma_template(int DH, int DV) {
#define FLASH_IS(a, b) \
  if (DH == a && DV == b) return true;
  FLASH_MMA_WIDTHS(FLASH_IS)
#undef FLASH_IS
  return false;
}

// True where the template (DH, DV) can run (dh, dv): multiples of 8 (the
// 16-byte copies of a bf16 row) that it holds.
inline bool mma_holds(int DH, int DV, int dh, int dv) {
  return mma_template(DH, DV) && dh >= 1 && dv >= 1 && dh % 8 == 0 && dv % 8 == 0 && dh <= DH &&
         dv <= DV;
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

template <int DH, int DV>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v, void* o, void* ell, int B,
                           int Tq, int S, int dh, int dv, float scale, cudaStream_t stream) {
  const int tiles = tiles_of(Tq, mma_rows(DV));
  if (!grid_fits((long long)B * tiles)) return cudaErrorInvalidValue;
  const size_t smem = fwd_mma_bytes(DH, DV);
  cudaError_t err = allow_smem(flash_fwd_mma<DH, DV>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_mma<DH, DV><<<B * tiles, 32 * mma_warps(DV), smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)ell, Tq, S, dh, dv, tiles,
      scale);
  return cudaGetLastError();
}

template <int DH, int DV>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                          const void* ell, const void* delta, void* dq, int B, int Tq, int S,
                          int dh, int dv, float scale, cudaStream_t stream) {
  const int tiles = tiles_of(Tq, mma_rows(DV));
  if (!grid_fits((long long)B * tiles)) return cudaErrorInvalidValue;
  const size_t smem = dq_mma_bytes(DH, DV);
  cudaError_t err = allow_smem(flash_dq_mma<DH, DV>, smem);
  if (err != cudaSuccess) return err;
  flash_dq_mma<DH, DV><<<B * tiles, 32 * mma_warps(DV), smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)ell,
      (const float*)delta, (bf16*)dq, Tq, S, dh, dv, tiles, scale);
  return cudaGetLastError();
}

template <int DH, int DV>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                           const void* ell, const void* delta, void* dk, void* dvo, int B, int Tq,
                           int S, int dh, int dv, float scale, cudaStream_t stream) {
  const int tiles = tiles_of(S, mma_rows(DV));
  if (!grid_fits((long long)B * tiles)) return cudaErrorInvalidValue;
  const size_t smem = dkv_mma_bytes(DH, DV);
  cudaError_t err = allow_smem(flash_dkv_mma<DH, DV>, smem);
  if (err != cudaSuccess) return err;
  flash_dkv_mma<DH, DV><<<B * tiles, 32 * mma_warps(DV), smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)ell,
      (const float*)delta, (bf16*)dk, (bf16*)dvo, Tq, S, dh, dv, tiles, scale);
  return cudaGetLastError();
}

// Blocks of `kernel` that fit on one SM at once (threads, registers, shared
// memory), 0 where its shared memory is refused; -(cudaError_t) where the
// query fails otherwise (the error cleared).
template <typename K>
int occupancy(K kernel, int threads, size_t smem) {
  if (allow_smem(kernel, smem) != cudaSuccess) return 0;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return n;
}

template <typename T, int RQ>
int simt_blocks(int kind, int dh, int dv) {
  const int bq = 16 * RQ;
  if (kind == 0) return occupancy(flash_fwd<T, RQ>, kThreads, fwd_floats(dh, dv, bq) * 4);
  if (kind == 1) return occupancy(flash_dq<T, RQ>, kThreads, dq_floats(dh, dv, bq) * 4);
  return occupancy(flash_dkv<T, RQ>, kThreads, dkv_floats(dh, dv, bq) * 4);
}

template <int DH, int DV>
int mma_blocks(int kind) {
  const int threads = 32 * mma_warps(DV);
  if (kind == 0) return occupancy(flash_fwd_mma<DH, DV>, threads, fwd_mma_bytes(DH, DV));
  if (kind == 1) return occupancy(flash_dq_mma<DH, DV>, threads, dq_mma_bytes(DH, DV));
  return occupancy(flash_dkv_mma<DH, DV>, threads, dkv_mma_bytes(DH, DV));
}

constexpr int kRouteSimt = 0, kRouteMma = 1;

// The mma template (DH, DV) launched on (dh, dv); cudaErrorInvalidValue
// where it is not instantiated or does not hold the widths.
cudaError_t fwd_mma(const void* q, const void* k, const void* v, void* o, void* ell, int B, int Tq,
                    int S, int dh, int dv, int DH, int DV, float scale, cudaStream_t stream) {
  if (!mma_holds(DH, DV, dh, dv)) return cudaErrorInvalidValue;
#define FLASH_CALL(a, b)                                                                   \
  if (DH == a && DV == b)                                                                  \
    return launch_fwd_mma<a, b>(q, k, v, o, ell, B, Tq, S, dh, dv, scale, stream);
  FLASH_MMA_WIDTHS(FLASH_CALL)
#undef FLASH_CALL
  return cudaErrorInvalidValue;
}

cudaError_t dq_mma(const void* q, const void* k, const void* v, const void* dout,
                   const void* ell, const void* delta, void* dq, int B, int Tq, int S, int dh,
                   int dv, int DH, int DV, float scale, cudaStream_t stream) {
  if (!mma_holds(DH, DV, dh, dv)) return cudaErrorInvalidValue;
#define FLASH_CALL(a, b)                                                                   \
  if (DH == a && DV == b)                                                                  \
    return launch_dq_mma<a, b>(q, k, v, dout, ell, delta, dq, B, Tq, S, dh, dv, scale, stream);
  FLASH_MMA_WIDTHS(FLASH_CALL)
#undef FLASH_CALL
  return cudaErrorInvalidValue;
}

cudaError_t dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                    const void* ell, const void* delta, void* dk, void* dvo, int B, int Tq,
                    int S, int dh, int dv, int DH, int DV, float scale, cudaStream_t stream) {
  if (!mma_holds(DH, DV, dh, dv)) return cudaErrorInvalidValue;
#define FLASH_CALL(a, b)                                                                  \
  if (DH == a && DV == b)                                                                 \
    return launch_dkv_mma<a, b>(q, k, v, dout, ell, delta, dk, dvo, B, Tq, S, dh, dv, scale, \
                                stream);
  FLASH_MMA_WIDTHS(FLASH_CALL)
#undef FLASH_CALL
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, loaded with ctypes. `route` selects the kernel of a
// pass (0: simt, 1: mma, bf16 only); `is_bf16` the compute
// dtype (1: bfloat16, 0: float32); `bq` the simt route's q tile, 64 or 16
// rows; `DH`, `DV` the mma route's template (0 on the simt route, whose
// kernels take any widths, and `bq` 0 on the mma route, whose blocks are
// the template's). Returns a cudaError_t (0 = launched).
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

// kind 0: flash_fwd, 1: flash_dq, 2: flash_dkv, on the simt route.
size_t locate_flash_smem_bytes(int kind, int dh, int dv, int bq) {
  const size_t floats = kind == 0 ? fwd_floats(dh, dv, bq)
                        : kind == 1 ? dq_floats(dh, dv, bq) : dkv_floats(dh, dv, bq);
  return floats * sizeof(float);
}

// kind 0: flash_fwd, 1: flash_dq, 2: flash_dkv, on the mma route: the
// bytes of the template (DH, DV), 0 where it is not instantiated.
size_t locate_flash_mma_smem_bytes(int kind, int DH, int DV) {
  if (kind < 0 || kind > 2 || !mma_template(DH, DV)) return 0;
  return kind == 0 ? fwd_mma_bytes(DH, DV) : kind == 1 ? dq_mma_bytes(DH, DV)
                                                       : dkv_mma_bytes(DH, DV);
}

// Blocks of a kernel that fit on one SM at once; 0 where there is no such
// kernel or its shared memory is refused. On the mma route (dh, dv) name
// the template.
int locate_flash_blocks_per_sm(int route, int kind, int is_bf16, int dh, int dv, int bq) {
  if (route == kRouteMma) {
    const int DH = dh, DV = dv;
    if (!is_bf16 || kind < 0 || kind > 2 || !mma_template(DH, DV)) return 0;
#define FLASH_MMA_BLOCKS(a, b) \
    if (DH == a && DV == b) return mma_blocks<a, b>(kind);
    FLASH_MMA_WIDTHS(FLASH_MMA_BLOCKS)
#undef FLASH_MMA_BLOCKS
    return 0;
  }
  if (bq == 64) return is_bf16 ? simt_blocks<__nv_bfloat16, 4>(kind, dh, dv)
                               : simt_blocks<float, 4>(kind, dh, dv);
  if (bq == 16) return is_bf16 ? simt_blocks<__nv_bfloat16, 1>(kind, dh, dv)
                               : simt_blocks<float, 1>(kind, dh, dv);
  return 0;
}

// q (B, T, dh), k (B, S, dh), v (B, S, dv) in; o (B, T, dv) and ell (B, T) f32 out.
int locate_flash_fwd(int route, int is_bf16, const void* q, const void* k, const void* v,
                     void* o, void* ell, int B, int T, int S, int dh, int dv, int bq, int DH,
                     int DV, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == kRouteMma) {
    if (!is_bf16) return (int)cudaErrorInvalidValue;
    return (int)fwd_mma(q, k, v, o, ell, B, T, S, dh, dv, DH, DV, scale, s);
  }
  if (route != kRouteSimt) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(launch_fwd, q, k, v, o, ell, B, T, S, dh, dv, scale, s);
}

// dout (B, T, dv), ell and delta (B, T) f32 in; dq (B, T, dh) out.
int locate_flash_dq(int route, int is_bf16, const void* q, const void* k, const void* v,
                    const void* dout, const void* ell, const void* delta, void* dq, int B, int T,
                    int S, int dh, int dv, int bq, int DH, int DV, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == kRouteMma) {
    if (!is_bf16) return (int)cudaErrorInvalidValue;
    return (int)dq_mma(q, k, v, dout, ell, delta, dq, B, T, S, dh, dv, DH, DV, scale, s);
  }
  if (route != kRouteSimt) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(launch_dq, q, k, v, dout, ell, delta, dq, B, T, S, dh, dv, scale, s);
}

// The inputs of locate_flash_dq; dk (B, S, dh) and dv_out (B, S, dv) out.
int locate_flash_dkv(int route, int is_bf16, const void* q, const void* k, const void* v,
                     const void* dout, const void* ell, const void* delta, void* dk,
                     void* dv_out, int B, int T, int S, int dh, int dv, int bq, int DH, int DV,
                     float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == kRouteMma) {
    if (!is_bf16) return (int)cudaErrorInvalidValue;
    return (int)dkv_mma(q, k, v, dout, ell, delta, dk, dv_out, B, T, S, dh, dv, DH, DV, scale, s);
  }
  if (route != kRouteSimt) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(launch_dkv, q, k, v, dout, ell, delta, dk, dv_out, B, T, S, dh, dv, scale, s);
}

const char* locate_flash_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
