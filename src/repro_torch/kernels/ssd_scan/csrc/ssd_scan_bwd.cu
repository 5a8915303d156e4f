// K3b: the backward of the Mamba2 SSD scan (K3, ssd_scan.cu) for Hopper
// (sm_90a), bound to Python through ctypes.
//
// Replaces no TPU kernel: the JAX package trains through jax.grad of its
// plain scan (src/repro/models/ssm.py::ssd_chunked), and its Pallas kernel
// (src/repro/kernels/ssd_scan/kernel.py::ssd_chunk_pallas) has no backward.
// K3b lets the port train mamba2 through K3 on the card.  For one (batch,
// head) and chunk c of L rows, i and j rows of the chunk, dacs_i the
// cumulative sum of dt a inside the chunk, T = dacs_{L-1}, S_c the chunk's
// inbound state (K3 writes it when a gradient will be asked for), G_c the
// gradient reaching the state after the chunk (G_last = dfinal):
//
//   G_{c-1} = exp(T) G_c + sum_i exp(dacs_i) dy_i (x) C_i
//   dx_j = dt_j [sum_{i>=j} (C_i.B_j) exp(dacs_i - dacs_j) dy_i
//                + exp(T - dacs_j) G_c B_j]
//   dC_i = sum_{j<=i} (dy_i.x_j) dt_j exp(dacs_i - dacs_j) B_j
//          + exp(dacs_i) S_c^T dy_i
//   dB_j = sum_{i>=j} (dy_i.x_j) dt_j exp(dacs_i - dacs_j) C_i
//          + exp(T - dacs_j) dt_j G_c^T x_j
//
// and the exponents' gradients: with M_ij = (C_i.B_j)(dy_i.x_j) dt_j
// exp(dacs_i - dacs_j) for i > j, d dacs_i gets sum_j M_ij - sum_k M_ki,
// plus exp(dacs_i) dy_i.(S_c C_i), minus q_i = dt_i x_i.(exp(T - dacs_i)
// G_c B_i); d dacs_{L-1} also gets dT = sum_i q_i + exp(T) <G_c, S_c>.  A
// reverse cumulative sum inside the chunk turns d dacs into d(dt a), so
// ddt_j = x_j.(dx_j / dt_j) + a d(dt a)_j and da = sum dt d(dt a) over the
// batch and the sequence; the q_i are summed from the top of the chunk
// instead (ref.py::ssd_scan_bwd_ref writes the sum out), and the diagonal
// of M, whose exponent is 0, is left out.  The initial state's gradient is
// G_{-1}.
//
// Four kernels a launch, all deterministic (no atomics):
//   1. bwd_state_local, one block per (batch, chunk, head): each chunk's
//      sum_i exp(dacs_i) dy_i (x) C_i and its total decay T;
//   2. bwd_state_scan, one thread per state element: the reverse
//      recurrence over the chunks, leaving G_c in place of chunk c's sum,
//      and the initial state's gradient;
//   3. bwd_chunk, one block per (batch, chunk, head): everything above
//      inside the chunk, by 64-row tiles (j tiles outer, the i tiles at or
//      below the diagonal inner), from C, B, x and dy staged in shared
//      memory as f32; dx, ddt and the chunk's partial da are written, dB
//      and dC as f32 partials of the head ([B, S, H, N]): B and C belong to
//      a group of heads (mamba2-370m has 32 heads in one group), and
//      atomics would not give equal bits twice;
//   4. bwd_reduce: dB and dC as each group's heads' partials summed in
//      order (in double), and da as the (batch, chunk) partials summed in
//      order.
// Every product is scalar f32 FMAs on a 16 x 16 thread grid, each thread a
// 4 x (width / 16) patch, from shared memory padded one float a row (no
// bank conflicts); bf16 inputs are exact in f32, and dx, dB and dC are
// rounded once at the end.  The masks go on the exponents before exp, as
// in K3: exp(dacs_i - dacs_j) for i < j overflows.  The state terms read
// K3's f32 states and G_c whole (no bf16 split: nothing here goes through
// the tensor cores).
//
// Bound on an H100 at mamba2-370m's train step (B=4, S=2048, 32 heads of
// P=64, N=128, one group, L=256): about 180 MB (x, dy, dx, B, C, dB, dC, dt,
// ddt and K3's states: 0.054 ms at 3.35 TB/s) against 51.7 GFLOP (0.052 ms
// at the bf16 tensor-core peak, 0.77 ms at the f32 FMA peak this kernel
// uses): a simple, right kernel first; moving its products onto wgmma is
// later work (PERF.md has its times).  Its scratch is 2 x 134 MB of f32
// partials of dB and dC at that shape.  L is a multiple of 64 up to 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kMaxChunk = 256;
constexpr int kThreads = 256;
constexpr int kLd = kTile + 1;   // a padded row of a 64 x 64 score tile

// x, B, C by their (batch, seq, head-or-group) strides in elements, last dim
// contiguous; dt, dy, dx, ddt contiguous.
struct Problem {
  int heads, hpg, seqlen, chunk;
  long long x_sb, x_ss, x_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// dst[r][k] (rows of W + 1 floats) = src[r * stride + k] * scale_r, r < 64
template <int W, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long stride,
                                          const float* scale = nullptr) {
  for (int e = threadIdx.x; e < kTile * W; e += kThreads) {
    const int r = e / W, k = e % W;
    const float v = to_f(src[r * stride + k]);
    dst[r * (W + 1) + k] = scale != nullptr ? v * scale[r] : v;
  }
}

// The chunk's dt and dacs (a scan in double, rounded once to f32, as K3's
// f32 path takes it); ends with a barrier.
__device__ __forceinline__ void chunk_decays(float* sDa, float* sDt,
                                             const float* dt, float ah,
                                             long long t_off, int heads,
                                             int L) {
  for (int j = threadIdx.x; j < L; j += kThreads)
    sDt[j] = dt[t_off + static_cast<long long>(j) * heads];
  __syncthreads();
  if (threadIdx.x == 0) {
    double acc = 0.0;
    for (int j = 0; j < L; ++j) {
      acc += static_cast<double>(sDt[j] * ah);
      sDa[j] = static_cast<float>(acc);
    }
  }
  __syncthreads();
}

// acc[i][j] += sum_{k < K} A(ty RI + i, k) B(tx + 16 j, k), with ty =
// threadIdx.x / 16 and tx = threadIdx.x % 16; A(r, k) = A[r lda + k], or
// A[k lda + r] when AT; B likewise.  Every lda and ldb is 1 mod 32, so a
// warp's reads fall in distinct banks or are broadcasts.
template <int RI, int NJ, bool AT, bool BT>
__device__ __forceinline__ void mm(float (&acc)[RI][NJ], const float* A,
                                   int lda, const float* B, int ldb, int K) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RI], bv[NJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty * RI + i;
      av[i] = AT ? A[k * lda + r] : A[r * lda + k];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      bv[j] = BT ? B[k * ldb + c] : B[c * ldb + k];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int RI, int NJ>
__device__ __forceinline__ void zero(float (&acc)[RI][NJ]) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
}

// the sum over the 16 lanes of a half warp (the tx of one ty)
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// 1. each chunk's sum_i exp(dacs_i) dy_i (x) C_i [P, N] and its total decay
// ---------------------------------------------------------------------------

template <int P, int N>
constexpr size_t local_smem() {
  return (kTile * (P + 1) + kTile * (N + 1) + 2 * kMaxChunk) * sizeof(float);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
bwd_state_local(const T* __restrict__ dy, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ cm,
                float* __restrict__ gstates, float* __restrict__ datot,
                Problem p) {
  constexpr int RI = P / 16, NJ = N / 16;
  extern __shared__ float smem[];
  float* sDy = smem;                     // [64][P + 1], times exp(dacs_i)
  float* sC = sDy + kTile * (P + 1);     // [64][N + 1]
  float* sDa = sC + kTile * (N + 1);
  float* sDt = sDa + kMaxChunk;
  const int L = p.chunk, nc = p.seqlen / L;
  const int h = blockIdx.x % p.heads, bc = blockIdx.x / p.heads;
  const int c = bc % nc, b = bc / nc, grp = h / p.hpg;
  const long long s0 = static_cast<long long>(c) * L;
  const long long t_off = (static_cast<long long>(b) * p.seqlen + s0) * p.heads + h;
  chunk_decays(sDa, sDt, dt, a[h], t_off, p.heads, L);
  float* sE = sDt;   // dt is not needed here: exp(dacs) in its place
  for (int j = threadIdx.x; j < L; j += kThreads) sE[j] = expf(sDa[j]);
  float acc[RI][NJ];
  zero(acc);
  for (int it = 0; it < L / kTile; ++it) {
    const int i0 = it * kTile;
    __syncthreads();
    load_rows<P>(sDy, dy + (t_off + static_cast<long long>(i0) * p.heads) * P,
                 static_cast<long long>(p.heads) * P, sE + i0);
    load_rows<N>(sC, cm + b * p.c_sb + grp * p.c_sg + (s0 + i0) * p.c_ss,
                 p.c_ss);
    __syncthreads();
    // [p, n] += sum_i dy'_i[p] C_i[n]
    mm<RI, NJ, true, true>(acc, sDy, P + 1, sC, N + 1, kTile);
  }
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float* out = gstates + static_cast<long long>(blockIdx.x) * P * N;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[(ty * RI + i) * N + tx + 16 * j] = acc[i][j];
  if (threadIdx.x == 0) datot[blockIdx.x] = sDa[L - 1];
}

// ---------------------------------------------------------------------------
// 2. the reverse recurrence, one thread per (batch, head, state element)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
bwd_state_scan(float* __restrict__ gstates, const float* __restrict__ datot,
               const float* __restrict__ dfinal, float* __restrict__ dinit,
               int batch, int nc, int heads, int pn) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(batch) * heads * pn) return;
  const int e = static_cast<int>(idx % pn);
  const long long bh = idx / pn;
  const long long b = bh / heads, h = bh % heads;
  float run = dfinal != nullptr ? dfinal[idx] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const long long blk = (b * nc + c) * heads + h;
    float* g = gstates + blk * pn + e;
    const float local = *g;
    *g = run;   // G_c: the gradient reaching the state after chunk c
    run = expf(datot[blk]) * run + local;
  }
  dinit[idx] = run;
}

// ---------------------------------------------------------------------------
// 3. inside each chunk
// ---------------------------------------------------------------------------

template <int P, int N>
struct ChunkSmem {
  static constexpr int kC = 0;                            // [64][N + 1]
  static constexpr int kB = kC + kTile * (N + 1);         // [64][N + 1]
  static constexpr int kX = kB + kTile * (N + 1);         // [64][P + 1]
  static constexpr int kDy = kX + kTile * (P + 1);        // [64][P + 1]
  static constexpr int kW = kDy + kTile * (P + 1);        // [64][65]
  static constexpr int kV = kW + kTile * kLd;             // [64][65]
  static constexpr int kS = kV + kTile * kLd;             // [P][N + 1]
  static constexpr int kG = kS + P * (N + 1);             // [P][N + 1]
  static constexpr int kDa = kG + P * (N + 1);            // [L] each:
  static constexpr int kDt = kDa + kMaxChunk;             //   dacs, dt,
  static constexpr int kQ = kDt + kMaxChunk;              //   q, r and
  static constexpr int kR = kQ + kMaxChunk;               //   x.(dx / dt)
  static constexpr int kDd = kR + kMaxChunk;
  static constexpr int kRow = kDd + kMaxChunk;            // [64]
  static constexpr int kCol = kRow + kTile;               // [16][64]
  static constexpr int kFloats = kCol + 16 * kTile;
  // then, in double: d dacs [L] and 8 warp sums
  static constexpr size_t kBytes =
      kFloats * sizeof(float) + (kMaxChunk + 8) * sizeof(double);
  static_assert(kFloats % 2 == 0, "doubles 8-byte aligned");
  static_assert(kBytes <= 232448, "at most 227 KB of shared memory a block");
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
bwd_chunk(const T* __restrict__ x, const float* __restrict__ dt,
          const float* __restrict__ a, const T* __restrict__ bm,
          const T* __restrict__ cm, const float* __restrict__ states,
          const T* __restrict__ dy, const float* __restrict__ gstates,
          T* __restrict__ dx, float* __restrict__ ddt,
          float* __restrict__ db_part, float* __restrict__ dc_part,
          double* __restrict__ da_part, Problem p) {
  using Sm = ChunkSmem<P, N>;
  constexpr int RP = P + 1, RN = N + 1, JP = P / 16, JN = N / 16;
  extern __shared__ float smem[];
  float* sC = smem + Sm::kC;
  float* sB = smem + Sm::kB;
  float* sX = smem + Sm::kX;
  float* sDy = smem + Sm::kDy;
  float* sW = smem + Sm::kW;
  float* sV = smem + Sm::kV;
  float* sS = smem + Sm::kS;
  float* sG = smem + Sm::kG;
  float* sDa = smem + Sm::kDa;
  float* sDt = smem + Sm::kDt;
  float* sQ = smem + Sm::kQ;
  float* sR = smem + Sm::kR;
  float* sDd = smem + Sm::kDd;
  float* sRow = smem + Sm::kRow;
  float* sCol = smem + Sm::kCol;
  double* dda = reinterpret_cast<double*>(smem + Sm::kFloats);
  double* sRed = dda + kMaxChunk;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int L = p.chunk, nc = p.seqlen / L, tiles = L / kTile;
  const int h = blockIdx.x % p.heads, bc = blockIdx.x / p.heads;
  const int c = bc % nc, b = bc / nc, grp = h / p.hpg;
  const long long s0 = static_cast<long long>(c) * L;
  const long long t_off = (static_cast<long long>(b) * p.seqlen + s0) * p.heads + h;
  const long long hs = p.heads;                        // token stride of dt
  const float ah = a[h];
  const T* xb = x + b * p.x_sb + h * p.x_sh + s0 * p.x_ss;
  const T* bb = bm + b * p.b_sb + grp * p.b_sg + s0 * p.b_ss;
  const T* cb = cm + b * p.c_sb + grp * p.c_sg + s0 * p.c_ss;
  const T* dyb = dy + t_off * P;                       // row stride H P
  const long long part_off = t_off * N;                // [B, S, H, N]

  // S_c and G_c, and <G_c, S_c> for dT
  const float* st = states + static_cast<long long>(blockIdx.x) * P * N;
  const float* gs = gstates + static_cast<long long>(blockIdx.x) * P * N;
  double gsum = 0.0;
  for (int e = tid; e < P * N; e += kThreads) {
    const float sv = st[e], gv = gs[e];
    sS[(e / N) * RN + e % N] = sv;
    sG[(e / N) * RN + e % N] = gv;
    gsum += static_cast<double>(sv) * gv;
  }
  for (int j = tid; j < L; j += kThreads) dda[j] = 0.0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    gsum += __shfl_xor_sync(0xffffffffu, gsum, off);
  if ((tid & 31) == 0) sRed[tid >> 5] = gsum;
  chunk_decays(sDa, sDt, dt, ah, t_off, p.heads, L);   // barriers
  const float T_ = sDa[L - 1];

  for (int jt = 0; jt < tiles; ++jt) {
    const int j0 = jt * kTile;
    __syncthreads();   // the previous j tile's x and B are read
    load_rows<P>(sX, xb + j0 * p.x_ss, p.x_ss);
    load_rows<N>(sB, bb + j0 * p.b_ss, p.b_ss);
    __syncthreads();

    // the state terms of rows j: adx = exp(T - dacs_j) G B_j (dx / dt so
    // far), q_j = dt_j x_j . adx_j, adb = exp(T - dacs_j) dt_j G^T x_j
    float adx[4][JP], adb[4][JN];
    zero(adx);
    zero(adb);
    mm<4, JP, false, false>(adx, sB, RN, sG, RN, N);
    mm<4, JN, false, true>(adb, sX, RP, sG, RN, P);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int jj = ty * 4 + i, j = j0 + jj;
      const float f = expf(T_ - sDa[j]);
      float q = 0.f;
#pragma unroll
      for (int k = 0; k < JP; ++k) {
        adx[i][k] *= f;
        q += adx[i][k] * sX[jj * RP + tx + 16 * k];
      }
      q = sum16(q);
      if (tx == 0) sQ[j] = q * sDt[j];
#pragma unroll
      for (int k = 0; k < JN; ++k) adb[i][k] *= f * sDt[j];
    }

    for (int it = jt; it < tiles; ++it) {
      const int i0 = it * kTile;
      __syncthreads();   // the previous i tile's C, dy, W and V are read
      load_rows<N>(sC, cb + i0 * p.c_ss, p.c_ss);
      load_rows<P>(sDy, dyb + static_cast<long long>(i0) * hs * P, hs * P);
      __syncthreads();

      // CB_ij = C_i . B_j and DX_ij = dy_i . x_j; W = CB e, V = DX e dt_j,
      // with e = exp(dacs_i - dacs_j) masked on the exponent; M = CB V
      // strictly below the diagonal, summed along rows (+) and columns (-)
      float s1[4][4], s2[4][4];
      zero(s1);
      zero(s2);
      mm<4, 4, false, false>(s1, sC, RN, sB, RN, N);
      mm<4, 4, false, false>(s2, sDy, RP, sX, RP, P);
      float rows[4] = {0.f, 0.f, 0.f, 0.f}, cols[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ii = ty * 4 + r, jj = tx + 16 * q;
          const int i = i0 + ii, j = j0 + jj;
          const float e = expf(i >= j ? sDa[i] - sDa[j] : -INFINITY);
          const float w = s1[r][q] * e, v = s2[r][q] * e * sDt[j];
          sW[ii * kLd + jj] = w;
          sV[ii * kLd + jj] = v;
          const float m = i > j ? s1[r][q] * v : 0.f;
          rows[r] += m;
          cols[q] += m;
        }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float v = sum16(rows[r]);
        if (tx == 0) sRow[ty * 4 + r] = v;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) sCol[ty * kTile + tx + 16 * q] = cols[q];
      __syncthreads();
      if (tid < kTile) {
        double colsum = 0.0;
        for (int k = 0; k < 16; ++k) colsum += sCol[k * kTile + tid];
        dda[i0 + tid] += sRow[tid];
        dda[j0 + tid] -= colsum;
      }

      // dx_j / dt_j += sum_i W_ij dy_i; dB_j += sum_i V_ij C_i
      mm<4, JP, true, true>(adx, sW, kLd, sDy, RP, kTile);
      mm<4, JN, true, true>(adb, sV, kLd, sC, RN, kTile);
      // dC_i += sum_j V_ij B_j, and on the first j tile the state term
      // exp(dacs_i) S^T dy_i, whose dot with C_i is r_i
      float adc[4][JN];
      zero(adc);
      if (jt == 0) {
        mm<4, JN, false, true>(adc, sDy, RP, sS, RN, P);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int ii = ty * 4 + r;
          const float f = expf(sDa[i0 + ii]);
          float rr = 0.f;
#pragma unroll
          for (int k = 0; k < JN; ++k) {
            adc[r][k] *= f;
            rr += adc[r][k] * sC[ii * RN + tx + 16 * k];
          }
          rr = sum16(rr);
          if (tx == 0) sR[i0 + ii] = rr;
        }
      }
      mm<4, JN, false, true>(adc, sV, kLd, sB, RN, kTile);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* row = dc_part + part_off +
                     static_cast<long long>(i0 + ty * 4 + r) * hs * N;
#pragma unroll
        for (int k = 0; k < JN; ++k) {
          const int n = tx + 16 * k;
          row[n] = jt == 0 ? adc[r][k] : row[n] + adc[r][k];
        }
      }
    }

    // the j tile is done: dx = dt adx, x . adx for ddt, dB's partial
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int jj = ty * 4 + i, j = j0 + jj;
      T* row = dx + (t_off + static_cast<long long>(j) * hs) * P;
      float d = 0.f;
#pragma unroll
      for (int k = 0; k < JP; ++k) {
        const int pp = tx + 16 * k;
        row[pp] = from_f<T>(sDt[j] * adx[i][k]);
        d += adx[i][k] * sX[jj * RP + pp];
      }
      d = sum16(d);
      if (tx == 0) sDd[j] = d;
      float* brow = db_part + part_off + static_cast<long long>(j) * hs * N;
#pragma unroll
      for (int k = 0; k < JN; ++k) brow[tx + 16 * k] = adb[i][k];
    }
  }
  __syncthreads();

  // g = d(dt a) at row k: the suffix sum of d dacs (rows k and below),
  // plus the q_j of the rows above k and exp(T) <G, S> (dT, which reaches
  // g at every row; the q_j reach dT and dacs_j with opposite signs, so
  // only those above k are left, summed without cancelling); ddt and da
  if (tid == 0) {
    double gs_sum = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) gs_sum += sRed[w];
    double suf = 0.0;
    for (int j = L - 1; j >= 0; --j) {
      suf += dda[j] + static_cast<double>(sR[j]);
      dda[j] = suf;
    }
    double left = static_cast<double>(expf(T_)) * gs_sum, da = 0.0;
    for (int j = 0; j < L; ++j) {
      const double g = dda[j] + left;
      ddt[t_off + static_cast<long long>(j) * hs] =
          static_cast<float>(static_cast<double>(sDd[j]) + ah * g);
      da += static_cast<double>(sDt[j]) * g;
      left += sQ[j];
    }
    da_part[blockIdx.x] = da;
  }
}

// ---------------------------------------------------------------------------
// 4. dB and dC over a group's heads, da over (batch, chunk), in order
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_reduce(const float* __restrict__ db_part,
           const float* __restrict__ dc_part,
           const double* __restrict__ da_part, T* __restrict__ db,
           T* __restrict__ dc, float* __restrict__ da, long long tokens,
           int heads, int groups, int n, int chunks) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (blockIdx.x == 0) {
    for (int h = threadIdx.x; h < heads; h += kThreads) {
      double s = 0.0;
      for (int q = 0; q < chunks; ++q) s += da_part[static_cast<long long>(q) * heads + h];
      da[h] = static_cast<float>(s);
    }
  }
  if (idx >= tokens * groups * n) return;
  const int nn = static_cast<int>(idx % n);
  const int g = static_cast<int>((idx / n) % groups);
  const long long t = idx / (static_cast<long long>(n) * groups);
  const int hpg = heads / groups;
  double sb = 0.0, sc = 0.0;
  for (int k = 0; k < hpg; ++k) {
    const long long off = (t * heads + g * hpg + k) * n + nn;
    sb += db_part[off];
    sc += dc_part[off];
  }
  db[idx] = from_f<T>(static_cast<float>(sb));
  dc[idx] = from_f<T>(static_cast<float>(sc));
}

struct Buffers {
  const void *x, *dt, *a, *b, *c, *states, *dy, *dfinal;
  void *dx, *ddt, *da, *db, *dc, *dinit, *gstates, *datot, *db_part,
      *dc_part, *da_part;
};

template <typename T, int P, int N>
cudaError_t launch(const Buffers& u, int batch, int groups, const Problem& p,
                   cudaStream_t s) {
  const int nc = p.seqlen / p.chunk;
  const int blocks = batch * nc * p.heads;
  auto local = bwd_state_local<T, P, N>;
  constexpr size_t local_bytes = local_smem<P, N>();
  cudaError_t e = cudaFuncSetAttribute(
      local, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(local_bytes));
  if (e != cudaSuccess) return e;
  local<<<blocks, kThreads, local_bytes, s>>>(
      static_cast<const T*>(u.dy), static_cast<const float*>(u.dt),
      static_cast<const float*>(u.a), static_cast<const T*>(u.c),
      static_cast<float*>(u.gstates), static_cast<float*>(u.datot), p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const long long elems = static_cast<long long>(batch) * p.heads * P * N;
  bwd_state_scan<<<static_cast<unsigned>((elems + kThreads - 1) / kThreads),
                   kThreads, 0, s>>>(
      static_cast<float*>(u.gstates), static_cast<const float*>(u.datot),
      static_cast<const float*>(u.dfinal), static_cast<float*>(u.dinit),
      batch, nc, p.heads, P * N);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  auto chunk = bwd_chunk<T, P, N>;
  constexpr size_t chunk_bytes = ChunkSmem<P, N>::kBytes;
  e = cudaFuncSetAttribute(chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(chunk_bytes));
  if (e != cudaSuccess) return e;
  chunk<<<blocks, kThreads, chunk_bytes, s>>>(
      static_cast<const T*>(u.x), static_cast<const float*>(u.dt),
      static_cast<const float*>(u.a), static_cast<const T*>(u.b),
      static_cast<const T*>(u.c), static_cast<const float*>(u.states),
      static_cast<const T*>(u.dy), static_cast<const float*>(u.gstates),
      static_cast<T*>(u.dx), static_cast<float*>(u.ddt),
      static_cast<float*>(u.db_part), static_cast<float*>(u.dc_part),
      static_cast<double*>(u.da_part), p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const long long tokens = static_cast<long long>(batch) * p.seqlen;
  const long long outs = tokens * groups * N;
  bwd_reduce<T><<<static_cast<unsigned>((outs + kThreads - 1) / kThreads),
                  kThreads, 0, s>>>(
      static_cast<const float*>(u.db_part),
      static_cast<const float*>(u.dc_part),
      static_cast<const double*>(u.da_part), static_cast<T*>(u.db),
      static_cast<T*>(u.dc), static_cast<float*>(u.da), tokens, p.heads,
      groups, N, batch * nc);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t dispatch_n(int n, const Buffers& u, int batch, int groups,
                       const Problem& p, cudaStream_t s) {
  switch (n) {
    case 32: return launch<T, P, 32>(u, batch, groups, p, s);
    case 64: return launch<T, P, 64>(u, batch, groups, p, s);
    case 128: return launch<T, P, 128>(u, batch, groups, p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_p(int pd, int n, const Buffers& u, int batch,
                       int groups, const Problem& p, cudaStream_t s) {
  switch (pd) {
    case 32: return dispatch_n<T, 32>(n, u, batch, groups, p, s);
    case 64: return dispatch_n<T, 64>(n, u, batch, groups, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: [B, S, H, P]; B and C: [B, S, G, N], each by its (batch, seq,
// head-or-group) strides in elements with the last dim contiguous; dt:
// contiguous [B, S, H] f32; a: [H] f32; states: contiguous [B, S / chunk, H,
// P, N] f32 (K3's inbound states); dy: contiguous [B, S, H, P] in x's
// dtype; dfinal (or null for 0): contiguous [B, H, P, N] f32.  Outputs, all
// contiguous: dx [B, S, H, P] and dB, dC [B, S, G, N] in x's dtype, ddt
// [B, S, H], da [H] and dinit [B, H, P, N] f32.  Scratch: gstates [B, S /
// chunk, H, P, N] f32, datot [B, S / chunk, H] f32, db_part and dc_part
// [B, S, H, N] f32, da_part [B, S / chunk, H] f64.  dtype: 0 = float32,
// 1 = bfloat16.  P in {32, 64}, N in {32, 64, 128}, H % G == 0, chunk a
// multiple of 64 up to 256 dividing S.  Returns cudaGetLastError() after
// the last of its four launches (or the first error).
extern "C" int repro_ssd_scan_bwd(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* states, const void* dy, const void* dfinal,
    void* dx, void* ddt, void* da, void* db, void* dc, void* dinit,
    void* gstates, void* datot, void* db_part, void* dc_part, void* da_part,
    int batch, int seqlen, int heads, int groups, int chunk, int p, int n,
    long long x_sb, long long x_ss, long long x_sh, long long b_sb,
    long long b_ss, long long b_sg, long long c_sb, long long c_ss,
    long long c_sg, int dtype, void* stream) {
  if (batch <= 0 || seqlen <= 0 || heads <= 0 || groups <= 0 ||
      heads % groups != 0 || chunk <= 0 || chunk % kTile != 0 ||
      chunk > kMaxChunk || seqlen % chunk != 0 ||
      static_cast<long long>(batch) * (seqlen / chunk) * heads > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const Problem pr{heads, heads / groups, seqlen, chunk,
                   x_sb, x_ss, x_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  const Buffers u{x, dt, a, b, c, states, dy, dfinal, dx, ddt, da, db, dc,
                  dinit, gstates, datot, db_part, dc_part, da_part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_p<float>(p, n, u, batch, groups, pr, s);
  if (dtype == 1)
    return dispatch_p<__nv_bfloat16>(p, n, u, batch, groups, pr, s);
  return cudaErrorInvalidValue;
}
