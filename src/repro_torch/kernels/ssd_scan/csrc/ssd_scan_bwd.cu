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
// A launch's kernels, all deterministic (no atomics):
//   1. each chunk's sum_i exp(dacs_i) dy_i (x) C_i and its total decay T,
//      one block per (batch, chunk, head) (f32: bwd_state_local);
//   2. the reverse recurrence over the chunks, leaving G_c in place of
//      chunk c's sum, and the initial state's gradient (f32:
//      bwd_state_scan, one thread per four state elements; bf16 takes 1
//      and 2 in one kernel, bwd_states_wg, one block per (batch, head)
//      walking its chunks with G in registers);
//   3. everything above inside the chunk, one block per (batch, chunk,
//      head): dx, ddt and the chunk's partial da are written, dB and dC as
//      f32 partials of the head ([B, S, H, N]): B and C belong to a group
//      of heads (mamba2-370m has 32 heads in one group), and atomics would
//      not give equal bits twice;
//   4. bwd_reduce: dB and dC as each group's heads' partials summed in
//      order (in double), and da as the (batch, chunk) partials summed in
//      order.
// The masks go on the exponents before exp, as in K3: exp(dacs_i - dacs_j)
// for i < j overflows.
//
// Bound on an H100 at mamba2-370m's train step (B=4, S=2048, 32 heads of
// P=64, N=128, one group, L=256): 148.9 MB of x, dy, dx, B, C, dB, dC, dt,
// ddt and K3's states (0.044 ms at 3.35 TB/s) against 51.7 GFLOP (0.052 ms
// at the bf16 tensor-core peak; 0.77 ms at the f32 FMA peak, which no
// scalar design passes): operations.  The per-head partials of dB and dC
// add 2 x 134 MB written and read (0.16 ms at 3.35 TB/s).
//
// bf16 (bwd_states_wg, bwd_chunk_ws, bwd_reduce): every product on
// wgmma.
//   * The chunk kernel is warp-specialised as K3: a producer thread streams
//     64-row tiles of B, C, x and dy with TMA (4-D tensor maps reading x, B
//     and C through their strides) into shared memory, swizzled as the
//     wgmma descriptors name them; two consumer warpgroups run the
//     products.  Each consumer holds one "anchor" tile pair at a time, and
//     a ring streams the other side's tiles past both consumers at once
//     (full and empty mbarriers; a consumer that has no pair with a tile
//     still frees it).
//   * First j-major (anchors B_j with x_j, stream C_i with dy_i, i >= j):
//     S^T = B_j C_i^T and DX^T = x_j dy_i^T with both bf16 operands K-major
//     in shared memory, so their products are exact in the f32 sums; W^T =
//     S^T e and V^T = DX^T e dt_j in registers; dx_j += W^T dy_i and dB_j
//     += V^T C_i take W^T and V^T as the register A operand, with dy_i and
//     C_i MN-major in shared memory (the transpose bit).  M = S V is summed
//     along j's row (quad shuffles): d dacs_j's - part.
//   * Then i-major (anchors C_i with dy_i, stream B_j with x_j, j <= i):
//     dC_i += V B_j needs V with rows i.  This kernel recomputes S = C_i
//     B_j^T and DX = dy_i x_j^T (a fifth of a pair's products at N = 128,
//     P = 64) rather than staging V^T through shared memory: the
//     recomputed DX's accumulator is V's A fragment as it stands, a staged
//     V^T would cost 16 KB of shared memory a pair and a barrier between
//     the consumers' turns, and with S M's sums over j (d dacs_i's + part)
//     are row sums too, so no sum crosses warps.
//   * The state terms (B_j G_c^T, x_j G_c, dy_i S_c) are products with G_c
//     and S_c, staged once a block in shared memory as bf16 hi and lo
//     parts, as K3 stages its state: [P, N] K-major for G B_j^T, MN-major
//     (the transpose bit) for the other two.
//   * No f32 value enters the tensor cores rounded whole to bf16: W, V,
//     G_c, S_c and dy exp(dacs) go in as hi + lo (two products each; the
//     residue is about u^2 of the value, u = 2^-8), bf16 inputs as they
//     are.  exp is __expf (ex2.approx, about 2^-21 relative at the
//     arguments that matter), masked only on diagonal tiles.
//   * A row's anchor is the same thread's in both phases, so its d dacs,
//     q and x.(dx/dt) pass from phase 0 to phase 1 with no barrier; the
//     epilogue (the suffix sum of d dacs, the prefix of q, ddt, da) is a
//     scan in double by both consumers, a row a thread, each warp's rows
//     across its lanes and the warps' totals in a fixed order.
//   * The recurrence's block walks its chunks from the last, the state's
//     gradient in f32 registers: it writes G_c, decays it by exp(T_c) and
//     adds the chunk's sum_i exp(dacs_i) dy_i (x) C_i on the tensor cores,
//     (exp(dacs) dy)^T through ldmatrix.trans, split hi + lo in registers,
//     against C MN-major; TMA keeps a chunk of tiles in flight.
// What is left (tools/trace_k3b.py; H100 80GB HBM3 at 700 W): 0.51 ms a
// launch at the train shape, 9.8x the bound: bwd_chunk_ws 0.36 ms,
// bwd_reduce 0.10, bwd_states_wg 0.05.  The chunk kernel's blocks (one an
// SM, eight waves) spend their 79k cycles on latency the two consumers
// cannot hide from each other: the exponentials (20%), the partials'
// writes (14%), the state terms (12%), staging the states and dacs (11%),
// waits (11%); the tensor cores' products are under a third of a block.
// The partials' round trip through device memory (bwd_reduce) is the next
// largest piece.  Summing a group's heads inside a cluster of blocks
// (distributed shared memory) was slower: every exchange waits for the
// slowest block of the cluster.
//
// f32 (bwd_state_local, bwd_chunk) is scalar f32 FMAs on a 16 x 16 thread
// grid, each thread a 4 x (width / 16) patch, from shared memory padded one
// float a row (no bank conflicts), by 64-row tiles (j tiles outer, the i
// tiles at or below the diagonal inner); it is off every main path.  L is
// a multiple of 64 up to 256.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../common/csrc/hopper.cuh"

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

// ---------------------------------------------------------------------------
// bf16: the products on wgmma
// ---------------------------------------------------------------------------

constexpr int kMaxTiles = kMaxChunk / kTile;
constexpr int kBarAll = 1;    // named barrier 1: both consumers of bwd_chunk_ws
constexpr int kBarScan = 2;   // named barrier 2: consumer 0 taking dacs

__device__ __forceinline__ uint32_t swizzle(uint32_t off, int bits) {
  return off ^ (((off >> 7) & ((1u << bits) - 1)) << 4);
}

// four 8x8 b16 matrices, transposed: register i holds matrix i, whose row
// addresses come from lanes 8i .. 8i+7
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], A K-major and B MN-major in shared
// memory (the transpose bit of B)
__device__ __forceinline__ void wgmma_ss_t_n32(float (&d)[16], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A K-major and B MN-major in shared
// memory (the transpose bit of B)
__device__ __forceinline__ void wgmma_ss_t_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x W] (+)= A B^T, both K-major in shared memory
template <int W>
__device__ __forceinline__ void wgmma_ss(float (&d)[W / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (W == 32) {
    wgmma_ss_n32(d, da, db, accumulate);
  } else {
    wgmma_ss_n64(d, da, db, accumulate);
  }
}

// D[64 x W] (+)= A B, A K-major and B MN-major in shared memory
template <int W>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[W / 2], uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (W == 32) {
    wgmma_ss_t_n32(d, da, db, accumulate);
  } else {
    wgmma_ss_t_n64(d, da, db, accumulate);
  }
}

// D[64 x W] += A B, A from registers, B MN-major in shared memory
template <int W>
__device__ __forceinline__ void wgmma_rs(float (&d)[W / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (W == 32) {
    wgmma_rs_n32(d, a, db);
  } else {
    wgmma_rs_n64(d, a, db);
  }
}

// (v0, v1) as bf16 hi and lo parts, each packed as one register of an A
// fragment: v = hi + lo to about u^2 |v|
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = pack_bf16(v0 - __low2float(h2), v1 - __high2float(h2));
}

// the sum over the 4 lanes of a row of a wgmma accumulator (lane % 4)
__device__ __forceinline__ float sum_quad(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Shared tiles as TMA writes them: B, C and the states in column blocks of
// kColsN (64 columns, 128-byte swizzle; 32 and 64-byte at N = 32), x and dy
// in one block of P columns; every tile on a 1024-byte boundary.  Element
// e of a 64 x W wgmma accumulator of warp w, lane l (g = l / 4, t4 = l % 4)
// is row 16 w + g + 8 ((e >> 1) & 1), column 8 (e >> 2) + 2 t4 + (e & 1).
template <int P, int N>
struct Wg {
  static constexpr int kColsN = N < 64 ? N : 64;
  static constexpr int kBlocksN = N / kColsN;
  static constexpr int kRowBytesN = kColsN * 2;
  static constexpr int kLayoutN = kColsN == 64 ? 1 : 2;  // 128- or 64-byte
  static constexpr int kSwzN = kColsN == 64 ? 3 : 2;
  static constexpr int kRowBytesP = P * 2;
  static constexpr int kLayoutP = P == 64 ? 1 : 2;
  static constexpr int kSwzP = P == 64 ? 3 : 2;
  static constexpr int kTileN = kTile * N * 2;   // bytes of a B or C tile
  static constexpr int kTileP = kTile * P * 2;   // of an x or dy tile
  static constexpr int kSlot = kTileN + kTileP;  // one of each, N first
  static constexpr int kState = P * N * 2;       // a state's hi or lo part

  // K-major operand of an N-wide tile of `rows` rows, 16 columns from col
  static __device__ __forceinline__ uint64_t kmaj_n(uint32_t tile, int rows,
                                                    int col) {
    return smem_desc(tile + (col / kColsN) * rows * kRowBytesN +
                         (col % kColsN) * 2,
                     16, 8 * kRowBytesN, kLayoutN);
  }
  static __device__ __forceinline__ uint64_t kmaj_p(uint32_t tile, int col) {
    return smem_desc(tile + col * 2, 16, 8 * kRowBytesP, kLayoutP);
  }
  // MN-major B operand: column block cb of an N-wide tile of `rows` rows,
  // 16 rows deep from row 16 kk
  static __device__ __forceinline__ uint64_t mn_n(uint32_t tile, int rows,
                                                  int cb, int kk) {
    return smem_desc(tile + cb * rows * kRowBytesN + kk * 16 * kRowBytesN,
                     rows * kRowBytesN, 8 * kRowBytesN, kLayoutN);
  }
  static __device__ __forceinline__ uint64_t mn_p(uint32_t tile, int kk) {
    return smem_desc(tile + kk * 16 * kRowBytesP, kTile * kRowBytesP,
                     8 * kRowBytesP, kLayoutP);
  }
  // the byte offset of element (row, col) in a tile
  static __device__ __forceinline__ uint32_t off_n(int rows, int row,
                                                   int col) {
    return (col / kColsN) * rows * kRowBytesN +
           swizzle(row * kRowBytesN + (col % kColsN) * 2, kSwzN);
  }
  static __device__ __forceinline__ uint32_t off_p(int row, int col) {
    return swizzle(row * kRowBytesP + col * 2, kSwzP);
  }
};

// thread t's two rows of dt (0 past L), 2t and 2t + 1 of the chunk
__device__ __forceinline__ float2 load_dt(const float* dt, long long t_off,
                                          int heads, int L, int t) {
  const int r0 = 2 * t;
  return make_float2(
      r0 < L ? dt[t_off + static_cast<long long>(r0) * heads] : 0.f,
      r0 + 1 < L ? dt[t_off + static_cast<long long>(r0 + 1) * heads] : 0.f);
}

// dacs (a scan in double, rounded once to f32) and dt of a chunk of L <= 256
// rows, by the 128 threads of one warpgroup (t its thread, rows 2t and 2t +
// 1, whose dt is d); `bar` is a named barrier of those 128 threads, sScan 4
// doubles.  The caller syncs before reading sDa and sDt.
__device__ __forceinline__ void scan_dacs(float* sDa, float* sDt, float2 d,
                                          float ah, int L, int t,
                                          double* sScan, int bar) {
  const int r0 = 2 * t, lane = t & 31, warp = t >> 5;
  const double v0 = static_cast<double>(d.x * ah);
  const double v1 = static_cast<double>(d.y * ah);
  double inc = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += u;
  }
  double ex = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) ex = 0.0;
  if (lane == 31) sScan[warp] = inc;
  named_sync(bar, 128);
  double pre = 0.0;
  for (int w = 0; w < warp; ++w) pre += sScan[w];
  const double s0 = (pre + ex) + v0;
  if (r0 < L) {
    sDa[r0] = static_cast<float>(s0);
    sDt[r0] = d.x;
  }
  if (r0 + 1 < L) {
    sDa[r0 + 1] = static_cast<float>(s0 + v1);
    sDt[r0 + 1] = d.y;
  }
}

// ---------------------------------------------------------------------------
// 1 and 2 (bf16). the state's gradient after every chunk, on wgmma
// ---------------------------------------------------------------------------
// One block per (batch, head) walks its chunks from the last to the first
// with the state's gradient G [P, N] in f32 registers (warpgroup 1 + k
// holds column block k): it writes G_c, the gradient reaching the state
// after chunk c, then takes G_{c-1} = exp(T_c) G_c + sum_i exp(dacs_i)
// dy_i (x) C_i, adding the chunk's sum on the tensor cores: its A operand
// (exp(dacs) dy)^T through ldmatrix.trans of the dy tile, times exp(dacs_i)
// in f32 and split into hi and lo, its B the C tile MN-major.  What is left
// at the end is the initial state's gradient.  Warpgroup 0's first thread
// loads the chunks' C and dy tiles with TMA through a ring of stages, a
// chunk ahead.  Rows p >= P of the 64-row product are 0 (P = 32).

template <int P, int N>
struct StatesSmem {
  using W = Wg<P, N>;
  static constexpr int kWgs = W::kBlocksN;                 // consumers
  static constexpr int kThreads = 128 * (1 + kWgs);
  static constexpr int kStages = 2 * kMaxTiles;
  static constexpr int kRing = 0;                          // (C, dy) slots
  static constexpr int kE = kRing + kStages * W::kSlot;    // exp(dacs) [L]
  static constexpr int kDa = kE + 4 * kMaxChunk;
  static constexpr int kDt = kDa + 4 * kMaxChunk;
  static constexpr int kScan = kDt + 4 * kMaxChunk;        // 4 doubles
  static constexpr int kBars = kScan + 4 * 8;              // full, empty
  static constexpr int kSmem = kBars + 16 * kStages + 1024;
  static_assert(kSmem <= 232448, "at most 227 KB of shared memory a block");
};

template <int P, int N>
__global__ void __launch_bounds__(StatesSmem<P, N>::kThreads, 1)
bwd_states_wg(const __grid_constant__ CUtensorMap tc,
              const __grid_constant__ CUtensorMap tdy,
              const float* __restrict__ dt, const float* __restrict__ a,
              const float* __restrict__ dfinal, float* __restrict__ gstates,
              float* __restrict__ dinit, Problem p) {
  using W = Wg<P, N>;
  using Sm = StatesSmem<P, N>;
  constexpr int kCN = W::kColsN, kStages = Sm::kStages;
  constexpr int kConsumers = 128 * Sm::kWgs;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base_ptr =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(base_ptr);
  float* sE = reinterpret_cast<float*>(base_ptr + Sm::kE);
  float* sDa = reinterpret_cast<float*>(base_ptr + Sm::kDa);
  float* sDt = reinterpret_cast<float*>(base_ptr + Sm::kDt);
  double* sScan = reinterpret_cast<double*>(base_ptr + Sm::kScan);
  const uint32_t bar_f = base + Sm::kBars;        // + 8 s: stage s landed
  const uint32_t bar_e = bar_f + 8 * kStages;     // + 8 s: stage s is free
  const int L = p.chunk, nc = p.seqlen / L, tiles = L / kTile;
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int grp = h / p.hpg;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_f + 8 * s, 1);
      mbar_init(bar_e + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer: chunk nc - 1 first, its tiles in order ----
    if (threadIdx.x == 0) {
      int k = 0;
      for (int c = nc - 1; c >= 0; --c)
        for (int i = 0; i < tiles; ++i, ++k) {
          const int s = k % kStages, row = c * L + i * kTile;
          const uint32_t slot = base + Sm::kRing + s * W::kSlot;
          mbar_wait(bar_e + 8 * s, ((k / kStages) & 1) ^ 1);
          mbar_expect_tx(bar_f + 8 * s, W::kSlot);
          for (int cb = 0; cb < W::kBlocksN; ++cb)
            tma_load(slot + cb * kTile * W::kRowBytesN, &tc, bar_f + 8 * s,
                     cb * kCN, row, grp, b);
          tma_load(slot + W::kTileN, &tdy, bar_f + 8 * s, 0, row, h, b);
        }
    }
    return;
  }

  // ---- consumers: warpgroup 1 + cw holds column block cw of G ----
  const int cw = wg - 1, ct = threadIdx.x - 128;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, t4 = lane % 4;
  const float ah = a[h];
  const long long bh = static_cast<long long>(b) * p.heads + h;
  float acc[kCN / 2];
#pragma unroll
  for (int e = 0; e < kCN / 2; ++e) {
    const int row = warp * 16 + g + 8 * ((e >> 1) & 1);
    const int col = cw * kCN + 8 * (e >> 2) + 2 * t4 + (e & 1);
    acc[e] = dfinal != nullptr && row < P ? dfinal[bh * P * N + row * N + col]
                                          : 0.f;
  }
  int k = 0;
  for (int c = nc - 1; c >= 0; --c) {
    const long long t_off =
        (static_cast<long long>(b) * p.seqlen + static_cast<long long>(c) * L) *
            p.heads + h;
    const float2 d = cw == 0 ? load_dt(dt, t_off, p.heads, L, t)
                             : make_float2(0.f, 0.f);
    // G_c, the gradient reaching the state after chunk c
    float* out = gstates +
        ((static_cast<long long>(b) * nc + c) * p.heads + h) * P * N;
#pragma unroll
    for (int e = 0; e < kCN / 2; e += 2) {
      const int row = warp * 16 + g + 8 * ((e >> 1) & 1);
      const int col = cw * kCN + 8 * (e >> 2) + 2 * t4;
      if (row < P)
        *reinterpret_cast<float2*>(out + row * N + col) =
            make_float2(acc[e], acc[e + 1]);
    }
    // the chunk's dacs (consumer 0) and exp(dacs), once every consumer is
    // done with the previous chunk's
    named_sync(kBarAll, kConsumers);
    if (cw == 0) scan_dacs(sDa, sDt, d, ah, L, t, sScan, kBarScan);
    named_sync(kBarAll, kConsumers);
    for (int i = ct; i < L; i += kConsumers) sE[i] = expf(sDa[i]);
    named_sync(kBarAll, kConsumers);
    const float decay = expf(sDa[L - 1]);
#pragma unroll
    for (int e = 0; e < kCN / 2; ++e) acc[e] *= decay;
    for (int tt = 0; tt < tiles; ++tt, ++k) {
      const int s = k % kStages;
      const uint32_t slot = base + Sm::kRing + s * W::kSlot;
      mbar_wait(bar_f + 8 * s, (k / kStages) & 1);
      // (e dy)^T's A fragments: rows p of this warp, 16 rows i a k-step.
      // ldmatrix.trans of dy's [i, p] tile gives, in register r, rows p =
      // 16 warp + g (+ 8 for r odd) and i = 2 t4, 2 t4 + 1 (+ 8 for r >=
      // 2) of the k-step; rows p >= P are 0
      uint32_t hi[kTile / 16][4], lo[kTile / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t r[4] = {0u, 0u, 0u, 0u};
        if (warp * 16 < P) {
          const int mi = lane >> 3;
          const int trow = kk * 16 + (lane & 7) + ((mi >> 1) << 3);
          const int pcol = warp * 16 + ((mi & 1) << 3);
          ldmatrix_x4_trans(r, slot + W::kTileN + W::off_p(trow, pcol));
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = tt * kTile + kk * 16 + 2 * t4 + ((q >> 1) << 3);
          const __nv_bfloat162 v =
              *reinterpret_cast<const __nv_bfloat162*>(&r[q]);
          split_bf16(__low2float(v) * sE[i], __high2float(v) * sE[i + 1],
                     hi[kk][q], lo[kk][q]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        wgmma_rs<kCN>(acc, hi[kk], W::mn_n(slot, kTile, cw, kk));
        wgmma_rs<kCN>(acc, lo[kk], W::mn_n(slot, kTile, cw, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(hi);
      fence_regs(lo);
      mbar_arrive(bar_e + 8 * s);
    }
  }
  // the initial state's gradient
#pragma unroll
  for (int e = 0; e < kCN / 2; e += 2) {
    const int row = warp * 16 + g + 8 * ((e >> 1) & 1);
    const int col = cw * kCN + 8 * (e >> 2) + 2 * t4;
    if (row < P)
      *reinterpret_cast<float2*>(dinit + bh * P * N + row * N + col) =
          make_float2(acc[e], acc[e + 1]);
  }
}

// ---------------------------------------------------------------------------
// 3 (bf16). inside each chunk, warp-specialised
// ---------------------------------------------------------------------------
// One block of three warpgroups per (batch, chunk, head).  Warpgroup 0's
// first thread is the producer; warpgroups 1 and 2 are consumers 0 and 1.
// The work comes in two phases of up to two rounds.  In round r consumer k
// holds the anchor tile owned_tile(k, r) (tile k, then tile L/64 - 1 - k
// where no other consumer's first tile is that: five of the ten tile pairs
// of L = 256 each, in both phases), and the ring streams the other side's
// tiles in a fixed order past both:
//   phase 0, j-major: anchors (B_j, x_j), stream (C_i, dy_i) from the last
//     i tile down to the lowest anchor; a consumer takes the pairs i >= j;
//     the row sums of M (over i) go to d dacs_j with a - sign;
//   phase 1, i-major: anchors (C_i, dy_i), stream (B_j, x_j) from tile 0 up
//     to the highest anchor; a consumer takes the pairs j <= i.  S = C_i
//     B_j^T is recomputed beside DX, so that M's sums over j (to d dacs_i,
//     + sign) are row sums too: a quad's shuffles, no transposed sum
//     across warps.
// A row's anchor is the same thread's in both phases, so the row values of
// phase 0 (d dacs' - part, q, x.(dx/dt)) reach phase 1 with no barrier.

// the ring's tiles of one round: its length, and its k-th tile
__device__ __forceinline__ int stream_len(int ph, const int (&an)[2],
                                          int tiles) {
  if (ph == 0) {
    const int lo = an[0] < 0 ? an[1] : an[1] < 0 ? an[0] : min(an[0], an[1]);
    return tiles - lo;
  }
  return max(an[0], an[1]) + 1;
}

__device__ __forceinline__ int stream_tile(int ph, int k, int tiles) {
  return ph == 0 ? tiles - 1 - k : k;
}

// the anchor tiles of consumer c among `tiles` (at most two): tile c, and
// tile tiles - 1 - c where that is no other consumer's first tile
__device__ __forceinline__ int owned_tile(int c, int k, int tiles) {
  if (k == 0) return c < tiles ? c : -1;
  const int t = tiles - 1 - c;
  return t > c && t >= 2 ? t : -1;
}

template <int P, int N>
struct ChunkWs {
  using W = Wg<P, N>;
  static constexpr int kThreads = 384;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static constexpr int kStages =
      6 * W::kSlot + 4 * W::kState + 24 * kMaxChunk + 40 * 8 + 8 * 12 +
                  1024 <= 232448
          ? 4
          : 3;
  static constexpr int kAnchor = 0;                        // 2 slots
  static constexpr int kRing = kAnchor + 2 * W::kSlot;     // kStages slots
  static constexpr int kG = kRing + kStages * W::kSlot;    // G_c hi, lo
  static constexpr int kS = kG + 2 * W::kState;            // S_c hi, lo
  static constexpr int kDa = kS + 2 * W::kState;           // f32 [L] each:
  static constexpr int kDt = kDa + 4 * kMaxChunk;          //   dacs, dt,
  static constexpr int kQ = kDt + 4 * kMaxChunk;           //   q and
  static constexpr int kDd = kQ + 4 * kMaxChunk;           //   x.(dx / dt)
  static constexpr int kA = kDd + 4 * kMaxChunk;           // f64 [L]
  static constexpr int kRed = kA + 8 * kMaxChunk;  // f64: 8 + 4 + 3 x 8
  static constexpr int kBars = kRed + 40 * 8;
  static constexpr int kSmem = kBars + 8 * (4 + 2 * kStages) + 1024;
  static_assert(kSmem <= 232448, "at most 227 KB of shared memory a block");
};

template <int P, int N>
__global__ void __launch_bounds__(ChunkWs<P, N>::kThreads, 1)
bwd_chunk_ws(const __grid_constant__ CUtensorMap tx,
             const __grid_constant__ CUtensorMap tb,
             const __grid_constant__ CUtensorMap tc,
             const __grid_constant__ CUtensorMap tdy,
             const float* __restrict__ dt, const float* __restrict__ a,
             const float* __restrict__ states,
             const float* __restrict__ gstates,
             __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
             float* __restrict__ db_part, float* __restrict__ dc_part,
             double* __restrict__ da_part, Problem p) {
  static_assert((P == 32 || P == 64) && (N == 32 || N == 64 || N == 128),
                "P in {32, 64}, N in {32, 64, 128}");
  using W = Wg<P, N>;
  using Sm = ChunkWs<P, N>;
  constexpr int kStages = Sm::kStages;
  constexpr int kCB = W::kBlocksN, kCN = W::kColsN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base_ptr =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(base_ptr);
  const uint32_t sAnc = base + Sm::kAnchor, sRing = base + Sm::kRing;
  const uint32_t sG = base + Sm::kG, sS = base + Sm::kS;
  float* sDa = reinterpret_cast<float*>(base_ptr + Sm::kDa);
  float* sDt = reinterpret_cast<float*>(base_ptr + Sm::kDt);
  float* sQ = reinterpret_cast<float*>(base_ptr + Sm::kQ);
  float* sDd = reinterpret_cast<float*>(base_ptr + Sm::kDd);
  double* sA = reinterpret_cast<double*>(base_ptr + Sm::kA);
  double* sRed = reinterpret_cast<double*>(base_ptr + Sm::kRed);
  const uint32_t bar_af = base + Sm::kBars;    // + 8 k: k's anchor landed
  const uint32_t bar_ae = bar_af + 16;         // + 8 k: k is done with it
  const uint32_t bar_rf = bar_ae + 16;         // + 8 s: stage s landed
  const uint32_t bar_re = bar_rf + 8 * kStages;  // + 8 s: stage s is free

  const int L = p.chunk, nc = p.seqlen / L, tiles = L / kTile;
  const int h = blockIdx.x % p.heads, bc = blockIdx.x / p.heads;
  const int c = bc % nc, b = bc / nc, grp = h / p.hpg;
  const int row0 = c * L;

  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) {
      mbar_init(bar_af + 8 * k, 1);
      mbar_init(bar_ae + 8 * k, 128);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_rf + 8 * s, 1);
      mbar_init(bar_re + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that the compiler knows it is
  // the same in every lane of a warp
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(Sm::kProducerRegs));
    if (threadIdx.x == 0) {
      // one slot: (B_t, x_t) when bx, else (C_t, dy_t)
      auto load = [&](uint32_t slot, uint32_t bar, bool bx, int t) {
        const int row = row0 + t * kTile;
        mbar_expect_tx(bar, W::kSlot);
        for (int cb = 0; cb < kCB; ++cb)
          tma_load(slot + cb * kTile * W::kRowBytesN, bx ? &tb : &tc, bar,
                   cb * kCN, row, grp, b);
        tma_load(slot + W::kTileN, bx ? &tx : &tdy, bar, 0, row, h, b);
      };
      int n = 0, used[2] = {0, 0};
      for (int ph = 0; ph < 2; ++ph)
        for (int r = 0; r < 2; ++r) {
          const int an[2] = {owned_tile(0, r, tiles), owned_tile(1, r, tiles)};
          if (an[0] < 0 && an[1] < 0) continue;
          for (int k = 0; k < 2; ++k) {
            if (an[k] < 0) continue;
            mbar_wait(bar_ae + 8 * k, (used[k] & 1) ^ 1);
            load(sAnc + k * W::kSlot, bar_af + 8 * k, ph == 0, an[k]);
            ++used[k];
          }
          const int len = stream_len(ph, an, tiles);
          for (int k = 0; k < len; ++k, ++n) {
            const int s = n % kStages;
            mbar_wait(bar_re + 8 * s, ((n / kStages) & 1) ^ 1);
            load(sRing + s * W::kSlot, bar_rf + 8 * s, ph == 1,
                 stream_tile(ph, k, tiles));
          }
        }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               ::"n"(Sm::kConsumerRegs));
  const int cw = wg - 1;                       // this consumer
  const int ct = threadIdx.x - 128;            // 0 .. 255
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long hs = p.heads;                // token stride of dt
  const long long t_off =
      (static_cast<long long>(b) * p.seqlen + row0) * p.heads + h;
  const float ah = a[h];
  const long long st_off = static_cast<long long>(blockIdx.x) * P * N;
  const uint32_t anc = sAnc + cw * W::kSlot;   // this consumer's anchor
  const unsigned char* anc_ptr = base_ptr + Sm::kAnchor + cw * W::kSlot;
  const int rl[2] = {warp * 16 + g, warp * 16 + g + 8};   // rows in a tile

  // the chunk's dt (consumer 0 takes dacs), loaded first so that its
  // latency runs under the states'
  const float2 dtr = load_dt(dt, t_off, p.heads, L, t);
  // G_c and S_c [P, N] f32 as bf16 hi and lo parts, each swizzled as a
  // [P, N] tile of column blocks (every load issued before the first
  // store), and <G_c, S_c> in double for dT
  {
    constexpr int kVec = P * N / 4 / 256;      // float4s of each a thread
    float4 gv[kVec], sv[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      gv[k] = reinterpret_cast<const float4*>(gstates + st_off)[ct + 256 * k];
      sv[k] = reinterpret_cast<const float4*>(states + st_off)[ct + 256 * k];
    }
    double gsum = 0.0;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int e = 4 * (ct + 256 * k), row = e / N, col = e % N;
      gsum += static_cast<double>(gv[k].x) * sv[k].x +
              static_cast<double>(gv[k].y) * sv[k].y +
              static_cast<double>(gv[k].z) * sv[k].z +
              static_cast<double>(gv[k].w) * sv[k].w;
      const float gf[4] = {gv[k].x, gv[k].y, gv[k].z, gv[k].w};
      const float sf[4] = {sv[k].x, sv[k].y, sv[k].z, sv[k].w};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const uint32_t off = W::off_n(P, row, col + 2 * hf);
        uint32_t hi, lo;
        split_bf16(gf[2 * hf], gf[2 * hf + 1], hi, lo);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sG + off), "r"(hi)
                     : "memory");
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sG + W::kState + off),
                     "r"(lo)
                     : "memory");
        split_bf16(sf[2 * hf], sf[2 * hf + 1], hi, lo);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sS + off), "r"(hi)
                     : "memory");
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sS + W::kState + off),
                     "r"(lo)
                     : "memory");
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      gsum += __shfl_xor_sync(0xffffffffu, gsum, off);
    if (lane == 0) sRed[ct / 32] = gsum;
  }
  // the chunk's dacs and dt
  if (cw == 0) scan_dacs(sDa, sDt, dtr, ah, L, t, sRed + 8, kBarScan);
  // the states' parts are read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(kBarAll, 256);
  const float T_ = sDa[L - 1];

  int n = 0, used = 0;   // ring stages and anchors consumed so far

  // ---- phase 0, j-major: dx, dB's partial, q, x.(dx/dt), M's row sums ----
  for (int r = 0; r < 2; ++r) {
    const int an[2] = {owned_tile(0, r, tiles), owned_tile(1, r, tiles)};
    if (an[0] < 0 && an[1] < 0) continue;
    const int jt = an[cw], len = stream_len(0, an, tiles);
    const int jr[2] = {jt * kTile + rl[0], jt * kTile + rl[1]};
    float adx[P / 2], adb[kCB][kCN / 2], daj[2], dtj[2];
    double rowacc[2] = {0.0, 0.0};
    if (jt >= 0) {
      mbar_wait(bar_af + 8 * cw, used & 1);
      // the state terms: adx = exp(T - dacs_j) B_j G^T (dx / dt so far),
      // adb = exp(T - dacs_j) dt_j x_j G
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int ks = 0; ks < N / 16; ++ks)
          wgmma_ss<P>(adx, W::kmaj_n(anc, kTile, ks * 16),
                      W::kmaj_n(sG + part * W::kState, P, ks * 16),
                      part > 0 || ks > 0);
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int ks = 0; ks < P / 16; ++ks)
            wgmma_ss_t<kCN>(adb[cb], W::kmaj_p(anc + W::kTileN, ks * 16),
                            W::mn_n(sG + part * W::kState, P, cb, ks),
                            part > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(adx);
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb) fence_regs(adb[cb]);
      float f[2], qv[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        daj[hf] = sDa[jr[hf]];
        dtj[hf] = sDt[jr[hf]];
        f[hf] = expf(T_ - daj[hf]);
      }
      // q_j = dt_j x_j . adx_j
#pragma unroll
      for (int e = 0; e < P / 2; e += 2) {
        const int hf = (e >> 1) & 1, col = 8 * (e >> 2) + 2 * t4;
        adx[e] *= f[hf];
        adx[e + 1] *= f[hf];
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(
                anc_ptr + W::kTileN + W::off_p(rl[hf], col)));
        qv[hf] += adx[e] * xv.x + adx[e + 1] * xv.y;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float q = sum_quad(qv[hf]);
        if (t4 == 0) sQ[jr[hf]] = q * dtj[hf];
      }
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
        for (int e = 0; e < kCN / 2; ++e)
          adb[cb][e] *= f[(e >> 1) & 1] * dtj[(e >> 1) & 1];
    }

    for (int k = 0; k < len; ++k, ++n) {
      const int it = stream_tile(0, k, tiles), s = n % kStages;
      mbar_wait(bar_rf + 8 * s, (n / kStages) & 1);
      if (jt >= 0 && it >= jt) {
        const uint32_t slot = sRing + s * W::kSlot;
        const int i0 = it * kTile;
        // S^T = B_j C_i^T, DX^T = x_j dy_i^T
        float sc[kTile / 2], dv[kTile / 2];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < N / 16; ++ks)
          wgmma_ss<kTile>(sc, W::kmaj_n(anc, kTile, ks * 16),
                          W::kmaj_n(slot, kTile, ks * 16), ks > 0);
#pragma unroll
        for (int ks = 0; ks < P / 16; ++ks)
          wgmma_ss<kTile>(dv, W::kmaj_p(anc + W::kTileN, ks * 16),
                          W::kmaj_p(slot + W::kTileN, ks * 16), ks > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dv);
        // W^T = S^T e, V^T = DX^T e dt_j, e = exp(dacs_i - dacs_j) masked
        // on the exponent on the diagonal tile; M = S V strictly below the
        // diagonal, summed along j's row
        float rowm[2] = {0.f, 0.f};
        if (it == jt) {
#pragma unroll
          for (int e = 0; e < kTile / 2; ++e) {
            const int hf = (e >> 1) & 1;
            const int i = i0 + 8 * (e >> 2) + 2 * t4 + (e & 1), j = jr[hf];
            const float ex = __expf(i >= j ? sDa[i] - daj[hf] : -INFINITY);
            const float w = sc[e] * ex, v = dv[e] * ex * dtj[hf];
            rowm[hf] += i > j ? sc[e] * v : 0.f;
            sc[e] = w;
            dv[e] = v;
          }
        } else {
#pragma unroll
          for (int e = 0; e < kTile / 2; ++e) {
            const int hf = (e >> 1) & 1;
            const int i = i0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
            const float ex = __expf(sDa[i] - daj[hf]);
            const float w = sc[e] * ex, v = dv[e] * ex * dtj[hf];
            rowm[hf] += sc[e] * v;
            sc[e] = w;
            dv[e] = v;
          }
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) rowacc[hf] += sum_quad(rowm[hf]);
        // the accumulator's columns 16 kk .. 16 kk + 15 are the A fragment
        // of that k-step, as hi and lo parts
        uint32_t whi[kTile / 16][4], wlo[kTile / 16][4];
        uint32_t vhi[kTile / 16][4], vlo[kTile / 16][4];
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            split_bf16(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1], whi[kk][q],
                       wlo[kk][q]);
            split_bf16(dv[8 * kk + 2 * q], dv[8 * kk + 2 * q + 1], vhi[kk][q],
                       vlo[kk][q]);
          }
        // dx_j / dt_j += W^T dy_i; dB_j += V^T C_i
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          wgmma_rs<P>(adx, whi[kk], W::mn_p(slot + W::kTileN, kk));
          wgmma_rs<P>(adx, wlo[kk], W::mn_p(slot + W::kTileN, kk));
        }
#pragma unroll
        for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
          for (int kk = 0; kk < kTile / 16; ++kk) {
            wgmma_rs<kCN>(adb[cb], vhi[kk], W::mn_n(slot, kTile, cb, kk));
            wgmma_rs<kCN>(adb[cb], vlo[kk], W::mn_n(slot, kTile, cb, kk));
          }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(adx);
#pragma unroll
        for (int cb = 0; cb < kCB; ++cb) fence_regs(adb[cb]);
        fence_regs(whi);
        fence_regs(wlo);
        fence_regs(vhi);
        fence_regs(vlo);
      }
      mbar_arrive(bar_re + 8 * s);
    }

    if (jt >= 0) {
      // the j tile is done: x . adx for ddt (the anchor's last read), then
      // dx = dt adx and dB's partial.  The anchor is freed only once the
      // quad sums of x . adx are stored, which waits for every lane's
      // loads of x, and after a proxy fence: the producer's next TMA load
      // (the async proxy) into the anchor must not overtake those generic
      // loads.  Freed right after the loads were issued, with no fence, up
      // to eight rows of a warp's ddt came out wrong in one launch of seven
      // at zamba2-2.7b's shape (dx, dB and dC right), as if the refill had
      // overtaken the loads; with the fence, none in 120
      float dd[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < P / 2; e += 2) {
        const int hf = (e >> 1) & 1, col = 8 * (e >> 2) + 2 * t4;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(
                anc_ptr + W::kTileN + W::off_p(rl[hf], col)));
        dd[hf] += adx[e] * xv.x + adx[e + 1] * xv.y;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float d = sum_quad(dd[hf]);
        if (t4 == 0) {
          sDd[jr[hf]] = d;
          sA[jr[hf]] = rowacc[hf];   // d dacs_j's - part
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(bar_ae + 8 * cw);
      ++used;
#pragma unroll
      for (int e = 0; e < P / 2; e += 2) {
        const int hf = (e >> 1) & 1, col = 8 * (e >> 2) + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(
            dx + (t_off + jr[hf] * hs) * P + col) =
            __floats2bfloat162_rn(dtj[hf] * adx[e], dtj[hf] * adx[e + 1]);
      }
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
        for (int e = 0; e < kCN / 2; e += 2) {
          const int hf = (e >> 1) & 1;
          const int col = cb * kCN + 8 * (e >> 2) + 2 * t4;
          *reinterpret_cast<float2*>(db_part + (t_off + jr[hf] * hs) * N +
                                     col) = make_float2(adb[cb][e],
                                                        adb[cb][e + 1]);
        }
    }
  }

  // ---- phase 1, i-major: dC's partial, r, M's row sums, d dacs ----
  for (int r = 0; r < 2; ++r) {
    const int an[2] = {owned_tile(0, r, tiles), owned_tile(1, r, tiles)};
    if (an[0] < 0 && an[1] < 0) continue;
    const int it = an[cw], len = stream_len(1, an, tiles);
    const int ir[2] = {it * kTile + rl[0], it * kTile + rl[1]};
    float adc[kCB][kCN / 2], dai[2], rr[2] = {0.f, 0.f};
    double plus[2] = {0.0, 0.0};
    if (it >= 0) {
      mbar_wait(bar_af + 8 * cw, used & 1);
      // the state term exp(dacs_i) dy_i S, whose dot with C_i is r_i
      wgmma_fence();
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int ks = 0; ks < P / 16; ++ks)
            wgmma_ss_t<kCN>(adc[cb], W::kmaj_p(anc + W::kTileN, ks * 16),
                            W::mn_n(sS + part * W::kState, P, cb, ks),
                            part > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb) fence_regs(adc[cb]);
      float f[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        dai[hf] = sDa[ir[hf]];
        f[hf] = expf(dai[hf]);
      }
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
        for (int e = 0; e < kCN / 2; e += 2) {
          const int hf = (e >> 1) & 1;
          const int col = cb * kCN + 8 * (e >> 2) + 2 * t4;
          adc[cb][e] *= f[hf];
          adc[cb][e + 1] *= f[hf];
          const float2 cv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  anc_ptr + W::off_n(kTile, rl[hf], col)));
          rr[hf] += adc[cb][e] * cv.x + adc[cb][e + 1] * cv.y;
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) rr[hf] = sum_quad(rr[hf]);
    }

    for (int k = 0; k < len; ++k, ++n) {
      const int jt = stream_tile(1, k, tiles), s = n % kStages;
      mbar_wait(bar_rf + 8 * s, (n / kStages) & 1);
      if (it >= 0 && jt <= it) {
        const uint32_t slot = sRing + s * W::kSlot;
        const int j0 = jt * kTile;
        // S = C_i B_j^T and DX = dy_i x_j^T, recomputed with rows i
        float sc[kTile / 2], dv[kTile / 2];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < N / 16; ++ks)
          wgmma_ss<kTile>(sc, W::kmaj_n(anc, kTile, ks * 16),
                          W::kmaj_n(slot, kTile, ks * 16), ks > 0);
#pragma unroll
        for (int ks = 0; ks < P / 16; ++ks)
          wgmma_ss<kTile>(dv, W::kmaj_p(anc + W::kTileN, ks * 16),
                          W::kmaj_p(slot + W::kTileN, ks * 16), ks > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dv);
        // V = DX e dt_j; M = S V strictly below the diagonal, summed along
        // i's row
        float rowm[2] = {0.f, 0.f};
        if (jt == it) {
#pragma unroll
          for (int e = 0; e < kTile / 2; ++e) {
            const int hf = (e >> 1) & 1;
            const int j = j0 + 8 * (e >> 2) + 2 * t4 + (e & 1), i = ir[hf];
            const float ex = __expf(j <= i ? dai[hf] - sDa[j] : -INFINITY);
            const float v = dv[e] * ex * sDt[j];
            rowm[hf] += i > j ? sc[e] * v : 0.f;
            dv[e] = v;
          }
        } else {
#pragma unroll
          for (int e = 0; e < kTile / 2; ++e) {
            const int j = j0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
            const float v = dv[e] * __expf(dai[(e >> 1) & 1] - sDa[j]) * sDt[j];
            rowm[(e >> 1) & 1] += sc[e] * v;
            dv[e] = v;
          }
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) plus[hf] += sum_quad(rowm[hf]);
        uint32_t vhi[kTile / 16][4], vlo[kTile / 16][4];
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            split_bf16(dv[8 * kk + 2 * q], dv[8 * kk + 2 * q + 1], vhi[kk][q],
                       vlo[kk][q]);
        // dC_i += V B_j
        wgmma_fence();
#pragma unroll
        for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
          for (int kk = 0; kk < kTile / 16; ++kk) {
            wgmma_rs<kCN>(adc[cb], vhi[kk], W::mn_n(slot, kTile, cb, kk));
            wgmma_rs<kCN>(adc[cb], vlo[kk], W::mn_n(slot, kTile, cb, kk));
          }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int cb = 0; cb < kCB; ++cb) fence_regs(adc[cb]);
        fence_regs(vhi);
        fence_regs(vlo);
      }
      mbar_arrive(bar_re + 8 * s);
    }

    if (it >= 0) {
      // the anchor's generic loads (r_i's C) ordered before its refill
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(bar_ae + 8 * cw);
      ++used;
      // d dacs_i (its sum over j less its sum over k, which this thread
      // left in sA in phase 0) plus r_i: what the suffix sum adds at row i
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (t4 == 0)
          sA[ir[hf]] = (plus[hf] - sA[ir[hf]]) + static_cast<double>(rr[hf]);
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
        for (int e = 0; e < kCN / 2; e += 2) {
          const int hf = (e >> 1) & 1;
          const int col = cb * kCN + 8 * (e >> 2) + 2 * t4;
          *reinterpret_cast<float2*>(dc_part + (t_off + ir[hf] * hs) * N +
                                     col) = make_float2(adc[cb][e],
                                                        adc[cb][e + 1]);
        }
    }
  }
  named_sync(kBarAll, 256);

  // g = d(dt a) at row k: the suffix sum of d dacs (rows k and below),
  // plus the q_j of the rows above k and exp(T) <G, S> (dT, which reaches
  // g at every row; the q_j reach dT and dacs_j with opposite signs, so
  // only those above k are left, summed without cancelling); ddt and da.
  // All 256 consumer threads, in double: thread k takes row k, each warp
  // scans its 32 rows across its lanes and the warps' totals are summed in
  // warp order (a fixed order: two launches give equal bits)
  const int wid = ct / 32;
  const double aj = ct < L ? sA[ct] : 0.0;
  const double qj = ct < L ? static_cast<double>(sQ[ct]) : 0.0;
  double below = aj, above = qj;   // this warp's rows from k on, up to k
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_down_sync(0xffffffffu, below, off);
    const double v = __shfl_up_sync(0xffffffffu, above, off);
    if (lane + off < 32) below += u;
    if (lane >= off) above += v;
  }
  if (lane == 0) sRed[16 + wid] = below;
  if (lane == 31) sRed[24 + wid] = above;
  above = __shfl_up_sync(0xffffffffu, above, 1);   // up to k - 1
  if (lane == 0) above = 0.0;
  named_sync(kBarAll, 256);
  double gs_sum = 0.0;
  for (int w = 0; w < 8; ++w) gs_sum += sRed[w];
  double after = 0.0, before = static_cast<double>(expf(T_)) * gs_sum;
  for (int w = wid + 1; w < 8; ++w) after += sRed[16 + w];
  for (int w = 0; w < wid; ++w) before += sRed[24 + w];
  double da = 0.0;
  if (ct < L) {
    const double gj = (below + after) + (before + above);
    ddt[t_off + static_cast<long long>(ct) * hs] =
        static_cast<float>(static_cast<double>(sDd[ct]) + ah * gj);
    da = static_cast<double>(sDt[ct]) * gj;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    da += __shfl_xor_sync(0xffffffffu, da, off);
  if (lane == 0) sRed[32 + wid] = da;
  named_sync(kBarAll, 256);
  if (ct == 0) {
    for (int w = 1; w < 8; ++w) da += sRed[32 + w];
    da_part[blockIdx.x] = da;
  }
}

// ---------------------------------------------------------------------------
// the launches
// ---------------------------------------------------------------------------

struct Buffers {
  const void *x, *dt, *a, *b, *c, *states, *dy, *dfinal;
  void *dx, *ddt, *da, *db, *dc, *dinit, *gstates, *datot, *db_part,
      *dc_part, *da_part;
};

// kernel 4, the same for both dtypes
template <typename T>
cudaError_t launch_reduce(const Buffers& u, int batch, int groups, int n,
                          const Problem& p, cudaStream_t s) {
  const long long tokens = static_cast<long long>(batch) * p.seqlen;
  const long long outs = tokens * groups * n;
  bwd_reduce<T><<<static_cast<unsigned>((outs + kThreads - 1) / kThreads),
                  kThreads, 0, s>>>(
      static_cast<const float*>(u.db_part),
      static_cast<const float*>(u.dc_part),
      static_cast<const double*>(u.da_part), static_cast<T*>(u.db),
      static_cast<T*>(u.dc), static_cast<float*>(u.da), tokens, p.heads,
      groups, n, batch * (p.seqlen / p.chunk));
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t launch_f32(const Buffers& u, int batch, int groups,
                       const Problem& p, cudaStream_t s) {
  using T = float;
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
  return launch_reduce<T>(u, batch, groups, N, p, s);
}

template <int P, int N>
cudaError_t launch_bf16(const Buffers& u, int batch, int groups,
                        const Problem& p, cudaStream_t s) {
  using W = Wg<P, N>;
  using T = __nv_bfloat16;
  const CUtensorMapSwizzle swz_n = W::kColsN == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                                   : CU_TENSOR_MAP_SWIZZLE_64B;
  const CUtensorMapSwizzle swz_p = P == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                           : CU_TENSOR_MAP_SWIZZLE_64B;
  // dy: contiguous [B, S, H, P]
  const Strides dys{static_cast<long long>(p.seqlen) * p.heads * P, P,
                    static_cast<long long>(p.heads) * P};
  CUtensorMap tx, tb, tc, tdy;
  if (!tensor_map(&tx, u.x, P, p.seqlen, p.heads, batch,
                  {p.x_sb, p.x_sh, p.x_ss}, P, kTile, swz_p) ||
      !tensor_map(&tb, u.b, N, p.seqlen, groups, batch,
                  {p.b_sb, p.b_sg, p.b_ss}, W::kColsN, kTile, swz_n) ||
      !tensor_map(&tc, u.c, N, p.seqlen, groups, batch,
                  {p.c_sb, p.c_sg, p.c_ss}, W::kColsN, kTile, swz_n) ||
      !tensor_map(&tdy, u.dy, P, p.seqlen, p.heads, batch, dys, P, kTile,
                  swz_p))
    return cudaErrorInvalidValue;
  const int nc = p.seqlen / p.chunk;
  const int blocks = batch * nc * p.heads;
  auto states = bwd_states_wg<P, N>;
  cudaError_t e = cudaFuncSetAttribute(
      states, cudaFuncAttributeMaxDynamicSharedMemorySize,
      StatesSmem<P, N>::kSmem);
  if (e != cudaSuccess) return e;
  states<<<batch * p.heads, StatesSmem<P, N>::kThreads,
           StatesSmem<P, N>::kSmem, s>>>(
      tc, tdy, static_cast<const float*>(u.dt),
      static_cast<const float*>(u.a), static_cast<const float*>(u.dfinal),
      static_cast<float*>(u.gstates), static_cast<float*>(u.dinit), p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  auto chunk = bwd_chunk_ws<P, N>;
  e = cudaFuncSetAttribute(chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           ChunkWs<P, N>::kSmem);
  if (e != cudaSuccess) return e;
  chunk<<<blocks, ChunkWs<P, N>::kThreads, ChunkWs<P, N>::kSmem, s>>>(
      tx, tb, tc, tdy, static_cast<const float*>(u.dt),
      static_cast<const float*>(u.a), static_cast<const float*>(u.states),
      static_cast<const float*>(u.gstates), static_cast<T*>(u.dx),
      static_cast<float*>(u.ddt), static_cast<float*>(u.db_part),
      static_cast<float*>(u.dc_part), static_cast<double*>(u.da_part), p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return launch_reduce<T>(u, batch, groups, N, p, s);
}

template <int P>
cudaError_t dispatch_n(int n, int dtype, const Buffers& u, int batch,
                       int groups, const Problem& p, cudaStream_t s) {
  switch (n * 2 + dtype) {
    case 32 * 2: return launch_f32<P, 32>(u, batch, groups, p, s);
    case 64 * 2: return launch_f32<P, 64>(u, batch, groups, p, s);
    case 128 * 2: return launch_f32<P, 128>(u, batch, groups, p, s);
    case 32 * 2 + 1: return launch_bf16<P, 32>(u, batch, groups, p, s);
    case 64 * 2 + 1: return launch_bf16<P, 64>(u, batch, groups, p, s);
    case 128 * 2 + 1: return launch_bf16<P, 128>(u, batch, groups, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: [B, S, H, P]; B and C: [B, S, G, N], each by its (batch, seq,
// head-or-group) strides in elements with the last dim contiguous (and, in
// bf16, every stride and base aligned to 16 bytes: TMA reads them); dt:
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
      chunk > kMaxChunk || seqlen % chunk != 0 || (dtype != 0 && dtype != 1) ||
      static_cast<long long>(batch) * (seqlen / chunk) * heads > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const Problem pr{heads, heads / groups, seqlen, chunk,
                   x_sb, x_ss, x_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  const Buffers u{x, dt, a, b, c, states, dy, dfinal, dx, ddt, da, db, dc,
                  dinit, gstates, datot, db_part, dc_part, da_part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 32: return dispatch_n<32>(n, dtype, u, batch, groups, pr, s);
    case 64: return dispatch_n<64>(n, dtype, u, batch, groups, pr, s);
    default: return cudaErrorInvalidValue;
  }
}
