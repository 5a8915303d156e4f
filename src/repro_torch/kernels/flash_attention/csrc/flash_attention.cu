// K1: flash attention forward for Hopper (sm_90a), bound to Python through
// ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_kernel (body _flash_kernel) and its GQA wrapper ops.py::
// flash_attention.
//
//   O = softmax(mask(cap(Q K^T / sqrt(d)))) V      per (batch, query head)
//
// with an online softmax over KV tiles (running max m, sum l and accumulator
// in f32), a causal mask, a sliding window (0 <= q - k < window), a tanh
// logit cap and a query offset q_offset (absolute position of q[0]).
//
// Bound on an H100: operations.  At a llama3-1b prefill (B=4, 32 query heads,
// S=2048, d=64, causal) the causal half of QK^T and PV is 2*S^2*d flops per
// head, 68.7 GFLOP in all: 69 us at the bf16 tensor-core peak of 989 TFLOP/s,
// against 84 MB of q, k, v and o, 25 us at 3.35 TB/s.  At d=64 the
// exponentials cost as much: 268.6 M visible scores at the ~3.9 T/s of the
// special-function units is another 69 us, so the design overlaps them with
// the products.  What the design does about those bounds:
//   * bf16 (flash_fwd_bf16) is warp-specialised and persistent: one block
//     an SM, in which one producer warpgroup streams Q and K and V tiles
//     through a ring of shared-memory stages with TMA and mbarriers and
//     gives most of its registers to two consumer warpgroups (setmaxnreg)
//     of 64 query rows each.  Both products run on wgmma: S = Q K^T with Q
//     and K K-major in shared memory, and O += P V with P in registers and
//     V MN-major in shared memory (the transpose bit, no transposing copy).
//     A consumer runs a tile's softmax while the previous tile's P V runs,
//     and the two consumers take turns at the tensor cores (named
//     barriers), so one's exponentials run under the other's products;
//   * f32 (flash_fwd_f32) runs the products as f32 FMAs, bound by the
//     67 TFLOP/s f32 rate, with loads and products in turn;
//   * a loop inside the block over key tiles takes the place of the TPU
//     grid's sequential innermost axis (which carried m, l and acc in VMEM
//     scratch); m, l and acc live in registers across the loop, and the
//     [Sq, Skv] scores never reach device memory;
//   * the loop starts at the window's edge and stops at the causal diagonal,
//     so masked tiles are never loaded or computed (same result, less work);
//     bf16 takes the query tiles that see the most keys first;
//   * the KV head is h / group, read in place (the TPU wrapper repeats K and
//     V in memory for GQA);
//   * ragged Sq and Skv tails are masked, not asserted; q, k, v and o are
//     addressed through their strides (last dim contiguous), so the
//     [B, S, H, D] projections are read without a transposing copy.
// A key masked out contributes exactly 0, and a row with no visible key at
// all writes 0.
//
// Where the caller passes an lse buffer ([B, Hq, Sq] f32, contiguous) the
// epilogue also writes each row's log-sum-exp, the natural log of
// sum_j exp(s_ij) over the visible keys of the scaled, capped scores s_ij,
// for the backward (flash_attention_bwd.cu) to recompute P = exp(s - lse).
// A row with no visible key writes -inf.  With a null lse the kernels do
// what they did without it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../common/csrc/hopper.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 16
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Problem {
  int hq, group, sq, skv;
  Strides qs, ks, vs, os;
  int causal, window;
  float logit_cap;
  int q_offset;
  float scale;
  float* lse;  // [B, Hq, Sq] f32, or null
};

// keys [lo, hi) that some query of the kRows-row tile starting at q0 can
// see: start at the window's edge (rounded down to a kKeys tile), stop at
// the causal diagonal
template <int kRows = kBlockQ, int kKeys = kBlockK>
__device__ __forceinline__ void key_range(const Problem& p, int q0, int* lo,
                                          int* hi) {
  const int q_first = q0 + p.q_offset;
  const int q_last = min(q0 + kRows, p.sq) - 1 + p.q_offset;
  *lo = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  *hi = p.causal ? min(p.skv, q_last + 1) : p.skv;
  *lo = (*lo / kKeys) * kKeys;
}

__device__ __forceinline__ bool visible(const Problem& p, int qa, int kj) {
  const int diff = qa - kj;
  return kj < p.skv && (!p.causal || diff >= 0) &&
         (p.window <= 0 || diff < p.window);
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs.  Each of the 4 warps owns 16 query rows.  For S = Q K^T a
// lane computes its 16 rows against keys lane and lane+32 (K padded to d+1
// floats a row: no bank conflicts; Q rows read as broadcast float4).  P goes
// through a per-warp shared tile, and for O += P V a lane owns output
// columns lane + 32*j of its 16 rows.
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t f32_smem_bytes() {
  return (kBlockQ * D + kBlockK * (D + 1) + kBlockK * D +
          kWarps * kRowsPerWarp * kBlockK) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Problem p) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int kCols = D / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockQ * D;
  float* sV = sK + kBlockK * (D + 1);
  float* sP = sV + kBlockK * D;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y / p.hq, h = blockIdx.y % p.hq;
  const int q0 = blockIdx.x * kBlockQ;
  float* lse_row = p.lse == nullptr
                       ? nullptr
                       : p.lse + static_cast<long long>(blockIdx.y) * p.sq;
  const float* qb = q + b * p.qs.b + h * p.qs.h;
  const float* kb = k + b * p.ks.b + (h / p.group) * p.ks.h;
  const float* vb = v + b * p.vs.b + (h / p.group) * p.vs.h;
  float* ob = o + b * p.os.b + h * p.os.h;

  for (int i = tid; i < kBlockQ * D / 4; i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.sq)
      x = *reinterpret_cast<const float4*>(qb + (q0 + r) * p.qs.s + c);
    x.x *= p.scale; x.y *= p.scale; x.z *= p.scale; x.w *= p.scale;
    *reinterpret_cast<float4*>(sQ + r * D + c) = x;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;
  }
  int kv_lo, kv_hi;
  key_range(p, q0, &kv_lo, &kv_hi);
  const int row0 = warp * kRowsPerWarp;
  float* sPw = sP + warp * kRowsPerWarp * kBlockK;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous K, V tiles
    for (int i = tid; i < kBlockK * D / 4; i += kThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < p.skv) {
        kx = *reinterpret_cast<const float4*>(kb + (k0 + r) * p.ks.s + c);
        vx = *reinterpret_cast<const float4*>(vb + (k0 + r) * p.vs.s + c);
      }
      float* kr = sK + r * (D + 1) + c;
      kr[0] = kx.x; kr[1] = kx.y; kr[2] = kx.z; kr[3] = kx.w;
      *reinterpret_cast<float4*>(sV + r * D + c) = vx;
    }
    __syncthreads();

    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    const float* ka = sK + lane * (D + 1);
    const float* kc = sK + (lane + 32) * (D + 1);
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float a0 = ka[d], a1 = ka[d + 1], a2 = ka[d + 2], a3 = ka[d + 3];
      const float c0 = kc[d], c1 = kc[d + 1], c2 = kc[d + 2], c3 = kc[d + 3];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(sQ + (row0 + r) * D + d);
        s[r][0] += qv.x * a0 + qv.y * a1 + qv.z * a2 + qv.w * a3;
        s[r][1] += qv.x * c0 + qv.y * c1 + qv.z * c2 + qv.w * c3;
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qa = q0 + row0 + r + p.q_offset;  // absolute query position
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = s[r][j];
        if (p.logit_cap > 0.f) x = p.logit_cap * tanhf(x / p.logit_cap);
        s[r][j] = visible(p, qa, k0 + lane + 32 * j) ? x : -INFINITY;
        mx = fmaxf(mx, s[r][j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float p0 = 0.f, p1 = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {  // some key of this row is visible so far
        alpha = expf(m[r] - m_new);  // 0 while m[r] is still -inf
        p0 = expf(s[r][0] - m_new);  // masked: exp(-inf) = 0
        p1 = expf(s[r][1] - m_new);
      }
      float rs = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = l[r] * alpha + rs;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[r][j] *= alpha;
      sPw[r * kBlockK + lane] = p0;
      sPw[r * kBlockK + lane + 32] = p1;
    }
    __syncwarp();

#pragma unroll 2
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float vv[4][kCols];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          vv[t][j] = sV[(kk + t) * D + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pr =
            *reinterpret_cast<const float4*>(sPw + r * kBlockK + kk);
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[r][j] += pr.x * vv[0][j] + pr.y * vv[1][j] + pr.z * vv[2][j] +
                       pr.w * vv[3][j];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    if (qi < p.sq) {
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        ob[qi * p.os.s + lane + 32 * j] = acc[r][j] * inv;
      // m and l are in natural units here (Q was scaled on load)
      if (lse_row != nullptr && lane == 0)
        lse_row[qi] = l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA, wgmma and warp specialisation.
//
// One persistent block on each SM walks work items of 128 query rows of one
// (batch, query head), the items whose rows see the most keys first, with
// three warpgroups:
//   * warpgroup 0, the producer: one thread loads each item's Q tile and
//     then its K and V tiles of 128 keys into a ring of stages (three; two
//     at d=128) with TMA.  Each stage has a "full" mbarrier for K and one
//     for V (the TMA reports its bytes to them) and an "empty" mbarrier on
//     which the 256 consumer threads arrive when they are done with the
//     stage; Q has a full and an empty mbarrier of its own.  The ring runs on
//     across items, and the next Q loads once the consumers' last Q K^T
//     is done;
//   * warpgroups 1 and 2, the consumers: 64 query rows each, in wgmma's
//     accumulator layout (warp w holds rows 16w .. 16w+15; lane l rows
//     l/4 and l/4 + 8, columns 2(l%4) + 8j and the one after).  For key
//     tile i a consumer issues S_i = Q K_i^T and O += P_{i-1} V_{i-1} (P
//     from registers), runs the softmax of S_i while the second product
//     runs, then rescales O and turns S_i into the bf16 P_i.  The S
//     accumulator of a 16-key slice is exactly the register A fragment of P
//     for that slice, so P never leaves registers.  The two consumers issue
//     their products in turn (named barriers), so that the tensor cores work
//     for one while the other exponentiates.
// Shared tiles are stored as TMA writes them with the 128-byte swizzle
// (64 columns a row; d=128 as two such column blocks) or, at d=32, the
// 64-byte swizzle; the wgmma descriptors name the same swizzle.  Every tile
// starts on a 1024-byte boundary, where the swizzle pattern starts.  The
// output goes through shared memory and out with one TMA store per
// consumer, which also clips the rows past Sq.
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;       // query rows of a consumer warpgroup
constexpr int kBarTurn = 1;   // named barriers 1, 2: whose turn at wgmma
constexpr int kBarStore = 3;  // named barriers 3, 4: a consumer's epilogue

template <int D>
struct Bf16Tiles {
  // consumer warpgroups (three, as 192-row items, measured faster without
  // a causal mask and slower with one; see PERF.md)
  static constexpr int kConsumers = 2;
  static constexpr int kTileQ = kWgRows * kConsumers;  // query rows of an item
  static constexpr int kThreads = 128 * (1 + kConsumers);
  // 384 threads at 168 registers each fill the SM's 64K registers: the
  // producer gives back 128 x 128 of them, which the consumers take
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static constexpr int kCols = D < 64 ? D : 64;  // columns of a swizzled block
  static constexpr int kColBlocks = D / kCols;
  static constexpr int kRowBytes = kCols * 2;    // one row of a block
  static constexpr int kSwizzleBits = kCols == 64 ? 3 : 2;  // 128 or 64 bytes
  static constexpr int kLayout = kCols == 64 ? 1 : 2;  // wgmma layout type
  static constexpr int kTileK = 128;  // keys of a K or V tile
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kQBytes = kTileQ * D * 2;
  static constexpr int kKVBytes = kTileK * D * 2;  // one K or V tile
  static constexpr int kBarBytes = 8 * (2 + 3 * kStages);
  // Q, O, the K and V ring, the barriers; + 1024 to align the dynamic
  // shared memory to the swizzle's period
  static constexpr int kSmem =
      2 * kQBytes + 2 * kStages * kKVBytes + kBarBytes + 1024;
  static_assert(kSmem <= 232448, "at most 227 KB of shared memory a block");
};

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 32) {
    wgmma_rs_n32(o, a, db);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(o, a, db);
  } else {
    wgmma_rs_n128(o, a, db);
  }
}

// one work item: kTileQ query rows of one (batch, query head), and the key
// tiles [lo, lo + n * kTileK) that they can see.  Items are numbered with
// the query tiles that see the most keys first.
struct Work {
  int b, h, hk, q0, lo, n;
};

template <int kTileQ, int kTileK>
__device__ __forceinline__ Work work_item(const Problem& p, int w, int n_bh,
                                          int n_q_tiles) {
  Work x;
  const int bh = w % n_bh;
  x.b = bh / p.hq;
  x.h = bh % p.hq;
  x.hk = x.h / p.group;
  x.q0 = (n_q_tiles - 1 - w / n_bh) * kTileQ;
  int hi;
  key_range<kTileQ, kTileK>(p, x.q0, &x.lo, &hi);
  x.n = hi > x.lo ? (hi - x.lo + kTileK - 1) / kTileK : 0;
  return x;
}

// Persistent: block b takes work items b, b + gridDim.x, ...  The K/V ring
// runs on across items, and the producer loads the next item's Q as soon as
// the consumers' last Q K^T of the current one is done, so one item's
// softmax, last products and output overlap the next one's loads.
template <int D>
__global__ void __launch_bounds__(Bf16Tiles<D>::kThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap to, Problem p, int n_bh,
               int n_q_tiles) {
  static_assert(D == 32 || D == 64 || D == 128, "head_dim 32, 64 or 128");
  using T = Bf16Tiles<D>;
  constexpr int kS = T::kStages, kC = T::kConsumers, kTileQ = T::kTileQ,
                kTileK = T::kTileK;
  constexpr uint32_t kSbo = 8 * T::kRowBytes;  // 8 rows of a swizzled block
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sO = sQ + T::kQBytes;           // the output, on its way out
  const uint32_t sK = sO + T::kQBytes;           // stage st at + st * kKVBytes
  const uint32_t sV = sK + kS * T::kKVBytes;
  const uint32_t bar_qf = sV + kS * T::kKVBytes;  // Q has landed
  const uint32_t bar_qe = bar_qf + 8;  // the consumers are done with Q
  const uint32_t bar_k = bar_qe + 8;   // + 8 st: K of stage st has landed
  const uint32_t bar_v = bar_k + 8 * kS;  // + 8 st: V of stage st has landed
  const uint32_t bar_e = bar_v + 8 * kS;  // + 8 st: stage st is free
  const int n_work = n_bh * n_q_tiles;

  if (threadIdx.x == 0) {
    mbar_init(bar_qf, 1);
    mbar_init(bar_qe, kC * 128);
    for (int st = 0; st < kS; ++st) {
      mbar_init(bar_k + 8 * st, 1);
      mbar_init(bar_v + 8 * st, 1);
      mbar_init(bar_e + 8 * st, kC * 128);
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
                 ::"n"(T::kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0, j = 0;  // key tiles and work items of this block so far
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++j) {
        const Work x = work_item<kTileQ, kTileK>(p, w, n_bh, n_q_tiles);
        mbar_wait(bar_qe, (j & 1) ^ 1);  // the consumers are done with Q
        mbar_expect_tx(bar_qf, T::kQBytes);
        for (int c = 0; c < kC; ++c)
          for (int cb = 0; cb < T::kColBlocks; ++cb)
            tma_load(sQ + (cb * kTileQ + c * kWgRows) * T::kRowBytes, &tq,
                     bar_qf, cb * T::kCols, x.q0 + c * kWgRows, x.h, x.b);
        for (int i = 0; i < x.n; ++i, ++it) {
          const int st = it % kS;
          const uint32_t phase = (it / kS) & 1;
          mbar_wait(bar_e + 8 * st, phase ^ 1);  // the stage is free
          const int k0 = x.lo + i * kTileK;
          mbar_expect_tx(bar_k + 8 * st, T::kKVBytes);
          for (int cb = 0; cb < T::kColBlocks; ++cb)
            tma_load(sK + st * T::kKVBytes + cb * kTileK * T::kRowBytes, &tk,
                     bar_k + 8 * st, cb * T::kCols, k0, x.hk, x.b);
          mbar_expect_tx(bar_v + 8 * st, T::kKVBytes);
          for (int cb = 0; cb < T::kColBlocks; ++cb)
            tma_load(sV + st * T::kKVBytes + cb * kTileK * T::kRowBytes, &tv,
                     bar_v + 8 * st, cb * T::kCols, k0, x.hk, x.b);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kConsumerRegs));
  const int c = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, t4 = lane % 4;
  const float scale_log2 = p.scale * kLog2e;
  const uint32_t q_rows = sQ + c * kWgRows * T::kRowBytes;
  const uint32_t o_rows = sO + c * kWgRows * T::kRowBytes;

  // Q and K K-major, 16 columns deep at column `col`; V MN-major, 16 keys
  // deep at key 16 kk
  auto q_desc = [&](int col) {
    return smem_desc(q_rows + (col / T::kCols) * kTileQ * T::kRowBytes +
                         (col % T::kCols) * 2,
                     16, kSbo, T::kLayout);
  };
  auto k_desc = [&](int st, int col) {
    return smem_desc(sK + st * T::kKVBytes +
                         (col / T::kCols) * kTileK * T::kRowBytes +
                         (col % T::kCols) * 2,
                     16, kSbo, T::kLayout);
  };
  auto v_desc = [&](int st, int kk) {
    return smem_desc(sV + st * T::kKVBytes + kk * 16 * T::kRowBytes,
                     kTileK * T::kRowBytes, kSbo, T::kLayout);
  };

  constexpr int kN = kTileK / 2;  // S accumulator registers of a thread
  float o[D / 2], s[kN];
#pragma unroll
  for (int x = 0; x < kN; ++x) s[x] = 0.f;
  uint32_t pf[kTileK / 16][4];
  // m in log2 units; l a partial sum over this lane's columns
  float m[2], l[2];
  float alpha[2];
  // the current item's first key, the absolute positions of this thread's
  // two rows and of the consumer's first and last real row
  int lo = 0, qa[2] = {0, 0}, wg_first = 0, wg_last = 0;

  // S = Q K^T of the tile in stage st, and O += P V of the tile in stage st,
  // each one commit group
  auto issue_qk = [&](int st) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n128(s, q_desc(ks * 16), k_desc(st, ks * 16), ks > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk)
      wgmma_pv<D>(o, pf[kk], v_desc(st, kk));
    wgmma_commit();
  };
  // the online softmax of key tile i's scores, in place: s becomes P (f32),
  // m and l move on, and alpha is the factor that rescales O
  auto softmax = [&](int i) {
    // the mask only on tiles that cross an edge of it for some row of this
    // consumer
    const int k0 = lo + i * kTileK;
    const bool interior = k0 + kTileK <= p.skv &&
                          (!p.causal || k0 + kTileK - 1 <= wg_first) &&
                          (p.window <= 0 || wg_last - k0 < p.window);
    // each step a loop of its own under a branch the whole consumer takes,
    // so that no score pays for a cap or a mask it does not have.  Without
    // a cap the scores stay raw and the scale goes into the exponent's FFMA
    // (the scale is positive, so the raw max is the max)
    float unit = scale_log2;  // s * unit is in log2 units
    if (p.logit_cap > 0.f) {
#pragma unroll
      for (int x = 0; x < kN; ++x)
        s[x] = p.logit_cap * tanhf(s[x] * p.scale / p.logit_cap) * kLog2e;
      unit = 1.f;
    }
    if (!interior) {
#pragma unroll
      for (int x = 0; x < kN; ++x) {
        const int kj = k0 + (x >> 2) * 8 + t4 * 2 + (x & 1);
        if (!visible(p, qa[(x >> 1) & 1], kj)) s[x] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int x = 0; x < kN; ++x)
      mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
    float m_use[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m[hf], mx[hf] * unit);
      // no key of the row visible yet: nothing to rescale, every p is 0
      alpha[hf] = m_new == -INFINITY ? 1.f : fast_exp2(m[hf] - m_new);
      m_use[hf] = m_new == -INFINITY ? 0.f : m_new;
      m[hf] = m_new;
      l[hf] *= alpha[hf];
    }
#pragma unroll
    for (int x = 0; x < kN; ++x) {
      // masked: exp2(-inf) = 0
      s[x] = fast_exp2(fmaf(s[x], unit, -m_use[(x >> 1) & 1]));
      l[(x >> 1) & 1] += s[x];
    }
  };
  // S's accumulator fragment of keys 16 kk .. 16 kk + 15 is the register A
  // fragment of P for that slice
  auto to_pf = [&]() {
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      pf[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  // O is rescaled once P_{i-1} V_{i-1} is in it, before P_i V_i
  auto rescale = [&]() {
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
  };

  // The consumers take turns at the tensor cores, in order: consumer c waits
  // on named barrier kBarTurn + c before it issues products and hands over
  // to the next after them.  Consumer 0 goes first, and takes one more turn
  // at the end to match the last consumer's last hand-over.  Every consumer
  // takes n turns for an item of n key tiles.
  const int next = kBarTurn + (c + 1) % kC;
  auto take_turn = [&]() {
    named_sync(kBarTurn + c, 256);
    wgmma_fence();
  };
  auto pass_turn = [&]() { named_arrive(next, 256); };
  // the ring: tile number `cur` of this block is in stage cur % kS
  auto wait_k = [&](int cur) {
    mbar_wait(bar_k + 8 * (cur % kS), (cur / kS) & 1);
  };
  auto wait_v = [&](int cur) {
    mbar_wait(bar_v + 8 * (cur % kS), (cur / kS) & 1);
  };
  auto release = [&](int cur) { mbar_arrive(bar_e + 8 * (cur % kS)); };

  if (c == kC - 1) named_arrive(kBarTurn, 256);
  int it = 0, j = 0;  // key tiles and work items of this block so far
  for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++j) {
    const Work x = work_item<kTileQ, kTileK>(p, w, n_bh, n_q_tiles);
    const int n = x.n, r0 = x.q0 + c * kWgRows + warp * 16 + g;
    lo = x.lo;
    qa[0] = r0 + p.q_offset;
    qa[1] = r0 + 8 + p.q_offset;
    wg_first = x.q0 + c * kWgRows + p.q_offset;
    wg_last = min(x.q0 + (c + 1) * kWgRows, p.sq) - 1 + p.q_offset;
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;

    mbar_wait(bar_qf, j & 1);  // Q of this item has landed
    if (n == 0) mbar_arrive(bar_qe);
    if (n > 0) {
      // key tile 0: S only (O is still 0)
      wait_k(it);
      take_turn();
      issue_qk(it % kS);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(s);
      if (n == 1) mbar_arrive(bar_qe);  // this consumer is done with Q
      softmax(0);
      to_pf();
      for (int i = 1; i < n; ++i) {
        const int cur = it + i;
        wait_k(cur);
        take_turn();
        issue_qk(cur % kS);
        wait_v(cur - 1);
        issue_pv((cur - 1) % kS);
        pass_turn();
        wgmma_wait<1>();  // S_i is done; P_{i-1} V_{i-1} may still run
        fence_regs(s);
        if (i == n - 1) mbar_arrive(bar_qe);  // this consumer is done with Q
        softmax(i);
        wgmma_wait<0>();  // P_{i-1} V_{i-1} is done
        fence_regs(o);
        fence_regs(pf);
        release(cur - 1);  // this consumer is done with tile i - 1
        rescale();
        to_pf();
      }
      const int last = it + n - 1;
      wait_v(last);  // V of the last tile
      wgmma_fence();
      issue_pv(last % kS);
      wgmma_wait<0>();
      fence_regs(o);
      release(last);
    }
    it += n;

    // O / l as bf16 into this consumer's rows of the output buffer, swizzled
    // as the O map reads them, then one TMA store (rows past Sq are clipped)
    float inv[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
      inv[hf] = l[hf] > 0.f ? 1.f / l[hf] : 0.f;
    }
    // the row's log-sum-exp: m is the row max in log2 units (the four lanes
    // of a row hold the same m) and l the row's sum of exp2(s log2e - m), so
    // lse = (m + log2 l) ln 2
    if (p.lse != nullptr && t4 == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = x.q0 + c * kWgRows + warp * 16 + g + 8 * hf;
        if (row < p.sq)
          p.lse[(static_cast<long long>(x.b) * p.hq + x.h) * p.sq + row] =
              l[hf] > 0.f ? (m[hf] + log2f(l[hf])) * kLn2 : -INFINITY;
      }
    }
    // the previous item's store has read the buffer
    if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    named_sync(kBarStore + c, 128);
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = warp * 16 + g + 8 * hf, col = jd * 8 + t4 * 2;
        const uint32_t off = row * T::kRowBytes + (col % T::kCols) * 2;
        const uint32_t swz =
            off ^ (((off >> 7) & ((1u << T::kSwizzleBits) - 1)) << 4);
        const uint32_t val = pack_bf16(o[4 * jd + 2 * hf] * inv[hf],
                                       o[4 * jd + 2 * hf + 1] * inv[hf]);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                         o_rows + (col / T::kCols) * kTileQ * T::kRowBytes +
                         swz),
                     "r"(val)
                     : "memory");
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(kBarStore + c, 128);
    if (t == 0) {
      for (int cb = 0; cb < T::kColBlocks; ++cb)
        tma_store(&to, o_rows + cb * kTileQ * T::kRowBytes, cb * T::kCols,
                  x.q0 + c * kWgRows, x.h, x.b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (c == 0) named_sync(kBarTurn, 256);  // the last consumer's hand-over
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const void* q, const void* k,
                   const void* v, void* o, int b, const Problem& p,
                   cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.sq + kBlockQ - 1) / kBlockQ, b * p.hq);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int b, int hkv, const Problem& p, cudaStream_t stream) {
  using T = Bf16Tiles<D>;
  const CUtensorMapSwizzle swizzle =
      T::kCols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tq, tk, tv, to;
  if (!tensor_map(&tq, q, D, p.sq, p.hq, b, p.qs, T::kCols, kWgRows, swizzle) ||
      !tensor_map(&tk, k, D, p.skv, hkv, b, p.ks, T::kCols, T::kTileK,
                  swizzle) ||
      !tensor_map(&tv, v, D, p.skv, hkv, b, p.vs, T::kCols, T::kTileK,
                  swizzle) ||
      !tensor_map(&to, o, D, p.sq, p.hq, b, p.os, T::kCols, kWgRows, swizzle))
    return cudaErrorInvalidValue;
  const long long n_q_tiles = (p.sq + T::kTileQ - 1) / T::kTileQ;
  const long long n_work = n_q_tiles * b * p.hq;
  if (n_work > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_bf16<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (e != cudaSuccess) return e;
  // one persistent block on each SM, or one for each work item if fewer
  int device = 0, sms = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device)) != cudaSuccess)
    return e;
  const int blocks = static_cast<int>(n_work < sms ? n_work : sms);
  kernel<<<blocks, T::kThreads, T::kSmem, stream>>>(
      tq, tk, tv, to, p, b * p.hq, static_cast<int>(n_q_tiles));
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_dtype(int dtype, const void* q, const void* k,
                           const void* v, void* o, int b, int hkv,
                           const Problem& p, cudaStream_t stream) {
  if (dtype == 0) {
    if (static_cast<long long>(b) * p.hq > 65535)  // grid.y of flash_fwd_f32
      return cudaErrorInvalidValue;
    return launch<float>(flash_fwd_f32<D>, f32_smem_bytes<D>(), q, k, v, o, b,
                         p, stream);
  }
  if (dtype == 1) return launch_bf16<D>(q, k, v, o, b, hkv, p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q: [B, Hq, Sq, D], k and v: [B, Hkv, Skv, D], o: [B, Hq, Sq, D], each given
// by its (batch, head, seq) strides in elements with the last dim contiguous;
// every stride and base pointer aligned to 16 bytes.  lse: null, or a
// contiguous [B, Hq, Sq] f32 buffer for each row's log-sum-exp.  dtype: 0 =
// float32, 1 = bfloat16.  d in {32, 64, 128}; Hq % Hkv == 0.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, float* lse, int b,
    int hq,
    int hkv, int sq, int skv, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, float logit_cap,
    int q_offset, int dtype, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || skv <= 0 ||
      static_cast<long long>(b) * hq > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const Problem p{hq,
                  hq / hkv,
                  sq,
                  skv,
                  {q_sb, q_sh, q_ss},
                  {k_sb, k_sh, k_ss},
                  {v_sb, v_sh, v_ss},
                  {o_sb, o_sh, o_ss},
                  causal,
                  window,
                  logit_cap,
                  q_offset,
                  1.0f / sqrtf(static_cast<float>(d)),
                  lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return dispatch_dtype<32>(dtype, q, k, v, o, b, hkv, p, s);
    case 64: return dispatch_dtype<64>(dtype, q, k, v, o, b, hkv, p, s);
    case 128: return dispatch_dtype<128>(dtype, q, k, v, o, b, hkv, p, s);
    default: return cudaErrorInvalidValue;
  }
}
