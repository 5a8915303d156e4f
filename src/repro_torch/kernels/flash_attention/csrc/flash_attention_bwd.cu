// K1b: the flash-attention backward for Hopper (sm_90a), bound to Python
// through ctypes.
//
// The JAX package has no backward Pallas kernel: it differentiates its plain
// attention (src/repro/kernels/flash_attention/ref.py::attention_ref and the
// chunked path of src/repro/models/attention.py).  This kernel is the
// gradient of K1 (flash_attention.cu) from what K1's forward keeps: q, k, v,
// o and each row's log-sum-exp lse.  With s = cap(scale q k^T) (cap(x) =
// c tanh(x / c) when c > 0) and the mask of K1:
//
//   P      = exp(s - lse)                 (0 where masked)
//   delta  = rowsum(dO o)
//   dS     = P (dO v^T - delta) cap'(x)   (cap' = 1 - tanh^2, or 1)
//   dV     = P^T dO      dK = scale dS^T q      dQ = scale dS k
//
// Three launches, deterministic (no atomics; every sum in a fixed order):
//   * bwd_delta: delta in f32 from 16-byte loads of o and dO, several rows a
//     warp, and lse in log2 units (+inf for a row that sees no key, so that
//     its P is 0 without a mask), into a scratch laid out [B Hq][2][Sq
//     rounded up to 128] that the next two kernels read;
//   * bwd_dkdv_ws: dK and dV, one work item per (batch, KV head, 128-key
//     tile), which walks every query head of its GQA group in turn over the
//     query tiles that can see its keys, so the group's sums stay in
//     registers;
//   * bwd_dq_ws: dQ, one work item per (batch, query head, 128-row tile),
//     which walks its visible key tiles (128 keys; 64 at d=128).
// S and dP are recomputed in both (7 products instead of 5): computing them
// once would need dQ's partial sums added across blocks, which is atomics
// (an order that changes from run to run) or an ordered hand-over that
// stalls under the GQA walk.  P and dS never reach device memory.
//
// Bound on an H100: operations.  At llama3-1b's training shape (B=4, 32
// query heads, 8 KV heads, S=2048, d=64, causal) the five products of the
// gradient (S, dP, dV, dK, dQ) over the causal half are 171.9 GFLOP: 0.174
// ms at 989 TFLOP/s; the seven this design runs are 240.6 GFLOP, 0.243 ms;
// about 170 MB of q, k, v, o, dO, lse, dq, dk and dv take 0.051 ms at 3.35
// TB/s.  What the bf16 design does about that bound:
//   * both bf16 kernels are persistent (one block an SM) and
//     warp-specialised as K1's forward: a producer warpgroup gives most of
//     its registers to two consumer warpgroups (setmaxnreg), and one of its
//     threads streams tiles with TMA (4-D tensor maps that read the strided
//     [B, S, H, D] layout in place; 1-D bulk copies for lse and delta)
//     through a ring of shared-memory stages with full and empty mbarriers,
//     so loads run under the products;
//   * the two consumers take turns at the tensor cores (named barriers):
//     a turn issues the previous step's gradient products and this step's
//     S and dP, so that one consumer's exponentials run under the other's
//     products;
//   * every product is a wgmma with f32 sums: S^T = K Q^T and dP^T = V dO^T
//     (dK/dV), S = Q K^T and dP = dO V^T (dQ) with both operands K-major
//     in shared memory; dV += P^T dO, dK += dS^T Q and dQ += dS K with the
//     A operand from registers (the accumulator of S or dP, repacked to
//     bf16: a 16-column slice of an accumulator is the A fragment of that
//     slice) and B MN-major in shared memory (the transpose bit, no
//     transposing copy).  Tiles are stored as TMA writes them, with the
//     128-byte swizzle (64-byte at d=32), each on a 1024-byte boundary;
//   * a dK/dV item's two consumers hold 64 keys each and share every Q and
//     dO stage, so each query tile is loaded once for 128 keys; at d=128 a
//     step takes 32 query rows, so that dK and dV (128 f32 registers a
//     thread) and S^T and dP^T fit without spilling.  dQ takes 128 keys a
//     step (64 at d=128): S and dP at N = 128 read 96 bytes of shared
//     memory a cycle, where N = 64 needs all 128 the SM has;
//   * the mask is evaluated only on tiles that cross the diagonal or the
//     window's edge; masked tiles are never loaded;
//   * items are numbered longest first (the smallest key tile for dK/dV,
//     the last query tile for dQ) and dealt to the blocks in rounds that
//     alternate direction, so the causal mask's 32:1 spread of item lengths
//     does not become a tail;
//   * the producer loads an item's first stages before its K and V (dK/dV)
//     or Q and dO (dQ), so the next item's loads overlap the current one's
//     last products and its output.
// What is left (tools/trace_k1b.py): the consumers' exponentials and dS,
// 2 to 3 times their special-function floor, not the tensor cores.
// f32 (bwd_dkdv_f32, bwd_dq_f32) runs f32 FMAs, four threads a row each
// holding a quarter of the columns, loads and products in turn.
//
// A row with lse = -inf (no visible key) has every P = 0, so it gives
// exactly 0 to dQ, dK and dV, and no NaN.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../common/csrc/hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // f32: keys of a dK/dV block, rows of a dQ block
constexpr int kAuxRows = 128;  // the scratch's rows are padded to this
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr float kLog2e = 1.4426950408889634f;

struct Bwd {
  int hq, group, sq, skv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int causal, window;
  float logit_cap;
  int q_offset;
  float scale;
  const float* lse;  // [B, Hq, Sq], natural log
  // [B Hq][2][sqp]: lse in log2 units (+inf for a row with no visible key
  // and for the padding), then delta (0 in the padding)
  float* aux;
  int sqp;  // Sq rounded up to kAuxRows
};

__device__ __forceinline__ const float* lse2_row(const Bwd& p, long long bh) {
  return p.aux + bh * 2 * p.sqp;
}
__device__ __forceinline__ const float* delta_row(const Bwd& p, long long bh) {
  return p.aux + bh * 2 * p.sqp + p.sqp;
}

__device__ __forceinline__ bool visible(const Bwd& p, int qi, int kj) {
  const int diff = qi + p.q_offset - kj;
  return qi < p.sq && kj < p.skv && (!p.causal || diff >= 0) &&
         (p.window <= 0 || diff < p.window);
}

// the score s = cap(scale r) of a raw product r, and cap's derivative
__device__ __forceinline__ float score(const Bwd& p, float r, float* dcap) {
  const float x = r * p.scale;
  if (p.logit_cap > 0.f) {
    const float t = tanhf(x / p.logit_cap);
    *dcap = 1.f - t * t;
    return p.logit_cap * t;
  }
  *dcap = 1.f;
  return x;
}

// the query rows [lo, hi) that can see some key of [k0, k0 + kKeys), lo
// rounded down to a multiple of kRound
template <int kKeys, int kRound>
__device__ __forceinline__ void query_range(const Bwd& p, int k0, int* lo,
                                            int* hi) {
  const int k_last = min(k0 + kKeys, p.skv) - 1;
  *lo = p.causal ? max(0, k0 - p.q_offset) : 0;
  *hi = p.window > 0 ? min(p.sq, k_last + p.window - p.q_offset) : p.sq;
  *lo = (*lo / kRound) * kRound;
}

// the keys [lo, hi) that some row of [q0, q0 + kRows) can see, lo rounded
// down to a multiple of kRound
template <int kRows, int kRound>
__device__ __forceinline__ void key_range(const Bwd& p, int q0, int* lo,
                                          int* hi) {
  const int q_first = q0 + p.q_offset;
  const int q_last = min(q0 + kRows, p.sq) - 1 + p.q_offset;
  *lo = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  *hi = p.causal ? min(p.skv, q_last + 1) : p.skv;
  *lo = (*lo / kRound) * kRound;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------------
// delta = rowsum(dO o) in f32, and lse in log2 units, into the scratch.
// kLanes lanes a row, each one 16-byte vector of o and of dO; the row's sum
// over its lanes by shuffles.  The grid is (batch, query head) x blocks of
// the padded rows, so the padding is written too.
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(256)
bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, Bwd p) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kLanes = D / kVec;  // 4 to 32, a power of two
  constexpr int kRows = 256 / kLanes;
  static_assert(kLanes >= 1 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0,
                "a row's lanes lie in one warp");
  const int bh = blockIdx.x;  // (batch, query head)
  const int i = blockIdx.y * kRows + threadIdx.x / kLanes;
  const int part = threadIdx.x % kLanes;
  float acc = 0.f;
  if (i < p.sq) {
    const int b = bh / p.hq, h = bh % p.hq;
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * p.os.b + h * p.os.h + i * p.os.s + part * kVec);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        dout + b * p.dos.b + h * p.dos.h + i * p.dos.s + part * kVec);
    const T* oe = reinterpret_cast<const T*>(&ov);
    const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc += to_f32(oe[e]) * to_f32(de[e]);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0) {
    float* row = p.aux + static_cast<long long>(bh) * 2 * p.sqp;
    const float lse =
        i < p.sq ? p.lse[static_cast<long long>(bh) * p.sq + i] : -INFINITY;
    row[i] = lse == -INFINITY ? INFINITY : lse * kLog2e;
    row[p.sqp + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA, wgmma and warp specialisation (see the header).  Both kernels
// run 384 threads: warpgroup 0 the producer (one thread issues every copy),
// warpgroups 1 and 2 the consumers.  A consumer's accumulators are in
// wgmma's layout: warp w holds rows 16w .. 16w + 15, lane l rows l/4 and
// l/4 + 8 and columns 2(l%4) + 8j and the one after (register 4j + 2hf +
// e: row l/4 + 8hf, column 8j + 2(l%4) + e).
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;  // rows of a consumer's accumulators
constexpr int kBarTurn = 1;  // named barriers 1, 2: whose turn at wgmma

// what both warp-specialised kernels share: 384 threads, the registers
// given from the producer to the consumers (384 threads at 168 each fill
// the SM), and the swizzled column blocks of their tiles
template <int D>
struct WsTiles {
  static constexpr int kConsumers = 2;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static constexpr int kCols = D < 64 ? D : 64;  // columns of a swizzled block
  static constexpr int kRowBytes = kCols * 2;    // one row of a block
  static constexpr int kLayout = kCols == 64 ? 1 : 2;  // wgmma: 128 or 64 B
  static constexpr uint32_t kSbo = 8 * kRowBytes;      // 8 rows of a block
};

template <int D>
struct DkdvTiles : WsTiles<D> {
  static constexpr int kKeys = kWgRows * 2;         // keys of an item
  static constexpr int kRowsQ = D == 128 ? 32 : 64;  // query rows a step
  static constexpr int kStages = 4;
  static constexpr int kKVBytes = kKeys * D * 2;  // K or V of an item
  static constexpr int kQBytes = kRowsQ * D * 2;  // Q or dO of a step
  static constexpr int kLDBytes = kRowsQ * 4;     // lse or delta of a step
  static constexpr int kBarBytes = 8 * (2 + 2 * kStages);
  static constexpr int kSmem = 2 * kKVBytes +
                               kStages * (2 * kQBytes + 2 * kLDBytes) +
                               kBarBytes + 1024;
  static_assert(kSmem <= 232448, "at most 227 KB of shared memory a block");
};

template <int D>
struct DqTiles : WsTiles<D> {
  static constexpr int kRows = kWgRows * 2;           // query rows of an item
  static constexpr int kKeys = D == 128 ? 64 : 128;  // keys a step
  static constexpr int kStages = D == 128 ? 3 : 4;
  static constexpr int kQBytes = kRows * D * 2;   // Q or dO of an item
  static constexpr int kKVBytes = kKeys * D * 2;  // K or V of a step
  static constexpr int kBarBytes = 8 * (2 + 2 * kStages);
  static constexpr int kSmem =
      2 * kQBytes + 2 * kStages * kKVBytes + kBarBytes + 1024;
  static_assert(kSmem <= 232448, "at most 227 KB of shared memory a block");
};

// D[64 x N] (+)= A[64 x 16] B[N x 16]^T (both K-major in shared memory)
// and D[64 x N] += A[64 x 16] B[16 x N] (A from registers, B MN-major),
// for N in {32, 64, 128}
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int accumulate) {
  static_assert(N == 32 || N == 64 || N == 128, "N is 32, 64 or 128");
  if constexpr (N == 32) {
    wgmma_ss_n32(d, da, db, accumulate);
  } else if constexpr (N == 64) {
    wgmma_ss_n64(d, da, db, accumulate);
  } else {
    wgmma_ss_n128(d, da, db, accumulate);
  }
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 128, "N is 32, 64 or 128");
  if constexpr (N == 32) {
    wgmma_rs_n32(d, a, db);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

// the r-th work item of this block: rounds alternate direction, so that
// the longest items (numbered first) are spread over the blocks
__device__ __forceinline__ int zigzag(int r) {
  return r * static_cast<int>(gridDim.x) +
         ((r & 1) ? static_cast<int>(gridDim.x - 1 - blockIdx.x)
                  : static_cast<int>(blockIdx.x));
}

// the 16-column slices of an accumulator as A fragments
template <int N>
__device__ __forceinline__ void to_frags(uint32_t (&f)[N / 16][4],
                                         const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    f[kk][0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
    f[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    f[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    f[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// a consumer's 64 x D f32 accumulator, times `scale`, as bf16 into rows
// [r0, r0 + 64) of a strided [S, D] slice; rows at or past `limit` skipped
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride,
                                           int r0, int limit,
                                           const float (&acc)[D / 2],
                                           float scale) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + warp * 16 + g + 8 * hf;
    if (r >= limit) continue;
    bf16* row = base + r * row_stride;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
      *reinterpret_cast<uint32_t*>(row + jd * 8 + 2 * t4) =
          pack_bf16(acc[4 * jd + 2 * hf] * scale,
                    acc[4 * jd + 2 * hf + 1] * scale);
  }
}

// one dK/dV work item: 128 keys from k0 of one (batch, KV head); the query
// tiles [lo, lo + nq kRowsQ) that can see them, walked for each query head
// of the group in turn (group nq steps)
struct KvItem {
  int b, hk, k0, lo, nq;
};

template <int kKeys, int kRowsQ>
__device__ __forceinline__ KvItem kv_item(const Bwd& p, int w, int n_bhk) {
  const int hkv = p.hq / p.group;
  const int bh = w % n_bhk;
  KvItem x;
  x.b = bh / hkv;
  x.hk = bh % hkv;
  x.k0 = (w / n_bhk) * kKeys;  // the smallest keys, which most rows see, first
  int hi;
  query_range<kKeys, kRowsQ>(p, x.k0, &x.lo, &hi);
  x.nq = hi > x.lo ? (hi - x.lo + kRowsQ - 1) / kRowsQ : 0;
  return x;
}

template <int D>
__global__ void __launch_bounds__(DkdvTiles<D>::kThreads, 1)
bwd_dkdv_ws(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tdo,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, bf16* __restrict__ dk,
            bf16* __restrict__ dv, Bwd p, int n_bhk, int n_work) {
  static_assert(D == 32 || D == 64 || D == 128, "head_dim 32, 64 or 128");
  using T = DkdvTiles<D>;
  constexpr int kS = T::kStages, kC = T::kConsumers, kKeys = T::kKeys,
                kRowsQ = T::kRowsQ, kCols = T::kCols, kRowBytes = T::kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + T::kKVBytes;
  const uint32_t sQ = sV + T::kKVBytes;        // stage st at + st * kQBytes
  const uint32_t sDO = sQ + kS * T::kQBytes;   // likewise
  const uint32_t sLD = sDO + kS * T::kQBytes;  // st: lse at + 2 st kLDBytes,
                                               // delta kLDBytes after it
  const uint32_t bar_kvf = sLD + kS * 2 * T::kLDBytes;  // K, V have landed
  const uint32_t bar_kve = bar_kvf + 8;  // the consumers are done with K, V
  const uint32_t bar_f = bar_kve + 8;    // + 8 st: stage st has landed
  const uint32_t bar_e = bar_f + 8 * kS;  // + 8 st: stage st is free
  const float* ld_base =
      reinterpret_cast<const float*>(smem_raw + (sLD - raw));

  if (threadIdx.x == 0) {
    mbar_init(bar_kvf, 1);
    mbar_init(bar_kve, kC * 128);
    for (int st = 0; st < kS; ++st) {
      mbar_init(bar_f + 8 * st, 1);
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
      int it = 0, j = 0;  // steps and work items of this block so far
      for (int r = 0;; ++r, ++j) {
        const int w = zigzag(r);
        if (w >= n_work) break;
        const KvItem x = kv_item<kKeys, kRowsQ>(p, w, n_bhk);
        const int n = p.group * x.nq;
        // step i of the item: Q, dO, lse and delta of one query tile
        auto load_step = [&](int i) {
          const int cur = it + i, st = cur % kS;
          mbar_wait(bar_e + 8 * st, ((cur / kS) & 1) ^ 1);  // stage free
          const int h = x.hk * p.group + i / x.nq;
          const int q0 = x.lo + (i % x.nq) * kRowsQ;
          const uint32_t full = bar_f + 8 * st;
          mbar_expect_tx(full, 2 * T::kQBytes + 2 * T::kLDBytes);
          for (int cb = 0; cb < D / kCols; ++cb) {
            tma_load(sQ + st * T::kQBytes + cb * kRowsQ * kRowBytes, &tq, full,
                     cb * kCols, q0, h, x.b);
            tma_load(sDO + st * T::kQBytes + cb * kRowsQ * kRowBytes, &tdo,
                     full, cb * kCols, q0, h, x.b);
          }
          const long long bh = static_cast<long long>(x.b) * p.hq + h;
          const uint32_t ld = sLD + st * 2 * T::kLDBytes;
          bulk_load(ld, lse2_row(p, bh) + q0, T::kLDBytes, full);
          bulk_load(ld + T::kLDBytes, delta_row(p, bh) + q0, T::kLDBytes,
                    full);
        };
        const int pre = n < kS ? n : kS;
        for (int i = 0; i < pre; ++i) load_step(i);
        mbar_wait(bar_kve, (j & 1) ^ 1);  // the consumers are done with K, V
        mbar_expect_tx(bar_kvf, 2 * T::kKVBytes);
        for (int cb = 0; cb < D / kCols; ++cb) {
          tma_load(sK + cb * kKeys * kRowBytes, &tk, bar_kvf, cb * kCols,
                   x.k0, x.hk, x.b);
          tma_load(sV + cb * kKeys * kRowBytes, &tv, bar_kvf, cb * kCols,
                   x.k0, x.hk, x.b);
        }
        for (int i = pre; i < n; ++i) load_step(i);
        it += n;
      }
    }
    return;
  }

  // ---- consumers: 64 keys each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kConsumerRegs));
  const int c = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, t4 = lane % 4;
  const float scale_log2 = p.scale * kLog2e;

  // this consumer's keys of K and V (A, K-major); a stage's Q and dO as the
  // K-major B of S^T and dP^T (16 columns deep at column `col`) and as the
  // MN-major B of dK and dV (16 query rows deep at row 16 kk)
  auto kv_desc = [&](uint32_t tile, int col) {
    return smem_desc(tile + (col / kCols) * kKeys * kRowBytes +
                         c * kWgRows * kRowBytes + (col % kCols) * 2,
                     16, T::kSbo, T::kLayout);
  };
  auto kmajor = [&](uint32_t tile, int col) {
    return smem_desc(tile + (col / kCols) * kRowsQ * kRowBytes +
                         (col % kCols) * 2,
                     16, T::kSbo, T::kLayout);
  };
  auto mnmajor = [&](uint32_t tile, int kk) {
    return smem_desc(tile + kk * 16 * kRowBytes, kRowsQ * kRowBytes, T::kSbo,
                     T::kLayout);
  };

  float s[kRowsQ / 2], dp[kRowsQ / 2], dc[kRowsQ / 2], dk_acc[D / 2],
      dv_acc[D / 2];
  uint32_t pf[kRowsQ / 16][4] = {}, df[kRowsQ / 16][4] = {};
#pragma unroll
  for (int e = 0; e < kRowsQ / 2; ++e) s[e] = dp[e] = dc[e] = 0.f;

  // S^T = K Q^T and dP^T = V dO^T of the query tile in stage st, two commit
  // groups; dV += P^T dO and dK += dS^T Q of the tile in stage st, one
  auto issue_scores = [&](int st) {
    const uint32_t tq_st = sQ + st * T::kQBytes, tdo_st = sDO + st * T::kQBytes;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_ss<kRowsQ>(s, kv_desc(sK, ks * 16), kmajor(tq_st, ks * 16), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_ss<kRowsQ>(dp, kv_desc(sV, ks * 16), kmajor(tdo_st, ks * 16),
                     ks > 0);
    wgmma_commit();
  };
  auto issue_grads = [&](int st) {
    const uint32_t tq_st = sQ + st * T::kQBytes, tdo_st = sDO + st * T::kQBytes;
#pragma unroll
    for (int kk = 0; kk < kRowsQ / 16; ++kk)
      mma_rs<D>(dv_acc, pf[kk], mnmajor(tdo_st, kk));
#pragma unroll
    for (int kk = 0; kk < kRowsQ / 16; ++kk)
      mma_rs<D>(dk_acc, df[kk], mnmajor(tq_st, kk));
    wgmma_commit();
  };
  // The consumers take turns at the tensor cores, in order: consumer c
  // waits on named barrier kBarTurn + c before it issues products and
  // hands over to the other after them.  A turn issues the previous step's
  // dV and dK and this step's S^T and dP^T, so that one consumer's
  // exponentials run under the other's products.  Consumer 0 goes first,
  // and takes one more turn at the end to match the last consumer's last
  // hand-over; an item of n > 0 steps takes n + 1 turns of each consumer.
  const int next = kBarTurn + (c + 1) % kC;
  auto take_turn = [&]() {
    named_sync(kBarTurn + c, 256);
    wgmma_fence();
  };
  auto pass_turn = [&]() { named_arrive(next, 256); };

  if (c == kC - 1) named_arrive(kBarTurn, 256);
  int it = 0, j = 0;
  for (int r = 0;; ++r, ++j) {
    const int w = zigzag(r);
    if (w >= n_work) break;
    const KvItem x = kv_item<kKeys, kRowsQ>(p, w, n_bhk);
    const int n = p.group * x.nq;
    const int k_first = x.k0 + c * kWgRows;  // this consumer's first key
    const int kj0 = k_first + warp * 16 + g;  // this thread's keys: + 0, + 8
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;

    // after step i's products are issued: P^T and dS^T of its query tile,
    // into pf and df for the next turn
    auto step = [&](int i) {
      const int cur = it + i, st = cur % kS;
      const int q0 = x.lo + (i % x.nq) * kRowsQ;
      wgmma_wait<1>();  // S^T, and the previous step's dK and dV, are done
      fence_regs(s);
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      fence_regs(pf);
      fence_regs(df);
      if (i > 0) mbar_arrive(bar_e + 8 * ((cur - 1) % kS));

      // P^T = exp(s - lse); the columns are queries, their lse in the stage
      const float* lse = ld_base + st * 2 * kRowsQ;
      const float* delta = lse + kRowsQ;
      float unit = scale_log2;  // s * unit is in log2 units
      if (p.logit_cap > 0.f) {
#pragma unroll
        for (int e = 0; e < kRowsQ / 2; ++e) {
          const float th = tanhf(s[e] * p.scale / p.logit_cap);
          dc[e] = 1.f - th * th;
          s[e] = p.logit_cap * th * kLog2e;
        }
        unit = 1.f;
      }
#pragma unroll
      for (int e = 0; e < kRowsQ / 2; ++e) {
        const int ql = (e >> 2) * 8 + 2 * t4 + (e & 1);
        s[e] = fast_exp2(fmaf(s[e], unit, -lse[ql]));  // lse +inf: 0
      }
      // the mask only on tiles that cross its edge for some pair
      const bool interior =
          (!p.causal || q0 + p.q_offset >= k_first + kWgRows - 1) &&
          (p.window <= 0 || q0 + kRowsQ - 1 + p.q_offset - k_first < p.window);
      if (!interior) {
#pragma unroll
        for (int e = 0; e < kRowsQ / 2; ++e) {
          const int ql = (e >> 2) * 8 + 2 * t4 + (e & 1);
          if (!visible(p, q0 + ql, kj0 + 8 * ((e >> 1) & 1))) s[e] = 0.f;
        }
      }
      to_frags<kRowsQ>(pf, s);
      wgmma_wait<0>();  // dP^T is done
      fence_regs(dp);
      if (i == n - 1) mbar_arrive(bar_kve);  // done with K and V
      // dS^T = P^T (dP^T - delta) cap'
#pragma unroll
      for (int e = 0; e < kRowsQ / 2; ++e) {
        const int ql = (e >> 2) * 8 + 2 * t4 + (e & 1);
        dp[e] = s[e] * (dp[e] - delta[ql]);
      }
      if (p.logit_cap > 0.f) {
#pragma unroll
        for (int e = 0; e < kRowsQ / 2; ++e) dp[e] *= dc[e];
      }
      to_frags<kRowsQ>(df, dp);
    };

    mbar_wait(bar_kvf, j & 1);  // K and V of this item have landed
    if (n == 0) mbar_arrive(bar_kve);
    if (n > 0) {
      mbar_wait(bar_f + 8 * (it % kS), (it / kS) & 1);  // step 0 has landed
      take_turn();
      issue_scores(it % kS);
      pass_turn();
      step(0);
      for (int i = 1; i < n; ++i) {
        const int cur = it + i;
        mbar_wait(bar_f + 8 * (cur % kS), (cur / kS) & 1);
        take_turn();
        issue_grads((cur - 1) % kS);
        issue_scores(cur % kS);
        pass_turn();
        step(i);
      }
      const int last = it + n - 1;
      take_turn();
      issue_grads(last % kS);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      fence_regs(pf);
      fence_regs(df);
      mbar_arrive(bar_e + 8 * (last % kS));
    }
    it += n;
    // dK and dV summed over the group: scaled and written once
    store_rows<D>(dk + x.b * p.dks.b + x.hk * p.dks.h, p.dks.s, k_first,
                  p.skv, dk_acc, p.scale);
    store_rows<D>(dv + x.b * p.dvs.b + x.hk * p.dvs.h, p.dvs.s, k_first,
                  p.skv, dv_acc, 1.f);
  }
  if (c == 0) named_sync(kBarTurn, 256);  // the last consumer's hand-over
}

// one dQ work item: 128 query rows from q0 of one (batch, query head), and
// the 64-key tiles [lo, lo + n 64) that they can see
struct QItem {
  int b, h, hk, q0, lo, n;
};

template <int kRows, int kKeys>
__device__ __forceinline__ QItem q_item(const Bwd& p, int w, int n_bh,
                                        int n_q_tiles) {
  QItem x;
  const int bh = w % n_bh;
  x.b = bh / p.hq;
  x.h = bh % p.hq;
  x.hk = x.h / p.group;
  x.q0 = (n_q_tiles - 1 - w / n_bh) * kRows;  // the rows seeing most, first
  int hi;
  key_range<kRows, kKeys>(p, x.q0, &x.lo, &hi);
  x.n = hi > x.lo ? (hi - x.lo + kKeys - 1) / kKeys : 0;
  return x;
}

template <int D>
__global__ void __launch_bounds__(DqTiles<D>::kThreads, 1)
bwd_dq_ws(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tdo,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, bf16* __restrict__ dq,
          Bwd p, int n_bh, int n_q_tiles) {
  static_assert(D == 32 || D == 64 || D == 128, "head_dim 32, 64 or 128");
  using T = DqTiles<D>;
  constexpr int kS = T::kStages, kC = T::kConsumers, kRows = T::kRows,
                kKeys = T::kKeys, kCols = T::kCols, kRowBytes = T::kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sDO = sQ + T::kQBytes;
  const uint32_t sK = sDO + T::kQBytes;        // stage st at + st * kKVBytes
  const uint32_t sV = sK + kS * T::kKVBytes;   // likewise
  const uint32_t bar_qf = sV + kS * T::kKVBytes;  // Q, dO have landed
  const uint32_t bar_qe = bar_qf + 8;  // the consumers are done with Q, dO
  const uint32_t bar_f = bar_qe + 8;   // + 8 st: stage st has landed
  const uint32_t bar_e = bar_f + 8 * kS;  // + 8 st: stage st is free
  const int n_work = n_bh * n_q_tiles;

  if (threadIdx.x == 0) {
    mbar_init(bar_qf, 1);
    mbar_init(bar_qe, kC * 128);
    for (int st = 0; st < kS; ++st) {
      mbar_init(bar_f + 8 * st, 1);
      mbar_init(bar_e + 8 * st, kC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(T::kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0, j = 0;  // key tiles and work items of this block so far
      for (int r = 0;; ++r, ++j) {
        const int w = zigzag(r);
        if (w >= n_work) break;
        const QItem x = q_item<kRows, kKeys>(p, w, n_bh, n_q_tiles);
        auto load_step = [&](int i) {
          const int cur = it + i, st = cur % kS;
          mbar_wait(bar_e + 8 * st, ((cur / kS) & 1) ^ 1);  // stage free
          const uint32_t full = bar_f + 8 * st;
          const int k0 = x.lo + i * kKeys;
          mbar_expect_tx(full, 2 * T::kKVBytes);
          for (int cb = 0; cb < D / kCols; ++cb) {
            tma_load(sK + st * T::kKVBytes + cb * kKeys * kRowBytes, &tk, full,
                     cb * kCols, k0, x.hk, x.b);
            tma_load(sV + st * T::kKVBytes + cb * kKeys * kRowBytes, &tv, full,
                     cb * kCols, k0, x.hk, x.b);
          }
        };
        const int pre = x.n < kS ? x.n : kS;
        for (int i = 0; i < pre; ++i) load_step(i);
        mbar_wait(bar_qe, (j & 1) ^ 1);  // the consumers are done with Q, dO
        mbar_expect_tx(bar_qf, 2 * T::kQBytes);
        for (int cb = 0; cb < D / kCols; ++cb) {
          tma_load(sQ + cb * kRows * kRowBytes, &tq, bar_qf, cb * kCols, x.q0,
                   x.h, x.b);
          tma_load(sDO + cb * kRows * kRowBytes, &tdo, bar_qf, cb * kCols,
                   x.q0, x.h, x.b);
        }
        for (int i = pre; i < x.n; ++i) load_step(i);
        it += x.n;
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kConsumerRegs));
  const int c = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, t4 = lane % 4;
  const float scale_log2 = p.scale * kLog2e;

  // this consumer's rows of Q and dO (A, K-major); a stage's K and V as the
  // K-major B of S and dP, and K as the MN-major B of dQ (16 keys deep at
  // key 16 kk)
  auto q_desc = [&](uint32_t tile, int col) {
    return smem_desc(tile + (col / kCols) * kRows * kRowBytes +
                         c * kWgRows * kRowBytes + (col % kCols) * 2,
                     16, T::kSbo, T::kLayout);
  };
  auto kmajor = [&](uint32_t tile, int col) {
    return smem_desc(tile + (col / kCols) * kKeys * kRowBytes +
                         (col % kCols) * 2,
                     16, T::kSbo, T::kLayout);
  };
  auto mnmajor = [&](uint32_t tile, int kk) {
    return smem_desc(tile + kk * 16 * kRowBytes, kKeys * kRowBytes, T::kSbo,
                     T::kLayout);
  };

  float s[kKeys / 2], dp[kKeys / 2], dq_acc[D / 2];
  uint32_t df[kKeys / 16][4] = {};
#pragma unroll
  for (int e = 0; e < kKeys / 2; ++e) s[e] = dp[e] = 0.f;

  // S = Q K^T and dP = dO V^T of the key tile in stage st, two commit
  // groups; dQ += dS K of the tile in stage st, one
  auto issue_scores = [&](int st) {
    const uint32_t tk_st = sK + st * T::kKVBytes, tv_st = sV + st * T::kKVBytes;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_ss<kKeys>(s, q_desc(sQ, ks * 16), kmajor(tk_st, ks * 16), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_ss<kKeys>(dp, q_desc(sDO, ks * 16), kmajor(tv_st, ks * 16), ks > 0);
    wgmma_commit();
  };
  auto issue_grads = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      mma_rs<D>(dq_acc, df[kk], mnmajor(sK + st * T::kKVBytes, kk));
    wgmma_commit();
  };
  // turns at the tensor cores as in bwd_dkdv_ws: a turn issues the previous
  // tile's dQ and this tile's S and dP
  const int next = kBarTurn + (c + 1) % kC;
  auto take_turn = [&]() {
    named_sync(kBarTurn + c, 256);
    wgmma_fence();
  };
  auto pass_turn = [&]() { named_arrive(next, 256); };

  if (c == kC - 1) named_arrive(kBarTurn, 256);
  int it = 0, j = 0;
  for (int r = 0;; ++r, ++j) {
    const int w = zigzag(r);
    if (w >= n_work) break;
    const QItem x = q_item<kRows, kKeys>(p, w, n_bh, n_q_tiles);
    const int wg_first = x.q0 + c * kWgRows;  // this consumer's first row
    const int r0 = wg_first + warp * 16 + g;  // this thread's rows: + 0, + 8
    const long long bh = static_cast<long long>(x.b) * p.hq + x.h;
    // lse and delta of this thread's two rows (the scratch is padded)
    const float lse[2] = {lse2_row(p, bh)[r0], lse2_row(p, bh)[r0 + 8]};
    const float delta[2] = {delta_row(p, bh)[r0], delta_row(p, bh)[r0 + 8]};
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dq_acc[e] = 0.f;

    // after key tile i's products are issued: dS into df for the next turn
    auto step = [&](int i) {
      const int cur = it + i;
      const int k0 = x.lo + i * kKeys;
      wgmma_wait<1>();  // S, and the previous tile's dQ, are done
      fence_regs(s);
      fence_regs(dq_acc);
      fence_regs(df);
      if (i > 0) mbar_arrive(bar_e + 8 * ((cur - 1) % kS));

      // without a cap P = exp(s - lse) runs under dP; with one, P and the
      // cap's derivative are formed once dP is in (no registers for
      // cap' across the wait).  Masked pairs are zeroed in dS.
      if (p.logit_cap <= 0.f) {
#pragma unroll
        for (int e = 0; e < kKeys / 2; ++e)
          s[e] = fast_exp2(fmaf(s[e], scale_log2, -lse[(e >> 1) & 1]));
      }
      wgmma_wait<0>();  // dP is done
      fence_regs(dp);
      if (i == x.n - 1) mbar_arrive(bar_qe);  // done with Q and dO
      if (p.logit_cap > 0.f) {
#pragma unroll
        for (int e = 0; e < kKeys / 2; ++e) {
          const float th = tanhf(s[e] * p.scale / p.logit_cap);
          const float pe =
              fast_exp2(fmaf(p.logit_cap * kLog2e, th, -lse[(e >> 1) & 1]));
          dp[e] = pe * (dp[e] - delta[(e >> 1) & 1]) * (1.f - th * th);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kKeys / 2; ++e)
          dp[e] = s[e] * (dp[e] - delta[(e >> 1) & 1]);
      }
      const bool interior =
          k0 + kKeys <= p.skv &&
          (!p.causal || k0 + kKeys - 1 <= wg_first + p.q_offset) &&
          (p.window <= 0 || wg_first + kWgRows - 1 + p.q_offset - k0 < p.window);
      if (!interior) {
#pragma unroll
        for (int e = 0; e < kKeys / 2; ++e) {
          const int kj = k0 + (e >> 2) * 8 + 2 * t4 + (e & 1);
          if (!visible(p, r0 + 8 * ((e >> 1) & 1), kj)) dp[e] = 0.f;
        }
      }
      to_frags<kKeys>(df, dp);
    };

    mbar_wait(bar_qf, j & 1);  // Q and dO of this item have landed
    if (x.n == 0) mbar_arrive(bar_qe);
    if (x.n > 0) {
      mbar_wait(bar_f + 8 * (it % kS), (it / kS) & 1);  // tile 0 has landed
      take_turn();
      issue_scores(it % kS);
      pass_turn();
      step(0);
      for (int i = 1; i < x.n; ++i) {
        const int cur = it + i;
        mbar_wait(bar_f + 8 * (cur % kS), (cur / kS) & 1);
        take_turn();
        issue_grads((cur - 1) % kS);
        issue_scores(cur % kS);
        pass_turn();
        step(i);
      }
      const int last = it + x.n - 1;
      take_turn();
      issue_grads(last % kS);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(dq_acc);
      fence_regs(df);
      mbar_arrive(bar_e + 8 * (last % kS));
    }
    it += x.n;
    store_rows<D>(dq + x.b * p.dqs.b + x.h * p.dqs.h, p.dqs.s, wg_first, p.sq,
                  dq_acc, p.scale);
  }
  if (c == 0) named_sync(kBarTurn, 256);  // the last consumer's hand-over
}

// ---------------------------------------------------------------------------
// f32: FMAs.  Four neighbouring threads share a row (a key in bwd_dkdv_f32,
// a query in bwd_dq_f32); thread j of the four holds columns j, j + 4, ...
// of it in registers, and the row's dot products are summed over the four
// with two shuffles.  The other side's rows stream through shared memory,
// kRowsF32 at a time.
// ---------------------------------------------------------------------------

constexpr int kThreadsF32 = 256;  // 64 rows x 4 threads
constexpr int kRowsF32 = 32;

template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long row_stride, int r0,
                                              int limit) {
  constexpr int kVecs = D / 4;
  for (int i = threadIdx.x; i < kRowsF32 * kVecs; i += kThreadsF32) {
    const int r = i / kVecs, c = (i % kVecs) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < limit)
      val = *reinterpret_cast<const float4*>(src + (r0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * D + c) = val;
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreadsF32)
bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             float* __restrict__ dk, float* __restrict__ dv, Bwd p) {
  constexpr int kC = D / 4;
  __shared__ __align__(16) float sQ[kRowsF32 * D];
  __shared__ __align__(16) float sDO[kRowsF32 * D];
  __shared__ float sL[kRowsF32], sD[kRowsF32];
  const int hkv = p.hq / p.group;
  const int b = blockIdx.y / hkv, hk = blockIdx.y % hkv;
  const int k0 = blockIdx.x * kTile;
  const int kj = k0 + threadIdx.x / 4, j0 = threadIdx.x % 4;
  float kr[kC], vr[kC], dka[kC], dva[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    kr[c] = kj < p.skv ? k[b * p.ks.b + hk * p.ks.h + kj * p.ks.s + 4 * c + j0]
                       : 0.f;
    vr[c] = kj < p.skv ? v[b * p.vs.b + hk * p.vs.h + kj * p.vs.s + 4 * c + j0]
                       : 0.f;
    dka[c] = dva[c] = 0.f;
  }
  int q_lo, q_hi;
  query_range<kTile, kTile>(p, k0, &q_lo, &q_hi);
  for (int gi = 0; gi < p.group; ++gi) {
    const int h = hk * p.group + gi;
    const long long bh = static_cast<long long>(b) * p.hq + h;
    const long long row0 = bh * p.sq;
    for (int q0 = q_lo; q0 < q_hi; q0 += kRowsF32) {
      __syncthreads();
      load_rows_f32<D>(sQ, q + b * p.qs.b + h * p.qs.h, p.qs.s, q0, p.sq);
      load_rows_f32<D>(sDO, dout + b * p.dos.b + h * p.dos.h, p.dos.s, q0,
                       p.sq);
      if (threadIdx.x < kRowsF32) {
        const int qi = q0 + threadIdx.x;
        sL[threadIdx.x] = qi < p.sq ? p.lse[row0 + qi] : 0.f;
        sD[threadIdx.x] = qi < p.sq ? delta_row(p, bh)[qi] : 0.f;
      }
      __syncthreads();
      for (int r = 0; r < kRowsF32; ++r) {
        const float* qrow = sQ + r * D;
        const float* drow = sDO + r * D;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          s = fmaf(qrow[4 * c + j0], kr[c], s);
          dp = fmaf(drow[4 * c + j0], vr[c], dp);
        }
        s = quad_sum(s);
        dp = quad_sum(dp);
        float dcap;
        const float sc = score(p, s, &dcap);
        const float pr = visible(p, q0 + r, kj) ? expf(sc - sL[r]) : 0.f;
        const float ds = pr * (dp - sD[r]) * dcap;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          dva[c] = fmaf(pr, drow[4 * c + j0], dva[c]);
          dka[c] = fmaf(ds, qrow[4 * c + j0], dka[c]);
        }
      }
    }
  }
  if (kj < p.skv) {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      dk[b * p.dks.b + hk * p.dks.h + kj * p.dks.s + 4 * c + j0] =
          dka[c] * p.scale;
      dv[b * p.dvs.b + hk * p.dvs.h + kj * p.dvs.s + 4 * c + j0] = dva[c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsF32)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           float* __restrict__ dq, Bwd p) {
  constexpr int kC = D / 4;
  __shared__ __align__(16) float sK[kRowsF32 * D];
  __shared__ __align__(16) float sV[kRowsF32 * D];
  const int b = blockIdx.y / p.hq, h = blockIdx.y % p.hq, hk = h / p.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int qi = q0 + threadIdx.x / 4, j0 = threadIdx.x % 4;
  const long long bh = static_cast<long long>(b) * p.hq + h;
  const long long row0 = bh * p.sq;
  float qr[kC], dor[kC], dqa[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    qr[c] = qi < p.sq ? q[b * p.qs.b + h * p.qs.h + qi * p.qs.s + 4 * c + j0]
                      : 0.f;
    dor[c] = qi < p.sq
                 ? dout[b * p.dos.b + h * p.dos.h + qi * p.dos.s + 4 * c + j0]
                 : 0.f;
    dqa[c] = 0.f;
  }
  const float lse = qi < p.sq ? p.lse[row0 + qi] : 0.f;
  const float delta = qi < p.sq ? delta_row(p, bh)[qi] : 0.f;
  int kv_lo, kv_hi;
  key_range<kTile, kRowsF32>(p, q0, &kv_lo, &kv_hi);
  for (int k0 = kv_lo; k0 < kv_hi; k0 += kRowsF32) {
    __syncthreads();
    load_rows_f32<D>(sK, k + b * p.ks.b + hk * p.ks.h, p.ks.s, k0, p.skv);
    load_rows_f32<D>(sV, v + b * p.vs.b + hk * p.vs.h, p.vs.s, k0, p.skv);
    __syncthreads();
    for (int r = 0; r < kRowsF32; ++r) {
      const float* krow = sK + r * D;
      const float* vrow = sV + r * D;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        s = fmaf(qr[c], krow[4 * c + j0], s);
        dp = fmaf(dor[c], vrow[4 * c + j0], dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      float dcap;
      const float sc = score(p, s, &dcap);
      const float pr = visible(p, qi, k0 + r) ? expf(sc - lse) : 0.f;
      const float ds = pr * (dp - delta) * dcap;
#pragma unroll
      for (int c = 0; c < kC; ++c) dqa[c] = fmaf(ds, krow[4 * c + j0], dqa[c]);
    }
  }
  if (qi < p.sq) {
#pragma unroll
    for (int c = 0; c < kC; ++c)
      dq[b * p.dqs.b + h * p.dqs.h + qi * p.dqs.s + 4 * c + j0] =
          dqa[c] * p.scale;
  }
}

// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

template <int D>
cudaError_t run_bf16(const void* q, const void* k, const void* v,
                     const void* dout, void* dq, void* dk, void* dv, int b,
                     const Bwd& p, cudaStream_t stream) {
  using TK = DkdvTiles<D>;
  using TQ = DqTiles<D>;
  const int hkv = p.hq / p.group;
  const CUtensorMapSwizzle swizzle = TK::kCols == 64
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  constexpr int kC = TK::kCols;
  // dK/dV: Q and dO by steps of kRowsQ rows, K and V by items of 128 keys;
  // dQ: Q and dO by items of 128 rows, K and V by steps of 64 keys
  CUtensorMap kq, kdo, kk, kv, qq, qdo, qk, qv;
  if (!tensor_map(&kq, q, D, p.sq, p.hq, b, p.qs, kC, TK::kRowsQ, swizzle) ||
      !tensor_map(&kdo, dout, D, p.sq, p.hq, b, p.dos, kC, TK::kRowsQ,
                  swizzle) ||
      !tensor_map(&kk, k, D, p.skv, hkv, b, p.ks, kC, TK::kKeys, swizzle) ||
      !tensor_map(&kv, v, D, p.skv, hkv, b, p.vs, kC, TK::kKeys, swizzle) ||
      !tensor_map(&qq, q, D, p.sq, p.hq, b, p.qs, kC, TQ::kRows, swizzle) ||
      !tensor_map(&qdo, dout, D, p.sq, p.hq, b, p.dos, kC, TQ::kRows,
                  swizzle) ||
      !tensor_map(&qk, k, D, p.skv, hkv, b, p.ks, kC, TQ::kKeys, swizzle) ||
      !tensor_map(&qv, v, D, p.skv, hkv, b, p.vs, kC, TQ::kKeys, swizzle))
    return cudaErrorInvalidValue;
  const long long n_bhk = static_cast<long long>(b) * hkv;
  const long long kv_work = n_bhk * ((p.skv + TK::kKeys - 1) / TK::kKeys);
  const long long n_bh = static_cast<long long>(b) * p.hq;
  const long long n_q_tiles = (p.sq + TQ::kRows - 1) / TQ::kRows;
  if (kv_work > 0x3fffffffLL || n_bh * n_q_tiles > 0x3fffffffLL)
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e;
  if ((e = sm_count(&sms)) != cudaSuccess ||
      (e = allow_smem(bwd_dkdv_ws<D>, TK::kSmem)) != cudaSuccess ||
      (e = allow_smem(bwd_dq_ws<D>, TQ::kSmem)) != cudaSuccess)
    return e;
  // one persistent block on each SM, or one for each work item if fewer
  const int kv_blocks = static_cast<int>(kv_work < sms ? kv_work : sms);
  bwd_dkdv_ws<D><<<kv_blocks, TK::kThreads, TK::kSmem, stream>>>(
      kq, kdo, kk, kv, static_cast<bf16*>(dk), static_cast<bf16*>(dv), p,
      static_cast<int>(n_bhk), static_cast<int>(kv_work));
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long q_work = n_bh * n_q_tiles;
  const int q_blocks = static_cast<int>(q_work < sms ? q_work : sms);
  bwd_dq_ws<D><<<q_blocks, TQ::kThreads, TQ::kSmem, stream>>>(
      qq, qdo, qk, qv, static_cast<bf16*>(dq), p, static_cast<int>(n_bh),
      static_cast<int>(n_q_tiles));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run(const void* q, const void* k, const void* v, const void* o,
                const void* dout, void* dq, void* dk, void* dv, int b,
                const Bwd& p, cudaStream_t stream) {
  // grid: (batch, query head) x the padded rows' blocks
  constexpr int kDeltaRows = 256 / (D / (16 / sizeof(T)));
  const dim3 grid(b * p.hq, p.sqp / kDeltaRows);
  if (p.sqp / kDeltaRows > 65535) return cudaErrorInvalidValue;
  bwd_delta<T, D><<<grid, 256, 0, stream>>>(static_cast<const T*>(o),
                                            static_cast<const T*>(dout), p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (sizeof(T) == 2) {
    return run_bf16<D>(q, k, v, dout, dq, dk, dv, b, p, stream);
  } else {
    if (static_cast<long long>(b) * p.hq > 65535)  // grid.y of bwd_dq_f32
      return cudaErrorInvalidValue;
    const int hkv = p.hq / p.group;
    const dim3 grid_kv((p.skv + kTile - 1) / kTile, b * hkv);
    const dim3 grid_q((p.sq + kTile - 1) / kTile, b * p.hq);
    const T* tq = static_cast<const T*>(q);
    const T* tk = static_cast<const T*>(k);
    const T* tv = static_cast<const T*>(v);
    const T* tdo = static_cast<const T*>(dout);
    bwd_dkdv_f32<D><<<grid_kv, kThreadsF32, 0, stream>>>(
        tq, tk, tv, tdo, static_cast<T*>(dk), static_cast<T*>(dv), p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    bwd_dq_f32<D><<<grid_q, kThreadsF32, 0, stream>>>(
        tq, tk, tv, tdo, static_cast<T*>(dq), p);
    return cudaGetLastError();
  }
}

template <int D>
cudaError_t dispatch_dtype(int dtype, const void* q, const void* k,
                           const void* v, const void* o, const void* dout,
                           void* dq, void* dk, void* dv, int b, const Bwd& p,
                           cudaStream_t stream) {
  if (dtype == 0)
    return run<float, D>(q, k, v, o, dout, dq, dk, dv, b, p, stream);
  if (dtype == 1)
    return run<bf16, D>(q, k, v, o, dout, dq, dk, dv, b, p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// The gradients of K1's forward.  q, o, dout, dq: [B, Hq, Sq, D]; k, v, dk,
// dv: [B, Hkv, Skv, D]; each given by its (batch, head, seq) strides in
// elements, in `strides` in that order (q, k, v, o, dout, dq, dk, dv; 24
// values), with the last dim contiguous and every stride and base 16-byte
// aligned.  lse: K1's [B, Hq, Sq] f32 log-sum-exp; delta: f32 scratch of
// B * Hq * 2 * (Sq rounded up to 128) values, 16-byte aligned.  dtype: 0 =
// float32, 1 = bfloat16, the same for every tensor but lse and delta.  d in
// {32, 64, 128}; Hq % Hkv == 0.  Launches bwd_delta, then the dK/dV and the
// dQ kernels, in that order on `stream`; returns the first launch error, or
// cudaGetLastError() after the last.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int b, int hq, int hkv, int sq, int skv, int d,
    const long long* strides, int causal, int window, float logit_cap,
    int q_offset, int dtype, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || skv <= 0 ||
      sq > 0x7fffffff - kAuxRows)
    return cudaErrorInvalidValue;
  const long long* s = strides;
  const Bwd p{hq,
              hq / hkv,
              sq,
              skv,
              {s[0], s[1], s[2]},
              {s[3], s[4], s[5]},
              {s[6], s[7], s[8]},
              {s[9], s[10], s[11]},
              {s[12], s[13], s[14]},
              {s[15], s[16], s[17]},
              {s[18], s[19], s[20]},
              {s[21], s[22], s[23]},
              causal,
              window,
              logit_cap,
              q_offset,
              1.0f / sqrtf(static_cast<float>(d)),
              lse,
              delta,
              (sq + kAuxRows - 1) / kAuxRows * kAuxRows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return dispatch_dtype<32>(dtype, q, k, v, o, dout, dq, dk, dv, b, p, st);
    case 64:
      return dispatch_dtype<64>(dtype, q, k, v, o, dout, dq, dk, dv, b, p, st);
    case 128:
      return dispatch_dtype<128>(dtype, q, k, v, o, dout, dq, dk, dv, b, p,
                                 st);
    default:
      return cudaErrorInvalidValue;
  }
}
