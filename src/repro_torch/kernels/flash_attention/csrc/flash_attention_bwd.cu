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
// Three launches: bwd_delta (one warp a row), bwd_dkdv (one block per batch,
// KV head and 64-key tile: it walks the query tiles that can see its keys,
// for every query head of the GQA group in turn, so dK and dV are summed
// over the group inside the block, without atomics and in a fixed order),
// and bwd_dq (one block per batch, query head and 64-row tile, walking its
// visible key tiles, the longest first).  P and dS never reach device
// memory.
//
// Bound on an H100: operations.  At llama3-1b's training shape (B=4, 32
// query heads, 8 KV heads, S=2048, d=64, causal) the five products (S and
// dP twice, dV, dK, dQ) are 10 S^2 d / 2 flops a head, 171.8 GFLOP: 0.174
// ms at 989 TFLOP/s, against about 170 MB of q, k, v, o, dO, lse, dq, dk
// and dv (0.051 ms at 3.35 TB/s).  This first design is simple: bf16 runs
// the products on the tensor cores with mma.sync (m16n8k16, f32 sums), the
// tiles padded by 16 bytes a row so that ldmatrix reads without bank
// conflicts, loads and products in turn; f32 runs f32 FMAs, four threads a
// row each holding a quarter of the columns.  Both recompute S and dP in
// each of the dK/dV and dQ launches (K1's forward is not redone).  wgmma
// and TMA are later work.
//
// A row with lse = -inf (no visible key) has every P = 0, so it gives
// exactly 0 to dQ, dK and dV, and no NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;      // keys of a dK/dV block, rows of a dQ block
constexpr int kThreads = 128;  // bf16: four warps, 16 keys or rows each
constexpr size_t kDefaultSmem = 48 * 1024;

struct S3 {
  long long b, h, s;  // (batch, head, seq) strides in elements
};

struct Bwd {
  int hq, group, sq, skv;
  S3 qs, ks, vs, os, dos, dqs, dks, dvs;
  int causal, window;
  float logit_cap;
  int q_offset;
  float scale;
  const float* lse;  // [B, Hq, Sq]
  float* delta;      // [B, Hq, Sq]
};

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

// the query rows [lo, hi) that can see some key of [k0, k0 + kTile)
__device__ __forceinline__ void query_range(const Bwd& p, int k0, int* lo,
                                            int* hi) {
  const int k_last = min(k0 + kTile, p.skv) - 1;
  *lo = p.causal ? max(0, k0 - p.q_offset) : 0;
  *hi = p.window > 0 ? min(p.sq, k_last + p.window - p.q_offset) : p.sq;
  *lo = (*lo / kTile) * kTile;
}

// the keys [lo, hi) that some row of [q0, q0 + kTile) can see, lo rounded
// down to a multiple of `step`
__device__ __forceinline__ void key_range(const Bwd& p, int q0, int step,
                                          int* lo, int* hi) {
  const int q_first = q0 + p.q_offset;
  const int q_last = min(q0 + kTile, p.sq) - 1 + p.q_offset;
  *lo = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  *hi = p.causal ? min(p.skv, q_last + 1) : p.skv;
  *lo = (*lo / step) * step;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------------
// delta = rowsum(dO o), one warp a row, in f32
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(256)
bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, Bwd p,
          long long rows) {
  const long long r = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int i = static_cast<int>(r % p.sq);
  const long long bh = r / p.sq;
  const int b = static_cast<int>(bh / p.hq), h = static_cast<int>(bh % p.hq);
  const T* orow = o + b * p.os.b + h * p.os.h + i * p.os.s;
  const T* drow = dout + b * p.dos.b + h * p.dos.h + i * p.dos.s;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc += to_f32(orow[c]) * to_f32(drow[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[r] = acc;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 with f32 sums
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16 x 8] += a[16 x 16] b[16 x 8]
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A shared tile: kTile rows of D bf16, each row padded by 8 elements (16
// bytes), so the eight rows an ldmatrix reads fall in distinct banks.
template <int D>
struct Tile {
  static constexpr int kStride = D + 8;
  static constexpr int kElems = kTile * kStride;
  // the A fragment (16 x 16) at rows r0.., columns c0.. of a row-major tile
  static __device__ __forceinline__ uint32_t a(const bf16* t, int r0, int c0,
                                               int lane) {
    return smem_u32(t + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                    c0 + (lane >> 4) * 8);
  }
  // B fragments of n-tiles n0 and n0 + 8 at depth k0, the tile stored as
  // [n][k] (ldmatrix without .trans)
  static __device__ __forceinline__ uint32_t b_nk(const bf16* t, int n0,
                                                  int k0, int lane) {
    return smem_u32(t + (n0 + (lane & 7) + (lane >> 4) * 8) * kStride + k0 +
                    ((lane >> 3) & 1) * 8);
  }
  // the same, the tile stored as [k][n] (ldmatrix .trans)
  static __device__ __forceinline__ uint32_t b_kn(const bf16* t, int k0,
                                                  int n0, int lane) {
    return smem_u32(t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                    n0 + (lane >> 4) * 8);
  }
};

// rows [r0, r0 + kTile) of a strided [S, D] slice into a padded tile; rows
// at or past `limit` read as 0
template <int D, int kThreadsOfBlock>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int r0,
                                          int limit) {
  constexpr int kVecs = D / 8;
  for (int i = threadIdx.x; i < kTile * kVecs; i += kThreadsOfBlock) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * Tile<D>::kStride + c) = val;
  }
}

template <int D>
constexpr size_t bf16_smem_bytes() {
  return 4 * Tile<D>::kElems * sizeof(bf16) + 2 * kTile * sizeof(float);
}

// S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys against a 64-row
// query tile, then P^T and dS^T in place of them
template <int D>
__device__ __forceinline__ void bwd_scores_kq(const Bwd& p, const bf16* sK,
                                              const bf16* sV, const bf16* sQ,
                                              const bf16* sDO,
                                              const float* sL,
                                              const float* sD, int k0, int q0,
                                              float (&s)[8][4],
                                              float (&dp)[8][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t ka[4], va[4];
    ldsm_x4(ka, Tile<D>::a(sK, warp * 16, ks * 16, lane));
    ldsm_x4(va, Tile<D>::a(sV, warp * 16, ks * 16, lane));
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      uint32_t qb[4], db[4];
      ldsm_x4(qb, Tile<D>::b_nk(sQ, n2 * 16, ks * 16, lane));
      ldsm_x4(db, Tile<D>::b_nk(sDO, n2 * 16, ks * 16, lane));
      mma(s[2 * n2], ka, qb[0], qb[1]);
      mma(s[2 * n2 + 1], ka, qb[2], qb[3]);
      mma(dp[2 * n2], va, db[0], db[1]);
      mma(dp[2 * n2 + 1], va, db[2], db[3]);
    }
  }
  // accumulator element e of n-tile nt: key row g (+8 for e >= 2), query
  // column nt * 8 + 2 t4 (+1 for odd e)
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kj = k0 + warp * 16 + g + (e >> 1) * 8;
      const int ql = nt * 8 + 2 * t4 + (e & 1);
      float dcap;
      const float sc = score(p, s[nt][e], &dcap);
      const float pr = visible(p, q0 + ql, kj) ? expf(sc - sL[ql]) : 0.f;
      s[nt][e] = pr;
      dp[nt][e] = pr * (dp[nt][e] - sD[ql]) * dcap;
    }
}

// accumulator n-tiles 2 kk and 2 kk + 1 as the A fragment of k-slice kk
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c)[8][4],
                                     int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              bf16* __restrict__ dk, bf16* __restrict__ dv, Bwd p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + Tile<D>::kElems;
  bf16* sQ = sV + Tile<D>::kElems;
  bf16* sDO = sQ + Tile<D>::kElems;
  float* sL = reinterpret_cast<float*>(sDO + Tile<D>::kElems);
  float* sD = sL + kTile;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int hkv = p.hq / p.group;
  const int b = blockIdx.y / hkv, hk = blockIdx.y % hkv;
  const int k0 = blockIdx.x * kTile;
  load_tile<D, kThreads>(sK, k + b * p.ks.b + hk * p.ks.h, p.ks.s, k0, p.skv);
  load_tile<D, kThreads>(sV, v + b * p.vs.b + hk * p.vs.h, p.vs.s, k0, p.skv);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  int q_lo, q_hi;
  query_range(p, k0, &q_lo, &q_hi);

  for (int gi = 0; gi < p.group; ++gi) {
    const int h = hk * p.group + gi;
    const long long row0 = (static_cast<long long>(b) * p.hq + h) * p.sq;
    for (int q0 = q_lo; q0 < q_hi; q0 += kTile) {
      __syncthreads();  // every warp is done with the previous Q, dO tiles
      load_tile<D, kThreads>(sQ, q + b * p.qs.b + h * p.qs.h, p.qs.s, q0,
                             p.sq);
      load_tile<D, kThreads>(sDO, dout + b * p.dos.b + h * p.dos.h, p.dos.s,
                             q0, p.sq);
      if (threadIdx.x < kTile) {
        const int qi = q0 + threadIdx.x;
        sL[threadIdx.x] = qi < p.sq ? p.lse[row0 + qi] : 0.f;
        sD[threadIdx.x] = qi < p.sq ? p.delta[row0 + qi] : 0.f;
      }
      __syncthreads();
      float s[8][4], dp[8][4];
      bwd_scores_kq<D>(p, sK, sV, sQ, sDO, sL, sD, k0, q0, s, dp);
      // dV += P^T dO and dK += dS^T Q, over the tile's 64 query rows
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4], da[4];
        to_a(pa, s, kk);
        to_a(da, dp, kk);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          uint32_t ob[4], qb[4];
          ldsm_x4_t(ob, Tile<D>::b_kn(sDO, kk * 16, n2 * 16, lane));
          ldsm_x4_t(qb, Tile<D>::b_kn(sQ, kk * 16, n2 * 16, lane));
          mma(dv_acc[2 * n2], pa, ob[0], ob[1]);
          mma(dv_acc[2 * n2 + 1], pa, ob[2], ob[3]);
          mma(dk_acc[2 * n2], da, qb[0], qb[1]);
          mma(dk_acc[2 * n2 + 1], da, qb[2], qb[3]);
        }
      }
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kj = k0 + warp * 16 + g + 8 * hf;
    if (kj >= p.skv) continue;
    bf16* dkr = dk + b * p.dks.b + hk * p.dks.h + kj * p.dks.s;
    bf16* dvr = dv + b * p.dvs.b + hk * p.dvs.h + kj * p.dvs.s;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(dkr + c) =
          pack_bf16(dk_acc[n][2 * hf] * p.scale, dk_acc[n][2 * hf + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvr + c) =
          pack_bf16(dv_acc[n][2 * hf], dv_acc[n][2 * hf + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            bf16* __restrict__ dq, Bwd p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + Tile<D>::kElems;
  bf16* sQ = sV + Tile<D>::kElems;
  bf16* sDO = sQ + Tile<D>::kElems;
  float* sL = reinterpret_cast<float*>(sDO + Tile<D>::kElems);
  float* sD = sL + kTile;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y / p.hq, h = blockIdx.y % p.hq, hk = h / p.group;
  // the query tiles that see the most keys first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const long long row0 = (static_cast<long long>(b) * p.hq + h) * p.sq;
  load_tile<D, kThreads>(sQ, q + b * p.qs.b + h * p.qs.h, p.qs.s, q0, p.sq);
  load_tile<D, kThreads>(sDO, dout + b * p.dos.b + h * p.dos.h, p.dos.s, q0,
                         p.sq);
  if (threadIdx.x < kTile) {
    const int qi = q0 + threadIdx.x;
    sL[threadIdx.x] = qi < p.sq ? p.lse[row0 + qi] : 0.f;
    sD[threadIdx.x] = qi < p.sq ? p.delta[row0 + qi] : 0.f;
  }
  float dq_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;
  int kv_lo, kv_hi;
  key_range(p, q0, kTile, &kv_lo, &kv_hi);

  for (int k0 = kv_lo; k0 < kv_hi; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous K, V tiles
    load_tile<D, kThreads>(sK, k + b * p.ks.b + hk * p.ks.h, p.ks.s, k0,
                           p.skv);
    load_tile<D, kThreads>(sV, v + b * p.vs.b + hk * p.vs.h, p.vs.s, k0,
                           p.skv);
    __syncthreads();
    // S = Q K^T and dP = dO V^T for this warp's 16 rows against 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, Tile<D>::a(sQ, warp * 16, ks * 16, lane));
      ldsm_x4(oa, Tile<D>::a(sDO, warp * 16, ks * 16, lane));
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, Tile<D>::b_nk(sK, n2 * 16, ks * 16, lane));
        ldsm_x4(vb, Tile<D>::b_nk(sV, n2 * 16, ks * 16, lane));
        mma(s[2 * n2], qa, kb[0], kb[1]);
        mma(s[2 * n2 + 1], qa, kb[2], kb[3]);
        mma(dp[2 * n2], oa, vb[0], vb[1]);
        mma(dp[2 * n2 + 1], oa, vb[2], vb[3]);
      }
    }
    // element e of n-tile nt: query row g (+8 for e >= 2), key column
    // nt * 8 + 2 t4 (+1 for odd e)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = warp * 16 + g + (e >> 1) * 8;
        const int kj = k0 + nt * 8 + 2 * t4 + (e & 1);
        float dcap;
        const float sc = score(p, s[nt][e], &dcap);
        const float pr = visible(p, q0 + ql, kj) ? expf(sc - sL[ql]) : 0.f;
        dp[nt][e] = pr * (dp[nt][e] - sD[ql]) * dcap;
      }
    // dQ += dS K over the tile's 64 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t da[4];
      to_a(da, dp, kk);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t kb[4];
        ldsm_x4_t(kb, Tile<D>::b_kn(sK, kk * 16, n2 * 16, lane));
        mma(dq_acc[2 * n2], da, kb[0], kb[1]);
        mma(dq_acc[2 * n2 + 1], da, kb[2], kb[3]);
      }
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qi = q0 + warp * 16 + g + 8 * hf;
    if (qi >= p.sq) continue;
    bf16* dqr = dq + b * p.dqs.b + h * p.dqs.h + qi * p.dqs.s;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dqr + n * 8 + 2 * t4) = pack_bf16(
          dq_acc[n][2 * hf] * p.scale, dq_acc[n][2 * hf + 1] * p.scale);
  }
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
  query_range(p, k0, &q_lo, &q_hi);
  for (int gi = 0; gi < p.group; ++gi) {
    const int h = hk * p.group + gi;
    const long long row0 = (static_cast<long long>(b) * p.hq + h) * p.sq;
    for (int q0 = q_lo; q0 < q_hi; q0 += kRowsF32) {
      __syncthreads();
      load_rows_f32<D>(sQ, q + b * p.qs.b + h * p.qs.h, p.qs.s, q0, p.sq);
      load_rows_f32<D>(sDO, dout + b * p.dos.b + h * p.dos.h, p.dos.s, q0,
                       p.sq);
      if (threadIdx.x < kRowsF32) {
        const int qi = q0 + threadIdx.x;
        sL[threadIdx.x] = qi < p.sq ? p.lse[row0 + qi] : 0.f;
        sD[threadIdx.x] = qi < p.sq ? p.delta[row0 + qi] : 0.f;
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
  const long long row0 = (static_cast<long long>(b) * p.hq + h) * p.sq;
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
  const float delta = qi < p.sq ? p.delta[row0 + qi] : 0.f;
  int kv_lo, kv_hi;
  key_range(p, q0, kRowsF32, &kv_lo, &kv_hi);
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

template <typename T, int D>
cudaError_t run(const void* q, const void* k, const void* v, const void* o,
                const void* dout, void* dq, void* dk, void* dv, int b,
                const Bwd& p, cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(b) * p.hq * p.sq;
  bwd_delta<T, D><<<static_cast<unsigned int>((rows + 7) / 8), 256, 0,
                    stream>>>(static_cast<const T*>(o), tdo, p, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int hkv = p.hq / p.group;
  const dim3 grid_kv((p.skv + kTile - 1) / kTile, b * hkv);
  const dim3 grid_q((p.sq + kTile - 1) / kTile, b * p.hq);
  if constexpr (sizeof(T) == 2) {
    constexpr size_t smem = bf16_smem_bytes<D>();
    if ((e = allow_smem(bwd_dkdv_bf16<D>, smem)) != cudaSuccess ||
        (e = allow_smem(bwd_dq_bf16<D>, smem)) != cudaSuccess)
      return e;
    bwd_dkdv_bf16<D><<<grid_kv, kThreads, smem, stream>>>(
        tq, tk, tv, tdo, static_cast<T*>(dk), static_cast<T*>(dv), p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    bwd_dq_bf16<D><<<grid_q, kThreads, smem, stream>>>(
        tq, tk, tv, tdo, static_cast<T*>(dq), p);
  } else {
    bwd_dkdv_f32<D><<<grid_kv, kThreadsF32, 0, stream>>>(
        tq, tk, tv, tdo, static_cast<T*>(dk), static_cast<T*>(dv), p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    bwd_dq_f32<D><<<grid_q, kThreadsF32, 0, stream>>>(
        tq, tk, tv, tdo, static_cast<T*>(dq), p);
  }
  return cudaGetLastError();
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
// aligned.  lse: K1's [B, Hq, Sq] f32 log-sum-exp; delta: a [B, Hq, Sq] f32
// scratch buffer.  dtype: 0 = float32, 1 = bfloat16, the same for every
// tensor but lse and delta.  d in {32, 64, 128}; Hq % Hkv == 0.  Launches
// bwd_delta, bwd_dkdv and bwd_dq in that order on `stream`; returns the
// first launch error, or cudaGetLastError() after the last.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int b, int hq, int hkv, int sq, int skv, int d,
    const long long* strides, int causal, int window, float logit_cap,
    int q_offset, int dtype, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || skv <= 0 ||
      static_cast<long long>(b) * hq > 65535)  // grid.y of bwd_dq
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
              delta};
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
