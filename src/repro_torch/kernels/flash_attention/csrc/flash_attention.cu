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
// against 84 MB of q, k, v and o, 25 us at 3.35 TB/s.  What the design does
// about that bound:
//   * bf16 runs both products on the tensor cores (mma.sync m16n8k16, bf16
//     in, f32 accumulate) and loads the next K and V tiles with cp.async
//     while it multiplies the current ones; f32 runs the products as f32
//     FMAs, bound by the 67 TFLOP/s f32 rate, with loads and products in
//     turn.  No wgmma, TMA or warp specialisation yet;
//   * one thread block per (b*h, 64-row query tile); the Q tile is loaded
//     once (and, for bf16, kept in registers as mma fragments);
//   * a loop inside the block over 64-key tiles takes the place of the TPU
//     grid's sequential innermost axis (which carried m, l and acc in VMEM
//     scratch); m, l and acc live in registers across the loop, and the
//     [Sq, Skv] scores never reach device memory;
//   * the loop starts at the window's edge and stops at the causal diagonal,
//     so masked tiles are never loaded or computed (same result, less work);
//   * the KV head is h / group, read in place (the TPU wrapper repeats K and
//     V in memory for GQA);
//   * ragged Sq and Skv tails are masked, not asserted; q, k, v and o are
//     addressed through their strides (last dim contiguous), so the
//     [B, S, H, D] projections are read without a transposing copy.
// A key masked out contributes exactly 0, and a row with no visible key at
// all writes 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 16
static_assert(kBlockQ == kBlockK, "load_tile stages Q and K/V tiles alike");
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s;
};

struct Problem {
  int hq, group, sq, skv;
  Strides qs, ks, vs, os;
  int causal, window;
  float logit_cap;
  int q_offset;
  float scale;
};

// keys [lo, hi) that some query of the tile starting at q0 can see: start at
// the window's edge, stop at the causal diagonal
__device__ __forceinline__ void key_range(const Problem& p, int q0, int* lo,
                                          int* hi) {
  const int q_first = q0 + p.q_offset;
  const int q_last = min(q0 + kBlockQ, p.sq) - 1 + p.q_offset;
  *lo = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  *hi = p.causal ? min(p.skv, q_last + 1) : p.skv;
  *lo = (*lo / kBlockK) * kBlockK;
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
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync.m16n8k16 (bf16 in, f32 accumulate).
// Each of the 4 warps owns 16 query rows.  Fragment layouts (PTX ISA): with
// g = lane / 4 and t = lane % 4, an A fragment holds rows g and g+8, columns
// 2t, 2t+1 (and the same +8); a B fragment holds k-rows 2t, 2t+1 (and +8) of
// column g; the f32 C fragment holds rows g and g+8, columns 2t, 2t+1.
//   * K and V tiles stream global -> shared with cp.async into two buffers:
//     the next tile loads while this one is multiplied.
//   * S = Q K^T: Q's A fragments stay in registers for the whole KV loop;
//     K is staged row-major, so a B fragment is one 32-bit load.
//   * softmax in f32 on the C fragments (row max and sum over the 4 lanes of
//     a row group by shuffles; l is kept per lane and summed at the end);
//     only tiles that cross a mask edge evaluate the mask.
//   * O += P V: the C fragments of S are exactly the A fragments of P, so P
//     goes to bf16 in registers and never touches shared memory; V's B
//     fragments come from the row-major tile through ldmatrix.trans.
// Rows of the staged tiles are padded by 8 elements (16 bytes): the
// fragment loads of a warp then hit 32 distinct banks.
// ---------------------------------------------------------------------------

constexpr int kPad = 8;

template <int D>
constexpr size_t bf16_smem_bytes() {
  // Q, then two buffers of K and V
  return (kBlockQ + 4 * kBlockK) * (D + kPad) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices, transposed: register i holds matrix i, whose row
// addresses come from lanes 8i .. 8i+7
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// rows [r0, r0 + 64) of a [S, D] bf16 matrix -> a shared tile of pitch
// D + kPad; rows at or past `rows` are zero
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int r0, int rows,
                                          int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < kBlockK * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool valid = r0 + r < rows;
    cp_async16(dst + r * (D + kPad) + c,
               valid ? src + (r0 + r) * stride + c : src, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, Problem p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kPitch = D + kPad;     // row pitch of every staged tile
  constexpr int kTile = kBlockK * kPitch;
  constexpr int kSteps = D / 16;       // k-steps of Q K^T
  constexpr int kDTiles = D / 8;       // n-tiles of P V
  constexpr int kKTiles = kBlockK / 8; // n-tiles of Q K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sKV = sQ + kBlockQ * kPitch;  // K0, V0, K1, V1

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y / p.hq, h = blockIdx.y % p.hq;
  const int q0 = blockIdx.x * kBlockQ;
  const __nv_bfloat16* qb = q + b * p.qs.b + h * p.qs.h;
  const __nv_bfloat16* kb = k + b * p.ks.b + (h / p.group) * p.ks.h;
  const __nv_bfloat16* vb = v + b * p.vs.b + (h / p.group) * p.vs.h;
  __nv_bfloat16* ob = o + b * p.os.b + h * p.os.h;

  int kv_lo, kv_hi;
  key_range(p, q0, &kv_lo, &kv_hi);
  // Q, then the first K and V tiles, in flight together
  load_tile<D>(sQ, qb, p.qs.s, q0, p.sq, tid);
  cp_async_commit();
  if (kv_lo < kv_hi) {
    load_tile<D>(sKV, kb, p.ks.s, kv_lo, p.skv, tid);
    load_tile<D>(sKV + kTile, vb, p.vs.s, kv_lo, p.skv, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  const int row0 = warp * kRowsPerWarp;
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const __nv_bfloat16* base = sQ + (row0 + g) * kPitch + ks * 16 + t4 * 2;
    qf[ks][0] = ld32(base);
    qf[ks][1] = ld32(base + 8 * kPitch);
    qf[ks][2] = ld32(base + 8);
    qf[ks][3] = ld32(base + 8 * kPitch + 8);
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int dn = 0; dn < kDTiles; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  // rows g (half 0) and g + 8 (half 1) of this warp; m in log2 units, l a
  // partial sum over this lane's columns
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  int qa[2];
  qa[0] = q0 + row0 + g + p.q_offset;
  qa[1] = qa[0] + 8;
  // absolute positions of the block's first and last real query
  const int qa_first = q0 + p.q_offset;
  const int qa_last = min(q0 + kBlockQ, p.sq) - 1 + p.q_offset;
  // ldmatrix row address of this lane inside a V tile (see the P V loop)
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = (lane >> 4) * 8;

  int buf = 0;
  for (int k0 = kv_lo; k0 < kv_hi; k0 += kBlockK, buf ^= 1) {
    const __nv_bfloat16* sK = sKV + (2 * buf) * kTile;
    const __nv_bfloat16* sV = sK + kTile;
    if (k0 + kBlockK < kv_hi) {  // prefetch the next tiles
      __nv_bfloat16* nK = sKV + (2 * (buf ^ 1)) * kTile;
      load_tile<D>(nK, kb, p.ks.s, k0 + kBlockK, p.skv, tid);
      load_tile<D>(nK + kTile, vb, p.vs.s, k0 + kBlockK, p.skv, tid);
      cp_async_commit();
      cp_async_wait<1>();  // this tile has landed, the next is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T, 16 x 64 per warp
    float s[kKTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const __nv_bfloat16* kp = sK + (nt * 8 + g) * kPitch + ks * 16 + t4 * 2;
        mma_16816(s[nt], qf[ks], ld32(kp), ld32(kp + 8));
      }
    }

    // scale and cap, in log2 units; the mask only on tiles that cross an
    // edge of it (the same for every thread of the block)
    const bool interior =
        k0 + kBlockK <= p.skv &&
        (!p.causal || k0 + kBlockK - 1 <= qa_first) &&
        (p.window <= 0 || qa_last - k0 < p.window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale;
        if (p.logit_cap > 0.f) x = p.logit_cap * tanhf(x / p.logit_cap);
        x *= kLog2e;
        if (!interior &&
            !visible(p, qa[e >> 1], k0 + nt * 8 + t4 * 2 + (e & 1)))
          x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], m_use[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m[hf], mx[hf]);
      // no key of the row visible yet: nothing to rescale, every p is 0
      alpha[hf] = m_new == -INFINITY ? 1.f : exp2f(m[hf] - m_new);
      m_use[hf] = m_new == -INFINITY ? 0.f : m_new;
      m[hf] = m_new;
      l[hf] *= alpha[hf];
    }
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nt][e] - m_use[e >> 1]);  // masked: 0
        s[nt][e] = pe;
        l[e >> 1] += pe;
      }
#pragma unroll
    for (int dn = 0; dn < kDTiles; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

    // O += P V, P taken from the S fragments as bf16.  One ldmatrix.x4.trans
    // gives the B fragments of two n-tiles: matrices (keys +0..7, d dn),
    // (keys +8..15, d dn), (keys +0..7, d dn+1), (keys +8..15, d dn+1).
#pragma unroll
    for (int t = 0; t < kBlockK / 16; ++t) {
      const uint32_t pa[4] = {pack_bf16(s[2 * t][0], s[2 * t][1]),
                              pack_bf16(s[2 * t][2], s[2 * t][3]),
                              pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]),
                              pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
      for (int dn = 0; dn < kDTiles; dn += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sV + (t * 16 + v_row) * kPitch + dn * 8 + v_col);
        mma_16816(acc[dn], pa, vf[0], vf[1]);
        mma_16816(acc[dn + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before reuse
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    const int qi = q0 + row0 + g + 8 * hf;
    if (qi < p.sq) {
      const float inv = l[hf] > 0.f ? 1.f / l[hf] : 0.f;
#pragma unroll
      for (int dn = 0; dn < kDTiles; ++dn)
        *reinterpret_cast<__nv_bfloat162*>(ob + qi * p.os.s + dn * 8 +
                                           t4 * 2) =
            __floats2bfloat162_rn(acc[dn][2 * hf] * inv,
                                  acc[dn][2 * hf + 1] * inv);
    }
  }
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
cudaError_t dispatch_dtype(int dtype, const void* q, const void* k,
                           const void* v, void* o, int b, const Problem& p,
                           cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(flash_fwd_f32<D>, f32_smem_bytes<D>(), q, k, v, o, b,
                         p, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(flash_fwd_bf16<D>, bf16_smem_bytes<D>(), q,
                                 k, v, o, b, p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q: [B, Hq, Sq, D], k and v: [B, Hkv, Skv, D], o: [B, Hq, Sq, D], each given
// by its (batch, head, seq) strides in elements with the last dim contiguous;
// every stride and base pointer aligned to 16 bytes.  dtype: 0 = float32,
// 1 = bfloat16.  d in {32, 64, 128}; Hq % Hkv == 0.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int b, int hq,
    int hkv, int sq, int skv, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, float logit_cap,
    int q_offset, int dtype, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || skv <= 0 ||
      b * hq > 65535)
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
                  1.0f / sqrtf(static_cast<float>(d))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return dispatch_dtype<32>(dtype, q, k, v, o, b, p, s);
    case 64: return dispatch_dtype<64>(dtype, q, k, v, o, b, p, s);
    case 128: return dispatch_dtype<128>(dtype, q, k, v, o, b, p, s);
    default: return cudaErrorInvalidValue;
  }
}
