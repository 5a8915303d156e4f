// K3: the Mamba2 SSD intra-chunk dual form for Hopper (sm_90a), bound to
// Python through ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py::
// ssd_chunk_pallas (body _kernel).  Per (batch, head, chunk), with i and j
// rows of the chunk:
//
//   y_i = sum_{j <= i} (C_i . B_j) exp(dacs_i - dacs_j) dt_j x_j
//         + exp(dacs_i) C_i . state^T
//
// where dacs is the cumulative sum of dt * a inside the chunk and state the
// chunk's inbound state (the wrapper, ops.py, computes both).  The TPU kernel
// also wrote each chunk's outbound state, which its wrapper discarded and
// recomputed by einsum; K3 does not write it.
//
// Bound on an H100: bytes.  At a mamba2-370m prefill (B=4, S=2048, 32 heads
// of P=64, d_state N=128, chunk L=256) the visible pairs cost 2 (N + P) flops
// each and the state term 2 L N P per (b, h, c): 17.2 GFLOP, 17 us at the
// bf16 tensor-core peak, against about 107 MB of x, dt, dacs, B, C, states
// and y, 32 us at 3.35 TB/s.  What the design does:
//   * one thread block per (b*h, chunk, 64-row tile of i); a loop inside the
//     block walks the 64-row tiles of j from the chunk's start to the
//     diagonal, so tiles above it are never loaded or computed;
//   * B and C are read per group (h / (H/G)) in place, and x, B, C through
//     their strides: they are column slices of the conv output, and the TPU
//     wrapper's repeat of B and C to every head is never written;
//   * dt is folded into the decayed scores in f32, so dt * x is never
//     rounded or written;
//   * the causal mask is applied to the exponent, before exp: exp(dacs_i -
//     dacs_j) for i < j overflows once |dt a| L is a few hundred, and a 0/1
//     mask times inf would give NaN;
//   * bf16 runs C B^T, P x and C state^T on the tensor cores (mma.sync
//     m16n8k16, f32 accumulate), rounding the decayed scores P to bf16
//     (ref.py states the tolerance for that), and loads the next B and x
//     tiles with cp.async while it multiplies the current ones.  The f32
//     inbound state goes in as two bf16 parts, hi + lo, each multiplied by
//     C: rounded whole, its error would meet a sum over N that cancels to
//     about 1/sqrt(N) of its terms, and move rows by about 7 units of bf16
//     roundoff at N = 128.  f32 runs the products as scalar FMAs, summed
//     in double.  No wgmma, TMA, or fusion of the chunk walk yet.
// Rows past the chunk's end (L not a multiple of 64) are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // rows of an i tile and of a j tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kTile / kWarps;  // 16
constexpr size_t kDefaultSmem = 48 * 1024;

// x, B, C by their (batch, seq, head-or-group) strides in elements, last dim
// contiguous.  dt and dacs are contiguous [batch, seq, heads] f32, states
// contiguous [batch, chunks, heads, P, N] f32, y contiguous [batch, seq,
// heads, P].
struct Problem {
  int heads, hpg, seqlen, chunk, tiles;
  long long x_sb, x_ss, x_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
};

// what one block works on
struct Block {
  long long x_off, b_off, c_off;  // row 0 of the chunk in x, B, C
  long long t_off;                // row 0 of the chunk in dt, dacs (and y / P)
  long long st_off;               // the chunk's inbound state
  int i0;                         // first row of the i tile in the chunk
  int jt_last;                    // last j tile (the diagonal one)
};

__device__ __forceinline__ Block locate(const Problem& p, int P, int N) {
  Block k;
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads, grp = h / p.hpg;
  const int c = blockIdx.x / p.tiles, it = blockIdx.x % p.tiles;
  const long long s0 = static_cast<long long>(c) * p.chunk;
  k.x_off = b * p.x_sb + h * p.x_sh + s0 * p.x_ss;
  k.b_off = b * p.b_sb + grp * p.b_sg + s0 * p.b_ss;
  k.c_off = b * p.c_sb + grp * p.c_sg + s0 * p.c_ss;
  k.t_off = (static_cast<long long>(b) * p.seqlen + s0) * p.heads + h;
  const int nchunks = p.seqlen / p.chunk;
  k.st_off = ((static_cast<long long>(b) * nchunks + c) * p.heads + h) *
             static_cast<long long>(P) * N;
  k.i0 = it * kTile;
  k.jt_last = it;
  return k;
}

// exponent of the decay from j to i, -inf above the diagonal (exp gives 0)
__device__ __forceinline__ float decay_arg(int i, int j, float dai,
                                           float daj) {
  return j <= i ? dai - daj : -INFINITY;
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs.  Each of the 4 warps owns 16 rows of the i tile.  For
// S = C B^T a lane computes its 16 rows against j = lane and lane + 32 (B
// padded to N+1 floats a row: no bank conflicts; C rows read as broadcast
// float4).  The decayed scores go through a per-warp shared tile, and for
// y += P x a lane owns output columns lane + 32 k of its 16 rows.  The
// inbound state, staged [P][N+1] in B's buffer, is multiplied first the same
// way.  The sums over N and over j run in double (a product of two floats is
// exact there): a row of y can cancel to a thousandth of its terms, and
// summed in float its error would then exceed 2^-12 of the row.
// ---------------------------------------------------------------------------

template <int P, int N>
constexpr size_t f32_smem_bytes() {
  return (kTile * N + kTile * (N + 1) + kTile * P + kTile * kTile + 2 * kTile) *
         sizeof(float);
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_f32(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ dacs, const float* __restrict__ bm,
              const float* __restrict__ cm, const float* __restrict__ states,
              float* __restrict__ y, Problem p) {
  static_assert(P % 32 == 0 && P <= kTile && N % 4 == 0, "P, N");
  constexpr int kCols = P / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* sC = smem;                      // [kTile][N]
  float* sB = sC + kTile * N;            // [kTile][N + 1], first the state
  float* sX = sB + kTile * (N + 1);      // [kTile][P]
  float* sP = sX + kTile * P;            // [kWarps][16][kTile]
  float* sDa = sP + kTile * kTile;       // [kTile]
  float* sDt = sDa + kTile;              // [kTile]

  const Block k = locate(p, P, N);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp * kRowsPerWarp;
  const float* xb = x + k.x_off;
  const float* bb = bm + k.b_off;
  const float* cb = cm + k.c_off;
  const float* st = states + k.st_off;

  for (int e = tid; e < kTile * N / 4; e += kThreads) {
    const int r = e / (N / 4), c = (e % (N / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k.i0 + r < p.chunk)
      v = *reinterpret_cast<const float4*>(cb + (k.i0 + r) * p.c_ss + c);
    *reinterpret_cast<float4*>(sC + r * N + c) = v;
  }
  for (int e = tid; e < P * N / 4; e += kThreads) {
    const int r = e / (N / 4), c = (e % (N / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(st + r * N + c);
    float* d = sB + r * (N + 1) + c;
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
  float dai[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = k.i0 + row0 + r;
    dai[r] = i < p.chunk ? dacs[k.t_off + static_cast<long long>(i) * p.heads]
                         : 0.f;
  }
  __syncthreads();

  // the inbound state's term: exp(dacs_i) C_i . state^T
  double acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.0;
  for (int n = 0; n < N; n += 4) {
    float sv[kCols][4];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) sv[j][t] = sB[(lane + 32 * j) * (N + 1) + n + t];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float4 cv = *reinterpret_cast<const float4*>(sC + (row0 + r) * N + n);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[r][j] += static_cast<double>(cv.x) * sv[j][0] +
                     static_cast<double>(cv.y) * sv[j][1] +
                     static_cast<double>(cv.z) * sv[j][2] +
                     static_cast<double>(cv.w) * sv[j][3];
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const double f = exp(static_cast<double>(dai[r]));
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] *= f;
  }

  float* sPw = sP + warp * kRowsPerWarp * kTile;
  for (int jt = 0; jt <= k.jt_last; ++jt) {
    const int j0 = jt * kTile;
    __syncthreads();  // every warp is done with the state or previous tiles
    for (int e = tid; e < kTile * N / 4; e += kThreads) {
      const int r = e / (N / 4), c = (e % (N / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j0 + r < p.chunk)
        v = *reinterpret_cast<const float4*>(bb + (j0 + r) * p.b_ss + c);
      float* d = sB + r * (N + 1) + c;
      d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    }
    for (int e = tid; e < kTile * P / 4; e += kThreads) {
      const int r = e / (P / 4), c = (e % (P / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j0 + r < p.chunk)
        v = *reinterpret_cast<const float4*>(xb + (j0 + r) * p.x_ss + c);
      *reinterpret_cast<float4*>(sX + r * P + c) = v;
    }
    if (tid < kTile) {
      const bool valid = j0 + tid < p.chunk;
      const long long o = k.t_off + static_cast<long long>(j0 + tid) * p.heads;
      sDa[tid] = valid ? dacs[o] : 0.f;
      sDt[tid] = valid ? dt[o] : 0.f;
    }
    __syncthreads();

    double s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.0;
    const float* ba = sB + lane * (N + 1);
    const float* bc = sB + (lane + 32) * (N + 1);
#pragma unroll 2
    for (int n = 0; n < N; n += 4) {
      const float a0 = ba[n], a1 = ba[n + 1], a2 = ba[n + 2], a3 = ba[n + 3];
      const float c0 = bc[n], c1 = bc[n + 1], c2 = bc[n + 2], c3 = bc[n + 3];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 cv =
            *reinterpret_cast<const float4*>(sC + (row0 + r) * N + n);
        const double x0 = cv.x, x1 = cv.y, x2 = cv.z, x3 = cv.w;
        s[r][0] += x0 * a0 + x1 * a1 + x2 * a2 + x3 * a3;
        s[r][1] += x0 * c0 + x1 * c1 + x2 * c2 + x3 * c3;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = k.i0 + row0 + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jj = lane + 32 * h;
        sPw[r * kTile + jj] = static_cast<float>(
            s[r][h] * exp(static_cast<double>(
                          decay_arg(i, j0 + jj, dai[r], sDa[jj]))) *
            sDt[jj]);
      }
    }
    __syncwarp();

#pragma unroll 2
    for (int jj = 0; jj < kTile; jj += 4) {
      float xv[4][kCols];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int j = 0; j < kCols; ++j) xv[t][j] = sX[(jj + t) * P + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pr = *reinterpret_cast<const float4*>(sPw + r * kTile + jj);
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[r][j] += static_cast<double>(pr.x) * xv[0][j] +
                       static_cast<double>(pr.y) * xv[1][j] +
                       static_cast<double>(pr.z) * xv[2][j] +
                       static_cast<double>(pr.w) * xv[3][j];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = k.i0 + row0 + r;
    if (i < p.chunk) {
      float* yr = y + (k.t_off + static_cast<long long>(i) * p.heads) * P;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        yr[lane + 32 * j] = static_cast<float>(acc[r][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync.m16n8k16 (bf16 in, f32 accumulate).
// Each of the 4 warps owns 16 rows of the i tile.  Fragment layouts (PTX
// ISA): with g = lane / 4 and t = lane % 4, an A fragment holds rows g and
// g+8, columns 2t, 2t+1 (and the same +8); a B fragment holds k-rows 2t, 2t+1
// (and +8) of column g; the f32 C fragment holds rows g and g+8, columns 2t,
// 2t+1.
//   * C's A fragments stay in registers for the whole block;
//   * the inbound state, split into bf16 hi and lo parts staged [P][N],
//     gives the B fragments of C state^T as one 32-bit load each, like B
//     for C B^T;
//   * the decay and dt are applied in f32 on the C fragments of S = C B^T,
//     which are exactly the A fragments of P for y += P x; x's B fragments
//     come from the row-major tile through ldmatrix.trans;
//   * B and x tiles stream global -> shared with cp.async into two buffers:
//     the next tile loads while this one is multiplied.
// Rows of the staged tiles are padded by 8 elements (16 bytes): the
// fragment loads of a warp then hit 32 distinct banks.
// ---------------------------------------------------------------------------

constexpr int kPad = 8;

template <int P, int N>
constexpr size_t bf16_smem_bytes() {
  // C, the state's hi and lo parts, two buffers of B and of x; then dacs
  // and dt of two j tiles
  return ((kTile + 2 * P + 2 * kTile) * (N + kPad) + 2 * kTile * (P + kPad)) *
             sizeof(__nv_bfloat16) +
         4 * kTile * sizeof(float);
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
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(K));
}

// rows [r0, r0 + 64) of a [rows, W] bf16 matrix with row stride `stride` ->
// a shared tile of pitch W + kPad; rows at or past `rows` are zero
template <int W>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int r0, int rows,
                                          int tid) {
  constexpr int kChunks = W / 8;  // 16-byte chunks per row
  for (int e = tid; e < kTile * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const bool valid = r0 + r < rows;
    cp_async16(dst + r * (W + kPad) + c,
               valid ? src + (r0 + r) * stride + c : src, valid);
  }
}

// dacs and dt of the j tile starting at j0 (0 past the chunk's end)
__device__ __forceinline__ void load_decays(float* sDa, float* sDt,
                                            const float* dacs, const float* dt,
                                            const Problem& p, const Block& k,
                                            int j0, int tid) {
  if (tid < kTile) {
    const bool valid = j0 + tid < p.chunk;
    const long long o = k.t_off + static_cast<long long>(j0 + tid) * p.heads;
    sDa[tid] = valid ? dacs[o] : 0.f;
    sDt[tid] = valid ? dt[o] : 0.f;
  }
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_bf16(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ dt, const float* __restrict__ dacs,
               const __nv_bfloat16* __restrict__ bm,
               const __nv_bfloat16* __restrict__ cm,
               const float* __restrict__ states,
               __nv_bfloat16* __restrict__ y, Problem p) {
  static_assert(P % 16 == 0 && N % 16 == 0, "P and N: multiples of 16");
  constexpr int kNP = N + kPad;         // pitch of C, the state and B tiles
  constexpr int kPP = P + kPad;         // pitch of x tiles
  constexpr int kSteps = N / 16;        // k-steps over N
  constexpr int kPTiles = P / 8;        // n-tiles over P
  constexpr int kJTiles = kTile / 8;    // n-tiles of C B^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sC = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sS = sC + kTile * kNP;           // the state: hi, lo
  __nv_bfloat16* sB = sS + 2 * P * kNP;           // B0, B1
  __nv_bfloat16* sX = sB + 2 * kTile * kNP;       // x0, x1
  float* sDa = reinterpret_cast<float*>(sX + 2 * kTile * kPP);  // [2][kTile]
  float* sDt = sDa + 2 * kTile;                                 // [2][kTile]

  const Block k = locate(p, P, N);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = warp * kRowsPerWarp;
  const __nv_bfloat16* xb = x + k.x_off;
  const __nv_bfloat16* bb = bm + k.b_off;
  const __nv_bfloat16* cb = cm + k.c_off;
  const float* st = states + k.st_off;

  // C, then the first B and x tiles, in flight together; meanwhile the state
  // goes to shared memory as hi = bf16(state) and lo = bf16(state - hi)
  load_tile<N>(sC, cb, p.c_ss, k.i0, p.chunk, tid);
  cp_async_commit();
  load_tile<N>(sB, bb, p.b_ss, 0, p.chunk, tid);
  load_tile<P>(sX, xb, p.x_ss, 0, p.chunk, tid);
  cp_async_commit();
  for (int e = tid; e < P * N / 4; e += kThreads) {
    const int r = e / (N / 4), c = (e % (N / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(st + r * N + c);
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
    uint2 hi, lo;
    hi.x = pack_bf16(v.x, v.y);
    hi.y = pack_bf16(v.z, v.w);
    lo.x = pack_bf16(v.x - __bfloat162float(h01.x), v.y - __bfloat162float(h01.y));
    lo.y = pack_bf16(v.z - __bfloat162float(h23.x), v.w - __bfloat162float(h23.y));
    *reinterpret_cast<uint2*>(sS + r * kNP + c) = hi;
    *reinterpret_cast<uint2*>(sS + (P + r) * kNP + c) = lo;
  }
  load_decays(sDa, sDt, dacs, dt, p, k, 0, tid);
  // rows g (half 0) and g + 8 (half 1) of this warp, inside the chunk
  int ii[2];
  float dai[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    ii[hf] = k.i0 + row0 + g + 8 * hf;
    dai[hf] = ii[hf] < p.chunk
                  ? dacs[k.t_off + static_cast<long long>(ii[hf]) * p.heads]
                  : 0.f;
  }
  cp_async_wait<1>();  // C has landed
  __syncthreads();

  uint32_t cf[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const __nv_bfloat16* base = sC + (row0 + g) * kNP + ks * 16 + t4 * 2;
    cf[ks][0] = ld32(base);
    cf[ks][1] = ld32(base + 8 * kNP);
    cf[ks][2] = ld32(base + 8);
    cf[ks][3] = ld32(base + 8 * kNP + 8);
  }

  // the inbound state's term: exp(dacs_i) C_i . state^T
  float acc[kPTiles][4];
#pragma unroll
  for (int pn = 0; pn < kPTiles; ++pn) {
    acc[pn][0] = acc[pn][1] = acc[pn][2] = acc[pn][3] = 0.f;
#pragma unroll
    for (int part = 0; part < 2; ++part)  // hi, then lo
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const __nv_bfloat16* sp =
            sS + (part * P + pn * 8 + g) * kNP + ks * 16 + t4 * 2;
        mma_16816(acc[pn], cf[ks], ld32(sp), ld32(sp + 8));
      }
  }
  const float f0 = expf(dai[0]), f1 = expf(dai[1]);
#pragma unroll
  for (int pn = 0; pn < kPTiles; ++pn) {
    acc[pn][0] *= f0;
    acc[pn][1] *= f0;
    acc[pn][2] *= f1;
    acc[pn][3] *= f1;
  }

  // ldmatrix row address of this lane inside an x tile (see the P x loop)
  const int x_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int x_col = (lane >> 4) * 8;

  int buf = 0;
  for (int jt = 0; jt <= k.jt_last; ++jt, buf ^= 1) {
    const int j0 = jt * kTile;
    const __nv_bfloat16* tB = sB + buf * kTile * kNP;
    const __nv_bfloat16* tX = sX + buf * kTile * kPP;
    const float* tDa = sDa + buf * kTile;
    const float* tDt = sDt + buf * kTile;
    if (jt < k.jt_last) {  // prefetch the next tiles
      const int nb = buf ^ 1;
      load_tile<N>(sB + nb * kTile * kNP, bb, p.b_ss, j0 + kTile, p.chunk, tid);
      load_tile<P>(sX + nb * kTile * kPP, xb, p.x_ss, j0 + kTile, p.chunk, tid);
      cp_async_commit();
      load_decays(sDa + nb * kTile, sDt + nb * kTile, dacs, dt, p, k,
                  j0 + kTile, tid);
      cp_async_wait<1>();  // this tile has landed, the next is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = C B^T, 16 x 64 per warp
    float s[kJTiles][4];
#pragma unroll
    for (int nt = 0; nt < kJTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const __nv_bfloat16* bp = tB + (nt * 8 + g) * kNP + ks * 16 + t4 * 2;
        mma_16816(s[nt], cf[ks], ld32(bp), ld32(bp + 8));
      }
    }
    // P = S exp(dacs_i - dacs_j) dt_j, masked above the diagonal
#pragma unroll
    for (int nt = 0; nt < kJTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = nt * 8 + t4 * 2 + (e & 1);
        s[nt][e] *= expf(decay_arg(ii[e >> 1], j0 + jj, dai[e >> 1],
                                   tDa[jj])) * tDt[jj];
      }

    // y += P x, P taken from the S fragments as bf16.  One
    // ldmatrix.x4.trans gives the B fragments of two n-tiles: matrices
    // (j +0..7, p pn), (j +8..15, p pn), (j +0..7, p pn+1), (j +8..15, p pn+1).
#pragma unroll
    for (int t = 0; t < kTile / 16; ++t) {
      const uint32_t pa[4] = {pack_bf16(s[2 * t][0], s[2 * t][1]),
                              pack_bf16(s[2 * t][2], s[2 * t][3]),
                              pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]),
                              pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
      for (int pn = 0; pn < kPTiles; pn += 2) {
        uint32_t xf[4];
        ldmatrix_x4_trans(xf, tX + (t * 16 + x_row) * kPP + pn * 8 + x_col);
        mma_16816(acc[pn], pa, xf[0], xf[1]);
        mma_16816(acc[pn + 1], pa, xf[2], xf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before reuse
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (ii[hf] < p.chunk) {
      __nv_bfloat16* yr =
          y + (k.t_off + static_cast<long long>(ii[hf]) * p.heads) * P;
#pragma unroll
      for (int pn = 0; pn < kPTiles; ++pn)
        *reinterpret_cast<__nv_bfloat162*>(yr + pn * 8 + t4 * 2) =
            __floats2bfloat162_rn(acc[pn][2 * hf], acc[pn][2 * hf + 1]);
    }
  }
}

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const void* x, const float* dt,
                   const float* dacs, const void* b, const void* c,
                   const float* states, void* y, int batch, const Problem& p,
                   cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.seqlen / p.chunk) * p.tiles, batch * p.heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, dacs, static_cast<const T*>(b),
      static_cast<const T*>(c), states, static_cast<T*>(y), p);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t dispatch_dtype(int dtype, const void* x, const float* dt,
                           const float* dacs, const void* b, const void* c,
                           const float* states, void* y, int batch,
                           const Problem& p, cudaStream_t s) {
  if (dtype == 0)
    return launch<float>(ssd_chunk_f32<P, N>, f32_smem_bytes<P, N>(), x, dt,
                         dacs, b, c, states, y, batch, p, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(ssd_chunk_bf16<P, N>, bf16_smem_bytes<P, N>(),
                                 x, dt, dacs, b, c, states, y, batch, p, s);
  return cudaErrorInvalidValue;
}

template <int P>
cudaError_t dispatch_n(int n, int dtype, const void* x, const float* dt,
                       const float* dacs, const void* b, const void* c,
                       const float* states, void* y, int batch,
                       const Problem& p, cudaStream_t s) {
  switch (n) {
    case 32: return dispatch_dtype<P, 32>(dtype, x, dt, dacs, b, c, states, y, batch, p, s);
    case 64: return dispatch_dtype<P, 64>(dtype, x, dt, dacs, b, c, states, y, batch, p, s);
    case 128: return dispatch_dtype<P, 128>(dtype, x, dt, dacs, b, c, states, y, batch, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: [B, S, H, P]; B and C: [B, S, G, N], each given by its (batch, seq,
// head-or-group) strides in elements with the last dim contiguous and every
// stride and base aligned to 16 bytes; dt and dacs: contiguous [B, S, H] f32;
// states: contiguous [B, S / chunk, H, P, N] f32; y: contiguous [B, S, H, P].
// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16.  P in {32, 64}, N in
// {32, 64, 128}, H % G == 0, S % chunk == 0.  Returns cudaGetLastError()
// after the launch.
extern "C" int repro_ssd_chunk(
    const void* x, const void* dt, const void* dacs, const void* b,
    const void* c, const void* states, void* y, int batch, int seqlen,
    int heads, int groups, int chunk, int p, int n, long long x_sb,
    long long x_ss, long long x_sh, long long b_sb, long long b_ss,
    long long b_sg, long long c_sb, long long c_ss, long long c_sg, int dtype,
    void* stream) {
  if (batch <= 0 || seqlen <= 0 || heads <= 0 || groups <= 0 ||
      heads % groups != 0 || chunk <= 0 || seqlen % chunk != 0 ||
      static_cast<long long>(batch) * heads > 65535)
    return cudaErrorInvalidValue;
  const int tiles = (chunk + kTile - 1) / kTile;
  const Problem pr{heads, heads / groups, seqlen, chunk, tiles,
                   x_sb, x_ss, x_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* daf = static_cast<const float*>(dacs);
  const float* stf = static_cast<const float*>(states);
  switch (p) {
    case 32: return dispatch_n<32>(n, dtype, x, dtf, daf, b, c, stf, y, batch, pr, s);
    case 64: return dispatch_n<64>(n, dtype, x, dtf, daf, b, c, stf, y, batch, pr, s);
    default: return cudaErrorInvalidValue;
  }
}
