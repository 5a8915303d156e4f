// K3: the Mamba2 SSD scan (the chunked dual form, whole) for Hopper
// (sm_90a), bound to Python through ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py::
// ssd_chunk_pallas (body _kernel) together with the plain work its wrapper
// ops.py::ssd_scan did around it: the decays, the chunk states and the
// inter-chunk lax.scan.  For one (batch, head), with chunks of L rows, i and
// j rows of chunk c, S_c its inbound state [P, N]:
//
//   dacs = cumsum(dt * a) inside the chunk,  datot = dacs[L - 1]
//   y_i  = sum_{j <= i} (C_i . B_j) exp(dacs_i - dacs_j) dt_j x_j
//          + exp(dacs_i) C_i . S_c^T
//   S_{c+1} = exp(datot) S_c + sum_t exp(datot - dacs_t) dt_t x_t (x) B_t
//
// with S_0 the initial state (or 0); the kernel writes y and the final state.
// No decay, chunk state or inbound state reaches device memory.
//
// Bound on an H100 at a mamba2-370m prefill (B=4, S=2048, 32 heads of
// P=64, d_state N=128, one group, L=256): 76.5 MB of x, dt, B, C, y and the
// final state (23 us at 3.35 TB/s) against 21.5 GFLOP (22 us at the bf16
// tensor-core peak) and 33.7 M exponentials (9 us): bytes and operations
// alike.  What the design does:
//   * one block per (batch, head) walks its chunks in order (the reference's
//     sequential lax.scan, done on chip): the f32 state stays in registers
//     across chunks, decayed by exp(datot) and added to by each chunk's local
//     state on the tensor cores;
//   * da = dt * a and its within-chunk cumulative sum are computed in the
//     block (a scan in double, rounded once to f32);
//   * B and C are read per group in place and x, B and C through their
//     strides (the column slices of the conv output), by TMA;
//   * the causal mask is applied to the exponent, before exp: exp(dacs_i -
//     dacs_j) for i < j overflows once |dt a| L is a few hundred, and a 0/1
//     mask times inf would give NaN;
//   * neither f32 state goes into the tensor cores rounded whole to bf16:
//     the inbound state and the weighted x of the local state (w x, f32)
//     each go in as two bf16 parts, hi + lo (ref.py says why).
// bf16 (ssd_scan_bf16) is warp-specialised: a producer warpgroup loads the
// chunk's C, B and x in 64-row tiles with TMA, one slot per tile, and
// loads the next chunk's tiles as the consumers free them; two consumer
// warpgroups run C B^T, C S^T (both operands in shared memory, K-major), P x
// (P from registers) and the local state on wgmma.  f32 (ssd_scan_f32)
// runs the same function as scalar FMAs summed in double, off the serving
// path.  L is a multiple of 64 up to 256.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../common/csrc/hopper.cuh"

namespace {

constexpr int kTile = 64;     // rows of an i tile and of a j tile
constexpr int kMaxTiles = 4;  // L <= 256
constexpr int kMaxChunk = kTile * kMaxTiles;
constexpr float kLog2e = 1.4426950408889634f;

// x, B, C by their (batch, seq, head-or-group) strides in elements, last dim
// contiguous; dt contiguous [batch, seq, heads] f32; the initial and final
// states contiguous [batch, heads, P, N] f32; y contiguous [batch, seq,
// heads, P].
struct Problem {
  int heads, hpg, seqlen, chunk;
  long long x_sb, x_ss, x_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
};

// ---------------------------------------------------------------------------
// f32: scalar FMAs summed in double.  One block of 4 warps per (batch,
// head) walks the chunks.  Thread 0 takes the chunk's cumulative sum in
// double.  Each i tile is computed as K3's first version did it: each warp
// owns 16 rows; for S = C B^T a lane takes its 16 rows against j = lane and
// lane + 32 (B padded to N+1 floats a row: no bank conflicts; C rows read as
// broadcast float4); the decayed scores go through a per-warp shared tile,
// and for y += P x a lane owns output columns lane + 32 k of its 16 rows.
// The inbound state, staged [P][N+1], is multiplied first the same way.
// The state itself is kept in double, in registers: thread t owns elements
// t + 128 k of the row-major [P, N] state.  A row of y can cancel to a
// thousandth of its terms, and summed in float its error would then exceed
// 2^-12 of the row.
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 4;
constexpr int kF32Threads = kF32Warps * 32;
constexpr int kRowsPerWarp = kTile / kF32Warps;  // 16

template <int P, int N>
constexpr size_t f32_smem_bytes() {
  return (kTile * N + kTile * (N + 1) + kTile * P + kTile * kTile +
          P * (N + 1) + 3 * kMaxChunk) * sizeof(float);
}

template <int P, int N>
__global__ void __launch_bounds__(kF32Threads)
ssd_scan_f32(const float* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ a, const float* __restrict__ bm,
             const float* __restrict__ cm, const float* __restrict__ init,
             float* __restrict__ y, float* __restrict__ final_state,
             Problem p) {
  static_assert(P % 32 == 0 && P <= kTile && N % 4 == 0, "P, N");
  constexpr int kCols = P / 32;                  // output columns per lane
  constexpr int kOwn = P * N / kF32Threads;      // state elements per thread
  extern __shared__ __align__(16) float smem[];
  float* sC = smem;                      // [kTile][N]
  float* sB = sC + kTile * N;            // [kTile][N + 1]
  float* sX = sB + kTile * (N + 1);      // [kTile][P]
  float* sP = sX + kTile * P;            // [kWarps][16][kTile]
  float* sS = sP + kTile * kTile;        // the inbound state, [P][N + 1]
  float* sDa = sS + P * (N + 1);         // dacs of the chunk
  float* sDt = sDa + kMaxChunk;          // dt
  float* sW = sDt + kMaxChunk;           // exp(datot - dacs) dt

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp * kRowsPerWarp;
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int grp = h / p.hpg;
  const int L = p.chunk, tiles = L / kTile, nc = p.seqlen / L;
  const float ah = a[h];
  const long long st_off = static_cast<long long>(blockIdx.x) * P * N;

  double st[kOwn];
#pragma unroll
  for (int k = 0; k < kOwn; ++k)
    st[k] = init != nullptr ? static_cast<double>(init[st_off + tid + kF32Threads * k])
                            : 0.0;

  for (int c = 0; c < nc; ++c) {
    const long long s0 = static_cast<long long>(c) * L;
    const long long t_off = (b * static_cast<long long>(p.seqlen) + s0) * p.heads + h;
    const float* xb = x + b * p.x_sb + h * p.x_sh + s0 * p.x_ss;
    const float* bb = bm + b * p.b_sb + grp * p.b_sg + s0 * p.b_ss;
    const float* cb = cm + b * p.c_sb + grp * p.c_sg + s0 * p.c_ss;
    __syncthreads();  // every thread is done with the previous chunk
    for (int j = tid; j < L; j += kF32Threads)
      sDt[j] = dt[t_off + static_cast<long long>(j) * p.heads];
    // the inbound state, staged for C S^T
#pragma unroll
    for (int k = 0; k < kOwn; ++k) {
      const int e = tid + kF32Threads * k;
      sS[(e / N) * (N + 1) + e % N] = static_cast<float>(st[k]);
    }
    __syncthreads();
    if (tid == 0) {
      double acc = 0.0;
      for (int j = 0; j < L; ++j) {
        acc += static_cast<double>(sDt[j] * ah);
        sDa[j] = static_cast<float>(acc);
      }
    }
    __syncthreads();
    const float datot = sDa[L - 1];
    for (int j = tid; j < L; j += kF32Threads)
      sW[j] = expf(datot - sDa[j]) * sDt[j];

    for (int it = 0; it < tiles; ++it) {
      const int i0 = it * kTile;
      __syncthreads();  // every warp is done with the previous C, B, x tiles
      for (int e = tid; e < kTile * N / 4; e += kF32Threads) {
        const int r = e / (N / 4), cc = (e % (N / 4)) * 4;
        *reinterpret_cast<float4*>(sC + r * N + cc) =
            *reinterpret_cast<const float4*>(cb + (i0 + r) * p.c_ss + cc);
      }
      __syncthreads();
      float dai[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) dai[r] = sDa[i0 + row0 + r];

      // the inbound state's term: exp(dacs_i) C_i . S^T
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
          for (int t = 0; t < 4; ++t)
            sv[j][t] = sS[(lane + 32 * j) * (N + 1) + n + t];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float4 cv =
              *reinterpret_cast<const float4*>(sC + (row0 + r) * N + n);
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
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        __syncthreads();  // every warp is done with the previous B, x tiles
        for (int e = tid; e < kTile * N / 4; e += kF32Threads) {
          const int r = e / (N / 4), cc = (e % (N / 4)) * 4;
          const float4 v =
              *reinterpret_cast<const float4*>(bb + (j0 + r) * p.b_ss + cc);
          float* d = sB + r * (N + 1) + cc;
          d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
        }
        for (int e = tid; e < kTile * P / 4; e += kF32Threads) {
          const int r = e / (P / 4), cc = (e % (P / 4)) * 4;
          *reinterpret_cast<float4*>(sX + r * P + cc) =
              *reinterpret_cast<const float4*>(xb + (j0 + r) * p.x_ss + cc);
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
          const int i = i0 + row0 + r;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int j = j0 + lane + 32 * hf;
            // the mask on the exponent: -inf above the diagonal, exp gives 0
            const float arg = j <= i ? dai[r] - sDa[j] : -INFINITY;
            sPw[r * kTile + lane + 32 * hf] = static_cast<float>(
                s[r][hf] * exp(static_cast<double>(arg)) * sDt[j]);
          }
        }
        __syncwarp();

#pragma unroll 2
        for (int jj = 0; jj < kTile; jj += 4) {
          float xv[4][kCols];
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              xv[t][j] = sX[(jj + t) * P + lane + 32 * j];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float4 pr =
                *reinterpret_cast<const float4*>(sPw + r * kTile + jj);
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
        float* yr = y + (t_off + static_cast<long long>(i0 + row0 + r) * p.heads) * P;
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          yr[lane + 32 * j] = static_cast<float>(acc[r][j]);
      }
    }

    // S_{c+1} = exp(datot) S_c + sum_t w_t x_t (x) B_t
    const double decay = exp(static_cast<double>(datot));
#pragma unroll
    for (int k = 0; k < kOwn; ++k) st[k] *= decay;
    for (int jt = 0; jt < tiles; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();
      for (int e = tid; e < kTile * N / 4; e += kF32Threads) {
        const int r = e / (N / 4), cc = (e % (N / 4)) * 4;
        const float4 v =
            *reinterpret_cast<const float4*>(bb + (j0 + r) * p.b_ss + cc);
        float* d = sB + r * (N + 1) + cc;
        d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
      }
      for (int e = tid; e < kTile * P / 4; e += kF32Threads) {
        const int r = e / (P / 4), cc = (e % (P / 4)) * 4;
        *reinterpret_cast<float4*>(sX + r * P + cc) =
            *reinterpret_cast<const float4*>(xb + (j0 + r) * p.x_ss + cc);
      }
      __syncthreads();
      for (int t = 0; t < kTile; ++t) {
        const double w = sW[j0 + t];
#pragma unroll
        for (int k = 0; k < kOwn; ++k) {
          const int e = tid + kF32Threads * k;
          st[k] += w * static_cast<double>(sX[t * P + e / N]) *
                   static_cast<double>(sB[t * (N + 1) + e % N]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kOwn; ++k)
    final_state[st_off + tid + kF32Threads * k] = static_cast<float>(st[k]);
}

// ---------------------------------------------------------------------------
// bf16: TMA, wgmma and warp specialisation.  One block of three warpgroups
// per (batch, head):
//   * warpgroup 0, the producer: one thread loads each chunk's tiles with
//     TMA into one slot per 64-row tile: C_i, and B_i with x_i, each slot with
//     a "full" mbarrier (the TMA reports its bytes to it) and an "empty" one
//     (the 256 consumer threads arrive when they are done with it).  It
//     loads the next chunk's C tiles once the consumers' y is done and its
//     B and x tiles one by one as the local state frees them;
//   * warpgroups 1 and 2, the consumers, in wgmma's accumulator layout
//     (warp w holds rows 16w .. 16w+15; lane l rows l/4 and l/4 + 8, columns
//     2(l%4) + 8j and the one after).  Per chunk, all 256 threads first take
//     the cumulative sum of dt * a (a warp scan in double, one row a thread)
//     and stage dacs, dt and w_t = exp(datot - dacs_t) dt_t.  Then y, one
//     64-row i tile at a time (consumer 0 takes tiles 0 and 3 of four,
//     consumer 1 tiles 1 and 2: five of the ten visible 64x64 tile pairs
//     each): y = exp(dacs_i) (C_i S_hi^T + C_i S_lo^T) then, for each j
//     tile up to the diagonal, S = C_i B_j^T, decayed and weighted by dt_j
//     in f32 and masked in the exponent on the diagonal tile, and y += P x_j
//     with P's bf16 A fragments taken from S's accumulator registers.  y
//     leaves through shared memory with one TMA store a tile.  Then the
//     state: its f32 accumulator [P, N] lives in registers (at N = 128 each
//     consumer holds 64 columns; narrower states belong to consumer 0),
//     is decayed by exp(datot), and takes (w x)^T B on wgmma, with (w x)^T
//     as register A fragments (x through ldmatrix.trans, times w in f32,
//     split into bf16 hi and lo) and B MN-major from the same tiles that
//     C B^T read K-major.  Last, the new state goes to shared memory as bf16
//     hi and lo parts for the next chunk's C S^T.
// Shared tiles are stored as TMA writes them with the 128-byte swizzle (64
// columns a row; N = 128 as two column blocks) or, for 32 columns, the
// 64-byte swizzle; the wgmma descriptors name the same swizzle.  Every tile
// starts on a 1024-byte boundary.
// ---------------------------------------------------------------------------

constexpr int kBarAll = 1;    // named barrier 1: both consumers
constexpr int kBarStore = 2;  // named barriers 2, 3: a consumer's y store

template <int P, int N>
struct Tiles {
  static constexpr int kConsumers = 2;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  // B, C and the state: blocks of kColsN columns
  static constexpr int kColsN = N < 64 ? N : 64;
  static constexpr int kRowBytesN = kColsN * 2;
  static constexpr int kLayoutN = kColsN == 64 ? 1 : 2;  // 128- or 64-byte
  static constexpr int kSwzN = kColsN == 64 ? 3 : 2;
  // x and y: one block of P columns
  static constexpr int kRowBytesP = P * 2;
  static constexpr int kLayoutP = P == 64 ? 1 : 2;
  static constexpr int kSwzP = P == 64 ? 3 : 2;
  static constexpr int kTileNBytes = kTile * N * 2;  // a tile of B or C
  static constexpr int kTilePBytes = kTile * P * 2;  // a tile of x or y
  static constexpr int kStateBytes = P * N * 2;      // the hi or lo part
  // at N = 128 the two consumers split the state's columns
  static constexpr int kStateWgs = N == 128 ? 2 : 1;
  static constexpr int kStateCols = N / kStateWgs;
  static constexpr int kC = 0;
  static constexpr int kB = kC + kMaxTiles * kTileNBytes;
  static constexpr int kX = kB + kMaxTiles * kTileNBytes;
  static constexpr int kS = kX + kMaxTiles * kTilePBytes;
  static constexpr int kY = kS + 2 * kStateBytes;
  static constexpr int kDa2 = kY + kConsumers * kTilePBytes;  // dacs log2(e)
  static constexpr int kDt = kDa2 + 4 * kMaxChunk;
  static constexpr int kW = kDt + 4 * kMaxChunk;
  static constexpr int kTot = kW + 4 * kMaxChunk;    // 8 warp sums, double
  static constexpr int kBars = kTot + 8 * 8;         // 4 x 4 mbarriers
  // + 1024 to align the dynamic shared memory to the swizzle's period
  static constexpr int kSmem = kBars + 8 * 4 * kMaxTiles + 1024;
  static_assert(kSmem <= 232448, "at most 227 KB of shared memory a block");
};

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

template <int W>
__device__ __forceinline__ void wgmma_ss(float (&d)[W / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (W == 32) {
    wgmma_ss_n32(d, da, db, accumulate);
  } else {
    wgmma_ss_n64(d, da, db, accumulate);
  }
}

template <int W>
__device__ __forceinline__ void wgmma_rs(float (&d)[W / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (W == 32) {
    wgmma_rs_n32(d, a, db);
  } else {
    wgmma_rs_n64(d, a, db);
  }
}

// the i tiles of consumer c among `tiles` (at most two): tile c, and tile
// tiles - 1 - c where that is no other consumer's first tile
__device__ __forceinline__ int owned_tile(int c, int k, int tiles) {
  if (k == 0) return c < tiles ? c : -1;
  const int t = tiles - 1 - c;
  return t > c && t >= 2 ? t : -1;
}

template <int P, int N>
__global__ void __launch_bounds__(Tiles<P, N>::kThreads, 1)
ssd_scan_bf16(const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tb,
              const __grid_constant__ CUtensorMap tc,
              const __grid_constant__ CUtensorMap ty,
              const float* __restrict__ dt, const float* __restrict__ a,
              const float* __restrict__ init, float* __restrict__ final_state,
              Problem p) {
  static_assert((P == 32 || P == 64) && (N == 32 || N == 64 || N == 128),
                "P in {32, 64}, N in {32, 64, 128}");
  using T = Tiles<P, N>;
  constexpr int kSC = T::kStateCols;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base_ptr = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(base_ptr);
  const uint32_t sC = base + T::kC, sB = base + T::kB, sX = base + T::kX;
  const uint32_t sS = base + T::kS, sY = base + T::kY;
  float* sDa2 = reinterpret_cast<float*>(base_ptr + T::kDa2);
  float* sDt = reinterpret_cast<float*>(base_ptr + T::kDt);
  float* sW = reinterpret_cast<float*>(base_ptr + T::kW);
  double* sTot = reinterpret_cast<double*>(base_ptr + T::kTot);
  const uint32_t bar_fc = base + T::kBars;          // + 8 i: C_i has landed
  const uint32_t bar_fb = bar_fc + 8 * kMaxTiles;   // + 8 i: B_i, x_i have
  const uint32_t bar_ec = bar_fb + 8 * kMaxTiles;   // + 8 i: C_i is free
  const uint32_t bar_eb = bar_ec + 8 * kMaxTiles;   // + 8 i: B_i, x_i are

  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int grp = h / p.hpg;
  const int L = p.chunk, tiles = L / kTile, nc = p.seqlen / L;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kMaxTiles; ++i) {
      mbar_init(bar_fc + 8 * i, 1);
      mbar_init(bar_fb + 8 * i, 1);
      mbar_init(bar_ec + 8 * i, 256);
      mbar_init(bar_eb + 8 * i, 256);
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
      for (int c = 0; c < nc; ++c) {
        const uint32_t phase = (c & 1) ^ 1;
        for (int i = 0; i < tiles; ++i) {
          const int row = c * L + i * kTile;
          mbar_wait(bar_ec + 8 * i, phase);
          mbar_expect_tx(bar_fc + 8 * i, T::kTileNBytes);
          for (int cb = 0; cb < N / T::kColsN; ++cb)
            tma_load(sC + i * T::kTileNBytes + cb * kTile * T::kRowBytesN, &tc,
                     bar_fc + 8 * i, cb * T::kColsN, row, grp, b);
          mbar_wait(bar_eb + 8 * i, phase);
          mbar_expect_tx(bar_fb + 8 * i, T::kTileNBytes + T::kTilePBytes);
          for (int cb = 0; cb < N / T::kColsN; ++cb)
            tma_load(sB + i * T::kTileNBytes + cb * kTile * T::kRowBytesN, &tb,
                     bar_fb + 8 * i, cb * T::kColsN, row, grp, b);
          tma_load(sX + i * T::kTilePBytes, &tx, bar_fb + 8 * i, 0, row, h, b);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kConsumerRegs));
  const int cw = wg - 1;                       // this consumer
  const int ct = threadIdx.x - 128;            // 0 .. 255
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, t4 = lane % 4;
  const bool holds_state = cw < T::kStateWgs;
  const int n0 = cw * kSC;                     // its first state column
  const float ah = a[h];
  const long long st_off = static_cast<long long>(blockIdx.x) * P * N;
  const long long dt_base = static_cast<long long>(b) * p.seqlen * p.heads + h;

  // C and B tiles K-major, 16 columns deep at column `col`; the state the
  // same; x and B MN-major, 16 rows deep at row 16 kk
  auto kmaj_desc = [&](uint32_t tile, int rows, int col) {
    return smem_desc(tile + (col / T::kColsN) * rows * T::kRowBytesN +
                         (col % T::kColsN) * 2,
                     16, 8 * T::kRowBytesN, T::kLayoutN);
  };
  auto x_desc = [&](int tile, int kk) {
    return smem_desc(sX + tile * T::kTilePBytes + kk * 16 * T::kRowBytesP,
                     kTile * T::kRowBytesP, 8 * T::kRowBytesP, T::kLayoutP);
  };
  auto bmn_desc = [&](int tile, int kk) {
    return smem_desc(sB + tile * T::kTileNBytes +
                         (n0 / T::kColsN) * kTile * T::kRowBytesN +
                         kk * 16 * T::kRowBytesN,
                     kTile * T::kRowBytesN, 8 * T::kRowBytesN, T::kLayoutN);
  };

  // the state's f32 accumulator: element e is row 16 warp + g + 8 ((e>>1)&1)
  // and column n0 + 8 (e>>2) + 2 t4 + (e&1)
  float st[kSC / 2];
#pragma unroll
  for (int e = 0; e < kSC / 2; ++e) {
    const int row = warp * 16 + g + 8 * ((e >> 1) & 1);
    const int col = n0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
    st[e] = holds_state && init != nullptr && row < P
                ? init[st_off + row * N + col]
                : 0.f;
  }
  // the state as bf16 hi and lo parts into shared memory, swizzled as a
  // K-major [P, N] tile
  auto stage_state = [&]() {
    if (!holds_state) return;
#pragma unroll
    for (int e = 0; e < kSC / 2; e += 2) {
      const int row = warp * 16 + g + 8 * ((e >> 1) & 1);
      if (row >= P) continue;
      const int col = n0 + 8 * (e >> 2) + 2 * t4;
      const uint32_t off =
          (col / T::kColsN) * P * T::kRowBytesN +
          swizzle(row * T::kRowBytesN + (col % T::kColsN) * 2, T::kSwzN);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(st[e], st[e + 1]);
      const uint32_t lo = pack_bf16(st[e] - __low2float(hi),
                                    st[e + 1] - __high2float(hi));
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sS + off),
                   "r"(*reinterpret_cast<const uint32_t*>(&hi))
                   : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sS + T::kStateBytes + off),
                   "r"(lo)
                   : "memory");
    }
  };
  stage_state();

  float y[P / 2], s[kTile / 2];
  uint32_t pf[kTile / 16][4];
  float dt_cur = ct < L ? dt[dt_base + static_cast<long long>(ct) * p.heads] : 0.f;

  for (int c = 0; c < nc; ++c) {
    const uint32_t ph = c & 1;
    const int s0 = c * L;
    const float dt_next =
        c + 1 < nc && ct < L
            ? dt[dt_base + static_cast<long long>(s0 + L + ct) * p.heads]
            : 0.f;

    // ---- dacs: a scan in double, one row a thread ----
    double v = ct < L ? static_cast<double>(dt_cur * ah) : 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) sTot[ct / 32] = v;
    named_sync(kBarAll, 256);
    double pre = 0.0;
    for (int w = 0; w < ct / 32; ++w) pre += sTot[w];
    double tot = 0.0;
    for (int w = 0; w < L / 32; ++w) tot += sTot[w];
    const float datot = static_cast<float>(tot);
    if (ct < L) {
      const float dacs = static_cast<float>(pre + v);
      sDa2[ct] = dacs * kLog2e;
      sDt[ct] = dt_cur;
      sW[ct] = expf(datot - dacs) * dt_cur;
    }
    // the state's hi and lo parts are read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(kBarAll, 256);

    // ---- y, one i tile at a time ----
    for (int k = 0; k < 2; ++k) {
      const int it = owned_tile(cw, k, tiles);
      if (it < 0) continue;
      const uint32_t cT = sC + it * T::kTileNBytes;
      mbar_wait(bar_fc + 8 * it, ph);
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int ks = 0; ks < N / 16; ++ks)
          wgmma_ss<P>(y, kmaj_desc(cT, kTile, ks * 16),
                      kmaj_desc(sS + part * T::kStateBytes, P, ks * 16),
                      part > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(y);
      const int r0 = it * kTile + warp * 16 + g;  // rows r0 and r0 + 8
      const float da_i[2] = {sDa2[r0], sDa2[r0 + 8]};
#pragma unroll
      for (int e = 0; e < P / 2; ++e) y[e] *= fast_exp2(da_i[(e >> 1) & 1]);

      for (int jt = 0; jt <= it; ++jt) {
        mbar_wait(bar_fb + 8 * jt, ph);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < N / 16; ++ks)
          wgmma_ss<kTile>(s, kmaj_desc(cT, kTile, ks * 16),
                          kmaj_desc(sB + jt * T::kTileNBytes, kTile, ks * 16),
                          ks > 0);
        wgmma_commit();
        wgmma_wait<0>();  // S, and the previous tile's P x
        fence_regs(s);
        fence_regs(y);
        // P = S exp(dacs_i - dacs_j) dt_j; on the diagonal tile the mask
        // goes on the exponent
        if (jt == it) {
#pragma unroll
          for (int e = 0; e < kTile / 2; ++e) {
            const int jj = 8 * (e >> 2) + 2 * t4 + (e & 1);
            const int ii = warp * 16 + g + 8 * ((e >> 1) & 1);
            const int j = jt * kTile + jj;
            const float arg = jj <= ii ? da_i[(e >> 1) & 1] - sDa2[j] : -INFINITY;
            s[e] *= fast_exp2(arg) * sDt[j];
          }
        } else {
#pragma unroll
          for (int e = 0; e < kTile / 2; ++e) {
            const int j = jt * kTile + 8 * (e >> 2) + 2 * t4 + (e & 1);
            s[e] *= fast_exp2(da_i[(e >> 1) & 1] - sDa2[j]) * sDt[j];
          }
        }
        // S's accumulator fragment of columns 16 kk .. 16 kk + 15 is the
        // register A fragment of P for that slice
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          pf[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
          pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
          wgmma_rs<P>(y, pf[kk], x_desc(jt, kk));
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(y);
      fence_regs(pf);

      // y as bf16 into this consumer's staging tile, swizzled as the y map
      // reads it, then one TMA store
      const uint32_t yT = sY + cw * T::kTilePBytes;
      // the previous store has read the buffer
      if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      named_sync(kBarStore + cw, 128);
#pragma unroll
      for (int jd = 0; jd < P / 8; ++jd)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = warp * 16 + g + 8 * hf, col = jd * 8 + t4 * 2;
          const uint32_t off = swizzle(row * T::kRowBytesP + col * 2, T::kSwzP);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(yT + off),
                       "r"(pack_bf16(y[4 * jd + 2 * hf], y[4 * jd + 2 * hf + 1]))
                       : "memory");
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(kBarStore + cw, 128);
      if (t == 0) {
        tma_store(&ty, yT, 0, s0 + it * kTile, h, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    for (int i = 0; i < tiles; ++i) mbar_arrive(bar_ec + 8 * i);

    // ---- the state: S = exp(datot) S + (w x)^T B ----
    if (holds_state) {
      const float decay = expf(datot);
#pragma unroll
      for (int e = 0; e < kSC / 2; ++e) st[e] *= decay;
      for (int tt = 0; tt < tiles; ++tt) {
        mbar_wait(bar_fb + 8 * tt, ph);
        // (w x)^T's A fragments: rows p of this warp, 16 rows t a k-step.
        // ldmatrix.trans of x's [t, p] tile gives, in register r, rows
        // p = 16 warp + g (+ 8 for r odd) and t = 2 t4, 2 t4 + 1 (+ 8 for
        // r >= 2) of the k-step; rows p >= P are 0
        uint32_t hi[kTile / 16][4], lo[kTile / 16][4];
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          uint32_t r[4] = {0u, 0u, 0u, 0u};
          if (warp * 16 < P) {
            const int mi = lane >> 3;
            const int trow = kk * 16 + (lane & 7) + ((mi >> 1) << 3);
            const int pcol = warp * 16 + ((mi & 1) << 3);
            ldmatrix_x4_trans(
                r, sX + tt * T::kTilePBytes +
                       swizzle(trow * T::kRowBytesP + pcol * 2, T::kSwzP));
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int tw = tt * kTile + kk * 16 + 2 * t4 + ((q >> 1) << 3);
            const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(&r[q]);
            const float f0 = __low2float(xv) * sW[tw];
            const float f1 = __high2float(xv) * sW[tw + 1];
            const __nv_bfloat162 hv = __floats2bfloat162_rn(f0, f1);
            hi[kk][q] = *reinterpret_cast<const uint32_t*>(&hv);
            lo[kk][q] = pack_bf16(f0 - __low2float(hv), f1 - __high2float(hv));
          }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          wgmma_rs<kSC>(st, hi[kk], bmn_desc(tt, kk));
          wgmma_rs<kSC>(st, lo[kk], bmn_desc(tt, kk));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(hi);
        fence_regs(lo);
        mbar_arrive(bar_eb + 8 * tt);
      }
    } else {
      for (int i = 0; i < tiles; ++i) mbar_arrive(bar_eb + 8 * i);
    }

    // every consumer is done with this chunk's state, dacs, dt and w
    named_sync(kBarAll, 256);
    stage_state();
    dt_cur = dt_next;
  }

  if (holds_state) {
#pragma unroll
    for (int e = 0; e < kSC / 2; e += 2) {
      const int row = warp * 16 + g + 8 * ((e >> 1) & 1);
      const int col = n0 + 8 * (e >> 2) + 2 * t4;
      if (row < P)
        *reinterpret_cast<float2*>(final_state + st_off + row * N + col) =
            make_float2(st[e], st[e + 1]);
    }
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int P, int N>
cudaError_t launch_f32(const void* x, const float* dt, const float* a,
                       const void* b, const void* c, const float* init,
                       void* y, float* final_state, int batch,
                       const Problem& p, cudaStream_t stream) {
  auto kernel = ssd_scan_f32<P, N>;
  constexpr size_t smem = f32_smem_bytes<P, N>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<batch * p.heads, kF32Threads, smem, stream>>>(
      static_cast<const float*>(x), dt, a, static_cast<const float*>(b),
      static_cast<const float*>(c), init, static_cast<float*>(y), final_state,
      p);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t launch_bf16(const void* x, const float* dt, const float* a,
                        const void* b, const void* c, const float* init,
                        void* y, float* final_state, int batch, int groups,
                        const Problem& p, cudaStream_t stream) {
  using T = Tiles<P, N>;
  const CUtensorMapSwizzle swz_n = T::kColsN == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                                   : CU_TENSOR_MAP_SWIZZLE_64B;
  const CUtensorMapSwizzle swz_p = P == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                           : CU_TENSOR_MAP_SWIZZLE_64B;
  const Strides ys{static_cast<long long>(p.seqlen) * p.heads * P, P,
                   static_cast<long long>(p.heads) * P};
  CUtensorMap tx, tb, tc, ty;
  if (!tensor_map(&tx, x, P, p.seqlen, p.heads, batch, {p.x_sb, p.x_sh, p.x_ss},
                  P, kTile, swz_p) ||
      !tensor_map(&tb, b, N, p.seqlen, groups, batch, {p.b_sb, p.b_sg, p.b_ss},
                  T::kColsN, kTile, swz_n) ||
      !tensor_map(&tc, c, N, p.seqlen, groups, batch, {p.c_sb, p.c_sg, p.c_ss},
                  T::kColsN, kTile, swz_n) ||
      !tensor_map(&ty, y, P, p.seqlen, p.heads, batch, ys, P, kTile, swz_p))
    return cudaErrorInvalidValue;
  auto kernel = ssd_scan_bf16<P, N>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (e != cudaSuccess) return e;
  kernel<<<batch * p.heads, T::kThreads, T::kSmem, stream>>>(
      tx, tb, tc, ty, dt, a, init, final_state, p);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t dispatch_dtype(int dtype, const void* x, const float* dt,
                           const float* a, const void* b, const void* c,
                           const float* init, void* y, float* final_state,
                           int batch, int groups, const Problem& p,
                           cudaStream_t s) {
  if (dtype == 0)
    return launch_f32<P, N>(x, dt, a, b, c, init, y, final_state, batch, p, s);
  if (dtype == 1)
    return launch_bf16<P, N>(x, dt, a, b, c, init, y, final_state, batch,
                             groups, p, s);
  return cudaErrorInvalidValue;
}

template <int P>
cudaError_t dispatch_n(int n, int dtype, const void* x, const float* dt,
                       const float* a, const void* b, const void* c,
                       const float* init, void* y, float* final_state,
                       int batch, int groups, const Problem& p,
                       cudaStream_t s) {
  switch (n) {
    case 32: return dispatch_dtype<P, 32>(dtype, x, dt, a, b, c, init, y, final_state, batch, groups, p, s);
    case 64: return dispatch_dtype<P, 64>(dtype, x, dt, a, b, c, init, y, final_state, batch, groups, p, s);
    case 128: return dispatch_dtype<P, 128>(dtype, x, dt, a, b, c, init, y, final_state, batch, groups, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: [B, S, H, P]; B and C: [B, S, G, N], each given by its (batch, seq,
// head-or-group) strides in elements with the last dim contiguous and every
// stride and base aligned to 16 bytes; dt: contiguous [B, S, H] f32; a: [H]
// f32; init (or null for zeros) and final_state: contiguous [B, H, P, N]
// f32; y: contiguous [B, S, H, P].  dtype (of x, B, C and y): 0 = float32,
// 1 = bfloat16.  P in {32, 64}, N in {32, 64, 128}, H % G == 0, chunk a
// multiple of 64 up to 256 dividing S.  Returns cudaGetLastError() after the
// launch.
extern "C" int repro_ssd_scan(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* init, void* y, void* final_state, int batch,
    int seqlen, int heads, int groups, int chunk, int p, int n,
    long long x_sb, long long x_ss, long long x_sh, long long b_sb,
    long long b_ss, long long b_sg, long long c_sb, long long c_ss,
    long long c_sg, int dtype, void* stream) {
  if (batch <= 0 || seqlen <= 0 || heads <= 0 || groups <= 0 ||
      heads % groups != 0 || chunk <= 0 || chunk % kTile != 0 ||
      chunk > kMaxChunk || seqlen % chunk != 0 ||
      static_cast<long long>(batch) * heads > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const Problem pr{heads, heads / groups, seqlen, chunk,
                   x_sb, x_ss, x_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* initf = static_cast<const float*>(init);
  float* fs = static_cast<float*>(final_state);
  switch (p) {
    case 32: return dispatch_n<32>(n, dtype, x, dtf, af, b, c, initf, y, fs, batch, groups, pr, s);
    case 64: return dispatch_n<64>(n, dtype, x, dtf, af, b, c, initf, y, fs, batch, groups, pr, s);
    default: return cudaErrorInvalidValue;
  }
}
