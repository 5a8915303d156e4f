// K2b: the RMSNorm backward for Hopper (sm_90a), bound to Python through
// ctypes.
//
// The JAX package has no backward Pallas kernel: it differentiates its plain
// src/repro/models/common.py::rms_norm.  This is the gradient of K2
// (rmsnorm.cu), y = x rstd (offset + w) with rstd = rsqrt(mean(x^2) + eps),
// recomputing rstd from x:
//
//   x^ = x rstd      g = dy (offset + w)
//   dx = rstd (g - x^ mean(g x^))      dw = sum over rows of dy x^
//
// Bound on an H100: memory.  At 8192 x 2048 bf16 it reads x and dy and
// writes dx, 100.7 MB, 30 us at 3.35 TB/s.  Two launches, deterministic and
// without atomics:
//   * rmsnorm_bwd_groups (16-byte aligned rows of 2 tpr vectors, tpr a
//     multiple of 32 from 64 to 512: bf16 d = 1024 .. 8192 in steps of
//     512, e.g. 2560, 4608, 5120, 6144): one persistent block an SM, of as
//     many row groups of tpr = d / 16 threads (bf16; 2 vectors of 8 columns
//     a thread) as 512 threads hold (3 x 160 = 480 threads at d = 2560, one
//     group of 288, 320 or 384 at 4608, 5120, 6144), so that a thread holds
//     16 columns of x and dy, not a whole warp's share of the row: nothing
//     spills.  Each thread keeps its
//     columns' offset + w (read once a block) and partial dw in f32
//     registers.  A group walks rows g, g + G, ... (G groups in the grid)
//     and loads the next two rows' x and dy while it computes the current
//     one, so the loads of the card's memory overlap the arithmetic.  The
//     row's two sums go from the warps to shared memory (two slots, used
//     in turn) and a named barrier of the group; each thread adds the
//     warps' sums in warp order.  At the end the groups add their partial
//     dw in shared memory in group order and the block writes one f32 row
//     of partial sums.  Other rows take rmsnorm_bwd_block: one block a row
//     at a time, the row staged in shared memory, each thread owning its
//     columns' partial dw;
//   * rmsnorm_bwd_dw: 32 columns a block; each of its 8 warps sums every
//     8th partial row in order, then the 8 sums are added in warp order,
//     and dw is written in w's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroupThreads = 512;  // a rmsnorm_bwd_groups block
constexpr int kGroupVecs = 2;       // 16-byte vectors a thread in a group
constexpr int kMaxGroupWarps = kGroupThreads / 32;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// T: type of x, w, dy and dx.  d = tpr * kGroupVecs vectors of 16 bytes, tpr
// (threads a row) a multiple of 32 from 64 to 512; the block is a whole
// number of groups (blockDim.x / tpr of them, at most 8: named barriers
// 1 .. 8).  Dynamic shared memory: d floats.
template <typename T>
__global__ void __launch_bounds__(kGroupThreads, 1)
rmsnorm_bwd_groups(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ partial, long long rows, int d,
                   float eps, float offset) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kV = kGroupVecs;
  extern __shared__ float sdw[];
  // the warps' (sum of x^2, sum of g x) of a row, in two slots used in turn
  __shared__ float red[2][2][kMaxGroupWarps];
  const int tpr = d / (kVec * kV);
  const int groups = blockDim.x / tpr;
  const int gid = threadIdx.x / tpr, tig = threadIdx.x % tpr;
  const int lane = threadIdx.x & 31, wig = tig / 32, nw = tpr / 32;
  float* red_g = &red[0][0][0] + gid * (tpr / 32);  // this group's warps
  const float inv_d = 1.f / static_cast<float>(d);

  // this thread's columns: vectors tig and tig + tpr of the row
  float wf[kV][kVec], pw[kV][kVec];
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const uint4 raw = reinterpret_cast<const uint4*>(w)[tig + j * tpr];
    const T* we = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      wf[j][e] = to_f32(we[e]) + offset;
      pw[j][e] = 0.f;
    }
  }
  auto load = [&](long long row, uint4 (&xr)[kV], uint4 (&gr)[kV]) {
    if (row < rows) {
      const uint4* xv = reinterpret_cast<const uint4*>(x + row * d);
      const uint4* gv = reinterpret_cast<const uint4*>(dy + row * d);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        xr[j] = xv[tig + j * tpr];
        gr[j] = gv[tig + j * tpr];
      }
    }
  };

  const long long stride = static_cast<long long>(gridDim.x) * groups;
  long long row = static_cast<long long>(blockIdx.x) * groups + gid;
  // the next two rows of this group, in flight while a row computes
  uint4 x1[kV] = {}, g1[kV] = {}, x2[kV] = {}, g2[kV] = {};
  load(row, x1, g1);
  load(row + stride, x2, g2);
  for (int slot = 0; row < rows; row += stride, slot ^= 1) {
    uint4 xr[kV], gr[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      xr[j] = x1[j];
      gr[j] = g1[j];
      x1[j] = x2[j];
      g1[j] = g2[j];
    }
    load(row + 2 * stride, x2, g2);
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const T* xe = reinterpret_cast<const T*>(&xr[j]);
      const T* ge = reinterpret_cast<const T*>(&gr[j]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float xf = to_f32(xe[e]);
        ss += xf * xf;
        dot += to_f32(ge[e]) * wf[j][e] * xf;
      }
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    float* sums = red_g + slot * 2 * kMaxGroupWarps;
    if (lane == 0) {
      sums[wig] = ss;
      sums[kMaxGroupWarps + wig] = dot;
    }
    group_sync(1 + gid, tpr);
    ss = dot = 0.f;
    for (int i = 0; i < nw; ++i) {
      ss += sums[i];
      dot += sums[kMaxGroupWarps + i];
    }
    const float rstd = rsqrtf(ss * inv_d + eps);
    // mean(g x^) = rstd mean(g x)
    const float c = rstd * dot * inv_d;
    uint4* dxv = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const T* xe = reinterpret_cast<const T*>(&xr[j]);
      const T* ge = reinterpret_cast<const T*>(&gr[j]);
      uint4 raw;
      T* o = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float xh = to_f32(xe[e]) * rstd;
        const float gk = to_f32(ge[e]);
        o[e] = from_f32<T>(rstd * (gk * wf[j][e] - xh * c));
        pw[j][e] += gk * xh;
      }
      dxv[tig + j * tpr] = raw;
    }
  }
  // the block's partial dw: groups added in order 0, 1, ...
  for (int gi = 0; gi < groups; ++gi) {
    if (gid == gi) {
#pragma unroll
      for (int j = 0; j < kV; ++j)
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int col = (tig + j * tpr) * kVec + e;
          sdw[col] = gi == 0 ? pw[j][e] : sdw[col] + pw[j][e];
        }
    }
    __syncthreads();
  }
  for (int col = threadIdx.x; col < d; col += blockDim.x)
    partial[static_cast<long long>(blockIdx.x) * d + col] = sdw[col];
}

// one block a row at a time; thread t owns columns t, t + 256, ... of the
// staged row and of the block's partial dw
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_block(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ dy, T* __restrict__ dx,
                  float* __restrict__ partial, long long rows, int d,
                  float eps, float offset) {
  extern __shared__ float smem[];
  float* sx = smem;          // d: the row of x
  float* sg = sx + d;        // d: the row of dy
  float* sdw = sg + d;       // d: partial dw
  __shared__ float red[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float inv_d = 1.f / static_cast<float>(d);
  for (int col = threadIdx.x; col < d; col += kThreads) sdw[col] = 0.f;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    float ss = 0.f, dot = 0.f;
    for (int col = threadIdx.x; col < d; col += kThreads) {
      const float xf = to_f32(x[row * d + col]);
      const float gf = to_f32(dy[row * d + col]);
      sx[col] = xf;
      sg[col] = gf;
      ss += xf * xf;
      dot += gf * (to_f32(w[col]) + offset) * xf;
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    if (lane == 0) {
      red[0][warp] = ss;
      red[1][warp] = dot;
    }
    __syncthreads();
    ss = dot = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      ss += red[0][i];
      dot += red[1][i];
    }
    __syncthreads();  // red is read before the next row writes it
    const float rstd = rsqrtf(ss * inv_d + eps);
    const float c = rstd * dot * inv_d;
    for (int col = threadIdx.x; col < d; col += kThreads) {
      const float xh = sx[col] * rstd;
      dx[row * d + col] = from_f32<T>(
          rstd * (sg[col] * (to_f32(w[col]) + offset) - xh * c));
      sdw[col] += sg[col] * xh;
    }
  }
  for (int col = threadIdx.x; col < d; col += kThreads)
    partial[static_cast<long long>(blockIdx.x) * d + col] = sdw[col];
}

// dw from the blocks' partial rows: 32 columns a block, lane l column
// 32 blockIdx.x + l; warp w sums partial rows w, w + 8, ... in order, then
// warp 0 adds the 8 warps' sums in order
template <typename T>
__device__ __forceinline__ void sum_partials(const float* __restrict__ partial,
                                             T* __restrict__ dw, int blocks,
                                             int d) {
  __shared__ float sums[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < d) {
    for (int i = warp; i < blocks; i += kWarps)
      s += partial[static_cast<long long>(i) * d + col];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < d) {
    s = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += sums[i][lane];
    dw[col] = from_f32<T>(s);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_dw(const float* __restrict__ partial, T* __restrict__ dw,
               int blocks, int d) {
  sum_partials(partial, dw, blocks, d);
}

// dynamic shared memory beyond the default 48 KB a block, less the static
// shared memory the kernels declare
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem + 1024 <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
cudaError_t run(const void* x, const void* w, const void* dy, void* dx,
                void* dw, float* partial, long long rows, int d, float eps,
                float offset, int max_blocks, int vec, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = d / kVec;
  const int tpr = nvec / kGroupVecs;
  const bool by_groups = vec && d % kVec == 0 && nvec % kGroupVecs == 0 &&
                         tpr >= 64 && tpr <= kGroupThreads && tpr % 32 == 0;
  // the groups of a block: as many whole groups as kGroupThreads hold
  const int groups = by_groups ? kGroupThreads / tpr : 1;
  const long long want = by_groups ? (rows + groups - 1) / groups : rows;
  const int blocks = static_cast<int>(want < max_blocks ? want : max_blocks);
  const size_t smem = (by_groups ? 1 : 3) * static_cast<size_t>(d) *
                      sizeof(float);
  cudaError_t e;
  if (by_groups) {
    if ((e = allow_smem(rmsnorm_bwd_groups<T>, smem)) != cudaSuccess) return e;
    rmsnorm_bwd_groups<T><<<blocks, groups * tpr, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(dy), static_cast<T*>(dx), partial, rows, d, eps,
        offset);
  } else {
    if ((e = allow_smem(rmsnorm_bwd_block<T>, smem)) != cudaSuccess) return e;
    rmsnorm_bwd_block<T><<<blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(dy), static_cast<T*>(dx), partial, rows, d, eps,
        offset);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  rmsnorm_bwd_dw<T><<<(d + 31) / 32, kThreads, 0, stream>>>(
      partial, static_cast<T*>(dw), blocks, d);
  return cudaGetLastError();
}

// ---- the split-row form --------------------------------------------------
// The backward of rmsnorm.cu's split-row form: the row's D columns are held
// in blocks of d by the ranks of a model axis.  With rstd = rsqrt(total / D
// + eps) from each row's sum of squares over the whole row (the forward's,
// saved) and dot = the sum over the whole row of x (offset + w) dy:
//   dx = rstd dy (offset + w) - x rstd^3 dot / D     dw = sum of dy x rstd
//   * rmsnorm_bwd_dot: each row's f32 sum over the block of x (offset + w)
//     dy, one warp a row; the caller sums it over the ranks;
//   * rmsnorm_bwd_split: every element of dx is then independent of the
//     others, so a block takes a tile of 32 columns (lane l column
//     32 blockIdx.x + l) and a chunk of rows (blockIdx.y): warp w walks the
//     chunk's rows w, w + 8, ..., writes dx and adds dy x rstd to its
//     column's partial dw in a register; the 8 warps' sums are added in
//     warp order and the block writes its chunk's row of partial sums;
//   * rmsnorm_bwd_split_dw adds the chunks' partial rows in order, as
//     rmsnorm_bwd_dw does (an entry of its own, so that a profile tells the
//     two forms apart).
// Deterministic and without atomics, like the whole-row form; any d (the
// whole-row groups kernel needs 64 .. 512 threads a row, which rows of 128
// and 320 columns do not make).

constexpr int kDotWarps = 4;

template <typename T>
__global__ void __launch_bounds__(kDotWarps * 32)
rmsnorm_bwd_dot(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ dy, float* __restrict__ out,
                long long rows, int d, float offset) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kDotWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * d;
  const T* gr = dy + row * d;
  float dot = 0.f;
  for (int i = lane; i < d; i += 32)
    dot += to_f32(xr[i]) * (to_f32(w[i]) + offset) * to_f32(gr[i]);
  dot = warp_sum(dot);
  if (lane == 0) out[row] = dot;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_split(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ dy, const float* __restrict__ total,
                  const float* __restrict__ dot, T* __restrict__ dx,
                  float* __restrict__ partial, long long rows, int d,
                  long long per_chunk, float inv_whole, float eps,
                  float offset) {
  __shared__ float sums[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const long long start = static_cast<long long>(blockIdx.y) * per_chunk;
  long long stop = start + per_chunk;
  if (stop > rows) stop = rows;
  float pw = 0.f;
  if (col < d) {
    const float wf = to_f32(w[col]) + offset;
    for (long long row = start + warp; row < stop; row += kWarps) {
      const float rstd = rsqrtf(total[row] * inv_whole + eps);
      const float c = rstd * rstd * rstd * dot[row] * inv_whole;
      const float xf = to_f32(x[row * d + col]);
      const float gf = to_f32(dy[row * d + col]);
      dx[row * d + col] = from_f32<T>(rstd * gf * wf - xf * c);
      pw += gf * xf * rstd;
    }
  }
  sums[warp][lane] = pw;
  __syncthreads();
  if (warp == 0 && col < d) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += sums[i][lane];
    partial[static_cast<long long>(blockIdx.y) * d + col] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_split_dw(const float* __restrict__ partial, T* __restrict__ dw,
                     int chunks, int d) {
  sum_partials(partial, dw, chunks, d);
}

template <typename T>
cudaError_t run_dot(const void* x, const void* w, const void* dy, float* out,
                    long long rows, int d, float offset, cudaStream_t stream) {
  const unsigned int blocks =
      static_cast<unsigned int>((rows + kDotWarps - 1) / kDotWarps);
  rmsnorm_bwd_dot<T><<<blocks, kDotWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(dy), out, rows, d, offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_split(const void* x, const void* w, const void* dy,
                      const float* total, const float* dot, void* dx, void* dw,
                      float* partial, long long rows, int d, int d_whole,
                      float eps, float offset, int max_chunks,
                      cudaStream_t stream) {
  // chunks of at least one row a warp, at most max_chunks of them
  long long chunks = (rows + kWarps - 1) / kWarps;
  if (chunks > max_chunks) chunks = max_chunks;
  const long long per_chunk = (rows + chunks - 1) / chunks;
  chunks = (rows + per_chunk - 1) / per_chunk;
  const dim3 grid((d + 31) / 32, static_cast<unsigned int>(chunks));
  rmsnorm_bwd_split<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(dy), total, dot, static_cast<T*>(dx), partial,
      rows, d, per_chunk, 1.f / static_cast<float>(d_whole), eps, offset);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rmsnorm_bwd_split_dw<T><<<(d + 31) / 32, kThreads, 0, stream>>>(
      partial, static_cast<T*>(dw), static_cast<int>(chunks), d);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for x, w, dy, dx and dw alike.  x,
// dy and dx are [rows, d] contiguous, w and dw are [d].  partial: f32 scratch
// of at least max_blocks * d values.  vec != 0 promises 16-byte aligned rows
// (d * sizeof(T) % 16 == 0 and a 16-byte aligned x, w, dy and dx).  Launches
// the groups (or block) kernel and then rmsnorm_bwd_dw on `stream`; returns
// the first launch error, or cudaGetLastError() after the last.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* w, const void* dy,
                                 void* dx, void* dw, float* partial,
                                 long long rows, int d, float eps,
                                 float offset, int max_blocks, int dtype,
                                 int vec, void* stream) {
  if (rows <= 0 || d <= 0 || max_blocks <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, w, dy, dx, dw, partial, rows, d, eps, offset,
                      max_blocks, vec, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, w, dy, dx, dw, partial, rows, d, eps, offset,
                              max_blocks, vec, s);
  return cudaErrorInvalidValue;
}

// The split-row form.  x, dy and dx [rows, d] contiguous, w and dw [d];
// total and dot: f32 [rows], each row's sums over the whole row of d_whole
// columns.  repro_rmsnorm_bwd_dot writes each row's sum over the block of
// x (w + offset) dy into out [rows].  repro_rmsnorm_bwd_split writes dx and
// dw; partial: f32 scratch of at least max_chunks * d values (max_chunks at
// most 65535).
extern "C" int repro_rmsnorm_bwd_dot(const void* x, const void* w,
                                     const void* dy, float* out,
                                     long long rows, int d, float offset,
                                     int dtype, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL * kDotWarps || d <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_dot<float>(x, w, dy, out, rows, d, offset, s);
  if (dtype == 1)
    return run_dot<__nv_bfloat16>(x, w, dy, out, rows, d, offset, s);
  return cudaErrorInvalidValue;
}

extern "C" int repro_rmsnorm_bwd_split(const void* x, const void* w,
                                       const void* dy, const float* total,
                                       const float* dot, void* dx, void* dw,
                                       float* partial, long long rows, int d,
                                       int d_whole, float eps, float offset,
                                       int max_chunks, int dtype,
                                       void* stream) {
  if (rows <= 0 || d <= 0 || d_whole < d || max_chunks <= 0 ||
      max_chunks > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_split<float>(x, w, dy, total, dot, dx, dw, partial, rows, d,
                            d_whole, eps, offset, max_chunks, s);
  if (dtype == 1)
    return run_split<__nv_bfloat16>(x, w, dy, total, dot, dx, dw, partial,
                                    rows, d, d_whole, eps, offset, max_chunks,
                                    s);
  return cudaErrorInvalidValue;
}
