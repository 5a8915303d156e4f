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
//   * rmsnorm_bwd_groups (16-byte aligned rows of 128, 256, 512 or 1024
//     vectors: bf16 d = 1024 .. 8192): one persistent block of 512 threads
//     an SM, in row groups of d / 16 threads (bf16; 2 vectors of 8 columns
//     a thread), so that a thread holds 16 columns of x and dy, not a
//     whole warp's share of the row: nothing spills.  Each thread keeps its
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
// (threads a row) in {64, 128, 256, 512}: kGroupThreads / tpr groups a
// block, named barriers 1 .. 8.  Dynamic shared memory: d floats.
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
  const int groups = kGroupThreads / tpr;
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
  for (int col = threadIdx.x; col < d; col += kGroupThreads)
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
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_dw(const float* __restrict__ partial, T* __restrict__ dw,
               int blocks, int d) {
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
                         tpr >= 64 && tpr <= kGroupThreads &&
                         kGroupThreads % tpr == 0;
  const long long want =
      by_groups ? (rows + kGroupThreads / tpr - 1) / (kGroupThreads / tpr)
                : rows;
  const int blocks = static_cast<int>(want < max_blocks ? want : max_blocks);
  const size_t smem = (by_groups ? 1 : 3) * static_cast<size_t>(d) *
                      sizeof(float);
  cudaError_t e;
  if (by_groups) {
    if ((e = allow_smem(rmsnorm_bwd_groups<T>, smem)) != cudaSuccess) return e;
    rmsnorm_bwd_groups<T><<<blocks, kGroupThreads, smem, stream>>>(
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
