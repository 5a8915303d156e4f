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
//   * rmsnorm_bwd_rows (rows of at most 256 16-byte vectors, aligned): one
//     warp a row, as K2, with the row of x and dy in registers; each block
//     of 8 warps walks rows b*8 + w, b*8 + w + 8*grid, ... and keeps its
//     warps' partial dw in registers, sums them in a fixed order in shared
//     memory and writes one f32 row of partial sums.  Other rows take
//     rmsnorm_bwd_block: one block a row at a time, the row staged in shared
//     memory, each thread owning its columns' partial dw;
//   * rmsnorm_bwd_dw: one thread a column sums the blocks' partial rows in
//     block order and writes dw in w's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
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

// T: type of x, w, dy and dx; N: 16-byte vectors a lane holds
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_rows(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ dy, T* __restrict__ dx,
                 float* __restrict__ partial, long long rows, int d,
                 float eps, float offset) {
  extern __shared__ float sdw[];  // d floats
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = d / kVec;
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  float pw[N][kVec];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int k = 0; k < kVec; ++k) pw[j][k] = 0.f;
  const float inv_d = 1.f / static_cast<float>(d);
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
       row < rows; row += static_cast<long long>(gridDim.x) * kWarps) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + row * d);
    const uint4* gv = reinterpret_cast<const uint4*>(dy + row * d);
    // w is re-read each row from L1 (__ldg) rather than held: registers
    // go to the rows of x and dy and the partial dw
    uint4 xr[N], gr[N], wr[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = lane + 32 * j;
      xr[j] = i < nvec ? xv[i] : make_uint4(0, 0, 0, 0);
      gr[j] = i < nvec ? gv[i] : make_uint4(0, 0, 0, 0);
      wr[j] = i < nvec ? __ldg(wv + i) : make_uint4(0, 0, 0, 0);
    }
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T* xe = reinterpret_cast<const T*>(&xr[j]);
      const T* ge = reinterpret_cast<const T*>(&gr[j]);
      const T* we = reinterpret_cast<const T*>(&wr[j]);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float xf = to_f32(xe[k]);
        ss += xf * xf;
        dot += to_f32(ge[k]) * (to_f32(we[k]) + offset) * xf;
      }
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    const float rstd = rsqrtf(ss * inv_d + eps);
    // mean(g x^) = rstd mean(g x)
    const float c = rstd * dot * inv_d;
    uint4* dxv = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = lane + 32 * j;
      if (i < nvec) {
        const T* xe = reinterpret_cast<const T*>(&xr[j]);
        const T* ge = reinterpret_cast<const T*>(&gr[j]);
        const T* we = reinterpret_cast<const T*>(&wr[j]);
        uint4 raw;
        T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const float xh = to_f32(xe[k]) * rstd;
          const float gk = to_f32(ge[k]);
          e[k] = from_f32<T>(rstd * (gk * (to_f32(we[k]) + offset) - xh * c));
          pw[j][k] += gk * xh;
        }
        dxv[i] = raw;
      }
    }
  }
  // the block's partial dw: warps added in order 0, 1, ...
  for (int wi = 0; wi < kWarps; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int i = lane + 32 * j;
        if (i < nvec) {
#pragma unroll
          for (int k = 0; k < kVec; ++k)
            sdw[i * kVec + k] = wi == 0 ? pw[j][k] : sdw[i * kVec + k] + pw[j][k];
        }
      }
    }
    __syncthreads();
  }
  for (int col = threadIdx.x; col < d; col += kThreads)
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_dw(const float* __restrict__ partial, T* __restrict__ dw,
               int blocks, int d) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= d) return;
  float s = 0.f;
  for (int i = 0; i < blocks; ++i)
    s += partial[static_cast<long long>(i) * d + col];
  dw[col] = from_f32<T>(s);
}

// dynamic shared memory beyond the default 48 KB a block, less the static
// shared memory the kernel declares (`red`)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem + 1024 <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int N>
cudaError_t launch_rows(const void* x, const void* w, const void* dy, void* dx,
                        float* partial, long long rows, int d, float eps,
                        float offset, int blocks, cudaStream_t stream) {
  rmsnorm_bwd_rows<T, N><<<blocks, kThreads, d * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(dy), static_cast<T*>(dx), partial, rows, d, eps,
      offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, const void* w, const void* dy, void* dx,
                void* dw, float* partial, long long rows, int d, float eps,
                float offset, int max_blocks, int vec, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = d / kVec;
  const bool by_rows = vec && d % kVec == 0 && nvec <= 256;
  const long long want = by_rows ? (rows + kWarps - 1) / kWarps : rows;
  const int blocks = static_cast<int>(want < max_blocks ? want : max_blocks);
  cudaError_t e;
  if (by_rows) {
    if (nvec <= 32)
      e = launch_rows<T, 1>(x, w, dy, dx, partial, rows, d, eps, offset,
                            blocks, stream);
    else if (nvec <= 64)
      e = launch_rows<T, 2>(x, w, dy, dx, partial, rows, d, eps, offset,
                            blocks, stream);
    else if (nvec <= 128)
      e = launch_rows<T, 4>(x, w, dy, dx, partial, rows, d, eps, offset,
                            blocks, stream);
    else
      e = launch_rows<T, 8>(x, w, dy, dx, partial, rows, d, eps, offset,
                            blocks, stream);
  } else {
    const size_t smem = 3 * static_cast<size_t>(d) * sizeof(float);
    if ((e = allow_smem(rmsnorm_bwd_block<T>, smem)) != cudaSuccess) return e;
    rmsnorm_bwd_block<T><<<blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(dy), static_cast<T*>(dx), partial, rows, d, eps,
        offset);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return e;
  rmsnorm_bwd_dw<T><<<(d + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, static_cast<T*>(dw), blocks, d);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for x, w, dy, dx and dw alike.  x,
// dy and dx are [rows, d] contiguous, w and dw are [d].  partial: f32 scratch
// of at least max_blocks * d values.  vec != 0 promises 16-byte aligned rows
// (d * sizeof(T) % 16 == 0 and a 16-byte aligned x, w, dy and dx).  Launches
// the rows (or block) kernel and then rmsnorm_bwd_dw on `stream`; returns the
// first launch error, or cudaGetLastError() after the last.
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
