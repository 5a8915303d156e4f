// K2: fused RMSNorm for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py::
// rmsnorm_kernel (body _kernel); the JAX models compute the same function,
// with an additive weight offset, in src/repro/models/common.py::rms_norm.
//
//   y = x * rsqrt(mean(x^2) + eps) * (w + offset)   over the last dim, f32 inside
//
// Bound on an H100: memory.  The op does ~4 flops per element against 4 bytes
// moved per bf16 element (2 in, 2 out), far below the card's ~295 flop/byte
// ridge: a llama3-1b prefill row block of 8192 x 2048 bf16 moves 67 MB, about
// 20 us at 3.35 TB/s.  At decode (8 rows) the launch latency bounds it.
//
// Design against that bound: rows whose d is a multiple of the 16-byte
// vector and at most 256 vectors (d <= 2048 in bf16, 1024 in f32) take
// rmsnorm_rows: one warp a row, four rows a block, so any row count works (no
// divisibility condition, unlike the TPU kernel's row blocks).  Each lane
// loads its 16-byte vectors of the row (lane, lane + 32, ...) and of w, all
// in flight together, keeps the row in registers as f32 between the sum of
// squares (warp shuffles, no shared memory, no __syncthreads) and the
// scaling, and writes 16-byte vectors: x is read once and y written once,
// the fusion the Pallas kernel makes.  Other rows (not 16-byte aligned, or
// longer, such as llama2-7b's 4096) take rmsnorm_kernel: one block a row,
// staged in shared memory as f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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

// T: type of x, w and y; VEC: 16-byte loads and stores.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, int d, float eps, float offset) {
  extern __shared__ float row[];  // d floats: the row, staged as f32
  __shared__ float warp_sums[kWarps];
  constexpr int kVec = 16 / sizeof(T);
  const T* xr = x + static_cast<long long>(blockIdx.x) * d;
  T* yr = y + static_cast<long long>(blockIdx.x) * d;

  float ss = 0.f;
  if (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < d / kVec; i += kThreads) {
      uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float f = to_f32(e[j]);
        row[i * kVec + j] = f;
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float f = to_f32(xr[i]);
      row[i] = f;
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += warp_sums[i];
  const float inv = rsqrtf(total / static_cast<float>(d) + eps);

  // each thread scales the elements it staged itself: no barrier needed
  if (VEC) {
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = threadIdx.x; i < d / kVec; i += kThreads) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int c = i * kVec + j;
        e[j] = from_f32<T>(row[c] * inv * (to_f32(w[c]) + offset));
      }
      yv[i] = raw;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      yr[i] = from_f32<T>(row[i] * inv * (to_f32(w[i]) + offset));
    }
  }
}

// T: type of x, w and y; N: 16-byte vectors a lane holds (the row has at most
// 32 N of them).  One warp a row.
constexpr int kRowWarps = 4;

template <typename T, int N>
__global__ void __launch_bounds__(kRowWarps * 32)
rmsnorm_rows(const T* __restrict__ x, const T* __restrict__ w,
             T* __restrict__ y, long long rows, int d, float eps,
             float offset) {
  constexpr int kVec = 16 / sizeof(T);
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31, nvec = d / kVec;
  const uint4* xv = reinterpret_cast<const uint4*>(x + row * d);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  uint4 xr[N], wr[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = lane + 32 * j;
    xr[j] = i < nvec ? xv[i] : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = lane + 32 * j;
    wr[j] = i < nvec ? __ldg(wv + i) : make_uint4(0, 0, 0, 0);
  }
  float f[N][kVec];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const T* e = reinterpret_cast<const T*>(&xr[j]);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      f[j][k] = to_f32(e[k]);
      ss += f[j][k] * f[j][k];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  uint4* yv = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = lane + 32 * j;
    if (i < nvec) {
      const T* we = reinterpret_cast<const T*>(&wr[j]);
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        e[k] = from_f32<T>(f[j][k] * inv * (to_f32(we[k]) + offset));
      yv[i] = raw;
    }
  }
}

template <typename T, int N>
cudaError_t launch_rows(const void* x, const void* w, void* y, long long rows,
                        int d, float eps, float offset, cudaStream_t stream) {
  const long long blocks = (rows + kRowWarps - 1) / kRowWarps;
  rmsnorm_rows<T, N><<<static_cast<unsigned int>(blocks), kRowWarps * 32, 0,
                       stream>>>(static_cast<const T*>(x),
                                 static_cast<const T*>(w), static_cast<T*>(y),
                                 rows, d, eps, offset);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch(const void* x, const void* w, void* y, long long rows, int d,
                   float eps, float offset, cudaStream_t stream) {
  auto kernel = rmsnorm_kernel<T, VEC>;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned int>(rows), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      d, eps, offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_vec(const void* x, const void* w, void* y, long long rows,
                         int d, float eps, float offset, int vec,
                         cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = d / kVec;
  // the register path, with as few vectors a lane as hold the row
  if (vec && d % kVec == 0) {
    if (nvec <= 32)
      return launch_rows<T, 1>(x, w, y, rows, d, eps, offset, stream);
    if (nvec <= 64)
      return launch_rows<T, 2>(x, w, y, rows, d, eps, offset, stream);
    if (nvec <= 128)
      return launch_rows<T, 4>(x, w, y, rows, d, eps, offset, stream);
    if (nvec <= 256)
      return launch_rows<T, 8>(x, w, y, rows, d, eps, offset, stream);
  }
  return vec ? launch<T, true>(x, w, y, rows, d, eps, offset, stream)
             : launch<T, false>(x, w, y, rows, d, eps, offset, stream);
}

// ---- the split-row form --------------------------------------------------
// A row of D columns held in blocks of d by the ranks of a model axis (the
// Mamba2 gated norm over a rank's heads: d = 128 or 320 at the published
// widths on a model axis of 16).  Its mean square needs the whole row, so
// the norm runs in two passes with the ranks' all-reduce between them:
//   rmsnorm_sumsq: each row's f32 sum of squares over the block, one warp a
//     row (16-byte vectors where aligned), the lanes' sums added by warp
//     shuffles, lane 0 writing the row's sum;
//   rmsnorm_split: y = x rsqrt(total / D + eps) (w + offset), from each row's
//     total over the whole row (the sums added over the ranks), one warp a
//     row, each lane its vectors of the row.
// Bound: memory (x read twice, y written once, 4 bytes a row each way).

template <typename T, bool VEC>
__global__ void __launch_bounds__(kRowWarps * 32)
rmsnorm_sumsq(const T* __restrict__ x, float* __restrict__ out,
              long long rows, int d) {
  constexpr int kVec = 16 / sizeof(T);
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * d;
  float ss = 0.f;
  if (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = lane; i < d / kVec; i += 32) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float f = to_f32(e[k]);
        ss += f * f;
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) out[row] = ss;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kRowWarps * 32)
rmsnorm_split(const T* __restrict__ x, const T* __restrict__ w,
              const float* __restrict__ total, T* __restrict__ y,
              long long rows, int d, float inv_whole, float eps,
              float offset) {
  constexpr int kVec = 16 / sizeof(T);
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const float inv = rsqrtf(total[row] * inv_whole + eps);
  const T* xr = x + row * d;
  T* yr = y + row * d;
  if (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    const uint4* wv = reinterpret_cast<const uint4*>(w);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = lane; i < d / kVec; i += 32) {
      const uint4 xraw = xv[i], wraw = __ldg(wv + i);
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* we = reinterpret_cast<const T*>(&wraw);
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        e[k] = from_f32<T>(to_f32(xe[k]) * inv * (to_f32(we[k]) + offset));
      yv[i] = raw;
    }
  } else {
    for (int i = lane; i < d; i += 32)
      yr[i] = from_f32<T>(to_f32(xr[i]) * inv * (to_f32(w[i]) + offset));
  }
}

template <typename T>
cudaError_t split_sumsq(const void* x, float* out, long long rows, int d,
                        int vec, cudaStream_t stream) {
  const unsigned int blocks =
      static_cast<unsigned int>((rows + kRowWarps - 1) / kRowWarps);
  if (vec && d % (16 / sizeof(T)) == 0)
    rmsnorm_sumsq<T, true><<<blocks, kRowWarps * 32, 0, stream>>>(
        static_cast<const T*>(x), out, rows, d);
  else
    rmsnorm_sumsq<T, false><<<blocks, kRowWarps * 32, 0, stream>>>(
        static_cast<const T*>(x), out, rows, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t split_apply(const void* x, const void* w, const float* total,
                        void* y, long long rows, int d, int d_whole, float eps,
                        float offset, int vec, cudaStream_t stream) {
  const unsigned int blocks =
      static_cast<unsigned int>((rows + kRowWarps - 1) / kRowWarps);
  const float inv_whole = 1.f / static_cast<float>(d_whole);
  if (vec && d % (16 / sizeof(T)) == 0)
    rmsnorm_split<T, true><<<blocks, kRowWarps * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), total,
        static_cast<T*>(y), rows, d, inv_whole, eps, offset);
  else
    rmsnorm_split<T, false><<<blocks, kRowWarps * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), total,
        static_cast<T*>(y), rows, d, inv_whole, eps, offset);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for x, w and y alike.  x and y are
// [rows, d] contiguous, w is [d].  vec != 0 promises 16-byte aligned rows
// (d * sizeof(T) % 16 == 0 and a 16-byte aligned x, w and y).  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_rmsnorm(const void* x, const void* w, void* y,
                             long long rows, int d, float eps, float offset,
                             int dtype, int vec, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_vec<float>(x, w, y, rows, d, eps, offset, vec, s);
  if (dtype == 1)
    return dispatch_vec<__nv_bfloat16>(x, w, y, rows, d, eps, offset, vec, s);
  return cudaErrorInvalidValue;
}

// The split-row form.  x [rows, d] contiguous; total: f32 [rows].  vec as
// above (x, w and y 16-byte aligned, d * sizeof(T) % 16 == 0).
extern "C" int repro_rmsnorm_sumsq(const void* x, float* out, long long rows,
                                   int d, int dtype, int vec, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL * kRowWarps || d <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return split_sumsq<float>(x, out, rows, d, vec, s);
  if (dtype == 1) return split_sumsq<__nv_bfloat16>(x, out, rows, d, vec, s);
  return cudaErrorInvalidValue;
}

// y = x rsqrt(total / d_whole + eps) (w + offset), w [d].
extern "C" int repro_rmsnorm_split(const void* x, const void* w,
                                   const float* total, void* y,
                                   long long rows, int d, int d_whole,
                                   float eps, float offset, int dtype,
                                   int vec, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL * kRowWarps || d <= 0 || d_whole < d)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return split_apply<float>(x, w, total, y, rows, d, d_whole, eps, offset,
                              vec, s);
  if (dtype == 1)
    return split_apply<__nv_bfloat16>(x, w, total, y, rows, d, d_whole, eps,
                                      offset, vec, s);
  return cudaErrorInvalidValue;
}
