// Transposed 2x half-pixel bilinear upsample: the gradient of the
// upsample with respect to its coarse input, NHWC.
//
// Replaces distributed_sod_project_tpu/pallas/fused_resample.py _upT_kernel
// (pallas_call site _call_upT).  Per axis, with ge = g[2j], go = g[2j+1]:
//   dx[j] = 0.75*(ge[j] + go[j]) + 0.25*(go[j-1] + ge[j+1])
// where the edge clamping of the forward folds in as go[-1] -> ge[0] and
// ge[n] -> go[n-1], and a coarse axis of length 1 gives dx = ge + go.  W
// is applied first, then H (the reverse of the forward), in f32, rounded
// once to the output type, with the _rn intrinsics so the f32 result
// rounds exactly as the plain version's separate ops.
//
// Gather form: one thread per coarse output element reads its 4 x 4 fine
// taps (neighbouring threads on neighbouring channels, so loads and
// stores coalesce; the taps shared by neighbouring outputs come from L1/L2).
// The fine cotangent may be a channel slab [coff, coff + c) of a wider map
// with ctot channels: the concat merge's gradient for the upsampled part is
// read in place, never copied out.
//
// Bound on the card: bytes (it reads the fine map once and writes a
// quarter of it, ~25 FLOPs per output).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// 0.75*(e + o) + 0.25*(os + es), op for op as the plain version.
__device__ __forceinline__ float combine(float e, float o, float os,
                                         float es) {
  return __fadd_rn(__fmul_rn(0.75f, __fadd_rn(e, o)),
                   __fmul_rn(0.25f, __fadd_rn(os, es)));
}

// The W-transposed value at coarse column x of fine row `row` (a pointer
// to the row's first pixel at this thread's channel; stride = ctot).
template <typename T>
__device__ __forceinline__ float row_T(const T* row, int x, int w,
                                       int64_t stride) {
  const float e = to_f(row[(int64_t)(2 * x) * stride]);
  const float o = to_f(row[(int64_t)(2 * x + 1) * stride]);
  if (w == 1) return __fadd_rn(e, o);
  const float os = to_f(row[(int64_t)(x == 0 ? 0 : 2 * x - 1) * stride]);
  const float es =
      to_f(row[(int64_t)(x == w - 1 ? 2 * w - 1 : 2 * x + 2) * stride]);
  return combine(e, o, os, es);
}

template <typename T>
__global__ void upT_kernel(const T* __restrict__ g, T* __restrict__ dx,
                           int h, int w, int c, int ctot, int coff,
                           int64_t total) {
  const int64_t fine_row = (int64_t)2 * w * ctot;  // one fine row
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < total; i += (int64_t)gridDim.x * blockDim.x) {
    const int ch = (int)(i % c);
    const int64_t pix = i / c;
    const int x = (int)(pix % w);
    const int64_t row = pix / w;
    const int y = (int)(row % h);
    const int64_t b = row / h;
    const T* img = g + b * 2 * h * fine_row + coff + ch;
    const float e = row_T(img + (int64_t)(2 * y) * fine_row, x, w, ctot);
    const float o = row_T(img + (int64_t)(2 * y + 1) * fine_row, x, w, ctot);
    float out;
    if (h == 1) {
      out = __fadd_rn(e, o);
    } else {
      const int ry = y == 0 ? 0 : 2 * y - 1;
      const int rs = y == h - 1 ? 2 * h - 1 : 2 * y + 2;
      const float os = row_T(img + (int64_t)ry * fine_row, x, w, ctot);
      const float es = row_T(img + (int64_t)rs * fine_row, x, w, ctot);
      out = combine(e, o, os, es);
    }
    dx[i] = from_f<T>(out);
  }
}

template <typename T>
int launch(const void* g, void* dx, int b, int h, int w, int c, int ctot,
           int coff, cudaStream_t stream) {
  const int64_t total = (int64_t)b * h * w * c;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  upT_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(dx), h, w, c, ctot, coff,
      total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  g is [b,2h,2w,ctot], of which
// channels [coff, coff + c) are read; dx is [b,h,w,c].  Returns
// cudaGetLastError() after the launch.
int dsod_upsample2_T(const void* g, void* dx, int b, int h, int w, int c,
                     int ctot, int coff, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0) return (int)cudaSuccess;
  if (coff < 0 || coff + c > ctot) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(g, dx, b, h, w, c, ctot, coff, s);
  return launch<float>(g, dx, b, h, w, c, ctot, coff, s);
}

const char* dsod_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
