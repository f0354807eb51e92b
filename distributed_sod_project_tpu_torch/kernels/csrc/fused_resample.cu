// 2x half-pixel bilinear upsample of an NHWC map, optionally fused with
// "+ lateral" or a channel concat with the lateral, in one pass.
//
// Replaces distributed_sod_project_tpu/pallas/fused_resample.py
// (_up_kernel, _up_add_kernel, _up_cat_kernel; pallas_call sites
// _call_up and _call_merge).  Per axis, with the edge taps clamped:
//   out[2i]   = 0.25*x[i-1] + 0.75*x[i]
//   out[2i+1] = 0.75*x[i]   + 0.25*x[i+1]
// applied H first, then W, in f32, rounded once to the output type.
//
// Bound on the card: bytes.  The kernel reads the coarse map (a quarter
// of the fine bytes) and the lateral and writes the merged map, a few
// FLOPs per output element, far below the H100's ops:byte ridge.  The
// design keeps that traffic minimal: one thread per output element,
// neighbouring threads on neighbouring channels (coalesced loads and
// stores); the four coarse taps of a pixel are re-read from L1/L2, not
// from HBM, and the "up" map is never written on its own.
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

// mode: 0 = upsample only, 1 = + lateral, 2 = concat with the lateral.
template <typename T>
__global__ void resample_kernel(const T* __restrict__ x,
                                const T* __restrict__ lat,
                                T* __restrict__ out, int h, int w, int c,
                                int cl, int mode, int x_first,
                                int64_t total) {
  const int ho = 2 * h, wo = 2 * w;
  const int co = mode == 2 ? c + cl : c;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < total; i += (int64_t)gridDim.x * blockDim.x) {
    int ch = (int)(i % co);
    int64_t pix = i / co;  // (b*ho + oy)*wo + ox
    const int ox = (int)(pix % wo);
    const int64_t row = pix / wo;
    const int oy = (int)(row % ho);
    const int64_t b = row / ho;
    if (mode == 2) {
      const int cx = x_first ? ch : ch - cl;  // channel of the up part
      if (cx < 0 || cx >= c) {
        const int lc = x_first ? ch - c : ch;
        out[i] = lat[pix * cl + lc];
        continue;
      }
      ch = cx;
    }
    const int iy = oy >> 1, ix = ox >> 1;
    int ya, yb, xa, xb;
    float wya, wyb, wxa, wxb;
    if (oy & 1) { ya = iy; yb = min(iy + 1, h - 1); wya = 0.75f; wyb = 0.25f; }
    else        { ya = max(iy - 1, 0); yb = iy;     wya = 0.25f; wyb = 0.75f; }
    if (ox & 1) { xa = ix; xb = min(ix + 1, w - 1); wxa = 0.75f; wxb = 0.25f; }
    else        { xa = max(ix - 1, 0); xb = ix;     wxa = 0.25f; wxb = 0.75f; }
    const T* img = x + b * h * (int64_t)w * c + ch;
    const float a00 = to_f(img[((int64_t)ya * w + xa) * c]);
    const float a10 = to_f(img[((int64_t)yb * w + xa) * c]);
    const float a01 = to_f(img[((int64_t)ya * w + xb) * c]);
    const float a11 = to_f(img[((int64_t)yb * w + xb) * c]);
    // The _rn intrinsics keep nvcc from contracting into FMAs, so the
    // f32 result rounds exactly as the plain version's separate ops.
    const float ra = __fadd_rn(__fmul_rn(wya, a00), __fmul_rn(wyb, a10));
    const float rb = __fadd_rn(__fmul_rn(wya, a01), __fmul_rn(wyb, a11));
    float up = __fadd_rn(__fmul_rn(wxa, ra), __fmul_rn(wxb, rb));
    if (mode == 1) up = __fadd_rn(up, to_f(lat[pix * c + ch]));
    out[i] = from_f<T>(up);
  }
}

template <typename T>
int launch(const void* x, const void* lat, void* out, int b, int h, int w,
           int c, int cl, int mode, int x_first, cudaStream_t stream) {
  const int co = mode == 2 ? c + cl : c;
  const int64_t total = (int64_t)b * 4 * h * w * co;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  resample_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(lat),
      static_cast<T*>(out), h, w, c, cl, mode, x_first, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x is [b,h,w,c]; lat is
// [b,2h,2w,cl] (ignored for mode 0); out is [b,2h,2w,c or c+cl].
// Returns cudaGetLastError() after the launch.
int dsod_fused_resample(const void* x, const void* lat, void* out, int b,
                        int h, int w, int c, int cl, int mode, int x_first,
                        int dtype, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, lat, out, b, h, w, c, cl, mode,
                                 x_first, s);
  return launch<float>(x, lat, out, b, h, w, c, cl, mode, x_first, s);
}

const char* dsod_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
