// Per-image BCE / IoU / CEL statistics of a logit map against its
// target, in one pass over both:
//   s0 = sum max(x, 0) - x*t + log1p(exp(-|x|))   (stable BCE)
//   s1 = sum sigmoid(x) * t
//   s2 = sum sigmoid(x)
//   s3 = sum t
// in f32.  The loss terms and their closed-form gradient are plain tensor
// code around it (kernels/fused_loss.py), as the JAX package leaves them
// to XLA.
//
// Replaces distributed_sod_project_tpu/pallas/fused_loss.py _sums_kernel
// (pallas_call site pixel_region_sums), which takes one image per step of
// a sequential grid.  Here several blocks share an image: each block
// reduces a contiguous chunk of its pixels with a fixed shared-memory
// tree, and a second launch sums each image's block partials in a fixed
// order, so repeated runs agree bitwise (no atomics).
//
// Bound on the card: bytes (two f32 maps read once, a dozen FLOPs and two
// transcendentals a pixel); at 320 px, batch 8, that is 6.5 MB, so a step
// is dominated by the two launches.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sums_partial_kernel(const float* __restrict__ x, const float* __restrict__ t,
                    float* __restrict__ partial, int64_t n, int64_t chunk) {
  __shared__ float sh[4][kThreads];
  const int tid = threadIdx.x;
  const int64_t img = blockIdx.y;
  const int64_t begin = blockIdx.x * chunk;
  const int64_t end = begin + chunk < n ? begin + chunk : n;
  const float* xi = x + img * n;
  const float* ti = t + img * n;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  for (int64_t i = begin + tid; i < end; i += kThreads) {
    const float xv = xi[i], tv = ti[i];
    s0 += fmaxf(xv, 0.f) - xv * tv + log1pf(expf(-fabsf(xv)));
    const float p = 1.f / (1.f + expf(-xv));
    s1 += p * tv;
    s2 += p;
    s3 += tv;
  }
  sh[0][tid] = s0;
  sh[1][tid] = s1;
  sh[2][tid] = s2;
  sh[3][tid] = s3;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride)
      for (int k = 0; k < 4; ++k) sh[k][tid] += sh[k][tid + stride];
    __syncthreads();
  }
  if (tid < 4)
    partial[(img * gridDim.x + blockIdx.x) * 4 + tid] = sh[tid][0];
}

// out[k][img] = sum over blocks j (in order) of partial[img][j][k].
__global__ void sums_final_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int batch,
                                  int blocks_per_image) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * 4) return;
  const int img = i / 4, k = i % 4;
  float s = 0.f;
  for (int j = 0; j < blocks_per_image; ++j)
    s += partial[((int64_t)img * blocks_per_image + j) * 4 + k];
  out[(int64_t)k * batch + img] = s;
}

}  // namespace

extern "C" {

// x, t are [batch, n] float32; out is [4, batch] float32 (the four sums
// above); partial is scratch of batch * blocks_per_image * 4 floats.
// Returns cudaGetLastError().
int dsod_pixel_region_sums(const void* x, const void* t, void* partial,
                           void* out, int batch, long long n,
                           int blocks_per_image, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  if (n <= 0 || blocks_per_image < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t chunk = (n + blocks_per_image - 1) / blocks_per_image;
  const dim3 grid((unsigned)blocks_per_image, (unsigned)batch);
  sums_partial_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(t),
      static_cast<float*>(partial), (int64_t)n, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sums_final_kernel<<<(batch * 4 + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), batch,
      blocks_per_image);
  return (int)cudaGetLastError();
}

const char* dsod_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
