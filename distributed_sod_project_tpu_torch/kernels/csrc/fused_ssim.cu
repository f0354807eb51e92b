// SSIM of two single-channel maps a, b ([B,H,W] f32) with a separable
// Gaussian window (odd, 2r+1 taps) and zero "SAME" padding: the forward
// gives one f32 sum of the SSIM map per image, the backward the gradient
// of that sum with respect to a (and to b when asked).
//
// Replaces distributed_sod_project_tpu/pallas/fused_ssim.py _fwd_kernel
// and _bwd_kernel (pallas_call site _run), which hold one whole image in
// VMEM and blur it with banded matrices on the MXU.  Here a block owns a
// 32 x 16 pixel tile of one image and loads it with an r-pixel halo (zero
// outside the image: exactly the band matrices' zero padding) into shared
// memory; the 5 moment maps (a, b, a*a, b*b, a*b) are blurred along H,
// then along W, as the reference does, and the SSIM value
//   S = (2 mu_a mu_b + C1)(2 (e_ab - mu_a mu_b) + C2)
//       / ((mu_a^2 + mu_b^2 + C1)(e_aa - mu_a^2 + e_bb - mu_b^2 + C2))
// is evaluated per pixel.
//
// Forward: each block reduces its tile's S with a fixed tree into one
// partial, and a second launch sums an image's partials in a fixed order
// (bitwise repeatable; no atomics).
//
// Backward, two launches.  The first recomputes the moments and writes
// the pointwise partials in closed form (with A1, A2, B1, B2 the four
// factors above):
//   dS/dmu_a = 2 mu_b (A2 - A1) / (B1 B2) - 2 mu_a S (1/B1 - 1/B2)
//   dS/de_aa = dS/de_bb = -S / B2,   dS/de_ab = 2 A1 / (B1 B2)
// (dS/dmu_b is dS/dmu_a with a and b swapped, written only when b needs a
// gradient).  The second blurs those maps (the window is symmetric, so the
// blur is its own transpose) and combines them:
//   ga = G*dmu_a + 2 a (G*de_aa) + b (G*de_ab)
//   gb = G*dmu_b + 2 b (G*de_bb) + a (G*de_ab)
//
// Bound on the card: bytes at these sizes in principle (a few maps read
// once), but at 320 px, batch 8 the whole step moves ~6.5 MB, so the
// launches dominate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32, TH = 16, kThreads = 256;
constexpr int kPer = TW * TH / kThreads;  // pixels per thread
constexpr int kMaxR = 15;                 // windows up to 31 taps
constexpr int kHaloMax = (TH + 2 * kMaxR) * (TW + 2 * kMaxR);
constexpr int kVMax = TH * (TW + 2 * kMaxR);

struct Params {
  float w[2 * kMaxR + 1];  // the window's taps
  int r;                   // its radius
  float c1, c2;
};

// The tile's halo of one map: (TH + 2r) x (TW + 2r), zero outside.
__device__ __forceinline__ void load_halo(const float* __restrict__ src,
                                          int H, int W, int y0, int x0,
                                          int r, float* dst) {
  const int hh = TH + 2 * r, hw = TW + 2 * r;
  for (int idx = threadIdx.x; idx < hh * hw; idx += kThreads) {
    const int yy = y0 - r + idx / hw, xx = x0 - r + idx % hw;
    dst[idx] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                   ? src[(int64_t)yy * W + xx]
                   : 0.f;
  }
}

// The 5 blurred moments at this thread's kPer pixels of the tile, from
// the halos of a and b (H pass into sv, then W pass into registers).
__device__ __forceinline__ void tile_moments(const float* sa, const float* sb,
                                             float* sv, const Params& p,
                                             float mom[kPer][5]) {
  const int r = p.r, hw = TW + 2 * r, k = 2 * r + 1;
  for (int idx = threadIdx.x; idx < TH * hw; idx += kThreads) {
    const int ty = idx / hw, xx = idx % hw;
    float m[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < k; ++j) {
      const float a = sa[(ty + j) * hw + xx], b = sb[(ty + j) * hw + xx];
      const float wj = p.w[j];
      m[0] += wj * a;
      m[1] += wj * b;
      m[2] += wj * (a * a);
      m[3] += wj * (b * b);
      m[4] += wj * (a * b);
    }
    for (int q = 0; q < 5; ++q) sv[q * TH * hw + idx] = m[q];
  }
  __syncthreads();
  for (int e = 0; e < kPer; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    const int ty = idx / TW, tx = idx % TW;
    for (int q = 0; q < 5; ++q) {
      const float* row = sv + q * TH * hw + ty * hw + tx;
      float s = 0.f;
      for (int j = 0; j < k; ++j) s += p.w[j] * row[j];
      mom[e][q] = s;
    }
  }
}

struct Factors {
  float a1, a2, b1, b2, s;
};

__device__ __forceinline__ Factors factors(const float m[5],
                                           const Params& p) {
  const float mu_aa = m[0] * m[0], mu_bb = m[1] * m[1], mu_ab = m[0] * m[1];
  Factors f;
  f.a1 = 2.f * mu_ab + p.c1;
  f.a2 = 2.f * (m[4] - mu_ab) + p.c2;
  f.b1 = mu_aa + mu_bb + p.c1;
  f.b2 = (m[2] - mu_aa) + (m[3] - mu_bb) + p.c2;
  f.s = (f.a1 * f.a2) / (f.b1 * f.b2);
  return f;
}

// Fixed-order shared-memory tree over the block; thread 0 gets the sum.
__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if ((int)threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  return red[0];
}

__global__ void __launch_bounds__(kThreads)
ssim_fwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ partial, int H, int W, Params p) {
  __shared__ float sa[kHaloMax], sb[kHaloMax], sv[5 * kVMax];
  __shared__ float red[kThreads];
  const int64_t img = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  load_halo(a + img * H * W, H, W, y0, x0, p.r, sa);
  load_halo(b + img * H * W, H, W, y0, x0, p.r, sb);
  __syncthreads();
  float mom[kPer][5];
  tile_moments(sa, sb, sv, p, mom);
  float local = 0.f;
  for (int e = 0; e < kPer; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    if (y0 + idx / TW < H && x0 + idx % TW < W) local += factors(mom[e], p).s;
  }
  const float s = block_sum(local, red);
  if (threadIdx.x == 0)
    partial[(img * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = s;
}

// out[img] = sum over the image's tiles (in order) of partial.
__global__ void ssim_sum_kernel(const float* __restrict__ partial,
                                float* __restrict__ out, int batch,
                                int tiles) {
  const int img = blockIdx.x * blockDim.x + threadIdx.x;
  if (img >= batch) return;
  float s = 0.f;
  for (int j = 0; j < tiles; ++j) s += partial[(int64_t)img * tiles + j];
  out[img] = s;
}

// Pointwise partials of S into maps[q][img][y][x]: q = 0 dS/dmu_a,
// 1 dS/de_aa (= dS/de_bb), 2 dS/de_ab, 3 dS/dmu_b (with need_b).
__global__ void __launch_bounds__(kThreads)
ssim_partials_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ maps, int H, int W, Params p,
                     int need_b, int64_t plane) {
  __shared__ float sa[kHaloMax], sb[kHaloMax], sv[5 * kVMax];
  const int64_t img = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  load_halo(a + img * H * W, H, W, y0, x0, p.r, sa);
  load_halo(b + img * H * W, H, W, y0, x0, p.r, sb);
  __syncthreads();
  float mom[kPer][5];
  tile_moments(sa, sb, sv, p, mom);
  for (int e = 0; e < kPer; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    const int y = y0 + idx / TW, x = x0 + idx % TW;
    if (y >= H || x >= W) continue;
    const Factors f = factors(mom[e], p);
    const float inv = 1.f / (f.b1 * f.b2);
    const float t = f.s * (1.f / f.b1 - 1.f / f.b2);
    const float mu_a = mom[e][0], mu_b = mom[e][1];
    const int64_t o = img * H * W + (int64_t)y * W + x;
    maps[o] = 2.f * mu_b * (f.a2 - f.a1) * inv - 2.f * mu_a * t;
    maps[plane + o] = -f.s / f.b2;
    maps[2 * plane + o] = 2.f * f.a1 * inv;
    if (need_b)
      maps[3 * plane + o] = 2.f * mu_a * (f.a2 - f.a1) * inv - 2.f * mu_b * t;
  }
}

// ga (and gb) from the blurred partial maps.
__global__ void __launch_bounds__(kThreads)
ssim_grad_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ maps, float* __restrict__ ga,
                 float* __restrict__ gb, int H, int W, Params p, int need_b,
                 int64_t plane) {
  __shared__ float sh[kHaloMax], sv[kVMax];
  const int64_t img = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int r = p.r, hw = TW + 2 * r, k = 2 * r + 1;
  float G[kPer][4];
  const int n_maps = need_b ? 4 : 3;
  for (int q = 0; q < n_maps; ++q) {
    load_halo(maps + q * plane + img * H * W, H, W, y0, x0, r, sh);
    __syncthreads();
    for (int idx = threadIdx.x; idx < TH * hw; idx += kThreads) {
      const int ty = idx / hw, xx = idx % hw;
      float s = 0.f;
      for (int j = 0; j < k; ++j) s += p.w[j] * sh[(ty + j) * hw + xx];
      sv[idx] = s;
    }
    __syncthreads();
    for (int e = 0; e < kPer; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const float* row = sv + (idx / TW) * hw + idx % TW;
      float s = 0.f;
      for (int j = 0; j < k; ++j) s += p.w[j] * row[j];
      G[e][q] = s;
    }
    __syncthreads();
  }
  for (int e = 0; e < kPer; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    const int y = y0 + idx / TW, x = x0 + idx % TW;
    if (y >= H || x >= W) continue;
    const int64_t o = img * H * W + (int64_t)y * W + x;
    const float av = a[o], bv = b[o];
    ga[o] = (G[e][0] + 2.f * av * G[e][1]) + bv * G[e][2];
    if (need_b) gb[o] = (G[e][3] + 2.f * bv * G[e][1]) + av * G[e][2];
  }
}

Params make_params(const float* taps, int window, float c1, float c2) {
  Params p{};
  for (int i = 0; i < window; ++i) p.w[i] = taps[i];
  p.r = window / 2;
  p.c1 = c1;
  p.c2 = c2;
  return p;
}

bool bad_window(int window) {
  return window < 1 || window % 2 == 0 || window > 2 * kMaxR + 1;
}

}  // namespace

extern "C" {

// a, b are [batch,h,w] float32; taps is a host array of `window` floats.
// out is [batch] float32, the per-image sum of the SSIM map; partial is
// scratch of batch * ceil(w/32) * ceil(h/16) floats.  Returns
// cudaGetLastError().
int dsod_ssim_fwd(const void* a, const void* b, void* partial, void* out,
                  int batch, int h, int w, const float* taps, int window,
                  float c1, float c2, void* stream) {
  if (bad_window(window)) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || h <= 0 || w <= 0) return (int)cudaSuccess;
  const Params p = make_params(taps, window, c1, c2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, batch);
  ssim_fwd_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(partial), h, w, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssim_sum_kernel<<<(batch + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), batch,
      (int)(grid.x * grid.y));
  return (int)cudaGetLastError();
}

// The gradient of the per-image SSIM sums: ga (and gb when need_b) are
// [batch,h,w] float32; maps is scratch of (need_b ? 4 : 3) * batch*h*w
// floats.  Returns cudaGetLastError().
int dsod_ssim_bwd(const void* a, const void* b, void* maps, void* ga,
                  void* gb, int batch, int h, int w, const float* taps,
                  int window, float c1, float c2, int need_b,
                  void* stream) {
  if (bad_window(window)) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || h <= 0 || w <= 0) return (int)cudaSuccess;
  const Params p = make_params(taps, window, c1, c2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, batch);
  const int64_t plane = (int64_t)batch * h * w;
  ssim_partials_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(maps), h, w, p, need_b, plane);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssim_grad_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(maps), static_cast<float*>(ga),
      static_cast<float*>(gb), h, w, p, need_b, plane);
  return (int)cudaGetLastError();
}

const char* dsod_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
