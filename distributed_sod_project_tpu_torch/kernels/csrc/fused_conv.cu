// Stride-1, odd-kernel, dilated 2-D convolution over the channel concat
// of up to four NHWC parts (the concat is never built), with the f32
// accumulator run through a none / bias / inference-BN epilogue and an
// optional ReLU, in one pass.  Forward only.
//
// Replaces distributed_sod_project_tpu/pallas/fused_conv.py _fwd_kernel
// (pallas_call site _call_fwd).  Epilogue order, as _epilogue there:
//   c = round_to_T(acc)                               (the conv output)
//   bias: y = round_to_T(c + bias)                    (bias pre-rounded to T)
//   bn:   y = round_to_T((c - mean) * mul + beta)     (f32; mul folded outside)
//   relu: y = max(y, 0)
//
// Implicit GEMM: M = B*H*W output pixels, N = Cout, K = kh*kw*sum(Cin)
// in (tap, part, channel) order, which is exactly the HWIO weight read
// as a row-major K x N matrix.  A block owns a 64x64 output tile and
// walks K tap by tap, part by part, 32 channels at a time: each A tile
// is read straight from the part at its own channel offset (zero for
// taps in the padding), so no im2col buffer and no concat exists.
//
// Bound on the card: operations for the wide 3x3 layers (the 64..512
// channel VGG/decoder convs run hundreds of FLOPs per byte moved, above
// the H100's ~295 FLOP/byte bf16 ridge), bytes for the narrow ones
// (3 input channels, the 1-channel head).  The bf16 path therefore runs
// on the tensor cores (WMMA 16x16x16, f32 accumulate): four warps, each
// a 32x32 sub-tile, tiles staged in shared memory with 16-byte loads
// where the channel count allows.  The f32 path (parity checks; the
// served arms compute in bf16) is a SIMT tile of 8x4 outputs a thread
// with fmaf accumulation.  Neither pipelines its loads yet (no cp.async
// or TMA ring): a later, performance-minded change starts there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxParts = 4;
constexpr int BM = 64, BN = 64, BK = 32, kThreads = 128;

struct Parts {
  const void* ptr[kMaxParts];
  int ch[kMaxParts];   // channels of each part
  int off[kMaxParts];  // its channel offset in the concat
  int n;
};

struct Geo {
  int H, W, cin, cout, kh, kw, dil;
  int64_t m;  // B*H*W
};

struct Epi {
  const float* mean;
  const float* mul;
  const float* bias;
  int mode;  // 0 none, 1 bias, 2 bn
  int relu;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ T epilogue(float acc, int n, const Epi& e) {
  const float c = to_f(from_f<T>(acc));
  float y = c;
  if (e.mode == 1) {
    y = to_f(from_f<T>(__fadd_rn(c, e.bias[n])));
  } else if (e.mode == 2) {
    y = to_f(from_f<T>(__fadd_rn(
        __fmul_rn(__fsub_rn(c, e.mean[n]), e.mul[n]), e.bias[n])));
  }
  if (e.relu) y = y < 0.f ? 0.f : y;  // NaN propagates, as jnp.maximum
  return from_f<T>(y);
}

// Pixel coordinates of the block's BM output rows (b = -1: past M).
__device__ __forceinline__ void row_coords(int64_t m0, const Geo& g, int* sb,
                                           int* sy, int* sx) {
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const int64_t m = m0 + r;
    if (m < g.m) {
      const int64_t hw = (int64_t)g.H * g.W;
      sb[r] = (int)(m / hw);
      const int rem = (int)(m % hw);
      sy[r] = rem / g.W;
      sx[r] = rem % g.W;
    } else {
      sb[r] = -1;
    }
  }
}

// Offset of input pixel (row r shifted by dy, dx) in a part with cp
// channels, or -1 when it lies in the zero padding or past M.
__device__ __forceinline__ int64_t pix_off(int r, int dy, int dx,
                                           const int* sb, const int* sy,
                                           const int* sx, const Geo& g,
                                           int cp) {
  const int b = sb[r];
  const int y = sy[r] + dy, x = sx[r] + dx;
  if (b < 0 || y < 0 || y >= g.H || x < 0 || x >= g.W) return -1;
  return (((int64_t)b * g.H + y) * g.W + x) * cp;
}

// ---------------------------------------------------------------- bf16

constexpr int LDA = BK + 8;  // 80-byte rows: 16-byte aligned, fewer conflicts
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;

__global__ void __launch_bounds__(kThreads)
conv_bf16_kernel(Parts parts, const bf16* __restrict__ w, Epi epi,
                 bf16* __restrict__ out, Geo g) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 As[BM * LDA];
  __shared__ __align__(32) bf16 Bs[BK * LDB];
  __shared__ __align__(32) float Cs[BM * LDC];
  __shared__ int sb[BM], sy[BM], sx[BM];

  const int tid = threadIdx.x;
  const int warp = tid / 32, wm = warp / 2, wn = warp % 2;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  row_coords(m0, g, sb, sy, sx);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const bool w_vec = (g.cout % 8 == 0) &&
                     ((reinterpret_cast<uintptr_t>(w) & 15) == 0);
  const int ph = g.dil * (g.kh / 2), pw = g.dil * (g.kw / 2);
  __syncthreads();

  for (int u = 0; u < g.kh; ++u) {
    for (int v = 0; v < g.kw; ++v) {
      const int dy = u * g.dil - ph, dx = v * g.dil - pw;
      for (int p = 0; p < parts.n; ++p) {
        const bf16* src = static_cast<const bf16*>(parts.ptr[p]);
        const int cp = parts.ch[p];
        const bool a_vec = (cp % 8 == 0) &&
                           ((reinterpret_cast<uintptr_t>(src) & 15) == 0);
        const int64_t kbase = (int64_t)(u * g.kw + v) * g.cin + parts.off[p];
        for (int c0 = 0; c0 < cp; c0 += BK) {
          // A tile: BM pixels x BK channels of this part at this tap.
          if (a_vec) {
            for (int idx = tid; idx < BM * BK / 8; idx += kThreads) {
              const int r = idx >> 2, c = c0 + (idx & 3) * 8;
              uint4 val = make_uint4(0, 0, 0, 0);
              const int64_t o = pix_off(r, dy, dx, sb, sy, sx, g, cp);
              if (o >= 0 && c < cp)
                val = *reinterpret_cast<const uint4*>(src + o + c);
              *reinterpret_cast<uint4*>(&As[r * LDA + (idx & 3) * 8]) = val;
            }
          } else {
            for (int idx = tid; idx < BM * BK; idx += kThreads) {
              const int r = idx >> 5, cc = idx & 31, c = c0 + cc;
              bf16 val = __float2bfloat16_rn(0.f);
              const int64_t o = pix_off(r, dy, dx, sb, sy, sx, g, cp);
              if (o >= 0 && c < cp) val = src[o + c];
              As[r * LDA + cc] = val;
            }
          }
          // B tile: BK weight rows x BN output channels.
          if (w_vec) {
            for (int idx = tid; idx < BK * BN / 8; idx += kThreads) {
              const int kr = idx >> 3, n = n0 + (idx & 7) * 8;
              uint4 val = make_uint4(0, 0, 0, 0);
              if (c0 + kr < cp && n < g.cout)
                val = *reinterpret_cast<const uint4*>(
                    w + (kbase + c0 + kr) * g.cout + n);
              *reinterpret_cast<uint4*>(&Bs[kr * LDB + (idx & 7) * 8]) = val;
            }
          } else {
            for (int idx = tid; idx < BK * BN; idx += kThreads) {
              const int kr = idx >> 6, nc = idx & 63, n = n0 + nc;
              bf16 val = __float2bfloat16_rn(0.f);
              if (c0 + kr < cp && n < g.cout)
                val = w[(kbase + c0 + kr) * g.cout + n];
              Bs[kr * LDB + nc] = val;
            }
          }
          __syncthreads();
          for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
                a[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
                b[2];
            for (int i = 0; i < 2; ++i)
              wmma::load_matrix_sync(a[i], &As[(wm * 32 + i * 16) * LDA + kk],
                                     LDA);
            for (int j = 0; j < 2; ++j)
              wmma::load_matrix_sync(b[j], &Bs[kk * LDB + wn * 32 + j * 16],
                                     LDB);
            for (int i = 0; i < 2; ++i)
              for (int j = 0; j < 2; ++j)
                wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
          }
          __syncthreads();
        }
      }
    }
  }

  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * LDC + wn * 32 + j * 16],
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN, nc = idx % BN, n = n0 + nc;
    const int64_t m = m0 + r;
    if (m < g.m && n < g.cout)
      out[m * g.cout + n] = epilogue<bf16>(Cs[r * LDC + nc], n, epi);
  }
}

// ----------------------------------------------------------------- f32

__global__ void __launch_bounds__(kThreads)
conv_f32_kernel(Parts parts, const float* __restrict__ w, Epi epi,
                float* __restrict__ out, Geo g) {
  __shared__ float As[BK][BM + 1];  // k-major; +1 spreads the stores
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ int sb[BM], sy[BM], sx[BM];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  row_coords(m0, g, sb, sy, sx);
  float acc[8][4];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int ph = g.dil * (g.kh / 2), pw = g.dil * (g.kw / 2);
  __syncthreads();

  for (int u = 0; u < g.kh; ++u) {
    for (int v = 0; v < g.kw; ++v) {
      const int dy = u * g.dil - ph, dx = v * g.dil - pw;
      for (int p = 0; p < parts.n; ++p) {
        const float* src = static_cast<const float*>(parts.ptr[p]);
        const int cp = parts.ch[p];
        const int64_t kbase = (int64_t)(u * g.kw + v) * g.cin + parts.off[p];
        for (int c0 = 0; c0 < cp; c0 += BK) {
          for (int idx = tid; idx < BM * BK; idx += kThreads) {
            const int r = idx >> 5, cc = idx & 31, c = c0 + cc;
            const int64_t o = pix_off(r, dy, dx, sb, sy, sx, g, cp);
            As[cc][r] = (o >= 0 && c < cp) ? src[o + c] : 0.f;
          }
          for (int idx = tid; idx < BK * BN; idx += kThreads) {
            const int kr = idx >> 6, nc = idx & 63, n = n0 + nc;
            Bs[kr][nc] = (c0 + kr < cp && n < g.cout)
                             ? w[(kbase + c0 + kr) * g.cout + n]
                             : 0.f;
          }
          __syncthreads();
          for (int k = 0; k < BK; ++k) {
            const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
            for (int i = 0; i < 8; ++i) {
              const float a = As[k][ty * 8 + i];
              acc[i][0] = fmaf(a, bv.x, acc[i][0]);
              acc[i][1] = fmaf(a, bv.y, acc[i][1]);
              acc[i][2] = fmaf(a, bv.z, acc[i][2]);
              acc[i][3] = fmaf(a, bv.w, acc[i][3]);
            }
          }
          __syncthreads();
        }
      }
    }
  }

  for (int i = 0; i < 8; ++i) {
    const int64_t m = m0 + ty * 8 + i;
    if (m >= g.m) continue;
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < g.cout) out[m * g.cout + n] = epilogue<float>(acc[i][j], n, epi);
    }
  }
}

}  // namespace

extern "C" {

// parts p0..p3 (the first n_parts used) are [B,H,W,c_i] in `dtype`
// (0 = float32, 1 = bfloat16); w is [kh,kw,sum c_i,cout] in the same
// dtype; mean/mul/bias are float32 [cout] (null where the mode does not
// read them); out is [B,H,W,cout].  Returns cudaGetLastError().
int dsod_fused_conv(const void* p0, const void* p1, const void* p2,
                    const void* p3, int c0, int c1, int c2, int c3,
                    int n_parts, const void* w, const void* mean,
                    const void* mul, const void* bias, void* out, int b,
                    int h, int wd, int cout, int kh, int kw, int dil,
                    int mode, int relu, int dtype, void* stream) {
  if (n_parts < 1 || n_parts > kMaxParts) return (int)cudaErrorInvalidValue;
  Parts parts;
  const void* ptrs[kMaxParts] = {p0, p1, p2, p3};
  const int chs[kMaxParts] = {c0, c1, c2, c3};
  int off = 0;
  for (int i = 0; i < kMaxParts; ++i) {
    parts.ptr[i] = ptrs[i];
    parts.ch[i] = i < n_parts ? chs[i] : 0;
    parts.off[i] = off;
    off += parts.ch[i];
  }
  parts.n = n_parts;
  Geo g{h, wd, off, cout, kh, kw, dil, (int64_t)b * h * wd};
  Epi e{static_cast<const float*>(mean), static_cast<const float*>(mul),
        static_cast<const float*>(bias), mode, relu};
  if (g.m == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((g.m + BM - 1) / BM), (cout + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    conv_bf16_kernel<<<grid, kThreads, 0, s>>>(
        parts, static_cast<const bf16*>(w), e, static_cast<bf16*>(out), g);
  else
    conv_f32_kernel<<<grid, kThreads, 0, s>>>(
        parts, static_cast<const float*>(w), e, static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}

const char* dsod_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
