// Weight gradient of the stride-1, odd-kernel, dilated fused conv over up
// to four NHWC parts (the concat is never built):
//   dw[u, v, c, n] = sum over b, y, x of
//                    x_cat[b, y + u*dil - ph, x + v*dil - pw, c] * g[b, y, x, n]
// with zero outside the image, accumulated in f32 and written in f32.
//
// Replaces distributed_sod_project_tpu/pallas/fused_conv.py _dw_kernel
// (pallas_call site _call_dw), which walks the batch on a sequential grid
// and accumulates into one resident output block.
//
// Implicit GEMM with M = kh*kw*sum(Cin) rows (tap, part, channel: the HWIO
// layout read as a row-major M x N matrix), N = Cout and the reduction
// over K = B*H*W pixels.  K is huge (819200 at the 320-px layers of a
// batch-8 step) while the output is small (9*64 x 64 at the widest maps),
// so one block per output tile would leave most of the 132 SMs idle.  The
// pixel range is therefore split: a block owns a 64-row x 64-column output
// tile and one contiguous slice of the pixels, writes its f32 partial tile,
// and a second launch sums the slices in a fixed order, so repeated runs
// agree bitwise (no atomics).  A row tile never straddles a tap or a part:
// it is up to 64 channels of one part at one tap, read straight from that
// part at the tap's pixel shift.
//
// Bound on the card: operations at the wide layers (hundreds of FLOPs per
// byte), bytes at the narrow ones (the 3-channel first layer, the
// 1-channel head).  bf16 runs on the tensor cores (WMMA 16x16x16 with f32
// accumulation; the pixel tile is the WMMA k dimension, so the x tile is
// loaded as a column-major A); f32 (parity checks) is a SIMT tile.  No
// load pipelining yet, and the narrow layers waste most of a 64-wide tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxParts = 4;
constexpr int BR = 64;  // dw rows per tile: channels of one part at one tap
constexpr int BN = 64;  // dw columns per tile: output channels
constexpr int BP = 32;  // pixels per step of the reduction loop
constexpr int kThreads = 128;

struct Parts {
  const void* ptr[kMaxParts];
  int ch[kMaxParts];   // channels of each part
  int off[kMaxParts];  // its channel offset in the concat
  int n;
};

struct Geo {
  int H, W, cin, cout, kh, kw, dil;
  int64_t m;             // B*H*W
  int64_t px_per_split;  // pixels each blockIdx.z slice reduces over
};

// Row tile t -> (tap, part, first channel): tap-major, then part, then
// 64-channel chunk, so every dw row is covered by exactly one tile.
struct RowTile {
  int tap, part, c0;
};

__device__ __forceinline__ RowTile row_tile(int t, const Parts& parts) {
  int per_tap = 0;
  for (int p = 0; p < parts.n; ++p) per_tap += (parts.ch[p] + BR - 1) / BR;
  RowTile rt;
  rt.tap = t / per_tap;
  int rem = t % per_tap;
  rt.part = 0;
  for (int p = 0; p < parts.n; ++p) {
    const int chunks = (parts.ch[p] + BR - 1) / BR;
    if (rem < chunks) {
      rt.part = p;
      break;
    }
    rem -= chunks;
  }
  rt.c0 = rem * BR;
  return rt;
}

// Pixel coordinates of the BP pixels starting at m0 (b = -1: past the
// slice), shared by the block.
__device__ __forceinline__ void pixel_coords(int64_t m0, int64_t m_end,
                                             const Geo& g, int* sb, int* sy,
                                             int* sx) {
  for (int r = threadIdx.x; r < BP; r += kThreads) {
    const int64_t m = m0 + r;
    if (m < m_end) {
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

// Offset of pixel r shifted by (dy, dx) in an NHWC map with cp channels,
// or -1 in the zero padding or past the slice.
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

constexpr int LDA = BR + 8;  // As is [pixel][channel]
constexpr int LDG = BN + 8;  // Gs is [pixel][output channel]
constexpr int LDC = BN + 4;

__global__ void __launch_bounds__(kThreads)
dw_bf16_kernel(Parts parts, const bf16* __restrict__ gout,
               float* __restrict__ out, Geo g) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 As[BP * LDA];
  __shared__ __align__(32) bf16 Gs[BP * LDG];
  __shared__ __align__(32) float Cs[BR * LDC];
  __shared__ int sb[BP], sy[BP], sx[BP];

  const int tid = threadIdx.x;
  const int warp = tid / 32, wm = warp / 2, wn = warp % 2;
  const RowTile rt = row_tile(blockIdx.x, parts);
  const int n0 = blockIdx.y * BN;
  const int64_t m_begin = (int64_t)blockIdx.z * g.px_per_split;
  const int64_t m_end =
      m_begin + g.px_per_split < g.m ? m_begin + g.px_per_split : g.m;
  const int u = rt.tap / g.kw, v = rt.tap % g.kw;
  const int dy = u * g.dil - g.dil * (g.kh / 2);
  const int dx = v * g.dil - g.dil * (g.kw / 2);
  const bf16* src = static_cast<const bf16*>(parts.ptr[rt.part]);
  const int cp = parts.ch[rt.part];
  const bool a_vec = (cp % 8 == 0) &&
                     ((reinterpret_cast<uintptr_t>(src) & 15) == 0);
  const bool g_vec = (g.cout % 8 == 0) &&
                     ((reinterpret_cast<uintptr_t>(gout) & 15) == 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int64_t m0 = m_begin; m0 < m_end; m0 += BP) {
    pixel_coords(m0, m_end, g, sb, sy, sx);
    __syncthreads();
    // A: BP pixels x BR channels of the part, at the tap's shift.
    if (a_vec) {
      for (int idx = tid; idx < BP * BR / 8; idx += kThreads) {
        const int r = idx >> 3, c = rt.c0 + (idx & 7) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        const int64_t o = pix_off(r, dy, dx, sb, sy, sx, g, cp);
        if (o >= 0 && c < cp)
          val = *reinterpret_cast<const uint4*>(src + o + c);
        *reinterpret_cast<uint4*>(&As[r * LDA + (idx & 7) * 8]) = val;
      }
    } else {
      for (int idx = tid; idx < BP * BR; idx += kThreads) {
        const int r = idx / BR, cc = idx % BR, c = rt.c0 + cc;
        bf16 val = __float2bfloat16_rn(0.f);
        const int64_t o = pix_off(r, dy, dx, sb, sy, sx, g, cp);
        if (o >= 0 && c < cp) val = src[o + c];
        As[r * LDA + cc] = val;
      }
    }
    // G: the same BP pixels (unshifted) x BN output channels.
    if (g_vec) {
      for (int idx = tid; idx < BP * BN / 8; idx += kThreads) {
        const int r = idx >> 3, n = n0 + (idx & 7) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (sb[r] >= 0 && n < g.cout)
          val = *reinterpret_cast<const uint4*>(gout + (m0 + r) * g.cout + n);
        *reinterpret_cast<uint4*>(&Gs[r * LDG + (idx & 7) * 8]) = val;
      }
    } else {
      for (int idx = tid; idx < BP * BN; idx += kThreads) {
        const int r = idx / BN, nc = idx % BN, n = n0 + nc;
        bf16 val = __float2bfloat16_rn(0.f);
        if (sb[r] >= 0 && n < g.cout) val = gout[(m0 + r) * g.cout + n];
        Gs[r * LDG + nc] = val;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < BP; kk += 16) {
      // A (rows = dw rows, k = pixels) is As read column-major.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[kk * LDA + wm * 32 + i * 16], LDA);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Gs[kk * LDG + wn * 32 + j * 16], LDG);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * LDC + wn * 32 + j * 16],
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  const int64_t rows = (int64_t)g.kh * g.kw * g.cin;
  float* dst = out + (int64_t)blockIdx.z * rows * g.cout;
  const int64_t row0 = (int64_t)rt.tap * g.cin + parts.off[rt.part] + rt.c0;
  for (int idx = tid; idx < BR * BN; idx += kThreads) {
    const int r = idx / BN, nc = idx % BN, n = n0 + nc;
    if (rt.c0 + r < cp && n < g.cout)
      dst[(row0 + r) * g.cout + n] = Cs[r * LDC + nc];
  }
}

// ----------------------------------------------------------------- f32

__global__ void __launch_bounds__(kThreads)
dw_f32_kernel(Parts parts, const float* __restrict__ gout,
              float* __restrict__ out, Geo g) {
  __shared__ float As[BP][BR + 1];
  __shared__ __align__(16) float Gs[BP][BN];
  __shared__ int sb[BP], sy[BP], sx[BP];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const RowTile rt = row_tile(blockIdx.x, parts);
  const int n0 = blockIdx.y * BN;
  const int64_t m_begin = (int64_t)blockIdx.z * g.px_per_split;
  const int64_t m_end =
      m_begin + g.px_per_split < g.m ? m_begin + g.px_per_split : g.m;
  const int u = rt.tap / g.kw, v = rt.tap % g.kw;
  const int dy = u * g.dil - g.dil * (g.kh / 2);
  const int dx = v * g.dil - g.dil * (g.kw / 2);
  const float* src = static_cast<const float*>(parts.ptr[rt.part]);
  const int cp = parts.ch[rt.part];

  float acc[8][4];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t m0 = m_begin; m0 < m_end; m0 += BP) {
    pixel_coords(m0, m_end, g, sb, sy, sx);
    __syncthreads();
    for (int idx = tid; idx < BP * BR; idx += kThreads) {
      const int r = idx / BR, cc = idx % BR, c = rt.c0 + cc;
      const int64_t o = pix_off(r, dy, dx, sb, sy, sx, g, cp);
      As[r][cc] = (o >= 0 && c < cp) ? src[o + c] : 0.f;
    }
    for (int idx = tid; idx < BP * BN; idx += kThreads) {
      const int r = idx / BN, nc = idx % BN, n = n0 + nc;
      Gs[r][nc] = (sb[r] >= 0 && n < g.cout) ? gout[(m0 + r) * g.cout + n]
                                             : 0.f;
    }
    __syncthreads();
    for (int p = 0; p < BP; ++p) {
      const float4 gv = *reinterpret_cast<const float4*>(&Gs[p][tx * 4]);
      for (int i = 0; i < 8; ++i) {
        const float a = As[p][ty * 8 + i];
        acc[i][0] = fmaf(a, gv.x, acc[i][0]);
        acc[i][1] = fmaf(a, gv.y, acc[i][1]);
        acc[i][2] = fmaf(a, gv.z, acc[i][2]);
        acc[i][3] = fmaf(a, gv.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

  const int64_t rows = (int64_t)g.kh * g.kw * g.cin;
  float* dst = out + (int64_t)blockIdx.z * rows * g.cout;
  const int64_t row0 = (int64_t)rt.tap * g.cin + parts.off[rt.part] + rt.c0;
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    if (rt.c0 + r >= cp) continue;
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < g.cout) dst[(row0 + r) * g.cout + n] = acc[i][j];
    }
  }
}

// out[i] = sum over s of partial[s][i], s in order: the fixed-order
// cross-slice reduction.
__global__ void dw_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out, int64_t n,
                                 int splits) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partial[(int64_t)k * n + i];
    out[i] = s;
  }
}

}  // namespace

extern "C" {

// parts p0..p3 (the first n_parts used) are [B,H,W,c_i] in `dtype`
// (0 = float32, 1 = bfloat16); g is [B,H,W,cout] in the same dtype; out
// is [kh,kw,sum c_i,cout] float32.  The pixels are reduced in `splits`
// slices of px_per_split each: with splits > 1, `partial` holds
// splits * kh*kw*sum(c_i) * cout floats of scratch and a second launch
// sums them into out; with splits == 1 the tiles write out directly.
// Returns cudaGetLastError().
int dsod_conv_dw(const void* p0, const void* p1, const void* p2,
                 const void* p3, int c0, int c1, int c2, int c3, int n_parts,
                 const void* g, void* partial, void* out, int b, int h,
                 int wd, int cout, int kh, int kw, int dil, int splits,
                 long long px_per_split, int dtype, void* stream) {
  if (n_parts < 1 || n_parts > kMaxParts || splits < 1)
    return (int)cudaErrorInvalidValue;
  Parts parts;
  const void* ptrs[kMaxParts] = {p0, p1, p2, p3};
  const int chs[kMaxParts] = {c0, c1, c2, c3};
  int off = 0, per_tap = 0;
  for (int i = 0; i < kMaxParts; ++i) {
    parts.ptr[i] = ptrs[i];
    parts.ch[i] = i < n_parts ? chs[i] : 0;
    parts.off[i] = off;
    off += parts.ch[i];
    per_tap += (parts.ch[i] + BR - 1) / BR;
  }
  parts.n = n_parts;
  Geo geo{h, wd, off, cout, kh, kw, dil, (int64_t)b * h * wd,
          (int64_t)px_per_split};
  const int64_t n_out = (int64_t)kh * kw * off * cout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_out == 0) return (int)cudaSuccess;
  if (geo.m == 0) return (int)cudaMemsetAsync(out, 0, n_out * 4, s);
  float* tiles_out =
      static_cast<float*>(splits > 1 ? partial : out);
  const dim3 grid((unsigned)(per_tap * kh * kw), (cout + BN - 1) / BN,
                  (unsigned)splits);
  if (dtype == 1)
    dw_bf16_kernel<<<grid, kThreads, 0, s>>>(
        parts, static_cast<const bf16*>(g), tiles_out, geo);
  else
    dw_f32_kernel<<<grid, kThreads, 0, s>>>(
        parts, static_cast<const float*>(g), tiles_out, geo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int64_t want = (n_out + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  dw_reduce_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n_out,
      splits);
  return (int)cudaGetLastError();
}

const char* dsod_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
