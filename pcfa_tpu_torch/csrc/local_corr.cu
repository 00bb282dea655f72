// Patch correlation of two channels-last feature maps, forward and
// backward (df1, df2), for sm_90a.
//
// Replaces the Pallas kernels of pcfa_tpu/ops/pallas/local_corr.py:
// `_forward` (resident or DMA-streamed f2 slabs, one output channel per
// unrolled shift) and `_backward` (`_dgrad1_kernel` / `_dgrad2_kernel`
// over pre-gathered halo slabs, with XLA fallbacks for tiny maps and for
// patch^2 > 128). Here every size and patch <= 21 runs the kernels.
//
// Math, with R = (patch-1)/2 * stride, shift p = iy*patch + ix,
// dy = iy*stride - R (rows), dx = ix*stride - R (columns), zero padding:
//   out[b,y,x,p]  = sum_c f1[b,y,x,c] * f2[b,y+dy,x+dx,c] / C
//   df1[b,y,x,c]  = sum_p g[b,y,x,p] * f2[b,y+dy,x+dx,c] / C
//   df2[b,y,x,c]  = sum_p g[b,y-dy,x-dx,p] * f1[b,y-dy,x-dx,c] / C
// PWCNet uses patch 9, stride 1 (81 channels); FlowNetC patch 21,
// stride 2 (441 channels).
//
// Bound on the H100 (PWCNet at 384x1280, B = 1, bf16): the largest level
// (96x320, C = 32) reads 3.9 MB of features and writes 5.0 MB of output for
// 0.16 GFLOP; every level is memory-bound, a few microseconds each.
//
// Forward design. A block owns one output row, 32 columns and 8 shift rows
// (iy); a thread owns one (column, iy) and keeps the patch's dx sums in
// registers. Channels go in chunks of 16: the f1 row tile and the 8 f2
// rows it meets (with an R-column halo each side) are staged in shared
// memory with a padded cell stride (17 floats), so a warp's reads hit 32
// different banks. The results go out through shared memory, so each
// pixel's run of shift channels is written contiguously.
//
// Backward design. Gather form, no atomics: a thread owns one output
// element (pixel, channel) of df1 or df2; lanes of a warp take consecutive
// channels, so feature reads are coalesced and the cotangent is a
// broadcast. Both gradients go in one launch (grid.z picks which).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTW = 32;             // output columns per forward block
constexpr int kDY = 8;              // shift rows per forward block
constexpr int kCC = 16;             // channels per staged chunk
constexpr int kCS = kCC + 1;        // padded shared-memory cell stride
constexpr int kMaxPatch = 21;
constexpr int kMaxR = 20;
constexpr int kHalo = kTW + 2 * kMaxR;
constexpr int kBwdPix = 8;          // pixels per backward block (x 32 lanes)

__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kTW * kDY)
local_corr_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                      T* __restrict__ out, int H, int W, int C, int patch,
                      int stride, float inv_c) {
  __shared__ float s_f2[kDY * kHalo * kCS];
  __shared__ float s_f1[kTW * kCS];
  const int tx = threadIdx.x % kTW, ty = threadIdx.x / kTW;
  const int groups = (patch + kDY - 1) / kDY;
  const int b = blockIdx.z / groups;
  const int iy0 = (blockIdx.z % groups) * kDY;
  const int y = blockIdx.y, x0 = blockIdx.x * kTW;
  const int R = (patch - 1) / 2 * stride;
  const int halo = kTW + 2 * R;
  const int iy = iy0 + ty;
  const int64_t img = (int64_t)b * H * W;

  float acc[kMaxPatch];
#pragma unroll
  for (int i = 0; i < kMaxPatch; ++i) acc[i] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += kCC) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTW * kCC; i += blockDim.x) {
      const int px = i / kCC, cc = i - px * kCC;
      const int gx = x0 + px, gc = c0 + cc;
      s_f1[px * kCS + cc] =
          (gx < W && gc < C) ? load_f(f1, (img + (int64_t)y * W + gx) * C + gc)
                             : 0.0f;
    }
    for (int i = threadIdx.x; i < kDY * halo * kCC; i += blockDim.x) {
      const int r = i / (halo * kCC);
      const int rem = i - r * halo * kCC;
      const int hx = rem / kCC, cc = rem - hx * kCC;
      const int yy = y + (iy0 + r) * stride - R;
      const int xx = x0 - R + hx, gc = c0 + cc;
      float v = 0.0f;
      if (iy0 + r < patch && yy >= 0 && yy < H && xx >= 0 && xx < W && gc < C)
        v = load_f(f2, (img + (int64_t)yy * W + xx) * C + gc);
      s_f2[(r * kHalo + hx) * kCS + cc] = v;
    }
    __syncthreads();
    if (iy < patch) {
      const float* row = s_f2 + ty * kHalo * kCS;
#pragma unroll
      for (int cc = 0; cc < kCC; ++cc) {
        const float a = s_f1[tx * kCS + cc];
#pragma unroll
        for (int ix = 0; ix < kMaxPatch; ++ix)
          if (ix < patch) acc[ix] += a * row[(tx + ix * stride) * kCS + cc];
      }
    }
  }

  // stage the block's results as [column][iy - iy0][ix] and write each
  // column's contiguous run of shift channels
  const int rows = min(kDY, patch - iy0);
  const int run = rows * patch;
  const int ostride = kDY * patch + 1;
  __syncthreads();
  if (iy < patch) {
#pragma unroll
    for (int ix = 0; ix < kMaxPatch; ++ix)
      if (ix < patch) s_f2[tx * ostride + ty * patch + ix] = acc[ix];
  }
  __syncthreads();
  const int P2 = patch * patch;
  for (int i = threadIdx.x; i < kTW * run; i += blockDim.x) {
    const int px = i / run, k = i - px * run;
    const int gx = x0 + px;
    if (gx < W)
      store_f(out, (img + (int64_t)y * W + gx) * P2 + iy0 * patch + k,
              s_f2[px * ostride + k] * inv_c);
  }
}

// grid.z = (b * c_chunks + chunk) * 2 + which; which 0: df1, 1: df2
template <typename T>
__global__ void __launch_bounds__(32 * kBwdPix)
local_corr_bwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                      const T* __restrict__ g, T* __restrict__ df1,
                      T* __restrict__ df2, int H, int W, int C, int patch,
                      int stride, float inv_c) {
  const int which = blockIdx.z & 1;
  const int c_chunks = (C + 31) / 32;
  const int bc = blockIdx.z >> 1;
  const int b = bc / c_chunks;
  const int c = (bc - b * c_chunks) * 32 + threadIdx.x;
  const int x = blockIdx.x * kBwdPix + threadIdx.y;
  const int y = blockIdx.y;
  if (x >= W || c >= C) return;
  const int R = (patch - 1) / 2 * stride;
  const int P2 = patch * patch;
  const int64_t img = (int64_t)b * H * W;
  float acc = 0.0f;
  if (which == 0) {
    const int64_t gp = (img + (int64_t)y * W + x) * P2;
    for (int iy = 0; iy < patch; ++iy) {
      const int yy = y + iy * stride - R;
      if (yy < 0 || yy >= H) continue;
      for (int ix = 0; ix < patch; ++ix) {
        const int xx = x + ix * stride - R;
        if (xx < 0 || xx >= W) continue;
        acc += load_f(g, gp + iy * patch + ix) *
               load_f(f2, (img + (int64_t)yy * W + xx) * C + c);
      }
    }
    store_f(df1, (img + (int64_t)y * W + x) * C + c, acc * inv_c);
  } else {
    for (int iy = 0; iy < patch; ++iy) {
      const int yy = y - (iy * stride - R);
      if (yy < 0 || yy >= H) continue;
      for (int ix = 0; ix < patch; ++ix) {
        const int xx = x - (ix * stride - R);
        if (xx < 0 || xx >= W) continue;
        const int64_t pix = img + (int64_t)yy * W + xx;
        acc += load_f(g, pix * P2 + iy * patch + ix) *
               load_f(f1, pix * C + c);
      }
    }
    store_f(df2, (img + (int64_t)y * W + x) * C + c, acc * inv_c);
  }
}

bool valid_args(int dtype, int B, int H, int W, int C, int patch,
                int stride) {
  return (dtype == 0 || dtype == 1) && B > 0 && H > 0 && W > 0 && C > 0 &&
         patch >= 1 && patch % 2 == 1 && patch <= kMaxPatch && stride >= 1 &&
         (patch - 1) / 2 * stride <= kMaxR && H <= 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for every tensor. f1, f2: (B, H, W, C);
// out: (B, H, W, patch^2), fully written. Returns cudaGetLastError().
extern "C" int pcfa_local_corr_fwd(int dtype, const void* f1, const void* f2,
                                   void* out, int B, int H, int W, int C,
                                   int patch, int stride, void* stream) {
  if (!valid_args(dtype, B, H, W, C, patch, stride))
    return (int)cudaErrorInvalidValue;
  const int groups = (patch + kDY - 1) / kDY;
  const dim3 grid((W + kTW - 1) / kTW, H, B * groups);
  const dim3 block(kTW * kDY);
  const float inv_c = 1.0f / (float)C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    local_corr_fwd_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(f1), static_cast<const float*>(f2),
        static_cast<float*>(out), H, W, C, patch, stride, inv_c);
  else
    local_corr_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(f1),
        static_cast<const __nv_bfloat16*>(f2),
        static_cast<__nv_bfloat16*>(out), H, W, C, patch, stride, inv_c);
  return (int)cudaGetLastError();
}

// g: (B, H, W, patch^2) cotangent of `out`; df1, df2: (B, H, W, C), fully
// written.
extern "C" int pcfa_local_corr_bwd(int dtype, const void* f1, const void* f2,
                                   const void* g, void* df1, void* df2, int B,
                                   int H, int W, int C, int patch, int stride,
                                   void* stream) {
  if (!valid_args(dtype, B, H, W, C, patch, stride))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kBwdPix - 1) / kBwdPix, H, B * ((C + 31) / 32) * 2);
  const dim3 block(32, kBwdPix);
  const float inv_c = 1.0f / (float)C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    local_corr_bwd_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(f1), static_cast<const float*>(f2),
        static_cast<const float*>(g), static_cast<float*>(df1),
        static_cast<float*>(df2), H, W, C, patch, stride, inv_c);
  else
    local_corr_bwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(f1),
        static_cast<const __nv_bfloat16*>(f2),
        static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(df1), static_cast<__nv_bfloat16*>(df2),
        H, W, C, patch, stride, inv_c);
  return (int)cudaGetLastError();
}
