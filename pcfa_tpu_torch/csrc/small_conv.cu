// Direct SAME convolution for small channel counts, forward and input
// gradient (dx), for sm_90a.
//
// Replaces the Pallas kernel of pcfa_tpu/ops/pallas/small_conv.py:
// `_forward` (shifted-slab block-Toeplitz matmuls on NHCW) and its VJP
// `_bwd`, which reuses `_forward` with flipped, channel-transposed weights
// on a zero-dilated cotangent for stride 2. Semantics are torch's
// Conv2d(k, stride=s, padding=k//2) on NCHW: stride 1 or 2, k 3/5/7,
// output ceil(H/s) x ceil(W/s) for every H and W (odd sizes included),
// fused bias and none/relu/leaky(0.1) epilogue, float32 accumulation.
//
// Bound on the H100 (RAFT at 376x1248, B = 2 pairs, bf16): the fnet stem
// (4 images, 3 -> 64, k7 s2, 188x624 out) moves ~71 MB and does 8.8 GFLOP;
// one fnet layer1 conv (64 -> 64, k3 s1 at 188x624) moves ~120 MB and does
// 34.6 GFLOP. Against HBM (3.35 TB/s) and the bf16 tensor-core peak both
// are memory-bound (~21 us and ~36 us). This kernel runs on the CUDA cores
// in float32 FMA (67 TFLOP/s peak), so its own ceiling is the FLOPs, not
// the bytes; tensor cores, TMA and tiling are later work.
//
// Design. A block computes a 16x16 tile of output pixels (one per thread)
// for OCT output channels held in registers. Input channels are staged in
// chunks of 4 as a zero-padded (15*s + k)^2 halo tile in shared memory,
// with the matching weights laid out [chunk][tap][OCT] so a thread reads
// them as float4 broadcasts. The dx kernel is the transposed conv in
// gather form: each input pixel sums the cotangent taps of its stride
// parity class only, so stride 2 needs no zero-dilated cotangent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kChunk = 4;  // channels staged per pass

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

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// out[b, o, oy, ox] = act(bias[o] + sum_{c,ky,kx}
//     x[b, c, oy*S - P + ky, ox*S - P + kx] * w[o, c, ky, kx])
template <typename T, int K, int S, int OCT>
__global__ void __launch_bounds__(kThreads)
conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ bias, T* __restrict__ out, int C_in,
                int H, int W, int C_out, int Ho, int Wo, int act) {
  constexpr int P = K / 2;
  constexpr int IT = (kTile - 1) * S + K;
  __shared__ float s_in[kChunk][IT][IT];
  __shared__ __align__(16) float s_w[kChunk][K * K][OCT];

  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const int groups = (C_out + OCT - 1) / OCT;
  const int b = blockIdx.z / groups;
  const int oc0 = (blockIdx.z % groups) * OCT;
  const int ox = blockIdx.x * kTile + tx, oy = blockIdx.y * kTile + ty;
  const int iy0 = blockIdx.y * kTile * S - P;
  const int ix0 = blockIdx.x * kTile * S - P;
  const T* xb = x + (int64_t)b * C_in * H * W;

  float acc[OCT];
#pragma unroll
  for (int o = 0; o < OCT; ++o) acc[o] = 0.0f;

  for (int c0 = 0; c0 < C_in; c0 += kChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * IT * IT; i += kThreads) {
      const int c = i / (IT * IT);
      const int r = i - c * IT * IT;
      const int yy = r / IT, xx = r - (r / IT) * IT;
      const int gy = iy0 + yy, gx = ix0 + xx, gc = c0 + c;
      float v = 0.0f;
      if (gc < C_in && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = load_f(xb, ((int64_t)gc * H + gy) * W + gx);
      s_in[c][yy][xx] = v;
    }
    for (int i = threadIdx.x; i < kChunk * K * K * OCT; i += kThreads) {
      const int o = i % OCT;
      const int t = (i / OCT) % (K * K);
      const int c = i / (OCT * K * K);
      const int go = oc0 + o, gc = c0 + c;
      s_w[c][t][o] = (go < C_out && gc < C_in)
                         ? load_f(w, ((int64_t)go * C_in + gc) * K * K + t)
                         : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const float v = s_in[c][ty * S + ky][tx * S + kx];
          const float4* wv =
              reinterpret_cast<const float4*>(&s_w[c][ky * K + kx][0]);
#pragma unroll
          for (int q = 0; q < OCT / 4; ++q) {
            const float4 w4 = wv[q];
            acc[4 * q + 0] += v * w4.x;
            acc[4 * q + 1] += v * w4.y;
            acc[4 * q + 2] += v * w4.z;
            acc[4 * q + 3] += v * w4.w;
          }
        }
      }
    }
  }

  if (ox < Wo && oy < Ho) {
#pragma unroll
    for (int o = 0; o < OCT; ++o) {
      const int go = oc0 + o;
      if (go >= C_out) continue;
      float v = acc[o] + (bias != nullptr ? load_f(bias, go) : 0.0f);
      if (act == 1) v = fmaxf(v, 0.0f);
      else if (act == 2) v = v > 0.0f ? v : 0.1f * v;
      store_f(out, (((int64_t)b * C_out + go) * Ho + oy) * Wo + ox, v);
    }
  }
}

// dx[b, c, y, x] = sum_{o, ky, kx : y + P - ky = S*oy, x + P - kx = S*ox}
//     g[b, o, oy, ox] * w[o, c, ky, kx]   (g zero outside Ho x Wo)
template <typename T, int K, int S, int ICT>
__global__ void __launch_bounds__(kThreads)
conv_dx_kernel(const T* __restrict__ g, const T* __restrict__ w,
               T* __restrict__ dx, int C_in, int H, int W, int C_out, int Ho,
               int Wo) {
  constexpr int P = K / 2;
  constexpr int GT = (kTile - 1 + K - 1) / S + 2;
  constexpr int NT = (K + S - 1) / S;  // taps per parity class and axis
  __shared__ float s_g[kChunk][GT][GT];
  __shared__ __align__(16) float s_w[kChunk][K * K][ICT];

  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const int groups = (C_in + ICT - 1) / ICT;
  const int b = blockIdx.z / groups;
  const int ic0 = (blockIdx.z % groups) * ICT;
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int xx = x0 + tx, yy = y0 + ty;
  const int gy0 = floor_div(y0 + P - (K - 1), S);
  const int gx0 = floor_div(x0 + P - (K - 1), S);
  const int ky0 = (yy + P) % S, kx0 = (xx + P) % S;
  const T* gb = g + (int64_t)b * C_out * Ho * Wo;

  float acc[ICT];
#pragma unroll
  for (int i = 0; i < ICT; ++i) acc[i] = 0.0f;

  for (int o0 = 0; o0 < C_out; o0 += kChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * GT * GT; i += kThreads) {
      const int c = i / (GT * GT);
      const int r = i - c * GT * GT;
      const int ly = r / GT, lx = r - (r / GT) * GT;
      const int gy = gy0 + ly, gx = gx0 + lx, go = o0 + c;
      float v = 0.0f;
      if (go < C_out && gy >= 0 && gy < Ho && gx >= 0 && gx < Wo)
        v = load_f(gb, ((int64_t)go * Ho + gy) * Wo + gx);
      s_g[c][ly][lx] = v;
    }
    for (int i = threadIdx.x; i < kChunk * K * K * ICT; i += kThreads) {
      const int ci = i % ICT;
      const int t = (i / ICT) % (K * K);
      const int c = i / (ICT * K * K);
      const int go = o0 + c, gc = ic0 + ci;
      s_w[c][t][ci] = (go < C_out && gc < C_in)
                          ? load_f(w, ((int64_t)go * C_in + gc) * K * K + t)
                          : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
#pragma unroll
      for (int jy = 0; jy < NT; ++jy) {
        const int ky = ky0 + jy * S;
        if (ky >= K) continue;
        // y + P - ky is a multiple of S, so the division is exact
        const int ly = (yy + P - ky) / S - gy0;
#pragma unroll
        for (int jx = 0; jx < NT; ++jx) {
          const int kx = kx0 + jx * S;
          if (kx >= K) continue;
          const int lx = (xx + P - kx) / S - gx0;
          const float v = s_g[c][ly][lx];
          const float4* wv =
              reinterpret_cast<const float4*>(&s_w[c][ky * K + kx][0]);
#pragma unroll
          for (int q = 0; q < ICT / 4; ++q) {
            const float4 w4 = wv[q];
            acc[4 * q + 0] += v * w4.x;
            acc[4 * q + 1] += v * w4.y;
            acc[4 * q + 2] += v * w4.z;
            acc[4 * q + 3] += v * w4.w;
          }
        }
      }
    }
  }

  if (xx < W && yy < H) {
#pragma unroll
    for (int i = 0; i < ICT; ++i) {
      const int gc = ic0 + i;
      if (gc >= C_in) continue;
      store_f(dx, (((int64_t)b * C_in + gc) * H + yy) * W + xx, acc[i]);
    }
  }
}

template <typename T, int K, int S>
void launch_fwd(const void* x, const void* w, const void* bias, void* out,
                int B, int C_in, int H, int W, int C_out, int Ho, int Wo,
                int act, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(bias);
  T* op = static_cast<T*>(out);
  const dim3 block(kThreads);
  if (C_out <= 4) {
    const dim3 grid((Wo + kTile - 1) / kTile, (Ho + kTile - 1) / kTile, B);
    conv_fwd_kernel<T, K, S, 4><<<grid, block, 0, stream>>>(
        xp, wp, bp, op, C_in, H, W, C_out, Ho, Wo, act);
  } else {
    const dim3 grid((Wo + kTile - 1) / kTile, (Ho + kTile - 1) / kTile,
                    B * ((C_out + 15) / 16));
    conv_fwd_kernel<T, K, S, 16><<<grid, block, 0, stream>>>(
        xp, wp, bp, op, C_in, H, W, C_out, Ho, Wo, act);
  }
}

template <typename T, int K, int S>
void launch_dx(const void* g, const void* w, void* dx, int B, int C_in,
               int H, int W, int C_out, int Ho, int Wo, cudaStream_t stream) {
  const T* gp = static_cast<const T*>(g);
  const T* wp = static_cast<const T*>(w);
  T* dp = static_cast<T*>(dx);
  const dim3 block(kThreads);
  if (C_in <= 4) {
    const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
    conv_dx_kernel<T, K, S, 4><<<grid, block, 0, stream>>>(
        gp, wp, dp, C_in, H, W, C_out, Ho, Wo);
  } else {
    const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile,
                    B * ((C_in + 15) / 16));
    conv_dx_kernel<T, K, S, 16><<<grid, block, 0, stream>>>(
        gp, wp, dp, C_in, H, W, C_out, Ho, Wo);
  }
}

template <typename T, int K>
bool dispatch_fwd_s(int S, const void* x, const void* w, const void* bias,
                    void* out, int B, int C_in, int H, int W, int C_out,
                    int Ho, int Wo, int act, cudaStream_t st) {
  if (S == 1)
    launch_fwd<T, K, 1>(x, w, bias, out, B, C_in, H, W, C_out, Ho, Wo, act, st);
  else if (S == 2)
    launch_fwd<T, K, 2>(x, w, bias, out, B, C_in, H, W, C_out, Ho, Wo, act, st);
  else
    return false;
  return true;
}

template <typename T>
bool dispatch_fwd(int K, int S, const void* x, const void* w,
                  const void* bias, void* out, int B, int C_in, int H, int W,
                  int C_out, int Ho, int Wo, int act, cudaStream_t st) {
  switch (K) {
    case 3: return dispatch_fwd_s<T, 3>(S, x, w, bias, out, B, C_in, H, W,
                                        C_out, Ho, Wo, act, st);
    case 5: return dispatch_fwd_s<T, 5>(S, x, w, bias, out, B, C_in, H, W,
                                        C_out, Ho, Wo, act, st);
    case 7: return dispatch_fwd_s<T, 7>(S, x, w, bias, out, B, C_in, H, W,
                                        C_out, Ho, Wo, act, st);
    default: return false;
  }
}

template <typename T, int K>
bool dispatch_dx_s(int S, const void* g, const void* w, void* dx, int B,
                   int C_in, int H, int W, int C_out, int Ho, int Wo,
                   cudaStream_t st) {
  if (S == 1)
    launch_dx<T, K, 1>(g, w, dx, B, C_in, H, W, C_out, Ho, Wo, st);
  else if (S == 2)
    launch_dx<T, K, 2>(g, w, dx, B, C_in, H, W, C_out, Ho, Wo, st);
  else
    return false;
  return true;
}

template <typename T>
bool dispatch_dx(int K, int S, const void* g, const void* w, void* dx, int B,
                 int C_in, int H, int W, int C_out, int Ho, int Wo,
                 cudaStream_t st) {
  switch (K) {
    case 3: return dispatch_dx_s<T, 3>(S, g, w, dx, B, C_in, H, W, C_out, Ho,
                                       Wo, st);
    case 5: return dispatch_dx_s<T, 5>(S, g, w, dx, B, C_in, H, W, C_out, Ho,
                                       Wo, st);
    case 7: return dispatch_dx_s<T, 7>(S, g, w, dx, B, C_in, H, W, C_out, Ho,
                                       Wo, st);
    default: return false;
  }
}

int out_size(int n, int K, int S) { return (n + 2 * (K / 2) - K) / S + 1; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for x, w, bias and out alike. x: NCHW
// (B, C_in, H, W); w: (C_out, C_in, K, K); bias: (C_out) or NULL; out:
// (B, C_out, Ho, Wo) with Ho = ceil(H/S). act: 0 none, 1 relu, 2 leaky 0.1.
extern "C" int pcfa_small_conv_fwd(int dtype, const void* x, const void* w,
                                   const void* bias, void* out, int B,
                                   int C_in, int H, int W, int C_out, int K,
                                   int S, int act, void* stream) {
  if (B <= 0 || C_in <= 0 || C_out <= 0 || H <= 0 || W <= 0 || act < 0 ||
      act > 2)
    return (int)cudaErrorInvalidValue;
  const int Ho = out_size(H, K, S), Wo = out_size(W, K, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok;
  if (dtype == 0)
    ok = dispatch_fwd<float>(K, S, x, w, bias, out, B, C_in, H, W, C_out, Ho,
                             Wo, act, st);
  else if (dtype == 1)
    ok = dispatch_fwd<__nv_bfloat16>(K, S, x, w, bias, out, B, C_in, H, W,
                                     C_out, Ho, Wo, act, st);
  else
    ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// g: (B, C_out, Ho, Wo) cotangent of the conv output (activation already
// applied by the caller); dx: (B, C_in, H, W), fully written.
extern "C" int pcfa_small_conv_dx(int dtype, const void* g, const void* w,
                                  void* dx, int B, int C_in, int H, int W,
                                  int C_out, int K, int S, void* stream) {
  if (B <= 0 || C_in <= 0 || C_out <= 0 || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  const int Ho = out_size(H, K, S), Wo = out_size(W, K, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok;
  if (dtype == 0)
    ok = dispatch_dx<float>(K, S, g, w, dx, B, C_in, H, W, C_out, Ho, Wo, st);
  else if (dtype == 1)
    ok = dispatch_dx<__nv_bfloat16>(K, S, g, w, dx, B, C_in, H, W, C_out, Ho,
                                    Wo, st);
  else
    ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
