// SAME convolution for small channel counts, forward and input gradient
// (dx), for sm_90a.
//
// Replaces the Pallas kernel of pcfa_tpu/ops/pallas/small_conv.py:
// `_forward` (shifted-slab block-Toeplitz matmuls on NHCW) and its VJP
// `_bwd`, which reruns `_forward` with flipped, channel-transposed weights
// on a zero-dilated cotangent for stride 2. Semantics are torch's
// Conv2d(k, stride=s, padding=k//2) on NCHW: stride 1 or 2, k 3/5/7,
// output ceil(H/s) x ceil(W/s) for every H and W (odd sizes included),
// fused bias and none/relu/leaky(0.1) epilogue, float32 accumulation.
//
// Bound on the H100: bytes, at every main-path shape. RAFT's fnet layer1
// conv (4 x 64 x 188 x 624, 64 -> 64, k3 s1, bf16) moves ~120 MB for 34.6
// GFLOP (36 us at 3.35 TB/s, 35 us at the 989 TFLOP/s bf16 peak); the stem
// (3 -> 64, k7 s2) ~71 MB for 8.8 GFLOP; PWCNet's 16-96 channel layers
// are smaller still per byte.
//
// bf16: an implicit GEMM on the tensor cores (`conv_tc_kernel`).
//   M = output pixels of a tile (one warp per output row, 16 or 32
//   pixels), N = output channels padded to 8 (one block computes all of
//   them, or a third of 96 on small maps), K = taps x input channels
//   padded to 8 (C_in <= 8) or in chunks of 16. Each chunk's input halo
//   arrives by 16-byte `cp.async` as raw NCHW rows (zero-filled outside
//   the map; element by element where W % 8 != 0) and is transposed in
//   shared memory to channels-innermost [y][x][c] (stride-2 columns split
//   by parity, the two 16-byte halves of a pixel swizzled), so that each
//   tap's A fragment is an `ldmatrix` of 16-byte rows. Weights come
//   prepacked by the wrapper as bf16 [group][chunk][tap][c][n] and arrive
//   by `cp.async` in rows padded against bank conflicts (`ldmatrix.trans`
//   gives B). Products are `mma.sync.m16n8k16` (k8 for C_in <= 8) with
//   float32 accumulators; a tap's fragments all load before its MMAs.
//   Chunks are double-buffered: chunk i+1's halo and weights are in
//   flight while the MMAs consume chunk i. Epilogue: bias and activation
//   in registers, then a shared-memory transpose and 16-byte NCHW stores.
//   dx is the same kernel. Stride 1: the conv of the cotangent with
//   flipped, channel-transposed weights. Stride 2: one GEMM per output
//   parity class (py, px), each a stride-1 correlation of the cotangent
//   with that class's taps (k7: 4x4, 4x3, 3x4, 3x3; k3: 2x2 .. 1x1); a
//   block runs one class, so its tap set is uniform across lanes. The
//   activation's derivative (relu / leaky 0.1, from the forward's saved
//   output) is applied while the cotangent is staged. The wrapper plans
//   each shape (tile, N split, buffers; `ops/small_conv.py`) so that the
//   main-path shapes launch >= 2 x 132 blocks.
//
// float32: direct kernels on the CUDA cores (float32 FMA), kept because
//   TF32 would not hold 1e-4 of the plain result: a block computes a 16x16
//   output tile for 16 output channels (4 for C_out <= 4) from 4-channel
//   chunks of a zero-padded halo tile in shared memory; dx gathers one
//   stride-parity class of taps per pixel. float32 runs on no timed main
//   path (the attacks run bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------
// float32 route
// ---------------------------------------------------------------------

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kChunk = 4;  // channels staged per pass

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ float act_slope(int act) {
  return act == 2 ? 0.1f : 0.0f;
}

// out[b, o, oy, ox] = act(bias[o] + sum_{c,ky,kx}
//     x[b, c, oy*S - P + ky, ox*S - P + kx] * w[o, c, ky, kx])
template <int K, int S, int OCT>
__global__ void __launch_bounds__(kThreads)
conv_fwd_f32(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ out,
             int C_in, int H, int W, int C_out, int Ho, int Wo, int act) {
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
  const float* xb = x + (int64_t)b * C_in * H * W;

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
        v = xb[((int64_t)gc * H + gy) * W + gx];
      s_in[c][yy][xx] = v;
    }
    for (int i = threadIdx.x; i < kChunk * K * K * OCT; i += kThreads) {
      const int o = i % OCT;
      const int t = (i / OCT) % (K * K);
      const int c = i / (OCT * K * K);
      const int go = oc0 + o, gc = c0 + c;
      s_w[c][t][o] = (go < C_out && gc < C_in)
                         ? w[((int64_t)go * C_in + gc) * K * K + t]
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
      float v = acc[o] + (bias != nullptr ? bias[go] : 0.0f);
      if (act == 1) v = fmaxf(v, 0.0f);
      else if (act == 2) v = v > 0.0f ? v : 0.1f * v;
      out[(((int64_t)b * C_out + go) * Ho + oy) * Wo + ox] = v;
    }
  }
}

// dx[b, c, y, x] = sum_{o, ky, kx : y + P - ky = S*oy, x + P - kx = S*ox}
//     g'[b, o, oy, ox] * w[o, c, ky, kx]   (g' zero outside Ho x Wo), with
// g' = g * act'(fwd_out) when `fwd_out` is given (relu: 0 where out <= 0,
// leaky: 0.1 there).
template <int K, int S, int ICT>
__global__ void __launch_bounds__(kThreads)
conv_dx_f32(const float* __restrict__ g, const float* __restrict__ fwd_out,
            const float* __restrict__ w, float* __restrict__ dx, int C_in,
            int H, int W, int C_out, int Ho, int Wo, int act) {
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
  const int64_t gofs = (int64_t)b * C_out * Ho * Wo;
  const float slope = act_slope(act);

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
      if (go < C_out && gy >= 0 && gy < Ho && gx >= 0 && gx < Wo) {
        const int64_t at = gofs + ((int64_t)go * Ho + gy) * Wo + gx;
        v = g[at];
        if (fwd_out != nullptr && !(fwd_out[at] > 0.0f)) v *= slope;
      }
      s_g[c][ly][lx] = v;
    }
    for (int i = threadIdx.x; i < kChunk * K * K * ICT; i += kThreads) {
      const int ci = i % ICT;
      const int t = (i / ICT) % (K * K);
      const int c = i / (ICT * K * K);
      const int go = o0 + c, gc = ic0 + ci;
      s_w[c][t][ci] = (go < C_out && gc < C_in)
                          ? w[((int64_t)go * C_in + gc) * K * K + t]
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
      dx[(((int64_t)b * C_in + gc) * H + yy) * W + xx] = acc[i];
    }
  }
}

template <int K, int S>
void launch_fwd_f32(const float* x, const float* w, const float* bias,
                    float* out, int B, int C_in, int H, int W, int C_out,
                    int Ho, int Wo, int act, cudaStream_t st) {
  const int oct = C_out <= 4 ? 4 : 16;
  const dim3 grid((Wo + kTile - 1) / kTile, (Ho + kTile - 1) / kTile,
                  B * ((C_out + oct - 1) / oct));
  if (oct == 4)
    conv_fwd_f32<K, S, 4><<<grid, kThreads, 0, st>>>(
        x, w, bias, out, C_in, H, W, C_out, Ho, Wo, act);
  else
    conv_fwd_f32<K, S, 16><<<grid, kThreads, 0, st>>>(
        x, w, bias, out, C_in, H, W, C_out, Ho, Wo, act);
}

template <int K, int S>
void launch_dx_f32(const float* g, const float* fwd_out, const float* w,
                   float* dx, int B, int C_in, int H, int W, int C_out,
                   int Ho, int Wo, int act, cudaStream_t st) {
  const int ict = C_in <= 4 ? 4 : 16;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile,
                  B * ((C_in + ict - 1) / ict));
  if (ict == 4)
    conv_dx_f32<K, S, 4><<<grid, kThreads, 0, st>>>(
        g, fwd_out, w, dx, C_in, H, W, C_out, Ho, Wo, act);
  else
    conv_dx_f32<K, S, 16><<<grid, kThreads, 0, st>>>(
        g, fwd_out, w, dx, C_in, H, W, C_out, Ho, Wo, act);
}

// calls F<K, S>::run(args...) for K in 3/5/7 and S in 1/2
#define PCFA_KS_DISPATCH(FN, K, S, ...)                       \
  do {                                                        \
    if (K == 3 && S == 1) FN<3, 1>(__VA_ARGS__);              \
    else if (K == 3 && S == 2) FN<3, 2>(__VA_ARGS__);         \
    else if (K == 5 && S == 1) FN<5, 1>(__VA_ARGS__);         \
    else if (K == 5 && S == 2) FN<5, 2>(__VA_ARGS__);         \
    else if (K == 7 && S == 1) FN<7, 1>(__VA_ARGS__);         \
    else if (K == 7 && S == 2) FN<7, 2>(__VA_ARGS__);         \
    else return (int)cudaErrorInvalidValue;                   \
  } while (0)

int out_size(int n, int K, int S) { return (n + 2 * (K / 2) - K) / S + 1; }

// ---------------------------------------------------------------------
// bf16 route: implicit GEMM on the tensor cores
// ---------------------------------------------------------------------

// One GEMM of a launch: output pixels (u, v) in [0, hc) x [0, wc), stored
// at (u*OS + py, v*OS + px); input pixel of tap (jy, jx) at
// (u*S + by + jy, v*S + bx + jx); its weights at element `woff` of the
// packed buffer, [group][chunk][ty*tx][KC][BN].
struct TcClass {
  int ty, tx, by, bx, hc, wc, py, px, woff;
};

struct TcArgs {
  const uint16_t* x;     // GEMM input, NCHW (B, C, H, W), bf16 bits
  const uint16_t* mask;  // forward output of x's shape (dx) or null
  const uint16_t* w;     // packed weights
  const uint16_t* bias;  // (N) or null
  uint16_t* out;         // (B, N, Ho, Wo)
  int C, H, W, N, Ho, Wo;
  int S, OS, act, mask_act;
  int nchunk, groups, nclass, nbuf, vec;
  int raw_bytes, a_bytes, w_bytes;  // one raw / input / weight buffer
  TcClass cls[4];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x1_t(uint32_t& r0, uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
               : "=r"(r0)
               : "r"(a));
}

__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t* a,
                                        uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t* a,
                                       uint32_t b0) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
// 16 bytes, or 16 zero bytes when !ok (nothing is read then)
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst,
                                                 const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float bf2f(uint16_t v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}
__device__ __forceinline__ uint16_t f2bf(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// The input halo one block stages per chunk. It arrives raw, as NCHW rows
// [c][row][iwr] (columns from ix0a, ix0 rounded down to 8, so that each
// 16-byte segment is aligned), and is transposed in shared memory into
// the channels-innermost tile the MMAs read.
struct Halo {
  const uint16_t* x;     // this image of the GEMM input
  const uint16_t* mask;  // this image of the forward output, or null
  int C, H, W, S;
  int ih, iw, half, iwp, iy0, ix0a, xoff, iwr;
  float slope;  // act' where the forward output is <= 0
};

// Global -> raw tile of chunk `ch` (and the mask's): 16-byte cp.async
// segments when rows and pointers are 16-byte aligned (`vec`: W % 8 ==
// 0), zero-filled outside the map; else element by element.
template <int KC>
__device__ __forceinline__ void raw_load(const Halo& h, int ch, bool vec,
                                         unsigned char* raw,
                                         unsigned char* rawm) {
  const int64_t plane = (int64_t)h.H * h.W;
  if (vec) {
    // (i + 0.5) / d in float is exact enough to floor for these small ints
    const int nseg = h.iwr >> 3, n = KC * h.ih * nseg;
    const float inv_seg = 1.0f / nseg, inv_ih = 1.0f / h.ih;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int row = __float2int_rz((i + 0.5f) * inv_seg);
      const int sg = i - row * nseg;
      const int c = __float2int_rz((row + 0.5f) * inv_ih);
      const int r = row - c * h.ih;
      const int gc = ch * KC + c, gy = h.iy0 + r, gx = h.ix0a + 8 * sg;
      const bool ok = gc < h.C && gy >= 0 && gy < h.H && gx >= 0 && gx < h.W;
      const int64_t off = ok ? gc * plane + (int64_t)gy * h.W + gx : 0;
      cp_async16_zfill(smem_u32(raw) + i * 16, h.x + off, ok);
      if (h.mask != nullptr)
        cp_async16_zfill(smem_u32(rawm) + i * 16, h.mask + off, ok);
    }
  } else {
    const int n = KC * h.ih * h.iwr;
    uint16_t* rx = reinterpret_cast<uint16_t*>(raw);
    uint16_t* rm = reinterpret_cast<uint16_t*>(rawm);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int row = i / h.iwr, col = i - row * h.iwr;
      const int c = row / h.ih, r = row - c * h.ih;
      const int gc = ch * KC + c, gy = h.iy0 + r, gx = h.ix0a + col;
      const bool ok = gc < h.C && gy >= 0 && gy < h.H && gx >= 0 && gx < h.W;
      const int64_t off = gc * plane + (int64_t)gy * h.W + gx;
      rx[i] = ok ? h.x[off] : 0;
      if (h.mask != nullptr) rm[i] = ok ? h.mask[off] : 0;
    }
  }
}

// Raw tile -> channels innermost: pixel q = row * iwp + pos (stride 2:
// columns split by parity), 8 channels per 16-byte unit, the two units of
// a 16-channel pixel swizzled by bit 2 of q so that 8 neighbouring pixels
// hit 8 bank groups. The activation's derivative is applied here.
template <int KC>
__device__ __forceinline__ void halo_transpose(const Halo& h,
                                               const unsigned char* raw,
                                               const unsigned char* rawm,
                                               unsigned char* ab) {
  const uint16_t* rx = reinterpret_cast<const uint16_t*>(raw);
  const uint16_t* rm = reinterpret_cast<const uint16_t*>(rawm);
  const int cstride = h.ih * h.iwr;  // one channel of the raw tile
  const int nwarps = blockDim.x >> 5, lane = threadIdx.x & 31;
  for (int rr = threadIdx.x >> 5; rr < (KC / 8) * h.ih; rr += nwarps) {
    const int hf = rr >= h.ih ? 1 : 0, r = rr - hf * h.ih;
    for (int col = lane; col < h.iw; col += 32) {
      const int at = (hf * 8 * h.ih + r) * h.iwr + h.xoff + col;
      uint32_t v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint16_t e = rx[at + q * cstride];
        if (h.mask != nullptr && !(bf2f(rm[at + q * cstride]) > 0.0f))
          e = f2bf(bf2f(e) * h.slope);
        v[q] = e;
      }
      const int pos = h.S == 2 ? (col & 1) * h.half + (col >> 1) : col;
      const int q = r * h.iwp + pos;
      const int byte =
          q * (KC * 2) + (KC == 16 ? ((hf ^ ((q >> 2) & 1)) << 4) : 0);
      *reinterpret_cast<uint4*>(ab + byte) =
          make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16),
                     v[4] | (v[5] << 16), v[6] | (v[7] << 16));
    }
  }
}

// One chunk's weights, [tap][KC][BN] in global, into shared rows of
// pitch WP by cp.async.
template <int KC, int NF>
__device__ __forceinline__ void weights_load(const uint16_t* src, int taps,
                                             unsigned char* wb) {
  constexpr int BN = 8 * NF, WP = (NF % 2 ? NF : NF + 1) * 8;
  const uint32_t dst = smem_u32(wb);
  const int n = taps * KC * NF;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int unit = i % NF, row = i / NF;
    cp_async16(dst + (row * WP + unit * 8) * 2,
               src + (int64_t)row * BN + unit * 8);
  }
}

// One tap of one staged chunk: this warp's A fragments (MF ldmatrix of
// 16 output pixels x KC channels, tap (jy, jx)) and all NF B fragments
// (weights at wt) are loaded first, then the MF x NF MMAs run, so a tap
// waits for shared memory once.
template <int KC, int MF, int NF>
__device__ __forceinline__ void tap_mma(const Halo& h, uint32_t ab, int jy,
                                        int jx, uint32_t wt,
                                        float (&acc)[MF][NF][4]) {
  constexpr int WP = (NF % 2 ? NF : NF + 1) * 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t af[MF][KC / 4], bf[NF][KC / 8];
  const int q0 = (warp * h.S + jy) * h.iwp +
                 (h.S == 2 ? (jx & 1) * h.half + (jx >> 1) : jx) +
                 (lane & 15);
#pragma unroll
  for (int m = 0; m < MF; ++m) {
    const int q = q0 + m * 16;
    if constexpr (KC == 16) {
      uint32_t r[4];
      ldsm_x4(r, ab + q * 32 + (((lane >> 4) ^ ((q >> 2) & 1)) << 4));
#pragma unroll
      for (int e = 0; e < 4; ++e) af[m][e] = r[e];
    } else {
      ldsm_x2(af[m][0], af[m][1], ab + q * 16);
    }
  }
  if constexpr (KC == 16) {
    const int mi = lane >> 3, k = (mi & 1) * 8 + (lane & 7);
#pragma unroll
    for (int np = 0; np < NF / 2; ++np) {
      uint32_t r[4];
      ldsm_x4_t(r, wt + (k * WP + (2 * np + (mi >> 1)) * 8) * 2);
      bf[2 * np][0] = r[0], bf[2 * np][1] = r[1];
      bf[2 * np + 1][0] = r[2], bf[2 * np + 1][1] = r[3];
    }
    if constexpr (NF % 2 == 1)
      ldsm_x2_t(bf[NF - 1][0], bf[NF - 1][1],
                wt + ((lane & 15) * WP + (NF - 1) * 8) * 2);
#pragma unroll
    for (int m = 0; m < MF; ++m)
#pragma unroll
      for (int n = 0; n < NF; ++n) mma_k16(acc[m][n], af[m], bf[n][0], bf[n][1]);
  } else {
    const int k = lane & 7;
#pragma unroll
    for (int nq = 0; nq + 4 <= NF; nq += 4) {
      uint32_t r[4];
      ldsm_x4_t(r, wt + (k * WP + (nq + (lane >> 3)) * 8) * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) bf[nq + e][0] = r[e];
    }
    constexpr int nr = NF % 4;
    if constexpr (nr == 2)
      ldsm_x2_t(bf[NF - 2][0], bf[NF - 1][0],
                wt + (k * WP + (NF - 2 + ((lane >> 3) & 1)) * 8) * 2);
    else if constexpr (nr == 1)
      ldsm_x1_t(bf[NF - 1][0], wt + (k * WP + (NF - 1) * 8) * 2);
#pragma unroll
    for (int m = 0; m < MF; ++m)
#pragma unroll
      for (int n = 0; n < NF; ++n) mma_k8(acc[m][n], af[m], bf[n][0]);
  }
}

// The MMAs of one staged chunk: every tap of the class, this warp's
// output row (MF fragments of 16 pixels) times all NF fragments of N.
template <int KC, int MF, int NF>
__device__ __forceinline__ void chunk_mma(const Halo& h, uint32_t ab,
                                          uint32_t wb, int ty, int tx,
                                          float (&acc)[MF][NF][4]) {
  constexpr int TAP = KC * (NF % 2 ? NF : NF + 1) * 8 * 2;  // weight bytes
  for (int jy = 0; jy < ty; ++jy)
    for (int jx = 0; jx < tx; ++jx)
      tap_mma<KC, MF, NF>(h, ab, jy, jx, wb + (jy * tx + jx) * TAP, acc);
}

// KC: input channels per K step (8 or 16); MF: 16-pixel M fragments per
// warp (one output row of 16*MF pixels); NF: 8-channel N fragments.
// blockDim.x = 32 * (output rows of the tile). Up to 64 output channels
// the kernel is held to 128 registers, so that two blocks share an SM.
template <int KC, int MF, int NF>
__global__ void __launch_bounds__(256, MF * NF <= 16 && NF <= 8 ? 2 : 1)
conv_tc_kernel(const TcArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TW = 16 * MF;
  constexpr int BN = 8 * NF;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x, TH = nthr >> 5;
  int z = blockIdx.z;
  const int grp = z % a.groups;
  z /= a.groups;
  const int ci = z % a.nclass;
  const int b = z / a.nclass;
  const TcClass c = ci == 0 ? a.cls[0]
                    : ci == 1 ? a.cls[1]
                    : ci == 2 ? a.cls[2]
                              : a.cls[3];
  const int u0 = blockIdx.y * TH, v0 = blockIdx.x * TW;
  if (u0 >= c.hc || v0 >= c.wc) return;  // the whole block: no barrier yet

  Halo h;
  const int64_t img = (int64_t)b * a.C * a.H * a.W;
  h.x = a.x + img;
  h.mask = a.mask != nullptr ? a.mask + img : nullptr;
  h.C = a.C, h.H = a.H, h.W = a.W, h.S = a.S;
  h.ih = (TH - 1) * a.S + c.ty;
  h.iw = (TW - 1) * a.S + c.tx;
  h.half = a.S == 2 ? (h.iw + 1) >> 1 : h.iw;
  h.iwp = a.S == 2 ? 2 * h.half : h.iw;
  h.iy0 = u0 * a.S + c.by;
  const int ix0 = v0 * a.S + c.bx;
  h.xoff = ix0 & 7;  // ix0 - ix0a, also for ix0 < 0
  h.ix0a = ix0 - h.xoff;
  h.iwr = (h.xoff + h.iw + 7) & ~7;
  h.slope = a.mask_act == 2 ? 0.1f : 0.0f;
  const int taps = c.ty * c.tx;
  const int64_t wchunk = (int64_t)taps * KC * BN;
  const uint16_t* wsrc = a.w + c.woff + grp * a.nchunk * wchunk;
  unsigned char* raw = smem;
  unsigned char* rawm = smem + a.raw_bytes;
  unsigned char* abase = smem + (a.mask != nullptr ? 2 : 1) * a.raw_bytes;
  unsigned char* wbase = abase + a.nbuf * a.a_bytes;

  float acc[MF][NF][4];
#pragma unroll
  for (int m = 0; m < MF; ++m)
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;

  // The K loop over input-channel chunks. Step s loads chunk s (its raw
  // halo and its weights, cp.async) into buffer s % nbuf and runs the MMAs
  // of chunk s - 1; with two buffers the loads are in flight during those
  // MMAs. Then the raw halo is transposed for the next step.
  const bool overlap = a.nbuf == 2;
#pragma unroll 1
  for (int s = 0; s <= a.nchunk; ++s) {
    const bool stage = s < a.nchunk, mma = s > 0;
    const int sb = overlap ? (s & 1) : 0, cb = overlap ? ((s - 1) & 1) : 0;
    if (mma && !overlap) {
      chunk_mma<KC, MF, NF>(h, smem_u32(abase), smem_u32(wbase), c.ty, c.tx,
                            acc);
      __syncthreads();
    }
    if (stage) {
      raw_load<KC>(h, s, a.vec != 0, raw, rawm);
      weights_load<KC, NF>(wsrc + s * wchunk, taps, wbase + sb * a.w_bytes);
      cp_async_commit();
    }
    if (mma && overlap)
      chunk_mma<KC, MF, NF>(h, smem_u32(abase + cb * a.a_bytes),
                            smem_u32(wbase + cb * a.w_bytes), c.ty, c.tx,
                            acc);
    if (stage) {
      cp_async_wait_all();
      __syncthreads();
      halo_transpose<KC>(h, raw, rawm, abase + sb * a.a_bytes);
    }
    __syncthreads();
  }

  // Epilogue: bias and activation in registers, then a transpose through
  // shared memory (the pipeline buffers are free) for coalesced stores.
  const int BM = TH * TW, BMP = BM + 8;
  uint16_t* so = reinterpret_cast<uint16_t*>(smem);
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int m = 0; m < MF; ++m)
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = warp * TW + m * 16 + gq + (e >= 2 ? 8 : 0);
        const int nn = n * 8 + 2 * tq + (e & 1);
        const int ng = grp * BN + nn;
        float v = acc[m][n][e];
        if (a.bias != nullptr && ng < a.N) v += bf2f(a.bias[ng]);
        if (a.act == 1) v = fmaxf(v, 0.0f);
        else if (a.act == 2) v = v > 0.0f ? v : 0.1f * v;
        so[nn * BMP + p] = f2bf(v);
      }
  __syncthreads();
  if (a.OS == 1 && a.Wo % 8 == 0) {
    // 8 pixels of one channel per thread: one 16-byte store where all are
    // inside the map
    for (int i = tid; i < BN * TH * (TW / 8); i += nthr) {
      const int v8 = (i % (TW / 8)) * 8, t = i / (TW / 8);
      const int r = t % TH, nn = t / TH;
      const int u = u0 + r, v = v0 + v8, ng = grp * BN + nn;
      if (u >= c.hc || ng >= a.N) continue;
      const uint16_t* src = so + nn * BMP + r * TW + v8;
      uint16_t* dst = a.out + (((int64_t)b * a.N + ng) * a.Ho + u) * a.Wo + v;
      if (v + 8 <= c.wc)
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      else
        for (int e = 0; v + e < c.wc; ++e) dst[e] = src[e];
    }
  } else {
    // one pixel per thread, neighbouring lanes on neighbouring pixels (of
    // this parity class: every other output pixel for dx of stride 2)
    for (int i = tid; i < BN * BM; i += nthr) {
      const int vv = i % TW, t = i / TW;
      const int r = t % TH, nn = t / TH;
      const int u = u0 + r, v = v0 + vv, ng = grp * BN + nn;
      if (u < c.hc && v < c.wc && ng < a.N)
        a.out[(((int64_t)b * a.N + ng) * a.Ho + u * a.OS + c.py) * a.Wo +
              v * a.OS + c.px] = so[nn * BMP + r * TW + vv];
    }
  }
}

template <int KC, int MF, int NF>
int launch_tc(const TcArgs& args, dim3 grid, int threads, int smem,
              cudaStream_t st) {
  static int smem_set = 48 * 1024;
  auto kern = conv_tc_kernel<KC, MF, NF>;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  kern<<<grid, threads, smem, st>>>(args);
  return (int)cudaGetLastError();
}

template <int KC, int MF>
int dispatch_nf(int NF, const TcArgs& args, dim3 grid, int threads,
                int smem, cudaStream_t st) {
  switch (NF) {
    case 1: return launch_tc<KC, MF, 1>(args, grid, threads, smem, st);
    case 2: return launch_tc<KC, MF, 2>(args, grid, threads, smem, st);
    case 4: return launch_tc<KC, MF, 4>(args, grid, threads, smem, st);
    case 8: return launch_tc<KC, MF, 8>(args, grid, threads, smem, st);
    case 12: return launch_tc<KC, MF, 12>(args, grid, threads, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// float32 forward. x: NCHW (B, C_in, H, W); w: (C_out, C_in, K, K); bias:
// (C_out) or NULL; out: (B, C_out, Ho, Wo) with Ho = ceil(H/S). act: 0
// none, 1 relu, 2 leaky 0.1.
extern "C" int pcfa_small_conv_fwd_f32(const void* x, const void* w,
                                       const void* bias, void* out, int B,
                                       int C_in, int H, int W, int C_out,
                                       int K, int S, int act, void* stream) {
  if (B <= 0 || C_in <= 0 || C_out <= 0 || H <= 0 || W <= 0 || act < 0 ||
      act > 2)
    return (int)cudaErrorInvalidValue;
  const int Ho = out_size(H, K, S), Wo = out_size(W, K, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PCFA_KS_DISPATCH(launch_fwd_f32, K, S, static_cast<const float*>(x),
                   static_cast<const float*>(w),
                   static_cast<const float*>(bias), static_cast<float*>(out),
                   B, C_in, H, W, C_out, Ho, Wo, act, st);
  return (int)cudaGetLastError();
}

// float32 dx. g: (B, C_out, Ho, Wo) cotangent of the conv output;
// fwd_out: the forward's output (same shape) when act is 1 or 2, whose
// derivative is applied to g; dx: (B, C_in, H, W), fully written.
extern "C" int pcfa_small_conv_dx_f32(const void* g, const void* fwd_out,
                                      const void* w, void* dx, int B,
                                      int C_in, int H, int W, int C_out,
                                      int K, int S, int act, void* stream) {
  if (B <= 0 || C_in <= 0 || C_out <= 0 || H <= 0 || W <= 0 || act < 0 ||
      act > 2 || (act != 0) != (fwd_out != nullptr))
    return (int)cudaErrorInvalidValue;
  const int Ho = out_size(H, K, S), Wo = out_size(W, K, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PCFA_KS_DISPATCH(launch_dx_f32, K, S, static_cast<const float*>(g),
                   static_cast<const float*>(fwd_out),
                   static_cast<const float*>(w), static_cast<float*>(dx), B,
                   C_in, H, W, C_out, Ho, Wo, act, st);
  return (int)cudaGetLastError();
}

// bf16 implicit GEMM, forward or dx, as planned by ops/small_conv.py.
// x: GEMM input (B, C, H, W); mask: forward output of x's shape or NULL
// (mask_act 1 relu, 2 leaky); w: packed weights; bias: (N) or NULL; out:
// (B, N, Ho, Wo). cls: nclass rows of 9 ints (ty, tx, by, bx, hc, wc, py,
// px, woff). Tile: th output rows (one warp each) x 16*mf pixels, nf
// 8-channel N fragments per block, `groups` blocks along N. Shared memory
// (`smem` bytes): the raw halo (raw_bytes; twice with a mask), then nbuf
// stages of a_bytes + w_bytes. vec: x, mask and their rows are 16-byte
// aligned (W % 8 == 0), so the halo arrives by 16-byte cp.async.
extern "C" int pcfa_small_conv_tc(
    const void* x, const void* mask, const void* w, const void* bias,
    void* out, int B, int C, int H, int W, int N, int Ho, int Wo, int S,
    int OS, int act, int mask_act, int kc, int th, int mf, int nf,
    int groups, int nbuf, int vec, int raw_bytes, int a_bytes, int w_bytes,
    int smem, int nclass, const int* cls, int tiles_x, int tiles_y,
    void* stream) {
  if (B <= 0 || C <= 0 || N <= 0 || H <= 0 || W <= 0 || th < 1 || th > 8 ||
      nclass < 1 || nclass > 4 || nbuf < 1 || nbuf > 2 || groups < 1 ||
      act < 0 || act > 2 || mask_act < 0 || mask_act > 2 ||
      (mask_act != 0) != (mask != nullptr) || (S != 1 && S != 2) ||
      smem > 232448 || tiles_x < 1 || tiles_y < 1)
    return (int)cudaErrorInvalidValue;
  TcArgs args;
  args.x = static_cast<const uint16_t*>(x);
  args.mask = static_cast<const uint16_t*>(mask);
  args.w = static_cast<const uint16_t*>(w);
  args.bias = static_cast<const uint16_t*>(bias);
  args.out = static_cast<uint16_t*>(out);
  args.C = C, args.H = H, args.W = W, args.N = N, args.Ho = Ho, args.Wo = Wo;
  args.S = S, args.OS = OS, args.act = act, args.mask_act = mask_act;
  args.nchunk = (C + kc - 1) / kc, args.groups = groups;
  args.nclass = nclass, args.nbuf = nbuf, args.vec = vec;
  args.raw_bytes = raw_bytes, args.a_bytes = a_bytes, args.w_bytes = w_bytes;
  for (int i = 0; i < 4; ++i) {
    const int* r = cls + 9 * (i < nclass ? i : 0);
    args.cls[i] = TcClass{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7],
                          r[8]};
  }
  const dim3 grid(tiles_x, tiles_y, B * nclass * groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 32 * th;
  if (kc == 8 && mf == 1)
    return dispatch_nf<8, 1>(nf, args, grid, threads, smem, st);
  if (kc == 8 && mf == 2)
    return dispatch_nf<8, 2>(nf, args, grid, threads, smem, st);
  if (kc == 16 && mf == 1)
    return dispatch_nf<16, 1>(nf, args, grid, threads, smem, st);
  if (kc == 16 && mf == 2)
    return dispatch_nf<16, 2>(nf, args, grid, threads, smem, st);
  return (int)cudaErrorInvalidValue;
}
