// The packed bilinear sampler's whole backward (the warp's d img, d ix,
// d iy) for sm_90a, in one launch. For each sample n with padded window
// base (r0, c0) decoded from idx[n] and corner slot k = (dy, dx) in the
// order tl, tr, bl, br:
//   dimg[b, clamp(r0-1+dy, 0, H-1), clamp(c0-1+dx, 0, W-1), :] += w4[n,k] g[n,:]
//   dot[k] = <win[n, k, :], g[n, :]>, 0 where mask4[n, k] is false
//   dix[n] = (1-b)(dot[1]-dot[0]) + b(dot[3]-dot[2])
//   diy[n] = (1-a)(dot[2]-dot[0]) + a(dot[3]-dot[1])
// The clamp is exactly what the JAX package's four shifted adds and border
// folds compute (pcfa_tpu/ops/warp.py:_bilinear_abs_packed_bwd): in zeros
// mode the masked weights are already 0, in border mode the clamp is the
// semantics.
//
// Replaces the Pallas kernel of pcfa_tpu/ops/pallas/segsum.py:
// `segment_rows_pallas`, the segment row-sum that carries that d img on a
// TPU: it sorts the (N, 4C) corner rows by window base and splats them as
// blocked one-hot matmuls on the MXU, because a TPU serialises a scatter
// with colliding indices. On Hopper the splat is what the hardware does
// well: float32 atomic adds resolved in the L2 cache, as the reference's own
// CUDA warp backward does (resample2d_kernel.cu). No sort, no (N, 4C) row
// tensor, no padded (B(H+1)(W+1), 4C) buffer and no shifted adds: each
// corner's w*g goes straight to its clamped cell of the image gradient.
//
// Bound on the H100: bytes. Per sample it reads g (C float32), the saved
// corners win (4C, the image's dtype), idx, w4, a, b and the mask, and the
// outputs are written once; PWCNet's level-2 warp at 384x1280 (N = 30,720,
// C = 32, bf16 image) moves ~15 MB, ~4.5 us at 3.35 TB/s.
//
// Design. A group of `lanes` consecutive lanes (a power of two, 1..32)
// owns one sample, its lanes across the channels, V channels per lane and
// step (16-byte loads of g for V = 4): C = 32..196 take a group of 8..32
// lanes (planned in Python, ops/segsum._plan). C < 4 takes a kernel of its
// own: a thread per sample, the image gradient accumulated 4 channels wide
// so that each corner is one float4 atomic add.
// One read of g serves the four dots and the four corners' atomic adds;
// with V = 4 (or 2) each corner is one vector atomic add of V floats
// (sm_90's float4/float2 atomicAdd). A corner whose weight is exactly 0 (a
// masked corner in zeros mode) adds nothing and is skipped: samples pushed
// off the map would otherwise pile zero adds onto one border cell. The
// dots are summed across the group's lanes by shuffles; its first lane
// writes d ix and d iy. Atomics make the order of the additions, and so
// the float32 rounding of d img, vary from run to run. A base outside
// [0, B(H+1)(W+1)) adds nothing, so no write leaves the buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

// bf16 values as their 16-bit patterns: a bf16 is the top half of a float32
template <int V>
__device__ __forceinline__ void load(const uint16_t* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(t.x << 16); v[1] = __uint_as_float(t.x & 0xffff0000u);
    v[2] = __uint_as_float(t.y << 16); v[3] = __uint_as_float(t.y & 0xffff0000u);
  } else if constexpr (V == 2) {
    const uint32_t t = *reinterpret_cast<const uint32_t*>(p);
    v[0] = __uint_as_float(t << 16); v[1] = __uint_as_float(t & 0xffff0000u);
  } else {
    v[0] = __uint_as_float(static_cast<uint32_t>(*p) << 16);
  }
}

template <int V>
__device__ __forceinline__ void add_to(float* p, float w, const float (&g)[V]) {
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(w * g[0], w * g[1], w * g[2], w * g[3]));
  } else if constexpr (V == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(w * g[0], w * g[1]));
  } else {
    atomicAdd(p, w * g[0]);
  }
}

// The image cells (flat b*H*W + y*W + x) of a sample's four corners, from
// its padded window base p = (b*(H+1) + r0)*(W+1) + c0, clamped to the
// image; false for a base outside [0, B(H+1)(W+1)).
__device__ __forceinline__ bool corner_cells(int64_t p, int B, int H, int W,
                                             int64_t (&cell)[4]) {
  if (p < 0 || p >= (int64_t)B * (H + 1) * (W + 1)) return false;
  const int c0 = (int)(p % (W + 1));
  const int64_t q = p / (W + 1);
  const int r0 = (int)(q % (H + 1));
  const int64_t bb = q / (H + 1);
  const int yt = max(r0 - 1, 0), yb = min(r0, H - 1);
  const int xl = max(c0 - 1, 0), xr = min(c0, W - 1);
  cell[0] = (bb * H + yt) * W + xl;
  cell[1] = (bb * H + yt) * W + xr;
  cell[2] = (bb * H + yb) * W + xl;
  cell[3] = (bb * H + yb) * W + xr;
  return true;
}

template <typename TW, int V>
__global__ void __launch_bounds__(kThreads)
warp_bwd_kernel(const float* __restrict__ g, const TW* __restrict__ win,
                const int64_t* __restrict__ idx, const float* __restrict__ w4,
                const uint8_t* __restrict__ mask4,
                const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ dimg, float* __restrict__ dix,
                float* __restrict__ diy, int64_t n, int c, int B, int H,
                int W, int lanes_log2) {
  const int lanes = 1 << lanes_log2;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t s = t >> lanes_log2;
  const int lane = (int)(t & (lanes - 1));
  // every lane of the warp reaches the shuffles below; `live` guards the
  // memory accesses of the groups past the last sample
  const bool live = s < n;
  float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
  if (live) {
    float w[4] = {0.f, 0.f, 0.f, 0.f};
    int64_t cell[4] = {0, 0, 0, 0};
    if (dimg != nullptr && corner_cells(idx[s], B, H, W, cell))
      for (int k = 0; k < 4; ++k) w[k] = w4[s * 4 + k];
    const float* gs = g + s * c;
    const TW* ws = win + s * 4 * c;
    for (int ch = lane * V; ch < c; ch += lanes * V) {
      float gv[V];
      load<V>(gs + ch, gv);
      if (dix != nullptr) {
        float wv[V];
        load<V>(ws + ch, wv);
        for (int j = 0; j < V; ++j) d0 += wv[j] * gv[j];
        load<V>(ws + c + ch, wv);
        for (int j = 0; j < V; ++j) d1 += wv[j] * gv[j];
        load<V>(ws + 2 * c + ch, wv);
        for (int j = 0; j < V; ++j) d2 += wv[j] * gv[j];
        load<V>(ws + 3 * c + ch, wv);
        for (int j = 0; j < V; ++j) d3 += wv[j] * gv[j];
      }
      for (int k = 0; k < 4; ++k)
        if (w[k] != 0.f) add_to<V>(dimg + cell[k] * c + ch, w[k], gv);
    }
  }
  if (dix == nullptr) return;
  for (int o = lanes >> 1; o > 0; o >>= 1) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, o);
    d1 += __shfl_xor_sync(0xffffffffu, d1, o);
    d2 += __shfl_xor_sync(0xffffffffu, d2, o);
    d3 += __shfl_xor_sync(0xffffffffu, d3, o);
  }
  if (!live || lane != 0) return;
  if (mask4 != nullptr) {
    const uint8_t* m = mask4 + s * 4;
    if (!m[0]) d0 = 0.f;
    if (!m[1]) d1 = 0.f;
    if (!m[2]) d2 = 0.f;
    if (!m[3]) d3 = 0.f;
  }
  const float as = a[s], bs = b[s];
  dix[s] = (1.f - bs) * (d1 - d0) + bs * (d3 - d2);
  diy[s] = (1.f - as) * (d2 - d0) + as * (d3 - d1);
}

// C < 4 (FlowNet2's and SpyNet's 3-channel images): a thread per sample,
// and the image gradient accumulated 4 channels wide, so that each corner
// is one float4 atomic add (its 4th value 0) in place of C scalar ones;
// the caller copies the first C channels out.
template <typename TW>
__global__ void __launch_bounds__(kThreads)
warp_bwd_narrow_kernel(const float* __restrict__ g,
                       const TW* __restrict__ win,
                       const int64_t* __restrict__ idx,
                       const float* __restrict__ w4,
                       const uint8_t* __restrict__ mask4,
                       const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ dimg4,
                       float* __restrict__ dix, float* __restrict__ diy,
                       int64_t n, int c, int B, int H, int W) {
  const int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (s >= n) return;
  float gv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    if (ch < c) gv[ch] = g[s * c + ch];
  int64_t cell[4];
  if (dimg4 != nullptr && corner_cells(idx[s], B, H, W, cell)) {
    for (int k = 0; k < 4; ++k) {
      const float w = w4[s * 4 + k];
      if (w != 0.f) add_to<4>(dimg4 + cell[k] * 4, w, gv);
    }
  }
  if (dix == nullptr) return;
  float d[4];
  for (int k = 0; k < 4; ++k) {
    const TW* ws = win + (s * 4 + k) * c;
    float acc = 0.f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      if (ch < c) {
        float v[1];
        load<1>(ws + ch, v);
        acc += v[0] * gv[ch];
      }
    }
    d[k] = (mask4 != nullptr && !mask4[s * 4 + k]) ? 0.f : acc;
  }
  const float as = a[s], bs = b[s];
  dix[s] = (1.f - bs) * (d[1] - d[0]) + bs * (d[3] - d[2]);
  diy[s] = (1.f - as) * (d[2] - d[0]) + as * (d[3] - d[1]);
}

template <typename TW, int V>
int launch(const void* g, const void* win, const void* idx, const void* w4,
           const void* mask4, const void* a, const void* b, void* dimg,
           void* dix, void* diy, int64_t n, int c, int B, int H, int W,
           int lanes_log2, cudaStream_t stream) {
  const int64_t threads = n << lanes_log2;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  warp_bwd_kernel<TW, V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(g), static_cast<const TW*>(win),
      static_cast<const int64_t*>(idx), static_cast<const float*>(w4),
      static_cast<const uint8_t*>(mask4), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<float*>(dimg),
      static_cast<float*>(dix), static_cast<float*>(diy), n, c, B, H, W,
      lanes_log2);
  return (int)cudaGetLastError();
}

template <typename TW>
int launch_v(int vec, const void* g, const void* win, const void* idx,
             const void* w4, const void* mask4, const void* a, const void* b,
             void* dimg, void* dix, void* diy, int64_t n, int c, int B, int H,
             int W, int lanes_log2, cudaStream_t stream) {
  if (vec == 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    if (c >= 4 || lanes_log2 != 0 || blocks > 0x7fffffff)
      return (int)cudaErrorInvalidValue;
    warp_bwd_narrow_kernel<TW><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(g), static_cast<const TW*>(win),
        static_cast<const int64_t*>(idx), static_cast<const float*>(w4),
        static_cast<const uint8_t*>(mask4), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<float*>(dimg),
        static_cast<float*>(dix), static_cast<float*>(diy), n, c, B, H, W);
    return (int)cudaGetLastError();
  }
  switch (vec) {
    case 4: return launch<TW, 4>(g, win, idx, w4, mask4, a, b, dimg, dix,
                                 diy, n, c, B, H, W, lanes_log2, stream);
    case 2: return launch<TW, 2>(g, win, idx, w4, mask4, a, b, dimg, dix,
                                 diy, n, c, B, H, W, lanes_log2, stream);
    case 1: return launch<TW, 1>(g, win, idx, w4, mask4, a, b, dimg, dix,
                                 diy, n, c, B, H, W, lanes_log2, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// g: float32 (n, c); win: (n, 4, c) float32 (win_bf16 = 0) or bf16 (1);
// idx: int64 (n); w4, a, b: float32 (n, 4), (n), (n); mask4: bool (n, 4)
// or null (border mode). dimg: float32 (B, H, W, c), zero-filled by the
// caller, or null (no image gradient); dix, diy: float32 (n), or both null
// (no coordinate gradient). vec (1, 2, 4) divides c and every vector
// access is aligned to it; lanes_log2 in 0..5. vec = 0 (c < 4, lanes_log2
// 0) takes the narrow kernel, whose dimg is float32 (B, H, W, 4).
// Returns cudaGetLastError().
extern "C" int pcfa_warp_bwd(const void* g, const void* win, int win_bf16,
                             const void* idx, const void* w4,
                             const void* mask4, const void* a, const void* b,
                             void* dimg, void* dix, void* diy, int64_t n,
                             int c, int B, int H, int W, int vec,
                             int lanes_log2, void* stream) {
  if (n < 0 || c <= 0 || B <= 0 || H <= 0 || W <= 0 || vec < 0 ||
      (vec > 0 && c % vec != 0) ||
      lanes_log2 < 0 || lanes_log2 > 5 || (dix == nullptr) != (diy == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || (dimg == nullptr && dix == nullptr)) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  return win_bf16
             ? launch_v<uint16_t>(vec, g, win, idx, w4, mask4, a, b, dimg,
                                  dix, diy, n, c, B, H, W, lanes_log2, st)
             : launch_v<float>(vec, g, win, idx, w4, mask4, a, b, dimg, dix,
                               diy, n, c, B, H, W, lanes_log2, st);
}
