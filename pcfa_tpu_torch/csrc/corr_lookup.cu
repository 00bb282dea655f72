// Correlation-window lookup of RAFT's materialized pyramid, forward and
// accumulating backward, for sm_90a.
//
// Replaces the Pallas kernels of pcfa_tpu/ops/pallas/corr_lookup.py:
// `_vslice_fwd_impl` (the vertical 2-tap blend, with an XLA einsum for the
// horizontal step) and `_vslice_bwd` (its transpose). Here the whole 2-D
// window is one kernel.
//
// Math. All (2r+1)^2 samples of one query at one level share a single
// fractional offset (fx, fy), because the window offsets are integers. So
// the window reads one (P+1)x(P+1) patch (P = 2r+1) with its top-left cell
// at (floor(x)-r, floor(y)-r), zero outside the map, and blends it:
//   out[n, l*P*P + a*P + b] = bilinear sample at (x + a - r, y + b - r).
// The FIRST offset index a moves x: the reference's transposed-window
// quirk (pcfa_tpu/ops/correlation.py:149-174).
//
// Bound on the H100 (RAFT at 376x1248, B = 2, bf16: N = 14,664 queries,
// levels 47x156, 23x78, 11x39, 5x19): the forward writes N*4*81 outputs
// (9.5 MB) and reads at most N*4*100 patch cells (11.7 MB); the backward
// reads the 9.5 MB cotangent and read-modify-writes at most the same 11.7
// MB of patch cells: ~6 and ~10 us at 3.35 TB/s.
//
// Design. One warp per query, all levels in one warp, the radius a
// template parameter (so every index division is by a constant).
// Forward: the lanes first issue every 16-byte load that covers a patch
// row (a row is P+1 values at any offset, so a few aligned words cover
// it; rows are split into (row, word) items, levels taken four at a time),
// then store the words as loaded into shared memory, out-of-map values
// zeroed, with each row's offset. One lane per window column (level, x
// offset a) blends the P+1 patch rows horizontally once and each pair of
// neighbouring rows vertically, writing its P outputs into a
// shared-memory copy of the query's output row laid out with the row's
// own 16-byte alignment; the warp writes that row as 16-byte stores
// (partial words at its two ends element by element, since they hold
// neighbouring queries' values).
// Backward: the warp reads the query's cotangent row (L*P*P values) by
// 16-byte loads into shared memory. One lane per patch column (level,
// column; consecutive lanes on consecutive columns, so a warp's accesses
// to one patch row coalesce) loads the old gradient of its in-map cells
// first, then adds each cell's <= 4 window cotangents.
// The gradient maps are buffers the caller owns and zero-fills once per
// backward pass: the kernel adds into them, so successive lookups on one
// pyramid accumulate in place, ordered by the stream. Each query owns its
// own map, so no atomics are needed, and only in-map patch cells are
// touched. The sum is taken in the maps' dtype: each launch's cell
// gradient is rounded to it and added with one more rounding, as
// autograd's sum of per-lookup gradients does.
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): both kernels sit well
// above their byte bounds. The forward is held in the SM (with every map
// resident in L2 it still takes ~9/10 of its time). The backward's cells
// are 10-cell runs of a row each, so it moves whole 32-byte sectors,
// about twice the cells' bytes; that split is not measured.
// The integer corner is clipped before any index arithmetic, so non-finite
// or exploding coordinates cannot index out of bounds: a clipped window
// lies wholly outside the map.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxRadius = 7;
constexpr int kGroup = 4;       // levels whose loads are issued together
constexpr int kMaxWarps = 4;    // queries per block
constexpr int kBlockSmem = 48 * 1024;

struct Levels {
  void* map[kMaxLevels];  // forward: the maps; backward: gradient buffers
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// A 16-byte word of T values: V per word, value j as float, raw bits.
template <typename T>
struct Word;

template <>
struct Word<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static float get(const uint4& w, int j) {
    const uint32_t b = j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
    return __uint_as_float(b);
  }
  __device__ __forceinline__ static void put(uint4& w, int j,
                                             const float* p) {
    const uint32_t b = __float_as_uint(*p);
    if (j == 0) w.x = b; else if (j == 1) w.y = b;
    else if (j == 2) w.z = b; else w.w = b;
  }
};

template <>
struct Word<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static float get(const uint4& w, int j) {
    const int q = j >> 1;
    const uint32_t b = q == 0 ? w.x : q == 1 ? w.y : q == 2 ? w.z : w.w;
    return __uint_as_float((j & 1) ? (b & 0xffff0000u) : (b << 16));
  }
  __device__ __forceinline__ static void put(uint4& w, int j,
                                             const __nv_bfloat16* p) {
    const uint32_t h = *reinterpret_cast<const unsigned short*>(p);
    const int q = j >> 1;
    const uint32_t keep = (j & 1) ? 0x0000ffffu : 0xffff0000u;
    const uint32_t v = (j & 1) ? (h << 16) : h;
    if (q == 0) w.x = (w.x & keep) | v; else if (q == 1) w.y = (w.y & keep) | v;
    else if (q == 2) w.z = (w.z & keep) | v; else w.w = (w.w & keep) | v;
  }
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// First patch cell along one axis and the shared fractional offset. The
// corner is clipped into [-(P+1), extent]: beyond either end the patch is
// wholly outside the map, so clipping changes nothing but keeps NaN/inf
// coordinates (fmaxf/fminf return the non-NaN operand) in int range.
__device__ __forceinline__ void corner(float c, float scale, int radius,
                                       int extent, int* first, float* frac) {
  const float s = c * scale;
  const float f = floorf(s);
  *frac = s - f;
  const float lo = fminf(fmaxf(f - (float)radius, -(float)(2 * radius + 2)),
                         (float)extent);
  *first = (int)lo;
}

// Zero the values of a word outside [lo, hi).
__device__ __forceinline__ uint32_t keep_bits(int j, int lo, int hi,
                                              uint32_t bits) {
  return (j >= lo && j < hi) ? bits : 0u;
}
__device__ __forceinline__ uint4 mask_word(uint4 w, int lo, int hi, float*) {
  return make_uint4(keep_bits(0, lo, hi, 0xffffffffu) & w.x,
                    keep_bits(1, lo, hi, 0xffffffffu) & w.y,
                    keep_bits(2, lo, hi, 0xffffffffu) & w.z,
                    keep_bits(3, lo, hi, 0xffffffffu) & w.w);
}
__device__ __forceinline__ uint4 mask_word(uint4 w, int lo, int hi,
                                           __nv_bfloat16*) {
  uint32_t m[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    m[q] = keep_bits(2 * q, lo, hi, 0x0000ffffu) |
           keep_bits(2 * q + 1, lo, hi, 0xffff0000u);
  return make_uint4(w.x & m[0], w.y & m[1], w.z & m[2], w.w & m[3]);
}

// Per-warp shared memory, every part 16-byte aligned: a head with each
// level's corner (x0, y0, fx, fy) and the query's map base; the query's
// row of outputs (forward) or cotangents (backward) in T, shifted to its
// own 16-byte alignment; and, forward only, each patch row's read offset
// and the patch rows as loaded: NW aligned words per row, so a row's cell
// c sits at its offset + c.
constexpr int kHeadBytes = 4 * kMaxLevels * 4 + kMaxLevels * 8;

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}
__host__ __device__ constexpr int words_per_row(int radius, int esz) {
  return (2 * radius + 2 + 2 * (16 / esz) - 2) / (16 / esz);
}
__host__ __device__ constexpr int row_bytes(int radius, int levels, int esz) {
  return round16((levels * (2 * radius + 1) * (2 * radius + 1) + 16 / esz) *
                 esz);
}
__host__ __device__ constexpr int offsets_bytes(int radius, int levels) {
  return round16(levels * (2 * radius + 2) * 4);
}
__host__ __device__ constexpr int warp_bytes(bool fwd, int radius, int levels,
                                             int esz) {
  return kHeadBytes + row_bytes(radius, levels, esz) +
         (fwd ? offsets_bytes(radius, levels) +
                    levels * (2 * radius + 2) * words_per_row(radius, esz) *
                        16
              : 0);
}

template <typename T>
struct Head {
  int* cx;
  int* cy;
  float* fx;
  float* fy;
  T** base;  // the query's map (forward) or gradient buffer, per level
};

// The head of this warp's shared memory; lanes 0..L-1 fill level `lane`.
template <typename T>
__device__ __forceinline__ Head<T> setup(unsigned char* ws, const Levels& lv,
                                         const float* coords, int n,
                                         int num_levels, int radius,
                                         int lane) {
  Head<T> hd;
  hd.cx = reinterpret_cast<int*>(ws);
  hd.cy = hd.cx + kMaxLevels;
  hd.fx = reinterpret_cast<float*>(hd.cy + kMaxLevels);
  hd.fy = hd.fx + kMaxLevels;
  hd.base = reinterpret_cast<T**>(hd.fy + kMaxLevels);
  if (lane < num_levels) {
    const float scale = 1.0f / (float)(1 << lane);
    const int H = lv.h[lane], W = lv.w[lane];
    corner(coords[2 * (int64_t)n], scale, radius, W, &hd.cx[lane],
           &hd.fx[lane]);
    corner(coords[2 * (int64_t)n + 1], scale, radius, H, &hd.cy[lane],
           &hd.fy[lane]);
    hd.base[lane] = static_cast<T*>(lv.map[lane]) + (int64_t)n * H * W;
  }
  return hd;
}

// The forward for query n, by one warp, in its shared memory `ws`.
template <typename T, int R>
__device__ __forceinline__ void fwd_query(const Levels& lv,
                                          const float* __restrict__ coords,
                                          T* __restrict__ out, int n,
                                          int n_query, int num_levels,
                                          unsigned char* ws, int lane) {
  constexpr int P = 2 * R + 1, S = P + 1, PP = P * P;
  constexpr int V = Word<T>::V;
  constexpr int NW = words_per_row(R, (int)sizeof(T));
  constexpr int RP = NW * V;               // row pitch of the patch rows
  constexpr int IPL = (S * NW + 31) / 32;  // (row, word) items per lane
  const Head<T> hd = setup<T>(ws, lv, coords, n, num_levels, R, lane);
  const int lpp = num_levels * PP;
  T* stage = reinterpret_cast<T*>(ws + kHeadBytes);
  int* roff = reinterpret_cast<int*>(ws + kHeadBytes +
                                     row_bytes(R, num_levels, sizeof(T)));
  T* rows = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(roff) +
                                 offsets_bytes(R, num_levels));
  // only the first and last query's words can reach outside the maps
  const bool edge = n == 0 || n == n_query - 1;
  __syncwarp();

  for (int g0 = 0; g0 < num_levels; g0 += kGroup) {
    uint4 word[kGroup][IPL];
    int lo[kGroup][IPL], hi[kGroup][IPL];  // in-map values of the word
    // every load of the group is issued before any is used
#pragma unroll
    for (int gl = 0; gl < kGroup; ++gl) {
#pragma unroll
      for (int i = 0; i < IPL; ++i) {
        word[gl][i] = make_uint4(0u, 0u, 0u, 0u);
        lo[gl][i] = hi[gl][i] = 0;
        const int l = g0 + gl, t = lane + 32 * i;
        if (l >= num_levels || t >= S * NW) continue;
        const int u = t / NW, w = t - u * NW;
        const int H = lv.h[l], W = lv.w[l], x0 = hd.cx[l], y = hd.cy[l] + u;
        const T* row = hd.base[l] + (y * W + x0);  // the patch row's cell 0
        const int sh = (int)(((uintptr_t)row & 15) / sizeof(T));
        const int c0 = w * V - sh;  // patch column of the word's value 0
        if (w == 0) roff[l * S + u] = u * RP + sh;
        if (y < 0 || y >= H || c0 >= S) continue;
        const int jlo = max(0, -x0 - c0), jhi = min(V, W - x0 - c0);
        if (jlo >= jhi) continue;
        lo[gl][i] = jlo;
        hi[gl][i] = jhi;
        const T* wp = reinterpret_cast<const T*>((uintptr_t)row &
                                                 ~(uintptr_t)15) + w * V;
        const T* first = static_cast<const T*>(lv.map[l]);
        if (!edge || (wp >= first && wp + V <= first + (int64_t)n_query *
                                                           H * W)) {
          word[gl][i] = __ldg(reinterpret_cast<const uint4*>(wp));
        } else {  // a word past the maps' ends: its in-map values only
#pragma unroll
          for (int j = 0; j < V; ++j)
            if (j >= jlo && j < jhi) Word<T>::put(word[gl][i], j, wp + j);
        }
      }
    }
    // the patch rows as loaded, out-of-map values zeroed
#pragma unroll
    for (int gl = 0; gl < kGroup; ++gl) {
#pragma unroll
      for (int i = 0; i < IPL; ++i) {
        const int l = g0 + gl, t = lane + 32 * i;
        if (l >= num_levels || t >= S * NW) continue;
        const int u = t / NW, w = t - u * NW;
        uint4 v = word[gl][i];
        if (lo[gl][i] > 0 || hi[gl][i] < V)
          v = mask_word(v, lo[gl][i], hi[gl][i], (T*)nullptr);
        *reinterpret_cast<uint4*>(rows + (l * S + u) * RP + w * V) = v;
      }
    }
  }
  __syncwarp();

  // one window column (level l, offset a) per lane: each patch row's
  // horizontal blend once, shared by the column's two neighbouring outputs
  T* orow = out + (int64_t)n * lpp;
  const int sh = (int)(((uintptr_t)orow & 15) / sizeof(T));
  for (int col = lane; col < num_levels * P; col += 32) {
    const unsigned l = (unsigned)col / P, a = (unsigned)col - l * P;
    const T* lr = rows + l * S * RP + a;
    const int* ro = roff + l * S;
    const float fx = hd.fx[l], fy = hd.fy[l];
    T* st = stage + sh + l * PP + a * P;  // outputs a*P + b, b moves y
    float top = (1.0f - fx) * to_f(lr[ro[0]]) + fx * to_f(lr[ro[0] + 1]);
#pragma unroll
    for (int b = 0; b < P; ++b) {
      const T* r = lr + ro[b + 1];
      const float bot = (1.0f - fx) * to_f(r[0]) + fx * to_f(r[1]);
      st[b] = from_f<T>((1.0f - fy) * top + fy * bot);
      top = bot;
    }
  }
  __syncwarp();
  const int nchunk = (sh + lpp + V - 1) / V;
  for (int c = lane; c < nchunk; c += 32) {
    const int k0 = c * V - sh;
    if (k0 >= 0 && k0 + V <= lpp) {
      *reinterpret_cast<uint4*>(orow + k0) =
          *reinterpret_cast<const uint4*>(stage + c * V);
    } else {
      for (int j = 0; j < V; ++j)
        if (k0 + j >= 0 && k0 + j < lpp) orow[k0 + j] = stage[sh + k0 + j];
    }
  }
}

// The backward for query n, by one warp, in its shared memory `ws`.
template <typename T, int R>
__device__ __forceinline__ void bwd_query(const Levels& lv,
                                          const float* __restrict__ coords,
                                          const T* __restrict__ grad_out,
                                          int n, int n_query, int num_levels,
                                          unsigned char* ws, int lane) {
  constexpr int P = 2 * R + 1, S = P + 1, PP = P * P;
  constexpr int V = Word<T>::V;
  T* stage = reinterpret_cast<T*>(ws + kHeadBytes);

  // the query's cotangent row by 16-byte loads (the words at its ends also
  // hold neighbouring rows' values, which are not used)
  const int lpp = num_levels * PP;
  const T* grow = grad_out + (int64_t)n * lpp;
  const int sh = (int)(((uintptr_t)grow & 15) / sizeof(T));
  const T* gbase = grow - sh;
  const bool edge = n == 0 || n == n_query - 1;
  const int nchunk = (sh + lpp + V - 1) / V;
  for (int c = lane; c < nchunk; c += 32) {
    const T* wp = gbase + c * V;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (!edge || (wp >= grad_out &&
                  wp + V <= grad_out + (int64_t)n_query * lpp)) {
      v = __ldg(reinterpret_cast<const uint4*>(wp));
    } else {
      for (int j = 0; j < V; ++j) {
        const int k = c * V + j - sh;
        if (k >= 0 && k < lpp) Word<T>::put(v, j, grow + k);
      }
    }
    *reinterpret_cast<uint4*>(stage + c * V) = v;
  }
  const Head<T> hd = setup<T>(ws, lv, coords, n, num_levels, R, lane);
  __syncwarp();
  const T* g = stage + sh;

  // one patch column (level l, column v) per lane, consecutive lanes on
  // consecutive columns: the old values of its in-map cells are loaded
  // first, then each cell adds its window cotangents: columns a = v
  // (weight 1-fx) and a = v-1 (fx), each over rows b = u (1-fy) and
  // b = u-1 (fy)
  for (int col = lane; col < num_levels * S; col += 32) {
    const unsigned l = (unsigned)col / S, v = (unsigned)col - l * S;
    const int H = lv.h[l], W = lv.w[l];
    const int x = hd.cx[l] + (int)v, y0 = hd.cy[l];
    if (x < 0 || x >= W) continue;
    T* cp = hd.base[l] + x;
    float old[S], acc[S];
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int y = y0 + u;
      old[u] = (y >= 0 && y < H) ? to_f(cp[y * W]) : 0.0f;
      acc[u] = 0.0f;
    }
    const float fx = hd.fx[l], fy = hd.fy[l];
#pragma unroll
    for (int da = 0; da < 2; ++da) {
      const int a = (int)v - da;
      if (a < 0 || a >= P) continue;
      const float wx = da == 0 ? 1.0f - fx : fx;
      const T* ga = g + l * PP + a * P;
      float above = 0.0f;  // the cotangent of row b = u-1
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const float here = u < P ? to_f(ga[u]) : 0.0f;
        acc[u] += wx * ((1.0f - fy) * here + fy * above);
        above = here;
      }
    }
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int y = y0 + u;
      if (y >= 0 && y < H)
        cp[y * W] = from_f<T>(old[u] + to_f(from_f<T>(acc[u])));
    }
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kMaxWarps * 32)
corr_window_fwd_kernel(const __grid_constant__ Levels lv,
                       const float* __restrict__ coords,
                       T* __restrict__ out, int n_query, int num_levels,
                       int wbytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n < n_query)  // whole warp; only __syncwarp inside
    fwd_query<T, R>(lv, coords, out, n, n_query, num_levels,
                    smem + warp * wbytes, lane);
}

template <typename T, int R>
__global__ void __launch_bounds__(kMaxWarps * 32)
corr_window_bwd_kernel(const __grid_constant__ Levels lv,
                       const float* __restrict__ coords,
                       const T* __restrict__ grad_out, int n_query,
                       int num_levels, int wbytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n < n_query)
    bwd_query<T, R>(lv, coords, grad_out, n, n_query, num_levels,
                    smem + warp * wbytes, lane);
}

bool valid_args(int dtype, int num_levels, int radius, int n_query) {
  return (dtype == 0 || dtype == 1) && num_levels >= 1 &&
         num_levels <= kMaxLevels && radius >= 0 && radius <= kMaxRadius &&
         n_query >= 0;
}

Levels make_levels(int num_levels, void* const* maps, const int* heights,
                   const int* widths) {
  Levels lv = {};
  for (int l = 0; l < num_levels; ++l) {
    lv.map[l] = maps[l];
    lv.h[l] = heights[l];
    lv.w[l] = widths[l];
  }
  return lv;
}

template <typename T, int R>
int launch(bool fwd, const Levels& lv, const float* coords, void* row,
           int n_query, int num_levels, cudaStream_t s) {
  const int wbytes = warp_bytes(fwd, R, num_levels, (int)sizeof(T));
  int warps = kBlockSmem / wbytes;
  warps = warps < 1 ? 1 : warps > kMaxWarps ? kMaxWarps : warps;
  const dim3 grid((n_query + warps - 1) / warps), block(32 * warps);
  // the L1/shared split stays the default: both kernels' loads go
  // through L1, and the largest shared carve-out made them 5-14% slower
  const size_t smem = (size_t)warps * wbytes;
  if (fwd)
    corr_window_fwd_kernel<T, R><<<grid, block, smem, s>>>(
        lv, coords, static_cast<T*>(row), n_query, num_levels, wbytes);
  else
    corr_window_bwd_kernel<T, R><<<grid, block, smem, s>>>(
        lv, coords, static_cast<const T*>(row), n_query, num_levels, wbytes);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(bool fwd, int radius, const Levels& lv, const float* coords,
             void* row, int n_query, int num_levels, cudaStream_t s) {
  switch (radius) {
    case 0: return launch<T, 0>(fwd, lv, coords, row, n_query, num_levels, s);
    case 1: return launch<T, 1>(fwd, lv, coords, row, n_query, num_levels, s);
    case 2: return launch<T, 2>(fwd, lv, coords, row, n_query, num_levels, s);
    case 3: return launch<T, 3>(fwd, lv, coords, row, n_query, num_levels, s);
    case 4: return launch<T, 4>(fwd, lv, coords, row, n_query, num_levels, s);
    case 5: return launch<T, 5>(fwd, lv, coords, row, n_query, num_levels, s);
    case 6: return launch<T, 6>(fwd, lv, coords, row, n_query, num_levels, s);
    case 7: return launch<T, 7>(fwd, lv, coords, row, n_query, num_levels, s);
  }
  return (int)cudaErrorInvalidValue;
}

int run(bool fwd, int dtype, int num_levels, void* const* maps,
        const int* heights, const int* widths, const void* coords, void* row,
        int n_query, int radius, void* stream) {
  if (!valid_args(dtype, num_levels, radius, n_query))
    return (int)cudaErrorInvalidValue;
  if (n_query == 0) return 0;
  const Levels lv = make_levels(num_levels, maps, heights, widths);
  const float* c = static_cast<const float*>(coords);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? dispatch<float>(fwd, radius, lv, c, row, n_query, num_levels, s)
             : dispatch<__nv_bfloat16>(fwd, radius, lv, c, row, n_query,
                                       num_levels, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (maps, output and cotangent alike);
// maps: one contiguous (n_query, H, W) map per level; coords: float32
// (n_query, 2) in level-0 pixels; out: (n_query, num_levels * P * P);
// radius <= 7. Returns cudaGetLastError() after the launch.
extern "C" int pcfa_corr_window_fwd(int dtype, int num_levels,
                                    void* const* maps,
                                    const int* heights, const int* widths,
                                    const void* coords, void* out,
                                    int n_query, int radius, void* stream) {
  return run(true, dtype, num_levels, maps, heights, widths, coords, out,
             n_query, radius, stream);
}

// dmaps: one gradient buffer per level, shaped like the maps and owned by
// the caller, which zero-fills them once; the kernel ADDS the window's
// gradient into their in-map patch cells. grad_out: (n_query, num_levels
// * P * P).
extern "C" int pcfa_corr_window_bwd(int dtype, int num_levels,
                                    void* const* dmaps,
                                    const int* heights, const int* widths,
                                    const void* coords, const void* grad_out,
                                    int n_query, int radius, void* stream) {
  return run(false, dtype, num_levels, dmaps, heights, widths, coords,
             const_cast<void*>(grad_out), n_query, radius, stream);
}
