// Patch correlation of two channels-last feature maps, forward and
// backward (df1, df2), for sm_90a.
//
// Replaces the Pallas kernels of pcfa_tpu/ops/pallas/local_corr.py:
// `_forward` (resident or DMA-streamed f2 slabs, one output channel per
// unrolled shift) and `_backward` (`_dgrad1_kernel` / `_dgrad2_kernel`
// over pre-gathered halo slabs, with XLA fallbacks for tiny maps and for
// patch^2 > 128). Here every map size and every odd patch <= 21 with
// (patch-1)/2 * stride <= 20 runs the kernels.
//
// Math, with R = (patch-1)/2 * stride, shift p = iy*patch + ix,
// dy = iy*stride - R (rows), dx = ix*stride - R (columns), zero padding:
//   out[b,y,x,p]  = sum_c f1[b,y,x,c] * f2[b,y+dy,x+dx,c] / C
//   df1[b,y,x,c]  = sum_p g[b,y,x,p] * f2[b,y+dy,x+dx,c] / C
//   df2[b,y,x,c]  = sum_p g[b,y-dy,x-dx,p] * f1[b,y-dy,x-dx,c] / C
// PWCNet uses patch 9, stride 1 (81 channels); FlowNetC patch 21,
// stride 2 (441 channels).
//
// Bound on the H100 (bf16, B = 1): bytes at every PWCNet level. The
// largest, level 2 (96x320, C = 32), moves 2 x 2.0 MB of features and
// 5.0 MB of output per forward (2.7 us at 3.35 TB/s) for 0.16 GFLOP;
// level 6 (6x20, C = 196) moves 0.11 MB (0.03 us). FlowNetC (48x160,
// C = 256, patch 21 stride 2) moves 14.7 MB (4.4 us) for 1.7 GFLOP of
// useful products (1.8 us at the 989 TFLOP/s bf16 peak): bytes too,
// though the band below runs 2.7x those products on the tensor cores.
//
// What held the first design back was latency: every block walked its
// channels in 16-channel chunks of 2-byte loads between two barriers, and
// the backward re-read each feature element 81 times through L1/L2, one
// thread per output element. Measured on the H100, what holds this one
// back is instructions and their latency, not bytes: the band keeps 3/8
// of the products, and small maps give few blocks. This design:
//
// Tiling (both directions; planned per shape in ops/local_corr.py). A
// block owns TH output rows (stride rows apart, so that with stride 2 the
// rows of one parity share their f2 rows), 16*MF columns, and for the
// forward a run of PB shift rows. It stages its f1 tile (or g) and the
// TH + PB - 1 feature halo rows that those rows meet, each once, by
// cp.async issued all at once per stage (16-, 8- or 4-byte copies as the
// pixel stride allows; bf16 maps with odd C element by element), zero-
// filled outside the map, in a [pixel][channel] layout whose pixel pitch
// is an odd number of 16-byte units (ldmatrix without bank conflicts).
// Channel chunks are double-buffered where the plan takes more than one
// and two buffers fit. Index arithmetic avoids integer division by
// run-time values (fdiv below).
//
// Forward, bf16: a banded product on the tensor cores. For output row y,
// shift row iy and 16 pixels x0..x0+15, the halo is f2 row y+dy, columns
// x0-R .. x0+15+R; the 16 x (16+2R) product F1_tile . F2_halo^T over C
// runs as mma.sync m16n8k16 (bf16 in, float32 accumulators; A and B both
// by ldmatrix straight from [pixel][channel]). The block keeps the band:
// entry (x, h) is shift ix = (h - x) / stride when that is a whole number
// in [0, patch), which is also the stride-2 even-offset selection. Bands
// go to a float [pixel][shift] tile in shared memory (stored once where
// the plan has one chunk and no k split, else added, atomically where
// warps split one product's channels, the plan's choice for the small
// levels), which is scaled by 1/C and written as the block's contiguous
// span of out in paired bf16 stores.
//
// Backward, bf16: both gradients in one launch (grid.z picks df1 or
// df2), no atomics. With G_iy the 16 x (16+2R) band built from g's shift
// row iy (zero off the band):
//   df1[y, x0:x0+16, :] += G_iy . F2_halo[y+dy]      (g of row y)
//   df2[y, x0:x0+16, :] += H_iy . F1_halo[y-dy]      (g of row y-dy)
// Each is a product of a band matrix (A, built in registers from g staged
// in shared memory, once for up to 4 16-channel groups) and a staged
// [pixel][channel] tile (B by ldmatrix.trans), accumulated over the
// patch's shift rows in registers; a block owns chunks of channels (the N
// dimension), so its products run back to back with no barrier. g
// arrives as whole rows by 16-byte cp.async, or, for df2 where that
// stages too much (FlowNetC's 441 shifts), as runs of the P entries that
// reach the block.
//
// float32 keeps the CUDA cores (TF32 would miss 1e-4) on the same tiling
// and staging: a thread of the forward owns a pixel and up to 4 (patch
// <= 9) or 2 of the (row, shift row) pairs that read one halo row, with
// their sums in registers; a thread of the backward owns one (pixel,
// channel) of a gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxPatch = 21;
constexpr int kMaxR = 20;
// float32 forward: rows per thread (F32Item), by the bound on the patch:
// as many sums as the registers of two resident blocks hold
__host__ __device__ constexpr int f32_rows(int pm) {
  return pm <= 9 ? 4 : 2;
}

// The plan of ops/local_corr.py, in the order of its PLAN_FIELDS.
struct Plan {
  int th;       // output rows per block (stride rows apart)
  int mf;       // 16-pixel fragments per row: 16*mf columns per block
  int nf;       // fwd: 8-column halo fragments per 16 pixels; bwd: k steps
                // of 16 halo columns per shift row
  int pb;       // fwd: shift rows per block (bwd: patch)
  int kc;       // channels per stage (fwd: the K chunk, bwd: the N chunk)
  int nchunk;   // chunks over C
  int ksplit;   // fwd, bf16: warps that split one product's k steps
  int cgroups;  // bwd: blocks along the channel chunks
  int nbuf;     // stage buffers (2: the next chunk loads during the MMAs)
  int threads;
  int hws;      // staged halo width in pixels
  int rows;     // staged halo rows
  int pitch;    // bytes per staged pixel
  int stage_bytes;  // one stage buffer (the forward's out tile follows)
  int g_bytes;      // bwd: staged g, before the stage buffers
  int smem;
  int gx, gy, gz;
  int gmode;    // bwd: 1, df2 stages whole rows of g; 0, runs of P
  int gcap;     // bwd: elements per staged row of g
  int ngroup;   // bwd, bf16: 16-channel groups per warp item
};
constexpr int kPlanInts = 22;

struct Args {
  const void* f1;
  const void* f2;
  const void* g;
  void* out;
  void* df1;
  void* df2;
  int H, W, C, P, S, R, ub;
  float inv_c, inv_s;
  Plan p;
};

// n / d for 0 <= n < 2^21, by the float reciprocal inv = 1.f / d: (n +
// 0.5) / d lies at least 0.5 / d from a whole number, well beyond the
// rounding of the product (integer division by a value known only at run
// time costs ~20 instructions; this costs 3)
__device__ __forceinline__ int fdiv(int n, float inv) {
  return __float2int_rz((static_cast<float>(n) + 0.5f) * inv);
}

// shift ix of band offset d (a halo column minus a pixel, or the mirror
// of that for df2): d / S when d >= 0 is a multiple of S below P, else -1
__device__ __forceinline__ int band_shift(int d, int S, int P, float inv_s) {
  if (d < 0) return -1;
  const int q = fdiv(d, inv_s);
  return (q * S == d && q < P) ? q : -1;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ uint16_t from_f<uint16_t>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// ub bytes (16, 8 or 4), or ub zero bytes when !ok (nothing is read then)
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int ub, bool ok) {
  const int n = ok ? ub : 0;
  if (ub == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
  else if (ub == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The rows x cols pixels of a tile (rows `ystep` apart from y0, columns
// from x0) of one image (H x W x C of T), channels [c0, c0 + kc), into
// shared memory at `dst`, one pixel per `pitch` bytes; zero outside the
// map and past channel C. ub: bytes per copy, 16, 8 or 4 by cp.async
// (ub / sizeof(T) divides C), or 2 for bf16 maps copied element by element.
template <typename T>
__device__ __forceinline__ void stage_tile(unsigned char* dst, int pitch,
                                           const T* img, const Args& a,
                                           int rows, int cols, int y0,
                                           int ystep, int x0, int c0, int kc) {
  const int ub = a.ub, per = ub / (int)sizeof(T);
  const int upp = kc / per, n = rows * cols * upp;
  const float inv_upp = 1.0f / upp, inv_cols = 1.0f / cols;
  const uint32_t d0 = smem_u32(dst);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int px = fdiv(i, inv_upp), u = i - px * upp;
    const int row = fdiv(px, inv_cols), col = px - row * cols;
    const int yy = y0 + row * ystep, xx = x0 + col, c = c0 + u * per;
    const bool ok = yy >= 0 && yy < a.H && xx >= 0 && xx < a.W && c < a.C;
    const T* src = ok ? img + ((int64_t)yy * a.W + xx) * a.C + c : img;
    const int off = px * pitch + u * ub;
    if (ub >= 4)
      cp_async(d0 + off, src, ub, ok);
    else
      *reinterpret_cast<T*>(dst + off) = ok ? *src : T(0);
  }
}

// The block's place in the grid, shared by every kernel: x tile, row
// class (stride rows interleave), row tile; rows y = ybase + r * S. gimg:
// the block's image's first element of g (backward).
struct Tile {
  int x0, ybase;
  int64_t gimg;
};
__device__ __forceinline__ Tile tile_of(const Args& a, int b) {
  const int tw = 16 * a.p.mf;
  const int cls = blockIdx.y % a.S, t = blockIdx.y / a.S;
  return Tile{(int)blockIdx.x * tw, cls + a.S * t * a.p.th,
              (int64_t)b * a.H * a.W * a.P * a.P};
}

// ---------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------

// One stage of the forward: the f1 tile (th x tw pixels) and the halo
// (rows x hws pixels from row hy0, column hx0), channels of chunk k.
template <typename T>
__device__ __forceinline__ void fwd_stage(const Args& a, unsigned char* base,
                                         const T* f1, const T* f2, Tile t,
                                         int rows, int hy0, int k) {
  const Plan& p = a.p;
  const int tw = 16 * p.mf;
  stage_tile<T>(base, p.pitch, f1, a, p.th, tw, t.ybase, a.S, t.x0,
                k * p.kc, p.kc);
  stage_tile<T>(base + p.th * tw * p.pitch, p.pitch, f2, a, rows, p.hws, hy0,
                a.S, t.x0 - a.R, k * p.kc, p.kc);
  cp_async_commit();
}

// The MMAs of one staged chunk (bf16): items (r, shift row, fragment m,
// k part) over the warps; each puts its band into the float out tile `ot`
// ([pixel][pbe * P]). With one chunk and no k split each entry has one
// writer, which stores it (an item whose halo row lies outside the map
// runs on the staged zeros); else the tile starts at zero and items add.
template <int NF>
__device__ __forceinline__ void fwd_chunk_tc(const Args& a,
                                             unsigned char* base, float* ot,
                                             Tile t, int pbe, int hy0) {
  const Plan& p = a.p;
  const int tw = 16 * p.mf, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5, PB = pbe * a.P;
  const int ks = p.kc / 16, items = p.th * pbe * p.mf * p.ksplit;
  const bool add = p.nchunk > 1 || p.ksplit > 1;
  const uint32_t sa = smem_u32(base);
  const uint32_t sh = sa + p.th * tw * p.pitch;
  const int gq = lane >> 2, tq = lane & 3;
  // this lane's accumulator entries on the band: offset (pixel xi, shift
  // ix) in the out tile, or -1; xi = gq (+8 for e >= 2), halo column
  // 8j + 2tq (+1 for odd e)
  int boff[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int xi = gq + (e >= 2 ? 8 : 0);
      const int ix = band_shift(8 * j + 2 * tq + (e & 1) - xi, a.S, a.P,
                                a.inv_s);
      boff[j][e] = ix < 0 ? -1 : xi * PB + ix;
    }
  for (int it = threadIdx.x >> 5; it < items; it += nwarps) {
    int v = it / p.ksplit;
    const int kp = it - v * p.ksplit;
    const int m = v % p.mf;
    v /= p.mf;
    const int iyl = v % pbe, r = v / pbe, h = r + iyl;
    const int yy = hy0 + h * a.S;
    if (t.ybase + r * a.S >= a.H || (add && (yy < 0 || yy >= a.H))) continue;
    float acc[NF][4];
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    // A: pixel (lane & 15), k half (lane >> 4). B: lanes 0-7 fragment j,
    // k low; 8-15 fragment j, k high; 16-31 the same for fragment j + 1.
    const uint32_t arow =
        sa + (r * tw + m * 16 + (lane & 15)) * p.pitch + (lane >> 4) * 16;
    const uint32_t brow =
        sh + (h * p.hws + m * 16 + (lane & 7) + ((lane >> 4) << 3)) * p.pitch +
        ((lane >> 3) & 1) * 16;
    for (int kk = kp; kk < ks; kk += p.ksplit) {
      uint32_t af[4], bf[NF][2];
      ldsm_x4(af, arow + kk * 32);
#pragma unroll
      for (int j = 0; j + 1 < NF; j += 2) {
        uint32_t r4[4];
        ldsm_x4(r4, brow + j * 8 * p.pitch + kk * 32);
        bf[j][0] = r4[0], bf[j][1] = r4[1];
        bf[j + 1][0] = r4[2], bf[j + 1][1] = r4[3];
      }
      if constexpr (NF % 2 == 1)
        ldsm_x2(bf[NF - 1][0], bf[NF - 1][1],
                brow + (NF - 1) * 8 * p.pitch + kk * 32);
#pragma unroll
      for (int j = 0; j < NF; ++j) mma_k16(acc[j], af, bf[j][0], bf[j][1]);
    }
    // keep the band
    float* orow = ot + (r * tw + m * 16) * PB + iyl * a.P;
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (boff[j][e] < 0) continue;
        float* o = orow + boff[j][e];
        if (!add)
          *o = acc[j][e];
        else if (p.ksplit > 1)
          atomicAdd(o, acc[j][e]);
        else
          *o += acc[j][e];
      }
  }
}

// float32 forward (CUDA cores). Output row r with shift row iyl reads
// halo row h = r + iyl, so the pairs on one diagonal r + iyl = h share
// their f2 values. A thread owns one pixel x, one halo row h and up to
// f32_rows(PM) of that diagonal's rows (r0 ..): each f2 value it loads
// serves all of them, and its sums stay in registers across the channel
// chunks.
// The plan gives every such item a thread of its own (f32_runs).
struct F32Item {
  int h, x, r0, nq;
};

// items per block: tw pixels x the diagonals' runs of q rows
__host__ __device__ __forceinline__ int f32_runs(int th, int pbe, int q) {
  int n = 0;
  for (int h = 0; h < th + pbe - 1; ++h) {
    const int lo = h - pbe + 1 > 0 ? h - pbe + 1 : 0;
    const int hi = h < th - 1 ? h : th - 1;
    n += (hi - lo + q) / q;
  }
  return n;
}

__device__ __forceinline__ F32Item f32_item(const Plan& p, int pbe, int it,
                                            int q) {
  const int tw = 16 * p.mf;
  int run = it / tw;
  for (int h = 0; h < p.th + pbe - 1; ++h) {
    const int lo = max(0, h - pbe + 1), hi = min(p.th - 1, h);
    const int n = (hi - lo + q) / q;
    if (run < n) {
      const int r0 = lo + run * q;
      return F32Item{h, it % tw, r0, min(q, hi - r0 + 1)};
    }
    run -= n;
  }
  return F32Item{0, 0, 0, 0};
}

// One staged chunk (float32): the item's sums over the chunk's channels
// (past C the staged zeros). PM >= patch bounds the unrolled loops.
template <int PM>
__device__ __forceinline__ void fwd_chunk_f32(const Args& a,
                                              const unsigned char* base,
                                              const F32Item& w,
                                              float (&acc)[f32_rows(PM)][PM]) {
  const Plan& p = a.p;
  const int tw = 16 * p.mf, pst = p.pitch / 4, sst = a.S * pst;
  const float* sa = reinterpret_cast<const float*>(base);
  const float* fb = sa + (p.th * tw + w.h * p.hws + w.x) * pst;
  constexpr int Q = f32_rows(PM);
  const float* fa[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q)
    fa[q] = sa + ((w.r0 + min(q, w.nq - 1)) * tw + w.x) * pst;
#pragma unroll 2
  for (int c = 0; c < p.kc; ++c) {
    float v2[PM];
#pragma unroll
    for (int ix = 0; ix < PM; ++ix)
      v2[ix] = ix < a.P ? fb[ix * sst + c] : 0.0f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (q >= w.nq) break;  // one value across each 16 pixels
      const float v1 = fa[q][c];
#pragma unroll
      for (int ix = 0; ix < PM; ++ix) acc[q][ix] += v1 * v2[ix];
    }
  }
}

// The out tile, scaled by 1/C, to out: with every shift row in the block
// each row's valid pixels are one contiguous span, written in pairs
// (4-byte stores for bf16); else one run of pbe * P per pixel.
template <typename T>
__device__ __forceinline__ void fwd_write(const Args& a, const float* ot,
                                         T* out, Tile t, int iy0, int pbe) {
  const Plan& p = a.p;
  const int tw = 16 * p.mf, PB = pbe * a.P, P2 = a.P * a.P;
  const int nvalid = min(tw, a.W - t.x0);
  for (int r = 0; r < p.th; ++r) {
    const int y = t.ybase + r * a.S;
    if (y >= a.H) break;
    const float* src = ot + r * tw * PB;
    T* dst = out + ((int64_t)y * a.W + t.x0) * P2 + iy0 * a.P;
    if (PB == P2) {
      const int n = nvalid * P2;
      if constexpr (sizeof(T) == 2) {
        // one element first where the span starts between 4-byte words
        const int head = (int)(((uintptr_t)dst >> 1) & 1);
        if (head && threadIdx.x == 0) dst[0] = from_f<T>(src[0] * a.inv_c);
        const int npair = (n - head) >> 1;
        for (int q = threadIdx.x; q < npair; q += blockDim.x) {
          const int e = head + 2 * q;
          const uint32_t lo = from_f<uint16_t>(src[e] * a.inv_c);
          const uint32_t hi = from_f<uint16_t>(src[e + 1] * a.inv_c);
          *reinterpret_cast<uint32_t*>(dst + e) = lo | (hi << 16);
        }
        if (((n - head) & 1) && threadIdx.x == 0)
          dst[n - 1] = from_f<T>(src[n - 1] * a.inv_c);
      } else {
        for (int e = threadIdx.x; e < n; e += blockDim.x)
          dst[e] = from_f<T>(src[e] * a.inv_c);
      }
    } else {
      for (int i = threadIdx.x; i < nvalid * PB; i += blockDim.x) {
        const int x = i / PB, kk = i - x * PB;
        dst[(int64_t)x * P2 + kk] = from_f<T>(src[i] * a.inv_c);
      }
    }
  }
}

// T: float (CUDA cores, NF: a bound on the patch; 256 threads at most, and
// registers for two resident blocks) or uint16_t holding bf16 (tensor
// cores, NF 8-column halo fragments per 16 pixels).
template <typename T, int NF>
__global__ void __launch_bounds__(sizeof(T) == 4 ? 256 : 512,
                                  sizeof(T) == 4 ? 2 : 1)
    corr_fwd_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& p = a.p;
  const int ysplit = (a.P + p.pb - 1) / p.pb;
  const int b = blockIdx.z / ysplit, iy0 = (blockIdx.z % ysplit) * p.pb;
  const Tile t = tile_of(a, b);
  const int pbe = min(p.pb, a.P - iy0);
  const int rows = p.th + pbe - 1;
  const int hy0 = t.ybase + iy0 * a.S - a.R;
  const int64_t img = (int64_t)b * a.H * a.W;
  const T* f1 = static_cast<const T*>(a.f1) + img * a.C;
  const T* f2 = static_cast<const T*>(a.f2) + img * a.C;
  float* ot = reinterpret_cast<float*>(smem + p.nbuf * p.stage_bytes);
  constexpr int PM = sizeof(T) == 4 ? NF : 1;
  float acc[f32_rows(PM)][PM];
  F32Item w{};
  if constexpr (sizeof(T) == 4) {
    w = f32_item(p, pbe, threadIdx.x, f32_rows(PM));
#pragma unroll
    for (int q = 0; q < f32_rows(PM); ++q)
#pragma unroll
      for (int ix = 0; ix < PM; ++ix) acc[q][ix] = 0.0f;
  } else if (p.nchunk > 1 || p.ksplit > 1) {
    const int ntile = p.th * 16 * p.mf * pbe * a.P;
    for (int i = threadIdx.x; i < ntile; i += blockDim.x) ot[i] = 0.0f;
  }

  fwd_stage<T>(a, smem, f1, f2, t, rows, hy0, 0);
  for (int k = 0; k < p.nchunk; ++k) {
    const int buf = p.nbuf == 2 ? (k & 1) : 0;
    if (p.nbuf == 2 && k + 1 < p.nchunk) {
      fwd_stage<T>(a, smem + (buf ^ 1) * p.stage_bytes, f1, f2, t, rows, hy0,
                   k + 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    unsigned char* base = smem + buf * p.stage_bytes;
    if constexpr (sizeof(T) == 2)
      fwd_chunk_tc<NF>(a, base, ot, t, pbe, hy0);
    else if (w.nq > 0)
      fwd_chunk_f32<PM>(a, base, w, acc);
    __syncthreads();
    if (p.nbuf == 1 && k + 1 < p.nchunk)
      fwd_stage<T>(a, smem, f1, f2, t, rows, hy0, k + 1);
  }
  if constexpr (sizeof(T) == 4) {
    // every (row, shift row, pixel) of the out tile has one owner
    const int tw = 16 * p.mf, PB = pbe * a.P;
#pragma unroll
    for (int q = 0; q < f32_rows(PM); ++q) {
      if (q >= w.nq) break;
      const int r = w.r0 + q;
      float* o = ot + (r * tw + w.x) * PB + (w.h - r) * a.P;
#pragma unroll
      for (int ix = 0; ix < PM; ++ix)
        if (ix < a.P) o[ix] = acc[q][ix];
    }
    __syncthreads();
  }
  fwd_write<T>(a, ot, static_cast<T*>(a.out) + img * a.P * a.P, t, iy0, pbe);
}

// ---------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------

// Where a staged row of g starts within its shared-memory row: the span's
// first element sits at this offset, so that it and its source agree
// modulo 16 bytes (g itself is 16-byte aligned).
template <typename T>
__device__ __forceinline__ int g_shift(const Args& a, Tile t, int y, int xs) {
  constexpr int V = 16 / sizeof(T);
  return (int)((t.gimg + ((int64_t)y * a.W + xs) * (a.P * a.P)) & (V - 1));
}

// Rows of g into shared memory, row i at gs + i * gcap + g_shift: row i
// is g's contiguous span of npx pixels (all P^2 entries each) from pixel
// (y0 + i * ystep, xs) of the block's image; zero outside the map.
// 16-byte cp.async, element by element only where a 16-byte piece
// straddles the map's edge. g: the whole tensor.
template <typename T>
__device__ __forceinline__ void stage_g_rows(const Args& a, T* gs, const T* g,
                                             Tile t, int nrows, int y0,
                                             int ystep, int xs, int npx) {
  constexpr int V = 16 / sizeof(T);
  const int P2 = a.P * a.P, nch = a.p.gcap / V;
  const int xa = max(xs, 0), xb = min(xs + npx, a.W);
  const float inv_nch = 1.0f / nch;
  for (int i = threadIdx.x; i < nrows * nch; i += blockDim.x) {
    const int row = fdiv(i, inv_nch), c = i - row * nch;
    const int y = y0 + row * ystep;
    const bool in = y >= 0 && y < a.H && xb > xa;
    const int e0 = in ? (xa - xs) * P2 : 0, e1 = in ? (xb - xs) * P2 : 0;
    const int64_t gidx = t.gimg + ((int64_t)y * a.W + xs) * P2;
    const int lo = c * V - (int)(gidx & (V - 1));  // span element at dst[0]
    T* dst = gs + row * a.p.gcap + c * V;
    if (lo >= e0 && lo + V <= e1) {
      cp_async(smem_u32(dst), g + gidx + lo, 16, true);
    } else if (lo + V <= e0 || lo >= e1) {
      cp_async(smem_u32(dst), g, 16, false);
    } else {
      for (int k = 0; k < V; ++k) {
        const int e = lo + k;
        dst[k] = (e >= e0 && e < e1) ? g[gidx + e] : T(0);
      }
    }
  }
}

// g (the whole tensor) into shared memory. df1 (which 0): the block's th
// rows of g (its own pixels). df2, gmode 1: the th + P - 1 halo rows of g
// that send to the block (hws pixels each); gmode 0 (fewer bytes, and
// what fits at FlowNetC's 441 shifts): [r][iy][j][P], for each output row
// r and shift row iy the halo row that sends to r through iy, shift row
// iy's P entries of each halo pixel j.
template <typename T>
__device__ __forceinline__ void bwd_stage_g(const Args& a, T* gs, const T* g,
                                            Tile t, int which) {
  const Plan& p = a.p;
  const int P = a.P, P2 = P * P;
  if (which == 0) {
    stage_g_rows<T>(a, gs, g, t, p.th, t.ybase, a.S, t.x0, 16 * p.mf);
  } else if (p.gmode == 1) {
    stage_g_rows<T>(a, gs, g, t, p.rows, t.ybase - a.R, a.S, t.x0 - a.R,
                    p.hws);
  } else {
    // a warp per (r, iy), lanes on neighbouring (j, k): each warp load
    // reads a few runs of P contiguous entries
    g += t.gimg;
    const int run = p.hws * P;
    const float inv_p = 1.0f / P;
    for (int q = threadIdx.x >> 5; q < p.th * P; q += blockDim.x >> 5) {
      const int r = fdiv(q, inv_p), iy = q - r * P;
      const int yy = t.ybase + (r + P - 1 - iy) * a.S - a.R;
      const bool yok = yy >= 0 && yy < a.H;
      const T* src = g + (int64_t)(yok ? yy : 0) * a.W * P2 + iy * P;
      T* dst = gs + q * run;
#pragma unroll 4
      for (int w = threadIdx.x & 31; w < run; w += 32) {
        const int j = fdiv(w, inv_p), k = w - j * P;
        const int xx = t.x0 - a.R + j;
        dst[w] = (yok && xx >= 0 && xx < a.W) ? src[(int64_t)xx * P2 + k]
                                              : T(0);
      }
    }
  }
}

// Where shift row iy's g values for output row r start in gs, and the
// distance between neighbouring pixels there.
template <typename T>
__device__ __forceinline__ int g_base(const Args& a, Tile t, int which, int r,
                                      int iy, int h) {
  const Plan& p = a.p;
  if (which == 0)
    return r * p.gcap + g_shift<T>(a, t, t.ybase + r * a.S, t.x0) + iy * a.P;
  if (p.gmode == 1)
    return h * p.gcap +
           g_shift<T>(a, t, t.ybase + h * a.S - a.R, t.x0 - a.R) + iy * a.P;
  return (r * a.P + iy) * p.hws * a.P;
}
__device__ __forceinline__ int g_pixel_stride(const Args& a, int which) {
  return (which == 0 || a.p.gmode == 1) ? a.P * a.P : a.P;
}

// The halo row a gradient's shift row iy reads for output row r: df1
// reads f2 at y + dy, df2 reads f1 at y - dy (staged halo rows start at
// ybase - R, stride rows apart).
__device__ __forceinline__ int bwd_row(int which, int r, int iy, int P) {
  return which == 0 ? r + iy : r + P - 1 - iy;
}

// The MMAs of one staged channel chunk (bf16): items (r, fragment m, NQ
// 16-channel groups from nq) over the warps. A = the band of g for shift
// row iy (16 pixels x 16 halo columns per k step), built in registers
// once for the item's 2*NQ MMAs; B = the staged halo by ldmatrix.trans.
// Results go straight to dst.
template <int KH, int NQ>
__device__ __forceinline__ void bwd_chunk_tc(const Args& a,
                                             const unsigned char* base,
                                             const uint16_t* gs,
                                             uint16_t* dst, Tile t,
                                             int which, int k) {
  const Plan& p = a.p;
  const int lane = threadIdx.x & 31, P = a.P;
  const int nq_n = p.kc / (16 * NQ), items = p.th * p.mf * nq_n;
  const int gq = lane >> 2, tq = lane & 3, hy0 = t.ybase - a.R;
  const int gps = g_pixel_stride(a, which);
  const uint32_t sf = smem_u32(base);
  for (int it = threadIdx.x >> 5; it < items; it += blockDim.x >> 5) {
    const int nq = (it % nq_n) * NQ, v = it / nq_n;
    const int m = v % p.mf, r = v / p.mf;
    const int y = t.ybase + r * a.S;
    if (y >= a.H) continue;
    // offsets into gs of this lane's 8 A elements per k step (-1: off the
    // band), without the shift row's term; element e: pixel gq (+8 for
    // e & 2), halo column 2tq (+1 for e & 1, +8 for e & 4)
    int goff[KH][8];
#pragma unroll
    for (int kk = 0; kk < KH; ++kk)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int xi = gq + ((e & 2) ? 8 : 0);
        const int hc = 16 * kk + 2 * tq + (e & 1) + ((e & 4) ? 8 : 0);
        const int ix = band_shift(which == 0 ? hc - xi : xi + 2 * a.R - hc,
                                  a.S, P, a.inv_s);
        goff[kk][e] =
            ix < 0 ? -1 : (m * 16 + (which == 0 ? xi : hc)) * gps + ix;
      }
    float acc[2 * NQ][4];
#pragma unroll
    for (int j = 0; j < 2 * NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    // B: lanes 0-7 halo pixels 0-7 / channels 0-7, 8-15 pixels 8-15,
    // 16-31 the same for channels 8-15 of the group
    const uint32_t brow =
        sf + (m * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * p.pitch +
        nq * 32 + (lane >> 4) * 16;
    for (int iy = 0; iy < P; ++iy) {
      const int h = bwd_row(which, r, iy, P);
      const int yy = hy0 + h * a.S;
      if (yy < 0 || yy >= a.H) continue;
      const uint16_t* gb = gs + g_base<uint16_t>(a, t, which, r, iy, h);
#pragma unroll
      for (int kk = 0; kk < KH; ++kk) {
        uint32_t af[4], bt[4];  // bt: B of two 8-channel fragments
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int o0 = goff[kk][2 * q], o1 = goff[kk][2 * q + 1];
          const uint32_t lo = o0 >= 0 ? gb[o0] : 0u;
          const uint32_t hi = o1 >= 0 ? gb[o1] : 0u;
          af[q] = lo | (hi << 16);
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          ldsm_x4_t(bt, brow + (h * p.hws + 16 * kk) * p.pitch + q * 32);
          mma_k16(acc[2 * q], af, bt[0], bt[1]);
          mma_k16(acc[2 * q + 1], af, bt[2], bt[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2 * NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int x = t.x0 + m * 16 + gq + (e >= 2 ? 8 : 0);
        const int c = k * p.kc + nq * 16 + 8 * j + 2 * tq;
        if (x >= a.W || c >= a.C) continue;
        uint16_t* o = dst + ((int64_t)y * a.W + x) * a.C + c;
        const uint32_t lo = from_f<uint16_t>(acc[j][e] * a.inv_c);
        const uint32_t hi = from_f<uint16_t>(acc[j][e + 1] * a.inv_c);
        if (c + 1 < a.C && (a.C & 1) == 0) {
          *reinterpret_cast<uint32_t*>(o) = lo | (hi << 16);
        } else {
          o[0] = (uint16_t)lo;
          if (c + 1 < a.C) o[1] = (uint16_t)hi;
        }
      }
  }
}

// One staged chunk (float32, CUDA cores): a thread owns one (r, pixel,
// channel); lanes take neighbouring channels.
__device__ __forceinline__ void bwd_chunk_f32(const Args& a,
                                              const unsigned char* base,
                                              const float* gs, float* dst,
                                              Tile t, int which, int k) {
  const Plan& p = a.p;
  const int tw = 16 * p.mf, P = a.P, pst = p.pitch / 4, hy0 = t.ybase - a.R;
  const int gps = g_pixel_stride(a, which);
  const float* sf = reinterpret_cast<const float*>(base);
  const int items = p.th * tw * p.kc;
  const float inv_kc = 1.0f / p.kc;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int v = fdiv(it, inv_kc), c = it - v * p.kc;
    const int x = v & (tw - 1), r = v / tw;
    const int y = t.ybase + r * a.S, gx = t.x0 + x, gc = k * p.kc + c;
    if (y >= a.H || gx >= a.W || gc >= a.C) continue;
    float acc = 0.0f;
    for (int iy = 0; iy < P; ++iy) {
      const int h = bwd_row(which, r, iy, P);
      const int yy = hy0 + h * a.S;
      if (yy < 0 || yy >= a.H) continue;
      const float* fr = sf + h * p.hws * pst + c;
      const float* gr = gs + g_base<float>(a, t, which, r, iy, h);
      if (which == 0) {
        gr += x * gps;
        for (int ix = 0; ix < P; ++ix)
          acc += gr[ix] * fr[(x + ix * a.S) * pst];
      } else {
        for (int ix = 0; ix < P; ++ix) {
          const int j = x + 2 * a.R - ix * a.S;
          acc += gr[j * gps + ix] * fr[j * pst];
        }
      }
    }
    dst[((int64_t)y * a.W + gx) * a.C + gc] = acc * a.inv_c;
  }
}

// grid.z = (b * cgroups + channel group) * 2 + which; which 0: df1, 1:
// df2. A block runs chunks cg, cg + cgroups, ... of the channels.
template <typename T, int KH, int NQ>
__global__ void __launch_bounds__(512)
    corr_bwd_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& p = a.p;
  int z = blockIdx.z;
  const int which = z & 1;
  z >>= 1;
  const int cg = z % p.cgroups, b = z / p.cgroups;
  const Tile t = tile_of(a, b);
  const int64_t img = (int64_t)b * a.H * a.W;
  const T* feat = static_cast<const T*>(which == 0 ? a.f2 : a.f1) + img * a.C;
  T* dst = static_cast<T*>(which == 0 ? a.df1 : a.df2) + img * a.C;
  T* gs = reinterpret_cast<T*>(smem);
  unsigned char* stages = smem + p.g_bytes;
  const int hy0 = t.ybase - a.R, hx0 = t.x0 - a.R;

  auto stage = [&](int k, int buf) {
    stage_tile<T>(stages + buf * p.stage_bytes, p.pitch, feat, a, p.rows,
                  p.hws, hy0, a.S, hx0, k * p.kc, p.kc);
    cp_async_commit();
  };
  if (cg >= p.nchunk) return;
  // g's cp.async copies join the first chunk's group
  bwd_stage_g<T>(a, gs, static_cast<const T*>(a.g), t, which);
  stage(cg, 0);
  int buf = 0;
  for (int k = cg; k < p.nchunk; k += p.cgroups, buf ^= (p.nbuf - 1)) {
    const bool next = k + p.cgroups < p.nchunk;
    if (p.nbuf == 2 && next) {
      stage(k + p.cgroups, buf ^ 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const unsigned char* base = stages + buf * p.stage_bytes;
    if constexpr (sizeof(T) == 2)
      bwd_chunk_tc<KH, NQ>(a, base, gs, dst, t, which, k);
    else
      bwd_chunk_f32(a, base, gs, dst, t, which, k);
    if (next) {
      __syncthreads();
      if (p.nbuf == 1) stage(k + p.cgroups, 0);
    }
  }
}

// ---------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------

bool valid_args(int dtype, int B, int H, int W, int C, int patch,
                int stride) {
  return (dtype == 0 || dtype == 1) && B > 0 && H > 0 && W > 0 && C > 0 &&
         patch >= 1 && patch % 2 == 1 && patch <= kMaxPatch && stride >= 1 &&
         (patch - 1) / 2 * stride <= kMaxR;
}

// The plan's launch and shared-memory layout, checked against what the
// kernels index: the grid covers the map and no more images or shift rows
// than there are; each stage buffer holds the f1 tile (forward) and the
// halo rows at the staged pitch; the shared memory holds g's rows or runs
// (backward), the stage buffers and the forward's float out tile.
bool layout_ok(const Plan& p, int B, int H, int W, int C, int P, int S,
               int R, int esz, bool fwd) {
  const int tw = 16 * p.mf, V = 16 / esz;
  const int64_t pitch = p.pitch, stage = p.stage_bytes;
  if (p.th < 1 || p.mf < 1 || p.nf < 1 || p.kc < 16 || p.kc % 16 ||
      p.nchunk < 1 || (int64_t)p.nchunk * p.kc < C || p.ksplit < 1 ||
      p.cgroups < 1 || (p.nbuf != 1 && p.nbuf != 2) || p.threads < 32 ||
      p.threads > 512 || p.threads % 32 || p.smem > 232448 ||
      pitch < (int64_t)p.kc * esz || pitch % (esz == 2 ? 16 : 4) ||
      stage % 16 || p.g_bytes < 0 || p.g_bytes % 16 || p.gx < 1 ||
      (int64_t)p.gx * tw < W || p.gy < 1 || p.gy > 65535 || p.gy % S ||
      (int64_t)(p.gy / S) * p.th * S < H || p.gz < 1 || p.gz > 65535)
    return false;
  if (fwd) {
    const int rows = p.th + p.pb - 1;
    const int need = esz == 2 ? 16 * (p.mf - 1) + 8 * p.nf
                              : 16 * (p.mf - 1) + 16 + 2 * R;
    return p.pb >= 1 && p.pb <= P && p.gz == B * ((P + p.pb - 1) / p.pb) &&
           (esz == 2 || (p.threads <= 256 &&
                         tw * f32_runs(p.th, p.pb, f32_rows(P)) <=
                             p.threads)) &&
           (esz == 4 || 8 * p.nf >= 16 + 2 * R) && p.hws >= need &&
           stage >= ((int64_t)p.th * tw + (int64_t)rows * p.hws) * pitch &&
           p.smem >= p.nbuf * stage + (int64_t)p.th * tw * p.pb * P * 4;
  }
  const int64_t gel = std::max<int64_t>(
      (int64_t)p.th * p.gcap,
      p.gmode ? (int64_t)p.rows * p.gcap : (int64_t)p.th * P * p.hws * P);
  return p.gz == B * p.cgroups * 2 && 16 * p.nf >= 16 + 2 * R &&
         p.hws == 16 * (p.mf - 1) + 16 * p.nf && p.rows == p.th + P - 1 &&
         (p.gmode == 0 || p.gmode == 1) && p.gcap % V == 0 &&
         p.gcap >= tw * P * P + V - 1 &&
         (p.gmode == 0 || p.gcap >= p.hws * P * P + V - 1) &&
         (esz == 4 || p.kc % (16 * p.ngroup) == 0) &&
         stage >= (int64_t)p.rows * p.hws * pitch &&
         p.g_bytes >= gel * esz && p.smem >= p.g_bytes + p.nbuf * stage;
}

bool make_args(Args& a, int dtype, int B, int H, int W, int C, int patch,
               int stride, const int* plan, int ub, bool fwd) {
  if (!valid_args(dtype, B, H, W, C, patch, stride)) return false;
  int* dst = reinterpret_cast<int*>(&a.p);
  for (int i = 0; i < kPlanInts; ++i) dst[i] = plan[i];
  const int esz = dtype == 0 ? 4 : 2;
  a.H = H, a.W = W, a.C = C, a.P = patch, a.S = stride;
  a.R = (patch - 1) / 2 * stride, a.ub = ub;
  a.inv_c = 1.0f / (float)C;
  a.inv_s = 1.0f / (float)stride;
  return layout_ok(a.p, B, H, W, C, patch, stride, a.R, esz, fwd) &&
         (ub == 16 || ub == 8 || ub == 4 || (ub == 2 && esz == 2)) &&
         (C * esz) % ub == 0 && (a.p.kc * esz) % ub == 0 &&
         a.p.pitch % ub == 0;
}

template <auto kern>
int launch(const Args& a, cudaStream_t st) {
  // each kernel remembers the largest dynamic shared memory it was
  // allowed, so the attribute is set once per size
  static int smem_set = 48 * 1024;
  if (a.p.smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.p.smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = a.p.smem;
  }
  kern<<<dim3(a.p.gx, a.p.gy, a.p.gz), a.p.threads, a.p.smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for every tensor. f1, f2: (B, H, W, C);
// out: (B, H, W, patch^2), fully written. plan: the 22 ints of
// ops/local_corr.py's forward plan (refused unless layout_ok); ub: bytes
// per staging copy (16, 8 or 4, dividing C * element size and the maps'
// addresses; 2 for bf16 maps copied element by element). Returns a
// cudaError_t.
extern "C" int pcfa_local_corr_fwd(int dtype, const void* f1, const void* f2,
                                   void* out, int B, int H, int W, int C,
                                   int patch, int stride, const int* plan,
                                   int ub, void* stream) {
  Args a{};
  if (!make_args(a, dtype, B, H, W, C, patch, stride, plan, ub, true))
    return (int)cudaErrorInvalidValue;
  a.f1 = f1, a.f2 = f2, a.out = out;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return patch <= 9 ? launch<corr_fwd_kernel<float, 9>>(a, st)
                      : launch<corr_fwd_kernel<float, kMaxPatch>>(a, st);
  switch (a.p.nf) {
    case 2: return launch<corr_fwd_kernel<uint16_t, 2>>(a, st);
    case 3: return launch<corr_fwd_kernel<uint16_t, 3>>(a, st);
    case 4: return launch<corr_fwd_kernel<uint16_t, 4>>(a, st);
    case 5: return launch<corr_fwd_kernel<uint16_t, 5>>(a, st);
    case 6: return launch<corr_fwd_kernel<uint16_t, 6>>(a, st);
    case 7: return launch<corr_fwd_kernel<uint16_t, 7>>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// g: (B, H, W, patch^2), the contiguous, 16-byte aligned cotangent of
// `out`; df1, df2: (B, H, W, C), fully written, in one launch. plan: the
// backward plan (refused unless layout_ok).
extern "C" int pcfa_local_corr_bwd(int dtype, const void* f1, const void* f2,
                                   const void* g, void* df1, void* df2, int B,
                                   int H, int W, int C, int patch, int stride,
                                   const int* plan, int ub, void* stream) {
  Args a{};
  if (!make_args(a, dtype, B, H, W, C, patch, stride, plan, ub, false) ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  a.f1 = f1, a.f2 = f2, a.g = g, a.df1 = df1, a.df2 = df2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<corr_bwd_kernel<float, 1, 1>>(a, st);
#define PCFA_BWD_NQ(KH)                                                  \
  switch (a.p.ngroup) {                                                  \
    case 1: return launch<corr_bwd_kernel<uint16_t, KH, 1>>(a, st);      \
    case 2: return launch<corr_bwd_kernel<uint16_t, KH, 2>>(a, st);      \
    case 4: return launch<corr_bwd_kernel<uint16_t, KH, 4>>(a, st);      \
    default: return (int)cudaErrorInvalidValue;                          \
  }
  switch (a.p.nf) {
    case 1: PCFA_BWD_NQ(1)
    case 2: PCFA_BWD_NQ(2)
    case 3: PCFA_BWD_NQ(3)
    case 4: PCFA_BWD_NQ(4)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PCFA_BWD_NQ
}
