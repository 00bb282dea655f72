// The compact L-BFGS direction's two passes over the history ring buffers
// S (steps) and Y (gradient differences), each (B, m, n), for sm_90a.
//
//   products: for each pair b and each ring row i < rows(b),
//     S[i]·g, S[i]·y, Y[i]·g, Y[i]·y, Y[i]·s     (written as (B, 5, m))
//   combine:  d = -(γ g + Σ_i top[i] S[i] + γ Σ_i bot[i] Y[i])   (B, n)
//
// with rows(b) = min(count[b], m), read on the device: rows past the ring's
// fill are never read (they hold zeros in the optimizer's state) and their
// products are written as 0. g, y, s are the new gradient, gradient
// difference and step, as float32 or float64; before the products they are
// rounded to the history's storage dtype (bf16, float32 or float64), as
// the plain version's `.to(history dtype)` does. Products accumulate in
// float32 (float64 for a float64 history); the combine accumulates in g's
// dtype, with the same final additions as the plain version
// (ops/lbfgs_hist.py): only the order of the summation differs.
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA
// (pcfa_tpu/attack/lbfgs.py, einsums over the ring). The port's plain
// version copies each chunk of bf16 columns to float32, multiplies it with
// cuBLAS on the CUDA cores, reads the copy back, and walks all m rows
// whatever the fill; this reads each valid bf16 row once per pass.
//
// Bound on the H100: bytes. RAFT's published attack on 16 KITTI pairs
// holds B = 16, m = 100, n = 2·3·376·1248 = 2,815,488: S and Y are 18.02 GB
// in bf16. With a full ring the products pass moves 18.56 GB (with g, y, s
// in float32), 5.54 ms at 3.35 TB/s, and the combine 18.38 GB (g in, d
// out), 5.49 ms; at 2 pairs 0.69 ms each. The arithmetic (5 or 2 FMAs per
// element) is far below the CUDA cores' rate.
//
// Design. Products (`hist_products`): one block per (pair, slab of
// columns); the slabs split n evenly over about two waves of resident
// blocks (planned in Python from the occupancy this file reports), so 2 and
// 16 pairs both fill the card without a ragged last wave. A block stages
// its slab's g, y, s in shared memory in sub-chunks of 8 KB per vector,
// rounded to the storage dtype; then each warp walks its ring rows
// (warp, warp + 8, ...), reading the row of S and the row of Y together
// with 16-byte streaming loads (each load instruction of a warp covers 512
// contiguous bytes), and keeps the five products of a row in registers. A
// row's sums are reduced across the warp by shuffles and added to the
// block's partials in shared memory (the warp owns the row: no atomics).
// The partials go to a workspace (B, slabs, 5, m), which a second small
// kernel sums over the slabs in a fixed order: no float atomics anywhere,
// so a rerun gives the same bits. Combine (`hist_combine`): the
// coefficients top and bot sit in shared memory; each thread owns 8
// columns (in 16-byte pieces laid out as in the products) and streams the
// valid rows of S and Y, four rows of loads in flight, keeping both sums
// in registers; it then writes d once. Both kernels take only n a multiple
// of 8 and S, Y and the vectors 16-byte aligned, as every main path gives
// them (n is 2·3·H·W, or 3·H·W for a joint δ, with H and W padded to ÷8 or
// ÷64; the ring and vectors are fresh allocations); the wrappers and the
// entry points refuse anything else.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageBytes = 8192;  // per staged vector of a products sub-chunk
constexpr int kReduceLanes = 8;    // slab lanes per output of the reduction

using bf16_t = uint16_t;  // bf16 values as their bit patterns

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

// ----------------------------------------------------------- arithmetic ---

__device__ __forceinline__ float mad(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double mad(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
// the final combination, unfused, as the plain version's separate ops
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rounding to the storage dtype, as torch's `.to()`: round to nearest even;
// a float64 value reaches bf16 through float32, as c10::BFloat16 takes it;
// a NaN becomes torch's quiet NaN
__device__ __forceinline__ void round_to(float x, bf16_t& out) {
  const uint32_t u = __float_as_uint(x);
  out = (u & 0x7fffffffu) > 0x7f800000u
            ? bf16_t(0x7fc0)
            : bf16_t((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}
__device__ __forceinline__ void round_to(double x, bf16_t& out) {
  round_to(__double2float_rn(x), out);
}
__device__ __forceinline__ void round_to(float x, float& out) { out = x; }
__device__ __forceinline__ void round_to(double x, float& out) {
  out = __double2float_rn(x);
}
__device__ __forceinline__ void round_to(float x, double& out) { out = x; }
__device__ __forceinline__ void round_to(double x, double& out) { out = x; }

// --------------------------------------------------------------- loads ---

template <bool kStream>
__device__ __forceinline__ uint4 ld16(const void* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  if constexpr (kStream) return __ldcs(q);
  else return *q;
}

// the E storage elements of the 16-byte piece at p as C; `kStream` reads
// around the L1 and marks the lines evict-first (the ring is read once per
// pass)
template <int E, bool kStream, typename C>
__device__ __forceinline__ void load_piece(const bf16_t* p, C (&v)[E]) {
  static_assert(E == 8, "a 16-byte piece of bf16 holds 8 values");
  const uint4 w = ld16<kStream>(p);
  const uint32_t h[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = C(__uint_as_float(h[i] << 16));
    v[2 * i + 1] = C(__uint_as_float(h[i] & 0xffff0000u));
  }
}

template <int E, bool kStream, typename C>
__device__ __forceinline__ void load_piece(const float* p, C (&v)[E]) {
  static_assert(E == 4, "a 16-byte piece of float32 holds 4 values");
  const uint4 w = ld16<kStream>(p);
  v[0] = C(__uint_as_float(w.x));
  v[1] = C(__uint_as_float(w.y));
  v[2] = C(__uint_as_float(w.z));
  v[3] = C(__uint_as_float(w.w));
}

template <int E, bool kStream, typename C>
__device__ __forceinline__ void load_piece(const double* p, C (&v)[E]) {
  static_assert(E == 2, "a 16-byte piece of float64 holds 2 values");
  const uint4 w = ld16<kStream>(p);
  v[0] = C(__hiloint2double(int(w.y), int(w.x)));
  v[1] = C(__hiloint2double(int(w.w), int(w.z)));
}

// E (2, 4 or 8) consecutive values of g's dtype at p, aligned to E values
template <int E>
__device__ __forceinline__ void load_x(const float* p, float (&v)[E]) {
  if constexpr (E == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  }
}

template <int E>
__device__ __forceinline__ void load_x(const double* p, double (&v)[E]) {
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    const double2 t = reinterpret_cast<const double2*>(p)[i];
    v[2 * i] = t.x; v[2 * i + 1] = t.y;
  }
}

template <int E>
__device__ __forceinline__ void store_x(float* p, const float (&v)[E]) {
  if constexpr (E == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < E / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

template <int E>
__device__ __forceinline__ void store_x(double* p, const double (&v)[E]) {
#pragma unroll
  for (int i = 0; i < E / 2; ++i)
    reinterpret_cast<double2*>(p)[i] = make_double2(v[2 * i], v[2 * i + 1]);
}

// The layout of a warp's step of 32·kCols columns: pieces of 16 bytes of
// the storage dtype (E values each, P = kCols / E pieces a lane), piece q
// of lane l at q·32·E + l·E, so each load instruction of the warp reads 512
// contiguous bytes. With n, a slab and a sub-chunk all multiples of kCols,
// a piece lies wholly inside or wholly past each bound.
constexpr int kCols = 8;  // columns a lane owns per step

template <typename T>
struct Pieces {
  static constexpr int E = 16 / int(sizeof(T));
  static constexpr int P = kCols / E;
  __device__ static int offset(int q, int lane) {
    return q * 32 * E + lane * E;
  }
};

__device__ __forceinline__ int valid_rows(int64_t count, int m) {
  return count <= 0 ? 0 : (count < m ? int(count) : m);
}

// ------------------------------------------------------------- kernels ---

template <typename T, typename X>
__global__ void __launch_bounds__(kThreads)
hist_products(const T* __restrict__ S, const T* __restrict__ Y,
              const X* __restrict__ g, const X* __restrict__ yn,
              const X* __restrict__ sn, const int64_t* __restrict__ count,
              typename AccOf<T>::type* __restrict__ ws, int m, int64_t n,
              int64_t per, int chunk) {
  using A = typename AccOf<T>::type;
  using L = Pieces<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const stage = reinterpret_cast<T*>(smem);  // g | y | s, chunk each
  A* const part = reinterpret_cast<A*>(smem + size_t(3) * chunk * sizeof(T));

  const int b = blockIdx.y;
  const int rows = valid_rows(count[b], m);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 5 * m; i += kThreads) part[i] = A(0);
  const int64_t start = int64_t(blockIdx.x) * per;
  const int64_t end = start + per < n ? start + per : n;
  const int64_t pair = int64_t(b) * n;

  for (int64_t c0 = start; rows > 0 && c0 < end; c0 += chunk) {
    const int len = int(end - c0 < chunk ? end - c0 : chunk);
    __syncthreads();  // the last sub-chunk's stage is read; part is zeroed
    for (int j = threadIdx.x; j < len; j += kThreads) {
      round_to(g[pair + c0 + j], stage[j]);
      round_to(yn[pair + c0 + j], stage[chunk + j]);
      round_to(sn[pair + c0 + j], stage[2 * chunk + j]);
    }
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      const T* const srow = S + (int64_t(b) * m + r) * n + c0;
      const T* const yrow = Y + (int64_t(b) * m + r) * n + c0;
      A a0 = 0, a1 = 0, a2 = 0, a3 = 0, a4 = 0;
#pragma unroll 2
      for (int j = 0; j < len; j += 32 * kCols) {
#pragma unroll
        for (int q = 0; q < L::P; ++q) {
          const int off = j + L::offset(q, lane);
          if (off < len) {
            A s[L::E], y[L::E], gv[L::E], yv[L::E], sv[L::E];
            load_piece<L::E, true>(srow + off, s);
            load_piece<L::E, true>(yrow + off, y);
            load_piece<L::E, false>(stage + off, gv);
            load_piece<L::E, false>(stage + chunk + off, yv);
            load_piece<L::E, false>(stage + 2 * chunk + off, sv);
#pragma unroll
            for (int e = 0; e < L::E; ++e) {
              a0 = mad(s[e], gv[e], a0);
              a1 = mad(s[e], yv[e], a1);
              a2 = mad(y[e], gv[e], a2);
              a3 = mad(y[e], yv[e], a3);
              a4 = mad(y[e], sv[e], a4);
            }
          }
        }
      }
      a0 = warp_sum(a0); a1 = warp_sum(a1); a2 = warp_sum(a2);
      a3 = warp_sum(a3); a4 = warp_sum(a4);
      if (lane == 0) {
        part[r] += a0;
        part[m + r] += a1;
        part[2 * m + r] += a2;
        part[3 * m + r] += a3;
        part[4 * m + r] += a4;
      }
    }
  }
  __syncthreads();
  A* const out = ws + (int64_t(b) * gridDim.x + blockIdx.x) * 5 * m;
  for (int i = threadIdx.x; i < 5 * m; i += kThreads) out[i] = part[i];
}

// out[b, o] = Σ_slab ws[b, slab, o], o < k: kReduceLanes lanes per output
// take every kReduceLanes-th slab, then lane 0 adds the lanes in order
template <typename A>
__global__ void __launch_bounds__(32 * kReduceLanes)
reduce_slabs(const A* __restrict__ ws, A* __restrict__ out, int slabs, int k) {
  __shared__ A buf[kReduceLanes][32];
  const int b = blockIdx.y, o = blockIdx.x * 32 + threadIdx.x;
  A s = 0;
  if (o < k)
    for (int i = threadIdx.y; i < slabs; i += kReduceLanes)
      s += ws[(int64_t(b) * slabs + i) * k + o];
  buf[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && o < k) {
    A t = buf[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < kReduceLanes; ++i) t += buf[i][threadIdx.x];
    out[int64_t(b) * k + o] = t;
  }
}

template <typename T, typename X>
__global__ void __launch_bounds__(kThreads)
hist_combine(const T* __restrict__ S, const T* __restrict__ Y,
             const X* __restrict__ g, const X* __restrict__ top,
             const X* __restrict__ bot, const X* __restrict__ gamma,
             const int64_t* __restrict__ count, X* __restrict__ d, int m,
             int64_t n) {
  using L = Pieces<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  X* const ct = reinterpret_cast<X*>(smem);
  X* const cb = ct + m;

  const int b = blockIdx.y;
  const int rows = valid_rows(count[b], m);
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    ct[i] = top[int64_t(b) * m + i];
    cb[i] = bot[int64_t(b) * m + i];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t base = (int64_t(blockIdx.x) * kWarps + warp) * 32 * kCols;
  bool ok[L::P];
  bool any = false;
#pragma unroll
  for (int q = 0; q < L::P; ++q) {
    ok[q] = base + L::offset(q, lane) < n;
    any |= ok[q];
  }
  if (!any) return;

  X as[L::P][L::E], ay[L::P][L::E];
#pragma unroll
  for (int q = 0; q < L::P; ++q)
#pragma unroll
    for (int e = 0; e < L::E; ++e) as[q][e] = ay[q][e] = X(0);
  const T* sp = S + int64_t(b) * m * n + base;
  const T* yp = Y + int64_t(b) * m * n + base;
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    const X ts = ct[r], tb = cb[r];
#pragma unroll
    for (int q = 0; q < L::P; ++q) {
      if (ok[q]) {
        X s[L::E], y[L::E];
        load_piece<L::E, true>(sp + L::offset(q, lane), s);
        load_piece<L::E, true>(yp + L::offset(q, lane), y);
#pragma unroll
        for (int e = 0; e < L::E; ++e) {
          as[q][e] = mad(ts, s[e], as[q][e]);
          ay[q][e] = mad(tb, y[e], ay[q][e]);
        }
      }
    }
    sp += n;
    yp += n;
  }
  const X gam = gamma[b];
#pragma unroll
  for (int q = 0; q < L::P; ++q) {
    if (ok[q]) {
      const int64_t col = int64_t(b) * n + base + L::offset(q, lane);
      X gv[L::E], out[L::E];
      load_x<L::E>(g + col, gv);
#pragma unroll
      for (int e = 0; e < L::E; ++e)
        out[e] = -add(add(mul(gam, gv[e]), as[q][e]), mul(gam, ay[q][e]));
      store_x<L::E>(d + col, out);
    }
  }
}

// -------------------------------------------------------------- launch ---

template <typename T>
int products_smem(int m) {
  using A = typename AccOf<T>::type;
  return 3 * kStageBytes + 5 * m * int(sizeof(A));
}

template <typename Kernel>
int allow_smem(Kernel kern, int smem, int& smem_set) {
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
    smem_set = smem;
  }
  return 0;
}

template <typename T, typename X>
int plan(int m, int* blocks_per_sm) {
  static int smem_set = 48 * 1024;
  const int smem = products_smem<T>(m);
  int err = allow_smem(hist_products<T, X>, smem, smem_set);
  if (err) return err;
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, hist_products<T, X>, kThreads, smem));
}

template <typename T, typename X>
int products(const void* S, const void* Y, const void* g, const void* yn,
             const void* sn, const int64_t* count, void* ws, void* out,
             int B, int m, int64_t n, int slabs, int64_t per,
             cudaStream_t st) {
  using A = typename AccOf<T>::type;
  static int smem_set = 48 * 1024;
  const int smem = products_smem<T>(m);
  int err = allow_smem(hist_products<T, X>, smem, smem_set);
  if (err) return err;
  hist_products<T, X><<<dim3(slabs, B), kThreads, smem, st>>>(
      static_cast<const T*>(S), static_cast<const T*>(Y),
      static_cast<const X*>(g), static_cast<const X*>(yn),
      static_cast<const X*>(sn), count, static_cast<A*>(ws), m, n, per,
      kStageBytes / int(sizeof(T)));
  err = int(cudaGetLastError());
  if (err) return err;
  const int k = 5 * m;
  reduce_slabs<A><<<dim3((k + 31) / 32, B), dim3(32, kReduceLanes), 0, st>>>(
      static_cast<const A*>(ws), static_cast<A*>(out), slabs, k);
  return int(cudaGetLastError());
}

template <typename T, typename X>
int combine(const void* S, const void* Y, const void* g, const void* top,
            const void* bot, const void* gamma, const int64_t* count, void* d,
            int B, int m, int64_t n, cudaStream_t st) {
  static int smem_set = 48 * 1024;
  const int smem = 2 * m * int(sizeof(X));
  int err = allow_smem(hist_combine<T, X>, smem, smem_set);
  if (err) return err;
  const int64_t per_block = int64_t(kThreads) * kCols;
  hist_combine<T, X><<<dim3(unsigned((n + per_block - 1) / per_block), B),
                          kThreads, smem, st>>>(
      static_cast<const T*>(S), static_cast<const T*>(Y),
      static_cast<const X*>(g), static_cast<const X*>(top),
      static_cast<const X*>(bot), static_cast<const X*>(gamma), count,
      static_cast<X*>(d), m, n);
  return int(cudaGetLastError());
}

// storage codes: 0 bf16, 1 float32, 2 float64; g's codes: 1 float32,
// 2 float64
template <template <typename, typename> class F, typename T,
          typename... Args>
int by_x(int x_code, Args... args) {
  return x_code == 1 ? F<T, float>::run(args...)
                     : F<T, double>::run(args...);
}

template <template <typename, typename> class F, typename... Args>
int dispatch(int t_code, int x_code, Args... args) {
  switch (t_code) {
    case 0: return by_x<F, bf16_t>(x_code, args...);
    case 1: return by_x<F, float>(x_code, args...);
    default: return by_x<F, double>(x_code, args...);
  }
}

template <typename T, typename X>
struct Plan {
  static int run(int m, int* blocks) { return plan<T, X>(m, blocks); }
};
template <typename T, typename X>
struct Products {
  template <typename... Args>
  static int run(Args... args) { return products<T, X>(args...); }
};
template <typename T, typename X>
struct Combine {
  template <typename... Args>
  static int run(Args... args) { return combine<T, X>(args...); }
};

bool codes_ok(int t_code, int x_code, int B, int m, int64_t n) {
  return t_code >= 0 && t_code <= 2 && (x_code == 1 || x_code == 2) &&
         B > 0 && B <= 65535 && m > 0 && n > 0 && n % kCols == 0;
}

// the buffers the kernels read and write in 16-byte pieces
bool aligned(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

}  // namespace

// Resident blocks of the products kernel per SM for history size m (the
// wrapper plans its slabs from it).
extern "C" int pcfa_lbfgs_hist_plan(int t_code, int x_code, int m,
                                    int* blocks_per_sm) {
  if (!codes_ok(t_code, x_code, 1, m, kCols) || blocks_per_sm == nullptr)
    return int(cudaErrorInvalidValue);
  return dispatch<Plan>(t_code, x_code, m, blocks_per_sm);
}

// The products (B, 5, m) in float32 (float64 for a float64 history), with
// `ws` a (B, slabs, 5, m) workspace of that dtype; slab i covers columns
// [i·per, (i+1)·per) ∩ [0, n), per a multiple of 8.
extern "C" int pcfa_lbfgs_hist_products(
    const void* S, const void* Y, const void* g, const void* yn,
    const void* sn, const void* count, void* ws, void* out, int t_code,
    int x_code, int B, int m, int64_t n, int slabs, int64_t per,
    void* stream) {
  if (!codes_ok(t_code, x_code, B, m, n) || !aligned({S, Y, g, yn, sn}) ||
      slabs <= 0 || per <= 0 || per % kCols != 0 ||
      int64_t(slabs) * per < n || int64_t(slabs - 1) * per >= n)
    return int(cudaErrorInvalidValue);
  return dispatch<Products>(t_code, x_code, S, Y, g, yn, sn,
                            static_cast<const int64_t*>(count), ws, out, B,
                            m, n, slabs, per,
                            static_cast<cudaStream_t>(stream));
}

// d = -(γ g + Σ top·S + γ Σ bot·Y), (B, n) in g's dtype.
extern "C" int pcfa_lbfgs_hist_combine(
    const void* S, const void* Y, const void* g, const void* top,
    const void* bot, const void* gamma, const void* count, void* d,
    int t_code, int x_code, int B, int m, int64_t n, void* stream) {
  if (!codes_ok(t_code, x_code, B, m, n) || !aligned({S, Y, g, d}))
    return int(cudaErrorInvalidValue);
  return dispatch<Combine>(t_code, x_code, S, Y, g, top, bot, gamma,
                           static_cast<const int64_t*>(count), d, B, m, n,
                           static_cast<cudaStream_t>(stream));
}
