// Grouped matmul for mixture-of-experts layers (megablocks-style), for
// Hopper (sm_90a).
//
// Plain C interface (loaded with ctypes by ops/_build.py); every launcher
// returns the cudaError_t of its launch and never synchronises.
//
// What it replaces (deepspeed_tpu/ops/pallas/grouped_matmul.py):
//   ds_gmm  -> _gmm (:85): out[i*bt:(i+1)*bt] = lhs_blk_i @ rhs[be[i]], the
//              forward product; with trans_b = 1 the same against
//              rhs[be[i]]^T, read through the strides (the backward's dx,
//              which the TPU package computes against rhs.transpose(0, 2, 1)
//              materialised at :215)
//   ds_tgmm -> _tgmm (:148): out[e] = sum over the row blocks i with
//              be[i] == e of lhs_blk_i^T @ dy_blk_i, in fp32 (the dw)
//
// Semantics copied from the TPU kernels: bf16 (or fp16) operands, products
// accumulated in fp32 (:109-111, :175-178; a bf16 x bf16 product is exact
// in fp32, so tensor-core MMAs with fp32 accumulators compute the same
// function up to the order of the sum), gmm rounds once to the operand
// dtype, tgmm writes fp32. The block table be[T / bt] is non-decreasing (the
// dispatcher sorts tokens by expert) and is read from device memory: no
// host table. Row blocks are bt rows, a multiple of the 128-row CTA tile.
// Trailing padding blocks (expert E - 1, zero rows) are multiplied like any
// other: the kernels do not read from the device which blocks are padding.
//
// gmm: one CTA per (128-row tile, 128-column tile) of out, walked in groups
// of 8 row tiles so that the CTAs in flight share the same expert's weight
// columns in L2. tgmm: one CTA per (expert, 128 x 128 tile of out[e]); it
// finds its expert's row blocks by two binary searches over be and loops
// over them. An expert that owns no row block gets zeros (the TPU kernel
// leaves such a block unwritten; the dispatcher never produces one,
// deepspeed_tpu/moe/grouped.py:61-63). Every output element is written once,
// with no atomics.
//
// Inside a CTA: 8 warps, each a 32 x 64 slice of the 128 x 128 tile as 2 x 4
// nvcuda::wmma 16x16x16 fragments with fp32 accumulators; operand tiles of
// 32 along the reduction staged in shared memory, double-buffered with
// 16-byte cp.async loads. K, N (and T for tgmm's rows) need not be multiples
// of the tile: loads past an edge fill zeros, stores past it are skipped.
// A row whose start is not 16-byte aligned (a width not a multiple of 8)
// takes element loads instead of cp.async.
//
// What bounds it on the H100: at the main path's shapes (8192 routed rows,
// K / N = 4096 / 14336) each call does 9.6e11 FLOPs against ~1.2 GB
// (gmm) or ~2.2 GB (tgmm) of traffic, so the bound is the tensor cores'
// 989 TFLOP/s (0.97 ms). This first version issues mma.sync through wmma
// from shared-memory tiles; wgmma with TMA-fed, deeper pipelines is later
// work, measured against that bound.
//
// Offsets are int64 throughout.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kTM = 128;     // output rows per CTA tile
constexpr int kTN = 128;     // output columns per CTA tile
constexpr int kTK = 32;      // reduction depth per pipeline stage
constexpr int kPad = 8;      // shared-memory row padding (elements)
constexpr int kGroupM = 8;   // gmm row tiles per raster group
constexpr int kSmemBytes = 40960;  // the largest layout below (gmm, trans_b)

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage a rows x cols tile of the row-major matrix g (row stride ld) whose
// corner is (row0, col0) into shared memory (row stride lds), zero past
// row_lim / col_lim. vec: rows start 16-byte aligned (ld % 8 == 0).
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* s, int lds, const T* __restrict__ g, long long ld,
                                          int row0, int col0, int row_lim, int col_lim, bool vec) {
  constexpr int kChunksPerRow = COLS / 8;
  constexpr int kChunks = ROWS * kChunksPerRow;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int cc = (c % kChunksPerRow) * 8;
    const int gr = row0 + r;
    const int gc = col0 + cc;
    T* dst = s + r * lds + cc;
    if (vec && gr < row_lim && gc + 8 <= col_lim) {
      cp_async16(dst, g + (long long)gr * ld + gc);
    } else {
      for (int j = 0; j < 8; ++j) {
        dst[j] = (gr < row_lim && gc + j < col_lim) ? g[(long long)gr * ld + gc + j]
                                                    : from_f<T>(0.f);
      }
    }
  }
}

template <typename Acc>
__device__ __forceinline__ void zero_acc(Acc (&acc)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

// Write the warp's 2 x 4 fragments (tile corner (r0, c0)) through a 16 x 16
// fp32 scratch per warp, skipping rows >= row_lim and columns >= col_lim.
template <typename O, typename Acc>
__device__ __forceinline__ void store_acc(Acc (&acc)[2][4], float* scratch, O* __restrict__ out,
                                          long long ld, int r0, int c0, int row_lim,
                                          int col_lim) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int rb = r0 + i * 16, cb = c0 + j * 16;
      for (int t = lane; t < 256; t += 32) {
        const int r = rb + t / 16, c = cb + t % 16;
        if (r < row_lim && c < col_lim) {
          if constexpr (std::is_same<O, float>::value) {
            out[(long long)r * ld + c] = scratch[t];
          } else {
            out[(long long)r * ld + c] = from_f<O>(scratch[t]);
          }
        }
      }
      __syncwarp();
    }
  }
}

// out [T, N] = lhs [T, K] @ B_e, e = be[row / bt]; B_e = rhs[e] ([K, N]) or,
// with TRANS_B, rhs[e]^T (rhs[e] stored [N, K]).
template <typename T, bool TRANS_B>
__global__ void __launch_bounds__(kThreads, 2)
    gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs, const int* __restrict__ be,
               T* __restrict__ out, int n_rows, int K, int N, int bt) {
  constexpr int kLdA = kTK + kPad;                  // A stage [kTM][kLdA]
  constexpr int kLdB = TRANS_B ? kTK + kPad : kTN + kPad;  // B stage [kTN][..] or [kTK][..]
  constexpr int kAStage = kTM * kLdA;
  constexpr int kBStage = TRANS_B ? kTN * kLdB : kTK * kLdB;
  static_assert(2 * (kAStage + kBStage) * (int)sizeof(T) <= kSmemBytes, "shared memory layout");
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  // stage s: A at sm + s * (kAStage + kBStage), B right after it
  T* const sm = reinterpret_cast<T*>(smem);

  // grouped raster: kGroupM row tiles x every column tile, row-fastest
  const int num_m = n_rows / kTM;
  const int num_n = (N + kTN - 1) / kTN;
  const int per_group = kGroupM * num_n;
  const int group = blockIdx.x / per_group;
  const int first_m = group * kGroupM;
  const int group_size = min(num_m - first_m, kGroupM);
  const int in_group = blockIdx.x % per_group;
  const int m_tile = first_m + in_group % group_size;
  const int n_tile = in_group / group_size;
  const int row0 = m_tile * kTM;
  const int col0 = n_tile * kTN;
  const int e = be[row0 / bt];
  const T* __restrict__ B = rhs + (long long)e * K * N;

  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;  // a 32 x 64 slice of the tile
  using LayoutB = typename std::conditional<TRANS_B, wmma::col_major, wmma::row_major>::type;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
  zero_acc(acc);

  const bool a_vec = (K % 8) == 0;
  const bool b_vec = TRANS_B ? (K % 8) == 0 : (N % 8) == 0;
  const int nk = (K + kTK - 1) / kTK;
  auto load_stage = [&](int s, int kt) {
    const int k0 = kt * kTK;
    T* const sA = sm + s * (kAStage + kBStage);
    T* const sB = sA + kAStage;
    load_tile<T, kTM, kTK>(sA, kLdA, lhs, K, row0, k0, n_rows, K, a_vec);
    if constexpr (TRANS_B) {
      load_tile<T, kTN, kTK>(sB, kLdB, B, K, col0, k0, N, K, b_vec);
    } else {
      load_tile<T, kTK, kTN>(sB, kLdB, B, N, k0, col0, K, N, b_vec);
    }
    cp_async_commit();
  };

  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) {
      load_stage(s ^ 1, kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* const sA = sm + s * (kAStage + kBStage);
    const T* const sB = sA + kAStage;
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LayoutB> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sA + (wm * 32 + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 64 + j * 16;
        if constexpr (TRANS_B) {
          wmma::load_matrix_sync(b[j], sB + n * kLdB + kk, kLdB);
        } else {
          wmma::load_matrix_sync(b[j], sB + kk * kLdB + n, kLdB);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  // the pipeline's shared memory is free now: 1 KB of fp32 scratch per warp
  float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
  store_acc(acc, scratch, out, N, row0 + wm * 32, col0 + wn * 64, n_rows, N);
}

// out [E, K, N] fp32: out[e] = sum over rows r of expert e's row blocks of
// lhs[r, :]^T dy[r, :]. Grid: x = k_tile * num_n + n_tile, y = e.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    tgmm_kernel(const T* __restrict__ lhs, const T* __restrict__ dy, const int* __restrict__ be,
                float* __restrict__ out, int n_rows, int K, int N, int bt) {
  constexpr int kLd = kTM + kPad;  // both stages [kTK rows][kLd]: lhs rows and dy rows
  constexpr int kStage = kTK * kLd;
  static_assert(4 * kStage * (int)sizeof(T) <= kSmemBytes, "shared memory layout");
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  // stage s: the lhs rows at sm + 2 * s * kStage, the dy rows right after
  T* const sm = reinterpret_cast<T*>(smem);

  const int num_n = (N + kTN - 1) / kTN;
  const int n_tile = blockIdx.x % num_n;
  const int k_tile = blockIdx.x / num_n;
  const int e = blockIdx.y;
  const int k0 = k_tile * kTM, n0 = n_tile * kTN;

  // the expert's row blocks [first, last): be is non-decreasing
  const int nb = n_rows / bt;
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (be[mid] < e) lo = mid + 1; else hi = mid;
  }
  const int first = lo;
  hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (be[mid] <= e) lo = mid + 1; else hi = mid;
  }
  const int r_begin = first * bt, r_end = lo * bt;

  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
  zero_acc(acc);

  const bool a_vec = (K % 8) == 0;
  const bool b_vec = (N % 8) == 0;
  const int steps = (r_end - r_begin) / kTK;  // bt is a multiple of kTK
  auto load_stage = [&](int s, int step) {
    const int r0 = r_begin + step * kTK;
    T* const sA = sm + 2 * s * kStage;
    load_tile<T, kTK, kTM>(sA, kLd, lhs, K, r0, k0, r_end, K, a_vec);
    load_tile<T, kTK, kTN>(sA + kStage, kLd, dy, N, r0, n0, r_end, N, b_vec);
    cp_async_commit();
  };

  if (steps > 0) load_stage(0, 0);
  for (int st = 0; st < steps; ++st) {
    const int s = st & 1;
    if (st + 1 < steps) {
      load_stage(s ^ 1, st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* const sA = sm + 2 * s * kStage;
    const T* const sB = sA + kStage;
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      // A = lhs^T: element (m, r) sits at sA[r][m], a column-major operand
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sA + kk * kLd + wm * 32 + i * 16, kLd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], sB + kk * kLd + wn * 64 + j * 16, kLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
  store_acc(acc, scratch, out + (long long)e * K * N, N, k0 + wm * 32, n0 + wn * 64, K, N);
}

bool shapes_ok(int n_rows, int K, int N, int bt) {
  return n_rows > 0 && K > 0 && N > 0 && bt > 0 && bt % kTM == 0 && n_rows % bt == 0;
}

template <typename T>
cudaError_t launch_gmm(const void* lhs, const void* rhs, const int* be, void* out, int n_rows,
                       int K, int N, int bt, int trans_b, cudaStream_t stream) {
  const long long ctas = (long long)(n_rows / kTM) * ((N + kTN - 1) / kTN);
  if (ctas > 2147483647LL) return cudaErrorInvalidValue;
  const T* a = reinterpret_cast<const T*>(lhs);
  const T* b = reinterpret_cast<const T*>(rhs);
  T* o = reinterpret_cast<T*>(out);
  if (trans_b) {
    gmm_kernel<T, true><<<(unsigned)ctas, kThreads, 0, stream>>>(a, b, be, o, n_rows, K, N, bt);
  } else {
    gmm_kernel<T, false><<<(unsigned)ctas, kThreads, 0, stream>>>(a, b, be, o, n_rows, K, N, bt);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tgmm(const void* lhs, const void* dy, const int* be, float* out, int n_rows,
                        int K, int N, int bt, int E, cudaStream_t stream) {
  const long long tiles = (long long)((K + kTM - 1) / kTM) * ((N + kTN - 1) / kTN);
  if (tiles > 2147483647LL || E > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)E);
  tgmm_kernel<T><<<grid, kThreads, 0, stream>>>(reinterpret_cast<const T*>(lhs),
                                                  reinterpret_cast<const T*>(dy), be, out,
                                                  n_rows, K, N, bt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [T, N] in lhs's dtype = per row block i: lhs[i*bt:(i+1)*bt] @ rhs[be[i]]
// (rhs [E, K, N]) or, with trans_b, @ rhs[be[i]]^T (rhs [E, N, K]).
// be: int32 [T / bt], non-decreasing. half = 1 for fp16, 0 for bf16.
int ds_gmm(const void* lhs, const void* rhs, const int* be, void* out, int n_rows, int K, int N,
           int bt, int trans_b, int half, void* stream) {
  if (!shapes_ok(n_rows, K, N, bt)) return (int)cudaErrorInvalidValue;
  return half ? (int)launch_gmm<__half>(lhs, rhs, be, out, n_rows, K, N, bt, trans_b,
                                        (cudaStream_t)stream)
              : (int)launch_gmm<__nv_bfloat16>(lhs, rhs, be, out, n_rows, K, N, bt, trans_b,
                                               (cudaStream_t)stream);
}

// out [E, K, N] fp32: out[e] = sum over the row blocks i with be[i] == e of
// lhs[i*bt:(i+1)*bt]^T @ dy[i*bt:(i+1)*bt]; zeros for an expert with none.
int ds_tgmm(const void* lhs, const void* dy, const int* be, float* out, int n_rows, int K, int N,
            int bt, int E, int half, void* stream) {
  if (!shapes_ok(n_rows, K, N, bt) || E < 1) return (int)cudaErrorInvalidValue;
  return half ? (int)launch_tgmm<__half>(lhs, dy, be, out, n_rows, K, N, bt, E,
                                         (cudaStream_t)stream)
              : (int)launch_tgmm<__nv_bfloat16>(lhs, dy, be, out, n_rows, K, N, bt, E,
                                                (cudaStream_t)stream);
}

const char* ds_gmm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
