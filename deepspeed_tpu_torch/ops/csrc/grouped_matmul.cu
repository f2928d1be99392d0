// Grouped matmul for mixture-of-experts layers (megablocks-style), for
// Hopper (sm_90a).
//
// Plain C interface (loaded with ctypes by ops/_build.py); every launcher
// returns the cudaError_t of its launch (or kErrTensorMap when the driver
// refuses a TMA descriptor) and never synchronises.
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
// tgmm finds an expert's row blocks by two binary searches over be; an
// expert that owns no row block gets zeros (the TPU kernel leaves such a
// block unwritten; the dispatcher never produces one,
// deepspeed_tpu/moe/grouped.py:61-63). Every output element is written once,
// with no atomics.
//
// What bounds it on the H100: at the main path's shapes (8192 routed rows,
// K / N = 4096 / 14336) each call does 9.6e11 FLOPs against ~1.2 GB (gmm)
// or ~2.2 GB (tgmm, its fp32 output 1.88 GB of it) of traffic, so the bound
// is the tensor cores' 989 TFLOP/s (0.97 ms); tgmm's output alone takes
// 0.56 ms of the 3.35 TB/s, so its stores must be wide.
//
// Two routes, chosen by shape alone (ops/grouped_matmul.py: route):
//
// ds_gmm / ds_tgmm, the wgmma route (K and N multiples of 8, so that every
// row of every operand starts on 16 bytes and TMA can describe it). Output
// tiles of 128 x 256; a persistent grid of one CTA per SM (384 threads)
// walks them. Warpgroup 0 is the producer: one thread keeps TMA loads two
// stages ahead in a ring of kStages = 3 stages of a 128 x 64 A tile and a
// 64 x 256 B tile (48 KB a stage: 4.2 MFLOP of products), each guarded by a
// full and an empty mbarrier, and runs on into the next tile's stages while
// the consumers write this one. Warpgroups 1 and 2 each own 64 rows of the
// tile and issue wgmma.mma_async m64n256k16 with both operands read from
// the swizzled shared tiles (wgmma_sm90.cuh), 128 fp32 accumulators a
// thread in registers, the previous stage released as soon as its products
// have retired. The three products differ only in the operands'
// major-ness and in what the loop walks:
//   gmm      A = lhs rows (K-major), B = rhs[e] [K, N] (N-major: the
//            instruction's B transpose bit); the loop walks K
//   gmm^T    B = rhs[e] [N, K] (K-major, wgmma's native B); the loop walks K
//   tgmm     A = lhs^T, B = dy, both read as they lie (M- and N-major: both
//            transpose bits); the loop walks the expert's rows, 64 a stage
// TMA fills zeros past K and N, so the edges need no code. The epilogue
// writes each consumer's 64-row slice into 32 KB of swizzled shared memory
// (bf16 or fp32 pairs, no bank conflicts; tgmm's fp32 slice in two passes)
// and one thread stores it with TMA, which drops what lies past the edge;
// the store runs on while the next tile's products start (the staging is
// rewritten only after it has been read). gmm tiles run in groups of 8 row
// tiles, so that the tiles in flight share an expert's weight columns in
// L2; tgmm's expert by expert, row tiles fastest.
// rhs is described as a 3-D tensor (expert outermost) of kMaxExperts
// experts: the C interface does not pass E (the wrapper refuses more), and
// the kernel addresses only experts named by be.
//
// ds_gmm_wmma / ds_tgmm_wmma, the second route (any width; the wrapper sends
// it only widths that are not multiples of 8): the first version. 8
// warps, each a 32 x 64 slice of the 128 x 128 tile as 2 x 4 nvcuda::wmma
// 16x16x16 fragments; operand tiles of 32 along the reduction staged in
// padded shared memory, double-buffered with 16-byte cp.async loads (element
// loads where a row is not 16-byte aligned); edges masked by hand, int64
// offsets (TMA addresses the wgmma route's operands).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "wgmma_sm90.cuh"

namespace {

constexpr int kErrTensorMap = 100000;  // a launcher's code: the driver refused a tensor map
constexpr int kMaxExperts = 65535;
constexpr int kGroupM = 8;  // gmm row tiles per raster group (both routes)

// the rows [r_begin, r_end) of expert e's row blocks (be is non-decreasing)
__device__ __forceinline__ void expert_rows(const int* __restrict__ be, int nb, int e, int bt,
                                            int& r_begin, int& r_end) {
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
  r_begin = first * bt;
  r_end = lo * bt;
}

// gmm's grouped raster of tile t: kGroupM row tiles x every column tile,
// row-fastest
__device__ __forceinline__ void gmm_tile(int t, int num_m, int num_n, int& m_tile, int& n_tile) {
  const int per_group = kGroupM * num_n;
  const int group = t / per_group;
  const int first_m = group * kGroupM;
  const int group_size = min(num_m - first_m, kGroupM);
  const int in_group = t % per_group;
  m_tile = first_m + in_group % group_size;
  n_tile = in_group / group_size;
}

bool shapes_ok(int n_rows, int K, int N, int bt) {
  return n_rows > 0 && K > 0 && N > 0 && bt > 0 && bt % 128 == 0 && n_rows % bt == 0;
}

// ---------------------------------------------------------------------------
// the wgmma route
// ---------------------------------------------------------------------------

namespace wgmma_route {

using namespace ds_wgmma;

constexpr int kThreads = 384;  // warpgroup 0 loads, warpgroups 1 and 2 multiply
constexpr int kBM = 128, kBN = 256, kBK = 64;
constexpr int kStages = 3;
constexpr int kBlock = 8192;  // 64 rows x 128 swizzled bytes: one 64 x 64 box of 16-bit values
constexpr int kATile = kBM * kBK * 2;  // 16 KB
constexpr int kStageBytes = kATile + kBK * kBN * 2;  // + a 32 KB B tile
constexpr int kRing = kStages * kStageBytes;
constexpr int kSlice = 4 * kBlock;  // a consumer's output staging: four TMA boxes, 32 KB
constexpr int kSmemBytes = 1024 + kRing + 2 * kSlice + 2 * kStages * 8;  // + base alignment

enum Kind { kGmm = 0, kGmmT = 1, kTgmm = 2 };

__device__ __forceinline__ uint32_t pack2(float a, float b, __nv_bfloat16) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, __half) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One output tile: out rows [row0, row0 + 128) and columns [col0, col0 +
// 256), of expert e; n_iter ring stages, from row r_begin (tgmm).
struct Tile {
  int row0, col0, e, n_iter, r_begin;
};

// gmm tiles in the grouped raster; tgmm tiles expert by expert, each
// expert's n_tile * num_k + k_tile: the tiles in flight share dy's column
// blocks and the expert's lhs (9.4 MB at Mixtral's widths) stays in L2
// (row-band first, every wave would stream all of the expert's dy, 33 MB,
// again from device memory)
template <int KIND>
__device__ __forceinline__ Tile tile_at(int t, const int* __restrict__ be, int n_rows, int K,
                                        int N, int bt) {
  const int num_n = (N + kBN - 1) / kBN;
  Tile x;
  if constexpr (KIND == kTgmm) {
    const int num_k = (K + kBM - 1) / kBM;
    const int per_e = num_k * num_n;
    x.e = t / per_e;
    x.row0 = (t % per_e) % num_k * kBM;
    x.col0 = (t % per_e) / num_k * kBN;
    int r_end;
    expert_rows(be, n_rows / bt, x.e, bt, x.r_begin, r_end);
    x.n_iter = (r_end - x.r_begin) / kBK;  // bt is a multiple of kBK
  } else {
    int m_tile, n_tile;
    gmm_tile(t, n_rows / kBM, num_n, m_tile, n_tile);
    x.row0 = m_tile * kBM;
    x.col0 = n_tile * kBN;
    x.e = be[x.row0 / bt];
    x.r_begin = 0;
    x.n_iter = (K + kBK - 1) / kBK;
  }
  return x;
}

// gmm / gmm^T: out [n_rows, N] (T) = lhs [n_rows, K] . B_e, e = be[row / bt].
// tgmm: out [E, K, N] (fp32), out[e] = sum over expert e's rows r of
// lhs[r, :]^T dy[r, :]. The CTA walks tiles blockIdx.x, + gridDim.x, ...
// (a persistent grid of one CTA per SM, or one CTA per tile): the producer
// runs on into the next tile's stages while the consumers write this one.
// Tensor maps: gmm A lhs (K, n_rows) boxes 64 x 128; B rhs (N, K, E) boxes
// 64 x 64 x 1, or for gmm^T (K, N, E) boxes 64 x 256 x 1; out (N, n_rows)
// boxes 64 x 64. tgmm A lhs (K, n_rows) and B dy (N, n_rows) boxes 64 x 64,
// out (N, K, E) fp32 boxes 32 x 64 x 1.
template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_out, const int* __restrict__ be,
                 int n_rows, int K, int N, int bt, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const epi = ring + kRing;
  uint64_t* const full = reinterpret_cast<uint64_t*>(epi + 2 * kSlice);
  uint64_t* const empty = full + kStages;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the stage's TMA bytes
      mbar_init(&empty[s], 8);  // lane 0 of each of the 8 consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  // g counts ring stages over all of this CTA's tiles: stage g % kStages,
  // the (g / kStages)-th use of it
  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {  // the producer
    if (threadIdx.x == 0) {
      int g = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile x = tile_at<KIND>(t, be, n_rows, K, N, bt);
        for (int it = 0; it < x.n_iter; ++it, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(&empty[s], ((g / kStages) - 1) & 1);
          uint8_t* const sa = ring + s * kStageBytes;
          uint8_t* const sb = sa + kATile;
          mbar_arrive_expect_tx(&full[s], kStageBytes);
          if constexpr (KIND == kTgmm) {
            const int r = x.r_begin + it * kBK;
            tma_load_2d(sa, &tm_a, &full[s], x.row0, r);
            tma_load_2d(sa + kBlock, &tm_a, &full[s], x.row0 + 64, r);
#pragma unroll
            for (int h = 0; h < kBN / 64; ++h)
              tma_load_2d(sb + h * kBlock, &tm_b, &full[s], x.col0 + 64 * h, r);
          } else {
            const int k0 = it * kBK;
            tma_load_2d(sa, &tm_a, &full[s], k0, x.row0);
            if constexpr (KIND == kGmm) {
#pragma unroll
              for (int h = 0; h < kBN / 64; ++h)
                tma_load_3d(sb + h * kBlock, &tm_b, &full[s], x.col0 + 64 * h, k0, x.e);
            } else {
              tma_load_3d(sb, &tm_b, &full[s], k0, x.col0, x.e);
            }
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup cw owns out rows [row0 + 64 cw, row0 + 64 cw + 64)
  const int cw = wgi - 1;
  const int lane = threadIdx.x & 31;
  const bool leader = (threadIdx.x & 127) == 0;  // issues the warpgroup's stores
  uint8_t* const st = epi + cw * kSlice;
  int g = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Tile x = tile_at<KIND>(t, be, n_rows, K, N, bt);
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    for (int it = 0; it < x.n_iter; ++it, ++g) {
      const int s = g % kStages;
      mbar_wait(&full[s], (g / kStages) & 1);
      const uint8_t* const sa = ring + s * kStageBytes;
      const uint8_t* const sb = sa + kATile;
      fence_regs(acc);
      mma_fence();
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        uint64_t da, db;
        if constexpr (KIND == kTgmm) {  // both MN-major: k16 step j is 16 rows of 128 bytes on
          da = smem_desc(sa + cw * kBlock + 2048 * j, kBlock, 1024);
          db = smem_desc(sb + 2048 * j, kBlock, 1024);
        } else {  // A K-major: k16 step j is 32 bytes into each row
          da = smem_desc(sa + cw * kBlock + 32 * j, 16, 1024);
          db = KIND == kGmm ? smem_desc(sb + 2048 * j, kBlock, 1024)
                            : smem_desc(sb + 32 * j, 16, 1024);
        }
        mma_m64n256k16<KIND == kTgmm, KIND != kGmmT>(acc, da, db, T());
      }
      mma_commit();
      fence_regs(acc);
      mma_wait<1>();  // the previous stage's products have retired: release it
      fence_regs(acc);
      if (it > 0 && lane == 0) mbar_arrive(&empty[(g - 1) % kStages]);
    }
    mma_wait<0>();
    fence_regs(acc);
    if (x.n_iter > 0 && lane == 0) mbar_arrive(&empty[(g - 1) % kStages]);

    // out: each consumer warpgroup writes its 64 rows
    // through its 32 KB of shared staging, four TMA boxes a pass: gmm's
    // 64 x 256 16-bit slice in one pass (boxes of 64 columns), tgmm's fp32
    // slice in two of 128 columns (boxes of 32)
    constexpr int kPasses = KIND == kTgmm ? 2 : 1;
    constexpr int kGroups = kBN / 8 / kPasses;  // n8 column groups a pass
    const int q = lane & 3;
    const int r_lo = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);  // and r_lo + 8
    const int r0 = x.row0 + 64 * cw;
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      if (leader) bulk_wait_read();  // the earlier stores have read the staging
      named_sync(1 + cw, 128);
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        const int i = pass * kGroups + j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r_lo + 8 * h;
          if constexpr (KIND == kTgmm) {
            const int chunk = 2 * (j & 3) + (q >> 1);
            *reinterpret_cast<float2*>(st + (j >> 2) * kBlock + r * 128 +
                                       ((chunk ^ (r & 7)) << 4) + (q & 1) * 8) =
                make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
          } else {
            *reinterpret_cast<uint32_t*>(st + (j >> 3) * kBlock + r * 128 +
                                         (((j & 7) ^ (r & 7)) << 4) + q * 4) =
                pack2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1], T());
          }
        }
      }
      fence_proxy_async();
      named_sync(1 + cw, 128);
      if (leader) {
#pragma unroll
        for (int box = 0; box < 4; ++box) {
          const int c = x.col0 + pass * (kBN / kPasses) + box * (kBN / kPasses / 4);
          if (c >= N) continue;
          if constexpr (KIND == kTgmm) {
            if (r0 < K) tma_store_3d(&tm_out, st + box * kBlock, c, r0, x.e);
          } else {
            tma_store_2d(&tm_out, st + box * kBlock, c, r0);
          }
        }
        bulk_commit();
      }
    }
  }
  if (leader) bulk_wait_read();
}

template <typename T>
CUtensorMapDataType map_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// a persistent grid: one CTA per SM walks the tiles (false: one CTA per tile)
constexpr bool kPersistent = true;

template <typename T, int KIND>
int launch(const CUtensorMap& a, const CUtensorMap& b, const CUtensorMap& o, const int* be,
           int n_rows, int K, int N, int bt, long long n_tiles, cudaStream_t stream) {
  if (n_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(wgmma_kernel<T, KIND>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  int dev = 0, sms = 0;
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  const long long grid = kPersistent ? std::min<long long>(n_tiles, sms) : n_tiles;
  wgmma_kernel<T, KIND><<<(unsigned)grid, kThreads, kSmemBytes, stream>>>(a, b, o, be, n_rows, K,
                                                                          N, bt, (int)n_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gmm(const void* lhs, const void* rhs, const int* be, void* out, int n_rows, int K,
               int N, int bt, int trans_b, cudaStream_t stream) {
  const long long tiles = (long long)(n_rows / kBM) * ((N + kBN - 1) / kBN);
  const CUtensorMapDataType ty = map_type<T>();
  const uint64_t k = K, n = N, rows = n_rows;
  CUtensorMap ta, tb, to;
  const uint64_t a_dims[2] = {k, rows}, a_str[1] = {2 * k};
  const uint32_t a_box[2] = {64, 128};
  const uint64_t o_dims[2] = {n, rows}, o_str[1] = {2 * n};
  const uint32_t o_box[2] = {64, 64};
  bool ok = make_map(&ta, ty, 2, lhs, a_dims, a_str, a_box) &&
            make_map(&to, ty, 2, out, o_dims, o_str, o_box);
  if (trans_b) {
    const uint64_t b_dims[3] = {k, n, kMaxExperts}, b_str[2] = {2 * k, 2 * k * n};
    const uint32_t b_box[3] = {64, kBN, 1};
    ok = ok && make_map(&tb, ty, 3, rhs, b_dims, b_str, b_box);
  } else {
    const uint64_t b_dims[3] = {n, k, kMaxExperts}, b_str[2] = {2 * n, 2 * k * n};
    const uint32_t b_box[3] = {64, 64, 1};
    ok = ok && make_map(&tb, ty, 3, rhs, b_dims, b_str, b_box);
  }
  if (!ok) return kErrTensorMap;
  return trans_b ? launch<T, kGmmT>(ta, tb, to, be, n_rows, K, N, bt, tiles, stream)
                 : launch<T, kGmm>(ta, tb, to, be, n_rows, K, N, bt, tiles, stream);
}

template <typename T>
int launch_tgmm(const void* lhs, const void* dy, const int* be, float* out, int n_rows, int K,
                int N, int bt, int E, cudaStream_t stream) {
  const long long tiles = (long long)E * ((K + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (E > kMaxExperts) return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType ty = map_type<T>();
  const uint64_t k = K, n = N, rows = n_rows;
  CUtensorMap ta, tb, to;
  const uint64_t a_dims[2] = {k, rows}, a_str[1] = {2 * k};
  const uint64_t b_dims[2] = {n, rows}, b_str[1] = {2 * n};
  const uint32_t box[2] = {64, 64};
  const uint64_t o_dims[3] = {n, k, (uint64_t)E}, o_str[2] = {4 * n, 4 * k * n};
  const uint32_t o_box[3] = {32, 64, 1};
  if (!(make_map(&ta, ty, 2, lhs, a_dims, a_str, box) &&
        make_map(&tb, ty, 2, dy, b_dims, b_str, box) &&
        make_map(&to, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, out, o_dims, o_str, o_box)))
    return kErrTensorMap;
  return launch<T, kTgmm>(ta, tb, to, be, n_rows, K, N, bt, tiles, stream);
}

}  // namespace wgmma_route

// ---------------------------------------------------------------------------
// the wmma route (widths that TMA cannot describe)
// ---------------------------------------------------------------------------

namespace wmma_route {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kTM = 128;     // output rows per CTA tile
constexpr int kTN = 128;     // output columns per CTA tile
constexpr int kTK = 32;      // reduction depth per pipeline stage
constexpr int kPad = 8;      // shared-memory row padding (elements)
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

  int m_tile, n_tile;
  gmm_tile(blockIdx.x, n_rows / kTM, (N + kTN - 1) / kTN, m_tile, n_tile);
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

  int r_begin, r_end;
  expert_rows(be, n_rows / bt, e, bt, r_begin, r_end);

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

template <typename T>
int launch_gmm(const void* lhs, const void* rhs, const int* be, void* out, int n_rows,
                       int K, int N, int bt, int trans_b, cudaStream_t stream) {
  const long long ctas = (long long)(n_rows / kTM) * ((N + kTN - 1) / kTN);
  if (ctas > 2147483647LL) return (int)cudaErrorInvalidValue;
  const T* a = reinterpret_cast<const T*>(lhs);
  const T* b = reinterpret_cast<const T*>(rhs);
  T* o = reinterpret_cast<T*>(out);
  if (trans_b) {
    gmm_kernel<T, true><<<(unsigned)ctas, kThreads, 0, stream>>>(a, b, be, o, n_rows, K, N, bt);
  } else {
    gmm_kernel<T, false><<<(unsigned)ctas, kThreads, 0, stream>>>(a, b, be, o, n_rows, K, N, bt);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tgmm(const void* lhs, const void* dy, const int* be, float* out, int n_rows,
                        int K, int N, int bt, int E, cudaStream_t stream) {
  const long long tiles = (long long)((K + kTM - 1) / kTM) * ((N + kTN - 1) / kTN);
  if (tiles > 2147483647LL || E > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)E);
  tgmm_kernel<T><<<grid, kThreads, 0, stream>>>(reinterpret_cast<const T*>(lhs),
                                                  reinterpret_cast<const T*>(dy), be, out,
                                                  n_rows, K, N, bt);
  return (int)cudaGetLastError();
}

}  // namespace wmma_route

}  // namespace

extern "C" {

// out [T, N] in lhs's dtype = per row block i: lhs[i*bt:(i+1)*bt] @ rhs[be[i]]
// (rhs [E, K, N]) or, with trans_b, @ rhs[be[i]]^T (rhs [E, N, K]).
// be: int32 [T / bt], non-decreasing. half = 1 for fp16, 0 for bf16.
// The wgmma route: K and N multiples of 8, 16-byte aligned operands.
int ds_gmm(const void* lhs, const void* rhs, const int* be, void* out, int n_rows, int K, int N,
           int bt, int trans_b, int half, void* stream) {
  namespace r = wgmma_route;
  if (!shapes_ok(n_rows, K, N, bt) || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return half ? r::launch_gmm<__half>(lhs, rhs, be, out, n_rows, K, N, bt, trans_b, s)
              : r::launch_gmm<__nv_bfloat16>(lhs, rhs, be, out, n_rows, K, N, bt, trans_b, s);
}

// out [E, K, N] fp32: out[e] = sum over the row blocks i with be[i] == e of
// lhs[i*bt:(i+1)*bt]^T @ dy[i*bt:(i+1)*bt]; zeros for an expert with none.
// The wgmma route: K and N multiples of 8, 16-byte aligned operands.
int ds_tgmm(const void* lhs, const void* dy, const int* be, float* out, int n_rows, int K, int N,
            int bt, int E, int half, void* stream) {
  namespace r = wgmma_route;
  if (!shapes_ok(n_rows, K, N, bt) || E < 1 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return half ? r::launch_tgmm<__half>(lhs, dy, be, out, n_rows, K, N, bt, E, s)
              : r::launch_tgmm<__nv_bfloat16>(lhs, dy, be, out, n_rows, K, N, bt, E, s);
}

// the same two products on the wmma route, for any K and N
int ds_gmm_wmma(const void* lhs, const void* rhs, const int* be, void* out, int n_rows, int K,
                int N, int bt, int trans_b, int half, void* stream) {
  namespace r = wmma_route;
  if (!shapes_ok(n_rows, K, N, bt)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return half ? r::launch_gmm<__half>(lhs, rhs, be, out, n_rows, K, N, bt, trans_b, s)
              : r::launch_gmm<__nv_bfloat16>(lhs, rhs, be, out, n_rows, K, N, bt, trans_b, s);
}

int ds_tgmm_wmma(const void* lhs, const void* dy, const int* be, float* out, int n_rows, int K,
                 int N, int bt, int E, int half, void* stream) {
  namespace r = wmma_route;
  if (!shapes_ok(n_rows, K, N, bt) || E < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return half ? r::launch_tgmm<__half>(lhs, dy, be, out, n_rows, K, N, bt, E, s)
              : r::launch_tgmm<__nv_bfloat16>(lhs, dy, be, out, n_rows, K, N, bt, E, s);
}

// dynamic shared memory of a wgmma-route CTA (gmm, either layout, and tgmm)
int ds_gmm_smem_bytes() { return wgmma_route::kSmemBytes; }

const char* ds_gmm_error_string(int code) {
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a tensor map (or the driver has no such entry point)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
