// Tensor-core building blocks of the attention kernels, for Hopper (sm_90a):
// included by flash_attention.cu, paged_attention.cu, evoformer_attention.cu
// and block_sparse_attention.cu, each built into its own library
// (ops/_build.py keys a library on its source and every csrc header it
// includes, so an edit here rebuilds all four).
//
// A warp owns 16 rows of a 64-row tile and every product runs as
// mma.sync.m16n8k16 with bf16 / fp16 operands and fp32 accumulators,
// operands loaded with ldmatrix from padded shared tiles: row stride D + 8
// elements, so the eight rows an 8 x 8 ldmatrix reads fall in eight
// different 16-byte bank groups. Fragment layouts (PTX ISA, m16n8k16): with
// g = lane / 4 and t = lane % 4, a C fragment holds rows g and g + 8,
// columns 2t and 2t + 1 of a 16 x 8 tile, so element e of n-tile j is
// (row g + 8 (e / 2), column 8 j + 2 t + e % 2). Two neighbouring C tiles
// are one A fragment of the next product (FA2's register reuse): a
// probability tile never goes through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ds_mma {

constexpr int kPad = 8;  // elements of padding per shared row
constexpr int kTileThreads = 128;  // a CTA of 4 warps x 16 rows of a 64-row tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile16 {
  static constexpr int LDS = D + kPad;    // row stride, elements (a 16-byte multiple)
  static constexpr int ELEMS = 64 * LDS;  // one 16-bit [64][D] tile
};

__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 (4) bytes global -> shared, zero-filled when !valid (src is then any
// mapped address and is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest has landed (this thread's copies)
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// every group has landed (this thread's copies)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// every group but the newest n has landed (this thread's copies)
template <int n>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Rows r0 .. r0 + 63 of a [.., n, D] tensor (row stride ld elements) into a
// [64][LDS] shared tile, asynchronously, by the NT threads of a CTA (its
// first NT); rows past S are zeros.
template <int D, typename T, int NT = kTileThreads>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long ld, int r0, int S) {
  constexpr int CH = D / 8, LDS = Tile16<D>::LDS;
  for (int c = threadIdx.x; c < 64 * CH; c += NT) {
    const int r = c / CH, c8 = (c % CH) * 8;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * LDS + c8, ok ? src + (long long)(r0 + r) * ld + c8 : src, ok);
  }
}

__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a . b on the tensor cores: a 16 x 16 (row), b 16 x 8 (col), fp32 c
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1, __nv_bfloat16) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1, __half) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as two packed 16-bit values, x in the low half (the lower column)
__device__ __forceinline__ unsigned pack2(__nv_bfloat16 x, __nv_bfloat16 y) {
  __nv_bfloat162 v = __halves2bfloat162(x, y);
  return *reinterpret_cast<unsigned*>(&v);
}
__device__ __forceinline__ unsigned pack2(__half x, __half y) {
  __half2 v = __halves2half2(x, y);
  return *reinterpret_cast<unsigned*>(&v);
}

// A warp's 16 x D C fragments, times mul, to rows row0 + (g, g + 8) of a
// [.., n, D] tensor (row stride ld elements; rows past S are not written)
template <int D, typename T>
__device__ __forceinline__ void store_frags(T* p, long long ld, int row0, int S,
                                            const float (&acc)[D / 8][4], float mul, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + lane / 4 + 8 * i;
    if (row >= S) continue;
    T* dst = p + (long long)row * ld + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<unsigned*>(dst + 8 * n) =
          pack2(from_f<T>(acc[n][2 * i] * mul), from_f<T>(acc[n][2 * i + 1] * mul));
  }
}

// A warp's 16 x 16 KC fp32 tile (2 KC C fragments, as mma_abt leaves them;
// KC 4: 16 x 64) as the A fragments of KC depth-16 chunks, each value split
// into a pair hi + lo of T (about twice T's significant bits: 16 for bf16,
// 22 for fp16 down to fp16's subnormals). C tiles 2c and 2c + 1 are chunk
// c's A fragment: element e of C tile j is register 2 (j % 2) + e / 2, half
// e % 2.
template <int KC = 4>
struct SplitFragsN {
  unsigned hi[KC][4], lo[KC][4];
};
using SplitFrags = SplitFragsN<4>;

template <typename T, int NT>
__device__ __forceinline__ void split_frags(SplitFragsN<NT / 2>& f, const float (&w)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x = w[j][2 * h], y = w[j][2 * h + 1];
      const T hx = from_f<T>(x), hy = from_f<T>(y);
      f.hi[j / 2][2 * (j % 2) + h] = pack2(hx, hy);
      f.lo[j / 2][2 * (j % 2) + h] = pack2(from_f<T>(x - to_f(hx)), from_f<T>(y - to_f(hy)));
    }
}

__device__ __forceinline__ float half_to_f(unsigned short u, __nv_bfloat16) {
  return __bfloat162float(__ushort_as_bfloat16(u));
}
__device__ __forceinline__ float half_to_f(unsigned short u, __half) {
  return __half2float(__ushort_as_half(u));
}

// hi + lo of element e of C tile j
template <typename T, int KC>
__device__ __forceinline__ float split_value(const SplitFragsN<KC>& f, int j, int e) {
  const int c = j / 2, r = 2 * (j % 2) + e / 2, sh = 16 * (e % 2);
  return half_to_f((unsigned short)(f.hi[c][r] >> sh), T()) +
         half_to_f((unsigned short)(f.lo[c][r] >> sh), T());
}

// acc = A . B^T for a warp: A the warp's 16 rows of a shared [.][D] tile,
// B a shared [8 NT][D] tile (64 rows unless NT says fewer); acc[j] is the
// C fragment of columns 8j .. 8j + 7. Operands straight from the inputs:
// exact products, fp32 sums.
template <int D, typename T, int NT = 8>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const T* sA, const T* sB, int lane) {
  constexpr int LDS = Tile16<D>::LDS;
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // A: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15), in a0..a3 order;
  // B rows are n: matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
  // (n 8-15, k 8-15) = b0, b1 of n-tile j, then b0, b1 of n-tile j + 1
  const T* pa = sA + (lane & 15) * LDS + (lane >> 4) * 8;
  const T* pb = sB + ((lane & 7) + (lane >> 4) * 8) * LDS + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    unsigned a[4];
    ldsm4(a, pa + kk);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      unsigned b[4];
      ldsm4(b, pb + j * 8 * LDS + kk);
      mma16816(acc[j], a, b[0], b[1], T());
      mma16816(acc[j + 1], a, b[2], b[3], T());
    }
  }
}

// out += W . M for a warp: W its 16 x 16 KC tile as split A fragments (two
// products, hi and lo, into the same accumulator); M a shared [16 KC][D]
// tile read with ldmatrix.trans (its rows are the product's depth), its rows
// LDS elements apart (D's padded row unless the caller passes a wider
// tile's, of which M is then D of the columns). out[n] is the C fragment of
// columns 8n .. 8n + 7 of the warp's 16 x D rows. The
// tensor cores' fp32 accumulation truncates, so each tile's product is
// summed from zero over its own 2 KC mma steps and then added to out with
// one rounded fp32 add: a long-run accumulator fed thousands of mma steps
// drifts by up to ~2^-23 of its size per step.
template <int D, typename T, int LDS = Tile16<D>::LDS, int KC = 4>
__device__ __forceinline__ void mma_wm(float (&out)[D / 8][4], const SplitFragsN<KC>& w,
                                       const T* sM, int lane) {
  // matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
  // = b0, b1 of n-tile n, then b0, b1 of n-tile n + 1
  const T* pm = sM + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDS + (lane >> 4) * 8;
#pragma unroll
  for (int n = 0; n < D / 8; n += 2) {
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < KC; ++c) {  // depth 16 c .. 16 c + 15
      unsigned b[4];
      ldsm4_t(b, pm + c * 16 * LDS + n * 8);
      mma16816(t0, w.hi[c], b[0], b[1], T());
      mma16816(t0, w.lo[c], b[0], b[1], T());
      mma16816(t1, w.hi[c], b[2], b[3], T());
      mma16816(t1, w.lo[c], b[2], b[3], T());
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out[n][e] += t0[e];
      out[n + 1][e] += t1[e];
    }
  }
}

// The online softmax of one row's 16 scores in a warp's C fragments (this
// thread's 16 of the row's 64: elements 2 i and 2 i + 1 of every n-tile),
// reduced over the 4 lanes of a quad: m becomes max(m, row max), and the
// scores become p = exp(x - m) for the keys that `keep(j, e)` admits, 0 for
// the rest (a key that is not a position never enters). Returns alpha =
// exp(m_old - m_new), by which the caller rescales the row's accumulators;
// `l` is this thread's share of the row sum, rescaled and added to here.
// Masked scores are -1e30 and the start is m = -1e30, l = 0, never -inf:
// a masked real key enters with weight exp(-1e30 - m) (1 while every key
// seen so far is masked, 0 once a visible key has set m), as in the TPU
// kernels.
template <typename Keep>
__device__ __forceinline__ float online_softmax_row(float (&s)[8][4], int i, float& m, float& l,
                                                    Keep keep) {
  float mx = m;
#pragma unroll
  for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float alpha = exp2f((m - mx) * kLog2e);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float p = keep(j, e) ? exp2f((s[j][2 * i + e] - mx) * kLog2e) : 0.f;
      s[j][2 * i + e] = p;
      sum += p;
    }
  l = l * alpha + sum;
  m = mx;
  return alpha;
}

// the quad's shares of a row sum, added (every lane of the quad gets it)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace ds_mma
