// Flash attention for training (forward and both backward passes), for
// Hopper (sm_90a).
//
// Plain C interface (loaded with ctypes by ops/_build.py); every launcher
// returns the cudaError_t of its launch and never synchronises.
//
// What it replaces (deepspeed_tpu/ops/pallas/flash_attention.py):
//   ds_flash_fwd      -> _flash_fwd_impl (:237): out and lse = m + log(l)
//   ds_flash_bwd_dkdv -> _flash_bwd_impl's dkdv_kernel (:414), GQA group sum
//                        done inside the CTA instead of fp32 per-q-head
//                        buffers summed afterwards (:472-473, :536-538)
//   ds_flash_bwd_dq   -> _flash_bwd_impl's dq_kernel (:483)
//
// Semantics copied from the TPU kernels. q, k, v are [B, S, n, D] (GQA: the
// g = nq / nkv query heads of kv head h / g share it), read in that order
// with no transposes. Forward: q is pre-scaled by 1/sqrt(D) (:285); masked
// scores are -1e30, the online softmax starts at m = -1e30, l = 0, and the
// output is acc / max(l, 1e-30) with lse = m + log(max(l, 1e-30)) (:318).
// Backward: s = scale * q.k (:396), p = exp(s - lse), dp = dO.v,
// delta = rowsum(dO * O) from the stored output, ds = p * (dp - delta);
// dv = sum p^T dO, dk = scale * sum ds^T q, dq = scale * sum ds k. ALiBi adds
// slope[head] * (k_pos - q_pos) before the mask; causal keeps k <= q and a
// window keeps q - k < window. Tiles that hold no visible position are not
// visited (the TPU kernels' pl.when predicates and kv_index clamps become
// loop bounds). Ragged S: positions past S are masked inside the kernels
// (zero-loaded tiles, p = 0), so any length works.
//
// What bounds it on the H100: at the training shapes (S 4096, d 128) every
// kernel does ~64 FLOPs per byte it must move, so the bound is the tensor
// cores' 989 TFLOP/s.
//
// The forward is the first, simple version: fp32 products on the CUDA cores
// (67 TFLOP/s peak) from fp32 tiles of 64 x 64, each of 256 threads owning
// a 4 x 4 score block.
//
// The backward pair runs every product on the tensor cores: mma.sync
// m16n8k16 with bf16 / fp16 operands and fp32 accumulators, operands
// loaded with ldmatrix from shared tiles filled by a two-stage cp.async
// ring. mma.sync rather than wgmma because dS and P must feed the next
// product straight from registers in a per-warp layout that is written out
// in the PTX ISA (the FA2 layout), and a warp that owns its 16 rows masks
// and exponentiates its own fragments with no warpgroup-wide barrier; the
// tensor cores run mma.sync at well below their wgmma rate, which is the
// next step against the bound.
// - q . k^T and dO . v^T take their operands straight from the inputs:
//   exact products, fp32 sums, as in the JAX kernel. p and ds are fp32 there;
//   here each is fed to the tensor cores as a split pair hi + lo of the
//   16-bit type (two products into one accumulator, ~16 significant bits
//   for bf16), because a single rounding costs ~2^-9 relative per term.
//   dk/dv does 6 tile products per (k-tile, q-tile) pair, dq 4.
// - The tensor cores' fp32 accumulation truncates. A dv accumulator of an
//   early key fed ~2,000 mma steps drifted several bf16 ulps from the plain
//   version (to the edge of chip_smoke.py's tolerance), so every output
//   product sums one tile pair's mma steps from zero and adds that to the
//   long-run accumulator with a rounded fp32 add.
// - dq runs first: its CTA holds a q-tile's dO, and reads the matching O
//   once to write delta [B, nq, S] fp32 beside lse. dk/dv reads lse and
//   delta and never loads O.
// - dk/dv's warps own keys: it computes S^T = K . Q^T, so P^T and dS^T are
//   already the A fragments of dv += P^T dO and dk += dS^T Q; dq computes
//   S = Q . K^T and feeds dS to dq += dS K the same way.
// - 128 threads and ~103 KB of shared memory per CTA (two resident 16-bit
//   [64][D + 8] tiles and a two-stage ring of two: K, V resident with
//   (Q, dO) streaming in dk/dv; Q, dO resident with (K, V) streaming in
//   dq) let two CTAs share an SM. No atomics: each output row is summed by
//   one warp in a fixed order, so results do not depend on scheduling.
// - Grid order is heavy-first across the whole grid: blockIdx.y is dk/dv's
//   key tile (early keys see the most queries) and dq's reversed q-tile
//   (late queries see the most keys), blockIdx.x the head, so every head's
//   heaviest CTAs are dispatched first (with the tile in x, a late head's
//   heaviest dk/dv CTA starts hundreds of CTAs in and sets the tail;
//   chip_ablation.py's grid_per_head measures it).
// - The per-element mask runs only on tiles that cross the causal / window
//   band or S; p = exp2((x - lse) log2 e).
//
// Offsets are int64 throughout.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // key rows per tile
constexpr int kLP = kBK + 4;  // padded row of a [kBQ][kBK] probability tile
constexpr float kMask = -1e30f;

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

template <typename T>
__device__ __forceinline__ void load8(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = to_f(h[i]);
}

__device__ __forceinline__ void store8(float* dst, const float* f) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

struct Args {
  const void* q;     // [B, S, nq, D]
  const void* k;     // [B, S, nkv, D]
  const void* v;
  const void* o;     // [B, S, nq, D] (dq)
  const void* dout;  // [B, S, nq, D] (backward)
  float* lse;        // [B, nq, S] fp32 (written by fwd, read by bwd)
  float* delta;      // [B, nq, S] fp32 rowsum(dO * O) (written by dq, read by dk/dv)
  const float* slopes;  // [nq] ALiBi slopes or null
  void* out;         // fwd: out [B, S, nq, D]; dq: dq
  void* dk;          // [B, S, nkv, D]
  void* dv;
  int B, S, nq, nkv, causal, window;
  float scale;
};

// Live tile ranges (inclusive) of the causal / window predicates.
__device__ __forceinline__ void live_k_tiles(const Args& a, int q0, int* lo, int* hi) {
  *lo = 0;
  *hi = (a.S - 1) / kBK;
  if (a.causal) {
    *hi = min(*hi, (min(q0 + kBQ, a.S) - 1) / kBK);
    if (a.window > 0) {
      const int x = q0 - (a.window - 1);
      *lo = x > 0 ? x / kBK : 0;
    }
  }
}

__device__ __forceinline__ void live_q_tiles(const Args& a, int k0, int* lo, int* hi) {
  *lo = 0;
  *hi = (a.S - 1) / kBQ;
  if (a.causal) {
    *lo = k0 / kBQ;
    if (a.window > 0) *hi = min(*hi, (k0 + kBK - 1 + a.window - 1) / kBQ);
  }
}

// (query qpos, key kpos) is visible under the causal / window mask and S
__device__ __forceinline__ bool visible(const Args& a, int qpos, int kpos) {
  bool ok = kpos < a.S && qpos < a.S;
  if (a.causal) {
    ok = ok && kpos <= qpos;
    if (a.window > 0) ok = ok && (qpos - kpos < a.window);
  }
  return ok;
}

// Score of (query qpos, key kpos): the ALiBi bias, then the mask.
__device__ __forceinline__ float mask_score(const Args& a, float s, float slope, int qpos,
                                            int kpos, bool* vis) {
  if (a.slopes != nullptr) s += slope * (float)(kpos - qpos);
  *vis = visible(a, qpos, kpos);
  return *vis ? s : kMask;
}

// Stage `rows` rows of a [.., n, D] tensor (row stride `ld` elements), from
// row r0, into an fp32 [kBQ][D + 4] tile, times `mul`; rows past S are zero.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ld, int r0, int S,
                                          float mul) {
  constexpr int LD = D + 4;
  for (int c = threadIdx.x; c < kBQ * (D / 8); c += kThreads) {
    const int r = c / (D / 8), c8 = (c % (D / 8)) * 8;
    float f[8];
    if (r0 + r < S) {
      load8(src + (long long)(r0 + r) * ld + c8, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] *= mul;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;
    }
    store8(dst + r * LD + c8, f);
  }
}

// acc[i][j] += sum_d A[ra_i][d] * B[rb_j][d] over fp32 tiles of row length
// D + 4, rows ra_i = ty + 16 i, rb_j = tx + 16 j.
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A, const float* Bm,
                                         int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// out[i][n] (float4 at column tx*4 + 64 n of row ro_i = ty + 16 i) +=
// sum_r W[ro_i][r] * M[r][col], over 64 rows r.
template <int D>
__device__ __forceinline__ void tile_mm(float4 (&out)[4][D / 64], const float* W, const float* M,
                                        int ty, int tx) {
  constexpr int LD = D + 4;
  constexpr int NC = D / 64;
#pragma unroll 2
  for (int r = 0; r < 64; ++r) {
    float4 mv[NC];
#pragma unroll
    for (int n = 0; n < NC; ++n) mv[n] = *reinterpret_cast<const float4*>(M + r * LD + tx * 4 + 64 * n);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float w = W[(ty + 16 * i) * kLP + r];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        out[i][n].x = fmaf(w, mv[n].x, out[i][n].x);
        out[i][n].y = fmaf(w, mv[n].y, out[i][n].y);
        out[i][n].z = fmaf(w, mv[n].z, out[i][n].z);
        out[i][n].w = fmaf(w, mv[n].w, out[i][n].w);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// forward: one CTA per (q-tile, q-head, batch); heavy (late) q-tiles first
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  constexpr int LD = D + 4;
  constexpr int NC = D / 64;
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.nq / a.nkv);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;             // [kBQ][LD], pre-scaled q
  float* sK = sQ + kBQ * LD;    // [kBK][LD]; reused for P [kBQ][kLP]
  float* sV = sK + kBK * LD;    // [kBK][LD]

  const long long ldq = (long long)a.nq * D, ldk = (long long)a.nkv * D;
  const long long qbase = (long long)b * a.S * ldq + (long long)h * D;
  const long long kbase = (long long)b * a.S * ldk + (long long)kvh * D;
  const T* kp = reinterpret_cast<const T*>(a.k) + kbase;
  const T* vp = reinterpret_cast<const T*>(a.v) + kbase;
  load_tile<D, T>(sQ, reinterpret_cast<const T*>(a.q) + qbase, ldq, q0, a.S, a.scale);
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;

  float m[4], l[4];
  float4 acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  int kt_lo, kt_hi;
  live_k_tiles(a, q0, &kt_lo, &kt_hi);

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers of sK (as P) and sV are done
    load_tile<D, T>(sK, kp, ldk, k0, a.S, 1.f);
    load_tile<D, T>(sV, vp, ldk, k0, a.S, 1.f);
    __syncthreads();
    float s[4][4] = {};
    tile_dot<D>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kMask;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bool vis;
        s[i][j] = mask_score(a, s[i][j], slope, qpos, k0 + tx + 16 * j, &vis);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a key past S never enters: it is not a position (a masked real
        // key does, with weight exp(-1e30 - m), as in the TPU kernel)
        s[i][j] = k0 + tx + 16 * j < a.S ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        acc[i][n].x *= alpha;
        acc[i][n].y *= alpha;
        acc[i][n].z *= alpha;
        acc[i][n].w *= alpha;
      }
    }
    __syncthreads();  // every thread is done reading sK
    float* sP = sK;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty + 16 * i) * kLP + tx + 16 * j] = s[i][j];
    __syncthreads();
    tile_mm<D>(acc, sP, sV, ty, tx);
  }

  T* op = reinterpret_cast<T*>(a.out) + qbase;
  float* lse = a.lse + ((long long)b * a.nq + h) * a.S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= a.S) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      T* dst = op + (long long)qpos * ldq + tx * 4 + 64 * n;
      dst[0] = from_f<T>(acc[i][n].x / l_safe);
      dst[1] = from_f<T>(acc[i][n].y / l_safe);
      dst[2] = from_f<T>(acc[i][n].z / l_safe);
      dst[3] = from_f<T>(acc[i][n].w / l_safe);
    }
    if (tx == 0) lse[qpos] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// backward: tensor-core kernels (mma.sync m16n8k16, fp32 accumulators)
//
// A CTA is 4 warps; each warp owns 16 of the CTA's 64 rows (queries in dq,
// keys in dk/dv) and every product runs as mma.sync.m16n8k16 with bf16 /
// fp16 operands fed by ldmatrix from padded shared tiles (row stride D + 8
// elements: the eight rows an 8 x 8 ldmatrix reads fall in eight different
// 16-byte bank groups). Fragment layouts (PTX ISA, m16n8k16): with
// g = lane / 4 and t = lane % 4, a C fragment holds rows g and g + 8,
// columns 2t and 2t + 1 of a 16 x 8 tile, so that element e of n-tile j is
// (row g + 8 (e / 2), column 8 j + 2 t + e % 2). Two neighbouring C tiles
// are one A fragment of the next product (FA2's register reuse): the
// probabilities and dS never go through shared memory.
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 128;
constexpr int kPad = 8;  // elements of padding per shared row

template <int D>
struct BwdTile {
  static constexpr int LDS = D + kPad;    // row stride, elements (a 16-byte multiple)
  static constexpr int ELEMS = 64 * LDS;  // one [64][D] tile
};

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

// Rows r0 .. r0 + 63 of a [.., n, D] tensor (row stride ld elements) into a
// [64][LDS] shared tile, asynchronously; rows past S are zeros.
template <int D, typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long ld, int r0, int S) {
  constexpr int CH = D / 8, LDS = BwdTile<D>::LDS;
  for (int c = threadIdx.x; c < 64 * CH; c += kBwdThreads) {
    const int r = c / CH, c8 = (c % CH) * 8;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * LDS + c8, ok ? src + (long long)(r0 + r) * ld + c8 : src, ok);
  }
}

// lse and delta of positions r0 .. r0 + 63 of one head's [S] rows (zeros
// past S): threads 0-63 copy lse, 64-127 delta.
__device__ __forceinline__ void stage_stats(float* sLse, const float* lse, float* sDelta,
                                            const float* delta, int r0, int S) {
  const int i = threadIdx.x % 64, r = r0 + i;
  const bool ok = r < S;
  if (threadIdx.x < 64)
    cp_async4(sLse + i, ok ? lse + r : lse, ok);
  else
    cp_async4(sDelta + i, ok ? delta + r : delta, ok);
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

// A warp's 16 x 64 fp32 tile (eight C fragments, as mma_abt leaves them)
// as the A fragments of four depth-16 chunks, each value split into a pair
// hi + lo of T (about twice T's significant bits: 16 for bf16, 22 for fp16
// down to fp16's subnormals). C tiles 2c and 2c + 1 are chunk c's A
// fragment: element e of C tile j is register 2 (j % 2) + e / 2, half e % 2.
struct SplitFrags {
  unsigned hi[4][4], lo[4][4];
};

template <typename T>
__device__ __forceinline__ void split_frags(SplitFrags& f, const float (&w)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
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
template <typename T>
__device__ __forceinline__ float split_value(const SplitFrags& f, int j, int e) {
  const int c = j / 2, r = 2 * (j % 2) + e / 2, sh = 16 * (e % 2);
  return half_to_f((unsigned short)(f.hi[c][r] >> sh), T()) +
         half_to_f((unsigned short)(f.lo[c][r] >> sh), T());
}

// acc = A . B^T for a warp: A the warp's 16 rows of a shared [.][D] tile,
// B a shared [64][D] tile; acc[j] is the C fragment of columns 8j .. 8j + 7.
// Operands straight from the inputs: exact products, fp32 sums.
template <int D, typename T>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const T* sA, const T* sB, int lane) {
  constexpr int LDS = BwdTile<D>::LDS;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
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
    for (int j = 0; j < 8; j += 2) {
      unsigned b[4];
      ldsm4(b, pb + j * 8 * LDS + kk);
      mma16816(acc[j], a, b[0], b[1], T());
      mma16816(acc[j + 1], a, b[2], b[3], T());
    }
  }
}

// out += W . M for a warp: W its 16 x 64 tile as split A fragments (two
// products, hi and lo, into the same accumulator); M a shared [64][D] tile
// read with ldmatrix.trans (its 64 rows are the product's depth). out[n] is
// the C fragment of columns 8n .. 8n + 7 of the warp's 16 x D rows. The
// tensor cores' fp32 accumulation truncates, so each tile's product is
// summed from zero over its own 8 mma steps and then added to out with one
// rounded fp32 add: a long-run accumulator fed thousands of mma steps
// drifts by up to ~2^-23 of its size per step.
template <int D, typename T>
__device__ __forceinline__ void mma_wm(float (&out)[D / 8][4], const SplitFrags& w, const T* sM,
                                       int lane) {
  constexpr int LDS = BwdTile<D>::LDS;
  // matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
  // = b0, b1 of n-tile n, then b0, b1 of n-tile n + 1
  const T* pm = sM + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDS + (lane >> 4) * 8;
#pragma unroll
  for (int n = 0; n < D / 8; n += 2) {
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // depth 16 c .. 16 c + 15
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

constexpr float kLog2e = 1.4426950408889634f;

// every (query, key) of the q-tile at q0 and the k-tile at k0 is visible
// (no position past S, wholly inside the causal / window band): the
// per-element mask is skipped
__device__ __forceinline__ bool tile_full(const Args& a, int q0, int k0) {
  if (q0 + kBQ > a.S || k0 + kBK > a.S) return false;
  if (!a.causal) return true;
  return k0 + kBK - 1 <= q0 && (a.window <= 0 || q0 + kBQ - 1 - k0 < a.window);
}

// A warp's 16 x D C fragments, times mul, to rows row0 + (g, g + 8) of a
// [.., n, D] tensor (rows past S are not written)
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

// ---------------------------------------------------------------------------
// dq (runs first): one CTA per (q-tile, q-head, batch), heavy (late) q-tiles
// first; Q and dO stay resident, K and V stream through a two-stage
// cp.async ring. It also writes delta = rowsum(dO * O) for dk/dv.
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(kBwdThreads, 2) flash_bwd_dq_kernel(const Args a) {
  constexpr int LDS = BwdTile<D>::LDS, TILE = BwdTile<D>::ELEMS;
  const int qt = gridDim.y - 1 - blockIdx.y, h = blockIdx.x, b = blockIdx.z;
  const int kvh = h / (a.nq / a.nkv);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = 16 * warp;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + TILE;
  T* sKV = sdO + TILE;  // stage s: K at sKV + 2 s TILE, V after it
  float* sLse = reinterpret_cast<float*>(sKV + 4 * TILE);
  float* sDelta = sLse + kBQ;

  const long long ldq = (long long)a.nq * D, ldk = (long long)a.nkv * D;
  const long long qbase = (long long)b * a.S * ldq + (long long)h * D;
  const long long kbase = (long long)b * a.S * ldk + (long long)kvh * D;
  const T* kp = reinterpret_cast<const T*>(a.k) + kbase;
  const T* vp = reinterpret_cast<const T*>(a.v) + kbase;
  int kt_lo, kt_hi;
  live_k_tiles(a, q0, &kt_lo, &kt_hi);
  const int nkt = kt_hi - kt_lo + 1;

  stage_tile<D, T>(sQ, reinterpret_cast<const T*>(a.q) + qbase, ldq, q0, a.S);
  stage_tile<D, T>(sdO, reinterpret_cast<const T*>(a.dout) + qbase, ldq, q0, a.S);
  if (nkt > 0) {
    stage_tile<D, T>(sKV, kp, ldk, kt_lo * kBK, a.S);
    stage_tile<D, T>(sKV + TILE, vp, ldk, kt_lo * kBK, a.S);
  }
  cp_async_commit();

  // delta = rowsum(dO * O) in fp32 from the stored output (the TPU kernels'
  // :395), two threads per row, while the first tiles land; written once to
  // device memory for dk/dv
  {
    const int r = threadIdx.x / 2, half = threadIdx.x % 2, qpos = q0 + r;
    float part = 0.f;
    if (qpos < a.S) {
      const long long off = qbase + (long long)qpos * ldq + half * (D / 2);
      const T* dr = reinterpret_cast<const T*>(a.dout) + off;
      const T* orow = reinterpret_cast<const T*>(a.o) + off;
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        float fd[8], fo[8];
        load8(dr + c, fd);
        load8(orow + c, fo);
#pragma unroll
        for (int e = 0; e < 8; ++e) part += fd[e] * fo[e];
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      const long long row = ((long long)b * a.nq + h) * a.S;
      sDelta[r] = part;
      sLse[r] = qpos < a.S ? a.lse[row + qpos] : 0.f;
      if (qpos < a.S) a.delta[row + qpos] = part;
    }
  }

  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int it = 0; it < nkt; ++it) {
    const int st = it & 1;
    if (it + 1 < nkt) {  // the next k-tile into the other stage
      T* nxt = sKV + 2 * (st ^ 1) * TILE;
      stage_tile<D, T>(nxt, kp, ldk, (kt_lo + it + 1) * kBK, a.S);
      stage_tile<D, T>(nxt + TILE, vp, ldk, (kt_lo + it + 1) * kBK, a.S);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const T* sK = sKV + 2 * st * TILE;
    const T* sV = sK + TILE;
    const int k0 = (kt_lo + it) * kBK;
    const bool full = tile_full(a, q0, k0);
    float s[8][4], dp[8][4];
    mma_abt<D, T>(s, sQ + r0 * LDS, sK, lane);   // q . k
    mma_abt<D, T>(dp, sdO + r0 * LDS, sV, lane);  // dO . v
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + lane / 4 + 8 * i, qpos = q0 + r;
      const float lse = sLse[r], delta = sDelta[r];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * j + 2 * (lane % 4) + e;
          float x = a.scale * s[j][2 * i + e];
          if (a.slopes != nullptr) x += slope * (float)(kpos - qpos);
          const float p = (full || visible(a, qpos, kpos)) ? exp2f((x - lse) * kLog2e) : 0.f;
          dp[j][2 * i + e] = p * (dp[j][2 * i + e] - delta);  // ds
        }
    }
    SplitFrags ds;
    split_frags<T>(ds, dp);
    mma_wm<D, T>(dq, ds, sK, lane);  // dq += ds . k
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  store_frags<D, T>(reinterpret_cast<T*>(a.out) + qbase, ldq, q0 + r0, a.S, dq, a.scale, lane);
}

// ---------------------------------------------------------------------------
// dk/dv: one CTA per (k-tile, kv-head, batch), heavy (early) k-tiles first;
// K and V stay resident, each (q-head of the group, live q-tile) item's Q,
// dO, lse and delta stream through a two-stage cp.async ring. The warp's
// rows are keys: S^T = K . Q^T, so P^T and dS^T are already the A
// fragments of dv += P^T . dO and dk += dS^T . Q.
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(kBwdThreads, 2) flash_bwd_dkdv_kernel(const Args a) {
  constexpr int LDS = BwdTile<D>::LDS, TILE = BwdTile<D>::ELEMS;
  const int kvh = blockIdx.x, kt = blockIdx.y, b = blockIdx.z;
  const int g = a.nq / a.nkv;
  const int k0 = kt * kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = 16 * warp;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + TILE;
  T* sQdO = sV + TILE;  // stage s: Q at sQdO + 2 s TILE, dO after it
  float* sLse = reinterpret_cast<float*>(sQdO + 4 * TILE);  // [2][kBQ]
  float* sDelta = sLse + 2 * kBQ;                           // [2][kBQ]

  const long long ldq = (long long)a.nq * D, ldk = (long long)a.nkv * D;
  const long long kbase = (long long)b * a.S * ldk + (long long)kvh * D;
  int qt_lo, qt_hi;
  live_q_tiles(a, k0, &qt_lo, &qt_hi);
  const int nqt = qt_hi - qt_lo + 1;
  const int n_items = g * nqt;

  // item i: q-head kvh * g + i / nqt, q-tile qt_lo + i % nqt
  auto stage_item = [&](int i, int st) {
    const int h = kvh * g + i / nqt, q0 = (qt_lo + i % nqt) * kBQ;
    const long long qbase = (long long)b * a.S * ldq + (long long)h * D;
    const long long row = ((long long)b * a.nq + h) * a.S;
    T* dst = sQdO + 2 * st * TILE;
    stage_tile<D, T>(dst, reinterpret_cast<const T*>(a.q) + qbase, ldq, q0, a.S);
    stage_tile<D, T>(dst + TILE, reinterpret_cast<const T*>(a.dout) + qbase, ldq, q0, a.S);
    stage_stats(sLse + st * kBQ, a.lse + row, sDelta + st * kBQ, a.delta + row, q0, a.S);
  };
  stage_tile<D, T>(sK, reinterpret_cast<const T*>(a.k) + kbase, ldk, k0, a.S);
  stage_tile<D, T>(sV, reinterpret_cast<const T*>(a.v) + kbase, ldk, k0, a.S);
  if (n_items > 0) stage_item(0, 0);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    const int st = it & 1;
    if (it + 1 < n_items) stage_item(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const int h = kvh * g + it / nqt, q0 = (qt_lo + it % nqt) * kBQ;
    const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
    const bool full = tile_full(a, q0, k0);
    const T* sQ = sQdO + 2 * st * TILE;
    const T* sdO = sQ + TILE;
    const float* lse = sLse + st * kBQ;
    const float* delta = sDelta + st * kBQ;

    SplitFrags p;  // p^T, kept only as its split pair
    {
      float s[8][4];
      mma_abt<D, T>(s, sK + r0 * LDS, sQ, lane);  // s^T = k . q
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + r0 + lane / 4 + 8 * (e / 2);
          const int c = 8 * j + 2 * (lane % 4) + e % 2, qpos = q0 + c;
          float x = a.scale * s[j][e];
          if (a.slopes != nullptr) x += slope * (float)(kpos - qpos);
          s[j][e] = (full || visible(a, qpos, kpos)) ? exp2f((x - lse[c]) * kLog2e) : 0.f;
        }
      split_frags<T>(p, s);
    }
    mma_wm<D, T>(dv, p, sdO, lane);  // dv += p^T . dO
    SplitFrags ds;
    {
      float dp[8][4];
      mma_abt<D, T>(dp, sV + r0 * LDS, sdO, lane);  // dp^T = v . dO
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)  // ds^T = p^T (dp^T - delta)
          dp[j][e] = split_value<T>(p, j, e) * (dp[j][e] - delta[8 * j + 2 * (lane % 4) + e % 2]);
      split_frags<T>(ds, dp);
    }
    mma_wm<D, T>(dk, ds, sQ, lane);  // dk += ds^T . q
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  store_frags<D, T>(reinterpret_cast<T*>(a.dk) + kbase, ldk, k0 + r0, a.S, dk, a.scale, lane);
  store_frags<D, T>(reinterpret_cast<T*>(a.dv) + kbase, ldk, k0 + r0, a.S, dv, 1.f, lane);
}

enum Kind { kFwd = 0, kDkdv = 1, kDq = 2 };

__host__ __device__ inline size_t smem_bytes(int kind, int d) {
  if (kind == kFwd) return 3 * (size_t)64 * (d + 4) * sizeof(float);
  // six 16-bit [64][d + kPad] tiles (two resident, a two-stage ring of two),
  // then lse and delta (dk/dv: one pair per stage)
  const size_t tiles = 6 * (size_t)64 * (d + kPad) * 2;
  return tiles + (kind == kDkdv ? 4 : 2) * kBQ * sizeof(float);
}

template <int D, typename T>
cudaError_t launch(int kind, const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes(kind, D);
  void (*kern)(const Args);
  dim3 grid;
  if (kind == kFwd) {
    kern = flash_fwd_kernel<D, T>;
    grid = dim3((a.S + kBQ - 1) / kBQ, a.nq, a.B);
  } else if (kind == kDkdv) {
    kern = flash_bwd_dkdv_kernel<D, T>;
    grid = dim3(a.nkv, (a.S + kBK - 1) / kBK, a.B);
  } else {
    kern = flash_bwd_dq_kernel<D, T>;
    grid = dim3(a.nq, (a.S + kBQ - 1) / kBQ, a.B);
  }
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  if (kind != kFwd && grid.y > 65535) return cudaErrorInvalidValue;
  if (kind != kFwd) {  // two backward CTAs share an SM's shared memory
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kind == kFwd ? kThreads : kBwdThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(int kind, const Args& a, int d, int half, cudaStream_t stream) {
  if (a.S < 1 || a.B < 1 || a.nkv < 1 || a.nq % a.nkv != 0 || a.B > 65535 || a.nq > 65535)
    return cudaErrorInvalidValue;
  if (d == 128) return half ? launch<128, __half>(kind, a, stream)
                            : launch<128, __nv_bfloat16>(kind, a, stream);
  if (d == 64) return half ? launch<64, __half>(kind, a, stream)
                           : launch<64, __nv_bfloat16>(kind, a, stream);
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const float* slopes, int B, int S,
               int nq, int nkv, int d, int causal, int window) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.slopes = slopes;
  a.B = B;
  a.S = S;
  a.nq = nq;
  a.nkv = nkv;
  a.causal = causal;
  a.window = causal ? window : 0;
  a.scale = 1.0f / sqrtf((float)d);
  return a;
}

}  // namespace

extern "C" {

// out [B, S, nq, d] in q's dtype, lse [B, nq, S] fp32. half = 1 for fp16,
// 0 for bf16; window <= 0 is no window (and is ignored without causal).
int ds_flash_fwd(const void* q, const void* k, const void* v, const float* slopes, void* out,
                 float* lse, int B, int S, int nq, int nkv, int d, int causal, int window,
                 int half, void* stream) {
  Args a = make_args(q, k, v, slopes, B, S, nq, nkv, d, causal, window);
  a.out = out;
  a.lse = lse;
  return (int)dispatch(kFwd, a, d, half, (cudaStream_t)stream);
}

// dq [B, S, nq, d] in q's dtype and delta = rowsum(dO * O) [B, nq, S] fp32;
// runs before dk/dv, which reads that delta.
int ds_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                    const float* lse, const float* slopes, void* dq, float* delta, int B, int S,
                    int nq, int nkv, int d, int causal, int window, int half, void* stream) {
  Args a = make_args(q, k, v, slopes, B, S, nq, nkv, d, causal, window);
  a.o = o;
  a.dout = dout;
  a.lse = const_cast<float*>(lse);
  a.delta = delta;
  a.out = dq;
  return (int)dispatch(kDq, a, d, half, (cudaStream_t)stream);
}

// dk, dv [B, S, nkv, d] in k's dtype, each the sum over the kv head's group,
// from lse and ds_flash_bwd_dq's delta (the output itself is not read).
int ds_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const float* slopes, void* dk,
                      void* dv, int B, int S, int nq, int nkv, int d, int causal, int window,
                      int half, void* stream) {
  Args a = make_args(q, k, v, slopes, B, S, nq, nkv, d, causal, window);
  a.dout = dout;
  a.lse = const_cast<float*>(lse);
  a.delta = const_cast<float*>(delta);
  a.dk = dk;
  a.dv = dv;
  return (int)dispatch(kDkdv, a, d, half, (cudaStream_t)stream);
}

const char* ds_flash_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Dynamic shared memory of one CTA: kind 0 forward, 1 dk/dv, 2 dq.
long long ds_flash_smem_bytes(int kind, int d) { return (long long)smem_bytes(kind, d); }

}  // extern "C"
