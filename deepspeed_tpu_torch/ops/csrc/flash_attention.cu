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
// with no transposes. Scores are s = scale * (q . k) in fp32 (the products
// take the unscaled 16-bit inputs, so no rounded, pre-scaled q enters
// them). Forward: masked scores are -1e30, the online softmax starts at
// m = -1e30, l = 0, and the output is acc / max(l, 1e-30) with
// lse = m + log(max(l, 1e-30)) (:318); a masked real key enters with weight
// exp(-1e30 - m), a key past S never enters. Backward: p = exp(s - lse),
// dp = dO.v, delta = rowsum(dO * O) from the stored output,
// ds = p * (dp - delta); dv = sum p^T dO, dk = scale * sum ds^T q,
// dq = scale * sum ds k. ALiBi adds slope[head] * (k_pos - q_pos) before
// the mask; causal keeps k <= q and a window keeps q - k < window. Tiles
// that hold no visible position are not visited (the TPU kernels' pl.when
// predicates and kv_index clamps become loop bounds). Ragged S: positions
// past S are masked inside the kernels (zero-loaded tiles, p = 0), so any
// length works.
//
// What bounds it on the H100: at the training shapes (S 4096, d 128) every
// kernel does ~64 FLOPs per byte it must move, so the bound is the tensor
// cores' 989 TFLOP/s. All three kernels run every product on them:
// mma.sync m16n8k16 with bf16 / fp16 operands and fp32 accumulators,
// operands loaded with ldmatrix from shared tiles filled by a two-stage
// cp.async ring (the helpers of mma_sm90.cuh). mma.sync rather than wgmma
// because P and dS must feed the next product straight from registers in a
// per-warp layout that is written out in the PTX ISA (the FA2 layout), and
// a warp that owns its 16 rows masks and exponentiates its own fragments
// with no warpgroup-wide barrier; the tensor cores run mma.sync at well
// below their wgmma rate, which is the next step against the bound.
// - q . k^T and dO . v^T take their operands straight from the inputs:
//   exact products, fp32 sums, as in the JAX kernel. p and ds are fp32 there;
//   here each is fed to the tensor cores as a split pair hi + lo of the
//   16-bit type (two products into one accumulator, ~16 significant bits
//   for bf16), because a single rounding costs ~2^-9 relative per term.
//   The forward does 3 tile products per (q-tile, k-tile) pair (S, and
//   P . V as a split pair), dk/dv 6, dq 4.
// - The tensor cores' fp32 accumulation truncates. A dv accumulator of an
//   early key fed ~2,000 mma steps drifted several bf16 ulps from the plain
//   version (to the edge of chip_smoke.py's tolerance), so every output
//   product sums one tile pair's mma steps from zero and adds that to the
//   long-run accumulator with a rounded fp32 add (the forward after
//   rescaling it by the online softmax's alpha).
// - The forward keeps the online softmax in registers: each row's running
//   max and sum live in the 4 lanes of a quad that hold its C fragments,
//   reduced with two shuffles; P never goes through shared memory.
// - dq runs first: its CTA holds a q-tile's dO, and reads the matching O
//   once to write delta [B, nq, S] fp32 beside lse. dk/dv reads lse and
//   delta and never loads O.
// - dk/dv's warps own keys: it computes S^T = K . Q^T, so P^T and dS^T are
//   already the A fragments of dv += P^T dO and dk += dS^T Q; dq computes
//   S = Q . K^T and feeds dS to dq += dS K the same way, and the forward P
//   to out += P V.
// - 128 threads and ~87 KB (forward: Q resident, (K, V) streaming) or
//   ~103 KB (backward: two resident 16-bit [64][D + 8] tiles and a
//   two-stage ring of two: K, V resident with (Q, dO) streaming in dk/dv;
//   Q, dO resident with (K, V) streaming in dq) of shared memory per CTA
//   let two CTAs share an SM. No atomics: each output row is summed by one
//   warp in a fixed order, so results do not depend on scheduling.
// - Grid order is heavy-first across the whole grid: blockIdx.y is dk/dv's
//   key tile (early keys see the most queries) and the forward's and dq's
//   reversed q-tile (late queries see the most keys), blockIdx.x the head,
//   so every head's heaviest CTAs are dispatched first (with the tile in x,
//   a late head's heaviest CTA starts hundreds of CTAs in and sets the
//   tail; chip_smoke.py --ablation's grid_per_head and fwd_grid_per_head
//   measure it).
// - The per-element mask runs only on tiles that cross the causal / window
//   band or S; p = exp2((x - m) log2 e).
//
// Offsets are int64 throughout.

#include "mma_sm90.cuh"

namespace {

using namespace ds_mma;

constexpr int kThreads = kTileThreads;  // 4 warps x 16 rows of a 64-row tile
constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // key rows per tile
constexpr float kMask = -1e30f;

template <typename T>
__device__ __forceinline__ void load8(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = to_f(h[i]);
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

// every (query, key) of the q-tile at q0 and the k-tile at k0 is visible
// (no position past S, wholly inside the causal / window band): the
// per-element mask is skipped
__device__ __forceinline__ bool tile_full(const Args& a, int q0, int k0) {
  if (q0 + kBQ > a.S || k0 + kBK > a.S) return false;
  if (!a.causal) return true;
  return k0 + kBK - 1 <= q0 && (a.window <= 0 || q0 + kBQ - 1 - k0 < a.window);
}

// ---------------------------------------------------------------------------
// forward: one CTA per (q-head, q-tile, batch), heavy (late) q-tiles first
// across the whole grid; Q stays resident, K and V stream through a
// two-stage cp.async ring. S = Q . K^T, then the online softmax in
// registers, then out = out * alpha + P . V with P as a split pair.
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(const Args a) {
  constexpr int LDS = Tile16<D>::LDS, TILE = Tile16<D>::ELEMS;
  const int h = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.nq / a.nkv);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = 16 * warp;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sKV = sQ + TILE;  // stage s: K at sKV + 2 s TILE, V after it

  const long long ldq = (long long)a.nq * D, ldk = (long long)a.nkv * D;
  const long long qbase = (long long)b * a.S * ldq + (long long)h * D;
  const long long kbase = (long long)b * a.S * ldk + (long long)kvh * D;
  const T* kp = reinterpret_cast<const T*>(a.k) + kbase;
  const T* vp = reinterpret_cast<const T*>(a.v) + kbase;
  int kt_lo, kt_hi;
  live_k_tiles(a, q0, &kt_lo, &kt_hi);
  const int n_kt = kt_hi - kt_lo + 1;

  stage_tile<D, T>(sQ, reinterpret_cast<const T*>(a.q) + qbase, ldq, q0, a.S);
  if (n_kt > 0) {
    stage_tile<D, T>(sKV, kp, ldk, kt_lo * kBK, a.S);
    stage_tile<D, T>(sKV + TILE, vp, ldk, kt_lo * kBK, a.S);
  }
  cp_async_commit();

  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1;
    if (it + 1 < n_kt) {  // the next k-tile into the other stage
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
    float s[8][4];
    mma_abt<D, T>(s, sQ + r0 * LDS, sK, lane);  // q . k
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = q0 + r0 + lane / 4 + 8 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * j + 2 * (lane % 4) + e;
          float x = a.scale * s[j][2 * i + e];
          if (a.slopes != nullptr) x += slope * (float)(kpos - qpos);
          s[j][2 * i + e] = (full || visible(a, qpos, kpos)) ? x : kMask;
        }
      // a key past S never enters: it is not a position
      const float alpha = online_softmax_row(s, i, m[i], l[i], [&](int j, int e) {
        return full || k0 + 8 * j + 2 * (lane % 4) + e < a.S;
      });
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * i] *= alpha;
        acc[n][2 * i + 1] *= alpha;
      }
    }
    SplitFrags p;
    split_frags<T>(p, s);
    mma_wm<D, T>(acc, p, sV, lane);  // acc += p . v
    __syncthreads();  // this stage's readers are done before it is refilled
  }

  float* lse = a.lse + ((long long)b * a.nq + h) * a.S;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_safe = fmaxf(quad_sum(l[i]), 1e-30f);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][2 * i] /= l_safe;
      acc[n][2 * i + 1] /= l_safe;
    }
    const int qpos = q0 + r0 + lane / 4 + 8 * i;
    if (lane % 4 == 0 && qpos < a.S) lse[qpos] = m[i] + logf(l_safe);
  }
  store_frags<D, T>(reinterpret_cast<T*>(a.out) + qbase, ldq, q0 + r0, a.S, acc, 1.f, lane);
}

// ---------------------------------------------------------------------------
// dq (runs first): one CTA per (q-tile, q-head, batch), heavy (late) q-tiles
// first; Q and dO stay resident, K and V stream through a two-stage
// cp.async ring. It also writes delta = rowsum(dO * O) for dk/dv.
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dq_kernel(const Args a) {
  constexpr int LDS = Tile16<D>::LDS, TILE = Tile16<D>::ELEMS;
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
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dkdv_kernel(const Args a) {
  constexpr int LDS = Tile16<D>::LDS, TILE = Tile16<D>::ELEMS;
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
  // 16-bit [64][d + kPad] tiles: the forward's Q and a two-stage ring of
  // (K, V); the backward's two resident tiles and a two-stage ring of two,
  // then its lse and delta (dk/dv: one pair per stage)
  const size_t tile = (size_t)64 * (d + kPad) * 2;
  if (kind == kFwd) return 5 * tile;
  return 6 * tile + (kind == kDkdv ? 4 : 2) * kBQ * sizeof(float);
}

template <int D, typename T>
cudaError_t launch(int kind, const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes(kind, D);
  void (*kern)(const Args);
  dim3 grid;
  if (kind == kFwd) {
    kern = flash_fwd_kernel<D, T>;
    grid = dim3(a.nq, (a.S - 1) / kBQ + 1, a.B);
  } else if (kind == kDkdv) {
    kern = flash_bwd_dkdv_kernel<D, T>;
    grid = dim3(a.nkv, (a.S + kBK - 1) / kBK, a.B);
  } else {
    kern = flash_bwd_dq_kernel<D, T>;
    grid = dim3(a.nq, (a.S + kBQ - 1) / kBQ, a.B);
  }
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  // two CTAs share an SM's shared memory
  e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, bytes, stream>>>(a);
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
