// Paged (blocked) attention over a flat KV pool, for Hopper (sm_90a).
//
// Plain C interface (loaded with ctypes by ops/_build.py); every launcher
// returns the cudaError_t of its launch and never synchronises.
//
// What it replaces (deepspeed_tpu/ops/pallas/paged_attention.py):
//   ds_paged_decode, kv_splits == 1 -> _pallas_paged, the per-token grid (:258)
//   ds_paged_decode, kv_splits  > 1 -> _paged_kv_split, flash-decode split-K (:550);
//                                     the log-sum-exp merge stays torch ops, as in :700-703
//   ds_paged_prefill               -> _paged_q_tiled, the q-tiled grid (:394)
//
// Semantics copied from the TPU kernels: query token t of sequence seq_idx[t]
// at position pos[t] attends cached positions p with p <= pos[t] (and
// pos[t] - p < window); scores are fp32, masked scores are -1e30, the online
// softmax starts at m = -1e30, l = 0 and the output is acc / max(l, 1e-30).
// ALiBi adds slope[head] * (p - pos[t]). int8 pools are dequantised with the
// per-(kv-head, slot) fp32 scales. GQA: the g = nq / nkv query heads of one
// kv head share a CTA, so each KV slot is read once for all of them.
//
// What bounds it on the H100: decode reads every live KV byte once per
// (token, kv head) and does ~1 FLOP per byte, so it is bound by HBM bytes
// (3.35 TB/s); a prefill tile of q_tile tokens does ~4 q_tile g FLOPs per
// KV byte it reads, and its products are what the card must run fast.
//
// Decode (paged_attn_kernel, the first, simple version): a CTA stages one
// KV block (block_size x head_dim) in shared memory as fp32 with 16-byte
// vector loads, scores it against its query rows on the CUDA cores and
// keeps the online softmax in shared memory and the output accumulator in
// registers. The split-K grid gives a decode batch enough CTAs to keep the
// card's memory system busy.
//
// Prefill (paged_prefill_kernel) runs every product on the tensor cores
// with the helpers of mma_sm90.cuh, as the flash forward does:
// - A CTA is (one prefill tile, kv head), 128 threads. Its 64 rows are the
//   tile's tokens x the g query heads of the kv head (row r = token r / g,
//   head r % g), 16 rows per warp; each row carries its own position (its
//   token's), ALiBi slope (its head's) and validity, and rows past
//   tile_len x g are masked and never written. The wrapper's default tile
//   is 64 / g tokens, so the rows are full.
// - Q is gathered once into a resident 16-bit [64][D + 8] tile; K and V
//   are gathered through the block table, 64 slots per k-tile, into a
//   two-stage cp.async ring, so the next k-tile loads while this one
//   computes. A slot's address is tables[seq, p / bs] * bs + p % bs for
//   position p, with int64 offsets, so any block size works (a k-tile is
//   one block at 64, four at 16).
// - int8 pools: the int8 rows are copied as they are, then widened to bf16
//   in shared memory (exact: |x| <= 127 fits bf16's 8-bit significand),
//   with the fp32 per-slot scales staged beside them. k_scale multiplies
//   each score column after q . k and v_scale is folded into P before it is
//   split ((p vs) . v8 = p . (v8 vs)): they differ from the TPU kernel's
//   dequantise-then-dot only by fp32 rounding.
// - S = Q . K^T by mma from the 16-bit operands (exact products, fp32
//   sums), times sm_scale in fp32; then ALiBi, the causal and window masks
//   per element, skipped on k-tiles wholly visible to every row of the
//   tile. The online softmax runs in registers (each row's max and sum in
//   the quad of lanes that holds it), and P . V runs by mma with P as a
//   split hi + lo pair, each k-tile's product summed from zero and then
//   added to the rescaled accumulator (the tensor cores' fp32 accumulation
//   truncates).
// - The live block range and the TPU kernel's block predicate are kept
//   exactly: slots of blocks outside it never enter (p = 0), like slots
//   past the table.
// - The grid is heavy-first: kv head in blockIdx.x and the tile index
//   reversed in blockIdx.y, so the latest (heaviest) tiles of a causal
//   prefill are dispatched first; unused tiles (tile_len 0, the static
//   bound's tail) return at once.
//
// Offsets: a 7B pool holds ~8.6e9 elements per tensor, past INT32_MAX, so
// every slot x (nkv * head_dim) product is int64.

#include "mma_sm90.cuh"

namespace {

using namespace ds_mma;

constexpr int kThreads = 128;
constexpr int kKT = 64;  // prefill: KV slots per k-tile (and query rows per CTA)
constexpr float kMask = -1e30f;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(b[i]);
}

template <typename KV>
struct IsInt8 {
  static constexpr bool value = false;
};
template <>
struct IsInt8<int8_t> {
  static constexpr bool value = true;
};

struct Args {
  const __nv_bfloat16* q;     // [T, nq, D]
  const void* k;              // [pool_len, nkv, D] bf16 or int8
  const void* v;
  const float* k_scale;       // [nkv, scale_ld] (int8 pools only)
  const float* v_scale;
  long long scale_ld;
  const int* tables;          // [S, max_blocks], already offset to the layer
  const int* seq_idx;         // [T]
  const int* pos;             // [T]
  const float* alibi;         // [nq] or null
  __nv_bfloat16* out;         // [T, nq, D]
  float* part_acc;            // [splits, T, nq, D] (decode, splits > 1)
  float* part_m;              // [splits, T, nq]
  float* part_l;              // [splits, T, nq]
  const int* tile_start;      // [n_tiles] (prefill)
  const int* tile_len;
  const int* tile_seq;
  const int* tile_max;
  const int* tile_min;
  int T, nq, nkv, g, bs, max_blocks, window, kv_splits;
  float sm_scale;
};

__host__ __device__ inline size_t smem_floats(int rows, int d, int bs) {
  // q [rows][d] | k [bs][d+1] | v [bs][d] | s [rows][bs] | m, l, alpha, slope, pos [rows]
  return (size_t)rows * d + (size_t)bs * (d + 1) + (size_t)bs * d + (size_t)rows * bs +
         5 * (size_t)rows;
}

// ---------------------------------------------------------------------------
// decode: one CTA per (token, kv head, KV split), the rows (group head gi)
// of token tok0 against kv head `kvh`, over the KV blocks [j_begin, j_end)
// of its split that the block predicate keeps. RMAX bounds rows per CTA (g).
// ---------------------------------------------------------------------------
template <int D, typename KV, int RMAX>
__global__ void __launch_bounds__(kThreads) paged_attn_kernel(const Args a) {
  constexpr int RS = kThreads / D;        // row stride of a thread's accumulator rows
  constexpr int KMAX = RMAX / RS;         // accumulator rows per thread
  static_assert(kThreads % D == 0, "head_dim must divide the CTA");
  static_assert(RMAX % RS == 0, "RMAX must be a multiple of the row stride");

  const int kvh = blockIdx.y;
  const int tok0 = blockIdx.x;
  const int ntok = 1;
  const int seq = a.seq_idx[tok0];
  const int max_pos = a.pos[tok0], min_pos = max_pos;
  const int split = blockIdx.z;
  const int per = (a.max_blocks + a.kv_splits - 1) / a.kv_splits;
  const int j_begin = split * per;
  const int j_end = min(j_begin + per, a.max_blocks);
  const int g = a.g;
  const int R = ntok * g;
  const int bs = a.bs;
  const int D8 = D / 8;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + (size_t)R * D;
  float* sV = sK + (size_t)bs * (D + 1);
  float* sS = sV + (size_t)bs * D;
  float* sM = sS + (size_t)R * bs;
  float* sL = sM + R;
  float* sAlpha = sL + R;
  float* sSlope = sAlpha + R;
  int* sPos = reinterpret_cast<int*>(sSlope + R);

  const int tid = threadIdx.x;
  const long long row_stride = (long long)a.nkv * D;  // elements per pool slot
  const KV* kp = reinterpret_cast<const KV*>(a.k);
  const KV* vp = reinterpret_cast<const KV*>(a.v);

  for (int e = tid; e < R * D; e += kThreads) {
    const int r = e / D, dd = e % D;
    const int i = r / g, head = kvh * g + r % g;
    const long long qi = ((long long)(tok0 + i) * a.nq + head) * D + dd;
    sQ[e] = __bfloat162float(a.q[qi]) * a.sm_scale;
  }
  for (int r = tid; r < R; r += kThreads) {
    const int head = kvh * g + r % g;
    sM[r] = kMask;
    sL[r] = 0.f;
    sPos[r] = a.pos[tok0 + r / g];
    sSlope[r] = a.alibi != nullptr ? a.alibi[head] : 0.f;
  }

  float acc[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) acc[k] = 0.f;
  const int dcol = tid % D;
  const int r0 = tid / D;

  // live block range: blocks past the newest position never hold a visible
  // slot; with a window, blocks wholly below the oldest row's window neither
  const int j_hi = min(max_pos / bs, j_end - 1);
  int j_lo = j_begin;
  if (a.window > 0) {
    const int x = min_pos - a.window + 1;
    if (x > 0) j_lo = max(j_lo, x / bs);
  }
  __syncthreads();

  for (int j = j_lo; j <= j_hi; ++j) {
    // the TPU kernels' block predicate, kept exactly
    if (a.window > 0 && !((j + 1) * bs - 1 > min_pos - a.window)) continue;
    const long long slot0 = (long long)a.tables[(long long)seq * a.max_blocks + j] * bs;

    for (int c = tid; c < bs * D8; c += kThreads) {
      const int row = c / D8, c8 = (c % D8) * 8;
      const long long off = (slot0 + row) * row_stride + (long long)kvh * D + c8;
      float kf[8], vf[8];
      load8(kp + off, kf);
      load8(vp + off, vf);
      if constexpr (IsInt8<KV>::value) {
        const long long si = (long long)kvh * a.scale_ld + slot0 + row;
        const float ks = a.k_scale[si], vs = a.v_scale[si];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          kf[e] *= ks;
          vf[e] *= vs;
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sK[row * (D + 1) + c8 + e] = kf[e];
        sV[row * D + c8 + e] = vf[e];
      }
    }
    __syncthreads();

    // scores: one (row, slot) pair per thread at a time; K rows padded to
    // D + 1 floats so a warp's 32 slots hit 32 banks
    for (int e = tid; e < R * bs; e += kThreads) {
      const int r = e / bs, jj = e % bs;
      const float* qr = sQ + (size_t)r * D;
      const float* kr = sK + (size_t)jj * (D + 1);
      float s = 0.f;
#pragma unroll 16
      for (int dd = 0; dd < D; ++dd) s = fmaf(qr[dd], kr[dd], s);
      const int kpos = j * bs + jj;
      const int my = sPos[r];
      if (a.alibi != nullptr) s += sSlope[r] * (float)(kpos - my);
      bool vis = kpos <= my;
      if (a.window > 0) vis = vis && (my - kpos < a.window);
      sS[e] = vis ? s : kMask;
    }
    __syncthreads();

    // online softmax, one warp per row
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < R; r += kThreads / 32) {
      float* sr = sS + (size_t)r * bs;
      float mx = kMask;
      for (int jj = lane; jj < bs; jj += 32) mx = fmaxf(mx, sr[jj]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int jj = lane; jj < bs; jj += 32) {
        const float p = expf(sr[jj] - m_new);
        sr[jj] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sAlpha[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc[row] = acc[row] * alpha + P[row] . V ; a thread owns column dcol
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int r = r0 + k * RS;
      if (r < R) acc[k] *= sAlpha[r];
    }
    for (int jj = 0; jj < bs; ++jj) {
      const float vv = sV[jj * D + dcol];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const int r = r0 + k * RS;
        if (r < R) acc[k] = fmaf(sS[(size_t)r * bs + jj], vv, acc[k]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const int r = r0 + k * RS;
    if (r >= R) continue;
    const int i = r / g, head = kvh * g + r % g;
    const long long row = (long long)(tok0 + i) * a.nq + head;
    if (a.kv_splits == 1) {
      a.out[row * D + dcol] = __float2bfloat16(acc[k] / fmaxf(sL[r], 1e-30f));
    } else {
      // un-normalised partial and its softmax stats; the merge divides
      const long long prow = (long long)split * a.T * a.nq + row;
      a.part_acc[prow * D + dcol] = acc[k];
      if (dcol == 0) {
        a.part_m[prow] = sM[r];
        a.part_l[prow] = sL[r];
      }
    }
  }
}


// ---------------------------------------------------------------------------
// prefill: one CTA per (tile of <= 64 / g contiguous tokens of one sequence,
// kv head) on the tensor cores; heavy (late) tiles first
// ---------------------------------------------------------------------------
__host__ __device__ inline size_t prefill_smem_bytes(int d, int kv_int8) {
  // bf16 pools: Q and a two-stage ring of (K, V), five 16-bit [64][d + 8]
  // tiles; int8 pools: Q and the widened K and V tiles, a two-stage ring of
  // the int8 (K, V) rows [64][d] and of their (k, v) scales [64] fp32
  const size_t tile = (size_t)kKT * (d + kPad) * 2;
  if (!kv_int8) return 5 * tile;
  return 3 * tile + 2 * 2 * (size_t)kKT * d + 2 * 2 * kKT * sizeof(float);
}

template <int D, typename KV>
__global__ void __launch_bounds__(kThreads, 2) paged_prefill_kernel(const Args a) {
  constexpr int LDS = Tile16<D>::LDS, TILE = Tile16<D>::ELEMS;
  constexpr bool kInt8 = IsInt8<KV>::value;
  constexpr int CH = D * (int)sizeof(KV) / 16;  // 16-byte chunks of one pool row
  using T = __nv_bfloat16;
  const int kvh = blockIdx.x, tile = gridDim.y - 1 - blockIdx.y;
  const int ntok = a.tile_len[tile];
  if (ntok == 0) return;  // unused tile of the static bound
  const int tok0 = a.tile_start[tile], seq = a.tile_seq[tile];
  const int max_pos = a.tile_max[tile], min_pos = a.tile_min[tile];
  const int g = a.g, R = ntok * g, bs = a.bs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = 16 * warp;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  // bf16: stage s holds K at sKV + 2 s TILE and V after it; int8: sKV holds
  // the widened K and V, the int8 ring and the scales follow
  T* sKV = sQ + TILE;
  KV* sRaw = reinterpret_cast<KV*>(sKV + (kInt8 ? 2 : 4) * TILE);  // stage s: K, V [64][D]
  float* sScale = reinterpret_cast<float*>(sRaw + 2 * 2 * kKT * D);  // stage s: ks, vs [64]

  // live block range: blocks past the newest position never hold a visible
  // slot; with a window, blocks wholly below the oldest row's window neither
  const int j_hi = min(max_pos / bs, a.max_blocks - 1);
  int j_lo = 0;
  if (a.window > 0) {
    const int x = min_pos - a.window + 1;
    if (x > 0) j_lo = x / bs;
  }
  const int p_lo = j_lo * bs, p_hi = min((j_hi + 1) * bs, a.max_blocks * bs);
  // a slot enters only from a live block that the TPU kernels' block
  // predicate keeps (kept exactly; it holds for every block from j_lo on)
  auto live = [&](int p) {
    return p >= p_lo && p < p_hi &&
           (a.window <= 0 || (p / bs + 1) * bs - 1 > min_pos - a.window);
  };
  const int kt_lo = p_lo / kKT;
  const int n_kt = p_hi > p_lo ? (p_hi - 1) / kKT - kt_lo + 1 : 0;

  const long long row_stride = (long long)a.nkv * D;  // elements per pool slot
  const KV* kp = reinterpret_cast<const KV*>(a.k) + (long long)kvh * D;
  const KV* vp = reinterpret_cast<const KV*>(a.v) + (long long)kvh * D;
  const int* table = a.tables + (long long)seq * a.max_blocks;

  // the k-tile at position k0 into stage st (slots that do not enter are
  // zeros, their scales 0)
  auto stage_kv = [&](int k0, int st) {
    KV* dk;
    KV* dv;
    int ld;
    if constexpr (kInt8) {
      dk = sRaw + 2 * st * kKT * D;
      dv = dk + kKT * D;
      ld = D;
    } else {
      dk = reinterpret_cast<KV*>(sKV + 2 * st * TILE);
      dv = dk + TILE;
      ld = LDS;
    }
    for (int c = threadIdx.x; c < kKT * CH; c += kThreads) {
      const int r = c / CH, e0 = (c % CH) * (16 / (int)sizeof(KV)), p = k0 + r;
      const bool ok = live(p);
      const long long off = ok ? ((long long)table[p / bs] * bs + p % bs) * row_stride + e0 : 0;
      cp_async16(dk + r * ld + e0, kp + off, ok);
      cp_async16(dv + r * ld + e0, vp + off, ok);
    }
    if constexpr (kInt8) {  // threads 0-63 copy k scales, 64-127 v scales
      const int r = threadIdx.x % kKT, p = k0 + r;
      const bool ok = live(p);
      const long long si =
          (long long)kvh * a.scale_ld + (ok ? (long long)table[p / bs] * bs + p % bs : 0);
      const float* src = threadIdx.x < kKT ? a.k_scale : a.v_scale;
      cp_async4(sScale + (2 * st + threadIdx.x / kKT) * kKT + r, src + si, ok);
    }
  };

  // Q: row r is token tok0 + r / g, head kvh * g + r % g; rows past R zeros
  for (int c = threadIdx.x; c < kKT * (D / 8); c += kThreads) {
    const int r = c / (D / 8), c8 = (c % (D / 8)) * 8;
    const bool ok = r < R;
    const long long off =
        ok ? ((long long)(tok0 + r / g) * a.nq + kvh * g + r % g) * D + c8 : 0;
    cp_async16(sQ + r * LDS + c8, a.q + off, ok);
  }
  if (n_kt > 0) stage_kv(kt_lo * kKT, 0);
  cp_async_commit();

  // this thread's two rows (g + 8 i of the warp's 16): position, slope
  int rpos[2];
  float rslope[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + lane / 4 + 8 * i;
    rpos[i] = r < R ? a.pos[tok0 + r / g] : max_pos;
    rslope[i] = (r < R && a.alibi != nullptr) ? a.alibi[kvh * g + r % g] : 0.f;
  }
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1;
    const int k0 = (kt_lo + it) * kKT;
    if (it + 1 < n_kt) stage_kv(k0 + kKT, st ^ 1);  // the next k-tile into the other stage
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const T* sK = kInt8 ? sKV : sKV + 2 * st * TILE;
    const T* sV = sK + TILE;
    const float* ks = sScale + 2 * st * kKT;
    const float* vs = ks + kKT;
    if constexpr (kInt8) {  // widen this stage's int8 rows into sKV (exact)
      const KV* rk = sRaw + 2 * st * kKT * D;
      for (int c = threadIdx.x; c < 2 * kKT * (D / 16); c += kThreads) {
        const int t = c / (kKT * (D / 16)), cc = c % (kKT * (D / 16));
        const int r = cc / (D / 16), e0 = (cc % (D / 16)) * 16;
        const int4 raw = *reinterpret_cast<const int4*>(rk + t * kKT * D + r * D + e0);
        const int8_t* b8 = reinterpret_cast<const int8_t*>(&raw);
        unsigned w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          w[e] = pack2(__float2bfloat16((float)b8[2 * e]), __float2bfloat16((float)b8[2 * e + 1]));
        uint4* dst = reinterpret_cast<uint4*>(sKV + t * TILE + r * LDS + e0);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
    }
    // every slot enters and is visible to every row of the tile: no
    // per-element mask
    const bool full = k0 >= p_lo && k0 + kKT <= p_hi && k0 + kKT - 1 <= min_pos &&
                      (a.window <= 0 || max_pos - k0 < a.window);
    if (r0 < R) {  // a warp whose rows are all past the tile's skips the products
      float s[8][4];
      mma_abt<D, T>(s, sQ + r0 * LDS, sK, lane);  // q . k
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * (lane % 4) + e, p = k0 + c;
            float x = s[j][2 * i + e];
            if constexpr (kInt8) x *= ks[c];
            x *= a.sm_scale;
            if (a.alibi != nullptr) x += rslope[i] * (float)(p - rpos[i]);
            if (!full && !(p <= rpos[i] && (a.window <= 0 || rpos[i] - p < a.window))) x = kMask;
            s[j][2 * i + e] = x;
          }
        // a slot outside the live blocks never enters: it is not visited
        const float alpha = online_softmax_row(s, i, m[i], l[i], [&](int j, int e) {
          return full || live(k0 + 8 * j + 2 * (lane % 4) + e);
        });
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[n][2 * i] *= alpha;
          acc[n][2 * i + 1] *= alpha;
        }
        if constexpr (kInt8) {  // v_scale folded into p before the split
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) s[j][2 * i + e] *= vs[8 * j + 2 * (lane % 4) + e];
        }
      }
      SplitFrags pf;
      split_frags<T>(pf, s);
      mma_wm<D, T>(acc, pf, sV, lane);  // acc += p . v
    }
    __syncthreads();  // this stage's (and the widened tiles') readers are done
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_safe = fmaxf(quad_sum(l[i]), 1e-30f);
    const int r = r0 + lane / 4 + 8 * i;
    if (r >= R) continue;
    T* dst = a.out + ((long long)(tok0 + r / g) * a.nq + kvh * g + r % g) * D + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<unsigned*>(dst + 8 * n) =
          pack2(__float2bfloat16(acc[n][2 * i] / l_safe), __float2bfloat16(acc[n][2 * i + 1] / l_safe));
  }
}

template <int D, typename KV, int RMAX>
cudaError_t launch_decode(const Args& a, dim3 grid, int rows, cudaStream_t stream) {
  const size_t bytes = smem_floats(rows, D, a.bs) * sizeof(float);
  auto kern = paged_attn_kernel<D, KV, RMAX>;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int D, typename KV>
cudaError_t launch_prefill(const Args& a, dim3 grid, cudaStream_t stream) {
  const size_t bytes = prefill_smem_bytes(D, IsInt8<KV>::value);
  auto kern = paged_prefill_kernel<D, KV>;
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

Args base_args(const void* q, const void* k, const void* v, const float* k_scale,
               const float* v_scale, long long scale_ld, const int* tables, const int* pos,
               const float* alibi, void* out, int T, int nq, int nkv, int d, int bs,
               int max_blocks, int window) {
  Args a{};
  a.q = reinterpret_cast<const __nv_bfloat16*>(q);
  a.k = k;
  a.v = v;
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.scale_ld = scale_ld;
  a.tables = tables;
  a.pos = pos;
  a.alibi = alibi;
  a.out = reinterpret_cast<__nv_bfloat16*>(out);
  a.T = T;
  a.nq = nq;
  a.nkv = nkv;
  a.g = nq / nkv;
  a.bs = bs;
  a.max_blocks = max_blocks;
  a.window = window;
  a.kv_splits = 1;
  a.sm_scale = 1.0f / sqrtf((float)d);
  return a;
}

}  // namespace

extern "C" {

// Decode grid (T, nkv, kv_splits): one CTA per (token, kv head, split).
// kv_splits == 1 writes `out`; kv_splits > 1 writes the fp32 partials.
int ds_paged_decode(const void* q, const void* k, const void* v, const float* k_scale,
                    const float* v_scale, long long scale_ld, const int* tables,
                    const int* seq_idx, const int* pos, const float* alibi, void* out,
                    float* part_acc, float* part_m, float* part_l, int T, int nq, int nkv, int d,
                    int bs, int max_blocks, int window, int kv_splits, int kv_int8,
                    void* stream) {
  Args a = base_args(q, k, v, k_scale, v_scale, scale_ld, tables, pos, alibi, out, T, nq, nkv,
                     d, bs, max_blocks, window);
  a.seq_idx = seq_idx;
  a.kv_splits = kv_splits;
  a.part_acc = part_acc;
  a.part_m = part_m;
  a.part_l = part_l;
  if (a.g > 8 || nq % nkv != 0 || kv_splits < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(T, nkv, kv_splits);
  const cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return (int)(kv_int8 ? launch_decode<128, int8_t, 8>(a, grid, a.g, s)
                         : launch_decode<128, __nv_bfloat16, 8>(a, grid, a.g, s));
  if (d == 64)
    return (int)(kv_int8 ? launch_decode<64, int8_t, 8>(a, grid, a.g, s)
                         : launch_decode<64, __nv_bfloat16, 8>(a, grid, a.g, s));
  return (int)cudaErrorInvalidValue;
}

// Prefill grid (nkv, n_tiles): one CTA per (kv head, tile of <= q_tile
// contiguous tokens of one sequence, q_tile * g <= 64), the tiles in reverse;
// reads q and writes out in token order.
int ds_paged_prefill(const void* q, const void* k, const void* v, const float* k_scale,
                     const float* v_scale, long long scale_ld, const int* tables, const int* pos,
                     const int* tile_start, const int* tile_len, const int* tile_seq,
                     const int* tile_max, const int* tile_min, const float* alibi, void* out,
                     int n_tiles, int T, int nq, int nkv, int d, int bs, int max_blocks,
                     int window, int q_tile, int kv_int8, void* stream) {
  Args a = base_args(q, k, v, k_scale, v_scale, scale_ld, tables, pos, alibi, out, T, nq, nkv,
                     d, bs, max_blocks, window);
  a.tile_start = tile_start;
  a.tile_len = tile_len;
  a.tile_seq = tile_seq;
  a.tile_max = tile_max;
  a.tile_min = tile_min;
  if (q_tile * a.g > kKT || nq % nkv != 0 || q_tile < 1 || n_tiles < 1 || n_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nkv, n_tiles, 1);
  const cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return (int)(kv_int8 ? launch_prefill<128, int8_t>(a, grid, s)
                         : launch_prefill<128, __nv_bfloat16>(a, grid, s));
  if (d == 64)
    return (int)(kv_int8 ? launch_prefill<64, int8_t>(a, grid, s)
                         : launch_prefill<64, __nv_bfloat16>(a, grid, s));
  return (int)cudaErrorInvalidValue;
}

const char* ds_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Dynamic shared memory one decode CTA requests for `rows` (= g) query rows
// at this head_dim and block size.
long long ds_paged_smem_bytes(int rows, int d, int bs) {
  return (long long)(smem_floats(rows, d, bs) * sizeof(float));
}

// Dynamic shared memory of one prefill CTA at this head_dim, for bf16
// (kv_int8 = 0) or int8 pools; it does not depend on the block size.
long long ds_paged_prefill_smem_bytes(int d, int kv_int8) {
  return (long long)prefill_smem_bytes(d, kv_int8);
}

}  // extern "C"
