// Paged (blocked) attention over a flat KV pool, for Hopper (sm_90a).
//
// Plain C interface (loaded with ctypes by ops/_build.py); every launcher
// returns the cudaError_t of its launch and never synchronises.
//
// What it replaces (deepspeed_tpu/ops/pallas/paged_attention.py):
//   ds_paged_decode, kv_splits == 1 -> _pallas_paged, the per-token grid (:258)
//   ds_paged_decode, kv_splits  > 1 -> _paged_kv_split, flash-decode split-K (:550),
//                                     with its log-sum-exp merge (:700-703) as a
//                                     second kernel launched by the same call
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
// (token, kv head) and does ~g FLOPs per byte, so it is bound by HBM bytes
// (3.35 TB/s); a prefill tile of q_tile tokens does ~4 q_tile g FLOPs per
// KV byte it reads, and its products are what the card must run fast.
//
// Head dims 64, 80, 96, 128 and 256 (multiples of 16: the mma's depth and
// ldmatrix's 8-column steps; 80 and 96 are not multiples of 32 or 64, so
// every loop over a row's 16-byte chunks or 32-dim fragment pairs has a
// tail), and any group size g = nq / nkv.
//
// Decode (paged_decode_kernel): a CTA is (token, kv head, head tile,
// split), 4 warps; a head tile is <= 8 of the kv head's g query heads, so
// g <= 8 is one tile and Falcon-7B's 71 is nine, the last holding 7. The
// head tiles of one (token, kv head), then the kv heads of a token, are
// side by side in the grid.
// - Bytes in flight. Each warp owns 16 slots of every 64-position step and
//   streams them through its own two-stage cp.async ring, 16 B a thread,
//   each copy instruction taking whole pool rows (16-row instructions of
//   32 B a row ran 36% slower), kept 16-bit in shared memory (int8 pools:
//   the int8 rows and their fp32 scales as they are, widened to bf16 by the
//   warp, exactly, by an integer path: the conversion instructions run at
//   a quarter of the ALU rate). While a warp scores one step its next is in
//   flight: 8 KB a warp at d 128, 32 KB a CTA, and ~70 KB of shared memory
//   a CTA lets 3 CTAs share an SM, ~96 KB in flight against the ~25 KB an
//   SM that Little's law asks of 3.35 TB/s at ~1 us. No CTA barrier inside
//   the loop: each warp keeps its own online softmax, and the four warps'
//   states are merged once at the end, in warp order.
// - The products run on the tensor cores, transposed so that a head tile's
//   <= 8 query heads are the n = 8 side of mma.m16n8k16: S^T = K . Q^T (K
//   by ldmatrix, Q's B fragments held in registers; at d 80 the last 16
//   dims by an x2 ldmatrix), the softmax per head column (over the 8 lanes
//   that share it), then O^T += V^T . P^T with V^T by ldmatrix.trans and
//   P^T moved from C into B fragments by movmatrix, as a split hi + lo pair
//   summed from zero per step (as the prefill's P).
//   More heads a CTA would hold 8 x D / 16 x 4 more fp32 accumulators a
//   thread per tile (nine tiles at g 71: 576 at d 128), so the tiles are
//   CTAs: they re-read the same pool rows, adjacent in the grid so that
//   the second read comes from L2.
// - Shared memory: Q's 8 rows and each warp's ring (DecodeSmem); at d 256
//   139,392 B (bf16 pools), one CTA an SM with 64 KB of each CTA's rows in
//   flight, above the ~25 KB an SM that Little's law asks at 3.35 TB/s; the
//   ring stays two stages deep at every head dim.
// - The split runs over the live range, not the table's capacity: split s
//   of a token takes blocks [j_lo + s n / splits, j_lo + (s + 1) n /
//   splits) of its n live blocks [j_lo, j_hi] (for one token, exactly the
//   blocks the TPU kernel's block predicate keeps). The TPU grid gives
//   split s the blocks [s per, (s + 1) per), per = ceil(max_blocks /
//   splits): there an idle grid step moves no HBM bytes, but here a context
//   shorter than the table lands in the first splits' CTAs (2 live blocks
//   of 32 in one CTA of 8) and runs as one chain, where the live-range
//   split spreads it. (At a half-full table the capacity split's fewer,
//   longer CTAs measured 3% faster.) The merged result differs from the TPU
//   kernel's only by fp32 association, which its docstring allows. A split
//   with no live block writes m = -1e30, l = 0, acc = 0 and returns.
// - The merge (kv_splits > 1) is a second small kernel launched by the
//   same C call: a thread per (token, head, 4 dims) reads the partials in
//   split order, 8 splits' loads in flight at once, m* = max m, w = exp(m -
//   m*), out = sum w acc / max(sum w l, 1e-30). No atomics: the order of
//   every sum is fixed.
//
// Prefill (paged_prefill_kernel) runs every product on the tensor cores
// with the helpers of mma_sm90.cuh, as the flash forward does:
// - A CTA is (one prefill tile, kv head, row chunk), 128 threads (256 at d
//   256, below). A tile's rows are its tokens x the g query heads of the kv
//   head (row r = token r / g, head r % g), cut into chunks of 64, one CTA
//   each, 16 rows per warp; each row carries its own position (its
//   token's), ALiBi slope (its head's) and validity, and rows past tile_len
//   x g are masked and never written. The wrapper's default tile is 64 / g tokens for g <= 64 (one
//   chunk, full), 8 tokens above (g 71: 568 rows, eight full chunks and one
//   of 56); every chunk of a tile reads the tile's live KV range.
// - Q is gathered once into a resident 16-bit [64][D + 8] tile; K and V
//   are gathered through the block table, 64 slots per k-tile, into a
//   two-stage cp.async ring, so the next k-tile loads while this one
//   computes. At d 256 a warp's 16 x 256 fp32 accumulators would take 128
//   registers a thread, and beside them the scores and split probabilities
//   spilled ~0.5 KB a thread at the 255-register cap (with 64- or 32-slot
//   k-tiles alike): there the CTA has 8 warps, warps w and w + 4 sharing
//   rows 16 (w % 4) .. + 15, each computing their scores and softmax (the
//   same, in the same order) and accumulating 128 of the output dims (64
//   registers), one CTA an SM (168,960 B of shared memory). A slot's
//   address is tables[seq, p / bs] * bs + p % bs for position p, with
//   int64 offsets, so any block size works (a k-tile is one block at 64,
//   four at 16).
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

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

using namespace ds_mma;

constexpr int kThreads = 128;
constexpr int kKT = 64;  // prefill: KV slots per k-tile (and query rows per CTA)

// prefill at head dim d: the warps that share each 16-row block, each
// accumulating d / that many of its output dims (2 at d 256: a warp's 16 x
// 256 fp32 accumulators would take 128 registers a thread, and beside them
// a k-tile's scores and probabilities spilled ~0.5 KB a thread at the
// 255-register cap)
__host__ __device__ constexpr int prefill_dsplit(int d) { return d > 128 ? 2 : 1; }
constexpr float kMask = -1e30f;

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
  float* part_acc;            // [splits, T, nq, D] (decode partials, or null: write out)
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

// ---------------------------------------------------------------------------
// decode: one CTA per (token, kv head, split); warp w takes positions
// 16 w .. 16 w + 15 of every 64-position step of the split's blocks
// ---------------------------------------------------------------------------
constexpr int kDecWarps = kThreads / 32;
constexpr int kDecSlots = 16;                      // slots a warp takes per step
constexpr int kDecStep = kDecWarps * kDecSlots;    // positions a CTA takes per step
constexpr int kDecStages = 2;                      // each warp's ring

// Shared memory of one decode CTA: Q's 8 head rows [8][D + 8] bf16, then per
// warp a ring of kDecStages. bf16 pools: stage s holds K and V [16][D + 8].
// int8 pools: stage s holds the int8 K and V rows [16][D] and their (k, v)
// scales [16] fp32, then the warp's widened K and V [16][D + 8] bf16. The
// epilogue reuses the rings for the warps' states: acc [4][8][D + 4] fp32,
// then m and l [4][8].
template <int D, bool kInt8>
struct DecodeSmem {
  static constexpr int LDS = D + kPad;
  static constexpr size_t kQ = 8 * LDS * 2;
  static constexpr size_t kWide = 2 * kDecSlots * LDS * 2;             // a K + V pair, 16-bit
  static constexpr size_t kRaw = kDecStages * 2 * kDecSlots * D;       // the int8 K + V stages
  static constexpr size_t kScales = kDecStages * 2 * kDecSlots * 4;    // their (k, v) scales
  static constexpr size_t kWarp = kInt8 ? kRaw + kScales + kWide : kDecStages * kWide;
  static constexpr size_t kBytes = kQ + kDecWarps * kWarp;
  static constexpr int kAccLd = D + 4;  // 8 (tq) x (D + 4) floats apart: no bank conflict
  static_assert((size_t)(kDecWarps * 8 * kAccLd + 2 * kDecWarps * 8) * 4 <= kDecWarps * kWarp,
                "the epilogue must fit in the rings");
};

// 8 x 8 b16 matrix in a warp's fragments (row lane / 4, columns 2 (lane % 4)
// and + 1), transposed in place across the warp
__device__ __forceinline__ unsigned movmatrix_t(unsigned x) {
  unsigned y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// two 8 x 8 b16 matrices (rows from lanes 0-7 and 8-15) into b[0], b[1]
__device__ __forceinline__ void ldsm2(unsigned (&b)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(smem_u32(p)));
}

// 16 int8 values (one 16-byte chunk) as 16 bf16, packed in pairs, exactly
// and without the conversion instructions (a quarter of the ALU rate): the
// fp32 with bits 0x4B000000 | (x ^ 0x80) is 2^23 + 128 + x, so one add
// gives x, and an integer |x| <= 128 has zeros in its low 16 fp32 bits, so
// its top 16 bits are its bf16
__device__ __forceinline__ void widen16(const int4& raw, unsigned (&w)[8]) {
  const unsigned* r = reinterpret_cast<const unsigned*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned u = r[q] ^ 0x80808080u;
    unsigned f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[k] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | k)) - 8388736.f);
    w[2 * q] = __byte_perm(f[0], f[1], 0x7632);
    w[2 * q + 1] = __byte_perm(f[2], f[3], 0x7632);
  }
}

template <int D, typename KV>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(const Args a) {
  using T = __nv_bfloat16;
  constexpr bool kInt8 = IsInt8<KV>::value;
  using L = DecodeSmem<D, kInt8>;
  constexpr int LDS = L::LDS;
  constexpr int CH = D * (int)sizeof(KV) / 16;  // 16-byte chunks of one pool row
  // the head tiles of one (token, kv head) side by side in the grid, then
  // the kv heads of one token: their CTAs read the same pool rows (or
  // their neighbouring 256-byte pieces) together
  const int n_ht = (a.g + 7) / 8;
  const int ht = blockIdx.x % n_ht, kvt = blockIdx.x / n_ht, split = blockIdx.y;
  const int kvh = kvt % a.nkv, tok = kvt / a.nkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int head0 = kvh * a.g + 8 * ht;  // this tile's first query head
  const int g = min(8, a.g - 8 * ht), bs = a.bs;  // g: this tile's query heads
  const int seq = a.seq_idx[tok], P = a.pos[tok];
  const long long row0 = (long long)tok * a.nq + head0;
  const bool partial = a.part_acc != nullptr;
  const long long prow0 = (long long)split * a.T * a.nq + row0;  // its partials' row

  // the live blocks [j_lo, j_hi]: blocks past the token's position never
  // hold a visible slot, and with a window neither do blocks wholly below
  // it; for one token this is exactly the TPU kernel's block predicate
  const int j_hi = P >= 0 ? min(P / bs, a.max_blocks - 1) : -1;
  const int j_lo = (a.window > 0 && P - a.window + 1 > 0) ? (P - a.window + 1) / bs : 0;
  const int n_live = max(j_hi - j_lo + 1, 0);
  // this split's share of them, whole blocks [b0, b1)
  const int b0 = j_lo + (int)((long long)split * n_live / a.kv_splits);
  const int b1 = j_lo + (int)((long long)(split + 1) * n_live / a.kv_splits);
  const int p_lo = b0 * bs, p_hi = b1 * bs;  // the positions that enter
  if (p_hi <= p_lo) {  // no live block: zeros, m = -1e30, l = 0
    for (int e = threadIdx.x; e < g * D; e += kThreads) {
      if (partial) a.part_acc[prow0 * D + e] = 0.f;
      else a.out[row0 * D + e] = __float2bfloat16(0.f);
    }
    if (partial && threadIdx.x < g) {
      a.part_m[prow0 + threadIdx.x] = kMask;
      a.part_l[prow0 + threadIdx.x] = 0.f;
    }
    return;
  }
  const int n_steps = (p_hi - p_lo + kDecStep - 1) / kDecStep;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  unsigned char* ring = smem_raw + L::kQ + warp * L::kWarp;
  const long long row_stride = (long long)a.nkv * D;  // elements per pool slot
  const KV* kp = reinterpret_cast<const KV*>(a.k) + (long long)kvh * D;
  const KV* vp = reinterpret_cast<const KV*>(a.v) + (long long)kvh * D;
  const int* table = a.tables + (long long)seq * a.max_blocks;
  auto slot_of = [&](int p) { return (long long)table[p / bs] * bs + p % bs; };

  // step `it` of this warp (positions p_lo + 64 it + 16 warp + 0..15) into
  // stage st: lane j % 16 looks up slot j's pool row, and the warp's copy
  // instructions walk the step's 16 x CH 16-byte chunks in order, chunk c
  // (row c / CH) on lane c % 32, so each instruction takes whole rows where
  // CH divides 32 (d 64, 128, 256) and rows and parts of rows at d 80 / 96;
  // the last instruction is predicated per lane where 32 does not divide
  // 16 CH; slots that do not enter are zeros (scales 0)
  auto stage = [&](int it, int st) {
    constexpr int kChunks = kDecSlots * CH;
    const int pb = p_lo + it * kDecStep + warp * kDecSlots;
    const bool ok_me = pb + lane % kDecSlots < p_hi;
    const long long slot_me = ok_me ? slot_of(pb + lane % kDecSlots) : 0;
    KV* dk = reinterpret_cast<KV*>(ring) + st * (kInt8 ? 2 * kDecSlots * D : 2 * kDecSlots * LDS);
    constexpr int ld = kInt8 ? D : LDS;
    KV* dv = dk + kDecSlots * ld;
#pragma unroll
    for (int i = 0; i < (kChunks + 31) / 32; ++i) {
      const int c = min(i * 32 + lane, kChunks - 1);
      const int r = c / CH, e0 = (c % CH) * (16 / (int)sizeof(KV));
      const long long off = __shfl_sync(0xffffffffu, slot_me, r) * row_stride;
      if (i * 32 + lane < kChunks) {
        cp_async16(dk + r * ld + e0, kp + off + e0, pb + r < p_hi);
        cp_async16(dv + r * ld + e0, vp + off + e0, pb + r < p_hi);
      }
    }
    if constexpr (kInt8) {  // lanes 0-15: k scales, 16-31: v scales
      const long long si = (long long)kvh * a.scale_ld + slot_me;
      float* dst =
          reinterpret_cast<float*>(ring + L::kRaw) + (2 * st + lane / kDecSlots) * kDecSlots;
      cp_async4(dst + lane % kDecSlots, (lane < kDecSlots ? a.k_scale : a.v_scale) + si, ok_me);
    }
  };

  // Q's rows: head head0 + r, rows past this tile's g zeros
  for (int c = threadIdx.x; c < 8 * (D / 8); c += kThreads) {
    const int r = c / (D / 8), c8 = (c % (D / 8)) * 8;
    const bool ok = r < g;
    cp_async16(sQ + r * LDS + c8, a.q + (ok ? (row0 + r) * D + c8 : 0), ok);
  }
  cp_async_commit();
#pragma unroll
  for (int it = 0; it < kDecStages - 1; ++it) {  // the ring's first steps, one group each
    if (it < n_steps) stage(it, it);
    cp_async_commit();
  }
  cp_async_wait_n<kDecStages - 1>();
  __syncthreads();  // every thread's Q rows have landed
  // Q^T as the B fragments of S^T = K . Q^T (n = head, k = dim), in registers
  unsigned qf[D / 16][2];
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    unsigned b[4];
    ldsm4(b, sQ + (lane & 7) * LDS + (lane >> 3) * 8 + 32 * kk);
    qf[2 * kk][0] = b[0];
    qf[2 * kk][1] = b[1];
    qf[2 * kk + 1][0] = b[2];
    qf[2 * kk + 1][1] = b[3];
  }
  if constexpr (D % 32 != 0)  // d 80: the last 16 dims, two matrices (lanes 0-15's rows)
    ldsm2(qf[D / 16 - 1], sQ + (lane & 7) * LDS + ((lane >> 3) & 1) * 8 + (D - 16));
  // this thread's head columns 2 tq + c: slope and online-softmax state
  float slope[2], m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int h = 2 * tq + c;
    slope[c] = (a.alibi != nullptr && h < g) ? a.alibi[head0 + h] : 0.f;
  }
  // O^T: acc[mt] is the C fragment of dims 16 mt .. 16 mt + 15 x heads 0-7
  float acc[D / 16][4];
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;

  for (int it = 0; it < n_steps; ++it) {
    const int st = it % kDecStages;
    // the step kDecStages - 1 ahead, into the stage that step it - 1 left
    const int ahead = it + kDecStages - 1;
    if (ahead < n_steps) stage(ahead, ahead % kDecStages);
    cp_async_commit();
    cp_async_wait_n<kDecStages - 1>();
    __syncwarp();
    const T* sK;
    const float* ks = nullptr;
    const float* vs = nullptr;
    if constexpr (kInt8) {  // widen this stage's int8 rows (exact) into the warp's K, V
      const int8_t* raw = reinterpret_cast<const int8_t*>(ring) + st * 2 * kDecSlots * D;
      T* wide = reinterpret_cast<T*>(ring + L::kRaw + L::kScales);
      for (int c = lane; c < 2 * kDecSlots * (D / 16); c += 32) {
        const int t = c / (kDecSlots * (D / 16)), cc = c % (kDecSlots * (D / 16));
        const int r = cc / (D / 16), e0 = (cc % (D / 16)) * 16;
        const int4 v16 = *reinterpret_cast<const int4*>(raw + (t * kDecSlots + r) * D + e0);
        unsigned w[8];
        widen16(v16, w);
        uint4* dst = reinterpret_cast<uint4*>(wide + (t * kDecSlots + r) * LDS + e0);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncwarp();
      sK = wide;
      ks = reinterpret_cast<const float*>(ring + L::kRaw) + 2 * st * kDecSlots;
      vs = ks + kDecSlots;
    } else {
      sK = reinterpret_cast<const T*>(ring) + st * 2 * kDecSlots * LDS;
    }
    const T* sV = sK + kDecSlots * LDS;

    // S^T = K . Q^T: s[e] is (slot gq + 8 (e / 2), head 2 tq + e % 2)
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const T* pk = sK + (lane & 15) * LDS + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned ka[4];
      ldsm4(ka, pk + 16 * kk);
      mma16816(s, ka, qf[kk][0], qf[kk][1], T());
    }
    const int pb = p_lo + it * kDecStep + warp * kDecSlots;
    bool keep[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = gq + 8 * (e / 2), p = pb + c;
      float x = s[e];
      if constexpr (kInt8) x *= ks[c];
      x *= a.sm_scale;
      if (a.alibi != nullptr) x += slope[e % 2] * (float)(p - P);
      keep[e] = p < p_hi;  // a slot past the split's blocks never enters
      const bool vis = keep[e] && p <= P && (a.window <= 0 || P - p < a.window);
      s[e] = vis ? x : kMask;
    }
    // the online softmax of each head column, over its 16 slots (two per
    // lane, reduced over the 8 lanes gq = 0..7 that share tq)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float mx = fmaxf(m[c], fmaxf(s[c], s[c + 2]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float alpha = exp2f((m[c] - mx) * kLog2e);
      const float p0 = keep[c] ? exp2f((s[c] - mx) * kLog2e) : 0.f;
      const float p1 = keep[c + 2] ? exp2f((s[c + 2] - mx) * kLog2e) : 0.f;
      l[c] = l[c] * alpha + p0 + p1;
      m[c] = mx;
      s[c] = p0;
      s[c + 2] = p1;
#pragma unroll
      for (int mt = 0; mt < D / 16; ++mt) {
        acc[mt][c] *= alpha;
        acc[mt][c + 2] *= alpha;
      }
    }
    if constexpr (kInt8) {  // v_scale folded into p before the split
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] *= vs[gq + 8 * (e / 2)];
    }
    // P^T (slots x heads) as split hi + lo, each 8 x 8 half transposed into
    // the B fragments of O^T += V^T . P^T (k = slot, n = head)
    const T h0 = __float2bfloat16(s[0]), h1 = __float2bfloat16(s[1]);
    const T h2 = __float2bfloat16(s[2]), h3 = __float2bfloat16(s[3]);
    const unsigned bh0 = movmatrix_t(pack2(h0, h1)), bh1 = movmatrix_t(pack2(h2, h3));
    const unsigned bl0 = movmatrix_t(pack2(__float2bfloat16(s[0] - __bfloat162float(h0)),
                                           __float2bfloat16(s[1] - __bfloat162float(h1))));
    const unsigned bl1 = movmatrix_t(pack2(__float2bfloat16(s[2] - __bfloat162float(h2)),
                                           __float2bfloat16(s[3] - __bfloat162float(h3))));
    // V^T's A fragments: matrices (dims 0-7 | 8-15) x (slots 0-7 | 8-15)
    const T* pv = sV + ((lane & 7) + (lane >> 4) * 8) * LDS + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
      unsigned va[4];
      ldsm4_t(va, pv + 16 * mt);
      float t[4] = {0.f, 0.f, 0.f, 0.f};  // summed from zero, then added once
      mma16816(t, va, bh0, bh1, T());
      mma16816(t, va, bl0, bl1, T());
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][e] += t[e];
    }
    __syncwarp();  // this stage's readers are done before it is refilled
  }

  // the warp's row sums over the 8 lanes of each head column
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    l[c] += __shfl_xor_sync(0xffffffffu, l[c], 4);
    l[c] += __shfl_xor_sync(0xffffffffu, l[c], 8);
    l[c] += __shfl_xor_sync(0xffffffffu, l[c], 16);
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is done with its ring: the epilogue reuses them
  float* sAcc = reinterpret_cast<float*>(smem_raw + L::kQ);  // [warp][head][kAccLd]
  float* sM = sAcc + kDecWarps * 8 * L::kAccLd;             // [warp][head]
  float* sL = sM + kDecWarps * 8;
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sAcc[(warp * 8 + 2 * tq + e % 2) * L::kAccLd + 16 * mt + gq + 8 * (e / 2)] = acc[mt][e];
  if (gq == 0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      sM[warp * 8 + 2 * tq + c] = m[c];
      sL[warp * 8 + 2 * tq + c] = l[c];
    }
  }
  __syncthreads();
  // the warps' states merged in warp order
  for (int e = threadIdx.x; e < g * D; e += kThreads) {
    const int h = e / D, dd = e % D;
    float mx = kMask;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, sM[w * 8 + h]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float wt = exp2f((sM[w * 8 + h] - mx) * kLog2e);
      num += wt * sAcc[(w * 8 + h) * L::kAccLd + dd];
      den += wt * sL[w * 8 + h];
    }
    if (!partial) {
      a.out[row0 * D + e] = __float2bfloat16(num / fmaxf(den, 1e-30f));
    } else {  // the un-normalised partial and its softmax stats
      a.part_acc[prow0 * D + e] = num;
      if (dd == 0) {
        a.part_m[prow0 + h] = mx;
        a.part_l[prow0 + h] = den;
      }
    }
  }
}

// the splits' merge: a thread per (output row (token, head), 4 dims), the
// splits in order, 8 at a time so that their loads are in flight together;
// dead splits (m = -1e30, l = 0, acc = 0) weigh 0 beside a live one
constexpr int kMergeBatch = 8;

template <int D>
__global__ void __launch_bounds__(kThreads) decode_merge_kernel(const float* acc, const float* pm,
                                                                const float* pl,
                                                                __nv_bfloat16* out, long long rows,
                                                                int splits) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long row = t / (D / 4);
  const int c4 = (int)(t % (D / 4)) * 4;
  if (row >= rows) return;
  float mx = kMask;
  for (int s0 = 0; s0 < splits; s0 += kMergeBatch) {
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j)
      if (s0 + j < splits) mx = fmaxf(mx, pm[(s0 + j) * rows + row]);
  }
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.f;
  for (int s0 = 0; s0 < splits; s0 += kMergeBatch) {
    float mv[kMergeBatch], lv[kMergeBatch];
    float4 av[kMergeBatch];
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      const bool ok = s0 + j < splits;
      const long long r = (s0 + j) * rows + row;
      mv[j] = ok ? pm[r] : kMask;
      lv[j] = ok ? pl[r] : 0.f;
      av[j] = ok ? *reinterpret_cast<const float4*>(acc + r * D + c4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      const float w = exp2f((mv[j] - mx) * kLog2e);
      den += w * lv[j];
      num.x += w * av[j].x;
      num.y += w * av[j].y;
      num.z += w * av[j].z;
      num.w += w * av[j].w;
    }
  }
  const float d_safe = fmaxf(den, 1e-30f);
  *reinterpret_cast<uint2*>(out + row * D + c4) =
      make_uint2(pack2(__float2bfloat16(num.x / d_safe), __float2bfloat16(num.y / d_safe)),
                 pack2(__float2bfloat16(num.z / d_safe), __float2bfloat16(num.w / d_safe)));
}

// ---------------------------------------------------------------------------
// prefill: one CTA per (tile of contiguous tokens of one sequence, kv head,
// chunk of 64 of the tile's tokens x g rows) on the tensor cores; heavy
// (late) tiles first
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
__global__ void __launch_bounds__(kThreads * prefill_dsplit(D), prefill_dsplit(D) > 1 ? 1 : 2)
    paged_prefill_kernel(const Args a) {
  constexpr int LDS = Tile16<D>::LDS, TILE = Tile16<D>::ELEMS;
  constexpr bool kInt8 = IsInt8<KV>::value;
  constexpr int CH = D * (int)sizeof(KV) / 16;  // 16-byte chunks of one pool row
  constexpr int kPT = kThreads * prefill_dsplit(D);  // the CTA's threads
  constexpr int DV = D / prefill_dsplit(D);  // output dims a warp accumulates
  using T = __nv_bfloat16;
  const int kvh = blockIdx.x, tile = gridDim.y - 1 - blockIdx.y, c0 = kKT * blockIdx.z;
  const int ntok = a.tile_len[tile];
  // this chunk's rows: tile rows c0 .. c0 + R - 1 (R <= 0: an unused tile of
  // the static bound, or a chunk past a short tile's rows)
  const int g = a.g, R = min(ntok * g - c0, kKT), bs = a.bs;
  if (R <= 0) return;
  const int tok0 = a.tile_start[tile], seq = a.tile_seq[tile];
  const int max_pos = a.tile_max[tile], min_pos = a.tile_min[tile];
  // warp w: rows 16 (w % 4) .. + 15, output dims DV (w / 4) .. + DV - 1
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = 16 * (warp % 4);
  const int dv0 = DV * (warp / 4);

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
    for (int c = threadIdx.x; c < kKT * CH; c += kPT) {
      const int r = c / CH, e0 = (c % CH) * (16 / (int)sizeof(KV)), p = k0 + r;
      const bool ok = live(p);
      const long long off = ok ? ((long long)table[p / bs] * bs + p % bs) * row_stride + e0 : 0;
      cp_async16(dk + r * ld + e0, kp + off, ok);
      cp_async16(dv + r * ld + e0, vp + off, ok);
    }
    if (kInt8 && threadIdx.x < 2 * kKT) {  // threads 0-63 copy k scales, 64-127 v scales
      const int r = threadIdx.x % kKT, p = k0 + r;
      const bool ok = live(p);
      const long long si =
          (long long)kvh * a.scale_ld + (ok ? (long long)table[p / bs] * bs + p % bs : 0);
      const float* src = threadIdx.x < kKT ? a.k_scale : a.v_scale;
      cp_async4(sScale + (2 * st + threadIdx.x / kKT) * kKT + r, src + si, ok);
    }
  };

  // Q: row r is tile row c0 + r: token tok0 + (c0 + r) / g, head kvh * g +
  // (c0 + r) % g; rows past R zeros
  for (int c = threadIdx.x; c < kKT * (D / 8); c += kPT) {
    const int r = c / (D / 8), c8 = (c % (D / 8)) * 8, tr = c0 + r;
    const bool ok = r < R;
    const long long off =
        ok ? ((long long)(tok0 + tr / g) * a.nq + kvh * g + tr % g) * D + c8 : 0;
    cp_async16(sQ + r * LDS + c8, a.q + off, ok);
  }
  if (n_kt > 0) stage_kv(kt_lo * kKT, 0);
  cp_async_commit();

  // this thread's two rows (g + 8 i of the warp's 16): position, slope
  int rpos[2];
  float rslope[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + lane / 4 + 8 * i, tr = c0 + r;
    rpos[i] = r < R ? a.pos[tok0 + tr / g] : max_pos;
    rslope[i] = (r < R && a.alibi != nullptr) ? a.alibi[kvh * g + tr % g] : 0.f;
  }
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

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
      for (int c = threadIdx.x; c < 2 * kKT * (D / 16); c += kPT) {
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
        for (int n = 0; n < DV / 8; ++n) {
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
      mma_wm<DV, T, LDS>(acc, pf, sV + dv0, lane);  // acc += p . v over this warp's DV dims
    }
    __syncthreads();  // this stage's (and the widened tiles') readers are done
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_safe = fmaxf(quad_sum(l[i]), 1e-30f);
    const int r = r0 + lane / 4 + 8 * i, tr = c0 + r;
    if (r >= R) continue;
    T* dst = a.out + ((long long)(tok0 + tr / g) * a.nq + kvh * g + tr % g) * D + dv0 +
             2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      *reinterpret_cast<unsigned*>(dst + 8 * n) =
          pack2(__float2bfloat16(acc[n][2 * i] / l_safe), __float2bfloat16(acc[n][2 * i + 1] / l_safe));
  }
}

inline unsigned merge_grid(long long rows, int d) {
  return (unsigned)((rows * (d / 4) + kThreads - 1) / kThreads);
}

// The decode grid (T x nkv x head tiles, kv_splits), then, when `a` has both
// partials and `out`, the merge of the partials into out
template <int D, typename KV>
cudaError_t launch_decode(const Args& a, cudaStream_t stream) {
  constexpr size_t bytes = DecodeSmem<D, IsInt8<KV>::value>::kBytes;
  auto kern = paged_decode_kernel<D, KV>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  // up to three CTAs share an SM's shared memory (one at d 256)
  e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.T * a.nkv * ((a.g + 7) / 8), a.kv_splits), kThreads, bytes, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.part_acc == nullptr || a.out == nullptr) return e;
  const long long rows = (long long)a.T * a.nq;
  decode_merge_kernel<D><<<merge_grid(rows, D), kThreads, 0, stream>>>(a.part_acc, a.part_m,
                                                                       a.part_l, a.out, rows,
                                                                       a.kv_splits);
  return cudaGetLastError();
}

template <int D, typename KV>
cudaError_t launch_prefill(const Args& a, dim3 grid, cudaStream_t stream) {
  const size_t bytes = prefill_smem_bytes(D, IsInt8<KV>::value);
  auto kern = paged_prefill_kernel<D, KV>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  // two CTAs share an SM's shared memory (at d 256 one CTA of twice the warps)
  e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads * prefill_dsplit(D), bytes, stream>>>(a);
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
  a.g = nkv > 0 ? nq / nkv : 0;
  a.bs = bs;
  a.max_blocks = max_blocks;
  a.window = window;
  a.kv_splits = 1;
  a.sm_scale = 1.0f / sqrtf((float)d);
  return a;
}

// fn(std::integral_constant<int, d>{}) at a head dim the kernels are built
// for (64, 80, 96, 128, 256); cudaErrorInvalidValue at any other
template <typename F>
cudaError_t by_head_dim(int d, F fn) {
  switch (d) {
    case 64: return fn(std::integral_constant<int, 64>{});
    case 80: return fn(std::integral_constant<int, 80>{});
    case 96: return fn(std::integral_constant<int, 96>{});
    case 128: return fn(std::integral_constant<int, 128>{});
    case 256: return fn(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Decode grid (T x nkv x ceil(g / 8), kv_splits): one CTA per (token, kv
// head, head tile of <= 8 query heads, split).
// Without partials (part_acc null; kv_splits must be 1) it writes `out`.
// With partials it writes them, [kv_splits, T, nq, (D)] fp32, and then, when
// `out` is given, merges them into it by a second kernel on the same stream.
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
  const bool partial = part_acc != nullptr && part_m != nullptr && part_l != nullptr;
  if (nkv < 1 || nq % nkv != 0 || kv_splits < 1 || kv_splits > 65535 || T < 1 ||
      (long long)T * nkv * ((a.g + 7) / 8) > 0x7fffffffLL ||
      (!partial && (kv_splits != 1 || out == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (!partial) a.part_acc = nullptr;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)by_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return kv_int8 ? launch_decode<D, int8_t>(a, s) : launch_decode<D, __nv_bfloat16>(a, s);
  });
}

// The merge alone: partials [splits, rows, d] fp32 and [splits, rows] m, l
// into out [rows, d] bf16 (rows = T x nq).
int ds_paged_decode_merge(const float* part_acc, const float* part_m, const float* part_l,
                          void* out, long long rows, int d, int splits, void* stream) {
  if (rows < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  const unsigned grid = merge_grid(rows, d);
  auto* o = reinterpret_cast<__nv_bfloat16*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)by_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    decode_merge_kernel<D><<<grid, kThreads, 0, s>>>(part_acc, part_m, part_l, o, rows, splits);
    return cudaGetLastError();
  });
}

// Prefill grid (nkv, n_tiles, ceil(q_tile * g / 64)): one CTA per (kv head,
// tile of <= q_tile contiguous tokens of one sequence, chunk of 64 of the
// tile's rows), the tiles in reverse; reads q and writes out in token order.
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
  const long long chunks = ((long long)q_tile * a.g + kKT - 1) / kKT;
  if (nkv < 1 || nq % nkv != 0 || q_tile < 1 || n_tiles < 1 || n_tiles > 65535 ||
      chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nkv, n_tiles, (unsigned)chunks);
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)by_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return kv_int8 ? launch_prefill<D, int8_t>(a, grid, s)
                   : launch_prefill<D, __nv_bfloat16>(a, grid, s);
  });
}

const char* ds_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Dynamic shared memory of one decode CTA at this head_dim, for bf16
// (kv_int8 = 0) or int8 pools; it depends on neither g nor the block size.
long long ds_paged_smem_bytes(int d, int kv_int8) {
  long long bytes = -1;
  by_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    bytes = (long long)(kv_int8 ? DecodeSmem<D, true>::kBytes : DecodeSmem<D, false>::kBytes);
    return cudaSuccess;
  });
  return bytes;
}

// Dynamic shared memory of one prefill CTA at this head_dim, for bf16
// (kv_int8 = 0) or int8 pools; it does not depend on the block size.
long long ds_paged_prefill_smem_bytes(int d, int kv_int8) {
  return (long long)prefill_smem_bytes(d, kv_int8);
}

}  // extern "C"
