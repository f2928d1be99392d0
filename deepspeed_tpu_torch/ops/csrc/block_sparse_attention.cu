// Block-sparse attention forward over a per-(head, row) column LUT, for
// Hopper (sm_90a).
//
// Plain C interface (loaded with ctypes by ops/_build.py); the launchers
// return the cudaError_t of their launch and never synchronise.
//
// What it replaces: deepspeed_tpu/ops/pallas/block_sparse_attention.py
// _pallas_block_sparse (:196). That kernel walks a grid (B, H, nb, A) and
// carries its online-softmax state in VMEM across the innermost LUT axis.
// Here a warp (tensor cores) or a CTA (fp32) owns 16 query rows of one
// (batch, head, block row) and loops over the row's own nvalid[h, r] LUT
// columns itself.
//
// Semantics copied from the TPU kernel and the gathered form (:78-122).
// q, k, v are [B, H, L, D], read through (batch, head, row) strides with the
// last dimension contiguous, so the model's [B, S, n, D] tensors are read in
// place. Scores are scale * q.k; rpe[q, k] is added, then the key-padding
// mask kp[b, k] and the attention mask am[q, k], each either added ('add')
// or read as a 0/1 indicator that adds -1e30 where it is 0 ('mul'); causal
// sets -1e30 where k > q. The online softmax starts at m = -1e30, l = 0; a
// probability is exp(s - m) only where s > -5e29 (the TPU kernel's guard,
// :275), so a fully masked row stays 0; the output is acc / max(l, 1e-30).
// Padded LUT entries (make_layout_lut repeats a row's last column) are never
// visited: the key loop runs over the row's first nvalid columns only, and a
// row with nvalid 0 writes zeros. rpe and am ([L, L] fp32) are read only at
// the visited (q, k) positions.
//
// What bounds it on the H100: at the training shape (B 1, H 32, L 4096,
// D 128, block 16, the 'fixed' layout of 67 columns at most and 34 on
// average) the function needs ~3.6e10 operations over ~134 MB of q, k, v
// and out, so the bound is the bytes (~0.04 ms). But every block row reads
// its columns' K and V again: ~2.3 GB from L2 at block 16 when each 16-row
// warp stages its own, so a kernel whose products run on the tensor cores
// is held first by L2, then by the latency of each warp's chain of steps.
//
// bf16 / fp16, modelled on the paged decode's rings and the flash forward's
// fragments (mma_sm90.cuh):
// - A warp owns 16 query rows, which lie in one block row (the block is a
//   multiple of 16); a CTA is 4 warps over 64 consecutive rows of one
//   (b, h). The grid puts the head in blockIdx.x and the 64-row tile
//   reversed in blockIdx.y, so the latest (densest) rows of every head are
//   dispatched first.
// - Q stays in registers: its A fragments are loaded once with ldmatrix.
// - The walk (block_sparse_union_kernel): the CTA's warps walk the union of
//   their block rows' LUT columns together, from a descriptor built once
//   per layout on the host (union_plan: each entry a column and the bits of
//   the warps whose rows hold it). In the 'fixed' layout the four rows of a
//   local window share every global column, so one staged K/V slice serves
//   four warps and L2 reads fall about 4x. K and V (16-bit, row stride
//   D + 8) go by cp.async into a two-stage ring shared by the CTA, two
//   16-key slices a step (kUnionSlices), one barrier a step; a warp masks a
//   slice its row lacks and skips a step with none of its own. The other
//   walk (block_sparse_mma_kernel, --ablation block_sparse_per_warp): each
//   warp its own row's columns, one slice a step through a ring of its own,
//   no barrier; measured slower (PERF.md, PR 13).
// - Each column's slices are walked in order, reading each LUT (or union)
//   entry once per column; with causal, slices wholly above the rows are
//   skipped (exact: each of their scores is -1e30 and adds 0), and the
//   per-element mask runs only on the diagonal slice (16-aligned rows and
//   keys make every other slice wholly below or wholly above).
// - S = Q.K^T by mma.sync m16n8k16 from the unscaled 16-bit operands (exact
//   products, fp32 sums), times scale in fp32; rpe, am and kp are read in
//   the C-fragment layout, two neighbouring keys a float2.
// - P.V with P as a split hi + lo pair of the 16-bit type (the reference's
//   P is fp32), each step's product summed from zero and then added to the
//   alpha-rescaled accumulator (the tensor cores' fp32 sums truncate). The
//   online softmax's m and l stay in the quad of lanes that holds each row.
// - Registers: at d 128 the union kernel takes 248 and the per-warp one
//   ~236, so two CTAs share an SM; capped at 170 for three they spill
//   100-170 bytes a thread (and ran ~8% faster), which chip_smoke.py's
//   no-spill check refuses, so neither is capped.
//
// fp32 (block_sparse_fwd_fp32_kernel, the first version): each CTA stages
// 32 of its row's valid keys (the LUT columns laid end to end) at a time as
// fp32 tiles in shared memory, 128 threads give each of 16 query rows 8
// threads that own 4 keys of the score tile and 4 (D / 32) float4 columns
// of the output, on the CUDA cores (67 TFLOP/s peak), which hold it.
//
// Offsets are int64 throughout.

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kMask = -1e30f;

struct Args {
  const void* q;  // [B, H, L, D] through strides qs
  const void* k;
  const void* v;
  void* out;
  const int* lut;     // [H, nb, A] int32
  const int* nvalid;  // [H, nb] int32
  const float* rpe;   // [L, L] fp32 or null
  const float* kp;    // [B, L] fp32 or null
  const float* am;    // [L, L] fp32 or null
  long long qs[3], ks[3], vs[3], os[3];  // (batch, head, row) strides, in elements
  int B, H, L, block, A, causal, kp_mul, am_mul;
  float scale;
};

// One mask value: 'add' adds it, 'mul' adds -1e30 where it is 0.
__device__ __forceinline__ float mask_bias(float m, int mul) {
  return mul ? (m == 0.f ? kMask : 0.f) : m;
}

// ---------------------------------------------------------------------------
// bf16 / fp16: one warp per 16 query rows, on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;   // query rows of a warp, and keys of a slice
constexpr int kTileRows = kWarps * kRows;  // query rows of a CTA
constexpr int kStages = 2;  // the ring of K, V slices (each warp's, or the CTA's)
// the walk: each warp its own row's LUT columns (false), or the CTA's
// warps together the union of their rows' columns, from the descriptor of
// ops/block_sparse_attention.py::union_plan (true), whose format
// (kTileRows, kColBits) is that module's TILE_ROWS, _COL_BITS
constexpr bool kUnionWalk = true;
constexpr int kColBits = 24;  // a union entry: column | warp membership bits << kColBits

// 16-key slices a step of the union walk (the per-warp walk takes one)
constexpr int kUnionSlices = 2;

template <int D>
struct MmaSmem {
  static constexpr int LDS = D + ds_mma::kPad;
  static constexpr int kTile = kRows * LDS;  // one 16 x D tile, elements
};

// 16 rows from row0 of a [L, D] operand (row stride ld) into a [16][LDS]
// tile by `n` threads (thread index i), each copy instruction of a warp
// taking 32 / (D / 8) whole rows; zeros when !valid
template <int D, int n, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long ld, int row0, int i,
                                           bool valid = true) {
  constexpr int CH = D / 8, LDS = MmaSmem<D>::LDS, CHUNKS = kRows * CH;
#pragma unroll
  for (int k = 0; k < (CHUNKS + n - 1) / n; ++k) {
    const int c = k * n + i, rr = c / CH, c8 = (c % CH) * 8;
    if (CHUNKS % n == 0 || c < CHUNKS)
      ds_mma::cp_async16(dst + rr * LDS + c8, src + (long long)(row0 + rr) * ld + c8, valid);
  }
}

// The 16-key slices of column c that rows up to q_last walk: all, or with
// causal those not wholly above q_last (a slice wholly above is skipped:
// every score there is -1e30 and adds 0)
__device__ __forceinline__ int col_slices(const Args& a, int c, int q_last) {
  const int spc = a.block / kRows;
  return a.causal ? max(0, min(spc, (q_last - c * a.block + kRows) / kRows)) : spc;
}

// Q's 16 rows from q0, staged through `tile`, as the A fragments of
// S = Q . K^T in registers (the caller's copies before this have landed)
template <int D, typename T>
__device__ __forceinline__ void load_q(unsigned (&qf)[D / 16][4], T* tile, const T* qp,
                                       long long ld, int q0, int lane) {
  constexpr int LDS = MmaSmem<D>::LDS;
  stage_rows<D, 32>(tile, qp, ld, q0, lane);
  ds_mma::cp_async_commit();
  ds_mma::cp_async_wait_all();
  __syncwarp();
  const T* pa = tile + (lane & 15) * LDS + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ds_mma::ldsm4(qf[kk], pa + 16 * kk);
  __syncwarp();
}

// One step of NS 16-key slices (slice h: keys k0[h] .. + 15, K and V
// staged in rows 16 h .. 16 h + 15 of sK, sV) against a warp's 16 query
// rows q0 .. q0 + 15, slices with on[h] false entering as -1e30 (never):
// S = Q . K^T on the tensor cores, times scale, then rpe, kp, am at (row
// q0 + g + 8 i, keys kc, kc + 1) and the causal mask per element on the
// diagonal slice; the online softmax of rows g and g + 8 over the quad that
// holds them (a score at or below -5e29 never enters); acc = alpha acc +
// P . V with P split hi + lo, the step's product summed from zero first.
template <int D, int NS, typename T>
__device__ __forceinline__ void attend(const Args& a, const T* sK, const T* sV,
                                       const unsigned (&qf)[D / 16][4], const float* kp_row,
                                       int q0, const int (&k0)[NS], const bool (&on)[NS],
                                       float (&m)[2], float (&l)[2], float (&acc)[D / 8][4],
                                       int lane) {
  using ds_mma::mma16816;
  constexpr int LDS = MmaSmem<D>::LDS;
  const int g = lane / 4, t4 = lane % 4;
  // S: s[j] is the C fragment of keys 8 j .. 8 j + 7 of the step. B rows
  // are keys: matrices (keys 0-7, dims 0-7), (0-7, 8-15), (8-15, 0-7),
  // (8-15, 8-15) = b0, b1 of n-tile 2 h, then of n-tile 2 h + 1
  float s[2 * NS][4];
#pragma unroll
  for (int j = 0; j < 2 * NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  const T* pb = sK + ((lane & 7) + (lane >> 4) * 8) * LDS + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int h = 0; h < NS; ++h) {
      unsigned kb[4];
      ds_mma::ldsm4(kb, pb + h * kRows * LDS + 16 * kk);
      mma16816(s[2 * h], qf[kk], kb[0], kb[1], T());
      mma16816(s[2 * h + 1], qf[kk], kb[2], kb[3], T());
    }
#pragma unroll
  for (int j = 0; j < 2 * NS; ++j) {
    const int h = j / 2, kc = k0[h] + 8 * (j % 2) + 2 * t4;
    if (!on[h]) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = kMask;
      continue;
    }
    const bool diag = a.causal && k0[h] == q0;
    float2 kpv = make_float2(0.f, 0.f);
    if (kp_row != nullptr) kpv = *reinterpret_cast<const float2*>(kp_row + kc);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = q0 + g + 8 * i;
      float x0 = s[j][2 * i] * a.scale, x1 = s[j][2 * i + 1] * a.scale;
      if (a.rpe != nullptr) {
        const float2 rv = *reinterpret_cast<const float2*>(a.rpe + (long long)qpos * a.L + kc);
        x0 += rv.x;
        x1 += rv.y;
      }
      if (kp_row != nullptr) {
        x0 += mask_bias(kpv.x, a.kp_mul);
        x1 += mask_bias(kpv.y, a.kp_mul);
      }
      if (a.am != nullptr) {
        const float2 mv = *reinterpret_cast<const float2*>(a.am + (long long)qpos * a.L + kc);
        x0 += mask_bias(mv.x, a.am_mul);
        x1 += mask_bias(mv.y, a.am_mul);
      }
      if (diag) {
        if (kc > qpos) x0 = kMask;
        if (kc + 1 > qpos) x1 = kMask;
      }
      s[j][2 * i] = x0;
      s[j][2 * i + 1] = x1;
    }
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m[i];
#pragma unroll
    for (int j = 0; j < 2 * NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[i] = exp2f((m[i] - mx) * ds_mma::kLog2e);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * NS; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = s[j][2 * i + e];
        const float p = x > 0.5f * kMask ? exp2f((x - mx) * ds_mma::kLog2e) : 0.f;
        s[j][2 * i + e] = p;
        sum += p;
      }
    l[i] = l[i] * alpha[i] + sum;
    m[i] = mx;
  }
  // P (16 x 16 NS) as NS A fragments (depth chunk h: C tiles 2 h, 2 h + 1),
  // split hi + lo: element e of C tile j is register 2 (j % 2) + e / 2 of
  // chunk j / 2, half e % 2
  unsigned ph[NS][4], pl[NS][4];
#pragma unroll
  for (int j = 0; j < 2 * NS; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float x = s[j][2 * i], y = s[j][2 * i + 1];
      const T hx = ds_mma::from_f<T>(x), hy = ds_mma::from_f<T>(y);
      ph[j / 2][2 * (j % 2) + i] = ds_mma::pack2(hx, hy);
      pl[j / 2][2 * (j % 2) + i] = ds_mma::pack2(ds_mma::from_f<T>(x - ds_mma::to_f(hx)),
                                                 ds_mma::from_f<T>(y - ds_mma::to_f(hy)));
    }
  // V by ldmatrix.trans: matrices (keys 0-7, dims 0-7), (8-15, 0-7),
  // (0-7, 8-15), (8-15, 8-15) of chunk h = b0, b1 of n-tile n, then of
  // n-tile n + 1
  const T* pv = sV + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDS + (lane >> 4) * 8;
#pragma unroll
  for (int n = 0; n < D / 8; n += 2) {
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int h = 0; h < NS; ++h) {
      unsigned vb[4];
      ds_mma::ldsm4_t(vb, pv + h * kRows * LDS + n * 8);
      mma16816(t0, ph[h], vb[0], vb[1], T());
      mma16816(t0, pl[h], vb[0], vb[1], T());
      mma16816(t1, ph[h], vb[2], vb[3], T());
      mma16816(t1, pl[h], vb[2], vb[3], T());
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[n][e] = acc[n][e] * alpha[e / 2] + t0[e];
      acc[n + 1][e] = acc[n + 1][e] * alpha[e / 2] + t1[e];
    }
  }
}

// acc / max(l, 1e-30) of a warp's rows q0 + g + 8 i, l summed over the quad
template <int D, typename T>
__device__ __forceinline__ void store_rows(const Args& a, int b, int h, int q0,
                                           const float (&l)[2], const float (&acc)[D / 8][4],
                                           int lane) {
  T* op = reinterpret_cast<T*>(a.out) + b * a.os[0] + h * a.os[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mul = 1.f / fmaxf(ds_mma::quad_sum(l[i]), 1e-30f);
    T* dst = op + (long long)(q0 + lane / 4 + 8 * i) * a.os[2] + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<unsigned*>(dst + 8 * n) =
          ds_mma::pack2(ds_mma::from_f<T>(acc[n][2 * i] * mul),
                        ds_mma::from_f<T>(acc[n][2 * i + 1] * mul));
  }
}

// Each warp walks its own block row's LUT columns through its own ring; no
// barrier spans the CTA.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 2) block_sparse_mma_kernel(const Args a) {
  constexpr int TILE = MmaSmem<D>::kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTileRows + warp * kRows;
  if (q0 >= a.L) return;
  const int nb = a.L / a.block, r = q0 / a.block;
  const int* lut_row = a.lut + ((long long)h * nb + r) * a.A;
  const int nv = a.nvalid[(long long)h * nb + r];

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw) + warp * kStages * 2 * TILE;
  const T* kptr = reinterpret_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const T* vptr = reinterpret_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[1];
  // the first LUT index >= j (of the row's first nv) with a slice to walk,
  // its column c and slice count ns; nv when there is none
  auto next_col = [&](int j, int& c, int& ns) {
    for (; j < nv; ++j) {
      c = lut_row[j];
      ns = col_slices(a, c, q0 + kRows - 1);
      if (ns > 0) break;
    }
    return j;
  };

  unsigned qf[D / 16][4];
  load_q<D>(qf, ring, reinterpret_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1], a.qs[2], q0,
            lane);

  // two cursors over (LUT index j, column c, its slice count ns, slice s):
  // `a*` stages, `c*` computes, kStages - 1 slices behind
  int ac = 0, an = 0, as = 0;
  int aj = next_col(0, ac, an);
  int cj = aj, cc = ac, cn = an, cs = 0;
  auto issue = [&](int st) {  // the ahead cursor's slice into stage st, one group
    if (aj < nv) {
      const int k0 = ac * a.block + as * kRows;
      T* dst = ring + st * 2 * TILE;
      stage_rows<D, 32>(dst, kptr, a.ks[2], k0, lane);
      stage_rows<D, 32>(dst + TILE, vptr, a.vs[2], k0, lane);
      if (++as == an) {
        as = 0;
        aj = next_col(aj + 1, ac, an);
      }
    }
    ds_mma::cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(st);

  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float* kp_row = a.kp != nullptr ? a.kp + (long long)b * a.L : nullptr;
  for (int it = 0; cj < nv; ++it) {
    const int st = it % kStages;
    issue((it + kStages - 1) % kStages);  // the stage that step it - 1 left
    ds_mma::cp_async_wait_n<kStages - 1>();
    __syncwarp();
    const T* sK = ring + st * 2 * TILE;
    const int k0[1] = {cc * a.block + cs * kRows};
    const bool on[1] = {true};
    attend<D, 1>(a, sK, sK + TILE, qf, kp_row, q0, k0, on, m, l, acc, lane);
    __syncwarp();  // every lane's reads of stage st are done before it refills
    if (++cs == cn) {
      cs = 0;
      cj = next_col(cj + 1, cc, cn);
    }
  }
  store_rows<D, T>(a, b, h, q0, l, acc, lane);
}

// The CTA's warps walk the union of their block rows' LUT columns
// together, kUnionSlices 16-key slices a step: a.lut holds the union_plan
// descriptor [H, tiles, A], entries column | (warp membership bits <<
// kColBits), and a.nvalid [H, tiles] the entries of each tile. Every staged
// slice is shared by the four warps; a warp masks a slice of a column its
// own row lacks, and with causal a slice wholly above its rows, and skips
// a step in which it has none.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 2) block_sparse_union_kernel(const Args a) {
  constexpr int NS = kUnionSlices, TILE = MmaSmem<D>::kTile, STEP = NS * TILE;
  static_assert(2 * NS * kStages >= kWarps, "each warp stages its Q through one tile of the ring");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.x, b = blockIdx.z;
  const int tile = gridDim.y - 1 - blockIdx.y;
  const int q_cta = tile * kTileRows, q0 = q_cta + warp * kRows;
  const bool live = q0 < a.L;  // a warp past L still stages its share
  const int q_last = min(q_cta + kTileRows, a.L) - 1;
  const int* list = a.lut + ((long long)h * gridDim.y + tile) * a.A;
  const int n = a.nvalid[(long long)h * gridDim.y + tile];

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [kStages][K, V][16 NS][LDS]
  const T* kptr = reinterpret_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const T* vptr = reinterpret_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[1];
  // a cursor over the slices of the entries with a slice below the CTA's
  // last row: entry j, its column c, warp bits w, slice count ns, slice sl
  struct Cursor {
    int j, c, w, ns, sl;
  };
  auto seek = [&](Cursor& u, int j) {  // the first such entry >= j; j = n when none
    for (; j < n; ++j) {
      const int e = list[j];
      u.c = e & ((1 << kColBits) - 1);
      u.w = e >> kColBits;
      u.ns = col_slices(a, u.c, q_last);
      if (u.ns > 0) break;
    }
    u.j = j;
    u.sl = 0;
  };
  auto advance = [&](Cursor& u) {
    if (++u.sl == u.ns) seek(u, u.j + 1);
  };

  unsigned qf[D / 16][4];
  if (live)
    load_q<D>(qf, ring + warp * TILE,
              reinterpret_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1], a.qs[2], q0, lane);
  __syncthreads();  // every warp's Q is in registers before the ring refills

  Cursor ahead, at;  // `ahead` stages, `at` computes, kStages - 1 steps behind
  seek(ahead, 0);
  at = ahead;
  auto issue = [&](int st) {  // the next NS slices into stage st by the CTA, one group
    T* dst = ring + st * 2 * STEP;
#pragma unroll
    for (int hh = 0; hh < NS; ++hh) {
      if (ahead.j < n) {
        const int k0 = ahead.c * a.block + ahead.sl * kRows;
        stage_rows<D, kThreads>(dst + hh * TILE, kptr, a.ks[2], k0, threadIdx.x);
        stage_rows<D, kThreads>(dst + STEP + hh * TILE, vptr, a.vs[2], k0, threadIdx.x);
        advance(ahead);
      } else if (hh > 0) {  // past the list: zeros, so that p = 0 meets no NaN
        stage_rows<D, kThreads>(dst + hh * TILE, kptr, a.ks[2], 0, threadIdx.x, false);
        stage_rows<D, kThreads>(dst + STEP + hh * TILE, vptr, a.vs[2], 0, threadIdx.x, false);
      }
    }
    ds_mma::cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(st);

  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const float* kp_row = a.kp != nullptr ? a.kp + (long long)b * a.L : nullptr;
  for (int it = 0; at.j < n; ++it) {
    const int st = it % kStages;
    ds_mma::cp_async_wait_n<kStages - 2>();  // this thread's copies of step it
    __syncthreads();  // everyone's have landed, and step it - 1 is done with its stage
    issue((it + kStages - 1) % kStages);
    int k0[NS];
    bool on[NS], any = false;
#pragma unroll
    for (int hh = 0; hh < NS; ++hh) {
      k0[hh] = at.c * a.block + at.sl * kRows;
      on[hh] = live && at.j < n && ((at.w >> warp) & 1) &&
               (!a.causal || k0[hh] <= q0 + kRows - 1);
      any = any || on[hh];
      if (at.j < n) advance(at);
    }
    if (any) {
      const T* sK = ring + st * 2 * STEP;
      attend<D, NS>(a, sK, sK + STEP, qf, kp_row, q0, k0, on, m, l, acc, lane);
    }
  }
  if (live) store_rows<D, T>(a, b, h, q0, l, acc, lane);
}

// ---------------------------------------------------------------------------
// fp32: one CTA per (16 query rows, head, batch), on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int kTQ = 16;        // query rows per CTA
constexpr int kKC = 32;        // keys staged per step
constexpr int kPL = kKC + 8;   // padded row of the [kTQ][kKC] probability tile

// 8 consecutive floats
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store8(float* dst, const float* f) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

template <int D>
__global__ void __launch_bounds__(kThreads) block_sparse_fwd_fp32_kernel(const Args a) {
  constexpr int LD = D + 4;
  constexpr int NC = D / 32;  // float4 output columns per thread
  const int nb = a.L / a.block;
  const int q0 = blockIdx.x * kTQ;
  const int r = q0 / a.block;  // the query block row
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ri = tid >> 3, cg = tid & 7;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;             // [kTQ][LD], pre-scaled q
  float* sK = sQ + kTQ * LD;    // [kKC][LD]
  float* sV = sK + kKC * LD;    // [kKC][LD]
  float* sP = sV + kKC * LD;    // [kTQ][kPL]

  const float* qp = reinterpret_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const float* kptr = reinterpret_cast<const float*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const float* vptr = reinterpret_cast<const float*>(a.v) + b * a.vs[0] + h * a.vs[1];
  for (int c = tid; c < kTQ * (D / 8); c += kThreads) {
    const int row = c / (D / 8), c8 = (c % (D / 8)) * 8;
    float f[8];
    load8(qp + (long long)(q0 + row) * a.qs[2] + c8, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] *= a.scale;
    store8(sQ + row * LD + c8, f);
  }

  const int* lut_row = a.lut + ((long long)h * nb + r) * a.A;
  const int nv = a.nvalid[(long long)h * nb + r];
  const int n_keys = nv * a.block;  // the row's valid keys, its LUT columns end to end
  const int qpos = q0 + ri;
  const float* rpe_row = a.rpe != nullptr ? a.rpe + (long long)qpos * a.L : nullptr;
  const float* am_row = a.am != nullptr ? a.am + (long long)qpos * a.L : nullptr;
  const float* kp_row = a.kp != nullptr ? a.kp + (long long)b * a.L : nullptr;

  float m = kMask, l = 0.f;
  float4 acc[NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[n] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t0 = 0; t0 < n_keys; t0 += kKC) {
    __syncthreads();  // the previous step's readers of sK, sV and sP are done
    for (int c = tid; c < kKC * (D / 8); c += kThreads) {
      const int kk = c / (D / 8), c8 = (c % (D / 8)) * 8;
      const int t = t0 + kk;
      float fk[8], fv[8];
      if (t < n_keys) {
        const long long kpos = (long long)lut_row[t / a.block] * a.block + t % a.block;
        load8(kptr + kpos * a.ks[2] + c8, fk);
        load8(vptr + kpos * a.vs[2] + c8, fv);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) fk[e] = fv[e] = 0.f;
      }
      store8(sK + kk * LD + c8, fk);
      store8(sV + kk * LD + c8, fv);
    }
    __syncthreads();

    // scores of query row ri against keys cg + 8 j
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(sQ + ri * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(sK + (cg + 8 * j) * LD + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }
    bool valid[4];
    float mx = kMask;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + cg + 8 * j;
      valid[j] = t < n_keys;
      if (!valid[j]) continue;  // past the row's keys: not a key at all
      const int kpos = lut_row[t / a.block] * a.block + t % a.block;
      float x = s[j];
      if (rpe_row != nullptr) x += rpe_row[kpos];
      if (kp_row != nullptr) x += mask_bias(kp_row[kpos], a.kp_mul);
      if (am_row != nullptr) x += mask_bias(am_row[kpos], a.am_mul);
      if (a.causal && kpos > qpos) x = kMask;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // a masked score never contributes, so a fully masked row stays 0
      const float p = (valid[j] && s[j] > 0.5f * kMask) ? expf(s[j] - m_new) : 0.f;
      sP[ri * kPL + cg + 8 * j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float alpha = expf(m - m_new);
    l = l * alpha + sum;
    m = m_new;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      acc[n].x *= alpha;
      acc[n].y *= alpha;
      acc[n].z *= alpha;
      acc[n].w *= alpha;
    }
    __syncthreads();  // sP complete

    // acc[row ri, columns cg * 4 + 32 n] += sum_kk p[ri][kk] v[kk][columns]
    const int kn = min(kKC, n_keys - t0);
    for (int kk = 0; kk < kn; ++kk) {
      const float p = sP[ri * kPL + kk];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float4 vv = *reinterpret_cast<const float4*>(sV + kk * LD + cg * 4 + 32 * n);
        acc[n].x = fmaf(p, vv.x, acc[n].x);
        acc[n].y = fmaf(p, vv.y, acc[n].y);
        acc[n].z = fmaf(p, vv.z, acc[n].z);
        acc[n].w = fmaf(p, vv.w, acc[n].w);
      }
    }
  }

  const float l_safe = fmaxf(l, 1e-30f);
  float* op = reinterpret_cast<float*>(a.out) + b * a.os[0] + h * a.os[1] +
              (long long)qpos * a.os[2];
#pragma unroll
  for (int n = 0; n < NC; ++n)
    reinterpret_cast<float4*>(op + cg * 4 + 32 * n)[0] =
        make_float4(acc[n].x / l_safe, acc[n].y / l_safe, acc[n].z / l_safe, acc[n].w / l_safe);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
enum Kind { kMma = 0, kFp32 = 1 };

__host__ __device__ inline size_t smem_bytes(int kind, int d) {
  if (kind == kMma)  // rings of kStages steps of K, V, 16 x (d + 8) 16-bit a slice: the CTA's
    // (union walk, kUnionSlices slices a step) or each warp's (one slice a step)
    return (size_t)kStages * 2 * (kUnionWalk ? kUnionSlices : kWarps) * kRows *
           (d + ds_mma::kPad) * 2;
  return ((size_t)kTQ * (d + 4) + 2 * (size_t)kKC * (d + 4) + (size_t)kTQ * kPL) * sizeof(float);
}

template <typename K>
cudaError_t launch(K kern, size_t bytes, dim3 grid, const Args& a, cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_kind(int kind, int dtype, const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes(kind, D);
  if (kind == kFp32) {
    if (dtype != 2) return cudaErrorInvalidValue;
    return launch(block_sparse_fwd_fp32_kernel<D>, bytes, dim3(a.L / kTQ, a.H, a.B), a, stream);
  }
  const dim3 grid(a.H, (a.L + kTileRows - 1) / kTileRows, a.B);
  if constexpr (kUnionWalk) {
    if (dtype == 0) return launch(block_sparse_union_kernel<D, __nv_bfloat16>, bytes, grid, a, stream);
    if (dtype == 1) return launch(block_sparse_union_kernel<D, __half>, bytes, grid, a, stream);
  } else {
    if (dtype == 0) return launch(block_sparse_mma_kernel<D, __nv_bfloat16>, bytes, grid, a, stream);
    if (dtype == 1) return launch(block_sparse_mma_kernel<D, __half>, bytes, grid, a, stream);
  }
  return cudaErrorInvalidValue;
}

int run(int kind, const void* q, const void* k, const void* v, void* out, const int* lut,
        const int* nvalid, const float* rpe, const float* kp, const float* am,
        const long long* strides, int B, int H, int L, int d, int block, int A, int causal,
        float scale, int kp_mul, int am_mul, int dtype, void* stream) {
  if (B < 1 || H < 1 || B > 65535 || H > 65535 || block < kRows || block % kRows != 0 ||
      L < block || L % block != 0 || A < 1 ||
      (kind == kMma && (L + kTileRows - 1) / kTileRows > 65535))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lut = lut;
  a.nvalid = nvalid;
  a.rpe = rpe;
  a.kp = kp;
  a.am = am;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.B = B;
  a.H = H;
  a.L = L;
  a.block = block;
  a.A = A;
  a.causal = causal;
  a.kp_mul = kp_mul;
  a.am_mul = am_mul;
  a.scale = scale;
  const cudaStream_t st = (cudaStream_t)stream;
  if (d == 128) return (int)launch_kind<128>(kind, dtype, a, st);
  if (d == 64) return (int)launch_kind<64>(kind, dtype, a, st);
  if (d == 32) return (int)launch_kind<32>(kind, dtype, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out [B, H, L, d] through its strides, in q's dtype (dtype 0 bf16, 1 fp16;
// the tensor-core kernel). strides: 12 int64, the (batch, head, row) strides
// of q, k, v and out in elements, each a multiple of 8, the last dimension
// contiguous. lut [H, L / block, A] and nvalid [H, L / block] int32; rpe,
// kp, am fp32 or null; kp_mul / am_mul select 'mul' mode. block must be a
// multiple of 16 that divides L, and d 32, 64 or 128.
int ds_block_sparse_fwd(const void* q, const void* k, const void* v, void* out, const int* lut,
                        const int* nvalid, const float* rpe, const float* kp, const float* am,
                        const long long* strides, int B, int H, int L, int d, int block, int A,
                        int causal, float scale, int kp_mul, int am_mul, int dtype,
                        void* stream) {
  return run(kMma, q, k, v, out, lut, nvalid, rpe, kp, am, strides, B, H, L, d, block, A, causal,
             scale, kp_mul, am_mul, dtype, stream);
}

// The same on the CUDA cores in fp32: fp32 (dtype 2) only.
int ds_block_sparse_fwd_fp32(const void* q, const void* k, const void* v, void* out,
                             const int* lut, const int* nvalid, const float* rpe, const float* kp,
                             const float* am, const long long* strides, int B, int H, int L, int d,
                             int block, int A, int causal, float scale, int kp_mul, int am_mul,
                             int dtype, void* stream) {
  return run(kFp32, q, k, v, out, lut, nvalid, rpe, kp, am, strides, B, H, L, d, block, A,
             causal, scale, kp_mul, am_mul, dtype, stream);
}

const char* ds_block_sparse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// 1 when the tensor-core kernel takes the union walk, whose descriptor
// (ops/block_sparse_attention.py::union_plan) the caller passes in place of
// lut, nvalid and A; 0 when it takes the per-warp walk over lut itself.
int ds_block_sparse_union_walk() { return kUnionWalk ? 1 : 0; }

// Dynamic shared memory of one CTA at head_dim d: kind 0 the tensor-core
// kernel, 1 the fp32 one.
long long ds_block_sparse_smem_bytes(int kind, int d) { return (long long)smem_bytes(kind, d); }

}  // extern "C"
