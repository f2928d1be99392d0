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
// per-(kv-head, slot) fp32 scales at the read. GQA: the g = nq / nkv query
// heads of one kv head share a CTA, so each KV block is read once for them.
//
// What bounds it on the H100: decode reads every live KV byte once per
// (token, kv head) and does ~1 FLOP per byte, so it is bound by HBM bytes
// (3.35 TB/s); a long prefill does ~q_tile*g FLOPs per KV byte and moves
// toward the FLOP roof. This first version is deliberately simple: a CTA
// stages one KV block (block_size x head_dim) in shared memory as fp32 with
// 16-byte vector loads, scores it against its query rows on the CUDA cores
// and keeps the online softmax in shared memory and the output accumulator
// in registers. The split-K grid gives a decode batch enough CTAs to keep
// the card's memory system busy; the q tile makes a prefill tile read each
// KV block once for q_tile tokens. wgmma and TMA pipelines are later work.
//
// Offsets: a 7B pool holds ~8.6e9 elements per tensor, past INT32_MAX, so
// every slot x (nkv * head_dim) product is int64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
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

// One CTA: the rows (token i, group head gi), r = i * g + gi, of `ntok`
// consecutive tokens starting at tok0, all of sequence `seq`, against kv head
// `kvh`, over the KV blocks [j_begin, j_end) that the block predicate keeps.
// RMAX bounds rows per CTA (decode: g; prefill: q_tile * g).
template <int D, typename KV, int RMAX, bool PREFILL>
__global__ void __launch_bounds__(kThreads) paged_attn_kernel(const Args a) {
  constexpr int RS = kThreads / D;        // row stride of a thread's accumulator rows
  constexpr int KMAX = RMAX / RS;         // accumulator rows per thread
  static_assert(kThreads % D == 0, "head_dim must divide the CTA");
  static_assert(RMAX % RS == 0, "RMAX must be a multiple of the row stride");

  const int kvh = blockIdx.y;
  int tok0, ntok, seq, max_pos, min_pos, j_begin, j_end, split = 0;
  if constexpr (PREFILL) {
    const int tile = blockIdx.x;
    ntok = a.tile_len[tile];
    if (ntok == 0) return;  // unused tile of the static bound
    tok0 = a.tile_start[tile];
    seq = a.tile_seq[tile];
    max_pos = a.tile_max[tile];
    min_pos = a.tile_min[tile];
    j_begin = 0;
    j_end = a.max_blocks;
  } else {
    tok0 = blockIdx.x;
    ntok = 1;
    seq = a.seq_idx[tok0];
    max_pos = min_pos = a.pos[tok0];
    split = blockIdx.z;
    const int per = (a.max_blocks + a.kv_splits - 1) / a.kv_splits;
    j_begin = split * per;
    j_end = min(j_begin + per, a.max_blocks);
  }
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
    if (PREFILL || a.kv_splits == 1) {
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

template <int D, typename KV, int RMAX, bool PREFILL>
cudaError_t launch(const Args& a, dim3 grid, int rows, cudaStream_t stream) {
  const size_t bytes = smem_floats(rows, D, a.bs) * sizeof(float);
  auto kern = paged_attn_kernel<D, KV, RMAX, PREFILL>;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int RMAX, bool PREFILL>
cudaError_t dispatch(const Args& a, int d, int kv_int8, dim3 grid, int rows,
                     cudaStream_t stream) {
  if (d == 128) {
    return kv_int8 ? launch<128, int8_t, RMAX, PREFILL>(a, grid, rows, stream)
                   : launch<128, __nv_bfloat16, RMAX, PREFILL>(a, grid, rows, stream);
  }
  if (d == 64) {
    return kv_int8 ? launch<64, int8_t, RMAX, PREFILL>(a, grid, rows, stream)
                   : launch<64, __nv_bfloat16, RMAX, PREFILL>(a, grid, rows, stream);
  }
  return cudaErrorInvalidValue;
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
  return (int)dispatch<8, false>(a, d, kv_int8, grid, a.g, (cudaStream_t)stream);
}

// Prefill grid (n_tiles, nkv): one CTA per (tile of <= q_tile contiguous
// tokens of one sequence, kv head); reads q and writes out in token order.
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
  if (q_tile * a.g > 64 || nq % nkv != 0 || q_tile < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_tiles, nkv, 1);
  return (int)dispatch<64, true>(a, d, kv_int8, grid, q_tile * a.g, (cudaStream_t)stream);
}

const char* ds_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Dynamic shared memory one CTA requests for `rows` query rows (decode: g;
// prefill: q_tile * g) at this head_dim and block size.
long long ds_paged_smem_bytes(int rows, int d, int bs) {
  return (long long)(smem_floats(rows, d, bs) * sizeof(float));
}

}  // extern "C"
