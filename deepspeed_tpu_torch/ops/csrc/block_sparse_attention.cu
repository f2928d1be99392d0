// Block-sparse attention forward over a per-(head, row) column LUT, for
// Hopper (sm_90a).
//
// Plain C interface (loaded with ctypes by ops/_build.py); the launcher
// returns the cudaError_t of its launch and never synchronises.
//
// What it replaces: deepspeed_tpu/ops/pallas/block_sparse_attention.py
// _pallas_block_sparse (:196). That kernel walks a grid (B, H, nb, A) and
// carries its online-softmax state in VMEM across the innermost LUT axis.
// Here a CTA owns 16 query rows of one (batch, head, block row) and loops
// over the row's own nvalid[h, r] LUT columns itself.
//
// Semantics copied from the TPU kernel and the gathered form (:78-122).
// q, k, v are [B, H, L, D], read through (batch, head, row) strides with the
// last dimension contiguous, so the model's [B, S, n, D] tensors are read in
// place. q is pre-scaled by `scale` (:255); scores get rpe[q, k] added, then
// the key-padding mask kp[b, k] and the attention mask am[q, k], each either
// added ('add') or read as a 0/1 indicator that adds -1e30 where it is 0
// ('mul'); causal sets -1e30 where k > q. The online softmax starts at
// m = -1e30, l = 0; a probability is exp(s - m) only where s > -5e29, so a
// fully masked row stays 0; the output is acc / max(l, 1e-30). Padded LUT
// entries (make_layout_lut repeats a row's last column) are never visited:
// the key loop runs over the row's first nvalid columns only, and a row
// with nvalid 0 writes zeros. rpe and am ([L, L] fp32) are read only at the
// visited (q, k) positions.
//
// What bounds it on the H100: at the training shape (B 1, H 32, L 4096,
// D 128, block 16, the 'fixed' layout of 67 columns at most and 34 on
// average) the function needs ~3.6e10 operations over ~134 MB of q, k, v
// and out, so the bound is the bytes (~0.04 ms). This first version runs
// its products on the CUDA cores in fp32 (67 TFLOP/s peak), so it is held
// by those operations: each CTA stages 32 keys of its row's valid keys (the
// LUT columns laid end to end) at a time as fp32 tiles in shared memory,
// 128 threads give each of the 16 query rows 8 threads that own 4 keys of
// the score tile and 4 (D / 32) float4 columns of the output, and the
// online-softmax state stays in registers. Tensor-core (mma / wgmma)
// products, TMA-fed K/V and a hand-written backward are later work.
//
// Offsets are int64 throughout.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTQ = 16;        // query rows per CTA
constexpr int kKC = 32;        // keys staged per step
constexpr int kPL = kKC + 8;   // padded row of the [kTQ][kKC] probability tile
constexpr float kMask = -1e30f;

__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
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
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// 8 consecutive elements (16 bytes of bf16 / fp16, 32 of fp32) as floats.
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = to_f(h[i]);
}
template <>
__device__ __forceinline__ void load8<float>(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store8(float* dst, const float* f) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

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
// one CTA per (16 query rows, head, batch)
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) block_sparse_fwd_kernel(const Args a) {
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

  const T* qp = reinterpret_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* kptr = reinterpret_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const T* vptr = reinterpret_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[1];
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
  T* op = reinterpret_cast<T*>(a.out) + b * a.os[0] + h * a.os[1] + (long long)qpos * a.os[2];
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    T* dst = op + cg * 4 + 32 * n;
    dst[0] = from_f<T>(acc[n].x / l_safe);
    dst[1] = from_f<T>(acc[n].y / l_safe);
    dst[2] = from_f<T>(acc[n].z / l_safe);
    dst[3] = from_f<T>(acc[n].w / l_safe);
  }
}

__host__ __device__ inline size_t smem_bytes(int d) {
  return ((size_t)kTQ * (d + 4) + 2 * (size_t)kKC * (d + 4) + (size_t)kTQ * kPL) * sizeof(float);
}

template <int D, typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes(D);
  void (*kern)(const Args) = block_sparse_fwd_kernel<D, T>;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(a.L / kTQ, a.H, a.B), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, int d, cudaStream_t stream) {
  if (d == 128) return launch<128, T>(a, stream);
  if (d == 64) return launch<64, T>(a, stream);
  if (d == 32) return launch<32, T>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out [B, H, L, d] through its strides, in q's dtype (dtype 0 bf16, 1 fp16,
// 2 fp32). strides: 12 int64, the (batch, head, row) strides of q, k, v and
// out in elements. lut [H, L / block, A] and nvalid [H, L / block] int32;
// rpe, kp, am fp32 or null; kp_mul / am_mul select 'mul' mode. block must
// be a multiple of 16 that divides L, and d 32, 64 or 128.
int ds_block_sparse_fwd(const void* q, const void* k, const void* v, void* out, const int* lut,
                        const int* nvalid, const float* rpe, const float* kp, const float* am,
                        const long long* strides, int B, int H, int L, int d, int block, int A,
                        int causal, float scale, int kp_mul, int am_mul, int dtype,
                        void* stream) {
  if (B < 1 || H < 1 || B > 65535 || H > 65535 || block < kTQ || block % kTQ != 0 ||
      L < block || L % block != 0 || A < 1)
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
  if (dtype == 0) return (int)launch_d<__nv_bfloat16>(a, d, st);
  if (dtype == 1) return (int)launch_d<__half>(a, d, st);
  if (dtype == 2) return (int)launch_d<float>(a, d, st);
  return (int)cudaErrorInvalidValue;
}

const char* ds_block_sparse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory of one CTA at head_dim d.
long long ds_block_sparse_smem_bytes(int d) { return (long long)smem_bytes(d); }

}  // extern "C"
