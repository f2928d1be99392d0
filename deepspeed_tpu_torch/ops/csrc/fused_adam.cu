// Fused, gated AdamW over many tensors in one launch, for Hopper (sm_90a).
//
// Plain C interface (loaded with ctypes by ops/_build.py); the launcher
// returns the cudaError_t of its launch and never synchronises.
//
// What it replaces: deepspeed_tpu/ops/pallas/fused_adam.py, _adam_leaf (:47)
// and the jnp chain it sends non-128-multiple leaves to (:90-99): one kernel
// serves leaves of any size. Per element, in fp32, with the TPU kernel's
// formulas and order:
//   g   = grad * grad_scale
//   m   = b1 * m + (1 - b1) * g
//   v   = b2 * v + (1 - b2) * g * g
//   upd = (m / bc1) / (sqrt(v / bc2) + eps) + wd * p
//   p   = p - lr * upd
// and where gate <= 0 (or is NaN) nothing is written: the overflow skip.
// lr, bc1 = 1 - b1^t, bc2 = 1 - b2^t, grad_scale and gate are read from a
// device array (the TPU kernel's SMEM scalars): they come from device-side
// reductions (the gradient norm, the finiteness check, the step counter),
// and reading them on the host would synchronise every step. Every
// operation is rounded on its own (__f*_rn: no contraction into FMAs), so
// the kernel computes exactly what the plain PyTorch version computes.
//
// Multi-tensor: a device table holds each tensor's pointers, its size and
// the index of its first chunk (64-bit offsets: the training state holds
// ~2e9 elements); CTA c finds its tensor by binary search over the chunk
// starts and updates one chunk of kChunk elements, with 16-byte vector
// accesses when the tensor's pointers allow them.
//
// What bounds it on the H100: 28 bytes per element (read g, p, m, v; write
// p, m, v) at 3.35 TB/s and ~20 FLOPs per element, so HBM bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 65536;

struct AdamTensor {  // mirrored by ops/fused_adam.py (8 int64 fields)
  long long p, m, v, g;  // device pointers
  long long n;           // elements
  long long chunk0;      // index of this tensor's first chunk
  long long g_bf16;      // 1: grad is bfloat16, 0: fp32
  long long vec;         // 1: every pointer allows 16-byte accesses
};

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ void adam_one(float& p, float& m, float& v, float g, const Hyper& h,
                                         float lr, float bc1, float bc2, float gscale) {
  g = __fmul_rn(g, gscale);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float upd = __fadd_rn(
      __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps)),
      __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, upd));
}

__global__ void __launch_bounds__(kThreads)
    fused_adam_kernel(const AdamTensor* __restrict__ tab, int n_tensors,
                      const float* __restrict__ scal, const Hyper h) {
  const float gate = scal[4];
  if (!(gate > 0.f)) return;
  const float lr = scal[0], bc1 = scal[1], bc2 = scal[2], gscale = scal[3];
  const long long chunk = blockIdx.x;
  int lo = 0, hi = n_tensors - 1;  // last tensor whose chunk0 <= chunk
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tab[mid].chunk0 <= chunk) lo = mid; else hi = mid - 1;
  }
  const AdamTensor t = tab[lo];
  const long long begin = (chunk - t.chunk0) * kChunk;
  const long long end = min(begin + kChunk, t.n);
  float* P = reinterpret_cast<float*>(t.p);
  float* M = reinterpret_cast<float*>(t.m);
  float* V = reinterpret_cast<float*>(t.v);
  const float* G32 = reinterpret_cast<const float*>(t.g);
  const __nv_bfloat16* G16 = reinterpret_cast<const __nv_bfloat16*>(t.g);
  long long i = begin;
  if (t.vec) {
    const long long end4 = begin + ((end - begin) / 4) * 4;
    for (long long j = begin + 4 * threadIdx.x; j < end4; j += 4 * kThreads) {
      float4 p = *reinterpret_cast<float4*>(P + j);
      float4 m = *reinterpret_cast<float4*>(M + j);
      float4 v = *reinterpret_cast<float4*>(V + j);
      float4 g;
      if (t.g_bf16) {
        g = make_float4(__bfloat162float(G16[j]), __bfloat162float(G16[j + 1]),
                        __bfloat162float(G16[j + 2]), __bfloat162float(G16[j + 3]));
      } else {
        g = *reinterpret_cast<const float4*>(G32 + j);
      }
      adam_one(p.x, m.x, v.x, g.x, h, lr, bc1, bc2, gscale);
      adam_one(p.y, m.y, v.y, g.y, h, lr, bc1, bc2, gscale);
      adam_one(p.z, m.z, v.z, g.z, h, lr, bc1, bc2, gscale);
      adam_one(p.w, m.w, v.w, g.w, h, lr, bc1, bc2, gscale);
      *reinterpret_cast<float4*>(P + j) = p;
      *reinterpret_cast<float4*>(M + j) = m;
      *reinterpret_cast<float4*>(V + j) = v;
    }
    i = end4;
  }
  for (long long j = i + threadIdx.x; j < end; j += kThreads) {
    float p = P[j], m = M[j], v = V[j];
    const float g = t.g_bf16 ? __bfloat162float(G16[j]) : G32[j];
    adam_one(p, m, v, g, h, lr, bc1, bc2, gscale);
    P[j] = p;
    M[j] = m;
    V[j] = v;
  }
}

}  // namespace

extern "C" {

// table: device array of n_tensors AdamTensor records (chunk0 ascending, the
// first 0); n_chunks: their total. scal: device fp32 [lr, bc1, bc2,
// grad_scale, gate]. omb1 / omb2: (1 - b1) and (1 - b2) as the caller rounds
// them.
int ds_fused_adam(const void* table, int n_tensors, long long n_chunks, const float* scal,
                  float b1, float omb1, float b2, float omb2, float eps, float wd, void* stream) {
  if (n_tensors < 1 || n_chunks < 1 || n_chunks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  fused_adam_kernel<<<(unsigned)n_chunks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const AdamTensor*>(table), n_tensors, scal, h);
  return (int)cudaGetLastError();
}

long long ds_fused_adam_chunk() { return kChunk; }

const char* ds_fused_adam_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
