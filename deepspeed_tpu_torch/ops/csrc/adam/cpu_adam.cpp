// Fused host-side Adam/AdamW: the ZeRO-Offload optimizer that updates fp32
// master weights and moments in host RAM while the card keeps the compute
// parameters (the reference's csrc/adam/cpu_adam.cpp + cpu_adam_impl.cpp).
// Vectorization comes from -O3 -march=native on the flat loops; threading
// splits the flat range across std::threads. The arithmetic is the JAX
// package's copy of this file, line for line, so both packages' host updates
// agree bit for bit when built with the same flags.
//
// C ABI (loaded with ctypes). An optimizer registry keyed by optimizer_id
// mirrors the reference create_adam/ds_adam_step interface.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct AdamConfig {
    float lr;
    float beta1;
    float beta2;
    float eps;
    float weight_decay;
    bool adamw_mode;  // true: decoupled decay (AdamW); false: L2 into grad
};

std::mutex g_mu;
std::unordered_map<int, AdamConfig> g_optimizers;

// round-to-nearest-even float32 -> bfloat16 (bit pattern), matching XLA
inline uint16_t float_to_bf16(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    uint32_t lsb = (x >> 16) & 1;
    uint32_t rounded = x + 0x7fff + lsb;
    return static_cast<uint16_t>(rounded >> 16);
}

void adam_chunk(const AdamConfig& cfg, int64_t begin, int64_t end, int64_t step, float* params, const float* grads,
                float* exp_avg, float* exp_avg_sq, uint16_t* bf16_out, float grad_scale) {
    const float b1 = cfg.beta1, b2 = cfg.beta2;
    const float bias1 = 1.0f - std::pow(b1, static_cast<float>(step));
    const float bias2 = 1.0f - std::pow(b2, static_cast<float>(step));
    const float step_size = cfg.lr / bias1;
    const float inv_sqrt_bias2 = 1.0f / std::sqrt(bias2);
    const float decay = cfg.weight_decay;

#pragma omp simd
    for (int64_t i = begin; i < end; ++i) {
        float g = grads[i] * grad_scale;
        if (!cfg.adamw_mode && decay != 0.0f) g += decay * params[i];
        float m = b1 * exp_avg[i] + (1.0f - b1) * g;
        float v = b2 * exp_avg_sq[i] + (1.0f - b2) * g * g;
        exp_avg[i] = m;
        exp_avg_sq[i] = v;
        float denom = std::sqrt(v) * inv_sqrt_bias2 + cfg.eps;
        float p = params[i];
        if (cfg.adamw_mode && decay != 0.0f) p -= cfg.lr * decay * p;
        p -= step_size * m / denom;
        params[i] = p;
        if (bf16_out) bf16_out[i] = float_to_bf16(p);
    }
}

}  // namespace

extern "C" {

int ds_adam_create(int optimizer_id, float lr, float beta1, float beta2, float eps, float weight_decay,
                   int adamw_mode) {
    std::lock_guard<std::mutex> lk(g_mu);
    g_optimizers[optimizer_id] = AdamConfig{lr, beta1, beta2, eps, weight_decay, adamw_mode != 0};
    return 0;
}

int ds_adam_destroy(int optimizer_id) {
    std::lock_guard<std::mutex> lk(g_mu);
    return g_optimizers.erase(optimizer_id) ? 0 : -1;
}

// One fused Adam step over a flat range. step is 1-based (bias correction).
// lr < 0 keeps the configured lr (so schedules can drive it per step).
// bf16_out != nullptr also emits bf16 copies of the new params for device
// upload (the reference's ds_adam_step_plus_copy).
int ds_adam_step(int optimizer_id, long long step, long long n, float* params, const float* grads, float* exp_avg,
                 float* exp_avg_sq, float lr, float grad_scale, unsigned short* bf16_out, int n_threads) {
    AdamConfig cfg;
    {
        std::lock_guard<std::mutex> lk(g_mu);
        auto it = g_optimizers.find(optimizer_id);
        if (it == g_optimizers.end()) return -1;
        cfg = it->second;
    }
    if (lr >= 0.0f) cfg.lr = lr;
    if (n <= 0) return 0;

    int hw = static_cast<int>(std::thread::hardware_concurrency());
    int nt = n_threads > 0 ? n_threads : (hw > 0 ? hw : 1);
    int64_t min_chunk = 1 << 16;
    nt = static_cast<int>(std::min<int64_t>(nt, (n + min_chunk - 1) / min_chunk));
    if (nt <= 1) {
        adam_chunk(cfg, 0, n, step, params, grads, exp_avg, exp_avg_sq, bf16_out, grad_scale);
        return 0;
    }
    std::vector<std::thread> threads;
    int64_t per = (n + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
        int64_t b = t * per, e = std::min<int64_t>(n, b + per);
        if (b >= e) break;
        threads.emplace_back([&, b, e] {
            adam_chunk(cfg, b, e, step, params, grads, exp_avg, exp_avg_sq, bf16_out, grad_scale);
        });
    }
    for (auto& t : threads) t.join();
    return 0;
}

// fp32 -> bf16 conversion helper (device-upload staging)
void ds_fp32_to_bf16(const float* src, unsigned short* dst, long long n) {
#pragma omp simd
    for (int64_t i = 0; i < n; ++i) dst[i] = float_to_bf16(src[i]);
}

}  // extern "C"
