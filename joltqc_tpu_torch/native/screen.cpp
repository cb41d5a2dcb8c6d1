// Native task screening for the contracted J/K engine.
//
// Reference counterpart: the GPU screening kernel
// JoltQC jqc/backend/jk/screen_jk_tasks.cu (one thread per
// (tile_ij, tile_kl), Schwarz x density bound, two-sided fp32/fp64
// queue).  Here the task plan is built ON HOST once per density
// bound (scf/jk_contracted.py::_build_plan); the numpy version
// materializes the full candidate set (~10^8 rows at ~500 AOs) through
// several large temporaries, which dominates plan-build wall time on
// the single-core bench host.  This C++ kernel fuses candidate
// generation (sorted-q early exit), the six-block density refinement,
// tier routing, and symmetry weights into one streaming pass that
// emits only the kept tasks, split by precision tier.
//
// Contract (all arrays little-endian, caller-owned unless noted):
//   q1, q2          f32[P1], f32[P2]  pair log-Schwarz bounds,
//                                      DESCENDING (candidate order)
//   qv1, qv2        f32[P1], f32[P2]  bound values used for dq (may
//                                      equal q1/q2; differ for omega)
//   si1, sj1        i32[P1]           global shell ids of bra pairs
//   si2, sj2        i32[P2]           global shell ids of ket pairs
//   diag1, diag2    u8[P1], u8[P2]    shell-diagonal pair flags
//   dcond           f32[nbas*nbas]    log shell-block density bounds
//   same            whether bra and ket pair classes are the same list
//   log32_gen       candidate-generation cutoff (global-bound screen)
//   log32, log64    absolute keep / fp64-tier cutoffs on dq
// Output: one jqc_screen_result per tier holding i32 task index pairs
// (t1, t2), f32 weights, count, and max dq (for the limb-scale bound).
//
// Build: g++ -O3 -shared -fPIC (see joltqc_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

struct TierBuf {
    std::vector<int32_t> t1, t2;
    std::vector<float> w;
    float dqmax = -1e30f;
};

struct Result {
    // [0] = fp32 tier, [1] = df64 tier
    TierBuf tier[2];
    int64_t cand = 0, cand64 = 0;
};

inline float max6(float a, float b, float c, float d, float e, float f) {
    float m = a > b ? a : b;
    m = m > c ? m : c;
    m = m > d ? m : d;
    m = m > e ? m : e;
    return m > f ? m : f;
}

}  // namespace

extern "C" {

// Opaque handle API: run the screen, query sizes, copy out, free.
void* jqc_screen_run(
    const float* q1, int64_t P1, const float* q2, int64_t P2,
    const float* qv1, const float* qv2,
    const int32_t* si1, const int32_t* sj1,
    const int32_t* si2, const int32_t* sj2,
    const uint8_t* diag1, const uint8_t* diag2,
    const float* dcond, int64_t nbas,
    int same, float log32_gen, float log64_gen,
    float log32, float log64, int refine) {
    Result* res = new Result();
    // rough reserve: sorted-q candidate count is cheap to precompute
    int64_t cand_total = 0;
    {
        // q2 descending: count = #{j : q2[j] > log32_gen - q1[i]}
        for (int64_t i = 0; i < P1; ++i) {
            float thr = log32_gen - q1[i];
            // binary search first index with q2[j] <= thr
            int64_t lo = 0, hi = P2;
            while (lo < hi) {
                int64_t mid = (lo + hi) >> 1;
                if (q2[mid] > thr) lo = mid + 1; else hi = mid;
            }
            int64_t cnt = lo;
            if (same && cnt > i + 1) cnt = i + 1;
            cand_total += cnt;
            if (q1[i] + q2[0] <= log32_gen && !same) break;  // sorted q1
        }
    }
    res->cand = cand_total;
    res->tier[0].t1.reserve(cand_total / 2);
    res->tier[1].t1.reserve(cand_total / 4);

    for (int64_t i = 0; i < P1; ++i) {
        float q1i = q1[i];
        float thr = log32_gen - q1i;
        int64_t lo = 0, hi = P2;
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (q2[mid] > thr) lo = mid + 1; else hi = mid;
        }
        int64_t jmax = lo;
        if (same && jmax > i + 1) jmax = i + 1;
        if (jmax == 0) continue;
        const float qv1i = qv1[i];
        // pad shells carry shell_id = -1: wrap negatives like numpy
        // fancy indexing does (D[-1] = last row), keeping bit parity
        // with the numpy fallback and all reads in bounds
        int64_t a = si1[i], b = sj1[i];
        if (a < 0) a += nbas;
        if (b < 0) b += nbas;
        const float* Da = dcond + a * nbas;
        const float* Db = dcond + b * nbas;
        const float Dab = Da[b];
        const float wi = diag1[i] ? 0.5f : 1.0f;
        for (int64_t j = 0; j < jmax; ++j) {
            float dq = qv1i + qv2[j];
            if (refine) {
                int64_t c = si2[j], d = sj2[j];
                if (c < 0) c += nbas;
                if (d < 0) d += nbas;
                const float dmx = max6(
                    Dab, dcond[c * nbas + d],
                    Da[c], Da[d], Db[c], Db[d]);
                dq += dmx;
                if (dq <= log32) continue;
            }
            int tier = dq > (refine ? log64 : log64_gen) ? 1 : 0;
            if (!refine) {
                // non-refined: generation cutoff already applied via jmax;
                // count it as kept
                if (q1i + q2[j] <= log32_gen) continue;
            }
            float w = wi * (diag2[j] ? 0.5f : 1.0f);
            if (same && i == j) w *= 0.5f;
            TierBuf& tb = res->tier[tier];
            tb.t1.push_back((int32_t)i);
            tb.t2.push_back((int32_t)j);
            tb.w.push_back(w);
            if (dq > tb.dqmax) tb.dqmax = dq;
        }
    }
    // cand64: candidates that the GLOBAL bound would have routed to fp64
    // (for plan_stats parity with the numpy path)
    int64_t c64 = 0;
    for (int64_t i = 0; i < P1; ++i) {
        float thr64 = log64_gen - q1[i];
        int64_t lo = 0, hi = P2;
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (q2[mid] > thr64) lo = mid + 1; else hi = mid;
        }
        int64_t cnt = lo;
        if (same && cnt > i + 1) cnt = i + 1;
        c64 += cnt;
    }
    res->cand64 = c64;
    return res;
}

int64_t jqc_screen_count(void* h, int tier) {
    return ((Result*)h)->tier[tier].t1.size();
}

float jqc_screen_dqmax(void* h, int tier) {
    return ((Result*)h)->tier[tier].dqmax;
}

int64_t jqc_screen_cand(void* h) { return ((Result*)h)->cand; }
int64_t jqc_screen_cand64(void* h) { return ((Result*)h)->cand64; }

void jqc_screen_copy(void* h, int tier, int32_t* t1, int32_t* t2, float* w) {
    TierBuf& tb = ((Result*)h)->tier[tier];
    std::memcpy(t1, tb.t1.data(), tb.t1.size() * sizeof(int32_t));
    std::memcpy(t2, tb.t2.data(), tb.t2.size() * sizeof(int32_t));
    std::memcpy(w, tb.w.data(), tb.w.size() * sizeof(float));
}

void jqc_screen_free(void* h) { delete (Result*)h; }

}  // extern "C"
