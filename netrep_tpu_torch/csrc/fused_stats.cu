// Fused preservation statistics: gather + the seven statistics + exceedance
// tallies, one thread block per (permutation b, module k) cell.
//
// Replaces the Pallas mega-kernel `_kernel` of netrep_tpu/ops/fused_stats.py
// (:135, launched by `_call` :250 through `fused_stats_values` :345 and
// `fused_stats_counts` :363). It computes what that kernel computes —
// `module_stats_masked` with the fixed-count power-iteration summary — but
// is laid out for Hopper rather than carried over block by block:
//
// * The TPU kernel DMAs the module's cap rows into an 8 MiB VMEM window and
//   selects columns with one-hot MXU products. A Hopper block has at most
//   227 KB of shared memory, and one f32 224x224 submatrix is already
//   200 KB (corr + net: 400 KB). So only the data slice (cap x s floats,
//   115 KB at cap 224, s 128) stays resident; the correlation and network
//   entries are read straight from global memory (L2) in two row sweeps.
// * masked_pearson is two-pass (means, then centred products), as in
//   netrep_tpu/ops/stats.py:49-64. The second sweep re-reads the
//   correlation entries instead of holding the submatrix.
// * The power iteration runs as v <- Z^T (Z v) on the resident data instead
//   of forming the cap x cap Gram matrix (which would not fit). In exact
//   arithmetic the two are the same map; in f32 they round differently, by
//   about 1e-7 relative per step, and the iteration does not amplify it
//   (each step is linear and renormalised). chip_smoke.py holds the kernel
//   to its plain version at 1e-4 absolute on every statistic.
// * Every reduction is a fixed warp-shuffle tree plus a fixed-order sum over
//   warps, so a cell's statistics do not depend on scheduling. The counts
//   compare the very values this block writes, and integer atomics commute,
//   so hi == sum((values >= obs) & pvalid) holds bit for bit.
//
// What bounds it: per cell the kernel reads m(m-1) scattered correlation
// entries (and as many network entries when the network is stored), each
// from its own 32-byte sector, plus m contiguous data rows of s floats,
// and does ~15 m(m-1) + (4 n_iter + 12) s m floating-point operations,
// most of them in the power iteration. At the main path's shapes (m
// 30-200, s 128, n_iter 60, stored network) the sector traffic at
// 3.35 TB/s takes about five times as long as the operations at the card's
// 67 TFLOP/s scalar f32 rate: the bound is bytes. chip_smoke.py computes
// both from each run's module sizes and prints the kernel's distance from
// the bound; this first version makes no attempt to close it (no cp.async
// or TMA, one 120 KB block per SM at cap 224, 4-byte scattered loads).

#include <cuda_runtime.h>
#include <math.h>

#define NT 256
#define NWARP (NT / 32)
#define NQ_MAX 8
#define N_STATS 7
#define EPS 1e-30f

enum { NET_STORED = -1, NET_UNSIGNED = 0, NET_SIGNED = 1, NET_HYBRID = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Sums NQ per-thread values over the block: a warp tree, then warps in a
// fixed order. Every thread gets the totals in out[0..NQ).
template <int NQ>
__device__ __forceinline__ void block_sum(float (&v)[NQ], float* red,
                                          float* out) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
    for (int q = 0; q < NQ; ++q) v[q] = warp_sum(v[q]);
    if (lane == 0) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) red[wid * NQ_MAX + q] = v[q];
    }
    __syncthreads();
    if (threadIdx.x < NQ) {
        float acc = 0.f;
        for (int w = 0; w < NWARP; ++w) acc += red[w * NQ_MAX + threadIdx.x];
        out[threadIdx.x] = acc;
    }
    __syncthreads();
}

__device__ __forceinline__ float derived(float c, int kind, float beta) {
    if (kind == NET_SIGNED) return powf(fmaxf((1.f + c) * 0.5f, 0.f), beta);
    if (kind == NET_HYBRID) return powf(fmaxf(c, 0.f), beta);
    return powf(fabsf(c), beta);
}

// masked_pearson of x (global, length m) and y (shared) under mask w.
__device__ float block_pearson(const float* __restrict__ x, const float* y,
                               const float* w, int m, float* red, float* sc) {
    float a[3] = {0.f, 0.f, 0.f};
    for (int i = threadIdx.x; i < m; i += NT) {
        a[0] += x[i] * w[i];
        a[1] += y[i] * w[i];
        a[2] += w[i];
    }
    block_sum<3>(a, red, sc);
    const float nw = fmaxf(sc[2], EPS);
    const float mx = sc[0] / nw, my = sc[1] / nw;
    __syncthreads();
    float b[3] = {0.f, 0.f, 0.f};
    for (int i = threadIdx.x; i < m; i += NT) {
        const float xc = (x[i] * w[i] - mx) * w[i];
        const float yc = (y[i] * w[i] - my) * w[i];
        b[0] += xc * yc;
        b[1] += xc * xc;
        b[2] += yc * yc;
    }
    block_sum<3>(b, red, sc);
    const float denom = sqrtf(sc[1]) * sqrtf(sc[2]);
    const float r = denom > 0.f ? sc[0] / fmaxf(denom, EPS) : nanf("");
    __syncthreads();
    return r;
}

__global__ void __launch_bounds__(NT) fused_stats_kernel(
    const float* __restrict__ tc, const float* __restrict__ tn,
    const float* __restrict__ tdT, const float* __restrict__ dcorr,
    const float* __restrict__ dsign, const float* __restrict__ ddeg,
    const float* __restrict__ dcon, const float* __restrict__ dsgn,
    const float* __restrict__ dmask, const int* __restrict__ idx,
    const int* __restrict__ pvalid, const float* __restrict__ obs,
    float* __restrict__ vals, int* __restrict__ hi, int* __restrict__ lo,
    int* __restrict__ eff, int n, int s, int K, int cap, int n_iter,
    int net_kind, float beta, int counts) {
    extern __shared__ float smem[];
    const int cell = blockIdx.x;
    const int b = cell / K, k = cell - b * K;
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const bool has_data = tdT != nullptr;
    const int s1 = s > 0 ? s : 1;

    float* Z = smem;                              // cap * s (data mode)
    float* w = Z + (has_data ? cap * s : 0);      // cap
    float* deg = w + cap;                         // cap
    float* v = deg + cap;                         // cap
    float* nc = v + cap;                          // cap
    float* u = nc + cap;                          // s1
    float* an = u + s1;                           // s1
    float* red = an + s1;                         // NWARP * NQ_MAX
    float* sc = red + NWARP * NQ_MAX;             // NQ_MAX
    float* st = sc + NQ_MAX;                      // N_STATS
    int* sidx = reinterpret_cast<int*>(st + N_STATS + 1);  // cap

    for (int i = threadIdx.x; i < cap; i += NT) {
        // out-of-range slots clip like the TPU kernel's src_row; padded
        // slots are masked out below
        sidx[i] = min(max(idx[(size_t)cell * cap + i], 0), n - 1);
        w[i] = dmask[(size_t)k * cap + i];
    }
    __syncthreads();

    // ---- topology, sweep 1: sums for the means, degrees, avg.cor -------
    const float* dc_k = dcorr + (size_t)k * cap * cap;
    const float* ds_k = dsign + (size_t)k * cap * cap;
    float t1[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // sx, sy, snet, savg, npair
    for (int i = wid; i < cap; i += NWARP) {
        float drow = 0.f;
        if (w[i] != 0.f) {
            const float* rc = tc + (size_t)sidx[i] * n;
            const float* rn = tn ? tn + (size_t)sidx[i] * n : nullptr;
            for (int j = lane; j < cap; j += 32) {
                if (j == i || w[j] == 0.f) continue;
                const float c = rc[sidx[j]];
                const float net = rn ? rn[sidx[j]] : derived(c, net_kind, beta);
                t1[0] += dc_k[i * cap + j];
                t1[1] += c;
                t1[2] += net;
                t1[3] += ds_k[i * cap + j] * c;
                t1[4] += 1.f;
                drow += net;
            }
        }
        drow = warp_sum(drow);
        if (lane == 0) deg[i] = drow;
    }
    block_sum<5>(t1, red, sc);
    const float npair = fmaxf(sc[4], EPS);
    const float mx = sc[0] / npair, my = sc[1] / npair;
    const float avg_weight = sc[2] / npair;
    const float avg_cor = sc[3] / npair;
    __syncthreads();

    // ---- topology, sweep 2: centred products of cor.cor -----------------
    float t2[3] = {0.f, 0.f, 0.f};
    for (int i = wid; i < cap; i += NWARP) {
        if (w[i] == 0.f) continue;
        const float* rc = tc + (size_t)sidx[i] * n;
        for (int j = lane; j < cap; j += 32) {
            if (j == i || w[j] == 0.f) continue;
            const float xc = dc_k[i * cap + j] - mx;
            const float yc = rc[sidx[j]] - my;
            t2[0] += xc * yc;
            t2[1] += xc * xc;
            t2[2] += yc * yc;
        }
    }
    block_sum<3>(t2, red, sc);
    const float dcc = sqrtf(sc[1]) * sqrtf(sc[2]);
    const float cor_cor = dcc > 0.f ? sc[0] / fmaxf(dcc, EPS) : nanf("");
    __syncthreads();

    const float cor_degree =
        block_pearson(ddeg + (size_t)k * cap, deg, w, cap, red, sc);

    float coherence = nanf(""), cor_contrib = nanf(""), avg_contrib = nanf("");
    if (has_data) {
        // ---- resident data slice, standardized per node row -------------
        for (int i = wid; i < cap; i += NWARP) {
            float* zr = Z + (size_t)i * s;
            const float* src = tdT + (size_t)sidx[i] * s;
            const float wi = w[i];
            float sum = 0.f;
            for (int t = lane; t < s; t += 32) {
                const float d = src[t] * wi;
                zr[t] = d;
                sum += d;
            }
            const float mu = warp_sum(sum) / (float)s;
            float ss = 0.f;
            for (int t = lane; t < s; t += 32) {
                const float xc = zr[t] - mu;
                ss += xc * xc;
            }
            const float sd = sqrtf(warp_sum(ss) / (float)(s > 1 ? s - 1 : 1));
            for (int t = lane; t < s; t += 32) {
                const float xc = zr[t] - mu;
                zr[t] = (sd > 0.f ? xc / fmaxf(sd, EPS) : 0.f) * wi;
            }
        }
        float q1[1] = {0.f};
        for (int i = threadIdx.x; i < cap; i += NT) q1[0] += w[i] * w[i];
        block_sum<1>(q1, red, sc);
        const float wn = fmaxf(sqrtf(sc[0]), EPS);
        for (int i = threadIdx.x; i < cap; i += NT) v[i] = w[i] / wn;
        __syncthreads();

        // ---- power iteration: v <- w * Z^T (Z v), renormalised ----------
        for (int it = 0; it < n_iter; ++it) {
            for (int t = threadIdx.x; t < s; t += NT) {
                float acc = 0.f;
                for (int i = 0; i < cap; ++i) acc += Z[(size_t)i * s + t] * v[i];
                u[t] = acc;
            }
            __syncthreads();
            float ss[1] = {0.f};
            for (int i = wid; i < cap; i += NWARP) {
                const float* zr = Z + (size_t)i * s;
                float acc = 0.f;
                for (int t = lane; t < s; t += 32) acc += zr[t] * u[t];
                acc = warp_sum(acc) * w[i];
                if (lane == 0) {
                    nc[i] = acc;
                    ss[0] += acc * acc;
                }
            }
            block_sum<1>(ss, red, sc);
            const float vn = fmaxf(sqrtf(sc[0]), EPS);
            for (int i = threadIdx.x; i < cap; i += NT) v[i] = nc[i] / vn;
            __syncthreads();
        }

        // ---- summary profile, sign-anchored to the mean node profile ----
        float q2[1] = {0.f};
        for (int t = threadIdx.x; t < s; t += NT) {
            float p = 0.f, a = 0.f;
            for (int i = 0; i < cap; ++i) {
                const float z = Z[(size_t)i * s + t];
                p += z * v[i];
                a += z;
            }
            u[t] = p;
            an[t] = a;
            q2[0] += p * p;
        }
        block_sum<1>(q2, red, sc);
        const float pn = fmaxf(sqrtf(sc[0]), EPS);
        float q3[1] = {0.f};
        for (int t = threadIdx.x; t < s; t += NT) {
            u[t] = u[t] / pn;
            q3[0] += u[t] * an[t];
        }
        block_sum<1>(q3, red, sc);
        const float sgn = sc[0] > 0.f ? 1.f : (sc[0] < 0.f ? -1.f : 1.f);
        float q4[1] = {0.f};
        for (int t = threadIdx.x; t < s; t += NT) {
            u[t] *= sgn;
            q4[0] += u[t];
        }
        block_sum<1>(q4, red, sc);
        const float pmean = sc[0] / (float)s;
        float q5[1] = {0.f};
        for (int t = threadIdx.x; t < s; t += NT) {
            u[t] -= pmean;
            q5[0] += u[t] * u[t];
        }
        block_sum<1>(q5, red, sc);
        const float pcn = sqrtf(sc[0]);

        // ---- node contributions and the three data statistics -----------
        for (int i = wid; i < cap; i += NWARP) {
            const float* zr = Z + (size_t)i * s;
            float num = 0.f, xx = 0.f;
            for (int t = lane; t < s; t += 32) {
                num += zr[t] * u[t];
                xx += zr[t] * zr[t];
            }
            num = warp_sum(num);
            xx = warp_sum(xx);
            if (lane == 0) {
                const float denom = sqrtf(xx) * pcn;
                nc[i] = (denom > 0.f ? num / fmaxf(denom, EPS) : 0.f) * w[i];
            }
        }
        __syncthreads();
        const float* dsg_k = dsgn + (size_t)k * cap;
        float q6[3] = {0.f, 0.f, 0.f};
        for (int i = threadIdx.x; i < cap; i += NT) {
            q6[0] += nc[i] * nc[i] * w[i];
            q6[1] += dsg_k[i] * nc[i] * w[i];
            q6[2] += w[i];
        }
        block_sum<3>(q6, red, sc);
        const float nw = fmaxf(sc[2], EPS);
        coherence = sc[0] / nw;
        avg_contrib = sc[1] / nw;
        __syncthreads();
        cor_contrib = block_pearson(dcon + (size_t)k * cap, nc, w, cap, red, sc);
    }

    if (threadIdx.x == 0) {
        st[0] = avg_weight;
        st[1] = coherence;
        st[2] = cor_cor;
        st[3] = cor_degree;
        st[4] = cor_contrib;
        st[5] = has_data ? avg_cor : nanf("");
        st[6] = avg_contrib;
    }
    __syncthreads();
    if (threadIdx.x < N_STATS) {
        const int q = threadIdx.x;
        const float x = st[q];
        vals[(size_t)cell * N_STATS + q] = x;
        if (counts && pvalid[b] > 0) {
            const float ob = obs[k * N_STATS + q];
            // NaN compares false on both tails
            if (x >= ob) atomicAdd(&hi[k * N_STATS + q], 1);
            if (x <= ob) atomicAdd(&lo[k * N_STATS + q], 1);
            if (!isnan(x)) atomicAdd(&eff[k * N_STATS + q], 1);
        }
    }
}

extern "C" size_t fused_stats_smem_bytes(int cap, int s, int has_data) {
    const int s1 = s > 0 ? s : 1;
    return sizeof(float) * ((has_data ? (size_t)cap * s : 0) + 4 * (size_t)cap +
                            2 * (size_t)s1 + NWARP * NQ_MAX + NQ_MAX +
                            N_STATS + 1) +
           sizeof(int) * (size_t)cap;
}

extern "C" const char* fused_stats_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Launches one block per (b, k) cell on `stream`; returns cudaGetLastError().
// tn, tdT and (outside counts mode) pvalid/obs/hi/lo/eff may be null.
extern "C" int fused_stats_launch(
    const float* tc, const float* tn, const float* tdT, const float* dcorr,
    const float* dsign, const float* ddeg, const float* dcon,
    const float* dsgn, const float* dmask, const int* idx, const int* pvalid,
    const float* obs, float* vals, int* hi, int* lo, int* eff, int n, int s,
    int B, int K, int cap, int n_iter, int net_kind, float beta, int counts,
    void* stream) {
    const size_t smem = fused_stats_smem_bytes(cap, s, tdT != nullptr);
    cudaError_t err = cudaFuncSetAttribute(
        fused_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (B > 0 && K > 0) {
        fused_stats_kernel<<<B * K, NT, smem, (cudaStream_t)stream>>>(
            tc, tn, tdT, dcorr, dsign, ddeg, dcon, dsgn, dmask, idx, pvalid,
            obs, vals, hi, lo, eff, n, s, K, cap, n_iter, net_kind, beta,
            counts);
    }
    return (int)cudaGetLastError();
}
