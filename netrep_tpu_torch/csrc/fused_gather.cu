// Batched submatrix gather over any number of capacity buckets in one
// launch: out_b[g, a, c] = M[idx_b[g, a], idx_b[g, c]] for every bucket b's
// G_b index sets of cap_b slots, sentinel slots giving zero rows and zero
// columns.
//
// Replaces the Pallas kernel `_kernel` of netrep_tpu/ops/fused_gather.py
// (:190, launched by `_run` :238 through `pl.pallas_call` :274, behind
// `gather_submatrix_fused` :290 and `gather_submatrix_fused_local` :319).
// One source covers both entries through (row_start, rows_per, own_limit):
// output row (b, g, a) is owned iff 0 <= idx - row_start < rows_per and
// idx < own_limit, and is then read at M row idx - row_start; column c is
// valid iff 0 <= idx_b[g, c] < n_cols. An entry is M[...] when its row is
// owned and its column valid, else 0 — by select: an un-owned row or an
// invalid column is never read, so a NaN elsewhere in M cannot leak. Each
// output entry is written exactly once, by a copy (no atomics on values),
// so the result is bit-equal to the plain version.
//
// Which rows a launch writes (zero_mode): every row of every bucket, the
// un-owned ones as zeros (the block's additive share, ZERO_SHARE); or, into
// a caller's buffer that a set of launches over a partition of the rows
// [0, own_limit) fills together, only the rows this block owns — plus, in
// the launch whose row_start is 0, the rows no block owns (sentinels and
// idx >= own_limit) as zeros (ZERO_ORPHANS; the others ZERO_NONE). Each
// entry then has exactly one writer, so the assembly is exact.
//
// What bounded the first version: one launch per bucket, one block per
// (instance, 32 output rows), each lane a scattered 4-byte __ldg per
// output entry. Each costs a 32-byte DRAM sector, and an H100 serves
// scattered sectors at ~31 G/s (~1.0 TB/s of sectors, PERF.md): at
// chip_smoke.py's chunk (128 permutations x 50 modules, ~96 M real
// entries per matrix) that was 3.16 ms, 8x read amplification. Yet the demand is dense: those entries
// land on a 20,000 x 20,000 matrix of 50 M sectors, ~37 output rows per
// source row and chunk, once a chunk's buckets are taken together.
//
// This design walks M by source row, over all buckets of a chunk at once:
//   1. fused_gather_count: one thread per output row classifies it (owned
//      -> its block row, zero -> the extra key rows_per, else skipped) and
//      counts rows and demand (sum of caps) per key; a warp's equal keys
//      are merged first (__match_any_sync), so the ~100 K padded slots
//      that all read gene 0 cost a few thousand integer atomics;
//   2. fused_gather_scan (one block): exclusive scan over the keys, and
//      the work items — each key's rows cut into items of at most WMAX
//      output rows (row 0 must not serialise one block) — each marked
//      `stage` when its demand (rows x cap entries) covers at least
//      1/STAGE_DIV of the row's 32-byte sectors and the row fits in
//      shared memory;
//   3. fused_gather_fill: each output row's id into its key's list;
//   4. fused_gather_rows: a persistent grid walks the items in key order.
//      A staged item copies its source row once, coalesced (16-byte
//      cp.async), into shared memory (80 KB at 20,000 columns) and writes
//      each of its output rows, coalesced, from there through the
//      instance's column indices; an item in low demand reads the row in
//      place with __ldg, next to the other items of its row, so their
//      sectors are reused from L2. A row wider than a block's shared
//      memory (~57,000 float32 columns) is always read in place: no shape
//      is refused.
// No sort is used; the four kernels are one launch of the wrapper.
//
// What bounds it: the matrix rows in demand streamed once (1.6 GB at
// 20,000 genes, ~0.48 ms at 3.35 TB/s), the outputs written once (~0.48 GB
// per chunk and matrix at chip_smoke.py's shapes) and the work list. On
// an H100 (700 W) that chunk takes ~1.04 ms against 3.16 ms before: ~2 TB/s
// of rows and outputs, one block's row copy not yet overlapped with its
// writes (two blocks per SM at 80 KB of shared memory each).
//
// Crossover (chip_smoke.py gather_times, the chunk cut to 4-128
// permutations, every row forced in place or staged): staging pays from a
// mean demand of ~0.45 of a row's sectors (0.30: 0.50 ms in place, 0.67
// staged; 0.60: 0.87 in place, 0.71 staged). Deciding per item at a third
// (STAGE_DIV 3) is below both forced choices from 16 permutations up and
// within 1% of the better one below that.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 512            // threads of a fused_gather_rows block
#define NWARP (NT / 32)
#define CNT_NT 256        // threads of a count / fill block
#define SCAN_NT 1024      // threads of the one scan block (32 warps)
#define WMAX 128          // output rows of one work item
#define UNROLL 4          // entries a lane loads before it stores any
#define TAB 4             // int64 fields per bucket: idx, out, cap, first row
#define SMEM_LIMIT 232448 // dynamic + static shared memory of one H100 block
#define FULL 0xffffffffu

enum { ZERO_SHARE = 0, ZERO_ORPHANS = 1, ZERO_NONE = 2 };

typedef unsigned long long u64;

// The bucket of global output row gid: the largest b whose first row is
// <= gid (buckets hold at least one row each).
__device__ __forceinline__ int find_bucket(const long long* __restrict__ tab,
                                           int nb, long long gid) {
    int lo = 0, hi = nb - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (__ldg(tab + TAB * mid + 3) <= gid) lo = mid; else hi = mid - 1;
    }
    return lo;
}

struct Row {
    const int* ig;  // the instance's cap column indices
    float* dst;     // the output row
    int cap;
    int src;        // idx_b[g, a]: the M row it reads
};

__device__ __forceinline__ Row decode(const long long* __restrict__ tab,
                                      int nb, long long gid) {
    const int b = find_bucket(tab, nb, gid);
    const int* idx = reinterpret_cast<const int*>(__ldg(tab + TAB * b));
    float* out = reinterpret_cast<float*>(__ldg(tab + TAB * b + 1));
    const int cap = (int)__ldg(tab + TAB * b + 2);
    const long long local = gid - __ldg(tab + TAB * b + 3);
    Row r;
    r.cap = cap;
    r.ig = idx + (local / cap) * cap;
    r.dst = out + local * cap;
    r.src = __ldg(idx + local);
    return r;
}

// The key of an output row reading M row `src`: its block row when owned,
// rows_per for a row written as zeros, -1 for a row this launch skips.
__device__ __forceinline__ int classify(int src, long long row_start,
                                        int rows_per, int own_limit,
                                        int zero_mode) {
    const long long rel = (long long)src - row_start;
    if (rel >= 0 && rel < rows_per && src < own_limit) return (int)rel;
    if (zero_mode == ZERO_SHARE ||
        (zero_mode == ZERO_ORPHANS && (src < 0 || src >= own_limit)))
        return rows_per;
    return -1;
}

__global__ void __launch_bounds__(CNT_NT) fused_gather_count(
    const long long* __restrict__ tab, int nb, long long total,
    long long row_start, int rows_per, int own_limit, int zero_mode,
    u64* __restrict__ cnt, u64* __restrict__ dem) {
    const long long gid = (long long)blockIdx.x * CNT_NT + threadIdx.x;
    int key = -1;
    unsigned cap = 0;
    if (gid < total) {
        const Row r = decode(tab, nb, gid);
        key = classify(r.src, row_start, rows_per, own_limit, zero_mode);
        cap = (unsigned)r.cap;
    }
    const unsigned active = __ballot_sync(FULL, key >= 0);
    if (key >= 0) {
        const unsigned grp = __match_any_sync(active, key);
        const unsigned caps = __reduce_add_sync(grp, cap);
        if ((int)(threadIdx.x & 31) == __ffs(grp) - 1) {
            atomicAdd(cnt + key, (u64)__popc(grp));
            atomicAdd(dem + key, (u64)caps);
        }
    }
}

// One block: exclusive scan of the per-key row counts into the fill
// cursors, and the work items. Thread t owns a contiguous run of keys.
__global__ void __launch_bounds__(SCAN_NT) fused_gather_scan(
    const u64* __restrict__ cnt, const u64* __restrict__ dem, int keys,
    int rows_per, u64* __restrict__ cur, longlong2* __restrict__ spans,
    int2* __restrict__ kinds, u64* __restrict__ n_items, int stage_ok,
    long long sectors, int stage_div) {
    __shared__ u64 s_a[SCAN_NT / 32], s_b[SCAN_NT / 32];
    const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
    const int seg = (keys + SCAN_NT - 1) / SCAN_NT;
    const int k0 = min(t * seg, keys), k1 = min(k0 + seg, keys);
    u64 a = 0, b = 0;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
        const u64 c = cnt[k];
        a += c;
        b += (c + WMAX - 1) / WMAX;
    }
    u64 ia = a, ib = b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const u64 ya = __shfl_up_sync(FULL, ia, o);
        const u64 yb = __shfl_up_sync(FULL, ib, o);
        if (lane >= o) { ia += ya; ib += yb; }
    }
    if (lane == 31) { s_a[wid] = ia; s_b[wid] = ib; }
    __syncthreads();
    if (wid == 0) {
        u64 va = s_a[lane], vb = s_b[lane];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const u64 ya = __shfl_up_sync(FULL, va, o);
            const u64 yb = __shfl_up_sync(FULL, vb, o);
            if (lane >= o) { va += ya; vb += yb; }
        }
        s_a[lane] = va;
        s_b[lane] = vb;
    }
    __syncthreads();
    u64 ea = ia - a + (wid ? s_a[wid - 1] : 0);
    u64 eb = ib - b + (wid ? s_b[wid - 1] : 0);
    for (int k = k0; k < k1; ++k) {
        const u64 c = cnt[k];
        cur[k] = ea;
        if (c) {
            const u64 d = dem[k];
            for (u64 s = 0; s < c; s += WMAX) {
                const u64 e = min(s + (u64)WMAX, c);
                const u64 want = d * (e - s) / c;  // entries this item reads
                const int stage = stage_ok && k < rows_per &&
                                  want * (u64)stage_div >= (u64)sectors;
                spans[eb] = make_longlong2((long long)(ea + s),
                                           (long long)(ea + e));
                kinds[eb] = make_int2(k, stage);
                ++eb;
            }
        }
        ea += c;
    }
    if (t == SCAN_NT - 1) *n_items = eb;
}

__global__ void __launch_bounds__(CNT_NT) fused_gather_fill(
    const long long* __restrict__ tab, int nb, long long total,
    long long row_start, int rows_per, int own_limit, int zero_mode,
    u64* __restrict__ cur, long long* __restrict__ entries) {
    const long long gid = (long long)blockIdx.x * CNT_NT + threadIdx.x;
    int key = -1;
    if (gid < total) {
        const Row r = decode(tab, nb, gid);
        key = classify(r.src, row_start, rows_per, own_limit, zero_mode);
    }
    const unsigned active = __ballot_sync(FULL, key >= 0);
    if (key >= 0) {
        const int lane = threadIdx.x & 31;
        const unsigned grp = __match_any_sync(active, key);
        const int leader = __ffs(grp) - 1;
        u64 base = 0;
        if (lane == leader) base = atomicAdd(cur + key, (u64)__popc(grp));
        base = __shfl_sync(grp, base, leader);
        entries[base + __popc(grp & ((1u << lane) - 1u))] = gid;
    }
}

// The block copies M row `src` into shared memory: 16-byte cp.async where
// the row is 16-byte aligned, 4-byte otherwise; every copy is in flight
// before the block waits.
__device__ __forceinline__ void stage_row(float* srow,
                                          const float* __restrict__ src,
                                          int n_cols, int vec) {
    const unsigned base = (unsigned)__cvta_generic_to_shared(srow);
    if (vec) {
        for (int i = threadIdx.x; i < (n_cols >> 2); i += NT)
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
                             "r"(base + 16u * i), "l"(src + 4 * i));
    } else {
        for (int i = threadIdx.x; i < n_cols; i += NT)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
                             "r"(base + 4u * i), "l"(src + i));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One warp writes one output row from `row` (shared memory when SHARED,
// else M's row in place), UNROLL loads in flight per lane.
template <bool SHARED>
__device__ __forceinline__ void write_row(const Row& r,
                                          const float* __restrict__ row,
                                          int n_cols, int lane) {
    for (int c0 = lane; c0 < r.cap; c0 += 32 * UNROLL) {
        float v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int c = c0 + 32 * u;
            const int col = c < r.cap ? __ldg(r.ig + c) : -1;
            const bool ok = col >= 0 && col < n_cols;
            v[u] = ok ? (SHARED ? row[col] : __ldg(row + col)) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int c = c0 + 32 * u;
            if (c < r.cap) r.dst[c] = v[u];
        }
    }
}

__global__ void __launch_bounds__(NT) fused_gather_rows(
    const float* __restrict__ M, const long long* __restrict__ tab, int nb,
    const long long* __restrict__ entries,
    const longlong2* __restrict__ spans, const int2* __restrict__ kinds,
    const u64* __restrict__ n_items_p, int rows_per, int n_cols, int vec) {
    extern __shared__ float4 srow4[];
    float* srow = reinterpret_cast<float*>(srow4);
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const long long n_items = (long long)*n_items_p;
    for (long long it = blockIdx.x; it < n_items; it += gridDim.x) {
        const int2 kd = kinds[it];
        const longlong2 sp = spans[it];
        const int key = kd.x;
        const bool stage = kd.y != 0;
        // 64-bit row offset: at n >= 46,341 the flat index passes 2^31
        const float* src = M + (long long)key * n_cols;
        if (stage) {
            stage_row(srow, src, n_cols, vec);
            __syncthreads();
        }
        for (long long e = sp.x + wid; e < sp.y; e += NWARP) {
            const Row r = decode(tab, nb, entries[e]);
            if (key == rows_per) {
                for (int c = lane; c < r.cap; c += 32) r.dst[c] = 0.f;
            } else if (stage) {
                write_row<true>(r, srow, n_cols, lane);
            } else {
                write_row<false>(r, src, n_cols, lane);
            }
        }
        if (stage) __syncthreads();  // before the next item overwrites srow
    }
}

extern "C" const char* fused_gather_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

struct Scratch {
    u64 *dem, *cnt, *cur, *n_items;
    longlong2* spans;
    int2* kinds;
    long long* entries;
    long long bytes;
};

static Scratch carve(char* base, int rows_per, long long total) {
    const long long keys = (long long)rows_per + 1;
    const long long items = keys + total / WMAX + 1;
    Scratch s;
    long long at = 0;
    s.dem = reinterpret_cast<u64*>(base + at);
    at += 8 * keys;
    s.cnt = reinterpret_cast<u64*>(base + at);
    at += 8 * keys;
    s.cur = reinterpret_cast<u64*>(base + at);
    at += 8 * keys;
    s.n_items = reinterpret_cast<u64*>(base + at);
    at = (at + 16 + 15) / 16 * 16;  // spans are 16-byte vectors
    s.spans = reinterpret_cast<longlong2*>(base + at);
    at += 16 * items;
    s.kinds = reinterpret_cast<int2*>(base + at);
    at += 8 * items;
    s.entries = reinterpret_cast<long long*>(base + at);
    at += 8 * total;
    s.bytes = at;
    return s;
}

// Bytes of device scratch one launch needs (the wrapper allocates them).
extern "C" long long fused_gather_scratch_bytes(int rows_per,
                                                long long total) {
    return carve(nullptr, rows_per, total).bytes;
}

// Launches the gather of nb buckets on `stream`; returns the first CUDA
// error. M is (rows_per, n_cols) row-major float32 holding global rows
// [row_start, row_start + rows_per); tab is a device array of nb * TAB
// int64 (bucket b: its (G_b, cap_b) int32 indices, its (G_b, cap_b, cap_b)
// float32 output, cap_b, its first global output row), every bucket with
// at least one row, `total` = sum of G_b * cap_b; scratch holds
// fused_gather_scratch_bytes(rows_per, total) bytes, 16-byte aligned.
extern "C" int fused_gather_launch(const float* M, const long long* tab,
                                   int nb, long long total, int rows_per,
                                   int n_cols, long long row_start,
                                   int own_limit, int zero_mode,
                                   int stage_div, void* scratch,
                                   void* stream_) {
    if (nb <= 0 || total <= 0) return 0;
    cudaStream_t stream = (cudaStream_t)stream_;
    const Scratch s = carve((char*)scratch, rows_per, total);
    const int keys = rows_per + 1;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fused_gather_rows);
    if (err != cudaSuccess) return (int)err;
    const long long row_bytes = ((long long)n_cols * 4 + 15) / 16 * 16;
    const int stage_ok = row_bytes + (long long)attr.sharedSizeBytes <=
                         SMEM_LIMIT;
    const int smem = stage_ok ? (int)row_bytes : 0;
    err = cudaFuncSetAttribute(fused_gather_rows,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_gather_rows, NT, smem);
    if (err != cudaSuccess) return (int)err;
    const int vec = n_cols % 4 == 0 && ((uintptr_t)M & 15) == 0;
    const long long sectors = ((long long)n_cols * 4 + 31) / 32;
    const unsigned grid_rows = (unsigned)((total + CNT_NT - 1) / CNT_NT);

    err = cudaMemsetAsync(s.dem, 0, 16 * (size_t)keys, stream);  // dem, cnt
    if (err != cudaSuccess) return (int)err;
    fused_gather_count<<<grid_rows, CNT_NT, 0, stream>>>(
        tab, nb, total, row_start, rows_per, own_limit, zero_mode, s.cnt,
        s.dem);
    fused_gather_scan<<<1, SCAN_NT, 0, stream>>>(
        s.cnt, s.dem, keys, rows_per, s.cur, s.spans, s.kinds, s.n_items,
        stage_ok, sectors, stage_div);
    fused_gather_fill<<<grid_rows, CNT_NT, 0, stream>>>(
        tab, nb, total, row_start, rows_per, own_limit, zero_mode, s.cur,
        s.entries);
    fused_gather_rows<<<sms * (per_sm > 0 ? per_sm : 1), NT, smem, stream>>>(
        M, tab, nb, s.entries, s.spans, s.kinds, s.n_items, rows_per, n_cols,
        vec);
    return (int)cudaGetLastError();
}
