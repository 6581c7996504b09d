// Batched submatrix gather: out[g, a, b] = M[idx[g, a], idx[g, b]] for G
// index sets of `cap` slots each, with sentinel slots giving zero rows and
// zero columns.
//
// Replaces the Pallas kernel `_kernel` of netrep_tpu/ops/fused_gather.py
// (:190, launched by `_run` :238 through `gather_submatrix_fused` :290 and
// `gather_submatrix_fused_local` :319). One source covers both entries
// through the (row_start, rows_per, own_limit) triple:
//
// * replicated: row_start 0, rows_per n_rows, own_limit n_rows — slot a is
//   owned iff 0 <= idx[g, a] < n_rows;
// * local (one row block of a matrix split by rows): slot a is owned iff
//   0 <= idx[g, a] - row_start < rows_per and idx[g, a] < own_limit
//   (= n_cols, fused_gather.py:337-339); the block is read at row
//   idx[g, a] - row_start. The result is this block's additive share: the
//   sum over the row blocks is the replicated gather.
//
// Column b is valid iff 0 <= idx[g, b] < n_cols. An entry is written as
// M[...] when its row is owned and its column valid, else 0 — by select,
// never by multiplying, and an un-owned or invalid slot is never read, so a
// NaN elsewhere in M cannot leak into the output.
//
// The TPU kernel DMAs whole rows into VMEM and selects columns with one-hot
// MXU products (hence its hi/lo split for f32 exactness and its VMEM
// row-block policy). None of that is carried over: on Hopper a gather is a
// copy, exact by construction.
//
// Layout: one block per (instance g, tile of ROWS_PER_BLOCK output rows).
// The instance's cap column indices are staged once in shared memory, with
// an invalid column stored as -1. Each warp then writes whole output rows:
// its lanes stride over b, so the writes are coalesced 128-byte lines and
// the reads are scattered 4-byte loads within one row of M (n_cols * 4 =
// 80 KB at 20,000 genes).
//
// What bounds it: each gathered entry costs one 32-byte DRAM sector read
// (neighbouring columns of one module rarely share a sector) and 4 bytes
// written. At chip_smoke.py's shapes (Σ cap² = 945,152 per permutation,
// 128 permutations) that is 4.36 GB per chunk and matrix, ~1.30 ms at
// 3.35 TB/s. This first version issues plain loads, one per lane, and
// leaves the latency of the scattered sectors to the number of warps in
// flight.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256
#define NWARP (NT / 32)
#define ROWS_PER_BLOCK 32

__global__ void __launch_bounds__(NT) fused_gather_kernel(
    const float* __restrict__ M, const int* __restrict__ idx,
    float* __restrict__ out, int n_cols, long long row_start, int rows_per,
    int own_limit, int cap) {
    extern __shared__ int scol[];
    const int g = blockIdx.x;
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int* ig = idx + (size_t)g * cap;
    for (int b = threadIdx.x; b < cap; b += NT) {
        const int c = ig[b];
        scol[b] = (c >= 0 && c < n_cols) ? c : -1;
    }
    __syncthreads();
    const int a0 = blockIdx.y * ROWS_PER_BLOCK;
    const int a1 = min(a0 + ROWS_PER_BLOCK, cap);
    for (int a = a0 + wid; a < a1; a += NWARP) {
        const int r = ig[a];
        const long long rel = (long long)r - row_start;
        const bool owned = rel >= 0 && rel < rows_per && r < own_limit;
        // 64-bit row offset: at n >= 46,341 the flat index passes 2^31
        const float* src = M + (owned ? rel : 0) * (long long)n_cols;
        float* dst = out + ((size_t)g * cap + a) * cap;
        for (int b = lane; b < cap; b += 32) {
            const int c = scol[b];
            dst[b] = (owned && c >= 0) ? __ldg(src + c) : 0.f;
        }
    }
}

extern "C" const char* fused_gather_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Launches the gather of G instances on `stream`; returns
// cudaGetLastError(). M is (rows_per, n_cols) row-major float32 starting at
// global row row_start; idx is (G, cap) int32; out is (G, cap, cap).
extern "C" int fused_gather_launch(const float* M, const int* idx, float* out,
                                   int G, int cap, int n_cols,
                                   long long row_start, int rows_per,
                                   int own_limit, void* stream) {
    const size_t smem = sizeof(int) * (size_t)cap;
    cudaError_t err = cudaFuncSetAttribute(
        fused_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (G > 0 && cap > 0) {
        const dim3 grid(G, (cap + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
        fused_gather_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
            M, idx, out, n_cols, row_start, rows_per, own_limit, cap);
    }
    return (int)cudaGetLastError();
}
