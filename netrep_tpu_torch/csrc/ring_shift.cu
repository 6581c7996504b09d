// One step of the row ring: copy one shard's (rows_per, n) float32 row
// block into the buffer of its right neighbour.
//
// Replaces the Pallas kernel `_ring_dma_kernel` / `ring_shift_dma` of
// netrep_tpu/ops/fused_stats.py (:398-437): there, one
// `pltpu.make_async_remote_copy` pushes this chip's block to the ring
// neighbour's output buffer, with send/recv DMA semaphores. Here one process
// drives every shard of the mesh, so the neighbour's buffer is addressable
// memory: a plain pointer when both shards share a card, a peer pointer
// under unified addressing when they do not (peer access enabled once per
// device pair by `ring_shift_enable_peer`). The kernel runs on the SOURCE
// card and stores straight into the destination; the wrapper
// (netrep_tpu_torch/ops/fused_stats.py) launches it on the source card's
// current stream and, where the cards differ, makes the destination card's
// stream wait on an event recorded after the launch — the counterpart of
// the semaphores. There is no fallback through the host.
//
// What bounds it: bytes. Each element is read once and written once:
// 2 x rows_per x n x 4 bytes at 3.35 TB/s on one card (0.2388 ms for a
// 5,000 x 20,000 block), or rows_per x n x 4 bytes at 450 GB/s each way
// over NVLink between two cards. At 3.35 TB/s and ~1 us of DRAM latency a
// card needs about 3.4 MB in flight, ~25 KB per SM.
//
// Design: one 16-byte element per thread over a grid that covers the whole
// block (~98,000 blocks of 256 threads for 5,000 x 20,000 floats), loads
// that bypass L1 (ld.global.nc.L1::no_allocate) and stores marked
// streaming (st.global.cs): the block is touched once, so neither should
// evict what the next kernel reads. Measured on one H100 against the
// alternatives in one call (PERF.md): a grid-stride loop capped at 4,096
// blocks, a persistent grid whose threads keep 4-16 loads in flight
// (strided or over block-contiguous tiles) and a TMA bulk-copy pipeline
// (cp.async.bulk through shared memory) were all slower than this and
// than `copy_`; the full grid with streaming hints was the fastest. The
// tail of fewer than 4 elements is copied by the first threads of block
// 0; a pair of pointers that is not 16-byte aligned copies single floats.
// The copy is exact, so the kernel equals its plain version (a rotation of
// the block list) bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256

__device__ __forceinline__ float4 ld_stream(const float4* p) {
    float4 v;
    asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0,%1,%2,%3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "l"(p));
    return v;
}

__device__ __forceinline__ float ld_stream(const float* p) {
    float v;
    asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];"
                 : "=f"(v)
                 : "l"(p));
    return v;
}

__global__ void __launch_bounds__(NT) ring_shift_kernel(
    const float* __restrict__ src, float* __restrict__ dst, long long n,
    int vec) {
    const long long i = (long long)blockIdx.x * NT + threadIdx.x;
    if (!vec) {
        if (i < n) __stcs(dst + i, ld_stream(src + i));
        return;
    }
    const long long n4 = n >> 2;
    if (i < n4)
        __stcs(reinterpret_cast<float4*>(dst) + i,
               ld_stream(reinterpret_cast<const float4*>(src) + i));
    if (i < (n & 3)) {
        const long long t = (n4 << 2) + i;
        __stcs(dst + t, ld_stream(src + t));
    }
}

extern "C" const char* ring_shift_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Whether card `src` may store into card `dst`'s memory; enables the
// access (once: an already-enabled pair is not an error). Returns 0 on
// success, -1 when the pair has no peer path, else a cudaError_t. The
// calling thread's current card is restored.
extern "C" int ring_shift_enable_peer(int src, int dst) {
    int can = 0;
    cudaError_t err = cudaDeviceCanAccessPeer(&can, src, dst);
    if (err != cudaSuccess) return (int)err;
    if (!can) return -1;
    int prev = 0;
    err = cudaGetDevice(&prev);
    if (err != cudaSuccess) return (int)err;
    err = cudaSetDevice(src);
    if (err == cudaSuccess) {
        err = cudaDeviceEnablePeerAccess(dst, 0);
        if (err == cudaErrorPeerAccessAlreadyEnabled) {
            cudaGetLastError();  // clear the error it left behind
            err = cudaSuccess;
        }
    }
    cudaError_t back = cudaSetDevice(prev);
    return (int)(err != cudaSuccess ? err : back);
}

// Copies n float32 values from src (on card `device`) to dst (on that card
// or on a peer) on `stream`, a stream of card `device`; returns
// cudaGetLastError(). The calling thread's current card is restored.
extern "C" int ring_shift_launch(const float* src, float* dst, long long n,
                                 int device, void* stream) {
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err != cudaSuccess) return (int)err;
    if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
        return (int)err;
    if (n > 0) {
        const int vec =
            ((uintptr_t)src % 16 == 0) && ((uintptr_t)dst % 16 == 0);
        const long long work = vec ? (n >> 2) : n;
        const long long blocks = work > 0 ? (work + NT - 1) / NT : 1;
        ring_shift_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
            src, dst, n, vec);
    }
    if (err == cudaSuccess) err = cudaGetLastError();
    if (prev != device) {
        cudaError_t back = cudaSetDevice(prev);
        if (err == cudaSuccess) err = back;
    }
    return (int)err;
}
