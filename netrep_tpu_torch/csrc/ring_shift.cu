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
// Design: a grid-stride loop of 16-byte vector loads and stores (float4)
// over the block when both pointers are 16-byte aligned, then a scalar loop
// over the tail of fewer than 4 elements; an unaligned pair runs the scalar
// loop throughout. The copy is exact, so the kernel equals its plain
// version (a rotation of the block list) bit for bit.
//
// What bounds it: bytes. Each element is read once and written once:
// 2 x rows_per x n x 4 bytes at 3.35 TB/s on one card (0.2388 ms for a
// 5,000 x 20,000 block), or rows_per x n x 4 bytes at 450 GB/s each way
// over NVLink between two cards.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256
#define MAX_BLOCKS 4096

__global__ void __launch_bounds__(NT) ring_shift_kernel(
    const float* __restrict__ src, float* __restrict__ dst, long long n,
    int vec) {
    const long long tid = (long long)blockIdx.x * NT + threadIdx.x;
    const long long stride = (long long)gridDim.x * NT;
    long long done = 0;
    if (vec) {
        const long long n4 = n >> 2;
        const float4* s4 = reinterpret_cast<const float4*>(src);
        float4* d4 = reinterpret_cast<float4*>(dst);
        for (long long i = tid; i < n4; i += stride) d4[i] = __ldg(s4 + i);
        done = n4 << 2;
    }
    for (long long i = done + tid; i < n; i += stride) dst[i] = __ldg(src + i);
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
        const int vec = ((uintptr_t)src % 16 == 0) && ((uintptr_t)dst % 16 == 0);
        const long long work = vec ? (n >> 2) : n;
        long long blocks = (work + NT - 1) / NT;
        if (blocks < 1) blocks = 1;
        if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
        ring_shift_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
            src, dst, n, vec);
    }
    err = cudaGetLastError();
    if (prev != device) {
        cudaError_t back = cudaSetDevice(prev);
        if (err == cudaSuccess) err = back;
    }
    return (int)err;
}
