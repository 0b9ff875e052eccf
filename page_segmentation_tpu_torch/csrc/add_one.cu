// out[i] = x[i] + 1 over an int32 array: the elementwise kernel of the
// download-race tool (tools/repro_download.py), for Hopper (sm_90a), bound to
// Python through a plain C interface (ops/cuda_add_one.py loads it with
// ctypes).
//
// Replaces the Pallas TPU kernel of page_segmentation_tpu:
//   K3  tools/repro_pallas_download.py:45  kernel  (with_pallas :48-55)
// There the whole (424, 304) array sits in VMEM as one block.  Here a grid
// of 256-thread blocks walks the array with a grid-stride loop, one element
// per thread per step, on the caller's stream.
//
// What bounds it: bytes.  It reads 4 B and writes 4 B per element (1.03 MB
// for 424 x 304, ~0.31 us at 3.35 TB/s), far below the time of one launch,
// so launch latency sets its time on the card.  The tool needs the launch
// itself (a kernel of the port's own build on the dispatch stream), not speed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4 * 132;  // a few waves over the 132 SMs

__global__ void add_one_kernel(const int32_t* __restrict__ x,
                               int32_t* __restrict__ out, long long n) {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < n; i += stride)
        out[i] = x[i] + 1;
}

}  // namespace

extern "C" {

// x, out: n int32 on the card, allocated by the caller.  Launches one kernel
// on `stream` and returns cudaGetLastError() (0 on success).
int ps_add_one(const int32_t* x, int32_t* out, long long n, void* stream) {
    if (n <= 0) return 0;
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    add_one_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, out, n);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
