// out[i] = x[i] + 1 over an int32 array: the elementwise kernel of the
// download-race tool (tools/repro_download.py), for Hopper (sm_90a), bound to
// Python through a plain C interface (ops/cuda_add_one.py loads it with
// ctypes).
//
// Replaces the Pallas TPU kernel of page_segmentation_tpu:
//   K3  tools/repro_pallas_download.py:45  kernel  (with_pallas :48-55)
// There the whole (424, 304) array sits in VMEM as one block.  Here each
// thread loads and stores 16 B (four elements), and up to three more
// threads take the ragged tail after the last whole 16 B.  The grid is sized
// to the element count (252 blocks of 128 threads at 424 x 304, one int4 a
// thread); only arrays above kMaxBlocks * 128 int4 loop, grid-stride.
// Where x or out is not 16-byte aligned (a view into another tensor), a
// scalar grid-stride kernel does it all.
//
// What bounds it: launch latency.  It reads 4 B and writes 4 B per element
// (1.03 MB for 424 x 304, 0.31 us at 3.35 TB/s), far below the time of one
// launch, so the launch sets its time on the card, and from the host the
// wrapper's Python (ops/cuda_add_one.py) sets it.  The tool needs the launch
// itself (a kernel of the port's own build on the dispatch stream).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr long long kMaxBlocks = 16 * 132;  // 16 waves over the 132 SMs

// One int4 a thread, for arrays up to kMaxBlocks * kThreads int4, x and
// out 16-byte aligned; the threads past the last whole int4 take the tail.
__global__ void __launch_bounds__(kThreads)
add_one_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, int n) {
    const int vecs = n / 4;
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i < vecs) {
        int4 v = reinterpret_cast<const int4*>(x)[i];
        v.x += 1;
        v.y += 1;
        v.z += 1;
        v.w += 1;
        reinterpret_cast<int4*>(out)[i] = v;
    } else if (vecs * 4 + (i - vecs) < n) {
        const int k = vecs * 4 + (i - vecs);
        out[k] = x[k] + 1;
    }
}

// Larger arrays: a grid of kMaxBlocks blocks strides over the int4s.
__global__ void __launch_bounds__(kThreads)
add_one_stride_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n) {
    const long long vecs = n / 4;
    const int4* xv = reinterpret_cast<const int4*>(x);
    int4* ov = reinterpret_cast<int4*>(out);
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < vecs;
         i += stride) {
        int4 v = xv[i];
        v.x += 1;
        v.y += 1;
        v.z += 1;
        v.w += 1;
        ov[i] = v;
    }
    if (blockIdx.x == 0 && vecs * 4 + threadIdx.x < n) {  // the tail, n - vecs * 4 < 4
        const long long k = vecs * 4 + threadIdx.x;
        out[k] = x[k] + 1;
    }
}

// x or out not 16-byte aligned: one element a step.
__global__ void __launch_bounds__(kThreads)
add_one_scalar_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n) {
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
         i += stride)
        out[i] = x[i] + 1;
}

long long blocks(long long threads) { return (threads + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// x, out: n int32 on the card, allocated by the caller.  Launches one kernel
// on `stream` and returns cudaGetLastError() (0 on success).
int ps_add_one(const int32_t* x, int32_t* out, long long n, void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long vecs = n / 4;
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 != 0) {
        const long long b = blocks(n);
        add_one_scalar_kernel<<<static_cast<unsigned>(b < kMaxBlocks ? b : kMaxBlocks), kThreads,
                                0, s>>>(x, out, n);
    } else if (vecs <= kMaxBlocks * kThreads) {  // one int4 a thread, + up to 3 for the tail
        add_one_kernel<<<static_cast<unsigned>(blocks(vecs + 3)), kThreads, 0, s>>>(
            x, out, static_cast<int>(n));
    } else {
        add_one_stride_kernel<<<static_cast<unsigned>(kMaxBlocks), kThreads, 0, s>>>(x, out, n);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
