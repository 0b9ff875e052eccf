// Connected-component min-labels of a batch of ink masks: a union-find
// labeler for Hopper (sm_90a), bound to Python through a plain C interface
// (ops/cuda_cc.py loads it with ctypes).
//
// Replaces the two Pallas TPU kernels of page_segmentation_tpu:
//   K1  ops/pallas_cc.py:68   _cc_kernel   (cc_min_label_pallas, whole page
//                                          in VMEM, pages <= 240,000 px)
//   K2  ops/pallas_cc.py:129  _band_kernel (cc_min_label_tiled, row bands
//                                          + an outer pointer jump, any size)
// On the TPU there are two kernels only because the label map must fit in
// VMEM.  Here labels live in device memory (a 48-page batch of normalized
// A4 pages is 24.7 MB of int32, inside the 50 MB L2), so this one labeler
// computes what both compute, at every size.
//
// Label contract (identical to the TPU kernels): for each page, ink pixel p
// gets 1 + the smallest row-major flat index, within its own page, over its
// 4-connected component; background gets 0.
//
// Three launches on the caller's stream, batched over pages (blockIdx.z):
//   init     parent[p] = ink ? p : -1
//   merge    each ink pixel unites with its right and its down ink
//            neighbour.  A union finds both roots and links the LARGER root
//            under the smaller with atomicMin, retrying while it loses a
//            race.  Parent values only ever decrease and always point to a
//            pixel of the same component, so each component's final root
//            is its minimum flat index whatever order the threads run in.
//   compress labels[p] = ink ? find(p) + 1 : 0
// find() splits paths as it walks (each visited node is pointed at its
// grandparent, again by atomicMin), which keeps trees shallow.
//
// What bounds it: bytes.  The function must read 1 B of ink and write 4 B
// of label per pixel (31 MB for 48 x 424 x 304, ~9 us at 3.35 TB/s).  The
// parent array adds 8 B/pixel of traffic that stays mostly in L2 at the
// main path's size.  This first version spends no effort on that bound
// (no shared-memory tile phase, no fused vote): it is the simple, exact
// labeler that later work makes fast.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// Root of x's tree, splitting the path on the way.  Reads bypass L1
// (__ldcg): other SMs update parents concurrently, and atomics act in L2.
__device__ __forceinline__ int find_root(int32_t* parent, int x) {
    int p = __ldcg(parent + x);
    while (p != x) {
        const int gp = __ldcg(parent + p);
        if (gp != p) atomicMin(parent + x, gp);
        x = p;
        p = gp;
    }
    return x;
}

__device__ __forceinline__ void unite(int32_t* parent, int a, int b) {
    while (true) {
        a = find_root(parent, a);
        b = find_root(parent, b);
        if (a == b) return;
        if (a > b) {
            const int t = a;
            a = b;
            b = t;
        }
        const int old = atomicMin(parent + b, a);
        if (old == b) return;  // b was still a root: now linked under a
        b = old;               // b was linked meanwhile: join its new parent to a
    }
}

struct Pixel {
    bool inside;
    int x, y, p;
    size_t page;
};

__device__ __forceinline__ Pixel locate(int h, int w) {
    Pixel px;
    px.x = blockIdx.x * blockDim.x + threadIdx.x;
    px.y = blockIdx.y * blockDim.y + threadIdx.y;
    px.inside = px.x < w && px.y < h;
    px.p = px.y * w + px.x;
    px.page = static_cast<size_t>(blockIdx.z) * h * w;
    return px;
}

__global__ void init_kernel(const uint8_t* __restrict__ ink,
                            int32_t* __restrict__ parent, int h, int w) {
    const Pixel px = locate(h, w);
    if (!px.inside) return;
    parent[px.page + px.p] = ink[px.page + px.p] ? px.p : -1;
}

__global__ void merge_kernel(const uint8_t* __restrict__ ink,
                             int32_t* parent, int h, int w) {
    const Pixel px = locate(h, w);
    if (!px.inside) return;
    const uint8_t* page_ink = ink + px.page;
    int32_t* page_parent = parent + px.page;
    if (!page_ink[px.p]) return;
    if (px.x + 1 < w && page_ink[px.p + 1]) unite(page_parent, px.p, px.p + 1);
    if (px.y + 1 < h && page_ink[px.p + w]) unite(page_parent, px.p, px.p + w);
}

__global__ void compress_kernel(const uint8_t* __restrict__ ink,
                                int32_t* parent, int32_t* __restrict__ labels,
                                int h, int w) {
    const Pixel px = locate(h, w);
    if (!px.inside) return;
    labels[px.page + px.p] =
        ink[px.page + px.p] ? find_root(parent + px.page, px.p) + 1 : 0;
}

dim3 grid_for(int n, int h, int w) {
    return dim3((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, n);
}

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError()
// (0 on success).  ink: (n, h, w) uint8, nonzero = ink; parent, labels:
// (n, h, w) int32, allocated by the caller.
extern "C" {

int ps_cc_init(const uint8_t* ink, int32_t* parent, int n, int h, int w,
               void* stream) {
    init_kernel<<<grid_for(n, h, w), dim3(kBlockX, kBlockY), 0,
                  static_cast<cudaStream_t>(stream)>>>(ink, parent, h, w);
    return static_cast<int>(cudaGetLastError());
}

int ps_cc_merge(const uint8_t* ink, int32_t* parent, int n, int h, int w,
                void* stream) {
    merge_kernel<<<grid_for(n, h, w), dim3(kBlockX, kBlockY), 0,
                   static_cast<cudaStream_t>(stream)>>>(ink, parent, h, w);
    return static_cast<int>(cudaGetLastError());
}

int ps_cc_compress(const uint8_t* ink, int32_t* parent, int32_t* labels,
                   int n, int h, int w, void* stream) {
    compress_kernel<<<grid_for(n, h, w), dim3(kBlockX, kBlockY), 0,
                      static_cast<cudaStream_t>(stream)>>>(ink, parent, labels,
                                                           h, w);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
