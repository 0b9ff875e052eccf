// Connected-component min-labels of a batch of ink masks: a block-based
// union-find labeler for Hopper (sm_90a), bound to Python through a plain C
// interface (ops/cuda_cc.py loads it with ctypes).
//
// Replaces the two Pallas TPU kernels of page_segmentation_tpu:
//   K1  ops/pallas_cc.py:68   _cc_kernel   (cc_min_label_pallas, whole page
//                                          in VMEM, pages <= 240,000 px)
//   K2  ops/pallas_cc.py:129  _band_kernel (cc_min_label_tiled, row bands
//                                          + an outer pointer jump, any size)
// On the TPU there are two kernels only because the label map must fit in
// VMEM.  Here labels live in device memory, so this one labeler computes
// what both compute, at every size.
//
// Label contract (identical to the TPU kernels): for each page, ink pixel p
// gets 1 + the smallest row-major flat index, within its own page, over its
// 4-connected component; background gets 0; int32.
//
// The output array is also the union-find forest: labels[p] = 1 + parent(p)
// on ink, 0 on background, and a root r holds r + 1.  Three launches on the
// caller's stream, each batched over pages (blockIdx.z, or blockIdx.y for
// the border and flatten passes), in the block-based union-find family
// (Playne & Hawick, IEEE TPDS 2018; Allegretti et al., IEEE TPDS 2019):
//
//   tile     one warp per 32 x 32 tile, four tiles to a block.  Lane r
//            loads tile row r once (two 16 B loads where rows are 16-byte
//            aligned, else 1 B at a time) into a 32-bit ink mask, so runs and
//            vertical overlaps are bit operations on whole rows (run
//            detection as in HA4, Hennequin et al. 2018), 32 rows at once.
//            Only the first pixel of each run is a node of the tile's forest
//            in shared memory, on tile-local indices.  A run links to the run
//            above at its first overlap with it (a plain store: no other
//            thread writes that node then); a run that joins several runs
//            above unites with the others by atomicMin.  Pointer jumping then
//            points every node at its root, and the warp writes the tile four
//            rows a step, 16 B a lane: 1 + the in-page index of the root of
//            each ink pixel's run, 0 on background.  Traffic: 1 B read + 4 B
//            written per pixel.
//   border   one thread per pixel pair across a tile edge (about 6 % of
//            the pixels at 424 x 304); where both are ink, a global union
//            on the label array.  A warp covers 32 consecutive pairs of one
//            edge and unites only at the first pair of each run of ink
//            pairs: the pairs after it are joined to it inside their tiles.
//            Traffic: 8 B read per pair, plus the union's walks.
//   flatten  each ink pixel whose parent is not a root writes its root.
//            Labels are read 16 B a thread where the page allows, and
//            background is never rewritten.  Traffic: 4 B read per pixel,
//            4 B written per changed pixel.
//
// Why the result is order-free and canonical: every link points a node at a
// smaller index of its own component.  Unions link the LARGER root under the
// smaller one with atomicMin and retry when they lose a race, and path
// splitting and pointer jumping only point a node further up its own tree.
// So each component's final root is its smallest index, whatever order the
// threads run in.  Inside a tile a run's first pixel is its smallest, and a
// tile-local index orders as the in-page index does, so the tile roots are
// the tiles' component minima too.
//
// What bounds it: bytes.  The function must read 1 B of ink and write 4 B of
// label per pixel: 5 B/px, 31 MB for 48 x 424 x 304 (9.2 us at 3.35 TB/s).
// The design moves about 1 + 4 + 4 B/px plus the border pass's few percent:
// the tile pass does the work of the old per-pixel global merge in shared
// memory, and the output doubles as the union-find array (no parent scratch).
// On an H100 the tile pass takes under twice as long as converting the ink
// to int32 (the same 1 B read and 4 B write per pixel), and the border pass
// is bound by the latency of its unions in L2, not by bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;       // tiles are kTile x kTile, one warp each
constexpr int kTileWarps = 4;   // tiles per block, side by side along x
constexpr int kTileThreads = kTileWarps * 32;
constexpr int kBorderThreads = 256;
constexpr int kFlattenThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr unsigned kAll = 0xffffffffu;

// ---------------------------------------------------------- shared memory
// A tile's forest on tile-local indices x = row * kTile + column: par at
// slot(x) is the parent of x, a root is its own parent.  Only the first
// pixel of each run is a node.  The slot rotates each row's columns by the
// row, so that lanes on different rows touching one column hit different
// banks.
__device__ __forceinline__ int slot(int x) { return (x & ~31) | ((x + (x >> 5)) & 31); }

// Root of x, splitting the path on the way (each visited node is pointed
// at its grandparent by atomicMin), while other lanes unite.
__device__ __forceinline__ int find_tile_split(int* par, int x) {
    volatile int* vpar = par;
    int p = vpar[slot(x)];
    while (p != x) {
        const int gp = vpar[slot(p)];
        if (gp != p) atomicMin(par + slot(x), gp);
        x = p;
        p = gp;
    }
    return x;
}

__device__ __forceinline__ void unite_tile(int* par, int a, int b) {
    while (true) {
        a = find_tile_split(par, a);
        b = find_tile_split(par, b);
        if (a == b) return;
        if (a > b) {
            const int t = a;
            a = b;
            b = t;
        }
        const int old = atomicMin(par + slot(b), a);
        if (old == b) return;  // b was still a root: now linked under a
        b = old;               // b was linked meanwhile: join its new parent to a
    }
}

// Column of the first pixel of the run of `row` through the column whose
// left-hand columns are the bits of `left`.
__device__ __forceinline__ int run_start(uint32_t row, uint32_t left) {
    const uint32_t gaps = ~row & left;
    return gaps ? 32 - __clz(gaps) : 0;
}

// Bit k of the result is set where byte k of the 16 bytes is nonzero.
__device__ __forceinline__ uint32_t nonzero_bits(uint4 v) {
    // per word: 0x01 in each nonzero byte, gathered into bits 24..27
    auto nib = [](uint32_t word) {
        return ((__vcmpne4(word, 0u) & 0x01010101u) * 0x01020408u) >> 24;
    };
    return nib(v.x) | nib(v.y) << 4 | nib(v.z) << 8 | nib(v.w) << 12;
}

// ---------------------------------------------------------- device memory
// On the 1-based label array of one page: lab[x] = 1 + parent(x).
// Root of x's tree, splitting the path on the way.  Reads bypass L1
// (__ldcg): other SMs update parents concurrently, and atomics act in L2.
__device__ __forceinline__ int find_split(int32_t* lab, int x) {
    int p = __ldcg(lab + x) - 1;
    while (p != x) {
        const int gp = __ldcg(lab + p) - 1;
        if (gp != p) atomicMin(lab + x, gp + 1);
        x = p;
        p = gp;
    }
    return x;
}

__device__ __forceinline__ void unite_global(int32_t* lab, int a, int b) {
    while (true) {
        a = find_split(lab, a);
        b = find_split(lab, b);
        if (a == b) return;
        if (a > b) {
            const int t = a;
            a = b;
            b = t;
        }
        const int old = atomicMin(lab + b, a + 1) - 1;
        if (old == b) return;
        b = old;
    }
}

// ------------------------------------------------------------------ tile
// One warp per 32 x 32 tile.  vec: w % 16 == 0 and ink 16-byte aligned;
// out4: w % 4 == 0 and labels 16-byte aligned.
__global__ void __launch_bounds__(kTileThreads)
tile_kernel(const uint8_t* __restrict__ ink, int32_t* __restrict__ labels,
            int h, int w, int tiles_x, int tiles_y, bool vec, bool out4) {
    __shared__ int s_par[kTileWarps][kTile * kTile];

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int tx = blockIdx.x * kTileWarps + warp;
    if (tx >= tiles_x) return;
    const uint32_t left = (1u << lane) - 1u;
    const int x0 = tx * kTile;
    const size_t page = static_cast<size_t>(blockIdx.z) * h * w;
    int* par = s_par[warp];
    volatile int* vpar = par;

    for (int ty = blockIdx.y; ty < tiles_y; ty += gridDim.y) {
        const int y0 = ty * kTile;
        // 1. lane r loads tile row r once, as a 32-bit ink mask
        uint32_t m = 0;
        if (y0 + lane < h) {
            const uint8_t* src = ink + page + static_cast<size_t>(y0 + lane) * w + x0;
            if (vec) {  // w % 16 == 0: each 16 B chunk is wholly in or out
                m = nonzero_bits(__ldg(reinterpret_cast<const uint4*>(src)));
                if (x0 + 16 < w)
                    m |= nonzero_bits(__ldg(reinterpret_cast<const uint4*>(src + 16))) << 16;
            } else {
                const int cols = w - x0 < kTile ? w - x0 : kTile;
                for (int c = 0; c < cols; ++c) m |= static_cast<uint32_t>(src[c] != 0) << c;
            }
        }
        const uint32_t above = __shfl_up_sync(kAll, m, 1);
        const uint32_t up = lane ? above : 0u;  // the row above (none for row 0)
        const uint32_t starts = m & ~(m << 1);
        const uint32_t both = m & up;

        // 2. each run's first pixel links to the first pixel of the run above
        //    at the run's first overlap with the row above, or is a root.  A
        //    plain store: nothing else writes a node in this step.
        for (uint32_t s = starts; s; s &= s - 1) {
            const int c = __ffs(s) - 1;
            const uint32_t after = ~m & ~((2u << c) - 1u);  // background right of c
            uint32_t run = ~((1u << c) - 1u);
            if (after) run &= (1u << (__ffs(after) - 1)) - 1u;
            const uint32_t o = both & run;
            par[slot(lane * kTile + c)] =
                o ? (lane - 1) * kTile + run_start(up, (1u << (__ffs(o) - 1)) - 1u)
                  : lane * kTile + c;
        }
        __syncwarp();

        // 3. a run's further overlaps with the row above (it joins several
        //    runs there): unions, at the first column of each
        for (uint32_t f = both & ~(both << 1); f; f &= f - 1) {
            const uint32_t lc = (1u << (__ffs(f) - 1)) - 1u;  // columns left of this one
            const int start = run_start(m, lc);
            if (both & lc & ~((1u << start) - 1u))  // not the run's first overlap
                unite_tile(par, lane * kTile + start, (lane - 1) * kTile + run_start(up, lc));
        }
        __syncwarp();

        // 4. pointer jumping until every node points at its root
        bool moved = true;
        while (__any_sync(kAll, moved)) {
            moved = false;
            for (uint32_t s = starts; s; s &= s - 1) {
                const int x = slot(lane * kTile + __ffs(s) - 1);
                const int p = vpar[x];
                const int pp = vpar[slot(p)];
                if (pp != p) {
                    vpar[x] = pp;
                    moved = true;
                }
            }
            __syncwarp();
        }

        // 5. the labels, four rows a step: lane l writes columns c0 .. c0+3
        //    (c0 = 4 (l % 8)) of row l / 8 of the step, 16 B at a time: 1 + the
        //    in-page index of the root of each ink pixel's run, 0 on background
        const int c0 = (lane & 7) * 4;
        const int rows = h - y0 < kTile ? h - y0 : kTile;
        for (int ly = lane >> 3; ly < kTile; ly += 4) {
            const uint32_t row = __shfl_sync(kAll, m, ly);
            int v[4];
            int root = 0;  // 1 + in-page index of the current run's root
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int c = c0 + k;
                const bool on = row >> c & 1u;
                if (on && (k == 0 || !(row >> (c - 1) & 1u))) {  // the group's first run here
                    const int r = par[slot(ly * kTile + run_start(row, (1u << c) - 1u))];
                    root = (y0 + (r >> 5)) * w + x0 + (r & 31) + 1;
                }
                v[k] = on ? root : 0;
            }
            if (ly < rows) {
                int32_t* dst = labels + page + static_cast<size_t>(y0 + ly) * w + x0 + c0;
                if (out4) {  // w % 4 == 0: the 4 pixels are wholly in or out
                    if (x0 + c0 < w)
                        *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
                } else {
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        if (x0 + c0 + k < w) dst[k] = v[k];
                }
            }
        }
        __syncwarp();  // the forest is reused by the next tile row
    }
}

// ---------------------------------------------------------------- border
// The pairs across the edges between tile rows (row_edges lines of w pairs
// (y-1, x), (y, x), y = (line + 1) * kTile), then those across the edges
// between tile columns (lines of h pairs (y, x-1), (y, x), x = (line + 1) *
// kTile), each line padded to a multiple of 32 and laid end to end; one
// thread per pair, blockIdx.y the page.  A warp thus holds 32 consecutive
// positions of one edge, starting at a multiple of 32, and unites only the
// first pair of each run of ink pairs: pair k+1 of a run is joined to pair k
// by two links that lie inside tiles (the tile pass made them), because a
// run restarts at lane 0, and every tile boundary crossing the edge falls on
// lane 0 (kTile is a multiple of 32).
__global__ void __launch_bounds__(kBorderThreads)
border_kernel(int32_t* labels, int h, int w, int row_edges, int col_edges) {
    int32_t* lab = labels + static_cast<size_t>(blockIdx.y) * h * w;
    const int lw = (w + 31) & ~31, lh = (h + 31) & ~31;
    int t = blockIdx.x * kBorderThreads + threadIdx.x;
    int a = 0, b = 0;
    bool pair = false;
    if (t < row_edges * lw) {
        const int pos = t % lw;
        pair = pos < w;
        b = (t / lw + 1) * kTile * w + pos;
        a = b - w;
    } else {
        t -= row_edges * lw;
        const int pos = t % lh;
        pair = t / lh < col_edges && pos < h;
        b = pos * w + (t / lh + 1) * kTile;
        a = b - 1;
    }
    const bool both = pair && __ldcg(lab + a) != 0 && __ldcg(lab + b) != 0;
    const uint32_t run = __ballot_sync(kAll, both);
    if ((run & ~(run << 1)) >> (threadIdx.x & 31) & 1u) unite_global(lab, a, b);
}

// --------------------------------------------------------------- flatten
// Each ink pixel whose parent is not a root writes its root.  Writing in
// place while other threads walk is safe: the border pass has ended, so the
// forest's roots are fixed, and every value a pixel ever holds is an
// ancestor of it (its tile root, or a root found by a walk), so a walk that
// reads an old or a new value still climbs the same tree; each step goes to
// a smaller index, so it ends, and it ends at the one root.  Only a pixel's
// own thread writes it, and only if changed.
__device__ __forceinline__ int climb(const int32_t* lab, int x) {
    int p = lab[x] - 1;
    while (p != x) {
        x = p;
        p = lab[x] - 1;
    }
    return x;
}

__device__ __forceinline__ void flatten_one(int32_t* lab, int i, int v) {
    if (v == 0 || v - 1 == i) return;  // background, or a root
    const int r = climb(lab, v - 1);
    if (r != v - 1) lab[i] = r + 1;
}

template <bool kVec>
__global__ void __launch_bounds__(kFlattenThreads)
flatten_kernel(int32_t* labels, int hw) {
    int32_t* lab = labels + static_cast<size_t>(blockIdx.y) * hw;
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (kVec) {  // hw % 4 == 0 and labels 16-byte aligned: so is every page
        if (t >= hw / 4) return;
        const int4 v = reinterpret_cast<const int4*>(lab)[t];
        const int i = static_cast<int>(t) * 4;
        flatten_one(lab, i, v.x);
        flatten_one(lab, i + 1, v.y);
        flatten_one(lab, i + 2, v.z);
        flatten_one(lab, i + 3, v.w);
    } else {
        if (t >= hw) return;
        flatten_one(lab, static_cast<int>(t), lab[t]);
    }
}

unsigned blocks(long long items, int per_block) {
    const long long b = (items + per_block - 1) / per_block;
    return static_cast<unsigned>(b > 0 ? b : 1);
}

}  // namespace

extern "C" {

// ink: (n, h, w) uint8 or bool, nonzero = ink; labels: (n, h, w) int32,
// allocated by the caller (not read before it is written).  n <= 65535,
// h * w < 2^31.  Launches the tile, border and flatten kernels on `stream`
// and returns the first nonzero cudaGetLastError() (0 on success).
int ps_cc_label(const uint8_t* ink, int32_t* labels, int n, int h, int w,
                void* stream) {
    if (n <= 0 || h <= 0 || w <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int tiles_x = (w + kTile - 1) / kTile;
    const int tiles_y = (h + kTile - 1) / kTile;
    const bool vec = w % 16 == 0 && reinterpret_cast<uintptr_t>(ink) % 16 == 0;
    const bool out4 = w % 4 == 0 && reinterpret_cast<uintptr_t>(labels) % 16 == 0;
    tile_kernel<<<dim3(blocks(tiles_x, kTileWarps), tiles_y < kMaxGridY ? tiles_y : kMaxGridY, n),
                  kTileThreads, 0, s>>>(ink, labels, h, w, tiles_x, tiles_y, vec, out4);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    const int row_edges = tiles_y - 1, col_edges = tiles_x - 1;
    const long long pairs = static_cast<long long>(row_edges) * ((w + 31) & ~31) +
                            static_cast<long long>(col_edges) * ((h + 31) & ~31);
    border_kernel<<<dim3(blocks(pairs, kBorderThreads), n), kBorderThreads, 0, s>>>(
        labels, h, w, row_edges, col_edges);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    const int hw = h * w;
    if (hw % 4 == 0 && reinterpret_cast<uintptr_t>(labels) % 16 == 0)
        flatten_kernel<true><<<dim3(blocks(hw / 4, kFlattenThreads), n), kFlattenThreads,
                               0, s>>>(labels, hw);
    else
        flatten_kernel<false><<<dim3(blocks(hw, kFlattenThreads), n), kFlattenThreads,
                                0, s>>>(labels, hw);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
