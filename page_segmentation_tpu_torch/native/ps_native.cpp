// Host C functions of the predict paths (inference/pipeline.py,
// inference/postprocess.py, ops/cc.py): box decimation, the ink gather, the
// color/overlay/inverted trio from a raw or 2-bit packed class map, the
// 4-connected cc-majority vote, and connected components with stats
// (union-find labeling with raster-order numbering).  And those of the
// segmentation and PageXML paths: external contour tracing, bit-packed
// binary morphology, PNG row unfiltering, sub-byte index packing, and a
// rasterizer that draws PIL's polygons and lines.  And the values of flax's
// kernel initializers for a fresh model (models/flax_init.py).  And a zstd
// decoder and CRC-32C for the training checkpoints in orbax's layout
// (train/orbax_format.py).  These run on the host, GIL-free through ctypes;
// they are not device kernels.
//
// Built at first use by native/__init__.py (g++ -O3 -shared).  Outputs are
// byte-identical to page_segmentation_tpu's native library, which
// tests/test_torch_native.py and tests/test_torch_segmentation.py check;
// the initializers' values to JAX's (tests/test_torch_flax_init.py); the
// zstd decoder's output to the zstandard package's (tests/test_torch_orbax_zstd.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <system_error>
#include <thread>
#include <utility>
#include <vector>

#include <sched.h>
#if defined(__SSE2__)
#include <immintrin.h>
#endif

namespace {

struct UnionFind {
    std::vector<int32_t> parent;
    explicit UnionFind(size_t n) { parent.reserve(n); parent.push_back(0); }
    int32_t add() {
        parent.push_back(static_cast<int32_t>(parent.size()));
        return static_cast<int32_t>(parent.size()) - 1;
    }
    int32_t find(int32_t x) {
        int32_t root = x;
        while (parent[root] != root) root = parent[root];
        while (parent[x] != root) {
            int32_t next = parent[x];
            parent[x] = root;
            x = next;
        }
        return root;
    }
    void unite(int32_t a, int32_t b) {
        a = find(a);
        b = find(b);
        if (a < b) parent[b] = a;
        else if (b < a) parent[a] = b;
    }
};

// First pass: provisional labels + merges (4- or 8-connected).  Second
// pass: flatten and renumber components 1..n-1 in raster order of first
// occurrence, as cv2's connectedComponents numbers them.
int label_image(const uint8_t* img, int h, int w, int connectivity,
                int32_t* labels) {
    const size_t size = static_cast<size_t>(h) * w;
    std::vector<int32_t> provisional(size, 0);
    UnionFind uf(1024);

    for (int y = 0; y < h; ++y) {
        const uint8_t* row = img + static_cast<size_t>(y) * w;
        int32_t* prow = provisional.data() + static_cast<size_t>(y) * w;
        const int32_t* prev = prow - w;
        for (int x = 0; x < w; ++x) {
            if (!row[x]) continue;
            int32_t label = 0;
            if (x > 0 && prow[x - 1]) label = prow[x - 1];
            if (y > 0) {
                if (prev[x]) {
                    if (label && label != prev[x]) uf.unite(label, prev[x]);
                    label = label ? std::min(label, prev[x]) : prev[x];
                }
                if (connectivity == 8) {
                    if (x > 0 && prev[x - 1]) {
                        if (label && label != prev[x - 1]) uf.unite(label, prev[x - 1]);
                        label = label ? std::min(label, prev[x - 1]) : prev[x - 1];
                    }
                    if (x + 1 < w && prev[x + 1]) {
                        if (label && label != prev[x + 1]) uf.unite(label, prev[x + 1]);
                        label = label ? std::min(label, prev[x + 1]) : prev[x + 1];
                    }
                }
            }
            if (!label) label = uf.add();
            prow[x] = label;
        }
    }

    // raster-order renumbering of union-find roots
    std::vector<int32_t> remap(uf.parent.size(), 0);
    int32_t count = 0;
    for (size_t i = 0; i < size; ++i) {
        int32_t p = provisional[i];
        if (!p) { labels[i] = 0; continue; }
        int32_t root = uf.find(p);
        if (!remap[root]) remap[root] = ++count;
        labels[i] = remap[root];
    }
    return count + 1;  // including background
}

// Shared core of ps_finish / ps_finish_packed: ClsAt fetches the class of
// pixel x from a class-map row (raw byte vs 2-bit packed).  Pass 1: palette
// gather into color + mask expansion.  Pass 2 over the contiguous 3*ow row
// is byte arithmetic the compiler vectorizes: overlay = color & (is_ink - 1)
// and, since overlay/inverted partition color, inverted = color - overlay.
template <typename ClsAt>
void finish_pages(ClsAt cls_at, const uint8_t* cls_rows, const uint8_t* ink,
                  const uint8_t* palette, int n_colors, int n, int cls_h,
                  int cls_w, int oh, int ow, uint8_t* color, uint8_t* overlay,
                  uint8_t* inverted) {
    std::vector<uint8_t> m3(static_cast<size_t>(ow) * 3);
    for (int page = 0; page < n; ++page) {
        const uint8_t* pp = cls_rows + static_cast<size_t>(page) * cls_h * cls_w;
        const uint8_t* ip = ink + static_cast<size_t>(page) * oh * ow;
        const size_t base = static_cast<size_t>(page) * oh * ow * 3;
        uint8_t* cp = color + base;
        uint8_t* op = overlay + base;
        uint8_t* vp = inverted + base;
        for (int y = 0; y < oh; ++y) {
            const uint8_t* prow = pp + static_cast<size_t>(y) * cls_w;
            const uint8_t* irow = ip + static_cast<size_t>(y) * ow;
            uint8_t* crow = cp + static_cast<size_t>(y) * ow * 3;
            uint8_t* orow = op + static_cast<size_t>(y) * ow * 3;
            uint8_t* vrow = vp + static_cast<size_t>(y) * ow * 3;
            for (int x = 0; x < ow; ++x) {
                int cls = cls_at(prow, x);
                if (cls >= n_colors) cls = n_colors - 1;
                const uint8_t* rgb = palette + cls * 3;
                crow[x * 3] = rgb[0];
                crow[x * 3 + 1] = rgb[1];
                crow[x * 3 + 2] = rgb[2];
                const uint8_t m = irow[x] != 0 ? 1 : 0;
                m3[x * 3] = m;
                m3[x * 3 + 1] = m;
                m3[x * 3 + 2] = m;
            }
            const int row3 = ow * 3;
            for (int j = 0; j < row3; ++j) {
                const uint8_t o = static_cast<uint8_t>(crow[j] & (m3[j] - 1));
                orow[j] = o;
                vrow[j] = static_cast<uint8_t>(crow[j] - o);
            }
        }
    }
}

// The decimate takes one thread per this many input bytes: on the card's
// host a thread costs ~0.1 ms to start and join, which less work than this
// does not pay back (PERF.md: the split size on cold pages).
constexpr size_t kDecimateBytesPerThread = size_t(4) << 20;
// At most this many threads: the knee of the decimate's GB/s against its
// threads on the card's host (PERF.md).
constexpr int kDecimateMaxThreads = 5;

// CPUs in the calling thread's affinity mask (so `taskset` holds).
int process_cpus() {
    cpu_set_t set;
    CPU_ZERO(&set);
    if (sched_getaffinity(0, sizeof(set), &set) != 0) {
        const unsigned hc = std::thread::hardware_concurrency();
        return hc ? static_cast<int>(hc) : 1;
    }
    return CPU_COUNT(&set);
}

// Threads for a decimate of `bytes` input bytes into `rows` output rows:
// one per kDecimateBytesPerThread, at most the process's CPUs less two (a
// core each for the predictor's dispatch and download threads), capped.
int decimate_threads(size_t bytes, int64_t rows) {
    const int64_t by_size = static_cast<int64_t>(bytes / kDecimateBytesPerThread);
    const int64_t t = std::min<int64_t>(
        {by_size, rows, process_cpus() - 2, kDecimateMaxThreads});
    return static_cast<int>(std::max<int64_t>(t, 1));
}

#if defined(__SSE2__)
// Rounded box means of one output row at factor 8, from the 8 input rows
// that start at `rows` (stride w): a SAD against zero sums a cell's 8 bytes
// of a row in one instruction, 4 cells at a time with AVX2, then one.
void decimate_row_f8(const uint8_t* rows, size_t w, int ow, uint8_t* orow) {
    int ox = 0;
#if defined(__AVX2__)
    const __m256i zero256 = _mm256_setzero_si256();
    for (; ox + 4 <= ow; ox += 4) {
        const uint8_t* p = rows + static_cast<size_t>(ox) * 8;
        __m256i acc = zero256;
        for (int fy = 0; fy < 8; ++fy) {
            const __m256i v = _mm256_loadu_si256(
                reinterpret_cast<const __m256i*>(p + fy * w));
            acc = _mm256_add_epi64(acc, _mm256_sad_epu8(v, zero256));
        }
        alignas(32) uint64_t s[4];
        _mm256_store_si256(reinterpret_cast<__m256i*>(s), acc);
        for (int k = 0; k < 4; ++k) orow[ox + k] = static_cast<uint8_t>((s[k] + 32) / 64);
    }
#endif
    const __m128i zero128 = _mm_setzero_si128();
    for (; ox < ow; ++ox) {
        const uint8_t* p = rows + static_cast<size_t>(ox) * 8;
        __m128i acc = zero128;
        for (int fy = 0; fy < 8; ++fy) {
            const __m128i v = _mm_loadl_epi64(reinterpret_cast<const __m128i*>(p + fy * w));
            acc = _mm_add_epi32(acc, _mm_sad_epu8(v, zero128));
        }
        orow[ox] = static_cast<uint8_t>((_mm_cvtsi128_si32(acc) + 32) / 64);
    }
}
#endif

// Output rows [begin, end) of the whole batch (row r: page r / oh, row
// r % oh of it) of ps_decimate_u8.
void decimate_rows(const uint8_t* src, int h, int w, int factor, uint8_t* dst,
                   int64_t begin, int64_t end) {
    const int oh = h / factor, ow = w / factor;
    const uint32_t area = static_cast<uint32_t>(factor) * factor;
    const uint32_t half = area / 2;
    std::vector<uint16_t> vsum(w);
    for (int64_t r = begin; r < end; ++r) {
        const int64_t page = r / oh, oy = r % oh;
        const uint8_t* first_row =
            src + (page * h + oy * factor) * static_cast<int64_t>(w);
        uint8_t* orow = dst + r * ow;
#if defined(__SSE2__)
        if (factor == 8) {
            decimate_row_f8(first_row, w, ow, orow);
            continue;
        }
#endif
        for (int x = 0; x < w; ++x) vsum[x] = first_row[x];
        for (int fy = 1; fy < factor; ++fy) {
            const uint8_t* row = first_row + static_cast<size_t>(fy) * w;
            for (int x = 0; x < w; ++x) vsum[x] += row[x];
        }
        const uint16_t* cell = vsum.data();
        for (int ox = 0; ox < ow; ++ox, cell += factor) {
            uint32_t s = 0;
            for (int fx = 0; fx < factor; ++fx) s += cell[fx];
            orow[ox] = static_cast<uint8_t>((s + half) / area);
        }
    }
}

}  // namespace

extern "C" {

// cv2.connectedComponentsWithStats-compatible labeling of nonzero pixels.
// stats rows: [left, top, width, height, area], row 0 the background over
// the whole image; centroids (x, y).  Returns num_labels (background
// included), or -1 if it exceeds max_labels.
int ps_cc_with_stats(const uint8_t* img, int h, int w, int connectivity,
                     int32_t* labels, int32_t* stats, double* centroids,
                     int max_labels) {
    const int num_labels = label_image(img, h, w, connectivity, labels);
    if (num_labels > max_labels) return -1;

    std::vector<int32_t> left(num_labels, w), top(num_labels, h);
    std::vector<int32_t> right(num_labels, -1), bottom(num_labels, -1);
    std::vector<int64_t> area(num_labels, 0), sx(num_labels, 0), sy(num_labels, 0);
    for (int y = 0; y < h; ++y) {
        const int32_t* row = labels + static_cast<size_t>(y) * w;
        for (int x = 0; x < w; ++x) {
            const int32_t l = row[x];
            area[l]++;
            sx[l] += x;
            sy[l] += y;
            if (x < left[l]) left[l] = x;
            if (x > right[l]) right[l] = x;
            if (y < top[l]) top[l] = y;
            if (y > bottom[l]) bottom[l] = y;
        }
    }
    for (int l = 0; l < num_labels; ++l) {
        int32_t* srow = stats + static_cast<size_t>(l) * 5;
        if (l == 0) {
            srow[0] = 0; srow[1] = 0; srow[2] = w; srow[3] = h;
        } else {
            srow[0] = left[l];
            srow[1] = top[l];
            srow[2] = right[l] - left[l] + 1;
            srow[3] = bottom[l] - top[l] + 1;
        }
        srow[4] = static_cast<int32_t>(area[l]);
        centroids[l * 2] = area[l] ? static_cast<double>(sx[l]) / area[l] : 0.0;
        centroids[l * 2 + 1] = area[l] ? static_cast<double>(sy[l]) / area[l] : 0.0;
    }
    return num_labels;
}

// Fused cc-majority vote: label the binary's 4-connected components,
// histogram pred classes per component, and overwrite each component with
// its majority class (ties -> lowest class).
int ps_cc_vote(const uint8_t* binary, int h, int w, int n_classes,
               int32_t* pred) {
    const size_t size = static_cast<size_t>(h) * w;
    // provisional labels flattened to union-find roots partition pixels
    // like raster-renumbered labels, so no renumber pass is needed
    std::vector<int32_t> provisional(size, 0);
    UnionFind uf(1024);
    for (int y = 0; y < h; ++y) {
        const uint8_t* row = binary + static_cast<size_t>(y) * w;
        int32_t* prow = provisional.data() + static_cast<size_t>(y) * w;
        const int32_t* prev = prow - w;
        for (int x = 0; x < w; ++x) {
            if (!row[x]) continue;
            int32_t label = 0;
            if (x > 0 && prow[x - 1]) label = prow[x - 1];
            if (y > 0 && prev[x]) {
                if (label && label != prev[x]) uf.unite(label, prev[x]);
                label = label ? std::min(label, prev[x]) : prev[x];
            }
            if (!label) label = uf.add();
            prow[x] = label;
        }
    }
    const int32_t n_prov = static_cast<int32_t>(uf.parent.size());
    if (n_prov <= 1) return 1;  // background only

    // flatten roots and compact them to dense component ids in one sweep,
    // so the histogram is sized by components, not provisional labels
    std::vector<int32_t> flat(n_prov, 0);
    int32_t n_components = 0;
    for (int32_t l = 1; l < n_prov; ++l) {
        const int32_t root = uf.find(l);
        // union-by-min: root <= l, so flat[root] is already assigned
        flat[l] = (root == l) ? ++n_components : flat[root];
    }
    std::vector<int64_t> counts(
        static_cast<size_t>(n_components + 1) * n_classes, 0);
    for (size_t i = 0; i < size; ++i) {
        const int32_t p = provisional[i];
        if (p) counts[static_cast<size_t>(flat[p]) * n_classes + pred[i]]++;
    }
    std::vector<int32_t> majority(n_components + 1, 0);
    for (int32_t comp = 1; comp <= n_components; ++comp) {
        const int64_t* c = counts.data() + static_cast<size_t>(comp) * n_classes;
        int best = 0;
        for (int k = 1; k < n_classes; ++k)
            if (c[k] > c[best]) best = k;
        majority[comp] = best;
    }
    for (size_t i = 0; i < size; ++i) {
        const int32_t p = provisional[i];
        if (p) pred[i] = majority[flat[p]];
    }
    return n_components + 1;
}

// Box-mean decimation of a batch of uint8 pages by an integer factor
// (rounded mean, PIL Image.reduce semantics for full boxes; the ragged
// right/bottom remainder is cropped as the pipeline never reads it).  The
// batch's output rows are split in blocks over decimate_threads() threads,
// each with its own column sums; returns the number of threads used.
int ps_decimate_u8(const uint8_t* src, int n, int h, int w, int factor,
                   uint8_t* dst) {
    const int64_t rows = static_cast<int64_t>(n) * (h / factor);
    const int want = decimate_threads(static_cast<size_t>(n) * h * w, rows);
    std::vector<std::thread> workers;
    int64_t done = 0;  // rows handed out
    for (int i = 1; i < want; ++i) {
        const int64_t begin = rows * (i - 1) / want, end = rows * i / want;
        try {
            workers.emplace_back(decimate_rows, src, h, w, factor, dst, begin, end);
        } catch (const std::system_error&) {
            break;  // no more threads: the calling thread takes the rest
        }
        done = end;
    }
    decimate_rows(src, h, w, factor, dst, done, rows);
    for (auto& t : workers) t.join();
    return static_cast<int>(workers.size()) + 1;
}

// Nearest-neighbour gather of the ink mask (binary < 128) at precomputed
// row/col indices.
void ps_gather_ink(const uint8_t* binary, int n, int h, int w,
                   const int32_t* row_idx, int oh,
                   const int32_t* col_idx, int ow, uint8_t* out) {
    for (int page = 0; page < n; ++page) {
        const uint8_t* bp = binary + static_cast<size_t>(page) * h * w;
        uint8_t* op = out + static_cast<size_t>(page) * oh * ow;
        for (int oy = 0; oy < oh; ++oy) {
            const uint8_t* row = bp + static_cast<size_t>(row_idx[oy]) * w;
            uint8_t* orow = op + static_cast<size_t>(oy) * ow;
            for (int ox = 0; ox < ow; ++ox)
                orow[ox] = row[col_idx[ox]] < 128 ? 1 : 0;
        }
    }
}

// Class map + ink mask -> the color / overlay / inverted RGB trio in one
// pass.  pred rows may be padded (pred_w >= ow); palette is (n_colors, 3).
void ps_finish(const uint8_t* pred, const uint8_t* ink, const uint8_t* palette,
               int n_colors, int n, int pred_h, int pred_w, int oh, int ow,
               uint8_t* color, uint8_t* overlay, uint8_t* inverted) {
    finish_pages(
        [](const uint8_t* row, int x) { return static_cast<int>(row[x]); },
        pred, ink, palette, n_colors, n, pred_h, pred_w, oh, ow,
        color, overlay, inverted);
}

// ps_finish reading the 2-bit packed class map (4 pixels per byte,
// LSB-first: pixel x of a packed byte is (b >> (2*(x&3))) & 3).
void ps_finish_packed(const uint8_t* packed, const uint8_t* ink,
                      const uint8_t* palette, int n_colors, int n,
                      int pred_h, int packed_w, int oh, int ow,
                      uint8_t* color, uint8_t* overlay, uint8_t* inverted) {
    finish_pages(
        [](const uint8_t* row, int x) {
            return static_cast<int>((row[x >> 2] >> ((x & 3) * 2)) & 3);
        },
        packed, ink, palette, n_colors, n, pred_h, packed_w, oh, ow,
        color, overlay, inverted);
}

// The host cc-vote finish in one call: unpack the 2-bit class download,
// majority-vote each 4-connected ink component (as ps_cc_vote), and render
// the trio, per page.
void ps_vote_finish_packed(const uint8_t* packed, const uint8_t* ink,
                           const uint8_t* palette, int n_colors, int n_classes,
                           int n, int pred_h, int packed_w, int oh, int ow,
                           uint8_t* color, uint8_t* overlay, uint8_t* inverted) {
    const size_t page_px = static_cast<size_t>(oh) * ow;
    std::vector<uint8_t> cls(page_px);
    std::vector<int32_t> labels(page_px);
    for (int page = 0; page < n; ++page) {
        const uint8_t* pp = packed + static_cast<size_t>(page) * pred_h * packed_w;
        const uint8_t* ip = ink + page * page_px;
        for (int y = 0; y < oh; ++y) {
            const uint8_t* prow = pp + static_cast<size_t>(y) * packed_w;
            uint8_t* crow = cls.data() + static_cast<size_t>(y) * ow;
            for (int x = 0; x < ow; ++x)
                crow[x] = (prow[x >> 2] >> ((x & 3) * 2)) & 3;
        }
        const int num_labels = label_image(ip, oh, ow, 4, labels.data());
        if (num_labels > 1) {
            std::vector<int64_t> counts(
                static_cast<size_t>(num_labels) * n_classes, 0);
            for (size_t i = 0; i < page_px; ++i) {
                const int32_t l = labels[i];
                const uint8_t c = cls[i];
                if (l && c < n_classes)
                    counts[static_cast<size_t>(l) * n_classes + c]++;
            }
            std::vector<uint8_t> majority(num_labels, 0);
            for (int l = 1; l < num_labels; ++l) {
                const int64_t* c = counts.data() + static_cast<size_t>(l) * n_classes;
                int best = 0;
                for (int k = 1; k < n_classes; ++k)
                    if (c[k] > c[best]) best = k;
                majority[l] = static_cast<uint8_t>(best);
            }
            for (size_t i = 0; i < page_px; ++i)
                if (labels[i]) cls[i] = majority[labels[i]];
        }
        const size_t base = page * page_px * 3;
        finish_pages(
            [](const uint8_t* row, int x) { return static_cast<int>(row[x]); },
            cls.data(), ip, palette, n_colors, /*n=*/1, oh, ow, oh, ow,
            color + base, overlay + base, inverted + base);
    }
}

}  // extern "C"

// ---------------------------------------------------------------- contours
// Used by ops/contours.py find_external_contours.

extern "C" {

// External contours (8-connectivity) via Moore-neighbor tracing, with
// collinear-run compression.  Writes (x, y) int32 pairs contiguously into
// out_points; per-contour lengths into out_lens.  Returns the number of
// contours, or -1 on overflow.
int ps_contours(const uint8_t* img, int h, int w, int32_t* out_points,
                int max_points, int32_t* out_lens, int max_contours) {
    const size_t size = static_cast<size_t>(h) * w;  // trace-step bound
    // Run-based labeling instead of a per-pixel pass: foreground runs per
    // row are extracted with 8-byte-at-a-time zero skipping (the masks
    // this traces are mostly background), then union-find merges runs of
    // adjacent rows that 8-touch.  With union-by-min over creation-order
    // run labels, a component's root is its first (topmost-leftmost) run,
    // so roots in ascending order == components in raster discovery
    // order, and the root run's start == the trace start pixel — the
    // exact contract of the per-pixel labeler this replaces (measured
    // ~30 ms/A4-page there vs ~2 ms here on blobby region masks).
    // Tracing needs no label array at all: two different 8-connected
    // components are never 8-adjacent, so plain mask membership keeps the
    // tracer on its own component.
    struct Run { int32_t x0, x1, label; };
    std::vector<Run> rows_runs;           // all runs, row-major
    std::vector<int32_t> row_begin(h + 1, 0);  // index into rows_runs per row
    UnionFind uf(1024);
    std::vector<int32_t> run_start_y(1, -1);   // per label: y of first run
    std::vector<int32_t> run_start_x(1, -1);
    for (int y = 0; y < h; ++y) {
        const uint8_t* row = img + static_cast<size_t>(y) * w;
        row_begin[y] = static_cast<int32_t>(rows_runs.size());
        int x = 0;
        while (x < w) {
            // skip background 8 bytes at a time
            while (x + 8 <= w) {
                uint64_t chunk;
                std::memcpy(&chunk, row + x, 8);
                if (chunk) break;
                x += 8;
            }
            while (x < w && !row[x]) ++x;
            if (x >= w) break;
            const int x0 = x;
            while (x < w && row[x]) ++x;
            rows_runs.push_back({x0, x - 1, 0});
        }
        // merge with the previous row's runs (8-connectivity: overlap
        // with one pixel of diagonal tolerance)
        const int32_t cur_begin = row_begin[y];
        const int32_t cur_end = static_cast<int32_t>(rows_runs.size());
        int32_t p = y > 0 ? row_begin[y - 1] : 0;
        const int32_t p_end = y > 0 ? row_begin[y] : 0;
        for (int32_t r = cur_begin; r < cur_end; ++r) {
            Run& run = rows_runs[r];
            while (p < p_end && rows_runs[p].x1 + 1 < run.x0) ++p;
            for (int32_t q = p; q < p_end && rows_runs[q].x0 <= run.x1 + 1; ++q) {
                if (!run.label) run.label = rows_runs[q].label;
                else uf.unite(run.label, rows_runs[q].label);
            }
            if (!run.label) {
                run.label = uf.add();
                run_start_y.push_back(y);
                run_start_x.push_back(run.x0);
            }
        }
    }
    row_begin[h] = static_cast<int32_t>(rows_runs.size());

    static const int dy[8] = {0, -1, -1, -1, 0, 1, 1, 1};
    static const int dx[8] = {-1, -1, 0, 1, 1, 1, 0, -1};

    int n_contours = 0;
    int point_cursor = 0;
    std::vector<std::pair<int, int>> trace;
    // next boundary move from (cy, cx) scanning clockwise after `backtrack`;
    // returns the direction taken or -1 for an isolated pixel
    auto next_move = [&](int cy, int cx, int backtrack, int* ny, int* nx) {
        for (int k = 0; k < 8; ++k) {
            const int d = (backtrack + 1 + k) % 8;
            const int ty = cy + dy[d], tx = cx + dx[d];
            if (ty < 0 || ty >= h || tx < 0 || tx >= w) continue;
            if (!img[static_cast<size_t>(ty) * w + tx]) continue;
            *ny = ty; *nx = tx;
            return d;
        }
        return -1;
    };
    const int32_t n_labels = static_cast<int32_t>(uf.parent.size());
    for (int32_t l = 1; l < n_labels; ++l) {
        if (uf.find(l) != l) continue;  // merged into an earlier label
        if (n_contours >= max_contours) return -1;
        const int sy0 = run_start_y[l], sx0 = run_start_x[l];
        trace.clear();
        trace.emplace_back(sy0, sx0);
        // west of the topmost-leftmost pixel is background
        int fy, fx;
        const int first_dir = next_move(sy0, sx0, 0, &fy, &fx);
        if (first_dir >= 0) {
            int cy = fy, cx = fx, backtrack = (first_dir + 4) % 8;
            const int64_t limit = 4 * static_cast<int64_t>(size);
            for (int64_t step = 0; step < limit; ++step) {
                trace.emplace_back(cy, cx);
                int ny, nx;
                const int d = next_move(cy, cx, backtrack, &ny, &nx);
                if (d < 0) break;
                if (ny == sy0 && nx == sx0) {
                    // Jacob's criterion: closed iff the initial move from
                    // the start would repeat (mere start re-entry truncates
                    // boundaries that pass through the start pixel twice)
                    int ay, ax;
                    const int after = next_move(sy0, sx0, (d + 4) % 8, &ay, &ax);
                    if (after == first_dir && ay == fy && ax == fx) break;
                }
                cy = ny; cx = nx;
                backtrack = (d + 4) % 8;
            }
        }
        // compress collinear runs (CHAIN_APPROX_SIMPLE-style)
        std::vector<std::pair<int, int>> simple;
        simple.push_back(trace[0]);
        for (size_t i = 1; i + 1 < trace.size(); ++i) {
            const int dy0 = trace[i].first - simple.back().first;
            const int dx0 = trace[i].second - simple.back().second;
            const int dy1 = trace[i + 1].first - trace[i].first;
            const int dx1 = trace[i + 1].second - trace[i].second;
            const int n0 = std::max(std::abs(dy0), std::abs(dx0));
            const int n1 = std::max(std::abs(dy1), std::abs(dx1));
            if (static_cast<int64_t>(dy0) * (n1 ? n1 : 1) != static_cast<int64_t>(dy1) * (n0 ? n0 : 1) ||
                static_cast<int64_t>(dx0) * (n1 ? n1 : 1) != static_cast<int64_t>(dx1) * (n0 ? n0 : 1))
                simple.push_back(trace[i]);
        }
        if (trace.size() > 1) simple.push_back(trace.back());

        if (point_cursor + static_cast<int>(simple.size()) > max_points) return -1;
        for (const auto& p : simple) {
            out_points[point_cursor * 2] = p.second;      // x
            out_points[point_cursor * 2 + 1] = p.first;   // y
            ++point_cursor;
        }
        out_lens[n_contours++] = static_cast<int32_t>(simple.size());
    }
    return n_contours;
}

}  // extern "C"

// ----------------------------------------------------------------- bitmorph
// Bit-packed binary morphology: each row packs LSB-first into 64-px words
// (bit b of word i = pixel x = i*64 + b), and a rectangular dilate/erode
// becomes a separable sliding OR/AND window evaluated by sparse-table
// doubling — O(log2 k) shift-combine passes over 1/64th the bytes,
// independent of kernel size.  This is the host twin of the torch chain
// in segmentation/device_morph.py (same algorithm, same cv2 border
// conventions: reads outside the image are background for dilate and
// foreground for erode) and takes the place of cv2's van Herk path for the
// char_height-sized chain.

namespace bitmorph {

typedef uint64_t u64;

// value whose bit x equals src bit (x + s) of the same row; bits outside
// [0, wc*64) read `pad`.  s may be negative.
static inline u64 read_shifted(const u64* row, int wc, int j, int sb, u64 pad) {
    const u64 w0 = (j >= 0 && j < wc) ? row[j] : pad;
    if (sb == 0) return w0;
    const u64 w1 = (j + 1 >= 0 && j + 1 < wc) ? row[j + 1] : pad;
    return (w0 >> sb) | (w1 << (64 - sb));
}

static inline void split_shift(int s, int& sw, int& sb) {
    sw = s >= 0 ? s / 64 : -((-s + 63) / 64);
    sb = s - sw * 64;  // 0..63
}

// The working buffer is EXTENDED: `er` identity rows on top and `ew`
// identity words on the left of every row, sized so that any sparse-table
// entry a combine can read either physically exists (the doubling passes
// compute the extension region too, so partial windows overlapping the
// data materialize correctly) or is a genuinely all-identity window.
// With er = kmax and ew = ceil(kmax/64), a read below the physical
// buffer covers only positions < 0, whose true reduction is the op's
// identity — exactly what the out-of-range guard returns.  Right/bottom
// overflow needs no extension: a table entry at index >= the data end
// covers only positions past the end (tables anchor at their own index),
// so the guard's identity is always the true value there.

struct Layout {
    int h, w;      // logical mask
    int er, ew;    // top extension rows / left extension words
    int H, WC;     // extended buffer: (er + h) rows of (ew + wc) words
    u64 used_mask; // valid bits of each row's last word
};

// ---- cache-blocked morph_op -----------------------------------------------
// window_pass streams the full image once per shift-combine pass, so a
// composed chain is DRAM-bound (~log2(k) full sweeps per axis per op).
// The blocked version performs ALL of an axis's passes while the working
// set is cache-resident — horizontal: one row (~WC words) in L1 at a
// time; vertical: one column stripe (H x STRIPE_W words) in L2 — cutting
// full-image DRAM sweeps per op from 2*(log2(k)+1) to ~4.  Bit-identical
// to window_pass (same doubling, same identity handling; gated in
// tests/test_torch_device_morph.py).

// in-place doubling along the bit axis within one row: writing word i
// reads words >= i, so left-to-right is safe.  The final (possibly
// negative-shift) combine goes through a scratch row.
static void h_passes_row(u64* row, u64* scratch, const Layout& L,
                         int k, int anchor, bool is_and) {
    const u64 pad = is_and ? ~0ull : 0ull;
    const u64 tail = pad & ~L.used_mask;
    int width = 1;
    while (width * 2 <= k) {
        int sw, sb;
        split_shift(width, sw, sb);
        for (int i = 0; i < L.WC; ++i) {
            const u64 v = read_shifted(row, L.WC, i + sw, sb, pad);
            row[i] = is_and ? (row[i] & v) : (row[i] | v);
        }
        row[L.WC - 1] = (row[L.WC - 1] & L.used_mask) | tail;
        width *= 2;
    }
    int sw1, sb1, sw2, sb2;
    split_shift(-anchor, sw1, sb1);
    split_shift(k - width - anchor, sw2, sb2);
    for (int i = 0; i < L.WC; ++i) {
        const u64 v1 = read_shifted(row, L.WC, i + sw1, sb1, pad);
        const u64 v2 = read_shifted(row, L.WC, i + sw2, sb2, pad);
        scratch[i] = is_and ? (v1 & v2) : (v1 | v2);
    }
    scratch[L.WC - 1] = (scratch[L.WC - 1] & L.used_mask) | tail;
    std::copy(scratch, scratch + L.WC, row);
}

// all vertical passes for the word-column stripe [w0, w1): doubling runs
// in place top-down (writing row y reads rows >= y), the final combine
// through a scratch stripe.
static void v_passes_stripe(u64* buf, u64* scratch, const Layout& L,
                            int w0, int w1, int k, int anchor, bool is_and) {
    const u64 pad = is_and ? ~0ull : 0ull;
    const int sw = w1 - w0;
    int width = 1;
    while (width * 2 <= k) {
        for (int y = 0; y < L.H; ++y) {
            u64* d = buf + static_cast<size_t>(y) * L.WC + w0;
            const int y2 = y + width;
            if (y2 < L.H) {
                const u64* r = buf + static_cast<size_t>(y2) * L.WC + w0;
                if (is_and)
                    for (int i = 0; i < sw; ++i) d[i] &= r[i];
                else
                    for (int i = 0; i < sw; ++i) d[i] |= r[i];
            }
            // else: the missing row reads the op identity — AND with all-
            // ones / OR with zero — so the combine is a no-op either way
        }
        width *= 2;
    }
    const int s1 = -anchor, s2 = k - width - anchor;
    for (int y = 0; y < L.H; ++y) {
        const int y1 = y + s1, y2 = y + s2;
        const u64* r1 = (y1 >= 0 && y1 < L.H)
                            ? buf + static_cast<size_t>(y1) * L.WC + w0 : nullptr;
        const u64* r2 = (y2 >= 0 && y2 < L.H)
                            ? buf + static_cast<size_t>(y2) * L.WC + w0 : nullptr;
        u64* d = scratch + static_cast<size_t>(y) * sw;
        for (int i = 0; i < sw; ++i) {
            const u64 v1 = r1 ? r1[i] : pad;
            const u64 v2 = r2 ? r2[i] : pad;
            d[i] = is_and ? (v1 & v2) : (v1 | v2);
        }
    }
    for (int y = 0; y < L.H; ++y)
        std::copy(scratch + static_cast<size_t>(y) * sw,
                  scratch + static_cast<size_t>(y) * sw + sw,
                  buf + static_cast<size_t>(y) * L.WC + w0);
}

static void morph_op_blocked(u64* buf, const Layout& L,
                             int k, int anchor, bool is_and) {
    const u64 pad = is_and ? ~0ull : 0ull;
    // identity reset (extension region + tail bits held the previous
    // op's opposite identity), fused with the horizontal passes so the
    // row is touched once
    std::vector<u64> hscratch(L.WC);
    for (int y = 0; y < L.H; ++y) {
        u64* row = buf + static_cast<size_t>(y) * L.WC;
        if (y < L.er) {
            std::fill(row, row + L.WC, pad);
            continue;
        }
        std::fill(row, row + L.ew, pad);
        row[L.WC - 1] = (row[L.WC - 1] & L.used_mask) | (pad & ~L.used_mask);
        if (k > 1)
            h_passes_row(row, hscratch.data(), L, k, anchor, is_and);
    }
    if (k <= 1) return;
    // stripe width: 32 words x H rows (~900 KB at A4 height) stays L2-
    // resident while amortizing the per-stripe loop overhead
    const int STRIPE_W = 32;
    std::vector<u64> vscratch(static_cast<size_t>(L.H) * STRIPE_W);
    for (int w0 = 0; w0 < L.WC; w0 += STRIPE_W)
        v_passes_stripe(buf, vscratch.data(), L, w0,
                        std::min(L.WC, w0 + STRIPE_W), k, anchor, is_and);
}

static Layout make_layout(int h, int w, int kmax) {
    Layout L;
    L.h = h;
    L.w = w;
    L.er = kmax;
    L.ew = (kmax + 63) / 64;
    const int wc = (w + 63) / 64;
    L.H = L.er + h;
    L.WC = L.ew + wc;
    const int used = (L.ew * 64 + w) & 63;  // == w & 63
    L.used_mask = used ? ((1ull << used) - 1) : ~0ull;
    return L;
}

// pack/unpack move 8.7 MB/page at A4 — a per-pixel bit loop there costs
// more than the blocked morphology itself, so both go 8 pixels at a time:
// pack gathers per-byte nonzero flags with the movemask multiply
// (0x0002040810204081 collects the 8 byte-MSBs into the top byte);
// unpack expands each bit-octet through a 2 KB LUT of 0/255 byte lanes.

static inline uint8_t pack8(u64 v) {
    // MSB of each byte = 1 iff that byte is nonzero
    const u64 nz = ((v & 0x7f7f7f7f7f7f7f7full) + 0x7f7f7f7f7f7f7f7full) | v;
    return static_cast<uint8_t>(
        ((nz & 0x8080808080808080ull) * 0x0002040810204081ull) >> 56);
}

static void pack(const uint8_t* mask, const Layout& L, u64* dst) {
    const int w8 = L.w & ~7;
    for (int y = 0; y < L.h; ++y) {
        const uint8_t* row = mask + static_cast<size_t>(y) * L.w;
        u64* d = dst + static_cast<size_t>(L.er + y) * L.WC + L.ew;
        int x = 0;
        for (; x < w8; x += 8) {
            u64 v;
            std::memcpy(&v, row + x, 8);
            d[x >> 6] |= static_cast<u64>(pack8(v)) << (x & 63);
        }
        for (; x < L.w; ++x)
            d[x >> 6] |= static_cast<u64>(row[x] != 0) << (x & 63);
    }
}

struct Expand8 {
    u64 lut[256];
    Expand8() {
        for (int b = 0; b < 256; ++b) {
            u64 v = 0;
            for (int j = 0; j < 8; ++j)
                if (b & (1 << j)) v |= 0xffull << (8 * j);
            lut[b] = v;
        }
    }
};

static void unpack(const u64* src, const Layout& L, uint8_t* out) {
    static const Expand8 expand;
    const int w8 = L.w & ~7;
    for (int y = 0; y < L.h; ++y) {
        const u64* s = src + static_cast<size_t>(L.er + y) * L.WC + L.ew;
        uint8_t* d = out + static_cast<size_t>(y) * L.w;
        int x = 0;
        for (; x < w8; x += 8) {
            const u64 v = expand.lut[(s[x >> 6] >> (x & 63)) & 0xff];
            std::memcpy(d + x, &v, 8);
        }
        for (; x < L.w; ++x)
            d[x] = static_cast<uint8_t>(
                -static_cast<int8_t>((s[x >> 6] >> (x & 63)) & 1));
    }
}

}  // namespace bitmorph

extern "C" {

// Single rectangular dilate (op=0) / erode (op=1) with a k x k kernel on a
// 0/nonzero uint8 mask; writes 0/255.  Exposed for the equality gates.
int ps_bitmorph(const uint8_t* mask, int h, int w, int k, int op,
                uint8_t* out) {
    using namespace bitmorph;
    if (h <= 0 || w <= 0 || k <= 0) return -1;
    const Layout L = make_layout(h, w, k);
    std::vector<u64> a(static_cast<size_t>(L.H) * L.WC, 0);
    pack(mask, L, a.data());
    morph_op_blocked(a.data(), L, k, k / 2, op != 0);
    unpack(a.data(), L, out);
    return 0;
}

// The full text-contours chain of pc_segmentation.text_region_mask:
// close(k) -> open(k3) -> dilate(k11) -> close(k11) on a 0/nonzero uint8
// mask; writes 0/255.
//
// Runs as FOUR composed window ops instead of the literal seven: adjacent
// same-type box ops compose exactly — a sliding AND of size a anchored at
// a/2 followed by one of size b anchored at b/2 equals a single sliding
// AND of size a+b-1 anchored at a/2+b/2 (Minkowski sum of the two
// windows; identically for OR).  The op sequence
//   D(k) E(k) E(k3) D(k3) D(k11) D(k11) E(k11)
// therefore collapses to
//   D(k) . E(k+k3-1) . D(k3+2*k11-2) . E(k11)
// which is bit-identical to the sequential chain (gated against the
// cv2/scipy composition in tests/test_torch_device_morph.py) at ~2/3 of the
// shift-combine passes at production char heights.
int ps_bitmorph_chain(const uint8_t* mask, int h, int w,
                      int k, int k3, int k11, uint8_t* out) {
    using namespace bitmorph;
    if (h <= 0 || w <= 0 || k <= 0 || k3 <= 0 || k11 <= 0) return -1;
    const int ek = k + k3 - 1;          // E(k) . E(k3)
    const int ea = k / 2 + k3 / 2;
    const int dk = k3 + 2 * k11 - 2;    // D(k3) . D(k11) . D(k11)
    const int da = k3 / 2 + k11 / 2 + k11 / 2;
    const int kmax = std::max(std::max(k, k11), std::max(ek, dk));
    const Layout L = make_layout(h, w, kmax);
    std::vector<u64> a(static_cast<size_t>(L.H) * L.WC, 0);
    pack(mask, L, a.data());
    u64* cur = a.data();
    morph_op_blocked(cur, L, k, k / 2, false);      // close(k): dilate
    morph_op_blocked(cur, L, ek, ea, true);         // close-erode + open-erode
    morph_op_blocked(cur, L, dk, da, false);        // open-dilate + grow + close-dilate
    morph_op_blocked(cur, L, k11, k11 / 2, true);   // close(k11): erode
    unpack(cur, L, out);
    return 0;
}

}  // extern "C"

// ------------------------------------------------------------ PNG unfilter
// Reconstruction of PNG row filters (sub/up/average/paeth — RFC 2083 §6)
// so that ANY non-interlaced grayscale/bilevel PNG decodes on the fast
// path: zlib inflate (C, via Python's zlib) + this pass, instead of
// falling back to a general decoder per file.  `rows` is the inflated
// stream (h rows of 1 filter byte + stride pixel bytes); `out` receives
// the reconstructed h x stride pixels.  `bpp` is the filter's byte
// distance to the "left" pixel (1 for gray-8 and all sub-byte depths).

extern "C" {

int ps_png_unfilter(const uint8_t* rows, int h, int stride, int bpp,
                    uint8_t* out) {
    if (h <= 0 || stride <= 0 || bpp <= 0) return -1;
    const uint8_t* prev = nullptr;
    for (int y = 0; y < h; ++y) {
        const uint8_t* src = rows + static_cast<size_t>(y) * (stride + 1);
        uint8_t* dst = out + static_cast<size_t>(y) * stride;
        const int f = src[0];
        const uint8_t* px = src + 1;
        switch (f) {
            case 0:  // None
                std::memcpy(dst, px, stride);
                break;
            case 1:  // Sub
                for (int i = 0; i < bpp && i < stride; ++i) dst[i] = px[i];
                for (int i = bpp; i < stride; ++i)
                    dst[i] = static_cast<uint8_t>(px[i] + dst[i - bpp]);
                break;
            case 2:  // Up
                if (prev)
                    for (int i = 0; i < stride; ++i)
                        dst[i] = static_cast<uint8_t>(px[i] + prev[i]);
                else
                    std::memcpy(dst, px, stride);
                break;
            case 3:  // Average
                for (int i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? dst[i - bpp] : 0;
                    const int b = prev ? prev[i] : 0;
                    dst[i] = static_cast<uint8_t>(px[i] + ((a + b) >> 1));
                }
                break;
            case 4:  // Paeth
                for (int i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? dst[i - bpp] : 0;
                    const int b = prev ? prev[i] : 0;
                    const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                    const int p = a + b - c;
                    const int pa = std::abs(p - a);
                    const int pb = std::abs(p - b);
                    const int pc = std::abs(p - c);
                    const int pred = (pa <= pb && pa <= pc) ? a
                                     : (pb <= pc) ? b : c;
                    dst[i] = static_cast<uint8_t>(px[i] + pred);
                }
                break;
            default:
                return -1;  // invalid filter byte: general decoder reports it
        }
        prev = dst;
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------- palette index packing
// MSB-first sub-byte index packing/unpacking for indexed PNGs (RFC 2083
// §2.3 bit order).  The numpy strided formulation re-touches the full
// label plane once per position (k passes); these read/write each byte
// exactly once.

extern "C" {

int ps_pack_indices(const uint8_t* labels, int h, int w, int depth,
                    uint8_t* out) {
    if (h <= 0 || w <= 0) return -1;
    if (depth != 1 && depth != 2 && depth != 4) return -1;
    const int k = 8 / depth;
    const int stride = (w + k - 1) / k;
    for (int y = 0; y < h; ++y) {
        const uint8_t* row = labels + static_cast<size_t>(y) * w;
        uint8_t* dst = out + static_cast<size_t>(y) * stride;
        int x = 0;
        for (int i = 0; i < stride; ++i) {
            uint8_t byte = 0;
            for (int j = 0; j < k && x < w; ++j, ++x)
                byte = static_cast<uint8_t>(
                    byte | (row[x] << (8 - depth - j * depth)));
            dst[i] = byte;
        }
    }
    return 0;
}

int ps_unpack_indices(const uint8_t* packed, int h, int stride, int w,
                      int depth, uint8_t* out) {
    if (h <= 0 || w <= 0 || stride <= 0) return -1;
    if (depth != 1 && depth != 2 && depth != 4) return -1;
    const int k = 8 / depth;
    const uint8_t mask = static_cast<uint8_t>((1 << depth) - 1);
    for (int y = 0; y < h; ++y) {
        const uint8_t* row = packed + static_cast<size_t>(y) * stride;
        uint8_t* dst = out + static_cast<size_t>(y) * w;
        int x = 0;
        for (int i = 0; i < stride && x < w; ++i) {
            const uint8_t byte = row[i];
            for (int j = 0; j < k && x < w; ++j, ++x)
                dst[x] = static_cast<uint8_t>(
                    (byte >> (8 - depth - j * depth)) & mask);
        }
    }
    return 0;
}

}  // extern "C"

// ------------------------------------------------------------- rasterizer
// PIL ImageDraw's polygon fill and line stroke (Pillow 12, "1"/"L"/"RGB"
// images, no blending), for pagexml/mask_gen.py and ops/contours.py
// fill_contour: a scanline fill over float32 edge crossings with PIL's
// rounding (ROUND_UP for a span's start, ROUND_DOWN for its end), its rule
// of counting an edge's crossing twice on the row where the edge ends above
// the last row, and its widening of the row of a vertex where two edges of
// one slope sign meet (a spike): the row is filled out to one pixel short
// of the rounded crossing of the row beyond, on the side the edges go.
// These rules were derived from Pillow 12.1 by randomized comparison;
// tests/test_torch_pagexml.py holds them on seeded random polygons and
// polylines.
// Horizontal edges are drawn as spans.  A line of width 1 is PIL's
// Bresenham walk plus its end point; a wider one fills PIL's rounded
// quadrilateral per segment.  Float arithmetic must not be contracted into
// FMAs (the library builds with -ffp-contract=off), or crossings round
// differently from PIL's.  Held against PIL in tests/test_torch_pagexml.py.

namespace raster {

struct Edge {
    int xmin, ymin, xmax, ymax;
    float dx;
    int x0, y0;
};

struct Canvas {
    uint8_t* p;
    int h, w, c;            // rows, columns, bytes per pixel
    const uint8_t* color;   // c bytes
};

static inline int round_up(float f) {
    return static_cast<int>(f >= 0.0 ? std::floor(f + 0.5F) : -std::floor(std::fabs(f) + 0.5F));
}

static inline int round_down(float f) {
    return static_cast<int>(f >= 0.0 ? std::ceil(f - 0.5F) : -std::ceil(std::fabs(f) - 0.5F));
}

static void add_edge(Edge* e, int x0, int y0, int x1, int y1) {
    e->xmin = std::min(x0, x1);
    e->xmax = std::max(x0, x1);
    e->ymin = std::min(y0, y1);
    e->ymax = std::max(y0, y1);
    e->dx = y0 == y1 ? 0.0f : static_cast<float>(x1 - x0) / (y1 - y0);
    e->x0 = x0;
    e->y0 = y0;
}

static void hline(const Canvas& im, int x0, int y, int x1) {
    if (y < 0 || y >= im.h) return;
    if (x0 < 0) x0 = 0;
    else if (x0 >= im.w) return;
    if (x1 < 0) return;
    if (x1 >= im.w) x1 = im.w - 1;
    uint8_t* row = im.p + (static_cast<size_t>(y) * im.w) * im.c;
    for (int x = x0; x <= x1; ++x)
        std::memcpy(row + static_cast<size_t>(x) * im.c, im.color, im.c);
}

static inline void point(const Canvas& im, int x, int y) {
    if (x >= 0 && x < im.w && y >= 0 && y < im.h)
        std::memcpy(im.p + (static_cast<size_t>(y) * im.w + x) * im.c, im.color, im.c);
}

// x where an edge touches row y at one of its ends
static inline int end_x(const Edge* e, int y) {
    const bool rising = e->dx > 0;
    return y == e->ymin ? (rising ? e->xmin : e->xmax) : (rising ? e->xmax : e->xmin);
}

static inline float crossing(const Edge* e, int y) {
    return (y - e->y0) * e->dx + e->x0;
}

static void fill_edges(const Canvas& im, int n, Edge* e) {
    std::vector<Edge*> table;
    table.reserve(n);
    int ymin = im.h - 1, ymax = 0;
    for (int i = 0; i < n; ++i) {
        ymin = std::min(ymin, e[i].ymin);
        ymax = std::max(ymax, e[i].ymax);
        if (e[i].ymin == e[i].ymax) {
            hline(im, e[i].xmin, e[i].ymin, e[i].xmax);
            continue;
        }
        table.push_back(e + i);
    }
    ymin = std::max(ymin, 0);
    ymax = std::min(ymax, im.h);
    const int count = static_cast<int>(table.size());
    std::vector<float> xx(2 * count + 2);
    for (int y = ymin; y <= ymax; ++y) {
        int j = 0;
        for (int i = 0; i < count; ++i) {
            const Edge* cur = table[i];
            if (y < cur->ymin || y > cur->ymax) continue;
            xx[j++] = crossing(cur, y);
            if (y == cur->ymax && y < ymax) {
                xx[j] = xx[j - 1];  // an edge ending above the last row counts twice
                ++j;
                continue;
            }
            if (cur->dx == 0) continue;
            // a spike: the first earlier edge that starts (or ends) with
            // this one at the same vertex on this row has its slope sign;
            // one of the other sign there means no spike (vertical edges
            // are passed over)
            const bool top = y == cur->ymin;
            const int vx = end_x(cur, y);
            for (int k = 0; k < i; ++k) {
                const Edge* other = table[k];
                if (other->dx == 0) continue;
                if (top ? y != other->ymin : y != other->ymax) continue;
                if (end_x(other, y) != vx) continue;
                if ((cur->dx > 0) != (other->dx > 0)) break;
                const int next = y == ymax ? y - 1 : y + 1;
                const float a = crossing(cur, next), b = crossing(other, next);
                if (top == (cur->dx > 0)) {  // the spike opens to the right
                    const int end = round_up(std::fmin(a, b)) - 1;
                    if (end > vx) xx[j - 1] = static_cast<float>(end);
                } else {
                    const int start = round_up(std::fmax(a, b) + 1);
                    if (start < vx) xx[j - 1] = static_cast<float>(start);
                }
                break;
            }
        }
        std::sort(xx.begin(), xx.begin() + j);
        for (int i = 1; i < j; i += 2)
            hline(im, round_up(xx[i - 1]), y, round_down(xx[i]));
    }
}

static void line1(const Canvas& im, int x0, int y0, int x1, int y1) {
    int dx = x1 - x0, dy = y1 - y0, xs = 1, ys = 1;
    if (dx < 0) { dx = -dx; xs = -1; }
    if (dy < 0) { dy = -dy; ys = -1; }
    if (dx == 0) {
        for (int i = 0; i < dy; ++i, y0 += ys) point(im, x0, y0);
    } else if (dy == 0) {
        for (int i = 0; i < dx; ++i, x0 += xs) point(im, x0, y0);
    } else if (dx > dy) {
        const int n = dx;
        dy += dy;
        int e = dy - dx;
        dx += dx;
        for (int i = 0; i < n; ++i, x0 += xs) {
            point(im, x0, y0);
            if (e >= 0) { y0 += ys; e -= dx; }
            e += dy;
        }
    } else {
        const int n = dy;
        dx += dx;
        int e = dx - dy;
        dy += dy;
        for (int i = 0; i < n; ++i, y0 += ys) {
            point(im, x0, y0);
            if (e >= 0) { x0 += xs; e -= dy; }
            e += dx;
        }
    }
}

static void wide_line(const Canvas& im, int x0, int y0, int x1, int y1, int width) {
    const int dx = x1 - x0, dy = y1 - y0;
    if (dx == 0 && dy == 0) {
        point(im, x0, y0);
        return;
    }
    const double length = std::hypot(dx, dy);
    const double half = (width - 1) / 2.0;
    const double ratio_max = round_up(static_cast<float>(half)) / length;
    const double ratio_min = round_down(static_cast<float>(half)) / length;
    const int dxmin = round_down(static_cast<float>(ratio_min * dy));
    const int dxmax = round_down(static_cast<float>(ratio_max * dy));
    const int dymin = round_down(static_cast<float>(ratio_min * dx));
    const int dymax = round_down(static_cast<float>(ratio_max * dx));
    const int v[4][2] = {{x0 - dxmin, y0 + dymax}, {x1 - dxmin, y1 + dymax},
                         {x1 + dxmax, y1 - dymin}, {x0 + dxmax, y0 - dymin}};
    Edge e[4];
    for (int i = 0; i < 4; ++i)
        add_edge(e + i, v[i][0], v[i][1], v[(i + 1) % 4][0], v[(i + 1) % 4][1]);
    fill_edges(im, 4, e);
}

}  // namespace raster

extern "C" {

// PIL's draw.polygon(xy, fill=color) on an (h, w, c) uint8 canvas: `count`
// (x, y) int32 vertices, closed back to the first unless it repeats.
// Returns -1 for fewer than one vertex.
int ps_fill_polygon(uint8_t* canvas, int h, int w, int c, int count,
                    const int32_t* xy, const uint8_t* color) {
    using namespace raster;
    if (count < 1 || h <= 0 || w <= 0 || c <= 0) return -1;
    const Canvas im{canvas, h, w, c, color};
    std::vector<Edge> e(count);
    int n = 0, i = 0;
    for (; i < count - 1; ++i)
        add_edge(&e[n++], xy[2 * i], xy[2 * i + 1], xy[2 * i + 2], xy[2 * i + 3]);
    if (xy[2 * i] != xy[0] || xy[2 * i + 1] != xy[1])
        add_edge(&e[n++], xy[2 * i], xy[2 * i + 1], xy[0], xy[1]);
    fill_edges(im, n, e.data());
    return 0;
}

// PIL's draw.line(xy, fill=color, width=width), without joints.
int ps_draw_lines(uint8_t* canvas, int h, int w, int c, int count,
                  const int32_t* xy, const uint8_t* color, int width) {
    using namespace raster;
    if (h <= 0 || w <= 0 || c <= 0) return -1;
    const Canvas im{canvas, h, w, c, color};
    if (width <= 1) {
        for (int i = 0; i + 1 < count; ++i)
            line1(im, xy[2 * i], xy[2 * i + 1], xy[2 * i + 2], xy[2 * i + 3]);
        if (count >= 2) point(im, xy[2 * count - 2], xy[2 * count - 1]);
    } else {
        for (int i = 0; i + 1 < count; ++i)
            wide_line(im, xy[2 * i], xy[2 * i + 1], xy[2 * i + 2], xy[2 * i + 3], width);
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------- flax's fresh weights
// The values flax's kernel initializers make on XLA's CPU backend, from
// JAX's threefry-2x32 bits of a kernel's flat indices (models/flax_init.py
// derives the keys and scales).  Written with explicit fmaf where XLA's
// code contracts a multiply-add (the build's -ffp-contract=off fuses
// nothing else), constants rounded as XLA rounds them: double literals
// cast to float for log and log1p, float literals for erf_inv.

namespace flax {

inline uint32_t f2u(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline float u2f(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// JAX's partitionable random bits of flat index i: the two threefry
// output words of the counter (i >> 32, i & 0xffffffff), XORed.
inline uint32_t bits(uint32_t k0, uint32_t k1, uint64_t i) {
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
    static constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    uint32_t x0 = static_cast<uint32_t>(i >> 32) + k0;
    uint32_t x1 = static_cast<uint32_t>(i) + k1;
    for (int r = 0; r < 5; ++r) {
        for (int j = 0; j < 4; ++j) {
            x0 += x1;
            x1 = rotl(x1, kRot[r & 1][j]) ^ x0;
        }
        x0 += ks[(r + 1) % 3];
        x1 += ks[(r + 2) % 3] + static_cast<uint32_t>(r + 1);
    }
    return x0 ^ x1;
}

// a float in [0, 1) from the top 23 bits
inline float unit(uint32_t b) { return u2f((b >> 9) | 0x3F800000u) - 1.0f; }

#define F(x) static_cast<float>(x)

// XLA's CPU float32 log of a positive normal v: Cephes' logf.
inline float xla_log(float v) {
    const uint32_t b = f2u(v);
    float e = 1.0f + static_cast<float>(static_cast<int32_t>(b >> 23) - 127);
    const float m = u2f((b & 0x807FFFFFu) | 0x3F000000u);
    const bool below = m < F(0.707106781186547524);
    const float t = (m - 1.0f) + (below ? m : 0.0f);
    e = e - (below ? 1.0f : 0.0f);
    const float x2 = t * t, x3 = x2 * t;
    float p = fmaf(fmaf(t, F(7.0376836292E-2), F(-1.1514610310E-1)), t, F(1.1676998740E-1));
    const float p1 = fmaf(fmaf(t, F(-1.2420140846E-1), F(1.4249322787E-1)), t, F(-1.6668057665E-1));
    const float p2 = fmaf(fmaf(t, F(2.0000714765E-1), F(-2.4999993993E-1)), t, F(3.3333331174E-1));
    p = fmaf(fmaf(p, x3, p1), x3, p2);
    p = fmaf(p, x3, F(-2.12194440e-4) * e);
    return fmaf(F(0.693359375), e, (t - 0.5f * x2) + p);
}

// XLA's float32 log1p of x in (-1, 0]: Cephes' rational below sqrt(2) - 1,
// else the log of 1 + x.
inline float xla_log1p(float x) {
    const float x2 = x * x;
    float num = F(4.5270000862445199635215E-5);
    num = fmaf(num, x, F(4.9854102823193375972212E-1));
    num = fmaf(num, x, F(6.5787325942061044846969E0));
    num = fmaf(num, x, F(2.9911919328553073277375E1));
    num = fmaf(num, x, F(6.0949667980987787057556E1));
    num = fmaf(num, x, F(5.7112963590585538103336E1));
    num = fmaf(num, x, F(2.0039553499201281259648E1));
    float den = 1.0f;
    den = fmaf(den, x, F(1.5062909083469192043167E1));
    den = fmaf(den, x, F(8.3047565967967209469434E1));
    den = fmaf(den, x, F(2.2176239823732856465394E2));
    den = fmaf(den, x, F(3.0909872225312059774938E2));
    den = fmaf(den, x, F(2.1642788614495947685003E2));
    den = fmaf(den, x, F(6.0118660497603843919306E1));
    const float small = x + fmaf(-0.5f, x2, (x * x2) * (num / den));
    return std::fabs(x) < F(0.41421356237309504880) ? small : xla_log(x + 1.0f);
}

// jax.random.truncated_normal(key, -2, 2) from a float in [0, 1): the
// uniform in [erf(-sqrt 2), erf(sqrt 2)) rounded once (XLA's FMA), then
// sqrt(2) * erf_inv (XLA's Giles polynomial, its w < 5 branch: |u| stays
// below erf(sqrt 2), so w below 2.5), clipped inside (-2, 2).
inline float truncated_normal(float floats) {
    const float lo = u2f(0xBF745A18u);  // erf(-2 / sqrt(2)) in float32
    const float u = std::max(lo, fmaf(floats, -lo - lo, lo));
    const float w = -xla_log1p(u * -u) - 2.5f;
    float p = 2.81022636e-08f;
    p = fmaf(p, w, 3.43273939e-07f);
    p = fmaf(p, w, -3.5233877e-06f);
    p = fmaf(p, w, -4.39150654e-06f);
    p = fmaf(p, w, 0.00021858087f);
    p = fmaf(p, w, -0.00125372503f);
    p = fmaf(p, w, -0.00417768164f);
    p = fmaf(p, w, 0.246640727f);
    p = fmaf(p, w, 1.50140941f);
    const float out = F(1.4142135623730951) * (p * u);
    return std::min(std::max(out, u2f(0xBFFFFFFFu)), u2f(0x3FFFFFFFu));
}

#undef F

}  // namespace flax

extern "C" {

// Values of the flat indices [start, start + n) of one kernel drawn from
// the key (k0, k1): law 0 glorot_uniform (the uniform [-1, 1) draw), law 1
// lecun_normal (the truncated normal), each times ``scale``.
void ps_flax_draw(uint32_t k0, uint32_t k1, int law, float scale, int64_t start, int64_t n,
                  float* out) {
    const uint64_t first = static_cast<uint64_t>(start);
    if (law == 0) {
        for (int64_t i = 0; i < n; ++i) {
            const float f = flax::unit(flax::bits(k0, k1, first + i));
            out[i] = std::max(-1.0f, f * 2.0f + -1.0f) * scale;
        }
    } else {
        for (int64_t i = 0; i < n; ++i)
            out[i] = flax::truncated_normal(flax::unit(flax::bits(k0, k1, first + i))) * scale;
    }
}

}  // extern "C"

// ------------------------------------------------------------------ zstd
// A decoder of Zstandard frames (RFC 8878): raw, RLE and compressed blocks;
// raw, RLE, Huffman (1 or 4 streams) and treeless literals; sequences with
// predefined, RLE, FSE and repeated tables and the three repeat offsets;
// skippable frames; the XXH64 content checksum.  Frames that name a
// dictionary are refused.  Every read and write is bounds-checked: corrupt
// input throws, and the C entry turns that into an error message.

namespace zstd {

[[noreturn]] void fail(const char* msg) { throw std::runtime_error(msg); }

constexpr size_t kBlockMax = 128 * 1024;

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// 64 bits little-endian from byte i of [p, p + n), zeros outside it
inline uint64_t load64(const uint8_t* p, size_t n, size_t i) {
    if (i + 8 <= n) {
        uint64_t v;
        std::memcpy(&v, p + i, 8);
        return v;
    }
    uint64_t v = 0;
    for (size_t k = 0; k < 8 && i + k < n; ++k) v |= static_cast<uint64_t>(p[i + k]) << (8 * k);
    return v;
}

// bits [lo, lo + nb) of the little-endian number p[0..n), nb <= 32; bits
// below 0 read as zeros
inline uint32_t bits_at(const uint8_t* p, size_t n, int64_t lo, int nb) {
    if (nb == 0) return 0;
    const uint64_t mask = (uint64_t(1) << nb) - 1;
    if (lo >= 0) return static_cast<uint32_t>((load64(p, n, lo >> 3) >> (lo & 7)) & mask);
    if (lo + nb <= 0) return 0;
    return static_cast<uint32_t>((load64(p, n, 0) << (-lo)) & mask);
}

// A bitstream read backwards from its last byte, whose highest set bit
// marks the end.  Reading past its start yields zeros and leaves pos < 0.
// A 64-bit window of the stream, refilled as the reads pass its low end,
// serves the reads.
struct BackBits {
    const uint8_t* p = nullptr;
    size_t n = 0;
    int64_t pos = 0;  // bits left to read
    int64_t low = 0;  // the stream bit at the window's bit 0 (a multiple of 8)
    uint64_t window = 0;
    BackBits(const uint8_t* src, size_t len) : p(src), n(len) {
        if (len == 0) fail("zstd: empty bitstream");
        if (src[len - 1] == 0) fail("zstd: bitstream without its end mark");
        pos = static_cast<int64_t>(len - 1) * 8 + highbit(src[len - 1]);
        refill();
    }
    void refill() {
        low = pos > 56 ? ((pos - 56) & ~int64_t(7)) : 0;
        window = load64(p, n, static_cast<size_t>(low >> 3));
    }
    // bits [pos - nb, pos), nb <= 32
    uint32_t peek(int nb) {
        if (pos - nb < low && low > 0) refill();
        const int64_t shift = pos - nb - low;
        const uint64_t mask = (uint64_t(1) << nb) - 1;
        if (shift >= 0) return static_cast<uint32_t>((window >> shift) & mask);
        if (-shift >= nb) return 0;  // all below the stream's start
        return static_cast<uint32_t>((window << -shift) & mask);
    }
    uint32_t read(int nb) {
        if (nb == 0) return 0;
        const uint32_t v = peek(nb);
        pos -= nb;
        return v;
    }
};

// The decoded bytes: a caller's buffer of fixed size, or one that grows
struct Out {
    uint8_t* data = nullptr;
    size_t len = 0, cap = 0;
    bool fixed = false;
    Out() = default;
    Out(uint8_t* buf, size_t size) : data(buf), cap(size), fixed(true) {}
    Out(const Out&) = delete;
    Out& operator=(const Out&) = delete;
    ~Out() {
        if (!fixed) std::free(data);
    }
    void reserve(size_t more) {
        if (more <= cap - len) return;
        if (fixed) fail("zstd: content larger than the output buffer");
        void* q = std::realloc(data, len + more);
        if (!q) fail("zstd: out of memory");
        data = static_cast<uint8_t*>(q);
        cap = len + more;
    }
    // room for n more bytes; returns where they go
    uint8_t* grow(size_t n) {
        if (n > cap - len) reserve(std::max(n, std::max(cap, size_t(1) << 16)));  // doubles
        uint8_t* at = data + len;
        len += n;
        return at;
    }
    uint8_t* release() {
        uint8_t* q = data;
        data = nullptr;
        return q;
    }
};

// A bitstream read forwards (the FSE table descriptions)
struct FwdBits {
    const uint8_t* p;
    size_t n;
    int64_t pos = 0;
    FwdBits(const uint8_t* src, size_t len) : p(src), n(len) {}
    uint32_t peek(int nb) const { return bits_at(p, n, pos, nb); }
    uint32_t read(int nb) {
        const uint32_t v = peek(nb);
        pos += nb;
        return v;
    }
    size_t bytes() const { return static_cast<size_t>((pos + 7) >> 3); }
};

struct FseEntry {
    uint16_t symbol;
    uint8_t nbits;
    uint16_t base;
};

struct Fse {
    int log = -1;  // -1: no table
    std::vector<FseEntry> t;
};

void fse_build(Fse& f, const int16_t* norm, int nsym, int log) {
    const uint32_t size = 1u << log;
    f.log = log;
    f.t.assign(size, FseEntry{0, 0, 0});
    std::vector<uint32_t> next(nsym);
    uint32_t high = size - 1;
    for (int s = 0; s < nsym; ++s) {
        if (norm[s] == -1) {
            f.t[high--].symbol = static_cast<uint16_t>(s);
            next[s] = 1;
        } else {
            next[s] = static_cast<uint32_t>(norm[s]);
        }
    }
    const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    uint32_t pos = 0;
    for (int s = 0; s < nsym; ++s)
        for (int i = 0; i < norm[s]; ++i) {
            f.t[pos].symbol = static_cast<uint16_t>(s);
            do pos = (pos + step) & mask; while (pos > high);
        }
    if (pos != 0) fail("zstd: FSE distribution does not fill its table");
    for (uint32_t u = 0; u < size; ++u) {
        const uint32_t state = next[f.t[u].symbol]++;
        const int nb = log - highbit(state);
        f.t[u].nbits = static_cast<uint8_t>(nb);
        f.t[u].base = static_cast<uint16_t>((state << nb) - size);
    }
}

// An FSE table description (RFC 8878 §4.1.1); returns the bytes it takes.
size_t fse_read(Fse& f, const uint8_t* src, size_t len, int max_symbol, int max_log) {
    if (len == 0) fail("zstd: truncated FSE table description");
    FwdBits in(src, len);
    const int log = static_cast<int>(in.read(4)) + 5;
    if (log > max_log) fail("zstd: FSE accuracy log too large");
    int16_t norm[256] = {0};
    int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1, sym = 0;
    bool previous0 = false;
    while (remaining > 1 && sym <= max_symbol) {
        if (previous0) {
            int n0 = sym;
            uint32_t r;
            while ((r = in.read(2)) == 3) n0 += 3;
            n0 += static_cast<int>(r);
            if (n0 > max_symbol) fail("zstd: FSE zero run past the last symbol");
            sym = n0;
        }
        const int max = (2 * threshold - 1) - remaining;
        int count;
        const uint32_t low = in.peek(nbits);
        if (static_cast<int>(low & (threshold - 1)) < max) {
            count = static_cast<int>(low & (threshold - 1));
            in.pos += nbits - 1;
        } else {
            count = static_cast<int>(low & (2 * threshold - 1));
            if (count >= threshold) count -= max;
            in.pos += nbits;
        }
        count -= 1;
        remaining -= count < 0 ? -count : count;
        norm[sym++] = static_cast<int16_t>(count);
        previous0 = count == 0;
        while (remaining < threshold) {
            --nbits;
            threshold >>= 1;
        }
    }
    if (remaining != 1) fail("zstd: corrupt FSE distribution");
    if (in.bytes() > len) fail("zstd: truncated FSE table description");
    fse_build(f, norm, sym, log);
    return in.bytes();
}

void fse_rle(Fse& f, uint8_t symbol) {
    f.log = 0;
    f.t.assign(1, FseEntry{symbol, 0, 0});
}

struct Huf {
    int maxbits = 0;  // 0: no table
    std::vector<uint16_t> entry;  // the symbol | its code length << 8
};

// A Huffman tree description (RFC 8878 §4.2.1); returns the bytes it takes.
size_t huf_read(Huf& h, const uint8_t* src, size_t len) {
    if (len == 0) fail("zstd: truncated Huffman tree description");
    uint8_t w[256];
    int nw = 0;
    size_t used;
    const int header = src[0];
    if (header >= 128) {
        nw = header - 127;
        used = 1 + static_cast<size_t>((nw + 1) / 2);
        if (used > len) fail("zstd: truncated Huffman weights");
        for (int i = 0; i < nw; ++i) w[i] = (i & 1) ? (src[1 + i / 2] & 15) : (src[1 + i / 2] >> 4);
    } else {
        used = 1 + static_cast<size_t>(header);
        if (used > len || header == 0) fail("zstd: truncated Huffman weights");
        Fse f;
        const size_t d = fse_read(f, src + 1, header, 255, 6);
        if (d >= static_cast<size_t>(header)) fail("zstd: Huffman weights without a bitstream");
        BackBits in(src + 1 + d, header - d);
        uint32_t s1 = in.read(f.log), s2 = in.read(f.log);
        // two interleaved states; the stream ends when a read passes its start
        for (;;) {
            if (nw > 254) fail("zstd: too many Huffman weights");
            w[nw++] = static_cast<uint8_t>(f.t[s1].symbol);
            s1 = f.t[s1].base + in.read(f.t[s1].nbits);
            if (in.pos < 0) {
                w[nw++] = static_cast<uint8_t>(f.t[s2].symbol);
                break;
            }
            if (nw > 254) fail("zstd: too many Huffman weights");
            w[nw++] = static_cast<uint8_t>(f.t[s2].symbol);
            s2 = f.t[s2].base + in.read(f.t[s2].nbits);
            if (in.pos < 0) {
                w[nw++] = static_cast<uint8_t>(f.t[s1].symbol);
                break;
            }
        }
        if (nw > 255) fail("zstd: too many Huffman weights");
    }
    uint32_t total = 0;
    for (int i = 0; i < nw; ++i) {
        if (w[i] > 11) fail("zstd: Huffman weight above 11");
        if (w[i]) total += 1u << (w[i] - 1);
    }
    if (total == 0) fail("zstd: Huffman weights all zero");
    const int maxbits = highbit(total) + 1;
    if (maxbits > 11) fail("zstd: Huffman code longer than 11 bits");
    const uint32_t rest = (1u << maxbits) - total;
    if (rest & (rest - 1)) fail("zstd: Huffman weights do not complete a tree");
    w[nw++] = static_cast<uint8_t>(highbit(rest) + 1);
    h.maxbits = maxbits;
    h.entry.assign(size_t(1) << maxbits, 0);
    size_t pos = 0;
    for (int weight = 1; weight <= maxbits; ++weight)
        for (int s = 0; s < nw; ++s)
            if (w[s] == weight) {
                const size_t n = size_t(1) << (weight - 1);
                std::fill(h.entry.begin() + pos, h.entry.begin() + pos + n,
                          static_cast<uint16_t>(s | ((maxbits + 1 - weight) << 8)));
                pos += n;
            }
    return used;
}

// Decode k Huffman streams (1 or 4) into their outputs, in lockstep while
// every stream has 4 symbols of bits left above its start (the streams'
// lookups then overlap), then each to its end, which must be exact.
void huf_streams(const Huf& h, int k, const uint8_t* const* src, const size_t* len,
                 uint8_t* const* out, const size_t* n) {
    const int mb = h.maxbits;
    const uint64_t mask = (uint64_t(1) << mb) - 1;
    const uint16_t* table = h.entry.data();
    std::vector<BackBits> in;
    in.reserve(k);
    for (int j = 0; j < k; ++j) in.emplace_back(src[j], len[j]);
    size_t done = 0, common = n[0];
    for (int j = 1; j < k; ++j) common = std::min(common, n[j]);
    for (;;) {
        bool room = done + 4 <= common;
        for (int j = 0; j < k && room; ++j) room = in[j].pos >= 4 * mb;
        if (!room) break;
        for (int j = 0; j < k; ++j)
            if (in[j].pos - 4 * mb < in[j].low) in[j].refill();
        for (int step = 0; step < 4; ++step, ++done)
            for (int j = 0; j < k; ++j) {
                BackBits& b = in[j];
                const uint16_t e = table[(b.window >> (b.pos - mb - b.low)) & mask];
                out[j][done] = static_cast<uint8_t>(e);
                b.pos -= e >> 8;
            }
    }
    for (int j = 0; j < k; ++j) {
        BackBits& b = in[j];
        for (size_t i = done; i < n[j]; ++i) {
            const uint16_t e = table[b.peek(mb)];
            out[j][i] = static_cast<uint8_t>(e);
            b.pos -= e >> 8;
        }
        if (b.pos != 0) fail("zstd: Huffman stream not consumed exactly");
    }
}

const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                             2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,    9,    10,   11,
                              12, 13, 14, 15, 16, 18, 20, 22, 24,   28,   32,   40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// What carries from block to block within a frame
struct FrameState {
    Huf huf;
    Fse ll, of, ml;
    uint32_t rep[3] = {1, 4, 8};
};

size_t read_literals(FrameState& st, const uint8_t* src, size_t len, std::vector<uint8_t>& lit) {
    if (len == 0) fail("zstd: truncated literals section");
    const int type = src[0] & 3, format = (src[0] >> 2) & 3;
    if (type < 2) {  // raw or RLE
        size_t hs, regen;
        if (format == 0 || format == 2) {
            hs = 1;
            regen = src[0] >> 3;
        } else if (format == 1) {
            hs = 2;
            if (len < hs) fail("zstd: truncated literals header");
            regen = (src[0] >> 4) + (size_t(src[1]) << 4);
        } else {
            hs = 3;
            if (len < hs) fail("zstd: truncated literals header");
            regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
        }
        if (regen > kBlockMax) fail("zstd: literals larger than a block");
        if (type == 0) {
            if (hs + regen > len) fail("zstd: truncated raw literals");
            lit.assign(src + hs, src + hs + regen);
            return hs + regen;
        }
        if (hs + 1 > len) fail("zstd: truncated RLE literals");
        lit.assign(regen, src[hs]);
        return hs + 1;
    }
    const size_t hs = format < 2 ? 3 : format == 2 ? 4 : 5;
    if (len < hs) fail("zstd: truncated literals header");
    uint64_t v = 0;
    for (size_t i = 0; i < hs; ++i) v |= uint64_t(src[i]) << (8 * i);
    const int width = format < 2 ? 10 : format == 2 ? 14 : 18;
    const size_t regen = (v >> 4) & ((uint64_t(1) << width) - 1);
    const size_t csize = (v >> (4 + width)) & ((uint64_t(1) << width) - 1);
    if (regen > kBlockMax) fail("zstd: literals larger than a block");
    if (hs + csize > len) fail("zstd: truncated compressed literals");
    const uint8_t* p = src + hs;
    size_t rem = csize;
    if (type == 2) {
        const size_t used = huf_read(st.huf, p, rem);
        p += used;
        rem -= used;
    } else if (st.huf.maxbits == 0) {
        fail("zstd: treeless literals without an earlier Huffman table");
    }
    lit.resize(regen);
    if (format == 0) {
        uint8_t* out = lit.data();
        huf_streams(st.huf, 1, &p, &rem, &out, &regen);
    } else {
        if (rem < 6) fail("zstd: truncated literals jump table");
        const size_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8), s3 = p[4] | (p[5] << 8);
        if (6 + s1 + s2 + s3 > rem) fail("zstd: literals jump table past its section");
        const size_t s4 = rem - 6 - s1 - s2 - s3, seg = (regen + 3) / 4;
        if (3 * seg > regen) fail("zstd: too few literals for 4 streams");
        const uint8_t* q = p + 6;
        const uint8_t* srcs[4] = {q, q + s1, q + s1 + s2, q + s1 + s2 + s3};
        const size_t lens[4] = {s1, s2, s3, s4}, counts[4] = {seg, seg, seg, regen - 3 * seg};
        uint8_t* outs[4] = {lit.data(), lit.data() + seg, lit.data() + 2 * seg, lit.data() + 3 * seg};
        huf_streams(st.huf, 4, srcs, lens, outs, counts);
    }
    return hs + csize;
}

size_t read_table(Fse& f, int mode, const uint8_t* src, size_t len, const int16_t* norm,
                  int nsym, int log, int max_symbol, int max_log) {
    switch (mode) {
        case 0:
            fse_build(f, norm, nsym, log);
            return 0;
        case 1:
            if (len < 1) fail("zstd: truncated RLE sequence table");
            if (src[0] > max_symbol) fail("zstd: RLE sequence symbol out of range");
            fse_rle(f, src[0]);
            return 1;
        case 2:
            return fse_read(f, src, len, max_symbol, max_log);
        default:
            if (f.log < 0) fail("zstd: repeated sequence table without an earlier one");
            return 0;
    }
}

void copy_match(Out& out, size_t frame_start, size_t offset, size_t length) {
    if (offset == 0 || offset > out.len - frame_start) fail("zstd: match offset out of range");
    uint8_t* dst = out.grow(length);
    const uint8_t* from = dst - offset;
    if (offset >= length) {
        std::memcpy(dst, from, length);
    } else if (offset >= 8) {  // 8-byte steps, each from bytes already written
        size_t i = 0;
        for (; i + 8 <= length; i += 8) std::memcpy(dst + i, from + i, 8);
        for (; i < length; ++i) dst[i] = from[i];
    } else {
        for (size_t i = 0; i < length; ++i) dst[i] = from[i];
    }
}

void compressed_block(FrameState& st, const uint8_t* src, size_t len, Out& out,
                      size_t frame_start, std::vector<uint8_t>& lit) {
    const size_t block_start = out.len;
    size_t p = read_literals(st, src, len, lit);
    if (p >= len) fail("zstd: truncated sequences section");
    size_t nseq = src[p];
    if (nseq < 128) {
        p += 1;
    } else if (nseq < 255) {
        if (p + 2 > len) fail("zstd: truncated sequence count");
        nseq = ((nseq - 128) << 8) + src[p + 1];
        p += 2;
    } else {
        if (p + 3 > len) fail("zstd: truncated sequence count");
        nseq = src[p + 1] + (size_t(src[p + 2]) << 8) + 0x7F00;
        p += 3;
    }
    size_t lit_pos = 0;
    if (nseq > 0) {
        if (p >= len) fail("zstd: truncated sequence modes");
        const int modes = src[p++];
        if (modes & 3) fail("zstd: reserved bits of the sequence modes set");
        p += read_table(st.ll, modes >> 6, src + p, len - p, kLLNorm, 36, 6, 35, 9);
        p += read_table(st.of, (modes >> 4) & 3, src + p, len - p, kOFNorm, 29, 5, 31, 8);
        p += read_table(st.ml, (modes >> 2) & 3, src + p, len - p, kMLNorm, 53, 6, 52, 9);
        if (p >= len) fail("zstd: sequences without a bitstream");
        BackBits in(src + p, len - p);
        uint32_t sll = in.read(st.ll.log), sof = in.read(st.of.log), sml = in.read(st.ml.log);
        for (size_t i = 0; i < nseq; ++i) {
            const FseEntry &ell = st.ll.t[sll], &eof = st.of.t[sof], &eml = st.ml.t[sml];
            const int ofc = eof.symbol;
            if (ofc > 31) fail("zstd: offset code out of range");
            const uint32_t ofv = static_cast<uint32_t>((uint64_t(1) << ofc) + in.read(ofc));
            const size_t ml = kMLBase[eml.symbol] + in.read(kMLBits[eml.symbol]);
            const size_t ll = kLLBase[ell.symbol] + in.read(kLLBits[ell.symbol]);
            size_t offset;
            if (ofv > 3) {
                offset = ofv - 3;
                st.rep[2] = st.rep[1];
                st.rep[1] = st.rep[0];
                st.rep[0] = static_cast<uint32_t>(offset);
            } else {
                const uint32_t idx = ofv + (ll == 0 ? 1 : 0);
                if (idx == 1) {
                    offset = st.rep[0];
                } else {
                    offset = idx == 2 ? st.rep[1] : idx == 3 ? st.rep[2] : st.rep[0] - 1;
                    if (idx != 2) st.rep[2] = st.rep[1];
                    st.rep[1] = st.rep[0];
                    st.rep[0] = static_cast<uint32_t>(offset);
                }
            }
            if (i + 1 < nseq) {
                sll = ell.base + in.read(ell.nbits);
                sml = eml.base + in.read(eml.nbits);
                sof = eof.base + in.read(eof.nbits);
            }
            if (ll > lit.size() - lit_pos) fail("zstd: sequence takes more literals than decoded");
            if (ll) std::memcpy(out.grow(ll), lit.data() + lit_pos, ll);
            lit_pos += ll;
            if (out.len + ml - block_start > kBlockMax) fail("zstd: block decodes past 128 KiB");
            copy_match(out, frame_start, offset, ml);
        }
        if (in.pos != 0) fail("zstd: sequence bitstream not consumed exactly");
    } else if (p != len) {
        fail("zstd: bytes after an empty sequences section");
    }
    if (lit.size() > lit_pos) std::memcpy(out.grow(lit.size() - lit_pos), lit.data() + lit_pos,
                                          lit.size() - lit_pos);
    if (out.len - block_start > kBlockMax) fail("zstd: block decodes past 128 KiB");
}

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
    const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;
    auto rd64 = [&](size_t i) { uint64_t v; std::memcpy(&v, p + i, 8); return v; };
    auto round = [&](uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; };
    size_t i = 0;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
        for (; i + 32 <= n; i += 32) {
            v1 = round(v1, rd64(i));
            v2 = round(v2, rd64(i + 8));
            v3 = round(v3, rd64(i + 16));
            v4 = round(v4, rd64(i + 24));
        }
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ round(0, v)) * P1 + P4;
    } else {
        h = seed + P5;
    }
    h += n;
    for (; i + 8 <= n; i += 8) h = rotl(h ^ round(0, rd64(i)), 27) * P1 + P4;
    if (i + 4 <= n) {
        uint32_t v;
        std::memcpy(&v, p + i, 4);
        h = rotl(h ^ (uint64_t(v) * P1), 23) * P2 + P3;
        i += 4;
    }
    for (; i < n; ++i) h = rotl(h ^ (p[i] * P5), 11) * P1;
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

inline uint32_t le32(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24); }

void decompress(const uint8_t* src, size_t n, Out& out) {
    if (n == 0) fail("zstd: no frame in empty input");
    std::vector<uint8_t> lit;
    size_t pos = 0;
    while (pos < n) {
        if (n - pos < 4) fail("zstd: truncated frame magic");
        const uint32_t magic = le32(src + pos);
        pos += 4;
        if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
            if (n - pos < 4) fail("zstd: truncated skippable frame");
            const size_t size = le32(src + pos);
            pos += 4;
            if (size > n - pos) fail("zstd: truncated skippable frame");
            pos += size;
            continue;
        }
        if (magic != 0xFD2FB528u) fail("zstd: not a zstd frame (bad magic number)");
        if (pos >= n) fail("zstd: truncated frame header");
        const int fhd = src[pos++];
        const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
        if (fhd & 8) fail("zstd: reserved bit of the frame header set");
        uint64_t window = 0;
        if (!single) {
            if (pos >= n) fail("zstd: truncated frame header");
            const int wd = src[pos++];
            const uint64_t base = uint64_t(1) << (10 + (wd >> 3));
            window = base + (base / 8) * (wd & 7);
        }
        static const size_t kDidSize[4] = {0, 1, 2, 4}, kFcsSize[4] = {0, 2, 4, 8};
        const size_t did_size = kDidSize[fhd & 3];
        const size_t fcs_size = fcs_flag == 0 && single ? 1 : kFcsSize[fcs_flag];
        if (n - pos < did_size + fcs_size) fail("zstd: truncated frame header");
        uint64_t dict_id = 0;
        for (size_t i = 0; i < did_size; ++i) dict_id |= uint64_t(src[pos + i]) << (8 * i);
        if (dict_id != 0) fail("zstd: frames that need a dictionary are not supported");
        pos += did_size;
        uint64_t fcs = 0;
        for (size_t i = 0; i < fcs_size; ++i) fcs |= uint64_t(src[pos + i]) << (8 * i);
        if (fcs_size == 2) fcs += 256;
        pos += fcs_size;
        if (single) window = fcs;
        const size_t block_max = static_cast<size_t>(std::min<uint64_t>(window, kBlockMax));
        if (fcs_size && !out.fixed && fcs <= (uint64_t(1) << 34)) out.reserve(fcs);
        const size_t frame_start = out.len;
        FrameState st;
        for (bool last = false; !last;) {
            if (n - pos < 3) fail("zstd: truncated block header");
            const uint32_t bh = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
            pos += 3;
            last = bh & 1;
            const int type = (bh >> 1) & 3;
            const size_t size = bh >> 3;
            if (size > block_max) fail("zstd: block larger than its maximum");
            if (type == 1) {
                if (pos >= n) fail("zstd: truncated RLE block");
                if (size) std::memset(out.grow(size), src[pos], size);
                pos += 1;
                continue;
            }
            if (size > n - pos) fail("zstd: truncated block");
            if (type == 0) {
                if (size) std::memcpy(out.grow(size), src + pos, size);
            } else if (type == 2) {
                compressed_block(st, src + pos, size, out, frame_start, lit);
            } else {
                fail("zstd: reserved block type");
            }
            pos += size;
        }
        if (fcs_size && out.len - frame_start != fcs) fail("zstd: frame content size mismatch");
        if (checksum) {
            if (n - pos < 4) fail("zstd: truncated content checksum");
            const uint32_t want = le32(src + pos);
            pos += 4;
            const uint64_t got = xxh64(out.data + frame_start, out.len - frame_start, 0);
            if (static_cast<uint32_t>(got) != want) fail("zstd: content checksum mismatch");
        }
    }
}

uint32_t crc32c_table[8][256];

void crc32c_init() {
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t c = i;
        for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
        crc32c_table[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
        for (int t = 1; t < 8; ++t)
            crc32c_table[t][i] = (crc32c_table[t - 1][i] >> 8) ^ crc32c_table[0][crc32c_table[t - 1][i] & 0xFF];
}

}  // namespace zstd

extern "C" {

// Decompress the zstd frames of src[0..n): returns a malloc'd buffer of
// *out_len bytes (free it with ps_free), or null with the reason in err.
void* ps_zstd_decompress(const uint8_t* src, size_t n, size_t* out_len, char* err, int err_len) {
    try {
        zstd::Out out;
        zstd::decompress(src, n, out);
        out.reserve(1);  // a buffer also for empty content
        *out_len = out.len;
        return out.release();
    } catch (const std::exception& e) {
        std::snprintf(err, static_cast<size_t>(err_len), "%s", e.what());
        return nullptr;
    }
}

// Decompress into dst[0..cap): returns the bytes written, or -1 with the
// reason in err (also when the content does not fit).
int64_t ps_zstd_decompress_into(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, char* err,
                                int err_len) {
    try {
        zstd::Out out(dst, cap);
        zstd::decompress(src, n, out);
        return static_cast<int64_t>(out.len);
    } catch (const std::exception& e) {
        std::snprintf(err, static_cast<size_t>(err_len), "%s", e.what());
        return -1;
    }
}

void ps_free(void* p) { std::free(p); }

// CRC-32C (Castagnoli) of src[0..n), continuing from crc (0 to start)
uint32_t ps_crc32c(const uint8_t* src, size_t n, uint32_t crc) {
    static const bool ready = (zstd::crc32c_init(), true);
    (void)ready;
    crc = ~crc;
    size_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t v;
        std::memcpy(&v, src + i, 8);
        v ^= crc;
        crc = zstd::crc32c_table[7][v & 0xFF] ^ zstd::crc32c_table[6][(v >> 8) & 0xFF] ^
              zstd::crc32c_table[5][(v >> 16) & 0xFF] ^ zstd::crc32c_table[4][(v >> 24) & 0xFF] ^
              zstd::crc32c_table[3][(v >> 32) & 0xFF] ^ zstd::crc32c_table[2][(v >> 40) & 0xFF] ^
              zstd::crc32c_table[1][(v >> 48) & 0xFF] ^ zstd::crc32c_table[0][v >> 56];
    }
    for (; i < n; ++i) crc = zstd::crc32c_table[0][(crc ^ src[i]) & 0xFF] ^ (crc >> 8);
    return ~crc;
}

}  // extern "C"
