// Host C functions of the predict paths (inference/pipeline.py,
// inference/postprocess.py, ops/cc.py): box decimation, the ink gather, the
// color/overlay/inverted trio from a raw or 2-bit packed class map, the
// 4-connected cc-majority vote, and connected components with stats
// (union-find labeling with raster-order numbering).  These run on the
// host, GIL-free through ctypes; they are not device kernels.
//
// Built at first use by native/__init__.py (g++ -O3 -shared).  Outputs are
// byte-identical to page_segmentation_tpu's native library, which
// tests/test_torch_native.py checks.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>

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
// right/bottom remainder is cropped as the pipeline never reads it).
void ps_decimate_u8(const uint8_t* src, int n, int h, int w, int factor,
                    uint8_t* dst) {
    const int oh = h / factor, ow = w / factor;
    const uint32_t area = static_cast<uint32_t>(factor) * factor;
    const uint32_t half = area / 2;
    std::vector<uint16_t> vsum(w);
    for (int page = 0; page < n; ++page) {
        const uint8_t* sp = src + static_cast<size_t>(page) * h * w;
        uint8_t* dp = dst + static_cast<size_t>(page) * oh * ow;
        for (int oy = 0; oy < oh; ++oy) {
            const uint8_t* first_row = sp + static_cast<size_t>(oy) * factor * w;
            for (int x = 0; x < w; ++x) vsum[x] = first_row[x];
            for (int fy = 1; fy < factor; ++fy) {
                const uint8_t* row = first_row + static_cast<size_t>(fy) * w;
                for (int x = 0; x < w; ++x) vsum[x] += row[x];
            }
            uint8_t* orow = dp + static_cast<size_t>(oy) * ow;
            const uint16_t* cell = vsum.data();
            for (int ox = 0; ox < ow; ++ox, cell += factor) {
                uint32_t s = 0;
                for (int fx = 0; fx < factor; ++fx) s += cell[fx];
                orow[ox] = static_cast<uint8_t>((s + half) / area);
            }
        }
    }
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
