"""Region segmentation in the port against the JAX package (which uses cv2
here): host morphology, the torch dilate/erode, contours and their fills,
the XY cut and find_segments (held to the golden corpus's frozen
rectangles), text contours, and the helpers the slice added (palette-PNG
decode, cv2's nearest resize, exact color masks, the native PNG and index
functions)."""
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_segmentation_tpu import native as jax_native
from page_segmentation_tpu.core import image_io as jax_io
from page_segmentation_tpu.core.colors import ColorMap as JaxColorMap
from page_segmentation_tpu.core.colors import exact_color_mask as jax_exact_color_mask
from page_segmentation_tpu.ops import contours as jax_contours
from page_segmentation_tpu.ops import morphology as jax_morphology
from page_segmentation_tpu.ops.resize import resize_nearest_cv as jax_resize_nearest_cv
from page_segmentation_tpu.segmentation import pc_segmentation as jax_seg
from page_segmentation_tpu.segmentation import xycut as jax_xycut
from page_segmentation_tpu_torch import native
from page_segmentation_tpu_torch.core import image_io
from page_segmentation_tpu_torch.core.colors import ColorMap, exact_color_mask
from page_segmentation_tpu_torch.ops import contours, morphology
from page_segmentation_tpu_torch.ops.resize import resize_nearest_cv
from page_segmentation_tpu_torch.pagexml import mask_gen
from page_segmentation_tpu_torch.segmentation import pc_segmentation as seg
from page_segmentation_tpu_torch.segmentation import xycut

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "tests", "golden_corpus")
SEG_MAP = {"(255, 255, 255)": (0, "background"), "(255, 0, 0)": (1, "text"),
           "(0, 255, 0)": (2, "image")}
KERNELS = [(3, 3), (4, 4), (5, 2), (2, 7), (1, 1), (6, 9)]


def _blobs(seed: int, shape=(90, 70), density=0.02, grow=3) -> np.ndarray:
    """A binary mask of random blobs, some with holes and some touching."""
    rng = np.random.default_rng(seed)
    seeds = (rng.random(shape) < density).astype(np.uint8) * 255
    blobs = jax_morphology.dilate(seeds, (grow, grow + 1))
    return np.where(rng.random(shape) < 0.03, 0, blobs).astype(np.uint8)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("image", ["gray", "rgb", "binary"])
def test_host_morphology_equals_cv2(kernel, image):
    rng = np.random.default_rng(len(image) * 10 + kernel[0])
    arr = {"gray": lambda: rng.integers(0, 256, (37, 45), dtype=np.uint8),
           "rgb": lambda: rng.integers(0, 256, (37, 45, 3), dtype=np.uint8),
           "binary": lambda: _blobs(kernel[1], (37, 45))}[image]()
    for port_fn, jax_fn in [(morphology.dilate, jax_morphology.dilate),
                            (morphology.erode, jax_morphology.erode),
                            (morphology.morph_close, jax_morphology.morph_close),
                            (morphology.morph_open, jax_morphology.morph_open)]:
        got, want = port_fn(arr, kernel), jax_fn(arr, kernel)
        assert got.shape == want.shape and (got == want).all(), port_fn.__name__
    np.testing.assert_array_equal(morphology.dilate(arr, kernel, iterations=2),
                                  jax_morphology.dilate(arr, kernel, iterations=2))


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float32])
def test_torch_dilate_erode_equal_the_jax_device_functions(kernel, dtype):
    rng = np.random.default_rng(kernel[0] * 7 + kernel[1])
    for shape in ((23, 31), (23, 31, 3)):
        arr = (rng.random(shape) * 200 - (50 if dtype != np.uint8 else 0)).astype(dtype)
        got = morphology.dilate_torch(torch.from_numpy(arr), kernel).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_morphology.dilate_jax(jnp.asarray(arr), kernel)))
        got = morphology.erode_torch(torch.from_numpy(arr), kernel).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_morphology.erode_jax(jnp.asarray(arr), kernel)))


@pytest.mark.parametrize("seed", range(6))
def test_external_contours_equal_the_jax_packages(seed):
    mask = _blobs(seed, density=0.01 + 0.01 * seed)
    got = contours.find_external_contours(mask)
    want = jax_contours.find_external_contours(mask)
    plain = contours.find_external_contours_plain(mask)
    assert len(got) == len(want) == len(plain) > 0
    for g, w, p in zip(got, want, plain):
        assert g.dtype == np.int32 and (g == w).all() and (g == p).all()
    assert contours.find_external_contours(np.zeros((5, 4), np.uint8)) == []


@pytest.mark.parametrize("seed", range(6))
def test_fill_contour_equals_cv2_draw_contours(seed):
    """Boundary-traced polygons (the family segmentation passes) filled by
    the port's rasterizer equal cv2.drawContours(..., FILLED), through the
    JAX package's cv2 path, on index and RGB canvases."""
    mask = _blobs(100 + seed, density=0.004, grow=9)
    for contour in jax_contours.find_external_contours(mask):
        for shape, value in (((90, 70), 7), ((90, 70, 3), (1, 2, 3))):
            got = np.zeros(shape, np.uint8)
            want = np.zeros(shape, np.uint8)
            contours.fill_contour(got, contour, value)
            jax_contours.fill_contour(want, contour, value)
            assert (got == want).all()
    strided = np.zeros((90, 140), np.uint8)[:, ::2]  # not C-contiguous: the mask route
    want = np.zeros((90, 70), np.uint8)
    for contour in jax_contours.find_external_contours(mask):
        contours.fill_contour(strided, contour, 5)
        jax_contours.fill_contour(want, contour, 5)
    assert (strided == want).all()


def test_contours_from_region_mask_and_nesting_pretest():
    ring = np.zeros((60, 60), np.uint8)
    ring[5:55, 5:55] = 255
    ring[15:45, 15:45] = 0
    ring[25:35, 25:35] = 255  # an island in the hole: swallowed by the fill
    for mask in (ring, _blobs(7)):
        got = seg.contours_from_region_mask(mask)
        want = jax_seg.contours_from_region_mask(mask)
        assert [c.contour.tolist() for c in got] == [c.contour.tolist() for c in want]
    assert len(seg.contours_from_region_mask(ring)) == 1


@pytest.mark.parametrize("page", range(11))
def test_find_segments_reproduces_the_frozen_xycut(page):
    with open(os.path.join(CORPUS, "frozen.json")) as f:
        frozen = json.load(f)
    setting = mask_gen.MaskSetting()
    rgb = mask_gen.page_region_to_mask(
        mask_gen.get_xml_regions(os.path.join(CORPUS, "xml", f"page{page}.xml"), setting), setting)
    texts, images = seg.find_segments(400, rgb, frozen["char_height"][f"page{page}"], 300,
                                      ColorMap(SEG_MAP))
    got = {"text": [[s.x_start, s.y_start, s.x_end, s.y_end] for s in texts],
           "image": [[s.x_start, s.y_start, s.x_end, s.y_end] for s in images]}
    assert got == frozen["xycut"][f"page{page}"]


def _prediction(seed: int, shape=(420, 310)) -> np.ndarray:
    """A label map of text lines, a figure and speckle, from a seed."""
    rng = np.random.default_rng(seed)
    labels = np.zeros(shape, np.uint8)
    for row in range(20, shape[0] - 40, 28):
        labels[row : row + 14, int(rng.integers(10, 40)) : int(rng.integers(200, 300))] = 1
    top = int(rng.integers(100, 250))
    labels[top : top + 80, 60:220] = 2
    labels[rng.random(shape) < 0.01] = int(rng.integers(0, 3))
    return labels


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("char_height", [9, 14, 22])
def test_segments_and_text_contours_equal_the_jax_packages(seed, char_height):
    labels = _prediction(seed)
    cmap, jax_cmap = ColorMap(SEG_MAP), JaxColorMap(SEG_MAP)
    rgb = cmap.palette[labels]
    for only_images in (False, True):
        got = seg.find_segments(500, rgb, char_height, 300, cmap, only_images)
        want = jax_seg.find_segments(500, rgb, char_height, 300, jax_cmap, only_images)
        assert [[vars(s) for s in g] for g in got] == [[vars(s) for s in w] for w in want]
        indexed = seg.find_segments_indexed(500, labels, cmap.palette, char_height, 300, cmap,
                                            only_images)
        assert [[vars(s) for s in g] for g in indexed] == [[vars(s) for s in w] for w in want]
    got = seg.get_text_contours(rgb, char_height, cmap)
    want = jax_seg.get_text_contours(rgb, char_height, jax_cmap)
    assert [c.contour.tolist() for c in got] == [c.contour.tolist() for c in want]
    text = labels == 1
    batch = seg.get_text_contours_batch([text, text[:200]], [char_height, char_height + 3])
    jax_batch = jax_seg.get_text_contours_batch([text, text[:200]], [char_height, char_height + 3])
    assert [[c.contour.tolist() for c in p] for p in batch] == \
        [[c.contour.tolist() for c in p] for p in jax_batch]


@pytest.mark.parametrize("char_height", [5, 12, 13, 30])
def test_host_chain_equals_its_plain_composition(char_height):
    mask = _blobs(char_height, density=0.05, grow=2)
    fused = seg.text_region_mask(mask, char_height)
    plain = seg.text_region_mask(mask[..., None], char_height)[..., 0]
    assert ((fused != 0) == (plain != 0)).all()
    assert (fused == jax_seg.text_region_mask(mask, char_height)).all()


@pytest.mark.parametrize("seed", range(5))
def test_xy_cut_and_profile_tables_equal_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    image = _prediction(seed, (200, 150)) == 1
    thresholds = [int(v) for v in rng.integers(1, 12, 4)]
    got = xycut.do_xy_cut(image, *thresholds)
    want = jax_xycut.do_xy_cut(image, *thresholds)
    assert [vars(s) for s in got] == [vars(s) for s in want]
    batch = np.stack([image, ~image, rng.random(image.shape) < 0.3])
    for tables, page in zip(xycut.profile_tables_batch(batch, device="cpu"), batch):
        plain = xycut.ProfileTables.of_image(page)
        assert (tables.down == plain.down).all() and (tables.right == plain.right).all()
        assert [vars(s) for s in xycut.do_xy_cut(page, *thresholds, tables=tables)] == \
            [vars(s) for s in jax_xycut.do_xy_cut(page, *thresholds)]


def test_profile_tables_batch_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        xycut.profile_tables_batch(np.zeros((1, 4, 4), bool))


@pytest.mark.parametrize("seed", range(4))
def test_resize_nearest_cv_and_exact_color_mask_equal_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 3, (int(rng.integers(50, 900)), int(rng.integers(50, 700)), 3),
                         dtype=np.uint8) * 127
    for out in [(300, int(rng.integers(20, 400))), (int(rng.integers(5, 60)), 7)]:
        np.testing.assert_array_equal(resize_nearest_cv(image, out), jax_resize_nearest_cv(image, out))
        np.testing.assert_array_equal(resize_nearest_cv(image[..., 0], out),
                                      jax_resize_nearest_cv(image[..., 0], out))
    for color in [(0, 0, 0), (254, 127, 0), (127, 254, 254)]:
        np.testing.assert_array_equal(exact_color_mask(image, color), jax_exact_color_mask(image, color))
    cmap, jax_cmap = ColorMap(SEG_MAP), JaxColorMap(SEG_MAP)
    for label in ("text", "image", "background"):
        np.testing.assert_array_equal(cmap.filter_label(image, label), jax_cmap.filter_label(image, label))
        np.testing.assert_array_equal(cmap.filter_label(image[..., 0] // 127, label),
                                      jax_cmap.filter_label(image[..., 0] // 127, label))
        assert cmap.color_for_label(label) == jax_cmap.color_for_label(label)
        assert cmap.index_for_label(label) == jax_cmap.index_for_label(label)


@pytest.mark.parametrize("n_colors, width", [(2, 33), (3, 41), (5, 17), (12, 9), (200, 30)])
def test_palette_png_decode_equals_the_jax_packages(n_colors, width, tmp_path):
    """Palette PNGs from the JAX writer (filter 0) and from PIL (filtered
    rows, which go through the native unfilter) decode to the same labels
    and palette in both packages; other files are not palette PNGs."""
    from PIL import Image

    rng = np.random.default_rng(n_colors)
    labels = rng.integers(0, n_colors, (23, width), dtype=np.uint8)
    labels[:, : width // 2] = labels[:1, : width // 2]  # runs that PIL's filters compress
    palette = rng.integers(0, 256, (n_colors, 3), dtype=np.uint8)
    jax_io.imsave_indexed(str(tmp_path / "a.png"), labels, palette)
    im = Image.fromarray(labels, "P")
    im.putpalette(palette.tobytes())
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    (tmp_path / "b.png").write_bytes(buf.getvalue())
    stream = (tmp_path / "b.png").read_bytes()
    if n_colors <= 16:  # PIL filters the rows of its sub-byte palette PNGs
        assert image_io._png_rows(stream) is None
    for name in ("a.png", "b.png"):
        got = image_io.imread_labels(str(tmp_path / name))
        want = jax_io.imread_labels(str(tmp_path / name))
        assert (got[0] == want[0]).all() and (got[1] == want[1]).all()
        assert (got[1][got[0]] == jax_io.imread_rgb(str(tmp_path / name))).all()
    image_io.imsave(str(tmp_path / "rgb.png"), palette[labels])
    assert image_io.imread_labels(str(tmp_path / "rgb.png")) is None
    assert image_io.decode_labels_bytes(b"not a png") is None
    assert image_io.decode_labels_bytes((tmp_path / "a.png").read_bytes()[:60]) is None


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_native_png_and_index_functions_equal_the_jax_packages(depth):
    rng = np.random.default_rng(depth)
    labels = rng.integers(0, 1 << depth, (13, 29), dtype=np.uint8)
    packed = native.pack_indices(labels, depth)
    np.testing.assert_array_equal(packed, jax_native.pack_indices(labels, depth))
    np.testing.assert_array_equal(native.unpack_indices(packed, 29, depth), labels)
    rows = rng.integers(0, 256, (9, 17), dtype=np.uint8)
    rows[:, 0] = rng.integers(0, 5, 9)
    for bpp in (1, 3):
        np.testing.assert_array_equal(native.png_unfilter(rows, bpp), jax_native.png_unfilter(rows, bpp))
    rows[3, 0] = 9
    assert native.png_unfilter(rows) is None and jax_native.png_unfilter(rows) is None
    mask = _blobs(depth)
    for k in (1, 4, 7):
        for erode in (False, True):
            np.testing.assert_array_equal(native.bitmorph(mask, k, erode),
                                          jax_native.bitmorph(mask, k, erode))
    assert image_io.split_filename("/a/b.c/page.x.png") == jax_io.split_filename("/a/b.c/page.x.png")
    assert list(image_io.chunks(list(range(7)), 3)) == list(jax_io.chunks(list(range(7)), 3))
