"""The port's zstd decoder (``native/ps_native.cpp`` ``ps_zstd_decompress``)
against the ``zstandard`` package, on the CPU.

Tolerance: none.  Frames that ``zstandard`` writes at levels 1, 3, 9 and 19,
with and without a content checksum, decode to the same bytes: empty, one
byte and > 128 KiB inputs of zeros, random float32 and repetitive text,
concatenated frames, skippable frames, and the chunk frames of a real orbax
save (``tests/orbax_fixture/``).  Truncated and bit-flipped frames raise.
The port's raw-block frames (``train/orbax_format.py`` ``zstd_frame``)
decode in ``zstandard``."""
import os

import numpy as np
import pytest

from page_segmentation_tpu_torch import native
from page_segmentation_tpu_torch.train import orbax_format
from tests import make_orbax_fixture

zstandard = pytest.importorskip("zstandard")

LEVELS = (1, 3, 9, 19)


def _inputs():
    rng = np.random.default_rng(0)
    text = b"".join(b"region %d: text line %d of the page\n" % (i % 7, i % 53)
                    for i in range(12000))
    return {
        "empty": b"",
        "one_byte": b"x",
        "zeros": bytes(300_000),
        "random_float32": rng.standard_normal(90_000).astype(np.float32).tobytes(),
        "repetitive_text": text,
        "small_weights": (rng.standard_normal(5000) * 0.05).astype(np.float32).tobytes(),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("checksum", [False, True], ids=["no_checksum", "checksum"])
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_decodes_zstandard_frames(name, level, checksum):
    data = INPUTS[name]
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert native.zstd_decompress(frame) == data


@pytest.mark.parametrize("level", LEVELS)
def test_decodes_streamed_frames_without_content_size(level):
    # a stream writer flushes blocks as they come and names no content size
    data = INPUTS["repetitive_text"] + INPUTS["random_float32"]
    stream = zstandard.ZstdCompressor(level=level).compressobj()
    out = b"".join(stream.compress(data[i : i + 50_000])
                   + stream.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
                   for i in range(0, len(data), 50_000)) + stream.flush()
    assert out[4] >> 6 == 0  # no content size in the header
    assert native.zstd_decompress(out) == data


def test_concatenated_and_skippable_frames():
    a, b = INPUTS["repetitive_text"], INPUTS["small_weights"]
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"hello"
    frames = (zstandard.ZstdCompressor(level=3).compress(a) + skippable
              + zstandard.ZstdCompressor(level=19, write_checksum=True).compress(b))
    assert native.zstd_decompress(frames) == a + b


def test_chunk_frames_of_an_orbax_save():
    store = orbax_format.read_ocdbt(os.path.join(make_orbax_fixture.DIRECTORY,
                                                 str(make_orbax_fixture.STEP), "state"))
    chunks = [bytes(v) for k, v in store.items() if not k.endswith(b"/.zarray")]
    assert len(chunks) > 20
    for frame in chunks:
        assert native.zstd_decompress(frame) == zstandard.ZstdDecompressor().decompress(
            frame, max_output_size=1 << 24)
    big = bytes(store[b"variables.batch_stats.bn_big.mean/0"])
    assert {"literals:huffman", "sequences:fse"} <= make_orbax_fixture.block_kinds(big)


@pytest.mark.parametrize("n", [0, 1, 255, 256, 65791, 65792, 131072, 131073, 400_000])
def test_raw_block_frames_decode_in_zstandard(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    frame = orbax_format.zstd_frame(data)
    assert len(frame) <= n + 16 + 3 * (n // (128 * 1024) + 1)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert native.zstd_decompress(frame) == data


def test_corrupt_frames_raise():
    rng = np.random.default_rng(7)
    data = INPUTS["repetitive_text"][:40_000] + INPUTS["random_float32"][:40_000]
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    for cut in (0, 3, 4, 6, 10, len(frame) // 2, len(frame) - 1):
        with pytest.raises(ValueError, match="zstd"):
            native.zstd_decompress(frame[:cut])
    raised = 0
    for _ in range(300):
        bad = bytearray(frame)
        bad[int(rng.integers(0, len(bad)))] ^= 1 << int(rng.integers(0, 8))
        try:
            out = native.zstd_decompress(bytes(bad))
        except ValueError:
            raised += 1
            continue
        # a flip that decodes (the header's unused bit) gives the data itself:
        # the content checksum catches every other
        assert out == data
    assert raised >= 290
    with pytest.raises(ValueError, match="magic"):
        native.zstd_decompress(b"not zstd at all")


def test_dictionary_frames_are_refused():
    samples = [b"region %d: text line %d of page %d" % (i % 7, i, i % 11) for i in range(2000)]
    dictionary = zstandard.train_dictionary(2048, samples)
    assert dictionary.dict_id() != 0
    frame = zstandard.ZstdCompressor(level=3, dict_data=dictionary).compress(samples[5])
    with pytest.raises(ValueError, match="dictionary"):
        native.zstd_decompress(frame)


def test_crc32c():
    assert native.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    assert native.crc32c(b"") == 0
    assert native.crc32c(b"56789", native.crc32c(b"1234")) == 0xE3069283
