"""The port's ``TensorboardWriter`` (``train/callbacks.py``) against the JAX
package's, which writes through ``tf.summary`` when tensorflow imports (as
here): the same scalars and images through both, both event files read
back by tensorflow, every record's CRC checked on the way.  The port's
writer imports neither tensorflow nor protobuf."""
import os
import subprocess
import sys

import numpy as np
import pytest

from page_segmentation_tpu.train.callbacks import TensorboardWriter as JaxWriter
from page_segmentation_tpu_torch.train import callbacks
from page_segmentation_tpu_torch.train.callbacks import TensorboardWriter

tf = pytest.importorskip("tensorflow")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(cls, outdir):
    rng = np.random.default_rng(0)
    writer = cls(str(outdir), max_outputs=2)
    writer.save_scalar("loss", 0.5, 3)
    writer.save_scalar("val/accuracy", np.float32(1 / 3), 7)
    writer.save_scalar("lr", 1e-4, 0)
    writer.save_image("rgb", rng.integers(0, 256, (3, 5, 7, 3), dtype=np.uint8))
    writer.save_image("gray", rng.uniform(-0.2, 1.2, (2, 4, 6, 1)).astype(np.float32))
    writer.save_image("rgba", rng.integers(0, 256, (1, 3, 2, 4), dtype=np.uint8))
    writer.save_scalar("loss", 0.25, 4)
    writer.close()
    files = os.listdir(outdir)
    assert len(files) == 1 and files[0].startswith("events.out.tfevents."), files
    return os.path.join(outdir, files[0])


def _read(path):
    """(step, tag, plugin, value) of every summary value; scalars as floats,
    images as (width, height, decoded pixels...)."""
    events = list(tf.compat.v1.train.summary_iterator(path))
    assert events[0].file_version == "brain.Event:2"
    out = []
    for event in events[1:]:
        for v in event.summary.value:
            plugin = v.metadata.plugin_data.plugin_name
            if plugin == "scalars":
                value = float(tf.make_ndarray(v.tensor))
                assert v.tensor.dtype == tf.float32.as_datatype_enum
            else:
                width, height, *pngs = v.tensor.string_val
                value = (width, height, [tf.io.decode_png(p).numpy().tolist() for p in pngs])
            out.append((event.step, v.tag, plugin, value))
    return out


def test_event_file_reads_back_as_the_jax_writers(tmp_path):
    want = _read(_write(JaxWriter, tmp_path / "jax"))
    got = _read(_write(TensorboardWriter, tmp_path / "port"))
    assert [g[:3] for g in got] == [w[:3] for w in want]
    assert got == want
    # the counter steps the images, max_outputs limits them
    assert [(s, t) for s, t, p, _ in got if p == "images"] == [(0, "rgb"), (1, "gray"), (2, "rgba")]
    assert len(got[3][3][2]) == 2


def test_records_carry_checked_crcs(tmp_path):
    assert callbacks.masked_crc32c(b"123456789") == \
        ((((0xE3069283 >> 15) | (0xE3069283 << 17)) + 0xA282EAD8) & 0xFFFFFFFF)  # CRC-32C check value
    path = _write(TensorboardWriter, tmp_path / "port")
    with open(path, "rb") as f:
        data = f.read()
    assert sum(1 for _ in tf.compat.v1.io.tf_record_iterator(path)) == 8
    broken = tmp_path / "broken" / os.path.basename(path)
    broken.parent.mkdir()
    broken.write_bytes(data[:-5] + bytes([data[-5] ^ 1]) + data[-4:])
    with pytest.raises(tf.errors.DataLossError):
        list(tf.compat.v1.io.tf_record_iterator(str(broken)))


def test_writer_imports_neither_tensorflow_nor_protobuf(tmp_path):
    code = ("import sys, numpy as np\n"
            "from page_segmentation_tpu_torch.train.callbacks import TensorboardWriter\n"
            f"w = TensorboardWriter({str(tmp_path)!r})\n"
            "w.save_scalar('loss', 1.0, 1)\n"
            "w.save_image('x', np.zeros((1, 2, 2, 3), np.uint8))\n"
            "w.close()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('tensorflow', 'tensorboard')\n"
            "       or m.startswith('google.protobuf')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
