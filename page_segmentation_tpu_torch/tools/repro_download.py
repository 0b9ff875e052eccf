"""Download-race check: does a result come back whole from the card while
other host-to-device traffic is in flight?

Port of ``tools/repro_pallas_download.py``.  On the TPU runtime the JAX
package was built on, the download of a program holding a Pallas kernel came
back empty when another device transfer overlapped it, so the JAX pipeline
serializes that case.  ``ThroughputPredictor.run`` in this package overlaps
its labeler's dispatch and download with side-stream uploads for every vote
placement; this tool is the check behind that.

Each trial builds a page-sized (424, 304) uint8 array from its seed, uploads
it, dispatches one arm on the current stream, and downloads the result while
a second thread keeps uploading random (64, 1024) uint8 arrays.  Every copy
goes through the pipeline's own ``inference/pipeline.py``
``DeviceTransfers``: uploads from pinned memory on a side stream followed by
an event, and the download as a non-blocking copy into pinned memory
followed by an event.  Two arms:

* the kernel arm: in ``simple`` mode ``add_one`` (``csrc/add_one.cu``); in
  the real mode the batched cc-majority vote on the CUDA labeler
  (``csrc/cc_label.cu``), with ``pred = x % 3`` and ``ink = x != 0``;
* the plain arm, the control: the plain PyTorch versions of the same
  functions, run on the card.

Every download is held against the host's answer (``x + 1``, or the native
union-find vote).  Run on the card:

    python -m page_segmentation_tpu_torch.tools.repro_download [--simple] [--trials N]

Prints one line per trial and the totals; exits 1 if any kernel-arm download
was corrupt while the plain arm stayed clean.  ``device="cpu"`` runs the
plain versions with no streams (for the tests).
"""
from __future__ import annotations

import sys
import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from ..inference.pipeline import DeviceTransfers

SHAPE = (424, 304)  # a normalized page
N_CLASSES = 3


def _arms(simple: bool, dev: torch.device):
    """{arm: fn(x on dev) -> tensor on dev} and the host oracle."""
    if simple:
        from ..ops.cuda_add_one import add_one, add_one_reference

        def expected(x):
            return x.astype(np.int32) + 1

        return {"kernel": lambda x: add_one(x, device=dev), "plain": add_one_reference}, expected

    from .. import native
    from ..ops.cuda_cc import _vote_from_labels, cc_min_label_reference, cc_vote_batch

    def kernel(x):
        pred, ink = (x % N_CLASSES).to(torch.int32), x != 0
        return cc_vote_batch(pred[None], ink[None], n_classes=N_CLASSES, device=dev)[0]

    def plain(x):
        pred, ink = (x % N_CLASSES).to(torch.int32)[None], (x != 0)[None]
        labels, _ = cc_min_label_reference(ink)
        return _vote_from_labels(pred, ink, labels, N_CLASSES)[0]

    def expected(x):
        return native.cc_vote(x != 0, (x % N_CLASSES).astype(np.int32), N_CLASSES)

    return {"kernel": kernel, "plain": plain}, expected


def trial_input(rng: np.random.RandomState) -> np.ndarray:
    """A trial's (424, 304) uint8 page: 40 % of pixels nonzero."""
    return (rng.rand(*SHAPE) > 0.6).astype(np.uint8) * rng.randint(1, 255, SHAPE).astype(np.uint8)


def _trial(fn, expected, traffic: DeviceTransfers, seed: int):
    """Dispatch ``fn`` on the page of ``seed``, then download its result
    while a second thread keeps uploading; None if the download is whole and
    right, else what was wrong."""
    rng = np.random.RandomState(seed)
    x = trial_input(rng)
    out = fn(traffic.take(traffic.put(x)))
    stop = threading.Event()
    errors = []

    def interfere():
        try:
            while not stop.is_set():
                _, ready = traffic.put(rng.randint(0, 255, (64, 1024)).astype(np.uint8))
                if ready is not None:
                    ready.synchronize()
        except Exception as exc:  # reported with the trial, never lost
            errors.append(exc)

    thread = threading.Thread(target=interfere)
    thread.start()
    try:
        time.sleep(0.005)
        host = traffic.wait_download(traffic.start_download(out))
    finally:
        stop.set()
        thread.join(timeout=60)
    if errors:
        raise RuntimeError(f"upload thread failed: {errors[0]!r}") from errors[0]
    if thread.is_alive():
        raise RuntimeError("upload thread did not stop")
    if host.size != x.size:
        return f"corrupt download: size {host.size} != {x.size}"
    if not np.array_equal(host, expected(x)):
        return "corrupt download: wrong contents"
    return None


def run(trials: int = 20, simple: bool = False, device="cuda"):
    """Run ``trials`` trials of both arms; prints one line per trial and
    returns {arm: corrupt downloads}."""
    dev = resolve_device(device)
    arms, expected = _arms(simple, dev)
    traffic = DeviceTransfers(dev)
    failures = {name: 0 for name in arms}
    for i in range(trials):
        for name, fn in arms.items():
            err = _trial(fn, expected, traffic, seed=i)
            print(f"trial {i:2d} {name:6s}: {f'FAIL ({err})' if err else 'ok'}", flush=True)
            failures[name] += bool(err)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"failures ({'simple' if simple else 'real'} mode): kernel={failures['kernel']}/{trials} "
          f"plain={failures['plain']}/{trials} on {where}", flush=True)
    return failures


def main(trials: int = 20, simple: bool = False, device="cuda") -> int:
    """1 if any kernel-arm download was corrupt while the plain arm stayed
    clean, else 0."""
    failures = run(trials, simple, device)
    return 1 if failures["kernel"] and not failures["plain"] else 0


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trials", type=int, default=20)
    parser.add_argument("--simple", action="store_true",
                        help="the elementwise add_one kernel instead of the cc vote")
    args = parser.parse_args()
    sys.exit(main(args.trials, args.simple))
