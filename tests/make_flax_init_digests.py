"""Frozen digests of the JAX package's fresh weights, for the port's draw.

``tests/flax_init_digests.json`` holds, for each model the JAX package
builds (the 14 architectures, and FCN / FCNSkip with the s2d stem as
``fcn:s2d`` and ``fcn_skip:s2d``), the SHA-256 of the float32 bytes of every
leaf of ``PixelClassifier(3, architecture, seed=0).variables``.  The tree
mirrors the variables; each leaf is an index into ``digests`` (equal
constant leaves share one).  A leaf whose port draw (``models/bridge.py``
``init_variables``) is not bit-equal would instead hold
``{"digest": i, "sum": s, "sum_sq": q}``, the float64 sum and sum of squares
of the JAX values; today none does.

The card's machine has no JAX, so ``chip_smoke.py`` checks the port's
fresh weights against this file; ``tests/test_torch_flax_init*.py`` check
it here.  Regenerate (about 5 minutes on 8 CPU cores; ``jax.jit`` of
``module.init``, which gives the eager init's bytes,
``tests/test_torch_flax_init_effnet.py::test_jit_init_is_eager_init``):

    JAX_PLATFORMS=cpu python tests/make_flax_init_digests.py
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "flax_init_digests.json")
SEED = 0
N_CLASSES = 3
ARCHITECTURES = ("fcn_skip", "fcn", "image_res_net", "res_unet", "mobile_net", "unet",
                 "effb0", "effb1", "effb2", "effb3", "effb4", "effb5", "effb6", "effb7")
MODELS = ARCHITECTURES + ("fcn_skip:s2d", "fcn:s2d")


def split(model: str):
    """(architecture name, s2d stem) of a ``MODELS`` entry."""
    name, _, stem = model.partition(":")
    return name, stem == "s2d"


def leaves(tree, path=()):
    """(path, leaf) of a variables tree or of a frozen entry, whose leaves
    are digest indices or ``{"digest", "sum", "sum_sq"}`` dicts."""
    for key, value in tree.items():
        if isinstance(value, dict) and "digest" not in value:
            yield from leaves(value, path + (key,))
        else:
            yield path + (key,), value


def digest(value: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(value, np.float32).tobytes()).hexdigest()


def mismatches(variables, entry, digests) -> list:
    """The leaves of ``variables`` (numpy, the JAX layout) that disagree
    with a model's ``entry`` of the frozen file: a missing or extra leaf, a
    digest that differs, or (for a leaf kept by its sums) sums off by more
    than 1e-6 relative."""
    expected = dict(leaves(entry))
    got = dict(leaves(variables))
    bad = sorted("/".join(p) for p in set(expected) ^ set(got))
    for path, value in got.items():
        want = expected.get(path)
        if want is None:
            continue
        if isinstance(want, dict):
            v = np.asarray(value, np.float64)
            ok = all(abs(x - want[k]) <= 1e-6 * max(1.0, abs(want[k]))
                     for x, k in ((v.sum(), "sum"), ((v * v).sum(), "sum_sq")))
        else:
            ok = digest(value) == digests[want]
        if not ok:
            bad.append("/".join(path))
    return bad


def jax_variables(model: str, seed: int = SEED) -> dict:
    """The JAX package's ``PixelClassifier(3, ..., seed=seed).variables``:
    ``module.init`` of its dummy input under ``jax.jit``."""
    import jax
    import jax.numpy as jnp

    from page_segmentation_tpu.models.registry import Architecture

    name, s2d = split(model)
    arch = Architecture(name)
    module = arch.model(N_CLASSES, s2d_stem=s2d)
    h = arch.stride_factor * 2
    dummy = jnp.zeros((1, h, h, 3 if arch.preprocess()[1] else 1), jnp.float32)
    rng = jax.random.PRNGKey(seed)
    variables = jax.jit(module.init)({"params": rng, "dropout": rng}, dummy)
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), dict(variables))


def port_variables(model: str, seed: int = SEED) -> dict:
    """The port's fresh variables of ``model`` (drawn from shapes only)."""
    import torch

    from page_segmentation_tpu_torch.models.bridge import init_variables
    from page_segmentation_tpu_torch.models.registry import Architecture

    name, s2d = split(model)
    with torch.device("meta"):
        module = Architecture(name).model(N_CLASSES, s2d_stem=s2d)
    return init_variables(module, seed)


def entry_for(model: str, digests: list) -> dict:
    """A model's frozen entry from a live JAX init; appends new digests."""
    reference = jax_variables(model)
    port = dict(leaves(port_variables(model)))
    positions = {d: i for i, d in enumerate(digests)}

    def index(value, path):
        d = digest(value)
        if d not in positions:
            positions[d] = len(digests)
            digests.append(d)
        if path in port and digest(port[path]) == d:
            return positions[d]
        v = np.asarray(value, np.float64)
        return {"digest": positions[d], "sum": float(v.sum()), "sum_sq": float((v * v).sum())}

    return _nest({path: index(value, path) for path, value in leaves(reference)})


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, value in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=PATH)
    parser.add_argument("--models", nargs="*", default=list(MODELS))
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax
    import flax

    digests: list = []
    models = {}
    for model in args.models:
        start = time.time()
        models[model] = entry_for(model, digests)
        print(f"{model}: {time.time() - start:.1f} s", flush=True)
    doc = {"seed": SEED, "n_classes": N_CLASSES,
           "source": f"page_segmentation_tpu PixelClassifier(n_classes, architecture, seed).variables"
                     f" on the CPU, jax {jax.__version__}, flax {flax.__version__}",
           "models": models, "digests": digests}
    with open(args.out, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
