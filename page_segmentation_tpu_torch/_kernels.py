"""Build and load the port's compiled libraries at first use.

Two kinds of library, both bound through a plain C interface with ctypes:

* the hand-written CUDA kernels under ``csrc/``, compiled by ``nvcc`` for
  Hopper (``sm_90a``) — :data:`KERNELS`;
* the host C functions under ``native/`` (g++), see ``native/__init__.py``.

Each library is built into ``_build/`` next to this file (listed in
``.gitignore``), under a name that carries a digest of its compiler, flags
and sources, so an edited source never loads a stale build.  A build writes
to a private temporary name and is renamed into place, so processes that
build the same library at once do not see each other's partial output.
:func:`build_libraries` starts one compiler process per library, all at
once, and waits for them together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterable, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR / "_build"
BUILD_TIMEOUT_S = 600


def _nvcc() -> str:
    for candidate in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels are built from source at first use"
    )


def _gxx() -> str:
    return os.environ.get("CXX", "g++")


@dataclass(frozen=True)
class LibrarySpec:
    """A shared library built from ``sources`` (paths relative to the
    package) by ``compiler`` (a callable returning its path) with ``flags``."""

    name: str
    compiler: Callable[[], str]
    flags: Tuple[str, ...]
    sources: Tuple[str, ...]

    def source_paths(self):
        return [PACKAGE_DIR / s for s in self.sources]

    def target(self) -> Path:
        digest = hashlib.sha256()
        digest.update(" ".join((self.compiler(),) + self.flags).encode())
        for path in self.source_paths():
            digest.update(path.read_bytes())
        return BUILD_DIR / f"lib{self.name}-{digest.hexdigest()[:16]}.so"


# nvcc: Hopper target with the `a` features (wgmma, setmaxnreg), plain C
# interface (no PyTorch headers: seconds to build instead of minutes);
# -Xptxas=-v reports registers/spills in the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

KERNELS: Dict[str, LibrarySpec] = {
    "cc_label": LibrarySpec("cc_label", _nvcc, NVCC_FLAGS, ("csrc/cc_label.cu",)),
    "add_one": LibrarySpec("add_one", _nvcc, NVCC_FLAGS, ("csrc/add_one.cu",)),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def build_libraries(specs: Iterable[LibrarySpec]) -> Dict[str, str]:
    """Build every library of ``specs`` that is not built yet, one compiler
    process each, all started together.  Returns {name: compiler log} for
    the libraries built now; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for spec in specs:
        target = spec.target()
        if target.exists():
            continue
        tmp = target.with_name(
            f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp"
        )
        cmd = [spec.compiler(), *spec.flags, "-o", str(tmp),
               *map(str, spec.source_paths())]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((spec, target, tmp, proc))
    logs = {}
    failures = []
    for spec, target, tmp, proc in jobs:
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failures.append(f"{spec.name}: compiler timed out\n{log}")
            continue
        if proc.returncode != 0:
            failures.append(f"{spec.name}: exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)
        logs[spec.name] = log
    if failures:
        raise RuntimeError("library build failed:\n" + "\n".join(failures))
    return logs


def load_library(spec: LibrarySpec) -> ctypes.CDLL:
    """The loaded library of ``spec``, built first if needed."""
    with _lock:
        lib = _loaded.get(spec.name)
        if lib is None:
            build_libraries([spec])
            lib = ctypes.CDLL(str(spec.target()))
            _loaded[spec.name] = lib
        return lib
