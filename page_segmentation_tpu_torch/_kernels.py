"""Build and load the port's compiled libraries at first use, and launch
their kernels.

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

A kernel's C entry point is an :class:`Entry`, made once at module level by
the wrapper that launches it.  Its first call builds and loads the library
and types the function (under a lock); from then on the bound ctypes
function is an attribute of the entry, so :func:`launch` takes no lock and
looks nothing up.  :func:`launch` passes the caller's current CUDA stream as
a raw integer (no ``torch.cuda.Stream`` is built) and enters a device guard
only when the tensor's card is not the current one (never asking which card
is current when the process sees one card).
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
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

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
    "jax_random": LibrarySpec("jax_random", _nvcc, NVCC_FLAGS, ("csrc/jax_random.cu",)),
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


class Entry:
    """The C function ``symbol`` of the kernel library ``kernel`` (a key of
    :data:`KERNELS`), taking ``argtypes`` and then the stream, returning a
    CUDA error code.  Bound at its first launch."""

    __slots__ = ("kernel", "symbol", "argtypes", "fn", "one_card")

    def __init__(self, kernel: str, symbol: str, argtypes: Tuple):
        self.kernel, self.symbol, self.argtypes = kernel, symbol, argtypes
        self.fn: Optional[Callable[..., int]] = None
        # with one visible card every tensor's card is the current one
        self.one_card = False

    def bind(self) -> Callable[..., int]:
        fn = getattr(load_library(KERNELS[self.kernel]), self.symbol)
        fn.argtypes = [*self.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self.one_card = torch.cuda.device_count() == 1
        self.fn = fn
        return fn


def current_raw_stream(index: int) -> int:
    """The current stream of card ``index`` as the integer handle that
    ``torch.cuda.current_stream(index).cuda_stream`` gives, without building
    the ``Stream`` object (the function exists only in CUDA builds of
    torch)."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(entry: Entry, index: int, *args) -> None:
    """Call ``entry`` with ``args`` and the current stream of card ``index``,
    on that card; raises on a nonzero CUDA error code."""
    fn = entry.fn or entry.bind()
    # the stream is what current_raw_stream(index) returns, read inline
    if entry.one_card or index == torch._C._cuda_getDevice():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc:
        raise RuntimeError(f"{entry.symbol} launch failed: CUDA error {rc}")
