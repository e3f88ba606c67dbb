"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, bound through ``ctypes``.

Each ``csrc/<name>.cu`` compiles on first use (or ahead of it, through
:func:`build`) for Hopper only::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
        -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so \\
        ops/csrc/<name>.cu

into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``).  The library's file name carries a hash of its source,
so an edited kernel is rebuilt and a stale one is never loaded; the
compiler's ``-Xptxas -v`` report (registers, shared memory, spills) is
kept beside it as ``<library>.log``.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$PATH`` first, then the toolkit's usual home."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels build on a machine with "
        "the CUDA toolkit (tensors on the CPU take the plain PyTorch "
        "versions and need no build)"
    )


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names) -> dict[str, float]:
    """Compile every named kernel source that has no current library,
    all ``nvcc`` processes started together; returns the seconds each
    took (0.0 where the library was already built).  Raises with the
    compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = None
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        exe = exe or nvcc()
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, out, tmp, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, out, tmp, t0) in running.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        Path(str(out) + ".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
