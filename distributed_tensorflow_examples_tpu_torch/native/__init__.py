"""ctypes bindings for the port's native host services (SURVEY.md section 2b:
the C++ component slots D5/D12 — gradient accumulator, token queue,
gradient queue and param store, and the cross-process PS server that hosts
them on a socket), the twin of the JAX package's ``native`` bindings.

``accumulator.cc``, ``ps_server.cc`` and ``dataloader.cc`` beside this file
are the port's own copies of the JAX package's sources (standard library
only).  The server calls the accumulator's C ABI, and the data loader
(``data/native_loader.py``'s ``dtx_dl_*`` bindings) rides along, so all
three link into ONE shared library, which compiles on first use, never at
import time::

    g++ -O2 -std=c++17 -fPIC -shared -o build/native/libdtx_ps-<hash>.so \\
        native/accumulator.cc native/ps_server.cc native/dataloader.cc -lpthread

into ``build/native/`` at the root of the checkout (listed in
``.gitignore``), under a name that carries a hash of the three sources, so an
edited source is rebuilt and a stale library is never loaded.  The
compiler writes a temporary file that ``os.replace`` moves into place, so
processes that build at once never load half a library.  A failed build
raises with the compiler's output; nothing falls back to a Python queue.
The library is loaded through ``ctypes.CDLL`` with the default
``RTLD_LOCAL``, so a process that also loads the JAX package's library
(the cross-package tests) keeps two sets of the same C symbols apart: each
server calls its own accumulator.  ``CDLL`` releases the interpreter lock
for the length of every call, so a blocking ``take`` or ``pop`` holds up
no other thread.  The Python wrappers own the handles and take and give
numpy float32 arrays; ``parallel/ps_service.py`` wraps the server calls.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "accumulator.cc"
SERVER_SOURCE = Path(__file__).resolve().parent / "ps_server.cc"
LOADER_SOURCE = Path(__file__).resolve().parent / "dataloader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_build_lock = threading.Lock()
_lib = None

_c_float_p = ctypes.POINTER(ctypes.c_float)
_i64 = ctypes.c_int64
_p = ctypes.c_void_p
#: name -> (restype, argtypes) of every function the wrappers call.
_SIGNATURES = {
    "acc_new": (_p, [_i64]),
    "acc_free": (None, [_p]),
    "acc_apply": (ctypes.c_int, [_p, _i64, _c_float_p]),
    "acc_apply_tagged": (ctypes.c_int, [_p, _i64, _i64, _i64, _c_float_p]),
    "acc_take": (_i64, [_p, _i64, _c_float_p]),
    "acc_take_timed": (_i64, [_p, _i64, _i64, _c_float_p]),
    "acc_set_global_step": (None, [_p, _i64]),
    "acc_dropped": (_i64, [_p]),
    "acc_deduped": (_i64, [_p]),
    "acc_count": (_i64, [_p]),
    "acc_cancel": (None, [_p]),
    "tq_new": (_p, []),
    "tq_free": (None, [_p]),
    "tq_push": (None, [_p, _i64, _i64]),
    "tq_pop": (_i64, [_p]),
    "tq_pop_timed": (_i64, [_p, _i64]),
    "tq_size": (_i64, [_p]),
    "tq_cancel": (None, [_p]),
    "gq_new": (_p, [_i64, _i64]),
    "gq_free": (None, [_p]),
    "gq_push": (ctypes.c_int, [_p, _i64, _c_float_p]),
    "gq_push_tagged": (ctypes.c_int, [_p, _i64, _i64, _i64, _i64, _c_float_p]),
    "gq_pop": (_i64, [_p, _c_float_p]),
    "gq_pop_timed": (_i64, [_p, _i64, _c_float_p]),
    "gq_set_min_step": (None, [_p, _i64]),
    "gq_dropped": (_i64, [_p]),
    "gq_deduped": (_i64, [_p]),
    "gq_size": (_i64, [_p]),
    "gq_cancel": (None, [_p]),
    "acc_reset_worker": (None, [_p, _i64]),
    "gq_reset_worker": (None, [_p, _i64]),
    "pstore_new": (_p, [_i64]),
    "pstore_free": (None, [_p]),
    "pstore_set": (None, [_p, _i64, _c_float_p]),
    "pstore_get": (_i64, [_p, _c_float_p]),
    "pstore_step": (_i64, [_p]),
    "pstore_get_if_newer": (_i64, [_p, _i64, _c_float_p]),
    "pstore_num_elems": (_i64, [_p]),
    "pstore_get_range": (_i64, [_p, _i64, _i64, _c_float_p]),
    # The socket server (ps_server.cc); each takes or answers a port.
    "ps_server_start_replicated": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _i64,
        ctypes.c_char_p, ctypes.c_int, _i64]),
    "ps_server_stop": (None, []),
    "ps_server_stop_port": (ctypes.c_int, [ctypes.c_int]),
    "ps_server_incarnation": (_i64, []),
    "ps_server_incarnation_port": (_i64, [ctypes.c_int]),
    "ps_server_requests": (_i64, []),
    "ps_server_requests_port": (_i64, [ctypes.c_int]),
    "ps_server_live_conns_port": (ctypes.c_int, [ctypes.c_int]),
    "ps_server_set_draining": (ctypes.c_int, [ctypes.c_int, ctypes.c_int]),
    "ps_server_state_token_port": (_i64, [ctypes.c_int]),
    # The replicated pair (a shard's primary and backup).
    "ps_server_set_peer": (ctypes.c_int, [ctypes.c_int, ctypes.c_char_p, ctypes.c_int]),
    "ps_server_resync_port": (ctypes.c_int, [ctypes.c_int, _i64]),
    "ps_server_set_partitioned": (ctypes.c_int, [ctypes.c_int, ctypes.c_int]),
    "ps_server_diverged_port": (ctypes.c_int, [ctypes.c_int]),
    # The data loader (dataloader.cc; data/native_loader.py wraps it).
    "dtx_dl_new": (_p, [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int]),
    "dtx_dl_schema": (ctypes.c_int, [_p, ctypes.c_char_p, ctypes.c_int]),
    "dtx_dl_batch_bytes": (_i64, [_p]),
    "dtx_dl_next": (ctypes.c_int, [_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]),
    "dtx_dl_error": (ctypes.c_int, [_p, ctypes.c_char_p, ctypes.c_int]),
    "dtx_dl_produced": (_i64, [_p]),
    "dtx_dl_free": (None, [_p]),
}


def _sources() -> tuple[Path, ...]:
    return (SOURCE, SERVER_SOURCE, LOADER_SOURCE)


def library_path() -> Path:
    """Where the library of the current ``accumulator.cc``, ``ps_server.cc``
    and ``dataloader.cc`` lives."""
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdtx_ps-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``accumulator.cc``, ``ps_server.cc`` and ``dataloader.cc``
    into one library unless it exists; returns the library's path.  Raises with the
    compiler's output when g++ fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, _sources()), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native build failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _build_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
    return _lib


def _as_float_ptr(a: np.ndarray):
    return a.ctypes.data_as(_c_float_p)


def _flat_f32(grad: np.ndarray, num_elems: int) -> np.ndarray:
    g = np.ascontiguousarray(grad, dtype=np.float32).reshape(-1)
    if g.size != num_elems:
        raise ValueError(f"grad size {g.size} != {num_elems}")
    return g


#: Sentinel returned by deadline-bounded blocking ops (take/pop with a
#: timeout) when the deadline expires — distinct from ``None`` (cancelled),
#: so fault-recovery loops can re-issue without mistaking a timeout for
#: shutdown.
TIMED_OUT = object()


def _timeout_ms(timeout_s: float) -> int:
    """A requested bounded wait must stay bounded: the C side treats
    timeout_ms <= 0 as "block forever", so sub-millisecond (and zero)
    timeouts clamp to 1 ms instead of silently inverting the contract."""
    return max(1, int(timeout_s * 1000))


def _tag(worker: int, seq: int) -> int:
    """Wire packing of a (worker, seq) dedup tag (the JAX package's PS wire
    layout).  Worker is capped at 15 bits: the tag travels as a SIGNED i64,
    so bit 63 must stay clear (worker << 48 with worker >= 2**15 would
    overflow the wire format)."""
    if not 0 <= worker < (1 << 15):
        raise ValueError(f"worker tag {worker} out of range")
    if not 0 <= seq < (1 << 48):
        raise ValueError(f"seq {seq} out of range")
    return (worker << 48) | seq


class GradientAccumulator:
    """One dense accumulator (the ConditionalAccumulator analog) for a flat
    f32 buffer.  Thread-safe; staleness-dropping per the reference semantics
    (apply with local_step < global_step is rejected)."""

    def __init__(self, num_elems: int):
        self._lib = _load()
        self._h = self._lib.acc_new(int(num_elems))
        if not self._h:
            raise MemoryError(f"acc_new({num_elems}) failed")
        self.num_elems = int(num_elems)
        #: How many gradients the last successful ``take`` averaged.
        self.last_count = 0

    def apply(self, local_step: int, grad: np.ndarray) -> bool:
        g = _flat_f32(grad, self.num_elems)
        return bool(self._lib.acc_apply(self._h, int(local_step), _as_float_ptr(g)))

    def apply_tagged(self, local_step: int, worker: int, seq: int, grad: np.ndarray) -> bool:
        """Replay-safe apply: (worker, seq) dedup-tagged — a re-issue of a
        seq already processed is counted in ``deduped`` and NOT re-applied.
        Returns True when the gradient counts toward the next take (fresh
        first delivery); False for stale drops AND duplicates."""
        g = _flat_f32(grad, self.num_elems)
        _tag(worker, seq)  # range check (the wire's limits)
        return (
            self._lib.acc_apply_tagged(
                self._h, int(local_step), int(worker), int(seq), _as_float_ptr(g)
            )
            == 1
        )

    def take(self, num_required: int, timeout_s: float | None = None):
        """Blocking average of >= num_required fresh grads; None if
        cancelled; ``TIMED_OUT`` when ``timeout_s`` expires first."""
        out = np.empty((self.num_elems,), np.float32)
        if timeout_s is None:
            n = self._lib.acc_take(self._h, int(num_required), _as_float_ptr(out))
        else:
            n = self._lib.acc_take_timed(
                self._h, int(num_required), _timeout_ms(timeout_s), _as_float_ptr(out)
            )
            if n == -3:
                return TIMED_OUT
        if n < 0:
            return None
        self.last_count = int(n)
        return out

    def set_global_step(self, step: int) -> None:
        self._lib.acc_set_global_step(self._h, int(step))

    @property
    def dropped(self) -> int:
        return int(self._lib.acc_dropped(self._h))

    @property
    def deduped(self) -> int:
        return int(self._lib.acc_deduped(self._h))

    @property
    def pending(self) -> int:
        return int(self._lib.acc_count(self._h))

    def cancel(self) -> None:
        self._lib.acc_cancel(self._h)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.acc_free(h)


class GradientQueue:
    """FIFO of whole gradients for TRUE-async apply (the worker->PS
    Send/Recv role): each pushed gradient is popped and applied individually
    — no coalescing — with an optional staleness gate."""

    def __init__(self, num_elems: int, capacity: int = 16):
        self._lib = _load()
        self._h = self._lib.gq_new(int(num_elems), int(capacity))
        if not self._h:
            raise MemoryError(f"gq_new({num_elems}, {capacity}) failed")
        self.num_elems = int(num_elems)

    def push(self, local_step: int, grad: np.ndarray) -> bool | None:
        """Blocks while the queue is full (backpressure).  Tri-state result:
        True = enqueued, False = dropped as stale, None = CANCELLED — the
        termination signal."""
        g = _flat_f32(grad, self.num_elems)
        r = self._lib.gq_push(self._h, int(local_step), _as_float_ptr(g))
        return None if r < 0 else r == 1

    def push_tagged(
        self, local_step: int, worker: int, seq: int, grad: np.ndarray,
        timeout_s: float | None = None,
    ):
        """Replay-safe push ((worker, seq) dedup like the accumulator's).
        True enqueued OR duplicate-of-enqueued, False stale-dropped, None
        cancelled, ``TIMED_OUT`` when the bounded space wait expires."""
        g = _flat_f32(grad, self.num_elems)
        _tag(worker, seq)
        r = self._lib.gq_push_tagged(
            self._h, int(local_step), int(worker), int(seq),
            0 if timeout_s is None else _timeout_ms(timeout_s), _as_float_ptr(g),
        )
        if r == -3:
            return TIMED_OUT
        return None if r < 0 else r != 0

    def pop(self, timeout_s: float | None = None):
        """Blocking; returns (local_step, grad), None when cancelled+drained,
        or ``TIMED_OUT`` when ``timeout_s`` expires first."""
        out = np.empty((self.num_elems,), np.float32)
        if timeout_s is None:
            step = self._lib.gq_pop(self._h, _as_float_ptr(out))
        else:
            step = self._lib.gq_pop_timed(
                self._h, _timeout_ms(timeout_s), _as_float_ptr(out)
            )
            if step == -3:
                return TIMED_OUT
        return None if step < 0 else (int(step), out)

    def set_min_step(self, step: int) -> None:
        self._lib.gq_set_min_step(self._h, int(step))

    @property
    def dropped(self) -> int:
        return int(self._lib.gq_dropped(self._h))

    @property
    def deduped(self) -> int:
        return int(self._lib.gq_deduped(self._h))

    def __len__(self) -> int:
        return int(self._lib.gq_size(self._h))

    def cancel(self) -> None:
        self._lib.gq_cancel(self._h)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.gq_free(h)


class TokenQueue:
    """The sync-replicas token queue (chief pushes N per applied update,
    workers pop one to proceed)."""

    def __init__(self):
        self._lib = _load()
        self._h = self._lib.tq_new()
        if not self._h:
            raise MemoryError("tq_new failed")

    def push(self, step: int, n: int = 1) -> None:
        self._lib.tq_push(self._h, int(step), int(n))

    def pop(self, timeout_s: float | None = None):
        """Blocking; returns the token's global step, None if cancelled, or
        ``TIMED_OUT`` when ``timeout_s`` expires first."""
        if timeout_s is None:
            step = self._lib.tq_pop(self._h)
        else:
            step = self._lib.tq_pop_timed(self._h, _timeout_ms(timeout_s))
            if step == -3:
                return TIMED_OUT
        return None if step < 0 else int(step)

    def __len__(self) -> int:
        return int(self._lib.tq_size(self._h))

    def cancel(self) -> None:
        self._lib.tq_cancel(self._h)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.tq_free(h)
