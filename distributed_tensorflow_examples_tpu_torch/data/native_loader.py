"""Native (C++) out-of-core input pipeline, the tf.data C++ runtime slot:
the port of ``distributed_tensorflow_examples_tpu/data/native_loader.py``.

The reference's input layer is tf.data, whose hot path (file IO, shuffling,
batch assembly) is C++ (SURVEY.md section 2c T7).  ``FileStreamPipeline``
(``data/filestream.py``) covers the streaming role with threads; THIS
module runs the hot path in ``native/dataloader.cc`` (the port's own copy,
linked into the port's one native library, ``native/__init__.py``): a
worker-pool and bounded-ring loader behind the ``dtx_dl_*`` C ABI, so
batch assembly costs no GIL time.

Shard format: ``DTXRAW1`` raw-record files (fixed-size records, header-
described fields), written by :func:`write_raw_shards` byte for byte as
the JAX writer, read by the C++ core.  Decode/augment stays in Python
(``filestream.image_decode_fn`` downstream); the u8 image bytes become
f32 in numpy on the assembled batch.

With ``n_workers`` > 1 the loader threads take chunks from a shared cursor
and push batches as each finishes, so the order across chunks races (as in
JAX); ``n_workers=1`` or a single shard gives one order.

Usage::

    write_raw_shards(dir, {"image": x_u8, "label": y_i32}, shard_records=4096)
    pipe = NativeFileStream(list_raw_shards(dir), batch_size=256, seed=0)
    for batch in pipe:   # {"image": [B,32,32,3] u8, "label": [B] i32}
        ...
"""

from __future__ import annotations

import ctypes
import glob
import os
from typing import Iterator

import numpy as np

_DTYPE_CODE = {np.dtype(np.uint8): 0, np.dtype(np.int32): 1, np.dtype(np.float32): 2}
_CODE_DTYPE = {"u8": np.uint8, "i32": np.int32, "f32": np.float32}
MAGIC = b"DTXRAW1\n"


def write_raw_shards(
    directory: str,
    arrays: dict[str, np.ndarray],
    *,
    shard_records: int = 4096,
    prefix: str = "shard",
) -> list[str]:
    """Split record-aligned arrays into DTXRAW1 shard files."""
    os.makedirs(directory, exist_ok=True)
    n = len(next(iter(arrays.values())))
    fields = []
    for name, a in arrays.items():
        if len(a) != n:
            raise ValueError(f"field {name!r} length {len(a)} != {n}")
        if a.dtype not in _DTYPE_CODE:
            raise ValueError(f"field {name!r}: unsupported dtype {a.dtype}")
        fields.append((name, np.ascontiguousarray(a)))

    def header() -> bytes:
        out = [MAGIC, np.uint32(len(fields)).tobytes()]
        for name, a in fields:
            nb = name.encode()
            out += [bytes([len(nb)]), nb, bytes([_DTYPE_CODE[a.dtype]])]
            dims = a.shape[1:]
            out += [bytes([len(dims)])] + [np.uint32(d).tobytes() for d in dims]
        return b"".join(out)

    paths = []
    for si, start in enumerate(range(0, n, shard_records)):
        stop = min(start + shard_records, n)
        path = os.path.join(directory, f"{prefix}-{si:05d}.dtxr")
        with open(path, "wb") as f:
            f.write(header())
            f.write(np.uint64(stop - start).tobytes())
            # Record-major interleave, matching the C++ reader.
            views = [a[start:stop].reshape(stop - start, -1) for _, a in fields]
            for r in range(stop - start):
                for v in views:
                    f.write(v[r].tobytes())
        paths.append(path)
    return paths


def list_raw_shards(directory: str, pattern: str = "shard-*.dtxr") -> list[str]:
    return sorted(glob.glob(os.path.join(directory, pattern)))


#: Caps on untrusted header values (mirrors native/dataloader.cc): this
#: Python parse is the user-facing validator — absurd claims must raise a
#: clear ValueError HERE, not surface as the C++ backstop's generic NULL.
MAX_RECORD_BYTES = 1 << 30
MAX_SHARD_BYTES = 1 << 40


def _read_header(f) -> tuple[list, int]:
    def take(n: int) -> bytes:
        b = f.read(n)
        if len(b) != n:
            raise ValueError(f"truncated DTXRAW1 header: {f.name}")
        return b

    if f.read(8) != MAGIC:
        raise ValueError(f"not a DTXRAW1 shard: {f.name}")
    n_fields = int(np.frombuffer(take(4), np.uint32)[0])
    fields = []
    record_bytes = 0
    for _ in range(n_fields):
        name_len = take(1)[0]
        name = take(name_len).decode()
        code = take(1)[0]
        if code > 2:
            raise ValueError(f"bad dtype code {code} in {f.name}")
        dtype = np.dtype([np.uint8, np.int32, np.float32][code])
        ndim = take(1)[0]
        shape = tuple(int(np.frombuffer(take(4), np.uint32)[0]) for _ in range(ndim))
        field_bytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize if shape else dtype.itemsize
        if field_bytes > MAX_RECORD_BYTES:
            raise ValueError(
                f"absurd field {name!r} ({field_bytes} B/record) in {f.name}"
            )
        record_bytes += field_bytes
        fields.append((name, dtype, shape))
    n = int(np.frombuffer(take(8), np.uint64)[0])
    if record_bytes > MAX_RECORD_BYTES or n * max(record_bytes, 1) > MAX_SHARD_BYTES:
        raise ValueError(
            f"absurd shard claim in {f.name}: {n} records x {record_bytes} B"
        )
    # The claimed payload must actually exist in the file (a lying header
    # must not size any downstream buffer).
    data_offset = f.tell()
    f.seek(0, 2)
    avail = f.tell() - data_offset
    f.seek(data_offset)
    if n * record_bytes > avail:
        raise ValueError(
            f"shard {f.name} claims {n} x {record_bytes} B but only "
            f"{avail} B of payload exist"
        )
    return fields, n


def peek_shard(path: str) -> tuple[list, int]:
    """(fields, n_records) from a shard header — no data read."""
    with open(path, "rb") as f:
        return _read_header(f)


def read_raw_shard(path: str) -> dict[str, np.ndarray]:
    """Host-side (numpy) read of ONE shard — for eval splits; the training
    path goes through the C++ loader."""
    with open(path, "rb") as f:
        fields, n = _read_header(f)
        raw = f.read()
    rec_bytes = sum(
        int(np.prod(s, dtype=np.int64)) * d.itemsize for _, d, s in fields
    )
    recs = np.frombuffer(raw, np.uint8, count=n * rec_bytes).reshape(n, rec_bytes)
    out, off = {}, 0
    for name, dtype, shape in fields:
        nb = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        out[name] = (
            np.ascontiguousarray(recs[:, off : off + nb])
            .view(dtype)
            .reshape((n, *shape))
        )
        off += nb
    return out


def _load():
    """The port's native library (built on first use), whose ``dtx_dl_*``
    signatures ``native._SIGNATURES`` declares."""
    from .. import native

    return native._load()


class NativeFileStream:
    """Iterate DTXRAW1 shards through the C++ worker-pool loader.

    Yields ``{field: np.ndarray}`` batches.  ``repeat=True`` streams epochs
    forever (chunk order reshuffled per epoch, records shuffled per chunk —
    both seeded).  Remainder batches are dropped (fixed shapes keep XLA from
    recompiling).
    """

    def __init__(
        self,
        paths: list[str],
        *,
        batch_size: int,
        n_workers: int = 2,
        capacity: int = 8,
        seed: int = 0,
        repeat: bool = True,
        timeout_s: float = 120.0,
    ):
        if not paths:
            raise ValueError("no shard paths")
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        # All user-facing construction validation happens HERE (one source of
        # truth; the C++ guards in dtx_dl_new are an internal backstop whose
        # NULL return then genuinely means "unreadable"): headers parse,
        # schemas agree, and at least one shard can emit a full batch.
        ref_fields, max_n = None, 0
        for p in paths:
            fields, n = peek_shard(p)  # ValueError on bad/truncated header
            if ref_fields is None:
                ref_fields = fields
            elif fields != ref_fields:
                raise ValueError(
                    f"shard schema mismatch: {paths[0]} has {ref_fields}, "
                    f"{p} has {fields}"
                )
            max_n = max(max_n, n)
        if batch_size > max_n:
            raise ValueError(
                f"batch_size {batch_size} > {max_n} records in the largest "
                "shard (drop_remainder): rewrite shards with more records "
                "or shrink the batch"
            )
        self._lib = _load()
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._h = self._lib.dtx_dl_new(
            arr, len(paths), batch_size, n_workers, capacity, seed,
            int(repeat), 1,
        )
        if not self._h:
            raise ValueError(f"cannot open DTXRAW1 shards: {paths[0]}")
        self.batch_size = batch_size
        self.timeout_s = timeout_s
        buf = ctypes.create_string_buffer(4096)
        if self._lib.dtx_dl_schema(self._h, buf, 4096) < 0:
            raise RuntimeError("schema too large")
        self.schema = []
        for part in buf.value.decode().split(";"):
            name, dt, dims = part.split(":")
            shape = () if dims == "-" else tuple(int(d) for d in dims.split("x"))
            self.schema.append((name, np.dtype(_CODE_DTYPE[dt]), shape))
        self._batch_bytes = self._lib.dtx_dl_batch_bytes(self._h)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        out = np.empty(self._batch_bytes, np.uint8)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        while True:
            n = self._lib.dtx_dl_next(self._h, ptr, int(self.timeout_s * 1000))
            if n == 0:
                return
            if n == -1:
                raise TimeoutError(
                    f"native loader: no batch within {self.timeout_s}s "
                    "(starved or shard files unreadable)"
                )
            if n == -2:
                err = ctypes.create_string_buffer(1024)
                self._lib.dtx_dl_error(self._h, err, 1024)
                raise RuntimeError(f"native loader: {err.value.decode()}")
            batch, off = {}, 0
            for name, dtype, shape in self.schema:
                nbytes = n * int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
                batch[name] = (
                    out[off : off + nbytes].view(dtype).reshape((n, *shape)).copy()
                )
                off += nbytes
            yield batch

    @property
    def batches_produced(self) -> int:
        return self._lib.dtx_dl_produced(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dtx_dl_free(self._h)
            self._h = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:
            pass
