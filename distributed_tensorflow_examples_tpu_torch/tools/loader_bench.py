"""Input-pipeline throughput of the port: the native C++ loader against
the Python pipeline, the twin of the root ``tools/loader_bench.py``::

    python -m distributed_tensorflow_examples_tpu_torch.tools.loader_bench \\
        [--records 32768] [--batch 256] [--shard-records 2048] [--batches 200] [--workers 2]

Writes one synthetic image dataset (32x32x3 uint8 images, int32 labels)
in both shard formats, DTXRAW1 records (``data/native_loader.py::
write_raw_shards``) and ``.npz`` chunks (``data/filestream.py::
write_array_shards``), then drains each through its streaming path, the
port's ``NativeFileStream`` (``native/dataloader.cc``'s worker pool) and
``FileStreamPipeline``: 4 warm batches, then ``--batches`` timed ones.
Prints the root tool's three lines, then one JSON line with batches/s and
MB/s of each path, their ratio, and ``checks``: whether each path's last
batch had the written shapes, dtypes and label range.  Host only, as the
root tool is; it exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from ..data import filestream, native_loader
from . import _hostbench

HW = 32
CLASSES = 1000


def make_dataset(n: int, hw: int = HW) -> dict:
    rng = np.random.default_rng(0)
    return {
        "image": rng.integers(0, 256, size=(n, hw, hw, 3)).astype(np.uint8),
        "label": rng.integers(0, CLASSES, size=(n,)).astype(np.int32),
    }


def drain(it, n_batches: int, record_bytes: int, batch: int) -> tuple[float, float, dict]:
    """(batches/s, MB/s, last batch) over ``n_batches`` after 4 warm ones
    (they fill the rings and start the workers)."""
    for _ in range(4):
        next(it)
    t0 = time.perf_counter()
    for _ in range(n_batches):
        b = next(it)
    dt = time.perf_counter() - t0
    return n_batches / dt, n_batches * batch * record_bytes / 1e6 / dt, b


def batch_ok(b: dict, batch: int, hw: int = HW) -> bool:
    """The written layout came back: [batch, hw, hw, 3] uint8 images and
    [batch] integer labels in [0, CLASSES)."""
    img, lab = np.asarray(b["image"]), np.asarray(b["label"])
    return (img.shape == (batch, hw, hw, 3) and img.dtype == np.uint8
            and lab.shape == (batch,) and lab.dtype.kind == "i"
            and int(lab.min()) >= 0 and int(lab.max()) < CLASSES)


def run(args) -> dict:
    data = make_dataset(args.records)
    record_bytes = data["image"][0].nbytes + 4
    detail: dict = {"records": args.records, "batch": args.batch,
                    "shard_records": args.shard_records, "batches": args.batches,
                    "workers": args.workers, "record_bytes": record_bytes}
    tmp = tempfile.mkdtemp(prefix="dtx_loaderbench_")
    try:
        raw_dir, npz_dir = os.path.join(tmp, "raw"), os.path.join(tmp, "npz")
        raw_paths = native_loader.write_raw_shards(
            raw_dir, data, shard_records=args.shard_records)
        os.makedirs(npz_dir)
        npz_paths = filestream.write_array_shards(
            npz_dir, data, rows_per_shard=args.shard_records)
        native = native_loader.NativeFileStream(
            raw_paths, batch_size=args.batch, n_workers=args.workers, seed=0, repeat=True)
        try:
            bps, mbs, last = drain(iter(native), args.batches, record_bytes, args.batch)
        finally:
            native.close()
        detail["native"] = {"batches_per_s": bps, "mbs": mbs}
        checks = {"native_batch": batch_ok(last, args.batch)}
        py = filestream.FileStreamPipeline(
            npz_paths, batch_size=args.batch, seed=0, num_decode_workers=args.workers)
        bps2, mbs2, last = drain(iter(py), args.batches, record_bytes, args.batch)
        detail["python"] = {"batches_per_s": bps2, "mbs": mbs2}
        checks["python_batch"] = batch_ok(last, args.batch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    detail["native_over_python"] = bps / bps2
    detail["checks"] = checks
    return detail


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", type=int, default=32768)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--shard-records", type=int, default=2048)
    ap.add_argument("--batches", type=int, default=200)
    ap.add_argument("--workers", type=int, default=2)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    d = run(parse_args(argv))
    print(f"native C++ loader : {d['native']['batches_per_s']:8.1f} batches/s  "
          f"{d['native']['mbs']:8.1f} MB/s")
    print(f"python pipeline   : {d['python']['batches_per_s']:8.1f} batches/s  "
          f"{d['python']['mbs']:8.1f} MB/s")
    print(f"native/python     : {d['native_over_python']:8.2f}x")
    _hostbench.emit({"metric": "loader_batches_per_s",
                     "value": round(d["native"]["batches_per_s"], 1),
                     "unit": "batches/s", "detail": _hostbench.rounded(d, 4)})
    return 0 if all(d["checks"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
