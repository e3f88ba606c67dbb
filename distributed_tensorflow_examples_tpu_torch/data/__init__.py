"""Input data of the port: the ``tf.data`` replacement.

- ``datasets``       the workload datasets (real files under ``--data_dir``,
  deterministic synthetic fallback otherwise).
- ``pipeline``       ``InMemoryPipeline`` (the per-rank shard of an in-RAM
  dataset) and ``prefetch_to_device`` (the pinned, non-blocking infeed).
- ``filestream``     ``FileStreamPipeline``: datasets larger than host RAM
  stream from ``shard-*.npz`` files (reader thread, decode pool).
- ``native_loader``  ``NativeFileStream``: ``shard-*.dtxr`` records through
  the C++ worker-pool loader (``native/dataloader.cc``).
- ``data_service``   the disaggregated path: dedicated input-worker
  processes stream ready batches over the PS wire (``dsvc://host:port``).
- ``streams``        the ``--data_dir`` resolution over all four.
"""


import importlib

_SUBMODULES = ("data_service", "datasets", "filestream", "native_loader", "pipeline", "streams")
_NAMES = {"InMemoryPipeline": "pipeline", "prefetch_to_device": "pipeline",
          "FileStreamPipeline": "filestream"}


def __getattr__(name: str):
    """The submodules and their names load on first use: ``pipeline``
    imports torch, ``data_service`` and ``filestream`` do not, so the data
    service's clients and scrapers run without it."""
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _NAMES:
        return getattr(importlib.import_module(f".{_NAMES[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
