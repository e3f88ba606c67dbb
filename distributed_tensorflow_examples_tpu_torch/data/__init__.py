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

from .pipeline import InMemoryPipeline, prefetch_to_device  # noqa: F401
from .filestream import FileStreamPipeline  # noqa: F401
from . import data_service, datasets, filestream, native_loader, pipeline, streams  # noqa: F401
