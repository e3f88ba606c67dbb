"""The port's shard writers and readers (``data/filestream.py``,
``data/native_loader.py`` over ``native/dataloader.cc``) against the JAX
package's, on the CPU, from the same numpy inputs.

- The writers give byte-identical files: ``.npz`` (plain and compressed;
  numpy's zip members carry the wall clock's time, which the test pins for
  both writes) and ``.dtxr``.
- ``FileStreamPipeline`` yields the JAX pipeline's batches bit for bit
  over several ``process_index``/``process_count`` splits, two epochs, a
  remainder carried across chunks, fewer files than ranks, with and
  without shuffle and with the image decoder in its pool.
- ``image_decode_fn`` is bitwise JAX's (augment on and off, u8 and f32
  images), and so are ``stream_token_ids`` and both forms of
  ``streamed_skipgram_batches``.
- ``NativeFileStream`` at ``n_workers=1`` yields JAX's batches bit for bit
  over two epochs; at 2 the loader threads race for chunks (as in JAX), so
  one epoch's batches are compared as multisets.
- Bad, truncated and hostile headers, a too-large batch and the other
  refusals raise what JAX raises: the same type and message.

Every comparison is exact (no tolerance): both packages run the same numpy
code on the same bytes.
"""

from __future__ import annotations

import struct
import types
import zipfile

import numpy as np
import pytest

from distributed_tensorflow_examples_tpu.data import filestream as jax_fs
from distributed_tensorflow_examples_tpu.data import native_loader as jax_nl
from distributed_tensorflow_examples_tpu_torch.data import filestream as fs
from distributed_tensorflow_examples_tpu_torch.data import native_loader as nl


def _arrays(n=50, seed=0, image=(4, 4, 3)):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.integers(0, 256, size=(n, *image)).astype(np.uint8),
        "label": rng.integers(0, 10, size=n).astype(np.int32),
        "w": rng.normal(size=(n, 2)).astype(np.float32),
    }


def _equal_batches(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k


def _take(it, n):
    return [next(it) for _ in range(n)]


# ----------------------------------------------------------------------------
# Writers
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("compress", [False, True], ids=["stored", "deflated"])
def test_npz_writer_files_are_byte_identical(tmp_path, monkeypatch, compress):
    clock = types.SimpleNamespace(time=lambda: 1.7e9, localtime=zipfile.time.localtime)
    monkeypatch.setattr(zipfile, "time", clock)
    x = _arrays(37)
    ours = fs.write_array_shards(str(tmp_path / "p"), x, rows_per_shard=10, compress=compress)
    theirs = jax_fs.write_array_shards(str(tmp_path / "j"), x, rows_per_shard=10,
                                       compress=compress)
    assert [p.rsplit("/", 1)[1] for p in ours] == [p.rsplit("/", 1)[1] for p in theirs]
    assert len(ours) == 4
    for a, b in zip(ours, theirs):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert fs.list_shards(str(tmp_path / "p")) == ours
    _equal_batches([fs.load_chunk(p) for p in ours], [jax_fs.load_chunk(p) for p in theirs])


@pytest.mark.parametrize("shard_records", [16, 50, 64])
def test_dtxr_writer_files_are_byte_identical(tmp_path, shard_records):
    x = _arrays(50)
    ours = nl.write_raw_shards(str(tmp_path / "p"), x, shard_records=shard_records)
    theirs = jax_nl.write_raw_shards(str(tmp_path / "j"), x, shard_records=shard_records)
    assert len(ours) == len(theirs) == -(-50 // shard_records)
    for a, b in zip(ours, theirs):
        assert open(a, "rb").read() == open(b, "rb").read()
        assert nl.peek_shard(a) == jax_nl.peek_shard(b)
    assert nl.list_raw_shards(str(tmp_path / "p")) == ours
    _equal_batches([nl.read_raw_shard(p) for p in ours], [jax_nl.read_raw_shard(p) for p in theirs])


# ----------------------------------------------------------------------------
# FileStreamPipeline
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffled", "ordered"])
@pytest.mark.parametrize("pidx,pcount", [(0, 1), (0, 2), (1, 2), (2, 3), (3, 8)])
def test_file_stream_pipeline_matches_jax_batch_for_batch(tmp_path, pidx, pcount, shuffle):
    """Two epochs of 7 shards of 13 rows at a local batch of 4: the
    remainder rows carry across chunks; at 8 ranks there are fewer files
    than ranks, so every rank reads every file and strides rows."""
    x = _arrays(91)
    files = fs.write_array_shards(str(tmp_path), x, rows_per_shard=13)
    kw = dict(batch_size=4 * pcount, shuffle=shuffle, seed=5, process_index=pidx,
              process_count=pcount, decode_fn=fs.image_decode_fn(augment=True, seed=5))
    jkw = dict(kw, decode_fn=jax_fs.image_decode_fn(augment=True, seed=5))
    ours = fs.FileStreamPipeline(files, **kw)
    theirs = jax_fs.FileStreamPipeline(files, **jkw)
    per_epoch = sum(1 for _ in fs.FileStreamPipeline(files, **kw, repeat=False))
    assert per_epoch > 0
    _equal_batches(_take(iter(ours), 2 * per_epoch + 1), _take(iter(theirs), 2 * per_epoch + 1))
    assert ours.stats["batches"] >= 2 * per_epoch


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_file_stream_single_epoch_tail(tmp_path, drop_remainder):
    files = fs.write_array_shards(str(tmp_path), _arrays(30), rows_per_shard=7)
    kw = dict(batch_size=4, seed=1, repeat=False, drop_remainder=drop_remainder,
              process_index=0, process_count=1)
    ours = list(fs.FileStreamPipeline(str(tmp_path), **kw))
    _equal_batches(ours, list(jax_fs.FileStreamPipeline(str(tmp_path), **kw)))
    assert sum(len(b["label"]) for b in ours) == (28 if drop_remainder else 30)


def test_file_stream_defaults_to_the_data_axis(tmp_path):
    """Outside any group the rank is 0 of 1, as JAX's one process."""
    files = fs.write_array_shards(str(tmp_path), _arrays(24), rows_per_shard=8)
    pipe = fs.FileStreamPipeline(files, batch_size=4)
    assert (pipe.pidx, pipe.pcount, pipe.local_batch) == (0, 1, 4)
    _equal_batches(_take(iter(pipe), 7),
                   _take(iter(jax_fs.FileStreamPipeline(files, batch_size=4, process_index=0,
                                                        process_count=1)), 7))


# ----------------------------------------------------------------------------
# Decoders and text streams
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_image_decode_fn_is_bitwise_jax(augment, dtype):
    rng = np.random.default_rng(3)
    for i in range(4):
        img = rng.integers(0, 256, size=(16, 6, 5, 3))
        batch = {"image": img.astype(dtype), "label": rng.integers(0, 10, 16).astype(np.int64)}
        ours = fs.image_decode_fn(augment=augment, seed=i)(dict(batch))
        theirs = jax_fs.image_decode_fn(augment=augment, seed=i)(dict(batch))
        _equal_batches([ours], [theirs])
        assert ours["label"].dtype == np.int32


def _corpus(tmp_path):
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(40)]
    paths = []
    for f in range(2):
        text = "\n".join(" ".join(rng.choice(words, size=rng.integers(3, 30)))
                         for _ in range(60))
        p = tmp_path / f"part{f}.txt"
        p.write_text(text)
        paths.append(str(p))
    vocab = {w: i + 1 for i, w in enumerate(words[:30])}  # the rest map to <unk>
    return paths, vocab


@pytest.mark.parametrize("chunk_words", [7, 100, 1 << 20])
def test_stream_token_ids_match_jax(tmp_path, chunk_words):
    paths, vocab = _corpus(tmp_path)
    ours = list(fs.stream_token_ids(paths, vocab=vocab, chunk_words=chunk_words))
    theirs = list(jax_fs.stream_token_ids(paths, vocab=vocab, chunk_words=chunk_words))
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.int32 and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("form", ["factory", "iterator"])
def test_streamed_skipgram_batches_match_jax(tmp_path, form):
    paths, vocab = _corpus(tmp_path)

    def chunks(mod):
        make = lambda: mod.stream_token_ids(paths, vocab=vocab, chunk_words=300)  # noqa: E731
        return make if form == "factory" else make()

    ours = fs.streamed_skipgram_batches(chunks(fs), batch_size=32, window=3, seed=9)
    theirs = jax_fs.streamed_skipgram_batches(chunks(jax_fs), batch_size=32, window=3, seed=9)
    # Past one pass of the corpus: the repeat re-streams (or cycles) it.
    _equal_batches(_take(ours, 200), _take(theirs, 200))


# ----------------------------------------------------------------------------
# NativeFileStream
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 11])
def test_native_stream_one_worker_matches_jax_over_two_epochs(tmp_path, seed):
    x = _arrays(100)
    files = nl.write_raw_shards(str(tmp_path), x, shard_records=24)
    kw = dict(batch_size=8, n_workers=1, seed=seed, repeat=True)
    per_epoch = sum(24 // 8 if i < 4 else (100 - 96) // 8 for i in range(5))
    ours = nl.NativeFileStream(files, **kw)
    theirs = jax_nl.NativeFileStream(files, **kw)
    try:
        _equal_batches(_take(iter(ours), 2 * per_epoch), _take(iter(theirs), 2 * per_epoch))
        assert ours.batches_produced >= 2 * per_epoch
        assert ours.schema == theirs.schema
    finally:
        ours.close()
        theirs.close()


def _multiset(batches):
    return sorted(b"".join(b[k].tobytes() for k in sorted(b)) for b in batches)


@pytest.mark.parametrize("seed", [0, 4])
def test_native_stream_two_workers_match_jax_as_an_epoch_multiset(tmp_path, seed):
    files = nl.write_raw_shards(str(tmp_path), _arrays(120), shard_records=20)
    kw = dict(batch_size=6, n_workers=2, seed=seed, repeat=False)
    ours = list(nl.NativeFileStream(files, **kw))
    theirs = list(jax_nl.NativeFileStream(files, **kw))
    assert len(ours) == 6 * (20 // 6)
    assert _multiset(ours) == _multiset(theirs)
    # The same per-chunk shuffle as one worker: only the order races.
    assert _multiset(ours) == _multiset(nl.NativeFileStream(files, **dict(kw, n_workers=1)))


# ----------------------------------------------------------------------------
# Refusals: the same error type and message as JAX
# ----------------------------------------------------------------------------


def _hostile_dims(path):
    hdr = nl.MAGIC + struct.pack("<I", 1) + struct.pack("<B", 1) + b"x" + struct.pack("<B", 0)
    hdr += struct.pack("<B", 2) + struct.pack("<II", 1 << 31, 1 << 31)
    path.write_bytes(hdr + struct.pack("<Q", 1 << 50))


def _lying_payload(path):
    hdr = nl.MAGIC + struct.pack("<I", 1) + struct.pack("<B", 1) + b"x" + struct.pack("<B", 0)
    hdr += struct.pack("<B", 1) + struct.pack("<I", 4096)
    path.write_bytes(hdr + struct.pack("<Q", 1 << 20))


def _bad_dtype_code(path):
    hdr = nl.MAGIC + struct.pack("<I", 1) + struct.pack("<B", 1) + b"x" + struct.pack("<B", 7)
    path.write_bytes(hdr)


BAD_SHARDS = {
    "not-magic": lambda p: p.write_bytes(b"NOTDTXRAW" * 4),
    "truncated": lambda p: p.write_bytes(nl.MAGIC + np.uint32(1).tobytes()),
    "hostile-dims": _hostile_dims,
    "lying-payload": _lying_payload,
    "bad-dtype-code": _bad_dtype_code,
}


def _raises_alike(fn, jfn):
    with pytest.raises(Exception) as ours:
        fn()
    with pytest.raises(Exception) as theirs:
        jfn()
    assert type(ours.value) is type(theirs.value)
    assert str(ours.value) == str(theirs.value)
    return ours.value


@pytest.mark.parametrize("case", sorted(BAD_SHARDS))
def test_bad_shard_headers_raise_as_jax(tmp_path, case):
    p = tmp_path / "shard-00000.dtxr"
    BAD_SHARDS[case](p)
    err = _raises_alike(lambda: nl.NativeFileStream([str(p)], batch_size=4),
                        lambda: jax_nl.NativeFileStream([str(p)], batch_size=4))
    assert isinstance(err, ValueError)
    _raises_alike(lambda: nl.read_raw_shard(str(p)), lambda: jax_nl.read_raw_shard(str(p)))


def _schema_mismatch(tmp_path):
    a = nl.write_raw_shards(str(tmp_path / "a"), {"x": np.zeros((8, 2), np.uint8)})
    b = nl.write_raw_shards(str(tmp_path / "b"), {"x": np.zeros((8, 3), np.uint8)})
    return (lambda m: m.NativeFileStream(a + b, batch_size=4))


def _fixture_refusals(tmp_path):
    good = nl.write_raw_shards(str(tmp_path / "g"), _arrays(64), shard_records=64)
    npz = fs.write_array_shards(str(tmp_path / "n"), _arrays(16), rows_per_shard=8)
    (tmp_path / "odd.bin").write_bytes(b"")
    return {
        "batch-larger-than-every-shard": lambda m: m.NativeFileStream(good, batch_size=128),
        "batch-not-positive": lambda m: m.NativeFileStream(good, batch_size=0),
        "no-paths": lambda m: m.NativeFileStream([], batch_size=4),
        "schema-mismatch": _schema_mismatch(tmp_path),
        "raw-bad-dtype": lambda m: m.write_raw_shards(
            str(tmp_path / "x"), {"x": np.zeros(4, np.int64)}),
        "raw-length-mismatch": lambda m: m.write_raw_shards(
            str(tmp_path / "y"), {"x": np.zeros(4, np.uint8), "y": np.zeros(3, np.uint8)}),
    }, {
        "npz-length-mismatch": lambda m: m.write_array_shards(
            str(tmp_path / "z"), {"x": np.zeros(4), "y": np.zeros(3)}, rows_per_shard=2),
        "npz-no-shards": lambda m: m.FileStreamPipeline(str(tmp_path / "empty"), batch_size=2,
                                                        process_index=0, process_count=1),
        "npz-batch-not-divisible": lambda m: m.FileStreamPipeline(
            npz, batch_size=5, process_index=0, process_count=2),
        "npz-unsupported-chunk": lambda m: m.load_chunk(str(tmp_path / "odd.bin")),
    }


REFUSALS = ["batch-larger-than-every-shard", "batch-not-positive", "no-paths", "schema-mismatch",
            "raw-bad-dtype", "raw-length-mismatch", "npz-length-mismatch", "npz-no-shards",
            "npz-batch-not-divisible", "npz-unsupported-chunk"]


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_raise_as_jax(tmp_path, case):
    native_cases, stream_cases = _fixture_refusals(tmp_path)
    if case in native_cases:
        fn, ours, theirs = native_cases[case], nl, jax_nl
    else:
        fn, ours, theirs = stream_cases[case], fs, jax_fs
    err = _raises_alike(lambda: fn(ours), lambda: fn(theirs))
    assert isinstance(err, ValueError)
