"""Datasets: a copy of ``distributed_tensorflow_examples_tpu/data/datasets.py``.

Pure numpy, bit for bit the JAX package's (the same arrays, ids and
batches from the same seed, the draws in the same order), so both packages
train on identical streams.  Each loader reads the standard file under
``data_dir`` when it is there, else makes a deterministic synthetic set
of the same shapes (the returned ``source`` says which):

- MNIST: ``mnist.npz`` (keras layout: x_train/y_train/x_test/y_test);
- CIFAR-10: ``cifar10.npz`` (the same layout) or the python pickle
  batches under ``cifar-10-batches-py/``;
- PTB: ``ptb.train.txt`` / ``ptb.valid.txt`` (word level, ``<eos>`` per
  line);
- word2vec corpus: ``text8`` or ``corpus.txt`` (whitespace tokens);
- ImageNet: synthetic only, at ResNet-50's shapes.

The synthetic images are class-conditional Gaussian blobs; the synthetic
token stream is Zipf-distributed with bigram structure, so skip-gram
co-occurrence and next-token loss both have a learnable signal.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class ArrayDataset:
    train: dict[str, np.ndarray]
    test: dict[str, np.ndarray]
    source: str  # "file:<path>" or "synthetic"
    num_classes: int = 0
    vocab: dict | None = None


def _synth_image_splits(rng: np.random.Generator, n_train, n_test, h, w, c, num_classes):
    """Class-conditional Gaussian blobs; train and test share the class
    prototypes, so test accuracy is a generalisation signal."""
    protos = rng.normal(0.0, 1.0, size=(num_classes, h, w, c)).astype(np.float32)

    def draw(n):
        y = rng.integers(0, num_classes, size=n).astype(np.int32)
        x = 0.5 * protos[y] + rng.normal(0.0, 1.0, size=(n, h, w, c)).astype(np.float32)
        return x, y

    return draw(n_train), draw(n_test)


def mnist(data_dir: str | None = None, *, seed: int = 0) -> ArrayDataset:
    """MNIST: images [n, 28, 28, 1] float32 in [0, 1], labels int32;
    synthetic 8192/1024 splits without ``mnist.npz``."""
    path = os.path.join(data_dir or "", "mnist.npz")
    if data_dir and os.path.exists(path):
        with np.load(path) as d:
            xt = (d["x_train"].astype(np.float32) / 255.0).reshape(-1, 28, 28, 1)
            xe = (d["x_test"].astype(np.float32) / 255.0).reshape(-1, 28, 28, 1)
            return ArrayDataset(
                {"image": xt, "label": d["y_train"].astype(np.int32)},
                {"image": xe, "label": d["y_test"].astype(np.int32)},
                f"file:{path}",
                num_classes=10,
            )
    rng = np.random.default_rng(seed)
    (xt, yt), (xe, ye) = _synth_image_splits(rng, 8192, 1024, 28, 28, 1, 10)
    return ArrayDataset(
        {"image": xt, "label": yt}, {"image": xe, "label": ye}, "synthetic", 10
    )


def cifar10(data_dir: str | None = None, *, seed: int = 0) -> ArrayDataset:
    """CIFAR-10: images [n, 32, 32, 3] float32 NHWC in [0, 1], labels
    int32; synthetic 8192/1024 splits without a file."""
    if data_dir:
        npz = os.path.join(data_dir, "cifar10.npz")
        if os.path.exists(npz):
            with np.load(npz) as d:
                return ArrayDataset(
                    {
                        "image": d["x_train"].astype(np.float32) / 255.0,
                        "label": d["y_train"].reshape(-1).astype(np.int32),
                    },
                    {
                        "image": d["x_test"].astype(np.float32) / 255.0,
                        "label": d["y_test"].reshape(-1).astype(np.int32),
                    },
                    f"file:{npz}",
                    10,
                )
        batches = os.path.join(data_dir, "cifar-10-batches-py")
        if os.path.isdir(batches):
            xs, ys = [], []
            for i in range(1, 6):
                with open(os.path.join(batches, f"data_batch_{i}"), "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                xs.append(d[b"data"])
                ys.append(d[b"labels"])
            x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            with open(os.path.join(batches, "test_batch"), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xe = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            return ArrayDataset(
                {
                    "image": x.astype(np.float32) / 255.0,
                    "label": np.concatenate(ys).astype(np.int32),
                },
                {
                    "image": xe.astype(np.float32) / 255.0,
                    "label": np.asarray(d[b"labels"], np.int32),
                },
                f"file:{batches}",
                10,
            )
    rng = np.random.default_rng(seed)
    (xt, yt), (xe, ye) = _synth_image_splits(rng, 8192, 1024, 32, 32, 3, 10)
    return ArrayDataset(
        {"image": xt, "label": yt}, {"image": xe, "label": ye}, "synthetic", 10
    )


def imagenet_synthetic(
    *,
    image_size: int = 224,
    n_train: int = 2048,
    n_test: int = 256,
    num_classes: int = 1000,
    seed: int = 0,
) -> ArrayDataset:
    """Synthetic ImageNet-shaped splits (the W3 ResNet-50 workload):
    images [n, size, size, 3] float32 NHWC, labels int32."""
    rng = np.random.default_rng(seed)
    (xt, yt), (xe, ye) = _synth_image_splits(
        rng, n_train, n_test, image_size, image_size, 3, num_classes
    )
    return ArrayDataset(
        {"image": xt, "label": yt}, {"image": xe, "label": ye}, "synthetic", num_classes
    )


def _tokenize_corpus(words: list[str], vocab_size: int):
    from collections import Counter

    counts = Counter(words)
    keep = [w for w, _ in counts.most_common(vocab_size - 1)]
    vocab = {w: i + 1 for i, w in enumerate(keep)}  # 0 = <unk>
    ids = np.asarray([vocab.get(w, 0) for w in words], dtype=np.int32)
    return ids, {"<unk>": 0, **vocab}


def _synthetic_token_stream(n: int, vocab_size: int, seed: int) -> np.ndarray:
    """Zipf-distributed token stream with bigram structure (so next-token
    prediction has learnable signal)."""
    rng = np.random.default_rng(seed)
    # Markov chain: each token prefers a fixed successor half the time.
    succ = rng.permutation(vocab_size)
    zipf = rng.zipf(1.3, size=n).astype(np.int64) % vocab_size
    out = np.empty(n, dtype=np.int32)
    out[0] = zipf[0]
    follow = rng.random(n) < 0.5
    for i in range(1, n):
        out[i] = succ[out[i - 1]] if follow[i] else zipf[i]
    return out


def text_corpus(
    data_dir: str | None = None,
    *,
    filename_candidates=("text8", "corpus.txt"),
    vocab_size: int = 10000,
    synth_tokens: int = 200_000,
    seed: int = 0,
):
    """``(ids, vocab, source)``: a whitespace-tokenised corpus file under
    ``data_dir`` if one is there, else the synthetic stream."""
    if data_dir:
        for name in filename_candidates:
            path = os.path.join(data_dir, name)
            if os.path.exists(path):
                with open(path, "r", encoding="utf-8", errors="replace") as f:
                    words = f.read().split()
                ids, vocab = _tokenize_corpus(words, vocab_size)
                return ids, vocab, f"file:{path}"
    ids = _synthetic_token_stream(synth_tokens, vocab_size, seed)
    vocab = {f"tok{i}": i for i in range(vocab_size)}
    return ids, vocab, "synthetic"


def ptb(data_dir: str | None = None, *, vocab_size: int = 10000, seed: int = 0):
    """PTB word-level LM streams (W5): ``(train_ids, valid_ids, vocab,
    source)``; the vocabulary comes from the train file, and without it the
    streams are synthetic (120,000 train and 12,000 valid tokens)."""
    if data_dir:
        tr = os.path.join(data_dir, "ptb.train.txt")
        va = os.path.join(data_dir, "ptb.valid.txt")
        if os.path.exists(tr):
            with open(tr) as f:
                train_words = f.read().replace("\n", " <eos> ").split()
            valid_words = []
            if os.path.exists(va):
                with open(va) as f:
                    valid_words = f.read().replace("\n", " <eos> ").split()
            ids, vocab = _tokenize_corpus(train_words, vocab_size)
            vids = np.asarray([vocab.get(w, 0) for w in valid_words], np.int32)
            return ids, vids, vocab, f"file:{tr}"
    ids = _synthetic_token_stream(120_000, vocab_size, seed)
    vids = _synthetic_token_stream(12_000, vocab_size, seed + 1)
    return ids, vids, {f"tok{i}": i for i in range(vocab_size)}, "synthetic"


def lm_batches(
    ids: np.ndarray, *, batch_size: int, seq_len: int
) -> Iterator[dict[str, np.ndarray]]:
    """Truncated-BPTT batching: contiguous streams per batch row, yielding
    {"x": [B,T], "y": [B,T]} int32 forever, in corpus order."""
    n = len(ids)
    rows = batch_size
    per_row = n // rows
    if per_row < seq_len + 1:
        raise ValueError(
            f"token stream too short: {n} ids over {rows} rows gives "
            f"{per_row} tokens/row, need seq_len+1={seq_len + 1}"
        )
    data = ids[: rows * per_row].reshape(rows, per_row)
    pos = 0
    while True:
        if pos + seq_len + 1 > per_row:
            pos = 0
        x = data[:, pos : pos + seq_len]
        y = data[:, pos + 1 : pos + seq_len + 1]
        pos += seq_len
        yield {"x": x.astype(np.int32), "y": y.astype(np.int32)}


def skipgram_batches(
    ids: np.ndarray,
    *,
    batch_size: int,
    window: int = 5,
    seed: int = 0,
) -> Iterator[dict[str, np.ndarray]]:
    """Skip-gram (center, context) pairs for word2vec (W4), forever:
    ``{"center": [B], "context": [B]}`` int32, each context within
    ``window`` tokens of its center on either side."""
    rng = np.random.default_rng(seed)
    n = len(ids)
    while True:
        centers = rng.integers(window, n - window, size=batch_size)
        offsets = rng.integers(1, window + 1, size=batch_size)
        signs = rng.choice([-1, 1], size=batch_size)
        contexts = centers + offsets * signs
        yield {
            "center": ids[centers].astype(np.int32),
            "context": ids[contexts].astype(np.int32),
        }
