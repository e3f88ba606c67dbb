"""Token corpora for the transformer LM: a copy of the text-corpus part of
``distributed_tensorflow_examples_tpu/data/datasets.py``.

Pure numpy, bit for bit the JAX package's (the same ids and batches from
the same seed), so both packages train on identical streams.  With no
corpus file under ``data_dir`` the stream is the deterministic synthetic
one: Zipf-distributed tokens with bigram structure, so next-token loss
has a learnable signal.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np


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
