"""PTB word-level LSTM language model (W5): the port of
``distributed_tensorflow_examples_tpu/models/lstm.py``.

An embedding, a stack of LSTM cells (``layers.lstm_cell``: the legacy
``BasicLSTMCell``, gate order i, g, f, o, forget bias 1.0) and a softmax
layer.  The JAX ``lax.scan`` over time is a Python loop over the window's
T steps, each running every layer in turn, as ``MultiRNNCell`` does.  The
truncated-BPTT carry (c, h per layer, float32, shaped for the batch) is
the train state's ``model_state``: the last state of one window starts
the next, detached (the twin of ``stop_gradient``), so backprop stops at
the window's edge.  Dropout on the embedding (``keep_prob < 1``) draws
its mask from the step's key with ``threefry.bernoulli``; under data
parallelism each rank takes its rows of the global batch's draw.  The products
are ``torch.matmul`` (the JAX package has no LSTM kernel), so a step on
the card is some thousand small launches.

:data:`SHARDING_RULES` (JAX :120-125) shard the embedding's rows and the
softmax's vocab columns over ``model``: the lookup gathers over the
row blocks (``layers.embedding_lookup``), ``h`` enters the softmax
through ``collectives.copy_to_model``, each model rank computes its
[B·T, V/M] block of the logits, and the cross-entropy runs vocab-parallel
(``layers.vocab_parallel_cross_entropy``).  The carry's rows follow the
batch over ``data`` (the CLI builds each rank's rows).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..parallel import collectives, sharding
from ..parallel.partitioner import PartitionSpec as P
from ..utils import device as device_lib
from ..utils import threefry
from . import layers


@dataclasses.dataclass(frozen=True)
class Config:
    """The JAX ``Config``: the same fields and defaults."""

    vocab_size: int = 10000
    dim: int = 200  # embedding and hidden width
    num_layers: int = 2
    keep_prob: float = 1.0  # inverted dropout on the embedding
    compute_dtype: str = "bfloat16"

    @property
    def dtype(self) -> torch.dtype:
        return layers.compute_dtype(self.compute_dtype)


def zero_carry(cfg: Config, batch_size: int) -> dict:
    """The TBPTT carry of ``batch_size`` rows, all zero (float32 numpy)."""
    return {
        f"lstm_{i}": {
            "c": np.zeros((batch_size, cfg.dim), np.float32),
            "h": np.zeros((batch_size, cfg.dim), np.float32),
        }
        for i in range(cfg.num_layers)
    }


def init_numpy(cfg: Config, seed: int, *, batch_size: int, device=None):
    """The JAX ``init(cfg, jax.random.key(seed), batch_size=...)`` as
    ``(params, carry)`` trees of float32 numpy arrays, from
    ``split(key(seed), layers + 2)``: the embedding U[-1/dim, 1/dim], one
    glorot-uniform cell kernel per layer, the glorot-uniform softmax
    (all bit for bit), zero biases and a zero carry."""
    dev = device_lib.for_drawing(device)
    rngs = threefry.split(threefry.key(seed), cfg.num_layers + 2)
    params: dict = {"emb": layers.embedding_init(rngs[0], cfg.vocab_size, cfg.dim, device=dev)}
    for i in range(cfg.num_layers):
        params[f"lstm_{i}"] = layers.lstm_cell_init(rngs[1 + i], cfg.dim, cfg.dim, device=dev)
    params["softmax"] = layers.dense_init(rngs[-1], cfg.dim, cfg.vocab_size, device=dev)
    return layers.as_numpy(params), zero_carry(cfg, batch_size)


def reset_carry(model_state):
    """The carry zeroed (an epoch boundary, in the PTB convention)."""
    if isinstance(model_state, dict):
        return {k: reset_carry(v) for k, v in model_state.items()}
    return torch.zeros_like(model_state)


def apply(cfg: Config, params, carry, x, *, rng=None):
    """x: [B, T] int ids -> (logits [B, T, V] in the compute dtype, or this
    model rank's [B, T, V/M] block of them, new_carry detached in
    float32)."""
    emb = layers.embedding_lookup(params["emb"], x, dtype=cfg.dtype,
                                  vocab_size=cfg.vocab_size)  # [B,T,D]
    if cfg.keep_prob < 1.0 and rng is not None:
        # This rank's rows of the draw shaped by the global batch, as JAX
        # draws one mask for the batch sharded over 'data'.
        shape = (sharding.global_batch(emb.shape[0]), *emb.shape[1:])
        mask = sharding.local_rows(threefry.bernoulli(rng, cfg.keep_prob, shape, emb.device))
        emb = torch.where(mask, emb / cfg.keep_prob, 0).to(emb.dtype)
    carries = [(carry[f"lstm_{i}"]["c"], carry[f"lstm_{i}"]["h"])
               for i in range(cfg.num_layers)]
    hs = []
    for t in range(x.shape[1]):
        h = emb[:, t]
        for i in range(cfg.num_layers):
            carries[i], h = layers.lstm_cell(params[f"lstm_{i}"], carries[i], h,
                                             dtype=cfg.dtype)
        hs.append(h)
    hs = torch.stack(hs, dim=1)
    if params["softmax"]["kernel"].shape[1] != cfg.vocab_size:  # vocab-parallel
        hs = collectives.copy_to_model(hs)
    logits = layers.dense(params["softmax"], hs, dtype=cfg.dtype)
    new_carry = {
        f"lstm_{i}": {"c": c.detach().to(torch.float32), "h": h.detach().to(torch.float32)}
        for i, (c, h) in enumerate(carries)
    }
    return logits, new_carry


def loss_fn(cfg: Config):
    """``f(params, carry, batch, rng) -> (loss, (new_carry, metrics))``
    over an {"x", "y"} window; metrics ``loss`` and ``perplexity``."""

    def f(params, model_state, batch, rng):
        logits, new_carry = apply(cfg, params, model_state, batch["x"], rng=rng)
        xent = (layers.softmax_cross_entropy if logits.shape[-1] == cfg.vocab_size
                else layers.vocab_parallel_cross_entropy)
        loss = xent(logits.reshape(-1, logits.shape[-1]), batch["y"].reshape(-1))
        return loss, (new_carry, {"loss": loss.detach(), "perplexity": torch.exp(loss.detach())})

    return f


#: The JAX rule table (:120-125): the carry's rows over ``data`` with the
#: batch; the [V, D] embedding's rows and the [D, V] softmax's columns,
#: and its bias, over ``model`` (clamped to replicated without a model
#: axis).
SHARDING_RULES: tuple = (
    (r"lstm_\d+/(c|h)$", P("data", None)),
    (r"emb/table", P("model", None)),
    (r"softmax/kernel", P(None, "model")),
    (r"softmax/bias", P("model")),
)
