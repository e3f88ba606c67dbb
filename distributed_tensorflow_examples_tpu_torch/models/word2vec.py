"""word2vec skip-gram (W4), training loss and similarity: the port of
``distributed_tensorflow_examples_tpu/models/word2vec.py``.

An embedding table and an output table, both [vocab, dim], with NCE (the
default) or sampled softmax over ``num_sampled`` log-uniform negatives
shared across the batch, TF's ``LogUniformCandidateSampler``
distribution with the subtract-log-q correction on the true and the
sampled logits.  The negatives are drawn from the train step's key with
``threefry.uniform`` and the JAX function's float32 inverse CDF, so from
the same key the port samples the JAX package's ids.  The row gathers are
tensor indexing, whose gradient scatter-adds into repeated ids, as
``jnp.take``'s transpose does.

:data:`SHARDING_RULES` (JAX :135-138) shard both tables' vocab dim, and
the bias, over the ``model`` axis.  A model rank then holds a block of
rows: the lookup gathers its own and sums over ``model``
(``layers.embedding_lookup``), and :func:`_logits` takes the true and
sampled logits from its rows of ``nce/weights`` and ``nce/bias`` (zero
for the other blocks' ids) and sums the partial logits over ``model``
(``collectives.reduce_from_model``), with ``emb`` entering through
``collectives.copy_to_model``, so the gradient of ``emb`` is the sum of
the blocks'.  Each logit has one owner, so a sum adds zeros only and the
sharded logits are the replicated ones.  The negatives come from the
step key, the same ids on every rank; ``log_q`` is per id and not
sharded.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import collectives
from ..parallel.partitioner import PartitionSpec as P
from ..utils import device as device_lib
from ..utils import threefry
from ..utils.threefry import fma32
from . import layers


@dataclasses.dataclass(frozen=True)
class Config:
    """The JAX ``Config``: the same fields and defaults."""

    vocab_size: int = 10000
    dim: int = 128
    num_sampled: int = 64
    loss: str = "nce"  # "nce" | "sampled_softmax"
    compute_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return layers.compute_dtype(self.compute_dtype)


def init_numpy(cfg: Config, seed: int, *, device=None):
    """The JAX ``init(cfg, jax.random.key(seed))`` as a tree of float32
    numpy arrays, from ``split(key(seed))``: the embedding U[-1/dim, 1/dim]
    (bit for bit), the nce weights ``truncated_normal(-2, 2) / sqrt(dim)``
    (within a few float32 ulps) and a zero nce bias."""
    dev = device_lib.for_drawing(device)
    r1, r2 = threefry.split(threefry.key(seed))
    scale = torch.tensor(np.float32(1.0) / np.sqrt(np.float32(cfg.dim)), device=dev)
    return layers.as_numpy({
        "emb": layers.embedding_init(r1, cfg.vocab_size, cfg.dim, device=dev),
        "nce": {
            "weights": scale * threefry.truncated_normal(
                r2, -2.0, 2.0, (cfg.vocab_size, cfg.dim), dev),
            "bias": np.zeros((cfg.vocab_size,), np.float32),
        },
    })


# XLA's float32 ``exp`` and ``log`` on its CPU backend (Cephes): the
# sampler's inverse CDF and the subtract-log-q correction evaluate these,
# so the ids and the correction are JAX's to the bit.  Each constant is a
# float32 value held as a Python float; polynomials highest power first.
def _f32s(*values):
    return tuple(float(np.float32(v)) for v in values)


_LOG2E, _LN2_HI, _LN2_LO, _SQRT_HALF = _f32s(
    1.44269504088896341, 0.693359375, -2.12194440e-4, 0.707106781186547524)
_EXP_POLY = _f32s(1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
                  1.6666665459e-1, 5.0000001201e-1)
_LOG_POLY = _f32s(7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
                  1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
                  3.3333331174e-1)


def _log_of(x: float, device) -> torch.Tensor:
    """``jnp.log`` of a Python float under ``jit``: XLA folds the constant
    with the C library's float32 ``log``, correctly rounded here as
    torch's ``log`` is (held to JAX's in the tests)."""
    return torch.log(torch.tensor(x, dtype=torch.float32, device=device))


def _exp32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` of float32 ``x`` as XLA's CPU backend computes it, for
    |x| < 88: ``2^n * exp(a)`` with ``n = floor(x * log2(e) + 1/2)``,
    ``a = x - n * ln 2`` and ``exp(a)`` the Cephes polynomial, every
    multiply-add fused.  It is not correctly rounded (an ulp off in about
    one draw in ten), so the inverse CDF needs this one, not torch's
    ``exp``, to land on JAX's integers; made of IEEE operations, it gives
    the same bits on the card."""
    n = torch.floor(fma32(x, _LOG2E, 0.5))
    a = fma32(-n, _LN2_HI, x)
    a = fma32(-n, _LN2_LO, a)
    z = torch.full_like(a, _EXP_POLY[0])
    for coef in _EXP_POLY[1:]:
        z = fma32(z, a, coef)
    z = fma32(z, a * a, a) + 1.0
    two_n = ((n.to(torch.int32) + 127) << 23).view(torch.float32)  # 2^n, exactly
    return z * two_n


def _log32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` of positive normal float32 ``x`` as XLA's CPU backend
    computes it: ``x = m * 2^e`` with ``m`` in [sqrt(1/2), sqrt(2)), then
    ``log(m)`` by the Cephes polynomial in ``t = m - 1`` (evaluated in
    three interleaved parts, multiply-adds fused) plus ``e * ln 2`` in two
    parts."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    low = m < _SQRT_HALF
    e = e - low.to(torch.float32)
    t = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    t2 = t * t
    t3 = t2 * t
    p = _LOG_POLY
    y, y1, y2 = fma32(t, p[0], p[1]), fma32(t, p[3], p[4]), fma32(t, p[6], p[7])
    y, y1, y2 = fma32(y, t, p[2]), fma32(y1, t, p[5]), fma32(y2, t, p[8])
    y = fma32(fma32(y, t3, y1), t3, y2)
    y = fma32(y, t3, _LN2_LO * e)
    return (t - 0.5 * t2) + y + _LN2_HI * e


def log_uniform_sample(rng, num_sampled: int, vocab_size: int, device="cpu") -> torch.Tensor:
    """``num_sampled`` int32 ids from P(k) = (log(k+2) - log(k+1)) /
    log(V+1) by the inverse CDF ``exp(u * log(V+1)) - 1`` in float32 (with
    XLA's ``exp``), truncated and clipped to [0, V)."""
    u = threefry.uniform(rng, (num_sampled,), device=device)
    ids = _exp32(u * _log_of(vocab_size + 1.0, device)) - 1.0
    return ids.to(torch.int32).clamp(0, vocab_size - 1)


@functools.lru_cache(maxsize=8)
def _log_expected_counts(vocab_size: int, num_sampled: int, device: str) -> torch.Tensor:
    """:func:`_log_expected_count` of every id in [0, V), computed once per
    configuration and device: a loss gathers its ids' rows (one launch a
    call instead of some hundred elementwise ones)."""
    ids = torch.arange(vocab_size, dtype=torch.int32, device=device)
    return _log_expected_count(ids, vocab_size, num_sampled)


def _log_expected_count(ids, vocab_size: int, num_sampled: int) -> torch.Tensor:
    """log(num_sampled * P(id)), the subtract-log-q correction, in XLA's
    float32 arithmetic: ``log(k+2) - log(k+1)`` cancels, so torch's
    ``log``, an ulp apart from XLA's, would move it by up to 1e-2 at ids
    near V."""
    k = ids.to(torch.float32)
    # XLA divides by a constant as a product with its float32 reciprocal.
    inv = 1.0 / _log_of(vocab_size + 1.0, ids.device)
    p = (_log32(k + 2.0) - _log32(k + 1.0)) * inv
    return _log32(num_sampled * p)


def _logits(cfg: Config, params, emb, true_ids, sampled_ids):
    """(true_logits [B], sampled_logits [B, S]) with subtract-log-q; from
    this rank's rows of a table sharded over ``model`` (module
    docstring)."""
    w, b = params["nce"]["weights"], params["nce"]["bias"]
    emb = emb.to(torch.promote_types(emb.dtype, w.dtype))
    true_ids, sampled_ids = true_ids.long(), sampled_ids.long()
    if w.shape[0] == cfg.vocab_size:  # a whole table: no collective
        true_logits = (emb * w[true_ids]).sum(dim=-1) + b[true_ids]  # [B]
        sampled_logits = emb @ w[sampled_ids].T + b[sampled_ids][None, :]  # [B, S]
    else:
        emb = collectives.copy_to_model(emb)
        w_true, b_true = layers.own_rows(w, true_ids), layers.own_rows(b, true_ids)
        w_samp, b_samp = layers.own_rows(w, sampled_ids), layers.own_rows(b, sampled_ids)
        part = torch.cat([((emb * w_true).sum(dim=-1) + b_true)[:, None],
                          emb @ w_samp.T + b_samp[None, :]], dim=-1)
        logits = collectives.reduce_from_model(part)  # [B, 1 + S], one all-reduce
        true_logits, sampled_logits = logits[:, 0], logits[:, 1:]
    log_q = _log_expected_counts(cfg.vocab_size, cfg.num_sampled, str(w.device))
    true_logits = true_logits - log_q[true_ids]
    sampled_logits = sampled_logits - log_q[sampled_ids][None, :]
    return true_logits, sampled_logits


def nce_loss(cfg: Config, params, emb, true_ids, rng):
    """NCE: logistic regression of the true pair against every sampled
    negative."""
    sampled = log_uniform_sample(rng, cfg.num_sampled, cfg.vocab_size, emb.device)
    t, s = _logits(cfg, params, emb, true_ids, sampled)
    return (F.softplus(-t) + F.softplus(s).sum(dim=-1)).mean()


def sampled_softmax_loss(cfg: Config, params, emb, true_ids, rng):
    """Softmax cross-entropy over {true} and the sampled classes."""
    sampled = log_uniform_sample(rng, cfg.num_sampled, cfg.vocab_size, emb.device)
    t, s = _logits(cfg, params, emb, true_ids, sampled)
    logits = torch.cat([t[:, None], s], dim=-1)  # [B, 1+S]; gold = 0
    return (torch.logsumexp(logits, dim=-1) - logits[:, 0]).mean()


def loss_fn(cfg: Config):
    """``f(params, model_state, batch, rng) -> (loss, (model_state,
    metrics))`` over a {"center", "context"} batch; ``rng`` (a threefry
    key) draws the negatives."""

    def f(params, model_state, batch, rng):
        emb = layers.embedding_lookup(params["emb"], batch["center"], dtype=cfg.dtype,
                                      vocab_size=cfg.vocab_size)
        fn = nce_loss if cfg.loss == "nce" else sampled_softmax_loss
        loss = fn(cfg, params, emb, batch["context"], rng)
        return loss, (model_state, {"loss": loss.detach()})

    return f


def similarity(cfg: Config, params, query_ids) -> torch.Tensor:
    """Cosine similarity [Q, V] of the query words against the vocab; on
    a table sharded over ``model``, the queries' rows are gathered from
    their owners and the ranks' columns concatenated."""
    table = params["emb"]["table"]
    norm = table / (torch.linalg.vector_norm(table, dim=-1, keepdim=True) + 1e-8)
    q = layers.embedding_lookup({"table": norm}, query_ids, vocab_size=cfg.vocab_size)
    if table.shape[0] == cfg.vocab_size:
        return q @ norm.T
    return collectives.all_gather(q @ norm.T, 1, axis_name="model", tag="similarity")


#: The fixed_size_partitioner -> mesh mapping (JAX :135-138): both [vocab,
#: dim] tables shard their vocab dim over ``model``; the bias follows.  On
#: a mesh without a model axis they clamp to replicated.
SHARDING_RULES: tuple = (
    (r"emb/table", P("model", None)),
    (r"nce/weights", P("model", None)),
    (r"nce/bias", P("model")),
)
