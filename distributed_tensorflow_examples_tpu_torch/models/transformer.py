"""Decoder-only transformer LM, forward and training loss: the port of
``distributed_tensorflow_examples_tpu/models/transformer.py``.

Pre-norm blocks, learned positional embedding, tanh-GELU MLP.  Params stay
float32 and every matmul runs in the compute dtype (bf16 by default), as in
JAX.  The parameter tree is the JAX one — ``emb``, ``pos``, ``ln_f``,
``head`` and ``block_<i>`` — with kernels in [in, out] layout, and the qkv
output columns read head-major ``(H, 3, head_dim)``, so a tree or a flat
registry vector moves between the packages as it is.

Attention runs through the flash kernel when ``Config.attention`` asks for
it (``"flash"``, or ``"auto"``/``"ulysses"`` where :func:`ops.flash_attention.
flash_viable` holds) and through plain :func:`ops.attention.mha` otherwise.
:func:`loss_fn` is the training loss (mean next-token cross-entropy),
optionally over ``loss_chunks`` sequence chunks whose logits are
recomputed in the backward, and with ``remat`` every block is
recomputed in the backward (``torch.utils.checkpoint`` in the role of
``jax.checkpoint``; a recomputed block launches its flash forward again).
KV-cache decode (:func:`decode_step`, the per-row-position
:func:`decode_step_batch` a serving replica steps, :func:`generate`) keeps
its attention in plain PyTorch, as the reference keeps it outside Pallas.
A mesh, pipeline stages and mixture-of-experts blocks come with the port's
item A8b (the sequence, pipeline and expert axes).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import attention as attn_ops
from ..ops import flash_attention as flash_ops
from ..utils import device as device_lib
from ..utils import threefry
from . import layers

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class Config:
    """The JAX ``Config``: the same fields and defaults (the pipeline and
    MoE fields are carried so a config reads the same in both packages;
    see the module docstring for what the port runs)."""

    vocab_size: int = 32000
    dim: int = 512
    n_layers: int = 6
    n_heads: int = 8
    mlp_ratio: int = 4
    max_seq_len: int = 2048
    causal: bool = True
    attention: str = "auto"
    compute_dtype: str = "bfloat16"
    pipeline_stages: int = 1
    microbatches: int = 4
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    moe_group_size: int = 1024
    remat: bool = False
    loss_chunks: int = 0

    @property
    def dtype(self) -> torch.dtype:
        try:
            return _DTYPES[self.compute_dtype]
        except KeyError:
            raise ValueError(
                f"compute_dtype {self.compute_dtype!r} not in {sorted(_DTYPES)}"
            ) from None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def _check_supported(cfg: Config) -> None:
    if cfg.pipeline_stages > 1:
        raise NotImplementedError(
            "pipeline_stages > 1 waits for the port's model-parallel slice A8b"
        )
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "moe_experts > 0 waits for the port's model-parallel slice A8b"
        )


def param_shapes(cfg: Config) -> dict:
    """The nested key structure JAX ``init`` builds, with a shape tuple at
    each leaf (no values)."""
    _check_supported(cfg)
    d, h = cfg.dim, cfg.dim * cfg.mlp_ratio
    ln = {"scale": (d,), "bias": (d,)}
    shapes: dict = {
        "emb": {"table": (cfg.vocab_size, d)},
        "pos": {"table": (cfg.max_seq_len, d)},
        "ln_f": dict(ln),
        "head": {"kernel": (d, cfg.vocab_size)},
    }
    for i in range(cfg.n_layers):
        shapes[f"block_{i}"] = {
            "ln1": dict(ln),
            "qkv": {"kernel": (d, 3 * d)},
            "proj": {"kernel": (d, d)},
            "ln2": dict(ln),
            "mlp_in": {"kernel": (d, h), "bias": (h,)},
            "mlp_out": {"kernel": (h, d), "bias": (d,)},
        }
    return shapes


def init_numpy(cfg: Config, seed: int, *, device=None) -> dict:
    """The JAX ``init(cfg, jax.random.key(seed))`` as a tree of float32
    numpy arrays: the same keys (``split(key(seed), 4n + 3)``: the
    embedding, the 0.02-normal positions, the head, then four per block
    for qkv, proj, mlp_in and mlp_out), the same initialisers
    (``layers``), so uniform leaves equal JAX's bit for bit and the normal
    positions within a few float32 ulps.  Drawn on ``device``
    (``utils.device.for_drawing``: the card when there is one)."""
    _check_supported(cfg)
    dev = device_lib.for_drawing(device)
    d, h = cfg.dim, cfg.dim * cfg.mlp_ratio
    rngs = threefry.split(threefry.key(seed), 4 * cfg.n_layers + 3)

    def ln():
        return {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)}

    pos = threefry.normal(rngs[1], (cfg.max_seq_len, d), dev)
    params: dict = {
        "emb": layers.embedding_init(rngs[0], cfg.vocab_size, d, device=dev),
        "pos": {"table": pos * torch.tensor(0.02, dtype=torch.float32, device=dev)},
        "ln_f": ln(),
        "head": layers.dense_init(rngs[2], d, cfg.vocab_size, use_bias=False, device=dev),
    }
    for i in range(cfg.n_layers):
        r = rngs[3 + 4 * i : 3 + 4 * (i + 1)]
        params[f"block_{i}"] = {
            "ln1": ln(),
            "qkv": layers.dense_init(r[0], d, 3 * d, use_bias=False, device=dev),
            "proj": layers.dense_init(r[1], d, d, use_bias=False, device=dev),
            "ln2": ln(),
            "mlp_in": layers.dense_init(r[2], d, h, device=dev),
            "mlp_out": layers.dense_init(r[3], h, d, device=dev),
        }
    return layers.as_numpy(params)


def _layernorm(p, x, eps=1e-5):
    """In float32 with the biased variance, cast back to x's dtype."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _use_flash(cfg: Config, seq_len: int, device) -> bool:
    if cfg.attention == "flash":
        return True
    if cfg.attention in ("auto", "ulysses"):
        # Ulysses without a seq-sharded mesh is local attention: the same
        # flash-if-viable policy as auto.
        return flash_ops.flash_viable(seq_len, device, cfg.head_dim)
    return False


def _attention(cfg: Config, q, k, v):
    """Attention on the no-mesh branches: flash kernel or plain mha."""
    if _use_flash(cfg, q.shape[2], q.device):
        return flash_ops.flash_attention(q, k, v, causal=cfg.causal)
    return attn_ops.mha(q, k, v, causal=cfg.causal)


def _block(cfg: Config, p, h):
    """One pre-norm decoder block: attention + dense MLP."""
    B, T = h.shape[0], h.shape[1]
    y = _layernorm(p["ln1"], h)
    qkv = layers.dense(p["qkv"], y, dtype=cfg.dtype)  # [B,T,3D]
    # Output columns read head-major (H, 3, hd), as in JAX.
    qkv = qkv.reshape(B, T, cfg.n_heads, 3, cfg.head_dim)
    q, k, v = [qkv[:, :, :, j].movedim(2, 1) for j in range(3)]  # [B,H,T,hd]
    o = _attention(cfg, q, k, v)
    o = o.movedim(1, 2).reshape(B, T, cfg.dim)
    h = h + layers.dense(p["proj"], o, dtype=cfg.dtype)
    return _mlp_tail(cfg, p, h)


def _mlp_tail(cfg: Config, p, h):
    """ln2 -> dense -> GELU (tanh, jax.nn.gelu's default) -> dense, residual."""
    y = _layernorm(p["ln2"], h)
    y = layers.dense(p["mlp_in"], y, dtype=cfg.dtype)
    y = F.gelu(y, approximate="tanh")
    return h + layers.dense(p["mlp_out"], y, dtype=cfg.dtype)


def _trunk(cfg: Config, params, x):
    """x [B, T] -> h [B, T, D], up to and including ln_f."""
    T = x.shape[1]
    h = layers.embedding_lookup(params["emb"], x, dtype=cfg.dtype)
    h = h + params["pos"]["table"][:T].to(cfg.dtype)[None]
    for i in range(cfg.n_layers):
        block_fn = functools.partial(_block, cfg, params[f"block_{i}"])
        if cfg.remat and torch.is_grad_enabled():
            h = checkpoint(block_fn, h, use_reentrant=False)
        else:
            h = block_fn(h)
    return _layernorm(params["ln_f"], h)


def apply(cfg: Config, params, x, *, mesh=None):
    """x: [B, T] integer ids -> logits [B, T, V] in the compute dtype."""
    _check_supported(cfg)
    if mesh is not None:
        raise NotImplementedError(
            "a mesh waits for the port's model-parallel slice A8b (the transformer's "
            "rule table, the sequence axis)"
        )
    h = _trunk(cfg, params, x)
    return layers.dense(params["head"], h, dtype=cfg.dtype)


# ----------------------------------------------------------------------------
# KV-cache decode (the reference computes its attention outside Pallas, so
# it stays plain PyTorch here too)
# ----------------------------------------------------------------------------


def init_cache(cfg: Config, batch: int, max_len: int, *, device="cpu") -> dict:
    """Per-layer K/V cache [B, H, max_len, hd] of zeros in the compute
    dtype, on ``device`` (the params' device)."""
    shape = (batch, cfg.n_heads, max_len, cfg.head_dim)
    return {
        f"block_{i}": {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        }
        for i in range(cfg.n_layers)
    }


def _block_decode(cfg: Config, p, h, layer_cache, pos, visible):
    """One block for ONE new token per row: h [B, 1, D].  ``pos`` is one
    position shared by every row (an int: the reference's
    ``_block_decode``) or a [B] tensor of a position per row (its
    ``_block_decode_batch``: the sequence-slot serving shape); ``visible``
    the cache positions each row may read (``_visible``).

    The rows' k and v are written into ``layer_cache`` in place at their
    positions (the values the reference's ``dynamic_update_slice`` and
    one-hot ``where`` write), and the causal mask bounds each row at its
    own position, so a row reads only cache entries its session wrote:
    a freed slot needs no reset, and a row's numbers do not depend on the
    other rows.  Scores come from the compute-dtype operands in float32
    (a product of two bf16 values is exact there, as under the
    reference's ``preferred_element_type=f32``), then the mask, the
    float32 softmax, and the probabilities cast to the compute dtype for
    the product with v."""
    B = h.shape[0]
    y = _layernorm(p["ln1"], h)
    qkv = layers.dense(p["qkv"], y, dtype=cfg.dtype)
    qkv = qkv.reshape(B, 1, cfg.n_heads, 3, cfg.head_dim)
    q, k, v = [qkv[:, :, :, j].movedim(2, 1) for j in range(3)]  # [B,H,1,hd]
    ck, cv = layer_cache["k"], layer_cache["v"]
    if isinstance(pos, int):
        ck[:, :, pos] = k[:, :, 0]
        cv[:, :, pos] = v[:, :, 0]
    else:
        rows = torch.arange(B, device=h.device)
        ck[rows, :, pos] = k[:, :, 0]
        cv[rows, :, pos] = v[:, :, 0]
    s = torch.matmul(q.float(), ck.float().transpose(-1, -2)) / math.sqrt(cfg.head_dim)
    s = s.masked_fill(~visible, float("-inf"))
    w = torch.softmax(s, dim=-1).to(cfg.dtype)
    o = torch.matmul(w, cv)
    o = o.movedim(1, 2).reshape(B, 1, cfg.dim)
    h = h + layers.dense(p["proj"], o, dtype=cfg.dtype)
    return _mlp_tail(cfg, p, h)


def _visible(cache_len: int, pos, device) -> torch.Tensor:
    """The causal mask of one decode step: cache position t is visible to
    a row at ``pos`` when t <= pos; [T] for a shared int position,
    [B, 1, 1, T] for a position per row."""
    t_idx = torch.arange(cache_len, device=device)
    if isinstance(pos, int):
        return t_idx <= pos
    return (t_idx[None, :] <= pos[:, None])[:, None, None, :]


def _decode(cfg: Config, params, cache, h, pos):
    visible = _visible(cache["block_0"]["k"].shape[2], pos, h.device)
    for i in range(cfg.n_layers):
        h = _block_decode(cfg, params[f"block_{i}"], h, cache[f"block_{i}"], pos, visible)
    h = _layernorm(params["ln_f"], h)
    return layers.dense(params["head"], h, dtype=cfg.dtype)[:, 0], cache


def decode_step(cfg: Config, params, cache, token, pos):
    """token [B] at the one position ``pos`` -> (logits [B, V] in the
    compute dtype, cache), the cache updated in place."""
    _check_supported(cfg)
    pos = int(pos)
    h = layers.embedding_lookup(params["emb"], token[:, None], dtype=cfg.dtype)
    h = h + params["pos"]["table"][pos : pos + 1].to(cfg.dtype)[None]
    return _decode(cfg, params, cache, h, pos)


def decode_step_batch(cfg: Config, params, cache, token, pos):
    """token [B], pos [B] (a position PER ROW) -> (logits [B, V], cache):
    the sequence-slot step, in which row b advances its own session at
    ``pos[b]``.  Row for row the same numbers as :func:`decode_step`."""
    _check_supported(cfg)
    pos = pos.long()
    h = layers.embedding_lookup(params["emb"], token[:, None], dtype=cfg.dtype)
    h = h + params["pos"]["table"][pos].to(cfg.dtype)[:, None]
    return _decode(cfg, params, cache, h, pos)


def serve_decode_fns(cfg: Config):
    """The ``(init_cache_fn, step_fn)`` pair a serving replica's decode
    engine takes (``serve.ModelReplicaServer(decode_fns=...)``):
    ``init_cache_fn(slots, max_len, device)`` and the per-row-position
    step ``step_fn(params, cache, tokens, pos)``."""
    _check_supported(cfg)

    def init_cache_fn(slots: int, max_len: int, device):
        return init_cache(cfg, slots, max_len, device=device)

    def step_fn(params, cache, tokens, pos):
        return decode_step_batch(cfg, params, cache, tokens, pos)

    return init_cache_fn, step_fn


def generate(cfg: Config, params, prompt, *, max_new_tokens: int,
             temperature: float = 0.0, rng=None) -> torch.Tensor:
    """Autoregressive generation: prompt [B, Tp] -> int32 [B, Tp +
    max_new_tokens] on the params' device.

    One :func:`decode_step` per position over a cache of exactly that
    length: prompt positions are teacher-forced, then greedy (temperature
    0, the first index on a tie) or ``threefry.categorical`` over the
    float32 logits / temperature.  The key (``rng``, a threefry key,
    ``threefry.key(0)`` by default) is split once per position, prompt
    positions included, as the reference's scan does, so the same key
    samples the same tokens in both packages."""
    device = params["emb"]["table"].device
    prompt = torch.as_tensor(prompt, device=device).to(torch.int32)
    B, Tp = prompt.shape
    total = Tp + max_new_tokens
    if total > cfg.max_seq_len:
        raise ValueError(f"{total} tokens > max_seq_len={cfg.max_seq_len}")
    rng = threefry.key(0) if rng is None else rng
    with torch.inference_mode():
        cache = init_cache(cfg, B, total, device=device)
        tok = prompt[:, 0]
        out = [tok]
        for pos in range(total - 1):
            logits, cache = decode_step(cfg, params, cache, tok, pos)
            rng, sub = threefry.split(rng)
            if pos + 1 < Tp:
                tok = prompt[:, pos + 1]  # teacher-force the prompt
            elif temperature > 0:
                tok = threefry.categorical(sub, logits.float() / temperature)
            else:
                tok = torch.argmax(logits, dim=-1)
            tok = tok.to(torch.int32)
            out.append(tok)
        return torch.stack(out, dim=1)


def _chunked_ce(cfg: Config, head_p, h, y):
    """Mean CE from hidden states without materialising [B, T, V] logits:
    ``cfg.loss_chunks`` sequence chunks, each chunk's (head matmul in the
    compute dtype -> f32 logsumexp - gold) under ``checkpoint`` so the
    backward recomputes the chunk's logits instead of storing them.  The
    same math as the dense :func:`layers.softmax_cross_entropy`, the
    global mean regrouped."""
    B, T, D = h.shape
    c = cfg.loss_chunks
    hc = h.reshape(B, c, T // c, D)
    yc = y.reshape(B, c, T // c)

    def one(hcb, ycb):
        logits = layers.dense(head_p, hcb, dtype=cfg.dtype).to(torch.float32)
        lz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ycb.long()[..., None])[..., 0]
        return (lz - gold).sum()

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(c):
        tot = tot + checkpoint(one, hc[:, i], yc[:, i], use_reentrant=False)
    return tot / (B * T)


def loss_fn(cfg: Config, *, mesh=None):
    """The train step's loss: ``f(params, model_state, batch, rng) ->
    (loss, (model_state, metrics))`` with metrics ``loss`` and
    ``perplexity`` (detached), as the JAX ``loss_fn`` builds it."""
    _check_supported(cfg)
    if mesh is not None:
        raise NotImplementedError(
            "a mesh waits for the port's model-parallel slice A8b (the transformer's "
            "rule table, the sequence axis)"
        )

    def f(params, model_state, batch, rng):
        del rng  # the dense transformer draws no noise
        x, y = batch["x"], batch["y"]
        T = x.shape[1]
        if cfg.loss_chunks > 1 and T % cfg.loss_chunks == 0:
            h = _trunk(cfg, params, x)
            ce = _chunked_ce(cfg, params["head"], h, y)
        else:
            logits = apply(cfg, params, x)
            ce = layers.softmax_cross_entropy(
                logits.reshape(-1, cfg.vocab_size), y.reshape(-1)
            )
        d = ce.detach()
        return ce, (model_state, {"loss": d, "perplexity": torch.exp(d)})

    return f
