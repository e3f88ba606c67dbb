"""Decoder-only transformer LM, forward only: the port of
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
A mesh, pipeline stages and mixture-of-experts blocks come with the port's
model-parallel slice; KV-cache decode with its decode slice; the loss and
training with its training slice.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import attention as attn_ops
from ..ops import flash_attention as flash_ops
from . import layers

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class Config:
    """The JAX ``Config``: the same fields and defaults (the mesh, pipeline,
    MoE, remat and loss fields are carried so a config reads the same in
    both packages; see the module docstring for what this slice runs)."""

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
            "pipeline_stages > 1 waits for the port's model-parallel slice"
        )
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "moe_experts > 0 waits for the port's model-parallel slice"
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


def init_numpy(cfg: Config, seed: int) -> dict:
    """Random float32 weights at the JAX init's scales, drawn from
    ``numpy.random.default_rng(seed)``: glorot-uniform kernels,
    U[-1/dim, 1/dim] embedding, 0.02-normal positions, unit LayerNorm
    scales and zero biases.  (JAX draws other numbers from its own keys;
    what matches is the distribution and the tree.)"""
    rng = np.random.default_rng(seed)

    def leaf(path: str, shape):
        name = path.rsplit("/", 1)[-1]
        if path == "emb/table":
            s = 1.0 / shape[-1]
            return rng.uniform(-s, s, shape).astype(np.float32)
        if path == "pos/table":
            return (0.02 * rng.standard_normal(shape)).astype(np.float32)
        if name == "kernel":
            lim = math.sqrt(6.0 / (shape[0] + shape[1]))
            return rng.uniform(-lim, lim, shape).astype(np.float32)
        if name == "scale":
            return np.ones(shape, np.float32)
        return np.zeros(shape, np.float32)  # biases

    def walk(node, prefix):
        return {
            k: walk(v, f"{prefix}{k}/") if isinstance(v, dict)
            else leaf(prefix + k, v)
            for k, v in node.items()
        }

    return walk(param_shapes(cfg), "")


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
        h = _block(cfg, params[f"block_{i}"], h)
    return _layernorm(params["ln_f"], h)


def apply(cfg: Config, params, x, *, mesh=None):
    """x: [B, T] integer ids -> logits [B, T, V] in the compute dtype."""
    _check_supported(cfg)
    if mesh is not None:
        raise NotImplementedError(
            "a mesh waits for the port's model-parallel slice"
        )
    h = _trunk(cfg, params, x)
    return layers.dense(params["head"], h, dtype=cfg.dtype)
