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

Under a ``mesh`` (``parallel/mesh.py``; JAX's mesh path of ``_trunk``,
``_block``, ``_mlp_tail``, ``_attention`` and ``_flash_sharded``) each rank
runs its block of the step, laid out by :func:`sharding_rules`:

- ``data`` and ``seq``: the rank's rows and its slice ``[s T/S, (s+1) T/S)``
  of the sequence (:func:`batch_spec`), the position table read at that
  offset; attention over a seq axis runs as the ring (the flash kernels
  per hop, or plain) or as Ulysses (``ops/attention.py``), by
  ``Config.attention``, as JAX's ``sequence_parallel_attention``;
- ``model``: Megatron tensor parallelism, qkv and mlp_in column-sharded,
  proj and mlp_out row-sharded; the head-major qkv columns give a model
  block whole heads.  Where GSPMD derives the collectives, the port writes
  them: ``collectives.copy_to_model`` where an activation replicated over
  ``model`` enters a sharded product (its gradient sums over ``model``),
  ``collectives.reduce_from_model`` on the row-sharded products' partial
  sums.  The embedding (vocab rows) and the head (vocab columns) are
  vocab-parallel (``layers.embedding_lookup``,
  ``layers.vocab_parallel_cross_entropy``); :func:`apply` then returns
  this rank's vocab block of the logits.

- ``expert`` (``moe_experts > 0``): every block's MLP is a mixture of
  experts (``ops/moe.py``, JAX ``_moe_tail``), the batch's rows split over
  data x expert (:func:`batch_spec`, JAX ``Config.data_axes``), each
  rank holding its ``E/X`` experts (``ops.moe.SHARDING_RULES``, which
  compose with ``model`` as the Megatron MLP does); the tokens cross the
  expert group by all-to-all, and :func:`loss_fn` adds
  ``moe_aux_weight`` times the layers' Switch loss (``metrics["moe_aux"]``).

- ``pipe`` (``pipeline_stages > 1``): the blocks are stacked (one
  ``blocks`` tree whose leaves carry a leading layer dim, JAX's
  pipeline layout), each pipe rank holding its L/S layers
  (:func:`sharding_rules`), and run under the GPipe schedule of
  ``parallel/pipeline.py`` with ``microbatches`` microbatches; the
  stage body is the same block (the flash kernels on the card, Megatron
  over ``model``), recomputed in the backward.  :func:`collapse_pipeline`
  turns the stacked layout into the per-layer one for decode and serving.

A block runs its collectives only where its leaves are blocks: whole
leaves (a one-rank step beside a model mesh) run none.  KV-cache decode
(:func:`decode_step`, the per-row-position :func:`decode_step_batch` a
serving replica steps, :func:`generate`) keeps its attention in plain
PyTorch, as the reference keeps it outside Pallas.  Under a mesh it runs
on the rank's rows (data x expert) with the training layout: the cache
holds the rank's heads over ``model`` (:func:`init_cache`), the blocks
are Megatron's, MoE blocks route through the training layer, the
vocab-parallel head's logits are gathered over ``model`` so every rank
picks the same token, and a ``seq`` axis is replicated (the decode's T of
1 never touches it: JAX's ``_decode_constrain``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import attention as attn_ops
from ..ops import flash_attention as flash_ops
from ..ops import moe as moe_ops
from ..parallel import collectives, sharding
from ..parallel import pipeline as pipeline_lib
from ..parallel.partitioner import PartitionSpec as P
from ..utils import device as device_lib
from ..utils import threefry
from . import layers

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class Config:
    """The JAX ``Config``: the same fields and defaults.
    ``pipeline_stages > 1`` stacks the blocks and runs them under the
    GPipe schedule over the mesh's ``pipe`` axis (which must be that
    size), with ``microbatches`` microbatches a step."""

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

    @property
    def data_axes(self) -> tuple:
        """The mesh axes the batch's rows shard over: ``("data", "expert")``
        for a mixture of experts (tokens leave their rank for their
        experts' ranks), else ``("data",)``."""
        return ("data", "expert") if self.moe_experts > 0 else ("data",)


def _check_supported(cfg: Config) -> None:
    """JAX ``init``'s refusals: stages that do not divide the layers, and
    MoE under stages."""
    if cfg.pipeline_stages > 1 and cfg.n_layers % cfg.pipeline_stages:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by pipeline_stages={cfg.pipeline_stages}"
        )
    if cfg.moe_experts > 0 and cfg.pipeline_stages > 1:
        raise ValueError("moe_experts and pipeline_stages>1 do not compose (v1)")


def _moe_cfg(cfg: Config) -> moe_ops.MoEConfig:
    return moe_ops.MoEConfig(
        n_experts=cfg.moe_experts,
        top_k=cfg.moe_top_k,
        capacity_factor=cfg.moe_capacity_factor,
        group_size=cfg.moe_group_size,
    )


def param_shapes(cfg: Config) -> dict:
    """The nested key structure JAX ``init`` builds, with a shape tuple at
    each leaf (no values): ``block_<i>``, or one stacked ``blocks`` tree
    (a leading layer dim on every leaf) when ``pipeline_stages > 1``."""
    _check_supported(cfg)
    d, h = cfg.dim, cfg.dim * cfg.mlp_ratio
    ln = {"scale": (d,), "bias": (d,)}
    shapes: dict = {
        "emb": {"table": (cfg.vocab_size, d)},
        "pos": {"table": (cfg.max_seq_len, d)},
        "ln_f": dict(ln),
        "head": {"kernel": (d, cfg.vocab_size)},
    }
    e = cfg.moe_experts
    blocks = []
    for _i in range(cfg.n_layers):
        b = {
            "ln1": dict(ln),
            "qkv": {"kernel": (d, 3 * d)},
            "proj": {"kernel": (d, d)},
            "ln2": dict(ln),
        }
        if e > 0:
            b["moe"] = {"router": {"kernel": (d, e)}, "w1": (e, d, h), "b1": (e, h),
                        "w2": (e, h, d), "b2": (e, d)}
        else:
            b["mlp_in"] = {"kernel": (d, h), "bias": (h,)}
            b["mlp_out"] = {"kernel": (h, d), "bias": (d,)}
        blocks.append(b)
    return _place_blocks(cfg, shapes, blocks, lambda *xs: (len(xs), *xs[0]))


def _place_blocks(cfg: Config, tree: dict, blocks: list, stack) -> dict:
    """``tree`` with the per-layer ``blocks`` as ``block_<i>`` keys, or
    stacked leaf by leaf (``stack(*leaves)``) under ``blocks`` when
    pipelined (JAX ``init``)."""
    if cfg.pipeline_stages > 1:
        tree["blocks"] = pipeline_lib.tree_map(stack, *blocks)
    else:
        for i, b in enumerate(blocks):
            tree[f"block_{i}"] = b
    return tree


def init_numpy(cfg: Config, seed: int, *, device=None) -> dict:
    """The JAX ``init(cfg, jax.random.key(seed))`` as a tree of float32
    numpy arrays: the same keys (``split(key(seed), 4n + 3)``: the
    embedding, the 0.02-normal positions, the head, then four per block
    for qkv, proj, mlp_in and mlp_out, or for qkv, proj and the experts
    from the third, ``moe.init``), the same initialisers (``layers``), so
    uniform leaves equal JAX's bit for bit and the normal positions within
    a few float32 ulps; pipelined, the per-layer draws stacked, as JAX
    stacks them.  Drawn on ``device`` (``utils.device.for_drawing``: the
    card when there is one)."""
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
    blocks = []
    for i in range(cfg.n_layers):
        r = rngs[3 + 4 * i : 3 + 4 * (i + 1)]
        b = {
            "ln1": ln(),
            "qkv": layers.dense_init(r[0], d, 3 * d, use_bias=False, device=dev),
            "proj": layers.dense_init(r[1], d, d, use_bias=False, device=dev),
            "ln2": ln(),
        }
        if cfg.moe_experts > 0:
            b["moe"] = moe_ops.init(r[2], d, h, _moe_cfg(cfg), device=dev)
        else:
            b["mlp_in"] = layers.dense_init(r[2], d, h, device=dev)
            b["mlp_out"] = layers.dense_init(r[3], h, d, device=dev)
        blocks.append(layers.as_numpy(b))
    return layers.as_numpy(_place_blocks(cfg, params, blocks, lambda *xs: np.stack(xs)))


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


def _attention(cfg: Config, q, k, v, mesh=None):
    """Attention dispatch (JAX ``_attention``): over a seq-sharded mesh the
    ring or Ulysses (``attn_ops.sequence_parallel_attention``, the
    ``Config.attention`` value naming the impl, so an explicit "xla" never
    becomes the flash ring); else the flash kernel or plain mha on this
    rank's heads (JAX's ``_flash_sharded``: batch and heads are local)."""
    if mesh is not None and mesh.shape.get("seq", 1) > 1:
        return attn_ops.sequence_parallel_attention(q, k, v, causal=cfg.causal,
                                                    impl=cfg.attention)
    if _use_flash(cfg, q.shape[2], q.device):
        return flash_ops.flash_attention(q, k, v, causal=cfg.causal)
    return attn_ops.mha(q, k, v, causal=cfg.causal)


def _sharded(p, name: str, full: int) -> bool:
    """Whether kernel ``p[name]["kernel"]`` is this rank's block of columns
    over ``model`` (the whole kernel has ``full``)."""
    return p[name]["kernel"].shape[1] != full


def _row_parallel(p, y, dtype):
    """``dense(p, y)`` for a row-sharded kernel: the blocks' partial
    products summed over ``model``, then the (replicated) bias."""
    out = collectives.reduce_from_model(torch.matmul(y.to(dtype), p["kernel"].to(dtype)))
    if "bias" in p:
        out = out + p["bias"].to(dtype)
    return out


def _block(cfg: Config, p, h, mesh=None):
    """One pre-norm decoder block: attention + (dense | MoE) FFN, Megatron
    tensor-parallel where the kernels are ``model`` blocks.  Returns
    ``(h, aux)``, ``aux`` the MoE layer's load-balance loss (None for the
    dense MLP)."""
    B, T = h.shape[0], h.shape[1]
    tp = _sharded(p, "qkv", 3 * cfg.dim)
    y = _layernorm(p["ln1"], h)
    if tp:
        y = collectives.copy_to_model(y)
    qkv = layers.dense(p["qkv"], y, dtype=cfg.dtype)  # [B,T,3D] (this rank's 3D/M)
    # Output columns read head-major (H, 3, hd), as in JAX: a model block
    # of the column-sharded kernel holds whole heads.
    heads = qkv.shape[-1] // (3 * cfg.head_dim)
    qkv = qkv.reshape(B, T, heads, 3, cfg.head_dim)
    q, k, v = [qkv[:, :, :, j].movedim(2, 1) for j in range(3)]  # [B,H,T,hd]
    o = _attention(cfg, q, k, v, mesh)
    o = o.movedim(1, 2).reshape(B, T, heads * cfg.head_dim)
    if tp:
        h = h + _row_parallel(p["proj"], o, cfg.dtype)
    else:
        h = h + layers.dense(p["proj"], o, dtype=cfg.dtype)
    return _ffn_tail(cfg, p, h, mesh)


def _ffn_tail(cfg: Config, p, h, mesh):
    """(h after the block's FFN, its aux loss): the MoE layer (JAX
    ``_moe_tail``: ln2, the experts, the residual) or the dense MLP (aux
    None)."""
    if "moe" not in p:
        return _mlp_tail(cfg, p, h), None
    y = _layernorm(p["ln2"], h)
    y, aux = moe_ops.apply(p["moe"], y, _moe_cfg(cfg), dtype=cfg.dtype, mesh=mesh,
                           hidden=cfg.dim * cfg.mlp_ratio)
    return h + y, aux


def _mlp_tail(cfg: Config, p, h):
    """ln2 -> dense -> GELU (tanh, jax.nn.gelu's default) -> dense,
    residual; column- then row-parallel where the kernels are blocks."""
    y = _layernorm(p["ln2"], h)
    tp = _sharded(p, "mlp_in", cfg.dim * cfg.mlp_ratio)
    if tp:
        y = collectives.copy_to_model(y)
    y = layers.dense(p["mlp_in"], y, dtype=cfg.dtype)
    y = F.gelu(y, approximate="tanh")
    if tp:
        return h + _row_parallel(p["mlp_out"], y, cfg.dtype)
    return h + layers.dense(p["mlp_out"], y, dtype=cfg.dtype)


def _trunk(cfg: Config, params, x, mesh=None):
    """x [B, T] (this rank's rows and sequence slice under a mesh) -> (h
    [B, T, D], up to and including ln_f; the blocks' summed aux loss).
    Positions start at the slice's global offset, ``seq_index * T``."""
    T = x.shape[1]
    off = collectives.axis_index("seq") * T if mesh is not None else 0
    h = layers.embedding_lookup(params["emb"], x, dtype=cfg.dtype, vocab_size=cfg.vocab_size)
    h = h + params["pos"]["table"][off:off + T].to(cfg.dtype)[None]
    if cfg.pipeline_stages > 1:
        # MoE is refused under stages, so the aux loss is 0, as in JAX.
        h = _pipeline_trunk(cfg, params["blocks"], h, mesh)
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        return _layernorm(params["ln_f"], h), zero
    aux_total = None
    for i in range(cfg.n_layers):
        block_fn = functools.partial(_block, cfg, params[f"block_{i}"], mesh=mesh)
        if cfg.remat and torch.is_grad_enabled():
            h, aux = checkpoint(_under_axes(mesh, block_fn), h, use_reentrant=False)
        else:
            h, aux = block_fn(h)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    if aux_total is None:  # a dense model's: 0, as in JAX
        aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    return _layernorm(params["ln_f"], h), aux_total


def _layer(blocks, i: int):
    """Layer ``i`` of a stacked blocks tree (views)."""
    return pipeline_lib.tree_map(lambda x: x[i], blocks)


def _pipeline_trunk(cfg: Config, blocks, h, mesh):
    """The stacked blocks over h (JAX ``_trunk``'s pipeline branch): the
    GPipe schedule over the mesh's ``pipe`` axis, each stage this rank's
    layers in order; all of them in order without a mesh."""
    if mesh is not None and mesh.shape.get("pipe", 1) != cfg.pipeline_stages:
        raise ValueError(
            f"pipeline_stages={cfg.pipeline_stages} needs a mesh whose 'pipe' axis is "
            f"exactly that size; got {dict(mesh.shape)} (pass e.g. --mesh "
            f'"data=...,pipe={cfg.pipeline_stages}")'
        )

    def stage_fn(rank_blocks, x):
        for i in range(rank_blocks["qkv"]["kernel"].shape[0]):
            x, _ = _block(cfg, _layer(rank_blocks, i), x, mesh)
        return x

    if mesh is None:
        return stage_fn(blocks, h)
    return pipeline_lib.pipeline_apply(mesh, stage_fn, blocks, h,
                                       microbatches=cfg.microbatches)


def collapse_pipeline(cfg: Config, params):
    """A pipeline-trained tree -> the per-layer serving layout (JAX
    ``collapse_pipeline``): the stacked ``blocks`` become ``block_<i>``
    keys and ``pipeline_stages`` drops to 1 (and ``microbatches`` to 1),
    so the result decodes through the KV-cache path.  The leaves are
    views of the stacked ones (numpy or tensors); ``cfg`` unchanged when
    not pipelined."""
    if cfg.pipeline_stages <= 1:
        return cfg, params
    flat = {k: v for k, v in params.items() if k != "blocks"}
    for i, b in enumerate(pipeline_lib.unstack_stages(params["blocks"], cfg.n_layers)):
        flat[f"block_{i}"] = b
    return dataclasses.replace(cfg, pipeline_stages=1, microbatches=1), flat


def _under_axes(mesh, fn):
    """``fn`` run under the mesh's groups: a recomputation in the backward
    runs on autograd's thread, which has none installed."""
    if mesh is None:
        return fn

    def run(*args):
        with mesh.axes():
            return fn(*args)

    return run


def _head(cfg: Config, params, h):
    """Logits [B, T, V] in the compute dtype, or this model rank's vocab
    block [B, T, V/M] of them where the head kernel is column-sharded."""
    if _sharded(params, "head", cfg.vocab_size):
        h = collectives.copy_to_model(h)
    return layers.dense(params["head"], h, dtype=cfg.dtype)


def _ce(cfg: Config, logits, y):
    """Mean cross-entropy of logits (whole, or this rank's vocab block)."""
    logits = logits.reshape(-1, logits.shape[-1])
    if logits.shape[-1] != cfg.vocab_size:
        return layers.vocab_parallel_cross_entropy(logits, y.reshape(-1))
    return layers.softmax_cross_entropy(logits, y.reshape(-1))


def apply(cfg: Config, params, x, *, mesh=None, return_aux=False):
    """x: [B, T] integer ids -> logits [B, T, V] in the compute dtype (or
    ``(logits, moe_aux)`` with ``return_aux``).  Under a ``mesh``: this
    rank's rows and sequence slice, and its vocab block of the logits
    where the head is column-sharded."""
    _check_supported(cfg)
    h, aux = _trunk(cfg, params, x, mesh)
    logits = _head(cfg, params, h)
    return (logits, aux) if return_aux else logits


# ----------------------------------------------------------------------------
# KV-cache decode (the reference computes its attention outside Pallas, so
# it stays plain PyTorch here too)
# ----------------------------------------------------------------------------


def init_cache(cfg: Config, batch: int, max_len: int, *, device="cpu", mesh=None) -> dict:
    """Per-layer K/V cache [B, H, max_len, hd] of zeros in the compute
    dtype, on ``device`` (the params' device).  ``mesh``: the cache of
    this rank's ``batch`` rows and its H/M heads over ``model`` (JAX's
    ``P(data_axes, "model")`` cache, born sharded)."""
    heads = cfg.n_heads // (1 if mesh is None else mesh.shape.get("model", 1))
    shape = (batch, heads, max_len, cfg.head_dim)
    return {
        f"block_{i}": {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        }
        for i in range(cfg.n_layers)
    }


def _block_decode(cfg: Config, p, h, layer_cache, pos, visible, mesh=None):
    """One block for ONE new token per row: h [B, 1, D].  ``pos`` is one
    position shared by every row (an int: the reference's
    ``_block_decode``) or a [B] tensor of a position per row (its
    ``_block_decode_batch``: the sequence-slot serving shape); ``visible``
    the cache positions each row may read (``_visible``).

    The rows' k and v are written into ``layer_cache`` in place at their
    positions (the values the reference's ``dynamic_update_slice`` and
    one-hot ``where`` write), and the causal mask bounds each row at its
    own position, so a row reads only cache entries its session wrote:
    a freed slot needs no reset, and a row's attention does not depend on
    the other rows.  Scores come from the compute-dtype operands in
    float32 (a product of two bf16 values is exact there, as under the
    reference's ``preferred_element_type=f32``), then the mask, the
    float32 softmax, and the probabilities cast to the compute dtype for
    the product with v.  Megatron where the kernels are ``model`` blocks
    (the rank's heads, the row blocks' products summed).  An MoE block
    routes its rows through the training layer (``ops/moe.py``; ``mesh``:
    this rank's rows of a data x expert mesh), its aux loss unused; the
    rows share the experts' capacity, as in JAX, which drops none while a
    group holds no more tokens than C."""
    B = h.shape[0]
    tp = _sharded(p, "qkv", 3 * cfg.dim)
    y = _layernorm(p["ln1"], h)
    if tp:
        y = collectives.copy_to_model(y)
    qkv = layers.dense(p["qkv"], y, dtype=cfg.dtype)
    heads = qkv.shape[-1] // (3 * cfg.head_dim)
    qkv = qkv.reshape(B, 1, heads, 3, cfg.head_dim)
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
    o = o.movedim(1, 2).reshape(B, 1, heads * cfg.head_dim)
    if tp:
        h = h + _row_parallel(p["proj"], o, cfg.dtype)
    else:
        h = h + layers.dense(p["proj"], o, dtype=cfg.dtype)
    return _ffn_tail(cfg, p, h, mesh)[0]


def _visible(cache_len: int, pos, device) -> torch.Tensor:
    """The causal mask of one decode step: cache position t is visible to
    a row at ``pos`` when t <= pos; [T] for a shared int position,
    [B, 1, 1, T] for a position per row."""
    t_idx = torch.arange(cache_len, device=device)
    if isinstance(pos, int):
        return t_idx <= pos
    return (t_idx[None, :] <= pos[:, None])[:, None, None, :]


def _decode(cfg: Config, params, cache, h, pos, mesh):
    visible = _visible(cache["block_0"]["k"].shape[2], pos, h.device)
    for i in range(cfg.n_layers):
        h = _block_decode(cfg, params[f"block_{i}"], h, cache[f"block_{i}"], pos, visible,
                          mesh)
    h = _layernorm(params["ln_f"], h)
    logits = layers.dense(params["head"], h, dtype=cfg.dtype)[:, 0]
    if _sharded(params, "head", cfg.vocab_size):  # the vocab blocks, gathered
        logits = collectives.all_gather(logits, 1, axis_name="model", tag="decode")
    return logits, cache


@dataclasses.dataclass(frozen=True)
class _DecodeShape:
    """What a decode block reads of its mesh: the shape, without ``seq``."""

    shape: dict


def _decode_view(mesh):
    """(the axes to decode under, the mesh a decode block reads): the
    mesh's groups with the ``seq`` axis replicated (JAX
    ``_decode_constrain`` maps every ``seq`` entry to None: the decode's T
    is 1) and the batch the row shards; None for no mesh."""
    if mesh is None:
        return contextlib.nullcontext(), None
    axes = collectives.use_group(
        mesh.group, model=mesh.model_group, expert=mesh.expert_group, batch=mesh.rows_group,
        pipe=mesh.pipe_group, slice=mesh.slice_group, rows=mesh.rows_group)
    return axes, _DecodeShape({a: n for a, n in mesh.shape.items() if a != "seq"})


def decode_step(cfg: Config, params, cache, token, pos, *, mesh=None):
    """token [B] at the one position ``pos`` -> (logits [B, V] in the
    compute dtype, cache), the cache updated in place.  ``mesh``: the
    mesh ``params`` are laid out over, of which ``token`` and the cache
    are this rank's rows (:func:`init_cache`); the logits are whole on
    every rank."""
    _check_decode(cfg)
    pos = int(pos)
    axes, view = _decode_view(mesh)
    with axes:
        h = _decode_embed(cfg, params, token)
        h = h + params["pos"]["table"][pos : pos + 1].to(cfg.dtype)[None]
        return _decode(cfg, params, cache, h, pos, view)


def _check_decode(cfg: Config) -> None:
    _check_supported(cfg)
    if cfg.pipeline_stages > 1:  # JAX's refusal: collapse the stages first
        raise NotImplementedError("decode supports the non-pipelined model (dense or MoE)")


def _decode_embed(cfg: Config, params, token):
    return layers.embedding_lookup(params["emb"], token[:, None], dtype=cfg.dtype,
                                   vocab_size=cfg.vocab_size)


def decode_step_batch(cfg: Config, params, cache, token, pos, *, mesh=None):
    """token [B], pos [B] (a position PER ROW) -> (logits [B, V], cache):
    the sequence-slot step, in which row b advances its own session at
    ``pos[b]``.  Row for row the same numbers as :func:`decode_step`."""
    _check_decode(cfg)
    pos = pos.long()
    axes, view = _decode_view(mesh)
    with axes:
        h = _decode_embed(cfg, params, token)
        h = h + params["pos"]["table"][pos].to(cfg.dtype)[:, None]
        return _decode(cfg, params, cache, h, pos, view)


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
             temperature: float = 0.0, rng=None, mesh=None) -> torch.Tensor:
    """Autoregressive generation: prompt [B, Tp] -> int32 [B, Tp +
    max_new_tokens] on the params' device.

    One :func:`decode_step` per position over a cache of exactly that
    length: prompt positions are teacher-forced, then greedy (temperature
    0, the first index on a tie) or ``threefry.categorical`` over the
    float32 logits / temperature.  The key (``rng``, a threefry key,
    ``threefry.key(0)`` by default) is split once per position, prompt
    positions included, as the reference's scan does, so the same key
    samples the same tokens in both packages.  ``mesh`` (the mesh over
    which ``params`` are laid out: JAX's sharded ``generate``): each rank
    decodes its rows of the prompt (its row shard's; the model ranks
    their heads and vocab blocks, the seq ranks replicated), the experts'
    tokens cross the expert group, and every rank returns the whole batch
    (a temperature draw is over the whole batch's logits, as in JAX)."""
    _check_decode(cfg)
    device = params["emb"]["table"].device
    prompt = torch.as_tensor(prompt, device=device).to(torch.int32)
    total = prompt.shape[1] + max_new_tokens
    if total > cfg.max_seq_len:
        raise ValueError(f"{total} tokens > max_seq_len={cfg.max_seq_len}")
    if mesh is None:
        return _generate(cfg, params, prompt, total, temperature, rng, None)
    axes, _view = _decode_view(mesh)
    with axes:
        rows = sharding.rank_rows(prompt.shape[0], mesh.row_index, mesh.row_shards)
        out = _generate(cfg, params, prompt[rows], total, temperature, rng, mesh)
        return collectives.all_gather(out, 0, axis_name="rows", tag="decode")


def _generate(cfg: Config, params, prompt, total: int, temperature: float, rng, mesh):
    B, Tp = prompt.shape
    spread = mesh is not None and mesh.row_shards > 1
    rng = threefry.key(0) if rng is None else rng
    with torch.inference_mode():
        cache = init_cache(cfg, B, total, device=prompt.device, mesh=mesh)
        tok = prompt[:, 0]
        out = [tok]
        for pos in range(total - 1):
            logits, cache = decode_step(cfg, params, cache, tok, pos, mesh=mesh)
            rng, sub = threefry.split(rng)
            if pos + 1 < Tp:
                tok = prompt[:, pos + 1]  # teacher-force the prompt
            elif temperature > 0:
                scaled = logits.float() / temperature
                if spread:  # the draw over the whole batch, this rank's rows kept
                    whole = collectives.all_gather(scaled, 0, axis_name="rows", tag="decode")
                    tok = threefry.categorical(sub, whole)[
                        sharding.rank_rows(whole.shape[0], mesh.row_index, mesh.row_shards)]
                else:
                    tok = threefry.categorical(sub, scaled)
            else:
                tok = torch.argmax(logits, dim=-1)
            tok = tok.to(torch.int32)
            out.append(tok)
        return torch.stack(out, dim=1)


def _chunked_ce(cfg: Config, params, h, y, mesh=None):
    """Mean CE from hidden states without materialising [B, T, V] logits:
    ``cfg.loss_chunks`` sequence chunks, each chunk's (head matmul in the
    compute dtype -> f32 logsumexp - gold) under ``checkpoint`` so the
    backward recomputes the chunk's logits instead of storing them.  The
    same math as the dense :func:`layers.softmax_cross_entropy` (or its
    vocab-parallel twin), the global mean regrouped."""
    B, T, D = h.shape
    c = cfg.loss_chunks
    head_p = params["head"]
    if _sharded(params, "head", cfg.vocab_size):
        h = collectives.copy_to_model(h)
    hc = h.reshape(B, c, T // c, D)
    yc = y.reshape(B, c, T // c)

    def one(hcb, ycb):
        logits = layers.dense(head_p, hcb, dtype=cfg.dtype)
        return _ce(cfg, logits, ycb) * ycb.numel()

    one = _under_axes(mesh, one)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(c):
        tot = tot + checkpoint(one, hc[:, i], yc[:, i], use_reentrant=False)
    return tot / (B * T)


def loss_fn(cfg: Config, *, mesh=None):
    """The train step's loss: ``f(params, model_state, batch, rng) ->
    (loss, (model_state, metrics))`` with metrics ``loss`` (the
    cross-entropy) and ``perplexity`` (detached), as the JAX ``loss_fn``
    builds it; an MoE model's loss adds ``moe_aux_weight`` times the
    blocks' aux loss, reported as ``moe_aux``.  Under a ``mesh`` the loss
    is this rank's token mean (the step averages it over the data x expert
    x seq ranks; the aux loss is the global batch's on every rank), and,
    as in JAX, ``loss_chunks`` falls back to the dense path when the
    sequence is sharded."""
    _check_supported(cfg)
    seq_sharded = mesh is not None and mesh.shape.get("seq", 1) > 1

    def f(params, model_state, batch, rng):
        del rng  # the transformer draws no noise
        x, y = batch["x"], batch["y"]
        T = x.shape[1]
        if cfg.loss_chunks > 1 and T % cfg.loss_chunks == 0 and not seq_sharded:
            h, aux = _trunk(cfg, params, x, mesh)
            ce = _chunked_ce(cfg, params, h, y, mesh)
        else:
            logits, aux = apply(cfg, params, x, mesh=mesh, return_aux=True)
            ce = _ce(cfg, logits, y)
        d = ce.detach()
        metrics = {"loss": d, "perplexity": torch.exp(d)}
        loss = ce
        if cfg.moe_experts > 0:
            loss = ce + cfg.moe_aux_weight * aux
            metrics["moe_aux"] = aux.detach()
        return loss, (model_state, metrics)

    return f


def batch_spec(cfg: Config | None = None) -> P:
    """[B, T] batches shard the batch over ``data`` (``("data", "expert")``
    for a mixture of experts, ``Config.data_axes``) and the sequence over
    ``seq`` (JAX ``batch_spec``)."""
    return P(cfg.data_axes if cfg is not None else "data", "seq")


#: Megatron TP rules for ONE block (JAX ``_BLOCK_RULES``): qkv/mlp_in
#: column-sharded (output dim), proj/mlp_out row-sharded (input dim).
#: Patterns are block-relative.
_BLOCK_RULES: tuple = (
    (r"qkv/kernel", P(None, "model")),
    (r"proj/kernel", P("model", None)),
    (r"mlp_in/kernel", P(None, "model")),
    (r"mlp_in/bias", P("model")),
    (r"mlp_out/kernel", P("model", None)),
)

_TOP_RULES: tuple = (
    (r"emb/table", P("model", None)),
    (r"pos/table", P(None, None)),
    (r"head/kernel", P(None, "model")),
)

#: Per-layer storage (block_0, block_1, ...): JAX ``SHARDING_RULES``.
SHARDING_RULES: tuple = (
    tuple((rf"block_\d+/{pat}", spec) for pat, spec in _BLOCK_RULES) + _TOP_RULES
)


def _pipeline_rules() -> tuple:
    """Stacked-block storage (JAX ``_pipeline_rules``): the leading layer
    dim over ``pipe`` (each rank holds its stage's layers), the inner dims
    the Megatron specs."""
    return pipeline_lib.stage_sharding_rules(_BLOCK_RULES, "blocks") + _TOP_RULES


def sharding_rules(cfg: Config) -> tuple:
    """The rule table of ``cfg`` (JAX ``sharding_rules``): the stacked
    rules when pipelined, the experts' rules first for an MoE model."""
    _check_supported(cfg)
    if cfg.pipeline_stages > 1:
        return _pipeline_rules()
    if cfg.moe_experts > 0:
        return moe_ops.SHARDING_RULES + SHARDING_RULES
    return SHARDING_RULES
