"""The f32-out routes of the flash forward and the fused backward, checked
with their bf16 rounding flips accounted for (``tools/flash_rounding.py``
``check_fwd`` and ``check_fused``), on the plain versions a CPU tensor
takes.

On the card bf16 in with f32 out runs the tensor-core kernels, whose sums
run in another order than the plain walks'; a p or a ds may then round to
the other neighbouring bf16 value.  The check feeds the plain walks the
kernel's own records (claim 1) and holds each record to the walk's own
(claim 2).  Here a stand-in kernel is the plain walk fed (possibly faulty)
records, so each injected fault can only be caught by the claim aimed at
it.  T 200, BH 2, D 32 and 64, causal and full."""

import numpy as np
import pytest
import torch

from distributed_tensorflow_examples_tpu_torch.ops import flash_attention as torch_flash
from distributed_tensorflow_examples_tpu_torch.tools import flash_rounding

# One intra-op thread: these tiny tests share the machine with the
# timing-sensitive server and fault tests of the other xdist workers.
torch.set_num_threads(1)

T = 200
F32 = torch.float32


def _bf16(t, d, seed, n):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((2, t, d)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(n)]


def _bwd_state(t, d, causal, seed):
    q, k, v, do = _bf16(t, d, seed, 4)
    o, lse = torch_flash.fwd_plain(q, k, v, causal=causal)
    return q, k, v, do, lse, torch_flash.compute_delta(do, o)


def _steps(x, n):
    """bf16 ``x`` moved by ``n`` bf16 steps (its bit pattern plus n)."""
    return (x.view(torch.int16) + n).view(torch.bfloat16)


def _close(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(want.float().abs().max().item(), 1e-30), err


# ----------------------------------------------------------------------------
# The walks fed their own records
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_fwd_walk_fed_its_own_records_reproduces_itself(d, causal):
    """Fed the (p, m) it kept (p rounded to bf16 as p.v takes it, each
    row's running max after each k tile), the forward walk gives back its
    own o and lse."""
    q, k, v = _bf16(T, d, 400 + d + causal, 3)
    o, lse, kept = torch_flash._fwd_walk(q, k, v, causal, F32, keep=True)
    p, m = kept
    nk = -(-T // torch_flash.FWD_BLOCK_K)
    assert p.dtype == torch.bfloat16 and tuple(p.shape) == (2, T, T)
    assert m.dtype == F32 and tuple(m.shape) == (2, T, nk)
    if causal:  # no pair above the diagonal holds a p
        assert not torch.triu(p.float(), diagonal=1).any()
    assert torch.equal(o, torch_flash.fwd_plain(q, k, v, causal=causal, out_dtype=F32)[0])
    fed_o, fed_lse = torch_flash._fwd_walk(q, k, v, causal, F32, given=kept)
    _close(fed_o, o, 1e-6)
    _close(fed_lse, lse, 1e-6)
    with pytest.raises(ValueError, match="not both"):
        torch_flash._fwd_walk(q, k, v, causal, F32, given=kept, keep=True)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_fused_walk_fed_its_own_records_reproduces_itself(d, causal):
    """Fed the (p, ds) it kept, rounded to bf16 as its products take them,
    the fused walk gives back its own dq, dk and dv."""
    args = _bwd_state(T, d, causal, seed=410 + d + causal)
    *grads, kept = torch_flash._fused_walk(*args, causal, F32, keep=True)
    for x in kept:
        assert x.dtype == torch.bfloat16 and tuple(x.shape) == (2, T, T)
    if causal:
        assert not torch.triu(kept[0].float(), diagonal=1).any()
    for got, want in zip(grads, torch_flash.fused_bwd_plain(*args, causal=causal, out_dtype=F32)):
        assert torch.equal(got, want)
    for got, want in zip(torch_flash._fused_walk(*args, causal, F32, given=kept), grads):
        _close(got, want, 1e-6)
    with pytest.raises(ValueError, match="not both"):
        torch_flash._fused_walk(*args, causal, F32, given=kept, keep=True)


@pytest.mark.parametrize("causal", [False, True])
def test_record_calls_on_the_cpu_are_the_plain_walks(causal):
    """``fwd_record``/``fused_bwd_record`` on CPU tensors: the plain f32-out
    results and the walks' own records, which pass the checks with no
    flip."""
    q, k, v = _bf16(T, 32, 420 + causal, 3)
    o, lse, rec = torch_flash.fwd_record(q, k, v, causal=causal)
    for got, want in zip((o, lse), torch_flash.fwd_plain(q, k, v, causal=causal, out_dtype=F32)):
        assert torch.equal(got, want)
    res = flash_rounding.check_fwd(torch_flash, (q, k, v), causal, (o, lse), rec)
    assert res["ok"] and res["failed"] == []
    assert res["fed"] == {"o": 0.0, "lse": 0.0}
    fwd = res["flash_fwd"]
    assert fwd["p_steps"] == 0 and fwd["p_flips"] == 0.0 and fwd["m_excess"] <= 0

    args = _bwd_state(T, 32, causal, seed=430 + causal)
    dq, dk, dv, rec = torch_flash.fused_bwd_record(*args, causal=causal)
    for got, want in zip((dq, dk, dv),
                         torch_flash.fused_bwd_plain(*args, causal=causal, out_dtype=F32)):
        assert torch.equal(got, want)
    res = flash_rounding.check_fused(torch_flash, args, causal, (dq, dk, dv), rec)
    assert res["ok"] and res["failed"] == []
    assert res["fed"] == {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    fused = res["flash_fused_bwd"]
    assert fused["p_flips"] == fused["ds_flips"] == 0.0
    assert fused["p_steps"] == 0 and fused["ds_excess"] <= 0


# ----------------------------------------------------------------------------
# Stand-in kernels with injected faults and with one-step flips
# ----------------------------------------------------------------------------


def _last_m(m, causal):
    """Each row's running max after the last k tile its block visits."""
    rows = torch.arange(T)
    if causal:
        q1 = torch.clamp((rows // torch_flash.FWD_BLOCK_Q + 1) * torch_flash.FWD_BLOCK_Q, max=T)
        last = -(-q1 // torch_flash.FWD_BLOCK_K) - 1
    else:
        last = torch.full_like(rows, m.shape[-1] - 1)
    return m[:, rows, last][..., None]


def _fwd_like(qkv, causal, fault):
    """A stand-in forward kernel's (o, lse) and records with ``fault``: its
    outputs are what the plain walk gives fed its (faulty) records."""
    _o, _lse, (p, m) = torch_flash.fwd_record(*qkv, causal=causal)
    p, m = p.clone(), m.clone()
    live = p.float().argmax()  # the largest p: a pair no mask touches
    low = (p.float() + 2 * (p.float() == 0)).argmin()  # the smallest live p
    if fault == "p_two_steps":
        p.view(-1)[live] = _steps(p.view(-1)[live], 2)
    elif fault == "m_off":  # the last row's max after tile 0, far past its bound
        m[:, -1, 0] += 2.0 ** -4
    elif fault == "one_step_flips":
        p.view(-1)[live] = _steps(p.view(-1)[live], -1)
        p.view(-1)[low] = _steps(p.view(-1)[low], 1)
    o, lse = torch_flash._fwd_walk(*qkv, causal, F32, given=(p, m))
    if fault == "o_without_1_over_l":
        o = o * torch.exp(lse - _last_m(m, causal) * torch_flash.LN2)
    return (o, lse), (p, m)


@pytest.mark.parametrize("fault,claim", [("p_two_steps", "claim 2 flash_fwd: a p"),
                                         ("m_off", "claim 2 flash_fwd: a running max"),
                                         ("o_without_1_over_l", "claim 1 o")])
def test_fwd_check_catches_injected_faults(fault, claim):
    """A p two bf16 steps off, a running max off by more than its bound, o
    without its 1/l: each fails ``check_fwd``, at the claim aimed at it."""
    qkv = _bf16(T, 64, 440, 3)
    got, rec = _fwd_like(qkv, True, fault)
    res = flash_rounding.check_fwd(torch_flash, qkv, True, got, rec)
    assert not res["ok"]
    assert any(f.startswith(claim) for f in res["failed"]), res["failed"]


@pytest.mark.parametrize("causal", [False, True])
def test_fwd_check_allows_one_step_flips(causal):
    """Two p one bf16 step from the plain walk's, with the o and lse a
    kernel that used them would give: ``check_fwd`` passes and counts
    them."""
    qkv = _bf16(T, 32, 450 + causal, 3)
    got, rec = _fwd_like(qkv, causal, "one_step_flips")
    res = flash_rounding.check_fwd(torch_flash, qkv, causal, got, rec)
    assert res["ok"], res["failed"]
    fwd = res["flash_fwd"]
    assert fwd["p_steps"] == 1 and fwd["p_flips"] > 0
    assert fwd["p_worst_over_bound"] <= 1 and fwd["m_worst_over_bound"] == 0.0


def _fused_like(args, causal, fault, d):
    """A stand-in fused kernel's (dq, dk, dv) and records with ``fault``."""
    *_grads, (p, ds) = torch_flash.fused_bwd_record(*args, causal=causal)
    p, ds = p.clone(), ds.clone()
    live = p.float().argmax()
    big = ds.float().abs().argmax()
    if fault == "p_two_steps":
        p.view(-1)[live] = _steps(p.view(-1)[live], 2)
    elif fault == "ds_sign":
        ds.view(-1)[big] = -ds.view(-1)[big]
    elif fault == "one_step_flips":
        p.view(-1)[live] = _steps(p.view(-1)[live], 1)
        ds.view(-1)[big] = _steps(ds.view(-1)[big], -1)
    dq, dk, dv = torch_flash._fused_walk(*args, causal, F32, given=(p, ds))
    if fault == "dq_scale":  # dq without its 1/sqrt(D)
        dq = dq * d ** 0.5
    return (dq, dk, dv), (p, ds)


@pytest.mark.parametrize("fault,claim", [("p_two_steps", "claim 2 flash_fused_bwd: a p"),
                                         ("ds_sign", "claim 2 flash_fused_bwd: a ds"),
                                         ("dq_scale", "claim 1 dq")])
def test_fused_check_catches_injected_faults(fault, claim):
    """A p two bf16 steps off, one ds of the wrong sign, dq without its
    1/sqrt(D): each fails ``check_fused``, at the claim aimed at it."""
    args = _bwd_state(T, 64, True, seed=460)
    got, rec = _fused_like(args, True, fault, 64)
    res = flash_rounding.check_fused(torch_flash, args, True, got, rec)
    assert not res["ok"]
    assert any(f.startswith(claim) for f in res["failed"]), res["failed"]


@pytest.mark.parametrize("causal", [False, True])
def test_fused_check_allows_one_step_flips(causal):
    """A p and a ds one bf16 step from the plain walk's, with the outputs a
    kernel that used them would give: ``check_fused`` passes and counts
    the flips."""
    args = _bwd_state(T, 32, causal, seed=470 + causal)
    got, rec = _fused_like(args, causal, "one_step_flips", 32)
    res = flash_rounding.check_fused(torch_flash, args, causal, got, rec)
    assert res["ok"], res["failed"]
    fused = res["flash_fused_bwd"]
    assert fused["p_steps"] == 1 and fused["p_flips"] > 0 and fused["ds_flips"] > 0
    assert fused["ds_worst_over_bound"] <= 1


def test_checks_refuse_records_of_the_wrong_shape():
    """Records of another shape or dtype raise before any claim runs."""
    qkv = _bf16(T, 32, 480, 3)
    o, lse, (p, m) = torch_flash.fwd_record(*qkv, causal=True)
    with pytest.raises(ValueError, match="p must be"):
        flash_rounding.check_fwd(torch_flash, qkv, True, (o, lse), (p.float(), m))
    with pytest.raises(ValueError, match="m must be"):
        flash_rounding.check_fwd(torch_flash, qkv, True, (o, lse), (p, m[..., :-1]))
    args = _bwd_state(T, 32, True, seed=481)
    *grads, (p, ds) = torch_flash.fused_bwd_record(*args, causal=True)
    with pytest.raises(ValueError, match="records must be"):
        flash_rounding.check_fused(torch_flash, args, True, grads, (p, ds[:, :-1]))
