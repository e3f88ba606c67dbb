#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when
it fails:

1. Build: compile every CUDA kernel source in the checkout
   (``distributed_tensorflow_examples_tpu_torch/ops/csrc``: ``flash_fwd``,
   ``flash_bwd``, ``flash_fused_bwd``, ``bn_stats``), one ``nvcc`` per
   source, all started together.  Print each kernel instance's registers
   and spills (``-Xptxas -v``) and the tensor-core instructions (``HMMA``,
   ``HGMMA``) that ``cuobjdump -sass`` finds in the SASS of the four
   tensor-core kernels (``flash_fwd_tc_kernel``, ``flash_dq_tc_kernel``,
   ``flash_dkv_tc_kernel``, ``flash_fused_bwd_tc_kernel``, one instance
   per head dim); the run fails if one of those spills, has no ptxas
   report or none, or if ``cuobjdump`` is missing.  Each flash library
   must also report (``dtx_<kernel>_route``) the tensor-core kernel for
   bf16 in and out, with the tiles the plain version walks, and the
   CUDA-core one for any f32 side.
2. Kernels against their plain PyTorch versions on the card, at the shapes
   the main paths give them and at the edges the kernels must also take
   (ragged T, head dims 32/64, float32 in and out, non-causal), with the
   tolerances stated below; the backward kernels must also give the same
   bits on a second run.  Then each kernel, its plain version and the
   PyTorch call computing the same function (``scaled_dot_product_attention``
   and its backward, timed as a yardstick only; the port never calls
   either) are timed with CUDA events at the main path's shape, with the
   achieved TFLOP/s of the forward and the fused backward; the forward
   also at the training shapes [64, 2048, 128] and [16, 8192, 128].  The
   BatchNorm statistics kernels (``bn_stats``, ``bn_bwd_stats`` with and
   without the ReLU mask) likewise, at ResNet-50's shapes and a ragged
   f32 one, bitwise equal run to run, and timed against
   ``torch.batch_norm_stats`` / ``torch.batch_norm_backward_reduce`` (the
   yardsticks; the port calls neither) at the stem's shape and summed over
   the 53 BatchNorm shapes of one training step.  The fused backward
   (``flash_fused_bwd``) likewise at the T 8192 path's [16, 8192, 128] bf16
   causal (bitwise equal run to run), [8, 2048, 128] non-causal, ragged
   T 1000 at D 64 and 32, T 320 and 192 (a last 128-row k group half
   empty), and f32 in and out; timed there against its plain version,
   SDPA's backward and the split pair at the same shape, with the bytes of
   its f32 dq workspace a call (``fused_dq_workspace_bytes``).  Then
   the parity gate (the port's twin of ``tools/flash_parity.py``, all three
   of the reference's cases): fused against split and dense gradients, and
   bitwise determinism; the run fails unless ``parity_ok``.
3. Serve end to end at full width: the flagship transformer (vocab 32000,
   dim 1024, 12 layers, 8 heads, T 2048, bf16), random weights drawn on
   the card by the JAX init's own keys and initialisers (``init_numpy``:
   the JAX package's weights for seed 0), published to a model registry,
   served by the port's registry-pinned replica (``host_serve_task``,
   ``attention="auto"``, ``max_batch=2``, and the KV-cache decode path:
   ``decode_slots=4``, ``decode_max_len=2048``).  Predict first: one-row
   predicts from the port's ``ServeClient``, two of them concurrently.
   Every answer must be finite logits [1, 2048, 32000] with the published
   step and version stamps; the flash forward must have run 12 times per
   apply, every time on its tensor-core kernel (``TENSOR_CORE_LAUNCHES``,
   as in phases 4 and 6); one answer must match an ``attention="xla"``
   apply of the same weights on the card.  One padded apply is timed
   (flash and xla attention) and profiled once: device busy against the
   host's time.  Then decode on the same replica: five sessions, each a
   16-token prompt from the synthetic corpus and 64 greedy tokens, first
   each alone, then all five at once (four slots, one queued), then four
   at once, from clients in a process of their own (``decode_clients``);
   every session's tokens must equal its solo run byte for byte,
   and no flash kernel may launch during decode.  One session is decoded
   again by the same step function on the card, position by position:
   its tokens must equal the served ones, its logits at every position
   must lie within ``TOL_LOGITS`` of the replica's flash-forward predict of
   the same tokens, and the greedy tokens must agree wherever the top-2
   margin exceeds that tolerance.  Printed: the init's seconds, the KV
   cache's bytes, ms per engine step with 1 and 4 active sessions, decode
   tokens/s, the client's time to first token, and one engine step under
   ``torch.profiler``.
4. Train end to end at full width: the same flagship, batch 8 x T 2048,
   through the port's training job (``examples.transformer_lm``'s
   ``run_training``: ``Experiment`` over the synthetic ``text_corpus``,
   ``attention="auto"``, clip 1.0 + AdamW 1e-3) for ``TRAIN_STEPS`` steps,
   publishing the trained weights to a registry.  The loss must start
   near ln(32000), stay finite and fall; the forward, dq and dk/dv
   kernels must each have run 12 times per step, every time on its
   tensor-core kernel; the published version
   must hold the trained parameters bit for bit; and one step's loss and
   gradients from the initial weights on the first batch must match an
   ``attention="xla"`` step.  Last, one step under ``torch.profiler``
   gives the step's device time by kernel family and the idle share.
5. Train ResNet-50 end to end at full width: 224 x 224, 1000 classes,
   batch 256, bf16 compute, SGD momentum 0.9 at lr 0.1 (the example's
   stepwise decay), l2 1e-4, on ``imagenet_synthetic`` (2048 train images,
   the example's default: no cut), through ``examples.resnet50``'s
   ``run_training`` with the fused statistics path switched on
   (``loss_fn_factory=lambda mesh: resnet.loss_fn(cfg, mesh=mesh)``) for
   ``RESNET_STEPS`` steps.  Loss finite, step 1 within
   ``TOL_RESNET_START`` (1.0) of ln(1000) plus the l2 term of the initial
   weights, falling; 53 launches of each
   BN kernel in every step and none in the eval; running stats moved.
   One step from the same weights and batch through the fused path and
   the plain-torch BatchNorm (float32, batch 64) must agree in loss and
   per-leaf gradients, and the fused path may be no further than the
   plain one from a float64 step.  Last, one bf16 step under
   ``torch.profiler``.
6. Train the flagship at T 8192 (the reference's ``bench_t8192_fused``:
   vocab 32000, dim 1024, 12 layers, 8 heads, batch 2, bf16) through
   ``run_training`` for ``TRAIN_STEPS`` steps with ``DTX_FUSED_BWD=1`` set
   for this phase only, as the reference opts in; its default 1024 blocks
   give nq = nk = 8, so every attention backward takes the fused kernel.
   Loss finite, within 0.5 of ln(32000) at step 1, falling; in every step
   12 launches of ``flash_fused_bwd`` and ``flash_fwd`` and none of
   ``flash_dq``/``flash_dkv``.  One step from the initial weights on the
   first batch must match the split path's (``DTX_FUSED_BWD=0``) in loss
   and per-leaf gradients; the whole step is timed fused against split
   in turns; every flash launch of that comparison and of the turns must
   have taken its tensor-core kernel.  Last, one step under
   ``torch.profiler``.

7. Train the four remaining reference workloads on the card through
   their CLIs' ``run_training`` at the CLIs' default widths and batch
   (MNIST MLP 784-128-128-10 at batch 128; CIFAR-10 CNN, 5x5 convs 64/64
   and dense 384/192 at batch 128; word2vec, vocab 10000, dim 128, 64
   sampled, NCE, at batch 256; PTB LSTM, vocab 10000, width 200, 2
   layers, 64 x 20), ``WORKLOAD_STEPS`` steps each on their synthetic
   data at ``--seed=0``.  Each must print its FINAL line, log only finite
   losses, launch none of the port's hand kernels (the JAX package
   computes these models with no Pallas kernel), and start where the same
   CLI's first step on the CPU starts (``TOL_WORKLOAD_START``);
   word2vec's step-1 negatives drawn on the card must equal the CPU's.
   Printed: the median step's ms and examples/s, and one step under
   ``torch.profiler``: kernel launches, device-busy ms and the idle share.

8. Train W1 and W2 on the in-process PS emulation (``--worker_hosts=a:1,b:1``:
   2 worker threads of local batch 64 sharing the card, the parameters on
   the host, the port's native accumulator/token/gradient-queue service
   between them) through the CLIs' ``run_training`` at their defaults,
   ``PS_STEPS`` applied steps each: MNIST MLP ``--ps_emulation``
   (sync_replicas, 2 gradients an apply), CIFAR-10 CNN
   ``--sync_replicas=false --max_staleness=4`` (async, free running), and
   the same with ``--deterministic`` twice (the fixed interleave, under
   ``utils.determinism``).  Each must print the JAX PS FINAL line (its
   ``mode``, ``step=200``, ``stale_dropped``), log only finite losses and
   launch no hand kernel; every sync take must average 2 gradients; the two
   deterministic runs must end with bitwise-equal parameters; each W1
   worker's first gradient at step 0 and the deterministic run's first 4
   applied losses must be within ``TOL_WORKLOAD_START`` of the CPU's
   (the same weights and batches; the same CLI on the CPU).  Printed,
   over applies 21-200 (``PS_WARMUP_APPLIES``): applied steps/s, examples/s
   per chip, the time of an applied step split
   into worker gradient, D2H flatten, native apply/push, the chief's
   take/pop wait and the apply with its H2D publish (summed over threads),
   the bytes an apply moves, and a second run of ``PS_PROFILE_APPLIES``
   applies wholly under ``torch.profiler`` (started before the worker
   threads and stopped after they are joined): launches and device-busy
   ms an apply, idle share.
   ``chip_smoke.ps_emulation_end_to_end(card)`` runs this phase alone.

9. Synchronous data parallelism on the card: every rank a process of the
   port's ``utils.multiprocess.MultiProcessRunner`` (``TF_CONFIG`` per
   task, as a reference launcher gives it), the phase's functions
   (``dp_resnet_rank``, ``dp_lstm_rank``) run in the ranks.  First the
   ResNet step on a world of one rank with NCCL (a real communicator;
   ``DP_NCCL_STEPS`` steps), its step ms beside phase 5's; beside its
   start-up a probe: two ranks start NCCL on the one card (NCCL's own
   error, printed, is why ranks that share a card take gloo;
   ``parallel/dist.py::backend_for``).  Then ResNet-50 (W3) at full
   width, as in phase 5 with the fused
   statistics path, on ``DP_RANKS`` ranks sharing the card through
   ``examples.resnet50``'s ``run_training``: global batch 256 (128 a rank),
   ``RESNET_STEPS`` steps, ``DP_EXAMPLES`` synthetic train images.  Gates:
   every rank's backend gloo on a CUDA device; 53 launches of each BN
   kernel a step on each rank and none in the eval; the FINAL line from
   the chief alone; bitwise-equal parameters and running stats on the
   ranks at the end; step 1's loss finite and within ``TOL_RESNET_START``
   of ln(1000) + l2 (phase 5's beside it) and falling; and one float32
   step from the initial weights at batch 64 (32 a rank) against a 1-rank
   step over the global batch (rank 0's rows, then rank 1's), within
   ``TOL_RESNET_LOSS``, ``TOL_RESNET_HEAD`` and ``TOL_DP_VS_NOISE`` times
   the float32 noise floor (the 1-rank step on the batch reversed), BN
   scale and bias included.  Printed: step ms, global images/s, the
   all-reduce calls and bytes of a step by kind (gradients, SyncBN
   partials, metrics) and each rank's profiled step (device busy, idle).
   Last, the PTB LSTM (W5) at its CLI defaults on ``DP_RANKS`` ranks (32
   rows a rank, each a contiguous block of the stream and its own carry),
   ``WORKLOAD_STEPS`` steps: gloo, bitwise-equal parameters, finite
   losses, FINAL with ``valid_perplexity`` from the chief, and the first
   update against a 1-rank step over the global rows (the clip on the
   global gradient; float32, the clip engaged) within
   ``TOL_DP_LSTM_UPDATE``; step ms and tokens/s.
   ``chip_smoke.data_parallel_end_to_end(card, phase5)`` runs this phase
   alone.

Phase 4 still runs the split kernels: at T 2048 the blocks give
nq = nk = 2, under the fused regime.  No path is cut in depth.

The line before the last is the kernels' JSON record (the four kernels
with a tensor-core instance carry its launches on the main paths and its
SASS tensor-core instruction count, and the forward its times at the
three shapes); the last line is
``{"ok": true, "device": {...}}``.  The run needs one card; it exits
non-zero without one, and without the repository beside it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12
#: Kernel vs plain version, same inputs, same arithmetic in another order:
#: a bf16 output may land one bf16 step away (2^-7 at |o| in [1, 2)) and a
#: p on the other side of a bf16 rounding boundary moves o by 2^-8 * p * |v|;
#: float32 outputs differ by summation order only; lse is float32 throughout.
TOL_O = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
TOL_LSE = 1e-3
#: Flash kernel vs plain mha, 12 bf16 layers at full width: the two round
#: the attention output differently in every layer; 2^-3 is four bf16 steps
#: at |logit| in [2, 4).  (A CPU run of the same comparison at dim 1024,
#: T 1024 differed by at most 0.025.)
TOL_LOGITS = 0.125
#: Phase 3's decode: sessions of a 16-token prompt and 64 new tokens, on a
#: replica of 4 slots of the flagship's 2048 positions.
DECODE_SESSIONS = 5
DECODE_PROMPT = 16
DECODE_NEW = 64
DECODE_SLOTS = 4
#: Backward kernels vs plain versions, relative to the largest entry of the
#: plain output: bf16 outputs two bf16 steps (2^-8 relative each; p and ds
#: also round to bf16 inside the products, and a value on the other side
#: of a rounding boundary moves one term by 2^-8 of itself); float32 the
#: summation order only.
TOL_BWD = {torch.bfloat16: 8e-3, torch.float32: 2e-5}
#: The full-width training phases (T 2048 in phase 4, T 8192 in phase 6).
TRAIN_STEPS = 6
TRAIN_BATCH = 8
LONG_T = 8192
LONG_BATCH = 2
#: Flash step vs xla step from the same weights and batch, bf16 at full
#: width: the two round attention differently (p to bf16 inside the kernel,
#: the softmax output to bf16 in mha).  On an H100 (700 W) it gave a
#: loss gap of 1.2e-5 and per-leaf gradient errors up to 2.6e-3; the bounds
#: leave room for other cards' summation orders.  A kernel fault (a mask,
#: a scale, a cast) moves gradients by O(1).
TOL_TRAIN_LOSS = 1e-2
TOL_TRAIN_GRAD = 3e-2
#: BN statistics kernels vs their plain versions: both sum f32 values in
#: another order; each sum's error is below (terms added one after another)
#: x 2^-24 x the sum of the terms' magnitudes, and no term here passes
#: through more than ~1,200 serial additions (3,041 rows of a stem block over
#: 32 row lanes, then 32 lanes, then 1,056 partials in 8 lanes), so 1e-4 of
#: sum|x|, sum x^2, sum|do| and sum|do*xhat| per channel.  A fault (a
#: dropped row, a wrong channel, a missed mask) is O(1) of that.
TOL_BN = 1e-4
#: The full-width ResNet-50 training phase.
RESNET_STEPS = 6
RESNET_BATCH = 256
RESNET_IMAGE = 224
#: Fused-statistics step vs plain-torch BatchNorm step from the same
#: weights and batch, in float32 (TF32 off) at batch 64: the same math,
#: sums in another order and the backward's dx from the closed form instead
#: of autodiff through the statistics.  The loss agrees to f32 rounding.
#: The gradients of the full network at this size do not: a BatchNorm's
#: upstream gradient is nearly zero-mean per channel (the next BatchNorm
#: took its mean out and the conv carried that through), so the BN
#: scale/bias gradients and what flows below them are small sums of
#: ~10^5-10^6 terms that cancel, and f32 resolves them to a few percent.
#: On an H100 (700 W) both paths sat 2.4% and 2.7% (median per leaf; max
#: 3.1% and 3.7%) from a run with float64 convolutions, and 2.6% (max 3.5%)
#: from each other, while the head's gradient agreed to 3e-5; each path
#: repeated itself bit for bit under cudnn.deterministic.  At the test
#: suite's tiny size the two agree to 1e-5.  So the gate is relative: the
#: fused path may be no further from a float64 step (f32 BN statistics,
#: everything else in f64) than the plain path is.  A kernel fault (a
#: dropped mask, a wrong sum) moves the BN gradients by O(1).  (In bf16 the plain path's
#: BatchNorm gradients carry rounding of 10-40% of their size — the JAX
#: package's own bf16 gradients differ that much from its f32 ones — so
#: bf16 is reported, not gated.)
RESNET_CMP_BATCH = 64
TOL_RESNET_LOSS = 1e-3
TOL_RESNET_GRAD = 0.1
TOL_RESNET_HEAD = 1e-3
#: The fused path's distance from a float64 step (median and max over the
#: leaves) may be at most this multiple of the plain path's.
TOL_RESNET_VS_F64 = 1.5
#: Step 1's loss against ln(1000) + the l2 term of the initial weights.
#: That sum assumes uniform logits; the random glorot head over 2048
#: post-ReLU features gives logits of std ~1.2, which adds ~sigma^2 / 2 ~ 0.7
#: to the cross-entropy (the JAX init's scales, so the JAX model starts
#: there too; measured on an H100: 0.79).  A broken forward is off by far
#: more, or not finite.
TOL_RESNET_START = 1.0
#: Phase 7: the four reference workloads through their CLIs at the CLI's
#: default widths and batch, ``WORKLOAD_STEPS`` steps each (the median step
#: is over steps 2 on, the profiled step left out).
WORKLOAD_STEPS = 200
WORKLOADS = ("mnist_mlp", "cifar10_cnn", "word2vec", "ptb_lstm")
#: Step 1's loss on the card against the same CLI's step 1 on the CPU, same
#: seed.  The bf16 workloads (MLP, CNN, LSTM) round their bf16 products and
#: activations apart on the two (cuBLAS/cuDNN and oneDNN sum in other
#: orders; one bf16 step is 2^-8 relative): on an H100 (700 W) the gaps
#: were 2.4e-7 (MLP), 1.6e-5 (CNN) and 9.5e-7 (LSTM) at cross-entropies of
#: 2.3-9.2.  word2vec is float32 (TF32 off): 7e-8 relative (loss 221.2).  A
#: wrong weight, batch, key or dtype moves the loss by O(0.1).
TOL_WORKLOAD_START = {"mnist_mlp": 1e-3, "cifar10_cnn": 1e-3, "ptb_lstm": 1e-3}
TOL_WORKLOAD_START_REL = {"word2vec": 1e-6}
#: Phase 8: the PS emulation through the MNIST and CIFAR-10 CLIs at their
#: defaults, 2 workers (local batch 64), ``PS_STEPS`` applied steps each,
#: then a run of ``PS_PROFILE_APPLIES`` applies under ``torch.profiler``.
#: The card-against-CPU gates reuse ``TOL_WORKLOAD_START`` (bf16 models).
PS_STEPS = 200
PS_WORKERS = "a:1,b:1"
PS_PROFILE_APPLIES = 10
#: The first applies of a run load kernels and build cuDNN plans (~2 s in
#: a fresh process on an H100 80GB HBM3 at 700 W); the timed window starts
#: after them.
PS_WARMUP_APPLIES = 20
#: Phase 9: data parallelism on the card.  ``DP_RANKS`` ranks share the one
#: card (gloo); each generates the synthetic ImageNet train split itself,
#: cut to ``DP_EXAMPLES`` images (the CLI's default is 2048; the images are
#: not cut) so two processes do not spend the phase making 2.4 GB of data;
#: step ``DP_PROFILE_STEP`` of each rank is profiled.  The NCCL run (a world
#: of one) takes ``DP_NCCL_STEPS`` steps, the last profiled.
DP_RANKS = 2
DP_EXAMPLES = 512
DP_PROFILE_STEP = 4
DP_NCCL_STEPS = 6
#: 2-rank step vs 1-rank step over the same global batch, float32 at batch
#: 64.  The two compute the same function (in float64 everywhere, BN
#: statistics too, they agreed on the CPU to 2e-15 in the loss and 5e-7 in
#: the gradients, the float32 bucket's rounding), but float32 does not
#: resolve ResNet-50's gradients at init (phase 5's note): BN statistics
#: and weight gradients summed in another order move them by percents.  The
#: noise floor is measured in the same run: the 1-rank step on the batch
#: in reverse order (the same function, every batch sum in another order;
#: on the CPU at 64 x 64, batch 8, it moved the gradients by 1.5% median,
#: 2.3% max, and the 2-rank step by 0.8% and 1.6%).  The 2-rank step may
#: be at most ``TOL_DP_VS_NOISE`` times that far from the 1-rank step (or
#: phase 5's ``TOL_RESNET_GRAD``, where the floor is smaller); the loss
#: within ``TOL_RESNET_LOSS`` and the head within ``TOL_RESNET_HEAD``, as
#: in phase 5.  A sum where a mean belongs, local BN statistics or a
#: dropped all-reduce move the loss or the gradients by O(1).
TOL_DP_VS_NOISE = 2.0
#: W5's clip check: one float32 step from the initial weights with the
#: clip at ``DP_LSTM_CLIP`` (below the global gradient's norm, ~0.18 at the
#: CLI's defaults, so the clip scales the step), 2 ranks against 1 rank
#: over the global rows; relative per leaf.  The two sum the batch in
#: another order (two partial gradients, then the all-reduce), and the
#: smallest leaves cancel across the rows, so float32 gives ~1e-6 where
#: bf16 gave 5% (the two ranks' bf16 gradient partials each rounded).  A
#: clip of the local gradient, or a summed gradient, is off by O(1).
DP_LSTM_CLIP = 0.05
TOL_DP_LSTM_UPDATE = 1e-4
#: Device rows of a profile that are the profiler's own markers, not work.
CUPTI_MARKERS = ("Command Buffer Full", "Activity Buffer Request")
#: The port's flash kernels in an LM step's profile, by kernel name.
FLASH_FAMILIES = ("flash_fwd", "flash_dq", "flash_dkv", "flash_fused_bwd", "fused_dq_reduce")
#: Kernel families of a training step's profile, by substrings of the
#: kernel name (after the flash kernels).
KERNEL_FAMILIES = (
    ("optimizer", ("adam", "multi_tensor_apply")),
    ("matmul", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
    ("reduce", ("reduce", "norm", "softmax", "logsumexp")),
    ("copy/cast", ("copy", "memcpy", "memset", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


_TYPES = {"13__nv_bfloat16S1_": "bf16->bf16", "13__nv_bfloat16f": "bf16->f32",
          "f13__nv_bfloat16": "f32->bf16", "ff": "f32->f32"}


def _kernel_instance(mangled: str) -> str:
    """A readable name for a mangled kernel instance of the port's sources."""
    import re

    bn = re.search(r"(bn_(?:bwd_)?stats_(?:partial|finalize))", mangled)
    if bn:
        vec = re.search(r"Li(\d+)E", mangled)
        relu = re.search(r"Lb(\d)E", mangled)
        if bn.group(1).endswith("finalize"):
            return bn.group(1)
        dtype = "bf16" if "bfloat16" in mangled else "f32"
        return (f"{bn.group(1)}<{dtype}, VEC={vec.group(1) if vec else '?'}"
                + (f", RELU={relu.group(1)}>" if relu else ">"))
    if "fused_dq_reduce_kernel" in mangled:
        return f"fused_dq_reduce_kernel<{'bf16' if 'bfloat16' in mangled else 'f32'}>"
    kernel = re.search(r"(flash_(?:fwd|dq|dkv|fused_bwd)(?:_tc)?_kernel)I", mangled)
    d = re.search(r"Li(\d+)E", mangled)
    if "_tc_kernelI" in mangled:  # bf16 in and out; the template names only D
        types = "bf16->bf16"
    else:
        types = next((v for k, v in _TYPES.items()
                      if re.search(r"_kernelI" + re.escape(k), mangled)), "?")
    return f"{kernel.group(1) if kernel else mangled}<{types}, D={d.group(1) if d else '?'}>"


def ptxas_report(log_text: str) -> list[str]:
    """One line per kernel instance from nvcc's ``-Xptxas -v`` log: its
    registers and spills."""
    import re

    out, name, spill = [], None, ""
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_instance(m.group(1))
            continue
        if "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers; {spill}")
            name, spill = None, ""
    return out


def spills(report_line: str) -> bool:
    """Whether a :func:`ptxas_report` line shows spill stores or loads."""
    import re

    return any(int(n) for n in re.findall(r"(\d+) bytes spill", report_line))


def tensor_core_counts(library: Path) -> dict[str, int]:
    """Tensor-core instructions (``HMMA``, ``HGMMA``) in the SASS of each
    kernel instance of a built library, from ``cuobjdump -sass``."""
    import os
    import re

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        raise SystemExit("cuobjdump not found: the tensor-core check needs the CUDA toolkit's")
    sass = subprocess.run([exe, "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts: dict = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _kernel_instance(m.group(1))
            counts[name] = 0
        elif name and re.search(r"\bHG?MMA\.", line):
            counts[name] += 1
    return counts


#: The libraries with tensor-core kernels (bf16 in and out) beside their
#: CUDA-core ones, and the kernels (launch names; ``<name>_tc_kernel`` in
#: the source) each holds.
TENSOR_CORE_LIBRARIES = {
    "flash_fwd": ("flash_fwd",),
    "flash_bwd": ("flash_dq", "flash_dkv"),
    "flash_fused_bwd": ("flash_fused_bwd",),
}
TENSOR_CORE_KERNELS = tuple(k for ks in TENSOR_CORE_LIBRARIES.values() for k in ks)


def check_build(_build, sources) -> dict:
    """Each kernel instance's registers and spills (``-Xptxas -v``), and the
    tensor-core instructions in the SASS of the tensor-core kernels;
    fails when a tensor-core kernel's report is missing, lacks a head dim,
    shows a spill, or its SASS has no tensor-core instruction.  Returns
    the tensor-core instruction count of each tensor-core kernel, summed
    over its head dims."""
    for name in sources:
        ptxas = Path(str(_build.library_path(name)) + ".log")
        if not ptxas.exists():
            if name in TENSOR_CORE_LIBRARIES:
                raise SystemExit(f"no ptxas report beside {_build.library_path(name)}: "
                                 "delete the library to rebuild it")
            continue
        report = ptxas_report(ptxas.read_text())
        for line in report:
            log(f"  ptxas: {line}")
            if "_tc_kernel" in line and spills(line):
                raise SystemExit(f"a tensor-core kernel spills registers: {line}")
        for kernel in TENSOR_CORE_LIBRARIES.get(name, ()):
            for d in (32, 64, 128):
                if not any(ln.startswith(f"{kernel}_tc_kernel<") and f"D={d}>" in ln
                           for ln in report):
                    raise SystemExit(f"{name}: no ptxas line for {kernel}_tc_kernel at D {d}")
    totals = {}
    for name, kernels in TENSOR_CORE_LIBRARIES.items():
        counts = {k: n for k, n in tensor_core_counts(_build.library_path(name)).items()
                  if "_tc_kernel" in k}
        log(f"  SASS tensor-core instructions (HMMA/HGMMA) in lib{name}: "
            + ", ".join(f"{k} {n}" for k, n in sorted(counts.items())))
        for kernel in kernels:
            mine = [n for k, n in counts.items() if k.startswith(f"{kernel}_tc_kernel<")]
            if len(mine) != 3 or min(mine) == 0:
                raise SystemExit(f"{name}: an instance of {kernel}_tc_kernel is missing or has "
                                 "no tensor-core instruction")
            totals[kernel] = sum(mine)
    return totals


def check_routes(flash) -> None:
    """The built libraries take the tensor-core kernel for bf16 in and out
    only, with the (q rows, k rows) tiles the plain versions walk
    (``FWD_BLOCK_Q``/``_K``, ``DQ_BLOCK_Q``/``_K``, ``DKV_BLOCK_Q``/
    ``DKV_GROUP_K``, ``FUSED_BLOCK_Q``/``FUSED_GROUP_K``), and the
    CUDA-core kernel with 64-row tiles (``BLOCK``) for any f32 side."""
    bf16, f32 = torch.bfloat16, torch.float32
    tc_tiles = {
        "flash_fwd": (flash.FWD_BLOCK_Q, flash.FWD_BLOCK_K),
        "flash_dq": (flash.DQ_BLOCK_Q, flash.DQ_BLOCK_K),
        "flash_dkv": (flash.DKV_BLOCK_Q, flash.DKV_GROUP_K),
        "flash_fused_bwd": (flash.FUSED_BLOCK_Q, flash.FUSED_GROUP_K),
    }
    want = {(name, bf16, bf16): (True, tiles) for name, tiles in tc_tiles.items()}
    for name in TENSOR_CORE_KERNELS:
        for pair in ((bf16, f32), (f32, f32), (f32, bf16)):
            want[(name, *pair)] = (False, (flash.BLOCK, flash.BLOCK))
    for key, route in want.items():
        got = flash.kernel_route(*key)
        if got != route:
            raise SystemExit(f"{key[0]} {key[1]} -> {key[2]}: the library reports "
                             f"(tensor cores, tiles) {got}, the plain version walks {route}")
    log("  routes: bf16 in and out -> tensor-core kernels (tiles "
        + ", ".join(f"{k} {v}" for k, v in tc_tiles.items())
        + "), any f32 side -> CUDA-core kernels, as the plain versions walk them")


def require_tensor_cores(path: str, launches: dict, tc_launches: dict) -> None:
    """Fails unless every launch of a kernel with a tensor-core instance
    took that instance on ``path``: an f32 side slipping onto a bf16 path
    would run the CUDA-core kernel, ~10x slower, at the same launch count."""
    for name in TENSOR_CORE_KERNELS:
        n, tc = launches.get(name, 0), tc_launches.get(name, 0)
        if tc != n:
            raise SystemExit(f"the {path} path launched {name} {n} times, {tc} of them "
                             "on its tensor-core kernel")
    log(f"  tensor-core launches ({path}): " + ", ".join(
        f"{k} {tc_launches.get(k, 0)} of {launches.get(k, 0)}" for k in TENSOR_CORE_KERNELS))


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time of one call, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_flops(bh: int, t: int, d: int, causal: bool, products: int = 2) -> int:
    """Operations of ``products`` [T, D]-by-pair matrix products over the
    (causal: visible) score pairs."""
    pairs = t * (t + 1) // 2 if causal else t * t
    return products * 2 * bh * pairs * d


def flash_bound_ms(
    bh: int, t: int, d: int, dtype, causal: bool, *,
    products: int = 2, tiles_in: int = 3, tiles_out: int = 1,
    rows_in: int = 0, rows_out: int = 1,
) -> tuple[float, str]:
    """The least time for a flash function on these inputs: ``products``
    [T, D]-by-pair matrix products over the (causal: visible) score pairs
    at the dtype's peak, against ``tiles_in`` [BH, T, D] tensors read once,
    ``tiles_out`` written once, and ``rows_in``/``rows_out`` f32 [BH, T]
    rows (lse, delta) at the memory rate.  Forward: q.k^T and p.v, q/k/v
    in, o and lse out.  dq: q.k^T, do.v^T and ds.k.  dk/dv: q.k^T, do.v^T,
    p^T.do and ds^T.q.  Both read q, k, v, do, lse and delta."""
    flops = flash_flops(bh, t, d, causal, products)
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (tiles_in + tiles_out) * bh * t * d * esize + (rows_in + rows_out) * bh * t * 4
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


#: The backward kernels' work, for :func:`flash_bound_ms`.
BWD_WORK = {
    "flash_dq": dict(products=3, tiles_in=4, tiles_out=1, rows_in=2, rows_out=0),
    "flash_dkv": dict(products=4, tiles_in=4, tiles_out=2, rows_in=2, rows_out=0),
    # q.k^T, do.v^T, p^T.do, ds^T.q and ds.k once per pair; dq, dk, dv out.
    "flash_fused_bwd": dict(products=5, tiles_in=4, tiles_out=3, rows_in=2, rows_out=0),
}


def check_flash(flash, bh, t, d, dtype, causal, out_dtype=None) -> float:
    """Kernel vs plain version on one input; returns the max abs error of o."""
    g = torch.Generator(device="cuda").manual_seed(bh * 7919 + t * 31 + d)
    q, k, v = (
        torch.randn(bh, t, d, device="cuda", dtype=torch.float32, generator=g).to(dtype)
        for _ in range(3)
    )
    o, lse = flash.fwd_call(q, k, v, causal=causal, out_dtype=out_dtype)
    torch.cuda.synchronize()
    po, plse = flash.fwd_plain(q, k, v, causal=causal, out_dtype=out_dtype)
    err_o = (o.float() - po.float()).abs().max().item()
    err_lse = (lse - plse).abs().max().item()
    tol = TOL_O[out_dtype or dtype]
    log(
        f"  flash_fwd [{bh}, {t}, {d}] {str(dtype)[6:]}->{str(out_dtype or dtype)[6:]} "
        f"causal={causal}: max|o - plain| = {err_o:.3e} (tol {tol:g}), "
        f"max|lse - plain| = {err_lse:.3e} (tol {TOL_LSE:g})"
    )
    if not (math.isfinite(err_o) and err_o <= tol and err_lse <= TOL_LSE):
        raise SystemExit(f"flash_fwd disagrees with its plain version at [{bh}, {t}, {d}]")
    return err_o


def time_flash(flash, bh, t, d, dtype, causal) -> dict:
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (
        torch.randn(bh, t, d, device="cuda", generator=g).to(dtype) for _ in range(3)
    )
    ms = time_ms(lambda: flash.fwd_call(q, k, v, causal=causal), iters=20)
    plain_ms = time_ms(lambda: flash.fwd_plain(q, k, v, causal=causal), iters=3, warmup=1)
    q4, k4, v4 = (x.view(1, bh, t, d) for x in (q, k, v))
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal), iters=20
    )
    bound_ms, bound_by = flash_bound_ms(bh, t, d, dtype, causal)
    tflops = flash_flops(bh, t, d, causal) / (ms * 1e-3) / 1e12
    log(
        f"  timing flash_fwd [{bh}, {t}, {d}] {str(dtype)[6:]} causal={causal}: "
        f"kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s), plain {plain_ms:.4f} ms, sdpa "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
    )
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, tflops=tflops)


def _bwd_inputs(flash, bh, t, d, dtype, causal, seed):
    """q, k, v, do on the card and the saved state (lse from the forward
    kernel, delta = rowsum(do*o)) both backward versions take."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (
        torch.randn(bh, t, d, device="cuda", generator=g).to(dtype) for _ in range(4)
    )
    o, lse = flash.fwd_call(q, k, v, causal=causal)
    return q, k, v, do, lse, flash.compute_delta(do, o)


def check_flash_bwd(flash, bh, t, d, dtype, causal, out_dtype=None, determinism=False) -> dict:
    """dq and dk/dv kernels vs their plain versions on one input, held to
    the tolerance relative to the largest plain entry; returns each
    kernel's max absolute error."""
    args = _bwd_inputs(flash, bh, t, d, dtype, causal, seed=bh * 131 + t * 7 + d)
    kw = dict(causal=causal, out_dtype=out_dtype)
    got = (flash.dq_call(*args, **kw), *flash.dkv_call(*args, **kw))
    torch.cuda.synchronize()
    want = (flash.dq_plain(*args, **kw), *flash.dkv_plain(*args, **kw))
    tol = TOL_BWD[out_dtype or dtype]
    rels, abs_errs = [], []
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        if a.dtype != (out_dtype or dtype) or a.shape != b.shape:
            raise SystemExit(f"flash backward {name}: {a.dtype} {tuple(a.shape)}")
        abs_errs.append((a.float() - b.float()).abs().max().item())
        rels.append(abs_errs[-1] / max(b.float().abs().max().item(), 1e-30))
    log(
        f"  flash_dq/flash_dkv [{bh}, {t}, {d}] {str(dtype)[6:]}->"
        f"{str(out_dtype or dtype)[6:]} causal={causal}: max|Δ|/max|plain| "
        f"dq {rels[0]:.3e}, dk {rels[1]:.3e}, dv {rels[2]:.3e} (tol {tol:g})"
    )
    if not all(math.isfinite(r) and r <= tol for r in rels):
        raise SystemExit(f"flash backward disagrees with its plain version at [{bh}, {t}, {d}]")
    if determinism:
        again = (flash.dq_call(*args, **kw), *flash.dkv_call(*args, **kw))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"  flash_dq/flash_dkv second run bitwise equal: {same}")
        if not same:
            raise SystemExit("flash backward kernels are not deterministic run to run")
    return {"flash_dq": abs_errs[0], "flash_dkv": max(abs_errs[1:])}


def time_flash_bwd(flash, bh, t, d, dtype, causal) -> dict:
    """Kernel, plain version, SDPA's backward and the bound for dq and
    dk/dv at one shape."""
    import torch.nn.functional as F

    args = _bwd_inputs(flash, bh, t, d, dtype, causal, seed=2)
    q4, k4, v4 = (x.view(1, bh, t, d).detach().requires_grad_() for x in args[:3])
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
    do4 = args[3].view(1, bh, t, d)
    sdpa_bwd_ms = time_ms(
        lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True), iters=20
    )
    out = {}
    for name, call, plain in (
        ("flash_dq", flash.dq_call, flash.dq_plain),
        ("flash_dkv", flash.dkv_call, flash.dkv_plain),
    ):
        ms = time_ms(lambda: call(*args, causal=causal), iters=20)
        plain_ms = time_ms(lambda: plain(*args, causal=causal), iters=2, warmup=1)
        bound_ms, bound_by = flash_bound_ms(bh, t, d, dtype, causal, **BWD_WORK[name])
        products = BWD_WORK[name]["products"]
        tflops = flash_flops(bh, t, d, causal, products) / (ms * 1e-3) / 1e12
        log(
            f"  timing {name} [{bh}, {t}, {d}] {str(dtype)[6:]} causal={causal}: "
            f"kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s), plain {plain_ms:.4f} ms, sdpa "
            f"backward (dq, dk, dv together) {sdpa_bwd_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by})"
        )
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_bwd_ms,
                         bound_ms=bound_ms, bound_by=bound_by, tflops=tflops)
    return out


def check_fused_bwd(flash, bh, t, d, dtype, causal, out_dtype=None, determinism=False) -> float:
    """The fused backward kernel vs its plain version on one input, each of
    dq, dk, dv held to ``TOL_BWD`` relative to the largest plain entry;
    returns the max absolute error."""
    args = _bwd_inputs(flash, bh, t, d, dtype, causal, seed=bh * 131 + t * 7 + d + 1)
    kw = dict(causal=causal, out_dtype=out_dtype)
    got = flash.fused_bwd_call(*args, **kw)
    torch.cuda.synchronize()
    want = flash.fused_bwd_plain(*args, **kw)
    tol = TOL_BWD[out_dtype or dtype]
    rels, abs_errs = [], []
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        if a.dtype != (out_dtype or dtype) or a.shape != b.shape:
            raise SystemExit(f"fused backward {name}: {a.dtype} {tuple(a.shape)}")
        abs_errs.append((a.float() - b.float()).abs().max().item())
        rels.append(abs_errs[-1] / max(b.float().abs().max().item(), 1e-30))
    del want
    log(
        f"  flash_fused_bwd [{bh}, {t}, {d}] {str(dtype)[6:]}->{str(out_dtype or dtype)[6:]} "
        f"causal={causal} (S = {flash.fused_slices(bh, t)} slices): max|Δ|/max|plain| "
        f"dq {rels[0]:.3e}, dk {rels[1]:.3e}, dv {rels[2]:.3e} (tol {tol:g})"
    )
    if not all(math.isfinite(r) and r <= tol for r in rels):
        raise SystemExit(f"the fused backward disagrees with its plain version at [{bh}, {t}, {d}]")
    if determinism:
        same = all(torch.equal(a, b) for a, b in zip(got, flash.fused_bwd_call(*args, **kw)))
        log(f"  flash_fused_bwd second run bitwise equal: {same}")
        if not same:
            raise SystemExit("the fused backward kernel is not deterministic run to run")
    return max(abs_errs)


def time_fused_bwd(flash, bh, t, d, dtype, causal) -> dict:
    """The fused kernel, its plain version, SDPA's backward and the bound at
    one shape, and the split pair (dq + dk/dv) there for the 7 -> 5
    product trade."""
    import torch.nn.functional as F

    args = _bwd_inputs(flash, bh, t, d, dtype, causal, seed=4)
    q4, k4, v4 = (x.view(1, bh, t, d).detach().requires_grad_() for x in args[:3])
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
    do4 = args[3].view(1, bh, t, d)
    sdpa_bwd_ms = time_ms(
        lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True), iters=10
    )
    del q4, k4, v4, o4
    ms = time_ms(lambda: flash.fused_bwd_call(*args, causal=causal), iters=5, warmup=1)
    dq_ms = time_ms(lambda: flash.dq_call(*args, causal=causal), iters=5, warmup=1)
    dkv_ms = time_ms(lambda: flash.dkv_call(*args, causal=causal), iters=5, warmup=1)
    plain_ms = time_ms(lambda: flash.fused_bwd_plain(*args, causal=causal), iters=1, warmup=1)
    bound_ms, bound_by = flash_bound_ms(bh, t, d, dtype, causal, **BWD_WORK["flash_fused_bwd"])
    split_bound = sum(flash_bound_ms(bh, t, d, dtype, causal, **BWD_WORK[k])[0]
                      for k in ("flash_dq", "flash_dkv"))
    tflops = flash_flops(bh, t, d, causal, products=5) / (ms * 1e-3) / 1e12
    ws_walk, ws_reduce = flash.fused_dq_workspace_bytes(bh, t, d, causal=causal)
    log(
        f"  timing flash_fused_bwd [{bh}, {t}, {d}] {str(dtype)[6:]} causal={causal}: "
        f"kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s), plain {plain_ms:.4f} ms, sdpa "
        f"backward {sdpa_bwd_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); split pair "
        f"at this shape: flash_dq {dq_ms:.4f} + flash_dkv {dkv_ms:.4f} = "
        f"{dq_ms + dkv_ms:.4f} ms (bound {split_bound:.4f} ms)"
    )
    log(
        f"  flash_fused_bwd dq workspace bytes a call: {ws_walk} in the blocks' walk "
        f"({ws_walk / 1e9:.3f} GB; {ws_walk / (ms * 1e-3) / 1e12:.2f} TB/s over the "
        f"kernel's time), {ws_reduce} in the reduction, S = {flash.fused_slices(bh, t)}"
    )
    return dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_bwd_ms, bound_ms=bound_ms,
                bound_by=bound_by, split_dq_ms=dq_ms, split_dkv_ms=dkv_ms, tflops=tflops)


def resnet50_bn_shapes(batch: int, image: int) -> list[tuple[tuple, bool]]:
    """(NHWC shape, relu) of every BatchNorm of one ResNet-50 v1.5 step, in
    the order the forward runs them: the stem, then per bottleneck bn1 and
    bn2 (ReLU), bn3 and, in each stage's first block, bn_proj (no ReLU)."""
    side = image // 2  # after the stride-2 stem
    out = [((batch, side, side, 64), True)]
    side //= 2  # the max-pool
    cin = 64
    for stage, n_blocks in enumerate((3, 4, 6, 3)):
        mid = 64 * 2 ** stage
        for block in range(n_blocks):
            stride = 2 if stage > 0 and block == 0 else 1
            out.append(((batch, side, side, mid), True))
            side //= stride
            out.append(((batch, side, side, mid), True))
            out.append(((batch, side, side, 4 * mid), False))
            if cin != 4 * mid or stride == 2:
                out.append(((batch, side, side, 4 * mid), False))
            cin = 4 * mid
    return out


def bn_bound_ms(shape, dtype, *, backward: bool, relu: bool = False) -> tuple[float, str]:
    """The least time for a BN statistics call: the activation (and, in
    the backward, the upstream gradient) read once plus the (1, C) f32
    vectors in and out, against its f32 operations at the f32 rate (3 an
    element forward: add, multiply, add; backward 5: subtract, multiply,
    add, multiply-add, plus 4 for the ReLU mask: multiply, add, compare,
    multiply)."""
    n = math.prod(shape)
    c = shape[-1]
    esize = torch.tensor([], dtype=dtype).element_size()
    if backward:
        nbytes, ops = 2 * n * esize + 6 * c * 4, (9 if relu else 5) * n
    else:
        nbytes, ops = n * esize + 2 * c * 4, 3 * n
    ops_ms, bytes_ms = ops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _bn_inputs(bn, x, do):
    """mean, inv, scale, bias for the backward statistics of x (eps 1e-5),
    from the plain forward statistics."""
    c = x.shape[-1]
    s, ss = bn.bn_stats_plain(x)
    n = x.numel() // c
    mean = s[0] / n
    inv = torch.rsqrt(torch.clamp(ss[0] / n - mean * mean, min=0.0) + 1e-5)
    scale = torch.linspace(0.5, 1.5, c, device=x.device)
    bias = torch.linspace(-1.0, 1.0, c, device=x.device)
    return mean, inv, scale, bias


def check_bn(bn, shape, dtype, seed: int) -> dict:
    """bn_stats and bn_bwd_stats (relu on and off) vs their plain versions
    on one input, held to ``TOL_BN`` per channel, and bitwise equal on a
    second run; returns each kernel's max absolute error."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(shape, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    do = torch.randn(shape, device="cuda", generator=g).to(dtype)
    c = shape[-1]
    xf = x.float().reshape(-1, c)
    got = bn.bn_stats(x)
    torch.cuda.synchronize()
    want = bn.bn_stats_plain(x)
    scales = (xf.abs().sum(0), (xf * xf).sum(0))
    rel = max((((a - b).abs() / m.clamp_min(1e-30)).max().item()
               for a, b, m in zip(got, want, scales)))
    err = {"bn_stats": max((a - b).abs().max().item() for a, b in zip(got, want))}
    same = all(torch.equal(a, b) for a, b in zip(got, bn.bn_stats(x)))
    mean, inv, scale, bias = _bn_inputs(bn, x, do)
    dof = do.float().reshape(-1, c)
    bscales = (dof.abs().sum(0), (dof * ((xf - mean) * inv)).abs().sum(0))
    brel, err["bn_bwd_stats"] = {}, 0.0
    for relu in (True, False):
        got_b = bn.bn_bwd_stats(do, x, mean, inv, scale, bias, relu=relu)
        torch.cuda.synchronize()
        want_b = bn.bn_bwd_stats_plain(do, x, mean, inv, scale, bias, relu=relu)
        brel[relu] = max((((a - b).abs() / m.clamp_min(1e-30)).max().item()
                          for a, b, m in zip(got_b, want_b, bscales)))
        err["bn_bwd_stats"] = max(err["bn_bwd_stats"],
                                  *((a - b).abs().max().item() for a, b in zip(got_b, want_b)))
        again = bn.bn_bwd_stats(do, x, mean, inv, scale, bias, relu=relu)
        same = same and all(torch.equal(a, b) for a, b in zip(got_b, again))
    log(
        f"  bn_stats/bn_bwd_stats {list(shape)} {str(dtype)[6:]}: max |Δ| / per-channel "
        f"scale: stats {rel:.3e}, bwd relu {brel[True]:.3e}, bwd no relu {brel[False]:.3e} "
        f"(tol {TOL_BN:g}); max |Δ| stats {err['bn_stats']:.3e}, bwd "
        f"{err['bn_bwd_stats']:.3e}; second run bitwise equal: {same}"
    )
    if not all(math.isfinite(r) and r <= TOL_BN for r in (rel, *brel.values())):
        raise SystemExit(f"BN statistics kernels disagree with their plain versions at {shape}")
    if not same:
        raise SystemExit(f"BN statistics kernels are not deterministic run to run at {shape}")
    return err


def time_bn(bn, card: str) -> dict:
    """Each BN kernel, its plain version and its PyTorch yardstick, timed
    with CUDA events at the stem's shape and summed over the 53 BatchNorm
    shapes of one ResNet-50 step at batch ``RESNET_BATCH``, with the bound
    beside each.  The inputs are views of one buffer; a shape that fits the
    50 MB L2 is read warm on repeats."""
    shapes = resnet50_bn_shapes(RESNET_BATCH, RESNET_IMAGE)
    dtype = torch.bfloat16
    biggest = max(math.prod(sh) for sh, _r in shapes)
    g = torch.Generator(device="cuda").manual_seed(3)
    xbuf = (torch.randn(biggest, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    dbuf = torch.randn(biggest, device="cuda", generator=g).to(dtype)
    out = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0) for k in
           ("bn_stats", "bn_bwd_stats")}
    stem = {}
    for i, (shape, relu) in enumerate(shapes):
        n = math.prod(shape)
        x, do = xbuf[:n].view(shape), dbuf[:n].view(shape)
        mean, inv, scale, bias = _bn_inputs(bn, x, do)
        xc, dc = x.permute(0, 3, 1, 2), do.permute(0, 3, 1, 2)  # channels_last NCHW
        lmean, linv = torch.batch_norm_stats(xc, 1e-5)
        row = {
            "bn_stats": (
                time_ms(lambda: bn.bn_stats(x), iters=10),
                time_ms(lambda: bn.bn_stats_plain(x), iters=3, warmup=1),
                time_ms(lambda: torch.batch_norm_stats(xc, 1e-5), iters=10),
                bn_bound_ms(shape, dtype, backward=False),
            ),
            "bn_bwd_stats": (
                time_ms(lambda: bn.bn_bwd_stats(do, x, mean, inv, scale, bias, relu=relu), iters=10),
                time_ms(lambda: bn.bn_bwd_stats_plain(do, x, mean, inv, scale, bias, relu=relu),
                        iters=3, warmup=1),
                # No ReLU mask in the yardstick: it reduces dy as given.
                time_ms(lambda: torch.batch_norm_backward_reduce(
                    dc, xc, lmean, linv, scale, True, True, True), iters=10),
                bn_bound_ms(shape, dtype, backward=True, relu=relu),
            ),
        }
        for k, (ms, plain_ms, lib_ms, (bound_ms, bound_by)) in row.items():
            acc = out[k]
            acc["ms"] += ms
            acc["plain_ms"] += plain_ms
            acc["library_ms"] += lib_ms
            acc["bound_ms"] += bound_ms
            if i == 0:
                stem[k] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=bound_ms, bound_by=bound_by)
    del xbuf, dbuf
    result = {}
    for k in out:
        s0, acc = stem[k], out[k]
        log(
            f"  timing {k} at the stem {list(shapes[0][0])} bf16"
            + (" relu" if k == "bn_bwd_stats" else "")
            + f": kernel {s0['ms']:.4f} ms, plain {s0['plain_ms']:.4f} ms, torch "
            f"{s0['library_ms']:.4f} ms, bound {s0['bound_ms']:.4f} ms ({s0['bound_by']}); "
            f"over the step's {len(shapes)} shapes: kernel {acc['ms']:.3f} ms, plain "
            f"{acc['plain_ms']:.3f} ms, torch {acc['library_ms']:.3f} ms, bound "
            f"{acc['bound_ms']:.3f} ms"
        )
        result[k] = dict(s0, step_ms=acc["ms"], step_plain_ms=acc["plain_ms"],
                         step_library_ms=acc["library_ms"], step_bound_ms=acc["bound_ms"])
    log(f"  [{card}]")
    return result


class StepClock:
    """The replica's decode step, wrapped: the time (``time.monotonic``,
    which every process of the host shares) at which each call starts and
    the seconds it takes to the device's end (the engine copies the
    logits to the host right after, so the wait moves nothing)."""

    def __init__(self, step_fn):
        self.step_fn = step_fn
        self.starts: list[float] = []
        self.seconds: list[float] = []

    def __call__(self, params, cache, tokens, pos):
        t0 = time.monotonic()
        out = self.step_fn(params, cache, tokens, pos)
        torch.cuda.synchronize()
        self.starts.append(t0)
        self.seconds.append(time.monotonic() - t0)
        return out

    def window(self, lo: int, hi: int) -> tuple[list[float], list[float]]:
        """For steps ``lo`` to ``hi``: ms from one step's start to the next
        (the engine's whole step, its bookkeeping included) and ms of the
        step function alone."""
        t = self.starts[lo:hi]
        return ([(b - a) * 1e3 for a, b in zip(t, t[1:])],
                [x * 1e3 for x in self.seconds[lo:hi]])

    def between(self, t0: float, t1: float) -> tuple[int, int]:
        """The steps that started in [t0, t1]."""
        idx = [i for i, t in enumerate(self.starts) if t0 <= t <= t1]
        return (idx[0], idx[-1] + 1) if idx else (0, 0)


def serve_end_to_end(card: str) -> tuple[dict, dict]:
    """Publish, serve, ask, decode and check (the module docstring's phase
    3); returns the kernel launch counts (and tensor-core launch counts) of
    the served predicts, the decode cross-check's included."""
    from distributed_tensorflow_examples_tpu_torch import bridge
    from distributed_tensorflow_examples_tpu_torch.models import transformer
    from distributed_tensorflow_examples_tpu_torch.serve import (
        ModelRegistry, host_serve_task,
    )

    cfg = transformer.Config(
        vocab_size=32000, dim=1024, n_layers=12, n_heads=8,
        max_seq_len=2048, attention="auto",
    )
    t0 = time.perf_counter()
    init = transformer.init_numpy(cfg, SEED)
    init_s = time.perf_counter() - t0
    flat = bridge.flat_params_of(init)
    del init
    registry_dir = ROOT / "build" / "smoke_registry"
    shutil.rmtree(registry_dir, ignore_errors=True)
    step = 4242
    version = ModelRegistry(str(registry_dir)).publish(
        "transformer_lm", flat, step=step, source=f"chip_smoke seed={SEED}"
    )
    log(
        f"  weights: {flat.size} params ({flat.nbytes / 1e9:.3f} GB f32) drawn by the "
        f"JAX init's keys on the card in {init_s:.3f} s, published as "
        f"transformer_lm/v{version} in {time.perf_counter() - t0:.1f} s"
    )

    ready = threading.Event()
    holder: dict = {}
    failure: list = []
    init_cache_fn, step_fn = transformer.serve_decode_fns(cfg)
    clock = StepClock(step_fn)

    def host():
        try:
            host_serve_task(
                param_shapes=transformer.param_shapes(cfg),
                predict_fn=lambda p, b: transformer.apply(cfg, p, b["x"]),
                decode_fns=(init_cache_fn, clock), decode_slots=DECODE_SLOTS,
                decode_max_len=cfg.max_seq_len,
                port=0, device="cuda", max_batch=2,
                registry_dir=str(registry_dir), model_name="transformer_lm",
                model_version=version,
                on_ready=lambda s: (holder.update(server=s), ready.set()),
            )
        except BaseException as e:  # noqa: BLE001 — the main thread reports it
            failure.append(e)
            ready.set()

    server_thread = threading.Thread(target=host, name="serve-task", daemon=True)
    server_thread.start()
    try:
        if not ready.wait(600) or failure:
            raise SystemExit(f"replica did not come up: {failure!r}")
        launches, tc = _ask_and_check(cfg, card, holder["server"], flat, step, version)
        cross, cross_tc = _decode_and_check(cfg, card, holder["server"], flat, clock)
    finally:
        if "server" in holder:
            holder["server"].shutdown_requested.set()
        server_thread.join(120)
        shutil.rmtree(registry_dir, ignore_errors=True)
    if server_thread.is_alive() or failure:
        raise SystemExit(f"serve task did not shut down cleanly: {failure!r}")
    return ({k: launches.get(k, 0) + cross.get(k, 0) for k in {*launches, *cross}},
            {k: tc.get(k, 0) + cross_tc.get(k, 0) for k in {*tc, *cross_tc}})


def _decode_session(client, prompt, record: dict) -> None:
    """One greedy session polled to its end, as ``ServeClient.generate``
    polls it, with its open and end times and the seconds from the open
    to the first token."""
    t0 = time.monotonic()
    sid = client.decode_open(prompt, DECODE_NEW)
    tokens: list[int] = []
    try:
        while True:
            got, done, _step = client.decode_next(sid, cursor=len(tokens))
            if got.size and not tokens:
                record["ttft_s"] = time.monotonic() - t0
            tokens.extend(int(t) for t in got)
            if done:
                break
            time.sleep(0.005)  # ServeClient.generate's poll
    finally:
        client.decode_close(sid)
    record.update(tokens=tokens, t_open=t0, t_end=time.monotonic())


def decode_clients(port: int, together: bool, prompts: list) -> None:
    """The decode sessions' clients, run in a process of their own (see
    :func:`_client_process`): each prompt as a session, one after another
    or all at once (one client and thread each); prints one JSON line of
    the session records and the wall seconds."""
    sys.path.insert(0, str(ROOT))
    from distributed_tensorflow_examples_tpu_torch.serve import ServeClient

    prompts = [np.asarray(p, np.int32) for p in prompts]
    records: list = [{} for _ in prompts]
    clients = [ServeClient("127.0.0.1", port, op_timeout_s=300.0)
               for _ in (prompts if together else prompts[:1])]
    t0 = time.monotonic()
    if together:
        threads = [threading.Thread(target=_decode_session, args=(c, p, r))
                   for c, p, r in zip(clients, prompts, records)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
    else:
        for p, r in zip(prompts, records):
            _decode_session(clients[0], p, r)
    wall = time.monotonic() - t0
    for c in clients:
        c.close()
    print(json.dumps({"wall_s": wall, "sessions": records}))


def _client_process(port: int, together: bool, prompts: list) -> tuple[list, float]:
    """:func:`decode_clients` in a child process, so that the clients'
    polling does not hold this process's interpreter lock, which the
    replica's decode step needs for each of its launches (as a remote
    client would not); returns the session records and the wall seconds."""
    code = (f"import chip_smoke; chip_smoke.decode_clients({port}, {together}, "
            f"{json.dumps([p.tolist() for p in prompts])})")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        raise SystemExit(f"decode clients failed:\n{out.stderr[-4000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    records = got["sessions"]
    if not all("tokens" in r and "ttft_s" in r for r in records):
        raise SystemExit("a decode session did not finish")
    for r in records:
        r["tokens"] = np.asarray(r["tokens"], np.int32)
    return records, got["wall_s"]


def _decode_and_check(cfg, card: str, server, flat, clock: StepClock) -> tuple[dict, dict]:
    """Decode on the replica that served the predicts, and check (the
    module docstring's phase 3); returns the launches of the cross-check's
    served predict."""
    from distributed_tensorflow_examples_tpu_torch import bridge, ops
    from distributed_tensorflow_examples_tpu_torch.data import datasets
    from distributed_tensorflow_examples_tpu_torch.models import transformer
    from distributed_tensorflow_examples_tpu_torch.serve import ServeClient

    ids, _vocab, _src = datasets.text_corpus(
        None, vocab_size=cfg.vocab_size, synth_tokens=DECODE_SESSIONS * DECODE_PROMPT,
        seed=SEED,
    )
    prompts = [np.asarray(ids[i * DECODE_PROMPT:(i + 1) * DECODE_PROMPT], np.int32)
               for i in range(DECODE_SESSIONS)]
    client = ServeClient("127.0.0.1", server.port, op_timeout_s=300.0)
    steps0 = client.stats()["decode_steps"]
    before = _launch_counts(ops)
    # Each session alone (one active slot of four), all five at once (four
    # slots, the fifth queued), then four at once.
    solo_records, _ = _client_process(server.port, False, prompts)
    conc, conc_wall = _client_process(server.port, True, prompts)
    since4 = len(clock.starts)
    four, four_wall = _client_process(server.port, True, prompts[:DECODE_SLOTS])
    decode_launches, _ = _launches_since(ops, before)
    steps = client.stats()["decode_steps"] - steps0
    solo = [r["tokens"] for r in solo_records]
    solo_ms, solo_fn_ms = [], []
    for r in solo_records:
        ms, fn_ms = clock.window(*clock.between(r["t_open"], r["t_end"]))
        solo_ms += ms
        solo_fn_ms += fn_ms
    four_ms, four_fn_ms = clock.window(since4, len(clock.starts))

    for i, want in enumerate(solo):
        if want.shape != (DECODE_NEW,) or not ((0 <= want) & (want < cfg.vocab_size)).all():
            raise SystemExit(f"session {i}: tokens {want.shape} out of the vocabulary")
        for name, runs in (("five at once", conc), ("four at once", four)):
            if i < len(runs) and not np.array_equal(runs[i]["tokens"], want):
                raise SystemExit(f"session {i} {name} differs from its solo run")
    flash_in_decode = sum(decode_launches.get(k, 0) for k in FLASH_FAMILIES)
    log(f"  decode: {DECODE_SESSIONS} sessions of {DECODE_PROMPT} prompt + {DECODE_NEW} "
        f"tokens alone, five and four at once ({steps} engine steps): every session's "
        f"tokens equal its solo run; flash launches during decode {flash_in_decode}")
    if flash_in_decode:
        raise SystemExit("a flash kernel launched during decode")

    # The same session by the same step function, position by position,
    # against the replica's flash-forward predict of the same tokens.
    _total, unflatten = bridge.flat_param_spec(transformer.param_shapes(cfg))
    params = unflatten(flat, "cuda")
    init_cache_fn, step_fn = transformer.serve_decode_fns(cfg)
    seq = np.concatenate([prompts[0], solo[0]])
    n = len(seq) - 1
    with torch.inference_mode():
        cache = init_cache_fn(DECODE_SLOTS, cfg.max_seq_len, "cuda")
        kv_bytes = sum(t.numel() * t.element_size() for c in cache.values() for t in c.values())
        tokens = torch.zeros(DECODE_SLOTS, dtype=torch.int32, device="cuda")
        pos = torch.zeros(DECODE_SLOTS, dtype=torch.int32, device="cuda")
        rows = []
        for p in range(n):
            tokens[0], pos[0] = int(seq[p]), p
            logits, cache = step_fn(params, cache, tokens, pos)
            rows.append(logits[0].float())
        dec = torch.stack(rows).cpu()  # [n, V]: logits at positions 0..n-1
        device_ms = time_ms(lambda: step_fn(params, cache, tokens, pos), iters=20)
        busy_ms, wall_ms, flash_ms, kernels = profile_apply(
            lambda: step_fn(params, cache, tokens, pos))
    greedy = np.argmax(dec[DECODE_PROMPT - 1:].numpy(), axis=-1)
    if not np.array_equal(greedy, solo[0]):
        raise SystemExit("the step function's greedy tokens differ from the served session's")
    x = np.zeros((1, cfg.max_seq_len), np.int32)
    x[0, :len(seq)] = seq  # causal: the padding reads nothing back
    before_x = _launch_counts(ops)
    _step, out = client.predict({"x": x})
    cross, cross_tc = _launches_since(ops, before_x)
    client.close()
    full = out["output"][0, :n].float()
    err = (dec - full).abs().max().item()
    top2 = dec.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > TOL_LOGITS
    agree = (dec.argmax(-1) == full.argmax(-1))
    log(f"  decode logits vs the replica's flash predict over {n} positions: max abs "
        f"{err:.4e} (tol {TOL_LOGITS:g}); greedy agrees at {int(agree[sure].sum())} of "
        f"{int(sure.sum())} positions with a top-2 margin over the tolerance "
        f"({int(agree.sum())} of {n} in all)")
    if not err <= TOL_LOGITS or not bool(agree[sure].all()):
        raise SystemExit("decode logits disagree with the flash forward")
    if cross.get("flash_fwd", 0) != cfg.n_layers:
        raise SystemExit(f"the cross-check predict launched flash_fwd "
                         f"{cross.get('flash_fwd', 0)} times")
    require_tensor_cores("serve (decode cross-check)", cross, cross_tc)

    conc_ttft = [r["ttft_s"] for r in conc]
    ttft = [r["ttft_s"] for r in solo_records]
    tok_s = DECODE_SESSIONS * DECODE_NEW / conc_wall
    four_tok_s = DECODE_SLOTS * DECODE_NEW / four_wall
    log(f"  KV cache: {DECODE_SLOTS} slots x {cfg.max_seq_len} positions x {cfg.n_layers} "
        f"layers x k, v bf16 = {kv_bytes} bytes")
    log(f"  engine step (clients in a process of their own), start to start, median: "
        f"{float(np.median(solo_ms)):.3f} ms with 1 "
        f"active slot, {float(np.median(four_ms)):.3f} ms with 4; of it the step function "
        f"to the device's end {float(np.median(solo_fn_ms)):.3f} and "
        f"{float(np.median(four_fn_ms)):.3f} ms; {device_ms:.3f} ms a step by CUDA events "
        f"over 20 back-to-back steps from the main thread")
    log(f"  decode tokens/s: {tok_s:.0f} for five sessions at once ({conc_wall:.3f} s), "
        f"{four_tok_s:.0f} for four ({four_wall:.3f} s)")
    log(f"  time to first token (client, open to first token, {DECODE_PROMPT}-token prompt): "
        f"p50 {float(np.median(conc_ttft)) * 1e3:.1f} ms with five at once, "
        f"{float(np.median(ttft)) * 1e3:.1f} ms alone")
    log(f"  profiled engine step: host {wall_ms:.3f} ms to the synchronize, device busy "
        f"{busy_ms:.3f} ms (busy share {busy_ms / wall_ms:.1%}, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.1%}) in {kernels} kernel launches; "
        f"flash_fwd {flash_ms:.3f} ms [{card}]")
    del params, cache
    return cross, cross_tc


def profile_apply(apply) -> tuple[float, float, float, int]:
    """One inference call (after a warm-up) under torch.profiler: (device
    busy ms, host ms to the synchronize, ms in the flash forward, kernel
    launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        apply()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            apply()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0
            and e.device_type == DeviceType.CUDA and e.key not in CUPTI_MARKERS]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    flash_ms = sum(e.self_device_time_total for e in rows if "flash_fwd" in e.key) / 1e3
    return busy_ms, wall_ms, flash_ms, sum(e.count for e in rows)


def _ask_and_check(cfg, card: str, server, flat, step: int, version: int) -> dict:
    from distributed_tensorflow_examples_tpu_torch import bridge, ops
    from distributed_tensorflow_examples_tpu_torch.models import transformer
    from distributed_tensorflow_examples_tpu_torch.serve import ServeClient

    t = cfg.max_seq_len
    client = ServeClient("127.0.0.1", server.port, op_timeout_s=300.0)
    side = ServeClient("127.0.0.1", server.port, op_timeout_s=300.0)
    rng = np.random.default_rng(SEED)
    requests = [rng.integers(0, cfg.vocab_size, (1, t), dtype=np.int32) for _ in range(8)]
    answers: list = [None] * len(requests)
    latencies: list = [None] * len(requests)

    def ask(i, c):
        t_req = time.perf_counter()
        answers[i] = c.predict({"x": requests[i]}) + (c.last_model_version,)
        latencies[i] = time.perf_counter() - t_req

    applies0 = server.stats()["applies"]
    ops.reset_launches()  # every count to 0 just before the main path
    t_run = time.perf_counter()
    ask(0, client)
    ask(1, client)
    pair = [threading.Thread(target=ask, args=(2, client)),
            threading.Thread(target=ask, args=(3, side))]
    for th in pair:
        th.start()
    for th in pair:
        th.join(600)
    for i in range(4, len(requests)):
        ask(i, client)
    wall = time.perf_counter() - t_run
    launches = dict(ops.LAUNCHES)  # read just after the main path
    tc_launches = dict(ops.TENSOR_CORE_LAUNCHES)
    stats = client.stats()
    applies = stats["applies"] - applies0
    client.close()
    side.close()

    for i, got in enumerate(answers):
        if got is None:
            raise SystemExit(f"request {i} got no answer")
        a_step, out, a_version = got
        logits = out["output"]
        if tuple(logits.shape) != (1, t, cfg.vocab_size):
            raise SystemExit(f"request {i}: logits shape {tuple(logits.shape)}")
        if a_step != step or a_version != version:
            raise SystemExit(f"request {i}: stamps step={a_step} v={a_version}")
        if not torch.isfinite(logits.float()).all():
            raise SystemExit(f"request {i}: non-finite logits")
    log(f"  {len(requests)} answers: finite, [1, {t}, {cfg.vocab_size}], "
        f"model_step {step}, version {version}")

    # One answer against an attention="xla" apply of the same weights.
    _total, unflatten = bridge.flat_param_spec(transformer.param_shapes(cfg))
    params = unflatten(flat, "cuda")
    xla_cfg = dataclasses.replace(cfg, attention="xla")
    with torch.inference_mode():
        ref = transformer.apply(
            xla_cfg, params, torch.from_numpy(requests[0]).cuda()
        ).float().cpu()
    diff = (answers[0][1]["output"].float() - ref).abs()
    err, mean_err = diff.max().item(), diff.mean().item()
    log(
        f"  logits vs attention=xla apply: max abs {err:.4e} (tol {TOL_LOGITS:g}), "
        f"mean abs {mean_err:.4e}"
    )
    if not err <= TOL_LOGITS:
        raise SystemExit("served logits disagree with the xla-attention apply")

    # Where the time goes: one apply at the replica's padded shape on the
    # device (flash and xla attention), and its logits' copy to the host.
    padded = torch.from_numpy(np.concatenate(requests[:2])).cuda()
    with torch.inference_mode():
        apply_ms = time_ms(lambda: transformer.apply(cfg, params, padded), iters=5)
        xla_ms = time_ms(lambda: transformer.apply(xla_cfg, params, padded), iters=5)
        logits = transformer.apply(cfg, params, padded)
        torch.cuda.synchronize()
        t_copy = time.perf_counter()
        logits[:1].cpu()  # what the replica copies for a lone request
        d2h_ms = (time.perf_counter() - t_copy) * 1e3
    busy_ms, wall_ms, flash_ms, _kernels = profile_apply(
        lambda: transformer.apply(cfg, params, padded))
    del params, logits
    log(
        f"  one padded apply [2, {t}] on the device: {apply_ms:.2f} ms with the "
        f"flash kernel, {xla_ms:.2f} ms with xla attention; one logits row "
        f"[1, {t}, {cfg.vocab_size}] bf16 to the host: {d2h_ms:.1f} ms [{card}]"
    )
    log(
        f"  profiled apply (flash): host {wall_ms:.2f} ms to the synchronize, device busy "
        f"{busy_ms:.2f} ms (idle share {max(0.0, 1 - busy_ms / wall_ms):.1%}), of it "
        f"flash_fwd {flash_ms:.2f} ms"
    )

    want = cfg.n_layers * applies
    log(
        f"  {len(requests)} predicts in {applies} applies; flash_fwd launches "
        f"{launches.get('flash_fwd', 0)} (want {cfg.n_layers} x {applies} = {want})"
    )
    if launches.get("flash_fwd", 0) != want:
        raise SystemExit("the serving path did not run the flash kernel once per layer")
    require_tensor_cores("serve", launches, tc_launches)

    lat = np.asarray(latencies)
    p50_ms = float(np.percentile(lat, 50) * 1e3)
    tokens_per_s = len(requests) * t / wall
    log(
        f"  e2e: p50 predict latency {p50_ms:.1f} ms (client round trip, "
        f"[1, {t}] -> [1, {t}, {cfg.vocab_size}] bf16), "
        f"{tokens_per_s:.0f} tokens/s over {len(requests)} requests "
        f"in {wall:.2f} s; server-side p50 "
        f"{stats.get('serve/latency_p50_ms', float('nan')):.1f} ms [{card}]"
    )
    return launches, tc_launches


def step_clock(kernels):
    """A training hook that records (step, ms, loss, launches of each of
    ``kernels`` in the step) for every step; reading the loss waits for the
    step's device work."""
    from distributed_tensorflow_examples_tpu_torch import ops
    from distributed_tensorflow_examples_tpu_torch.train import hooks

    class StepClock(hooks.Hook):
        def __init__(self):
            self.steps: list = []

        def begin(self, loop):
            torch.cuda.synchronize()
            self._t = time.perf_counter()
            self._launches = dict(ops.LAUNCHES)

        def after_step(self, loop, metrics):
            loss = float(metrics["loss"])
            now = time.perf_counter()
            counts = {k: ops.LAUNCHES[k] - self._launches.get(k, 0) for k in kernels}
            self.steps.append((loop.step, (now - self._t) * 1e3, loss, counts))
            self._t, self._launches = now, dict(ops.LAUNCHES)

    return StepClock()


def profile_lm_step(cfg, init, batch, card: str) -> None:
    """Where an LM step's time goes: one full step (after a warm-up step)
    under torch.profiler, device time summed by kernel family, against the
    host clock around the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from distributed_tensorflow_examples_tpu_torch.models import transformer
    from distributed_tensorflow_examples_tpu_torch.train import optim, state, step

    opt = optim.ClippedAdamW(1e-3, 1.0)
    st = state.create_state(lambda seed: init, opt, SEED, "cuda")
    train_step = step.build_train_step(transformer.loss_fn(cfg), opt)
    st, m = train_step(st, batch)
    float(m["loss"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st, m = train_step(st, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del st, m
    # Only device-side rows: a CPU op's row repeats its kernels' device time,
    # and CUPTI's own markers are not work.
    families: dict = {}
    kernels = []
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us <= 0 or e.device_type != DeviceType.CUDA or e.key in CUPTI_MARKERS:
            continue
        kernels.append((us, e.count, e.key))
        name = e.key.lower()
        fam = next((f for f in FLASH_FAMILIES
                    if f + "_kernel" in name or f + "_tc_kernel" in name), None)
        if fam is None:
            fam = next((f for f, keys in KERNEL_FAMILIES if any(k in name for k in keys)), "other")
        families[fam] = families.get(fam, 0.0) + us / 1e3
    busy_ms = sum(families.values())
    if busy_ms <= 0:
        raise SystemExit("torch.profiler recorded no device time for the profiled step")
    log(
        f"  profiled step: host {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"(idle share {max(0.0, 1 - busy_ms / wall_ms):.1%}); by family: "
        + ", ".join(f"{k} {v:.1f} ms ({v / busy_ms:.1%})"
                    for k, v in sorted(families.items(), key=lambda kv: -kv[1]))
    )
    for us, count, key in sorted(kernels, reverse=True)[:10]:
        log(f"    {us / 1e3:8.2f} ms in {count:4d} launches  {key[:110]}")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")


def train_end_to_end(card: str, kernel_ms: dict) -> dict:
    """Train, check, compare and publish (the module docstring's phase 4);
    returns the kernel launch counts of the main path's run."""
    from distributed_tensorflow_examples_tpu_torch import bridge, ops
    from distributed_tensorflow_examples_tpu_torch.data import datasets
    from distributed_tensorflow_examples_tpu_torch.examples import transformer_lm as cli
    from distributed_tensorflow_examples_tpu_torch.models import transformer
    from distributed_tensorflow_examples_tpu_torch.serve import ModelRegistry
    from distributed_tensorflow_examples_tpu_torch.train import state

    registry_dir = ROOT / "build" / "smoke_train_registry"
    shutil.rmtree(registry_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    t_len = 2048
    args = cli.build_parser().parse_args([
        f"--batch_size={TRAIN_BATCH}", f"--seq_len={t_len}", "--vocab_size=32000",
        "--dim=1024", "--n_layers=12", "--n_heads=8", f"--train_steps={TRAIN_STEPS}",
        "--learning_rate=1e-3", "--log_every_steps=1", f"--seed={SEED}",
        "--attention=auto", f"--registry_dir={registry_dir}", "--device=cuda",
    ])
    cfg = cli.config_from_args(args)
    clock = step_clock(())
    ops.reset_launches()  # every count to 0 just before the main path
    t0 = time.perf_counter()
    exp = cli.run_training(args, extra_hooks=[clock])
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)  # read just after the main path
    tc_launches = dict(ops.TENSOR_CORE_LAUNCHES)
    try:
        losses = [loss for _s, _ms, loss, _c in clock.steps]
        log("  steps: " + ", ".join(
            f"{s}: loss {loss:.4f} in {ms:.1f} ms" for s, ms, loss, _c in clock.steps
        ))
        want = cfg.n_layers * TRAIN_STEPS
        log(
            f"  {TRAIN_STEPS} steps of [{TRAIN_BATCH}, {t_len}] in {wall:.1f} s "
            f"(corpus, init, steps, publish); launches "
            + ", ".join(f"{k} {launches.get(k, 0)}" for k in ("flash_fwd", "flash_dq", "flash_dkv"))
            + f" (want {cfg.n_layers} x {TRAIN_STEPS} = {want} each)"
        )
        if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"training losses not finite: {losses}")
        if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5 or not losses[-1] < losses[0]:
            raise SystemExit(
                f"training loss did not start near ln({cfg.vocab_size}) = "
                f"{math.log(cfg.vocab_size):.3f} and fall: {losses}"
            )
        for k in ("flash_fwd", "flash_dq", "flash_dkv"):
            if launches.get(k, 0) != want:
                raise SystemExit(f"the training path did not run {k} once per layer and step")
        require_tensor_cores("train", launches, tc_launches)

        reg = ModelRegistry(str(registry_dir))
        got_step, flat, _manifest = reg.load("transformer_lm", exp.published_version)
        trained = bridge.flat_params_of(exp.state.params)
        if got_step != TRAIN_STEPS or not np.array_equal(flat, trained):
            raise SystemExit("the published version does not hold the trained parameters")
        log(f"  published transformer_lm/v{exp.published_version} at step {got_step}: "
            f"{flat.size} params round-trip bit for bit")

        step_ms = float(np.median([ms for _s, ms, _l, _c in clock.steps[1:]]))
        tokens_per_s = TRAIN_BATCH * t_len / (step_ms / 1e3)
        per_layer = {k: kernel_ms[k] for k in ("flash_fwd", "flash_dq", "flash_dkv")}
        kernel_step_ms = cfg.n_layers * sum(per_layer.values())
        log(
            f"  e2e: step {step_ms:.1f} ms (median of steps 2-{TRAIN_STEPS}, host clock "
            f"to the loss read), {tokens_per_s:.0f} tokens/s; the flash kernels' "
            f"share of a step {kernel_step_ms / step_ms:.1%} ({cfg.n_layers} x ("
            + " + ".join(f"{k} {v:.3f}" for k, v in per_layer.items())
            + f") = {kernel_step_ms:.1f} ms at [{TRAIN_BATCH * cfg.n_heads}, {t_len}, "
            f"{cfg.head_dim}], CUDA events) [{card}]"
        )
    finally:
        shutil.rmtree(registry_dir, ignore_errors=True)
    del exp

    # One step's loss and gradients from the initial weights on the first
    # batch: the flash kernels against plain mha (attention="xla").
    ids, _vocab, _src = datasets.text_corpus(
        None, vocab_size=cfg.vocab_size,
        synth_tokens=max(2_000_000, TRAIN_BATCH * (t_len + 1) * 50), seed=SEED,
    )
    first = next(datasets.lm_batches(ids, batch_size=TRAIN_BATCH, seq_len=t_len))
    batch = {k: torch.from_numpy(v).cuda() for k, v in first.items()}
    init = transformer.init_numpy(cfg, SEED)
    paths = [p for p, _l in bridge._leaves(init)]
    result = {}
    for attention in ("auto", "xla"):
        c = dataclasses.replace(cfg, attention=attention)
        params = state.as_param_leaves(init, "cuda")
        loss, _ = transformer.loss_fn(c)(params, {}, batch, None)
        loss.backward()
        result[attention] = (loss.item(), [p.grad for p in state.leaves(params)])
        del params, loss
    (l_flash, g_flash), (l_xla, g_xla) = result["auto"], result["xla"]
    rels = [((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
            for a, b in zip(g_flash, g_xla)]
    worst = int(np.argmax(rels))
    log(
        f"  step 1 vs attention=xla (same weights, batch [{TRAIN_BATCH}, {t_len}]): "
        f"loss {l_flash:.5f} vs {l_xla:.5f} (|Δ| {abs(l_flash - l_xla):.2e}, tol "
        f"{TOL_TRAIN_LOSS:g}; the training run's step 1 read {losses[0]:.5f}); "
        f"per-leaf gradient error max {rels[worst]:.3e} at {paths[worst]}, median "
        f"{float(np.median(rels)):.3e} (tol {TOL_TRAIN_GRAD:g})"
    )
    if not (abs(l_flash - l_xla) <= TOL_TRAIN_LOSS and rels[worst] <= TOL_TRAIN_GRAD):
        raise SystemExit("the flash training step disagrees with the xla-attention step")
    del result, g_flash, g_xla

    profile_lm_step(cfg, init, batch, card)
    return launches, tc_launches


def _with_fused_env(value: str, fn):
    """``fn()`` with ``DTX_FUSED_BWD`` set to ``value``, restored after."""
    import os

    saved = os.environ.get("DTX_FUSED_BWD")
    os.environ["DTX_FUSED_BWD"] = value
    try:
        return fn()
    finally:
        if saved is None:
            del os.environ["DTX_FUSED_BWD"]
        else:
            os.environ["DTX_FUSED_BWD"] = saved


def _launch_counts(ops) -> tuple[dict, dict]:
    """A copy of the launch counts and of the tensor-core launch counts."""
    return dict(ops.LAUNCHES), dict(ops.TENSOR_CORE_LAUNCHES)


def _launches_since(ops, before: tuple[dict, dict]) -> tuple[dict, dict]:
    """The launches, and the tensor-core launches, made since
    :func:`_launch_counts` gave ``before``."""
    return tuple({k: n - was.get(k, 0) for k, n in now.items()}
                 for now, was in zip(_launch_counts(ops), before))


def train_long_end_to_end(card: str, fused_ms: float, fwd_ms: float) -> dict:
    """Train at T 8192 through the fused backward, check, compare with the
    split backward and profile (the module docstring's phase 6); returns
    the kernel launch counts of the main path's run."""
    from distributed_tensorflow_examples_tpu_torch import bridge, ops
    from distributed_tensorflow_examples_tpu_torch.data import datasets
    from distributed_tensorflow_examples_tpu_torch.examples import transformer_lm as cli
    from distributed_tensorflow_examples_tpu_torch.models import transformer
    from distributed_tensorflow_examples_tpu_torch.train import optim, state, step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = cli.build_parser().parse_args([
        f"--batch_size={LONG_BATCH}", f"--seq_len={LONG_T}", "--vocab_size=32000",
        "--dim=1024", "--n_layers=12", "--n_heads=8", f"--train_steps={TRAIN_STEPS}",
        "--learning_rate=1e-3", "--log_every_steps=1", f"--seed={SEED}",
        "--attention=auto", "--device=cuda",
    ])
    cfg = cli.config_from_args(args)
    names = ("flash_fwd", "flash_fused_bwd", "flash_dq", "flash_dkv")
    clock = step_clock(names)
    ops.reset_launches()  # every count to 0 just before the main path
    t0 = time.perf_counter()
    exp = _with_fused_env("1", lambda: cli.run_training(args, extra_hooks=[clock]))
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)  # read just after the main path
    tc_launches = dict(ops.TENSOR_CORE_LAUNCHES)
    n_params = sum(p.numel() for p in state.leaves(exp.state.params))
    del exp
    losses = [loss for _s, _ms, loss, _c in clock.steps]
    log("  steps: " + ", ".join(
        f"{s}: loss {loss:.4f} in {ms:.1f} ms, launches "
        + "/".join(str(c[k]) for k in names) for s, ms, loss, c in clock.steps
    ) + f" ({'/'.join(names)})")
    log(
        f"  {TRAIN_STEPS} steps of [{LONG_BATCH}, {LONG_T}] ({n_params} params) in "
        f"{wall:.1f} s (corpus, init, steps); launches "
        + ", ".join(f"{k} {launches.get(k, 0)}" for k in names)
        + f" (want flash_fwd and flash_fused_bwd {cfg.n_layers} x {TRAIN_STEPS} = "
        f"{cfg.n_layers * TRAIN_STEPS}, the split pair 0)"
    )
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"T {LONG_T} training losses not finite: {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5 or not losses[-1] < losses[0]:
        raise SystemExit(
            f"T {LONG_T} training loss did not start near ln({cfg.vocab_size}) = "
            f"{math.log(cfg.vocab_size):.3f} and fall: {losses}"
        )
    per_step = {"flash_fwd": cfg.n_layers, "flash_fused_bwd": cfg.n_layers,
                "flash_dq": 0, "flash_dkv": 0}
    if any(c != per_step for *_r, c in clock.steps):
        raise SystemExit(f"the T {LONG_T} path did not run the fused backward alone, "
                         f"once per layer and step: {[c for *_r, c in clock.steps]}")
    require_tensor_cores(f"T {LONG_T} train", launches, tc_launches)
    step_ms = float(np.median([ms for _s, ms, _l, _c in clock.steps[1:]]))
    log(
        f"  e2e: step {step_ms:.1f} ms (median of steps 2-{TRAIN_STEPS}, host clock to "
        f"the loss read), {LONG_BATCH * LONG_T / (step_ms / 1e3):.0f} tokens/s; "
        f"flash_fused_bwd {cfg.n_layers} x {fused_ms:.3f} = {cfg.n_layers * fused_ms:.1f} ms "
        f"and flash_fwd {cfg.n_layers} x {fwd_ms:.3f} = {cfg.n_layers * fwd_ms:.1f} ms a step "
        f"at [{LONG_BATCH * cfg.n_heads}, {LONG_T}, {cfg.head_dim}] (CUDA events) [{card}]"
    )

    # One step's loss and gradients from the initial weights on the first
    # batch: the fused backward against the split one.
    ids, _vocab, _src = datasets.text_corpus(
        None, vocab_size=cfg.vocab_size,
        synth_tokens=max(2_000_000, LONG_BATCH * (LONG_T + 1) * 50), seed=SEED,
    )
    first = next(datasets.lm_batches(ids, batch_size=LONG_BATCH, seq_len=LONG_T))
    batch = {k: torch.from_numpy(v).cuda() for k, v in first.items()}
    init = transformer.init_numpy(cfg, SEED)
    paths = [p for p, _l in bridge._leaves(init)]
    result = {}
    for mode in ("1", "0"):
        def one_step():
            params = state.as_param_leaves(init, "cuda")
            loss, _ = transformer.loss_fn(cfg)(params, {}, batch, None)
            loss.backward()
            return loss.item(), [p.grad for p in state.leaves(params)]

        before = _launch_counts(ops)
        result[mode] = _with_fused_env(mode, one_step)
        ran, ran_tc = _launches_since(ops, before)
        bwd = ("flash_fused_bwd", "flash_dq", "flash_dkv")
        want = dict(zip(bwd, (cfg.n_layers, 0, 0) if mode == "1" else (0, cfg.n_layers,
                                                                          cfg.n_layers)))
        if {k: ran.get(k, 0) for k in bwd} != want:
            raise SystemExit(f"DTX_FUSED_BWD={mode} step ran {ran}, want {want}")
        require_tensor_cores(f"T {LONG_T} DTX_FUSED_BWD={mode} step", ran, ran_tc)
    (l_fused, g_fused), (l_split, g_split) = result["1"], result["0"]
    rels = _leaf_rel_errors(g_fused, g_split)
    worst = int(np.argmax(rels))
    log(
        f"  step 1, fused vs split backward (same weights, batch [{LONG_BATCH}, {LONG_T}]): "
        f"loss {l_fused:.5f} vs {l_split:.5f} (|Δ| {abs(l_fused - l_split):.2e}, tol "
        f"{TOL_TRAIN_LOSS:g}; the training run's step 1 read {losses[0]:.5f}); per-leaf "
        f"gradient error max {rels[worst]:.3e} at {paths[worst]}, median "
        f"{float(np.median(rels)):.3e} (tol {TOL_TRAIN_GRAD:g})"
    )
    if not (abs(l_fused - l_split) <= TOL_TRAIN_LOSS and rels[worst] <= TOL_TRAIN_GRAD):
        raise SystemExit("the fused-backward training step disagrees with the split one")
    del result, g_fused, g_split

    # The whole step, fused against split backward, in turns on one state
    # (after a warm-up step): host clock to the loss read.
    opt = optim.ClippedAdamW(1e-3, 1.0)
    st = state.create_state(lambda seed: init, opt, SEED, "cuda")
    train_step = step.build_train_step(transformer.loss_fn(cfg), opt)
    times: dict = {"1": [], "0": []}
    before = _launch_counts(ops)
    for mode in ("1", "1", "0", "0", "1", "1", "0"):
        def timed():
            nonlocal st
            t0 = time.perf_counter()
            st, m = train_step(st, batch)
            float(m["loss"])
            return (time.perf_counter() - t0) * 1e3

        times[mode].append(_with_fused_env(mode, timed))
    require_tensor_cores(f"T {LONG_T} fused/split turns", *_launches_since(ops, before))
    del st, opt
    fused_step, split_step = (float(np.median(times[m][1 if m == "1" else 0:])) for m in "10")
    log(
        f"  the step in turns (fused, split, split, fused, fused, split after a warm-up): "
        f"fused {fused_step:.1f} ms, split {split_step:.1f} ms (medians; "
        f"{LONG_BATCH * LONG_T / (fused_step / 1e3):.0f} vs "
        f"{LONG_BATCH * LONG_T / (split_step / 1e3):.0f} tokens/s) [{card}]"
    )

    _with_fused_env("1", lambda: profile_lm_step(cfg, init, batch, card))
    return launches, tc_launches


#: Kernel families of a ResNet-50 step's profile, by substrings of the
#: kernel name, checked in this order.
RESNET_FAMILIES = (
    ("bn_stats", ("bn_stats_partial",)),
    ("bn_bwd_stats", ("bn_bwd_stats_partial",)),
    ("bn finalize (both)", ("bn_stats_finalize",)),
    ("optimizer", ("sgd", "multi_tensor_apply")),
    ("layout transform", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("conv/cuDNN", ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad", "fprop",
                    "sm90", "gemm", "cutlass", "nvjet")),
    ("pool", ("pool",)),
    ("reduce", ("reduce", "softmax", "logsumexp")),
    ("copy/cast", ("copy", "memcpy", "memset", "fill", "pad")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _leaf_rel_errors(a: list, b: list) -> list[float]:
    return [((x.float() - y.float()).norm() / y.float().norm().clamp_min(1e-30)).item()
            for x, y in zip(a, b)]


def _one_step_grads(cfg, init, batch, mesh) -> tuple[float, list]:
    """Loss and per-leaf gradients of one forward/backward from ``init``."""
    from distributed_tensorflow_examples_tpu_torch.models import resnet
    from distributed_tensorflow_examples_tpu_torch.train import state

    params = state.as_param_leaves(init[0], "cuda")
    mstate = state.as_state_leaves(init[1], "cuda")
    loss, _ = resnet.loss_fn(cfg, mesh=mesh)(params, mstate, batch, None)
    loss.backward()
    grads = [p.grad for p in state.leaves(params)]
    out = (loss.item(), grads)
    del params, mstate, loss
    return out


def resnet_end_to_end(card: str) -> tuple[dict, dict]:
    """Train, check, compare and profile ResNet-50 (the module docstring's
    phase 5); returns the BN kernels' launch counts of the main path's run,
    and its step 1 loss and median step ms."""
    import contextlib
    import dataclasses as dc
    import io

    from distributed_tensorflow_examples_tpu_torch import bridge, ops
    from distributed_tensorflow_examples_tpu_torch.data import streams
    from distributed_tensorflow_examples_tpu_torch.examples import resnet50 as cli
    from distributed_tensorflow_examples_tpu_torch.models import resnet
    from distributed_tensorflow_examples_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from distributed_tensorflow_examples_tpu_torch.train import optim, state, step

    args = cli.build_parser().parse_args([
        f"--batch_size={RESNET_BATCH}", f"--image_size={RESNET_IMAGE}", "--num_classes=1000",
        f"--train_steps={RESNET_STEPS}", "--learning_rate=0.1", "--momentum=0.9",
        "--log_every_steps=1", f"--seed={SEED}", "--device=cuda",
    ])
    cfg = cli.config_from_args(args)
    init = resnet.init_numpy(cfg, SEED)
    kernels = [k for k in resnet._kernels(init[0])]
    l2_term = 1e-4 * float(sum(np.sum(np.square(k, dtype=np.float64)) for k in kernels))
    n_bn = len(resnet50_bn_shapes(RESNET_BATCH, RESNET_IMAGE))
    clock = step_clock(("bn_stats", "bn_bwd_stats"))
    ops.reset_launches()  # every count to 0 just before the main path
    t0 = time.perf_counter()
    final = io.StringIO()
    with contextlib.redirect_stdout(final):
        exp = cli.run_training(
            args, loss_fn_factory=lambda mesh: resnet.loss_fn(cfg, mesh=mesh),
            extra_hooks=[clock],
        )
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)  # read just after the main path
    final_line = [l for l in final.getvalue().splitlines() if l.startswith("FINAL ")]
    log(f"  {final_line[0] if final_line else 'no FINAL line'}")
    losses = [loss for _s, _ms, loss, _c in clock.steps]
    log("  steps: " + ", ".join(
        f"{s}: loss {loss:.4f} in {ms:.1f} ms, launches {c['bn_stats']}/{c['bn_bwd_stats']}"
        for s, ms, loss, c in clock.steps
    ))
    want = n_bn * RESNET_STEPS
    log(
        f"  {RESNET_STEPS} steps of [{RESNET_BATCH}, {RESNET_IMAGE}, {RESNET_IMAGE}, 3] + eval "
        f"in {wall:.1f} s (data, init, steps, eval); launches bn_stats "
        f"{launches.get('bn_stats', 0)}, bn_bwd_stats {launches.get('bn_bwd_stats', 0)} "
        f"(want {n_bn} x {RESNET_STEPS} = {want} each, none in the eval)"
    )
    if not final_line or "test_accuracy=" not in final_line[0]:
        raise SystemExit("the ResNet run printed no FINAL line with test_accuracy")
    if len(losses) != RESNET_STEPS or not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"ResNet training losses not finite: {losses}")
    start = math.log(1000) + l2_term
    if abs(losses[0] - start) > TOL_RESNET_START or not losses[-1] < losses[0]:
        raise SystemExit(
            f"ResNet loss did not start within {TOL_RESNET_START} of ln(1000) + l2 = "
            f"{start:.3f} and fall: {losses}"
        )
    if any(c != {"bn_stats": n_bn, "bn_bwd_stats": n_bn} for *_r, c in clock.steps) or any(
        launches.get(k, 0) != want for k in ("bn_stats", "bn_bwd_stats")
    ):
        raise SystemExit(f"the ResNet path did not run each BN kernel {n_bn} times a step")
    init_stats = [torch.from_numpy(np.asarray(v)).cuda() for v in state.leaves(init[1])]
    moved = [(a - b).abs().max().item()
             for a, b in zip(state.leaves(exp.state.model_state), init_stats)]
    if not min(moved) > 0:
        raise SystemExit("some BatchNorm running stats did not move in training")
    ops.reset_launches()
    exp.evaluate(exp.source.ds.test, eval_fn=cli.eval_fn_for(cfg))
    if sum(ops.LAUNCHES.values()):
        raise SystemExit(f"the eval (train=False) launched BN kernels: {dict(ops.LAUNCHES)}")
    step_ms = float(np.median([ms for _s, ms, _l, _c in clock.steps[1:]]))
    log(
        f"  step 1 loss {losses[0]:.4f} (ln 1000 + l2 {start:.4f}, l2 term {l2_term:.4f}, "
        f"tol {TOL_RESNET_START:g}); loss {losses[0] - losses[-1]:+.4f} lower after "
        f"{RESNET_STEPS} steps; "
        f"{len(moved)} running-stat leaves moved (least max |Δ| {min(moved):.3e}); eval "
        f"launched no BN kernel; test metrics {exp.test_metrics}"
    )
    log(
        f"  e2e: step {step_ms:.1f} ms (median of steps 2-{RESNET_STEPS}, host clock to the "
        f"loss read), {RESNET_BATCH / (step_ms / 1e3):.0f} images/s [{card}]"
    )
    first_batch = next(streams.train_iter(exp.source, batch_size=RESNET_BATCH, seed=SEED))
    del exp

    # One step from the same weights and batch: fused statistics vs plain
    # torch BatchNorm, float32 at batch RESNET_CMP_BATCH, each also against
    # a float64 step (gated), then bf16 at the training batch (reported).
    mesh = build_mesh(MeshSpec.parse("data=1"), "cuda")
    paths = [p for p, _l in bridge._leaves(init[0])]
    for dtype, b, gate in (("float32", RESNET_CMP_BATCH, True), ("bfloat16", RESNET_BATCH, False)):
        c = dc.replace(cfg, compute_dtype=dtype)
        batch = {k: torch.from_numpy(v[:b]).cuda() for k, v in first_batch.items()}
        l_fused, g_fused = _one_step_grads(c, init, batch, mesh)
        l_plain, g_plain = _one_step_grads(c, init, batch, None)
        rels = _leaf_rel_errors(g_fused, g_plain)
        worst = int(np.argmax(rels))
        head = rels[paths.index("head/kernel")]
        log(
            f"  step 1, fused vs plain-torch BatchNorm ({dtype}, batch {b}): loss "
            f"{l_fused:.6f} vs {l_plain:.6f} (|Δ| {abs(l_fused - l_plain):.2e}"
            + (f", tol {TOL_RESNET_LOSS:g}" if gate else "")
            + f"); per-leaf gradient error max {rels[worst]:.3e} at {paths[worst]}, median "
            f"{float(np.median(rels)):.3e}, head {head:.3e}"
            + (f" (tol {TOL_RESNET_GRAD:g}, head {TOL_RESNET_HEAD:g})" if gate
               else " (reported, not gated)")
        )
        if gate:
            _l64, g64 = _one_step_grads(dc.replace(cfg, compute_dtype="float64"), init, batch, None)
            far = {name: _leaf_rel_errors(g, g64) for name, g in (("fused", g_fused),
                                                                  ("plain", g_plain))}
            log("  the same step against float64 convolutions and elementwise work: "
                + "; ".join(f"{name} median {float(np.median(e)):.3e}, max {max(e):.3e}"
                            for name, e in far.items())
                + f" (the fused path no further than {TOL_RESNET_VS_F64:g}x the plain one)")
            del g64
        if gate and not (
            abs(l_fused - l_plain) <= TOL_RESNET_LOSS and rels[worst] <= TOL_RESNET_GRAD
            and head <= TOL_RESNET_HEAD
            and all(f(far["fused"]) <= TOL_RESNET_VS_F64 * f(far["plain"]) for f in (np.median, max))
        ):
            raise SystemExit("the fused-statistics ResNet step disagrees with the plain one")
        del g_fused, g_plain, batch

    # Where a step's time goes: one full bf16 step at batch RESNET_BATCH
    # (after a warm-up step) under torch.profiler.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    opt = optim.SGD(cli.lr_schedule(args), momentum=0.9)
    st = state.create_state(lambda seed: init, opt, SEED, "cuda")
    train_step = step.build_train_step(resnet.loss_fn(cfg, mesh=mesh), opt)
    batch = {k: torch.from_numpy(v).cuda() for k, v in first_batch.items()}
    st, m = train_step(st, batch)
    float(m["loss"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st, m = train_step(st, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families: dict = {}
    kernels = []
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us <= 0 or e.device_type != DeviceType.CUDA or e.key in CUPTI_MARKERS:
            continue
        kernels.append((us, e.count, e.key))
        name = e.key.lower()
        fam = next((f for f, keys in RESNET_FAMILIES if any(k in name for k in keys)), "other")
        families[fam] = families.get(fam, 0.0) + us / 1e3
    busy_ms = sum(families.values())
    if busy_ms <= 0:
        raise SystemExit("torch.profiler recorded no device time for the ResNet step")
    log(
        f"  profiled ResNet step: host {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"(idle share {max(0.0, 1 - busy_ms / wall_ms):.1%}); by family: "
        + ", ".join(f"{k} {v:.1f} ms ({v / busy_ms:.1%})"
                    for k, v in sorted(families.items(), key=lambda kv: -kv[1]))
    )
    for us, count, key in sorted(kernels, reverse=True)[:12]:
        log(f"    {us / 1e3:8.2f} ms in {count:4d} launches  {key[:110]}")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")
    return launches, {"first_loss": losses[0], "step_ms": step_ms}


def step_recorder(profile_step: int | None = None):
    """A training hook that records (step, ms, loss, profiled) for every
    step, reading the loss (which waits for the step's device work), and
    runs step ``profile_step`` under ``torch.profiler`` (``.prof``)."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_tensorflow_examples_tpu_torch.train import hooks

    class StepRecorder(hooks.Hook):
        def __init__(self):
            self.steps: list = []
            self.prof = None

        def begin(self, loop):
            torch.cuda.synchronize()
            self._t = time.perf_counter()

        def before_step(self, loop):
            if loop.step + 1 == profile_step:
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                self.prof.__enter__()
                self._t = time.perf_counter()

        def after_step(self, loop, metrics):
            loss = float(metrics["loss"])
            profiled = loop.step == profile_step
            if profiled:
                torch.cuda.synchronize()
            now = time.perf_counter()
            self.steps.append((loop.step, (now - self._t) * 1e3, loss, profiled))
            if profiled:
                self.prof.__exit__(None, None, None)
                now = time.perf_counter()
            self._t = now

    return StepRecorder()


def _host_rows(prof, top: int = 6) -> str:
    """The profile's CPU ops with the most self time on the host."""
    from torch.autograd import DeviceType

    rows = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:top]
    return ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.2f} ms ({e.count})" for e in rows)


def _device_rows(prof) -> tuple[float, int, int]:
    """(busy ms, kernel launches, memcpy/memset operations) of a profile's
    device rows, the profiler's own markers left out."""
    from torch.autograd import DeviceType

    busy_us, kernels, copies = 0.0, 0, 0
    for e in prof.key_averages():
        if e.self_device_time_total <= 0 or e.device_type != DeviceType.CUDA \
                or e.key in CUPTI_MARKERS:
            continue
        busy_us += e.self_device_time_total
        if e.key.lower().startswith(("memcpy", "memset")):
            copies += e.count
        else:
            kernels += e.count
    return busy_us / 1e3, kernels, copies


def _first_step_loss(cli, argv: list, device: str) -> float:
    """Step 1's loss of ``cli`` at ``argv`` on ``device`` (one step; its
    FINAL line and logs are swallowed)."""
    import contextlib
    import io

    rec = step_recorder()
    args = cli.build_parser().parse_args([*argv, f"--device={device}", "--train_steps=1"])
    with contextlib.redirect_stdout(io.StringIO()):
        cli.run_training(args, extra_hooks=[rec])
    return rec.steps[0][2]


def workloads_end_to_end(card: str) -> dict:
    """Train the four reference workloads on the card through their CLIs
    (the module docstring's phase 7); returns each one's measurements."""
    import contextlib
    import io
    import re

    from distributed_tensorflow_examples_tpu_torch import ops
    from distributed_tensorflow_examples_tpu_torch.examples import (
        cifar10_cnn, mnist_mlp, ptb_lstm, word2vec as w2v_cli,
    )
    from distributed_tensorflow_examples_tpu_torch.models import word2vec
    from distributed_tensorflow_examples_tpu_torch.utils import threefry

    clis = {"mnist_mlp": mnist_mlp, "cifar10_cnn": cifar10_cnn, "word2vec": w2v_cli,
            "ptb_lstm": ptb_lstm}
    metric = {"mnist_mlp": "test_accuracy", "cifar10_cnn": "test_accuracy",
              "word2vec": "eval_loss", "ptb_lstm": "valid_perplexity"}
    results = {}
    for name in WORKLOADS:
        cli = clis[name]
        argv = [f"--seed={SEED}"]
        args = cli.build_parser().parse_args(
            [*argv, "--device=cuda", f"--train_steps={WORKLOAD_STEPS}", "--log_every_steps=100"])
        rec = step_recorder(profile_step=WORKLOAD_STEPS // 2)
        ops.reset_launches()  # every count to 0 just before the main path
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            exp = cli.run_training(args, extra_hooks=[rec])
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)  # read just after the main path
        final = [l for l in out.getvalue().splitlines() if l.startswith("FINAL ")]
        pattern = (rf"^FINAL step={WORKLOAD_STEPS} steps_per_sec=\S+ "
                   rf"examples_per_sec_per_chip=\S+ {metric[name]}=([0-9.]+)$")
        match = re.match(pattern, final[0]) if final else None
        if not match:
            raise SystemExit(f"{name}: no FINAL line of the CLI's form: {final}")
        losses = [loss for _s, _ms, loss, _p in rec.steps]
        if len(losses) != WORKLOAD_STEPS or not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"{name}: a logged loss is not finite (or steps are missing)")
        if sum(launches.values()):
            raise SystemExit(f"{name}: the path launched a hand kernel: {launches}")
        cpu_first = _first_step_loss(cli, argv, "cpu")
        gap = abs(losses[0] - cpu_first)
        if name in TOL_WORKLOAD_START_REL:
            tol, ok = TOL_WORKLOAD_START_REL[name], gap <= TOL_WORKLOAD_START_REL[name] * abs(cpu_first)
        else:
            tol, ok = TOL_WORKLOAD_START[name], gap <= TOL_WORKLOAD_START[name]
        if not ok:
            raise SystemExit(f"{name}: step 1's loss on the card {losses[0]:.6f} is not within "
                             f"{tol:g} of the CPU's {cpu_first:.6f}")
        if name == "word2vec":
            key = threefry.fold_in(threefry.key(SEED), 0)
            on_card = word2vec.log_uniform_sample(key, args.num_sampled, args.vocab_size, "cuda")
            on_cpu = word2vec.log_uniform_sample(key, args.num_sampled, args.vocab_size, "cpu")
            if not torch.equal(on_card.cpu(), on_cpu):
                raise SystemExit("word2vec: step 1's sampled ids on the card differ from the CPU's")
        step_ms = float(np.median([ms for _s, ms, _l, p in rec.steps[1:] if not p]))
        profiled_ms = next(ms for _s, ms, _l, p in rec.steps if p)
        busy_ms, kernels, copies = _device_rows(rec.prof)
        per_step = args.batch_size * (args.seq_len if name == "ptb_lstm" else 1)
        results[name] = {
            "step_ms": step_ms, "examples_per_s": args.batch_size / (step_ms / 1e3),
            "kernel_launches": kernels, "copies": copies, "busy_ms": busy_ms,
            "profiled_ms": profiled_ms,
            "idle_share": max(0.0, 1 - busy_ms / step_ms),
            "loss_first": losses[0], "loss_last": losses[-1], "cpu_first": cpu_first,
            "final": float(match.group(1)),
        }
        r = results[name]
        log(f"  {name}: {final[0]}")
        log(f"    {WORKLOAD_STEPS} steps + eval in {wall:.1f} s; loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, all finite; step 1 on the card {losses[0]:.6f} vs the CPU's "
            f"{cpu_first:.6f} (|d| {gap:.2e}, tol {tol:g}"
            + (" relative" if name in TOL_WORKLOAD_START_REL else "") + ")"
            + ("; step 1's sampled ids equal the CPU's" if name == "word2vec" else "")
            + "; no hand kernel launched")
        log(f"    e2e: step {step_ms:.3f} ms (median of steps 2-{WORKLOAD_STEPS}, host clock to "
            f"the loss read), {r['examples_per_s']:.0f} examples/s"
            + (f" ({per_step / (step_ms / 1e3):.0f} tokens/s)" if name == "ptb_lstm" else "")
            + f"; profiled step {WORKLOAD_STEPS // 2}: {kernels} kernel launches + {copies} "
            f"copies/sets, device busy {busy_ms:.3f} ms, idle share {r['idle_share']:.1%} of "
            f"the median step ({max(0.0, 1 - busy_ms / profiled_ms):.1%} of the profiled "
            f"step's {profiled_ms:.3f} ms) [{card}]")
        log(f"    host, profiled step, most self time: {_host_rows(rec.prof)}")
        del exp
    return results


def ps_timed_trainer(base, profiled: bool = False):
    """A subclass of the port's ``AsyncPSTrainer`` that times each part of
    an applied step (worker gradient to the loss read, the gradient's
    device-to-host flatten, the native ``apply``/``push``, the chief's
    ``take``/``pop`` wait, the apply with its host-to-device publish) from
    apply ``PS_WARMUP_APPLIES`` on (the first applies load kernels and
    build cuDNN plans), notes when that window starts and when the last
    apply ends, and records how many gradients each sync ``take``
    averaged.  With
    ``profiled``, the whole ``run`` (thread start to join) is under
    ``torch.profiler``: the profiler starts and stops only while no worker
    thread runs, since stopping it while another thread is inside an
    operator crashed the process (on an H100, torch 2.11.0+cu128)."""
    from torch.profiler import ProfilerActivity, profile

    class Timed(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.seconds = dict.fromkeys(("grad", "d2h", "send", "wait", "apply"), 0.0)
            self.taken: list[int] = []
            self.prof = None
            self._clock = threading.Lock()

        def _timed(self, key, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            with self._clock:
                self.seconds[key] += time.perf_counter() - t0
            return out

        def _grad(self, *args):
            return self._timed("grad", super()._grad, *args)

        def _to_host(self, grads):
            return self._timed("d2h", super()._to_host, grads)

        def _send(self, *args):
            return self._timed("send", super()._send, *args)

        def _take(self, n_agg):
            out = self._timed("wait", super()._take, n_agg)
            if out is not None:
                self.taken.append(self._acc.last_count)
            return out

        def _pop(self):
            return self._timed("wait", super()._pop)

        def _apply_update(self, flat):
            self._timed("apply", super()._apply_update, flat)
            self.t_last = time.perf_counter()
            if self.global_step == PS_WARMUP_APPLIES:
                with self._clock:
                    self.seconds = dict.fromkeys(self.seconds, 0.0)
                    self.grads_at_warm = len(self.history)
                self.t_warm = self.t_last

        def run(self, batch_fns):
            if profiled:
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                self.prof.__enter__()
            t0 = time.perf_counter()
            try:
                return super().run(batch_fns)
            finally:
                if profiled:
                    torch.cuda.synchronize()
                self.run_s = time.perf_counter() - t0
                if profiled:
                    self.prof.__exit__(None, None, None)

    return Timed


def _ps_cli_run(cli, argv: list, timed) -> tuple:
    """``cli.run_training`` on ``argv`` with the port's trainer swapped for
    ``timed``; returns (trainer, FINAL line, hand-kernel launches)."""
    import contextlib
    import io

    from distributed_tensorflow_examples_tpu_torch import ops
    from distributed_tensorflow_examples_tpu_torch.parallel import async_ps

    real = async_ps.AsyncPSTrainer
    async_ps.AsyncPSTrainer = timed
    out = io.StringIO()
    try:
        ops.reset_launches()  # every count to 0 just before the main path
        with contextlib.redirect_stdout(out):
            trainer = cli.run_training(cli.build_parser().parse_args(argv))
        launches = dict(ops.LAUNCHES)  # read just after the main path
    finally:
        async_ps.AsyncPSTrainer = real
    final = [l for l in out.getvalue().splitlines() if l.startswith("FINAL ")]
    return trainer, (final[0] if final else ""), launches


def _ps_param_hash(trainer) -> str:
    """A hash of the trainer's final parameters, as one flat f32 vector."""
    import hashlib

    from distributed_tensorflow_examples_tpu_torch.bridge import flat_params_of

    return hashlib.sha256(flat_params_of(trainer.params).tobytes()).hexdigest()[:16]


def ps_emulation_end_to_end(card: str) -> dict:
    """Train W1 and W2 on the in-process PS emulation through their CLIs
    (the module docstring's phase 8); returns each run's measurements."""
    import re

    from distributed_tensorflow_examples_tpu_torch.data.pipeline import InMemoryPipeline
    from distributed_tensorflow_examples_tpu_torch.examples import cifar10_cnn, mnist_mlp
    from distributed_tensorflow_examples_tpu_torch.models import mlp
    from distributed_tensorflow_examples_tpu_torch.parallel import async_ps

    base = [f"--seed={SEED}", f"--worker_hosts={PS_WORKERS}", f"--train_steps={PS_STEPS}"]
    runs = {
        "w1_sync": (mnist_mlp, ["--ps_emulation"], "sync_replicas"),
        "w2_async": (cifar10_cnn, ["--sync_replicas=false", "--max_staleness=4"], "async"),
        "w2_deterministic": (cifar10_cnn, ["--sync_replicas=false", "--max_staleness=4",
                                           "--deterministic"], "async"),
        "w2_deterministic_again": (cifar10_cnn, ["--sync_replicas=false", "--max_staleness=4",
                                                 "--deterministic"], "async"),
    }
    results, trainers = {}, {}
    for name, (cli, argv, mode) in runs.items():
        timed = ps_timed_trainer(async_ps.AsyncPSTrainer)
        tr, final, launches = _ps_cli_run(cli, [*base, *argv, "--device=cuda"], timed)
        trainers[name] = tr
        # The profile: a second, short run of the same CLI, wholly profiled.
        prof_tr, _f, _l = _ps_cli_run(
            cli, [*base[:2], f"--train_steps={PS_PROFILE_APPLIES}", *argv, "--device=cuda"],
            ps_timed_trainer(async_ps.AsyncPSTrainer, profiled=True))
        pattern = (rf"^FINAL step={PS_STEPS} steps_per_sec=\S+ examples_per_sec_per_chip=\S+ "
                   rf"mode={mode} stale_dropped=(\d+) first_loss=\S+ last_loss=\S+ "
                   rf"test_accuracy=([0-9.]+)$")
        match = re.match(pattern, final)
        if not match:
            raise SystemExit(f"{name}: no FINAL line of the JAX PS form: {final!r}")
        losses = [loss for _w, _s, loss in tr.history]
        if tr.global_step != PS_STEPS or not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"{name}: {tr.global_step} applied steps, or a loss not finite")
        if sum(launches.values()):
            raise SystemExit(f"{name}: the path launched a hand kernel: {launches}")
        if mode == "sync_replicas":
            r2a = tr.cfg.replicas_to_aggregate
            if tr.taken != [r2a] * PS_STEPS:
                raise SystemExit(f"{name}: a take averaged other than {r2a} gradients: "
                                 f"{sorted(set(tr.taken))} over {len(tr.taken)} applies")
        local_bs = cli.build_parser().parse_args([]).batch_size // tr.cfg.num_workers
        per_apply = (tr.cfg.replicas_to_aggregate or 1) if mode == "sync_replicas" else 1
        # The steady window: applies PS_WARMUP_APPLIES + 1 .. PS_STEPS.
        steps = tr.global_step - PS_WARMUP_APPLIES
        steady_s = tr.t_last - tr.t_warm
        sps = steps / steady_s
        grads = len(tr.history) - tr.grads_at_warm
        busy_ms, kernels, copies = _device_rows(prof_tr.prof)
        train = tr.source.train if cli is mnist_mlp else tr.source.ds.train
        batch_bytes = sum(v[:local_bs].nbytes for v in train.values())
        r = {
            "applied_steps_per_s": sps, "examples_per_s_per_chip": sps * local_bs * per_apply,
            "apply_wall_ms": steady_s / steps * 1e3,
            "whole_run_applied_steps_per_s": tr.global_step / tr.run_s,
            **{f"{k}_ms_per_apply": v / steps * 1e3 for k, v in tr.seconds.items()},
            "gradients_per_apply": grads / steps,
            "d2h_mb_per_apply": grads * tr.num_elems * 4 / steps / 1e6,
            "h2d_param_mb_per_apply": tr.num_elems * 4 / 1e6,
            "h2d_batch_mb_per_apply": grads * batch_bytes / steps / 1e6,
            "launches_per_apply": kernels / PS_PROFILE_APPLIES,
            "copies_per_apply": copies / PS_PROFILE_APPLIES,
            "busy_ms_per_apply": busy_ms / PS_PROFILE_APPLIES,
            "idle_share": max(0.0, 1 - busy_ms / (prof_tr.run_s * 1e3)),
            "stale_dropped": int(match.group(1)), "test_accuracy": float(match.group(2)),
            "loss_first": losses[0], "loss_last": losses[-1], "params": tr.num_elems,
        }
        results[name] = r
        log(f"  {name}: {final}")
        log(f"    {tr.global_step} applies in {tr.run_s:.2f} s "
            f"({r['whole_run_applied_steps_per_s']:.1f} applied steps/s over the whole run); "
            f"applies {PS_WARMUP_APPLIES + 1}-{tr.global_step}: {sps:.1f} applied steps/s, "
            f"{r['examples_per_s_per_chip']:.0f} examples/s per chip, {r['apply_wall_ms']:.3f} ms "
            f"an applied step, {grads} gradients ({r['gradients_per_apply']:.2f} an apply); "
            f"{r['stale_dropped']} dropped stale; loss {losses[0]:.4f} -> {losses[-1]:.4f}, all "
            "finite; no hand kernel launched"
            + (f"; every take averaged {tr.cfg.replicas_to_aggregate} gradients"
               if mode == "sync_replicas" else ""))
        log(f"    per applied step, applies {PS_WARMUP_APPLIES + 1} on (ms, summed over threads): "
            + ", ".join(f"{k} {v / steps * 1e3:.3f}" for k, v in tr.seconds.items())
            + " (grad: worker forward+backward to the loss read; d2h: flatten + copy to "
            "pinned host; send: native apply/push; wait: chief's take/pop; apply: host "
            "update + H2D publish)")
        log(f"    bytes per applied step: gradient D2H {r['d2h_mb_per_apply']:.3f} MB, params "
            f"H2D {r['h2d_param_mb_per_apply']:.3f} MB, batches H2D "
            f"{r['h2d_batch_mb_per_apply']:.3f} MB ({tr.num_elems} f32 params)")
        log(f"    a profiled run of {PS_PROFILE_APPLIES} applies (thread start to join): "
            f"{r['launches_per_apply']:.1f} kernel launches + {r['copies_per_apply']:.1f} "
            f"copies/sets an apply, device busy {r['busy_ms_per_apply']:.3f} ms an apply, "
            f"idle share {r['idle_share']:.1%} of the run's {prof_tr.run_s * 1e3:.2f} ms [{card}]")
        log(f"    host, profiled run, the chief thread's ops with most self time: "
            f"{_host_rows(prof_tr.prof)}")

    a, b = (_ps_param_hash(trainers[k]) for k in ("w2_deterministic", "w2_deterministic_again"))
    if a != b:
        raise SystemExit(f"the two deterministic W2 runs end with other parameters: {a} {b}")
    log(f"  the two deterministic W2 runs end with bitwise-equal parameters (sha256 {a})")

    # The card against the CPU.  W1: each worker's first gradient at step 0
    # (token assignment is racy, so a worker may have none there) against
    # the loss of the same initial weights on its first batch on the CPU.
    w1 = trainers["w1_sync"]
    cfg = mlp.Config()
    init = mlp.init_numpy(cfg, SEED)
    cpu_params = {k: {n: torch.from_numpy(v) for n, v in leaf.items()} for k, leaf in init.items()}
    compared = 0
    for wid in range(2):
        first = next((h for h in w1.history if h[0] == wid), None)
        if first is None or first[1] != 0:
            continue
        batch = next(iter(InMemoryPipeline(w1.source.train, batch_size=64, seed=SEED + wid)))
        cpu = float(mlp.loss_fn(cfg)(cpu_params, {}, {k: torch.from_numpy(v)
                                                       for k, v in batch.items()}, None)[0])
        gap = abs(first[2] - cpu)
        if gap > TOL_WORKLOAD_START["mnist_mlp"]:
            raise SystemExit(f"w1_sync: worker {wid}'s first loss on the card {first[2]:.6f} is "
                             f"not within {TOL_WORKLOAD_START['mnist_mlp']:g} of the CPU's {cpu:.6f}")
        log(f"  w1_sync: worker {wid}'s first gradient (step 0) loss {first[2]:.6f} on the card, "
            f"{cpu:.6f} on the CPU (|d| {gap:.2e})")
        compared += 1
    if not compared:
        raise SystemExit("w1_sync: no worker computed a gradient at step 0")
    # W2 deterministic: the first 4 applied losses against the same CLI's
    # run on the CPU.
    det = trainers["w2_deterministic"]
    cpu_tr, _final, _l = _ps_cli_run(
        cifar10_cnn, [*base[:2], "--train_steps=4", "--sync_replicas=false",
                      "--max_staleness=4", "--deterministic", "--device=cpu"],
        async_ps.AsyncPSTrainer)
    card4 = [h[2] for h in det.history[:4]]
    cpu4 = [h[2] for h in cpu_tr.history[:4]]
    gaps = [abs(x - y) for x, y in zip(card4, cpu4, strict=True)]
    if max(gaps) > TOL_WORKLOAD_START["cifar10_cnn"]:
        raise SystemExit(f"w2_deterministic: the first 4 applied losses on the card {card4} are not "
                         f"within {TOL_WORKLOAD_START['cifar10_cnn']:g} of the CPU's {cpu4}")
    log(f"  w2_deterministic: first 4 applied losses on the card {[round(x, 6) for x in card4]}, "
        f"on the CPU {[round(x, 6) for x in cpu4]} (max |d| {max(gaps):.2e})")
    results["w2_deterministic"]["param_sha256"] = a
    results["w2_deterministic"]["cpu_first4_max_gap"] = max(gaps)
    return results


# ----------------------------------------------------------------------------
# Phase 9: synchronous data parallelism on the card
# ----------------------------------------------------------------------------


def dp_step_hook(kernels=(), profile_step: int | None = None):
    """A training hook of one rank that records, for every step, (step, ms,
    loss, launches of each of ``kernels``, all-reduce calls and bytes by
    tag, profiled), reading the loss (which waits for the step's device
    work), and runs step ``profile_step`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_tensorflow_examples_tpu_torch import ops
    from distributed_tensorflow_examples_tpu_torch.parallel import collectives
    from distributed_tensorflow_examples_tpu_torch.train import hooks

    class DPStep(hooks.Hook):
        def __init__(self):
            self.steps: list = []
            self.prof = None

        def _mark(self):
            self._t = time.perf_counter()
            self._launches = dict(ops.LAUNCHES)
            self._traffic = dict(collectives.TRAFFIC)

        def begin(self, loop):
            torch.cuda.synchronize()
            self._mark()

        def before_step(self, loop):
            if loop.step + 1 == profile_step:
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                self.prof.__enter__()
                self._t = time.perf_counter()

        def after_step(self, loop, metrics):
            loss = float(metrics["loss"])
            profiled = loop.step == profile_step
            if profiled:
                torch.cuda.synchronize()
            ms = (time.perf_counter() - self._t) * 1e3
            launches = {k: ops.LAUNCHES[k] - self._launches.get(k, 0) for k in kernels}
            traffic = {k: v - self._traffic.get(k, 0) for k, v in collectives.TRAFFIC.items()
                       if v != self._traffic.get(k, 0)}
            self.steps.append({"step": loop.step, "ms": ms, "loss": loss,
                               "launches": launches, "traffic": traffic,
                               "profiled": profiled})
            if profiled:
                self.prof.__exit__(None, None, None)
            self._mark()

    return DPStep()


def _profile_summary(prof, step_ms: float) -> dict:
    """Device busy ms, kernel launches, NCCL kernels and idle share of one
    rank's profiled step."""
    from torch.autograd import DeviceType

    busy_ms, kernels, _copies = _device_rows(prof)
    nccl = sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower())
    return {"busy_ms": busy_ms, "kernels": kernels, "nccl_kernels": nccl,
            "step_ms": step_ms, "idle_share": max(0.0, 1 - busy_ms / step_ms)}


def _rank_result(out_dir: str, result: dict) -> None:
    from distributed_tensorflow_examples_tpu_torch.parallel import dist

    with open(Path(out_dir) / f"rank{dist.process_index()}.json", "w") as f:
        json.dump(result, f)


def dp_resnet_rank(out_dir: str, steps: int, profile_step: int, parity: bool) -> None:
    """One rank of phase 9's ResNet-50 runs: ``examples.resnet50``'s
    ``run_training`` on the fused statistics path over the world the
    runner's ``TF_CONFIG`` gives, then (``parity``) one float32 step from
    the initial weights against a 1-rank step over the global batch."""
    import dataclasses as dc

    from distributed_tensorflow_examples_tpu_torch import bridge, ops
    from distributed_tensorflow_examples_tpu_torch.examples import resnet50 as cli
    from distributed_tensorflow_examples_tpu_torch.models import resnet
    from distributed_tensorflow_examples_tpu_torch.parallel import collectives, dist, sharding
    from distributed_tensorflow_examples_tpu_torch.parallel.mesh import Mesh
    from distributed_tensorflow_examples_tpu_torch.train import state, step as step_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = cli.build_parser().parse_args([
        f"--batch_size={RESNET_BATCH}", f"--image_size={RESNET_IMAGE}", "--num_classes=1000",
        f"--train_steps={steps}", "--learning_rate=0.1", "--momentum=0.9",
        "--log_every_steps=1", f"--seed={SEED}", f"--synthetic_examples={DP_EXAMPLES}",
    ])
    cfg = cli.config_from_args(args)
    hook = dp_step_hook(("bn_stats", "bn_bwd_stats"), profile_step)
    ops.reset_launches()  # every count to 0 just before the main path
    collectives.TRAFFIC.clear()
    t0 = time.perf_counter()
    exp = cli.run_training(
        args, loss_fn_factory=lambda mesh: resnet.loss_fn(cfg, mesh=mesh), extra_hooks=[hook])
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)  # read just after the main path
    ops.reset_launches()
    exp.evaluate(exp.source.ds.test, eval_fn=cli.eval_fn_for(cfg))
    profiled = next(s for s in hook.steps if s["profiled"])
    result = {
        "rank": dist.process_index(), "world": dist.process_count(),
        "backend": dist.backend(), "device": str(exp.device), "wall_s": wall,
        "mesh": exp.mesh.shape, "steps": hook.steps, "launches": launches,
        "eval_launches": dict(ops.LAUNCHES), "test_metrics": exp.test_metrics,
        "param_sha256": state.params_sha256(exp.state.params),
        "stats_sha256": state.params_sha256(exp.state.model_state),
        "profile": _profile_summary(hook.prof, profiled["ms"]),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    if parity:
        c32 = dc.replace(cfg, compute_dtype="float32")
        init = resnet.init_numpy(cfg, SEED)
        result["l2_term"] = 1e-4 * float(sum(np.sum(np.square(k, dtype=np.float64))
                                             for k in resnet._kernels(init[0])))
        batch = {k: torch.from_numpy(v[:RESNET_CMP_BATCH]).to(exp.device)
                 for k, v in exp.source.ds.train.items()}
        rows = sharding.rank_rows(RESNET_CMP_BATCH)
        params = state.as_param_leaves(init[0], exp.device)
        loss, _ = resnet.loss_fn(c32, mesh=exp.mesh)(
            params, state.as_state_leaves(init[1], exp.device),
            {k: v[rows] for k, v in batch.items()}, None)
        loss.backward()
        step_lib.sync_gradients(params, exp.mesh.group)
        dp_loss = float(collectives.pmean(loss.detach()))
        g_dp = [p.grad for p in state.leaves(params)]
        if dist.is_chief():
            # The 1-rank references over the global batch, on a mesh of one
            # rank (it has no group: no collective reaches the other rank).
            one = Mesh(device=exp.device, shape={"data": 1})
            l1, g1 = _one_step_grads(c32, init, batch, one)
            flipped = {k: v.flip(0) for k, v in batch.items()}
            l1r, g1r = _one_step_grads(c32, init, flipped, one)
            paths = [p for p, _l in bridge._leaves(init[0])]
            result["parity"] = {
                "dp_loss": dp_loss, "one_loss": l1, "reversed_loss": l1r, "paths": paths,
                "dp_vs_one": _leaf_rel_errors(g_dp, g1),
                "reversed_vs_one": _leaf_rel_errors(g1r, g1),
            }
        dist.barrier("parity")
    _rank_result(out_dir, result)


def dp_lstm_rank(out_dir: str) -> None:
    """One rank of phase 9's W5 run: ``examples.ptb_lstm``'s
    ``run_training`` at the CLI's defaults over the runner's world.  Then
    one float32 step from the initial weights with the clip at
    ``DP_LSTM_CLIP`` (engaged) on every rank's first window, against the
    chief's 1-rank step over the global rows (rank 0's, then rank 1's)."""
    import dataclasses as dc

    from distributed_tensorflow_examples_tpu_torch.data import datasets
    from distributed_tensorflow_examples_tpu_torch.examples import ptb_lstm as cli
    from distributed_tensorflow_examples_tpu_torch.models import lstm
    from distributed_tensorflow_examples_tpu_torch.parallel import dist
    from distributed_tensorflow_examples_tpu_torch.parallel.mesh import Mesh
    from distributed_tensorflow_examples_tpu_torch.train import optim, state
    from distributed_tensorflow_examples_tpu_torch.train import step as step_lib

    args = cli.build_parser().parse_args([
        f"--seed={SEED}", f"--train_steps={WORKLOAD_STEPS}", "--log_every_steps=100"])
    cfg = cli.config_from_args(args)
    rec = dp_step_hook()
    exp = cli.run_training(args, extra_hooks=[rec])
    result = {
        "rank": dist.process_index(), "backend": dist.backend(), "device": str(exp.device),
        "steps": rec.steps, "param_sha256": state.params_sha256(exp.state.params),
        "valid_perplexity": exp.valid_perplexity,
    }
    n, rank = dist.process_count(), dist.process_index()
    train_ids, _v, _voc, _src = datasets.ptb(None, vocab_size=args.vocab_size, seed=SEED)
    block, rows = len(train_ids) // n, args.batch_size // n
    windows = [{k: torch.from_numpy(v).to(exp.device) for k, v in next(datasets.lm_batches(
        train_ids[r * block:(r + 1) * block], batch_size=rows, seq_len=args.seq_len)).items()}
        for r in range(n)]

    c32 = dc.replace(cfg, compute_dtype="float32")

    def update(batch, mesh):
        """The first update (after - before, per leaf) from the initial
        weights on ``batch``."""
        init = lstm.init_numpy(c32, SEED, batch_size=batch["x"].shape[0])
        opt = optim.SGD(args.learning_rate, clip_norm=DP_LSTM_CLIP)
        st = state.create_state(lambda seed: init, opt, SEED, exp.device)
        before = [p.detach().clone() for p in state.leaves(st.params)]
        st, _m = step_lib.build_train_step(lstm.loss_fn(c32), opt, mesh=mesh)(st, batch)
        return [(a.detach() - b).cpu() for a, b in zip(state.leaves(st.params), before)]

    dp_update = update(windows[rank], exp.mesh)
    if dist.is_chief():
        one = Mesh(device=exp.device, shape={"data": 1})
        glob = {k: torch.cat([w[k] for w in windows]) for k in windows[0]}

        params = state.as_param_leaves(lstm.init_numpy(c32, SEED, batch_size=1)[0],
                                       exp.device)
        carry = state.as_state_leaves(lstm.zero_carry(c32, args.batch_size), exp.device)
        lstm.loss_fn(c32)(params, carry, glob, None)[0].backward()
        norm = float(torch.sqrt(sum(p.grad.square().sum() for p in state.leaves(params))))
        one_update = update(glob, one)
        result["parity"] = {"global_grad_norm": norm, "clip_norm": DP_LSTM_CLIP,
                            "dp_vs_one": _leaf_rel_errors(dp_update, one_update)}
    dist.barrier("parity")
    _rank_result(out_dir, result)


#: Phase 9's probe: NCCL with two ranks on one card (its own error is the
#: reason the two ranks that share the card take gloo).
DP_NCCL_PROBE = """
import torch, torch.distributed as tdist
from distributed_tensorflow_examples_tpu_torch.parallel import dist
cfg = dist.resolve_cluster()
torch.cuda.set_device(0)
try:
    tdist.init_process_group("nccl", init_method=f"tcp://{cfg.coordinator_address}",
                             rank=cfg.process_id, world_size=cfg.num_processes,
                             device_id=torch.device("cuda", 0))
    t = torch.ones(1, device="cuda")
    tdist.all_reduce(t)
    torch.cuda.synchronize()
    print("NCCL_OK", t.item(), flush=True)
except Exception as e:
    print("NCCL_ERROR", repr(e)[:1500].replace(chr(10), " "), flush=True)
"""


def _run_ranks(n: int, call: str, timeout: float) -> tuple[list, list, str]:
    """Run ``chip_smoke.<call>`` (``{out}`` names the result directory) on
    ``n`` ranks of the port's ``MultiProcessRunner`` on the card; returns
    (exit codes, outputs, result directory).  A failing rank fails the
    phase."""
    import tempfile

    from distributed_tensorflow_examples_tpu_torch.utils.multiprocess import MultiProcessRunner

    out = tempfile.mkdtemp(prefix="dtx_dp_")
    src = f"import chip_smoke\nchip_smoke.{call.format(out=out)}\n"
    runner = MultiProcessRunner(n, src, device=None, timeout=timeout)
    t0 = time.perf_counter()
    runner.start()
    codes = runner.join()
    outs = [runner.output(i) for i in range(n)]
    log(f"  {n} rank(s) of {call.split('(')[0]} exited {codes} in "
        f"{time.perf_counter() - t0:.1f} s")
    if any(c != 0 for c in codes):
        for i, o in enumerate(outs):
            log(f"  --- rank {i} (exit {codes[i]}), last lines ---\n" + "\n".join(o.splitlines()[-40:]))
        raise SystemExit(f"a data-parallel rank failed: exit codes {codes}")
    runner.cleanup()
    return codes, outs, out


def _read_ranks(out: str, n: int) -> list:
    return [json.loads((Path(out) / f"rank{i}.json").read_text()) for i in range(n)]


def _traffic_line(step: dict) -> str:
    t = step["traffic"]
    tags = sorted({k.rsplit("_", 1)[0] for k in t})
    return ", ".join(f"{tag} {t.get(tag + '_calls', 0)} call(s) / "
                     f"{t.get(tag + '_bytes', 0) / 1e6:.3f} MB / "
                     f"{t.get(tag + '_seconds', 0) * 1e3:.1f} ms of host time" for tag in tags)


def data_parallel_end_to_end(card: str, phase5: dict) -> dict:
    """Sync data parallelism on the card (the module docstring's phase 9);
    returns each run's step ms and the BN kernels' launches by rank."""
    # The probe's two processes fail in NCCL's start within seconds, while
    # the world of one still imports: it runs beside that run's start-up.
    probe = dp_nccl_probe_start()
    resnet_nccl1 = dp_resnet_nccl(card, phase5)
    dp_nccl_probe_report(probe)
    return {"resnet_dp2": dp_resnet(card, phase5), "resnet_nccl1": resnet_nccl1,
            "lstm_dp2": dp_lstm(card)}


def dp_nccl_probe_start():
    """Start two ranks that try NCCL on the one card."""
    from distributed_tensorflow_examples_tpu_torch.utils.multiprocess import MultiProcessRunner

    runner = MultiProcessRunner(DP_RANKS, DP_NCCL_PROBE, prelude=False, device=None,
                                timeout=60, env={"NCCL_DEBUG": "WARN"})
    runner.start()
    return runner


def dp_nccl_probe_report(runner) -> None:
    """Print what NCCL said to the probe's two ranks."""
    log("  two ranks with NCCL on one card (the backend rule's case): probe, run beside the "
        "world of one's start-up")
    codes = runner.join()
    outs = [runner.output(i) for i in range(DP_RANKS)]
    runner.cleanup()
    for i, o in enumerate(outs):
        said = [l for l in o.splitlines() if l.startswith(("NCCL_OK", "NCCL_ERROR"))
                or "NCCL WARN" in l or "Duplicate GPU" in l]
        log(f"    rank {i} (exit {codes[i]}): " + (" | ".join(said[:4]) if said else
                                                   "no NCCL result (hung or killed)"))
    if all(any(l.startswith("NCCL_OK") for l in o.splitlines()) for o in outs):
        log("    NCCL took two ranks on one card here; the backend rule still gives gloo to "
            "ranks that share a card")
    else:
        log("    so the two ranks that share the card run on gloo (CUDA tensors), by the "
            "backend rule (parallel/dist.py::backend_for)")


def dp_resnet(card: str, phase5: dict) -> dict:
    """ResNet-50 on ``DP_RANKS`` ranks sharing the card, gloo, with the
    parity step."""
    log(f"  ResNet-50 on {DP_RANKS} ranks sharing the card: global batch {RESNET_BATCH} "
        f"({RESNET_BATCH // DP_RANKS} a rank), {RESNET_STEPS} steps, fused statistics")
    _codes, outs, out = _run_ranks(
        DP_RANKS, f"dp_resnet_rank({{out!r}}, {RESNET_STEPS}, {DP_PROFILE_STEP}, True)", 600)
    ranks = _read_ranks(out, DP_RANKS)
    n_bn = len(resnet50_bn_shapes(RESNET_BATCH // DP_RANKS, RESNET_IMAGE))
    finals = [[l for l in o.splitlines() if l.startswith("FINAL ")] for o in outs]
    for r in ranks:
        log(f"    rank {r['rank']}: backend {r['backend']} on {r['device']}, mesh {r['mesh']}, "
            f"{r['wall_s']:.1f} s (data, init, steps, eval), peak {r['peak_gib']:.1f} GiB; "
            "steps: " + ", ".join(f"{s['step']}: loss {s['loss']:.4f} in {s['ms']:.1f} ms, "
                                  f"BN launches {s['launches']['bn_stats']}/"
                                  f"{s['launches']['bn_bwd_stats']}" for s in r["steps"]))
    log(f"    FINAL lines by rank: {[len(f) for f in finals]}: {finals[0][:1]}")
    if any(r["backend"] != "gloo" or not r["device"].startswith("cuda") for r in ranks):
        raise SystemExit("the ranks sharing the card did not take gloo on CUDA devices")
    if len(finals[0]) != 1 or any(finals[1:]) or "test_accuracy=" not in finals[0][0]:
        raise SystemExit("the FINAL line must come from the chief alone")
    if len({r["param_sha256"] for r in ranks}) != 1 or len({r["stats_sha256"] for r in ranks}) != 1:
        raise SystemExit("the replicas' parameters or running stats differ at the end")
    want = {"bn_stats": n_bn, "bn_bwd_stats": n_bn}
    if any(s["launches"] != want for r in ranks for s in r["steps"]) or any(
            sum(r["eval_launches"].values()) for r in ranks):
        raise SystemExit(f"each rank must launch {n_bn} of each BN kernel a step, none in eval")
    losses = [s["loss"] for s in ranks[0]["steps"]]
    start = math.log(1000) + ranks[0]["l2_term"]
    if not all(math.isfinite(x) for x in losses) or abs(losses[0] - start) > TOL_RESNET_START \
            or not losses[-1] < losses[0]:
        raise SystemExit(f"2-rank ResNet losses did not start near {start:.3f} and fall: {losses}")
    par = ranks[0]["parity"]
    paths = par["paths"]
    affine = [i for i, p in enumerate(paths) if p.endswith(("scale", "bias"))]
    med = {k: float(np.median(par[k])) for k in ("dp_vs_one", "reversed_vs_one")}
    mx = {k: max(par[k]) for k in ("dp_vs_one", "reversed_vs_one")}
    head = par["dp_vs_one"][paths.index("head/kernel")]
    loss_gap = abs(par["dp_loss"] - par["one_loss"])
    log(f"    parity, float32 at batch {RESNET_CMP_BATCH} ({RESNET_CMP_BATCH // DP_RANKS} a rank): "
        f"loss {par['dp_loss']:.6f} (2 ranks) vs {par['one_loss']:.6f} (1 rank) (|d| "
        f"{loss_gap:.2e}, tol {TOL_RESNET_LOSS:g}; the batch reversed on 1 rank: |d| "
        f"{abs(par['reversed_loss'] - par['one_loss']):.2e}); per-leaf gradient error 2-rank vs "
        f"1-rank median {med['dp_vs_one']:.3e}, max {mx['dp_vs_one']:.3e} at "
        f"{paths[int(np.argmax(par['dp_vs_one']))]}, head {head:.3e} (tol {TOL_RESNET_HEAD:g}), "
        f"BN scale/bias max {max(par['dp_vs_one'][i] for i in affine):.3e}; the float32 noise "
        f"floor (1 rank, batch reversed) median {med['reversed_vs_one']:.3e}, max "
        f"{mx['reversed_vs_one']:.3e} (the 2-rank step within {TOL_DP_VS_NOISE:g}x of it, or "
        f"{TOL_RESNET_GRAD:g})")
    if not (loss_gap <= TOL_RESNET_LOSS and head <= TOL_RESNET_HEAD and all(
            m["dp_vs_one"] <= max(TOL_DP_VS_NOISE * m["reversed_vs_one"], TOL_RESNET_GRAD)
            for m in (med, mx))):
        raise SystemExit("the 2-rank ResNet step disagrees with the 1-rank step on the global batch")
    step_ms = float(np.median([s["ms"] for s in ranks[0]["steps"][1:] if not s["profiled"]]))
    one = next(s for s in ranks[0]["steps"][1:] if not s["profiled"])
    log(f"    e2e: step {step_ms:.1f} ms (rank 0, median of steps 2-{RESNET_STEPS} without the "
        f"profiled one), {RESNET_BATCH / (step_ms / 1e3):.0f} global images/s (phase 5, one "
        f"rank, batch {RESNET_BATCH}: {phase5['step_ms']:.1f} ms; step 1 loss {losses[0]:.4f} "
        f"vs phase 5's {phase5['first_loss']:.4f}, ln 1000 + l2 {start:.4f}) [{card}]")
    log(f"    all-reduce a step, each rank: {_traffic_line(one)}")
    for r in ranks:
        p = r["profile"]
        log(f"    rank {r['rank']} profiled step {DP_PROFILE_STEP}: {p['step_ms']:.1f} ms, device "
            f"busy {p['busy_ms']:.1f} ms ({p['kernels']} kernels), idle share "
            f"{p['idle_share']:.1%} of its step")
    return {"step_ms": step_ms, "launches": [r["launches"] for r in ranks]}


def dp_resnet_nccl(card: str, phase5: dict) -> dict:
    """The ResNet-50 step on a world of one rank with NCCL."""
    log(f"  ResNet-50 on one rank with NCCL (a world of 1: a real communicator), "
        f"{DP_NCCL_STEPS} steps at batch {RESNET_BATCH}")
    _codes, _outs, out = _run_ranks(
        1, f"dp_resnet_rank({{out!r}}, {DP_NCCL_STEPS}, {DP_NCCL_STEPS}, False)", 600)
    (nccl,) = _read_ranks(out, 1)
    if nccl["backend"] != "nccl":
        raise SystemExit(f"a world of one rank on one card took {nccl['backend']}, not nccl")
    nccl_ms = float(np.median([s["ms"] for s in nccl["steps"][1:] if not s["profiled"]]))
    p = nccl["profile"]
    log(f"    backend {nccl['backend']} on {nccl['device']}: step {nccl_ms:.1f} ms (median of steps 2-"
        f"{DP_NCCL_STEPS - 1}) beside phase 5's {phase5['step_ms']:.1f} ms; all-reduce a step: "
        f"{_traffic_line(nccl['steps'][1])}; profiled step: {p['nccl_kernels']} NCCL kernel "
        f"launch(es), busy {p['busy_ms']:.1f} ms of {p['step_ms']:.1f} [{card}]")
    if any(s["traffic"].get("grads_calls") != 1 for s in nccl["steps"]):
        raise SystemExit("the NCCL world of one did not all-reduce its gradients every step")
    return {"step_ms": nccl_ms, "launches": [nccl["launches"]]}


def dp_lstm(card: str) -> dict:
    """W5 at its CLI defaults on ``DP_RANKS`` ranks sharing the card."""
    log(f"  PTB LSTM (W5) at its CLI defaults on {DP_RANKS} ranks sharing the card, "
        f"{WORKLOAD_STEPS} steps")
    _codes, outs, out = _run_ranks(DP_RANKS, "dp_lstm_rank({out!r})", 600)
    ranks = _read_ranks(out, DP_RANKS)
    finals = [[l for l in o.splitlines() if l.startswith("FINAL ")] for o in outs]
    losses = [s["loss"] for s in ranks[0]["steps"]]
    par = ranks[0]["parity"]
    lstm_ms = float(np.median([s["ms"] for s in ranks[0]["steps"][1:]]))
    log(f"    {finals[0][:1]}; backends {[r['backend'] for r in ranks]}; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; valid_perplexity {ranks[0]['valid_perplexity']:.2f}")
    log(f"    clip: one float32 step from the initial weights at clip {par['clip_norm']:g} "
        f"(the global gradient's norm {par['global_grad_norm']:.4f}, so the clip scales the "
        f"step): the 2-rank update vs the 1-rank one over the global rows, per leaf max "
        f"{max(par['dp_vs_one']):.3e} (tol {TOL_DP_LSTM_UPDATE:g})")
    log(f"    e2e: step {lstm_ms:.3f} ms (rank 0, median of steps 2-{WORKLOAD_STEPS}), "
        f"{64 * 20 / (lstm_ms / 1e3):.0f} global tokens/s; all-reduce a step, each rank: "
        f"{_traffic_line(ranks[0]['steps'][1])} [{card}]")
    if len(finals[0]) != 1 or any(finals[1:]) or "valid_perplexity=" not in finals[0][0]:
        raise SystemExit("W5: the FINAL line with valid_perplexity must come from the chief alone")
    if any(r["backend"] != "gloo" for r in ranks) or len({r["param_sha256"] for r in ranks}) != 1:
        raise SystemExit("W5: the ranks did not take gloo or end with different parameters")
    if len(losses) != WORKLOAD_STEPS or not all(math.isfinite(x) for x in losses):
        raise SystemExit("W5: a loss is not finite (or steps are missing)")
    if par["global_grad_norm"] <= DP_LSTM_CLIP or max(par["dp_vs_one"]) > TOL_DP_LSTM_UPDATE:
        raise SystemExit("W5: the 2-rank clipped update disagrees with the 1-rank one")
    return {"step_ms": lstm_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from distributed_tensorflow_examples_tpu_torch.ops import _build
    from distributed_tensorflow_examples_tpu_torch.ops import bn
    from distributed_tensorflow_examples_tpu_torch.ops import flash_attention as flash

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("phase 1: build")
    sources = ["flash_fwd", "flash_bwd", "flash_fused_bwd", "bn_stats"]
    t0 = time.perf_counter()
    built = _build.build(sources)
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
        f"(per source: {json.dumps({k: round(v, 1) for k, v in built.items()})})")
    tensor_cores = check_build(_build, sources)
    check_routes(flash)

    log("phase 2: kernels against their plain versions on the card")
    # The serving path's shape: the replica pads every apply to max_batch = 2
    # rows, so each layer's call folds 2 x 8 heads into BH = 16.
    errs = [
        check_flash(flash, 16, 2048, 128, torch.bfloat16, True),
        check_flash(flash, 8, 2048, 128, torch.bfloat16, False),
        check_flash(flash, 8, 1000, 128, torch.bfloat16, True),
        check_flash(flash, 8, 2048, 64, torch.bfloat16, True),
        check_flash(flash, 8, 2048, 32, torch.bfloat16, True),
        check_flash(flash, 8, 1000, 64, torch.float32, True, out_dtype=torch.float32),
        check_flash(flash, 8, 2048, 128, torch.bfloat16, True, out_dtype=torch.float32),
        check_flash(flash, LONG_BATCH * 8, LONG_T, 128, torch.bfloat16, True),
        check_flash(flash, 3, 136, 32, torch.bfloat16, False, out_dtype=torch.float32),
    ]
    # The training path's shape: batch 8 x 8 heads = BH 64.
    train_bh = TRAIN_BATCH * 8
    bwd_errs = [
        check_flash_bwd(flash, train_bh, 2048, 128, torch.bfloat16, True, determinism=True),
        check_flash_bwd(flash, 8, 2048, 128, torch.bfloat16, False),
        check_flash_bwd(flash, 8, 1000, 128, torch.bfloat16, True),
        check_flash_bwd(flash, 8, 1000, 64, torch.bfloat16, True),
        check_flash_bwd(flash, 8, 2048, 32, torch.bfloat16, True),
        check_flash_bwd(flash, 8, 1000, 64, torch.float32, True, out_dtype=torch.float32),
        check_flash_bwd(flash, 8, 1000, 32, torch.float32, False, out_dtype=torch.float32),
    ]
    main_shape = time_flash(flash, 16, 2048, 128, torch.bfloat16, True)
    train_fwd = time_flash(flash, train_bh, 2048, 128, torch.bfloat16, True)
    long_fwd = time_flash(flash, LONG_BATCH * 8, LONG_T, 128, torch.bfloat16, True)
    time_flash(flash, 8, 2048, 128, torch.bfloat16, False)
    bwd = time_flash_bwd(flash, train_bh, 2048, 128, torch.bfloat16, True)
    # The T 8192 training path's shape: batch 2 x 8 heads = BH 16.
    long_bh = LONG_BATCH * 8
    fused_errs = [
        check_fused_bwd(flash, long_bh, LONG_T, 128, torch.bfloat16, True, determinism=True),
        check_fused_bwd(flash, 8, 2048, 128, torch.bfloat16, False),
        check_fused_bwd(flash, 8, 1000, 64, torch.bfloat16, True),
        check_fused_bwd(flash, 8, 1000, 32, torch.bfloat16, False),
        check_fused_bwd(flash, 8, 1000, 64, torch.float32, True, out_dtype=torch.float32),
        check_fused_bwd(flash, 8, 2048, 128, torch.bfloat16, True, out_dtype=torch.float32),
        check_fused_bwd(flash, 3, 320, 128, torch.bfloat16, True),
        check_fused_bwd(flash, 3, 192, 32, torch.bfloat16, False),
    ]
    fused = time_fused_bwd(flash, long_bh, LONG_T, 128, torch.bfloat16, True)
    log(f"  [{card}]")
    # ResNet-50's BatchNorm shapes at batch 256 (the stem, a stage-0 bn3, a
    # stage-3 bn3) and a ragged one (C = 24, not a multiple of 8).
    bn_errs = [
        check_bn(bn, (RESNET_BATCH, 112, 112, 64), torch.bfloat16, seed=11),
        check_bn(bn, (RESNET_BATCH, 56, 56, 256), torch.bfloat16, seed=12),
        check_bn(bn, (RESNET_BATCH, 7, 7, 2048), torch.bfloat16, seed=13),
        check_bn(bn, (3, 5, 7, 24), torch.float32, seed=14),
    ]
    bn_times = time_bn(bn, card)

    log("phase 2b: the fused backward's parity gate (twin of tools/flash_parity.py)")
    from distributed_tensorflow_examples_tpu_torch.tools import flash_parity

    parity = flash_parity.run(quick=False, segmented=False, device="cuda")
    log(f"  {json.dumps(parity)}")
    if not parity["parity_ok"]:
        raise SystemExit("the fused backward failed its parity gate")

    log("phase 3: serve the flagship transformer end to end")
    serve_launches, serve_tc = serve_end_to_end(card)

    log("phase 4: train the flagship transformer end to end")
    kernel_ms = {"flash_fwd": train_fwd["ms"], **{k: v["ms"] for k, v in bwd.items()}}
    train_launches, train_tc = train_end_to_end(card, kernel_ms)

    log("phase 5: train ResNet-50 end to end with the fused BatchNorm statistics")
    resnet_launches, resnet_run = resnet_end_to_end(card)

    log(f"phase 6: train the flagship at T {LONG_T} end to end through the fused backward")
    long_launches, long_tc = train_long_end_to_end(card, fused["ms"], long_fwd["ms"])

    log("phase 7: train the four reference workloads (MNIST MLP, CIFAR-10 CNN, word2vec, "
        "PTB LSTM) through their CLIs")
    workloads = workloads_end_to_end(card)
    log("  workloads: " + json.dumps({k: {m: round(v, 6) for m, v in r.items()}
                                      for k, r in workloads.items()}))

    log("phase 8: the PS emulation (W1 sync-replicas, W2 async) through the MNIST and "
        "CIFAR-10 CLIs")
    ps = ps_emulation_end_to_end(card)
    log("  ps_emulation: " + json.dumps({k: {m: (round(v, 6) if isinstance(v, float) else v)
                                             for m, v in r.items()} for k, r in ps.items()}))

    log("phase 9: synchronous data parallelism on the card (ResNet-50 W3 and the PTB LSTM "
        f"W5 on {DP_RANKS} ranks sharing it, gloo; ResNet-50 on a world of one, nccl)")
    torch.cuda.empty_cache()  # the ranks are processes of their own
    dp = data_parallel_end_to_end(card, resnet_run)
    dp_launches = {name: [r.get(name, 0) for r in dp["resnet_dp2"]["launches"]]
                   for name in ("bn_stats", "bn_bwd_stats")}
    nccl_launches = {name: dp["resnet_nccl1"]["launches"][0].get(name, 0)
                     for name in ("bn_stats", "bn_bwd_stats")}

    csrc = "distributed_tensorflow_examples_tpu_torch/ops/csrc"
    tpu = "distributed_tensorflow_examples_tpu/ops/flash_attention.py"
    record = {"kernels": [
        {
            "name": "flash_fwd", "route": "cuda", "source": f"{csrc}/flash_fwd.cu",
            "replaces": f"{tpu}:135",
            "launches": serve_launches.get("flash_fwd", 0)
            + train_launches.get("flash_fwd", 0) + long_launches.get("flash_fwd", 0),
            "launches_by_path": {"serve": serve_launches.get("flash_fwd", 0),
                                 "train": train_launches.get("flash_fwd", 0),
                                 "train_t8192": long_launches.get("flash_fwd", 0)},
            "tensor_core_launches": serve_tc.get("flash_fwd", 0)
            + train_tc.get("flash_fwd", 0) + long_tc.get("flash_fwd", 0),
            "max_abs_err": max(errs), **main_shape,
            "tensor_core_instructions": tensor_cores["flash_fwd"],
            "at_shapes": {"[16, 2048, 128]": main_shape, "[64, 2048, 128]": train_fwd,
                          "[16, 8192, 128]": long_fwd},
        },
        *({
            "name": name, "route": "cuda", "source": f"{csrc}/flash_bwd.cu",
            "replaces": f"{tpu}:{line}",
            "launches": train_launches.get(name, 0) + long_launches.get(name, 0),
            "launches_by_path": {"train": train_launches.get(name, 0),
                                 "train_t8192": long_launches.get(name, 0)},
            "tensor_core_launches": train_tc.get(name, 0) + long_tc.get(name, 0),
            "max_abs_err": max(e[name] for e in bwd_errs), **bwd[name],
            "tensor_core_instructions": tensor_cores[name],
        } for name, line in (("flash_dq", 211), ("flash_dkv", 244))),
        {
            "name": "flash_fused_bwd", "route": "cuda",
            "source": f"{csrc}/flash_fused_bwd.cu", "replaces": f"{tpu}:518",
            "launches": long_launches.get("flash_fused_bwd", 0),
            "launches_by_path": {"train_t8192": long_launches.get("flash_fused_bwd", 0)},
            "tensor_core_launches": long_tc.get("flash_fused_bwd", 0),
            "max_abs_err": max(fused_errs), **fused,
            "tensor_core_instructions": tensor_cores["flash_fused_bwd"],
        },
        *({
            "name": name, "route": "cuda", "source": f"{csrc}/bn_stats.cu",
            "replaces": f"distributed_tensorflow_examples_tpu/ops/bn.py:{line}",
            "launches": resnet_launches.get(name, 0) + sum(dp_launches[name])
            + nccl_launches[name],
            "launches_by_path": {"train_resnet50": resnet_launches.get(name, 0),
                                 "train_resnet50_dp2_by_rank": dp_launches[name],
                                 "train_resnet50_nccl1": nccl_launches[name]},
            "max_abs_err": max(e[name] for e in bn_errs), **bn_times[name],
        } for name, line in (("bn_stats", 166), ("bn_bwd_stats", 239))),
    ]}
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
