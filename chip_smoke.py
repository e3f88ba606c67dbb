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
   ``flash_dkv_tc_kernel``, ``flash_fused_bwd_tc_kernel``: each one's
   bf16-out and f32-out instances per head dim and its check-only
   recording ones at D 32 and 64); the run fails if one of those spills,
   has no ptxas report or none, or if ``cuobjdump`` is missing.  Each
   flash library must also report (``dtx_<kernel>_route``) the
   tensor-core kernel for bf16 in with bf16 or f32 out, with the tiles the
   plain version walks, and the CUDA-core one for f32 in.
2. Kernels against their plain PyTorch versions on the card, at the shapes
   the main paths give them and at the edges the kernels must also take
   (ragged T, head dims 32/64, float32 in and out, non-causal), with the
   tolerances stated below; the backward kernels must also give the same
   bits on a second run.  Every flash kernel at bf16 in and f32 out (the
   flash ring's hops, on the tensor cores) is held not by a tolerance but
   by two checks (``check_split_f32``, ``check_fwd_f32``,
   ``check_fused_f32``), causal and full at [8, 2048, 128], [8, 1000, 64]
   and [8, 200, 32] (the forward also full at [3, 136, 32]), causal at
   [2, 2048, 64] (the forward and the fused backward) and causal at the
   hop shape [16, 4096, 128]: (a) its f32 result rounded to bf16 (round to
   nearest even, as the bf16 instance rounds) equals the bf16-out kernel's
   bit for bit (the forward's lse too), and a second launch is bitwise the
   first; (b) at T 2048 (D 64, BH 2), 1000 and 200 and below (the records
   are T^2 a head), the check-only recording instances give the f32
   result bit for bit and the bf16 p and ds (the forward: p and each
   row's running max after every k tile) they used; fed those, the plain
   walks reproduce the result within ``TOL_BWD[float32]`` (the forward: o
   within ``TOL_O[float32]``, lse within ``TOL_LSE``), and each recorded p
   lies within one bf16 step, each ds and each running max within the
   bound that ``tools/flash_rounding.py`` states, of the plain walk's own;
   the shares of p and ds that flipped are printed.  Then each kernel, its
   plain version and the
   PyTorch call computing the same function (``scaled_dot_product_attention``
   and its backward, timed as a yardstick only; the port never calls
   either) are timed with CUDA events at the main path's shape, with the
   achieved TFLOP/s of the forward and the fused backward; the forward
   also at the training shapes [64, 2048, 128] and [16, 8192, 128].  The
   BatchNorm statistics kernels (``bn_stats``, ``bn_bwd_stats`` with and
   without the ReLU mask) likewise, at ResNet-50's shapes (the stem, the
   most frequent [256, 14, 14, 256], the smallest [256, 7, 7, 512], two
   wider ones), a shape of one block, ragged channel strips over many
   blocks (C 264 bf16 at 16-byte loads, C 100 bf16 one element a load)
   and a ragged f32 one, bitwise equal run to run, and timed against
   ``torch.batch_norm_stats`` / ``torch.batch_norm_backward_reduce`` (the
   yardsticks; the port calls neither) at the stem's shape and summed over
   the 53 BatchNorm shapes of one training step, with each kernel's
   device time by shape from ``torch.profiler`` beside the events' ms
   (``tools/flash_bench.py::time_bn``).  The fused backward
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
   16-token prompt from the synthetic corpus and 32 greedy tokens, first
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
   ``attention="xla"`` step.  The last step but one runs in a one-step
   ``ProfilerHook`` window (the port's ``--profile``): its Chrome trace
   must be written, and ``tools/profile_step.py``'s reader must find 12
   launches of each of the forward, dq and dk/dv kernels in it; printed:
   the step's device time by kernel family, the idle share, the longest
   idle gaps and the seconds the trace took to write.
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
   ``torch.profiler``: it must show 53 launches of ``bn_stats``'s one
   kernel (``bn_stats_onepass``) and 53 of each of ``bn_bwd_stats``'s two
   (``bn_bwd_stats_partial``, ``bn_stats_finalize``), so no second B6
   kernel.
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
   ``utils.determinism``, whose process-wide settings are put back when
   the phase ends: ``torch_settings_restored``).  Each must print the JAX
   PS FINAL line (its ``mode``, ``step=200``, ``stale_dropped``), log only
   finite losses and
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
   Beside it (the two runs side by side: ``side_by_side``; their
   host-bound numbers carry each other's load), the PTB LSTM (W5) at its
   CLI defaults on ``DP_RANKS`` ranks (32
   rows a rank, each a contiguous block of the stream and its own carry),
   ``WORKLOAD_STEPS`` steps: gloo, bitwise-equal parameters, finite
   losses, FINAL with ``valid_perplexity`` from the chief, and the first
   update against a 1-rank step over the global rows (the clip on the
   global gradient; float32, the clip engaged) within
   ``TOL_DP_LSTM_UPDATE``; step ms and tokens/s.
   ``chip_smoke.data_parallel_end_to_end(card, phase5)`` runs this phase
   alone.

10. W1 and W2 in their reference shape: for each, a PS task, the chief and
   two workers, each a process of the port's CLI (``python -m
   distributed_tensorflow_examples_tpu_torch.examples.<cli> --job_name=...
   --task_index=...``, ``--ps_hosts`` one loopback port, ``--worker_hosts=
   a:1,b:1``, ``OMP_NUM_THREADS=1``), all started together, the two
   clusters side by side: MNIST MLP
   ``--ps_emulation`` and CIFAR-10 CNN ``--sync_replicas=false
   --max_staleness=4``, ``PS_STEPS`` applied steps each.  The PS task is
   host-only (supervised, ``--ps_restarts`` at its default); the chief and
   the workers run on the card.  Gates: every process exits 0 on its own
   within ``PS_CLUSTER_LIMIT_S``; the chief prints ``CHIEF_PLATFORM=gpu``
   and the JAX cluster FINAL line (``mode=sync_replicas_cluster`` or
   ``async_cluster``, ``workers=2``, finite numbers); both workers
   contributed; the PS prints ``PS_DONE`` and created no CUDA context; the
   chief and the workers report ``cuda``.  Printed beside phase 8's
   in-process figures: applied steps/s and examples/s per chip over the
   second half of the applies, ``stale_dropped`` and dedups, the chief's
   host update + publish ms, each worker's median token wait, pull,
   gradient and push ms, the wire bytes an applied step, and the phase's
   wall seconds.  ``chip_smoke.ps_cluster_end_to_end(card, {})`` runs it
   alone (no kernel needs building).  Its ports lie below the host's
   ephemeral range (``utils.multiprocess.free_ports``), and a process that
   fails stops the whole cluster at once (``ProcessCluster``).

11. The sharded, replicated, elastic PS and a serve replica tracking it,
   two clusters of the port's CLIs started together (phases 1-10 as
   before).  ``w2_async_2x2``: CIFAR-10 CNN ``--sync_replicas=false
   --max_staleness=4``, ``PS_STEPS`` applies, at ``--ps_shards=2
   --ps_replicas=2`` (4 supervised host-only PS tasks, ``--ps_hosts``
   replica-major), the chief and 2 workers on the card, and one
   ``--job_name=serve`` replica on the card.  Once the replica reports its
   first snapshot, a client here predicts a fixed CIFAR batch of 8 rows
   through the port's ``ServeClient`` for as long as the run trains.
   ``DTX_FAULT_PLAN`` kills ps0, shard 0's primary, after
   ``PS_KILL_AFTER_REQS`` requests (about a third of the run).  Gates:
   every process exits 0; ``CHIEF_PLATFORM=gpu``; FINAL
   ``mode=async_cluster workers=2`` with finite numbers; the chief's
   ``reseeds`` 0; both workers contributed; no PS task created a CUDA
   context; every predict answered with finite logits [8, 10]; the stamped
   step never went backwards and rose at least 3 times; ``SERVE_DONE``.
   Printed beside phase 10's 1-shard W2: applied steps/s and ms an applied
   step over the second half, the chief's update + publish ms, each
   worker's medians, wire MB an apply, the longest gap between two applies
   (the failover's cost), the predicts' count and p50/p99 client latency,
   and the replica's refresh count.  ``w1_sync_reshard``: MNIST MLP
   ``--ps_emulation`` at 2 shards, ``--ps_layout_version=1``,
   ``RESHARD_STEPS`` applies (``PS_STEPS`` would end before a joiner is
   up); once the chief has published step ``RESHARD_AT_STEP`` (read from
   the store's metadata), 3 joiner PS tasks start with
   ``--ps_reshard_to=2:<3 hosts>`` (the JAX ``tools/loadsim.py`` reshard
   scenario).  Gates: every process exits 0, the retired tier too; the
   epoch-2 record committed; the chief's ``reseeds`` 0 and ``reshards``
   1; FINAL ``step=RESHARD_STEPS mode=sync_replicas_cluster workers=2``;
   both workers contributed after the commit.  Printed: the commit time (s from the joiners' spawn to the
   committed record) and ms an applied step before and after.
   ``chip_smoke.ps_sharded_end_to_end(card, {})`` runs it alone.

12. The ``model`` mesh axis and ZeRO-1, every rank a process of the port's
   ``MultiProcessRunner`` on the card (gloo: the ranks share it).  (a) W4
   word2vec and (b) W5 PTB LSTM through their CLIs' ``run_training`` at
   the CLI defaults (W4: vocab 10000, dim 128, 64 negatives, batch 256;
   W5: vocab 10000, width 200, 2 layers, batch 64 x 20) with
   ``--mesh=data=1,model=2`` (``MA_MESH``), ``WORKLOAD_STEPS`` steps
   each, in the same two rank processes (``ma_rank``).  Gates: each rank's
   device ``cuda`` and backend gloo; the ranks are the model axis's two
   positions; each rank holds 5000 of the 10000 rows of ``emb/table`` and
   ``nce/weights`` (W5: of ``emb/table``, and 5000 of the softmax's 10000
   columns); the replicated leaves bitwise equal on both ranks; FINAL from
   the chief alone with a finite ``eval_loss`` / ``valid_perplexity``; no
   hand kernel launched; one float32 step from the initial weights (W5
   with its clip at ``DP_LSTM_CLIP``, below the global gradient's norm)
   against the chief's 1-rank step on the same batch (W4: and the same
   negatives, id for id): the loss within ``TOL_MA_LOSS_REL``, every
   parameter, the tables put together, within ``TOL_MA_PARAM``.  Printed:
   step ms, examples/s or tokens/s, each rank's collective account of a
   step (``utils/hlo_analysis.py``: kind, calls, bytes and host ms by tag)
   and one profiled step's device busy ms and idle share; W4 fails if any
   collective of any step moved a tensor as large as a whole [V, D] table
   (the JAX HLO test's verdict).  Beside (a) and (b), (c) ResNet-50 (W3) with ``--zero_opt`` and
   then without, on
   ``DP_RANKS`` data ranks at phase 9's global batch and width,
   ``ZERO_STEPS`` steps each from the same weights and batches, cuDNN
   deterministic (``zero_resnet_rank``): the parameters bitwise equal (or
   within ``TOL_DP_VS_NOISE`` of the float32 noise floor, a second
   replicated run, when not); each rank's optimizer bytes (every tensor
   the optimizer holds beyond the parameters, ``optim.state_bytes``) its
   half of every slot ZeRO-1 shards plus the small leaves whole, so no
   copy of a parameter's block beside them; 53 launches of each BN
   kernel a step, as in phase 9.  Printed: step ms beside phase 9's, and
   the optimizer bytes a rank.  ``chip_smoke.model_axis_end_to_end(card)``
   runs this phase alone (the BN kernels built first, as for phase 9).

13. The data planes and deploys at full width.  The data:
   ``imagenet_synthetic`` at ``RESNET_IMAGE``^2 and 1000 classes, 1280
   images quantised to uint8 once (the record type a real ImageNet shard
   set holds; it exercises the u8 decode), written by the port's writers
   in shards of ``D13_SHARD_RECORDS``: 4 train shards and 1 held out, in
   ``.dtxr`` and ``.npz``.  (a) ResNet-50 through
   ``examples.resnet50.run_training`` with the fused statistics path, as in
   phase 5, ``RESNET_STEPS`` steps at batch ``RESNET_BATCH`` from the
   ``.dtxr`` directory (the native C++ loader), (b) the same from the
   ``.npz`` directory (``FileStreamPipeline``), (c) the same from
   ``--data_dir=dsvc://127.0.0.1:<port>``, served by a supervised
   ``--job_name=data_service`` task process over the ``.npz`` directory.
   Gates for each: every batch of ``RESNET_BATCH`` rows, losses finite,
   step 1 within ``TOL_RESNET_START`` of ln(1000) + l2, 53 launches of
   each BN kernel a step, and the eval on the held-out shard.  Printed
   beside phase 5's in-memory step: step ms and images/s, the training
   loop's wait for a host batch a step, and (a) the loader's
   ``batches_produced``, (a, b) the decode ms a batch, (b) the pipeline's
   ``stats``, (c) the wire MB a batch and the prefetcher's waits.
   (d) W2 in its reference shape reading a data service: the CIFAR-10 CNN
   at its CLI defaults, async, a supervised PS task, the chief and 2
   workers (as in phase 10) on ``--data_dir=dsvc://...`` from one
   supervised data_service task over port-written CIFAR-10 synthetic
   ``.npz`` shards, which ``DTX_FAULT_PLAN=die:role=data_service0,
   after_reqs=DSVC_KILL_AFTER_REQS`` kills once mid-epoch.  Gates: phase
   10's, FINAL ``step=PS_STEPS mode=async_cluster workers=2``; the task
   restarted once; both workers' clients logged ``dsvc_reincarnation``;
   the restarted service completed an epoch with every split visited; no
   hand kernel launched.  (e) A canary deploy of the W2 CNN on port
   replicas pinned on the card (``make_pinned_factory``,
   ``RollingDeploy``): version 1 the initial weights, version 2 after
   ``DEPLOY_TRAIN_STEPS`` steps, both published to a registry; 2 replicas
   at version 1 with a client thread predicting throughout; a canary
   replica at version 2 with weight 0.5 until it has
   ``DEPLOY_MIN_ANSWERS`` answers, ``canary_verdict``, the promote; then a
   second deploy (version 1 again) rolled back.  Gates: zero failed
   predicts; every answer carries version 1 or 2 and its logits lie within
   ``TOL_DEPLOY_LOGITS`` of that version's apply on the card; after the
   promote the pool is all version 2 (no version 1 answer until the second
   deploy), and the rollback leaves it non-empty.  Printed: the predicts,
   p50 and p99 per version and the flip's seconds.
   ``chip_smoke.data_planes_end_to_end(card)`` runs this phase alone (the
   BN kernels built first, as for phase 9).

14. The flagship on a ``data`` x ``seq`` x ``model`` mesh at full width:
   phase 6's model, weights and batch (vocab 32000, dim 1024, 12 layers,
   8 heads, bf16, T 8192, batch 2), ``SP_STEPS`` steps a run through
   ``examples.transformer_lm.run_training`` on gloo ranks sharing the
   card (``sp_rank``): (a) ``--mesh=data=1,seq=2`` on 2 ranks with
   ``DTX_FUSED_BWD=1``, the flash ring with the forward and the fused
   backward per hop; (b) ``--mesh=data=1,seq=2,model=2`` on 4 ranks, the
   split backward (``DTX_FUSED_BWD=0``), the ring's forward, dq and dk/dv
   per hop under Megatron TP; (c) as (b) with ``--attention=ulysses``:
   the all-to-all, then the tensor-core flash kernels over the whole
   sequence.  (b) and (c) share one set of processes, spawned beside (a)'s
   (their host-bound numbers carry each other's load).  First, each flash
   kernel at a hop's shape [16, 4096, 128], bf16 in, timed with float32
   out (the route every hop takes: the tensor cores, as the libraries
   report) beside bf16 out (the tensor cores) and SDPA at float32, causal
   and full (``time_hop_routes``, by ``tools/flash_bench.py``).  Gates: every rank's
   steps 1-``SP_STEPS`` within ``TOL_SP_LOSS`` of phase 6's one-process
   steps on the same weights, batch and learning rate (steps 2 and 3
   carry the mesh's gradients: the ring's backward, the seq mean, the
   Megatron sums), and its loss falling;
   every step's launches on each rank exactly the causal ring's (seq
   index + 1 hops a layer, every one on the tensor cores) or Ulysses' (one
   tensor-core call a layer); and, on the (a) ranks, the attention gate:
   ``ring_flash_attention`` over layer 0's q/k/v (the rank's slice) with
   fused and then split hops against the same ring with the plain
   versions and against one-rank ``flash_attention`` over the whole
   sequence, phase 2's bf16 tolerances, every hop on the tensor cores
   (``sp_attention_gate``).  Printed
   per run: step ms and tokens/s, the ``seq_ring``/``seq_a2a``/model
   collectives a step (calls, MB, host ms), each rank's profiled device
   busy ms and idle share, launches a step by rank.

15. The MoE flagship of the JAX package's ``bench_moe`` (vocab 32000, dim
   1024, 12 layers, 8 heads, 8 experts, top-2, capacity factor 1.25,
   routing groups of 1024, T 2048, batch 4, bf16, clip 1.0 + AdamW 1e-3;
   924M parameters from JAX ``init``'s numbers for seed 0), depth not
   cut.  (a) ``MOE_STEPS`` steps through
   ``examples.transformer_lm.run_training`` on one process, published to
   a registry: step 1's loss within 0.5 of ln(32000) (the loss trained is
   the cross-entropy plus 0.01 aux), aux finite, the loss falling; B1, B2
   and B3 each launched 12 times a step, all on the tensor cores; one
   step from the initial weights against ``attention="xla"``, routed by
   the flash step's decisions (``TOL_TRAIN_LOSS``, ``TOL_TRAIN_GRAD``;
   routed freely, the share of decisions that differ is printed beside).
   Printed: step ms, tokens/s, each layer's share of (token, choice)
   pairs past capacity at step 1, peak memory, one profiled step's device
   ms for the flash kernels, the experts' matmuls and the routing,
   dispatch and combine, and its idle share.  (b) ``--mesh=data=1,
   expert=2`` on 2 gloo ranks sharing the card (``moe_rank``), 3 steps:
   each rank holds 4 experts a layer; steps 1-3 against one process on
   the same global batches and weights (``TOL_MOE_EP_LOSS``,
   ``TOL_MOE_EP_LOSS_LATER``, with that process's flash-against-xla gaps
   as the noise floor); B1-B3 12 times a step a rank on the tensor cores;
   every step's account holds all-to-alls, all over the expert group.
   Printed: step ms, tokens/s, each rank's collective account of a step
   (``expert_a2a`` and the rest: calls, MB, host ms), each rank's busy and
   idle share.  (c) (a)'s
   published weights on a registry-pinned replica: one [1, 2048] predict
   (12 tensor-core B1 launches; its logits against ``transformer.apply``
   on the card within ``TOL_LOGITS``) and one decode session of 16 prompt
   and 16 greedy tokens on one slot, whose tokens equal ``generate``'s on
   the card, with no flash launch.

16. GPipe, the collapsed stages, decode under a model mesh and ghost-batch
   BN, on 2 gloo ranks sharing the card, spawned once (``pp_rank``; each
   rank runs (a), (b) and (c) in turn).  (a) Phase 4's flagship and batch
   with ``--pipeline_stages=2 --microbatches=4 --mesh=pipe=2``,
   ``PP_STEPS`` steps and a checkpoint: each rank holds 6 layers; every
   step launches on each rank the forward ``2 (M + S - 1) L / S`` times
   (every tick runs its stage, and the backward recomputes it) and the
   backward pair ``(M + S - 1) L / S`` times, all on the tensor cores;
   steps 1-3 within ``TOL_PP_LOSS`` of one process with
   ``--grad_accum=4`` on the same global batches and weights (the same
   microbatch sums; run here first).  Printed: step ms, tokens/s, the
   ``pipe``/``pipe_out``/``pipe_in`` collectives a step (calls, MB, host
   ms), each rank's profiled busy and idle share and launches.  (b) The
   stacked blocks gathered over pipe and collapsed
   (``checkpoint.global_params``, ``collapse_pipeline``); the chief decodes 8 greedy tokens from a
   16-token corpus prompt on its device, equal to one process decoding
   the collapsed weights of the pipe-trained checkpoint; the same weights
   laid out over a ``model=2`` mesh of the 2 ranks decode the same ids on
   both (or depart only where the replicated top-2 margin is within
   twice the largest teacher-forced logit gap, printed).  (c) ResNet-50 at
   phase 5's width and batch 256 with ``--bn_ghost_slices=2
   --mesh=slice=2`` (128 rows a rank), ``GB_STEPS`` steps on the fused
   statistics path: 53 launches of each BN kernel a step a rank, no BN
   all-reduce (each slice's statistics are its rank's), one gradient
   bucket a step over the 2 ranks, no all-reduce but the gradient bucket's
   and the metrics' crossing the slices in any step's account (the JAX HLO
   test's verdict), the FINAL line; step 1's loss and each
   rank's row of the running stats against one process's ghost path on
   the same global batch (``TOL_GB_LOSS``, ``TOL_GB_STATS``; run here
   first).

17. The port's measuring tools (the twins of the root ``tools/``), their
   card-side parts on the card, one after another, in
   ``tools_end_to_end``.  (a) ``tools/ulysses_ab.py`` at phase 14's shape
   (``--b 2 --h 8 --t 8192 --d 128 --sp 2,4``, 10 timed steps), once with
   ``DTX_FUSED_BWD`` unset (the split backward) and once set to 1 (the
   fused backward where the dispatch takes it): forward plus backward of
   Ulysses' [2, 8/sp, 8192, 128] against sp ring hops of [2, 8, 8192/sp,
   128], bf16.  Gates: rows for sp 2 and 4, every time positive; each
   run's flash launches exactly ``UA_CALLS`` x ``UA_ITERS`` forwards and as
   many backwards (fused, or a B2 and a B3 each), some fused exactly when
   ``DTX_FUSED_BWD=1``, every one on the tensor cores.  The launches join
   the flash kernels' ``launches_by_path`` (``ulysses_ab_split``,
   ``ulysses_ab_fused``).  (b) ``tools/serving_bench.py --quick
   --device=cuda``: the 512-512-128 MLP applied on the card by a
   PS-tracking replica, in the single, batched and concurrency (64 and 256
   connections) regimes.  Gates: no failed request (the tool raises on
   one) and one served prediction within ``TOL_PREDICT`` (1e-4 of the
   largest logit) of the float64 apply of the published parameters.
   ``batched_speedup`` and the p99 ratio are printed with the root's CPU
   rules' verdicts, not held.  (c) ``tools/loader_bench.py`` (8192
   records, 50 batches), ``tools/data_service_bench.py --quick`` and
   ``tools/ps_transport_bench.py --quick`` on the host.  Gates: each
   tool's ``checks`` (the batches' layout, a pull equal to the published
   vector); their rows are printed.  (d) ``tools/loadsim.py
   --scenario=canary --duration_s=30`` (a process of its own session,
   stopped past ``CANARY_LIMIT_S``): the MNIST MLP's PS, chief, 2 workers
   and pinned serve replicas as processes of the port's CLI on the card,
   a v1 -> v2 canary flip at weight 0.4 with a stable replica killed
   mid-flip.  Gates: every verdict gate of the root's canary (zero failed
   predicts, p99 under 2500 ms, 60% of 100 qps, the canary's share within
   0.12 of 0.4, the served version monotone and all v2 at the end, both
   versions answering mid-flip, the served step monotone and advancing,
   the kill fired).  Printed: each part's seconds.

18. ``tools/loadsim.py --scenario=overload`` (``overload_end_to_end``, a
   process of its own session, stopped past ``OVERLOAD_LIMIT_S``) at the
   root's defaults: the MNIST MLP's PS, chief, 2 workers and 2 replicas
   (4096 hidden units, a queue of 8 predicts, a 500 ms queue deadline,
   batches of 2; the PS and the replicas unsupervised: nothing kills
   them) as processes of the port's CLI on the card;
   16 clients paced at 100 qps over a 30 s window, and from 35% to 65% of
   it 64 unpaced clients in 4 processes sending 64-row predicts.  Gates:
   every verdict gate of the root's overload (no failed predict before
   the burst, goodput during it at least 50 qps, no lease expired, every
   member kept, p99 back under 1.5x the baseline's within 20 s of the
   burst's end, the served step monotone and advancing, and admission
   control tripped: batcher refusals or core sheds).  Printed: the
   baseline p99, the burst's goodput and its clients' and the paced
   predicts, the refusals, sheds and retry counters, the recovery, the
   lease expirations and members, the timeline.

Phase 4 still runs the split kernels: at T 2048 the blocks give
nq = nk = 2, under the fused regime.  No path is cut in depth.

The line before the last is the kernels' JSON record (the four kernels
with a tensor-core instance carry its launches on the main paths and its
SASS tensor-core instruction count, and the forward its times at the
three shapes); the last line is
``{"ok": true, "device": {...}}``.  The kernels' timers, the profiled
windows' reader and the collective account are the port's own tools
(``tools/flash_bench.py``, ``tools/profile_step.py``,
``utils/hlo_analysis.py``).  The run needs one card; it exits non-zero
without one, and without the repository beside it.
"""

from __future__ import annotations

import contextlib
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

from distributed_tensorflow_examples_tpu_torch.tools import flash_bench as fb
from distributed_tensorflow_examples_tpu_torch.tools import flash_rounding
from distributed_tensorflow_examples_tpu_torch.tools import profile_step as ps
from distributed_tensorflow_examples_tpu_torch.utils import hlo_analysis

ROOT = Path(__file__).resolve().parent
SEED = 0
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
DECODE_NEW = 32
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
#: Phase 4's profiled step (a one-step ProfilerHook window).
PROFILE_STEP = TRAIN_STEPS - 1
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
WORKLOAD_STEPS = 100
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
#: A thread's buffered log lines (``buffered``), else None: printed now.
_LOG = threading.local()


def log(msg: str) -> None:
    lines = getattr(_LOG, "lines", None)
    if lines is not None:
        lines.append(msg)
        return
    print(msg, flush=True)


def buffered(fn, *args):
    """``(fn(*args), the lines it logged)``: its log lines kept back, for a
    run beside another that logs."""
    _LOG.lines = lines = []
    try:
        return fn(*args), lines
    except BaseException as e:  # noqa: BLE001 — re-raised with the lines below
        e.lines = lines
        raise
    finally:
        _LOG.lines = None


def side_by_side(runs: dict) -> dict:
    """Run ``{name: (fn, *args)}`` at once, one thread each, and return
    ``{name: fn(*args)}``; each run's log lines are printed after all end,
    in order, and the first failure is raised then.  The runs share the
    host and the card, so their host-bound numbers carry each other's
    load; their gates do not depend on it."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(runs)) as pool:
        futures = {name: pool.submit(buffered, *run) for name, run in runs.items()}
    out, failure = {}, None
    for name, f in futures.items():
        try:
            out[name], lines = f.result()
        except BaseException as e:  # noqa: BLE001 — the first failure ends the phase
            lines, failure = getattr(e, "lines", []), failure or e
        for line in lines:
            log(line)
    if failure is not None:
        raise failure
    return out


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

    bn = re.search(r"(bn_(?:bwd_)?stats_(?:partial|finalize|onepass))", mangled)
    if bn:
        ints = re.findall(r"Li(\d+)E", mangled)
        relu = re.search(r"Lb(\d)E", mangled)
        if bn.group(1).endswith("finalize"):
            return bn.group(1)
        dtype = "bf16" if "bfloat16" in mangled else "f32"
        vec = ints[0] if ints else "?"
        if bn.group(1).endswith("onepass"):
            return f"{bn.group(1)}<{dtype}, VEC={vec}>"
        return (f"{bn.group(1)}<{dtype}, VEC={vec}"
                + (f", RELU={relu.group(1)}>" if relu else ">"))
    if "fused_dq_reduce_kernel" in mangled:
        return f"fused_dq_reduce_kernel<{'bf16' if 'bfloat16' in mangled else 'f32'}>"
    kernel = re.search(r"(flash_(?:fwd|dq|dkv|fused_bwd)(?:_tc)?_kernel)I", mangled)
    d = re.search(r"Li(\d+)E", mangled)
    record = ""
    if "_tc_kernelI" in mangled:  # bf16 in; <D, Tout, kRecord>
        types = "bf16->f32" if re.search(r"_tc_kernelILi\d+Ef", mangled) else "bf16->bf16"
        record = ", record" if "Lb1E" in mangled else ""
    else:
        types = next((v for k, v in _TYPES.items()
                      if re.search(r"_kernelI" + re.escape(k), mangled)), "?")
    return (f"{kernel.group(1) if kernel else mangled}<{types}, D={d.group(1) if d else '?'}"
            f"{record}>")


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


#: The libraries with tensor-core kernels (bf16 in) beside their
#: CUDA-core ones, and the kernels (launch names; ``<name>_tc_kernel`` in
#: the source) each holds.
TENSOR_CORE_LIBRARIES = {
    "flash_fwd": ("flash_fwd",),
    "flash_bwd": ("flash_dq", "flash_dkv"),
    "flash_fused_bwd": ("flash_fused_bwd",),
}
TENSOR_CORE_KERNELS = tuple(k for ks in TENSOR_CORE_LIBRARIES.values() for k in ks)
#: The tensor-core instances each kernel holds: (types, head dims, record).
TC_FORMS = (("bf16->bf16", (32, 64, 128), ""), ("bf16->f32", (32, 64, 128), ""),
            ("bf16->f32", (32, 64), ", record"))


def tc_instances(library: str) -> list[str]:
    """The tensor-core kernel instances (:func:`_kernel_instance` names)
    library ``library`` must hold: each kernel's bf16 -> bf16 and
    bf16 -> f32 at D 32, 64 and 128, and its check-only recording
    instances (f32 out) at D 32 and 64."""
    return [f"{kernel}_tc_kernel<{ty}, D={d}{rec}>" for kernel in TENSOR_CORE_LIBRARIES[library]
            for ty, ds, rec in TC_FORMS for d in ds]


#: B6's kernel instances: its 1024-thread blocks leave a thread 64
#: registers, and the last block's fold keeps eight float4 loads in them.
BN_STATS_INSTANCES = tuple(f"bn_stats_onepass<{t}, VEC={v}>"
                           for t, vs in (("bf16", (8, 1)), ("f32", (4, 1))) for v in vs)


def check_build(_build, sources) -> dict:
    """Each kernel instance's registers and spills (``-Xptxas -v``), and the
    tensor-core instructions in the SASS of the tensor-core kernels;
    fails when an instance of :func:`tc_instances` or
    :data:`BN_STATS_INSTANCES` has no report or shows a spill, or a
    tensor-core instance's SASS has no tensor-core instruction.
    Returns the tensor-core instruction count of each tensor-core kernel,
    summed over its instances."""
    for name in sources:
        ptxas = Path(str(_build.library_path(name)) + ".log")
        if not ptxas.exists():
            if name in TENSOR_CORE_LIBRARIES or name == "bn_stats":
                raise SystemExit(f"no ptxas report beside {_build.library_path(name)}: "
                                 "delete the library to rebuild it")
            continue
        report = ptxas_report(ptxas.read_text())
        for line in report:
            log(f"  ptxas: {line}")
            if ("_tc_kernel" in line or "bn_stats_onepass" in line) and spills(line):
                raise SystemExit(f"a kernel that must keep its registers spills: {line}")
        gated = (tc_instances(name) if name in TENSOR_CORE_LIBRARIES
                 else BN_STATS_INSTANCES if name == "bn_stats" else ())
        for inst in gated:
            if not any(ln.startswith(f"{inst}:") for ln in report):
                raise SystemExit(f"{name}: no ptxas line for {inst}")
    totals = {}
    for name, kernels in TENSOR_CORE_LIBRARIES.items():
        counts = {k: n for k, n in tensor_core_counts(_build.library_path(name)).items()
                  if "_tc_kernel" in k}
        log(f"  SASS tensor-core instructions (HMMA/HGMMA) in lib{name}: "
            + ", ".join(f"{k} {n}" for k, n in sorted(counts.items())))
        missing = [inst for inst in tc_instances(name) if not counts.get(inst)]
        if missing:
            raise SystemExit(f"{name}: tensor-core instances missing or without a tensor-core "
                             f"instruction: {missing}")
        for kernel in kernels:
            totals[kernel] = sum(n for k, n in counts.items()
                                 if k.startswith(f"{kernel}_tc_kernel<"))
    return totals


def check_routes(flash) -> None:
    """The built libraries take the tensor-core kernel for bf16 in with
    bf16 or f32 out, with the (q rows, k rows) tiles the plain versions
    walk (``FWD_BLOCK_Q``/``_K``, ``DQ_BLOCK_Q``/``_K``, ``DKV_BLOCK_Q``/
    ``DKV_GROUP_K``, ``FUSED_BLOCK_Q``/``FUSED_GROUP_K``), and the
    CUDA-core kernel with 64-row tiles (``BLOCK``) for f32 in."""
    bf16, f32 = torch.bfloat16, torch.float32
    tc_tiles = {
        "flash_fwd": (flash.FWD_BLOCK_Q, flash.FWD_BLOCK_K),
        "flash_dq": (flash.DQ_BLOCK_Q, flash.DQ_BLOCK_K),
        "flash_dkv": (flash.DKV_BLOCK_Q, flash.DKV_GROUP_K),
        "flash_fused_bwd": (flash.FUSED_BLOCK_Q, flash.FUSED_GROUP_K),
    }
    want = {}
    for name, tiles in tc_tiles.items():
        for out in (bf16, f32):
            want[(name, bf16, out)] = (True, tiles)
            want[(name, f32, out)] = (False, (flash.BLOCK, flash.BLOCK))
    for key, route in want.items():
        got = flash.kernel_route(*key)
        if got != route:
            raise SystemExit(f"{key[0]} {key[1]} -> {key[2]}: the library reports "
                             f"(tensor cores, tiles) {got}, the plain version walks {route}")
    log("  routes: bf16 in, bf16 or f32 out -> tensor-core kernels (tiles "
        + ", ".join(f"{k} {v}" for k, v in tc_tiles.items())
        + "); f32 in -> CUDA-core kernels; as the plain versions walk them")


def require_tensor_cores(path: str, launches: dict, tc_launches: dict) -> None:
    """Fails unless every launch of a kernel with a tensor-core instance
    took that instance on ``path``: f32 in slipping onto a bf16 path would
    run a CUDA-core kernel, ~10x slower, at the same launch count."""
    for name in TENSOR_CORE_KERNELS:
        n, tc = launches.get(name, 0), tc_launches.get(name, 0)
        if tc != n:
            raise SystemExit(f"the {path} path launched {name} {n} times, {tc} of them "
                             "on its tensor-core kernel")
    log(f"  tensor-core launches ({path}): " + ", ".join(
        f"{k} {tc_launches.get(k, 0)} of {launches.get(k, 0)}" for k in TENSOR_CORE_KERNELS))


def timed(label: str, row: dict) -> dict:
    """Log one of ``tools/flash_bench.py``'s timings and return it."""
    log(f"  timing {fb.describe(label, row)}")
    return row


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


def check_flash_bwd(flash, bh, t, d, dtype, causal, out_dtype=None, determinism=False) -> dict:
    """dq and dk/dv kernels vs their plain versions on one input, held to
    the tolerance relative to the largest plain entry; returns each
    kernel's max absolute error."""
    args = fb.bwd_inputs(flash, bh, t, d, dtype, causal, seed=bh * 131 + t * 7 + d)
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


def check_split_f32(flash, bh, t, d, causal, *, rounding: bool) -> dict:
    """B2 and B3 at bf16 in and f32 out (the flash ring's hops, on the
    tensor cores) on one input, held not by a tolerance but by (a) and,
    where ``rounding``, (b):

    (a) the f32 dq, dk, dv rounded to bf16 (round to nearest even, as the
        bf16 instance rounds its accumulators) equal the bf16-out kernels'
        bit for bit (the two instances differ in the store alone), and a
        second f32 launch is bitwise the first;
    (b) the check-only recording instances give the same f32 results bit
        for bit, and with the p and ds they recorded pass
        ``tools/flash_rounding.py``'s check: fed them, the plain walks
        reproduce the results within ``TOL_BWD[float32]`` of the largest
        entry; each p lies within one bf16 step of the plain walk's own
        rounded p, each ds within the bound stated there.  The records
        are [BH, T, T], so (b) runs at small T.

    Returns the claim gaps and the shares of p and ds that flipped."""
    bf16, f32 = torch.bfloat16, torch.float32
    args = fb.bwd_inputs(flash, bh, t, d, bf16, causal, seed=bh * 131 + t * 7 + d + 2)

    def run(out_dtype):
        return (flash.dq_call(*args, causal=causal, out_dtype=out_dtype),
                *flash.dkv_call(*args, causal=causal, out_dtype=out_dtype))

    got, as_bf16, again = run(f32), run(bf16), run(f32)
    torch.cuda.synchronize()
    if any(x.dtype != f32 or x.shape != args[0].shape for x in got):
        raise SystemExit(f"flash backward f32 out: {[(x.dtype, tuple(x.shape)) for x in got]}")
    same = [torch.equal(a.to(bf16), b) for a, b in zip(got, as_bf16)]
    det = all(torch.equal(a, b) for a, b in zip(got, again))
    out = {"bitwise_bf16": all(same), "deterministic": det}
    text = (f"  flash_dq/flash_dkv [{bh}, {t}, {d}] bf16->f32 causal={causal} (tensor cores): "
            f"(a) rounded to bf16 == bf16 out bitwise: dq {same[0]}, dk {same[1]}, dv "
            f"{same[2]}; second run bitwise equal: {det}")
    if rounding:
        dq_r, rec_q = flash.dq_record(*args, causal=causal)
        dk_r, dv_r, rec_kv = flash.dkv_record(*args, causal=causal)
        torch.cuda.synchronize()
        rec_same = all(torch.equal(a, b) for a, b in zip((dq_r, dk_r, dv_r), got))
        res = flash_rounding.check(flash, args, causal, got, rec_q, rec_kv,
                                   tol=TOL_BWD[torch.float32])
        out.update(recorded_bitwise=rec_same, **res)
        text += (f"; (b) recording instances bitwise: {rec_same}; fed their p and ds, plain "
                 f"vs kernel " + ", ".join(f"{k} {v:.3e}" for k, v in res["fed"].items())
                 + f" (tol {TOL_BWD[torch.float32]:g}); "
                 + "; ".join(f"{k}: p flipped {res[k]['p_flips']:.3%} (max {res[k]['p_steps']} "
                             f"step), ds flipped {res[k]['ds_flips']:.3%} (worst gap "
                             f"{res[k]['ds_worst_over_bound']:.3f} of its bound)"
                             for k in ("flash_dq", "flash_dkv")))
    log(text)
    if not (all(same) and det):
        raise SystemExit(f"the split pair's f32-out route fails check (a) at [{bh}, {t}, {d}]")
    if rounding and not (out["recorded_bitwise"] and out["ok"]):
        raise SystemExit(f"the split pair's f32-out route fails check (b) at [{bh}, {t}, {d}]: "
                         f"recorded bitwise {out['recorded_bitwise']}, {out['failed']}")
    return out


def check_fwd_f32(flash, bh, t, d, causal, *, rounding: bool) -> dict:
    """B1 at bf16 in and f32 out (the flash ring's forward hops, on the
    tensor cores) on one input, held as :func:`check_split_f32` holds the
    split pair: (a) the f32 o rounded to bf16 equals the bf16-out kernel's
    bit for bit, its lse equals theirs bit for bit, and a second f32 launch
    is bitwise the first; (b), where ``rounding``, the check-only
    recording instance gives the same o and lse bit for bit, and with the
    p and running maxima it recorded passes ``tools/flash_rounding.py``'s
    ``check_fwd``: fed them, the plain walk reproduces o within
    ``TOL_O[float32]`` and lse within ``TOL_LSE``; each p lies within one
    bf16 step and each running max within its stated bound of the plain
    walk's own.  Returns the gaps and the share of p that flipped."""
    bf16, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device="cuda").manual_seed(bh * 7919 + t * 31 + d + 2)
    q, k, v = (torch.randn(bh, t, d, device="cuda", dtype=f32, generator=g).to(bf16)
               for _ in range(3))
    got, as_bf16, again = (flash.fwd_call(q, k, v, causal=causal, out_dtype=o)
                           for o in (f32, bf16, f32))
    torch.cuda.synchronize()
    if got[0].dtype != f32 or got[0].shape != q.shape:
        raise SystemExit(f"flash_fwd f32 out: {got[0].dtype} {tuple(got[0].shape)}")
    same = [torch.equal(got[0].to(bf16), as_bf16[0]), torch.equal(got[1], as_bf16[1])]
    det = all(torch.equal(a, b) for a, b in zip(got, again))
    out = {"bitwise_bf16": all(same), "deterministic": det}
    text = (f"  flash_fwd [{bh}, {t}, {d}] bf16->f32 causal={causal} (tensor cores): (a) rounded "
            f"to bf16 == bf16 out bitwise: o {same[0]}, lse {same[1]}; second run bitwise equal: "
            f"{det}")
    if rounding:
        o_r, lse_r, rec = flash.fwd_record(q, k, v, causal=causal)
        torch.cuda.synchronize()
        rec_same = torch.equal(o_r, got[0]) and torch.equal(lse_r, got[1])
        res = flash_rounding.check_fwd(flash, (q, k, v), causal, got, rec,
                                       tol_o=TOL_O[f32], tol_lse=TOL_LSE)
        out.update(recorded_bitwise=rec_same, **res)
        r = res["flash_fwd"]
        text += (f"; (b) recording instance bitwise: {rec_same}; fed its p and running maxima, "
                 f"plain vs kernel o {res['fed']['o']:.3e} (tol {TOL_O[f32]:g}), lse "
                 f"{res['fed']['lse']:.3e} (tol {TOL_LSE:g}); p flipped {r['p_flips']:.4%} (max "
                 f"{r['p_steps']} step, worst gap {r['p_worst_over_bound']:.3f} of its bound), "
                 f"running max worst gap {r['m_worst_over_bound']:.3f} of its bound")
    log(text)
    if not (all(same) and det):
        raise SystemExit(f"the forward's f32-out route fails check (a) at [{bh}, {t}, {d}]")
    if rounding and not (out["recorded_bitwise"] and out["ok"]):
        raise SystemExit(f"the forward's f32-out route fails check (b) at [{bh}, {t}, {d}]: "
                         f"recorded bitwise {out['recorded_bitwise']}, {out['failed']}")
    return out


def check_fused_f32(flash, bh, t, d, causal, *, rounding: bool) -> dict:
    """B4 at bf16 in and f32 out (the fused flash ring's backward hops, on
    the tensor cores) on one input, held as :func:`check_split_f32` holds
    the split pair: (a) bitwise against the bf16-out kernel once rounded,
    and run to run; (b), where ``rounding``, the check-only recording
    instance bitwise the f32 kernel, and its recorded p and ds through
    ``tools/flash_rounding.py``'s ``check_fused`` (fed: dq, dk, dv within
    ``TOL_BWD[float32]`` of the largest entry; each p within one bf16
    step, each ds within its stated bound of the plain walk's own)."""
    bf16, f32 = torch.bfloat16, torch.float32
    args = fb.bwd_inputs(flash, bh, t, d, bf16, causal, seed=bh * 131 + t * 7 + d + 3)
    got, as_bf16, again = (flash.fused_bwd_call(*args, causal=causal, out_dtype=o)
                           for o in (f32, bf16, f32))
    torch.cuda.synchronize()
    if any(x.dtype != f32 or x.shape != args[0].shape for x in got):
        raise SystemExit(f"fused backward f32 out: {[(x.dtype, tuple(x.shape)) for x in got]}")
    same = [torch.equal(a.to(bf16), b) for a, b in zip(got, as_bf16)]
    det = all(torch.equal(a, b) for a, b in zip(got, again))
    out = {"bitwise_bf16": all(same), "deterministic": det}
    text = (f"  flash_fused_bwd [{bh}, {t}, {d}] bf16->f32 causal={causal} (tensor cores, S = "
            f"{flash.fused_slices(bh, t)} slices): (a) rounded to bf16 == bf16 out bitwise: dq "
            f"{same[0]}, dk {same[1]}, dv {same[2]}; second run bitwise equal: {det}")
    if rounding:
        *rec_got, rec = flash.fused_bwd_record(*args, causal=causal)
        torch.cuda.synchronize()
        rec_same = all(torch.equal(a, b) for a, b in zip(rec_got, got))
        res = flash_rounding.check_fused(flash, args, causal, got, rec, tol=TOL_BWD[f32])
        out.update(recorded_bitwise=rec_same, **res)
        r = res["flash_fused_bwd"]
        text += (f"; (b) recording instance bitwise: {rec_same}; fed its p and ds, plain vs "
                 "kernel " + ", ".join(f"{k} {v:.3e}" for k, v in res["fed"].items())
                 + f" (tol {TOL_BWD[f32]:g}); p flipped {r['p_flips']:.4%} (max {r['p_steps']} "
                 f"step), ds flipped {r['ds_flips']:.4%} (worst gap "
                 f"{r['ds_worst_over_bound']:.3f} of its bound)")
    log(text)
    if not (all(same) and det):
        raise SystemExit(f"the fused backward's f32-out route fails check (a) at [{bh}, {t}, {d}]")
    if rounding and not (out["recorded_bitwise"] and out["ok"]):
        raise SystemExit(f"the fused backward's f32-out route fails check (b) at [{bh}, {t}, "
                         f"{d}]: recorded bitwise {out['recorded_bitwise']}, {out['failed']}")
    return out


#: Where phase 2 holds the f32-out routes (bh, t, d, causal): the training
#: shape's width and two ragged T at the recording instances' head dims,
#: causal and full, T 2048 at D 64 (does the flip share grow with T?), and
#: the ring's hop shape.  Check (b) runs where D has a recording instance.
F32_CHECKS = ([(8, t, d, c) for t, d in ((2048, 128), (1000, 64), (200, 32))
               for c in (True, False)] + [(2, 2048, 64, True)])


def check_fused_bwd(flash, bh, t, d, dtype, causal, out_dtype=None, determinism=False) -> float:
    """The fused backward kernel vs its plain version on one input, each of
    dq, dk, dv held to ``TOL_BWD`` relative to the largest plain entry;
    returns the max absolute error."""
    args = fb.bwd_inputs(flash, bh, t, d, dtype, causal, seed=bh * 131 + t * 7 + d + 1)
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


def check_bn(bn, shape, dtype, seed: int) -> dict:
    """bn_stats and bn_bwd_stats (relu on and off) vs their plain versions on one input, held to ``TOL_BN`` per
    channel, and bitwise equal on a second run; returns each kernel's max
    absolute error."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(shape, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    do = torch.randn(shape, device="cuda", generator=g).to(dtype)
    c = shape[-1]
    xf = x.float().reshape(-1, c)
    want = bn.bn_stats_plain(x)
    scales = (xf.abs().sum(0), (xf * xf).sum(0))
    got = bn.bn_stats(x)
    torch.cuda.synchronize()
    rel = max(((a - b).abs() / m.clamp_min(1e-30)).max().item()
              for a, b, m in zip(got, want, scales))
    err = {"bn_stats": max((a - b).abs().max().item() for a, b in zip(got, want))}
    same = all(torch.equal(a, b) for a, b in zip(got, bn.bn_stats(x)))
    mean, inv, scale, bias = fb.bn_inputs(bn, x, do)
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
    flash_in_decode = sum(decode_launches.get(k, 0) for k in ps.FLASH_FAMILIES)
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
        device_ms = fb.time_ms(lambda: step_fn(params, cache, tokens, pos), iters=20)
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
    busy ms, host ms to the synchronize, ms in the flash forward, device
    rows), read by ``tools/profile_step.py``."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        apply()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            apply()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    trace = ps.load(prof)
    flash_ms = ps.by_family(trace).get("flash_fwd", {"ms": 0.0})["ms"]
    return ps.busy_ms(trace), wall_ms, flash_ms, len(trace.device)


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
        apply_ms = fb.time_ms(lambda: transformer.apply(cfg, params, padded), iters=5)
        xla_ms = fb.time_ms(lambda: transformer.apply(xla_cfg, params, padded), iters=5)
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


def log_window(label: str, summary: dict, card: str, top: int = 10) -> None:
    """Print a profiled window (``tools/profile_step.py``'s summary with
    families): host ms, device busy ms and the idle share, device ms by
    kernel family, the ``top`` kernels and the longest idle gaps."""
    fams = summary["families"]
    total = sum(v["ms"] for v in fams.values()) or 1.0
    log(f"  {label}: host {summary['window_ms']:.1f} ms, device busy {summary['busy_ms']:.1f} ms "
        f"(idle share {summary['idle_share']:.1%}); by family: "
        + ", ".join(f"{k} {v['ms']:.1f} ms ({v['ms'] / total:.1%})"
                    for k, v in sorted(fams.items(), key=lambda kv: -kv[1]["ms"])))
    for name, ms, n in summary["top_kernels"][:top]:
        log(f"    {ms:8.2f} ms in {n:4d} launches  {name[:110]}")
    log("    longest device-idle gaps: " + ", ".join(
        f"{ms:.2f} ms at {at:.1f} ms under {op or '-'}" for ms, at, op in summary["gaps"])
        + f" [{card}]")


def profile_lm_step(cfg, init, batch, card: str) -> None:
    """Where an LM step's time goes: one full step (after a warm-up step)
    under torch.profiler, read by ``tools/profile_step.py``: device time by
    kernel family against the host clock around the step."""
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
    summary = ps.summary(prof, wall_ms=wall_ms, families=ps.LM_FAMILIES)
    if summary["busy_ms"] <= 0:
        raise SystemExit("torch.profiler recorded no device time for the profiled step")
    log_window("profiled step", summary, card)
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")


def train_end_to_end(card: str, kernel_ms: dict) -> dict:
    """Train, check, compare and publish (the module docstring's phase 4);
    returns the kernel launch counts of the main path's run."""
    from distributed_tensorflow_examples_tpu_torch import bridge, ops
    from distributed_tensorflow_examples_tpu_torch.data import datasets
    from distributed_tensorflow_examples_tpu_torch.examples import transformer_lm as cli
    from distributed_tensorflow_examples_tpu_torch.models import transformer
    from distributed_tensorflow_examples_tpu_torch.serve import ModelRegistry
    from distributed_tensorflow_examples_tpu_torch.train import hooks, state

    registry_dir = ROOT / "build" / "smoke_train_registry"
    profile_dir = ROOT / "build" / "smoke_profile"
    shutil.rmtree(registry_dir, ignore_errors=True)
    shutil.rmtree(profile_dir, ignore_errors=True)
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
    # One step's window, the last but one (before the clock, so that its
    # trace export falls inside that step's time, which the median leaves out).
    window = hooks.ProfilerHook(str(profile_dir), start_step=PROFILE_STEP - 1, num_steps=1)
    ops.reset_launches()  # every count to 0 just before the main path
    t0 = time.perf_counter()
    exp = cli.run_training(args, extra_hooks=[window, clock])
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

        step_ms = float(np.median([ms for s, ms, _l, _c in clock.steps[1:] if s != PROFILE_STEP]))
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
        window_launches(window, "train", cfg.n_layers, card)
        log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")
    finally:
        shutil.rmtree(registry_dir, ignore_errors=True)
        shutil.rmtree(profile_dir, ignore_errors=True)
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
    return launches, tc_launches


def window_launches(window, path: str, layers: int, card: str) -> None:
    """Print phase 4's profiled step (``window``, a one-step
    ``ProfilerHook``) by kernel family and fail unless its trace was
    written and each of the forward, dq and dk/dv kernels launched
    ``layers`` times in it."""
    if window.trace_path is None or not Path(window.trace_path).is_file():
        raise SystemExit(f"the {path} path's profiled step wrote no trace")
    summary = dict(window.summary, families=ps.by_family(window.trace, ps.LM_FAMILIES))
    log_window(f"profiled step {window.start + 1} (ProfilerHook, trace "
               f"{Path(window.trace_path).stat().st_size / 1e6:.1f} MB written and summarised "
               f"in {window.summary['export_s']:.2f} s)", summary, card)
    got = {k: summary["families"].get(k, {"launches": 0})["launches"]
           for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    if got != dict.fromkeys(got, layers):
        raise SystemExit(f"the {path} path's profiled step launched {got}, want {layers} of each")


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


def train_long_end_to_end(card: str, fused_ms: float, fwd_ms: float) -> tuple:
    """Train at T 8192 through the fused backward, check, compare with the
    split backward and profile (the module docstring's phase 6); returns
    the kernel launch counts of the main path's run, its tensor-core
    launches and its first ``SP_STEPS`` losses (phase 14's yardstick)."""
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
    return launches, tc_launches, losses[:SP_STEPS]


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
    n_bn = len(fb.resnet50_bn_shapes(RESNET_BATCH, RESNET_IMAGE))
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
    from torch.profiler import ProfilerActivity, profile

    opt = optim.SGD(cli.lr_schedule(args), momentum=0.9)
    st = state.create_state(lambda seed: init, opt, SEED, "cuda")
    train_step = step.build_train_step(resnet.loss_fn(cfg, mesh=mesh), opt)
    batch = {k: torch.from_numpy(v).cuda() for k, v in first_batch.items()}
    st, m = train_step(st, batch)
    float(m["loss"])
    # One kernel a bn_stats call, two a bn_bwd_stats call: no second B6
    # kernel.  A window whose trace lost kernel rows (the profiler's
    # activity buffers drop some on a loaded host: 52 of 53 seen) is taken
    # again, up to ``fb.WINDOWS`` steps.
    for window in range(fb.WINDOWS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st, m = train_step(st, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        summary = ps.summary(prof, wall_ms=wall_ms, families=ps.RESNET_FAMILIES, top=12)
        if summary["busy_ms"] <= 0:
            raise SystemExit("torch.profiler recorded no device time for the ResNet step")
        rows = {key: sum(n for k, n in summary["launches"].items() if key in k)
                for key in ("bn_stats_onepass", "bn_bwd_stats_partial", "bn_stats_finalize")}
        log(f"  BN kernel launches in profiled step {window + 1}: {json.dumps(rows)} "
            f"(want {n_bn} each)")
        if set(rows.values()) == {n_bn}:
            break
    else:
        raise SystemExit(f"the profiled ResNet steps did not launch each BN kernel {n_bn} times: "
                         f"{rows}")
    log_window("profiled ResNet step", summary, card, top=12)
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")
    return launches, {"first_loss": losses[0], "step_ms": step_ms, "start": start}


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


def _host_line(summary: dict) -> str:
    """A window's host ops with the most self time (``tools/profile_step.py``)."""
    return ", ".join(f"{k} {ms:.2f} ms ({n})" for k, ms, n in summary["host_ops"][:6])


def _first_step_loss(cli, argv: list, device: str) -> float:
    """Step 1's loss of ``cli`` at ``argv`` on ``device`` (one step; its
    FINAL line and logs are swallowed)."""
    return _step_losses(cli, argv, device, 1)[0]


def _step_losses(cli, argv: list, device: str, steps: int) -> list:
    """The losses of the first ``steps`` steps of ``cli`` at ``argv`` on
    ``device`` (its FINAL line and logs are swallowed)."""
    import contextlib
    import io

    rec = step_recorder()
    args = cli.build_parser().parse_args([*argv, f"--device={device}", f"--train_steps={steps}"])
    with contextlib.redirect_stdout(io.StringIO()):
        cli.run_training(args, extra_hooks=[rec])
    return [loss for _s, _ms, loss, *_r in rec.steps]


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
        window = ps.summary(rec.prof)
        busy_ms, kernels, copies = window["busy_ms"], window["kernels"], window["copies"]
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
        log(f"    host, profiled step, most self time: {_host_line(window)}")
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


@contextlib.contextmanager
def torch_settings_restored():
    """Put back, on leaving, the process-wide settings that
    ``utils.determinism.enable`` (``--deterministic``) turns: torch's
    deterministic algorithms, cuDNN's deterministic and benchmark flags,
    TF32 in matmuls and cuDNN, and ``CUBLAS_WORKSPACE_CONFIG``."""
    import os

    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    workspace = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) = saved[2:]
        if workspace is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = workspace


def ps_emulation_end_to_end(card: str) -> dict:
    """Train W1 and W2 on the in-process PS emulation through their CLIs
    (the module docstring's phase 8); returns each run's measurements.
    The ``--deterministic`` runs' process-wide settings end with the
    phase."""
    with torch_settings_restored():
        return _ps_emulation(card)


def _ps_emulation(card: str) -> dict:
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
        window = ps.summary(prof_tr.prof)
        busy_ms, kernels, copies = window["busy_ms"], window["kernels"], window["copies"]
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
            f"{_host_line(window)}")

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
    loss, launches of each of ``kernels``, collective calls, bytes and host
    seconds by tag (``TRAFFIC``), the step's collective account
    (``utils/hlo_analysis.py``'s records, as dicts), profiled), reading
    the loss (which waits for the step's device work), and runs step
    ``profile_step`` under ``torch.profiler``."""
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
            self._account = hlo_analysis.record_collectives()
            self._records = self._account.__enter__()

        def after_step(self, loop, metrics):
            loss = float(metrics["loss"])
            self._account.__exit__(None, None, None)
            profiled = loop.step == profile_step
            if profiled:
                torch.cuda.synchronize()
            ms = (time.perf_counter() - self._t) * 1e3
            launches = {k: ops.LAUNCHES[k] - self._launches.get(k, 0) for k in kernels}
            traffic = {k: v - self._traffic.get(k, 0) for k, v in collectives.TRAFFIC.items()
                       if v != self._traffic.get(k, 0)}
            self.steps.append({"step": loop.step, "ms": ms, "loss": loss,
                               "launches": launches, "traffic": traffic,
                               "account": [dataclasses.asdict(c) for c in self._records],
                               "profiled": profiled})
            if profiled:
                self.prof.__exit__(None, None, None)
            self._mark()

    return DPStep()


def _profile_summary(prof, step_ms: float) -> dict:
    """Device busy ms, kernel launches, NCCL kernels, idle share and the
    longest idle gaps of one rank's profiled step (``tools/profile_step.py``)."""
    s = ps.summary(prof, wall_ms=step_ms, families=ps.LM_FAMILIES)
    return {"busy_ms": s["busy_ms"], "kernels": s["kernels"],
            "nccl_kernels": s["families"].get("nccl", {"launches": 0})["launches"],
            "step_ms": step_ms, "idle_share": s["idle_share"], "gaps": s["gaps"]}


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


def _run_ranks(n: int, call: str, timeout: float, device=None) -> tuple[list, list, str]:
    """Run ``chip_smoke.<call>`` (``{out}`` names the result directory) on
    ``n`` ranks of the port's ``MultiProcessRunner`` on the card (or
    ``device``); returns (exit codes, outputs, result directory).  A
    failing rank fails the phase."""
    import tempfile

    from distributed_tensorflow_examples_tpu_torch.utils.multiprocess import MultiProcessRunner

    out = tempfile.mkdtemp(prefix="dtx_dp_")
    src = f"import chip_smoke\nchip_smoke.{call.format(out=out)}\n"
    runner = MultiProcessRunner(n, src, device=device, timeout=timeout)
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


def _records(step: dict) -> list:
    """A step's collective account as ``hlo_analysis.Collective`` records."""
    return [hlo_analysis.Collective(**c) for c in step["account"]]


def account_line(step: dict) -> str:
    """A step's collectives by tag (its account, ``utils/hlo_analysis.py``):
    the kind, the calls, the MB by the JAX package's convention and the
    host ms ``TRAFFIC`` timed."""
    t = step["traffic"]
    return ", ".join(
        f"{tag} {kind} {v['count']} call(s) / {v['bytes'] / 1e6:.3f} MB / "
        f"{t.get(tag + '_seconds', 0) * 1e3:.1f} ms of host time"
        for tag, kinds in hlo_analysis.by_tag(_records(step)).items()
        for kind, v in kinds.items()) or "none"


def data_parallel_end_to_end(card: str, phase5: dict) -> dict:
    """Sync data parallelism on the card (the module docstring's phase 9);
    returns each run's step ms and the BN kernels' launches by rank."""
    # The probe's two processes fail in NCCL's start within seconds, while
    # the world of one still imports: it runs beside that run's start-up.
    probe = dp_nccl_probe_start()
    resnet_nccl1 = dp_resnet_nccl(card, phase5)
    dp_nccl_probe_report(probe)
    # ResNet-50's and the LSTM's 2-rank runs side by side.
    return {"resnet_nccl1": resnet_nccl1,
            **side_by_side({"resnet_dp2": (dp_resnet, card, phase5),
                            "lstm_dp2": (dp_lstm, card)})}


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
    n_bn = len(fb.resnet50_bn_shapes(RESNET_BATCH // DP_RANKS, RESNET_IMAGE))
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
    log(f"    collectives a step, each rank: {account_line(one)}")
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
        f"{DP_NCCL_STEPS - 1}) beside phase 5's {phase5['step_ms']:.1f} ms; collectives a step: "
        f"{account_line(nccl['steps'][1])}; profiled step: {p['nccl_kernels']} NCCL kernel "
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
        f"{64 * 20 / (lstm_ms / 1e3):.0f} global tokens/s; collectives a step, each rank: "
        f"{account_line(ranks[0]['steps'][1])} [{card}]")
    if len(finals[0]) != 1 or any(finals[1:]) or "valid_perplexity=" not in finals[0][0]:
        raise SystemExit("W5: the FINAL line with valid_perplexity must come from the chief alone")
    if any(r["backend"] != "gloo" for r in ranks) or len({r["param_sha256"] for r in ranks}) != 1:
        raise SystemExit("W5: the ranks did not take gloo or end with different parameters")
    if len(losses) != WORKLOAD_STEPS or not all(math.isfinite(x) for x in losses):
        raise SystemExit("W5: a loss is not finite (or steps are missing)")
    if par["global_grad_norm"] <= DP_LSTM_CLIP or max(par["dp_vs_one"]) > TOL_DP_LSTM_UPDATE:
        raise SystemExit("W5: the 2-rank clipped update disagrees with the 1-rank one")
    return {"step_ms": lstm_ms}


# ----------------------------------------------------------------------------
# Phase 10: W1 and W2 as PS, chief and worker processes sharing the card
# ----------------------------------------------------------------------------

#: The phase's runs: (name, CLI module, its flags, mode).
PS_CLUSTER_RUNS = (
    ("w1_sync", "mnist_mlp", ["--ps_emulation"], "sync_replicas"),
    ("w2_async", "cifar10_cnn", ["--sync_replicas=false", "--max_staleness=4"], "async"),
)
#: A cluster's processes must all exit on their own within this time.
PS_CLUSTER_LIMIT_S = 240


def _run_cluster(name: str, cmds: dict, env: dict, limit_s: float = PS_CLUSTER_LIMIT_S,
                 during=None) -> dict:
    """Start every command of ``cmds`` together and return each process's
    output once all exited 0; ``during(cluster)`` runs meanwhile.  The first
    process to fail (or the time limit) stops the whole cluster and the
    phase, with that process's output."""
    from distributed_tensorflow_examples_tpu_torch.utils.multiprocess import (
        ClusterFailed,
        ProcessCluster,
    )

    try:
        with ProcessCluster(limit_s) as cluster:
            for k, c in cmds.items():
                cluster.spawn(k, c, env=env, cwd=str(ROOT))
            if during is not None:
                during(cluster)
            return cluster.finish()
    except ClusterFailed as e:
        raise SystemExit(f"{name}: {e}")


def _json_after(tag: str, out: str) -> dict:
    """The JSON object a process logged after ``tag`` (its last such line)."""
    lines = [l for l in out.splitlines() if l.startswith(tag + " ")]
    if not lines:
        raise SystemExit(f"no {tag} line in:\n{out[-2000:]}")
    return json.loads(lines[-1][len(tag) + 1:])


def _ps_common(cli: str, ports: list[int], steps: int, *argv) -> list[str]:
    """The command line every task of a phase 10 or 11 cluster shares."""
    return [sys.executable, "-m", f"distributed_tensorflow_examples_tpu_torch.examples.{cli}",
            f"--seed={SEED}", f"--worker_hosts={PS_WORKERS}", f"--train_steps={steps}",
            "--ps_hosts=" + ",".join(f"127.0.0.1:{p}" for p in ports), *argv]


def _cluster_checks(name: str, outs: dict, mode: str, steps: int, device: str) -> tuple:
    """The gates every run of phases 10-11 shares: ``CHIEF_PLATFORM``, the
    JAX cluster FINAL line with finite numbers, each PS task's ``PS_DONE``
    and no CUDA context in it, both workers contributed, the chief and the
    workers on ``device``, no chief reseed.  Returns (the FINAL line's
    match, the chief's stats, each worker's stats)."""
    import re

    chief = outs["chief"]
    platform = "gpu" if device == "cuda" else device
    if f"CHIEF_PLATFORM={platform}" not in chief.splitlines():
        raise SystemExit(f"{name}: the chief did not print CHIEF_PLATFORM={platform}")
    finals = [l for l in chief.splitlines() if l.startswith("FINAL ")]
    pattern = (rf"^FINAL step={steps} steps_per_sec=(\S+) examples_per_sec_per_chip=(\S+) "
               rf"mode={mode}_cluster workers=2 stale_dropped=(\d+) test_accuracy=(\S+)$")
    match = re.match(pattern, finals[0]) if len(finals) == 1 else None
    if not match or not all(math.isfinite(float(match.group(i))) for i in (1, 2, 4)):
        raise SystemExit(f"{name}: no finite FINAL line of the JAX cluster form: {finals}")
    for k, out in outs.items():
        if k.startswith("ps"):
            if not re.search(r"^PS_DONE port=\d+$", out, re.M):
                raise SystemExit(f"{name}: {k} printed no PS_DONE")
            if ("PS task: CUDA initialized=False" not in out
                    or "PS task: CUDA initialized=True" in out):
                raise SystemExit(f"{name}: {k} created a CUDA context (or did not say)")
    cstats = _json_after("PS_CHIEF_STATS", chief)
    wstats = [_json_after("PS_WORKER_STATS", outs[f"worker{w}"]) for w in range(2)]
    if min(w["contributed"] for w in wstats) <= 0:
        raise SystemExit(f"{name}: a worker contributed nothing: {wstats}")
    if cstats["device"] != device or any(w["device"] != device for w in wstats):
        raise SystemExit(f"{name}: the chief and workers must run on {device}")
    if cstats["reseeds"] != 0:
        raise SystemExit(f"{name}: the chief reseeded {cstats['reseeds']} time(s)")
    return match, cstats, wstats


def _wire_mb(cstats: dict, wstats: list) -> float:
    """Every client byte of the chief and the workers, both ways, an
    applied step, in MB."""
    total = sum(st["bytes_tx"] + st["bytes_rx"] for st in (cstats, *wstats))
    return total / cstats["applied"] / 1e6


def ps_cluster_end_to_end(card: str, phase8: dict) -> dict:
    """Run W1 and W2 in their reference shape (the module docstring's phase
    10): a PS task, the chief and two workers, each a process of the port's
    CLI, started together, the two clusters side by side; returns each
    run's measurements."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return side_by_side({run[0]: (_ps_cluster_run, card, phase8, env, *run)
                         for run in PS_CLUSTER_RUNS})


def _ps_cluster_run(card: str, phase8: dict, env: dict, name: str, cli: str, argv: list,
                    mode: str) -> dict:
    """One cluster of phase 10: its checks, prints and measurements."""
    from distributed_tensorflow_examples_tpu_torch.utils.multiprocess import free_port

    common = _ps_common(cli, [free_port()], PS_STEPS, *argv)
    cmds = {"ps": [*common, "--job_name=ps"],
            "chief": [*common, "--job_name=chief", "--device=cuda"],
            **{f"worker{w}": [*common, "--job_name=worker", f"--task_index={w}",
                              "--device=cuda"] for w in range(2)}}
    t0 = time.perf_counter()
    outs = _run_cluster(name, cmds, env)
    wall_s = time.perf_counter() - t0
    match, cstats, wstats = _cluster_checks(name, outs, mode, PS_STEPS, "cuda")
    contributed = [w["contributed"] for w in wstats]
    r2a = 2 if mode == "sync_replicas" else 1
    local_bs = 128 // 2
    sps = cstats["applies_per_s_second_half"]
    r = {
        "applied_steps_per_s": sps, "apply_wall_ms": 1e3 / sps,
        "examples_per_s_per_chip": sps * local_bs * r2a,
        "final_steps_per_sec": float(match.group(1)),
        "final_examples_per_sec_per_chip": float(match.group(2)),
        "stale_dropped": int(match.group(3)), "deduped": cstats["deduped"],
        "test_accuracy": float(match.group(4)), "contributed": contributed,
        "chief_apply_ms": cstats["median_apply_ms"],
        "chief_wait_ms": cstats["median_wait_ms"],
        **{f"worker{w}_{k}": ws[f"median_{k}"]
           for w, ws in enumerate(wstats) for k in ("token_ms", "pull_ms", "grad_ms", "push_ms")},
        "wire_mb_per_apply": _wire_mb(cstats, wstats), "wall_s": wall_s,
    }
    p8 = phase8.get(name, {})
    log(f"  {name}: {match.group(0)}")
    log(f"    1 PS + chief + 2 workers, started together, {wall_s:.1f} s wall; the PS "
        f"task host-only (no CUDA context), the chief and the workers on cuda [{card}]")
    log(f"    second half of the applies: {sps:.1f} applied steps/s "
        f"({r['apply_wall_ms']:.3f} ms an applied step), {r['examples_per_s_per_chip']:.0f} "
        f"examples/s per chip; phase 8 in one process: "
        f"{p8.get('applied_steps_per_s', float('nan')):.1f} applied steps/s "
        f"({p8.get('apply_wall_ms', float('nan')):.3f} ms), "
        f"{p8.get('examples_per_s_per_chip', float('nan')):.0f} examples/s")
    log(f"    {r['stale_dropped']} dropped stale, {r['deduped']} deduped; contributed "
        f"{contributed}; chief medians: take/pop wait {r['chief_wait_ms']:.3f} ms, host "
        f"update + publish {r['chief_apply_ms']:.3f} ms")
    for w, ws in enumerate(wstats):
        log(f"    worker {w} medians: token wait {ws['median_token_ms']:.3f} ms, pull "
            f"{ws['median_pull_ms']:.3f} ms, H2D + gradient + D2H {ws['median_grad_ms']:.3f} "
            f"ms, push {ws['median_push_ms']:.3f} ms")
    log(f"    wire: {r['wire_mb_per_apply']:.3f} MB an applied step (every client byte, "
        "both ways, chief and workers)")
    return r


# ----------------------------------------------------------------------------
# Phase 11: the sharded, replicated, elastic PS and a serve replica tracking it
# ----------------------------------------------------------------------------

#: ps0 (shard 0's primary) dies after serving this many requests: about a
#: third of the way into ``w2_async_2x2`` (~570 requests of start-up polls
#: on the H100 machine, then ~7.5 an applied step with the replica's polls;
#: 750 killed it after apply 26 of 200, PERF.md section 6).
PS_KILL_AFTER_REQS = 1100
#: The W1 run's joiners start once the chief has published this step ...
RESHARD_AT_STEP = 40
#: ... and the run trains this many steps: PS_STEPS of W1 (~1.3 s at ~6.5
#: ms an applied step, phase 10) would end before a joiner process is up
#: (a supervised start imports torch twice, several seconds).
RESHARD_STEPS = 3000
#: The predicts' fixed batch: rows of the synthetic CIFAR-10 test split.
SERVE_ROWS = 8


def _predict_loop(port: int, x: np.ndarray, stop: threading.Event, record: list) -> None:
    """Predict ``x`` on the replica at ``port`` until ``stop``; record
    (step, client ms, logits shape, all finite) or the exception."""
    from distributed_tensorflow_examples_tpu_torch import serve

    c = serve.ServeClient("127.0.0.1", port, role="smoke_sv")
    try:
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                step, out = c.predict({"image": x})
            except Exception as e:  # noqa: BLE001 — every failure fails the gate
                record.append(e)
                continue
            logits = torch.as_tensor(out["output"]).float()
            record.append((step, (time.perf_counter() - t0) * 1e3, tuple(logits.shape),
                           bool(torch.isfinite(logits).all())))
    finally:
        c.close()


def _w2_async_2x2(card: str, phase10: dict, env: dict, device: str, steps: int) -> dict:
    import os

    from distributed_tensorflow_examples_tpu_torch import serve
    from distributed_tensorflow_examples_tpu_torch.data import datasets
    from distributed_tensorflow_examples_tpu_torch.parallel import membership, ps_service
    from distributed_tensorflow_examples_tpu_torch.utils.multiprocess import free_ports

    name = "w2_async_2x2"
    *ports, sport = free_ports(5)
    common = _ps_common("cifar10_cnn", ports, steps, "--sync_replicas=false",
                        "--max_staleness=4", "--ps_shards=2", "--ps_replicas=2")
    cmds = {**{f"ps{i}": [*common, "--job_name=ps", f"--task_index={i}"] for i in range(4)},
            "serve0": [*common, "--job_name=serve", f"--serve_hosts=127.0.0.1:{sport}",
                       f"--device={device}"]}
    trainers = {"chief": [*common, "--job_name=chief", f"--device={device}"],
                **{f"worker{w}": [*common, "--job_name=worker", f"--task_index={w}",
                                  f"--device={device}"] for w in range(2)}}
    env = dict(env, DTX_FAULT_PLAN=f"die:role=ps0,after_reqs={PS_KILL_AFTER_REQS}")
    x = datasets.cifar10(None, seed=SEED).test["image"][:SERVE_ROWS].astype(np.float32)
    record: list = []
    replica: dict = {}

    def serve_leased() -> bool:
        try:
            c = ps_service.PSClient("127.0.0.1", ports[0], timeout_s=2.0)
        except (OSError, ps_service.PSError):
            return False
        try:
            return bool(membership.live_members(c, "serve"))
        except (OSError, ps_service.PSError):
            return False
        finally:
            c.close()

    def during(cluster) -> None:
        # The trainers start once the replica holds its lease (a state), so
        # it serves from the run's first publish on.
        cluster.wait_until(serve_leased, poll_s=0.05)
        for k, c in trainers.items():
            cluster.spawn(k, c, env=os.environ | env, cwd=str(ROOT))
        # The replica logs this line once it pulled its first snapshot
        # (``host_serve_task``'s wait_for_model).
        cluster.wait_until(lambda: "serve task on port" in cluster.output("serve0"))
        stop = threading.Event()
        asker = threading.Thread(target=_predict_loop, args=(sport, x, stop, record),
                                 daemon=True)
        asker.start()
        try:
            cluster.finish(["chief", "worker0", "worker1"])
        finally:
            stop.set()
            asker.join(30)
        c = serve.ServeClient("127.0.0.1", sport, role="smoke_sv")
        replica.update(c.stats())
        c.shutdown_server()
        c.close()

    t0 = time.perf_counter()
    outs = _run_cluster(name, cmds, os.environ | env, during=during)
    wall_s = time.perf_counter() - t0
    match, cstats, wstats = _cluster_checks(name, outs, "async", steps, device)
    if "SERVE_DONE port=" not in outs["serve0"]:
        raise SystemExit(f"{name}: the replica printed no SERVE_DONE")
    if "supervisor_healed_plan" not in outs["ps0"]:
        raise SystemExit(f"{name}: ps0 was not killed and restarted by its plan")
    errors = [r for r in record if isinstance(r, Exception)]
    answers = [r for r in record if not isinstance(r, Exception)]
    if errors or not answers:
        raise SystemExit(f"{name}: {len(errors)} of {len(record)} predicts failed: {errors[:3]}")
    if any(shape != (SERVE_ROWS, 10) or not finite for _s, _ms, shape, finite in answers):
        raise SystemExit(f"{name}: a predict answered other than finite logits [8, 10]")
    steps_seen = [a[0] for a in answers]
    rises = sum(b > a for a, b in zip(steps_seen, steps_seen[1:]))
    if any(b < a for a, b in zip(steps_seen, steps_seen[1:])) or rises < 3:
        raise SystemExit(f"{name}: the stamped step went backwards or rose {rises} < 3 times")
    done = cstats["apply_done_s"]
    gaps = np.diff(done) * 1e3
    lat = np.array([a[1] for a in answers])
    sps = cstats["applies_per_s_second_half"]
    p10 = phase10.get("w2_async", {})
    r = {
        "applied_steps_per_s": sps, "apply_wall_ms": 1e3 / sps,
        "final_steps_per_sec": float(match.group(1)), "stale_dropped": int(match.group(3)),
        "test_accuracy": float(match.group(4)), "reseeds": cstats["reseeds"],
        "contributed": [w["contributed"] for w in wstats],
        "chief_apply_ms": cstats["median_apply_ms"], "chief_pop_ms": cstats["median_wait_ms"],
        **{f"worker{w}_{k}": ws[f"median_{k}"]
           for w, ws in enumerate(wstats) for k in ("token_ms", "pull_ms", "grad_ms", "push_ms")},
        "wire_mb_per_apply": _wire_mb(cstats, wstats),
        "longest_apply_gap_ms": float(gaps.max()), "median_apply_gap_ms": float(np.median(gaps)),
        "longest_gap_after_apply": int(np.argmax(gaps)) + 1,
        "predicts": len(answers), "predict_p50_ms": float(np.percentile(lat, 50)),
        "predict_p99_ms": float(np.percentile(lat, 99)), "step_rises": rises,
        "replica_refreshes": replica.get("refreshes"), "wall_s": wall_s,
    }
    log(f"  {name}: {match.group(0)}")
    log(f"    4 PS tasks (2 shards x 2 replicas, host-only, no CUDA context), the chief, 2 "
        f"workers and 1 serve replica on {device} [{card}], {wall_s:.1f} s wall; ps0 killed "
        f"after {PS_KILL_AFTER_REQS} requests and restarted; chief reseeds {cstats['reseeds']}")
    log(f"    second half of the applies: {sps:.1f} applied steps/s ({r['apply_wall_ms']:.3f} "
        f"ms an applied step); phase 10 at 1 shard in this run: "
        f"{p10.get('applied_steps_per_s', float('nan')):.1f} applied steps/s "
        f"({p10.get('apply_wall_ms', float('nan')):.3f} ms)")
    log(f"    chief medians: pop {r['chief_pop_ms']:.3f} ms, host update + publish "
        f"{r['chief_apply_ms']:.3f} ms; wire {r['wire_mb_per_apply']:.3f} MB an applied "
        f"step; contributed {r['contributed']}, {r['stale_dropped']} dropped stale")
    for w, ws in enumerate(wstats):
        log(f"    worker {w} medians: pull {ws['median_pull_ms']:.3f} ms, H2D + gradient + D2H "
            f"{ws['median_grad_ms']:.3f} ms, push {ws['median_push_ms']:.3f} ms")
    log(f"    failover: the longest gap between two applies {r['longest_apply_gap_ms']:.1f} ms "
        f"(after apply {r['longest_gap_after_apply']}; median gap "
        f"{r['median_apply_gap_ms']:.3f} ms)")
    log(f"    serve replica: {r['predicts']} predicts of [{SERVE_ROWS}, 32, 32, 3], all finite "
        f"[8, 10] logits, client p50 {r['predict_p50_ms']:.3f} ms, p99 "
        f"{r['predict_p99_ms']:.3f} ms; the stamped step rose {rises} times, never back; "
        f"{r['replica_refreshes']} refreshes")
    return r


def _w1_sync_reshard(card: str, env: dict, device: str, steps: int) -> dict:
    import os

    from distributed_tensorflow_examples_tpu_torch.parallel import reshard
    from distributed_tensorflow_examples_tpu_torch.utils.multiprocess import free_ports

    name = "w1_sync_reshard"
    ports = free_ports(5)
    old, new = ports[:2], ports[2:]
    old_addrs = [("127.0.0.1", p) for p in old]
    common = _ps_common("mnist_mlp", old, steps, "--ps_emulation", "--ps_layout_version=1")
    cmds = {**{f"ps{i}": [*common, "--job_name=ps", f"--task_index={i}"] for i in range(2)},
            "chief": [*common, "--job_name=chief", f"--device={device}"],
            **{f"worker{w}": [*common, "--job_name=worker", f"--task_index={w}",
                              f"--device={device}"] for w in range(2)}}
    target = "2:" + ",".join(f"127.0.0.1:{p}" for p in new)
    timing: dict = {}

    def published_step() -> int:
        try:
            meta = reshard.discover_old_layout(old_addrs, old_version=1, timeout_s=2.0)
        except OSError:
            return -1
        return min(meta["steps"].get("params", [-1]))

    def committed() -> bool:
        from distributed_tensorflow_examples_tpu_torch.parallel import ps_service

        try:
            c = ps_service.PSClient("127.0.0.1", old[0], timeout_s=2.0)
        except (OSError, ps_service.PSError):
            return False
        try:
            return reshard.poll_committed(c, 1) is not None
        except (OSError, ps_service.PSError):
            return False
        finally:
            c.close()

    def during(cluster) -> None:
        cluster.wait_until(lambda: published_step() >= RESHARD_AT_STEP, poll_s=0.02)
        timing["spawn"] = time.perf_counter()
        for j in range(3):
            cluster.spawn(f"ps_new{j}", [*common, "--job_name=ps", f"--task_index={j}",
                                         f"--ps_reshard_to={target}"],
                          env=os.environ | env, cwd=str(ROOT))
        cluster.wait_until(lambda: committed() or cluster.procs["chief"].poll() is not None,
                           poll_s=0.02)
        if not committed():
            raise SystemExit(f"{name}: the chief finished before the epoch-2 commit")
        timing["commit"] = time.perf_counter()

    t0 = time.perf_counter()
    outs = _run_cluster(name, cmds, os.environ | env, during=during)
    wall_s = time.perf_counter() - t0
    match, cstats, wstats = _cluster_checks(name, outs, "sync_replicas", steps, device)
    if cstats["reshards"] != 1 or cstats["layout_version"] != 2 or cstats["shards"] != 3:
        raise SystemExit(f"{name}: the epoch-2 layout was not adopted: {cstats}")
    after = [w["contributed_by_epoch"].get("2", 0) for w in wstats]
    if min(after) <= 0:
        raise SystemExit(f"{name}: a worker contributed nothing after the commit: {wstats}")
    done = np.asarray(cstats["apply_done_s"])
    at = cstats["reshard_steps"][0]
    before_ms = float(np.mean(np.diff(done[:at]))) * 1e3
    after_ms = float(np.mean(np.diff(done[at:]))) * 1e3
    r = {"commit_s": timing["commit"] - timing["spawn"], "reshard_at_step": at,
         "apply_ms_before": before_ms, "apply_ms_after": after_ms,
         "final_steps_per_sec": float(match.group(1)), "test_accuracy": float(match.group(4)),
         "reseeds": cstats["reseeds"], "contributed_after_commit": after, "wall_s": wall_s}
    log(f"  {name}: {match.group(0)}")
    log(f"    2 PS shards (epoch 1) -> 3 joiners (epoch 2) spawned at step >= "
        f"{RESHARD_AT_STEP}, committed {r['commit_s']:.3f} s after their spawn at step {at}; "
        f"the retired tier exited 0; chief reseeds {r['reseeds']}; contributed after the "
        f"commit {after} [{card}]")
    log(f"    ms an applied step: {before_ms:.3f} before the commit (2 shards), "
        f"{after_ms:.3f} after (3 shards); {wall_s:.1f} s wall")
    return r


def ps_sharded_end_to_end(card: str, phase10: dict, device: str = "cuda",
                          steps: int = PS_STEPS, reshard_steps: int = RESHARD_STEPS) -> dict:
    """Phase 11 (the module docstring): W2 at 2 shards x 2 replicas with a
    primary kill and a serve replica predicting throughout, and beside it
    W1 across a live 2 -> 3 reshard (the two clusters start together, so
    each run's host-bound numbers carry the other's load); returns each
    run's measurements.  ``device`` and the step counts let the phase run
    on the CPU at a small size."""
    env = {"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    return side_by_side({
        "w2_async_2x2": (_w2_async_2x2, card, phase10, env, device, steps),
        "w1_sync_reshard": (_w1_sync_reshard, card, env, device, reshard_steps)})


# ----------------------------------------------------------------------------
# Phase 12: the model mesh axis (W4, W5 vocab-parallel) and ZeRO-1 (W3)
# ----------------------------------------------------------------------------

#: Phase 12's ranks and mesh: the two ranks split the tables' vocab rows.
MA_RANKS = 2
MA_MESH = "data=1,model=2"
MA_PROFILE_STEP = 50
#: The compared step, float32, 2 model ranks against 1 rank on the same
#: batch and negatives.  The sharded logits are the owner's value plus
#: zeros (exact), so what may differ is the order in which the card sums
#: the gradient rows of repeated ids (index backward's atomic adds; a row
#: of the batch's 256 ids sums at most a few hundred terms, each rounded
#: at 2^-24 relative) and the clip's norm (W5: its squares summed over
#: the two blocks, then over the ranks).  Losses relative 1e-6; the
#: parameters after the update (entries ~1e-2) absolute 1e-6: at the CLI's
#: learning rates (0.01 for W4; 1.0 clipped to a norm of 0.05 for W5) a
#: reorder moves an entry by ~1e-9.  A psum in place of the vocab-parallel
#: operators doubles the table's update (1e-2 off), a local clip norm
#: scales W5's update by ~sqrt(2), a missed block's rows are O(1e-2).
TOL_MA_LOSS_REL = 1e-6
TOL_MA_PARAM = 1e-6
#: Phase 12 (c): ResNet-50 with ``--zero_opt`` and without, on two data
#: ranks, phase 9's batch and width, ``ZERO_STEPS`` steps each, cuDNN
#: deterministic so that the two runs may be compared bit for bit.
ZERO_STEPS = 4


def _leaf_arrays(params) -> dict:
    from distributed_tensorflow_examples_tpu_torch import bridge

    return {p: t.detach().float().cpu().numpy() for p, t in bridge._leaves(params)}


def _specs_json(specs) -> dict:
    from distributed_tensorflow_examples_tpu_torch import bridge

    return {p: list(s) for p, s in bridge._leaves(specs)}


def _ma_run(out_dir: str, name: str, cli, argv: list, compare) -> dict:
    """One CLI run of phase 12 on this rank at ``MA_MESH`` (every count to
    0 just before it), then ``compare(exp)``, the float32 step against the
    chief's 1-rank step."""
    from distributed_tensorflow_examples_tpu_torch import bridge, ops
    from distributed_tensorflow_examples_tpu_torch.parallel import collectives, dist

    args = cli.build_parser().parse_args([
        f"--seed={SEED}", f"--train_steps={WORKLOAD_STEPS}", "--log_every_steps=100",
        f"--mesh={MA_MESH}", *argv])
    hook = dp_step_hook(profile_step=MA_PROFILE_STEP)
    ops.reset_launches()
    collectives.TRAFFIC.clear()
    t0 = time.perf_counter()
    exp = cli.run_training(args, extra_hooks=[hook])
    wall = time.perf_counter() - t0
    specs = _specs_json(exp.specs["params"])
    replicated = [t for p, t in bridge._leaves(exp.state.params)
                  if "model" not in specs[p]]
    profiled = next(s for s in hook.steps if s["profiled"])
    final = {"eval_loss": getattr(exp, "eval_metrics", {}).get("loss"),
             "valid_perplexity": getattr(exp, "valid_perplexity", None)}
    r = {"device": str(exp.device), "backend": dist.backend(), "mesh": exp.mesh.shape,
         "data_index": exp.mesh.data_index, "model_index": exp.mesh.model_index,
         "wall_s": wall, "steps": hook.steps, "launches": dict(ops.LAUNCHES),
         "specs": specs, "shapes": {p: list(t.shape) for p, t in bridge._leaves(exp.state.params)},
         "replicated_sha256": _sha256(replicated), "final": final,
         "profile": _profile_summary(hook.prof, profiled["ms"])}
    r["compare"] = compare(args, exp, Path(out_dir) / f"{name}_rank{dist.process_index()}")
    return r


def _sha256(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _ma_compare(init, cfg, loss_fn, rules, opt_fn, batch, grad_norm=False):
    """``compare(args, exp, path)``: one float32 step from ``init`` on
    ``batch`` on this rank's mesh (saved to ``path``.npz), and on the chief
    the same step on a mesh of one rank (``path``_one.npz); returns the
    losses, the negatives drawn and (``grad_norm``) the global gradient's
    norm before the clip."""
    from distributed_tensorflow_examples_tpu_torch.models import word2vec
    from distributed_tensorflow_examples_tpu_torch.parallel import dist
    from distributed_tensorflow_examples_tpu_torch.parallel.mesh import Mesh
    from distributed_tensorflow_examples_tpu_torch.train import state
    from distributed_tensorflow_examples_tpu_torch.train import step as step_lib

    def compare(args, exp, path):
        dev_batch = {k: torch.from_numpy(v).to(exp.device) for k, v in batch.items()}

        def one_step(mesh):
            opt = opt_fn(args)
            st, _specs = state.create_sharded_state(lambda s: init, opt, SEED, exp.device,
                                                    mesh=mesh, rules=rules)
            before = _leaf_arrays(st.params)
            drawn, draw = [], word2vec.log_uniform_sample

            def recording(rng, n, v, device="cpu"):
                ids = draw(rng, n, v, device)
                drawn.append(ids.cpu().tolist())
                return ids

            word2vec.log_uniform_sample = recording
            try:
                st, m = step_lib.build_train_step(loss_fn, opt, mesh=mesh)(st, dev_batch)
            finally:
                word2vec.log_uniform_sample = draw
            after = _leaf_arrays(st.params)
            return float(m["loss"]), {p: after[p] - before[p] for p in after}, after, drawn

        out = {}
        loss, update, after, drawn = one_step(exp.mesh)
        np.savez(f"{path}.npz", **{f"u:{p}": a for p, a in update.items()},
                 **{f"p:{p}": a for p, a in after.items()})
        out.update(loss=loss, negatives=drawn)
        if dist.is_chief():
            one = Mesh(device=exp.device, shape={"data": 1})
            loss1, update1, after1, drawn1 = one_step(one)
            np.savez(f"{path}_one.npz", **{f"u:{p}": a for p, a in update1.items()},
                     **{f"p:{p}": a for p, a in after1.items()})
            out.update(one_loss=loss1, one_negatives=drawn1)
            if grad_norm:
                st, _specs = state.create_sharded_state(lambda s: init, opt_fn(args), SEED,
                                                        exp.device, mesh=one)
                loss_fn(st.params, st.model_state, dev_batch, None)[0].backward()
                out["global_grad_norm"] = float(torch.sqrt(sum(
                    p.grad.double().square().sum() for p in state.leaves(st.params))))
        dist.barrier("ma-compare")
        return out

    return compare


def ma_rank(out_dir: str) -> None:
    """One rank of phase 12 (a) and (b): W4 and W5 through their CLIs'
    ``run_training`` at ``MA_MESH``, each with its compared step."""
    import dataclasses as dc

    from distributed_tensorflow_examples_tpu_torch.data import datasets
    from distributed_tensorflow_examples_tpu_torch.examples import ptb_lstm
    from distributed_tensorflow_examples_tpu_torch.examples import word2vec as w2v_cli
    from distributed_tensorflow_examples_tpu_torch.models import lstm, word2vec
    from distributed_tensorflow_examples_tpu_torch.parallel import dist
    from distributed_tensorflow_examples_tpu_torch.train import optim

    torch.backends.cuda.matmul.allow_tf32 = False
    wargs = w2v_cli.build_parser().parse_args([f"--seed={SEED}"])
    wcfg = w2v_cli.config_from_args(wargs)
    ids, _v, _s = datasets.text_corpus(None, vocab_size=wargs.vocab_size, seed=SEED)
    wbatch = next(datasets.skipgram_batches(ids, batch_size=wargs.batch_size,
                                            window=wargs.window, seed=SEED))
    w4 = _ma_run(out_dir, "w4", w2v_cli, [], _ma_compare(
        word2vec.init_numpy(wcfg, SEED), wcfg, word2vec.loss_fn(wcfg), word2vec.SHARDING_RULES,
        lambda a: optim.SGD(a.learning_rate), wbatch))

    largs = ptb_lstm.build_parser().parse_args([f"--seed={SEED}"])
    c32 = dc.replace(ptb_lstm.config_from_args(largs), compute_dtype="float32")
    train_ids, _v, _voc, _src = datasets.ptb(None, vocab_size=largs.vocab_size, seed=SEED)
    lbatch = next(datasets.lm_batches(train_ids, batch_size=largs.batch_size,
                                      seq_len=largs.seq_len))
    w5 = _ma_run(out_dir, "w5", ptb_lstm, [], _ma_compare(
        lstm.init_numpy(c32, SEED, batch_size=largs.batch_size), c32, lstm.loss_fn(c32),
        lstm.SHARDING_RULES, lambda a: optim.SGD(a.learning_rate, clip_norm=DP_LSTM_CLIP),
        lbatch, grad_norm=True))
    _rank_result(out_dir, {"rank": dist.process_index(), "w4": w4, "w5": w5})


def zero_resnet_rank(out_dir: str, steps: int) -> None:
    """One rank of phase 12 (c): ``examples.resnet50``'s ``run_training``
    with ``--zero_opt`` and then without, on the fused statistics path,
    from the same weights and batches, cuDNN deterministic."""
    from distributed_tensorflow_examples_tpu_torch import ops
    from distributed_tensorflow_examples_tpu_torch.examples import resnet50 as cli
    from distributed_tensorflow_examples_tpu_torch.models import resnet
    from distributed_tensorflow_examples_tpu_torch.parallel import dist
    from distributed_tensorflow_examples_tpu_torch.train import optim, state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    base = [f"--batch_size={RESNET_BATCH}", f"--image_size={RESNET_IMAGE}", "--num_classes=1000",
            f"--train_steps={steps}", "--learning_rate=0.1", "--momentum=0.9",
            "--log_every_steps=1", f"--seed={SEED}", f"--synthetic_examples={DP_EXAMPLES}"]
    runs, params = {}, {}

    def run(name, extra):
        args = cli.build_parser().parse_args(base + extra)
        cfg = cli.config_from_args(args)
        hook = dp_step_hook(("bn_stats", "bn_bwd_stats"))
        ops.reset_launches()
        exp = cli.run_training(args, loss_fn_factory=lambda mesh: resnet.loss_fn(cfg, mesh=mesh),
                               extra_hooks=[hook])
        leaves = state.leaves(exp.state.params)
        opt_specs = [tuple(s) for s in state.leaves(exp.specs["opt_state"])]
        runs[name] = {
            "steps": hook.steps, "launches": dict(ops.LAUNCHES),
            "opt_bytes": optim.state_bytes(exp.state.opt_state),
            "replicated_bytes": sum(p.numel() * 4 for p in leaves),
            "zero_bytes": sum(p.numel() * 4 // (2 if "data" in s else 1)
                              for p, s in zip(leaves, opt_specs)),
            "zero_leaves": sum("data" in s for s in opt_specs), "leaves": len(leaves),
            "param_sha256": state.params_sha256(exp.state.params),
            "backend": dist.backend(), "device": str(exp.device),
        }
        params[name] = [p.detach().clone() for p in leaves]
        del exp
        torch.cuda.empty_cache()

    run("zero", ["--zero_opt"])
    run("replicated", [])
    bitwise = all(torch.equal(a, b) for a, b in zip(params["zero"], params["replicated"]))
    result = {"rank": dist.process_index(), "runs": runs, "bitwise": bitwise}
    if not bitwise:  # the float32 noise floor: the replicated run again
        run("replicated_again", [])
        result["zero_vs_replicated"] = _leaf_rel_errors(params["zero"], params["replicated"])
        result["noise"] = _leaf_rel_errors(params["replicated_again"], params["replicated"])
    _rank_result(out_dir, result)


def _ma_load(out: str, name: str, rank: int, one: bool = False) -> dict:
    path = Path(out) / f"{name}_rank{rank}{'_one' if one else ''}.npz"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _ma_global(out: str, name: str, ranks: list) -> dict:
    """The ranks' compared-step arrays put together: a leaf sharded over
    ``model`` concatenated along its sharded dim in model order."""
    parts = [_ma_load(out, name, r["rank"]) for r in ranks]
    specs = ranks[0][name]["specs"]
    order = np.argsort([r[name]["model_index"] for r in ranks])
    out_arrays = {}
    for key in parts[0]:
        spec = specs[key.split(":", 1)[1]]
        if "model" in spec:
            out_arrays[key] = np.concatenate([parts[i][key] for i in order],
                                             axis=spec.index("model"))
        else:
            out_arrays[key] = parts[0][key]
    return out_arrays


def _ma_check(card: str, out: str, name: str, ranks: list, outs: list, metric: str,
              rows: dict, unit: str, per_step: int, device: str) -> dict:
    """Phase 12's gates and report for one of W4 and W5."""
    runs = [r[name] for r in ranks]
    finals = [[l for l in o.splitlines() if l.startswith("FINAL ") and metric in l]
              for o in outs]
    log(f"  {name.upper()} at --mesh={MA_MESH}: {finals[0][:1]}")
    for r in runs:
        log(f"    rank (data {r['data_index']}, model {r['model_index']}): backend "
            f"{r['backend']} on {r['device']}, mesh {r['mesh']}, {r['wall_s']:.1f} s; "
            + ", ".join(f"{p} {r['shapes'][p]}" for p in rows))
    if any(r["backend"] != "gloo" or not r["device"].startswith(device) for r in runs):
        raise SystemExit(f"{name}: the ranks sharing the card did not take gloo on CUDA devices")
    if sorted(r["model_index"] for r in runs) != list(range(MA_RANKS)):
        raise SystemExit(f"{name}: the ranks are not the model axis's {MA_RANKS} positions")
    for p, (dim, full) in rows.items():
        if any(r["shapes"][p][dim] * MA_RANKS != full for r in runs):
            raise SystemExit(f"{name}: {p} is not split {MA_RANKS} ways along dim {dim}")
    if len({r["replicated_sha256"] for r in runs}) != 1:
        raise SystemExit(f"{name}: the replicated leaves differ between the model ranks")
    if len(finals[0]) != 1 or any(finals[1:]):
        raise SystemExit(f"{name}: the FINAL line must come from the chief alone")
    final = runs[0]["final"]["eval_loss" if name == "w4" else "valid_perplexity"]
    losses = [s["loss"] for s in runs[0]["steps"]]
    if final is None or not math.isfinite(final) or not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{name}: a loss or the final metric is not finite")
    if any(sum(r["launches"].values()) for r in runs):
        raise SystemExit(f"{name}: a hand kernel launched on a path that has none")
    cmp0 = runs[0]["compare"]
    sharded, one = _ma_global(out, name, ranks), _ma_load(out, name, 0, one=True)
    worst = max(float(np.max(np.abs(sharded[k] - one[k]))) for k in one)
    worst_update = max(float(np.max(np.abs(sharded[k] - one[k]))) for k in one
                       if k.startswith("u:"))
    loss_rel = abs(cmp0["loss"] - cmp0["one_loss"]) / abs(cmp0["one_loss"])
    negs_equal = all(r["compare"]["negatives"] == cmp0["one_negatives"] for r in runs)
    clip = (f"; the global gradient's norm {cmp0['global_grad_norm']:.4f} against the clip "
            f"{DP_LSTM_CLIP:g}" if "global_grad_norm" in cmp0 else "")
    negs = f"; negatives equal id for id: {negs_equal}" if name == "w4" else ""
    log(f"    compared step (float32, {MA_RANKS} model ranks vs 1 rank, same batch"
        f"{' and negatives' if name == 'w4' else ''}): loss {cmp0['loss']:.7f} vs "
        f"{cmp0['one_loss']:.7f} (rel {loss_rel:.2e}, tol {TOL_MA_LOSS_REL:g}); parameters "
        f"after the step max |d| {worst:.2e}, updates {worst_update:.2e} (tol "
        f"{TOL_MA_PARAM:g}){negs}{clip}")
    if loss_rel > TOL_MA_LOSS_REL or worst > TOL_MA_PARAM or (name == "w4" and not negs_equal):
        raise SystemExit(f"{name}: the model-sharded step disagrees with the 1-rank step")
    if "global_grad_norm" in cmp0 and cmp0["global_grad_norm"] <= DP_LSTM_CLIP:
        raise SystemExit(f"{name}: the compared step's clip did not engage")
    timed = [s["ms"] for s in runs[0]["steps"][1:] if not s["profiled"]]
    step_ms = float(np.median(timed))
    one_step = next(s for s in runs[0]["steps"][1:] if not s["profiled"])
    p = runs[0]["profile"]
    log(f"    e2e: step {step_ms:.3f} ms (rank 0, median of steps 2-{WORKLOAD_STEPS} without the "
        f"profiled one), {per_step / (step_ms / 1e3):.0f} {unit}/s; losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; final {final:.4f} [{card}]")
    for r in runs:
        step = next(s for s in r["steps"][1:] if not s["profiled"])
        log(f"    collectives a step (step {step['step']}), rank (data {r['data_index']}, model "
            f"{r['model_index']}): {account_line(step)}")
    if name == "w4":
        # As the JAX HLO test asserts of W4 on a model mesh: no tensor as
        # large as a whole [V, D] table crosses the mesh in any step.
        table = rows["emb/table"][1] * runs[0]["shapes"]["emb/table"][1] * 4
        biggest = max(hlo_analysis.max_tensor_bytes(_records(s)) for r in runs for s in r["steps"])
        log(f"    W4's largest tensor in a collective, any step, any rank: {biggest} bytes "
            f"(a whole table: {table})")
        if biggest >= table:
            raise SystemExit(f"w4: a collective moved a {biggest}-byte tensor, a whole table "
                             f"is {table}")
    log(f"    profiled step {MA_PROFILE_STEP}: {p['step_ms']:.2f} ms, device busy "
        f"{p['busy_ms']:.2f} ms ({p['kernels']} kernels), idle share {p['idle_share']:.1%}")
    t = one_step["traffic"]
    return {"step_ms": step_ms, "per_s": per_step / (step_ms / 1e3),
            "model_calls": t.get("model_fwd_calls", 0) + t.get("model_bwd_calls", 0)
            + t.get("model_clip_calls", 0),
            "model_bytes": t.get("model_fwd_bytes", 0) + t.get("model_bwd_bytes", 0)
            + t.get("model_clip_bytes", 0),
            "model_host_ms": 1e3 * (t.get("model_fwd_seconds", 0) + t.get("model_bwd_seconds", 0)
                                    + t.get("model_clip_seconds", 0)),
            "busy_ms": p["busy_ms"], "idle_share": p["idle_share"],
            "loss_rel": loss_rel, "max_param_err": worst}


def model_axis_end_to_end(card: str, phase9: dict | None = None, device: str = "cuda") -> dict:
    """Phase 12 (the module docstring): W4 and W5 at ``MA_MESH`` on two
    ranks sharing the card, beside ResNet-50 with ``--zero_opt`` on two data
    ranks; returns the measurements and the BN kernels' launches by rank.
    ``device="cpu"`` rehearses it on gloo CPU ranks (set the step counts
    and ResNet sizes down first)."""
    # W4 and W5's ranks side by side with ZeRO-1's.
    runs = side_by_side({"ma": (_ma_runs, card, device),
                         "zero": (zero_resnet, card, phase9 or {}, device)})
    return {**runs["ma"], "zero": runs["zero"]}


def _ma_runs(card: str, device: str) -> dict:
    """Phase 12 (a) and (b): W4 and W5 at ``MA_MESH`` on two ranks."""
    rank_device = None if device == "cuda" else device
    log(f"  W4 word2vec and W5 PTB LSTM at their CLI defaults on {MA_RANKS} ranks sharing the "
        f"card, --mesh={MA_MESH}, {WORKLOAD_STEPS} steps each")
    _codes, outs, out = _run_ranks(MA_RANKS, "ma_rank({out!r})", 300, rank_device)
    ranks = _read_ranks(out, MA_RANKS)
    result = {
        "w4": _ma_check(card, out, "w4", ranks, outs, "eval_loss=",
                        {"emb/table": (0, 10000), "nce/weights": (0, 10000),
                         "nce/bias": (0, 10000)}, "examples", 256, device),
        "w5": _ma_check(card, out, "w5", ranks, outs, "valid_perplexity=",
                        {"emb/table": (0, 10000), "softmax/kernel": (1, 10000),
                         "softmax/bias": (0, 10000)}, "tokens", 64 * 20, device),
    }
    return result


def zero_resnet(card: str, phase9: dict, device: str = "cuda") -> dict:
    """Phase 12 (c): ResNet-50 with ``--zero_opt`` against the replicated
    optimizer on ``DP_RANKS`` data ranks."""
    log(f"  ResNet-50 with --zero_opt and without on {DP_RANKS} data ranks sharing the card: "
        f"global batch {RESNET_BATCH}, {ZERO_STEPS} steps each, fused statistics, cuDNN "
        "deterministic")
    _codes, _outs, out = _run_ranks(DP_RANKS, f"zero_resnet_rank({{out!r}}, {ZERO_STEPS})", 300,
                                    None if device == "cuda" else device)
    ranks = _read_ranks(out, DP_RANKS)
    n_bn = len(fb.resnet50_bn_shapes(RESNET_BATCH // DP_RANKS, RESNET_IMAGE))
    want = {"bn_stats": n_bn, "bn_bwd_stats": n_bn}
    for r in ranks:
        z, rep = r["runs"]["zero"], r["runs"]["replicated"]
        log(f"    rank {r['rank']}: backend {z['backend']} on {z['device']}; optimizer bytes "
            f"{z['opt_bytes']} with ZeRO-1 ({z['zero_leaves']} of {z['leaves']} leaves sharded) vs "
            f"{rep['opt_bytes']} replicated ({z['opt_bytes'] / rep['opt_bytes']:.4f}); "
            f"parameters after {ZERO_STEPS} steps bitwise equal: {r['bitwise']}")
        if z["backend"] != "gloo" or not z["device"].startswith(device):
            raise SystemExit("ZeRO-1: the ranks sharing the card did not take gloo on CUDA")
        if z["opt_bytes"] != z["zero_bytes"] or rep["opt_bytes"] != rep["replicated_bytes"]:
            raise SystemExit("ZeRO-1: a rank's optimizer holds more than its block of the "
                             "sharded slots")
        for run in (z, rep):
            if any(s["launches"] != want for s in run["steps"]):
                raise SystemExit(f"ZeRO-1: each rank must launch {n_bn} of each BN kernel a step")
        if not r["bitwise"]:
            med = float(np.median(r["zero_vs_replicated"]))
            floor = float(np.median(r["noise"]))
            log(f"      not bitwise: per-leaf rel error median {med:.3e}, max "
                f"{max(r['zero_vs_replicated']):.3e}; the float32 noise floor (the replicated run "
                f"again) median {floor:.3e}, max {max(r['noise']):.3e}")
            if med > max(TOL_DP_VS_NOISE * floor, TOL_RESNET_GRAD) or max(
                    r["zero_vs_replicated"]) > max(TOL_DP_VS_NOISE * max(r["noise"]),
                                                   TOL_RESNET_GRAD):
                raise SystemExit("ZeRO-1: the parameters disagree with the replicated run")
    if len({r["runs"]["zero"]["param_sha256"] for r in ranks}) != 1:
        raise SystemExit("ZeRO-1: the data ranks end with different parameters")
    z0, rep0 = ranks[0]["runs"]["zero"], ranks[0]["runs"]["replicated"]
    ms = {k: float(np.median([s["ms"] for s in run["steps"][1:]]))
          for k, run in (("zero", z0), ("replicated", rep0))}
    log(f"    e2e: step {ms['zero']:.1f} ms with ZeRO-1, {ms['replicated']:.1f} ms replicated "
        f"(cuDNN deterministic; rank 0, median of steps 2-{ZERO_STEPS}); phase 9's 2-rank step "
        f"{phase9.get('step_ms', float('nan')):.1f} ms; collectives a ZeRO-1 step: "
        f"{account_line(z0['steps'][1])} [{card}]")
    return {"step_ms": ms["zero"], "replicated_step_ms": ms["replicated"],
            "opt_bytes": z0["opt_bytes"], "replicated_opt_bytes": rep0["opt_bytes"],
            "bitwise": all(r["bitwise"] for r in ranks),
            "launches": [{k: r["runs"]["zero"]["launches"].get(k, 0)
                          + r["runs"]["replicated"]["launches"].get(k, 0)
                          for k in ("bn_stats", "bn_bwd_stats")} for r in ranks]}


# ----------------------------------------------------------------------------
# Phase 13: the data planes and deploys at full width
# ----------------------------------------------------------------------------

#: ResNet-50's streamed data: ``imagenet_synthetic`` at RESNET_IMAGE and
#: 1000 classes, quantised to uint8 once, written in shards of this many
#: records: 4 train shards and 1 held out (the ``_holdout`` rule).
D13_SHARD_RECORDS = 256
D13_TRAIN_SHARDS = 4
#: W2 from a data service: CIFAR-10 synthetic rows written by the port's
#: ``.npz`` writer, 9 train shards (8 splits of 64-row local batches each)
#: and 1 held out; the supervised task dies after this many requests, about
#: 60 batches into the first of the run's ~2.8 epochs.
D13_W2_SHARD_ROWS = 512
D13_W2_SHARDS = 10
DSVC_KILL_AFTER_REQS = 60
#: The canary deploy: rows of each predict, answers each version must have
#: before a verdict (the policy's own ``min_requests``), the steps between
#: version 1 (the initial weights) and version 2, the logits' tolerance
#: against the version's own apply on the card at the replica's padded batch.
DEPLOY_ROWS = 8
DEPLOY_MIN_ANSWERS = 20
DEPLOY_TRAIN_STEPS = 3
TOL_DEPLOY_LOGITS = 1e-2


def _quantise_u8(x: np.ndarray) -> np.ndarray:
    """Synthetic float images as the uint8 records a real image shard set
    holds (``image_decode_fn`` maps them back to ``v / 255 - 0.5``)."""
    return np.clip(np.rint((x * 0.125 + 0.5) * 255.0), 0, 255).astype(np.uint8)


def _write_image_shards(root: Path, ds, records: int) -> dict:
    """``ds``'s train rows then its test rows, quantised, written by the
    port's ``.dtxr`` and ``.npz`` writers; the last shard is the test split."""
    from distributed_tensorflow_examples_tpu_torch.data import filestream, native_loader

    arrays = {"image": _quantise_u8(np.concatenate([ds.train["image"], ds.test["image"]])),
              "label": np.concatenate([ds.train["label"], ds.test["label"]]).astype(np.int32)}
    t0 = time.perf_counter()
    dtxr = native_loader.write_raw_shards(str(root / "dtxr"), arrays, shard_records=records)
    t1 = time.perf_counter()
    npz = filestream.write_array_shards(str(root / "npz"), arrays, rows_per_shard=records)
    t2 = time.perf_counter()
    return {"dtxr": root / "dtxr", "npz": root / "npz", "held_out_labels": arrays["label"][-records:],
            "bytes": int(sum(a.nbytes for a in arrays.values())), "shards": len(dtxr),
            "dtxr_write_s": t1 - t0, "npz_write_s": t2 - t1, "npz_files": len(npz)}


class _InfeedProbes:
    """Instruments the streamed infeed of the runs inside it: the training
    loop's wait for each host batch (``Experiment.batches``' consumer), each
    train-time decode, the native loader's ``batches_produced``, the npz
    pipeline's ``stats``, and the data-service prefetcher's waits and
    payload bytes.  Restores everything on exit."""

    def __enter__(self):
        from distributed_tensorflow_examples_tpu_torch.data import (
            data_service,
            filestream,
            native_loader,
        )
        from distributed_tensorflow_examples_tpu_torch.train import runner

        self.waits, self.rows, self.decodes, self.loaders, self.pipes = [], [], [], [], []
        self.fetches: list = []  # (queue was empty, wait s, payload bytes)
        probes = self
        self._saved = [(runner.Experiment, "batches", runner.Experiment.batches),
                       (native_loader, "NativeFileStream", native_loader.NativeFileStream),
                       (filestream, "FileStreamPipeline", filestream.FileStreamPipeline),
                       (filestream, "image_decode_fn", filestream.image_decode_fn),
                       (data_service, "_BatchPrefetcher", data_service._BatchPrefetcher)]
        real_batches = runner.Experiment.batches
        real_decode_fn = filestream.image_decode_fn

        def batches(exp, local_iter):
            it = real_batches(exp, local_iter)
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        b = next(it)
                    except StopIteration:
                        return
                    probes.waits.append(time.perf_counter() - t0)
                    probes.rows.append(len(b["label"]))
                    yield b
            finally:
                it.close()

        class Loader(native_loader.NativeFileStream):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                probes.loaders.append(self)

        class Pipe(filestream.FileStreamPipeline):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                probes.pipes.append(self)

        def image_decode_fn(**kw):
            decode = real_decode_fn(**kw)
            if not kw.get("augment"):
                return decode  # the eval split's decode

            def timed(batch):
                t0 = time.perf_counter()
                out = decode(batch)
                probes.decodes.append(time.perf_counter() - t0)
                return out

            return timed

        class Prefetcher(data_service._BatchPrefetcher):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                get = self._q.get

                def timed_get(*ga, **gk):
                    empty = self._q.empty()
                    t0 = time.perf_counter()
                    item = get(*ga, **gk)
                    nbytes = (sum(v.nbytes for v in item.values()) if isinstance(item, dict)
                              else 0)
                    probes.fetches.append((empty, time.perf_counter() - t0, nbytes))
                    return item

                self._q.get = timed_get

        runner.Experiment.batches = batches
        native_loader.NativeFileStream = Loader
        filestream.FileStreamPipeline = Pipe
        filestream.image_decode_fn = image_decode_fn
        data_service._BatchPrefetcher = Prefetcher
        return self

    def __exit__(self, *exc):
        for owner, name, value in self._saved:
            setattr(owner, name, value)
        return False


def _resnet_streamed(card: str, kind: str, data_dir: str, shards: dict, phase5: dict,
                     device: str) -> tuple[dict, dict]:
    """ResNet-50 through ``examples.resnet50.run_training`` (the fused
    statistics path) from ``data_dir``; gates and prints as phase 13's
    docstring says.  Returns (the BN launches, the run's numbers)."""
    import contextlib
    import io

    from distributed_tensorflow_examples_tpu_torch import ops
    from distributed_tensorflow_examples_tpu_torch.examples import resnet50 as cli
    from distributed_tensorflow_examples_tpu_torch.models import resnet

    args = cli.build_parser().parse_args([
        f"--batch_size={RESNET_BATCH}", f"--image_size={RESNET_IMAGE}", "--num_classes=1000",
        f"--train_steps={RESNET_STEPS}", "--learning_rate=0.1", "--momentum=0.9",
        "--log_every_steps=1", f"--seed={SEED}", f"--device={device}", f"--data_dir={data_dir}",
    ])
    cfg = cli.config_from_args(args)
    n_bn = len(fb.resnet50_bn_shapes(RESNET_BATCH, RESNET_IMAGE)) if device == "cuda" else 0
    clock = step_clock(("bn_stats", "bn_bwd_stats"))
    final = io.StringIO()
    with _InfeedProbes() as probes:
        ops.reset_launches()  # every count to 0 just before the main path
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(final):
            exp = cli.run_training(args, loss_fn_factory=lambda mesh: resnet.loss_fn(cfg, mesh=mesh),
                                   extra_hooks=[clock])
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)  # read just after the main path
    final_line = [l for l in final.getvalue().splitlines() if l.startswith("FINAL ")]
    losses = [loss for _s, _ms, loss, _c in clock.steps]
    log(f"  {kind}: {final_line[0] if final_line else 'no FINAL line'}")
    if not probes.rows or set(probes.rows) != {RESNET_BATCH}:
        raise SystemExit(f"ResNet from {kind}: batches of {sorted(set(probes.rows))} rows, "
                         f"not {RESNET_BATCH}")
    log("    steps: " + ", ".join(
        f"{s}: loss {loss:.4f} in {ms:.1f} ms, launches {c['bn_stats']}/{c['bn_bwd_stats']}"
        for s, ms, loss, c in clock.steps))
    if exp.source.kind != kind:
        raise SystemExit(f"{data_dir} resolved to {exp.source.kind}, not {kind}")
    if not final_line or "test_accuracy=" not in final_line[0]:
        raise SystemExit(f"ResNet from {kind} printed no FINAL line with test_accuracy")
    if len(losses) != RESNET_STEPS or not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"ResNet from {kind}: losses not finite: {losses}")
    if abs(losses[0] - phase5["start"]) > TOL_RESNET_START:
        raise SystemExit(f"ResNet from {kind}: step 1 loss {losses[0]:.4f} not within "
                         f"{TOL_RESNET_START} of ln(1000) + l2 = {phase5['start']:.4f}")
    if any(c != {"bn_stats": n_bn, "bn_bwd_stats": n_bn} for *_r, c in clock.steps) or any(
            launches.get(k, 0) != n_bn * RESNET_STEPS for k in ("bn_stats", "bn_bwd_stats")):
        raise SystemExit(f"ResNet from {kind} did not run each BN kernel {n_bn} times a step")
    test = exp.source.ds.test
    if len(test["label"]) != D13_SHARD_RECORDS or not np.array_equal(
            test["label"], shards["held_out_labels"]):
        raise SystemExit(f"ResNet from {kind}: the eval split is not the held-out shard")
    later = [ms for _s, ms, _l, _c in clock.steps[1:]]
    step_ms = float(np.median(later))
    waits_ms = [w * 1e3 for w in probes.waits[1:RESNET_STEPS]]
    # The median hides a host-bound infeed while the batches the producer
    # made during step 1 last; the mean and the last step show it.
    r = {"step_ms": step_ms, "images_per_s": RESNET_BATCH / (step_ms / 1e3),
         "step_ms_mean": float(np.mean(later)), "last_step_ms": later[-1],
         "host_wait_ms_total": float(sum(waits_ms)),
         "first_loss": losses[0], "wall_s": wall,
         "host_wait_ms_median": float(np.median(waits_ms)) if waits_ms else float("nan"),
         "host_wait_ms_max": float(max(waits_ms)) if waits_ms else float("nan"),
         "first_batch_wait_ms": probes.waits[0] * 1e3 if probes.waits else float("nan"),
         "decode_ms_median": float(np.median(probes.decodes)) * 1e3 if probes.decodes
         else float("nan"), "decodes": len(probes.decodes),
         "test_accuracy": exp.test_metrics.get("accuracy", float("nan"))}
    line = (f"    {kind}: step {step_ms:.1f} ms (median of steps 2-{RESNET_STEPS}; mean "
            f"{r['step_ms_mean']:.1f}, the last {r['last_step_ms']:.1f}), "
            f"{r['images_per_s']:.0f} images/s; phase 5 in memory {phase5['step_ms']:.1f} ms; "
            f"the loop waited {r['host_wait_ms_median']:.2f} ms (median, max "
            f"{r['host_wait_ms_max']:.2f}, {r['host_wait_ms_total']:.0f} in all) a step for a "
            f"host batch, {r['first_batch_wait_ms']:.0f} ms for the first; {wall:.1f} s for "
            "source, init, steps and eval")
    if probes.decodes:
        line += (f"; decode {r['decode_ms_median']:.1f} ms a batch (median of "
                 f"{len(probes.decodes)}, u8 -> f32 + flips, host)")
    log(line + f" [{card}]")
    if kind == "native":
        r["batches_produced"] = int(sum(l.batches_produced for l in probes.loaders))
        log(f"    native loader: {len(probes.loaders)} stream(s), batches_produced "
            f"{r['batches_produced']} (the ring runs ahead of the {RESNET_STEPS} steps)")
    if kind == "stream":
        st = probes.pipes[0].stats
        r.update({f"stream_{k}": v for k, v in st.items()})
        log(f"    FileStreamPipeline stats: {json.dumps({k: round(v, 4) for k, v in st.items()})}")
    if kind == "dsvc":
        waits = [w for _e, w, _n in probes.fetches]
        payload = [n for _e, _w, n in probes.fetches if n]
        r.update({"wire_mb_per_batch": float(np.median(payload)) / 1e6 if payload else 0.0,
                  "prefetch_gets": len(probes.fetches),
                  "prefetch_empty": sum(e for e, _w, _n in probes.fetches),
                  "prefetch_wait_ms_median": float(np.median(waits)) * 1e3 if waits else 0.0,
                  "prefetch_wait_s_total": float(sum(waits))})
        log(f"    data service: {r['wire_mb_per_batch']:.1f} MB a batch on the wire (the decoded "
            f"f32 arrays; the JSON schema adds < 1 kB); prefetcher: {r['prefetch_empty']} of "
            f"{r['prefetch_gets']} gets found the queue empty, median wait "
            f"{r['prefetch_wait_ms_median']:.2f} ms, {r['prefetch_wait_s_total']:.2f} s in all")
    del exp
    if device == "cuda":
        torch.cuda.empty_cache()
    return launches, r


def _dsvc_cmd(ports: dict, data_dir: Path, batch_size: int, workers: str, *extra) -> list[str]:
    """A supervised ``--job_name=data_service`` task of the CIFAR-10 CLI
    (the data service is model-agnostic) over ``data_dir``'s ``.npz``."""
    return [sys.executable, "-m", "distributed_tensorflow_examples_tpu_torch.examples.cifar10_cnn",
            "--job_name=data_service", "--sync_replicas=false", "--device=cpu",
            f"--seed={SEED}", f"--worker_hosts={workers}", f"--batch_size={batch_size}",
            f"--data_service_hosts=127.0.0.1:{ports['dsvc']}", f"--data_dir={data_dir}", *extra]


def _dsvc_stop(port: int) -> dict:
    """The service's STATS, then its shutdown."""
    from distributed_tensorflow_examples_tpu_torch.data import data_service

    c = data_service.DataServiceClient("127.0.0.1", port, role="smoke_ds",
                                       reconnect_deadline_s=10.0)
    try:
        stats = c.stats()
        c.shutdown_server()
    finally:
        c.close()
    return stats


def _resnet_from_dsvc(card: str, shards: dict, phase5: dict, device: str) -> tuple[dict, dict]:
    import os

    from distributed_tensorflow_examples_tpu_torch.utils.multiprocess import free_port

    ports = {"dsvc": free_port()}
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="4")
    # The task serves batch_size // workers rows (at least 2 workers, as in
    # JAX): 2 x RESNET_BATCH over 2 gives the one training process its batch.
    cmds = {"data_service": _dsvc_cmd(ports, shards["npz"], 2 * RESNET_BATCH, "a:1,b:1")}
    got: dict = {}

    def during(cluster) -> None:
        cluster.wait_until(lambda: _listening(ports["dsvc"]))
        got["run"] = _resnet_streamed(card, "dsvc", f"dsvc://127.0.0.1:{ports['dsvc']}", shards,
                                      phase5, device)
        got["stats"] = _dsvc_stop(ports["dsvc"])

    outs = _run_cluster("resnet_dsvc", cmds, env, during=during)
    if f"DSVC_DONE port={ports['dsvc']}" not in outs["data_service"]:
        raise SystemExit("the ResNet data service printed no DSVC_DONE")
    st = got["stats"]
    log(f"    data service task: {st['batches_served']} batches served from {st['num_splits']} "
        f"splits, {st['epochs_completed']} epoch(s) completed, {st['requests']} requests")
    launches, r = got["run"]
    r["batches_served"] = st["batches_served"]
    return launches, r


def _listening(port: int) -> bool:
    import socket

    try:
        socket.create_connection(("127.0.0.1", port), timeout=2.0).close()
    except OSError:
        return False
    return True


def _w2_from_dsvc(card: str, phase10: dict, root: Path, device: str, steps: int) -> dict:
    """W2 (CIFAR-10 CNN at its CLI defaults, async) as a supervised PS task,
    the chief and 2 workers reading ``dsvc://`` from one supervised
    data_service task, killed once by ``DTX_FAULT_PLAN``."""
    import os
    import re

    from distributed_tensorflow_examples_tpu_torch.data import datasets, filestream
    from distributed_tensorflow_examples_tpu_torch.utils.multiprocess import free_ports

    name = "w2_async_dsvc"
    n_rows = D13_W2_SHARD_ROWS * D13_W2_SHARDS
    ds = datasets.cifar10(None, seed=SEED)
    rows = {k: np.concatenate([ds.train[k], ds.test[k]])[-n_rows:] for k in ("image", "label")}
    filestream.write_array_shards(str(root / "cifar"), {"image": _quantise_u8(rows["image"]),
                                                        "label": rows["label"].astype(np.int32)},
                                  rows_per_shard=D13_W2_SHARD_ROWS)
    ps_port, dport = free_ports(2)
    ports = {"dsvc": dport}
    common = _ps_common("cifar10_cnn", [ps_port], steps, "--sync_replicas=false",
                        "--max_staleness=4", f"--data_dir=dsvc://127.0.0.1:{dport}")
    dsvc_task = _dsvc_cmd(ports, root / "cifar", 128, PS_WORKERS,
                          f"--ps_hosts=127.0.0.1:{ps_port}")
    trainers = {"ps": [*common, "--job_name=ps"],
                "chief": [*common, "--job_name=chief", f"--device={device}"],
                **{f"worker{w}": [*common, "--job_name=worker", f"--task_index={w}",
                                  f"--device={device}"] for w in range(2)}}
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               DTX_FAULT_PLAN=f"die:role=data_service0,after_reqs={DSVC_KILL_AFTER_REQS}")
    got: dict = {}

    def during(cluster) -> None:
        cluster.wait_until(lambda: _listening(dport))
        for k, c in trainers.items():
            cluster.spawn(k, c, env=env, cwd=str(ROOT))
        cluster.finish(list(trainers))
        got["stats"] = _dsvc_stop(dport)

    t0 = time.perf_counter()
    outs = _run_cluster(name, {"data_service": dsvc_task}, env, during=during)
    wall_s = time.perf_counter() - t0
    match, cstats, wstats = _cluster_checks(name, outs, "async", steps, device)
    dsvc_out = outs["data_service"]
    restarts = len(re.findall(r"child exited 43", dsvc_out))
    if restarts != 1 or "supervisor_healed_plan" not in dsvc_out:
        raise SystemExit(f"{name}: the data service was not killed and restarted once "
                         f"({restarts} fault exits)")
    if f"DSVC_DONE port={dport}" not in dsvc_out:
        raise SystemExit(f"{name}: the data service printed no DSVC_DONE")
    reinc = [outs[f"worker{w}"].count("event=dsvc_reincarnation") for w in range(2)]
    if min(reinc) < 1:
        raise SystemExit(f"{name}: a worker's client logged no dsvc_reincarnation: {reinc}")
    st = got["stats"]
    if st["epochs_completed"] < 1 or st["last_epoch_min_visits"] < 1:
        raise SystemExit(f"{name}: no epoch of the restarted service visited every split: {st}")
    hand = [cstats["hand_kernel_launches"], *(w["hand_kernel_launches"] for w in wstats)]
    if any(hand):
        raise SystemExit(f"{name}: hand kernels launched (chief, workers): {hand}")
    gaps = np.diff(cstats["apply_done_s"]) * 1e3
    sps = cstats["applies_per_s_second_half"]
    p10 = phase10.get("w2_async", {})
    r = {"applied_steps_per_s": sps, "apply_wall_ms": 1e3 / sps,
         "stale_dropped": int(match.group(3)), "test_accuracy": float(match.group(4)),
         "contributed": [w["contributed"] for w in wstats], "reincarnations_seen": reinc,
         "longest_apply_gap_ms": float(gaps.max()), "median_apply_gap_ms": float(np.median(gaps)),
         "longest_gap_after_apply": int(np.argmax(gaps)) + 1,
         "dsvc_epochs_completed": st["epochs_completed"],
         "dsvc_batches_served": st["batches_served"], "dsvc_reassigned": st["reassigned"],
         **{f"worker{w}_{k}": ws[f"median_{k}"]
            for w, ws in enumerate(wstats) for k in ("pull_ms", "grad_ms", "push_ms")},
         "wall_s": wall_s}
    log(f"  {name}: {match.group(0)}")
    log(f"    1 PS task, the chief and 2 workers on {device} reading dsvc:// from 1 supervised "
        f"data_service task ({D13_W2_SHARDS - 1} splits of {D13_W2_SHARD_ROWS} CIFAR rows, local "
        f"batch 64), killed after {DSVC_KILL_AFTER_REQS} requests and restarted once; "
        f"{wall_s:.1f} s wall [{card}]")
    log(f"    second half of the applies: {sps:.1f} applied steps/s ({r['apply_wall_ms']:.3f} ms "
        f"an applied step); phase 10's in-memory W2 in this run: "
        f"{p10.get('applied_steps_per_s', float('nan')):.1f} applied steps/s")
    log(f"    the kill: the longest gap between two applies {r['longest_apply_gap_ms']:.1f} ms "
        f"(after apply {r['longest_gap_after_apply']}; median {r['median_apply_gap_ms']:.3f} ms); "
        f"dsvc_reincarnation logged by the workers {reinc}; the restarted service completed "
        f"{st['epochs_completed']} epoch(s), every split visited (least visits "
        f"{st['last_epoch_min_visits']}), {st['batches_served']} batches served, "
        f"{st['reassigned']} reassigned; contributed {r['contributed']}")
    for w, ws in enumerate(wstats):
        log(f"    worker {w} medians: pull {ws['median_pull_ms']:.3f} ms, H2D + gradient + D2H "
            f"{ws['median_grad_ms']:.3f} ms, push {ws['median_push_ms']:.3f} ms")
    return r


def _cnn_canary_deploy(card: str, root: Path, device: str) -> dict:
    """A canary deploy and a rollback of the W2 CNN on port replicas on the
    card, a client predicting throughout (phase 13 (e))."""
    from distributed_tensorflow_examples_tpu_torch import bridge, serve
    from distributed_tensorflow_examples_tpu_torch.data import datasets
    from distributed_tensorflow_examples_tpu_torch.models import cnn
    from distributed_tensorflow_examples_tpu_torch.train import optim, state, step

    cfg = cnn.Config()
    init = cnn.init_numpy(cfg, SEED)
    ds = datasets.cifar10(None, seed=SEED)
    opt = optim.SGD(0.05)
    st = state.create_state(lambda seed: init, opt, SEED, device)
    train_step = step.build_train_step(cnn.loss_fn(cfg), opt)
    for i in range(DEPLOY_TRAIN_STEPS):
        batch = {k: torch.from_numpy(v[i * 128:(i + 1) * 128]).to(device)
                 for k, v in ds.train.items()}
        st, m = train_step(st, batch)
        float(m["loss"])
    flats = {1: bridge.flat_params_of(init), 2: bridge.flat_params_of(st.params)}
    reg = serve.ModelRegistry(str(root / "registry"))
    for v in (1, 2):
        reg.publish("default", flats[v], step=0 if v == 1 else DEPLOY_TRAIN_STEPS, version=v)
    predict = lambda p, b: cnn.apply(cfg, p, b["image"])  # noqa: E731
    x = ds.test["image"][:DEPLOY_ROWS].astype(np.float32)
    # Each version's own apply on the card at the replica's padded batch.
    max_batch = 32
    _total, unflatten = bridge.flat_param_spec(init)
    padded = np.zeros((max_batch, *x.shape[1:]), np.float32)
    padded[:DEPLOY_ROWS] = x
    with torch.inference_mode():
        want = {v: predict(unflatten(flats[v], device),
                           {"image": torch.from_numpy(padded).to(device)})[:DEPLOY_ROWS]
                .float().cpu().numpy() for v in (1, 2)}
    make = serve.make_pinned_factory(init, predict, [], registry_dir=str(root / "registry"),
                                     device=device, membership=False, max_batch=max_batch,
                                     max_wait_ms=1.0)
    pool = serve.ServePool([("127.0.0.1", 1)], role="canary_sv", op_timeout_s=10.0,
                           deadline_s=60.0)
    answers: list = []
    failures: list = []
    stop = threading.Event()

    def client() -> None:
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                _step, out = pool.predict({"image": x})
            except Exception as e:  # noqa: BLE001 — every failure is counted
                failures.append(repr(e))
                return
            answers.append((pool.last_version, (time.perf_counter() - t0) * 1e3,
                            next(iter(out.values()))))

    def wait_for(pred, what: str) -> None:
        end = time.monotonic() + 60.0
        while not pred():
            if failures or time.monotonic() > end:
                raise SystemExit(f"canary deploy: no {what} ({len(failures)} failed predicts: "
                                 f"{failures[:2]})")
            time.sleep(0.005)

    dep = serve.RollingDeploy(make, replicas=2, version=1, on_change=pool.set_addrs)
    asker = threading.Thread(target=client, daemon=True)
    asker.start()
    try:
        wait_for(lambda: len(answers) >= DEPLOY_MIN_ANSWERS, "version 1 answers")
        dep.canary(2)
        pool.set_canary(2, 0.5)
        wait_for(lambda: pool.version_stats().get(2, {}).get("ok", 0) >= DEPLOY_MIN_ANSWERS,
                 "canary evidence")
        vs = pool.version_stats()
        verdict = serve.canary_verdict(vs.get(1), vs.get(2))
        gate = serve.canary_verdict(vs.get(1), vs.get(2), p99_factor=float("inf"))
        if gate != "promote":
            raise SystemExit(f"canary deploy: verdict {gate} on {vs}")
        pool.clear_canary()
        t0 = time.perf_counter()
        replaced = dep.promote(2)
        flip_s = time.perf_counter() - t0
        promoted_at = len(answers)
        if sorted(dep.versions().values()) != [2, 2, 2] or replaced != 2:
            raise SystemExit(f"canary deploy: after the promote {dep.versions()}")
        wait_for(lambda: len(answers) >= promoted_at + DEPLOY_MIN_ANSWERS, "promoted answers")
        second_at = len(answers)
        # A second deploy (version 1 again), then its rollback.
        dep.canary(1)
        pool.set_canary(1, 0.5)
        before = pool.version_stats().get(1, {}).get("ok", 0)
        wait_for(lambda: pool.version_stats().get(1, {}).get("ok", 0) >= before + 5,
                 "second canary answers")
        pool.clear_canary()
        t0 = time.perf_counter()
        stopped = dep.rollback(1)
        rollback_s = time.perf_counter() - t0
        rolled_at = len(answers)
        wait_for(lambda: len(answers) >= rolled_at + DEPLOY_MIN_ANSWERS, "answers after rollback")
    finally:
        stop.set()
        asker.join(60)
    vs = pool.version_stats()
    left = dep.versions()
    dep.close()
    pool.close()
    if failures:
        raise SystemExit(f"canary deploy: {len(failures)} predicts failed: {failures[:3]}")
    if stopped != 1 or not left or set(left.values()) != {2}:
        raise SystemExit(f"canary deploy: the rollback left {left} (stopped {stopped})")
    versions = [v for v, _ms, _o in answers]
    if set(versions) != {1, 2}:
        raise SystemExit(f"canary deploy: answers carried versions {set(versions)}")
    if 1 in versions[promoted_at:second_at] or versions[-1] != 2:
        raise SystemExit("canary deploy: a version 1 answer after the promote (before the "
                         "second deploy) or after the rollback")
    errs = {1: 0.0, 2: 0.0}
    for v, _ms, out in answers:
        # bfloat16 logits arrive as a CPU tensor (numpy has no bfloat16).
        got = out.float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float32)
        errs[v] = max(errs[v], float(np.abs(got - want[v]).max()))
    if max(errs.values()) > TOL_DEPLOY_LOGITS:
        raise SystemExit(f"canary deploy: logits off their version's apply: {errs}")
    lat = {v: np.array([ms for vv, ms, _o in answers if vv == v]) for v in (1, 2)}
    r = {"predicts": len(answers), "failed": len(failures), "flip_s": flip_s,
         "rollback_s": rollback_s, "verdict": verdict,
         **{f"v{v}_predicts": int(len(lat[v])) for v in (1, 2)},
         **{f"v{v}_p50_ms": float(np.percentile(lat[v], 50)) for v in (1, 2)},
         **{f"v{v}_p99_ms": float(np.percentile(lat[v], 99)) for v in (1, 2)},
         **{f"v{v}_max_abs_err": errs[v] for v in (1, 2)}}
    log(f"  canary deploy of the W2 CNN ({DEPLOY_ROWS}-row predicts, replicas pinned on "
        f"{device}, max_batch {max_batch}): 2 replicas at v1 -> canary v2 (weight 0.5) -> "
        f"verdict {verdict} (latency factor left out of the gate: {gate}) -> promote in "
        f"{flip_s:.2f} s -> canary v1 -> rollback in {rollback_s:.2f} s; {len(answers)} "
        f"predicts, 0 failed; left {sorted(left.values())} [{card}]")
    log("    per version: " + "; ".join(
        f"v{v} {len(lat[v])} predicts, client p50 {r[f'v{v}_p50_ms']:.3f} ms, p99 "
        f"{r[f'v{v}_p99_ms']:.3f} ms, logits within {errs[v]:.2e} of its apply "
        f"(tol {TOL_DEPLOY_LOGITS:g})" for v in (1, 2)))
    return r


def data_planes_end_to_end(card: str, phase5: dict | None = None, phase10: dict | None = None,
                           device: str = "cuda") -> dict:
    """Phase 13 of the module docstring: ResNet-50 from ``.dtxr``, ``.npz``
    and ``dsvc://``, W2's PS cluster reading a data service that is killed
    once, and a canary deploy of the W2 CNN.  ``phase5``/``phase10``: the
    in-memory numbers printed beside (measured here when not given)."""
    import shutil as shutil_lib
    import tempfile

    from distributed_tensorflow_examples_tpu_torch.data import datasets
    from distributed_tensorflow_examples_tpu_torch.examples import resnet50 as cli
    from distributed_tensorflow_examples_tpu_torch.models import resnet

    base = dict(phase5 or {})
    if "start" not in base:
        args = cli.build_parser().parse_args(["--num_classes=1000", f"--seed={SEED}"])
        init = resnet.init_numpy(cli.config_from_args(args), SEED)
        base["start"] = math.log(1000) + 1e-4 * float(sum(
            np.sum(np.square(k, dtype=np.float64)) for k in resnet._kernels(init[0])))
        base.setdefault("step_ms", float("nan"))
        del init
    root = Path(tempfile.mkdtemp(prefix="dtx_dataplanes_"))
    results: dict = {}
    launches: dict = {}
    try:
        t0 = time.perf_counter()
        ds = datasets.imagenet_synthetic(
            image_size=RESNET_IMAGE, n_train=D13_TRAIN_SHARDS * D13_SHARD_RECORDS,
            n_test=D13_SHARD_RECORDS, num_classes=1000, seed=SEED)
        shards = _write_image_shards(root, ds, D13_SHARD_RECORDS)
        del ds
        log(f"  data: imagenet_synthetic {RESNET_IMAGE}^2 x 1000 classes, "
            f"{(D13_TRAIN_SHARDS + 1) * D13_SHARD_RECORDS} images as uint8 "
            f"({shards['bytes'] / 1e6:.0f} MB), {shards['shards']} shards of "
            f"{D13_SHARD_RECORDS} ({D13_TRAIN_SHARDS} train, 1 held out) in each format: .dtxr "
            f"written in {shards['dtxr_write_s']:.1f} s, .npz in {shards['npz_write_s']:.1f} s; "
            f"{time.perf_counter() - t0:.1f} s with the draw")
        for kind, fmt in (("native", "dtxr"), ("stream", "npz")):
            launches[kind], results[f"resnet_{kind}"] = _resnet_streamed(
                card, kind, str(shards[fmt]), shards, base, device)
        launches["dsvc"], results["resnet_dsvc"] = _resnet_from_dsvc(card, shards, base, device)
        results["w2_dsvc"] = _w2_from_dsvc(card, phase10 or {}, root, device, PS_STEPS)
        results["deploy"] = _cnn_canary_deploy(card, root, device)
    finally:
        shutil_lib.rmtree(root, ignore_errors=True)
    results["launches"] = {name: [launches[k].get(name, 0) for k in ("native", "stream", "dsvc")]
                           for name in ("bn_stats", "bn_bwd_stats")}
    return results


# ----------------------------------------------------------------------------
# Phase 14: the flagship on a data x seq x model mesh (ring and Ulysses)
# ----------------------------------------------------------------------------

#: The runs of phase 14: (name, --mesh, --attention, DTX_FUSED_BWD), the
#: 2-rank run first, then the two 4-rank runs in one set of processes.
SP_RUNS_2 = (("ring_fused", "data=1,seq=2", "auto", "1"),)
SP_RUNS_4 = (("ring_split_tp", "data=1,seq=2,model=2", "auto", "0"),
             ("ulysses_tp", "data=1,seq=2,model=2", "ulysses", "0"))
SP_STEPS = 3
SP_PROFILE_STEP = 3
#: Steps 1-3's losses on the mesh against phase 6's one-process steps on
#: the same weights, batch and learning rate.  The ring's float32 partials
#: and the Ulysses all-to-alls change only bf16 roundings: the three runs
#: read at most 5e-4 apart (step 2), 7.1e-5 at step 1, on an H100.
TOL_SP_LOSS = 2e-3
#: The flagship's flags at T 8192 (phase 6's), without the step count.
SP_LAYERS = 12
SP_FLAGS = [f"--batch_size={LONG_BATCH}", f"--seq_len={LONG_T}", "--vocab_size=32000",
            "--dim=1024", f"--n_layers={SP_LAYERS}", "--n_heads=8", "--learning_rate=1e-3",
            "--log_every_steps=1", f"--seed={SEED}", "--device=cuda"]
SP_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv", "flash_fused_bwd")


def time_hop_routes(flash, card: str) -> dict:
    """Each flash kernel at a ring hop's shape, bf16 in: the float32-out
    route the hops take beside the bf16-out tensor-core kernel and SDPA at
    float32, causal (the diagonal hop) and full (the others), timed by
    ``tools/flash_bench.py``, each f32 route labelled as its library
    reports it.  Fails unless the libraries route bf16 in with f32 and with
    bf16 out of all four to the tensor cores."""
    bf16, f32 = torch.bfloat16, torch.float32
    bh, t = LONG_BATCH * 8, LONG_T // 2
    for name in SP_KERNELS:
        if not (flash.kernel_route(name, bf16, f32)[0] and flash.kernel_route(name, bf16, bf16)[0]):
            raise SystemExit(f"{name}: bf16 -> f32 and bf16 -> bf16 must take the tensor-core "
                             "kernel")
    out = fb.time_hop_routes(flash, bh, t, 128)
    for name, kinds in out.items():
        for kind, r in kinds.items():
            log(f"  hop route {name} [{bh}, {t}, 128] bf16 {kind}: f32 out ({r['route']}) "
                f"{r['f32_ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s), bf16 out (tensor cores) "
                f"{r['bf16_ms']:.4f} ms ({r['f32_ms'] / r['bf16_ms']:.2f}x), bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), SDPA at f32 {r['library_ms']:.4f} ms "
                f"[{card}]")
    return out


def _layer0_qkv(exp, cfg):
    """Layer 0's q, k, v [B, H, T, hd] (bf16, contiguous) over the whole
    sequence of the first batch, from the rank's parameters (replicated
    over ``seq``)."""
    from distributed_tensorflow_examples_tpu_torch.data import datasets
    from distributed_tensorflow_examples_tpu_torch.models import layers, transformer

    ids, _v, _s = datasets.text_corpus(
        None, vocab_size=cfg.vocab_size,
        synth_tokens=max(2_000_000, LONG_BATCH * (LONG_T + 1) * 50), seed=SEED)
    first = next(datasets.lm_batches(ids, batch_size=LONG_BATCH, seq_len=LONG_T))
    x = torch.from_numpy(first["x"]).to(exp.device)
    p = exp.state.params
    with torch.no_grad():
        h = layers.embedding_lookup(p["emb"], x, dtype=cfg.dtype)
        h = h + p["pos"]["table"][:LONG_T].to(cfg.dtype)[None]
        y = transformer._layernorm(p["block_0"]["ln1"], h)
        qkv = layers.dense(p["block_0"]["qkv"], y, dtype=cfg.dtype)
        qkv = qkv.reshape(LONG_BATCH, LONG_T, cfg.n_heads, 3, cfg.head_dim)
        return [qkv[:, :, :, j].movedim(2, 1).contiguous() for j in range(3)]


def _errors(got, want, rel: bool) -> float:
    err = (got.float() - want.float()).abs().max().item()
    return err / max(want.float().abs().max().item(), 1e-30) if rel else err


def sp_attention_gate(exp, cfg) -> dict:
    """On a rank of the ring run: ``ring_flash_attention`` over layer 0's
    q/k/v (this rank's slice of the sequence) and a random bf16 cotangent,
    fused and split hops, against the same ring with the plain versions
    (each hop's ``fwd_plain``, ``dq_plain``, ... on the card) and against
    one-rank ``flash_attention`` over the whole sequence (the tensor-core
    kernels): the output within ``TOL_O[bf16]``, each gradient within
    ``TOL_BWD[bf16]`` of the largest reference entry, phase 2's
    tolerances.  Every hop of the kernel ring must take the tensor
    cores."""
    from distributed_tensorflow_examples_tpu_torch import ops
    from distributed_tensorflow_examples_tpu_torch.ops import attention
    from distributed_tensorflow_examples_tpu_torch.ops import flash_attention as fa

    mesh = exp.mesh
    n, s = mesh.shape["seq"], mesh.seq_index
    q, k, v = _layer0_qkv(exp, cfg)
    g = torch.Generator(device=q.device).manual_seed(SEED + 14)
    do = torch.randn(q.shape, device=q.device, generator=g).to(q.dtype)
    tl = LONG_T // n
    sl = slice(s * tl, (s + 1) * tl)
    plain = {"fwd_call": fa.fwd_plain, "dq_call": fa.dq_plain, "dkv_call": fa.dkv_plain,
             "fused_bwd_call": fa.fused_bwd_plain}

    def run(fn, inputs, cot):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        o = fn(*leaves)
        o.backward(cot)
        torch.cuda.synchronize()
        return [o.detach()] + [t.grad for t in leaves]

    def ring():
        with mesh.axes():
            return run(lambda *a: attention.ring_flash_attention(*a, causal=True),
                       [t[:, :, sl] for t in (q, k, v)], do[:, :, sl])

    import os

    out = {}
    for mode in ("1", "0"):
        os.environ["DTX_FUSED_BWD"] = mode
        before = _launch_counts(ops)
        kern = ring()
        ran, ran_tc = _launches_since(ops, before)
        saved = {name: getattr(fa, name) for name in plain}
        try:
            for name, fn in plain.items():
                setattr(fa, name, fn)
            ref = ring()
        finally:
            for name, fn in saved.items():
                setattr(fa, name, fn)
        full = run(lambda *a: fa.flash_attention(*a, causal=True), [q, k, v], do)
        full = [full[0][:, :, sl]] + [t[:, :, sl] for t in full[1:]]
        errs = {"o_vs_plain": _errors(kern[0], ref[0], False),
                "o_vs_full": _errors(kern[0], full[0], False)}
        for i, name in enumerate(("dq", "dk", "dv"), 1):
            errs[f"{name}_vs_plain"] = _errors(kern[i], ref[i], True)
            errs[f"{name}_vs_full"] = _errors(kern[i], full[i], True)
        hops = s + 1  # the diagonal and every earlier rank's block
        bwd = {"flash_fused_bwd": hops} if mode == "1" else {"flash_dq": hops, "flash_dkv": hops}
        want = {"flash_fwd": hops, **bwd}
        got = {k2: c for k2, c in ran.items() if c}
        got_tc = {k2: c for k2, c in ran_tc.items() if c}
        ok = (got == want and got_tc == want
              and all(math.isfinite(e) for e in errs.values())
              and all(e <= (TOL_O if name.startswith("o_") else TOL_BWD)[torch.bfloat16]
                      for name, e in errs.items()))
        out[f"fused={mode}"] = {"errors": errs, "launches": got, "tc_launches": got_tc, "ok": ok}
    return out


def sp_rank(out_dir: str, runs: tuple) -> None:
    """One rank of phase 14: each run of ``runs`` through
    ``examples.transformer_lm.run_training`` at ``--mesh`` (every count to
    0 just before it, read just after), then, on the ring run of the
    2-rank set, the attention gate."""
    import os

    from distributed_tensorflow_examples_tpu_torch import ops
    from distributed_tensorflow_examples_tpu_torch.examples import transformer_lm as cli
    from distributed_tensorflow_examples_tpu_torch.parallel import collectives, dist

    torch.backends.cuda.matmul.allow_tf32 = False
    result: dict = {"rank": dist.process_index() if dist.is_initialized() else 0, "runs": {}}
    for name, mesh, attention_impl, fused in runs:
        os.environ["DTX_FUSED_BWD"] = fused
        args = cli.build_parser().parse_args(
            [*SP_FLAGS, f"--train_steps={SP_STEPS}", f"--mesh={mesh}",
             f"--attention={attention_impl}"])
        hook = dp_step_hook(kernels=SP_KERNELS, profile_step=SP_PROFILE_STEP)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()  # every count to 0 just before the main path
        collectives.TRAFFIC.clear()
        t0 = time.perf_counter()
        exp = cli.run_training(args, extra_hooks=[hook])
        wall = time.perf_counter() - t0
        launches, tc = dict(ops.LAUNCHES), dict(ops.TENSOR_CORE_LAUNCHES)  # just after
        profiled = next(st for st in hook.steps if st["profiled"])
        r = {"mesh": exp.mesh.shape, "backend": dist.backend(), "seq": exp.mesh.seq_index,
             "model": exp.mesh.model_index, "wall_s": wall, "steps": hook.steps,
             "launches": launches, "tc_launches": tc,
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "profile": _profile_summary(hook.prof, profiled["ms"])}
        if name == "ring_fused":
            r["gate"] = sp_attention_gate(exp, cli.config_from_args(args))
        result["runs"][name] = r
        del exp, hook
        torch.cuda.empty_cache()
    _rank_result(out_dir, result)


def _sp_expected(run: str, seq_index: int, layers: int) -> dict:
    """The launches one step of ``run`` must make on a rank at
    ``seq_index``: the causal ring visits the diagonal block and
    every earlier rank's (``seq_index + 1`` hops, f32 out); Ulysses runs
    one full-sequence flash call a layer.  Every launch takes the tensor
    cores."""
    hops = seq_index + 1
    if run == "ring_fused":
        want = {"flash_fwd": hops, "flash_fused_bwd": hops}
    elif run == "ring_split_tp":
        want = {"flash_fwd": hops, "flash_dq": hops, "flash_dkv": hops}
    else:
        want = {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    return {k: n * layers for k, n in want.items()}


def _sp_report(card: str, run: str, ranks: list, phase6_losses: list, layers: int) -> dict:
    """Gate and print one run of phase 14 over its ranks' results."""
    rs = [r["runs"][run] for r in ranks]
    losses = [[st["loss"] for st in r["steps"]] for r in rs]
    ok = all(len(ls) == len(phase6_losses) and all(math.isfinite(x) for x in ls)
             and ls[-1] < ls[0] for ls in losses)
    gaps = [max(abs(ls[i] - want) for ls in losses) if ok else math.inf
            for i, want in enumerate(phase6_losses)]
    log(f"  {run} ({rs[0]['mesh']}, {rs[0]['backend']}): losses by rank {losses}; phase 6's "
        f"{[round(x, 5) for x in phase6_losses]} (worst |Δ| by step "
        f"{', '.join(f'{g:.2e}' for g in gaps)}, tol {TOL_SP_LOSS:g})")
    if not ok or not max(gaps) <= TOL_SP_LOSS:
        raise SystemExit(f"phase 14 {run}: the losses do not fall, or disagree with phase "
                         f"6's one-process steps ({losses} vs {phase6_losses})")
    for r in rs:
        want = _sp_expected(run, r["seq"], layers)
        for st in r["steps"]:
            got = {k: c for k, c in st["launches"].items() if c}
            if got != want:
                raise SystemExit(f"phase 14 {run}: rank at seq {r['seq']} step {st['step']} "
                                 f"launched {got}, want {want} a step")
        tc = {k: c for k, c in r["tc_launches"].items() if c}
        if tc != {k: n * SP_STEPS for k, n in want.items()}:
            raise SystemExit(f"phase 14 {run}: tensor-core launches {tc}, want "
                             f"{want} a step")
    step_ms = float(np.median([st["ms"] for st in rs[0]["steps"][1:]]))
    tokens = LONG_BATCH * LONG_T
    log(f"  {run}: step {step_ms:.1f} ms (rank 0, median of steps 2-{SP_STEPS}, host clock to "
        f"the loss read), {tokens / (step_ms / 1e3):.0f} tokens/s; launches a step by rank "
        + "; ".join(f"seq {r['seq']} model {r['model']}: " + ", ".join(
            f"{k} {c}" for k, c in r["steps"][-1]["launches"].items() if c) for r in rs)
        + f" [{card}]")
    log(f"  {run}: traffic a step (rank 0, step {rs[0]['steps'][-2]['step']}): "
        + account_line(rs[0]["steps"][-2]))
    for r in rs:
        p = r["profile"]
        log(f"  {run}: rank seq {r['seq']} model {r['model']}: profiled step {p['step_ms']:.1f} "
            f"ms, device busy {p['busy_ms']:.1f} ms, idle {p['idle_share']:.1%}, "
            f"{p['kernels']} kernels; peak {r['peak_gb']:.2f} GB; run {r['wall_s']:.1f} s")
    return {"step_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
            "losses": losses[0], "loss_gaps": gaps,
            "idle_share": [r["profile"]["idle_share"] for r in rs],
            "launches": [r["launches"] for r in rs], "tc_launches": [r["tc_launches"] for r in rs],
            "traffic": rs[0]["steps"][-2]["traffic"]}


def seq_axis_end_to_end(card: str, phase6_losses: list | None = None,
                        hop_routes: dict | None = None) -> dict:
    """Phase 14 (the module docstring): the flagship at T 8192 on a
    ``data=1,seq=2`` mesh of 2 ranks (the fused ring) and, side by side, on
    ``data=1,seq=2,model=2`` of 4 (the split ring, then Ulysses), ranks
    sharing the card over gloo; returns each run's measurements and
    launches by rank.  Alone (no phase 6 before it): the first
    ``SP_STEPS`` steps of the one-process CLI at T 8192 are the loss
    yardstick, and the hop routes are timed first."""
    from distributed_tensorflow_examples_tpu_torch.examples import transformer_lm as cli
    from distributed_tensorflow_examples_tpu_torch.ops import flash_attention as flash

    layers = SP_LAYERS
    if hop_routes is None:
        hop_routes = time_hop_routes(flash, card)
    if phase6_losses is None:
        phase6_losses = _with_fused_env(
            "1", lambda: _step_losses(cli, SP_FLAGS[:-1], "cuda", SP_STEPS))
        torch.cuda.empty_cache()
    log(f"  the flagship at T {LONG_T}, batch {LONG_BATCH}, {SP_STEPS} steps a run: "
        f"{[r[:2] for r in SP_RUNS_2]} on 2 ranks, {[r[:3] for r in SP_RUNS_4]} on 4 "
        "(gloo, sharing the card)")
    t0 = time.perf_counter()
    # The 2-rank and the 4-rank spawns side by side (6 processes, ~60 GB of
    # the card at their peaks): their host-bound numbers carry each other's
    # load, their gates do not depend on it.
    spawned = side_by_side({
        2: (_run_ranks, 2, f"sp_rank({{out!r}}, {SP_RUNS_2!r})", 360),
        4: (_run_ranks, 4, f"sp_rank({{out!r}}, {SP_RUNS_4!r})", 420)})
    ranks2 = _read_ranks(spawned[2][2], 2)
    for r in ranks2:
        for mode, g in r["runs"]["ring_fused"]["gate"].items():
            log(f"  attention gate (rank {r['rank']}, DTX_FUSED_BWD {mode[-1]}): kernel ring "
                f"vs plain ring and vs one-rank flash_attention at T {LONG_T}: "
                + ", ".join(f"{k} {e:.3e}" for k, e in g["errors"].items())
                + f" (tol o {TOL_O[torch.bfloat16]:g} abs, gradients "
                f"{TOL_BWD[torch.bfloat16]:g} of the largest entry); launches {g['launches']}, "
                f"on the tensor cores {g['tc_launches']}")
            if not g["ok"]:
                raise SystemExit(f"phase 14: the ring's attention gate failed on rank "
                                 f"{r['rank']} ({mode}): {g}")
    ranks4 = _read_ranks(spawned[4][2], 4)
    result = {"ring_fused": _sp_report(card, "ring_fused", ranks2, phase6_losses, layers)}
    for run, *_rest in SP_RUNS_4:
        result[run] = _sp_report(card, run, ranks4, phase6_losses, layers)
    hop = hop_routes
    log(f"  hop kernels (CUDA events, [{LONG_BATCH * 8}, {LONG_T // 2}, 128] bf16 in, f32 out vs "
        "bf16 out): " + "; ".join(
            f"{k} ({v['causal']['route']}) causal {v['causal']['f32_ms']:.3f} vs "
            f"{v['causal']['bf16_ms']:.3f} ms, full {v['full']['f32_ms']:.3f} vs "
            f"{v['full']['bf16_ms']:.3f} ms" for k, v in hop.items())
        + f" [{card}]")
    log(f"  phase 14: the 2-rank and the 4-rank runs side by side {time.perf_counter() - t0:.1f} s")
    return result



# ----------------------------------------------------------------------------
# Phase 15: the MoE flagship and the expert axis
# ----------------------------------------------------------------------------

#: The MoE flagship of the JAX package's ``bench_moe``: 12 layers of 8
#: experts, top-2, capacity factor 1.25, routing groups of 1024 tokens, at
#: T 2048 and batch 4, bf16, clip 1.0 + AdamW 1e-3 from JAX ``init``'s
#: weights for seed 0.
MOE_BATCH, MOE_T, MOE_LAYERS, MOE_EXPERTS = 4, 2048, 12, 8
MOE_FLAGS = [f"--batch_size={MOE_BATCH}", f"--seq_len={MOE_T}", "--vocab_size=32000",
             "--dim=1024", f"--n_layers={MOE_LAYERS}", "--n_heads=8",
             f"--moe_experts={MOE_EXPERTS}", "--moe_capacity_factor=1.25",
             "--moe_group_size=1024", "--learning_rate=1e-3", "--clip_norm=1.0",
             "--log_every_steps=1", f"--seed={SEED}", "--attention=auto", "--device=cuda"]
#: (a): steps of the one-process run, and the step it profiles.
MOE_STEPS, MOE_PROFILE_STEP = 4, 3
#: (b): the expert mesh on 2 gloo ranks sharing the card, its steps and
#: profiled step; steps 1-3 against one process's steps on the same
#: global batches (each rank reads its row shard's block of the corpus)
#: from the same weights: the same routing groups (8 groups of 1024
#: tokens, 4 a rank), so only bf16 roundings of other matmul shapes
#: differ.  Step 1 is held to 2e-3 (phase 14's gate).  From step 2 on the
#: weights carry step 1's gradients, and a bf16 rounding flips routing
#: decisions (the flash and the xla step of one process route 6.3% of
#: their (token, choice) pairs apart at step 1 on an H100), each flip an
#: O(1) change of its token: steps 2-3 are held to 1.5e-2, and one
#: process's flash-against-xla gaps over the same steps are printed
#: beside them as the noise floor.
MOE_EP_MESH, MOE_EP_STEPS, MOE_EP_PROFILE_STEP = "data=1,expert=2", 3, 3
TOL_MOE_EP_LOSS, TOL_MOE_EP_LOSS_LATER = 2e-3, 1.5e-2
#: (c): one decode session on the pinned replica (one slot, a cache of
#: exactly the session's length, as ``generate``'s).
MOE_DECODE_PROMPT, MOE_DECODE_NEW = 16, 16
MOE_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
#: The aten ops of the routing, dispatch and combine (``ops/moe.py``: the
#: top-k sort, the places' running count, the slot copies both ways); the
#: experts' products are its only batched matmuls (``aten::bmm``).
MOE_DISPATCH_OPS = ("aten::sort", "aten::cumsum", "aten::one_hot", "aten::index_copy_",
                    "aten::index_select")


def moe_step_hook():
    """A training hook that records each step's ``moe_aux`` and, over step
    1, each MoE layer's share of (token, choice) pairs past capacity."""
    from distributed_tensorflow_examples_tpu_torch.ops import moe as moe_ops
    from distributed_tensorflow_examples_tpu_torch.train import hooks

    class MoEStep(hooks.Hook):
        def __init__(self):
            self.aux: list = []
            self.drops: list = []
            self._ctx = None

        def before_step(self, loop):
            if loop.step == 0:
                self._ctx = moe_ops.record_drops()
                self._seen = self._ctx.__enter__()

        def after_step(self, loop, metrics):
            self.aux.append(float(metrics["moe_aux"]))
            if self._ctx is not None:
                self._ctx.__exit__(None, None, None)
                self._ctx = None
                self.drops = [float(d) for d in self._seen]

    return MoEStep()


def _moe_profile_split(prof) -> dict:
    """A profiled MoE step's device ms (``tools/profile_step.py``): the
    flash kernels (by kernel name), the experts' products (``aten::bmm``)
    and the routing, dispatch and combine (``MOE_DISPATCH_OPS``), each op's
    own kernels."""
    trace = ps.load(prof)
    fams, by_op = ps.by_family(trace), ps.device_ms_by_op(trace)
    return {"attention_ms": sum(fams.get(f, {"ms": 0.0})["ms"] for f in ps.FLASH_FAMILIES),
            "expert_matmul_ms": by_op.get("aten::bmm", 0.0),
            "dispatch_combine_ms": sum(by_op.get(op, 0.0) for op in MOE_DISPATCH_OPS)}


def _moe_global_batches(cfg, shards: int, n: int) -> list:
    """The CLI's first ``n`` global batches over ``shards`` row shards
    (each shard's block of the corpus, its rows in shard order), on the
    card."""
    from distributed_tensorflow_examples_tpu_torch.data import datasets
    from distributed_tensorflow_examples_tpu_torch.parallel import sharding

    ids, _vocab, _src = datasets.text_corpus(
        None, vocab_size=cfg.vocab_size,
        synth_tokens=max(2_000_000, MOE_BATCH * (MOE_T + 1) * 50), seed=SEED)
    its = [datasets.lm_batches(block, batch_size=rows, seq_len=MOE_T)
           for block, rows in (sharding.stream_block(ids, MOE_BATCH, j, shards)
                               for j in range(shards))]
    out = []
    for _ in range(n):
        parts = [next(it) for it in its]
        out.append({k: torch.from_numpy(np.concatenate([p[k] for p in parts])).cuda()
                    for k in parts[0]})
    return out


def _routing_replay(decisions: list, replay: bool):
    """A stand-in for ``ops.moe.route`` that records each call's routing
    decisions (expert, place, kept) into ``decisions`` or, with
    ``replay``, routes by the recorded ones, the gates taken from this
    call's own probabilities at the recorded experts."""
    from distributed_tensorflow_examples_tpu_torch.ops import moe as moe_ops

    route, calls = moe_ops.route, []

    def replaying(tok32, router, moe, C):
        probs, idx, gates, pos, keep = route(tok32, router, moe, C)
        if not replay:
            decisions.append((idx, pos, keep))
            return probs, idx, gates, pos, keep
        idx, pos, keep = decisions[len(calls)]
        calls.append(idx)
        vals = probs.gather(-1, idx)
        gates = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9) * keep
        return probs, idx, gates, pos, keep

    return replaying


def _moe_reference(cfg, batches) -> dict:
    """From the initial weights: one step's loss and per-leaf gradients on
    ``batches[0]``, the flash kernels against plain mha
    (``attention="xla"``), routed freely and then by the flash step's
    routing decisions (bf16 roundings flip single choices near a tie or
    the capacity edge, and a flipped choice moves its token by O(1):
    the gate is the replayed routing's, the free one is printed with the
    share of decisions that differ); then one process's losses over
    ``batches`` (clip 1.0 + AdamW 1e-3, the CLI's optimizer): (b)'s
    yardstick."""
    from distributed_tensorflow_examples_tpu_torch import bridge
    from distributed_tensorflow_examples_tpu_torch.models import transformer
    from distributed_tensorflow_examples_tpu_torch.ops import moe as moe_ops
    from distributed_tensorflow_examples_tpu_torch.train import optim, state, step

    batch = batches[0]
    init = transformer.init_numpy(cfg, SEED)
    paths = [p for p, _l in bridge._leaves(init)]
    flash_routes: list = []
    xla_routes: list = []
    result = {}
    route = moe_ops.route
    for name, attention, stand_in in (
            ("flash", "auto", _routing_replay(flash_routes, False)),
            ("xla", "xla", _routing_replay(xla_routes, False)),
            ("xla_replayed", "xla", _routing_replay(flash_routes, True))):
        c = dataclasses.replace(cfg, attention=attention)
        params = state.as_param_leaves(init, "cuda")
        moe_ops.route = stand_in
        try:
            loss, (_s, metrics) = transformer.loss_fn(c)(params, {}, batch, None)
            loss.backward()
        finally:
            moe_ops.route = route
        result[name] = (loss.item(), float(metrics["moe_aux"]),
                        [p.grad for p in state.leaves(params)])
        del params, loss

    def rel_errors(got, want):
        return [((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
                for a, b in zip(got, want)]

    l_flash, a_flash, g_flash = result["flash"]
    free = rel_errors(g_flash, result["xla"][2])
    rels = rel_errors(g_flash, result["xla_replayed"][2])
    l_xla, a_xla = result["xla_replayed"][:2]
    l_free, a_free = result["xla"][:2]
    del result, g_flash
    pairs = sum(idx.numel() for idx, _p, _k in flash_routes)
    flipped = sum(int(((i1 != i2) | (k1 != k2)).sum())
                  for (i1, _p1, k1), (i2, _p2, k2) in zip(flash_routes, xla_routes))
    del flash_routes, xla_routes
    worst = int(np.argmax(rels))
    runs = {}
    for attention in ("auto", "xla"):
        opt = optim.ClippedAdamW(1e-3, 1.0)
        st = state.create_state(lambda seed: init, opt, SEED, "cuda")
        train_step = step.build_train_step(
            transformer.loss_fn(dataclasses.replace(cfg, attention=attention)), opt)
        runs[attention] = []
        for b in batches:
            st, m = train_step(st, b)
            runs[attention].append(float(m["loss"]))
        del st, opt, train_step
        torch.cuda.empty_cache()
    del init
    losses = runs["auto"]
    return {"loss": l_flash, "loss_xla": l_xla, "aux": a_flash, "aux_xla": a_xla,
            "grad_rel_max": rels[worst], "grad_rel_max_at": paths[worst],
            "grad_rel_median": float(np.median(rels)), "free_loss_xla": l_free,
            "free_aux_xla": a_free, "free_grad_rel_max": max(free),
            "free_grad_rel_median": float(np.median(free)),
            "free_flipped_share": flipped / pairs, "one_process_losses": losses,
            "one_process_xla_losses": runs["xla"]}


def moe_train(card: str, registry_dir: Path) -> dict:
    """Phase 15 (a): the MoE flagship through ``run_training`` on one
    process, published to ``registry_dir``; gates and prints (the module
    docstring); returns its measurements, launches and published version."""
    from distributed_tensorflow_examples_tpu_torch import ops
    from distributed_tensorflow_examples_tpu_torch.examples import transformer_lm as cli
    from distributed_tensorflow_examples_tpu_torch.train import state

    args = cli.build_parser().parse_args(
        [*MOE_FLAGS, f"--train_steps={MOE_STEPS}", f"--registry_dir={registry_dir}"])
    cfg = cli.config_from_args(args)
    hook = dp_step_hook(kernels=MOE_KERNELS, profile_step=MOE_PROFILE_STEP)
    moe_hook = moe_step_hook()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()  # every count to 0 just before the main path
    t0 = time.perf_counter()
    exp = cli.run_training(args, extra_hooks=[hook, moe_hook])
    wall = time.perf_counter() - t0
    launches, tc = dict(ops.LAUNCHES), dict(ops.TENSOR_CORE_LAUNCHES)  # just after
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for t in state.leaves(exp.state.params))
    version = exp.published_version
    del exp
    torch.cuda.empty_cache()

    losses = [st["loss"] for st in hook.steps]
    aux = moe_hook.aux
    ln_v = math.log(cfg.vocab_size)
    log(f"  (a) {MOE_STEPS} steps of [{MOE_BATCH}, {MOE_T}], {n_params} params "
        f"({n_params * 16 / 1e9:.2f} GB of f32 parameters, gradients and AdamW moments), "
        f"in {wall:.1f} s (corpus, init, steps, publish): losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; moe_aux "
        + ", ".join(f"{a:.4f}" for a in aux)
        + f"; step 1's loss + 0.01 aux {losses[0] + 0.01 * aux[0]:.4f} against ln(32000) + "
        f"0.01 aux {ln_v + 0.01 * aux[0]:.4f}")
    if (len(losses) != MOE_STEPS or not all(math.isfinite(x) for x in losses + aux)
            or abs(losses[0] - ln_v) > 0.5 or not losses[-1] < losses[0]):
        raise SystemExit(f"phase 15 (a): the MoE losses do not start near ln(32000) and "
                         f"fall, or aux is not finite: {losses}, {aux}")
    for st in hook.steps:
        got = {k: st["launches"].get(k, 0) for k in MOE_KERNELS}
        if got != {k: MOE_LAYERS for k in MOE_KERNELS}:
            raise SystemExit(f"phase 15 (a): step {st['step']} launched {got}, want "
                             f"{MOE_LAYERS} of each")
    require_tensor_cores("train_moe", launches, tc)
    if len(moe_hook.drops) != MOE_LAYERS:
        raise SystemExit(f"phase 15 (a): step 1 recorded {len(moe_hook.drops)} MoE layers")
    step_ms = float(np.median([st["ms"] for st in hook.steps[1:]
                               if not st["profiled"]]))
    tokens = MOE_BATCH * MOE_T
    profiled = next(st for st in hook.steps if st["profiled"])
    prof = _profile_summary(hook.prof, profiled["ms"])
    split = _moe_profile_split(hook.prof)
    log(f"  (a) step {step_ms:.1f} ms (median of the unprofiled steps 2-{MOE_STEPS}, host clock "
        f"to the loss read), {tokens / (step_ms / 1e3):.0f} tokens/s; launches a step "
        + ", ".join(f"{k} {hook.steps[-1]['launches'][k]}" for k in MOE_KERNELS)
        + f", every one on the tensor cores; peak device memory {peak_gb:.2f} GB [{card}]")
    log("  (a) step 1's share of (token, choice) pairs past capacity by layer: "
        + ", ".join(f"{d:.4f}" for d in moe_hook.drops))
    log(f"  (a) profiled step {MOE_PROFILE_STEP}: host {prof['step_ms']:.1f} ms, device busy "
        f"{prof['busy_ms']:.1f} ms (idle share {prof['idle_share']:.1%}, {prof['kernels']} "
        f"kernels); attention kernels {split['attention_ms']:.1f} ms, expert matmuls "
        f"{split['expert_matmul_ms']:.1f} ms, routing/dispatch/combine "
        f"{split['dispatch_combine_ms']:.1f} ms [{card}]")

    cmp = _moe_reference(cfg, _moe_global_batches(cfg, 2, MOE_EP_STEPS))
    torch.cuda.empty_cache()
    log(f"  (a) step 1 vs attention=xla (the initial weights, (b)'s first global batch), "
        f"routed as the flash step routed: loss {cmp['loss']:.5f} vs {cmp['loss_xla']:.5f} (|Δ| "
        f"{abs(cmp['loss'] - cmp['loss_xla']):.2e}, tol {TOL_TRAIN_LOSS:g}; aux "
        f"{cmp['aux']:.5f} vs {cmp['aux_xla']:.5f}); per-leaf gradient error max "
        f"{cmp['grad_rel_max']:.3e} at {cmp['grad_rel_max_at']}, median "
        f"{cmp['grad_rel_median']:.3e} (tol {TOL_TRAIN_GRAD:g})")
    log(f"  (a) the same, each routing freely: {cmp['free_flipped_share']:.3%} of the (token, "
        f"choice) decisions differ (expert or kept); loss {cmp['free_loss_xla']:.5f}, aux "
        f"{cmp['free_aux_xla']:.5f}; per-leaf gradient error max "
        f"{cmp['free_grad_rel_max']:.3e}, median {cmp['free_grad_rel_median']:.3e}")
    if not (abs(cmp["loss"] - cmp["loss_xla"]) <= TOL_TRAIN_LOSS
            and cmp["grad_rel_max"] <= TOL_TRAIN_GRAD):
        raise SystemExit("phase 15 (a): the flash MoE step disagrees with the xla-attention step")
    return {"losses": losses, "aux": aux, "step_ms": step_ms,
            "tokens_per_s": tokens / (step_ms / 1e3), "peak_gb": peak_gb,
            "drops": moe_hook.drops, "profile": prof, "split": split, "launches": launches,
            "tc_launches": tc, "version": version, "vs_xla": cmp}


def moe_rank(out_dir: str) -> None:
    """One rank of phase 15 (b): the MoE flagship through ``run_training``
    at ``--mesh=MOE_EP_MESH`` (every count to 0 just before it, read just
    after)."""
    from distributed_tensorflow_examples_tpu_torch import ops
    from distributed_tensorflow_examples_tpu_torch.examples import transformer_lm as cli
    from distributed_tensorflow_examples_tpu_torch.parallel import collectives, dist

    torch.backends.cuda.matmul.allow_tf32 = False
    args = cli.build_parser().parse_args(
        [*MOE_FLAGS, f"--train_steps={MOE_EP_STEPS}", f"--mesh={MOE_EP_MESH}"])
    hook = dp_step_hook(kernels=MOE_KERNELS, profile_step=MOE_EP_PROFILE_STEP)
    moe_hook = moe_step_hook()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()  # every count to 0 just before the main path
    collectives.TRAFFIC.clear()
    t0 = time.perf_counter()
    exp = cli.run_training(args, extra_hooks=[hook, moe_hook])
    wall = time.perf_counter() - t0
    launches, tc = dict(ops.LAUNCHES), dict(ops.TENSOR_CORE_LAUNCHES)  # just after
    profiled = next(st for st in hook.steps if st["profiled"])
    _rank_result(out_dir, {
        "rank": dist.process_index(), "backend": dist.backend(), "mesh": exp.mesh.shape,
        "expert": exp.mesh.expert_index, "wall_s": wall, "steps": hook.steps,
        "aux": moe_hook.aux, "drops": moe_hook.drops, "launches": launches,
        "tc_launches": tc,
        "experts_here": [int(exp.state.params[f"block_{i}"]["moe"]["w1"].shape[0])
                         for i in range(MOE_LAYERS)],
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": _profile_summary(hook.prof, profiled["ms"]),
        "split": _moe_profile_split(hook.prof)})


def moe_expert_mesh(card: str, want: list, want_xla: list) -> dict:
    """Phase 15 (b): the 2 ranks of ``moe_rank``, gated against ``want``,
    one process's losses on the same global batches from the same weights
    (``want_xla``: the same with plain attention, the noise floor);
    returns the step ms, the launches by rank and the traffic."""
    _c, _o, out = _run_ranks(2, "moe_rank({out!r})", 420)
    ranks = _read_ranks(out, 2)
    gaps = [max(abs(r["steps"][i]["loss"] - w) for r in ranks) for i, w in enumerate(want)]
    floor = [abs(a - b) for a, b in zip(want, want_xla)]
    tols = [TOL_MOE_EP_LOSS] + [TOL_MOE_EP_LOSS_LATER] * (len(want) - 1)
    log(f"  (b) {MOE_EP_MESH} ({ranks[0]['backend']}, 2 ranks sharing the card): losses by "
        f"rank {[[round(st['loss'], 5) for st in r['steps']] for r in ranks]}; (a)'s "
        f"{[round(x, 5) for x in want]} (worst |Δ| by step "
        + ", ".join(f"{g:.2e}" for g in gaps) + f", tol {', '.join(f'{t:g}' for t in tols)}; "
        "one process on the same global batches and weights; that process's flash against "
        "xla steps by step " + ", ".join(f"{f:.2e}" for f in floor) + "); experts a layer "
        f"by rank {[sorted(set(r['experts_here'])) for r in ranks]}")
    for r in ranks:
        if r["experts_here"] != [MOE_EXPERTS // 2] * MOE_LAYERS:
            raise SystemExit(f"phase 15 (b): rank {r['rank']} holds {r['experts_here']} experts")
        for st in r["steps"]:
            got = {k: st["launches"].get(k, 0) for k in MOE_KERNELS}
            if got != {k: MOE_LAYERS for k in MOE_KERNELS}:
                raise SystemExit(f"phase 15 (b): rank {r['rank']} step {st['step']} launched "
                                 f"{got}")
        require_tensor_cores(f"train_moe_ep rank {r['rank']}", r["launches"], r["tc_launches"])
        # As the JAX HLO test asserts of the MoE step: the dispatch crosses
        # the expert group (here both ranks) by all-to-all, in every step.
        for st in r["steps"]:
            a2a = [c for c in _records(st) if c.kind == "all-to-all"]
            if not a2a or any(c.groups != [[0, 1]] for c in a2a):
                raise SystemExit(f"phase 15 (b): rank {r['rank']} step {st['step']}'s "
                                 f"all-to-alls are not over the expert group: {a2a}")
        log(f"  (b) rank {r['rank']} (expert {r['expert']}), collectives a step (step "
            f"{r['steps'][1]['step']}): {account_line(r['steps'][1])}")
    if not all(math.isfinite(g) and g <= t for g, t in zip(gaps, tols)):
        raise SystemExit(f"phase 15 (b): the expert mesh's losses disagree with one "
                         f"process's: {gaps}")
    step_ms = ranks[0]["steps"][1]["ms"]
    tokens = MOE_BATCH * MOE_T
    traffic = ranks[0]["steps"][1]["traffic"]
    log(f"  (b) step {step_ms:.1f} ms (rank 0, step 2, host clock to the loss read), "
        f"{tokens / (step_ms / 1e3):.0f} tokens/s [{card}]")
    for r in ranks:
        p, s = r["profile"], r["split"]
        log(f"  (b) rank {r['rank']} (expert {r['expert']}): profiled step {p['step_ms']:.1f} ms, "
            f"device busy {p['busy_ms']:.1f} ms ({1 - p['idle_share']:.1%}), idle "
            f"{p['idle_share']:.1%}, {p['kernels']} kernels (attention {s['attention_ms']:.1f}, "
            f"expert matmuls {s['expert_matmul_ms']:.1f}, routing/dispatch/combine "
            f"{s['dispatch_combine_ms']:.1f} ms); peak {r['peak_gb']:.2f} GB; run "
            f"{r['wall_s']:.1f} s")
    return {"step_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3), "loss_gaps": gaps,
            "noise_floor": floor,
            "launches": [r["launches"] for r in ranks], "traffic": traffic,
            "idle_share": [r["profile"]["idle_share"] for r in ranks]}


def moe_serve(card: str, registry_dir: Path, version: int) -> dict:
    """Phase 15 (c): (a)'s published weights on a registry-pinned replica:
    one [1, MOE_T] predict (its flash launches counted) against
    ``transformer.apply`` on the card, and one greedy decode session
    against ``generate`` on the card; returns the predict's launches."""
    from distributed_tensorflow_examples_tpu_torch import bridge, ops
    from distributed_tensorflow_examples_tpu_torch.data import datasets
    from distributed_tensorflow_examples_tpu_torch.examples import transformer_lm as cli
    from distributed_tensorflow_examples_tpu_torch.models import transformer
    from distributed_tensorflow_examples_tpu_torch.serve import (
        ModelRegistry, ServeClient, host_serve_task,
    )

    cfg = cli.config_from_args(cli.build_parser().parse_args(MOE_FLAGS))
    session_len = MOE_DECODE_PROMPT + MOE_DECODE_NEW
    ready, holder, failure = threading.Event(), {}, []

    def host():
        try:
            host_serve_task(
                param_shapes=transformer.param_shapes(cfg),
                predict_fn=lambda p, b: transformer.apply(cfg, p, b["x"]),
                decode_fns=transformer.serve_decode_fns(cfg), decode_slots=1,
                decode_max_len=session_len, port=0, device="cuda", max_batch=1,
                registry_dir=str(registry_dir), model_name="transformer_lm",
                model_version=version,
                on_ready=lambda s: (holder.update(server=s), ready.set()))
        except BaseException as e:  # noqa: BLE001 — the main thread reports it
            failure.append(e)
            ready.set()

    t0 = time.perf_counter()
    thread = threading.Thread(target=host, name="moe-serve-task", daemon=True)
    thread.start()
    try:
        if not ready.wait(600) or failure:
            raise SystemExit(f"phase 15 (c): the replica did not come up: {failure!r}")
        up_s = time.perf_counter() - t0
        ids, _vocab, _src = datasets.text_corpus(
            None, vocab_size=cfg.vocab_size, synth_tokens=2_000_000, seed=SEED)
        x = np.asarray(ids[:MOE_T], np.int32)[None]
        prompt = np.asarray(ids[:MOE_DECODE_PROMPT], np.int32)
        client = ServeClient("127.0.0.1", holder["server"].port, op_timeout_s=300.0)
        before = _launch_counts(ops)
        t1 = time.perf_counter()
        _step, out = client.predict({"x": x})
        predict_s = time.perf_counter() - t1
        launches, tc = _launches_since(ops, before)
        before = _launch_counts(ops)
        t1 = time.perf_counter()
        tokens = client.generate(prompt, MOE_DECODE_NEW, deadline_s=300.0)
        decode_s = time.perf_counter() - t1
        decode_launches, _tc = _launches_since(ops, before)
        client.close()
    finally:
        if "server" in holder:
            holder["server"].shutdown_requested.set()
        thread.join(120)
    if thread.is_alive() or failure:
        raise SystemExit(f"phase 15 (c): the serve task did not shut down cleanly: {failure!r}")

    _step, flat, _manifest = ModelRegistry(str(registry_dir)).load("transformer_lm", version)
    _total, unflatten = bridge.flat_param_spec(transformer.param_shapes(cfg))
    params = unflatten(flat, "cuda")
    del flat
    with torch.inference_mode():
        want = transformer.apply(cfg, params, torch.from_numpy(x).cuda()).float().cpu()
        gen = transformer.generate(cfg, params, prompt[None], max_new_tokens=MOE_DECODE_NEW)
    gen = gen[0, MOE_DECODE_PROMPT:].cpu().numpy()
    del params
    torch.cuda.empty_cache()
    logits = out["output"].float()
    err = (logits - want).abs().max().item()
    flash_in_decode = sum(decode_launches.get(k, 0) for k in ps.FLASH_FAMILIES)
    log(f"  (c) pinned replica of transformer_lm/v{version} up in {up_s:.1f} s; predict "
        f"[1, {MOE_T}] in {predict_s * 1e3:.1f} ms (client), logits {tuple(logits.shape)}, "
        f"finite {bool(torch.isfinite(logits).all())}, max |Δ| against transformer.apply on "
        f"the card {err:.3e} (tol {TOL_LOGITS:g}); launches "
        + ", ".join(f"{k} {c}" for k, c in launches.items() if c) + f" [{card}]")
    log(f"  (c) decode session ({MOE_DECODE_PROMPT}-token prompt, {MOE_DECODE_NEW} greedy "
        f"tokens, one slot) in {decode_s:.2f} s ({MOE_DECODE_NEW / decode_s:.1f} tokens/s): "
        f"equal to generate on the card {bool(np.array_equal(tokens, gen))}; flash launches "
        f"during decode {flash_in_decode}")
    if (tuple(logits.shape) != (1, MOE_T, cfg.vocab_size) or not torch.isfinite(logits).all()
            or not err <= TOL_LOGITS):
        raise SystemExit("phase 15 (c): the replica's predict disagrees with transformer.apply")
    if launches.get("flash_fwd", 0) != MOE_LAYERS:
        raise SystemExit(f"phase 15 (c): the predict launched flash_fwd "
                         f"{launches.get('flash_fwd', 0)} times, want {MOE_LAYERS}")
    require_tensor_cores("serve_moe", launches, tc)
    if flash_in_decode or not np.array_equal(tokens, gen):
        raise SystemExit(f"phase 15 (c): decode launched flash {flash_in_decode} times, or its "
                         f"tokens {tokens.tolist()} differ from generate's {gen.tolist()}")
    return {"launches": launches, "tc_launches": tc, "predict_ms": predict_s * 1e3,
            "decode_tokens_per_s": MOE_DECODE_NEW / decode_s}


def moe_end_to_end(card: str) -> dict:
    """Phase 15 (the module docstring): (a), (b) and (c); returns each
    part's measurements and launches."""
    registry_dir = ROOT / "build" / "smoke_moe_registry"
    shutil.rmtree(registry_dir, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        a = moe_train(card, registry_dir)
        ta = time.perf_counter() - t0
        torch.cuda.empty_cache()  # the ranks are processes of their own
        b = moe_expert_mesh(card, a["vs_xla"]["one_process_losses"],
                            a["vs_xla"]["one_process_xla_losses"])
        tb = time.perf_counter() - t0 - ta
        c = moe_serve(card, registry_dir, a["version"])
    finally:
        shutil.rmtree(registry_dir, ignore_errors=True)
    log(f"  phase 15: (a) {ta:.1f} s, (b) {tb:.1f} s, (c) {time.perf_counter() - t0 - ta - tb:.1f} s")
    return {"train": a, "expert_mesh": b, "serve": c}


# ----------------------------------------------------------------------------
# Phase 16: GPipe over the pipe axis, the collapsed stages served, decode
# under a model mesh, ghost-batch BN over a slice axis
# ----------------------------------------------------------------------------

#: (a): phase 4's flagship and batch (vocab 32000, dim 1024, 12 layers, 8
#: heads, T 2048, batch 8, bf16, clip 1.0 + AdamW 1e-3, JAX ``init``'s
#: weights for seed 0) pipelined over 2 stages of 6 layers, 4 microbatches
#: of 2 rows, on 2 gloo ranks sharing the card.
PP_STAGES, PP_MICRO, PP_STEPS, PP_PROFILE_STEP = 2, 4, 3, 3
PP_MESH = "pipe=2"
PP_T, PP_LAYERS, PP_HEADS = 2048, 12, 8
#: The device of the phase's runs (the card; the CPU for a dry run of
#: the phase's logic at a small size).
PP_DEVICE = "cuda"
PP_FLAGS = [f"--batch_size={TRAIN_BATCH}", f"--seq_len={PP_T}", "--vocab_size=32000",
            "--dim=1024", f"--n_layers={PP_LAYERS}", f"--n_heads={PP_HEADS}",
            "--learning_rate=1e-3", "--clip_norm=1.0", "--log_every_steps=1", f"--seed={SEED}",
            "--attention=auto", f"--device={PP_DEVICE}"]
PP_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
#: Every rank runs every tick (M + S - 1 of them) over its 12 / S layers;
#: the stage body is recomputed in the backward, so each tick launches the
#: forward twice and the backward pair once a layer.
PP_TICKS = PP_MICRO + PP_STAGES - 1
PP_WANT = {"flash_fwd": 2 * PP_TICKS * PP_LAYERS // PP_STAGES,
           "flash_dq": PP_TICKS * PP_LAYERS // PP_STAGES,
           "flash_dkv": PP_TICKS * PP_LAYERS // PP_STAGES}
#: Steps 1-3 against one process with --grad_accum=4 on the same global
#: batches from the same weights: the same microbatch sums, so only bf16
#: roundings of other product shapes differ.  Phase 14's gate.
TOL_PP_LOSS = 2e-3
#: (b): the greedy sample of the collapsed weights.
PP_SAMPLE_PROMPT, PP_SAMPLE_NEW = 16, 8
#: (c): ResNet-50 at phase 5's width and global batch, 2 ghost slices on
#: --mesh=slice=2 (128 rows a rank), phase 9's train-set size.
GB_SLICES, GB_STEPS, GB_EXAMPLES = 2, 3, DP_EXAMPLES
GB_BATCH = RESNET_BATCH
GB_FLAGS = [f"--batch_size={GB_BATCH}", f"--image_size={RESNET_IMAGE}",
            "--num_classes=1000", "--learning_rate=0.1", "--momentum=0.9",
            "--log_every_steps=1", f"--seed={SEED}", f"--device={PP_DEVICE}",
            f"--bn_ghost_slices={GB_SLICES}", f"--synthetic_examples={GB_EXAMPLES}"]
#: Each BN kernel's launches a step a rank: ResNet-50's 53 BatchNorms.
GB_BN_WANT = 53
#: Step 1's loss and running stats of a slice rank against one process's
#: ghost path on the same global batch (its two ghost batches the ranks'
#: rows): bf16 convolutions over 128 rows against 256 round apart.
TOL_GB_LOSS, TOL_GB_STATS = 2e-2, 5e-2


def _bn_stats_hook():
    """A training hook that keeps the model state after step 1 (float32,
    on the host)."""
    from distributed_tensorflow_examples_tpu_torch import bridge
    from distributed_tensorflow_examples_tpu_torch.train import hooks

    class Stats(hooks.Hook):
        def __init__(self):
            self.after_first = None

        def after_step(self, loop, metrics):
            if self.after_first is None:
                self.after_first = {p: t.detach().float().cpu().numpy().tolist()
                                    for p, t in bridge._leaves(loop.state.model_state)}

    return Stats()


def pp_rank(out_dir: str, ckpt_dir: str) -> None:
    """One rank of phase 16: (a) the pipelined flagship, (b) its stages
    collapsed and decoded replicated on the chief and over a model=2 mesh
    of the 2 ranks, (c) ghost-batch BN ResNet-50 over a slice=2 mesh.
    Every count to 0 just before each path, read just after."""
    import contextlib
    import io

    from distributed_tensorflow_examples_tpu_torch import ops
    from distributed_tensorflow_examples_tpu_torch.data import datasets
    from distributed_tensorflow_examples_tpu_torch.examples import resnet50 as rcli
    from distributed_tensorflow_examples_tpu_torch.examples import transformer_lm as cli
    from distributed_tensorflow_examples_tpu_torch.models import resnet, transformer
    from distributed_tensorflow_examples_tpu_torch.parallel import collectives, dist, sharding
    from distributed_tensorflow_examples_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from distributed_tensorflow_examples_tpu_torch.train import checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    res: dict = {"rank": dist.process_index(), "backend": dist.backend()}

    # (a) GPipe at full width.
    args = cli.build_parser().parse_args(
        [*PP_FLAGS, f"--train_steps={PP_STEPS}", f"--pipeline_stages={PP_STAGES}",
         f"--microbatches={PP_MICRO}", f"--mesh={PP_MESH}", f"--log_dir={ckpt_dir}"])
    cfg = cli.config_from_args(args)
    hook = dp_step_hook(kernels=PP_KERNELS, profile_step=PP_PROFILE_STEP)
    ops.reset_launches()  # every count to 0 just before the main path
    collectives.TRAFFIC.clear()
    t0 = time.perf_counter()
    exp = cli.run_training(args, extra_hooks=[hook])
    wall = time.perf_counter() - t0
    launches, tc = dict(ops.LAUNCHES), dict(ops.TENSOR_CORE_LAUNCHES)  # just after
    profiled = next(st for st in hook.steps if st["profiled"])
    res["a"] = {"pipe": exp.mesh.pipe_index, "mesh": exp.mesh.shape, "wall_s": wall,
                "steps": hook.steps, "launches": launches, "tc_launches": tc,
                "layers_here": int(exp.state.params["blocks"]["qkv"]["kernel"].shape[0]),
                "profile": _profile_summary(hook.prof, profiled["ms"])}

    # (b) The stages collapsed (a collective gather), decoded replicated on
    # the chief and over a model=2 mesh of the same 2 ranks.
    t0 = time.perf_counter()
    with exp.mesh.axes():
        whole = checkpoint.global_params(exp.state.params, exp.specs["params"])
    dcfg, dparams = transformer.collapse_pipeline(cfg, whole)
    del exp
    torch.cuda.empty_cache()
    ids, _vocab, _src = datasets.text_corpus(None, vocab_size=cfg.vocab_size,
                                             synth_tokens=2_000_000, seed=SEED)
    prompt = np.asarray(ids[:PP_SAMPLE_PROMPT], np.int32)[None]
    chief = dist.is_chief()
    rep = None
    if chief:
        rep = transformer.generate(dcfg, dparams, prompt, max_new_tokens=PP_SAMPLE_NEW)
    mesh = build_mesh(MeshSpec.parse("model=2"), PP_DEVICE)
    tp = sharding.shard_pytree(dparams, mesh, transformer.sharding_rules(dcfg))
    collectives.TRAFFIC.clear()
    t1 = time.perf_counter()
    with hlo_analysis.record_collectives() as decode_account:
        tp_ids = transformer.generate(dcfg, tp, prompt, max_new_tokens=PP_SAMPLE_NEW, mesh=mesh)
    tp_s = time.perf_counter() - t1
    decode_traffic = dict(collectives.TRAFFIC)
    # Teacher-forced over the TP tokens: the largest logit gap, and the
    # replicated top-2 margin at each sampled position.
    seq = tp_ids[0]
    gap, margins = 0.0, []
    with torch.inference_mode():
        cache_tp = transformer.init_cache(dcfg, 1, seq.shape[0], device=PP_DEVICE, mesh=mesh)
        cache_rep = transformer.init_cache(dcfg, 1, seq.shape[0], device=PP_DEVICE)
        for pos in range(seq.shape[0] - 1):
            lt, _c = transformer.decode_step(dcfg, tp, cache_tp, seq[pos:pos + 1], pos,
                                             mesh=mesh)
            if chief:
                lr, _c = transformer.decode_step(dcfg, dparams, cache_rep, seq[pos:pos + 1], pos)
                gap = max(gap, (lt.float() - lr.float()).abs().max().item())
                if pos >= PP_SAMPLE_PROMPT - 1:
                    top2 = lr.float().topk(2, dim=-1).values[0]
                    margins.append((top2[0] - top2[1]).item())
    res["b"] = {"rep": None if rep is None else rep[0].tolist(), "tp": seq.tolist(),
                "tp_heads": int(tp["block_0"]["qkv"]["kernel"].shape[1] // (3 * dcfg.head_dim)),
                "gap": gap, "margins": margins, "tp_s": tp_s, "traffic": decode_traffic,
                "account": [dataclasses.asdict(c) for c in decode_account],
                "wall_s": time.perf_counter() - t0}
    del dparams, tp, cache_tp, cache_rep
    torch.cuda.empty_cache()

    # (c) Ghost-batch BN over slice=2.
    rargs = rcli.build_parser().parse_args(
        [*GB_FLAGS, f"--train_steps={GB_STEPS}", f"--mesh=slice={GB_SLICES}"])
    rcfg = rcli.config_from_args(rargs)
    hook = dp_step_hook(kernels=("bn_stats", "bn_bwd_stats"))
    stats = _bn_stats_hook()
    ops.reset_launches()  # every count to 0 just before the main path
    collectives.TRAFFIC.clear()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as final:
        exp = rcli.run_training(rargs, loss_fn_factory=lambda m: resnet.loss_fn(rcfg, mesh=m),
                                extra_hooks=[hook, stats])
    res["c"] = {"slice": exp.mesh.slice_index, "wall_s": time.perf_counter() - t0,
                "steps": hook.steps, "launches": dict(ops.LAUNCHES),
                "stats": stats.after_first, "final": final.getvalue(),
                "bn_group": None if exp.mesh.group is None else exp.mesh.group.size,
                "batch_group": exp.mesh.batch_group.size}
    _rank_result(out_dir, res)


def _pp_reference(card: str) -> list:
    """Phase 16 (a)'s yardstick: one process, the flat flagship (the same
    weights: the pipelined init is the per-layer draws stacked) with
    --grad_accum=PP_MICRO on the same global batches; returns its losses."""
    from distributed_tensorflow_examples_tpu_torch.examples import transformer_lm as cli

    args = cli.build_parser().parse_args(
        [*PP_FLAGS, f"--train_steps={PP_STEPS}", f"--grad_accum={PP_MICRO}"])
    clock = step_clock(())
    cli.run_training(args, extra_hooks=[clock])
    torch.cuda.empty_cache()
    losses = [loss for _s, _ms, loss, _c in clock.steps]
    log(f"  (a) one process, --grad_accum={PP_MICRO}: losses "
        + ", ".join(f"{x:.5f}" for x in losses) + ", step ms "
        + ", ".join(f"{ms:.1f}" for _s, ms, _l, _c in clock.steps) + f" [{card}]")
    return losses


def _gb_reference(card: str) -> tuple[float, dict]:
    """Phase 16 (c)'s yardstick: one process's ghost path (no slice axis:
    the batch splits into the 2 ghost batches) over the same global
    batch, the ranks' first batches (each its strided share of the
    pipeline's batch) in rank order, from the same weights; returns step
    1's loss and the running stats after it."""
    from distributed_tensorflow_examples_tpu_torch import bridge
    from distributed_tensorflow_examples_tpu_torch.data import datasets, pipeline
    from distributed_tensorflow_examples_tpu_torch.examples import resnet50 as rcli
    from distributed_tensorflow_examples_tpu_torch.models import resnet
    from distributed_tensorflow_examples_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from distributed_tensorflow_examples_tpu_torch.train import state as state_lib
    from distributed_tensorflow_examples_tpu_torch.utils import threefry

    args = rcli.build_parser().parse_args(GB_FLAGS)
    cfg = rcli.config_from_args(args)
    ds = datasets.imagenet_synthetic(image_size=args.image_size, n_train=args.synthetic_examples,
                                     num_classes=args.num_classes, seed=args.seed)
    parts = [next(iter(pipeline.InMemoryPipeline(ds.train, batch_size=args.batch_size,
                                                 seed=args.seed, process_index=i,
                                                 process_count=GB_SLICES)))
             for i in range(GB_SLICES)]
    batch = {k: torch.from_numpy(np.concatenate([p[k] for p in parts])).to(PP_DEVICE)
             for k in parts[0]}
    params, model_state = resnet.init_numpy(cfg, args.seed)
    mesh = build_mesh(MeshSpec(), PP_DEVICE)
    with mesh.axes(), torch.no_grad():
        loss, (new_state, _m) = resnet.loss_fn(cfg, mesh=mesh)(
            state_lib.as_param_leaves(params, PP_DEVICE),
            state_lib.as_state_leaves(model_state, PP_DEVICE), batch, threefry.key(0))
    stats = {p: t.float().cpu().numpy() for p, t in bridge._leaves(new_state)}
    del batch, new_state
    torch.cuda.empty_cache()
    log(f"  (c) one process's ghost path over the ranks' global batch: step 1 loss "
        f"{float(loss):.5f} [{card}]")
    return float(loss), stats


def _collapsed_from_checkpoint(ckpt_dir: Path, cfg):
    """The pipe-trained checkpoint's global parameters, collapsed to the
    per-layer layout, on the card."""
    from distributed_tensorflow_examples_tpu_torch.models import transformer

    step_dir = sorted((p for p in (ckpt_dir / "ckpt").iterdir() if p.name.isdigit()),
                      key=lambda p: int(p.name))[-1]
    blob = torch.load(step_dir / "state.pt", map_location=PP_DEVICE, weights_only=True)
    tree: dict = {}
    for path, t in blob["params"].items():
        node = tree
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = t
    return transformer.collapse_pipeline(cfg, tree)


def pipe_slice_end_to_end(card: str) -> dict:
    """Phase 16 (the module docstring): the one-process yardsticks, then 2
    ranks of ``pp_rank``; gates and prints; returns the launches by rank."""
    from distributed_tensorflow_examples_tpu_torch.examples import transformer_lm as cli
    from distributed_tensorflow_examples_tpu_torch.models import transformer

    t0 = time.perf_counter()
    want = _pp_reference(card)
    gb_loss, gb_stats = _gb_reference(card)
    t_ref = time.perf_counter() - t0
    ckpt_dir = ROOT / "build" / "smoke_pipe_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()  # the ranks are processes of their own
    try:
        _c, _o, out = _run_ranks(2, f"pp_rank({{out!r}}, {str(ckpt_dir)!r})", 600)
        ranks = _read_ranks(out, 2)

        # (a)
        gaps = [max(abs(r["a"]["steps"][i]["loss"] - w) for r in ranks)
                for i, w in enumerate(want)]
        log(f"  (a) {PP_MESH} ({ranks[0]['backend']}, 2 ranks sharing the card), "
            f"--pipeline_stages={PP_STAGES} --microbatches={PP_MICRO}: losses by rank "
            f"{[[round(st['loss'], 5) for st in r['a']['steps']] for r in ranks]}; one "
            "process's " + ", ".join(f"{x:.5f}" for x in want) + " (worst |Δ| by step "
            + ", ".join(f"{g:.2e}" for g in gaps) + f", tol {TOL_PP_LOSS:g}); layers by rank "
            f"{[r['a']['layers_here'] for r in ranks]}")
        for r in ranks:
            if r["a"]["layers_here"] != PP_LAYERS // PP_STAGES or r["backend"] != "gloo":
                raise SystemExit(f"phase 16 (a): rank {r['rank']} holds "
                                 f"{r['a']['layers_here']} layers on {r['backend']}")
            for st in r["a"]["steps"]:
                got = {k: st["launches"].get(k, 0) for k in PP_KERNELS}
                if got != PP_WANT:
                    raise SystemExit(f"phase 16 (a): rank {r['rank']} step {st['step']} "
                                     f"launched {got}, want {PP_WANT}")
            require_tensor_cores(f"train_pipe rank {r['rank']}", r["a"]["launches"],
                                 r["a"]["tc_launches"])
        if not all(math.isfinite(g) and g <= TOL_PP_LOSS for g in gaps):
            raise SystemExit(f"phase 16 (a): the pipelined losses disagree with one "
                             f"process's: {gaps}")
        tokens = TRAIN_BATCH * PP_T
        step = ranks[0]["a"]["steps"][1]
        log(f"  (a) step {step['ms']:.1f} ms (rank 0, step 2, host clock to the loss read), "
            f"{tokens / (step['ms'] / 1e3):.0f} tokens/s; traffic a step (rank 0, step 2): "
            + account_line(step) + f" [{card}]")
        for r in ranks:
            p = r["a"]["profile"]
            log(f"  (a) rank {r['rank']} (pipe {r['a']['pipe']}): profiled step "
                f"{p['step_ms']:.1f} ms, device busy {p['busy_ms']:.1f} ms, idle "
                f"{p['idle_share']:.1%}, {p['kernels']} kernels; launches a step "
                + ", ".join(f"{k} {r['a']['steps'][-1]['launches'][k]}" for k in PP_KERNELS)
                + f" (every one on the tensor cores); run {r['a']['wall_s']:.1f} s")

        # (b)
        chief = ranks[0]
        rep, margins, gap = chief["b"]["rep"], chief["b"]["margins"], chief["b"]["gap"]
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            [*PP_FLAGS, f"--pipeline_stages={PP_STAGES}", f"--microbatches={PP_MICRO}"]))
        dcfg, dparams = _collapsed_from_checkpoint(ckpt_dir, cfg)
        prompt = np.asarray(rep[:PP_SAMPLE_PROMPT], np.int32)[None]
        one = transformer.generate(dcfg, dparams, prompt,
                                   max_new_tokens=PP_SAMPLE_NEW)[0].tolist()
        del dparams
        torch.cuda.empty_cache()
        tps = [r["b"]["tp"] for r in ranks]
        first = next((i for i, (a, b) in enumerate(zip(rep, tps[0])) if a != b), None)
        log(f"  (b) the chief's collapsed weights: {PP_SAMPLE_NEW} greedy tokens "
            f"{rep[PP_SAMPLE_PROMPT:]}; one process from the pipe-trained checkpoint, "
            f"collapsed: equal {one == rep}; decoded over model=2 ({chief['b']['tp_heads']} "
            f"heads a rank, {chief['b']['tp_s']:.2f} s): equal {tps[0] == rep}, the ranks "
            f"alike {tps[0] == tps[1]}; largest logit gap (teacher-forced) {gap:.3e}, "
            f"smallest top-2 margin {min(margins):.3e}; decode traffic (rank 0) "
            + account_line(chief["b"]))
        if one != rep or tps[0] != tps[1] or chief["b"]["tp_heads"] != PP_HEADS // 2:
            raise SystemExit("phase 16 (b): the collapsed weights decode differently in one "
                             "process, or the model ranks disagree")
        if first is not None and margins[first - PP_SAMPLE_PROMPT] > 2 * gap:
            raise SystemExit(f"phase 16 (b): the model=2 decode departs at position {first} "
                             f"where the margin {margins[first - PP_SAMPLE_PROMPT]:.3e} exceeds "
                             f"twice the logit gap {gap:.3e}")

        # (c)
        loss_gaps = [abs(r["c"]["steps"][0]["loss"] - gb_loss) for r in ranks]
        stat_gap = 0.0
        for r in ranks:
            s = r["c"]["slice"]
            for path, rows in r["c"]["stats"].items():
                mine, ref = np.asarray(rows)[0], np.asarray(gb_stats[path])[s]
                stat_gap = max(stat_gap, float(np.max(np.abs(mine - ref) / (np.abs(ref) + 1.0))))
        bn_reduce = [sum(st["traffic"].get("bn_calls", 0) for st in r["c"]["steps"])
                     for r in ranks]
        grads = [r["c"]["steps"][1]["traffic"].get("grads_calls", 0) for r in ranks]
        log(f"  (c) ResNet-50 --bn_ghost_slices={GB_SLICES} --mesh=slice={GB_SLICES} "
            f"({GB_BATCH // GB_SLICES} rows a rank): step 1 losses {[round(r['c']['steps'][0]['loss'], 5) for r in ranks]} "
            f"against one process's {gb_loss:.5f} (|Δ| {max(loss_gaps):.2e}, tol "
            f"{TOL_GB_LOSS:g}); running stats after step 1, each rank's slice row against "
            f"the one process's, largest |Δ| / (|ref| + 1) {stat_gap:.3e} (tol "
            f"{TOL_GB_STATS:g}); BN all-reduces by rank {bn_reduce}; gradient buckets a "
            f"step {grads} over {ranks[0]['c']['batch_group']} ranks")
        for r in ranks:
            for st in r["c"]["steps"]:
                got = {k: st["launches"].get(k, 0) for k in ("bn_stats", "bn_bwd_stats")}
                if got != {"bn_stats": GB_BN_WANT, "bn_bwd_stats": GB_BN_WANT}:
                    raise SystemExit(f"phase 16 (c): rank {r['rank']} step {st['step']} "
                                     f"launched {got}")
            if "FINAL" not in r["c"]["final"] and r["rank"] == 0:
                raise SystemExit("phase 16 (c): no FINAL line from the chief")
        if any(bn_reduce) or grads != [1, 1] or ranks[0]["c"]["batch_group"] != 2:
            raise SystemExit(f"phase 16 (c): BN all-reduces {bn_reduce} (want none), "
                             f"gradient buckets {grads}")
        if not (max(loss_gaps) <= TOL_GB_LOSS and stat_gap <= TOL_GB_STATS):
            raise SystemExit(f"phase 16 (c): the slice ranks disagree with one process's "
                             f"ghost path: loss {loss_gaps}, stats {stat_gap}")
        # As the JAX HLO test asserts of ghost BN: no statistics all-reduce
        # crosses a slice (here a slice is a rank); only the gradient
        # bucket and the metrics span the slices.
        for r in ranks:
            crossing = {c.tag for st in r["c"]["steps"] for c in _records(st)
                        if c.kind == "all-reduce" and any(len(g) > 1 for g in c.groups)}
            if not crossing <= {"grads", "metrics"}:
                raise SystemExit(f"phase 16 (c): rank {r['rank']}'s all-reduces {crossing} "
                                 "cross the slices")
            log(f"  (c) rank {r['rank']} (slice {r['c']['slice']}), collectives a step (step 2): "
                + account_line(r["c"]["steps"][1]))
        step = ranks[0]["c"]["steps"][1]
        log(f"  (c) step {step['ms']:.1f} ms (rank 0, step 2), "
            f"{GB_BATCH / (step['ms'] / 1e3):.0f} images/s [{card}]")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"  phase 16: the one-process yardsticks {t_ref:.1f} s, the ranks and the checks "
        f"{time.perf_counter() - t0 - t_ref:.1f} s")
    return {"pipe_launches": [r["a"]["launches"] for r in ranks],
            "ghost_launches": [r["c"]["launches"] for r in ranks],
            "decode_gap": gap, "loss_gaps": gaps}



# ----------------------------------------------------------------------------
# Phase 17: the port's measuring tools on the card
# ----------------------------------------------------------------------------

#: ``tools/ulysses_ab.py`` at phase 14's shape: [b, h/sp, T, d] against sp
#: hops of [b, h, T/sp, d], bf16, forward plus backward.
UA_ARGS = ["--b", "2", "--h", "8", "--t", str(LONG_T), "--d", "128", "--sp", "2,4",
           "--steps", "10"]
UA_CALLS = 4  # grad_time calls a run: Ulysses and a hop, at each sp
UA_ITERS = 12  # time_ms's 2 warm calls and 10 timed ones, each a forward and backward
#: The host tools at their quick sizes (``loader_bench`` has no --quick:
#: a quarter of its records and batches).
LOADER_ARGS = ["--records", "8192", "--batches", "50"]
#: ``tools/loadsim.py --scenario=canary`` at the root's --duration_s=30 and
#: qps 100, with the p99 bound of the root's own acceptance run of the
#: scenario (``tools/loadsim_canary_baseline.json``: 2500 ms, at qps 50):
#: the kill and the retire put seconds-long replica restarts and lease
#: expiries into the tail (the root's run: p99 668 ms; on the H100 host,
#: where a task takes ~10 s to import and reach the card, 230-600 ms).
#: Its own wait for the flip to finish is bounded by 90 s past the window.
CANARY_ARGS = ["--scenario=canary", "--duration_s=30", "--p99_bound_ms=2500"]
CANARY_LIMIT_S = 420.0


def _ulysses_run(ulysses_ab, fused: str | None) -> tuple[dict, dict, dict]:
    """``ulysses_ab`` on the card with ``DTX_FUSED_BWD`` unset (None) or
    set: its record and the flash launches and tensor-core launches it
    made."""
    import os

    from distributed_tensorflow_examples_tpu_torch import ops

    saved = os.environ.pop("DTX_FUSED_BWD", None)
    if fused is not None:
        os.environ["DTX_FUSED_BWD"] = fused
    try:
        before = _launch_counts(ops)
        rec = ulysses_ab.run(ulysses_ab.parse_args([*UA_ARGS, "--device", "cuda"]))
        launches, tc = _launches_since(ops, before)
    finally:
        os.environ.pop("DTX_FUSED_BWD", None)
        if saved is not None:
            os.environ["DTX_FUSED_BWD"] = saved
    return rec, {k: launches.get(k, 0) for k in SP_KERNELS}, {k: tc.get(k, 0) for k in SP_KERNELS}


def _ulysses_gate(name: str, rec: dict, launches: dict, tc: dict, fused: bool) -> None:
    rows = rec["rows"]
    if [r["sp"] for r in rows] != [2, 4] or not all(
            r[k] > 0 for r in rows for k in ("t_ulysses_ms", "t_ring_hop_ms", "t_ring_ms",
                                               "ring_over_ulysses")):
        raise SystemExit(f"phase 17 {name}: rows {rows}")
    if launches != tc:
        raise SystemExit(f"phase 17 {name}: flash launches {launches}, of them on the tensor "
                         f"cores {tc}: a CUDA-core launch")
    want_fwd = UA_CALLS * UA_ITERS
    bwd = launches["flash_fused_bwd"] + launches["flash_dq"]
    if (launches["flash_fwd"] != want_fwd or bwd != want_fwd
            or launches["flash_dq"] != launches["flash_dkv"]
            or (launches["flash_fused_bwd"] > 0) != fused):
        raise SystemExit(f"phase 17 {name}: flash launches {launches}, want {want_fwd} forwards "
                         f"and as many backwards, {'some' if fused else 'no'} fused")


def _loadsim_start(tmp: Path, argv: list) -> subprocess.Popen:
    """``tools/loadsim.py`` with ``argv`` on the card, in a session of its
    own (so a timeout can stop its tasks with it), its output into
    ``tmp``."""
    import os

    out = open(tmp / "loadsim.out", "wb")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "distributed_tensorflow_examples_tpu_torch.tools.loadsim",
             *argv, "--device=cuda", f"--logdir={tmp}", f"--out={tmp / 'verdict.json'}"],
            cwd=str(ROOT), stdout=out, stderr=subprocess.STDOUT, start_new_session=True,
            env={**os.environ, "PYTHONPATH": str(ROOT)})
    finally:
        out.close()


def loadsim_on_card(argv: list, limit_s: float, label: str, ok=lambda verdict: True) -> dict:
    """One ``tools/loadsim.py`` run on the card, alone, its session stopped
    past ``limit_s``: its verdict, gated on every gate and on ``ok``; on a
    failure the tasks' last lines are printed."""
    import os
    import signal
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_loadsim_"))
    proc = _loadsim_start(tmp, argv)
    try:
        try:
            rc = proc.wait(timeout=limit_s)
        except subprocess.TimeoutExpired:
            rc = None
        text = (tmp / "loadsim.out").read_text(errors="replace")
        verdict_path = tmp / "verdict.json"
        verdict = json.loads(verdict_path.read_text()) if verdict_path.exists() else {}
        if rc != 0 or not verdict.get("slo_pass") or not ok(verdict):
            for log_file in sorted(tmp.glob("*.log")):
                log(f"  --- {log_file.name} (last lines)\n"
                    + "\n".join(log_file.read_text(errors="replace").splitlines()[-15:]))
            log("  --- loadsim (last lines)\n" + "\n".join(text.splitlines()[-20:]))
            raise SystemExit(f"{label}: rc {rc}, gates {verdict.get('gates')}, failed predicts "
                             f"{verdict.get('predict_failed')}")
        return verdict
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


#: ``tools/loadsim.py --scenario=overload`` at the root's defaults: 100 qps
#: from 16 paced clients over a 30 s window; from 35% to 65% of it, 64
#: unpaced clients in 4 processes send 64-row predicts; the replicas of the
#: 4096-wide MLP hold 8 predicts in their queue and shed those that waited
#: past 500 ms.  Its gates: goodput at least half the paced qps during the
#: burst, p99 back under 1.5x the baseline's (50 ms at least) within 20 s
#: of the burst's end.  The tool's own recovery wait ends 20 s past the
#: burst; the limit covers the boot.
OVERLOAD_ARGS = ["--scenario=overload"]
OVERLOAD_LIMIT_S = 240.0


def overload_end_to_end(card: str) -> dict:
    """Phase 18 (the module docstring): the root's overload acceptance over
    a cluster of the port's CLI on the card; returns its verdict."""
    t0 = time.perf_counter()
    v = loadsim_on_card(OVERLOAD_ARGS, OVERLOAD_LIMIT_S, "phase 18 overload")
    per_proc = v["burst_threads"] // v["burst_procs"]
    log(f"  loadsim --scenario=overload: gates {json.dumps(v['gates'])} [{card}]")
    log(f"  baseline {v['baseline_ok']} ok, {v['baseline_failed']} failed, p99 "
        f"{v['baseline_p99_ms']:.1f} ms; burst ({v['burst_procs']} processes x {per_proc} "
        f"clients, {v['burst_window_s']} s): goodput {v['burst_goodput_qps']} qps (floor "
        f"{v['goodput_floor_qps']}), burst clients {v['burst_ok']} ok / {v['burst_failed']} "
        f"failed, paced {v['burst_paced']['ok']} ok / {v['burst_paced']['failed']} failed "
        f"(p99 {v['burst_paced']['p99_ms']:.1f} ms)")
    log(f"  admission: batcher refusals {v['batcher_overloads']}, core sheds {v['shed_total']} "
        f"(queue deadline {v['queue_deadline_drops']}), retry {json.dumps(v['retry'])}; "
        f"recovered in {v['recovery_s']} s to p99 <= {v['recovery_target_ms']} ms "
        f"(windows {json.dumps(v['recovery_windows'])}); lease expirations "
        f"{v['leases_expired']}; members {v['members_before']} -> {v['members_after']}")
    log(f"  paced totals {v['predict_ok']} ok, {v['predict_failed']} failed, p50 "
        f"{v['p50_ms']:.1f} / p99 {v['p99_ms']:.1f} ms; served step {v['step_first']} -> "
        f"{v['step_last']}; window {v['window_s']} s; the timeline (s from the start) "
        f"{json.dumps(v['timeline_s'])}; phase 18 {time.perf_counter() - t0:.1f} s")
    return v


def tools_end_to_end(card: str) -> dict:
    """Phase 17: the port's twins of the root measuring tools, their
    card-side parts on the card, one after another: each measures a
    plane of the host the others would load."""
    from distributed_tensorflow_examples_tpu_torch.tools import (
        data_service_bench, loader_bench, ps_transport_bench, serving_bench, ulysses_ab)
    from distributed_tensorflow_examples_tpu_torch.tools._hostbench import rounded

    t0 = time.perf_counter()
    # (a) ulysses_ab, split and fused backward.
    ua, ua_launches = {}, {}
    for name, fused in (("split", None), ("fused", "1")):
        rec, launches, tc = _ulysses_run(ulysses_ab, fused)
        _ulysses_gate(name, rec, launches, tc, fused is not None)
        ua[name], ua_launches[name] = rec, launches
        log(f"  (a) ulysses_ab, DTX_FUSED_BWD={fused or 'unset'}: {json.dumps(rec['rows'])}; "
            f"flash launches {launches}, all on the tensor cores [{card}]")
    t_a = time.perf_counter()
    # (b) serving_bench --quick on the card.
    sv = serving_bench.run(serving_bench.parse_args(["--quick", "--device=cuda"]))
    if not all(sv["checks"].values()):
        raise SystemExit(f"phase 17 (b): the served prediction is {sv['predict_max_rel_err']:.3e} "
                         f"from the plain apply (tol {serving_bench.TOL_PREDICT:g})")
    conc = sv["concurrency"]["clients"]
    log(f"  (b) serving_bench --quick --device=cuda: single {sv['single']['qps']:.1f} qps "
        f"(p50 {sv['single']['p50_ms']:.2f}, p99 {sv['single']['p99_ms']:.2f} ms), batched "
        f"{sv['batched']['qps']:.1f} qps at {sv['batched']['clients']} clients (p99 "
        f"{sv['batched']['p99_ms']:.2f} ms), concurrency p99 "
        + ", ".join(f"{k}: {r['p99_ms']:.2f} ms" for k, r in conc.items())
        + f"; no failed request; the served prediction {sv['predict_max_rel_err']:.2e} from "
        f"the plain apply.  Measured, not held here (the root's CPU rules): batched_speedup "
        f"{sv['batched_speedup']:.2f} ({sv['gates']['batched_speedup_ge_3']}), p99 ratio "
        f"{sv['concurrency']['p99_ratio']:.2f} ({sv['gates']['concurrent_p99_ratio_le_3']}) "
        f"[{card}]")
    t_b = time.perf_counter()
    # (c) the host tools at their quick sizes.
    host = {"loader_bench": loader_bench.run(loader_bench.parse_args(LOADER_ARGS)),
            "data_service_bench": data_service_bench.run(data_service_bench.parse_args(["--quick"])),
            "ps_transport_bench": ps_transport_bench.run(ps_transport_bench.parse_args(["--quick"]))}
    for name, d in host.items():
        log(f"  (c) {name}: {json.dumps(rounded(d, 4))}")
        if not all(d["checks"].values()):
            raise SystemExit(f"phase 17 (c): {name} checks {d['checks']}")
    t_c = time.perf_counter()
    # (d) the canary over a cluster of the port's CLI.
    verdict = loadsim_on_card(CANARY_ARGS, CANARY_LIMIT_S, "phase 17 canary",
                              ok=lambda v: v.get("predict_failed") == 0)
    log(f"  (d) loadsim --scenario=canary: gates {json.dumps(verdict['gates'])}; predicts "
        f"{verdict['predict_ok']} ok, {verdict['predict_failed']} failed, p50 "
        f"{verdict['p50_ms']:.1f} / p99 {verdict['p99_ms']:.1f} ms at {verdict['qps_achieved']} "
        f"qps; canary share {verdict['canary_frac']} (weight {verdict['canary_weight']} ± "
        f"{verdict['canary_tol']}); window {verdict.get('window_s')} s; the timeline (s from "
        f"the start) {json.dumps(verdict.get('timeline_s'))} [{card}]")
    t_d = time.perf_counter()
    log(f"  phase 17: (a) {t_a - t0:.1f} s, (b) {t_b - t_a:.1f} s, (c) {t_c - t_b:.1f} s, "
        f"(d) {t_d - t_c:.1f} s")
    return {"ulysses": ua, "ulysses_launches": ua_launches, "serving": sv, "host": host,
            "canary": verdict}


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
    t_run = time.perf_counter()
    marks: list = []

    def phase(label: str, msg: str) -> None:
        """Log a phase's start; its seconds are printed at the end."""
        marks.append((label, time.perf_counter()))
        log(msg)

    phase("1", "phase 1: build")
    sources = ["flash_fwd", "flash_bwd", "flash_fused_bwd", "bn_stats"]
    t0 = time.perf_counter()
    built = _build.build(sources)
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
        f"(per source: {json.dumps({k: round(v, 1) for k, v in built.items()})})")
    tensor_cores = check_build(_build, sources)
    check_routes(flash)

    phase("2", "phase 2: kernels against their plain versions on the card")
    # The serving path's shape: the replica pads every apply to max_batch = 2
    # rows, so each layer's call folds 2 x 8 heads into BH = 16.
    errs = [
        check_flash(flash, 16, 2048, 128, torch.bfloat16, True),
        check_flash(flash, 8, 2048, 128, torch.bfloat16, False),
        check_flash(flash, 8, 1000, 128, torch.bfloat16, True),
        check_flash(flash, 8, 2048, 64, torch.bfloat16, True),
        check_flash(flash, 8, 2048, 32, torch.bfloat16, True),
        check_flash(flash, 8, 1000, 64, torch.float32, True, out_dtype=torch.float32),
        check_flash(flash, LONG_BATCH * 8, LONG_T, 128, torch.bfloat16, True),
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
    # The flash ring's hops (bf16 in, f32 out, on the tensor cores): checks
    # (a) and (b), ending at the hop shape [LONG_BATCH * 8, LONG_T / 2, 128].
    hop = (LONG_BATCH * 8, LONG_T // 2, 128, True)
    f32_out = {
        "flash_dq/flash_dkv": [check_split_f32(flash, *sh, rounding=sh[2] in flash.RECORD_HEAD_DIMS)
                               for sh in (*F32_CHECKS, hop)],
        "flash_fwd": [check_fwd_f32(flash, *sh, rounding=sh[2] in flash.RECORD_HEAD_DIMS)
                      for sh in (*F32_CHECKS, (3, 136, 32, False), hop)],
        "flash_fused_bwd": [check_fused_f32(flash, *sh, rounding=sh[2] in flash.RECORD_HEAD_DIMS)
                            for sh in (*F32_CHECKS, hop)],
    }
    flips = {name: {w: max(r[name][f"{w}_flips"] for r in f32_out[group] if name in r)
                    for w in (("p",) if name == "flash_fwd" else ("p", "ds"))}
             for group in f32_out for name in group.split("/")}
    log(f"  bf16 -> f32 of every flash kernel: the largest shares of flipped p and ds over the "
        f"(b) shapes {json.dumps(flips)} [{card}]")
    # Timed by tools/flash_bench.py, at the shapes of its rows.
    bf16 = torch.bfloat16
    main_shape, train_fwd, long_fwd, _full = (
        timed(f"flash_fwd [{bh}, {t}, 128] bf16 {'causal' if c else 'full'}",
              fb.time_flash(flash, bh, t, 128, bf16, c))
        for bh, t, c in ((16, 2048, True), (train_bh, 2048, True),
                         (LONG_BATCH * 8, LONG_T, True), (8, 2048, False)))
    bwd = fb.time_flash_bwd(flash, train_bh, 2048, 128, bf16, True)
    for name, r in bwd.items():
        timed(f"{name} [{train_bh}, 2048, 128] bf16 causal (sdpa: its whole backward)", r)
    # The T 8192 training path's shape: batch 2 x 8 heads = BH 16.
    long_bh = LONG_BATCH * 8
    fused_errs = [
        check_fused_bwd(flash, long_bh, LONG_T, 128, torch.bfloat16, True, determinism=True),
        check_fused_bwd(flash, 8, 2048, 128, torch.bfloat16, False),
        check_fused_bwd(flash, 8, 1000, 64, torch.bfloat16, True),
        check_fused_bwd(flash, 8, 1000, 32, torch.bfloat16, False),
        check_fused_bwd(flash, 8, 1000, 64, torch.float32, True, out_dtype=torch.float32),
        check_fused_bwd(flash, 3, 320, 128, torch.bfloat16, True),
        check_fused_bwd(flash, 3, 192, 32, torch.bfloat16, False),
    ]
    fused = timed(f"flash_fused_bwd [{long_bh}, {LONG_T}, 128] bf16 causal",
                  fb.time_fused_bwd(flash, long_bh, LONG_T, 128, bf16, True))
    log(f"  split pair at this shape: flash_dq {fused['split_dq_ms']:.4f} + flash_dkv "
        f"{fused['split_dkv_ms']:.4f} = {fused['split_dq_ms'] + fused['split_dkv_ms']:.4f} ms "
        f"(bound {fused['split_bound_ms']:.4f} ms); dq workspace bytes a call: "
        f"{fused['dq_workspace_bytes']} in the blocks' walk "
        f"({fused['dq_workspace_bytes'] / (fused['ms'] * 1e-3) / 1e12:.2f} TB/s over the "
        f"kernel's time), {fused['dq_reduce_bytes']} in the reduction, S = {fused['slices']}")
    log(f"  [{card}]")
    # ResNet-50's BatchNorm shapes at batch 256 (the stem, a stage-0 bn3, a
    # stage-3 bn3, the most frequent and the smallest), one block, ragged
    # channel strips over many blocks (C = 264 at 16-byte loads, C = 100
    # one element a load) and a ragged f32 one (C = 24, not a multiple of 8).
    bn_errs = [
        check_bn(bn, (RESNET_BATCH, 112, 112, 64), torch.bfloat16, seed=11),
        check_bn(bn, (RESNET_BATCH, 56, 56, 256), torch.bfloat16, seed=12),
        check_bn(bn, (RESNET_BATCH, 7, 7, 2048), torch.bfloat16, seed=13),
        check_bn(bn, (RESNET_BATCH, 14, 14, 256), torch.bfloat16, seed=15),
        check_bn(bn, (RESNET_BATCH, 7, 7, 512), torch.bfloat16, seed=16),
        check_bn(bn, (2, 4, 4, 64), torch.bfloat16, seed=17),
        check_bn(bn, (64, 28, 28, 264), torch.bfloat16, seed=18),
        check_bn(bn, (32, 28, 28, 100), torch.bfloat16, seed=19),
        check_bn(bn, (3, 5, 7, 24), torch.float32, seed=14),
    ]
    bn_times = fb.time_bn(bn, RESNET_BATCH, RESNET_IMAGE)
    for name, r in bn_times.items():
        timed(f"{name} at the stem {r['shape']} bf16" + (" relu" if name == "bn_bwd_stats" else ""), r)
        log(f"  {name} over the step's {r['shapes']} shapes: kernel {r['step_ms']:.3f} ms, plain "
            f"{r['step_plain_ms']:.3f} ms, torch {r['step_library_ms']:.3f} ms, bound "
            f"{r['step_bound_ms']:.3f} ms")
        for line in fb.describe_bn_device(name, r):
            log(f"  {line}")
    log(f"  [{card}]")

    phase("2b", "phase 2b: the fused backward's parity gate (twin of tools/flash_parity.py)")
    from distributed_tensorflow_examples_tpu_torch.tools import flash_parity

    parity = flash_parity.run(quick=False, segmented=False, device="cuda")
    log(f"  {json.dumps(parity)}")
    if not parity["parity_ok"]:
        raise SystemExit("the fused backward failed its parity gate")

    phase("3", "phase 3: serve the flagship transformer end to end")
    serve_launches, serve_tc = serve_end_to_end(card)

    phase("4", "phase 4: train the flagship transformer end to end")
    kernel_ms = {"flash_fwd": train_fwd["ms"], **{k: v["ms"] for k, v in bwd.items()}}
    train_launches, train_tc = train_end_to_end(card, kernel_ms)

    phase("5", "phase 5: train ResNet-50 end to end with the fused BatchNorm statistics")
    resnet_launches, resnet_run = resnet_end_to_end(card)

    phase("6", f"phase 6: train the flagship at T {LONG_T} end to end through the fused backward")
    long_launches, long_tc, long_losses = train_long_end_to_end(card, fused["ms"], long_fwd["ms"])

    phase("7", "phase 7: train the four reference workloads (MNIST MLP, CIFAR-10 CNN, word2vec, "
        "PTB LSTM) through their CLIs")
    workloads = workloads_end_to_end(card)
    log("  workloads: " + json.dumps({k: {m: round(v, 6) for m, v in r.items()}
                                      for k, r in workloads.items()}))

    phase("8", "phase 8: the PS emulation (W1 sync-replicas, W2 async) through the MNIST and "
        "CIFAR-10 CLIs")
    ps = ps_emulation_end_to_end(card)
    log("  ps_emulation: " + json.dumps({k: {m: (round(v, 6) if isinstance(v, float) else v)
                                             for m, v in r.items()} for k, r in ps.items()}))

    phase("9", "phase 9: synchronous data parallelism on the card (ResNet-50 W3 and the PTB LSTM "
        f"W5 on {DP_RANKS} ranks sharing it, gloo; ResNet-50 on a world of one, nccl)")
    torch.cuda.empty_cache()  # the ranks are processes of their own
    dp = data_parallel_end_to_end(card, resnet_run)
    dp_launches = {name: [r.get(name, 0) for r in dp["resnet_dp2"]["launches"]]
                   for name in ("bn_stats", "bn_bwd_stats")}
    nccl_launches = {name: dp["resnet_nccl1"]["launches"][0].get(name, 0)
                     for name in ("bn_stats", "bn_bwd_stats")}

    phase("10", "phase 10: W1 sync-replicas and W2 async SGD as PS, chief and worker processes "
        "sharing the card")
    cluster = ps_cluster_end_to_end(card, ps)
    log("  ps_cluster: " + json.dumps({k: {m: (round(v, 6) if isinstance(v, float) else v)
                                           for m, v in r.items()} for k, r in cluster.items()}))

    phase("11", "phase 11: the sharded, replicated, elastic PS (W2 at 2 shards x 2 replicas through "
        "a primary kill, served while it trains; W1 across a live 2 -> 3 reshard)")
    sharded = ps_sharded_end_to_end(card, cluster)
    log("  ps_sharded: " + json.dumps({k: {m: (round(v, 6) if isinstance(v, float) else v)
                                           for m, v in r.items()} for k, r in sharded.items()}))

    phase("12", f"phase 12: the model mesh axis (W4 word2vec and W5 PTB LSTM at --mesh={MA_MESH}, "
        "vocab-parallel tables) and ZeRO-1 (ResNet-50 --zero_opt on 2 data ranks)")
    t12 = time.perf_counter()
    model_axis = model_axis_end_to_end(card, dp["resnet_dp2"])
    zero_launches = {name: [r[name] for r in model_axis["zero"]["launches"]]
                     for name in ("bn_stats", "bn_bwd_stats")}
    log("  model_axis: " + json.dumps({k: {m: (round(v, 6) if isinstance(v, float) else v)
                                           for m, v in r.items() if m != "launches"}
                                       for k, r in model_axis.items()})
        + f"; phase 12 took {time.perf_counter() - t12:.1f} s")

    phase("13", "phase 13: the data planes (ResNet-50 from .dtxr, .npz and dsvc://; W2's PS cluster "
        "reading a data service killed once) and a canary deploy of the W2 CNN")
    t13 = time.perf_counter()
    planes = data_planes_end_to_end(card, resnet_run, cluster)
    log("  data_planes: " + json.dumps({k: {m: (round(v, 6) if isinstance(v, float) else v)
                                            for m, v in r.items()}
                                        for k, r in planes.items() if k != "launches"})
        + f"; phase 13 took {time.perf_counter() - t13:.1f} s")

    phase("14", f"phase 14: the flagship at T {LONG_T} on a data x seq x model mesh (the flash ring, "
        "fused and split hops, with Megatron TP; Ulysses), ranks sharing the card")
    t14 = time.perf_counter()
    hop_routes = time_hop_routes(flash, card)
    torch.cuda.empty_cache()  # the ranks are processes of their own
    seq_axis = seq_axis_end_to_end(card, long_losses, hop_routes)
    log("  seq_axis: " + json.dumps({k: {m: (round(v, 6) if isinstance(v, float) else v)
                                         for m, v in r.items()
                                         if m not in ("launches", "tc_launches", "traffic")}
                                     for k, r in seq_axis.items()})
        + f"; phase 14 took {time.perf_counter() - t14:.1f} s")
    paths14 = {"ring_fused": "train_t8192_seq2_ring_fused_by_rank",
               "ring_split_tp": "train_t8192_seq2_model2_ring_split_by_rank",
               "ulysses_tp": "train_t8192_seq2_model2_ulysses_by_rank"}

    def sp_launches(name: str) -> dict:
        """Phase 14's launches of kernel ``name``: by path and rank, their
        sum, and the sums on the tensor cores and the CUDA cores."""
        by_path = {paths14[run]: [r.get(name, 0) for r in seq_axis[run]["launches"]]
                   for run in paths14}
        tc = sum(r.get(name, 0) for run in paths14 for r in seq_axis[run]["tc_launches"])
        total = sum(sum(v) for v in by_path.values())
        return {"by_path": by_path, "total": total, "tc": tc, "cuda_core": total - tc}

    sp = {name: sp_launches(name) for name in SP_KERNELS}
    for name in SP_KERNELS:
        if sp[name]["total"] == 0:
            raise SystemExit(f"phase 14 launched {name} no time")

    phase("15", f"phase 15: the MoE flagship ({MOE_EXPERTS} experts, top-2, T {MOE_T}) trained on one "
        f"process and on --mesh={MOE_EP_MESH} (ranks sharing the card), then served from a "
        "pinned replica")
    t15 = time.perf_counter()
    moe = moe_end_to_end(card)
    log(f"  phase 15 took {time.perf_counter() - t15:.1f} s")

    def moe_launches(name: str) -> dict:
        """Phase 15's launches of kernel ``name`` by path (the expert mesh's
        by rank), their sum and the sum on the tensor cores."""
        by_path = {"train_moe": moe["train"]["launches"].get(name, 0),
                   "train_moe_ep2_by_rank": [r.get(name, 0)
                                             for r in moe["expert_mesh"]["launches"]]}
        if name == "flash_fwd":
            by_path["serve_moe"] = moe["serve"]["launches"].get(name, 0)
        total = by_path["train_moe"] + sum(by_path["train_moe_ep2_by_rank"]) + by_path.get(
            "serve_moe", 0)
        return {"by_path": by_path, "total": total}

    moe_l = {name: moe_launches(name) for name in MOE_KERNELS}
    for name in MOE_KERNELS:
        if moe_l[name]["total"] == 0:
            raise SystemExit(f"phase 15 launched {name} no time")

    phase("16", f"phase 16: GPipe over --mesh={PP_MESH} (the flagship, {PP_STAGES} stages, {PP_MICRO} "
        "microbatches), its stages collapsed and decoded over model=2, and ghost-batch BN "
        f"ResNet-50 over slice={GB_SLICES}, ranks sharing the card")
    t16 = time.perf_counter()
    pipe_slice = pipe_slice_end_to_end(card)
    log(f"  phase 16 took {time.perf_counter() - t16:.1f} s")
    pp_l = {name: [r.get(name, 0) for r in pipe_slice["pipe_launches"]] for name in PP_KERNELS}
    gb_l = {name: [r.get(name, 0) for r in pipe_slice["ghost_launches"]]
            for name in ("bn_stats", "bn_bwd_stats")}
    for name, by_rank in {**pp_l, **gb_l}.items():
        if sum(by_rank) == 0:
            raise SystemExit(f"phase 16 launched {name} no time")

    phase("17", "phase 17: the port's measuring tools on the card (ulysses_ab with the split and "
        "the fused backward, serving_bench --quick, the host tools, loadsim --scenario=canary)")
    t17 = time.perf_counter()
    tools17 = tools_end_to_end(card)
    log(f"  phase 17 took {time.perf_counter() - t17:.1f} s")
    ua_l = tools17["ulysses_launches"]
    ua_paths = {name: {f"ulysses_ab_{run}": ua_l[run][name] for run in ua_l}
                for name in SP_KERNELS}
    ua_total = {name: sum(ua_paths[name].values()) for name in SP_KERNELS}

    phase("18", "phase 18: the overload acceptance (loadsim --scenario=overload at the root's "
        "defaults) over a cluster of the port's CLI on the card")
    overload_end_to_end(card)

    csrc = "distributed_tensorflow_examples_tpu_torch/ops/csrc"
    tpu = "distributed_tensorflow_examples_tpu/ops/flash_attention.py"
    record = {"kernels": [
        {
            "name": "flash_fwd", "route": "cuda", "source": f"{csrc}/flash_fwd.cu",
            "replaces": f"{tpu}:135",
            "launches": serve_launches.get("flash_fwd", 0)
            + train_launches.get("flash_fwd", 0) + long_launches.get("flash_fwd", 0)
            + sp["flash_fwd"]["total"] + moe_l["flash_fwd"]["total"]
            + sum(pp_l["flash_fwd"]) + ua_total["flash_fwd"],
            "launches_by_path": {"serve": serve_launches.get("flash_fwd", 0),
                                 "train": train_launches.get("flash_fwd", 0),
                                 "train_t8192": long_launches.get("flash_fwd", 0),
                                 **sp["flash_fwd"]["by_path"],
                                 **moe_l["flash_fwd"]["by_path"],
                                 "train_pipe2_by_rank": pp_l["flash_fwd"],
                                 **ua_paths["flash_fwd"]},
            "tensor_core_launches": serve_tc.get("flash_fwd", 0)
            + train_tc.get("flash_fwd", 0) + long_tc.get("flash_fwd", 0)
            + sp["flash_fwd"]["tc"] + moe_l["flash_fwd"]["total"] + sum(pp_l["flash_fwd"])
            + ua_total["flash_fwd"],
            "cuda_core_launches": sp["flash_fwd"]["cuda_core"],
            "f32_route_at_hop_shape": hop_routes["flash_fwd"],
            "f32_out_flip_shares": flips["flash_fwd"],
            "max_abs_err": max(errs), **main_shape,
            "tensor_core_instructions": tensor_cores["flash_fwd"],
            "at_shapes": {"[16, 2048, 128]": main_shape, "[64, 2048, 128]": train_fwd,
                          "[16, 8192, 128]": long_fwd},
        },
        *({
            "name": name, "route": "cuda", "source": f"{csrc}/flash_bwd.cu",
            "replaces": f"{tpu}:{line}",
            "launches": train_launches.get(name, 0) + long_launches.get(name, 0)
            + sp[name]["total"] + moe_l[name]["total"] + sum(pp_l[name]) + ua_total[name],
            "launches_by_path": {"train": train_launches.get(name, 0),
                                 "train_t8192": long_launches.get(name, 0),
                                 **sp[name]["by_path"], **moe_l[name]["by_path"],
                                 "train_pipe2_by_rank": pp_l[name], **ua_paths[name]},
            "tensor_core_launches": train_tc.get(name, 0) + long_tc.get(name, 0)
            + sp[name]["tc"] + moe_l[name]["total"] + sum(pp_l[name]) + ua_total[name],
            "cuda_core_launches": sp[name]["cuda_core"],
            "f32_route_at_hop_shape": hop_routes[name],
            "f32_out_flip_shares": flips[name],
            "max_abs_err": max(e[name] for e in bwd_errs), **bwd[name],
            "tensor_core_instructions": tensor_cores[name],
        } for name, line in (("flash_dq", 211), ("flash_dkv", 244))),
        {
            "name": "flash_fused_bwd", "route": "cuda",
            "source": f"{csrc}/flash_fused_bwd.cu", "replaces": f"{tpu}:518",
            "launches": long_launches.get("flash_fused_bwd", 0)
            + sp["flash_fused_bwd"]["total"] + ua_total["flash_fused_bwd"],
            "launches_by_path": {"train_t8192": long_launches.get("flash_fused_bwd", 0),
                                 **sp["flash_fused_bwd"]["by_path"],
                                 **ua_paths["flash_fused_bwd"]},
            "tensor_core_launches": long_tc.get("flash_fused_bwd", 0)
            + sp["flash_fused_bwd"]["tc"] + ua_total["flash_fused_bwd"],
            "cuda_core_launches": sp["flash_fused_bwd"]["cuda_core"],
            "f32_route_at_hop_shape": hop_routes["flash_fused_bwd"],
            "f32_out_flip_shares": flips["flash_fused_bwd"],
            "max_abs_err": max(fused_errs), **fused,
            "tensor_core_instructions": tensor_cores["flash_fused_bwd"],
        },
        *({
            "name": name, "route": "cuda", "source": f"{csrc}/bn_stats.cu",
            "replaces": f"distributed_tensorflow_examples_tpu/ops/bn.py:{line}",
            "launches": resnet_launches.get(name, 0) + sum(dp_launches[name])
            + nccl_launches[name] + sum(zero_launches[name]) + sum(planes["launches"][name])
            + sum(gb_l[name]),
            "launches_by_path": {"train_resnet50": resnet_launches.get(name, 0),
                                 "train_resnet50_dp2_by_rank": dp_launches[name],
                                 "train_resnet50_nccl1": nccl_launches[name],
                                 "train_resnet50_zero1_dp2_by_rank": zero_launches[name],
                                 "train_resnet50_dtxr_npz_dsvc": planes["launches"][name],
                                 "train_resnet50_ghost_slice2_by_rank": gb_l[name]},
            "device_kernels": fb.BN_KERNELS[name],
            "max_abs_err": max(e[name] for e in bn_errs), **bn_times[name],
        } for name, line in (("bn_stats", 166), ("bn_bwd_stats", 239))),
    ]}
    ends = [t for _label, t in marks[1:]] + [time.perf_counter()]
    log("phase seconds: " + json.dumps({label: round(e - t, 1)
                                       for (label, t), e in zip(marks, ends)})
        + f"; phases 1-18 {time.perf_counter() - t_run:.1f} s")
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
