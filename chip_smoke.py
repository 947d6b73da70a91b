#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``unicore_tpu_torch``) on one NVIDIA
card: the quickest proof that the port builds, is right, trains and serves
on the GPU.  Run it from the root of a checkout::

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero and prints no
result line):

1. device — the card's name and ``nvidia-smi`` name/power limit;
2. build — every ``unicore_tpu_torch/csrc/*.cu`` with nvcc (sm_90a), with
   each kernel's registers, shared memory and spills from ``-Xptxas -v``;
3. kernels — each kernel's wrapper on card tensors at the main paths'
   shapes against its plain PyTorch version on the same inputs (max abs
   error vs a stated tolerance): the attention forward (dropout 0 and 0.1,
   its Philox mask read off the card and held bit for bit against the
   plain mask, keep rate within 5 sigma), the attention backward at every
   length the training path runs (dq, dk, dv, dbias vs autograd of the
   plain version in fp32, vs the plain backward with the kernel's roundings
   in bf16; dropout 0 and 0.1), the LayerNorm/RMSNorm forward with its
   statistics, dx and dw/db; tolerances at ``TOL``.  Each with
   its time per call (CUDA events, warmed, the median of 5 repeats of
   ``iters`` calls -- fewer for a call over 0.5 ms, ~50 ms a repeat --,
   with the min-max spread) and its device time (the
   kernels' own durations from ``torch.profiler`` over 20 calls -- ~20 ms
   of them for a call over 1 ms --, without the host's time between
   calls), the same two for the plain version and for one PyTorch
   library call (a backward timed alone on a retained autograd graph) --
   past each kernel's first two checks, a plain version over 0.5 ms a call
   and the library call's L2-flushed profile are not measured, for the
   time limit --, and
   the least time the card could take (bytes over 3.35 TB/s or operations
   over the type's peak rate, whichever is larger; fp32 attention at the
   3xTF32 rate, 495 / 3 TFLOP/s, the least for fp32 accuracy on tensor
   cores);
4a. training — the train CLI's ``main`` (``python -m
   unicore_tpu_torch.cli.train --device cuda``'s, in this process) on a
   full-width BERT-base (12 layers, 768 wide, 12 heads, max_seq_len 512;
   weights from ``--seed``) over an indexed corpus written from a seed
   (a ~30k-word dictionary, documents of 380-510 words so batches fill the
   384 and 512 buckets), ``--seq-pad-multiple 128``, batch 8,
   ``--update-freq 2``, Adam, clip 1.0, polynomial decay with warmup, the
   arch's own dropouts; kernel launches per micro-batch read from the CLI's
   stats line (12 attention forward + 12 backward, 26 norm forward + 26 dx
   + 26 dw/db), every loss finite and the last losses below the first;
   then one update of the same configuration in this process under
   ``torch.profiler`` (``bert_profile``: device time by kernel group, the
   attention backward's two launches apart, and the idle share);
4b. card against CPU — one training path (BERT-base widths at 2 layers,
   L=256, attention dropout 0.1, other dropouts 0) in this process, on the
   card (kernels) and on the CPU (plain versions) from the same weights and
   batches: per-update loss 1e-4 relative, gradient norm 1e-3 relative,
   parameters within 1e-5 absolute, no launch in the CPU run;
4. serving — a copy of the checkpoint 4a wrote, served by ``python -m
   unicore_tpu_torch.cli.serve --device cuda`` (batch 8, buckets
   128/256/384/512) under ``--fault-inject slow-client:3@2
   --request-read-timeout 1`` as replica 0 of phase 14's fleet, which
   starts with it and runs right after it (the requests go to the replica
   directly, with the other replica and the router idle); requests of
   every bucket, some concurrent;
   the one request the slow client stalls answered 408 with its named
   reason and sent again, the rest 200; per-batch kernel launches read from
   ``/stats`` (12 attention, 26 norm); ``GET /metrics`` parsed, its served,
   batch and shed counters equal to ``/stats``'s; two 128-bucket answers
   held against the same checkpoint run in this process on the CPU;
   SIGTERM -> drain -> exit 0 and the journal beside the checkpoint with
   the run's start, the slow client's shed and the drain, at the end of
   phase 14;
5a. Uni-Mol training — ``python -m unicore_tpu_torch.cli.train --task
   unimol --arch unimol --device cuda`` (15 layers, 512 wide, 64 heads, FFN
   2048, 128 Gaussian kernels; weights from ``--seed``) over an indexed
   corpus of pocket-sized conformers (119-126 atoms, so every micro-batch
   pads to L=128) written from a seed, batch 16, ``--update-freq 1``, 20
   updates, the example script's Adam (0.9, 0.99), eps 1e-6, wd 1e-4, clip
   1.0, polynomial decay from 1e-4 with warmup; launches per micro-batch
   read from its stats line (15 softmax_dropout forward + 15 backward, 35
   norm forward + 35 dx + 35 dw/db, no full-row attention), every
   micro-batch 128 long, every loss finite and the last below the first;
5b. Uni-Mol card against CPU — full widths at 2 layers, L=128, batch 4,
   attention dropout 0.1 (Philox on both sides), other dropouts 0, 3
   updates from the same weights and batches: the BERT path's limits (loss
   1e-4 relative, gradient norm 1e-3 relative, parameters 1e-5 absolute),
   no launch in the CPU run;
6a. Evoformer training — ``python -m unicore_tpu_torch.cli.train --task
   msa_pretrain --loss masked_msa --arch evoformer --device cuda`` (12
   blocks, msa 256 / 8 heads, pair 128 / 4 heads, head dim 32, dropout
   0.1; weights from ``--seed``) over an indexed corpus of MSAs written from
   a seed (targets of 249-256 residues with 40-64 homolog rows, so every
   micro-batch is L=256 and the 32-row subsample runs), batch 1,
   ``--update-freq 2``, 20 updates, the example script's Adam (0.9, 0.999),
   eps 1e-8, wd 1e-4, clip 1.0, polynomial decay from 1e-3 with warmup;
   launches per micro-batch from its stats line (36 flash forwards and 34
   of each flash backward kernel: the last block's pair updates do not
   reach the loss; 145 norm forwards, 137 dx and dw/db; no full-row or
   softmax launch), every loss finite and the last below the first; then
   one update of the same configuration in this process under
   ``torch.profiler``: device time by kernel group (the flash forward, the
   dq launch and the dk/dv/dbias launch apart) and the idle share;
6b. Evoformer card against CPU — full widths at 2 blocks, L=128, 16 rows,
   batch 2 (a grouped bias, Bb = 2), dropout 0, 3 updates from the same
   weights (the seed's, every one moved by a seeded 0.05 N(0, 1) so the
   zero-init projections pass gradient from the first update) and batches,
   the optimizer of 4b and 5b (lr 1e-4, eps 1e-6): the BERT path's limits,
   no launch in the CPU run;
7. decode serving — a full-width ``transformer_lm`` checkpoint (6 layers,
   768 wide, 12 heads, FFN 3072, max_seq_len 512, rel-pos bias, tied LM
   head) on phase 4a's dictionary, weights from a seed, served by ``python
   -m unicore_tpu_torch.cli.serve --device cuda`` (prefill batch 8, decode
   batch 8, cache buckets 128/256/384/512, 512 pages of 32 rows): 24
   ``/v1/generate`` requests of 20-470-token prompts, the first half one at
   a time and the rest concurrently, 32 new tokens each; from ``/stats``
   exactly 6 decode-attention launches per decode step, 6 full-row forwards
   per prefill batch, 14 norm forwards per dispatch and nothing else; two
   served generations held against the CPU teacher-forced (the served
   token is the CPU's argmax wherever its top-2 gap exceeds 1e-3); in this
   process on the card, prefill plus 16 decode steps of a bucket-128 batch
   against the full causal forward within 1e-4; a second server with
   ``--decode-kv int8`` (8 requests, the same launch arithmetic); 20
   decode steps at batch 8 in bucket 512 under ``torch.profiler``
   (``decode_profile``: device ms by kernel group, idle share); each
   server drains on SIGTERM and exits 0;
8. quantized serving — phase 4a's checkpoint served by ``python -m
   unicore_tpu_torch.cli.serve --device cuda --serve-quantize int8
   --quant-drift-sample 1`` (batch 8, buckets 128/256/384/512): the
   ``QUANT-PATH int8`` line and the scale sidecar beside the checkpoint; 12
   ``/v1/infer`` requests over every bucket, half concurrent; from
   ``/stats`` the ``precision`` and ``quant`` block (calibration drift below
   the JAX package's int8 bound, 0.05 of the logit absmax; every request's
   drift sampled) and exactly 49 W8A8 dense, 12 int8 softmax, 1 int8
   LayerNorm and 25 norm launches per batch and no full-row attention (the
   drift probe's launches counted apart; the probe's own held
   to the quantized plus the fp32 forward's); two answers held against the
   same checkpoint quantized in this process on the CPU from the server's
   sidecar (ids 99% equal, scores 1e-3 relative); in this process the
   served forward of a full top-bucket batch, int8 and fp32 on the same
   weights, timed and profiled (``quant_profile``: device ms by kernel
   group, idle share); then a ``--serve-quantize fp8`` server (4 requests; drift below 0.15; 12 full-row and 25 norm
   launches per batch, no W8A8 dense); each drains on SIGTERM and exits 0.
   The int8 server serves a copy of the checkpoint with ``--reload-interval
   0.5``: after its main path, 4a's weights moved by a seeded 0.01 N(0, 1)
   are published onto it (copy + ``os.replace``) while requests are in
   flight: the ``QUANT-PATH ... reload candidate re-calibrated`` line,
   ``RELOAD SWAPPED``, ``reloads_applied`` 1, the candidate's calibration
   drift below 0.05, every request in flight answered 200, phase 8's int8
   launches in each of 4 batches after the swap, those 4 answers bit for
   bit (ids and score) against the candidate quantized in the smoke's
   process on the card from the re-derived sidecar, on the batch the
   engine formed, two of them against it quantized on the CPU (scores 5e-3
   relative, above the 1.25e-3 measured on the card; the distance from the
   fp32 candidate is printed beside it; each twin's logits within the
   int8 drift bound 0.05 of the logit absmax of its own device's fp32
   candidate, the two twins within twice it; the ids where the CPU's top-2
   gap exceeds twice the score bound of the logit absmax are printed), the journal's ``reload-calibrated``, ``swapped`` and
   ``swapped-in``, the device memory's peak (``quant_serve_int8``'s
   ``reload``);
9. causal-LM training with the run control — 9a: ``python -m
   unicore_tpu_torch.cli.train --task causal_lm --arch transformer_lm
   --loss lm_cross_entropy --device cuda`` (6 layers, 768 wide, 12 heads,
   FFN 3072, tied head; weights from ``--seed``) on phase 4a's corpus as
   ``train`` and a ``valid`` split of 40 documents written the same way from
   another seed, ``--seq-pad-multiple 128 --length-bucket 4`` (buckets
   128/256/384/512), batch 8 x ``--update-freq 2``, 20 updates (25 an
   epoch), Adam (0.9, 0.98) eps 1e-6 wd 0.01, clip 1.0, ``inverse_sqrt``
   from 5e-4 after 5 warmup updates, ``--ema-decay 0.999
   --validate-with-ema``, validating and saving every 10 updates: the
   ``lm_train`` line (per-update losses, the valid losses, step ms,
   tokens/s, peak memory, launches), exactly 6 full-row forwards and 14
   norm forwards per forward (micro-batch or validation batch), 6 full-row
   backwards and 14 norm dx and dw/db per micro-batch, a falling loss,
   ``checkpoint_best.pt`` and ``checkpoint_1_10.pt``, then one update of the
   same configuration in this process under ``torch.profiler``
   (``lm_profile``, the groups of ``bert_profile``); 9b: a new run of the
   CLI's ``main`` in this process (no start-up of its own) resumed from 9a's ``checkpoint_1_10.pt`` (mid-epoch) into a fresh
   ``--save-dir`` for updates 11-20: ``resumed_from_update`` 10, lrs equal
   to 9a's, per-update losses and the update-20 valid loss within 1e-4
   relative (the full-row backward sums dbias by atomics, so the card is
   not bit-exact run to run); 9d: a
   2-layer full-width ``transformer_lm`` trained on the card and on the CPU
   from the same weights and batches, 3 updates at L=256 (the full-row
   kernels, attention dropout 0.1) and 3 at L=200 with
   ``--seq-pad-multiple 8`` (neither attention kernel: the plain softmax
   composition, as the JAX package routes that length; dropout 0), each
   with the EMA and one validation: loss 1e-4, gradient norm 1e-3
   relative, parameters and EMA 1e-5 absolute, valid loss 1e-4 relative;
10. mixed precision -- 10a: phase 4a's run (same corpus, seed and
   arguments) plus ``--bf16 --bf16-sr``, 20 updates: the ``bf16_train``
   line (per-update losses beside 4a's, step ms, tokens/s, peak memory,
   launches), 4a's launches per micro-batch, a falling loss, each update's
   loss within 2% relative of 4a's fp32 loss at the same update; then one
   update under ``torch.profiler`` (``bf16_profile``: 4a's groups with the
   products on cuBLAS's tensor cores as ``bf16_matmul`` and the optimizer
   -- Adam on the fp32 master, the copy-back with its rounding, the EMA --
   apart); 10b: phase 9a's run plus ``--bf16`` (``lm_bf16_train``): 9a's
   exact launches, per-update and valid losses within 2% relative of 9a's,
   the fp32 master in ``checkpoint_1_10.pt`` (with the share of its
   elements that the bf16 weights do not hold), then resumed from that
   checkpoint in a new run (``lm_bf16_resume``, the CLI's ``main`` in this
   process): lrs equal, losses
   and the update-20 valid loss within 1e-3 relative; 10c: 4a's run with
   ``--fp16 --fp16-init-scale 128 --fp16-scale-window 4`` for 10 updates,
   the CLI's ``main`` in this process (``fp16_train``): finite falling losses, the norms' launches and no
   attention or softmax kernel (the JAX package sends fp16 attention to its
   plain composition), each update's loss scale as the schedule gives it
   for the run's own overflows, grown at least once; then
   ``--fp16-init-scale 2**120`` (the CLI's trainer in this process): both
   of 2 updates overflow, are skipped (no optimizer step) and halve the
   scale; 10d: the
   card-against-CPU paths of 4b, 5b, 6b and 9d (L=256) with ``--bf16``
   (no SR), 3 updates each (``bf16_card_vs_cpu``): loss 1e-2 and gradient
   norm 5e-2 relative, each update's change to the fp32 master within 10%
   in L2 over all parameters, and on each side the bf16 parameters the
   nearest-even rounding of its own master, bit for bit;
11. the optimizer and loader plane -- 11a: 10a's run plus ``--fused-adam
   --num-workers 2 --prefetch-to-device`` (``fused_train``): each update's
   loss within 2% relative of 10a's (the SR noise differs), 4a's launches
   per micro-batch, exactly one ``multi_tensor_l2norm`` (K-a) and one
   ``fused_adam`` (K-b) launch per update (one dtype group), step ms,
   tokens/s and peak memory beside 10a's; then one update under
   ``torch.profiler`` (``fused_profile``: K-a and K-b, the optimizer's
   kernels); 11b: 4b's path with ``--fused-adam`` at 4b's tolerances, then a
   checkpoint written with the flag resumed with and without it (the next
   two losses within 1e-5 relative of each other and of the uninterrupted
   run); 11c: 9d's L=256 path with ``--grad-accum adama`` at 9d's
   tolerances, then 9a's full-width LM for 10 updates in buffer mode and in
   adama, each the CLI's ``main`` in this process (``adama_lm``: both peak
   memories, 9a's launches, falling losses);
   11d: 5a's Uni-Mol run plus ``--num-workers 4 --prefetch-to-device``
   (``unimol_loader``): each update's loss within 1e-4 relative of 5a's,
   the same consumed position after every update, the step median beside
   5a's; 11e: 4b's path at 4b's tolerances with ``--per-sample-clip-norm
   0.1`` (batch 4, dropout 0) and with ``--optimizer sgd --momentum 0.9``,
   then a 2-layer BERT-base checkpoint with a NaN in one named weight
   fine-tuned by the train CLI's ``main`` (in this process) with
   ``--nan-rerun`` on the card and on the CPU: both raise
   ``FloatingPointError`` naming that module (``nan_rerun``);
12. the training robustness plane, on 11a's cell (BERT-base, ``--bf16
   --bf16-sr --fused-adam --num-workers 2 --prefetch-to-device``) for 20
   updates (25 an epoch), saving at updates 10 and 20 -- 12a: the control,
   unarmed (``--sentinel-interval 0``) under ``--fault-inject
   bit-flip-checkpoint@15``; 12b: the health sentinel armed
   (``--sentinel-interval 1 --snapshot-interval 5 --snapshot-keep 2
   --sentinel-warmup 10 --loss-spike-window 16``) under ``--fault-inject
   loss-spike:100@13``, through the train CLI with
   ``Trainer.restore_health_snapshot`` wrapped (``REWIND_CHECK``): before
   the spike (``robust_healthy``) no sentinel event, each loss within 1e-4
   relative of 12a's, a snapshot every 5 updates whose copies ran on the
   card (each snapshot's bytes, host ms and the side stream's device ms),
   the update wall ms at the snapshot updates, at the ones after them and
   at the others, in both runs; then (``robust_rewind``) exactly one
   ``rewind`` by ``loss-spike`` to the snapshot at update 10, the restored
   parameters, fp32 master, moments, step counts and lr scheduler bit for
   bit equal to the run's own ``checkpoint_1_10.pt``, the event in
   ``checkpoint_last.pt``'s ``extra_state["sentinel"]``, 20 updates with
   finite losses, K-a and K-b once for every update run (``grad-explosion``
   is left to the CPU tests and the card runs that recorded it, for the
   time limit); 12c: a new run (the CLI's ``main`` in this process)
   resuming 12a's unarmed run with ``--checkpoint-write-version 1``: the
   manifest mismatch of ``checkpoint_last.pt`` and ``checkpoint_1_20.pt``
   named, the fallback to ``checkpoint_1_10.pt``, 20 updates; v2 write
   seconds beside the v1 write, and the async publish's seconds
   (``robust_corrupt``); 12d: SIGTERM after update 15 under
   ``--preemption-save-deadline 60``: exit 0, one minimal
   ``checkpoint_last.pt`` at the update it stopped at, resumed by a new run
   to 20 with each loss within 1e-4 relative of 12a's;
   ``--fault-inject raise@7 --emergency-save-on-error`` saving every 5: the
   ``ChaosError`` out of the CLI's ``main``, ``checkpoint_emergency.pt``
   beside ``checkpoint_last.pt``,
   and the train CLI's restore decision picks the latter (update 5)
   (``robust_preempt``);
13. the serving control plane -- 13a: 10a's ``checkpoint_last.pt`` (bf16
   weights) served in bf16 (batch 8, buckets 128/256/384/512) under
   ``--fault-inject request-flood:400@2 --admission-capacity 16
   --default-deadline-ms 40``: the log names the bf16 weights served in
   bf16; phase 4's launches per batch (12 full-row, 26 norm forwards) in
   bf16; during the flood's 10 s, probes of 200 ms every 0.1 s answered
   within their deadlines or shed with named reasons, sheds in ``/stats``,
   ``/metrics`` and the journal; then phase 4's requests as phase 4 sends
   them (client p50/p99 beside phase 4's fp32 server); two answers held
   against the same checkpoint served in bf16 on the CPU (ids 99%, scores
   2e-2 relative, the measured error printed); SIGTERM -> exit 0
   (``bf16_serve``); 13b: 10b's ``checkpoint_1_10.pt`` served over
   ``/v1/generate`` with phase 7's engine settings, ``--reload-interval
   0.5 --fault-inject corrupt-reload@1``: 8 requests over every cache
   bucket, exactly 6 launches of the decode attention's bf16-query variant
   a decode step (a bf16 q and bias row against the fp32 pool), 6 full-row
   forwards a prefill batch, 14 norm forwards a dispatch; two generations
   teacher-forced on the CPU in bf16 (top-2 gap 0.5); 10b's resumed
   ``checkpoint_last.pt`` published while generations are in flight:
   ``RELOAD ROLLBACK (rejected:verify)``, re-published: ``RELOAD
   SWAPPED``, every generation answered 200; the journal's
   ``rejected:verify``, ``swapped`` and ``swapped-in``; 10b's first
   checkpoint re-published (a second swap); the ``/metrics`` decode
   gauges; the device memory after the swap within 5% of before, and after
   the second swap (10b's first checkpoint served again) within 0.5% of
   before the first (no leak over two reloads);
   tokens/s and token p50/p99 beside phase 7's fp32 server
   (``lm_bf16_serve``);
14. the serving fleet (run right after phase 4, whose server is its
   replica 0) -- phase 4a's checkpoint copied to a fleet path and
   served by two replicas at once (``python -m unicore_tpu_torch.cli.serve
   --device cuda --advertise auto --fleet-kv DIR --replica-index 0|1
   --fleet-interval 0.5``, phase 4's engine settings, one journal
   directory; replica 0 under phase 4's slow client, replica 1 under
   ``--fault-inject replica-loss@150@1``)
   behind ``python -m unicore_tpu_torch.cli.router --fleet-timeout 3
   --path <the fleet path> --reload-interval 0.5``: each replica registered
   before it was ready, 2 routable; 24 requests over every bucket and phase
   4's two CPU-checked rows through the router, half one at a time and half
   concurrent, all 200, both replicas serving (the split printed), each
   replica's ``/stats`` exactly 12 full-row and 26 norm launches a batch and
   nothing else, the two rows against phase 4's CPU reference (ids 99%,
   scores 1e-3 relative), the router's ``/metrics`` counters equal to its
   ``/stats``; 4a's weights moved by a seeded 0.01 N(0, 1) published onto
   the fleet path with requests in flight: ``ROLLING RELOAD COMPLETE``
   2/2, every request in flight 200, both leases' digests equal and new,
   each replica's device memory after its swap within 5% of before; a
   rotten copy published: ``ROLLING RELOAD HALT`` after one rollback,
   replica 1 never asked, the digests kept; traffic until replica 1 exits
   74: the router's ``REPLICA-LOSS`` verdict within the fleet timeout plus
   two lease intervals (the replica's beat and the router's poll) and half a
   second of the exit, every answer 200 or a named outcome and every one
   sent after the verdict 200, 1 routable; SIGTERM on replica 0: exit 0,
   ``FLEET DEREGISTERED`` in both logs, then the router's 503
   ``no-ready-replica`` with ``Retry-After``; SIGTERM on the router: exit
   0; the journal directory holds the router's and both replicas' files,
   the router's with the loss verdict, the complete and the halted roll and
   the goodbye (``fleet_serve``: the split, the router's client p50/p99
   beside phase 4's -- the two replicas time-share one card --, the roll
   and halt seconds, the verdict latency, the outcomes and sheds by
   reason).  The JAX package's trace merger is held on this journal in
   the CPU tests (``tests/test_torch_fleet_cli.py``): this script runs
   nothing of the JAX package;
15. data parallelism — 15a: 11a's train CLI run under a process group of
   one rank (``--distributed-world-size 1 --distributed-init-method``:
   NCCL on the card; its stats name the backend), and its in-process
   profile's trainer under one too, whose first two updates hold every
   reduction bit for bit against its input (the flat gradient buffers
   after the NCCL all-reduce, the sample size and logging sums after
   theirs), so the run under the group is the run without it; 15b: 4a's
   BERT-base in fp32 with dropouts 0 and 4b's optimizer on two ranks of
   the train CLI over gloo (``--distributed-world-size 2
   --distributed-backend gloo``: NCCL refuses two ranks on one card), 3
   updates of batch 8 a rank: the ranks' parameters the same bits, 4a's
   launches per micro-batch on each rank, and against the one-rank
   ``--update-freq 2`` run on the same batches (in this process) the
   losses within 1e-4, the gradient norms within 1e-3 and rank 0's saved
   parameters within 1e-5; 15c: ``python -m
   unicore_tpu_torch.tools.dp_pair`` (one spawned pair) at ``--num-pods
   2``, ``sum`` (every reduction the bits of the flat all-reduce of the
   same buffers) then ``adasum`` (finite, the ranks the same bits), 2
   updates each (``dp_train``: the update wall ms beside the one-rank
   run's -- two ranks time-share one card, not a scaling figure --, each
   reduction's ms and bytes, flat and two-level, the launches a rank);
   15d: in the same spawned pair, ZeRO legs at ``--num-pods 1`` of 4a's
   model and corpus with ``--fused-adam --clip-norm 0``, 2 updates each:
   fp32 stages 0, 1 and 2, ``--bf16 --bf16-sr`` stages 0 and 3, each
   sharded leg updating from its stage-0 leg's reduced gradients (two
   training runs on the card differ in the gradient's last bits: #2 sums
   the bias gradient with atomics); each leg's state is gathered to rank
   0's host as a checkpoint gathers it, and the stage-2 leg's is saved by
   rank 0 and loaded back by every rank (``dp_zero``: each leg's ranks'
   parameter digests -- equal, and equal to its dtype's stage-0 leg --,
   the gathered state's digests -- equal to the stage-0 leg's, on rank 0
   alone --, the gradient norms -- the stage-0 leg's bits --, how far each
   rank's own reduced gradient was from stage 0's -- within 1e-5 in fp32,
   1e-3 in bf16 --, each rank's optimizer-state bytes -- at a sharded
   stage half of stage 0's plus at most half the padding --, its peak
   allocated bytes and the bytes the gather added on its card -- less than
   the whole state, and on rank 1 no more than its share --, the update
   walls, the reduction's ms and bytes, 4a's launches plus one K-a and one
   K-b an update on each rank, the reload's verdict);
16. training telemetry -- 16a: phase 11a's run with ``--log-format json
   --log-interval 5 --telemetry-sample-interval 4 --profile-steps 8:10
   --metrics-port <free> --tensorboard-logdir <dir>`` (no process of its
   own): every JSON progress line parses, each ``train_inner`` line holds
   the JAX trainer's stat names in its order (``TRAIN_INNER_KEYS``) and one
   ``train`` line ends each epoch; the journal holds one ``comm-plan``, the
   sampled updates' ``data_wait`` / ``dispatch`` spans and lag-1
   ``device_busy`` (with its ``upper_bound`` flag), ``profile-start`` at 8
   and ``profile-stop`` at 10, a ``checkpoint-save`` for each write and
   ``fused-norm-path`` naming the CUDA kernel; the window's Chrome trace
   holds exactly the CLI's launches per update times 2 of #1, #2 (its two
   kernels), #7, #8/#9, K-a and K-b (``PROFILE_KERNELS``); a ``/metrics``
   scrape during the run shows ``unicore_tpu_train_updates_total`` >= 5 and
   the span gauges; TensorBoard's ``loss`` scalars equal the JSON lines'
   (or, with no writer installed, the one warning); read, not gated: the
   walls of the sampled, profiled and other updates, ``dispatch`` past
   ``device_busy``, 11a's medians beside ``PERF.md``'s
   (``train_telemetry``); 16b: ``python -m unicore_tpu_torch.cli.trace``
   on phase 12's one journal directory names 12b's rewind to its snapshot,
   12c's fallback to the intact checkpoint, 12d's SIGTERM stop and its
   emergency save, and writes a Chrome trace that parses
   (``trace_merge``);
17. a ``phase_seconds`` line (every phase's seconds), a
   ``missing_device_times`` line naming any phase-3 check whose device
   time the profiler did not read (an empty profile is retried), the
   ``nvidia-smi`` line (name, power limit), the ``kernels`` JSON line and,
   last, the ``{"ok": true, "device": ...}`` line.

Phase 3 also holds the softmax(+dropout) kernels against
``softmax_dropout_plain``: Uni-Mol's (16 * 64, 128, 128) fp32 at rate 0.1,
and at rate 0 beside ``torch.softmax`` (the like-for-like yardstick: no
PyTorch call takes the dropout), L=256 and 512, bf16, a ``bcast`` and a
``tile`` extra with their gradients, rows holding -inf, and the keep mask read off the card bit for
bit against ``philox_keep_plain``; the norms at D=64 over 16 * 128**2
rows, the width of Uni-Mol's head norms, at the Evoformer's D=256 and
D=128 and at Uni-Mol's (2048, 512) layer norms (the forward, #7, in its
serving and its training form, each timed warm and with the L2 flushed
against its own bound -- the training form's counts the fp32 statistics --
beside ``F.layer_norm`` / ``F.rms_norm``, with its statistics within 1e-5
of the fp32 plain ones, the same bits twice and one device operation a
call; the backward, #8 and #9, is one call: it is held through autograd
and alone against ``fused_norm_bwd_plain``, the same bits twice, and timed
warm and with the L2 flushed beside ``F.layer_norm``'s / ``F.rms_norm``'s
backward and its device operations counted); and the four flash kernels (forward with its lse, dq with di,
dk/dv with dbias folded into the same launch) against
``flash_attention_plain`` in fp32 and bf16 at phase 6a's
triangle (256, 4, 256, 32) and MSA-row (32, 8, 256, 32) shapes with their
(1, H, 256, 256) bias, the same at batch 2 with a grouped (2, H, 256, 256)
bias, a shared (1, 1) bias, and BERT's (2, 12, 1152, 64) at dropout 0.1 (past the full-row gate),
each with a fully masked key row, and the flash keep mask read off the
card bit for bit; the library yardstick there is one
``scaled_dot_product_attention`` with the bias expanded into its mask, and
each check's ``flash_attention_bwd_total`` line sets the backward's two
launches, summed, beside SDPA's backward and the bound.  It
also holds the decode attention against ``decode_attention_plain`` at phase
7's step (8, 12, 512, 64) in fp32 and bf16, with int8 KV, with mixed
positions and junk rows past them, and at the 128 bucket, each with the
split count its wrapper chose, and a second call on the same inputs
(mixed positions, a chunk of -inf bias) that must equal the first bit for
bit; its yardstick is SDPA over the single query row with the bias row and
the dead rows in a float mask (int8: the dequant, then SDPA).  Its
bf16-query variant (a bf16 LM's step: a bf16 q and a bf16 bias row
against the fp32 pool, and against int8 caches) at the same shape, with
mixed positions and the repeat; its yardstick SDPA in fp32 on the query
cast (the ``decode_attention_bf16q`` row of the ``kernels`` line).  And it holds
the three int8 serving kernels at BERT-base serving shapes (8 x 512 = 4096
rows): the W8A8 dense against ``quant_matmul_plain`` at every dense site
of a served batch -- ``in_proj`` (768 -> 2304), ``out_proj`` (768 -> 768),
``fc1`` (768 -> 3072, GELU), ``fc2`` (3072 -> 768), the LM head (768 ->
768, GELU), each with its bias -- and an M of 4093 (1e-6 of the output's
absmax; yardstick one ``torch._int_mm`` plus the epilogue in torch ops,
logged beside the kernel at every site with the tile width it ran); the
int8 LayerNorm at
(4096, 768) with a scalar and a per-channel scale (the dequant multiply
plus ``F.layer_norm``); the int8/int32 softmax on (8, 12, 512, 512) int32
scores with the (8, 1, 1, 512) ``finfo.min`` key mask and the (1, 12, 512,
512) bias, and on int8 at (8, 12, 128, 128) (the dequant multiply, the adds
and ``torch.softmax``).

Phase 3 also holds the optimizer plane's two kernels against their plain
versions at fp32 buffers of 110,000,000 (BERT-base's parameter count),
1,000,003 and 1 elements: K-a (the L2 norm, each element divided by a
device scalar) within 1e-6 relative of ``vector_norm`` and the same bits on
a second call, its yardstick ``vector_norm`` of the buffer; K-b (two
segments, the first decayed; the clip read from K-a's norm) with fp32
parameters, bf16 parameters rounded to nearest even and bf16 under SR,
bit for bit on m, v, the master and the parameters, its yardstick the
per-tensor path's torch calls for the same update.  At the first two sizes
it also holds the ZeRO segment modes (``segments``, timed at 110,000,000):
the buffer zero-padded and cut in two as two ranks' segments, K-a's
sum-of-squares mode on each, the partials in order, and its stage 2 alone
give the whole buffer's norm bit for bit (and the plain versions the plain
whole's); K-b on each segment (its offset, the clipped chunk table) gives
the whole buffer's m, v, master and parameters bit for bit, SR included,
and each segment equals its plain version.

Phase 3 also holds the full-row forward and backward at the causal LM's
attention, (8, 12, 512, 64): the rel-pos bias plus the ``triu`` of
``CAUSAL_NEG`` as one (1, 12, 512, 512) bias that needs a gradient, the key
mask and dropout 0.1, with dbias exactly 0 at every entry above the
diagonal.  And the inputs of a ``--bf16`` / ``--fp16`` run: the norms at
(4096, 768) with bf16 and with fp16 x, weight and bias, and at Uni-Mol's
and the Evoformer's D = 64 / 128 / 256 rows with bf16 ones; the full-row
kernels at (8, 12, 512, 64) bf16 with a bf16 bias, with and without the
causal triangle, dropout 0.1; the flash kernels at the triangle shape
(256, 4, 256, 32) bf16 with a bf16 (1, 4, 256, 256) bias; each gradient in
its input's type (dw, db and dbias in bf16 or fp16).

Without a CUDA card, or without the port beside it, it exits non-zero.
``--cpu-rehearsal`` runs phases 3 to 16 on the CPU at ``bert_tiny``,
``unimol_tiny``, an Evoformer whose attentions take the flash route and
``transformer_lm_tiny``, through the plain versions (no card, no kernels,
no profile, no result line) to check the script's own control flow.

A ``python -m unicore_tpu_torch.cli.train`` run above is a process of its
own where another process must watch it or its ranks spawn (11a with its
``/metrics`` scrapes, 12b, 12d's SIGTERM, 15b's ranks); the
others call the CLI's ``main`` with the same arguments in this process
(``train_in_process``: no interpreter, torch import or CUDA context of
their own, ~7-15 s each on the card; their peak memory counts what this
process still holds).
"""

import argparse
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time
import traceback
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and flop/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float32_3xtf32": 495e12 / 3, "bfloat16": 989e12,
              "int8": 1979e12}
#: tolerances, kernel vs plain version on the same inputs.  Forward
#: outputs, max abs error: fp32 differs only in summation order; bf16 may
#: round last-bit fp32 differences to neighbouring bf16 values (one ulp is
#: 2**-8 below 1 and 2**-4 below 16 in magnitude), so the bf16 full-row
#: forward also allows two ulps of each element (BF16_ULPS of it).  Gradients, per element
#: (:func:`grad_check`): the ``*_grad`` fraction of the reference's largest
#: magnitude (at least 1) for every output, the fp32 outputs of bf16 runs
#: included (dw, db, dbias, and dk, dv as the kernel sums them before their
#: cast) -- the full-row backward adds dbias by atomics in an order that
#: changes from run to run; plus two bf16 ulps of the element
#: (BF16_ULPS of it) for an output stored in bf16, and for the attention
#: backward in bf16 ``bwd_rounding_slack``: pd and ds round to bf16 before
#: their products, and may land one ulp apart on the two sides.
#: Softmax(+dropout) forward, per element: 1e-6 absolute (probabilities;
#: summation order and exp's last bits), plus two bf16 ulps of the element
#: (BF16_ULPS of it) in bf16, where the cast of p and of the dropped
#: quotient may each land on a neighbouring value.
TOL = {
    "attention": {"float32": 2e-5, "bfloat16": 2e-2},
    # fp16: two ulps below 16 in magnitude (2**-7 each)
    "norm": {"float32": 1e-5, "bfloat16": 6.25e-2, "float16": 1.5625e-2},
    "softmax": 1e-6,
    "attention_grad": 1e-4,
    "norm_grad": 1e-5,
    "softmax_grad": 1e-5,
    "decode": 1e-5,
    "decode_bf16_ulps": 2 * 2.0 ** -7,
}
BF16_ULPS = 2.0 ** -6
#: two fp16 ulps of an element (10 mantissa bits), for a gradient stored in fp16
FP16_ULPS = 2.0 ** -9
#: kernel -> (the TPU kernel it replaces, its source, the main path whose
#: launches the result line reports as ``launches``)
KERNELS = {
    "fullrow_attention_fwd": ("unicore_tpu/ops/attention_fullrow.py:110",
                              "unicore_tpu_torch/csrc/attention_fullrow.cu", "train"),
    "fullrow_attention_bwd": ("unicore_tpu/ops/attention_fullrow.py:205",
                              "unicore_tpu_torch/csrc/attention_fullrow.cu", "train"),
    "fused_norm_fwd": ("unicore_tpu/ops/fused_norm.py:56",
                       "unicore_tpu_torch/csrc/fused_norm.cu", "train"),
    "fused_norm_dx": ("unicore_tpu/ops/fused_norm.py:140",
                      "unicore_tpu_torch/csrc/fused_norm.cu", "train"),
    "fused_norm_dwdb": ("unicore_tpu/ops/fused_norm.py:157",
                        "unicore_tpu_torch/csrc/fused_norm.cu", "train"),
    "softmax_dropout_fwd": ("unicore_tpu/ops/softmax_dropout_pallas.py:223",
                            "unicore_tpu_torch/csrc/softmax_dropout.cu", "unimol_train"),
    "softmax_dropout_bwd": ("unicore_tpu/ops/softmax_dropout_pallas.py:234",
                            "unicore_tpu_torch/csrc/softmax_dropout.cu", "unimol_train"),
    "flash_attention_fwd": ("unicore_tpu/ops/flash_attention.py:93",
                            "unicore_tpu_torch/csrc/flash_attention.cu", "evoformer_train"),
    "flash_attention_dq": ("unicore_tpu/ops/flash_attention.py:311",
                           "unicore_tpu_torch/csrc/flash_attention.cu", "evoformer_train"),
    "flash_attention_dkv": ("unicore_tpu/ops/flash_attention.py:341",
                            "unicore_tpu_torch/csrc/flash_attention.cu", "evoformer_train"),
    "flash_attention_db": ("unicore_tpu/ops/flash_attention.py:387",
                           "unicore_tpu_torch/csrc/flash_attention.cu", "evoformer_train"),
    "decode_attention": ("unicore_tpu/ops/decode_attention.py:98",
                         "unicore_tpu_torch/csrc/decode_attention.cu", "decode_serve"),
    # the same TPU kernel's bf16-query variant (a bf16 q and bias against the
    # fp32 pool), on the bf16 LM's served decode step (phase 13b)
    "decode_attention_bf16q": ("unicore_tpu/ops/decode_attention.py:98",
                               "unicore_tpu_torch/csrc/decode_attention.cu",
                               "lm_bf16_serve"),
    "quant_matmul": ("unicore_tpu/ops/quant_matmul.py:147",
                     "unicore_tpu_torch/csrc/quant_matmul.cu", "quant_serve"),
    "quant_layer_norm": ("unicore_tpu/ops/fused_norm.py:281",
                         "unicore_tpu_torch/csrc/fused_norm.cu", "quant_serve"),
    "quant_softmax_dropout_fwd": ("unicore_tpu/ops/softmax_dropout_pallas.py:443",
                                  "unicore_tpu_torch/csrc/softmax_dropout.cu", "quant_serve"),
    # jnp in the JAX package (XLA fuses each into one pass; no Pallas kernel)
    "multi_tensor_l2norm": ("unicore_tpu/optim/multi_tensor.py:232",
                            "unicore_tpu_torch/csrc/multi_tensor.cu", "fused_train"),
    "fused_adam": ("unicore_tpu/optim/multi_tensor.py:259",
                   "unicore_tpu_torch/csrc/multi_tensor.cu", "fused_train"),
}


#: the monotonic clock when the script started, for each log line's stamp
T0 = time.monotonic()


def log(msg):
    print(f"[chip_smoke {time.monotonic() - T0:.1f}s] {msg}", flush=True)


def nvidia_smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi unavailable ({err})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"nvidia-smi gave nothing (rc {out.returncode})"
    )


def dtype_name(dtype):
    return str(dtype).split(".")[1]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def time_ms(torch, fn, device, iters=100, warm=10, repeats=5, budget_ms=50.0):
    """(median, [min, max]) milliseconds per call over ``repeats`` runs of
    ``iters`` warmed calls: CUDA events on the card, the host clock on the
    CPU rehearsal.  A call slower than ``budget_ms / iters`` (the plain
    versions, mostly) warms and runs fewer calls a repeat, about
    ``budget_ms`` of them and at least 5, so the yardsticks do not hold the
    script's time limit."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        one_ms = (time.perf_counter() - t0) * 1e3
        fit = int(budget_ms / max(one_ms, 1e-6))
        iters, warm = max(5, min(iters, fit)), max(1, min(warm, fit // 10))
    for _ in range(warm):
        fn()
    runs = []
    for _ in range(repeats):
        if device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            runs.append((time.perf_counter() - t0) * 1e3 / iters)
            continue
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        runs.append(start.elapsed_time(end) / iters)
    runs.sort()
    return runs[len(runs) // 2], [runs[0], runs[-1]]


#: the kernel of :func:`l2_flush`'s pass, which :func:`device_profile` leaves out
FLUSH_KERNEL = "bitwise_not"
_FLUSH_BUFFERS = {}


def l2_flush(torch, device, nbytes=64 << 20):
    """A call that rewrites ``nbytes`` (64 MB, past the H100's 50 MB L2) on
    ``device``, so the next kernel finds its inputs in device memory."""
    if device not in _FLUSH_BUFFERS:
        _FLUSH_BUFFERS[device] = torch.zeros(nbytes, dtype=torch.uint8, device=device)
    buf = _FLUSH_BUFFERS[device]
    return lambda: buf.bitwise_not_()


def device_profile(torch, fn, iters=20, flush=None, attempts=3):
    """(milliseconds of device work a call, device operations a call): the
    durations and the count of the CUDA kernels, memsets and copies the
    calls launch, summed by ``torch.profiler`` (CUPTI) over ``iters`` warmed
    calls, each after ``flush()`` when given (its kernel left out).  CUDA
    events around back-to-back calls also count the host's time between
    launches, which is most of a call of a few microseconds.  CUPTI drops
    kernel events now and then (one of 40, or all of them), never adds any:
    a profile whose count is not a whole number of operations a call, or
    that saw no device work, is taken again with a fresh profiler, up to
    ``attempts`` profiles, and the fullest kept; (None, None) when none saw
    any.  A one-byte pass of the flush kernel opens each profile, where a
    dropped first event costs nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    opener = torch.zeros(1, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    best_us, best_ops = 0.0, 0
    for _attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            opener.bitwise_not_()
            for _ in range(iters):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and FLUSH_KERNEL not in e.key]
        ops = sum(e.count for e in events)
        if ops > best_ops:
            best_us, best_ops = sum(e.self_device_time_total for e in events), ops
        if best_ops > 0 and best_ops % iters == 0:
            break
    if best_us <= 0:
        return None, None
    return best_us / iters / 1e3, best_ops / iters


def device_ms(torch, fn, iters=20):
    """Milliseconds of device work per call (:func:`device_profile`)."""
    return device_profile(torch, fn, iters)[0]


#: past a kernel's first two checks (the main path's shape, whose numbers the
#: ``kernels`` line carries, and the next), a check is lean: a plain version
#: slower than this a call goes unmeasured, and the library call's flushed
#: profile too, for the script's time limit; the library call is always timed
LEAN_PLAIN_MS = 0.5


def too_slow(torch, fn, device):
    """Whether one warmed call of ``fn`` on the card takes over
    :data:`LEAN_PLAIN_MS`."""
    if device.type != "cuda":
        return False
    fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3 > LEAN_PLAIN_MS


def timed(res, key, torch, fn, device, iters, lean=False):
    """res[key], res[<key>_spread]: ms per call by :func:`time_ms`; on the
    card also res[<key with device_ms>]: :func:`device_ms`.  With ``lean``, a
    call of ``fn`` over :data:`LEAN_PLAIN_MS` is not measured (all three
    None), and a faster one over 3 repeats of ~25 ms."""
    if lean and too_slow(torch, fn, device):
        res[key] = res[key.replace("ms", "ms_spread")] = None
        res[key.replace("ms", "device_ms")] = None
        return
    res[key], res[key.replace("ms", "ms_spread")] = (
        time_ms(torch, fn, device, iters, repeats=3, budget_ms=25.0) if lean
        else time_ms(torch, fn, device, iters))
    # a call over 1 ms (a plain version) is profiled over fewer calls, ~20 ms
    n = 20 if res[key] <= 1.0 else max(4, int(20.0 / res[key]))
    res[key.replace("ms", "device_ms")] = (
        device_ms(torch, fn, n) if device.type == "cuda" else None)


def backward_call(torch, fwd, leaves, grad_out):
    """A backward alone through autograd: one forward, then the backward
    repeated on the retained graph.  (Forward + backward minus forward
    subtracts two noisy times, and came out negative for the plain
    version, whose Philox runs as many small integer kernels.)"""
    out = fwd()
    return lambda: torch.autograd.grad(out, leaves, grad_out, retain_graph=True)


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attention_bound(res, nbytes, flops):
    """res[bound_ms], res[bound_by], res[bound_rate] of an attention check
    (full-row and flash alike): fp32 at the 3xTF32 rate (495 / 3 TFLOP/s,
    the least time for fp32 accuracy on tensor cores), bf16 at 989."""
    rate = "float32_3xtf32" if res["dtype"] == "float32" else res["dtype"]
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops, rate)
    res["bound_rate"] = f"{rate} {PEAK_FLOPS[rate] / 1e12:.0f} TFLOP/s"


def rel_err(got, ref):
    """max |got - ref| and the scale max(1, max |ref|) it is held against."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, max(1.0, ref.float().abs().max().item())


def grad_tolerance(floor, dtype):
    """:func:`grad_check`'s tolerance in words, for the result lines."""
    text = f"{floor} x max(1, max|ref|)"
    if "bfloat16" in str(dtype):
        text += f" + {BF16_ULPS} x |ref| where stored in bf16"
    if "float16" in str(dtype) and "bfloat16" not in str(dtype):
        text += f" + {FP16_ULPS} x |ref| where stored in fp16"
    return text


def grad_check(torch, name, got, ref, floor, slack=0.0):
    """(max abs error, max error over tolerance) of one gradient, raising
    past 1: per element, ``floor`` x max(1, max|ref|) + ``slack``, plus
    BF16_ULPS (FP16_ULPS) of the element where ``got`` is stored in bf16
    (fp16)."""
    ref = ref.float()
    err = (got.float() - ref).abs()
    tol = floor * max(1.0, ref.abs().max().item()) + slack
    if got.dtype == torch.bfloat16:
        tol = tol + BF16_ULPS * ref.abs()
    elif got.dtype == torch.float16:
        tol = tol + FP16_ULPS * ref.abs()
    worst, ratio = err.max().item(), (err / tol).max().item()
    if not (ratio <= 1.0 and math.isfinite(worst)):
        raise AssertionError(f"{name}: max abs err {worst}, {ratio} x its tolerance")
    return worst, ratio


def attention_inputs(torch, device, B, H, L, D, dtype, seed, causal=False,
                     bias_dtype=None):
    """q, k, v, do, a (1, H, L, L) bias (with ``causal``, plus the causal
    LM's ``triu`` of ``CAUSAL_NEG``; in ``bias_dtype``, fp32 by default), a
    key mask with a fully-masked row, and SDPA's float mask."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = (torch.randn(B, H, L, D, generator=g, device=device) * D ** -0.5).to(dtype)
    k = torch.randn(B, H, L, D, generator=g, device=device).to(dtype)
    v = torch.randn(B, H, L, D, generator=g, device=device).to(dtype)
    do = torch.randn(B, H, L, D, generator=g, device=device).to(dtype)
    bias = torch.randn(1, H, L, L, generator=g, device=device)
    if causal:
        from unicore_tpu_torch.modules.transformer_decoder import CAUSAL_NEG

        bias = bias + torch.triu(torch.full((L, L), CAUSAL_NEG, device=device), 1)
    if bias_dtype is not None:
        bias = bias.to(bias_dtype)
    lens = torch.linspace(L, L // 3, B, device=device).long()
    lens[-1] = 0  # a fully-masked row, like the serve engine's fill rows
    mask = (torch.arange(L, device=device)[None, :] >= lens[:, None]).to(torch.int32)
    # the library yardstick: SDPA with a float mask and no fully-masked row
    lens_lib = lens.clone()
    lens_lib[-1] = L // 3
    keymask = torch.arange(L, device=device)[None, :] >= lens_lib[:, None]
    attn_mask = (bias.float()
                 + torch.where(keymask, float("-inf"), 0.0)[:, None, None, :]).to(dtype)
    return q, k, v, do, bias, mask, attn_mask


def check_attention(torch, device, B, H, L, D, dtype, iters, rate=0.0, seed=1234,
                    causal=False, bias_dtype=None, lean=False):
    import torch.nn.functional as F

    from unicore_tpu_torch.ops import attention_fullrow as fr

    q, k, v, _, bias, mask, attn_mask = attention_inputs(torch, device, B, H, L, D,
                                                         dtype, L, causal, bias_dtype)
    call = lambda: fr.fullrow_attention(  # noqa: E731
        q, k, v, bias=bias, kv_padding_mask=mask, dropout_rate=rate,
        dropout_seed=seed)
    plain = lambda: fr.fullrow_attention_plain(q, k, v, bias, mask, 1.0, rate, seed)  # noqa: E731
    out, ref = call().float(), plain().float()
    diff = (out - ref).abs()
    err = diff.max().item()
    masked_row_zero = out[-1].abs().max().item() == 0.0
    tol = TOL["attention"][dtype_name(dtype)]
    # bf16: per element, at least two ulps of the element (a causal row of
    # few keys reaches |v| ~ 4.5, where one ulp is 2**-5)
    over = (diff / (tol + BF16_ULPS * ref.abs()) if dtype == torch.bfloat16
            else diff / tol).max().item()
    name = (f"attention fwd B={B} H={H} L={L} D={D} {dtype} dropout={rate}"
            + (" causal" if causal else "") + f" bias {bias.dtype}")
    if not (over <= 1.0 and masked_row_zero and math.isfinite(err)):
        raise AssertionError(
            f"{name}: kernel vs plain max abs err {err}, {over} x its tolerance (tol "
            f"{tol}), fully-masked row zero: {masked_row_zero}"
        )
    res = {"shape": [B, H, L, D], "dtype": dtype_name(dtype), "dropout": rate,
           "causal": causal, "bias_dtype": dtype_name(bias.dtype), "max_abs_err": err,
           "max_err_over_tol": over,
           "tolerance": tol if dtype != torch.bfloat16 else
           f"{tol} + {BF16_ULPS} x |ref| (bf16)"}
    timed(res, "ms", torch, call, device, iters)
    timed(res, "plain_ms", torch, plain, device, iters, lean=lean)
    timed(res, "library_ms", torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, scale=1.0, dropout_p=rate), device, iters)
    nbytes = (4 * B * H * L * D * q.element_size() + bias.numel() * bias.element_size()
              + mask.numel() * 4)
    attention_bound(res, nbytes, 4 * B * H * L * L * D)
    log(f"{name}: {json.dumps(res)}")
    return res


def check_dropout_mask(torch, device, B, H, rate, seed):
    """q = k = 0 makes every kept probability 1/L scaled, and v = I makes the
    output the dropped probability row itself: the kernel's keep mask,
    read off the card, against the plain Philox mask bit for bit, and its
    keep rate within 5 binomial sigmas of 1 - rate."""
    from unicore_tpu_torch.ops import attention_fullrow as fr

    L = 128
    z = torch.zeros(B, H, L, L, device=device)
    eye = torch.eye(L, device=device).expand(B, H, L, L).contiguous()
    kernel_keep = fr.fullrow_attention(z, z, eye, dropout_rate=rate,
                                       dropout_seed=seed) != 0
    plain_keep = fr.philox_keep_plain(B, H, L, L, seed, rate, device=device)
    keep_rate = kernel_keep.float().mean().item()
    sigma = math.sqrt(rate * (1 - rate) / kernel_keep.numel())
    res = {"shape": [B, H, L, L], "mask_equal": bool(torch.equal(kernel_keep, plain_keep)),
           "keep_rate": keep_rate, "expected": 1 - rate, "sigma": sigma}
    log(f"attention dropout mask: {json.dumps(res)}")
    if not res["mask_equal"] or abs(keep_rate - (1 - rate)) > 5 * sigma:
        raise AssertionError(f"dropout mask check failed: {res}")
    return res


def check_attention_bwd(torch, device, B, H, L, D, dtype, iters, rate, seed=4321,
                        causal=False, bias_dtype=None, lean=False):
    """The backward against autograd of the plain version (fp32) or the
    plain backward with the kernel's roundings (bf16); with ``causal``
    (the LM's bias, which needs a gradient) also dbias exactly 0 above the
    diagonal, where every probability is 0; every gradient in its input's
    type (dbias in the bias's: bf16 in a --bf16 run)."""
    import torch.nn.functional as F

    from unicore_tpu_torch.ops import attention_fullrow as fr

    q, k, v, do, bias, mask, attn_mask = attention_inputs(torch, device, B, H, L, D,
                                                          dtype, L + 1, causal, bias_dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]

    def public_grads():  # the training path: the autograd Function
        out = fr.fullrow_attention(*leaves[:3], bias=leaves[3], kv_padding_mask=mask,
                                   dropout_rate=rate, dropout_seed=seed)
        return torch.autograd.grad(out, leaves, do)

    name = (f"attention bwd B={B} H={H} L={L} D={D} {dtype} dropout={rate}"
            + (" causal" if causal else "") + f" bias {bias.dtype}")
    got = public_grads()
    got_dtypes = [g.dtype for g in got]
    if got_dtypes != [t.dtype for t in leaves]:
        raise AssertionError(f"{name}: gradient types {got_dtypes}, want their inputs'")
    masked_dbias_nonzero = None
    if causal:
        above = torch.triu(torch.ones(L, L, dtype=torch.bool, device=device), 1)
        masked_dbias_nonzero = int((got[3][:, :, above] != 0).sum())
        if masked_dbias_nonzero:
            raise AssertionError(f"{name}: dbias nonzero at {masked_dbias_nonzero} "
                                 "masked entries")
    if dtype == torch.bfloat16:
        # the plain backward with the kernel's roundings (autograd of the
        # plain forward rounds dp instead of pd and ds)
        args = (q, k, v, bias, mask, do, 1.0, rate, seed)
        ref = fr.fullrow_attention_bwd_plain(*args)
        slack = [*fr.bwd_rounding_slack(*args), 0.0]
        if device.type == "cpu":  # no kernel: the rehearsal holds it against itself
            got = ref
    else:
        ref = torch.autograd.grad(
            fr.fullrow_attention_plain(*leaves[:3], leaves[3], mask, 1.0, rate, seed),
            leaves, do)
        slack = [0.0] * 4
    pairs = list(zip(("dq", "dk", "dv", "dbias"), got, ref, slack))
    if device.type == "cuda":
        # the forward's output and row statistics, the backward's residuals
        o, lse = fr._launch_fwd(q, k, v, bias, mask, 1.0, rate, seed, True)
    if dtype == torch.bfloat16 and device.type == "cuda":
        # dk and dv as the kernel sums them in fp32, before their cast
        _, dk32, dv32, _ = fr._launch_bwd(q, k, v, bias, mask, o, do, lse, 1.0, rate, seed,
                                          True)
        pairs += [("dk_fp32", dk32, ref[1], slack[1]), ("dv_fp32", dv32, ref[2], slack[2])]
    errs, ratios = {}, {}
    for gname, g, r, s in pairs:
        errs[gname], ratios[gname] = grad_check(torch, f"{name}: {gname}", g, r,
                                                TOL["attention_grad"], s)
    # the backward kernels alone on the card (their two launches, with the
    # zeroed dbias they add into); the whole autograd backward on the CPU
    kernel = ((lambda: fr._launch_bwd(q, k, v, bias, mask, o, do, lse, 1.0, rate, seed,
                                      True))
              if device.type == "cuda" else public_grads)
    res = {"shape": [B, H, L, D], "dtype": dtype_name(dtype), "dropout": rate,
           "causal": causal, "bias_dtype": dtype_name(bias.dtype),
           "masked_dbias_nonzero": masked_dbias_nonzero,
           "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
           "max_err_over_tol": max(ratios.values()),
           "tolerance": grad_tolerance(TOL["attention_grad"], dtype)}
    timed(res, "ms", torch, kernel, device, iters)
    slow_iters = max(iters // 4, 2)
    timed(res, "plain_ms", torch, backward_call(
        torch, lambda: fr.fullrow_attention_plain(*leaves[:3], leaves[3], mask, 1.0,
                                                  rate, seed),
        leaves, do), device, slow_iters, lean=lean)
    lib_mask = attn_mask.clone().requires_grad_(True)
    timed(res, "library_ms", torch, backward_call(
        torch, lambda: F.scaled_dot_product_attention(
            *leaves[:3], attn_mask=lib_mask, scale=1.0, dropout_p=rate),
        leaves[:3] + [lib_mask], do), device, slow_iters)
    item = q.element_size()
    nbytes = (7 * B * H * L * D * item + 2 * bias.numel() * bias.element_size()
              + mask.numel() * 4)
    attention_bound(res, nbytes, 10 * B * H * L * L * D)
    log(f"{name}: {json.dumps(res)}")
    return res


def norm_inputs(torch, device, N, D, dtype, wdtype=None):
    """x, dy, weight and bias (in ``wdtype``, fp32 by default)."""
    g = torch.Generator(device=device).manual_seed(N + D)
    x = (torch.randn(N, D, generator=g, device=device) * 2 + 0.5).to(dtype)
    dy = torch.randn(N, D, generator=g, device=device).to(dtype)
    w = 1 + 0.1 * torch.randn(D, generator=g, device=device)
    b = 0.1 * torch.randn(D, generator=g, device=device)
    if wdtype is not None:
        w, b = w.to(wdtype), b.to(wdtype)
    return x, dy, w, b


def check_norm(torch, device, N, D, dtype, rms, iters, wdtype=None, lean=False):
    """The norm forward (#7) in its two forms against ``fused_norm_plain``:
    serving (no gradient: y alone) and training (the autograd Function,
    which also writes the fp32 row statistics); on the card the statistics
    within 1e-5 of ``fused_norm_stats_plain``, the same bits on a second
    call and one device operation a call.  Times of each form: per call
    (host included) and device ms warm and with the L2 flushed; the plain
    version; the library's forward (``F.layer_norm`` / ``F.rms_norm``),
    warm and flushed.  Bounds: x read, y written and w (b) read once; in
    training plus the statistics (8 bytes a row; RMSNorm 4, rstd alone,
    which is all its backward reads).  The serving form is the row's
    main entry; ``training`` holds the other."""
    import torch.nn.functional as F

    from unicore_tpu_torch.ops import fused_norm as fn

    x, _, w, b = norm_inputs(torch, device, N, D, dtype, wdtype)
    eps = 1e-6 if rms else 1e-5
    bb = None if rms else b
    name_fn = "fused_rms_norm" if rms else "fused_layer_norm"
    leaves = [t.clone().requires_grad_(True) for t in ((x, w) if rms else (x, w, b))]
    call = lambda: fn._fused_norm(x, w, bb, eps, rms)  # noqa: E731
    train = lambda: fn._fused_norm(leaves[0], leaves[1], None if rms else leaves[2],  # noqa: E731
                                   eps, rms)
    plain = lambda: fn.fused_norm_plain(x, w, bb, eps, rms)  # noqa: E731
    if rms:
        lib = (lambda: F.rms_norm(x, (D,), w.to(dtype), eps)) if hasattr(F, "rms_norm") else None  # noqa: E731
    else:
        lib = lambda: F.layer_norm(x, (D,), w.to(dtype), b.to(dtype), eps)  # noqa: E731
    ref = plain().float()
    y_train = train()
    err = max((call().float() - ref).abs().max().item(),
              (y_train.detach().float() - ref).abs().max().item())
    # the training forward's statistics against the fp32 plain ones, and
    # its bits on a second call
    stat_err, same_bits = 0.0, None
    if device.type == "cuda":
        got = fn._launch_fwd(x, w, bb, eps, rms, True, name_fn)
        again = fn._launch_fwd(x, w, bb, eps, rms, True, name_fn)
        same_bits = all(torch.equal(a, c) for a, c in zip(got, again))
        for s, r in zip(got[1:], fn.fused_norm_stats_plain(x, eps, rms)):
            err_s, scale = rel_err(s, r.reshape(-1))
            stat_err = max(stat_err, err_s / scale)
    tol = TOL["norm"][dtype_name(dtype)]
    name = f"{'rms' if rms else 'layer'}_norm fwd N={N} D={D} {dtype} weight {w.dtype}"
    if not (err <= tol and stat_err <= 1e-5 and math.isfinite(err) and same_bits is not False
            and y_train.requires_grad):
        raise AssertionError(f"{name}: kernel vs plain max abs err {err} (tol {tol}), "
                             f"statistics err {stat_err} (tol 1e-5), same bits twice "
                             f"{same_bits}")
    res = {"shape": [N, D], "dtype": dtype_name(dtype), "weight_dtype": dtype_name(w.dtype),
           "rms": rms, "max_abs_err": err, "tolerance": tol, "stats_rel_err": stat_err,
           "same_bits_twice": same_bits}
    training = {}
    timed(res, "ms", torch, call, device, iters)
    timed(training, "ms", torch, train, device, iters)
    timed(res, "plain_ms", torch, plain, device, iters, lean=lean)
    if lib is None:
        res["library_ms"] = res["library_ms_spread"] = res["library_device_ms"] = None
    else:
        timed(res, "library_ms", torch, lib, device, iters)
    if device.type == "cuda":
        flush = l2_flush(torch, device)
        for form, out, fwd in (("serving", res, call), ("training", training, train)):
            _, out["device_ops"] = device_profile(torch, fwd)
            out["device_ms_flushed"], _ = device_profile(torch, fwd, flush=flush)
            # one kernel a call and nothing beside it (CUPTI may drop an
            # event, never add one, so a short count is no failure)
            if out["device_ops"] is not None and out["device_ops"] > 1.0:
                raise AssertionError(f"{name}: {out['device_ops']} device operations a "
                                     f"{form} call, want one")
        if lib is not None and not lean:
            res["library_device_ms_flushed"], _ = device_profile(torch, lib, flush=flush)
    nbytes = 2 * N * D * x.element_size() + D * w.element_size() * (1 if rms else 2)
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 8 * N * D, "float32")
    training["bound_ms"], training["bound_by"] = bound_ms(nbytes + (4 if rms else 8) * N,
                                                          8 * N * D, "float32")
    for out in (res, training):
        for key in ("device_ms", "device_ms_flushed"):
            if out.get(key):
                out[f"bound_share_{key}"] = out["bound_ms"] / out[key]
    res["training"] = training
    log(f"{name}: {json.dumps(res)}")
    return res


def check_norm_bwd(torch, device, N, D, dtype, rms, iters, wdtype=None, lean=False):
    """The norm backward (#8 dx and #9 dw/db as one call: a pass
    over x and dy, then the partials' sum): through autograd against
    autograd of the plain forward, each gradient in its input's type (dw,
    db in the weight's); on the card also the kernel call alone against
    ``fused_norm_bwd_plain`` on the forward kernel's statistics, the same
    bits on a second call.  Times of that call: per call, device ms warm
    and with the L2 flushed, device operations a call; its plain version;
    the library's whole backward (``F.layer_norm`` / ``F.rms_norm``), warm
    and flushed.  Bound: x and dy read and dx written once, the fp32
    statistics the kernel reads (mean and rstd, 8 bytes a row; RMSNorm
    rstd alone, 4), w read and dw (db) written.  Returns the
    fused_norm_dx and fused_norm_dwdb rows, which share the call's times."""
    import torch.nn.functional as F

    from unicore_tpu_torch.ops import fused_norm as fn

    x, dy, w, b = norm_inputs(torch, device, N, D, dtype, wdtype)
    eps = 1e-6 if rms else 1e-5
    name_fn = "fused_rms_norm" if rms else "fused_layer_norm"
    name = f"norm bwd N={N} D={D} {dtype} weight {w.dtype} rms={rms}"
    bb = None if rms else b
    leaves = [t.clone().requires_grad_(True) for t in ((x, w) if rms else (x, w, b))]

    def plain_fwd():
        return fn.fused_norm_plain(leaves[0], leaves[1], None if rms else leaves[2], eps, rms)

    def public_grads():  # the training path: the autograd Function
        return torch.autograd.grad(
            fn._fused_norm(leaves[0], leaves[1], None if rms else leaves[2], eps, rms),
            leaves, dy)

    pairs = list(zip(("dx", "dw", "db"), public_grads(), torch.autograd.grad(plain_fwd(),
                                                                            leaves, dy)))
    if [g.dtype for _, g, _ in pairs] != [t.dtype for t in leaves]:
        raise AssertionError(f"{name}: gradient types {[g.dtype for _, g, _ in pairs]}, "
                             "want their inputs'")
    on_card = device.type == "cuda"
    if on_card:  # the kernel call alone, on the forward kernel's statistics
        _, mean, rstd = fn._launch_fwd(x, w, bb, eps, rms, True, name_fn)
        call = lambda: fn._launch_bwd(x, w, mean, rstd, dy, rms, not rms, True, True,  # noqa: E731
                                      name_fn)
        plain = lambda: fn.fused_norm_bwd_plain(x, w, mean, rstd, dy, rms, not rms)  # noqa: E731
        got, again = call(), call()
        same_bits = all(a is None or torch.equal(a, c) for a, c in zip(got, again))
        if not same_bits:
            raise AssertionError(f"{name}: two calls of the kernel differ")
        pairs += [(f"kernel_{n}", g, r) for n, g, r in zip(("dx", "dw", "db"), got, plain())
                  if r is not None]
    else:
        call = plain = public_grads
        same_bits = None
    errs, ratios = {}, {}
    for gname, g, r in pairs:
        errs[gname], ratios[gname] = grad_check(torch, f"{name}: {gname}", g, r,
                                                TOL["norm_grad"])
    shared = {"shape": [N, D], "dtype": dtype_name(dtype), "weight_dtype": dtype_name(w.dtype),
              "rms": rms, "same_bits_twice": same_bits,
              "launch": "fused_norm_bwd: one pass (dx, dw/db partials) + the partials' sum"}
    timed(shared, "ms", torch, call, device, iters)
    timed(shared, "plain_ms", torch, plain, device, iters, lean=lean)
    if rms and not hasattr(F, "rms_norm"):
        shared.update(library_ms=None, library_ms_spread=None, library_device_ms=None)
        lib_call = None
    else:
        lw = w.to(dtype).clone().requires_grad_(True)
        lb = b.to(dtype).clone().requires_grad_(True)
        lx = x.clone().requires_grad_(True)
        lib_call = backward_call(
            torch,
            (lambda: F.rms_norm(lx, (D,), lw, eps)) if rms else
            (lambda: F.layer_norm(lx, (D,), lw, lb, eps)),
            [lx, lw] if rms else [lx, lw, lb], dy)
        timed(shared, "library_ms", torch, lib_call, device, iters)
    if on_card:
        flush = l2_flush(torch, device)
        _, shared["device_ops"] = device_profile(torch, call)
        shared["device_ms_flushed"], _ = device_profile(torch, call, flush=flush)
        if lib_call is not None and not lean:
            shared["library_device_ms_flushed"], shared["library_device_ops"] = \
                device_profile(torch, lib_call, flush=flush)
    item, witem = x.element_size(), w.element_size()
    nbytes = 3 * N * D * item + (4 if rms else 8) * N + D * witem * (2 if rms else 3)
    shared["bound_ms"], shared["bound_by"] = bound_ms(nbytes, 12 * N * D, "float32")
    for key in ("device_ms", "device_ms_flushed"):
        if shared.get(key):
            shared[f"bound_share_{key}"] = shared["bound_ms"] / shared[key]
    out = {}
    for kname, gnames, other in (("fused_norm_dx", ["dx", "kernel_dx"], "fused_norm_dwdb"),
                                 ("fused_norm_dwdb", ["dw", "db", "kernel_dw", "kernel_db"],
                                  "fused_norm_dx")):
        gnames = [n for n in gnames if n in errs]
        out[kname] = dict(shared, fused_with=other,
                          max_abs_err=max(errs[n] for n in gnames),
                          max_abs_err_by_grad={n: errs[n] for n in gnames},
                          max_err_over_tol=max(ratios[n] for n in gnames),
                          tolerance=grad_tolerance(TOL["norm_grad"],
                                                   pairs[0][1].dtype if kname == "fused_norm_dx"
                                                   else w.dtype))
    log(f"{name}: {json.dumps(out['fused_norm_dx'])}")
    log(f"{name} dw/db errors: {json.dumps(out['fused_norm_dwdb']['max_abs_err_by_grad'])}")
    return out


def softmax_inputs(torch, device, c, dtype, seed):
    """x, mask, bias, dy for one softmax check ``c``: x ~ 2 N(0, 1) in
    ``dtype``; with ``neg_inf`` the last 40 columns -inf (padded keys, as
    Uni-Mol's pair bias holds them); a 0/-1e9 mask and an N(0, 1) bias,
    fp32, in the shapes the check names."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = (2 * torch.randn(c["shape"], generator=g, device=device)).to(dtype)
    if c.get("neg_inf"):
        x[..., -40:] = float("-inf")
    mask = bias = None
    if c.get("mask"):
        mask = torch.where(torch.rand(c["mask"], generator=g, device=device) < 0.2,
                           -1e9, 0.0)
    if c.get("bias"):
        bias = torch.randn(c["bias"], generator=g, device=device)
    dy = torch.randn(c["shape"], generator=g, device=device).to(dtype)
    return x, mask, bias, dy


def check_softmax(torch, device, c, dtype, iters, seed=1234, lean=False):
    """The softmax(+dropout) forward and backward kernels against
    ``softmax_dropout_plain`` (autograd for the backward in fp32; in bf16
    ``softmax_dropout_bwd_plain``, which keeps dp in fp32 as the kernel
    does), with every extra's gradient.  Returns (forward row, backward
    row)."""
    from unicore_tpu_torch.ops import softmax_dropout as sd

    rate = c["rate"]
    x, mask, bias, dy = softmax_inputs(torch, device, c, dtype, len(c["shape"]) + c["shape"][-1])
    extras = [t for t in (mask, bias) if t is not None]
    plans = [sd.plan_extra(tuple(t.shape), tuple(x.shape)) for t in extras]
    name = (f"softmax_dropout {tuple(c['shape'])} {dtype} rate={rate} mask="
            f"{c.get('mask')} bias={c.get('bias')} neg_inf={bool(c.get('neg_inf'))}")
    on_card = device.type == "cuda"
    fwd = sd.softmax_dropout_kernel if on_card else sd.softmax_dropout_plain

    def run(f):
        leaves = [t.clone().requires_grad_(True) for t in [x] + extras]
        it = iter(leaves[1:])
        m = next(it) if mask is not None else None
        b = next(it) if bias is not None else None
        out = f(leaves[0], rate, m, b, seed)
        return out.detach(), torch.autograd.grad(out, leaves, dy)

    out, grads = run(fwd)
    ref_out, ref_grads = run(sd.softmax_dropout_plain)
    tol = TOL["softmax"] + (BF16_ULPS * ref_out.float().abs() if dtype == torch.bfloat16 else 0.0)
    err_el = (out.float() - ref_out.float()).abs()
    err = err_el.max().item()
    zero_cols = (not c.get("neg_inf")) or out[..., -40:].abs().max().item() == 0.0
    if not (bool((err_el <= tol).all()) and math.isfinite(err) and zero_cols):
        raise AssertionError(f"{name}: forward max abs err {err}, -inf columns zero: "
                             f"{zero_cols}")
    if dtype == torch.bfloat16:
        ds = sd.softmax_dropout_bwd_plain(x, mask, bias, dy, rate, seed)
        ref_grads = [ds] + [sd._grad_reduce(ds, p, t) for p, t in zip(plans, extras)]
        if not on_card:  # no kernel: the rehearsal holds it against itself
            grads = ref_grads
    errs, ratios = {}, {}
    gnames = ["dx"] + ["dmask"] * (mask is not None) + ["dbias"] * (bias is not None)
    for gname, g, r in zip(gnames, grads, ref_grads):
        errs[gname], ratios[gname] = grad_check(torch, f"{name}: {gname}", g, r,
                                                TOL["softmax_grad"])
    base = {"shape": list(c["shape"]), "dtype": dtype_name(dtype), "dropout": rate,
            "mask": c.get("mask"), "bias": c.get("bias"),
            "neg_inf": bool(c.get("neg_inf"))}
    f_res = dict(base, max_abs_err=err,
                 tolerance=f"{TOL['softmax']}" + (f" + {BF16_ULPS} x |ref|"
                                                  if dtype == torch.bfloat16 else ""))
    b_res = dict(base, max_abs_err=max(errs.values()), max_abs_err_by_grad=errs,
                 max_err_over_tol=max(ratios.values()),
                 tolerance=grad_tolerance(TOL["softmax_grad"], dtype))
    n, item = x.numel(), x.element_size()
    extra_bytes = sum(t.numel() * t.element_size() for t in extras)

    def call_fwd():
        with torch.no_grad():
            return fwd(x, rate, mask, bias, seed)

    def call_plain():
        with torch.no_grad():
            return sd.softmax_dropout_plain(x, rate, mask, bias, seed)

    slow_iters = max(iters // 4, 2)
    timed(f_res, "ms", torch, call_fwd, device, iters)
    timed(f_res, "plain_ms", torch, call_plain, device, slow_iters, lean=lean)
    # no single PyTorch call takes softmax and dropout: torch.softmax at rate 0
    timed(f_res, "library_ms", torch, lambda: torch.softmax(x, -1), device, iters)
    f_res["bound_ms"], f_res["bound_by"] = bound_ms(2 * n * item + extra_bytes, 5 * n,
                                                    "float32")
    # the backward kernel alone on the card; the whole autograd backward on
    # the CPU
    all_plans = tuple(None if t is None else sd.plan_extra(tuple(t.shape), tuple(x.shape))
                      for t in (mask, bias))
    kernel_bwd = ((lambda: sd._launch_bwd(x, mask, bias, all_plans, dy, rate, seed))
                  if on_card else (lambda: run(sd.softmax_dropout_plain)))
    timed(b_res, "ms", torch, kernel_bwd, device, iters)
    leaves = [t.clone().requires_grad_(True) for t in [x] + extras]
    it = iter(leaves[1:])
    lm = next(it) if mask is not None else None
    lb = next(it) if bias is not None else None
    timed(b_res, "plain_ms", torch, backward_call(
        torch, lambda: sd.softmax_dropout_plain(leaves[0], rate, lm, lb, seed), leaves, dy),
        device, slow_iters, lean=lean)
    lx = x.clone().requires_grad_(True)
    timed(b_res, "library_ms", torch, backward_call(
        torch, lambda: torch.softmax(lx, -1), [lx], dy), device, slow_iters)
    b_res["bound_ms"], b_res["bound_by"] = bound_ms(2 * n * item + 4 * n + extra_bytes,
                                                    8 * n, "float32")
    log(f"{name} fwd: {json.dumps(f_res)}")
    log(f"{name} bwd: {json.dumps(b_res)}")
    return f_res, b_res


def check_softmax_mask(torch, device, R, M, L, rate, seed):
    """x = 0 makes every kept value 1/L scaled: the kernel's keep mask read
    off the card against ``philox_keep_plain(1, R, M, L)`` bit for bit, and
    its keep rate within 5 binomial sigmas of 1 - rate."""
    from unicore_tpu_torch.ops import attention_fullrow as fr
    from unicore_tpu_torch.ops import softmax_dropout as sd

    fwd = sd.softmax_dropout_kernel if device.type == "cuda" else sd.softmax_dropout_plain
    kernel_keep = fwd(torch.zeros(R, M, L, device=device), rate, seed=seed) != 0
    plain_keep = fr.philox_keep_plain(1, R, M, L, seed, rate, device=device).view(R, M, L)
    keep_rate = kernel_keep.float().mean().item()
    sigma = math.sqrt(rate * (1 - rate) / kernel_keep.numel())
    res = {"shape": [R, M, L], "mask_equal": bool(torch.equal(kernel_keep, plain_keep)),
           "keep_rate": keep_rate, "expected": 1 - rate, "sigma": sigma}
    log(f"softmax_dropout mask: {json.dumps(res)}")
    if not res["mask_equal"] or abs(keep_rate - (1 - rate)) > 5 * sigma:
        raise AssertionError(f"softmax_dropout mask check failed: {res}")
    return res


def flash_inputs(torch, device, c, dtype, seed):
    """q, k, v, do, the grouped bias, the key mask (its last row masks every
    key, as a padded residue's row does) and SDPA's float mask (bias
    expanded to the batch plus -inf at masked keys, no fully masked row:
    SDPA gives NaN there) for one flash check ``c``."""
    B, H, L, D = c["shape"]
    g = torch.Generator(device=device).manual_seed(seed)
    q = (torch.randn(B, H, L, D, generator=g, device=device) * D ** -0.5).to(dtype)
    k = torch.randn(B, H, L, D, generator=g, device=device).to(dtype)
    v = torch.randn(B, H, L, D, generator=g, device=device).to(dtype)
    do = torch.randn(B, H, L, D, generator=g, device=device).to(dtype)
    bias = None if c.get("bias") is None else torch.randn(c["bias"], generator=g, device=device)
    lens = torch.linspace(L, L // 3, B, device=device).long()
    lens[-1] = 0
    mask = (torch.arange(L, device=device)[None, :] >= lens[:, None]).to(torch.int32)
    lens[-1] = L // 3
    lib = torch.where(torch.arange(L, device=device)[None, :] >= lens[:, None],
                      float("-inf"), 0.0)[:, None, None, :]
    if bias is not None:
        if c.get("bias_dtype"):
            bias = bias.to(getattr(torch, c["bias_dtype"]))
        lib = lib + bias.float().repeat_interleave(B // bias.shape[0], dim=0)
    return q, k, v, do, bias, mask, lib.to(dtype)


def check_flash(torch, device, c, dtype, iters, seed=4321, lean=False):
    """The four flash kernels against ``flash_attention_plain``: the forward
    and its lse, then dq, dk, dv and dbias (fp32: against autograd of the
    plain version; bf16: against ``flash_attention_bwd_plain`` from the
    kernel's own output and lse, which rounds ds and the dropped p as the
    kernels do).  Returns {kernel name: result row}."""
    import torch.nn.functional as F

    from unicore_tpu_torch.ops import flash_attention as fa

    B, H, L, D = c["shape"]
    rate = c.get("rate", 0.0)
    q, k, v, do, bias, mask, lib = flash_inputs(torch, device, c, dtype, L + D)
    name = (f"flash {c['name']} B={B} H={H} L={L} D={D} bias={c.get('bias')} "
            f"{c.get('bias_dtype', 'float32')} {dtype} dropout={rate}")
    on_card = device.type == "cuda"
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias) if t is not None]
    lb = leaves[3] if bias is not None else None
    kw = dict(dropout_rate=rate, dropout_seed=seed)

    def public(*ls):
        return fa.flash_attention(ls[0], ls[1], ls[2], bias=ls[3] if len(ls) > 3 else None,
                                  kv_padding_mask=mask, **kw)

    def plain(*ls):
        return fa.flash_attention_plain(ls[0], ls[1], ls[2], ls[3] if len(ls) > 3 else None,
                                        mask, 1.0, rate, seed)

    out = public(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    if [g.dtype for g in got] != [t.dtype for t in leaves]:
        raise AssertionError(f"{name}: gradient types {[g.dtype for g in got]}, want their "
                             "inputs'")
    ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, bias, mask, 1.0, rate, seed)
    lse = fa._launch_fwd(q, k, v, bias, mask, 1.0, rate, seed)[1] if on_card else ref_lse
    err = (out.float() - ref_out.float()).abs().max().item()
    live = ref_lse > -1e29
    lse_err = (lse - ref_lse)[live].abs().max().item() if bool(live.any()) else 0.0
    zero_row = out[-1].abs().max().item() == 0.0 and got[0][-1].abs().max().item() == 0.0
    tol = TOL["attention"][dtype_name(dtype)]
    if not (err <= tol and lse_err <= 1e-4 and bool((lse[~live] <= -1e29).all())
            and zero_row and math.isfinite(err)):
        raise AssertionError(f"{name}: forward max abs err {err} (tol {tol}), lse err "
                             f"{lse_err} (tol 1e-4), fully masked row zero: {zero_row}")
    if dtype == torch.bfloat16:
        args = (q, k, v, bias, mask, out.detach(), lse, do, 1.0, rate, seed)
        ref = fa.flash_attention_bwd_plain(*args)
        slack = [*fa.bwd_rounding_slack(*args), 0.0]
        if not on_card:  # no kernel: the rehearsal holds it against itself
            got = ref
    else:
        ref = torch.autograd.grad(plain(*leaves), leaves, do)
        slack = [0.0] * 4
    errs, ratios = {}, {}
    for gname, g, r, s in zip(("dq", "dk", "dv", "dbias"), got, ref, slack):
        errs[gname], ratios[gname] = grad_check(torch, f"{name}: {gname}", g, r,
                                                TOL["attention_grad"], s)
    base = {"shape": [B, H, L, D], "bias": c.get("bias"), "dtype": dtype_name(dtype),
            "bias_dtype": None if bias is None else dtype_name(bias.dtype),
            "dropout": rate, "case": c["name"]}
    rows = {"flash_attention_fwd": dict(base, max_abs_err=err, lse_max_abs_err=lse_err,
                                        tolerance=tol)}
    for kname, gnames in (("flash_attention_dq", ["dq"]),
                          ("flash_attention_dkv", ["dk", "dv"]),
                          ("flash_attention_db", ["dbias"] if bias is not None else [])):
        if gnames:
            rows[kname] = dict(base, max_abs_err=max(errs[n] for n in gnames),
                               max_abs_err_by_grad={n: errs[n] for n in gnames},
                               max_err_over_tol=max(ratios[n] for n in gnames),
                               tolerance=grad_tolerance(TOL["attention_grad"], dtype))

    # times: the forward through the public call; each backward launch
    # alone on the card (the whole autograd backward on the CPU); plain and
    # library: the forward, and the whole backward for every backward row
    slow_iters = max(iters // 4, 2)
    f_res = rows["flash_attention_fwd"]
    timed(f_res, "ms", torch, lambda: public(q, k, v, *([bias] if bias is not None else [])),
          device, iters)
    timed(f_res, "plain_ms", torch, lambda: plain(q, k, v, *([bias] if bias is not None else [])),
          device, slow_iters, lean=lean)
    timed(f_res, "library_ms", torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=lib, scale=1.0, dropout_p=rate), device, iters)
    both = {}
    timed(both, "plain_ms", torch, backward_call(torch, lambda: plain(*leaves), leaves, do),
          device, slow_iters, lean=lean)
    lib_leaves = [t.clone().requires_grad_(True) for t in (q, k, v, lib)]
    timed(both, "library_ms", torch, backward_call(
        torch, lambda: F.scaled_dot_product_attention(*lib_leaves[:3], attn_mask=lib_leaves[3],
                                                      scale=1.0, dropout_p=rate),
        lib_leaves, do), device, slow_iters)
    # the backward is two launches: dq (with di), then dk/dv with dbias
    # from the same ds (#5 and #6 fused; its row and dbias's are one launch)
    o_det = out.detach()
    di = fa._launch_dq(q, k, v, bias, mask, lse, o_det, do, 1.0, rate, seed)[1] if on_card else None
    launch = {
        "flash_attention_dq": lambda: fa._launch_dq(q, k, v, bias, mask, lse, o_det, do, 1.0,
                                                    rate, seed),
        "flash_attention_dkv": lambda: fa._launch_dkv(q, k, v, bias, mask, lse, di, do, 1.0,
                                                      rate, seed, need_db=bias is not None),
    }
    # bounds: q, k, v, do, out read or written once (item bytes), lse and di
    # (4 bytes a row), the bias and the mask read once, dbias written once
    item, bhld, bhl = q.element_size(), B * H * L * D, B * H * L
    bias_bytes = 0 if bias is None else bias.numel() * bias.element_size()
    extra = bias_bytes + mask.numel() * 4
    prod = 2 * B * H * L * L * D  # operations of one (L x L) by D product
    attention_bound(f_res, 4 * bhld * item + 4 * bhl + extra, 2 * prod)
    sizes = {"flash_attention_dq": (6 * bhld * item + 8 * bhl + extra, 3 * prod),
             "flash_attention_dkv": (6 * bhld * item + 8 * bhl + extra + bias_bytes,
                                     4 * prod)}
    for kname in ("flash_attention_dq", "flash_attention_dkv"):
        res = rows[kname]
        call = (launch[kname] if on_card
                else (lambda: torch.autograd.grad(public(*leaves), leaves, do)))
        timed(res, "ms", torch, call, device, iters)
        res.update(both)
        attention_bound(res, *sizes[kname])
    dkv = rows["flash_attention_dkv"]
    if "flash_attention_db" in rows:
        dkv["fused_with"] = "flash_attention_db"
        rows["flash_attention_db"].update(
            {key: dkv[key] for key in dkv if key.startswith(("ms", "device_ms", "plain", "library",
                                                              "bound"))},
            fused_with="flash_attention_dkv")
    dq = rows["flash_attention_dq"]
    total = {"device_ms": (None if dq["device_ms"] is None or dkv["device_ms"] is None
                           else dq["device_ms"] + dkv["device_ms"]),
             "ms": dq["ms"] + dkv["ms"] if on_card else dq["ms"],  # CPU: one autograd backward
             "library_device_ms": both["library_device_ms"], "library_ms": both["library_ms"],
             "bound_ms": dq["bound_ms"] + dkv["bound_ms"],
             "launches": "dq (with di) + dk/dv" + ("/dbias" if bias is not None else "")}
    total["vs_library"] = (None if total["device_ms"] is None or not total["library_device_ms"]
                           else total["device_ms"] / total["library_device_ms"])
    for kname in ("flash_attention_dq", "flash_attention_dkv", "flash_attention_db"):
        if kname in rows:
            rows[kname]["flash_attention_bwd_total"] = total
    for kname, res in rows.items():
        log(f"{name} {kname}: {json.dumps(res)}")
    log(f"{name} flash_attention_bwd_total: {json.dumps(total)}")
    return rows


def check_flash_mask(torch, device, B, H, L, D, rate, seed):
    """q = k = 0 makes every kept probability 1/L scaled; v the one-hot
    columns c0 .. c0 + D - 1 makes the output those columns of the dropped
    probability row: the kernel's keep mask, read off the card in L / D
    calls, against ``philox_keep_plain`` bit for bit, and its keep rate
    within 5 binomial sigmas of 1 - rate."""
    from unicore_tpu_torch.ops import attention_fullrow as fr
    from unicore_tpu_torch.ops import flash_attention as fa

    z = torch.zeros(B, H, L, D, device=device)
    kernel_keep = torch.empty(B, H, L, L, dtype=torch.bool, device=device)
    for c0 in range(0, L, D):
        onehot = torch.zeros(L, D, device=device)
        onehot[c0:c0 + D] = torch.eye(D, device=device)
        out = fa.flash_attention(z, z, onehot.expand(B, H, L, D).contiguous(),
                                 dropout_rate=rate, dropout_seed=seed)
        kernel_keep[..., c0:c0 + D] = out != 0
    plain_keep = fr.philox_keep_plain(B, H, L, L, seed, rate, device=device)
    keep_rate = kernel_keep.float().mean().item()
    sigma = math.sqrt(rate * (1 - rate) / kernel_keep.numel())
    res = {"shape": [B, H, L, L], "mask_equal": bool(torch.equal(kernel_keep, plain_keep)),
           "keep_rate": keep_rate, "expected": 1 - rate, "sigma": sigma}
    log(f"flash dropout mask: {json.dumps(res)}")
    if not res["mask_equal"] or abs(keep_rate - (1 - rate)) > 5 * sigma:
        raise AssertionError(f"flash dropout mask check failed: {res}")
    return res


def decode_inputs(torch, device, c, seed):
    """q (B, H, D) pre-scaled, caches (B, H, L, D), positions, a bias row and,
    for int8 caches, their (H, D) scales.  Every position is L - 1 unless
    ``mixed`` (0 .. L - 1 over the batch, with junk past each position: K
    +1e6 / V -1e6, int8 +127 / -127).  Also the live rows over the batch.
    The caches are in q's type unless ``kv`` names theirs, the bias fp32
    unless ``bias`` names its type."""
    B, H, L, D = c["shape"]
    dtype = getattr(torch, c["dtype"])
    kv_dtype = getattr(torch, c.get("kv", c["dtype"]))
    g = torch.Generator(device=device).manual_seed(seed)
    q = (torch.randn(B, H, D, generator=g, device=device) * D ** -0.5).to(dtype)
    k = torch.randn(B, H, L, D, generator=g, device=device)
    v = torch.randn(B, H, L, D, generator=g, device=device)
    bias = torch.randn(B, H, L, generator=g, device=device)
    if c.get("neg_inf"):  # a chunk of -inf scores in the last (b, h): weight 0, not NaN
        bias[-1, -1, :min(32, L - 1)] = float("-inf")
    if c.get("mixed"):
        pos = torch.linspace(0, L - 1, B, device=device).to(torch.int32)
    else:
        pos = torch.full((B,), L - 1, dtype=torch.int32, device=device)
    live = torch.arange(L, device=device)[None, None, :, None] <= pos[:, None, None, None].long()
    scales = {}
    if c.get("int8"):
        ks = k.abs().amax(dim=(0, 2)) / 127.0 + 1e-8
        vs = v.abs().amax(dim=(0, 2)) / 127.0 + 1e-8
        k = torch.where(live, torch.round(k / ks[None, :, None]).clamp(-127, 127),
                        127.0).to(torch.int8)
        v = torch.where(live, torch.round(v / vs[None, :, None]).clamp(-127, 127),
                        -127.0).to(torch.int8)
        scales = {"k_scale": ks.contiguous(), "v_scale": vs.contiguous()}
    else:
        k = torch.where(live, k, 1e6).to(kv_dtype)
        v = torch.where(live, v, -1e6).to(kv_dtype)
    bias = bias.to(getattr(torch, c.get("bias", "float32")))
    return q, k, v, pos, bias, scales, int(pos.long().sum().item()) + B


def check_decode(torch, device, c, iters, seed=5150, lean=False):
    """The decode attention against ``decode_attention_plain`` on the same
    inputs.  Its library yardstick is one ``scaled_dot_product_attention``
    over the (B, H, 1, D) query with the bias row and the dead rows folded
    into a float mask (int8: the dequant multiplies, then SDPA -- no one
    PyTorch call fuses the dequant into the read; a bf16 q against fp32 or
    int8 caches goes to SDPA cast to fp32, the one type SDPA takes for all
    three).  The bound counts what the kernel must move: q and out, every
    live K and V row with its bias entry, the positions and the scales."""
    import torch.nn.functional as F

    from unicore_tpu_torch.ops import decode_attention as da

    B, H, L, D = c["shape"]
    q, k, v, pos, bias, scales, live_rows = decode_inputs(torch, device, c, seed)
    call = lambda: da.decode_attention(q, k, v, pos, bias=bias, **scales)  # noqa: E731
    plain = lambda: da.decode_attention_plain(q, k, v, pos, bias=bias, **scales)  # noqa: E731
    dead = torch.arange(L, device=device)[None, None, None, :] > pos.long()[:, None, None, None]
    # a bf16 q beside fp32 or int8 caches: SDPA in fp32 on the query cast
    lib_dtype = torch.float32 if "bias" in c else q.dtype
    mask = (bias.float()[:, :, None] + torch.where(dead, float("-inf"), 0.0)).to(lib_dtype)
    if scales:
        def lib():
            kf = (k.float() * scales["k_scale"][None, :, None]).to(lib_dtype)
            vf = (v.float() * scales["v_scale"][None, :, None]).to(lib_dtype)
            return F.scaled_dot_product_attention(q[:, :, None].to(lib_dtype), kf, vf,
                                                  attn_mask=mask, scale=1.0)
    else:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q[:, :, None].to(lib_dtype), k, v, attn_mask=mask, scale=1.0)
    out, ref = call(), plain()
    bitwise = None
    if c.get("repeat"):  # the split partials combine in a fixed order
        bitwise = bool(torch.equal(call(), out))
        if not bitwise:
            raise AssertionError(f"decode {c['name']}: two calls on the same inputs differ")
    err_t = (out.float() - ref.float()).abs()
    err = err_t.max().item()
    if q.dtype == torch.bfloat16:
        tol = f"{TOL['decode_bf16_ulps']} x |ref| + 1e-6"
        ok = bool((err_t <= TOL["decode_bf16_ulps"] * ref.float().abs() + 1e-6).all())
    else:
        tol = TOL["decode"]
        ok = err <= tol
    name = f"decode {c['name']} B={B} H={H} L={L} D={D} {c['dtype']}"
    if not (ok and math.isfinite(err) and out.float().abs().max().item() < 100):
        raise AssertionError(f"{name}: kernel vs plain max abs err {err} (tol {tol})")
    res = {"name": c["name"], "shape": [B, H, L, D], "dtype": c["dtype"],
           "kv": "int8" if scales else c.get("kv", c["dtype"]),
           "bias": c.get("bias", "float32"), "live_rows": live_rows,
           "splits": da.choose_splits(B * H, L), "max_abs_err": err, "tolerance": tol}
    if bitwise is not None:
        res["repeat_bitwise"] = bitwise
    timed(res, "ms", torch, call, device, iters)
    timed(res, "plain_ms", torch, plain, device, iters, lean=lean)
    timed(res, "library_ms", torch, lib, device, iters)
    nbytes = (2 * q.numel() * q.element_size() + 4 * B
              + live_rows * H * (2 * D * k.element_size() + bias.element_size())
              + 8 * H * D * bool(scales))
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 4 * live_rows * H * D, "float32")
    log(f"{name}: {json.dumps(res)}")
    return res


def check_quant_matmul(torch, device, c, iters, lean=False):
    """#13 against ``quant_matmul_plain`` at one BERT-base dense site: int8
    x (M, K) and w (N, K), the combined scale, the site's bias and
    activation; fp32 out within 1e-6 of its absmax.  Yardstick: one
    ``torch._int_mm`` (where it takes the shape) plus the epilogue in torch
    ops."""
    from unicore_tpu_torch.ops import quant_matmul as qm
    from unicore_tpu_torch.utils import get_activation_fn

    M, K, N, act = c["M"], c["K"], c["N"], c["act"]
    g = torch.Generator(device=device).manual_seed(M + K + N)
    x = torch.randint(-127, 128, (M, K), generator=g, device=device,
                      dtype=torch.int32).to(torch.int8)
    w = torch.randint(-127, 128, (N, K), generator=g, device=device,
                      dtype=torch.int32).to(torch.int8)
    scale = torch.rand(N, generator=g, device=device) * 2e-5 + 1e-5
    bias = torch.randn(N, generator=g, device=device) if c["bias"] else None
    on_card = device.type == "cuda"
    call = ((lambda: qm.quant_matmul_kernel(x, w, scale, bias, act)) if on_card
            else (lambda: qm.quant_matmul_plain(x, w, scale, bias, act)))
    plain = lambda: qm.quant_matmul_plain(x, w, scale, bias, act)  # noqa: E731
    fn = get_activation_fn(act) if act else (lambda t: t)

    def library():
        y = torch._int_mm(x, w.t()).float() * scale
        return fn(y + bias if bias is not None else y)

    ref = plain()
    err = (call() - ref).abs().max().item()
    tol = 1e-6 * ref.abs().max().item()
    name = f"quant_matmul {c['name']} M={M} K={K} N={N} act={act or 'linear'}"
    if not (err <= tol and math.isfinite(err)):
        raise AssertionError(f"{name}: kernel vs plain max abs err {err} (tol {tol})")
    res = {"site": c["name"], "shape": [M, K, N], "dtype": "int8", "activation": act,
           "bias": bool(c["bias"]), "tile": [qm.TILE_M, qm.choose_tile_n(M, N, K)],
           "max_abs_err": err, "tolerance": "1e-6 x max|ref|"}
    timed(res, "ms", torch, call, device, iters)
    timed(res, "plain_ms", torch, plain, device, max(iters // 4, 2), lean=lean)
    try:
        library()
        timed(res, "library_ms", torch, library, device, iters)
    except RuntimeError as err_lib:  # _int_mm refuses some shapes
        res["library_ms"] = res["library_ms_spread"] = res["library_device_ms"] = None
        res["library_refused"] = str(err_lib).splitlines()[0][:200]
    nbytes = M * K + N * K + 4 * N * (2 if bias is not None else 1) + 4 * M * N
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 2 * M * N * K, "int8")
    log(f"{name}: {json.dumps(res)}")
    log("quant_matmul_site " + json.dumps(
        {k: res[k] for k in ("site", "shape", "tile", "device_ms", "library_device_ms", "ms",
                             "library_ms", "bound_ms", "bound_by")}))
    return res


def check_quant_norm(torch, device, N, D, per_channel, iters, lean=False):
    """7q against ``quant_layer_norm_plain``: int8 (N, D) dequantized by one
    scale or (D,) of them; tolerance the fp32 norm's.  Yardstick: the
    dequant multiply and one ``F.layer_norm``.  On the card also device ms
    with the L2 flushed (the kernel's and the yardstick's) and the device
    operations a call."""
    import torch.nn.functional as F

    from unicore_tpu_torch.ops import fused_norm as fn

    g = torch.Generator(device=device).manual_seed(N + D)
    x = torch.randint(-127, 128, (N, D), generator=g, device=device,
                      dtype=torch.int32).to(torch.int8)
    scale = torch.rand(D if per_channel else (), generator=g, device=device) * 0.05 + 0.01
    w = 1 + 0.1 * torch.randn(D, generator=g, device=device)
    b = 0.1 * torch.randn(D, generator=g, device=device)
    call = ((lambda: fn.quant_layer_norm_kernel(x, scale, w, b)) if device.type == "cuda"
            else (lambda: fn.quant_layer_norm_plain(x, scale, w, b)))
    plain = lambda: fn.quant_layer_norm_plain(x, scale, w, b)  # noqa: E731
    library = lambda: F.layer_norm(x.float() * scale, (D,), w, b, 1e-5)  # noqa: E731
    err = (call() - plain()).abs().max().item()
    tol = TOL["norm"]["float32"]
    name = f"quant_layer_norm N={N} D={D} {'per-channel' if per_channel else 'scalar'} scale"
    if not (err <= tol and math.isfinite(err)):
        raise AssertionError(f"{name}: kernel vs plain max abs err {err} (tol {tol})")
    res = {"shape": [N, D], "dtype": "int8", "per_channel_scale": per_channel,
           "max_abs_err": err, "tolerance": tol}
    timed(res, "ms", torch, call, device, iters)
    timed(res, "plain_ms", torch, plain, device, iters, lean=lean)
    timed(res, "library_ms", torch, library, device, iters)
    if device.type == "cuda":
        flush = l2_flush(torch, device)
        _, res["device_ops"] = device_profile(torch, call)
        res["device_ms_flushed"], _ = device_profile(torch, call, flush=flush)
        if not lean:
            res["library_device_ms_flushed"], _ = device_profile(torch, library, flush=flush)
    nbytes = N * D + 4 * N * D + 4 * D * (3 if per_channel else 2)
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 9 * N * D, "float32")
    for key in ("device_ms", "device_ms_flushed"):
        if res.get(key):
            res[f"bound_share_{key}"] = res["bound_ms"] / res[key]
    log(f"{name}: {json.dumps(res)}")
    return res


def check_quant_softmax(torch, device, c, iters, lean=False):
    """10q against ``quant_softmax_dropout_plain``: int32 (or int8) scores of
    BERT serving, one device scale, the ``finfo.min`` key mask of padded
    rows (B, 1, 1, L) and the rel-pos bias (1, H, L, L); tolerance the fp32
    softmax's.  Yardstick: the dequant multiply, the adds and one
    ``torch.softmax``."""
    from unicore_tpu_torch.ops import quant_softmax_dropout as qsd
    from unicore_tpu_torch.ops import softmax_dropout as sd

    shape, dtype = tuple(c["shape"]), getattr(torch, c["dtype"])
    B, H, Lq, L = shape
    g = torch.Generator(device=device).manual_seed(L + len(c["dtype"]))
    hi = 128 if dtype == torch.int8 else 200_000
    x = torch.randint(-hi + 1, hi, shape, generator=g, device=device,
                      dtype=torch.int32).to(dtype)
    scale = torch.tensor(3.0 / hi, device=device)
    lens = torch.linspace(L, L // 4, B, device=device).long()
    mask = ((torch.arange(L, device=device)[None, :] >= lens[:, None]).float()
            * torch.finfo(torch.float32).min)[:, None, None, :]
    bias = torch.randn(1, H, Lq, L, generator=g, device=device)
    call = ((lambda: sd.quant_softmax_dropout_kernel(x, scale, 0.0, mask, bias))
            if device.type == "cuda"
            else (lambda: qsd.quant_softmax_dropout_plain(x, scale, 0.0, mask, bias)))
    plain = lambda: qsd.quant_softmax_dropout_plain(x, scale, 0.0, mask, bias)  # noqa: E731
    library = lambda: torch.softmax(x.float() * scale + mask + bias, -1)  # noqa: E731
    err = (call() - plain()).abs().max().item()
    tol = TOL["softmax"]
    name = f"quant_softmax_dropout {shape} {c['dtype']}"
    if not (err <= tol and math.isfinite(err)):
        raise AssertionError(f"{name}: kernel vs plain max abs err {err} (tol {tol})")
    res = {"shape": list(shape), "dtype": c["dtype"], "mask": list(mask.shape),
           "bias": list(bias.shape), "max_abs_err": err, "tolerance": tol}
    timed(res, "ms", torch, call, device, iters)
    timed(res, "plain_ms", torch, plain, device, max(iters // 4, 2), lean=lean)
    timed(res, "library_ms", torch, library, device, max(iters // 4, 2))
    n = x.numel()
    nbytes = n * x.element_size() + 4 * n + 4 * (mask.numel() + bias.numel())
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 6 * n, "float32")
    log(f"{name}: {json.dumps(res)}")
    return res


def _bits_equal(torch, a, b):
    if a is None:
        return True
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return bool(torch.equal(a.view(view), b.view(view)))


def check_l2norm(torch, device, n, iters, lean=False):
    """K-a (``multi_tensor_l2norm``) on an fp32 buffer of ``n`` elements,
    each divided by a device scalar inside the reduction, against its plain
    version and ``torch.linalg.vector_norm`` of the divided buffer (1e-6
    relative), and the same bits on a second call.  Yardstick:
    ``vector_norm`` of the buffer, one PyTorch call."""
    from unicore_tpu_torch.optim import multi_tensor as mt

    g = torch.Generator(device=device).manual_seed(n)
    x = torch.randn(n, generator=g, device=device) * 1e-3
    denom = torch.tensor(3.0, device=device)
    call = lambda: mt.multi_tensor_l2norm([x], denom)  # noqa: E731
    plain = lambda: mt.multi_tensor_l2norm_plain([x], denom)  # noqa: E731
    lib = lambda: torch.linalg.vector_norm(x)  # noqa: E731
    got, again = call(), call()
    ref = torch.linalg.vector_norm(x / denom)
    rel = abs(float(got) - float(ref)) / float(ref)
    res = {"shape": [n], "dtype": "float32", "max_abs_err": abs(float(got) - float(plain())),
           "rel_err_vs_vector_norm": rel, "tolerance": 1e-6,
           "same_bits_twice": _bits_equal(torch, got, again)}
    if not (rel <= 1e-6 and res["same_bits_twice"]):
        raise AssertionError(f"multi_tensor_l2norm n={n}: {res}")
    if n >= 1_000_000 or device.type != "cuda":
        iters = min(iters, 20)
        timed(res, "ms", torch, call, device, iters)
        timed(res, "plain_ms", torch, plain, device, iters, lean=lean)
        timed(res, "library_ms", torch, lib, device, iters)
    res["bound_ms"], res["bound_by"] = bound_ms(4 * n, 2 * n, "float32")
    if n >= 1_000_000 or (device.type != "cuda" and n > 1):
        res["segments"] = check_l2norm_segments(torch, device, x, denom, got, iters)
    log(f"multi_tensor_l2norm n={n}: {json.dumps(res)}")
    return res


def check_l2norm_segments(torch, device, x, denom, whole, iters):
    """K-a's ZeRO mode on ``x`` cut as two ranks' segments (padded to
    2 * NORM_SPAN): each segment's partials (the sum-of-squares mode), in
    rank order, cut to the whole buffer's count, then stage 2 alone -- the
    bits of ``whole`` (K-a on ``x``); the plain versions the same way give
    the plain whole's bits.  Times: one segment's partials, stage 2 alone."""
    from unicore_tpu_torch.optim import multi_tensor as mt

    n = x.numel()
    padded = mt.pad_to(x, 2 * mt.NORM_SPAN)
    half = padded.numel() // 2
    segs = [padded[:half], padded[half:]]
    keep = mt.norm_partials(n)
    parts = torch.cat([mt.l2norm_partials([s], denom) for s in segs])[:keep]
    got = mt.l2norm_final(parts)
    plain_parts = torch.cat([mt.l2norm_partials_plain([s], denom) for s in segs])[:keep]
    plain = mt.l2norm_final_plain(plain_parts)
    res = {"segments": [half, half], "partials": keep, "tolerance": "bit for bit",
           "bit_equal_whole": _bits_equal(torch, got, whole),
           "plain_bit_equal_plain_whole": _bits_equal(
               torch, plain, mt.multi_tensor_l2norm_plain([x], denom)),
           "max_abs_err": abs(float(got) - float(plain))}
    if not (res["bit_equal_whole"] and res["plain_bit_equal_plain_whole"]):
        raise AssertionError(f"multi_tensor_l2norm segments n={n}: {res}")
    if n >= 100_000_000 or device.type != "cuda":
        iters = min(iters, 20)
        timed(res, "ms", torch, lambda: mt.l2norm_partials([segs[0]], denom), device, iters)
        timed(res, "final_ms", torch, lambda: mt.l2norm_final(parts), device, iters)
        res["bound_ms"], res["bound_by"] = bound_ms(4 * half, 2 * half, "float32")
    return res


def check_fused_adam(torch, device, n, kind, iters, lean=False):
    """K-b (``fused_adam``) on a flat group of ``n`` elements -- two
    segments, the first decayed, the clip read from K-a's norm, the
    gradient divided by a device scalar -- with fp32 parameters (the master
    is the parameters), bf16 parameters rounded to nearest even, or bf16
    under SR: m, v, the master and the parameters bit for bit against
    ``fused_adam_plain``.  Yardstick: the per-tensor path's torch calls for
    the same function (divide, clip, the ``_foreach`` Adam, the
    copy-back)."""
    from unicore_tpu_torch.ops.rounding import fp32_to_bf16_sr
    from unicore_tpu_torch.optim import multi_tensor as mt

    g = torch.Generator(device=device).manual_seed(n + len(kind))
    master = torch.randn(n, generator=g, device=device)
    m = torch.randn(n, generator=g, device=device) * 1e-3
    v = torch.rand(n, generator=g, device=device) * 1e-6
    grad = torch.randn(n, generator=g, device=device) * 1e-3
    param = None if kind == "float32" else master.to(torch.bfloat16)
    half = (n // 2) // mt.ALIGN * mt.ALIGN
    segs = [(0, half, True), (half, n - half, False)] if half else [(0, n, True)]
    step_size = float(torch.tensor(1e-4) * torch.tensor(0.99).sqrt() / 0.9)
    decay = float(torch.tensor(1.0) - torch.tensor(step_size) * torch.tensor(0.01))
    hp = mt.AdamHyper(0.9, 0.98, 1e-6, step_size, 0.01, decay)
    denom = torch.tensor(3.0, device=device)
    gnorm = mt.multi_tensor_l2norm([grad], denom)
    sr_key = (0x1234567, 0x89) if kind == "bfloat16_sr" else None
    chunks = mt.chunk_table(segs, device)
    kw = dict(denom=denom, gnorm=gnorm, max_norm=1.0, sr_key=sr_key, buffer_id=1)
    got = [t.clone() if t is not None else None for t in (master, m, v, param)]
    ref = [t.clone() if t is not None else None for t in (master, m, v, param)]
    if device.type == "cuda":
        mt.fused_adam(got[0], got[1], got[2], grad, chunks, hp, got[3], **kw)
    else:
        mt.fused_adam_plain(got[0], got[1], got[2], grad, segs, hp, got[3], **kw)
    mt.fused_adam_plain(ref[0], ref[1], ref[2], grad, segs, hp, ref[3], **kw)
    same = [_bits_equal(torch, a, b) for a, b in zip(got, ref)]
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref)
              if a is not None)
    coef = float(mt.clip_coef(gnorm, 1.0))
    res = {"shape": [n], "dtype": kind, "max_abs_err": err, "tolerance": "bit for bit",
           "bit_equal_master_m_v_param": same, "clip_coef": coef}
    if not all(same):
        raise AssertionError(f"fused_adam n={n} {kind}: {res}")
    if n >= 1_000_000 or device.type != "cuda":
        bufs = [t.clone() if t is not None else None for t in (master, m, v, param)]
        gen = torch.Generator(device=device).manual_seed(3)

        def foreach_path():
            g2 = grad / denom
            g2.mul_(mt.clip_coef(gnorm, 1.0))
            mt.adam_elementwise([bufs[0]], [g2], [bufs[1]], [bufs[2]], hp, [True])
            if bufs[3] is not None:
                bufs[3].copy_(fp32_to_bf16_sr(bufs[0], gen) if sr_key else bufs[0])

        iters = min(iters, 20)
        call = (lambda: mt.fused_adam(bufs[0], bufs[1], bufs[2], grad, chunks, hp, bufs[3],
                                      **kw)) if device.type == "cuda" else foreach_path
        plain = lambda: mt.fused_adam_plain(bufs[0], bufs[1], bufs[2], grad, segs, hp,  # noqa
                                            bufs[3], **kw)
        timed(res, "ms", torch, call, device, iters)
        if lean and too_slow(torch, plain, device):
            res["plain_ms"] = res["plain_ms_spread"] = res["plain_device_ms"] = None
        else:
            res["plain_ms"], res["plain_ms_spread"] = time_ms(torch, plain, device, 2, 1, 3)
            res["plain_device_ms"] = (device_ms(torch, plain, 2) if device.type == "cuda"
                                      else None)
        timed(res, "library_ms", torch, foreach_path, device, iters)
    # g read; m, v, master read and written; a bf16 parameter written
    nbytes = n * (4 + 8 + 8 + 8 + (2 if param is not None else 0))
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 20 * n, "float32")
    if n >= 1_000_000 or (device.type != "cuda" and n > 1):
        res["segments"] = check_fused_adam_segments(
            torch, device, (master, m, v, param, grad), got, segs, hp, kw, iters)
    log(f"fused_adam n={n} {kind}: {json.dumps(res)}")
    return res


def check_fused_adam_segments(torch, device, inputs, whole, segs, hp, kw, iters):
    """K-b's ZeRO mode: the group of ``segs`` padded to 2 * NORM_SPAN and cut
    as two ranks' segments, K-b on each (its offset, the clipped chunk
    table) -- the bits of ``whole`` (K-b on the whole buffer) in m, v, the
    master and the parameters, SR included -- and each segment against its
    plain version, bit for bit.  Time: one segment's call."""
    from unicore_tpu_torch.optim import multi_tensor as mt

    master, m, v, param, grad = inputs
    n = master.numel()
    group = mt.FlatGroup(torch.float32, [mt.Segment(f"s{i}", a, size, (size,), d)
                                         for i, (a, size, d) in enumerate(segs)],
                         n, -(-n // (2 * mt.NORM_SPAN)) * 2 * mt.NORM_SPAN)
    half = group.padded // 2
    pad = [mt.pad_to(t, group.padded) if t is not None else None
           for t in (master, m, v, param, grad)]
    got = [t.clone() if t is not None else None for t in pad[:4]]
    ref = [t.clone() if t is not None else None for t in pad[:4]]

    def seg(ts, a):
        return [t[a:a + half] if t is not None else None for t in ts]

    for a in (0, half):
        g, r = seg(got, a), seg(ref, a)
        mt.adam_group(g[0], g[1], g[2], pad[4][a:a + half], group, hp, g[3], offset=a, **kw)
        mt.fused_adam_plain(r[0], r[1], r[2], pad[4][a:a + half], group.clipped(a, half), hp,
                            r[3], offset=a, **kw)
    same_whole = [_bits_equal(torch, a[:n] if a is not None else None, b)
                  for a, b in zip(got, whole)]
    same_plain = [_bits_equal(torch, a, b) for a, b in zip(got, ref)]
    res = {"segments": [half, half], "tolerance": "bit for bit",
           "bit_equal_whole_master_m_v_param": same_whole,
           "bit_equal_plain_master_m_v_param": same_plain,
           "max_abs_err": max(float((a.float() - b.float()).abs().max())
                              for a, b in zip(got, ref) if a is not None)}
    if not (all(same_whole) and all(same_plain)):
        raise AssertionError(f"fused_adam segments n={n}: {res}")
    if n >= 100_000_000 or device.type != "cuda":
        g = seg(got, 0)
        timed(res, "ms", torch, lambda: mt.adam_group(g[0], g[1], g[2], pad[4][:half], group,
                                                        hp, g[3], offset=0, **kw),
              device, min(iters, 20))
        nbytes = half * (4 + 8 + 8 + 8 + (2 if param is not None else 0))
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 20 * half, "float32")
    return res


# ---------------------------------------------------------------------------
# phase 4a: training through the train CLI's main
# ---------------------------------------------------------------------------

def fresh_dir(path):
    """``path`` emptied: the train CLI resumes from a ``checkpoint_last.pt``
    it finds in its ``--save-dir``."""
    import shutil

    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def write_split(cfg, data, split, docs, seed):
    """An indexed split of ``docs`` documents drawn from ``seed``."""
    import numpy as np

    from unicore_tpu_torch.data import make_builder

    words = [f"w{i}" for i in range(cfg["symbols"])]
    rng = np.random.default_rng(seed)
    # Zipf-like word frequencies, as in text, so a few updates can learn them
    freq = 1.0 / np.arange(10, len(words) + 10)
    builder = make_builder(str(data / split))
    lo, hi = cfg["doc_words"]
    for _ in range(docs):
        n = int(rng.integers(lo, hi + 1))
        picks = rng.choice(len(words), size=n, p=freq / freq.sum())
        builder.add_item(" ".join(words[i] for i in picks))
    builder.finalize()


def write_corpus(cfg):
    """dict.txt (one symbol per line, as WordPiece reads it) and an indexed
    train split of documents drawn from a seed (no valid split: phase 9
    writes it, after the BERT phases)."""
    data = fresh_dir(WORK / "data")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        f"w{i}" for i in range(cfg["symbols"])]
    (data / "dict.txt").write_text("\n".join(vocab) + "\n")
    write_split(cfg, data, "train", cfg["docs"], cfg["seed"])
    return data


def train_argv(cfg, data, save_dir, device):
    t = cfg["train"]
    return [
        str(data), "--device", device, "--task", "bert", "--loss", "masked_lm",
        "--arch", cfg["arch"], "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)",
        "--adam-eps", "1e-6", "--weight-decay", "1e-4", "--clip-norm", "1.0",
        "--lr-scheduler", "polynomial_decay", "--lr", str(t["lr"]),
        "--warmup-updates", str(t["warmup"]), "--total-num-update", str(t["updates"]),
        "--max-update", str(t["updates"]), "--batch-size", str(cfg["batch"]),
        "--update-freq", str(t["update_freq"]), "--seq-pad-multiple", "128",
        "--log-interval", "1", "--log-format", "simple", "--num-workers", "0",
        "--save-dir", str(save_dir), "--seed", str(cfg["seed"] + 1),
    ]


def train_in_process(log_path, argv):
    """The train CLI's ``main`` on ``argv`` in this process: no interpreter,
    torch import or CUDA context of its own (what a start-up costs, ~11 s a
    run on the card), the run's log and ``TRAIN stats`` line written to
    ``log_path``.  Its peak memory counts what this process still holds.
    Raises what the run raises."""
    import contextlib
    import gc
    import logging

    import torch

    from unicore_tpu_torch import options
    from unicore_tpu_torch.cli import train as cli
    from unicore_tpu_torch.cli.serve import resolve_device

    args = options.parse_args_and_arch(options.get_training_parser(), argv)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    root = logging.getLogger()
    level = root.level
    with open(log_path, "w") as f:
        handler = logging.StreamHandler(f)
        handler.setFormatter(logging.Formatter(" | ".join(f"%({x})s" for x in cli._LOG_FIELDS)))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        try:
            with contextlib.redirect_stdout(f):
                cli.main(args, resolve_device(args.device))
        finally:
            root.removeHandler(handler)
            root.setLevel(level)
            # the run's suspended loaders (their threads) go with it
            gc.collect()


def run_train_cli(tag, argv, device, t, timeout_s, falling=True,
                  launcher=("-m", "unicore_tpu_torch.cli.train"), in_process=False,
                  watch=None):
    """``python -m unicore_tpu_torch.cli.train`` with ``argv`` (or
    ``python`` + ``launcher`` + ``argv``; with ``in_process`` the CLI's
    ``main`` in this process, :func:`train_in_process`; ``watch`` is
    called every 0.2 s while the process runs): its stats line,
    checked -- the update count, every loss finite, the mean of the last
    five below the first five (``falling``), and the launches per
    micro-batch (``t["per_micro_batch"]``; none at all on the CPU
    rehearsal)."""
    log_path = WORK / f"{tag}.log"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.monotonic()
    if in_process:
        try:
            train_in_process(log_path, argv)
        except Exception as err:
            raise RuntimeError(f"{tag}: the train CLI's main raised {err!r}:\n"
                               f"{log_path.read_text()[-6000:]}") from err
        text = log_path.read_text()
    else:
        with open(log_path, "w") as f:
            proc = subprocess.Popen([sys.executable, *launcher, *argv],
                                    stdout=f, stderr=subprocess.STDOUT, cwd=str(ROOT),
                                    env=env)
            try:
                while proc.poll() is None:
                    if time.monotonic() - t0 > timeout_s:
                        raise RuntimeError(f"{tag}: train CLI over its {timeout_s} s")
                    if watch is not None:
                        watch()
                    time.sleep(0.2)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        text = log_path.read_text()
        if proc.returncode != 0:
            raise RuntimeError(f"{tag}: train CLI exited {proc.returncode}:\n{text[-6000:]}")
    lines = [ln for ln in text.splitlines() if ln.startswith("TRAIN stats ")]
    if not lines:
        raise AssertionError(f"{tag}: no TRAIN stats line:\n{text[-6000:]}")
    stats = json.loads(lines[-1][len("TRAIN stats "):])
    for ln in text.splitlines():
        if "| train_inner | " in ln or "| train | " in ln:
            log(f"{tag} " + ln.split(" | ", 3)[-1])
    losses = stats["loss_per_update"]
    micro = stats["micro_batches"]
    launches = stats["kernel_launches"]
    want = t["per_micro_batch"]
    log(f"{tag}: {stats['updates']} updates, {micro} micro-batches in "
        f"{time.monotonic() - t0:.1f}s; launches {launches} (want per "
        f"micro-batch {want})")
    if stats["updates"] != t["updates"]:
        raise AssertionError(f"{tag}: {stats['updates']} updates, want {t['updates']}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: non-finite loss: {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if falling and not last < first:
        raise AssertionError(f"{tag}: loss did not fall: first 5 mean {first}, "
                             f"last 5 mean {last}")
    if device.type == "cuda":
        for k, n in want.items():
            if launches.get(k) != n * micro:
                raise AssertionError(f"{tag}: {k}: {launches.get(k)} launches for "
                                     f"{micro} micro-batches, want {n} per micro-batch")
    elif sum(launches.values()):
        raise AssertionError(f"{tag}: the CPU rehearsal launched kernels: {launches}")
    stats["loss_first5_mean"], stats["loss_last5_mean"] = first, last
    return stats


def drive_training(torch, cfg, data, card, smi):
    save_dir = fresh_dir(WORK / "train_ckpt")
    t = cfg["train"]
    stats = run_train_cli("train", train_argv(cfg, data, save_dir, cfg["device"].type),
                          cfg["device"], t, t["timeout_s"], in_process=True)
    train = {
        "arch": cfg["arch"], "updates": stats["updates"],
        "micro_batches": stats["micro_batches"], "batch": cfg["batch"],
        "update_freq": t["update_freq"],
        "loss_first5_mean": stats["loss_first5_mean"],
        "loss_last5_mean": stats["loss_last5_mean"],
        "median_step_ms": stats["median_step_ms"], "tokens_per_s": stats["tokens_per_s"],
        "tokens": stats["tokens"], "peak_memory_bytes": stats["peak_memory_bytes"],
        "step_ms": stats["step_ms"], "card": card, "nvidia_smi": smi,
    }
    print("train " + json.dumps(train), flush=True)
    if cfg["device"].type == "cuda":
        profile_cli_update(torch, cfg, train_argv(cfg, data, WORK / "unused", "cuda"),
                           "bert_profile", card, smi)
    return save_dir / "checkpoint_last.pt", stats


# ---------------------------------------------------------------------------
# phase 4b: one training path on the card against the CPU
# ---------------------------------------------------------------------------

def bert_card_vs_cpu_setup(torch, cfg, data, *flags, batch=None, attention_dropout=0.1):
    """4b's path with ``flags`` added to its arguments (and ``batch`` rows a
    micro-batch, ``attention_dropout``, where given): (args, task, model,
    loss, the micro-batches of each update).  Without Adam (``--optimizer
    sgd``) the Adam flags of 4a's arguments are dropped."""
    import numpy as np

    from unicore_tpu_torch import options
    from unicore_tpu_torch.losses import LOSS_REGISTRY
    from unicore_tpu_torch.models.bert import BertModel
    from unicore_tpu_torch.tasks.bert import BertTask

    c = cfg["card_vs_cpu"]
    argv = train_argv(cfg, data, WORK / "unused", "cpu")
    if "--optimizer" in flags:
        for name in ("--adam-betas", "--adam-eps"):
            i = argv.index(name)
            del argv[i:i + 2]
    args = options.parse_args_and_arch(
        options.get_training_parser(),
        argv + ["--update-freq", "2", "--max-update", str(c["updates"]),
                "--total-num-update", str(c["updates"]), "--warmup-updates", "1", *flags])
    task = BertTask.setup_task(args)
    vocab, pad = len(task.dictionary), task.dictionary.pad()
    model = BertModel(
        vocab_size=vocab, padding_idx=pad, encoder_layers=2,
        encoder_embed_dim=args.encoder_embed_dim,
        encoder_ffn_embed_dim=args.encoder_ffn_embed_dim,
        encoder_attention_heads=args.encoder_attention_heads,
        max_seq_len=args.max_seq_len, dropout=0.0, emb_dropout=0.0,
        attention_dropout=attention_dropout, generator=torch.Generator().manual_seed(7))
    rng = np.random.default_rng(11)
    B, L = batch or cfg["batch"], c["seq_len"]
    samples = []
    for _ in range(2 * c["updates"]):
        lens = rng.integers(L // 2, L + 1, B)
        src = rng.integers(5, vocab, (B, L))
        src[np.arange(L)[None, :] >= lens[:, None]] = pad
        tgt = np.where((rng.random((B, L)) < 0.15) & (src != pad), src, pad)
        samples.append({"net_input": {"src_tokens": src}, "target": tgt})
    groups = [samples[2 * i:2 * i + 2] for i in range(c["updates"])]
    return args, task, model, LOSS_REGISTRY["masked_lm"](task), groups


def drive_card_vs_cpu(torch, cfg, data, *flags, tag="card vs CPU", need=None, **setup):
    """4b (and, with ``flags``, phase 11's variants of it): the 2-layer
    BERT-base path trained on the card and on the CPU from the same weights
    and batches; loss 1e-4 and gradient norm 1e-3 relative, parameters 1e-5
    absolute, every kernel of ``need`` (4a's by default) launched on the
    card and none on the CPU."""
    import copy

    from unicore_tpu_torch.ops import _kernels
    from unicore_tpu_torch.trainer import Trainer

    c = cfg["card_vs_cpu"]
    args, task, model, loss, groups = bert_card_vs_cpu_setup(torch, cfg, data, *flags, **setup)

    def run(device):
        tr = Trainer(args, task, copy.deepcopy(model), loss, device)
        tr.begin_epoch(1)
        gnorms = [tr.train_step(group) for group in groups]
        params = {n: p.detach().cpu() for n, p in tr.model.named_parameters()}
        return tr.update_losses, gnorms, params

    _kernels.reset_launch_counts()
    card = run(cfg["device"])
    card_launches = _kernels.launch_counts()
    _kernels.reset_launch_counts()
    cpu = run(torch.device("cpu"))
    cpu_launches = _kernels.launch_counts()
    res = {"losses_card": card[0], "losses_cpu": cpu[0], "gnorm_card": card[1],
           "gnorm_cpu": cpu[1], "card_launches": card_launches}
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
    gnorm_rel = max(abs(a - b) / abs(b) for a, b in zip(card[1], cpu[1]))
    param_err = max((card[2][n] - cpu[2][n]).abs().max().item() for n in cpu[2])
    param_tol = c["param_tol"]
    res.update(loss_rel=loss_rel, gnorm_rel=gnorm_rel, param_max_abs_diff=param_err,
               param_tol=param_tol)
    log(f"{tag}: {json.dumps(res)}")
    if sum(cpu_launches.values()):
        raise AssertionError(f"the CPU run launched kernels: {cpu_launches}")
    need = need or [k for k, v in KERNELS.items() if v[2] == "train"]
    if cfg["device"].type == "cuda" and not all(card_launches.get(k, 0) > 0 for k in need):
        raise AssertionError(f"{tag}: the card run missed a kernel: {card_launches}")
    if not (loss_rel <= 1e-4 and gnorm_rel <= 1e-3 and param_err <= param_tol):
        raise AssertionError(f"card and CPU disagree: loss {loss_rel} (1e-4 rel), "
                             f"gnorm {gnorm_rel} (1e-3 rel), params {param_err} "
                             f"({param_tol} abs)")
    return res


# ---------------------------------------------------------------------------
# phases 5a and 5b: Uni-Mol training
# ---------------------------------------------------------------------------

ATOMS = ["C", "N", "O", "S", "H", "F", "Cl", "Br", "P"]


def write_conformers(u):
    """dict.txt (the Uni-Mol example's atom symbols) and an indexed train
    split of conformers drawn from a seed: ``u["atoms"]`` atoms each, with
    the example's element frequencies, at Gaussian positions (4 A spread)
    as in a protein pocket."""
    import numpy as np

    from unicore_tpu_torch.data import make_builder

    data = WORK / "unimol_data"
    data.mkdir(parents=True, exist_ok=True)
    (data / "dict.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + ATOMS)
                                  + "\n")
    rng = np.random.default_rng(u["seed"])
    p = np.asarray([0.4, 0.1, 0.12, 0.03, 0.25, 0.04, 0.03, 0.01, 0.02])
    builder = make_builder(str(data / "train"))
    lo, hi = u["atoms"]
    for _ in range(u["conformers"]):
        n = int(rng.integers(lo, hi + 1))
        builder.add_item({"atoms": list(rng.choice(ATOMS, size=n, p=p)),
                          "coordinates": (rng.standard_normal((n, 3)) * 4.0)
                          .astype(np.float32)})
    builder.finalize()
    return data


def unimol_argv(u, data, save_dir, device):
    t = u["train"]
    return [
        str(data), "--device", device, "--task", "unimol", "--loss", "unimol",
        "--arch", u["arch"], "--optimizer", "adam", "--adam-betas", "(0.9, 0.99)",
        "--adam-eps", "1e-6", "--weight-decay", "1e-4", "--clip-norm", "1.0",
        "--lr-scheduler", "polynomial_decay", "--lr", str(t["lr"]),
        "--warmup-updates", str(t["warmup"]), "--total-num-update", str(t["updates"]),
        "--max-update", str(t["updates"]), "--batch-size", str(u["batch"]),
        "--update-freq", "1", "--log-interval", "1", "--log-format", "simple",
        "--num-workers", "0", "--save-dir", str(save_dir), "--seed", str(u["seed"] + 1),
        *u["extra_args"],
    ]


def drive_unimol_training(cfg, data, card, smi):
    u = cfg["unimol"]
    t = u["train"]
    stats = run_train_cli("unimol_train",
                          unimol_argv(u, data, fresh_dir(WORK / "unimol_ckpt"),
                                      cfg["device"].type),
                          cfg["device"], t, t["timeout_s"], in_process=True)
    lengths = stats["micro_batch_lengths"]
    if set(lengths) != {u["length"]}:
        raise AssertionError(f"unimol_train: micro-batch lengths {lengths}, want all "
                             f"{u['length']}")
    micro, seconds = stats["micro_batches"], sum(stats["step_ms"]) / 1e3
    atoms = stats["tokens"] - 2 * u["batch"] * micro  # less BOS/EOS per molecule
    train = {
        "arch": u["arch"], "updates": stats["updates"], "micro_batches": micro,
        "batch": u["batch"], "update_freq": 1, "micro_batch_lengths": sorted(set(lengths)),
        "loss_first5_mean": stats["loss_first5_mean"],
        "loss_last5_mean": stats["loss_last5_mean"],
        "median_step_ms": stats["median_step_ms"], "atoms": atoms,
        "atoms_per_s": atoms / seconds, "tokens_per_s": stats["tokens_per_s"],
        "peak_memory_bytes": stats["peak_memory_bytes"], "step_ms": stats["step_ms"],
        "loss_per_update": stats["loss_per_update"], "card": card, "nvidia_smi": smi,
    }
    print("unimol_train " + json.dumps(train), flush=True)
    return stats


def unimol_card_vs_cpu_setup(torch, cfg, data, *flags):
    """5b's path (full widths at 2 layers, attention dropout 0.1, other
    dropouts 0) with ``flags`` added to its arguments: (args, task, model,
    loss, the micro-batches of each update)."""
    from unicore_tpu_torch import options
    from unicore_tpu_torch.losses.unimol import UniMolLoss
    from unicore_tpu_torch.models.unimol import UniMolModel
    from unicore_tpu_torch.tasks.unimol import UniMolTask

    u, c = cfg["unimol"], cfg["unimol"]["card_vs_cpu"]
    args = options.parse_args_and_arch(
        options.get_training_parser(),
        unimol_argv(u, data, WORK / "unused", "cpu")
        + ["--batch-size", str(c["batch"]), "--max-update", str(c["updates"]),
           "--total-num-update", str(c["updates"]), "--warmup-updates", "1", *flags])
    task = UniMolTask.setup_task(args)
    task.load_dataset("train")
    itr = task.get_batch_iterator(task.dataset("train"), batch_size=c["batch"],
                                  seed=args.seed)
    samples = list(itr.next_epoch_itr(shuffle=True))[: c["updates"]]
    model = UniMolModel(
        vocab_size=len(task.dictionary), padding_idx=task.dictionary.pad(),
        encoder_layers=2, encoder_embed_dim=args.encoder_embed_dim,
        encoder_ffn_embed_dim=args.encoder_ffn_embed_dim,
        encoder_attention_heads=args.encoder_attention_heads,
        gaussian_kernels=args.gaussian_kernels,
        dropout=0.0, emb_dropout=0.0, attention_dropout=0.1, activation_dropout=0.0,
        masked_token_loss=args.masked_token_loss, masked_coord_loss=args.masked_coord_loss,
        masked_dist_loss=args.masked_dist_loss, generator=torch.Generator().manual_seed(7))
    return args, task, model, UniMolLoss(task), [[s] for s in samples]


def drive_unimol_card_vs_cpu(torch, cfg, data):
    """One Uni-Mol training path (:func:`unimol_card_vs_cpu_setup`) on the
    card and on the CPU from the same weights and batches."""
    import copy

    from unicore_tpu_torch.ops import _kernels
    from unicore_tpu_torch.trainer import Trainer

    u, c = cfg["unimol"], cfg["unimol"]["card_vs_cpu"]
    args, task, model, loss, groups = unimol_card_vs_cpu_setup(torch, cfg, data)

    def run(device):
        tr = Trainer(args, task, copy.deepcopy(model), loss, device)
        tr.begin_epoch(1)
        gnorms = [tr.train_step(group) for group in groups]
        params = {n: p.detach().cpu() for n, p in tr.model.named_parameters()}
        return tr.update_losses, gnorms, params, tr.micro_batch_lengths

    _kernels.reset_launch_counts()
    card = run(cfg["device"])
    card_launches = _kernels.launch_counts()
    _kernels.reset_launch_counts()
    cpu = run(torch.device("cpu"))
    cpu_launches = _kernels.launch_counts()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
    gnorm_rel = max(abs(a - b) / abs(b) for a, b in zip(card[1], cpu[1]))
    param_err = max((card[2][n] - cpu[2][n]).abs().max().item() for n in cpu[2])
    res = {"losses_card": card[0], "losses_cpu": cpu[0], "gnorm_card": card[1],
           "gnorm_cpu": cpu[1], "micro_batch_lengths": card[3],
           "card_launches": card_launches, "loss_rel": loss_rel, "gnorm_rel": gnorm_rel,
           "param_max_abs_diff": param_err, "param_tol": c["param_tol"]}
    log(f"unimol card vs CPU: {json.dumps(res)}")
    if sum(cpu_launches.values()):
        raise AssertionError(f"the CPU run launched kernels: {cpu_launches}")
    if set(card[3]) != {u["length"]}:
        raise AssertionError(f"micro-batch lengths {card[3]}, want all {u['length']}")
    if cfg["device"].type == "cuda" and not all(
            card_launches.get(k, 0) > 0 for k in u["train"]["per_micro_batch"]
            if u["train"]["per_micro_batch"][k]):
        raise AssertionError(f"the card run missed a kernel: {card_launches}")
    if not (loss_rel <= 1e-4 and gnorm_rel <= 1e-3 and param_err <= c["param_tol"]):
        raise AssertionError(f"Uni-Mol card and CPU disagree: loss {loss_rel} (1e-4 rel), "
                             f"gnorm {gnorm_rel} (1e-3 rel), params {param_err} "
                             f"({c['param_tol']} abs)")
    return res


# ---------------------------------------------------------------------------
# phases 6a and 6b: Evoformer masked-MSA pretraining
# ---------------------------------------------------------------------------

AA = list("ACDEFGHIKLMNPQRSTVWY") + ["-"]


def write_msas(e, tag):
    """dict.txt (the Evoformer example's alphabet) and an indexed train split
    of MSAs drawn from a seed, as examples/evoformer/make_example_data.py
    makes them: a target of ``e["residues"]`` residues and ``e["rows"]``
    homologs with point mutations and gaps."""
    import numpy as np

    from unicore_tpu_torch.data import make_builder

    data = WORK / tag
    data.mkdir(parents=True, exist_ok=True)
    specials = ["[CLS]", "[PAD]", "[SEP]", "[UNK]"]
    (data / "dict.txt").write_text("\n".join(specials + AA) + "\n")
    rng = np.random.default_rng(e["seed"])
    builder = make_builder(str(data / "train"))
    for _ in range(e["msas"]):
        L = int(rng.integers(e["residues"][0], e["residues"][1] + 1))
        R = int(rng.integers(e["rows"][0], e["rows"][1] + 1))
        target = rng.integers(0, 20, size=L)
        rows = [target]
        for _ in range(R - 1):
            row = target.copy()
            pos = rng.choice(L, size=int(rng.integers(0, L // 3)), replace=False)
            row[pos] = rng.integers(0, 21, size=len(pos))  # may be a gap
            rows.append(row)
        builder.add_item({"msa": (np.stack(rows) + len(specials)).astype(np.int16)})
    builder.finalize()
    return data


def evoformer_argv(e, data, save_dir, device):
    t = e["train"]
    return [
        str(data), "--device", device, "--task", "msa_pretrain", "--loss", "masked_msa",
        "--arch", e["arch"], "--optimizer", "adam", "--adam-betas", "(0.9, 0.999)",
        "--adam-eps", "1e-8", "--weight-decay", "1e-4", "--clip-norm", "1.0",
        "--lr-scheduler", "polynomial_decay", "--lr", str(t["lr"]),
        "--warmup-updates", str(t["warmup"]), "--total-num-update", str(t["updates"]),
        "--max-update", str(t["updates"]), "--batch-size", str(e["batch"]),
        "--update-freq", str(t["update_freq"]), "--max-msa-rows", str(e["max_rows"]),
        "--log-interval", "1", "--log-format", "simple", "--num-workers", "0",
        "--save-dir", str(save_dir), "--seed", str(e["seed"] + 1), *e["extra_args"],
    ]


def drive_evoformer_training(torch, cfg, data, card, smi):
    e = cfg["evoformer"]
    t = e["train"]
    stats = run_train_cli("evoformer_train",
                          evoformer_argv(e, data, fresh_dir(WORK / "evoformer_ckpt"),
                                         cfg["device"].type),
                          cfg["device"], t, t["timeout_s"], in_process=True)
    lengths = stats["micro_batch_lengths"]
    if set(lengths) != {e["length"]}:
        raise AssertionError(f"evoformer_train: micro-batch lengths {lengths}, want all "
                             f"{e['length']}")
    train = {
        "arch": e["arch"], "extra_args": e["extra_args"], "updates": stats["updates"],
        "micro_batches": stats["micro_batches"], "batch": e["batch"],
        "update_freq": t["update_freq"], "max_msa_rows": e["max_rows"],
        "micro_batch_lengths": sorted(set(lengths)),
        "loss_first5_mean": stats["loss_first5_mean"],
        "loss_last5_mean": stats["loss_last5_mean"],
        "median_step_ms": stats["median_step_ms"], "samples_per_s": stats["samples_per_s"],
        "msa_tokens": stats["tokens"], "msa_tokens_per_s": stats["tokens_per_s"],
        "peak_memory_bytes": stats["peak_memory_bytes"], "step_ms": stats["step_ms"],
        "loss_per_update": stats["loss_per_update"], "card": card, "nvidia_smi": smi,
    }
    print("evoformer_train " + json.dumps(train), flush=True)
    if cfg["device"].type == "cuda":
        profile_evoformer_update(torch, cfg, data, card, smi)
    return stats["kernel_launches"]


#: device kernels by name, for the step's time split
KERNEL_GROUPS = (("flash_attention", ("flash_",)), ("fused_norm", ("fused_norm",)),
                 ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "splitk", "nvjet")),
                 ("elementwise_and_reductions", ("elementwise", "vectorized", "reduce",
                                                 "Reduce", "index", "Index", "scatter",
                                                 "gather", "copy", "cat", "softmax",
                                                 "Softmax", "foreach", "fill")))


def profile_update(torch, tr, samples, groups, card, smi, split_optimizer=True):
    """One update of ``tr`` (a Trainer, its micro-batches ``samples[2:4]``)
    after a warm-up update on ``samples[:2]``: its wall time unprofiled,
    then the same update under ``torch.profiler`` for the device time of
    the kernels by ``groups`` (first match by name; "other" for the rest);
    the idle share is the part of the unprofiled wall time the device time
    does not fill.  With ``split_optimizer`` the trainer's ``optimizer``
    range comes out of the elementwise group into its own; without, the
    optimizer's kernels have groups of their own (``--fused-adam``'s K-a
    and K-b, launched through ``ctypes``, which the range does not see)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tr.begin_epoch(1)
    tr.train_step(samples[:2])  # warm-up
    # the wall time of an update without the profiler (whose host-side
    # recording of every op stretches the traced update several times)
    tr.train_step(samples[2:4])
    wall_us = tr.step_ms[-1] * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.train_step(samples[2:4])
        torch.cuda.synchronize()
    by_group = {name: 0.0 for name, _ in groups}
    by_group["other"] = 0.0
    calls = {name: 0 for name in by_group}
    top = []
    for ev in prof.key_averages():
        if (ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0
                or ev.key == "optimizer"):  # the range itself, not a kernel
            continue
        name = next((g for g, keys in groups if any(k in ev.key for k in keys)), "other")
        by_group[name] += ev.self_device_time_total
        calls[name] += ev.count
        top.append((ev.self_device_time_total, ev.key[:90], ev.count))
    busy = sum(by_group.values())
    # the trainer's "optimizer" range (Adam on the master, the copy-back and
    # its rounding, the EMA): its kernels, all elementwise or foreach ones,
    # come out of that group into their own
    opt_us = range_device_us(prof, "optimizer") if split_optimizer else None
    if opt_us is not None:
        by_group["optimizer"] = opt_us
        elem = "elementwise_and_reductions"
        by_group[elem] = max(0.0, by_group[elem] - opt_us)
    top.sort(reverse=True)
    return {"update_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy / wall_us),
            "device_ms_by_group": {k: v / 1e3 for k, v in by_group.items()},
            "calls_by_group": calls,
            "top_kernels": [{"name": n, "device_ms": t / 1e3, "calls": c}
                            for t, n, c in top[:12]],
            "profiled": "one update (2 micro-batches) after a warm-up update and an "
                        "unprofiled timing of the same update, in-process",
            "card": card, "nvidia_smi": smi}


def watch_one_rank_reduction(torch, tr, samples):
    """15a: two updates of ``tr`` (a trainer under a process group of one
    rank) on ``samples``, each reduction held bit for bit against its
    input: the flat gradient buffers after the group's all-reduce, the
    sample size and the logging outputs' sums after theirs.  A run without
    a group uses those inputs as they are, so equal bits make the run under
    the group the run without it.  (Two runs of BERT on the card are not
    compared: #2's dbias sums by atomics, ROADMAP.md C.)  The watch is
    removed before returning."""
    rec = {"reductions": 0, "buffers_equal": True, "stats_equal": True,
           "backend": None, "buffer_bytes": None}
    reducer = tr._reducer
    real_reduce, real_stats = reducer.reduce_, tr._reduce_stats

    def reduce_(bufs):
        before = [b.clone() for b in bufs]
        real_reduce(bufs)
        rec["reductions"] += 1
        rec["buffers_equal"] &= all(_bits_equal(torch, a, b) for a, b in zip(before, bufs))

    def stats(sample_size, logs):
        size, out = real_stats(sample_size, logs)
        local = {k: sum(float(log[k]) for log in logs) for k in out[0]}
        rec["stats_equal"] &= (float(size) == float(sample_size)
                               and {k: float(v) for k, v in out[0].items()} == local)
        return size, out

    reducer.reduce_, tr._reduce_stats = reduce_, stats
    try:
        tr.begin_epoch(1)
        tr.train_step(samples[:2])
        tr.train_step(samples[2:4])
    finally:
        del reducer.reduce_, tr._reduce_stats
    from unicore_tpu_torch.parallel import groups

    rec.update(backend=groups.backend(), buffer_bytes=reducer.buffer_bytes)
    return rec


def range_device_us(prof, name):
    """Microseconds of the device kernels launched inside the profiler
    ranges called ``name`` (their CPU ops' kernels, summed down the op
    tree); None when no such range or no kernel was seen."""
    from torch.autograd import DeviceType

    def kernel_us(ev):
        return (sum(k.duration for k in getattr(ev, "kernels", []))
                + sum(kernel_us(ch) for ch in ev.cpu_children))

    total, found = 0.0, False
    for ev in prof.events():
        if ev.name == name and ev.device_type == DeviceType.CPU:
            found = True
            total += kernel_us(ev)
    return total if found and total > 0 else None


#: the Evoformer's update by kernel group: the flash forward and each
#: launch of its backward apart (the dbias reduction with dk/dv), then the
#: groups of :data:`KERNEL_GROUPS`; ``flash_attention`` is their sum
EVOFORMER_GROUPS = (("flash_fwd", ("flash_fwd",)), ("flash_bwd_dq", ("flash_dq",)),
                    ("flash_bwd_dkv_dbias", ("flash_dkv", "flash_db_reduce"))) + KERNEL_GROUPS[1:]


def profile_evoformer_update(torch, cfg, data, card, smi):
    """:func:`profile_update` on 6a's configuration (full width, its
    optimizer): the ``evoformer_profile`` line."""
    from unicore_tpu_torch import options
    from unicore_tpu_torch.losses.masked_msa import MaskedMSALoss
    from unicore_tpu_torch.tasks.msa_pretrain import MSAPretrainTask
    from unicore_tpu_torch.trainer import Trainer

    e = cfg["evoformer"]
    dev = cfg["device"]
    args = options.parse_args_and_arch(
        options.get_training_parser(), evoformer_argv(e, data, WORK / "unused", "cuda"))
    task = MSAPretrainTask.setup_task(args)
    task.load_dataset("train")
    itr = task.get_batch_iterator(task.dataset("train"), batch_size=e["batch"],
                                  seed=args.seed)
    samples = list(itr.next_epoch_itr(shuffle=True))[:4]
    model = task.build_model(args, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(args.seed))
    tr = Trainer(args, task, model, MaskedMSALoss(task), dev)
    res = profile_update(torch, tr, samples, EVOFORMER_GROUPS, card, smi)
    by_group = res["device_ms_by_group"]
    by_group["flash_attention"] = sum(by_group[g] for g, _ in EVOFORMER_GROUPS[:3])
    print("evoformer_profile " + json.dumps(res), flush=True)
    del tr, model
    torch.cuda.empty_cache()


#: BERT's update by kernel group: the full-row forward and each launch of
#: its backward apart, then the groups of :data:`KERNEL_GROUPS`
BERT_GROUPS = (("fullrow_fwd", ("fullrow_fwd",)), ("fullrow_bwd_dq_dbias", ("fullrow_dq",)),
               ("fullrow_bwd_dk_dv", ("fullrow_dkv",))) + KERNEL_GROUPS[1:]


def profile_cli_update(torch, cfg, argv, tag, card, smi, groups=None, split_optimizer=True,
                       one_rank_group=False):
    """:func:`profile_update` on the configuration the train CLI takes from
    ``argv`` (its model at full width, optimizer, EMA and dropouts; its
    first 4 batches of 8): the ``tag`` line.  BERT (4a): 2 micro-batches
    of the 384/512 buckets; the LM (9a): of the 512 bucket.  With
    ``one_rank_group`` (15a) the trainer runs under a process group of one
    rank (NCCL), first 2 updates under :func:`watch_one_rank_reduction`,
    then the profile, whose update includes the group's reduction."""
    from unicore_tpu_torch import options, tasks
    from unicore_tpu_torch.distributed import utils as distributed_utils
    from unicore_tpu_torch.trainer import Trainer

    dev = cfg["device"]
    args = options.parse_args_and_arch(options.get_training_parser(), argv)
    task = tasks.setup_task(args)
    task.load_dataset("train")
    itr = task.get_batch_iterator(task.dataset("train"), batch_size=cfg["batch"],
                                  seed=args.seed)
    samples = list(itr.next_epoch_itr(shuffle=True))[:4]
    model = task.build_model(args, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(args.seed))
    if one_rank_group:
        args.distributed_init_method = f"tcp://localhost:{distributed_utils.free_port()}"
        distributed_utils.distributed_init(args)
    try:
        tr = Trainer(args, task, model, task.build_loss(args), dev)
        identity = watch_one_rank_reduction(torch, tr, samples) if one_rank_group else None
        res = profile_update(torch, tr, samples, groups or BERT_GROUPS, card, smi,
                             split_optimizer)
        if identity is not None:
            res["one_rank_group"] = identity
            res["reduction"] = tr.reduction_stats()
    finally:
        if one_rank_group:
            distributed_utils.destroy()
    res["micro_batch_shapes"] = [list(s["net_input"]["src_tokens"].shape)
                                 for s in samples[2:4]]
    print(f"{tag} " + json.dumps(res), flush=True)
    del tr, model
    torch.cuda.empty_cache()
    if identity is not None and not (identity["buffers_equal"] and identity["stats_equal"]):
        raise AssertionError(f"15a: the one-rank group changed an update: {identity}")


def evoformer_card_vs_cpu_setup(torch, cfg, data, *flags):
    """6b's path (full widths at 2 blocks, dropout 0, the optimizer of
    phases 4b and 5b: lr 1e-4, eps 1e-6) with ``flags`` added to its
    arguments: (args, task, model, loss, the micro-batches of each update).
    At 6a's lr 1e-3 and eps 1e-8 Adam turns gradient elements at fp32 noise
    level -- the bias of ``ln_z`` before the pair-bias projection, whose
    true gradient is 0 (a constant added to a score row leaves the softmax
    as it is), and ReLU units at the edge of activity -- into steps the size
    of the lr, and the devices then differ by more than the parameter
    limit."""
    from unicore_tpu_torch import options
    from unicore_tpu_torch.losses.masked_msa import MaskedMSALoss
    from unicore_tpu_torch.models.evoformer_model import EvoformerModel
    from unicore_tpu_torch.tasks.msa_pretrain import MSAPretrainTask

    e, c = cfg["evoformer"], cfg["evoformer"]["card_vs_cpu"]
    args = options.parse_args_and_arch(
        options.get_training_parser(),
        evoformer_argv(e, data, WORK / "unused", "cpu")
        + ["--batch-size", str(c["batch"]), "--max-update", str(c["updates"]),
           "--total-num-update", str(c["updates"]), "--warmup-updates", "1",
           "--update-freq", "1", "--max-msa-rows", str(c["max_rows"]),
           "--max-seq-len", str(c["length"]), "--lr", "1e-4", "--adam-eps", "1e-6", *flags])
    task = MSAPretrainTask.setup_task(args)
    task.load_dataset("train")
    itr = task.get_batch_iterator(task.dataset("train"), batch_size=c["batch"],
                                  seed=args.seed)
    samples = list(itr.next_epoch_itr(shuffle=True))[: c["updates"]]
    model = EvoformerModel(
        vocab_size=len(task.dictionary), padding_idx=task.dictionary.pad(),
        num_blocks=c["blocks"], msa_dim=args.msa_dim, pair_dim=args.pair_dim,
        msa_heads=args.msa_heads, pair_heads=args.pair_heads, dropout=0.0,
        max_seq_len=args.max_seq_len, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():  # move the AF2 zero-init projections and gates, so
        gen = torch.Generator().manual_seed(8)  # every path has gradient at once
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return args, task, model, MaskedMSALoss(task), [[s] for s in samples]


def drive_evoformer_card_vs_cpu(torch, cfg, data):
    """One Evoformer training path (:func:`evoformer_card_vs_cpu_setup`) on
    the card and on the CPU from the same weights and batches."""
    import copy

    from unicore_tpu_torch.ops import _kernels
    from unicore_tpu_torch.trainer import Trainer

    c = cfg["evoformer"]["card_vs_cpu"]
    args, task, model, loss, groups = evoformer_card_vs_cpu_setup(torch, cfg, data)

    def run(device):
        tr = Trainer(args, task, copy.deepcopy(model), loss, device)
        tr.begin_epoch(1)
        gnorms = [tr.train_step(group) for group in groups]
        params = {n: p.detach().cpu() for n, p in tr.model.named_parameters()}
        return tr.update_losses, gnorms, params, tr.micro_batch_lengths

    _kernels.reset_launch_counts()
    card = run(cfg["device"])
    card_launches = _kernels.launch_counts()
    _kernels.reset_launch_counts()
    cpu = run(torch.device("cpu"))
    cpu_launches = _kernels.launch_counts()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
    gnorm_rel = max(abs(a - b) / abs(b) for a, b in zip(card[1], cpu[1]))
    param_err = max((card[2][n] - cpu[2][n]).abs().max().item() for n in cpu[2])
    res = {"losses_card": card[0], "losses_cpu": cpu[0], "gnorm_card": card[1],
           "gnorm_cpu": cpu[1], "micro_batch_lengths": card[3], "batch": c["batch"],
           "blocks": c["blocks"], "card_launches": card_launches, "loss_rel": loss_rel,
           "gnorm_rel": gnorm_rel, "param_max_abs_diff": param_err,
           "param_tol": c["param_tol"]}
    log(f"evoformer card vs CPU: {json.dumps(res)}")
    if sum(cpu_launches.values()):
        raise AssertionError(f"the CPU run launched kernels: {cpu_launches}")
    if set(card[3]) != {c["length"]}:
        raise AssertionError(f"micro-batch lengths {card[3]}, want all {c['length']}")
    if cfg["device"].type == "cuda" and not all(
            card_launches.get(k, 0) > 0 for k, v in KERNELS.items()
            if v[2] == "evoformer_train"):
        raise AssertionError(f"the card run missed a flash kernel: {card_launches}")
    if not (loss_rel <= 1e-4 and gnorm_rel <= 1e-3 and param_err <= c["param_tol"]):
        raise AssertionError(f"Evoformer card and CPU disagree: loss {loss_rel} (1e-4 rel), "
                             f"gnorm {gnorm_rel} (1e-3 rel), params {param_err} "
                             f"({c['param_tol']} abs)")
    return res


# ---------------------------------------------------------------------------
# phase 4: the served slice
# ---------------------------------------------------------------------------

def http(method, url, payload=None, timeout=120.0):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def load_serving_model_cpu(torch, path):
    """The checkpoint's model on the CPU in its own dtype, as the server
    loads it, in eval mode."""
    from unicore_tpu_torch import checkpoint_utils, tasks

    state = checkpoint_utils.load_checkpoint_to_cpu(str(path))
    model = tasks.setup_task(state["args"]).build_model(state["args"])
    model.load_state_dict(state["model"], assign=True)
    return model.eval()


def cpu_reference(torch, path, rows, bucket, pad_idx):
    """ids/score for ``rows`` padded to ``bucket``: the same checkpoint
    loaded in this process on the CPU in its own dtype (as the server loads
    it), through the plain versions."""
    import numpy as np

    from unicore_tpu_torch.serve import build_infer_fn

    model = load_serving_model_cpu(torch, path)
    arr = np.full((len(rows), bucket), pad_idx, np.int32)
    for i, r in enumerate(rows):
        arr[i, : len(r)] = r
    return build_infer_fn("cpu")(model, arr)


class Server:
    """``python -m unicore_tpu_torch.cli.serve`` on ``path``: batch size
    and buckets from ``argv`` (the BERT serving path's by default), which
    come after the deadline defaults and so may override them."""

    def __init__(self, path, cfg, argv=None, name="serve"):
        self.log_path = WORK / f"{name}.log"
        self._log = open(self.log_path, "w")
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
        if argv is None:
            argv = ["--serve-batch-size", str(cfg["batch"]), "--serve-buckets", "4"]
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "unicore_tpu_torch.cli.serve",
             "--path", str(path), "--device", cfg["device"].type, "--port", "0",
             "--default-deadline-ms", "120000", "--max-deadline-ms", "120000",
             "--drain-deadline", "120", *argv],
            stdout=self._log, stderr=subprocess.STDOUT, cwd=str(ROOT), env=env,
        )
        self.base = None

    def log_text(self):
        return self.log_path.read_text()

    def wait_ready(self, budget):
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"server exited {self.proc.returncode}:\n{self.log_text()[-6000:]}"
                )
            if self.base is None:
                for line in self.log_text().splitlines():
                    if "SERVE listening on http://" in line:
                        self.base = "http://" + line.split("http://", 1)[1].split()[0]
            if self.base is not None:
                try:
                    if http("GET", self.base + "/readyz", timeout=5)[0] == 200:
                        return
                except OSError:
                    pass
            time.sleep(0.5)
        raise RuntimeError(f"server not ready in {budget}s:\n{self.log_text()[-6000:]}")

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self._log.close()


def scrape_metrics(base):
    """``GET /metrics`` parsed: {name or name{labels}: value}.  Raises on a
    line that is not a comment or one sample."""
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        if not r.headers["Content-Type"].startswith("text/plain; version=0.0.4"):
            raise AssertionError(f"/metrics content type {r.headers['Content-Type']}")
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, value = line.rsplit(" ", 1)
        out[key] = float(value)
    return out


def metrics_match_stats(m, stats):
    """The served, batch and shed counters of ``/metrics`` equal ``/stats``'s."""
    shed = {k[len('unicore_tpu_serve_shed_total{reason="'):-2]: v for k, v in m.items()
            if k.startswith("unicore_tpu_serve_shed_total{")}
    if (m.get("unicore_tpu_serve_served_total") != stats["served"]
            or m.get("unicore_tpu_serve_batches_total") != stats["batches"]
            or shed != {k: float(v) for k, v in stats["shed"].items()}):
        raise AssertionError(f"/metrics {m} against /stats {stats}")


def journal_events(path):
    """The serve journal beside the served checkpoint (the CLI's default
    ``<dirname(--path)>/telemetry``)."""
    jpath = Path(path).parent / "telemetry" / "events_rank0_serve.jsonl"
    return [json.loads(line) for line in jpath.read_text().splitlines() if line.strip()]


def publish(src, dst):
    """A checkpoint published as training publishes one: copy, then
    ``os.replace`` (a new inode)."""
    tmp = Path(str(dst) + ".publishing")
    shutil.copy(src, tmp)
    os.replace(tmp, dst)


def wait_log(server, text, budget=300.0, count=1):
    """Wait until ``text`` stands in the server's log ``count`` times."""
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        if server.log_text().count(text) >= count:
            return
        if server.proc.poll() is not None:
            break
        time.sleep(0.2)
    raise AssertionError(f"{text!r} never logged:\n{server.log_text()[-6000:]}")


class KeepSending:
    """Requests sent back to back (or ``pace_s`` apart) from ``workers``
    threads until :meth:`stop`: the traffic in flight across a hot reload.
    ``stop`` returns every (code, body)."""

    def __init__(self, url, payloads, workers=4, pace_s=0.0):
        import threading

        self._stop = threading.Event()
        self.results = []
        self._lock = threading.Lock()

        def run(k):
            i = k
            while not self._stop.is_set():
                res = http("POST", url, payloads[i % len(payloads)])
                with self._lock:
                    self.results.append(res)
                i += workers
                self._stop.wait(pace_s)

        self._threads = [threading.Thread(target=run, args=(k,), daemon=True)
                         for k in range(workers)]
        for t in self._threads:
            t.start()

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=300)
        return self.results


def drive_slice(torch, cfg, fleet, card, smi):
    """Phase 4 on phase 14's replica 0 (``start_fleet``), which serves a copy
    of 4a's checkpoint under the slow client: the requests go to it
    directly.  Its drain and journal are checked when phase 14 ends it."""
    import numpy as np

    from unicore_tpu_torch.ops import _kernels

    server, path = fleet["reps"][0], fleet["path"]
    vocab, pad = fleet["vocab"], fleet["pad"]
    wait_fleet_ready(cfg, fleet)
    log(f"server ready at {server.base} after {fleet['startup_s']:.1f}s")
    rng = np.random.default_rng(cfg["seed"])
    reqs = [rng.integers(5, vocab, size=n).tolist() for n in cfg["lengths"]]
    _kernels.reset_launch_counts()
    code, before = http("GET", server.base + "/stats")
    assert code == 200, before

    def send(toks):
        t = time.monotonic()
        code, body = http("POST", server.base + "/v1/infer", {"tokens": toks})
        return code, body, (time.monotonic() - t) * 1e3

    # the first half one at a time, the rest concurrently; the one
    # request the slow client stalled is answered 408 with its reason
    # and sent again
    half = len(reqs) // 2
    results = [send(r) for r in reqs[:half]]
    slow = [i for i, (code, _, _) in enumerate(results) if code == 408]
    if len(slow) != 1 or results[slow[0]][1] != {"status": "shed", "reason": "slow-client"}:
        raise AssertionError(f"want one 408 slow-client answer: {[r[:2] for r in results]}")
    results[slow[0]] = send(reqs[slow[0]])
    with ThreadPoolExecutor(max_workers=cfg["batch"]) as pool:
        results += list(pool.map(send, reqs[half:]))
    code, after = http("GET", server.base + "/stats")
    assert code == 200, after
    metrics_match_stats(scrape_metrics(server.base), after)

    buckets = set()
    for toks, (code, body, _) in zip(reqs, results):
        if code != 200:
            raise AssertionError(f"request of {len(toks)} tokens: {code} {body}")
        if len(body["output"]) != len(toks) or not math.isfinite(body["score"]):
            raise AssertionError(f"bad answer for {len(toks)} tokens: {body}")
        buckets.add(body["bucket"])
    if buckets != set(after["buckets"]):
        raise AssertionError(f"buckets hit {sorted(buckets)} != {after['buckets']}")

    batches = after["batches"] - before["batches"]
    launches = {
        k: after["kernel_launches"][k] - before["kernel_launches"].get(k, 0)
        for k in after["kernel_launches"]
    }
    per_batch = cfg["per_batch"]
    log(f"main path: {len(reqs)} requests in {batches} batches, server "
        f"launches {launches} (want per batch {per_batch})")
    if batches <= 0:
        raise AssertionError("no batch was served")
    if cfg["device"].type == "cuda":
        for k, n in per_batch.items():
            if launches.get(k) != n * batches:
                raise AssertionError(
                    f"{k}: {launches.get(k)} launches for {batches} batches, "
                    f"want {n} per batch"
                )

    # two 128-bucket answers against this process's CPU run
    small = [i for i, (_, b, _) in enumerate(results) if b["bucket"] == min(buckets)][:2]
    ids, score = cpu_reference(torch, path, [reqs[i] for i in small],
                               min(buckets), pad)
    agree, total = 0, 0
    for row, i in enumerate(small):
        got = np.asarray(results[i][1]["output"])
        agree += int((got == ids[row, : len(got)]).sum())
        total += len(got)
        rel = abs(results[i][1]["score"] - float(score[row])) / max(abs(float(score[row])), 1e-6)
        if rel > 1e-3:
            raise AssertionError(f"score {results[i][1]['score']} vs CPU {score[row]}")
    if agree < 0.99 * total:
        raise AssertionError(f"ids agree with the CPU run on {agree}/{total}")
    if sum(_kernels.launch_counts().values()):
        raise AssertionError("the CPU reference launched a kernel")
    log(f"CPU agreement: ids {agree}/{total}, scores within 1e-3 relative")
    lat = np.asarray([r[2] for r in results])
    serve = {
        "requests": len(reqs), "batches": batches,
        "client_p50_ms": float(np.percentile(lat, 50)),
        "client_p99_ms": float(np.percentile(lat, 99)),
        "server_p50_ms": after.get("p50_ms"), "server_p99_ms": after.get("p99_ms"),
        "slow_client_408": slow[0], "metrics_match_stats": True,
        "launches": launches, "arch": cfg["arch"], "card": card, "nvidia_smi": smi,
    }
    print("serve " + json.dumps(serve), flush=True)
    # phase 14 routes the same two rows and holds them to this reference
    serve["cpu_ref"] = [(reqs[i], ids[row, : len(reqs[i])].tolist(), float(score[row]))
                        for row, i in enumerate(small)]
    return serve


# ---------------------------------------------------------------------------
# phase 7: incremental-decode serving of the causal LM
# ---------------------------------------------------------------------------

def write_lm_checkpoint(torch, cfg, data):
    """A ``transformer_lm`` checkpoint at its arch's widths and depth, on
    phase 4a's dictionary (``task='causal_lm'``), its weights the JAX init
    distributions drawn from a seed: embeddings and dense kernels N(0, 0.02),
    biases 0, LayerNorms 1 and 0.  Returns (path, vocab size, pad, eos)."""
    from argparse import Namespace

    from unicore_tpu_torch import checkpoint_utils, tasks
    from unicore_tpu_torch.models import ARCH_CONFIG_REGISTRY

    d = cfg["decode"]
    args = Namespace(task="causal_lm", arch=d["arch"], data=str(data), seed=d["seed"])
    ARCH_CONFIG_REGISTRY[d["arch"]](args)
    task = tasks.setup_task(args)
    model = task.build_model(args, generator=torch.Generator().manual_seed(d["seed"]))
    path = WORK / "lm.pt"
    checkpoint_utils.write_checkpoint(str(path), args, model.state_dict())
    log(f"wrote {d['arch']} ({sum(p.numel() for p in model.parameters())} parameters, "
        f"vocab {len(task.dictionary)}) to {path}")
    return path, len(task.dictionary), task.dictionary.pad(), task.dictionary.eos()


def load_lm(torch, path, device):
    return load_serving_model_cpu(torch, path).to(device)


def decode_launch_check(cfg, before, after, decode="decode_attention"):
    """The server's launches between two ``/stats`` reads against the decode
    arithmetic: per decode step one decode attention a layer (``decode``
    names the counter: the bf16-query variant's for a bf16 model); per
    prefill batch one full-row attention forward a layer; per dispatch
    (either) two norm forwards a layer plus the embedding and final norms;
    no other launch (no backward, no flash or softmax kernel).  On the CPU:
    none."""
    layers = cfg["decode"]["layers"]
    steps = after["decode_steps"] - before["decode_steps"]
    prefills = after["prefill_batches"] - before["prefill_batches"]
    launches = {k: n - before["kernel_launches"].get(k, 0)
                for k, n in after["kernel_launches"].items()}
    want = {decode: layers * steps, "fullrow_attention_fwd": layers * prefills,
            "fused_norm_fwd": (2 * layers + 2) * (steps + prefills)}
    if cfg["device"].type != "cuda":
        want = {}
    for k in set(launches) | set(want):
        if launches.get(k, 0) != want.get(k, 0):
            raise AssertionError(
                f"{k}: {launches.get(k, 0)} launches for {steps} decode steps and "
                f"{prefills} prefill batches, want {want.get(k, 0)} ({launches})")
    return steps, prefills, launches


def teacher_forced_check(torch, model, prompt, served, gap):
    """One served generation against the same checkpoint on the CPU, teacher
    forced: prefill the prompt, then decode over the served tokens.  At
    every step whose CPU top-2 logit gap exceeds ``gap`` the served token
    must be the CPU's argmax.  Returns the number of steps so checked."""
    P = len(prompt)
    with torch.inference_mode():
        logits, (k, v) = model.prefill(torch.tensor([prompt]))
        rows = [logits[0, -1]]
        nl, _, H, _, D = k.shape
        kc = torch.zeros(nl, 1, H, P + len(served), D)
        vc = torch.zeros_like(kc)
        kc[:, :, :, :P], vc[:, :, :, :P] = k, v
        for i, tok in enumerate(served[:-1]):
            lg, (kr, vr) = model.decode_step(torch.tensor([tok]), (kc, vc),
                                             torch.tensor([P + i], dtype=torch.int32))
            kc[:, :, :, P + i], vc[:, :, :, P + i] = kr, vr
            rows.append(lg[0])
    checked = 0
    for i, (row, tok) in enumerate(zip(rows, served)):
        top2 = row.topk(2).values
        if (top2[0] - top2[1]).item() > gap:
            checked += 1
            if int(row.argmax()) != tok:
                raise AssertionError(
                    f"served token {i} of a {P}-token prompt is {tok}, the CPU's "
                    f"argmax {int(row.argmax())} (top-2 gap {(top2[0] - top2[1]).item()})")
    return checked


def drive_decode_serving(torch, cfg, path, lm, card, smi, kv, lengths=None, tag=None):
    """``python -m unicore_tpu_torch.cli.serve`` on the LM checkpoint:
    ``/v1/generate`` requests of ``lengths`` prompt tokens (phase 7's by
    default; the first half one at a time, the rest concurrently) with their
    launch arithmetic from ``/stats``; with fp32 KV two served generations
    held against the CPU; SIGTERM drains and exits 0.  Prints the ``tag``
    line (``decode_serve`` / ``decode_serve_int8`` by default) and returns
    it (the server's launches under ``launches``)."""
    import threading

    import numpy as np

    from unicore_tpu_torch.serve.kv_cache import bucket_for

    d = cfg["decode"]
    vocab, eos = lm["vocab"], lm["eos"]
    if lengths is None:
        lengths = d["lengths"] if kv == "fp32" else d["lengths"][: d["int8_requests"]]
    tag = tag or ("decode_serve" if kv == "fp32" else "decode_serve_int8")
    t0 = time.monotonic()
    server = Server(path, cfg, [
        "--serve-batch-size", str(d["prefill_batch"]),
        "--decode-batch-size", str(d["decode_batch"]), "--serve-buckets", "4",
        "--cache-pages", str(d["cache_pages"]), "--max-new-tokens", str(d["max_new"]),
        "--decode-kv", kv], name=tag)
    try:
        server.wait_ready(d["ready_budget_s"])
        log(f"decode server ({kv} KV) ready at {server.base} after "
            f"{time.monotonic() - t0:.1f}s")
        rng = np.random.default_rng(d["seed"])
        prompts = [rng.integers(5, vocab, size=n).tolist() for n in lengths]
        code, before = http("GET", server.base + "/stats")
        assert code == 200, before
        edges = before["buckets"]
        occupancy = [before["cache_page_occupancy"]]
        done = threading.Event()

        def send(toks):
            t = time.monotonic()
            code, body = http("POST", server.base + "/v1/generate",
                              {"tokens": toks, "max_new_tokens": d["max_new"]})
            return code, body, (time.monotonic() - t) * 1e3

        def watch():  # page occupancy while the concurrent half is in flight
            while not done.wait(0.05):
                code, st = http("GET", server.base + "/stats")
                if code == 200:
                    occupancy.append(st["cache_page_occupancy"])

        t_req = time.monotonic()
        half = len(prompts) // 2
        results = [send(p) for p in prompts[:half]]
        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        with ThreadPoolExecutor(max_workers=len(prompts) - half) as pool:
            results += list(pool.map(send, prompts[half:]))
        done.set()
        watcher.join(timeout=30)
        wall = time.monotonic() - t_req
        code, after = http("GET", server.base + "/stats")
        assert code == 200, after

        for toks, (code, body, _) in zip(prompts, results):
            out = body.get("output") if code == 200 else None
            if (not out or len(out) > d["max_new"] or not math.isfinite(body["score"])
                    or not all(0 <= t < vocab for t in out)):
                raise AssertionError(f"request of {len(toks)} tokens: {code} {body}")
            if out[-1] != eos and len(out) < d["max_new"] and len(toks) + len(out) < edges[-1]:
                raise AssertionError(f"generation stopped early: {len(toks)} tokens, {body}")
        if kv == "fp32" and {bucket_for(len(p), edges) for p in prompts} != set(edges):
            raise AssertionError(f"prompts miss a cache bucket of {edges}")
        if after["kv_dtype"] != ("int8" if kv == "int8" else "float32"):
            raise AssertionError(f"kv_dtype {after['kv_dtype']} for --decode-kv {kv}")
        steps, prefills, launches = decode_launch_check(cfg, before, after)
        log(f"decode main path ({kv} KV): {len(prompts)} requests, {steps} decode steps, "
            f"{prefills} prefill batches, server launches {launches}")

        agreement = None
        if kv == "fp32":  # two served generations against the CPU
            cpu_model = load_lm(torch, path, "cpu")
            order = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))[:2]
            agreement = {
                "requests": len(order),
                "steps": sum(len(results[i][1]["output"]) for i in order),
                "checked_steps": sum(teacher_forced_check(
                    torch, cpu_model, prompts[i], results[i][1]["output"], d["cpu_gap"])
                    for i in order),
                "gap": d["cpu_gap"]}
            del cpu_model
            log(f"decode CPU agreement: {json.dumps(agreement)}")

        server.proc.send_signal(signal.SIGTERM)
        rc = server.proc.wait(timeout=180)
        if rc != 0 or "DRAIN complete" not in server.log_text():
            raise AssertionError(f"drain exit {rc}:\n{server.log_text()[-6000:]}")
        tokens = after["tokens_generated"] - before["tokens_generated"]
        lat = np.asarray([r[2] for r in results])
        res = {
            "kv": kv, "requests": len(prompts), "concurrent": len(prompts) - half,
            "prompt_tokens": [min(lengths), max(lengths)], "max_new_tokens": d["max_new"],
            "tokens_generated": tokens, "request_wall_s": wall,
            "tokens_per_s": tokens / wall,
            "server_tokens_per_s": after["tokens_per_s"],
            "token_p50_ms": after.get("token_p50_ms"),
            "token_p99_ms": after.get("token_p99_ms"),
            "client_p50_ms": float(np.percentile(lat, 50)),
            "client_p99_ms": float(np.percentile(lat, 99)),
            "decode_steps": steps, "prefill_batches": prefills,
            "page_occupancy_peak": max(occupancy), "preempted":
                after["preempted"] - before["preempted"],
            "buckets": edges, "launches": launches, "cpu_agreement": agreement,
            "arch": d["arch"], "card": card, "nvidia_smi": smi,
        }
        print(f"{tag} " + json.dumps(res), flush=True)
        return res
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# phase 8: quantized serving of the BERT checkpoint
# ---------------------------------------------------------------------------

def quant_per_batch(layers, mode):
    """Kernel launches of one quantized BERT forward: int8 runs 4 W8A8
    denses a layer plus the LM head's, one int8 softmax a layer, the LM
    head's int8 LayerNorm and the other 2 x layers + 1 norms; fp8 runs the
    full-row attention and those norms (its LM-head norm is plain), no
    W8A8 dense."""
    if mode == "int8":
        return {"quant_matmul": 4 * layers + 1, "quant_softmax_dropout_fwd": layers,
                "quant_layer_norm": 1, "fused_norm_fwd": 2 * layers + 1,
                "fullrow_attention_fwd": 0}
    return {"quant_matmul": 0, "quant_softmax_dropout_fwd": 0, "quant_layer_norm": 0,
            "fused_norm_fwd": 2 * layers + 1, "fullrow_attention_fwd": layers}


def load_quantized(torch, path, mode, device):
    """(fp32 model, quantized model) of the checkpoint on ``device``, the
    latter from the server's sidecar (its digest verified), its weights
    quantized on ``device`` as the server quantizes them on its own."""
    from unicore_tpu_torch import checkpoint_utils, tasks
    from unicore_tpu_torch.quant import calibrate

    state = checkpoint_utils.load_checkpoint_to_cpu(str(path))
    task = tasks.setup_task(state["args"])
    model = task.build_model(state["args"])
    model.load_state_dict(state["model"])
    model.eval()
    doc = calibrate.load_scales(calibrate.scales_path(str(path)))
    if doc is None or doc["mode"] != mode or not calibrate.digest_matches(
            doc, model.state_dict()):
        raise AssertionError(f"the {mode} sidecar beside {path} does not verify")
    model = model.to(device)
    model_q = calibrate.load_prepared(
        model.clone(quantize=mode),
        calibrate.prepare(model.state_dict(), doc["sites"], mode))
    return model, model_q


def cpu_logits(torch, model, rows, bucket, pad_idx):
    """(logits, ids, score) of ``model`` on the CPU for ``rows`` padded to
    ``bucket``: the engine's ids and score, and the fp32 logits behind them."""
    import numpy as np

    arr = np.full((len(rows), bucket), pad_idx, np.int32)
    for i, r in enumerate(rows):
        arr[i, : len(r)] = r
    with torch.inference_mode():
        logits = model(torch.as_tensor(arr, dtype=torch.long)).float()
    ids = logits.argmax(dim=-1).numpy()
    score = logits.amax(dim=-1).mean(dim=-1).numpy()
    return logits.numpy(), ids, score


def gapped_agreement(answers, logits, ids, gap):
    """Served ids against the CPU's at the positions whose CPU top-2 logit
    gap exceeds ``gap`` (a near tie may break either way under the path's
    own rounding): (equal, compared, excluded)."""
    import numpy as np

    agree = total = excluded = 0
    for row, body in enumerate(answers):
        got = np.asarray(body["output"])
        top2 = np.sort(logits[row, : len(got)], axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > gap
        agree += int((got[clear] == ids[row, : len(got)][clear]).sum())
        total += int(clear.sum())
        excluded += int((~clear).sum())
    return agree, total, excluded


def cpu_quant_reference(torch, path, mode, rows, bucket, pad_idx):
    """ids/score for ``rows`` padded to ``bucket``: the same checkpoint
    quantized in this process on the CPU from the server's sidecar, through
    the plain versions."""
    import numpy as np

    from unicore_tpu_torch.serve import build_infer_fn

    _, model_q = load_quantized(torch, path, mode, "cpu")
    arr = np.full((len(rows), bucket), pad_idx, np.int32)
    for i, r in enumerate(rows):
        arr[i, : len(r)] = r
    return build_infer_fn("cpu")(model_q, arr)


#: (7q is the norm forward's template on int8 rows: ahead of ``fused_norm``)
QUANT_GROUPS = (("quant_matmul", ("quant_matmul",)),
                ("quant_layer_norm", ("fused_norm_fwd_kernel<signed char",
                                      "fused_norm_fwd_wide_kernel<signed char")),
                ("softmax_kernel", ("softmax_dropout_fwd",)),
                ("fullrow_attention", ("fullrow_",))) + KERNEL_GROUPS


def profile_serve_batches(torch, cfg, path, card, smi):
    """The served forward of one full batch (8 rows at the top bucket,
    through the engine's own ``build_infer_fn``) in this process, int8 and
    fp32 on the same weights: wall time per batch unprofiled, then device
    time by kernel group under ``torch.profiler``; the idle share is the
    part of the wall time the device time does not fill."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from unicore_tpu_torch.serve import build_infer_fn

    dev, n = cfg["device"], cfg["quant_serve"]["profile_batches"]
    model, model_q = load_quantized(torch, path, "int8", dev)
    bucket = max(cfg["quant_serve"]["lengths"])  # the top bucket
    arr = np.random.default_rng(14).integers(5, model.vocab_size, (cfg["batch"], bucket))
    infer = build_infer_fn(dev)
    out = {"batch": cfg["batch"], "bucket": bucket, "batches": n, "card": card,
           "nvidia_smi": smi}
    for name, m in (("int8", model_q), ("fp32", model)):
        infer(m, arr)  # warm
        t0 = time.perf_counter()
        for _ in range(n):
            infer(m, arr)
        wall_us = (time.perf_counter() - t0) * 1e6
        res = {"batch_wall_ms": wall_us / n / 1e3}
        if dev.type == "cuda":
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    infer(m, arr)
                torch.cuda.synchronize()
            groups = {g: 0.0 for g, _ in QUANT_GROUPS}
            groups["other"] = 0.0
            top = []
            for ev in prof.key_averages():
                if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
                    continue
                g = next((g for g, keys in QUANT_GROUPS if any(k in ev.key for k in keys)),
                         "other")
                groups[g] += ev.self_device_time_total
                top.append((ev.self_device_time_total, ev.key[:90], ev.count))
            busy = sum(groups.values())
            top.sort(reverse=True)
            res.update({
                "device_busy_ms_per_batch": busy / n / 1e3,
                "device_idle_share": max(0.0, 1.0 - busy / wall_us),
                "device_ms_per_batch_by_group": {k: v / n / 1e3 for k, v in groups.items()},
                "top_kernels": [{"name": k, "device_ms_per_batch": t / n / 1e3, "calls": c}
                                for t, k, c in top[:10]],
            })
        out[name] = res
    del model, model_q
    print("quant_profile " + json.dumps(out), flush=True)


def write_moved_checkpoint(torch, src, dst, seed, scale=0.01):
    """``src``'s checkpoint with every float weight moved by
    ``scale`` * N(0, 1) drawn from ``seed``: a hot-reload candidate of the
    same arch whose scales must be re-derived."""
    from unicore_tpu_torch import checkpoint_utils

    state = checkpoint_utils.load_checkpoint_to_cpu(str(src))
    g = torch.Generator().manual_seed(seed)
    weights = {k: (v + scale * torch.randn(v.shape, generator=g)).to(v.dtype)
               if v.is_floating_point() else v for k, v in state["model"].items()}
    checkpoint_utils.write_checkpoint(str(dst), state["args"], weights,
                                      optimizer_history=[{"num_updates": 1000 + seed}])
    return dst


def quant_reload(torch, cfg, server, path, reqs, vocab, pad):
    """Phase 8's hot reload of the int8 server: 4a's weights moved by a
    seeded 0.01 N(0, 1), published onto ``--path`` while requests are in
    flight; the candidate re-calibrated on the card while the old twin
    serves, swapped on a batch boundary; every request in flight answered
    200; the int8 path's launches in each batch after the swap; four
    answers after the swap bit for bit against the candidate quantized in
    this process on the same device from the re-derived sidecar, two of
    them against it quantized on the CPU.  Returns the ``reload`` record."""
    import numpy as np

    from unicore_tpu_torch.serve import build_infer_fn

    q = cfg["quant_serve"]
    cand = write_moved_checkpoint(torch, path, Path(path).parent / "candidate.pt",
                                  cfg["seed"] + 80)
    in_flight = KeepSending(server.base + "/v1/infer",
                            [{"tokens": r} for r in reqs], workers=4)
    t0 = time.monotonic()
    try:
        publish(cand, path)
        wait_log(server, "RELOAD SWAPPED")
    finally:
        answered = in_flight.stop()
    reload_s = time.monotonic() - t0
    text = server.log_text()
    recal = next((ln for ln in text.splitlines()
                  if "QUANT-PATH int8: reload candidate re-calibrated" in ln), None)
    if recal is None:
        raise AssertionError(f"no reload-calibrated QUANT-PATH line:\n{text[-6000:]}")
    bad = [(c, b) for c, b in answered if c != 200]
    if bad or not answered:
        raise AssertionError(f"requests in flight across the reload: {len(answered)} sent, "
                             f"not 200: {bad[:5]}")
    code, st = http("GET", server.base + "/stats")
    quant = st["quant"]
    if st["reloads_applied"] != 1 or quant["source"] != "calibrated" \
            or quant["rel_drift"] >= q["rel_drift_bound"]["int8"]:
        raise AssertionError(f"after the reload: reloads_applied {st['reloads_applied']}, "
                             f"quant {quant}")
    # the swapped-in twin's launches over a few batches: the int8 path's
    # (the drift probe's and the reload thread's counted apart)
    small = sorted(range(len(reqs)), key=lambda i: len(reqs[i]))[:2]
    more = sorted(range(len(reqs)), key=lambda i: -len(reqs[i]))[:2]
    code, before = http("GET", server.base + "/stats")
    picked = small + more
    served = [http("POST", server.base + "/v1/infer", {"tokens": reqs[i]})[1] for i in picked]
    code, st2 = http("GET", server.base + "/stats")
    batches = st2["batches"] - before["batches"]
    launches = {k: n - before["kernel_launches"].get(k, 0)
                for k, n in st2["kernel_launches"].items()}
    per_batch = quant_per_batch(q["layers"], "int8")
    if cfg["device"].type == "cuda":
        for k, n in per_batch.items():
            if batches <= 0 or launches.get(k, 0) != n * batches:
                raise AssertionError(f"after the swap {k}: {launches.get(k, 0)} launches for "
                                     f"{batches} batches, want {n} per batch")
    # every answer after the swap against the candidate quantized from the
    # sidecar the reload re-derived, built in this process as the server
    # builds it (weights quantized on the same device), on the batch the
    # engine formed (each request alone, rows padded to the batch): ids and
    # score bit for bit
    dev = cfg["device"]
    model, model_q = load_quantized(torch, path, "int8", dev)
    infer = build_infer_fn(dev)
    for i, body in zip(picked, served):
        arr = np.full((cfg["batch"], body["bucket"]), pad, np.int32)
        arr[0, : len(reqs[i])] = reqs[i]
        ids_t, score_t = infer(model_q, arr)
        if body["output"] != ids_t[0, : len(reqs[i])].tolist() \
                or body["score"] != float(score_t[0]):
            same = int((np.asarray(body["output"]) == ids_t[0, : len(reqs[i])]).sum())
            raise AssertionError(f"after the reload, a request of {len(reqs[i])} tokens: ids "
                                 f"{same}/{len(reqs[i])} and score {body['score']} against "
                                 f"the re-derived twin's {float(score_t[0])}")
    # the card's twin against the same quantized on the CPU through the
    # plain versions, on the two shortest rows at their bucket: the served
    # scores within ``reload_score_rel`` of the CPU's; each twin's logits
    # within the JAX package's int8 drift bound (of the fp32 logit absmax)
    # of its own device's fp32 candidate, and so the two twins within twice
    # it of each other.  A W8A8 network re-rounds its activations at every
    # site, so two twins whose sums differ in a last bit drift apart about
    # as far as either drifts from fp32, and no top-2 gap below that
    # separates a near tie from a fault: the ids against the CPU's past a
    # gap of twice the score bound of the logit absmax are recorded.
    after = served[:2]
    bucket = min(b["bucket"] for b in after)
    rows = [reqs[i] for i in small]
    arr = np.full((len(rows), bucket), pad, np.int32)
    for r, toks in enumerate(rows):
        arr[r, : len(toks)] = toks
    with torch.inference_mode():
        tokens = torch.as_tensor(arr, dtype=torch.long, device=dev)
        card_q = model_q(tokens).float().cpu().numpy()
        card_f = model(tokens).float().cpu().numpy()
    del model, model_q
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    model, model_q = load_quantized(torch, path, "int8", "cpu")
    logits, ids, score = cpu_logits(torch, model_q, rows, bucket, pad)
    logits_f, _, score_fp32 = cpu_logits(torch, model, rows, bucket, pad)
    del model, model_q
    bound, drift_bound = q["reload_score_rel"], q["rel_drift_bound"]["int8"]
    absmax = float(np.abs(logits_f).max())
    valid = np.zeros(arr.shape, bool)
    for r, toks in enumerate(rows):
        valid[r, : len(toks)] = True
    dist = {name: float(np.abs(a - b)[valid].max()) / absmax for name, a, b in (
        ("card_int8_vs_cpu_int8", card_q, logits), ("card_int8_vs_card_fp32", card_q, card_f),
        ("cpu_int8_vs_cpu_fp32", logits, logits_f), ("card_fp32_vs_cpu_fp32", card_f, logits_f))}
    gap = 2 * bound * float(np.abs(logits).max())
    agree, total, excluded = gapped_agreement(after, logits, ids, gap)
    rel = [abs(b["score"] - float(score[row])) / max(abs(float(score[row])), 1e-6)
           for row, b in enumerate(after)]
    rel_fp32 = [abs(b["score"] - float(score_fp32[row])) / max(abs(float(score_fp32[row])), 1e-6)
                for row, b in enumerate(after)]
    if max(rel) > bound or dist["card_int8_vs_cpu_int8"] > 2 * drift_bound \
            or dist["card_int8_vs_card_fp32"] > drift_bound \
            or dist["cpu_int8_vs_cpu_fp32"] > drift_bound:
        raise AssertionError(f"after the reload vs the CPU: score rel err {max(rel)} (bound "
                             f"{bound}; the fp32 candidate's {max(rel_fp32)}), max |logit "
                             f"distance| / absmax {dist} (bound {drift_bound}, twice it "
                             f"between the int8 twins)")
    swapped = next(ln for ln in text.splitlines() if "RELOAD SWAPPED" in ln)
    events = [e.get("event") or e.get("outcome") for e in journal_events(path)
              if e["kind"] in ("quant-path", "serve-reload")]
    for want in ("reload-calibrated", "swapped", "swapped-in"):
        if want not in events:
            raise AssertionError(f"journal lacks {want}: {events}")
    res = {"reload_s": reload_s, "in_flight_answered_200": len(answered),
           "rel_drift": quant["rel_drift"], "max_abs_logit_drift": quant["max_abs_logit_drift"],
           "launches_after_swap": launches, "batches_after_swap": batches,
           "per_batch_want": per_batch,
           "twin_bit_equal": {"requests": len(served),
                              "ids": sum(len(reqs[i]) for i in picked)},
           "cpu_agreement": {"ids_equal": agree, "ids": total, "ids_within_gap": excluded,
                             "gap": gap, "score_rel_err": max(rel),
                             "score_rel_bound": bound,
                             "score_rel_err_vs_fp32_candidate": max(rel_fp32),
                             "max_abs_logit_distance_over_absmax": dist,
                             "drift_bound": drift_bound},
           "recalibrated": recal.split("QUANT-PATH", 1)[1].strip(),
           "swapped": swapped.split("RELOAD SWAPPED: ", 1)[1].strip(),
           "device_memory_mib": st.get("device_memory_mib"),
           "device_memory_peak_mib": st.get("device_memory_peak_mib")}
    log(f"int8 reload: {json.dumps(res)}")
    return res


def drive_quant_serving(torch, cfg, path, card, smi, mode):
    """``python -m unicore_tpu_torch.cli.serve --serve-quantize <mode>
    --quant-drift-sample 1`` on phase 4a's checkpoint: the ``QUANT-PATH``
    line, the sidecar, /stats' ``precision`` and ``quant`` block with every
    request's drift sampled, the calibration drift within the JAX package's
    bound, the serving path's launches per batch (the drift probe's counted
    apart), for int8 two answers against this process's CPU on
    the same sidecar; SIGTERM drains and exits 0.  Prints the
    ``quant_serve`` line and returns the serving path's launches."""
    import numpy as np

    from unicore_tpu_torch import checkpoint_utils, tasks
    from unicore_tpu_torch.quant import calibrate

    q = cfg["quant_serve"]
    lengths = q["lengths"] if mode == "int8" else q["lengths"][: q["fp8_requests"]]
    state = checkpoint_utils.load_checkpoint_to_cpu(str(path))
    task = tasks.setup_task(state["args"])
    vocab, pad = len(task.dictionary), task.dictionary.pad()
    del state
    t0 = time.monotonic()
    argv = ["--serve-batch-size", str(cfg["batch"]), "--serve-buckets", "4",
            "--serve-quantize", mode, "--quant-drift-sample", "1"]
    if mode == "int8":
        argv += ["--reload-interval", "0.5"]  # the hot reload after the main path
    server = Server(path, cfg, argv, name=f"quant_serve_{mode}")
    try:
        server.wait_ready(cfg["ready_budget_s"])
        startup_s = time.monotonic() - t0
        line = next((ln for ln in server.log_text().splitlines()
                     if f"QUANT-PATH {mode}:" in ln), None)
        sidecar = calibrate.scales_path(str(path))
        if line is None or f"scales at {sidecar}" not in line or not os.path.exists(sidecar):
            raise AssertionError(f"no QUANT-PATH line naming {sidecar}:\n"
                                 f"{server.log_text()[-6000:]}")
        log(f"{mode} server ready after {startup_s:.1f}s: {line.split('QUANT-PATH', 1)[1]}")
        rng = np.random.default_rng(cfg["seed"] + 8)
        reqs = [rng.integers(5, vocab, size=n).tolist() for n in lengths]
        code, before = http("GET", server.base + "/stats")
        assert code == 200, before

        def send(toks):
            t = time.monotonic()
            code, body = http("POST", server.base + "/v1/infer", {"tokens": toks})
            return code, body, (time.monotonic() - t) * 1e3

        half = len(reqs) // 2
        results = [send(r) for r in reqs[:half]]
        with ThreadPoolExecutor(max_workers=cfg["batch"]) as pool:
            results += list(pool.map(send, reqs[half:]))
        deadline = time.monotonic() + 60  # the last batch's drift sample follows it
        while True:
            code, after = http("GET", server.base + "/stats")
            assert code == 200, after
            if after["quant"]["request_drift"]["samples"] >= len(reqs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        buckets = set()
        for toks, (code, body, _) in zip(reqs, results):
            if code != 200 or len(body["output"]) != len(toks) \
                    or not math.isfinite(body["score"]):
                raise AssertionError(f"request of {len(toks)} tokens: {code} {body}")
            buckets.add(body["bucket"])
        if mode == "int8" and buckets != set(after["buckets"]):
            raise AssertionError(f"buckets hit {sorted(buckets)} != {after['buckets']}")
        quant = after["quant"]
        if after["precision"] != mode or quant["mode"] != mode \
                or quant["rel_drift"] >= q["rel_drift_bound"][mode] \
                or quant["request_drift"]["samples"] != len(reqs):
            raise AssertionError(f"/stats precision {after['precision']}, quant {quant}")

        batches = after["batches"] - before["batches"]

        def delta(key):
            a, b = after.get(key, {}), before.get(key, {})
            return {k: a.get(k, 0) - b.get(k, 0) for k in a}

        launches, probe = delta("kernel_launches"), delta("probe_kernel_launches")
        want = quant_per_batch(q["layers"], mode)
        log(f"quant main path ({mode}): {len(reqs)} requests in {batches} batches, "
            f"serving launches {launches}, drift probe launches {probe} "
            f"(want per batch {want})")
        if batches <= 0:
            raise AssertionError("no batch was served")
        if cfg["device"].type == "cuda":
            for k, n in want.items():
                if launches.get(k, 0) != n * batches:
                    raise AssertionError(f"{k}: {launches.get(k, 0)} launches for "
                                         f"{batches} batches, want {n} per batch")
            fp = quant_per_batch(q["layers"], "fp8")  # the fp32 model's, less its LM head
            probe_want = {k: want[k] + fp[k] for k in want}
            probe_want["fused_norm_fwd"] += 1  # the fp32 LM head's norm is a kernel
            for k, n in probe_want.items():
                if probe.get(k, 0) != n * batches:
                    raise AssertionError(f"drift probe {k}: {probe.get(k, 0)} launches "
                                         f"for {batches} batches, want {n} per batch")

        agreement = None
        if mode == "int8":  # two answers of the smallest bucket against the CPU
            small = [i for i, (_, b, _) in enumerate(results)
                     if b["bucket"] == min(buckets)][:2]
            ids, score = cpu_quant_reference(torch, path, mode, [reqs[i] for i in small],
                                             min(buckets), pad)
            agree = total_ids = 0
            worst = 0.0
            for row, i in enumerate(small):
                got = np.asarray(results[i][1]["output"])
                agree += int((got == ids[row, : len(got)]).sum())
                total_ids += len(got)
                rel = (abs(results[i][1]["score"] - float(score[row]))
                       / max(abs(float(score[row])), 1e-6))
                worst = max(worst, rel)
            if agree < 0.99 * total_ids or worst > 1e-3:
                raise AssertionError(f"{mode} answers vs the CPU: ids {agree}/{total_ids}, "
                                     f"score rel err {worst}")
            agreement = {"requests": len(small), "ids_equal": agree, "ids": total_ids,
                         "score_rel_err": worst}
            log(f"quant CPU agreement: {json.dumps(agreement)}")
        reload = quant_reload(torch, cfg, server, path, reqs, vocab, pad) \
            if mode == "int8" else None

        server.proc.send_signal(signal.SIGTERM)
        rc = server.proc.wait(timeout=180)
        if rc != 0 or "DRAIN complete" not in server.log_text():
            raise AssertionError(f"drain exit {rc}:\n{server.log_text()[-6000:]}")
        lat = np.asarray([r[2] for r in results])
        res = {
            "mode": mode, "requests": len(reqs), "batches": batches,
            "startup_s": startup_s,
            "client_p50_ms": float(np.percentile(lat, 50)),
            "client_p99_ms": float(np.percentile(lat, 99)),
            "server_p50_ms": after.get("p50_ms"), "server_p99_ms": after.get("p99_ms"),
            "calibration": {k: quant[k] for k in (
                "source", "sites", "rel_drift", "max_abs_logit_drift",
                "mean_abs_logit_drift", "ref_logit_absmax", "batches")},
            "request_drift": quant["request_drift"], "launches": launches,
            "probe_launches": probe, "per_batch_want": want, "cpu_agreement": agreement,
            "reload": reload, "arch": cfg["arch"], "card": card, "nvidia_smi": smi,
        }
        print(f"quant_serve_{mode} " + json.dumps(res), flush=True)
        return launches
    finally:
        server.stop()


def check_decode_parity(torch, cfg, path):
    """In this process on the card, at full width: a batch of prompts in the
    smallest cache bucket, prefilled, then decoded step by step over dense
    caches, against the full causal forward's logits on the same card
    (1e-4 absolute and relative, as the JAX package's parity test)."""
    from unicore_tpu_torch.ops import _kernels

    p, dev = cfg["decode"]["parity"], cfg["device"]
    model = load_lm(torch, path, dev)
    B, P, steps, Lc = p["batch"], p["prompt"], p["steps"], p["cache"]
    toks = torch.randint(5, model.vocab_size, (B, P + steps),
                         generator=torch.Generator().manual_seed(11)).to(dev)
    with torch.inference_mode():
        full = model(toks)[:, P:].float()
        _, (k, v) = model.prefill(toks[:, :P])
        nl, _, H, _, D = k.shape
        kc = torch.zeros(nl, B, H, Lc, D, device=dev)
        vc = torch.zeros_like(kc)
        kc[:, :, :, :P], vc[:, :, :, :P] = k, v
        _kernels.reset_launch_counts()
        rows = []
        for t in range(P, P + steps):
            logits, (kr, vr) = model.decode_step(
                toks[:, t], (kc, vc), torch.full((B,), t, dtype=torch.int32, device=dev))
            kc[:, :, :, t], vc[:, :, :, t] = kr, vr
            rows.append(logits.float())
        got = torch.stack(rows, dim=1)
    launches = _kernels.launch_counts()
    err = (got - full).abs()
    res = {"batch": B, "prompt": P, "steps": steps, "cache": Lc,
           "max_abs_err": err.max().item(),
           "max_err_over_tol": (err / (1e-4 + 1e-4 * full.abs())).max().item(),
           "decode_attention_launches": launches.get("decode_attention", 0)}
    log(f"decode parity (incremental vs full forward, {dev.type}): {json.dumps(res)}")
    if not res["max_err_over_tol"] <= 1.0:
        raise AssertionError(f"incremental decode differs from the full forward: {res}")
    if dev.type == "cuda" and res["decode_attention_launches"] != steps * model.decoder_layers:
        raise AssertionError(f"decode parity launched {launches}")
    del model
    return res


def profile_decode_steps(torch, cfg, path, lm, card, smi):
    """Decode steps of the served configuration in this process: a
    ``DecodeEngine`` at batch 8 in the top bucket, every sequence deep in
    it, stepped through the engine's own decode dispatch (gather, model,
    scatter, the greedy pick, the host read of it); their wall time
    unprofiled, then the same steps under ``torch.profiler`` for device
    time by kernel group.  The idle share is the part of the unprofiled
    wall time the device time does not fill."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from unicore_tpu_torch.serve import DecodeEngine

    p, dev = cfg["decode"]["profile"], cfg["device"]
    eng = DecodeEngine(load_lm(torch, path, dev), bucket_edges=(p["bucket"],),
                       decode_batch=p["batch"], prefill_batch=p["batch"],
                       num_pages=cfg["decode"]["cache_pages"], pad_idx=lm["pad"],
                       eos_idx=lm["eos"], vocab_size=lm["vocab"], device=card)
    eng.warmup()
    with torch.inference_mode():
        gen = torch.Generator(device=dev).manual_seed(12)
        eng.cache.k_pool.normal_(generator=gen)
        eng.cache.v_pool.normal_(generator=gen)
    pages = [eng.cache.alloc(eng.cache.pages_for(p["bucket"])) for _ in range(p["batch"])]
    table = np.stack([eng.cache.table(pg, p["bucket"]) for pg in pages])
    tokens = np.random.default_rng(13).integers(5, lm["vocab"], p["batch"]).astype(np.int32)

    def run():
        for i in range(p["steps"]):
            eng._dispatch_decode_arrays(
                tokens, np.full((p["batch"],), p["start"] + i, np.int32), table)

    run()  # warm
    t0 = time.perf_counter()
    run()
    wall_us = (time.perf_counter() - t0) * 1e6
    res = {"steps": p["steps"], "batch": p["batch"], "bucket": p["bucket"],
           "positions": [p["start"], p["start"] + p["steps"] - 1],
           "step_wall_ms": wall_us / p["steps"] / 1e3, "card": card, "nvidia_smi": smi}
    if dev.type == "cuda":
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kinds = (("decode_attention", ("decode_attention",)),) + KERNEL_GROUPS
        groups = {name: 0.0 for name, _ in kinds}
        groups["other"] = 0.0
        top = []
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
                continue
            name = next((g for g, keys in kinds if any(k in ev.key for k in keys)), "other")
            groups[name] += ev.self_device_time_total
            top.append((ev.self_device_time_total, ev.key[:90], ev.count))
        busy = sum(groups.values())
        top.sort(reverse=True)
        res.update({
            "device_busy_ms_per_step": busy / p["steps"] / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy / wall_us),
            "device_ms_per_step_by_group": {k: v / p["steps"] / 1e3
                                            for k, v in groups.items()},
            "top_kernels": [{"name": n, "device_ms_per_step": t / p["steps"] / 1e3,
                             "calls": c} for t, n, c in top[:12]],
            "profiled": f"{p['steps']} decode steps after {p['steps']} warm ones and an "
                        "unprofiled timing of the same steps, in-process",
        })
    print("decode_profile " + json.dumps(res), flush=True)
    del eng


# ---------------------------------------------------------------------------
# phase 9: causal-LM training with validation, EMA, checkpoints and resume
# ---------------------------------------------------------------------------

def lm_train_argv(cfg, data, save_dir, device, *extra):
    m = cfg["lm_train"]
    return [
        str(data), "--device", device, "--task", "causal_lm", "--loss", "lm_cross_entropy",
        "--arch", m["arch"], *m["extra_args"], "--seq-pad-multiple", "128",
        "--length-bucket", "4", "--batch-size", str(cfg["batch"]), "--update-freq", "2",
        "--max-update", str(m["updates"]), "--optimizer", "adam",
        "--adam-betas", "(0.9, 0.98)", "--adam-eps", "1e-6", "--weight-decay", "0.01",
        "--clip-norm", "1.0", "--lr-scheduler", "inverse_sqrt", "--lr", str(m["lr"]),
        "--warmup-updates", "5", "--ema-decay", "0.999", "--validate-with-ema",
        "--validate-interval-updates", str(m["interval"]),
        "--save-interval-updates", str(m["interval"]), "--log-interval", "1",
        "--save-dir", str(save_dir), "--seed", str(cfg["seed"] + 2), *extra,
    ]


def lm_launch_check(cfg, stats, valid_batches):
    """The LM's launches from a stats line: per forward (a micro-batch or a
    validation batch) one full-row forward a layer and two norm forwards a
    layer plus the embedding and final norms; per micro-batch the same
    counts of backwards.  On the CPU: none."""
    layers, micro = cfg["lm_train"]["layers"], stats["micro_batches"]
    forwards = micro + valid_batches * len(stats["validations"])
    want = {"fullrow_attention_fwd": layers * forwards,
            "fullrow_attention_bwd": layers * micro,
            "fused_norm_fwd": (2 * layers + 2) * forwards,
            "fused_norm_dx": (2 * layers + 2) * micro,
            "fused_norm_dwdb": (2 * layers + 2) * micro}
    launches = stats["kernel_launches"]
    if cfg["device"].type != "cuda":
        want = {}
    for k in set(launches) | set(want):
        if launches.get(k, 0) != want.get(k, 0):
            raise AssertionError(f"{k}: {launches.get(k, 0)} launches for {micro} "
                                 f"micro-batches and {forwards - micro} validation "
                                 f"batches, want {want.get(k, 0)} ({launches})")
    return launches


def drive_lm_training(torch, cfg, data, card, smi):
    """9a: the train CLI on the full ``transformer_lm`` with validation, the
    EMA and interval checkpoints; then 9b: a new run (the CLI's ``main`` in
    this process, :func:`train_in_process`) resumed from 9a's mid-epoch
    checkpoint.  Prints ``lm_train``, on the card
    ``lm_profile`` (one update of 9a's configuration in this process), and
    ``lm_resume``; returns (9a's save dir, 9a's launches)."""
    m = cfg["lm_train"]
    write_split(cfg, data, "valid", m["valid_docs"], cfg["seed"] + 100)
    valid_batches = -(-m["valid_docs"] // cfg["batch"])
    dev = cfg["device"]
    t = {"updates": m["updates"], "per_micro_batch": {}}
    save_dir = fresh_dir(WORK / "lm_ckpt")
    stats = run_train_cli("lm_train", lm_train_argv(cfg, data, save_dir, dev.type), dev,
                          t, m["timeout_s"], in_process=True)
    launches = lm_launch_check(cfg, stats, valid_batches)
    interval = m["interval"]
    names = sorted(os.listdir(save_dir))
    want_names = {"checkpoint_best.pt", f"checkpoint_1_{interval}.pt", "checkpoint_last.pt"}
    if not want_names <= set(names):
        raise AssertionError(f"lm_train: checkpoints {names}, want {sorted(want_names)}")
    if [v["update"] for v in stats["validations"]] != list(
            range(interval, m["updates"] + 1, interval)):
        raise AssertionError(f"lm_train: validations {stats['validations']}")
    if not all(math.isfinite(v["loss"]) for v in stats["validations"]):
        raise AssertionError(f"lm_train: non-finite valid loss: {stats['validations']}")
    steady = stats["step_ms"][1:]
    train = {
        "arch": m["arch"], "extra_args": m["extra_args"], "updates": stats["updates"],
        "micro_batches": stats["micro_batches"], "batch": cfg["batch"], "update_freq": 2,
        "micro_batch_lengths": sorted(set(stats["micro_batch_lengths"])),
        "loss_per_update": stats["loss_per_update"], "lr_per_update": stats["lr_per_update"],
        "validations": stats["validations"], "best": stats["best"],
        "median_step_ms": stats["median_step_ms"],
        "step_ms_min_max": [min(steady), max(steady)] if steady else None,
        "tokens": stats["tokens"], "tokens_per_s": stats["tokens_per_s"],
        "peak_memory_bytes": stats["peak_memory_bytes"], "launches": launches,
        "checkpoints": names, "wall_s": stats["wall_s"], "card": card, "nvidia_smi": smi,
    }
    print("lm_train " + json.dumps(train), flush=True)
    if dev.type == "cuda":
        profile_cli_update(torch, cfg, lm_train_argv(cfg, data, WORK / "unused", "cuda"),
                           "lm_profile", card, smi)

    # 9b: resume from the mid-epoch checkpoint into a fresh --save-dir
    resumed_dir = fresh_dir(WORK / "lm_resume_ckpt")
    restore = save_dir / f"checkpoint_1_{interval}.pt"
    res = run_train_cli("lm_resume", lm_train_argv(
        cfg, data, resumed_dir, dev.type, "--restore-file", str(restore)), dev, t,
        m["timeout_s"], falling=False, in_process=True)
    ref_losses = stats["loss_per_update"][interval:]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(res["loss_per_update"], ref_losses))
    v_ref, v_res = stats["validations"][-1], res["validations"][-1]
    valid_rel = abs(v_res["loss"] - v_ref["loss"]) / abs(v_ref["loss"])
    resume = {
        "resumed_from_update": res["resumed_from_update"], "restore_file": restore.name,
        "updates": res["updates"], "loss_per_update": res["loss_per_update"],
        "loss_max_rel_diff": loss_rel, "lrs_equal":
            res["lr_per_update"] == stats["lr_per_update"][interval:],
        "valid_loss": v_res["loss"], "valid_loss_uninterrupted": v_ref["loss"],
        "valid_loss_rel_diff": valid_rel, "tolerance": 1e-4, "card": card,
        "nvidia_smi": smi,
    }
    print("lm_resume " + json.dumps(resume), flush=True)
    if not (res["resumed_from_update"] == interval and resume["lrs_equal"]
            and len(res["loss_per_update"]) == len(ref_losses) == m["updates"] - interval
            and v_res["update"] == v_ref["update"] == m["updates"]
            and loss_rel <= 1e-4 and valid_rel <= 1e-4):
        raise AssertionError(f"the resumed run differs from the uninterrupted one: {resume}")
    return save_dir, stats


def lm_card_vs_cpu_setup(torch, cfg, data, L, pad_multiple, attn_dropout, *flags):
    """9d's path at length ``L`` (a 2-layer full-width ``transformer_lm``,
    3 updates of 2 micro-batches) with ``flags`` added to its arguments:
    (args, task, model, loss, the micro-batches of each update, 2
    validation batches)."""
    import numpy as np

    from unicore_tpu_torch import options
    from unicore_tpu_torch.models.transformer_lm import TransformerLMModel
    from unicore_tpu_torch.tasks.causal_lm import CausalLMTask

    c = cfg["lm_train"]["card_vs_cpu"]
    args = options.parse_args_and_arch(options.get_training_parser(), lm_train_argv(
        cfg, data, WORK / "unused", "cpu", "--max-update", str(c["updates"]),
        "--seq-pad-multiple", str(pad_multiple), *flags))
    task = CausalLMTask.setup_task(args)
    vocab, pad = len(task.dictionary), task.dictionary.pad()
    model = TransformerLMModel(
        vocab_size=vocab, padding_idx=pad, decoder_layers=2,
        decoder_embed_dim=args.decoder_embed_dim,
        decoder_ffn_embed_dim=args.decoder_ffn_embed_dim,
        decoder_attention_heads=args.decoder_attention_heads,
        max_seq_len=args.max_seq_len, dropout=0.0, emb_dropout=0.0,
        attention_dropout=attn_dropout, generator=torch.Generator().manual_seed(8))
    rng = np.random.default_rng(12 + L)
    B = c["batch"]

    def batch():
        lens = rng.integers(L // 2, L + 1, B)
        lens[0] = L
        src = rng.integers(5, vocab, (B, L))
        src[np.arange(L)[None, :] >= lens[:, None]] = pad
        return {"net_input": {"src_tokens": src}, "target": src}

    samples = [batch() for _ in range(2 * c["updates"])]
    valid = [batch() for _ in range(2)]
    groups = [samples[2 * i:2 * i + 2] for i in range(c["updates"])]
    return args, task, model, task.build_loss(args), groups, valid


def drive_lm_card_vs_cpu(torch, cfg, data, *flags, lengths=None, tag="LM card vs CPU"):
    """9d: a 2-layer full-width ``transformer_lm`` trained on the card and on
    the CPU from the same weights and batches (3 updates of 2 micro-batches)
    at each length of ``c["lengths"]``, with the EMA, then validated on its
    weights: loss 1e-4, gnorm 1e-3 relative, parameters and EMA 1e-5
    absolute, valid loss 1e-4 relative.  Returns the card's launches by
    length."""
    import copy

    from unicore_tpu_torch.ops import _kernels
    from unicore_tpu_torch.trainer import Trainer

    c = cfg["lm_train"]["card_vs_cpu"]
    out = {}
    for L, pad_multiple, attn_dropout in lengths or c["lengths"]:
        args, task, model, loss, groups, valid = lm_card_vs_cpu_setup(
            torch, cfg, data, L, pad_multiple, attn_dropout, *flags)

        def run(device):
            tr = Trainer(args, task, copy.deepcopy(model), loss, device)
            tr.begin_epoch(1)
            gnorms = [tr.train_step(group) for group in groups]
            totals = {}
            with tr.eval_weights():
                for s in valid:
                    for k, v in tr.valid_step(s).items():
                        totals[k] = totals.get(k, 0) + float(v)
            params = {n: p.detach().cpu() for n, p in tr.model.named_parameters()}
            ema = {n: e.cpu() for n, e in tr.ema.shadow.items()}
            return (tr.update_losses, gnorms, params, ema,
                    totals["loss"] / totals["sample_size"] / math.log(2))

        _kernels.reset_launch_counts()
        card = run(cfg["device"])
        card_launches = _kernels.launch_counts()
        _kernels.reset_launch_counts()
        cpu = run(torch.device("cpu"))
        cpu_launches = _kernels.launch_counts()
        res = {
            "seq_len": L, "seq_pad_multiple": pad_multiple, "attention_dropout": attn_dropout,
            "losses_card": card[0], "losses_cpu": cpu[0],
            "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0])),
            "gnorm_rel": max(abs(a - b) / abs(b) for a, b in zip(card[1], cpu[1])),
            "param_max_abs_diff": max((card[2][n] - cpu[2][n]).abs().max().item()
                                      for n in cpu[2]),
            "ema_max_abs_diff": max((card[3][n] - cpu[3][n]).abs().max().item()
                                    for n in cpu[3]),
            "valid_loss_card": card[4], "valid_loss_cpu": cpu[4],
            "valid_rel": abs(card[4] - cpu[4]) / abs(cpu[4]),
            "card_launches": {k: v for k, v in card_launches.items() if v},
        }
        log(f"{tag}: {json.dumps(res)}")
        if sum(cpu_launches.values()):
            raise AssertionError(f"the CPU run launched kernels: {cpu_launches}")
        if cfg["device"].type == "cuda":
            route = ("fullrow_attention_fwd", "fullrow_attention_bwd") if L % 128 == 0 else ()
            need = route + ("fused_norm_fwd", "fused_norm_dx", "fused_norm_dwdb")
            if not all(card_launches.get(k, 0) > 0 for k in need):
                raise AssertionError(f"L={L}: the card run missed a kernel: {card_launches}")
        if not (res["loss_rel"] <= 1e-4 and res["gnorm_rel"] <= 1e-3
                and res["param_max_abs_diff"] <= 1e-5 and res["ema_max_abs_diff"] <= 1e-5
                and res["valid_rel"] <= 1e-4):
            raise AssertionError(f"L={L}: card and CPU disagree: {res}")
        out[L] = res
    return out


# ---------------------------------------------------------------------------
# phase 10: mixed-precision training (--bf16 with the fp32 master and
# --bf16-sr, --fp16 with the dynamic loss scale)
# ---------------------------------------------------------------------------

#: the bf16 update by kernel group: :data:`BERT_GROUPS` with the products
#: on cuBLAS's tensor cores named as such; ``optimizer`` (the trainer's
#: range: Adam on the master, the copy-back with its stochastic rounding,
#: the EMA) is split out by :func:`profile_update`
BF16_GROUPS = BERT_GROUPS[:4] + (("bf16_matmul", KERNEL_GROUPS[2][1]),) + BERT_GROUPS[5:]


def loss_rel_diffs(got, ref):
    return [abs(a - b) / abs(b) for a, b in zip(got, ref)]


def matmul_reduction_cost(torch, card, smi):
    """What the train CLI's ``allow_bf16_reduced_precision_reduction =
    False`` (bf16 products summed in fp32 throughout) costs cuBLAS: BERT-base's
    FFN products in bf16, (4096, 768) x (768, 3072) and (4096, 3072) x
    (3072, 768), timed with reduced-precision reductions allowed and not,
    in turns (allowed, not, not, allowed; the faster of each pair).  Prints
    ``bf16_matmul_reduction``; leaves the setting False."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    flag = torch.backends.cuda.matmul
    out = {}
    for name, (M, K, N) in {"fc1": (4096, 768, 3072), "fc2": (4096, 3072, 768)}.items():
        a = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
        b = torch.randn(K, N, generator=g, device=dev).to(torch.bfloat16)
        times = {True: [], False: []}
        for allow in (True, False, False, True):
            flag.allow_bf16_reduced_precision_reduction = allow
            times[allow].append(time_ms(torch, lambda: a @ b, dev, iters=200)[0])
        fp32_sum, reduced = min(times[False]), min(times[True])
        out[name] = {"shape": [M, K, N], "fp32_reduction_ms": fp32_sum,
                     "reduced_allowed_ms": reduced, "cost": fp32_sum / reduced - 1.0,
                     "tflops_fp32_reduction": 2 * M * K * N / fp32_sum / 1e9}
    flag.allow_bf16_reduced_precision_reduction = False
    print("bf16_matmul_reduction " + json.dumps(dict(out, card=card, nvidia_smi=smi)),
          flush=True)


def drive_bf16_training(torch, cfg, data, fp32_stats, card, smi):
    """10a: phase 4a's configuration (same corpus, seed and arguments) plus
    ``--bf16 --bf16-sr``: the launches per micro-batch of 4a, a falling
    loss, each update's loss within ``tol`` relative of 4a's fp32 loss at
    the same update (same batches; the Philox keep masks and the elementwise
    dropout masks do not depend on the type).  Prints ``bf16_train`` and,
    on the card, ``bf16_profile``.  Returns the run's launches."""
    b = cfg["bf16"]
    dev = cfg["device"]
    # 4a ran before phase 9 wrote the valid split: no validation, as in 4a
    flags = ["--bf16", "--bf16-sr", "--disable-validation"]
    # this process's products as the train CLI sets them under --bf16/--fp16
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    stats = run_train_cli("bf16_train", train_argv(cfg, data, fresh_dir(WORK / "bf16_ckpt"),
                                                   dev.type) + flags,
                          dev, cfg["train"], cfg["train"]["timeout_s"], in_process=True)
    rel = loss_rel_diffs(stats["loss_per_update"], fp32_stats["loss_per_update"])
    line = {
        "arch": cfg["arch"], "flags": flags, "dtype": stats["dtype"],
        "bf16_sr": stats["bf16_sr"], "updates": stats["updates"],
        "micro_batches": stats["micro_batches"], "loss_per_update": stats["loss_per_update"],
        "fp32_loss_per_update": fp32_stats["loss_per_update"],
        "loss_max_rel_diff_vs_fp32": max(rel), "tolerance": b["loss_rel"],
        "median_step_ms": stats["median_step_ms"],
        "fp32_median_step_ms": fp32_stats["median_step_ms"],
        "tokens_per_s": stats["tokens_per_s"], "fp32_tokens_per_s": fp32_stats["tokens_per_s"],
        "peak_memory_bytes": stats["peak_memory_bytes"],
        "fp32_peak_memory_bytes": fp32_stats["peak_memory_bytes"],
        "step_ms": stats["step_ms"], "launches": stats["kernel_launches"], "card": card,
        "nvidia_smi": smi,
    }
    print("bf16_train " + json.dumps(line), flush=True)
    if not (stats["dtype"] == "bfloat16" and stats["bf16_sr"] and max(rel) <= b["loss_rel"]):
        raise AssertionError(f"bf16_train: dtype {stats['dtype']}, sr {stats['bf16_sr']}, "
                             f"loss vs fp32 {max(rel)} (tol {b['loss_rel']} rel)")
    if dev.type == "cuda":
        profile_cli_update(torch, cfg, train_argv(cfg, data, WORK / "unused", "cuda") + flags,
                           "bf16_profile", card, smi, BF16_GROUPS)
        matmul_reduction_cost(torch, card, smi)
    return stats


def drive_lm_bf16_training(torch, cfg, data, fp32_stats, card, smi):
    """10b: phase 9a's configuration plus ``--bf16``: its exact launches, a
    falling loss, each update's loss and the valid losses within ``tol``
    relative of 9a's; then a new run (the CLI's ``main`` in this process)
    resumed from its
    ``checkpoint_1_{interval}.pt`` (the fp32 master from the optimizer
    state: the low bits that a master rebuilt from the bf16 weights would
    lose, counted in the checkpoint) with 9a's lrs, losses and last valid
    loss within ``resume_rel``.  Prints ``lm_bf16_train`` and
    ``lm_bf16_resume``; returns the run's launches."""
    m, b = cfg["lm_train"], cfg["bf16"]
    dev = cfg["device"]
    interval = m["interval"]
    valid_batches = -(-m["valid_docs"] // cfg["batch"])
    t = {"updates": m["updates"], "per_micro_batch": {}}
    save_dir = fresh_dir(WORK / "lm_bf16_ckpt")
    stats = run_train_cli("lm_bf16_train", lm_train_argv(cfg, data, save_dir, dev.type,
                                                         "--bf16"), dev, t, m["timeout_s"],
                          in_process=True)
    launches = lm_launch_check(cfg, stats, valid_batches)
    rel = loss_rel_diffs(stats["loss_per_update"], fp32_stats["loss_per_update"])
    v_rel = loss_rel_diffs([v["loss"] for v in stats["validations"]],
                           [v["loss"] for v in fp32_stats["validations"]])
    restore = save_dir / f"checkpoint_1_{interval}.pt"
    state = load_state(restore)
    master = state["optimizer_state"]["master"]
    low_bits = sum(int((mt != state["model"][n].float()).sum()) for n, mt in master.items())
    total = sum(mt.numel() for mt in master.values())
    line = {
        "arch": m["arch"], "dtype": stats["dtype"], "updates": stats["updates"],
        "loss_per_update": stats["loss_per_update"],
        "fp32_loss_per_update": fp32_stats["loss_per_update"], "loss_max_rel_diff": max(rel),
        "validations": stats["validations"], "fp32_validations": fp32_stats["validations"],
        "valid_loss_max_rel_diff": max(v_rel), "tolerance": b["loss_rel"],
        "median_step_ms": stats["median_step_ms"],
        "fp32_median_step_ms": fp32_stats["median_step_ms"],
        "tokens_per_s": stats["tokens_per_s"], "peak_memory_bytes": stats["peak_memory_bytes"],
        "launches": launches, "checkpoint_master_share_off_bf16": low_bits / total,
        "card": card, "nvidia_smi": smi,
    }
    print("lm_bf16_train " + json.dumps(line), flush=True)
    if not (stats["dtype"] == "bfloat16" and len(v_rel) == m["updates"] // interval
            and max(rel) <= b["loss_rel"] and max(v_rel) <= b["loss_rel"]
            and all(mt.dtype == torch.float32 for mt in master.values()) and low_bits > 0):
        raise AssertionError(f"lm_bf16_train against 9a: {line}")

    res = run_train_cli("lm_bf16_resume", lm_train_argv(
        cfg, data, fresh_dir(WORK / "lm_bf16_resume_ckpt"), dev.type, "--bf16",
        "--restore-file", str(restore)), dev, t, m["timeout_s"], falling=False,
        in_process=True)
    r_rel = loss_rel_diffs(res["loss_per_update"], stats["loss_per_update"][interval:])
    v_ref, v_res = stats["validations"][-1], res["validations"][-1]
    valid_rel = abs(v_res["loss"] - v_ref["loss"]) / abs(v_ref["loss"])
    resume = {
        "resumed_from_update": res["resumed_from_update"], "restore_file": restore.name,
        "loss_per_update": res["loss_per_update"], "loss_max_rel_diff": max(r_rel),
        "lrs_equal": res["lr_per_update"] == stats["lr_per_update"][interval:],
        "valid_loss": v_res["loss"], "valid_loss_uninterrupted": v_ref["loss"],
        "valid_loss_rel_diff": valid_rel, "tolerance": b["resume_rel"], "card": card,
        "nvidia_smi": smi,
    }
    print("lm_bf16_resume " + json.dumps(resume), flush=True)
    if not (res["resumed_from_update"] == interval and resume["lrs_equal"]
            and len(r_rel) == m["updates"] - interval and v_res["update"] == m["updates"]
            and max(r_rel) <= b["resume_rel"] and valid_rel <= b["resume_rel"]):
        raise AssertionError(f"the resumed bf16 run differs from the uninterrupted one: {resume}")
    return launches


def drive_fp16_training(torch, cfg, data, card, smi):
    """10c: phase 4a's configuration with ``--fp16 --fp16-init-scale 128
    --fp16-scale-window 4`` for ``updates`` updates: finite falling losses,
    the norms' launches of 4a and no attention or softmax kernel (the JAX
    package routes fp16 attention to its plain composition), and the loss
    scale of every update as the schedule gives it for the run's own
    overflows (non-finite gradient norms), grown at least once.  Then
    ``--fp16-init-scale 2**120`` (:func:`in_process_run`, no start-up of
    its own): the first two updates overflow, are skipped (no optimizer
    step) and halve the scale, with the norms' launches of 4a.
    Prints ``fp16_train``; returns the first run's launches."""
    from unicore_tpu_torch.optim.dynamic_loss_scaler import init_scale_state, scale_schedule

    f = cfg["fp16"]
    dev = cfg["device"]
    t = {"updates": f["updates"], "per_micro_batch": f["per_micro_batch"]}
    window, init = 4, 128
    flags = ["--fp16", "--fp16-scale-window", str(window), "--max-update", str(f["updates"]),
             "--total-num-update", str(f["updates"]), "--disable-validation"]
    stats = run_train_cli("fp16_train", train_argv(cfg, data, fresh_dir(WORK / "fp16_ckpt"),
                                                   dev.type)
                          + flags + ["--fp16-init-scale", str(init)],
                          dev, t, cfg["train"]["timeout_s"], in_process=True)
    st, want = init_scale_state(init), []
    for g in stats["gnorm_per_update"]:
        want.append(float(st["scale"]))
        st, _ = scale_schedule(st, not math.isfinite(g), scale_window=window)
    # the forced overflows in this process (no second start-up): the train
    # CLI's trainer for the same arguments, its first two updates
    from unicore_tpu_torch.ops import _kernels

    _kernels.reset_launch_counts()
    tr, _ = in_process_run(torch, cfg, train_argv(cfg, data, WORK / "unused", dev.type)
                           + flags + ["--fp16-init-scale", str(2 ** 120), "--max-update", "2"],
                           2)
    over_launches = _kernels.launch_counts()
    over = {"loss_scale": tr.update_loss_scales, "overflows": tr.overflows}
    steps = tr._optimizer.num_steps
    for k, n in f["per_micro_batch"].items():
        need = n * tr.micro_batches if dev.type == "cuda" else 0
        if over_launches.get(k, 0) != need:
            raise AssertionError(f"fp16_overflow: {k}: {over_launches.get(k)} launches, "
                                 f"want {need}")
    del tr
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    line = {
        "arch": cfg["arch"], "dtype": stats["dtype"], "updates": stats["updates"],
        "loss_per_update": stats["loss_per_update"], "loss_scale": stats["loss_scale"],
        "loss_scale_schedule": want, "gnorm_per_update": stats["gnorm_per_update"],
        "overflows": stats["overflows"], "median_step_ms": stats["median_step_ms"],
        "tokens_per_s": stats["tokens_per_s"], "peak_memory_bytes": stats["peak_memory_bytes"],
        "launches": stats["kernel_launches"],
        "forced_overflow": {"loss_scale": over["loss_scale"], "overflows": over["overflows"],
                            "optimizer_steps": steps},
        "card": card, "nvidia_smi": smi,
    }
    print("fp16_train " + json.dumps(line), flush=True)
    if not (stats["dtype"] == "float16" and stats["loss_scale"] == want and max(want) > init
            and over["loss_scale"] == [2.0 ** 120, 2.0 ** 119] and over["overflows"] == 2
            and steps == 0):
        raise AssertionError(f"fp16_train: {line}")
    return stats["kernel_launches"]


def bf16_compare(torch, cfg, tag, args, task, model, loss, groups, need):
    """One family's training path in bf16 (no SR) on the card and on the CPU
    from the same weights and batches (``groups``: the micro-batches of
    each update): loss and gradient norm within ``loss_rel`` /
    ``gnorm_rel`` relative, each update's change to the fp32 master within
    ``master_rel`` in L2 over all parameters, and on each side the bf16
    parameters the nearest-even rounding of its own master, bit for bit;
    the card ran each kernel of ``need``."""
    import copy

    from unicore_tpu_torch.ops import _kernels
    from unicore_tpu_torch.trainer import Trainer

    b = cfg["bf16"]["card_vs_cpu"]

    def run(device):
        tr = Trainer(args, task, copy.deepcopy(model), loss, device)
        tr.begin_epoch(1)
        gnorms, deltas = [], []
        for group in groups:
            before = {n: mt.clone() for n, mt in tr._optimizer.master.items()}
            gnorms.append(tr.train_step(group))
            deltas.append({n: (mt - before[n]).cpu() for n, mt in tr._optimizer.master.items()})
        rne = all(torch.equal(p.detach(), tr._optimizer.master[n].to(p.dtype))
                  for n, p in tr.params.items())
        return tr.update_losses, gnorms, deltas, rne, str(tr.compute_dtype)

    _kernels.reset_launch_counts()
    card = run(cfg["device"])
    card_launches = _kernels.launch_counts()
    _kernels.reset_launch_counts()
    cpu = run(torch.device("cpu"))
    cpu_launches = _kernels.launch_counts()
    master_rel = []
    for dc, dp in zip(card[2], cpu[2]):
        ref = math.sqrt(sum(float(d.square().sum()) for d in dp.values()))
        diff = math.sqrt(sum(float((dc[n] - d).square().sum()) for n, d in dp.items()))
        master_rel.append(diff / ref if ref > 0 else (0.0 if diff == 0 else math.inf))
    res = {
        "family": tag, "dtype": card[4], "losses_card": card[0], "losses_cpu": cpu[0],
        "gnorm_card": card[1], "gnorm_cpu": cpu[1],
        "loss_rel": max(loss_rel_diffs(card[0], cpu[0])),
        "gnorm_rel": max(loss_rel_diffs(card[1], cpu[1])),
        "master_change_rel_l2": master_rel, "params_rne_of_master": [card[3], cpu[3]],
        "tolerances": b, "card_launches": {k: v for k, v in card_launches.items() if v},
    }
    log(f"bf16 card vs CPU: {json.dumps(res)}")
    if sum(cpu_launches.values()):
        raise AssertionError(f"{tag}: the CPU run launched kernels: {cpu_launches}")
    if cfg["device"].type == "cuda" and not all(card_launches.get(k, 0) > 0 for k in need):
        raise AssertionError(f"{tag}: the card run missed a kernel of {need}: {card_launches}")
    if not (card[4] == cpu[4] == "torch.bfloat16" and res["loss_rel"] <= b["loss_rel"]
            and res["gnorm_rel"] <= b["gnorm_rel"] and max(master_rel) <= b["master_rel"]
            and card[3] and cpu[3]):
        raise AssertionError(f"{tag}: bf16 card and CPU disagree: {res}")
    return res


def drive_bf16_card_vs_cpu(torch, cfg, data, um_data, evo_data):
    """10d: :func:`bf16_compare` on the card-against-CPU paths of 4b (a
    2-layer full-width BERT-base), 5b (Uni-Mol at 2 layers), 6b (a 2-block
    Evoformer) and 9d (a 2-layer full-width LM at L = 256), each with its
    attention dropout, plus ``--bf16``.  Prints ``bf16_card_vs_cpu``."""
    norms = ("fused_norm_fwd", "fused_norm_dx", "fused_norm_dwdb")
    fullrow = ("fullrow_attention_fwd", "fullrow_attention_bwd")
    flash = tuple(k for k, v in KERNELS.items() if v[2] == "evoformer_train")
    lm = cfg["lm_train"]["card_vs_cpu"]["lengths"][0]
    out = {
        "bert": bf16_compare(torch, cfg, "bert",
                             *bert_card_vs_cpu_setup(torch, cfg, data, "--bf16"),
                             fullrow + norms),
        "unimol": bf16_compare(torch, cfg, "unimol",
                               *unimol_card_vs_cpu_setup(torch, cfg, um_data, "--bf16"),
                               ("softmax_dropout_fwd", "softmax_dropout_bwd") + norms),
        "evoformer": bf16_compare(torch, cfg, "evoformer",
                                  *evoformer_card_vs_cpu_setup(torch, cfg, evo_data, "--bf16"),
                                  flash + norms),
        "lm": bf16_compare(torch, cfg, "lm",
                           *lm_card_vs_cpu_setup(torch, cfg, data, *lm, "--bf16")[:5],
                           fullrow + norms),
    }
    print("bf16_card_vs_cpu " + json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 11: the optimizer and loader plane (--fused-adam, --grad-accum
# adama, --per-sample-clip-norm, sgd, --nan-rerun, the loader threads and
# the device prefetcher)
# ---------------------------------------------------------------------------

#: the fused update by kernel group: K-a and K-b apart, then :data:`BF16_GROUPS`
FUSED_GROUPS = (("fused_adam", ("fused_adam",)),
                ("multi_tensor_l2norm", ("l2norm",))) + BF16_GROUPS


def fused_launch_check(tag, stats, per_update):
    """K-a and K-b launched ``per_update`` times each update (one per dtype
    group) in a run's stats; none on the CPU."""
    launches = stats["kernel_launches"]
    want = per_update * stats["updates"] if stats["device"] != "cpu" else 0
    for k in ("multi_tensor_l2norm", "fused_adam"):
        if launches.get(k, 0) != want:
            raise AssertionError(f"{tag}: {k}: {launches.get(k, 0)} launches over "
                                 f"{stats['updates']} updates, want {want}")


def drive_fused_training(torch, cfg, data, bf16_stats, card, smi):
    """11a: 10a's run (BERT-base, ``--bf16 --bf16-sr``, same corpus, seed
    and arguments) plus ``--fused-adam --num-workers 2
    --prefetch-to-device``: each update's loss within 2% relative of 10a's
    (the SR noise differs: not bit for bit), 4a's launches per micro-batch,
    exactly one K-a and one K-b launch per update (one dtype group); step
    ms, update wall ms, tokens/s and peak memory beside 10a's
    (``fused_train``).  On the card one update in-process under
    ``torch.profiler`` (``fused_profile``: K-a and K-b, the optimizer's
    kernels, beside ``bf16_profile``'s ``optimizer`` range).  Returns the
    run's stats."""
    from unicore_tpu_torch.distributed import utils as distributed_utils

    p = cfg["phase11"]
    dev = cfg["device"]
    flags = ["--bf16", "--bf16-sr", "--disable-validation", *p["fused_flags"]]
    # 15a: under a process group of one rank (NCCL on the card)
    group = ["--distributed-world-size", "1", "--distributed-init-method",
             f"tcp://localhost:{distributed_utils.free_port()}"]
    # 16a: the telemetry flags; /metrics scraped while the run goes on
    t = cfg["phase16"]
    port = distributed_utils.free_port()
    tele = ["--log-format", "json", "--log-interval", str(t["log_interval"]),
            "--telemetry-sample-interval", str(t["sample_interval"]),
            "--profile-steps", f"{t['profile'][0]}:{t['profile'][1]}",
            "--metrics-port", str(port),
            "--tensorboard-logdir", str(fresh_dir(WORK / "fused_tb"))]
    scrapes = []

    def scrape():
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2) as r:
                text = r.read().decode()
        except OSError:
            return  # not bound yet, or gone
        if "unicore_tpu_train_updates_total" in text:
            scrapes.append(text)

    save_dir = fresh_dir(WORK / "fused_ckpt")
    stats = run_train_cli("fused_train", train_argv(cfg, data, save_dir, dev.type)
                          + flags + group + tele, dev, cfg["train"], cfg["train"]["timeout_s"],
                          watch=scrape)
    stats["telemetry"] = {"flags": tele, "scrapes": scrapes, "save_dir": str(save_dir),
                          "log": str(WORK / "fused_train.log")}
    fused_launch_check("fused_train", stats, 1)
    want_backend = "nccl" if dev.type == "cuda" else "gloo"
    red = stats.get("distributed") or {}
    if red.get("backend") != want_backend or red.get("world_size") != 1:
        raise AssertionError(f"15a: fused_train ran without a one-rank {want_backend} "
                             f"group: {red}")
    rel = loss_rel_diffs(stats["loss_per_update"], bf16_stats["loss_per_update"])
    line = {
        "flags": flags, "telemetry_flags": tele, "updates": stats["updates"],
        "micro_batches": stats["micro_batches"],
        "loss_per_update": stats["loss_per_update"],
        "bf16_loss_per_update": bf16_stats["loss_per_update"],
        "loss_max_rel_diff_vs_bf16": max(rel), "tolerance": p["fused_loss_rel"],
        "median_step_ms": stats["median_step_ms"],
        "bf16_median_step_ms": bf16_stats["median_step_ms"],
        "median_update_wall_ms": stats["median_update_wall_ms"],
        "bf16_median_update_wall_ms": bf16_stats["median_update_wall_ms"],
        "tokens_per_s": stats["tokens_per_s"], "bf16_tokens_per_s": bf16_stats["tokens_per_s"],
        "peak_memory_bytes": stats["peak_memory_bytes"],
        "bf16_peak_memory_bytes": bf16_stats["peak_memory_bytes"],
        "step_ms": stats["step_ms"], "launches": stats["kernel_launches"],
        "distributed": red, "first_loss_equals_bf16": (stats["loss_per_update"][0]
                                                      == bf16_stats["loss_per_update"][0]),
        "card": card, "nvidia_smi": smi,
    }
    print("fused_train " + json.dumps(line), flush=True)
    if max(rel) > p["fused_loss_rel"]:
        raise AssertionError(f"fused_train: loss vs 10a {max(rel)} (tol {p['fused_loss_rel']})")
    if dev.type == "cuda":
        profile_cli_update(torch, cfg, train_argv(cfg, data, WORK / "unused", "cuda") + flags,
                           "fused_profile", card, smi, FUSED_GROUPS, split_optimizer=False,
                           one_rank_group=True)
    return stats


def drive_fused_card_vs_cpu(torch, cfg, data):
    """11b: 4b's path with ``--fused-adam`` (fp32, 3 updates) at 4b's
    tolerances, K-a and K-b launched on the card; then on the device a
    checkpoint written after one ``--fused-adam`` update and resumed with
    and without the flag: the next two updates' losses within 1e-5
    relative of each other and of the uninterrupted run."""
    import copy

    from unicore_tpu_torch.trainer import Trainer

    drive_card_vs_cpu(torch, cfg, data, "--fused-adam", tag="fused card vs CPU",
                      need=["multi_tensor_l2norm", "fused_adam"])
    args, task, model, loss, groups = bert_card_vs_cpu_setup(torch, cfg, data, "--fused-adam")
    dev = cfg["device"]
    ckpt = fresh_dir(WORK / "fused_resume") / "checkpoint_1.pt"

    def trainer(fused):
        a = copy.copy(args)
        a.fused_adam = fused
        tr = Trainer(a, task, copy.deepcopy(model), loss, dev)
        tr.begin_epoch(1)
        return tr

    full = trainer(True)
    for group in groups:
        full.train_step(group)
    first = trainer(True)
    first.train_step(groups[0])
    first.save_checkpoint(str(ckpt), {})
    losses = {}
    for fused in (True, False):
        tr = trainer(fused)
        tr.load_checkpoint(str(ckpt))
        for group in groups[1:]:
            tr.train_step(group)
        losses[fused] = tr.update_losses
    rel = max(loss_rel_diffs(losses[False], losses[True])
              + loss_rel_diffs(losses[True], full.update_losses[1:]))
    res = {"resumed_with_flag": losses[True], "resumed_without_flag": losses[False],
           "uninterrupted": full.update_losses[1:], "max_rel_diff": rel, "tolerance": 1e-5}
    log(f"fused cross-flag resume: {json.dumps(res)}")
    if not rel <= 1e-5:
        raise AssertionError(f"fused cross-flag resume: {res}")


def drive_adama(torch, cfg, data, card, smi):
    """11c: 9d's LM path at L=256 with ``--grad-accum adama`` (its
    tolerances: the adama fold runs in the same torch ops on both sides);
    then the full-width LM (9a's arguments, no validation or checkpoint)
    for ``adama_updates`` updates in buffer mode and in adama, each the
    CLI's ``main`` in this process (:func:`train_in_process`: the two peaks
    both count what this process holds): both peak memories (``adama_lm``
    line), the launches of 9a, falling losses."""
    p = cfg["phase11"]
    L = cfg["lm_train"]["card_vs_cpu"]["lengths"][0]
    drive_lm_card_vs_cpu(torch, cfg, data, "--grad-accum", "adama", lengths=[L],
                         tag="adama LM card vs CPU")
    runs = {}
    t = dict(cfg["lm_train"], updates=p["adama_updates"], per_micro_batch={})
    for mode in ("buffer", "adama"):
        argv = lm_train_argv(cfg, data, fresh_dir(WORK / f"adama_{mode}"), cfg["device"].type,
                             "--max-update", str(p["adama_updates"]), "--grad-accum", mode,
                             "--disable-validation", "--no-save")
        stats = run_train_cli(f"lm_{mode}", argv, cfg["device"], t, t["timeout_s"],
                              in_process=True)
        lm_launch_check(cfg, stats, 0)
        runs[mode] = stats
    line = {m: {k: r[k] for k in ("median_step_ms", "tokens_per_s", "peak_memory_bytes",
                                  "loss_per_update", "gnorm_per_update")}
            for m, r in runs.items()}
    line.update(card=card, nvidia_smi=smi,
                peak_memory_saved_bytes=(None if runs["buffer"]["peak_memory_bytes"] is None
                                         else runs["buffer"]["peak_memory_bytes"]
                                         - runs["adama"]["peak_memory_bytes"]))
    print("adama_lm " + json.dumps(line), flush=True)


def drive_loader(cfg, um_data, um_stats, card, smi):
    """11d: 5a's Uni-Mol run plus ``--num-workers 4 --prefetch-to-device``:
    each update's loss within 1e-4 relative of 5a's (the same batches in the
    same order; a batch lost or out of order moves a loss far more), the
    same consumed position after every update, 5a's launches; the step
    median beside 5a's (``unimol_loader`` line)."""
    p = cfg["phase11"]
    u = cfg["unimol"]
    argv = unimol_argv(u, um_data, fresh_dir(WORK / "unimol_loader"),
                       cfg["device"].type) + p["loader_flags"]
    stats = run_train_cli("unimol_loader", argv, cfg["device"], u["train"],
                          u["train"]["timeout_s"], in_process=True)
    rel = loss_rel_diffs(stats["loss_per_update"], um_stats["loss_per_update"])
    line = {"flags": p["loader_flags"], "loss_max_rel_diff_vs_5a": max(rel),
            "tolerance": p["loader_loss_rel"],
            "iterations_in_epoch": stats["iterations_in_epoch"],
            "iterations_in_epoch_5a": um_stats["iterations_in_epoch"],
            "median_step_ms": stats["median_step_ms"],
            "median_step_ms_5a": um_stats["median_step_ms"], "step_ms": stats["step_ms"],
            "median_update_wall_ms": stats["median_update_wall_ms"],
            "median_update_wall_ms_5a": um_stats["median_update_wall_ms"],
            "card": card, "nvidia_smi": smi}
    print("unimol_loader " + json.dumps(line), flush=True)
    if not (max(rel) <= p["loader_loss_rel"]
            and stats["iterations_in_epoch"] == um_stats["iterations_in_epoch"]):
        raise AssertionError(f"unimol_loader: {line}")


def drive_nan_rerun(torch, cfg, data):
    """11e (last part): a 2-layer BERT-base checkpoint with a NaN written
    into one named weight, fine-tuned by the train CLI's ``main`` (in this
    process, :func:`train_in_process`) with ``--nan-rerun`` on the card and
    on the CPU: both raise ``FloatingPointError`` naming the same module."""
    import re

    from unicore_tpu_torch import checkpoint_utils, options, tasks

    p = cfg["phase11"]
    extra = ["--encoder-layers", "2", "--batch-size", "2", "--max-update", "1", "--nan-rerun"]
    args = options.parse_args_and_arch(
        options.get_training_parser(), train_argv(cfg, data, WORK / "unused", "cpu") + extra)
    task = tasks.setup_task(args)
    model = task.build_model(args, generator=torch.Generator().manual_seed(5))
    state = model.state_dict()
    state[p["poison"] + ".weight"][0, 0] = float("nan")
    path = fresh_dir(WORK / "nan_ckpt") / "poisoned.pt"
    checkpoint_utils.write_checkpoint(str(path), args, state)
    named = {}
    for device in sorted({cfg["device"].type, "cpu"}):
        argv = train_argv(cfg, data, fresh_dir(WORK / f"nan_{device}"), device) + extra + [
            "--finetune-from-model", str(path)]
        log_path = WORK / f"nan_rerun_{device}.log"
        raised = None
        try:
            train_in_process(log_path, argv)
        except FloatingPointError as err:
            raised = f"FloatingPointError: {err}"
        found = re.findall(r"FloatingPointError: non-finite gradients detected: NaN/Inf "
                           r"detected in forward output of (\S+?);", raised or "")
        if not found:
            raise AssertionError(f"nan_rerun on {device}: raised {raised!r}, {found}:\n"
                                 f"{log_path.read_text()[-4000:]}")
        named[device] = {"raised": "FloatingPointError", "module": found[-1]}
    line = dict(named, poisoned=p["poison"])
    print("nan_rerun " + json.dumps(line), flush=True)
    if {v["module"] for v in named.values()} != {p["poison"]}:
        raise AssertionError(f"nan_rerun: {line}")


def drive_optimizer_paths(torch, cfg, data):
    """11e: 4b's path at its tolerances with ``--per-sample-clip-norm 0.1``
    (batch 4, dropout 0) and with ``--optimizer sgd --momentum 0.9``, then
    :func:`drive_nan_rerun`."""
    p = cfg["phase11"]
    drive_card_vs_cpu(torch, cfg, data, "--per-sample-clip-norm", str(p["per_sample_clip"]),
                      tag="per_sample_clip card vs CPU", batch=p["per_sample_batch"],
                      attention_dropout=0.0)
    drive_card_vs_cpu(torch, cfg, data, "--optimizer", "sgd", "--momentum", "0.9",
                      tag="sgd card vs CPU")
    drive_nan_rerun(torch, cfg, data)


#: phase 11's settings, shared by the card and the rehearsal
PHASE11 = {
    "fused_flags": ["--fused-adam", "--num-workers", "2", "--prefetch-to-device"],
    "fused_loss_rel": 0.02, "adama_updates": 10,
    "loader_flags": ["--num-workers", "4", "--prefetch-to-device"], "loader_loss_rel": 1e-4,
    "per_sample_clip": 0.1, "per_sample_batch": 4,
    "poison": "sentence_encoder.layers.1.self_attn.in_proj",
}

# ---------------------------------------------------------------------------
# phase 12: the training robustness plane (the health sentinel, verified v2
# checkpoints with the corrupt-file fallback, the async publish, the
# preemption and on-error emergency saves)
# ---------------------------------------------------------------------------

#: run in place of ``-m unicore_tpu_torch.cli.train`` for 12b: the train CLI
#: with ``Trainer.restore_health_snapshot`` wrapped, so that right after the
#: rewind the restored state is held bit for bit against the checkpoint the
#: same run wrote at the snapshot's update; the verdict goes to argv[1]
REWIND_CHECK = r"""
import json, os, re, sys
import torch
from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.cli import train
from unicore_tpu_torch.trainer import Trainer

out_path, ckpt_dir = sys.argv[1], sys.argv[2]
restore = Trainer.restore_health_snapshot


def checked(self, snap):
    restore(self, snap)
    if self.device.type == "cuda":
        torch.cuda.synchronize(self.device)
    got = self.state_dict()
    (name,) = [n for n in os.listdir(ckpt_dir)
               if re.fullmatch(rf"checkpoint_\d+_{snap.step}\.pt", n)]
    want = checkpoint_utils.load_checkpoint_to_cpu(os.path.join(ckpt_dir, name))
    pairs = [("model." + k, v, want["model"][k]) for k, v in got["model"].items()]
    for group in ("state", "master"):
        for n, slots in got["optimizer_state"].get(group, {}).items():
            items = slots.items() if isinstance(slots, dict) else [("", slots)]
            ref = want["optimizer_state"][group][n]
            for k, v in items:
                pairs.append((f"{group}.{n}.{k}", v, ref[k] if k else ref))
    bad = [k for k, a, b in pairs
           if not (a.dtype == b.dtype and torch.equal(a.detach().cpu(), b))]
    res = {"checkpoint": name, "tensors": len(pairs), "mismatched": bad[:10],
           "n_mismatched": len(bad),
           "num_steps": [got["optimizer_state"]["num_steps"],
                         want["optimizer_state"]["num_steps"]],
           "num_updates": [self.get_num_updates(),
                           want["optimizer_history"][-1]["num_updates"]],
           "lr_scheduler_equal": got["optimizer_history"][-1]["lr_scheduler_state"]
           == want["optimizer_history"][-1]["lr_scheduler_state"],
           "bytes": snap.nbytes}
    with open(out_path, "w") as f:
        json.dump(res, f)


Trainer.restore_health_snapshot = checked
sys.exit(train.cli_main(sys.argv[3:]))
"""


def robust_argv(cfg, data, save_dir, *extra, sentinel=True):
    """Phase 11a's cell (BERT-base, ``--bf16 --bf16-sr --fused-adam
    --num-workers 2 --prefetch-to-device``, no validation) for
    ``p["updates"]`` updates, with the sentinel's flags unless
    ``sentinel`` is False (``--sentinel-interval 0``), journaling into
    the phase's one ``--telemetry-dir``."""
    p = cfg["phase12"]
    n = str(p["updates"])
    return (train_argv(cfg, data, save_dir, cfg["device"].type)
            + ["--bf16", "--bf16-sr", "--disable-validation", *cfg["phase11"]["fused_flags"],
               "--max-update", n, "--total-num-update", n,
               # one journal directory for the phase (16b merges it)
               "--telemetry-dir", str(WORK / "robust_telemetry")]
            + (p["sentinel_flags"] if sentinel else ["--sentinel-interval", "0"])
            + list(extra))


def robust_t(cfg, updates=None):
    return {"updates": updates or cfg["phase12"]["updates"],
            "per_micro_batch": cfg["train"]["per_micro_batch"]}


def robust_launch_check(tag, stats):
    """K-a and K-b once for every update the run took (rewound ones too)."""
    launches = stats["kernel_launches"]
    want = len(stats["update_ids"]) if stats["device"] != "cpu" else 0
    for k in ("multi_tensor_l2norm", "fused_adam"):
        if launches.get(k, 0) != want:
            raise AssertionError(f"{tag}: {k}: {launches.get(k, 0)} launches for "
                                 f"{len(stats['update_ids'])} updates run")


def by_update(stats):
    """The loss of each update number (the last run of it after a rewind)."""
    return dict(zip(stats["update_ids"], stats["loss_per_update"]))


def walls_at(stats, updates):
    """The update wall ms of each update in ``updates`` (update u's wall
    runs from u-1's end to u's), from its first run where a rewind ran it
    twice."""
    walls = {}
    for u, ms in zip(stats["update_ids"][1:], stats["update_wall_ms"]):
        walls.setdefault(u, ms)
    return [walls[u] for u in updates if u in walls]


def drive_robust_control(cfg, data):
    """12a: the cell unarmed (``--sentinel-interval 0``) saving every two
    ``snapshot_every`` (the last save at the end) with ``--fault-inject
    bit-flip-checkpoint@flip_at``: the control whose losses and update
    walls 12b's armed run is held against (a save or a rotten file changes
    no loss), whose rotten files 12c resumes from, and whose losses 12d's
    resume must reproduce.  Returns its stats and its ``--save-dir``."""
    p = cfg["phase12"]
    flip_dir = fresh_dir(WORK / "robust_corrupt")
    off = run_train_cli("robust_flip", robust_argv(
        cfg, data, flip_dir, "--save-interval-updates", str(2 * p["snapshot_every"]),
        "--save-interval", "1000", "--fault-inject", f"bit-flip-checkpoint@{p['flip_at']}",
        sentinel=False), cfg["device"], robust_t(cfg), cfg["train"]["timeout_s"],
        in_process=True)
    robust_launch_check("robust_flip", off)
    return off, flip_dir


def drive_robust_rewind(cfg, data, off, card, smi):
    """12b: the cell armed (interval 1, snapshots every ``snapshot_every``,
    a ring of 2) with ``--fault-inject loss-spike:MAG@spike_at``, saving
    where 12a's control saves, through the train CLI with
    ``Trainer.restore_health_snapshot`` wrapped (``REWIND_CHECK``).

    Before the spike it is the healthy control (``robust_healthy``): no
    sentinel event, each update's loss within ``loss_rel`` relative of
    12a's unarmed run (the same batches: the sentinel reads, it does not
    perturb), a snapshot at every ``snapshot_every``-th update whose copies
    ran on the card; the update wall time at the snapshot updates (the
    capture's enqueue), at the updates after them (the copy overlapped with
    the forward and backward) and at the others, in both runs, leaving out
    the updates after a save and those the spike and the rewind touch; the
    snapshot bytes and the capture's host and device ms.

    The spike (``robust_rewind``): exactly one rewind, by ``loss-spike``,
    to the snapshot before the spike; the restored state (parameters, the
    fp32 master, the moments, the step counts, the lr scheduler) equal bit
    for bit to the checkpoint the run wrote at that update; the event in
    ``checkpoint_last.pt``'s ``extra_state["sentinel"]``; the run reaches
    ``--max-update`` with finite losses.  Returns the armed run's stats."""
    import numpy as np

    p = cfg["phase12"]
    dev = cfg["device"]
    every = p["snapshot_every"]
    save_every = 2 * every
    save_dir = fresh_dir(WORK / "robust_spike")
    target = p["spike_at"] // every * every
    argv = robust_argv(cfg, data, save_dir, "--save-interval-updates", str(save_every),
                       "--save-interval", "1000",
                       "--fault-inject", f"loss-spike:{p['magnitude']}@{p['spike_at']}")
    verdict = WORK / "robust_spike_restore.json"
    if verdict.exists():
        verdict.unlink()
    on = run_train_cli("robust_spike", argv, dev, robust_t(cfg), cfg["train"]["timeout_s"],
                       launcher=("-c", REWIND_CHECK, str(verdict), str(save_dir)))
    robust_launch_check("robust_spike", on)
    events = on["sentinel_events"]

    # before the spike: the healthy control
    first = {}
    for u, loss in zip(on["update_ids"], on["loss_per_update"]):
        first.setdefault(u, loss)
    pre = [u for u in sorted(first) if u < p["spike_at"]]
    rel = loss_rel_diffs([first[u] for u in pre], [by_update(off)[u] for u in pre])
    snap_updates = list(range(every, p["updates"] + 1, every))
    after = [u + 1 for u in snap_updates]
    touched = set(range(save_every + 1, p["updates"] + 2, save_every)) | {
        p["spike_at"], p["spike_at"] + 1}
    others = [u for u in range(3, p["updates"] + 1)
              if u not in snap_updates + after and u not in touched]
    after = [u for u in after if u not in touched]
    med = lambda xs: float(np.median(xs)) if xs else None  # noqa: E731
    line = {
        "updates": on["updates"], "sentinel_events_before_spike":
            [e for e in events if e["step"] < p["spike_at"]],
        "compared_updates": [pre[0], pre[-1]],
        "loss_max_rel_diff_vs_unarmed": max(rel), "tolerance": p["loss_rel"],
        "snapshots": on["snapshots"],
        "snapshot_bytes": on["snapshots"][0]["bytes"] if on["snapshots"] else None,
        "wall_ms_at_snapshot": walls_at(on, snap_updates),
        "wall_ms_after_snapshot": walls_at(on, after),
        "median_wall_ms_other": med(walls_at(on, others)),
        "unarmed_wall_ms_at_snapshot": walls_at(off, snap_updates),
        "unarmed_wall_ms_after_snapshot": walls_at(off, after),
        "unarmed_median_wall_ms_other": med(walls_at(off, others)),
        "median_step_ms": on["median_step_ms"], "unarmed_median_step_ms": off["median_step_ms"],
        "card": card, "nvidia_smi": smi,
    }
    print("robust_healthy " + json.dumps(line), flush=True)
    if (line["sentinel_events_before_spike"] or max(rel) > p["loss_rel"]
            or [s["update"] for s in on["snapshots"]] != snap_updates):
        raise AssertionError(f"robust_healthy: {line}")
    if dev.type == "cuda" and not all(s["copy_ms"] is not None for s in on["snapshots"]):
        raise AssertionError(f"robust_healthy: a capture did not run on the card: {line}")

    # the spike
    restore = json.loads(verdict.read_text()) if verdict.exists() else None
    last = load_state(save_dir / "checkpoint_last.pt")["extra_state"]["sentinel"]
    line = {"fault": "loss-spike", "magnitude": p["magnitude"], "spike_at": p["spike_at"],
            "events": events, "updates": on["updates"],
            "updates_run": len(on["update_ids"]), "update_ids": on["update_ids"],
            "loss_per_update": on["loss_per_update"],
            "gnorm_per_update": on["gnorm_per_update"], "restore": restore,
            "checkpoint_last_sentinel": last, "launches": on["kernel_launches"],
            "card": card, "nvidia_smi": smi}
    print("robust_rewind " + json.dumps(line), flush=True)
    if not (len(events) == 1 and events[0]["detector"] == "loss-spike"
            and events[0]["action"] == "rewind" and events[0]["target_step"] == target
            and all(math.isfinite(x) for x in on["loss_per_update"])
            and restore is not None and restore["n_mismatched"] == 0
            and restore["num_steps"][0] == restore["num_steps"][1]
            and restore["num_updates"] == [target, target] and restore["lr_scheduler_equal"]
            and restore["checkpoint"].endswith(f"_{target}.pt")
            and last is not None and last["events"] == events):
        raise AssertionError(f"robust_rewind: {line}")
    return on


def load_state(path):
    from unicore_tpu_torch import checkpoint_utils

    return checkpoint_utils.load_checkpoint_to_cpu(str(path))


def drive_robust_corrupt(cfg, data, first, save_dir, card, smi):
    """12c: 12a's unarmed run (``first``) saved every two
    ``snapshot_every`` updates under ``--fault-inject
    bit-flip-checkpoint@flip_at``: the interval checkpoint of the last
    update and the ``checkpoint_last.pt`` published from it are rotten; a
    resume in a new run (the CLI's ``main`` in this process,
    ``--checkpoint-write-version 1``) names the
    manifest mismatch of both, falls back to the newest intact checkpoint,
    resumes from its update and reaches ``--max-update``.  The v2 write
    seconds of the first run beside the v1 write of the second, and the
    async publish's seconds off the training thread (``robust_corrupt``)."""
    import re

    p = cfg["phase12"]
    every = 2 * p["snapshot_every"]
    intact = (p["flip_at"] - 1) // every * every
    resumed = run_train_cli("robust_fallback", robust_argv(
        cfg, data, save_dir, "--save-interval-updates", str(every), "--save-interval", "1000",
        "--checkpoint-write-version", "1", sentinel=False), cfg["device"], robust_t(cfg),
        cfg["train"]["timeout_s"], falling=False, in_process=True)
    text = (WORK / "robust_fallback.log").read_text()
    corrupt = re.findall(r"CHECKPOINT CORRUPT: (\S+) failed to load \(CorruptCheckpointError: "
                         r"[^)]*digest mismatch", text)
    loaded = re.findall(r"Loaded checkpoint (\S+) \(@ (\d+) updates\)", text)
    line = {"flip_at": p["flip_at"], "corrupt": [os.path.basename(c) for c in corrupt],
            "loaded": loaded, "resumed_from_update": resumed["resumed_from_update"],
            "updates": resumed["updates"],
            "v2_write_s": first["checkpoint_seconds"]["write"],
            "v2_publish_s": first["checkpoint_seconds"]["publish"],
            "v1_write_s": resumed["checkpoint_seconds"]["write"],
            "v1_publish_s": resumed["checkpoint_seconds"]["publish"],
            "checkpoint_bytes": {n: (save_dir / n).stat().st_size
                                 for n in sorted(os.listdir(save_dir))},
            "card": card, "nvidia_smi": smi}
    print("robust_corrupt " + json.dumps(line), flush=True)
    last = f"checkpoint_{(p['updates'] - 1) // p['epoch_updates'] + 1}_{p['updates']}.pt"
    if not (line["corrupt"][:2] == ["checkpoint_last.pt", last]
            and resumed["resumed_from_update"] == intact
            and resumed["updates"] == p["updates"]):
        raise AssertionError(f"robust_corrupt: {line}")


def drive_robust_preempt(cfg, data, control, card, smi):
    """12d: the armed cell with ``--preemption-save-deadline 60``, SIGTERM
    once update ``sigterm_after`` is logged: exit 0, a minimal
    ``checkpoint_last.pt`` (its ``emergency_save`` kind ``preempt``) at
    the update the run stopped at, nothing staged left behind; a new run
    (the CLI's ``main`` in this process) resumes it to ``--max-update``,
    each of its losses within
    ``loss_rel`` of 12a's control at the same update (phase 9's resume
    gate).  The resumes run unarmed: the detectors restart cold after a
    resume (their bands are not checkpointed, as in the JAX package), and a
    band of the few observations past the shortened warmup is too narrow
    to judge.  Then ``--fault-inject raise@raise_at
    --emergency-save-on-error`` saving every ``snapshot_every`` (the CLI's
    ``main`` in this process): the injected ``ChaosError`` out of it and
    ``checkpoint_emergency.pt`` beside ``checkpoint_last.pt``; the
    train CLI's restore decision for the next resume picks
    ``checkpoint_last.pt`` (the last save's) and never lists the emergency
    file among its fallbacks (``robust_preempt``)."""
    p = cfg["phase12"]
    dev = cfg["device"]
    save_dir = fresh_dir(WORK / "robust_preempt")
    argv = robust_argv(cfg, data, save_dir, "--preemption-save-deadline", "60")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    log_path = WORK / "robust_sigterm.log"
    mark = f"num_updates={p['sigterm_after']},"
    t0 = time.monotonic()
    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "unicore_tpu_torch.cli.train", *argv],
                                stdout=f, stderr=subprocess.STDOUT, cwd=str(ROOT), env=env)
        try:
            while mark not in log_path.read_text():
                if proc.poll() is not None or time.monotonic() - t0 > cfg["train"]["timeout_s"]:
                    raise AssertionError(f"robust_sigterm: never reached update "
                                         f"{p['sigterm_after']}:\n{log_path.read_text()[-4000:]}")
                time.sleep(0.02)
            signalled = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=300)
            exit_s = time.monotonic() - signalled
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    text = log_path.read_text()
    stats = json.loads([ln for ln in text.splitlines()
                        if ln.startswith("TRAIN stats ")][-1][len("TRAIN stats "):]) \
        if "TRAIN stats " in text else {}
    files = sorted(os.listdir(save_dir))
    stopped = stats.get("updates")
    saved = load_state(save_dir / "checkpoint_last.pt") if "checkpoint_last.pt" in files else {}
    ok = (rc == 0 and stats.get("stop_signal") == "SIGTERM" and "checkpoint_last.pt" in files
          and not any(n.endswith((".emg", ".tmp")) for n in files)
          and saved.get("extra_state", {}).get("emergency_save", {}).get("kind") == "preempt"
          and saved["optimizer_history"][-1]["num_updates"] == stopped)
    if not ok:
        raise AssertionError(f"robust_sigterm: exit {rc}, files {files}, stats "
                             f"{ {k: stats.get(k) for k in ('updates', 'stop_signal')} }:\n"
                             + text[-4000:])
    resumed = run_train_cli("robust_resume", robust_argv(cfg, data, save_dir, "--no-save",
                                                         sentinel=False),
                            dev, robust_t(cfg), cfg["train"]["timeout_s"], falling=False,
                            in_process=True)
    want = by_update(control)
    rel = loss_rel_diffs([v for u, v in by_update(resumed).items() if u > stopped],
                         [want[u] for u in by_update(resumed) if u > stopped])
    # the fatal error: raise at an update, with the emergency save on error
    err_dir = fresh_dir(WORK / "robust_error")
    err_argv = robust_argv(cfg, data, err_dir, "--save-interval-updates", str(p["snapshot_every"]),
                           "--emergency-save-on-error", "--fault-inject", f"raise@{p['raise_at']}")
    # the train CLI's main in this process: the injected error must
    # propagate out of it (the CLI then exits nonzero)
    err_rc = 0
    try:
        train_in_process(WORK / "robust_error.log", err_argv)
    except Exception as err:  # noqa: BLE001 -- the fault injected
        err_rc = type(err).__name__
    err_files = sorted(n for n in os.listdir(err_dir) if not n.endswith(".tmp"))
    emergency = load_state(err_dir / "checkpoint_emergency.pt") \
        if "checkpoint_emergency.pt" in err_files else {}
    last_good = p["raise_at"] // p["snapshot_every"] * p["snapshot_every"]
    # what the next resume loads: the train CLI's own restore decision
    # (``restore_session`` -> ``load_checkpoint``: ``_resolve_restore``,
    # then the fallback candidates of a corrupt file)
    from unicore_tpu_torch import checkpoint_utils, options

    err_args = options.parse_args_and_arch(options.get_training_parser(), err_argv)
    pick, _ = checkpoint_utils._resolve_restore(err_args, err_args.checkpoint_suffix)
    picked = load_state(pick)["optimizer_history"][-1]["num_updates"]
    fallbacks = [os.path.basename(f) for f in
                 checkpoint_utils._fallback_checkpoints(str(err_dir), "")]
    line = {"sigterm_after": p["sigterm_after"], "stopped_at": stopped, "exit": rc,
            "exit_s_after_signal": exit_s, "files": files,
            "resumed_from_update": resumed["resumed_from_update"],
            "resume_loss_max_rel_diff": max(rel) if rel else None, "tolerance": p["loss_rel"],
            "error_exit": err_rc, "error_files": err_files,
            "emergency_kind": emergency.get("extra_state", {}).get("emergency_save", {}).get(
                "kind"),
            "emergency_update": (emergency["optimizer_history"][-1]["num_updates"]
                                 if emergency else None),
            "error_resume_picks": [os.path.basename(pick), picked],
            "error_fallback_candidates": fallbacks,
            "card": card, "nvidia_smi": smi}
    print("robust_preempt " + json.dumps(line), flush=True)
    if not (resumed["resumed_from_update"] == stopped and rel and max(rel) <= p["loss_rel"]
            and err_rc == "ChaosError" and "checkpoint_emergency.pt" in err_files
            and "checkpoint_last.pt" in err_files and line["emergency_kind"] == "error"
            and line["error_resume_picks"] == ["checkpoint_last.pt", last_good]
            and "checkpoint_emergency.pt" not in fallbacks):
        raise AssertionError(f"robust_preempt: {line}")


# ---------------------------------------------------------------------------
# phase 16: training telemetry (the progress bars, the journal, the step
# spans, the --profile-steps window, /metrics, TensorBoard, the trace merger)
# ---------------------------------------------------------------------------

#: a train_inner line's stats, the JAX trainer's names in its order (by
#: priority) for 11a's flags: bf16 (no loss_scale), --clip-norm,
#: --prefetch-to-device; gb_free on a card only; the JAX recompiles stat
#: has no counterpart in eager PyTorch
TRAIN_INNER_KEYS = ["loss", "seq_len", "ups", "bsz", "num_updates", "lr", "gnorm", "clip",
                    "train_wall", "gb_free", "transfer_wall", "prefetch_wall", "host_blocked",
                    "device_busy"]

#: the CUDA kernels a BERT update launches on the main path, by their
#: launch counters: (counter, kernel function names, kernel launches a
#: counted call).  #2 is one call of two launches; #8/#9 one call of the
#: row pass and, with dw/db, the partials' sum; K-a a stage-1 launch per
#: buffer and one stage 2
PROFILE_KERNELS = (
    ("fullrow_attention_fwd", ("fullrow_fwd_kernel",), 1),
    ("fullrow_attention_bwd", ("fullrow_dq_kernel",), 1),
    ("fullrow_attention_bwd", ("fullrow_dkv_kernel",), 1),
    ("fused_norm_fwd", ("fused_norm_fwd_kernel", "fused_norm_fwd_wide_kernel"), 1),
    ("fused_norm_dx", ("fused_norm_bwd_kernel", "fused_norm_bwd_wide_kernel"), 1),
    ("fused_norm_dwdb", ("fused_norm_bwd_finish_kernel",), 1),
    ("multi_tensor_l2norm", ("l2norm_final_kernel",), 1),
    ("fused_adam", ("fused_adam_kernel",), 1),
)


def kernel_events(trace_path, names):
    """The CUDA kernel events of a ``torch.profiler`` Chrome trace whose
    (demangled) name holds each kernel function name of ``names`` as a
    whole identifier, counted by that name."""
    import re

    events = [ev.get("name", "") for ev in json.loads(Path(trace_path).read_text())["traceEvents"]
              if ev.get("cat") == "kernel"]
    return {n: sum(1 for ev in events
                   if re.search(rf"(?<![A-Za-z0-9_]){n}(?![A-Za-z0-9_])", ev))
            for n in names}


def tb_scalars(logdir, tag):
    """(step, value) of every ``tag`` scalar in the TensorBoard event files
    under ``logdir``, read as TFRecords with the Event proto of
    ``tensorboard`` or ``tensorboardX``, whichever is installed."""
    import struct

    try:
        from tensorboard.compat.proto.event_pb2 import Event
    except ImportError:
        from tensorboardX.proto.event_pb2 import Event
    out = []
    for path in sorted(Path(logdir).glob("events.out.tfevents.*")):
        data = path.read_bytes()
        pos = 0
        while pos + 12 <= len(data):
            (n,) = struct.unpack("<Q", data[pos:pos + 8])
            ev = Event()
            ev.ParseFromString(data[pos + 12:pos + 12 + n])
            pos += 12 + n + 4
            for v in ev.summary.value:
                if v.tag == tag and v.HasField("simple_value"):
                    out.append((ev.step, v.simple_value))
    return out


def check_train_telemetry(torch, cfg, stats, card, smi):
    """16a: the telemetry of 11a's run (``stats``, which carries the flags,
    the ``/metrics`` scrapes taken during the run and where it wrote): every
    JSON progress line parses, each ``train_inner`` line holds
    :data:`TRAIN_INNER_KEYS` and one ``train`` line ends each epoch; the
    journal holds one ``comm-plan``, the ``data_wait`` and ``dispatch``
    spans of every sampled update and its ``device_busy`` with the
    ``upper_bound`` flag (the last sampled update's probe excepted: it is
    collected at the next update's wait), ``h2d`` where the update's
    batches were copied on the training thread (the epoch's first: the
    prefetcher copies the others), ``profile-start`` at START and
    ``profile-stop`` at END, a ``checkpoint-save`` for each write and a
    ``fused-norm-path`` naming the CUDA kernel; the window's Chrome trace
    holds, for each kernel of :data:`PROFILE_KERNELS`, exactly the CLI's
    launches per update times the window's updates; a scrape shows
    ``unicore_tpu_train_updates_total`` of at least ``log_interval`` and
    the span gauges; TensorBoard: the ``loss`` scalars equal the JSON
    lines' values, or, with no writer installed, the one warning.  Read,
    not gated: the wall of the sampled, the profiled and the other updates,
    how far ``dispatch`` runs past ``device_busy``, and 11a's step and
    update-wall medians beside ``PERF.md``'s (``train_telemetry``)."""
    import numpy as np

    p = cfg["phase16"]
    dev = cfg["device"]
    tele = stats["telemetry"]
    start, end = p["profile"]
    n = stats["updates"]
    problems = []
    # the progress lines
    lines = []
    for ln in Path(tele["log"]).read_text().splitlines():
        parts = ln.split(" | ", 3)
        if len(parts) == 4 and parts[2] in ("train_inner", "train", "valid"):
            lines.append((parts[2], json.loads(parts[3])))
    want_keys = ["epoch", "update"] + [k for k in TRAIN_INNER_KEYS
                                       if k != "gb_free" or dev.type == "cuda"] + ["wall"]
    inner = [s for tag, s in lines if tag == "train_inner"]
    if len(inner) != n // p["log_interval"]:
        problems.append(f"{len(inner)} train_inner lines for {n} updates")
    bad_keys = [list(s) for s in inner if list(s) != want_keys]
    if bad_keys:
        problems.append(f"train_inner keys {bad_keys[0]} != {want_keys}")
    epochs = [s["epoch"] for tag, s in lines if tag == "train"]
    if not inner or epochs != list(range(1, inner[-1]["epoch"] + 1)):
        problems.append(f"train lines of epochs {epochs}: not one at each epoch's end")
    # the journal
    journal = [json.loads(x) for x in
               (Path(tele["save_dir"]) / "telemetry" / "events_rank0.jsonl").read_text()
               .splitlines()]
    kinds = [r["kind"] for r in journal]
    spans = {}
    for r in journal:
        if r["kind"] == "span":
            spans.setdefault(r["update"], {})[r["name"]] = r
    sampled = list(range(0, n, p["sample_interval"]))
    for u in sampled:
        got = spans.get(u, {})
        need = ["data_wait", "dispatch"] + (["device_busy"] if u != n - 1 else [])
        if u == 0:
            need.append("h2d")
        if any(k not in got for k in need) or ("device_busy" in got
                                               and "upper_bound" not in got["device_busy"]):
            problems.append(f"update {u}: spans {sorted(got)}, want {need}")
    if set(spans) - set(sampled):
        problems.append(f"spans of unsampled updates {sorted(set(spans) - set(sampled))}")
    edges = [(r["kind"], r["update"]) for r in journal if r["kind"].startswith("profile-")]
    if edges != [("profile-start", start), ("profile-stop", end)]:
        problems.append(f"profile edges {edges}")
    if kinds.count("comm-plan") != 1:
        problems.append(f"{kinds.count('comm-plan')} comm-plan records")
    if kinds.count("checkpoint-save") != len(stats["checkpoint_seconds"]["write"]):
        problems.append(f"{kinds.count('checkpoint-save')} checkpoint-save for "
                        f"{len(stats['checkpoint_seconds']['write'])} writes")
    norms = {(r["module"], r["dim"], r["path"]) for r in journal
             if r["kind"] == "fused-norm-path"}
    want_path = "cuda" if dev.type == "cuda" else "plain"
    if not norms or any(path != want_path for _, _, path in norms):
        problems.append(f"fused-norm-path {sorted(norms)}, want path {want_path}")
    # the profile window's kernels against the CLI's counters
    trace = next((Path(tele["save_dir"]) / "telemetry" / "profile_rank0").glob(
        "*.pt.trace.json"), None)
    window = {"trace": str(trace) if trace else None, "updates": end - start}
    if trace is None:
        problems.append("no profile trace")
    else:
        events = kernel_events(trace, [k for _, names, _ in PROFILE_KERNELS for k in names]
                               + ["l2norm_partial_kernel"])
        launches = stats["kernel_launches"]
        rows = []
        for counter, names, per_call in PROFILE_KERNELS:
            per_update = launches.get(counter, 0) / n
            want = per_update * per_call * (end - start)
            got = sum(events.get(k, 0) for k in names)
            rows.append({"counter": counter, "kernels": list(names),
                         "launches_per_update": per_update, "want": want, "events": got})
            if got != want or (dev.type == "cuda" and want == 0):
                problems.append(f"profile window: {names} {got} events, want {want}")
        window["kernels"] = rows
        window["l2norm_partial_kernel"] = events.get("l2norm_partial_kernel", 0)
    # /metrics during the run
    scraped = []
    for text in tele["scrapes"]:
        samples = dict(x.rsplit(" ", 1) for x in text.splitlines() if x and x[0] != "#")
        scraped.append({k[len("unicore_tpu_train_"):]: float(v) for k, v in samples.items()
                        if k.startswith("unicore_tpu_train_")})
    best = max(scraped, key=lambda d: d.get("updates_total", 0), default={})
    gauges = [f"{k}_seconds" for k in ("host_blocked", "device_busy", "data_wait", "h2d",
                                       "dispatch")]
    if best.get("updates_total", 0) < p["log_interval"] or any(g not in best for g in gauges):
        problems.append(f"/metrics: {len(scraped)} scrapes, best {best}")
    # TensorBoard
    log_text = Path(tele["log"]).read_text()
    warned = log_text.count("tensorboard not found, please install with: pip install "
                            "tensorboardX")
    tb_dir = WORK / "fused_tb" / "train_inner"
    if warned:
        tb = {"case": "no writer installed: the warning", "warnings": warned}
        if warned != 1:
            problems.append(f"the missing-writer warning {warned} times")
    else:
        scalars = tb_scalars(tb_dir, "loss")
        want = [(int(s["num_updates"]), float(s["loss"])) for s in inner]
        got = [(step, round(v, 3)) for step, v in scalars]
        tb = {"case": "writer installed: loss scalars against the JSON lines",
              "scalars": got, "json": want}
        if got != want:
            problems.append(f"TensorBoard loss {got} != JSON {want}")
    # read, not gated: what the flags cost
    walls = dict(zip(range(1, n), stats["update_wall_ms"]))
    profiled = [u for u in range(start, end) if u in walls]
    sampled_walls = [walls[u] for u in sampled if u in walls and u not in profiled]
    others = [w for u, w in walls.items() if u not in sampled and u not in profiled]
    past = [spans[u]["dispatch"]["dur"] - spans[u]["device_busy"]["dur"]
            for u in sampled if "device_busy" in spans.get(u, {})]
    med = lambda xs: float(np.median(xs)) if xs else None  # noqa: E731
    line = {
        "flags": tele["flags"], "updates": n, "progress_lines": len(lines),
        "train_inner_keys": want_keys, "journal_kinds": sorted(set(kinds)),
        "sampled_updates": sampled,
        "device_busy_upper_bound": [spans[u]["device_busy"]["upper_bound"] for u in sampled
                                    if "device_busy" in spans.get(u, {})],
        "dispatch_minus_device_busy_s": past, "median_dispatch_minus_device_busy_s": med(past),
        "profile_window": window, "metrics_scrapes": len(scraped), "metrics_best": best,
        "tensorboard": tb,
        "wall_ms_sampled": sampled_walls, "wall_ms_profiled": [walls[u] for u in profiled],
        "median_wall_ms_other": med(others),
        "median_step_ms": stats["median_step_ms"],
        "median_update_wall_ms": stats["median_update_wall_ms"],
        "perf_md_11a": p["perf_md_11a"], "card": card, "nvidia_smi": smi,
    }
    print("train_telemetry " + json.dumps(line), flush=True)
    if problems:
        raise AssertionError(f"train_telemetry: {problems}")


def drive_trace_merger(cfg, card, smi):
    """16b: ``python -m unicore_tpu_torch.cli.trace`` on phase 12's journal
    directory (12a-12d's runs, each appending its records) with ``--out``:
    exit 0; the post-mortem summary names 12b's rewind by ``loss-spike`` to
    the snapshot it targeted, 12c's fallback to the intact interval
    checkpoint and 12d's SIGTERM stop; the timeline holds 12d's preemption
    emergency save (``save_kind=preempt``); the Chrome trace parses
    (``trace_merge``)."""
    p = cfg["phase12"]
    every = p["snapshot_every"]
    target = p["spike_at"] // every * every
    intact = (p["flip_at"] - 1) // (2 * every) * (2 * every)
    out = WORK / "robust_trace.json"
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "unicore_tpu_torch.cli.trace",
                           str(WORK / "robust_telemetry"), "--out", str(out)],
                          capture_output=True, text=True, cwd=str(ROOT), timeout=300)
    seconds = time.monotonic() - t0
    summary = proc.stdout.split("== post-mortem summary ==")[-1].strip().splitlines()
    rewind = [x for x in summary if "SENTINEL REWIND" in x]
    fallback = [x for x in summary if "CHECKPOINT FALLBACK" in x]
    stops = [x for x in summary if "agreed stop" in x and "SIGTERM" in x]
    emergency = [x for x in proc.stdout.splitlines()
                 if " checkpoint-emergency " in x and "save_kind=preempt" in x]
    events = json.loads(out.read_text())["traceEvents"] if out.exists() else []
    line = {"exit": proc.returncode, "seconds": seconds, "summary": summary,
            "rewind": rewind, "fallback": fallback, "sigterm_stop": stops,
            "emergency_save": emergency, "trace_events": len(events),
            "span_slices": sum(1 for e in events if e.get("ph") == "X"),
            "card": card, "nvidia_smi": smi}
    print("trace_merge " + json.dumps(line), flush=True)
    if not (proc.returncode == 0
            and any(f"-> snapshot @update {target}" in x for x in rewind)
            and any(x.endswith(f"checkpoint_{(intact - 1) // p['epoch_updates'] + 1}_"
                               f"{intact}.pt") for x in fallback)
            and stops and emergency and events):
        raise AssertionError(f"trace_merge: {line}\n{proc.stderr[-3000:]}")


#: phase 16's settings (16a rides on 11a's run, 16b on phase 12's)
PHASE16 = {
    "log_interval": 5, "sample_interval": 4, "profile": (8, 10),
    # 11a's figures in PERF.md (NVIDIA H100 80GB HBM3, 700.00 W): its
    # update wall median (§6) and the wall of its profiled update (§5)
    # before the telemetry flags
    "perf_md_11a": {"median_update_wall_ms": 169.2, "fused_profile_wall_ms": 81.0},
}


#: phase 12's settings on the card (the rehearsal scales the updates down):
#: BERT-base's 400-document corpus is 25 updates an epoch at batch 8 x 2;
#: 20 updates, snapshots every 5, saves every 10 (each a 1.5 GB write of
#: ~4-5 s), the spike rewound to the snapshot at 10, the save at 20 rotten
PHASE12 = {
    "updates": 20, "epoch_updates": 25, "snapshot_every": 5, "spike_at": 13,
    "magnitude": 100, "flip_at": 15, "sigterm_after": 15, "raise_at": 7,
    "loss_rel": 1e-4,
    "sentinel_flags": ["--sentinel-interval", "1", "--snapshot-interval", "5",
                       "--snapshot-keep", "2", "--sentinel-warmup", "10",
                       "--loss-spike-window", "16"],
}

# ---------------------------------------------------------------------------
# phase 13: the serving control plane
# ---------------------------------------------------------------------------

#: 13a: the flood (``request-flood:QPS@BATCH``) against a queue of 16 and
#: 40 ms default deadlines, probed every 0.1 s with 200 ms requests; a bf16
#: card-vs-CPU score bound.  13b: the bf16 teacher-forced gap (8 bf16 ulps of
#: a logit in [4, 8)) and the device memory across the swap.
PHASE13 = {"flood": "request-flood:400@2", "admission_capacity": 16, "flood_deadline_ms": 40,
           "probe_deadline_ms": 200, "probe_every_s": 0.1, "window_s": 10.0,
           "score_rel": 2e-2, "bf16_gap": 0.5, "memory_rel": 0.05,
           # the first checkpoint served again after two swaps against its
           # memory before them: a leak of ~2 MiB a reload would show.  (Two
           # different checkpoints of one arch read ~3 MiB apart on the
           # card, so the swaps' memory is compared checkpoint for checkpoint)
           "memory_repeat_rel": 0.005, "reload_new_tokens": 8}
SHED_REASONS = ("queue-full", "deadline-unmeetable", "too-long", "draining", "not-ready",
                "cache-oom", "expired-in-queue", "expired-at-admission",
                "expired-at-response")


def drive_bf16_serving(torch, cfg, path, fp32_serve, card, smi):
    """13a: 10a's bf16 BERT-base checkpoint served in bf16 (phase 4's batch
    and buckets) under ``request-flood``: the log names the dtype; phase 4's
    launches per batch; during the flood's 10 s, sheds with named reasons in
    ``/metrics`` and the journal while admitted requests keep their
    deadlines; after it, phase 4's requests as phase 4 sends them (client
    p50/p99 beside phase 4's fp32 server), two answers against the same
    checkpoint served in bf16 on the CPU; SIGTERM drains and exits 0.
    Prints ``bf16_serve`` and returns the server's launches."""
    import numpy as np

    from unicore_tpu_torch import checkpoint_utils, tasks

    p = cfg["phase13"]
    state = checkpoint_utils.load_checkpoint_to_cpu(str(path))
    task = tasks.setup_task(state["args"])
    vocab, pad = len(task.dictionary), task.dictionary.pad()
    del state
    t0 = time.monotonic()
    server = Server(path, cfg, [
        "--serve-batch-size", str(cfg["batch"]), "--serve-buckets", "4",
        "--fault-inject", p["flood"], "--admission-capacity", str(p["admission_capacity"]),
        "--default-deadline-ms", str(p["flood_deadline_ms"])], name="bf16_serve")
    try:
        server.wait_ready(cfg["ready_budget_s"])
        startup_s = time.monotonic() - t0
        if "checkpoint weights in bfloat16: served in bfloat16" not in server.log_text():
            raise AssertionError(f"the log names no bf16 serving:\n{server.log_text()[-4000:]}")
        rng = np.random.default_rng(cfg["seed"])  # phase 4's requests
        reqs = [rng.integers(5, vocab, size=n).tolist() for n in cfg["lengths"]]
        code, before = http("GET", server.base + "/stats")
        assert code == 200, before

        def send(toks, deadline_ms=120000.0):
            t = time.monotonic()
            code, body = http("POST", server.base + "/v1/infer",
                              {"tokens": toks, "deadline_ms": deadline_ms})
            return code, body, (time.monotonic() - t) * 1e3

        opening = [send(reqs[0]), send(reqs[1])]  # two batches open the window
        wait_log(server, "request-flood window OPEN", budget=60)
        t_open = time.monotonic()
        probes = []
        while time.monotonic() - t_open < p["window_s"] - 1.0:
            probes.append(send(reqs[len(probes) % len(reqs)], p["probe_deadline_ms"]))
            time.sleep(p["probe_every_s"])
        time.sleep(max(0.0, p["window_s"] + 1.0 - (time.monotonic() - t_open)))
        deadline = time.monotonic() + 60
        while http("GET", server.base + "/stats")[1]["depth"] and time.monotonic() < deadline:
            time.sleep(0.1)
        code, flood = http("GET", server.base + "/stats")
        # phase 4's requests, as phase 4 sends them
        half = len(reqs) // 2
        results = [send(r) for r in reqs[:half]]
        with ThreadPoolExecutor(max_workers=cfg["batch"]) as pool:
            results += list(pool.map(send, reqs[half:]))
        code, after = http("GET", server.base + "/stats")
        assert code == 200, after
        metrics = scrape_metrics(server.base)
        metrics_match_stats(metrics, after)

        for toks, (code, body, _) in zip(reqs[:2] + reqs, opening + results):
            if code != 200 or len(body["output"]) != len(toks) \
                    or not math.isfinite(body["score"]):
                raise AssertionError(f"request of {len(toks)} tokens: {code} {body}")
        outcomes = {}
        for code, body, _ in probes:
            key = body.get("reason") or body.get("status") if code != 200 else "ok"
            outcomes[f"{code} {key}"] = outcomes.get(f"{code} {key}", 0) + 1
            if code == 200 and body["latency_ms"] > p["probe_deadline_ms"]:
                raise AssertionError(f"an admitted probe answered past its deadline: {body}")
            if code != 200 and (code not in (429, 503, 504)
                                or body.get("reason") not in SHED_REASONS):
                raise AssertionError(f"a probe answered {code} {body}")
        shed = flood["shed"]
        if not sum(shed.values()) or not set(shed) <= set(SHED_REASONS):
            raise AssertionError(f"the flood shed {shed}")
        journal_shed = {e["reason"] for e in journal_events(path) if e["kind"] == "serve-shed"}
        if not journal_shed or not journal_shed <= set(SHED_REASONS):
            raise AssertionError(f"journal sheds {journal_shed}")

        batches = after["batches"] - before["batches"]
        launches = {k: n - before["kernel_launches"].get(k, 0)
                    for k, n in after["kernel_launches"].items()}
        if cfg["device"].type == "cuda":
            for k, n in cfg["per_batch"].items():
                if launches.get(k) != n * batches:
                    raise AssertionError(f"bf16 {k}: {launches.get(k)} launches for "
                                         f"{batches} batches, want {n} per batch")
        # two answers against the checkpoint served in bf16 on the CPU: ids
        # where the CPU's top-2 gap exceeds 4 bf16 ulps of the largest logit
        # (each module rounds its output to bf16, on the card and on the CPU
        # in other places), the score within score_rel
        small = sorted(range(len(reqs)), key=lambda i: len(reqs[i]))[:2]
        bucket = min(results[i][1]["bucket"] for i in small)
        cpu_model = load_serving_model_cpu(torch, path)
        logits, ids, score = cpu_logits(torch, cpu_model, [reqs[i] for i in small], bucket, pad)
        del cpu_model
        gap = 4 * 2.0 ** -8 * float(np.abs(logits).max())
        answers = [results[i][1] for i in small]
        agree, total, excluded = gapped_agreement(answers, logits, ids, gap)
        worst = max(abs(b["score"] - float(score[row])) / max(abs(float(score[row])), 1e-6)
                    for row, b in enumerate(answers))
        if not total or agree < 0.99 * total or worst > p["score_rel"]:
            raise AssertionError(f"bf16 answers vs the CPU in bf16: ids {agree}/{total} past a "
                                 f"top-2 gap of {gap} ({excluded} closer), score rel err "
                                 f"{worst} (bound {p['score_rel']})")

        server.proc.send_signal(signal.SIGTERM)
        rc = server.proc.wait(timeout=180)
        if rc != 0 or "DRAIN complete" not in server.log_text():
            raise AssertionError(f"drain exit {rc}:\n{server.log_text()[-6000:]}")
        lat = np.asarray([r[2] for r in results])
        res = {
            "requests": len(reqs), "batches": batches, "startup_s": startup_s,
            "client_p50_ms": float(np.percentile(lat, 50)),
            "client_p99_ms": float(np.percentile(lat, 99)),
            "fp32_client_p50_ms": fp32_serve["client_p50_ms"],
            "fp32_client_p99_ms": fp32_serve["client_p99_ms"],
            "flood": {"spec": p["flood"], "window_s": p["window_s"],
                      "admitted": flood["admitted"] - before["admitted"],
                      "served": flood["served"] - before["served"],
                      "shed": shed, "probes": outcomes, "journal_shed_reasons":
                          sorted(journal_shed)},
            "metrics_shed": {k: v for k, v in metrics.items() if "shed_total" in k},
            "cpu_agreement": {"requests": len(small), "ids_equal": agree, "ids": total,
                              "ids_within_gap": excluded, "gap": gap,
                              "score_rel_err": worst, "bound": p["score_rel"]},
            "launches": launches, "arch": cfg["arch"], "card": card, "nvidia_smi": smi,
        }
        print("bf16_serve " + json.dumps(res), flush=True)
        return launches
    finally:
        server.stop()


def drive_lm_bf16_serving(torch, cfg, lm, fp32_decode, card, smi):
    """13b: 10b's bf16 ``checkpoint_1_<interval>.pt`` served over
    ``/v1/generate`` with phase 7's engine settings, ``--reload-interval
    0.5 --fault-inject corrupt-reload@1``: six launches of the bf16-query
    decode kernel a step; two generations teacher-forced on the CPU in bf16;
    10b's resumed ``checkpoint_last.pt`` published (rotten: ``RELOAD
    ROLLBACK (rejected:verify)``) and re-published (``RELOAD SWAPPED``)
    while generations are in flight, every one answered 200; then 10b's
    first checkpoint re-published (a second ``RELOAD SWAPPED``); the
    journal's outcomes; the decode gauges of ``/metrics``; the device
    memory after the swap within 5% of before, and after the second swap
    (the first checkpoint again) within 0.5% of before the first.  Prints
    ``lm_bf16_serve`` (tokens/s and token
    p50/p99 beside phase 7's fp32 server) and returns the server's
    launches."""
    import numpy as np

    d, p = cfg["decode"], cfg["phase13"]
    vocab, eos = lm["vocab"], lm["eos"]
    src = WORK / "lm_bf16_ckpt" / f"checkpoint_1_{cfg['lm_train']['interval']}.pt"
    cand = WORK / "lm_bf16_resume_ckpt" / "checkpoint_last.pt"
    path = fresh_dir(WORK / "lm_bf16_serve") / "checkpoint.pt"
    shutil.copy(src, path)
    t0 = time.monotonic()
    server = Server(path, cfg, [
        "--serve-batch-size", str(d["prefill_batch"]),
        "--decode-batch-size", str(d["decode_batch"]), "--serve-buckets", "4",
        "--cache-pages", str(d["cache_pages"]), "--max-new-tokens", str(d["max_new"]),
        "--reload-interval", "0.5", "--fault-inject", "corrupt-reload@1"],
        name="lm_bf16_serve")
    try:
        server.wait_ready(d["ready_budget_s"])
        startup_s = time.monotonic() - t0
        if "checkpoint weights in bfloat16: served in bfloat16" not in server.log_text():
            raise AssertionError(f"the log names no bf16 serving:\n{server.log_text()[-4000:]}")
        rng = np.random.default_rng(d["seed"])
        prompts = [rng.integers(5, vocab, size=n).tolist()
                   for n in cfg["lm_train"]["serve_lengths"]]
        code, before = http("GET", server.base + "/stats")
        assert code == 200, before

        def send(toks):
            t = time.monotonic()
            code, body = http("POST", server.base + "/v1/generate",
                              {"tokens": toks, "max_new_tokens": d["max_new"]})
            return code, body, (time.monotonic() - t) * 1e3

        t_req = time.monotonic()
        half = len(prompts) // 2
        results = [send(q) for q in prompts[:half]]
        with ThreadPoolExecutor(max_workers=len(prompts) - half) as pool:
            results += list(pool.map(send, prompts[half:]))
        wall = time.monotonic() - t_req
        code, after = http("GET", server.base + "/stats")
        assert code == 200, after
        for toks, (code, body, _) in zip(prompts, results):
            out = body.get("output") if code == 200 else None
            if not out or len(out) > d["max_new"] or not all(0 <= t < vocab for t in out):
                raise AssertionError(f"request of {len(toks)} tokens: {code} {body}")
        steps, prefills, launches = decode_launch_check(cfg, before, after,
                                                        decode="decode_attention_bf16q")
        cpu_model = load_lm(torch, path, "cpu")
        if {q.dtype for q in cpu_model.parameters()} != {torch.bfloat16}:
            raise AssertionError("the CPU reference is not bf16")
        order = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))[:2]
        checked = sum(teacher_forced_check(torch, cpu_model, prompts[i],
                                           results[i][1]["output"], p["bf16_gap"])
                      for i in order)
        del cpu_model
        if not checked:
            raise AssertionError("no served step had a CPU top-2 gap past the bound")
        agreement = {"requests": len(order), "checked_steps": checked,
                     "steps": sum(len(results[i][1]["output"]) for i in order),
                     "gap": p["bf16_gap"]}

        # the hot reload, generations in flight: a rotten candidate rolls
        # back, the same re-published swaps in
        mem_before = after.get("device_memory_mib")
        in_flight = KeepSending(server.base + "/v1/generate",
                                [{"tokens": q, "max_new_tokens": p["reload_new_tokens"]}
                                 for q in prompts], workers=4)
        t_pub = time.monotonic()
        try:
            publish(cand, path)
            wait_log(server, "RELOAD ROLLBACK (rejected:verify)")
            rollback_s = time.monotonic() - t_pub
            publish(cand, path)
            wait_log(server, "RELOAD SWAPPED")
            swap_s = time.monotonic() - t_pub - rollback_s
            time.sleep(1.0)  # generations on the swapped model
        finally:
            answered = in_flight.stop()
        bad = [(c, b) for c, b in answered if c != 200]
        if bad or not answered:
            raise AssertionError(f"generations across the reload: {len(answered)} sent, "
                                 f"not 200: {bad[:5]}")
        code, swapped = http("GET", server.base + "/stats")
        mem_after = swapped.get("device_memory_mib")
        if swapped["reloads_applied"] != 1:
            raise AssertionError(f"reloads_applied {swapped['reloads_applied']}")
        # a second swap, back to the first checkpoint: its memory equals its
        # memory before the two reloads, so they leaked nothing
        t_pub = time.monotonic()
        publish(src, path)
        wait_log(server, "RELOAD SWAPPED", count=2)
        swap2_s = time.monotonic() - t_pub
        time.sleep(1.0)  # as after the first
        code, swapped = http("GET", server.base + "/stats")
        mem_after2 = swapped.get("device_memory_mib")
        if swapped["reloads_applied"] != 2:
            raise AssertionError(f"reloads_applied {swapped['reloads_applied']}")
        if cfg["device"].type == "cuda" and not (
                abs(mem_after - mem_before) <= p["memory_rel"] * mem_before
                and abs(mem_after2 - mem_before) <= p["memory_repeat_rel"] * mem_before):
            raise AssertionError(f"device memory {mem_before} MiB before the swap, "
                                 f"{mem_after} after it, {mem_after2} after a second")
        metrics = scrape_metrics(server.base)
        metrics_match_stats(metrics, swapped)
        gauges = ("tokens_generated_total", "tokens_per_second", "cache_page_occupancy",
                  "cache_pages_free", "active_sequences", "preempted_total",
                  "requeued_total", "decode_steps_total", "prefill_batches_total")
        missing = [g for g in gauges if f"unicore_tpu_serve_{g}" not in metrics]
        if missing:
            raise AssertionError(f"/metrics lacks {missing}")

        server.proc.send_signal(signal.SIGTERM)
        rc = server.proc.wait(timeout=180)
        if rc != 0 or "DRAIN complete" not in server.log_text():
            raise AssertionError(f"drain exit {rc}:\n{server.log_text()[-6000:]}")
        # the chaos flip rewrites the published file, so the watcher may see
        # the rotten file's new signature once more (and reject it again, as
        # the JAX watcher would) before the re-publish
        outcomes = [e["outcome"] for e in journal_events(path) if e["kind"] == "serve-reload"]
        if (outcomes[-4:] != ["swapped", "swapped-in"] * 2 or not outcomes[:-4]
                or set(outcomes[:-4]) != {"rejected:verify"}):
            raise AssertionError(f"journal reload outcomes {outcomes}")
        tokens = after["tokens_generated"] - before["tokens_generated"]
        lat = np.asarray([r[2] for r in results])
        res = {
            "requests": len(prompts), "startup_s": startup_s,
            "tokens_generated": tokens, "request_wall_s": wall,
            "tokens_per_s": tokens / wall, "server_tokens_per_s": after["tokens_per_s"],
            "token_p50_ms": after.get("token_p50_ms"), "token_p99_ms": after.get("token_p99_ms"),
            "client_p50_ms": float(np.percentile(lat, 50)),
            "client_p99_ms": float(np.percentile(lat, 99)),
            "fp32": {k: fp32_decode[k] for k in ("tokens_per_s", "token_p50_ms",
                                                  "token_p99_ms", "requests")},
            "decode_steps": steps, "prefill_batches": prefills,
            "cpu_agreement": agreement,
            "reload": {"rollback_s": rollback_s, "swap_s": swap_s, "swap2_s": swap2_s,
                       "in_flight_answered_200": len(answered), "journal": outcomes,
                       "device_memory_mib_before": mem_before,
                       "device_memory_mib_after": mem_after,
                       "device_memory_mib_after_second_swap": mem_after2,
                       "device_memory_peak_mib": swapped.get("device_memory_peak_mib"),
                       "reload_kernel_launches": swapped.get("reload_kernel_launches")},
            "launches": launches, "arch": d["arch"], "card": card, "nvidia_smi": smi,
        }
        print("lm_bf16_serve " + json.dumps(res), flush=True)
        return launches
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# phase 14: the serving fleet and its router
# ---------------------------------------------------------------------------

#: two replicas of phase 4a's checkpoint at phase 4's engine settings behind
#: the router; leases every 0.5 s, a 3 s fleet timeout; replica 1 hard-exits
#: after its ``loss_batch``-th batch, past every batch steps 2-3 send it
#: (their in-flight traffic is paced by ``pace_s`` a worker); the rolled
#: candidate is 4a's weights moved by a seeded 0.01 N(0, 1)
PHASE14 = {"interval": 0.5, "timeout": 3.0, "loss_batch": 150, "moved_seed": 14,
           "pace_s": 0.1, "memory_rel": 0.05,
           # every bucket of 128/256/384/512, twice, and a few more
           "lengths": [1, 64, 128, 129, 200, 256, 257, 300, 384, 385, 450, 512,
                       17, 100, 127, 140, 230, 255, 270, 333, 383, 400, 480, 511]}


class Router:
    """``python -m unicore_tpu_torch.cli.router --port 0`` with ``argv``."""

    def __init__(self, argv, name="fleet_router"):
        self.log_path = WORK / f"{name}.log"
        self._log = open(self.log_path, "w")
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "unicore_tpu_torch.cli.router", "--port", "0",
             "--default-deadline-ms", "120000", "--max-deadline-ms", "120000", *argv],
            stdout=self._log, stderr=subprocess.STDOUT, cwd=str(ROOT), env=env,
        )
        self.base = None

    def log_text(self):
        return self.log_path.read_text()

    def wait_listening(self, budget):
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(f"router exited {self.proc.returncode}:\n"
                                   f"{self.log_text()[-6000:]}")
            for line in self.log_text().splitlines():
                if "ROUTER listening on http://" in line:
                    self.base = "http://" + line.split("http://", 1)[1].split()[0]
                    return
            time.sleep(0.2)
        raise RuntimeError(f"router not listening in {budget}s:\n{self.log_text()[-6000:]}")

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self._log.close()


def wait_until(what, pred, budget, poll_s=0.1):
    """Poll ``pred`` until it is true; AssertionError naming ``what`` after
    ``budget`` seconds."""
    deadline = time.monotonic() + budget
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {budget}s")
        time.sleep(poll_s)


def corrupt_copy(src, dst):
    """``src`` with one payload byte flipped (at 60% of the file), as the JAX
    fleet test rots a candidate."""
    shutil.copy(src, dst)
    size = os.path.getsize(dst)
    with open(dst, "r+b") as f:
        f.seek(int(size * 0.6))
        byte = f.read(1)
        f.seek(int(size * 0.6))
        f.write(bytes([byte[0] ^ 0xFF]))
    return dst


def start_fleet(torch, cfg, src):
    """Phase 14's fleet, started with phase 4 (whose server is its replica
    0, so the two phases share a start-up): 4a's checkpoint copied to a
    fleet path and served by two replicas (``--advertise auto``, one fleet
    KV, one journal directory beside the path; replica 0 under phase 4's
    slow client, replica 1 under ``replica-loss``) behind the router
    (``--path`` watched for rolling reloads).  The rolled and the rotten
    candidates are written while the replicas warm up.  Returns the fleet's
    handles (:func:`stop_fleet` ends them)."""
    from unicore_tpu_torch import checkpoint_utils, tasks

    p = cfg["phase14"]
    t0 = time.monotonic()
    root = fresh_dir(WORK / "fleet")
    path, kv, tele = root / "checkpoint_last.pt", root / "kv", root / "telemetry"
    shutil.copy(src, path)
    fleet_argv = ["--serve-batch-size", str(cfg["batch"]), "--serve-buckets", "4",
                  "--advertise", "auto", "--fleet-kv", str(kv),
                  "--fleet-interval", str(p["interval"]), "--telemetry-dir", str(tele)]
    # phase 4's slow client: the first request after the second batch
    # stalls 3 s mid-body against a 1 s read budget
    fleet = {"root": root, "path": path, "tele": tele, "t0": t0, "reps": [
        Server(path, cfg, fleet_argv + ["--replica-index", "0", "--fault-inject",
                                        "slow-client:3@2", "--request-read-timeout", "1"],
               name="fleet_r0"),
        Server(path, cfg, fleet_argv + ["--replica-index", "1", "--fault-inject",
                                        f"replica-loss@{p['loss_batch']}@1"], name="fleet_r1")]}
    fleet["router"] = Router(["--fleet-kv", str(kv), "--fleet-interval", str(p["interval"]),
                              "--fleet-timeout", str(p["timeout"]), "--path", str(path),
                              "--reload-interval", "0.5", "--reload-timeout", "300",
                              "--telemetry-dir", str(tele)])
    try:
        state = checkpoint_utils.load_checkpoint_to_cpu(str(path))
        task = tasks.setup_task(state["args"])
        fleet["vocab"], fleet["pad"] = len(task.dictionary), task.dictionary.pad()
        del state
        fleet["moved"] = write_moved_checkpoint(torch, src, root / "moved.pt", p["moved_seed"])
        fleet["rotten"] = corrupt_copy(src, root / "rotten.pt")
    except BaseException:
        stop_fleet(fleet)
        raise
    return fleet


def wait_fleet_ready(cfg, fleet):
    """Both replicas ready, each registered before it was ready, and the
    router routing to 2; the seconds since :func:`start_fleet` go to
    ``fleet["startup_s"]``."""
    router = fleet["router"]
    router.wait_listening(cfg["ready_budget_s"])
    for r in fleet["reps"]:
        r.wait_ready(cfg["ready_budget_s"])
    wait_until("2 routable", lambda: http("GET", router.base + "/readyz")[1].get(
        "routable") == 2, 30)
    fleet["startup_s"] = time.monotonic() - fleet["t0"]
    for r in fleet["reps"]:
        text = r.log_text()
        if not 0 <= text.find("FLEET REGISTERED") < text.find("readiness -> true"):
            raise AssertionError(f"{r.log_path.name}: not registered before ready")
    log(f"fleet ready after {fleet['startup_s']:.1f}s: 2 routable")


def stop_fleet(fleet):
    for r in fleet["reps"]:
        r.stop()
    fleet["router"].stop()


def drive_fleet(torch, cfg, fleet, fp32_serve, card, smi):
    """Phase 14, after phase 4 on replica 0 (:func:`start_fleet`): 24
    requests over every bucket and phase 4's two CPU-checked rows through
    the router, half concurrent, all 200, both replicas serving, each replica's
    launches exactly phase 4's per batch and nothing else, two answers
    against phase 4's CPU reference, ``/metrics`` = ``/stats``; a moved
    candidate rolled across both with requests in flight (all 200, equal new
    digests, device memory within 5% across each swap), then a corrupt one
    halted after one rollback (one replica never asked, digests kept, the
    journal's halt record); traffic until replica 1 exits 74, the router's
    REPLICA-LOSS verdict, every answer 200 or named and every one after the
    verdict 200, 1 routable; SIGTERM on replica 0 -> exit 0 and ``FLEET
    DEREGISTERED`` in both logs, the router's 503 ``no-ready-replica`` with
    ``Retry-After``; SIGTERM on the router -> exit 0; phase 4's drain
    (replica 0's exit 0) and the journal's start, slow-client shed and
    drain.  Prints ``fleet_serve`` and returns the replicas' summed
    launches."""
    import threading

    import numpy as np

    p = cfg["phase14"]
    reps, router, tele = fleet["reps"], fleet["router"], fleet["tele"]
    path, moved, rotten, vocab = fleet["path"], fleet["moved"], fleet["rotten"], fleet["vocab"]
    startup_s = fleet["startup_s"]
    # 2. route: the first half one at a time, the rest concurrently
    rng = np.random.default_rng(cfg["seed"] + 14)
    reqs = [rng.integers(5, vocab, size=n).tolist() for n in p["lengths"]]
    ref_rows = [row for row, _, _ in fp32_serve["cpu_ref"]]
    reqs += ref_rows  # the two rows phase 4 held against the CPU

    def send(toks):
        t = time.monotonic()
        code, body = http("POST", router.base + "/v1/infer", {"tokens": toks})
        return code, body, (time.monotonic() - t) * 1e3

    before = [http("GET", r.base + "/stats")[1] for r in reps]
    half = len(reqs) // 2
    results = [send(r) for r in reqs[:half]]
    with ThreadPoolExecutor(max_workers=cfg["batch"]) as pool:
        results += list(pool.map(send, reqs[half:]))
    after = [http("GET", r.base + "/stats")[1] for r in reps]
    buckets = set()
    for toks, (code, body, _) in zip(reqs, results):
        if code != 200 or len(body["output"]) != len(toks) or not math.isfinite(
                body["score"]):
            raise AssertionError(f"routed request of {len(toks)} tokens: {code} {body}")
        buckets.add(body["bucket"])
    if buckets != set(after[0]["buckets"]):
        raise AssertionError(f"buckets hit {sorted(buckets)} != {after[0]['buckets']}")
    launches, per_replica = {}, []
    for name, b, a in zip(("r0", "r1"), before, after):
        batches = a["batches"] - b["batches"]
        got = {k: a["kernel_launches"][k] - b["kernel_launches"].get(k, 0)
               for k in a["kernel_launches"]}
        per_replica.append({"replica": name, "batches": batches, "launches": got})
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        if cfg["device"].type == "cuda":
            want = {k: cfg["per_batch"].get(k, 0) * batches for k in got}
            if got != want:
                raise AssertionError(f"replica {name}: launches {got} for {batches} "
                                     f"batches, want {cfg['per_batch']} a batch and "
                                     "nothing else")
    rstats = http("GET", router.base + "/stats")[1]
    split = rstats["by_replica"]
    if set(split) != {"r0", "r1"} or rstats["ok"] != len(reqs):
        raise AssertionError(f"router /stats: {rstats}")
    m = scrape_metrics(router.base)
    for key, want in [("unicore_tpu_router_ok_total", rstats["ok"]),
                      ("unicore_tpu_router_proxied_total", rstats["proxied"]),
                      ("unicore_tpu_router_retries_total", rstats["retries"]),
                      ("unicore_tpu_router_replicas_routable", 2)] + [
            (f'unicore_tpu_router_replica_proxied_total{{replica="{n}"}}', c)
            for n, c in split.items()]:
        if m.get(key) != want:
            raise AssertionError(f"/metrics {key} = {m.get(key)}, /stats {want}")
    agree, total = 0, 0
    for (row, ids, score), (_, body, _) in zip(fp32_serve["cpu_ref"], results[-2:]):
        got = np.asarray(body["output"])
        agree += int((got == np.asarray(ids)[: len(got)]).sum())
        total += len(got)
        if abs(body["score"] - score) / max(abs(score), 1e-6) > 1e-3:
            raise AssertionError(f"routed score {body['score']} vs CPU {score}")
    if agree < 0.99 * total:
        raise AssertionError(f"routed ids agree with the CPU run on {agree}/{total}")
    lat = np.asarray([r[2] for r in results])
    log(f"routed {len(reqs)} requests: split {split}, per replica {per_replica}, "
        f"CPU ids {agree}/{total}")

    # 3. roll a moved candidate with requests in flight, then a rotten one
    digests = lambda: {n: r["digest"] for n, r in http(  # noqa: E731
        "GET", router.base + "/stats")[1]["fleet"]["replicas"].items()}
    old = digests()
    if len(set(old.values())) != 1:
        raise AssertionError(f"digests before the roll: {old}")
    mem_before = [a.get("device_memory_mib") for a in after]
    in_flight = KeepSending(router.base + "/v1/infer", [{"tokens": r} for r in reqs],
                            workers=2, pace_s=p["pace_s"])
    t_pub = time.monotonic()
    try:
        publish(moved, path)
        wait_log(router, "ROLLING RELOAD COMPLETE: 2/2")
        roll_s = time.monotonic() - t_pub
        time.sleep(1.0)  # requests on the swapped models
    finally:
        answered = in_flight.stop()
    bad = [(c, b) for c, b in answered if c != 200]
    if bad or not answered:
        raise AssertionError(f"requests across the roll: {len(answered)} sent, not 200: "
                             f"{bad[:5]}")
    wait_until("new digests", lambda: set(digests().values()).isdisjoint(old.values()),
               10)
    new = digests()
    if len(set(new.values())) != 1:
        raise AssertionError(f"digests after the roll: {new}")
    swapped = [http("GET", r.base + "/stats")[1] for r in reps]
    mem_after = [s.get("device_memory_mib") for s in swapped]
    if [s["reloads_applied"] for s in swapped] != [1, 1]:
        raise AssertionError(f"reloads_applied {[s['reloads_applied'] for s in swapped]}")
    if cfg["device"].type == "cuda" and not all(
            abs(a - b) <= p["memory_rel"] * b for a, b in zip(mem_after, mem_before)):
        raise AssertionError(f"device memory {mem_before} MiB before the swaps, "
                             f"{mem_after} after")
    t_pub = time.monotonic()
    publish(rotten, path)
    wait_log(router, "ROLLING RELOAD HALT")
    halt_s = time.monotonic() - t_pub
    rolled_back = [r.log_path.name for r in reps if "RELOAD ROLLBACK" in r.log_text()]
    if rolled_back != ["fleet_r0.log"] or \
            "1 remaining replica(s) were never asked" not in router.log_text():
        raise AssertionError(f"the halt: rollbacks in {rolled_back}")
    time.sleep(2 * p["interval"])
    if digests() != new:
        raise AssertionError(f"digests after the halt {digests()} != {new}")
    r1_batches = http("GET", reps[1].base + "/stats")[1]["batches"]
    if r1_batches >= p["loss_batch"]:
        raise AssertionError(f"replica 1 ran {r1_batches} batches before step 4")
    log(f"roll {roll_s:.2f}s ({len(answered)} in flight, all 200), halt {halt_s:.2f}s; "
        f"memory {mem_before} -> {mem_after} MiB; r1 at batch {r1_batches}")

    # 4. lose replica 1: traffic until it exits, and past the verdict
    sent, lock, stop = [], threading.Lock(), threading.Event()

    def drive(k):
        i = k
        while not stop.is_set():
            t0 = time.monotonic()
            code, body = http("POST", router.base + "/v1/infer", {"tokens": reqs[i % 8]})
            with lock:
                sent.append((t0, code, body.get("reason")))
            i += 4

    pool = [threading.Thread(target=drive, args=(k,), daemon=True) for k in range(4)]
    for t in pool:
        t.start()
    try:
        reps[1].proc.wait(timeout=300)
        died = time.monotonic()
        wait_until("the REPLICA-LOSS verdict",
                   lambda: "FLEET REPLICA-LOSS: replica r1" in router.log_text(),
                   p["timeout"] + 4 * p["interval"] + 10, poll_s=0.05)
        verdict_s = time.monotonic() - died
        verdict_at = time.monotonic()
        time.sleep(1.0)
    finally:
        stop.set()
        for t in pool:
            t.join(timeout=300)
    if reps[1].proc.returncode != 74 or "REPLICA LOSS" not in reps[1].log_text():
        raise AssertionError(f"replica 1 exit {reps[1].proc.returncode}:\n"
                             f"{reps[1].log_text()[-4000:]}")
    # the verdict lands within the timeout plus one lease interval of the
    # replica's last beat (which is at most one interval before its death)
    # and one of the router's poll
    if verdict_s > p["timeout"] + 2 * p["interval"] + 0.5:
        raise AssertionError(f"verdict {verdict_s:.2f}s after the loss")
    unnamed = [(c, r) for _, c, r in sent if c != 200 and not r]
    late = [(c, r) for t0, c, r in sent if t0 > verdict_at and c != 200]
    if unnamed or late or not any(t0 > verdict_at for t0, _, _ in sent):
        raise AssertionError(f"the loss: unnamed {unnamed[:5]}, after the verdict {late[:5]}")
    rstats = http("GET", router.base + "/stats")[1]
    if rstats["fleet"]["routable"] != 1 or rstats["fleet"]["lost"] != ["r1"]:
        raise AssertionError(f"after the loss: {rstats['fleet']}")
    outcomes = {}
    for _, c, r in sent:
        outcomes[f"{c} {r}" if r else str(c)] = outcomes.get(f"{c} {r}" if r else str(c),
                                                            0) + 1
    log(f"replica 1 exited 74; verdict {verdict_s:.2f}s later; outcomes {outcomes}")

    # 5. shut down: the goodbye, the router's shed, the router's exit
    reps[0].proc.send_signal(signal.SIGTERM)
    rc0 = reps[0].proc.wait(timeout=180)
    if rc0 != 0 or "FLEET DEREGISTERED: replica r0" not in reps[0].log_text():
        raise AssertionError(f"replica 0 exit {rc0}:\n{reps[0].log_text()[-4000:]}")
    wait_log(router, "FLEET DEREGISTERED: replica r0", budget=30)
    req = urllib.request.Request(router.base + "/v1/infer", data=b'{"tokens": [5, 6]}',
                                 method="POST")
    try:
        urllib.request.urlopen(req, timeout=30)
        raise AssertionError("the router answered with no replica")
    except urllib.error.HTTPError as err:
        shed = (err.code, err.headers.get("Retry-After"), json.loads(err.read()))
    if shed[:2] != (503, "1") or shed[2].get("reason") != "no-ready-replica":
        raise AssertionError(f"the empty fleet's answer: {shed}")
    final = http("GET", router.base + "/stats")[1]
    router.proc.send_signal(signal.SIGTERM)
    if router.proc.wait(timeout=60) != 0:
        raise AssertionError(f"router exit {router.proc.returncode}")

    # 6. the journal: one file per replica index and the router's
    events = {}
    for name in ("events_rank0_router.jsonl", "events_rank0_serve.jsonl",
                 "events_rank1_serve.jsonl"):
        events[name] = [json.loads(x) for x in (tele / name).read_text().splitlines() if x]
    rj = [(e["kind"], e.get("verdict") or e.get("event"), e.get("replica"))
          for e in events["events_rank0_router.jsonl"]]
    for want in (("fleet-verdict", "replica-loss", "r1"), ("fleet-reload", "complete", None),
                 ("fleet-reload", "halt", "r0"), ("fleet-verdict", "deregistered", "r0")):
        if want not in rj:
            raise AssertionError(f"router journal lacks {want}: {rj}")
    # phase 4's run on replica 0: its start, the slow client, its drain
    kinds = [(e["kind"], e.get("role") or e.get("reason") or e.get("outcome"))
             for e in journal_events(path)]
    for want in (("run-start", "serve"), ("serve-shed", "slow-client"),
                 ("serve-drain", "complete")):
        if want not in kinds:
            raise AssertionError(f"replica 0's journal lacks {want}: {kinds}")
    res = {
        "requests": len(reqs), "by_replica": split, "per_replica": per_replica,
        "client_p50_ms": float(np.percentile(lat, 50)),
        "client_p99_ms": float(np.percentile(lat, 99)),
        "router_p50_ms": final.get("p50_ms"), "router_p99_ms": final.get("p99_ms"),
        "phase4_client_p50_ms": fp32_serve["client_p50_ms"],
        "phase4_client_p99_ms": fp32_serve["client_p99_ms"],
        "cpu_ids": [agree, total], "startup_s": startup_s,
        "roll_s": roll_s, "roll_in_flight_200": len(answered), "halt_s": halt_s,
        "device_memory_mib_before": mem_before, "device_memory_mib_after": mem_after,
        "verdict_s": verdict_s, "loss_outcomes": outcomes,
        "router_shed": final["shed"], "router_retries": final["retries"],
        "router_by_code": final["by_code"], "empty_fleet": [shed[0], shed[2]["reason"]],
        "journal_events": {k: len(v) for k, v in events.items()},
        "launches": launches, "arch": cfg["arch"], "card": card, "nvidia_smi": smi,
    }
    print("fleet_serve " + json.dumps(res), flush=True)
    return launches


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 15: data-parallel training (15a rides 11a: see drive_fused_training)
# ---------------------------------------------------------------------------

#: phase 15's settings: 4a's BERT-base and corpus in fp32 with the dropouts
#: 0 and 4b's optimizer (lr 1e-4, eps 1e-6), so the tolerances of 4b hold
#: 15d's ZeRO legs ([dtype:]stage), run after 15c's modes in its pair
ZERO_LEGS = ("0", "1", "2", "bf16:0", "bf16:3")
#: how far a sharded leg's own reduced gradient may lie from its stage-0
#: leg's, by dtype: two training runs on the card differ in the gradient's
#: last bits (#2's atomics); seen at most 7.6e-7 (fp32) and 1.2e-4 (bf16),
#: where a wrong reduce-scatter is off by the gradient itself
#: (``grad_max_abs``, which must lie above the bound on some rank)
ZERO_GRAD_ABS = {"fp32": 1e-5, "bf16": 1e-3}
PHASE15 = {"updates": 3, "pair_updates": 2, "lr": 1e-4, "loss_rel": 1e-4,
           "gnorm_rel": 1e-3, "param_tol": 1e-5, "timeout_s": 600}


def dp_argv(cfg, data, save_dir, device, updates, *extra):
    """4a's train arguments at phase 15's settings: ``updates`` updates,
    no validation, the weights alone saved at the end."""
    p = cfg["phase15"]
    return train_argv(cfg, data, save_dir, device) + [
        "--max-update", str(updates), "--total-num-update", str(updates),
        "--update-freq", "1", "--warmup-updates", "1", "--lr", str(p["lr"]), "--dropout", "0",
        "--attention-dropout", "0", "--emb-dropout", "0", "--activation-dropout", "0",
        "--disable-validation", "--no-save-optimizer-state", *extra]


def in_process_run(torch, cfg, argv, updates):
    """The first ``updates`` updates of the train CLI's run for ``argv``
    (its model from ``--seed``, its trainer, its epoch-1 batches in the
    CLI's order, ``--update-freq`` of them an update) in this process, with
    no start-up of its own: (trainer, wall ms from one update's end to the
    next's, the batches' loading included)."""
    from unicore_tpu_torch import options, tasks
    from unicore_tpu_torch.data import iterators
    from unicore_tpu_torch.trainer import Trainer

    dev = cfg["device"]
    args = options.parse_args_and_arch(options.get_training_parser(), argv)
    task = tasks.setup_task(args)
    task.load_dataset("train")
    model = task.build_model(args, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(args.seed))
    tr = Trainer(args, task, model, task.build_loss(args), dev)
    tr.begin_epoch(1)
    itr = iterators.GroupedIterator(tr.get_train_iterator(1).next_epoch_itr(shuffle=True),
                                    args.update_freq[0])
    ends = []
    for _ in range(updates):
        tr.train_step(next(itr))
        ends.append(time.perf_counter())
    return tr, [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]


def one_process_reference(torch, cfg, data, updates):
    """The one-rank ``--update-freq 2`` run on the batches the two ranks
    take (rank r the epoch's batches r, r + 2, ...: update u's pair is
    batches 2u and 2u + 1), in this process (:func:`in_process_run`)."""
    return in_process_run(torch, cfg, dp_argv(cfg, data, WORK / "unused", cfg["device"].type,
                                              updates, "--update-freq", "2"), updates)


def rank_launch_check(tag, cfg, stats):
    """Every rank launched 4a's kernels per micro-batch (none on the CPU)."""
    want = cfg["train"]["per_micro_batch"]
    for r in stats["ranks"]:
        for k, n in want.items():
            need = n * r["micro_batches"] if cfg["device"].type == "cuda" else 0
            if r["kernel_launches"].get(k, 0) != need:
                raise AssertionError(f"{tag}: rank {r['rank']}: {k}: "
                                     f"{r['kernel_launches'].get(k)} launches, want {need}")


def drive_dp_training(torch, cfg, data, card, smi):
    """15b: BERT-base on two ranks of the train CLI over gloo (one card:
    NCCL refuses two ranks on it), fp32, dropouts 0, ``updates`` updates of
    batch 8 a rank: the ranks' parameters the same bits (their sha256),
    4a's launches per micro-batch on each rank, and against the one-rank
    ``--update-freq 2`` run on the same batches the losses within 1e-4, the
    gradient norms within 1e-3 (relative) and rank 0's saved parameters
    within 1e-5.  15c: ``tools/dp_pair.py`` (one spawned pair) runs
    ``--num-pods 2`` with ``sum``, each reduction the bits of the flat
    all-reduce of the same buffers, then ``adasum``: finite, the ranks the
    same bits.  The ``dp_train`` line: the update wall ms beside the
    one-rank run's (two ranks time-share one card: not a scaling figure),
    the reductions' ms and bytes, flat and two-level, the launches a rank.
    Returns rank 0's launches."""
    import numpy as np

    from unicore_tpu_torch import checkpoint_utils

    p = cfg["phase15"]
    dev = cfg["device"]
    save_dir = fresh_dir(WORK / "dp_ckpt")
    dist_flags = ["--distributed-world-size", "2", "--distributed-backend", "gloo"]
    stats = run_train_cli("dp_train", dp_argv(cfg, data, save_dir, dev.type, p["updates"],
                                              *dist_flags),
                          dev, {"updates": p["updates"],
                                "per_micro_batch": cfg["train"]["per_micro_batch"]},
                          p["timeout_s"], falling=False)
    rank_launch_check("dp_train", cfg, stats)
    digests = {r["param_sha256"] for r in stats["ranks"]}
    one, one_wall = one_process_reference(torch, cfg, data, p["updates"])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(stats["loss_per_update"],
                                                          one.update_losses))
    gnorm_rel = max(abs(a - b) / abs(b) for a, b in zip(stats["gnorm_per_update"],
                                                           one.update_gnorms))
    saved = checkpoint_utils.load_checkpoint_to_cpu(str(save_dir / "checkpoint_last.pt"))
    param_err = max((saved["model"][n].float() - q.detach().float().cpu()).abs().max().item()
                    for n, q in one.model.named_parameters())
    one_losses, one_gnorms = list(one.update_losses), list(one.update_gnorms)
    del one, saved
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    pair_out = fresh_dir(WORK / "dp_pair")
    argv = ["--out", str(pair_out), "--combines", "sum,adasum",
            "--zero-stages", ",".join(ZERO_LEGS), "--",
            *dp_argv(cfg, data, WORK / "dp_pair_ckpt", dev.type, p["pair_updates"],
                     *dist_flags, "--num-pods", "2", "--no-save")]
    t0 = time.monotonic()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    with open(WORK / "dp_pair.log", "w") as f:
        proc = subprocess.run([sys.executable, "-m", "unicore_tpu_torch.tools.dp_pair",
                               *argv], stdout=f, stderr=subprocess.STDOUT, cwd=str(ROOT),
                              env=env, timeout=p["timeout_s"])
    if proc.returncode != 0:
        raise RuntimeError(f"15c: dp_pair exited {proc.returncode}:\n"
                           f"{(WORK / 'dp_pair.log').read_text()[-6000:]}")
    pair = [json.loads((pair_out / f"dp_pair_rank{r}.json").read_text()) for r in range(2)]
    pair_s = time.monotonic() - t0
    runs = pair[0]["runs"]
    pair_res = {}
    for mode, rec in runs.items():
        st = rec["stats"]
        rank_launch_check(f"dp_pair {mode}", cfg, st)
        pair_res[mode] = {
            "losses": rec["losses"], "gnorms": rec["gnorms"], "plan": rec["plan"],
            "ranks_equal": len({r["param_sha256"] for r in st["ranks"]}) == 1,
            "finite": all(x["runs"][mode]["finite"] for x in pair) and all(
                math.isfinite(v) for v in rec["losses"] + rec["gnorms"]),
            "sum_equals_flat": [x["runs"][mode]["sum_equals_flat"] for x in pair],
            "reduction": st["distributed"], "median_update_wall_ms":
                st["median_update_wall_ms"]}
    line = {
        "arch": cfg["arch"], "ranks": 2, "backend": stats["distributed"]["backend"],
        "batch_per_rank": cfg["batch"], "updates": stats["updates"],
        "loss_per_update": stats["loss_per_update"],
        "one_process_loss_per_update": one_losses,
        "gnorm_per_update": stats["gnorm_per_update"],
        "one_process_gnorm_per_update": one_gnorms,
        "loss_max_rel_diff": loss_rel, "gnorm_max_rel_diff": gnorm_rel,
        "param_max_abs_diff": param_err,
        "tolerances": {"loss_rel": p["loss_rel"], "gnorm_rel": p["gnorm_rel"],
                       "param_abs": p["param_tol"]},
        "ranks_equal": len(digests) == 1,
        "median_update_wall_ms": stats["median_update_wall_ms"],
        "update_wall_ms": stats["update_wall_ms"],
        "one_process_median_update_wall_ms": float(np.median(one_wall)),
        "one_process_update_wall_ms": one_wall,
        "reduction": stats["distributed"],
        "launches_per_rank": [{"rank": r["rank"], "micro_batches": r["micro_batches"],
                               "kernel_launches": {k: v for k, v in r["kernel_launches"].items()
                                                   if v}} for r in stats["ranks"]],
        "two_level": pair_res, "pair_seconds": pair_s, "card": card, "nvidia_smi": smi,
    }
    print("dp_train " + json.dumps(line), flush=True)
    if len(digests) != 1:
        raise AssertionError(f"15b: the ranks' parameters differ: {stats['ranks']}")
    if not (loss_rel <= p["loss_rel"] and gnorm_rel <= p["gnorm_rel"]
            and param_err <= p["param_tol"]):
        raise AssertionError(f"15b: two ranks against the one-rank --update-freq 2 run: "
                             f"loss {loss_rel}, gnorm {gnorm_rel}, params {param_err}")
    for mode, r in pair_res.items():
        if not (r["finite"] and r["ranks_equal"]):
            raise AssertionError(f"15c: {mode}: {r}")
    sums = pair_res["sum"]["sum_equals_flat"]
    if not (all(all(v) for v in sums) and all(len(v) == p["pair_updates"] for v in sums)):
        raise AssertionError(f"15c: the two-level sum left the flat all-reduce's bits: {sums}")
    zero_launches = check_zero_legs(cfg, pair, card, smi)
    return stats["ranks"][0]["kernel_launches"], zero_launches


def check_zero_legs(cfg, pair, card, smi):
    """15d: the ZeRO legs of the pair (``pair``: each rank's record; each
    sharded leg updated from its stage-0 leg's gradients): each leg's ranks
    the same parameters, and its dtype's stage-0 leg's; its gradient norms
    the stage-0 leg's bits (the gathered partials of stages 2/3); each
    rank's own reduced gradient (the reduce-scatter's segment at stages
    2/3) within ``ZERO_GRAD_ABS`` of the stage-0 leg's; the optimizer state
    gathered to rank 0 the stage-0 leg's, and no other rank given it; each
    rank's state bytes at a sharded stage 1/world of stage 0's plus at most
    1/world of the padding, and the gather adding on no card the whole
    state, on a rank other than 0 no more than its share; 4a's launches per
    micro-batch plus one K-a and one K-b an update on each rank; the stage-2
    leg's save and reload bit for bit on every rank.  Prints the
    ``dp_zero`` line; returns rank 0's launches in the stage-2 leg."""
    from unicore_tpu_torch.optim.multi_tensor import NORM_SPAN

    p = cfg["phase15"]
    legs = pair[0]["zero"]
    world = len(pair)
    lines, problems = {}, []
    for leg in ZERO_LEGS:
        rec, st = legs[leg], legs[leg]["stats"]
        dtype = "bf16" if leg.startswith("bf16") else "fp32"
        base = legs["bf16:0" if dtype == "bf16" else "0"]
        rank_launch_check(f"dp_zero {leg}", cfg, st)
        on_card = cfg["device"].type == "cuda"
        for r in st["ranks"]:
            for k in ("multi_tensor_l2norm", "fused_adam"):
                want = p["pair_updates"] if on_card else 0
                if r["kernel_launches"].get(k, 0) != want:
                    problems.append(f"{leg}: rank {r['rank']}: {k} "
                                    f"{r['kernel_launches'].get(k)}, want {want}")
        shas = [r["param_sha256"] for r in st["ranks"]]
        whole = base["stats"]["ranks"][0]["memory"]["optimizer_state_bytes"]
        buffers = 3 if leg.startswith("bf16") else 2
        numel = whole // (4 * buffers)
        pad = -(-numel // (world * NORM_SPAN)) * world * NORM_SPAN - numel
        state_bytes = [r["memory"]["optimizer_state_bytes"] for r in st["ranks"]]
        line = {
            "zero_stage": rec["zero_stage"], "param_sha256": shas,
            "ranks_equal": len(set(shas)) == 1,
            "params_equal_stage0": shas[0] == base["stats"]["ranks"][0]["param_sha256"],
            "state_equal_stage0": rec["state"] == base["state"],
            "state_bytes": state_bytes, "stage0_state_bytes": whole,
            "padding_bytes": pad * 4 * buffers,
            "peak_allocated_bytes": [r["memory"]["peak_allocated_bytes"] for r in st["ranks"]],
            "losses": rec["losses"], "gnorms": rec["gnorms"],
            "median_update_wall_ms": st["median_update_wall_ms"],
            "update_wall_ms": st["update_wall_ms"], "step_ms": st["step_ms"],
            "reduction": {k: st["distributed"][k] for k in
                          ("ms_per_update", "buffer_bytes", "reduce_scatter", "backend")},
            "seconds": rec["seconds"]}
        line["gnorms_equal_stage0"] = rec["gnorms"] == base["gnorms"]
        line["state_on_ranks"] = [x["zero"][leg]["rank_got_state"] for x in pair]
        ok_share = True
        if rec["zero_stage"] > 0:
            line["state_bytes_share_plus_padding"] = all(
                0 <= b - whole / world <= pad * 4 * buffers / world for b in state_bytes)
            line["own_grad_max_abs_diff"] = [x["zero"][leg]["grad_max_abs_diff"] for x in pair]
            line["grad_max_abs"] = [x["zero"][leg]["grad_max_abs"] for x in pair]
            line["grad_abs_tolerance"] = ZERO_GRAD_ABS[dtype]
            ok_share = (line["state_bytes_share_plus_padding"]
                        and line["state_on_ranks"] == [r == 0 for r in range(world)]
                        and all(d <= ZERO_GRAD_ABS[dtype]
                                for x in line["own_grad_max_abs_diff"] for d in x)
                        and max(max(x) for x in line["grad_max_abs"]) > ZERO_GRAD_ABS[dtype])
        else:
            line["state_bytes_share_plus_padding"] = None
        if cfg["device"].type == "cuda":
            before = [x["zero"][leg]["allocated_before_save_bytes"] for x in pair]
            peak = [x["zero"][leg]["save_peak_allocated_bytes"] for x in pair]
            line["allocated_before_save_bytes"], line["save_peak_allocated_bytes"] = before, peak
            line["save_added_bytes"] = [b - a for a, b in zip(before, peak)]
            if rec["zero_stage"] > 0:
                ok_share = ok_share and all(
                    added < whole and (r == 0 or added <= state_bytes[r])
                    for r, added in enumerate(line["save_added_bytes"]))
        if "reload_equal" in rec:
            line["reload_equal"] = [x["zero"][leg]["reload_equal"] for x in pair]
        lines[leg] = line
        if not (line["ranks_equal"] and line["params_equal_stage0"]
                and line["state_equal_stage0"] and line["gnorms_equal_stage0"] and ok_share
                and all(line.get("reload_equal", [True]))):
            problems.append(f"{leg}: {json.dumps(line)}")
    reloads = [leg for leg, line in lines.items() if "reload_equal" in line]
    if reloads != ["2"]:
        problems.append(f"the save and reload ran in {reloads}, want the stage-2 leg")
    print("dp_zero " + json.dumps({"arch": cfg["arch"], "ranks": world, "legs": lines,
                                   "seconds": sum(legs[leg]["seconds"] for leg in ZERO_LEGS),
                                   "card": card, "nvidia_smi": smi}), flush=True)
    if problems:
        raise AssertionError("dp_zero: " + "; ".join(problems))
    return legs["2"]["stats"]["ranks"][0]["kernel_launches"]


CHIP = {
    # the training path's buckets: 512 and 384 (documents of 380-510 words)
    # and the serving path's smallest, 128
    "attention": [(8, 12, 512, 64), (8, 12, 384, 64), (8, 12, 128, 64)],
    "attention_causal": (8, 12, 512, 64),
    "attention_bwd": [(8, 12, 512, 64), (8, 12, 384, 64), (8, 12, 128, 64)],
    # Uni-Mol's head norms: D = 64 over B * L**2 rows; the Evoformer's msa
    # (32 rows x 256 residues, D = 256) and pair (256**2 rows, D = 128) norms;
    # Uni-Mol's layer norms (16 x 128 tokens, D = 512)
    "norm": [(4096, 768), (4097, 1024), (16 * 128 * 128, 64), (32 * 256, 256),
             (256 * 256, 128), (2048, 512)],
    # Uni-Mol's micro-batch (16 x 64 heads, L = 128) first, fp32 then bf16
    "softmax": [
        {"shape": (16, 64, 128, 128), "rate": 0.1, "dtype": "float32"},
        {"shape": (16, 64, 128, 128), "rate": 0.0, "dtype": "float32"},
        {"shape": (16, 64, 128, 128), "rate": 0.1, "dtype": "bfloat16"},
        {"shape": (4, 64, 256, 256), "rate": 0.1, "dtype": "float32"},
        {"shape": (2, 64, 512, 512), "rate": 0.1, "dtype": "float32"},
        {"shape": (4, 8, 128, 256), "mask": (4, 1, 1, 256), "bias": (1, 8, 128, 256),
         "rate": 0.1, "dtype": "float32"},
        {"shape": (6, 64, 384), "bias": (2, 64, 384), "rate": 0.1, "dtype": "float32"},
        {"shape": (16, 64, 128, 128), "neg_inf": True, "rate": 0.1, "dtype": "float32"},
    ],
    "softmax_mask": (16 * 64, 128, 128),
    # the Evoformer's attentions at phase 6a's batch 1 (one bias slab shared
    # by every lead row, R = 256 or 32: dbias takes its chunked plan):
    # triangle (the lead rows of the pair, 24 of the 36 calls a micro-batch)
    # first, then MSA-row; the same at batch 2 (a grouped bias, Bb = 2, as
    # in phase 6b); a shared bias (Bb = Hb = 1); and a BERT shape the
    # full-row gate refuses (1152 rows), with dropout
    "flash": [
        {"name": "triangle", "shape": (256, 4, 256, 32), "bias": (1, 4, 256, 256)},
        {"name": "msa_row", "shape": (32, 8, 256, 32), "bias": (1, 8, 256, 256)},
        {"name": "triangle_b2", "shape": (2 * 256, 4, 256, 32), "bias": (2, 4, 256, 256)},
        {"name": "msa_row_b2", "shape": (2 * 32, 8, 256, 32), "bias": (2, 8, 256, 256)},
        {"name": "shared_bias", "shape": (8, 4, 256, 32), "bias": (1, 1, 256, 256)},
        {"name": "bert_router", "shape": (2, 12, 1152, 64), "bias": (1, 12, 1152, 1152),
         "rate": 0.1},
    ],
    "flash_mask": (2, 12, 1152, 64),
    # phase 7's decode step: batch 8, 12 heads of 64, the top cache bucket
    # with every position live, fp32 KV and the bias row; then bf16, int8
    # KV, mixed positions with junk past them, and the smallest bucket
    "decode_checks": [
        {"name": "serve", "shape": (8, 12, 512, 64), "dtype": "float32"},
        {"name": "serve_bf16", "shape": (8, 12, 512, 64), "dtype": "bfloat16"},
        {"name": "serve_int8", "shape": (8, 12, 512, 64), "dtype": "float32", "int8": True},
        {"name": "mixed", "shape": (8, 12, 512, 64), "dtype": "float32", "mixed": True},
        {"name": "bucket128", "shape": (8, 12, 128, 64), "dtype": "float32"},
        {"name": "repeat", "shape": (8, 12, 512, 64), "dtype": "float32", "mixed": True,
         "neg_inf": True, "repeat": True},
    ],
    # the bf16-query variant at phase 7's bucket-512 shape, as a bf16 LM's
    # decode step gives it: a bf16 q and bias row against the fp32 pool,
    # then against int8 caches
    "decode_bf16q_checks": [
        {"name": "serve_bf16q", "shape": (8, 12, 512, 64), "dtype": "bfloat16",
         "kv": "float32", "bias": "bfloat16"},
        {"name": "serve_bf16q_int8", "shape": (8, 12, 512, 64), "dtype": "bfloat16",
         "int8": True, "bias": "bfloat16"},
        {"name": "mixed_bf16q", "shape": (8, 12, 512, 64), "dtype": "bfloat16",
         "kv": "float32", "bias": "bfloat16", "mixed": True, "neg_inf": True,
         "repeat": True},
    ],
    # the int8 serving kernels at BERT-base serving shapes, batch 8 x 512
    # rows: the denses in_proj, out_proj, fc1 (GELU), fc2, the LM head's
    # (GELU), and an M that is not a multiple of 16; the LM head's norm with a scalar and a
    # per-channel scale; the scores at the top bucket (int32) and an int8
    # input at the smallest
    "quant_matmul": [
        {"name": "in_proj", "M": 4096, "K": 768, "N": 2304, "act": "", "bias": True},
        {"name": "out_proj", "M": 4096, "K": 768, "N": 768, "act": "", "bias": True},
        {"name": "fc1", "M": 4096, "K": 768, "N": 3072, "act": "gelu", "bias": True},
        {"name": "fc2", "M": 4096, "K": 3072, "N": 768, "act": "", "bias": True},
        {"name": "lm_head", "M": 4096, "K": 768, "N": 768, "act": "gelu", "bias": True},
        {"name": "odd_m", "M": 4093, "K": 768, "N": 2304, "act": "", "bias": True},
    ],
    "quant_norm": [(4096, 768, False), (4096, 768, True)],
    "quant_softmax": [{"shape": (8, 12, 512, 512), "dtype": "int32"},
                      {"shape": (8, 12, 128, 128), "dtype": "int8"}],
    # phase 8: 12 requests over every bucket of 128/256/384/512, 4 at fp8
    "quant_serve": {"layers": 12, "fp8_requests": 4, "profile_batches": 10,
                    "lengths": [30, 200, 300, 450, 128, 256, 384, 512, 90, 250, 380, 500],
                    "rel_drift_bound": {"int8": 0.05, "fp8": 0.15},
                    # the swapped-in int8 twin's scores against the CPU's
                    "reload_score_rel": 5e-3},
    "iters": 100,
    "arch": "bert_base", "symbols": 30000, "batch": 8, "seed": 0,
    "docs": 400, "doc_words": (380, 510),
    "train": {"updates": 20, "update_freq": 2, "lr": 1e-4, "warmup": 5,
              "timeout_s": 600,
              "per_micro_batch": {"fullrow_attention_fwd": 12,
                                  "fullrow_attention_bwd": 12,
                                  "fused_norm_fwd": 26, "fused_norm_dx": 26,
                                  "fused_norm_dwdb": 26}},
    "card_vs_cpu": {"updates": 3, "seq_len": 256, "param_tol": 1e-5},
    # every bucket of 128/256/384/512 at both of its edges, plus a few more
    "lengths": [1, 17, 64, 100, 128, 129, 200, 256, 257, 300, 384, 385,
                450, 500, 511, 512, 33, 77, 222, 333],
    "ready_budget_s": 600,
    "per_batch": {"fullrow_attention_fwd": 12, "fused_norm_fwd": 26},
    # 15 layers: one fused softmax each; norms: 2 per layer, the embedding,
    # final, head (over heads), LM-head and distance-head norms
    "unimol": {"arch": "unimol", "batch": 16, "seed": 3, "atoms": (119, 126),
               "conformers": 320, "length": 128, "extra_args": [],
               "train": {"updates": 20, "lr": 1e-4, "warmup": 5, "timeout_s": 600,
                         "per_micro_batch": {"softmax_dropout_fwd": 15,
                                             "softmax_dropout_bwd": 15,
                                             "fused_norm_fwd": 35, "fused_norm_dx": 35,
                                             "fused_norm_dwdb": 35,
                                             "fullrow_attention_fwd": 0,
                                             "fullrow_attention_bwd": 0}},
               "card_vs_cpu": {"updates": 3, "batch": 4, "param_tol": 1e-5}},
    # the full `evoformer` arch (12 blocks, msa 256 / 8 heads, pair 128 / 4
    # heads, dropout 0.1) at batch 1 (Uni-Fold's per-card batch; the port has
    # no remat) and 32 MSA rows; targets of 249-256 residues pad every
    # micro-batch to L = 256.  Flash: 3 forwards a block; the last block's
    # pair updates do not reach the loss, so 34 of each backward kernel.
    # Norms: 12 a block and the final one; 8 of the last block's have no
    # backward.  The MSA column attention (over 32 rows) runs the plain
    # composition, as the JAX package runs jnp there.
    "evoformer": {"arch": "evoformer", "batch": 1, "seed": 4, "msas": 48,
                  "residues": (249, 256), "rows": (40, 64), "max_rows": 32, "length": 256,
                  "extra_args": [],
                  "train": {"updates": 20, "update_freq": 2, "lr": 1e-3, "warmup": 5,
                            "timeout_s": 900,
                            "per_micro_batch": {"flash_attention_fwd": 36,
                                                "flash_attention_dq": 34,
                                                "flash_attention_dkv": 34,
                                                "flash_attention_db": 34,
                                                "fused_norm_fwd": 145, "fused_norm_dx": 137,
                                                "fused_norm_dwdb": 137,
                                                "fullrow_attention_fwd": 0,
                                                "fullrow_attention_bwd": 0,
                                                "softmax_dropout_fwd": 0,
                                                "softmax_dropout_bwd": 0}},
                  "card_vs_cpu": {"updates": 3, "batch": 2, "blocks": 2, "length": 128,
                                  "max_rows": 16, "param_tol": 1e-5}},
    # the full `transformer_lm` arch (6 layers, 768 wide, 12 heads, FFN 3072,
    # max_seq_len 512) on phase 4a's dictionary, cache buckets
    # 128/256/384/512; 24 prompts of 20-470 tokens (each bucket in the
    # sequential first half), 32 new tokens each; launches per decode step
    # 6 decode attentions, per prefill batch 6 full-row forwards, per
    # dispatch 14 norm forwards
    "decode": {"arch": "transformer_lm", "seed": 7, "layers": 6, "prefill_batch": 8,
               "decode_batch": 8, "cache_pages": 512, "max_new": 32,
               "lengths": [20, 470, 127, 300, 64, 350, 200, 420, 383, 100, 260, 450,
                           40, 150, 240, 330, 400, 460, 90, 310, 180, 255, 385, 128],
               "int8_requests": 8, "cpu_gap": 1e-3, "ready_budget_s": 600,
               "parity": {"batch": 8, "prompt": 112, "steps": 16, "cache": 128},
               "profile": {"batch": 8, "bucket": 512, "steps": 20, "start": 480}},
    # phase 9: the full `transformer_lm` on phase 4a's corpus (25 updates an
    # epoch), validated and saved every 10 updates; 8 served prompts, every
    # cache bucket; 9d at L = 256 (the full-row kernels) and L = 200 (the
    # plain softmax composition)
    "lm_train": {"arch": "transformer_lm", "extra_args": [], "layers": 6, "updates": 20,
                 "interval": 10, "lr": 5e-4, "valid_docs": 40, "timeout_s": 600,
                 "serve_lengths": [20, 470, 127, 300, 200, 383, 64, 260],
                 "card_vs_cpu": {"updates": 3, "batch": 4,
                                 "lengths": [(256, 128, 0.1), (200, 8, 0.0)]}},
    # phase 3's mixed-precision inputs: the norms at BERT-base's (4096, 768)
    # with bf16 and fp16 x, weight and bias, and at Uni-Mol's and the
    # Evoformer's D = 64 / 128 / 256 rows in bf16 as --bf16 runs them; the
    # full-row kernels at (8, 12, 512, 64) bf16 with a bf16 bias (with and
    # without the causal triangle); the flash kernels at the triangle shape
    # with a bf16 bias
    "mixed": {"norm": [(4096, 768, "bfloat16", "bfloat16"), (4096, 768, "float16", "float16"),
                       (16 * 128 * 128, 64, "bfloat16", "bfloat16"),
                       (256 * 256, 128, "bfloat16", "bfloat16"),
                       (32 * 256, 256, "bfloat16", "bfloat16")],
              "attention": (8, 12, 512, 64),
              "flash": {"name": "triangle", "shape": (256, 4, 256, 32),
                        "bias": (1, 4, 256, 256), "bias_dtype": "bfloat16"}},
    # phase 10: 10a/10b against 4a/9a, 10b's resume, 10d card against CPU
    "bf16": {"loss_rel": 0.02, "resume_rel": 1e-3,
             "card_vs_cpu": {"loss_rel": 1e-2, "gnorm_rel": 5e-2, "master_rel": 0.1}},
    "fp16": {"updates": 10,
             "per_micro_batch": {"fused_norm_fwd": 26, "fused_norm_dx": 26,
                                 "fused_norm_dwdb": 26, "fullrow_attention_fwd": 0,
                                 "fullrow_attention_bwd": 0, "softmax_dropout_fwd": 0,
                                 "softmax_dropout_bwd": 0}},
    # phase 3's K-a / K-b buffers: BERT-base's ~110M fp32 elements, an odd
    # length and one element; phase 11 (see its functions)
    "multi_tensor": [110_000_000, 1_000_003, 1],
    "phase11": PHASE11,
    "phase12": PHASE12,
    "phase13": PHASE13,
    "phase14": PHASE14,
    "phase15": PHASE15,
    "phase16": PHASE16,
}
REHEARSAL = {
    "attention": [(2, 2, 128, 16)],
    "attention_causal": (2, 2, 128, 16),
    "attention_bwd": [(2, 2, 128, 16)],
    "norm": [(33, 64)],
    "softmax": [
        {"shape": (2, 4, 16, 128), "rate": 0.1, "dtype": "float32"},
        {"shape": (2, 4, 16, 128), "rate": 0.0, "dtype": "float32"},
        {"shape": (2, 4, 16, 128), "rate": 0.1, "dtype": "bfloat16"},
        {"shape": (2, 8, 256), "mask": (2, 1, 256), "bias": (1, 8, 256), "rate": 0.1,
         "dtype": "float32"},
        {"shape": (6, 8, 128), "bias": (2, 8, 128), "rate": 0.1, "dtype": "float32"},
        {"shape": (2, 4, 16, 128), "neg_inf": True, "rate": 0.1, "dtype": "float32"},
    ],
    "softmax_mask": (8, 16, 128),
    "flash": [
        {"name": "triangle", "shape": (16, 2, 128, 16), "bias": (1, 2, 128, 128)},
        {"name": "triangle_b2", "shape": (16, 2, 128, 16), "bias": (2, 2, 128, 128)},
        {"name": "shared_bias", "shape": (4, 2, 128, 16), "bias": (1, 1, 128, 128)},
        {"name": "bert_router", "shape": (2, 2, 256, 16), "bias": (1, 2, 256, 256),
         "rate": 0.1},
    ],
    "flash_mask": (1, 2, 256, 16),
    "decode_checks": [
        {"name": "serve", "shape": (2, 2, 64, 16), "dtype": "float32"},
        {"name": "serve_bf16", "shape": (2, 2, 64, 16), "dtype": "bfloat16"},
        {"name": "serve_int8", "shape": (2, 2, 64, 16), "dtype": "float32", "int8": True},
        {"name": "mixed", "shape": (3, 2, 64, 16), "dtype": "float32", "mixed": True},
        {"name": "repeat", "shape": (3, 2, 64, 16), "dtype": "float32", "mixed": True,
         "neg_inf": True, "repeat": True},
    ],
    "decode_bf16q_checks": [
        {"name": "serve_bf16q", "shape": (2, 2, 64, 16), "dtype": "bfloat16",
         "kv": "float32", "bias": "bfloat16"},
        {"name": "serve_bf16q_int8", "shape": (2, 2, 64, 16), "dtype": "bfloat16",
         "int8": True, "bias": "bfloat16"},
    ],
    "quant_matmul": [
        {"name": "in_proj", "M": 256, "K": 64, "N": 192, "act": "", "bias": True},
        {"name": "out_proj", "M": 256, "K": 64, "N": 64, "act": "", "bias": True},
        {"name": "fc1", "M": 256, "K": 64, "N": 128, "act": "gelu", "bias": True},
        {"name": "odd_m", "M": 250, "K": 128, "N": 64, "act": "", "bias": False},
    ],
    "quant_norm": [(256, 64, False), (256, 64, True)],
    "quant_softmax": [{"shape": (2, 4, 128, 128), "dtype": "int32"},
                      {"shape": (2, 4, 128, 128), "dtype": "int8"}],
    "quant_serve": {"layers": 2, "fp8_requests": 4, "profile_batches": 2,
                    "lengths": [10, 40, 70, 100, 32, 64, 96, 128],
                    "rel_drift_bound": {"int8": 0.05, "fp8": 0.15},
                    # the swapped-in int8 twin's scores against the CPU's
                    "reload_score_rel": 5e-3},
    "iters": 2,
    "arch": "bert_tiny", "symbols": 200, "batch": 4, "seed": 0,
    "docs": 48, "doc_words": (60, 126),
    "train": {"updates": 10, "update_freq": 2, "lr": 1e-3, "warmup": 2,
              "timeout_s": 300,
              "per_micro_batch": {"fullrow_attention_fwd": 2,
                                  "fullrow_attention_bwd": 2,
                                  "fused_norm_fwd": 6, "fused_norm_dx": 6,
                                  "fused_norm_dwdb": 6}},
    "card_vs_cpu": {"updates": 2, "seq_len": 128, "param_tol": 1e-5},
    "lengths": [1, 20, 32, 33, 64, 96, 97, 128],
    "ready_budget_s": 120,
    "per_batch": {"fullrow_attention_fwd": 2, "fused_norm_fwd": 6},
    "unimol": {"arch": "unimol_tiny", "batch": 4, "seed": 3, "atoms": (119, 126),
               "conformers": 40, "length": 128, "extra_args": ["--max-seq-len", "256"],
               "train": {"updates": 10, "lr": 1e-3, "warmup": 2, "timeout_s": 300,
                         "per_micro_batch": {"softmax_dropout_fwd": 2,
                                             "softmax_dropout_bwd": 2,
                                             "fused_norm_fwd": 9, "fused_norm_dx": 9,
                                             "fused_norm_dwdb": 9}},
               "card_vs_cpu": {"updates": 2, "batch": 4, "param_tol": 1e-5}},
    # a width whose MSA-row and triangle attentions take the flash route
    # (head dims 8, L = 120 padded to 128)
    "evoformer": {"arch": "evoformer", "batch": 1, "seed": 4, "msas": 24,
                  "residues": (113, 120), "rows": (10, 14), "max_rows": 8, "length": 120,
                  "extra_args": ["--num-blocks", "1", "--msa-dim", "64", "--msa-heads", "8",
                                 "--pair-dim", "32", "--pair-heads", "4",
                                 "--max-seq-len", "128"],
                  "train": {"updates": 10, "update_freq": 2, "lr": 1e-3, "warmup": 2,
                            "timeout_s": 600,
                            "per_micro_batch": {"flash_attention_fwd": 3,
                                                "flash_attention_dq": 1,
                                                "flash_attention_dkv": 1,
                                                "flash_attention_db": 1,
                                                "fused_norm_fwd": 13, "fused_norm_dx": 5,
                                                "fused_norm_dwdb": 5}},
                  "card_vs_cpu": {"updates": 2, "batch": 2, "blocks": 2, "length": 112,
                                  "max_rows": 8, "param_tol": 1e-5}},
    # `transformer_lm_tiny` (2 layers, 64 wide, max_seq_len 128): cache
    # buckets 32/64/96/128
    "decode": {"arch": "transformer_lm_tiny", "seed": 7, "layers": 2, "prefill_batch": 4,
               "decode_batch": 4, "cache_pages": 64, "max_new": 8,
               "lengths": [5, 100, 31, 60, 33, 90, 64, 70, 20, 110, 45, 96],
               "int8_requests": 4, "cpu_gap": 1e-3, "ready_budget_s": 120,
               "parity": {"batch": 2, "prompt": 16, "steps": 8, "cache": 32},
               "profile": {"batch": 4, "bucket": 128, "steps": 4, "start": 100}},
    # 6 updates an epoch: validated and saved every 2
    "lm_train": {"arch": "transformer_lm_tiny", "extra_args": [], "layers": 2,
                 "updates": 6, "interval": 2, "lr": 2e-3, "valid_docs": 8,
                 "timeout_s": 300, "serve_lengths": [5, 100, 31, 60, 33, 90, 64, 70],
                 "card_vs_cpu": {"updates": 2, "batch": 2,
                                 "lengths": [(128, 128, 0.1), (40, 8, 0.0)]}},
    "mixed": {"norm": [(33, 64, "bfloat16", "bfloat16"), (33, 64, "float16", "float16")],
              "attention": (2, 2, 128, 16),
              "flash": {"name": "triangle", "shape": (16, 2, 128, 16),
                        "bias": (1, 2, 128, 128), "bias_dtype": "bfloat16"}},
    "bf16": {"loss_rel": 0.02, "resume_rel": 1e-3,
             "card_vs_cpu": {"loss_rel": 1e-2, "gnorm_rel": 5e-2, "master_rel": 0.1}},
    "fp16": {"updates": 10,
             "per_micro_batch": {"fused_norm_fwd": 6, "fused_norm_dx": 6,
                                 "fused_norm_dwdb": 6}},
    "multi_tensor": [4099, 1],
    "phase11": dict(PHASE11, adama_updates=6),
    # 48 documents at batch 4 x 2: 6 updates an epoch
    "phase12": dict(PHASE12, updates=16, epoch_updates=6, snapshot_every=4, spike_at=9,
                    magnitude=1000, flip_at=13, sigterm_after=6, raise_at=5,
                    sentinel_flags=["--sentinel-interval", "1", "--snapshot-interval", "4",
                                    "--snapshot-keep", "2", "--sentinel-warmup", "4",
                                    "--loss-spike-window", "8"]),
    "phase13": PHASE13,
    "phase14": dict(PHASE14, loss_batch=120,
                    lengths=[1, 20, 32, 33, 64, 96, 97, 128, 5, 40, 70, 110]),
    "phase15": PHASE15,
    "phase16": PHASE16,
}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu-rehearsal", action="store_true",
                        help="phases 3 to 16 on the CPU at a tiny size, no card")
    opts = parser.parse_args(argv)
    if not (ROOT / "unicore_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: unicore_tpu_torch/ is not beside this script; run "
              "it from the root of a checkout", file=sys.stderr)
        return 2
    import torch

    if not opts.cpu_rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(REHEARSAL if opts.cpu_rehearsal else CHIP)
    cfg["device"] = torch.device("cpu") if opts.cpu_rehearsal else torch.device("cuda", 0)
    WORK.mkdir(parents=True, exist_ok=True)
    started = time.monotonic()
    phase_seconds = {}
    last = [started]

    def done(phase):
        """Log the phase's end and keep its seconds for ``phase_seconds``."""
        now = time.monotonic()
        phase_seconds[phase] = round(now - last[0], 1)
        last[0] = now
        log(f"phase {phase} done at {now - started:.0f}s")

    # 1. device
    card = "cpu" if opts.cpu_rehearsal else torch.cuda.get_device_name(0)
    smi = "not run" if opts.cpu_rehearsal else nvidia_smi()
    log(f"device {card}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {sys.version.split()[0]}")

    # 2. build
    from unicore_tpu_torch.ops import _kernels

    if not opts.cpu_rehearsal:
        t0 = time.monotonic()
        lib = _kernels.build()
        _kernels.library()
        log(f"kernels built in {time.monotonic() - t0:.1f}s: {lib.name}")
        for line in _kernels.build_log_path().read_text().splitlines():
            if any(s in line for s in ("Compiling entry", "Used", "spill", "==")):
                log("ptxas " + line.strip())

    # 3. kernels against their plain versions; the first entry of each
    # kernel is the training path's shape, fp32
    checks = {name: [] for name in KERNELS}
    dtypes = [torch.float32, torch.bfloat16]
    dev, iters = cfg["device"], cfg["iters"]

    def check(name, fn, *a, **kw):
        """``fn``'s check of kernel ``name``, lean past the kernel's first
        two checks (:data:`LEAN_PLAIN_MS`)."""
        return fn(*a, lean=len(checks[name]) >= 2, **kw)

    checks["fullrow_attention_fwd"].append(check(
        "fullrow_attention_fwd", check_attention, torch, dev, *cfg["attention"][0],
        torch.float32, iters, rate=0.1))
    for shape in cfg["attention"]:
        for dt in dtypes:
            checks["fullrow_attention_fwd"].append(check(
                "fullrow_attention_fwd", check_attention, torch, dev, *shape, dt, iters))
    mask_check = check_dropout_mask(torch, dev, cfg["attention"][0][0],
                                    cfg["attention"][0][1], 0.1, 2024)
    for shape in cfg["attention_bwd"]:
        for rate in (0.1, 0.0):
            for dt in dtypes:
                checks["fullrow_attention_bwd"].append(check(
                    "fullrow_attention_bwd", check_attention_bwd, torch, dev, *shape, dt,
                    iters, rate))
    # the causal LM's attention: the rel-pos bias plus the causal triangle
    checks["fullrow_attention_fwd"].append(check(
        "fullrow_attention_fwd", check_attention, torch, dev, *cfg["attention_causal"],
        torch.float32, iters, rate=0.1, causal=True))
    for dt in dtypes:
        checks["fullrow_attention_bwd"].append(check(
            "fullrow_attention_bwd", check_attention_bwd, torch, dev, *cfg["attention_causal"],
            dt, iters, 0.1, causal=True))
    for shape in cfg["norm"]:
        for dt in dtypes:
            for rms in (False, True):
                checks["fused_norm_fwd"].append(check(
                    "fused_norm_fwd", check_norm, torch, dev, *shape, dt, rms, iters))
                for kname, res in check("fused_norm_dx", check_norm_bwd, torch, dev, *shape,
                                        dt, rms, iters).items():
                    checks[kname].append(res)
    for c in cfg["softmax"]:
        f_res, b_res = check("softmax_dropout_fwd", check_softmax, torch, dev, c,
                             getattr(torch, c["dtype"]), iters)
        checks["softmax_dropout_fwd"].append(f_res)
        checks["softmax_dropout_bwd"].append(b_res)
    softmax_mask = check_softmax_mask(torch, dev, *cfg["softmax_mask"], 0.1, 2025)
    for c in cfg["flash"]:
        for dt in dtypes:
            for kname, res in check("flash_attention_fwd", check_flash, torch, dev, c, dt,
                                    iters).items():
                checks[kname].append(res)
    flash_mask = check_flash_mask(torch, dev, *cfg["flash_mask"], 0.1, 2026)
    for c in cfg["decode_checks"]:
        checks["decode_attention"].append(check(
            "decode_attention", check_decode, torch, dev, c, iters))
    for c in cfg["decode_bf16q_checks"]:
        checks["decode_attention_bf16q"].append(check(
            "decode_attention_bf16q", check_decode, torch, dev, c, iters))
    for c in cfg["quant_matmul"]:
        checks["quant_matmul"].append(check("quant_matmul", check_quant_matmul, torch, dev, c,
                                            iters))
    for N, D, per_channel in cfg["quant_norm"]:
        checks["quant_layer_norm"].append(check(
            "quant_layer_norm", check_quant_norm, torch, dev, N, D, per_channel, iters))
    for c in cfg["quant_softmax"]:
        checks["quant_softmax_dropout_fwd"].append(check(
            "quant_softmax_dropout_fwd", check_quant_softmax, torch, dev, c, iters))
    # the inputs of a --bf16 / --fp16 run (phase 10): the norms with their
    # weight and bias in the run's type, the attention kernels with a bf16
    # bias, every gradient in its input's type
    mixed = cfg["mixed"]
    for N, D, xd, wd in mixed["norm"]:
        xd, wd = getattr(torch, xd), getattr(torch, wd)
        for rms in (False, True):
            checks["fused_norm_fwd"].append(check(
                "fused_norm_fwd", check_norm, torch, dev, N, D, xd, rms, iters, wd))
            for kname, res in check("fused_norm_dx", check_norm_bwd, torch, dev, N, D, xd, rms,
                                    iters, wd).items():
                checks[kname].append(res)
    # (the forward with an fp32 bias at rate 0.1 too: the backward's is in
    # the loop above, the flash kernels' at "triangle" there)
    for causal, bias_dtype in ((False, torch.float32), (False, torch.bfloat16),
                               (True, torch.bfloat16)):
        checks["fullrow_attention_fwd"].append(check(
            "fullrow_attention_fwd", check_attention, torch, dev, *mixed["attention"],
            torch.bfloat16, iters, rate=0.1, causal=causal, bias_dtype=bias_dtype))
    for causal in (False, True):
        checks["fullrow_attention_bwd"].append(check(
            "fullrow_attention_bwd", check_attention_bwd, torch, dev, *mixed["attention"],
            torch.bfloat16, iters, 0.1, causal=causal, bias_dtype=torch.bfloat16))
    for kname, res in check("flash_attention_fwd", check_flash, torch, dev, mixed["flash"],
                            torch.bfloat16, iters).items():
        checks[kname].append(res)
    # the optimizer plane's kernels: K-a, then K-b with fp32 parameters,
    # bf16 ones rounded to nearest even, and bf16 ones under SR
    for n in cfg["multi_tensor"]:
        checks["multi_tensor_l2norm"].append(check(
            "multi_tensor_l2norm", check_l2norm, torch, dev, n, iters))
        for kind in ("float32", "bfloat16", "bfloat16_sr"):
            checks["fused_adam"].append(check("fused_adam", check_fused_adam, torch, dev, n,
                                              kind, iters))
    done("3")

    # 4a. training through the CLI; 4b. card against CPU; 4. serving
    data = write_corpus(cfg)
    ckpt, train_stats = drive_training(torch, cfg, data, card, smi)
    train_launches = train_stats["kernel_launches"]
    done("4a")
    drive_card_vs_cpu(torch, cfg, data)
    done("4b")
    # 4. serving, on replica 0 of phase 14's fleet, which starts with it;
    # 14. the fleet: routed, a rolling reload and a halted one, replica 1
    # lost, replica 0's goodbye and drain (phase 4's), the router's exit
    fleet = start_fleet(torch, cfg, ckpt)
    try:
        fp32_serve = drive_slice(torch, cfg, fleet, card, smi)
        serve_launches = fp32_serve["launches"]
        done("4")
        fleet_launches = drive_fleet(torch, cfg, fleet, fp32_serve, card, smi)
        done("14")
    finally:
        stop_fleet(fleet)

    # 5a. Uni-Mol training through the CLI; 5b. card against CPU
    um_data = write_conformers(cfg["unimol"])
    unimol_stats = drive_unimol_training(cfg, um_data, card, smi)
    unimol_launches = unimol_stats["kernel_launches"]
    done("5a")
    drive_unimol_card_vs_cpu(torch, cfg, um_data)
    done("5b")

    # 6a. Evoformer training through the CLI; 6b. card against CPU
    evo_data = write_msas(cfg["evoformer"], "evoformer_data")
    evoformer_launches = drive_evoformer_training(torch, cfg, evo_data, card, smi)
    done("6a")
    drive_evoformer_card_vs_cpu(torch, cfg, evo_data)
    done("6b")

    # 7. incremental-decode serving of the causal LM: fp32 KV, the card's
    # parity, int8 KV, a profile of the decode step
    lm_path, vocab, pad, eos = write_lm_checkpoint(torch, cfg, data)
    lm = {"vocab": vocab, "pad": pad, "eos": eos}
    fp32_decode = drive_decode_serving(torch, cfg, lm_path, lm, card, smi, "fp32")
    decode_launches = fp32_decode["launches"]
    check_decode_parity(torch, cfg, lm_path)
    decode8_launches = drive_decode_serving(torch, cfg, lm_path, lm, card, smi,
                                            "int8")["launches"]
    profile_decode_steps(torch, cfg, lm_path, lm, card, smi)
    done("7")

    # 8. quantized serving of phase 4a's checkpoint: int8 (from a copy,
    # which its hot reload replaces; the profile reads the copy and the
    # sidecar the reload re-derived), then fp8
    quant_path = fresh_dir(WORK / "quant_int8") / "checkpoint_last.pt"
    shutil.copy(ckpt, quant_path)
    quant_launches = drive_quant_serving(torch, cfg, quant_path, card, smi, "int8")
    profile_serve_batches(torch, cfg, quant_path, card, smi)
    quant8_launches = drive_quant_serving(torch, cfg, ckpt, card, smi, "fp8")
    done("8")

    # 9. causal-LM training through the CLI with validation, the EMA and
    # checkpoints (9a), resumed mid-epoch (9b), card against CPU (9d); its
    # checkpoint is served in 13b, in bf16
    _, lm_stats = drive_lm_training(torch, cfg, data, card, smi)
    lm_train_launches = lm_stats["kernel_launches"]
    done("9a-9b")
    drive_lm_card_vs_cpu(torch, cfg, data)
    done("9d")

    # 10. mixed precision: BERT-base in bf16 with SR against 4a (10a), the
    # LM in bf16 against 9a and resumed (10b), fp16 with the loss scale
    # (10c), bf16 card against CPU for the four families (10d)
    bf16_stats = drive_bf16_training(torch, cfg, data, train_stats, card, smi)
    bf16_launches = bf16_stats["kernel_launches"]
    done("10a")
    lm_bf16_launches = drive_lm_bf16_training(torch, cfg, data, lm_stats, card, smi)
    done("10b")
    fp16_launches = drive_fp16_training(torch, cfg, data, card, smi)
    done("10c")
    drive_bf16_card_vs_cpu(torch, cfg, data, um_data, evo_data)
    done("10d")

    # 11. the optimizer and loader plane: 10a with --fused-adam, workers
    # and the device prefetcher (11a); --fused-adam card against CPU and
    # its cross-flag resume (11b); adama (11c); 5a with the loader threads
    # and the prefetcher (11d); per-sample clip, sgd, --nan-rerun (11e)
    fused_stats = drive_fused_training(torch, cfg, data, bf16_stats, card, smi)
    done("11a")
    # 16a: 11a's run's telemetry
    check_train_telemetry(torch, cfg, fused_stats, card, smi)
    done("16a")
    drive_fused_card_vs_cpu(torch, cfg, data)
    done("11b")
    drive_adama(torch, cfg, data, card, smi)
    done("11c")
    drive_loader(cfg, um_data, unimol_stats, card, smi)
    done("11d")
    drive_optimizer_paths(torch, cfg, data)
    done("11e")

    # 12. the robustness plane on 11a's cell: the unarmed control (12a),
    # the armed run, healthy up to an injected loss spike and rewound (12b),
    # the corrupt-checkpoint fallback (12c), the preemption and on-error
    # emergency saves (12d)
    fresh_dir(WORK / "robust_telemetry")
    flip_stats, flip_dir = drive_robust_control(cfg, data)
    done("12a")
    spike_stats = drive_robust_rewind(cfg, data, flip_stats, card, smi)
    done("12b")
    drive_robust_corrupt(cfg, data, flip_stats, flip_dir, card, smi)
    done("12c")
    drive_robust_preempt(cfg, data, flip_stats, card, smi)
    done("12d")
    # 16b: the port's trace merger on phase 12's journals
    drive_trace_merger(cfg, card, smi)
    done("16b")

    # 13. the serving control plane: 10a's bf16 checkpoint served in bf16
    # under a request flood (13a); 10b's bf16 LM served over /v1/generate
    # through the bf16-query decode kernel, a rotten hot reload rolled back
    # and the re-published one swapped in (13b)
    bf16_serve_launches = drive_bf16_serving(
        torch, cfg, WORK / "bf16_ckpt" / "checkpoint_last.pt", fp32_serve, card, smi)
    done("13a")
    lm_bf16_serve_launches = drive_lm_bf16_serving(torch, cfg, lm, fp32_decode, card, smi)
    done("13b")

    # 15. data parallelism: 11a and its profile ran under a one-rank NCCL
    # group (15a); two ranks of the train CLI over gloo against the one-rank
    # --update-freq 2 run (15b); --num-pods 2, sum and adasum, in one pair
    # (15c), then in the same pair the ZeRO legs (15d)
    dp_launches, zero_launches = drive_dp_training(torch, cfg, data, card, smi)
    done("15b-15d")
    print("phase_seconds " + json.dumps(phase_seconds), flush=True)
    if opts.cpu_rehearsal:
        log("CPU rehearsal complete (no card: no kernels, no result line)")
        return 0

    # 17. result lines: each kernel at its main path's shape (fp32, the
    # first check of each) with every check beside it; ``launches`` is the
    # count of the run its slice ported it for (BERT training for the
    # attention and norm kernels, Uni-Mol for the fused softmax, the
    # Evoformer for the flash kernels, decode serving for the decode
    # attention, int8 serving for the quantized kernels), every path's
    # beside it
    by_path = {"train": train_launches, "serve": serve_launches,
               "unimol_train": unimol_launches, "evoformer_train": evoformer_launches,
               "decode_serve": decode_launches, "decode_serve_int8": decode8_launches,
               "quant_serve": quant_launches, "quant_serve_fp8": quant8_launches,
               "lm_train": lm_train_launches, "bf16_serve": bf16_serve_launches,
               "lm_bf16_serve": lm_bf16_serve_launches, "fleet_serve": fleet_launches,
               "bf16_train": bf16_launches, "lm_bf16_train": lm_bf16_launches,
               "fp16_train": fp16_launches, "fused_train": fused_stats["kernel_launches"],
               "robust_train": spike_stats["kernel_launches"], "dp_train": dp_launches,
               "dp_zero": zero_launches}
    kernels = []
    for name, rows in checks.items():
        main_row = rows[0]
        replaces, source, path = KERNELS[name]
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": by_path[path].get(name, 0), "launches_path": path,
            "launches_by_path": {p: c.get(name, 0) for p, c in by_path.items()},
            "max_abs_err": main_row["max_abs_err"],
            "ms": main_row["ms"], "ms_spread": main_row["ms_spread"],
            "device_ms": main_row["device_ms"],
            "plain_ms": main_row["plain_ms"],
            "plain_device_ms": main_row["plain_device_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "library_device_ms": main_row["library_device_ms"],
            "shape": main_row["shape"], "dtype": main_row["dtype"],
            "checks": rows,
        }
        if name == "fullrow_attention_fwd":
            row["dropout_mask_check"] = mask_check
        if name == "softmax_dropout_fwd":
            row["dropout_mask_check"] = softmax_mask
            # the main shape at rate 0: the kernel beside torch.softmax, like for like
            rate0 = rows[1]
            row["rate0"] = {k: rate0[k] for k in ("ms", "device_ms", "library_ms",
                                                  "library_device_ms", "max_abs_err")}
        if name == "flash_attention_fwd":
            row["dropout_mask_check"] = flash_mask
        if name in ("fused_norm_fwd", "quant_layer_norm"):  # flushed times beside
            row.update(device_ms_flushed=main_row.get("device_ms_flushed"),
                       library_device_ms_flushed=main_row.get("library_device_ms_flushed"),
                       device_ops=main_row.get("device_ops"))
        if name == "fused_norm_fwd":
            row["training"] = main_row["training"]
        if name in ("fused_norm_dx", "fused_norm_dwdb"):  # one call, its flushed time beside
            row.update(fused_with=main_row["fused_with"],
                       device_ms_flushed=main_row["device_ms_flushed"],
                       library_device_ms_flushed=main_row.get("library_device_ms_flushed"),
                       device_ops=main_row["device_ops"])
        kernels.append(row)
    # every timed check's own device time was read (device_profile retries
    # an empty profile); any still without one is named here (the
    # one-element optimizer checks are not timed)
    missing = [f"{name} {r.get('shape')} {r.get('dtype')}" for name, rows in checks.items()
               for r in rows if "device_ms" in r and r["device_ms"] is None]
    print("missing_device_times " + json.dumps(missing), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
