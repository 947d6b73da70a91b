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
   ``iters`` calls, with the min-max spread) and its device time (the
   kernels' own durations from ``torch.profiler``, without the host's time
   between calls), the same two for the plain version and for one PyTorch
   library call (a backward timed alone on a retained autograd graph), and
   the least time the card could take (bytes over 3.35 TB/s or operations
   over the type's peak rate, whichever is larger; fp32 attention at the
   3xTF32 rate, 495 / 3 TFLOP/s, the least for fp32 accuracy on tensor
   cores);
4a. training — ``python -m unicore_tpu_torch.cli.train --device cuda`` on a
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
4. serving — the checkpoint 4a wrote, served by ``python -m
   unicore_tpu_torch.cli.serve --device cuda`` (batch 8, buckets
   128/256/384/512); requests of every bucket, some concurrent; per-batch
   kernel launches read from ``/stats`` (12 attention, 26 norm); two
   128-bucket answers held against the same checkpoint run in this process
   on the CPU; SIGTERM -> drain -> exit 0;
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
   ``torch.profiler``: device time by kernel group and the idle share;
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
   drift probe's launches, counted apart, subtracted; the probe's own held
   to the quantized plus the fp32 forward's); two answers held against the
   same checkpoint quantized in this process on the CPU from the server's
   sidecar (ids 99% equal, scores 1e-3 relative); in this process the
   served forward of a full top-bucket batch, int8 and fp32 on the same
   weights, timed and profiled (``quant_profile``: device ms by kernel
   group, idle share); then a ``--serve-quantize fp8`` server (4 requests; drift below 0.15; 12 full-row and 25 norm
   launches per batch, no W8A8 dense); each drains on SIGTERM and exits 0;
9. the ``nvidia-smi`` line (name, power limit), the ``kernels`` JSON line
   and, last, the ``{"ok": true, "device": ...}`` line.

Phase 3 also holds the softmax(+dropout) kernels against
``softmax_dropout_plain``: Uni-Mol's (16 * 64, 128, 128) fp32 at rate 0.1,
L=256 and 512, bf16, a ``bcast`` and a ``tile`` extra with their
gradients, rows holding -inf, and the keep mask read off the card bit for
bit against ``philox_keep_plain``; the norms at D=64 over 16 * 128**2
rows, the width of Uni-Mol's head norms, and at the Evoformer's D=256 and
D=128; and the four flash kernels (forward with its lse, dq, dk/dv,
dbias) against ``flash_attention_plain`` in fp32 and bf16 at phase 6a's
triangle (256, 4, 256, 32) and MSA-row (32, 8, 256, 32) shapes with their
(1, H, 256, 256) bias, the same at batch 2 with a grouped (2, H, 256, 256)
bias, a shared (1, 1) bias, and BERT's (2, 12, 1152, 64) at dropout 0.1 (past the full-row gate),
each with a fully masked key row, and the flash keep mask read off the
card bit for bit; the library yardstick there is one
``scaled_dot_product_attention`` with the bias expanded into its mask.  It
also holds the decode attention against ``decode_attention_plain`` at phase
7's step (8, 12, 512, 64) in fp32 and bf16, with int8 KV, with mixed
positions and junk rows past them, and at the 128 bucket; its yardstick is
SDPA over the single query row with the bias row and the dead rows in a
float mask (int8: the dequant, then SDPA).  And it holds the three int8
serving kernels at BERT-base serving shapes (8 x 512 = 4096 rows): the W8A8
dense against ``quant_matmul_plain`` at ``in_proj`` (768 -> 2304, bias),
``fc1`` (768 -> 3072, GELU), ``fc2`` (3072 -> 768), the LM head (768 ->
768, GELU) and an M of 4093 (1e-6 of the output's absmax; yardstick one
``torch._int_mm`` plus the epilogue in torch ops); the int8 LayerNorm at
(4096, 768) with a scalar and a per-channel scale (the dequant multiply
plus ``F.layer_norm``); the int8/int32 softmax on (8, 12, 512, 512) int32
scores with the (8, 1, 1, 512) ``finfo.min`` key mask and the (1, 12, 512,
512) bias, and on int8 at (8, 12, 128, 128) (the dequant multiply, the adds
and ``torch.softmax``).

Without a CUDA card, or without the port beside it, it exits non-zero.
``--cpu-rehearsal`` runs phases 3 to 8 on the CPU at ``bert_tiny``,
``unimol_tiny``, an Evoformer whose attentions take the flash route and
``transformer_lm_tiny``, through the plain versions (no card, no kernels,
no profile, no result line) to check the script's own control flow.
"""

import argparse
import json
import math
import os
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
#: 2**-8 below 1 and 2**-4 below 16 in magnitude).  Gradients, per element
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
    "norm": {"float32": 1e-5, "bfloat16": 6.25e-2},
    "softmax": 1e-6,
    "attention_grad": 1e-4,
    "norm_grad": 1e-5,
    "softmax_grad": 1e-5,
    "decode": 1e-5,
    "decode_bf16_ulps": 2 * 2.0 ** -7,
}
BF16_ULPS = 2.0 ** -6
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
    "quant_matmul": ("unicore_tpu/ops/quant_matmul.py:147",
                     "unicore_tpu_torch/csrc/quant_matmul.cu", "quant_serve"),
    "quant_layer_norm": ("unicore_tpu/ops/fused_norm.py:281",
                         "unicore_tpu_torch/csrc/fused_norm.cu", "quant_serve"),
    "quant_softmax_dropout_fwd": ("unicore_tpu/ops/softmax_dropout_pallas.py:443",
                                  "unicore_tpu_torch/csrc/softmax_dropout.cu", "quant_serve"),
}


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


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

def time_ms(torch, fn, device, iters=100, warm=10, repeats=5):
    """(median, [min, max]) milliseconds per call over ``repeats`` runs of
    ``iters`` warmed calls: CUDA events on the card, the host clock on the
    CPU rehearsal."""
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


def device_ms(torch, fn, iters=20):
    """Milliseconds of device work per call: the durations of the CUDA
    kernels and memsets the calls launch, summed by ``torch.profiler``
    (CUPTI) over ``iters`` warmed calls.  CUDA events around back-to-back
    calls also count the host's time between launches, which is most of a
    call of a few microseconds.  None where the profiler saw no device
    work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    return total_us / iters / 1e3 if total_us > 0 else None


def timed(res, key, torch, fn, device, iters):
    """res[key], res[<key>_spread]: ms per call by :func:`time_ms`; on the
    card also res[<key with device_ms>]: :func:`device_ms`."""
    res[key], res[key.replace("ms", "ms_spread")] = time_ms(torch, fn, device, iters)
    res[key.replace("ms", "device_ms")] = (
        device_ms(torch, fn) if device.type == "cuda" else None)


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
    return text


def grad_check(torch, name, got, ref, floor, slack=0.0):
    """(max abs error, max error over tolerance) of one gradient, raising
    past 1: per element, ``floor`` x max(1, max|ref|) + ``slack``, plus
    BF16_ULPS of the element where ``got`` is stored in bf16."""
    ref = ref.float()
    err = (got.float() - ref).abs()
    tol = floor * max(1.0, ref.abs().max().item()) + slack
    if got.dtype == torch.bfloat16:
        tol = tol + BF16_ULPS * ref.abs()
    worst, ratio = err.max().item(), (err / tol).max().item()
    if not (ratio <= 1.0 and math.isfinite(worst)):
        raise AssertionError(f"{name}: max abs err {worst}, {ratio} x its tolerance")
    return worst, ratio


def attention_inputs(torch, device, B, H, L, D, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q = (torch.randn(B, H, L, D, generator=g, device=device) * D ** -0.5).to(dtype)
    k = torch.randn(B, H, L, D, generator=g, device=device).to(dtype)
    v = torch.randn(B, H, L, D, generator=g, device=device).to(dtype)
    do = torch.randn(B, H, L, D, generator=g, device=device).to(dtype)
    bias = torch.randn(1, H, L, L, generator=g, device=device)
    lens = torch.linspace(L, L // 3, B, device=device).long()
    lens[-1] = 0  # a fully-masked row, like the serve engine's fill rows
    mask = (torch.arange(L, device=device)[None, :] >= lens[:, None]).to(torch.int32)
    # the library yardstick: SDPA with a float mask and no fully-masked row
    lens_lib = lens.clone()
    lens_lib[-1] = L // 3
    keymask = torch.arange(L, device=device)[None, :] >= lens_lib[:, None]
    attn_mask = (bias + torch.where(keymask, float("-inf"), 0.0)[:, None, None, :]).to(dtype)
    return q, k, v, do, bias, mask, attn_mask


def check_attention(torch, device, B, H, L, D, dtype, iters, rate=0.0, seed=1234):
    import torch.nn.functional as F

    from unicore_tpu_torch.ops import attention_fullrow as fr

    q, k, v, _, bias, mask, attn_mask = attention_inputs(torch, device, B, H, L, D,
                                                         dtype, L)
    call = lambda: fr.fullrow_attention(  # noqa: E731
        q, k, v, bias=bias, kv_padding_mask=mask, dropout_rate=rate,
        dropout_seed=seed)
    plain = lambda: fr.fullrow_attention_plain(q, k, v, bias, mask, 1.0, rate, seed)  # noqa: E731
    out = call()
    err = (out.float() - plain().float()).abs().max().item()
    masked_row_zero = out[-1].abs().max().item() == 0.0
    tol = TOL["attention"][dtype_name(dtype)]
    name = f"attention fwd B={B} H={H} L={L} D={D} {dtype} dropout={rate}"
    if not (err <= tol and masked_row_zero and math.isfinite(err)):
        raise AssertionError(
            f"{name}: kernel vs plain max abs err {err} (tol {tol}), "
            f"fully-masked row zero: {masked_row_zero}"
        )
    res = {"shape": [B, H, L, D], "dtype": dtype_name(dtype), "dropout": rate,
           "max_abs_err": err, "tolerance": tol}
    timed(res, "ms", torch, call, device, iters)
    timed(res, "plain_ms", torch, plain, device, iters)
    timed(res, "library_ms", torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, scale=1.0, dropout_p=rate), device, iters)
    nbytes = 4 * B * H * L * D * q.element_size() + bias.numel() * 4 + mask.numel() * 4
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


def check_attention_bwd(torch, device, B, H, L, D, dtype, iters, rate, seed=4321):
    import torch.nn.functional as F

    from unicore_tpu_torch.ops import attention_fullrow as fr

    q, k, v, do, bias, mask, attn_mask = attention_inputs(torch, device, B, H, L, D,
                                                          dtype, L + 1)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]

    def public_grads():  # the training path: the autograd Function
        out = fr.fullrow_attention(*leaves[:3], bias=leaves[3], kv_padding_mask=mask,
                                   dropout_rate=rate, dropout_seed=seed)
        return torch.autograd.grad(out, leaves, do)

    name = f"attention bwd B={B} H={H} L={L} D={D} {dtype} dropout={rate}"
    got = public_grads()
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
           "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
           "max_err_over_tol": max(ratios.values()),
           "tolerance": grad_tolerance(TOL["attention_grad"], dtype)}
    timed(res, "ms", torch, kernel, device, iters)
    slow_iters = max(iters // 4, 2)
    timed(res, "plain_ms", torch, backward_call(
        torch, lambda: fr.fullrow_attention_plain(*leaves[:3], leaves[3], mask, 1.0,
                                                  rate, seed),
        leaves, do), device, slow_iters)
    lib_mask = attn_mask.clone().requires_grad_(True)
    timed(res, "library_ms", torch, backward_call(
        torch, lambda: F.scaled_dot_product_attention(
            *leaves[:3], attn_mask=lib_mask, scale=1.0, dropout_p=rate),
        leaves[:3] + [lib_mask], do), device, slow_iters)
    item = q.element_size()
    nbytes = (7 * B * H * L * D * item + 2 * bias.numel() * 4 + mask.numel() * 4)
    attention_bound(res, nbytes, 10 * B * H * L * L * D)
    log(f"{name}: {json.dumps(res)}")
    return res


def norm_inputs(torch, device, N, D, dtype):
    g = torch.Generator(device=device).manual_seed(N + D)
    x = (torch.randn(N, D, generator=g, device=device) * 2 + 0.5).to(dtype)
    dy = torch.randn(N, D, generator=g, device=device).to(dtype)
    w = 1 + 0.1 * torch.randn(D, generator=g, device=device)
    b = 0.1 * torch.randn(D, generator=g, device=device)
    return x, dy, w, b


def check_norm(torch, device, N, D, dtype, rms, iters):
    import torch.nn.functional as F

    from unicore_tpu_torch.ops import fused_norm as fn

    x, _, w, b = norm_inputs(torch, device, N, D, dtype)
    eps = 1e-6 if rms else 1e-5
    bb = None if rms else b
    name_fn = "fused_rms_norm" if rms else "fused_layer_norm"
    call = lambda: fn._fused_norm(x, w, bb, eps, rms)  # noqa: E731
    plain = lambda: fn.fused_norm_plain(x, w, bb, eps, rms)  # noqa: E731
    if rms:
        lib = (lambda: F.rms_norm(x, (D,), w.to(dtype), eps)) if hasattr(F, "rms_norm") else None  # noqa: E731
    else:
        lib = lambda: F.layer_norm(x, (D,), w.to(dtype), b.to(dtype), eps)  # noqa: E731
    err = (call().float() - plain().float()).abs().max().item()
    # the training forward's statistics against fp32 plain statistics
    stat_err = 0.0
    if device.type == "cuda":
        _, mean, rstd = fn._launch_fwd(x, w, bb, eps, rms, True, name_fn)
        xf = x.float()
        ref_mean = torch.zeros_like(mean) if rms else xf.mean(-1)
        ref_var = (xf - ref_mean[:, None]).square().mean(-1)
        for got, ref in ((mean, ref_mean), (rstd, torch.rsqrt(ref_var + eps))):
            err_s, scale = rel_err(got, ref)
            stat_err = max(stat_err, err_s / scale)
    tol = TOL["norm"][dtype_name(dtype)]
    name = f"{'rms' if rms else 'layer'}_norm fwd N={N} D={D} {dtype}"
    if not (err <= tol and stat_err <= 1e-5 and math.isfinite(err)):
        raise AssertionError(f"{name}: kernel vs plain max abs err {err} (tol {tol}), "
                             f"statistics err {stat_err} (tol 1e-5)")
    res = {"shape": [N, D], "dtype": dtype_name(dtype), "rms": rms,
           "max_abs_err": err, "tolerance": tol, "stats_rel_err": stat_err}
    timed(res, "ms", torch, call, device, iters)
    timed(res, "plain_ms", torch, plain, device, iters)
    if lib is None:
        res["library_ms"] = res["library_ms_spread"] = res["library_device_ms"] = None
    else:
        timed(res, "library_ms", torch, lib, device, iters)
    nbytes = 2 * N * D * x.element_size() + D * 4 * (1 if rms else 2)
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 8 * N * D, "float32")
    log(f"{name}: {json.dumps(res)}")
    return res


def check_norm_bwd(torch, device, N, D, dtype, rms, iters):
    """dx and dw/db kernels against autograd of the plain version.  Their
    plain and library times are the whole backward (dx, dw and db
    together), as autograd computes it."""
    import torch.nn.functional as F

    from unicore_tpu_torch.ops import fused_norm as fn

    x, dy, w, b = norm_inputs(torch, device, N, D, dtype)
    eps = 1e-6 if rms else 1e-5
    name_fn = "fused_rms_norm" if rms else "fused_layer_norm"
    leaves = [t.clone().requires_grad_(True) for t in ((x, w) if rms else (x, w, b))]

    def plain_fwd():
        return fn.fused_norm_plain(leaves[0], leaves[1], None if rms else leaves[2], eps, rms)

    def public_grads():  # the training path: the autograd Function
        return torch.autograd.grad(
            fn._fused_norm(leaves[0], leaves[1], None if rms else leaves[2], eps, rms),
            leaves, dy)

    ref = torch.autograd.grad(plain_fwd(), leaves, dy)
    got = public_grads()
    if device.type == "cuda":  # each kernel alone on the card
        _, mean, rstd = fn._launch_fwd(x, w, None if rms else b, eps, rms, True, name_fn)
        dx_call = lambda: fn._launch_dx(x, w, mean, rstd, dy, rms, name_fn)  # noqa: E731
        dwdb_call = lambda: fn._launch_dwdb(x, mean, rstd, dy, not rms, name_fn)  # noqa: E731
    else:
        dx_call = dwdb_call = public_grads
    out = {}
    for kname, pairs in (("fused_norm_dx", [("dx", got[0], ref[0])]),
                         ("fused_norm_dwdb", list(zip(("dw", "db"), got[1:], ref[1:])))):
        errs, ratios = {}, {}
        for gname, g, r in pairs:
            errs[gname], ratios[gname] = grad_check(
                torch, f"{kname} N={N} D={D} {dtype} rms={rms}: {gname}", g, r,
                TOL["norm_grad"])
        out[kname] = {"shape": [N, D], "dtype": dtype_name(dtype), "rms": rms,
                      "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
                      "max_err_over_tol": max(ratios.values()),
                      "tolerance": grad_tolerance(TOL["norm_grad"], pairs[0][1].dtype)}

    both = {}
    timed(both, "plain_ms", torch, backward_call(torch, plain_fwd, leaves, dy),
          device, iters)
    if rms and not hasattr(F, "rms_norm"):
        both.update(library_ms=None, library_ms_spread=None, library_device_ms=None)
    else:
        lw = w.to(dtype).clone().requires_grad_(True)
        lb = b.to(dtype).clone().requires_grad_(True)
        lx = x.clone().requires_grad_(True)
        timed(both, "library_ms", torch, backward_call(
            torch,
            (lambda: F.rms_norm(lx, (D,), lw, eps)) if rms else
            (lambda: F.layer_norm(lx, (D,), lw, lb, eps)),
            [lx, lw] if rms else [lx, lw, lb], dy), device, iters)
    item = x.element_size()
    for kname, call, nbytes, flops in (
        ("fused_norm_dx", dx_call, 3 * N * D * item + 2 * N * 4 + D * 4, 10 * N * D),
        ("fused_norm_dwdb", dwdb_call,
         2 * N * D * item + 2 * N * 4 + D * 4 * (1 if rms else 2), 4 * N * D),
    ):
        res = out[kname]
        timed(res, "ms", torch, call, device, iters)
        res.update(both)
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops, "float32")
        log(f"{kname} N={N} D={D} {dtype} rms={rms}: {json.dumps(res)}")
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


def check_softmax(torch, device, c, dtype, iters, seed=1234):
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
    timed(f_res, "plain_ms", torch, call_plain, device, slow_iters)
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
        device, slow_iters)
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
        lib = lib + bias.repeat_interleave(B // bias.shape[0], dim=0)
    return q, k, v, do, bias, mask, lib.to(dtype)


def check_flash(torch, device, c, dtype, iters, seed=4321):
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
    name = (f"flash {c['name']} B={B} H={H} L={L} D={D} bias={c.get('bias')} {dtype} "
            f"dropout={rate}")
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

    # times: the forward through the public call; each backward kernel
    # alone on the card (the whole autograd backward on the CPU); plain and
    # library: the forward, and the whole backward for every backward kernel
    slow_iters = max(iters // 4, 2)
    f_res = rows["flash_attention_fwd"]
    timed(f_res, "ms", torch, lambda: public(q, k, v, *([bias] if bias is not None else [])),
          device, iters)
    timed(f_res, "plain_ms", torch, lambda: plain(q, k, v, *([bias] if bias is not None else [])),
          device, slow_iters)
    timed(f_res, "library_ms", torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=lib, scale=1.0, dropout_p=rate), device, iters)
    both = {}
    timed(both, "plain_ms", torch, backward_call(torch, lambda: plain(*leaves), leaves, do),
          device, slow_iters)
    lib_leaves = [t.clone().requires_grad_(True) for t in (q, k, v, lib)]
    timed(both, "library_ms", torch, backward_call(
        torch, lambda: F.scaled_dot_product_attention(*lib_leaves[:3], attn_mask=lib_leaves[3],
                                                      scale=1.0, dropout_p=rate),
        lib_leaves, do), device, slow_iters)
    di = (out.detach().float() * do.float()).sum(-1)
    bwd_args = (q, k, v, bias, mask, lse, di, do, 1.0, rate, seed)
    launch = {"flash_attention_dq": fa._launch_dq, "flash_attention_dkv": fa._launch_dkv,
              "flash_attention_db": fa._launch_db}
    # bounds: q, k, v, do, out read or written once (item bytes), lse and di
    # (4 bytes a row), the bias and the mask read once, dbias written once
    item, bhld, bhl = q.element_size(), B * H * L * D, B * H * L
    bias_bytes = 0 if bias is None else bias.numel() * 4
    extra = bias_bytes + mask.numel() * 4
    prod = 2 * B * H * L * L * D  # operations of one (L x L) by D product
    attention_bound(f_res, 4 * bhld * item + 4 * bhl + extra, 2 * prod)
    sizes = {"flash_attention_dq": (5 * bhld * item + 8 * bhl + extra, 3 * prod),
             "flash_attention_dkv": (6 * bhld * item + 8 * bhl + extra, 4 * prod),
             "flash_attention_db": (4 * bhld * item + 8 * bhl + extra + bias_bytes,
                                    2 * prod)}
    for kname in ("flash_attention_dq", "flash_attention_dkv", "flash_attention_db"):
        if kname not in rows:
            continue
        res = rows[kname]
        call = ((lambda fn=launch[kname]: fn(*bwd_args)) if on_card
                else (lambda: torch.autograd.grad(public(*leaves), leaves, do)))
        timed(res, "ms", torch, call, device, iters)
        res.update(both)
        attention_bound(res, *sizes[kname])
    for kname, res in rows.items():
        log(f"{name} {kname}: {json.dumps(res)}")
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
    +1e6 / V -1e6, int8 +127 / -127).  Also the live rows over the batch."""
    B, H, L, D = c["shape"]
    dtype = getattr(torch, c["dtype"])
    g = torch.Generator(device=device).manual_seed(seed)
    q = (torch.randn(B, H, D, generator=g, device=device) * D ** -0.5).to(dtype)
    k = torch.randn(B, H, L, D, generator=g, device=device)
    v = torch.randn(B, H, L, D, generator=g, device=device)
    bias = torch.randn(B, H, L, generator=g, device=device)
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
        k = torch.where(live, k, 1e6).to(dtype)
        v = torch.where(live, v, -1e6).to(dtype)
    return q, k, v, pos, bias, scales, int(pos.long().sum().item()) + B


def check_decode(torch, device, c, iters, seed=5150):
    """The decode attention against ``decode_attention_plain`` on the same
    inputs.  Its library yardstick is one ``scaled_dot_product_attention``
    over the (B, H, 1, D) query with the bias row and the dead rows folded
    into a float mask (int8: the dequant multiplies, then SDPA -- no one
    PyTorch call fuses the dequant into the read).  The bound counts what
    the kernel must move: q and out, every live K and V row with its bias
    entry, the positions and the scales."""
    import torch.nn.functional as F

    from unicore_tpu_torch.ops import decode_attention as da

    B, H, L, D = c["shape"]
    q, k, v, pos, bias, scales, live_rows = decode_inputs(torch, device, c, seed)
    call = lambda: da.decode_attention(q, k, v, pos, bias=bias, **scales)  # noqa: E731
    plain = lambda: da.decode_attention_plain(q, k, v, pos, bias=bias, **scales)  # noqa: E731
    dead = torch.arange(L, device=device)[None, None, None, :] > pos.long()[:, None, None, None]
    mask = (bias[:, :, None] + torch.where(dead, float("-inf"), 0.0)).to(q.dtype)
    if scales:
        def lib():
            kf = (k.float() * scales["k_scale"][None, :, None]).to(q.dtype)
            vf = (v.float() * scales["v_scale"][None, :, None]).to(q.dtype)
            return F.scaled_dot_product_attention(q[:, :, None], kf, vf, attn_mask=mask,
                                                  scale=1.0)
    else:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q[:, :, None], k, v, attn_mask=mask, scale=1.0)
    out, ref = call(), plain()
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
           "kv": "int8" if scales else c["dtype"], "live_rows": live_rows,
           "max_abs_err": err, "tolerance": tol}
    timed(res, "ms", torch, call, device, iters)
    timed(res, "plain_ms", torch, plain, device, iters)
    timed(res, "library_ms", torch, lib, device, iters)
    nbytes = (2 * q.numel() * q.element_size() + 4 * B
              + live_rows * H * (2 * D * k.element_size() + 4) + 8 * H * D * bool(scales))
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 4 * live_rows * H * D, "float32")
    log(f"{name}: {json.dumps(res)}")
    return res


def check_quant_matmul(torch, device, c, iters):
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
           "bias": bool(c["bias"]), "max_abs_err": err, "tolerance": "1e-6 x max|ref|"}
    timed(res, "ms", torch, call, device, iters)
    timed(res, "plain_ms", torch, plain, device, max(iters // 4, 2))
    try:
        library()
        timed(res, "library_ms", torch, library, device, iters)
    except RuntimeError as err_lib:  # _int_mm refuses some shapes
        res["library_ms"] = res["library_ms_spread"] = res["library_device_ms"] = None
        res["library_refused"] = str(err_lib).splitlines()[0][:200]
    nbytes = M * K + N * K + 4 * N * (2 if bias is not None else 1) + 4 * M * N
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 2 * M * N * K, "int8")
    log(f"{name}: {json.dumps(res)}")
    return res


def check_quant_norm(torch, device, N, D, per_channel, iters):
    """7q against ``quant_layer_norm_plain``: int8 (N, D) dequantized by one
    scale or (D,) of them; tolerance the fp32 norm's.  Yardstick: the
    dequant multiply and one ``F.layer_norm``."""
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
    timed(res, "plain_ms", torch, plain, device, iters)
    timed(res, "library_ms", torch, library, device, iters)
    nbytes = N * D + 4 * N * D + 4 * D * (3 if per_channel else 2)
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 9 * N * D, "float32")
    log(f"{name}: {json.dumps(res)}")
    return res


def check_quant_softmax(torch, device, c, iters):
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
    timed(res, "plain_ms", torch, plain, device, max(iters // 4, 2))
    timed(res, "library_ms", torch, library, device, max(iters // 4, 2))
    n = x.numel()
    nbytes = n * x.element_size() + 4 * n + 4 * (mask.numel() + bias.numel())
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 6 * n, "float32")
    log(f"{name}: {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# phase 4a: training, a subprocess of the train CLI
# ---------------------------------------------------------------------------

def write_corpus(cfg):
    """dict.txt (one symbol per line, as WordPiece reads it) and an indexed
    train split of documents drawn from a seed."""
    import numpy as np

    from unicore_tpu_torch.data import make_builder

    data = WORK / "data"
    data.mkdir(parents=True, exist_ok=True)
    words = [f"w{i}" for i in range(cfg["symbols"])]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    (data / "dict.txt").write_text("\n".join(vocab) + "\n")
    rng = np.random.default_rng(cfg["seed"])
    # Zipf-like word frequencies, as in text, so a few updates can learn them
    freq = 1.0 / np.arange(10, len(words) + 10)
    builder = make_builder(str(data / "train"))
    lo, hi = cfg["doc_words"]
    for _ in range(cfg["docs"]):
        n = int(rng.integers(lo, hi + 1))
        picks = rng.choice(len(words), size=n, p=freq / freq.sum())
        builder.add_item(" ".join(words[i] for i in picks))
    builder.finalize()
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


def run_train_cli(tag, argv, device, t, timeout_s):
    """``python -m unicore_tpu_torch.cli.train`` with ``argv``: its stats
    line, checked -- the update count, every loss finite, the mean of the
    last five below the first five, and the launches per micro-batch
    (``t["per_micro_batch"]``; none at all on the CPU rehearsal)."""
    log_path = WORK / f"{tag}.log"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.monotonic()
    with open(log_path, "w") as f:
        proc = subprocess.run([sys.executable, "-m", "unicore_tpu_torch.cli.train", *argv],
                              stdout=f, stderr=subprocess.STDOUT, cwd=str(ROOT),
                              env=env, timeout=timeout_s)
    text = log_path.read_text()
    if proc.returncode != 0:
        raise RuntimeError(f"{tag}: train CLI exited {proc.returncode}:\n{text[-6000:]}")
    lines = [ln for ln in text.splitlines() if ln.startswith("TRAIN stats ")]
    if not lines:
        raise AssertionError(f"{tag}: no TRAIN stats line:\n{text[-6000:]}")
    stats = json.loads(lines[-1][len("TRAIN stats "):])
    for ln in text.splitlines():
        if "| update " in ln:
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
    if not last < first:
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
    save_dir = WORK / "train_ckpt"
    t = cfg["train"]
    stats = run_train_cli("train", train_argv(cfg, data, save_dir, cfg["device"].type),
                          cfg["device"], t, t["timeout_s"])
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
        profile_bert_update(torch, cfg, data, card, smi)
    return save_dir / "checkpoint_last.pt", stats["kernel_launches"]


# ---------------------------------------------------------------------------
# phase 4b: one training path on the card against the CPU
# ---------------------------------------------------------------------------

def drive_card_vs_cpu(torch, cfg, data):
    import copy

    import numpy as np

    from unicore_tpu_torch import options
    from unicore_tpu_torch.losses import LOSS_REGISTRY
    from unicore_tpu_torch.models.bert import BertModel
    from unicore_tpu_torch.ops import _kernels
    from unicore_tpu_torch.tasks.bert import BertTask
    from unicore_tpu_torch.trainer import Trainer

    c = cfg["card_vs_cpu"]
    args = options.parse_args_and_arch(
        options.get_training_parser(),
        train_argv(cfg, data, WORK / "unused", "cpu")
        + ["--update-freq", "2", "--max-update", str(c["updates"]),
           "--total-num-update", str(c["updates"]), "--warmup-updates", "1"])
    task = BertTask.setup_task(args)
    vocab, pad = len(task.dictionary), task.dictionary.pad()
    model = BertModel(
        vocab_size=vocab, padding_idx=pad, encoder_layers=2,
        encoder_embed_dim=args.encoder_embed_dim,
        encoder_ffn_embed_dim=args.encoder_ffn_embed_dim,
        encoder_attention_heads=args.encoder_attention_heads,
        max_seq_len=args.max_seq_len, dropout=0.0, emb_dropout=0.0,
        attention_dropout=0.1, generator=torch.Generator().manual_seed(7))
    rng = np.random.default_rng(11)
    B, L = cfg["batch"], c["seq_len"]
    samples = []
    for _ in range(2 * c["updates"]):
        lens = rng.integers(L // 2, L + 1, B)
        src = rng.integers(5, vocab, (B, L))
        src[np.arange(L)[None, :] >= lens[:, None]] = pad
        tgt = np.where((rng.random((B, L)) < 0.15) & (src != pad), src, pad)
        samples.append({"net_input": {"src_tokens": src}, "target": tgt})

    def run(device):
        tr = Trainer(args, task, copy.deepcopy(model), LOSS_REGISTRY["masked_lm"](task),
                     device)
        tr.begin_epoch(1)
        gnorms = [tr.train_step(samples[2 * i:2 * i + 2]) for i in range(c["updates"])]
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
    log(f"card vs CPU: {json.dumps(res)}")
    if sum(cpu_launches.values()):
        raise AssertionError(f"the CPU run launched kernels: {cpu_launches}")
    if cfg["device"].type == "cuda" and not all(
            card_launches.get(k, 0) > 0 for k, v in KERNELS.items() if v[2] == "train"):
        raise AssertionError(f"the card run missed a kernel: {card_launches}")
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
                          unimol_argv(u, data, WORK / "unimol_ckpt", cfg["device"].type),
                          cfg["device"], t, t["timeout_s"])
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
    return stats["kernel_launches"]


def drive_unimol_card_vs_cpu(torch, cfg, data):
    """One Uni-Mol training path (full widths at 2 layers, attention dropout
    0.1, other dropouts 0) on the card and on the CPU from the same weights
    and batches."""
    import copy

    from unicore_tpu_torch import options
    from unicore_tpu_torch.losses.unimol import UniMolLoss
    from unicore_tpu_torch.models.unimol import UniMolModel
    from unicore_tpu_torch.ops import _kernels
    from unicore_tpu_torch.tasks.unimol import UniMolTask
    from unicore_tpu_torch.trainer import Trainer

    u, c = cfg["unimol"], cfg["unimol"]["card_vs_cpu"]
    args = options.parse_args_and_arch(
        options.get_training_parser(),
        unimol_argv(u, data, WORK / "unused", "cpu")
        + ["--batch-size", str(c["batch"]), "--max-update", str(c["updates"]),
           "--total-num-update", str(c["updates"]), "--warmup-updates", "1"])
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

    def run(device):
        tr = Trainer(args, task, copy.deepcopy(model), UniMolLoss(task), device)
        tr.begin_epoch(1)
        gnorms = [tr.train_step([s]) for s in samples]
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
                          evoformer_argv(e, data, WORK / "evoformer_ckpt", cfg["device"].type),
                          cfg["device"], t, t["timeout_s"])
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
                 ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "splitk")),
                 ("elementwise_and_reductions", ("elementwise", "vectorized", "reduce",
                                                 "Reduce", "index", "Index", "scatter",
                                                 "gather", "copy", "cat", "softmax",
                                                 "Softmax", "foreach", "fill")))


def profile_update(torch, tr, samples, groups, card, smi):
    """One update of ``tr`` (a Trainer, its micro-batches ``samples[2:4]``)
    after a warm-up update on ``samples[:2]``: its wall time unprofiled,
    then the same update under ``torch.profiler`` for the device time of
    the kernels by ``groups`` (first match by name; "other" for the rest);
    the idle share is the part of the unprofiled wall time the device time
    does not fill."""
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
        if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
            continue
        name = next((g for g, keys in groups if any(k in ev.key for k in keys)), "other")
        by_group[name] += ev.self_device_time_total
        calls[name] += ev.count
        top.append((ev.self_device_time_total, ev.key[:90], ev.count))
    busy = sum(by_group.values())
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
    res = profile_update(torch, tr, samples, KERNEL_GROUPS, card, smi)
    print("evoformer_profile " + json.dumps(res), flush=True)
    del tr, model
    torch.cuda.empty_cache()


#: BERT's update by kernel group: the full-row forward and each launch of
#: its backward apart, then the groups of :data:`KERNEL_GROUPS`
BERT_GROUPS = (("fullrow_fwd", ("fullrow_fwd",)), ("fullrow_bwd_dq_dbias", ("fullrow_dq",)),
               ("fullrow_bwd_dk_dv", ("fullrow_dkv",))) + KERNEL_GROUPS[1:]


def profile_bert_update(torch, cfg, data, card, smi):
    """:func:`profile_update` on 4a's configuration (BERT-base at full
    width, batch 8 x 2 micro-batches of the 384/512 buckets, its optimizer
    and dropouts): the ``bert_profile`` line."""
    from unicore_tpu_torch import options, tasks
    from unicore_tpu_torch.trainer import Trainer

    dev = cfg["device"]
    args = options.parse_args_and_arch(
        options.get_training_parser(), train_argv(cfg, data, WORK / "unused", "cuda"))
    task = tasks.setup_task(args)
    task.load_dataset("train")
    itr = task.get_batch_iterator(task.dataset("train"), batch_size=cfg["batch"],
                                  seed=args.seed)
    samples = list(itr.next_epoch_itr(shuffle=True))[:4]
    model = task.build_model(args, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(args.seed))
    tr = Trainer(args, task, model, task.build_loss(args), dev)
    res = profile_update(torch, tr, samples, BERT_GROUPS, card, smi)
    res["micro_batch_shapes"] = [list(s["net_input"]["src_tokens"].shape)
                                 for s in samples[2:4]]
    print("bert_profile " + json.dumps(res), flush=True)
    del tr, model
    torch.cuda.empty_cache()


def drive_evoformer_card_vs_cpu(torch, cfg, data):
    """One Evoformer training path (full widths at 2 blocks, dropout 0) on
    the card and on the CPU from the same weights and batches, with the
    optimizer of phases 4b and 5b (lr 1e-4, eps 1e-6).  At 6a's lr 1e-3 and
    eps 1e-8 Adam turns gradient elements at fp32 noise level -- the bias
    of ``ln_z`` before the pair-bias projection, whose true gradient is 0
    (a constant added to a score row leaves the softmax as it is), and
    ReLU units at the edge of activity -- into steps the size of the lr, and
    the devices then differ by more than the parameter limit."""
    import copy

    from unicore_tpu_torch import options
    from unicore_tpu_torch.losses.masked_msa import MaskedMSALoss
    from unicore_tpu_torch.models.evoformer_model import EvoformerModel
    from unicore_tpu_torch.ops import _kernels
    from unicore_tpu_torch.tasks.msa_pretrain import MSAPretrainTask
    from unicore_tpu_torch.trainer import Trainer

    e, c = cfg["evoformer"], cfg["evoformer"]["card_vs_cpu"]
    args = options.parse_args_and_arch(
        options.get_training_parser(),
        evoformer_argv(e, data, WORK / "unused", "cpu")
        + ["--batch-size", str(c["batch"]), "--max-update", str(c["updates"]),
           "--total-num-update", str(c["updates"]), "--warmup-updates", "1",
           "--update-freq", "1", "--max-msa-rows", str(c["max_rows"]),
           "--max-seq-len", str(c["length"]), "--lr", "1e-4", "--adam-eps", "1e-6"])
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

    def run(device):
        tr = Trainer(args, task, copy.deepcopy(model), MaskedMSALoss(task), device)
        tr.begin_epoch(1)
        gnorms = [tr.train_step([s]) for s in samples]
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


def cpu_reference(torch, path, rows, bucket, pad_idx):
    """ids/score for ``rows`` padded to ``bucket``: the same checkpoint
    loaded in this process on the CPU, through the plain versions."""
    import numpy as np

    from unicore_tpu_torch import checkpoint_utils, tasks
    from unicore_tpu_torch.serve import build_infer_fn

    state = checkpoint_utils.load_checkpoint_to_cpu(str(path))
    task = tasks.setup_task(state["args"])
    model = task.build_model(state["args"])
    model.load_state_dict(state["model"])
    model.eval()
    arr = np.full((len(rows), bucket), pad_idx, np.int32)
    for i, r in enumerate(rows):
        arr[i, : len(r)] = r
    return build_infer_fn("cpu")(model, arr)


class Server:
    """``python -m unicore_tpu_torch.cli.serve`` on ``path``: batch size
    and buckets from ``argv`` (the BERT serving path's by default)."""

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
             *argv, "--default-deadline-ms", "120000",
             "--max-deadline-ms", "120000", "--drain-deadline", "120"],
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


def drive_slice(torch, cfg, path, card, smi):
    import numpy as np

    from unicore_tpu_torch import checkpoint_utils, tasks
    from unicore_tpu_torch.ops import _kernels

    t0 = time.monotonic()
    state = checkpoint_utils.load_checkpoint_to_cpu(str(path))
    task = tasks.setup_task(state["args"])
    vocab, pad = len(task.dictionary), task.dictionary.pad()
    del state
    server = Server(path, cfg)
    try:
        server.wait_ready(cfg["ready_budget_s"])
        log(f"server ready at {server.base} after {time.monotonic() - t0:.1f}s")
        rng = np.random.default_rng(cfg["seed"])
        reqs = [rng.integers(5, vocab, size=n).tolist() for n in cfg["lengths"]]
        _kernels.reset_launch_counts()
        code, before = http("GET", server.base + "/stats")
        assert code == 200, before

        def send(toks):
            t = time.monotonic()
            code, body = http("POST", server.base + "/v1/infer", {"tokens": toks})
            return code, body, (time.monotonic() - t) * 1e3

        # the first half one at a time, the rest concurrently
        half = len(reqs) // 2
        results = [send(r) for r in reqs[:half]]
        with ThreadPoolExecutor(max_workers=cfg["batch"]) as pool:
            results += list(pool.map(send, reqs[half:]))
        code, after = http("GET", server.base + "/stats")
        assert code == 200, after

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

        server.proc.send_signal(signal.SIGTERM)
        rc = server.proc.wait(timeout=180)
        if rc != 0:
            raise AssertionError(f"drain exit {rc}:\n{server.log_text()[-6000:]}")
        lat = np.asarray([r[2] for r in results])
        serve = {
            "requests": len(reqs), "batches": batches,
            "client_p50_ms": float(np.percentile(lat, 50)),
            "client_p99_ms": float(np.percentile(lat, 99)),
            "server_p50_ms": after.get("p50_ms"), "server_p99_ms": after.get("p99_ms"),
            "launches": launches, "arch": cfg["arch"], "card": card, "nvidia_smi": smi,
        }
        print("serve " + json.dumps(serve), flush=True)
        return launches
    finally:
        server.stop()


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
    checkpoint_utils.save_checkpoint(str(path), args, model.state_dict())
    log(f"wrote {d['arch']} ({sum(p.numel() for p in model.parameters())} parameters, "
        f"vocab {len(task.dictionary)}) to {path}")
    return path, len(task.dictionary), task.dictionary.pad(), task.dictionary.eos()


def load_lm(torch, path, device):
    from unicore_tpu_torch import checkpoint_utils, tasks

    state = checkpoint_utils.load_checkpoint_to_cpu(str(path))
    model = tasks.setup_task(state["args"]).build_model(state["args"])
    model.load_state_dict(state["model"])
    return model.to(device).eval()


def decode_launch_check(cfg, before, after):
    """The server's launches between two ``/stats`` reads against the decode
    arithmetic: per decode step one decode attention a layer; per prefill
    batch one full-row attention forward a layer; per dispatch (either) two
    norm forwards a layer plus the embedding and final norms; no other
    launch (no backward, no flash or softmax kernel).  On the CPU: none."""
    layers = cfg["decode"]["layers"]
    steps = after["decode_steps"] - before["decode_steps"]
    prefills = after["prefill_batches"] - before["prefill_batches"]
    launches = {k: n - before["kernel_launches"].get(k, 0)
                for k, n in after["kernel_launches"].items()}
    want = {"decode_attention": layers * steps, "fullrow_attention_fwd": layers * prefills,
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


def drive_decode_serving(torch, cfg, path, lm, card, smi, kv):
    """``python -m unicore_tpu_torch.cli.serve`` on the LM checkpoint:
    ``/v1/generate`` requests (the first half one at a time, the rest
    concurrently) with their launch arithmetic from ``/stats``; with fp32
    KV two served generations held against the CPU; SIGTERM drains and
    exits 0.  Prints the ``decode_serve`` (``decode_serve_int8``) line and
    returns the server's launches."""
    import threading

    import numpy as np

    from unicore_tpu_torch.serve.kv_cache import bucket_for

    d = cfg["decode"]
    vocab, eos = lm["vocab"], lm["eos"]
    lengths = d["lengths"] if kv == "fp32" else d["lengths"][: d["int8_requests"]]
    t0 = time.monotonic()
    server = Server(path, cfg, [
        "--serve-batch-size", str(d["prefill_batch"]),
        "--decode-batch-size", str(d["decode_batch"]), "--serve-buckets", "4",
        "--cache-pages", str(d["cache_pages"]), "--max-new-tokens", str(d["max_new"]),
        "--decode-kv", kv], name=f"decode_serve_{kv}")
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
        print(f"{'decode_serve' if kv == 'fp32' else 'decode_serve_int8'} "
              + json.dumps(res), flush=True)
        return launches
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
    latter from the server's sidecar (its digest verified)."""
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
    model_q = calibrate.load_prepared(
        model.clone(quantize=mode),
        calibrate.prepare(model.state_dict(), doc["sites"], mode))
    return model.to(device), model_q.to(device)


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


QUANT_GROUPS = (("quant_matmul", ("quant_matmul",)), ("quant_layer_norm", ("quant_layer_norm",)),
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


def drive_quant_serving(torch, cfg, path, card, smi, mode):
    """``python -m unicore_tpu_torch.cli.serve --serve-quantize <mode>
    --quant-drift-sample 1`` on phase 4a's checkpoint: the ``QUANT-PATH``
    line, the sidecar, /stats' ``precision`` and ``quant`` block with every
    request's drift sampled, the calibration drift within the JAX package's
    bound, the serving path's launches per batch (the drift probe's, counted
    apart, subtracted), for int8 two answers against this process's CPU on
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
    server = Server(path, cfg, ["--serve-batch-size", str(cfg["batch"]), "--serve-buckets",
                                "4", "--serve-quantize", mode, "--quant-drift-sample", "1"],
                    name=f"quant_serve_{mode}")
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

        total, probe = delta("kernel_launches"), delta("probe_kernel_launches")
        launches = {k: n - probe.get(k, 0) for k, n in total.items()}
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
            "arch": cfg["arch"], "card": card, "nvidia_smi": smi,
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

CHIP = {
    # the training path's buckets: 512 and 384 (documents of 380-510 words)
    # and the serving path's smallest, 128
    "attention": [(8, 12, 512, 64), (8, 12, 384, 64), (8, 12, 128, 64)],
    "attention_bwd": [(8, 12, 512, 64), (8, 12, 384, 64), (8, 12, 128, 64)],
    # Uni-Mol's head norms: D = 64 over B * L**2 rows; the Evoformer's msa
    # (32 rows x 256 residues, D = 256) and pair (256**2 rows, D = 128) norms
    "norm": [(4096, 768), (4097, 1024), (16 * 128 * 128, 64), (32 * 256, 256),
             (256 * 256, 128)],
    # Uni-Mol's micro-batch (16 x 64 heads, L = 128) first, fp32 then bf16
    "softmax": [
        {"shape": (16, 64, 128, 128), "rate": 0.1, "dtype": "float32"},
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
    ],
    # the int8 serving kernels at BERT-base serving shapes, batch 8 x 512
    # rows: the denses in_proj, fc1 (GELU), fc2, the LM head's (GELU), and an
    # M that is not a multiple of 16; the LM head's norm with a scalar and a
    # per-channel scale; the scores at the top bucket (int32) and an int8
    # input at the smallest
    "quant_matmul": [
        {"name": "in_proj", "M": 4096, "K": 768, "N": 2304, "act": "", "bias": True},
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
                    "rel_drift_bound": {"int8": 0.05, "fp8": 0.15}},
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
}
REHEARSAL = {
    "attention": [(2, 2, 128, 16)],
    "attention_bwd": [(2, 2, 128, 16)],
    "norm": [(33, 64)],
    "softmax": [
        {"shape": (2, 4, 16, 128), "rate": 0.1, "dtype": "float32"},
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
    ],
    "quant_matmul": [
        {"name": "in_proj", "M": 256, "K": 64, "N": 192, "act": "", "bias": True},
        {"name": "fc1", "M": 256, "K": 64, "N": 128, "act": "gelu", "bias": True},
        {"name": "odd_m", "M": 250, "K": 128, "N": 64, "act": "", "bias": False},
    ],
    "quant_norm": [(256, 64, False), (256, 64, True)],
    "quant_softmax": [{"shape": (2, 4, 128, 128), "dtype": "int32"},
                      {"shape": (2, 4, 128, 128), "dtype": "int8"}],
    "quant_serve": {"layers": 2, "fp8_requests": 4, "profile_batches": 2,
                    "lengths": [10, 40, 70, 100, 32, 64, 96, 128],
                    "rel_drift_bound": {"int8": 0.05, "fp8": 0.15}},
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
}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu-rehearsal", action="store_true",
                        help="phases 3 to 8 on the CPU at a tiny size, no card")
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
    checks["fullrow_attention_fwd"].append(
        check_attention(torch, dev, *cfg["attention"][0], torch.float32, iters, rate=0.1))
    for shape in cfg["attention"]:
        for dt in dtypes:
            checks["fullrow_attention_fwd"].append(check_attention(torch, dev, *shape, dt, iters))
    mask_check = check_dropout_mask(torch, dev, cfg["attention"][0][0],
                                    cfg["attention"][0][1], 0.1, 2024)
    for shape in cfg["attention_bwd"]:
        for rate in (0.1, 0.0):
            for dt in dtypes:
                checks["fullrow_attention_bwd"].append(
                    check_attention_bwd(torch, dev, *shape, dt, iters, rate))
    for shape in cfg["norm"]:
        for dt in dtypes:
            for rms in (False, True):
                checks["fused_norm_fwd"].append(check_norm(torch, dev, *shape, dt, rms, iters))
                for kname, res in check_norm_bwd(torch, dev, *shape, dt, rms, iters).items():
                    checks[kname].append(res)
    for c in cfg["softmax"]:
        f_res, b_res = check_softmax(torch, dev, c, getattr(torch, c["dtype"]), iters)
        checks["softmax_dropout_fwd"].append(f_res)
        checks["softmax_dropout_bwd"].append(b_res)
    softmax_mask = check_softmax_mask(torch, dev, *cfg["softmax_mask"], 0.1, 2025)
    for c in cfg["flash"]:
        for dt in dtypes:
            for kname, res in check_flash(torch, dev, c, dt, iters).items():
                checks[kname].append(res)
    flash_mask = check_flash_mask(torch, dev, *cfg["flash_mask"], 0.1, 2026)
    for c in cfg["decode_checks"]:
        checks["decode_attention"].append(check_decode(torch, dev, c, iters))
    for c in cfg["quant_matmul"]:
        checks["quant_matmul"].append(check_quant_matmul(torch, dev, c, iters))
    for N, D, per_channel in cfg["quant_norm"]:
        checks["quant_layer_norm"].append(check_quant_norm(torch, dev, N, D, per_channel, iters))
    for c in cfg["quant_softmax"]:
        checks["quant_softmax_dropout_fwd"].append(check_quant_softmax(torch, dev, c, iters))
    log(f"phase 3 done at {time.monotonic() - started:.0f}s")

    # 4a. training through the CLI; 4b. card against CPU; 4. serving
    data = write_corpus(cfg)
    ckpt, train_launches = drive_training(torch, cfg, data, card, smi)
    log(f"phase 4a done at {time.monotonic() - started:.0f}s")
    drive_card_vs_cpu(torch, cfg, data)
    log(f"phase 4b done at {time.monotonic() - started:.0f}s")
    serve_launches = drive_slice(torch, cfg, ckpt, card, smi)
    log(f"phase 4 done at {time.monotonic() - started:.0f}s")

    # 5a. Uni-Mol training through the CLI; 5b. card against CPU
    um_data = write_conformers(cfg["unimol"])
    unimol_launches = drive_unimol_training(cfg, um_data, card, smi)
    log(f"phase 5a done at {time.monotonic() - started:.0f}s")
    drive_unimol_card_vs_cpu(torch, cfg, um_data)
    log(f"phase 5b done at {time.monotonic() - started:.0f}s")

    # 6a. Evoformer training through the CLI; 6b. card against CPU
    evo_data = write_msas(cfg["evoformer"], "evoformer_data")
    evoformer_launches = drive_evoformer_training(torch, cfg, evo_data, card, smi)
    log(f"phase 6a done at {time.monotonic() - started:.0f}s")
    drive_evoformer_card_vs_cpu(torch, cfg, evo_data)
    log(f"phase 6b done at {time.monotonic() - started:.0f}s")

    # 7. incremental-decode serving of the causal LM: fp32 KV, the card's
    # parity, int8 KV, a profile of the decode step
    lm_path, vocab, pad, eos = write_lm_checkpoint(torch, cfg, data)
    lm = {"vocab": vocab, "pad": pad, "eos": eos}
    decode_launches = drive_decode_serving(torch, cfg, lm_path, lm, card, smi, "fp32")
    check_decode_parity(torch, cfg, lm_path)
    decode8_launches = drive_decode_serving(torch, cfg, lm_path, lm, card, smi, "int8")
    profile_decode_steps(torch, cfg, lm_path, lm, card, smi)
    log(f"phase 7 done at {time.monotonic() - started:.0f}s")

    # 8. quantized serving of phase 4a's checkpoint: int8, then fp8
    # (the profile reads the int8 sidecar, which the fp8 server replaces)
    quant_launches = drive_quant_serving(torch, cfg, ckpt, card, smi, "int8")
    profile_serve_batches(torch, cfg, ckpt, card, smi)
    quant8_launches = drive_quant_serving(torch, cfg, ckpt, card, smi, "fp8")
    log(f"phase 8 done at {time.monotonic() - started:.0f}s")
    if opts.cpu_rehearsal:
        log("CPU rehearsal complete (no card: no kernels, no result line)")
        return 0

    # 9. result lines: each kernel at its main path's shape (fp32, the
    # first check of each) with every check beside it; ``launches`` is the
    # count of the run its slice ported it for (BERT training for the
    # attention and norm kernels, Uni-Mol for the fused softmax, the
    # Evoformer for the flash kernels, decode serving for the decode
    # attention, int8 serving for the quantized kernels), every path's
    # beside it
    by_path = {"train": train_launches, "serve": serve_launches,
               "unimol_train": unimol_launches, "evoformer_train": evoformer_launches,
               "decode_serve": decode_launches, "decode_serve_int8": decode8_launches,
               "quant_serve": quant_launches, "quant_serve_fp8": quant8_launches}
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
        if name == "flash_attention_fwd":
            row["dropout_mask_check"] = flash_mask
        kernels.append(row)
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
