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
   over the type's peak rate, whichever is larger);
4a. training — ``python -m unicore_tpu_torch.cli.train --device cuda`` on a
   full-width BERT-base (12 layers, 768 wide, 12 heads, max_seq_len 512;
   weights from ``--seed``) over an indexed corpus written from a seed
   (a ~30k-word dictionary, documents of 380-510 words so batches fill the
   384 and 512 buckets), ``--seq-pad-multiple 128``, batch 8,
   ``--update-freq 2``, Adam, clip 1.0, polynomial decay with warmup, the
   arch's own dropouts; kernel launches per micro-batch read from the CLI's
   stats line (12 attention forward + 12 backward, 26 norm forward + 26 dx
   + 26 dw/db), every loss finite and the last losses below the first;
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
5. the ``nvidia-smi`` line (name, power limit), the ``kernels`` JSON line
   and, last, the ``{"ok": true, "device": ...}`` line.

Without a CUDA card, or without the port beside it, it exits non-zero.
``--cpu-rehearsal`` runs phases 3, 4a, 4b and 4 on the CPU at ``bert_tiny``
through the plain versions (no card, no kernels, no result line) to check
the script's own control flow.
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
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
#: tolerances, kernel vs plain version on the same inputs.  Forward
#: outputs, max abs error: fp32 differs only in summation order; bf16 may
#: round last-bit fp32 differences to neighbouring bf16 values (one ulp is
#: 2**-8 below 1 and 2**-4 below 16 in magnitude).  Gradients, per element
#: (:func:`grad_check`): the ``*_grad`` fraction of the reference's largest
#: magnitude (at least 1) for every output, the fp32 outputs of bf16 runs
#: included (dw, db, dbias, and dk, dv as the kernel sums them before their
#: cast) -- the attention backward adds dk, dv and dbias by atomics in an
#: order that changes from run to run; plus two bf16 ulps of the element
#: (BF16_ULPS of it) for an output stored in bf16, and for the attention
#: backward in bf16 ``bwd_rounding_slack``: pd and ds round to bf16 before
#: their products, and may land one ulp apart on the two sides.
TOL = {
    "attention": {"float32": 2e-5, "bfloat16": 2e-2},
    "norm": {"float32": 1e-5, "bfloat16": 6.25e-2},
    "attention_grad": 1e-4,
    "norm_grad": 1e-5,
}
BF16_ULPS = 2.0 ** -6
KERNELS = {
    "fullrow_attention_fwd": ("unicore_tpu/ops/attention_fullrow.py:110",
                              "unicore_tpu_torch/csrc/attention_fullrow.cu"),
    "fullrow_attention_bwd": ("unicore_tpu/ops/attention_fullrow.py:205",
                              "unicore_tpu_torch/csrc/attention_fullrow.cu"),
    "fused_norm_fwd": ("unicore_tpu/ops/fused_norm.py:56",
                       "unicore_tpu_torch/csrc/fused_norm.cu"),
    "fused_norm_dx": ("unicore_tpu/ops/fused_norm.py:140",
                      "unicore_tpu_torch/csrc/fused_norm.cu"),
    "fused_norm_dwdb": ("unicore_tpu/ops/fused_norm.py:157",
                        "unicore_tpu_torch/csrc/fused_norm.cu"),
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
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 4 * B * H * L * L * D,
                                                res["dtype"])
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
    if dtype == torch.bfloat16 and device.type == "cuda":
        # dk and dv as the kernel sums them in fp32, before their cast
        _, dk32, dv32, _ = fr._launch_bwd(q, k, v, bias, mask, do, 1.0, rate, seed, True)
        pairs += [("dk_fp32", dk32, ref[1], slack[1]), ("dv_fp32", dv32, ref[2], slack[2])]
    errs, ratios = {}, {}
    for gname, g, r, s in pairs:
        errs[gname], ratios[gname] = grad_check(torch, f"{name}: {gname}", g, r,
                                                TOL["attention_grad"], s)
    # the backward kernel alone on the card (its launch, with the zeroed
    # fp32 sums it adds into); the whole autograd backward on the CPU
    kernel = ((lambda: fr._launch_bwd(q, k, v, bias, mask, do, 1.0, rate, seed, True))
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
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 10 * B * H * L * L * D,
                                                res["dtype"])
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


def drive_training(cfg, data, card, smi):
    save_dir = WORK / "train_ckpt"
    log_path = WORK / "train.log"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    argv = [sys.executable, "-m", "unicore_tpu_torch.cli.train",
            *train_argv(cfg, data, save_dir, cfg["device"].type)]
    t0 = time.monotonic()
    with open(log_path, "w") as f:
        proc = subprocess.run(argv, stdout=f, stderr=subprocess.STDOUT, cwd=str(ROOT),
                              env=env, timeout=cfg["train"]["timeout_s"])
    text = log_path.read_text()
    if proc.returncode != 0:
        raise RuntimeError(f"train CLI exited {proc.returncode}:\n{text[-6000:]}")
    lines = [ln for ln in text.splitlines() if ln.startswith("TRAIN stats ")]
    if not lines:
        raise AssertionError(f"no TRAIN stats line:\n{text[-6000:]}")
    stats = json.loads(lines[-1][len("TRAIN stats "):])
    for ln in text.splitlines():
        if "| update " in ln:
            log("train " + ln.split(" | ", 3)[-1])
    losses = stats["loss_per_update"]
    micro = stats["micro_batches"]
    launches = stats["kernel_launches"]
    want = cfg["train"]["per_micro_batch"]
    log(f"training: {stats['updates']} updates, {micro} micro-batches in "
        f"{time.monotonic() - t0:.1f}s; launches {launches} (want per "
        f"micro-batch {want})")
    if stats["updates"] != cfg["train"]["updates"]:
        raise AssertionError(f"{stats['updates']} updates, want {cfg['train']['updates']}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not last < first:
        raise AssertionError(f"loss did not fall: first 5 mean {first}, last 5 mean {last}")
    if cfg["device"].type == "cuda":
        for k, n in want.items():
            if launches.get(k) != n * micro:
                raise AssertionError(f"{k}: {launches.get(k)} launches for {micro} "
                                     f"micro-batches, want {n} per micro-batch")
    elif sum(launches.values()):
        raise AssertionError(f"the CPU rehearsal launched kernels: {launches}")
    train = {
        "arch": cfg["arch"], "updates": stats["updates"], "micro_batches": micro,
        "batch": cfg["batch"], "update_freq": cfg["train"]["update_freq"],
        "loss_first5_mean": first, "loss_last5_mean": last,
        "median_step_ms": stats["median_step_ms"], "tokens_per_s": stats["tokens_per_s"],
        "tokens": stats["tokens"], "peak_memory_bytes": stats["peak_memory_bytes"],
        "step_ms": stats["step_ms"], "card": card, "nvidia_smi": smi,
    }
    print("train " + json.dumps(train), flush=True)
    return save_dir / "checkpoint_last.pt", launches


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
            card_launches.get(k, 0) > 0 for k in KERNELS):
        raise AssertionError(f"the card run missed a kernel: {card_launches}")
    if not (loss_rel <= 1e-4 and gnorm_rel <= 1e-3 and param_err <= param_tol):
        raise AssertionError(f"card and CPU disagree: loss {loss_rel} (1e-4 rel), "
                             f"gnorm {gnorm_rel} (1e-3 rel), params {param_err} "
                             f"({param_tol} abs)")
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
    def __init__(self, path, cfg):
        self.log_path = WORK / "serve.log"
        self._log = open(self.log_path, "w")
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "unicore_tpu_torch.cli.serve",
             "--path", str(path), "--device", cfg["device"].type,
             "--port", "0", "--serve-batch-size", str(cfg["batch"]),
             "--serve-buckets", "4", "--default-deadline-ms", "120000",
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

CHIP = {
    # the training path's buckets: 512 and 384 (documents of 380-510 words)
    # and the serving path's smallest, 128
    "attention": [(8, 12, 512, 64), (8, 12, 384, 64), (8, 12, 128, 64)],
    "attention_bwd": [(8, 12, 512, 64), (8, 12, 384, 64), (8, 12, 128, 64)],
    "norm": [(4096, 768), (4097, 1024)],
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
}
REHEARSAL = {
    "attention": [(2, 2, 128, 16)],
    "attention_bwd": [(2, 2, 128, 16)],
    "norm": [(33, 64)],
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
}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu-rehearsal", action="store_true",
                        help="phases 3, 4a, 4b and 4 on the CPU at a tiny size, no card")
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
    log(f"phase 3 done at {time.monotonic() - started:.0f}s")

    # 4a. training through the CLI; 4b. card against CPU; 4. serving
    data = write_corpus(cfg)
    ckpt, train_launches = drive_training(cfg, data, card, smi)
    log(f"phase 4a done at {time.monotonic() - started:.0f}s")
    drive_card_vs_cpu(torch, cfg, data)
    log(f"phase 4b done at {time.monotonic() - started:.0f}s")
    serve_launches = drive_slice(torch, cfg, ckpt, card, smi)
    log(f"phase 4 done at {time.monotonic() - started:.0f}s")
    if opts.cpu_rehearsal:
        log("CPU rehearsal complete (no card: no kernels, no result line)")
        return 0

    # 5. result lines: each kernel at the training path's shape (fp32, the
    # first check of each) with every check beside it; ``launches`` is the
    # training run's count (the main path of this slice), the serve run's
    # beside it
    kernels = []
    for name, rows in checks.items():
        main_row = rows[0]
        replaces, source = KERNELS[name]
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": train_launches.get(name, 0),
            "launches_by_path": {"train": train_launches.get(name, 0),
                                 "serve": serve_launches.get(name, 0)},
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
