"""Times the LayerNorm / RMSNorm backward of the checkout it runs in, on one
card, beside the library's backward (``F.layer_norm`` / ``F.rms_norm``).

The backward is taken through the public path, as training takes it: one
forward of ``fused_layer_norm`` / ``fused_rms_norm`` on leaves that need a
gradient, then ``torch.autograd.grad`` repeated on the retained graph.  It
reaches only the public API, ``ops.fused_norm._launch_fwd`` and
``_FusedNorm.backward`` (whose signatures older checkouts share) and the
kernel library's build, so a copy of this file times an older checkout's
backward the same way (put it under that checkout's
``unicore_tpu_torch/tools/`` and run it from that root).

For every shape (BERT's (4096, 768) in fp32, bf16 and fp16; 1024-wide rows;
Uni-Mol's pair head norm (16 * 128**2, 64); the Evoformer's pair (256**2,
128) and MSA (32 * 256, 256) norms; fp32 and bf16), with the weight and
bias in x's type as a ``--bf16`` / ``--fp16`` run keeps them, it prints one
``norm_bwd_ab`` JSON line:

* ``device_ms``: the summed durations of the device operations of one
  backward (``torch.profiler``), warm (inputs left in the 50 MB L2 by the
  previous call) and ``flushed`` (a 64 MB read-modify-write between calls,
  whose kernel is left out of the sum);
* ``ops``: device operations (kernels, memsets, copies) a backward;
* ``kernels_us_flushed``: each device kernel's flushed us a call;
* ``per_call_ms``: CUDA events around 100 back-to-back backwards, host
  included, median of 7;
* ``wrapper_per_call_ms``: the same for the port's backward alone, without
  the autograd engine: ``_FusedNorm.backward`` on a context that holds the
  forward kernel's residuals (its host work, allocations and launches; an
  older checkout's backward takes the same context);
* ``library_*``: the same for the library's backward on the same inputs;
* ``bound_ms``: the least time the card could take: 3 * N * D * itemsize
  (x and dy read, dx written) + the fp32 statistics the kernel reads (8 * N:
  mean and rstd; RMSNorm rstd alone, 4 * N) + the weight bytes (w read, dw
  and db written), at 3.35 TB/s.

Run from the root of a checkout on a machine with one NVIDIA card::

    python -m unicore_tpu_torch.tools.norm_bwd_ab [--label NAME]

To A/B two checkouts, copy this file into the other's
``unicore_tpu_torch/tools/`` and run both from their roots in turns
(parent, tree, tree, parent) in one session on the card.
"""

import argparse
import json
import re
import subprocess
import sys
import types

HBM_BYTES_PER_S = 3.35e12
#: (N, D, x's type, who runs it)
SHAPES = [
    (4096, 768, "float32", "BERT"),
    (4096, 768, "bfloat16", "BERT --bf16"),
    (4096, 768, "float16", "BERT --fp16"),
    (4097, 1024, "float32", "wide rows"),
    (4097, 1024, "bfloat16", "wide rows --bf16"),
    (16 * 128 * 128, 64, "float32", "Uni-Mol pair head norm"),
    (16 * 128 * 128, 64, "bfloat16", "Uni-Mol pair head norm --bf16"),
    (256 * 256, 128, "float32", "Evoformer pair"),
    (256 * 256, 128, "bfloat16", "Evoformer pair --bf16"),
    (32 * 256, 256, "float32", "Evoformer MSA"),
    (32 * 256, 256, "bfloat16", "Evoformer MSA --bf16"),
]
FLUSH_BYTES = 64 << 20
FLUSH_KERNEL = "bitwise_not"


def device_profile(torch, fn, iters, flush=None, attempts=3):
    """(device us a call, device operations a call, {kernel: us a call}) of
    ``iters`` warmed calls of ``fn`` under ``torch.profiler``, each after
    ``flush()`` when given (its kernel left out).  CUPTI drops kernel events
    now and then (one of 40, or all of them), never adds any: a profile
    whose count is not a whole number of operations a call, or that saw no
    device work, is taken again with a fresh profiler, up to ``attempts``
    profiles, and the fullest kept; (None, None, {}) when none saw any.  A
    one-byte pass of the flush kernel opens each profile, where a dropped
    first event costs nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    opener = torch.zeros(1, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    best = (0.0, 0, {})
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            opener.bitwise_not_()
            for _ in range(iters):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        total, ops, kernels = 0.0, 0, {}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA or FLUSH_KERNEL in ev.key:
                continue
            total += ev.self_device_time_total
            ops += ev.count
            name = re.search(r"(\w*_kernel\w*|Memset|Memcpy)", ev.key)
            name = name.group(1) if name else ev.key[:60]
            kernels[name] = kernels.get(name, 0.0) + ev.self_device_time_total / iters
        if ops > best[1]:
            best = (total, ops, kernels)
        if best[1] > 0 and best[1] % iters == 0:
            break
    if best[0] <= 0:
        return None, None, {}
    return best[0] / iters, best[1] / iters, best[2]


def per_call_ms(torch, fn, iters=100, repeats=7):
    """Median ms a call over ``repeats`` runs of ``iters`` back-to-back
    calls, CUDA events, host included."""
    for _ in range(10):
        fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return sorted(runs)[len(runs) // 2]


def backward_call(torch, out, leaves, dy):
    return lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)


def measure(torch, fwd, leaves, dy, flush, iters):
    call = backward_call(torch, fwd(), leaves, dy)
    warm_us, ops, _ = device_profile(torch, call, iters)
    cold_us, _, kernels = device_profile(torch, call, iters, flush)
    return {"device_ms": None if warm_us is None else warm_us / 1e3,
            "device_ms_flushed": None if cold_us is None else cold_us / 1e3,
            "ops": ops, "kernels_us_flushed": kernels,
            "per_call_ms": per_call_ms(torch, call)}


def wrapper_call(fn, leaves, dy, eps, rms):
    """``_FusedNorm.backward`` alone on the residuals its forward keeps."""
    x, w = leaves[0].detach(), leaves[1].detach()
    b = None if rms else leaves[2].detach()
    name = "fused_rms_norm" if rms else "fused_layer_norm"
    x2 = x.reshape(-1, x.shape[-1])
    _, mean, rstd = fn._launch_fwd(x2, w, b, eps, rms, True, name)
    ctx = types.SimpleNamespace(saved_tensors=(x2, w, mean, rstd), rms=rms, name=name,
                                has_bias=not rms,
                                needs_input_grad=(True, True, not rms, False, False, False))
    return lambda: fn._FusedNorm.backward(ctx, dy)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--label", default="tree", help="names the checkout in each line")
    parser.add_argument("--iters", type=int, default=20)
    opts = parser.parse_args(argv)
    import torch
    import torch.nn.functional as F

    from ..ops import _kernels
    from ..ops import fused_norm as fn

    if not torch.cuda.is_available():
        print("norm_bwd_ab: no CUDA card", file=sys.stderr)
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    _kernels.library()
    dev = torch.device("cuda", 0)
    buf = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def flush():
        buf.bitwise_not_()

    for N, D, dtype_name, used_by in SHAPES:
        dtype = getattr(torch, dtype_name)
        for rms in (False, True):
            g = torch.Generator(device=dev).manual_seed(N + D)
            x = (torch.randn(N, D, generator=g, device=dev) * 2 + 0.5).to(dtype)
            dy = torch.randn(N, D, generator=g, device=dev).to(dtype)
            w = (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype)
            b = (0.1 * torch.randn(D, generator=g, device=dev)).to(dtype)
            eps = 1e-6 if rms else 1e-5
            leaves = [t.clone().requires_grad_(True) for t in ((x, w) if rms else (x, w, b))]
            if rms:
                ours = lambda: fn.fused_rms_norm(leaves[0], leaves[1], eps)  # noqa: E731
                lib = ((lambda: F.rms_norm(leaves[0], (D,), leaves[1], eps))
                       if hasattr(F, "rms_norm") else None)
            else:
                ours = lambda: fn.fused_layer_norm(*leaves, eps)  # noqa: E731
                lib = lambda: F.layer_norm(leaves[0], (D,), leaves[1], leaves[2], eps)  # noqa: E731
            res = {"label": opts.label, "norm": "rms" if rms else "layer", "shape": [N, D],
                   "dtype": dtype_name, "weight_dtype": dtype_name, "used_by": used_by,
                   "card": smi.strip()}
            res.update(measure(torch, ours, leaves, dy, flush, opts.iters))
            res["wrapper_per_call_ms"] = per_call_ms(
                torch, wrapper_call(fn, leaves, dy, eps, rms))
            if lib is not None:
                lib_res = measure(torch, lib, leaves, dy, flush, opts.iters)
                res.update({f"library_{k}": v for k, v in lib_res.items()})
            item = x.element_size()
            nbytes = (3 * N * D * item + (4 if rms else 8) * N
                      + D * w.element_size() * (2 if rms else 3))
            res["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
            for key in ("device_ms", "device_ms_flushed"):
                if res.get(key):
                    res[f"{key}_of_bound"] = res["bound_ms"] / res[key]
            print("norm_bwd_ab " + json.dumps(res), flush=True)
            del x, dy, w, b, leaves
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
