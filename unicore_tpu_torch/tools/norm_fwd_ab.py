"""Times the LayerNorm / RMSNorm forward of the checkout it runs in, on one
card, beside the library's forward (``F.layer_norm`` / ``F.rms_norm``), and
the int8-input LayerNorm (7q) beside the dequant multiply + ``F.layer_norm``.

The forward is taken through the public path in its two forms:

* ``serving``: ``fused_layer_norm`` / ``fused_rms_norm`` on tensors that
  need no gradient, which writes y and no statistics;
* ``training``: the same on leaves that need a gradient, with autograd on
  (``_FusedNorm.apply``), which also writes the fp32 mean and rstd.

It reaches only the public API, ``ops.fused_norm._launch_fwd``,
``_FusedNorm.forward`` and ``quant_layer_norm_kernel`` (whose signatures
older checkouts share), so a copy of this file and of ``norm_bwd_ab.py``
(whose shapes, flush and timers it shares) times an older checkout's
forward the same way.

For every shape of ``norm_bwd_ab`` plus Uni-Mol's layer norms (2048, 512)
and a decode row block (8, 768), with the weight and bias in x's type as a
``--bf16`` / ``--fp16`` run keeps them, it prints one ``norm_fwd_ab`` JSON
line per form:

* ``device_ms`` / ``device_ms_flushed``: the summed durations of the
  device operations of one call (``torch.profiler``), warm and after a
  64 MB read-modify-write that leaves the L2 cold (its kernel left out);
* ``ops``: device operations a call; ``kernels_us_flushed``: by kernel;
* ``per_call_ms``: CUDA events around 100 back-to-back calls, host
  included, median of 7;
* ``wrapper_per_call_ms``: the same for the port's wrapper alone, without
  the autograd engine or the public dispatch: ``_launch_fwd`` on the 2-D
  rows (serving) or ``_FusedNorm.forward`` on a bare context (training);
* ``library_*``: the same for the library's forward on the same inputs
  (it writes its statistics in both forms);
* ``bound_ms``: x read and y written once, w (and b) read, and in training
  the fp32 statistics (8 * N: mean and rstd; RMSNorm 4 * N, rstd alone,
  which is all its backward reads), at 3.35 TB/s.

Run from the root of a checkout on a machine with one NVIDIA card::

    python -m unicore_tpu_torch.tools.norm_fwd_ab [--label NAME]

To A/B two checkouts, copy this file and ``norm_bwd_ab.py`` into the
other's ``unicore_tpu_torch/tools/`` and run both from their roots in turns
(parent, tree, tree, parent) in one session on the card.

``--host-ab ROOT`` times the wrapper's host work in one process against
another checkout at ROOT (loaded under another package name, with its own
kernel library): ``_launch_fwd`` (serving) and the public call without a
gradient at (4096, 768) and (8, 768), calls alternating between the two
checkouts in rounds of 200 (CUDA events: these calls are host-bound), one
``norm_fwd_host`` line per case with each checkout's median µs a call.

``--variants`` times instead the tree's forward kernel against copies of
``csrc/fused_norm.cu`` with one design choice undone each (each edit's
anchor must occur once in the source), through the C entry points on the
same inputs, serving form, L2 flushed, in turns (tree, copies, tree); one
``norm_fwd_variant`` line per (shape, copy), with the largest difference
from the tree's y:

* ``registers_all`` / ``shared_all``: w and b (and 7q's scales) held in
  registers at every width / in shared memory at every width, not in
  registers where the thread's row and its weights widened to fp32 take at
  most 224 bytes and in shared memory above that;
* ``no_prefetch`` / ``prefetch_all``: no row read ahead of its turn / every
  row's successor read while its sums run, not only rows of at most 32
  bytes a thread;
* ``persistent``: one wave of blocks, each walking an equal share of the
  rows, not at least four waves of contiguous ranges;
* ``ahead_one_group``: blocks of one row group where the rows allow it,
  not two where a row is read ahead (so that the read-ahead has a row);
* ``min_waves_2`` / ``min_waves_8``: a grid of at least two / eight waves
  of blocks, not four;
* ``teams_16``: rows of 33-64 vectors on teams of 16 threads (two rows a
  warp, up to 8 vectors a thread), not a warp (the backward's plan too,
  which this mode does not time).
"""

import argparse
import ctypes
import json
import subprocess
import sys
import threading
import types

from .norm_bwd_ab import FLUSH_BYTES, HBM_BYTES_PER_S, SHAPES as BWD_SHAPES
from .norm_bwd_ab import device_profile, per_call_ms

#: (N, D, x's type, who runs it): the backward's shapes and two more
SHAPES = BWD_SHAPES + [
    (2048, 512, "float32", "Uni-Mol layers"),
    (2048, 512, "bfloat16", "Uni-Mol layers --bf16"),
    (8, 768, "float32", "decode row block"),
    (8, 768, "bfloat16", "decode row block --bf16"),
]
#: the int8 LayerNorm's shape: BERT's LM head in int8 serving
QUANT_SHAPE = (4096, 768)
_HOLD = "constexpr int kFwdHoldBytes = 224;"
_WAVES = ("    const long long waves = slots * kFwdMinWaves;\n"
          "    long long per_block = groups > waves ? groups / waves : 1;")
#: name -> [(old, new), ...]: edits of csrc/fused_norm.cu that undo one choice
_AHEAD = "constexpr int kFwdPrefetchBytes = 32;"
_MIN_WAVES = "constexpr int kFwdMinWaves = 4;"
VARIANTS = {
    "registers_all": [(_HOLD, "constexpr int kFwdHoldBytes = 1 << 20;")],
    "shared_all": [(_HOLD, "constexpr int kFwdHoldBytes = 0;")],
    "no_prefetch": [(_AHEAD, "constexpr int kFwdPrefetchBytes = 0;")],
    "prefetch_all": [(_AHEAD, "constexpr int kFwdPrefetchBytes = 1 << 20;")],
    "persistent": [(_WAVES, "    long long per_block = (groups + slots - 1) / slots;")],
    "ahead_one_group": [("    if (K > 0 && fwd_reads_ahead<T, VEC, K>() && per_block < 2) "
                         "per_block = 2;", "")],
    "min_waves_2": [(_MIN_WAVES, _MIN_WAVES.replace("= 4;", "= 2;"))],
    "min_waves_8": [(_MIN_WAVES, _MIN_WAVES.replace("= 4;", "= 8;"))],
    "teams_16": [("    if (p.vec != 1 && tl < 5) tl = 5;",
                  "    if (p.vec != 1 && tl < 4) tl = 4;")],
}
#: the variants' shapes (N, D, x's type, weight in x's type), and 7q's
VARIANT_SHAPES = [(4096, 768, "float32"), (4096, 768, "bfloat16"), (4097, 1024, "float32"),
                  (16 * 128 * 128, 64, "float32"), (16 * 128 * 128, 64, "bfloat16"),
                  (256 * 256, 128, "float32"), (256 * 256, 128, "bfloat16"),
                  (32 * 256, 256, "float32"), (32 * 256, 256, "bfloat16"),
                  (2048, 512, "float32"), (8, 768, "float32")]


def measure(torch, call, flush, iters):
    warm_us, ops, _ = device_profile(torch, call, iters)
    cold_us, _, kernels = device_profile(torch, call, iters, flush)
    return {"device_ms": None if warm_us is None else warm_us / 1e3,
            "device_ms_flushed": None if cold_us is None else cold_us / 1e3,
            "ops": ops, "kernels_us_flushed": kernels, "per_call_ms": per_call_ms(torch, call)}


def shares(res):
    for key in ("device_ms", "device_ms_flushed", "library_device_ms",
                "library_device_ms_flushed"):
        if res.get(key):
            res[f"{key}_of_bound"] = res["bound_ms"] / res[key]


def norm_lines(torch, F, fn, dev, N, D, dtype_name, used_by, rms, flush, opts, card):
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(N + D)
    x = (torch.randn(N, D, generator=g, device=dev) * 2 + 0.5).to(dtype)
    w = (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype)
    b = None if rms else (0.1 * torch.randn(D, generator=g, device=dev)).to(dtype)
    eps = 1e-6 if rms else 1e-5
    name = "fused_rms_norm" if rms else "fused_layer_norm"
    leaves = [t.clone().requires_grad_(True) for t in ((x, w) if rms else (x, w, b))]

    def public(*args):
        return fn.fused_rms_norm(*args, eps) if rms else fn.fused_layer_norm(*args, eps)

    if rms:
        lib = ((lambda: F.rms_norm(x, (D,), w, eps)) if hasattr(F, "rms_norm") else None)
    else:
        lib = lambda: F.layer_norm(x, (D,), w, b, eps)  # noqa: E731
    lib_res = {} if lib is None else measure(torch, lib, flush, opts.iters)
    ctx = types.SimpleNamespace(save_for_backward=lambda *t: None)
    item = x.element_size()
    base = (2 * N * D * item + D * w.element_size() * (1 if rms else 2))
    forms = (
        ("serving", lambda: public(*((x, w) if rms else (x, w, b))),
         lambda: fn._launch_fwd(x, w, b, eps, rms, False, name), 0),
        ("training", lambda: public(*leaves),
         lambda: fn._FusedNorm.forward(ctx, x, w, b, eps, rms, name), (4 if rms else 8) * N),
    )
    for form, call, wrapper, stat_bytes in forms:
        res = {"label": opts.label, "form": form, "norm": "rms" if rms else "layer",
               "shape": [N, D], "dtype": dtype_name, "weight_dtype": dtype_name,
               "used_by": used_by, "card": card}
        with torch.set_grad_enabled(form == "training"):
            res.update(measure(torch, call, flush, opts.iters))
            res["wrapper_per_call_ms"] = per_call_ms(torch, wrapper)
        res.update({f"library_{k}": v for k, v in lib_res.items()})
        res["bound_ms"] = (base + stat_bytes) / HBM_BYTES_PER_S * 1e3
        shares(res)
        print("norm_fwd_ab " + json.dumps(res), flush=True)


def quant_lines(torch, F, fn, dev, flush, opts, card):
    N, D = QUANT_SHAPE
    for per_channel in (False, True):
        g = torch.Generator(device=dev).manual_seed(N + D)
        x = torch.randint(-127, 128, (N, D), generator=g, device=dev,
                          dtype=torch.int32).to(torch.int8)
        scale = torch.rand(D if per_channel else (), generator=g, device=dev) * 0.05 + 0.01
        w = 1 + 0.1 * torch.randn(D, generator=g, device=dev)
        b = 0.1 * torch.randn(D, generator=g, device=dev)
        res = {"label": opts.label, "form": "quant", "norm": "layer", "shape": [N, D],
               "dtype": "int8", "per_channel_scale": per_channel, "card": card}
        res.update(measure(torch, lambda: fn.quant_layer_norm_kernel(x, scale, w, b), flush,
                           opts.iters))
        lib = measure(torch, lambda: F.layer_norm(x.float() * scale, (D,), w, b, 1e-5), flush,
                      opts.iters)
        res.update({f"library_{k}": v for k, v in lib.items()})
        # int8 read, fp32 written, the scale(s), w and b read
        res["bound_ms"] = ((N * D + 4 * N * D + 4 * D * (3 if per_channel else 2))
                           / HBM_BYTES_PER_S * 1e3)
        shares(res)
        print("norm_fwd_ab " + json.dumps(res), flush=True)


def load_variant(path):
    lib = ctypes.CDLL(str(path))
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.unicore_fused_norm_fwd.argtypes = [p, p, p, p, p, p, ll, i, f, i, i, i, p]
    lib.unicore_quant_layer_norm_fwd.argtypes = [p, p, i, p, p, p, ll, i, f, p]
    lib.unicore_fused_norm_fwd.restype = lib.unicore_quant_layer_norm_fwd.restype = i
    return lib


def variant_lines(torch, fn, dev, flush, opts, card):
    """The tree's kernel and each copy's, in turns, on the same inputs."""
    from ..ops import _kernels
    from .flash_bwd_ab import build_variant

    built = {}
    threads = [threading.Thread(target=build_variant, args=(n, e, built, "fused_norm.cu"))
               for n, e in VARIANTS.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    libs = {"tree": _kernels.library()}
    for name, res in built.items():
        if isinstance(res, str):
            print("norm_fwd_variant " + json.dumps({"copy": name, "skipped": res}), flush=True)
        else:
            libs[name] = load_variant(res)
    order = ["tree", *[n for n in libs if n != "tree"], "tree"]
    stream = _kernels.stream_handle(dev)
    cases = [(N, D, dt, rms) for N, D, dt in VARIANT_SHAPES for rms in (False, True)]
    cases += [(*QUANT_SHAPE, "int8", per_channel) for per_channel in (False, True)]
    for N, D, dtype_name, flag in cases:
        g = torch.Generator(device=dev).manual_seed(N + D)
        if dtype_name == "int8":
            x = torch.randint(-127, 128, (N, D), generator=g, device=dev,
                              dtype=torch.int32).to(torch.int8)
            scale = torch.rand(D if flag else (), generator=g, device=dev) * 0.05 + 0.01
            w = 1 + 0.1 * torch.randn(D, generator=g, device=dev)
            b = 0.1 * torch.randn(D, generator=g, device=dev)
            y = torch.empty(N, D, device=dev)

            def call(lib):
                return lambda: lib.unicore_quant_layer_norm_fwd(
                    x.data_ptr(), scale.data_ptr(), int(flag), w.data_ptr(), b.data_ptr(),
                    y.data_ptr(), N, D, 1e-5, stream)
        else:
            dtype = getattr(torch, dtype_name)
            x = (torch.randn(N, D, generator=g, device=dev) * 2 + 0.5).to(dtype)
            w = (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype)
            b = (0.1 * torch.randn(D, generator=g, device=dev)).to(dtype)
            y = torch.empty_like(x)
            code = fn._DTYPES[dtype]

            def call(lib):
                return lambda: lib.unicore_fused_norm_fwd(
                    x.data_ptr(), w.data_ptr(), None if flag else b.data_ptr(), y.data_ptr(),
                    None, None, N, D, 1e-6 if flag else 1e-5, int(flag), code, code, stream)
        ref = None
        for name in order:
            run = call(libs[name])
            rc = run()
            torch.cuda.synchronize()
            out = y.float().clone()
            ref = out if ref is None else ref
            warm_us, _, _ = device_profile(torch, run, opts.iters)
            cold_us, _, _ = device_profile(torch, run, opts.iters, flush)
            print("norm_fwd_variant " + json.dumps({
                "copy": name, "shape": [N, D], "dtype": dtype_name,
                "rms" if dtype_name != "int8" else "per_channel_scale": flag, "rc": rc,
                "device_ms": None if warm_us is None else warm_us / 1e3,
                "device_ms_flushed": None if cold_us is None else cold_us / 1e3,
                "max_abs_diff_vs_tree": (out - ref).abs().max().item(), "card": card}),
                flush=True)
        torch.cuda.empty_cache()


HOST_SHAPES = [(4096, 768, "float32"), (4096, 768, "bfloat16"), (8, 768, "float32")]


def load_checkout(root, alias):
    """The fused_norm module of the checkout at ``root``, imported as the
    package ``alias`` (its modules import one another relatively)."""
    import importlib
    import importlib.util
    from pathlib import Path

    pkg = Path(root).resolve() / "unicore_tpu_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{alias}.ops.fused_norm")


def host_lines(torch, fn, dev, root, card, rounds=15, calls=200):
    other = load_checkout(root, "other_checkout")
    other._kernels.library()
    mods = {"other": other, "tree": fn}
    for N, D, dtype_name in HOST_SHAPES:
        g = torch.Generator(device=dev).manual_seed(N + D)
        dtype = getattr(torch, dtype_name)
        x = (torch.randn(N, D, generator=g, device=dev) * 2 + 0.5).to(dtype)
        w = (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype)
        b = (0.1 * torch.randn(D, generator=g, device=dev)).to(dtype)
        for form in ("wrapper", "public"):
            calls_of = {
                name: ((lambda m=m: m._launch_fwd(x, w, b, 1e-5, False, False,
                                                   "fused_layer_norm"))
                       if form == "wrapper" else (lambda m=m: m.fused_layer_norm(x, w, b)))
                for name, m in mods.items()}
            times = {name: [] for name in mods}
            with torch.no_grad():
                for name, call in calls_of.items():
                    for _ in range(20):
                        call()
                for r in range(rounds):
                    for name in (("other", "tree") if r % 2 == 0 else ("tree", "other")):
                        torch.cuda.synchronize()
                        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                        start.record()
                        for _ in range(calls):
                            calls_of[name]()
                        end.record()
                        torch.cuda.synchronize()
                        times[name].append(start.elapsed_time(end) / calls * 1e3)
            med = {name: sorted(t)[len(t) // 2] for name, t in times.items()}
            print("norm_fwd_host " + json.dumps({
                "shape": [N, D], "dtype": dtype_name, "form": form, "other": str(root),
                "other_us": med["other"], "tree_us": med["tree"],
                "other_us_range": [min(times["other"]), max(times["other"])],
                "tree_us_range": [min(times["tree"]), max(times["tree"])],
                "card": card}), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--label", default="tree", help="names the checkout in each line")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--variants", action="store_true",
                        help="the tree's kernel against copies with one choice undone")
    parser.add_argument("--host-ab", metavar="ROOT",
                        help="the wrapper's host time against the checkout at ROOT")
    opts = parser.parse_args(argv)
    import torch
    import torch.nn.functional as F

    from ..ops import _kernels
    from ..ops import fused_norm as fn

    if not torch.cuda.is_available():
        print("norm_fwd_ab: no CUDA card", file=sys.stderr)
        return 3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    _kernels.library()
    dev = torch.device("cuda", 0)
    buf = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def flush():
        buf.bitwise_not_()

    if opts.variants:
        variant_lines(torch, fn, dev, flush, opts, card)
        return 0
    if opts.host_ab:
        host_lines(torch, fn, dev, opts.host_ab, card)
        return 0
    for N, D, dtype_name, used_by in SHAPES:
        for rms in (False, True):
            norm_lines(torch, F, fn, dev, N, D, dtype_name, used_by, rms, flush, opts, card)
            torch.cuda.empty_cache()
    quant_lines(torch, F, fn, dev, flush, opts, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
