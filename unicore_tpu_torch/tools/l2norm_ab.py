"""Times K-a (``unicore_multi_tensor_l2norm``, both stages) of the checkout it
runs in at several stage-1 spans, beside another checkout's K-a and
``torch.linalg.vector_norm``, on one card and on the same fp32 buffer.

The span is the elements of one stage-1 partial (``kNormSpan`` in
``csrc/multi_tensor.cu``); ZeRO pads each flat buffer to a multiple of the
world size times the span, so a rank's segment gives the whole buffer's
partials.  Each library is the checkout's ``multi_tensor.cu`` built at a
span (``-DUNICORE_NORM_SPAN=<span>``) and a number of float4 loads a thread
keeps in flight (``-DUNICORE_NORM_BATCH=<batch>``, which leaves the bits as
they are; a batch that does not divide the span's loads a thread is
skipped); ``--other ROOT`` adds the ``multi_tensor.cu`` of the checkout at
ROOT as it is (its C interface for K-a is the same: buffer pointers and
lengths, the denominator, the partials, the output, the stream).  Each
library is built into ``build/l2norm_ab/`` with the package's ``nvcc``
flags, all at once.

Run from the root of a checkout on a machine with one NVIDIA card::

    python -m unicore_tpu_torch.tools.l2norm_ab [--numel N] [--spans 8192,32768] \\
        [--batches 4,16] [--other ROOT]

It prints one ``l2norm_ab`` JSON line per library and turn (turns: other,
spans in order, spans reversed, other), then one ``l2norm_ab_summary`` line:
for each library its median of the turns' ``device_ms`` (the profiler's
kernel durations of one call, warm: the buffer is larger than the L2) and
``per_call_ms`` (CUDA events over 100 calls), its stage-1 blocks and
registers a thread (``ptxas``), the norm's
relative error against a float64 sum, and whether its bits equal the
checkout's default span's; the bound (4 bytes an element read once at
3.35 TB/s); ``vector_norm`` of the buffer; the card's name and power limit.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import threading
from pathlib import Path

from .norm_bwd_ab import HBM_BYTES_PER_S, device_profile, per_call_ms

#: BERT-base's fp32 flat group (the parameters of ``bert_base``)
NUMEL = 109_115_576
SPANS = (8192, 32768, 131072)
BATCHES = (4, 8, 16)


def build(name, src, defines, out):
    """``src`` (a multi_tensor.cu beside its headers) with ``defines`` into
    build/l2norm_ab/<name>/lib.so; out[name] = its path or the error."""
    from ..ops import _kernels

    d = _kernels.BUILD_DIR.parent / "l2norm_ab" / name
    d.mkdir(parents=True, exist_ok=True)
    nvcc = _kernels._nvcc()
    obj, lib = d / "multi_tensor.o", d / "lib.so"
    r = subprocess.run([nvcc, *_kernels.NVCC_FLAGS, *defines, "-I", str(src.parent), "-c",
                        str(src), "-o", str(obj)], capture_output=True, text=True)
    if r.returncode == 0:
        link = subprocess.run([nvcc, "-shared", *_kernels.NVCC_FLAGS[:2], "-o", str(lib),
                               str(obj)], capture_output=True, text=True)
        if link.returncode:
            r = link
    if r.returncode:
        out[name] = f"nvcc failed: {r.stdout[-2000:]}{r.stderr[-2000:]}"
        return
    out[name] = lib
    # ptxas -v: the "Used N registers" line after the stage-1 kernel's entry
    lines = (r.stdout + r.stderr).splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "l2norm_partial" in line:
            used = [x for x in lines[i + 1:i + 6] if "Used" in x]
            out[f"{name}.ptxas"] = used[0].strip() if used else None
            break


def load(path):
    lib = ctypes.CDLL(str(path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.unicore_l2norm_blocks.argtypes = [ll]
    lib.unicore_l2norm_blocks.restype = ll
    lib.unicore_multi_tensor_l2norm.argtypes = [p, p, i, p, p, p, p]
    lib.unicore_multi_tensor_l2norm.restype = i
    return lib


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--numel", type=int, default=NUMEL)
    parser.add_argument("--spans", default=",".join(map(str, SPANS)))
    parser.add_argument("--batches", default=",".join(map(str, BATCHES)),
                        help="float4 loads in flight a thread")
    parser.add_argument("--other", default=None, metavar="ROOT",
                        help="another checkout whose K-a is timed as it is")
    parser.add_argument("--iters", type=int, default=20)
    opts = parser.parse_args(argv)
    import torch

    from ..ops import _kernels
    from ..optim.multi_tensor import NORM_SPAN

    if not torch.cuda.is_available():
        print("l2norm_ab: no CUDA card", file=sys.stderr)
        return 3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    tree = _kernels.CSRC / "multi_tensor.cu"
    jobs = {f"span_{s}_batch_{b}": (tree, [f"-DUNICORE_NORM_SPAN={s}",
                                           f"-DUNICORE_NORM_BATCH={b}"])
            for s in map(int, opts.spans.split(",")) for b in map(int, opts.batches.split(","))
            if (s // 1024) % b == 0}
    if opts.other:
        jobs["other"] = (Path(opts.other).resolve() / "unicore_tpu_torch" / "csrc" /
                         "multi_tensor.cu", [])
    built = {}
    threads = [threading.Thread(target=build, args=(n, src, dfn, built))
               for n, (src, dfn) in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = {n: built[n] for n in jobs if not isinstance(built.get(n), Path)}
    if failed:
        print("l2norm_ab: " + json.dumps(failed), file=sys.stderr)
        return 1
    libs = {n: load(built[n]) for n in jobs}
    dev = torch.device("cuda", 0)
    n = opts.numel
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(n, generator=g, device=dev) * 1e-3
    denom = torch.tensor(3.0, device=dev)
    exact = float((x.double() / 3.0).square().sum().sqrt())
    stream = _kernels.stream_handle(dev)
    bufs, sizes = (ctypes.c_void_p * 1)(x.data_ptr()), (ctypes.c_longlong * 1)(n)
    outs = {}

    def call(name):
        lib = libs[name]
        part = torch.empty(lib.unicore_l2norm_blocks(n), device=dev)
        out = outs.setdefault(name, torch.empty((), device=dev))

        def run():
            rc = lib.unicore_multi_tensor_l2norm(bufs, sizes, 1, denom.data_ptr(),
                                                 part.data_ptr(), out.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"l2norm_ab {name}: CUDA error {rc}")
        return run

    spans = [k for k in jobs if k != "other"]
    order = (["other"] if opts.other else []) + spans + spans[::-1] + (
        ["other"] if opts.other else [])
    turns = {}
    for name in order:
        run = call(name)
        us, _, kernels = device_profile(torch, run, opts.iters)
        line = {"library": name, "device_ms": None if us is None else us / 1e3,
                "kernels_us": kernels, "per_call_ms": per_call_ms(torch, run), "card": card}
        turns.setdefault(name, []).append(line)
        print("l2norm_ab " + json.dumps(line), flush=True)
    vn = lambda: torch.linalg.vector_norm(x)  # noqa: E731
    us, _, _ = device_profile(torch, vn, opts.iters)
    default = next((outs[k] for k in outs if k.startswith(f"span_{NORM_SPAN}_")), None)

    def median(vals):
        vals = sorted(v for v in vals if v is not None)
        return vals[len(vals) // 2] if vals else None

    summary = {"numel": n, "bound_ms": 4 * n / HBM_BYTES_PER_S * 1e3, "default_span": NORM_SPAN,
               "vector_norm_device_ms": None if us is None else us / 1e3,
               "vector_norm_per_call_ms": per_call_ms(torch, vn), "card": card, "libraries": {}}
    for name, lines in turns.items():
        out = outs[name]
        summary["libraries"][name] = {
            "device_ms": median([t["device_ms"] for t in lines]),
            "per_call_ms": median([t["per_call_ms"] for t in lines]),
            "stage1_blocks": libs[name].unicore_l2norm_blocks(n),
            "ptxas": built.get(f"{name}.ptxas"),
            "rel_err_vs_float64": abs(float(out) - exact) / exact,
            "bits_equal_default": (None if default is None else
                                   bool(out.view(torch.int32) == default.view(torch.int32)))}
    print("l2norm_ab_summary " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
