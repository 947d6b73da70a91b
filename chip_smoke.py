#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``unicore_tpu_torch``) on one NVIDIA
card: the quickest proof that the port builds, is right and serves on the
GPU.  Run it from the root of a checkout::

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero and prints no
result line):

1. device — the card's name and ``nvidia-smi`` name/power limit;
2. build — every ``unicore_tpu_torch/csrc/*.cu`` with nvcc (sm_90a), with
   each kernel's registers, shared memory and spills from ``-Xptxas -v``;
3. kernels — each kernel's wrapper on card tensors at the serve path's
   shapes against its plain PyTorch version on the same inputs (max abs
   error vs a stated tolerance), then its time (CUDA events, warmed, 100
   launches), the plain version's, one PyTorch library call's, and the
   least time the card could take (bytes over 3.35 TB/s or operations over
   the type's peak rate, whichever is larger);
4. the slice — a full-width BERT-base checkpoint (12 layers, 768 wide, 12
   heads, max_seq_len 512) with weights from a fixed seed and a ~30k-symbol
   dictionary, served by ``python -m unicore_tpu_torch.cli.serve --device
   cuda`` (batch 8, buckets 128/256/384/512); requests of every bucket, some
   concurrent; per-batch kernel launches read from ``/stats`` (12 attention,
   26 norm); two 128-bucket answers held against the same checkpoint run in
   this process on the CPU through the plain versions; SIGTERM → drain →
   exit 0;
5. the ``nvidia-smi`` line (name, power limit), the ``kernels`` JSON line
   and, last, the ``{"ok": true, "device": ...}`` line.

Without a CUDA card, or without the port beside it, it exits non-zero.
``--cpu-rehearsal`` runs phases 3-4 on the CPU at a tiny size through the
plain versions (no card, no kernels, no result line) to check the script's
own control flow.
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
#: max-abs-error tolerances, kernel vs plain version on the same inputs:
#: fp32 differs only in summation order; bf16 may round last-bit fp32
#: differences to neighbouring bf16 values (one ulp is 2**-8 below 1 and
#: 2**-4 below 16 in magnitude)
TOL = {
    "attention": {"float32": 2e-5, "bfloat16": 2e-2},
    "norm": {"float32": 1e-5, "bfloat16": 6.25e-2},
}
REPLACES = {
    "fullrow_attention_fwd": "unicore_tpu/ops/attention_fullrow.py:110",
    "fused_norm_fwd": "unicore_tpu/ops/fused_norm.py:56",
}
SOURCES = {
    "fullrow_attention_fwd": "unicore_tpu_torch/csrc/attention_fullrow.cu",
    "fused_norm_fwd": "unicore_tpu_torch/csrc/fused_norm.cu",
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


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def time_ms(torch, fn, device, iters=100, warm=10):
    """Mean milliseconds per call: CUDA events around ``iters`` warmed calls
    on the card; the host clock on the CPU rehearsal."""
    for _ in range(warm):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_attention(torch, device, B, H, L, D, dtype, iters):
    import torch.nn.functional as F

    from unicore_tpu_torch.ops import attention_fullrow as fr

    g = torch.Generator(device=device).manual_seed(L)
    q = (torch.randn(B, H, L, D, generator=g, device=device) * D ** -0.5).to(dtype)
    k = torch.randn(B, H, L, D, generator=g, device=device).to(dtype)
    v = torch.randn(B, H, L, D, generator=g, device=device).to(dtype)
    bias = torch.randn(1, H, L, L, generator=g, device=device)
    lens = torch.linspace(L, L // 3, B, device=device).long()
    lens[-1] = 0  # a fully-masked row, like the serve engine's fill rows
    mask = (torch.arange(L, device=device)[None, :] >= lens[:, None]).to(torch.int32)

    out = fr.fullrow_attention(q, k, v, bias=bias, kv_padding_mask=mask)
    ref = fr.fullrow_attention_plain(q, k, v, bias, mask)
    err = (out.float() - ref.float()).abs().max().item()
    masked_row_zero = out[-1].abs().max().item() == 0.0
    tol = TOL["attention"][str(dtype).split(".")[1]]
    name = f"attention B={B} H={H} L={L} D={D} {dtype}"
    if not (err <= tol and masked_row_zero and math.isfinite(err)):
        raise AssertionError(
            f"{name}: kernel vs plain max abs err {err} (tol {tol}), "
            f"fully-masked row zero: {masked_row_zero}"
        )
    # the library yardstick: SDPA with a float mask and no fully-masked row
    lens_lib = lens.clone()
    lens_lib[-1] = L // 3
    keymask = torch.arange(L, device=device)[None, :] >= lens_lib[:, None]
    attn_mask = (bias + torch.where(keymask, float("-inf"), 0.0)[:, None, None, :]).to(dtype)
    res = {
        "shape": [B, H, L, D], "dtype": str(dtype).split(".")[1],
        "max_abs_err": err, "tolerance": tol,
        "ms": time_ms(torch, lambda: fr.fullrow_attention(
            q, k, v, bias=bias, kv_padding_mask=mask), device, iters),
        "plain_ms": time_ms(torch, lambda: fr.fullrow_attention_plain(
            q, k, v, bias, mask), device, iters),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, scale=1.0), device, iters),
    }
    itemsize = q.element_size()
    nbytes = 4 * B * H * L * D * itemsize + bias.numel() * 4 + mask.numel() * 4
    res["bound_ms"], res["bound_by"] = bound_ms(
        nbytes, 4 * B * H * L * L * D, res["dtype"]
    )
    log(f"{name}: {json.dumps(res)}")
    return res


def check_norm(torch, device, N, D, dtype, rms, iters):
    import torch.nn.functional as F

    from unicore_tpu_torch.ops import fused_norm as fn

    g = torch.Generator(device=device).manual_seed(N + D)
    x = (torch.randn(N, D, generator=g, device=device) * 2 + 0.5).to(dtype)
    w = 1 + 0.1 * torch.randn(D, generator=g, device=device)
    b = 0.1 * torch.randn(D, generator=g, device=device)
    if rms:
        call = lambda: fn.fused_rms_norm(x, w)  # noqa: E731
        plain = lambda: fn.fused_norm_plain(x, w, None, 1e-6, True)  # noqa: E731
        lib = (lambda: F.rms_norm(x, (D,), w.to(dtype), 1e-6)) if hasattr(F, "rms_norm") else None  # noqa: E731
    else:
        call = lambda: fn.fused_layer_norm(x, w, b)  # noqa: E731
        plain = lambda: fn.fused_norm_plain(x, w, b, 1e-5, False)  # noqa: E731
        lib = lambda: F.layer_norm(x, (D,), w.to(dtype), b.to(dtype), 1e-5)  # noqa: E731
    err = (call().float() - plain().float()).abs().max().item()
    tol = TOL["norm"][str(dtype).split(".")[1]]
    name = f"{'rms' if rms else 'layer'}_norm N={N} D={D} {dtype}"
    if not (err <= tol and math.isfinite(err)):
        raise AssertionError(f"{name}: kernel vs plain max abs err {err} (tol {tol})")
    res = {
        "shape": [N, D], "dtype": str(dtype).split(".")[1], "rms": rms,
        "max_abs_err": err, "tolerance": tol,
        "ms": time_ms(torch, call, device, iters),
        "plain_ms": time_ms(torch, plain, device, iters),
        "library_ms": None if lib is None else time_ms(torch, lib, device, iters),
    }
    nbytes = 2 * N * D * x.element_size() + D * 4 * (1 if rms else 2)
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 8 * N * D, "float32")
    log(f"{name}: {json.dumps(res)}")
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


def write_checkpoint(torch, cfg):
    from unicore_tpu_torch import checkpoint_utils
    from unicore_tpu_torch.models import ARCH_CONFIG_REGISTRY
    from unicore_tpu_torch.tasks.bert import BertTask

    data = WORK / "data"
    data.mkdir(parents=True, exist_ok=True)
    words = ["[CLS]", "[PAD]", "[SEP]", "[UNK]"] + [
        f"w{i}" for i in range(cfg["symbols"])
    ]
    (data / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    args = argparse.Namespace(task="bert", arch=cfg["arch"], data=str(data), seed=1)
    ARCH_CONFIG_REGISTRY[cfg["arch"]](args)
    task = BertTask.setup_task(args)
    gen = torch.Generator(device=cfg["device"]).manual_seed(0)
    model = task.build_model(args, device=cfg["device"], generator=gen)
    path = WORK / "checkpoint.pt"
    checkpoint_utils.save_checkpoint(str(path), args, model.state_dict())
    del model
    return path, task


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


def drive_slice(torch, cfg, card, smi):
    import numpy as np

    from unicore_tpu_torch.ops import _kernels

    t0 = time.monotonic()
    path, task = write_checkpoint(torch, cfg)
    vocab, pad = len(task.dictionary), task.dictionary.pad()
    log(f"checkpoint {cfg['arch']} vocab {vocab} written in "
        f"{time.monotonic() - t0:.1f}s")
    server = Server(path, cfg)
    try:
        server.wait_ready(cfg["ready_budget_s"])
        log(f"server ready at {server.base} after {time.monotonic() - t0:.1f}s")
        rng = np.random.default_rng(cfg["seed"])
        reqs = [rng.integers(4, vocab, size=n).tolist() for n in cfg["lengths"]]
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
            "arch": cfg["arch"], "card": card, "nvidia_smi": smi,
        }
        print("serve " + json.dumps(serve), flush=True)
        return launches
    finally:
        server.stop()


# ---------------------------------------------------------------------------

CHIP = {
    "attention": [(8, 12, 512, 64), (8, 12, 128, 64)],
    "norm": [(4096, 768), (4097, 1024)],
    "iters": 100,
    "arch": "bert_base", "symbols": 30000, "batch": 8, "seed": 0,
    # every bucket of 128/256/384/512 at both of its edges, plus a few more
    "lengths": [1, 17, 64, 100, 128, 129, 200, 256, 257, 300, 384, 385,
                450, 500, 511, 512, 33, 77, 222, 333],
    "ready_budget_s": 600,
    "per_batch": {"fullrow_attention_fwd": 12, "fused_norm_fwd": 26},
}
REHEARSAL = {
    "attention": [(2, 2, 128, 16)],
    "norm": [(33, 64)],
    "iters": 2,
    "arch": "bert_tiny", "symbols": 200, "batch": 4, "seed": 0,
    "lengths": [1, 20, 32, 33, 64, 96, 97, 128],
    "ready_budget_s": 120,
    "per_batch": {"fullrow_attention_fwd": 2, "fused_norm_fwd": 6},
}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu-rehearsal", action="store_true",
                        help="phases 3-4 on the CPU at a tiny size, no card")
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

    # 3. kernels against their plain versions
    checks = {"fullrow_attention_fwd": [], "fused_norm_fwd": []}
    dtypes = [torch.float32, torch.bfloat16]
    for shape in cfg["attention"]:
        for dt in dtypes:
            checks["fullrow_attention_fwd"].append(
                check_attention(torch, cfg["device"], *shape, dt, cfg["iters"]))
    for shape in cfg["norm"]:
        for dt in dtypes:
            for rms in (False, True):
                checks["fused_norm_fwd"].append(
                    check_norm(torch, cfg["device"], *shape, dt, rms, cfg["iters"]))

    # 4. the slice
    launches = drive_slice(torch, cfg, card, smi)
    if opts.cpu_rehearsal:
        log("CPU rehearsal complete (no card: no kernels, no result line)")
        return 0

    # 5. result lines: each kernel at the serve path's shape (fp32; the
    # first attention / LayerNorm entry), with every check beside it
    kernels = []
    for name, rows in checks.items():
        main_row = rows[0]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches.get(name, 0),
            "max_abs_err": main_row["max_abs_err"],
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "shape": main_row["shape"], "dtype": main_row["dtype"],
            "checks": rows,
        })
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
