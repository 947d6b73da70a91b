"""The serve CLI's control plane end to end on the CPU
(``python -m unicore_tpu_torch.cli.serve --device cpu``), two servers:

1. a tiny fp32 BERT under ``--fault-inject slow-client:2@0`` with
   ``--request-read-timeout 1``: the first request is answered 408 with the
   named reason and the next one 200; ``GET /metrics`` parses and its
   served, batch and shed counters equal ``/stats``; ``POST /v1/reload``
   answers 404 (no fleet); a bf16 checkpoint published onto ``--path``
   (copy + ``os.replace``) under ``--reload-interval 0.3`` swaps in and
   answers as the bf16 model does in this process; SIGTERM drains and exits
   0; the journal beside the checkpoint holds the run's events;
2. a tiny ``transformer_lm`` on the decode engine under ``--fault-inject
   corrupt-reload@0``: the first published candidate is rotten and rolls
   back (``rejected:verify``) while ``/v1/generate`` keeps answering; the
   same candidate re-published swaps in; the journal holds
   ``rejected:verify``, ``swapped`` and ``swapped-in``; ``/metrics`` carries
   the decode gauges.

Plus the flood generator in process: ``request-flood`` offers its rate into
admission, which sheds with named reasons while admitted requests are
answered within their deadlines.

Tolerances: the swapped-in bf16 server's ids equal this process's bf16
forward and its score within 1e-3 (two processes, one CPU library: the
same kernels; a thread count may split a sum differently).
"""

import json
import os
import shutil
import signal
import threading
import time
import urllib.request
from argparse import Namespace

import numpy as np
import torch

from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.cli import serve as serve_cli
from unicore_tpu_torch.distributed import chaos
from unicore_tpu_torch.serve import ServeEngine, build_infer_fn
from unicore_tpu_torch.serve import request as rq

from test_torch_bert import PAD, random_jax_variables
from test_torch_decode import random_jax_lm
from test_torch_decode_serve import write_lm_checkpoint
from test_torch_serve import PortServer, _get, _post
from test_torch_serve_control import _write_bert_checkpoint


def _metrics(base):
    """The exposition as {name{labels}: value}."""
    with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
        assert r.headers["Content-Type"].startswith("text/plain; version=0.0.4")
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


def _wait_log(srv, text, budget=60.0):
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        if text in srv.log():
            return
        assert srv.proc.poll() is None, srv.log()[-4000:]
        time.sleep(0.1)
    raise AssertionError(f"{text!r} never logged:\n{srv.log()[-4000:]}")


def _journal(path):
    jpath = os.path.join(os.path.dirname(str(path)), "telemetry", "events_rank0_serve.jsonl")
    with open(jpath) as f:
        return [json.loads(line) for line in f if line.strip()]


def _publish(src, dst):
    tmp = str(dst) + ".tmp"
    shutil.copy(src, tmp)
    os.replace(tmp, dst)


def test_slow_client_metrics_and_a_bf16_swap_through_the_cli(tmp_path):
    _, variables = random_jax_variables(post_ln=True)
    path = _write_bert_checkpoint(tmp_path, variables)
    cand = _write_bert_checkpoint(tmp_path, variables, name="bf16.pt",
                                  dtype=torch.bfloat16, step=9)
    srv = PortServer(tmp_path / "serve.log", [
        "--path", str(path), "--device", "cpu", "--port", "0",
        "--serve-batch-size", "2", "--serve-buckets", "1",
        "--fault-inject", "slow-client:2@0", "--request-read-timeout", "1",
        "--reload-interval", "0.3",
        "--default-deadline-ms", "30000", "--drain-deadline", "30",
    ])
    try:
        srv.wait_ready()
        tokens = [5, 9, 17, 23, 8]
        code, body = _post(srv.base + "/v1/infer", {"tokens": tokens})
        assert (code, body) == (408, {"status": "shed", "reason": "slow-client"})
        code, body = _post(srv.base + "/v1/infer", {"tokens": tokens})
        assert code == 200, body
        code, body = _post(srv.base + "/v1/infer", {"tokens": [5] * 200})  # too long
        assert code == 400 and body["reason"] == "too-long"
        stats = _get(srv.base + "/stats")[1]
        m = _metrics(srv.base)
        assert m["unicore_tpu_serve_served_total"] == stats["served"] == 1
        assert m["unicore_tpu_serve_batches_total"] == stats["batches"]
        assert m['unicore_tpu_serve_shed_total{reason="too-long"}'] == stats["shed"]["too-long"]
        assert m["unicore_tpu_serve_ready"] == 1.0
        assert m["unicore_tpu_serve_reloads_applied_total"] == 0
        req = urllib.request.Request(srv.base + "/v1/reload", data=b"{}", method="POST")
        try:
            urllib.request.urlopen(req, timeout=10)
            raise AssertionError("/v1/reload answered without a reloader")
        except urllib.error.HTTPError as err:
            assert err.code == 404

        _publish(cand, path)
        _wait_log(srv, "RELOAD SWAPPED")
        code, body = _post(srv.base + "/v1/infer", {"tokens": tokens})
        assert code == 200, body
        assert _get(srv.base + "/stats")[1]["reloads_applied"] == 1
        args = Namespace(path=str(cand), data=None, serve_quantize="off")
        bf16 = serve_cli.load_serving_model(args, torch.device("cpu"))[0]
        arr = np.full((2, 128), PAD, np.int32)
        arr[0, :len(tokens)] = tokens
        ids, score = build_infer_fn("cpu")(bf16, arr)
        assert body["output"] == ids[0, :len(tokens)].tolist()
        assert abs(body["score"] - float(score[0])) <= 1e-3
        assert "checkpoint weights in float32: served in float32" in srv.log()

        srv.proc.send_signal(signal.SIGTERM)
        assert srv.proc.wait(timeout=60) == 0, srv.log()[-4000:]
    finally:
        srv.close()
    events = _journal(path)
    kinds = [(e["kind"], e.get("outcome") or e.get("reason") or e.get("role"))
             for e in events]
    assert kinds[0] == ("run-start", "serve")
    for want in [("serve-shed", "slow-client"), ("serve-shed", "too-long"),
                 ("serve-reload", "swapped"), ("serve-reload", "swapped-in"),
                 ("serve-drain", "complete")]:
        assert want in kinds, (want, kinds)
    assert len({e["run_id"] for e in events}) == 1


def test_corrupt_reload_rolls_back_the_decode_server_and_republish_swaps(tmp_path):
    path, _, _ = write_lm_checkpoint(tmp_path)
    _, other = random_jax_lm(seed=1)
    cand = tmp_path / "cand.pt"
    state = checkpoint_utils.load_checkpoint_to_cpu(str(path))
    checkpoint_utils.write_checkpoint(str(cand), state["args"],
                                      checkpoint_utils.from_jax_params(other),
                                      optimizer_history=[{"num_updates": 4}])
    srv = PortServer(tmp_path / "serve.log", [
        "--path", str(path), "--device", "cpu", "--port", "0",
        "--serve-batch-size", "2", "--decode-batch-size", "2", "--serve-buckets", "2",
        "--cache-page-size", "32", "--cache-pages", "16", "--max-new-tokens", "4",
        "--fault-inject", "corrupt-reload@0", "--reload-interval", "0.3",
        "--decode-sample-every", "1",
        "--default-deadline-ms", "30000", "--drain-deadline", "30",
    ])
    try:
        srv.wait_ready()
        prompt = {"tokens": [5, 6, 7, 8], "max_new_tokens": 4}
        code, first = _post(srv.base + "/v1/generate", prompt)
        assert code == 200 and len(first["output"]) == 4, first
        _publish(cand, path)
        _wait_log(srv, "RELOAD ROLLBACK (rejected:verify)")
        code, again = _post(srv.base + "/v1/generate", prompt)
        assert code == 200 and again["output"] == first["output"]  # the old model
        _publish(cand, path)  # re-published intact
        _wait_log(srv, "RELOAD SWAPPED")
        code, body = _post(srv.base + "/v1/generate", prompt)
        assert code == 200 and len(body["output"]) == 4
        m = _metrics(srv.base)
        for name in ("tokens_generated_total", "tokens_per_second", "cache_page_occupancy",
                     "cache_pages_free", "active_sequences", "decode_steps_total",
                     "prefill_batches_total", "preempted_total", "requeued_total"):
            assert f"unicore_tpu_serve_{name}" in m, name
        assert m["unicore_tpu_serve_reloads_applied_total"] == 1
        srv.proc.send_signal(signal.SIGTERM)
        assert srv.proc.wait(timeout=60) == 0, srv.log()[-4000:]
    finally:
        srv.close()
    # the chaos flip rewrites the published file: the watcher may see the
    # rotten file's new signature once more before the re-publish
    outcomes = [e.get("outcome") for e in _journal(path) if e["kind"] == "serve-reload"]
    assert outcomes[-2:] == ["swapped", "swapped-in"], outcomes
    assert outcomes[:-2] and set(outcomes[:-2]) == {"rejected:verify"}, outcomes
    assert any(e["kind"] == "decode-step" for e in _journal(path))


def test_request_flood_sheds_with_named_reasons_and_keeps_deadlines():
    """The CLI's flood generator against an engine that serves a batch of 2
    every 20 ms behind a queue of 4: 200 offered a second for ~1 s."""
    def infer(model, arr):
        time.sleep(0.02)
        return np.asarray(arr).copy(), np.ones(arr.shape[0], np.float32)

    eng = ServeEngine(torch.nn.Linear(1, 1), infer, bucket_edges=(16, 32), batch_size=2,
                      pad_idx=1, admission_capacity=4)
    eng.warmup()
    eng.start()
    chaos.configure(Namespace(fault_inject="request-flood:200@0"))
    stop = threading.Event()
    args = Namespace(default_deadline_ms=300.0)
    seen = []
    orig = eng.submit

    def submit(*a, **kw):
        seen.append(orig(*a, **kw))
        return seen[-1]

    eng.submit = submit
    try:
        t = serve_cli._start_flood_generator(args, eng, stop)
        time.sleep(1.0)
        stop.set()
        t.join(timeout=5)
        deadline = time.monotonic() + 5
        while not all(r.done() for r in seen) and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        eng.stop()
        chaos.reset()
    assert len(seen) > 50 and all(r.done() for r in seen)
    shed = {r.response.reason for r in seen if r.response.status == rq.STATUS_SHED}
    ok = [r for r in seen if r.response.status == rq.STATUS_OK]
    assert shed and shed <= {rq.SHED_QUEUE_FULL, rq.SHED_DEADLINE_UNMEETABLE}
    assert ok and all(r.response.latency_ms <= 300.0 for r in ok)
    assert {len(r.tokens) for r in seen} == {15, 31}  # every bucket
    assert sum(eng.stats()["shed"].values()) >= len(seen) - len(ok) - 2
