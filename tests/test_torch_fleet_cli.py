"""The port's serving fleet end to end on the CPU: two replicas (``python -m
unicore_tpu_torch.cli.serve --device cpu --advertise auto``) of a tiny
BERT checkpoint made with ``from_jax_params``, behind ``python -m
unicore_tpu_torch.cli.router``, sharing one fleet KV directory and one
journal directory:

* each replica registers before it is ready; the router sees 2 routable;
* answers through the router are the JAX model's forward on the same
  weights (``tests/test_torch_serve.py``'s tolerances); both replicas
  serve; ``/metrics`` equals ``/stats``;
* a candidate published onto the watched path rolls across both replicas
  with requests in flight, all answered 200 (both leases' digests move
  together) and the answers follow it; a
  corrupt candidate halts the roll after ONE rollback, the other replica
  never asked, the digests unchanged;
* ``replica-loss@K@1`` kills replica 1 (exit 74): the router names the
  REPLICA-LOSS verdict, every request is answered 200 or with a named
  reason, and every request after the verdict is 200;
* SIGTERM on replica 0: ``FLEET DEREGISTERED`` in both logs, then the
  router sheds 503 ``no-ready-replica`` with ``Retry-After``; SIGTERM on
  the router exits 0;
* the JAX package's trace merger summarises the fleet's journal: replica
  r1's loss noticed by the router, the halted roll.

And the start-up failures: exit 75 for a router whose port is taken, 78 for
an unusable ``--fleet-kv`` (router and replica, as the JAX router answers)
and for an ``--advertise`` address without a port.

Tolerances: ids exact wherever the JAX top-2 logit gap exceeds 1e-3, score
1e-4 absolute (``tests/test_torch_serve.py``).
"""

import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from unicore_tpu import options as jax_options
from unicore_tpu import telemetry as jax_telemetry
from unicore_tpu.telemetry import trace as jax_trace
from unicore_tpu_cli import router as jax_router_cli

from test_torch_bert import VOCAB, random_jax_variables
from test_torch_serve import BATCH, GAP, REPO, SCORE_ATOL, _env, _get, _jax_reference, _post
from test_torch_serve_control import _write_bert_checkpoint


class Proc:
    """One CLI subprocess with its log."""

    def __init__(self, log_path, module, argv):
        self.log_path = log_path
        self._log = open(log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", f"unicore_tpu_torch.cli.{module}", *argv],
            stdout=self._log, stderr=subprocess.STDOUT, cwd=REPO, env=_env(),
        )
        self.base = None

    def log(self):
        with open(self.log_path) as f:
            return f.read()

    def wait_log(self, text, budget=60.0, alive=True):
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            if text in self.log():
                return
            if alive:
                assert self.proc.poll() is None, self.log()[-4000:]
            time.sleep(0.1)
        raise AssertionError(f"{text!r} never logged:\n{self.log()[-4000:]}")

    def wait_listening(self, marker, budget=60.0):
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            for line in self.log().splitlines():
                if marker in line:
                    self.base = "http://" + line.split("http://", 1)[1].split()[0]
                    return self.base
            assert self.proc.poll() is None, self.log()[-4000:]
            time.sleep(0.1)
        raise AssertionError(f"never listened:\n{self.log()[-4000:]}")

    def stop(self, budget=60.0):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=budget)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(timeout=10)
            self._log.close()


def _publish(src, dst, corrupt=False):
    """copy + os.replace onto ``dst``; ``corrupt`` flips one payload byte."""
    staged = str(dst) + ".staged"
    shutil.copy(src, staged)
    if corrupt:
        size = os.path.getsize(staged)
        with open(staged, "r+b") as f:
            f.seek(int(size * 0.6))
            byte = f.read(1)
            f.seek(int(size * 0.6))
            f.write(bytes([byte[0] ^ 0xFF]))
    os.replace(staged, dst)


def _digests(router):
    return {n: r["digest"] for n, r in _get(router.base + "/stats")[1]["fleet"]["replicas"].items()}


def _check_against_jax(jax_model, variables, toks, body):
    assert len(body["output"]) == len(toks)
    ids, score, logits = _jax_reference(jax_model, variables, toks, body["bucket"])
    top2 = np.sort(logits[: len(toks)], axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > GAP
    np.testing.assert_array_equal(np.asarray(body["output"])[clear], ids[: len(toks)][clear])
    assert abs(body["score"] - score) <= SCORE_ATOL, (body["score"], score)


def _metrics(base):
    with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
        text = r.read().decode()
    return dict(line.rsplit(" ", 1) for line in text.splitlines()
                if line and not line.startswith("#"))


def test_fleet_routes_rolls_survives_a_loss_and_deregisters(tmp_path):
    jax_model, variables = random_jax_variables(post_ln=True)
    _, moved = random_jax_variables(post_ln=True, seed=1)
    live = tmp_path / "fleet" / "checkpoint.pt"
    live.parent.mkdir()
    src = _write_bert_checkpoint(tmp_path, variables)
    cand = _write_bert_checkpoint(tmp_path, moved, name="moved.pt", step=9)
    shutil.copy(src, live)
    kv, tele = tmp_path / "fleetkv", tmp_path / "telemetry"
    common = ["--path", str(live), "--device", "cpu", "--port", "0",
              "--serve-batch-size", str(BATCH), "--serve-buckets", "2",
              "--default-deadline-ms", "30000", "--drain-deadline", "30",
              "--advertise", "auto", "--fleet-kv", str(kv), "--fleet-interval", "0.5",
              "--telemetry-dir", str(tele)]
    # replica 1's loss must land in the loss section below, not earlier: the
    # roll's in-flight requests alone took it past 28 batches on a loaded
    # CPU, and a replica that dies with a request's body read answers a
    # named 502 (upstream-incomplete), never a 200
    loss_batch = 120
    reps = [Proc(tmp_path / "r0.log", "serve", common + ["--replica-index", "0"]),
            Proc(tmp_path / "r1.log", "serve", common + [
                "--replica-index", "1", "--fault-inject", f"replica-loss@{loss_batch}@1"])]
    router = Proc(tmp_path / "router.log", "router", [
        "--fleet-kv", str(kv), "--port", "0", "--fleet-interval", "0.5",
        "--fleet-timeout", "3", "--default-deadline-ms", "30000",
        "--path", str(live), "--reload-interval", "0.5", "--reload-timeout", "60",
        "--telemetry-dir", str(tele)])
    router_rc = None
    try:
        router.wait_listening("ROUTER listening")
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            code, body = _get(router.base + "/readyz")
            if code == 200 and body["routable"] == 2:
                break
            for r in reps:
                assert r.proc.poll() is None, r.log()[-4000:]
            time.sleep(0.2)
        assert _get(router.base + "/readyz") == (200, {"ready": True, "routable": 2})
        for r in reps:  # registered first, ready after the warm-up
            log = r.log()
            assert log.index("FLEET REGISTERED") < log.index("readiness -> true")

        # route: one at a time, then concurrently; the JAX forward's answers
        rng = np.random.default_rng(0)
        reqs = [rng.integers(4, VOCAB, size=n).tolist()
                for n in (5, 40, 64, 65, 100, 128, 7, 33, 90, 120, 12, 60)]
        results = [_post(router.base + "/v1/infer", {"tokens": t}) for t in reqs[:6]]
        out = [None] * 6

        def send(i):
            out[i] = _post(router.base + "/v1/infer", {"tokens": reqs[6 + i]})

        threads = [threading.Thread(target=send, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for toks, (code, body) in zip(reqs, results + out):
            assert code == 200, body
            _check_against_jax(jax_model, variables, toks, body)
        stats = _get(router.base + "/stats")[1]
        assert stats["ok"] == 12 and set(stats["by_replica"]) == {"r0", "r1"}, stats
        m = _metrics(router.base)
        assert float(m["unicore_tpu_router_ok_total"]) == stats["ok"]
        assert float(m["unicore_tpu_router_replicas_routable"]) == 2
        for name, n in stats["by_replica"].items():
            assert float(m[f'unicore_tpu_router_replica_proxied_total{{replica="{name}"}}']) == n
        before = _digests(router)
        assert len(set(before.values())) == 1

        # roll a good candidate with requests in flight, then a corrupt one
        in_flight, stop_sending = [], threading.Event()

        def keep_sending():
            # each answer's code and the router's named reason
            while not stop_sending.is_set():
                code, body = _post(router.base + "/v1/infer", {"tokens": reqs[0]})
                in_flight.append((code, body.get("reason"), body.get("detail")))
                stop_sending.wait(0.05)

        sender = threading.Thread(target=keep_sending)
        sender.start()
        try:
            _publish(cand, live)
            router.wait_log("ROLLING RELOAD COMPLETE: 2/2")
        finally:
            stop_sending.set()
            sender.join(timeout=60)
        assert in_flight and {c for c, _, _ in in_flight} == {200}, (
            [a for a in in_flight if a[0] != 200], router.log()[-3000:],
            [r.log()[-3000:] for r in reps])
        deadline = time.monotonic() + 10
        while not set(_digests(router).values()).isdisjoint(before.values()):
            assert time.monotonic() < deadline, _digests(router)
            time.sleep(0.2)
        after = _digests(router)
        assert len(set(after.values())) == 1
        toks = reqs[1]
        code, body = _post(router.base + "/v1/infer", {"tokens": toks})
        assert code == 200, (body, router.log()[-3000:], [r.log()[-3000:] for r in reps])
        _check_against_jax(jax_model, moved, toks, body)
        _publish(cand, live, corrupt=True)
        router.wait_log("ROLLING RELOAD HALT")
        rolled_back = [i for i, r in enumerate(reps) if "RELOAD ROLLBACK" in r.log()]
        assert rolled_back == [0], rolled_back  # r1 never asked
        assert "1 remaining replica(s) were never asked" in router.log()
        time.sleep(1.0)
        assert _digests(router) == after

        # lose replica 1: traffic until it exits 74
        answers = []
        verdict_at = [None]

        def drive():
            while reps[1].proc.poll() is None or verdict_at[0] is None or \
                    time.monotonic() < verdict_at[0] + 1.0:
                t0 = time.monotonic()
                code, body = _post(router.base + "/v1/infer", {"tokens": [5, 6, 7]})
                answers.append((t0, code, body.get("reason")))
                if "FLEET REPLICA-LOSS" in router.log() and verdict_at[0] is None:
                    verdict_at[0] = time.monotonic()
                if t0 > deadline:
                    return

        deadline = time.monotonic() + 90
        pool = [threading.Thread(target=drive) for _ in range(3)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
            assert not t.is_alive()
        assert reps[1].proc.wait(timeout=30) == 74, reps[1].log()[-3000:]
        assert "REPLICA LOSS" in reps[1].log() and "DRAIN" not in reps[1].log()
        router.wait_log("FLEET REPLICA-LOSS: replica r1")
        assert verdict_at[0] is not None
        for t0, code, reason in answers:  # 200 or a named outcome
            assert code == 200 or reason, (code, reason)
        assert all(code == 200 for t0, code, _ in answers if t0 > verdict_at[0])
        stats = _get(router.base + "/stats")[1]
        assert stats["fleet"]["routable"] == 1 and stats["fleet"]["lost"] == ["r1"]

        # a clean stop deregisters; then the router sheds
        assert reps[0].stop() == 0, reps[0].log()[-3000:]
        assert "FLEET DEREGISTERED: replica r0" in reps[0].log()
        router.wait_log("FLEET DEREGISTERED: replica r0")
        req = urllib.request.Request(router.base + "/v1/infer", method="POST",
                                     data=b'{"tokens": [5, 6]}')
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=10)
        assert err.value.code == 503 and err.value.headers["Retry-After"] == "1"
        assert b"no-ready-replica" in err.value.read()
        router_rc = router.stop()
    finally:
        for p in reps + [router]:
            p.stop(budget=30)
    assert router_rc == 0, router.log()[-3000:]

    # the JAX package's merger reads the port fleet's journal: one file per
    # replica index plus the router's
    paths = jax_trace.find_journals(str(tele))
    assert sorted(os.path.basename(p) for p in paths) == [
        "events_rank0_router.jsonl", "events_rank0_serve.jsonl", "events_rank1_serve.jsonl"]
    records = [rec for p in paths for rec in jax_trace.load_journal(p)]
    summary = "\n".join(jax_trace.summarize(jax_trace.merge(records)))
    assert "replica r1 REPLICA-LOSS noticed by the router" in summary, summary
    assert "ROLLING RELOAD HALTED" in summary and "1 replica(s) never asked" in summary


def _taken_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    s.listen(1)
    return s


@pytest.mark.parametrize("case", ["router-bind", "router-fleet-kv", "serve-fleet-kv",
                                  "serve-advertise"])
def test_start_up_failures_exit_as_jax(tmp_path, case):
    afile = tmp_path / "afile"
    afile.write_text("x")
    held = _taken_port()
    try:
        port = str(held.getsockname()[1])
        if case.startswith("router"):
            argv = (["--fleet-kv", str(tmp_path / "kv"), "--port", port]
                    if case == "router-bind" else ["--fleet-kv", str(afile), "--port", "0"])
            want = 75 if case == "router-bind" else 78
            # the JAX router's answer, in process (its main returns the code)
            args = jax_options.get_router_parser().parse_args(argv)
            try:
                assert jax_router_cli.main(args) == want
            finally:
                jax_telemetry.reset()
            runs = [[sys.executable, "-m", "unicore_tpu_torch.cli.router", *argv]]
        else:
            path = _write_bert_checkpoint(tmp_path)
            argv = ["--path", str(path), "--device", "cpu", "--port", "0",
                    "--serve-buckets", "1", "--advertise",
                    "auto" if case == "serve-fleet-kv" else "http://127.0.0.1",
                    "--fleet-kv", str(afile if case == "serve-fleet-kv" else tmp_path / "kv")]
            want = 78
            runs = [[sys.executable, "-m", "unicore_tpu_torch.cli.serve", *argv]]
        for cmd in runs:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120, cwd=REPO,
                                  env=_env(JAX_PLATFORMS="cpu"))
            assert proc.returncode == want, (cmd[:3], proc.stdout[-3000:], proc.stderr[-3000:])
        if not case.startswith("router"):
            assert "fleet-kv-failure" in proc.stdout and "SERVE listening" in proc.stdout
            assert "FLEET REGISTERED" not in proc.stdout
    finally:
        held.close()
