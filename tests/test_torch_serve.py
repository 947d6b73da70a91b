"""End to end on the CPU: ``python -m unicore_tpu_torch.cli.serve`` serving a
port checkpoint of a tiny BERT over HTTP, held against the JAX package's
``build_infer_fn`` (unicore_tpu/serve/engine.py) on the same padded batch.

Tolerances: ids exact wherever the top-2 logit gap exceeds 1e-3 (closer
ties may flip under fp32 summation-order differences); score 1e-4
absolute (a mean of fp32 max-logits of magnitude ~1).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from argparse import Namespace

import numpy as np

import jax
import jax.numpy as jnp

from unicore_tpu.serve.engine import build_infer_fn as jax_build_infer_fn

from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.models.bert import bert_tiny_architecture

from test_torch_bert import PAD, VOCAB, random_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4
GAP = 1e-3
SCORE_ATOL = 1e-4


def write_checkpoint(root):
    """dict.txt (the task adds [MASK] as the last id) + a port checkpoint
    of a tiny post-LN BERT whose weights come from a numpy seed."""
    data = root / "data"
    data.mkdir()
    words = ["[CLS]", "[PAD]", "[SEP]", "[UNK]"] + [
        f"w{i}" for i in range(VOCAB - 5)
    ]
    (data / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    jax_model, variables = random_jax_variables(post_ln=True)
    args = Namespace(task="bert", arch="bert_tiny", data=str(data), seed=1)
    bert_tiny_architecture(args)
    path = root / "checkpoint.pt"
    checkpoint_utils.write_checkpoint(
        str(path), args, checkpoint_utils.from_jax_params(variables)
    )
    return path, jax_model, variables


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _post(url, payload, timeout=30.0):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _get(url, timeout=5.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


class PortServer:
    def __init__(self, log_path, argv, **env):
        self.log_path = log_path
        self._log = open(log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "unicore_tpu_torch.cli.serve", *argv],
            stdout=self._log, stderr=subprocess.STDOUT, cwd=REPO,
            env=_env(**env),
        )
        self.base = None

    def log(self):
        with open(self.log_path) as f:
            return f.read()

    def wait_ready(self, budget=120.0):
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            assert self.proc.poll() is None, f"serve died:\n{self.log()[-4000:]}"
            if self.base is None:
                for line in self.log().splitlines():
                    if "SERVE listening" in line:
                        addr = line.split("http://", 1)[1].split()[0]
                        self.base = "http://" + addr
            if self.base is not None:
                try:
                    if _get(self.base + "/readyz")[0] == 200:
                        return
                except OSError:
                    pass
            time.sleep(0.2)
        raise AssertionError(f"server never ready:\n{self.log()[-4000:]}")

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)
        self._log.close()


def _jax_reference(jax_model, variables, tokens, bucket):
    """JAX ids/score/logits for ``tokens`` padded into a batch of dummy
    rows at ``bucket``, exactly as the engine pads."""
    arr = np.full((BATCH, bucket), PAD, np.int32)
    arr[0, : len(tokens)] = tokens
    infer, _ = jax_build_infer_fn(jax_model)
    ids, score = infer(variables, jnp.asarray(arr))
    logits = np.asarray(jax_model.apply(variables, jnp.asarray(arr), train=False))
    return np.asarray(ids)[0], float(np.asarray(score)[0]), logits[0]


def test_serve_matches_jax_engine(tmp_path):
    path, jax_model, variables = write_checkpoint(tmp_path)
    srv = PortServer(tmp_path / "serve.log", [
        "--path", str(path), "--device", "cpu", "--port", "0",
        "--serve-batch-size", str(BATCH), "--serve-buckets", "2",
        "--default-deadline-ms", "30000", "--drain-deadline", "30",
    ])
    try:
        srv.wait_ready()
        rng = np.random.default_rng(0)
        lengths = [5, 40, 64, 65, 100, 128]
        reqs = [rng.integers(4, VOCAB, size=n).tolist() for n in lengths]
        results = [None] * len(reqs)

        def send(i):
            results[i] = _post(srv.base + "/v1/infer", {"tokens": reqs[i]})

        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()

        for toks, (code, body) in zip(reqs, results):
            assert code == 200, body
            assert body["bucket"] == (64 if len(toks) <= 64 else 128)
            assert len(body["output"]) == len(toks)
            ids, score, logits = _jax_reference(
                jax_model, variables, toks, body["bucket"]
            )
            top2 = np.sort(logits[: len(toks)], axis=-1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0]) > GAP
            got = np.asarray(body["output"])
            np.testing.assert_array_equal(got[clear], ids[: len(toks)][clear])
            assert abs(body["score"] - score) <= SCORE_ATOL, (body["score"], score)

        # an over-long request sheds with the JAX package's named reason
        code, body = _post(srv.base + "/v1/infer", {"tokens": [5] * 129})
        assert (code, body["status"], body["reason"]) == (400, "shed", "too-long")
        # out-of-vocabulary ids are refused before they reach the model
        code, body = _post(srv.base + "/v1/infer", {"tokens": [5, VOCAB]})
        assert code == 400 and f"[0, {VOCAB})" in body["reason"], body
        # an encoder engine does not generate: 404, as the JAX server answers
        code, body = _post(srv.base + "/v1/generate", {"tokens": [5, 6]})
        assert code == 404 and "does not generate" in body["error"], body
        code, stats = _get(srv.base + "/stats")
        assert code == 200 and stats["served"] == len(reqs)
        assert stats["device"] == "cpu"
        assert sum(stats["kernel_launches"].values()) == 0  # CPU: plain only

        srv.proc.send_signal(signal.SIGTERM)
        assert srv.proc.wait(timeout=60) == 0, srv.log()[-4000:]
        assert "DRAIN complete" in srv.log()
    finally:
        srv.close()


def test_cuda_default_refuses_without_a_card(tmp_path):
    """Without --device cpu the server wants a CUDA card and, finding none,
    exits non-zero naming it — it never carries on on the CPU."""
    path, _, _ = write_checkpoint(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "unicore_tpu_torch.cli.serve",
         "--path", str(path), "--port", "0"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=_env(CUDA_VISIBLE_DEVICES=""),
    )
    out = proc.stdout + proc.stderr
    assert proc.returncode == 76, out[-4000:]
    assert "no CUDA card" in out
    assert "SERVE listening" not in out


def test_jax_reference_is_cpu():
    assert jax.default_backend() == "cpu"
