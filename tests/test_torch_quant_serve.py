"""End to end on the CPU: ``python -m unicore_tpu_torch.cli.serve
--serve-quantize int8|fp8`` on a port checkpoint of a tiny BERT, held
against the JAX package's quantized model on the same weights and the same
scale sidecar (the JAX calibration finds the port's sidecar, verifies its
digest and reuses its scales).

Tolerances: the served ids equal the JAX quantized model's argmax on 99% of
the positions, and each score within 5e-3 of the JAX one relative to the
logit absmax (an activation 1e-7 apart may round to the neighbouring int8
step); the calibration drift below the JAX package's bounds (int8 0.05, fp8
0.15 of the logit absmax).
"""

import json
import signal
import subprocess
import sys
import time

import numpy as np

import jax.numpy as jnp

from unicore_tpu.quant import calibrate as jcal

from test_torch_decode_serve import write_lm_checkpoint
from test_torch_serve import BATCH, PAD, VOCAB, PortServer, _env, _get, _post, write_checkpoint

REL_DRIFT_BOUND = {"int8": 0.05, "fp8": 0.15}


def _jax_quantized(jax_model, variables, path, mode, edges):
    """The JAX quantized model on ``path``'s sidecar, as the JAX server
    would load it."""
    jq = jax_model.clone(quantize=mode)
    prepared, info = jcal.calibrate_for_serving(
        jq, jax_model, variables, mode=mode, snapshot_path=str(path), vocab_size=VOCAB,
        pad_idx=PAD, bucket_edges=edges, batch_size=BATCH, persist=False)
    return jq, prepared, info


def _serve(tmp_path, path, mode, drift_sample):
    return PortServer(tmp_path / f"serve-{mode}.log", [
        "--path", str(path), "--device", "cpu", "--port", "0",
        "--serve-batch-size", str(BATCH), "--serve-buckets", "2",
        "--serve-quantize", mode, "--quant-drift-sample", str(drift_sample),
        "--default-deadline-ms", "30000", "--drain-deadline", "30",
    ])


def test_serve_int8_matches_jax_quantized_model(tmp_path):
    path, jax_model, variables = write_checkpoint(tmp_path)
    srv = _serve(tmp_path, path, "int8", 1)
    try:
        srv.wait_ready()
        log = srv.log()
        line = next(ln for ln in log.splitlines() if "QUANT-PATH int8" in ln)
        assert "scales calibrated for 9 site(s)" in line, line
        sidecar = jcal.scales_path(str(path))
        assert f"scales at {sidecar}" in line
        with open(sidecar) as f:
            doc = json.load(f)
        assert doc["mode"] == "int8" and len(doc["sites"]) == 9

        jq, prepared, info = _jax_quantized(jax_model, variables, path, "int8", [64, 128])
        assert info["source"] == "reused-verified"  # the port's sidecar, verified
        rng = np.random.default_rng(0)
        reqs = [rng.integers(4, VOCAB, size=n).tolist() for n in (5, 40, 64, 65, 100, 128)]
        agree = total = 0
        for toks in reqs:
            code, body = _post(srv.base + "/v1/infer", {"tokens": toks})
            assert code == 200 and len(body["output"]) == len(toks), body
            arr = np.full((BATCH, body["bucket"]), PAD, np.int32)
            arr[0, : len(toks)] = toks
            logits = np.asarray(jq.apply(prepared, jnp.asarray(arr), train=False))
            ids = logits[0].argmax(-1)[: len(toks)]
            score = float(logits[0].max(-1).mean())
            agree += int((np.asarray(body["output"]) == ids).sum())
            total += len(toks)
            assert abs(body["score"] - score) <= 5e-3 * np.abs(logits).max()
        assert agree >= 0.99 * total, (agree, total)

        # a batch's drift sample follows its responses: wait for the last one
        deadline = time.monotonic() + 30
        while True:
            code, st = _get(srv.base + "/stats")
            if st["quant"]["request_drift"]["samples"] >= len(reqs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        assert code == 200 and st["precision"] == "int8"
        q = st["quant"]
        assert q["mode"] == "int8" and q["source"] == "calibrated" and q["sites"] == 9
        assert q["rel_drift"] < REL_DRIFT_BOUND["int8"], q
        assert "weights_digest" not in q and q["scales_path"] == sidecar
        drift = q["request_drift"]
        assert drift["samples"] == len(reqs)  # one request a batch, every batch sampled
        assert 0.0 <= drift["last_abs"] <= drift["max_abs"] and drift["mean_abs"] >= 0.0
        assert sum(st["kernel_launches"].values()) == 0  # CPU: plain versions
        assert sum(st["probe_kernel_launches"].values()) == 0

        srv.proc.send_signal(signal.SIGTERM)
        assert srv.proc.wait(timeout=60) == 0, srv.log()[-4000:]
        assert "DRAIN complete" in srv.log()
    finally:
        srv.close()


def test_serve_fp8_reuses_nothing_and_stays_in_bound(tmp_path):
    """fp8 on the same checkpoint: its own scales (an int8 sidecar is not
    reused across modes), the drift in the fp8 bound, no drift probe when
    ``--quant-drift-sample 0``."""
    path, jax_model, variables = write_checkpoint(tmp_path)
    sidecar = jcal.scales_path(str(path))
    with open(sidecar, "w") as f:
        json.dump({"version": 1, "mode": "int8", "weights_digest": "x", "sites": {}}, f)
    srv = _serve(tmp_path, path, "fp8", 0)
    try:
        srv.wait_ready()
        assert "QUANT-PATH fp8: scales calibrated for 9 site(s)" in srv.log()
        code, body = _post(srv.base + "/v1/infer", {"tokens": [5, 6, 7, 8]})
        assert code == 200 and len(body["output"]) == 4, body
        code, st = _get(srv.base + "/stats")
        assert st["precision"] == "fp8" and st["quant"]["rel_drift"] < REL_DRIFT_BOUND["fp8"]
        assert st["quant"]["request_drift"]["samples"] == 0
        with open(sidecar) as f:
            assert json.load(f)["mode"] == "fp8"
        _, _, info = _jax_quantized(jax_model, variables, path, "fp8", [64, 128])
        assert info["source"] == "reused-verified"
        srv.proc.send_signal(signal.SIGTERM)
        assert srv.proc.wait(timeout=60) == 0, srv.log()[-4000:]
    finally:
        srv.close()


def test_serve_quantize_refused_on_a_decode_checkpoint(tmp_path):
    """``--serve-quantize`` on a ``transformer_lm`` checkpoint is a model-load
    failure (exit 76) with the JAX server's message."""
    path, _, _ = write_lm_checkpoint(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "unicore_tpu_torch.cli.serve", "--path", str(path),
         "--device", "cpu", "--port", "0", "--serve-quantize", "int8"],
        capture_output=True, text=True, timeout=120, env=_env(),
    )
    assert proc.returncode == 76, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "--serve-quantize is the encoder-path weight quantization" in proc.stdout
    assert "--decode-kv int8" in proc.stdout
