"""End to end on the CPU: ``python -m unicore_tpu_torch.cli.serve`` serving a
port checkpoint of a tiny ``transformer_lm`` through its incremental-decode
engine over HTTP (``POST /v1/generate``), the generated tokens held against
a greedy rollout of the JAX package's model on the same weights.

Tolerance: tokens equal, or, where they differ, the JAX logits' top-2 gap
below 1e-5 at the first difference (fp32 summation order may break a near
tie the other way).
"""

import signal
import subprocess
import sys
from argparse import Namespace

import numpy as np

import jax

from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.models.transformer_lm import transformer_lm_tiny_architecture

from test_torch_decode import EOS, PAD, TINY, VOCAB, random_jax_lm
from test_torch_serve import REPO, PortServer, _env, _get, _post, write_checkpoint

MAX_NEW = 6
TOP = 128  # the top cache bucket at max_seq_len 128


def write_lm_checkpoint(root):
    """dict.txt (BERT specials, so [PAD] is 1 and [SEP], the EOS, is 2) and
    a port checkpoint of a tiny ``transformer_lm`` from a numpy seed."""
    data = root / "data"
    data.mkdir()
    words = ["[CLS]", "[PAD]", "[SEP]", "[UNK]"] + [f"w{i}" for i in range(VOCAB - 4)]
    (data / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    jax_model, variables = random_jax_lm()
    args = Namespace(task="causal_lm", arch="transformer_lm_tiny", data=str(data),
                     seed=1, decoder_embed_dim=TINY["decoder_embed_dim"],
                     decoder_ffn_embed_dim=TINY["decoder_ffn_embed_dim"])
    transformer_lm_tiny_architecture(args)
    path = root / "lm.pt"
    checkpoint_utils.write_checkpoint(str(path), args,
                                     checkpoint_utils.from_jax_params(variables))
    return path, jax_model, variables


_PREFILL = {}


def _jit_prefill(jax_model):
    if jax_model not in _PREFILL:
        _PREFILL[jax_model] = jax.jit(
            lambda v, t: jax_model.apply(v, t, method="prefill")[0])
    return _PREFILL[jax_model]


def _check_rollout(jax_model, variables, prompt, got, max_new):
    """``got`` against a greedy rollout of the JAX model with the engine's
    stop rules (EOS appended when chosen; at most ``max_new`` tokens).  The
    prefill runs at one padded length: it is causal and takes no padding
    mask, so right padding leaves every real row's logits as they are."""
    prefill = _jit_prefill(jax_model)
    toks, want = list(prompt), []
    while True:
        padded = np.full((1, TOP), PAD, np.int32)
        padded[0, : len(toks)] = toks
        row = np.asarray(prefill(variables, padded))[0, len(toks) - 1]
        nxt = int(np.argmax(row))
        i = len(want)
        if i < len(got) and got[i] != nxt:
            top2 = np.sort(row)[-2:]
            assert top2[1] - top2[0] < 1e-5, (prompt, got, want + [nxt])
            return
        want.append(nxt)
        if nxt == EOS or len(want) >= max_new or len(toks) + 2 > TOP:
            break
        toks.append(nxt)
    assert got == want, (prompt, got, want)


def _jax_max_new(value):
    """The JAX server's ``max_new_tokens`` rule: ``int(value)``, then > 0;
    None where it answers 400."""
    try:
        n = int(value)
    except (TypeError, ValueError):
        return None
    return n if n > 0 else None


def test_serve_generate_matches_jax_rollout(tmp_path):
    path, jax_model, variables = write_lm_checkpoint(tmp_path)
    srv = PortServer(tmp_path / "serve.log", [
        "--path", str(path), "--device", "cpu", "--port", "0",
        "--serve-batch-size", "2", "--decode-batch-size", "2", "--serve-buckets", "2",
        "--cache-pages", "16", "--max-new-tokens", str(MAX_NEW),
        "--default-deadline-ms", "30000", "--drain-deadline", "30",
    ])
    try:
        srv.wait_ready()
        rng = np.random.default_rng(0)
        prompts = [rng.integers(4, VOCAB, size=n).tolist() for n in (3, 40, 70)]
        for p in prompts:
            code, body = _post(srv.base + "/v1/generate", {"tokens": p})
            assert code == 200 and body["status"] == "ok", body
            assert 1 <= len(body["output"]) <= MAX_NEW and np.isfinite(body["score"])
            assert body["bucket"] == (64 if len(p) + len(body["output"]) <= 64 else 128)
            _check_rollout(jax_model, variables, p, body["output"], MAX_NEW)
        # a client budget below the engine's ceiling, and /v1/infer on a
        # decode engine, which generates with the default budget
        code, body = _post(srv.base + "/v1/generate",
                           {"tokens": prompts[0], "max_new_tokens": 2})
        assert code == 200 and len(body["output"]) <= 2, body
        _check_rollout(jax_model, variables, prompts[0], body["output"], 2)
        code, body = _post(srv.base + "/v1/infer", {"tokens": prompts[1]})
        assert code == 200, body
        _check_rollout(jax_model, variables, prompts[1], body["output"], MAX_NEW)
        # max_new_tokens as the JAX server takes it: whatever int() takes,
        # then positive (unicore_tpu/serve/http.py:291-303)
        for value in ("16", 2.5, True, "x", 0, -3, [1]):
            code, body = _post(srv.base + "/v1/generate",
                               {"tokens": prompts[0], "max_new_tokens": value})
            want = _jax_max_new(value)
            if want is None:
                assert code == 400 and "max_new_tokens" in body["reason"], (value, body)
                continue
            assert code == 200 and 1 <= len(body["output"]) <= min(want, MAX_NEW), (value, body)
            _check_rollout(jax_model, variables, prompts[0], body["output"],
                           min(want, MAX_NEW))
        code, body = _post(srv.base + "/v1/generate", {"tokens": [5] * (TOP + 1)})
        assert (code, body["reason"]) == (400, "too-long")

        code, st = _get(srv.base + "/stats")
        assert code == 200 and st["mode"] == "decode" and st["kv_dtype"] == "float32"
        assert st["served"] == len(prompts) + 5 and st["buckets"] == [64, TOP]
        assert st["decode_steps"] > 0 and st["prefill_batches"] >= len(prompts) + 5
        assert st["tokens_generated"] > 0 and st["tokens_per_s"] > 0
        assert st["token_p50_ms"] > 0 and st["token_p99_ms"] >= st["token_p50_ms"]
        assert st["cache_page_occupancy"] == 0.0 and st["active_sequences"] == 0
        assert st["preempted"] == 0 and st["device"] == "cpu"
        assert sum(st["kernel_launches"].values()) == 0  # CPU: plain versions

        srv.proc.send_signal(signal.SIGTERM)
        assert srv.proc.wait(timeout=60) == 0, srv.log()[-4000:]
        log = srv.log()
        assert "serving INCREMENTAL DECODE" in log and "DRAIN complete" in log
    finally:
        srv.close()


def test_serve_decode_on_refuses_an_encoder_checkpoint(tmp_path):
    """``--serve-decode on`` with a model that has no decode surface is a
    model-load failure (exit 76), as in the JAX server."""
    bert, _, _ = write_checkpoint(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "unicore_tpu_torch.cli.serve", "--path", str(bert),
         "--device", "cpu", "--port", "0", "--serve-decode", "on"],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=_env(),
    )
    out = proc.stdout + proc.stderr
    assert proc.returncode == 76, out[-4000:]
    assert "no prefill/decode_step surface" in out
