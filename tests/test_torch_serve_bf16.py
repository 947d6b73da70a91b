"""A bf16 checkpoint served in its own dtype, held against the JAX package
on the CPU: the JAX server applies the loaded tree as it is, so a ``--bf16``
run's weights serve in bf16 there; the port's serve CLI builds its model
with the checkpoint's tensors assigned in their own types
(``cli/serve.load_serving_model``).

The weights are a JAX tiny BERT / ``transformer_lm`` tree redrawn from a
numpy seed and cast to bf16, carried to the port by ``from_jax_params``
and written as a port checkpoint.

* BERT (``/v1/infer``): the port's ``ServeEngine`` against the JAX
  ``build_infer_fn`` on the same padded batch.
* The LM (prefill plus 8 decode steps): the port's ``DecodeEngine`` greedy
  rollout, every token against the argmax of the JAX model's bf16 prefill
  over the prompt and the tokens before it (teacher-forced).  The JAX
  ``DecodeEngine`` cannot be the reference here: its decode step writes the
  bf16 K/V row into the fp32 cache view with ``lax.dynamic_update_slice``,
  which raises on the mixed dtypes (``unicore_tpu/modules/
  multihead_attention.py`` ``_decode``); its prefill casts into the pool
  and runs.

Each pair holds: the served parameters and logits are bf16 as JAX's are;
ids equal wherever the JAX top-2 logit gap exceeds ``GAP`` = 0.0625 (four
bf16 ulps of a logit in [1, 2): both sides round every module's output to
bf16, in different places); scores within ``SCORE_REL`` = 1e-2 of JAX's
(measured: 3.4e-3 at most).  XLA on the CPU keeps a fused elementwise
chain in fp32 between its bf16 ends, so the values alone lie about as close
to an fp32 forward as to the port's bf16 one: the dtype checks are what an
fp32-served port fails.
"""

import os
from argparse import Namespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unicore_tpu.serve.engine import build_infer_fn as jax_build_infer_fn

from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.cli import serve as serve_cli
from unicore_tpu_torch.models.bert import bert_tiny_architecture
from unicore_tpu_torch.models.transformer_lm import transformer_lm_tiny_architecture
from unicore_tpu_torch.serve import DecodeEngine, ServeEngine, build_infer_fn
from unicore_tpu_torch.serve import request as rq

from test_torch_bert import PAD, VOCAB, random_jax_variables
from test_torch_decode import random_jax_lm

GAP = 0.0625
SCORE_REL = 1e-2
BATCH = 4


def _bf16(variables):
    return jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                                  variables)


def _dict(root, n_words):
    """dict.txt with BERT's specials ([PAD] 1, [SEP] 2) and ``n_words``
    words in all (the bert task adds [MASK] after them)."""
    data = root / "data"
    data.mkdir()
    words = ["[CLS]", "[PAD]", "[SEP]", "[UNK]"] + [f"w{i}" for i in range(n_words - 4)]
    (data / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    return data


def _serve_args(path, **kw):
    return Namespace(path=str(path), data=None, serve_quantize="off", **kw)


def _assert_served_in_bf16(model):
    dtypes = {p.dtype for p in model.parameters() if p.is_floating_point()}
    assert dtypes == {torch.bfloat16}, dtypes


@pytest.fixture(scope="module")
def bert(tmp_path_factory):
    root = tmp_path_factory.mktemp("bert_bf16")
    data = _dict(root, VOCAB - 1)
    jm, variables = random_jax_variables(post_ln=True)
    vb = _bf16(variables)
    args = Namespace(task="bert", arch="bert_tiny", data=str(data), seed=1)
    bert_tiny_architecture(args)
    path = root / "checkpoint.pt"
    checkpoint_utils.write_checkpoint(str(path), args, checkpoint_utils.from_jax_params(vb))
    model = serve_cli.load_serving_model(_serve_args(path), torch.device("cpu"))[0]
    return jm, vb, model


@pytest.mark.parametrize("bucket,lengths", [(64, [5, 30, 64, 40]), (128, [100, 65, 128, 90])])
def test_bf16_bert_served_in_bf16_matches_jax(bert, bucket, lengths):
    jm, vb, model = bert
    _assert_served_in_bf16(model)
    rng = np.random.default_rng(bucket)
    arr = np.full((BATCH, bucket), PAD, np.int32)
    for i, n in enumerate(lengths):
        arr[i, :n] = rng.integers(4, VOCAB, size=n)
    eng = ServeEngine(model, build_infer_fn("cpu"), bucket_edges=(64, 128),
                      batch_size=BATCH, pad_idx=PAD, vocab_size=VOCAB)
    eng.warmup()
    reqs = [eng.submit(arr[i, :n], 60.0) for i, n in enumerate(lengths)]
    while not all(r.done() for r in reqs):
        eng.step(timeout=0.01)
    jinfer, _ = jax_build_infer_fn(jm)
    jids, jscore = (np.asarray(x) for x in jinfer(vb, jnp.asarray(arr)))
    jlogits = jm.apply(vb, jnp.asarray(arr), train=False)
    with torch.inference_mode():
        logits = model(torch.as_tensor(arr, dtype=torch.long))
    assert logits.dtype == torch.bfloat16 and jlogits.dtype == jnp.bfloat16
    jl = np.asarray(jlogits).astype(np.float32)
    top2 = np.sort(jl, axis=-1)[..., -2:]
    for i, (r, n) in enumerate(zip(reqs, lengths)):
        assert r.response.status == rq.STATUS_OK and r.response.bucket == bucket
        got = np.asarray(r.response.output)
        clear = (top2[i, :n, 1] - top2[i, :n, 0]) > GAP
        np.testing.assert_array_equal(got[clear], jids[i, :n][clear])
        assert abs(r.response.score - jscore[i]) <= SCORE_REL * abs(jscore[i]), (
            r.response.score, jscore[i])


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm_bf16")
    data = _dict(root, 17)
    jm, variables = random_jax_lm()
    vb = _bf16(variables)
    args = Namespace(task="causal_lm", arch="transformer_lm_tiny", data=str(data), seed=1,
                     decoder_embed_dim=32, decoder_ffn_embed_dim=64)
    transformer_lm_tiny_architecture(args)
    path = root / "checkpoint.pt"
    checkpoint_utils.write_checkpoint(str(path), args, checkpoint_utils.from_jax_params(vb))
    loaded = serve_cli.load_serving_model(_serve_args(path), torch.device("cpu"))
    return jm, vb, loaded[0], loaded[1], loaded[4]


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_bf16_lm_prefill_and_8_decode_steps_match_jax(lm, kv):
    """Prefill plus 8 decode steps of the bf16 LM against the fp32 (or
    int8) pool; int8 tokens and scores are held only to their own run's
    finiteness and length (the quantized pool is not the JAX reference's)."""
    jm, vb, model, pad, eos = lm
    _assert_served_in_bf16(model)
    eng = DecodeEngine(model, bucket_edges=(16, 32), decode_batch=2, prefill_batch=2,
                       page_size=8, num_pages=12, pad_idx=pad, eos_idx=-1, vocab_size=17,
                       max_new_tokens=8, kv_dtype=kv)
    eng.warmup()
    assert eng.cache.k_pool.dtype == (torch.int8 if kv == "int8" else torch.float32)
    prompts = [[5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15]]
    reqs = [eng.submit(p, 60.0) for p in prompts]
    for _ in range(200):
        if all(r.done() for r in reqs):
            break
        eng.step(timeout=0.01)
    assert eng.decode_steps >= 8
    for p, r in zip(prompts, reqs):
        assert r.response.status == rq.STATUS_OK, r.response
        out = r.response.output
        # the prefill chooses the first token, each decode step the next;
        # the 8th step's choice ends the generation unemitted, and the
        # score averages all 9 choices' logits, as the JAX engine does
        assert len(out) == 8 and np.isfinite(r.response.score)
        if kv == "int8":
            continue
        # every prefix (prompt + the tokens before each generated one),
        # right-padded to 32 in one jitted bf16 prefill: causal rows never
        # see the pads on their right
        prefixes = [list(p) + out[:j] for j in range(len(out) + 1)]
        batch = np.full((len(prefixes), 32), pad, np.int32)
        for i, pre in enumerate(prefixes):
            batch[i, :len(pre)] = pre
        jlog = _jax_prefill(jm)(vb, batch)
        assert jlog.dtype == jnp.bfloat16
        rows = np.asarray(jlog.astype(jnp.float32))[np.arange(len(prefixes)),
                                                     [len(x) - 1 for x in prefixes]]
        for j, tok in enumerate(out):
            if tok != int(rows[j].argmax()):
                top2 = np.sort(rows[j])[-2:]
                assert top2[1] - top2[0] < GAP, (p, j, out)
                break
        else:
            want = float(rows.max(axis=-1).mean())
            assert abs(r.response.score - want) <= SCORE_REL * abs(want), (
                r.response.score, want)


_PREFILL = {}


def _jax_prefill(jm):
    if jm not in _PREFILL:
        _PREFILL[jm] = jax.jit(lambda v, t: jm.apply(v, t, method="prefill")[0])
    return _PREFILL[jm]


def test_bf16_lm_decode_step_runs_in_bf16_against_the_fp32_pool(lm):
    """One decode step of the bf16 model over an fp32 cache: logits bf16,
    the new K/V rows cast into the pool's type, as the JAX engine casts
    them (``unicore_tpu/serve/decode.py`` ``_decode``)."""
    _, _, model, _, _ = lm
    L, H, D = 16, 4, 8
    caches = (torch.zeros(2, 2, H, L, D), torch.zeros(2, 2, H, L, D))
    with torch.inference_mode():
        logits, (k_rows, v_rows) = model.decode_step(
            torch.tensor([5, 6]), caches, torch.tensor([0, 3], dtype=torch.int32))
    assert logits.dtype == torch.bfloat16 and logits.shape == (2, 17)
    assert k_rows.dtype == v_rows.dtype == torch.float32
    assert k_rows.shape == (2, 2, H, D)
