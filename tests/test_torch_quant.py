"""The port's quantized serving path (``unicore_tpu_torch/ops/quant_*.py``,
``unicore_tpu_torch/quant/``) against the JAX package on the CPU, on the
same numpy inputs and the same weights.

The JAX functions run as the JAX package's own serving runs them on the
CPU: its jnp references (``quant_matmul_reference``,
``quant_layer_norm_reference``, ``quant_softmax_dropout_reference``) and its
modules in dispatch mode ``auto``, which on the CPU take those references.
No test here touches the Pallas interpret switch or a dispatch mode.

Tolerances:

- W8A8 dense: the int32 sum bit for bit (int8 operands, K up to 3072 with
  +-127 values, past where an int8 product would wrap); the fp32 output
  within 1e-6 of its absmax (exact sums; the activations' last bits
  differ between XLA and torch); fp8 operands within 1e-6 relative (fp32
  sums in another order);
- int8 LayerNorm 1e-5 absolute; int8/int32 softmax 1e-6 absolute;
- the quantize step, the per-channel weight quantization, the site names
  and the weights digest: equal, bit for bit;
- calibrated absmaxes: 1e-5 relative (fp32 forwards in another order);
- the quantized model on the JAX package's prepared weights: max |delta| of
  the logits within 5e-3 of their absmax and argmax equal on 99% of the
  positions (an activation 1e-7 apart may round to the neighbouring int8
  step); the port's own calibration drift below the JAX package's bounds
  (``tests/test_quant.py``: int8 0.05, fp8 0.15 of the logit absmax).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unicore_tpu.models.bert import BertModel as JaxBert
from unicore_tpu.ops import quant_matmul as jqm
from unicore_tpu.ops.quant_norm import quant_layer_norm_reference as jax_qln
from unicore_tpu.ops.quant_softmax_dropout import (
    quant_softmax_dropout_reference as jax_qsd,
)
from unicore_tpu.quant import calibrate as jcal

from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.models.bert import BertModel as PortBert
from unicore_tpu_torch.modules import multihead_attention as port_mha
from unicore_tpu_torch.ops import _kernels
from unicore_tpu_torch.ops import quant_matmul as qm
from unicore_tpu_torch.ops import quant_softmax_dropout as qsd
from unicore_tpu_torch.ops.fused_norm import quant_layer_norm_plain
from unicore_tpu_torch.ops.quant_norm import quant_layer_norm
from unicore_tpu_torch.quant import QTensor, calibrate, check_mode
from unicore_tpu_torch.quant.dense import QuantDense

REL_DRIFT_BOUND = {"int8": 0.05, "fp8": 0.15}
ACTIVATIONS = ["", "relu", "gelu", "gelu_fast", "tanh", "silu"]
#: the JAX package's tiny BERT of tests/test_quant.py
TINY = dict(vocab_size=100, padding_idx=1, encoder_layers=2, encoder_embed_dim=64,
            encoder_ffn_embed_dim=128, encoder_attention_heads=4, max_seq_len=32,
            post_ln=True, dropout=0.0, emb_dropout=0.0, attention_dropout=0.0)


def _int8(rng, shape, lo=-127, hi=128):
    return rng.integers(lo, hi, size=shape).astype(np.int8)


def _fp8_values(rng, shape):
    """fp32 values that are exact float8_e4m3fn values (a torch cast)."""
    v = torch.from_numpy((rng.standard_normal(shape) * 40).astype(np.float32))
    return torch.clamp(v, -448, 448).to(torch.float8_e4m3fn).float().numpy()


# ---------------------------------------------------------------------------
# #13: the W8A8 dense
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N,extreme", [(8, 128, 128, False), (19, 96, 40, False),
                                           (16, 3072, 96, True)])
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("with_bias", [False, True])
def test_quant_matmul_int8_matches_jax_reference(M, K, N, extreme, activation, with_bias):
    rng = np.random.default_rng(M * K + N)
    if extreme:  # +-127 only: the sums reach 5e7, far past an int8 result's wrap
        x = np.where(rng.random((M, K)) < 0.9, 127, -127).astype(np.int8)
        w = np.where(rng.random((K, N)) < 0.9, 127, -127).astype(np.int8)
    else:
        x, w = _int8(rng, (M, K)), _int8(rng, (K, N))
    scale = (rng.random(N) * 1e-3 + 1e-4).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32) if with_bias else None

    acc_jax = np.asarray(jax.lax.dot_general(
        jnp.asarray(x), jnp.asarray(w), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    wt = torch.from_numpy(np.ascontiguousarray(w.T))
    acc = qm.int8_matmul_plain(torch.from_numpy(x), wt)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), acc_jax)

    ref = np.asarray(jqm.quant_matmul_reference(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        None if bias is None else jnp.asarray(bias), activation))
    got = qm.quant_matmul(torch.from_numpy(x), wt, torch.from_numpy(scale),
                          None if bias is None else torch.from_numpy(bias), activation)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("activation", ["", "gelu"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_quant_matmul_fp8_matches_jax_reference(activation, with_bias):
    rng = np.random.default_rng(5)
    M, K, N = 12, 256, 64
    x, w = _fp8_values(rng, (M, K)), _fp8_values(rng, (K, N))
    scale = (rng.random(N) * 1e-3 + 1e-4).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32) if with_bias else None
    ref = np.asarray(jqm.quant_matmul_reference(
        jnp.asarray(x).astype(jnp.float8_e4m3fn), jnp.asarray(w).astype(jnp.float8_e4m3fn),
        jnp.asarray(scale), None if bias is None else jnp.asarray(bias), activation))
    got = qm.quant_matmul(
        torch.from_numpy(x).to(torch.float8_e4m3fn),
        torch.from_numpy(np.ascontiguousarray(w.T)).to(torch.float8_e4m3fn),
        torch.from_numpy(scale), None if bias is None else torch.from_numpy(bias),
        activation).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantize_step_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((7, 33)) * 3).astype(np.float32)
    x[0, :4] = [1e6, -1e6, 0.5 * 0.02, 1.5 * 0.02]  # saturation and .5 ties
    scale = np.float32(0.02)
    qmax = 127.0 if dtype == "int8" else 448.0
    jdt, tdt = ((jnp.int8, torch.int8) if dtype == "int8"
                else (jnp.float8_e4m3fn, torch.float8_e4m3fn))
    ref = np.asarray(jqm.quantize_to_dtype(jnp.asarray(x), scale, qmax, jdt)
                     .astype(jnp.float32))
    got = qm.quantize_to_dtype(torch.from_numpy(x), torch.tensor(scale), qmax, tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), ref)
    s_ref = np.asarray(jqm.dynamic_act_scale(jnp.asarray(x)))
    assert qm.dynamic_act_scale(torch.from_numpy(x)).item() == s_ref
    assert qm.dynamic_act_scale(torch.zeros(3, 4)).item() == np.float32(1e-8)


# ---------------------------------------------------------------------------
# 7q: the int8 LayerNorm; 10q: the int8/int32 softmax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 33), (2, 16, 768)])
@pytest.mark.parametrize("per_channel", [False, True])
def test_quant_layer_norm_matches_jax_reference(shape, per_channel):
    rng = np.random.default_rng(shape[-1])
    D = shape[-1]
    x = _int8(rng, shape)
    scale = ((rng.random(D) if per_channel else rng.random(())) * 0.05 + 0.01
             ).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    ref = np.asarray(jax_qln(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(w),
                             jnp.asarray(b)))
    args = [torch.from_numpy(np.asarray(a)) for a in (x, scale, w, b)]
    got = quant_layer_norm(*args)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-5
    np.testing.assert_array_equal(quant_layer_norm_plain(*args).numpy(), got.numpy())


@pytest.mark.parametrize(
    "shape,dtype,mask_shape,bias_shape",
    [
        ((2, 3, 16, 128), "int32", (2, 1, 1, 128), (1, 3, 16, 128)),  # bcast
        ((2, 3, 16, 256), "int8", None, (3, 16, 256)),
        ((6, 16, 384), "int32", None, (2, 16, 384)),  # tile
        ((2, 2, 12, 40), "int32", (2, 1, 1, 40), None),  # no kernel shape
    ],
)
def test_quant_softmax_matches_jax_reference(shape, dtype, mask_shape, bias_shape):
    rng = np.random.default_rng(shape[-1] + len(shape))
    hi = 128 if dtype == "int8" else 200_000
    x = rng.integers(-hi + 1, hi, size=shape).astype(dtype)
    scale = np.float32(3.0 / hi)
    mask = None
    if mask_shape is not None:
        mask = ((rng.random(mask_shape) < 0.3).astype(np.float32)
                * np.finfo(np.float32).min)
    bias = None if bias_shape is None else rng.standard_normal(bias_shape).astype(np.float32)
    ref = np.asarray(jax_qsd(jnp.asarray(x), scale, 0.0,
                             mask=None if mask is None else jnp.asarray(mask),
                             bias=None if bias is None else jnp.asarray(bias)))
    t = [None if a is None else torch.from_numpy(a) for a in (x, mask, bias)]
    kernel_shape = qsd.kernel_would_run(t[0].shape, t[0].dtype, t[1], t[2])
    assert kernel_shape == (shape[-1] % 128 == 0)
    got = qsd.quant_softmax_dropout(t[0], torch.tensor(scale), mask=t[1], bias=t[2])
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-6
    plain = qsd.quant_softmax_dropout_plain(t[0], torch.tensor(scale), 0.0, t[1], t[2])
    assert np.abs(plain.numpy() - ref).max() <= 1e-6


def test_quant_softmax_dropout_is_the_kernels_philox():
    """At a nonzero rate the plain version drops what the fp32 softmax's
    Philox mask drops, on the dequantized scores."""
    from unicore_tpu_torch.ops.softmax_dropout import softmax_dropout_plain

    x = torch.randint(-1000, 1000, (2, 8, 128), dtype=torch.int32)
    s = torch.tensor(0.01)
    got = qsd.quant_softmax_dropout_plain(x, s, 0.2, seed=7)
    want = softmax_dropout_plain(x.float() * s, 0.2, seed=7)
    assert torch.equal(got, want) and bool((got == 0).any())


@pytest.mark.parametrize("D", [64, 1300])
def test_int8_scores_are_the_exact_int32_product(D):
    """The attention's q.k^T of int8 operands equals the JAX int32
    ``dot_general`` bit for bit: in fp32 at BERT's head dim, through float64
    past 1040 (sums past 2**24 here), and never in TF32."""
    rng = np.random.default_rng(D)
    q = np.where(rng.random((2, 3, 8, D)) < 0.95, 127, -127).astype(np.int8)
    k = np.where(rng.random((2, 3, 8, D)) < 0.95, 127, -127).astype(np.int8)
    ref = np.asarray(jax.lax.dot_general(
        jnp.asarray(q), jnp.asarray(k), (((3,), (3,)), ((0, 1), (0, 1))),
        preferred_element_type=jnp.int32))
    assert (np.abs(ref).max() > 2 ** 24) == (D > 1040)
    got = port_mha._int8_scores(torch.from_numpy(q), torch.from_numpy(k))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = port_mha._int8_scores(torch.from_numpy(q), torch.from_numpy(k))
    finally:
        torch.set_float32_matmul_precision(prev)
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# QuantDense and the small pieces of quant/
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_quant_dense_fp_path_is_linear(activation):
    from unicore_tpu_torch.utils import get_activation_fn

    torch.manual_seed(0)
    dense = QuantDense(24, 40, activation=activation, quantize_output=True)
    lin = torch.nn.Linear(24, 40)
    lin.load_state_dict(dense.state_dict())
    assert list(dense.state_dict()) == ["weight", "bias"]
    x = torch.randn(3, 5, 24)
    want = lin(x) if not activation else get_activation_fn(activation)(lin(x))
    assert torch.equal(dense(x), want)


def test_quant_small_pieces():
    with pytest.raises(ValueError):
        check_mode("int4")
    assert check_mode("") == "off"
    qt = QTensor(torch.tensor([[10, -20]], dtype=torch.int8), torch.tensor(0.5))
    np.testing.assert_array_equal(qt.dequant().numpy(), [[5.0, -10.0]])
    b = calibrate.calibration_batches(100, 1, [16, 32], 2, n_batches=2)
    j = jcal.calibration_batches(100, 1, [16, 32], 2, n_batches=2)
    assert len(b) == len(j) == 4
    for x, y in zip(b, j):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# calibration and the model against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The JAX ``_tiny_bert`` of tests/test_quant.py and its port twin on
    the same weights."""
    jm = JaxBert(**TINY)
    toks = np.random.RandomState(0).randint(4, 100, size=(2, 16)).astype(np.int32)
    variables = jm.init_params(jax.random.PRNGKey(0), {"net_input": {"src_tokens": toks}})
    variables = jax.tree_util.tree_map(np.asarray, variables)
    cfg = {k: v for k, v in TINY.items() if k not in ("post_ln",)}
    pm = PortBert(post_ln=True, **cfg).eval()
    pm.load_state_dict(checkpoint_utils.from_jax_params(variables))
    return jm, variables, pm


def test_site_names_and_digest_match_jax(tiny):
    jm, variables, pm = tiny
    batches = jcal.calibration_batches(100, 1, [16], 2)
    j_sites = jcal.collect_scales(jm.clone(quantize="int8"), variables, batches)
    p_sites = calibrate.collect_scales(pm.clone(quantize="int8"), batches)
    assert sorted(p_sites) == sorted(j_sites) == sorted(calibrate.quant_sites(pm))
    assert "sentence_encoder/layers_0/self_attn/in_proj" in p_sites
    for site, leaves in j_sites.items():
        assert sorted(p_sites[site]) == sorted(leaves), site
        for name, v in leaves.items():
            assert abs(p_sites[site][name] - v) <= 1e-5 * abs(v), (site, name)
    assert "out_absmax" in p_sites["lm_head/dense"]
    assert calibrate.weights_digest(pm.state_dict(), j_sites) == \
        jcal.weights_digest(variables, j_sites)
    # the fp model records inputs only: out_absmax needs the quantized twin
    fp_sites = calibrate.collect_scales(pm, batches)
    assert "out_absmax" not in fp_sites["lm_head/dense"]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_prepare_matches_jax_bit_for_bit(tiny, mode):
    jm, variables, pm = tiny
    sites = jcal.collect_scales(jm.clone(quantize=mode), variables,
                                jcal.calibration_batches(100, 1, [16, 32], 2))
    j_prep = jcal.prepare(variables, sites, mode)
    state = pm.state_dict()
    before = {k: v.clone() for k, v in state.items()}
    p_prep = calibrate.prepare(state, sites, mode)
    for k, v in before.items():  # the fp32 state is left untouched
        assert torch.equal(state[k], v)
    carried = checkpoint_utils.from_jax_params(j_prep)
    assert sorted(carried) == sorted(p_prep)
    for key, want in carried.items():
        got = p_prep[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if got.dtype == torch.float8_e4m3fn:
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), key
        else:
            assert torch.equal(got, want), key
    node = j_prep["params"]["lm_head"]["dense"]
    w_q = p_prep["lm_head.dense.weight_q"]
    want = np.asarray(node["kernel_q"]).T
    if mode == "int8":
        np.testing.assert_array_equal(w_q.numpy(), want)
    else:
        np.testing.assert_array_equal(w_q.view(torch.uint8).numpy(), want.view(np.uint8))
    np.testing.assert_array_equal(p_prep["lm_head.dense.weight_scale"].numpy(),
                                  np.asarray(node["kernel_scale"]))
    assert p_prep["lm_head.dense.out_scale"].item() == np.float32(node["out_scale"])


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("seq", [16, 32])
def test_quantized_model_matches_jax_on_its_prepared_weights(tiny, mode, seq):
    jm, variables, pm = tiny
    jq = jm.clone(quantize=mode)
    j_prep, _ = jcal.calibrate_for_serving(
        jq, jm, variables, mode=mode, snapshot_path=None, vocab_size=100, pad_idx=1,
        bucket_edges=[seq], batch_size=2)
    j_prep = jax.tree_util.tree_map(np.asarray, j_prep)
    pq = calibrate.load_prepared(pm.clone(quantize=mode),
                                 checkpoint_utils.from_jax_params(j_prep))
    toks = np.random.RandomState(7).randint(4, 100, size=(3, seq)).astype(np.int32)
    toks[2, seq // 2:] = 1  # a padded row
    ref = np.asarray(jq.apply(j_prep, toks, train=False), np.float32)
    _kernels.reset_launch_counts()
    with torch.no_grad():
        got = pq(torch.from_numpy(toks).long()).numpy()
    assert sum(_kernels.launch_counts().values()) == 0  # CPU: plain versions
    assert np.abs(got - ref).max() <= 5e-3 * np.abs(ref).max()
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.99


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("seq", [16, 32])
def test_port_calibration_drift_within_jax_bound(tiny, mode, seq):
    _, _, pm = tiny
    pq, info = calibrate.calibrate_for_serving(
        pm.clone(quantize=mode), pm, mode=mode, snapshot_path=None, vocab_size=100,
        pad_idx=1, bucket_edges=[seq], batch_size=2)
    assert info["sites"] == 9 and info["source"] == "calibrated"
    assert info["rel_drift"] < REL_DRIFT_BOUND[mode], info
    toks = torch.from_numpy(np.random.RandomState(7).randint(4, 100, size=(2, seq))).long()
    with torch.no_grad():
        ref, got = pm(toks), pq(toks)
    rel = (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-8)
    assert rel < 2 * REL_DRIFT_BOUND[mode], rel
    # the quantized twin holds no fp32 copy of a site's weight
    assert "lm_head.dense.weight" not in pq.state_dict()
    assert pq.lm_head.dense.weight_q.dtype == (
        torch.int8 if mode == "int8" else torch.float8_e4m3fn)


def test_sidecar_is_shared_with_jax(tmp_path, tiny):
    """A sidecar written by either package is reused by the other; other
    weights, a torn file, another version or an unknown site re-derive."""
    jm, variables, pm = tiny
    kw = dict(mode="int8", vocab_size=100, pad_idx=1, bucket_edges=[16], batch_size=2)
    snap = str(tmp_path / "a.pt")
    _, j_info = jcal.calibrate_for_serving(jm.clone(quantize="int8"), jm, variables,
                                           snapshot_path=snap, **kw)
    assert j_info["source"] == "calibrated"
    _, p_info = calibrate.calibrate_for_serving(pm.clone(quantize="int8"), pm,
                                                snapshot_path=snap, **kw)
    assert p_info["source"] == "reused-verified"
    assert p_info["weights_digest"] == j_info["weights_digest"]

    snap = str(tmp_path / "b.pt")
    calibrate.calibrate_for_serving(pm.clone(quantize="int8"), pm, snapshot_path=snap, **kw)
    with open(calibrate.scales_path(snap)) as f:
        doc = json.load(f)
    assert doc["version"] == 1 and doc["mode"] == "int8" and len(doc["sites"]) == 9
    _, j_info = jcal.calibrate_for_serving(jm.clone(quantize="int8"), jm, variables,
                                           snapshot_path=snap, **kw)
    assert j_info["source"] == "reused-verified"

    other = PortBert(post_ln=True, **{k: v for k, v in TINY.items() if k != "post_ln"},
                     generator=torch.Generator().manual_seed(3)).eval()
    _, info = calibrate.calibrate_for_serving(other.clone(quantize="int8"), other,
                                              snapshot_path=snap, **kw)
    assert info["source"] == "calibrated"
    path = calibrate.scales_path(snap)
    for bad in ("{not json", json.dumps({"version": 99})):
        with open(path, "w") as f:
            f.write(bad)
        _, info = calibrate.calibrate_for_serving(pm.clone(quantize="int8"), pm,
                                                  snapshot_path=snap, **kw)
        assert info["source"] == "calibrated"
    with open(path) as f:
        doc = json.load(f)
    doc["sites"]["nonexistent/site"] = {"act_absmax": 1.0}
    with open(path, "w") as f:
        json.dump(doc, f)
    _, info = calibrate.calibrate_for_serving(pm.clone(quantize="int8"), pm,
                                              snapshot_path=snap, **kw)
    assert info["source"] == "calibrated" and os.path.exists(path)
