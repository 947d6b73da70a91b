"""The port's Evoformer modules and model (unicore_tpu_torch/modules/evoformer.py,
models/evoformer_model.py) against the JAX package on the CPU.

Each module is initialised by the JAX package, every weight then moved by
0.05 N(0, 1) from a numpy seed (so the AF2 zero-init projections and gates
carry gradient), and loaded into the port with ``from_jax_params``; both
run the same numpy inputs, and the gradients of a random cotangent are
compared for every parameter and every float input.  Two widths:

- ``flash``: msa 64 / 8 heads, pair 32 / 4 heads (head dim 8), L = 104:
  the MSA-row and triangle attentions take the direct flash route, padded
  to 128 (the JAX side runs its Pallas flash kernels in interpret mode,
  the port the flash attention's plain version);
- ``tiny`` (``evoformer_tiny``: msa 32 / 4, pair 16 / 4, head dims 8 and
  4) at L = 40: every attention takes the fused-softmax route (pad waste,
  head dim 4), the JAX package's jnp composition and the port's plain one.

The MSA column attention attends over R = 4 rows and takes the fused
route at both widths.  Inputs hold padded residues and a padded MSA row,
so masks and fully masked rows are on every route.

Tolerances: outputs 2e-5, gradients 5e-5, of the tensor's largest
magnitude (at least 1): fp32 on both sides, summation orders differ, the
flash route recomputes p from lse, and a block chains eleven modules.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unicore_tpu.models.evoformer_model import EvoformerModel as JaxEvoformer
from unicore_tpu.modules import evoformer as jax_evo
from unicore_tpu.ops import _pallas

from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.models.evoformer_model import EvoformerModel as PortEvoformer
from unicore_tpu_torch.modules import DropoutRng
from unicore_tpu_torch.modules import evoformer as port_evo
from unicore_tpu_torch.modules.dropout import dropout
from unicore_tpu_torch.ops import _kernels

OUT_TOL, GRAD_TOL = 2e-5, 5e-5
WIDTHS = {
    "flash": dict(msa_dim=64, pair_dim=32, msa_heads=8, pair_heads=4, L=104),
    "tiny": dict(msa_dim=32, pair_dim=16, msa_heads=4, pair_heads=4, L=40),
}
B, R, PAD = 2, 4, 1


@pytest.fixture
def pallas_interpret():
    """Run the JAX Pallas kernels in interpret mode for one test, restoring
    the process-global override exactly as it was."""
    saved = _pallas._override
    _pallas.set_interpret(True)
    try:
        yield
    finally:
        _pallas._override = saved


def _streams(w, seed):
    """msa (B, R, L, msa_dim), pair (B, L, L, pair_dim) and their masks:
    sample 1 has 12 padded residues, sample 0 a padded last MSA row."""
    L = w["L"]
    rng = np.random.default_rng(seed)
    msa = rng.standard_normal((B, R, L, w["msa_dim"])).astype(np.float32)
    pair = rng.standard_normal((B, L, L, w["pair_dim"])).astype(np.float32)
    msa_mask = np.ones((B, R, L), np.float32)
    msa_mask[1, :, L - 12:] = 0
    msa_mask[0, R - 1] = 0
    seq = msa_mask[:, 0]
    pair_mask = seq[:, :, None] * seq[:, None, :]
    return msa, pair, msa_mask, pair_mask


def _perturb(variables, seed):
    leaves, tdef = jax.tree_util.tree_flatten(jax.device_get(variables))
    rng = np.random.default_rng(seed)
    return tdef.unflatten([np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
                           for x in leaves])


def _close(got, ref, floor, what):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    tol = floor * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    assert np.isfinite(got).all() and err <= tol, (what, err, tol)


def _compare(jmod, pmod, inputs, masks, seed):
    """Outputs and gradients (parameters and float inputs) of one module,
    port against JAX, from the same perturbed JAX weights."""
    jin = [jnp.asarray(x) for x in inputs]
    jmasks = {k: jnp.asarray(v) for k, v in masks.items()}
    variables = _perturb(jmod.init(jax.random.PRNGKey(seed), *jin, **jmasks), seed)
    pmod.load_state_dict(checkpoint_utils.from_jax_params(variables))
    pmod.eval()

    def jf(v, *xs):
        out = jmod.apply(v, *xs, **jmasks)
        return out if isinstance(out, tuple) else (out,)

    jout, vjp = jax.vjp(jf, variables, *jin)
    rng = np.random.default_rng(seed + 1)
    cts = [rng.standard_normal(o.shape).astype(np.float32) for o in jout]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cts))

    tin = [torch.from_numpy(x.copy()).requires_grad_(True) for x in inputs]
    pout = pmod(*tin, **{k: torch.from_numpy(v) for k, v in masks.items()})
    pout = pout if isinstance(pout, tuple) else (pout,)
    for i, (p, j) in enumerate(zip(pout, jout)):
        _close(p.detach().numpy(), np.asarray(j), OUT_TOL, f"output {i}")
    names = [n for n, _ in pmod.named_parameters()]
    grads = torch.autograd.grad(pout, [p for _, p in pmod.named_parameters()] + tin,
                                [torch.from_numpy(c) for c in cts])
    ref = checkpoint_utils.from_jax_params(jax.device_get(jgrads[0]))
    assert set(ref) == set(names)
    for name, g in zip(names, grads):
        _close(g.numpy(), ref[name].numpy(), GRAD_TOL, f"grad {name}")
    for i, (g, j) in enumerate(zip(grads[len(names):], jgrads[1:])):
        _close(g.numpy(), np.asarray(j), GRAD_TOL, f"grad input {i}")
    assert sum(_kernels.launch_counts().values()) == 0


def _module(name, w):
    """(JAX module, port module, float inputs, masks) for one module."""
    msa, pair, msa_mask, pair_mask = _streams(w, seed=len(name))
    m, z, hm, hz = w["msa_dim"], w["pair_dim"], w["msa_heads"], w["pair_heads"]
    if name == "gated_attention":  # the MSA-row layout: bias group b for R rows
        rng = np.random.default_rng(3)
        bias = rng.standard_normal((B, hm, w["L"], w["L"])).astype(np.float32)
        return (jax_evo.GatedAttention(m, hm), port_evo.GatedAttention(m, hm),
                [msa, msa, bias], {"kv_mask": msa_mask})
    if name == "msa_row_attn":
        return (jax_evo.MSARowAttentionWithPairBias(m, z, hm),
                port_evo.MSARowAttentionWithPairBias(m, z, hm), [msa, pair],
                {"msa_mask": msa_mask})
    if name == "msa_col_attn":
        return (jax_evo.MSAColumnAttention(m, hm), port_evo.MSAColumnAttention(m, hm),
                [msa], {"msa_mask": msa_mask})
    if name == "outer_product_mean":
        return (jax_evo.OuterProductMean(m, z), port_evo.OuterProductMean(m, z), [msa],
                {"msa_mask": msa_mask})
    if name in ("tri_mul_out", "tri_mul_in"):
        out = name == "tri_mul_out"
        return (jax_evo.TriangleMultiplication(z, outgoing=out),
                port_evo.TriangleMultiplication(z, outgoing=out), [pair],
                {"pair_mask": pair_mask})
    if name in ("tri_attn_start", "tri_attn_end"):
        st = name == "tri_attn_start"
        return (jax_evo.TriangleAttention(z, hz, starting=st),
                port_evo.TriangleAttention(z, hz, starting=st), [pair],
                {"pair_mask": pair_mask})
    if name == "transition":
        return jax_evo.Transition(z), port_evo.Transition(z), [pair], {}
    if name == "iteration":
        kw = dict(msa_dim=m, pair_dim=z, msa_heads=hm, pair_heads=hz, dropout=0.0)
        return (jax_evo.EvoformerIteration(**kw), port_evo.EvoformerIteration(**kw),
                [msa, pair], {"msa_mask": msa_mask, "pair_mask": pair_mask})
    raise AssertionError(name)


MODULE_CASES = [(n, "tiny") for n in (
    "gated_attention", "msa_row_attn", "msa_col_attn", "outer_product_mean",
    "tri_mul_out", "tri_mul_in", "tri_attn_start", "tri_attn_end", "transition",
    "iteration")] + [(n, "flash") for n in (
        "gated_attention", "msa_row_attn", "tri_attn_start", "tri_attn_end")]


@pytest.mark.parametrize("name,width", MODULE_CASES)
def test_module_matches_jax(pallas_interpret, name, width):
    jmod, pmod, inputs, masks = _module(name, WIDTHS[width])
    _compare(jmod, pmod, inputs, masks, seed=7)


@pytest.mark.parametrize("width", ["flash", "tiny"])
def test_routes_match_the_jax_gate(pallas_interpret, width):
    """The direct flash route's gate is the JAX ``_flash_ok`` without its
    backend check (interpret mode passes that check, as a TPU does): the
    flash width sends the MSA-row and triangle attentions to the flash
    kernel, the tiny width sends none; the MSA column attention (R = 4)
    never goes."""
    w = WIDTHS[width]
    L, hm, hz = w["L"], w["msa_dim"] // w["msa_heads"], w["pair_dim"] // w["pair_heads"]
    bias = np.zeros((B, 1, L, L), np.float32)
    for N, Lq, hd in ((B * R, L, hm), (B * L, L, hz), (B * L, R, hm)):
        got = port_evo._flash_ok(N, Lq, Lq, hd, torch.float32, torch.from_numpy(bias))
        assert got == jax_evo._flash_ok(N, Lq, Lq, hd, jnp.float32, jnp.asarray(bias))
        assert got == (width == "flash" and Lq == L), (width, N, Lq, hd)


def _msa_batch(w, seed):
    """src_msa (B, R, L) tokens (row 0 the target) with a padded row and
    padded residues, and its masked-MSA target."""
    L = w["L"]
    rng = np.random.default_rng(seed)
    src = rng.integers(4, 25, size=(B, R, L)).astype(np.int64)
    src[1, :, L - 12:] = PAD
    src[0, R - 1] = PAD
    tgt = np.where(rng.random((B, R, L)) < 0.15, src, PAD)
    return src, tgt


@pytest.mark.parametrize("width", ["flash", "tiny"])
def test_model_loss_and_grads_match_jax(pallas_interpret, width):
    """``EvoformerModel`` (1 block) logits, pair output, masked-MSA loss and
    every parameter's gradient, from the same perturbed JAX weights."""
    from unicore_tpu.losses.masked_msa import MaskedMSALoss as JaxLoss
    from unicore_tpu_torch.losses.masked_msa import MaskedMSALoss as PortLoss

    w = WIDTHS[width]
    kw = dict(vocab_size=26, padding_idx=PAD, num_blocks=1, msa_dim=w["msa_dim"],
              pair_dim=w["pair_dim"], msa_heads=w["msa_heads"], pair_heads=w["pair_heads"],
              dropout=0.0, max_seq_len=w["L"])
    src, tgt = _msa_batch(w, seed=w["L"])
    sample = {"net_input": {"src_msa": src}, "target": tgt}

    class Task:
        dictionary = type("D", (), {"pad": staticmethod(lambda: PAD)})
        args = None

    jmodel = JaxEvoformer(**kw)
    variables = _perturb(jmodel.init_params(jax.random.PRNGKey(0), sample), 5)
    jloss = JaxLoss(Task)
    jsample = {"net_input": {"src_msa": jnp.asarray(src)}, "target": jnp.asarray(tgt)}
    @jax.jit  # one trace of the interpret-mode kernels: half the eager time
    def loss_and_outputs(v):
        def loss_fn(v):
            loss, sample_size, _ = jloss.forward(jmodel, v, jsample, train=False)
            return loss, sample_size

        return (jax.value_and_grad(loss_fn, has_aux=True)(v),
                jmodel.apply(v, jsample["net_input"]["src_msa"], train=False))

    ((jval, jss), jgrads), (jlogits, jpair) = loss_and_outputs(variables)

    port = PortEvoformer(**kw)
    port.load_state_dict(checkpoint_utils.from_jax_params(variables))
    port.eval()
    tsample = {"net_input": {"src_msa": torch.from_numpy(src)},
               "target": torch.from_numpy(tgt)}
    logits, pair = port(tsample["net_input"]["src_msa"])
    _close(logits.detach().numpy(), np.asarray(jlogits), OUT_TOL, "logits")
    _close(pair.detach().numpy(), np.asarray(jpair), OUT_TOL, "pair")
    loss, ss, log = PortLoss(Task)(port, tsample)
    assert float(ss) == float(jss) == float((tgt != PAD).sum())
    assert abs(loss.item() - float(jval)) <= 1e-5 * abs(float(jval))
    loss.backward()
    ref = checkpoint_utils.from_jax_params(jax.device_get(jgrads))
    assert set(ref) == {n for n, _ in port.named_parameters()}
    for name, p in port.named_parameters():
        # the last block's pair updates do not reach the loss: no gradient
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        _close(grad.numpy(), ref[name].numpy(), GRAD_TOL, f"grad {name}")
    assert log["bsz"] == B and log["seq_len"] == B * w["L"]


def test_drop_row_shares_one_mask_along_dim_1():
    """``dropout(..., broadcast_dims=(1,))``, the Evoformer's ``drop_row``
    (flax ``nn.Dropout(broadcast_dims=(1,))``): one mask drawn for the
    shape with dim 1 set to 1, broadcast along it; kept values scaled by
    1 / (1 - p); the same (seed, update, micro-batch) gives the same mask."""
    x = torch.ones(2, 5, 16, 8)
    p = 0.25
    y = dropout(x, p, True, DropoutRng(3, "cpu", 0, 0), broadcast_dims=(1,))
    assert torch.equal(y, y[:, :1].expand_as(y))
    assert set(torch.unique(y).tolist()) <= {0.0, float(torch.tensor(1.0 / (1.0 - p)))}
    assert 0 < (y == 0).float().mean().item() < 0.5
    assert torch.equal(y, dropout(x, p, True, DropoutRng(3, "cpu", 0, 0), broadcast_dims=(1,)))
    z = dropout(x, p, True, DropoutRng(3, "cpu", 0, 0))  # no broadcast: masks differ by row
    assert not torch.equal(z, z[:, :1].expand_as(z))
    assert torch.equal(dropout(x, p, False, None, broadcast_dims=(1,)), x)


def test_unported_stack_options_raise():
    """Remat, the pipelined stack and the sequence-sharded stack raise,
    naming the JAX code."""
    for kw, match in ((dict(remat=True), "remat"), (dict(remat_policy="dots"), "remat"),
                      (dict(pipeline_stages=2), "pipeline"), (dict(seq_shard=True), "seq")):
        with pytest.raises(NotImplementedError, match=match):
            port_evo.EvoformerStack(num_blocks=1, msa_dim=8, pair_dim=8, msa_heads=1,
                                    pair_heads=1, **kw)
