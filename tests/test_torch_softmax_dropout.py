"""The port's fused softmax(+mask)(+bias)(+dropout)
(unicore_tpu_torch/ops/softmax_dropout.py) against the JAX package on the
CPU.

Inputs come from a numpy seed.  The JAX side runs its Pallas kernels
(``softmax_dropout_pallas``) in interpret mode with the dispatch mode
``on``, as tests/test_softmax_dropout.py runs them; the port's side runs
``softmax_dropout_plain`` (autograd gives its gradient), the function the
CUDA kernels are held against on the card by chip_smoke.py.  Dropout bits
are never compared with the JAX package's (Philox against the TPU's
stream): at rate 0.1 the port is held to determinism, its keep rate,
``p * keep / (1 - r)`` and the gradient of that formula.

Tolerances: fp32 forward 1e-6 absolute on probabilities (both sides take an
fp32 softmax and differ in summation order and exp's last bits); fp32
gradients 1e-5 of the tensor's largest magnitude (at least 1).  bf16: the
outputs and dx are fp32 values rounded to bf16, which may round to
neighbouring bf16 values: one bf16 ulp (2**-7 of the element) on top of
the fp32 allowance; mask/bias gradients stay fp32 sums.
"""

import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unicore_tpu.ops import _pallas

from unicore_tpu_torch.modules import DropoutRng
from unicore_tpu_torch.ops import _kernels
from unicore_tpu_torch.ops import attention_fullrow as port_fr
from unicore_tpu_torch.ops import softmax_dropout as port_sd

jax_sd = importlib.import_module("unicore_tpu.ops.softmax_dropout")
jax_sdp = importlib.import_module("unicore_tpu.ops.softmax_dropout_pallas")

FWD_TOL = 1e-6
GRAD_TOL = 1e-5
BF16_ULP = 2.0 ** -7


@pytest.fixture
def pallas_on():
    """The JAX softmax_dropout dispatch in mode ``on`` with the Pallas
    kernels in interpret mode, both process-global switches restored
    exactly as they were after the test."""
    saved_interpret, saved_mode = _pallas._override, jax_sd._gate._mode
    _pallas.set_interpret(True)
    jax_sd.set_softmax_dropout_mode("on")
    try:
        yield
    finally:
        _pallas._override = saved_interpret
        jax_sd._gate._mode = saved_mode


def _layout(name, seed):
    """(input, mask, bias) numpy fp32 for one extra layout the kernel takes."""
    r = np.random.RandomState(seed)
    if name == "plain":
        return r.randn(4, 16, 128), None, None
    if name == "bcast":  # mask broadcast over rows, bias shared over the batch
        return (r.randn(2, 4, 16, 256), np.where(r.rand(2, 1, 1, 256) < 0.2, -1e9, 0.0),
                r.randn(1, 4, 16, 256))
    if name == "tile":  # the Uni-Fold triangle layout: bias row i % 2
        return r.randn(6, 16, 128), None, r.randn(2, 16, 128)
    if name == "evoformer":  # mixed per-dim broadcast (G, 1, H, ...) vs (G, N, H, ...)
        return r.randn(2, 3, 4, 8, 128), r.randn(1, 3, 1, 1, 128), r.randn(2, 1, 4, 8, 128)
    if name == "neg_inf":  # whole -inf columns, as Uni-Mol's padded keys
        x = r.randn(2, 8, 128)
        x[:, :, 100:] = -np.inf
        return x, None, r.randn(1, 8, 128)
    raise AssertionError(name)


def _np(x, dtype=np.float32):
    return None if x is None else np.asarray(x, dtype)


def _check(got, ref, floor, what):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    tol = floor * max(1.0, float(np.abs(ref).max()))
    err = np.abs(got - ref)
    assert np.isfinite(got).all(), what
    assert (err <= tol).all(), (what, float(err.max()), tol)


def _check_bf16(got, ref, floor, what):
    ref = np.asarray(ref, np.float64)
    tol = floor * max(1.0, float(np.abs(ref).max())) + BF16_ULP * np.abs(ref)
    err = np.abs(np.asarray(got, np.float64) - ref)
    assert (err <= tol).all(), (what, float(err.max()))


@pytest.mark.parametrize("layout", ["plain", "bcast", "tile", "evoformer", "neg_inf"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(pallas_on, layout, dtype):
    """Forward and the dx/dmask/dbias gradients at rate 0 against the JAX
    Pallas kernels (interpret mode) and their custom VJP."""
    x, mask, bias = _layout(layout, seed=len(layout))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    assert port_sd.kernel_would_run(x.shape, tdt, _np(mask), _np(bias))
    dy = np.random.RandomState(1).randn(*x.shape)

    jx = jnp.asarray(x, jnp.float32).astype(jdt)
    jargs = [jx] + [jnp.asarray(e, jnp.float32) for e in (mask, bias) if e is not None]

    def jfun(x_, *extras):
        it = iter(extras)
        m = next(it) if mask is not None else None
        b = next(it) if bias is not None else None
        return jax_sd.softmax_dropout(x_, 0.0, is_training=True, mask=m, bias=b)

    jout, vjp = jax.vjp(jfun, *jargs)
    jgrads = vjp(jnp.asarray(dy, jnp.float32).astype(jdt))

    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt).requires_grad_(True)
    textras = [None if e is None else torch.from_numpy(_np(e)).requires_grad_(True)
               for e in (mask, bias)]
    _kernels.reset_launch_counts()
    out = port_sd.softmax_dropout_plain(tx, 0.0, *textras)
    assert out.dtype == tdt and out.shape == tx.shape
    leaves = [tx] + [e for e in textras if e is not None]
    tgrads = torch.autograd.grad(out, leaves,
                                 torch.from_numpy(np.asarray(
                                     jnp.asarray(dy, jnp.float32).astype(jdt).astype(jnp.float32)
                                 )).to(tdt))
    assert sum(_kernels.launch_counts().values()) == 0

    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    if dtype == "float32":
        _check(out.detach().numpy(), f32(jout), FWD_TOL, "forward")
        _check(tgrads[0].numpy(), f32(jgrads[0]), GRAD_TOL, "dx")
    else:
        _check_bf16(out.detach().float().numpy(), f32(jout), FWD_TOL, "forward")
        _check_bf16(tgrads[0].float().numpy(), f32(jgrads[0]), GRAD_TOL, "dx")
    for name, g, r in zip(("dmask/dbias", "dbias"), tgrads[1:], jgrads[1:]):
        assert tuple(g.shape) == tuple(r.shape), name
        _check(g.numpy(), f32(r), GRAD_TOL, name)


@pytest.mark.parametrize("layout", ["plain", "bcast", "tile", "evoformer"])
def test_extra_index_map_matches_broadcast(layout):
    """The index map the CUDA kernels read an extra through (``_extra_desc``:
    leading dims with element strides, row and column strides), evaluated
    here in numpy for every (r, m, col), gives the broadcast extra."""
    x, mask, bias = _layout(layout, seed=3)
    ishape = x.shape
    R, M, L = port_sd._rows(ishape)
    for ext in (mask, bias):
        if ext is None:
            continue
        t = torch.from_numpy(_np(ext))
        plan = port_sd.plan_extra(tuple(t.shape), ishape)
        desc = port_sd._extra_desc(t, plan, ishape)
        nlead, row_stride, col_stride = desc[1], desc[2], desc[3]
        dims, strides = desc[4:4 + nlead], desc[4 + nlead:]
        flat = t.contiguous().reshape(-1).numpy()
        r = np.arange(R)
        base = np.zeros(R, np.int64)
        rem = r.copy()
        for d in range(nlead - 1, -1, -1):
            base += (rem % dims[d]) * strides[d]
            rem //= dims[d]
        idx = (base[:, None, None] + np.arange(M)[None, :, None] * row_stride
               + np.arange(L)[None, None, :] * col_stride)
        got = flat[idx].reshape(ishape)
        ref = port_sd._expand_extra(t, ishape).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("layout", ["bcast", "tile", "evoformer"])
def test_kernel_backward_composition(layout):
    """What the CUDA autograd Function builds from the backward kernel's
    fp32 ds -- dx its cast, dmask/dbias ``_grad_reduce`` -- with ds from
    ``softmax_dropout_bwd_plain``, equals autograd of the plain forward
    (fp32, rate 0.1, so the regenerated keep mask is in both)."""
    x, mask, bias = _layout(layout, seed=5)
    tx = torch.from_numpy(_np(x)).requires_grad_(True)
    ext = [None if e is None else torch.from_numpy(_np(e)).requires_grad_(True)
           for e in (mask, bias)]
    dy = torch.from_numpy(_np(np.random.RandomState(2).randn(*x.shape)))
    out = port_sd.softmax_dropout_plain(tx, 0.1, *ext, seed=77)
    leaves = [tx] + [e for e in ext if e is not None]
    ref = torch.autograd.grad(out, leaves, dy)
    ds = port_sd.softmax_dropout_bwd_plain(tx.detach(), ext[0], ext[1], dy, 0.1, 77)
    plans = [None if e is None else port_sd.plan_extra(tuple(e.shape), x.shape) for e in ext]
    got = [ds] + [port_sd._grad_reduce(ds, p, e) for p, e in zip(plans, ext) if e is not None]
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        _check(g.detach().numpy(), r.numpy(), GRAD_TOL, "grad")


def test_dropout_contract():
    """Rate 0.1: deterministic in the seed, the keep rate within 5 binomial
    sigmas, equal to ``p * keep / (1 - r)`` with the Philox mask, and the
    gradient equal to autograd of that formula."""
    rate, seed = 0.1, 1234
    x, _, bias = _layout("bcast", seed=9)
    tx = torch.from_numpy(_np(x)).requires_grad_(True)
    tb = torch.from_numpy(_np(bias))
    a = port_sd.softmax_dropout_plain(tx, rate, None, tb, seed)
    b = port_sd.softmax_dropout_plain(tx, rate, None, tb, seed)
    c = port_sd.softmax_dropout_plain(tx, rate, None, tb, seed + 1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    R, M, L = port_sd._rows(x.shape)
    keep = port_fr.philox_keep_plain(1, R, M, L, seed, rate).view(x.shape)
    rate_seen = keep.float().mean().item()
    sigma = math.sqrt(rate * (1 - rate) / keep.numel())
    assert abs(rate_seen - (1 - rate)) <= 5 * sigma
    assert torch.equal(a != 0, keep)
    p = torch.softmax(tx + tb, dim=-1)
    formula = torch.where(keep, p / (1 - rate), 0.0)
    np.testing.assert_allclose(a.detach().numpy(), formula.detach().numpy(),
                               rtol=1e-6, atol=FWD_TOL)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    g_plain, = torch.autograd.grad(a, tx, dy)
    g_formula, = torch.autograd.grad(formula, tx, dy)
    _check(g_plain.numpy(), g_formula.numpy(), GRAD_TOL, "dx")
    # the backward kernel's formula (dp = dy * fp32(1 / (1 - r))) too
    ds = port_sd.softmax_dropout_bwd_plain(tx.detach(), None, tb, dy, rate, seed)
    _check(ds.numpy(), g_formula.numpy(), GRAD_TOL, "ds")


def test_bf16_dropout_rounds_in_the_output_type():
    """bf16: kept values are the bf16 probability divided by (1 - rate)
    rounded to bf16, the quotient rounded to bf16 (the JAX kernel's
    ``y / (1.0 - rate)`` in the output type)."""
    x = torch.from_numpy(_np(np.random.RandomState(4).randn(2, 8, 128))).bfloat16()
    out = port_sd.softmax_dropout_plain(x, 0.1, seed=5)
    y = torch.softmax(x.float(), -1).bfloat16()
    div = torch.tensor(0.9).bfloat16().float()
    kept = out != 0
    ref = (y.float() / div).bfloat16()
    assert torch.equal(out[kept], ref[kept])


LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def _fma(a, b, c):
    """fp32 a * b + c with one rounding (exact product in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _kernel_probs(x):
    """The forward kernel's p of an fp32 (..., L): exp as exp2 of (v -
    max) log2(e) taken as one FMA, the row normalised by the correctly
    rounded reciprocal of its sum (csrc/softmax_dropout.cu row_probs)."""
    ml = x.amax(-1, keepdim=True) * LOG2E
    e = torch.exp2(_fma(x, LOG2E, -ml))
    return e * (1.0 / e.sum(-1, keepdim=True))


def _kernel_drop(y, keep, div):
    """The forward kernel's keep ? y / div : 0 on y (p rounded to the
    output type, as fp32 values): q = y (1 / div), then one FMA correction
    (drop_out), the quotient rounded to the output type by the caller."""
    rd = 1.0 / torch.tensor(div, dtype=torch.float32)
    q = y * rd
    return torch.where(keep, _fma(_fma(-q, torch.tensor(div), y), rd, q), 0.0)


@pytest.mark.parametrize("shape", [(16 * 64, 128, 128), (4, 12, 64, 1152)],
                         ids=["unimol", "L1152"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_arithmetic_holds_the_jax_kernel(shape, dtype):
    """The forward kernel's arithmetic, emulated in torch (no division an
    element: exp2 of a pre-scaled argument, one reciprocal a row, the
    dropout's quotient by a reciprocal and one FMA correction), against the
    JAX ``_row_probs`` and ``_fwd_kernel``'s ``y / (1.0 - rate)`` in the
    output type, at Uni-Mol's micro-batch and at L = 1152, rate 0.1 on the
    same Philox mask: within 1e-6 (chip_smoke.py's TOL["softmax"]) plus
    two bf16 ulps of the element in bf16."""
    rate, seed = 0.1, 31
    x = (2 * np.random.RandomState(len(shape)).randn(*shape)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    jp = jax_sdp._row_probs(jx[None], None, None)
    R, M, L = port_sd._rows(shape)
    keep = port_fr.philox_keep_plain(1, R, M, L, seed, rate).view(shape)
    jy = jp.astype(jdt)
    jout = jnp.where(jnp.asarray(keep.numpy()), jy / (1.0 - rate), 0.0).astype(jdt)
    jp = torch.from_numpy(np.array(jp))
    jout = torch.from_numpy(np.array(jout.astype(jnp.float32)))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    p = _kernel_probs(tx)
    assert (p - jp).abs().max().item() <= FWD_TOL
    y = p.to(tdt).float()
    out = _kernel_drop(y, keep, port_sd._keep_divisor(rate, tdt)).to(tdt).float()
    tol = FWD_TOL + (2 * BF16_ULP * jout.abs() if dtype == "bfloat16" else 0.0)
    assert bool(((out - jout).abs() <= tol).all()), (out - jout).abs().max().item()
    assert torch.equal(out != 0, keep & (jout != 0))


def test_routing():
    """A CPU tensor at a kernel shape takes the plain version with the
    Philox mask keyed on the DropoutRng's int32 seed; any other shape the
    plain composition with a Bernoulli mask from the DropoutRng's device
    generator (the JAX route); training dropout without a DropoutRng
    raises; nothing launches a kernel."""
    _kernels.reset_launch_counts()
    x = torch.randn(2, 4, 16, 128, generator=torch.Generator().manual_seed(1))
    got = port_sd.softmax_dropout(x, 0.1, True, rng=DropoutRng(3, "cpu", 0, 0))
    seed = DropoutRng(3, "cpu", 0, 0).kernel_seed()
    assert torch.equal(got, port_sd.softmax_dropout_plain(x, 0.1, seed=seed))
    # not a kernel shape (L = 100): the reference composition
    y = torch.randn(2, 4, 16, 100, generator=torch.Generator().manual_seed(2))
    a = port_sd.softmax_dropout(y, 0.1, True, rng=DropoutRng(3, "cpu", 0, 0))
    b = port_sd.softmax_dropout(y, 0.1, True, rng=DropoutRng(3, "cpu", 0, 0))
    assert torch.equal(a, b)
    zeros = (a == 0).float().mean().item()
    assert 0.05 < zeros < 0.15
    with pytest.raises(ValueError, match="DropoutRng"):
        port_sd.softmax_dropout(y, 0.1, True)
    # eval: no dropout, no DropoutRng needed
    np.testing.assert_allclose(port_sd.softmax_dropout(y, 0.1, False).numpy(),
                               torch.softmax(y, -1).numpy(), atol=1e-7)
    assert sum(_kernels.launch_counts().values()) == 0


def test_kernel_wrapper_refuses():
    """The CUDA wrapper raises on a shape outside the gate and on a CPU
    tensor (the kernels have no CPU mode)."""
    with pytest.raises(ValueError, match="refused"):
        port_sd.softmax_dropout_kernel(torch.zeros(2, 8, 100))
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_sd.softmax_dropout_kernel(torch.zeros(2, 8, 128))


def test_bert_trains_through_the_fused_route_with_dropout(tmp_path, monkeypatch):
    """The repaired fault: BERT at ``--seq-pad-multiple 8`` on short
    documents pads each batch far from the attention kernel's 128 tile, so
    its attention takes the fused-softmax route; with attention dropout in
    training that route used to raise NotImplementedError.  Two updates
    now train, with dropout drawn from the trainer's DropoutRng."""
    from test_torch_train import PORT_LOSSES, PortBertTask, PortTrainer, TINY, train_args
    from test_torch_train_data import write_corpus

    from unicore_tpu_torch.models.bert import BertModel

    data = str(tmp_path / "corpus")
    write_corpus(data, n_docs=24)
    args = train_args(data)
    args.seq_pad_multiple = 8
    task = PortBertTask.setup_task(args)
    task.load_dataset("train")
    itr = task.get_batch_iterator(task.dataset("train"), batch_size=2, seed=1)
    # lengths up to 96: padding to 128 would waste more than 1.6x
    group = [s for s in itr.next_epoch_itr(shuffle=True)
             if s["net_input"]["src_tokens"].shape[1] <= 96][:2]
    assert len(group) == 2
    routed = []
    reference = port_sd.softmax_dropout_reference

    def counting(input, rate, mask, bias, rng):
        routed.append((rate, rng is not None))
        return reference(input, rate, mask, bias, rng)

    monkeypatch.setattr(port_sd, "softmax_dropout_reference", counting)
    model = BertModel(vocab_size=len(task.dictionary), padding_idx=task.dictionary.pad(),
                      generator=torch.Generator().manual_seed(0),
                      **dict(TINY, attention_dropout=0.1, dropout=0.1))
    tr = PortTrainer(args, task, model, PORT_LOSSES["masked_lm"](task), "cpu")
    tr.begin_epoch(1)
    tr.train_step(group[:1])
    tr.train_step(group[1:])
    assert all(np.isfinite(tr.update_losses)) and len(tr.update_losses) == 2
    # 2 layers x 2 micro-batches, each with training dropout and a DropoutRng
    assert routed == [(0.1, True)] * 4
