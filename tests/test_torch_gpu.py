"""The port's CUDA kernels against their plain versions ON THE CARD, at
shapes the chip smoke does not reach (no bias, a shared bias, no mask,
Lq != Lk, head dims 8/12/16/128, 1024 key rows — the most shared memory
the kernels ask for inside the ``supported()`` gate; norm widths 8 to 8192
and tiny row counts; softmax rows of 128 to 8192 with every extra layout),
forward and backward, with and without dropout; the four flash kernels
(forward, dq, dk/dv, dbias) with every bias grouping, head dims 24 to 128,
1152 rows, Lq != Lk, fully masked rows and dropout, their Philox mask and
the dbias sum's repeatability; the decode attention (fp32, bf16, int8 caches
with fp32 and bf16 q, head dims 4 to 256, L of 1 to 512, mixed positions
with junk rows past them) and the shapes it refuses; the int8 serving
kernels (the W8A8 dense at every activation, with and without bias, odd M
and an exact-sum check past 2**24; the int8 LayerNorm with a scalar and a
per-channel scale; the int8/int32 softmax with every extra layout and
dropout) and their refusals; plus the wrappers'
refusals and a tiny BERT, a tiny Uni-Mol and a 2-block Evoformer on the card
against the same weights on the CPU, their outputs and every parameter's
gradient, and a 2-layer full-width ``transformer_lm`` whose incremental
decode on the card matches its full forward on the CPU.

Marked ``gpu``: each test takes the ``cuda`` fixture, which skips without a
card, so on the CPU every test here is skipped.  On a machine with a card
(which need not have JAX)::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py

Tolerances, kernel vs plain version on the same card inputs: fp32 2e-5
(attention) / 1e-5 (norm) absolute — the two differ only in summation
order; bf16 2e-2 (attention) / 6.25e-2 (norm) — last-bit fp32 differences
may round to neighbouring bf16 values (one ulp is 2**-4 below 16).  BERT
logits: 1e-4 absolute, card vs CPU in fp32 with TF32 off.

Softmax(+dropout): fp32 1e-6 absolute (probabilities, summation order
and exp's last bits); bf16 that plus two bf16 ulps of the element (2**-6
of it: the cast of p, and of the dropped quotient, may each land on a
neighbouring bf16 value).

Quantized kernels, vs their plain versions: the W8A8 dense 1e-6 of the
output's absmax (both sums exact; the activations' last bits differ); the
int8 LayerNorm 1e-5 and the int8/int32 softmax 1e-6 absolute, as their
unquantized kernels.  A 2-layer BERT prepared on the CPU (int8 and fp8),
card vs CPU: 5e-3 of the logit absmax and argmax equal on 99% of the
positions (a rare activation may round to the neighbouring int8 step).

Decode attention, kernel vs ``decode_attention_plain``: fp32 q 1e-5
absolute (int8 caches included: both dequantize in fp32 and differ only in
summation order); bf16 q two bf16 ulps of the element plus 1e-6 (both round
one fp32 result once).  Incremental decode of the 2-layer LM on the card vs
its full forward on the CPU: 1e-4 absolute and relative on logits, as the
JAX package's parity test holds it.

The full-row backward at BERT-base's (8, 12, 512, 64) with dropout; its
dq, dk and dv bit for bit across two calls (no atomics), dbias within its
tolerance; the forward's row statistics written only when a backward
follows (not under ``torch.no_grad()``), and equal to the plain
log-sum-exp within 1e-5.

Gradients, kernel vs autograd of the plain version (for the attention
backward in bf16, vs ``fullrow_attention_bwd_plain``, which rounds pd and
ds as the kernel does; for the softmax backward in bf16, vs
``softmax_dropout_bwd_plain``, which keeps dp in fp32 as the kernel does),
per element as chip_smoke.py holds them: 1e-4 (attention, full-row and
flash) / 1e-5 (norm, softmax) of the reference's largest magnitude (at
least 1) — both backwards recompute p from the forward's lse, and the
full-row dbias is a sum added by atomics in an order that changes from run
to run — plus two bf16 ulps of the
element (2**-6 of it) where the output is stored in bf16, plus for the
attention backward in bf16 ``bwd_rounding_slack`` (pd and ds may round to
neighbouring bf16 values).  BERT gradients: 1e-4 relative to each
tensor's largest magnitude, card vs CPU.
"""

import pytest
import torch

from unicore_tpu_torch.models.bert import BertModel
from unicore_tpu_torch.ops import _kernels
from unicore_tpu_torch.ops import attention_fullrow as fr
from unicore_tpu_torch.ops import fused_norm as fn
from unicore_tpu_torch.ops import softmax_dropout as sd

pytestmark = pytest.mark.gpu

TOL = {
    "attention": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
    "norm": {torch.float32: 1e-5, torch.bfloat16: 6.25e-2},
    "softmax": 1e-6,
}
GRAD_TOL = {"attention": 1e-4, "norm": 1e-5, "softmax": 1e-5}
BF16_ULPS = 2.0 ** -6


def _rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp(min=1.0)).item()


def _grad_over_tol(got, ref, floor, slack=0.0):
    """The largest error of a gradient over its per-element tolerance."""
    ref = ref.float()
    tol = floor * max(1.0, ref.abs().max().item()) + slack
    if got.dtype == torch.bfloat16:
        tol = tol + BF16_ULPS * ref.abs()
    return ((got.float() - ref).abs() / tol).max().item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "B,H,Lq,Lk,D,bias_heads,masked,dtype",
    [
        (2, 3, 128, 128, 16, None, False, torch.float32),
        (2, 3, 128, 256, 64, 1, True, torch.float32),
        (1, 2, 128, 1024, 128, 2, True, torch.float32),  # L 1024, D 128
        (2, 2, 128, 128, 12, None, True, torch.float32),
        (2, 2, 384, 384, 8, 2, True, torch.bfloat16),
        (1, 1, 256, 768, 64, None, False, torch.bfloat16),
    ],
)
def test_attention_kernel_matches_plain(cuda, B, H, Lq, Lk, D, bias_heads,
                                        masked, dtype):
    g = torch.Generator(device=cuda).manual_seed(Lq * 7 + D)
    q = (torch.randn(B, H, Lq, D, generator=g, device=cuda) * D ** -0.5).to(dtype)
    k = torch.randn(B, H, Lk, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, H, Lk, D, generator=g, device=cuda).to(dtype)
    bias = (None if bias_heads is None else
            torch.randn(1, bias_heads, Lq, Lk, generator=g, device=cuda))
    mask = None
    if masked:
        lens = torch.linspace(Lk, 1, B, device=cuda).long()
        lens[-1] = 0 if B > 1 else lens[-1]
        mask = (torch.arange(Lk, device=cuda)[None, :] >= lens[:, None]).to(torch.int32)
    out = fr.fullrow_attention(q, k, v, bias=bias, kv_padding_mask=mask)
    ref = fr.fullrow_attention_plain(q, k, v, bias, mask)
    assert out.dtype == dtype and out.shape == q.shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL["attention"][dtype], err
    if masked and B > 1:
        assert out[-1].abs().max().item() == 0.0  # fully-masked row


@pytest.mark.parametrize("N,D", [(1, 8), (5, 33), (1000, 768), (3, 4096), (7, 8192)])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_kernel_matches_plain(cuda, N, D, rms, dtype):
    g = torch.Generator(device=cuda).manual_seed(N * 31 + D)
    x = (torch.randn(2, N, D, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    w = 1 + 0.1 * torch.randn(D, generator=g, device=cuda)
    b = None if rms else 0.1 * torch.randn(D, generator=g, device=cuda)
    out = fn.fused_rms_norm(x, w) if rms else fn.fused_layer_norm(x, w, b)
    ref = fn.fused_norm_plain(x, w, b, 1e-6 if rms else 1e-5, rms)
    assert out.dtype == dtype and out.shape == x.shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL["norm"][dtype], err


def test_launch_counters_and_refusals(cuda):
    q = torch.randn(1, 1, 128, 16, device=cuda)
    x = torch.randn(4, 32, device=cuda)
    w = torch.ones(32, device=cuda)
    _kernels.reset_launch_counts()
    fr.fullrow_attention(q, q, q)
    fn.fused_layer_norm(x, w, torch.zeros(32, device=cuda))
    fn.fused_rms_norm(x, w)
    assert fr.LAUNCHES.count == 1 and fn.LAUNCHES.count == 2
    with pytest.raises(ValueError, match="fp32/bf16"):
        fr.fullrow_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        fr.fullrow_attention(q.transpose(2, 3).contiguous().transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="fp32"):
        fn.fused_layer_norm(x, w.half(), None)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn.fused_layer_norm(x, w.cpu(), None)
    with pytest.raises(ValueError, match="dropout rate"):
        fr.fullrow_attention(q, q, q, dropout_rate=1.0)
    # refused calls launch nothing
    assert fr.LAUNCHES.count == 1 and fn.LAUNCHES.count == 2


@pytest.mark.parametrize("post_ln", [True, False])
def test_tiny_bert_on_card_matches_cpu(cuda, post_ln):
    gen = torch.Generator().manual_seed(3)
    model = BertModel(vocab_size=50, padding_idx=1, encoder_layers=2,
                      encoder_embed_dim=64, encoder_ffn_embed_dim=128,
                      encoder_attention_heads=4, max_seq_len=256,
                      post_ln=post_ln, generator=gen).eval()
    tok = torch.randint(4, 50, (3, 256), generator=gen)
    tok[1, 100:] = 1
    with torch.inference_mode():
        ref = model(tok)
        model.to(cuda)
        _kernels.reset_launch_counts()
        out = model(tok.to(cuda)).cpu()
    assert fr.LAUNCHES.count == 2  # one per layer
    assert fn.LAUNCHES.count == (6 if post_ln else 7)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


def _attention_inputs(cuda, B, H, Lq, Lk, D, bias_heads, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = (torch.randn(B, H, Lq, D, generator=g, device=cuda) * D ** -0.5).to(dtype)
    k = torch.randn(B, H, Lk, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, H, Lk, D, generator=g, device=cuda).to(dtype)
    do = torch.randn(B, H, Lq, D, generator=g, device=cuda).to(dtype)
    bias = (None if bias_heads is None else
            torch.randn(1, bias_heads, Lq, Lk, generator=g, device=cuda))
    lens = torch.linspace(Lk, Lk // 3, B, device=cuda).long()
    lens[-1] = 0 if B > 1 else lens[-1]  # a fully-masked row
    mask = (torch.arange(Lk, device=cuda)[None, :] >= lens[:, None]).to(torch.int32)
    return q, k, v, do, bias, mask


def _attention_grads(fn, q, k, v, do, bias, mask, **kw):
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    b = None if bias is None else bias.detach().clone().requires_grad_(True)
    out = fn(*leaves, b, mask, **kw)
    out.backward(do)
    return out.detach(), [t.grad for t in leaves] + ([] if b is None else [b.grad])


@pytest.mark.parametrize(
    "B,H,Lq,Lk,D,bias_heads,dropout,dtype",
    [
        (2, 2, 128, 128, 32, None, 0.0, torch.float32),
        (2, 3, 256, 256, 64, 1, 0.0, torch.float32),
        (2, 3, 512, 512, 64, 3, 0.1, torch.float32),
        (2, 2, 384, 384, 128, 2, 0.0, torch.float32),
        (2, 2, 256, 256, 12, 1, 0.1, torch.float32),  # D not a multiple of 8
        (1, 2, 128, 1024, 128, 2, 0.1, torch.float32),  # 202 KB of smem (dq)
        (2, 2, 256, 1024, 64, 1, 0.0, torch.float32),
        (2, 3, 512, 512, 64, 3, 0.1, torch.bfloat16),
        (2, 2, 768, 768, 32, None, 0.2, torch.bfloat16),
        # the main paths' shape: BERT-base at L = 512, dropout 0.1
        (8, 12, 512, 512, 64, 12, 0.1, torch.float32),
    ],
)
def test_attention_backward_matches_plain(cuda, B, H, Lq, Lk, D, bias_heads,
                                          dropout, dtype):
    q, k, v, do, bias, mask = _attention_inputs(cuda, B, H, Lq, Lk, D, bias_heads,
                                                dtype, seed=Lk + D)
    kw = dict(dropout_rate=dropout, sm_scale=0.7, dropout_seed=1234)
    _kernels.reset_launch_counts()
    out, grads = _attention_grads(
        lambda q, k, v, b, m, **a: fr.fullrow_attention(q, k, v, bias=b,
                                                       kv_padding_mask=m, **a),
        q, k, v, do, bias, mask, **kw)
    assert fr.LAUNCHES.count == 1 and fr.BWD_LAUNCHES.count == 1
    ref_out, ref_grads = _attention_grads(
        lambda q, k, v, b, m, **a: fr.fullrow_attention_plain(
            q, k, v, b, m, a["sm_scale"], a["dropout_rate"], a["dropout_seed"]),
        q, k, v, do, bias, mask, **kw)
    assert (out.float() - ref_out.float()).abs().max().item() <= \
        TOL["attention"][dtype] * max(1.0, ref_out.float().abs().max().item())
    slack = [0.0] * 4
    if dtype == torch.bfloat16:
        args = (q, k, v, bias, mask, do, 0.7, dropout, 1234)
        ref_grads = fr.fullrow_attention_bwd_plain(*args)
        slack = [*fr.bwd_rounding_slack(*args), 0.0]
    for name, got, ref, s in zip(("dq", "dk", "dv", "dbias"), grads, ref_grads, slack):
        assert got.shape == ref.shape, name
        assert got.dtype == (torch.float32 if name == "dbias" else dtype), name
        ratio = _grad_over_tol(got, ref, GRAD_TOL["attention"], s)
        assert ratio <= 1.0, (name, ratio)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_repeats_bit_for_bit(cuda, dtype):
    """dq, dk and dv are each written once by one block (no atomics), so two
    backward calls on the same inputs give the same bits; dbias, summed over
    the batch by atomics, within its fp32 tolerance."""
    q, k, v, do, bias, mask = _attention_inputs(cuda, 8, 12, 512, 512, 64, 12, dtype,
                                                seed=5)
    o, lse = fr._launch_fwd(q, k, v, bias, mask, 0.125, 0.1, 7, True)
    first = fr._launch_bwd(q, k, v, bias, mask, o, do, lse, 0.125, 0.1, 7, True)
    second = fr._launch_bwd(q, k, v, bias, mask, o, do, lse, 0.125, 0.1, 7, True)
    for name, a, b in zip(("dq", "dk", "dv"), first[:3], second[:3]):
        assert torch.equal(a, b), name
    assert _grad_over_tol(second[3], first[3], GRAD_TOL["attention"]) <= 1.0


def test_attention_row_statistics_only_for_a_backward(cuda, monkeypatch):
    """The forward writes its (B, H, Lq) fp32 lse only when a backward will
    follow: not under ``torch.no_grad()`` (the serving path), nor for inputs
    that need no gradient; with one, lse is the plain log-sum-exp of the
    scores (0 for a fully masked row)."""
    q, k, v, _, bias, mask = _attention_inputs(cuda, 2, 3, 256, 256, 64, 3,
                                               torch.float32, seed=9)
    seen = []
    launch = fr._launch_fwd

    def spy(*args):
        out = launch(*args)
        seen.append(out[1])
        return out

    monkeypatch.setattr(fr, "_launch_fwd", spy)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    with torch.no_grad():
        fr.fullrow_attention(*leaves, bias=bias, kv_padding_mask=mask)
    fr.fullrow_attention(q, k, v, bias=bias, kv_padding_mask=mask)
    assert seen == [None, None]
    fr.fullrow_attention(*leaves, bias=bias, kv_padding_mask=mask, sm_scale=0.5)
    lse = seen[-1]
    assert lse.shape == (2, 3, 256) and lse.dtype == torch.float32
    ref = fr.fullrow_lse_plain(q, k, bias, mask, 0.5)
    assert (lse - ref).abs().max().item() <= 1e-5
    assert (lse[-1] == 0).all()  # the fully masked batch row


def test_attention_dropout_mask_is_philox(cuda):
    """With q = k = 0 every kept probability is 1/L scaled, and v = I makes
    the output the dropped probability row itself: the kernel's mask read
    off the card equals the plain Philox mask bit for bit."""
    B, H, L, rate, seed = 2, 3, 128, 0.1, 77
    z = torch.zeros(B, H, L, L, device=cuda)
    eye = torch.eye(L, device=cuda).expand(B, H, L, L).contiguous()
    out = fr.fullrow_attention(z, z, eye, dropout_rate=rate, dropout_seed=seed)
    keep = fr.philox_keep_plain(B, H, L, L, seed, rate, device=cuda)
    assert torch.equal(out != 0, keep)
    other = fr.fullrow_attention(z, z, eye, dropout_rate=rate, dropout_seed=seed + 1)
    assert not torch.equal(out != 0, other != 0)


@pytest.mark.parametrize("N,D", [(1, 8), (5, 33), (1000, 768), (129, 1024),
                                 (3, 4096), (7, 8192)])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_backward_matches_plain(cuda, N, D, rms, dtype):
    g = torch.Generator(device=cuda).manual_seed(N * 17 + D)
    x = (torch.randn(2, N, D, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    dy = torch.randn(2, N, D, generator=g, device=cuda).to(dtype)
    w = 1 + 0.1 * torch.randn(D, generator=g, device=cuda)
    b = None if rms else 0.1 * torch.randn(D, generator=g, device=cuda)
    eps = 1e-6 if rms else 1e-5

    def grads(fn):
        xs = x.clone().requires_grad_(True)
        ws = w.clone().requires_grad_(True)
        bs = None if b is None else b.clone().requires_grad_(True)
        fn(xs, ws, bs).backward(dy)
        return [xs.grad, ws.grad] + ([] if bs is None else [bs.grad])

    _kernels.reset_launch_counts()
    got = grads(lambda x, w, b: fn.fused_rms_norm(x, w, eps) if rms
                else fn.fused_layer_norm(x, w, b, eps))
    assert (fn.LAUNCHES.count, fn.DX_LAUNCHES.count, fn.DWDB_LAUNCHES.count) == (1, 1, 1)
    ref = grads(lambda x, w, b: fn.fused_norm_plain(x, w, b, eps, rms))
    for name, gk, gr in zip(("dx", "dw", "db"), got, ref):
        assert gk.dtype == gr.dtype and gk.shape == gr.shape, name
        ratio = _grad_over_tol(gk, gr, GRAD_TOL["norm"])
        assert ratio <= 1.0, (name, ratio)


@pytest.mark.parametrize("post_ln", [True, False])
def test_tiny_bert_gradients_on_card_match_cpu(cuda, post_ln):
    """Every parameter of a 2-layer BERT gets a finite gradient on the card,
    equal to the CPU plain path's (a CUDA kernel output cut from autograd
    would leave the parameters below it without one)."""
    from unicore_tpu_torch.modules import DropoutRng

    gen = torch.Generator().manual_seed(5)
    model = BertModel(vocab_size=50, padding_idx=1, encoder_layers=2,
                      encoder_embed_dim=64, encoder_ffn_embed_dim=128,
                      encoder_attention_heads=4, max_seq_len=256, dropout=0.0,
                      emb_dropout=0.0, attention_dropout=0.1, post_ln=post_ln,
                      generator=gen).train()
    tok = torch.randint(4, 50, (3, 256), generator=gen)
    tok[1, 100:] = 1
    pos = torch.stack([torch.randperm(256, generator=gen)[:20] for _ in range(3)])

    def grads(device):
        model.to(device).zero_grad()
        rng = DropoutRng(7, device, 0, 0)
        model(tok.to(device), pos.to(device), rng=rng).float().square().mean().backward()
        return {n: None if p.grad is None else p.grad.detach().cpu().clone()
                for n, p in model.named_parameters()}

    ref = grads(torch.device("cpu"))
    _kernels.reset_launch_counts()
    got = grads(cuda)
    assert fr.BWD_LAUNCHES.count == 2
    assert fn.DX_LAUNCHES.count == fn.LAUNCHES.count == (6 if post_ln else 7)
    for name, g in got.items():
        assert g is not None, f"{name}: no gradient on the card"
        assert torch.isfinite(g).all(), name
        assert _rel_err(g, ref[name]) <= 1e-4, name


def _softmax_case(cuda, shape, mask_shape, bias_shape, dtype, seed, neg_inf=False):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (2 * torch.randn(shape, generator=g, device=cuda)).to(dtype)
    if neg_inf:  # padded keys: whole -inf columns, as in Uni-Mol's pair bias
        x[..., shape[-1] - 40:] = float("-inf")
    mask = (None if mask_shape is None else
            torch.where(torch.rand(mask_shape, generator=g, device=cuda) < 0.2, -1e9, 0.0))
    bias = None if bias_shape is None else torch.randn(bias_shape, generator=g, device=cuda)
    dy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    return x, mask, bias, dy


@pytest.mark.parametrize(
    "shape,mask_shape,bias_shape,dtype,rate,neg_inf",
    [
        ((64, 128, 128), None, None, torch.float32, 0.1, False),
        ((2, 8, 64, 128), None, None, torch.float32, 0.1, True),
        ((2, 4, 16, 256), (2, 1, 1, 256), (1, 4, 16, 256), torch.float32, 0.1, False),
        ((6, 16, 384), None, (2, 16, 384), torch.float32, 0.0, False),  # tile
        ((2, 3, 4, 8, 512), (1, 3, 1, 1, 512), (2, 1, 4, 8, 512), torch.float32, 0.1,
         False),  # the Evoformer's mixed per-dim broadcast
        ((4, 8, 1024), None, (8, 1024), torch.float32, 0.1, False),
        ((2, 8, 1152), (2, 1, 1152), None, torch.float32, 0.1, False),  # block rows
        ((1, 8, 8192), None, (1, 8, 8192), torch.float32, 0.2, False),
        ((16, 64, 128), None, None, torch.bfloat16, 0.1, True),
        ((2, 4, 8, 2048), (2, 1, 1, 2048), (1, 4, 8, 2048), torch.bfloat16, 0.1, False),
        ((8192, 8, 128), None, None, torch.float32, 0.1, False),  # many rows
    ],
)
def test_softmax_dropout_kernels_match_plain(cuda, shape, mask_shape, bias_shape, dtype,
                                             rate, neg_inf):
    x, mask, bias, dy = _softmax_case(cuda, shape, mask_shape, bias_shape, dtype,
                                      seed=shape[-1] + len(shape), neg_inf=neg_inf)
    seed = 4321

    def run(fwd):
        leaves = [t.clone().requires_grad_(True) for t in (x, mask, bias) if t is not None]
        it = iter(leaves[1:])
        m = next(it) if mask is not None else None
        b = next(it) if bias is not None else None
        out = fwd(leaves[0], rate, m, b, seed)
        return out.detach(), torch.autograd.grad(out, leaves, dy)

    _kernels.reset_launch_counts()
    out, grads = run(sd.softmax_dropout_kernel)
    assert sd.FWD_LAUNCHES.count == 1 and sd.BWD_LAUNCHES.count == 1
    ref_out, ref_grads = run(sd.softmax_dropout_plain)
    assert out.dtype == dtype and out.shape == x.shape
    tol = TOL["softmax"] + (2.0 ** -6 * ref_out.float().abs() if dtype == torch.bfloat16 else 0)
    err = (out.float() - ref_out.float()).abs()
    assert bool((err <= tol).all()), err.max().item()
    if dtype == torch.bfloat16:  # the kernel's backward keeps dp in fp32
        ds = sd.softmax_dropout_bwd_plain(x, mask, bias, dy, rate, seed)
        plans = [sd.plan_extra(tuple(t.shape), tuple(x.shape)) for t in (mask, bias)
                 if t is not None]
        ref_grads = [ds] + [sd._grad_reduce(ds, p, t) for p, t in
                            zip(plans, [t for t in (mask, bias) if t is not None])]
    for got, ref in zip(grads, ref_grads):
        assert got.shape == ref.shape and torch.isfinite(got).all()
        ratio = _grad_over_tol(got, ref, GRAD_TOL["softmax"])
        assert ratio <= 1.0, ratio
    if neg_inf:
        assert out[..., -40:].abs().max().item() == 0.0
        assert grads[0][..., -40:].abs().max().item() == 0.0


@pytest.mark.parametrize("L", [128, 640, 2048])
def test_softmax_dropout_mask_is_philox(cuda, L):
    """x = 0 makes every kept value 1/L scaled: the kernel's mask read off
    the card equals ``philox_keep_plain(1, R, M, L)`` bit for bit."""
    R, M, rate, seed = 6, 16, 0.1, 99
    out = sd.softmax_dropout_kernel(torch.zeros(R, M, L, device=cuda), rate, seed=seed)
    keep = fr.philox_keep_plain(1, R, M, L, seed, rate, device=cuda).view(R, M, L)
    assert torch.equal(out != 0, keep)
    other = sd.softmax_dropout_kernel(torch.zeros(R, M, L, device=cuda), rate, seed=seed + 1)
    assert not torch.equal(out != 0, other != 0)


def test_softmax_dropout_routing_and_refusals(cuda):
    from unicore_tpu_torch.modules import DropoutRng

    x = torch.randn(2, 4, 16, 128, device=cuda)
    _kernels.reset_launch_counts()
    sd.softmax_dropout(x, 0.1, True, rng=DropoutRng(1, cuda, 0, 0))
    sd.softmax_dropout(x, 0.1, False)
    assert sd.FWD_LAUNCHES.count == 2
    # not a kernel shape: the plain composition, no launch
    y = sd.softmax_dropout(torch.randn(2, 4, 16, 100, device=cuda), 0.1, True,
                           rng=DropoutRng(1, cuda, 0, 0))
    assert y.is_cuda and sd.FWD_LAUNCHES.count == 2
    with pytest.raises(ValueError, match="refused"):
        sd.softmax_dropout_kernel(x.half())
    with pytest.raises(ValueError, match="refused"):
        sd.softmax_dropout_kernel(torch.zeros(2, 8, 100, device=cuda))
    with pytest.raises(ValueError, match="CUDA tensor"):
        sd.softmax_dropout_kernel(x, bias=torch.zeros(1, 4, 16, 128))
    with pytest.raises(ValueError, match="dropout rate"):
        sd.softmax_dropout_kernel(x, 1.0)
    assert sd.FWD_LAUNCHES.count == 2


def test_tiny_unimol_gradients_on_card_match_cpu(cuda):
    """A 2-layer Uni-Mol at L = 128 with padded rows and attention dropout
    0.1 (Philox on both sides): loss and every parameter's gradient on the
    card equal the CPU plain path's, through 2 softmax_dropout forward and
    backward launches and 9 of each norm kernel."""
    from unicore_tpu_torch.losses.unimol import UniMolLoss
    from unicore_tpu_torch.models.unimol import UniMolModel
    from unicore_tpu_torch.modules import DropoutRng
    from argparse import Namespace

    gen = torch.Generator().manual_seed(2)
    V, B, L = 14, 3, 128
    model = UniMolModel(vocab_size=V, padding_idx=0, encoder_layers=2,
                        encoder_embed_dim=64, encoder_ffn_embed_dim=128,
                        encoder_attention_heads=8, gaussian_kernels=32, dropout=0.0,
                        emb_dropout=0.0, attention_dropout=0.1, masked_coord_loss=5.0,
                        masked_dist_loss=10.0, generator=gen).train()
    tok = torch.randint(4, V, (B, L), generator=gen)
    tok[1, 90:] = 0
    tok[2, 40:] = 0
    coord = torch.randn(B, L, 3, generator=gen).cumsum(1)
    dist = (coord[:, :, None] - coord[:, None]).square().sum(-1).add(1e-12).sqrt()
    tgt = torch.where((torch.rand(B, L, generator=gen) < 0.15) & (tok != 0), tok, 0)
    sample = {"net_input": {"src_tokens": tok, "src_coord": coord, "src_distance": dist,
                            "src_edge_type": tok[:, :, None] * V + tok[:, None, :]},
              "target": {"tokens_target": tgt, "coord_target": coord,
                         "distance_target": dist}}

    class Task:
        dictionary = Namespace(pad=lambda: 0)
        args = Namespace()

    def run(device):
        model.to(device).zero_grad()
        dev_sample = {k: {n: t.to(device) for n, t in v.items()} for k, v in sample.items()}
        loss, _, _ = UniMolLoss(Task)(model, dev_sample, rng=DropoutRng(7, device, 0, 0))
        loss.backward()
        return loss.item(), {n: p.grad.detach().cpu().clone()
                             for n, p in model.named_parameters()}

    ref_loss, ref = run(torch.device("cpu"))
    _kernels.reset_launch_counts()
    loss, got = run(cuda)
    assert sd.FWD_LAUNCHES.count == sd.BWD_LAUNCHES.count == 2
    assert fn.LAUNCHES.count == fn.DX_LAUNCHES.count == fn.DWDB_LAUNCHES.count == 9
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for name, g in got.items():
        assert torch.isfinite(g).all(), name
        assert _rel_err(g, ref[name]) <= 1e-4, name


def _flash_inputs(device, B, H, Lq, Lk, D, bias_shape, masked, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q = (torch.randn(B, H, Lq, D, generator=g, device=device) * D ** -0.5).to(dtype)
    k, v = (torch.randn(B, H, Lk, D, generator=g, device=device).to(dtype) for _ in range(2))
    do = torch.randn(B, H, Lq, D, generator=g, device=device).to(dtype)
    bias = None if bias_shape is None else torch.randn(bias_shape, generator=g, device=device)
    mask = None
    if masked:
        lens = torch.linspace(Lk, Lk // 3, B, device=device).long()
        lens[-1] = 0  # a fully masked row
        mask = (torch.arange(Lk, device=device)[None] >= lens[:, None]).to(torch.int32)
    return q, k, v, do, bias, mask


@pytest.mark.parametrize(
    "B,H,Lq,Lk,D,bias_shape,masked,dropout,dtype",
    [
        # the Evoformer's batch-1 triangle and MSA-row attentions: one slab
        # for 256 / 32 lead rows (dbias splits them into chunks)
        (256, 4, 256, 256, 32, (1, 4, 256, 256), True, 0.0, torch.float32),
        (32, 8, 256, 256, 32, (1, 8, 256, 256), True, 0.0, torch.float32),
        (256, 4, 256, 256, 32, (1, 4, 256, 256), True, 0.0, torch.bfloat16),
        (32, 8, 256, 256, 32, (1, 8, 256, 256), True, 0.0, torch.bfloat16),
        (4, 2, 128, 128, 32, (1, 2, 128, 128), True, 0.0, torch.float32),
        (4, 2, 256, 256, 32, (2, 1, 256, 256), True, 0.0, torch.float32),  # grouped, Hb 1
        (3, 2, 128, 384, 64, (3, 2, 128, 384), False, 0.1, torch.float32),  # per batch
        (2, 2, 128, 128, 24, None, True, 0.0, torch.float32),  # D not a multiple of 16
        (2, 1, 256, 128, 128, (1, 1, 256, 128), True, 0.1, torch.float32),
        (2, 2, 1152, 1152, 64, None, True, 0.1, torch.float32),  # past the full-row gate
        (4, 2, 256, 256, 32, (2, 2, 256, 256), True, 0.0, torch.bfloat16),
        (2, 2, 128, 256, 128, (1, 1, 128, 256), False, 0.1, torch.bfloat16),
    ],
)
def test_flash_kernels_match_plain(cuda, B, H, Lq, Lk, D, bias_shape, masked, dropout,
                                   dtype):
    """The four flash kernels (forward, dq, dk/dv, dbias) through the
    autograd Function against the plain version on the same card inputs:
    fp32 vs autograd of ``flash_attention_plain``; bf16 vs
    ``flash_attention_bwd_plain`` from the kernel's own output and lse."""
    from unicore_tpu_torch.ops import flash_attention as fa

    q, k, v, do, bias, mask = _flash_inputs(cuda, B, H, Lq, Lk, D, bias_shape, masked,
                                            dtype, seed=Lq + D)
    kw = dict(sm_scale=0.7, dropout_rate=dropout, dropout_seed=99)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias) if t is not None]
    _kernels.reset_launch_counts()
    out = fa.flash_attention(*leaves[:3], bias=leaves[3] if bias is not None else None,
                             kv_padding_mask=mask, **kw)
    grads = torch.autograd.grad(out, leaves, do)
    counts = (fa.FWD_LAUNCHES.count, fa.DQ_LAUNCHES.count, fa.DKV_LAUNCHES.count,
              fa.DB_LAUNCHES.count)
    assert counts == (1, 1, 1, int(bias is not None)), counts
    ref_out, lse = fa.flash_attention_fwd_plain(q, k, v, bias, mask, 0.7, dropout, 99)
    assert (out.float() - ref_out.float()).abs().max().item() <= \
        TOL["attention"][dtype] * max(1.0, ref_out.float().abs().max().item())
    _, klse = fa._launch_fwd(q, k, v, bias, mask, 0.7, dropout, 99)
    live = lse > -1e29
    assert (klse - lse)[live].abs().max().item() <= 1e-4 and bool((klse[~live] <= -1e29).all())
    if masked:
        assert out[-1].abs().max().item() == 0.0 and grads[0][-1].abs().max().item() == 0.0
    slack = [0.0] * 4
    if dtype == torch.bfloat16:
        args = (q, k, v, bias, mask, out.detach(), klse, do, 0.7, dropout, 99)
        ref_grads = fa.flash_attention_bwd_plain(*args)
        slack = [*fa.bwd_rounding_slack(*args), 0.0]
    else:
        rl = [t.clone().requires_grad_(True) for t in (q, k, v, bias) if t is not None]
        ref_grads = torch.autograd.grad(
            fa.flash_attention_plain(*rl[:3], rl[3] if bias is not None else None, mask,
                                     0.7, dropout, 99), rl, do)
    for name, got, ref, s in zip(("dq", "dk", "dv", "dbias"), grads, ref_grads, slack):
        assert got.shape == ref.shape and got.dtype == ref.dtype, name
        ratio = _grad_over_tol(got, ref, GRAD_TOL["attention"], s)
        assert ratio <= 1.0, (name, ratio)


def test_flash_dropout_mask_is_the_fullrow_one(cuda):
    """q = k = 0 and v = I: the flash kernel's output is its dropped
    probability row, and its mask equals the full-row kernel's and the
    plain Philox mask bit for bit; the dbias partial sums repeat to the bit."""
    from unicore_tpu_torch.ops import flash_attention as fa

    B, H, L, rate, seed = 2, 3, 128, 0.1, 77
    z = torch.zeros(B, H, L, L, device=cuda)
    eye = torch.eye(L, device=cuda).expand(B, H, L, L).contiguous()
    out = fa.flash_attention(z, z, eye, dropout_rate=rate, dropout_seed=seed)
    keep = fr.philox_keep_plain(B, H, L, L, seed, rate, device=cuda)
    assert torch.equal(out != 0, keep)
    assert torch.equal(out != 0, fr.fullrow_attention(z, z, eye, dropout_rate=rate,
                                                      dropout_seed=seed) != 0)
    q, k, v, do, bias, mask = _flash_inputs(cuda, 8, 2, 128, 128, 32, (1, 2, 128, 128),
                                            True, torch.float32, seed=5)
    _, lse = fa._launch_fwd(q, k, v, bias, mask, 1.0, 0.0, 0)
    di = torch.randn(8, 2, 128, device=cuda)
    a = fa._launch_db(q, k, v, bias, mask, lse, di, do, 1.0, 0.0, 0)
    b = fa._launch_db(q, k, v, bias, mask, lse, di, do, 1.0, 0.0, 0)
    assert torch.equal(a, b)


def test_flash_refusals(cuda):
    """A CUDA call launches the kernels or raises: CPU tensors mixed in,
    fp16, a bias that is not fp32."""
    from unicore_tpu_torch.ops import flash_attention as fa

    q = torch.zeros(2, 2, 128, 32, device=cuda)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention(q, q, q, bias=torch.zeros(1, 2, 128, 128))
    with pytest.raises(ValueError, match="fp32/bf16"):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="bias must be fp32"):
        fa.flash_attention(q, q, q, bias=torch.zeros(1, 2, 128, 128, device=cuda).half())


def test_tiny_evoformer_gradients_on_card_match_cpu(cuda):
    """A 2-block Evoformer whose MSA-row and triangle attentions take the
    flash route (msa 64 / 8 heads, pair 32 / 4, L = 128 with padded
    residues, batch 2 so the bias is grouped), dropout 0 (the row-wise
    dropout's Bernoulli draws differ between devices): loss and every
    parameter's gradient on the card equal the CPU's.  Launches: 6 flash
    forwards (3 per block) and 25 norm forwards (12 per block and the final
    norm); the last block's pair updates (its two triangle attentions and
    eight of its norms) do not reach the masked-MSA loss, so autograd runs
    4 of each flash backward kernel and 17 norm backwards."""
    from unicore_tpu_torch.losses.masked_msa import MaskedMSALoss
    from unicore_tpu_torch.models.evoformer_model import EvoformerModel
    from unicore_tpu_torch.ops import flash_attention as fa
    from argparse import Namespace

    gen = torch.Generator().manual_seed(4)
    model = EvoformerModel(vocab_size=26, padding_idx=1, num_blocks=2, msa_dim=64,
                           pair_dim=32, msa_heads=8, pair_heads=4, dropout=0.0,
                           max_seq_len=128, generator=gen)
    with torch.no_grad():  # move the zero-init projections so every path has gradient
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    model.train()
    src = torch.randint(4, 25, (2, 8, 128), generator=gen)
    src[1, :, 110:] = 1
    src[0, 6:] = 1
    tgt = torch.where(torch.rand(src.shape, generator=gen) < 0.15, src, 1)

    class Task:
        dictionary = Namespace(pad=lambda: 1)
        args = Namespace()

    def run(device):
        model.to(device).zero_grad()
        sample = {"net_input": {"src_msa": src.to(device)}, "target": tgt.to(device)}
        loss, _, _ = MaskedMSALoss(Task)(model, sample)
        loss.backward()
        return loss.item(), {n: p.grad.detach().cpu().clone()
                             for n, p in model.named_parameters() if p.grad is not None}

    ref_loss, ref = run(torch.device("cpu"))
    _kernels.reset_launch_counts()
    loss, got = run(cuda)
    assert (fa.FWD_LAUNCHES.count, fa.DQ_LAUNCHES.count, fa.DKV_LAUNCHES.count,
            fa.DB_LAUNCHES.count) == (6, 4, 4, 4)
    assert fn.LAUNCHES.count == 25 and fn.DX_LAUNCHES.count == fn.DWDB_LAUNCHES.count == 17
    assert fr.LAUNCHES.count == 0
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    assert set(got) == set(ref)
    for name, g in got.items():
        assert torch.isfinite(g).all(), name
        assert _rel_err(g, ref[name]) <= 1e-4, name


@pytest.mark.parametrize(
    "B,H,L,D,dtype,kv,with_bias",
    [
        (8, 12, 512, 64, torch.float32, "same", True),  # the served shape
        (8, 12, 512, 64, torch.bfloat16, "same", True),
        (8, 12, 512, 64, torch.float32, "int8", True),
        (3, 4, 128, 64, torch.bfloat16, "int8", False),
        (2, 3, 1, 16, torch.float32, "same", True),  # one row: only itself
        (3, 2, 37, 4, torch.float32, "same", False),  # D = 4: 32 rows a warp
        (3, 2, 200, 12, torch.float32, "int8", True),  # 3 quads: a lane idle
        (2, 2, 300, 128, torch.float32, "same", True),
        (2, 2, 100, 192, torch.bfloat16, "same", True),  # two loads a lane
        (2, 2, 64, 256, torch.float32, "int8", True),
    ],
)
def test_decode_attention_kernel_matches_plain(cuda, B, H, L, D, dtype, kv, with_bias):
    """Mixed positions (0, a middle one, L - 1) with junk past each one
    (K +1e6 / V -1e6, int8 +127 / -127), which must not leak."""
    from unicore_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device=cuda).manual_seed(L * 7 + D)
    q = (torch.randn(B, H, D, generator=g, device=cuda) * D ** -0.5).to(dtype)
    k = torch.randn(B, H, L, D, generator=g, device=cuda)
    v = torch.randn(B, H, L, D, generator=g, device=cuda)
    pos = torch.linspace(0, L - 1, B, device=cuda).to(torch.int32)
    live = torch.arange(L, device=cuda)[None, None, :, None] <= pos[:, None, None, None].long()
    scales = {}
    if kv == "int8":
        ks = k.abs().amax(dim=(0, 2)) / 127.0 + 1e-8
        vs = v.abs().amax(dim=(0, 2)) / 127.0 + 1e-8
        k = torch.where(live, torch.round(k / ks[None, :, None]).clamp(-127, 127),
                        127.0).to(torch.int8)
        v = torch.where(live, torch.round(v / vs[None, :, None]).clamp(-127, 127),
                        -127.0).to(torch.int8)
        scales = {"k_scale": ks.contiguous(), "v_scale": vs.contiguous()}
    else:
        k = torch.where(live, k, 1e6).to(dtype)
        v = torch.where(live, v, -1e6).to(dtype)
    bias = torch.randn(B, H, L, generator=g, device=cuda) if with_bias else None
    _kernels.reset_launch_counts()
    out = da.decode_attention(q, k, v, pos, bias=bias, **scales)
    torch.cuda.synchronize()
    assert da.LAUNCHES.count == 1
    ref = da.decode_attention_plain(q, k, v, pos, bias=bias, **scales)
    assert out.dtype == dtype and out.shape == (B, H, D)
    assert torch.isfinite(out.float()).all() and out.float().abs().max() < 100
    err = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5, err.max().item()
    else:
        assert (err <= 2 * 2.0 ** -7 * ref.float().abs() + 1e-6).all(), err.max().item()


def test_decode_attention_refusals(cuda):
    """A CUDA call launches the kernel or raises, naming what it refuses."""
    from unicore_tpu_torch.ops import decode_attention as da

    def call(D=64, dtype=torch.float32, cache=torch.float32, **kw):
        q = torch.zeros(2, 2, D, device=cuda, dtype=dtype)
        c = torch.zeros(2, 2, 32, D, device=cuda, dtype=cache)
        pos = kw.pop("pos", torch.zeros(2, dtype=torch.int32, device=cuda))
        return da.decode_attention(q, c, c, pos, **kw)

    _kernels.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="multiple of 4"):
        call(D=6)
    with pytest.raises(NotImplementedError, match="at most 256"):
        call(D=260)
    with pytest.raises(NotImplementedError, match="q's type or int8"):
        call(cache=torch.bfloat16)
    with pytest.raises(ValueError, match="fp32/bf16"):
        call(dtype=torch.float16, cache=torch.float16)
    with pytest.raises(ValueError, match="int32"):
        call(pos=torch.zeros(2, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(pos=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="bias must be fp32"):
        call(bias=torch.zeros(2, 2, 32, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="together"):
        call(k_scale=torch.ones(2, 64, device=cuda))
    assert da.LAUNCHES.count == 0  # refused calls launch nothing
    call()
    assert da.LAUNCHES.count == 1


def test_transformer_lm_incremental_decode_on_card_matches_cpu(cuda):
    """A 2-layer full-width ``transformer_lm`` (768 wide, 12 heads, FFN
    3072): prefill of 112 tokens (the full-row kernel, padded to 128) and 16
    decode steps over a 128-row cache (the decode kernel) on the card
    against the full causal forward on the CPU.  Launches per step: 2
    decode attentions and 6 norm forwards."""
    from unicore_tpu_torch.models.transformer_lm import TransformerLMModel
    from unicore_tpu_torch.ops import decode_attention as da

    model = TransformerLMModel(vocab_size=1000, padding_idx=1, decoder_layers=2,
                               generator=torch.Generator().manual_seed(5)).eval()
    B, P, steps, Lc = 4, 112, 16, 128
    toks = torch.randint(4, 1000, (B, P + steps), generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        full = model(toks)[:, P:]
        model.to(cuda)
        _, (k, v) = model.prefill(toks[:, :P].to(cuda))
        kc = torch.zeros(2, B, 12, Lc, 64, device=cuda)
        vc = torch.zeros_like(kc)
        kc[:, :, :, :P], vc[:, :, :, :P] = k, v
        _kernels.reset_launch_counts()
        rows = []
        for t in range(P, P + steps):
            logits, (kr, vr) = model.decode_step(
                toks[:, t].to(cuda), (kc, vc), torch.full((B,), t, dtype=torch.int32,
                                                          device=cuda))
            kc[:, :, :, t], vc[:, :, :, t] = kr, vr
            rows.append(logits.cpu())
    assert da.LAUNCHES.count == 2 * steps and fn.LAUNCHES.count == 6 * steps
    got = torch.stack(rows, dim=1)
    assert ((got - full).abs() <= 1e-4 + 1e-4 * full.abs()).all(), (got - full).abs().max()


# ---------------------------------------------------------------------------
# the int8 serving kernels: the W8A8 dense, the int8 LayerNorm and the
# int8/int32 softmax
# ---------------------------------------------------------------------------

def _int8(g, shape, device, lo=-127, hi=128):
    return torch.randint(lo, hi, shape, generator=g, device=device, dtype=torch.int32
                         ).to(torch.int8)


@pytest.mark.parametrize("M,K,N", [(1, 32, 8), (77, 64, 40), (300, 768, 2304),
                                   (130, 3072, 768), (4096, 768, 768), (257, 96, 136)])
@pytest.mark.parametrize("act,with_bias", [("", False), ("gelu", True), ("relu", True),
                                           ("gelu_fast", False), ("tanh", True),
                                           ("silu", True)])
def test_quant_matmul_kernel_matches_plain(cuda, M, K, N, act, with_bias):
    """#13 against ``quant_matmul_plain``: fp32 out within 1e-6 of the
    output's absmax (the int32 sums are exact on both sides; only the
    activation's last bits differ)."""
    from unicore_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=cuda).manual_seed(M * 7 + K + N)
    x, w = _int8(g, (M, K), cuda), _int8(g, (N, K), cuda)
    scale = torch.rand(N, generator=g, device=cuda) * 1e-4 + 1e-5
    bias = torch.randn(N, generator=g, device=cuda) if with_bias else None
    _kernels.reset_launch_counts()
    out = qm.quant_matmul(x, w, scale, bias, act)
    assert qm.LAUNCHES.count == 1 and out.dtype == torch.float32 and out.shape == (M, N)
    ref = qm.quant_matmul_plain(x, w, scale, bias, act)
    err = (out - ref).abs().max().item()
    assert err <= 1e-6 * max(ref.abs().max().item(), 1e-30), err


def test_quant_matmul_kernel_sums_exactly(cuda):
    """+-127 operands over K = 3072 (sums near 5e7, past fp32's 2**24 and
    past an int8 result's wrap): with scale 1 the output is the int32 sum
    rounded once to fp32, bit for bit the plain version's."""
    from unicore_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=cuda).manual_seed(3)
    M, K, N = 64, 3072, 256
    x = torch.where(torch.rand(M, K, generator=g, device=cuda) < 0.9, 127, -127).to(torch.int8)
    w = torch.full((N, K), 127, dtype=torch.int8, device=cuda)
    w[1::2] = -127
    out = qm.quant_matmul(x, w, torch.ones(N, device=cuda))
    acc = qm.int8_matmul_plain(x, w)
    assert acc.abs().max().item() > 2 ** 24
    assert torch.equal(out, acc.float())


def test_quant_kernels_refusals(cuda):
    from unicore_tpu_torch.ops import quant_matmul as qm

    x = torch.zeros(4, 64, dtype=torch.int8, device=cuda)
    w = torch.zeros(16, 64, dtype=torch.int8, device=cuda)
    s = torch.ones(16, device=cuda)
    _kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="multiple of 32"):
        qm.quant_matmul(torch.zeros(4, 48, dtype=torch.int8, device=cuda),
                        torch.zeros(16, 48, dtype=torch.int8, device=cuda), s)
    with pytest.raises(ValueError, match="multiple of 32"):
        qm.quant_matmul(x, torch.zeros(12, 64, dtype=torch.int8, device=cuda),
                        torch.ones(12, device=cuda))
    with pytest.raises(ValueError, match="int8 operands"):
        qm.quant_matmul_kernel(x.float().to(torch.float8_e4m3fn),
                               w.float().to(torch.float8_e4m3fn), s)
    with pytest.raises(ValueError, match="CUDA tensor"):
        qm.quant_matmul(x, w, s.cpu())
    with pytest.raises(ValueError, match="scale must be fp32"):
        qm.quant_matmul(x, w, torch.ones(8, device=cuda))
    with pytest.raises(ValueError, match="activation"):
        qm.quant_matmul(x, w, s, activation="softplus")
    with pytest.raises(ValueError, match="scale must be fp32"):
        fn.quant_layer_norm_kernel(x, torch.ones(3, device=cuda), torch.ones(64, device=cuda),
                                   torch.zeros(64, device=cuda))
    with pytest.raises(ValueError, match="int8/int32"):
        sd.quant_softmax_dropout_kernel(torch.zeros(2, 8, 128, device=cuda),
                                        torch.ones((), device=cuda))
    with pytest.raises(ValueError, match="refused"):
        sd.quant_softmax_dropout_kernel(torch.zeros(2, 8, 100, dtype=torch.int32, device=cuda),
                                        torch.ones((), device=cuda))
    assert sum(_kernels.launch_counts().values()) == 0  # refused calls launch nothing
    # fp8 is the plain composition on the card too (the JAX route): no launch
    y = qm.quant_matmul(x.float().to(torch.float8_e4m3fn), w.float().to(torch.float8_e4m3fn), s)
    assert y.is_cuda and qm.LAUNCHES.count == 0


@pytest.mark.parametrize("N,D", [(1, 8), (5, 33), (4096, 768), (7, 8192)])
@pytest.mark.parametrize("per_channel", [False, True])
def test_quant_layer_norm_kernel_matches_plain(cuda, N, D, per_channel):
    from unicore_tpu_torch.ops.quant_norm import quant_layer_norm

    g = torch.Generator(device=cuda).manual_seed(N + D)
    x = _int8(g, (2, N, D), cuda)
    scale = (torch.rand(D if per_channel else (), generator=g, device=cuda) * 0.05 + 0.01)
    w = 1 + 0.1 * torch.randn(D, generator=g, device=cuda)
    b = 0.1 * torch.randn(D, generator=g, device=cuda)
    _kernels.reset_launch_counts()
    out = quant_layer_norm(x, scale, w, b)
    assert fn.QUANT_LAUNCHES.count == 1 and out.dtype == torch.float32
    ref = fn.quant_layer_norm_plain(x, scale, w, b)
    assert (out - ref).abs().max().item() <= TOL["norm"][torch.float32]


@pytest.mark.parametrize(
    "shape,dtype,mask_shape,bias_shape,rate",
    [
        ((2, 3, 128, 256), torch.int32, (2, 1, 1, 256), (1, 3, 128, 256), 0.0),
        ((2, 12, 512, 512), torch.int32, (2, 1, 1, 512), (1, 12, 512, 512), 0.0),
        ((4, 2, 128, 128), torch.int8, None, None, 0.0),
        ((6, 16, 384), torch.int32, None, (2, 16, 384), 0.1),  # tile
        ((2, 8, 2048), torch.int8, (2, 1, 2048), None, 0.1),  # block rows
    ],
)
def test_quant_softmax_kernel_matches_plain(cuda, shape, dtype, mask_shape, bias_shape, rate):
    from unicore_tpu_torch.ops import quant_softmax_dropout as qsd

    g = torch.Generator(device=cuda).manual_seed(shape[-1] + len(shape))
    hi = 128 if dtype == torch.int8 else 200_000
    x = torch.randint(-hi + 1, hi, shape, generator=g, device=cuda,
                      dtype=torch.int32).to(dtype)
    scale = torch.tensor(3.0 / hi, device=cuda)
    mask = None
    if mask_shape is not None:
        mask = (torch.rand(mask_shape, generator=g, device=cuda) < 0.2).float() \
            * torch.finfo(torch.float32).min
    bias = None if bias_shape is None else torch.randn(bias_shape, generator=g, device=cuda)
    _kernels.reset_launch_counts()
    out = sd.quant_softmax_dropout_kernel(x, scale, rate, mask, bias, seed=17)
    assert sd.QUANT_LAUNCHES.count == 1 and out.dtype == torch.float32
    ref = qsd.quant_softmax_dropout_plain(x, scale, rate, mask, bias, seed=17)
    assert (out - ref).abs().max().item() <= TOL["softmax"]
    if rate:
        assert torch.equal(out != 0, ref != 0)


def test_tiny_bert_quantized_on_card_matches_cpu(cuda):
    """A 2-layer BERT prepared once on the CPU (int8 and fp8), its logits on
    the card against the CPU: within 5e-3 of the logit absmax and argmax
    equal on 99% of the positions (a rare activation may round to the
    neighbouring int8 step on the other device).  The int8 card forward
    launches 9 W8A8 dense, 2 int8 softmax, 1 int8 LayerNorm and 5 norms and
    no full-row attention."""
    from unicore_tpu_torch.ops import quant_matmul as qm
    from unicore_tpu_torch.quant import calibrate

    model = BertModel(vocab_size=100, encoder_layers=2, encoder_embed_dim=64,
                      encoder_ffn_embed_dim=128, encoder_attention_heads=4,
                      max_seq_len=256, generator=torch.Generator().manual_seed(0)).eval()
    toks = torch.randint(4, 100, (4, 128), generator=torch.Generator().manual_seed(1))
    toks[1, 100:] = 1
    for mode in ("int8", "fp8"):
        twin = model.clone(quantize=mode)
        twin, info = calibrate.calibrate_for_serving(
            twin, model, mode=mode, snapshot_path=None, vocab_size=100, pad_idx=1,
            bucket_edges=[128], batch_size=4)
        with torch.no_grad():
            cpu = twin(toks)
            twin.to(cuda)
            _kernels.reset_launch_counts()
            card = twin(toks.to(cuda)).cpu()
        counts = _kernels.launch_counts()
        if mode == "int8":
            assert counts["quant_matmul"] == 9 and counts["quant_softmax_dropout_fwd"] == 2
            assert counts["quant_layer_norm"] == 1 and counts["fused_norm_fwd"] == 5
        else:
            assert counts["quant_matmul"] == 0 and counts["fullrow_attention_fwd"] == 2
            assert counts["fused_norm_fwd"] == 5
        assert counts.get("fullrow_attention_fwd", 0) == (0 if mode == "int8" else 2)
        err = (card - cpu).abs().max().item()
        assert err <= 5e-3 * cpu.abs().max().item(), (mode, err)
        agree = (card.argmax(-1) == cpu.argmax(-1)).float().mean().item()
        assert agree >= 0.99, (mode, agree)
        assert qm.LAUNCHES.count == counts["quant_matmul"]
