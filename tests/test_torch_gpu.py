"""The port's CUDA kernels against their plain versions ON THE CARD, at
shapes the chip smoke does not reach (no bias, a shared bias, no mask,
Lq != Lk, head dims 8/12/16/128, 1024 key rows — the most shared memory
the kernels ask for inside the ``supported()`` gate; norm widths 8 to 8192
and tiny row counts), forward and backward, with and without dropout,
plus the wrappers' refusals and a tiny BERT on the card against the same
weights on the CPU, its outputs and every parameter's gradient.

Marked ``gpu``: each test takes the ``cuda`` fixture, which skips without a
card, so on the CPU every test here is skipped.  On a machine with a card
(which need not have JAX)::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py

Tolerances, kernel vs plain version on the same card inputs: fp32 2e-5
(attention) / 1e-5 (norm) absolute — the two differ only in summation
order; bf16 2e-2 (attention) / 6.25e-2 (norm) — last-bit fp32 differences
may round to neighbouring bf16 values (one ulp is 2**-4 below 16).  BERT
logits: 1e-4 absolute, card vs CPU in fp32 with TF32 off.

Gradients, kernel vs autograd of the plain version (for the attention
backward in bf16, vs ``fullrow_attention_bwd_plain``, which rounds pd and
ds as the kernel does), per element as chip_smoke.py holds them: 1e-4
(attention) / 1e-5 (norm) of the reference's largest magnitude (at least
1) — dk, dv and dbias are sums of per-tile partials added by atomics in
an order that changes from run to run — plus two bf16 ulps of the
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

pytestmark = pytest.mark.gpu

TOL = {
    "attention": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
    "norm": {torch.float32: 1e-5, torch.bfloat16: 6.25e-2},
}
GRAD_TOL = {"attention": 1e-4, "norm": 1e-5}
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
        (1, 2, 128, 1024, 128, 2, True, torch.float32),  # 186 KB of smem
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
        (1, 2, 128, 1024, 128, 2, 0.1, torch.float32),  # 16-row tiles, 186 KB
        (2, 2, 256, 1024, 64, 1, 0.0, torch.float32),
        (2, 3, 512, 512, 64, 3, 0.1, torch.bfloat16),
        (2, 2, 768, 768, 32, None, 0.2, torch.bfloat16),
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
