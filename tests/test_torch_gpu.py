"""The port's CUDA kernels against their plain versions ON THE CARD, at
shapes the chip smoke does not reach (no bias, a shared bias, no mask,
Lq != Lk, head dims 8/12/16/128, 1024 key rows — the most shared memory
the kernels ask for inside the ``supported()`` gate; norm widths 8 to 8192
and tiny row counts, the one-pass norm backward at those widths, the
pair rows of Uni-Mol and the Evoformer and rows of 5001 and 12288 (bit-equal twice, at most two
kernels and no memset a backward); the norm forward at every team width
(D 1 to 12288, the column-tiled rows among them) in fp32, bf16 and fp16,
its statistics against the fp32 plain ones, the same bits twice, one
kernel a call, unaligned views on the one-element route; softmax rows of 128 to 8192 with every extra layout),
forward and backward, with and without dropout; the four flash kernels
(forward, dq, dk/dv, dbias) with every bias grouping, head dims 24 to 128,
1152 rows, Lq != Lk, fully masked rows and dropout, their Philox mask and
the dbias sum's repeatability; the decode attention (fp32, bf16, int8 caches
with fp32 and bf16 q, head dims 4 to 256, L of 1 to 512, mixed positions
with junk rows past them; the split edges -- positions 0, a middle one and
L - 1 in one batch, a chunk of -inf bias, L 1 / 37 / 512 -- bit-equal
across two calls; its bf16-query variant, a bf16 q against fp32 or int8
caches with an fp32, bf16 or fp16 bias row or none) and the shapes it
refuses; a hot swap of the serving engine on the card (the answers switch
to the bf16 candidate's, the old model's memory released); the int8 serving
kernels (the W8A8 dense at every activation, with and without bias, odd M,
every dense site of a served BERT-base batch, and an exact-sum check past
2**24 at each tile width; the int8 LayerNorm with a scalar and a
per-channel scale; the int8/int32 softmax with every extra layout and
dropout) and their refusals; plus the wrappers'
refusals; the full-row forward and backward at the causal LM's attention
(the rel-pos bias plus the causal triangle as one bias that needs a
gradient, dbias exactly 0 above the diagonal); the mixed-precision inputs
of a ``--bf16`` / ``--fp16`` run (the norms with bf16 and fp16 x, weight
and bias; the full-row and flash kernels with a bf16 bias, dbias returned
in bf16; the stochastic rounding on a card tensor, unbiased and the same
bits from a generator with the same seed); and a tiny BERT, a tiny
Uni-Mol and a 2-block Evoformer on the card
against the same weights on the CPU, their outputs and every parameter's
gradient, and a 2-layer full-width ``transformer_lm`` whose incremental
decode on the card matches its full forward on the CPU; the health
sentinel's snapshot (pinned host buffers, a side stream) restored bit for
bit under ``--fused-adam --bf16``, and an injected loss spike's
denominator through the optimizer kernels against their plain versions.

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
summation order); bf16 / fp16 q two ulps of its type of the element plus
1e-6 (both round one fp32 result once).  Incremental decode of the 2-layer LM on the card vs
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
element (2**-6 of it) where the output is stored in bf16 (two fp16 ulps,
2**-9 of it, in fp16), plus for the
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
    # fp16: two ulps below 16 in magnitude (2**-7 each), as chip_smoke.py's
    "norm": {torch.float32: 1e-5, torch.bfloat16: 6.25e-2, torch.float16: 1.5625e-2},
    "softmax": 1e-6,
}
GRAD_TOL = {"attention": 1e-4, "norm": 1e-5, "softmax": 1e-5}
BF16_ULPS = 2.0 ** -6
FP16_ULPS = 2.0 ** -9


def _rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp(min=1.0)).item()


def _grad_over_tol(got, ref, floor, slack=0.0):
    """The largest error of a gradient over its per-element tolerance."""
    ref = ref.float()
    tol = floor * max(1.0, ref.abs().max().item()) + slack
    if got.dtype == torch.bfloat16:
        tol = tol + BF16_ULPS * ref.abs()
    elif got.dtype == torch.float16:
        tol = tol + FP16_ULPS * ref.abs()
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
    with pytest.raises(ValueError, match="fp32, bf16 or fp16"):
        fn.fused_layer_norm(x, w.double(), None)
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
def test_attention_causal_lm_bias_matches_plain(cuda, dtype):
    """The causal LM's attention at full width, (8, 12, 512, 64): the rel-pos
    bias plus the ``triu`` of ``CAUSAL_NEG`` as one bias that needs a
    gradient, the key mask (a fully-masked row among them) and dropout 0.1;
    forward and dq, dk, dv, dbias against the plain versions, and dbias
    exactly 0 above the diagonal, where every probability is 0."""
    from unicore_tpu_torch.modules.transformer_decoder import CAUSAL_NEG

    B, H, L, D = 8, 12, 512, 64
    q, k, v, do, rel, mask = _attention_inputs(cuda, B, H, L, L, D, H, dtype, seed=11)
    bias = rel + torch.triu(torch.full((L, L), CAUSAL_NEG, device=cuda), 1)
    kw = dict(dropout_rate=0.1, sm_scale=0.125, dropout_seed=77)
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
    assert (out.float() - ref_out.float()).abs().max().item() <= TOL["attention"][dtype]
    assert out[-1].abs().max().item() == 0.0
    slack = [0.0] * 4
    if dtype == torch.bfloat16:
        args = (q, k, v, bias, mask, do, 0.125, 0.1, 77)
        ref_grads = fr.fullrow_attention_bwd_plain(*args)
        slack = [*fr.bwd_rounding_slack(*args), 0.0]
    for name, got, ref, s in zip(("dq", "dk", "dv", "dbias"), grads, ref_grads, slack):
        ratio = _grad_over_tol(got, ref, GRAD_TOL["attention"], s)
        assert ratio <= 1.0, (name, ratio)
    above = torch.triu(torch.ones(L, L, dtype=torch.bool, device=cuda), 1)
    assert int((grads[3][:, :, above] != 0).sum()) == 0


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


@pytest.mark.parametrize("N,D", [(1, 8), (5, 33), (1000, 768), (129, 1024), (3, 4096),
                                 (7, 8192), (16 * 128 * 128, 64), (256 * 256, 128),
                                 (1000, 12288), (300, 5001)])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_fused_backward_matches_plain(cuda, N, D, rms, dtype):
    """The one-pass backward (``_launch_bwd``: dx and the dw/db partials in
    one launch, their sum in a second) against ``fused_norm_bwd_plain`` on
    the forward kernel's statistics, at every width above plus Uni-Mol's
    and the Evoformer's pair rows and two rows too wide for registers (the
    column-tiled kernel, 16-byte and one-element loads, several rows a
    block); the same bits on a second call, and dx
    alone or dw/db alone equal to the full call's."""
    g = torch.Generator(device=cuda).manual_seed(N * 13 + D)
    x = (torch.randn(N, D, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    dy = torch.randn(N, D, generator=g, device=cuda).to(dtype)
    w = 1 + 0.1 * torch.randn(D, generator=g, device=cuda)
    b = None if rms else 0.1 * torch.randn(D, generator=g, device=cuda)
    eps = 1e-6 if rms else 1e-5
    _, mean, rstd = fn._launch_fwd(x, w, b, eps, rms, True, "norm")
    _kernels.reset_launch_counts()
    got = fn._launch_bwd(x, w, mean, rstd, dy, rms, not rms, True, True, "norm")
    assert (fn.DX_LAUNCHES.count, fn.DWDB_LAUNCHES.count) == (1, 1)
    ref = fn.fused_norm_bwd_plain(x, w, mean, rstd, dy, rms, not rms)
    for name, gk, gr in zip(("dx", "dw", "db"), got, ref):
        if gr is None:
            assert gk is None, name
            continue
        assert gk.dtype == gr.dtype and gk.shape == gr.shape, name
        ratio = _grad_over_tol(gk, gr, GRAD_TOL["norm"])
        assert ratio <= 1.0, (name, ratio)
    again = fn._launch_bwd(x, w, mean, rstd, dy, rms, not rms, True, True, "norm")
    for name, a, c in zip(("dx", "dw", "db"), got, again):
        assert (a is None and c is None) or torch.equal(a, c), name
    dx_only = fn._launch_bwd(x, w, mean, rstd, dy, rms, not rms, True, False, "norm")
    assert dx_only[1] is None and dx_only[2] is None and torch.equal(dx_only[0], got[0])
    dw_only = fn._launch_bwd(x, w, mean, rstd, dy, rms, not rms, False, True, "norm")
    assert dw_only[0] is None and torch.equal(dw_only[1], got[1])
    assert rms or torch.equal(dw_only[2], got[2])


@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rms", [False, True])
def test_norm_backward_two_kernels_in_weight_type(cuda, wdtype, rms):
    """A norm backward of a --bf16 / --fp16 run through autograd (BERT's
    (4096, 768), x, weight and bias in one type): dx in x's type, dw and db
    in the weight's, within the plain version's tolerance, and on the
    device at most two kernels and no memset or copy (the profiler's
    view)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    N, D = 4096, 768
    g = torch.Generator(device=cuda).manual_seed(11)
    x = (torch.randn(N, D, generator=g, device=cuda) * 2 + 0.5).to(wdtype)
    dy = torch.randn(N, D, generator=g, device=cuda).to(wdtype)
    w = (1 + 0.1 * torch.randn(D, generator=g, device=cuda)).to(wdtype)
    b = (0.1 * torch.randn(D, generator=g, device=cuda)).to(wdtype)
    eps = 1e-6 if rms else 1e-5
    leaves = [t.clone().requires_grad_(True) for t in ((x, w) if rms else (x, w, b))]
    y = (fn.fused_rms_norm(*leaves, eps) if rms else fn.fused_layer_norm(*leaves, eps))
    torch.autograd.grad(y, leaves, dy, retain_graph=True)  # warm: the build, the plan
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = torch.autograd.grad(y, leaves, dy, retain_graph=True)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert sum(e.count for e in device) <= 2, [(e.key, e.count) for e in device]
    assert not any("emset" in e.key or "opy" in e.key for e in device), [e.key for e in device]
    assert [t.dtype for t in got] == [wdtype] * len(leaves)
    _, mean, rstd = fn._launch_fwd(x, w, None if rms else b, eps, rms, True, "norm")
    ref = fn.fused_norm_bwd_plain(x, w, mean, rstd, dy, rms, not rms)
    for name, gk, gr in zip(("dx", "dw", "db"), got, ref):
        assert gk.dtype == gr.dtype, name
        assert _grad_over_tol(gk, gr, GRAD_TOL["norm"]) <= 1.0, name


def _norm_forward_check(x, w, b, eps, rms):
    """One forward route on ``x``: the training call (y, mean, rstd) and the
    serving call, each twice; y within TOL["norm"] of ``fused_norm_plain``,
    the statistics within 1e-5 (of max(1, |ref|)) of the fp32 plain ones,
    the same bits on the second call, the serving y equal to the training
    y, one launch a call.  Returns y."""
    _kernels.reset_launch_counts()
    y, mean, rstd = fn._launch_fwd(x, w, b, eps, rms, True, "norm")
    y2, mean2, rstd2 = fn._launch_fwd(x, w, b, eps, rms, True, "norm")
    served, none, _ = fn._launch_fwd(x, w, b, eps, rms, False, "norm")
    assert fn.LAUNCHES.count == 3 and none is None
    assert torch.equal(y, y2) and torch.equal(mean, mean2) and torch.equal(rstd, rstd2)
    assert torch.equal(served, y)
    ref = fn.fused_norm_plain(x, w, b, eps, rms)
    assert y.dtype == x.dtype and y.shape == x.shape
    err = (y.float() - ref.float()).abs().max().item()
    assert err <= TOL["norm"][x.dtype], err
    ref_mean, ref_rstd = fn.fused_norm_stats_plain(x, eps, rms)
    for got, want in ((mean, ref_mean), (rstd, ref_rstd)):
        assert got.dtype == torch.float32 and got.shape == want.shape[:-1]
        assert _rel_err(got, want.reshape(-1)) <= 1e-5
    return y


@pytest.mark.parametrize("N,D", [(1, 1), (300, 2), (37, 8), (129, 16), (77, 33), (1001, 64),
                                 (513, 96), (257, 128), (33, 256), (9, 512), (1000, 768),
                                 (5, 1024), (3, 2048), (2, 4096), (7, 8192), (300, 5001),
                                 (100, 12288), (16 * 128 * 128, 64), (256 * 256, 128)])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_norm_forward_routes_match_plain(cuda, N, D, rms, dtype):
    """The forward at every team width (1 to 256 threads a row, several rows
    a warp at D <= 128), row counts that fill no team or block, the
    one-element route (odd D), and rows too wide for registers (5001 and
    12288: the column-tiled kernel); statistics, bits and launches as
    :func:`_norm_forward_check` holds them."""
    g = torch.Generator(device=cuda).manual_seed(N * 7 + D)
    x = (torch.randn(N, D, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    w = 1 + 0.1 * torch.randn(D, generator=g, device=cuda)
    b = None if rms else 0.1 * torch.randn(D, generator=g, device=cuda)
    _norm_forward_check(x, w, b, 1e-6 if rms else 1e-5, rms)


@pytest.mark.parametrize("D", [516, 772, 2056])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("xdtype,wdtype", [(torch.float32, torch.bfloat16),
                                           (torch.float32, torch.float16),
                                           (torch.bfloat16, torch.float32),
                                           (torch.float16, torch.float16)])
def test_norm_forward_weight_types_match_plain(cuda, D, rms, xdtype, wdtype):
    """Weights in another type than x where the block keeps them in shared
    memory, at widths whose weight bytes are no multiple of 16 (the copy's
    one-element tail), as :func:`_norm_forward_check` holds them."""
    g = torch.Generator(device=cuda).manual_seed(D + 11)
    x = (torch.randn(37, D, generator=g, device=cuda) * 2 + 0.5).to(xdtype)
    w = (1 + 0.1 * torch.randn(D, generator=g, device=cuda)).to(wdtype)
    b = None if rms else (0.1 * torch.randn(D, generator=g, device=cuda)).to(wdtype)
    _norm_forward_check(x, w, b, 1e-6 if rms else 1e-5, rms)


@pytest.mark.parametrize("D", [64, 768, 4096])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_forward_unaligned_view_matches_vector_route(cuda, D, rms, dtype):
    """x and w one element into their storage (not 16-byte aligned) take the
    one-element route; its y equals the plain version's, and the 16-byte
    route's on an aligned copy, within TOL["norm"]."""
    N = 50
    g = torch.Generator(device=cuda).manual_seed(D + 3)
    x_store = (torch.randn(N * D + 1, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    w_store = 1 + 0.1 * torch.randn(D + 1, generator=g, device=cuda)
    x, w = x_store[1:].view(N, D), w_store[1:]
    assert x.data_ptr() % 16 and w.data_ptr() % 16
    b = None if rms else 0.1 * torch.randn(D, generator=g, device=cuda)
    eps = 1e-6 if rms else 1e-5
    scalar = _norm_forward_check(x, w, b, eps, rms)
    vector = _norm_forward_check(x.clone(), w.clone(), b, eps, rms)
    assert (scalar.float() - vector.float()).abs().max().item() <= TOL["norm"][dtype]


@pytest.mark.parametrize("N,D,dtype", [(16 * 128 * 128, 64, torch.bfloat16),
                                       (4096, 768, torch.float32), (300, 5001, torch.float32)])
def test_norm_forward_one_device_operation(cuda, N, D, dtype):
    """Through the public path, serving (no gradient) and training (the
    autograd Function, which also writes the statistics): one kernel a
    call on the device, no memset or copy (the profiler's view)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(N + D)
    x = (torch.randn(N, D, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    w = (1 + 0.1 * torch.randn(D, generator=g, device=cuda)).to(dtype)
    b = (0.1 * torch.randn(D, generator=g, device=cuda)).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    calls = 10
    for args in ((x, w, b), leaves):
        fn.fused_layer_norm(*args)  # warm: the build, the occupancy
        torch.cuda.synchronize()
        # CUPTI drops kernel events now and then, never adds any: a profile
        # short of events is taken again (as chip_smoke.py's device_profile)
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    y = fn.fused_layer_norm(*args)
                torch.cuda.synchronize()
            device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            if sum(e.count for e in device) >= calls:
                break
        assert sum(e.count for e in device) == calls, [(e.key, e.count) for e in device]
        assert y.requires_grad == (args is leaves)


@pytest.mark.parametrize("N,D", [(3, 1), (33, 64), (2048, 512), (300, 5001), (100, 12288)])
@pytest.mark.parametrize("per_channel", [False, True])
def test_quant_layer_norm_routes_match_plain(cuda, N, D, per_channel):
    """The int8 LayerNorm (7q, the forward template with an int8 loader) at
    one-element, 4-element and column-tiled widths, with one scale or D of
    them: within 1e-5 of ``quant_layer_norm_plain``, the same bits twice,
    and an unaligned view of x within 1e-5 too."""
    g = torch.Generator(device=cuda).manual_seed(N * 3 + D)
    x = _int8(g, (N, D), cuda)
    scale = (torch.rand(D if per_channel else (), generator=g, device=cuda) * 0.05 + 0.01)
    w = 1 + 0.1 * torch.randn(D, generator=g, device=cuda)
    b = 0.1 * torch.randn(D, generator=g, device=cuda)
    _kernels.reset_launch_counts()
    out = fn.quant_layer_norm_kernel(x, scale, w, b)
    again = fn.quant_layer_norm_kernel(x, scale, w, b)
    assert fn.QUANT_LAUNCHES.count == 2 and torch.equal(out, again)
    ref = fn.quant_layer_norm_plain(x, scale, w, b)
    assert (out - ref).abs().max().item() <= TOL["norm"][torch.float32]
    store = torch.zeros(N * D + 1, dtype=torch.int8, device=cuda)
    store[1:] = x.reshape(-1)
    shifted = fn.quant_layer_norm_kernel(store[1:].view(N, D), scale, w, b)
    assert (shifted - ref).abs().max().item() <= TOL["norm"][torch.float32]


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
    ``flash_attention_bwd_plain`` from the kernel's own output and lse.
    dq, dk, dv and dbias repeat bit for bit across two backward calls (no
    atomics; dbias's partial sums are added in a fixed order), and each
    backward raises the dq, dk/dv and dbias counts by one -- dbias by none
    when the bias needs no gradient."""
    from unicore_tpu_torch.ops import flash_attention as fa

    q, k, v, do, bias, mask = _flash_inputs(cuda, B, H, Lq, Lk, D, bias_shape, masked,
                                            dtype, seed=Lq + D)
    kw = dict(sm_scale=0.7, dropout_rate=dropout, dropout_seed=99)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias) if t is not None]
    _kernels.reset_launch_counts()
    out = fa.flash_attention(*leaves[:3], bias=leaves[3] if bias is not None else None,
                             kv_padding_mask=mask, **kw)
    grads = torch.autograd.grad(out, leaves, do, retain_graph=True)
    counts = (fa.FWD_LAUNCHES.count, fa.DQ_LAUNCHES.count, fa.DKV_LAUNCHES.count,
              fa.DB_LAUNCHES.count)
    assert counts == (1, 1, 1, int(bias is not None)), counts
    again = torch.autograd.grad(out, leaves, do)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), grads, again):
        assert torch.equal(a, b), name
    counts = (fa.DQ_LAUNCHES.count, fa.DKV_LAUNCHES.count, fa.DB_LAUNCHES.count)
    assert counts == (2, 2, 2 * int(bias is not None)), counts
    if bias is not None:  # the bias needs no gradient: no dbias
        fixed = fa.flash_attention(*leaves[:3], bias=bias, kv_padding_mask=mask, **kw)
        no_db = torch.autograd.grad(fixed, leaves[:3], do)
        for name, a, b in zip(("dq", "dk", "dv"), grads, no_db):
            assert torch.equal(a, b), name
        counts = (fa.DQ_LAUNCHES.count, fa.DKV_LAUNCHES.count, fa.DB_LAUNCHES.count)
        assert counts == (3, 3, 2), counts
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
    plain Philox mask bit for bit; the dk/dv launch's dbias (partial sums
    in its chunks, then the ordered reduction) repeats to the bit."""
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
    a = fa._launch_dkv(q, k, v, bias, mask, lse, di, do, 1.0, 0.0, 0, need_db=True)[2]
    b = fa._launch_dkv(q, k, v, bias, mask, lse, di, do, 1.0, 0.0, 0, need_db=True)[2]
    assert torch.equal(a, b)


def test_flash_refusals(cuda):
    """A CUDA call launches the kernels or raises: CPU tensors mixed in,
    fp16, a bias that is neither fp32 nor bf16, a bf16 bias with fp32 q."""
    from unicore_tpu_torch.ops import flash_attention as fa

    q = torch.zeros(2, 2, 128, 32, device=cuda)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention(q, q, q, bias=torch.zeros(1, 2, 128, 128))
    with pytest.raises(ValueError, match="fp32/bf16"):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="bias must be fp32"):
        fa.flash_attention(q, q, q, bias=torch.zeros(1, 2, 128, 128, device=cuda).half())
    with pytest.raises(ValueError, match="bias must be fp32, or bf16 with bf16"):
        fa.flash_attention(q, q, q, bias=torch.zeros(1, 2, 128, 128, device=cuda).bfloat16())


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
        (8, 12, 512, 64, torch.float16, "same", True),
        (3, 4, 128, 64, torch.float16, "int8", False),
    ],
)
def test_decode_attention_kernel_matches_plain(cuda, B, H, L, D, dtype, kv, with_bias):
    """Mixed positions (0, a middle one, L - 1) with junk past each one
    (K +1e6 / V -1e6, fp16 +-6e4 to stay finite, int8 +127 / -127), which
    must not leak."""
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
        junk = 6e4 if dtype == torch.float16 else 1e6
        k = torch.where(live, k, junk).to(dtype)
        v = torch.where(live, v, -junk).to(dtype)
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
        assert (err <= 2 * _ULP[dtype] * ref.float().abs() + 1e-6).all(), err.max().item()


#: a 16-bit type's unit in the last place, relative
_ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


@pytest.mark.parametrize("L", [1, 37, 512])
@pytest.mark.parametrize("dtype,kv", [(torch.float32, "same"), (torch.bfloat16, "same"),
                                      (torch.float32, "int8")])
def test_decode_attention_split_edges_repeat_bit_for_bit(cuda, L, dtype, kv):
    """The split kernel's edges: positions 0, a middle one and L - 1 in one
    batch (chunks past a position read nothing), a (b, h) whose first 32
    rows have a -inf bias (a chunk of -inf scores: weight 0, not NaN) and a
    single -inf bias entry; against the plain version, twice, bit-equal,
    and the arrival counters left at zero."""
    from unicore_tpu_torch.ops import decode_attention as da

    B, H, D = 3, 4, 64
    g = torch.Generator(device=cuda).manual_seed(L + 11)
    q = (torch.randn(B, H, D, generator=g, device=cuda) * D ** -0.5).to(dtype)
    k = torch.randn(B, H, L, D, generator=g, device=cuda)
    v = torch.randn(B, H, L, D, generator=g, device=cuda)
    pos = torch.tensor([0, L // 2, L - 1], dtype=torch.int32, device=cuda)
    bias = torch.randn(B, H, L, generator=g, device=cuda)
    bias[2, 1, :min(32, L - 1)] = float("-inf")  # row L - 1 stays live
    bias[1, 2, L // 4] = float("-inf") if L // 4 != L // 2 else bias[1, 2, L // 4]
    scales = {}
    if kv == "int8":
        ks = k.abs().amax(dim=(0, 2)) / 127.0 + 1e-8
        vs = v.abs().amax(dim=(0, 2)) / 127.0 + 1e-8
        k = torch.round(k / ks[None, :, None]).clamp(-127, 127).to(torch.int8)
        v = torch.round(v / vs[None, :, None]).clamp(-127, 127).to(torch.int8)
        scales = {"k_scale": ks.contiguous(), "v_scale": vs.contiguous()}
    else:
        k, v = k.to(dtype), v.to(dtype)
    _kernels.reset_launch_counts()
    out = da.decode_attention(q, k, v, pos, bias=bias, **scales)
    again = da.decode_attention(q, k, v, pos, bias=bias, **scales)
    torch.cuda.synchronize()
    assert da.LAUNCHES.count == 2
    assert torch.equal(out, again)
    assert not da._COUNTERS.get(cuda, torch.zeros(1, device=cuda)).any()
    ref = da.decode_attention_plain(q, k, v, pos, bias=bias, **scales)
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5, err.max().item()
    else:
        assert (err <= 2 * 2.0 ** -7 * ref.float().abs() + 1e-6).all(), err.max().item()


@pytest.mark.parametrize("L", [37, 512])
@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32, torch.float16, None])
@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float16])
def test_decode_attention_16bit_q_matches_plain(cuda, L, kv, bias_dtype, qdtype):
    """The 16-bit-query variants (a bf16 or fp16 LM's step): a bf16 or fp16
    q against fp32 or int8 caches, the bias row in any float type, read as
    fp32; mixed positions with junk past them and a chunk of -inf bias;
    against the plain version (which upcasts every operand), twice
    bit-equal, and a bf16 q against fp32 caches counted as
    ``decode_attention_bf16q``, every other call as ``decode_attention``."""
    from unicore_tpu_torch.ops import decode_attention as da

    B, H, D = 8, 12, 64
    g = torch.Generator(device=cuda).manual_seed(L + 3)
    q = (torch.randn(B, H, D, generator=g, device=cuda) * D ** -0.5).to(qdtype)
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
        k = torch.where(live, k, 1e6)
        v = torch.where(live, v, -1e6)
    bias = None
    if bias_dtype is not None:
        bias = torch.randn(B, H, L, generator=g, device=cuda)
        bias[-1, -1, :min(32, L - 1)] = float("-inf")
        bias = bias.to(bias_dtype)
    _kernels.reset_launch_counts()
    out = da.decode_attention(q, k, v, pos, bias=bias, **scales)
    again = da.decode_attention(q, k, v, pos, bias=bias, **scales)
    torch.cuda.synchronize()
    mixed = kv == "float32" and qdtype == torch.bfloat16
    assert da.LAUNCHES_BF16Q.count == (2 if mixed else 0)
    assert da.LAUNCHES.count == (0 if mixed else 2)
    assert torch.equal(out, again)
    ref = da.decode_attention_plain(q, k, v, pos, bias=bias, **scales)
    assert out.dtype == qdtype and out.shape == (B, H, D)
    assert torch.isfinite(out.float()).all() and out.float().abs().max() < 100
    err = (out.float() - ref.float()).abs()
    assert (err <= 2 * _ULP[qdtype] * ref.float().abs() + 1e-6).all(), err.max().item()


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
    with pytest.raises(NotImplementedError, match="q's type, fp32 or int8"):
        call(cache=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="q's type, fp32 or int8"):
        call(dtype=torch.bfloat16, cache=torch.float16)
    with pytest.raises(ValueError, match="fp32/bf16/fp16"):
        call(dtype=torch.float64, cache=torch.float64)
    with pytest.raises(ValueError, match="int32"):
        call(pos=torch.zeros(2, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(pos=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="bias must be fp32, bf16 or fp16"):
        call(bias=torch.zeros(2, 2, 32, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="bias must be fp32, bf16 or fp16"):
        call(bias=torch.zeros(2, 2, 31, device=cuda))
    with pytest.raises(ValueError, match="together"):
        call(k_scale=torch.ones(2, 64, device=cuda))
    assert da.LAUNCHES.count == 0  # refused calls launch nothing
    call()
    assert da.LAUNCHES.count == 1


def test_engine_swap_on_card_switches_answers_and_releases_memory(cuda):
    """A hot swap on the card: an fp32 BERT (768 wide, 2 layers) serving,
    a bf16 candidate of other weights staged by the reloader's make_model,
    verified and probed by the reloader, swapped on the loop's boundary:
    the answers switch to the candidate's own, and the old model's device
    memory is released at the swap."""
    import numpy as np

    from unicore_tpu_torch.models.bert import BertModel
    from unicore_tpu_torch.serve import HotReloader, ServeEngine, build_infer_fn

    def bert(seed):
        return BertModel(vocab_size=1000, padding_idx=1, encoder_layers=2,
                         generator=torch.Generator().manual_seed(seed)).eval()

    def make_model(weights):
        m = bert(0)
        m.load_state_dict(weights, assign=True)
        return m.to(cuda).eval()

    infer = build_infer_fn(cuda)
    engine = ServeEngine(bert(0).to(cuda), infer, bucket_edges=(128,), batch_size=2,
                         pad_idx=1, vocab_size=1000)
    engine.warmup()
    old_bytes = sum(p.numel() * p.element_size() for p in engine.model.parameters())
    tokens = list(range(5, 45))

    def answer():
        r = engine.submit(tokens, 60.0)
        while not r.done():
            engine.step(timeout=0.01)
        return r.response

    before = answer()
    cand = {k: v.to(torch.bfloat16) for k, v in bert(1).state_dict().items()}
    reloader = HotReloader(engine, loader=lambda path: {"model": cand}, make_model=make_model)
    assert reloader.consider("candidate.pt") == "swapped"
    torch.cuda.synchronize()
    staged = torch.cuda.memory_allocated(cuda)
    engine._apply_pending_swap()
    torch.cuda.synchronize()
    released = staged - torch.cuda.memory_allocated(cuda)
    assert released >= 0.9 * old_bytes, (released, old_bytes)
    assert {p.dtype for p in engine.model.parameters()} == {torch.bfloat16}
    after = answer()
    arr = np.full((2, 128), 1, np.int32)
    arr[0, :len(tokens)] = tokens
    ids, score = infer(engine.model, arr)
    assert after.output == ids[0, :len(tokens)].tolist() and after.score == float(score[0])
    assert after.output != before.output
    assert engine.stats()["reloads_applied"] == 1


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


@pytest.mark.parametrize("M,N,tile_n", [(64, 256, 128), (4096, 768, 192), (300, 768, 256)])
def test_quant_matmul_kernel_sums_exactly(cuda, monkeypatch, M, N, tile_n):
    """+-127 operands over K = 3072 (sums near 5e7, past fp32's 2**24 and
    past an int8 result's wrap): with scale 1 the output is the int32 sum
    rounded once to fp32, bit for bit the plain version's, at each tile
    width (the chooser's 128 and 192; 256 forced)."""
    from unicore_tpu_torch.ops import quant_matmul as qm

    if qm.choose_tile_n(M, N, 3072) != tile_n:
        monkeypatch.setattr(qm, "choose_tile_n", lambda *shape: tile_n)
    g = torch.Generator(device=cuda).manual_seed(3)
    K = 3072
    x = torch.where(torch.rand(M, K, generator=g, device=cuda) < 0.9, 127, -127).to(torch.int8)
    w = torch.full((N, K), 127, dtype=torch.int8, device=cuda)
    w[1::2] = -127
    out = qm.quant_matmul(x, w, torch.ones(N, device=cuda))
    acc = qm.int8_matmul_plain(x, w)
    assert acc.abs().max().item() > 2 ** 24
    assert torch.equal(out, acc.float())


@pytest.mark.parametrize("site,M,K,N,act", [
    ("in_proj", 4096, 768, 2304, ""), ("out_proj", 4096, 768, 768, ""),
    ("fc1", 4096, 768, 3072, "gelu"), ("fc2", 4096, 3072, 768, ""),
    ("lm_head", 4096, 768, 768, "gelu"), ("odd_m", 4093, 768, 2304, ""),
])
def test_quant_matmul_kernel_at_serving_sites(cuda, site, M, K, N, act):
    """#13 at every dense of a served int8 BERT-base batch (8 x 512 rows) and
    at an M that is not a multiple of the tile, with the bias: within 1e-6
    of the output's absmax, one launch."""
    from unicore_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x, w = _int8(g, (M, K), cuda), _int8(g, (N, K), cuda)
    scale = torch.rand(N, generator=g, device=cuda) * 2e-5 + 1e-5
    bias = torch.randn(N, generator=g, device=cuda)
    _kernels.reset_launch_counts()
    out = qm.quant_matmul(x, w, scale, bias, act)
    assert qm.LAUNCHES.count == 1 and out.shape == (M, N)
    ref = qm.quant_matmul_plain(x, w, scale, bias, act)
    err = (out - ref).abs().max().item()
    assert err <= 1e-6 * ref.abs().max().item(), (site, err)


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


# ---------------------------------------------------------------------------
# the mixed-precision inputs of a --bf16 / --fp16 run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,D", [(5, 33), (4096, 768)])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("xdtype,wdtype", [(torch.bfloat16, torch.bfloat16),
                                           (torch.float16, torch.float16),
                                           (torch.float32, torch.bfloat16)])
def test_norm_low_precision_weights_match_plain(cuda, N, D, rms, xdtype, wdtype):
    """The norm kernels with the weight and bias in bf16 or fp16 (and fp16
    x): forward, dx and dw/db against the plain version, the gradients in
    their parameter's type (dw, db summed in fp32, then cast)."""
    g = torch.Generator(device=cuda).manual_seed(N + D)
    x = (torch.randn(2, N, D, generator=g, device=cuda) * 2 + 0.5).to(xdtype)
    dy = torch.randn(2, N, D, generator=g, device=cuda).to(xdtype)
    w = (1 + 0.1 * torch.randn(D, generator=g, device=cuda)).to(wdtype)
    b = None if rms else (0.1 * torch.randn(D, generator=g, device=cuda)).to(wdtype)
    eps = 1e-6 if rms else 1e-5

    def run(fwd):
        xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        bs = None if b is None else b.clone().requires_grad_(True)
        out = fwd(xs, ws, bs)
        out.backward(dy)
        return out.detach(), [xs.grad, ws.grad] + ([] if bs is None else [bs.grad])

    _kernels.reset_launch_counts()
    out, got = run(lambda x, w, b: fn.fused_rms_norm(x, w, eps) if rms
                   else fn.fused_layer_norm(x, w, b, eps))
    assert (fn.LAUNCHES.count, fn.DX_LAUNCHES.count, fn.DWDB_LAUNCHES.count) == (1, 1, 1)
    ref_out, ref = run(lambda x, w, b: fn.fused_norm_plain(x, w, b, eps, rms))
    tol = TOL["norm"][torch.bfloat16] if xdtype != torch.float32 else TOL["norm"][xdtype]
    assert out.dtype == xdtype and _rel_err(out, ref_out) <= tol
    for name, gk, gr, want in zip(("dx", "dw", "db"), got, ref, (xdtype, wdtype, wdtype)):
        assert gk.dtype == gr.dtype == want, name
        ratio = _grad_over_tol(gk, gr, GRAD_TOL["norm"])
        assert ratio <= 1.0, (name, ratio)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_bf16_bias_matches_plain(cuda, causal):
    """BERT-base's and the LM's attention in a --bf16 run: (8, 12, 512, 64)
    bf16 with a bf16 rel-pos bias (plus the causal triangle), the key mask
    and dropout 0.1; forward, dq, dk, dv and dbias (bf16) against the plain
    versions on the same bf16 bias, and with the triangle dbias exactly 0
    above the diagonal."""
    from unicore_tpu_torch.modules.transformer_decoder import CAUSAL_NEG

    B, H, L, D = 8, 12, 512, 64
    q, k, v, do, rel, mask = _attention_inputs(cuda, B, H, L, L, D, H, torch.bfloat16,
                                               seed=13)
    bias = rel
    if causal:
        bias = rel + torch.triu(torch.full((L, L), CAUSAL_NEG, device=cuda), 1)
    bias = bias.to(torch.bfloat16)
    kw = dict(dropout_rate=0.1, sm_scale=0.125, dropout_seed=21)
    _kernels.reset_launch_counts()
    out, grads = _attention_grads(
        lambda q, k, v, b, m, **a: fr.fullrow_attention(q, k, v, bias=b,
                                                       kv_padding_mask=m, **a),
        q, k, v, do, bias, mask, **kw)
    assert fr.LAUNCHES.count == 1 and fr.BWD_LAUNCHES.count == 1
    ref_out = fr.fullrow_attention_plain(q, k, v, bias, mask, 0.125, 0.1, 21)
    assert _rel_err(out, ref_out) <= TOL["attention"][torch.bfloat16]
    args = (q, k, v, bias, mask, do, 0.125, 0.1, 21)
    ref_grads = fr.fullrow_attention_bwd_plain(*args)
    slack = [*fr.bwd_rounding_slack(*args), 0.0]
    assert grads[3].dtype == torch.bfloat16
    for name, got, ref, s in zip(("dq", "dk", "dv", "dbias"), grads, ref_grads, slack):
        ratio = _grad_over_tol(got, ref, GRAD_TOL["attention"], s)
        assert ratio <= 1.0, (name, ratio)
    if causal:
        above = torch.triu(torch.ones(L, L, dtype=torch.bool, device=cuda), 1)
        assert int((grads[3][:, :, above] != 0).sum()) == 0


def test_flash_bf16_bias_matches_plain(cuda):
    """The Evoformer's triangle attention in a --bf16 run: (256, 4, 256, 32)
    bf16 with a bf16 (1, 4, 256, 256) bias and the key mask; forward, dq,
    dk, dv and dbias (bf16) against the plain versions on the same bias."""
    from unicore_tpu_torch.ops import flash_attention as fa

    q, k, v, do, bias, mask = _flash_inputs(cuda, 256, 4, 256, 256, 32, (1, 4, 256, 256),
                                            True, torch.bfloat16, seed=3)
    bias = bias.to(torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    out = fa.flash_attention(*leaves[:3], bias=leaves[3], kv_padding_mask=mask,
                             sm_scale=0.7)
    grads = torch.autograd.grad(out, leaves, do)
    ref_out, _ = fa.flash_attention_fwd_plain(q, k, v, bias, mask, 0.7)
    assert _rel_err(out, ref_out) <= TOL["attention"][torch.bfloat16]
    _, klse = fa._launch_fwd(q, k, v, bias, mask, 0.7, 0.0, 0)
    args = (q, k, v, bias, mask, out.detach(), klse, do, 0.7)
    ref_grads = fa.flash_attention_bwd_plain(*args)
    slack = [*fa.bwd_rounding_slack(*args), 0.0]
    assert grads[3].dtype == torch.bfloat16
    for name, got, ref, s in zip(("dq", "dk", "dv", "dbias"), grads, ref_grads, slack):
        ratio = _grad_over_tol(got, ref, GRAD_TOL["attention"], s)
        assert ratio <= 1.0, (name, ratio)


def test_stochastic_rounding_on_the_card(cuda):
    """``fp32_to_bf16_sr`` on a card tensor: every output one of the two bf16
    neighbours, the mean of 1024 draws within 3 sigma of the input, and the
    same bits from two generators with the same seed."""
    from unicore_tpu_torch.ops.rounding import fp32_to_bf16_sr

    x = torch.randn(4096, generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    draws = torch.stack([fp32_to_bf16_sr(x, g).float() for _ in range(1024)])
    cut = x.view(torch.int32) & ~0xFFFF
    lo, hi = cut.view(torch.float32), (cut + 0x10000).view(torch.float32)
    assert bool(((draws == lo) | (draws == hi)).all())
    sigma = (hi - lo).abs() / 2 / 1024 ** 0.5
    assert bool(((draws.mean(0) - x).abs() <= 3 * sigma + 1e-12).float().mean() >= 0.995)
    a = fp32_to_bf16_sr(x, torch.Generator(device=cuda).manual_seed(9))
    b = fp32_to_bf16_sr(x, torch.Generator(device=cuda).manual_seed(9))
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("n", [1, 3, 4, 8193, 3 * 8192 + 5])
@pytest.mark.parametrize("param_dtype,sr", [(None, False), (torch.bfloat16, False),
                                            (torch.bfloat16, True), (torch.float16, False)])
def test_fused_adam_kernel_bit_for_bit(cuda, n, param_dtype, sr):
    """The ``fused_adam`` kernel (K-b) against ``fused_adam_plain`` on one
    flat group of ``n`` elements in three segments that cover it (decayed,
    not, decayed; chunks that end mid-vector; the plain version updates the
    whole buffer, the kernel the segments, as in a plan whose gaps are
    zeros), the clip from a device norm: m, v, the
    master and the parameter bit for bit, SR included; a non-finite norm
    leaves every buffer as it was."""
    from unicore_tpu_torch.optim import multi_tensor as mt

    g = torch.Generator(device=cuda).manual_seed(n)
    master = torch.randn(n, generator=g, device=cuda)
    m = torch.randn(n, generator=g, device=cuda) * 1e-2
    v = torch.rand(n, generator=g, device=cuda) * 1e-4
    grad = torch.randn(n, generator=g, device=cuda)
    param = None if param_dtype is None else master.to(param_dtype)
    a, b = n // 3 // 4 * 4, (2 * n // 3) // 4 * 4
    segs = [(0, a, True), (a, b - a, False), (b, n - b, True)]
    segs = [s for s in segs if s[1] > 0]
    hp = mt.AdamHyper(0.9, 0.999, 1e-8, 3e-3, 0.1, 1.0 - 3e-3 * 0.1)
    denom = torch.tensor(7.0, device=cuda)
    gnorm = mt.multi_tensor_l2norm([grad], denom)
    kw = dict(denom=denom, gnorm=gnorm, max_norm=0.5, sr_key=(5, 6) if sr else None,
              buffer_id=2)
    got = [t.clone() if t is not None else None for t in (master, m, v, param)]
    ref = [t.clone() if t is not None else None for t in (master, m, v, param)]
    mt.fused_adam(got[0], got[1], got[2], grad, mt.chunk_table(segs, cuda), hp, got[3], **kw)
    mt.fused_adam_plain(ref[0], ref[1], ref[2], grad, segs, hp, ref[3], **kw)
    for x, y in zip(got, ref):
        if x is not None:
            view = torch.int16 if x.element_size() == 2 else torch.int32
            assert torch.equal(x.view(view), y.view(view))
    before = [t.clone() for t in got if t is not None]
    kw["gnorm"] = torch.tensor(float("nan"), device=cuda)
    mt.fused_adam(got[0], got[1], got[2], grad, mt.chunk_table(segs, cuda), hp, got[3], **kw)
    assert all(torch.equal(x, y) for x, y in zip([t for t in got if t is not None], before))


@pytest.mark.parametrize("sizes", [[1], [5, 3], [1_000_003], [4096, 77, 1 << 20]])
def test_l2norm_kernel_matches_and_repeats(cuda, sizes):
    """The ``multi_tensor_l2norm`` kernel (K-a) over several buffers, each
    element divided by a device scalar: within 1e-6 relative of the fp64
    norm, the same bits on a second call, one launch count per buffer."""
    from unicore_tpu_torch.optim import multi_tensor as mt

    g = torch.Generator(device=cuda).manual_seed(len(sizes))
    bufs = [torch.randn(n, generator=g, device=cuda) for n in sizes]
    denom = torch.tensor(0.25, device=cuda)
    before = mt.NORM_LAUNCHES.count
    a = mt.multi_tensor_l2norm(bufs, denom)
    b = mt.multi_tensor_l2norm(bufs, denom)
    assert mt.NORM_LAUNCHES.count - before == 2 * len(sizes)
    ref = torch.cat([x.double() / 0.25 for x in bufs]).norm().item()
    assert abs(a.item() - ref) <= 1e-6 * ref
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    with pytest.raises(ValueError):
        mt.multi_tensor_l2norm([bufs[0][1:]] if bufs[0].numel() > 1 else
                               [torch.zeros(3, dtype=torch.float64, device=cuda)])


def _fused_bf16_trainer(device, ema=True):
    """A 2-layer BERT trainer on the card under ``--fused-adam --bf16``
    with the sentinel armed (no task: the state is what matters here)."""
    from unicore_tpu_torch import options
    from unicore_tpu_torch.trainer import Trainer

    argv = ["unused", "--arch", "bert_tiny", "--optimizer", "adam", "--fused-adam", "--bf16",
            "--lr", "1e-3", "--sentinel-interval", "1", "--snapshot-interval", "1",
            "--snapshot-keep", "2"] + (["--ema-decay", "0.9"] if ema else [])
    args = options.parse_args_and_arch(options.get_training_parser(), argv)
    gen = torch.Generator().manual_seed(11)
    model = BertModel(vocab_size=50, padding_idx=1, encoder_layers=2, encoder_embed_dim=64,
                      encoder_ffn_embed_dim=128, encoder_attention_heads=4, max_seq_len=256,
                      generator=gen)
    return Trainer(args, None, model, None, device)


def _scramble(tr, seed):
    """Move every tensor of the training state, as updates would."""
    g = torch.Generator(device=tr.device).manual_seed(seed)
    with torch.no_grad():
        for t in tr._live_state().values():
            t.add_(torch.randn(t.shape, generator=g, device=t.device).to(t.dtype))
    tr._optimizer.num_steps += 3
    tr.set_num_updates(tr.get_num_updates() + 3)


def test_health_snapshot_round_trip_on_card(cuda):
    """Capture (pinned host buffers, side stream) and restore (in place)
    bit for bit under ``--fused-adam --bf16`` with the EMA: the flat
    buffers, the EMA, the step counts; the parameters still views into
    their flat buffer; a second capture reuses the ring slot's buffers once
    the ring is full."""
    tr = _fused_bf16_trainer(cuda)
    _scramble(tr, 1)
    want = {k: v.clone() for k, v in tr._live_state().items()}
    steps = (tr.get_num_updates(), tr._optimizer.num_steps)
    snap = tr.capture_health_snapshot()
    tr.sentinel.ring.add(snap)
    assert all(t.is_pinned() and t.device.type == "cpu" for t in snap.state.values())
    assert snap.extra["event"] is not None and snap.nbytes == sum(
        t.numel() * t.element_size() for t in want.values())
    tr._await_snapshot()  # what the next optimizer step does before it writes
    _scramble(tr, 2)
    tr.restore_health_snapshot(snap)
    torch.cuda.synchronize()
    live = tr._live_state()
    for k, v in live.items():
        assert torch.equal(v.view(torch.int16) if v.element_size() == 2 else v.view(torch.int32),
                           want[k].view(torch.int16) if v.element_size() == 2
                           else want[k].view(torch.int32)), k
    assert (tr.get_num_updates(), tr._optimizer.num_steps) == steps
    opt = tr._optimizer
    for group, bufs in zip(opt.plan.groups, opt.flat):
        for seg in group.segments:
            p = tr.params[seg.name]
            assert p.data_ptr() == bufs["param"][seg.start:].data_ptr(), seg.name
            assert opt.master[seg.name].data_ptr() == bufs["master"][seg.start:].data_ptr()
    # the ring's slots: two allocated, then the oldest's reused
    first = snap.state
    tr.sentinel.ring.add(tr.capture_health_snapshot())
    third = tr.capture_health_snapshot()
    assert third.state is first and len(tr._snap_slots) == 2
    assert all(r["copy_ms"] is not None for r in tr.snapshot_timings())


def test_fault_multipliers_through_the_optimizer_kernels(cuda):
    """An injected loss spike's denominator through K-a and K-b (the
    ``--fused-adam`` kernels) against their plain versions: the norm within
    1e-6 relative, the update bit for bit, 100x the norm of the unscaled
    gradient."""
    from argparse import Namespace

    from unicore_tpu_torch.distributed import chaos
    from unicore_tpu_torch.optim import multi_tensor as mt

    chaos.configure(Namespace(fault_inject="loss-spike:100@4"))
    try:
        loss_mul, grad_mul = chaos.fault_multipliers(4)
    finally:
        chaos.reset()
    assert (loss_mul, grad_mul) == (100.0, 1.0)
    n = 3 * 8192 + 5
    g = torch.Generator(device=cuda).manual_seed(3)
    grad = torch.randn(n, generator=g, device=cuda)
    master = torch.randn(n, generator=g, device=cuda)
    m = torch.zeros(n, device=cuda)
    v = torch.zeros(n, device=cuda)
    param = master.to(torch.bfloat16)
    denom = torch.tensor(16.0, device=cuda) / (loss_mul * grad_mul)
    gnorm = mt.multi_tensor_l2norm([grad], denom)
    ref_norm = mt.multi_tensor_l2norm_plain([grad.cpu()], denom.cpu())
    assert abs(gnorm.item() - ref_norm.item()) <= 1e-6 * ref_norm.item()
    base = mt.multi_tensor_l2norm([grad], torch.tensor(16.0, device=cuda))
    assert gnorm.item() == pytest.approx(100.0 * base.item(), rel=1e-6)
    segs = [(0, n, True)]
    hp = mt.AdamHyper(0.9, 0.98, 1e-6, 1e-3, 1e-4, 1.0 - 1e-3 * 1e-4)
    kw = dict(denom=denom, gnorm=gnorm, max_norm=1.0, sr_key=None, buffer_id=0)
    got = [t.clone() for t in (master, m, v, param)]
    ref = [t.clone() for t in (master, m, v, param)]
    mt.fused_adam(got[0], got[1], got[2], grad, mt.chunk_table(segs, cuda), hp, got[3], **kw)
    mt.fused_adam_plain(ref[0], ref[1], ref[2], grad, segs, hp, ref[3], **kw)
    for x, y in zip(got, ref):
        view = torch.int16 if x.element_size() == 2 else torch.int32
        assert torch.equal(x.view(view), y.view(view))
