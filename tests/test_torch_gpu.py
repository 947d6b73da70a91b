"""The port's CUDA kernels against their plain versions ON THE CARD, at
shapes the chip smoke does not reach (no bias, a shared bias, no mask,
Lq != Lk, head dims 8/12/16/128, 1024 key rows — the most shared memory
the kernel asks for inside the ``supported()`` gate; norm widths 8 to 8192
and tiny row counts), plus the wrappers' refusals and a tiny BERT on the
card against the same weights on the CPU.

Marked ``gpu``: each test takes the ``cuda`` fixture, which skips without a
card, so on the CPU every test here is skipped.  On a machine with a card
(which need not have JAX)::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py

Tolerances, kernel vs plain version on the same card inputs: fp32 2e-5
(attention) / 1e-5 (norm) absolute — the two differ only in summation
order; bf16 2e-2 (attention) / 6.25e-2 (norm) — last-bit fp32 differences
may round to neighbouring bf16 values (one ulp is 2**-4 below 16).  BERT
logits: 1e-4 absolute, card vs CPU in fp32 with TF32 off.
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
    with pytest.raises(NotImplementedError, match="dropout"):
        fr.fullrow_attention(q, q, q, dropout_rate=0.1)
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
