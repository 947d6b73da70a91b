"""The port's BERT (unicore_tpu_torch/models/bert.py) against the JAX
package's on the CPU: the same weights (JAX variables → ``from_jax_params``)
and the same numpy tokens through both.

JAX on the CPU takes its fused-softmax route; the port takes its full-row
route (the plain version on a CPU tensor), as it does on the card.  The two
differ only on a batch row with no real token at all (full-row gives zeros
there, the fused route a uniform softmax), so logits are compared on every
row that holds a real token.

Tolerance: fp32 1e-4 absolute on logits of magnitude ~1 — two layers of
fp32 matmuls, softmaxes and norms whose sums run in different orders.
"""

from argparse import Namespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unicore_tpu.models.bert import BertModel as JaxBert
from unicore_tpu.modules import transformer_encoder as jax_te

from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.models.bert import BertModel as PortBert
from unicore_tpu_torch.models.bert import bert_tiny_architecture
from unicore_tpu_torch.modules import transformer_encoder as port_te
from unicore_tpu_torch.ops import _kernels

ATOL = 1e-4
VOCAB, PAD = 50, 1
TINY = dict(encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
            encoder_attention_heads=4, max_seq_len=128)


@pytest.mark.parametrize("L,bins,dist", [(64, 32, 128), (512, 32, 128),
                                         (300, 16, 64)])
def test_rp_bucket_matches_jax(L, bins, dist):
    np.testing.assert_array_equal(
        port_te.make_rp_bucket(L, bins, dist), jax_te.make_rp_bucket(L, bins, dist)
    )


def random_jax_variables(post_ln, seed=0, vocab=VOCAB):
    """A JAX tiny-BERT variables tree whose every leaf is redrawn from a
    numpy seed (non-trivial LayerNorm affines and biases included)."""
    model = JaxBert(vocab_size=vocab, padding_idx=PAD, post_ln=post_ln,
                    **TINY)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    )
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "layer_norm" in name and name.endswith("['weight']"):
            base = 1.0
        else:
            base = 0.0
        return (base + 0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    return model, jax.tree_util.tree_map(np.asarray, variables)


def port_model(variables, post_ln, vocab=VOCAB):
    model = PortBert(vocab_size=vocab, padding_idx=PAD, post_ln=post_ln, **TINY)
    model.load_state_dict(checkpoint_utils.from_jax_params(variables))
    return model.eval()


def _tokens(L, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(4, VOCAB, size=(4, L)).astype(np.int32)
    tok[1, L // 3:] = PAD       # ragged
    tok[2, 5] = PAD             # a pad inside real tokens
    tok[3, :] = PAD             # a dummy fill row: no real token
    return tok


@pytest.mark.parametrize("post_ln", [True, False])
@pytest.mark.parametrize("L", [128, 64])
def test_logits_match_jax(post_ln, L):
    jax_model, variables = random_jax_variables(post_ln)
    model = port_model(variables, post_ln)
    tok = _tokens(L, seed=L)
    ref = np.asarray(jax_model.apply(variables, jnp.asarray(tok), train=False))
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        out = model(torch.from_numpy(tok).long()).numpy()
    assert out.shape == ref.shape == (4, L, VOCAB)
    real_rows = (tok != PAD).any(axis=1)
    assert real_rows.tolist() == [True, True, True, False]
    np.testing.assert_allclose(out[real_rows], ref[real_rows], rtol=0, atol=ATOL)
    assert np.isfinite(out).all()
    assert sum(_kernels.launch_counts().values()) == 0  # CPU: plain only


def test_from_jax_params_names_and_layout():
    _, variables = random_jax_variables(post_ln=True)
    sd = checkpoint_utils.from_jax_params(variables)
    p = variables["params"]
    enc = p["sentence_encoder"]
    np.testing.assert_array_equal(
        sd["sentence_encoder.layers.1.self_attn.in_proj.weight"].numpy(),
        enc["layers_1"]["self_attn"]["in_proj"]["kernel"].T,
    )
    np.testing.assert_array_equal(
        sd["sentence_encoder.relative_attention_bias.weight"].numpy(),
        enc["relative_attention_bias"]["embedding"],
    )
    np.testing.assert_array_equal(sd["lm_head.bias"].numpy(), p["lm_head"]["bias"])
    port = PortBert(vocab_size=VOCAB, padding_idx=PAD, post_ln=True, **TINY)
    assert set(sd) == set(port.state_dict())


def test_checkpoint_round_trip(tmp_path):
    _, variables = random_jax_variables(post_ln=True)
    args = Namespace(task="bert", arch="bert_tiny", data=str(tmp_path))
    bert_tiny_architecture(args)
    path = str(tmp_path / "ckpt.pt")
    checkpoint_utils.write_checkpoint(
        path, args, checkpoint_utils.from_jax_params(variables)
    )
    state = checkpoint_utils.load_checkpoint_to_cpu(path)
    assert state["args"].arch == "bert_tiny"
    assert state["args"].encoder_embed_dim == 64
    model = port_model(variables, post_ln=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(state["model"][k], v, rtol=0, atol=0)
