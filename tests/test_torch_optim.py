"""The port's optimizer path against the JAX package's on the CPU, over five
steps on the same gradients: the decay mask over a BERT parameter tree
(through the Flax-name map), the global-norm clip, Adam with decoupled
decay and the ``polynomial_decay`` schedule.

Tolerances: the lr is equal at every step (both compute it in Python
floats from the same formula); the gradient norm within 1e-6 relative and
the parameters within 1e-6 absolute — both sides compute in fp32 and
differ only in the order of their sums.
"""

from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unicore_tpu import utils as jax_utils
from unicore_tpu.models.bert import BertModel as JaxBert
from unicore_tpu.optim import build_optimizer as jax_build_optimizer
from unicore_tpu.optim.lr_scheduler import build_lr_scheduler as jax_build_sched
from unicore_tpu.optim.unicore_optimizer import _path_str, make_decay_mask

from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.models.bert import BertModel as PortBert
from unicore_tpu_torch.optim import build_optimizer as port_build_optimizer
from unicore_tpu_torch.optim.lr_scheduler import build_lr_scheduler as port_build_sched
from unicore_tpu_torch.optim.unicore_optimizer import clip_grad_norm

TINY = dict(vocab_size=40, padding_idx=1, encoder_layers=2, encoder_embed_dim=32,
            encoder_ffn_embed_dim=64, encoder_attention_heads=4, max_seq_len=128)


def opt_args():
    return Namespace(optimizer="adam", adam_betas="(0.9, 0.98)", adam_eps=1e-6,
                     weight_decay=0.05, fused_adam=False, lr=[3e-3],
                     lr_scheduler="polynomial_decay", warmup_updates=2,
                     warmup_ratio=-1.0, total_num_update=6, end_learning_rate=0.0,
                     power=1.0, force_anneal=None, max_update=6)


@pytest.mark.parametrize("clip_norm", [0.5, 0.0])
def test_adam_clip_schedule_match_jax(clip_norm):
    variables = JaxBert(**TINY).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params_j = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    model = PortBert(**TINY)
    model.load_state_dict(checkpoint_utils.from_jax_params(variables))
    params_t = dict(model.named_parameters())
    jax_names = checkpoint_utils.jax_param_names(model)

    opt_j, opt_t = jax_build_optimizer(opt_args()), port_build_optimizer(opt_args())
    state_j = opt_j.init_state(params_j)
    opt_t.init_state(params_t, jax_names)
    mask = {_path_str(p): bool(m) for p, m in
            jax.tree_util.tree_flatten_with_path(make_decay_mask(params_j))[0]}
    assert {jax_names[n]: opt_t.decay[n] for n in params_t} == mask
    assert 0 < sum(mask.values()) < len(mask)

    sched_j = jax_build_sched(opt_args(), opt_j, 6)
    sched_t = port_build_sched(opt_args(), opt_t, 6)
    for s in (sched_j, sched_t):  # as the trainers start an epoch
        s.step_begin_epoch(1)
        s.step_update(0)

    rng = np.random.default_rng(1)
    for step in range(5):
        lr_j, lr_t = sched_j.get_lr(), sched_t.get_lr()
        assert lr_j == lr_t, (step, lr_j, lr_t)
        grads_np = jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape) * 0.05).astype(np.float32),
            params_j)
        grads_j, gnorm_j = jax_utils.clip_grad_norm(
            jax.tree_util.tree_map(jnp.asarray, grads_np), clip_norm)
        params_j, state_j = opt_j.update(grads_j, state_j, params_j,
                                         jnp.float32(lr_j))
        grads_t = checkpoint_utils.from_jax_params(grads_np)
        gnorm_t = clip_grad_norm(grads_t, clip_norm)
        opt_t.step(params_t, grads_t, lr_t)
        assert abs(float(gnorm_t) - float(gnorm_j)) <= 1e-6 * float(gnorm_j)
        ref = checkpoint_utils.from_jax_params(jax.device_get(params_j))
        for name, p in params_t.items():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)
        sched_j.step_update(step + 1)
        sched_t.step_update(step + 1)
    assert opt_t.num_steps == int(state_j["step"]) == 5
