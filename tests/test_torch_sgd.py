"""``sgd`` (momentum 0 and 0.9, with and without weight decay), ``adagrad``
and ``adadelta`` of the port against the JAX optimizers on the CPU: the
same parameter tree and five steps of the same gradients, parameters and
slots within 1e-6 absolute (both compute in fp32; the two differ only
where one multiply-add rounds twice on one side)."""

from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicore_tpu.optim import OPTIMIZER_REGISTRY as JAX_OPTIMIZERS
from unicore_tpu.optim.unicore_optimizer import _path_str

from unicore_tpu_torch.optim import OPTIMIZER_REGISTRY as PORT_OPTIMIZERS

CASES = {
    "sgd": dict(optimizer="sgd", momentum=0.0, weight_decay=0.0),
    "sgd_wd": dict(optimizer="sgd", momentum=0.0, weight_decay=0.1),
    "sgd_momentum": dict(optimizer="sgd", momentum=0.9, weight_decay=0.0),
    "sgd_momentum_wd": dict(optimizer="sgd", momentum=0.9, weight_decay=0.1),
    "adagrad": dict(optimizer="adagrad", weight_decay=0.1, adagrad_eps=1e-10),
    "adadelta": dict(optimizer="adadelta", weight_decay=0.1, adadelta_rho=0.9,
                     adadelta_eps=1e-6),
}


def _tree():
    r = np.random.RandomState(0)
    w = lambda *s: r.randn(*s).astype(np.float32)  # noqa: E731
    return {"encoder": {"layer0": {"kernel": w(8, 6), "bias": w(6)},
                        "layer_norm": {"weight": w(6)}},
            "head": {"kernel": w(6, 3)}}


def _flat(tree):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_jax(case):
    args = Namespace(bf16_sr=False, no_weight_decay_names="", **CASES[case])
    lr = 0.5 if case == "adadelta" else 0.05
    params = _tree()
    jax_opt = JAX_OPTIMIZERS[args.optimizer](args)
    params_j = jax.tree_util.tree_map(jnp.asarray, params)
    state_j = jax_opt.init_state(params_j)

    port = PORT_OPTIMIZERS[args.optimizer](args)
    params_t = {n: torch.tensor(v) for n, v in _flat(params).items()}
    port.init_state(params_t, {n: n for n in params_t})
    assert not port.supports_accum

    r = np.random.RandomState(1)
    for _ in range(5):
        grads = jax.tree_util.tree_map(lambda p: (r.randn(*p.shape) * 0.3).astype(np.float32),
                                       params)
        params_j, state_j = jax_opt.update(jax.tree_util.tree_map(jnp.asarray, grads), state_j,
                                           params_j, jnp.float32(lr))
        port.step(params_t, {n: torch.tensor(v) for n, v in _flat(grads).items()}, lr)
    assert port.num_steps == int(state_j["step"]) == 5
    for n, ref in _flat(params_j).items():
        np.testing.assert_allclose(params_t[n].numpy(), ref, atol=1e-6, rtol=0, err_msg=n)
    for slot, tree in state_j["slots"].items():
        for n, ref in _flat(tree).items():
            np.testing.assert_allclose(port.state[n][slot].numpy(), ref, atol=1e-6, rtol=0,
                                       err_msg=f"{slot} {n}")
