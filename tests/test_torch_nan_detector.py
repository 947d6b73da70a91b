"""The port's NaN detector and ``--nan-rerun`` against the JAX package's on
the CPU: ``bert_tiny`` with a NaN written into one weight.

- the forward check names the first module whose output is non-finite.
  With the NaN in layer 1's ``self_attn.in_proj`` kernel both packages name
  that module (under ``checkpoint_utils.flax_path``).  With it in layer 1's
  ``fc1`` kernel the port names ``fc1`` and the JAX package the layer's
  inline ``Dropout_0`` whose second call follows ``fc1``: flax's
  intermediates list a child where its FIRST call lands, and that dropout
  first ran after the attention (a deliberate difference, ROADMAP C); both
  name layer 1;
- ``check_grads`` names the same parameter (the first in the JAX
  package's sorted order, under ``jax_param_names``);
- ``train_step`` under ``--nan-rerun`` raises ``FloatingPointError`` with
  the finding; without the flag the update is skipped and nothing raises.
"""

import re

import jax
import numpy as np
import pytest

from unicore_tpu.parallel.mesh import get_global_mesh, set_global_mesh
from unicore_tpu.parallel.plan import get_global_plan, set_global_plan

from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.trainer import _to_device

from torch_trainer_pair import port_trainer, setup


@pytest.fixture(autouse=True)
def _restore_parallel_plan():
    # a JAX Trainer sets the JAX package's process-global parallel plan and
    # mesh: put back what was there, so later tests in this process see it
    # (a plan and a mesh left together shard test_decode's KV pools)
    plan, mesh = get_global_plan(), get_global_mesh()
    yield
    set_global_plan(plan)
    set_global_mesh(mesh)


POISON = {"in_proj": ("self_attn", "in_proj"), "fc1": ("fc1",)}


def _names(detail):
    fwd = re.search(r"forward output of (\S+?)[;:]", detail).group(1)
    grad = re.search(r"gradient of parameter (\S+)", detail).group(1)
    return fwd, grad


@pytest.mark.parametrize("where", list(POISON))
def test_nan_rerun_names_the_module_as_jax(tmp_path, where):
    args, task, samples, jax_tr, variables = setup(tmp_path, 2, n_docs=16, nan_rerun=True)
    params = jax.tree_util.tree_map(np.array, variables)
    leaf = params["params"]["sentence_encoder"]["layers_1"]
    for k in POISON[where]:
        leaf = leaf[k]
    leaf["kernel"][0, 0] = np.nan
    jax_tr._state["params"] = jax.tree_util.tree_map(jax.numpy.asarray, params)
    jax_fwd, jax_grad = _names(jax_tr._localize_nan(samples[:1]))

    port_tr = port_trainer(args, task, params)
    port_fwd, port_grad = _names(port_tr._localize_nan([_to_device(samples[0], "cpu")]))
    jax_module = jax_fwd.split("/__call__")[0].replace("/", ".")
    port_module = checkpoint_utils.flax_path(port_fwd)
    assert port_module == "sentence_encoder.layers_1." + ".".join(POISON[where])
    if where == "in_proj":
        assert jax_module == port_module
    else:
        assert jax_module == "sentence_encoder.layers_1.Dropout_0"
    assert port_grad in port_tr.params
    assert checkpoint_utils.jax_param_names(port_tr.model)[port_grad] == \
        jax_grad.replace("params/", "", 1).replace("/", ".")

    with pytest.raises(FloatingPointError, match=re.escape(port_fwd)):
        port_tr.train_step(samples[:1])
    port_tr.args.nan_rerun = False
    assert not np.isfinite(port_tr.train_step(samples[1:2]))
    assert port_tr.overflows == 2
