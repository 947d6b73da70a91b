"""``--grad-accum adama`` in the port's trainer on the CPU.

- against the JAX trainer's adama (``bert_tiny``, ``--update-freq 3``, 3
  updates, dropout 0, clip 1.0, weight decay): each update's loss within
  1e-5 relative, the parameters within 1e-5 absolute (the two agree to
  about 1e-7; an update misapplied moves a weight by up to the lr, 1e-3);
- a micro-batch whose gradient is NaN skips the update and leaves the
  moments, the parameters and the step count bit for bit;
- ``ValueError`` for an optimizer that cannot fold (``sgd``), worded as the
  JAX trainer words it.
"""

import pytest
import torch

from unicore_tpu.parallel.mesh import get_global_mesh, set_global_mesh
from unicore_tpu.parallel.plan import get_global_plan, set_global_plan
from unicore_tpu.trainer import Trainer as JaxTrainer

from torch_trainer_pair import (assert_close_losses, max_param_diff, port_trainer, run_both,
                                setup)


@pytest.fixture(autouse=True)
def _restore_parallel_plan():
    # a JAX Trainer sets the JAX package's process-global parallel plan and
    # mesh: put back what was there, so later tests in this process see it
    # (a plan and a mesh left together shard test_decode's KV pools)
    plan, mesh = get_global_plan(), get_global_mesh()
    yield
    set_global_plan(plan)
    set_global_mesh(mesh)


UF, UPDATES = 3, 3


def test_adama_matches_jax(tmp_path):
    args, task, samples, jax_tr, variables = setup(
        tmp_path, UF * UPDATES, grad_accum="adama", update_freq=[UF], total_num_update=UPDATES,
        max_update=UPDATES)
    assert jax_tr.grad_accum_mode == "adama"
    port_tr = port_trainer(args, task, variables)
    groups = [samples[i * UF:(i + 1) * UF] for i in range(UPDATES)]
    jax_losses, port_losses = run_both(jax_tr, port_tr, groups)
    assert_close_losses(port_losses, jax_losses, 1e-5)
    assert port_tr._optimizer.num_steps == UPDATES
    assert max_param_diff(port_tr.model, jax_tr) <= 1e-5


def test_adama_nan_micro_batch_skips_and_keeps_moments(tmp_path):
    args, task, samples, _, variables = setup(tmp_path, 2 * UF, grad_accum="adama",
                                              update_freq=[UF])
    tr = port_trainer(args, task, variables)
    tr.begin_epoch(1)
    tr.train_step(samples[:UF])
    opt = tr._optimizer
    before = {n: {k: v.clone() for k, v in s.items()} for n, s in opt.state.items()}
    params = {n: p.detach().clone() for n, p in tr.params.items()}
    calls = []

    def poison(g):  # the second micro-batch's gradient of one weight is NaN
        calls.append(1)
        return g * float("nan") if len(calls) == 2 else g

    handle = tr.params["sentence_encoder.layers.0.fc1.weight"].register_hook(poison)
    try:
        gnorm = tr.train_step(samples[UF:2 * UF])
    finally:
        handle.remove()
    assert len(calls) == UF and not torch.isfinite(torch.tensor(gnorm))
    assert tr.overflows == 1 and opt.num_steps == 1 and tr.get_num_updates() == 2
    for n, s in opt.state.items():
        for k, v in s.items():
            assert torch.equal(v.view(torch.int32), before[n][k].view(torch.int32)), (n, k)
        assert torch.equal(tr.params[n].detach(), params[n]), n


def test_adama_refuses_an_optimizer_without_accumulators(tmp_path):
    args, task, _, _, variables = setup(tmp_path, 1, n_docs=8)
    args.grad_accum, args.optimizer, args.momentum = "adama", "sgd", 0.0
    with pytest.raises(ValueError) as jax_err:
        JaxTrainer(args, None, None, None)
    with pytest.raises(ValueError) as port_err:
        port_trainer(args, task, variables)
    assert "SGD does not support" in str(port_err.value)
    assert str(port_err.value) == str(jax_err.value)
