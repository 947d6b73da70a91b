"""``--per-sample-clip-norm`` in the port's trainer on the CPU.

- against the JAX trainer's per-sample path (``bert_tiny``, dropout 0,
  batch 4, 2 updates, per-sample norm 0.1, so every row is clipped): each
  update's loss within 1e-5 relative, the parameters within 1e-5 absolute
  (the JAX package vmaps per-row gradients, the port loops over the rows
  with batch-1 backwards; the sums run in another order);
- a per-sample norm far above every row's gradient norm gives the
  unclipped run: losses within 1e-6 relative and parameters within 1e-6
  absolute (the per-row gradients are summed in another order).
"""

import copy

import pytest

from unicore_tpu.parallel.mesh import get_global_mesh, set_global_mesh
from unicore_tpu.parallel.plan import get_global_plan, set_global_plan

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


UPDATES = 2


def test_per_sample_clip_matches_jax(tmp_path):
    args, task, samples, jax_tr, variables = setup(
        tmp_path, UPDATES, per_sample_clip_norm=0.1, update_freq=[1],
        total_num_update=UPDATES, max_update=UPDATES)
    port_tr = port_trainer(args, task, variables)
    jax_losses, port_losses = run_both(jax_tr, port_tr, [[s] for s in samples])
    assert_close_losses(port_losses, jax_losses, 1e-5)
    assert max_param_diff(port_tr.model, jax_tr) <= 1e-5


def test_per_sample_clip_far_above_every_row_is_unclipped(tmp_path):
    args, task, samples, _, variables = setup(tmp_path, UPDATES, update_freq=[1])
    clipped_args = copy.copy(args)
    clipped_args.per_sample_clip_norm = 1e6
    plain, per_row = port_trainer(args, task, variables), port_trainer(clipped_args, task,
                                                                       variables)
    for tr in (plain, per_row):
        tr.begin_epoch(1)
        for s in samples:
            tr.train_step([s])
    assert_close_losses(per_row.update_losses, plain.update_losses, 1e-6)
    for (n, p), q in zip(plain.model.named_parameters(), per_row.model.parameters()):
        assert float((p - q).detach().abs().max()) <= 1e-6, n
