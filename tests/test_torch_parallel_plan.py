"""The port's ``ParallelPlan`` (``unicore_tpu_torch/parallel/plan.py``, its
own copy) against the JAX package's (``unicore_tpu/parallel/plan.py``).

Over the same plans, both give the same legality verdict and rule name
(message text included), the same resolved ``data`` / ``pod_size`` /
``has_dcn`` / ``dp_axes``, the same ``describe()`` and ``to_json()``,
exactly; ``plan_from_args`` and ``resolve_deterministic_reductions`` read
the same flags.  Beside it: what the port refuses (``refuse_unported``;
the ZeRO flags resolve, ``parallel/zero.py``),
the groups' rank layout and the backend choice of ``distributed/utils.py``
(no process group needed)."""

from argparse import Namespace

import pytest

from unicore_tpu.parallel import plan as jax_plan

from unicore_tpu_torch.distributed import utils as port_dist
from unicore_tpu_torch.parallel import plan as port_plan

#: (plan kwargs, world size or None)
PLANS = [
    (dict(data=2), 2),
    (dict(), 2),
    (dict(), 4),
    (dict(pods=2, data=1), 2),
    (dict(pods=2, data=2), 4),
    (dict(pods=2), 4),
    (dict(pods=2, data=2, xpod_combine="adasum", deterministic_reductions=True), 4),
    (dict(pods=4, data=2, xpod_combine="adasum"), 8),
    (dict(data=4, model=2), 8),
    (dict(pods=2, data=1), None),
    (dict(data=3), 4),
    (dict(pods=3), 4),
    (dict(model=0), 2),
    (dict(data=-2), 2),
    (dict(pods=2, xpod_combine="avg"), 4),
    (dict(seq=2, pipe=2, seq_impl="ulysses"), 4),
    (dict(seq_impl="zigzag"), 2),
]


def _resolve(mod, kwargs, world):
    try:
        plan = mod.ParallelPlan(**kwargs).validate(world)
    except mod.PlanLegalityError as err:
        return ("rejected", err.rule, str(err))
    return ("accepted", plan.data, plan.pod_size, plan.has_dcn, plan.dp_axes(),
            plan.describe(), plan.to_json(), plan.mesh_shape(), plan.tiers())


@pytest.mark.parametrize("kwargs,world", PLANS, ids=lambda v: repr(v))
def test_plan_matches_jax(kwargs, world):
    assert _resolve(port_plan, kwargs, world) == _resolve(jax_plan, kwargs, world)


def _args(**kw):
    base = dict(data_parallel_size=-1, model_parallel_size=1, seq_parallel_size=1,
                pipeline_parallel_size=1, expert_parallel_size=1, num_pods=1,
                xpod_combine="sum", deterministic_reductions=False,
                seq_parallel_impl="ring")
    base.update(kw)
    return Namespace(**base)


@pytest.mark.parametrize("kw", [
    dict(num_pods=2, data_parallel_size=4, xpod_combine="adasum"),
    dict(num_pods=2, deterministic_reductions=True),
    dict(moe_deterministic_reduction=True),
    dict(num_pods=2, xpod_combine="median"),
], ids=lambda v: repr(v))
def test_plan_from_args_matches_jax(kw):
    def resolve(mod):
        try:
            plan = mod.plan_from_args(_args(**kw))
        except mod.PlanLegalityError as err:
            return ("rejected", err.rule, str(err))
        return ("accepted", plan.describe(), plan.to_json(),
                mod.resolve_deterministic_reductions(_args(**kw)))

    assert resolve(port_plan) == resolve(jax_plan)


def test_global_plan_round_trip():
    plan = port_plan.ParallelPlan(pods=2, data=1)
    port_plan.set_global_plan(plan)
    try:
        assert port_plan.get_global_plan() is plan
    finally:
        port_plan.set_global_plan(None)
    assert port_plan.get_global_plan() is None


@pytest.mark.parametrize("flag,value,name", [
    ("zero_stage", 1, "--zero-stage"),
    ("zero_stage", 3, "--zero-stage"),
    ("zero_shard_optimizer", True, "--zero-stage"),
    ("model_parallel_size", 2, "--model-parallel-size"),
    ("expert_parallel_size", 2, "--expert-parallel-size"),
    ("seq_parallel_size", 2, "--seq-parallel-size"),
])
def test_unported_parallelism_names_the_queue(flag, value, name):
    """The model, expert and seq axes raise, naming the queue; the ZeRO
    flags, ported since, pass and resolve to the JAX package's stage."""
    from unicore_tpu.parallel.sharding import resolve_zero_stage as jax_resolve

    from unicore_tpu_torch.parallel import zero

    args = _args(zero_stage=0, zero_shard_optimizer=False, fused_adam=True)
    setattr(args, flag, value)
    if flag.startswith("zero"):
        port_plan.refuse_unported(args)
        want = value if flag == "zero_stage" else 1
        assert zero.resolve_zero_stage(args) == jax_resolve(args) == want
        return
    with pytest.raises(NotImplementedError, match=name) as err:
        port_plan.refuse_unported(args)
    assert "ROADMAP queue A item 4" in str(err.value)


def test_data_parallel_plans_are_ported():
    port_plan.refuse_unported(_args(zero_stage=0, num_pods=2, data_parallel_size=2))


def _cli_args(**kw):
    base = dict(device="cpu", distributed_backend="xla", distributed_world_size=2,
                distributed_init_method=None, distributed_port=-1)
    base.update(kw)
    return Namespace(**base)


@pytest.mark.parametrize("device,asked,want", [
    ("cpu", "xla", "gloo"), ("cuda", "xla", "nccl"), ("cuda", "gloo", "gloo"),
    ("cpu", "gloo", "gloo"), ("cuda", "nccl", "nccl"),
])
def test_backend_resolution(device, asked, want):
    assert port_dist.resolve_backend(_cli_args(device=device, distributed_backend=asked)) == want


def test_nccl_refused_on_the_cpu():
    with pytest.raises(ValueError, match="gloo"):
        port_dist.resolve_backend(_cli_args(distributed_backend="nccl"))


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    args = _cli_args(device="cuda", distributed_backend="nccl")
    with pytest.raises(ValueError, match="--distributed-backend gloo"):
        port_dist.check_backend_devices(args, device_count=1)
    port_dist.check_backend_devices(args, device_count=2)
    port_dist.check_backend_devices(_cli_args(device="cuda", distributed_backend="gloo"),
                                    device_count=1)


def test_init_method_inference(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert port_dist.infer_init_method(_cli_args()) is None
    assert port_dist.infer_init_method(_cli_args(distributed_port=1234)) == "tcp://localhost:1234"
    assert port_dist.infer_init_method(
        _cli_args(distributed_init_method="tcp://h:1")) == "tcp://h:1"
    for k, v in (("RANK", "1"), ("WORLD_SIZE", "2"), ("MASTER_ADDR", "h0"),
                 ("MASTER_PORT", "29500")):
        monkeypatch.setenv(k, v)
    assert port_dist.infer_init_method(_cli_args()) == "tcp://h0:29500"


def test_no_rendezvous_refused_above_one_rank(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    args = _cli_args(distributed_no_spawn=True, distributed_rank=0, device_id=0,
                     zero_stage=0)
    with pytest.raises(ValueError, match="rendezvous"):
        port_dist.distributed_init(args)
    args.distributed_world_size = 1
    assert port_dist.distributed_init(args) == 0
