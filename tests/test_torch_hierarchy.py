"""The port's gradient reductions (``unicore_tpu_torch/parallel/hierarchy.py``)
against the JAX package's (``unicore_tpu/parallel/hierarchy.py``).

1. In process, on the same numpy inputs: ``adasum_pair`` (zero operands,
   parallel and orthogonal vectors, random ones; fp32 and bf16),
   ``combine_stack`` over 2-5 pods and ``_ordered_fold_sum``.
2. One 4-rank gloo job (``tests/torch_dp_ranks.py hierarchy``, spawned once
   through the port's ``call_main``) at pods=2 x data=2 runs
   ``two_level_reduce`` in {sum, adasum} x {deterministic, not}; the JAX
   ``two_level_reduce`` runs under ``shard_map`` on 4 of the suite's CPU
   devices, set up as ``tests/test_hierarchy.py`` does.  At pods=2 x data=1
   the port's two-level sum is the flat all-reduce bit for bit.

Tolerances: ``_ordered_fold_sum`` and the sums are compared bit for bit
where the order is the same on both sides (a left fold; two operands);
otherwise 2e-6 relative + 1e-6 absolute in fp32 (XLA and torch reduce the
dots of adasum and a reduce-scatter's partial sums in their own orders), and
one bf16 ulp (2^-8 relative) in bf16.  Every rank holds the same bits.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from unicore_tpu.parallel import DATA_AXIS, POD_AXIS, make_mesh
from unicore_tpu.parallel import hierarchy as JH
from unicore_tpu.parallel.compat import shard_map

from unicore_tpu_torch.parallel import hierarchy as TH

from torch_dp_ranks import REDUCE_CASES, reduce_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-6, 1e-6


def _pair_inputs(kind, n=257, seed=0):
    r = np.random.RandomState(seed)
    a = r.randn(n).astype(np.float32)
    if kind == "zero_a":
        return np.zeros(n, np.float32), a
    if kind == "zero_b":
        return a, np.zeros(n, np.float32)
    if kind == "both_zero":
        return np.zeros(n, np.float32), np.zeros(n, np.float32)
    if kind == "parallel":
        return a, 3.0 * a
    if kind == "identical":
        return a, a.copy()
    if kind == "orthogonal":
        a, b = np.zeros(n, np.float32), np.zeros(n, np.float32)
        a[: n // 2] = r.randn(n // 2)
        b[n // 2:] = r.randn(n - n // 2)
        return a, b
    return a, r.randn(n).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["zero_a", "zero_b", "both_zero", "parallel", "identical",
                                  "orthogonal", "random"])
def test_adasum_pair_matches_jax(kind, dtype):
    a, b = _pair_inputs(kind)
    if dtype == "bfloat16":
        ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
        ta, tb = torch.tensor(a).bfloat16(), torch.tensor(b).bfloat16()
    else:
        ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.tensor(a), torch.tensor(b)
    want = np.asarray(JH.adasum_pair(ja, jb)).astype(np.float32)
    got = TH.adasum_pair(ta, tb)
    assert got.dtype == ta.dtype
    got = got.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if kind in ("zero_a", "zero_b"):  # the zero-norm guard: the live side as it was
        live = tb if kind == "zero_a" else ta
        assert np.array_equal(got, live.float().numpy())


@pytest.mark.parametrize("mode", ["sum", "adasum"])
@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_combine_stack_matches_jax(mode, n):
    x = np.random.RandomState(n).randn(n, 129).astype(np.float32)
    want = np.asarray(JH.combine_stack(jnp.asarray(x), mode))
    got = TH.combine_stack(torch.tensor(x), mode).numpy()
    if mode == "sum":  # the same left fold on both sides
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_ordered_fold_sum_matches_jax():
    x = np.random.RandomState(7).randn(6, 1001).astype(np.float32)
    want = np.asarray(JH._ordered_fold_sum(jnp.asarray(x)))
    assert np.array_equal(TH._ordered_fold_sum(torch.tensor(x)).numpy(), want)


def test_engagement_matches_jax():
    from unicore_tpu.parallel.plan import ParallelPlan as JaxPlan

    from unicore_tpu_torch.parallel.plan import ParallelPlan as PortPlan

    for kw in (dict(pods=1, data=4), dict(pods=2, data=2), dict(pods=2, data=1)):
        jp = JaxPlan(**kw)
        mesh = make_mesh(pods=kw["pods"], data=kw["data"],
                         devices=jax.devices()[:kw["pods"] * kw["data"]])
        assert TH.engaged(PortPlan(**kw)) == JH.engaged(jp, mesh)


# ---------------------------------------------------------------------------
# the 4-rank job
# ---------------------------------------------------------------------------

def _jax_two_level(x, pods, data, mode, det):
    mesh = make_mesh(pods=pods, data=data, devices=jax.devices()[:pods * data])

    def body(xs):
        (out,) = JH.two_level_reduce([xs[0]], n_pods=pods, pod_size=data, mode=mode,
                                     deterministic=det)
        return out

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P((POD_AXIS, DATA_AXIS)),),
                           out_specs=P(), check_vma=False))
    return np.asarray(fn(x))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("hierarchy")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tests", "torch_dp_ranks.py"),
                           "hierarchy", str(out)], capture_output=True, text=True,
                          timeout=180, cwd=REPO, env=env)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-6000:]
    return [dict(np.load(out / f"hierarchy_rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("name,pods,data,mode,det", REDUCE_CASES,
                         ids=[c[0] for c in REDUCE_CASES])
def test_two_level_matches_jax(ranks, name, pods, data, mode, det):
    want = _jax_two_level(reduce_inputs(4), pods, data, mode, det)
    got = ranks[0][name]
    assert got.shape == want.shape == (reduce_inputs(4).shape[1],)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for r in range(1, 4):
        assert np.array_equal(ranks[r][name], got), r
    if mode == "sum":
        np.testing.assert_allclose(got, reduce_inputs(4).sum(0), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("det", ["free", "det"])
def test_pod_size_one_sum_is_the_flat_all_reduce(ranks, det):
    for r in range(2):
        assert np.array_equal(ranks[r][f"pair_sum_{det}"], ranks[r]["pair_flat"])
    x = reduce_inputs(2, seed=2)
    assert np.array_equal(ranks[0]["pair_flat"], x[0] + x[1])
    # and the JAX two-level sum at pods=2 x data=1: the same two adds
    assert np.array_equal(_jax_two_level(x, 2, 1, "sum", det == "det"), ranks[0]["pair_flat"])


def test_trainer_reducer_two_level(ranks):
    """The trainer's ``GradReducer`` on the job's plan (--num-pods 2
    --xpod-combine adasum): two-level, 1/pod_size of the fp32 buffer across
    the pods, the JAX adasum result on the flattened gradients."""
    want = _jax_two_level(reduce_inputs(4), 2, 2, "adasum", False)
    assert bool(ranks[0]["reducer_two_level"])
    # the flat plan pads the 1000 + 31 elements' segments to multiples of 4
    assert list(ranks[0]["reducer_dcn_bytes"]) == [4 * (1000 + 32) // 2]
    np.testing.assert_allclose(ranks[0]["reducer"], want, rtol=RTOL, atol=ATOL)
    for r in range(1, 4):
        assert np.array_equal(ranks[r]["reducer"], ranks[0]["reducer"])


@pytest.mark.parametrize("rank", range(4))
def test_rank_queries_and_host_collectives(ranks, rank):
    """``distributed/utils.py`` on the job's 4 ranks (pods=2 x data=2): the
    rank queries (world size, rank, data-parallel size and rank, pods, this
    rank's pod, master), then a MAX all-reduce, a dict sum, an object
    gather, an object broadcast from rank 2 and a tensor broadcast from
    rank 1."""
    r = ranks[rank]
    assert list(r["queries"]) == [4, rank, 4, rank, 2, rank // 2, int(rank == 0)]
    assert list(r["all_reduce_max"]) == [3.0, 0.0]
    assert list(r["all_reduce_dict"]) == [6.0, 6.0]
    assert list(r["all_gather_list"]) == [0, 1, 2, 3]
    assert int(r["broadcast_object"]) == 2
    assert list(r["broadcast_tensors"]) == [1.0, 1.0, 1.0]
