"""The port's flat buffers and fused optimizer pass (``--fused-adam``,
``unicore_tpu_torch/optim/multi_tensor.py``) on the CPU, where the kernel
wrappers take their plain versions.

- the flat plan: grouping by dtype in parameter order, views that round
  trip;
- ``fused_adam_plain`` against the JAX ``fused_adam_update`` (and
  ``fused_copy_back``) on the same trees: fp32 within 1e-6 absolute (both
  compute in fp32 in the same op order; the decay factor and the scalars
  round alike), mixed bf16/fp32 groups with an fp32 master the same, the
  bf16 parameters within one bf16 ulp of JAX's (a master 1e-7 apart may
  round to the neighbour);
- the L2 norm and the clip against the JAX ``multi_tensor_l2norm`` /
  ``clip_grad_norm``, 1e-6 relative (sums in another order);
- the plain fused path bit for bit against the port's per-tensor Adam
  (every operation rounded on its own in both);
- the stochastic copy-back on one of the two bf16 neighbours and unbiased
  (the mean of 400 draws within 5 standard errors of the fp32 value);
- a ``--fused-adam`` ``state_dict`` equal in names, shapes and values to
  the per-tensor one, each tensor owning its storage, loadable both ways;
- a non-finite norm leaving every buffer bit for bit.
"""

from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicore_tpu.optim import multi_tensor as jax_mt
from unicore_tpu.optim.unicore_optimizer import _path_str, make_decay_mask

from unicore_tpu_torch.optim import build_optimizer
from unicore_tpu_torch.optim import multi_tensor as mt
from unicore_tpu_torch.ops.rounding import fp32_to_bf16_sr_bits

BETAS, EPS, WD, LR = (0.9, 0.98), 1e-6, 0.05, 3e-3


def opt_args(**kw):
    d = dict(optimizer="adam", adam_betas=str(BETAS), adam_eps=EPS, weight_decay=WD,
             fused_adam=False, bf16_sr=False)
    d.update(kw)
    return Namespace(**d)


def make_tree(seed):
    """A parameter tree as JAX names it: kernels decay, biases and norms not."""
    r = np.random.RandomState(seed)
    w = lambda *s: r.randn(*s).astype(np.float32)  # noqa: E731
    return {"encoder": {"layer0": {"kernel": w(16, 12), "bias": w(12)},
                        "layer_norm": {"weight": w(12)}},
            "head": {"kernel": w(12, 7)}}


def flat(tree):
    return {_path_str(p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_flat_plan_round_trip_and_groups():
    named = {"a": torch.arange(4, dtype=torch.float32),
             "b": torch.arange(4, dtype=torch.float32).view(2, 2).bfloat16(),
             "c": torch.arange(3, dtype=torch.float32) + 10,
             "d": torch.ones(5, dtype=torch.bfloat16)}
    plan = mt.FlatPlan.build(named, {"a": True, "b": False, "c": True, "d": False})
    assert [g.dtype for g in plan.groups] == [torch.float32, torch.bfloat16]
    fp32, bf16 = plan.groups
    assert [(s.name, s.start, s.size) for s in fp32.segments] == [("a", 0, 4), ("c", 4, 3)]
    assert [(s.name, s.start, s.size) for s in bf16.segments] == [("b", 0, 4), ("d", 4, 5)]
    assert (fp32.numel, bf16.numel) == (8, 12)  # ends rounded up to ALIGN
    bufs = plan.flatten(named)
    assert [b.dtype for b in bufs] == [torch.float32, torch.bfloat16]
    assert float(bufs[0][7]) == 0.0 and float(bufs[1][9:].abs().sum()) == 0.0
    back = plan.unflatten(bufs)
    assert list(back) == list(named)
    for n, t in named.items():
        assert back[n].shape == t.shape and torch.equal(back[n], t)
        assert back[n].untyped_storage().data_ptr() == bufs[
            0 if t.dtype == torch.float32 else 1].untyped_storage().data_ptr()
    table = mt.chunk_table([(0, mt.CHUNK + 3, True), (mt.CHUNK + 4, 2, False)], "cpu")
    assert table.tolist() == [[0, 2 * mt.CHUNK + 1], [mt.CHUNK, 2 * 3 + 1],
                              [mt.CHUNK + 4, 2 * 2]]


def _port_hyper(step, lr=LR):
    opt = build_optimizer(opt_args())
    opt.num_steps = step
    return opt.hyper(lr)


@pytest.mark.parametrize("mixed", [False, True], ids=["fp32", "bf16_fp32_groups"])
def test_fused_adam_plain_matches_jax(mixed):
    params = make_tree(0)
    bf16_leaves = {"encoder.layer0.kernel", "head.kernel"} if mixed else set()
    r = np.random.RandomState(3)
    decay = {n: bool(m) for n, m in flat(make_decay_mask(params)).items()}
    assert 0 < sum(decay.values()) < len(decay)

    master_j = jax.tree_util.tree_map(jnp.asarray, params)
    params_j = jax.tree_util.tree_map_with_path(
        lambda p, x: x.astype(jnp.bfloat16) if _path_str(p) in bf16_leaves else x, master_j)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, master_j)
    slots_j = {"m": zeros, "v": zeros}

    named_p = {n: torch.tensor(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16 if n in bf16_leaves else torch.float32)
        for n, v in flat(params_j).items()}
    plan = mt.FlatPlan.build(named_p, decay)
    assert len(plan.groups) == (2 if mixed else 1)
    masters = plan.flatten({n: torch.tensor(np.asarray(v)) for n, v in flat(master_j).items()},
                           dtype=torch.float32)
    pbufs = plan.flatten(named_p)
    ms = [torch.zeros_like(b) for b in masters]
    vs = [torch.zeros_like(b) for b in masters]
    for step in range(1, 6):
        grads_np = jax.tree_util.tree_map(
            lambda p: (r.randn(*p.shape) * 0.05).astype(np.float32), params)
        master_j, slots_j = jax_mt.fused_adam_update(
            jax.tree_util.tree_map(jnp.asarray, grads_np), slots_j, master_j,
            jnp.float32(LR), jnp.asarray(step, jnp.int32), make_decay_mask(params),
            beta1=BETAS[0], beta2=BETAS[1], eps=EPS, weight_decay=WD)
        gbufs = plan.flatten({n: torch.from_numpy(v) for n, v in flat(grads_np).items()})
        hp = _port_hyper(step)
        for i, group in enumerate(plan.groups):
            mt.fused_adam_plain(masters[i], ms[i], vs[i], gbufs[i].float(),
                                [(s.start, s.size, s.decay) for s in group.segments], hp,
                                pbufs[i] if mixed else None, buffer_id=i)
    params_j = jax_mt.fused_copy_back(master_j, params_j, None, False)
    got_master = plan.unflatten(masters)
    got_m, got_v = plan.unflatten(ms), plan.unflatten(vs)
    for n, ref in flat(master_j).items():
        np.testing.assert_allclose(got_master[n].numpy(), np.asarray(ref), atol=1e-6, rtol=0)
        np.testing.assert_allclose(got_m[n].numpy(), np.asarray(flat(slots_j["m"])[n]),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(got_v[n].numpy(), np.asarray(flat(slots_j["v"])[n]),
                                   atol=1e-6, rtol=0)
    if mixed:
        got_p = plan.unflatten(pbufs)
        for n, ref in flat(params_j).items():
            ref = np.asarray(ref.astype(jnp.float32))
            assert got_p[n].dtype == (torch.bfloat16 if n in bf16_leaves else torch.float32)
            ulp = np.maximum(np.abs(ref) * 2.0 ** -7, 2.0 ** -126)
            assert (np.abs(got_p[n].float().numpy() - ref) <= ulp).all(), n


@pytest.mark.parametrize("max_norm", [0.5, 0.0])
def test_l2norm_and_clip_match_jax(max_norm):
    r = np.random.RandomState(5)
    tree = jax.tree_util.tree_map(lambda p: (p * r.rand() * 3).astype(np.float32),
                                  make_tree(1))
    ref_norm = float(jax_mt.multi_tensor_l2norm(jax_mt.flatten(jax_mt.build_plan(tree),
                                                               jax.tree_util.tree_map(
                                                                   jnp.asarray, tree))))
    clipped_j, gnorm_j = jax_mt.clip_grad_norm(jax.tree_util.tree_map(jnp.asarray, tree),
                                               max_norm)
    named = {n: torch.from_numpy(v) for n, v in flat(tree).items()}
    plan = mt.FlatPlan.build(named)
    bufs = plan.flatten(named)
    assert abs(float(mt.multi_tensor_l2norm(bufs)) - ref_norm) <= 1e-6 * ref_norm
    denom = torch.tensor(4.0)
    scaled = float(mt.multi_tensor_l2norm(bufs, denom))
    assert abs(scaled - ref_norm / 4.0) <= 1e-6 * ref_norm / 4.0
    gnorm = mt.clip_grad_norm_plain(bufs, max_norm)
    assert abs(float(gnorm) - float(gnorm_j)) <= 1e-6 * float(gnorm_j)
    if max_norm > 0:
        assert float(gnorm_j) > max_norm  # the clip engaged
    got = plan.unflatten(bufs)
    for n, ref in flat(clipped_j).items():
        np.testing.assert_allclose(got[n].numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


def _named(seed, dtype):
    g = torch.Generator().manual_seed(seed)
    shapes = {"embed.weight": (10, 8), "layers.0.fc1.weight": (12, 8),
              "layers.0.fc1.bias": (12,), "layers.0.layer_norm.weight": (8,),
              "head.weight": (5, 12)}
    return {n: torch.nn.Parameter(torch.randn(s, generator=g).to(dtype))
            for n, s in shapes.items()}


JAX_NAMES = {"embed.weight": "embed.embedding", "layers.0.fc1.weight": "layers_0.fc1.kernel",
             "layers.0.fc1.bias": "layers_0.fc1.bias",
             "layers.0.layer_norm.weight": "layers_0.layer_norm.scale",
             "head.weight": "head.kernel"}


def _pair(dtype):
    """(per-tensor Adam, its params, fused Adam, its params) from one seed."""
    ref_p, fus_p = _named(0, dtype), _named(0, dtype)
    ref = build_optimizer(opt_args())
    fus = build_optimizer(opt_args(fused_adam=True))
    ref.init_state(ref_p, JAX_NAMES)
    fus.init_state(fus_p, JAX_NAMES)
    return ref, ref_p, fus, fus_p


def _bits(t):
    return t.detach().contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_plain_bit_equal_per_tensor_adam(dtype):
    ref, ref_p, fus, fus_p = _pair(dtype)
    assert sum(fus.decay.values()) == 3  # embed, fc1 and head kernels decay
    grads_views = fus.grad_buffers()
    g = torch.Generator().manual_seed(9)
    for step in range(5):
        grads = {n: torch.randn(p.shape, generator=g) * 0.1 for n, p in ref_p.items()}
        ref.step(ref_p, grads, LR)
        for n, v in grads_views.items():
            v.copy_(grads[n])
        fus.fused_step(LR, torch.tensor(1.0), torch.tensor(1.0), 0.0, None)
    for n in ref_p:
        assert torch.equal(_bits(ref_p[n]), _bits(fus_p[n])), n
        for k in ("m", "v"):
            assert torch.equal(_bits(ref.state[n][k]), _bits(fus.state[n][k])), (n, k)
        if dtype != torch.float32:
            assert torch.equal(_bits(ref.master[n]), _bits(fus.master[n])), n
    # the parameters are views into the group's flat buffer
    assert fus_p["head.weight"].untyped_storage().data_ptr() == \
        fus.flat[0]["param" if dtype != torch.float32 else "master"].untyped_storage().data_ptr()


def test_fused_skips_on_non_finite_norm():
    _, _, fus, fus_p = _pair(torch.bfloat16)
    fus.grad_buffers()["head.weight"].fill_(1.0)
    before = [{k: v.clone() for k, v in b.items() if v is not None} for b in fus.flat]
    fus.fused_step(LR, torch.tensor(1.0), torch.tensor(float("inf")), 1.0, (3, 4))
    fus.unstep()
    assert fus.num_steps == 0
    for b, old in zip(fus.flat, before):
        for k, v in old.items():
            assert torch.equal(_bits(b[k]), _bits(v)), k


def test_sr_copy_back_within_one_ulp_and_unbiased():
    x = torch.from_numpy(np.random.RandomState(2).randn(1024).astype(np.float32))
    lo = fp32_to_bf16_sr_bits(x, torch.zeros(1024, dtype=torch.int32)).float()  # truncation
    draws = torch.stack([
        fp32_to_bf16_sr_bits(x, mt.sr_noise_plain(1024, k, 7, 0)).float()
        for k in range(400)])
    noise = mt.sr_noise_plain(1024, 1, 7, 0)
    assert int(noise.min()) >= 0 and int(noise.max()) < 65536
    assert not torch.equal(noise, mt.sr_noise_plain(1024, 1, 7, 1))  # the buffer id counts
    # every draw is one of x's two bf16 neighbours
    hi = ((lo.view(torch.int32) + 0x10000)).view(torch.float32)
    assert bool(((draws == lo) | (draws == hi)).all())
    # unbiased: per element the mean of 400 draws lies within 5 standard
    # errors (0.1 of the neighbours' gap) of x, and over the 1024 elements
    # the signed mean within 0.005 of a gap
    bias = (draws.mean(0) - x) / (hi - lo).abs()
    assert float(bias.abs().max()) < 0.1
    assert abs(float(bias.mean())) < 0.005


def test_fused_state_dict_equals_per_tensor():
    ref, ref_p, fus, fus_p = _pair(torch.bfloat16)
    g = torch.Generator().manual_seed(4)
    for _ in range(2):
        grads = {n: torch.randn(p.shape, generator=g) for n, p in ref_p.items()}
        ref.step(ref_p, grads, LR)
        for n, v in fus.grad_buffers().items():
            v.copy_(grads[n])
        fus.fused_step(LR, torch.tensor(1.0), torch.tensor(1.0), 0.0, None)
    sd_ref, sd_fus = ref.state_dict(), fus.state_dict()
    assert sd_fus["num_steps"] == sd_ref["num_steps"] == 2
    assert list(sd_fus["state"]) == list(sd_ref["state"])
    for n in sd_ref["state"]:
        for k in ("m", "v"):
            a, b = sd_ref["state"][n][k], sd_fus["state"][n][k]
            assert a.shape == b.shape and torch.equal(a, b)
            assert b.untyped_storage().nbytes() == b.numel() * 4  # its own storage
        assert torch.equal(sd_ref["master"][n], sd_fus["master"][n])
        assert sd_fus["master"][n].untyped_storage().nbytes() == sd_fus["master"][n].numel() * 4
    # a checkpoint of either loads into the other
    _, _, fus2, _ = _pair(torch.bfloat16)
    assert fus2.load_state_dict(sd_ref)
    ref2 = _pair(torch.bfloat16)[0]
    assert ref2.load_state_dict(sd_fus)
    for n in sd_ref["state"]:
        assert torch.equal(fus2.state[n]["m"], sd_ref["state"][n]["m"])
        assert torch.equal(ref2.master[n], sd_fus["master"][n])
