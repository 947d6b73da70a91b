"""The port's mixed-precision pieces against the JAX package's on the CPU.

1. ``fp32_to_bf16_sr``: the port's core fed JAX's own noise
   (``jax.random.bits(key) & 0xFFFF``) gives JAX's bf16 bits exactly, over
   normals, subnormals, +-0, +-inf, the largest finite values (which round
   up to infinity when the noise carries) and negatives.  Drawn from a
   generator it is unbiased (the mean of 4096 draws within 3 sigma of the
   input), every output is one of the input's two bf16 neighbours, and a
   generator with the same seed gives the same bits.
2. The nearest-even copy-back (``Tensor.to(bfloat16)``) equals JAX
   ``astype(bfloat16)`` bit for bit.
3. ``scale_schedule`` and ``DynamicLossScaler`` against the JAX ones on
   fixed overflow sequences (tolerance 0 / 0.25, a threshold or none, a
   sequence that pins at ``min_loss_scale``): scale, counters and
   ``pinned`` exactly equal at every step.
4. Adam with an fp32 master: 3 steps from the same bf16 parameters and
   fp32 gradients, against JAX ``Adam.update``: the master within 1e-6
   relative (fp32 both sides, the same formula), the parameters the
   nearest-even rounding of the master, bit for bit; a ``state_dict``
   round trip carries the master.
"""

from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicore_tpu.ops.rounding import fp32_to_bf16_sr as jax_sr
from unicore_tpu.optim import build_optimizer as jax_build_optimizer
from unicore_tpu.optim.dynamic_loss_scaler import DynamicLossScaler as JaxScaler
from unicore_tpu.optim.dynamic_loss_scaler import init_scale_state as jax_init
from unicore_tpu.optim.dynamic_loss_scaler import scale_schedule as jax_schedule

from unicore_tpu_torch.ops.rounding import fp32_to_bf16_sr, fp32_to_bf16_sr_bits
from unicore_tpu_torch.optim import build_optimizer as port_build_optimizer
from unicore_tpu_torch.optim.dynamic_loss_scaler import DynamicLossScaler as PortScaler
from unicore_tpu_torch.optim.dynamic_loss_scaler import init_scale_state, scale_schedule

_F32_MAX = np.finfo(np.float32).max


def _inputs(kind):
    r = np.random.default_rng(7)
    if kind == "normals":
        x = r.standard_normal(4096) * 10.0 ** r.integers(-6, 6, 4096)
    elif kind == "subnormals":
        x = r.uniform(-1, 1, 2048) * np.finfo(np.float32).tiny
    elif kind == "zeros_and_infs":
        x = np.array([0.0, -0.0, np.inf, -np.inf] * 64)
    elif kind == "largest_finite":
        x = np.array([_F32_MAX, -_F32_MAX, np.nextafter(_F32_MAX, 0, dtype=np.float32),
                      3.3895e38, -3.3895e38] * 64)
    else:  # negatives
        x = -np.abs(r.standard_normal(4096)) * 1e3
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("kind", ["normals", "subnormals", "zeros_and_infs",
                                  "largest_finite", "negatives"])
def test_sr_equals_jax_on_jax_noise(kind):
    x = _inputs(kind)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_sr(jnp.asarray(x), key)).view(np.uint16)
    noise = np.asarray(jax.random.bits(key, x.shape, dtype=jnp.uint32) & 0xFFFF)
    got = fp32_to_bf16_sr_bits(torch.from_numpy(x), torch.from_numpy(noise.astype(np.int32)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    if kind == "largest_finite":  # a carry out of the mantissa reaches infinity
        assert np.isinf(got[:2].float().numpy()).any()


def test_sr_unbiased_neighbours_and_deterministic():
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.standard_normal(64).astype(np.float32))
    g = torch.Generator().manual_seed(5)
    draws = torch.stack([fp32_to_bf16_sr(x, g).float() for _ in range(4096)])
    # the two neighbours: the bit pattern cut to bf16 (toward zero) and the
    # next one away from zero
    cut = x.view(torch.int32) & ~0xFFFF
    lo, hi = cut.view(torch.float32), (cut + 0x10000).view(torch.float32)
    assert bool(((draws == lo) | (draws == hi)).all())
    sigma = (hi - lo).abs() / 2 / np.sqrt(4096)
    assert bool(((draws.mean(0) - x).abs() <= 3 * sigma + 1e-12).all())
    a = fp32_to_bf16_sr(x, torch.Generator().manual_seed(9))
    b = fp32_to_bf16_sr(x, torch.Generator().manual_seed(9))
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_nearest_even_copy_back_equals_jax_astype():
    x = np.concatenate([_inputs("normals"), _inputs("subnormals"),
                        _inputs("zeros_and_infs"), _inputs("largest_finite"),
                        # exact ties between two bf16 values round to even
                        np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8)], np.float32)])
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
    got = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the loss-scale schedule
# ---------------------------------------------------------------------------

_SEQS = {
    "rare": [False] * 5 + [True] + [False] * 6 + [True, True] + [False] * 9,
    "burst": [True] * 3 + [False] * 4 + [True, False, True, True] + [False] * 8,
    "pin": [True] * 20,
}


@pytest.mark.parametrize("seq", list(_SEQS))
@pytest.mark.parametrize("tolerance", [0.0, 0.25])
@pytest.mark.parametrize("threshold", [None, 32.0])
def test_scale_schedule_equals_jax(seq, tolerance, threshold):
    kw = dict(scale_window=4, min_loss_scale=2.0, tolerance=tolerance,
              threshold_loss_scale=threshold)
    st_j, st_p = jax_init(128.0), init_scale_state(128.0)
    pinned_any = False
    for i, overflow in enumerate(_SEQS[seq]):
        st_j, pin_j = jax_schedule(st_j, jnp.asarray(overflow), **kw)
        st_p, pin_p = scale_schedule(st_p, overflow, **kw)
        assert float(st_p["scale"]) == float(st_j["scale"]), (i, st_p, st_j)
        for k in ("since_overflow", "since_rescale", "overflows_since_rescale"):
            assert st_p[k] == int(st_j[k]), (i, k)
        assert pin_p == bool(pin_j), i
        pinned_any |= pin_p
    assert pinned_any == (seq == "pin" and threshold is None)


@pytest.mark.parametrize("seq", list(_SEQS))
@pytest.mark.parametrize("tolerance", [0.0, 0.25])
def test_host_scaler_equals_jax(seq, tolerance):
    kw = dict(init_scale=128.0, scale_window=4, tolerance=tolerance, min_loss_scale=2.0)
    scalers = (JaxScaler(**kw), PortScaler(**kw))
    for i, overflow in enumerate(_SEQS[seq]):
        outcomes = []
        for s in scalers:
            try:
                if overflow:
                    s.check_overflow(float("inf"))
                s.update()
                outcomes.append("clean")
            except OverflowError:
                outcomes.append("overflow")
            except FloatingPointError:
                outcomes.append("pinned")
        assert outcomes[0] == outcomes[1], i
        j, p = scalers
        assert (p.loss_scale, p._since_overflow, p._since_rescale,
                p._overflows_since_rescale) == (j.loss_scale, j._since_overflow,
                                                j._since_rescale,
                                                j._overflows_since_rescale), i


# ---------------------------------------------------------------------------
# Adam with an fp32 master
# ---------------------------------------------------------------------------

def _adam_args(**kw):
    return Namespace(optimizer="adam", adam_betas="(0.9, 0.98)", adam_eps=1e-6,
                     weight_decay=0.05, fused_adam=False, bf16_sr=False, **kw)


def test_adam_master_equals_jax():
    r = np.random.default_rng(2)
    shapes = {"fc": {"kernel": (24, 16), "bias": (16,)}, "ln": {"weight": (16,)}}
    params_np = {m: {k: r.standard_normal(s).astype(np.float32) for k, s in d.items()}
                 for m, d in shapes.items()}
    params_j = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), params_np)
    names = {"fc.kernel": ("fc", "kernel"), "fc.bias": ("fc", "bias"),
             "ln.weight": ("ln", "weight")}
    params_t = {n: torch.from_numpy(np.asarray(params_j[m][k]).view(np.int16).copy())
                .view(torch.bfloat16) for n, (m, k) in names.items()}
    opt_j, opt_t = jax_build_optimizer(_adam_args()), port_build_optimizer(_adam_args())
    state_j = opt_j.init_state(params_j)
    opt_t.init_state(params_t, {n: n for n in names})
    assert opt_t.master is not None and state_j["master"] is not None
    for step, lr in enumerate((1e-2, 3e-3, 1e-3)):
        grads_np = jax.tree_util.tree_map(
            lambda a: (r.standard_normal(a.shape) * 0.1).astype(np.float32), params_np)
        params_j, state_j = opt_j.update(jax.tree_util.tree_map(jnp.asarray, grads_np),
                                         state_j, params_j, jnp.float32(lr))
        opt_t.step(params_t, {n: torch.from_numpy(grads_np[m][k]) for n, (m, k) in names.items()},
                   lr)
        for n, (m, k) in names.items():
            mj = np.asarray(state_j["master"][m][k])
            mt = opt_t.master[n].numpy()
            np.testing.assert_allclose(mt, mj, rtol=1e-6, atol=0, err_msg=(step, n))
            assert torch.equal(params_t[n], opt_t.master[n].to(torch.bfloat16)), (step, n)
    assert opt_t.num_steps == int(state_j["step"]) == 3
    fresh = port_build_optimizer(_adam_args())
    fresh.init_state({n: torch.zeros_like(p) for n, p in params_t.items()}, {n: n for n in names})
    assert fresh.load_state_dict(opt_t.state_dict())
    for n in names:
        assert torch.equal(fresh.master[n], opt_t.master[n])
