"""The port's incremental-decode plane against the JAX package on the CPU:
the paged KV cache (``serve/kv_cache.py``), the causal LM
(``models/transformer_lm.py``: full forward, prefill, one decode step,
fp32 and int8 KV) and the ``DecodeEngine`` scheduler (``serve/decode.py``).

Weights are a JAX ``transformer_lm`` tree whose every leaf is redrawn from a
numpy seed, carried to the port by ``from_jax_params`` (strict load).  On
the CPU the port's attention routes run their kernels' plain versions: the
full-row one at L=128, the fused-softmax one at short L, the decode one in
every step.

Tolerances: logits and K/V, fp32, 1e-5 of the tensor's largest magnitude
(at least 1; magnitudes reach ~5; two layers of fp32 sums in different
orders).  int8 decode rows: quantized from fp32
rows that may differ in the last bit, so an element at a rounding tie may
land one step apart (at most 1 in int8 units, on at most 1% of elements);
int8 decode logits 1e-4 of their largest magnitude (one such step moves a
dequantized element by one scale, ~1e-2, times attention weights).  Incremental decode against the
full forward: 1e-4 as the JAX package's own test holds it, int8 KV within
0.1.  Greedy rollouts: tokens equal, or, where they differ, the JAX logits'
top-2 gap below 1e-5 at the first difference (fp32 summation order may
break a tie the other way).  The kv_cache functions are bit for bit.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unicore_tpu.models.transformer_lm import TransformerLMModel as JaxLM
from unicore_tpu.serve import kv_cache as jkv
from unicore_tpu.serve.decode import DecodeEngine as JaxDecodeEngine

from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.checkpoint.emergency import Deadline
from unicore_tpu_torch.models.transformer_lm import TransformerLMModel as PortLM
from unicore_tpu_torch.ops import _kernels
from unicore_tpu_torch.serve import kv_cache as pkv
from unicore_tpu_torch.serve import request as rq
from unicore_tpu_torch.serve.decode import DecodeEngine, DecodeSequence

VOCAB, PAD, EOS = 17, 1, 2
TINY = dict(vocab_size=VOCAB, padding_idx=PAD, decoder_layers=2,
            decoder_embed_dim=32, decoder_ffn_embed_dim=64,
            decoder_attention_heads=4, dropout=0.0, emb_dropout=0.0,
            attention_dropout=0.0, activation_dropout=0.0, max_seq_len=128)
TOL = 1e-5


def random_jax_lm(seed=0, kernel_std=0.5, **kw):
    """A JAX ``transformer_lm`` and its variables, every leaf redrawn from a
    numpy seed (non-trivial LayerNorm affines and biases included).  Dense
    kernels draw at ``kernel_std`` 0.5 by default: at 0.05 the tied
    embedding dominates the residual stream and greedy decode repeats the
    last token."""
    model = JaxLM(**{**TINY, **kw})
    variables = jax.eval_shape(lambda: model.init_params(
        jax.random.PRNGKey(0), {"net_input": {"src_tokens": np.ones((1, 8), np.int32)}}))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        base = 1.0 if "layer_norm" in name and name.endswith("['weight']") else 0.0
        std = kernel_std if name.endswith("['kernel']") else 0.05
        return (base + std * rng.standard_normal(leaf.shape)).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, variables)


def port_lm(variables, **kw):
    model = PortLM(**{**TINY, **kw})
    model.load_state_dict(checkpoint_utils.from_jax_params(variables), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def lm():
    jm, variables = random_jax_lm()
    return jm, variables, port_lm(variables)


def _t(a, dtype=torch.long):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def _close(got, want, tol=TOL):
    """|got - want| within ``tol`` of want's largest magnitude (at least 1)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------------------------------
# serve/kv_cache: bit for bit against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_len,n,ps", [(100, 4, 32), (512, 4, 32), (128, 3, 8),
                                          (64, 1, 16), (31, 8, 4)])
def test_cache_bucket_edges_match_jax(max_len, n, ps):
    edges = pkv.cache_bucket_edges(max_len, n, page_size=ps)
    assert edges == jkv.cache_bucket_edges(max_len, n, page_size=ps)
    assert all(e % ps == 0 for e in edges) and edges[-1] >= max_len
    for length in (1, edges[0], min(edges[0] + 1, edges[-1]), edges[-1]):
        assert pkv.bucket_for(length, edges) == jkv.bucket_for(length, edges)
    with pytest.raises(ValueError):
        pkv.bucket_for(edges[-1] + 1, edges)


def test_scatter_gather_round_trip_with_sentinels_matches_jax():
    """A prefill of two sequences (one padded: its pad rows carry the
    sentinel page) and one decode row per sequence plus an idle batch row
    on the sentinel; every pool and gathered view equal bit for bit."""
    rng = np.random.RandomState(4)
    nl, H, D, ps, num_pages = 2, 2, 4, 4, 6
    cache = pkv.PagedKVCache(num_pages, nl, H, D, page_size=ps)
    sentinel = cache.sentinel
    pool0 = rng.randn(num_pages, nl, H, ps, D).astype(np.float32)
    lengths, Lp = (6, 3), 8
    pages = [cache.alloc(cache.pages_for(n)) for n in lengths]
    pages2d = np.full((2, Lp), sentinel, np.int32)
    for i, (n, p) in enumerate(zip(lengths, pages)):
        pages2d[i, :n] = np.repeat(np.asarray(p, np.int32), ps)[:n]
    slots2d = np.tile(np.arange(Lp, dtype=np.int32) % ps, (2, 1))
    kv = rng.randn(nl, 2, H, Lp, D).astype(np.float32)
    jpool = jkv.scatter_prefill(jnp.asarray(pool0), pages2d, slots2d, jnp.asarray(kv))
    ppool = pkv.scatter_prefill(torch.as_tensor(pool0.copy()), pages2d, slots2d,
                                torch.as_tensor(kv))
    np.testing.assert_array_equal(ppool.numpy(), np.asarray(jpool))
    table = np.stack([cache.table(p, 2 * ps) for p in pages]
                     + [np.full((2,), sentinel, np.int32)])  # an idle row
    np.testing.assert_array_equal(pkv.gather_pages(ppool, table).numpy(),
                                  np.asarray(jkv.gather_pages(jpool, table)))
    # one decode row each at the cursor (pages/slots as the engine makes them)
    positions = np.array([6, 3, 0], np.int32)
    rows = rng.randn(nl, 3, H, D).astype(np.float32)
    dpages = table[np.arange(3), positions // ps]
    jpool = jkv.scatter_rows(jpool, dpages, positions % ps, jnp.asarray(rows))
    ppool = pkv.scatter_rows(ppool, dpages, positions % ps, torch.as_tensor(rows))
    np.testing.assert_array_equal(ppool.numpy(), np.asarray(jpool))
    got = pkv.gather_pages(ppool, table).numpy()
    np.testing.assert_array_equal(got, np.asarray(jkv.gather_pages(jpool, table)))
    for b, n in enumerate(lengths):  # the prompt, then its decode row
        np.testing.assert_array_equal(got[:, b, :, :n], kv[:, b, :, :n])
        np.testing.assert_array_equal(got[:, b, :, positions[b]], rows[:, b])


def test_calibrate_and_quantize_match_jax_at_ties():
    rng = np.random.RandomState(5)
    k = rng.randn(2, 3, 2, 8, 4).astype(np.float32)
    v = (rng.randn(2, 3, 2, 8, 4) * 3).astype(np.float32)
    v[:, :, :, :, 1] = 0.0  # a dead channel: the eps floor
    ks, vs = pkv.calibrate_kv_scales(torch.as_tensor(k), torch.as_tensor(v))
    jks, jvs = jkv.calibrate_kv_scales(jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jks))
    np.testing.assert_array_equal(vs.numpy(), np.asarray(jvs))
    np.testing.assert_array_equal(pkv.quantize_kv(torch.as_tensor(k), ks).numpy(),
                                  np.asarray(jkv.quantize_kv(jnp.asarray(k), jks)))
    # exact .5 steps: power-of-two scales make x / scale exact, and both
    # round half to even; beyond the range saturates at +-127
    scale = np.full((2, 2, 4), 0.25, np.float32)
    x = (np.arange(-40, 40, dtype=np.float32) * 0.125)
    x = np.concatenate([x, [100.0, -100.0]]).astype(np.float32)
    kv = np.resize(x, (2, 1, 2, 41, 4)).astype(np.float32)
    got = pkv.quantize_kv(torch.as_tensor(kv), torch.as_tensor(scale)).numpy()
    want = np.asarray(jkv.quantize_kv(jnp.asarray(kv), jnp.asarray(scale)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int8 and set(np.unique(got[np.abs(kv) == 100.0])) <= {127, -127}
    assert got.flat[np.flatnonzero(kv.ravel() == 0.125)[0]] == 0  # 0.5 -> 0


def test_paged_cache_alloc_free_invariants():
    cache = pkv.PagedKVCache(4, 2, 2, 4, page_size=8)
    assert cache.occupancy() == 0.0
    a = cache.alloc(3)
    assert a is not None and len(a) == 3
    assert cache.occupancy() == pytest.approx(0.75)
    # never partial: 2 requested, 1 free -> None, and the free page stays
    assert cache.alloc(2) is None and cache.free_pages == 1
    b = cache.alloc(1)
    assert b is not None and cache.occupancy() == 1.0
    cache.free(a)
    assert cache.occupancy() == pytest.approx(0.25)
    with pytest.raises(RuntimeError):
        cache.free(a)  # double free overflows the free list
    with pytest.raises(ValueError):
        cache.free([99])  # bogus page id
    assert (cache.pages_for(1), cache.pages_for(8), cache.pages_for(9)) == (1, 1, 2)
    assert list(cache.table([3, 1], 32)) == [3, 1, 4, 4]
    with pytest.raises(ValueError, match="kv_scales"):
        pkv.PagedKVCache(4, 2, 2, 4, dtype=torch.int8)


# ---------------------------------------------------------------------------
# the model against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [16, 128])
def test_forward_matches_jax(lm, L):
    """L=128: the full-row route's plain version; L=16: fused softmax.  A
    right-padded row exercises the key mask."""
    jm, variables, pm = lm
    toks = np.random.default_rng(L).integers(3, VOCAB, (2, L)).astype(np.int32)
    toks[1, 3 * L // 4:] = PAD
    want = np.asarray(jax.jit(jm.apply)(variables, toks))
    _kernels.reset_launch_counts()
    with torch.no_grad():
        got = pm(_t(toks)).numpy()
    assert sum(_kernels.launch_counts().values()) == 0
    _close(got, want)


def test_prefill_matches_jax(lm):
    jm, variables, pm = lm
    toks = np.random.default_rng(1).integers(3, VOCAB, (2, 128)).astype(np.int32)
    toks[1, 100:] = PAD  # pads on the right, no mask: the causal bias hides them
    logits, (k, v) = jax.jit(lambda v, t: jm.apply(v, t, method="prefill"))(variables, toks)
    with torch.no_grad():
        plogits, (pk, pv) = pm.prefill(_t(toks))
    assert tuple(pk.shape) == (2, 2, 4, 128, 8)
    _close(plogits.numpy(), logits)
    _close(pk.numpy(), k)
    _close(pv.numpy(), v)


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_decode_step_matches_jax(lm, kv):
    """One step at mixed positions over caches seeded by the JAX prefill
    (rows past each position hold that prefill's junk)."""
    jm, variables, pm = lm
    P, Lc = 20, 32
    toks = np.random.default_rng(2).integers(3, VOCAB, (3, P)).astype(np.int32)
    _, (k, v) = jax.jit(lambda v, t: jm.apply(v, t, method="prefill"))(variables, toks)
    k, v = np.asarray(k), np.asarray(v)
    scales = None
    kc = np.zeros((2, 3, 4, Lc, 8), np.float32)
    vc = np.zeros_like(kc)
    kc[:, :, :, :P], vc[:, :, :, :P] = k, v
    if kv == "int8":
        scales = tuple(np.array(s) for s in jkv.calibrate_kv_scales(k, v))
        kc = np.asarray(jkv.quantize_kv(jnp.asarray(kc), jnp.asarray(scales[0])))
        vc = np.asarray(jkv.quantize_kv(jnp.asarray(vc), jnp.asarray(scales[1])))
    positions = np.array([P, P - 5, 0], np.int32)
    tok_t = np.array([4, 9, 12], np.int32)
    jl, (jk, jv) = jax.jit(lambda *a, **k: jm.apply(*a, **k, method="decode_step"))(
        variables, jnp.asarray(tok_t), (jnp.asarray(kc), jnp.asarray(vc)),
        jnp.asarray(positions),
        kv_scales=None if scales is None else tuple(jnp.asarray(s) for s in scales))
    with torch.no_grad():
        pl, (pk, pv) = pm.decode_step(
            _t(tok_t), (torch.as_tensor(kc.copy()), torch.as_tensor(vc.copy())),
            _t(positions, torch.int32),
            kv_scales=None if scales is None else tuple(torch.as_tensor(s) for s in scales))
    if kv == "fp32":
        _close(pl.numpy(), jl)
        _close(pk.numpy(), jk)
        _close(pv.numpy(), jv)
        return
    _close(pl.numpy(), jl, 1e-4)
    for got, want in ((pk.numpy(), np.asarray(jk)), (pv.numpy(), np.asarray(jv))):
        assert got.dtype == np.int8 and want.dtype == np.int8
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


def _port_incremental(pm, toks, P, kv_dtype, scales=None):
    """Prefill toks[:, :P], then decode token by token to the end over dense
    per-layer caches kept as the engine keeps its pages (quantized when
    int8).  Returns the logits of rows P..L-1."""
    B, L = toks.shape
    with torch.no_grad():
        _, (k, v) = pm.prefill(_t(toks[:, :P]))
        nl, _, H, _, D = k.shape
        if scales is not None:
            k, v = pkv.quantize_kv(k, scales[0]), pkv.quantize_kv(v, scales[1])
        kc = torch.zeros((nl, B, H, L, D), dtype=kv_dtype)
        vc = torch.zeros_like(kc)
        kc[:, :, :, :P], vc[:, :, :, :P] = k, v
        out = []
        for t in range(P, L):
            logits, (kr, vr) = pm.decode_step(
                _t(toks[:, t]), (kc, vc), torch.full((B,), t, dtype=torch.int32),
                kv_scales=scales)
            kc[:, :, :, t], vc[:, :, :, t] = kr, vr
            out.append(logits.numpy())
    return np.stack(out, axis=1)


def test_incremental_decode_matches_full_forward():
    """At the JAX parity test's weight scale (dense kernels 0.05, logits
    ~1), where its int8 bound of 0.1 is stated."""
    pm = port_lm(random_jax_lm(seed=3, kernel_std=0.05)[1])
    toks = np.random.RandomState(0).randint(3, VOCAB, size=(2, 40)).astype(np.int32)
    with torch.no_grad():
        full = pm(_t(toks)).numpy()
        plog, _ = pm.prefill(_t(toks[:, :13]))
    np.testing.assert_allclose(plog.numpy(), full[:, :13], atol=1e-4, rtol=1e-4)
    inc = _port_incremental(pm, toks, 13, torch.float32)
    np.testing.assert_allclose(inc, full[:, 13:], atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        _, (k, v) = pm.prefill(_t(toks[:, :13]))
    scales = pkv.calibrate_kv_scales(k, v)
    inc8 = _port_incremental(pm, toks, 13, torch.int8, scales)
    err = np.max(np.abs(inc8 - full[:, 13:]))
    assert err < 0.1, f"int8-KV decode drifted {err} from the fp32 forward"


def test_decoder_layer_refuses_cross_attention(lm):
    _, _, pm = lm
    layer = pm.decoder.layers[0]
    assert not any("encoder_attn" in n for n, _ in pm.named_parameters())
    with pytest.raises(NotImplementedError, match="cross-attention"):
        layer(torch.zeros(1, 4, 32), encoder_out=torch.zeros(1, 4, 32))


# ---------------------------------------------------------------------------
# DecodeEngine: the scheduler's ready-list mechanics (no warm-up)
# ---------------------------------------------------------------------------

def _sched_engine(lm, *, num_pages=8, decode_batch=3):
    eng = DecodeEngine(lm[2], bucket_edges=(4, 8), decode_batch=decode_batch,
                       page_size=4, num_pages=num_pages, vocab_size=VOCAB,
                       max_new_tokens=8)
    eng.cache = pkv.PagedKVCache(num_pages, 1, 1, 4, page_size=4)
    return eng


def _seq(eng, *, next_pos, bucket, seq_no, n_pages=1, deadline_s=60.0, max_new=8):
    req = rq.ServeRequest.make([3, 4, 5], deadline_s)
    pages = eng.cache.alloc(n_pages) if n_pages else []
    assert pages is not None
    s = DecodeSequence(req, [3, 4, 5], pages, pending=5, next_pos=next_pos,
                       bucket=bucket, max_new=max_new, seq_no=seq_no)
    eng._decode_ready.append(s)
    eng._active += 1
    return s


def test_take_decode_batch_fifo_bucket_affine(lm):
    eng = _sched_engine(lm)
    a = _seq(eng, next_pos=1, bucket=4, seq_no=1)
    b = _seq(eng, next_pos=1, bucket=4, seq_no=2)
    c = _seq(eng, next_pos=5, bucket=8, seq_no=3, n_pages=2)
    d = _seq(eng, next_pos=1, bucket=4, seq_no=4)
    live, bucket = eng._take_decode_batch()
    assert [s.seq_no for s in live] == [1, 2, 4] and bucket == 4  # FIFO in bucket 4
    assert list(eng._decode_ready) == [c]  # off-bucket kept, in order
    live2, bucket2 = eng._take_decode_batch()
    assert live2 == [c] and bucket2 == 8
    assert a.pages and b.pages and d.pages


def test_take_decode_batch_expires_dead_sequences(lm):
    eng = _sched_engine(lm)
    s = _seq(eng, next_pos=1, bucket=4, seq_no=1, deadline_s=0.0)
    assert eng._take_decode_batch() is None
    assert s.req.done()
    assert (s.req.response.status, s.req.response.reason) == (
        rq.STATUS_EXPIRED, rq.EXPIRED_IN_QUEUE)
    assert s.pages == [] and eng.cache.occupancy() == 0.0 and eng._active == 0


def test_page_exhaustion_preempts_youngest_bystander(lm):
    eng = _sched_engine(lm, num_pages=2, decode_batch=1)
    # the old sequence needs a second page for its next row; the only free
    # page is owned by a younger bystander in another bucket
    old = _seq(eng, next_pos=4, bucket=8, seq_no=1)
    young = _seq(eng, next_pos=1, bucket=4, seq_no=2)
    live, bucket = eng._take_decode_batch()
    assert live == [old] and bucket == 8 and len(old.pages) == 2
    assert eng.preempted_seqs == 1
    assert young.pages == [] and list(eng._preempted) == [young]
    assert not young.req.done()  # parked for re-prefill, not shed


def test_page_exhaustion_sheds_cache_oom_when_nothing_can_yield(lm):
    eng = _sched_engine(lm, num_pages=1, decode_batch=1)
    s = _seq(eng, next_pos=4, bucket=8, seq_no=1)
    assert eng._take_decode_batch() is None
    assert (s.req.response.status, s.req.response.reason) == (
        rq.STATUS_SHED, rq.SHED_CACHE_OOM)
    assert eng.cache.occupancy() == 0.0 and eng._active == 0
    assert eng.queue.shed_counts[rq.SHED_CACHE_OOM] == 1


# ---------------------------------------------------------------------------
# DecodeEngine end to end (in process, stepped synchronously)
# ---------------------------------------------------------------------------

ENGINE = dict(bucket_edges=(16, 32), decode_batch=2, prefill_batch=2, page_size=8,
              num_pages=12, pad_idx=PAD, eos_idx=EOS, vocab_size=VOCAB,
              max_new_tokens=6)
PROMPTS = [[5, 6, 7, 8], [9, 10, 11], [12, 13, 14, 15, 16],
           [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]]  # crosses 16 -> 32


def _drive(eng, reqs, iters=400):
    for _ in range(iters):
        if all(r.done() for r in reqs):
            return
        eng.step(timeout=0.01)
    raise AssertionError("engine did not finish all requests")


def test_engine_greedy_rollout_matches_jax_engine(lm):
    jm, variables, pm = lm
    jeng = JaxDecodeEngine(jm, variables, **ENGINE)
    jeng.warmup()
    jreqs = [jeng.submit(p, 120.0, request_id=f"j{i}") for i, p in enumerate(PROMPTS)]
    _drive(jeng, jreqs)
    eng = DecodeEngine(pm, **ENGINE)
    assert eng.warmup() == 2 * len(eng.bucket_edges)
    _kernels.reset_launch_counts()
    reqs = [eng.submit(p, 120.0, request_id=f"g{i}") for i, p in enumerate(PROMPTS)]
    _drive(eng, reqs)
    assert sum(_kernels.launch_counts().values()) == 0  # CPU: plain versions
    for p, r, jr in zip(PROMPTS, reqs, jreqs):
        assert r.response.status == rq.STATUS_OK, r.response
        got, want = r.response.output, jr.response.output
        if got == want:
            assert abs(r.response.score - jr.response.score) <= 1e-4
            continue
        j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        logits, _ = jm.apply(variables, np.asarray([list(p) + want[:j]], np.int32),
                             method="prefill")
        top2 = np.sort(np.asarray(logits)[0, -1])[-2:]
        assert top2[1] - top2[0] < 1e-5, (p, got, want)
    st = eng.stats()
    assert st["mode"] == "decode" and st["kv_dtype"] == "float32"
    assert st["active_sequences"] == 0 and st["cache_page_occupancy"] == 0.0
    assert st["served"] == len(PROMPTS) and st["requeued"] > 0
    assert st["decode_steps"] > 0 and st["prefill_batches"] >= 2
    assert st["tokens_generated"] >= sum(len(r.response.output) for r in reqs) - len(PROMPTS)
    assert st["token_p50_ms"] > 0.0 and st["tokens_per_s"] > 0.0


def test_engine_int8_kv_generates(lm):
    eng = DecodeEngine(lm[2], kv_dtype="int8", **ENGINE)
    eng.warmup()
    assert eng.cache.k_pool.dtype == torch.int8
    assert tuple(eng._kv_scales[0].shape) == (2, 4, 8)
    reqs = [eng.submit(p, 120.0) for p in PROMPTS[:2]]
    _drive(eng, reqs)
    assert all(r.response.status == rq.STATUS_OK for r in reqs)
    assert eng.stats()["kv_dtype"] == "int8"


def test_engine_max_new_tokens_clamped_per_request(lm):
    eng = DecodeEngine(lm[2], bucket_edges=(16,), decode_batch=1, page_size=8,
                       num_pages=4, pad_idx=PAD, eos_idx=-1,  # never chosen
                       vocab_size=VOCAB, max_new_tokens=5)
    eng.warmup()
    r_short = eng.submit([5, 6, 7], 60.0, max_new_tokens=2)
    r_capped = eng.submit([8, 9, 10], 60.0, max_new_tokens=99)
    _drive(eng, [r_short, r_capped])
    assert r_short.response.status == rq.STATUS_OK
    assert len(r_short.response.output) == 2
    assert r_capped.response.status == rq.STATUS_OK
    assert len(r_capped.response.output) == 5  # clamped to the engine's cap


def test_engine_drain_finishes_inflight_generations(lm):
    eng = DecodeEngine(lm[2], bucket_edges=(16,), decode_batch=2, page_size=8,
                       num_pages=6, pad_idx=PAD, eos_idx=-1, vocab_size=VOCAB,
                       max_new_tokens=4)
    eng.warmup()
    reqs = [eng.submit([5, 6, 7], 60.0), eng.submit([9, 10], 60.0)]
    t = threading.Thread(target=lambda: [eng.step(0.01) for _ in range(200)])
    t.start()
    assert eng.drain(Deadline(30.0))
    t.join(timeout=30)
    assert all(r.response.status == rq.STATUS_OK for r in reqs)
    assert all(len(r.response.output) == 4 for r in reqs)
    assert eng.stats()["active_sequences"] == 0
    # draining: new work sheds at the door
    late = eng.submit([5, 6], 60.0)
    assert (late.response.status, late.response.reason) == (rq.STATUS_SHED, rq.SHED_DRAINING)


def test_engine_rejects_out_of_vocabulary_ids(lm):
    eng = DecodeEngine(lm[2], **ENGINE)
    with pytest.raises(ValueError, match=f"0, {VOCAB}"):
        eng.submit([5, VOCAB], 60.0)
