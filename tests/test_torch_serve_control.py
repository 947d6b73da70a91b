"""The port's serving control plane against the JAX package on the CPU:
the event journal (``telemetry/journal.py``: the JAX schema, loaded and
merged by ``unicore_tpu.telemetry.trace``), the Prometheus exposition
(``telemetry/prometheus.py``: the same text for the same ``stats()``), the
serving fault kinds (``distributed/chaos.py``: the flood's window and rate,
the slow client consumed once, the corrupt reload's flipped bytes), the hot
reload state machine (``serve/reload.py``: every outcome beside the JAX
``HotReloader``'s on the same scenario, with plain ``loader`` / ``prober``
callables as ``tests/test_serve.py`` drives it) and the engines' swap
(``serve/engine.py``, ``serve/decode.py``: on a batch boundary, in the
candidate's own dtype, between decode steps with the pages kept).

Tolerances: none but exact, except the dtype-changing swap, whose answers
are held against the bf16 candidate's own forward bit for bit.
"""

import os
import shutil
import threading
import time
from argparse import Namespace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from unicore_tpu import telemetry as jax_telemetry
from unicore_tpu.distributed import chaos as jax_chaos
from unicore_tpu.serve import reload as jax_reload
from unicore_tpu.serve.engine import ServeEngine as JaxServeEngine
from unicore_tpu.telemetry import journal as jax_journal
from unicore_tpu.telemetry import prometheus as jax_prom
from unicore_tpu.telemetry import trace as jax_trace

from unicore_tpu_torch import checkpoint_utils, telemetry
from unicore_tpu_torch.checkpoint.format import CorruptCheckpointError
from unicore_tpu_torch.cli import serve as serve_cli
from unicore_tpu_torch.distributed import chaos
from unicore_tpu_torch.models.bert import bert_tiny_architecture
from unicore_tpu_torch.serve import (
    CheckpointWatcher,
    DecodeEngine,
    HotReloader,
    ReloadRunner,
    ServeEngine,
    build_infer_fn,
)
from unicore_tpu_torch.serve import reload as port_reload
from unicore_tpu_torch.serve import request as rq
from unicore_tpu_torch.telemetry import journal, prometheus

from test_torch_bert import PAD, VOCAB, random_jax_variables
from test_torch_decode import TINY as LM_TINY
from test_torch_decode import port_lm, random_jax_lm


@pytest.fixture(autouse=True)
def _clean_planes():
    for mod in (chaos, jax_chaos, telemetry, jax_telemetry):
        mod.reset()
    yield
    for mod in (chaos, jax_chaos, telemetry, jax_telemetry):
        mod.reset()


# ---------------------------------------------------------------------------
# the event journal
# ---------------------------------------------------------------------------

def test_journal_records_carry_the_jax_envelope_and_merge_with_its_trace(tmp_path):
    args = Namespace(telemetry_dir=str(tmp_path / "telemetry"))
    j = telemetry.configure(args, rank=0, role="serve")
    assert j.path == jax_journal.journal_file(str(tmp_path / "telemetry"), 0, "serve")
    telemetry.emit("serve-shed", reason="queue-full", count=np.int64(3))
    telemetry.emit("serve-reload", outcome="rejected:verify", path="/x", update=7)
    telemetry.emit("serve-drain", outcome="complete", seconds=0.5, queued=0)
    files = jax_trace.find_journals(str(tmp_path))
    assert files == [j.path]
    records = jax_trace.load_journal(files[0])
    assert [r["kind"] for r in records] == ["run-start", "serve-shed", "serve-reload",
                                          "serve-drain"]
    for r in records:
        assert set(jax_trace.ENVELOPE_KEYS) <= set(r)
        assert r["run_id"] == telemetry.run_id() and r["rank"] == 0
        assert r["attempt"] == 0 and r["membership_epoch"] == 0
    assert records[0]["role"] == "serve"
    assert records[1]["count"] == 3 and records[1]["update"] == -1
    assert records[2]["update"] == 7
    merged = jax_trace.merge(records)
    assert [r["kind"] for r in merged] == [r["kind"] for r in records]


def test_emit_before_configure_is_dropped(tmp_path):
    telemetry.emit("serve-shed", reason="queue-full")  # no journal: no raise
    assert telemetry.journal_path() is None
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("role", ["trainer", "serve", "supervisor"])
def test_journal_paths_match_jax(role):
    args = Namespace(telemetry_dir=None, save_dir="/ckpt")
    assert journal.journal_dir(args) == jax_journal.journal_dir(args)
    assert journal.journal_file("/t", 3, role) == jax_journal.journal_file("/t", 3, role)


# ---------------------------------------------------------------------------
# /metrics
# ---------------------------------------------------------------------------

_STATS = {
    "encoder": {"ready": True, "served": 12, "admitted": 15, "batches": 4, "depth": 2,
                "estimated_delay_s": 0.0125, "reloads_applied": 1,
                "shed": {"queue-full": 3, "deadline-unmeetable": 1},
                "p50_ms": 12.5, "p90_ms": 20.0, "p99_ms": 31.25},
    "decode": {"ready": False, "served": 5, "admitted": 5, "batches": 40, "depth": 0,
               "estimated_delay_s": 0.0, "reloads_applied": 0, "shed": {"cache-oom": 1},
               "p50_ms": 80.0, "mode": "decode", "tokens_generated": 160,
               "tokens_per_s": 812.5, "cache_page_occupancy": 0.125,
               "cache_pages_free": 448, "active_sequences": 2, "preempted": 1,
               "requeued": 150, "decode_steps": 35, "prefill_batches": 5,
               "token_p50_ms": 2.5, "token_p90_ms": 3.0, "token_p99_ms": 4.75},
}


@pytest.mark.parametrize("kind", list(_STATS))
def test_render_engine_matches_jax(kind):
    engine = SimpleNamespace(stats=lambda: dict(_STATS[kind]))
    prometheus.set_gauge("unicore_tpu_extra", 2.0, labels={"a": 'x"y'}, help="extra")
    jax_prom.set_gauge("unicore_tpu_extra", 2.0, labels={"a": 'x"y'}, help="extra")
    got = prometheus.render_engine(engine)
    assert got == jax_prom.render_engine(engine)
    assert 'unicore_tpu_serve_shed_total{reason="' in got
    assert 'unicore_tpu_extra{a="x\\"y"} 2' in got


def test_metrics_server_serves_the_registry():
    import urllib.request

    prometheus.set_counter("unicore_tpu_things_total", 1234567, help="things")
    server = prometheus.start_metrics_server(0)
    assert server is None  # port 0 means off, as in the JAX package
    server = prometheus.start_metrics_server(1, host="256.0.0.1")
    assert server is None  # a bind failure never raises
    srv = prometheus.start_metrics_server(_free_port(), host="127.0.0.1")
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.server_address[1]}/metrics", timeout=5) as r:
            body = r.read().decode()
        assert r.headers["Content-Type"] == prometheus.CONTENT_TYPE
        assert "unicore_tpu_things_total 1234567" in body
    finally:
        srv.shutdown()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# the serving fault kinds
# ---------------------------------------------------------------------------

SERVE_SPECS = ["request-flood:50@2", "slow-client:3@1", "corrupt-reload@0"]


@pytest.mark.parametrize("spec", SERVE_SPECS)
def test_serve_fault_specs_parse_as_jax(spec):
    port, ref = chaos.parse_fault_spec(spec), jax_chaos.parse_fault_spec(spec)
    assert (port.kind, port.step, port.param) == (ref.kind, ref.step, ref.param)
    assert repr(port) == repr(ref)
    with pytest.raises(ValueError) as want:
        jax_chaos.parse_fault_spec(spec + "@1")
    with pytest.raises(ValueError) as got:
        chaos.parse_fault_spec(spec + "@1")
    assert "drop the @RANK part" in str(got.value) and type(got.value) is type(want.value)


@pytest.mark.parametrize("spec", ["replica-loss@3", "replica-stall:5@2@1", "replica-loss@2",
                                  "replica-stall@1@0"])
def test_fleet_kinds_parse_as_jax(spec):
    port, ref = chaos.parse_fault_spec(spec), jax_chaos.parse_fault_spec(spec)
    assert (port.kind, port.step, port.param, port._rank) == (
        ref.kind, ref.step, ref.param, ref._rank)
    assert repr(port) == repr(ref)
    for idx in (0, 1, 2):  # @IDX against --replica-index, any replica without it
        chaos.set_replica_index(idx)
        jax_chaos.set_replica_index(idx)
        assert port.on_this_rank() == ref.on_this_rank()


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def monotonic(self):
        return self.t


def test_request_flood_window_and_rate_match_jax(monkeypatch):
    clocks = {}
    for mod in (chaos, jax_chaos):
        clocks[mod] = _Clock()
        monkeypatch.setattr(mod, "time", clocks[mod])
        mod.configure(Namespace(fault_inject="request-flood:50@2"))
    seen = {chaos: [], jax_chaos: []}
    for batch, t in [(0, 100.0), (1, 101.0), (2, 102.0), (3, 105.0), (5, 111.9),
                     (6, 112.0), (9, 130.0)]:
        for mod in (chaos, jax_chaos):
            clocks[mod].t = t
            mod.note_serve_batch(batch)
            seen[mod].append(mod.serve_flood_qps())
    assert seen[chaos] == seen[jax_chaos] == [0.0, 0.0, 50.0, 50.0, 50.0, 0.0, 0.0]


def test_slow_client_is_consumed_once_as_jax():
    got = {}
    for mod in (chaos, jax_chaos):
        mod.configure(Namespace(fault_inject="slow-client:3@1"))
        seq = [mod.take_slow_client_delay()]
        mod.note_serve_batch(1)
        seq += [mod.take_slow_client_delay(), mod.take_slow_client_delay()]
        got[mod] = seq
    assert got[chaos] == got[jax_chaos] == [0.0, 3.0, 0.0]


def _write_bert_checkpoint(root, variables=None, name="checkpoint.pt", dtype=None, step=5):
    data = root / "data"
    if not data.exists():
        data.mkdir()
        words = ["[CLS]", "[PAD]", "[SEP]", "[UNK]"] + [f"w{i}" for i in range(VOCAB - 5)]
        (data / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    if variables is None:
        variables = random_jax_variables(post_ln=True)[1]
    weights = checkpoint_utils.from_jax_params(variables)
    if dtype is not None:
        weights = {k: v.to(dtype) for k, v in weights.items()}
    args = Namespace(task="bert", arch="bert_tiny", data=str(data), seed=1)
    bert_tiny_architecture(args)
    path = root / name
    checkpoint_utils.write_checkpoint(str(path), args, weights,
                                      optimizer_history=[{"num_updates": step}])
    return path


def test_corrupt_reload_flips_the_jax_bytes_once(tmp_path):
    path = _write_bert_checkpoint(tmp_path)
    twin = tmp_path / "twin.pt"
    shutil.copy(path, twin)
    original = path.read_bytes()
    chaos.configure(Namespace(fault_inject="corrupt-reload@0"))
    jax_chaos.configure(Namespace(fault_inject="corrupt-reload@0"))
    assert chaos.maybe_corrupt_reload(str(path))
    assert jax_chaos.maybe_corrupt_reload(str(twin))
    assert path.read_bytes() == twin.read_bytes() != original
    with pytest.raises(CorruptCheckpointError):
        checkpoint_utils.load_checkpoint_to_cpu(str(path))
    shutil.copy(twin, path)  # consumed: the next candidate is left alone
    assert not chaos.maybe_corrupt_reload(str(path))


# ---------------------------------------------------------------------------
# the reload state machine, beside the JAX HotReloader
# ---------------------------------------------------------------------------

def _fake_infer(model, arr):
    arr = np.asarray(arr)
    score = np.full(arr.shape[0], getattr(model, "score", 1.0), np.float32)
    return arr.copy(), score


class _Tiny(torch.nn.Module):
    def __init__(self, w=None):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(2, 2) if w is None else w)


def _engines():
    port = ServeEngine(_Tiny(), _fake_infer, bucket_edges=(16, 32), batch_size=4,
                       pad_idx=1, admission_capacity=8)
    ref = JaxServeEngine({"params": {"w": np.zeros((2, 2))}}, _fake_infer,
                         bucket_edges=(16, 32), batch_size=4, pad_idx=1,
                         admission_capacity=8)
    for e in (port, ref):
        e.warmup()
    return port, ref


def _state(port, shape=(2, 2), names=("w",)):
    if port:
        return {"model": {n: torch.ones(shape) for n in names},
                "optimizer_history": [{"num_updates": 7}]}
    return {"model": {"params": {n: np.ones(shape) for n in names}},
            "optimizer_history": [{"num_updates": 7}]}


def _raise(exc):
    def f(*a):
        raise exc
    return f


SCENARIOS = {
    "swapped": dict(want="swapped"),
    "verify": dict(loader=_raise(CorruptCheckpointError("manifest digest mismatch")),
                   want="rejected:verify"),
    "no_model": dict(loader=lambda p: {}, want="rejected:structure"),
    "other_names": dict(names=("other",), want="rejected:structure"),
    "other_shape": dict(shape=(3, 2), want="rejected:structure"),
    "probe": dict(prober=_raise(ValueError("non-finite scores")), want="rejected:probe"),
    "calibration": dict(preparer=_raise(RuntimeError("digest mismatch, re-derive failed")),
                        want="rejected:calibration"),
    "probe_after_prepare": dict(preparer=lambda v: v, prober=_raise(ValueError("nan")),
                                want="rejected:probe", aborted=True),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_reload_outcome_matches_jax(name):
    sc = SCENARIOS[name]
    port_eng, jax_eng = _engines()
    outcomes, ready_inside, aborts = {}, [], []
    for is_port, eng, mod in ((True, port_eng, port_reload), (False, jax_eng, jax_reload)):
        def loader(p, is_port=is_port, eng=eng):
            ready_inside.append(eng.ready())
            return _state(is_port, sc.get("shape", (2, 2)), sc.get("names", ("w",)))

        def prober(v, eng=eng):
            ready_inside.append(eng.ready())
            if "prober" in sc:
                sc["prober"](v)

        kw = dict(loader=sc.get("loader", loader), prober=prober,
                  preparer=sc.get("preparer"), preparer_abort=lambda: aborts.append(1))
        if is_port:
            kw["make_model"] = lambda w: w
        hr = mod.HotReloader(eng, **kw)
        before = eng.model if is_port else eng.variables
        outcomes[is_port] = hr.consider("/fake/checkpoint_last.pt")
        assert eng.ready() and eng.phase == "serving"
        assert (hr.swapped, hr.rolled_back) == ((1, 0) if sc["want"] == "swapped" else (0, 1))
        if sc["want"] == "swapped":
            assert (eng.model if is_port else eng.variables) is before  # not mid-batch
            eng._apply_pending_swap()
            assert eng.reloads_applied == 1
        assert eng._pending_swap is None
        r = eng.submit([2, 3], 10.0)
        eng.step(timeout=0.2)
        assert r.response.status == rq.STATUS_OK
    assert outcomes[True] == outcomes[False] == sc["want"]
    assert not any(ready_inside)  # readiness false only during verify -> swap
    assert len(aborts) == (2 if sc.get("aborted") else 0)


def test_structure_ignores_dtype_as_jax_compares_shapes():
    port_eng, _ = _engines()
    bf16 = {"model": {"w": torch.ones(2, 2, dtype=torch.bfloat16)}}
    hr = HotReloader(port_eng, loader=lambda p: bf16, prober=lambda v: None,
                     make_model=lambda w: _Tiny(w["w"]))
    assert hr.consider("/fake/c.pt") == "swapped"
    port_eng._apply_pending_swap()
    assert port_eng.model.w.dtype == torch.bfloat16
    assert jax_reload._same_structure({"w": np.zeros((2, 2), np.float32)},
                                      {"w": jax.numpy.zeros((2, 2), jax.numpy.bfloat16)})


def test_watcher_considers_each_publish_once_and_runner_stops(tmp_path):
    path = tmp_path / "checkpoint_last.pt"
    w = CheckpointWatcher(str(path))
    assert w.poll() is None  # nothing published yet
    path.write_bytes(b"one")
    assert w.poll() == str(path) and w.poll() is None
    tmp = tmp_path / "tmp.pt"
    tmp.write_bytes(b"two!")
    os.replace(tmp, path)  # a publish: new inode and size
    assert w.poll() == str(path) and w.poll() is None

    port_eng, _ = _engines()
    seen = []
    hr = HotReloader(port_eng, loader=lambda p: seen.append(p) or {}, prober=lambda v: None)
    runner = ReloadRunner(CheckpointWatcher(str(path)), hr, 0.1)
    runner.start()
    tmp.write_bytes(b"three")
    os.replace(tmp, path)
    deadline = time.monotonic() + 5
    while not seen and time.monotonic() < deadline:
        time.sleep(0.05)
    t0 = time.monotonic()
    runner.stop()
    assert seen == [str(path)] and time.monotonic() - t0 < 2.0
    assert hr.last_outcome == "rejected:structure"


# ---------------------------------------------------------------------------
# the engines' swap, with real models
# ---------------------------------------------------------------------------

def test_swap_lands_on_a_batch_boundary():
    """A swap requested while a batch computes applies after it: the batch
    finishes on the old model, the next one runs on the new."""
    used = []
    started, release = threading.Event(), threading.Event()

    def infer(model, arr):
        used.append(model)
        if len(used) == 1:
            started.set()
            release.wait(5)
        return _fake_infer(model, arr)

    old, new = _Tiny(), _Tiny()
    eng = ServeEngine(old, infer, bucket_edges=(16,), batch_size=2, pad_idx=1)
    eng.set_ready(True, "serving")
    eng.queue.set_accepting(True)
    eng.start()
    try:
        r1 = eng.submit([2, 3], 10.0)
        assert started.wait(5)
        eng.request_swap(new, "test")  # mid-batch
        release.set()
        deadline = time.monotonic() + 5
        while not r1.done() and time.monotonic() < deadline:
            time.sleep(0.01)
        r2 = eng.submit([4, 5], 10.0)
        while not r2.done() and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        eng.stop()
    assert r1.response.status == r2.response.status == rq.STATUS_OK
    assert used[0] is old and used[-1] is new and eng.model is new
    assert eng.reloads_applied == 1 and eng.stats()["reloads_applied"] == 1


@pytest.fixture(scope="module")
def bert_server(tmp_path_factory):
    """An fp32 tiny BERT served by the CLI's loader and engine, on the CPU."""
    root = tmp_path_factory.mktemp("bert_reload")
    _, variables = random_jax_variables(post_ln=True)
    path = _write_bert_checkpoint(root, variables)
    args = Namespace(path=str(path), data=None, serve_quantize="off")
    loaded = serve_cli.open_serving_checkpoint(args, torch.device("cpu"))
    return root, variables, path, loaded


def _bert_engine(loaded):
    model, pad, _, vocab, _, _ = loaded
    eng = ServeEngine(model, build_infer_fn("cpu"), bucket_edges=(32,), batch_size=2,
                      pad_idx=pad, vocab_size=vocab)
    eng.warmup()
    return eng


def _answer(eng, tokens):
    r = eng.submit(tokens, 30.0)
    while not r.done():
        eng.step(timeout=0.01)
    assert r.response.status == rq.STATUS_OK
    return r.response


def test_dtype_changing_swap_serves_the_candidate_in_its_own_dtype(bert_server):
    root, variables, path, loaded = bert_server
    eng = _bert_engine(loaded)
    tokens = [5, 9, 17, 23, 8]
    fp32 = _answer(eng, tokens)
    cand = _write_bert_checkpoint(root, variables, name="bf16.pt", dtype=torch.bfloat16,
                                  step=9)
    hr = HotReloader(eng, checkpoint_utils.load_checkpoint_to_cpu, make_model=loaded[5])
    assert hr.consider(str(cand)) == "swapped"
    eng._apply_pending_swap()
    assert {p.dtype for p in eng.model.parameters()} == {torch.bfloat16}
    got = _answer(eng, tokens)
    arr = np.full((2, 32), PAD, np.int32)
    arr[0, :len(tokens)] = tokens
    ids, score = build_infer_fn("cpu")(eng.model, arr)
    assert got.output == ids[0, :len(tokens)].tolist() and got.score == float(score[0])
    assert got.score != fp32.score  # bf16 rounding moved it: the candidate answers


def test_corrupt_reload_of_a_v2_checkpoint_rolls_back_and_keeps_serving(bert_server):
    root, variables, path, loaded = bert_server
    eng = _bert_engine(loaded)
    before = eng.model
    want = _answer(eng, [7, 8, 9])
    cand = _write_bert_checkpoint(root, variables, name="cand.pt", step=11)
    clean = cand.read_bytes()
    chaos.configure(Namespace(fault_inject="corrupt-reload@0"))
    hr = HotReloader(eng, checkpoint_utils.load_checkpoint_to_cpu, make_model=loaded[5])
    assert hr.consider(str(cand)) == "rejected:verify"
    eng._apply_pending_swap()
    assert eng.model is before and eng.ready()
    got = _answer(eng, [7, 8, 9])
    assert (got.output, got.score) == (want.output, want.score)
    cand.write_bytes(clean)  # re-published intact
    assert hr.consider(str(cand)) == "swapped"


def test_structure_check_refuses_another_arch_by_name(bert_server, tmp_path):
    _, _, _, loaded = bert_server
    eng = _bert_engine(loaded)
    _, lm_vars = random_jax_lm()
    lm_path = tmp_path / "lm.pt"
    checkpoint_utils.write_checkpoint(str(lm_path), Namespace(task="causal_lm"),
                                      checkpoint_utils.from_jax_params(lm_vars))
    built = []
    hr = HotReloader(eng, checkpoint_utils.load_checkpoint_to_cpu,
                     make_model=lambda w: built.append(w))
    assert hr.consider(str(lm_path)) == "rejected:structure"
    assert built == []  # refused before anything was staged


def test_probe_rejects_non_finite_weights_and_counts_its_launches_apart(bert_server):
    _, variables, _, loaded = bert_server
    eng = _bert_engine(loaded)
    sd = {k: v.clone() for k, v in eng.model.state_dict().items()}
    sd["lm_head.bias"][3] = float("nan")
    hr = HotReloader(eng, loader=lambda p: {"model": sd}, make_model=loaded[5])
    assert hr.consider("/poisoned.pt") == "rejected:probe"
    assert eng.stats()["reload_kernel_launches"] == {}  # CPU: plain versions only


def test_decode_swap_lands_between_steps_and_keeps_the_pages():
    jm, variables = random_jax_lm()
    old = port_lm(variables)
    new = bf16_lm(variables)
    eng = DecodeEngine(old, bucket_edges=(16, 32), decode_batch=2, prefill_batch=2,
                       page_size=8, num_pages=12, pad_idx=1, eos_idx=-1, vocab_size=17,
                       max_new_tokens=6)
    eng.warmup()
    eng.probe(new)  # the candidate's canary passes
    reqs = [eng.submit(p, 60.0) for p in ([5, 6, 7, 8], [9, 10, 11])]
    eng.step(timeout=0.01)  # the prefill
    eng.step(timeout=0.01)  # one decode step
    pages = [list(s.pages) for s in eng._decode_ready]
    assert pages and all(pages)
    eng.request_swap(new, "bf16")
    eng._apply_pending_swap()  # what the loop does between steps
    assert eng.model is new and [list(s.pages) for s in eng._decode_ready] == pages
    for _ in range(50):
        if all(r.done() for r in reqs):
            break
        eng.step(timeout=0.01)
    assert all(r.response.status == rq.STATUS_OK and len(r.response.output) == 6
               for r in reqs)
    assert eng.cache.occupancy() == 0.0 and eng.reloads_applied == 1


def bf16_lm(variables):
    from unicore_tpu_torch.models.transformer_lm import TransformerLMModel

    model = TransformerLMModel(**LM_TINY)
    weights = {k: v.to(torch.bfloat16)
               for k, v in checkpoint_utils.from_jax_params(variables).items()}
    model.load_state_dict(weights, assign=True)
    return model.eval()


def test_reload_endpoint_answers_the_outcome_and_409_mid_reload():
    """``POST /v1/reload`` with a reloader (what a fleet replica sets): the
    named outcome with 200, and 409 while another reload is in flight."""
    import json
    import urllib.error
    import urllib.request

    from unicore_tpu_torch.serve.http import bind_server

    entered, release = threading.Event(), threading.Event()

    class Reloader:
        def consider(self, path):
            entered.set()
            release.wait(5)
            assert path == "/ckpt.pt"  # its own --path, whatever the body says
            return "swapped"

    eng, _ = _engines()
    server = bind_server("127.0.0.1", 0, eng)
    server.reloader, server.reload_path = Reloader(), "/ckpt.pt"
    server.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/v1/reload"

    def post():
        req = urllib.request.Request(url, data=b"{}", method="POST")
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read())

    try:
        first = []
        t = threading.Thread(target=lambda: first.append(post()))
        t.start()
        assert entered.wait(5)
        assert post() == (409, {"outcome": "reload-in-progress",
                                "error": "another reload is mid-flight"})
        release.set()
        t.join(10)
        assert first == [(200, {"outcome": "swapped"})]
    finally:
        server.shutdown()
