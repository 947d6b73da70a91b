"""The port's serving fleet (``unicore_tpu_torch/serve/fleet``,
``distributed/elastic.py``'s lease plane, the fleet chaos kinds,
``render_router``) against the JAX package's on the CPU.

Wire: leases written by either package decode in the other with equal
fields, and ``encode_lease`` strings are byte-equal; the fleet KV's files
are one layout.  Decisions: the same leases, clock values and calls give
the same balance sets, verdicts, ``frozen`` state and ``stats()`` from both
``FleetView`` s, the same picks from both ``RouterEngine`` s under one
``random.Random(seed)``, the same codes, shed reasons, retries and
down-marks over the same scripted replicas, and the same rolling-reload
histories.  In process, the JAX ``RouterEngine`` routes to a port replica
(a tiny BERT served by the port's ``ServeEngine`` and HTTP plane) and the
port's router to a JAX registrar's replica.

Tolerances: none but exact.  The routed BERT answer is held against the
port engine's own direct answer, bit for bit.
"""

import json
import os
import random
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from unicore_tpu import telemetry as jax_telemetry
from unicore_tpu.checkpoint.emergency import Deadline as JaxDeadline
from unicore_tpu.distributed import chaos as jax_chaos
from unicore_tpu.distributed import elastic as jax_elastic
from unicore_tpu.serve import fleet as jax_fleet
from unicore_tpu.serve.engine import ServeEngine as JaxServeEngine
from unicore_tpu.serve.fleet import registry as jax_registry
from unicore_tpu.serve.http import bind_server as jax_bind_server
from unicore_tpu.serve.reload import CheckpointWatcher as JaxWatcher
from unicore_tpu.telemetry import prometheus as jax_prom
from unicore_tpu.utils import retry as jax_retry

from unicore_tpu_torch import telemetry
from unicore_tpu_torch.checkpoint.emergency import Deadline
from unicore_tpu_torch.distributed import chaos, elastic
from unicore_tpu_torch.serve import CheckpointWatcher, ServeEngine, build_infer_fn
from unicore_tpu_torch.serve import fleet
from unicore_tpu_torch.serve.fleet import kv as fleet_kv
from unicore_tpu_torch.serve.fleet import registry
from unicore_tpu_torch.serve.http import bind_server
from unicore_tpu_torch.telemetry import prometheus
from unicore_tpu_torch.utils import retry

from test_torch_bert import PAD, VOCAB, port_model, random_jax_variables

PKGS = {
    "port": SimpleNamespace(fleet=fleet, Deadline=Deadline, Watcher=CheckpointWatcher),
    "jax": SimpleNamespace(fleet=jax_fleet, Deadline=JaxDeadline, Watcher=JaxWatcher),
}


@pytest.fixture(autouse=True)
def _clean_planes():
    for mod in (chaos, jax_chaos, telemetry, jax_telemetry, prometheus, jax_prom):
        mod.reset()
    yield
    for mod in (chaos, jax_chaos, telemetry, jax_telemetry, prometheus, jax_prom):
        mod.reset()


# ---------------------------------------------------------------------------
# helpers: leases, scripted replicas
# ---------------------------------------------------------------------------


def publish(client, name, address, *, seq, ready=True, est=0.0, digest="d0",
            step=0, wall=None):
    client.key_value_set(
        registry.lease_key(name),
        registry.ReplicaLease(
            name=name, address=address, ready=ready, digest=digest, est_delay_s=est,
            hb=elastic.Lease(epoch=0, seq=seq, step=step,
                             wall=time.time() if wall is None else wall),
        ).encode(),
    )


def dead_port():
    """A port bound then closed: a connect there is refused."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ScriptedReplica:
    """A replica HTTP plane that answers ``/v1/infer`` per ``mode`` and
    ``/v1/reload`` with ``reload_outcome``, counting both."""

    def __init__(self, name, mode="ok", reload_outcome="swapped", stall_s=0.0,
                 on_reload=None):
        self.name, self.mode = name, mode
        self.reload_outcome, self.stall_s = reload_outcome, stall_s
        self.on_reload = on_reload
        self.hits = 0
        self.reload_calls = 0
        me = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _json(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                if self.path == "/v1/reload":
                    me.reload_calls += 1
                    if me.on_reload is not None:
                        me.on_reload()
                    self._json(200, {"outcome": me.reload_outcome})
                    return
                me.hits += 1
                if me.stall_s:
                    time.sleep(me.stall_s)
                if me.mode == "ok":
                    doc = json.loads(body.decode() or "{}")
                    self._json(200, {"status": "ok", "output": [1], "replica": me.name,
                                     "deadline_ms": doc.get("deadline_ms")})
                elif isinstance(me.mode, tuple):  # ("status", code, payload)
                    self._json(me.mode[1], me.mode[2])
                elif me.mode == "drop-mid-body":
                    # the status line and part of the body, then a dead
                    # socket: the request reached the replica
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", "1000")
                    self.end_headers()
                    self.wfile.write(b'{"status": "ok", "output": [')
                    self.wfile.flush()
                    self.connection.shutdown(socket.SHUT_RDWR)
                    self.close_connection = True

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        # a short poll: shutdown() waits out one
        threading.Thread(target=self.server.serve_forever, args=(0.05,), daemon=True).start()

    @property
    def address(self):
        return f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def view_and_router(pkg, root, replicas, seed=7, **kw):
    """A FleetView of package ``pkg`` over a KV at ``root`` holding one lease
    per (name, address, est), polled once, and its RouterEngine."""
    client = pkg.fleet.open_fleet_kv(str(root))
    for name, address, est in replicas:
        publish(client, name, address, seq=1, est=est)
    view = pkg.fleet.FleetView(client, timeout=30.0)
    view.poll_once()
    return view, pkg.fleet.RouterEngine(view, rng=random.Random(seed), **kw)


# ---------------------------------------------------------------------------
# the fleet KV and the wire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_kv_round_trip_across_packages(tmp_path, writer):
    w = PKGS[writer].fleet.open_fleet_kv(str(tmp_path / "kv"))
    r = PKGS["jax" if writer == "port" else "port"].fleet.open_fleet_kv(str(tmp_path / "kv"))
    w.key_value_set("a/b/k1", "v1")
    w.key_value_set("a/b/k2", "v2")
    assert r.blocking_key_value_get("a/b/k1", 50) == "v1"
    assert r.key_value_dir_get("a/b") == w.key_value_dir_get("a/b") == [
        ("a/b/k1", "v1"), ("a/b/k2", "v2")]
    r.key_value_delete("a/b/k1")
    assert w.key_value_dir_get("a/b") == [("a/b/k2", "v2")]
    w.key_value_delete("a/b/k1")  # a missing key: a no-op in both


def test_kv_outcomes_classify_as_jax(tmp_path):
    root = tmp_path / "kv"
    port, ref = fleet.open_fleet_kv(str(root)), jax_fleet.open_fleet_kv(str(root))
    assert retry.kv_fetch(port, "nope/key", poll_ms=30) is retry.ABSENT
    assert jax_retry.kv_fetch(ref, "nope/key", poll_ms=30) is jax_retry.ABSENT
    port.key_value_set("yes/key", "v")
    assert retry.kv_fetch(port, "yes/key", poll_ms=30) == "v"
    os.rename(root, str(root) + ".dark")
    assert retry.kv_fetch(port, "yes/key", poll_ms=30) is retry.UNREACHABLE
    assert jax_retry.kv_fetch(ref, "yes/key", poll_ms=30) is jax_retry.UNREACHABLE
    assert fleet_kv.kv_list(port, "yes") is retry.UNREACHABLE
    with pytest.raises(ConnectionError):
        port.key_value_set("yes/key", "v")


def test_unusable_root_and_bad_names_raise_as_jax(tmp_path):
    f = tmp_path / "afile"
    f.write_text("x")
    with pytest.raises(fleet.FleetKVError, match="not a directory"):
        fleet.open_fleet_kv(str(f), create=False)
    with pytest.raises(jax_fleet.FleetKVError, match="not a directory"):
        jax_fleet.open_fleet_kv(str(f), create=False)
    with pytest.raises(fleet.FleetKVError, match="cannot create"):
        fleet.open_fleet_kv(str(f / "sub"))
    for bad in ("bad name/../x", "", "a/b"):
        with pytest.raises(ValueError) as want:
            jax_fleet.kv.check_name(bad)
        with pytest.raises(ValueError) as got:
            fleet_kv.check_name(bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fields", [
    dict(epoch=0, seq=12, step=340, wall=1754300000.0),
    dict(epoch=3, seq=1, step=0, wall=1754300000.123456, step_wall=0.25),
    dict(epoch=0, seq=1800, step=77, wall=0.0005, step_wall=-1.0),
])
def test_encode_lease_is_byte_equal(fields):
    raw = elastic.encode_lease(elastic.Lease(**fields))
    assert raw == jax_elastic.encode_lease(jax_elastic.Lease(**fields))
    assert vars(elastic.decode_lease(raw)) == vars(jax_elastic.decode_lease(raw))
    five = raw.rsplit("|", 1)[0]  # a lease without step_wall still decodes
    assert vars(elastic.decode_lease(five)) == vars(jax_elastic.decode_lease(five))
    for bad in ("uctp-hb2|0|1|2|3.0", "uctp-hb1|0|1"):
        with pytest.raises(ValueError):
            jax_elastic.decode_lease(bad)
        with pytest.raises(ValueError):
            elastic.decode_lease(bad)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_replica_lease_decodes_across_packages(writer):
    mods = {"port": (registry, elastic), "jax": (jax_registry, jax_elastic)}
    reg, el = mods[writer]
    lease = reg.ReplicaLease(
        name="r1", address="http://10.0.0.7:8693", ready=True, digest="abc123",
        est_delay_s=0.2500004,
        hb=el.Lease(epoch=0, seq=12, step=340, wall=1754300000.25),
    )
    raw = lease.encode()
    other = jax_registry if writer == "port" else registry
    back = other.decode_replica_lease(raw)
    assert back.encode() == raw
    for f in ("name", "address", "ready", "digest"):
        assert getattr(back, f) == getattr(lease, f)
    assert back.est_delay_s == 0.25
    assert vars(back.hb) == vars(lease.hb)
    with pytest.raises(ValueError):
        registry.decode_replica_lease('{"tag": "wrong"}')
    assert registry.lease_key("r1") == jax_registry.lease_key("r1")


def test_registrar_publishes_readiness_and_says_goodbye(tmp_path):
    client = fleet.open_fleet_kv(str(tmp_path / "kv"))
    ready = [False]
    reg = fleet.ReplicaRegistrar(
        client, "r0", "http://127.0.0.1:9", interval_s=30.0,
        ready_fn=lambda: ready[0], est_delay_fn=lambda: 0.5,
        digest_fn=lambda: "dg", served_fn=lambda: 7,
    ).start()
    try:
        key = registry.lease_key("r0")
        lease = jax_registry.decode_replica_lease(client.blocking_key_value_get(key, 100))
        assert not lease.ready and lease.digest == "dg"
        assert lease.est_delay_s == 0.5 and lease.hb.step == 7
        seq0 = lease.hb.seq
        ready[0] = True
        reg.publish_now()  # the readiness handshake's beat
        lease = jax_registry.decode_replica_lease(client.blocking_key_value_get(key, 100))
        assert lease.ready and lease.hb.seq == seq0 + 1
    finally:
        reg.stop(goodbye=True)
    assert retry.kv_fetch(client, key, poll_ms=30) is retry.ABSENT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_model_digest_tracks_names_shapes_types_and_bytes(dtype):
    torch.manual_seed(0)
    sd = {"b": torch.randn(3).to(dtype), "w": torch.randn(2, 4).to(dtype),
          "s": torch.tensor(2.0)}
    digest = registry.model_digest(sd)
    assert len(digest) == 16
    assert registry.model_digest({k: v.clone() for k, v in reversed(sd.items())}) == digest
    moved = dict(sd, b=sd["b"].clone())
    moved["b"].view(torch.uint8)[0] ^= 1  # one bit of one element
    assert registry.model_digest(moved) != digest
    assert registry.model_digest(dict(sd, w=sd["w"].reshape(4, 2))) != digest
    assert registry.model_digest({("x" + k): v for k, v in sd.items()}) != digest
    if dtype is torch.bfloat16:  # same values, another type
        assert registry.model_digest(dict(sd, b=sd["b"].half())) != digest


# ---------------------------------------------------------------------------
# membership: the same verdicts as the JAX FleetView
# ---------------------------------------------------------------------------

W = 1754300000.0  # the lease wall stamps: injected, so a restart is exact

SCENARIOS = {
    # r0 beats, r1 goes silent (its key stays, as os._exit leaves it); the
    # corpse's last lease does not resurrect it; an advancing seq rejoins
    "silent": (5.0, [
        ("pub", "r0", "http://h:1", 1), ("pub", "r1", "http://h:2", 1), ("poll", 0.0),
        ("pub", "r0", "http://h:1", 20), ("poll", 2.0),
        ("pub", "r0", "http://h:1", 40), ("poll", 4.0),
        ("pub", "r0", "http://h:1", 65), ("poll", 6.5),
        ("poll", 7.0),
        ("pub", "r1", "http://h:2", 100), ("poll", 7.5),
    ]),
    # a replica restarted under its name re-counts seq from 1 with a new
    # wall stamp: it rejoins on its first beat; the loss counter stands
    "restarted": (5.0, [
        ("pub", "r0", "http://h:1", 1800), ("poll", 0.0), ("poll", 3.0), ("poll", 6.5),
        ("pubw", "r0", "http://h:1", 1, W + 7.0), ("poll", 7.0),
    ]),
    # the store goes dark for 4x the timeout: frozen, no verdict; back, and
    # the replica that kept publishing is still a member
    "outage": (5.0, [
        ("pub", "r0", "http://h:1", 1), ("poll", 0.0), ("dark",),
        ("poll", 2.0), ("poll", 8.0), ("poll", 14.0), ("poll", 20.0), ("light",),
        ("pub", "r0", "http://h:1", 50), ("poll", 21.0),
    ]),
    # a healthy store with no replicas is no outage
    "empty": (2.0, [("poll", 0.0), ("poll", 3.0), ("poll", 6.0)]),
    # a deleted key is a goodbye: removed, not lost
    "deleted": (5.0, [
        ("pub", "r0", "http://h:1", 1), ("poll", 0.0), ("del", "r0"), ("poll", 1.0),
    ]),
    # a down-mark clears only on a FRESH ready lease
    "down-mark": (5.0, [
        ("pub", "r0", "http://h:1", 3), ("poll", 0.0), ("mark", "r0", "503:draining"),
        ("poll", 1.0), ("pubr", "r0", "http://h:1", 4, False), ("poll", 2.0),
        ("pubr", "r0", "http://h:1", 5, True), ("poll", 3.0),
    ]),
    # an address without a port never enters the balance set
    "bad-address": (5.0, [
        ("pub", "bad", "http://10.0.0.7", 1), ("pub", "good", "http://10.0.0.7:8693", 1),
        ("poll", 0.0), ("poll", 1.0),
    ]),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fleet_view_decides_as_jax(tmp_path, name):
    timeout, steps = SCENARIOS[name]
    client = fleet.open_fleet_kv(str(tmp_path / "kv"))
    now = [0.0]
    views = {key: PKGS[key].fleet.FleetView(
        PKGS[key].fleet.open_fleet_kv(str(tmp_path / "kv")), timeout=timeout,
        clock=lambda: now[0]) for key in PKGS}
    trail = {key: [] for key in PKGS}
    for step in steps:
        op = step[0]
        if op == "pub":
            publish(client, step[1], step[2], seq=step[3], wall=W + step[3] * 1e-3)
        elif op == "pubw":
            publish(client, step[1], step[2], seq=step[3], wall=step[4])
        elif op == "pubr":
            publish(client, step[1], step[2], seq=step[3], ready=step[4], wall=W + step[3])
        elif op == "del":
            client.key_value_delete(registry.lease_key(step[1]))
        elif op == "dark":
            os.rename(client.root, client.root + ".dark")
        elif op == "light":
            os.rename(client.root + ".dark", client.root)
        for key, view in views.items():
            if op == "poll":
                now[0] = step[1]
                view.poll_once(step[1])
            elif op == "mark":
                view.mark_unready(step[1], step[2])
            else:
                continue
            trail[key].append((sorted(r.name for r in view.balance_set()), view.stats(),
                               view.frozen_since))
    assert trail["port"] == trail["jax"]
    last = trail["port"][-1]
    if name in ("silent", "restarted"):
        assert last[1]["losses"] == 1 and last[1]["lost"] == []
    if name == "outage":
        assert any(t[1]["frozen"] for t in trail["port"]) and not last[1]["frozen"]
        assert last[0] == ["r0"]
    if name == "deleted":
        assert last[0] == [] and last[1]["lost"] == []
    if name == "down-mark":
        assert last[0] == ["r0"] and trail["port"][-2][0] == []


def test_membership_runner_polls_and_stops(tmp_path):
    client = fleet.open_fleet_kv(str(tmp_path / "kv"))
    publish(client, "r0", "http://h:1", seq=1)
    view = fleet.FleetView(client, timeout=5.0)
    runner = fleet.MembershipRunner(view, 0.1).start()
    deadline = time.monotonic() + 10
    while view.rounds < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    runner.stop()
    assert view.rounds >= 2 and not runner._thread.is_alive()
    assert [r.name for r in view.balance_set()] == ["r0"]


# ---------------------------------------------------------------------------
# routing: the same choices and outcomes as the JAX RouterEngine
# ---------------------------------------------------------------------------

P2C = {
    # tied estimates: a jittered coin flip spreads them
    "tied": ([("b0", 0.0), ("b1", 0.0)], False, 300),
    # a slightly lower stale estimate: the in-flight cost spreads the pair
    "stale": ([("b0", 0.010), ("b1", 0.012)], True, 40),
    # three replicas, equal estimates, dispatch and done: nobody starves
    "three": ([("b0", 0.0), ("b1", 0.0), ("b2", 0.0)], "done", 300),
}


@pytest.mark.parametrize("name", list(P2C))
def test_p2c_picks_as_jax(tmp_path, name):
    reps, inflight, n = P2C[name]
    picks = {}
    for key, pkg in PKGS.items():
        view, router = view_and_router(
            pkg, tmp_path / key, [(r, f"http://127.0.0.1:{i + 1}", est)
                                  for i, (r, est) in enumerate(reps)], seed=11)
        seq = []
        for _ in range(n):
            pick = router.pick_replica()
            seq.append(pick.name)
            if inflight:
                view.note_dispatch(pick.name)
            if inflight == "done":
                view.note_done(pick.name)
        picks[key] = seq
    assert picks["port"] == picks["jax"]
    counts = {r: picks["port"].count(r) for r, _ in reps}
    assert min(counts.values()) >= {"tied": 90, "stale": 15, "three": 50}[name], counts


def _route(pkg, root, name):
    """Drive one routing scenario on package ``pkg``; what both packages
    must agree on."""
    out = {}
    if name == "deadline":
        r = ScriptedReplica("r0")
        view, router = view_and_router(pkg, root, [("r0", r.address, 0.0)])
        deadline = pkg.Deadline(10.0)
        time.sleep(0.15)
        code, body = router.handle_infer({"tokens": [1]}, deadline)
        # downstream sees what is LEFT of the budget
        out["rewritten"] = body["deadline_ms"] < 10000.0 - 100.0
        reps = [r]
    elif name == "connect-failure":
        alive = ScriptedReplica("alive")
        view, router = view_and_router(pkg, root, [
            ("dead", f"http://127.0.0.1:{dead_port()}", 0.0),
            ("alive", alive.address, 5.0)])  # dead scores better
        code, body = router.handle_infer({"tokens": [1]}, pkg.Deadline(5.0))
        out["second"] = router.handle_infer({"tokens": [1]}, pkg.Deadline(5.0))
        reps = [alive]
    elif name == "budget":
        view, router = view_and_router(pkg, root, [
            (f"d{i}", f"http://127.0.0.1:{dead_port()}", 0.0) for i in range(4)],
            retry_budget=1)
        code, body = router.handle_infer({"tokens": [1]}, pkg.Deadline(5.0))
        out["tried"] = len(set(body.pop("replicas_tried")))
        reps = []
    elif name == "streamed":
        dropper, backup = ScriptedReplica("dropper", mode="drop-mid-body"), ScriptedReplica("b")
        view, router = view_and_router(pkg, root, [
            ("dropper", dropper.address, 0.0), ("backup", backup.address, 5.0)])
        code, body = router.handle_infer({"tokens": [1]}, pkg.Deadline(5.0))
        body.pop("detail", None)
        reps = [dropper, backup]
    elif name == "stall":
        zombie, alive = ScriptedReplica("zombie", stall_s=3.0), ScriptedReplica("alive")
        view, router = view_and_router(pkg, root, [
            ("zombie", zombie.address, 0.0), ("alive", alive.address, 5.0)])
        t0 = time.monotonic()
        code, body = router.handle_infer({"tokens": [1]}, pkg.Deadline(0.6))
        out["bounded"] = time.monotonic() - t0 < 2.5
        out["second"] = router.handle_infer({"tokens": [1]}, pkg.Deadline(5.0))
        reps = [zombie, alive]
    elif name == "replica-503":
        draining = ScriptedReplica("draining", mode=("status", 503, {
            "status": "shed", "reason": "draining"}))
        alive = ScriptedReplica("alive")
        view, router = view_and_router(pkg, root, [
            ("draining", draining.address, 0.0), ("alive", alive.address, 5.0)])
        code, body = router.handle_infer({"tokens": [1]}, pkg.Deadline(5.0))
        out["second"] = router.handle_infer({"tokens": [1]}, pkg.Deadline(5.0))
        reps = [draining, alive]
    elif name == "empty":
        view = pkg.fleet.FleetView(pkg.fleet.open_fleet_kv(str(root)), timeout=30.0)
        router = pkg.fleet.RouterEngine(view)
        code, body = router.handle_infer({"tokens": [1]}, pkg.Deadline(1.0))
        reps = []
    for r in reps:
        r.close()
    if "second" in out:  # the remaining budget it carried varies by a few ms
        out["second"][1].pop("deadline_ms", None)
    stats = router.stats()
    for k in ("p50_ms", "p90_ms", "p99_ms"):
        out[k] = k in stats
    body.pop("deadline_ms", None)
    out.update(code=code, body=body, hits=[r.hits for r in reps],
               retries=router.retries, shed=dict(router.shed_counts),
               by_code=stats["by_code"], by_replica=stats["by_replica"],
               down={n: i["down"] for n, i in stats["fleet"]["replicas"].items()})
    return out


@pytest.mark.parametrize("name", ["deadline", "connect-failure", "budget", "streamed",
                                  "stall", "replica-503", "empty"])
def test_routing_outcomes_as_jax(tmp_path, name):
    got = _route(PKGS["port"], tmp_path / "port", name)
    want = _route(PKGS["jax"], tmp_path / "jax", name)
    assert got == want
    expect = {
        "deadline": (200, None), "connect-failure": (200, "alive"),
        "budget": (503, "retry-budget-exhausted"), "streamed": (502, "upstream-incomplete"),
        "stall": (504, "upstream-timeout"), "replica-503": (200, "alive"),
        "empty": (503, "no-ready-replica"),
    }[name]
    assert got["code"] == expect[0]
    assert expect[1] in (None, got["body"].get("replica"), got["body"].get("reason"))
    if name == "connect-failure":
        assert got["retries"] == 1 and got["down"]["dead"] == "connect-failure"
        assert got["second"][0] == 200  # the dead replica is not dialled again
    if name == "budget":
        assert got["tried"] == 2 and got["shed"] == {"retry-budget-exhausted": 1}
    if name == "streamed":
        assert got["hits"] == [1, 0] and got["retries"] == 0  # never retried
    if name == "stall":
        assert got["bounded"] and got["second"][1]["replica"] == "alive"
    if name == "replica-503":
        assert got["hits"] == [1, 2] and got["down"]["draining"] == "503:draining"


def test_drain_handshake_over_port_replicas_loses_nothing(tmp_path):
    """One port replica starts draining mid-traffic (its 503 carries
    Retry-After): every request the router accepts afterwards is served by
    the other."""
    def infer(model, arr):
        return np.asarray(arr).copy(), np.ones(arr.shape[0], dtype=np.float32)

    engines, servers = [], []
    for _ in range(2):
        eng = ServeEngine(None, infer, bucket_edges=(16,), batch_size=2, pad_idx=1,
                          admission_capacity=64)
        eng.warmup()
        eng.start()
        srv = bind_server("127.0.0.1", 0, eng, read_timeout_s=2.0)
        srv.start()
        engines.append(eng)
        servers.append(srv)
    try:
        addr = [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]
        view, router = view_and_router(PKGS["port"], tmp_path / "kv",
                                       [("a", addr[0], 0.0), ("b", addr[1], 0.0)])
        engines[0].queue.begin_drain()
        engines[0].set_ready(False, "draining")
        req = urllib.request.Request(addr[0] + "/v1/infer", method="POST",
                                     data=json.dumps({"tokens": [1]}).encode())
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=5)
        assert err.value.code == 503 and err.value.headers["Retry-After"] == "1"
        for _ in range(20):
            assert router.handle_infer({"tokens": [2, 3]}, Deadline(10.0))[0] == 200
        assert router.stats()["by_code"] == {"200": 20}
    finally:
        for eng in engines:
            eng.stop()
        for srv in servers:
            srv.shutdown()


# ---------------------------------------------------------------------------
# rolling reload
# ---------------------------------------------------------------------------

ROLLS = {
    "all-swapped": ["swapped", "swapped", "swapped"],
    "halt-on-rollback": ["swapped", "rejected:verify", "swapped"],
    "halt-on-unreachable": [None, "swapped", "swapped"],
}


def fresh_lease_on_reload(client, name, address, seq=[1]):
    """A scripted replica's reload hook: it beats once after its reload, as
    a replica's registrar does within an interval."""
    def beat():
        seq[0] += 1
        publish(client, name, address, seq=seq[0])
    return beat


def _roll(pkg, root, outcomes):
    client = fleet.open_fleet_kv(str(root))
    fakes = [ScriptedReplica(f"r{i}", reload_outcome=o or "swapped") for i, o in enumerate(outcomes)]
    for f in fakes:
        f.on_reload = fresh_lease_on_reload(client, f.name, f.address, [1])
    reps = [(f.name, f.address if o else f"http://127.0.0.1:{dead_port()}", 0.0)
            for f, o in zip(fakes, outcomes)]
    view, _ = view_and_router(pkg, root, reps)
    runner = pkg.fleet.MembershipRunner(view, 0.1).start()
    roll = pkg.fleet.RollingReload(pkg.Watcher(str(root / "ckpt.pt")), view,
                                   interval_s=1.0, reload_timeout_s=2.0)
    history = roll.roll("/fake/candidate.pt")
    runner.stop()
    for f in fakes:
        f.close()
    return ([(n, o.split(" ")[0]) for n, o in history], roll.rolled, roll.halted,
            [f.reload_calls for f in fakes], len(view.balance_set()))


@pytest.mark.parametrize("name", list(ROLLS))
def test_rolling_reload_as_jax(tmp_path, name):
    got = _roll(PKGS["port"], tmp_path / "port", ROLLS[name])
    assert got == _roll(PKGS["jax"], tmp_path / "jax", ROLLS[name])
    history, rolled, halted, calls, routable = got
    if name == "all-swapped":
        assert history == [(f"r{i}", "swapped") for i in range(3)] and rolled == 1
    elif name == "halt-on-rollback":
        assert history == [("r0", "swapped"), ("r1", "rejected:verify")]
        assert halted == 1 and calls[2] == 0 and routable == 3  # r2 never asked
    else:
        assert history == [("r0", "unreachable")] and halted == 1 and calls == [0, 0, 0]


@pytest.mark.parametrize("back_after_s", [0.4, None])
def test_roll_asks_the_next_replica_once_the_last_is_routable(tmp_path, back_after_s):
    """A replica's lease says ready=false through its reload and for up to a
    beat after it: the next replica is asked only once the swapped one is
    back in the balance set (so one is always routable), and a replica that
    never comes back halts the roll (the JAX roll asks the next at once)."""
    client = fleet.open_fleet_kv(str(tmp_path / "kv"))
    seen = {}

    def reload_r0():
        publish(client, "r0", fakes[0].address, seq=2, ready=False)
        if back_after_s is not None:
            threading.Timer(back_after_s, lambda: publish(
                client, "r0", fakes[0].address, seq=3, ready=True)).start()

    def reload_r1():
        seen["r0_routable"] = view.get("r0").routable()
        publish(client, "r1", fakes[1].address, seq=2)

    fakes = [ScriptedReplica("r0", on_reload=reload_r0), ScriptedReplica("r1", on_reload=reload_r1)]
    try:
        for f in fakes:
            publish(client, f.name, f.address, seq=1)
        view = fleet.FleetView(client, timeout=30.0)
        view.poll_once()
        runner = fleet.MembershipRunner(view, 0.05).start()
        roll = fleet.RollingReload(CheckpointWatcher(str(tmp_path / "ckpt.pt")), view,
                                   interval_s=1.0, reload_timeout_s=1.5)
        history = roll.roll("/fake/candidate.pt")
        runner.stop()
    finally:
        for f in fakes:
            f.close()
    if back_after_s is not None:
        assert history == [("r0", "swapped"), ("r1", "swapped")] and roll.rolled == 1
        assert seen == {"r0_routable": True}
    else:
        assert history == [("r0", "swapped")] and roll.halted == 1
        assert roll.last_outcome == "not-readmitted" and fakes[1].reload_calls == 0


def test_rolling_runner_rolls_a_publish_once(tmp_path):
    client = fleet.open_fleet_kv(str(tmp_path / "kv"))
    fakes = [ScriptedReplica(f"r{i}") for i in range(2)]
    for f in fakes:
        f.on_reload = fresh_lease_on_reload(client, f.name, f.address, [1])
    try:
        view, _ = view_and_router(PKGS["port"], tmp_path / "kv",
                                  [(f.name, f.address, 0.0) for f in fakes])
        runner = fleet.MembershipRunner(view, 0.1).start()
        ckpt = tmp_path / "ckpt.pt"
        ckpt.write_bytes(b"v1")
        roll = fleet.RollingReload(CheckpointWatcher(str(ckpt)), view, interval_s=0.1).start()
        ckpt.write_bytes(b"v2 longer")
        deadline = time.monotonic() + 10
        while roll.rolled < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.3)
        roll.stop()
        runner.stop()
        assert roll.rolled == 1 and [f.reload_calls for f in fakes] == [1, 1]
    finally:
        for f in fakes:
            f.close()


# ---------------------------------------------------------------------------
# the exposition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine_of", ["port", "jax"])
def test_render_router_matches_jax(tmp_path, engine_of):
    r = ScriptedReplica("r0")
    try:
        view, router = view_and_router(PKGS[engine_of], tmp_path / "kv",
                                       [("r0", r.address, 0.25),
                                        ("r1", f"http://127.0.0.1:{dead_port()}", 9.0)])
        for _ in range(3):
            assert router.handle_infer({"tokens": [1]}, PKGS[engine_of].Deadline(5.0))[0] == 200
        view.mark_unready("r1", "connect-failure")
        router._count_shed("retry-budget-exhausted", 503)
        text = prometheus.render_router(router)
        assert text == jax_prom.render_router(router)
        for line in ("unicore_tpu_router_ready 1", "unicore_tpu_router_ok_total 3",
                     'unicore_tpu_router_replica_proxied_total{replica="r0"} 3',
                     "unicore_tpu_router_replicas_routable 1",
                     'unicore_tpu_router_shed_total{reason="retry-budget-exhausted"} 1'):
            assert line in text
    finally:
        r.close()


# ---------------------------------------------------------------------------
# the fleet chaos kinds
# ---------------------------------------------------------------------------


def test_replica_loss_fires_on_its_index_once_as_jax(monkeypatch):
    exits = []
    monkeypatch.setattr(os, "_exit", lambda code: exits.append(code))
    seen = {}
    for mod in (chaos, jax_chaos):
        exits.clear()
        mod.configure(SimpleNamespace(fault_inject="replica-loss@2@1"))
        trail = []
        for idx, batch in [(0, 5), (1, 1), (1, 2), (1, 3)]:
            mod.set_replica_index(idx)
            mod.note_serve_batch(batch)
            trail.append(list(exits))
        seen[mod] = trail
        mod.reset()
    assert seen[chaos] == seen[jax_chaos] == [[], [], [74], [74]]
    assert chaos.HOST_LOSS_EXIT_CODE == jax_chaos.HOST_LOSS_EXIT_CODE == 74


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def monotonic(self):
        return self.t


@pytest.mark.parametrize("spec,idx", [("replica-stall:0.3@0@2", 0),
                                      ("replica-stall:0.3@1@0", 0),
                                      ("replica-stall@0", 3)])
def test_replica_stall_window_and_targeting_as_jax(monkeypatch, spec, idx):
    seen = {}
    for mod in (chaos, jax_chaos):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        mod.configure(SimpleNamespace(fault_inject=spec))
        mod.set_replica_index(idx)
        trail = []
        for batch, t in [(0, 100.0), (1, 100.1), (1, 100.35), (2, 100.5), (3, 5000.0)]:
            clock.t = t
            mod.note_serve_batch(batch)
            trail.append(mod.replica_stall_active())
        seen[mod] = trail
    assert seen[chaos] == seen[jax_chaos]


def test_stalled_handler_releases_when_the_window_closes():
    """The port replica's /v1/infer handler wedges while the stall window is
    open and answers once it closes; the lease plane is not involved."""
    def infer(model, arr):
        return np.asarray(arr).copy(), np.ones(arr.shape[0], dtype=np.float32)

    eng = ServeEngine(None, infer, bucket_edges=(16,), batch_size=2, pad_idx=1)
    eng.warmup()
    eng.start()
    srv = bind_server("127.0.0.1", 0, eng, read_timeout_s=2.0)
    srv.start()
    try:
        chaos.configure(SimpleNamespace(fault_inject="replica-stall:0.6@0@0"))
        chaos.set_replica_index(0)
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/v1/infer", method="POST",
            data=json.dumps({"tokens": [3, 4], "deadline_ms": 5000}).encode())
        t0 = time.monotonic()
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert resp.status == 200
        assert 0.5 <= time.monotonic() - t0 < 5.0
    finally:
        eng.stop()
        srv.shutdown()


# ---------------------------------------------------------------------------
# across packages, in process
# ---------------------------------------------------------------------------


def test_jax_router_routes_to_a_port_replica(tmp_path):
    """A tiny BERT on the port's engine and HTTP plane, registered by the
    port's registrar; the JAX FleetView and RouterEngine over the same KV
    route to it and return its answer."""
    _, variables = random_jax_variables(post_ln=True)
    model = port_model(variables, post_ln=True)
    eng = ServeEngine(model, build_infer_fn(torch.device("cpu")), bucket_edges=(32,),
                      batch_size=2, pad_idx=PAD, vocab_size=VOCAB)
    eng.warmup()
    eng.start()
    srv = bind_server("127.0.0.1", 0, eng, read_timeout_s=5.0, default_deadline_ms=30000)
    srv.start()
    client = fleet.open_fleet_kv(str(tmp_path / "kv"))
    reg = fleet.ReplicaRegistrar(
        client, "p0", f"http://127.0.0.1:{srv.server_address[1]}", interval_s=30.0,
        ready_fn=eng.ready, est_delay_fn=eng.queue.estimated_delay,
        digest_fn=lambda: registry.model_digest(model.state_dict()),
        served_fn=lambda: eng.served,
    ).start()
    try:
        view = jax_fleet.FleetView(jax_fleet.open_fleet_kv(str(tmp_path / "kv")), timeout=30.0)
        view.poll_once()
        assert [r.name for r in view.balance_set()] == ["p0"]
        assert view.get("p0").digest == registry.model_digest(model.state_dict())
        router = jax_fleet.RouterEngine(view, rng=random.Random(0))
        tokens = [5, 9, 17, 23, 8, 31]
        code, routed = router.handle_infer({"tokens": tokens, "id": "q"}, JaxDeadline(30.0))
        assert code == 200, routed
        direct = eng.submit(np.asarray(tokens, np.int32), 30.0, "d")
        retry.bounded_wait(direct.done, 30.0)
        want = direct.response.to_json()
        assert routed["output"] == want["output"] and routed["score"] == want["score"]
        assert router.stats()["by_replica"] == {"p0": 1}
    finally:
        reg.stop(goodbye=True)
        eng.stop()
        srv.shutdown()


def test_port_router_routes_to_a_jax_registrars_replica(tmp_path):
    def infer(variables, arr):
        return np.asarray(arr).copy(), np.full(arr.shape[0], 0.5, dtype=np.float32)

    eng = JaxServeEngine({"params": {"w": np.zeros((2, 2))}}, infer, bucket_edges=(16,),
                         batch_size=2, pad_idx=1)
    eng.warmup()
    eng.start()
    srv = jax_bind_server("127.0.0.1", 0, eng, read_timeout_s=2.0)
    srv.start()
    client = jax_fleet.open_fleet_kv(str(tmp_path / "kv"))
    reg = jax_fleet.ReplicaRegistrar(
        client, "j0", f"http://127.0.0.1:{srv.server_address[1]}", interval_s=30.0,
        ready_fn=eng.ready, est_delay_fn=eng.queue.estimated_delay,
        digest_fn=lambda: "jaxdigest", served_fn=lambda: eng.served,
    ).start()
    try:
        view = fleet.FleetView(fleet.open_fleet_kv(str(tmp_path / "kv")), timeout=30.0)
        view.poll_once()
        assert view.stats()["replicas"]["j0"]["digest"] == "jaxdigest"
        router = fleet.RouterEngine(view, rng=random.Random(0))
        code, body = router.handle_infer({"tokens": [3, 4, 5]}, Deadline(10.0))
        assert code == 200 and body["output"] == [3, 4, 5] and body["score"] == 0.5
        # the JAX replica's goodbye deregisters it in the port's view
        reg.stop(goodbye=True)
        view.poll_once()
        assert view.balance_set() == [] and view.stats()["lost"] == []
        code, body = router.handle_infer({"tokens": [3]}, Deadline(1.0))
        assert (code, body["reason"]) == (503, "no-ready-replica")
    finally:
        reg.stop(goodbye=False)
        eng.stop()
        srv.shutdown()
