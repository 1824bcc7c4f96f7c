"""The port's cluster plane (``selkies_tpu_torch/cluster/``) against JAX's,
on the CPU.

tests/test_cluster.py's scenarios, each run through both packages on the
same inputs and held equal:

- capacity digests built from the same placer, drain, device and SLO
  views, field for field without ``ts``; ``/healthz``'s ``capacity`` block
  and ``/statz``'s ``cluster`` block off each package's own server;
- signatures on the same secret and body; heartbeats across packages in
  both directions (a JAX node's beat is accepted by a port node and the
  reverse, a wrong secret is refused by both);
- leases, capped backoff, the replay guard, the bound on tracked peers and
  the ``cluster:*`` fault sites, on one injected clock and one fault spec;
- router decisions and scores on the same digests;
- migrations between fake fleets (restores, failed restores, claim expiry,
  the nonce window, seeded chaos over three hosts);
- the live migration: two port hosts over ``TorchMultiSessionH264Service``
  joined by ``LocalMigrationChannel`` with real signalling servers, whose
  recovery IDR after the move equals JAX's uninterrupted oracle by sha256;
  and across packages in both directions, where the checkpoint JSON is the
  only state that crosses.

JAX's hosts run on tier-1's virtual CPU devices, the port's on
``torch.device("cpu")``. Torch runs with one intra-op thread.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from selkies_tpu import cluster as jcluster
from selkies_tpu.cluster import membership as jmembership
from selkies_tpu.cluster import migrate as jmigrate
from selkies_tpu.monitoring.telemetry import telemetry as jtele
from selkies_tpu.parallel import fleet as jfleet
from selkies_tpu.parallel import lifecycle as jlifecycle
from selkies_tpu.parallel.serving import MultiSessionH264Service
from selkies_tpu.resilience import InjectedFault as JInjectedFault
from selkies_tpu.resilience import configure_faults as jconfigure
from selkies_tpu.resilience import reset_faults as jreset
from selkies_tpu.signalling import client as jclient
from selkies_tpu.signalling import server as jserver
from selkies_tpu_torch import cluster as tcluster
from selkies_tpu_torch.cluster import membership as tmembership
from selkies_tpu_torch.cluster import migrate as tmigrate
from selkies_tpu_torch.monitoring.telemetry import telemetry as ttele
from selkies_tpu_torch.parallel import fleet as tfleet
from selkies_tpu_torch.parallel import lifecycle as tlifecycle
from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service
from selkies_tpu_torch.resilience import InjectedFault as TInjectedFault
from selkies_tpu_torch.resilience import configure_faults as tconfigure
from selkies_tpu_torch.resilience import reset_faults as treset
from selkies_tpu_torch.signalling import client as tclient
from selkies_tpu_torch.signalling import server as tserver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 96  # tests/test_cluster.py's geometry
CPU = torch.device("cpu")

JAX = SimpleNamespace(name="jax", cluster=jcluster, membership=jmembership, migrate=jmigrate,
                      tele=jtele, fleet=jfleet, lifecycle=jlifecycle, client=jclient,
                      server=jserver, configure=jconfigure, InjectedFault=JInjectedFault)
PORT = SimpleNamespace(name="torch", cluster=tcluster, membership=tmembership,
                       migrate=tmigrate, tele=ttele, fleet=tfleet, lifecycle=tlifecycle,
                       client=tclient, server=tserver, configure=tconfigure,
                       InjectedFault=TInjectedFault)
PKGS = (JAX, PORT)
CLUSTER_ENV = ("SELKIES_CLUSTER_PEERS", "SELKIES_CLUSTER_SELF", "SELKIES_CLUSTER_SECRET",
               "SELKIES_CLUSTER_HEARTBEAT_S", "SELKIES_CLUSTER_LEASE_S",
               "SELKIES_CLUSTER_CLAIM_S", "SELKIES_CAPACITY_FILE", "SELKIES_FAULTS",
               "SELKIES_TELEMETRY", "SELKIES_OCCUPANCY", "SELKIES_SLO", "SELKIES_POLICY",
               "SELKIES_BANDS", "SELKIES_TILE_GRID")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """The cluster's knobs cleared, both injectors and both packages'
    lifecycle registrations reset, one torch intra-op thread."""
    for k in CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jreset()
    treset()
    yield
    jreset()
    treset()
    for tele in (jtele, ttele):
        tele._lifecycle = None
        tele.disable()
        tele.reset()
    torch.set_num_threads(threads)


def both(fn, *a, **k) -> dict:
    """``fn(pkg, ...)`` for each package -> {"jax": ..., "torch": ...}."""
    out = {}
    for pkg in PKGS:
        out[pkg.name] = fn(pkg, *a, **k)
        (jreset if pkg is JAX else treset)()
    return out


def run(coro):
    return asyncio.run(coro)


def chips(n=4, tag=""):
    return [f"chip{tag}{i}" for i in range(n)]


def no_ts(d: dict) -> dict:
    return {k: v for k, v in d.items() if k != "ts"}


def _loopback(nodes: dict):
    async def send(peer, body, sig):
        node = nodes.get(peer)
        return node is not None and node.receive(body, sig)
    return send


def _mk_node(pkg, host, peers, nodes, *, digest=None, clock=None, secret="k",
             heartbeat_s=0.05, lease_s=0.2):
    node = pkg.membership.ClusterNode(
        host, peers, secret=secret, heartbeat_s=heartbeat_s, lease_s=lease_s,
        transport=_loopback(nodes),
        digest_fn=digest or (lambda: pkg.membership.build_digest(codecs=["h264"])),
        **({"clock": clock} if clock else {}))
    nodes[host] = node
    return node


# -- the capacity digest -------------------------------------------------------------

def _digest_case(pkg):
    p = pkg.lifecycle.SessionPlacer(devices=chips(4), bands=2, host_cores=8)
    p.place_initial(1, 2)
    p.set_busy(0, True)
    out = [pkg.membership.build_digest(
        host="http://a:1", placer=p,
        devices_view={"chips": 4, "healthy": 3, "quarantined": ["chip3"], "capacity": 0.75},
        slo_views={"0": {"chronic": ["latency_p50"]}, "1": {"chronic": []}},
        codecs=["av1", "h264"])]
    drainer = pkg.lifecycle.DrainController("digest", placer=p, deadline_s=5.0)
    drainer.begin()
    out.append(pkg.membership.build_digest(drain=drainer, codecs=["h264"],
                                           capacity_rows=[]))
    shared = pkg.lifecycle.SessionPlacer(devices=chips(1), bands=1, host_cores=8)
    shared.place_initial(3, 1)
    out.append(pkg.membership.build_digest(placer=shared, capacity_rows=[]))
    out.append(pkg.membership.build_digest())
    pkg.tele._lifecycle = None
    return [no_ts(d) for d in out]


def test_build_digest_matches_jax():
    got = both(_digest_case)
    assert got["torch"] == got["jax"]
    d = got["torch"][0]
    assert d["has_placer"] and d["bands"] == 2 and not d["shared"]
    assert (d["chips"], d["healthy_chips"], d["quarantined_chips"]) == (4, 3, 1)
    assert (d["sessions"], d["busy"], d["free_chips"], d["free_slots"]) == (1, 1, 2, 1)
    assert d["chronic_burn"] == ["0"] and d["codecs"] == ["av1", "h264"]
    assert got["torch"][1]["draining"] and got["torch"][1]["drain_state"] == "draining"
    assert got["torch"][2]["shared"] and got["torch"][2]["chips"] == 1
    for d in got["torch"]:
        assert json.loads(json.dumps(d)) == d


def _capacity_rows(pkg, tmp_path):
    path = os.path.join(REPO, "BENCH_capacity_r01.json")
    rows = pkg.membership.load_capacity_rows(path)
    lines = tmp_path / f"{pkg.name}.jsonl"
    lines.write_text("\n".join(json.dumps(r) for r in [
        {"max_sessions_at_slo": 6, "chips": 4, "codec": "h264", "mix": "a"},
        {"max_sessions_at_slo": 3, "chips": 2, "codec": "h264", "mix": "b",
         "mode": "lockstep"},
        {"max_sessions_at_slo": 9, "chips": 8, "codec": "av1", "mix": "a"},
        {"noise": 1}]) + "\nnot json\n")
    rows2 = pkg.membership.load_capacity_rows(str(lines))
    missing = pkg.membership.load_capacity_rows(str(tmp_path / "absent.json"))
    ceilings = [pkg.membership.measured_max_sessions(r, chips=c, codecs=cs)
                for r in (rows, rows2) for c in (1, 2, 4, 8)
                for cs in (None, ["h264"], ["av1", "h264"], ["vp9"])]
    return rows, rows2, missing, ceilings


def test_capacity_rows_parse_like_jax(tmp_path):
    """The parser and the ceiling only: BENCH_capacity_r01.json is a TPU
    run, read here for parity, never for the port's routing."""
    got = both(_capacity_rows, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] and got["torch"][2] == [] and len(got["torch"][1]) == 3


def test_capacity_rows_from_env_match_jax(tmp_path, monkeypatch):
    path = tmp_path / "cap.jsonl"
    path.write_text(json.dumps({"max_sessions_at_slo": 5, "chips": 1, "codec": "h264"}))
    monkeypatch.setenv("SELKIES_CAPACITY_FILE", str(path))
    got = both(lambda pkg: (pkg.membership.capacity_rows_from_env(),
                            no_ts(pkg.membership.build_digest())["measured_max_sessions"]))
    assert got["torch"] == got["jax"] == ([{"max_sessions_at_slo": 5, "chips": 1,
                                            "codec": "h264"}], 5)


def test_env_readers_match_jax(monkeypatch):
    cases = [{}, {"SELKIES_CLUSTER_PEERS": " http://a:1/ , ,http://b:2",
                  "SELKIES_CLUSTER_SELF": "http://me:9/", "SELKIES_CLUSTER_HEARTBEAT_S": "0.01",
                  "SELKIES_CLUSTER_LEASE_S": "0.001", "SELKIES_CLUSTER_CLAIM_S": "0.1"},
             {"SELKIES_CLUSTER_HEARTBEAT_S": "x", "SELKIES_CLUSTER_LEASE_S": "y",
              "SELKIES_CLUSTER_CLAIM_S": "z"},
             {"SELKIES_CLUSTER_HEARTBEAT_S": "3", "SELKIES_CLUSTER_LEASE_S": "20"}]
    for env in cases:
        for k in CLUSTER_ENV:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got = both(lambda pkg: (
            pkg.membership.cluster_enabled(), pkg.membership.cluster_peers_from_env(),
            pkg.membership.cluster_self_from_env(), pkg.membership.heartbeat_interval_from_env(),
            pkg.membership.lease_from_env(pkg.membership.heartbeat_interval_from_env()),
            pkg.migrate.claim_window_from_env()))
        assert got["torch"] == got["jax"], env


async def _healthz(pkg):
    import aiohttp

    placer = pkg.lifecycle.SessionPlacer(devices=chips(2), bands=1, host_cores=8)
    placer.place_initial(2, 1)
    placer.set_busy(0, True)
    drainer = pkg.lifecycle.DrainController("digest-test", placer=placer, deadline_s=5.0)
    server = pkg.server.SignallingServer(pkg.server.SignallingOptions(addr="127.0.0.1", port=0))
    await server.start()
    out = []
    try:
        base = f"http://127.0.0.1:{server.bound_port}"
        async with aiohttp.ClientSession() as http:
            for _ in range(2):
                r = await http.get(base + "/healthz")
                body = await r.json()
                out.append((r.status, body["status"], no_ts(body["capacity"])))
                out.append(no_ts(pkg.tele.capacity_digest()))
                drainer.begin()
    finally:
        await server.stop()
        pkg.tele._lifecycle = None
    return out


def test_healthz_capacity_block_matches_jax():
    got = both(lambda pkg: run(_healthz(pkg)))
    assert got["torch"] == got["jax"]
    (status, state, cap), hb = got["torch"][:2]
    assert status == 200 and state == "ok" and cap == hb
    assert cap["has_placer"] and cap["sessions"] == 2 and cap["busy"] == 1
    assert cap["free_slots"] == 1 and not cap["draining"] and "h264" in cap["codecs"]
    assert got["torch"][2][0] == 503 and got["torch"][2][2]["draining"] is True
    assert got["torch"][3]["draining"] is True


def _plane_of(pkg, *, secret="k", fleet=None, peers=(), nodes=None):
    node = pkg.membership.ClusterNode(
        "http://a:1", list(peers), secret=secret, heartbeat_s=2.0, lease_s=6.0,
        transport=_loopback(nodes if nodes is not None else {}),
        digest_fn=lambda: pkg.membership.build_digest(codecs=["h264"]))
    target = None if fleet is None else pkg.migrate.MigrationTarget(
        fleet=fleet, secret=secret, advertise="http://a:1")
    return pkg.cluster.ClusterPlane(node=node, router=pkg.cluster.ClusterRouter(node),
                                    target=target)


async def _statz(pkg, monkeypatch):
    import aiohttp

    monkeypatch.setattr(pkg.migrate, "_stats", dict.fromkeys(pkg.migrate._stats, 0))
    server = pkg.server.SignallingServer(pkg.server.SignallingOptions(addr="127.0.0.1", port=0))
    nodes = {}
    plane = pkg.cluster.wire_cluster_plane(_plane_of(pkg, peers=["http://b:2"], nodes=nodes),
                                           server)
    peer = _mk_node(pkg, "http://b:2", ["http://a:1"], nodes, secret="k", lease_s=6.0)
    await server.start()
    pkg.tele.enable()
    try:
        base = f"http://127.0.0.1:{server.bound_port}"
        body, sig = peer.envelope()
        async with aiohttp.ClientSession() as http:
            r = await http.post(base + "/cluster/heartbeat", data=body,
                                headers={"x-selkies-cluster-sig": sig})
            bad = await http.post(base + "/cluster/heartbeat", data=body,
                                  headers={"x-selkies-cluster-sig": "00"})
            plane.router.route({"codecs": ["h264"]}, uid="1")
            statz = await (await http.get(base + "/statz")).json()
    finally:
        await server.stop()
    block = statz["providers"]["cluster"]
    for d in block["router"]["decisions"]:
        d.pop("ts")
    return r.status, bad.status, block


def test_statz_cluster_block_matches_jax(monkeypatch):
    import importlib.util

    got = both(lambda pkg: run(_statz(pkg, monkeypatch)))
    assert got["torch"] == got["jax"]
    ok, bad, block = got["torch"]
    assert (ok, bad) == (200, 403)
    assert block["membership"]["peers"]["http://b:2"]["alive"]
    assert block["router"]["decisions"] == [{"uid": "1", "to": "local", "reason": "local"}]
    spec = importlib.util.spec_from_file_location("statz", os.path.join(REPO, "tools",
                                                                        "statz.py"))
    statz = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(statz)
    out = statz.render({"enabled": True, "uptime_s": 1.0, "providers": {"cluster": block}}, [])
    assert "http://b:2" in out and "alive" in out


# -- membership ------------------------------------------------------------------------

def test_signatures_match_jax():
    for secret in ("", "s", "k" * 40):
        for body in ("", "body", json.dumps({"host": "http://a:1", "seq": 3})):
            sig = jmembership.sign_blob(secret, body)
            assert tmembership.sign_blob(secret, body) == sig
            for s in (sig, "", "00", jmembership.sign_blob(secret + "x", body)):
                assert tmembership.verify_blob(secret, body, s) == \
                    jmembership.verify_blob(secret, body, s)


@pytest.mark.parametrize("sender,receiver", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_heartbeats_cross_packages(sender, receiver):
    """A beat signed by one package's node is accepted by the other's, its
    digest stored as sent; the wrong secret is refused."""
    nodes = {}
    a = _mk_node(sender, "http://a:1", ["http://b:2"], nodes, secret="right",
                 digest=lambda: sender.membership.build_digest(codecs=["h264", "av1"]))
    b = _mk_node(receiver, "http://b:2", ["http://a:1"], nodes, secret="WRONG")
    run(a.heartbeat_once())
    assert b.alive_peers() == {} and a._peers["http://b:2"].failed == 1
    b.secret = "right"
    a._peers["http://b:2"].next_send = 0.0
    run(a.heartbeat_once())
    alive = b.alive_peers()
    assert list(alive) == ["http://a:1"] and alive["http://a:1"]["codecs"] == ["h264", "av1"]
    assert alive["http://a:1"]["host"] == "http://a:1"
    body, sig = a.envelope()
    assert b.receive(body, sig) and not b.receive(body, sig + "0")
    assert receiver.membership.verify_blob("right", body, sig)


def _lease_case(pkg):
    t = [0.0]
    nodes = {}
    a = _mk_node(pkg, "http://a:1", ["http://b:2"], nodes, clock=lambda: t[0], lease_s=0.2)
    b = _mk_node(pkg, "http://b:2", ["http://a:1"], nodes, clock=lambda: t[0], lease_s=0.2)
    out = []
    run(a.heartbeat_once())
    out.append(b.peer_alive("http://a:1"))
    t[0] += 0.3
    out += [b.peer_alive("http://a:1"), b.alive_peers()]
    run(a.heartbeat_once())
    out.append(b.peer_alive("http://a:1"))
    st = b.stats()
    out.append({u: {k: v for k, v in p.items()} for u, p in st["peers"].items()})
    return out


def _backoff_case(pkg):
    t = [0.0]
    calls = {"n": 0, "fail": True}

    async def flaky(peer, body, sig):
        calls["n"] += 1
        if calls["fail"]:
            raise ConnectionError("peer down")
        return True
    a = pkg.membership.ClusterNode(
        "http://a:1", ["http://b:2"], secret="", heartbeat_s=0.05, lease_s=0.2,
        transport=flaky, clock=lambda: t[0],
        digest_fn=lambda: pkg.membership.build_digest(codecs=["h264"]))
    st = a._peers["http://b:2"]
    out = []
    for _ in range(4):  # the capped backoff's delays
        run(a.heartbeat_once())
        out.append((calls["n"], st.failed, st.next_send))
        t[0] = st.next_send + 0.01
    run(a.heartbeat_once())
    out.append(calls["n"])
    calls["fail"] = False
    t[0] = st.next_send + 0.01
    run(a.heartbeat_once())
    out.append((calls["n"], st.ok, st.next_send, a.stats()["peers"]["http://b:2"]))
    return out


def _replay_case(pkg):
    t = [0.0]
    nodes = {}
    a = _mk_node(pkg, "http://a:1", ["http://b:2"], nodes, clock=lambda: t[0], lease_s=1.0)
    b = _mk_node(pkg, "http://b:2", ["http://a:1"], nodes, clock=lambda: t[0], lease_s=1.0)
    old = b.envelope()
    new = b.envelope()
    out = [a.receive(*new)]
    lease = a._peers["http://b:2"].lease_until
    t[0] += 0.5
    out.append(a.receive(*old))
    st = a._peers["http://b:2"]
    out.append((st.last_seq, st.lease_until == lease))
    t[0] += 1.0
    out.append(a.peer_alive("http://b:2"))
    a.receive(*old)
    out.append(a.peer_alive("http://b:2"))
    b2 = _mk_node(pkg, "http://b:2", ["http://a:1"], nodes, clock=lambda: t[0], lease_s=1.0)
    out.append(a.receive(*b2.envelope()))
    out.append((a.peer_alive("http://b:2"), st.last_seq))
    return out


def _bound_case(pkg):
    t = [0.0]
    node = pkg.membership.ClusterNode(
        "http://a:1", ["http://seed:2"], secret="k", heartbeat_s=0.05, lease_s=1.0,
        transport=_loopback({}), digest_fn=pkg.membership.build_digest, clock=lambda: t[0])

    def beat(host, seq=1):
        body = json.dumps({"host": host, "seq": seq, "boot": "b" + host,
                           "digest": {"free_slots": 1}}, sort_keys=True)
        return node.receive(body, pkg.membership.sign_blob("k", body))
    cap = pkg.membership.ClusterNode.MAX_TRACKED_PEERS
    admitted = [beat(f"http://stranger{i}:1") for i in range(cap + 10)]
    out = [admitted, sorted(node._peers)]
    t[0] += 2.0
    out += [beat("http://fresh:1"), sorted(node._peers), node.receive("{", "x"),
            node.receive("not json", pkg.membership.sign_blob("k", "not json")),
            beat("http://a:1")]
    return out


@pytest.mark.parametrize("case", [_lease_case, _backoff_case, _replay_case, _bound_case],
                         ids=["lease_expiry_rejoin", "capped_backoff", "replay_guard",
                              "peer_bound"])
def test_membership_matches_jax(case):
    got = both(case)
    assert got["torch"] == got["jax"]
    if case is _lease_case:
        assert got["torch"][:4] == [True, False, {}, True]
    elif case is _backoff_case:
        assert [g[1] for g in got["torch"][:4]] == [1, 2, 3, 4] and got["torch"][4] == 5
        assert got["torch"][5][1] == 1 and got["torch"][5][2] == 0.0
    elif case is _replay_case:
        assert got["torch"] == [True, True, (2, True), False, False, True, (True, 1)]
    else:
        cap = tmembership.ClusterNode.MAX_TRACKED_PEERS
        assert got["torch"][0].count(False) == 11 and len(got["torch"][1]) == cap
        assert got["torch"][2] and "http://seed:2" in got["torch"][3]


FAULT_CASES = {
    "heartbeat_drop": "cluster:heartbeat@1-2:drop",
    "heartbeat_raise": "cluster:heartbeat@1:raise",
    "partition": "cluster:partition@1:drop",
    "heartbeat_delay": "cluster:heartbeat@1:delay:5",
}


def _fault_case(pkg, spec):
    pkg.configure(spec)
    t = [0.0]
    nodes = {}
    a = _mk_node(pkg, "http://a:1", ["http://b:2"], nodes, clock=lambda: t[0])
    b = _mk_node(pkg, "http://b:2", ["http://a:1"], nodes, clock=lambda: t[0])
    out = []
    for _ in range(3):
        run(a.heartbeat_once())
        st = a._peers["http://b:2"]
        out.append((b.peer_alive("http://a:1"), st.sent, st.ok, st.failed, st.next_send))
        t[0] = max(t[0], st.next_send) + 0.01
    return out


@pytest.mark.parametrize("case", sorted(FAULT_CASES))
def test_membership_fault_sites_match_jax(case):
    got = both(_fault_case, FAULT_CASES[case])
    assert got["torch"] == got["jax"]
    if case == "heartbeat_drop":
        assert [g[0] for g in got["torch"]] == [False, False, True]
        assert got["torch"][1][3] == 0  # a lost beat is not a send failure
    elif case == "partition":
        assert got["torch"][0][:4] == (False, 1, 0, 1) and got["torch"][1][0]


def _ship_fault_case(pkg):
    pkg.configure("cluster:ship@1:raise;cluster:ship@2:drop")
    fa, fb = _fake_host(pkg, "a"), _fake_host(pkg, "b")
    fa.slots[0].connected = True
    fa.placer.set_busy(0, True)
    channel = pkg.migrate.LocalMigrationChannel()
    target = pkg.migrate.MigrationTarget(fleet=fb, advertise="http://b:2", claim_s=5)
    channel.register("http://b:2", target.handle)
    out = []
    for _ in range(3):
        try:
            ack = run(pkg.migrate.migrate_session(fa, 0, "http://b:2", channel))
            out.append(("ok", ack["session"], ack["host"]))
        except pkg.InjectedFault:
            out.append(("injected", len(fa.placer.row(0))))
        except pkg.migrate.MigrationError as exc:
            out.append(("refused", str(exc), len(fa.placer.row(0))))
    return out


def test_ship_fault_site_matches_jax():
    got = both(_ship_fault_case)
    assert got["torch"] == got["jax"]
    assert [g[0] for g in got["torch"]] == ["injected", "refused", "ok"]


async def _redirect_fault(pkg):
    import aiohttp

    pkg.configure("cluster:redirect@1:drop")
    server = pkg.server.SignallingServer(pkg.server.SignallingOptions(addr="127.0.0.1", port=0))
    server.cluster_router = SimpleNamespace(route=lambda meta, uid="": pkg.cluster.Redirect(
        host="http://b:2", reason="capacity", retry_after_s=0.05))
    await server.start()
    out = []
    meta = "eyJjb2RlY3MiOiBbImgyNjQiXX0="  # {"codecs": ["h264"]}
    try:
        async with aiohttp.ClientSession() as http:
            for _ in range(2):
                ws = await http.ws_connect(f"http://127.0.0.1:{server.bound_port}/ws")
                await ws.send_str(f"HELLO 1 {meta}")
                msg = await ws.receive()
                out.append((msg.type.name, msg.data if msg.type == aiohttp.WSMsgType.TEXT
                            else None))
                await ws.close()
    finally:
        await server.stop()
    return out


def test_redirect_fault_site_matches_jax():
    got = both(lambda pkg: run(_redirect_fault(pkg)))
    assert got["torch"] == got["jax"]
    assert got["torch"][0][0] != "TEXT" and got["torch"][1][1].startswith("REDIRECT ")


def test_cluster_fault_sites_documented():
    import selkies_tpu_torch.resilience.faultinject as fi

    for site in ("cluster:heartbeat", "cluster:partition", "cluster:ship", "cluster:redirect"):
        assert site in fi.__doc__


def test_cluster_telemetry_families_emitted():
    def case(pkg):
        pkg.tele.reset()
        pkg.tele.enabled = True
        try:
            nodes = {}
            a = _mk_node(pkg, "http://a:1", ["http://b:2"], nodes)
            _mk_node(pkg, "http://b:2", ["http://a:1"], nodes)
            run(a.heartbeat_once())
            return sorted({fam for fam, _ in list(pkg.tele._counters) + list(pkg.tele._gauges)})
        finally:
            pkg.tele.enabled = False
            pkg.tele.reset()
    got = both(case)
    assert got["torch"] == got["jax"]
    assert {"selkies_cluster_heartbeats_total", "selkies_cluster_peers"} <= set(got["torch"])


# -- the router ------------------------------------------------------------------------

def _digest(host, *, free=1, draining=False, chronic=(), quarantined=0, codecs=("h264",),
            **extra):
    return dict({"host": host, "has_placer": True, "shared": False, "draining": draining,
                 "free_slots": free, "chronic_burn": list(chronic),
                 "quarantined_chips": quarantined, "codecs": list(codecs)}, **extra)


class _StubNode:
    def __init__(self, local, peers):
        self.local, self.peers = local, peers

    def self_digest(self):
        return self.local

    def alive_peers(self):
        return self.peers


SOLO_BUSY = {"host": "s", "has_placer": False, "draining": False, "busy": 1,
             "codecs": ["h264"]}
PEERS = {
    "b": {"http://b:2": _digest("http://b:2", free=2)},
    "scored": {"http://burn:1": _digest("http://burn:1", free=3, chronic=["0", "1"]),
               "http://quar:2": _digest("http://quar:2", free=3, quarantined=2),
               "http://clean:3": _digest("http://clean:3", free=2)},
    "codecs": {"http://h264:1": _digest("http://h264:1", free=5),
               "http://av1:2": _digest("http://av1:2", free=1, codecs=["av1", "h264"])},
    "solo": {"http://solo:1": dict(_digest("http://solo:1", free=0), has_placer=False),
             "http://fleet:2": _digest("http://fleet:2", free=1)},
    "solo_only": {"http://solo:1": dict(_digest("http://solo:1", free=0), has_placer=False)},
    "solo_busy": {"http://s:1": dict(SOLO_BUSY)},
    "solo_free": {"http://s:1": dict(SOLO_BUSY, busy=0)},
    "measured": {"http://m:1": _digest("http://m:1", free=4, measured_max_sessions=3,
                                       sessions=3),
                 "http://n:2": _digest("http://n:2", free=4, measured_max_sessions=6,
                                       sessions=4),
                 "http://sh:3": _digest("http://sh:3", free=0, shared=True,
                                        measured_max_sessions=5, sessions=1)},
    "none": {},
}
LOCALS = {"free": _digest("a", free=1), "full": _digest("a", free=0),
          "draining": _digest("a", free=1, draining=True), "solo_busy": dict(SOLO_BUSY),
          "free3": _digest("a", free=3)}
METAS = [None, {}, {"codecs": ["h264"]}, {"codecs": ["av1", "h264"]}, {"codecs": ["vp9"]},
         {"codecs": ["AV1"]}]


def _routes(pkg):
    out = []
    for lname, local in sorted(LOCALS.items()):
        for pname, peers in sorted(PEERS.items()):
            r = pkg.cluster.ClusterRouter(_StubNode(local, peers),
                                          is_local_session=lambda uid: uid == "11")
            for meta in METAS:
                for uid in ("", "1", "11"):
                    rd = r.route(meta, uid=uid)
                    out.append((lname, pname, json.dumps(meta), uid,
                                None if rd is None else rd.to_wire()))
            for codec in ("h264", "av1", "vp9", ""):
                out.append((lname, pname, codec, r.pick_migration_target(codec)))
            st = r.stats()
            out.append((st["redirects"], [{k: v for k, v in d.items() if k != "ts"}
                                          for d in st["decisions"]]))
    for peers in PEERS.values():
        for d in peers.values():
            for prefs in ([], ["h264"], ["av1"]):
                out.append(pkg.cluster.ClusterRouter.score(d, prefs))
    return out


def test_router_decisions_and_scores_match_jax():
    got = both(_routes)
    assert got["torch"] == got["jax"]


def _router_checks(pkg):
    R = pkg.cluster.ClusterRouter
    out = {}
    out["local"] = R(_StubNode(LOCALS["free"], PEERS["b"])).route({"codecs": ["h264"]}, uid="1")
    out["drain"] = R(_StubNode(LOCALS["draining"], PEERS["b"])).route({"codecs": ["h264"]})
    out["full"] = R(_StubNode(LOCALS["full"], PEERS["b"])).route({"codecs": ["h264"]})
    out["scored"] = R(_StubNode(LOCALS["draining"], PEERS["scored"])).route(
        {"codecs": ["h264"]})
    out["av1_drain"] = R(_StubNode(LOCALS["draining"], PEERS["codecs"])).route(
        {"codecs": ["av1", "h264"]})
    out["av1_codec"] = R(_StubNode(LOCALS["free3"], PEERS["codecs"])).route(
        {"codecs": ["av1", "h264"]})
    out["migrate_solo"] = R(_StubNode(LOCALS["draining"], PEERS["solo"])).pick_migration_target()
    out["migrate_none"] = R(_StubNode(LOCALS["draining"],
                                      PEERS["solo_only"])).pick_migration_target()
    out["pinned"] = R(_StubNode(LOCALS["draining"], PEERS["b"]),
                      is_local_session=lambda uid: uid == "11").route({"codecs": ["h264"]},
                                                                      uid="11")
    out["solo_busy"] = R(_StubNode(LOCALS["solo_busy"], PEERS["b"])).route({"codecs": ["h264"]})
    out["to_solo_free"] = R(_StubNode(LOCALS["draining"], PEERS["solo_free"])).route(
        {"codecs": ["h264"]})
    return {k: (v if v is None or isinstance(v, str) else (v.host, v.reason))
            for k, v in out.items()}


def test_router_scenarios_match_jax():
    got = both(_router_checks)
    assert got["torch"] == got["jax"] == {
        "local": None, "drain": ("http://b:2", "draining"), "full": ("http://b:2", "capacity"),
        "scored": ("http://clean:3", "draining"), "av1_drain": ("http://av1:2", "draining"),
        "av1_codec": ("http://av1:2", "codec"), "migrate_solo": "http://fleet:2",
        "migrate_none": None, "pinned": None, "solo_busy": ("http://b:2", "capacity"),
        "to_solo_free": ("http://s:1", "draining")}


def test_redirect_wire_matches_jax():
    for rd in (jcluster.Redirect(host="http://b:2", reason="capacity", retry_after_s=1.5),
               jcluster.Redirect(host="http://b:2", reason="migrated", session=3)):
        wire = rd.to_wire()
        assert tcluster.Redirect(**vars(rd)).to_wire() == wire
        assert tcluster.parse_redirect(wire) == tcluster.Redirect(**vars(rd))
    assert tcluster.parse_redirect("REDIRECT !!!garbage") is None


def test_cluster_exports_every_jax_name():
    assert set(jcluster.__all__) <= set(tcluster.__all__)
    for mod_j, mod_t in ((jmembership, tmembership), (jmigrate, tmigrate),
                         (jcluster.router, tcluster.router)):
        assert set(mod_j.__all__) <= set(mod_t.__all__)
    assert "FleetOrchestrator" in tfleet.__all__


# -- the plane's wiring ------------------------------------------------------------------

class _Srv:
    def __init__(self):
        self.ws_routes, self.cluster_router = {}, None


def _wire_case(pkg):
    out = []
    for secret, basic, fleet in (("", True, True), ("k", True, True), ("", False, False),
                                 ("k", False, True)):
        srv = _Srv()
        plane = _plane_of(pkg, secret=secret,
                          fleet=_fake_host(pkg, "w") if fleet else None)
        wired = pkg.cluster.wire_cluster_plane(plane, srv, enable_basic_auth=basic)
        out.append((wired is plane, wired is None, sorted(srv.ws_routes),
                    srv.cluster_router is plane.router))
    return out


def test_wire_cluster_plane_matches_jax():
    got = both(_wire_case)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == (False, True, [], False)
    assert got["torch"][1] == (True, False, ["/cluster/heartbeat", "/cluster/migrate"], True)
    assert got["torch"][2] == (True, False, ["/cluster/heartbeat"], True)


def _build_plane_case(pkg, monkeypatch):
    monkeypatch.setenv("SELKIES_CLUSTER_PEERS", "http://b:2,http://a:1")
    monkeypatch.setenv("SELKIES_CLUSTER_SELF", "http://a:1")
    monkeypatch.setenv("SELKIES_CLUSTER_SECRET", "s")
    monkeypatch.setenv("SELKIES_CLUSTER_HEARTBEAT_S", "0.5")
    solo = pkg.cluster.build_cluster_plane(digest_fn=lambda: {"free_slots": 1})
    fleet = pkg.cluster.build_cluster_plane(fleet=_fake_host(pkg, "f"))
    return [(p.node.host, sorted(p.node._peers), p.node.secret, p.node.heartbeat_s,
             p.node.lease_s, p.target is None, p.channel is None,
             None if p.target is None else (p.target.advertise, p.target.secret,
                                            p.target.claim_s))
            for p in (solo, fleet)] + [solo.node.self_digest()]


def test_build_cluster_plane_matches_jax(monkeypatch):
    got = both(_build_plane_case, monkeypatch)
    assert got["torch"] == got["jax"]
    assert got["torch"][0][1] == ["http://b:2"] and got["torch"][1][5:7] == (False, False)


# -- migration over fake fleets ----------------------------------------------------------

class _FakeSessionState:
    def __init__(self):
        self.frames_since_idr, self.idr_pic_id, self.force_idr, self.qp = 4, 1, False, 30


class _FakeService:
    def __init__(self, n):
        self.n = n
        self.sessions = [_FakeSessionState() for _ in range(n)]
        self.params = SimpleNamespace(width=W, height=H, fps=30)
        self.last_idrs = [True] * n

    def set_qp(self, k, qp):
        self.sessions[k].qp = qp

    def force_keyframe(self, k):
        self.sessions[k].force_idr = True

    def encode_tick(self, frames):
        self.last_idrs = [s.force_idr for s in self.sessions]
        for s in self.sessions:
            s.force_idr = False
        return [b"\x00" for _ in range(self.n)]

    def close(self):
        pass


def _fake_host(pkg, tag, n=2):
    slots = [pkg.fleet.SessionSlot(k, bitrate_kbps=2000, fps=60) for k in range(n)]
    kw = {} if pkg is JAX else {"devices": [CPU]}
    fleet = pkg.fleet.SessionFleet(slots, width=W, height=H, fps=60,
                                   service=_FakeService(n), **kw)
    fleet.placer = pkg.lifecycle.SessionPlacer(devices=chips(n, tag), bands=1, host_cores=8)
    fleet.placer.place_initial(n, 1)
    return fleet


def _fake_state(fleet):
    return [(s.qp, s.idr_pic_id, s.frames_since_idr, s.force_idr)
            for s in fleet.service.sessions], [len(fleet.placer.row(k))
                                               for k in range(len(fleet.slots))]


def _migrate_case(pkg):
    fa, fb = _fake_host(pkg, "a"), _fake_host(pkg, "b")
    fa.slots[0].connected = True
    fa.placer.set_busy(0, True)
    fa.service.sessions[0].qp = 37
    channel = pkg.migrate.LocalMigrationChannel()
    target = pkg.migrate.MigrationTarget(fleet=fb, advertise="http://b:2", claim_s=5)
    channel.register("http://b:2", target.handle)
    ack = run(pkg.migrate.migrate_session(fa, 0, "http://b:2", channel, source="http://a:1"))
    fa.placer.assert_consistent()
    fb.placer.assert_consistent()
    return ack, sorted(target.pending_claims), _fake_state(fa), _fake_state(fb)


def _restore_slot_case(pkg):
    ck = pkg.lifecycle.SessionCheckpoint(session=1, qp=33)
    out = []
    for occupied in (False, True):
        fb = _fake_host(pkg, "b")
        fb.slots[1].connected = occupied
        target = pkg.migrate.MigrationTarget(fleet=fb, advertise="http://b:2", claim_s=30)
        out.append((target.handle({"checkpoint": ck.to_json(), "source": "a"}),
                    _fake_state(fb)))
    return out


def _failed_restore_case(pkg):
    pkg.configure("migrate:0@1:raise")
    fb = _fake_host(pkg, "b")
    target = pkg.migrate.MigrationTarget(fleet=fb, advertise="http://b:2", claim_s=30)
    ck = pkg.lifecycle.SessionCheckpoint(session=0, qp=30)
    first = target.handle({"checkpoint": ck.to_json(), "source": "a"})
    out = [first["ok"], "migrate:0" in first["error"], sorted(target.pending_claims),
           _fake_state(fb)]
    fb.placer.assert_consistent()
    out += [target.handle({"checkpoint": ck.to_json(), "source": "a"}), _fake_state(fb)]
    return out


def _claim_case(pkg):
    t = [100.0]
    fb = _fake_host(pkg, "b")
    target = pkg.migrate.MigrationTarget(fleet=fb, advertise="http://b:2", claim_s=1.0,
                                         clock=lambda: t[0])
    ck = pkg.lifecycle.SessionCheckpoint(session=0, qp=30)
    out = [target.handle({"checkpoint": ck.to_json(), "source": "a"})]
    t[0] += 0.5
    out.append(target.expire_claims())
    t[0] += 1.0
    out += [target.expire_claims(), _fake_state(fb)]
    ack = target.handle({"checkpoint": ck.to_json(), "source": "a"})
    fb.slots[ack["session"]].connected = True
    t[0] += 5.0
    out += [ack, target.expire_claims(), sorted(target.pending_claims), _fake_state(fb)]
    fb.placer.assert_consistent()
    return out


def _nonce_case(pkg):
    fb = _fake_host(pkg, "r")
    target = pkg.migrate.MigrationTarget(fleet=fb, advertise="http://b:2", claim_s=30)
    payload = {"checkpoint": pkg.lifecycle.SessionCheckpoint(session=0, qp=30).to_json(),
               "source": "a", "nonce": "deadbeef"}
    out = [target.handle(dict(payload)), target.handle(dict(payload)),
           target.handle(dict(payload, nonce="cafebabe")), target.handle({"nonce": "x"})]
    out[-1] = (out[-1]["ok"], "KeyError" in out[-1]["error"])
    sent = {}

    class _Chan:
        async def send(self, host, payload):
            sent.update(payload)
            return {"ok": True, "session": 0, "host": host}
    fa = _fake_host(pkg, "s")
    fa.slots[0].connected = True
    fa.placer.set_busy(0, True)
    run(pkg.migrate.migrate_session(fa, 0, "http://b:2", _Chan(), source="a"))
    ck = json.loads(sent["checkpoint"])
    ck.pop("wall_time")
    return out, len(sent["nonce"]), sent["source"], ck


def _local_session_case(pkg):
    fb = _fake_host(pkg, "p")
    target = pkg.migrate.MigrationTarget(fleet=fb, advertise="http://b:2", claim_s=30)
    target.handle({"checkpoint": pkg.lifecycle.SessionCheckpoint(session=1, qp=30).to_json(),
                   "source": "a"})
    fn = pkg.fleet.FleetOrchestrator._cluster_local_session
    stub = SimpleNamespace(n=2, slots=fb.slots, cluster=SimpleNamespace(target=target))
    out = [fn(stub, uid) for uid in ("11", "1", "12", "x", "21")]
    fb.slots[1].connected = True
    target.expire_claims()
    out.append(fn(stub, "11"))
    stub.cluster = None
    out.append(fn(stub, "1"))
    return out


@pytest.mark.parametrize("case", [_migrate_case, _restore_slot_case, _failed_restore_case,
                                  _claim_case, _nonce_case, _local_session_case],
                         ids=["moves_state_frees_source", "restore_prefers_checkpoint_slot",
                              "failed_restore_releases", "unclaimed_slot_expires",
                              "replayed_nonce_refused", "pending_claims_pinned"])
def test_migration_matches_jax(case):
    got = both(case)
    assert got["torch"] == got["jax"]
    if case is _migrate_case:
        ack, claims, a_state, b_state = got["torch"]
        assert ack["ok"] and ack["host"] == "http://b:2" and claims == [ack["session"]]
        assert b_state[0][ack["session"]][0] == 37 and b_state[0][ack["session"]][3]
        assert a_state[1][0] == 0
    elif case is _restore_slot_case:
        assert [r[0]["session"] for r in got["torch"]] == [1, 0]
    elif case is _failed_restore_case:
        assert got["torch"][:3] == [False, True, []] and got["torch"][3][1][0] == 0
        assert got["torch"][4]["ok"] and got["torch"][4]["session"] == 0
    elif case is _claim_case:
        assert got["torch"][1] == [] and got["torch"][2] == [0] and got["torch"][6] == []
    elif case is _nonce_case:
        acks = got["torch"][0]
        assert acks[0]["ok"] and not acks[1]["ok"] and "replay" in acks[1]["error"]
        assert acks[2]["ok"] and got["torch"][1] == 32
    else:
        assert got["torch"] == [True, False, False, False, False, True, False]


def _chaos_case(pkg):
    """tests/test_cluster.py's seeded chaos over three hosts: heartbeat
    drops, mid-migration kills and a drain under partition -> the trace of
    every host's connected slots and where each logical session lives."""
    pkg.configure("cluster:heartbeat@3,7,11,15:drop;cluster:ship@2,5:raise;"
                  "cluster:partition@9-12:drop")
    hosts = ["http://a:1", "http://b:2", "http://c:3"]
    fleets = {h: _fake_host(pkg, t) for h, t in zip(hosts, "abc")}
    nodes = {}
    for h in hosts:
        _mk_node(pkg, h, [p for p in hosts if p != h], nodes,
                 digest=lambda h=h: pkg.membership.build_digest(placer=fleets[h].placer,
                                                                 codecs=["h264"]),
                 lease_s=10.0)
    routers = {h: pkg.cluster.ClusterRouter(nodes[h]) for h in hosts}
    channel = pkg.migrate.LocalMigrationChannel()
    targets = {h: pkg.migrate.MigrationTarget(fleet=fleets[h], advertise=h, claim_s=30)
               for h in hosts}
    for h in hosts:
        channel.register(h, targets[h].handle)
    loc = {}
    for lg, k in (("L0", 0), ("L1", 1)):
        fleets[hosts[0]].slots[k].connected = True
        fleets[hosts[0]].placer.set_busy(k, True)
        loc[lg] = (hosts[0], k)
    trace = []

    def snapshot(step):
        for h in hosts:
            fleets[h].placer.assert_consistent()
        connected = sorted((hh, kk) for hh in hosts
                           for kk, slot in enumerate(fleets[hh].slots) if slot.connected)
        assert connected == sorted(loc.values()), step
        trace.append((step, connected, dict(loc)))

    async def scenario():
        rng = np.random.default_rng(7)
        for step in range(40):
            op = int(rng.integers(0, 3))
            if op == 0:
                for h in hosts:
                    await nodes[h].heartbeat_once()
            elif op == 1:
                lg = ["L0", "L1"][int(rng.integers(0, 2))]
                src, k = loc[lg]
                dst = hosts[int(rng.integers(0, 3))]
                if dst == src:
                    continue
                try:
                    ack = await pkg.migrate.migrate_session(fleets[src], k, dst, channel,
                                                            source=src)
                except (pkg.InjectedFault, pkg.migrate.MigrationError):
                    trace.append((step, "ship failed"))
                else:
                    k2 = ack["session"]
                    fleets[src].slots[k].connected = False
                    fleets[dst].slots[k2].connected = True
                    targets[dst].pending_claims.pop(k2, None)
                    loc[lg] = (dst, k2)
            else:
                h = hosts[int(rng.integers(0, 3))]
                rd = routers[h].route({"codecs": ["h264"]}, uid="1")
                trace.append((step, h, None if rd is None else rd.to_wire()))
            snapshot(step)
        trace.append(("pick", routers[hosts[0]].pick_migration_target()))
    run(scenario())
    return trace


def test_cluster_chaos_matches_jax():
    got = both(_chaos_case)
    assert got["torch"] == got["jax"]
    assert any(t[1] == "ship failed" for t in got["torch"] if len(t) == 2)


# -- the live migration with real encoders ----------------------------------------------

def _frames(n=6):
    rng = np.random.default_rng(3)
    return [rng.integers(0, 255, (2, H, W, 4), np.uint8) for _ in range(n)]


def _sha(au) -> str:
    return hashlib.sha256(bytes(au)).hexdigest()


def _port_host():
    slots = [tfleet.SessionSlot(k, bitrate_kbps=2000, fps=30) for k in range(2)]
    svc = TorchMultiSessionH264Service(2, W, H, qp=28, fps=30, device=CPU)
    return tfleet.SessionFleet(slots, width=W, height=H, fps=30, service=svc, devices=[CPU])


def _jax_host(devices):
    slots = [jfleet.SessionSlot(k, bitrate_kbps=2000, fps=30) for k in range(2)]
    svc = MultiSessionH264Service(2, W, H, qp=28, fps=30, devices=devices)
    return jfleet.SessionFleet(slots, width=W, height=H, fps=30, service=svc, devices=devices)


async def _start_server(router=None):
    server = tserver.SignallingServer(tserver.SignallingOptions(addr="127.0.0.1", port=0))
    server.cluster_router = router
    await server.start()
    return server


def test_drain_migrates_session_across_port_hosts_byte_identical():
    """Two port hosts with real encoders and real signalling servers: a
    client is admitted on A, A drains, the session moves to B over
    LocalMigrationChannel, the client follows the redirect, and B's first
    AU after the restore is the recovery IDR, sha256-equal to JAX's
    uninterrupted single-host oracle, as is the P frame after it."""
    frames = _frames()
    devs = jax.devices()

    async def scenario():
        fleet_a, fleet_b = _port_host(), _port_host()
        oracle = MultiSessionH264Service(2, W, H, qp=28, fps=30, devices=devs[4:6])
        server_a, server_b = await _start_server(), await _start_server()
        host_a = f"http://127.0.0.1:{server_a.bound_port}"
        host_b = f"http://127.0.0.1:{server_b.bound_port}"
        nodes = {}
        node_a = _mk_node(PORT, host_a, [host_b], nodes, lease_s=30.0,
                          digest=lambda: tmembership.build_digest(
                              drain=drainer, placer=fleet_a.placer, codecs=["h264"]))
        node_b = _mk_node(PORT, host_b, [host_a], nodes, lease_s=30.0,
                          digest=lambda: tmembership.build_digest(
                              placer=fleet_b.placer, codecs=["h264"]))
        router_a = tcluster.ClusterRouter(node_a)
        server_a.cluster_router = router_a
        channel = tcluster.LocalMigrationChannel()
        target_b = tcluster.MigrationTarget(fleet=fleet_b, advertise=host_b, claim_s=30)
        channel.register(host_b, target_b.handle)

        async def migrate_off():
            moved = []
            for k, slot in enumerate(fleet_a.slots):
                if not slot.connected:
                    continue
                dst = router_a.pick_migration_target()
                if dst is None:
                    continue
                await tcluster.migrate_session(fleet_a, k, dst, channel, source=host_a)
                await server_a.redirect_peer("1", tcluster.Redirect(
                    host=dst, reason="migrated", retry_after_s=0.05))
                slot.connected = False
                moved.append(k)
            return moved
        drainer = tlifecycle.DrainController("e2e-a", placer=fleet_a.placer, deadline_s=30.0,
                                             force_idr=lambda: None, migrate=migrate_off,
                                             handoff=fleet_a.checkpoint_all)
        client = tclient.SignallingClient(tcluster.ws_url_of(host_a), id=1, peer_id=2,
                                          meta={"codecs": ["h264"]})
        task = asyncio.get_running_loop().create_task(
            tclient.run_reconnect_loop(client, "browser"))
        try:
            for _ in range(200):
                if "1" in server_a.peers:
                    break
                await asyncio.sleep(0.02)
            assert "1" in server_a.peers
            assert fleet_a.admit_client(0).accepted
            fleet_a.slots[0].connected = True
            for t in range(3):
                got = fleet_a.service.encode_tick(frames[t])
                want = oracle.encode_tick(frames[t])
                assert [_sha(a) for a in got] == [_sha(b) for b in want]
            await node_b.heartbeat_once()
            assert node_a.peer_alive(host_b)
            assert await asyncio.wait_for(drainer.drain(), 60)
            assert drainer.migrated == [0] and fleet_a.placer.row(0) == []
            fleet_a.placer.assert_consistent()
            fleet_b.placer.assert_consistent()
            for _ in range(400):
                if "1" in server_b.peers:
                    break
                await asyncio.sleep(0.02)
            assert "1" in server_b.peers and client.server == tcluster.ws_url_of(host_b)
            k2 = next(iter(target_b.pending_claims))
            fleet_b.slots[k2].connected = True
            target_b.expire_claims()
            assert k2 not in target_b.pending_claims
            oracle.force_keyframe(0)
            for t in (3, 4):
                got = fleet_b.service.encode_tick(frames[t])
                want = oracle.encode_tick(frames[t])
                assert fleet_b.service.last_idrs[k2] == (t == 3)
                assert _sha(got[k2]) == _sha(want[0]), t
            fleet_b.placer.assert_consistent()
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            await client.stop()
            await server_a.stop()
            await server_b.stop()
            for s in (fleet_a.service, fleet_b.service, oracle):
                s.close()
    run(scenario())


@pytest.mark.parametrize("src,dst", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_migration_across_packages_restores_to_the_oracle(src, dst):
    """A host of one package ships a live session's checkpoint to a host of
    the other through that host's MigrationTarget.handle; the landing
    session's recovery IDR and the P frames after it equal the target
    package's own uninterrupted oracle. The checkpoint JSON is the only
    state that crosses."""
    frames = _frames()
    devs = jax.devices()

    def host(pkg, devices):
        return _jax_host(devices) if pkg is JAX else _port_host()

    def service(pkg, devices):
        return (MultiSessionH264Service(2, W, H, qp=28, fps=30, devices=devices)
                if pkg is JAX else TorchMultiSessionH264Service(2, W, H, qp=28, fps=30,
                                                                device=CPU))
    fa, fb = host(src, devs[:2]), host(dst, devs[2:4])
    oracle = service(dst, devs[4:6])
    shipped = []

    class _Chan:  # what crosses: the signed payload's JSON, nothing else
        async def send(self, host_, payload):
            shipped.append(json.dumps(payload, sort_keys=True))
            return target.handle(json.loads(shipped[-1]))
    target = dst.migrate.MigrationTarget(fleet=fb, advertise="http://b:2", claim_s=30)
    try:
        assert fa.admit_client(1).accepted
        fa.slots[1].connected = True
        fa.service.set_qp(1, 31)
        oracle.set_qp(1, 31)
        for t in range(3):
            got = fa.service.encode_tick(frames[t])
            want = oracle.encode_tick(frames[t])
            assert _sha(got[1]) == _sha(want[1])
        ack = run(src.migrate.migrate_session(fa, 1, "http://b:2", _Chan(), source="http://a:1"))
        assert ack["ok"] and ack["session"] == 1 and fa.placer.row(1) == []
        ck = json.loads(json.loads(shipped[0])["checkpoint"])
        assert ck["session"] == 1 and ck["qp"] == 31 and ck["frames_since_idr"] > 0
        fb.slots[1].connected = True
        target.expire_claims()
        oracle.force_keyframe(1)
        for t in (3, 4, 5):
            got = fb.service.encode_tick(frames[t])
            want = oracle.encode_tick(frames[t])
            assert bool(fb.service.last_idrs[1]) == bool(oracle.last_idrs[1]) == (t == 3)
            assert _sha(got[1]) == _sha(want[1]), t
    finally:
        for s in (fa.service, fb.service, oracle):
            s.close()
