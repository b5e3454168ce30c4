"""The port's fleet tier (serve/fleet.py, serve/router.py) on the CPU, held
against the JAX package's (tests/test_fleet.py):

* placement — the port's Router and the JAX package's, each over a fake
  two-replica fleet whose forward records placements, driven through the
  same submits, deaths and refusals: the same placements, counters and
  replies;
* the in-process router over two replicas — two ServeServers of this
  process on tcp, supervised through a stand-in process handle; one
  replica dies with a job admitted and unretired, the router requeues it
  to the survivor, every output equals the JAX package's `molecular
  --batching sequential` bytes and the counters reconcile (jobs_routed ==
  admissions over the replicas); `submit --wait` through a RouterServer;
* the spawn — a replica is `python -m bsseqconsensusreads_tpu_torch serve`
  with the replica id, the shared BSSEQ_TPU_COMPILE_CACHE_DIR and a
  first-life failpoint schedule in its environment;
* (slow, as the JAX package marks its fleet processes) `route --replicas
  2 --device cpu` with r0 armed to exit at its second batch: the job is
  requeued, the bytes are the JAX package's.

Tolerance: equality (placements, counters, replies, SHA-256 of BAMs).
"""

import os
import subprocess
import sys
import time

import pytest

from bsseqconsensusreads_tpu.serve import router as jrouter_mod
from bsseqconsensusreads_tpu_torch import cli
from bsseqconsensusreads_tpu_torch.serve import ServeEngine, ServeServer
from bsseqconsensusreads_tpu_torch.serve import fleet as fleet_mod
from bsseqconsensusreads_tpu_torch.serve import router as router_mod
from bsseqconsensusreads_tpu_torch.serve import transport
from test_torch_serve import _reference_natives, grouped_bam, jax_standalone, sha  # noqa: F401
from test_torch_transport_serve import serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# placement over a fake fleet, both packages


class _FakeReplica:
    def __init__(self, rid: str):
        self.rid = rid
        self.address = f"tcp:127.0.0.1:1{rid[1:]}"
        self.proc = None
        self.generation = 0
        self.up = True

    @property
    def supervised(self) -> bool:
        return True

    def alive(self) -> bool:
        return self.up


class _FakeFleet:
    def __init__(self, n: int = 2):
        self.replicas = [_FakeReplica(f"r{i}") for i in range(n)]
        self.restarted: list[str] = []

    def alive(self):
        return [r for r in self.replicas if r.alive()]

    def lookup(self, rid):
        return next((r for r in self.replicas if r.rid == rid), None)

    def restart(self, replica):
        self.restarted.append(replica.rid)
        replica.generation += 1
        replica.up = True


def _routed(module, monkeypatch, inputs):
    """A Router of `module` over a fake fleet whose forward records
    (replica, input) placements instead of opening sockets."""
    placements: list[tuple[str, str]] = []
    seq = {"n": 0}
    fleet = _FakeFleet(2)

    def fake_request(address, payload, timeout=0.0):
        if payload.get("op") == "submit":
            seq["n"] += 1
            rid = next(r.rid for r in fleet.replicas if r.address == address)
            placements.append((rid, payload["spec"]["input"]))
            return {"ok": True, "job": {"id": f"j{seq['n']:04d}", "state": "queued"}}
        return {"ok": True, "stats": {"jobs": [], "counters": {}}}

    monkeypatch.setattr(module._transport, "request", fake_request)
    return module.Router(replicas=fleet), fleet, placements


def _scenario(name, router, fleet, placements, inputs):
    """Drive one placement scenario; returns what the JAX test asserts on."""
    replies = []
    if name == "affinity":
        for _ in range(3):
            replies.append(router.submit({"input": inputs[0], "output": "a"})["ok"])
        replies.append(router.submit({"input": inputs[1], "output": "b"})["ok"])
    elif name == "no-affinity":
        router.affinity_enabled = False
        for _ in range(2):
            replies.append(router.submit({"input": inputs[0], "output": "a"})["ok"])
    elif name == "death":
        for _ in range(2):
            replies.append(router.submit({"input": inputs[0], "output": "a"})["ok"])
        dead = fleet.lookup(placements[0][0])
        dead.up = False
        router._handle_death(dead)
        replies.append(sorted((j.replica_id, j.requeues) for j in router._jobs.values()))
        replies.append(fleet.restarted)
    elif name == "no-live":
        for r in fleet.replicas:
            r.up = False
        replies.append(router.submit({"input": inputs[0], "output": "a"}))
    elif name == "preempt":
        for k in range(3):
            replies.append(router.submit({"input": inputs[k % 2], "output": "a"})["ok"])
        fleet.replicas[0].proc = None
        replies.append(router.preempt_replica("r9"))
    return {"placements": placements, "counters": dict(router.counters), "replies": replies,
            "affinity": sorted(router._affinity.values())}


@pytest.mark.parametrize("scenario", ["affinity", "no-affinity", "death", "no-live", "preempt"])
def test_placement_equals_the_jax_routers(scenario, monkeypatch, tmp_path):
    inputs = []
    for k in range(2):
        p = tmp_path / f"in{k}.bin"
        p.write_bytes(bytes([k]) * 64)
        inputs.append(str(p))
    got = _scenario(scenario, *_routed(router_mod, monkeypatch, inputs), inputs)
    want = _scenario(scenario, *_routed(jrouter_mod, monkeypatch, inputs), inputs)
    assert got == want
    if scenario == "death":
        assert got["counters"]["jobs_requeued"] == 2 and got["counters"]["replica_restarts"] == 1


def test_router_server_answers_ping_and_unknown_op(monkeypatch, tmp_path):
    router, _fleet, _p = _routed(router_mod, monkeypatch, [])
    srv = router_mod.RouterServer(router, addresses=["tcp:127.0.0.1:0"])
    assert srv._dispatch({"op": "ping"}) == {"ok": True, "pong": True, "router": True}
    resp = srv._dispatch({"op": "frobnicate"})
    assert resp["ok"] is False and "unknown op" in resp["error"]
    assert srv._dispatch({"op": "status", "job": "f9"})["ok"] is False


# ---------------------------------------------------------------------------
# the in-process router over two replicas


class _Handle:
    """A stand-in child-process handle for an in-process replica: alive
    until `kill`, when its server stops answering."""

    def __init__(self, server):
        self.server = server
        self.returncode = None
        self.pid = os.getpid()

    def poll(self):
        return self.returncode

    def kill(self):
        self.server.request_drain()
        self.returncode = -9

    terminate = kill

    def wait(self, timeout=None):
        return self.returncode


@pytest.fixture(scope="module")
def tenants(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet_tenants")
    inputs = [grouped_bam(str(d / f"in{k}.bam"), seed=300 + k) for k in range(3)]
    refs = [jax_standalone(p, str(d / f"ref{k}.bam")) for k, p in enumerate(inputs)]
    return inputs, refs


def test_router_requeues_a_dead_replicas_job(tenants, tmp_path, capsys):
    """r0's engine never starts (a replica that dies before it retires),
    r1 serves. The job placed on r0 is requeued to r1 when r0 dies; the
    router's wait parks across the death; every output is the JAX
    package's; jobs_routed == admissions over both replicas."""
    inputs, refs = tenants
    engines = [ServeEngine(device="cpu", batch_families=4), ServeEngine(device="cpu",
                                                                        batch_families=4)]
    engines[1].start()
    servers = [ServeServer(e, addresses=["tcp:127.0.0.1:0"]) for e in engines]
    threads = [serving(s) for s in servers]
    fleet = fleet_mod.ReplicaSet(attach_addresses=[s.bound[0] for s in servers])
    for replica, srv in zip(fleet.replicas, servers):
        replica.proc = _Handle(srv)
    router = router_mod.Router(fleet, respawn=False, monitor_interval=0.05)
    front = router_mod.RouterServer(router, addresses=["tcp:127.0.0.1:0"])
    try:
        router.launch(ready_timeout=30)
        t_front = serving(front)
        outs = [str(tmp_path / f"out{k}.bam") for k in range(3)]
        first = router.submit({"input": inputs[0], "output": outs[0]})
        assert first["ok"] and first["job"]["replica"] == "r0"
        second = router.submit({"input": inputs[1], "output": outs[1]})
        assert second["ok"] and second["job"]["replica"] == "r1"
        fleet.replicas[0].proc.kill()
        for rid in (first["job"]["id"], second["job"]["id"]):
            assert router.wait_job(rid, timeout=60)["state"] == "done"
        assert cli.main(["submit", "--socket", front.bound[0], "-i", inputs[2], "-o", outs[2],
                         "--wait", "--timeout", "60"]) == 0
        capsys.readouterr()
        assert [sha(o) for o in outs] == refs
        c = router.counters
        assert (c["jobs_requeued"], c["jobs_routed"], c["replica_restarts"]) == (1, 4, 0)
        admitted = len(engines[0].queue.jobs()) + len(engines[1].queue.jobs())
        assert admitted == c["jobs_routed"]
        snap = router.job_status(first["job"]["id"])
        assert snap["replica"] == "r1" and snap["requeues"] == 1
        stats = transport.request(front.bound[0], {"op": "fleet"})["stats"]
        assert stats["replicas"]["r0"]["alive"] is False
        assert stats["replicas"]["r1"]["counters"]["serve_batches"] > 0
        assert router.drain(timeout=30)
        front.request_drain()
        t_front.join(timeout=30)
    finally:
        router._stop.set()
        for srv in servers:
            srv.request_drain()
        for t in threads:
            t.join(timeout=30)
        for e in engines:
            e.stop(timeout=30)


def test_spawned_replica_is_the_ports_serve(monkeypatch, tmp_path):
    """The spawn command and environment, with no process started."""
    seen = []

    class _Popen:
        def __init__(self, cmd, env=None, **kw):
            seen.append((cmd, env))
            self.pid = 1

        def poll(self):
            return None

    monkeypatch.setattr(fleet_mod.subprocess, "Popen", _Popen)
    rs = fleet_mod.ReplicaSet(n=2, rundir=str(tmp_path), serve_args=["--device", "cpu"],
                              compile_cache_dir=str(tmp_path / "cache"),
                              fail_once={"r0": "fleet_replica_exit=exit:9@batch=2"})
    rs.launch()
    (cmd0, env0), (cmd1, env1) = seen
    assert cmd0[:4] == [sys.executable, "-m", "bsseqconsensusreads_tpu_torch", "serve"]
    assert cmd0[-2:] == ["--device", "cpu"] and "--ready-file" in cmd0
    assert env0["BSSEQ_TPU_REPLICA_ID"] == "r0" and env1["BSSEQ_TPU_REPLICA_ID"] == "r1"
    assert env0["BSSEQ_TPU_COMPILE_CACHE_DIR"] == env1["BSSEQ_TPU_COMPILE_CACHE_DIR"]
    assert env0["BSSEQ_TPU_FAILPOINTS"] == "fleet_replica_exit=exit:9@batch=2"
    assert "BSSEQ_TPU_FAILPOINTS" not in env1 or env1["BSSEQ_TPU_FAILPOINTS"] != \
        env0["BSSEQ_TPU_FAILPOINTS"]
    assert REPO in env0["PYTHONPATH"].split(os.pathsep)


@pytest.mark.slow
def test_route_replica_kill_requeues_byte_identical(tenants, tmp_path):
    """`route --replicas 2 --device cpu`, r0 armed to exit at its second
    retired batch: its job is requeued, every output is the JAX
    package's, and the respawned r0 rejoins."""
    inputs, refs = tenants
    ready = str(tmp_path / "router.addr")
    env = dict(os.environ, PYTHONPATH=REPO, BSSEQ_TPU_COMPILE_CACHE_DIR=str(tmp_path / "cache"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "bsseqconsensusreads_tpu_torch", "route", "--replicas", "2",
         "--device", "cpu", "--batch-families", "2", "--address", "tcp:127.0.0.1:0",
         "--ready-file", ready, "--rundir", str(tmp_path / "run"),
         "--replica-failpoints", "r0:fleet_replica_exit=exit:9@batch=2"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(ready):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.1)
        addr = open(ready).read().split()[0]
        outs = [str(tmp_path / f"o{k}.bam") for k in range(3)]
        ids = []
        for src, out in zip(inputs, outs):
            resp = transport.request(addr, {"op": "submit", "spec": {"input": src, "output": out}})
            assert resp["ok"], resp
            ids.append(resp["job"]["id"])
        for rid in ids:
            assert transport.request(addr, {"op": "wait", "job": rid, "timeout": 120},
                                     timeout=150)["job"]["state"] == "done"
        counters = transport.request(addr, {"op": "fleet"})["stats"]["counters"]
        assert counters["jobs_requeued"] >= 1
        assert [sha(o) for o in outs] == refs
        transport.request(addr, {"op": "drain", "timeout": 120}, timeout=150)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
