"""The port's wire-fault shim (faults/netchaos.py) on the CPU, held against
the JAX package's (tests/test_netchaos.py grammar and refusal matrix):

* the WirePlans the port folds for a schedule equal the JAX package's for
  the same schedule, evaluated at the same sites and peers in the same
  order (the seeded `p=` schedules too); `mangle` writes the same bytes,
  and both packages' decoders refuse them (bad_json);
* the refusal matrix against the port's protocol server over tcp, with the
  port's client: partition refuses and heals, drop kills one delivery,
  dup is answered from the reply cache with no second dispatch (and
  ledgered `frame_dup_ignored`), corrupt is refused as bad_json in either
  direction, half_open is bounded by the client's timeout, an accept drop
  answers nothing, delay slows but delivers.

Tolerance: equality (plans field by field, bytes, dispatch counts).
"""

import dataclasses
import json
import threading
import time

import pytest

from bsseqconsensusreads_tpu.faults import failpoints as jfailpoints
from bsseqconsensusreads_tpu.faults import netchaos as jnetchaos
from bsseqconsensusreads_tpu.serve import transport as jtransport
from bsseqconsensusreads_tpu_torch.faults import failpoints, netchaos
from bsseqconsensusreads_tpu_torch.serve import transport
from bsseqconsensusreads_tpu_torch.serve.server import ProtocolServer
from bsseqconsensusreads_tpu_torch.utils import observe


@pytest.fixture(autouse=True)
def _clean_slate():
    yield
    failpoints.disarm()
    jfailpoints.disarm()


SCHEDULES = [
    "net_send=delay:0.05s;net_send=dup;net_recv=drop",
    "net_send=partition@peer=10.9.9.9",
    "net_accept=half_open:0.4s;net_send=corrupt@hit=2",
    "net_send=drop:p=0.5:seed=7;net_recv=delay:0.1s:times=2",
    "net_send=stall:0.1s;net_recv=corrupt@peer=tcp:",
    "net_send=delay;net_send=delay:0.3s;net_accept=drop@hit=1",
]
CALLS = [("net_send", "tcp:127.0.0.1:1"), ("net_recv", "tcp:127.0.0.1:1"),
         ("net_accept", "127.0.0.1:5"), ("net_send", "tcp:10.9.9.9:1"),
         ("net_send", "unix:/tmp/s"), ("net_recv", "unix:/tmp/s")] * 3


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_wire_plans_equal_the_jax_packages(schedule):
    failpoints.arm(schedule)
    jfailpoints.arm(schedule)
    for site, peer in CALLS:
        got = dataclasses.asdict(netchaos.plan(site, peer=peer))
        want = dataclasses.asdict(jnetchaos.plan(site, peer=peer))
        assert got == want, (site, peer)
    assert failpoints.fired_counts() == jfailpoints.fired_counts()


def test_plan_quiet_when_unarmed():
    assert not netchaos.plan("net_send", peer="anything")
    assert dataclasses.asdict(netchaos.plan("net_send")) == \
        dataclasses.asdict(jnetchaos.plan("net_send"))


@pytest.mark.parametrize("body", [json.dumps({"op": "ping"}).encode(), b"{}", b"", b'{"a": 1}\n'])
def test_mangle_equals_the_jax_packages_and_is_refused(body):
    bad = netchaos.mangle(body)
    assert bad == jnetchaos.mangle(body)
    if body:
        assert bad != body and len(bad) == len(body)
        for lib in (transport, jtransport):
            with pytest.raises(lib.TransportError) as ei:
                lib._decode(bad.rstrip(b"\n"), lib.MAX_FRAME)
            assert ei.value.reason == "bad_json"


# ---------------------------------------------------------------------------
# the refusal matrix over a real socket


class _Echo(ProtocolServer):
    """One-op server counting real dispatches."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.dispatches = 0

    def _dispatch(self, req):
        self.dispatches += 1
        return {"ok": True, "echo": req.get("n")}

    def _on_drain(self):
        pass


@pytest.fixture()
def echo():
    srv = _Echo(addresses=["tcp:127.0.0.1:0"])
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    deadline = time.monotonic() + 10.0
    while not srv.bound and time.monotonic() < deadline:
        time.sleep(0.01)
    assert srv.bound
    yield srv, srv.bound[0]
    failpoints.disarm()
    srv.request_drain()
    t.join(timeout=10.0)


def test_partition_refuses_then_heals(echo):
    srv, addr = echo
    failpoints.arm("net_send=partition")
    with pytest.raises(ConnectionError, match="injected partition"):
        transport.request(addr, {"op": "e", "n": 1}, timeout=5.0)
    assert srv.dispatches == 0
    failpoints.disarm()
    assert transport.request(addr, {"op": "e", "n": 2}, timeout=5.0)["ok"]


def test_drop_kills_one_delivery_retry_heals(echo):
    srv, addr = echo
    failpoints.arm("net_send=drop@hit=1")
    with pytest.raises(ConnectionError, match="injected drop"):
        transport.request(addr, {"op": "e", "n": 1}, timeout=5.0)
    resp = transport.request(addr, {"op": "e", "n": 2}, timeout=5.0)
    assert resp["ok"] and resp["echo"] == 2
    assert srv.dispatches == 1


def test_dup_answered_from_rid_cache(echo, monkeypatch, tmp_path):
    srv, addr = echo
    sink = str(tmp_path / "ledger.jsonl")
    monkeypatch.setenv("BSSEQ_TPU_STATS", sink)
    failpoints.arm("net_send=dup@peer=tcp:")
    resp = transport.request(addr, {"op": "e", "n": 7}, timeout=5.0)
    assert resp["ok"] and resp["echo"] == 7
    assert srv.dispatches == 1
    observe.flush_sinks()
    with open(sink) as fh:
        events = [json.loads(ln) for ln in fh]
    dups = [e for e in events if e["event"] == "frame_dup_ignored"]
    assert len(dups) == 1 and dups[0]["op"] == "e"
    fired = [e for e in events if e["event"] == "failpoint_fired"]
    assert fired and fired[0]["site"] == "net_send" and fired[0]["action"] == "dup"
    observe.close_sinks()


def test_corrupt_request_refused_as_bad_json(echo):
    srv, addr = echo
    failpoints.arm("net_send=corrupt@peer=tcp:")
    resp = transport.request(addr, {"op": "e", "n": 1}, timeout=5.0)
    assert not resp["ok"] and resp["guard"] == "bad_json"
    assert srv.dispatches == 0


def test_corrupt_reply_refused_as_bad_json(echo):
    srv, addr = echo
    failpoints.arm("net_send=corrupt@hit=2")
    with pytest.raises(transport.TransportError) as ei:
        transport.request(addr, {"op": "e", "n": 1}, timeout=5.0)
    assert ei.value.reason == "bad_json"
    assert srv.dispatches == 1


def test_half_open_bounded_by_client_timeout(echo):
    srv, addr = echo
    failpoints.arm("net_accept=half_open:2s")
    t0 = time.monotonic()
    with pytest.raises(OSError):
        transport.request(addr, {"op": "e", "n": 1}, timeout=0.5)
    assert time.monotonic() - t0 < 1.8
    assert srv.dispatches == 0


def test_accept_drop_is_no_response(echo):
    srv, addr = echo
    failpoints.arm("net_accept=drop@hit=1")
    with pytest.raises(ConnectionError):
        transport.request(addr, {"op": "e", "n": 1}, timeout=5.0)
    assert srv.dispatches == 0
    assert transport.request(addr, {"op": "e", "n": 2}, timeout=5.0)["ok"]


def test_delay_slows_but_delivers(echo):
    srv, addr = echo
    failpoints.arm("net_send=delay:0.3s@peer=tcp:")
    t0 = time.monotonic()
    resp = transport.request(addr, {"op": "e", "n": 3}, timeout=5.0)
    assert resp["ok"] and time.monotonic() - t0 >= 0.3
    assert srv.dispatches == 1
