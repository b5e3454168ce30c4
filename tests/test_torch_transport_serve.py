"""The port's serve transport and protocol server (serve/transport.py,
serve/server.py) on the CPU, held against the JAX package's
(tests/test_fleet.py framing and refusals, tests/test_serve.py protocol):

* the address grammar: the same parses and the same typed refusals;
* the framing: every hostile byte stream (oversized, empty, garbage,
  non-object, truncated frames; an unbounded unix line) refused by both
  packages' readers with the same reason; frames written by one package
  read by the other;
* the wire: the JAX package's client against the port's server and the
  port's client against the JAX package's, both framings;
* the protocol: a ServeServer on a unix and a tcp address in this process,
  `submit --wait` over each (the bytes of the JAX package's `molecular
  --batching sequential`), ping / status / stats / metrics / unknown op,
  a bogus u32 length answered `{"ok": false, "guard": "oversized_frame"}`,
  and the drain op;
* (slow, as the JAX package marks its own) `serve` in a child process
  drains every admitted job on SIGTERM and exits 0.

Tolerance: equality (parsed values, reasons, replies, SHA-256 of BAMs).
"""

import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import pytest

from bsseqconsensusreads_tpu.serve import server as jserver
from bsseqconsensusreads_tpu.serve import transport as jtransport
from bsseqconsensusreads_tpu_torch import cli
from bsseqconsensusreads_tpu_torch.faults.guard import GuardError
from bsseqconsensusreads_tpu_torch.serve import ServeEngine, ServeServer
from bsseqconsensusreads_tpu_torch.serve import server as pserver
from bsseqconsensusreads_tpu_torch.serve import transport
from test_torch_serve import _reference_natives, grouped_bam, jax_standalone, sha  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# address grammar


@pytest.mark.parametrize("addr", ["/tmp/x.sock", "unix:/tmp/x.sock", "tcp:127.0.0.1:8641",
                                  "tcp:localhost:0", "tcp:[::1]:9"])
def test_addresses_parse_as_the_jax_packages(addr):
    assert transport.parse_address(addr) == jtransport.parse_address(addr)
    assert transport.is_tcp(addr) == jtransport.is_tcp(addr)


@pytest.mark.parametrize("bad", ["", "unix:", "tcp:", "tcp:nohost", "tcp::123", "tcp:h:",
                                 "tcp:h:notaport", "tcp:h:70000"])
def test_bad_addresses_are_the_jax_packages_typed_refusals(bad):
    with pytest.raises(transport.TransportError) as ei:
        transport.parse_address(bad)
    with pytest.raises(jtransport.TransportError) as ej:
        jtransport.parse_address(bad)
    assert ei.value.reason == ej.value.reason == "bad_address"
    assert isinstance(ei.value, GuardError) and isinstance(ei.value, ConnectionError)


# ---------------------------------------------------------------------------
# framing over socketpairs


def _pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return a, b


def _read(lib, raw: bytes, kind: str, close: bool, max_bytes=None):
    """(reply, refusal reason) of `lib`'s reader over the bytes `raw`."""
    a, b = _pair()
    try:
        a.sendall(raw)
        if close:
            a.close()
        kw = {} if max_bytes is None else {"max_bytes": max_bytes}
        try:
            return lib.recv_message(b, kind, **kw), None
        except lib.TransportError as exc:
            return None, exc.reason
    finally:
        a.close()
        b.close()


HOSTILE = {
    "oversized": (struct.pack("!I", transport.MAX_FRAME + 1), "tcp", False, None),
    "empty": (struct.pack("!I", 0), "tcp", False, None),
    "garbage": (struct.pack("!I", 19) + b"\xff\xfe not json at all.", "tcp", False, None),
    "non-object": (struct.pack("!I", 9) + b"[1, 2, 3]", "tcp", False, None),
    "truncated": (struct.pack("!I", 100) + b"only ten b", "tcp", True, None),
    "unbounded-line": (b"x" * 8192, "unix", False, 1024),
    "clean-eof-tcp": (b"", "tcp", True, None),
    "clean-eof-unix": (b"", "unix", True, None),
    "unix-line-at-eof": (b'{"op": "ping"}', "unix", True, None),
}


@pytest.mark.parametrize("case", sorted(HOSTILE))
def test_readers_refuse_as_the_jax_packages(case):
    raw, kind, close, max_bytes = HOSTILE[case]
    got = _read(transport, raw, kind, close, max_bytes)
    want = _read(jtransport, raw, kind, close, max_bytes)
    assert got == want
    if case in ("oversized", "empty", "garbage", "non-object", "truncated", "unbounded-line"):
        assert got[1] is not None


@pytest.mark.parametrize("kind", ["unix", "tcp"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_frames_cross_between_the_packages(kind, writer):
    payload = {"op": "submit", "spec": {"input": "x", "n": [1, 2, 3]}, "u": "é"}
    send, recv = (transport, jtransport) if writer == "port" else (jtransport, transport)
    a, b = _pair()
    try:
        send.send_message(a, kind, payload)
        assert recv.recv_message(b, kind) == payload
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# servers in this process


class _Echo(pserver.ProtocolServer):
    def _dispatch(self, req):
        return {"ok": True, "echo": req}

    def _on_drain(self):
        pass


class _JaxEcho(jserver.ProtocolServer):
    def _dispatch(self, req):
        return {"ok": True, "echo": req}

    def _on_drain(self):
        pass


def serving(srv):
    """Start `srv.serve_forever` on a thread; returns the thread once the
    server has bound its addresses."""
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while len(srv.bound) < len(srv.addresses) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(srv.bound) == len(srv.addresses), "server never bound"
    return t


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_clients_and_servers_of_both_packages_interoperate(server_pkg, tmp_path):
    cls = _Echo if server_pkg == "port" else _JaxEcho
    client = jtransport if server_pkg == "port" else transport
    srv = cls(addresses=["tcp:127.0.0.1:0", f"unix:{tmp_path / 'e.sock'}"])
    t = serving(srv)
    try:
        for addr in srv.bound:
            resp = client.request(addr, {"op": "ping", "k": 1}, timeout=5.0)
            assert resp == {"ok": True, "echo": {"op": "ping", "k": 1}}
        sock, kind = transport.connect(srv.bound[0], timeout=5.0)
        try:
            sock.sendall(struct.pack("!I", transport.MAX_FRAME + 7))
            resp = transport.recv_message(sock, kind)
        finally:
            sock.close()
        assert resp["ok"] is False and resp["guard"] == "oversized_frame"
    finally:
        srv.request_drain()
        t.join(timeout=10)


@pytest.fixture(scope="module")
def tenant(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_protocol")
    inp = grouped_bam(str(d / "in.bam"), seed=800)
    return d, inp, jax_standalone(inp, str(d / "ref.bam"))


def test_serve_protocol_over_unix_and_tcp(tenant, tmp_path, capsys):
    """submit --wait over both addresses writes the JAX package's bytes;
    the other ops answer as the JAX package's server does; a bogus length
    header is refused with the guard reason; drain answers drained."""
    _d, inp, ref = tenant
    engine = ServeEngine(device="cpu", batch_families=4).start()
    srv = ServeServer(engine, addresses=[f"unix:{tmp_path / 's.sock'}", "tcp:127.0.0.1:0"])
    t = serving(srv)
    try:
        outs = []
        for k, addr in enumerate(srv.bound):
            out = str(tmp_path / f"out{k}.bam")
            outs.append(out)
            assert cli.main(["submit", "--socket", addr, "-i", inp, "-o", out,
                             "--wait", "--timeout", "60"]) == 0
            assert sha(out) == ref
        capsys.readouterr()
        addr = srv.bound[1]
        assert transport.request(addr, {"op": "ping"}) == {"ok": True, "pong": True}
        st = transport.request(addr, {"op": "status", "job": "j0001"})
        assert st["ok"] and st["job"]["state"] == "done"
        assert transport.request(addr, {"op": "status", "job": "j9"})["ok"] is False
        stats = transport.request(addr, {"op": "stats"})["stats"]
        assert [j["state"] for j in stats["jobs"]] == ["done", "done"]
        metrics = transport.request(addr, {"op": "metrics"})["metrics"]
        assert metrics["component"] == "serve" and metrics["jobs_total"] == 2
        bad = transport.request(addr, {"op": "frobnicate"})
        assert bad["ok"] is False and "unknown op" in bad["error"]
        garbage = str(tmp_path / "junk.bam")
        with open(garbage, "wb") as fh:
            fh.write(b"junk")
        assert cli.main(["submit", "--socket", addr, "-i", garbage, "-o", outs[0]]) == 3
        sock, kind = transport.connect(addr, timeout=5.0)
        try:
            sock.sendall(struct.pack("!I", 0xFFFFFFF0))
            resp = transport.recv_message(sock, kind)
        finally:
            sock.close()
        assert resp == {"ok": False, "error": resp["error"], "guard": "oversized_frame"}
        assert transport.request(addr, {"op": "drain", "timeout": 60, "sent_s": time.time()},
                                 timeout=90) == {"ok": True, "drained": True}
        t.join(timeout=30)
        assert not t.is_alive()
        assert cli.main(["serve-ctl", "ping", "--socket", addr, "--timeout", "2"]) == 2
    finally:
        srv.request_drain()
        engine.stop(timeout=30)


@pytest.mark.slow
def test_sigterm_drains_every_admitted_job(tenant, tmp_path):
    """`serve` in a child process: SIGTERM with two jobs admitted, both
    finish with the JAX package's bytes and the process exits 0."""
    d, inp, ref = tenant
    inp2 = grouped_bam(str(tmp_path / "in2.bam"), seed=701)
    ref2 = jax_standalone(inp2, str(tmp_path / "ref2.bam"))
    sock_path = str(tmp_path / "s.sock")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "bsseqconsensusreads_tpu_torch", "serve", "--socket", sock_path,
         "--batch-families", "4", "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                pserver.request(sock_path, {"op": "ping"}, timeout=2.0)
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.1)
        outs = [str(tmp_path / "o1.bam"), str(tmp_path / "o2.bam")]
        for src, out in zip((inp, inp2), outs):
            resp = pserver.request(sock_path, {"op": "submit",
                                               "spec": {"input": src, "output": out}})
            assert resp["ok"], resp
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0, proc.stderr.read().decode()[-2000:]
        assert [sha(o) for o in outs] == [ref, ref2]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
