"""Serve transport: address grammar + guarded wire framing (unix/TCP/TLS).

The port's copy of the JAX package's serve/transport.py: the same address
grammar, framing, refusals and netchaos shim, so the two packages'
clients and servers speak to each other.

The serve protocol is one JSON object each way per connection. This
module owns how those objects cross a socket, so the server, the
router, and every client agree on exactly one framing per transport:

* ``unix:<path>`` (or a bare filesystem path) — one newline-terminated
  JSON line each way. The reader here is *bounded*: a line that exceeds ``MAX_FRAME`` bytes without a
  newline is refused, so a hostile peer cannot balloon the resident
  process by never sending ``\\n``.
* ``tcp:<host>:<port>`` — the same JSON payloads, length-framed: a u32
  big-endian byte count, then exactly that many bytes of JSON. TCP is
  a byte stream with no natural record boundary and (unlike the unix
  socket) no filesystem permission wall, so the frame header is the
  admission gate: a declared length of zero or beyond ``MAX_FRAME``
  refuses the frame *before* a single payload byte is buffered.
* TLS rides the tcp transport when ``BSSEQ_TPU_SERVE_TLS_CERT`` /
  ``BSSEQ_TPU_SERVE_TLS_KEY`` name a PEM cert/key: the server wraps
  each accepted connection, clients verify against the cert as its own
  CA (self-signed single-cert deployments; a real PKI just points the
  env at its chain).

Failure policy is the input guard's: garbage frames, oversized payloads,
truncated streams, and non-JSON bodies surface as `TransportError` — a
typed `GuardError` — never a crash and never an unbounded read. The
server answers what it can and closes; the client raises the typed
error to its caller. Raw ``recv``/``readline`` on a socket belongs here
and nowhere else.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time

from bsseqconsensusreads_tpu_torch.faults import netchaos
from bsseqconsensusreads_tpu_torch.faults.guard import GuardError
from bsseqconsensusreads_tpu_torch.utils import observe

#: Hard ceiling on one protocol message (either direction, both
#: transports). Large enough for any stats payload; small enough that a
#: hostile length header cannot make the server allocate real memory.
MAX_FRAME = 8 * 1024 * 1024

_LEN = struct.Struct("!I")

ENV_TLS_CERT = "BSSEQ_TPU_SERVE_TLS_CERT"
ENV_TLS_KEY = "BSSEQ_TPU_SERVE_TLS_KEY"


class TransportError(GuardError, ConnectionError):
    """A wire-level refusal: bad frame, oversized payload, truncation,
    or non-JSON body. GuardError ancestry keeps the fuzz contract
    (hostile bytes -> typed error, never a crash); ConnectionError
    ancestry keeps existing callers that catch socket failures
    working."""

    def __init__(self, message: str, reason: str = "transport"):
        super().__init__(message)
        self.reason = reason


# ---------------------------------------------------------------------------
# Address grammar.


def parse_address(address: str) -> tuple:
    """('unix', path) or ('tcp', host, port). A bare path (no scheme)
    is a unix socket."""
    if not isinstance(address, str) or not address:
        raise TransportError(
            f"bad serve address {address!r}", reason="bad_address"
        )
    if address.startswith("unix:"):
        path = address[len("unix:"):]
        if not path:
            raise TransportError(
                f"bad unix address {address!r} (empty path)",
                reason="bad_address",
            )
        return ("unix", path)
    if address.startswith("tcp:"):
        rest = address[len("tcp:"):]
        host, sep, port_s = rest.rpartition(":")
        if not sep or not host or not port_s:
            raise TransportError(
                f"bad tcp address {address!r} (want tcp:host:port)",
                reason="bad_address",
            )
        try:
            port = int(port_s)
        except ValueError:
            raise TransportError(
                f"bad tcp port {port_s!r} in {address!r}",
                reason="bad_address",
            ) from None
        if not 0 <= port <= 65535:
            raise TransportError(
                f"tcp port {port} out of range in {address!r}",
                reason="bad_address",
            )
        return ("tcp", host, port)
    return ("unix", address)


def is_tcp(address: str) -> bool:
    return parse_address(address)[0] == "tcp"


# ---------------------------------------------------------------------------
# TLS (env-driven; tcp only).


def tls_server_context():
    """An SSLContext when the TLS env pair is set, else None."""
    cert = os.environ.get(ENV_TLS_CERT)
    if not cert:
        return None
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, os.environ.get(ENV_TLS_KEY) or None)
    return ctx


def tls_client_context():
    """Client context verifying against the server cert as its own CA
    (the self-signed single-cert deployment); None when TLS is off."""
    cert = os.environ.get(ENV_TLS_CERT)
    if not cert:
        return None
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.load_verify_locations(cafile=cert)
    return ctx


# ---------------------------------------------------------------------------
# Sockets.


def listen(address: str, backlog: int = 16, timeout: float = 0.25):
    """Bind + listen. Returns (sock, kind, resolved_address) —
    resolved_address substitutes the kernel-assigned port when the
    caller bound port 0 (how the fleet allocates replica ports). TLS
    wrapping happens per accepted connection (`server_wrap`), not on
    the listener, so one bad handshake can never wedge the accept
    loop."""
    parsed = parse_address(address)
    if parsed[0] == "unix":
        path = parsed[1]
        try:
            os.unlink(path)
        except OSError:
            pass
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.bind(path)
        resolved = f"unix:{path}"
    else:
        _, host, port = parsed
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host, port))
        resolved = f"tcp:{host}:{sock.getsockname()[1]}"
    sock.listen(backlog)
    sock.settimeout(timeout)
    return sock, parsed[0], resolved


def server_wrap(conn: socket.socket, kind: str) -> socket.socket:
    """TLS-wrap one accepted tcp connection when the env pair is set.
    Handshake failures raise OSError (ssl.SSLError) — the per-
    connection handler treats them as a refused client."""
    if kind != "tcp":
        return conn
    ctx = tls_server_context()
    if ctx is None:
        return conn
    return ctx.wrap_socket(conn, server_side=True)


def connect(address: str, timeout: float = 600.0):
    """Connect a client socket. Returns (sock, kind)."""
    parsed = parse_address(address)
    if parsed[0] == "unix":
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        sock.connect(parsed[1])
        return sock, "unix"
    _, host, port = parsed
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.settimeout(timeout)
    sock.connect((host, port))
    ctx = tls_client_context()
    if ctx is not None:
        sock = ctx.wrap_socket(sock, server_hostname=host)
    return sock, "tcp"


# ---------------------------------------------------------------------------
# The guarded readers/writers — the only sanctioned socket I/O in the
# package.


def _recv_exact(conn: socket.socket, n: int, what: str) -> bytes:
    """Exactly n bytes or a typed truncation error; b'' only when the
    peer closed cleanly before the FIRST byte of `what`."""
    chunks: list[bytes] = []
    got = 0
    while got < n:
        # the framed reader: the byte count was admitted against
        # MAX_FRAME first
        # graftlint: disable=unframed-socket-read -- this IS the framed reader: the byte
        # count was admitted against MAX_FRAME first
        chunk = conn.recv(min(n - got, 1 << 16))
        if not chunk:
            if not chunks:
                return b""
            raise TransportError(
                f"truncated {what}: peer closed after {got}/{n} bytes",
                reason="truncated_frame",
            )
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _decode(data: bytes, max_bytes: int) -> dict:
    if len(data) > max_bytes:
        raise TransportError(
            f"oversized message: {len(data)} bytes > {max_bytes}",
            reason="oversized_frame",
        )
    try:
        obj = json.loads(data)
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise TransportError(
            f"garbage frame: not JSON ({exc})", reason="bad_json"
        ) from None
    if not isinstance(obj, dict):
        raise TransportError(
            f"garbage frame: JSON {type(obj).__name__}, want object",
            reason="bad_json",
        )
    return obj


def recv_message(
    conn: socket.socket, kind: str, max_bytes: int = MAX_FRAME
) -> dict | None:
    """One guarded protocol message, or None on clean EOF before any
    byte. All refusals are TransportError (typed GuardError)."""
    if kind == "tcp":
        header = _recv_exact(conn, _LEN.size, "frame header")
        if not header:
            return None
        (length,) = _LEN.unpack(header)
        if length == 0 or length > max_bytes:
            raise TransportError(
                f"refused frame: declared length {length} "
                f"(admissible 1..{max_bytes})",
                reason="oversized_frame" if length else "empty_frame",
            )
        return _decode(_recv_exact(conn, length, "frame body"), max_bytes)
    # unix: newline-delimited JSON, read BOUNDED — a peer that never
    # sends '\n' is refused at max_bytes, not buffered forever
    buf = bytearray()
    while True:
        # the bounded line reader the rest of the package calls
        # graftlint: disable=unframed-socket-read -- this IS the bounded line reader the
        # rest of the package must call
        chunk = conn.recv(1 << 16)
        if not chunk:
            if not buf:
                return None
            break  # EOF terminates the line (lenient: line clients)
        buf.extend(chunk)
        if b"\n" in chunk:
            break
        if len(buf) > max_bytes:
            raise TransportError(
                f"unframed line exceeds {max_bytes} bytes with no "
                "newline", reason="oversized_frame",
            )
    line, _, _ = bytes(buf).partition(b"\n")
    return _decode(line, max_bytes)


def send_message(
    conn: socket.socket, kind: str, obj: dict, _corrupt: bool = False
) -> None:
    data = json.dumps(obj).encode()
    if len(data) > MAX_FRAME:
        raise TransportError(
            f"refusing to send oversized message ({len(data)} bytes)",
            reason="oversized_frame",
        )
    if _corrupt:
        # netchaos `corrupt`: flip body bytes AFTER the length header —
        # length stays truthful, so the peer buffers the frame and must
        # refuse it at decode (bad_json), proving garbage never parses
        data = netchaos.mangle(data)
    if kind == "tcp":
        conn.sendall(_LEN.pack(len(data)) + data)
    else:
        conn.sendall(data + b"\n")


def mint_rid() -> str:
    """A request id (nonce) for duplicate-delivery detection: stamped by
    `request()` as the reserved `_rid` key, echoed nowhere, consumed by
    the server's dedup cache. Random, not sequential — two processes
    sharing a worker id must never collide."""
    return os.urandom(8).hex()


def request(address: str, payload: dict, timeout: float = 600.0) -> dict:
    """One client request/response against a serve or router process.
    Raises TransportError on wire refusals, ConnectionError/OSError on
    plain socket failures.

    Trace carriage: when the calling thread has a bound trace context
    (observe.bind_trace), it rides as the reserved `_trace` key of the
    request object — identical on both framings, since each is one JSON
    object per message — and the round-trip is booked as a 'transport'
    span in that trace. The payload the caller passed is never mutated.

    Duplicate-delivery protection: every request is stamped with a
    reserved `_rid` nonce; servers answer a re-delivered rid from their
    reply cache without re-running the op (`frame_dup_ignored`).

    Wire faults (faults/netchaos.py, sites net_send/net_recv armed via
    BSSEQ_TPU_FAILPOINTS): partition refuses the connection, delay
    sleeps, drop closes without delivering, corrupt mangles the frame
    body (the peer must refuse it), dup re-issues the identical frame —
    same _rid, same _trace — on a fresh connection and discards the
    second reply."""
    trace_ctx = observe.current_trace()
    if trace_ctx is not None and "_trace" not in payload:
        payload = dict(payload, _trace=trace_ctx)
    if "_rid" not in payload:
        payload = dict(payload, _rid=mint_rid())
    fault = netchaos.plan("net_send", peer=address)
    if fault.partition:
        raise ConnectionError(
            f"injected partition: refusing connection to {address}"
        )
    if fault.delay_s:
        time.sleep(fault.delay_s)
    t0 = time.time()
    sock, kind = connect(address, timeout=timeout)
    try:
        if fault.drop:
            # connected, then the frame never arrives: the peer sees a
            # clean EOF, this client a dead exchange
            raise ConnectionError(
                f"injected drop: frame to {address} not delivered"
            )
        send_message(sock, kind, payload, _corrupt=fault.corrupt)
        rfault = netchaos.plan("net_recv", peer=address)
        if rfault.delay_s:
            time.sleep(rfault.delay_s)
        if rfault.drop:
            raise ConnectionError(
                f"injected drop: reply from {address} discarded"
            )
        resp = recv_message(sock, kind)
    finally:
        try:
            sock.close()
        # graftlint: disable=swallowed-exception -- closing a socket after the reply was
        # read; the reply stands
        except OSError:
            pass
        if trace_ctx is not None:
            observe.emit_span(
                "transport", t0, time.time(), ctx=trace_ctx,
                op=str(payload.get("op", "")),
            )
    if resp is None:
        raise ConnectionError(f"no response from {address}")
    if fault.dup:
        # second delivery of the SAME frame: fresh connection, identical
        # payload (same _rid); the reply is discarded — the server's
        # dedup cache must answer it without a second state transition
        sock2, kind2 = connect(address, timeout=timeout)
        try:
            send_message(sock2, kind2, payload)
            recv_message(sock2, kind2)
        # graftlint: disable=swallowed-exception -- the duplicate best-efforts; the
        # first reply stands
        except (TransportError, OSError):
            pass  # the duplicate best-efforts; the first reply stands
        finally:
            try:
                sock2.close()
            # graftlint: disable=swallowed-exception -- closing the duplicate's socket;
            # the first reply stands
            except OSError:
                pass
    return resp
