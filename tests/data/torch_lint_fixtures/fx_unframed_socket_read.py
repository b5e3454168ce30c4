"""graftlint fixture: unframed-socket-read — one seeded violation.

fx_raw_tcp_reader trusts the peer for both the record boundary and the
size by calling raw ``conn.recv`` on a TCP connection; the delegating
variant below reads through the length-framed guarded transport reader
and must stay clean, as must the reviewed-and-suppressed frame pump.
"""

import socket


def fx_raw_tcp_reader(conn):
    data = conn.recv(1 << 20)  # seeded: unframed-socket-read
    return data.decode("utf-8", "replace")


def fx_framed_reader(transport, address, payload):
    conn = socket.create_connection(address, timeout=5.0)
    try:
        transport.send_message(conn, "tcp", payload)
        return transport.recv_message(conn, "tcp")
    finally:
        conn.close()


def fx_reviewed_frame_pump(conn, admitted_len):
    buf = bytearray()
    while len(buf) < admitted_len:
        # graftlint: disable=unframed-socket-read -- this IS the framed
        # reader: admitted_len was checked against MAX_FRAME upstream
        chunk = conn.recv(admitted_len - len(buf))
        if not chunk:
            break
        buf += chunk
    return bytes(buf)
