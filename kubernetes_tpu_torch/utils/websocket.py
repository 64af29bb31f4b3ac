"""Minimal RFC 6455 websocket framing (server + client, text frames).

Reference: pkg/apiserver/watch.go:45-102 serves watches over BOTH
chunked JSON and websocket (golang.org/x/net/websocket); this is the
stdlib-only equivalent for the same wire role. Scope is deliberately
the watch protocol's needs: handshake, unfragmented text/close frames,
client-side masking (clients MUST mask; servers MUST NOT).

A copy of `kubernetes_tpu/utils/websocket.py`.
"""

from __future__ import annotations

import base64
import hashlib
import os
import struct
from typing import Optional, Tuple

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def handshake_headers(client_key: str) -> list:
    return [
        ("Upgrade", "websocket"),
        ("Connection", "Upgrade"),
        ("Sec-WebSocket-Accept", accept_key(client_key)),
    ]


def encode_frame(payload: bytes, opcode: int = OP_TEXT, mask: bool = False) -> bytes:
    """One unfragmented frame (FIN set). Clients mask, servers don't."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0
    if n < 126:
        head += bytes([mask_bit | n])
    elif n < 65536:
        head += bytes([mask_bit | 126]) + struct.pack(">H", n)
    else:
        head += bytes([mask_bit | 127]) + struct.pack(">Q", n)
    if mask:
        key = os.urandom(4)
        masked = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
        return head + key + masked
    return head + payload


def read_exact(stream, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            raise ConnectionError("websocket stream closed mid-frame")
        buf += chunk
    return buf


def decode_frame(stream) -> Tuple[int, bytes]:
    """Read one frame -> (opcode, payload). Raises ConnectionError on
    EOF."""
    b0, b1 = read_exact(stream, 2)
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    n = b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack(">H", read_exact(stream, 2))
    elif n == 127:
        (n,) = struct.unpack(">Q", read_exact(stream, 8))
    key = read_exact(stream, 4) if masked else None
    payload = read_exact(stream, n)
    if key:
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return opcode, payload


class WebSocketClient:
    """Tiny client for tests + in-repo consumers: connect, iterate text
    payloads. `headers` are extra handshake headers (auth)."""

    def __init__(
        self,
        host: str,
        port: int,
        path: str,
        timeout: float = 30.0,
        headers: Optional[dict] = None,
    ):
        import socket as socketlib
        import threading

        self._wlock = threading.Lock()
        self.sock = socketlib.create_connection((host, port), timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        extra = "".join(
            f"{name}: {value}\r\n" for name, value in (headers or {}).items()
        )
        req = (
            f"GET {path} HTTP/1.1\r\n"
            f"Host: {host}:{port}\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n"
            f"{extra}\r\n"
        )
        self.sock.sendall(req.encode())
        self.rfile = self.sock.makefile("rb")
        status = self.rfile.readline()
        if b"101" not in status:
            raise ConnectionError(f"websocket handshake refused: {status!r}")
        expect = accept_key(key)
        got = ""
        while True:
            line = self.rfile.readline().strip()
            if not line:
                break
            name, _, value = line.decode().partition(":")
            if name.strip().lower() == "sec-websocket-accept":
                got = value.strip()
        if got != expect:
            raise ConnectionError("websocket accept key mismatch")

    def recv_text(self) -> Optional[str]:
        """Next text payload; None on clean close."""
        while True:
            op, payload = self.recv()
            if op == OP_TEXT:
                return payload.decode()
            if op == OP_CLOSE:
                return None

    def recv(self) -> Tuple[int, bytes]:
        """Next (opcode, payload), answering pings transparently."""
        while True:
            op, payload = decode_frame(self.rfile)
            if op == OP_PING:
                self.send(payload, OP_PONG)
                continue
            return op, payload

    def send(self, payload: bytes, opcode: int = OP_BINARY) -> None:
        # Lock: concurrent senders (relay pumps answer PINGs while the
        # other direction streams data) must not interleave mid-frame.
        with self._wlock:
            self.sock.sendall(encode_frame(payload, opcode, mask=True))

    def clear_timeout(self) -> None:
        """Remove the connect-time socket timeout: long-lived tunnels
        must survive idle periods."""
        self.sock.settimeout(None)

    def close(self) -> None:
        """GRACEFUL close: send a CLOSE frame only. The socket stays
        open so in-flight inbound frames still deliver; call abort()
        (relays do, after a grace period) to release the transport."""
        try:
            self.send(b"", OP_CLOSE)
        except OSError:
            pass

    def abort(self) -> None:
        """Hard-close the transport (unblocks a reader on another
        thread)."""
        try:
            self.sock.close()
        except OSError:
            pass


class ServerEndpoint:
    """Server-side websocket endpoint over a handler's rfile/wfile
    (post-handshake), with the same recv/send surface as the client —
    so relay helpers work with either end. `raw_socket` (the handler's
    connection) enables abort()."""

    def __init__(self, rfile, wfile, raw_socket=None):
        import threading

        self.rfile = rfile
        self.wfile = wfile
        self.raw_socket = raw_socket
        self._wlock = threading.Lock()

    def recv(self) -> Tuple[int, bytes]:
        while True:
            op, payload = decode_frame(self.rfile)
            if op == OP_PING:
                self.send(payload, OP_PONG)
                continue
            return op, payload

    def send(self, payload: bytes, opcode: int = OP_BINARY) -> None:
        with self._wlock:
            self.wfile.write(encode_frame(payload, opcode))  # servers don't mask
            self.wfile.flush()

    def close(self) -> None:
        try:
            self.send(b"", OP_CLOSE)
        except OSError:
            pass

    def abort(self) -> None:
        if self.raw_socket is not None:
            import socket as socketlib

            try:
                self.raw_socket.shutdown(socketlib.SHUT_RDWR)
            except OSError:
                pass


def _abort_later(end, delay: float = 3.0) -> None:
    """Daemon timer backstop: hard-close an endpoint if the graceful
    CLOSE didn't finish the job. Daemonized so lingering timers can't
    hold the process open after a tunnel ends."""
    import threading

    timer = threading.Timer(delay, end.abort)
    timer.daemon = True
    timer.start()


def relay_ws_tcp(ws_end, sock) -> None:
    """Bidirectional pump: websocket endpoint <-> TCP socket. Blocks
    until either side closes. Clears the socket's timeout first (idle
    tunnels must not be torn down by a connect-time timeout)."""
    import socket as socketlib
    import threading

    sock.settimeout(None)
    done = threading.Event()

    def tcp_to_ws():
        try:
            while not done.is_set():
                data = sock.recv(65536)
                if not data:
                    break
                ws_end.send(data, OP_BINARY)
        except (ConnectionError, OSError):
            pass
        finally:
            done.set()
            # Graceful first: the CLOSE frame propagates shutdown
            # through relay chains WITHOUT discarding in-flight bytes
            # (a hard abort RSTs kernel-buffered data). The delayed
            # abort is only the backstop that unblocks OUR reader if
            # the peer never answers the CLOSE.
            ws_end.close()
            _abort_later(ws_end)

    t = threading.Thread(target=tcp_to_ws, daemon=True)
    t.start()
    try:
        while not done.is_set():
            op, payload = ws_end.recv()
            if op == OP_CLOSE:
                break
            if payload:
                sock.sendall(payload)
    except (ConnectionError, OSError):
        pass
    finally:
        done.set()
        try:
            sock.shutdown(socketlib.SHUT_RDWR)
        except OSError:
            pass
        sock.close()
        ws_end.close()
        ws_end.abort()  # peer already finished; safe to hard-close


def relay_ws_ws(a, b) -> None:
    """Bidirectional pump between two websocket endpoints."""
    import threading

    done = threading.Event()

    def pump(src, dst):
        try:
            while not done.is_set():
                op, payload = src.recv()
                if op == OP_CLOSE:
                    break
                dst.send(payload, op)
        except (ConnectionError, OSError):
            pass
        finally:
            done.set()
            for end in (src, dst):
                end.close()  # graceful: CLOSE frames propagate
                _abort_later(end)  # delayed hard-close backstop

    t = threading.Thread(target=pump, args=(b, a), daemon=True)
    t.start()
    pump(a, b)
    t.join(timeout=4)
