"""Minimal RFC 6455 WebSocket implementation over asyncio streams.

The serving environment has no web framework, so the dashboard server
carries its own protocol layer (~150 lines): HTTP Upgrade handshake,
frame encode/decode (text/binary/ping/pong/close, client-masked frames,
64-bit lengths), and a small WebSocket object with locked writes.

Scope: server side only; no extensions (permessage-deflate); fragmented
messages are reassembled from continuation frames up to max_frame_bytes
total, with control frames handled mid-message. These limits are TESTED
boundaries (tests/test_ws_protocol_fuzz.py): oversized declared lengths
fail before buffering, interleaved/invalid/truncated frames raise instead
of hanging, and a new data frame inside an unfinished message is rejected
per RFC 6455 5.4.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import struct

# server-side inbound frames are small JSON commands; clients (tests,
# tooling) receive large init payloads and use a higher cap
MAX_FRAME_BYTES = 1 << 20
MAX_CLIENT_FRAME_BYTES = 256 << 20

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA


class WebSocketClosed(ConnectionError):
    pass


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def handshake_response(headers: dict[str, str]) -> bytes | None:
    """Build the 101 response for an Upgrade request, or None if invalid."""
    if headers.get("upgrade", "").lower() != "websocket":
        return None
    key = headers.get("sec-websocket-key")
    if not key:
        return None
    return (
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {accept_key(key)}\r\n"
        "\r\n"
    ).encode()


def encode_frame(opcode: int, payload: bytes, fin: bool = True) -> bytes:
    head = bytes([(0x80 if fin else 0) | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < 65536:
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + payload


class WebSocket:
    """Server-side connection over (reader, writer)."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 max_frame_bytes: int = MAX_FRAME_BYTES):
        self.max_frame_bytes = max_frame_bytes
        self.reader = reader
        self.writer = writer
        self._send_lock = asyncio.Lock()
        self.closed = False

    async def _send_frame(self, opcode: int, payload: bytes) -> None:
        if self.closed:
            raise WebSocketClosed()
        async with self._send_lock:
            try:
                self.writer.write(encode_frame(opcode, payload))
                await self.writer.drain()
            except (ConnectionError, RuntimeError) as e:
                self.closed = True
                raise WebSocketClosed(str(e)) from e

    async def send_text(self, text: str) -> None:
        await self._send_frame(OP_TEXT, text.encode())

    async def send_json(self, msg: dict) -> None:
        await self.send_text(json.dumps(msg, default=str))

    async def pong(self, payload: bytes = b"") -> None:
        await self._send_frame(OP_PONG, payload)

    async def _read_exactly(self, n: int) -> bytes:
        try:
            return await self.reader.readexactly(n)
        except (asyncio.IncompleteReadError, ConnectionError) as e:
            self.closed = True
            raise WebSocketClosed(str(e)) from e

    async def recv(self) -> tuple[int, bytes]:
        """Next complete message as (opcode, payload); answers pings.

        Continuation frames are concatenated; control frames interleaved
        within a fragmented message are handled.
        """
        message: bytes = b""
        message_op: int | None = None
        while True:
            b1, b2 = await self._read_exactly(2)
            fin = bool(b1 & 0x80)
            opcode = b1 & 0x0F
            masked = bool(b2 & 0x80)
            length = b2 & 0x7F
            if length == 126:
                (length,) = struct.unpack(">H", await self._read_exactly(2))
            elif length == 127:
                (length,) = struct.unpack(">Q", await self._read_exactly(8))
            if (length > self.max_frame_bytes
                    or len(message) + length > self.max_frame_bytes):
                # dashboard commands are tiny JSON: an outsized declared
                # length is either a broken client or a memory-exhaustion
                # attempt — fail the connection before buffering anything
                self.closed = True
                raise ConnectionError(
                    f"frame of {length} bytes exceeds max_frame_bytes")
            mask = await self._read_exactly(4) if masked else b""
            payload = await self._read_exactly(length) if length else b""
            if masked and payload:
                payload = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))

            if opcode == OP_PING:
                await self.pong(payload)
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                self.closed = True
                try:
                    async with self._send_lock:
                        self.writer.write(encode_frame(OP_CLOSE, payload[:2]))
                        await self.writer.drain()
                except (ConnectionError, RuntimeError):
                    pass
                raise WebSocketClosed("client closed")

            if opcode in (OP_TEXT, OP_BINARY):
                if message_op is not None:
                    # RFC 6455 5.4: a new data frame before the previous
                    # message's FIN is a protocol violation — fail loudly
                    # instead of silently dropping the half-built message
                    self.closed = True
                    raise WebSocketClosed(
                        "new data frame interleaved into unfinished message")
                message_op = opcode
                message = payload
            elif opcode == OP_CONT and message_op is not None:
                message += payload
            else:
                # orphan continuation / reserved opcode: protocol-dead too —
                # mark closed so concurrent senders short-circuit (same
                # convention as the interleaved-data-frame path above)
                self.closed = True
                raise WebSocketClosed(f"unexpected opcode {opcode}")
            if fin:
                return message_op, message

    async def recv_text(self) -> str:
        op, payload = await self.recv()
        return payload.decode()

    async def close(self, code: int = 1000) -> None:
        if self.closed:
            return
        self.closed = True
        try:
            async with self._send_lock:
                self.writer.write(encode_frame(OP_CLOSE, struct.pack(">H", code)))
                await self.writer.drain()
        except (ConnectionError, RuntimeError):
            pass
        try:
            self.writer.close()
        except RuntimeError:
            pass


class WebSocketClientError(ConnectionError):
    pass


async def client_connect(host: str, port: int, path: str = "/ws",
                         host_header: str | None = None) -> WebSocket:
    """Tiny WS client for tests and tooling (frames sent MASKED per RFC)."""
    import os

    reader, writer = await asyncio.open_connection(host, port)
    key = base64.b64encode(os.urandom(16)).decode()
    writer.write(
        (f"GET {path} HTTP/1.1\r\n"
         f"Host: {host_header or f'{host}:{port}'}\r\n"
         "Upgrade: websocket\r\nConnection: Upgrade\r\n"
         f"Sec-WebSocket-Key: {key}\r\n"
         "Sec-WebSocket-Version: 13\r\n\r\n").encode()
    )
    await writer.drain()
    status = await reader.readline()
    if b"101" not in status:
        raise WebSocketClientError(f"handshake failed: {status!r}")
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
    ws = WebSocket(reader, writer, max_frame_bytes=MAX_CLIENT_FRAME_BYTES)

    # client frames must be masked: wrap _send_frame
    async def _send_frame_masked(opcode: int, payload: bytes) -> None:
        if ws.closed:
            raise WebSocketClosed()
        mask = os.urandom(4)
        masked = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
        n = len(payload)
        head = bytes([0x80 | opcode])
        if n < 126:
            head += bytes([0x80 | n])
        elif n < 65536:
            head += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            head += bytes([0x80 | 127]) + struct.pack(">Q", n)
        async with ws._send_lock:
            ws.writer.write(head + mask + masked)
            await ws.writer.drain()

    ws._send_frame = _send_frame_masked  # type: ignore[method-assign]
    return ws
