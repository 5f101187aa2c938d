"""Minimal asyncio HTTP/1.1 server with SSE streaming support.

A copy of scalellm_tpu/serve/http.py: the standard library only, no web
framework (the API surface is small and SSE is plain chunked text).
Keep-alive connections, chunked server-sent events, a 32 MiB body cap.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Awaitable, Callable, Dict, Optional, Tuple

logger = logging.getLogger(__name__)

MAX_BODY = 32 * 2**20  # 32 MiB request cap


class Request:
    def __init__(self, method: str, path: str, headers: Dict[str, str], body: bytes):
        self.method = method
        self.path = path
        self.headers = headers
        self.body = body

    def json(self):
        return json.loads(self.body or b"{}")


class Response:
    """Buffered response."""

    def __init__(
        self,
        status: int = 200,
        body: bytes = b"",
        content_type: str = "application/json",
        headers: Optional[Dict[str, str]] = None,
    ):
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = headers or {}

    @classmethod
    def json(cls, obj, status: int = 200) -> "Response":
        return cls(status, json.dumps(obj).encode(), "application/json")

    @classmethod
    def text(cls, s: str, status: int = 200, content_type: str = "text/plain") -> "Response":
        return cls(status, s.encode(), content_type)


class SSEResponse:
    """Server-sent-events stream; handler writes chunks via `send`."""

    def __init__(self):
        self._queue: asyncio.Queue = asyncio.Queue()

    async def send(self, data: str) -> None:
        await self._queue.put(f"data: {data}\n\n".encode())

    async def done(self) -> None:
        await self._queue.put(b"data: [DONE]\n\n")
        await self._queue.put(None)

    async def aborted(self) -> None:
        await self._queue.put(None)


_STATUS_TEXT = {
    200: "OK", 400: "Bad Request", 401: "Unauthorized", 404: "Not Found",
    405: "Method Not Allowed", 429: "Too Many Requests", 499: "Client Closed",
    500: "Internal Server Error", 501: "Not Implemented",
    503: "Service Unavailable", 504: "Gateway Timeout",
}

Handler = Callable[[Request], Awaitable[object]]


class HttpServer:
    def __init__(self):
        self._routes: Dict[Tuple[str, str], Handler] = {}
        self._server: Optional[asyncio.AbstractServer] = None

    def route(self, method: str, path: str):
        def deco(fn: Handler):
            self._routes[(method.upper(), path)] = fn
            return fn

        return deco

    async def start(self, host: str, port: int) -> None:
        self._server = await asyncio.start_server(self._handle_conn, host, port)

    async def serve_forever(self) -> None:
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # ------------------------------------------------------------- internals

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                keep_alive = req.headers.get("connection", "keep-alive") != "close"
                await self._dispatch(req, writer)
                if not keep_alive:
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except Exception:
            logger.exception("connection handler error")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _read_request(self, reader: asyncio.StreamReader) -> Optional[Request]:
        try:
            line = await reader.readline()
        except (ConnectionResetError, asyncio.IncompleteReadError):
            return None
        if not line:
            return None
        parts = line.decode("latin1").strip().split()
        if len(parts) < 2:
            return None
        method, path = parts[0].upper(), parts[1]
        headers: Dict[str, str] = {}
        while True:
            hline = await reader.readline()
            if hline in (b"\r\n", b"\n", b""):
                break
            k, _, v = hline.decode("latin1").partition(":")
            headers[k.strip().lower()] = v.strip()
        body = b""
        length = int(headers.get("content-length", 0) or 0)
        if length:
            if length > MAX_BODY:
                return Request(method, path, headers, b"")
            body = await reader.readexactly(length)
        return Request(method, path, headers, body)

    async def _dispatch(self, req: Request, writer: asyncio.StreamWriter) -> None:
        path = req.path.split("?", 1)[0]
        handler = self._routes.get((req.method, path))
        if handler is None:
            await self._write_response(writer, Response.json(
                {"error": {"message": f"not found: {path}", "type": "not_found", "code": 404}},
                404,
            ))
            return
        try:
            result = await handler(req)
        except Exception as e:
            logger.exception("handler error for %s", path)
            await self._write_response(
                writer,
                Response.json(
                    {"error": {"message": str(e), "type": "internal_error", "code": 500}},
                    500,
                ),
            )
            return
        if isinstance(result, SSEResponse):
            await self._write_sse(writer, result)
        else:
            await self._write_response(writer, result)

    async def _write_response(self, writer: asyncio.StreamWriter, resp: Response) -> None:
        head = (
            f"HTTP/1.1 {resp.status} {_STATUS_TEXT.get(resp.status, 'Unknown')}\r\n"
            f"Content-Type: {resp.content_type}\r\n"
            f"Content-Length: {len(resp.body)}\r\n"
        )
        for k, v in resp.headers.items():
            head += f"{k}: {v}\r\n"
        head += "\r\n"
        writer.write(head.encode() + resp.body)
        await writer.drain()

    async def _write_sse(self, writer: asyncio.StreamWriter, sse: SSEResponse) -> None:
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Transfer-Encoding: chunked\r\n"
            b"\r\n"
        )
        await writer.drain()
        while True:
            chunk = await sse._queue.get()
            if chunk is None:
                break
            writer.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
            try:
                await writer.drain()
            except (ConnectionResetError, BrokenPipeError):
                raise
        writer.write(b"0\r\n\r\n")
        await writer.drain()
