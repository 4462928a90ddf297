"""Minimal threaded HTTP service kit for the REST planes.

Copy of ``predictionio_tpu/common/http.py`` with its telemetry and trace
hooks (an installed :class:`~predictionio_tpu_torch.obs.Telemetry` counts
every request and records its sampled trace), its chunked streaming bodies
(a body that is an iterator of bytes) and its fault-injection shim: before
dispatch every request consults ``server:<service>:<path>``
(:func:`~predictionio_tpu_torch.common.faults.check`) for a latency, an
error reply, a dropped connection, or a streamed body torn mid-chunk. One
difference: ``stop()`` also shuts the connections still open. Stdlib only.
"""

from __future__ import annotations

import email.utils
import json
import re
import socket
import threading
import time
import urllib.parse
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional

from predictionio_tpu_torch.common import faults as _faults
from predictionio_tpu_torch.obs import tracing as _tracing


@dataclass
class Request:
    method: str
    path: str
    params: dict[str, str]  # query params (first value)
    headers: Any
    body: bytes
    match: Optional[re.Match] = None
    # the sampled obs trace riding this request (None when unsampled or
    # telemetry is not installed); handlers pass it to async stages
    trace: Any = None

    def json(self) -> Any:
        if not self.body:
            return None
        return json.loads(self.body.decode("utf-8"))

    def form(self) -> dict[str, str]:
        pairs = urllib.parse.parse_qsl(self.body.decode("utf-8"))
        return dict(pairs)


@dataclass
class Response:
    status: int = 200
    # JSON-serializable, str (text/html), bytes, or an ITERATOR of bytes
    # (sent with Transfer-Encoding: chunked, one chunk a piece)
    body: Any = None
    content_type: Optional[str] = None
    headers: dict[str, str] = field(default_factory=dict)


def json_response(status: int, obj: Any) -> Response:
    return Response(status=status, body=obj)


# The serve path writes ONE buffer per response: a pre-encoded status line +
# static headers, a per-second cached Date, Content-Length, then the payload
# — instead of BaseHTTPRequestHandler's one-write-per-header.

_SERVER_HDR = b"Server: pio-torch\r\n"
_STATUS_LINES: dict[int, bytes] = {}
_DATE_CACHE: tuple[int, bytes] = (0, b"")


def _status_line(status: int) -> bytes:
    line = _STATUS_LINES.get(status)
    if line is None:
        from http import HTTPStatus

        try:
            phrase = HTTPStatus(status).phrase
        except ValueError:
            phrase = ""
        line = f"HTTP/1.1 {status} {phrase}\r\n".encode("ascii")
        _STATUS_LINES[status] = line
    return line


def _date_hdr() -> bytes:
    global _DATE_CACHE
    now = int(time.time())
    sec, hdr = _DATE_CACHE
    if sec != now:
        hdr = ("Date: " + email.utils.formatdate(now, usegmt=True) + "\r\n").encode(
            "ascii"
        )
        # racing threads rebuild the same (second, header) pair; last write
        # wins and every value is correct, so no lock is needed
        # pio: ignore[race-global-write]
        _DATE_CACHE = (now, hdr)
    return hdr


class _Server(ThreadingHTTPServer):
    # the stdlib accept backlog (5) drops bursts of concurrent connects
    request_queue_size = 128
    daemon_threads = True


class HttpService:
    """Route table + threaded server; handlers get Request, return Response."""

    def __init__(self, name: str = "service"):
        self.name = name
        self.routes: list[tuple[str, re.Pattern, Callable[[Request], Response]]] = []
        # literal patterns dispatch through one dict hit instead of the scan
        self._exact: dict[tuple[str, str], Callable[[Request], Response]] = {}
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # obs.Telemetry installed via Telemetry.install(service); the hot
        # loop pays ONE attribute check when absent
        self.telemetry = None
        # open client connections, closed by stop() (see there)
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    def route(self, method: str, pattern: str):
        regex = re.compile("^" + pattern + "$")

        def deco(fn):
            self.routes.append((method.upper(), regex, fn))
            literal = pattern.replace(r"\.", ".")
            if not any(c in literal for c in "[](){}?*+|^$\\"):
                # routes register before serve_forever starts; dispatch only reads
                # pio: ignore[race-unguarded-rmw]
                self._exact[(method.upper(), literal)] = fn
            return fn

        return deco

    def dispatch(self, req: Request) -> Response:
        fn = self._exact.get((req.method, req.path))
        if fn is not None:
            return fn(req)
        path_matched = False
        for method, regex, fn in self.routes:
            m = regex.match(req.path)
            if m:
                path_matched = True
                if method == req.method:
                    req.match = m
                    return fn(req)
        if path_matched:
            return json_response(405, {"message": "method not allowed"})
        return json_response(404, {"message": "not found"})

    # -- server lifecycle ---------------------------------------------------
    def start(
        self,
        host: str = "0.0.0.0",
        port: int = 7070,
        cert_path: Optional[str] = None,
        key_path: Optional[str] = None,
    ) -> int:
        """Start serving; TLS when a certificate is given (parity: the
        reference servers' optional HTTPS, common SSLConfiguration)."""
        service = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # silence default stderr spam
                pass

            def setup(self):
                super().setup()
                with service._conns_lock:
                    service._conns.add(self.connection)

            def finish(self):
                try:
                    super().finish()
                finally:
                    with service._conns_lock:
                        service._conns.discard(self.connection)

            def _handle(self, method: str):
                parsed = urllib.parse.urlsplit(self.path)
                params = dict(urllib.parse.parse_qsl(parsed.query))
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                # the truncate flag is per REQUEST, not per connection: a
                # keep-alive socket must not carry a stale fault into a
                # response the seeded plan never scheduled
                self._fault_truncate = False
                # fault-injection shim: one None check with no plan installed
                act = _faults.check(f"server:{service.name}:{parsed.path}")
                if act is not None:
                    if act.latency_s:
                        time.sleep(act.latency_s)
                    if act.kind == "drop":
                        # die without a response: the client sees a reset,
                        # as from a crashed server process
                        self.close_connection = True
                        try:
                            self.connection.shutdown(socket.SHUT_RDWR)
                        except OSError:
                            pass
                        return
                    if act.kind == "error":
                        try:
                            self._send(json_response(
                                act.status, {"message": "injected fault"}
                            ))
                        except (BrokenPipeError, ConnectionResetError):
                            self.close_connection = True
                        return
                    if act.kind == "truncate":
                        # _send cuts a streamed body mid-chunk
                        self._fault_truncate = True
                tel = service.telemetry
                trace = None
                if tel is not None:
                    t_req = time.perf_counter()
                    trace = tel.tracer.begin(
                        request_id=self.headers.get(_tracing.TRACE_HEADER),
                        name=f"{method} {parsed.path}",
                    )
                req = Request(
                    method=method, path=parsed.path, params=params,
                    headers=self.headers, body=body, trace=trace,
                )
                try:
                    if trace is not None:
                        # active-trace scope: downstream stage() calls see it
                        with _tracing.scope((trace,)):
                            resp = service.dispatch(req)
                    else:
                        resp = service.dispatch(req)
                except json.JSONDecodeError as e:
                    resp = json_response(400, {"message": f"invalid JSON: {e}"})
                except Exception as e:  # the route table's boundary: answer 500
                    resp = json_response(500, {"message": str(e)})
                if trace is not None:
                    resp.headers.setdefault(_tracing.TRACE_HEADER, trace.request_id)
                try:
                    if tel is None:
                        self._send(resp)
                    else:
                        t_send = time.perf_counter()
                        try:
                            self._send(resp)
                        finally:
                            if trace is not None:
                                trace.add_stage("serialize", time.perf_counter() - t_send)
                                trace.finish(status=resp.status)
                                tel.tracer.record(trace)
                            tel.observe_http(
                                method, parsed.path, resp.status,
                                time.perf_counter() - t_req,
                                (method, parsed.path) in service._exact,
                            )
                except (BrokenPipeError, ConnectionResetError):
                    # client went away mid-response; nothing to salvage
                    self.close_connection = True

            def _send(self, resp: Response):
                body, ctype = resp.body, resp.content_type
                if hasattr(body, "__next__"):  # an iterator of bytes: chunked
                    self._send_chunked(resp)
                    return
                if isinstance(body, bytes):
                    payload = body
                    ctype = ctype or "application/octet-stream"
                elif isinstance(body, str):
                    payload = body.encode("utf-8")
                    ctype = ctype or "text/html; charset=utf-8"
                else:
                    payload = json.dumps(body, separators=(",", ":")).encode("utf-8")
                    ctype = ctype or "application/json; charset=utf-8"
                head = [
                    _status_line(resp.status),
                    _SERVER_HDR,
                    _date_hdr(),
                    b"Content-Type: " + ctype.encode("latin-1") + b"\r\n",
                    b"Content-Length: " + str(len(payload)).encode("ascii") + b"\r\n",
                ]
                for k, v in resp.headers.items():
                    head.append(f"{k}: {v}\r\n".encode("latin-1"))
                if self.close_connection:
                    head.append(b"Connection: close\r\n")
                head.append(b"\r\n")
                self.wfile.write(b"".join(head) + payload)

            def _send_chunked(self, resp: Response):
                self.send_response(resp.status)
                self.send_header("Content-Type", resp.content_type or "application/octet-stream")
                self.send_header("Transfer-Encoding", "chunked")
                for k, v in resp.headers.items():
                    self.send_header(k, v)
                self.end_headers()
                for piece in resp.body:
                    if not piece:
                        # an empty chunk is the terminator: skip it, even
                        # when tearing (a zero-length cut would end the
                        # stream cleanly)
                        continue
                    if self._fault_truncate:
                        # chaos: tear the stream mid-piece (half a frame, no
                        # terminal chunk); the client must see a truncated
                        # stream, never a short but valid result
                        cut = piece[: max(1, len(piece) // 2)]
                        self.wfile.write(f"{len(cut):x}\r\n".encode() + cut + b"\r\n")
                        self.close_connection = True
                        try:
                            self.connection.shutdown(socket.SHUT_RDWR)
                        except OSError:
                            pass
                        return
                    self.wfile.write(f"{len(piece):x}\r\n".encode() + piece + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")

            def do_GET(self):
                self._handle("GET")

            def do_POST(self):
                self._handle("POST")

            def do_DELETE(self):
                self._handle("DELETE")

            def do_PUT(self):
                self._handle("PUT")

        self._server = _Server((host, port), Handler)
        if cert_path:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(cert_path, key_path)
            self._server.socket = ctx.wrap_socket(self._server.socket, server_side=True)
        actual_port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name=f"{self.name}-http", daemon=True
        )
        self._thread.start()
        return actual_port

    def stop(self) -> None:
        """Stop accepting, then shut the connections still open: a client
        on a keep-alive connection learns at once that the server is gone
        (it would otherwise wait out its own timeout while the process
        exits), and ``server_close`` need not wait for its handler."""
        if self._server is not None:
            self._server.shutdown()
            with self._conns_lock:
                conns = list(self._conns)
            for conn in conns:
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass  # already closed by its client
            self._server.server_close()
            self._server = None

    def serve_forever(self) -> None:
        if self._thread is not None:
            self._thread.join()
