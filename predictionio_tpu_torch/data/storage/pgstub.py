"""In-repo PostgreSQL wire-protocol stub server for conformance tests.

Copy of ``predictionio_tpu/data/storage/pgstub.py`` for the port (so that
``chip_smoke.py`` runs it with nothing of the JAX package), with
``TCP_NODELAY`` on its sockets, plain ``?`` binds where the driver's
``$1..$n`` run in order, and result rows sent in batches.

The ``s3stub`` discipline applied to the JDBC role: the stub speaks the
REAL v3 wire protocol — startup, md5 and full SCRAM-SHA-256 verification
(proof checked against a stored key, server signature returned), the
extended query protocol (Parse/Bind/Describe/Execute/Sync) and simple
Query — so :mod:`postgres` is exercised against genuine protocol framing
and auth math, not a mock of itself. Statements execute on a private
sqlite database through a small PostgreSQL→sqlite dialect shim; the same
driver runs unchanged against a real PostgreSQL.

NOT a general PostgreSQL: it implements exactly what a storage client
needs (one unnamed statement/portal, text format, the dialect subset the
driver emits).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import re
import secrets
import socket
import socketserver
import sqlite3
import struct
import threading

OID_BOOL, OID_BYTEA, OID_INT8, OID_TEXT, OID_FLOAT8 = 16, 17, 20, 25, 701

_DIALECT = [
    (re.compile(r"\bBIGSERIAL PRIMARY KEY\b", re.I),
     "INTEGER PRIMARY KEY AUTOINCREMENT"),
    (re.compile(r"\bDOUBLE PRECISION\b", re.I), "REAL"),
    (re.compile(r"\bBIGINT\b", re.I), "INTEGER"),
    (re.compile(r"\bBYTEA\b", re.I), "BLOB"),
    (re.compile(r"\bstrpos\(", re.I), "instr("),
]


def _to_sqlite(sql: str) -> str:
    for pat, rep in _DIALECT:
        sql = pat.sub(rep, sql)
    # positional $N → sqlite's ?N (same indices); when they run 1..n in
    # order, as the driver writes them, plain ? binds the same values and
    # is much faster: sqlite's numbered parameters made a 256-row INSERT
    # about 25 times slower
    nums = [int(m) for m in re.findall(r"\$(\d+)", sql)]
    if nums == list(range(1, len(nums) + 1)):
        return re.sub(r"\$\d+", "?", sql)
    return re.sub(r"\$(\d+)", r"?\1", sql)


class _ScramVerifier:
    """Server-side SCRAM-SHA-256 state for one user (RFC 5802/7677)."""

    def __init__(self, password: str, iterations: int = 4096):
        self.salt = secrets.token_bytes(16)
        self.iterations = iterations
        salted = hashlib.pbkdf2_hmac(
            "sha256", password.encode(), self.salt, iterations
        )
        client_key = hmac.new(salted, b"Client Key", hashlib.sha256).digest()
        self.stored_key = hashlib.sha256(client_key).digest()
        self.server_key = hmac.new(
            salted, b"Server Key", hashlib.sha256
        ).digest()

    def server_first(self, client_nonce: str) -> tuple[str, str]:
        nonce = client_nonce + base64.b64encode(
            secrets.token_bytes(18)
        ).decode()
        msg = (
            f"r={nonce},s={base64.b64encode(self.salt).decode()},"
            f"i={self.iterations}"
        )
        return nonce, msg

    def verify_final(self, client_first_bare: str, server_first: str,
                     client_final: str) -> tuple[bool, str]:
        bare = client_final.rsplit(",p=", 1)[0]
        proof = base64.b64decode(client_final.rsplit(",p=", 1)[1])
        auth_message = f"{client_first_bare},{server_first},{bare}".encode()
        client_sig = hmac.new(
            self.stored_key, auth_message, hashlib.sha256
        ).digest()
        client_key = bytes(a ^ b for a, b in zip(proof, client_sig))
        ok = hashlib.sha256(client_key).digest() == self.stored_key
        server_sig = hmac.new(
            self.server_key, auth_message, hashlib.sha256
        ).digest()
        return ok, "v=" + base64.b64encode(server_sig).decode()


class PGStub:
    """Threaded stub server; ``users`` maps user → password."""

    def __init__(self, users: dict | None = None, auth: str = "scram",
                 lc_ctype: str = "en_US.UTF-8"):
        if auth not in ("scram", "md5", "trust"):
            raise ValueError(f"auth must be scram|md5|trust, got {auth!r}")
        self.users = users or {"pio": "pio-secret"}
        self.auth = auth
        # the database's character classification, as `SHOW lc_ctype`
        # reports it; under C or POSIX lower() folds ASCII only
        self.lc_ctype = lc_ctype
        self._scram = {
            u: _ScramVerifier(p) for u, p in self.users.items()
        }
        self.db = sqlite3.connect(":memory:", check_same_thread=False)
        self.db_lock = threading.RLock()
        # PG folds Unicode in lower() under a UTF-8 locale; sqlite's
        # builtin is ASCII-only, which is what PG's C/POSIX locale does —
        # shadow it only for the former so the stub matches the server
        if lc_ctype.upper() not in ("C", "POSIX"):
            self.db.create_function(
                "lower", 1, lambda s: s.lower() if isinstance(s, str) else s,
                deterministic=True,
            )
        # the server-side shard hash: the driver installs a plpgsql
        # pio_crc32 (no-op'd by the dialect shim); the stub provides the
        # SAME function as a Python UDF (both equal zlib.crc32)
        import zlib

        self.db.create_function(
            "pio_crc32", 1,
            lambda s: zlib.crc32(s.encode("utf-8")) if s is not None else 0,
            deterministic=True,
        )
        self._server: socketserver.ThreadingTCPServer | None = None

    # -- lifecycle ----------------------------------------------------------
    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        stub = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    _Session(stub, self.request).run()
                except (ConnectionError, OSError):
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        threading.Thread(
            target=self._server.serve_forever, daemon=True
        ).start()
        return self._server.server_address[1]

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        with self.db_lock:
            self.db.close()


class _Session:
    def __init__(self, stub: PGStub, sock: socket.socket):
        self.stub = stub
        self.sock = sock
        # replies are several small messages: send each without waiting
        # for the client's delayed ACK
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.buf = b""
        self.stmt_sql = ""
        self.stmt_oids: list[int] = []
        self.params: list = []

    # framing ---------------------------------------------------------------
    def _recv_exact(self, n: int) -> bytes:
        while len(self.buf) < n:
            piece = self.sock.recv(65536)
            if not piece:
                raise ConnectionError("client gone")
            self.buf += piece
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def _send(self, t: bytes, payload: bytes = b"") -> None:
        self.sock.sendall(t + struct.pack("!I", len(payload) + 4) + payload)

    def _error(self, message: str, code: str = "XX000") -> None:
        fields = (
            b"SERROR\x00" + b"C" + code.encode() + b"\x00"
            + b"M" + message.encode() + b"\x00\x00"
        )
        self._send(b"E", fields)

    def _ready(self) -> None:
        self._send(b"Z", b"I")

    # startup + auth --------------------------------------------------------
    def _startup(self) -> bool:
        (ln,) = struct.unpack("!I", self._recv_exact(4))
        body = self._recv_exact(ln - 4)
        (code,) = struct.unpack("!I", body[:4])
        if code == 80877103:  # SSLRequest → not supported
            self.sock.sendall(b"N")
            return self._startup()
        if code != 196608:
            self._error(f"unsupported protocol {code}")
            return False
        parts = body[4:].split(b"\x00")
        kv = dict(zip(parts[0::2], parts[1::2]))
        self.user = kv.get(b"user", b"").decode()
        if self.stub.auth == "trust":
            self._send(b"R", struct.pack("!I", 0))
        elif self.stub.auth == "md5":
            if not self._auth_md5():
                return False
        else:
            if not self._auth_scram():
                return False
        self._send(
            b"S", b"server_version\x00pgstub 16 (predictionio_tpu_torch)\x00"
        )
        self._send(b"K", struct.pack("!II", 1, 1))
        self._ready()
        return True

    def _recv_password(self) -> bytes:
        t = self._recv_exact(1)
        (ln,) = struct.unpack("!I", self._recv_exact(4))
        body = self._recv_exact(ln - 4)
        if t != b"p":
            raise ConnectionError(f"expected password message, got {t!r}")
        return body

    def _auth_md5(self) -> bool:
        salt = secrets.token_bytes(4)
        self._send(b"R", struct.pack("!I", 5) + salt)
        got = self._recv_password().rstrip(b"\x00")
        password = self.stub.users.get(self.user)
        if password is None:
            self._error(f"no such role {self.user!r}", "28000")
            return False
        inner = hashlib.md5(
            password.encode() + self.user.encode()
        ).hexdigest()
        want = b"md5" + hashlib.md5(inner.encode() + salt).hexdigest().encode()
        if not hmac.compare_digest(got, want):
            self._error("password authentication failed", "28P01")
            return False
        self._send(b"R", struct.pack("!I", 0))
        return True

    def _auth_scram(self) -> bool:
        self._send(b"R", struct.pack("!I", 10) + b"SCRAM-SHA-256\x00\x00")
        body = self._recv_password()
        mech_end = body.index(b"\x00")
        if body[:mech_end] != b"SCRAM-SHA-256":
            self._error("unknown SASL mechanism", "28000")
            return False
        (ln,) = struct.unpack("!I", body[mech_end + 1:mech_end + 5])
        client_first = body[mech_end + 5:mech_end + 5 + ln].decode()
        # gs2 header "n,," then bare
        bare = client_first.split(",", 2)[2]
        client_nonce = dict(
            p.split("=", 1) for p in bare.split(",")
        )["r"]
        verifier = self.stub._scram.get(self.user)
        if verifier is None:
            self._error(f"no such role {self.user!r}", "28000")
            return False
        nonce, server_first = verifier.server_first(client_nonce)
        self._send(
            b"R", struct.pack("!I", 11) + server_first.encode()
        )
        final = self._recv_password().decode()
        attrs = dict(
            p.split("=", 1) for p in final.split(",") if "=" in p
        )
        if attrs.get("r") != nonce:
            self._error("SCRAM nonce mismatch", "28P01")
            return False
        ok, server_final = verifier.verify_final(bare, server_first, final)
        if not ok:
            self._error("password authentication failed", "28P01")
            return False
        self._send(b"R", struct.pack("!I", 12) + server_final.encode())
        self._send(b"R", struct.pack("!I", 0))
        return True

    # query handling --------------------------------------------------------
    def _decode_param(self, raw: bytes | None, oid: int):
        if raw is None:
            return None
        if oid == OID_BYTEA:
            return bytes.fromhex(raw[2:].decode())  # \x hex
        if oid == OID_INT8 or oid in (21, 23):
            return int(raw)
        if oid in (OID_FLOAT8, 700, 1700):
            return float(raw)
        if oid == OID_BOOL:
            return raw == b"t"
        return raw.decode("utf-8")

    @staticmethod
    def _oid_of(v) -> int:
        if isinstance(v, bool):
            return OID_BOOL
        if isinstance(v, int):
            return OID_INT8
        if isinstance(v, float):
            return OID_FLOAT8
        if isinstance(v, (bytes, memoryview)):
            return OID_BYTEA
        return OID_TEXT

    @staticmethod
    def _encode_val(v) -> bytes | None:
        if v is None:
            return None
        if isinstance(v, bool):
            return b"t" if v else b"f"
        if isinstance(v, (bytes, memoryview)):
            return b"\\x" + bytes(v).hex().encode()
        return str(v).encode("utf-8")

    def _run_sql(self) -> None:
        verb0 = (self.stmt_sql.strip().split() or [""])[0].upper()
        if "CREATE OR REPLACE FUNCTION" in self.stmt_sql.upper():
            # plpgsql is PG-only; the stub registered the equivalent UDF
            self._send(b"n")
            self._send(b"C", b"CREATE FUNCTION\x00")
            return
        if (
            verb0 == "SET"
            or "pg_get_serial_sequence" in self.stmt_sql
            or "pg_advisory_" in self.stmt_sql
        ):
            # session SETs and serial-sequence bumps are PG-only; sqlite's
            # AUTOINCREMENT already provides the bump semantics
            self._send(b"n")
            self._send(b"C", f"{verb0 or 'SELECT'} 0".encode() + b"\x00")
            return
        if verb0 == "SHOW" and self.stmt_sql.split()[1].lower() == "lc_ctype":
            self.stmt_sql = "SELECT ? AS lc_ctype"
            self.params = [self.stub.lc_ctype]
        sql = _to_sqlite(self.stmt_sql)
        with self.stub.db_lock:
            cur = self.stub.db.execute(sql, self.params)
            rows = cur.fetchall()
            self.stub.db.commit()
            rowcount = cur.rowcount
        verb = (self.stmt_sql.strip().split() or ["SELECT"])[0].upper()
        if cur.description is not None:
            names = [d[0] for d in cur.description]
            # infer OIDs from the first non-NULL value per column
            oids = []
            for i in range(len(names)):
                oid = OID_TEXT
                for r in rows:
                    if r[i] is not None:
                        oid = self._oid_of(r[i])
                        break
                oids.append(oid)
            desc = struct.pack("!H", len(names))
            for name, oid in zip(names, oids):
                desc += name.encode() + b"\x00"
                desc += struct.pack("!IhIhih", 0, 0, oid, -1, -1, 0)
            self._send(b"T", desc)
            # DataRows leave in sends of ~256 KiB, not a system call a row
            out, size = [], 0
            for r in rows:
                parts = [struct.pack("!H", len(r))]
                for v in r:
                    enc = self._encode_val(v)
                    if enc is None:
                        parts.append(b"\xff\xff\xff\xff")
                    else:
                        parts += [struct.pack("!I", len(enc)), enc]
                row = b"".join(parts)
                out += [b"D", struct.pack("!I", len(row) + 4), row]
                size += len(row) + 5
                if size >= 1 << 18:
                    self.sock.sendall(b"".join(out))
                    out, size = [], 0
            if out:
                self.sock.sendall(b"".join(out))
            tag = f"{verb} {len(rows)}"
        else:
            self._send(b"n")  # NoData
            n = max(0, rowcount)
            tag = f"INSERT 0 {n}" if verb == "INSERT" else f"{verb} {n}"
        self._send(b"C", tag.encode() + b"\x00")

    def run(self) -> None:
        if not self._startup():
            return
        while True:
            t = self._recv_exact(1)
            (ln,) = struct.unpack("!I", self._recv_exact(4))
            body = self._recv_exact(ln - 4)
            if t == b"X":
                return
            if t == b"Q":  # simple query (pio status smoke, DDL)
                self.stmt_sql = body.rstrip(b"\x00").decode()
                self.params = []
                try:
                    self._run_sql()
                except sqlite3.Error as e:
                    self._error(str(e))
                self._ready()
            elif t == b"P":
                off = body.index(b"\x00") + 1  # unnamed stmt
                end = body.index(b"\x00", off)
                self.stmt_sql = body[off:end].decode()
                (nparams,) = struct.unpack("!H", body[end + 1:end + 3])
                self.stmt_oids = list(
                    struct.unpack(
                        f"!{nparams}I",
                        body[end + 3:end + 3 + 4 * nparams],
                    )
                )
                self._send(b"1")
            elif t == b"B":
                off = body.index(b"\x00") + 1  # portal
                off = body.index(b"\x00", off) + 1  # stmt
                (nfmt,) = struct.unpack("!H", body[off:off + 2])
                off += 2 + 2 * nfmt  # all-text expected
                (nparams,) = struct.unpack("!H", body[off:off + 2])
                off += 2
                self.params = []
                for i in range(nparams):
                    (pln,) = struct.unpack("!i", body[off:off + 4])
                    off += 4
                    raw = None
                    if pln != -1:
                        raw = body[off:off + pln]
                        off += pln
                    oid = (
                        self.stmt_oids[i]
                        if i < len(self.stmt_oids) else OID_TEXT
                    )
                    self.params.append(self._decode_param(raw, oid))
                self._send(b"2")
            elif t == b"D":
                pass  # RowDescription is emitted with Execute
            elif t == b"E":
                try:
                    self._run_sql()
                except sqlite3.Error as e:
                    self._error(str(e))
            elif t == b"S":
                self._ready()
            elif t == b"H":  # Flush
                pass
            else:
                self._error(f"unhandled message {t!r}")
                self._ready()
