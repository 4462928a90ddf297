"""Local S3-compatible object-store stub (the reference's localstack role).

Copy of ``predictionio_tpu/data/storage/s3stub.py`` for the port, on the
port's ``HttpService``.

The reference's storage conformance matrix runs its S3 driver against
``atlassianlabs/localstack`` (``tests/docker-compose.yml:17-45``,
``tests/run_docker.sh:20-46``).  The project runs no containers, so this
module provides the equivalent: an in-process HTTP server speaking enough
of the S3 REST protocol (path-style PUT/GET/DELETE object) to exercise
:mod:`predictionio_tpu_torch.data.storage.s3` end-to-end, **including real SigV4
verification** — it independently reconstructs the canonical request from
the received bytes and rejects bad or missing signatures with 403, so a
signing bug in the client cannot pass silently.

Dev usage: ``python -m predictionio_tpu_torch.data.storage.s3stub --port 9000``.
"""

from __future__ import annotations

import hashlib
import hmac
import logging
import re
import threading
import urllib.parse
from typing import Optional

from predictionio_tpu_torch.common.http import HttpService, Request, Response, json_response
from predictionio_tpu_torch.data.storage.s3 import signing_key

logger = logging.getLogger(__name__)

_AUTH_RE = re.compile(
    r"AWS4-HMAC-SHA256 Credential=(?P<access>[^/]+)/(?P<date>\d{8})/"
    r"(?P<region>[^/]+)/(?P<service>[^/]+)/aws4_request, "
    r"SignedHeaders=(?P<signed>[^,]+), Signature=(?P<sig>[0-9a-f]{64})"
)


def _xml_error(status: int, code: str, message: str) -> Response:
    body = (
        f'<?xml version="1.0" encoding="UTF-8"?>'
        f"<Error><Code>{code}</Code><Message>{message}</Message></Error>"
    )
    return Response(status, body, content_type="application/xml")


class S3Stub:
    """One bucket namespace per (access_key, secret_key) credential pair."""

    def __init__(self, access_key: str = "pio-test", secret_key: str = "pio-secret"):
        self.access_key = access_key
        self.secret_key = secret_key
        self._objects: dict[tuple[str, str], bytes] = {}
        self._lock = threading.Lock()
        self.svc = HttpService("s3stub")
        self._routes()

    # -- SigV4 verification (independent reconstruction) -------------------
    def _verify(self, req: Request) -> Optional[Response]:
        auth = req.headers.get("Authorization", "")
        m = _AUTH_RE.match(auth)
        if not m:
            return _xml_error(403, "AccessDenied", "missing/malformed Authorization")
        if m["access"] != self.access_key:
            return _xml_error(403, "InvalidAccessKeyId", "unknown access key")
        payload_hash = req.headers.get("x-amz-content-sha256", "")
        if hashlib.sha256(req.body or b"").hexdigest() != payload_hash:
            return _xml_error(400, "XAmzContentSHA256Mismatch", "payload hash wrong")
        amz_date = req.headers.get("x-amz-date", "")
        if not amz_date.startswith(m["date"]):
            return _xml_error(403, "AccessDenied", "date scope mismatch")

        signed_names = m["signed"].split(";")
        header_vals = {k: req.headers.get(k) for k in signed_names}
        if any(v is None for v in header_vals.values()):
            return _xml_error(403, "AccessDenied", "signed header absent")
        canonical_headers = "".join(
            f"{k}:{' '.join(v.split())}\n" for k, v in header_vals.items()
        )
        # req.path arrives percent-encoded on the wire; decode then re-encode
        # so the canonical URI matches what the client signed (re-quoting the
        # raw path would double-encode '%')
        quoted_path = urllib.parse.quote(
            urllib.parse.unquote(req.path), safe="/-_.~"
        )
        canonical_query = "&".join(
            f"{urllib.parse.quote(k, safe='-_.~')}={urllib.parse.quote(v, safe='-_.~')}"
            for k, v in sorted(req.params.items())
        )
        canonical_request = "\n".join(
            [
                req.method,
                quoted_path or "/",
                canonical_query,
                canonical_headers,
                m["signed"],
                payload_hash,
            ]
        )
        scope = f"{m['date']}/{m['region']}/{m['service']}/aws4_request"
        string_to_sign = "\n".join(
            [
                "AWS4-HMAC-SHA256",
                amz_date,
                scope,
                hashlib.sha256(canonical_request.encode()).hexdigest(),
            ]
        )
        expected = hmac.new(
            signing_key(self.secret_key, m["date"], m["region"], m["service"]),
            string_to_sign.encode(),
            hashlib.sha256,
        ).hexdigest()
        if not hmac.compare_digest(expected, m["sig"]):
            return _xml_error(403, "SignatureDoesNotMatch", "signature mismatch")
        return None

    # -- routes -------------------------------------------------------------
    def _routes(self):
        svc = self.svc

        @svc.route("GET", r"/")
        def index(req: Request):
            return json_response(200, {"service": "s3stub"})

        @svc.route("PUT", r"/(?P<bucket>[^/]+)/(?P<key>.+)")
        def put_object(req: Request):
            denied = self._verify(req)
            if denied:
                return denied
            with self._lock:
                self._objects[(req.match["bucket"], req.match["key"])] = req.body
            return Response(200, b"", headers={"ETag": '"stub"'})

        @svc.route("GET", r"/(?P<bucket>[^/]+)/(?P<key>.+)")
        def get_object(req: Request):
            denied = self._verify(req)
            if denied:
                return denied
            with self._lock:
                data = self._objects.get((req.match["bucket"], req.match["key"]))
            if data is None:
                return _xml_error(404, "NoSuchKey", "key does not exist")
            return Response(200, data, content_type="application/octet-stream")

        @svc.route("DELETE", r"/(?P<bucket>[^/]+)/(?P<key>.+)")
        def delete_object(req: Request):
            denied = self._verify(req)
            if denied:
                return denied
            with self._lock:
                self._objects.pop((req.match["bucket"], req.match["key"]), None)
            return Response(204, b"")

    # -- lifecycle ----------------------------------------------------------
    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        return self.svc.start(host, port)

    def stop(self) -> None:
        self.svc.stop()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="local S3-compatible stub")
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9000)
    p.add_argument("--access-key", default="pio-test")
    p.add_argument("--secret-key", default="pio-secret")
    args = p.parse_args(argv)
    stub = S3Stub(args.access_key, args.secret_key)
    port = stub.start(args.ip, args.port)
    print(f"s3stub listening on {args.ip}:{port}")
    stub.svc.serve_forever()


if __name__ == "__main__":
    main()
