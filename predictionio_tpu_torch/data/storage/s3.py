"""S3-compatible model-blob storage driver (pure stdlib, AWS SigV4).

Copy of ``predictionio_tpu/data/storage/s3.py`` for the port: the same
signatures, byte for byte.

Parity: the reference's S3 MODELDATA driver
(``storage/s3/src/main/scala/org/apache/predictionio/data/storage/s3/
S3Models.scala`` — model blobs as S3 objects via the AWS SDK).  The port
depends on no AWS SDK, so the driver speaks the S3 REST protocol directly:
Signature Version 4 request signing implemented with ``hmac``/``hashlib``,
HTTP via ``urllib``.  Works against any S3-compatible endpoint (AWS, MinIO,
localstack, or the in-repo :mod:`s3stub` used by the conformance suite).

Configuration (``PIO_STORAGE_SOURCES_<NAME>_*``):

* ``TYPE=s3``
* ``ENDPOINT``   — e.g. ``http://127.0.0.1:9000`` (default AWS:
  ``https://s3.<region>.amazonaws.com``)
* ``BUCKET``     — required
* ``REGION``     — default ``us-east-1``
* ``ACCESS_KEY`` / ``SECRET_KEY`` — credentials (fall back to
  ``AWS_ACCESS_KEY_ID`` / ``AWS_SECRET_ACCESS_KEY``)
* ``PREFIX``     — object key prefix, default ``models``

Path-style addressing (``endpoint/bucket/key``) is used throughout — the
compatible-server convention (MinIO/localstack) and still accepted by AWS.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import hmac
import logging
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from predictionio_tpu_torch.data.storage import base

logger = logging.getLogger(__name__)

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


class S3StorageError(Exception):
    pass


# ---------------------------------------------------------------------------
# AWS Signature Version 4 (stdlib-only)
# ---------------------------------------------------------------------------


def _uri_encode(value: str, is_key: bool = False) -> str:
    """RFC 3986 encoding per the SigV4 spec; '/' preserved in object keys."""
    return urllib.parse.quote(value, safe="/-_.~" if is_key else "-_.~")


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret_key: str, datestamp: str, region: str, service: str) -> bytes:
    k = _hmac(("AWS4" + secret_key).encode(), datestamp)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def sign_request(
    method: str,
    host: str,
    path: str,
    query: dict[str, str],
    headers: dict[str, str],
    payload_sha256: str,
    access_key: str,
    secret_key: str,
    region: str,
    service: str = "s3",
    amz_date: Optional[str] = None,
) -> dict[str, str]:
    """Return headers with SigV4 ``Authorization`` added.

    Pure function of its inputs (``amz_date`` injectable) so the signature
    can be asserted against AWS's published test vectors.
    """
    if amz_date is None:
        amz_date = _dt.datetime.now(_dt.timezone.utc).strftime("%Y%m%dT%H%M%SZ")
    datestamp = amz_date[:8]

    all_headers = {k.lower(): " ".join(v.split()) for k, v in headers.items()}
    all_headers["host"] = host
    all_headers["x-amz-date"] = amz_date
    if service == "s3":
        all_headers["x-amz-content-sha256"] = payload_sha256

    signed_names = sorted(all_headers)
    canonical_headers = "".join(f"{k}:{all_headers[k]}\n" for k in signed_names)
    signed_headers = ";".join(signed_names)
    canonical_query = "&".join(
        f"{_uri_encode(k)}={_uri_encode(v)}" for k, v in sorted(query.items())
    )
    canonical_request = "\n".join(
        [
            method,
            _uri_encode(path, is_key=True) or "/",
            canonical_query,
            canonical_headers,
            signed_headers,
            payload_sha256,
        ]
    )
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        [
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canonical_request.encode()).hexdigest(),
        ]
    )
    signature = hmac.new(
        signing_key(secret_key, datestamp, region, service),
        string_to_sign.encode(),
        hashlib.sha256,
    ).hexdigest()

    out = dict(headers)
    out["x-amz-date"] = amz_date
    if service == "s3":
        out["x-amz-content-sha256"] = payload_sha256
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}"
    )
    return out


# ---------------------------------------------------------------------------
# Minimal S3 REST client (the operations Models needs)
# ---------------------------------------------------------------------------


class S3Client:
    def __init__(
        self,
        bucket: str,
        endpoint: Optional[str] = None,
        region: str = "us-east-1",
        access_key: Optional[str] = None,
        secret_key: Optional[str] = None,
        timeout: float = 60.0,
    ):
        self.bucket = bucket
        self.region = region
        self.endpoint = (
            endpoint or f"https://s3.{region}.amazonaws.com"
        ).rstrip("/")
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        self.secret_key = secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        if not self.access_key or not self.secret_key:
            raise S3StorageError(
                "s3 storage needs ACCESS_KEY/SECRET_KEY source attributes "
                "(or AWS_ACCESS_KEY_ID/AWS_SECRET_ACCESS_KEY in env)"
            )
        self.timeout = float(timeout)
        self._host = urllib.parse.urlsplit(self.endpoint).netloc

    def _request(
        self, method: str, key: str, body: Optional[bytes] = None
    ) -> tuple[int, bytes]:
        path = f"/{self.bucket}/{key}" if key else f"/{self.bucket}"
        payload = body or b""
        payload_hash = (
            hashlib.sha256(payload).hexdigest() if payload else _EMPTY_SHA256
        )
        headers = sign_request(
            method,
            self._host,
            path,
            {},
            {},
            payload_hash,
            self.access_key,
            self.secret_key,
            self.region,
        )
        req = urllib.request.Request(
            self.endpoint + _uri_encode(path, is_key=True),
            data=body,
            method=method,
            headers=headers,
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
        except urllib.error.URLError as e:
            raise S3StorageError(
                f"S3 endpoint unreachable at {self.endpoint}: {e.reason}"
            ) from None

    def put_object(self, key: str, data: bytes) -> None:
        status, body = self._request("PUT", key, data)
        if status not in (200, 201):
            raise S3StorageError(f"PUT {key}: HTTP {status}: {body[:200]!r}")

    def get_object(self, key: str) -> Optional[bytes]:
        status, body = self._request("GET", key)
        if status == 404:
            # only a missing KEY means "no object"; a missing BUCKET is a
            # configuration error that must not read as "no model trained"
            if b"NoSuchBucket" in body:
                raise S3StorageError(
                    f"bucket {self.bucket!r} does not exist at {self.endpoint}"
                )
            return None
        if status != 200:
            raise S3StorageError(f"GET {key}: HTTP {status}: {body[:200]!r}")
        return body

    def delete_object(self, key: str) -> None:
        status, body = self._request("DELETE", key)
        if status not in (200, 204, 404):
            raise S3StorageError(f"DELETE {key}: HTTP {status}: {body[:200]!r}")


# ---------------------------------------------------------------------------
# Models DAO (parity: S3Models.scala)
# ---------------------------------------------------------------------------


class S3Models(base.Models):
    """MODELDATA repository on an S3-compatible object store."""

    def __init__(
        self,
        source_name: str = "default",
        bucket: Optional[str] = None,
        endpoint: Optional[str] = None,
        region: str = "us-east-1",
        access_key: Optional[str] = None,
        secret_key: Optional[str] = None,
        prefix: str = "models",
        timeout: float = 60.0,
        **_ignored,
    ):
        if not bucket:
            raise S3StorageError(
                f"s3 storage source {source_name!r} needs "
                f"PIO_STORAGE_SOURCES_{source_name}_BUCKET"
            )
        self._client = S3Client(
            bucket=bucket,
            endpoint=endpoint,
            region=region,
            access_key=access_key,
            secret_key=secret_key,
            timeout=float(timeout),
        )
        self._prefix = prefix.strip("/")

    def _key(self, model_id: str) -> str:
        return f"{self._prefix}/pio_model_{model_id}"

    def insert(self, model: base.Model) -> None:
        self._client.put_object(self._key(model.id), model.models)

    def get(self, model_id: str) -> Optional[base.Model]:
        data = self._client.get_object(self._key(model_id))
        if data is None:
            return None
        return base.Model(id=model_id, models=data)

    def delete(self, model_id: str) -> None:
        self._client.delete_object(self._key(model_id))
