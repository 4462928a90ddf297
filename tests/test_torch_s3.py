"""The port's S3 model repository: the JAX suite mirrored against both
packages' s3stubs, and SigV4 signatures held byte for byte against the JAX
signer.

Counterpart of ``tests/test_s3_storage.py`` (the AWS published SigV4
vector, round trips, key encoding, refused credentials and a tampered
payload, the registry's ``TYPE=s3``), with the stub parametrized: the
port's ``s3stub`` and the JAX package's both verify the port's signatures.
A seeded sweep of methods, paths, queries, headers, payload hashes and dates
signs byte-equal to JAX ``s3.sign_request``; a blob the JAX client wrote is
read back by the port's and the other way round. Every stub binds port 0
and stops in a ``finally``.
"""

import importlib
import uuid

import numpy as np
import pytest

from predictionio_tpu.data.storage import s3 as jax_s3
from predictionio_tpu.data.storage.base import Model as JaxModel

from predictionio_tpu_torch.data.storage.base import Model
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.data.storage.s3 import (
    S3Client,
    S3Models,
    S3StorageError,
    sign_request,
)


class TestSigV4Vector:
    def test_aws_published_get_vanilla_vector(self):
        """AWS SigV4 test suite vector (get-vanilla, iam.amazonaws.com).

        Credentials, timestamp, and expected signature are from AWS's
        official 'Signature Version 4 test suite' documentation example —
        an external ground truth for the signer.
        """
        headers = sign_request(
            method="GET",
            host="iam.amazonaws.com",
            path="/",
            query={"Action": "ListUsers", "Version": "2010-05-08"},
            headers={
                "content-type": "application/x-www-form-urlencoded; charset=utf-8"
            },
            payload_sha256=(
                "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"
            ),
            access_key="AKIDEXAMPLE",
            secret_key="wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY",
            region="us-east-1",
            service="iam",
            amz_date="20150830T123600Z",
        )
        assert headers["Authorization"] == (
            "AWS4-HMAC-SHA256 "
            "Credential=AKIDEXAMPLE/20150830/us-east-1/iam/aws4_request, "
            "SignedHeaders=content-type;host;x-amz-date, "
            "Signature=5d672d79c15b13162d9279b0855cfba6789a8edb4c82c400e06b"
            "5924a6f2b5d7"
        )


STUBS = {"port": "predictionio_tpu_torch", "jax": "predictionio_tpu"}


@pytest.fixture(params=sorted(STUBS))
def stub(request):
    cls = importlib.import_module(f"{STUBS[request.param]}.data.storage.s3stub").S3Stub
    s = cls(access_key="pio-test", secret_key="pio-secret")
    port = s.start()
    try:
        yield {"stub": s, "port": port, "endpoint": f"http://127.0.0.1:{port}",
               "pkg": request.param}
    finally:
        s.stop()


def make_models(endpoint, **over):
    kw = dict(
        bucket="pio-models",
        endpoint=endpoint,
        region="us-east-1",
        access_key="pio-test",
        secret_key="pio-secret",
    )
    kw.update(over)
    return S3Models(**kw)


class TestS3Models:
    def test_roundtrip_insert_get_delete(self, stub):
        models = make_models(stub["endpoint"])
        blob = b"\x00\x01binary-model-bytes" * 100
        models.insert(Model(id="inst42", models=blob))
        got = models.get("inst42")
        assert got is not None and got.models == blob and got.id == "inst42"
        models.delete("inst42")
        assert models.get("inst42") is None

    def test_key_with_special_characters(self, stub):
        # canonical-URI encoding must agree between signer and verifier for
        # keys outside the unreserved set (spaces, '+', unicode)
        models = make_models(stub["endpoint"])
        blob = b"model"
        models.insert(Model(id="inst 7+xé", models=blob))
        assert models.get("inst 7+xé").models == blob

    def test_get_missing_returns_none(self, stub):
        models = make_models(stub["endpoint"])
        assert models.get("never-inserted") is None

    def test_overwrite_replaces(self, stub):
        models = make_models(stub["endpoint"])
        models.insert(Model(id="m", models=b"v1"))
        models.insert(Model(id="m", models=b"v2"))
        assert models.get("m").models == b"v2"

    def test_wrong_secret_rejected(self, stub):
        models = make_models(stub["endpoint"], secret_key="WRONG")
        with pytest.raises(S3StorageError, match="403"):
            models.insert(Model(id="m", models=b"x"))

    def test_wrong_access_key_rejected(self, stub):
        models = make_models(stub["endpoint"], access_key="WHO")
        with pytest.raises(S3StorageError, match="403"):
            models.insert(Model(id="m", models=b"x"))

    def test_tampered_payload_rejected(self, stub):
        # a request that signs one payload but carries another must be
        # refused (the stub checks x-amz-content-sha256 against the body)
        import urllib.error
        import urllib.request

        from predictionio_tpu_torch.data.storage.s3 import _EMPTY_SHA256

        headers = sign_request(
            method="PUT",
            host=f"127.0.0.1:{stub['port']}",
            path="/pio-models/k",
            query={},
            headers={},
            payload_sha256=_EMPTY_SHA256,  # signed: empty body
            access_key="pio-test",
            secret_key="pio-secret",
            region="us-east-1",
        )
        req = urllib.request.Request(
            stub["endpoint"] + "/pio-models/k",
            data=b"actual-body",  # sent: something else
            method="PUT",
            headers=headers,
        )
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 400
        assert b"XAmzContentSHA256Mismatch" in ei.value.read()

    def test_missing_bucket_config_fails_loudly(self):
        with pytest.raises(S3StorageError, match="BUCKET"):
            S3Models(source_name="S3SRC", bucket=None, access_key="a", secret_key="b")


class TestRegistryIntegration:
    def test_modeldata_via_env_registry(self, stub):
        """The PIO_STORAGE_* env contract resolves TYPE=s3 for MODELDATA."""
        name = "S" + uuid.uuid4().hex[:8].upper()
        storage = Storage(
            env={
                f"PIO_STORAGE_SOURCES_{name}_TYPE": "memory",
                f"PIO_STORAGE_SOURCES_S3M_TYPE": "s3",
                f"PIO_STORAGE_SOURCES_S3M_ENDPOINT": stub["endpoint"],
                f"PIO_STORAGE_SOURCES_S3M_BUCKET": "pio-models",
                f"PIO_STORAGE_SOURCES_S3M_ACCESS_KEY": "pio-test",
                f"PIO_STORAGE_SOURCES_S3M_SECRET_KEY": "pio-secret",
                "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": name,
                "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": name,
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "S3M",
            }
        )
        models = storage.get_model_data_models()
        models.insert(Model(id="from-registry", models=b"pytree-bytes"))
        assert models.get("from-registry").models == b"pytree-bytes"
        from predictionio_tpu_torch.data.storage import memory

        memory.reset_store(name)


# -- the signer and the repository against the JAX package ----------------------



def _sweep(seed, n=60):
    rng = np.random.default_rng(seed)
    words = ["", "a", "Key With Spaces", "é/ü+~", "x=y&z", "..", "a//b", "%41", "*"]
    for _ in range(n):
        pick = lambda: words[int(rng.integers(len(words)))]  # noqa: E731
        yield dict(
            method=["GET", "PUT", "DELETE", "HEAD", "POST"][int(rng.integers(5))],
            host=f"h{int(rng.integers(9))}.example:{int(rng.integers(1, 65535))}",
            path="/" + "/".join(pick() for _ in range(int(rng.integers(0, 4)))),
            query={pick() or "k": pick() for _ in range(int(rng.integers(0, 3)))},
            headers={"Content-Type": "application/octet-stream", "X-Amz-Meta-N": f"  {pick()}  v  "}
            if rng.integers(2) else {},
            payload_sha256=format(int(rng.integers(2**62)), "064x"),
            access_key=f"AK{int(rng.integers(1e6))}", secret_key=f"s/{pick()}+{int(rng.integers(1e9))}",
            region=["us-east-1", "eu-west-3"][int(rng.integers(2))],
            service=["s3", "iam"][int(rng.integers(2))],
            amz_date=f"2026{int(rng.integers(1, 13)):02d}{int(rng.integers(1, 29)):02d}T0{int(rng.integers(10))}1500Z",
        )


class TestAgainstTheJaxSigner:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_signatures_byte_equal(self, seed):
        for kw in _sweep(seed):
            assert sign_request(**kw) == jax_s3.sign_request(**kw), kw

    def test_published_vector_equal_in_both_packages(self):
        kw = dict(method="GET", host="iam.amazonaws.com", path="/",
                  query={"Action": "ListUsers", "Version": "2010-05-08"},
                  headers={"content-type": "application/x-www-form-urlencoded; charset=utf-8"},
                  payload_sha256="e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
                  access_key="AKIDEXAMPLE", secret_key="wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY",
                  region="us-east-1", service="iam", amz_date="20150830T123600Z")
        assert sign_request(**kw) == jax_s3.sign_request(**kw)
        assert sign_request(**kw)["Authorization"].endswith(
            "5d672d79c15b13162d9279b0855cfba6789a8edb4c82c400e06b5924a6f2b5d7")

    def test_blobs_cross_between_the_clients(self, stub):
        ours = make_models(stub["endpoint"])
        theirs = jax_s3.S3Models(bucket="pio-models", endpoint=stub["endpoint"],
                                 region="us-east-1", access_key="pio-test",
                                 secret_key="pio-secret")
        blob = bytes(range(256)) * 40
        theirs.insert(JaxModel(id="jax wrote é", models=blob))
        assert ours.get("jax wrote é").models == blob
        ours.insert(Model(id="port wrote", models=blob[::-1]))
        assert theirs.get("port wrote").models == blob[::-1]
        ours.delete("jax wrote é")
        assert theirs.get("jax wrote é") is None
