"""Webhook connectors on the port, held against the JAX package.

Each connector (segmentio, mailchimp, examplejson, exampleform) turns the
same payloads into the same :class:`Event` as the JAX package's, and refuses
the same payloads with ``ConnectorError``. Then the two event servers, side
by side on their own sqlite stores, answer the same ``/webhooks/...``
requests alike (statuses and the stored events), the sequence of
``tests/test_event_server.py``'s ``TestWebhooks``. Every server binds port
0 and stops in the fixture's teardown; every request has a 30 s timeout.
"""

import json
import urllib.error
import urllib.parse
import urllib.request
import uuid

import pytest

from predictionio_tpu.data.api import event_server as jax_es
from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.data.storage import sqlite as jax_sqlite
from predictionio_tpu.data.storage.registry import Storage as JaxStorage
from predictionio_tpu.data.webhooks import connector as jax_connector
from predictionio_tpu_torch.data.api import event_server as port_es
from predictionio_tpu_torch.data.storage import base as port_base
from predictionio_tpu_torch.data.storage import sqlite as port_sqlite
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.data.webhooks import connector as port_connector

KEY = "key-hooks-0123456789"

JSON_PAYLOADS = {
    "segmentio": [
        {"type": "track", "userId": "seg-user", "event": "Clicked",
         "properties": {"plan": "pro", "n": 3}, "timestamp": "2026-01-02T03:04:05Z"},
        {"type": "identify", "anonymousId": "anon-7", "traits": {"email": "x@y.z", "age": None}},
        {"type": "page", "userId": "u2", "name": "Home", "properties": {"path": "/"}},
        {"type": "screen", "userId": "u2", "name": "Feed"},
        {"type": "group", "userId": "u3", "groupId": "g1", "traits": {"size": 12}},
        {"type": "alias", "userId": "u4", "previousId": "anon-7"},
        {"type": "nope", "userId": "u"},  # unsupported type
        {"type": "track"},  # no user
    ],
    "examplejson": [
        {"type": "like", "user": "ex-u", "item": "ex-i", "time": "2026-02-01T00:00:00Z"},
        {"type": "view", "user": 17},
        {"type": "like"},  # missing user
    ],
}
FORM_PAYLOADS = {
    "mailchimp": [
        {"type": "subscribe", "fired_at": "2026-01-02 03:04:05", "data[email]": "a@b.com",
         "data[list_id]": "L1"},
        {"type": "unsubscribe", "data[id]": "id-9", "data[reason]": "manual"},
        {"type": "profile", "data[email]": "c@d.com", "data[merges][FNAME]": "Zoë"},
        {"type": "upemail", "data[old_email]": "o@x.com", "data[new_email]": "n@x.com"},
        {"type": "cleaned", "data[email]": "gone@x.com", "data[reason]": "hard"},
        {"type": "campaign", "data[id]": "camp-1", "data[subject]": "Hi"},
        {"type": "cleaned"},  # no entity id
        {"type": "bounce", "data[email]": "a@b.com"},  # unsupported type
    ],
    "exampleform": [
        {"type": "share", "userId": "ex-u2", "itemId": "ex-i2", "timestamp": "2026-03-01T00:00:00Z"},
        {"type": "share", "userId": "ex-u3"},
        {"userId": "ex-u4"},  # no type
    ],
}


TIME_FIELDS = ("timestamp", "time", "fired_at")


def _outcome(connector_mod, lookup, name, payload):
    """The connector's Event as its JSON dict without the self-stamped
    creation time (and event time, where the payload gives none), or the
    refusal's class name."""
    try:
        e = connector_mod.connector_to_event(lookup(name), payload)
    except (connector_mod.ConnectorError, ValueError, KeyError) as err:
        return type(err).__name__
    d = e.to_dict()
    d.pop("creationTime")
    if not any(f in payload for f in TIME_FIELDS):
        d.pop("eventTime")
    return d


@pytest.mark.parametrize("name,i", [(n, i) for n, ps in JSON_PAYLOADS.items() for i in range(len(ps))])
def test_json_connectors_make_the_jax_events(name, i):
    payload = JSON_PAYLOADS[name][i]
    got = _outcome(port_connector, port_connector.get_json_connector, name, payload)
    want = _outcome(jax_connector, jax_connector.get_json_connector, name, payload)
    assert got == want


@pytest.mark.parametrize("name,i", [(n, i) for n, ps in FORM_PAYLOADS.items() for i in range(len(ps))])
def test_form_connectors_make_the_jax_events(name, i):
    payload = FORM_PAYLOADS[name][i]
    got = _outcome(port_connector, port_connector.get_form_connector, name, payload)
    want = _outcome(jax_connector, jax_connector.get_form_connector, name, payload)
    assert got == want


def test_the_same_connectors_are_registered():
    for name in ("segmentio", "examplejson"):
        assert type(port_connector.get_json_connector(name)).__name__ == \
            type(jax_connector.get_json_connector(name)).__name__
    for name in ("mailchimp", "exampleform"):
        assert type(port_connector.get_form_connector(name)).__name__ == \
            type(jax_connector.get_form_connector(name)).__name__
    assert port_connector.get_json_connector("mailchimp") is None


def _storage(cls, base, path):
    name = "WH" + uuid.uuid4().hex[:8].upper()
    s = cls(env={f"PIO_STORAGE_SOURCES_{name}_TYPE": "sqlite",
                 f"PIO_STORAGE_SOURCES_{name}_PATH": str(path)})
    app_id = s.get_meta_data_apps().insert(base.App(0, "Hooks"))
    s.get_meta_data_access_keys().insert(base.AccessKey(KEY, app_id, []))
    s.get_meta_data_access_keys().insert(base.AccessKey("key-track-only-0123", app_id, ["track"]))
    return s


@pytest.fixture()
def servers(tmp_path):
    started = []
    try:
        for name, mod, cls, base in (("jax", jax_es, JaxStorage, jax_base),
                                     ("port", port_es, Storage, port_base)):
            srv = mod.EventServer(storage=_storage(cls, base, tmp_path / f"{name}.db"),
                                  telemetry=False)
            started.append((name, srv, f"http://127.0.0.1:{srv.start('127.0.0.1', 0)}"))
        yield {name: base_url for name, _, base_url in started}
    finally:
        for _, srv, _ in started:
            srv.stop()
        port_sqlite.close_all_dbs()
        jax_sqlite.close_all_dbs()


def _request(base, method, path, body=None, form=None):
    if form is not None:
        data, ctype = urllib.parse.urlencode(form).encode(), "application/x-www-form-urlencoded"
    else:
        data = json.dumps(body).encode() if body is not None else None
        ctype = "application/json"
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _session(base):
    """Every payload through the routes, probes and refusals; then the
    stored events. Event ids and the self-stamped times are stripped (the
    connector tests above hold the event times a payload gives)."""
    out = []
    k = f"?accessKey={KEY}"
    for name, payloads in JSON_PAYLOADS.items():
        for p in payloads:
            status, _ = _request(base, "POST", f"/webhooks/{name}.json{k}", p)
            out.append((name, status))
    for name, payloads in FORM_PAYLOADS.items():
        for p in payloads:
            status, _ = _request(base, "POST", f"/webhooks/{name}.form{k}", form=p)
            out.append((name, status))
    for method, path in (("GET", "/webhooks/segmentio.json"), ("GET", "/webhooks/mailchimp.form"),
                         ("GET", "/webhooks/mailchimp.json"), ("POST", "/webhooks/zzz.json"),
                         ("GET", "/webhooks/zzz.form")):
        out.append((method, path, _request(base, method, path + k, {} if method == "POST" else None)))
    # no key, a wrong key, and an event the key does not allow
    out.append(_request(base, "POST", "/webhooks/segmentio.json", JSON_PAYLOADS["segmentio"][0])[0])
    out.append(_request(base, "POST", "/webhooks/segmentio.json?accessKey=nope",
                        JSON_PAYLOADS["segmentio"][0])[0])
    out.append(_request(base, "POST", "/webhooks/segmentio.json?accessKey=key-track-only-0123",
                        JSON_PAYLOADS["segmentio"][2]))
    status, events = _request(base, "GET", f"/events.json{k}&limit=-1")
    for e in events:
        e.pop("eventId"), e.pop("creationTime"), e.pop("eventTime")
    out.append((status, sorted(json.dumps(e, sort_keys=True) for e in events)))
    return out


def test_event_servers_answer_webhooks_alike(servers):
    port, ref = _session(servers["port"]), _session(servers["jax"])
    assert port == ref
    stored = port[-1][1]
    assert port[-1][0] == 200 and len(stored) == 16  # every accepted payload, stored once
    assert any('"plan": "pro"' in e and '"event": "track"' in e for e in stored)
