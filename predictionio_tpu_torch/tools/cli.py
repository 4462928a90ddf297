"""``pio`` CLI of the port: the operator surface of the quickstart.

Counterpart of ``predictionio_tpu/tools/cli.py`` (parity:
``tools/.../console/Console.scala:134-827``), with the verbs the quickstart
and its operators run and the same argument names and ``[INFO]``/``[ERROR]``
lines: ``version``, ``status``, ``build``, ``app``, ``accesskey``, ``train``,
``deploy``, ``undeploy``, ``eventserver``, ``template`` and ``loadtest``.

    python -m predictionio_tpu_torch.tools.cli <verb> ...

``train`` and ``deploy`` run on the CUDA card unless given ``--device cpu``;
without a card they exit non-zero with the ``DeviceContext`` error (the
JAX package pins its platform from ``JAX_PLATFORMS`` instead). The device
is never read from ``engine.json``. SIGTERM drains either server (in-flight
work finishes inside ``PIO_DRAIN_TIMEOUT_MS``) and exits 0.

Not ported yet, and failing with an error that names the ROADMAP item that
brings them: the other templates (item 11), the fleet options of
``deploy`` (item 13), and ``eventserver --ingest-buffer``/``--wal-dir``
(item 14). The options that only tune those features (``eventserver
--flush-ms/--buffer-max``) come with them, and the parser rejects them until
then; the other verbs of the JAX CLI are not here at all.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Optional

from predictionio_tpu_torch import __version__

logger = logging.getLogger("pio")


def _storage():
    from predictionio_tpu_torch.data.storage.registry import Storage

    return Storage.instance()


def _die(msg: str, code: int = 1) -> int:
    print(f"[ERROR] {msg}", file=sys.stderr)
    return code


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to predictionio_tpu_torch yet (ROADMAP §1 item {item})"
    )


# -- engine.json handling ----------------------------------------------------


def load_variant(args) -> dict:
    engine_dir = getattr(args, "engine_dir", None) or os.getcwd()
    path = getattr(args, "variant", None) or os.path.join(engine_dir, "engine.json")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found. Run from an engine directory or pass --variant."
        )
    # user engine code lives beside engine.json: make it importable for the
    # engineFactory (parity: `pio build` compiles the engine directory)
    for p in (engine_dir, os.path.dirname(os.path.abspath(path))):
        if p and p not in sys.path:
            sys.path.insert(0, p)
    with open(path) as f:
        variant = json.load(f)
    if "engineFactory" not in variant:
        raise ValueError(f"{path} has no engineFactory field")
    return variant


def engine_identity(variant: dict) -> tuple[str, str, str]:
    """(engine_id, engine_version, engine_variant) from the variant JSON."""
    return (
        variant.get("engineId", variant["engineFactory"]),
        variant.get("engineVersion", "default"),
        variant.get("id", "default"),
    )


def resolve_engine_from_variant(variant: dict):
    from predictionio_tpu_torch.core.workflow import resolve_engine

    return resolve_engine(variant["engineFactory"])


def make_ctx(variant: dict, device: str):
    """The compute context on ``device`` (``--device``); ``variant["mesh"]``
    is recorded on the instance and never picks the device."""
    from predictionio_tpu_torch.device import DeviceContext

    return DeviceContext.create(conf=variant.get("mesh") or {}, device=device)


def load_plugins(paths: list[str], group: Optional[str] = None) -> list:
    """Explicit ``--plugin dotted.path.Class`` instances + auto-discovered
    entry-point/``PIO_PLUGINS`` plugins (the ServiceLoader role,
    EngineServerPluginContext.scala:34-97 — ``serving/plugins.py``)."""
    from predictionio_tpu_torch.core.persistence import resolve_class
    from predictionio_tpu_torch.serving.plugins import ENGINE_GROUP, discover_plugins

    explicit = [resolve_class(p)() for p in paths or []]
    seen = {type(p) for p in explicit}
    return explicit + [
        p for p in discover_plugins(group or ENGINE_GROUP) if type(p) not in seen
    ]


BUILTIN_TEMPLATES = {
    "recommendation": "predictionio_tpu_torch.templates.recommendation.RecommendationEngine",
    "sequentialrecommendation": (
        "predictionio_tpu_torch.templates.sequentialrecommendation."
        "SequentialRecommendationEngine"
    ),
}
# the JAX package's other templates
WAITING_TEMPLATES = (
    "classification", "similarproduct", "similaruser", "ecommercerecommendation",
    "universalrecommender", "python",
)


def _install_drain_handler(server) -> None:
    """SIGTERM → graceful drain → exit 0 (the orchestrator contract: a
    TERM'd server finishes in-flight work inside PIO_DRAIN_TIMEOUT_MS and
    exits 0, instead of dropping it on the floor)."""
    import signal

    def _term(signum, frame):
        server.drain()
        raise SystemExit(0)

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:
        pass  # not the main thread (embedded use)


# -- verbs --------------------------------------------------------------------


def cmd_version(args) -> int:
    print(__version__)
    return 0


def cmd_status(args) -> int:
    # parity: `pio status` → Storage.verifyAllDataObjects smoke check
    try:
        storage = _storage()
        for repo, (source, stype) in sorted(storage.repository_bindings().items()):
            print(f"[INFO] {repo:<9} -> source {source} (type {stype})")
        ok = storage.verify_all_data_objects()
    except Exception as e:
        return _die(f"Unable to connect to all storage backends: {e}")
    if ok:
        print("[INFO] All storage backends are properly configured.")
        print("Your system is all ready to go.")
        return 0
    return _die("Storage verification failed.")


def cmd_build(args) -> int:
    """Compile check: resolve the engine factory and bind the variant params."""
    variant = load_variant(args)
    engine = resolve_engine_from_variant(variant)
    engine.params_from_variant(variant)
    print(f"[INFO] Engine {variant['engineFactory']} is ready for training.")
    return 0


def _channel_named(channels, app_id: int, name: str):
    return next((c for c in channels.get_by_app_id(app_id) if c.name == name), None)


def cmd_app(args) -> int:
    from predictionio_tpu_torch.data.storage.base import AccessKey, App, Channel

    storage = _storage()
    apps = storage.get_meta_data_apps()
    keys = storage.get_meta_data_access_keys()
    channels = storage.get_meta_data_channels()
    levents = storage.get_l_events()
    cmd = args.app_command

    if cmd == "new":
        app_id = apps.insert(App(0, args.name, args.description))
        if app_id is None:
            return _die(f"App {args.name} already exists.")
        levents.init(app_id)
        key = keys.insert(AccessKey(args.access_key or "", app_id, []))
        print(f"[INFO] App created: ID {app_id}, Name {args.name}.")
        print(f"[INFO] Access Key: {key}")
        return 0
    if cmd == "list":
        print(f"{'ID':>4} {'Name':<24} Access Key")
        for app in apps.get_all():
            for k in keys.get_by_app_id(app.id) or [None]:
                print(f"{app.id:>4} {app.name:<24} {k.key if k else '-'}")
        return 0
    app = apps.get_by_name(args.name)
    if app is None:
        return _die(f"App {args.name} does not exist.")
    if cmd == "show":
        print(f"[INFO] App: ID {app.id}, Name {app.name}, Desc {app.description}")
        for k in keys.get_by_app_id(app.id):
            allowed = "(all)" if not k.events else ",".join(k.events)
            print(f"[INFO] Access Key: {k.key} | Events: {allowed}")
        for c in channels.get_by_app_id(app.id):
            print(f"[INFO] Channel: ID {c.id}, Name {c.name}")
        return 0
    if cmd == "delete":
        for c in channels.get_by_app_id(app.id):
            levents.remove(app.id, c.id)
            channels.delete(c.id)
        levents.remove(app.id)
        for k in keys.get_by_app_id(app.id):
            keys.delete(k.key)
        apps.delete(app.id)
        print(f"[INFO] App {args.name} deleted.")
        return 0
    if cmd == "data-delete":
        channel_id = None
        if args.channel:
            channel = _channel_named(channels, app.id, args.channel)
            if channel is None:
                return _die(f"Channel {args.channel} does not exist.")
            channel_id = channel.id
        levents.remove(app.id, channel_id)
        levents.init(app.id, channel_id)
        print(f"[INFO] Data of app {args.name} deleted.")
        return 0
    if cmd == "channel-new":
        cid = channels.insert(Channel(0, args.channel, app.id))
        if cid is None:
            return _die(f"Invalid channel name {args.channel}.")
        levents.init(app.id, cid)
        print(f"[INFO] Channel created: ID {cid}, Name {args.channel}.")
        return 0
    if cmd == "channel-delete":
        channel = _channel_named(channels, app.id, args.channel)
        if channel is None:
            return _die(f"Channel {args.channel} does not exist.")
        levents.remove(app.id, channel.id)
        channels.delete(channel.id)
        print(f"[INFO] Channel {args.channel} deleted.")
        return 0
    return _die(f"unknown app command {cmd}")


def cmd_accesskey(args) -> int:
    from predictionio_tpu_torch.data.storage.base import AccessKey

    storage = _storage()
    keys = storage.get_meta_data_access_keys()
    if args.ak_command == "new":
        app = storage.get_meta_data_apps().get_by_name(args.app_name)
        if app is None:
            return _die(f"App {args.app_name} does not exist.")
        key = keys.insert(AccessKey("", app.id, args.event or []))
        print(f"[INFO] Access Key: {key}")
        return 0
    if args.ak_command == "list":
        for k in keys.get_all():
            print(f"{k.key} | app {k.app_id} | events {k.events or '(all)'}")
        return 0
    if args.ak_command == "delete":
        if keys.delete(args.key):
            print("[INFO] Deleted.")
            return 0
        return _die("Key not found.")
    return _die(f"unknown accesskey command {args.ak_command}")


def cmd_train(args) -> int:
    from predictionio_tpu_torch.core.workflow import WorkflowParams, run_train

    variant = load_variant(args)
    engine = resolve_engine_from_variant(variant)
    engine_params = engine.params_from_variant(variant)
    engine_id, engine_version, engine_variant = engine_identity(variant)
    ctx = make_ctx(variant, args.device)
    wp = WorkflowParams(
        batch=args.batch or "",
        skip_sanity_check=args.skip_sanity_check,
        stop_after_read=args.stop_after_read,
        stop_after_prepare=args.stop_after_prepare,
    )
    instance_id = run_train(
        engine,
        engine_params,
        engine_factory=variant["engineFactory"],
        storage=_storage(),
        ctx=ctx,
        workflow_params=wp,
        engine_id=engine_id,
        engine_version=engine_version,
        engine_variant=engine_variant,
    )
    print(f"[INFO] Training completed. Engine instance ID: {instance_id}")
    return 0


def cmd_deploy(args) -> int:
    from predictionio_tpu_torch.serving.query_server import QueryServer

    for flag, item in (("fleet", 13), ("autoscale", 13), ("canary", 13),
                       ("tenants", 13), ("pipeline", 13)):
        if getattr(args, flag):
            raise _not_ported(f"deploy --{flag}", item)
    variant = load_variant(args)
    engine = resolve_engine_from_variant(variant)
    engine_id, engine_version, engine_variant = engine_identity(variant)
    qs = QueryServer(
        engine,
        storage=_storage(),
        ctx=make_ctx(variant, args.device),
        engine_id=engine_id,
        engine_version=engine_version,
        engine_variant=engine_variant,
        feedback=args.feedback,
        event_server_url=(
            f"http://{args.event_server_ip}:{args.event_server_port}"
            if args.feedback
            else None
        ),
        access_key=args.accesskey,
        plugins=load_plugins(args.plugin),
        batching=args.batching,
    )
    port = qs.start(args.ip, args.port, cert_path=args.cert_path, key_path=args.key_path)
    _install_drain_handler(qs)
    print(f"[INFO] Engine is deployed and running. Engine API is live at "
          f"http://{args.ip}:{port}.", flush=True)
    try:
        qs.service.serve_forever()
    except KeyboardInterrupt:
        qs.drain()
    return 0


def cmd_undeploy(args) -> int:
    import http.client
    import urllib.request

    url = f"http://{args.ip}:{args.port}/stop"
    try:
        with urllib.request.urlopen(
            urllib.request.Request(url, method="POST"), timeout=5
        ) as r:
            print(f"[INFO] {r.read().decode()}")
        return 0
    except (http.client.RemoteDisconnected, ConnectionResetError):
        # the server may tear the socket down mid-response: it stopped
        print("[INFO] Server stopped.")
        return 0
    except Exception as e:
        return _die(f"Undeploy failed: {e}")


def cmd_eventserver(args) -> int:
    from predictionio_tpu_torch.data.api.event_server import EventServer
    from predictionio_tpu_torch.serving.plugins import EVENT_GROUP

    es = EventServer(
        storage=_storage(),
        stats=args.stats,
        plugins=load_plugins(args.plugin, group=EVENT_GROUP),
        ingest_mode=args.ingest_buffer,
        wal_dir=args.wal_dir,
    )
    port = es.start(args.ip, args.port, cert_path=args.cert_path, key_path=args.key_path)
    _install_drain_handler(es)
    print(f"[INFO] Event Server is listening at http://{args.ip}:{port}", flush=True)
    try:
        es.service.serve_forever()
    except KeyboardInterrupt:
        es.drain()
    return 0


def cmd_loadtest(args) -> int:
    from predictionio_tpu_torch.tools.loadtest import run_ingest_loadtest, run_loadtest

    url = f"http://{args.ip}:{args.port}"

    def attach_metrics(result: dict) -> dict:
        if not args.scrape_metrics:
            return result
        from predictionio_tpu_torch.tools.loadtest import scrape_metrics, summarize_metrics

        try:
            result["serverMetrics"] = summarize_metrics(scrape_metrics(url))
        except Exception as e:  # report, don't fail the loadtest itself
            result["serverMetrics"] = {"error": str(e)}
        return result

    if args.events:
        # ingest mode: hammer a live Event Server instead of a query server
        if not args.access_key:
            print("[ERROR] --events mode needs --access-key")
            return 1
        result = run_ingest_loadtest(
            url=url,
            access_key=args.access_key,
            events=args.events,
            concurrency=args.concurrency,
            batch_size=args.batch_size,
            channel=args.channel,
            kill_after_s=args.kill_after,
        )
        print(json.dumps(attach_metrics(result)))
        return 0 if result["errors"] == 0 else 1
    samples = {}
    for spec in args.sample or []:
        field, _, vals = spec.partition("=")
        # drop empties (trailing comma) so '' never enters the rotation
        values = [v for v in vals.split(",") if v]
        if not field or not values:
            print(f"[ERROR] --sample expects FIELD=v1,v2,..., got {spec!r}")
            return 1
        samples[field] = values
    if args.scenario:
        # scenario mode: a time-varying open-loop traffic program with
        # per-phase SLO accounting instead of constant closed-loop load
        from predictionio_tpu_torch.tools.scenarios import parse_scenario, run_scenario

        try:
            program = parse_scenario(args.scenario)
        except ValueError as e:
            print(f"[ERROR] bad --scenario: {e}")
            return 1
        result = run_scenario(
            url=url,
            query=json.loads(args.query),
            program=program,
            samples=samples or None,
            concurrency=args.concurrency,
            deadline_ms=args.deadline_ms,
            seed=args.seed,
            zipf_q=args.zipf_q,
            slo_p99_ms=args.slo_p99_ms,
        )
        print(json.dumps(attach_metrics(result)))
        ok = result["errors"] == 0 and result.get("sloHeld", True)
        return 0 if ok else 1
    result = run_loadtest(
        url=url,
        query=json.loads(args.query),
        requests=args.requests,
        concurrency=args.concurrency,
        samples=samples or None,
        deadline_ms=args.deadline_ms,
        kill_after_s=args.kill_after,
        dist=args.dist,
        zipf_s=args.zipf_s,
        zipf_q=args.zipf_q,
    )
    print(json.dumps(attach_metrics(result)))
    return 0 if result["errors"] == 0 else 1


def cmd_template(args) -> int:
    # parity: `pio template list/get` — templates ship in-tree here
    if args.template_command == "list":
        for name, factory in BUILTIN_TEMPLATES.items():
            print(f"{name:<26} {factory}")
        return 0
    if args.template_command == "get":
        name = args.name
        if name in WAITING_TEMPLATES:
            raise _not_ported(f"the {name} template", 11)
        if name not in BUILTIN_TEMPLATES:
            return _die(f"Unknown template {name}. Try `pio template list`.")
        directory = args.directory or name
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "engine.json")
        with open(path, "w") as f:
            json.dump(
                {
                    "id": "default",
                    "description": f"{name} template",
                    "engineFactory": BUILTIN_TEMPLATES[name],
                    "datasource": {"params": {"appName": "CHANGE_ME"}},
                    "algorithms": [],
                },
                f,
                indent=2,
            )
        print(f"[INFO] Engine skeleton created at {path}")
        return 0
    return _die(f"unknown template command {args.template_command}")


# -- parser -------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pio", description="PredictionIO on PyTorch/CUDA: the port's CLI"
    )
    p.add_argument("--verbose", action="store_true")
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("version").set_defaults(func=cmd_version)
    sub.add_parser("status").set_defaults(func=cmd_status)

    def add_engine_args(sp):
        sp.add_argument("--engine-dir", default=None)
        sp.add_argument("--variant", "-v", default=None)

    def add_device_arg(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to train or serve on (default: cuda)")

    sp = sub.add_parser("build")
    add_engine_args(sp)
    sp.set_defaults(func=cmd_build)

    sp = sub.add_parser("app")
    app_sub = sp.add_subparsers(dest="app_command", required=True)
    x = app_sub.add_parser("new")
    x.add_argument("name")
    x.add_argument("--description", default=None)
    x.add_argument("--access-key", default=None)
    app_sub.add_parser("list")
    for verb in ("show", "delete"):
        app_sub.add_parser(verb).add_argument("name")
    x = app_sub.add_parser("data-delete")
    x.add_argument("name")
    x.add_argument("--channel", default=None)
    for verb in ("channel-new", "channel-delete"):
        x = app_sub.add_parser(verb)
        x.add_argument("name")
        x.add_argument("channel")
    sp.set_defaults(func=cmd_app)

    sp = sub.add_parser("accesskey")
    ak_sub = sp.add_subparsers(dest="ak_command", required=True)
    x = ak_sub.add_parser("new")
    x.add_argument("app_name")
    x.add_argument("event", nargs="*")
    ak_sub.add_parser("list")
    ak_sub.add_parser("delete").add_argument("key")
    sp.set_defaults(func=cmd_accesskey)

    sp = sub.add_parser("train")
    add_engine_args(sp)
    add_device_arg(sp)
    sp.add_argument("--batch", default="")
    sp.add_argument("--skip-sanity-check", action="store_true")
    sp.add_argument("--stop-after-read", action="store_true")
    sp.add_argument("--stop-after-prepare", action="store_true")
    sp.set_defaults(func=cmd_train)

    sp = sub.add_parser("deploy")
    add_engine_args(sp)
    add_device_arg(sp)
    sp.add_argument("--ip", default="0.0.0.0")
    sp.add_argument("--port", type=int, default=8000)
    sp.add_argument("--feedback", action="store_true")
    sp.add_argument("--event-server-ip", default="0.0.0.0")
    sp.add_argument("--event-server-port", type=int, default=7070)
    sp.add_argument("--accesskey", default=None)
    sp.add_argument("--plugin", action="append", default=[])
    sp.add_argument("--cert-path", default=None)
    sp.add_argument("--key-path", default=None)
    sp.add_argument("--batching", action="store_true",
                    help="micro-batch concurrent queries into one kernel launch")
    sp.add_argument("--fleet", type=int, default=0, metavar="N")
    sp.add_argument("--autoscale", action="store_true")
    sp.add_argument("--canary", action="store_true")
    sp.add_argument("--tenants", default=None, metavar="PATH_OR_JSON")
    sp.add_argument("--pipeline", default=None, metavar="PATH_OR_JSON")
    sp.set_defaults(func=cmd_deploy)

    sp = sub.add_parser("undeploy")
    sp.add_argument("--ip", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8000)
    sp.set_defaults(func=cmd_undeploy)

    sp = sub.add_parser("eventserver")
    sp.add_argument("--ip", default="0.0.0.0")
    sp.add_argument("--port", type=int, default=7070)
    sp.add_argument("--stats", action="store_true")
    sp.add_argument("--plugin", action="append", default=[])
    sp.add_argument("--cert-path", default=None)
    sp.add_argument("--key-path", default=None)
    sp.add_argument("--ingest-buffer", choices=["off", "durable", "fast"], default=None)
    sp.add_argument("--wal-dir", default=None)
    sp.set_defaults(func=cmd_eventserver)

    sp = sub.add_parser("loadtest")
    sp.add_argument("--ip", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8000)
    sp.add_argument("--query", default='{"user": "u1", "num": 10}')
    sp.add_argument("--requests", type=int, default=200)
    sp.add_argument("--concurrency", type=int, default=8)
    sp.add_argument(
        "--sample", action="append", metavar="FIELD=V1,V2,...",
        help="rotate FIELD through the listed values round-robin, one per "
        "request (mixed-key tail latency instead of one hot payload)",
    )
    sp.add_argument(
        "--dist", choices=("roundrobin", "zipf"), default="roundrobin",
        help="how --sample values are drawn: roundrobin cycles them "
        "evenly; zipf draws Zipf-Mandelbrot skew (early values hottest) "
        "and adds per-key latency percentiles to the report",
    )
    sp.add_argument("--zipf-s", type=float, default=1.1,
                    help="Zipf-Mandelbrot exponent for --dist zipf (higher = hotter head)")
    sp.add_argument("--zipf-q", type=float, default=50.0,
                    help="Zipf-Mandelbrot shift for --dist zipf (higher = flatter head)")
    sp.add_argument(
        "--deadline-ms", type=float, default=None,
        help="per-request X-Request-Deadline budget; over-budget requests "
        "are shed by the server (503/504) and reported separately",
    )
    sp.add_argument(
        "--events", type=int, default=None,
        help="ingest mode: POST this many events at an Event Server "
        "(reports events/s + ack p50/p99) instead of querying",
    )
    sp.add_argument("--access-key", default=None, help="access key for --events mode")
    sp.add_argument(
        "--batch-size", type=int, default=1,
        help="--events mode: events per request (1 = /events.json, "
        ">1 = /batch/events.json)",
    )
    sp.add_argument("--channel", default=None, help="--events mode: target channel name")
    sp.add_argument(
        "--scrape-metrics", action="store_true",
        help="after the run, GET /metrics off the server under test and "
        "include a server-side summary in the JSON report",
    )
    sp.add_argument(
        "--kill-after", type=float, default=None, metavar="SECONDS",
        help="POST /stop to the server this many seconds into the run — "
        "exercises graceful drain under live load; post-stop connection "
        "failures are reported as afterStop, not errors",
    )
    sp.add_argument(
        "--scenario", default=None, metavar="SPEC",
        help="open-loop traffic program instead of constant load: "
        "';'-separated phases of kind:key=val,... (steady, ramp, sine, "
        "flash, zipfdrift, mixshift); reports p50/p99/shed/error per phase",
    )
    sp.add_argument(
        "--slo-p99-ms", type=float, default=None,
        help="--scenario mode: per-phase p99 SLO bound; each phase gets "
        "a sloHeld verdict and the exit code fails if any phase breaks it",
    )
    sp.add_argument(
        "--seed", type=int, default=0,
        help="--scenario mode: seed for the pre-drawn workload schedule "
        "(zipf draws, tenant-mix picks) — same seed, same workload",
    )
    sp.set_defaults(func=cmd_loadtest)

    sp = sub.add_parser("template")
    t_sub = sp.add_subparsers(dest="template_command", required=True)
    t_sub.add_parser("list")
    x = t_sub.add_parser("get")
    x.add_argument("name")
    x.add_argument("--directory", default=None)
    sp.set_defaults(func=cmd_template)
    return p


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.WARNING,
        format="[%(levelname)s] [%(name)s] %(message)s",
    )
    try:
        return args.func(args)
    except BrokenPipeError:
        # `pio status | head` closing the pipe early is not an error
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        return 0
    except (FileNotFoundError, ValueError, RuntimeError) as e:
        # NotImplementedError (a waiting ROADMAP item) is a RuntimeError
        return _die(str(e))


if __name__ == "__main__":
    sys.exit(main())
