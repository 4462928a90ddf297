"""``pio`` CLI of the port: the operator surface of the quickstart.

Counterpart of ``predictionio_tpu/tools/cli.py`` (parity:
``tools/.../console/Console.scala:134-827``), with the verbs the quickstart
and its operators run and the same argument names and ``[INFO]``/``[ERROR]``
lines: ``version``, ``status``, ``build``, ``app``, ``accesskey``, ``train``,
``eval``, ``deploy``, ``undeploy``, ``batchpredict``, ``eventserver``,
``template``, ``loadtest``, ``shards``, ``ivf``, ``fleet``, ``canary``,
``tenants`` and ``pipeline``.

    python -m predictionio_tpu_torch.tools.cli <verb> ...

``train``, ``eval``, ``deploy`` and ``batchpredict`` run on the CUDA card
unless given ``--device cpu``;
without a card they exit non-zero with the ``DeviceContext`` error (the
JAX package pins its platform from ``JAX_PLATFORMS`` instead). The device
is never read from ``engine.json``. SIGTERM drains either server (in-flight
work finishes inside ``PIO_DRAIN_TIMEOUT_MS``) and exits 0.

``eventserver --ingest-buffer off|durable|fast`` puts single-event POSTs
through the write-behind buffer (``--flush-ms``, ``--buffer-max``), and
``--wal-dir`` journals fast-acked events for replay at the next start.
Streaming micro-generations need no option: ``PIO_STREAMING=1`` turns them
on in ``deploy``, and the event plane's publisher is attached through
``EventServer.enable_delta_publisher``, as in the JAX package.

``shards show|rebuild`` inspects or rebuilds a checkpoint-mode instance's
sharding plan (``plan.blob``, written when ``train`` ran under
``PIO_SHARD_COUNT`` or ``PIO_SHARD_HBM_BUDGET``); a live server adopts a
rebuilt plan on ``POST /reload``. ``deploy`` serves a plan sharded only on a
mesh with the plan's placements; on one card (the default mesh) it serves
replicated.

``ivf show|rebuild`` inspects or rebuilds a checkpoint-mode instance's IVF
index (``ivf.blob``); ``rebuild`` reads the instance's sealed factor store,
re-runs the recall gate and reseals the index, which a live server adopts
on ``POST /reload``.

``deploy --fleet N`` turns this process into the router (host code: it
opens no CUDA context) in front of N replica processes, each a re-exec of
this CLI's ``deploy`` on the same ``--device``; ``--autoscale``,
``--canary``, ``--tenants`` and ``--pipeline`` are the JAX package's.
``fleet status|roll`` and ``canary status|start|promote|abort|quarantine``
operate a running router; ``tenants check|list`` and ``pipeline
seal|show`` check configs and inspect a live server.

``template list|get`` knows the seven templates the port serves; the
JAX package's ``python`` template (pypio) fails with an error that names
ROADMAP item 15; the other verbs of the JAX CLI are not here at all.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Optional

from predictionio_tpu_torch import __version__
from predictionio_tpu_torch.core.persistence import ForeignClassError

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
    is recorded on the instance and never picks the device.

    Under ``pio launch`` the context spans the launch's processes, each
    holding one placement: its card, or the CPU under ``--device cpu``."""
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.parallel import distributed

    conf = variant.get("mesh") or {}
    if distributed.initialize():  # no-op unless PIO_COORDINATOR is set
        return DeviceContext.create(conf=conf, devices=[device])
    return DeviceContext.create(conf=conf, device=device)


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
    "classification": "predictionio_tpu_torch.templates.classification.ClassificationEngine",
    "similarproduct": "predictionio_tpu_torch.templates.similarproduct.SimilarProductEngine",
    "similaruser": "predictionio_tpu_torch.templates.similaruser.SimilarUserEngine",
    "ecommercerecommendation": "predictionio_tpu_torch.templates.ecommerce.ECommerceEngine",
    "sequentialrecommendation": (
        "predictionio_tpu_torch.templates.sequentialrecommendation."
        "SequentialRecommendationEngine"
    ),
    "universalrecommender": (
        "predictionio_tpu_torch.templates.universal.UniversalRecommenderEngine"
    ),
}


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


def cmd_launch(args) -> int:
    """N coordinated processes of one ``pio`` command (the reference's
    ``Runner.runOnSpark`` role, Runner.scala:185)."""
    from predictionio_tpu_torch.tools import launcher

    pio_args = list(args.pio_args)
    if pio_args and pio_args[0] == "--":
        pio_args = pio_args[1:]
    if not pio_args:
        print("[ERROR] launch needs a pio command after --", file=sys.stderr)
        return 1
    if args.hosts:
        hosts = [h.strip() for h in args.hosts.split(",") if h.strip()]
        for line in launcher.render_host_commands(pio_args, hosts, args.coordinator_port):
            print(line)
        return 0
    rc = launcher.launch_local(
        pio_args,
        num_processes=args.num_processes,
        coordinator_port=args.coordinator_port,
    )
    if rc == 0:
        print(f"[INFO] all {args.num_processes} processes completed")
    else:
        print(f"[ERROR] a worker failed (exit {rc})", file=sys.stderr)
    return rc


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
    _report_launches()
    return 0


def _report_launches() -> None:
    """Under ``pio launch`` each worker prints the kernels it launched, the
    proof that every rank's work went through the card's kernels."""
    from predictionio_tpu_torch.parallel import distributed

    pid, n = distributed.process_slot()
    if n == 1:
        return
    from predictionio_tpu_torch.ops import flash_attention, score_kernel, train_kernel

    counts = {
        "score_topk": score_kernel.launches.count,
        "train_normal_eq": train_kernel.launches.count,
        "segment_normal_eq": train_kernel.segment_launches.count,
        "flash_fwd": flash_attention.launches.count,
        "flash_bwd_dq": flash_attention.bwd_dq_launches.count,
        "flash_bwd_dkv": flash_attention.bwd_dkv_launches.count,
    }
    print(f"[INFO] process {pid}/{n} kernel launches: {json.dumps(counts)}", flush=True)


def cmd_eval(args) -> int:
    from predictionio_tpu_torch.core.evaluation import run_evaluation

    # an explicit variant supplies the conf recorded on the instance
    variant = load_variant(args) if (args.variant or args.engine_dir) else {}
    result = run_evaluation(
        evaluation_class=args.evaluation_class,
        engine_params_generator_class=args.engine_params_generator_class,
        storage=_storage(),
        ctx=make_ctx(variant, args.device),
        batch=args.batch or "",
        output_path=args.output_best,
    )
    print(f"[INFO] Evaluation completed. Instance ID: {result.instance_id}")
    print(result.summary)
    if args.output_best:
        print(f"[INFO] Best engine params written to {args.output_best}")
    return 0


def cmd_batchpredict(args) -> int:
    from predictionio_tpu_torch.serving.batch_predict import run_batch_predict

    variant = load_variant(args)
    engine = resolve_engine_from_variant(variant)
    engine_id, engine_version, engine_variant = engine_identity(variant)
    n, written = run_batch_predict(
        engine,
        args.input,
        args.output,
        storage=_storage(),
        ctx=make_ctx(variant, args.device),
        engine_id=engine_id,
        engine_version=engine_version,
        engine_variant=engine_variant,
    )
    print(f"[INFO] Batch predict completed: {n} predictions -> {written}")
    _report_launches()
    return 0


def _child_deploy_argv(args, port: int) -> list[str]:
    """Re-exec this CLI as a single-replica ``deploy`` child on ``port``
    and the parent's ``--device`` (fleet mode: the parent becomes the
    router, the children serve and launch the kernels)."""
    argv = [
        sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "deploy",
        "--ip", "127.0.0.1", "--port", str(port), "--device", args.device,
    ]
    if getattr(args, "engine_dir", None):
        argv += ["--engine-dir", args.engine_dir]
    if getattr(args, "variant", None):
        argv += ["--variant", args.variant]
    if args.feedback:
        argv += [
            "--feedback",
            "--event-server-ip", args.event_server_ip,
            "--event-server-port", str(args.event_server_port),
        ]
    if args.accesskey:
        argv += ["--accesskey", args.accesskey]
    for p in args.plugin:
        argv += ["--plugin", p]
    if args.batching:
        argv += ["--batching"]
    return argv


def _deploy_fleet(args) -> int:
    """``pio deploy --fleet N``: N replica subprocesses on ports
    port+1..port+N behind a health-checked, hedging router on ``port``,
    supervised for crash-restart and rolling deploys.  With
    ``--autoscale`` (or ``PIO_AUTOSCALE=1``) an autoscaler control loop
    grows/shrinks the replica set from the router's own load signals;
    scale-up replicas take the next sequential ports past the initial
    range."""
    import itertools
    import subprocess

    from predictionio_tpu_torch.serving.autoscaler import Autoscaler
    from predictionio_tpu_torch.serving.fleet import FleetSupervisor
    from predictionio_tpu_torch.serving.router import Router

    ports = [args.port + 1 + i for i in range(args.fleet)]
    next_ports = itertools.count(args.port + 1 + args.fleet)

    def spawn(port: int) -> subprocess.Popen:
        return subprocess.Popen(_child_deploy_argv(args, port))

    router = Router([f"http://127.0.0.1:{p}" for p in ports])
    fleet = FleetSupervisor(
        spawn, ports, router=router,
        port_allocator=lambda: next(next_ports),
    )
    router.attach_fleet(fleet)
    # multi-tenant fleet: the router admits per tenant at the edge; the
    # replica subprocesses inherit PIO_TENANTS and enforce the same
    # registry behind it (auth is checked on both hops)
    from predictionio_tpu_torch.serving.tenancy import tenants_from_env

    tenants = tenants_from_env()
    if tenants is not None:
        router.attach_tenants(tenants)
    autoscale = (
        getattr(args, "autoscale", False)
        or os.environ.get("PIO_AUTOSCALE", "0") != "0"
    )
    scaler = None
    if autoscale:
        scaler = Autoscaler(router, fleet)
        router.attach_autoscaler(scaler)
    canary = None
    if (
        getattr(args, "canary", False)
        or os.environ.get("PIO_CANARY", "0") != "0"
    ):
        from predictionio_tpu_torch.serving.canary import CanaryController

        variant = load_variant(args)
        engine_id, engine_version, engine_variant = engine_identity(variant)
        canary = CanaryController(
            router, fleet=fleet, storage=_storage(),
            engine_id=engine_id, engine_version=engine_version,
            engine_variant=engine_variant,
        )
        router.attach_canary(canary)
    fleet.start()
    if scaler is not None:
        scaler.start()
    if canary is not None:
        # finish whatever a killed predecessor left mid-flight (and
        # fence it, should it still be alive somewhere)
        resumed = canary.resume()
        if resumed:
            print(f"[INFO] Canary journal recovered: {resumed}.")
    port = router.start(args.ip, args.port)
    _install_drain_handler(router)
    print(
        f"[INFO] Fleet of {args.fleet} replicas (ports "
        f"{ports[0]}-{ports[-1]}) is deploying behind the router at "
        f"http://{args.ip}:{port}. Roll with `pio fleet roll`."
        + (" Autoscaler is active." if scaler is not None else "")
        + (" Canary controller is armed (`pio canary status`)."
           if canary is not None else ""),
        flush=True,
    )
    try:
        router.service.serve_forever()
    except KeyboardInterrupt:
        router.shutdown()
    return 0


def cmd_deploy(args) -> int:
    # --tenants / --pipeline publish through the env knobs so the fleet's
    # replica processes inherit the same registry and pipeline
    if args.tenants:
        os.environ["PIO_TENANTS"] = args.tenants
    if args.pipeline:
        os.environ["PIO_PIPELINE"] = args.pipeline
    if args.fleet and args.fleet > 1:
        # the router process serves no model: it never imports torch
        return _deploy_fleet(args)
    from predictionio_tpu_torch.serving.query_server import QueryServer

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


def cmd_fleet(args) -> int:
    """Operate a running fleet router: ``status`` prints the replica
    table; ``roll`` triggers a zero-downtime rolling deploy and waits
    for it to finish."""
    import time as _time
    import urllib.error
    import urllib.request

    base = f"http://{args.ip}:{args.port}"

    def get_fleet() -> dict:
        with urllib.request.urlopen(base + "/fleet", timeout=10) as r:
            return json.loads(r.read().decode("utf-8"))

    try:
        if args.fleet_command == "status":
            print(json.dumps(get_fleet(), indent=2))
            return 0
        # roll
        req = urllib.request.Request(base + "/fleet/roll", method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            print(f"[INFO] {json.loads(r.read().decode())['message']}")
        deadline = _time.monotonic() + args.timeout
        while _time.monotonic() < deadline:
            state = get_fleet()
            if not state.get("rolling"):
                print(json.dumps(state, indent=2))
                print("[INFO] Roll complete.")
                return 0
            _time.sleep(0.5)
        return _die(f"roll still in progress after {args.timeout}s")
    except urllib.error.HTTPError as e:
        return _die(f"router answered {e.code}: {e.read().decode()}")
    except OSError as e:
        return _die(f"no router at {base}: {e}")


def cmd_canary(args) -> int:
    """Operate a fleet router's canary controller: ``status`` prints the
    state machine + verdict inputs; ``start`` begins a canary (newest
    non-quarantined candidate, or ``--instance``); ``promote`` skips the
    rest of the window; ``abort`` rolls back WITHOUT quarantining;
    ``quarantine`` lists receipts (``--release ID`` clears one)."""
    import urllib.error
    import urllib.request

    base = f"http://{args.ip}:{args.port}"

    def call(path: str, method: str = "GET", payload: Optional[dict] = None):
        data = json.dumps(payload).encode("utf-8") if payload else b""
        req = urllib.request.Request(
            base + path, method=method,
            data=data if method == "POST" else None,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read().decode("utf-8"))

    try:
        cmd = args.canary_command
        if cmd == "status":
            print(json.dumps(call("/canary"), indent=2))
            return 0
        if cmd == "start":
            payload = {}
            if getattr(args, "instance", None):
                payload["instanceId"] = args.instance
            if getattr(args, "force", False):
                payload["force"] = True
            out = call("/canary/start", "POST", payload)
            print(json.dumps(out, indent=2))
            print("[INFO] Canary started; watch `pio canary status`.")
            return 0
        if cmd == "promote":
            print(json.dumps(call("/canary/promote", "POST"), indent=2))
            return 0
        if cmd == "abort":
            print(json.dumps(call("/canary/abort", "POST"), indent=2))
            return 0
        # quarantine
        if getattr(args, "release", None):
            out = call(
                "/canary/quarantine/release", "POST",
                {"instanceId": args.release},
            )
            print(json.dumps(out, indent=2))
            return 0 if out.get("released") else _die(
                f"no quarantine receipt for {args.release}"
            )
        print(json.dumps(call("/canary/quarantine"), indent=2))
        return 0
    except urllib.error.HTTPError as e:
        return _die(f"router answered {e.code}: {e.read().decode()}")
    except OSError as e:
        return _die(f"no router at {base}: {e}")


def cmd_tenants(args) -> int:
    """``pio tenants check|list``: validate a tenant registry config
    offline (check), or print a live server's per-tenant admission /
    variant stats (list)."""
    from predictionio_tpu_torch.serving.tenancy import registry_from_config

    if args.tenants_command == "check":
        source = args.config or os.environ.get("PIO_TENANTS", "")
        if not source:
            return _die("no config: pass --config or set PIO_TENANTS")
        try:
            if source.strip().startswith(("{", "[")):
                config = json.loads(source)
            else:
                with open(source, "r", encoding="utf-8") as f:
                    config = json.load(f)
            reg = registry_from_config(config)
        except (OSError, ValueError) as e:
            return _die(f"invalid tenant config: {e}")
        print(json.dumps(
            {
                "tenants": [s.to_dict() for s in reg.specs()],
                "engineVariants": sorted(reg.engine_variants()),
            },
            indent=2,
        ))
        print(f"[INFO] Tenant config OK ({len(reg.specs())} tenants).")
        return 0
    # list: live server stats
    import urllib.request

    url = f"http://{args.ip}:{args.port}/"
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            info = json.loads(r.read().decode("utf-8"))
    except OSError as e:
        return _die(f"no server at {url}: {e}")
    tenancy = info.get("tenancy")
    if tenancy is None:
        print("[INFO] Server has no tenant registry (PIO_TENANTS unset).")
        return 0
    print(json.dumps(tenancy, indent=2))
    return 0


def cmd_pipeline(args) -> int:
    """``pio pipeline seal|show``: publish a pipeline JSON config as a
    sealed deployable blob, or open + verify + describe a sealed one."""
    from predictionio_tpu_torch.core.persistence import ModelIntegrityError
    from predictionio_tpu_torch.serving.pipeline import (
        PipelineConfig, load_pipeline, save_pipeline,
    )

    if args.pipeline_command == "seal":
        try:
            with open(args.config, "r", encoding="utf-8") as f:
                config = PipelineConfig.from_dict(json.load(f))
        except (OSError, ValueError, KeyError) as e:
            return _die(f"invalid pipeline config: {e}")
        save_pipeline(config, args.out)
        print(f"[INFO] Sealed pipeline {config.name!r} "
              f"({config.fingerprint}) -> {args.out}. "
              f"Deploy with PIO_PIPELINE={args.out}.")
        return 0
    # show
    try:
        config = load_pipeline(args.path)
    except ModelIntegrityError as e:
        return _die(f"pipeline blob failed integrity check: {e}")
    except (OSError, ValueError) as e:
        return _die(f"cannot load pipeline: {e}")
    print(json.dumps(config.describe(), indent=2))
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
        ingest_flush_ms=args.flush_ms,
        ingest_buffer_max=args.buffer_max,
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



def cmd_shards(args) -> int:
    """Inspect or rebuild a published model's ShardingPlan.

    ``show`` reads the sealed ``plan.blob`` beside a checkpoint-mode
    instance's factors. ``rebuild`` rebalances the item→shard assignment
    from the instance's ``factors.blob`` and reseals ``plan.blob``, then
    rewrites ``maps.pkl``'s record, each atomically (tmp + fsync + rename);
    a live server picks the plan up on ``POST /reload``.
    """
    import pickle

    from predictionio_tpu_torch.core import persistence
    from predictionio_tpu_torch.core.checkpoint import restore_state
    from predictionio_tpu_torch.models.als import CheckpointedALSModel
    from predictionio_tpu_torch.serving import sharding as _sharding
    from predictionio_tpu_torch.utils.fs import pio_base_dir

    base = os.path.join(pio_base_dir(), "persistent_models")

    def plan_path(iid: str) -> str:
        return os.path.join(base, iid, CheckpointedALSModel.PLAN)

    if args.shards_command == "show":
        if args.instance:
            instances = [args.instance]
        elif os.path.isdir(base):
            instances = sorted(os.listdir(base))
        else:
            instances = []
        rows = []
        for iid in instances:
            p = plan_path(iid)
            if not os.path.exists(p):
                if args.instance:
                    print(f"[INFO] {iid}: no sharding plan (replicated)")
                continue
            try:
                rows.append({"instance": iid, **_sharding.load_plan(p).describe()})
            except Exception as e:
                rows.append({"instance": iid, "error": str(e)})
        print(json.dumps(rows, indent=2))
        return 0

    # rebuild
    iid = args.instance
    d = os.path.join(base, iid)
    maps_path = os.path.join(d, CheckpointedALSModel.MAPS)
    if not os.path.exists(maps_path):
        return _die(f"no checkpoint-persisted model at {d}")
    import numpy as np

    V = np.asarray(restore_state(os.path.join(d, CheckpointedALSModel.FACTORS))["item_factors"],
                   np.float32)
    weights = np.linalg.norm(V, axis=1) if args.weights == "norm" else None
    try:
        plan = _sharding.build_plan(
            int(V.shape[0]), n_shards=args.shards, weights=weights, strategy=args.strategy,
            capacity_budget_bytes=args.budget, bytes_per_item=float(V.shape[1]) * 4.0,
            host_groups=args.host_groups,
        )
    except ValueError as e:
        return _die(f"cannot build plan: {e}")
    _sharding.save_plan(plan_path(iid), plan)
    with open(maps_path, "rb") as f:
        meta = persistence.load_models_blob(f.read())
    meta["sharding"] = {
        "n_shards": plan.n_shards,
        "strategy": plan.strategy,
        "fingerprint": plan.fingerprint,
        "host_groups": plan.host_groups,
    }
    tmp = f"{maps_path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, maps_path)
    print(json.dumps({"instance": iid, **plan.describe()}, indent=2))
    print(
        "[INFO] Plan resealed. POST /reload on the serving deployment to "
        "pick it up (the LKG machinery guards the swap)."
    )
    return 0


def cmd_ivf(args) -> int:
    """Inspect or rebuild a published model's IVF retrieval index.

    ``show`` reads the sealed ``ivf.blob`` beside a checkpoint-mode
    instance's factors. ``rebuild`` retrains the k-means coarse partition
    from the instance's ``factors.blob``, re-runs the recall@10 publish gate
    against the exact ranking and, only if it clears the threshold, reseals
    ``ivf.blob`` and rewrites ``maps.pkl`` atomically; a live server picks
    it up on ``POST /reload``. A refused rebuild leaves the deployed
    artifacts untouched.
    """
    import pickle

    from predictionio_tpu_torch.core import persistence
    from predictionio_tpu_torch.core.checkpoint import restore_state
    from predictionio_tpu_torch.models.als import CheckpointedALSModel
    from predictionio_tpu_torch.ops import ivf as _ivf
    from predictionio_tpu_torch.utils.fs import pio_base_dir

    base = os.path.join(pio_base_dir(), "persistent_models")

    def index_path(iid: str) -> str:
        return os.path.join(base, iid, CheckpointedALSModel.IVF)

    if args.ivf_command == "show":
        if args.instance:
            instances = [args.instance]
        elif os.path.isdir(base):
            instances = sorted(os.listdir(base))
        else:
            instances = []
        rows = []
        for iid in instances:
            p = index_path(iid)
            if not os.path.exists(p):
                if args.instance:
                    print(f"[INFO] {iid}: no IVF index (exact retrieval)")
                continue
            try:
                rows.append({"instance": iid, **_ivf.load_index(p).describe()})
            except Exception as e:
                rows.append({"instance": iid, "error": str(e)})
        print(json.dumps(rows, indent=2))
        return 0

    # rebuild
    iid = args.instance
    d = os.path.join(base, iid)
    maps_path = os.path.join(d, CheckpointedALSModel.MAPS)
    if not os.path.exists(maps_path):
        return _die(f"no checkpoint-persisted model at {d}")
    factors = restore_state(os.path.join(d, CheckpointedALSModel.FACTORS))
    U, V = factors["user_factors"], factors["item_factors"]
    try:
        index = _ivf.build_index(V, args.nlist, nprobe=args.nprobe)
    except ValueError as e:
        return _die(f"cannot build IVF index: {e}")
    threshold = float(
        args.min_recall if args.min_recall is not None
        else os.environ.get("PIO_IVF_MIN_RECALL", "0.95")
    )
    sealed, record = _ivf.gate_index(U, V, index, threshold)
    if sealed is None:
        return _die(
            f"IVF rebuild REFUSED: recall@{record['k']} {record['recall']:.4f} < "
            f"{threshold:.4f}; the deployed index is untouched"
        )
    _ivf.save_index(index_path(iid), sealed)
    with open(maps_path, "rb") as f:
        meta = persistence.load_models_blob(f.read())
    meta["ivf"] = record
    tmp = f"{maps_path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, maps_path)
    print(json.dumps({"instance": iid, **sealed.describe()}, indent=2))
    print(
        "[INFO] Index resealed. POST /reload on the serving deployment to "
        "pick it up (the LKG machinery guards the swap)."
    )
    return 0


def cmd_template(args) -> int:
    # parity: `pio template list/get` — templates ship in-tree here
    if args.template_command == "list":
        for name, factory in BUILTIN_TEMPLATES.items():
            print(f"{name:<26} {factory}")
        return 0
    if args.template_command == "get":
        name = args.name
        if name == "python":
            raise _not_ported("the python template (pypio)", 15)
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

    sp = sub.add_parser(
        "launch",
        help="run a pio command as N coordinated processes (the launch "
        "contract of parallel/distributed.py; Runner.runOnSpark role)",
    )
    sp.add_argument("-n", "--num-processes", type=int, default=2)
    sp.add_argument("--coordinator-port", type=int, default=7654)
    sp.add_argument(
        "--hosts",
        default=None,
        help="comma-separated host list: print per-host command lines "
        "instead of spawning locally (hosts[0] is the coordinator)",
    )
    sp.add_argument(
        "pio_args",
        nargs=argparse.REMAINDER,
        help="the pio command to launch, after --  (e.g. -- train --device cpu)",
    )
    sp.set_defaults(func=cmd_launch)

    sp = sub.add_parser("eval")
    sp.add_argument("evaluation_class")
    sp.add_argument("engine_params_generator_class", nargs="?", default=None)
    add_engine_args(sp)
    add_device_arg(sp)
    sp.add_argument("--batch", default="")
    sp.add_argument(
        "--output-best", default=None, metavar="PATH",
        help="write the best engine params as JSON (parity: "
        "MetricEvaluator.saveEngineJson best.json, MetricEvaluator.scala:193)",
    )
    sp.set_defaults(func=cmd_eval)

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
    sp.add_argument(
        "--fleet", type=int, default=0, metavar="N",
        help="N replica processes on ports port+1..port+N behind a "
        "health-checked, hedging router on --port",
    )
    sp.add_argument(
        "--autoscale", action="store_true",
        help="with --fleet: grow and shrink the replica set from the "
        "router's load signals (PIO_AUTOSCALE_*); equivalent to PIO_AUTOSCALE=1",
    )
    sp.add_argument(
        "--canary", action="store_true",
        help="with --fleet: arm the SLO-guarded canary controller "
        "(`pio canary start`); equivalent to PIO_CANARY=1",
    )
    sp.add_argument(
        "--tenants", default=None, metavar="PATH_OR_JSON",
        help="tenant registry config (JSON file or inline); equivalent to PIO_TENANTS",
    )
    sp.add_argument(
        "--pipeline", default=None, metavar="PATH_OR_JSON",
        help="composed retrieval->ranking pipeline (a sealed blob from "
        "`pio pipeline seal`, or inline JSON); equivalent to PIO_PIPELINE",
    )
    sp.set_defaults(func=cmd_deploy)

    sp = sub.add_parser(
        "tenants", help="validate tenant configs / inspect live "
        "per-tenant admission and A/B stats"
    )
    tenants_sub = sp.add_subparsers(dest="tenants_command", required=True)
    x = tenants_sub.add_parser(
        "check", help="validate a tenant registry config offline"
    )
    x.add_argument("--config", default=None,
                   help="JSON file or inline JSON (default: PIO_TENANTS)")
    x.set_defaults(func=cmd_tenants)
    x = tenants_sub.add_parser(
        "list", help="print a live server's per-tenant stats"
    )
    x.add_argument("--ip", default="127.0.0.1")
    x.add_argument("--port", type=int, default=8000)
    x.set_defaults(func=cmd_tenants)

    sp = sub.add_parser(
        "pipeline", help="seal or inspect a composed retrieval->ranking "
        "pipeline config"
    )
    pipeline_sub = sp.add_subparsers(dest="pipeline_command", required=True)
    x = pipeline_sub.add_parser(
        "seal", help="publish pipeline JSON as a sealed deployable blob"
    )
    x.add_argument("--config", required=True, help="pipeline JSON file")
    x.add_argument("--out", required=True, help="sealed blob output path")
    x.set_defaults(func=cmd_pipeline)
    x = pipeline_sub.add_parser(
        "show", help="open + verify + describe a sealed pipeline blob"
    )
    x.add_argument("path", help="sealed pipeline blob")
    x.set_defaults(func=cmd_pipeline)

    sp = sub.add_parser(
        "fleet", help="operate a running fleet router (status / roll)"
    )
    fleet_sub = sp.add_subparsers(dest="fleet_command", required=True)
    x = fleet_sub.add_parser("status")
    x.add_argument("--ip", default="127.0.0.1")
    x.add_argument("--port", type=int, default=8000)
    x.set_defaults(func=cmd_fleet)
    x = fleet_sub.add_parser(
        "roll", help="zero-downtime rolling deploy to the latest "
        "trained model generation",
    )
    x.add_argument("--ip", default="127.0.0.1")
    x.add_argument("--port", type=int, default=8000)
    x.add_argument("--timeout", type=float, default=600.0,
                   help="seconds to wait for the roll to finish")
    x.set_defaults(func=cmd_fleet)

    sp = sub.add_parser(
        "canary", help="operate a fleet router's SLO-guarded canary "
        "rollout (status / start / promote / abort / quarantine)"
    )
    canary_sub = sp.add_subparsers(dest="canary_command", required=True)
    for verb, help_text in (
        ("status", "print the canary state machine and verdict inputs"),
        ("start", "canary ONE replica onto a candidate generation"),
        ("promote", "skip the rest of the verification window"),
        ("abort", "roll the canary back WITHOUT quarantining"),
        ("quarantine", "list quarantine receipts (--release ID clears)"),
    ):
        x = canary_sub.add_parser(verb, help=help_text)
        x.add_argument("--ip", default="127.0.0.1")
        x.add_argument("--port", type=int, default=8000)
        if verb == "start":
            x.add_argument(
                "--instance", default=None,
                help="candidate engine instance id (default: newest "
                "non-quarantined COMPLETED generation)",
            )
            x.add_argument(
                "--force", action="store_true",
                help="canary a quarantined candidate anyway",
            )
        if verb == "quarantine":
            x.add_argument(
                "--release", default=None, metavar="INSTANCE_ID",
                help="clear the receipt for this instance id",
            )
        x.set_defaults(func=cmd_canary)

    sp = sub.add_parser("undeploy")
    sp.add_argument("--ip", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8000)
    sp.set_defaults(func=cmd_undeploy)

    sp = sub.add_parser("batchpredict")
    add_engine_args(sp)
    add_device_arg(sp)
    sp.add_argument("--input", required=True)
    sp.add_argument("--output", required=True)
    sp.set_defaults(func=cmd_batchpredict)

    sp = sub.add_parser("eventserver")
    sp.add_argument("--ip", default="0.0.0.0")
    sp.add_argument("--port", type=int, default=7070)
    sp.add_argument("--stats", action="store_true")
    sp.add_argument("--plugin", action="append", default=[])
    sp.add_argument("--cert-path", default=None)
    sp.add_argument("--key-path", default=None)
    sp.add_argument(
        "--ingest-buffer", choices=["off", "durable", "fast"], default=None,
        help="group-commit write-behind for single-event POSTs "
        "(default: PIO_INGEST_BUFFER env or off)",
    )
    sp.add_argument("--flush-ms", type=float, default=None,
                    help="write-behind flush interval (PIO_INGEST_FLUSH_MS)")
    sp.add_argument("--buffer-max", type=int, default=None,
                    help="write-behind capacity; beyond it single-event "
                    "POSTs shed 503 (PIO_INGEST_BUFFER_MAX)")
    sp.add_argument("--wal-dir", default=None,
                    help="fast-mode durability: journal fast-acked events "
                    "to this write-ahead-log directory and replay them on "
                    "startup (PIO_WAL_DIR; fsync via PIO_WAL_FSYNC)")
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

    sp = sub.add_parser(
        "shards", help="inspect or rebuild a published model's sharded-serving plan"
    )
    shards_sub = sp.add_subparsers(dest="shards_command", required=True)
    x = shards_sub.add_parser(
        "show", help="print the sealed ShardingPlan of one (or every) checkpoint-persisted "
        "model instance",
    )
    x.add_argument("--instance", default=None)
    x.set_defaults(func=cmd_shards)
    x = shards_sub.add_parser(
        "rebuild", help="re-balance the item→shard assignment offline and reseal plan.blob; "
        "a live server adopts it on POST /reload",
    )
    x.add_argument("--instance", required=True)
    x.add_argument("--shards", type=int, default=None, help="explicit shard count")
    x.add_argument("--budget", type=int, default=None,
                   help="per-shard HBM byte budget (derives the count)")
    x.add_argument("--strategy", default="popularity",
                   choices=["popularity", "round_robin", "contiguous"])
    x.add_argument("--weights", default="norm", choices=["norm", "uniform"],
                   help="popularity weights: item-factor L2 norms (the traffic proxy) or "
                   "uniform")
    x.add_argument("--host-groups", type=int, default=1,
                   help="pod host groups: shards partition into this many contiguous groups "
                   "(two-tier merge; must divide the shard count)")
    x.set_defaults(func=cmd_shards)

    sp = sub.add_parser(
        "ivf", help="inspect or rebuild a published model's IVF approximate-retrieval index"
    )
    ivf_sub = sp.add_subparsers(dest="ivf_command", required=True)
    x = ivf_sub.add_parser(
        "show", help="print the sealed IVF index of one (or every) checkpoint-persisted "
        "model instance",
    )
    x.add_argument("--instance", default=None)
    x.set_defaults(func=cmd_ivf)
    x = ivf_sub.add_parser(
        "rebuild", help="retrain the k-means coarse partition offline, re-run the recall "
        "gate, and reseal ivf.blob; a live server adopts it on POST /reload",
    )
    x.add_argument("--instance", required=True)
    x.add_argument("--nlist", type=int, required=True,
                   help="cluster count for the coarse partition")
    x.add_argument("--nprobe", type=int, default=None,
                   help="default probe count (default: nlist // 8)")
    x.add_argument("--min-recall", type=float, default=None,
                   help="recall@10 gate (default: PIO_IVF_MIN_RECALL or 0.95)")
    x.set_defaults(func=cmd_ivf)

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
    if os.environ.get("PIO_COORDINATOR") and args.command != "launch":
        # a launch's worker joins the rendezvous before any other work, so
        # every process leaves it together (parallel/distributed.py)
        from predictionio_tpu_torch.parallel import distributed

        distributed.initialize()
    try:
        return args.func(args)
    except BrokenPipeError:
        # `pio status | head` closing the pipe early is not an error
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        return 0
    except (FileNotFoundError, ValueError, RuntimeError, ForeignClassError) as e:
        # NotImplementedError (a waiting ROADMAP item) is a RuntimeError;
        # ForeignClassError names a stored class of the JAX package the port
        # refuses (any other ImportError keeps its traceback)
        return _die(str(e))


if __name__ == "__main__":
    sys.exit(main())
