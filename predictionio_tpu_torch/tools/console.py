"""The ``pio`` console of the port: the operator CLI.

Trimmed copy of ``predictionio_tpu/tools/console.py`` (a rebuild of
``tools/.../console/Console.scala`` and the app and access-key
consoles). Run it as ``python -m predictionio_tpu_torch.tools.console
<command>``. Commands:

    app new|list|show|delete|data-delete
    accesskey new|list|delete
    build                      — check the engine project and register it
    train | eval               — the training / evaluation workflow
    deploy | undeploy          — query-server lifecycle (undeploy = GET /stop)
    eventserver                — the event REST server
    status                     — storage verification (Storage.scala:230-250)
    import | export            — events ↔ JSON-lines files
    template list|get          — bundled engine templates
    ckpt ls|verify|gc          — checkpoint stores (alias ``checkpoint``)
    health | alerts | blackbox — the health plane (``tools/health.py``)
    trace <id>                 — one X-PIO-Trace id's spans across nodes

``train``, ``eval`` and ``deploy`` take ``--device`` (default ``cuda:0``,
which raises where there is no CUDA; ``--device cpu`` runs on the host).
With ``--spawn`` they run as ``python -m
predictionio_tpu_torch.tools.{run_workflow,run_server}`` child processes
that inherit the environment (and so the storage, ``PIO_FS_BASEDIR``)
and receive ``--device``; without it, in this process. ``train`` and
``eval`` report the CUDA kernels' launches of the run (a child's counts
are its own; a deployed server reports its own on ``/status.json``).
The commands that need no device (apps, keys, ``build``, ``status``,
``import``, ``export``, ``template``, ``undeploy``, ``ckpt``, ``health``,
``alerts``, ``blackbox``, ``trace``) do not import torch. The commands of
modules that are not ported stay in the parser and exit 1 with a
message naming their ROADMAP item (:data:`NOT_PORTED`).
"""

from __future__ import annotations

import argparse
import json
import os
import secrets
import subprocess
import sys
import time
import urllib.error
import urllib.request
from typing import List, Optional, Sequence

from ..storage import Event, Model, StorageRegistry, get_registry, utcnow
from ..storage.metadata import AccessKey, App
from ..storage.registry import base_dir
from . import not_ported
from . import register as register_mod

EXIT_OK = 0
EXIT_FAIL = 1

#: the JAX console's commands whose modules are not ported: name → (what,
#: ROADMAP queue 1 item)
NOT_PORTED = {
    "rollout": ("rollouts, the second half of item 6", 6),
    "continuous": ("the continuous-learning loop", 9),
    "migrate": ("live storage migration", 12),
    "autoscale": ("the fleet autoscaler", 13),
    "dashboard": ("the evaluation dashboard", 14),
    "storageserver": ("the storage server", 12),
    "lint": ("pio lint", 14),
    "top": ("pio top", 14),
    "perf": ("the perf tooling", 14),
    "quality": ("the quality plane", 14),
    "upgrade": ("storage upgrades", 14),
}


#: forwarded verbatim, subcommand included, to ``tools/health.py``
HEALTH_COMMANDS = ("health", "alerts", "blackbox")


# -- app / accesskey consoles (console/App.scala, console/AccessKey.scala) ----
def _app(registry: StorageRegistry, name: str) -> App:
    app = registry.get_metadata().app_get_by_name(name)
    if app is None:
        raise KeyError(f"App {name!r} not found")
    return app


def app_new(registry: StorageRegistry, name: str, app_id: Optional[int] = None,
            access_key: Optional[str] = None, description: Optional[str] = None) -> dict:
    """``pio app new`` (``App.scala:33-77``): create the app, initialise
    its event store, mint a default access key valid for all events."""
    md = registry.get_metadata()
    if md.app_get_by_name(name) is not None:
        raise ValueError(f"App {name!r} already exists")
    new_id = md.app_insert(App(id=app_id or 0, name=name, description=description))
    if new_id is None:
        raise ValueError(f"Could not create app {name!r} (id conflict?)")
    registry.get_events().init(new_id)
    key = access_key or secrets.token_urlsafe(32)
    md.access_key_insert(AccessKey(key=key, appid=new_id, events=()))
    return {"name": name, "id": new_id, "accessKey": key}


def app_list(registry: StorageRegistry) -> List[dict]:
    md = registry.get_metadata()
    return [{"name": app.name, "id": app.id,
             "accessKeys": [ak.key for ak in md.access_key_get_by_app(app.id)]}
            for app in sorted(md.app_get_all(), key=lambda a: a.name)]


def app_show(registry: StorageRegistry, name: str) -> dict:
    app = _app(registry, name)
    keys = [{"key": ak.key, "events": list(ak.events)}
            for ak in registry.get_metadata().access_key_get_by_app(app.id)]
    return {"name": app.name, "id": app.id, "description": app.description,
            "accessKeys": keys}


def app_delete(registry: StorageRegistry, name: str) -> dict:
    """``pio app delete``: the app, its keys and its event data
    (``App.scala:79-120``)."""
    md = registry.get_metadata()
    app = _app(registry, name)
    registry.get_events().remove(app.id)
    for ak in md.access_key_get_by_app(app.id):
        md.access_key_delete(ak.key)
    md.app_delete(app.id)
    return {"name": name, "id": app.id, "deleted": True}


def app_data_delete(registry: StorageRegistry, name: str) -> dict:
    """``pio app data-delete``: wipe and re-initialise the app's event
    store (``App.scala:122-141``)."""
    app = _app(registry, name)
    ev = registry.get_events()
    ev.remove(app.id)
    ev.init(app.id)
    return {"name": name, "id": app.id, "dataDeleted": True}


def accesskey_new(registry: StorageRegistry, app_name: str, events: Sequence[str] = (),
                  key: Optional[str] = None) -> dict:
    app = _app(registry, app_name)
    new_key = key or secrets.token_urlsafe(32)
    registry.get_metadata().access_key_insert(
        AccessKey(key=new_key, appid=app.id, events=tuple(events)))
    return {"app": app_name, "accessKey": new_key, "events": list(events)}


def accesskey_list(registry: StorageRegistry, app_name: Optional[str] = None) -> List[dict]:
    md = registry.get_metadata()
    apps = ([a for a in [md.app_get_by_name(app_name)] if a is not None]
            if app_name else md.app_get_all())
    return [{"key": ak.key, "app": app.name, "events": list(ak.events)}
            for app in apps for ak in md.access_key_get_by_app(app.id)]


def accesskey_delete(registry: StorageRegistry, key: str) -> dict:
    if not registry.get_metadata().access_key_delete(key):
        raise KeyError(f"Access key {key!r} not found")
    return {"accessKey": key, "deleted": True}


# -- undeploy / status (Console.scala:798-824, :930-986) -----------------------
def undeploy(ip: str = "localhost", port: int = 8000) -> dict:
    """HTTP GET /stop against a running query server."""
    url = f"http://{ip}:{port}/stop"
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return {"url": url, "status": resp.status}
    except (urllib.error.URLError, OSError) as exc:
        raise RuntimeError(f"Nothing to undeploy at {url}: {exc}") from exc


def status(registry: StorageRegistry) -> dict:
    """``pio status``: every storage repository touched with a live
    operation, a test write included (the JAX registry's
    ``verify_all_data_objects``)."""
    results = {}
    try:
        registry.get_metadata().app_get_all()
        results["metadata"] = True
    except Exception:
        results["metadata"] = False
    try:
        models = registry.get_models()
        probe = Model(id="pio-status-probe", models=b"probe")
        models.insert(probe)
        got = models.get(probe.id)
        models.delete(probe.id)
        results["modeldata"] = got is not None and got.models == b"probe"
    except Exception:
        results["modeldata"] = False
    try:
        events = registry.get_events()
        events.init(0)
        eid = events.insert(Event(event="$set", entity_type="pio_pr",
                                  entity_id="status-probe", event_time=utcnow()), 0)
        results["eventdata"] = events.get(eid, 0) is not None
        events.delete(eid, 0)
    except Exception:
        results["eventdata"] = False
    return {"storage": results, "ok": all(results.values())}


# -- the parser ------------------------------------------------------------------
_WORKFLOW_FLAGS = [
    ("--engine-dir", {"default": "."}),
    ("--engine-variant", {"default": "engine.json"}),
    ("--engine-params-key", {"default": None}),
    ("--batch", {"default": ""}),
    ("--device", {"default": None,
                  "help": "'cuda', 'cuda:N' or 'cpu' (default: cuda:0)"}),
    ("--verbose", {"action": "store_true"}),
    ("--skip-sanity-check", {"action": "store_true"}),
    ("--stop-after-read", {"action": "store_true"}),
    ("--stop-after-prepare", {"action": "store_true"}),
    ("--eval-parallelism", {"type": int, "default": 0}),
    ("--shards", {"type": int, "default": None, "metavar": "N"}),
    ("--checkpoint-every", {"type": int, "default": None, "metavar": "N"}),
    ("--resume", {"default": None, "action": argparse.BooleanOptionalAction}),
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pio", description="PredictionIO operator console "
                                "(the PyTorch/CUDA package)")
    sub = p.add_subparsers(dest="command", required=True)

    app = sub.add_parser("app", help="manage apps")
    app_sub = app.add_subparsers(dest="app_command", required=True)
    ap_new = app_sub.add_parser("new")
    ap_new.add_argument("name")
    ap_new.add_argument("--id", type=int, default=None)
    ap_new.add_argument("--access-key", default=None)
    ap_new.add_argument("--description", default=None)
    app_sub.add_parser("list")
    for nm in ("show", "delete", "data-delete"):
        sp = app_sub.add_parser(nm)
        sp.add_argument("name")
        if nm != "show":
            sp.add_argument("--force", "-f", action="store_true")

    ak = sub.add_parser("accesskey", help="manage access keys")
    ak_sub = ak.add_subparsers(dest="accesskey_command", required=True)
    ak_new = ak_sub.add_parser("new")
    ak_new.add_argument("app_name")
    ak_new.add_argument("events", nargs="*")
    ak_list = ak_sub.add_parser("list")
    ak_list.add_argument("app_name", nargs="?", default=None)
    ak_del = ak_sub.add_parser("delete")
    ak_del.add_argument("key")

    build = sub.add_parser("build", help="check + register the engine project")
    build.add_argument("--engine-dir", default=".")

    train = sub.add_parser("train", help="run the training workflow")
    ev = sub.add_parser("eval", help="run an evaluation")
    ev.add_argument("evaluation_class")
    ev.add_argument("engine_params_generator_class", nargs="?", default=None)
    for parser in (train, ev):
        for flag, kw in _WORKFLOW_FLAGS:
            parser.add_argument(flag, **kw)
        parser.add_argument("--spawn", action="store_true")

    # deploy takes run_server's flags, declared once in run_server's parser
    dp = sub.add_parser("deploy", help="serve the latest trained instance (takes "
                        "run_server's flags: --engine-dir, --ip, --port, --device, ...)")
    dp.add_argument("--spawn", action="store_true")

    ud = sub.add_parser("undeploy", help="stop a running query server")
    ud.add_argument("--ip", default="localhost")
    ud.add_argument("--port", type=int, default=8000)

    es = sub.add_parser("eventserver", help="run the event REST server")
    es.add_argument("--ip", default="localhost")
    es.add_argument("--port", type=int, default=7070)
    es.add_argument("--stats", action="store_true")

    sub.add_parser("status", help="verify storage backends")

    ex = sub.add_parser("export", help="export app events (JSON lines)")
    ex.add_argument("--appid", type=int, required=True)
    ex.add_argument("--output", required=True)
    ex.add_argument("--format", choices=("json", "parquet"), default="json")

    im = sub.add_parser("import", help="import events into an app (JSON lines)")
    im.add_argument("--appid", type=int, required=True)
    im.add_argument("--input", required=True)
    im.add_argument("--format", choices=("json", "parquet"), default="json")

    tp = sub.add_parser("template", help="bundled engine templates")
    tp_sub = tp.add_subparsers(dest="template_command", required=True)
    tp_sub.add_parser("list")
    tp_get = tp_sub.add_parser("get")
    tp_get.add_argument("template_name")
    tp_get.add_argument("directory")

    # forwarded verbatim to ckpt.cli and tools/health.py, which own
    # their flags (see main)
    sub.add_parser("ckpt", aliases=["checkpoint"], add_help=False,
                   help="checkpoint stores: ls | verify | gc")
    for name in HEALTH_COMMANDS:
        sub.add_parser(name, add_help=False, help=f"pio {name} (tools/health.py)")
    tr = sub.add_parser("trace", help="stitch one X-PIO-Trace id's spans across a "
                        "node list (GET /traces.json)")
    tr.add_argument("trace_id")
    tr.add_argument("--nodes", default=None, metavar="HOST:PORT,...",
                    help="nodes to query (default: localhost query/event/storage ports)")
    tr.add_argument("--json", action="store_true", help="emit raw spans as JSON")
    tr.add_argument("--timeout", type=float, default=5.0)
    for name, (what, item) in NOT_PORTED.items():
        sub.add_parser(name, help=f"{what}: not ported (ROADMAP.md, queue 1 item {item})")
    return p


def _emit(obj) -> None:
    print(json.dumps(obj, indent=2, default=str), flush=True)


def _spawn(module: str, argv: Sequence[str]) -> int:
    """A child process that runs to its end (train, eval): ``python -m
    module argv`` with this process's environment."""
    return subprocess.call([sys.executable, "-m", module, *argv])


def _spawn_detached(module: str, argv: Sequence[str]) -> int:
    """A long-running child (``deploy --spawn``): its output goes to
    ``$PIO_FS_BASEDIR/logs``, and a short liveness poll
    (``PIO_SPAWN_POLL_S``, default 4 s) reports a child that died at once
    instead of a dead pid."""
    log_dir = os.path.join(base_dir(), "logs")
    os.makedirs(log_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    log_path = os.path.join(log_dir, f"{module.rsplit('.', 1)[-1]}-{stamp}.log")
    with open(log_path, "ab") as log_f:
        proc = subprocess.Popen([sys.executable, "-m", module, *argv],
                                start_new_session=True, stdout=log_f,
                                stderr=subprocess.STDOUT)
    deadline = time.monotonic() + float(os.environ.get("PIO_SPAWN_POLL_S", "4"))
    while time.monotonic() < deadline and proc.poll() is None:
        time.sleep(0.2)
    if proc.poll() is not None:
        with open(log_path, "rb") as f:
            tail = f.read()[-2000:].decode("utf-8", "replace")
        _emit({"error": f"spawned {module} exited immediately (code {proc.returncode})",
               "log": log_path, "log_tail": tail})
        return EXIT_FAIL
    _emit({"spawned": module, "pid": proc.pid, "log": log_path})
    return EXIT_OK


def _workflow_argv(args: argparse.Namespace, extra: Sequence[str] = ()) -> List[str]:
    argv = ["--engine-dir", args.engine_dir, "--engine-variant", args.engine_variant,
            "--batch", args.batch]
    if args.engine_params_key:
        argv += ["--engine-params-key", args.engine_params_key]
    if args.device:
        argv += ["--device", args.device]
    for flag in ("verbose", "skip_sanity_check", "stop_after_read", "stop_after_prepare"):
        if getattr(args, flag):
            argv.append("--" + flag.replace("_", "-"))
    if args.eval_parallelism:
        argv += ["--eval-parallelism", str(args.eval_parallelism)]
    if args.shards is not None:
        argv += ["--shards", str(args.shards)]
    if args.checkpoint_every is not None:
        argv += ["--checkpoint-every", str(args.checkpoint_every)]
    if args.resume is not None:
        argv.append("--resume" if args.resume else "--no-resume")
    return argv + list(extra)


def main(argv: Optional[Sequence[str]] = None,
         registry: Optional[StorageRegistry] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    name = argv[0] if argv else None
    if name in ("ckpt", "checkpoint"):
        # forwarded before argparse: the ckpt CLI owns its option surface
        # and is pure filesystem, so it works on an unconfigured host
        from ..ckpt import cli as ckpt_cli

        return ckpt_cli.main(argv[1:])
    if name in HEALTH_COMMANDS:
        # the health CLIs are pure scrapers and ledger readers: forwarded
        # with the subcommand, before argparse, storage-free
        from . import health

        return health.main(argv)
    # a command that is not ported is refused before its own flags are
    # parsed (the JAX console forwards several of them verbatim)
    if name in NOT_PORTED:
        what, item = NOT_PORTED[name]
        _emit({"error": str(not_ported(f"`pio {name}` ({what})", item))})
        return EXIT_FAIL
    args, extra = build_parser().parse_known_args(argv)
    try:
        if args.command == "deploy":  # the rest are run_server's flags
            return _deploy(args.spawn, extra, registry)
        if extra:
            build_parser().error(f"unrecognized arguments: {' '.join(extra)}")
        return _dispatch(args, registry)
    except KeyboardInterrupt:
        return EXIT_FAIL
    except Exception as exc:  # every operator error → JSON + exit 1
        _emit({"error": str(exc)})
        return EXIT_FAIL


def _confirm_destructive(args: argparse.Namespace, action: str) -> bool:
    """``App.scala:79-120``: destructive app commands ask for 'YES' unless
    --force; a non-interactive call must pass --force."""
    if args.force:
        return True
    if not sys.stdin.isatty():
        _emit({"error": f"refusing to {action} without --force (non-interactive)"})
        return False
    if input(f"About to {action}. Enter 'YES' to proceed: ") != "YES":
        _emit({"error": "aborted"})
        return False
    return True


def _deploy(spawn: bool, srv_argv: List[str], registry: Optional[StorageRegistry]) -> int:
    """``pio deploy``: ``run_server``'s flags, checked here first (a flag
    whose module is not ported fails before any child starts); with
    ``spawn`` a detached ``run_server`` child, else a server in this
    process until ``GET /stop``."""
    from . import run_server

    srv_args = run_server.build_parser().parse_args(srv_argv)
    run_server.check_ported(srv_args)
    if spawn:
        return _spawn_detached("predictionio_tpu_torch.tools.run_server", srv_argv)
    run_server.make_server(srv_args, registry or get_registry(), block=True)
    return EXIT_OK


def _dispatch(args: argparse.Namespace, registry: Optional[StorageRegistry]) -> int:
    cmd = args.command
    if cmd == "trace":  # a scraper: no storage
        from ..obs.top import DEFAULT_NODES, run_trace

        return run_trace(args.trace_id, args.nodes or DEFAULT_NODES,
                         timeout=args.timeout, as_json=args.json)
    registry = registry or get_registry()
    if cmd == "app":
        sub = args.app_command
        if sub == "new":
            _emit(app_new(registry, args.name, args.id, args.access_key, args.description))
        elif sub == "list":
            _emit(app_list(registry))
        elif sub == "show":
            _emit(app_show(registry, args.name))
        elif sub == "delete":
            if not _confirm_destructive(args, f"delete app {args.name!r} and ALL its data"):
                return EXIT_FAIL
            _emit(app_delete(registry, args.name))
        elif sub == "data-delete":
            if not _confirm_destructive(args, f"delete ALL event data of app {args.name!r}"):
                return EXIT_FAIL
            _emit(app_data_delete(registry, args.name))
        return EXIT_OK

    if cmd == "accesskey":
        sub = args.accesskey_command
        if sub == "new":
            _emit(accesskey_new(registry, args.app_name, args.events))
        elif sub == "list":
            _emit(accesskey_list(registry, args.app_name))
        else:
            _emit(accesskey_delete(registry, args.key))
        return EXIT_OK

    if cmd == "build":
        from ..native import LIBRARIES, build_library

        ed = register_mod.register_engine(registry, args.engine_dir)
        # the host libraries now, so the first train does not pay the
        # g++ build; a failed build raises (the kernels build at deploy)
        for name in LIBRARIES:
            build_library(name)
        _emit({"engineId": ed.manifest.id, "engineVersion": ed.manifest.version,
               "nativeLibraries": sorted(LIBRARIES)})
        return EXIT_OK

    if cmd in ("train", "eval"):
        from ..ops.cuda_kernels import kernel_launches
        from . import run_workflow

        extra = []
        if cmd == "train":
            register_mod.register_engine(registry, args.engine_dir, verify_import=False)
        else:
            extra = ["--evaluation-class", args.evaluation_class]
            if args.engine_params_generator_class:
                extra += ["--engine-params-generator-class",
                          args.engine_params_generator_class]
        wf_argv = _workflow_argv(args, extra)
        if args.spawn:
            return _spawn("predictionio_tpu_torch.tools.run_workflow", wf_argv)
        instance_id = run_workflow.run(run_workflow.build_parser().parse_args(wf_argv),
                                       registry)
        key = "engineInstanceId" if cmd == "train" else "evaluationInstanceId"
        _emit({key: instance_id, "kernelLaunches": kernel_launches()})
        return EXIT_OK

    if cmd == "undeploy":
        _emit(undeploy(args.ip, args.port))
        return EXIT_OK

    if cmd == "eventserver":
        from ..api.event_server import EventServerConfig, create_event_server

        create_event_server(EventServerConfig(ip=args.ip, port=args.port, stats=args.stats),
                            registry=registry, block=True)
        return EXIT_OK

    if cmd == "status":
        result = status(registry)
        _emit(result)
        return EXIT_OK if result["ok"] else EXIT_FAIL

    if cmd in ("import", "export"):
        from .export_events import export_events
        from .import_events import PARQUET_NOT_PORTED, import_events

        if args.format == "parquet":
            raise NotImplementedError(PARQUET_NOT_PORTED)
        if cmd == "export":
            with open(args.output, "w", encoding="utf-8") as fh:
                n = export_events(registry, args.appid, fh)
            _emit({"appId": args.appid, "events": n, "output": args.output})
        else:
            with open(args.input, "r", encoding="utf-8") as fh:
                n = import_events(registry, args.appid, fh)
            _emit({"appId": args.appid, "events": n, "input": args.input})
        return EXIT_OK

    if cmd == "template":
        from .templates import get_template, list_templates

        if args.template_command == "list":
            _emit(list_templates())
        else:
            _emit(get_template(args.template_name, args.directory))
        return EXIT_OK

    raise ValueError(f"Unknown command {cmd!r}")


if __name__ == "__main__":
    sys.exit(main())
