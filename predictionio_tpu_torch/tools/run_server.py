"""Serving entry process: the ``CreateServer`` spawn analogue.

Trimmed copy of ``predictionio_tpu/tools/run_server.py`` (a rebuild of
``tools/.../RunServer.scala:29-139`` and ``CreateServer``'s main):
resolve the engine project, load its factory, and serve the latest
COMPLETED engine instance (or ``--engine-instance-id``) on ``POST
/queries.json`` with ``POST /reload`` and ``GET /stop``, over the port's
``workflow/serving.py::create_query_server``. Run it as ``python -m
predictionio_tpu_torch.tools.run_server --engine-dir DIR``.

``--device`` picks the card or the host (default ``cuda:0``, which
raises where there is no CUDA). On a CUDA device every kernel library is
built through ``kernels/build.py`` before the server binds (the
counterpart of the JAX package's ``tools/prewarm_cache.py``, which warms
a compilation cache); a build failure ends the deploy.

The request plane's flags: ``--feedback`` with ``--event-server-ip``,
``--event-server-port`` and ``--accesskey`` (a ``predict`` event per
answer), ``--log-url`` (failures posted there), ``--shard-index`` and
``--shard-count`` (serve one partition of the item table). With
``PIO_FLIGHT_DIR`` set, :func:`main` arms the flight recorder: an atexit
dump, ``faulthandler`` and a SIGTERM dump (``flight-<pid>.jsonl``,
``faulthandler-<pid>.txt``).

The continuous loop: ``--continuous-app APP`` attaches its controller,
tailing ``--continuous-feed URL`` (a storage primary, ``pio
storageserver``), or, without the flag, the ``_URL`` (or
``_HOST``/``_PORT``) of the registry's ``remote`` source;
``--continuous-min-events`` and ``--continuous-staleness-s`` set its
trigger. A partitioned store (``PIO_STORAGE_SOURCES_*_PARTITIONS``, or a
partitioned or ``pio+ha://`` feed URL) raises, naming ROADMAP.md queue 1
item 12.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

from ..device import resolve_device
from ..kernels import build
from ..obs import flight
from ..storage import StorageRegistry, get_registry
from ..workflow import loader
from ..workflow.serving import QueryServer, ServerConfig, create_query_server
from . import not_ported
from .register import load_engine_dir


def build_parser() -> argparse.ArgumentParser:
    """Flag grammar (``CreateServer.scala:101-147``)."""
    p = argparse.ArgumentParser(prog="run_server")
    p.add_argument("--engine-dir", default=".")
    p.add_argument("--engine-instance-id", default=None)
    p.add_argument("--ip", default="localhost")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--engine-variant", default="engine.json")
    p.add_argument(
        "--device", default=None,
        help="where the models' tables live: 'cuda', 'cuda:N' or 'cpu' "
             "(default: cuda:0, which raises without CUDA)",
    )
    p.add_argument("--batch", default="")
    p.add_argument("--batch-max", type=int, default=None,
                   help="micro-batch size cap (default 512)")
    p.add_argument("--batch-pipeline-depth", type=int, default=None,
                   help="batches in flight at once (default 2)")
    p.add_argument("--feedback", action="store_true",
                   help="post a predict event per answer to the Event Server")
    p.add_argument("--event-server-ip", default="localhost")
    p.add_argument("--event-server-port", type=int, default=7070)
    p.add_argument("--accesskey", default=None)
    p.add_argument("--log-url", default=None,
                   help="POST serving failures to this URL")
    p.add_argument("--shard-index", type=int, default=0, metavar="I")
    p.add_argument("--shard-count", type=int, default=1, metavar="N",
                   help="serve item rows i %% N == I only (sharded serving)")
    p.add_argument("--continuous-app", type=int, default=None, metavar="APP_ID",
                   help="attach the continuous-learning loop for this app")
    p.add_argument("--continuous-feed", default=None, metavar="URL",
                   help="storage primary whose GET /replicate/changes the loop tails "
                        "(default: the remote registry's URL)")
    p.add_argument("--continuous-min-events", type=int, default=10,
                   help="delta size that triggers a training cycle")
    p.add_argument("--continuous-staleness-s", type=float, default=300.0,
                   help="trigger below min-events once the oldest pending event is "
                        "this stale")
    p.add_argument("--verbose", action="store_true")
    return p


def check_ported(args: argparse.Namespace, env=None) -> None:
    """Raise for a flag or an environment whose module is not ported."""
    env = os.environ if env is None else env
    if any(k.startswith("PIO_STORAGE_SOURCES_") and k.endswith("_PARTITIONS")
           for k in env):
        raise not_ported("a partitioned event store (PIO_STORAGE_SOURCES_*_PARTITIONS)", 12)
    if args.continuous_feed:
        from ..storage.remote import single_endpoint

        single_endpoint(args.continuous_feed)  # a partitioned feed raises


def _continuous_config(args: argparse.Namespace, registry):
    """The ``ContinuousConfig`` of the ``--continuous-*`` flags (None
    without ``--continuous-app``). The feed is ``--continuous-feed``, else
    the registry's ``remote`` source; with neither, the deploy ends."""
    if args.continuous_app is None:
        return None
    from ..continuous.controller import ContinuousConfig
    from ..storage import remote

    feed_url = args.continuous_feed
    if not feed_url:
        # the storage primary every other plane of this deployment talks to
        env = getattr(registry, "_env", None) or {}
        for key, value in sorted(env.items()):
            if key.startswith("PIO_STORAGE_SOURCES_") and key.endswith("_TYPE") \
                    and value == "remote":
                prefix = key[:-len("TYPE")]
                feed_url = remote.base_url({k[len(prefix):].lower(): v
                                            for k, v in env.items() if k.startswith(prefix)})
                break
    if not feed_url:
        raise SystemExit("--continuous-app needs a changefeed source: pass "
                         "--continuous-feed URL (the storage primary) or configure a "
                         "remote storage registry")
    return ContinuousConfig(app_id=args.continuous_app,
                            feed_url=remote.single_endpoint(feed_url),
                            min_events=args.continuous_min_events,
                            max_staleness_s=args.continuous_staleness_s)


def prebuild_kernels(device) -> list:
    """On a CUDA device, build every kernel library (one ``nvcc`` per
    source, all at once) before the server binds; returns the names
    compiled (none when every library was current). A failed build
    raises ``KernelBuildError``. Nothing on the CPU."""
    if resolve_device(device).type != "cuda":
        return []
    return build.build_all()


def make_server(args: argparse.Namespace, registry: Optional[StorageRegistry] = None,
                block: bool = True) -> QueryServer:
    check_ported(args)
    loader.modify_logging(args.verbose)
    registry = registry or get_registry()
    continuous = _continuous_config(args, registry)
    ed = load_engine_dir(args.engine_dir)
    loader.apply_runtime_conf(ed.variant)
    engine = loader.get_engine(ed.engine_factory, search_dir=ed.path)
    prebuild_kernels(args.device)
    config = ServerConfig(
        ip=args.ip,
        port=args.port,
        engine_instance_id=args.engine_instance_id,
        engine_id=ed.manifest.id,
        engine_version=ed.manifest.version,
        engine_variant=args.engine_variant,
        feedback=args.feedback,
        event_server_ip=args.event_server_ip,
        event_server_port=args.event_server_port,
        access_key=args.accesskey,
        batch=args.batch,
        log_url=args.log_url,
        shard_index=args.shard_index,
        shard_count=args.shard_count,
        device=args.device,
        continuous=continuous,
        **{k: v for k, v in (("batch_max", args.batch_max),
                             ("batch_pipeline_depth", args.batch_pipeline_depth))
           if v is not None},
    )
    return create_query_server(engine, config, registry, block=block)


def main(argv: Optional[Sequence[str]] = None) -> int:
    # with PIO_FLIGHT_DIR set, a dying server leaves its flight-recorder
    # timeline and faulthandler stacks behind; the SIGTERM dump only
    # from an entry point (a library import never takes a signal)
    flight.arm(signals=True)
    args = build_parser().parse_args(argv)
    server = make_server(args, block=False)
    print(json.dumps({"engineInstanceId": server.deployment.instance.id,
                      "port": server.bound_port}), flush=True)
    while server.socket.fileno() != -1:  # until GET /stop closes it
        time.sleep(0.2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
