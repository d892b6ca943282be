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
a compilation cache); a build failure ends the deploy. The flags of
modules that are not ported raise, naming their ROADMAP item: feedback
events, the error log URL and sharded serving (queue 1 item 6), the
continuous loop (item 9); so do a flight-recorder directory
(``PIO_FLIGHT_DIR``, item 6) and a partitioned event store
(``PIO_STORAGE_SOURCES_*_PARTITIONS``, item 12).
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
    # the reference's flags whose planes are not ported: each raises
    p.add_argument("--feedback", action="store_true")
    p.add_argument("--event-server-ip", default="localhost")
    p.add_argument("--event-server-port", type=int, default=7070)
    p.add_argument("--accesskey", default=None)
    p.add_argument("--log-url", default=None)
    p.add_argument("--shard-index", type=int, default=0, metavar="I")
    p.add_argument("--shard-count", type=int, default=1, metavar="N")
    p.add_argument("--continuous-app", type=int, default=None, metavar="APP_ID")
    p.add_argument("--continuous-feed", default=None, metavar="URL")
    p.add_argument("--verbose", action="store_true")
    return p


def check_ported(args: argparse.Namespace, env=None) -> None:
    """Raise for a flag or an environment whose module is not ported."""
    env = os.environ if env is None else env
    if args.continuous_app is not None or args.continuous_feed:
        raise not_ported("the continuous-learning loop (--continuous-*)", 9)
    if args.feedback or args.accesskey:
        raise not_ported("feedback events (--feedback, --accesskey)", 6)
    if args.log_url:
        raise not_ported("the serving error log (--log-url)", 6)
    if args.shard_count != 1 or args.shard_index != 0:
        raise not_ported("sharded serving (--shard-index, --shard-count)", 6)
    if env.get("PIO_FLIGHT_DIR"):
        raise not_ported("the flight recorder (PIO_FLIGHT_DIR)", 6)
    if any(k.startswith("PIO_STORAGE_SOURCES_") and k.endswith("_PARTITIONS")
           for k in env):
        raise not_ported("a partitioned event store (PIO_STORAGE_SOURCES_*_PARTITIONS)", 12)


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
        batch=args.batch,
        device=args.device,
        **{k: v for k, v in (("batch_max", args.batch_max),
                             ("batch_pipeline_depth", args.batch_pipeline_depth))
           if v is not None},
    )
    return create_query_server(engine, config, registry, block=block)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    server = make_server(args, block=False)
    print(json.dumps({"engineInstanceId": server.deployment.instance.id,
                      "port": server.bound_port}), flush=True)
    while server.socket.fileno() != -1:  # until GET /stop closes it
        time.sleep(0.2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
