"""Loading of user engine factories and evaluations by name.

Copy of ``predictionio_tpu/workflow/loader.py``, a rebuild of
``core/src/main/scala/io/prediction/workflow/WorkflowUtils.scala``:
``getEngine`` / ``getEvaluation`` / ``getEngineParamsGenerator``
(``WorkflowUtils.scala:61-117``) resolve a user-supplied class name; here
a dotted path (``pkg.module:attr`` or ``pkg.module.attr``) is resolved
against ``sys.path`` with the engine project directory put first, so an
``engine.py`` next to ``engine.json`` imports — the analogue of the
reference putting built jars on the classpath
(``RegisterEngine.scala:30-120``).

:func:`apply_runtime_conf` applies an engine variant's ``runtimeConf``:
the port honours its ``env`` block and refuses every other key, naming
it — the JAX runtime's ``jax``, ``xla_flags`` and ``platform`` mean
nothing to a PyTorch process, and a setting that is present must not be
dropped silently. The device is chosen with ``--device``.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import logging
import os
import sys
from typing import Any, Optional

logger = logging.getLogger(__name__)


class EngineFactoryError(Exception):
    """Factory path did not resolve (``WorkflowUtils.scala:84-91``)."""


def load_object(path: str, search_dir: Optional[str] = None) -> Any:
    """Resolve ``module:attr`` (preferred) or dotted ``module.attr``.

    ``search_dir`` (the engine project directory) goes first on
    ``sys.path`` for the import and stays there, so the engine module's
    own imports of sibling files keep working after the load."""
    if not path:
        raise EngineFactoryError("empty factory path")
    if search_dir:
        search_dir = os.path.abspath(search_dir)
        if search_dir not in sys.path:
            sys.path.insert(0, search_dir)
    if ":" in path:
        mod_name, _, attr = path.partition(":")
        try:
            module = _import_module(mod_name, search_dir)
        except ImportError as exc:
            raise EngineFactoryError(f"could not import {mod_name!r}: {exc}") from exc
        try:
            return _get_attr_chain(module, attr)
        except AttributeError as exc:
            raise EngineFactoryError(f"{path}: {exc}") from exc
    # dotted form: try progressively shorter module prefixes
    parts = path.split(".")
    for split in range(len(parts) - 1, 0, -1):
        try:
            module = _import_module(".".join(parts[:split]), search_dir)
        except ImportError:
            continue
        try:
            return _get_attr_chain(module, ".".join(parts[split:]))
        except AttributeError:
            continue
    # the whole path may itself be a module exposing an engine factory
    try:
        return _import_module(path, search_dir)
    except ImportError as exc:
        raise EngineFactoryError(
            f"could not resolve {path!r} (searched sys.path"
            + (f" + {search_dir!r}" if search_dir else "")
            + ")"
        ) from exc


def _import_module(mod_name: str, search_dir: Optional[str]) -> Any:
    """Import ``mod_name``, preferring a file inside ``search_dir``.

    Engine projects tend to name their module ``engine``, so a plain
    ``import engine`` would collide across projects. A project-local
    module is loaded by file location under a flat name made from a
    digest of the project path: pickle resolves a class's ``__module__``
    through ``sys.modules`` directly for a flat name, and the digest is
    the same in every process, so models defined in a project's
    ``engine.py`` pickle and unpickle cleanly."""
    if search_dir:
        candidate = os.path.join(search_dir, *mod_name.split(".")) + ".py"
        if os.path.exists(candidate):
            tag = hashlib.sha1(search_dir.encode("utf-8")).hexdigest()[:12]
            unique = f"_pio_engine_{tag}_{mod_name.replace('.', '_')}"
            if unique in sys.modules:
                return sys.modules[unique]
            spec = importlib.util.spec_from_file_location(unique, candidate)
            if spec is None or spec.loader is None:
                raise ImportError(f"cannot load {candidate}")
            module = importlib.util.module_from_spec(spec)
            sys.modules[unique] = module
            spec.loader.exec_module(module)
            return module
    return importlib.import_module(mod_name)


def _get_attr_chain(obj: Any, attr_path: str) -> Any:
    for attr in attr_path.split("."):
        obj = getattr(obj, attr)
    return obj


def _instantiate(obj: Any) -> Any:
    """A factory may be the instance itself, a zero-arg callable, or a class."""
    return obj() if callable(obj) else obj


def get_engine(factory: str, search_dir: Optional[str] = None):
    """``WorkflowUtils.getEngine`` (``WorkflowUtils.scala:61-91``)."""
    from ..controller.engine import Engine

    obj = _instantiate(load_object(factory, search_dir))
    if not isinstance(obj, Engine):
        raise EngineFactoryError(
            f"{factory!r} resolved to {type(obj).__name__}, not an Engine"
        )
    return obj


def get_evaluation(path: str, search_dir: Optional[str] = None):
    """``WorkflowUtils.getEvaluation`` (``WorkflowUtils.scala:93-103``)."""
    from ..controller.evaluation import Evaluation

    obj = _instantiate(load_object(path, search_dir))
    if not isinstance(obj, Evaluation):
        raise EngineFactoryError(
            f"{path!r} resolved to {type(obj).__name__}, not an Evaluation"
        )
    return obj


def get_engine_params_generator(path: str, search_dir: Optional[str] = None):
    """``WorkflowUtils.getEngineParamsGenerator``
    (``WorkflowUtils.scala:105-117``)."""
    from ..controller.evaluation import EngineParamsGenerator

    obj = _instantiate(load_object(path, search_dir))
    if not isinstance(obj, EngineParamsGenerator):
        raise EngineFactoryError(
            f"{path!r} resolved to {type(obj).__name__}, "
            "not an EngineParamsGenerator"
        )
    return obj


def apply_runtime_conf(variant) -> dict:
    """Apply an engine variant's ``runtimeConf`` (the analogue of
    engine.json's ``sparkConf``, ``WorkflowUtils.scala:321-339``).

    ``"runtimeConf": {"env": {"PIO_PROFILE_DIR": "/tmp/prof"}}`` sets
    process environment variables. Any other key raises ``ValueError``
    naming it (the JAX runtime's ``jax``, ``xla_flags`` and ``platform``
    among them). Returns the dict of applied settings."""
    conf = (variant or {}).get("runtimeConf") or {}
    refused = sorted(k for k in conf if k != "env")
    if refused:
        raise ValueError(
            f"runtimeConf keys {refused} are not applied by the PyTorch port: "
            "it honours only 'env' (the JAX runtime's 'jax', 'xla_flags' and "
            "'platform' have no meaning here; pick the device with --device)"
        )
    applied: dict = {}
    for key, value in (conf.get("env") or {}).items():
        os.environ[key] = str(value)
        applied.setdefault("env", {})[key] = str(value)
    if applied:
        logger.info("applied runtimeConf: %s", applied)
    return applied


def modify_logging(verbose: bool) -> None:
    """``WorkflowUtils.modifyLogging`` (``WorkflowUtils.scala:278-289``)."""
    level = logging.DEBUG if verbose else logging.INFO
    logging.getLogger("predictionio_tpu_torch").setLevel(level)
    logging.basicConfig(level=level)
