"""The port's train/eval workflow entry on the CPU: ``tools.run_workflow``,
``workflow.loader``, ``tools.register`` and ``workflow.version_check``.

An engine project (``engine.json``, ``engine.py``, ``evaluation.py``) is
written into ``tmp_path`` over a SQLite store holding seeded rate events;
``run_workflow.run`` trains it and sweeps its evaluation with ``--device
cpu``, in process and through ``python -m
predictionio_tpu_torch.tools.run_workflow`` in a subprocess (the two give
the same evaluation result). Without ``--device`` the run raises where
there is no CUDA; ``runtimeConf`` keys of the JAX runtime are refused,
naming the key; ``--shards`` reaches the refusal of what is not ported
and ``--checkpoint-every`` the trainer; ``--resume`` sets
``PIO_CKPT_RESUME`` for the run only. The upgrade check makes no request unless
``PIO_VERSIONS_HOST`` is set (tried against a local server only).
"""

import datetime as dt
import http.server
import json
import os
import pathlib
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.controller import Engine
from predictionio_tpu_torch.models import recommendation as rec
from predictionio_tpu_torch.storage import (
    STATUS_COMPLETED,
    STATUS_EVALCOMPLETED,
    EngineManifest,
    Event,
    StorageRegistry,
)
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.tools import register, run_workflow
from predictionio_tpu_torch.workflow import load_models, loader, version_check

REPO = pathlib.Path(__file__).resolve().parent.parent
APP = 5
T0 = dt.datetime(2024, 6, 1, tzinfo=dt.timezone.utc)
FACTORY = "predictionio_tpu_torch.models.recommendation"

ENGINE_PY = f'''"""Engine project of the run_workflow tests."""

from {FACTORY} import (  # noqa: F401
    ALSAlgorithmParams,
    RecDataSourceParams,
    engine_factory,
)
from predictionio_tpu_torch.controller import EngineParams


class Keyed:
    """A factory object with programmatic params (--engine-params-key)."""

    def __call__(self):
        return engine_factory()

    def engine_params(self, key):
        return EngineParams(
            data_source_params=("", RecDataSourceParams(app_id={APP})),
            algorithm_params_list=[
                ("als", ALSAlgorithmParams(rank=int(key), num_iterations=2))])


KEYED = Keyed()
'''

EVALUATION_PY = f'''"""Evaluation of the run_workflow tests: a 1 x 2 grid, 3 iterations."""

from {FACTORY} import (  # noqa: F401
    ALSAlgorithmParams,
    RecDataSourceParams,
    RecEvaluation,
)
from predictionio_tpu_torch.controller import EngineParams, EngineParamsGenerator


class SmallGrid(EngineParamsGenerator):
    def __init__(self):
        super().__init__([
            EngineParams(
                data_source_params=("", RecDataSourceParams(app_id={APP})),
                algorithm_params_list=[("als", ALSAlgorithmParams(
                    rank=4, num_iterations=3, lambda_=lam))])
            for lam in (0.05, 0.5)
        ])
'''


def _variant(**extra):
    return {
        "id": "default",
        "description": "run_workflow test engine",
        "engineFactory": "engine:engine_factory",
        "datasource": {"params": {"app_id": APP, "event_names": ["rate"]}},
        "algorithms": [{"name": "als", "params": {"rank": 4, "num_iterations": 3,
                                                  "lambda_": 0.05}}],
        **extra,
    }


def _write_project(path, **extra):
    path.mkdir(parents=True, exist_ok=True)
    (path / "engine.json").write_text(json.dumps(_variant(**extra)))
    (path / "engine.py").write_text(ENGINE_PY)
    (path / "evaluation.py").write_text(EVALUATION_PY)
    return path


def _seed_store(base):
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(base)})
    rng = np.random.default_rng(8)
    registry.get_events().write([
        Event(event="rate", entity_type="user", entity_id=f"u{int(rng.integers(0, 30))}",
              target_entity_type="item", target_entity_id=f"i{int(rng.integers(0, 25))}",
              properties={"rating": float(rng.integers(1, 11)) / 2},
              event_time=T0 + dt.timedelta(seconds=j), creation_time=T0)
        for j in range(400)], APP)
    return registry


@pytest.fixture()
def project(tmp_path, monkeypatch):
    """(engine project dir, registry over the seeded store, store dir);
    the registry is also the process-wide one the DataSource reads."""
    registry = _seed_store(tmp_path / "store")
    monkeypatch.setattr(port_registry, "_default_registry", registry)
    return _write_project(tmp_path / "engine"), registry, tmp_path / "store"


def _args(*argv):
    return run_workflow.build_parser().parse_args(list(argv))


EVAL_ARGS = ("--evaluation-class", "evaluation:RecEvaluation",
             "--engine-params-generator-class", "evaluation:SmallGrid")


# -- train and eval in process --------------------------------------------------
def test_run_trains_the_engine_dir_on_the_cpu(project):
    engine_dir, registry, _ = project
    iid = run_workflow.run(_args("--engine-dir", str(engine_dir), "--device", "cpu",
                                 "--batch", "nightly"), registry)
    inst = registry.get_metadata().engine_instance_get(iid)
    ed = register.load_engine_dir(str(engine_dir))
    assert inst.status == STATUS_COMPLETED and inst.batch == "nightly"
    assert (inst.engine_id, inst.engine_version) == (ed.manifest.id, ed.manifest.version)
    assert inst.engine_factory == "engine:engine_factory"
    assert json.loads(inst.algorithms_params)[0]["params"]["rank"] == 4
    (model,) = load_models(registry, iid)
    assert model.user_factors.shape[1] == 4 and model.item_factors.shape[0] == 25
    model.sanity_check()


def test_engine_params_key_takes_the_factory_objects_params(project):
    engine_dir, registry, _ = project
    iid = run_workflow.run(_args("--engine-dir", str(engine_dir), "--device", "cpu",
                                 "--engine-factory", "engine:KEYED",
                                 "--engine-params-key", "3"), registry)
    (model,) = load_models(registry, iid)
    assert model.rank == 3


def test_run_sweeps_the_evaluation_on_the_cpu(project, tmp_path):
    engine_dir, registry, _ = project
    iid = run_workflow.run(_args("--engine-dir", str(engine_dir), *EVAL_ARGS,
                                 "--eval-parallelism", "2"), registry, device="cpu")
    row = registry.get_metadata().evaluation_instance_get(iid)
    assert row.status == STATUS_EVALCOMPLETED
    assert (row.evaluation_class, row.engine_params_generator_class) == (
        "RecEvaluation", "SmallGrid")
    result = json.loads(row.evaluator_results_json)
    assert [s["engineParams"]["algorithms"][0]["params"]["lambda_"]
            for s in result["scores"]] == [0.05, 0.5]
    assert all(0.0 <= s["score"] <= 1.0 for s in result["scores"])
    assert result["metricHeader"] == "Precision@10 (threshold=4.0)"


def test_an_evaluation_needs_no_engine_json(project, tmp_path):
    _, registry, _ = project
    bare = tmp_path / "bare"
    bare.mkdir()
    (bare / "evaluation.py").write_text(EVALUATION_PY)
    iid = run_workflow.run(_args("--engine-dir", str(bare), "--device", "cpu", *EVAL_ARGS),
                           registry)
    assert registry.get_metadata().evaluation_instance_get(iid).status == STATUS_EVALCOMPLETED


def test_a_subprocess_run_trains_and_evaluates_like_an_in_process_one(project):
    engine_dir, registry, store = project
    env = dict(os.environ, PIO_FS_BASEDIR=str(store), PYTHONPATH=str(REPO))
    out = {}
    for name, extra in (("train", ()), ("eval", EVAL_ARGS)):
        proc = subprocess.run(
            [sys.executable, "-m", "predictionio_tpu_torch.tools.run_workflow",
             "--engine-dir", str(engine_dir), "--device", "cpu", *extra],
            cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        out[name] = json.loads(proc.stdout.strip().splitlines()[-1])["engineInstanceId"]
    md = registry.get_metadata()
    assert md.engine_instance_get(out["train"]).status == STATUS_COMPLETED
    spawned = md.evaluation_instance_get(out["eval"])
    iid = run_workflow.run(_args("--engine-dir", str(engine_dir), "--device", "cpu",
                                 *EVAL_ARGS), registry)
    here = md.evaluation_instance_get(iid)
    assert spawned.status == STATUS_EVALCOMPLETED
    assert json.loads(spawned.evaluator_results_json) == json.loads(here.evaluator_results_json)


# -- what run_workflow refuses -------------------------------------------------------
def test_without_a_device_run_workflow_takes_the_card_or_raises(project):
    engine_dir, registry, _ = project
    if torch.cuda.is_available():
        assert run_workflow.WorkflowContext().device == torch.device("cuda", 0)
        return
    for extra in ((), EVAL_ARGS):
        with pytest.raises(RuntimeError, match="CUDA"):
            run_workflow.run(_args("--engine-dir", str(engine_dir), *extra), registry)
    md = registry.get_metadata()
    assert md.engine_instance_get_all() == []
    assert md.evaluation_instance_get("EVI-00000001") is None


@pytest.mark.parametrize("key,value", [("jax", {"jax_enable_x64": True}),
                                       ("xla_flags", "--xla_force_host_platform_device_count=8"),
                                       ("platform", "cpu")])
def test_runtime_conf_of_the_jax_runtime_is_refused_by_name(key, value, tmp_path, project):
    _, registry, _ = project
    engine_dir = _write_project(tmp_path / f"conf_{key}", runtimeConf={key: value})
    for extra in ((), EVAL_ARGS):
        with pytest.raises(ValueError, match=key):
            run_workflow.run(_args("--engine-dir", str(engine_dir), "--device", "cpu",
                                   *extra), registry)
    assert registry.get_metadata().engine_instance_get_all() == []


def test_runtime_conf_env_is_applied(tmp_path, project, monkeypatch):
    _, registry, _ = project
    monkeypatch.setenv("PIO_RUN_WORKFLOW_MARK", "before")
    engine_dir = _write_project(tmp_path / "conf_env",
                                runtimeConf={"env": {"PIO_RUN_WORKFLOW_MARK": 7}})
    assert loader.apply_runtime_conf(json.loads((engine_dir / "engine.json").read_text())) \
        == {"env": {"PIO_RUN_WORKFLOW_MARK": "7"}}
    assert os.environ["PIO_RUN_WORKFLOW_MARK"] == "7"
    assert loader.apply_runtime_conf({}) == {}


def test_shards_and_checkpoint_cadence_reach_the_refusals(project, tmp_path, monkeypatch):
    """``--shards`` above 1 reaches the refusal; ``--checkpoint-every``
    reaches the trainer: a training run checkpoints every iteration into
    the pinned directory, an evaluation trains without checkpoints."""
    engine_dir, registry, _ = project
    base = ("--engine-dir", str(engine_dir), "--device", "cpu")
    assert "PIO_TRAIN_SHARDS" not in os.environ
    with pytest.raises(NotImplementedError, match="sharded"):
        run_workflow.run(_args(*base, "--shards", "2"), registry)
    with pytest.raises(ValueError, match="PIO_TRAIN_SHARDS"):
        run_workflow.run(_args(*base, "--shards", "0"), registry)
    assert "PIO_TRAIN_SHARDS" not in os.environ  # scoped to the run
    ck = tmp_path / "ck"
    monkeypatch.setenv("PIO_CKPT_DIR", str(ck))
    iid = run_workflow.run(_args(*base, "--checkpoint-every", "1"), registry)
    assert registry.get_metadata().engine_instance_get(iid).status == STATUS_COMPLETED
    assert sorted(os.listdir(ck / "algo_0")) == ["step_1", "step_2", "step_3"]
    shutil.rmtree(ck)
    eid = run_workflow.run(_args(*base, "--checkpoint-every", "1", *EVAL_ARGS), registry)
    assert registry.get_metadata().evaluation_instance_get(eid).status == "EVALCOMPLETED"
    assert not ck.exists()
    # --shards 1 and cadence 0 train as usual
    iid = run_workflow.run(_args(*base, "--shards", "1", "--checkpoint-every", "0"),
                           registry)
    assert registry.get_metadata().engine_instance_get(iid).status == STATUS_COMPLETED


@pytest.mark.parametrize("flag,value", [("--resume", "1"), ("--no-resume", "0")])
def test_resume_sets_the_environment_for_the_run_only(flag, value, project, monkeypatch):
    engine_dir, registry, _ = project
    seen = {}

    def fake_run_train(*a, **kw):
        seen["resume"] = os.environ.get("PIO_CKPT_RESUME")
        return "EI-fake"

    monkeypatch.delenv("PIO_CKPT_RESUME", raising=False)
    monkeypatch.setattr(run_workflow, "run_train", fake_run_train)
    assert run_workflow.run(_args("--engine-dir", str(engine_dir), "--device", "cpu",
                                  flag), registry) == "EI-fake"
    assert seen == {"resume": value} and "PIO_CKPT_RESUME" not in os.environ


# -- loader and register ------------------------------------------------------------
def test_load_object_resolves_every_form(tmp_path):
    assert loader.load_object(f"{FACTORY}:engine_factory") is rec.engine_factory
    assert loader.load_object(f"{FACTORY}.engine_factory") is rec.engine_factory
    assert loader.load_object(f"{FACTORY}.RecEvaluation.__init__") is rec.RecEvaluation.__init__
    assert loader.load_object(FACTORY) is rec
    assert isinstance(loader.get_engine(f"{FACTORY}:engine_factory"), Engine)
    assert isinstance(loader.get_evaluation(f"{FACTORY}:RecEvaluation"), rec.RecEvaluation)
    grid = loader.get_engine_params_generator(f"{FACTORY}:RecParamsGenerator")
    assert len(grid.engine_params_list) == 4
    for bad in ("", "no_such_module_xyz:thing", f"{FACTORY}:nothing_here",
                "no.such.path.anywhere"):
        with pytest.raises(loader.EngineFactoryError):
            loader.load_object(bad)
    with pytest.raises(loader.EngineFactoryError, match="not an Engine"):
        loader.get_engine(f"{FACTORY}:RecEvaluation")
    with pytest.raises(loader.EngineFactoryError, match="not an Evaluation"):
        loader.get_evaluation(f"{FACTORY}:engine_factory")
    with pytest.raises(loader.EngineFactoryError, match="not an EngineParamsGenerator"):
        loader.get_engine_params_generator(f"{FACTORY}:RecEvaluation")
    # two projects' engine.py load as two modules
    one, two = tmp_path / "one", tmp_path / "two"
    for d, tag in ((one, "1"), (two, "2")):
        d.mkdir()
        (d / "engine.py").write_text(f"TAG = {tag}\n")
    assert loader.load_object("engine:TAG", str(one)) == 1
    assert loader.load_object("engine:TAG", str(two)) == 2


def test_register_engine_writes_and_finds_the_manifest(tmp_path):
    engine_dir = _write_project(tmp_path / "proj")
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path / "meta")})
    assert register.registered_manifest(registry, str(engine_dir)) is None
    ed = register.register_engine(registry, str(engine_dir))
    on_disk = json.loads((engine_dir / "manifest.json").read_text())
    assert on_disk["id"] == ed.manifest.id and on_disk["engineFactory"] == "engine:engine_factory"
    assert register.registered_manifest(registry, str(engine_dir)) == EngineManifest(
        id=ed.manifest.id, version=ed.manifest.version, name="proj",
        description="run_workflow test engine", files=(str(engine_dir),),
        engine_factory="engine:engine_factory")
    assert register.generate_manifest(str(engine_dir)).version == ed.manifest.version
    (engine_dir / "engine.py").write_text(ENGINE_PY + "\n# edited\n")
    assert register.load_engine_dir(str(engine_dir)).manifest.version != ed.manifest.version
    md = registry.get_metadata()
    ghost = EngineManifest(id="ghost", version="1", name="g")
    assert md.manifest_update(ghost, upsert=False) is False
    assert md.manifest_get("ghost", "1") is None
    assert md.manifest_update(ghost) is True and md.manifest_get("ghost", "1").name == "g"
    with pytest.raises(register.EngineDirError, match="not found"):
        register.load_engine_dir(str(tmp_path / "nowhere"))
    (engine_dir / "engine.json").write_text(json.dumps({"id": "x"}))
    with pytest.raises(register.EngineDirError, match="engineFactory"):
        register.load_engine_dir(str(engine_dir)).engine_factory


# -- the upgrade check ---------------------------------------------------------------
@pytest.fixture()
def versions_server():
    """A local version index answering ``{"version": ...}``."""
    answer = {}

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            answer["path"] = self.path
            body = json.dumps({"version": answer["version"]}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", answer
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_the_upgrade_check_is_opt_in(monkeypatch, versions_server):
    host, answer = versions_server
    monkeypatch.delenv("PIO_NO_UPGRADE_CHECK", raising=False)
    monkeypatch.delenv("PIO_VERSIONS_HOST", raising=False)
    assert version_check.check_upgrade("training") is None
    monkeypatch.setenv("PIO_VERSIONS_HOST", host + "/")
    monkeypatch.setenv("PIO_NO_UPGRADE_CHECK", "1")
    assert version_check.check_upgrade("training") is None
    monkeypatch.delenv("PIO_NO_UPGRADE_CHECK")
    answer["version"] = "99.0.1"
    thread = version_check.check_upgrade("evaluation", "RecEvaluation")
    thread.join(timeout=10)
    assert not thread.is_alive()
    from predictionio_tpu_torch import __version__

    assert answer["path"] == f"/{__version__}/evaluation/RecEvaluation.json"
    assert version_check._run_check("evaluation", "") == "99.0.1"
    answer["version"] = "0.0.1"
    assert version_check._run_check("evaluation", "") is None
    assert version_check.check_url("core", version="1.2") == f"{host}/1.2/core.json"
    assert version_check._parse_version("0.9.2-SNAPSHOT") == (0, 9, 2)
    assert version_check._parse_version("x") is None
