"""The port's console (``python -m predictionio_tpu_torch.tools.console``)
and its ``run_server``, mirroring ``tests/test_tools.py``'s cases for the
JAX package on the CPU (``--device cpu``): the app and access-key
consoles, ``status``, registration, the recommendation template's whole
lifecycle (build → train → deploy → query → reload → undeploy) whose
served answers equal the JAX template's ``batch_predict`` on the port's
factors, a train run in a spawned child that never imports jax, a
project-local model class that survives train → deploy, ``deploy
--spawn`` and ``undeploy``, and every command or flag whose module is not
ported refused with its ROADMAP item.
"""

import dataclasses
import datetime as dt
import json
import os
import pathlib
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu.storage.bimap import BiMap as JaxBiMap
from predictionio_tpu_torch.ckpt import CheckpointStore
from predictionio_tpu_torch.models import recommendation as rec
from predictionio_tpu_torch.storage import Event, EventFilter, get_registry
from predictionio_tpu_torch.tools import console
from predictionio_tpu_torch.tools import register as register_mod
from predictionio_tpu_torch.tools import run_server
from predictionio_tpu_torch.tools.templates import get_template
from predictionio_tpu_torch.workflow import load_models

REPO = pathlib.Path(__file__).resolve().parent.parent
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
SERVE_RTOL = SERVE_ATOL = 1e-5


@pytest.fixture()
def registry(tmp_path, monkeypatch):
    """The process-wide registry on a fresh base dir (the templates'
    DataSources read ``get_registry()``); children find the repo."""
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "store"))
    monkeypatch.setenv("PYTHONPATH", str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    reg = get_registry(refresh=True)
    yield reg
    get_registry(refresh=True)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, json.loads(resp.read().decode() or "{}")


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read().decode())


def _ingest_rates(registry, app_id=1, n_users=8, n_items=6):
    store = registry.get_events()
    store.init(app_id)
    events = [
        Event(event="rate", entity_type="user", entity_id=f"u{u}",
              target_entity_type="item", target_entity_id=f"i{i}",
              properties={"rating": float(1 + (u * i) % 5)},
              event_time=T0 + dt.timedelta(minutes=u * n_items + i))
        for u in range(n_users) for i in range(n_items) if (u + i) % 2 == 0
    ]
    store.write(events, app_id)
    return len(events)


# -- app / accesskey consoles -------------------------------------------------------
def test_app_lifecycle(registry):
    out = console.app_new(registry, "myapp", access_key="k1")
    assert out["accessKey"] == "k1" and out["id"] >= 1
    with pytest.raises(ValueError):
        console.app_new(registry, "myapp")
    apps = console.app_list(registry)
    assert [a["name"] for a in apps] == ["myapp"] and apps[0]["accessKeys"] == ["k1"]
    assert console.app_show(registry, "myapp")["accessKeys"][0]["key"] == "k1"
    console.accesskey_new(registry, "myapp", events=["rate"], key="k2")
    assert {k["key"] for k in console.accesskey_list(registry, "myapp")} == {"k1", "k2"}
    console.accesskey_delete(registry, "k2")
    assert len(console.accesskey_list(registry)) == 1
    # data-delete wipes the events and keeps the app
    store, app_id = registry.get_events(), out["id"]
    store.insert(Event(event="$set", entity_type="user", entity_id="u1", event_time=T0),
                 app_id)
    console.app_data_delete(registry, "myapp")
    assert list(store.find(app_id, EventFilter())) == []
    assert [a["name"] for a in console.app_list(registry)] == ["myapp"]
    console.app_delete(registry, "myapp")
    assert console.app_list(registry) == []


def test_console_main_app_commands(registry, capsys):
    assert console.main(["app", "new", "cliapp"], registry) == 0
    assert json.loads(capsys.readouterr().out)["name"] == "cliapp"
    assert console.main(["app", "list"], registry) == 0
    # a destructive command without --force off a terminal is refused
    assert console.main(["app", "delete", "cliapp"], registry) == 1
    assert console.app_list(registry), "a refused delete must not remove the app"
    capsys.readouterr()
    assert console.main(["app", "delete", "cliapp", "--force"], registry) == 0
    assert console.main(["app", "show", "nope"], registry) == 1
    capsys.readouterr()
    # not an engine project: a JSON error, not a traceback
    assert console.main(["build", "--engine-dir", "/tmp"], registry) == 1
    assert "error" in json.loads(capsys.readouterr().out)


def test_status(registry, capsys):
    result = console.status(registry)
    assert result["ok"] and set(result["storage"]) == {"metadata", "modeldata", "eventdata"}
    assert console.main(["status"], registry) == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True


def test_import_and_export_through_the_console(registry, tmp_path, capsys):
    n = _ingest_rates(registry, app_id=1)
    out = tmp_path / "events.jsonl"
    assert console.main(["export", "--appid", "1", "--output", str(out)], registry) == 0
    assert json.loads(capsys.readouterr().out)["events"] == n
    assert console.main(["import", "--appid", "4", "--input", str(out)], registry) == 0
    assert json.loads(capsys.readouterr().out)["events"] == n
    assert len(list(registry.get_events().find(4, EventFilter()))) == n
    assert console.main(["import", "--appid", "4", "--input", str(out), "--format",
                         "parquet"], registry) == 1
    assert "queue 1 item 14" in json.loads(capsys.readouterr().out)["error"]


def test_register_engine_manifest(registry, tmp_path):
    target = tmp_path / "proj"
    get_template("recommendation", str(target))
    ed = register_mod.register_engine(registry, str(target))
    stored = registry.get_metadata().manifest_get(ed.manifest.id, ed.manifest.version)
    assert stored is not None and stored.engine_factory == "engine:engine_factory"
    assert os.path.exists(target / "manifest.json")
    # editing the project bumps the version
    (target / "engine.py").write_text((target / "engine.py").read_text() + "\n# edited\n")
    ed2 = register_mod.register_engine(registry, str(target))
    assert ed2.manifest.id == ed.manifest.id and ed2.manifest.version != ed.manifest.version


def test_template_commands(registry, tmp_path, capsys):
    assert console.main(["template", "list"], registry) == 0
    assert {t["name"] for t in json.loads(capsys.readouterr().out)} >= {
        "recommendation", "sequencerec"}
    assert console.main(["template", "get", "sequencerec", str(tmp_path / "s")], registry) == 0
    assert (tmp_path / "s" / "engine.py").exists()
    capsys.readouterr()
    assert console.main(["template", "get", "classification", str(tmp_path / "e")],
                        registry) == 1
    assert "queue 1 item 14" in json.loads(capsys.readouterr().out)["error"]


# -- end to end: build → train → deploy → query → reload → undeploy --------------------
def _scores_ids(results):
    return {i: ([x.item for x in r.item_scores],
                np.array([x.score for x in r.item_scores], np.float32))
            for i, r in results}


def test_full_lifecycle_recommendation(registry, tmp_path, capsys):
    _ingest_rates(registry, app_id=1)
    target = tmp_path / "proj"
    get_template("recommendation", str(target))
    assert console.main(["build", "--engine-dir", str(target)], registry) == 0
    build_out = json.loads(capsys.readouterr().out)
    assert console.main(["train", "--engine-dir", str(target), "--device", "cpu"],
                        registry) == 0
    instance_id = json.loads(capsys.readouterr().out)["engineInstanceId"]
    inst = registry.get_metadata().engine_instance_get(instance_id)
    assert inst is not None and inst.status == "COMPLETED"
    assert inst.engine_id == build_out["engineId"]
    (model,) = load_models(registry, instance_id)

    srv_args = run_server.build_parser().parse_args(
        ["--engine-dir", str(target), "--port", "0", "--device", "cpu"])
    server = run_server.make_server(srv_args, registry, block=False)
    queries = [(i, {"user": f"u{i % 9}", "num": 1 + i % 5}) for i in range(12)]
    try:
        port = server.bound_port
        served = {}
        for i, body in queries:
            stat, data = _post(f"http://localhost:{port}/queries.json", body)
            assert stat == 200
            served[i] = rec.PredictedResult(item_scores=tuple(
                rec.ItemScore(**x) for x in data["itemScores"]))
        assert _get(f"http://localhost:{port}/status.json")[1]["topkPath"]
        stat, _ = _get(f"http://localhost:{port}/reload")
        assert stat == 200
        stat, again = _post(f"http://localhost:{port}/queries.json", {"user": "u1", "num": 3})
        assert stat == 200 and again["itemScores"]
        assert console.undeploy("localhost", port)["status"] == 200
    finally:
        server.stop_async()
        server.server_close()
    # the JAX template serving the port's factors answers the same
    carried = jrec.ALSModel(rank=model.rank, user_factors=model.user_factors,
                            item_factors=model.item_factors,
                            user_map=JaxBiMap(model.user_map.to_dict()),
                            item_map=JaxBiMap(model.item_map.to_dict()))
    params = json.loads((target / "engine.json").read_text())["algorithms"][0]["params"]
    jalgo = jrec.ALSAlgorithm(jrec.ALSAlgorithmParams(**params))
    want = _scores_ids(jalgo.batch_predict(carried, [(i, jrec.Query(**b)) for i, b in queries]))
    got = _scores_ids(served.items())
    for i, (w_items, w_scores) in want.items():
        g_items, g_scores = got[i]
        assert len(g_items) == len(w_items)
        np.testing.assert_allclose(g_scores, w_scores, rtol=SERVE_RTOL, atol=SERVE_ATOL)
        tied = np.isclose(g_scores, w_scores, rtol=SERVE_RTOL, atol=SERVE_ATOL)
        assert all(s or t for s, t in zip((a == b for a, b in zip(g_items, w_items)), tied))


SITECUSTOMIZE = '''
import atexit, importlib.abc, json, os, sys

FORBIDDEN = ("jax", "jaxlib", "predictionio_tpu")


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"{name} imported in a port child")
        return None


sys.meta_path.insert(0, _Refuse())


@atexit.register
def _report():
    bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    with open(os.environ["PIO_CHILD_REPORT"], "w") as fh:
        json.dump({"argv": sys.argv, "forbidden": bad}, fh)
'''


def test_train_via_spawned_subprocess(registry, tmp_path, monkeypatch):
    """``train --spawn`` runs ``python -m
    predictionio_tpu_torch.tools.run_workflow`` with ``--device``; the
    child refuses any import of jax or the JAX package (a ``sitecustomize``
    hook on its path) and reports its modules at exit."""
    _ingest_rates(registry, app_id=1)
    target = tmp_path / "proj"
    get_template("recommendation", str(target))
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(SITECUSTOMIZE)
    report = tmp_path / "report.json"
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(hook), str(REPO)]))
    monkeypatch.setenv("PIO_CHILD_REPORT", str(report))
    rc = console.main(["train", "--engine-dir", str(target), "--spawn", "--device", "cpu"],
                      registry)
    assert rc == 0
    child = json.loads(report.read_text())
    assert child["forbidden"] == []
    assert "--device" in child["argv"] and child["argv"][child["argv"].index("--device") + 1] == "cpu"
    (inst,) = [i for i in registry.get_metadata().engine_instance_get_all()
               if i.engine_variant == "engine.json"]
    assert inst.status == "COMPLETED"


def test_custom_engine_model_pickles_across_train_and_deploy(registry, tmp_path):
    """A model class defined in the project's own engine.py survives the
    pickle → model store → unpickle round trip."""
    target = tmp_path / "custom"
    target.mkdir()
    (target / "engine.json").write_text(json.dumps({
        "engineFactory": "engine:engine_factory",
        "algorithms": [{"name": "", "params": {}}],
    }))
    (target / "engine.py").write_text(
        "import dataclasses\n"
        "from predictionio_tpu_torch.controller import (\n"
        "    Algorithm, DataSource, Engine, FirstServing, IdentityPreparator)\n"
        "\n"
        "@dataclasses.dataclass\n"
        "class MyModel:\n"
        "    weight: float\n"
        "\n"
        "class DS(DataSource):\n"
        "    def read_training(self, ctx):\n"
        "        return [1.0, 2.0, 3.0]\n"
        "\n"
        "class Algo(Algorithm):\n"
        "    def train(self, ctx, pd):\n"
        "        return MyModel(weight=sum(pd))\n"
        "    def predict(self, model, query):\n"
        "        return {'w': model.weight * query.get('x', 1)}\n"
        "\n"
        "def engine_factory():\n"
        "    return Engine({'': DS}, {'': IdentityPreparator}, {'': Algo},\n"
        "                  {'': FirstServing})\n"
    )
    assert console.main(["train", "--engine-dir", str(target), "--device", "cpu"],
                        registry) == 0
    srv_args = run_server.build_parser().parse_args(
        ["--engine-dir", str(target), "--port", "0", "--device", "cpu"])
    server = run_server.make_server(srv_args, registry, block=False)
    try:
        stat, body = _post(f"http://localhost:{server.bound_port}/queries.json", {"x": 2.0})
        assert stat == 200 and body["w"] == 12.0
    finally:
        server.stop_async()
        server.server_close()


def test_deploy_spawn_and_undeploy(registry, tmp_path, capsys):
    """``deploy --spawn`` starts ``run_server`` as a detached child on the
    given port; ``undeploy`` stops it, after which the port is free."""
    import socket

    _ingest_rates(registry, app_id=1)
    target = tmp_path / "proj"
    get_template("recommendation", str(target))
    assert console.main(["train", "--engine-dir", str(target), "--device", "cpu"],
                        registry) == 0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    capsys.readouterr()
    assert console.main(["deploy", "--engine-dir", str(target), "--ip", "127.0.0.1",
                         "--port", str(port), "--device", "cpu", "--spawn"], registry) == 0
    spawned = json.loads(capsys.readouterr().out)
    assert spawned["spawned"] == "predictionio_tpu_torch.tools.run_server"
    deadline = time.monotonic() + 60
    while True:
        try:
            stat, body = _post(f"http://127.0.0.1:{port}/queries.json", {"user": "u2", "num": 2})
            break
        except OSError:
            assert time.monotonic() < deadline, open(spawned["log"]).read()[-2000:]
            time.sleep(0.2)
    assert stat == 200 and len(body["itemScores"]) == 2
    assert console.main(["undeploy", "--ip", "127.0.0.1", "--port", str(port)], registry) == 0
    deadline = time.monotonic() + 30
    while True:  # a new server can bind it (as HTTPServer does, SO_REUSEADDR)
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind(("127.0.0.1", port))
                break
            except OSError:
                assert time.monotonic() < deadline, "the port stayed taken after undeploy"
                time.sleep(0.2)


def test_eventserver_command_takes_events_into_the_apps_store(registry, tmp_path):
    """``pio eventserver`` serves the registry's store: an event posted
    with the app's key lands in that app."""
    import socket

    app = console.app_new(registry, "evapp", access_key="key1")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.console", "eventserver",
         "--ip", "127.0.0.1", "--port", str(port)],
        cwd=str(REPO), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 60
        body = {"event": "rate", "entityType": "user", "entityId": "u1",
                "targetEntityType": "item", "targetEntityId": "i1",
                "properties": {"rating": 4}, "eventTime": "2026-01-01T00:00:00.000Z"}
        while True:
            try:
                stat, out = _post(f"http://127.0.0.1:{port}/events.json?accessKey=key1", body)
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.2)
        assert stat == 201 and out["eventId"]
        (event,) = registry.get_events().find(app["id"], EventFilter())
        assert (event.entity_id, event.target_entity_id) == ("u1", "i1")
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_commands_that_need_no_device_do_not_import_torch(registry, tmp_path):
    """Apps, keys, status, templates, import, ``ckpt``, ``trace`` and
    ``health`` run without torch (a console process spends its start-up on what its command
    needs)."""
    (tmp_path / "ck").mkdir()
    code = (
        "import sys\n"
        "from predictionio_tpu_torch.tools import console\n"
        "for argv in (['app', 'new', 'a'], ['status'], ['template', 'list'],\n"
        "             ['template', 'get', 'recommendation', sys.argv[1]],\n"
        "             ['ckpt', 'ls', '--dir', sys.argv[2]]):\n"
        "    assert console.main(argv) == 0, argv\n"
        "assert console.main(['trace', 'x', '--nodes', '127.0.0.1:9', '--timeout', '0.2']) == 1\n"
        "assert console.main(['health', '--nodes', '127.0.0.1:9', '--timeout', '0.2']) == 2\n"
        "assert 'torch' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "proj"),
                           str(tmp_path / "ck")],
                          capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_train_without_a_device_raises_on_a_cpu_box(registry, tmp_path, capsys):
    if __import__("torch").cuda.is_available():
        pytest.skip("this box has a card: the default device is cuda:0 there")
    _ingest_rates(registry, app_id=1)
    target = tmp_path / "proj"
    get_template("recommendation", str(target))
    assert console.main(["train", "--engine-dir", str(target)], registry) == 1
    assert "CUDA" in json.loads(capsys.readouterr().out)["error"]


# -- what is not ported ---------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(console.NOT_PORTED))
def test_commands_of_modules_not_ported_name_their_roadmap_item(name, registry, capsys):
    item = console.NOT_PORTED[name][1]
    assert console.main([name, "--some", "args"], registry) == 1
    error = json.loads(capsys.readouterr().out)["error"]
    assert f"ROADMAP.md, queue 1 item {item})" in error


@pytest.mark.parametrize("name,item", [("router", 13), ("sharedcache", 13), ("profile", 14)])
def test_router_sharedcache_and_profile_exit_1_naming_their_item(name, item, registry,
                                                                  capsys):
    """The JAX console's ``router``, ``sharedcache`` and ``profile`` are
    refused by name (exit 1), not by argparse (exit 2)."""
    assert console.main([name, "--port", "9"], registry) == 1
    error = json.loads(capsys.readouterr().out)["error"]
    assert f"`pio {name}`" in error and f"ROADMAP.md, queue 1 item {item})" in error


@pytest.mark.parametrize("argv,code,needle", [
    (["rollout", "status", "--ip", "127.0.0.1", "--port", "CLOSED"], 1, "no query server"),
    (["quality", "--diff", "--snapshots", "/nonexistent/q.jsonl"], 2, ""),
])
def test_rollout_and_quality_are_ported(argv, code, needle, capsys):
    """``rollout`` and ``quality`` left ``NOT_PORTED``: an HTTP client and
    the quality CLI, each with its own exit codes (nothing to reach here)."""
    from torch_plane import closed_port

    argv = [str(closed_port()) if a == "CLOSED" else a for a in argv]
    assert argv[0] not in console.NOT_PORTED
    assert console.main(argv) == code
    captured = capsys.readouterr()
    assert needle in captured.out and "not ported" not in captured.out + captured.err


@pytest.mark.parametrize("argv,key", [(["ckpt", "ls", "--json"], "uncommitted"),
                                      (["checkpoint", "verify", "--json"], "ok")])
def test_ckpt_and_its_alias_reach_the_checkpoint_cli(argv, key, tmp_path, capsys):
    store = CheckpointStore(str(tmp_path / "store"))
    store.save(4, {"x": np.ones((3, 2), np.float32)}, {"iteration": 4})
    assert console.main(argv + ["--dir", store.root]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert [s["step"] for s in doc["steps"]] == [4] and key in doc


@pytest.mark.parametrize("flags,env,item", [
    (["--continuous-app", "1"], {}, 9),
    (["--continuous-feed", "http://127.0.0.1:1"], {}, 9),
    (["--continuous-app", "1", "--feedback"], {}, 9),
    ([], {"PIO_STORAGE_SOURCES_S_PARTITIONS": "a:1;b:2"}, 12),
    (["--shard-count", "2"], {"PIO_STORAGE_SOURCES_EV_PARTITIONS": "a:1"}, 12),
])
def test_deploy_flags_of_modules_not_ported_name_their_roadmap_item(
        flags, env, item, registry, tmp_path, capsys, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    target = tmp_path / "proj"
    get_template("recommendation", str(target))
    args = run_server.build_parser().parse_args(["--engine-dir", str(target), *flags])
    with pytest.raises(NotImplementedError, match=rf"queue 1 item {item}\)"):
        run_server.check_ported(args)
    assert console.main(["deploy", "--engine-dir", str(target), "--device", "cpu",
                         "--spawn", *flags], registry) == 1
    assert f"queue 1 item {item})" in json.loads(capsys.readouterr().out)["error"]


@pytest.mark.parametrize("flags,env,field,value", [
    (["--feedback"], {}, "feedback", True),
    (["--accesskey", "k", "--event-server-port", "7171"], {}, "access_key", "k"),
    (["--log-url", "http://127.0.0.1:1/log"], {}, "log_url", "http://127.0.0.1:1/log"),
    (["--shard-index", "1", "--shard-count", "2"], {}, "shard_count", 2),
    ([], {"PIO_FLIGHT_DIR": "/tmp/x"}, "feedback", False),
])
def test_deploy_takes_the_request_plane_flags(flags, env, field, value, registry, tmp_path,
                                              monkeypatch):
    """The flags and settings of the request plane (queue 1 item 6) are
    accepted and reach ``ServerConfig``."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    target = tmp_path / "proj"
    get_template("recommendation", str(target))
    args = run_server.build_parser().parse_args(["--engine-dir", str(target), "--device",
                                                 "cpu", *flags])
    run_server.check_ported(args)
    seen = {}
    monkeypatch.setattr(run_server, "create_query_server",
                        lambda engine, config, reg, block: seen.setdefault("config", config))
    config = run_server.make_server(args, registry, block=False)
    assert config is seen["config"] and getattr(config, field) == value
    assert config.event_server_port == (7171 if "--event-server-port" in flags else 7070)
    assert config.shard_index == (1 if "--shard-index" in flags else 0)


@pytest.mark.parametrize("argv,code", [
    (["trace", "abc", "--nodes", "127.0.0.1:9", "--timeout", "0.5"], 1),
    (["health", "--nodes", "127.0.0.1:9", "--timeout", "0.5"], 2),
    (["alerts"], 2),
    (["blackbox", "show", "--file", "/nonexistent/flight.jsonl"], 2),
])
def test_the_health_and_trace_commands_are_ported(argv, code, capsys, monkeypatch):
    """``trace`` left ``NOT_PORTED``; it and the health commands answer
    with their own pinned exit codes (here: nothing reachable)."""
    monkeypatch.delenv("PIO_ALERT_LEDGER", raising=False)
    assert argv[0] not in console.NOT_PORTED
    assert console.main(argv) == code
    captured = capsys.readouterr()
    assert "not ported" not in captured.out + captured.err


def test_the_kernels_are_built_before_a_card_deploy_binds(monkeypatch):
    """On CUDA every ``.cu`` is built through ``kernels/build.py`` before
    the server binds, and a build failure ends the deploy; on the CPU
    nothing is built."""
    from predictionio_tpu_torch.kernels import build

    calls = []
    monkeypatch.setattr(build, "build_all", lambda: calls.append("all") or ["x"])
    monkeypatch.setattr(run_server, "resolve_device",
                        lambda d: __import__("torch").device("cuda", 0))
    assert run_server.prebuild_kernels("cuda") == ["x"] and calls == ["all"]

    def fail():
        raise build.KernelBuildError("nvcc failed")

    monkeypatch.setattr(build, "build_all", fail)
    with pytest.raises(build.KernelBuildError):
        run_server.prebuild_kernels("cuda")
    monkeypatch.setattr(run_server, "resolve_device",
                        lambda d: __import__("torch").device("cpu"))
    assert run_server.prebuild_kernels("cpu") == []
