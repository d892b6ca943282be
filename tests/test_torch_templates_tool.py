"""The port's bundled template gallery (``tools/templates.py``) and its
event import and export, held against the JAX package's
(``tests/test_tools.py``'s cases): the same listing, scaffolds whose
``engine.py`` imports the port's models and that ``build`` accepts, the
template whose model is not ported refused with its ROADMAP item, and JSON-lines files that
cross between the two packages' stores.
"""

import datetime as dt
import json
import os

import pytest

from predictionio_tpu.storage import StorageRegistry as JaxStorageRegistry
from predictionio_tpu.tools.export_events import export_events as jax_export_events
from predictionio_tpu.tools.templates import list_templates as jax_list_templates
from predictionio_tpu_torch.storage import Event, EventFilter, StorageRegistry
from predictionio_tpu_torch.tools.export_events import export_events
from predictionio_tpu_torch.tools.import_events import (
    ImportError_,
    PARQUET_NOT_PORTED,
    import_events,
)
from predictionio_tpu_torch.tools.templates import (
    TemplateNotPorted,
    get_template,
    list_templates,
)
from predictionio_tpu_torch.workflow.loader import get_engine

T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)


def test_template_list_and_get(tmp_path):
    names = {t["name"] for t in list_templates()}
    assert names == {t["name"] for t in jax_list_templates()} == {
        "recommendation", "classification", "similarproduct", "ecommerce", "sequencerec"}
    target = tmp_path / "proj"
    out = get_template("recommendation", str(target))
    assert os.path.exists(target / "engine.json")
    assert os.path.exists(target / "engine.py")
    assert os.path.exists(target / "evaluation.py")
    assert out["template"] == "recommendation"
    with pytest.raises(ValueError):
        get_template("recommendation", str(target))  # non-empty dir
    with pytest.raises(KeyError):
        get_template("nope", str(tmp_path / "x"))


@pytest.mark.parametrize("name,module", [
    ("recommendation", "predictionio_tpu_torch.models.recommendation"),
    ("sequencerec", "predictionio_tpu_torch.models.sequencerec"),
])
def test_a_scaffold_imports_the_ports_model(name, module, tmp_path):
    target = tmp_path / name
    get_template(name, str(target))
    source = (target / "engine.py").read_text()
    assert f"from {module} import engine_factory" in source
    assert "predictionio_tpu." not in source.replace("predictionio_tpu_torch.", "")
    variant = json.loads((target / "engine.json").read_text())
    engine = get_engine(variant["engineFactory"], search_dir=str(target))
    assert engine.json_to_engine_params(variant) is not None
    if name == "recommendation":
        evaluation = (target / "evaluation.py").read_text()
        assert "from predictionio_tpu_torch.models.recommendation import" in evaluation


@pytest.mark.parametrize("name,module", [
    ("similarproduct", "predictionio_tpu_torch.models.similarproduct"),
    ("ecommerce", "predictionio_tpu_torch.models.ecommerce"),
])
def test_a_ported_template_scaffolds_an_engine_that_build_accepts(name, module, tmp_path,
                                                                   capsys):
    from predictionio_tpu_torch.tools import console

    target = tmp_path / name
    get_template(name, str(target))
    assert f"from {module} import engine_factory" in (target / "engine.py").read_text()
    variant = json.loads((target / "engine.json").read_text())
    assert variant["algorithms"] == [
        {"name": "als", "params": {"rank": 10, "num_iterations": 10}}]
    engine = get_engine(variant["engineFactory"], search_dir=str(target))
    assert engine.__class__.__module__.startswith("predictionio_tpu_torch.")
    assert all(cls.__module__ == module for cls in engine.algorithm_class_map.values())
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path / "store")})
    assert console.main(["build", "--engine-dir", str(target)], registry) == 0
    capsys.readouterr()
    listed = {t["name"]: t for t in list_templates()}
    assert "ported" not in listed[name]


@pytest.mark.parametrize("name,item", [("classification", "item 14")])
def test_templates_whose_models_are_not_ported_are_refused(name, item, tmp_path):
    with pytest.raises(TemplateNotPorted, match=rf"ROADMAP.md, queue 1 {item}"):
        get_template(name, str(tmp_path / name))
    assert not (tmp_path / name).exists()
    listed = {t["name"]: t for t in list_templates()}
    assert listed[name]["ported"] is False and "ported" not in listed["recommendation"]


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


def test_export_import_roundtrip(tmp_path):
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    n = _ingest_rates(registry, app_id=1)
    out_file = tmp_path / "events.jsonl"
    with open(out_file, "w") as fh:
        assert export_events(registry, 1, fh) == n
    with open(out_file) as fh:
        assert import_events(registry, 2, fh, batch_size=7) == n
    src = list(registry.get_events().find(1, EventFilter()))
    dst = list(registry.get_events().find(2, EventFilter()))
    assert len(src) == len(dst) == n
    assert {e.entity_id for e in src} == {e.entity_id for e in dst}
    assert sorted(e.properties.get("rating", 0) for e in src) == sorted(
        e.properties.get("rating", 0) for e in dst)


def test_a_file_the_jax_package_exported_imports_into_the_port(tmp_path):
    """JSON lines are the interchange format: the JAX package's export
    imports into the port's store, and the port's export of it is the
    same documents."""
    from predictionio_tpu.storage import Event as JaxEvent

    jreg = JaxStorageRegistry({"PIO_FS_BASEDIR": str(tmp_path / "jax")})
    store = jreg.get_events()
    store.init(1)
    store.write([JaxEvent(event="rate", entity_type="user", entity_id=f"u{u}",
                          target_entity_type="item", target_entity_id=f"i{u % 3}",
                          properties={"rating": float(u % 5 + 1)},
                          event_time=T0 + dt.timedelta(minutes=u)) for u in range(12)], 1)
    jax_file = tmp_path / "jax.jsonl"
    with open(jax_file, "w") as fh:
        assert jax_export_events(jreg, 1, fh) == 12
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path / "port")})
    with open(jax_file) as fh:
        assert import_events(registry, 5, fh) == 12
    port_file = tmp_path / "port.jsonl"
    with open(port_file, "w") as fh:
        assert export_events(registry, 5, fh) == 12
    key = lambda d: (d["entityId"], d["eventTime"])  # noqa: E731
    strip = lambda d: {k: v for k, v in d.items() if k not in ("eventId", "creationTime")}  # noqa: E731
    want = sorted((strip(json.loads(x)) for x in jax_file.read_text().splitlines()), key=key)
    got = sorted((strip(json.loads(x)) for x in port_file.read_text().splitlines()), key=key)
    assert got == want


@pytest.mark.parametrize("lines,where", [
    (['{"event":"rate","entityType":"user","entityId":"u1"}', "not-json"], "line 2"),
    (["", '{"event":"rate","entityType":"user"}'], "line 2"),
    (['{"event":"$bogus","entityType":"user","entityId":"u1"}'], "line 1"),
])
def test_import_rejects_bad_lines(lines, where, tmp_path):
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    with pytest.raises(ImportError_, match=where):
        import_events(registry, 3, lines)


def test_the_parquet_format_names_its_roadmap_item(tmp_path):
    from predictionio_tpu_torch.tools import export_events as export_mod
    from predictionio_tpu_torch.tools import import_events as import_mod

    assert "queue 1 item 14" in PARQUET_NOT_PORTED
    for main, flag in ((import_mod.main, "--input"), (export_mod.main, "--output")):
        with pytest.raises(NotImplementedError, match="queue 1 item 14"):
            main(["--appid", "1", flag, str(tmp_path / "x.parquet"), "--format", "parquet"])
