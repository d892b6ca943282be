"""The port's training infeed: event store → ``stream_ratings`` →
``RecDataSource`` / ``SeqDataSource`` → ``run_train``.

The same seeded events (numpy, seed 21) are written through both
packages' SQLite and native stores, and the port is held to the JAX
package exactly: ``stream_ratings`` gives equal ``users``/``items``/
``ratings`` arrays and equal id maps, ``RecDataSource.read_training`` and
``SeqDataSource.read_training`` give equal training data. The native
ratings scan (``ratings.cc``) equals the chunked path on the same store.
``run_train`` through ``RecDataSource`` gives the factors of a caller
DataSource over the same arrays (rtol 2e-3 / atol 2e-4, the ALS parity
tolerance; both runs start from the same seeded table).
"""

import datetime as dt

import numpy as np
import pytest

from predictionio_tpu.models import recommendation as jax_rec
from predictionio_tpu.models import sequencerec as jax_seq
from predictionio_tpu.storage import Event as JaxEvent
from predictionio_tpu.storage import registry as jax_registry
from predictionio_tpu.storage.native_events import NativeEventStore as JaxNativeEventStore
from predictionio_tpu.storage.sqlite_events import SqliteEventStore as JaxSqliteEventStore
from predictionio_tpu.workflow.infeed import stream_ratings as jax_stream_ratings
from predictionio_tpu_torch.controller import DataSource, Engine, EngineParams, FirstServing
from predictionio_tpu_torch.models import recommendation as rec
from predictionio_tpu_torch.models import sequencerec as seq
from predictionio_tpu_torch.storage import (
    BiMap,
    Event,
    EventFilter,
    NativeEventStore,
    SqliteEventStore,
    StorageRegistry,
)
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.workflow import (
    StreamingIndexer,
    WorkflowContext,
    load_models,
    run_train,
    stream_ratings,
)
from predictionio_tpu_torch.workflow.infeed import _stream_ratings_chunked

APP = 4
RTOL, ATOL = 2e-3, 2e-4
T0 = dt.datetime(2024, 3, 1, tzinfo=dt.timezone.utc)


def _seeded_rows(n=600, seed=21):
    """rate (with a rating), buy (no properties), view and a target-less
    $set, with event times that rise and sometimes tie."""
    rng = np.random.default_rng(seed)
    names = rng.choice(["rate", "rate", "buy", "view", "$set"], size=n)
    secs = np.cumsum(rng.integers(0, 3, n))
    rows = []
    for j in range(n):
        row = dict(event=str(names[j]), entity_type="user",
                   entity_id=f"u{int(rng.integers(0, 30))}",
                   event_time=T0 + dt.timedelta(seconds=int(secs[j])),
                   creation_time=T0, event_id=f"ev{j}")
        if names[j] == "$set":
            row["properties"] = {"age": int(rng.integers(18, 80))}
        else:
            row.update(target_entity_type="item",
                       target_entity_id=f"i{int(rng.integers(0, 40))}")
            if names[j] == "rate":
                row["properties"] = {"rating": float(rng.integers(1, 11)) / 2}
        rows.append(row)
    return rows


def _stores(kind, tmp_path):
    """(port store, JAX store), each holding the seeded events of APP."""
    if kind == "sqlite":
        ours = SqliteEventStore(str(tmp_path / "port" / "events.db"))
        theirs = JaxSqliteEventStore(str(tmp_path / "jax" / "events.db"))
    else:
        ours = NativeEventStore(str(tmp_path / "port" / "events_native"))
        theirs = JaxNativeEventStore(str(tmp_path / "jax" / "events_native"))
    rows = _seeded_rows()
    ours.write([Event(**r) for r in rows], APP)
    theirs.write([JaxEvent(**r) for r in rows], APP)
    return ours, theirs


def _same_batch(got, want):
    for name in ("users", "items", "ratings"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.user_map.to_dict() == want.user_map.to_dict()
    assert got.item_map.to_dict() == want.item_map.to_dict()


@pytest.fixture()
def registries(tmp_path, monkeypatch):
    """Point both packages' process-wide registries at a base directory
    for one test (restored afterwards), per store kind."""

    def point(kind):
        env = {"PIO_FS_BASEDIR": str(tmp_path / "port")}
        jenv = {"PIO_FS_BASEDIR": str(tmp_path / "jax")}
        if kind == "native":
            for e, base in ((env, "port"), (jenv, "jax")):
                e.update({"PIO_STORAGE_SOURCES_N_TYPE": "native",
                          "PIO_STORAGE_SOURCES_N_PATH": str(tmp_path / base)})
        ours = StorageRegistry(env)
        monkeypatch.setattr(port_registry, "_default_registry", ours)
        monkeypatch.setattr(jax_registry, "_default_registry",
                            jax_registry.StorageRegistry(jenv))
        return ours

    return point


# -- the chunked scan and the indexer -------------------------------------------
@pytest.mark.parametrize("kind", ["sqlite", "native"])
def test_scan_columnar_iter_chunks_concat_to_the_full_scan(kind, tmp_path):
    ours, _ = _stores(kind, tmp_path)
    full = ours.scan_columnar(APP)
    chunks = list(ours.scan_columnar_iter(APP, chunk_rows=77))
    assert [len(c["event"]) for c in chunks[:-1]] == [77] * (len(chunks) - 1)
    for key in full:
        assert [v for c in chunks for v in list(c[key])] == list(full[key]), key
    limited = list(ours.scan_columnar_iter(APP, EventFilter(limit=10), chunk_rows=4))
    assert sum(len(c["event"]) for c in limited) == 10
    assert list(ours.scan_columnar_iter(APP + 1)) == []


def test_streaming_indexer_matches_one_shot_bimap():
    keys = [f"k{int(x)}" for x in np.random.default_rng(3).integers(0, 50, 400)]
    ix = StreamingIndexer()
    parts = [ix.index_chunk(keys[j:j + 37]) for j in range(0, len(keys), 37)]
    one = BiMap.string_int(keys)
    assert ix.to_bimap() == one
    np.testing.assert_array_equal(np.concatenate(parts), [one[k] for k in keys])


# -- stream_ratings against the JAX package --------------------------------------------
@pytest.mark.parametrize("rules", [{"rate": "rating", "buy": 4.0}, {"rate": "rating"},
                                   {"buy": 1.0, "view": 0.5}])
@pytest.mark.parametrize("kind", ["sqlite", "native"])
def test_stream_ratings_matches_the_jax_package(kind, rules, tmp_path):
    ours, theirs = _stores(kind, tmp_path)
    got = stream_ratings(ours, APP, rules)
    _same_batch(got, jax_stream_ratings(theirs, APP, rules))
    assert len(got.users) > 0 and got.users.dtype == np.int32


@pytest.mark.parametrize("kind", ["sqlite", "native"])
def test_chunked_path_matches_the_one_shot_path(kind, tmp_path):
    """On the native store the fast path is the C++ ratings scan; the
    chunked path (``scan_columnar_iter`` + ``StreamingIndexer``) over
    several chunks gives the same arrays and maps."""
    ours, _ = _stores(kind, tmp_path)
    rules = {"rate": "rating", "buy": 4.0}
    chunked = _stream_ratings_chunked(ours, APP, rules, chunk_rows=50)
    _same_batch(stream_ratings(ours, APP, rules), chunked)
    chunks = list(ours.scan_columnar_iter(APP, EventFilter(event_names=list(rules)),
                                          chunk_rows=50))
    assert len(chunks) > 1 and len(chunked.users) > 50


@pytest.mark.parametrize("kind", ["sqlite", "native"])
def test_missing_property_raises(kind, tmp_path):
    ours, _ = _stores(kind, tmp_path)
    ours.insert(Event(event="rate", entity_type="user", entity_id="u1",
                      target_entity_type="item", target_entity_id="i1"), APP)
    with pytest.raises(ValueError, match="rating"):
        stream_ratings(ours, APP, {"rate": "rating"})


def test_two_property_names_take_the_exact_chunked_path(tmp_path):
    ours, _ = _stores("native", tmp_path)
    ours.insert(Event(event="like", entity_type="user", entity_id="u1",
                      target_entity_type="item", target_entity_id="i1",
                      properties={"score": 2.0}, event_time=T0), APP)
    got = stream_ratings(ours, APP, {"rate": "rating", "like": "score"})
    sq = SqliteEventStore(":memory:")
    sq.write(list(ours.find(APP)), APP)
    _same_batch(got, stream_ratings(sq, APP, {"rate": "rating", "like": "score"}))


def test_native_scan_honours_deletes_and_escapes(tmp_path):
    ours, _ = _stores("native", tmp_path)
    weird_user, weird_item = 'u"\\back\nslash\tñ–🎉', "item/ü\u0007"
    ours.insert(Event(event="rate", entity_type="user", entity_id=weird_user,
                      target_entity_type="item", target_entity_id=weird_item,
                      properties={"rating": 2.5}, event_time=T0), APP)
    ours.delete("ev5", APP)
    got = stream_ratings(ours, APP, {"rate": "rating"})
    assert weird_user in got.user_map and weird_item in got.item_map
    chunked = _stream_ratings_chunked(ours, APP, {"rate": "rating"})
    _same_batch(got, chunked)
    assert len(got.users) == len(chunked.users)


def test_empty_store_and_hashed_users(tmp_path):
    store = SqliteEventStore(":memory:")
    store.init(1)
    got = stream_ratings(store, 1, {"rate": "rating"})
    assert got.users.shape == (0,) and len(got.user_map) == 0
    hashed = stream_ratings(store, 1, {"rate": "rating"}, hashed_users=1024)
    assert hashed.users.shape == (0,) and len(hashed.user_map) == 1024
    assert len(hashed.item_map) == 0


# -- the DataSources ------------------------------------------------------------
@pytest.mark.parametrize("kind", ["sqlite", "native"])
def test_rec_data_source_reads_what_the_jax_one_reads(kind, tmp_path, registries):
    _stores(kind, tmp_path)
    registries(kind)
    params = dict(app_id=APP, event_names=("rate", "buy"), buy_rating=3.5)
    got = rec.RecDataSource(rec.RecDataSourceParams(**params)).read_training(None)
    want = jax_rec.RecDataSource(jax_rec.RecDataSourceParams(**params)).read_training(None)
    _same_batch(got, want)
    with pytest.raises(ValueError, match="Unsupported event"):
        rec.RecDataSource(rec.RecDataSourceParams(event_names=("like",))).read_training(None)


@pytest.mark.parametrize("kind", ["sqlite", "native"])
def test_seq_data_source_reads_what_the_jax_one_reads(kind, tmp_path, registries):
    _stores(kind, tmp_path)
    registries(kind)
    params = dict(app_id=APP, event_names=("view", "buy", "rate"))
    got = seq.SeqDataSource(seq.SeqDataSourceParams(**params)).read_training(None)
    want = jax_seq.SeqDataSource(jax_seq.SeqDataSourceParams(**params)).read_training(None)
    assert got.user_ids == want.user_ids and got.sequences == want.sequences
    assert sum(map(len, got.sequences)) == sum(
        r["event"] != "$set" for r in _seeded_rows())


def test_run_train_through_rec_data_source_matches_a_caller_data_source(
        tmp_path, registries):
    _stores("native", tmp_path)
    registries("native")
    training = rec.RecDataSource(rec.RecDataSourceParams(app_id=APP)).read_training(None)

    class Arrays(DataSource):
        def read_training(self, ctx):
            return training

    params = rec.ALSAlgorithmParams(rank=6, num_iterations=3, lambda_=0.05, seed=1)
    store = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path / "models")})
    models = {}
    for name, source, ds_params in (
        ("store", rec.RecDataSource, rec.RecDataSourceParams(app_id=APP)),
        ("caller", Arrays, EngineParams().data_source_params[1]),
    ):
        ep = EngineParams(data_source_params=("", ds_params),
                          algorithm_params_list=[("als", params)])
        engine = Engine({"": source}, {"": rec.RecPreparator},
                        {"als": rec.ALSAlgorithm}, {"": FirstServing})
        ctx = WorkflowContext(device="cpu")
        ctx.profile = {}
        (models[name],) = load_models(store, run_train(engine, ep, store, ctx=ctx))
        assert ctx.profile["host_prep_path"] == "native"
    got, want = models["store"], models["caller"]
    np.testing.assert_allclose(got.user_factors, want.user_factors, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.item_factors, want.item_factors, rtol=RTOL, atol=ATOL)
    assert got.user_map.to_dict() == want.user_map.to_dict()
    assert got.item_map.to_dict() == want.item_map.to_dict()
