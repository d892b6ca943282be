"""Evaluation through the port against the JAX package, on the CPU.

The same seeded events (numpy, seed 17: 40 users, 30 items, rate / buy /
view events and a target-less ``$set``) go into both packages' stores,
and the port is held to the JAX package:

- ``RecDataSource.read_eval`` and ``SeqDataSource.read_eval`` give equal
  splits (train arrays and maps, ``(query, actual)`` pairs) — exactly;
- ``Engine.eval`` and ``batch_eval`` (serial and ``parallelism=4``) and
  ``run_evaluation`` of ``RecEvaluation`` × ``RecParamsGenerator`` give
  the JAX package's predictions, Precision@K and best candidate, every
  ALS run starting from the JAX package's initial table (a
  ``torch.Generator`` cannot reproduce ``jax.random``): served scores to
  rtol 2e-3 / atol 2e-3 (the ALS parity tolerance of
  ``test_torch_train.py``), items equal or tied at that tolerance, and a
  Precision@K point that differs only where the actual item's score ties
  the k-th score (such queries are named in the assertion message);
- ``FastEvalEngine``'s memoization counts equal the JAX package's on the
  same sweeps, serial and threaded;
- ``MetricEvaluator``'s ordering (the earliest best wins) and its
  ``best.json`` equal the JAX package's;
- the top-k batch split (``topk_batch_slices``) covers every row once.
"""

import dataclasses
import datetime as dt
import json

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import engine as jax_engine_mod
from predictionio_tpu.controller import fast_eval as jax_fast_eval
from predictionio_tpu.controller import metrics as jax_metrics
from predictionio_tpu.models import recommendation as jax_rec
from predictionio_tpu.models import sequencerec as jax_seq
from predictionio_tpu.ops.als import init_factors as jax_init_factors
from predictionio_tpu.storage import Event as JaxEvent
from predictionio_tpu.storage import registry as jax_registry
from predictionio_tpu.workflow.context import WorkflowContext as JaxContext
from predictionio_tpu.workflow.core_workflow import run_evaluation as jax_run_evaluation
from predictionio_tpu_torch.controller import (
    EngineParams,
    EngineParamsGenerator,
    FirstServing,
    MetricEvaluator,
    Params,
    SumMetric,
    WorkflowParams,
)
from predictionio_tpu_torch.controller import dase as port_dase
from predictionio_tpu_torch.controller import metrics as port_metrics
from predictionio_tpu_torch.controller.engine import Engine
from predictionio_tpu_torch.controller.fast_eval import FastEvalEngine
from predictionio_tpu_torch.models import recommendation as rec
from predictionio_tpu_torch.models import sequencerec as seq
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.ops.cuda_kernels import TOPK_MAX_BATCH, topk_batch_slices
from predictionio_tpu_torch.storage import (
    STATUS_EVALCOMPLETED,
    STATUS_EVALUATING,
    Event,
    StorageRegistry,
)
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.workflow import WorkflowContext, run_evaluation

APP = 3
T0 = dt.datetime(2024, 5, 1, tzinfo=dt.timezone.utc)
SCORE_RTOL = SCORE_ATOL = 2e-3
#: a small grid: 2 ranks × 2 λ at the template's 10 iterations
RANKS, LAMBDAS = (4, 6), (0.01, 0.1)


def _seeded_rows(n=500, seed=17):
    rng = np.random.default_rng(seed)
    names = rng.choice(["rate"] * 6 + ["buy", "view", "$set"], size=n)
    secs = np.cumsum(rng.integers(0, 3, n))
    rows = []
    for j in range(n):
        row = dict(event=str(names[j]), entity_type="user",
                   entity_id=f"u{int(rng.integers(0, 40))}",
                   event_time=T0 + dt.timedelta(seconds=int(secs[j])),
                   creation_time=T0, event_id=f"ev{j}")
        if names[j] == "$set":
            row["properties"] = {"age": int(rng.integers(18, 80))}
        else:
            row.update(target_entity_type="item",
                       target_entity_id=f"i{int(rng.integers(0, 30))}")
            if names[j] == "rate":
                row["properties"] = {"rating": float(rng.integers(1, 11)) / 2}
        rows.append(row)
    return rows


@pytest.fixture()
def stores(tmp_path, monkeypatch):
    """Both packages' process-wide registries over the seeded events of
    APP (SQLite, or the native log), for one test."""

    def point(kind="sqlite"):
        env = {"PIO_FS_BASEDIR": str(tmp_path / "port")}
        jenv = {"PIO_FS_BASEDIR": str(tmp_path / "jax")}
        if kind == "native":
            for e, base in ((env, "port"), (jenv, "jax")):
                e.update({"PIO_STORAGE_SOURCES_N_TYPE": "native",
                          "PIO_STORAGE_SOURCES_N_PATH": str(tmp_path / base / "log"),
                          "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "N"})
        ours, theirs = StorageRegistry(env), jax_registry.StorageRegistry(jenv)
        rows = _seeded_rows()
        ours.get_events().write([Event(**r) for r in rows], APP)
        theirs.get_events().write([JaxEvent(**r) for r in rows], APP)
        monkeypatch.setattr(port_registry, "_default_registry", ours)
        monkeypatch.setattr(jax_registry, "_default_registry", theirs)
        return ours, theirs

    return point


@pytest.fixture()
def shared_init(monkeypatch):
    """The port's ALS starts from the JAX package's initial table."""

    def init(n, rank, seed, device=None):
        return torch.from_numpy(np.array(jax_init_factors(n, rank, seed))).to(device)

    monkeypatch.setattr(als, "init_factors", init)


def _pairs(qa):
    return [(q.user, q.num, a.item, a.score) for q, a in qa]


def _same_training(got, want):
    for name in ("users", "items", "ratings"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.user_map.to_dict() == want.user_map.to_dict()
    assert got.item_map.to_dict() == want.item_map.to_dict()


# -- read_eval ------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["sqlite", "native"])
def test_rec_read_eval_splits_as_the_jax_package(kind, stores):
    stores(kind)
    params = dict(app_id=APP, event_names=("rate", "buy"), buy_rating=3.5)
    [(td, ei, qa)] = rec.RecDataSource(rec.RecDataSourceParams(**params)).read_eval(None)
    [(jtd, jei, jqa)] = jax_rec.RecDataSource(
        jax_rec.RecDataSourceParams(**params)).read_eval(None)
    _same_training(td, jtd)
    assert ei is None and jei is None
    assert _pairs(qa) == _pairs(jqa) and len(qa) > 50
    assert all(isinstance(q, rec.Query) and isinstance(a, rec.ItemScore) for q, a in qa)


def test_rec_read_eval_maps_hold_only_the_training_split(stores):
    """A user whose every rating fell in the held-out split is absent from
    the train split's maps, so it takes the unknown-user path (the JAX
    package's ``test_eval_train_split_excludes_test_only_entities``)."""
    ours, theirs = stores()
    # the earliest rating of all (position 0: held out) is the only one of
    # its user and of its item
    solo = dict(event="rate", entity_type="user", entity_id="solo",
                target_entity_type="item", target_entity_id="i-solo",
                properties={"rating": 5.0}, event_time=T0 - dt.timedelta(days=1),
                creation_time=T0, event_id="ev-solo")
    ours.get_events().insert(Event(**solo), APP)
    theirs.get_events().insert(JaxEvent(**solo), APP)
    ds = rec.RecDataSource(rec.RecDataSourceParams(app_id=APP))
    [(train_td, _, qa)] = ds.read_eval(None)
    assert (qa[0][0].user, qa[0][1].item) == ("solo", "i-solo")
    assert "solo" not in train_td.user_map and "i-solo" not in train_td.item_map
    full = ds.read_training(None)
    test_mask = np.arange(len(full.users)) % 4 == 0
    u_inv, i_inv = full.user_map.inverse, full.item_map.inverse
    assert set(train_td.user_map.to_dict()) == {u_inv[int(u)] for u in full.users[~test_mask]}
    assert set(train_td.item_map.to_dict()) == {i_inv[int(i)] for i in full.items[~test_mask]}
    assert train_td.users.max() == len(train_td.user_map) - 1
    assert train_td.items.max() == len(train_td.item_map) - 1
    assert len(qa) == int(test_mask.sum())
    held_only = {q.user for q, _ in qa} - set(train_td.user_map.to_dict())
    [(jtd, _, jqa)] = jax_rec.RecDataSource(
        jax_rec.RecDataSourceParams(app_id=APP)).read_eval(None)
    _same_training(train_td, jtd)
    assert _pairs(qa) == _pairs(jqa)
    # the unknown-user path: a held-out-only user gets an empty answer
    model = rec.ALSModel(rank=2, user_factors=np.ones((len(train_td.user_map), 2), np.float32),
                         item_factors=np.ones((len(train_td.item_map), 2), np.float32),
                         user_map=train_td.user_map, item_map=train_td.item_map)
    algo = rec.ALSAlgorithm(rec.ALSAlgorithmParams(rank=2), device="cpu")
    for user in sorted(held_only)[:3]:
        assert algo.predict(model, rec.Query(user=user)).item_scores == ()


@pytest.mark.parametrize("kind", ["sqlite", "native"])
def test_seq_read_eval_splits_as_the_jax_package(kind, stores):
    stores(kind)
    params = dict(app_id=APP, event_names=("view", "buy", "rate"))
    [(td, ei, qa)] = seq.SeqDataSource(seq.SeqDataSourceParams(**params)).read_eval(None)
    [(jtd, _, jqa)] = jax_seq.SeqDataSource(
        jax_seq.SeqDataSourceParams(**params)).read_eval(None)
    assert td.user_ids == jtd.user_ids and td.sequences == jtd.sequences
    assert ei is None
    assert ([(q.recent_items, q.num, a.item, a.score) for q, a in qa]
            == [(q.recent_items, q.num, a.item, a.score) for q, a in jqa])
    assert len(qa) == sum(1 for s in jtd.sequences if s) and len(qa) > 10


# -- Engine.eval / batch_eval ----------------------------------------------------
def _candidates(pkg):
    return [
        pkg.RecParamsGenerator(app_id=APP, ranks=RANKS, lambdas=LAMBDAS)
        .engine_params_list[i] for i in (0, 3)
    ]


def _assert_served_alike(qpa, jqpa):
    """Per query: the same query and actual, and served items equal or
    tied with scores at the ALS tolerance."""
    assert len(qpa) == len(jqpa)
    for (q, p, a), (jq, jp, ja) in zip(qpa, jqpa):
        assert (q.user, q.num, a.item, a.score) == (jq.user, jq.num, ja.item, ja.score)
        gs = np.array([s.score for s in p.item_scores], np.float32)
        ws = np.array([s.score for s in jp.item_scores], np.float32)
        assert gs.shape == ws.shape
        np.testing.assert_allclose(gs, ws, rtol=SCORE_RTOL, atol=SCORE_ATOL)
        tied = np.isclose(gs, ws, rtol=SCORE_RTOL, atol=SCORE_ATOL)
        same = np.array([s.item == t.item for s, t in zip(p.item_scores, jp.item_scores)])
        assert (same | tied).all()


@pytest.fixture()
def jax_batch_eval(stores):
    stores()
    engine = jax_rec.engine_factory()
    return engine.batch_eval(JaxContext("Evaluation"), _candidates(jax_rec))


@pytest.mark.parametrize("parallelism", [1, 4])
def test_engine_batch_eval_serves_what_the_jax_package_serves(
        parallelism, jax_batch_eval, shared_init):
    got = rec.engine_factory().batch_eval(
        WorkflowContext(mode="Evaluation", device="cpu"), _candidates(rec),
        parallelism=parallelism)
    assert len(got) == len(jax_batch_eval) == 2
    for (ep, folds), (jep, jfolds) in zip(got, jax_batch_eval):
        assert ep.algorithm_params_list[0][1].rank == jep.algorithm_params_list[0][1].rank
        assert len(folds) == len(jfolds) == 1
        _assert_served_alike(folds[0][1], jfolds[0][1])
    # Engine.eval of one candidate is the sweep's first entry
    one = rec.engine_factory().eval(WorkflowContext(mode="Evaluation", device="cpu"),
                                    _candidates(rec)[0])
    _assert_served_alike(one[0][1], jax_batch_eval[0][1][0][1])


# -- run_evaluation --------------------------------------------------------------
def _points(qpa, k=10, threshold=4.0):
    """Per query: the Precision@K point (None when not relevant)."""
    metric = rec.PrecisionAtK(k=k, rating_threshold=threshold)
    return [metric.calculate_point(q, p, a) for q, p, a in qpa]


def test_run_evaluation_matches_the_jax_package(stores, shared_init, tmp_path):
    ours, theirs = stores()
    wp = WorkflowParams(batch="sweep", eval_parallelism=4)
    jiid = jax_run_evaluation(jax_rec.RecEvaluation(), jax_rec.RecParamsGenerator(
        app_id=APP, ranks=RANKS, lambdas=LAMBDAS), theirs,
        workflow_params=jax_engine_mod.WorkflowParams(batch="sweep", eval_parallelism=4))
    evaluation = rec.RecEvaluation()
    best_json = tmp_path / "best.json"
    evaluation.evaluator.output_path = str(best_json)
    iid = run_evaluation(evaluation, rec.RecParamsGenerator(
        app_id=APP, ranks=RANKS, lambdas=LAMBDAS), ours, workflow_params=wp,
        ctx=WorkflowContext(mode="Evaluation", device="cpu"))
    row = ours.get_metadata().evaluation_instance_get(iid)
    jrow = theirs.get_metadata().evaluation_instance_get(jiid)
    assert row.status == jrow.status == STATUS_EVALCOMPLETED
    assert iid.startswith("EVI-") and row.batch == "sweep"
    assert (row.evaluation_class, row.engine_params_generator_class) == (
        jrow.evaluation_class, jrow.engine_params_generator_class)
    got, want = json.loads(row.evaluator_results_json), json.loads(jrow.evaluator_results_json)
    assert set(got) == set(want)
    assert got["metricHeader"] == want["metricHeader"] == "Precision@10 (threshold=4.0)"
    assert got["bestIdx"] == want["bestIdx"]
    assert got["bestEngineParams"] == want["bestEngineParams"]
    assert [s["engineParams"] for s in got["scores"]] == [
        s["engineParams"] for s in want["scores"]]
    np.testing.assert_allclose([s["score"] for s in got["scores"]],
                               [s["score"] for s in want["scores"]], rtol=1e-6)
    np.testing.assert_allclose(got["bestScore"], want["bestScore"], rtol=1e-6)
    assert row.evaluator_results == f"[{got['bestScore']}] {got['metricHeader']}"
    assert "<html>" in row.evaluator_results_html
    assert ours.get_metadata().evaluation_instance_get_completed()[0].id == iid
    written = json.loads(best_json.read_text())
    assert written["engineFactory"] == "RecEvaluation"
    assert {k: written[k] for k in ("datasource", "preparator", "algorithms", "serving")} \
        == got["bestEngineParams"]


def test_precision_points_differ_from_the_jax_package_only_at_named_ties(
        jax_batch_eval, shared_init):
    """Precision@10 point by point: where the port's point differs from
    the JAX package's, the actual item's score ties the 10th served score
    at the ALS tolerance (the differing queries are named)."""
    got = rec.engine_factory().batch_eval(
        WorkflowContext(mode="Evaluation", device="cpu"), _candidates(rec))
    for (_, folds), (_, jfolds) in zip(got, jax_batch_eval):
        qpa, jqpa = folds[0][1], jfolds[0][1]
        mine, theirs = _points(qpa), _points(jqpa)
        assert sum(p is not None for p in mine) > 10
        differing = [(q.user, a.item) for (q, p, a), x, y in zip(qpa, mine, theirs) if x != y]
        for (q, p, a), x, y in zip(qpa, mine, theirs):
            if x == y:
                continue
            kth = p.item_scores[9].score
            actual = [s.score for s in p.item_scores if s.item == a.item]
            jactual = [s.score for s in jqpa[[t[0] for t in qpa].index(q)][1].item_scores
                       if s.item == a.item]
            score = (actual or jactual)[0]
            assert np.isclose(score, kth, rtol=SCORE_RTOL, atol=SCORE_ATOL), differing


def test_run_evaluation_refuses_a_run_cadence_before_its_row(stores, tmp_path, monkeypatch):
    """A run checkpoint cadence no longer refuses: an evaluation assigns
    no checkpoint directory, so its candidates train without checkpoints
    (none is written, even under a pinned ``PIO_CKPT_DIR``) and the result
    is the run's without a cadence."""
    ours, _ = stores()
    monkeypatch.setenv("PIO_CKPT_DIR", str(tmp_path / "ck"))
    results = []
    for every in (2, None):
        iid = run_evaluation(
            rec.RecEvaluation(), rec.RecParamsGenerator(app_id=APP, ranks=RANKS[:1],
                                                        lambdas=LAMBDAS[:1]),
            ours, workflow_params=WorkflowParams(checkpoint_every=every, eval_parallelism=1),
            ctx=WorkflowContext(mode="Evaluation", device="cpu"))
        row = ours.get_metadata().evaluation_instance_get(iid)
        assert row.status == STATUS_EVALCOMPLETED
        results.append(row.evaluator_results_json)
    assert results[0] == results[1]
    assert not (tmp_path / "ck").exists()


def test_a_failed_evaluation_leaves_its_evaluating_row(tmp_path, monkeypatch):
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    monkeypatch.setattr(port_registry, "_default_registry", registry)
    bad = EngineParams(data_source_params=("", rec.RecDataSourceParams(
        event_names=("like",))), algorithm_params_list=[("als", rec.ALSAlgorithmParams())])
    with pytest.raises(ValueError, match="Unsupported event"):
        run_evaluation(rec.RecEvaluation(), EngineParamsGenerator([bad]), registry,
                       ctx=WorkflowContext(mode="Evaluation", device="cpu"))
    row = registry.get_metadata().evaluation_instance_get("EVI-00000001")
    assert row.status == STATUS_EVALUATING


def test_evaluation_defaults_to_the_card_and_never_the_cpu(tmp_path):
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    if torch.cuda.is_available():
        assert WorkflowContext(mode="Evaluation").device == torch.device("cuda", 0)
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        run_evaluation(rec.RecEvaluation(), rec.RecParamsGenerator(), registry)
    assert registry.get_metadata().evaluation_instance_get("EVI-00000001") is None


# -- seqrec leave-one-out eval -------------------------------------------------------
def test_seqrec_engine_eval_answers_as_its_own_predict(stores):
    """``Engine.eval`` of the sequence template: one fold of leave-one-out
    queries, each answered by the base ``batch_predict`` (one forward a
    query), equal to ``predict`` on the trained model."""
    stores()
    ep = EngineParams(
        data_source_params=("", seq.SeqDataSourceParams(app_id=APP,
                                                         event_names=("rate", "buy"))),
        preparator_params=("", seq.SeqPreparatorParams(seq_len=8)),
        algorithm_params_list=[("transformer", seq.SeqRecAlgorithmParams(
            d_model=16, n_heads=2, n_layers=1, steps=2, batch_size=4))])
    trained = {}

    class Recording(seq.SeqRecAlgorithm):
        def train(self, ctx, pd):
            trained["model"] = super().train(ctx, pd)
            return trained["model"]

    engine = Engine({"": seq.SeqDataSource}, {"": seq.SeqPreparator},
                    {"transformer": Recording}, {"": FirstServing})
    [(ei, qpa)] = engine.eval(WorkflowContext(mode="Evaluation", device="cpu"), ep)
    [(_, _, qa)] = seq.SeqDataSource(ep.data_source_params[1]).read_eval(None)
    assert ei is None and [(q, a) for q, _, a in qpa] == qa
    algo = seq.SeqRecAlgorithm(ep.algorithm_params_list[0][1], device="cpu")
    for q, p, _ in qpa[:8]:
        assert p == algo.predict(trained["model"], q)
        assert 0 < len(p.item_scores) <= q.num


# -- FastEvalEngine memoization against the JAX package -------------------------------
def _counting_engine(pkg_dase, pkg_engine_cls, params_base):
    """The same counting components built on either package's bases
    (``FastEvalEngineTest.scala``'s DataSource0 / Preparator0 / Algo0 /
    Serving0): each call counts, results are plain ints."""
    counts = {"ds": 0, "prep": 0, "algo": 0, "serve": 0}

    @dataclasses.dataclass(frozen=True)
    class IdParams(params_base):
        id: int = 0

    class DS(pkg_dase.DataSource):
        params_class = IdParams

        def __init__(self, params=IdParams()):
            self.params = params

        def read_eval(self, ctx):
            counts["ds"] += 1
            return [(self.params.id, f"fold{f}", [(q, q * 10) for q in range(2)])
                    for f in range(1)]

    class Prep(pkg_dase.Preparator):
        params_class = IdParams

        def __init__(self, params=IdParams()):
            self.params = params

        def prepare(self, ctx, td):
            counts["prep"] += 1
            return (td, self.params.id)

    class Algo(pkg_dase.Algorithm):
        params_class = IdParams

        def __init__(self, params=IdParams()):
            self.params = params

        def train(self, ctx, pd):
            counts["algo"] += 1
            return (pd, self.params.id)

        def predict(self, model, q):
            return (model, q)

    class Serve(pkg_dase.Serving):
        params_class = IdParams

        def __init__(self, params=IdParams()):
            self.params = params

        def serve(self, q, predictions):
            counts["serve"] += 1
            return (predictions[0], self.params.id)

    engine = pkg_engine_cls({"": DS}, {"": Prep}, {"": Algo}, {"": Serve})
    return engine, IdParams, counts


SWEEPS = {
    "algo_sweep": lambda P, ep: [ep(algo=i) for i in range(4)],
    "ds_sweep": lambda P, ep: [ep(ds=i) for i in range(3)],
    "duplicates": lambda P, ep: [ep(), ep(), ep()],
    "serving_sweep": lambda P, ep: [ep(serve=i) for i in range(3)],
}


def _sweep(pkg_dase, engine_cls, params_base, ep_cls, sweep, ctx, parallelism=1):
    engine, IdParams, counts = _counting_engine(pkg_dase, engine_cls, params_base)

    def ep(ds=0, prep=0, algo=0, serve=0):
        return ep_cls(data_source_params=("", IdParams(ds)),
                      preparator_params=("", IdParams(prep)),
                      algorithm_params_list=[("", IdParams(algo))],
                      serving_params=("", IdParams(serve)))

    results = engine.batch_eval(ctx, SWEEPS[sweep](IdParams, ep), parallelism=parallelism)
    served = [[(ei, [(q, p, a) for q, p, a in qpa]) for ei, qpa in folds]
              for _, folds in results]
    return counts, served


@pytest.mark.parametrize("parallelism", [1, 4])
@pytest.mark.parametrize("sweep", sorted(SWEEPS))
def test_fast_eval_memoization_counts_equal_the_jax_packages(sweep, parallelism):
    from predictionio_tpu.controller import dase as jax_dase
    from predictionio_tpu.controller.params import Params as JaxParams

    mine, served = _sweep(port_dase, FastEvalEngine, Params, EngineParams, sweep,
                          WorkflowContext(mode="Evaluation", device="cpu"), parallelism)
    theirs, jserved = _sweep(jax_dase, jax_fast_eval.FastEvalEngine, JaxParams,
                             jax_engine_mod.EngineParams, sweep, None)
    assert mine == theirs
    assert served == jserved
    assert {"algo_sweep": (1, 1, 4), "ds_sweep": (3, 3, 3), "duplicates": (1, 1, 1),
            "serving_sweep": (1, 1, 1)}[sweep] == (mine["ds"], mine["prep"], mine["algo"])
    # the plain Engine evaluates every candidate from the start
    plain, _ = _sweep(port_dase, Engine, Params, EngineParams, sweep,
                      WorkflowContext(mode="Evaluation", device="cpu"))
    n = len(served)
    assert (plain["ds"], plain["algo"]) == (n, n)


def test_fast_eval_params_without_value_equality_are_not_cached():
    """``FastEvalEngineTest.scala:146``: distinct instances of a params
    class without value ``__eq__`` never hit the cache."""

    class RawParams:
        def __init__(self, id=0):
            self.id = id

    engine, IdParams, counts = _counting_engine(port_dase, FastEvalEngine, Params)
    eps = [EngineParams(data_source_params=("", RawParams()),
                        preparator_params=("", IdParams()),
                        algorithm_params_list=[("", IdParams())],
                        serving_params=("", IdParams())) for _ in range(2)]
    engine.data_source_class_map[""].read_eval = lambda self, ctx: (
        counts.__setitem__("ds", counts["ds"] + 1) or [(0, None, [(0, 0)])])
    engine.batch_eval(WorkflowContext(mode="Evaluation", device="cpu"), eps)
    assert counts["ds"] == 2


# -- metrics and the evaluator ---------------------------------------------------
class _PointSum(SumMetric):
    def calculate_point(self, q, p, a):
        return float(p)


class _JaxPointSum(jax_metrics.SumMetric):
    def calculate_point(self, q, p, a):
        return float(p)


@pytest.mark.parametrize("name", ["AverageMetric", "OptionAverageMetric", "SumMetric",
                                  "ZeroMetric"])
def test_metrics_score_as_the_jax_packages(name):
    rng = np.random.default_rng(2)
    data = [(f, [(j, float(rng.normal()), j % 3) for j in range(7)]) for f in range(3)]

    def point(self, q, p, a):
        return None if (name == "OptionAverageMetric" and a == 0) else p

    mine = type("M", (getattr(port_metrics, name),), {"calculate_point": point})()
    theirs = type("J", (getattr(jax_metrics, name),), {"calculate_point": point})()
    assert mine.calculate(None, data) == theirs.calculate(None, data)
    assert mine.header == "M" and str(mine) == "M"
    empty = [(0, [])]
    assert mine.calculate(None, empty) == theirs.calculate(None, empty)


def test_metric_evaluator_keeps_the_earliest_best_and_writes_best_json(tmp_path):
    scores = [0.5, 2.0, 1.0, 2.0]
    eps = [EngineParams(algorithm_params_list=[("als", rec.ALSAlgorithmParams(rank=r))])
           for r in (2, 3, 4, 5)]
    jeps = [jax_engine_mod.EngineParams(
        algorithm_params_list=[("als", jax_rec.ALSAlgorithmParams(rank=r))])
        for r in (2, 3, 4, 5)]
    data = [[(None, [(0, s, 0)])] for s in scores]
    mine = MetricEvaluator(_PointSum(), [_PointSum()], output_path=str(tmp_path / "best.json"))
    theirs = jax_metrics.MetricEvaluator(_JaxPointSum(), [_JaxPointSum()],
                                         output_path=str(tmp_path / "jax_best.json"))
    got = mine.evaluate_base(None, rec.RecEvaluation(), list(zip(eps, data)), parallelism=4)
    want = theirs.evaluate_base(None, jax_rec.RecEvaluation(), list(zip(jeps, data)))
    assert got.best_idx == want.best_idx == 1
    assert got.best_engine_params is eps[1]
    assert [ms.score for _, ms in got.engine_params_scores] == scores
    assert got.other_metric_headers == ("_PointSum",)
    assert json.loads(got.to_json()) == json.loads(want.to_json().replace("_JaxPointSum",
                                                                          "_PointSum"))
    assert got.one_liner() == "[2.0] _PointSum"
    assert (json.loads((tmp_path / "best.json").read_text())
            == json.loads((tmp_path / "jax_best.json").read_text()))
    # a metric ordered the other way picks the smallest
    low = type("Low", (_PointSum,), {"compare": lambda self, a, b: (a < b) - (a > b)})()
    assert MetricEvaluator(low).evaluate_base(None, None, list(zip(eps, data))).best_idx == 0


# -- the top-k batch split -------------------------------------------------------
@pytest.mark.parametrize("b", [0, 1, TOPK_MAX_BATCH - 1, TOPK_MAX_BATCH, TOPK_MAX_BATCH + 1,
                               600_000, 3 * TOPK_MAX_BATCH + 7])
def test_topk_batch_slices_cover_every_row_once(b):
    slices = topk_batch_slices(b)
    assert len(slices) == -(-b // TOPK_MAX_BATCH)
    covered = [s for s, e in slices] + [b]
    assert covered[0] == 0 and all(e == covered[i + 1] for i, (_, e) in enumerate(slices))
    assert all(0 < e - s <= TOPK_MAX_BATCH for s, e in slices)
    with pytest.raises(ValueError):
        topk_batch_slices(-1)


def test_a_split_batch_equals_the_unsplit_plain_version(monkeypatch):
    from predictionio_tpu_torch.ops import cuda_kernels

    gen = torch.Generator().manual_seed(4)
    q, items = torch.randn((23, 5), generator=gen), torch.randn((40, 5), generator=gen)
    excl = torch.randint(-1, 40, (23, 3), generator=gen, dtype=torch.int32)
    whole = cuda_kernels.top_k_streaming_reference(q, items, 7, excl)
    assert topk_batch_slices(23, 5)[-1] == (20, 23)
    monkeypatch.setattr(cuda_kernels, "topk_batch_slices", lambda b: topk_batch_slices(b, 5))
    split = cuda_kernels.top_k_streaming(q, items, 7, excl)
    assert torch.equal(split[0], whole[0]) and torch.equal(split[1], whole[1])
