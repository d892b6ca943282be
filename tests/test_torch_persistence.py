"""The DASE persistence contract of the port against the JAX package's.

``Algorithm.make_persistent`` decides what the model store holds for a
trained model: the model itself (pickled), a ``PersistentModelManifest``
for a ``PersistentModel`` that saved itself, or ``RETRAIN``, which stores
nothing and makes deploy train again (``Engine.scala:180-272``). The
cases of ``tests/test_engine.py``'s ``TestPersistence`` run here through
both packages on the same toy components (the JAX package's
``sample_engine`` and a copy over the port's classes), and their results
are compared: the sanity-check failure, the blob round trip, the
manifest, the retrain at deploy (the training count going from 1 to 2)
and mixed persistence.

Then the recommendation template on the CPU: an ALS engine whose
``make_persistent`` returns ``RETRAIN`` is trained with ``run_train`` and
deployed in both packages, on the same small ratings and the same initial
table (the JAX package's ``init_factors``). The port's retrained factors
equal its trained ones bit for bit; the two packages' factors agree to
the ALS parity tolerance (rtol 2e-3 / atol 2e-4, ``test_torch_train.py``);
the port's served answers equal the JAX package's ``batch_predict`` on
the port's factors (items equal or tied, scores rtol/atol 1e-5) and the
JAX package's own served answers to the ALS tolerance. A self-persisting
ALS model deploys from its manifest without training, and a manifest (or
a blob) naming the JAX package is refused before jax is imported.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import sample_engine as jse
from predictionio_tpu.controller import RETRAIN as JAX_RETRAIN
from predictionio_tpu.controller import AverageServing as JaxAverageServing
from predictionio_tpu.controller import DataSource as JaxDataSource
from predictionio_tpu.controller import Engine as JaxEngine
from predictionio_tpu.controller import EngineParams as JaxEngineParams
from predictionio_tpu.controller import FirstServing as JaxFirstServing
from predictionio_tpu.controller import IdentityPreparator as JaxIdentityPreparator
from predictionio_tpu.controller import PersistentModelManifest as JaxManifest
from predictionio_tpu.controller import WorkflowParams as JaxWorkflowParams
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu.ops.als import init_factors as jax_init_factors
from predictionio_tpu.storage import BiMap as JaxBiMap
from predictionio_tpu.storage import StorageRegistry as JaxStorageRegistry
from predictionio_tpu.workflow import serving as jax_serving
from predictionio_tpu.workflow.context import WorkflowContext as JaxContext
from predictionio_tpu.workflow.core_workflow import run_train as jax_run_train
from predictionio_tpu_torch.controller import (
    RETRAIN,
    Algorithm,
    AverageServing,
    DataSource,
    Engine,
    EngineParams,
    FirstServing,
    IdentityPreparator,
    Params,
    PersistentModel,
    PersistentModelManifest,
    Preparator,
    SanityCheck,
    Serving,
    WorkflowParams,
)
from predictionio_tpu_torch.controller import dase as port_dase
from predictionio_tpu_torch.models import recommendation as rec
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.storage import STATUS_COMPLETED, BiMap, Model, StorageRegistry
from predictionio_tpu_torch.utils.durability import atomic_write_bytes
from predictionio_tpu_torch.workflow import (
    ForeignModelError,
    ServerConfig,
    WorkflowContext,
    create_query_server,
    load_models,
    persist_instance,
    prepare_deployment,
    run_train,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = WorkflowContext(device="cpu")


# -- the port's copy of the toy components -----------------------------------
@dataclasses.dataclass(frozen=True)
class TrainingData:
    id: int
    error: bool = False

    def sanity_check(self):
        if self.error:
            raise ValueError(f"TrainingData {self.id} failed sanity check")


@dataclasses.dataclass(frozen=True)
class PreparedData:
    id: int
    td_id: int


@dataclasses.dataclass(frozen=True)
class SampleModel:
    algo_id: int
    pd_id: int


@dataclasses.dataclass(frozen=True)
class IdParams(Params):
    id: int = 0


@dataclasses.dataclass(frozen=True)
class DSParams(Params):
    id: int = 0
    n_eval_sets: int = 0
    error: bool = False


class DataSource0(DataSource):
    params_class = DSParams

    def __init__(self, params: DSParams = DSParams()):
        self.params = params

    def read_training(self, ctx):
        return TrainingData(id=self.params.id, error=self.params.error)


class Preparator0(Preparator):
    params_class = IdParams

    def __init__(self, params: IdParams = IdParams()):
        self.params = params

    def prepare(self, ctx, td):
        return PreparedData(id=self.params.id, td_id=td.id)


class Algo0(Algorithm):
    params_class = IdParams
    count = 0

    def __init__(self, params: IdParams = IdParams()):
        self.params = params

    def train(self, ctx, pd):
        type(self).count += 1
        return SampleModel(algo_id=self.params.id, pd_id=pd.id)

    def predict(self, model, query):
        return (self.params.id, model, query)


class Serving0(Serving):
    params_class = IdParams

    def __init__(self, params: IdParams = IdParams()):
        self.params = params

    def serve(self, query, predictions):
        return predictions[0]


_saved_store = {}


@dataclasses.dataclass(frozen=True)
class PersistableModel(PersistentModel):
    algo_id: int
    pd_id: int

    def save(self, instance_id, params, ctx) -> bool:
        _saved_store[(instance_id, self.algo_id)] = self
        return True

    @classmethod
    def load(cls, instance_id, params, ctx):
        return _saved_store[(instance_id, params.id)]


class PersistentAlgo(Algo0):
    count = 0

    def train(self, ctx, pd):
        type(self).count += 1
        return PersistableModel(algo_id=self.params.id, pd_id=pd.id)


class NonPersistentAlgo(Algo0):
    count = 0

    def make_persistent(self, instance_id, model, ctx):
        return RETRAIN


@pytest.fixture(autouse=True)
def _reset():
    for cls in (Algo0, PersistentAlgo, NonPersistentAlgo):
        cls.count = 0
    _saved_store.clear()
    jse.reset_all_counts()


def _both(algos=None, ds_error=False, algo_ids=(("", 11),)):
    """(port engine and params, JAX engine and params) over the same
    component names and ids."""
    port_algos = algos or {"": Algo0}
    jax_algos = {name: getattr(jse, cls.__name__) for name, cls in port_algos.items()}
    ports = [(name, IdParams(id=a)) for name, a in algo_ids]
    jaxes = [(name, jse.IdParams(id=a)) for name, a in algo_ids]
    port = (Engine({"": DataSource0}, {"": Preparator0}, port_algos, {"": Serving0}),
            EngineParams(data_source_params=("", DSParams(id=3, error=ds_error)),
                         preparator_params=("", IdParams(id=7)),
                         algorithm_params_list=ports))
    jax = (JaxEngine({"": jse.DataSource0}, {"": jse.Preparator0}, jax_algos,
                     {"": jse.Serving0}),
           JaxEngineParams(data_source_params=("", jse.DSParams(id=3, error=ds_error)),
                           preparator_params=("", jse.IdParams(id=7)),
                           algorithm_params_list=jaxes))
    return port, jax


def _as_tuple(model):
    """A model of either package as comparable plain values."""
    return (type(model).__name__, model.algo_id, model.pd_id)


def _deploy_both(port, jax, instance_id):
    """Train, make serializable, pickle, deploy, in each package; returns
    (persisted, live) for the port and for the JAX package."""
    (pe, pp), (je, jp) = port, jax
    out = []
    for eng, params, ctx in ((pe, pp, CPU), (je, jp, JaxContext(mode="Training"))):
        models = eng.train(ctx, params)
        persisted = eng.make_serializable_models(ctx, params, instance_id, models)
        live = eng.prepare_deploy(ctx, params, instance_id,
                                  pickle.loads(pickle.dumps(persisted)))
        out.append((persisted, live))
    return out


# -- the TestPersistence cases in both packages ----------------------------------
def test_sanity_check_failure_propagates_in_both():
    (pe, pp), (je, jp) = _both(ds_error=True, algo_ids=(("", 11),))
    for eng, params, ctx in ((pe, pp, CPU), (je, jp, JaxContext(mode="Training"))):
        with pytest.raises(ValueError, match="sanity check"):
            eng.train(ctx, params)
    got = pe.train(CPU, pp, WorkflowParams(skip_sanity_check=True))
    want = je.train(JaxContext(mode="Training"), jp, JaxWorkflowParams(skip_sanity_check=True))
    assert [_as_tuple(m) for m in got] == [_as_tuple(m) for m in want]


def test_plain_model_passthrough_pickle_like_jax():
    port, jax = _both(algo_ids=(("", 11), ("", 13)))
    (p_pers, p_live), (j_pers, j_live) = _deploy_both(port, jax, "I1")
    assert [_as_tuple(m) for m in p_live] == [_as_tuple(m) for m in j_live]
    assert [_as_tuple(m) for m in p_pers] == [_as_tuple(m) for m in j_pers]
    assert Algo0.count == jse.Algo0.count == 1 * 2  # two algorithms, no retrain


def test_persistent_model_manifest_like_jax():
    port, jax = _both(algos={"": PersistentAlgo}, algo_ids=(("", 5),))
    (p_pers, p_live), (j_pers, j_live) = _deploy_both(port, jax, "I2")
    assert isinstance(p_pers[0], PersistentModelManifest)
    assert isinstance(j_pers[0], JaxManifest)
    assert p_pers[0].class_path == f"{__name__}:PersistableModel"
    assert j_pers[0].class_path == "sample_engine:PersistableModel"
    assert isinstance(p_live[0], PersistableModel)
    assert _as_tuple(p_live[0]) == _as_tuple(j_live[0]) == ("PersistableModel", 5, 7)
    assert PersistentAlgo.count == jse.PersistentAlgo.count == 1  # no training at deploy


def test_retrain_at_deploy_like_jax():
    port, jax = _both(algos={"": NonPersistentAlgo}, algo_ids=(("", 9),))
    (pe, pp), (je, jp) = port, jax
    models = pe.train(CPU, pp)
    assert NonPersistentAlgo.count == 1
    persisted = pe.make_serializable_models(CPU, pp, "I3", models)
    assert persisted[0] is RETRAIN
    unpickled = pickle.loads(pickle.dumps(persisted))
    assert unpickled[0] is RETRAIN  # the same sentinel after the store
    live = pe.prepare_deploy(CPU, pp, "I3", unpickled)
    assert NonPersistentAlgo.count == 2  # retrained
    assert live[0] == SampleModel(algo_id=9, pd_id=7)
    jctx = JaxContext(mode="Training")
    jpersisted = je.make_serializable_models(jctx, jp, "I3", je.train(jctx, jp))
    j_live = je.prepare_deploy(jctx, jp, "I3", pickle.loads(pickle.dumps(jpersisted)))
    assert jpersisted[0] is JAX_RETRAIN and jse.NonPersistentAlgo.count == 2
    assert _as_tuple(live[0]) == _as_tuple(j_live[0])


def test_mixed_persistence_like_jax():
    algos = {"plain": Algo0, "npa": NonPersistentAlgo, "pa": PersistentAlgo}
    port, jax = _both(algos=algos, algo_ids=(("plain", 1), ("npa", 2), ("pa", 3)))
    (p_pers, p_live), (j_pers, j_live) = _deploy_both(port, jax, "I4")
    assert [_as_tuple(m) for m in p_live] == [_as_tuple(m) for m in j_live]
    assert p_live[0] == SampleModel(algo_id=1, pd_id=7)
    assert p_live[1] == SampleModel(algo_id=2, pd_id=7)
    assert isinstance(p_live[2], PersistableModel)
    assert [type(m).__name__ for m in p_pers] == ["SampleModel", "_RetrainSentinel",
                                                  "PersistentModelManifest"]
    assert [type(m).__name__ for m in p_pers] == [type(m).__name__ for m in j_pers]
    # one training of every algorithm, one more at deploy for the RETRAIN
    # entry's engine (the whole engine trains again, as in the reference)
    assert (Algo0.count, NonPersistentAlgo.count, PersistentAlgo.count) == (2, 2, 2)
    assert ((jse.Algo0.count, jse.NonPersistentAlgo.count, jse.PersistentAlgo.count)
            == (2, 2, 2))


def test_a_blob_with_the_wrong_number_of_entries_is_refused():
    (pe, pp), _ = _both(algos={"": NonPersistentAlgo}, algo_ids=(("", 9),))
    with pytest.raises(ValueError, match="persisted 2 models for 1 algorithms"):
        pe.prepare_deploy(CPU, pp, "I5", [RETRAIN, RETRAIN])
    assert NonPersistentAlgo.count == 0  # refused before any retrain


def test_a_declined_save_falls_back_to_retrain():
    class Declines(PersistableModel):
        def save(self, instance_id, params, ctx):
            return False

    algo = Algo0(IdParams(id=4))
    assert algo.make_persistent("I6", Declines(4, 7), CPU) is RETRAIN
    assert algo.make_persistent("I6", SampleModel(4, 7), CPU) == SampleModel(4, 7)


# -- the sentinel, the manifest and the unpickler ------------------------------------
def test_retrain_pickles_through_the_ports_own_module_path(tmp_path):
    blob = pickle.dumps([RETRAIN])
    assert b"predictionio_tpu_torch.controller.dase" in blob
    assert b"_retrain_instance" in blob
    assert repr(RETRAIN) == repr(JAX_RETRAIN) == "RETRAIN"
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    ep = EngineParams(algorithm_params_list=[("", IdParams(id=1))])
    manifest = PersistentModelManifest.of(PersistableModel(1, 2))
    instance_id = persist_instance(registry, ep, [RETRAIN, manifest])
    loaded = load_models(registry, instance_id)
    assert loaded[0] is RETRAIN
    assert loaded[1] == manifest and loaded[1].resolve() is PersistableModel
    # the JAX package's sentinel names its own module: refused, never imported
    registry.get_models().insert(Model(id="EI-jax", models=pickle.dumps([JAX_RETRAIN])))
    with pytest.raises(ForeignModelError, match="predictionio_tpu.controller.dase"):
        load_models(registry, "EI-jax")


@pytest.mark.parametrize("path", [
    "predictionio_tpu.models.recommendation:ALSModel",
    "predictionio_tpu:Anything",
    "jax.numpy:ndarray",
    "jaxlib.xla_client:Client",
])
def test_a_manifest_naming_the_jax_package_is_refused(path):
    with pytest.raises(ForeignModelError, match="JAX package"):
        PersistentModelManifest(path).resolve()
    assert PersistentModelManifest(path) == PersistentModelManifest(path)
    assert PersistentModelManifest(path) != JaxManifest(path)


def test_the_refusal_comes_before_any_import_of_jax():
    """In a fresh interpreter: the manifest of a JAX-package class and a
    blob holding one are refused, and jax is never imported."""
    blob = pickle.dumps([JAX_RETRAIN]).hex()
    script = textwrap.dedent(f"""
        import io, pickle, sys
        sys.path.insert(0, {REPO!r})
        from predictionio_tpu_torch.controller import PersistentModelManifest
        from predictionio_tpu_torch.workflow.core_workflow import _PortUnpickler
        from predictionio_tpu_torch.workflow import ForeignModelError
        for path in ("predictionio_tpu.controller.dase:PersistentModel", "jax:Array"):
            try:
                PersistentModelManifest(path).resolve()
            except ForeignModelError:
                pass
            else:
                raise SystemExit("resolved " + path)
        try:
            _PortUnpickler(io.BytesIO(bytes.fromhex({blob!r}))).load()
        except ForeignModelError:
            pass
        else:
            raise SystemExit("unpickled the JAX package's sentinel")
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "predictionio_tpu"))
        print(loaded)
    """)
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# -- the other DASE pieces, like the JAX package's -----------------------------
def test_identity_preparator_average_serving_and_sanity_check_like_jax():
    assert IdentityPreparator().prepare(CPU, "td") == JaxIdentityPreparator().prepare(
        None, "td") == "td"
    assert AverageServing().serve(None, [1.0, 2.0, 4.5]) == JaxAverageServing().serve(
        None, [1.0, 2.0, 4.5])

    class Bad(SanityCheck):
        def sanity_check(self):
            raise ValueError("bad data")

    with pytest.raises(TypeError):
        SanityCheck()
    with pytest.raises(ValueError, match="bad data"):
        port_dase.run_sanity_check(Bad(), "data")
    assert {"RETRAIN", "SanityCheck", "IdentityPreparator", "PersistentModel",
            "PersistentModelManifest", "AverageServing"} <= set(
        __import__("predictionio_tpu_torch.controller", fromlist=["x"]).__all__)


# -- the recommendation template: retrain at deploy, in both packages ------------
RANK, N_USERS, N_ITEMS, NNZ = 8, 200, 90, 4000
ALS_RTOL, ALS_ATOL = 2e-3, 2e-4
SERVE_RTOL = SERVE_ATOL = 1e-5
ALS_PARAMS = dict(rank=RANK, num_iterations=3, lambda_=0.05, seed=2)
QUERIES = [("u0", 10), ("u17", 1), ("ghost", 5), ("u199", 37), ("u42", 90)]


def _ratings():
    rng = np.random.default_rng(13)
    w = 1.0 / np.arange(1, N_USERS + 1) ** 0.8
    users = rng.choice(N_USERS, size=NNZ, p=w / w.sum()).astype(np.int32)
    items = rng.integers(0, N_ITEMS, NNZ).astype(np.int32)
    ratings = rng.integers(1, 6, NNZ).astype(np.float32)
    return users, items, ratings


def _ids(prefix, n):
    return {f"{prefix}{i}": i for i in range(n)}


class RetrainALS(rec.ALSAlgorithm):
    """The template's algorithm, opted out of the model store."""

    count = 0
    trained: list = []

    def train(self, ctx, pd):
        type(self).count += 1
        model = super().train(ctx, pd)
        type(self).trained.append(model)
        return model

    def make_persistent(self, instance_id, model, ctx):
        return RETRAIN


class JaxRetrainALS(jrec.ALSAlgorithm):
    count = 0

    def train(self, ctx, pd):
        type(self).count += 1
        return super().train(ctx, pd)

    def make_persistent(self, instance_id, model, ctx):
        return JAX_RETRAIN


class ArraysSource(DataSource):
    def read_training(self, ctx):
        users, items, ratings = _ratings()
        return rec.TrainingData(users=users, items=items, ratings=ratings,
                                user_map=BiMap(_ids("u", N_USERS)),
                                item_map=BiMap(_ids("i", N_ITEMS)))


class JaxArraysSource(JaxDataSource):
    def read_training(self, ctx):
        users, items, ratings = _ratings()
        return jrec.TrainingData(users=users, items=items, ratings=ratings,
                                 user_map=JaxBiMap(_ids("u", N_USERS)),
                                 item_map=JaxBiMap(_ids("i", N_ITEMS)))


@pytest.fixture()
def jax_table(monkeypatch):
    """The port starts from the JAX package's initial table (a
    ``torch.Generator`` cannot reproduce ``jax.random``)."""
    table = np.asarray(jax_init_factors(N_ITEMS, RANK, ALS_PARAMS["seed"]))
    monkeypatch.setattr(als, "init_factors", lambda n, rank, seed, device: (
        torch.from_numpy(table.copy()).to(device)))
    RetrainALS.count = JaxRetrainALS.count = 0
    RetrainALS.trained = []


def _scores_ids(results):
    return {i: ([x.item for x in r.item_scores],
                np.array([x.score for x in r.item_scores], np.float32))
            for i, r in results}


def _agree(got, want, rtol, atol):
    for i, (w_items, w_scores) in want.items():
        g_items, g_scores = got[i]
        assert len(g_items) == len(w_items)
        if not w_items:
            continue
        np.testing.assert_allclose(g_scores, w_scores, rtol=rtol, atol=atol)
        tied = np.isclose(g_scores, w_scores, rtol=rtol, atol=atol)
        same = np.array([a == b for a, b in zip(g_items, w_items)])
        assert (same | tied).all(), (i, g_items, w_items)


def test_retrain_at_deploy_of_the_als_template_like_jax(tmp_path, jax_table):
    port_engine = Engine({"": ArraysSource}, {"": rec.RecPreparator},
                         {"als": RetrainALS}, {"": FirstServing})
    jax_engine = JaxEngine({"": JaxArraysSource}, {"": jrec.RecPreparator},
                           {"als": JaxRetrainALS}, {"": JaxFirstServing})
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path / "port")})
    jregistry = JaxStorageRegistry({"PIO_FS_BASEDIR": str(tmp_path / "jax")})
    ep = EngineParams(algorithm_params_list=[("als", rec.ALSAlgorithmParams(**ALS_PARAMS))])
    jep = JaxEngineParams(algorithm_params_list=[("als", jrec.ALSAlgorithmParams(**ALS_PARAMS))])
    instance_id = run_train(port_engine, ep, registry, ctx=WorkflowContext(device="cpu"))
    jinstance = jax_run_train(jax_engine, jep, jregistry, ctx=JaxContext(mode="Training"))
    assert RetrainALS.count == JaxRetrainALS.count == 1
    inst = registry.get_metadata().engine_instance_get(instance_id)
    assert inst.status == STATUS_COMPLETED
    # the blob holds the sentinel alone: no factor bytes
    blob = registry.get_models().get(instance_id).models
    assert load_models(registry, instance_id) == [RETRAIN] and len(blob) < 200

    dep = prepare_deployment(port_engine, registry,
                             ServerConfig(engine_instance_id=instance_id, device="cpu"),
                             WorkflowContext(mode="Serving", device="cpu"))
    jdep = jax_serving.prepare_deployment(
        jax_engine, jregistry, jax_serving.ServerConfig(engine_instance_id=jinstance))
    (model,), (jmodel,) = dep.models, jdep.models
    assert (RetrainALS.count, JaxRetrainALS.count) == (2, 2)  # retrained once each
    # retraining from the same data with the same seed gives the same factors
    first = RetrainALS.trained[0]
    assert model is RetrainALS.trained[1]
    assert np.array_equal(model.user_factors, first.user_factors)
    assert np.array_equal(model.item_factors, first.item_factors)
    np.testing.assert_allclose(model.user_factors, jmodel.user_factors,
                               rtol=ALS_RTOL, atol=ALS_ATOL)
    np.testing.assert_allclose(model.item_factors, jmodel.item_factors,
                               rtol=ALS_RTOL, atol=ALS_ATOL)

    queries = [(i, rec.Query(user=u, num=n)) for i, (u, n) in enumerate(QUERIES)]
    jqueries = [(i, jrec.Query(user=u, num=n)) for i, (u, n) in enumerate(QUERIES)]
    got = _scores_ids(dep.algorithms[0].batch_predict(model, queries))
    # the JAX template serving the port's retrained factors: the same answers
    carried = jrec.ALSModel(rank=RANK, user_factors=model.user_factors,
                            item_factors=model.item_factors,
                            user_map=JaxBiMap(model.user_map.to_dict()),
                            item_map=JaxBiMap(model.item_map.to_dict()))
    jalgo = jrec.ALSAlgorithm(jrec.ALSAlgorithmParams(**ALS_PARAMS))
    _agree(got, _scores_ids(jalgo.batch_predict(carried, jqueries)), SERVE_RTOL, SERVE_ATOL)
    # and the JAX package's own deployment, to the ALS tolerance
    _agree(got, _scores_ids(jdep.algorithms[0].batch_predict(jmodel, jqueries)),
           ALS_RTOL, ALS_ATOL * 10)


def test_the_query_server_retrains_at_start_and_at_reload(tmp_path, jax_table):
    engine = Engine({"": ArraysSource}, {"": rec.RecPreparator},
                    {"als": RetrainALS}, {"": FirstServing})
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    ep = EngineParams(algorithm_params_list=[("als", rec.ALSAlgorithmParams(**ALS_PARAMS))])
    run_train(engine, ep, registry, ctx=WorkflowContext(device="cpu"))
    server = create_query_server(engine, ServerConfig(ip="127.0.0.1", port=0, device="cpu"),
                                 registry=registry, block=False)
    try:
        assert RetrainALS.count == 2
        first = server.deployment.models[0]
        answer = server.handle_query({"user": "u3", "num": 4})
        assert len(answer["itemScores"]) == 4
        server.reload()
        assert RetrainALS.count == 3
        again = server.deployment.models[0]
        assert again is not first
        assert np.array_equal(again.item_factors, first.item_factors)
        assert server.handle_query({"user": "u3", "num": 4}) == answer
    finally:
        server.shutdown()
        server.server_close()


class SavedALSModel(rec.ALSModel, PersistentModel):
    """An ALS model that writes its own tables (atomically) under a
    directory named by its params, and reads them back at deploy."""

    root = ""

    def save(self, instance_id, params, ctx) -> bool:
        arrays = {"user_factors": self.user_factors, "item_factors": self.item_factors,
                  "user_ids": np.array(list(self.user_map.to_dict()), dtype=object),
                  "item_ids": np.array(list(self.item_map.to_dict()), dtype=object)}
        for name, a in arrays.items():
            atomic_write_bytes(os.path.join(self.root, f"{instance_id}.{name}.pkl"),
                               pickle.dumps(a))
        return True

    @classmethod
    def load(cls, instance_id, params, ctx):
        def read(name):
            with open(os.path.join(cls.root, f"{instance_id}.{name}.pkl"), "rb") as fh:
                return pickle.load(fh)

        base = rec.als_model_from_numpy(params.rank, read("user_factors"),
                                        read("item_factors"), list(read("user_ids")),
                                        list(read("item_ids")))
        return cls(**{f.name: getattr(base, f.name) for f in dataclasses.fields(base)})


class SavingALS(rec.ALSAlgorithm):
    count = 0

    def train(self, ctx, pd):
        type(self).count += 1
        model = super().train(ctx, pd)
        return SavedALSModel(**{f.name: getattr(model, f.name)
                                for f in dataclasses.fields(model)})


def test_a_self_persisting_als_model_deploys_from_its_manifest(tmp_path, jax_table):
    SavedALSModel.root = str(tmp_path)
    SavingALS.count = 0
    engine = Engine({"": ArraysSource}, {"": rec.RecPreparator},
                    {"als": SavingALS}, {"": FirstServing})
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path / "store")})
    ep = EngineParams(algorithm_params_list=[("als", rec.ALSAlgorithmParams(**ALS_PARAMS))])
    instance_id = run_train(engine, ep, registry, ctx=WorkflowContext(device="cpu"))
    (manifest,) = load_models(registry, instance_id)
    assert manifest == PersistentModelManifest(f"{__name__}:SavedALSModel")
    dep = prepare_deployment(engine, registry,
                             ServerConfig(engine_instance_id=instance_id, device="cpu"))
    assert SavingALS.count == 1  # deploy loads, never trains
    (model,) = dep.models
    assert isinstance(model, SavedALSModel)
    saved = {n: pickle.load(open(tmp_path / f"{instance_id}.{n}.pkl", "rb"))
             for n in ("user_factors", "item_factors")}
    assert np.array_equal(model.user_factors, saved["user_factors"])
    assert np.array_equal(model.item_factors, saved["item_factors"])
    got = dep.algorithms[0].batch_predict(model, [(0, rec.Query(user="u5", num=3))])
    assert len(got[0][1].item_scores) == 3
    assert not list(tmp_path.glob("*.tmp"))  # every write completed
