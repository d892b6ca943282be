"""Engines with components in another language, through the port.

The port's ``controller/foreign.py`` runs a DASE component as a child
process speaking line-delimited JSON over stdio. The worked example
``examples/cpp_engine/popularity.cc`` (with ``sdk/cpp/pio_engine.hpp``) is
compiled with the system's ``g++`` and driven through the port exactly as
``tests/test_foreign_engine.py`` drives it through the JAX package — the
same nine cases: train and predict, params reaching the child, the
model's pickle round trip into a fresh child (the deploy path), a bad
query failing alone, a crashed child respawned and reloaded, non-BMP
strings, a half-written line tripping the per-request timeout, a missing
binary, and a mixed-language engine trained by the port's ``Engine``.
Each case runs in both packages on the same inputs, and their answers
are compared.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import time

import pytest

from predictionio_tpu.controller import Engine as JaxEngine
from predictionio_tpu.controller import EngineParams as JaxEngineParams
from predictionio_tpu.controller import foreign as jax_foreign
from predictionio_tpu.controller.dase import IdentityPreparator as JaxIdentityPreparator
from predictionio_tpu.controller.dase import Serving as JaxServing
from predictionio_tpu_torch.controller import Engine, EngineParams, IdentityPreparator, Serving
from predictionio_tpu_torch.controller.foreign import (
    ForeignAlgorithm,
    ForeignModel,
    ForeignParams,
    ForeignProcessError,
)
from predictionio_tpu_torch.workflow import WorkflowContext

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EXAMPLE = os.path.join(_REPO, "examples", "cpp_engine")

RATINGS = [
    ["u1", "i1", 5.0], ["u2", "i1", 4.0], ["u3", "i1", 3.0],
    ["u1", "i2", 5.0], ["u2", "i2", 4.0],
    ["u1", "i3", 1.0],
]


@pytest.fixture(scope="module")
def popularity_bin(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cppengine") / "popularity")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-I", os.path.join(_REPO, "sdk", "cpp"),
         "-o", out, os.path.join(_EXAMPLE, "popularity.cc")],
        check=True, capture_output=True,
    )
    return out


def _algos(cmd, timeout_s=30, **params):
    """The port's and the JAX package's foreign algorithm on one command."""
    return (ForeignAlgorithm(ForeignParams(cmd=cmd, params=params, timeout_s=timeout_s)),
            jax_foreign.ForeignAlgorithm(
                jax_foreign.ForeignParams(cmd=cmd, params=params, timeout_s=timeout_s)))


def test_train_and_predict_like_jax(popularity_bin):
    ours, theirs = _algos([popularity_bin])
    model = ours.train(None, {"ratings": RATINGS})
    jmodel = theirs.train(None, {"ratings": RATINGS})
    assert isinstance(model, ForeignModel)
    assert model.model_json == jmodel.model_json
    assert model.model_json["items"][0] == "i1"  # sum 12 > 9 > 1
    pred = ours.predict(model, {"user": "u9", "num": 2})
    assert pred == theirs.predict(jmodel, {"user": "u9", "num": 2})
    assert [r["item"] for r in pred["itemScores"]] == ["i1", "i2"]
    assert pred["itemScores"][0]["score"] == 12.0


def test_params_reach_the_child_like_jax(popularity_bin):
    ours, theirs = _algos([popularity_bin], min_count=3)
    model = ours.train(None, {"ratings": RATINGS})
    assert model.model_json["items"] == ["i1"]  # only i1 has >= 3 ratings
    assert model.model_json == theirs.train(None, {"ratings": RATINGS}).model_json


def test_model_pickle_roundtrip_into_a_fresh_child(popularity_bin):
    """The deploy path: the trained model goes through the model store
    (pickle) and a new algorithm serves it by respawning the child and
    pushing the model back with ``load``."""
    ours, theirs = _algos([popularity_bin])
    restored = pickle.loads(pickle.dumps(ours.train(None, {"ratings": RATINGS})))
    assert b"predictionio_tpu_torch.controller.foreign" in pickle.dumps(restored)
    server_algo, _ = _algos([popularity_bin])  # a fresh process
    pred = server_algo.predict(restored, {"user": "u1", "num": 1})
    jrestored = pickle.loads(pickle.dumps(theirs.train(None, {"ratings": RATINGS})))
    assert pred == _algos([popularity_bin])[1].predict(jrestored, {"user": "u1", "num": 1})
    assert pred["itemScores"][0]["item"] == "i1"


def test_a_bad_query_fails_alone_like_jax(popularity_bin):
    for algo in _algos([popularity_bin]):
        model = algo.train(None, {"ratings": RATINGS})
        with pytest.raises(RuntimeError, match="num must be >= 0"):
            algo.predict(model, {"user": "u1", "num": -1})
        ok = algo.predict(model, {"user": "u1", "num": 1})  # the child survived
        assert ok["itemScores"][0]["item"] == "i1"


def test_a_crashed_child_is_respawned_and_reloaded(popularity_bin):
    answers = []
    for algo in _algos([popularity_bin]):
        model = algo.train(None, {"ratings": RATINGS})
        algo._proc._proc.kill()  # the component dies
        algo._proc._proc.wait()
        answers.append(algo.predict(model, {"user": "u1", "num": 1}))
    assert answers[0] == answers[1]
    assert answers[0]["itemScores"][0]["item"] == "i1"


def test_non_bmp_strings_roundtrip_like_jax(popularity_bin):
    """``json.dumps`` escapes emoji as surrogate pairs; the C++ codec must
    recombine them."""
    ratings = [["u😀", "item🎉", 5.0], ["u2", "item🎉", 2.0]]
    preds = []
    for algo in _algos([popularity_bin]):
        model = algo.train(None, {"ratings": ratings})
        assert model.model_json["items"][0] == "item🎉"
        preds.append(algo.predict(model, {"user": "u😀", "num": 1}))
    assert preds[0] == preds[1]
    assert preds[0]["itemScores"][0]["item"] == "item🎉"


def test_a_half_written_line_trips_the_timeout(tmp_path):
    """A child that writes half a response and wedges trips the
    per-request deadline in both packages."""
    script = tmp_path / "wedge.py"
    script.write_text(textwrap.dedent("""
        import sys, time
        sys.stdin.readline()
        sys.stdout.write('{"id": 1, ')   # partial line, no newline
        sys.stdout.flush()
        time.sleep(600)
    """))
    ours, theirs = _algos([sys.executable, str(script)], timeout_s=1.5)
    for algo, error in ((ours, ForeignProcessError),
                        (theirs, jax_foreign.ForeignProcessError)):
        t0 = time.monotonic()
        with pytest.raises(error, match="timed out"):
            algo.train(None, {"ratings": []})
        assert time.monotonic() - t0 < 10


def test_a_missing_binary_is_loud_like_jax():
    ours, theirs = _algos(["/nonexistent/engine-bin"], timeout_s=5)
    with pytest.raises(ForeignProcessError, match="cannot start"):
        ours.train(None, {"ratings": RATINGS})
    with pytest.raises(jax_foreign.ForeignProcessError, match="cannot start"):
        theirs.train(None, {"ratings": RATINGS})


class _DictServing(Serving):
    def serve(self, query, predictions):
        return predictions[0]


class _JaxDictServing(JaxServing):
    def serve(self, query, predictions):
        return predictions[0]


class _ListSource:
    """A Python DataSource feeding the foreign algorithm: the
    mixed-language engine."""

    params = None

    def __init__(self, params=None):
        self.params = params

    def read_training(self, ctx):
        return {"ratings": RATINGS}

    def read_eval(self, ctx):
        return []


def test_the_ports_engine_trains_a_foreign_algorithm_like_jax(popularity_bin):
    engine = Engine({"": _ListSource}, {"": IdentityPreparator},
                    {"": ForeignAlgorithm}, {"": _DictServing})
    ep = EngineParams(algorithm_params_list=[
        ("", ForeignParams(cmd=[popularity_bin], timeout_s=30))])
    models = engine.train(WorkflowContext(device="cpu"), ep)
    assert len(models) == 1 and isinstance(models[0], ForeignModel)
    jengine = JaxEngine({"": _ListSource}, {"": JaxIdentityPreparator},
                        {"": jax_foreign.ForeignAlgorithm}, {"": _JaxDictServing})
    jep = JaxEngineParams(algorithm_params_list=[
        ("", jax_foreign.ForeignParams(cmd=[popularity_bin], timeout_s=30))])
    (jmodel,) = jengine.train(None, jep)
    assert models[0].model_json == jmodel.model_json
    # the foreign model passes through the port's model store as a blob
    persisted = engine.make_serializable_models(None, ep, "I1", models)
    live = engine.prepare_deploy(None, ep, "I1", pickle.loads(pickle.dumps(persisted)))
    served = engine._algorithms(ep)[0].predict(live[0], {"user": "u1", "num": 2})
    assert [r["item"] for r in served["itemScores"]] == ["i1", "i2"]
