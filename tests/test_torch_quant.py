"""Quantized serving tables of the port (``predictionio_tpu_torch/quant``)
against the JAX package's (``tests/test_quant.py`` mirrored, tolerances
unchanged), on the CPU.

1. **Codec**: the int8 codes and scales bit-equal to the JAX package's on
   seeded tables (the host encode is the same numpy); fp8 codes bit-equal
   to the JAX package's own ``astype(jnp.float8_e4m3fn)`` of the same
   normalised rows; zero rows; the byte model; the loud fp8 → int8
   fallback off a CUDA device.
2. **Ragged gather and dequant**: bit-identical to dense indexing.
3. **The lever**: tri-state resolution, an invalid ``PIO_SERVE_QUANT``.
4. **The gate**: an exact grid passes at 1.0 and serves ids equal to the
   f32 path; the seed-5 gaussian table is refused at 0.921875 — the JAX
   package's rate — and counted; tampered codes collapse the rate; a
   trained model (``test_sharded_train``'s recipe) measured alike in both
   packages, refused at the strict default and admitted at an explicit
   floor; ``ALSAlgorithm`` end to end.
5. **The query server**: ``/status.json`` (``topkPath`` "quant",
   ``quantServing``, ``quantGate``) and ``/metrics``
   (``pio_quant_gate_runs_total``, ``pio_quant_gate_refusals_total``),
   and a refusal answered with its message.

The JAX package's ledger records of the quant bench (``TestQuantRecords``)
belong to the port's bench entry (ROADMAP.md, queue 1 item 14a).
"""

from __future__ import annotations

import http.client
import json
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from predictionio_tpu import quant as jq
from predictionio_tpu_torch import quant as pq
from predictionio_tpu_torch.quant import table as ptable

CPU = "cpu"


def _exact_grid(n, rank, seed=0):
    """A table symmetric-absmax int8 round-trips within f32 rounding:
    integer codes in [-126, 127], one entry per row forced to 127, times a
    per-row scale (the JAX test's recipe)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-126, 127, size=(n, rank))
    k[np.arange(n), rng.integers(0, rank, size=n)] = 127
    scale = rng.uniform(0.01, 2.0, size=(n, 1))
    return (k * scale).astype(np.float32)


def _gaussian(seed, n, rank):
    return np.random.default_rng(seed).normal(size=(n, rank)).astype(np.float32)


# -- 1. codec -------------------------------------------------------------
class TestTableCodec:
    def test_int8_roundtrip_on_exact_grid(self):
        table = _exact_grid(40, 8)
        qtable = pq.quantize_table(table, device=CPU)
        assert qtable.dtype == "int8"
        assert qtable.codes.dtype == torch.int8
        approx = pq.dequantize_rows(qtable, np.arange(40)).numpy()
        denom = np.maximum(np.abs(table).max(axis=1, keepdims=True), 1e-9)
        assert np.max(np.abs(approx - table) / denom) < 1e-4

    def test_quantization_error_bounded_by_half_step(self):
        table = np.random.default_rng(3).normal(size=(64, 16)).astype(np.float32)
        qtable = pq.quantize_table(table, device=CPU)
        approx = pq.dequantize_rows(qtable, np.arange(64)).numpy()
        step = qtable.scales.numpy()[:, None]
        assert np.all(np.abs(approx - table) <= 0.5 * step + 1e-6)

    def test_zero_rows_are_safe(self):
        table = np.zeros((4, 6), dtype=np.float32)
        table[2] = 1.0
        qtable = pq.quantize_table(table, device=CPU)
        assert qtable.scales.numpy()[0] == 0.0
        approx = pq.dequantize_rows(qtable, np.arange(4)).numpy()
        assert np.all(approx[0] == 0.0) and np.all(approx[1] == 0.0)

    def test_unknown_dtype_is_loud(self):
        with pytest.raises(ValueError, match="dtype"):
            pq.quantize_table(np.ones((2, 2), dtype=np.float32), dtype="int4", device=CPU)

    def test_non_2d_table_is_loud(self):
        with pytest.raises(ValueError, match="2-D"):
            pq.quantize_table(np.ones(8, dtype=np.float32), device=CPU)

    def test_fp8_falls_back_loudly_off_a_cuda_device(self):
        table = _exact_grid(8, 4)
        assert pq.fp8_supported(CPU) is False
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            qtable = pq.quantize_table(table, dtype="fp8", device=CPU)
        assert qtable.dtype == "int8"
        assert qtable.fallback and "fp8" in qtable.fallback
        assert any("fp8" in str(w.message) for w in caught)
        assert qtable.status()["fallback"] == qtable.fallback
        # the fallback table is the int8 table, bit for bit
        assert torch.equal(qtable.codes, pq.quantize_table(table, device=CPU).codes)

    def test_estimate_matches_real_table_bytes(self):
        qtable = pq.quantize_table(_exact_grid(50, 8), device=CPU)
        assert pq.estimate_table_bytes(50, 8, "int8") == qtable.table_bytes
        assert pq.estimate_table_bytes(50, 8, "f32") == qtable.f32_bytes
        assert qtable.f32_bytes == 50 * 8 * 4
        with pytest.raises(ValueError, match="dtype"):
            pq.estimate_table_bytes(50, 8, "int7")

    def test_bench_recipe_compression_clears_3x(self):
        f32 = pq.estimate_table_bytes(1000, 50, "f32")
        int8 = pq.estimate_table_bytes(1000, 50, "int8")
        assert f32 / int8 >= 3.0
        assert pq.quantize_table(_exact_grid(100, 50), device=CPU).compression_ratio >= 3.0

    @pytest.mark.parametrize("seed,shape", [(0, (40, 8)), (3, (64, 16)), (11, (257, 50))])
    def test_int8_codes_and_scales_bit_equal_the_jax_package(self, seed, shape):
        table = _gaussian(seed, *shape)
        table[1] = 0.0
        mine = pq.quantize_table(table, device=CPU)
        theirs = jq.quantize_table(table)
        np.testing.assert_array_equal(mine.codes.numpy(), np.asarray(theirs.codes))
        np.testing.assert_array_equal(mine.scales.numpy(), np.asarray(theirs.scales))
        assert mine.status() == theirs.status()

    @pytest.mark.parametrize("seed,shape", [(0, (40, 8)), (5, (300, 50))])
    def test_fp8_codes_bit_equal_the_jax_package_encode(self, seed, shape):
        """The port's fp8 encode of the normalised rows against the JAX
        package's own ``astype(jnp.float8_e4m3fn)`` of the same rows."""
        table = _gaussian(seed, *shape) * 3.0
        table[2] = 0.0
        normalized, scales = ptable._normalized_rows(table, pq.FP8_QMAX)
        j_normalized, j_scales = jq.table._normalized_rows(table, jq.FP8_QMAX)
        np.testing.assert_array_equal(normalized, j_normalized)
        np.testing.assert_array_equal(scales, j_scales)
        mine = ptable._fp8_codes(normalized).view(torch.uint8).numpy()
        theirs = np.asarray(jnp.asarray(j_normalized).astype(jnp.float8_e4m3fn)).view(np.uint8)
        np.testing.assert_array_equal(mine, theirs)

    def test_fp8_table_scores_like_the_jax_fp8_table(self, monkeypatch):
        """With the capability probe forced on, the fp8 table's dequantized
        rows equal the JAX package's fp8 table's."""
        monkeypatch.setattr(ptable, "fp8_supported", lambda device=None: True)
        table = _exact_grid(30, 8, seed=4)
        mine = pq.quantize_table(table, dtype="fp8", device=CPU)
        assert mine.dtype == "fp8" and mine.codes.dtype == torch.float8_e4m3fn
        normalized, scales = jq.table._normalized_rows(table, jq.FP8_QMAX)
        theirs = np.asarray(jnp.asarray(normalized).astype(jnp.float8_e4m3fn))
        want = theirs.astype(np.float32) * scales[:, None]
        np.testing.assert_array_equal(pq.dequantize_rows(mine, np.arange(30)).numpy(), want)


# -- 2. ragged gather and dequant -----------------------------------------
class TestRaggedGather:
    @pytest.mark.parametrize(
        "ids",
        [np.array([3, 1, 3, 3, 0, 7, 1]), np.array([[5, 5, 2], [0, 9, 9]]), np.zeros(4)],
        ids=["dups-1d", "block-2d", "all-zero"],
    )
    def test_bit_identical_to_dense_gather(self, ids):
        table = np.random.default_rng(11).normal(size=(10, 6)).astype(np.float32)
        ids = ids.astype(np.int64)
        got = pq.ragged_gather(torch.from_numpy(table), torch.from_numpy(ids)).numpy()
        assert np.array_equal(got, table[ids])

    def test_empty_ids(self):
        out = pq.ragged_gather(torch.ones((5, 3)), torch.zeros(0, dtype=torch.long))
        assert tuple(out.shape) == (0, 3)

    def test_dequantize_rows_matches_full_dequant_and_the_jax_package(self):
        table = _exact_grid(20, 5)
        qtable = pq.quantize_table(table, device=CPU)
        ids = np.array([7, 7, 1, 19, 7], dtype=np.int32)
        full = qtable.codes.numpy().astype(np.float32) * qtable.scales.numpy()[:, None]
        got = pq.dequantize_rows(qtable, ids).numpy()
        assert np.allclose(got, full[ids], rtol=0, atol=1e-6)
        theirs = np.asarray(jq.dequantize_rows(jq.quantize_table(table), ids))
        np.testing.assert_array_equal(got, theirs)
        empty = pq.dequantize_rows(qtable, np.zeros((0, 2), dtype=np.int32))
        assert tuple(empty.shape) == (0, 2, 5)


# -- 3. the lever -----------------------------------------------------------
class TestServingLever:
    def test_explicit_wins_over_env(self, monkeypatch):
        monkeypatch.setenv("PIO_SERVE_QUANT", "1")
        assert pq.resolve_quantized_serving(False) is False
        monkeypatch.setenv("PIO_SERVE_QUANT", "0")
        assert pq.resolve_quantized_serving(True) is True

    def test_env_resolves_when_unset_explicitly(self, monkeypatch):
        monkeypatch.delenv("PIO_SERVE_QUANT", raising=False)
        assert pq.resolve_quantized_serving(None) is False
        monkeypatch.setenv("PIO_SERVE_QUANT", "1")
        assert pq.resolve_quantized_serving(None) is True
        monkeypatch.setenv("PIO_SERVE_QUANT", "0")
        assert pq.resolve_quantized_serving(None) is False

    @pytest.mark.parametrize("value", ["yes", "true", "2", " 1"])
    def test_invalid_env_is_loud_in_both_packages(self, monkeypatch, value):
        monkeypatch.setenv("PIO_SERVE_QUANT", value)
        with pytest.raises(ValueError, match="PIO_SERVE_QUANT"):
            pq.resolve_quantized_serving(None)
        with pytest.raises(ValueError, match="PIO_SERVE_QUANT"):
            jq.resolve_quantized_serving(None)

    def test_a_bad_env_fails_training(self, monkeypatch):
        from predictionio_tpu_torch.models.recommendation import (
            ALSAlgorithm,
            ALSAlgorithmParams,
        )

        monkeypatch.setenv("PIO_SERVE_QUANT", "on")
        with pytest.raises(ValueError, match="PIO_SERVE_QUANT"):
            ALSAlgorithm(ALSAlgorithmParams(rank=4), device=CPU).train(None, None)


# -- 4. the gate -------------------------------------------------------------
class TestExactnessGate:
    def test_exact_grid_gates_at_full_match(self):
        items = _exact_grid(60, 8, seed=5)
        users = np.random.default_rng(6).normal(size=(30, 8)).astype(np.float32)
        qtable, status = pq.quantize_serving_table(items, users, k=10, device=CPU)
        assert status["matchRate"] == 1.0
        assert status["dtype"] == "int8"
        assert status["tableBytes"] == qtable.table_bytes
        assert status["compression"] == round(qtable.compression_ratio, 2)
        _, jstatus = jq.quantize_serving_table(items, users, k=10)
        assert status == jstatus

    def test_quant_topk_ids_match_f32_end_to_end(self):
        from predictionio_tpu_torch.ops.scoring import top_k_for_users_fused

        items = _exact_grid(60, 8, seed=7)
        users = np.random.default_rng(8).normal(size=(20, 8)).astype(np.float32)
        qtable, _ = pq.quantize_serving_table(items, users, k=5, device=CPU)
        idx = torch.arange(20)
        _, ref_ids = top_k_for_users_fused(torch.from_numpy(users), torch.from_numpy(items),
                                           idx, k=5)
        _, got_ids = pq.top_k_quantized(users, qtable, idx, k=5)
        assert np.array_equal(np.sort(ref_ids.numpy(), axis=1), np.sort(got_ids.numpy(), axis=1))

    def test_top_k_quantized_matches_the_jax_package(self):
        """Scores to 1e-5 and ids equal on a gaussian table; k past the
        catalog pads with (-inf, -1) in both."""
        items, users = _gaussian(9, 30, 8), _gaussian(10, 12, 8)
        idx = np.array([0, 3, 3, 11, 5], dtype=np.int32)
        for k in (4, 40):
            s, i = pq.top_k_quantized(users, pq.quantize_table(items, device=CPU), idx, k)
            js, ji = jq.top_k_quantized(users, jq.quantize_table(items), idx, k)
            np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        assert np.all(i.numpy()[:, 30:] == -1) and np.all(np.isneginf(s.numpy()[:, 30:]))

    def test_near_tie_model_refused_loudly_and_counted(self):
        """The seed-5 gaussian table flips near-ties under int8: the JAX
        package's gate measures 0.921875 on it, and so does the port's;
        the strict default REFUSES, loud and counted, in both."""
        rng = np.random.default_rng(5)
        items = rng.normal(size=(100, 8)).astype(np.float32)
        users = rng.normal(size=(64, 8)).astype(np.float32)
        qtable = pq.quantize_table(items, device=CPU)
        probe = pq.default_probe_idx(64)
        rate = pq.topk_match_gate(users, items, qtable, probe, 10)
        assert rate == 0.921875
        assert rate == jq.topk_match_gate(users, items, jq.quantize_table(items), probe, 10)
        before = pq.gate_counts()
        with pytest.raises(pq.QuantGateError, match="REFUSED"):
            pq.quantize_serving_table(items, users, k=10, device=CPU)
        after = pq.gate_counts()
        assert after["refusals"] == before["refusals"] + 1
        assert after["runs"] == before["runs"] + 1
        # shuffled codes are the tamper detector's floor
        shuffled = pq.QuantizedTable(codes=qtable.codes.flip(0).clone(),
                                     scales=qtable.scales.flip(0).clone(), dtype="int8")
        assert pq.topk_match_gate(users, items, shuffled, probe, 10) < rate

    def test_tampered_codes_are_refused_even_at_a_lowered_floor(self):
        """A table whose codes no longer match the items (every row's sign
        flipped) scores the reverse ranking: refused at min_match 0.5."""
        rng = np.random.default_rng(12)
        items = rng.normal(size=(80, 8)).astype(np.float32)
        users = rng.normal(size=(32, 8)).astype(np.float32)
        honest = pq.quantize_table(items, device=CPU)
        tampered = pq.QuantizedTable(codes=(-honest.codes.to(torch.int16)).to(torch.int8),
                                     scales=honest.scales, dtype="int8")
        probe = pq.default_probe_idx(32)
        assert pq.topk_match_gate(users, items, honest, probe, 10) > 0.5
        assert pq.topk_match_gate(users, items, tampered, probe, 10) == 0.0

    def test_probe_idx_is_deterministic_and_bounded(self):
        idx = pq.default_probe_idx(1000)
        assert idx.size <= 64
        assert np.array_equal(idx, pq.default_probe_idx(1000))
        assert np.array_equal(idx, jq.default_probe_idx(1000))
        assert pq.default_probe_idx(3).size == 3
        assert pq.default_probe_idx(0).size == 0


class TestTrainedModelSweep:
    """The gate on a trained model: ``test_sharded_train``'s train-once
    recipe (the JAX single-device trainer), its tables carried over."""

    def _factors(self):
        import test_sharded_train

        uf, itf = test_sharded_train.sweep(0)
        return np.asarray(uf), np.asarray(itf)

    def test_trained_model_match_rate_measured_alike(self):
        uf, itf = self._factors()
        probe = pq.default_probe_idx(uf.shape[0])
        rate = pq.topk_match_gate(uf, itf, pq.quantize_table(itf, device=CPU), probe, 10)
        assert 0.75 <= rate <= 1.0
        assert rate == jq.topk_match_gate(uf, itf, jq.quantize_table(itf), probe, 10)

    def test_strict_default_refuses_and_explicit_floor_admits(self):
        uf, itf = self._factors()
        try:
            _, status = pq.quantize_serving_table(itf, uf, k=10, device=CPU)
            assert status["matchRate"] == 1.0
        except pq.QuantGateError:
            pass
        _, status = pq.quantize_serving_table(itf, uf, k=10, min_match=0.75, device=CPU)
        assert status["matchRate"] >= 0.75
        _, jstatus = jq.quantize_serving_table(itf, uf, k=10, min_match=0.75)
        assert status == jstatus

    def test_end_to_end_quantized_serving_via_model(self):
        import test_sharded_train
        from predictionio_tpu_torch.models.recommendation import (
            ALSAlgorithm,
            ALSAlgorithmParams,
            Query,
            als_model_from_numpy,
        )

        uf, itf = self._factors()
        rank = test_sharded_train._CFG.rank
        model = als_model_from_numpy(rank, uf, itf, [f"u{i}" for i in range(uf.shape[0])],
                                     [f"i{i}" for i in range(itf.shape[0])])
        queries = [(0, Query(user="u0", num=5)), (1, Query(user="u3", num=5))]
        quant_algo = ALSAlgorithm(ALSAlgorithmParams(
            rank=rank, quantized_serving=True, quant_gate_min_match=0.5), device=CPU)
        quant_out = dict(quant_algo.batch_predict(model, queries))
        assert quant_algo.topk_path == "quant"
        assert quant_algo.quant_status["dtype"] == "int8"
        assert quant_algo.quant_status["minMatch"] == 0.5
        f32_algo = ALSAlgorithm(ALSAlgorithmParams(rank=rank, quantized_serving=False),
                                device=CPU)
        f32_out = dict(f32_algo.batch_predict(model, queries))
        assert f32_algo.topk_path != "quant" and f32_algo.quant_status is None
        for i in quant_out:
            assert len(quant_out[i].item_scores) == 5 == len(f32_out[i].item_scores)
        # the answers are top_k_quantized's on the same codes, ids for ids
        want = pq.top_k_quantized(uf, pq.quantize_table(itf, device=CPU),
                                  np.array([0, 3]), 5)[1].numpy()
        for row, i in enumerate(quant_out):
            assert [s.item for s in quant_out[i].item_scores] == [f"i{j}" for j in want[row]]

    def test_the_gate_runs_once_a_model_and_again_after_a_new_one(self):
        from predictionio_tpu_torch.models.recommendation import (
            ALSAlgorithm,
            ALSAlgorithmParams,
            Query,
            als_model_from_numpy,
        )

        uf, itf = self._factors()
        ids = ([f"u{i}" for i in range(uf.shape[0])], [f"i{i}" for i in range(itf.shape[0])])
        model = als_model_from_numpy(uf.shape[1], uf, itf, *ids)
        algo = ALSAlgorithm(ALSAlgorithmParams(rank=uf.shape[1], quantized_serving=True,
                                               quant_gate_min_match=0.0), device=CPU)
        runs0 = pq.gate_counts()["runs"]
        for _ in range(3):
            algo.predict(model, Query(user="u1", num=3))
        assert pq.gate_counts()["runs"] == runs0 + 1
        other = als_model_from_numpy(uf.shape[1], uf, itf, *ids)
        algo.predict(other, Query(user="u1", num=3))
        assert pq.gate_counts()["runs"] == runs0 + 2


# -- 5. the query server -----------------------------------------------------
def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        ctype = resp.getheader("Content-Type", "")
        return resp.status, (json.loads(data) if ctype.startswith("application/json")
                             else data.decode())
    finally:
        conn.close()


def _serve(tmp_path, params, model):
    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.models.recommendation import engine_factory
    from predictionio_tpu_torch.storage import StorageRegistry
    from predictionio_tpu_torch.workflow import (
        ServerConfig,
        create_query_server,
        persist_instance,
    )

    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    persist_instance(registry, EngineParams(algorithm_params_list=[("als", params)]), [model])
    return create_query_server(engine_factory(), ServerConfig(
        ip="127.0.0.1", port=0, device=CPU), registry=registry, block=False)


class TestQueryServer:
    def _model(self, seed):
        from predictionio_tpu_torch.models.recommendation import als_model_from_numpy

        rng = np.random.default_rng(seed)
        items = rng.normal(size=(100, 8)).astype(np.float32)
        users = rng.normal(size=(64, 8)).astype(np.float32)
        return als_model_from_numpy(8, users, items, [f"u{i}" for i in range(64)],
                                    [f"i{i}" for i in range(100)])

    def test_status_and_metrics_of_a_quantized_server(self, tmp_path):
        from predictionio_tpu_torch.models.recommendation import ALSAlgorithmParams

        server = _serve(tmp_path, ALSAlgorithmParams(
            rank=8, quantized_serving=True, quant_gate_min_match=0.5), self._model(5))
        try:
            port = server.bound_port
            status, data = _request(port, "POST", "/queries.json", {"user": "u3", "num": 4})
            assert status == 200 and len(data["itemScores"]) == 4
            _, doc = _request(port, "GET", "/status.json")
            assert doc["topkPath"] == {"0:ALSAlgorithm": "quant"}
            quant = doc["quantServing"]["0:ALSAlgorithm"]
            assert quant["dtype"] == "int8" and quant["matchRate"] == 0.9219
            assert quant["minMatch"] == 0.5 and quant["probes"] == 64 and quant["k"] == 10
            assert quant["tableBytes"] == pq.estimate_table_bytes(100, 8, "int8")
            assert doc["quantGate"] == pq.gate_counts()
            _, text = _request(port, "GET", "/metrics")
            counts = pq.gate_counts()
            assert f"pio_quant_gate_runs_total {float(counts['runs'])}" in text \
                or f"pio_quant_gate_runs_total {counts['runs']}" in text
            assert "pio_quant_gate_refusals_total" in text
        finally:
            server.shutdown()
            server.server_close()

    def test_a_refused_table_answers_with_the_refusal(self, tmp_path):
        from predictionio_tpu_torch.models.recommendation import ALSAlgorithmParams

        server = _serve(tmp_path, ALSAlgorithmParams(rank=8, quantized_serving=True),
                        self._model(5))
        try:
            port = server.bound_port
            refusals = pq.gate_counts()["refusals"]
            status, data = _request(port, "POST", "/queries.json", {"user": "u3", "num": 4})
            assert status == 500 and "quantized serving REFUSED" in data["message"]
            assert pq.gate_counts()["refusals"] > refusals
            _, doc = _request(port, "GET", "/status.json")
            assert "quantServing" not in doc  # nothing was admitted
        finally:
            server.shutdown()
            server.server_close()

    def test_a_server_with_the_lever_off_shows_no_quant_block(self, tmp_path):
        from predictionio_tpu_torch.models.recommendation import ALSAlgorithmParams

        server = _serve(tmp_path, ALSAlgorithmParams(rank=8), self._model(6))
        try:
            port = server.bound_port
            assert _request(port, "POST", "/queries.json", {"user": "u3", "num": 4})[0] == 200
            _, doc = _request(port, "GET", "/status.json")
            assert "quantServing" not in doc and "quantGate" not in doc
            assert doc["topkPath"] == {"0:ALSAlgorithm": "dense"}
            assert "pio_quant_gate_runs_total" in _request(port, "GET", "/metrics")[1]
        finally:
            server.shutdown()
            server.server_close()


class TestTrainAndDeploy:
    """``quantized_serving: true`` through the workflow: ``run_train``
    gates at train time (a refusal fails the run, as in the JAX package),
    and the stored instance deploys and serves its quantized table."""

    def _engine(self):
        from predictionio_tpu_torch.controller import DataSource, Engine, FirstServing
        from predictionio_tpu_torch.models.recommendation import (
            ALSAlgorithm,
            RecPreparator,
            TrainingData,
        )
        from predictionio_tpu_torch.storage import BiMap

        rng = np.random.default_rng(21)
        users = rng.integers(0, 80, 3000).astype(np.int32)
        items = rng.integers(0, 60, 3000).astype(np.int32)
        ratings = rng.integers(1, 6, 3000).astype(np.float32)
        data = TrainingData(users=users, items=items, ratings=ratings,
                            user_map=BiMap({f"u{i}": i for i in range(80)}),
                            item_map=BiMap({f"i{i}": i for i in range(60)}))

        class Arrays(DataSource):
            def read_training(self, ctx):
                return data

        return Engine({"": Arrays}, {"": RecPreparator}, {"als": ALSAlgorithm},
                      {"": FirstServing})

    def _params(self, **kw):
        from predictionio_tpu_torch.models.recommendation import ALSAlgorithmParams

        return ALSAlgorithmParams(rank=6, num_iterations=3, lambda_=0.05,
                                  quantized_serving=True, **kw)

    def test_run_train_then_deploy_serves_the_quantized_table(self, tmp_path):
        from predictionio_tpu_torch.controller import EngineParams
        from predictionio_tpu_torch.models.recommendation import engine_factory
        from predictionio_tpu_torch.storage import StorageRegistry
        from predictionio_tpu_torch.workflow import (
            ServerConfig,
            WorkflowContext,
            create_query_server,
            run_train,
        )

        registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
        ep = EngineParams(algorithm_params_list=[("als", self._params(
            quant_gate_min_match=0.0))])
        runs = pq.gate_counts()["runs"]
        run_train(self._engine(), ep, registry, ctx=WorkflowContext(device=CPU))
        assert pq.gate_counts()["runs"] == runs + 1  # the gate ran at train
        server = create_query_server(engine_factory(), ServerConfig(
            ip="127.0.0.1", port=0, device=CPU), registry=registry, block=False)
        try:
            status, data = _request(server.bound_port, "POST", "/queries.json",
                                    {"user": "u4", "num": 5})
            assert status == 200 and len(data["itemScores"]) == 5
            _, doc = _request(server.bound_port, "GET", "/status.json")
            assert doc["topkPath"] == {"0:ALSAlgorithm": "quant"}
            assert doc["quantServing"]["0:ALSAlgorithm"]["minMatch"] == 0.0
        finally:
            server.shutdown()
            server.server_close()

    def test_a_refusing_gate_fails_the_training_run(self, tmp_path):
        from predictionio_tpu_torch.controller import EngineParams
        from predictionio_tpu_torch.storage import StorageRegistry
        from predictionio_tpu_torch.workflow import WorkflowContext, run_train

        registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
        ep = EngineParams(algorithm_params_list=[("als", self._params(
            quant_gate_min_match=1.01))])
        refusals = pq.gate_counts()["refusals"]
        with pytest.raises(pq.QuantGateError, match="REFUSED"):
            run_train(self._engine(), ep, registry, ctx=WorkflowContext(device=CPU))
        assert pq.gate_counts()["refusals"] == refusals + 1


def test_the_port_quant_modules_import_no_jax_and_no_ml_dtypes():
    import ast
    import pathlib

    root = pathlib.Path(ptable.__file__).resolve().parent.parent
    for rel in ("quant/table.py", "quant/__init__.py", "continuous/foldin.py",
                "continuous/__init__.py", "continuous/watcher.py",
                "continuous/controller.py"):
        for node in ast.walk(ast.parse((root / rel).read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            roots = {n.split(".")[0] for n in names}
            assert not roots & {"jax", "jaxlib", "ml_dtypes", "predictionio_tpu"}, (rel, names)
