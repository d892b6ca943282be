"""Sharded serving in the port against the JAX package.

- ``ALSAlgorithm.shard_model`` cuts the same partitions as the JAX
  package's for shard counts 1-5: item row ``i`` on shard ``i % count``,
  the user table whole, the item map rebuilt over the kept rows;
- ``fleet/merge.py``'s ``merge_item_scores``, ``merge_predictions`` and
  ``merged_matches_reference`` equal the JAX package's on seeded inputs,
  ties included;
- four port shard servers (``shard_count`` 4, ``device="cpu"``) answer a
  seeded burst whose merged answers equal the unsharded port server's
  and the JAX server's but for ties;
- an algorithm without ``shard_model`` fails the deploy.
"""

from __future__ import annotations

import numpy as np
import pytest

import predictionio_tpu.fleet.merge as jax_merge
import predictionio_tpu.workflow.serving as jax_serving
import predictionio_tpu_torch.fleet.merge as port_merge
import predictionio_tpu_torch.workflow.serving as port_serving
from predictionio_tpu.models.recommendation import ALSAlgorithm as JaxALS
from predictionio_tpu_torch.controller import Engine, FirstServing
from predictionio_tpu_torch.models.recommendation import (
    ALSAlgorithm,
    RecDataSource,
    RecPreparator,
)
from predictionio_tpu_torch.storage import StorageRegistry
from predictionio_tpu_torch.workflow import QueryServer, ServerConfig

from torch_plane import (
    N_ITEMS,
    N_USERS,
    jax_model,
    jax_server,
    port_model,
    port_server,
    request,
)

SEED = 17


@pytest.mark.parametrize("count", [1, 2, 3, 4, 5])
def test_shard_model_cuts_the_jax_packages_partitions(count):
    jm, pm = jax_model(SEED), port_model(SEED)
    seen = set()
    for index in range(count):
        want = JaxALS().shard_model(jm, index, count)
        got = ALSAlgorithm(device="cpu").shard_model(pm, index, count)
        np.testing.assert_array_equal(got.item_factors, want.item_factors)
        np.testing.assert_array_equal(got.user_factors, want.user_factors)
        assert got.user_factors is pm.user_factors  # users stay whole
        assert got.item_map.to_dict() == want.item_map.to_dict()
        assert got.user_map.to_dict() == want.user_map.to_dict()
        assert got.rank == want.rank and got.item_factors.flags["C_CONTIGUOUS"]
        assert all(int(item[1:]) % count == index for item in got.item_map.to_dict())
        seen |= set(got.item_map.to_dict())
    assert len(seen) == N_ITEMS


def _seeded_shard_lists(seed: int, shards: int, ties: bool):
    rng = np.random.default_rng(seed)
    lists = []
    for s in range(shards):
        n = int(rng.integers(0, 12))
        scores = rng.normal(size=n)
        if ties:
            scores = np.round(scores, 1)  # many equal scores across shards
        lists.append([{"item": f"i{int(rng.integers(0, 500))}-{s}", "score": float(x)}
                      for x in scores])
    return lists


@pytest.mark.parametrize("seed", range(6))
def test_merges_equal_the_jax_packages(seed):
    for ties in (False, True):
        lists = _seeded_shard_lists(seed, shards=4, ties=ties)
        for k in (None, 1, 5, 100):
            got = port_merge.merge_item_scores(lists, k)
            assert got == jax_merge.merge_item_scores(lists, k)
            keys = [(-e["score"], e["item"]) for e in got]
            assert keys == sorted(keys)  # score down, then item id up
        bodies = [{"itemScores": entries} for entries in lists] + [None]
        assert port_merge.merge_predictions(bodies, 7) == jax_merge.merge_predictions(bodies, 7)
        merged = port_merge.merge_predictions(bodies)
        flipped = {"itemScores": list(reversed(merged["itemScores"]))}
        nudged = {"itemScores": [dict(e, score=e["score"] + 1e-7) for e in merged["itemScores"]]}
        other = {"itemScores": merged["itemScores"][:-1] + [{"item": "zz", "score": 0.0}]}
        for a, b in ((merged, merged), (merged, flipped), (merged, nudged), (merged, other),
                     (merged, {"itemScores": []}), ({"x": 1}, {"x": 1})):
            assert (port_merge.merged_matches_reference(a, b)
                    == jax_merge.merged_matches_reference(a, b))
    assert port_merge.merge_predictions([]) is jax_merge.merge_predictions([]) is None
    for mod in (port_merge, jax_merge):
        assert mod.merge_predictions([{"a": 1}, {"a": 1}]) == {"a": 1}
        with pytest.raises(ValueError, match="disagree"):
            mod.merge_predictions([{"a": 1}, {"a": 2}])


def test_four_shard_servers_merge_to_the_unsharded_answer(tmp_path):
    rng = np.random.default_rng(SEED)
    bodies = [{"user": f"u{u}", "num": int(n)}
              for u, n in zip(rng.integers(0, N_USERS, 12), rng.integers(1, 30, 12))]
    bodies.append({"user": "u5", "num": N_ITEMS})  # the whole catalog
    with port_server(tmp_path / "whole", port_model(SEED)) as whole, \
            jax_server(tmp_path / "jax", jax_model(SEED)) as jax_whole:
        want = [request(whole.bound_port, "POST", "/queries.json", b)[1] for b in bodies]
        jax_want = [request(jax_whole.bound_port, "POST", "/queries.json", b)[1]
                    for b in bodies]
    shards = [port_server(tmp_path / f"s{i}", port_model(SEED), shard_index=i, shard_count=4)
              for i in range(4)]
    servers = [ctx.__enter__() for ctx in shards]
    try:
        for i, server in enumerate(servers):
            shard = request(server.bound_port, "GET", "/shard.json")[1]
            assert shard["sharded"] and (shard["shardIndex"], shard["shardCount"]) == (i, 4)
            assert shard["models"][0]["items"] == len(range(i, N_ITEMS, 4))
        for body, answer, jax_answer in zip(bodies, want, jax_want):
            parts = [request(s.bound_port, "POST", "/queries.json", body)[1] for s in servers]
            assert all(len(p["itemScores"]) <= body["num"] for p in parts)
            merged = port_merge.merge_predictions(parts, k=body["num"])
            assert port_merge.merged_matches_reference(merged, answer)
            assert port_merge.merged_matches_reference(merged, jax_answer)
            assert jax_merge.merged_matches_reference(merged, jax_answer)
        status = request(servers[2].bound_port, "GET", "/status.json")[1]
        assert status["shard"] == {"index": 2, "count": 4}
        assert status["topkPath"] == {"0:ALSAlgorithm": "dense"}  # CPU tensors
    finally:
        for ctx in shards:
            ctx.__exit__(None, None, None)


class _NoShardALS(ALSAlgorithm):
    shard_model = None


def test_an_algorithm_without_shard_model_fails_the_deploy(tmp_path):
    class NoShard:
        pass

    for mod in (port_serving, jax_serving):
        with pytest.raises(ValueError, match="NoShard does not implement shard_model"):
            mod._shard_models([NoShard()], [object()], mod.ServerConfig(shard_count=2))
        with pytest.raises(ValueError, match="shard_index 5 out of range for shard_count 2"):
            mod._shard_models([], [], mod.ServerConfig(shard_index=5, shard_count=2))
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path / "store")})
    with port_server(tmp_path, port_model(SEED), registry=registry):
        pass  # stores the instance
    engine = Engine({"": RecDataSource}, {"": RecPreparator}, {"als": _NoShardALS},
                    {"": FirstServing})
    with pytest.raises(ValueError, match="cannot serve in sharded mode"):
        QueryServer(ServerConfig(ip="127.0.0.1", port=0, device="cpu", shard_count=2),
                    engine, registry)
    # unsharded, the same engine deploys
    server = QueryServer(ServerConfig(ip="127.0.0.1", port=0, device="cpu"), engine, registry)
    server.server_close()
