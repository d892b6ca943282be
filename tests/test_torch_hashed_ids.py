"""The hashed big-id path of the port (``storage/bimap.py::HashedIdMap``
and ``stream_ratings(hashed_users=...)``) held to the JAX package's
(``tests/test_infeed.py``'s hashed cases): the same slot for the same id
and salt, the batch hash equal to FNV-1a written out in Python, and the
same rating arrays as the exact map with the users' indices replaced by
their slots.
"""

import datetime as dt

import numpy as np
import pytest

from predictionio_tpu.storage.bimap import HashedIdMap as JaxHashedIdMap
from predictionio_tpu.storage.sqlite_events import SqliteEventStore as JaxSqliteEventStore
from predictionio_tpu.storage import Event as JaxEvent
from predictionio_tpu.workflow.infeed import stream_ratings as jax_stream_ratings
from predictionio_tpu_torch.storage import Event, SqliteEventStore
from predictionio_tpu_torch.storage import bimap as bm
from predictionio_tpu_torch.storage.bimap import HashedIdMap
from predictionio_tpu_torch.workflow import stream_ratings

T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
KEYS = [f"user_{j}" for j in range(1000)] + ["", "a", "ü–🎉", "x" * 300]


def test_hashed_id_map_basics():
    m = HashedIdMap(1 << 16)
    idx = m.map_array(KEYS)
    assert idx.dtype == np.int32
    assert ((idx >= 0) & (idx < (1 << 16))).all()
    assert np.array_equal(idx, m.map_array(KEYS))  # deterministic
    assert not np.array_equal(idx, HashedIdMap(1 << 16, salt=7).map_array(KEYS))
    assert m["user_3"] == idx[3] == m.get("user_3") and "anything" in m
    assert len(m) == 1 << 16 and m.map_array([]).shape == (0,)
    with pytest.raises(ValueError, match="power of two"):
        HashedIdMap(1000)
    with pytest.raises(TypeError, match="inverted"):
        m.inverse
    # 1000 ids in 65,536 slots: 1 - e^-0.0153, about 1.5 %
    assert 0.01 < m.expected_collision_fraction(1000) < 0.02
    with pytest.raises(ValueError, match="2\\^31"):
        HashedIdMap(1 << 32)


@pytest.mark.parametrize("capacity,salt", [(1 << 4, 0), (1 << 16, 0), (1 << 16, 7),
                                           (1 << 31, 12345678901234)])
def test_slots_equal_the_jax_maps(capacity, salt):
    got = HashedIdMap(capacity, salt=salt).map_array(KEYS)
    want = JaxHashedIdMap(capacity, salt=salt).map_array(KEYS)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_the_batch_hash_is_fnv1a_with_the_salt():
    mask = (1 << 64) - 1
    for salt in (0, 5):
        native = bm._fnv1a64_batch(KEYS[-4:], salt)
        for j, k in enumerate(KEYS[-4:]):
            h = 14695981039346656037 ^ salt
            for b in k.encode("utf-8"):
                h = ((h ^ b) * 1099511628211) & mask
            assert native[j] == (h if h else 1)


def _rates(cls, n=30):
    return [cls(event="rate", entity_type="user", entity_id=f"u{j % 7}",
                target_entity_type="item", target_entity_id=f"i{j % 5}",
                properties={"rating": float(j % 5 + 1)},
                event_time=T0 + dt.timedelta(minutes=j)) for j in range(n)]


def test_stream_ratings_hashed_users_matches_the_jax_package():
    store = SqliteEventStore(":memory:")
    store.init(1)
    store.write(_rates(Event), 1)
    jax_store = JaxSqliteEventStore(":memory:")
    jax_store.init(1)
    jax_store.write(_rates(JaxEvent), 1)
    exact = stream_ratings(store, 1, {"rate": "rating"})
    hashed = stream_ratings(store, 1, {"rate": "rating"}, hashed_users=1 << 12, chunk_rows=8)
    want = jax_stream_ratings(jax_store, 1, {"rate": "rating"}, hashed_users=1 << 12)
    assert isinstance(hashed.user_map, HashedIdMap) and hashed.user_map.capacity == 1 << 12
    # same interactions, same item indexing, user indices are the hashes
    assert np.array_equal(hashed.items, exact.items)
    assert np.array_equal(hashed.ratings, exact.ratings)
    u_inv = exact.user_map.inverse
    assert np.array_equal(hashed.users,
                          hashed.user_map.map_array([u_inv[int(u)] for u in exact.users]))
    for name in ("users", "items", "ratings"):
        np.testing.assert_array_equal(getattr(hashed, name), getattr(want, name))
    assert hashed.item_map.to_dict() == want.item_map.to_dict()
