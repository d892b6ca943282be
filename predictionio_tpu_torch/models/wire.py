"""Shared wire-shape helpers for template results (copy of
``predictionio_tpu/models/wire.py``).

Every recommender-style template serves the reference's camelCase
``itemScores`` JSON (``{"itemScores": [{"item": ..., "score": ...}]}``);
each template keeps its own ``ItemScore``/``PredictedResult`` types (the
reference's per-template Engine.scala isolation) but renders through this
one function so the wire shape cannot drift between templates.
"""

from __future__ import annotations

from typing import Iterable


def item_scores_json(scores: Iterable) -> dict:
    return {
        "itemScores": [
            {"item": s.item, "score": s.score} for s in scores
        ]
    }
