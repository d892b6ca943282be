"""Engine template gallery: scaffold a bundled template into a project dir.

Trimmed copy of ``predictionio_tpu/tools/templates.py`` (a rebuild of
``tools/.../console/Template.scala:56-375``): ``pio template get <name>
<dir>`` writes a ready-to-run engine project (``engine.json`` +
``engine.py``, and the recommendation template's ``evaluation.py``)
whose ``engine.py`` imports the port's own
:mod:`predictionio_tpu_torch.models` engine. The templates whose models
are not ported yet (classification, similar products, e-commerce) stay in
the listing and refuse ``get`` with the ROADMAP item that ports them.
There is no remote gallery.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List


class TemplateNotPorted(NotImplementedError):
    """The template's model is not ported to the PyTorch package yet."""


def _engine_py(factory_import: str, blurb: str) -> str:
    return f'''"""Engine template: {blurb}

Customize by subclassing/replacing any DASE component and re-pointing
``engineFactory`` in engine.json at your own factory.
"""

from {factory_import} import engine_factory  # noqa: F401
'''


_TEMPLATES: Dict[str, Dict[str, object]] = {
    "recommendation": {
        "blurb": "ALS collaborative filtering (rate/buy events → top-N items)",
        "factory": "predictionio_tpu_torch.models.recommendation",
        "variant": {
            "id": "default",
            "description": "Recommendation engine (ALS on CUDA)",
            "engineFactory": "engine:engine_factory",
            "datasource": {"params": {"app_id": 1}},
            "algorithms": [
                {
                    "name": "als",
                    "params": {
                        "rank": 10,
                        "num_iterations": 10,
                        "lambda_": 0.01,
                    },
                }
            ],
        },
        "evaluation": '''"""Evaluation: Precision@K over a rank x lambda grid.

Run with:  pio eval --evaluation-class evaluation:RecEvaluation \\
                    --engine-params-generator-class evaluation:RecParamsGenerator
(the reference movielens-evaluation example's shape).
"""

from predictionio_tpu_torch.models.recommendation import (  # noqa: F401
    PrecisionAtK,
    RecEvaluation,
    RecParamsGenerator,
)
''',
    },
    "classification": {
        "blurb": "Naive Bayes / random forest over entity properties",
        "not_ported": "ROADMAP.md, queue 1 item 14 (classification)",
    },
    "similarproduct": {
        "blurb": "Item similarity from ALS factors (view/like events)",
        "not_ported": "ROADMAP.md, queue 1 item 7 (the similar-items template)",
    },
    "sequencerec": {
        "blurb": "Transformer next-item prediction over interaction histories",
        "factory": "predictionio_tpu_torch.models.sequencerec",
        "variant": {
            "id": "default",
            "description": "Sequence-recommendation engine (transformer on CUDA)",
            "engineFactory": "engine:engine_factory",
            "datasource": {"params": {"app_id": 1}},
            "algorithms": [
                {
                    "name": "transformer",
                    "params": {
                        "d_model": 64,
                        "n_layers": 2,
                        "steps": 300,
                    },
                }
            ],
        },
    },
    "ecommerce": {
        "blurb": "E-commerce recommendation with live serving-time filters",
        "not_ported": "ROADMAP.md, queue 1 item 7 (the e-commerce template)",
    },
}


def list_templates() -> List[dict]:
    """``pio template list`` (``Template.scala:262-285``); a template
    that is not ported says so."""
    return [
        {"name": name, "description": spec["blurb"],
         **({"ported": False} if "not_ported" in spec else {})}
        for name, spec in sorted(_TEMPLATES.items())
    ]


def get_template(name: str, directory: str) -> dict:
    """``pio template get`` (``Template.scala:287-375``): write the
    scaffold. Raises ``KeyError`` for an unknown name and
    :class:`TemplateNotPorted` for a template whose model is not ported."""
    if name not in _TEMPLATES:
        raise KeyError(
            f"Unknown template {name!r}; available: {sorted(_TEMPLATES)}"
        )
    spec = _TEMPLATES[name]
    if "not_ported" in spec:
        raise TemplateNotPorted(
            f"template {name!r} is not ported to the PyTorch package yet "
            f"({spec['not_ported']})"
        )
    directory = os.path.abspath(directory)
    if os.path.exists(directory) and os.listdir(directory):
        raise ValueError(f"Target directory {directory} is not empty")
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "engine.json"), "w", encoding="utf-8") as fh:
        json.dump(spec["variant"], fh, indent=2)
        fh.write("\n")
    with open(os.path.join(directory, "engine.py"), "w", encoding="utf-8") as fh:
        fh.write(_engine_py(str(spec["factory"]), str(spec["blurb"])))
    if "evaluation" in spec:
        with open(os.path.join(directory, "evaluation.py"), "w", encoding="utf-8") as fh:
            fh.write(str(spec["evaluation"]))
    return {"template": name, "directory": directory}
