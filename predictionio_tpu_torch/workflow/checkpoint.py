"""Step-level checkpoint and resume for single-device training runs.

Copy of ``predictionio_tpu/workflow/checkpoint.py``, with the same
on-disk format, so a checkpoint the JAX package wrote loads here: one
directory per step (``step_<n>/``) holding an ``arrays.npz`` with
'/'-joined tree paths as keys, a ``meta.json`` with the caller's
metadata, and a ``_COMPLETE`` marker written last, after the data files
were written atomically and fsynced. A step without the marker (a crash
mid-save) is ignored, and swept on the next save. A tree is nested
dicts, lists and tuples of numpy arrays; tensors are copied to the host
by the caller.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils.durability import atomic_write_bytes, fsync_dir

_STEP_RE = re.compile(r"^step_(\d+)$")
_SEP = "/"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Tree (nested dict/list/tuple of arrays) → {path: array}."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            key = str(k)
            if _SEP in key:
                raise ValueError(f"checkpoint dict keys may not contain '/': {key!r}")
            out.update(_flatten(v, f"{prefix}{key}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}"))
    else:
        out[prefix.rstrip(_SEP)] = np.asarray(tree)
    return out


def _unflatten_into(like: Any, flat: Dict[str, np.ndarray], prefix: str = "") -> Any:
    """Rebuild ``like``'s structure with arrays from ``flat``."""
    if isinstance(like, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}{_SEP}") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        items = [_unflatten_into(v, flat, f"{prefix}{i}{_SEP}") for i, v in enumerate(like)]
        return tuple(items) if isinstance(like, tuple) else items
    key = prefix.rstrip(_SEP)
    if key not in flat:
        raise KeyError(f"checkpoint missing array {key!r}")
    return flat[key]


class CheckpointManager:
    """Save, restore and prune step checkpoints under one run directory.

    ``keep_last=N`` (or its older name ``keep``) prunes all but the newest
    N complete steps after each save; ``None`` keeps everything."""

    def __init__(self, directory: str, keep: Optional[int] = None,
                 keep_last: Optional[int] = None):
        self.directory = directory
        self.keep = keep_last if keep_last is not None else keep
        os.makedirs(directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name, "_COMPLETE")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None) -> None:
        d = self._step_dir(step)
        if os.path.exists(d):
            shutil.rmtree(d)  # replace an incomplete or older attempt
        os.makedirs(d)
        buf = io.BytesIO()
        np.savez(buf, **_flatten(tree))
        # every data file commits atomically BEFORE the marker, or a power
        # loss can leave a durable marker pointing at garbage
        atomic_write_bytes(os.path.join(d, "arrays.npz"), buf.getvalue())
        atomic_write_bytes(os.path.join(d, "meta.json"),
                           json.dumps(metadata or {}).encode("utf-8"))
        with open(os.path.join(d, "_COMPLETE"), "w") as f:
            f.write("ok")
            f.flush()
            os.fsync(f.fileno())
        fsync_dir(d)
        fsync_dir(self.directory)  # the step_N entry lives in the parent
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        doomed = steps[: max(0, len(steps) - self.keep)] if self.keep is not None else []
        for s in doomed:
            # drop the marker first (durably), so a crash mid-rmtree leaves
            # an incomplete directory, never one that looks complete
            d = self._step_dir(s)
            try:
                os.remove(os.path.join(d, "_COMPLETE"))
            except OSError:
                pass
            fsync_dir(d)
            shutil.rmtree(d, ignore_errors=True)
        # sweep incomplete directories (crashed saves)
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if (m and int(m.group(1)) not in steps
                    and not os.path.exists(os.path.join(self.directory, name, "_COMPLETE"))):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    def restore(self, step: Optional[int] = None, like: Any = None) -> Tuple[int, Any, dict]:
        """(step, tree, metadata). ``like`` gives the structure to rebuild
        (its leaves are placeholders); without it a flat {path: array}
        dict is returned."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        if not os.path.exists(os.path.join(d, "_COMPLETE")):
            raise FileNotFoundError(f"checkpoint step {step} is incomplete")
        with np.load(os.path.join(d, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        with open(os.path.join(d, "meta.json")) as f:
            metadata = json.load(f)
        tree = _unflatten_into(like, flat) if like is not None else flat
        return step, tree, metadata
