"""On-disk checkpoint store: atomic per-file writes, manifest-last commit.

Copy of ``predictionio_tpu/ckpt/store.py`` (jax-free there), with the
same on-disk format. The commit protocol has exactly one durable
transition per checkpoint:

    step_00000007/x.npy.tmp      write + fsync
    step_00000007/x.npy          os.replace (atomic_write_bytes)
    step_00000007/y.npy          ... every array file the same way ...
    step_00000007/manifest.json  LAST — atomic_write_bytes again

A step directory without a parseable ``manifest.json`` is not a
checkpoint: it is garbage left by a crash, invisible to
:meth:`CheckpointStore.steps` and so to resume. A crash at any point of
the sequence leaves either no manifest (the step never existed) or a
complete manifest whose every file was already fsynced under its final
name.

Integrity is per file: the manifest records a SHA-256 for every array
file, verified on load. A mismatch is a loud skip: the corrupt step is
logged at ERROR, counted in :attr:`CheckpointStore.corrupt_skipped`, and
resume falls back to the previous valid step. A checkpoint whose
recorded config identity disagrees with the resuming run's is a loud
refusal (:class:`CheckpointMismatch`): training on foreign factors
diverges without a trace.

Retention: the ``keep_last`` newest committed steps always survive;
``keep_every`` > 0 also pins every step divisible by it. Deletion removes
the manifest FIRST and fsyncs, so a crash mid-GC demotes the step to
garbage instead of leaving a manifest pointing at missing files.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import logging
import os
import re
import shutil
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..utils.durability import atomic_write_bytes, fsync_dir

logger = logging.getLogger("pio.ckpt")

MANIFEST = "manifest.json"
SCHEMA_VERSION = 1
_STEP_RE = re.compile(r"^step_(\d{8})$")


class CheckpointError(Exception):
    """Base class for checkpoint failures."""


class CheckpointCorrupt(CheckpointError):
    """A committed step failed integrity verification (bad manifest,
    missing file, checksum mismatch). Resume SKIPS it — loudly,
    counted — and falls back to the previous valid step."""


class CheckpointMismatch(CheckpointError):
    """The checkpoint's recorded config identity disagrees with the
    resuming run. This never degrades to a skip: resuming different
    math on old factors is silent divergence, so it refuses."""


def sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _step_dirname(step: int) -> str:
    return f"step_{step:08d}"


def _npy_bytes(array: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(array))
    return buf.getvalue()


@dataclasses.dataclass
class LoadedCheckpoint:
    """One verified checkpoint: arrays by name, the manifest's ``meta``
    dict (config identity + ``iteration``), and the committed step."""

    step: int
    arrays: Dict[str, np.ndarray]
    meta: dict


class CheckpointStore:
    """Directory of committed checkpoints under ``root``.

    One writer at a time (the background :class:`~.writer.CheckpointWriter`
    thread); any number of readers. ``keep_last``/``keep_every`` set the
    GC policy applied after every save (and by ``pio ckpt gc``).
    """

    def __init__(
        self,
        root: str,
        keep_last: int = 3,
        keep_every: int = 0,
    ) -> None:
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        if keep_every < 0:
            raise ValueError(f"keep_every must be >= 0, got {keep_every}")
        self.root = root
        self.keep_last = keep_last
        self.keep_every = keep_every
        #: corrupt steps skipped by :meth:`load` over this store's
        #: lifetime
        self.corrupt_skipped = 0

    # -- listing ----------------------------------------------------------

    def steps(self) -> List[int]:
        """Committed steps (manifest present), ascending. Step dirs
        without a manifest are crash garbage and not listed."""
        if not os.path.isdir(self.root):
            return []
        out = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if m and os.path.isfile(
                os.path.join(self.root, name, MANIFEST)
            ):
                out.append(int(m.group(1)))
        return sorted(out)

    def uncommitted(self) -> List[str]:
        """Step dirs with NO manifest: crash leftovers, never loadable."""
        if not os.path.isdir(self.root):
            return []
        return sorted(
            name for name in os.listdir(self.root)
            if _STEP_RE.match(name)
            and not os.path.isfile(os.path.join(self.root, name, MANIFEST))
        )

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, _step_dirname(step))

    # -- save ------------------------------------------------------------

    def save(self, step: int, arrays: Dict[str, np.ndarray], meta: dict) -> str:
        """Commit one checkpoint: every array file atomically
        (tmp + fsync + rename, per-file SHA-256), manifest LAST. Returns
        the step directory. Runs GC after the commit."""
        if step < 0:
            raise ValueError(f"checkpoint step must be >= 0, got {step}")
        d = self.step_dir(step)
        if os.path.isdir(d):
            # a half-written twin from a crashed predecessor (same step,
            # no manifest) — or a re-save of a committed step: both
            # restart from an empty directory so stale files can never
            # shadow the new manifest's contents
            shutil.rmtree(d)
        os.makedirs(d, exist_ok=True)
        files = self._save_files(d, arrays)
        self._commit_manifest(d, step, files, meta)
        self.gc()
        return d

    def _save_files(
        self, d: str, arrays: Dict[str, np.ndarray]
    ) -> Dict[str, dict]:
        files: Dict[str, dict] = {}
        for name, array in arrays.items():
            data = _npy_bytes(array)
            fname = f"{name}.npy"
            atomic_write_bytes(os.path.join(d, fname), data)
            files[fname] = {
                "sha256": sha256_bytes(data),
                "bytes": len(data),
            }
        return files

    def _commit_manifest(
        self, d: str, step: int, files: Dict[str, dict], meta: dict
    ) -> None:
        manifest = {
            "schema": SCHEMA_VERSION,
            "step": int(step),
            "files": files,
            "meta": dict(meta),
        }
        atomic_write_bytes(
            os.path.join(d, MANIFEST),
            json.dumps(manifest, indent=2, sort_keys=True).encode("utf-8"),
        )
        # the rename inside atomic_write_bytes fsyncs the step dir; the
        # root must be durable too or the whole step dir can vanish
        fsync_dir(self.root)

    # -- load / verify ----------------------------------------------------

    def read_manifest(self, step: int) -> dict:
        path = os.path.join(self.step_dir(step), MANIFEST)
        try:
            with open(path, "rb") as fh:
                manifest = json.loads(fh.read().decode("utf-8"))
        except (OSError, ValueError) as exc:
            raise CheckpointCorrupt(
                f"step {step}: unreadable manifest ({exc})"
            ) from exc
        if not isinstance(manifest, dict) or "files" not in manifest:
            raise CheckpointCorrupt(
                f"step {step}: manifest is not a checkpoint manifest"
            )
        if manifest.get("schema") != SCHEMA_VERSION:
            raise CheckpointCorrupt(
                f"step {step}: manifest schema "
                f"{manifest.get('schema')!r} != {SCHEMA_VERSION}"
            )
        return manifest

    def verify_step(self, step: int) -> dict:
        """Re-hash every file against the manifest. Returns the manifest;
        raises :class:`CheckpointCorrupt` on the first mismatch."""
        manifest = self.read_manifest(step)
        d = self.step_dir(step)
        for fname, rec in manifest["files"].items():
            path = os.path.join(d, fname)
            try:
                with open(path, "rb") as fh:
                    data = fh.read()
            except OSError as exc:
                raise CheckpointCorrupt(
                    f"step {step}: missing file {fname} ({exc})"
                ) from exc
            digest = sha256_bytes(data)
            if digest != rec.get("sha256"):
                raise CheckpointCorrupt(
                    f"step {step}: checksum mismatch on {fname} "
                    f"(manifest {rec.get('sha256')!r:.20}…, file "
                    f"{digest!r:.20}…)"
                )
        return manifest

    def load_step(
        self, step: int, expect_meta: Optional[dict] = None
    ) -> LoadedCheckpoint:
        """Verify + load one step. Config mismatch → loud
        :class:`CheckpointMismatch` (never a skip); integrity failure →
        :class:`CheckpointCorrupt`."""
        manifest = self.verify_step(step)
        meta = manifest.get("meta", {})
        if expect_meta is not None:
            diffs = {
                k: (meta.get(k), v)
                for k, v in expect_meta.items()
                if meta.get(k) != v
            }
            if diffs:
                raise CheckpointMismatch(
                    f"step {step} was written by a different recipe — "
                    "refusing to resume (checkpoint value vs this run): "
                    + ", ".join(
                        f"{k}={got!r} vs {want!r}"
                        for k, (got, want) in sorted(diffs.items())
                    )
                    + " — clear the checkpoint directory (pio ckpt gc "
                    "--all / --no-resume) to train fresh"
                )
        d = self.step_dir(step)
        arrays = {}
        for fname in manifest["files"]:
            try:
                arrays[fname[: -len(".npy")]] = np.load(
                    os.path.join(d, fname)
                )
            except (OSError, ValueError) as exc:
                raise CheckpointCorrupt(
                    f"step {step}: undecodable array {fname} ({exc})"
                ) from exc
        return LoadedCheckpoint(step=int(manifest["step"]), arrays=arrays,
                                meta=meta)

    def load(
        self,
        expect_meta: Optional[dict] = None,
        max_step: Optional[int] = None,
    ) -> Optional[LoadedCheckpoint]:
        """Newest valid checkpoint (≤ ``max_step`` if given), or None.

        Corrupt steps are skipped LOUDLY — logged at ERROR and counted
        in :attr:`corrupt_skipped` — falling back to the previous valid
        step. A config mismatch propagates (loud refusal)."""
        for step in reversed(self.steps()):
            if max_step is not None and step > max_step:
                continue
            try:
                return self.load_step(step, expect_meta=expect_meta)
            except CheckpointCorrupt as exc:
                self.corrupt_skipped += 1
                logger.error(
                    "ckpt: skipping corrupt checkpoint %s (%s); falling "
                    "back to the previous valid step",
                    self.step_dir(step), exc,
                )
        return None

    def verify(self) -> List[dict]:
        """Verification report for every committed step (``pio ckpt
        verify``): ``{"step", "ok", "error"?, "files"?}`` rows."""
        report = []
        for step in self.steps():
            try:
                manifest = self.verify_step(step)
                report.append({
                    "step": step,
                    "ok": True,
                    "files": len(manifest["files"]),
                    "bytes": sum(
                        rec.get("bytes", 0)
                        for rec in manifest["files"].values()
                    ),
                })
            except CheckpointCorrupt as exc:
                report.append({"step": step, "ok": False,
                               "error": str(exc)})
        return report

    # -- retention --------------------------------------------------------

    def retained(self, steps: Optional[Iterable[int]] = None) -> List[int]:
        """The steps the GC policy keeps: the ``keep_last`` newest plus
        every step divisible by ``keep_every`` (when > 0)."""
        all_steps = sorted(self.steps() if steps is None else steps)
        keep = set(all_steps[-self.keep_last:])
        if self.keep_every > 0:
            keep |= {s for s in all_steps if s % self.keep_every == 0}
        return sorted(keep)

    def gc(self, prune_uncommitted: bool = False) -> List[int]:
        """Delete steps outside the retention set; returns what was
        removed. ``prune_uncommitted`` also clears crash garbage
        (manifest-less step dirs) — off by default because the writer
        thread may be mid-commit on one of them."""
        keep = set(self.retained())
        removed = []
        for step in self.steps():
            if step not in keep:
                self.delete_step(step)
                removed.append(step)
        if prune_uncommitted:
            for name in self.uncommitted():
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)
        return removed

    def delete_step(self, step: int) -> None:
        """Manifest-first delete: after the unlink the step is garbage by
        protocol, so a crash mid-rmtree can never resurrect a partially
        deleted checkpoint as loadable."""
        d = self.step_dir(step)
        try:
            os.unlink(os.path.join(d, MANIFEST))
        except FileNotFoundError:
            pass
        fsync_dir(d)
        shutil.rmtree(d, ignore_errors=True)

    def clear(self) -> None:
        """Remove every checkpoint (the ``--no-resume`` fresh start)."""
        if os.path.isdir(self.root):
            shutil.rmtree(self.root)
