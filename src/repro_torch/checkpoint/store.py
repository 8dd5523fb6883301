"""Checkpointing: flat-key npz of nested dict/list/tuple trees (the
counterpart of ``repro/checkpoint/store.py``, in the same on-disk format,
so a checkpoint written by one package loads in the other; the paper's
master manages checkpoints, here the host process plays the master role).

Layout: ``<dir>/step_<N>.npz`` with keys ``path/to/leaf`` and a JSON
manifest holding the treedef plus a **per-leaf crc32 checksum**.

Hardened for the fault-tolerant runtime (a checkpoint you cannot trust
is worse than none — rollback restores it blindly):

- writes go to an **open file handle** (so numpy cannot re-suffix the
  temp name), are **fsync'd**, then atomically renamed into place — a
  crash mid-save leaves only a ``.tmp`` orphan, never a half-written
  ``step_*.npz``;
- loads verify every leaf against the manifest checksums; truncated or
  corrupted files raise a typed :class:`CheckpointCorruptError` (never
  a bare ``zipfile``/``KeyError``), and :func:`latest_step` /
  :func:`load_checkpoint` skip them to the newest **valid** step;
- :func:`save_checkpoint` cleans up orphaned ``.tmp`` files and can
  retain only the last ``keep`` checkpoints.

Leaves may be torch tensors (copied to the host), numpy arrays or Python
numbers (a Python int becomes a numpy int64 scalar); loads hand back
numpy arrays.
"""
from __future__ import annotations

import json
import os
import re
import zipfile
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch


_SEP = "/"
_STEP_RE = re.compile(r"step_(\d+)\.npz$")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file is truncated, unreadable, missing its manifest,
    or fails its per-leaf checksum."""


def _to_host(tree):
    """The tree with every leaf a numpy array on the host."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _flatten(tree) -> dict:
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(f"{prefix}{_SEP}{k}" if prefix else str(k), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(f"{prefix}{_SEP}{i}" if prefix else str(i), v)
        else:
            flat[prefix] = np.asarray(node)

    rec("", tree)
    return flat


def _spec(tree):
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _spec(v) for k, v in tree.items()}}
    if isinstance(tree, tuple):
        return {"__kind__": "tuple", "items": [_spec(v) for v in tree]}
    if isinstance(tree, list):
        return {"__kind__": "list", "items": [_spec(v) for v in tree]}
    return {"__kind__": "leaf"}


def _rebuild(spec, flat, prefix=""):
    kind = spec["__kind__"]
    if kind == "dict":
        return {k: _rebuild(v, flat, f"{prefix}{_SEP}{k}" if prefix else k)
                for k, v in spec["items"].items()}
    if kind in ("tuple", "list"):
        seq = [_rebuild(v, flat, f"{prefix}{_SEP}{i}" if prefix else str(i))
               for i, v in enumerate(spec["items"])]
        return tuple(seq) if kind == "tuple" else seq
    return flat[prefix]


def _leaf_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _step_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.npz")


def checkpoint_path(directory: str, step: int) -> str:
    """Where :func:`save_checkpoint` puts step ``step``: what the ranks
    that do not write (one process writes for a group) hand back."""
    return _step_path(directory, step)


def _clean_tmp(directory: str, keep_path: Optional[str] = None) -> int:
    """Remove orphaned ``*.tmp`` files (a crash mid-save leaves exactly
    one; single-writer, so any .tmp not being written right now is
    garbage). Returns how many were removed."""
    removed = 0
    for f in os.listdir(directory):
        if not f.endswith(".tmp"):
            continue
        full = os.path.join(directory, f)
        if full == keep_path:
            continue
        try:
            os.remove(full)
            removed += 1
        except OSError:
            continue   # racing cleanup loses harmlessly
    return removed


def save_checkpoint(directory: str, step: int, tree: Any,
                    keep: int = 0) -> str:
    """Atomically write ``tree`` as ``step_<N>.npz``.

    The npz is written to an **open handle** on a ``.tmp`` path (numpy
    appends ``.npz`` to *names*, never to handles — the suffix is
    deterministic), flushed and fsync'd, then renamed over the final
    path. The manifest records a crc32 per leaf, verified on load.
    ``keep > 0`` retains only the newest ``keep`` checkpoints.
    """
    os.makedirs(directory, exist_ok=True)
    _clean_tmp(directory)
    host_tree = _to_host(tree)
    flat = _flatten(host_tree)
    manifest = {
        "spec": _spec(host_tree),
        "checksums": {k: _leaf_crc(v) for k, v in flat.items()},
    }
    path = _step_path(directory, step)
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __manifest__=np.frombuffer(
                json.dumps(manifest).encode(), dtype=np.uint8), **flat)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # never leave a half-written tmp masquerading as in-progress
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                # cleanup of a cleanup; the original error is what matters
                pass  # lint: waive=src.silent-except
        raise
    if keep > 0:
        for s in checkpoint_steps(directory)[:-keep]:
            try:
                os.remove(_step_path(directory, s))
            except OSError:
                continue   # retention is advisory; a locked file stays
    return path


def _load_verified(path: str) -> Any:
    """Read + checksum-verify one checkpoint file; every failure mode
    (truncated zip, unreadable member, missing manifest, bad crc) is a
    :class:`CheckpointCorruptError`."""
    try:
        with np.load(path) as data:
            if "__manifest__" not in data.files:
                raise CheckpointCorruptError(
                    f"{path}: no __manifest__ key — not a checkpoint "
                    "or header lost")
            manifest = json.loads(bytes(data["__manifest__"]).decode())
            flat = {k: data[k] for k in data.files if k != "__manifest__"}
    except CheckpointCorruptError:
        raise
    except (zipfile.BadZipFile, OSError, EOFError, ValueError, KeyError,
            json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"{path}: unreadable ({type(e).__name__}: {e})") from e
    if "spec" in manifest:            # hardened format: verify leaves
        spec = manifest["spec"]
        sums: Dict[str, int] = manifest.get("checksums", {})
        missing = set(sums) - set(flat)
        if missing:
            raise CheckpointCorruptError(
                f"{path}: leaves missing vs manifest: {sorted(missing)}")
        for k, want in sums.items():
            got = _leaf_crc(flat[k])
            if got != int(want):
                raise CheckpointCorruptError(
                    f"{path}: checksum mismatch on leaf {k!r} "
                    f"(manifest {int(want):#010x}, data {got:#010x})")
    else:                             # pre-hardening manifest = bare spec
        spec = manifest
    try:
        return _rebuild(spec, flat)
    except (KeyError, IndexError, TypeError) as e:
        raise CheckpointCorruptError(
            f"{path}: manifest/leaf structure mismatch "
            f"({type(e).__name__}: {e})") from e


def verify_checkpoint(path: str) -> bool:
    """True iff ``path`` loads and passes every checksum."""
    try:
        _load_verified(path)
        return True
    except (CheckpointCorruptError, FileNotFoundError):
        return False


def load_checkpoint(directory: str, step: Optional[int] = None) -> Any:
    """Load a checkpoint. ``step=None`` walks newest → oldest and
    returns the first that verifies, so resume after a crash (or a
    corrupted latest file) falls back to the previous valid step; an
    explicit ``step`` raises :class:`CheckpointCorruptError` if that
    file is bad."""
    if step is not None:
        return _load_verified(_step_path(directory, step))
    steps = checkpoint_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    last_err: Optional[CheckpointCorruptError] = None
    for s in reversed(steps):
        try:
            return _load_verified(_step_path(directory, s))
        except CheckpointCorruptError as e:
            last_err = e
    raise CheckpointCorruptError(
        f"no valid checkpoint in {directory} "
        f"({len(steps)} candidates, all corrupt; last: {last_err})")


def checkpoint_steps(directory: str) -> list:
    """All on-disk step numbers, ascending (no validation)."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for f in os.listdir(directory):
        m = _STEP_RE.match(f)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str, validate: bool = True) -> Optional[int]:
    """Newest step number — by default the newest that actually
    **verifies** (corrupt/truncated files are skipped), so the resume
    path never points at a checkpoint the load would reject.
    ``validate=False`` is the old name-only scan."""
    steps = checkpoint_steps(directory)
    if not validate:
        return steps[-1] if steps else None
    for s in reversed(steps):
        if verify_checkpoint(_step_path(directory, s)):
            return s
    return None
