"""Checkpoints: atomic, async, checksummed, in the reference's format.

Layout: <dir>/step_<n>/
  meta.json            step, leaf manifest (dtype/shape/crc32), version
  <leaf_idx>.npy       one file per tree leaf

The same layout as ``repro.checkpoint``, so a checkpoint written by either
package restores in the other:

  * LEAF ORDER — a tree of dicts, lists and tuples (NamedTuples too: the
    LM's parameter groups) is flattened as
    ``jax.tree.flatten(tree, is_leaf=lambda x: x is None)`` flattens it:
    lists and tuples in order, dict keys *sorted*, ``None`` a leaf of its
    own (no file, ``null`` in the manifest).  ``{"w_q", "scale",
    "thr_int"}`` is stored as ``scale, thr_int, w_q``.
  * ATOMIC — written to ``step_<n>.tmp`` then renamed; a crash mid-save
    never corrupts the latest checkpoint, and ``latest_step`` only sees
    completed saves.
  * VALIDATED — every leaf's crc32, dtype and shape are recorded in the
    manifest and checked on restore, and the manifest carries
    ``format_version``; a truncated or bit-flipped leaf, or a checkpoint of
    a newer format, raises :class:`CheckpointError` (a ``ValueError``).
  * ASYNC — ``save_async`` copies the leaves to host memory synchronously
    and writes them in a background thread; ``wait()`` joins it (one
    outstanding write).

``meta.json``'s ``treedef`` is a description of the tree for people; like
the reference, ``restore`` checks only the leaf count against it, and the
manifest guards the rest.  Leaves come back as numpy arrays with their
on-disk dtypes.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["CheckpointError", "Checkpointer", "FORMAT_VERSION", "tree_flatten",
           "tree_unflatten"]

# Bump when the on-disk layout changes incompatibly.  restore() refuses
# checkpoints stamped with a newer version; version-0 checkpoints
# (pre-checksum) load without validation.
FORMAT_VERSION = 1


class CheckpointError(ValueError):
    """A checkpoint failed validation (corrupt, truncated, or wrong version)."""


def tree_flatten(tree: Any) -> list:
    """Leaves in the reference's order (dict keys sorted, ``None`` a leaf)."""
    if tree is None:
        return [None]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_flatten(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_flatten(item)]
    return [tree]


def tree_unflatten(like: Any, leaves) -> Any:
    """``like``'s structure filled with ``leaves``, in :func:`tree_flatten`'s
    order (one iterator, shared by the recursion: ``iter`` of an iterator
    is itself)."""
    leaves = iter(leaves)
    if like is None:
        return next(leaves)
    if isinstance(like, dict):
        filled = {key: tree_unflatten(like[key], leaves) for key in sorted(like)}
        return {key: filled[key] for key in like}
    if isinstance(like, (list, tuple)):
        items = [tree_unflatten(item, leaves) for item in like]
        return type(like)(*items) if hasattr(like, "_fields") else type(like)(items)
    return next(leaves)


def _describe(tree: Any) -> str:
    """A readable outline of the tree (the manifest's ``treedef``)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_describe(x) for x in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _host(leaf):
    if leaf is None:
        return None
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class Checkpointer:
    def __init__(self, directory: str):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extra_meta: Optional[dict] = None):
        self._write(step, [_host(x) for x in tree_flatten(tree)], _describe(tree),
                    extra_meta or {})

    def save_async(self, step: int, tree: Any, extra_meta: Optional[dict] = None):
        self.wait()
        # Copy to host memory now (the caller may change the tensors next);
        # the disk writes happen in the thread.
        host = [None if x is None else np.array(_host(x)) for x in tree_flatten(tree)]
        self._thread = threading.Thread(
            target=self._write, args=(step, host, _describe(tree), extra_meta or {}),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_leaves, treedef: str, extra_meta: dict):
        final = os.path.join(self.directory, f"step_{step:09d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = []
        for i, leaf in enumerate(host_leaves):
            if leaf is None:
                manifest.append(None)
                continue
            # Not ascontiguousarray: that promotes 0-d scalars to (1,).
            leaf = np.asarray(leaf, order="C")
            np.save(os.path.join(tmp, f"{i}.npy"), leaf)
            manifest.append({"dtype": str(leaf.dtype), "shape": list(leaf.shape),
                             "crc32": zlib.crc32(leaf.tobytes())})
        meta = {"step": step, "format_version": FORMAT_VERSION,
                "n_leaves": len(host_leaves), "manifest": manifest,
                "treedef": treedef, **extra_meta}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = [int(d.split("_")[1]) for d in os.listdir(self.directory)
                 if d.startswith("step_") and not d.endswith(".tmp")]
        return max(steps) if steps else None

    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of ``like`` (numpy leaves).

        Every leaf is validated against the manifest (crc32, dtype and
        shape) before it is returned; damage raises
        :class:`CheckpointError`, a missing leaf file
        ``FileNotFoundError``, a tree of another leaf count ``ValueError``.
        """
        path = os.path.join(self.directory, f"step_{step:09d}")
        try:
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
        except FileNotFoundError:
            raise
        except (json.JSONDecodeError, OSError) as e:
            raise CheckpointError(
                f"checkpoint step {step} in {self.directory} has an "
                f"unreadable meta.json: {e}") from e
        version = meta.get("format_version", 0)
        if version > FORMAT_VERSION:
            raise CheckpointError(
                f"checkpoint step {step} was written by format version "
                f"{version}, but this build reads <= {FORMAT_VERSION} — "
                "upgrade the code or re-save the checkpoint")
        manifest = meta.get("manifest") or [None] * meta["n_leaves"]
        leaves_like = tree_flatten(like)
        if meta["n_leaves"] != len(leaves_like):
            raise ValueError(
                f"pytree structure changed: checkpoint step {step} holds "
                f"{meta['n_leaves']} leaves, the template {len(leaves_like)}")
        out = []
        for i, template in enumerate(leaves_like):
            if template is None:
                out.append(None)
                continue
            out.append(self._read_leaf(step, path, i,
                                       manifest[i] if i < len(manifest) else None))
        return tree_unflatten(like, out)

    def _read_leaf(self, step: int, path: str, i: int, entry) -> np.ndarray:
        leaf_path = os.path.join(path, f"{i}.npy")
        try:
            arr = np.load(leaf_path)
        except FileNotFoundError:
            raise
        except Exception as e:
            raise CheckpointError(
                f"checkpoint step {step} leaf {i} is unreadable "
                f"(truncated or corrupt {leaf_path}): {e}") from e
        if entry is not None and "crc32" in entry:
            if str(arr.dtype) != entry["dtype"] or list(arr.shape) != entry["shape"]:
                raise CheckpointError(
                    f"checkpoint step {step} leaf {i} is {arr.dtype}{arr.shape}, "
                    f"but the manifest records {entry['dtype']}"
                    f"{tuple(entry['shape'])} — the leaf file was modified "
                    "after the save")
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if crc != entry["crc32"]:
                raise CheckpointError(
                    f"checkpoint step {step} leaf {i} fails its crc32 check "
                    f"({crc} != recorded {entry['crc32']}) — the data is "
                    "corrupt; restore from another snapshot")
        return arr
