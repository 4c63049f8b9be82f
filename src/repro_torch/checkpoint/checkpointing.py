"""Asynchronous checkpoints of a tree of tensors
(``repro.checkpoint.checkpointing``).

Layout (one directory per step):

    <dir>/<prefix>_00000123/
        meta.json            step, tree structure, shapes, torch dtypes,
                             format version, per-leaf crc32 checksums
        leaf_00000.npy ...   one file per tensor of the tree

- **Trees**: the tensors of dataclasses, dicts, lists and tuples, in
  ``launch.steps.tree_leaves`` order; ``restore`` rebuilds the template
  with ``tree_replace`` and refuses a template of another structure.
- **Asynchronous**: the device-to-host copy, the checksums and the
  ``meta.json`` encoding run on the caller; the file writes on a
  background thread, so the caller is blocked only for the copy.
- **Atomic**: written into a ``.tmp`` directory and renamed, so a crash
  mid-write never corrupts the newest checkpoint.
- **Integrity**: every leaf's crc32 is recorded in ``meta.json`` and
  checked again on restore (``verify=True``); a bit-rotted or truncated
  leaf, a missing file, another structure or a newer format version
  raises ``CheckpointCorrupt``, which a caller that can rebuild the state
  another way (the serve journal) catches to start cold instead of
  loading wrong bytes.
- **Namespaces**: ``prefix`` separates checkpoint families in one
  directory (the serve's snapshots are ``serve_%08d`` by snapshot
  ordinal); each family rotates (``keep``) on its own.
- **Dtypes**: each leaf's torch dtype is recorded; a dtype numpy lacks
  (bf16, the fp8 types) is saved as its raw bits in an integer of the
  same width and viewed back on restore.
- **Meshes**: a DTensor leaf is saved whole (``full_tensor()``, a
  collective every rank takes part in; rank 0 writes), so a checkpoint
  does not depend on the mesh. ``restore(..., shardings=)`` places each
  leaf by its ``launch.sharding.Sharding`` onto any mesh (the elastic
  restart); without it a DTensor template leaf takes its own placement.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.launch.steps import tree_leaves, tree_replace

FORMAT_VERSION = 2

# dtypes numpy holds; any other is stored as the raw bits of its width
_NUMPY_DTYPES = {torch.bool, torch.uint8, torch.int8, torch.int16,
                 torch.int32, torch.int64, torch.float16, torch.float32,
                 torch.float64}
_RAW_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed verification: checksum mismatch, missing or
    truncated leaf, another structure or an incompatible format version.
    Restoring would hand back wrong bytes, so the restore refuses."""


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).view(np.uint8).data)


def tree_structure(tree) -> str:
    """A string naming the containers of ``tree`` and where its tensors
    sit (``T``), which two trees share exactly when ``tree_replace`` can
    move the leaves of one into the other."""
    if torch.is_tensor(tree):
        return "T"
    if dataclasses.is_dataclass(tree):
        return type(tree).__name__ + "(" + ",".join(
            f"{f.name}={tree_structure(getattr(tree, f.name))}"
            for f in dataclasses.fields(tree)) + ")"
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k!r}:{tree_structure(v)}"
                              for k, v in tree.items()) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ",".join(tree_structure(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return type(tree).__name__


def _writer() -> bool:
    """Whether this process writes (rank 0 of a process group, or no
    group)."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(t: torch.Tensor) -> np.ndarray:
    """An owned host copy of ``t`` (``to(copy=True)``: on the CPU
    ``.numpy()`` would alias a tensor the caller keeps mutating); a
    DTensor whole."""
    t = t.detach()
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    if t.dtype not in _NUMPY_DTYPES:
        t = t.view(_RAW_OF_WIDTH[t.element_size()])
    return t.to("cpu", copy=True).numpy()


def _dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name.removeprefix("torch."), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown torch dtype {name!r}")
    return dtype


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, prefix: str = "step"):
        self.dir = directory
        self.keep = keep
        self.prefix = prefix
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=2)
        self._pending = None
        self._lock = threading.Lock()

    def _dirname(self, step: int) -> str:
        return os.path.join(self.dir, f"{self.prefix}_{step:08d}")

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, extra: dict | None = None,
             blocking: bool = False):
        """Snapshot the tensors of ``tree`` at ``step``."""
        leaves = tree_leaves(tree)
        host_leaves = [_to_host(t) for t in leaves]          # device->host
        meta = {
            "format_version": FORMAT_VERSION,
            "step": step,
            "structure": tree_structure(tree),
            "n_leaves": len(leaves),
            "extra": extra or {},
            "shapes": [list(t.shape) for t in leaves],
            "dtypes": [str(t.dtype) for t in leaves],
            "checksums": [_crc32(a) for a in host_leaves],
        }
        # encoded now, on the caller: ``extra`` may hold live bookkeeping
        # (the serve's prefix index and pin ledger) that keeps changing
        # after save() returns
        meta_json = json.dumps(meta)
        if not _writer():                   # another rank writes
            fut = self._pool.submit(lambda: None)
        else:
            fut = self._pool.submit(self._write, step, host_leaves,
                                    meta_json)
        with self._lock:
            self._pending = fut
        if blocking:
            fut.result()
        return fut

    def _write(self, step, host_leaves, meta_json):
        final = self._dirname(step)
        tmp = f"{final}.{os.getpid()}.{threading.get_ident()}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for i, leaf in enumerate(host_leaves):
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), leaf)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            f.write(meta_json)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()
        return final

    def wait(self):
        with self._lock:
            fut = self._pending
        if fut is not None:
            fut.result()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self._dirname(s), ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self):
        out = []
        want = self.prefix + "_"
        for name in os.listdir(self.dir):
            if name.startswith(want) and not name.endswith(".tmp"):
                out.append(int(name[len(want):].split(".")[0]))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None, device=None,
                verify: bool = True, shardings=None) -> tuple:
        """Restore into the structure of ``template``, each leaf on
        ``device`` (None: the template leaf's device). ``shardings``: a
        tree of ``launch.sharding.Sharding`` of the template's structure
        (or None), each leaf placed by its own onto its mesh; a DTensor
        template leaf without one takes the template's placement.
        ``verify`` checks every leaf's crc32 against ``meta.json`` and
        raises ``CheckpointCorrupt`` on a mismatch. Returns ``(tree,
        meta)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self._dirname(step)
        try:
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorrupt(f"{path}: unreadable meta.json: {e}")
        version = meta.get("format_version", 1)
        if version > FORMAT_VERSION:
            raise CheckpointCorrupt(
                f"{path}: format version {version} is newer than this "
                f"reader ({FORMAT_VERSION})")
        leaves = tree_leaves(template)
        if len(leaves) != meta["n_leaves"] \
                or meta.get("structure") != tree_structure(template):
            raise CheckpointCorrupt(
                f"{path}: tree structure changed ({len(leaves)} leaves vs "
                f"{meta['n_leaves']} on disk)")
        checksums = meta.get("checksums")
        places = _placements(leaves, shardings)
        out = []
        for i, tmpl in enumerate(leaves):
            leaf_path = os.path.join(path, f"leaf_{i:05d}.npy")
            try:
                arr = np.load(leaf_path)
            except (OSError, ValueError) as e:
                raise CheckpointCorrupt(f"{leaf_path}: unreadable: {e}")
            if verify and checksums is not None:
                got = _crc32(arr)
                if got != checksums[i]:
                    raise CheckpointCorrupt(
                        f"{leaf_path}: crc32 {got:#010x} != recorded "
                        f"{checksums[i]:#010x}")
            # clone: from_numpy aliases the np.load buffer, and on the CPU
            # .to() would hand that alias to a caller that writes the
            # restored pools in place
            t = torch.from_numpy(arr).clone().view(_dtype(meta["dtypes"][i]))
            t = t.to(tmpl.device if device is None else device)
            out.append(t if places[i] is None else places[i](t))
        return tree_replace(template, iter(out)), meta


def _placements(leaves, shardings) -> list:
    """Per template leaf, a function placing a whole tensor as the leaf
    should be, or None: its ``Sharding`` in ``shardings``, else the
    placement of a DTensor template leaf."""
    from repro_torch.launch.sharding import Sharding, place, spec_of
    if shardings is not None:
        shs = tree_leaves(shardings, leaf=lambda x: isinstance(x, Sharding))
        if len(shs) != len(leaves):
            raise ValueError(f"{len(shs)} shardings for {len(leaves)} "
                             f"leaves")
        return [functools.partial(place, sharding=sh) for sh in shs]
    return [functools.partial(place, sharding=Sharding(
        t.device_mesh, spec_of(t.placements, t.device_mesh, t.ndim)))
        if hasattr(t, "device_mesh") else None for t in leaves]
