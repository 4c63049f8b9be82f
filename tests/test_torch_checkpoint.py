"""The port's ``Checkpointer`` (``repro_torch.checkpoint.checkpointing``)
on the CPU: the checkpoint tests of ``tests/test_runtime.py`` (rotation
and atomic rename, prefix namespaces rotating on their own, a flipped or
truncated leaf raising ``CheckpointCorrupt``), a round trip of the
serve's own tree (one ``{"mix": PagedKVState}`` per layer), restored
leaves that own their memory, a bf16 leaf (no numpy dtype) and a template
of another structure refused.

``tests/test_runtime.py::test_elastic_restore_to_different_mesh`` has no
counterpart: the port runs on one card and has no mesh to re-shard onto
(``restore`` takes a ``device=`` in place of ``shardings=``).
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.attention import PagedKVState
from repro_torch.checkpoint.checkpointing import (CheckpointCorrupt,
                                                  Checkpointer)
from repro_torch.launch.steps import tree_leaves


def test_checkpoint_gc_and_atomicity(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck4"), keep=2)
    for s in range(5):
        ck.save(s, {"x": torch.ones((4,)) * s}, blocking=True)
    assert ck.all_steps() == [3, 4]
    assert not any(n.endswith(".tmp") for n in os.listdir(ck.dir))


def test_checkpoint_prefix_namespaces_rotate_independently(tmp_path):
    """Two checkpoint families share a directory but list and rotate on
    their own through ``prefix``."""
    train = Checkpointer(str(tmp_path / "ck"), keep=2)
    serve = Checkpointer(str(tmp_path / "ck"), keep=2, prefix="serve")
    for s in range(4):
        train.save(s, {"x": torch.ones((2,)) * s}, blocking=True)
    serve.save(0, {"x": torch.zeros((2,))}, blocking=True)
    assert train.all_steps() == [2, 3]
    assert serve.all_steps() == [0]
    restored, meta = serve.restore({"x": torch.ones((2,))})
    assert meta["step"] == 0
    np.testing.assert_array_equal(restored["x"].numpy(), [0.0, 0.0])


def test_checkpoint_corruption_detected(tmp_path):
    """A flipped byte fails the leaf's crc32 and a truncated leaf fails to
    load: restore raises ``CheckpointCorrupt``, never wrong bytes."""
    ck = Checkpointer(str(tmp_path / "ck5"))
    tmpl = {"x": torch.arange(8, dtype=torch.float32)}
    ck.save(1, tmpl, blocking=True)
    restored, _ = ck.restore(tmpl)
    np.testing.assert_array_equal(restored["x"].numpy(),
                                  np.arange(8, dtype=np.float32))
    leaf = os.path.join(ck.dir, "step_00000001", "leaf_00000.npy")
    raw = bytearray(open(leaf, "rb").read())
    raw[-1] ^= 0xFF
    open(leaf, "wb").write(bytes(raw))
    with pytest.raises(CheckpointCorrupt):
        ck.restore(tmpl)
    with pytest.raises(CheckpointCorrupt):
        open(leaf, "wb").write(bytes(raw[: len(raw) // 2]))
        ck.restore(tmpl)


def _pools(seed, layers=2):
    """The serve's cache tree: a pool per layer, pages written, a page
    table and refcounts, a pinned page."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(layers):
        p = PagedKVState.init(3, 256, 2, 16, page_size=128, num_pages=6,
                               device="cpu")
        p = p._alloc(torch.tensor([2, 1, 0], dtype=torch.int32))
        p = p.incref_pages(torch.tensor([1], dtype=torch.int32))
        k = torch.randint(-128, 128, p.k.shape, generator=g,
                          dtype=torch.int8)
        out.append({"mix": PagedKVState(
            k=k, v=-k, page_table=p.page_table,
            pos=torch.tensor([200, 100, 0], dtype=torch.int32),
            free_stack=p.free_stack, free_top=p.free_top,
            ref_count=p.ref_count)})
    return out


def test_serve_pools_round_trip_and_own_their_memory(tmp_path):
    """The serve's tree round-trips bit for bit into a fresh template;
    each restored leaf is a new tensor, not the template's and not the
    loaded array (writing it leaves the next restore unchanged); a
    snapshot taken and then overwritten in place keeps its bytes."""
    caches = _pools(0)
    ck = Checkpointer(str(tmp_path / "snap"), keep=2, prefix="serve")
    ck.save(1, caches, extra={"pins": {"1": 1}}, blocking=True)
    want = [t.clone() for t in tree_leaves(caches)]
    for t in tree_leaves(caches):
        t.zero_()                  # the serve writes its pools in place
    template = _pools(1)
    restored, meta = ck.restore(template)
    assert meta["extra"] == {"pins": {"1": 1}}
    assert meta["n_leaves"] == len(want) == 14
    assert isinstance(restored[0]["mix"], PagedKVState)
    for got, w, tmpl in zip(tree_leaves(restored), want,
                            tree_leaves(template), strict=True):
        assert got.dtype == w.dtype and torch.equal(got, w)
        assert got.untyped_storage().data_ptr() \
            != tmpl.untyped_storage().data_ptr()
    for t in tree_leaves(restored):
        t.zero_()
    again, _ = ck.restore(template)
    for got, w in zip(tree_leaves(again), want, strict=True):
        assert torch.equal(got, w)
    for c in restored:
        assert c["mix"].page_size == 128


def test_bf16_leaf_round_trips_as_raw_bits(tmp_path):
    x = torch.randn((3, 5), generator=torch.Generator().manual_seed(2)
                    ).to(torch.bfloat16)
    ck = Checkpointer(str(tmp_path / "bf"))
    ck.save(0, [x, torch.tensor(True)], blocking=True)
    (got, flag), meta = ck.restore([torch.zeros_like(x), torch.tensor(False)])
    assert meta["dtypes"] == ["torch.bfloat16", "torch.bool"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, x)
    assert flag.item() is True


def test_restore_refuses_another_structure(tmp_path):
    ck = Checkpointer(str(tmp_path / "st"))
    ck.save(0, {"a": torch.zeros(2), "b": torch.zeros(2)}, blocking=True)
    with pytest.raises(CheckpointCorrupt, match="structure"):
        ck.restore({"a": torch.zeros(2), "c": torch.zeros(2)})
    with pytest.raises(CheckpointCorrupt, match="structure"):
        ck.restore([torch.zeros(2)])
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore([torch.zeros(2)])
