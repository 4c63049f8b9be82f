"""Typed int8 KV-cache state (``repro.attention.state``): the contiguous
ring buffer ``KVCacheState`` and the paged pool ``PagedKVState``.

Ring layout: ``k``/``v`` are ``(B, C, G, hd)`` with capacity ``C`` a
ring — token ``t`` lives in slot ``t % C``. ``pos`` is per sequence,
``(B,)`` int32: each row tracks its own stream length, so a ragged batch
shares one cache and one kernel call. ``valid_len`` and ``q_offset``
derive from ``pos`` and flow through ``dispatch`` into the per-row
kernel meta.

``PagedKVState`` is the continuous-batching allocator: one shared arena
of pages for the whole batch, a per-sequence page table, an on-device
LIFO free stack and a refcount per page. Its logical semantics are those
of a ring of capacity ``n_pages * page_size``, so the paged kernels read
the same bytes as the ring kernels; physically a sequence holds only
``ceil(pos / page_size)`` pages, and ``release`` hands them back. Page 0
is the parking page: never allocated, never written, it backs unassigned
table entries.

The JAX state is immutable and its scatters drop out-of-bounds indices
(``mode="drop"``); the port writes K/V into the ring or arena in place
and returns a state that shares them, with fresh small tensors for the
bookkeeping. Torch has no drop mode, and an out-of-bounds index asserts
on the card, so every write the reference drops goes to a sink: the
arena holds one page past the pool (index ``num_pages``) that no table,
free stack or refcount ever names, and the bookkeeping scatters write
into a copy padded by one sink entry that is cut off again (``scatter_drop``).
Ring writes of dead rows write back the value they would overwrite.
Every scatter is duplicate-free outside the sink, so results are
deterministic on the card, and no operation reads a value back to the
host. Per-head cache scales (``k_scale``/``v_scale``, (G,) float32,
optional) ride on both states for the engine of ``runtime.kv_cache``;
the model path quantizes onto its per-tensor QAT scales and keeps them
None.

Prefix sharing: ``adopt_prefix`` points a fresh row's leading table
entries at pages another request wrote, ``incref_pages``/``decref_pages``
pin and unpin pages for the host ``PrefixIndex`` (chain-hashed page-
aligned prompt chunks -> physical page), and copy-on-write in the append
paths guards shared pages.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.common import MIN_BLOCK_KV


def _ceil_div(a, b):
    return (a + b - 1) // b


def scatter_drop(t, index, values, accumulate=False):
    """``t.at[index].set(values, mode="drop")`` (or ``.add`` with
    ``accumulate``) for index tensors whose out-of-bounds entries are
    exactly the size of their dim: a copy of ``t`` padded by one sink
    entry on every indexed dim takes the writes, and the sink is cut off.
    Returns a new contiguous tensor."""
    k = len(index)
    buf = t.new_zeros([n + 1 for n in t.shape[:k]] + list(t.shape[k:]))
    inner = tuple(slice(0, n) for n in t.shape[:k])
    buf[inner] = t
    values = torch.as_tensor(values, dtype=t.dtype, device=t.device)
    buf.index_put_(tuple(i.long() for i in index), values,
                   accumulate=accumulate)
    return buf[inner].contiguous()


def _i32(x):
    return x.to(torch.int32)


def _align_capacity(capacity: int) -> int:
    """Round a ring capacity above one KV block up to a block multiple, so
    the fused kernels' ``_pad_seq`` is a no-op on the decode path."""
    capacity = max(capacity, 1)
    if capacity > MIN_BLOCK_KV:
        capacity = -(-capacity // MIN_BLOCK_KV) * MIN_BLOCK_KV
    return capacity


@dataclasses.dataclass(frozen=True)
class KVCacheState:
    k: torch.Tensor             # (B, C, G, hd) int8 (or compute dtype)
    v: torch.Tensor             # (B, C, G, hd)
    pos: torch.Tensor           # (B,) int32 — tokens ever written, per seq
    k_scale: torch.Tensor | None = None     # (G,) float32 per-head scales
    v_scale: torch.Tensor | None = None

    @classmethod
    def init(cls, batch: int, capacity: int, n_kv_heads: int, head_dim: int,
             dtype=torch.int8, device="cuda",
             per_head_scales: bool = False) -> "KVCacheState":
        """Fresh (zeroed) ring-buffer cache, capacity block-aligned above
        one KV block, on ``device`` (default the card; raises when CUDA is
        missing); ``per_head_scales`` starts (G,) scales at 1."""
        device = resolve_device(device)
        capacity = _align_capacity(capacity)
        shape = (batch, capacity, n_kv_heads, head_dim)
        scales = (torch.ones((n_kv_heads,), dtype=torch.float32,
                             device=device) if per_head_scales else None)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=torch.zeros((batch,), dtype=torch.int32,
                                   device=device),
                   k_scale=scales, v_scale=scales)

    def with_scales(self, k_scale, v_scale) -> "KVCacheState":
        return dataclasses.replace(self, k_scale=k_scale, v_scale=v_scale)

    @property
    def capacity(self) -> int:
        return self.k.shape[1]

    def valid_len(self) -> torch.Tensor:
        """Per-sequence number of valid (non-evicted) ring entries, (B,)."""
        return torch.clamp(self.pos, max=self.capacity)

    def q_offset(self, s_new: int = 1) -> torch.Tensor:
        """Ring-coordinate position of the first of the ``s_new`` query
        tokens just appended: ``valid_len - s_new``, per sequence (B,).
        After a wrap the oldest surviving token is position 0."""
        return torch.clamp(self.valid_len() - s_new, min=0)

    def prefill_write(self, k_q, v_q, lengths=None) -> "KVCacheState":
        """Bulk-write ``S`` prefill tokens (B, S, G, hd), evicting beyond
        capacity: token ``t`` lands in slot ``t % C``; when ``S >= C`` only
        the last ``C`` survive. ``lengths`` (B,) declares right-padded
        ragged prompts (``pos`` starts there) and needs ``C >= S``."""
        b, s = k_q.shape[:2]
        cs = self.capacity
        if lengths is not None:
            if s > cs:
                raise ValueError(
                    f"ragged prefill needs capacity >= padded prompt length "
                    f"(got S={s} > C={cs}); grow the ring (max_len, or the "
                    f"window for window-capped caches) or drop lengths")
            pos = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=self.pos.device).reshape(b).clone()
        else:
            pos = torch.full((b,), s, dtype=torch.int32,
                             device=self.pos.device)
        if s >= cs:
            # keep the tail, rolled so slot (t % C) holds token t
            self.k.copy_(torch.roll(k_q[:, s - cs:], s % cs, dims=1))
            self.v.copy_(torch.roll(v_q[:, s - cs:], s % cs, dims=1))
        else:
            self.k[:, :s] = k_q
            self.v[:, :s] = v_q
        return dataclasses.replace(self, pos=pos)

    def decode_append(self, k_q, v_q, live=None) -> "KVCacheState":
        """Append ``s_new`` decode tokens per sequence: row ``b``'s token
        ``pos[b] + i`` goes to slot ``(pos[b] + i) % C``; a burst longer
        than the ring writes only its last ``C`` tokens (the survivors),
        so no two writes hit one slot. ``live`` (B,) bool masks dead
        continuous-batching slots: their slots keep their bytes (the
        write puts back the value it would overwrite) and their ``pos``
        does not advance."""
        b, s_new = k_q.shape[:2]
        cs = self.capacity
        start = max(s_new - cs, 0)
        ar = torch.arange(s_new - start, dtype=torch.int64,
                          device=self.pos.device)
        slots = (self.pos.long()[:, None] + start + ar[None, :]) % cs
        bidx = torch.arange(b, device=self.pos.device)[:, None]
        k_new, v_new = k_q[:, start:], v_q[:, start:]
        if live is not None:
            keep = live.view(b, 1, 1, 1)
            k_new = torch.where(keep, k_new, self.k[bidx, slots])
            v_new = torch.where(keep, v_new, self.v[bidx, slots])
        self.k[bidx, slots] = k_new
        self.v[bidx, slots] = v_new
        step = s_new if live is None else s_new * live.to(torch.int32)
        return dataclasses.replace(self, pos=self.pos + step)


# ---------------------------------------------------------------------------
# Paged KV pool
# ---------------------------------------------------------------------------

PARKING_PAGE = 0        # physical page 0: backs unassigned table entries


@dataclasses.dataclass(frozen=True)
class PagedKVState:
    """Shared paged int8 KV pool + per-sequence page tables + free stack
    (``repro.attention.state.PagedKVState``).

    ``k``/``v``: ``(num_pages + 1, page_size, G, hd)`` — the
    ``num_pages`` pages of the pool (page 0 the parking page) and the
    sink page at index ``num_pages`` that takes every dropped write.
    ``page_table``: ``(B, n_pages)`` int32 — logical page ``j`` of
    sequence ``b`` lives in physical page ``page_table[b, j]``
    (``PARKING_PAGE`` = unassigned). ``pos``: per-sequence stream length;
    logical slot ``t % capacity`` with ``capacity = n_pages *
    page_size``. ``free_stack``/``free_top``: LIFO of free pages,
    ``free_stack[:free_top]`` free. ``ref_count``: ``(num_pages,)``
    references per page (page-table entries within a row's held prefix,
    plus pins). Every page is on the free stack XOR referenced
    (``check_invariants``).
    """

    k: torch.Tensor             # (P + 1, page, G, hd), page P the sink
    v: torch.Tensor
    page_table: torch.Tensor    # (B, n_pages) int32
    pos: torch.Tensor           # (B,) int32
    free_stack: torch.Tensor    # (P,) int32
    free_top: torch.Tensor      # () int32 — number of free pages
    ref_count: torch.Tensor     # (P,) int32
    k_scale: torch.Tensor | None = None     # (G,) float32 per-head scales
    v_scale: torch.Tensor | None = None

    # -- construction -----------------------------------------------------

    @classmethod
    def init(cls, batch: int, capacity: int, n_kv_heads: int, head_dim: int,
             dtype=torch.int8, device="cuda", *,
             page_size: int = MIN_BLOCK_KV, num_pages: int | None = None,
             per_head_scales: bool = False) -> "PagedKVState":
        """Fresh pool on ``device`` (default the card; raises when CUDA is
        missing). ``capacity`` (per-sequence logical window) rounds up to
        a ``page_size`` multiple; ``num_pages`` sizes the shared arena
        (default: fully provisioned, ``batch * pages_per_seq`` + the
        parking page — pass less to oversubscribe under an admission
        scheduler)."""
        device = resolve_device(device)
        capacity = max(capacity, 1)
        n_pages = _ceil_div(capacity, page_size)
        if num_pages is None:
            num_pages = batch * n_pages + 1
        if num_pages < 2:
            raise ValueError("num_pages must cover the parking page plus "
                             "at least one allocatable page")
        shape = (num_pages + 1, page_size, n_kv_heads, head_dim)
        i32 = dict(dtype=torch.int32, device=device)
        # free pages are 1..P-1 (0 is parking), laid out so the first pop
        # hands out page 1
        stack = torch.cat([torch.arange(num_pages - 1, 0, -1, **i32),
                           torch.zeros((1,), **i32)])
        scales = (torch.ones((n_kv_heads,), dtype=torch.float32,
                             device=device) if per_head_scales else None)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   page_table=torch.zeros((batch, n_pages), **i32),
                   pos=torch.zeros((batch,), **i32), free_stack=stack,
                   free_top=torch.full((), num_pages - 1, **i32),
                   ref_count=torch.zeros((num_pages,), **i32),
                   k_scale=scales, v_scale=scales)

    def with_scales(self, k_scale, v_scale) -> "PagedKVState":
        return dataclasses.replace(self, k_scale=k_scale, v_scale=v_scale)

    # -- geometry ---------------------------------------------------------

    @property
    def page_size(self) -> int:
        return self.k.shape[1]

    @property
    def num_pages(self) -> int:
        return self.k.shape[0] - 1

    @property
    def pages_per_seq(self) -> int:
        return self.page_table.shape[1]

    @property
    def capacity(self) -> int:
        return self.pages_per_seq * self.page_size

    @property
    def batch(self) -> int:
        return self.page_table.shape[0]

    def _ar(self, n):
        return torch.arange(n, dtype=torch.int32, device=self.pos.device)

    def pages_held(self) -> torch.Tensor:
        """Physical pages currently backing each sequence, (B,) int32."""
        return torch.clamp(_ceil_div(self.pos, self.page_size),
                           max=self.pages_per_seq)

    def valid_len(self) -> torch.Tensor:
        return torch.clamp(self.pos, max=self.capacity)

    def q_offset(self, s_new=1) -> torch.Tensor:
        """Ring-coordinate position of the first of the ``s_new`` query
        tokens just appended (an int or a (B,) vector), per sequence."""
        return torch.clamp(self.valid_len() - s_new, min=0)

    # -- allocation -------------------------------------------------------

    def _alloc(self, need) -> "PagedKVState":
        """Pop ``need[b]`` pages per row off the free stack into each
        row's next unassigned page-table entries (refcount 1). Callers
        guarantee ``sum(need) <= free_top`` (the admission scheduler's
        invariant); an overdrawn pool drives ``free_top`` negative, which
        ``oversubscribed`` exposes."""
        b, npps, P = need.shape[0], self.pages_per_seq, self.num_pages
        held = self.pages_held()
        offs = torch.cumsum(need, 0, dtype=torch.int32) - need  # exclusive
        cols = self._ar(npps)[None, :]
        take = cols < need[:, None]                         # (B, npps)
        sidx = self.free_top - 1 - (offs[:, None] + cols)
        phys = self.free_stack[torch.clamp(sidx, 0, P - 1).long()]
        dest = held[:, None] + cols
        dest = torch.where(take & (dest < npps), dest, npps)  # sink column
        bidx = self._ar(b)[:, None].expand(b, npps)
        pt = scatter_drop(self.page_table, (bidx, dest), phys)
        ref = scatter_drop(self.ref_count, (torch.where(take, phys, P),),
                           torch.ones_like(phys))
        top = self.free_top - take.sum(dtype=torch.int32)
        return dataclasses.replace(self, page_table=pt, ref_count=ref,
                                   free_top=top)

    def oversubscribed(self) -> torch.Tensor:
        """True when an allocation overdrew the pool (scheduler bug)."""
        return self.free_top < 0

    def _decref(self, dec) -> "PagedKVState":
        """Apply per-page refcount decrements ``dec`` (P,) int32, pushing
        pages whose count reaches zero back onto the free stack in
        ascending page-id order. A page already at count 0 can neither
        underflow nor be pushed twice."""
        P = self.num_pages
        freed = (dec > 0) & (self.ref_count > 0) & (self.ref_count <= dec) \
            & (self._ar(P) != PARKING_PAGE)
        ref = torch.clamp(self.ref_count - dec, min=0)
        rank = torch.cumsum(freed, 0, dtype=torch.int32) - 1
        dest = self.free_top + rank
        dest = torch.where(freed & (dest < P), dest, P)
        stack = scatter_drop(self.free_stack, (dest,), self._ar(P))
        top = self.free_top + freed.sum(dtype=torch.int32)
        return dataclasses.replace(self, ref_count=ref, free_stack=stack,
                                   free_top=top)

    def release(self, finished) -> "PagedKVState":
        """Drop one reference per page held by every row with
        ``finished[b]``, park those rows' tables and reset their ``pos``
        to 0 — the continuous-batching hand-back. Idempotent: a released
        row holds nothing, so releasing it again moves no pages."""
        finished = torch.as_tensor(finished, dtype=torch.bool,
                                   device=self.pos.device)
        P, npps = self.num_pages, self.pages_per_seq
        held = self.pages_held()
        give = finished[:, None] & (self._ar(npps)[None, :] < held[:, None]) \
            & (self.page_table != PARKING_PAGE)
        idx = torch.where(give, self.page_table, P).reshape(-1)
        dec = scatter_drop(torch.zeros_like(self.ref_count), (idx,),
                           torch.ones_like(idx), accumulate=True)
        new = self._decref(dec)
        pt = torch.where(finished[:, None], PARKING_PAGE, new.page_table)
        pos = torch.where(finished, 0, new.pos)
        return dataclasses.replace(new, page_table=_i32(pt), pos=_i32(pos))

    # -- prefix sharing ---------------------------------------------------

    def adopt_prefix(self, rows, pages, n_pages, n_tokens) -> "PagedKVState":
        """Point row ``rows[i]``'s first ``n_pages[i]`` table entries at
        the existing pages ``pages[i, :n_pages[i]]`` (+1 refcount each)
        and start its stream at ``pos = n_tokens[i]``: the shared-prefix
        admission, whose leading prompt pages are another request's bytes
        and are never prefilled again. ``rows[i] < 0`` is a dropped dummy
        entry. Target rows must be fresh (released). ``n_tokens`` equals
        ``n_pages * page_size``: sharing is page-granular."""
        b, dev = self.batch, self.pos.device

        def i32(x):
            return torch.as_tensor(x, dtype=torch.int32, device=dev)
        rows = i32(rows).reshape(-1)
        n = rows.shape[0]
        pages = i32(pages).reshape(n, -1)
        n_pages, n_tokens = i32(n_pages).reshape(n), i32(n_tokens).reshape(n)
        valid = rows >= 0
        rowsq = torch.where(valid, rows, b)
        cols = self._ar(pages.shape[1])[None, :]
        take = valid[:, None] & (cols < n_pages[:, None]) \
            & (pages != PARKING_PAGE)
        dcol = torch.where(take, cols, self.pages_per_seq)
        pt = scatter_drop(self.page_table,
                          (rowsq[:, None].expand_as(dcol), dcol), pages)
        ref = scatter_drop(self.ref_count,
                           (torch.where(take, pages, self.num_pages),),
                           torch.ones_like(pages), accumulate=True)
        pos = scatter_drop(self.pos, (rowsq,),
                           n_tokens * valid.to(torch.int32))
        return dataclasses.replace(self, page_table=pt, ref_count=ref,
                                   pos=pos)

    def _page_ids(self, pages, lo):
        """Flat int32 ``pages`` with every id outside ``[lo, num_pages)``
        sent to the sink entry ``num_pages``."""
        pages = torch.as_tensor(pages, dtype=torch.int32,
                                device=self.pos.device).reshape(-1)
        return torch.where((pages >= lo) & (pages < self.num_pages), pages,
                           self.num_pages)

    def incref_pages(self, pages) -> "PagedKVState":
        """+1 refcount per entry of ``pages`` (flat; negative = padding,
        dropped): the prefix index's pin, which keeps a registered page
        alive after its row releases it."""
        idx = self._page_ids(pages, PARKING_PAGE + 1)
        return dataclasses.replace(self, ref_count=scatter_drop(
            self.ref_count, (idx,), torch.ones_like(idx), accumulate=True))

    def decref_pages(self, pages) -> "PagedKVState":
        """Drop one reference per entry of ``pages`` (flat; negative =
        padding): the index's unpin or eviction. Pages reaching zero
        return to the free stack; duplicates decrement once each."""
        idx = self._page_ids(pages, 0)
        dec = scatter_drop(torch.zeros_like(self.ref_count), (idx,),
                           torch.ones_like(idx), accumulate=True)
        return self._decref(dec)

    def _cow(self, first, n_new, max_width: int) -> "PagedKVState":
        """Copy-on-write the pages the rows are about to overwrite: a
        logical page holding write slots ``[first[b], first[b]+n_new[b])``
        whose physical page is shared (refcount > 1) is copied to a
        freshly popped page first; the row repoints its table entry and
        drops its reference. ``max_width`` bounds ``n_new``. A pristine
        page abandoned by every holder in one call returns to the free
        stack once. The serve never lets a sharing row wrap onto its
        shared pages, so there no page qualifies; the copy fires in the
        tests and in ``chip_smoke.py``'s wrapping step. It runs inside
        captured steps: device ops only."""
        ps, cs = self.page_size, self.capacity
        npps, P = self.pages_per_seq, self.num_pages
        b = first.shape[0]
        maxp = min(_ceil_div(max_width + ps - 1, ps), npps)
        p0 = (first % cs) // ps
        npages = torch.where(
            n_new > 0, torch.clamp(_ceil_div(first % ps + n_new, ps),
                                   max=npps), 0)
        cols = self._ar(maxp)[None, :]
        jc = (p0[:, None] + cols) % npps                    # (B, maxp)
        bidx = self._ar(b)[:, None].expand(b, maxp)
        phys = self.page_table[bidx.long(), jc.long()]
        shared = (cols < npages[:, None]) & (phys != PARKING_PAGE) \
            & (self.ref_count[phys.long()] > 1)
        # pop one fresh page per shared entry (row-major, like _alloc)
        flat = shared.reshape(-1)
        rank = torch.cumsum(flat, 0, dtype=torch.int32) - 1
        sidx = self.free_top - 1 - rank
        fresh = self.free_stack[torch.clamp(sidx, 0, P - 1).long()] \
            .reshape(b, maxp)
        src = torch.where(shared, phys, PARKING_PAGE).reshape(-1).long()
        dst = torch.where(shared, fresh, P).reshape(-1).long()
        self.k[dst] = self.k[src]                           # P: the sink
        self.v[dst] = self.v[src]
        pt = scatter_drop(self.page_table,
                          (bidx, torch.where(shared, jc, npps)), fresh)
        ref = scatter_drop(self.ref_count, (dst,), torch.ones_like(dst))
        dec = scatter_drop(torch.zeros_like(self.ref_count),
                           (torch.where(shared, phys, P).reshape(-1),),
                           torch.ones_like(dst), accumulate=True)
        top = self.free_top - flat.sum(dtype=torch.int32)
        cow = dataclasses.replace(self, page_table=pt, ref_count=ref,
                                  free_top=top)
        return cow._decref(dec)

    # -- writes -----------------------------------------------------------

    def _write(self, phys, slot, k_q, v_q):
        """K/V bytes into pages ``phys`` (the sink for dropped writes) at
        in-page slots ``slot``, in place."""
        phys, slot = phys.long(), slot.long()
        self.k[phys, slot] = k_q
        self.v[phys, slot] = v_q

    def prefill_write(self, k_q, v_q, lengths=None) -> "PagedKVState":
        """Bulk-write right-padded prompts for the whole batch (rows must
        be fresh, ``pos == 0``); only ``ceil(len / page_size)`` pages are
        allocated per row."""
        return self.write_prompts(k_q, v_q, lengths=lengths)

    def write_prompts(self, k_q, v_q, lengths=None,
                      slots=None) -> "PagedKVState":
        """``prefill_write`` into batch ``slots``: row ``i`` of
        ``k_q``/``v_q`` (n, S, G, hd) lands in slot ``slots[i]`` (negative
        = dummy row, dropped entirely). Pad columns and dummy rows write
        to the sink, so the parking page stays all-zero."""
        n, s = k_q.shape[:2]
        b, ps, dev = self.batch, self.page_size, self.pos.device
        if lengths is None:
            if s > self.capacity:
                raise ValueError(
                    f"paged prefill needs capacity >= prompt length "
                    f"(got S={s} > C={self.capacity}); grow max_len/window")
            new_pos = torch.full((n,), s, dtype=torch.int32, device=dev)
        else:
            new_pos = torch.clamp(torch.as_tensor(
                lengths, dtype=torch.int32, device=dev).reshape(n),
                max=self.capacity)
        if slots is None:
            if n != b:
                raise ValueError(f"full-batch prefill expects {b} rows, "
                                 f"got {n} (pass slots= for a partial one)")
            rows = self._ar(b)
            valid = torch.ones((n,), dtype=torch.bool, device=dev)
        else:
            rows = torch.as_tensor(slots, dtype=torch.int32,
                                   device=dev).reshape(n)
            valid = rows >= 0
            rows = torch.where(valid, rows, b)               # sink row
        new_pos = new_pos * valid.to(torch.int32)

        need = scatter_drop(torch.zeros_like(self.pos), (rows,),
                            _ceil_div(new_pos, ps))
        new = self._alloc(need)

        t = self._ar(s)
        cols = torch.clamp(t // ps, max=self.pages_per_seq - 1)
        phys = new.page_table[torch.clamp(rows, max=b - 1).long()][
            :, cols.long()]                                  # (n, s)
        real = valid[:, None] & (t[None, :] < new_pos[:, None])
        phys = torch.where(real, phys, self.num_pages)
        new._write(phys, (t % ps)[None, :].expand(n, s), k_q, v_q)
        pos = scatter_drop(self.pos, (rows,), new_pos)
        return dataclasses.replace(new, pos=pos)

    def decode_append(self, k_q, v_q, live=None) -> "PagedKVState":
        """Append ``s_new`` decode tokens per sequence: rows crossing a
        page boundary pop a fresh page off the free stack on the device;
        once a row has wrapped its window its pages are reused in place,
        like the ring. ``live`` masks dead slots (writes to the sink,
        ``pos`` frozen). A burst longer than the window writes only its
        surviving tail."""
        b, s_new = k_q.shape[:2]
        ps, cs = self.page_size, self.capacity
        if live is None:
            live = torch.ones((b,), dtype=torch.bool, device=self.pos.device)
        live_i = live.to(torch.int32)
        start = max(s_new - cs, 0)
        n_eff = s_new - start
        state = self._cow(self.pos + start, n_eff * live_i, n_eff)
        held = state.pages_held()
        want = torch.clamp(_ceil_div(state.pos + s_new, ps),
                           max=state.pages_per_seq)
        new = state._alloc((want - held) * live_i)

        toks = (state.pos[:, None] + start + self._ar(n_eff)[None, :]) % cs
        bidx = self._ar(b)[:, None].long()
        phys = new.page_table[bidx, (toks // ps).long()]     # (B, n_eff)
        phys = torch.where(live[:, None], phys, self.num_pages)
        new._write(phys, toks % ps, k_q[:, start:], v_q[:, start:])
        return dataclasses.replace(new, pos=_i32(state.pos + s_new * live_i))

    def append_chunk(self, k_q, v_q, n_new) -> "PagedKVState":
        """Append a per-row ragged chunk: row ``b`` writes its first
        ``n_new[b]`` of the ``S`` presented tokens at logical slots
        ``pos[b] .. pos[b] + n_new[b] - 1``, across page boundaries,
        popping fresh pages on the device like ``decode_append``. Columns
        past a row's count go to the sink, and each row's ``pos``
        advances by its own ``n_new``: the write of the mixed serve step."""
        b, s = k_q.shape[:2]
        ps, cs = self.page_size, self.capacity
        if s > cs:
            raise ValueError(
                f"append_chunk width {s} exceeds the per-sequence window "
                f"{cs}; split the chunk (serving sizes chunk <= capacity)")
        n_new = torch.clamp(torch.as_tensor(
            n_new, dtype=torch.int32, device=self.pos.device).reshape(b),
            0, s)
        state = self._cow(self.pos, n_new, s)
        held = state.pages_held()
        want = torch.clamp(_ceil_div(state.pos + n_new, ps),
                           max=state.pages_per_seq)
        new = state._alloc(want - held)

        cols = self._ar(s)[None, :]
        toks = (state.pos[:, None] + cols) % cs              # (B, S)
        bidx = self._ar(b)[:, None].long()
        real = cols < n_new[:, None]
        phys = torch.where(real, new.page_table[bidx, (toks // ps).long()],
                           self.num_pages)
        new._write(phys, toks % ps, k_q, v_q)
        return dataclasses.replace(new, pos=_i32(state.pos + n_new))

    # -- debug ------------------------------------------------------------

    def check_invariants(self, pins=None) -> None:
        """Host-side allocator invariant check (tests, and ``chip_smoke``
        after a serve; never on the hot path):

        * every physical page is on the free stack XOR referenced (held
          by >= 1 page-table prefix entry or pinned);
        * each page's ``ref_count`` equals its page-table references plus
          its ``pins`` entry (a ``(P,)`` array-like or ``{page: count}``);
        * the parking page is never referenced, never free-listed, and no
          row's held prefix points at it;
        * ``free_top`` lies in ``[0, num_pages - 1]`` and the free list
          holds no duplicates.

        Raises ``AssertionError`` naming the violated condition."""
        pt = self.page_table.cpu().numpy()
        ref = self.ref_count.cpu().numpy()
        held = self.pages_held().cpu().numpy()
        top = int(self.free_top)
        P = self.num_pages
        assert 0 <= top <= P - 1, f"free_top {top} outside [0, {P - 1}]"
        free = self.free_stack.cpu().numpy()[:top]
        free_set = set(free.tolist())
        assert len(free_set) == top, "free stack holds duplicate pages"
        assert PARKING_PAGE not in free_set, "parking page on free stack"

        counts = np.zeros(P, np.int64)
        for row in range(self.batch):
            pages = pt[row, :int(held[row])]
            assert PARKING_PAGE not in pages, (
                f"live row {row} points at the parking page: {pages}")
            np.add.at(counts, pages, 1)
        if pins is not None:
            if isinstance(pins, dict):
                for p, c in pins.items():
                    counts[p] += c
            else:
                counts += np.asarray(pins, np.int64)
        assert ref[PARKING_PAGE] == 0 and counts[PARKING_PAGE] == 0, \
            "parking page acquired a refcount"
        for p in range(1, P):
            assert ref[p] == counts[p], (
                f"page {p}: ref_count {ref[p]} != references {counts[p]}")
            assert (p in free_set) ^ (counts[p] >= 1), (
                f"page {p}: free={p in free_set}, references={counts[p]} "
                f"(every page must be free xor referenced)")


# ---------------------------------------------------------------------------
# Prefix index (host side)
# ---------------------------------------------------------------------------

class PrefixIndex:
    """Host map from prompt prefixes to the physical pages that hold their
    K/V bytes (``repro.attention.state.PrefixIndex``), behind serve-time
    prefix sharing.

    Entry ``j`` keys on a chain hash of the prompt's ``j``-th
    ``page_size``-token chunk and chunk ``j - 1``'s key, so a hit for page
    ``j`` means the whole leading ``(j + 1) * page_size`` tokens match; a
    lookup walks the chain and returns the longest registered prefix. One
    page id is valid for every layer's pool because the per-layer
    allocators run the same op sequence. The index holds one pin (+1
    refcount, ``PagedKVState.incref_pages``) per registered page;
    ``evict_lru`` hands back the oldest unprotected pages for the caller
    to unpin. A page's bytes are a function of its chunk's tokens and
    page-aligned position only, which the chain key encodes."""

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self._entries: dict = {}        # chain key -> physical page id
        self._page_key: dict = {}       # physical page id -> chain key

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def pinned_pages(self):
        """Every registered (pinned) physical page id."""
        return list(self._page_key)

    def _chain_keys(self, tokens, n_chunks: int):
        # blake2b, not hash(): hash() is salted per process, and a
        # restored index must resolve the same prompts in a new process
        toks = np.ascontiguousarray(np.asarray(tokens, np.int64).reshape(-1))
        prev = b"prefix-chain-v1:%d" % self.page_size   # chain seed
        keys = []
        for j in range(n_chunks):
            chunk = toks[j * self.page_size:(j + 1) * self.page_size]
            prev = hashlib.blake2b(prev + chunk.tobytes(),
                                   digest_size=16).digest()
            keys.append(prev.hex())
        return keys

    def lookup(self, tokens, max_tokens: int | None = None):
        """Physical page ids of the longest registered page-aligned prefix
        of ``tokens`` covering at most ``max_tokens`` tokens (possibly
        empty); the hits move to the young end of the LRU order."""
        n_tok = int(np.asarray(tokens).size)
        if max_tokens is not None:
            n_tok = min(n_tok, int(max_tokens))
        pages = []
        for key in self._chain_keys(tokens, n_tok // self.page_size):
            page = self._entries.get(key)
            if page is None:
                break
            del self._entries[key]                # LRU touch: re-insert
            self._entries[key] = page
            pages.append(page)
        return pages

    def register(self, tokens, page_ids):
        """Register the pages behind ``tokens``' leading full chunks
        (``page_ids[j]`` holds chunk ``j``). Known chunks are skipped;
        registration stops at the parking page or at a page that serves
        another key, so the chain stays walkable. Returns the newly
        indexed pages, which the caller pins before the donor releases
        them."""
        page_ids = [int(p) for p in np.asarray(page_ids).reshape(-1)]
        new = []
        for key, page in zip(self._chain_keys(tokens, len(page_ids)),
                             page_ids, strict=True):
            if page == PARKING_PAGE:
                break
            if key in self._entries:
                continue                          # chunk already indexed
            if page in self._page_key:
                break                             # page serves another key
            self._entries[key] = page
            self._page_key[page] = key
            new.append(page)
        return new

    def state_dict(self) -> dict:
        """A JSON-serializable snapshot, entries oldest first (the dict's
        insertion order is the LRU order)."""
        return {"page_size": self.page_size,
                "entries": [[key, int(page)]
                            for key, page in self._entries.items()]}

    def load_state_dict(self, state: dict) -> None:
        """Rebuild the index from ``state_dict()``; raises ``ValueError``
        on another page size (the chain seed depends on it)."""
        if int(state["page_size"]) != self.page_size:
            raise ValueError(
                f"prefix index snapshot has page_size "
                f"{state['page_size']}, pool uses {self.page_size}")
        self._entries, self._page_key = {}, {}
        for key, page in state["entries"]:
            self._entries[str(key)] = int(page)
            self._page_key[int(page)] = str(key)

    def evict_lru(self, n: int, protected=frozenset()):
        """Drop up to ``n`` least recently used entries whose page is not
        ``protected`` (pages an active request adopted keep their pin).
        Returns the evicted pages for the caller to unpin. Evicting a
        chain's head orphans its tail, which stays evictable."""
        evicted = []
        for key in list(self._entries):
            if len(evicted) >= n:
                break
            page = self._entries[key]
            if page in protected:
                continue
            del self._entries[key]
            del self._page_key[page]
            evicted.append(page)
        return evicted
