"""Typed int8 KV ring-buffer state (``repro.attention.state.KVCacheState``).

Layout: ``k``/``v`` are ``(B, C, G, hd)`` with capacity ``C`` a ring —
token ``t`` lives in slot ``t % C``. ``pos`` is per sequence, ``(B,)``
int32: each row tracks its own stream length, so a ragged batch shares one
cache and one kernel call. ``valid_len`` and ``q_offset`` derive from
``pos`` and flow through ``dispatch`` into the per-row kernel meta.

The JAX state is immutable; the port writes K/V into the ring buffers in
place (no copy of the whole ring per step) and returns a state that
shares them, with a fresh ``pos``. The paged pool (``PagedKVState``) and
``decode_append(live=...)`` come with the continuous-batching slice; the
per-head cache scales of ``repro.runtime.kv_cache`` with that module.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.common import MIN_BLOCK_KV


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

    @classmethod
    def init(cls, batch: int, capacity: int, n_kv_heads: int, head_dim: int,
             dtype=torch.int8, device="cpu") -> "KVCacheState":
        """Fresh (zeroed) ring-buffer cache, capacity block-aligned above
        one KV block."""
        capacity = _align_capacity(capacity)
        shape = (batch, capacity, n_kv_heads, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=torch.zeros((batch,), dtype=torch.int32,
                                   device=device))

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
        so no two writes hit one slot."""
        if live is not None:
            raise NotImplementedError(
                "decode_append(live=...) masks dead continuous-batching "
                "slots; it comes with serve_continuous in the next slice "
                "of the port")
        b, s_new = k_q.shape[:2]
        cs = self.capacity
        start = max(s_new - cs, 0)
        ar = torch.arange(s_new - start, dtype=torch.int64,
                          device=self.pos.device)
        slots = (self.pos.long()[:, None] + start + ar[None, :]) % cs
        bidx = torch.arange(b, device=self.pos.device)[:, None]
        self.k[bidx, slots] = k_q[:, start:]
        self.v[bidx, slots] = v_q[:, start:]
        return dataclasses.replace(self, pos=self.pos + s_new)
