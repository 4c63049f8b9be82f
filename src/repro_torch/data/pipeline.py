"""Token data pipeline (``repro.data.pipeline``).

Two sources:
- ``SyntheticSource`` — deterministic tokens from (seed, position), the
  JAX package's numpy mix bit for bit: infinitely repeatable and
  resumable by construction.
- ``MemmapSource`` — a local flat uint16/uint32 token file (a tokenized
  corpus) read as windows without loading it into memory.

``DataPipeline`` cuts the source into ``(batch, seq_len + 1)`` windows,
one per step, and puts them on its device; with ``mesh=`` as DTensors
placed by ``launch.sharding.batch_shardings`` (every rank cuts the same
global batch and keeps its chunk, so the global batch does not depend on
the mesh). Its state is one integer, the step, so checkpointing the
pipeline is checkpointing that integer, and a restart replays the same
global step exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


class SyntheticSource:
    """Deterministic pseudo-corpus: token[i] = mix(seed, i) mod vocab."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab = vocab_size
        self.seed = seed

    def window(self, start: int, n: int) -> np.ndarray:
        idx = (np.arange(start, start + n, dtype=np.uint64)
               + np.uint64(self.seed) * np.uint64(0x9E3779B97F4A7C15))
        idx ^= idx >> np.uint64(33)
        idx *= np.uint64(0xFF51AFD7ED558CCD)
        idx ^= idx >> np.uint64(33)
        return (idx % np.uint64(self.vocab)).astype(np.int32)


class MemmapSource:
    """Windows of a local token file; a window past the end wraps to
    ``start mod (len - n)``, as the reference's does."""

    def __init__(self, path: str, vocab_size: int, dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab = vocab_size

    def window(self, start: int, n: int) -> np.ndarray:
        start = start % max(len(self.tokens) - n, 1)
        return np.asarray(self.tokens[start:start + n], dtype=np.int32)


@dataclasses.dataclass
class PipelineState:
    step: int = 0


class DataPipeline:
    """Yields ``{"tokens": (B, S+1) int32}`` batches on ``device`` (the
    card unless the caller asks for the CPU), with ``"frontend"`` (B,
    *frontend_shape) float32 — zeros plus a linspace over the last axis,
    the reference's stand-in — when ``frontend_shape`` is given. With
    ``mesh`` (and the config's ``parallelism``) the batches are DTensors
    over it."""

    def __init__(self, source, batch: int, seq_len: int, device="cuda",
                 frontend_shape=None, mesh=None, parallelism="tp_fsdp"):
        self.source = source
        self.batch = batch
        self.seq = seq_len
        self.device = resolve_device(device)
        self.frontend_shape = frontend_shape
        self.mesh = mesh
        self.parallelism = parallelism
        self.state = PipelineState()

    def _put(self, host: np.ndarray):
        t = torch.from_numpy(host).to(self.device)
        if self.mesh is None:
            return t
        from repro_torch.launch.sharding import Sharding, batch_spec, place
        return place(t, Sharding(self.mesh, batch_spec(
            t.shape, self.mesh, self.parallelism)))

    def _host_batch(self, step: int) -> np.ndarray:
        span = self.batch * (self.seq + 1)
        flat = self.source.window(step * span, span)
        return flat.reshape(self.batch, self.seq + 1)

    def next(self) -> dict:
        batch = {"tokens": self._put(self._host_batch(self.state.step))}
        if self.frontend_shape is not None:
            fe = np.zeros((self.batch,) + tuple(self.frontend_shape),
                          np.float32)
            fe += np.linspace(0, 1, fe.shape[-1], dtype=np.float32)
            batch["frontend"] = self._put(fe)
        self.state.step += 1
        return batch

    # -- checkpointable state --------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.state.step}

    def load_state_dict(self, d: dict):
        self.state.step = int(d["step"])
