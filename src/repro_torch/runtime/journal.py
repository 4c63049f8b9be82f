"""Crash-safe serving (``repro.runtime.journal``): the write-ahead request
journal, graceful drain, and the serve -> crash -> restore -> continue
harness.

The journal is the durability backbone of ``serve_continuous(
journal_dir=...)``. It is an append-only JSONL write-ahead log: every
line is one record wrapped with a crc32 of its canonical encoding,
written in order once per segment boundary and fsynced on a bounded
group-commit cadence. A crash can only lose the suffix written after the
last flush: replay verifies each line's checksum and stops at the first
torn or corrupt line (write-ahead-log tail semantics), so recovery
resumes from a prefix of true history, never from garbage. The line
format is the JAX package's, byte for byte: a journal written by either
package replays in the other.

Record types (one JSON object per line):

- ``header``: the journal format version and the serve's fingerprint
  (arch, page size, max_len, temperature, sampling flag, eos/pad ids and
  the sampling ``key``: the serve's seed and its generators' device type,
  or None when greedy). Resuming under another fingerprint would change
  tokens, so ``serve_continuous`` refuses it.
- ``submit``: one per request: its stable ``request_id``, trace index,
  prompt digest, ``gen``, arrival and priority. Re-submission after
  recovery dedupes on the id; a digest mismatch means the id was reused
  for another request and is an error, not a dedupe.
- ``progress``: one per segment boundary: ``d`` maps each advanced
  request's id to its emitted tokens since its last record and, when
  sampling, ``k`` maps it to its generator's state after those draws
  (``torch.Generator.get_state()`` as a hex string). A request's
  generator advances exactly once per emitted token, so the journaled
  state is the one a resumed stream continues from, which makes sampled
  recovery bit-exact. Replay also accepts the single-request
  ``rid``/``toks``/``key`` form, the shape of hand-written journals.
- ``complete``: the request finished: its token count and the fields its
  ``CompletedRequest`` is rebuilt from on replay.

Recovery treats every unfinished journaled request as preempted at its
last flushed boundary: its pending stream is ``prompt ++ emitted`` with
the budget left and its journaled generator state, re-admitted through
the serve's ordinary preemption resume. Tokens the device produced after
the last flush are generated again, bit-identically, because a request's
tokens depend on the config, its prompt and its own sampling stream,
never on co-scheduled traffic.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import zlib

import numpy as np
import torch

JOURNAL_VERSION = 1

# the fingerprint fields that determine token values (not only the
# schedule): resuming with any of them changed would give other tokens
# than the crashed serve, so resume refuses
TOKEN_FINGERPRINT_KEYS = ("journal_version", "arch", "page_size",
                          "max_len", "temperature", "sample", "eos_id",
                          "pad_id", "key")


def _canonical(rec: dict) -> str:
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))


def prompt_digest(prompt) -> str:
    """Stable digest of a prompt's token ids (blake2b of the int32 bytes):
    the submit record's identity check for request-id dedupe."""
    toks = np.ascontiguousarray(np.asarray(prompt, np.int32).reshape(-1))
    return hashlib.blake2b(toks.tobytes(), digest_size=12).hexdigest()


def state_hex(state: torch.Tensor) -> str:
    """A ``torch.Generator.get_state()`` (a uint8 tensor) as the progress
    record's hex string."""
    return state.numpy().tobytes().hex()


def generator_state(text: str) -> torch.Tensor:
    """The ``torch.Generator`` state a progress record's hex string
    holds, for ``set_state``."""
    return torch.tensor(list(bytes.fromhex(text)), dtype=torch.uint8)


@dataclasses.dataclass
class JournalReplay:
    """Parsed journal state, keyed by request_id. ``truncated`` flags a
    torn or corrupt tail (the records after it were dropped: write-ahead
    log semantics, not an error)."""

    header: dict | None = None
    submits: dict = dataclasses.field(default_factory=dict)
    emitted: dict = dataclasses.field(default_factory=dict)
    keys: dict = dataclasses.field(default_factory=dict)
    completes: dict = dataclasses.field(default_factory=dict)
    n_records: int = 0
    truncated: bool = False


class ServeJournal:
    """Append-only JSONL write-ahead log with group commit: ``append``
    buffers on the host, ``flush`` encodes and appends the whole batch in
    one write (the serve flushes once per segment boundary). Records land
    in the file in append order, so a crash loses only a suffix, the torn
    tail replay tolerates.

    ``fsync`` runs every ``fsync_every``-th batch on one background
    thread (created at the first), so its latency overlaps the next
    segment's device work, and synchronously on ``close()``. Every batch
    reaches the OS at once; a power loss can cost at most ``fsync_every``
    segments of progress, which recovery generates again. ``wait()``
    blocks until the in-flight fsync is done: the barrier the crash
    injector takes before a simulated death, so the restart reads a
    settled file."""

    def __init__(self, path: str, fingerprint: dict | None = None,
                 fresh: bool = False, fsync: bool = True,
                 fsync_every: int = 16):
        self.path = path
        self.fsync = fsync
        self.fsync_every = max(1, fsync_every)
        self._batches = 0
        self._buf: list = []
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "w" if fresh else "a")
        self._pool = None
        self._pending = None
        if fingerprint is not None and self._f.tell() == 0:
            self.append({"t": "header", "version": JOURNAL_VERSION,
                         "fingerprint": fingerprint})
            self.flush()

    def append(self, rec: dict) -> None:
        self._buf.append(rec)

    def flush(self) -> None:
        """Write the buffered batch (group commit). Lines are encoded
        before the write, so a record mutated after the flush cannot
        change what landed; the fsync is scheduled on its cadence."""
        if not self._buf:
            return
        lines = []
        for rec in self._buf:
            canon = _canonical(rec)
            # the canonical record spliced into its wrapper: exactly
            # _canonical({"crc": ..., "rec": rec}) ("crc" sorts first)
            # at half the encoding cost
            lines.append('{"crc":%d,"rec":%s}'
                         % (zlib.crc32(canon.encode()), canon))
        self._buf = []
        self._f.write("\n".join(lines) + "\n")
        self._f.flush()
        self._batches += 1
        if self.fsync and self._batches % self.fsync_every == 0:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(max_workers=1)
            self._pending = self._pool.submit(os.fsync, self._f.fileno())

    def wait(self) -> None:
        """Block until the in-flight background fsync (if any) is done;
        the writes are synchronous, so after this the file holds every
        flushed batch."""
        if self._pending is not None:
            self._pending.result()

    def close(self) -> None:
        self.flush()
        self.wait()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._f.close()
        if self._pool is not None:
            self._pool.shutdown()

    # -- replay -------------------------------------------------------------

    @staticmethod
    def replay(path: str) -> JournalReplay:
        """Parse the journal, checking each line's crc32; stop at the
        first unparsable or failing line (the torn tail of a crash
        mid-write) and return everything before it."""
        out = JournalReplay()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                    rec = obj["rec"]
                    if zlib.crc32(_canonical(rec).encode()) != obj["crc"]:
                        raise ValueError("crc mismatch")
                except (ValueError, KeyError, TypeError):
                    out.truncated = True
                    break
                out.n_records += 1
                t = rec.get("t")
                if t == "header":
                    out.header = rec
                elif t == "submit":
                    out.submits[rec["rid"]] = rec
                elif t == "progress":
                    if "rid" in rec:        # single-request form
                        out.emitted.setdefault(rec["rid"], []).extend(
                            rec["toks"])
                        if "key" in rec:
                            out.keys[rec["rid"]] = rec["key"]
                    else:                   # batched: one per boundary
                        for rid, tk in rec["d"].items():
                            out.emitted.setdefault(rid, []).extend(tk)
                        for rid, key in rec.get("k", {}).items():
                            out.keys[rid] = key
                elif t == "complete":
                    out.completes[rec["rid"]] = rec
        return out


def check_fingerprint(journal_fp: dict, current_fp: dict) -> None:
    """Refuse to resume a journal whose token-affecting fingerprint
    differs from this serve's: continuing would generate tokens the
    crashed serve never would have."""
    for k in TOKEN_FINGERPRINT_KEYS:
        if journal_fp.get(k) != current_fp.get(k):
            raise ValueError(
                f"journal fingerprint mismatch on {k!r}: journal has "
                f"{journal_fp.get(k)!r}, this serve has "
                f"{current_fp.get(k)!r} — resuming would change tokens; "
                f"start a fresh journal (resume=False) instead")


# ---------------------------------------------------------------------------
# Graceful drain
# ---------------------------------------------------------------------------

class ServeDrain:
    """Cooperative shutdown signal for ``serve_continuous``: once
    requested (a SIGTERM handler, or at a virtual step with
    ``after_steps``), the serve stops admitting and lets in-flight
    requests finish (past ``drain_timeout`` it stops at the next boundary
    with their progress journaled), then flushes the journal and takes a
    final snapshot."""

    def __init__(self, after_steps: int | None = None):
        self.after_steps = after_steps
        self._requested = False

    def request(self) -> None:
        self._requested = True

    def poll(self, step: int) -> bool:
        return self._requested or (self.after_steps is not None
                                   and step >= self.after_steps)


# ---------------------------------------------------------------------------
# Crash/restart harness
# ---------------------------------------------------------------------------

def serve_with_recovery(model, cfg, requests, *, journal_dir: str,
                        plans=(), max_restarts: int = 8, resume=False,
                        **kw):
    """Run ``serve_continuous`` under injected crashes until the trace
    completes: each ``SimulatedCrash`` abandons the serve's in-memory
    state (as a process death would) and restarts it with ``resume=True``
    over the same journal directory. Only ``SimulatedCrash`` is caught.

    ``plans`` holds one ``ServeFaultPlan`` per attempt: attempt ``k``
    runs under ``plans[k]`` (None past the end). Returns ``(result,
    crashes)``: the last ``ServeResult`` (replayed completions included)
    and how many crashes were survived."""
    from repro_torch.runtime.fault_tolerance import SimulatedCrash
    from repro_torch.runtime.generate import serve_continuous

    crashes = 0
    while True:
        plan = plans[crashes] if crashes < len(plans) else None
        try:
            res = serve_continuous(model, cfg, requests,
                                   journal_dir=journal_dir, resume=resume,
                                   faults=plan, **kw)
            return res, crashes
        except SimulatedCrash:
            crashes += 1
            if crashes > max_restarts:
                raise
            resume = True
