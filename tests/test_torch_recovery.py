"""Crash-safe serving in the port — the write-ahead journal, snapshots of
the pools and the prefix index, bit-exact recovery and graceful drain —
against the JAX package, on the CPU, on ``tests/test_recovery.py``'s
``recovery-smoke`` config and traces (weights made by the JAX package
and loaded with ``from_jax_params``; 128-token pages, the onepass pin).

- Greedy crash recovery is held to the JAX package's recovery: killed at
  every admission-round boundary and at every mid-segment point (after
  the readback, before the journal flush), alone, twice in one trace, and
  with prefix sharing, preemption and a snapshot every segment (a warm
  restore), the port's recovered tokens, scheduler counters,
  ``recovered``, ``restored_from_snapshot`` and ``replayed_tokens`` equal
  the JAX serve's, and the two journals hold the same records in the
  same order (wall-clock fields left out); the tokens equal the calm
  serve's.
- Sampled recovery, a corrupt snapshot's cold start, a finished journal
  replayed without a step (also one the JAX package wrote), request-id
  reuse and duplicates, a torn ``complete`` record, drain then resume and
  the drain timeout are held to the port's own calm serve (torch
  generators are not JAX keys, ``launch/steps.py``), each with the
  reference's expectation.

The reference runs with an exact ``exp2`` (``tests/test_torch_kernels.py``,
ROADMAP §C).
"""

import json
import os
import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.configs.base import ModelConfig as JConfig
from repro.models import init_model as j_init_model
from repro.runtime import journal as J
from repro.runtime.fault_tolerance import ServeFaultPlan as JPlan
from repro.runtime.generate import ServeRequest as JRequest
from repro.runtime.generate import serve_continuous as j_serve
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.launch.steps import tree_leaves
from repro_torch.models import from_jax_params, init_caches
from repro_torch.runtime.fault_tolerance import ServeFaultPlan, SimulatedCrash
from repro_torch.runtime.generate import ServeRequest, serve_continuous
from repro_torch.runtime.journal import ServeDrain, serve_with_recovery

_CFG = dict(name="recovery-smoke", family="dense", d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
            layer_groups=((("attn",), 2),), dtype="float32",
            attention_impl="ita", attention_backend="ita_onepass_pallas")
JCFG, CFG = JConfig(**_CFG), TConfig(**_CFG)
KW = dict(slots=3, segment=4, max_len=128, page_size=128, chunk_size=5,
          debug_invariants=True)
PREFIX_KW = dict(slots=3, segment=4, max_len=256, page_size=128,
                 chunk_size=48, prefix_sharing=True, debug_invariants=True)
HELD = ("steps", "segments", "admission_rounds", "prefill_tokens",
        "shared_prefix_tokens", "prefix_hits", "preemptions", "recovered",
        "restored_from_snapshot", "replayed_tokens")
WALL = ("arrived_s", "finished_s", "first_token_s")


@pytest.fixture(scope="module", autouse=True)
def exact_exp2():
    """Run the reference with exact powers of two (module docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "exp2", lambda x: jnp.ldexp(
            jnp.ones(jnp.shape(x), jnp.float32),
            jnp.asarray(x).astype(jnp.int32)))
        jax.clear_caches()
        yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def weights(exact_exp2):
    params = j_init_model(jax.random.PRNGKey(0), JCFG)
    model = from_jax_params(jax.tree.map(np.asarray, params), CFG,
                            device="cpu")
    return params, model


def _trace(n=7, seed=3):
    prng = np.random.default_rng(seed)
    reqs, step = [], 0
    for _ in range(n):
        plen = int(prng.integers(3, 13))
        reqs.append(ServeRequest(
            prompt=prng.integers(0, CFG.vocab_size, plen).astype(np.int32),
            gen=int(prng.integers(1, 10)), arrival=step))
        step += int(prng.integers(0, 4))
    return reqs


def _prefix_trace(n, priority=False):
    shared = np.arange(200, dtype=np.int32) % CFG.vocab_size
    return [ServeRequest(
        prompt=np.concatenate([shared[:140], np.full(4, i, np.int32)]),
        gen=6, arrival=i * 2, priority=i % 2 if priority else 0)
        for i in range(n)]


def _tokens(res):
    return {c.index: np.asarray(c.tokens) for c in res.completed}


def _assert_same_tokens(res, want, msg=""):
    got = _tokens(res)
    assert set(got) == set(want), (msg, sorted(got), sorted(want))
    for i in got:
        np.testing.assert_array_equal(
            got[i], want[i], err_msg=f"{msg}: request {i} diverged")


def _serve(model, reqs, **kw):
    return serve_continuous(model, CFG, reqs, device="cpu", **{**KW, **kw})


def _records(journal_dir):
    """The journal's records, wall-clock fields left out."""
    with open(os.path.join(journal_dir, "journal.jsonl")) as f:
        return [{k: v for k, v in json.loads(line)["rec"].items()
                 if k not in WALL} for line in f]


def recover_both(weights, reqs, tmp_path, plans, **kw):
    """``serve_with_recovery`` of ``reqs`` under ``plans`` in the port and
    in the JAX package, held together: crashes, tokens, counters and
    recovery fields, and the journals record for record. Returns the
    port's ``(result, crashes)``."""
    params, model = weights
    kw = {**KW, **kw}
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jres, jcrashes = J.serve_with_recovery(
        params, JCFG, [JRequest(r.prompt, r.gen, r.arrival, r.priority)
                       for r in reqs], journal_dir=jd,
        plans=tuple(JPlan(**vars(p)) for p in plans), **kw)
    res, crashes = serve_with_recovery(model, CFG, reqs, journal_dir=td,
                                       plans=plans, device="cpu", **kw)
    assert crashes == jcrashes
    for name in HELD:
        assert getattr(res, name) == getattr(jres, name), name
    _assert_same_tokens(res, _tokens(jres), "port vs JAX recovery")
    assert [c.replayed for c in res.completed] \
        == [c.replayed for c in jres.completed]
    assert _records(td) == _records(jd)
    return res, crashes


@pytest.fixture(scope="module")
def calm(weights):
    """The calm serve of the default trace, the port's (tokens equal the
    JAX package's calm serve)."""
    params, model = weights
    reqs = _trace()
    res = _serve(model, reqs)
    jres = j_serve(params, JCFG, [JRequest(r.prompt, r.gen, r.arrival)
                                  for r in reqs], **KW)
    _assert_same_tokens(res, _tokens(jres), "calm port vs JAX")
    return reqs, res


# ---------------------------------------------------------------------------
# Greedy: held to the JAX package's recovery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["crash_steps", "crash_after_steps"])
def test_crash_sweep_greedy_every_boundary(weights, calm, tmp_path, kind):
    """Killed at every round boundary (``crash_steps``) or every
    mid-segment point (``crash_after_steps``), the restart completes the
    trace as the calm serve and as the JAX package's recovery."""
    reqs, res = calm
    want = _tokens(res)
    boundaries = list(range(KW["segment"], res.steps, KW["segment"]))
    assert len(boundaries) >= 3                    # the sweep has points
    for at in boundaries:
        got, crashes = recover_both(
            weights, reqs, tmp_path / f"{kind}-{at}",
            (ServeFaultPlan(**{kind: (at,)}),))
        assert crashes == 1 and got.recovered, (kind, at)
        _assert_same_tokens(got, want, f"{kind}@{at}")


def test_crash_recovery_double_crash(weights, tmp_path):
    """A boundary crash, then a mid-segment crash of the restart: each
    restart recovers the journal of the one before."""
    _, model = weights
    reqs = _trace(seed=9)
    res, crashes = recover_both(
        weights, reqs, tmp_path, (ServeFaultPlan(crash_steps=(4,)),
                                  ServeFaultPlan(crash_after_steps=(12,))))
    assert crashes == 2
    _assert_same_tokens(res, _tokens(_serve(model, reqs)), "double crash")


def test_crash_recovery_prefix_preemption_snapshot(weights, tmp_path):
    """Prefix sharing, priority preemption and a snapshot every segment:
    the restart restores the pools and the prefix index (a warm start)
    and equals the calm serve and the JAX package's recovery."""
    _, model = weights
    reqs = _prefix_trace(5, priority=True)
    kw = dict(PREFIX_KW, preemption=True)
    calm = _serve(model, reqs, **kw)
    assert calm.prefix_hits > 0
    res, crashes = recover_both(weights, reqs, tmp_path,
                                (ServeFaultPlan(crash_steps=(12,)),),
                                snapshot_every=1, **kw)
    assert crashes == 1
    assert res.restored_from_snapshot and res.prefix_hits > 0
    pools = init_caches(CFG, kw["slots"], kw["max_len"], paged=True,
                        page_size=kw["page_size"], device="cpu")
    assert res.snapshot_bytes == sum(t.numel() * t.element_size()
                                     for t in tree_leaves(pools))
    assert res.snapshots > 0 and res.snapshot_s > 0
    _assert_same_tokens(res, _tokens(calm), "prefix+preempt+snapshot")


# ---------------------------------------------------------------------------
# Held to the port's own calm serve
# ---------------------------------------------------------------------------

def test_crash_recovery_sampled_bit_exact(weights, tmp_path):
    """Sampled serving resumes from the journaled generator states: the
    draws continue where the crashed serve left off, for both kinds."""
    _, model = weights
    reqs = _trace(seed=5)
    kw = dict(temperature=0.8, seed=7)
    want = _tokens(_serve(model, reqs, **kw))
    for kind in ("crash_steps", "crash_after_steps"):
        d = str(tmp_path / kind)
        res, crashes = serve_with_recovery(
            model, CFG, reqs, journal_dir=d, device="cpu",
            plans=(ServeFaultPlan(**{kind: (8,)}),), **KW, **kw)
        assert crashes == 1 and res.replayed_tokens > 0
        _assert_same_tokens(res, want, f"sampled {kind}")
        keys = J.ServeJournal.replay(os.path.join(d, "journal.jsonl")).keys
        assert keys and all(isinstance(k, str) for k in keys.values())


def test_max_restarts_reraises(weights, tmp_path):
    """A crash loop past the restart budget raises the SimulatedCrash."""
    _, model = weights
    plans = tuple(ServeFaultPlan(crash_steps=(0,)) for _ in range(4))
    with pytest.raises(SimulatedCrash):
        serve_with_recovery(model, CFG, _trace(n=3),
                            journal_dir=str(tmp_path / "j"), plans=plans,
                            max_restarts=2, device="cpu", **KW)


def test_corrupt_snapshot_degrades_to_cold_start(weights, tmp_path):
    """A flipped byte in the newest snapshot's first leaf fails its
    checksum: the restart starts cold from the journal alone, with the
    calm serve's tokens."""
    _, model = weights
    reqs = _prefix_trace(4)
    calm = _serve(model, reqs, **PREFIX_KW)
    d = str(tmp_path / "j")
    with pytest.raises(SimulatedCrash):
        _serve(model, reqs, journal_dir=d, snapshot_every=1,
               faults=ServeFaultPlan(crash_steps=(12,)), **PREFIX_KW)
    snaps = sorted(os.listdir(os.path.join(d, "snapshots")))
    assert snaps, "crash before any snapshot"
    leaf = os.path.join(d, "snapshots", snaps[-1], "leaf_00000.npy")
    raw = bytearray(open(leaf, "rb").read())
    raw[-1] ^= 0xFF
    open(leaf, "wb").write(bytes(raw))
    res = _serve(model, reqs, journal_dir=d, resume=True, snapshot_every=1,
                 **PREFIX_KW)
    assert res.recovered and not res.restored_from_snapshot
    _assert_same_tokens(res, _tokens(calm), "corrupt snapshot")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resume_finished_journal_replays_everything(weights, calm, tmp_path,
                                                    writer):
    """Resuming over a finished journal serves nothing: every request
    comes back replayed with its tokens, zero steps. A journal the JAX
    package wrote replays the same way."""
    params, model = weights
    reqs, first = calm
    d = str(tmp_path / "j")
    if writer == "port":
        first = _serve(model, reqs, journal_dir=d)
    else:
        j_serve(params, JCFG, [JRequest(r.prompt, r.gen, r.arrival)
                               for r in reqs], journal_dir=d, **KW)
    again = _serve(model, reqs, journal_dir=d, resume=True)
    assert again.steps == 0 and again.segments == 0 and again.recovered
    assert all(c.replayed for c in again.completed)
    _assert_same_tokens(again, _tokens(first), "idempotent replay")
    assert again.replayed_tokens == sum(len(c.tokens)
                                        for c in first.completed)


def test_request_id_reuse_for_different_request_is_error(weights,
                                                         tmp_path):
    _, model = weights
    d = str(tmp_path / "j")
    prng = np.random.default_rng(0)
    reqs = [ServeRequest(prompt=prng.integers(0, 128, 5).astype(np.int32),
                         gen=3, arrival=0, request_id="fixed-id")]
    _serve(model, reqs, journal_dir=d)
    other = [ServeRequest(prompt=prng.integers(0, 128, 7).astype(np.int32),
                          gen=3, arrival=0, request_id="fixed-id")]
    with pytest.raises(ValueError, match="reused"):
        _serve(model, other, journal_dir=d, resume=True)


def test_duplicate_request_ids_in_trace_rejected(weights, tmp_path):
    _, model = weights
    prng = np.random.default_rng(0)
    reqs = [ServeRequest(prompt=prng.integers(0, 128, 5).astype(np.int32),
                         gen=2, arrival=0, request_id="dup")
            for _ in range(2)]
    with pytest.raises(ValueError, match="duplicate"):
        _serve(model, reqs, journal_dir=str(tmp_path / "j"))


def test_torn_complete_without_progress_falls_back_to_resume(weights,
                                                             tmp_path):
    """A journal whose complete record survived but whose progress lines
    for that request were lost: replay does not trust the complete
    record, and the request is served again to the calm tokens."""
    _, model = weights
    reqs = _trace(n=3, seed=11)
    calm = _serve(model, reqs)
    d = str(tmp_path / "j")
    _serve(model, reqs, journal_dir=d)
    jpath = os.path.join(d, "journal.jsonl")
    kept, tore = [], False
    for ln in open(jpath).read().splitlines():
        rec = json.loads(ln)["rec"]
        if rec.get("t") == "progress" and "req-000000" in rec.get("d", {}):
            tore = True
            del rec["d"]["req-000000"]
            rec.get("k", {}).pop("req-000000", None)
            if not rec["d"]:
                continue
        canon = json.dumps(rec, sort_keys=True, separators=(",", ":"))
        kept.append(json.dumps({"crc": zlib.crc32(canon.encode()),
                                "rec": rec}))
    assert tore
    with open(jpath, "w") as f:
        f.write("\n".join(kept) + "\n")
    res = _serve(model, reqs, journal_dir=d, resume=True)
    assert res.steps > 0
    _assert_same_tokens(res, _tokens(calm), "torn complete")


# ---------------------------------------------------------------------------
# Graceful drain
# ---------------------------------------------------------------------------

def test_drain_finishes_inflight_then_resume_serves_rest(weights, calm,
                                                         tmp_path):
    """A drain without timeout stops admission and finishes in-flight
    requests; a resume serves the rest; the union equals the calm serve
    and nothing is served twice."""
    _, model = weights
    reqs, res = calm
    want = _tokens(res)
    d = str(tmp_path / "j")
    drained = _serve(model, reqs, journal_dir=d,
                     drain=ServeDrain(after_steps=8))
    assert drained.drained
    done = _tokens(drained)
    assert 0 < len(done) < len(reqs)
    for i in done:
        np.testing.assert_array_equal(done[i], want[i])
    rest = _serve(model, reqs, journal_dir=d, resume=True)
    _assert_same_tokens(rest, want, "post-drain resume")
    served_again = {c.index for c in rest.completed if not c.replayed}
    assert served_again.isdisjoint(done)


def test_drain_timeout_stops_midflight_progress_journaled(weights,
                                                          tmp_path):
    """A drain with a zero timeout stops at the next boundary with work
    in flight; its journaled progress lets a resume finish it."""
    _, model = weights
    reqs = _trace(seed=13)
    calm = _serve(model, reqs)
    d = str(tmp_path / "j")
    drained = _serve(model, reqs, journal_dir=d,
                     drain=ServeDrain(after_steps=8), drain_timeout=0.0)
    assert drained.drained and len(drained.completed) < len(reqs)
    rest = _serve(model, reqs, journal_dir=d, resume=True)
    assert rest.recovered
    _assert_same_tokens(rest, _tokens(calm), "timeout drain resume")


def test_serve_cli_journal_flags_reach_the_serve(tmp_path):
    """``--journal-dir``, ``--snapshot-every`` and ``--resume`` reach
    ``serve_continuous`` (on the CPU, as asked): the resumed run replays
    every request of the journaled one without a step, from its snapshot.
    The SIGTERM drain handler is removed again when the serve returns."""
    import signal

    from repro_torch.launch import serve
    d = str(tmp_path / "j")
    argv = ["--smoke", "--device", "cpu", "--continuous", "--requests", "3",
            "--batch", "2", "--prompt-len", "12", "--gen", "4",
            "--system-prompt-len", "128", "--prefix-sharing",
            "--journal-dir", d, "--snapshot-every", "1",
            "--drain-timeout", "5"]
    handler = signal.getsignal(signal.SIGTERM)
    first = serve.main(argv)
    assert signal.getsignal(signal.SIGTERM) is handler
    assert not first.recovered and first.snapshots > 0
    again = serve.main(argv + ["--resume"])
    assert again.recovered and again.restored_from_snapshot
    assert again.steps == 0 and all(c.replayed for c in again.completed)
    _assert_same_tokens(again, _tokens(first), "CLI resume")
