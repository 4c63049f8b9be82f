"""The port's paged KV pool and paged attention kernels against the JAX
package, on the CPU.

- ``PagedKVState``: every operation of this slice (``init``,
  ``write_prompts``/``prefill_write``, ``decode_append(live=)`` across
  page boundaries and through the wrap, ``append_chunk`` straddling pages
  with ragged ``n_new`` including 0, ``release`` and reallocation) is run
  on both packages from the same inputs, and every field is compared bit
  for bit (the port's arena without its sink page). The parking page
  stays all-zero. A seeded random op sequence checks the allocator
  invariants after every op.
- The plain versions of the paged kernels (B3 ``ita_attention_onepass_
  paged``, B4p ``ita_attention_decode_paged``) and ``fused_attention(
  page_table=, q_lens=)`` equal the JAX package's (Pallas in interpret
  mode) on the int8 grid, over permuted page tables, GQA, windows and
  both DIs, and equal the ring kernels on the gathered pages.
- The ``bhsd_paged``/``ragged_q`` verdicts of every ported backend equal
  the JAX package's.

The reference runs with an exact ``exp2`` (``tests/test_torch_kernels.py``,
ROADMAP §C). The CUDA kernels are held to these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import attention as JATT
from repro.attention import PagedKVState as JPaged
from repro.kernels.ita_attention import kernel as JK
from repro.kernels.ita_attention import ops as JO
from repro_torch import attention as TATT
from repro_torch.attention import PagedKVState as TPaged
from repro_torch.kernels.ita_attention import kernel as TK
from repro_torch.kernels.ita_attention import ops as TO

S_Q, S_OUT = np.float32(0.05), np.float32(0.02)
FIELDS = ("page_table", "pos", "free_stack", "free_top", "ref_count")


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


def _t(a):
    return torch.from_numpy(np.array(a))


def _i8(rng, *shape):
    return rng.integers(-128, 128, shape, dtype=np.int8)


def _same(j, t, what):
    """Every field of the JAX and the port state, bit for bit."""
    p = j.k.shape[0]
    assert t.num_pages == p and t.k.shape[0] == p + 1, what
    np.testing.assert_array_equal(np.asarray(j.k), t.k[:p].numpy(),
                                  err_msg=f"{what}: k")
    np.testing.assert_array_equal(np.asarray(j.v), t.v[:p].numpy(),
                                  err_msg=f"{what}: v")
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy(),
                                      err_msg=f"{what}: {f}")
    assert not t.k[0].any() and not t.v[0].any(), \
        f"{what}: parking page written"


_JITTED = {}


def _jax_op(name, kw_names):
    """The JAX state method ``name`` jitted (eager dispatch of every small
    op would dominate the test's time)."""
    key = (name, kw_names)
    if key not in _JITTED:
        def call(state, arrays, kw):
            return getattr(state, name)(*arrays, **kw)
        _JITTED[key] = jax.jit(call)
    return _JITTED[key]


class _Both:
    """One JAX and one port state, driven with the same inputs."""

    def __init__(self, *args, **kw):
        self.j = JPaged.init(*args, **kw)
        self.t = TPaged.init(*args, device="cpu", **kw)
        _same(self.j, self.t, "init")

    def op(self, name, *arrays, what=None, **kw):
        kw = {k: v for k, v in kw.items() if v is not None}
        self.j = _jax_op(name, tuple(sorted(kw)))(
            self.j, tuple(jnp.asarray(a) for a in arrays),
            {k: jnp.asarray(v) for k, v in kw.items()})
        self.t = getattr(self.t, name)(*(_t(a) for a in arrays),
                                       **{k: _t(v) for k, v in kw.items()})
        _same(self.j, self.t, what or name)


@pytest.mark.parametrize("page,cap,num_pages", [
    (8, 32, None),        # fully provisioned: 3 x 4 pages + parking
    (4, 12, 9),           # undersized pool, 3 pages per sequence
])
def test_paged_state_ops_match_jax(page, cap, num_pages):
    rng = np.random.default_rng(page + cap)
    b, g, hd = 3, 2, 4
    s = _Both(b, cap, g, hd, page_size=page, num_pages=num_pages)
    pre = _i8(rng, b, 6, g, hd)
    lens = np.asarray([5, 0, 3], np.int32)
    s.op("prefill_write", pre, pre, lengths=lens)
    # masked decode appends across page boundaries and through the wrap
    for t in range(cap + 6):
        tok = _i8(rng, b, 1, g, hd)
        live = np.asarray([True, t % 3 != 0, t < 4])
        s.op("decode_append", tok, tok, live=live, what=f"decode {t}")
    s.op("release", np.asarray([False, True, True]))
    # ragged chunks straddling pages; a dead row (n_new 0)
    for n_new in ([0, 3, page + 2], [0, page + 1, 1]):
        chunk = _i8(rng, b, page + 3, g, hd)
        s.op("append_chunk", chunk, chunk, np.asarray(n_new, np.int32),
             what=f"append_chunk {n_new}")
    # release, then reallocation into the freed slot (a dummy row too)
    s.op("release", np.asarray([False, True, False]))
    fresh = _i8(rng, 2, 7, g, hd)
    s.op("write_prompts", fresh, fresh, lengths=np.asarray([7, 5]),
         slots=np.asarray([1, -1], np.int32), what="write_prompts")
    tok = _i8(rng, b, 1, g, hd)
    s.op("decode_append", tok, tok, what="decode, no live mask")
    s.t.check_invariants()
    assert not bool(s.t.oversubscribed())


def test_allocator_partition_property_seeded():
    """A random interleaving of admissions, masked appends, ragged chunks
    and (repeated) releases: the port's allocator equals the JAX
    package's after every op, and its invariants hold throughout."""
    b, g, hd, page, cap = 4, 1, 4, 4, 16
    rng = np.random.default_rng(7)
    s = _Both(b, cap, g, hd, page_size=page,
              num_pages=b * (cap // page) + 1)
    active = np.zeros(b, bool)
    for op in range(60):
        kind = rng.integers(0, 4)
        if kind == 0:                              # admit into a free row
            free = np.flatnonzero(~active)
            if free.size:
                row = int(rng.choice(free))
                ln = int(rng.integers(1, cap + 1))
                tok = _i8(rng, 1, ln, g, hd)
                s.op("write_prompts", tok, tok, lengths=np.asarray([ln]),
                     slots=np.asarray([row], np.int32), what=f"op {op}")
                active[row] = True
        elif kind == 1 and active.any():           # masked decode append
            live = active & (rng.random(b) < 0.8)
            tok = _i8(rng, b, 1, g, hd)
            s.op("decode_append", tok, tok, live=live, what=f"op {op}")
        elif kind == 2 and active.any():           # ragged chunk
            n_new = np.where(active, rng.integers(0, 6, b), 0)
            tok = _i8(rng, b, 5, g, hd)
            s.op("append_chunk", tok, tok, n_new.astype(np.int32),
                 what=f"op {op}")
        elif kind == 3 and active.any():           # release, twice
            fin = active & (rng.random(b) < 0.4)
            if fin.any():
                s.op("release", fin, what=f"op {op}")
                active &= ~fin
                top = int(s.t.free_top)
                s.op("release", fin, what=f"op {op} again")
                assert int(s.t.free_top) == top, f"op {op}: double release"
        assert not bool(s.t.oversubscribed()), f"op {op}: pool overdrawn"
        s.t.check_invariants()


def test_write_prompts_dummy_rows_keep_parking_pristine():
    rng = np.random.default_rng(1)
    b, g, hd, page, cap = 3, 2, 4, 8, 16
    p = TPaged.init(b, cap, g, hd, page_size=page, device="cpu")
    a = _t(_i8(rng, 2, 12, g, hd))
    p = p.write_prompts(a, a, lengths=_t([12, 7]), slots=_t([0, 2]))
    snap = p.k[:p.num_pages].clone()
    dummy = _t(_i8(rng, 2, 12, g, hd))
    p2 = p.write_prompts(dummy, dummy, lengths=_t([12, 9]),
                         slots=_t([-1, -1]))
    assert torch.equal(p2.k[:p.num_pages], snap), "dummy rows wrote bytes"
    assert torch.equal(p2.pos, p.pos) and int(p2.free_top) == int(p.free_top)
    assert not p2.k[0].any(), "parking page written"
    p2.check_invariants()


def test_ring_decode_append_live_matches_jax():
    rng = np.random.default_rng(2)
    b, cap, g, hd = 3, 8, 2, 4
    j = JATT.KVCacheState.init(b, cap, g, hd)
    t = TATT.KVCacheState.init(b, cap, g, hd, device="cpu")
    for step in range(11):
        tok = _i8(rng, b, 1 + step % 2, g, hd)
        live = np.asarray([True, step % 2 == 0, False])
        j = j.decode_append(jnp.asarray(tok), jnp.asarray(tok),
                            live=jnp.asarray(live))
        t = t.decode_append(_t(tok), _t(tok), live=_t(live))
        for f in ("k", "v", "pos"):
            np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                          getattr(t, f).numpy(),
                                          err_msg=f"step {step}: {f}")


# ---------------------------------------------------------------------------
# Paged kernels (plain versions) and fused_attention against the JAX package
# ---------------------------------------------------------------------------

def _pool(rng, b, g, hd, page, n_pages, extra=3):
    """A pool with permuted, non-contiguous page tables (spare pages in
    between) and the matching per-sequence rings."""
    total = b * n_pages + 1 + extra
    perm = rng.permutation(np.arange(1, total))[:b * n_pages]
    pt = perm.reshape(b, n_pages).astype(np.int32)
    k_pool = _i8(rng, total, page, g, hd)
    v_pool = _i8(rng, total, page, g, hd)
    return k_pool, v_pool, pt


KERNEL_CASES = [
    # hq, hkv, window, adaptive
    pytest.param(4, 4, 0, True, id="mha-causal-adaptive"),
    pytest.param(4, 2, 0, False, id="gqa-causal-paper"),
    pytest.param(4, 2, 40, True, id="gqa-window-adaptive"),
    pytest.param(4, 4, 40, False, id="mha-window-paper"),
]


@pytest.mark.parametrize("hq,hkv,window,adaptive", KERNEL_CASES)
def test_paged_kernels_match_jax_and_ring(hq, hkv, window, adaptive):
    rng = np.random.default_rng(hq * 100 + hkv * 10 + window)
    b, d, page, n_pages, sq = 2, 16, 32, 4, 16
    bh, rep = b * hq, hq // hkv
    k_pool, v_pool, pt = _pool(rng, b, hkv, d, page, n_pages)
    lmult = rng.uniform(0.004, 0.03, bh).astype(np.float32)
    omult = rng.uniform(0.5, 2.0, bh).astype(np.float32)
    # kv_len ending mid-page, a short row, an empty row
    kv_b = np.asarray([77, 19], np.int32)
    kv_len = np.repeat(kv_b, hq)
    for name, q_len in (("onepass", np.repeat([16, 1], hq)),
                        ("onepass", np.repeat([0, 9], hq)),
                        ("decode", None)):
        s = sq if name == "onepass" else 4
        q = _i8(rng, bh, s, d)
        q_off = np.maximum(kv_len - s, 0).astype(np.int32)
        kw = dict(q_offset=q_off, causal=True, window=window,
                  adaptive=adaptive, kv_rep=rep, hq=hq)
        if q_len is not None:
            kw["q_len"] = q_len.astype(np.int32)
        jfn = getattr(JK, f"ita_attention_{name}_paged")
        tfn = getattr(TK, f"ita_attention_{name}_paged")
        want = np.asarray(jfn(
            jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
            jnp.asarray(pt), jnp.asarray(lmult), jnp.asarray(omult),
            jnp.asarray(kv_len), interpret=True,
            **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}))
        tkw = {k: _t(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        got = tfn(_t(q), _t(k_pool), _t(v_pool), _t(pt), _t(lmult),
                  _t(omult), _t(kv_len), **tkw)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        # paged == the ring kernel on the gathered pages
        ring = {x: TK.gather_pages(_t(pool), _t(pt))
                for x, pool in (("k", k_pool), ("v", v_pool))}
        ring_fn = getattr(TK, f"ita_attention_{name}")
        ring_out = ring_fn(_t(q), ring["k"], ring["v"], _t(lmult),
                           _t(omult), _t(kv_len), block_kv=page, **tkw)
        assert torch.equal(got, ring_out), name
        if q_len is not None:                  # pad / empty rows emit 0
            for r in range(bh):
                assert not got[r, int(q_len[r]):].any()


@pytest.mark.parametrize("kind", ["onepass", "decode"])
def test_fused_attention_paged_matches_jax(kind):
    rng = np.random.default_rng(11 if kind == "onepass" else 12)
    b, hq, hkv, d, page, n_pages = 3, 4, 2, 16, 32, 4
    sq = 12 if kind == "onepass" else 1
    k_pool, v_pool, pt = _pool(rng, b, hkv, d, page, n_pages)
    q = _i8(rng, b, hq, sq, d)
    kv_len = np.asarray([100, 40, 0], np.int32)
    q_lens = np.asarray([1, 12, 0], np.int32) if kind == "onepass" else None
    n_q = q_lens if q_lens is not None else np.full(b, sq, np.int32)
    q_off = np.maximum(kv_len - n_q, 0).astype(np.int32)
    s_k = np.asarray([0.04, 0.06], np.float32)       # per-head K scales
    kw = dict(q_offset=q_off, kv_len=kv_len, q_lens=q_lens, kind=kind,
              causal=True, window=0, adaptive=True)
    want = np.asarray(JO.fused_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool), S_Q,
        jnp.asarray(s_k), S_Q, S_OUT, page_table=jnp.asarray(pt),
        interpret=True,
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}))
    got = TO.fused_attention(
        _t(q), _t(k_pool), _t(v_pool), S_Q, _t(s_k), S_Q, S_OUT,
        page_table=_t(pt),
        **{k: _t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[2].any(), "an empty row must output zeros"


SPECS = [
    dict(mode="decode", layout="bhsd_paged", q_len=1),
    dict(mode="decode", layout="bhsd_paged", q_len=16, ragged_q=True),
    dict(mode="decode", layout="bhsd_paged", q_len=16),
    dict(mode="prefill", layout="bhsd_paged", q_len=16),
    dict(mode="decode", layout="bshd", q_len=4, ragged_q=True),
    dict(mode="prefill", layout="bshd", q_len=4, ragged_q=True),
    dict(mode="decode", layout="bhsd_paged", q_len=1, softmax="paper",
         window=64),
]


@pytest.mark.parametrize("kw", SPECS, ids=[
    f"{s['mode']}-{s['layout']}-q{s['q_len']}"
    + ("-ragged" if s.get("ragged_q") else "")
    + ("-window" if s.get("window") else "") for s in SPECS])
def test_paged_and_ragged_verdicts_match_jax(kw):
    j = JATT.backend_reasons(JATT.AttentionSpec(impl="ita", **kw))
    t = TATT.backend_reasons(TATT.AttentionSpec(impl="ita", **kw))
    assert t == {name: j[name] for name in t}


def test_dispatch_page_table_handshake():
    rng = np.random.default_rng(3)
    k_pool, v_pool, pt = _pool(rng, 1, 2, 16, 32, 2)
    q = _t(_i8(rng, 1, 4, 1, 16))
    scales = TATT.QuantScales.per_tensor(S_Q, s_out=S_OUT)
    paged = TATT.AttentionSpec(mode="decode", layout="bhsd_paged", q_len=1,
                               out_dtype="int8")
    out = TATT.dispatch(q, _t(k_pool), _t(v_pool), spec=paged,
                        scales=scales, q_offset=9, kv_len=10,
                        page_table=_t(pt))
    assert out.shape == (1, 4, 1, 16) and out.dtype == torch.int8
    with pytest.raises(ValueError, match="page_table"):
        TATT.dispatch(q, _t(k_pool), _t(v_pool), spec=paged, scales=scales,
                      q_offset=9, kv_len=10)
    with pytest.raises(ValueError, match="page_table"):
        TATT.dispatch(q, _t(k_pool), _t(v_pool),
                      spec=paged.replace(layout="bhsd_bsgd"), scales=scales,
                      q_offset=9, kv_len=10, page_table=_t(pt))
