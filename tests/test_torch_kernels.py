"""The port's ITA attention kernels against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through the JAX functions
(the Pallas kernels in interpret mode, as the JAX package's own tests run
them) and through ``repro_torch`` on ``device="cpu"``, where each kernel
wrapper computes its plain version. The bar is bit-exact equality
(``np.array_equal``) on the int8 output grid and on every integer helper.

XLA:CPU computes ``exp2`` of integers approximately for exponents beyond
12 (up to ~9 ulp off), while the reference's ``exp2`` calls all take
integer arguments and mean exact powers of two — what the port and its
CUDA kernels compute (ROADMAP §C). The reference therefore runs with an
exact ``exp2`` (``jnp.ldexp``), so ties on the output grid round alike.

The CUDA kernels are held to these plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import common as JC
from repro.kernels.ita_attention import kernel as JK
from repro.kernels.ita_attention import ref as JR
from repro_torch.kernels import common as TC
from repro_torch.kernels.ita_attention import kernel as TK
from repro_torch.kernels.ita_attention import ref as TR


@pytest.fixture(scope="module", autouse=True)
def exact_exp2():
    """Run the reference with exact powers of two (see module docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "exp2", lambda x: jnp.ldexp(
            jnp.ones(jnp.shape(x), jnp.float32),
            jnp.asarray(x).astype(jnp.int32)))
        jax.clear_caches()
        yield
    jax.clear_caches()


class _Ref:
    """A mutable stand-in for a Pallas scratch ref."""

    def __init__(self, a):
        self.a = a

    def __getitem__(self, idx):
        return self.a

    def __setitem__(self, idx, val):
        self.a = val


def _i8(rng, *shape):
    return rng.integers(-128, 128, shape, dtype=np.int8)


# --------------------------------------------------------------------------
# Helpers: tile_mask, da_update, adaptive_inverse, paper_inverse
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,kv_len,q_offset,q_len", [
    (True, 0, 100, 37, None),
    (False, 0, 20, 0, 5),
    (True, 9, 200, 130, 12),
    (False, 6, 64, 3, 16),
])
def test_tile_mask_matches_jax(causal, window, kv_len, q_offset, q_len):
    for q_tile, kv_tile in ((0, 0), (1, 2), (3, 1)):
        want = np.asarray(JC.tile_mask(q_tile, kv_tile, 16, 32, causal,
                                       window, kv_len, q_offset, q_len))
        got = TC.tile_mask(q_tile, kv_tile, 16, 32, causal, window, kv_len,
                           q_offset, q_len).numpy()
        assert np.array_equal(want, got), (q_tile, kv_tile)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_da_update_matches_jax(seed):
    rng = np.random.default_rng(seed)
    bq, bkv = 8, 64
    m = rng.integers(-256, 128, (bq, 1)).astype(np.int32)
    sigma = rng.integers(0, 1 << 20, (bq, 1)).astype(np.int32)
    logits = rng.integers(-128, 128, (bq, bkv)).astype(np.int32)
    valid = rng.random((bq, bkv)) < 0.7
    valid[0] = False                       # an all-masked row
    mr, sr = _Ref(jnp.asarray(m)), _Ref(jnp.asarray(sigma))
    u, delta = JC.da_update(mr, sr, jnp.asarray(logits), jnp.asarray(valid))
    tu, tdelta, tm, ts = TC.da_update(
        torch.from_numpy(m), torch.from_numpy(sigma),
        torch.from_numpy(logits), torch.from_numpy(valid))
    for want, got in ((u, tu), (delta, tdelta), (mr.a, tm), (sr.a, ts)):
        assert np.array_equal(np.asarray(want), got.numpy())


def _sigma_sweep():
    vals = {1, 2, 3}
    for e in range(1, 31):
        p = 1 << e
        vals |= {p - 1, p, p + 1, p + p // 3}
    vals |= {(1 << 31) - 1}
    return np.array(sorted(v for v in vals if v < 1 << 31), np.int32)


def test_inverses_match_jax_across_powers_of_two():
    sigma = np.concatenate([_sigma_sweep(), np.array([0, -5], np.int32)])
    inv, e_r = JC.adaptive_inverse(jnp.asarray(sigma))
    tinv, te_r = TC.adaptive_inverse(torch.from_numpy(sigma))
    assert tinv.dtype == te_r.dtype == torch.int32
    assert np.array_equal(np.asarray(inv), tinv.numpy())
    assert np.array_equal(np.asarray(e_r), te_r.numpy())
    assert np.array_equal(np.asarray(JC.paper_inverse(jnp.asarray(sigma))),
                          TC.paper_inverse(torch.from_numpy(sigma)).numpy())


def test_floor_log2_exact_where_float32_rounds():
    x = _sigma_sweep()
    want = np.floor(np.log2(x.astype(np.float64))).astype(np.int32)
    assert np.array_equal(TC.floor_log2(torch.from_numpy(x)).numpy(), want)
    n = torch.arange(0, 127, dtype=torch.int32)
    assert torch.equal(TC.pow2_neg(n).double(),
                       torch.ldexp(torch.ones(127, dtype=torch.float64),
                                   -n.double()))


# --------------------------------------------------------------------------
# Oracles: stream_ref / fused_ref
# --------------------------------------------------------------------------

@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("block_kv,kind", [(64, "onepass"), (128, "onepass"),
                                           (64, "twopass")])
def test_stream_ref_matches_jax(adaptive, block_kv, kind):
    rng = np.random.default_rng(7)
    q, k, v = _i8(rng, 3, 24, 32), _i8(rng, 3, 256, 32), _i8(rng, 3, 256, 32)
    lm, om = np.float32(0.011), np.float32(1.3)
    want = JR.ita_attention_stream_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lm, om, 230,
        causal=True, window=0, adaptive=adaptive, block_kv=block_kv,
        kind=kind, q_offset=200)
    got = TR.ita_attention_stream_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(lm), torch.tensor(om), 230, causal=True, window=0,
        adaptive=adaptive, block_kv=block_kv, kind=kind, q_offset=200)
    assert np.array_equal(np.asarray(want), got.numpy())


def test_fused_ref_matches_jax():
    rng = np.random.default_rng(8)
    q, k, v = _i8(rng, 2, 16, 16), _i8(rng, 2, 48, 16), _i8(rng, 2, 48, 16)
    lm, om = np.float32(0.02), np.float32(0.7)
    for adaptive in (True, False):
        want = JR.ita_attention_fused_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lm, om, 40,
            causal=True, window=12, adaptive=adaptive, q_offset=24)
        got = TR.ita_attention_fused_ref(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.tensor(lm), torch.tensor(om), 40, causal=True, window=12,
            adaptive=adaptive, q_offset=24)
        assert np.array_equal(np.asarray(want), got.numpy())


# --------------------------------------------------------------------------
# Kernel wrappers (plain versions on the CPU) vs the Pallas kernels
# --------------------------------------------------------------------------

def _kernel_inputs(rng, *, b, hq, hkv, sq, skv, d, layout, ragged, decode):
    bh, rep = b * hq, hq // hkv
    q = _i8(rng, bh, sq, d)
    if layout == "4d":
        k, v = _i8(rng, b, skv, hkv, d), _i8(rng, b, skv, hkv, d)
    else:
        k, v = _i8(rng, b * hkv, skv, d), _i8(rng, b * hkv, skv, d)
    lmult = rng.uniform(0.004, 0.03, bh).astype(np.float32)
    omult = rng.uniform(0.5, 2.0, bh).astype(np.float32)
    if ragged:
        kv_len = rng.integers(sq, skv + 1, bh).astype(np.int32)
        q_len = rng.integers(1, sq + 1, bh).astype(np.int32)
        if decode:
            q_len = np.full(bh, sq, np.int32)
    else:
        kv_len = np.full(bh, skv, np.int32)
        q_len = np.full(bh, sq, np.int32)
    q_offset = np.maximum(kv_len - sq, 0).astype(np.int32)
    return dict(q=q, k=k, v=v, lmult=lmult, omult=omult, kv_len=kv_len,
                q_offset=q_offset, q_len=q_len, rep=rep, hq=hq)


def _run_both(kind, x, *, causal, window, adaptive, block_kv, layout):
    hq = x["hq"] if layout == "4d" else None
    jfn = JK.ita_attention_onepass if kind == "onepass" \
        else JK.ita_attention_decode
    tfn = TK.ita_attention_onepass if kind == "onepass" \
        else TK.ita_attention_decode
    kw = dict(q_offset=x["q_offset"], q_len=x["q_len"], causal=causal,
              window=window, adaptive=adaptive, block_kv=block_kv,
              kv_rep=x["rep"], hq=hq)
    if kind == "onepass":
        kw["block_q"] = min(16, x["q"].shape[1])
    want = jfn(*(jnp.asarray(x[n]) for n in ("q", "k", "v", "lmult",
                                             "omult", "kv_len")),
               interpret=True, **{n: (jnp.asarray(a) if isinstance(
                   a, np.ndarray) else a) for n, a in kw.items()})
    got = tfn(*(torch.from_numpy(x[n]) for n in ("q", "k", "v", "lmult",
                                                 "omult", "kv_len")),
              **{n: (torch.from_numpy(a) if isinstance(a, np.ndarray)
                     else a) for n, a in kw.items()})
    return np.asarray(want), got.numpy()


ONEPASS_CASES = [
    # id, b, hq, hkv, sq, skv, d, block_kv, causal, window, layout, ragged
    ("mha-skv48-one-tile", 2, 2, 2, 16, 48, 16, 128, True, 0, "3d", False),
    ("gqa-256-4d-ragged", 2, 4, 2, 16, 256, 16, 128, True, 0, "4d", True),
    ("gqa-window-3d-ragged", 1, 4, 1, 32, 256, 32, 64, True, 40, "3d", True),
    ("noncausal-4d", 1, 2, 1, 8, 128, 16, 64, False, 0, "4d", False),
]


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("case", ONEPASS_CASES, ids=[c[0] for c in
                                                     ONEPASS_CASES])
def test_onepass_plain_matches_pallas(case, adaptive):
    _, b, hq, hkv, sq, skv, d, bkv, causal, window, layout, ragged = case
    rng = np.random.default_rng(zlib.crc32(case[0].encode()))
    x = _kernel_inputs(rng, b=b, hq=hq, hkv=hkv, sq=sq, skv=skv, d=d,
                       layout=layout, ragged=ragged, decode=False)
    want, got = _run_both("onepass", x, causal=causal, window=window,
                          adaptive=adaptive, block_kv=min(bkv, skv),
                          layout=layout)
    assert np.array_equal(want, got)


DECODE_CASES = [
    # id, b, hq, hkv, sq, skv, d, block_kv, window, layout
    ("ring20-one-tile-3d", 2, 2, 1, 1, 20, 16, 128, 0, "3d"),
    ("ring256-4d-gqa", 2, 4, 2, 1, 256, 16, 128, 0, "4d"),
    ("ring256-window-4d", 1, 4, 2, 4, 256, 32, 64, 70, "4d"),
    ("ring384-burst8-3d", 1, 4, 2, 8, 384, 16, 128, 0, "3d"),
]


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in
                                                    DECODE_CASES])
def test_decode_plain_matches_pallas(case, adaptive):
    _, b, hq, hkv, sq, skv, d, bkv, window, layout = case
    rng = np.random.default_rng(zlib.crc32(case[0].encode()))
    x = _kernel_inputs(rng, b=b, hq=hq, hkv=hkv, sq=sq, skv=skv, d=d,
                       layout=layout, ragged=True, decode=True)
    want, got = _run_both("decode", x, causal=True, window=window,
                          adaptive=adaptive, block_kv=min(bkv, skv),
                          layout=layout)
    assert np.array_equal(want, got)


def test_wrappers_count_only_kernel_launches():
    rng = np.random.default_rng(3)
    x = _kernel_inputs(rng, b=1, hq=2, hkv=1, sq=1, skv=32, d=16,
                       layout="3d", ragged=False, decode=True)
    TK.reset_launches()
    TK.ita_attention_decode(*(torch.from_numpy(x[n]) for n in (
        "q", "k", "v", "lmult", "omult", "kv_len")), kv_rep=2)
    assert TK.LAUNCHES == {"ita_attention_onepass": 0,
                           "ita_attention_decode": 0,
                           "ita_attention_onepass_paged": 0,
                           "ita_attention_decode_paged": 0,
                           "ita_attention_twopass_qk_da": 0,
                           "ita_attention_twopass_av_en": 0}
    with pytest.raises(ValueError, match="at most 8"):
        TK.ita_attention_decode(torch.zeros((2, 9, 16), dtype=torch.int8),
                                torch.zeros((1, 32, 16), dtype=torch.int8),
                                torch.zeros((1, 32, 16), dtype=torch.int8),
                                0.01, 1.0, 32, kv_rep=2)


@pytest.mark.parametrize("bkv", [128, 256])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_onepass_geometry(d, bkv):
    """The onepass kernel's launch geometry (``csrc/onepass.cu``) at
    qwen2-7b's 28/4 heads: a block serves one kv row and a tile of packed
    (query, head) rows in row groups of 16 — 64 rows for the 4×512
    prefill (896 blocks), 16 for a decode step, 32 for a serve step's 96
    queries and for KV tiles over 128 keys; shared memory within a
    block's 232,448 bytes, two staging stages where they fit; on an
    H100's 132 SMs."""
    prefill = TK.onepass_geometry(112, 512, d, bkv, 7, 132)
    decode = TK.onepass_geometry(112, 1, d, bkv, 7, 132)
    serve = TK.onepass_geometry(112, 96, d, bkv, 7, 132)
    wide = bkv > 128
    assert prefill["rows"] == (32 if wide else 64)
    assert prefill["grid"] == 16 * (112 if wide else 56)
    assert decode["rows"] == (32 if wide else 16) and decode["grid"] == 16
    assert serve["rows"] == 32 and serve["grid"] == 16 * 21
    for geo in (prefill, decode, serve):
        assert geo["threads"] == geo["rows"] * 2 * geo["warps_n"]
        assert geo["threads"] in (128, 256)
        assert geo["smem"] <= 232448
    assert decode["threads"] == (128 if d == 64 and not wide else 256)
    ks, rows = d + 16, prefill["rows"]
    stages = 1 if (d, bkv) == (256, 256) else 2
    assert prefill["stages"] == stages
    assert prefill["smem"] == (stages * 2 * bkv * ks + rows * (ks + bkv + 16)
                               + 2 * prefill["warps_n"] * rows * 4 + 16)
    # a short ring's tile is rounded up to the 32 keys of an mma step
    short = TK.onepass_geometry(4, 20, d, 20, 2, 132)
    assert short["smem"] == 2 * 2 * 32 * ks + short["rows"] * (ks + 48) \
        + 2 * short["warps_n"] * short["rows"] * 4 + 16


@pytest.mark.parametrize("d, bkv, bh, kv_rep, what", [
    (40, 128, 8, 2, "multiple of 16"),
    (272, 128, 8, 2, "multiple of 16"),
    (128, 512, 8, 2, "KV tile"),
    (128, 0, 8, 2, "KV tile"),
    (128, 128, 9, 2, "kv rows"),
])
def test_onepass_geometry_refuses_what_the_kernel_cannot_take(d, bkv, bh,
                                                              kv_rep, what):
    with pytest.raises(ValueError, match=what):
        TK.onepass_geometry(bh, 16, d, bkv, kv_rep, 132)


# bh, sq, d, bkv, kv_rep, n_tiles: chip_smoke.py run (c)'s prefill (4×512
# on qwen2-7b) and the twopass shapes of tests/test_torch_cuda.py
TWOPASS_GEOMETRY_CASES = [
    (112, 512, 128, 128, 7, 4),
    (112, 512, 128, 256, 7, 2),
    (28, 40, 128, 128, 7, 3),
    (14, 96, 64, 128, 7, 2),
    (14, 40, 128, 256, 7, 2),
    (14, 64, 32, 128, 7, 3),
    (4, 40, 16, 64, 1, 2),
    (2, 16, 16, 48, 1, 1),
    (8, 24, 256, 256, 2, 2),
]


@pytest.mark.parametrize("case", TWOPASS_GEOMETRY_CASES, ids=[
    "-".join(map(str, c)) for c in TWOPASS_GEOMETRY_CASES])
def test_twopass_geometry(case):
    """Both twopass kernels' launch (``csrc/twopass.cu`` checks it): one
    kv row and 64 or 128 packed (query, head) rows a block, one warp per
    16 rows, covering every packed row once (sq not a multiple of the
    tile: the last block's rows past sq write nothing); 128 rows only at
    head dim and KV tile <= 128 with 1.5 blocks (pass 1) or one (pass 2)
    per SM of an H100's 132;
    2-4 stages, no deeper than the row's tiles where two blocks fit an
    SM, each pass's shared memory as ``csrc/twopass.cu`` lays it out and
    within a block's 232,448 bytes."""
    bh, sq, d, bkv, rep, n_tiles = case
    geo = TK.twopass_geometry(bh, sq, d, bkv, rep, 132, n_tiles)
    packed, n_kr = sq * rep, bh // rep
    rs, sp1, sp2 = -(-d // 128) * 128, -(-bkv // 64) * 64, -(-bkv // 32) * 32
    for kind, per_stage, fixed in (
            ("qk", sp1 * rs, geo["qk"]["rows"] * (d + 16)),
            ("av", sp2 * rs + geo["av"]["rows"] * (sp2 + 16),
             sp2 * d + geo["av"]["rows"] * 8 + geo["av"]["rows"] // 2)):
        g = geo[kind]
        assert g["rows"] in (64, 128) and g["threads"] == 2 * g["rows"]
        need = {"qk": 1.5, "av": 1}[kind] * 132
        big = n_kr * -(-packed // 128) >= need and d <= 128 and bkv <= 128
        assert g["rows"] == (128 if big else 64)
        assert g["tiles_per_kv_row"] == -(-packed // g["rows"])
        assert (g["tiles_per_kv_row"] - 1) * g["rows"] < packed
        assert g["grid"] == n_kr * g["tiles_per_kv_row"]
        assert 2 <= g["stages"] <= max(2, min(4, n_tiles))
        assert g["smem"] == g["stages"] * per_stage + fixed <= 232448
        deeper = (g["stages"] + 1) * per_stage + fixed
        if g["stages"] < min(4, n_tiles):
            assert 2 * deeper > 232448
    if case[:5] == (112, 512, 128, 128, 7):
        # run (c): 448 blocks of 128 rows; K tiles 4 deep, V+A 2 deep
        assert geo["qk"]["grid"] == 16 * 28 and geo["qk"]["rows"] == 128
        assert (geo["qk"]["stages"], geo["av"]["stages"]) == (4, 2)


@pytest.mark.parametrize("sms", [78, 114, 132, 200, 264, 500])
def test_twopass_geometry_follows_the_sm_count(sms):
    """128-row blocks once they number 1.5 per SM of the card for pass 1,
    one per SM for pass 2, else 64: run (c)'s 4×512 prefill has 448 of
    them (128 rows up to 298 and 448 SMs), a 4×256 prefill 224 (up to
    149 and 224 SMs)."""
    for sq, blocks in ((512, 448), (256, 224)):
        geo = TK.twopass_geometry(112, sq, 128, 128, 7, sms, sq // 128)
        for kind, per_sm in (("qk", 1.5), ("av", 1)):
            rows = 128 if blocks >= per_sm * sms else 64
            assert geo[kind]["rows"] == rows
            assert geo[kind]["grid"] == 16 * -(-sq * 7 // rows)


@pytest.mark.parametrize("d, bkv, bh, kv_rep, what", [
    (40, 128, 8, 2, "multiple of 16"),
    (272, 128, 8, 2, "multiple of 16"),
    (128, 512, 8, 2, "KV tile"),
    (128, 0, 8, 2, "KV tile"),
    (128, 128, 9, 2, "kv rows"),
])
def test_twopass_geometry_refuses_what_the_kernels_cannot_take(d, bkv, bh,
                                                               kv_rep, what):
    with pytest.raises(ValueError, match=what):
        TK.twopass_geometry(bh, 16, d, bkv, kv_rep, 132, 2)


@pytest.mark.parametrize("sms", [78, 114, 132, 264])
def test_onepass_geometry_follows_the_sm_count(sms):
    """64-row blocks once they number four per SM of the card, else 32:
    the 4×512 prefill's 896 64-row blocks take 64 rows up to 224 SMs; a
    4×256 prefill's 448 take them up to 112 SMs. A decode step is 16
    rows on any card."""
    prefill = TK.onepass_geometry(112, 512, 128, 128, 7, sms)
    half = TK.onepass_geometry(112, 256, 128, 128, 7, sms)
    assert prefill["rows"] == (64 if 896 >= 4 * sms else 32)
    assert half["rows"] == (64 if 448 >= 4 * sms else 32)
    assert half["grid"] == 16 * -(-1792 // half["rows"])
    assert TK.onepass_geometry(112, 1, 128, 128, 7, sms)["rows"] == 16
    for geo in (prefill, half):
        assert geo["threads"] == 256 and geo["stages"] == 2


def _decode_smem(d, bkv, stages, rows, wn, cluster):
    """``csrc/ita_common.cuh``'s ``layout`` bytes, written out."""
    ks, sp = d + 16, -(-bkv // 32) * 32
    smem = stages * 2 * sp * ks + rows * ks + rows * (sp + 16) \
        + 2 * wn * rows * 4 + 16
    if cluster > 1:
        tiles = stages * cluster
        share = (rows * d // 4 + cluster - 1) // cluster
        smem += rows * 4 + rows * 16 + 2 * tiles * rows * 4 \
            + tiles * share * 16
    return smem


@pytest.mark.parametrize("bkv", [16, 32, 64, 128])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("sq", [1, 2, 8])
def test_decode_geometry(sq, d, bkv):
    """The decode kernel's launch geometry (``csrc/decode.cu`` checks it)
    at qwen2-7b's 28/4 heads and batch 4 (16 kv rows) on 132 SMs, over a
    ring of 640 tokens: one block serves a kv row's 7·sq packed rows in
    1, 2 or 4 row groups of 16 (8 warps; 4 for one group at d 64), and
    the 116 idle SMs give each kv row a cluster of 8 CTAs (at most the
    row's tiles), each holding its run of the row's tiles."""
    n_tiles = 640 // bkv
    geo = TK.decode_geometry(112, sq, d, bkv, 7, 132, n_tiles)
    wm = {1: 1, 2: 1, 8: 4}[sq]
    wn = 4 if wm == 1 and d == 64 else 8 // wm
    assert geo["rows"] == 16 * wm and geo["warps_n"] == wn
    assert geo["threads"] == 32 * wm * wn
    assert geo["tiles_per_kv_row"] == 1
    cluster = min(8, n_tiles)
    run = -(-n_tiles // cluster)
    if _decode_smem(d, bkv, run, 16 * wm, wn, cluster) > 232448:
        assert geo["cluster"] == 1
    else:
        assert (geo["cluster"], geo["stages"]) == (cluster, run)
    assert geo["grid"] == 16 * geo["cluster"]
    assert geo["smem"] == _decode_smem(d, bkv, geo["stages"], 16 * wm, wn,
                                       geo["cluster"]) <= 232448


def test_decode_geometry_clusters_only_where_sms_are_idle():
    """Cluster size from the call and the card: 1 when the blocks fill
    the card or a row has one tile (then one block streams the tiles
    through up to 4 stages), at most the SMs per block, and a run of
    tiles per CTA when a row has more tiles than a cluster has CTAs."""
    def geo(bh, n_tiles, sms=132, **kw):
        return TK.decode_geometry(bh, 1, 128, 128, 7, sms, n_tiles, **kw)
    assert (geo(112, 5)["cluster"], geo(112, 5)["stages"]) == (5, 1)
    assert (geo(112, 8)["cluster"], geo(112, 8)["stages"]) == (8, 1)
    long = geo(28, 18)                   # one sequence, 2304 tokens
    assert (long["cluster"], long["stages"], long["grid"]) == (8, 3, 32)
    full = geo(7 * 132, 5)               # 132 kv rows: the card is full
    assert (full["cluster"], full["stages"], full["grid"]) == (1, 4, 132)
    assert geo(112, 1)["cluster"] == 1 and geo(112, 1)["stages"] == 1
    assert geo(112, 5, sms=48)["cluster"] == 3          # 48 // 16 SMs
    assert geo(112, 5, sms=16)["cluster"] == 1
    streaming = geo(112, 5, max_cluster=1)
    assert (streaming["cluster"], streaming["stages"]) == (1, 4)
    assert streaming["smem"] == _decode_smem(128, 128, 4, 16, 8, 1)
    # a run that does not fit beside its u·V: one streaming block instead
    wide = TK.decode_geometry(4, 1, 256, 128, 1, 132, 40)
    assert wide["cluster"] == 1 and wide["stages"] == 3


@pytest.mark.parametrize("sq, d, bkv, bh, kv_rep, n_tiles, what", [
    (1, 40, 128, 8, 2, 5, "multiple of 16"),
    (1, 272, 128, 8, 2, 5, "multiple of 16"),
    (1, 128, 512, 8, 2, 5, "KV tile"),
    (1, 128, 0, 8, 2, 5, "KV tile"),
    (1, 128, 128, 9, 2, 5, "kv rows"),
    (9, 128, 128, 8, 2, 5, "at most 8"),
    (0, 128, 128, 8, 2, 5, "at most 8"),
    (1, 128, 128, 8, 2, 0, "KV tiles per row"),
])
def test_decode_geometry_refuses_what_the_kernel_cannot_take(
        sq, d, bkv, bh, kv_rep, n_tiles, what):
    with pytest.raises(ValueError, match=what):
        TK.decode_geometry(bh, sq, d, bkv, kv_rep, 132, n_tiles)
