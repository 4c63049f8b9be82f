"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card the test skips. It imports neither JAX
nor ``repro``, so it runs where only torch and the CUDA toolkit are
installed: ``python -m pytest -m cuda tests/test_torch_cuda.py``. Each kernel
must equal its plain version on the same CUDA tensors bit for bit: 3D
and 4D rings and paged pools, GQA, ragged rows and query counts, causal
and windowed, adaptive and paper DI, short rings (one tile of 20) and
multi-tile ones; the twopass kernels (out, A and pass 1's statistics),
the standalone softmax kernel and both int8 matmul kernels.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.common import exact_float32_matmul
from repro_torch.kernels.ita_attention import kernel as K

CASES = [
    # kind, b, hq, hkv, sq, skv, d, block_kv, causal, window, layout
    ("onepass", 2, 2, 2, 16, 48, 16, 128, True, 0, "3d"),
    ("onepass", 2, 4, 2, 40, 256, 16, 128, True, 0, "4d"),
    ("onepass", 1, 4, 1, 32, 256, 32, 64, True, 40, "3d"),
    ("onepass", 1, 2, 1, 8, 128, 16, 64, False, 0, "4d"),
    ("onepass", 1, 4, 2, 64, 512, 128, 256, True, 0, "4d"),
    # qwen2-7b's 28/4 heads packed into the block: prefill, decode-shaped
    # calls (sq 1 and 2), a window; head dims 64 and 256 (256-key tiles:
    # one staging stage)
    ("onepass", 2, 28, 4, 40, 384, 128, 128, True, 0, "3d"),
    ("onepass", 2, 28, 4, 1, 640, 128, 128, True, 0, "4d"),
    ("onepass", 2, 28, 4, 2, 640, 128, 128, True, 0, "3d"),
    ("onepass", 1, 28, 4, 24, 512, 128, 128, True, 200, "4d"),
    ("onepass", 2, 8, 2, 48, 256, 64, 128, True, 0, "4d"),
    ("onepass", 1, 4, 2, 80, 512, 256, 128, True, 0, "3d"),
    ("onepass", 1, 4, 2, 40, 512, 256, 256, True, 0, "4d"),
    ("decode", 2, 2, 1, 1, 20, 16, 128, True, 0, "3d"),
    ("decode", 2, 4, 2, 1, 256, 16, 128, True, 0, "4d"),
    ("decode", 1, 4, 2, 4, 256, 32, 64, True, 70, "4d"),
    ("decode", 1, 4, 2, 8, 384, 16, 128, True, 0, "3d"),
    ("decode", 2, 28, 4, 3, 640, 128, 128, True, 0, "4d"),
    # the decode block at qwen2-7b's 28/4 heads: 7·sq packed rows (sq 1,
    # 2, 8: one row group to four), a window that skips leading tiles,
    # a ring of 20 tokens (one tile of 20), kv_rep 1, head dim 256, and
    # rings of 2304 tokens (18 tiles: runs of 3 tiles on 8-CTA clusters)
    ("decode", 2, 28, 4, 1, 640, 128, 128, True, 0, "4d"),
    ("decode", 2, 28, 4, 2, 640, 128, 128, True, 0, "3d"),
    ("decode", 2, 28, 4, 8, 640, 128, 128, True, 0, "4d"),
    ("decode", 2, 28, 4, 1, 640, 128, 128, True, 200, "4d"),
    ("decode", 1, 28, 4, 2, 20, 128, 128, True, 0, "3d"),
    ("decode", 2, 4, 4, 1, 384, 64, 128, True, 0, "4d"),
    ("decode", 1, 8, 2, 1, 512, 256, 128, True, 0, "4d"),
    ("decode", 1, 28, 4, 1, 2304, 128, 128, True, 0, "4d"),
    ("decode", 1, 28, 4, 8, 2304, 128, 128, True, 300, "3d"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[
    f"{c[0]}-{c[10]}-sq{c[4]}-skv{c[5]}-d{c[6]}-w{c[9]}" for c in CASES])
def test_cuda_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    exact_float32_matmul()
    kind, b, hq, hkv, sq, skv, d, bkv, causal, window, layout = case
    rng = np.random.default_rng(b * 1000 + skv + sq)
    bh, rep = b * hq, hq // hkv
    kv_shape = (b, skv, hkv, d) if layout == "4d" else (b * hkv, skv, d)

    def t(a):
        return torch.from_numpy(np.asarray(a)).cuda()

    q = t(rng.integers(-128, 128, (bh, sq, d), dtype=np.int8))
    k = t(rng.integers(-128, 128, kv_shape, dtype=np.int8))
    v = t(rng.integers(-128, 128, kv_shape, dtype=np.int8))
    lmult = t(rng.uniform(0.004, 0.03, bh).astype(np.float32))
    omult = t(rng.uniform(0.5, 2.0, bh).astype(np.float32))
    kv_len = rng.integers(sq, skv + 1, bh).astype(np.int32)
    q_len = rng.integers(1, sq + 1, bh).astype(np.int32) \
        if kind == "onepass" else np.full(bh, sq, np.int32)
    fn = K.ita_attention_onepass if kind == "onepass" \
        else K.ita_attention_decode
    for adaptive in (True, False):
        kw = dict(q_offset=t(np.maximum(kv_len - sq, 0)), q_len=t(q_len),
                  causal=causal, window=window, adaptive=adaptive,
                  block_kv=min(bkv, skv), kv_rep=rep,
                  hq=hq if layout == "4d" else None)
        got = fn(q, k, v, lmult, omult, t(kv_len), **kw)
        want = K.attention_plain(q, k, v, lmult, omult, t(kv_len), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), adaptive


PAGED_CASES = [
    # kind, b, hq, hkv, sq, page, n_pages, d, window
    ("onepass", 2, 4, 2, 40, 32, 6, 16, 0),
    ("onepass", 3, 28, 4, 96, 128, 4, 128, 0),
    ("onepass", 2, 4, 4, 16, 64, 5, 32, 90),
    ("decode", 3, 4, 2, 1, 32, 6, 16, 0),
    ("decode", 2, 28, 4, 1, 128, 9, 128, 0),
    ("decode", 2, 4, 2, 4, 64, 5, 32, 70),
    # qwen2-7b's heads over pages of 16 and 64 tokens and over a pool
    # long enough for runs of tiles (18 pages of 128 tokens)
    ("decode", 2, 28, 4, 1, 16, 40, 128, 0),
    ("decode", 2, 28, 4, 2, 64, 12, 128, 150),
    ("decode", 2, 28, 4, 1, 128, 18, 128, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAGED_CASES, ids=[
    f"{c[0]}_paged-sq{c[4]}-page{c[5]}-d{c[7]}-w{c[8]}"
    for c in PAGED_CASES])
def test_cuda_paged_kernel_matches_plain(case):
    """The paged kernels against their plain version (pages gathered into
    a ring) and against the ring kernel on the gathered pages: permuted
    tables with spare pages, kv_len ending mid-page, empty rows, ragged
    q_len (onepass: 0, 1 and full rows in one call)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    exact_float32_matmul()
    kind, b, hq, hkv, sq, page, n_pages, d, window = case
    rng = np.random.default_rng(b * 100 + page + sq)
    bh, rep = b * hq, hq // hkv
    total = b * n_pages + 4

    def t(a):
        return torch.from_numpy(np.asarray(a)).cuda()

    pt = rng.permutation(np.arange(1, total))[:b * n_pages]
    pt = t(pt.reshape(b, n_pages).astype(np.int32))
    k = t(rng.integers(-128, 128, (total, page, hkv, d), dtype=np.int8))
    v = t(rng.integers(-128, 128, (total, page, hkv, d), dtype=np.int8))
    q = t(rng.integers(-128, 128, (bh, sq, d), dtype=np.int8))
    lmult = t(rng.uniform(0.004, 0.03, bh).astype(np.float32))
    omult = t(rng.uniform(0.5, 2.0, bh).astype(np.float32))
    kv_b = rng.integers(1, n_pages * page + 1, b).astype(np.int32)
    kv_b[-1] = 0                                   # an empty row
    kv_len = np.repeat(kv_b, hq)
    if kind == "onepass":
        q_b = rng.choice([0, 1, sq], b).astype(np.int32)
        q_b[0] = sq
    else:
        q_b = np.full(b, sq, np.int32)
    q_len = np.repeat(q_b, hq)
    fn = getattr(K, f"ita_attention_{kind}_paged")
    ring_fn = getattr(K, f"ita_attention_{kind}")
    ring_k, ring_v = K.gather_pages(k, pt), K.gather_pages(v, pt)
    for adaptive in (True, False):
        kw = dict(q_offset=t(np.maximum(kv_len - q_len, 0)), q_len=t(q_len),
                  causal=True, window=window, adaptive=adaptive,
                  kv_rep=rep, hq=hq)
        got = fn(q, k, v, pt, lmult, omult, t(kv_len), **kw)
        want = K.paged_attention_plain(q, k, v, pt, lmult, omult,
                                       t(kv_len), **kw)
        ring = ring_fn(q, ring_k, ring_v, lmult, omult, t(kv_len),
                       block_kv=page, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), adaptive
        assert torch.equal(got, ring), adaptive


@pytest.mark.cuda
@pytest.mark.parametrize("max_cluster", [1, 8])
@pytest.mark.parametrize("sq", [1, 3])
def test_cuda_decode_kv_len_edges(sq, max_cluster, monkeypatch):
    """The decode kernel at qwen2-7b widths over a ring of 640 tokens
    (5 tiles), the heads of each kv row with their own kv_len among 1,
    128, 129 and the capacity (and a few drawn), both as clusters of the
    row's tiles and as one streaming block per kv row (``max_cluster``
    1: four stages), against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    exact_float32_matmul()
    b, hq, hkv, skv, d = 4, 28, 4, 640, 128
    rng = np.random.default_rng(640 + sq)
    bh = b * hq

    def t(a):
        return torch.from_numpy(np.asarray(a)).cuda()

    q = t(rng.integers(-128, 128, (bh, sq, d), dtype=np.int8))
    k = t(rng.integers(-128, 128, (b, skv, hkv, d), dtype=np.int8))
    v = t(rng.integers(-128, 128, (b, skv, hkv, d), dtype=np.int8))
    lmult = t(rng.uniform(0.004, 0.03, bh).astype(np.float32))
    omult = t(rng.uniform(0.5, 2.0, bh).astype(np.float32))
    edges = np.array([1, 128, 129, skv], np.int32)
    kv_len = np.where(rng.random(bh) < 0.7, rng.choice(edges, bh),
                      rng.integers(sq, skv + 1, bh)).astype(np.int32)
    kv_len = np.maximum(kv_len, sq)
    monkeypatch.setattr(K, "DECODE_MAX_CLUSTER", max_cluster)
    for adaptive in (True, False):
        kw = dict(q_offset=t(kv_len - sq), causal=True, adaptive=adaptive,
                  kv_rep=hq // hkv, hq=hq)
        got = K.ita_attention_decode(q, k, v, lmult, omult, t(kv_len), **kw)
        want = K.attention_plain(q, k, v, lmult, omult, t(kv_len), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), adaptive


@pytest.mark.cuda
def test_cuda_decode_full_card_streams():
    """A decode call whose kv rows fill the card (40 sequences x 4 kv
    heads = 160 blocks on 132 SMs) runs one streaming block per kv row
    (no cluster), equal to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    exact_float32_matmul()
    b, hq, hkv, skv, d = 40, 28, 4, 384, 128
    rng = np.random.default_rng(160)
    bh = b * hq

    def t(a):
        return torch.from_numpy(np.asarray(a)).cuda()

    q = t(rng.integers(-128, 128, (bh, 1, d), dtype=np.int8))
    k = t(rng.integers(-128, 128, (b, skv, hkv, d), dtype=np.int8))
    v = t(rng.integers(-128, 128, (b, skv, hkv, d), dtype=np.int8))
    lmult = t(rng.uniform(0.004, 0.03, bh).astype(np.float32))
    omult = t(rng.uniform(0.5, 2.0, bh).astype(np.float32))
    kv_len = rng.integers(1, skv + 1, bh).astype(np.int32)
    geo = K.decode_geometry(bh, 1, d, 128, hq // hkv,
                            torch.cuda.get_device_properties(0)
                            .multi_processor_count, skv // 128)
    assert geo["cluster"] == 1
    kw = dict(q_offset=t(kv_len - 1), causal=True, kv_rep=hq // hkv, hq=hq)
    got = K.ita_attention_decode(q, k, v, lmult, omult, t(kv_len), **kw)
    want = K.attention_plain(q, k, v, lmult, omult, t(kv_len), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 200])
def test_cuda_onepass_paged_prefill_decode_idle_rows(window):
    """The paged onepass kernel on the serve's mixed call at qwen2-7b
    widths (28/4 heads, d 128, 128-token pages): batch rows with 96, 1
    and 0 queries in one call, against its plain version and the ring
    kernel on the gathered pages."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    exact_float32_matmul()
    b, hq, hkv, sq, page, n_pages, d = 3, 28, 4, 96, 128, 9, 128
    rng = np.random.default_rng(96 + window)
    bh, total = b * hq, b * n_pages + 3

    def t(a):
        return torch.from_numpy(np.asarray(a)).cuda()

    pt = rng.permutation(np.arange(1, total))[:b * n_pages]
    pt = t(pt.reshape(b, n_pages).astype(np.int32))
    k = t(rng.integers(-128, 128, (total, page, hkv, d), dtype=np.int8))
    v = t(rng.integers(-128, 128, (total, page, hkv, d), dtype=np.int8))
    q = t(rng.integers(-128, 128, (bh, sq, d), dtype=np.int8))
    lmult = t(rng.uniform(0.004, 0.03, bh).astype(np.float32))
    omult = t(rng.uniform(0.5, 2.0, bh).astype(np.float32))
    kv_len = t(np.repeat(np.array([1000, 515, 300], np.int32), hq))
    q_len = t(np.repeat(np.array([96, 1, 0], np.int32), hq))
    for adaptive in (True, False):
        kw = dict(q_offset=torch.clamp(kv_len - q_len, min=0), q_len=q_len,
                  causal=True, window=window, adaptive=adaptive,
                  kv_rep=hq // hkv, hq=hq)
        got = K.ita_attention_onepass_paged(q, k, v, pt, lmult, omult,
                                            kv_len, **kw)
        want = K.paged_attention_plain(q, k, v, pt, lmult, omult, kv_len,
                                       **kw)
        ring = K.ita_attention_onepass(q, K.gather_pages(k, pt),
                                       K.gather_pages(v, pt), lmult, omult,
                                       kv_len, block_kv=page, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), adaptive
        assert torch.equal(got, ring), adaptive
        assert not got[2 * hq:].any() and not got[hq:2 * hq, 1:].any()


TWOPASS_CASES = [
    # bh, kv_rep, sq, skv, d, block_kv, causal, window, ragged ("pad": row
    # 0 sees one key, row 1 none — its queries are the call's pad rows,
    # A still written, output 0)
    (4, 1, 40, 128, 16, 64, True, 0, False),
    (14, 7, 64, 384, 32, 128, True, 0, True),
    (4, 2, 32, 192, 16, 64, True, 40, True),
    (2, 1, 16, 48, 16, 48, False, 0, False),
    (56, 7, 512, 512, 128, 128, True, 0, False),
    # the 64/128-row blocks of csrc/twopass.cu: the largest KV tile, 40
    # queries x 7 heads (280 packed rows, not a multiple of the block),
    # head dim 64 at kv_rep 7, and pad rows
    (28, 7, 256, 512, 128, 256, True, 0, False),
    (28, 7, 40, 384, 128, 128, True, 0, True),
    (14, 7, 96, 256, 64, 128, True, 0, False),
    (14, 7, 48, 256, 128, 128, True, 0, "pad"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TWOPASS_CASES, ids=[
    f"twopass-sq{c[2]}-skv{c[3]}-d{c[4]}-rep{c[1]}-w{c[7]}"
    for c in TWOPASS_CASES])
def test_cuda_twopass_matches_plain(case):
    """Both twopass kernels (B5a, B5b) against their plain versions: out
    and A through the wrapper, then each pass alone on the same inputs
    (pass 1's statistics too), also in the other block size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    exact_float32_matmul()
    bh, rep, sq, skv, d, bkv, causal, window, ragged = case
    rng = np.random.default_rng(bh * 10 + skv + sq)

    def t(a):
        return torch.from_numpy(np.asarray(a)).cuda()

    q = t(rng.integers(-128, 128, (bh, sq, d), dtype=np.int8))
    k = t(rng.integers(-128, 128, (bh // rep, skv, d), dtype=np.int8))
    v = t(rng.integers(-128, 128, (bh // rep, skv, d), dtype=np.int8))
    lmult = t(rng.uniform(0.004, 0.03, bh).astype(np.float32))
    omult = t(rng.uniform(0.5, 2.0, bh).astype(np.float32))
    kv_len = rng.integers(1, skv + 1, bh) if ragged else np.full(bh, skv)
    if ragged == "pad":
        kv_len[:2] = (1, 0)
    kv_len = t(kv_len.astype(np.int32))
    q_offset = torch.clamp(kv_len - sq, min=0)
    for adaptive in (True, False):
        kw = dict(q_offset=q_offset, causal=causal, window=window,
                  block_kv=bkv, kv_rep=rep)
        out, a = K.ita_attention_twopass(q, k, v, lmult, omult, kv_len,
                                         adaptive=adaptive, **kw)
        want_out, want_a = K.twopass_plain(q, k, v, lmult, omult, kv_len,
                                           adaptive=adaptive, **kw)
        want1 = K.twopass_qk_plain(q, k, lmult, kv_len, adaptive=adaptive,
                                   **kw)
        want2 = K.twopass_av_plain(*want1, v, omult, kv_len, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, want_out), adaptive
        assert torch.equal(a, want_a), adaptive
        # each pass alone, in the call's geometry and in the blocks of
        # 128 and 64 rows that an SM count of 1 and of 10^6 gives
        bkv_ = min(bkv, skv)
        for sms in (None, 1, 10 ** 6):
            geo = (dict.fromkeys(("qk", "av")) if sms is None else
                   K.twopass_geometry(bh, sq, d, bkv_, rep, sms, skv // bkv_))
            launch, got1 = K.twopass_qk_launcher(
                q, k, lmult, kv_len, adaptive=adaptive, geometry=geo["qk"],
                **kw)
            launch()
            launch, got2 = K.twopass_av_launcher(*want1, v, omult, kv_len,
                                                 geometry=geo["av"], **kw)
            launch()
            torch.cuda.synchronize()
            for g, w in zip(got1, want1, strict=True):
                assert torch.equal(g, w), (adaptive, sms)
            assert torch.equal(got2, want2), (adaptive, sms)
        if ragged == "pad":
            assert not out[1].any() and a[1].any()


SOFTMAX_CASES = [
    # r, c, block_c
    (64, 512, 128),
    (40, 300, 64),
    (1024, 512, 512),
    (7, 96, 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SOFTMAX_CASES, ids=[
    f"softmax-r{c[0]}-c{c[1]}-bc{c[2]}" for c in SOFTMAX_CASES])
def test_cuda_softmax_matches_plain(case):
    """The standalone softmax kernel (B6) against its plain version through
    ``ops.ita_softmax`` (padded columns, row counts off the kernel's
    8-row block, a fully masked row, a causal mask), paper and adaptive
    DI."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    from repro_torch.kernels.ita_softmax import kernel as SK
    from repro_torch.kernels.ita_softmax.ops import ita_softmax
    r, c, bc = case
    rng = np.random.default_rng(r + c + bc)
    x = torch.from_numpy(rng.integers(-128, 128, (r, c), dtype=np.int8))
    mask = torch.from_numpy((rng.random((r, c)) > 0.2).astype(np.int8))
    mask[r // 2] = 0
    causal = torch.ones(r, c, dtype=torch.int8).tril(c - r)
    for m in (mask, causal):
        for adaptive in (True, False):
            got = ita_softmax(x.cuda(), m.cuda(), block_c=bc,
                              adaptive=adaptive)
            want = ita_softmax(x, m, block_c=bc, adaptive=adaptive)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), adaptive
            pad = (-c) % bc
            xp = torch.nn.functional.pad(x, (0, pad)).cuda()
            mp = torch.nn.functional.pad(m, (0, pad)).cuda()
            plain = SK.softmax_plain(xp, mp, block_c=bc, adaptive=adaptive)
            torch.cuda.synchronize()
            assert torch.equal(got, plain[:, :c]), adaptive


MATMUL_CASES = [
    # m, k, n, block_m, block_n, block_k
    (8, 32, 16, 32, 16, 32),
    (100, 200, 96, 32, 16, 32),
    (33, 65, 17, 32, 16, 32),         # no dimension a multiple of its block
    (4, 3584, 512, 256, 128, 128),    # a decode step of qwen2-7b's wk
    (300, 520, 260, 256, 128, 128),   # partial row, column and k tiles
    (130, 1000, 136, 64, 64, 200),    # B7b k tiles of 200 (not a multiple of 64)
    # B7a's rows geometry (at most 16 rows) and the wgmma one above it
    (1, 256, 64, 256, 128, 128),      # one row
    (4, 18944, 256, 256, 128, 128),   # a decode step over a long K
    (8, 1024, 96, 256, 128, 128),
    (16, 3584, 512, 256, 128, 128),   # 16 rows
    (17, 640, 200, 256, 128, 128),    # 17 rows: wgmma, one 128-row tile
    (2000, 3584, 512, 256, 128, 128),  # wk-shaped prefill: B7b's M in 16
                                       # ranges
    (1000, 1000, 2600, 256, 128, 128),  # B7b's partial sums staged: 168
                                        # blocks
    (256, 3328, 256, 256, 128, 1664),  # B7b's largest k tile: one weight tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MATMUL_CASES, ids=[
    "matmul-m{}-k{}-n{}-b{}x{}x{}".format(*c) for c in MATMUL_CASES])
def test_cuda_int8_matmul_matches_plain(case):
    """Both int8 matmul kernels (B7a, B7b) through ``ops.int8_matmul``
    against the plain version of their schedule on the CPU and the plain
    reference on the card (padding of M, K and N included), against each
    other, with one launch per call of either; the weight given row-major
    (transposed by the wrapper) or as a K-major view (read as it is); an
    accumulator above 2^24 checks the float32 conversion."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    from repro_torch.kernels.int8_matmul import kernel as MK
    from repro_torch.kernels.int8_matmul.ops import int8_matmul
    m, k, n, bm, bn, bk = case
    rng = np.random.default_rng(m + k + n)
    x = rng.integers(-128, 128, (m, k), dtype=np.int8)
    w = rng.integers(-128, 128, (k, n), dtype=np.int8)
    x[0], w[:, 0] = 127, 127
    bias = rng.integers(-2 ** 16, 2 ** 16, n, dtype=np.int32)
    mult = (rng.uniform(0.5, 2.0, n) * 127 / (3 * 74 ** 2 * k ** 0.5)) \
        .astype(np.float32)
    mult[0] = 100 / (127 * 127 * k)
    args = [torch.from_numpy(a) for a in (x, w, bias, mult)]
    dev = [a.cuda() for a in args]
    w_km = dev[1].t().contiguous().t()         # the same values, K-major
    assert not w_km.is_contiguous()
    blocks = dict(block_m=bm, block_n=bn, block_k=bk)
    want_ref = int8_matmul(*dev, use_pallas=False)
    outs = {}
    for schedule, name in (("tpu", "int8_matmul"),
                           ("weight_stationary", "int8_matmul_ws")):
        want = int8_matmul(*args, **blocks, schedule=schedule)
        for layout, w_dev in (("row-major", dev[1]), ("k-major", w_km)):
            MK.reset_launches()
            got = int8_matmul(dev[0], w_dev, *dev[2:], **blocks,
                              schedule=schedule)
            torch.cuda.synchronize()
            assert MK.LAUNCHES[name] == 1, (schedule, layout, MK.LAUNCHES)
            assert torch.equal(got.cpu(), want), (schedule, layout)
            assert torch.equal(got, want_ref), (schedule, layout)
            outs[schedule, layout] = got
    assert all(torch.equal(o, outs["tpu", "row-major"])
               for o in outs.values())
    assert (want_ref.abs() < 127).float().mean() > 0.5     # not saturated


@pytest.mark.cuda
def test_cuda_int8_matmul_refuses_what_it_cannot_load():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    from repro_torch.kernels.int8_matmul import kernel as MK
    x = torch.zeros((8, 30), dtype=torch.int8, device="cuda")
    w = torch.zeros((30, 8), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="multiples of 4"):
        MK.kernel_launcher(x, w, 0, 1.0, block_k=30)
    x = torch.zeros((8, 4096), dtype=torch.int8, device="cuda")
    w = torch.zeros((4096, 8), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="resident weight tile"):
        MK.kernel_launcher(x, w, 0, 1.0, block_k=2048,
                           schedule="weight_stationary")
    # B7b's launcher checks the geometry it is given: partial sums staged
    # beside two weight tiles of 1664 bytes do not fit two blocks to an SM
    from repro_torch.kernels import build
    wt = torch.zeros((128, 4096), dtype=torch.int8, device="cuda")
    psum = torch.zeros((8, 128), dtype=torch.int32, device="cuda")
    out = torch.empty((8, 128), dtype=torch.int8, device="cuda")
    bias = torch.zeros(128, dtype=torch.int32, device="cuda")
    mult = torch.ones(128, device="cuda")
    ptrs = [t.data_ptr() for t in (x, wt, bias, mult, psum, out)]
    launch = build.launcher("int8_matmul_ws_launch")
    stream = torch.cuda.current_stream().cuda_stream
    assert launch(*ptrs, 8, 128, 4096, 1664, 128, 1, 1, stream) == 1
    assert launch(*ptrs, 8, 128, 4096, 1664, 128, 0, 0, stream) == 0
    torch.cuda.synchronize()


def _smoke_decode_start(cfg, model, prompts, paged):
    """The decode loop's carry after a prefill of ``prompts``."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_caches
    b, s = prompts.shape
    caches = init_caches(cfg, b, s + 12, paged=paged, page_size=16,
                         device="cuda")
    logits, caches = make_prefill_step(cfg)(model, prompts, caches)
    return (torch.argmax(logits, dim=-1).to(torch.int32),
            torch.full((b,), s, dtype=torch.int32, device="cuda"),
            torch.zeros((b,), dtype=torch.bool, device="cuda"),
            torch.zeros((), dtype=torch.int32, device="cuda"), caches)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_cuda_captured_decode_step_equals_eager(paged):
    """A decode step captured in a CUDA graph (``CapturedSteps``) gives the
    eager step's bits over 8 replays on the smoke-width model: tokens,
    positions and every layer's KV state; each call counts one launch of
    the decode kernel per layer (the warm-up launches, the capture does
    not, every replay adds what the capture saw), and the static buffers
    are the first carry's own tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs)")
    exact_float32_matmul()
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import (CapturedSteps, make_decode_body,
                                          tree_leaves)
    from repro_torch.models import init_model
    cfg = get_config("qwen2-7b", smoke=True, attention_impl="ita")
    model = init_model(cfg, seed=0, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (3, 20), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(1))
    name = "ita_attention_decode_paged" if paged else "ita_attention_decode"
    body = make_decode_body(cfg, model, None, 1.0, sample=False, eos_id=None,
                            pad_id=0)
    graphs = CapturedSteps("cuda")
    with torch.inference_mode():
        eager = _smoke_decode_start(cfg, model, prompts, paged)
        captured = _smoke_decode_start(cfg, model, prompts, paged)
        first = tree_leaves(captured)
        for step in range(9):                  # warm-up + capture, 8 replays
            eager, _ = body(eager)
            K.reset_launches()
            captured, _ = graphs.run("decode", body, captured)
            torch.cuda.synchronize()
            assert K.LAUNCHES[name] == cfg.n_layers, (step, K.LAUNCHES)
            assert sum(K.LAUNCHES.values()) == cfg.n_layers
            for a, b in zip(tree_leaves(eager), tree_leaves(captured),
                            strict=True):
                assert torch.equal(a, b), step
    assert list(graphs.graphs) == ["decode"] and graphs.capture_s > 0
    # the first carry is the static buffers: no KV pool was copied
    assert all(s is t for s, t in zip(graphs.static, first, strict=True))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(paged=True),
                                dict(eos="row 0", early_exit=True),
                                dict(sampled=True)],
                         ids=["ring", "paged", "eos", "sampled"])
def test_cuda_fused_generate_counts_replays_and_equals_stepwise(kw):
    """``generate(loop="fused")`` on the card: the tokens of
    ``loop="stepwise"`` (sampled: the same draws from generators of one
    seed, the graph's registered with it), and the decode kernel's
    counter at one launch per layer and step, the steps replayed from
    the graph included, in the capturing call and in the call that
    replays the kept graph (a sampled call captures its own)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs)")
    exact_float32_matmul()
    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_model
    from repro_torch.runtime.generate import generate
    cfg = get_config("qwen2-7b", smoke=True, attention_impl="ita")
    model = init_model(cfg, seed=0, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (3, 20),
                            generator=torch.Generator().manual_seed(2))
    name = "ita_attention_decode_paged" if kw.get("paged") \
        else "ita_attention_decode"
    kw = dict(kw)
    if kw.pop("eos", None):
        kw["eos_id"] = int(generate(model, cfg, prompts, 10).tokens[0, 3])
    sampled = kw.pop("sampled", False)
    runs = {}
    for loop in ("stepwise", "fused", "fused again"):
        if sampled:
            kw.update(temperature=0.8, generator=torch.Generator(
                "cuda").manual_seed(5))
        K.reset_launches()
        runs[loop] = generate(model, cfg, prompts, 10, loop=loop.split()[0],
                              **kw)
        torch.cuda.synchronize()
        assert K.LAUNCHES[name] == \
            cfg.n_layers * runs[loop].decode_steps, (loop, K.LAUNCHES)
    for loop in ("fused", "fused again"):
        assert torch.equal(runs[loop].tokens, runs["stepwise"].tokens)
        assert runs[loop].decode_steps == runs["stepwise"].decode_steps
        assert runs[loop].n_decode_tokens == runs["stepwise"].n_decode_tokens
    assert (runs["fused again"].capture_s > 0) == sampled
