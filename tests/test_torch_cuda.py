"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card the test skips. It imports neither JAX
nor ``repro``, so it runs where only torch and the CUDA toolkit are
installed: ``python -m pytest -m cuda tests/test_torch_cuda.py``. Each kernel
must equal its plain version on the same CUDA tensors bit for bit: 3D
and 4D rings and paged pools, GQA, ragged rows and query counts, causal
and windowed, adaptive and paper DI, short rings (one tile of 20) and
multi-tile ones; the twopass kernels (out, A and pass 1's statistics),
the standalone softmax kernel and both int8 matmul kernels. The direct
and baseline backends (``ita_direct_xla``, ``ibert_xla``, ``float_xla``;
plain torch ops) on the card equal their CPU results, and smoke-width
``generate()`` through them launches no fused kernel and gives equal
tokens from both loops. The recurrent blocks' scans on the card equal
(RG-LRU) or lie within 1e-5 of (RWKV6's wkv) the CPU's, and
recurrentgemma-smoke and rwkv6-smoke give the stepwise loop's tokens
from the fused one. The six capture lints run on the card
(``repro_torch.analysis.lints``), the nine kernels on calls at the
declared extremes equal their plain versions inside their certificates'
proven intervals (``analysis/extremes.py``), and ``roofline.op_costs``
counts a train step's backward and a decode step's kernel on the card
as on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis.extremes import KERNELS as EXTREME_KERNELS
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
    # phi3-mini's 32/32 heads at head dim 96 (kv_rep 1) and olmoe-1b-7b's
    # 16/16 at 128: prefill, decode-shaped onepass and the decode block
    ("onepass", 2, 32, 32, 40, 384, 96, 128, True, 0, "4d"),
    ("onepass", 2, 32, 32, 1, 640, 96, 128, True, 0, "3d"),
    ("decode", 2, 32, 32, 1, 640, 96, 128, True, 0, "4d"),
    ("decode", 1, 32, 32, 8, 2304, 96, 128, True, 300, "3d"),
    ("onepass", 2, 16, 16, 40, 384, 128, 128, True, 0, "4d"),
    ("decode", 2, 16, 16, 1, 640, 128, 128, True, 0, "4d"),
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
    # phi3-mini's and olmoe-1b-7b's heads (kv_rep 1; head dims 96, 128)
    ("onepass", 3, 32, 32, 96, 128, 4, 96, 0),
    ("decode", 2, 32, 32, 1, 128, 9, 96, 0),
    ("onepass", 3, 16, 16, 96, 128, 4, 128, 0),
    ("decode", 2, 16, 16, 1, 128, 9, 128, 0),
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


@pytest.mark.cuda
def test_cuda_captured_mixed_step_copies_shared_page_on_write():
    """Copy-on-write inside a captured mixed step (smoke width, 32-token
    pages, a 2-page window): slot 0 prefills 64 tokens and finishes, its
    pages kept; slot 1 adopts its first page and prefills a 96-token
    stream of the same leading tokens in 16-token chunks, so its third
    step wraps onto the shared page and copies it. Replayed from a CUDA
    graph (the copy in the second replay), every tensor of the carry and
    the tokens equal the eager steps'; the copy happened (slot 1's first
    page is its own, the shared page's refcount back to 1) and the
    invariants hold in every layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs)")
    exact_float32_matmul()
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import (CapturedSteps, ServeSlotState,
                                          admit_chunked, make_serve_segment,
                                          tree_leaves)
    from repro_torch.models import init_caches, init_model
    from repro_torch.runtime.generate import _adopt_prefix_slots
    cfg = get_config("qwen2-7b", smoke=True, attention_impl="ita")
    model = init_model(cfg, seed=0, device="cuda")
    page, chunk = 32, 16
    stream = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 96)).astype(np.int32)

    def seg(segment, graphs=None):
        return make_serve_segment(cfg, segment=segment, sample=False,
                                  eos_id=None, pad_id=0, chunk=chunk,
                                  budget=chunk + 1, graphs=graphs)

    def start():
        caches = init_caches(cfg, 2, 2 * page, paged=True, page_size=page,
                             num_pages=6, device="cuda")
        state = admit_chunked(ServeSlotState.init(2, 96, "cuda"), [0],
                              stream, [2 * page], [1])
        _, _, _, state, caches, _ = seg(4)(model, state, caches, 1.0)
        shared = caches[0]["mix"].page_table[0, 0].item()
        caches = _adopt_prefix_slots(caches, [1], [[shared, 0]], [1],
                                     [page])
        state = admit_chunked(state, [1], stream, [96], [4], shared=[page])
        return caches, state, shared

    with torch.inference_mode():
        (c_e, s_e, shared), (c_g, s_g, _) = start(), start()
        step_e, step_g = seg(1), seg(1, CapturedSteps("cuda"))
        for i in range(3):
            t_e, _, _, s_e, c_e, _ = step_e(model, s_e, c_e, 1.0)
            t_g, _, _, s_g, c_g, _ = step_g(model, s_g, c_g, 1.0)
            torch.cuda.synchronize()
            for a, b in zip(tree_leaves((c_e, s_e, t_e)),
                            tree_leaves((c_g, s_g, t_g)), strict=True):
                assert torch.equal(a, b), i
    pool = c_g[0]["mix"]
    table = pool.page_table.tolist()
    assert table[0][0] == shared and table[1][0] != shared, table
    assert pool.ref_count[shared].item() == 1
    for c in c_g:
        c["mix"].check_invariants()


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_cuda_journaled_serve_recovers_with_warm_restore(sampled, tmp_path):
    """A journaled serve on the card (smoke width, prefix sharing, a
    snapshot every segment) crashed at a round boundary and then
    mid-segment, recovered by ``serve_with_recovery``: the second restart
    restores the pools and the prefix index from the snapshot (greedy: the
    captured steps bind to the restored pools; sampled: eager steps, the
    journaled states of CUDA generators), and the tokens equal the calm
    serve's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    exact_float32_matmul()
    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_model
    from repro_torch.runtime.fault_tolerance import ServeFaultPlan
    from repro_torch.runtime.generate import ServeRequest, serve_continuous
    from repro_torch.runtime.journal import serve_with_recovery
    cfg = get_config("qwen2-7b", smoke=True, attention_impl="ita")
    model = init_model(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(4)
    shared = rng.integers(0, cfg.vocab_size, 140).astype(np.int32)
    reqs = [ServeRequest(prompt=np.concatenate(
        [shared, rng.integers(0, cfg.vocab_size, 4).astype(np.int32)]),
        gen=10, arrival=i * 2) for i in range(6)]
    kw = dict(slots=3, segment=4, max_len=256, page_size=128,
              chunk_size=48, prefix_sharing=True, debug_invariants=True)
    if sampled:
        kw.update(temperature=0.8, seed=3)
    calm = serve_continuous(model, cfg, reqs, **kw)
    K.reset_launches()
    res, crashes = serve_with_recovery(
        model, cfg, reqs, journal_dir=str(tmp_path / "j"), snapshot_every=1,
        plans=(ServeFaultPlan(crash_steps=(8,)),
               ServeFaultPlan(crash_after_steps=(16,))), **kw)
    torch.cuda.synchronize()
    assert crashes == 2 and res.recovered and res.restored_from_snapshot
    assert res.snapshot_bytes > 0 and res.replayed_tokens > 0
    assert K.LAUNCHES["ita_attention_onepass_paged"] > 0
    want = {c.index: c.tokens for c in calm.completed}
    assert {c.index for c in res.completed} == set(want)
    for c in res.completed:
        assert np.array_equal(c.tokens, want[c.index]), c.index


# --------------------------------------------------------------------------
# The direct/baseline backends (plain torch ops) on the card
# --------------------------------------------------------------------------

XLA_CASES = [
    # backend, mode, sq, skv, hq, hkv, d, window, softcap, query scale
    ("ita_direct_xla", "decode", 1, 640, 28, 4, 128, 0, 0.0, 0.0),
    ("ita_direct_xla", "decode", 2, 4096, 32, 16, 128, 4096, 0.0,
     144.0 ** -0.5),
    ("ita_direct_xla", "decode", 1, 4096, 32, 16, 128, 4096, 50.0,
     144.0 ** -0.5),
    ("ibert_xla", "decode", 1, 640, 28, 4, 128, 0, 0.0, 0.0),
    ("ibert_xla", "prefill", 256, 256, 28, 4, 128, 0, 0.0, 0.0),
    ("float_xla", "decode", 1, 640, 28, 4, 128, 0, 0.0, 0.0),
    ("float_xla", "prefill", 600, 600, 28, 4, 128, 0, 50.0, 0.1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", XLA_CASES, ids=[
    f"{c[0]}-{c[1]}-sq{c[2]}-skv{c[3]}-cap{c[8]:g}" for c in XLA_CASES])
def test_cuda_xla_backends_match_cpu(case):
    """Each direct/baseline backend through ``dispatch`` on CUDA tensors
    against the same call on the CPU: bit-exact on the integer paths
    (ITA direct, I-BERT) except, with a softcap, output rows whose
    logits hold a value within one float32 ulp of a .5 tie (CUDA's and
    the CPU's ``tanh`` may differ in the last bit); the float path
    within 1e-4 (``exp`` and float32 sums in other orders). Ragged
    positions over rings of qwen2-7b's and gemma2-27b's decode shapes
    (over 4096 keys a third of the rows hold such a tie; the others must
    be equal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    exact_float32_matmul()
    from repro_torch import attention as ATT
    from repro_torch.attention import xla as X
    from repro_torch.core.quant import EPS_MAX
    backend, mode, sq, skv, hq, hkv, d, window, cap, qs = case
    impl = {"ita_direct_xla": "ita", "ibert_xla": "ibert",
            "float_xla": "float"}[backend]
    rng = np.random.default_rng(skv + sq)
    b = 2
    q = rng.normal(0, 2.0, (b, sq, hq, d)).astype(np.float32)
    if impl == "float":
        k = rng.normal(0, 2.0, (b, skv, hkv, d)).astype(np.float32)
        v = rng.normal(0, 1.0, (b, skv, hkv, d)).astype(np.float32)
    else:
        k = rng.integers(-128, 128, (b, skv, hkv, d), dtype=np.int8)
        v = rng.integers(-128, 128, (b, skv, hkv, d), dtype=np.int8)
    if mode == "decode":
        kv_len = np.array([skv, skv // 3], np.int32)
        q_offset, kv = kv_len - sq, kv_len
    else:
        q_offset, kv = 0, None
    spec = ATT.AttentionSpec(mode=mode, impl=impl, window=window,
                             softcap=cap, query_scale=qs, q_len=sq,
                             n_heads=hq)
    scales = (0.05, 0.04, 0.06, 0.03)

    def run(dev):
        def t(a):
            return torch.as_tensor(a, device=dev) \
                if isinstance(a, np.ndarray) else a
        return ATT.dispatch(
            t(q), t(k), t(v), spec=spec, backend=backend,
            scales=ATT.QuantScales(*(torch.tensor(s, device=dev)
                                     for s in scales)),
            q_offset=t(q_offset), kv_len=t(kv)).cpu()
    got, want = run("cuda"), run("cpu")
    if impl == "float":
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        return
    same = (got == want).all(-1)                        # (B, Sq, H) rows
    if not cap:
        assert bool(same.all())
        return
    q8 = X.quantize_to_int8(torch.from_numpy(q), torch.tensor(scales[0]))
    acc = X.gqa_logits(q8.float(), torch.from_numpy(k).float())
    mult = torch.tensor(scales[0]) * torch.tensor(scales[1]) \
        * torch.tensor(np.float32(qs))
    pre = X.softcap(acc * mult, cap) / torch.tensor(np.float32(EPS_MAX))
    frac = (pre - torch.floor(pre) - 0.5).abs()
    ulp = torch.nextafter(pre.abs(), torch.tensor(np.inf)) - pre.abs()
    tie = (frac <= ulp).any(-1)                         # (B, G, M, Sq)
    tie = tie.permute(0, 3, 1, 2).reshape(b, sq, hq)
    assert bool(same[~tie].all()) and bool((~tie).any())


@pytest.mark.cuda
@pytest.mark.parametrize("arch,impl", [("qwen2-7b", "float"),
                                       ("qwen2-7b", "ibert"),
                                       ("gemma2-27b", "ita")])
def test_cuda_generate_through_xla_backends(arch, impl):
    """Smoke-width ``generate()`` on the card through the direct/baseline
    backends: no fused attention kernel launches, the fused loop (its
    decode step replayed from a CUDA graph) gives the stepwise loop's
    tokens, and the prefill's last logits are within 5e-2 of the CPU's
    (float projections round differently on the two devices)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs)")
    exact_float32_matmul()
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_caches, init_model
    from repro_torch.runtime.generate import generate
    cfg = get_config(arch, smoke=True, attention_impl=impl)
    model = init_model(cfg, seed=0, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (3, 40),
                            generator=torch.Generator().manual_seed(2))
    logits = {}
    for dev in ("cpu", "cuda"):
        m = model.to(dev)
        with torch.inference_mode():
            logits[dev] = make_prefill_step(cfg)(
                m, prompts, init_caches(cfg, 3, 48, device=dev))[0].cpu()
    torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=5e-2,
                               rtol=0)
    runs = {}
    for loop in ("stepwise", "fused"):
        K.reset_launches()
        runs[loop] = generate(model, cfg, prompts, 10, loop=loop)
        torch.cuda.synchronize()
        assert not any(K.LAUNCHES.values()), K.LAUNCHES
    assert torch.equal(runs["fused"].tokens, runs["stepwise"].tokens)


@pytest.mark.cuda
def test_cuda_expert_ffn_rows_do_not_depend_on_their_block():
    """The experts' SwiGLU over the blocked capacity buffer (one
    ``(E, 128, d) @ (E, d, f)`` bmm per block, olmoe-1b-7b's widths in
    bf16) gives each row the same bits whatever the other rows of its
    block and whichever block holds it, and the same replayed from a
    CUDA graph: serve-equals-solo rests on it for MoE models."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models.moe import expert_ffn
    g = torch.Generator("cuda").manual_seed(4)
    e, d, f = 64, 2048, 1024

    def w(*shape):
        return (torch.randn(shape, generator=g, device="cuda")
                * shape[-2] ** -0.5).to(torch.bfloat16)
    wg, wu, wd = w(e, d, f), w(e, d, f), w(e, f, d)
    buf = torch.randn((3, e, 128, d), generator=g, device="cuda") \
        .to(torch.bfloat16)
    full = expert_ffn(buf, wg, wu, wd)
    moved = torch.zeros_like(buf[:1])
    moved[0, :, 5] = buf[2, :, 77]            # alone, at another row
    got = expert_ffn(moved, wg, wu, wd)
    assert torch.equal(got[0, :, 5], full[2, :, 77])
    shuffled = buf.flip(0)
    assert torch.equal(expert_ffn(shuffled, wg, wu, wd), full.flip(0))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        expert_ffn(buf, wg, wu, wd)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = expert_ffn(buf, wg, wu, wd)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, full)


def _olmoe_smoke():
    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_model
    cfg = get_config("olmoe-1b-7b", smoke=True, attention_impl="ita")
    return cfg, init_model(cfg, seed=0, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_cuda_olmoe_captured_decode_step_equals_eager(paged):
    """olmoe-smoke's decode step (the routing's sort, argsort,
    searchsorted, gathers and fixed-order combine inside) replayed from
    a CUDA graph gives the eager step's bits over 8 replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs)")
    exact_float32_matmul()
    from repro_torch.launch.steps import (CapturedSteps, make_decode_body,
                                          tree_leaves)
    cfg, model = _olmoe_smoke()
    prompts = torch.randint(0, cfg.vocab_size, (3, 20), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(1))
    body = make_decode_body(cfg, model, None, 1.0, sample=False, eos_id=None,
                            pad_id=0)
    graphs = CapturedSteps("cuda")
    with torch.inference_mode():
        eager = _smoke_decode_start(cfg, model, prompts, paged)
        captured = _smoke_decode_start(cfg, model, prompts, paged)
        for step in range(9):
            eager, _ = body(eager)
            captured, _ = graphs.run("decode", body, captured)
            torch.cuda.synchronize()
            for a, b in zip(tree_leaves(eager), tree_leaves(captured),
                            strict=True):
                assert torch.equal(a, b), step


@pytest.mark.cuda
def test_cuda_olmoe_captured_mixed_step_equals_eager():
    """olmoe-smoke's mixed serve step (two slots prefilling 16-token
    chunks of 40-token prompts, then decoding) replayed from a CUDA
    graph equals the eager steps in every tensor of the carry but the
    pools' sink page: the third chunk's 8 padding rows of each slot all
    write their dropped K/V there (``attention.state``), in an order no
    run fixes, and nothing ever reads it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs)")
    exact_float32_matmul()
    from repro_torch.launch.steps import (CapturedSteps, ServeSlotState,
                                          admit_chunked, make_serve_segment,
                                          tree_leaves)
    from repro_torch.models import init_caches
    cfg, model = _olmoe_smoke()
    prompts = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)

    def seg(graphs=None):
        return make_serve_segment(cfg, segment=1, sample=False, eos_id=None,
                                  pad_id=0, chunk=16, budget=33,
                                  graphs=graphs)

    def start():
        caches = init_caches(cfg, 2, 64, paged=True, page_size=32,
                             device="cuda")
        state = admit_chunked(ServeSlotState.init(2, 40, "cuda"), [0, 1],
                              prompts, [40, 40], [8, 8])
        return caches, state

    def read(caches):
        return [dataclasses.replace(c["mix"], k=c["mix"].k[:-1],
                                    v=c["mix"].v[:-1]) for c in caches]

    with torch.inference_mode():
        (c_e, s_e), (c_g, s_g) = start(), start()
        step_e, step_g = seg(), seg(CapturedSteps("cuda"))
        for i in range(6):
            t_e, _, _, s_e, c_e, _ = step_e(model, s_e, c_e, 1.0)
            t_g, _, _, s_g, c_g, _ = step_g(model, s_g, c_g, 1.0)
            torch.cuda.synchronize()
            for a, b in zip(tree_leaves((read(c_e), s_e, t_e)),
                            tree_leaves((read(c_g), s_g, t_g)),
                            strict=True):
                assert torch.equal(a, b), i


@pytest.mark.cuda
def test_cuda_olmoe_fused_generate_is_repeatable():
    """Greedy tokens equal across two fused ``generate()`` calls and the
    stepwise loop on olmoe-smoke: an order-dependent (atomic) combine
    would show here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs)")
    exact_float32_matmul()
    from repro_torch.runtime.generate import generate
    cfg, model = _olmoe_smoke()
    prompts = torch.randint(0, cfg.vocab_size, (4, 24),
                            generator=torch.Generator().manual_seed(2))
    runs = [generate(model, cfg, prompts, 12, loop=loop).tokens
            for loop in ("fused", "fused", "stepwise")]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("carried", [False, True], ids=["no-h0", "h0"])
def test_cuda_recurrent_scans_match_cpu(carried):
    """RG-LRU's scan (its odd/even recursion: elementwise products and
    sums, within 1e-6) and RWKV6's wkv scan on the card against the same
    functions on the CPU, at a 4096-token RG-LRU scan of rnn width 2560
    and a 64-step wkv scan of 64 heads of 64. The wkv step is a matmul:
    cuBLAS and the CPU sum its 64 products in other orders, and where
    the sum cancels the float32 result of either device is off by a
    share of the largest output, not of its own value (the CPU's is up
    to 2.3e-7 of max |o| from float64 at these inputs): ``rtol=1e-5``,
    ``atol=1e-6 · max |o|`` (and of ``max |S|`` for the state)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    exact_float32_matmul()
    from repro_torch.models import rglru as RG
    from repro_torch.models import rwkv6 as RW
    g = torch.Generator().manual_seed(int(carried))
    a = 0.3 + 0.7 * torch.rand((1, 4096, 2560), generator=g)
    x = torch.randn((1, 4096, 2560), generator=g)
    h0 = torch.randn((1, 2560), generator=g) if carried else None
    cpu = RG._rglru_scan(x, a, h0)
    card = RG._rglru_scan(x.cuda(), a.cuda(),
                          None if h0 is None else h0.cuda())
    torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=1e-6)
    r, k, v = (torch.randn((2, 64, 64, 64), generator=g) for _ in range(3))
    w = 0.8 + 0.2 * torch.rand((2, 64, 64, 64), generator=g)
    u = torch.randn((64, 64), generator=g)
    s0 = torch.randn((2, 64, 64, 64), generator=g) if carried \
        else torch.zeros((2, 64, 64, 64))
    o, s = RW._wkv_scan(r, k, v, w, u, s0)
    o_c, s_c = RW._wkv_scan(*(t.cuda() for t in (r, k, v, w, u, s0)))
    for got, want in ((o_c, o), (s_c, s)):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                   atol=1e-6 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("arch,paged", [
    ("recurrentgemma-2b", False), ("recurrentgemma-2b", True),
    ("rwkv6-7b", False)], ids=["recurrentgemma-ring", "recurrentgemma-paged",
                               "rwkv6"])
def test_cuda_recurrent_fused_generate_equals_stepwise(arch, paged):
    """recurrentgemma-smoke (the 16-entry local rings wrap under a
    20-token prompt) and rwkv6-smoke on the card: the fused loop's tokens
    equal the stepwise loop's and a second fused call's (the kept graph
    advances the recurrent state in place), and the decode kernel runs
    once per local-attention layer and step (none for rwkv6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs)")
    exact_float32_matmul()
    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_model
    from repro_torch.runtime.generate import generate
    cfg = get_config(arch, smoke=True, attention_impl="ita")
    model = init_model(cfg, seed=0, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (3, 20),
                            generator=torch.Generator().manual_seed(2))
    name = "ita_attention_decode_paged" if paged else "ita_attention_decode"
    n_attn = sum(pat.count("local") * n for pat, n in cfg.layer_groups)
    runs = {}
    for loop in ("stepwise", "fused", "fused again"):
        K.reset_launches()
        runs[loop] = generate(model, cfg, prompts, 10, loop=loop.split()[0],
                              paged=paged)
        torch.cuda.synchronize()
        assert K.LAUNCHES[name] == n_attn * runs[loop].decode_steps, (
            loop, K.LAUNCHES)
    for loop in ("fused", "fused again"):
        assert torch.equal(runs[loop].tokens, runs["stepwise"].tokens), loop


# the cross-attention shapes: whisper-large-v3's 20/20 heads of 64 over
# 1500 frames, llama-3.2-vision-90b's 64/8 of 128 over 1601 patches
CROSS_CASES = [(20, 20, 64, 1500), (64, 8, 128, 1601)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CROSS_CASES, ids=[
    f"h{c[0]}-kv{c[1]}-d{c[2]}-skv{c[3]}" for c in CROSS_CASES])
def test_cuda_noncausal_cross_attention_matches_plain(case):
    """B2 and B3 non-causal, as the cross layers call them: the memory's
    keys zero-padded to the 128-key tile (1500 -> 1536, 1601 -> 1664)
    with ``kv_len`` the unpadded count, queries at offset 0: a prefill of
    40 rows, a decode-shaped row (sq 1) and the paged kernel over a pool
    of 128-token pages (kv_len ending mid-page), against their plain
    versions and the ring kernel on the gathered pages."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    exact_float32_matmul()
    hq, hkv, d, skv = case
    b, page = 2, 128
    n_pages = -(-skv // page)
    rng = np.random.default_rng(skv)
    bh, rep = b * hq, hq // hkv

    def t(a):
        return torch.from_numpy(np.asarray(a)).cuda()

    def i8(*shape):
        return t(rng.integers(-128, 128, shape, dtype=np.int8))
    k, v = i8(b, n_pages * page, hkv, d), i8(b, n_pages * page, hkv, d)
    k[:, skv:] = 0
    v[:, skv:] = 0
    lmult = t(rng.uniform(0.004, 0.03, bh).astype(np.float32))
    omult = t(rng.uniform(0.5, 2.0, bh).astype(np.float32))
    kv_len = t(np.full(bh, skv, np.int32))
    total = b * n_pages + 3
    pt = t(rng.permutation(np.arange(1, total))[:b * n_pages]
           .reshape(b, n_pages).astype(np.int32))
    kp, vp = i8(total, page, hkv, d), i8(total, page, hkv, d)
    for sq in (40, 1):
        q = i8(bh, sq, d)
        kw = dict(q_offset=0, causal=False, adaptive=True, kv_rep=rep,
                  hq=hq)
        got = K.ita_attention_onepass(q, k, v, lmult, omult, kv_len,
                                      block_kv=page, **kw)
        want = K.attention_plain(q, k, v, lmult, omult, kv_len,
                                 block_kv=page, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), sq
        got = K.ita_attention_onepass_paged(q, kp, vp, pt, lmult, omult,
                                            kv_len, **kw)
        want = K.paged_attention_plain(q, kp, vp, pt, lmult, omult, kv_len,
                                       **kw)
        ring = K.ita_attention_onepass(q, K.gather_pages(kp, pt),
                                       K.gather_pages(vp, pt), lmult, omult,
                                       kv_len, block_kv=page, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), sq
        assert torch.equal(got, ring), sq


@pytest.mark.cuda
@pytest.mark.parametrize("arch,pin,paged", [
    ("whisper-large-v3", "", False),
    ("whisper-large-v3", "ita_onepass_pallas", True),
    ("llama-3.2-vision-90b", "ita_onepass_pallas", False)],
    ids=["whisper", "whisper-pinned-paged", "llama-vision-pinned"])
def test_cuda_encdec_fused_generate_equals_stepwise(arch, pin, paged):
    """whisper-smoke and llama-vision-smoke on the card: the fused loop's
    tokens equal the stepwise loop's and a second fused call's; the
    captured decode step reads the static cross caches (one kernel call
    per cross layer and step) and never runs the encoder."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs)")
    exact_float32_matmul()
    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_model
    from repro_torch.runtime.generate import generate
    cfg = get_config(arch, smoke=True, attention_impl="ita",
                     attention_backend=pin)
    model = init_model(cfg, seed=0, device="cuda")
    with torch.no_grad():
        for blk in model.blocks:
            for gate in ("gate_attn", "gate_mlp"):
                if hasattr(blk, gate):
                    getattr(blk, gate).fill_(0.5)
    g = torch.Generator().manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (3, 20), generator=g)
    frontend = torch.randn((3, cfg.n_frontend_tokens, cfg.frontend_dim),
                           generator=g)
    runs = {}
    for loop in ("stepwise", "fused", "fused again"):
        runs[loop] = generate(model, cfg, prompts, 10, frontend=frontend,
                              loop=loop.split()[0], paged=paged)
        torch.cuda.synchronize()
    for loop in ("fused", "fused again"):
        assert torch.equal(runs[loop].tokens, runs["stepwise"].tokens), loop


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["float", "ita"])
def test_cuda_train_step_matches_cpu(impl):
    """phi3-smoke, one ``make_train_step`` step on the card against the
    CPU's on the same weights and batch, by the check ``chip_smoke.py``
    12d runs (``repro_torch.launch.train_parity``). ``float``: loss and
    grad norm within 1e-5, every parameter within 1e-5 of its leaf's
    scale but the under 1% a near-zero gradient stepped the other way
    (by at most ``2·lr``: Adam's first step is ``~sign(g)·lr``);
    ``ita``: the loss within 5e-3 (a flipped ``s_out`` tie), and with the
    output fake-quant replaced by identity the grad norm, every gradient,
    the ``s_q``/``s_k`` gradients of the STE backward and the parameters
    (bounds and readings in its docstring); no fused kernel launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.launch.train_parity import (describe,
                                                 train_step_card_vs_cpu)
    print(describe(impl, train_step_card_vs_cpu("phi3-mini-3.8b", impl)))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-large-v3", "olmoe-1b-7b"])
def test_cuda_dots_remat_train_steps_equal_full(arch):
    """``remat_policy="dots"`` against ``"full"`` on the card at smoke
    width (bf16 storage, a float32 master): two ``make_train_step`` steps
    from seed 0 on the same batches, losses, parameters, masters and
    AdamW moments bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataPipeline, SyntheticSource
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_model
    from repro_torch.optim.optimizer import (AdamWConfig, init_opt_state,
                                             train_params)
    runs = {}
    for policy in ("dots", "full"):
        cfg = get_config(arch, smoke=True, attention_impl="ita",
                         dtype="bfloat16", param_dtype="bfloat16",
                         remat_policy=policy)
        model = init_model(cfg, seed=0, device="cuda")
        opt = init_opt_state(train_params(model))
        step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                                total_steps=2))
        pipe = DataPipeline(
            SyntheticSource(cfg.vocab_size, seed=0), batch=2, seq_len=64,
            device="cuda", frontend_shape=(
                (cfg.n_frontend_tokens, cfg.frontend_dim)
                if cfg.frontend_dim else None))
        losses = []
        for _ in range(2):
            opt, m = step(model, opt, pipe.next())
            losses.append(m["loss"])
        runs[policy] = (losses, dict(model.named_parameters()), opt)
    (dl, dp, do), (fl, fp, fo) = runs["dots"], runs["full"]
    assert all(torch.equal(a, b) for a, b in zip(dl, fl)), (dl, fl)
    assert do.master is not None
    for n, p in dp.items():
        for a, b in ((p, fp[n]), (do.master[n], fo.master[n]),
                     (do.mu[n], fo.mu[n]), (do.nu[n], fo.nu[n])):
            assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# The range certificates, the loop lints and the roofline's counter on the
# card (repro_torch.analysis, repro_torch.roofline)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_card_lints_pass():
    """All six lints run and pass on the card: each CUDA graph captured
    once, no recapture under preemption, carries in place, no host sync
    in a replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    from repro_torch.analysis.lints import run_lints
    exact_float32_matmul()
    rep = run_lints(smoke=True, device="cuda")
    assert len(rep["lints"]) == 6
    assert all(x["ran"] and x["ok"] for x in rep["lints"]), rep["lints"]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", EXTREME_KERNELS)
def test_cuda_kernel_at_extremes_inside_certificate(kernel):
    """The kernel on calls at the declared extremes (saturated Q/K/V,
    fully masked rows beside rows at the capacity, scales at
    SCALE_BOUNDS) equals its plain version bit for bit, every output
    inside its certificate's proven interval."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    from repro_torch.analysis.extremes import check_extremes
    exact_float32_matmul()
    rows = check_extremes("cuda", kernels=(kernel,))
    assert {r["kernel"] for r in rows} == {kernel}
    bad = [r for r in rows
           if not (r["certified"] and r["equal"] and r["inside"])]
    assert not bad, bad


@pytest.mark.cuda
def test_cuda_op_costs_count_train_step_and_decode():
    """``op_costs`` on the card: a phi3-smoke train step's backward (run
    by the autograd engine's device thread) and remat are counted as on
    the CPU; a qwen2-smoke decode step counts B4 by its formula and the
    projections at whole row blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataPipeline, SyntheticSource
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import forward, init_caches, init_model
    from repro_torch.optim.optimizer import (AdamWConfig, init_opt_state,
                                             train_params)
    from repro_torch.roofline import op_costs as OC
    exact_float32_matmul()
    cfg = get_config("phi3-mini-3.8b", smoke=True, attention_impl="ita")
    model = init_model(cfg, seed=0, device="cuda")
    opt = init_opt_state(train_params(model))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=2))
    batch = DataPipeline(SyntheticSource(cfg.vocab_size, seed=0), batch=2,
                         seq_len=64, device="cuda").next()
    with OC.counting() as c:
        step(model, opt, batch)
    want = OC.expected_flops(cfg, ShapeConfig("t", 64, 2, "train"))
    assert c.flops["dense"] == want["dense"], (c.flops, want)
    assert c.flops["other"] > 0
    cfg = get_config("qwen2-7b", smoke=True, attention_impl="ita")
    model = init_model(cfg, seed=0, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda")
    with torch.inference_mode():
        _, caches = forward(model, toks, cfg, mode="prefill",
                            caches=init_caches(cfg, 2, 128, device="cuda"))
        with OC.counting() as c:
            forward(model, toks[:, :1], cfg, mode="decode", caches=caches,
                    pos0=torch.full((2,), 64, device="cuda"))
    want = OC.expected_flops(cfg, ShapeConfig("d", 65, 2, "decode"))
    assert c.flops["dense"] == want["dense"]
    assert c.kernel_calls == {"ita_attention_decode": cfg.n_layers}
