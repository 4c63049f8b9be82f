"""Fused ITA attention kernels for Hopper and their plain versions.

``ita_attention_onepass``, ``ita_attention_decode``, their paged
variants ``ita_attention_onepass_paged`` and ``ita_attention_decode_paged``,
and ``ita_attention_twopass`` are the port's counterparts of the Pallas
entry points of the same names (``repro/kernels/ita_attention/
kernel.py:265-564``; their bodies ``onepass_kernel``, ``decode_kernel``,
``qk_da_kernel`` and ``av_en_kernel``). The ring entries take the same
operands:

- ``q`` (BH, Sq, D) int8 (decode: Sq <= 8);
- ``k``/``v`` int8 in the kernel layout (BH/kv_rep, Skv, D) — GQA: q row
  ``r`` reads kv row ``r // kv_rep`` — or the cache-native ring layout
  (B, Skv, G, D) with ``hq`` q heads per batch row (``r = b·hq + h``
  reads kv head ``h // kv_rep``), never broadcast or transposed;
- per-row requant multipliers and ``[kv_len, q_offset, q_len]`` meta
  (scalars broadcast; (BH,) vectors are the ragged batch).

The paged entries take K/V as a shared pool ``(P, page, G, D)`` and a
``page_table`` (B, n_pages) int32: logical tile ``j`` of row ``r`` is
pool page ``page_table[r // hq, j]``, the tile is the page, and the
schedule is the ring's — paged equals ring on the gathered pages bit for
bit. Their plain version gathers each row's pages into a contiguous
(B, n_pages·page, G, D) ring and runs ``attention_plain`` at
``block_kv = page``.

On a CPU tensor a wrapper computes its plain PyTorch version
(``attention_plain``: the same KV tile schedule through
``ref.stream_rows``, on any device — ``chip_smoke.py`` holds the kernels
to it on the card). On a CUDA tensor it launches its kernel
(``csrc/onepass.cu``, ``csrc/decode.cu``, one launcher each for rings
and pools; ``csrc/twopass.cu``) or raises — there is no fallback —
checks the launch status, and adds one to ``LAUNCHES[name]``.

``ita_attention_twopass`` (the paper's dataflow) takes K/V in the kernel
layout only and returns ``(out, A)``: pass 1 (``csrc/twopass.cu``,
counted as ``ita_attention_twopass_qk_da``) writes the int8 attention
matrix A and the per-row statistics after DA and DI, pass 2
(``ita_attention_twopass_av_en``) re-reads A for EN and p·V. Each pass
has its plain version (``twopass_qk_plain``, ``twopass_av_plain``) and
its binder (``twopass_qk_launcher``, ``twopass_av_launcher``).

The KV tile schedule is part of the arithmetic (the integer Σ shifts
depend on tile boundaries): ``block_kv`` is the tile, ``skv`` must be a
multiple of it, and no kernel splits a row's KV into parts that fold on
their own. The decode kernel may spread a row's tiles over the CTAs of a
cluster (``decode_geometry``), which fold them in tile order, as one
block would. The q tiling is free (query rows are independent).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import device_tensor, sm_count, tile_mask
from repro_torch.kernels.ita_attention.ref import (requant_logits,
                                                   stream_rows, twopass_out,
                                                   twopass_stats)

# Launches of each CUDA kernel since the last reset (plain versions and
# CPU calls do not count).
LAUNCHES = {"ita_attention_onepass": 0, "ita_attention_decode": 0,
            "ita_attention_onepass_paged": 0,
            "ita_attention_decode_paged": 0,
            "ita_attention_twopass_qk_da": 0,
            "ita_attention_twopass_av_en": 0}
# kernel -> exported launcher (``build.FUNCTIONS``)
_LAUNCHERS = {"ita_attention_onepass": "ita_onepass_launch",
              "ita_attention_decode": "ita_decode_launch",
              "ita_attention_onepass_paged": "ita_onepass_paged_launch",
              "ita_attention_decode_paged": "ita_decode_paged_launch",
              "ita_attention_twopass_qk_da": "ita_twopass_qk_launch",
              "ita_attention_twopass_av_en": "ita_twopass_av_launch"}
PAGED = ("ita_attention_onepass_paged", "ita_attention_decode_paged")

MAX_DECODE_Q = 8
_MAX_HEAD_DIM = 256
_MAX_SMEM = 232448          # bytes of shared memory one block may use
MAX_TILE = 256              # keys per KV tile the onepass and decode
                            # kernels take
ONEPASS_MANY_BLOCKS_PER_SM = 4  # 64-row blocks from this many per SM on
DECODE_MAX_STAGES = 4       # K/V stages of a streaming decode block
DECODE_MAX_CLUSTER = 8      # CTAs of a decode cluster (portable size)
TWOPASS_MAX_STAGES = 4      # K (pass 1) or V and A (pass 2) tiles in flight


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _row_mults(logit_mult, out_mult, bh, device):
    """Scalar or per-row requant multipliers -> (bh,) float32."""
    def rows(x):
        x = device_tensor(x, torch.float32, device).reshape(-1)
        return x.expand(bh).contiguous()
    return rows(logit_mult), rows(out_mult)


def _row_meta(kv_len, q_offset, q_len, bh, device):
    """Per-row ``[kv_len, q_offset, q_len]`` (bh, 3) int32; scalars
    broadcast to every row, (bh,) vectors pass through."""
    cols = []
    for x in (kv_len, q_offset, q_len):
        x = device_tensor(x, torch.int32, device).reshape(-1)
        if x.shape[0] not in (1, bh):
            raise ValueError(f"meta column of {x.shape[0]} entries for "
                             f"{bh} rows")
        cols.append(x.expand(bh))
    return torch.stack(cols, dim=1).contiguous()


def _kv_rows(x, bh, kv_rep, hq):
    """Per-row K or V (bh, skv, d) gathered from either layout."""
    r = torch.arange(bh, device=x.device)
    if x.ndim == 4:
        return x[r // hq, :, (r % hq) // kv_rep]
    return x[r // kv_rep]


def _row_valid(meta, sq, skv, causal, window):
    """(BH, Sq, Skv) validity of every (query, key) pair of every row."""
    col = [meta[:, i].view(-1, 1, 1) for i in range(3)]
    return tile_mask(0, 0, sq, skv, causal, window, kv_len=col[0],
                     q_offset=col[1], q_len=col[2], device=meta.device)


def _plain_rows(q, k, v, lmult, omult, meta, *, causal, window, adaptive,
                block_kv, kv_rep, hq):
    """The kernels' plain version: per-row logits, masks and values
    through the same KV tile loop. Returns (BH, Sq, D) int8."""
    bh, sq, _ = q.shape
    k_rows = _kv_rows(k, bh, kv_rep, hq)
    v_rows = _kv_rows(v, bh, kv_rep, hq)
    logits = requant_logits(q, k_rows, lmult.view(bh, 1, 1))
    valid = _row_valid(meta, sq, k_rows.shape[1], causal, window)
    return stream_rows(logits, valid, v_rows, omult.view(bh, 1, 1),
                       adaptive=adaptive, block_kv=block_kv)


def row_operands(q_q, k_q, v_q, logit_mult, out_mult, kv_len, q_offset,
                 q_len, kv_rep, hq):
    """Check a call's operands and resolve its per-row ``(lmult, omult,
    meta)`` — the operands ``_plain_rows`` and the kernels take."""
    bh, sq, d = q_q.shape
    if q_q.dtype != torch.int8 or k_q.dtype != torch.int8 \
            or v_q.dtype != torch.int8:
        raise TypeError("q/k/v must be int8")
    if k_q.shape != v_q.shape or k_q.shape[-1] != d:
        raise ValueError(f"k/v shapes {tuple(k_q.shape)}/{tuple(v_q.shape)}"
                         f" do not fit q {tuple(q_q.shape)}")
    if k_q.ndim == 4:
        if hq is None or bh % hq or k_q.shape[0] * hq != bh \
                or hq != k_q.shape[2] * kv_rep:
            raise ValueError(f"4D K/V {tuple(k_q.shape)} needs hq with "
                             f"B·hq = {bh} and G·kv_rep = hq")
    elif k_q.ndim == 3:
        if k_q.shape[0] * kv_rep != bh:
            raise ValueError(f"3D K/V {tuple(k_q.shape)} x kv_rep {kv_rep} "
                             f"!= {bh} rows")
    else:
        raise ValueError(f"K/V must be 3D or 4D, got {k_q.ndim}D")
    lmult, omult = _row_mults(logit_mult, out_mult, bh, q_q.device)
    meta = _row_meta(kv_len, q_offset, sq if q_len is None else q_len, bh,
                     q_q.device)
    return lmult, omult, meta


def gather_pages(pool, page_table):
    """The contiguous ring ``(B, n_pages·page, G, D)`` that a paged pool
    ``(P, page, G, D)`` holds for each row of ``page_table`` (B, n_pages)."""
    b, n = page_table.shape
    rows = pool[page_table.long()]                 # (B, n, page, G, D)
    return rows.reshape(b, n * pool.shape[1], *pool.shape[2:])


def paged_operands(q_q, k_pool, v_pool, page_table, logit_mult, out_mult,
                   kv_len, q_offset, q_len, kv_rep, hq):
    """Check a paged call's operands and resolve its per-row ``(lmult,
    omult, meta)``."""
    bh, sq, d = q_q.shape
    if q_q.dtype != torch.int8 or k_pool.dtype != torch.int8 \
            or v_pool.dtype != torch.int8:
        raise TypeError("q/k/v must be int8")
    if k_pool.ndim != 4 or k_pool.shape != v_pool.shape \
            or k_pool.shape[-1] != d:
        raise ValueError(f"pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} must be (P, page, G, {d})")
    if page_table.dtype != torch.int32 or page_table.ndim != 2:
        raise TypeError("page_table must be a (B, n_pages) int32 tensor")
    if bh % hq or page_table.shape[0] * hq != bh \
            or hq != k_pool.shape[2] * kv_rep:
        raise ValueError(f"page_table {tuple(page_table.shape)} and pool "
                         f"{tuple(k_pool.shape)} need B·hq = {bh} and "
                         f"G·kv_rep = hq (hq={hq}, kv_rep={kv_rep})")
    lmult, omult = _row_mults(logit_mult, out_mult, bh, q_q.device)
    meta = _row_meta(kv_len, q_offset, sq if q_len is None else q_len, bh,
                     q_q.device)
    return lmult, omult, meta


def _bind(name, args, out, keep):
    """``(launch, out)``: ``launch()`` enqueues kernel ``name`` with the
    bound ``args`` on the current stream and raises if the launch fails;
    ``keep`` holds the operand tensors alive while ``launch`` is."""
    fn = build.launcher(_LAUNCHERS[name])

    def launch():
        err = fn(*args, torch.cuda.current_stream(keep[0].device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: kernel launch failed with CUDA "
                               f"error {err}")
    return launch, out


def _check_block(name, bh, d, bkv, kv_rep):
    """Refuse what the onepass and decode blocks cannot take."""
    if d <= 0 or d % 16 or d > _MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} must be a multiple of 16 "
                         f"and at most {_MAX_HEAD_DIM}")
    if not 0 < bkv <= MAX_TILE:
        raise ValueError(f"{name}: a KV tile of {bkv} keys; it takes 1 to "
                         f"{MAX_TILE}")
    if kv_rep <= 0 or bh % kv_rep:
        raise ValueError(f"{name}: {bh} rows are not kv rows of {kv_rep} "
                         f"q heads")


def _block_smem(d, bkv, stages, rows, wn, cluster=1):
    """Shared memory of a block (``csrc/ita_common.cuh``'s ``layout``):
    ``stages`` stages of K and V and the Q tile (rows of d + 16 bytes),
    the u tile (rows of the keys rounded up to 32, + 16 bytes), the row
    groups' partial maxima and sums, 16 bytes for the block's KV range;
    in a cluster also the rows' run maxima and kernel rows (16 bytes a
    row) and, for each of the kv row's ``stages · cluster`` tiles at
    most, every row's δ and Σu and the int32 u·V of the block's share of
    the output's four-column items."""
    ks, sp = d + 16, -(-bkv // 32) * 32
    smem = stages * 2 * sp * ks + rows * (ks + sp + 16) \
        + 2 * wn * rows * 4 + 16
    if cluster > 1:
        tiles, share = stages * cluster, -(-rows * d // 4 // cluster)
        smem += rows * 20 + tiles * (2 * rows * 4 + share * 16)
    return smem


def _warps_n(wm, d):
    """8 warps a block; a single row group at d <= 64 takes 4 (a warp
    takes at least 16 columns)."""
    return 4 if wm == 1 and d <= 64 else 8 // wm


def onepass_geometry(bh, sq, d, bkv, kv_rep, sms):
    """The onepass kernel's launch for a call on a card of ``sms`` SMs
    (``csrc/onepass.cu`` checks it). A block serves one kv row (the
    ``kv_rep`` q rows that read the same K/V) and ``rows`` packed rows,
    query-major (packed row m is query ``m // kv_rep`` of head ``m %
    kv_rep``), in row groups of 16 with ``warps_n`` warps each: 16 rows
    and 8 warps when a kv row has at most 16 packed rows (a decode step;
    4 warps at d <= 64), 64 rows and 2 warps when 64-row blocks number
    ``ONEPASS_MANY_BLOCKS_PER_SM`` per SM or more, else 32 rows and 4
    warps (also for KV tiles over 128 keys). Two stages of K and V where
    they fit (``_block_smem``), else one. Raises on what the kernel
    cannot take."""
    _check_block("onepass kernel", bh, d, bkv, kv_rep)
    packed, n_kr = sq * kv_rep, bh // kv_rep
    if bkv > 128:
        wm = 2
    elif packed <= 16:
        wm = 1
    else:
        many = n_kr * -(-packed // 64) >= ONEPASS_MANY_BLOCKS_PER_SM * sms
        wm = 4 if many else 2
    wn, rows = _warps_n(wm, d), 16 * wm
    for stages in (2, 1):
        smem = _block_smem(d, bkv, stages, rows, wn)
        if smem <= _MAX_SMEM:
            break
    else:
        raise ValueError(f"onepass kernel: d={d}, block_kv={bkv} needs "
                         f"{smem} bytes of shared memory (> {_MAX_SMEM})")
    n_mt = -(-packed // rows)
    return {"rows": rows, "warps_n": wn, "threads": 32 * wm * wn,
            "tiles_per_kv_row": n_mt, "grid": n_kr * n_mt,
            "stages": stages, "smem": smem}


def decode_geometry(bh, sq, d, bkv, kv_rep, sms, n_tiles,
                    max_cluster=DECODE_MAX_CLUSTER):
    """The decode kernel's launch for a call of ``n_tiles`` KV tiles per
    row (ring capacity / ``bkv``, or the page table's width) on a card of
    ``sms`` SMs (``csrc/decode.cu`` checks it). A block serves one kv
    row's ``kv_rep · sq`` packed rows, query-major, in 1, 2 or 4 row
    groups of 16 (``tiles_per_kv_row`` blocks past 64 rows; 2 groups of 4
    warps for tiles over 128 keys), 8 warps a block (4 for one group at
    d <= 64).

    When the call's blocks leave SMs idle and a row has several tiles,
    each kv row gets a ``cluster`` of up to ``max_cluster`` CTAs (and at
    most the SMs per block): the CTAs split the row's live tiles into
    runs of at most ``stages`` tiles, each held whole in shared memory.
    Otherwise ``cluster`` is 1 and one block streams the tiles through
    up to ``DECODE_MAX_STAGES`` stages. Raises on what the kernel cannot
    take."""
    _check_block("decode kernel", bh, d, bkv, kv_rep)
    if not 1 <= sq <= MAX_DECODE_Q:
        raise ValueError(f"decode kernel takes at most {MAX_DECODE_Q} "
                         f"queries per row, got {sq}")
    if n_tiles < 1:
        raise ValueError(f"decode kernel: {n_tiles} KV tiles per row")
    packed, n_kr = sq * kv_rep, bh // kv_rep
    if bkv > 128:
        wm = 2
    else:
        wm = 1 if packed <= 16 else 2 if packed <= 32 else 4
    wn, rows = _warps_n(wm, d), 16 * wm
    n_mt = -(-packed // rows)
    blocks = n_kr * n_mt
    cluster = min(max_cluster, n_tiles, sms // max(blocks, 1))
    stages = -(-n_tiles // max(cluster, 1))
    if cluster < 2 or _block_smem(d, bkv, stages, rows, wn,
                                  cluster) > _MAX_SMEM:
        cluster = 1
        for stages in range(min(DECODE_MAX_STAGES, n_tiles), 0, -1):
            if _block_smem(d, bkv, stages, rows, wn) <= _MAX_SMEM:
                break
        else:
            raise ValueError(
                f"decode kernel: d={d}, block_kv={bkv} needs "
                f"{_block_smem(d, bkv, 1, rows, wn)} bytes of shared memory "
                f"(> {_MAX_SMEM})")
    return {"rows": rows, "warps_n": wn, "threads": 32 * wm * wn,
            "tiles_per_kv_row": n_mt, "grid": blocks * cluster,
            "stages": stages, "cluster": cluster,
            "smem": _block_smem(d, bkv, stages, rows, wn, cluster)}


def _twopass_smem(kind, d, bkv, rows, stages):
    """Shared memory of a twopass block (``csrc/twopass.cu``'s
    ``qk_smem``/``av_smem``): staged K/V rows of the head dim rounded up
    to 128 bytes; pass 1 (``kind`` "qk") ``stages`` K tiles of the KV tile
    rounded up to 64 keys and the Q tile (rows of d + 16 bytes); pass 2
    ("av") ``stages`` of a V tile and an A tile (rows of the KV tile
    rounded up to 32 keys, + 16 bytes), the tile's V in fragment order
    (keys × d bytes), 8 bytes per row and 8 per warp (its tile range)."""
    rs = -(-d // 128) * 128
    if kind == "qk":
        return stages * -(-bkv // 64) * 64 * rs + rows * (d + 16)
    sp = -(-bkv // 32) * 32
    return stages * (sp * rs + rows * (sp + 16)) + sp * d + rows * 8 \
        + rows // 2


def twopass_geometry(bh, sq, d, bkv, kv_rep, sms, n_tiles):
    """Both twopass passes' launch for a call of ``n_tiles`` KV tiles per
    row on a card of ``sms`` SMs (``csrc/twopass.cu`` checks it):
    ``{"qk": {...}, "av": {...}}``. A block serves one kv row and
    ``rows`` packed (query, head) rows, query-major, one warp per 16
    rows: 128 rows (at head dim and KV tile up to 128) when the call has
    128-row blocks enough, 1.5 per SM for pass 1 (every block walks all
    its row's tiles) and one per SM for pass 2, else 64. Each pass takes
    the deepest ring of 2 to ``TWOPASS_MAX_STAGES`` stages (no deeper
    than the row's tiles) that leaves room for two blocks an SM, else the
    deepest that fits one. Raises on what the kernels cannot take."""
    _check_block("twopass kernels", bh, d, bkv, kv_rep)
    packed, n_kr = sq * kv_rep, bh // kv_rep
    wide = d > 128 or bkv > 128
    blocks128 = n_kr * -(-packed // 128)
    geo = {}
    for kind, per_sm in (("qk", 1.5), ("av", 1)):
        rows = 64 if wide or blocks128 < per_sm * sms else 128
        n_mt = -(-packed // rows)
        deepest = max(2, min(TWOPASS_MAX_STAGES, n_tiles))
        fits = [st for st in range(deepest, 1, -1)
                if _twopass_smem(kind, d, bkv, rows, st) <= _MAX_SMEM]
        if not fits:
            raise ValueError(
                f"twopass kernels: d={d}, block_kv={bkv} needs "
                f"{_twopass_smem(kind, d, bkv, rows, 2)} bytes of shared "
                f"memory (> {_MAX_SMEM})")
        two = [st for st in fits
               if 2 * _twopass_smem(kind, d, bkv, rows, st) <= _MAX_SMEM]
        stages = (two or fits)[0]
        geo[kind] = {"rows": rows, "threads": 2 * rows,
                     "tiles_per_kv_row": n_mt, "grid": n_kr * n_mt,
                     "stages": stages,
                     "smem": _twopass_smem(kind, d, bkv, rows, stages)}
    return geo


def _check_vectors(name, d, *tensors):
    """The kernels load D-vectors as 16-byte words."""
    if d % 16 or d > _MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} must be a multiple of 16 "
                         f"and at most {_MAX_HEAD_DIM}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: q/k/v must be 16-byte aligned")


def _require_cuda(name, *tensors):
    if tensors[0].device.type != "cuda":
        raise RuntimeError(f"{name}: tensors on {tensors[0].device}; the "
                           f"kernel runs on CUDA tensors, the plain version "
                           f"on CPU ones")
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{name}: operands on different devices")


def kernel_launcher(name, q, k, v, *args, q_offset=0, q_len=None,
                    causal=True, window=0, adaptive=True, block_q=None,
                    block_kv=128, kv_rep=1, hq=None):
    """Check a kernel call's operands and bind them: returns ``(launch,
    out)``, where ``launch()`` enqueues kernel ``name`` on the current
    stream writing ``out`` and raises if the launch fails. ``args`` are
    the wrapper's positional operands after q, k, v: ``(logit_mult,
    out_mult, kv_len)``, or for a paged kernel ``(page_table, logit_mult,
    out_mult, kv_len)``. The wrappers launch through it once per call;
    timing code can launch it again without the wrapper's host work."""
    _require_cuda(name, q)
    bh, sq, d = q.shape
    paged = name in PAGED
    if paged:
        page_table, logit_mult, out_mult, kv_len = args
        lmult, omult, meta = paged_operands(
            q, k, v, page_table, logit_mult, out_mult, kv_len, q_offset,
            q_len, kv_rep, hq)
        page_table = page_table.contiguous()
        bkv = k.shape[1]
    else:
        logit_mult, out_mult, kv_len = args
        bkv, lmult, omult, meta = _prepare(q, k, v, logit_mult, out_mult,
                                           kv_len, q_offset, q_len, block_kv,
                                           kv_rep, hq)
    q, k, v = (t.contiguous() for t in (q, k, v))
    operands = (k, v, lmult, omult, meta) + ((page_table,) if paged else ())
    _require_cuda(name, q, *operands)
    _check_vectors(name, d, q, k, v)
    sms = sm_count(q.device)
    if name.startswith("ita_attention_onepass"):
        geo = onepass_geometry(bh, sq, d, bkv, kv_rep, sms)
        cluster = ()
    else:
        n_tiles = page_table.shape[1] if paged else k.shape[1] // bkv
        geo = decode_geometry(bh, sq, d, bkv, kv_rep, sms, n_tiles,
                              max_cluster=DECODE_MAX_CLUSTER)
        cluster = (geo["cluster"],)
    out = torch.empty_like(q)
    flags = (int(causal), window, int(adaptive), geo["rows"] // 16,
             geo["warps_n"], geo["stages"]) + cluster
    if paged:
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                page_table.data_ptr(), lmult.data_ptr(), omult.data_ptr(),
                meta.data_ptr(), out.data_ptr(), bh, sq,
                page_table.shape[1], bkv, d, kv_rep, hq, k.shape[2]) + flags
    else:
        kv_4d = k.ndim == 4
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lmult.data_ptr(),
                omult.data_ptr(), meta.data_ptr(), out.data_ptr(), bh, sq,
                k.shape[1], d, bkv, int(kv_4d), kv_rep, hq or 1,
                k.shape[2] if kv_4d else 1) + flags
    return _bind(name, args, out, (q,) + operands)


def _launch(name, *args, **kw):
    """Launch kernel ``name`` once and count the launch."""
    launch, out = kernel_launcher(name, *args, **kw)
    launch()
    LAUNCHES[name] += 1
    return out


def _prepare(q_q, k_q, v_q, logit_mult, out_mult, kv_len, q_offset, q_len,
             block_kv, kv_rep, hq):
    skv = k_q.shape[1]
    bkv = min(block_kv, skv)
    if skv % bkv:
        raise ValueError(f"Skv={skv} is not a multiple of block_kv={bkv}")
    return (bkv,) + row_operands(q_q, k_q, v_q, logit_mult, out_mult, kv_len,
                                 q_offset, q_len, kv_rep, hq)


def attention_plain(q_q, k_q, v_q, logit_mult, out_mult, kv_len, *,
                    q_offset=0, q_len=None, causal: bool = True,
                    window: int = 0, adaptive: bool = True,
                    block_q: int | None = None, block_kv: int = 128,
                    kv_rep: int = 1, hq: int | None = None):
    """The plain version of both kernels, on the tensors' device: what a
    wrapper computes on the CPU and what the kernels are held to on the
    card. Same operands as ``ita_attention_onepass``."""
    bkv, lmult, omult, meta = _prepare(q_q, k_q, v_q, logit_mult, out_mult,
                                       kv_len, q_offset, q_len, block_kv,
                                       kv_rep, hq)
    return _plain_rows(q_q, k_q, v_q, lmult, omult, meta, causal=causal,
                       window=window, adaptive=adaptive, block_kv=bkv,
                       kv_rep=kv_rep, hq=hq)


def ita_attention_onepass(q_q, k_q, v_q, logit_mult, out_mult, kv_len, *,
                          q_offset=0, q_len=None, causal: bool,
                          window: int = 0, adaptive: bool = True,
                          block_q: int = 128, block_kv: int = 128,
                          kv_rep: int = 1, hq: int | None = None):
    """Flash-style onepass ITA attention. q (BH, Sq, D) int8; k/v 3D
    (BH/kv_rep, Skv, D) or 4D (B, Skv, G, D) with ``hq``; returns (BH, Sq,
    D) int8. ``block_q`` is accepted for signature parity: query rows are
    independent, and the CUDA kernel packs them with their heads
    (``onepass_geometry``)."""
    kw = dict(q_offset=q_offset, q_len=q_len, causal=causal, window=window,
              adaptive=adaptive, block_kv=block_kv, kv_rep=kv_rep, hq=hq)
    if q_q.device.type == "cpu":
        return attention_plain(q_q, k_q, v_q, logit_mult, out_mult, kv_len,
                               **kw)
    return _launch("ita_attention_onepass", q_q, k_q, v_q, logit_mult,
                   out_mult, kv_len, **kw)


def ita_attention_decode(q_q, k_q, v_q, logit_mult, out_mult, kv_len, *,
                         q_offset=0, q_len=None, causal: bool = True,
                         window: int = 0, adaptive: bool = True,
                         block_kv: int = 128, kv_rep: int = 1,
                         hq: int | None = None):
    """Fused decode step: q (BH, Sq <= 8, D) int8 against an int8 KV ring
    of capacity Skv with per-row ``kv_len`` valid entries; KV tiles past a
    row's ``kv_len`` are skipped. Bit-identical to the matching rows of
    ``ita_attention_onepass`` at equal ``block_kv``."""
    if q_q.shape[1] > MAX_DECODE_Q:
        raise ValueError(f"decode kernel takes at most {MAX_DECODE_Q} "
                         f"queries per row, got {q_q.shape[1]}")
    kw = dict(q_offset=q_offset, q_len=q_len, causal=causal, window=window,
              adaptive=adaptive, block_kv=block_kv, kv_rep=kv_rep, hq=hq)
    if q_q.device.type == "cpu":
        return attention_plain(q_q, k_q, v_q, logit_mult, out_mult, kv_len,
                               **kw)
    return _launch("ita_attention_decode", q_q, k_q, v_q, logit_mult,
                   out_mult, kv_len, **kw)


def paged_attention_plain(q_q, k_pool, v_pool, page_table, logit_mult,
                          out_mult, kv_len, *, q_offset=0, q_len=None,
                          causal: bool = True, window: int = 0,
                          adaptive: bool = True, block_q: int | None = None,
                          kv_rep: int = 1, hq: int = 1):
    """The plain version of both paged kernels, on the tensors' device:
    each row's pages gathered into a ring, then ``attention_plain`` at
    ``block_kv = page``. Same operands as ``ita_attention_onepass_paged``."""
    paged_operands(q_q, k_pool, v_pool, page_table, logit_mult, out_mult,
                   kv_len, q_offset, q_len, kv_rep, hq)
    return attention_plain(
        q_q, gather_pages(k_pool, page_table),
        gather_pages(v_pool, page_table), logit_mult, out_mult, kv_len,
        q_offset=q_offset, q_len=q_len, causal=causal, window=window,
        adaptive=adaptive, block_kv=k_pool.shape[1], kv_rep=kv_rep, hq=hq)


def ita_attention_onepass_paged(q_q, k_pool, v_pool, page_table, logit_mult,
                                out_mult, kv_len, *, q_offset=0, q_len=None,
                                causal: bool, window: int = 0,
                                adaptive: bool = True, block_q: int = 128,
                                kv_rep: int = 1, hq: int = 1):
    """Onepass ITA attention over a paged KV pool: the mixed chunked-
    prefill/decode serve step. q (BH, Sq, D) int8; pools (P, page, G, D)
    int8; ``page_table`` (BH/hq, n_pages) int32; ``q_len`` per row marks
    the valid query rows (pad rows output 0). Returns (BH, Sq, D) int8,
    equal to ``ita_attention_onepass`` on the gathered ring at
    ``block_kv = page``."""
    kw = dict(q_offset=q_offset, q_len=q_len, causal=causal, window=window,
              adaptive=adaptive, kv_rep=kv_rep, hq=hq)
    if q_q.device.type == "cpu":
        return paged_attention_plain(q_q, k_pool, v_pool, page_table,
                                     logit_mult, out_mult, kv_len, **kw)
    return _launch("ita_attention_onepass_paged", q_q, k_pool, v_pool,
                   page_table, logit_mult, out_mult, kv_len, **kw)


def ita_attention_decode_paged(q_q, k_pool, v_pool, page_table, logit_mult,
                               out_mult, kv_len, *, q_offset=0, q_len=None,
                               causal: bool = True, window: int = 0,
                               adaptive: bool = True, kv_rep: int = 1,
                               hq: int = 1):
    """Fused decode step over a paged KV pool: q (BH, Sq <= 8, D) int8;
    otherwise as ``ita_attention_onepass_paged``. Pages past a row's
    ``kv_len`` are skipped."""
    if q_q.shape[1] > MAX_DECODE_Q:
        raise ValueError(f"decode kernel takes at most {MAX_DECODE_Q} "
                         f"queries per row, got {q_q.shape[1]}")
    kw = dict(q_offset=q_offset, q_len=q_len, causal=causal, window=window,
              adaptive=adaptive, kv_rep=kv_rep, hq=hq)
    if q_q.device.type == "cpu":
        return paged_attention_plain(q_q, k_pool, v_pool, page_table,
                                     logit_mult, out_mult, kv_len, **kw)
    return _launch("ita_attention_decode_paged", q_q, k_pool, v_pool,
                   page_table, logit_mult, out_mult, kv_len, **kw)


# ---------------------------------------------------------------------------
# Twopass: the paper's dataflow (A written once, read once)
# ---------------------------------------------------------------------------

def _twopass_operands(x, kv, kv_len, q_offset, block_kv, kv_rep,
                      skv=None):
    """Check a twopass pass's operands and resolve ``(bkv, meta)``: ``x``
    (BH, Sq, ·) int8 is Q (pass 1) or A with ``skv`` keys (pass 2); ``kv``
    is K or V, int8 in the kernel layout (BH/kv_rep, Skv, D) with Q's D.
    Every row's query count is Sq (no ragged q_len)."""
    bh, sq = x.shape[:2]
    if x.dtype != torch.int8 or kv.dtype != torch.int8:
        raise TypeError("q/k/v and A must be int8")
    if kv.ndim != 3 or kv.shape[0] * kv_rep != bh \
            or (skv is None and kv.shape[2] != x.shape[2]) \
            or (skv is not None and kv.shape[1] != skv):
        raise ValueError(f"twopass operands {tuple(x.shape)} and K/V "
                         f"{tuple(kv.shape)} do not fit: K/V must be "
                         f"(BH/kv_rep, Skv, D) with kv_rep = {kv_rep}")
    skv = kv.shape[1]
    bkv = min(block_kv, skv)
    if skv % bkv:
        raise ValueError(f"Skv={skv} is not a multiple of block_kv={bkv}")
    return bkv, _row_meta(kv_len, q_offset, sq, bh, kv.device)


def twopass_qk_plain(q_q, k_q, logit_mult, kv_len, *, q_offset=0,
                     causal: bool = True, window: int = 0,
                     adaptive: bool = False, block_kv: int = 128,
                     kv_rep: int = 1):
    """Pass 1's plain version: ``(a, row_max, sigma_inv, e_r)`` — the int8
    attention matrix (BH, Sq, Skv) at every position and the per-row
    statistics (BH, Sq) int32 after the DA over KV tiles and the DI."""
    bkv, meta = _twopass_operands(q_q, k_q, kv_len, q_offset, block_kv,
                                  kv_rep)
    bh, sq, _ = q_q.shape
    lmult, _ = _row_mults(logit_mult, 1.0, bh, q_q.device)
    logits = requant_logits(q_q, _kv_rows(k_q, bh, kv_rep, None),
                            lmult.view(bh, 1, 1))
    valid = _row_valid(meta, sq, k_q.shape[1], causal, window)
    stats = twopass_stats(logits, valid, adaptive=adaptive, block_kv=bkv)
    return (logits.to(torch.int8),) + tuple(x.view(bh, sq) for x in stats)


def twopass_av_plain(a, row_max, sigma_inv, e_r, v_q, out_mult, kv_len, *,
                     q_offset=0, causal: bool = True, window: int = 0,
                     block_kv: int = 128, kv_rep: int = 1):
    """Pass 2's plain version: EN on ``a`` with pass 1's statistics, p·V
    and the finalize. Returns (BH, Sq, D) int8."""
    bh, sq, skv = a.shape
    bkv, meta = _twopass_operands(a, v_q, kv_len, q_offset, block_kv,
                                  kv_rep, skv=skv)
    _, omult = _row_mults(1.0, out_mult, bh, a.device)
    valid = _row_valid(meta, sq, skv, causal, window)
    stats = (x.view(bh, sq, 1) for x in (row_max, sigma_inv, e_r))
    return twopass_out(a.to(torch.int32), valid, *stats,
                       _kv_rows(v_q, bh, kv_rep, None),
                       omult.view(bh, 1, 1), block_kv=bkv)


def twopass_plain(q_q, k_q, v_q, logit_mult, out_mult, kv_len, *,
                  q_offset=0, causal: bool = True, window: int = 0,
                  adaptive: bool = False, block_q: int | None = None,
                  block_kv: int = 128, kv_rep: int = 1):
    """Both passes' plain version, on the tensors' device: ``(out, a)``.
    Same operands as ``ita_attention_twopass``."""
    kw = dict(q_offset=q_offset, causal=causal, window=window,
              block_kv=block_kv, kv_rep=kv_rep)
    a, *stats = twopass_qk_plain(q_q, k_q, logit_mult, kv_len,
                                 adaptive=adaptive, **kw)
    return twopass_av_plain(a, *stats, v_q, out_mult, kv_len, **kw), a


def _twopass_pass_geometry(kind, x, d, bkv, kv_rep, skv, geometry):
    """The geometry a twopass pass launches with: ``geometry`` (a pass's
    entry of ``twopass_geometry``, for timing others) or the call's own."""
    if geometry is not None:
        return geometry
    bh, sq = x.shape[:2]
    return twopass_geometry(bh, sq, d, bkv, kv_rep, sm_count(x.device),
                            skv // bkv)[kind]


def twopass_qk_launcher(q_q, k_q, logit_mult, kv_len, *, q_offset=0,
                        causal: bool = True, window: int = 0,
                        adaptive: bool = False, block_kv: int = 128,
                        kv_rep: int = 1, geometry=None):
    """Bind pass 1 (B5a): ``(launch, (a, row_max, sigma_inv, e_r))``, the
    outputs as ``twopass_qk_plain`` returns them. ``geometry``: see
    ``_twopass_pass_geometry``."""
    name = "ita_attention_twopass_qk_da"
    bkv, meta = _twopass_operands(q_q, k_q, kv_len, q_offset, block_kv,
                                  kv_rep)
    bh, sq, d = q_q.shape
    skv = k_q.shape[1]
    lmult, _ = _row_mults(logit_mult, 1.0, bh, q_q.device)
    q_q, k_q = q_q.contiguous(), k_q.contiguous()
    _require_cuda(name, q_q, k_q, lmult)
    _check_vectors(name, d, q_q, k_q)
    geo = _twopass_pass_geometry("qk", q_q, d, bkv, kv_rep, skv, geometry)
    a = torch.empty((bh, sq, skv), dtype=torch.int8, device=q_q.device)
    stats = torch.empty((3, bh, sq), dtype=torch.int32, device=q_q.device)
    args = (q_q.data_ptr(), k_q.data_ptr(), lmult.data_ptr(),
            meta.data_ptr(), a.data_ptr(), stats[0].data_ptr(),
            stats[1].data_ptr(), stats[2].data_ptr(), bh, sq, skv, d, bkv,
            kv_rep, int(causal), window, int(adaptive), geo["rows"] // 16,
            geo["stages"])
    return _bind(name, args, (a, stats[0], stats[1], stats[2]),
                 (q_q, k_q, lmult, meta))


def twopass_av_launcher(a, row_max, sigma_inv, e_r, v_q, out_mult, kv_len,
                        *, q_offset=0, causal: bool = True, window: int = 0,
                        block_kv: int = 128, kv_rep: int = 1, geometry=None):
    """Bind pass 2 (B5b): ``(launch, out)`` with out (BH, Sq, D) int8.
    ``geometry``: see ``_twopass_pass_geometry``."""
    name = "ita_attention_twopass_av_en"
    bh, sq, skv = a.shape
    d = v_q.shape[-1]
    bkv, meta = _twopass_operands(a, v_q, kv_len, q_offset, block_kv,
                                  kv_rep, skv=skv)
    stats = [x.to(torch.int32).reshape(bh, sq).contiguous()
             for x in (row_max, sigma_inv, e_r)]
    _, omult = _row_mults(1.0, out_mult, bh, a.device)
    a, v_q = a.contiguous(), v_q.contiguous()
    _require_cuda(name, a, v_q, omult, *stats)
    _check_vectors(name, d, v_q)
    geo = _twopass_pass_geometry("av", a, d, bkv, kv_rep, skv, geometry)
    out = torch.empty((bh, sq, d), dtype=torch.int8, device=a.device)
    args = (a.data_ptr(), *(x.data_ptr() for x in stats), v_q.data_ptr(),
            omult.data_ptr(), meta.data_ptr(), out.data_ptr(), bh, sq, skv,
            d, bkv, kv_rep, int(causal), window, geo["rows"] // 16,
            geo["stages"])
    return _bind(name, args, out, (a, v_q, omult, meta, *stats))


def ita_attention_twopass(q_q, k_q, v_q, logit_mult, out_mult, kv_len, *,
                          q_offset=0, causal: bool, window: int = 0,
                          adaptive: bool = False, block_q: int = 128,
                          block_kv: int = 128, kv_rep: int = 1):
    """Paper-faithful dataflow. q (BH, Sq, D) int8; k/v (BH/kv_rep, Skv,
    D) int8 in the kernel layout; returns ``(out int8 (BH, Sq, D), a int8
    (BH, Sq, Skv))`` — A is the materialised attention matrix, written
    once by pass 1 and read once by pass 2. ``block_q`` is accepted for
    signature parity: query rows are independent (the kernels pack them
    with their heads, ``twopass_geometry``)."""
    kw = dict(q_offset=q_offset, causal=causal, window=window,
              block_kv=block_kv, kv_rep=kv_rep)
    if q_q.device.type == "cpu":
        return twopass_plain(q_q, k_q, v_q, logit_mult, out_mult, kv_len,
                             adaptive=adaptive, **kw)
    launch, (a, *stats) = twopass_qk_launcher(q_q, k_q, logit_mult, kv_len,
                                              adaptive=adaptive, **kw)
    launch()
    LAUNCHES["ita_attention_twopass_qk_da"] += 1
    launch, out = twopass_av_launcher(a, *stats, v_q, out_mult, kv_len, **kw)
    launch()
    LAUNCHES["ita_attention_twopass_av_en"] += 1
    return out, a
