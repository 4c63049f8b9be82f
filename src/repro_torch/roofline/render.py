"""Markdown tables from the port's roofline records
(``repro.roofline.render``).

A record is one JSON object per path, as ``chip_smoke.py`` prints them
on its ``{"roofline": [...]}`` line: the path, the config and shape, the
card (``nvidia-smi``'s name and power limit), ``Roofline.row()`` and the
measured step with its ``mfu`` and ``share``; or one dry-run cell, as
``launch.dryrun --out`` writes them (``arch``, ``shape``, ``mesh``,
``status``, ``memory``, ``collectives``, ``roofline``).

    python -m repro_torch.roofline.render chip_smoke.log
    python -m repro_torch.roofline.render dryrun.jsonl

reads every ``{"roofline": ...}`` line of a log, and every record line
of a file, and prints the tables.
"""

from __future__ import annotations

import json
import sys


def load(path):
    """The records of ``path``: the ``roofline`` lists of its JSON lines,
    and its lines that are records themselves."""
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            obj = json.loads(line)
            if isinstance(obj.get("roofline"), list):
                recs.extend(obj["roofline"])
            elif "path" in obj or "arch" in obj:
                recs.append(obj)
    return recs


def _fmt_s(x):
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}µs"


def roofline_table(recs):
    hdr = ("| path | compute | memory | bottleneck | MODEL_FLOPS | useful "
           "| measured | MFU | share | card |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for r in recs:
        rows.append(
            f"| {r['path']} | {_fmt_s(r['compute_s'])} | "
            f"{_fmt_s(r['memory_s'])} | **{r['bottleneck']}** | "
            f"{r['model_flops']:.3e} | {r['useful_ratio']:.3f} | "
            f"{_fmt_s(r['measured_s'])} | {r['mfu']:.4f} | "
            f"{r['share']:.4f} | {r['card']} |")
    return hdr + "\n".join(rows) + "\n"


def flops_table(recs):
    """Where each path's counted work went: matmul FLOPs by family and by
    dtype, the kernels' integer ops, and the bytes."""
    hdr = ("| path | dense | attention | experts | other | int8 | bf16 | "
           "fp32 | kernel ops | bytes |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for r in recs:
        fam = r.get("families", {})
        rows.append(
            f"| {r['path']} | " + " | ".join(
                f"{fam.get(k, 0.0):.3e}"
                for k in ("dense", "attention", "experts", "other"))
            + f" | {r['flops_int8']:.3e} | {r['flops_bf16']:.3e} | "
            f"{r['flops_fp32']:.3e} | {r.get('kernel_ops', 0.0):.3e} | "
            f"{r['hbm_bytes']:.3e} |")
    return hdr + "\n".join(rows) + "\n"


def _gib(n):
    return f"{n / 2**30:.2f}"


def dryrun_table(recs):
    """One row per dry-run cell: per-device GiB of the arguments, outputs
    and temporaries, the counted FLOPs and collective bytes per device,
    the roofline's terms, bottleneck and useful share."""
    hdr = ("| arch | shape | mesh | status | args GiB | out GiB | temp GiB "
           "| FLOPs | coll bytes | compute | memory | collective | "
           "bottleneck | useful |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for r in recs:
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"fail: {r.get('error', '')[:60]} |" + " |" * 10)
            continue
        m, f = r["memory"], r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{_gib(m['argument_bytes'])} | {_gib(m['output_bytes'])} | "
            f"{_gib(m['temp_bytes'])} | {f['flops']:.3e} | "
            f"{f['coll_bytes']:.3e} | {_fmt_s(f['compute_s'])} | "
            f"{_fmt_s(f['memory_s'])} | {_fmt_s(f['collective_s'])} | "
            f"**{f['bottleneck']}** | {f['useful_ratio']:.3f} |")
    return hdr + "\n".join(rows) + "\n"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    recs = load(argv[0])
    cells = [r for r in recs if "arch" in r]
    paths = [r for r in recs if "arch" not in r]
    if cells:
        print("### Dry-run\n")
        print(dryrun_table(cells))
    if paths:
        print("### Roofline\n")
        print(roofline_table(paths))
        print("\n### Counted work\n")
        print(flops_table(paths))


if __name__ == "__main__":
    main()
