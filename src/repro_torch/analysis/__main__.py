"""``python -m repro_torch.analysis`` — run the no-overflow certification
matrix and the capture-hygiene lints; print a human report and
optionally write the JSON artifact.

Exit status is 0 iff every certificate and every lint that ran passed.
The lints run on ``--device``: the card by default (it raises without
one), the CPU with ``--device cpu`` or, unless a device is named,
``--smoke``. On the CPU the four card lints print as SKIP and count as
not run.
"""

from __future__ import annotations

import argparse
import json
import sys


def _fmt_case(c: dict) -> str:
    mark = "PASS" if c["ok"] else "FAIL"
    if "error" in c:
        return f"  {mark}  {c['name']:44s} ERROR {c['error']}"
    line = (f"  {mark}  {c['name']:44s} ops={c['n_ops']:>6} "
            f"max|int|={c['max_int_magnitude']:>12} "
            f"headroom={c['int32_headroom_bits']:>2}b")
    if c["n_unproven"]:
        line += f" unproven={c['n_unproven']}"
    if c["path_fixed"]:
        line += " path-fixed"
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Integer-range no-overflow certificates for the port's "
                    "quantized kernels and backends + capture-hygiene "
                    "lints for the served and fused loops.")
    ap.add_argument("--smoke", action="store_true",
                    help="small geometry, short lint trace")
    ap.add_argument("--all-backends", action="store_true",
                    help="accepted for invocation clarity; the full "
                         "matrix is already the default")
    ap.add_argument("--backend", action="append", default=None,
                    help="restrict the matrix to this backend name "
                         "(repeatable)")
    ap.add_argument("--no-lints", action="store_true",
                    help="skip the loop lints (range matrix only)")
    ap.add_argument("--device", default=None,
                    help="device of the lints: cuda (the default) or cpu "
                         "(the default with --smoke)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable report here")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print per-finding / per-note detail")
    args = ap.parse_args(argv)
    device = args.device or ("cpu" if args.smoke else "cuda")
    if not args.no_lints:
        from repro_torch.device import resolve_device
        resolve_device(device)           # no card: raise before the work

    from repro_torch.analysis.lints import run_lints
    from repro_torch.analysis.verify import run_verification

    report = run_verification(smoke=args.smoke, backends=args.backend)

    g = report["geometry"]
    print(f"integer-range certification matrix [{report['mode']}] — "
          f"kv={g['skv']} q={g['sq']} d={g['d']} "
          f"tiles=({g['bq']},{g['bkv']}) page={g['page']}")
    for c in report["cases"]:
        print(_fmt_case(c))
        if args.verbose or not c["ok"]:
            for f in c.get("findings", []):
                print(f"        finding[{f['kind']}] {f['prim']} "
                      f"{f['ival']} at {f['path']}")
            for n in c.get("notes", []):
                print(f"        note[{n['kind']}] {n['message']}")
    print(f"  {report['n_cases'] - report['n_failed']}/{report['n_cases']} "
          f"certificates; backends certified: "
          f"{', '.join(report['certified_backends']) or 'none'}")

    if not args.no_lints:
        lint_report = run_lints(smoke=args.smoke, device=device)
        report["lints"] = lint_report["lints"]
        report["ok"] = report["ok"] and lint_report["ok"]
        print("capture-hygiene lints")
        for lint in lint_report["lints"]:
            mark = "SKIP" if not lint["ran"] else \
                "PASS" if lint["ok"] else "FAIL"
            print(f"  {mark}  {lint['name']:28s} {lint['detail']}")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        print(f"report written to {args.json}")

    print("analysis:", "OK" if report["ok"] else "FAILED")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
