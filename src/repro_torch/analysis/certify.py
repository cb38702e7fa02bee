"""Certification CLI: certify every registry config, write the port's
certificate (twin of ``repro.analysis.certify``).

``python -m repro_torch.analysis.certify [--arch ID ...] [--seq-len N]
[--cache-len N] [--out PATH]`` runs
:func:`repro_torch.analysis.interpret.certify_config` over the registry's
architectures and writes ``docs/CERTIFY_TORCH.json`` (schema
``repro_torch/certify-v1``; ``--out -`` writes nothing).  The reference's
certificate, ``benchmarks/CERTIFY.json``, is its own.  The exit status is
non-zero if any config fails, so an unsafe plan constant is caught.

Per config the certificate carries: status, worst-case bits and minimum
int32 headroom across all ops, per op its worst-case magnitude, bits, the
``cuda`` backend's path, and its Hopper launch's ``route`` and
``smem_bytes`` at the serving geometry (``interpret.SERVE_*``), the
number of plan-tree dyadics whose staging invariant was re-proved, and
the assumptions (what is taken on contract rather than proven —
docs/ANALYSIS.md).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.budgets import (INT32_MAX, MAX_ROWSUM_LEN, MAX_SQ,
                                          BitBudgetError)
from repro_torch.analysis.interpret import (SERVE_BATCH, SERVE_CHUNK,
                                            SERVE_PAGE, certify_config)

SCHEMA = "repro_torch/certify-v1"

DEFAULT_JSON = os.path.join("docs", "CERTIFY_TORCH.json")


def _op_entry(o):
    return {
        "op": o.op,
        "layer": o.layer,
        "worst": o.worst,
        "bits": o.bits,
        "headroom_bits": o.headroom_bits,
        "path": o.path,
        "note": o.note,
        "route": o.route,
        "smem_bytes": o.smem_bytes,
    }


def certify_all(seq_len: int, cache_len: int, names=None):
    """Certify the selected (default: all) registry configs.  Returns
    ``(report_dict, n_failed)`` — never raises on certification failure,
    so one bad config still reports every other."""
    from repro_torch.configs.registry import ARCHS
    names = list(names) if names else sorted(ARCHS)
    configs = {}
    n_failed = 0
    for name in names:
        cfg = ARCHS[name]            # KeyError on unknown names: intended
        try:
            r = certify_config(cfg, seq_len=seq_len, cache_len=cache_len)
        except BitBudgetError as e:
            n_failed += 1
            configs[name] = {
                "ok": False,
                "error": {
                    "what": e.what,
                    "value": e.value,
                    "budget": e.budget,
                    "op": e.op or "",
                    "layer": e.layer or "",
                    "message": str(e),
                },
            }
            continue
        configs[name] = {
            "ok": True,
            "worst_bits": r.worst_bits,
            "min_headroom_bits": r.min_headroom_bits,
            "n_ops": len(r.ops),
            "n_dyadics": r.n_dyadics,
            "ops": [_op_entry(o) for o in r.ops],
            "assumptions": list(r.assumptions),
        }
    report = {
        "schema": SCHEMA,
        "seq_len": seq_len,
        "cache_len": cache_len,
        "serving_geometry": {"batch": SERVE_BATCH, "page_size": SERVE_PAGE,
                             "prefill_chunk": SERVE_CHUNK},
        "budgets": {
            "INT32_MAX": INT32_MAX,
            "MAX_ROWSUM_LEN": MAX_ROWSUM_LEN,
            "MAX_SQ": MAX_SQ,
        },
        "n_configs": len(configs),
        "n_failed": n_failed,
        "configs": configs,
    }
    return report, n_failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.certify",
        description="Statically certify every registry config "
                    "overflow-free (docs/ANALYSIS.md).")
    ap.add_argument("--seq-len", type=int, default=4096,
                    help="prefill sequence length to certify at")
    ap.add_argument("--cache-len", type=int, default=32768,
                    help="decode/paged-prefill cache length to certify at")
    ap.add_argument("--arch", action="append", default=None,
                    help="certify only this config (repeatable)")
    ap.add_argument("--out", default=DEFAULT_JSON, metavar="PATH",
                    help="certificate path ('-' to skip writing)")
    args = ap.parse_args(argv)

    report, n_failed = certify_all(args.seq_len, args.cache_len, args.arch)
    for name, entry in report["configs"].items():
        if entry["ok"]:
            print(f"  ok    {name}: {entry['n_ops']} ops, worst "
                  f"{entry['worst_bits']} bits (headroom "
                  f"{entry['min_headroom_bits']}), "
                  f"{entry['n_dyadics']} dyadics audited")
        else:
            print(f"  FAIL  {name}: {entry['error']['message']}")
    if args.out != "-":
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"wrote {args.out}")
    if n_failed:
        print(f"{n_failed} config(s) failed certification",
              file=sys.stderr)
        return 1
    print(f"all {report['n_configs']} configs certified overflow-free "
          f"at seq_len={args.seq_len}, cache_len={args.cache_len}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
