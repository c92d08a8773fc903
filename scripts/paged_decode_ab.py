#!/usr/bin/env python3
"""Time one checkout's paged decode kernel at chip_smoke's timed shapes.

    python3 scripts/paged_decode_ab.py [--package-root DIR] [--label NAME]

Imports ``pytorchdistributed_tpu_torch`` from DIR (default: this
checkout), which builds its paged kernel under DIR/build at first use,
holds the kernel against that package's own plain twin, and times its
``paged_flash_attention`` at the four timed shapes of ``chip_smoke.py``
phase 3 (the same inputs from the same seeds, pools cycled past twice
the L2): on the device clock, every kernel of a call summed from the
profiler, and by CUDA events around 200 calls. Prints a JSON line per
shape, the card's name and power limit, and a last JSON line with all
of them. Needs one CUDA GPU.

To compare two versions on one card, run it in turns in one command,
for example with the parent unpacked by ``git archive`` into a directory
that .gitignore lists (here ``build/parent``):

    for r in build/parent . . build/parent; do
        python3 scripts/paged_decode_ab.py --package-root $r; done
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", default=ROOT,
                    help="checkout whose pytorchdistributed_tpu_torch is "
                         "timed (default: this one)")
    ap.add_argument("--label", default=None,
                    help="name for the result line (default: the root)")
    args = ap.parse_args()
    root = os.path.abspath(args.package_root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("paged_decode_ab.py needs a CUDA GPU")
    from pytorchdistributed_tpu_torch.ops import paged_attention as pa

    smoke.check(pa.__file__.startswith(root + os.sep),
                f"imported {pa.__file__}, not the package under {root}")
    card = smoke.card_line()
    rows = []
    for name, kw in smoke.PAGED_TIMED:
        case = smoke.paged_case(name, timed=True, **kw)
        q, tables, lengths = case["q"], case["tables"], case["lengths"]
        k, v, extra = case["pools"][0]
        got = pa.paged_flash_attention(q, k, v, tables, lengths,
                                       **case["kw"], **extra)
        want = pa.paged_flash_attention_plain(q, k, v, tables, lengths,
                                              **case["kw"], **extra)
        err = (got.float() - want.float()).abs()
        smoke.check(bool((err <= smoke.BF16_TOL
                          * (1 + want.float().abs())).all()),
                    f"{name}: kernel vs plain max |err| {float(err.max())}")
        row = dict(name=name,
                   **smoke.time_paged(case, pa.paged_flash_attention),
                   bound_ms=smoke.bound_ms(case)[0], copies=case["copies"],
                   max_abs_err=float(err.max()))
        rows.append(row)
        print(json.dumps(row), flush=True)
        del case
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"label": args.label or root, "card": card,
                      "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
