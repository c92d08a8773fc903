#!/usr/bin/env python3
"""Time the port's flash attention kernels across builds on one GPU.

    python3 scripts/flash_tiles.py [--reps 50] [--rounds 2]
        [--build NAME=-DMACRO=VALUE,-DMACRO=VALUE ...]

``csrc/flash_attention.cu`` takes the forward's q-tile height from two
macros: ``PTD_FLASH_FWD_BLOCK_M`` for the flash step (128 rows) and
``PTD_RING_FWD_BLOCK_M`` for the ring's forward hop (64). This builds the
source as shipped and, by default, once more with the two swapped (flash
64, ring 128); ``--build`` names other builds instead. One nvcc per
build, all started together. It prints each build's flash-kernel
registers and spill bytes from the ptxas report and holds each build's
outputs against the plain twins. Then it times every kernel through the
package's own launch wrappers, the builds in turns (a, b, b, a each
round): the flash step's forward, dQ and dK/dV at the GPT-2-small
training shape (B 8, S 1024, H 12, D 64, causal), and the ring's three
hop kernels at its hop shape (B 8, S_local 256, H 12, D 64, visible and
diagonal). Times are the kernels' device time per launch from
torch.profiler beside CUDA events around the launch loop (the timers of
``chip_smoke.py``). Prints the card's name and power limit, then one JSON
line per build and per case.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the timers, the cases and the tolerance)

DEFAULT_BUILDS = {"swapped": ["-DPTD_FLASH_FWD_BLOCK_M=64",
                              "-DPTD_RING_FWD_BLOCK_M=128"]}


def parse_builds(specs) -> dict:
    builds = {"shipped": []}
    if not specs:
        builds.update(DEFAULT_BUILDS)
    for spec in specs or ():
        name, _, defs = spec.partition("=")
        builds[name] = [d for d in defs.split(",") if d]
    return builds


def build_all(builds: dict) -> dict:
    """One nvcc per build, started together; {build: (library, ptxas
    entries of the flash kernels)}."""
    from pytorchdistributed_tpu_torch import _build

    src = os.path.join(_build.CSRC_DIR, "flash_attention.cu")
    out_dir = os.path.join(_build.BUILD_DIR, "tiles")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, defs in builds.items():
        path = os.path.join(out_dir, f"libflash_attention_{name}.so")
        procs[name] = (path, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *defs, "-o", path, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (path, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc ({name}) failed:\n{report}")
        regs = {k: v for k, v in chip_smoke.ptxas_kernels(report).items()
                if k.startswith("flash_")}
        out[name] = (ctypes.CDLL(path), regs)
    return out


def check(name, got, want):
    err, ok = chip_smoke.max_err(got, want)
    if not ok:
        raise SystemExit(f"{name}: max |err| {err:.3e} beyond "
                         f"{chip_smoke.BF16_TOL} * (1 + |plain|)")
    return err


def main() -> int:
    import torch

    from pytorchdistributed_tpu_torch import _build
    from pytorchdistributed_tpu_torch.ops import flash_attention as fa
    from pytorchdistributed_tpu_torch.ops import ring_attention as ring

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--build", action="append",
                    help="NAME=-DMACRO=VALUE,... (replaces the swapped "
                         "build; may repeat)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    print(chip_smoke.card_line(), flush=True)
    builds = parse_builds(args.build)
    libs = build_all(builds)
    for name, (_, regs) in libs.items():
        print(json.dumps({"build": name, "defines": builds[name],
                          "ptxas": regs}), flush=True)

    def use(name):
        # the package's wrappers launch the library loaded under this name
        _build._LIBS["flash_attention"] = libs[name][0]

    scale = 0.125
    flash = chip_smoke.flash_case("train", b=8, s=1024, h=12, hk=12,
                                  causal=True, copies=2)
    # per set: the backward's operands and a Δ for dK/dV
    flash_bwd = []
    for q, k, v, do in flash["sets"]:
        o, lse = fa.flash_attention_fwd_plain(q, k, v, causal=True,
                                              scale=scale)
        flash_bwd.append((fa._bwd_operands(q, k, v, o, lse, do),
                          fa._delta(o, do)))
    hops = {causal: chip_smoke.ring_hop_case("hop", causal=causal, copies=3,
                                             seed=int(causal))
            for causal in (False, True)}
    for case in hops.values():
        for x in case["sets"]:
            x["ops"] = ring._bwd_hop_operands(
                *(x[key] for key in ("q", "k", "v", "do", "lse", "delta")))
    carries = ("acc", "m", "l", "dq", "dk", "dv")

    errs = {}
    for name in libs:
        use(name)
        q, k, v, do = flash["sets"][0]
        o, lse = fa._launch_fwd(q, k, v, True, scale)
        got = (o, lse, *fa._launch_bwd(q, k, v, o, lse, do, True, scale))
        want = (*fa.flash_attention_fwd_plain(q, k, v, causal=True,
                                              scale=scale),
                *fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                              causal=True, scale=scale))
        errs[f"{name}/flash"] = max(
            check(f"{name} flash {key}", g, w) for key, g, w in
            zip(("O", "LSE", "dQ", "dK", "dV"), got, want))
        for causal, case in hops.items():
            x = case["sets"][0]
            got = [x[key].clone() for key in carries]
            want = [x[key].clone() for key in carries]
            ring._launch_fwd_hop(x["q"], x["k"], x["v"], *got[:3], causal,
                                 scale)
            ring._launch_dq_hop(x["ops"], got[3], causal, scale)
            ring._launch_dkv_hop(x["ops"], *got[4:], causal, scale)
            ring.ring_fwd_update_plain(x["q"], x["k"], x["v"], *want[:3],
                                       causal=causal, scale=scale)
            ring.ring_bwd_update_plain(*x["ops"], *want[3:], causal=causal,
                                       scale=scale)
            for c in (got, want):   # the forward carry held as acc / l
                c[0] = c[0] / c[2].transpose(1, 2)[..., None]
            errs[f"{name}/hop_causal{int(causal)}"] = max(
                check(f"{name} hop {key}", g, w) for key, g, w in
                zip(("acc/l", "m", "l", "dQ", "dK", "dV"), got, want))
    torch.cuda.synchronize()
    print(json.dumps({"max_abs_err": errs}), flush=True)

    it = iter(range(10 ** 9))

    def nxt(seq):
        return seq[next(it) % len(seq)]

    def flash_fwd():
        fa._launch_fwd(*nxt(flash["sets"])[:3], True, scale)

    def flash_dq():
        fa._launch_dq(*nxt(flash_bwd)[0], True, scale)

    def flash_dkv():
        ops, delta = nxt(flash_bwd)
        fa._launch_dkv(*ops[:4], ops[5], delta, True, scale)

    def hop(kind, causal):
        sets = hops[causal]["sets"]

        def fn():
            x = nxt(sets)
            if kind == "fwd":
                ring._launch_fwd_hop(x["q"], x["k"], x["v"], x["acc"],
                                     x["m"], x["l"], causal, scale)
            elif kind == "dq":
                ring._launch_dq_hop(x["ops"], x["dq"], causal, scale)
            else:
                ring._launch_dkv_hop(x["ops"], x["dk"], x["dv"], causal,
                                     scale)
        return fn

    cases = [("flash_fwd", "flash_fwd_kernel<64, false", flash_fwd),
             ("flash_bwd_dq", "flash_bwd_dq_kernel<64, false", flash_dq),
             ("flash_bwd_dkv", "flash_bwd_dkv_kernel<64, false", flash_dkv)]
    for kind, body in (("fwd", "flash_fwd_kernel"),
                       ("dq", "flash_bwd_dq_kernel"),
                       ("dkv", "flash_bwd_dkv_kernel")):
        for causal, label in ((False, "visible"), (True, "diagonal")):
            cases.append((f"ring_{kind}/{label}", f"{body}<64, true",
                          hop(kind, causal)))
    order = list(libs) + list(reversed(libs))
    for case, kernel, fn in cases:
        times = {name: {"ms": [], "ms_events": []} for name in libs}
        for _ in range(args.rounds):
            for name in order:
                use(name)
                times[name]["ms"].append(
                    chip_smoke.kernel_device_ms(fn, args.reps, kernel))
                times[name]["ms_events"].append(
                    chip_smoke.time_ms(fn, args.reps))
        print(json.dumps({"case": case, **times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
