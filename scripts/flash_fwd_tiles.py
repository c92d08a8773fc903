#!/usr/bin/env python3
"""Time the port's flash forward kernel at both q-tile heights on one GPU.

    python3 scripts/flash_fwd_tiles.py [--reps 100] [--rounds 2]

``csrc/flash_attention.cu`` takes the forward's q tile from two macros:
``PTD_FLASH_FWD_BLOCK_M`` for the flash step (128 rows by default) and
``PTD_RING_FWD_BLOCK_M`` for the ring's forward hop (64). This builds the
source twice — as shipped, and with the two swapped (flash 64, ring 128)
— and times ``ptd_flash_fwd`` at the GPT-2-small training shape (B 8,
S 1024, H 12, D 64, causal) and ``ptd_ring_fwd`` at the ring's hop shape
(B 8, S_local 256, H 12, D 64, visible and diagonal), the two builds in
turns (a, b, b, a per round). Each build's outputs are first held against
the plain twins. Times are the kernels' device time per launch from
torch.profiler, beside CUDA events around the launch loop (the timers
of ``chip_smoke.py``). Prints the card's name and power limit, then one
JSON line per case.
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

import chip_smoke  # noqa: E402  (the timers and the tolerance)

BUILDS = {"shipped": [], "swapped": ["-DPTD_FLASH_FWD_BLOCK_M=64",
                                     "-DPTD_RING_FWD_BLOCK_M=128"]}
BLOCK_M = {"shipped": {"flash": 128, "ring": 64},
           "swapped": {"flash": 64, "ring": 128}}


def build_all() -> dict:
    """One nvcc per build, started together; {build: loaded library}."""
    from pytorchdistributed_tpu_torch import _build

    src = os.path.join(_build.CSRC_DIR, "flash_attention.cu")
    out_dir = os.path.join(_build.BUILD_DIR, "fwd_tiles")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, defs in BUILDS.items():
        path = os.path.join(out_dir, f"libflash_attention_{name}.so")
        procs[name] = (path, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *defs, "-o", path, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc ({name}) failed:\n{out}")
        lib = ctypes.CDLL(path)
        vp, i = ctypes.c_void_p, ctypes.c_int
        tail = [ctypes.POINTER(ctypes.c_longlong), i, i, i, i, i,
                ctypes.c_float, i, vp]
        lib.ptd_flash_fwd.argtypes = [vp] * 5 + tail
        lib.ptd_ring_fwd.argtypes = [vp] * 6 + tail
        libs[name] = lib
    return libs


def check(name, got, want):
    err, ok = chip_smoke.max_err(got, want)
    if not ok:
        raise SystemExit(f"{name}: max |err| {err:.3e} beyond "
                         f"{chip_smoke.BF16_TOL} * (1 + |plain|)")
    return err


def main() -> int:
    import torch

    from pytorchdistributed_tpu_torch.ops import flash_attention as fa
    from pytorchdistributed_tpu_torch.ops import ring_attention as ring

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    print(chip_smoke.card_line(), flush=True)
    libs = build_all()
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", torch.bfloat16)

    # two operand sets per case, alternated, so a timing loop is not
    # served out of L2
    flash_sets = [tuple(rnd(8, 1024, 12, 64) for _ in range(3))
                  for _ in range(2)]
    hop_sets = []
    for _ in range(2):
        q, k0, v0, k, v = (rnd(8, 256, 12, 64) for _ in range(5))
        acc = torch.zeros(8, 256, 12, 64, device="cuda")
        m = torch.full((8, 12, 256), -1e30, device="cuda")
        l = torch.zeros(8, 12, 256, device="cuda")
        ring.ring_fwd_update_plain(q, k0, v0, acc, m, l, causal=False,
                                   scale=0.125)
        hop_sets.append((q, k, v, acc, m, l))

    def flash_call(lib, i):
        q, k, v = flash_sets[i % 2]
        o = torch.empty_like(q)
        lse = torch.empty(8, 12, 1024, device="cuda")
        err = lib.ptd_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                o.data_ptr(), lse.data_ptr(),
                                fa._strides(q, k, v),
                                *fa._dims(q, k, 0.125, True))
        if err:
            raise SystemExit(f"ptd_flash_fwd failed: CUDA error {err}")
        return o, lse

    def hop_call(lib, i, causal, carry=None):
        q, k, v, acc, m, l = hop_sets[i % 2]
        acc, m, l = carry or (acc, m, l)
        err = lib.ptd_ring_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               m.data_ptr(), l.data_ptr(), acc.data_ptr(),
                               fa._strides(q, k, v),
                               *fa._dims(q, k, 0.125, causal))
        if err:
            raise SystemExit(f"ptd_ring_fwd failed: CUDA error {err}")
        return acc, m, l

    errs = {}
    for name, lib in libs.items():
        q, k, v = flash_sets[0]
        o, lse = flash_call(lib, 0)
        po, plse = fa.flash_attention_fwd_plain(q, k, v, causal=True,
                                                scale=0.125)
        errs[f"{name}/flash"] = max(check(f"{name} flash O", o, po),
                                    check(f"{name} flash LSE", lse, plse))
        for causal in (False, True):
            x = hop_sets[0]
            got = hop_call(lib, 0, causal,
                           tuple(t.clone() for t in x[3:]))
            want = ring.ring_fwd_update_plain(
                *x[:3], *(t.clone() for t in x[3:]), causal=causal,
                scale=0.125)
            got = (got[0] / got[2].transpose(1, 2)[..., None], *got[1:])
            want = (want[0] / want[2].transpose(1, 2)[..., None], *want[1:])
            errs[f"{name}/hop_causal{int(causal)}"] = max(
                check(f"{name} hop {key}", g, w)
                for key, g, w in zip(("acc/l", "m", "l"), got, want))
    torch.cuda.synchronize()
    print(json.dumps({"max_abs_err": errs}), flush=True)

    cases = [("flash_train_8x1024x12x64_causal", "flash", None,
              "flash_fwd_kernel<64, false"),
             ("hop_8x256x12x64_visible", "ring", False,
              "flash_fwd_kernel<64, true"),
             ("hop_8x256x12x64_diagonal", "ring", True,
              "flash_fwd_kernel<64, true")]
    order = ["shipped", "swapped", "swapped", "shipped"]
    for case, path, causal, kernel in cases:
        times = {name: {"ms": [], "ms_events": []} for name in libs}
        for _ in range(args.rounds):
            for name in order:
                lib, it = libs[name], iter(range(10 ** 9))
                if path == "flash":
                    def fn():
                        flash_call(lib, next(it))
                else:
                    def fn():
                        hop_call(lib, next(it), causal)
                times[name]["ms"].append(
                    chip_smoke.kernel_device_ms(fn, args.reps, kernel))
                times[name]["ms_events"].append(
                    chip_smoke.time_ms(fn, args.reps))
        print(json.dumps({"case": case, **{
            f"block_m_{BLOCK_M[name][path]}": t for name, t in
            times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
