#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure raises, so the exit code is not 0):

  1. device  — require CUDA; print the card's name and power limit.
  2. build   — compile every kernel of the serving, training and ring
               paths from csrc/ with nvcc (one process per source, all started
               together) into build/; print each kernel's registers and
               spill bytes from the ptxas report, every instantiation
               under its own name, and fail if a flash or paged
               instantiation spills.
  3. kernels — hold the paged decode kernel against its plain PyTorch
               twin on the card within a stated tolerance, two launches
               bitwise equal, at four timed shapes (the serving tick's
               8 slots x 12 heads x D 64 at block 16; all 8 slots at
               length 1023; one slot at 1023; 32 q heads over 8 kv heads)
               and three checked ones (int8 pool, sink + window, a GQA
               group of 8). Each timed case cycles through enough pool
               copies that a cycle's live K/V exceeds twice the L2, and
               is timed on the device clock (every kernel of a call, from
               the profiler) with CUDA events beside it, at the run
               length the wrapper picks and at others; beside it the
               plain twin, the library yardstick (paged gather + SDPA,
               device clock and events) and the bound.
  3b. flash  — the same for the three flash attention kernels (forward,
               dK/dV, dQ) at the training shape (B 8, S 1024, H 12, D 64,
               bf16, causal), two GQA shapes (H 32 over 8 kv heads, S
               512; H 8 over 2, S 200), a ragged one (S 1000, not
               causal), and where the tilings have edges: S 64 and 96
               (less than one q tile), S 200 (a ragged diagonal), D 32
               and D 128 (S 512), all causal; every case holds O, LSE,
               dQ, dK and dV, and the backward must give bitwise-equal
               grads on two runs. The yardstick is SDPA's forward (CUDA
               events) and its backward on the device clock — every
               kernel its backward launches, beside the port's whole
               backward and the eager Δ the ring keeps (CUDA events
               around SDPA's autograd call, fwd+bwd minus fwd, time the
               host as much as the device). Prints each kernel's
               TFLOP/s, registers and its time as a multiple of its
               bound at the training shape.
  3c. ring   — the same for the three ring-attention hop kernels (the
               flash kernels with a carry: forward, dQ, dK/dV) at phase
               6's hop shape (B 8, S_local 256, H 12, D 64, bf16, fp32
               carries from a previous hop), diagonal and fully visible,
               and a ragged S_local 250; no library call computes a hop.
  4. serve   — GPT-2-small at full width (12 layers, 768 wide, vocab
               50257, context 1024), bf16 compute over fp32 weights from
               a seed, through the paged engine (block 16, 8 slots, the
               kernel read, paged_attn="pallas"): 8 requests of 32..600
               prompt tokens, 64 new tokens each, greedy and sampled, a
               shared prefix. Every
               request must finish, the kernel must have run once per
               layer per tick, and from one snapshot of the cache the
               kernel tick's logits must agree with the gather tick's
               and with a cache-free forward.
  5. train   — GPT-2-small at full width through the port's Trainer with
               attention="pallas": bf16 compute over fp32 weights from
               seed 0, the bench_gpt2 batch (8 x 1024 from
               numpy default_rng(0)), adamw(3e-4); 2 warm-up and 12 timed
               steps on one batch, then a 2-step profiler window. Each
               flash kernel must launch 12 times per step, every loss be
               finite and the last below the first, and from one weight
               copy the kernel path's step-0 loss and gradient must agree
               with the attention="dense" path's.
  6. ring    — the same model, batch and optimizer with
               attention="ring" over a port mesh seq=4 (S_local 256, the
               four shards stepped in this process on the one card): 2
               warm-up and 6 timed steps, then a 2-step profiler window.
               Each hop kernel must launch 120 times per step (10 hops of
               12 layers), every loss be finite and the last below the
               first, and the step-0 loss and gradient agree with dense.
  7. summary — one JSON line with every ported kernel, then the last
               line: {"ok": true, "device": {...}}.

Needs the repository beside it; run alone, or without a GPU, it exits
with an error and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (data sheet)
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
BF16_TOL = 1e-2               # |got - want| <= tol * (1 + |want|)
KERNEL_SOURCES = ("paged_attention", "flash_attention")


def report_dir() -> str:
    """Where the long reports go: $PTD_SMOKE_OUT, else build/."""
    d = os.environ.get("PTD_SMOKE_OUT") or os.path.join(ROOT, "build")
    os.makedirs(d, exist_ok=True)
    return d


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# short names for the type template arguments the port's kernels take
MANGLED_TYPES = {"f": "float", "a": "int8", "13__nv_bfloat16": "bf16"}


def demangle_kernel(sym: str) -> str:
    """A kernel's name with its template arguments, from its Itanium
    symbol: ``_Z16flash_fwd_kernelILi64ELb0ELi128EEv…`` gives
    ``flash_fwd_kernel<64, false, 128>``, and a kernel in an anonymous
    namespace with type arguments ``paged_attention_kernel<bf16, int8,
    64, 8>`` (substitutions such as ``S1_`` resolved). Reads only the
    grammar those kernels use; anything else keeps the whole symbol, so
    no two instantiations share a name."""
    try:
        i, subs, parts, args = 2, [], [], []
        nested = sym[i] == "N"
        i += nested

        def source_name():
            nonlocal i
            n = re.match(r"\d+", sym[i:]).group()
            i += len(n) + int(n)
            return sym[i - int(n):i]

        while sym[i].isdigit():
            parts.append(source_name())
            subs.append("::".join(parts))   # each prefix is a candidate
            if not nested:
                break
        if sym[i] == "I":
            i += 1
            while sym[i] != "E":
                m = re.match(r"L([ib])(n?)(\d+)E|S([0-9A-Z]*)_|(\d+)|([a-z])",
                             sym[i:])
                i += len(m.group())
                if m.group(1):            # an integer or bool literal
                    v = m.group(2).replace("n", "-") + m.group(3)
                    args.append({"0": "false", "1": "true"}[v]
                                if m.group(1) == "b" else v)
                    continue
                if m.group(5):            # a named type: a new candidate
                    i -= len(m.group())
                    name = source_name()
                    subs.append(name)
                    token = m.group(5) + name
                elif m.group(6):          # a builtin type
                    token = m.group(6)
                else:                     # S_ is candidate 0, S<n>_ n + 1
                    k = int(m.group(4), 36) + 1 if m.group(4) else 0
                    name = subs[k]
                    token = f"{len(name)}{name}"
                args.append(MANGLED_TYPES.get(
                    token, token.lstrip("0123456789")))
        return parts[-1] + (f"<{', '.join(args)}>" if args else "")
    except (AttributeError, IndexError, KeyError, ValueError):
        return sym


def ptxas_kernels(report: str) -> dict:
    """{kernel: {"registers": n, "spill_bytes": stores + loads}} from an
    ``nvcc -Xptxas -v`` report, each name demangled with its template
    arguments (``demangle_kernel``)."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(_Z\w+)'", line)
        if m:
            name = demangle_kernel(m.group(1))
            out[name] = {"registers": None, "spill_bytes": 0}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
            name = None
    return out


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs (CUDA events,
    after two warm-up runs)."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps: int, kernel: str) -> float:
    """Mean device time per launch of the CUDA kernel whose name contains
    ``kernel`` over ``reps`` runs of ``fn()``, from torch.profiler's
    device timestamps (after two warm-up runs). Unlike CUDA events around
    the loop, it leaves out the device's idle gaps while the host issues
    the next launch, which a kernel of a few tens of microseconds cannot
    hide."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    # the tracer may drop some or all of a window's device events: the
    # mean is over the launches it saw, from the first of up to three
    # windows that shows at least half of them
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        if 2 * len(us) >= reps:
            if len(us) < reps:
                log(f"  profiler saw {len(us)} of {reps} launches of "
                    f"{kernel}")
            return sum(us) / len(us) / 1e3
    raise SystemExit(f"FAILED: profiler saw {len(us)} of {reps} launches "
                     f"of {kernel} in three windows")


def call_device_ms(fn, reps: int) -> tuple[float, float]:
    """(device ms per call, kernels per call) of ``fn()``: every CUDA
    kernel's device time that torch.profiler records over ``reps`` calls
    (after two warm-up calls), per call — what a call costs the device,
    whatever it launches, without the host's gaps. The tracer may drop
    events (see ``kernel_device_ms``): each kernel counts as launched
    round(seen / reps) times a call at the mean of the launches seen, and
    a window counts only if every kernel kept at least 90 % of those
    launches and no more; up to three windows are tried."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                n_us = seen.setdefault(e.name, [0, 0.0])
                n_us[0] += 1
                n_us[1] += e.time_range.elapsed_us()
        per_call = {k: round(n / reps) for k, (n, _) in seen.items()}
        if seen and all(per_call[k] and 0.9 * per_call[k] * reps <= n
                        <= per_call[k] * reps for k, (n, _) in seen.items()):
            if any(n < per_call[k] * reps for k, (n, _) in seen.items()):
                log(f"  profiler kept {[n for n, _ in seen.values()]} of "
                    f"{reps} calls' launches")
            return (sum(us / n * per_call[k] for k, (n, us) in seen.items())
                    / 1e3, sum(per_call.values()))
        log(f"  profiler window incomplete: "
            f"{ {k[:60]: n for k, (n, _) in seen.items()} }")
    raise SystemExit(f"FAILED: three profiler windows of {reps} calls "
                     f"each lost device events")


# ---------------------------------------------------------------------------
# phase 3: the paged kernel against its plain twin


L2_BYTES = 50e6                # H100 SXM L2 (data sheet)
PAGED_REPLACES = "pytorchdistributed_tpu/ops/pallas_attention.py:482"
PAGED_KERNELS = ("paged_attention_kernel", "paged_merge_kernel")
SERVING_LENGTHS = [1, 15, 16, 255, 256, 600, 1000, 1023]
# the timed cases: the serving tick's shape, every slot at full context,
# one slot at full context (single-user decode) and a GQA group of 4
PAGED_TIMED = (
    ("serving_8x12x64_bs16", {}),
    ("full_8x12x64_len1023", dict(lengths=[1023] * 8)),
    ("decode_1x12x64_len1023", dict(slots=1, lengths=[1023])),
    ("gqa_32q_8kv", dict(heads=32, kv_heads=8, seed=1)),
)


def paged_case(name, *, slots=8, heads=12, kv_heads=12, d=64, bs=16,
               pages=64, lengths=None, int8=False, sink=0, window=0,
               timed=False, seed=0):
    """Inputs at one shape. A timed case gets enough independent pools
    that one cycle through them holds more than twice the L2 in live K/V
    bytes, so a timing loop reads its K/V from device memory."""
    import torch

    from pytorchdistributed_tpu_torch.ops.quant import kv_quantize

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    nb = slots * pages + 1
    lengths = (lengths or SERVING_LENGTHS)[:slots]
    tables = (torch.randperm(nb - 1, generator=gen)[:slots * pages] + 1)
    tables = tables.reshape(slots, pages).to(torch.int32)
    q = torch.randn(slots, heads, d, generator=gen)
    row = kv_heads * d * (1 if int8 else 2) * 2   # K and V
    if int8:
        row += kv_heads * 4 * 2                   # their fp32 scales
    case = dict(name=name, q=q.to(dev, torch.bfloat16),
                tables=tables.to(dev),
                lengths=torch.tensor(lengths, dtype=torch.int32, device=dev),
                kw=dict(sink_tokens=sink, window_tokens=window), pools=[],
                kv_row_bytes=row)
    live = live_tokens(case) * row
    case["copies"] = int(2 * L2_BYTES // live) + 1 if timed else 1
    case["cycle_bytes"] = case["copies"] * live
    cuda_gen = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(case["copies"]):
        k, v = (torch.randn(nb, bs, kv_heads, d, generator=cuda_gen,
                            device=dev, dtype=torch.bfloat16)
                for _ in range(2))
        if int8:
            (k, ks), (v, vs) = kv_quantize(k), kv_quantize(v)
            case["pools"].append((k, v, dict(k_scale=ks, v_scale=vs)))
        else:
            case["pools"].append((k, v, {}))
    return case


def live_tokens(case) -> int:
    """Positions these lengths make the kernel read: p <= length and,
    with a window, p < sink or p > length - window."""
    sink, window = case["kw"]["sink_tokens"], case["kw"]["window_tokens"]
    return sum(1 for n in case["lengths"].tolist() for p in range(n + 1)
               if not window or p < sink or p > n - window)


def bound_ms(case) -> tuple[float, str]:
    """Live K/V rows (and scales) read once, q read and the output
    written once, the tables and lengths read once, over 3.35 TB/s;
    against q·k and p·v, 2 flops a product each, over 67 TFLOP/s fp32."""
    q = case["q"]
    slots, heads, d = q.shape
    toks = live_tokens(case)
    nbytes = (toks * case["kv_row_bytes"] + 2 * q.numel() * q.element_size()
              + case["tables"].numel() * 4 + slots * 4)
    flops = toks * heads * d * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(case, k, v, extra):
    """Yardstick, not the port: gather the pages, then PyTorch's SDPA
    with a boolean mask of the attended positions."""
    import torch
    import torch.nn.functional as F

    from pytorchdistributed_tpu_torch.ops.attention import paged_gather
    from pytorchdistributed_tpu_torch.ops.quant import kv_dequantize

    q, tables, lengths = case["q"], case["tables"], case["lengths"]
    kc, vc = paged_gather(k, tables), paged_gather(v, tables)
    if extra:
        kc = kv_dequantize(kc, paged_gather(extra["k_scale"], tables),
                           q.dtype)
        vc = kv_dequantize(vc, paged_gather(extra["v_scale"], tables),
                           q.dtype)
    j = torch.arange(kc.shape[1], device=q.device)
    n = lengths.long()[:, None]
    valid = j[None] <= n
    w, s = case["kw"]["window_tokens"], case["kw"]["sink_tokens"]
    if w:
        valid &= (j[None] < s) | (j[None] > n - w)
    rep = q.shape[1] // kc.shape[2]
    return F.scaled_dot_product_attention(
        q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
        attn_mask=valid[:, None, None], enable_gqa=rep > 1)[:, :, 0]


def cycler(case):
    """A function giving the case's pools in turn, one set a call."""
    pools, it = case["pools"], iter(range(10 ** 9))
    return lambda: pools[next(it) % len(pools)]


def time_paged(case, attend) -> dict:
    """``attend(q, k, v, tables, lengths, **kw)`` over the case's pools in
    turn: the device-clock time of a call (every kernel it launches,
    from the profiler) and CUDA events around 200 calls, host gaps and
    all."""
    q, tables, lengths, kw = (case["q"], case["tables"], case["lengths"],
                              case["kw"])
    rot = cycler(case)

    def call():
        k, v, ex = rot()
        attend(q, k, v, tables, lengths, **kw, **ex)

    ms, kernels = call_device_ms(call, 50)
    return dict(ms=ms, kernels_per_call=kernels, ms_events=time_ms(call, 200))


def run_case(case, *, timed: bool) -> dict:
    import torch

    from pytorchdistributed_tpu_torch.ops import paged_attention as pa

    q, tables, lengths, kw = (case["q"], case["tables"], case["lengths"],
                              case["kw"])
    k, v, extra = case["pools"][0]
    got = pa.paged_flash_attention(q, k, v, tables, lengths, **kw, **extra)
    again = pa.paged_flash_attention(q, k, v, tables, lengths, **kw,
                                     **extra)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{case['name']}: two launches differ")
    want = pa.paged_flash_attention_plain(q, k, v, tables, lengths, **kw,
                                          **extra)
    check(bool(torch.isfinite(got).all()), f"{case['name']}: non-finite")
    err = (got.float() - want.float()).abs()
    tol = BF16_TOL * (1 + want.float().abs())
    max_err = float(err.max())
    check(bool((err <= tol).all()),
          f"{case['name']}: kernel vs plain max |err| {max_err:.3e} beyond "
          f"{BF16_TOL} * (1 + |plain|)")
    lib = library_call(case, k, v, extra)
    lib_err = float((lib.float() - want.float()).abs().max())
    out = dict(name=case["name"], max_abs_err=max_err, lib_err=lib_err,
               live_tokens=live_tokens(case))
    if timed:
        per_split = pa._default_pages_per_split(q, k, tables)
        pages = tables.shape[1]
        out.update(time_paged(case, pa.paged_flash_attention))
        rot = cycler(case)

        def launch(pages_per_split):
            kk, vv, ex = rot()
            pa._launch(q, kk, vv, tables, lengths, ex.get("k_scale"),
                       ex.get("v_scale"), kw["sink_tokens"],
                       kw["window_tokens"], q.shape[-1] ** -0.5,
                       pages_per_split=pages_per_split)

        # the same kernel with other run lengths, from a page a warp up to
        # one run for the whole table; and the merge kernel alone
        out["per_split_ms"] = {
            p: call_device_ms(lambda p=p: launch(p), 50)[0]
            for p in sorted({per_split, 4, 8, 12, 16, 24, 32, pages})}
        if per_split < pages:
            out["merge_ms"] = kernel_device_ms(
                lambda: launch(per_split), 50, PAGED_KERNELS[1])
        lib_ms, lib_kernels = call_device_ms(
            lambda: library_call(case, *rot()), 20)
        bms, by = bound_ms(case)
        out.update(pages_per_split=per_split, bound_ms=bms, bound_by=by,
                   plain_ms=time_ms(lambda: pa.paged_flash_attention_plain(
                       q, k, v, tables, lengths, **kw, **extra), 3),
                   library_ms=lib_ms, library_kernels=lib_kernels,
                   library_ms_events=time_ms(
                       lambda: library_call(case, *rot()), 20),
                   times_bound=out["ms"] / bms, copies=case["copies"],
                   cycle_mb=case["cycle_bytes"] / 1e6)
    log(f"  {case['name']}: " + json.dumps(
        {k: (round(v, 6) if isinstance(v, float) else v)
         for k, v in out.items() if k != "name"}, default=float))
    return out


def phase_kernels() -> dict:
    log("phase 3: the paged kernel vs its plain twin (tolerance "
        f"|err| <= {BF16_TOL} * (1 + |plain|), bf16; two launches bitwise "
        "equal); timed on the device clock over pools past the L2")
    cases = [run_case(paged_case(name, timed=True, **kw), timed=True)
             for name, kw in PAGED_TIMED]
    errs = [c["max_abs_err"] for c in cases]
    for case in (
            paged_case("int8_pool", int8=True, seed=2),
            paged_case("sink16_window256", sink=16, window=256, seed=3),
            paged_case("gqa_16q_2kv", heads=16, kv_heads=2, seed=4)):
        errs.append(run_case(case, timed=False)["max_abs_err"])
    res = dict(cases[0])
    res["max_abs_err_all_variants"] = max(errs)
    res["cases"] = cases
    return res


# ---------------------------------------------------------------------------
# phase 4: serve GPT-2-small through the port


def phase_serve() -> dict:
    import numpy as np
    import torch

    from pytorchdistributed_tpu_torch.models import (
        GPT2,
        gpt2_config,
        init_weights,
    )
    from pytorchdistributed_tpu_torch.ops.paged_attention import (
        paged_flash_attention,
    )
    from pytorchdistributed_tpu_torch.serving import (
        SamplingParams,
        ServingEngine,
        paged_decode_tick,
    )

    log("phase 4: serve GPT-2-small (12 x 768, vocab 50257, ctx 1024), "
        "bf16 compute, seeded weights")
    cfg = gpt2_config("small")
    model = init_weights(GPT2(cfg), seed=0)
    engine = ServingEngine(model, num_slots=8, block_size=16,
                           prefill_bucket=128, paged_attn="pallas",
                           device="cuda")
    engine.warmup(prompt_lens=(32,))
    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab_size, (64,)).astype(np.int32)
    lens = [32, 600, 97, 300, 48, 450, 160, 230]
    prompts = []
    for i, n in enumerate(lens):
        p = rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
        if i in (0, 3, 6):           # three share a 64-token prefix
            p = np.concatenate([system, p[:n - 64]]) if n > 64 \
                else np.concatenate([system[:n - 1], p[-1:]])
        prompts.append(p)
    sampling = [SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                               seed=i) if i % 2 else SamplingParams()
                for i in range(len(prompts))]

    paged_flash_attention.launches = 0
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=64, sampling=s)
            for p, s in zip(prompts, sampling)]
    snap = None
    while engine.queue_depth or engine.active_count or \
            engine.prefilling_count:
        engine.step()
        if snap is None and engine.active_count == len(reqs):
            # one cache state for the read comparison after the run
            tables, lengths, tokens = engine.decode_state()
            snap = (engine.cache.clone(), tables.clone(), lengths.clone(),
                    tokens.clone(), {r.slot: r.output_ids for r in reqs})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_flash_attention.launches
    s = engine.summary()

    check(all(r.done and r.finish_reason == "length"
              and len(r.new_tokens) == 64 for r in reqs),
          "not every request finished with 64 tokens")
    check(launches == s["ticks"] * cfg.num_layers,
          f"kernel launches {launches} != ticks {s['ticks']} x "
          f"{cfg.num_layers} layers")
    check(s["prefix_hit_tokens"] > 0, "the shared prefix never hit")
    check(snap is not None, "all 8 requests were never resident at once")

    # the kernel tick against the gather tick from the snapshot, and the
    # gather tick against a cache-free causal forward of the same tokens
    cache, tables, lengths, tokens, ids = snap
    n = len(reqs)
    zeros = torch.zeros(n, device="cuda")
    greedy = (zeros, zeros, torch.zeros(n, dtype=torch.long, device="cuda"),
              torch.ones(n, device="cuda"))
    reads = {}
    for mode in ("pallas", "gather"):
        c = cache.clone()
        c.cfg = dataclasses.replace(c.cfg, paged_attn=mode)
        _, logits = paged_decode_tick(engine.model, c, tables, lengths,
                                      tokens, *greedy, candidates=64)
        reads[mode] = logits
    torch.cuda.synchronize()
    check(bool(torch.isfinite(reads["pallas"]).all()), "non-finite logits")
    check(tuple(reads["pallas"].shape) == (n, cfg.vocab_size),
          f"logits shape {tuple(reads['pallas'].shape)}")
    kg_err = float((reads["pallas"] - reads["gather"]).abs().max())
    slot0 = int(torch.nonzero(lengths == lengths.max())[0])
    with torch.inference_mode():
        seq = torch.as_tensor(ids[slot0], device="cuda")[None].long()
        dense = engine.model(seq)[0, -1]
    dense_err = float((reads["gather"][slot0] - dense).abs().max())
    # bf16 logits: allow 4 ulps at the largest logit (2^-5 relative)
    logit_tol = 2.0 ** -5 * max(1.0, float(dense.abs().max()))
    log(f"  logits |kernel - gather| max {kg_err:.4e}; |gather - dense "
        f"forward| max {dense_err:.4e}; tolerance {logit_tol:.4e}")
    check(kg_err <= logit_tol, f"kernel vs gather logits differ by {kg_err}")
    check(dense_err <= logit_tol,
          f"paged vs dense logits differ by {dense_err}")
    out = dict(requests=len(reqs), ticks=s["ticks"], launches=launches,
               decode_tokens=s["decode_tokens"],
               ttft_ms_p50=s.get("ttft_ms_p50"),
               ttft_ms_p99=s.get("ttft_ms_p99"),
               decode_tokens_per_s=s["decode_tokens_per_s"],
               tick_ms=s["tick_ms_mean"],
               prefill_ms_mean=s["prefill_ms_mean"],
               prefix_hit_tokens=s["prefix_hit_tokens"],
               preemptions=s["preemptions"], wall_s=round(wall, 3),
               logits_kernel_vs_gather=kg_err,
               logits_paged_vs_dense=dense_err, logits_tol=logit_tol)
    log("  serve: " + json.dumps(out))
    out["profile"] = profile_serve(engine, prompts)
    engine.close()
    return out


def device_profile(run, name: str, tally=()) -> dict:
    """Where a window's time goes: ``run()`` under torch.profiler. Device
    busy time is the union of the CUDA kernels' intervals (GPU user
    annotations such as ``Optimizer.step#AdamW.step`` span kernels and
    are left out); the rest of the host-clock window is device idle.
    ``tally_ms`` sums the device time of the kernels whose names contain
    one of ``tally``. Written in full to ``<name>_profile.json`` in the
    report directory."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extra = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, per_kernel = [], {}
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        r = e.time_range
        spans.append((r.start, r.end))
        tot = per_kernel.setdefault(e.name, [0.0, 0])
        tot[0] += r.elapsed_us()
        tot[1] += 1
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    tallied = [v for k, v in per_kernel.items()
               if any(t in k for t in tally)]
    out = dict(wall_ms=wall_us / 1e3, **(extra or {}),
               device_busy_ms=busy / 1e3,
               device_idle_share=(1 - busy / wall_us) if spans else None,
               kernels=len(spans),
               tally_ms=sum(v[0] for v in tallied) / 1e3,
               tally_launches=sum(v[1] for v in tallied),
               top=[dict(name=k[:80], ms=v[0] / 1e3, count=v[1])
                    for k, v in top[:12]])
    with open(os.path.join(report_dir(), f"{name}_profile.json"), "w") as f:
        json.dump(out, f, indent=1)
    log("  profile: " + json.dumps({k: v for k, v in out.items()
                                    if k != "top"}))
    for row in out["top"][:8]:
        log(f"    {row['ms']:9.3f} ms  x{row['count']:<5} {row['name']}")
    return out


def profile_serve(engine, prompts) -> dict:
    """A short second serving run (8 requests, 64-token prompts, 24 new
    tokens) under the profiler (serve_profile.json); ``tally_ms`` is the
    paged kernels' device time in it."""

    def run():
        for p in prompts:
            engine.submit(p[:64], max_new_tokens=24)
        ticks0 = engine.summary()["ticks"]
        engine.run_until_idle()
        return dict(ticks=engine.summary()["ticks"] - ticks0)

    return device_profile(run, "serve", tally=PAGED_KERNELS)


# ---------------------------------------------------------------------------
# phase 3b: the flash attention kernels against their plain twins


# each flash kernel's ptxas name as the flash step instantiates it at the
# training shape (the forward's third argument is its q-tile height)
FLASH_PTXAS = {"flash_fwd": "flash_fwd_kernel<64, false, 128>",
               "flash_bwd_dkv": "flash_bwd_dkv_kernel<64, false>",
               "flash_bwd_dq": "flash_bwd_dq_kernel<64, false>"}
FLASH_REPLACES = {
    "flash_fwd": "pytorchdistributed_tpu/ops/pallas_attention.py:57",
    "flash_bwd_dkv": "pytorchdistributed_tpu/ops/pallas_attention.py:228",
    "flash_bwd_dq": "pytorchdistributed_tpu/ops/pallas_attention.py:289",
}


def flash_case(name, *, b, s, h, hk, d=64, causal, copies=1, seed=0):
    """bf16 (q, k, v, dO) on the card at one shape; ``copies`` independent
    sets (cycling through two keeps the ~63 MB of operands at the
    training shape from being served out of the 50 MB L2)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    sets = []
    for _ in range(copies):
        sets.append(tuple(
            torch.randn(*shape, generator=gen).to("cuda", torch.bfloat16)
            for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d),
                          (b, s, h, d))))
    return dict(name=name, causal=causal, sets=sets, shape=(b, s, h, hk, d))


def flash_bounds(case) -> dict:
    """Least time per kernel: bytes (each input read once, each output
    written once) over 3.35 TB/s against the products' flops over 989
    TFLOP/s bf16, for the (q, k) pairs this run attends."""
    b, s, h, hk, d = case["shape"]
    pairs = b * h * (s * (s + 1) // 2 if case["causal"] else s * s)
    q_bytes = b * s * h * d * 2          # q, O, dO and dQ alike (bf16)
    kv_bytes = b * s * hk * d * 2        # each of k, v, dK, dV
    row_bytes = b * h * s * 4            # LSE or Δ (fp32)
    work = {  # (bytes, flops): 2·d flops per pair per product
        "flash_fwd": (2 * q_bytes + 2 * kv_bytes + row_bytes,
                      2 * 2 * d * pairs),       # Q·Kᵀ, P·V
        "flash_bwd_dkv": (2 * q_bytes + 4 * kv_bytes + 2 * row_bytes,
                          4 * 2 * d * pairs),   # Q·Kᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q
        "flash_bwd_dq": (3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,
                         3 * 2 * d * pairs),    # Q·Kᵀ, dO·Vᵀ, dS·K
    }
    return {name: bf16_bound(*w) for name, w in work.items()}


def bf16_bound(nbytes: int, flops: int) -> tuple[float, str]:
    """(least ms, "bytes" or "operations"): ``nbytes`` over 3.35 TB/s
    against ``flops`` over 989 TFLOP/s bf16, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want):
    """(max |got - want|, whether every entry is within BF16_TOL·(1 +
    |want|))."""
    err = (got.float() - want.float()).abs()
    return float(err.max()), bool((err <= BF16_TOL * (1 + want.float().abs()))
                                  .all())


def run_flash_case(case, *, timed: bool) -> dict:
    import torch
    import torch.nn.functional as F

    from pytorchdistributed_tpu_torch.ops import flash_attention as fa

    causal, name = case["causal"], case["name"]
    q, k, v, do = case["sets"][0]
    scale = q.shape[-1] ** -0.5
    o, lse = fa._launch_fwd(q, k, v, causal, scale)
    dq, dk, dv = fa._launch_bwd(q, k, v, o, lse, do, causal, scale)
    dq2, dk2, dv2 = fa._launch_bwd(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    check(torch.equal(dk, dk2) and torch.equal(dv, dv2)
          and torch.equal(dq, dq2),
          f"{name}: two backward runs differ (not deterministic)")
    po, plse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
    # the backward kernels and their twin on the same (O, LSE, dO)
    pdq, pdk, pdv = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                 causal=causal)
    errs = {}
    for key, got, want in (("O", o, po), ("LSE", lse, plse), ("dQ", dq, pdq),
                           ("dK", dk, pdk), ("dV", dv, pdv)):
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite {key}")
        errs[key], ok = max_err(got, want)
        check(ok, f"{name}: {key} kernel vs plain max |err| {errs[key]:.3e} "
                  f"beyond {BF16_TOL} * (1 + |plain|)")
    out = dict(name=name, max_abs_err=errs)
    if timed:
        sets = case["sets"]
        # each kernel's operands per set: dQ's (q, k, v, dO, O, LSE), and
        # dK/dV's (q, k, v, dO, LSE, Δ) with the Δ that dQ formed
        dq_args, dkv_args = [], []
        for qq, kk, vv, dd in sets:
            oo, ll = fa._launch_fwd(qq, kk, vv, causal, scale)
            ops = fa._bwd_operands(qq, kk, vv, oo, ll, dd)
            dq_args.append(ops)
            dkv_args.append((*ops[:4], ops[5],
                             fa._launch_dq(*ops, causal, scale)[1]))
        it = iter(range(10 ** 9))

        def nxt(seq):
            return seq[next(it) % len(seq)]

        def sdpa_fwd():
            qq, kk, vv, _ = nxt(sets)
            return F.scaled_dot_product_attention(
                qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                is_causal=causal, enable_gqa=qq.shape[2] != kk.shape[2])

        leaves = [[t.detach().clone().requires_grad_() for t in st[:3]]
                  for st in sets]

        def sdpa_fwd_bwd():
            i = next(it) % len(sets)
            qq, kk, vv = leaves[i]
            out_ = F.scaled_dot_product_attention(
                qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                is_causal=causal, enable_gqa=qq.shape[2] != kk.shape[2])
            torch.autograd.grad(out_, (qq, kk, vv),
                                sets[i][3].transpose(1, 2))

        def port_fwd_bwd():
            i = next(it) % len(sets)
            qq, kk, vv = leaves[i]
            out_ = fa.flash_attention(qq, kk, vv, causal=causal)
            torch.autograd.grad(out_, (qq, kk, vv), sets[i][3])

        bounds = flash_bounds(case)
        lib_fwd = time_ms(sdpa_fwd, 50)
        lib_bwd = time_ms(sdpa_fwd_bwd, 50) - lib_fwd
        plain_bwd = time_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal=causal), 3)
        out["kernels"] = {
            "flash_fwd": dict(
                ms=time_ms(lambda: fa._launch_fwd(*nxt(sets)[:3], causal,
                                                  scale), 50),
                plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(
                    q, k, v, causal=causal), 3),
                library_ms=lib_fwd),
            "flash_bwd_dkv": dict(
                ms=time_ms(lambda: fa._launch_dkv(*nxt(dkv_args), causal,
                                                  scale), 50),
                plain_ms=plain_bwd, library_ms=lib_bwd),
            "flash_bwd_dq": dict(
                ms=time_ms(lambda: fa._launch_dq(*nxt(dq_args), causal,
                                                 scale), 50),
                plain_ms=plain_bwd, library_ms=lib_bwd),
        }
        for kname, row in out["kernels"].items():
            row["bound_ms"], row["bound_by"] = bounds[kname]
        out["port_fwd_bwd_ms"] = time_ms(port_fwd_bwd, 20)
        out["library_fwd_bwd_ms"] = lib_fwd + lib_bwd
        # like with like on the device clock: each kernel's own time, and
        # the whole backward of each side — the port's Δ and both kernels
        # against every kernel SDPA's backward launches — per call
        dkv_name = f"flash_bwd_dkv_kernel<{q.shape[-1]}, false"
        dq_name = f"flash_bwd_dq_kernel<{q.shape[-1]}, false"
        out["kernels"]["flash_bwd_dkv"]["ms_device"] = kernel_device_ms(
            lambda: fa._launch_dkv(*nxt(dkv_args), causal, scale), 50,
            dkv_name)
        out["kernels"]["flash_bwd_dq"]["ms_device"] = kernel_device_ms(
            lambda: fa._launch_dq(*nxt(dq_args), causal, scale), 50,
            dq_name)
        saved = []
        for (qq, kk, vv), dd in zip(leaves, (st[3] for st in sets)):
            out_ = F.scaled_dot_product_attention(
                qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                is_causal=causal, enable_gqa=qq.shape[2] != kk.shape[2])
            saved.append((out_, (qq, kk, vv), dd.transpose(1, 2)))

        def sdpa_bwd():
            out_, ins, dd = nxt(saved)
            torch.autograd.grad(out_, ins, dd, retain_graph=True)

        fwd_outs = [fa._launch_fwd(*st[:3], causal, scale) for st in sets]

        def port_bwd():
            i = next(it) % len(sets)
            fa._launch_bwd(*sets[i][:3], *fwd_outs[i], sets[i][3], causal,
                           scale)

        def delta():
            i = next(it) % len(sets)
            fa._delta(fwd_outs[i][0], sets[i][3])

        out["library_bwd_device_ms"], out["library_bwd_kernels"] = \
            call_device_ms(sdpa_bwd, 20)
        out["port_bwd_device_ms"], out["port_bwd_kernels"] = \
            call_device_ms(port_bwd, 20)
        out["delta_device_ms"], out["delta_kernels"] = call_device_ms(
            delta, 20)
    log(f"  {name}: " + json.dumps(out, default=float))
    return out


def phase_flash(registers: dict) -> dict:
    log("phase 3b: flash kernels vs plain twins (tolerance |err| <= "
        f"{BF16_TOL} * (1 + |plain|), bf16; backward run twice, bitwise)")
    train_case = flash_case("train_8x1024x12x64_causal", b=8, s=1024, h=12,
                            hk=12, causal=True, copies=2)
    train = run_flash_case(train_case, timed=True)
    # a GQA group of 4 (the dK/dV walk crosses q heads) and a ragged
    # sequence; then where the tilings have edges — the forward's 128-row
    # q tiles, the backward's 64-row CTA sides and streamed tiles — S 64
    # and 96 (less than one q tile), S 200 (a ragged diagonal), and head
    # dims 32 and 128
    variants = [run_flash_case(flash_case(
        name, b=b, s=s, h=h, hk=hk, d=d, causal=causal, seed=seed),
        timed=False) for name, b, s, h, hk, d, causal, seed in (
            ("gqa_32q_8kv_s512_causal", 4, 512, 32, 8, 64, True, 1),
            ("ragged_s1000_full", 2, 1000, 12, 12, 64, False, 2),
            ("s64_causal", 4, 64, 12, 12, 64, True, 3),
            ("s96_causal", 4, 96, 12, 12, 64, True, 4),
            ("s200_causal", 4, 200, 12, 12, 64, True, 5),
            ("d32_s512_causal", 2, 512, 12, 12, 32, True, 6),
            ("d128_s512_causal", 2, 512, 12, 12, 128, True, 7),
            ("gqa_8q_2kv_s200_causal", 2, 200, 8, 2, 64, True, 8))]
    b, s, h, _, d = train_case["shape"]
    pairs = b * h * s * (s + 1) // 2
    for kname, products in (("flash_fwd", 2), ("flash_bwd_dkv", 4),
                            ("flash_bwd_dq", 3)):
        row = train["kernels"][kname]
        row["tflops"] = products * 2 * d * pairs / (row["ms"] * 1e-3) / 1e12
        row["times_bound"] = row["ms"] / row["bound_ms"]
        ptx = registers.get(FLASH_PTXAS[kname], {})
        row.update(registers=ptx.get("registers"),
                   spill_bytes=ptx.get("spill_bytes"))
        log(f"  {kname} at {train_case['name']}: {row['ms']:.4f} ms, "
            f"{row['tflops']:.1f} TFLOP/s, {row['times_bound']:.2f}x its "
            f"{row['bound_ms']:.4f} ms bound ({row['bound_by']}); "
            f"registers {row['registers']}, spill bytes "
            f"{row['spill_bytes']}")
    log(f"  SDPA's forward {train['kernels']['flash_fwd']['library_ms']:.4f}"
        f" ms; the whole backward on the device clock: the port "
        f"{train['port_bwd_device_ms']:.4f} ms a call "
        f"({train['port_bwd_kernels']:.0f} kernels; dK/dV "
        f"{train['kernels']['flash_bwd_dkv']['ms_device']:.4f}, dQ "
        f"{train['kernels']['flash_bwd_dq']['ms_device']:.4f}), SDPA "
        f"{train['library_bwd_device_ms']:.4f} ms "
        f"({train['library_bwd_kernels']:.0f} kernels); the eager Δ the "
        f"ring keeps {train['delta_device_ms']:.4f} ms "
        f"({train['delta_kernels']:.0f} kernels)")
    errs = {}
    for kname, keys in (("flash_fwd", ("O", "LSE")),
                        ("flash_bwd_dkv", ("dK", "dV")),
                        ("flash_bwd_dq", ("dQ",))):
        row = train["kernels"][kname]
        if kname != "flash_fwd":
            # no library call computes dK/dV or dQ alone: both backward
            # rows carry the one SDPA backward and the one plain backward.
            # SDPA's backward on the device clock: CUDA events around its
            # autograd call time the host as much as the device
            row["plain_and_library_compute"] = "dQ, dK and dV together"
            row["library_ms_events"] = row["library_ms"]
            row["library_ms"] = train["library_bwd_device_ms"]
        row["max_abs_err"] = max(train["max_abs_err"][k] for k in keys)
        row["max_abs_err_all_variants"] = max(
            r["max_abs_err"][k] for r in (train, *variants) for k in keys)
        errs[kname] = row
    return dict(kernels=errs, port_fwd_bwd_ms=train["port_fwd_bwd_ms"],
                library_fwd_bwd_ms=train["library_fwd_bwd_ms"],
                port_bwd_device_ms=train["port_bwd_device_ms"],
                library_bwd_device_ms=train["library_bwd_device_ms"],
                delta_device_ms=train["delta_device_ms"])


# ---------------------------------------------------------------------------
# phase 3c: the ring-attention hop kernels against their plain twins


RING_REPLACES = {
    "ring_fwd": "pytorchdistributed_tpu/ops/ring_attention.py:104",
    "ring_bwd_dq": "pytorchdistributed_tpu/ops/ring_attention.py:156",
    "ring_bwd_dkv": "pytorchdistributed_tpu/ops/ring_attention.py:156",
}
RING_SHARDS = 4                # phase 6's seq axis: S_local 1024 / 4
RING_LIBRARY_NOTE = ("none: no PyTorch call computes one carried, "
                     "unnormalized ring hop")


def ring_hop_case(name, *, b=8, s=256, h=12, d=64, causal, copies=1,
                  seed=0):
    """bf16 hop operands at one shape with the fp32 carries a previous
    visible hop (over another K/V block) leaves: (acc, m, l) for the
    forward; the two hops' LSE and Δ, and one earlier hop's dQ/dK/dV, for
    the backward. ``copies`` independent sets (three keep a timing loop's
    22–38 MB per launch from being served out of the 50 MB L2)."""
    import torch

    from pytorchdistributed_tpu_torch.ops import ring_attention as ring

    gen = torch.Generator().manual_seed(seed)
    scale = d ** -0.5
    sets = []
    for _ in range(copies):
        q, k0, v0, k, v, do = (
            torch.randn(b, s, h, d, generator=gen).to("cuda", torch.bfloat16)
            for _ in range(6))
        acc = torch.zeros(b, s, h, d, device="cuda")
        m = torch.full((b, h, s), -1e30, device="cuda")
        l = torch.zeros(b, h, s, device="cuda")
        ring.ring_fwd_update_plain(q, k0, v0, acc, m, l, causal=False,
                                   scale=scale)
        fa, fm, fl = ring.ring_fwd_update_plain(
            q, k, v, acc.clone(), m.clone(), l.clone(), causal=causal,
            scale=scale)
        lsum = fl.clamp_min(1e-30)
        lse = fm + torch.log(lsum)
        o = (fa / lsum.transpose(1, 2)[..., None]).to(q.dtype)
        delta = ring._delta(o, do)
        dq, dk, dv = (torch.zeros(b, s, h, d, device="cuda")
                      for _ in range(3))
        ring.ring_bwd_update_plain(q, k0, v0, do, lse, delta, dq, dk, dv,
                                   causal=False, scale=scale)
        sets.append(dict(q=q, k=k, v=v, do=do, acc=acc, m=m, l=l, lse=lse,
                         delta=delta, dq=dq, dk=dk, dv=dv))
    return dict(name=name, causal=causal, sets=sets, shape=(b, s, h, d),
                scale=scale)


def ring_bounds(case) -> dict:
    """Least time per hop kernel: bytes (each input read once, each output
    written once — the fp32 carry in and out) over 3.35 TB/s against the
    products' flops over 989 TFLOP/s bf16, for the pairs this hop
    attends."""
    b, s, h, d = case["shape"]
    pairs = b * h * (s * (s + 1) // 2 if case["causal"] else s * s)
    op_bytes = b * s * h * d * 2         # q, k, v or dO (bf16)
    carry_bytes = b * s * h * d * 4      # acc, dQ, dK or dV (fp32)
    row_bytes = b * h * s * 4            # m, l, LSE or Δ (fp32)
    work = {  # (bytes, flops): 2·d flops per pair per product
        "ring_fwd": (3 * op_bytes + 2 * carry_bytes + 4 * row_bytes,
                     2 * 2 * d * pairs),        # Q·Kᵀ, P·V
        "ring_bwd_dq": (4 * op_bytes + 2 * carry_bytes + 2 * row_bytes,
                        3 * 2 * d * pairs),     # Q·Kᵀ, dO·Vᵀ, dS·K
        "ring_bwd_dkv": (4 * op_bytes + 4 * carry_bytes + 2 * row_bytes,
                         4 * 2 * d * pairs),    # + Pᵀ·dO, dSᵀ·Q
    }
    return {name: bf16_bound(*w) for name, w in work.items()}


def run_ring_case(case, *, timed: bool) -> dict:
    import torch

    from pytorchdistributed_tpu_torch.ops import ring_attention as ring

    causal, name, scale = case["causal"], case["name"], case["scale"]
    st = case["sets"][0]
    q, k, v, do = st["q"], st["k"], st["v"], st["do"]
    # the kernels update their carries in place: each side gets a clone
    got = ring._launch_fwd_hop(q, k, v, st["acc"].clone(), st["m"].clone(),
                               st["l"].clone(), causal, scale)
    ops = ring._bwd_hop_operands(q, k, v, do, st["lse"], st["delta"])
    got += (ring._launch_dq_hop(ops, st["dq"].clone(), causal, scale),
            *ring._launch_dkv_hop(ops, st["dk"].clone(), st["dv"].clone(),
                                  causal, scale))
    torch.cuda.synchronize()
    want = ring.ring_fwd_update_plain(
        q, k, v, st["acc"].clone(), st["m"].clone(), st["l"].clone(),
        causal=causal, scale=scale)
    want += ring.ring_bwd_update_plain(
        q, k, v, do, st["lse"], st["delta"], st["dq"].clone(),
        st["dk"].clone(), st["dv"].clone(), causal=causal, scale=scale)
    # acc is an unnormalized sum of up to 2·S_local bf16-rounded p·v terms
    # (p <= 1), so its rounding scales with l, not with |acc|: it is held
    # as acc / l, the output the ring normalizes it to (l on its own)
    got, want = ((t[0] / t[2].transpose(1, 2)[..., None], *t[1:])
                 for t in (got, want))
    errs = {}
    for key, g, w in zip(("acc/l", "m", "l", "dQ", "dK", "dV"), got,
                         want):
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite {key}")
        errs[key], ok = max_err(g, w)
        check(ok, f"{name}: {key} kernel vs plain max |err| {errs[key]:.3e} "
                  f"beyond {BF16_TOL} * (1 + |plain|)")
    out = dict(name=name, max_abs_err=errs)
    if timed:
        sets = case["sets"]
        it = iter(range(10 ** 9))

        def nxt():
            return sets[next(it) % len(sets)]

        def fwd():
            x = nxt()
            ring._launch_fwd_hop(x["q"], x["k"], x["v"], x["acc"], x["m"],
                                 x["l"], causal, scale)

        prepared = [(ring._bwd_hop_operands(x["q"], x["k"], x["v"], x["do"],
                                            x["lse"], x["delta"]), x)
                    for x in sets]

        def dq():
            o, x = prepared[next(it) % len(prepared)]
            ring._launch_dq_hop(o, x["dq"], causal, scale)

        def dkv():
            o, x = prepared[next(it) % len(prepared)]
            ring._launch_dkv_hop(o, x["dk"], x["dv"], causal, scale)

        scratch = {key: st[key].clone() for key in
                   ("acc", "m", "l", "dq", "dk", "dv")}
        plain_fwd = time_ms(lambda: ring.ring_fwd_update_plain(
            q, k, v, scratch["acc"], scratch["m"], scratch["l"],
            causal=causal, scale=scale), 3)
        plain_bwd = time_ms(lambda: ring.ring_bwd_update_plain(
            q, k, v, do, st["lse"], st["delta"], scratch["dq"],
            scratch["dk"], scratch["dv"], causal=causal, scale=scale), 3)
        bounds = ring_bounds(case)
        d = case["shape"][-1]
        out["kernels"] = {}
        for kname, fn, body, plain in (
                ("ring_fwd", fwd, "flash_fwd_kernel", plain_fwd),
                ("ring_bwd_dq", dq, "flash_bwd_dq_kernel", plain_bwd),
                ("ring_bwd_dkv", dkv, "flash_bwd_dkv_kernel", plain_bwd)):
            # ms: the kernel's device time; ms_events: CUDA events around
            # the launch loop, host launch gaps included
            out["kernels"][kname] = dict(
                ms=kernel_device_ms(fn, 50, f"{body}<{d}, true"),
                ms_events=time_ms(fn, 50), plain_ms=plain)
        for kname, row in out["kernels"].items():
            row["bound_ms"], row["bound_by"] = bounds[kname]
    log(f"  {name}: " + json.dumps(out, default=float))
    return out


def phase_ring_hops() -> dict:
    log("phase 3c: ring hop kernels vs plain twins (tolerance |err| <= "
        f"{BF16_TOL} * (1 + |plain|), bf16 operands, fp32 carries)")
    visible = run_ring_case(ring_hop_case(
        "hop_8x256x12x64_visible", causal=False, copies=3), timed=True)
    diagonal = run_ring_case(ring_hop_case(
        "hop_8x256x12x64_diagonal", causal=True, copies=3, seed=1),
        timed=True)
    ragged = run_ring_case(ring_hop_case(
        "hop_8x250x12x64_ragged_visible", s=250, causal=False, seed=2),
        timed=False)
    rows = {}
    for kname, keys in (("ring_fwd", ("acc/l", "m", "l")),
                        ("ring_bwd_dq", ("dQ",)),
                        ("ring_bwd_dkv", ("dK", "dV"))):
        row = dict(visible["kernels"][kname])   # the main: 6 of 10 hops
        diag = diagonal["kernels"][kname]
        row.update(ms_diagonal=diag["ms"],
                   ms_events_diagonal=diag["ms_events"],
                   bound_ms_diagonal=diag["bound_ms"],
                   plain_ms_diagonal=diag["plain_ms"])
        if kname != "ring_fwd":
            row["plain_computes"] = "dQ, dK and dV together"
        row["max_abs_err"] = max(visible["max_abs_err"][k] for k in keys)
        row["max_abs_err_all_variants"] = max(
            r["max_abs_err"][k] for r in (visible, diagonal, ragged)
            for k in keys)
        rows[kname] = row
    return rows


# ---------------------------------------------------------------------------
# phase 5: train GPT-2-small through the port


TRAIN_WARMUP, TRAIN_STEPS, PROFILE_STEPS = 2, 12, 2


def loss_and_grad(model, batch):
    """Step 0 of the trainer by hand: the loss and every gradient,
    flattened into one fp32 vector."""
    import torch

    from pytorchdistributed_tpu_torch.training import (
        token_cross_entropy_loss,
    )

    model.zero_grad(set_to_none=True)
    loss, _ = token_cross_entropy_loss(model, batch)
    loss.backward()
    grad = torch.cat([p.grad.float().flatten() for p in model.parameters()])
    model.zero_grad(set_to_none=True)
    return loss.item(), grad


def dense_parity(model, batch, mesh=None) -> dict:
    """Step 0 from one weight copy: ``model``'s loss and gradient (under
    ``mesh``, if given) against a twin with ``attention="dense"`` —
    loss within 2e-3 relative, gradient cosine >= 0.999, norm within
    1 %."""
    import contextlib

    import torch

    from pytorchdistributed_tpu_torch.models import GPT2
    from pytorchdistributed_tpu_torch.runtime.mesh import set_mesh

    with set_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        loss_k, grad_k = loss_and_grad(model, batch)
    dense = GPT2(dataclasses.replace(model.cfg, attention="dense")).cuda()
    dense.load_state_dict(model.state_dict())
    loss_d, grad_d = loss_and_grad(dense, batch)
    del dense
    cos = float(torch.nn.functional.cosine_similarity(grad_k, grad_d, dim=0))
    norm_ratio = float(grad_k.norm() / grad_d.norm())
    loss_rel = abs(loss_k - loss_d) / abs(loss_d)
    del grad_k, grad_d
    torch.cuda.empty_cache()
    parity = dict(loss_kernel=loss_k, loss_dense=loss_d, loss_rel=loss_rel,
                  grad_cosine=cos, grad_norm_ratio=norm_ratio)
    log("  step-0 parity vs attention='dense': " + json.dumps(parity))
    check(loss_rel <= 2e-3, f"step-0 loss differs from dense by {loss_rel}")
    check(cos >= 0.999, f"step-0 gradient cosine {cos} < 0.999")
    check(abs(norm_ratio - 1) <= 0.01,
          f"step-0 gradient norm ratio {norm_ratio} off by more than 1 %")
    return parity


def phase_train(card: str) -> dict:
    import numpy as np
    import torch

    from pytorchdistributed_tpu_torch.models import (
        GPT2,
        gpt2_config,
        init_weights,
    )
    from pytorchdistributed_tpu_torch.ops import flash_attention as fa
    from pytorchdistributed_tpu_torch.training import (
        Trainer,
        adamw,
        token_cross_entropy_loss,
    )
    from pytorchdistributed_tpu_torch.utils.metrics import (
        transformer_train_flops_per_token,
    )

    log("phase 5: train GPT-2-small (12 x 768, vocab 50257, ctx 1024), "
        "batch 8 x 1024, bf16 compute, fp32 params, attention='pallas', "
        "adamw(3e-4)")
    cfg = gpt2_config("small", attention="pallas")
    model = init_weights(GPT2(cfg), seed=0).cuda()
    rng = np.random.default_rng(0)     # the bench_gpt2 batch
    batch = {k: torch.as_tensor(rng.integers(0, 50257, (8, 1024)).astype(
        np.int32), device="cuda") for k in ("tokens", "targets")}

    # step 0 from one weight copy: the flash kernels against dense
    parity = dense_parity(model, batch)

    trainer = Trainer(model, adamw(3e-4), token_cross_entropy_loss,
                      device="cuda", log_every=10 ** 9)
    for name in fa.launches:
        fa.launches[name] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        before = dict(fa.launches)
        t0 = time.perf_counter()
        losses.append(trainer.train_step(batch)["loss"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        grew = {n: fa.launches[n] - before[n] for n in before}
        check(all(g == cfg.num_layers for g in grew.values()),
              f"step {i}: flash launches grew by {grew}, not "
              f"{cfg.num_layers} each")
    peak = torch.cuda.max_memory_allocated()
    def window():
        for _ in range(PROFILE_STEPS):
            trainer.train_step(batch)
        return dict(steps=PROFILE_STEPS)

    prof = device_profile(window, "train")
    launches = dict(fa.launches)
    steps = TRAIN_WARMUP + TRAIN_STEPS + PROFILE_STEPS
    check(all(n == cfg.num_layers * steps for n in launches.values()),
          f"flash launches {launches} != {cfg.num_layers} x {steps} steps")
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite loss in {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    timed = np.asarray(step_s[TRAIN_WARMUP:])
    med = float(np.median(timed))
    tokens = 8 * 1024
    flops = transformer_train_flops_per_token(cfg) * tokens
    out = dict(steps=steps, step_ms_median=med * 1e3,
               step_ms_min=float(timed.min()) * 1e3,
               step_ms_max=float(timed.max()) * 1e3,
               tokens_per_s=tokens / med,
               mfu=flops / med / BF16_FLOPS_PER_S,
               flops_per_step=flops, peak_mem_bytes=peak,
               losses=losses, launches=launches, parity=parity,
               card=card)
    log("  train: " + json.dumps({k: v for k, v in out.items()
                                  if k != "losses"}))
    log(f"  losses: {[round(x, 4) for x in losses]}")
    out["profile"] = prof
    return out


# ---------------------------------------------------------------------------
# phase 6: train GPT-2-small with context parallelism through the ring


RING_WARMUP, RING_STEPS, RING_PROFILE_STEPS = 2, 6, 2


def phase_ring_train(card: str) -> dict:
    import numpy as np
    import torch

    from pytorchdistributed_tpu_torch.models import (
        GPT2,
        gpt2_config,
        init_weights,
    )
    from pytorchdistributed_tpu_torch.ops import ring_attention as ring
    from pytorchdistributed_tpu_torch.runtime.mesh import create_mesh
    from pytorchdistributed_tpu_torch.training import (
        Trainer,
        adamw,
        token_cross_entropy_loss,
    )
    from pytorchdistributed_tpu_torch.utils.metrics import (
        transformer_train_flops_per_token,
    )

    log(f"phase 6: train GPT-2-small (12 x 768, vocab 50257, ctx 1024), "
        f"batch 8 x 1024, attention='ring' over a port mesh "
        f"seq={RING_SHARDS} (S_local {1024 // RING_SHARDS}), bf16 compute, "
        f"fp32 params, adamw(3e-4)")
    cfg = gpt2_config("small", attention="ring")
    model = init_weights(GPT2(cfg), seed=0).cuda()
    mesh = create_mesh(seq=RING_SHARDS, device="cuda")
    rng = np.random.default_rng(0)     # phase 5's batch
    batch = {k: torch.as_tensor(rng.integers(0, 50257, (8, 1024)).astype(
        np.int32), device="cuda") for k in ("tokens", "targets")}
    parity = dense_parity(model, batch, mesh)

    # causal: shard j folds the blocks of shards 0..j, n(n+1)/2 hops a layer
    per_step = cfg.num_layers * RING_SHARDS * (RING_SHARDS + 1) // 2
    trainer = Trainer(model, adamw(3e-4), token_cross_entropy_loss,
                      mesh=mesh, device="cuda", log_every=10 ** 9)
    for name in ring.launches:
        ring.launches[name] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for i in range(RING_WARMUP + RING_STEPS):
        before = dict(ring.launches)
        t0 = time.perf_counter()
        losses.append(trainer.train_step(batch)["loss"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        grew = {n: ring.launches[n] - before[n] for n in before}
        check(all(g == per_step for g in grew.values()),
              f"step {i}: ring launches grew by {grew}, not {per_step} each")
    peak = torch.cuda.max_memory_allocated()

    def window():
        for _ in range(RING_PROFILE_STEPS):
            trainer.train_step(batch)
        return dict(steps=RING_PROFILE_STEPS)

    prof = device_profile(window, "ring")
    launches = dict(ring.launches)
    steps = RING_WARMUP + RING_STEPS + RING_PROFILE_STEPS
    check(all(n == per_step * steps for n in launches.values()),
          f"ring launches {launches} != {per_step} x {steps} steps")
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite loss in {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    timed = np.asarray(step_s[RING_WARMUP:])
    med = float(np.median(timed))
    tokens = 8 * 1024
    flops = transformer_train_flops_per_token(cfg) * tokens
    out = dict(steps=steps, shards=RING_SHARDS, step_ms_median=med * 1e3,
               step_ms_min=float(timed.min()) * 1e3,
               step_ms_max=float(timed.max()) * 1e3,
               tokens_per_s=tokens / med,
               mfu=flops / med / BF16_FLOPS_PER_S, peak_mem_bytes=peak,
               launches_per_step=per_step, launches=launches, parity=parity,
               losses=losses, card=card)
    log("  ring train: " + json.dumps({k: v for k, v in out.items()
                                       if k != "losses"}))
    log(f"  losses: {[round(x, 4) for x in losses]}")
    out["profile"] = prof
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "pytorchdistributed_tpu_torch")):
        raise SystemExit("chip_smoke.py needs the repository beside it "
                         "(pytorchdistributed_tpu_torch/ not found)")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU "
                         "(torch.cuda.is_available() is False)")
    t_start = time.perf_counter()
    log(f"phase 1: device — torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from pytorchdistributed_tpu_torch import _build

    t0 = time.perf_counter()
    reports = _build.build(*KERNEL_SOURCES)
    log(f"phase 2: built {list(KERNEL_SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s")
    registers = {}
    for name, rep in reports.items():
        with open(os.path.join(report_dir(), f"ptxas_{name}.txt"),
                  "w") as f:
            f.write(rep)
        registers.update(ptxas_kernels(rep))
    if registers:   # only a build made here has a report
        log("  ptxas: " + json.dumps(registers))
        spills = {k: v for k, v in registers.items()
                  if k.startswith(("flash_", "paged_")) and v["spill_bytes"]}
        check(not spills, f"kernel instantiations spill: {spills}")

    kern = phase_kernels()
    flash = phase_flash(registers)
    hops = phase_ring_hops()
    serve = phase_serve()
    train = phase_train(card)
    ring_train = phase_ring_train(card)

    # the paged row: the serving shape's device-clock time per call (its
    # kernel and, with more than one run of pages, the merge), and every
    # timed case beside it
    entries = [dict(
        name="paged_attention", route="cuda",
        source="pytorchdistributed_tpu_torch/csrc/paged_attention.cu",
        replaces=PAGED_REPLACES, launches=serve["launches"],
        **{k: kern[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "ms_events", "kernels_per_call",
            "pages_per_split", "max_abs_err_all_variants")},
        serve_profile_ms=serve["profile"]["tally_ms"],
        cases=[{k: c[k] for k in (
            "name", "ms", "ms_events", "bound_ms", "bound_by", "times_bound",
            "library_ms", "library_ms_events", "plain_ms",
            "pages_per_split", "per_split_ms", "merge_ms", "copies",
            "cycle_mb", "max_abs_err") if k in c} for c in kern["cases"]])]
    for name, row in flash["kernels"].items():
        entries.append(dict(
            name=name, route="cuda",
            source="pytorchdistributed_tpu_torch/csrc/flash_attention.cu",
            replaces=FLASH_REPLACES[name], launches=train["launches"][name],
            **row))
    for name, row in hops.items():
        entries.append(dict(
            name=name, route="cuda",
            source="pytorchdistributed_tpu_torch/csrc/flash_attention.cu",
            replaces=RING_REPLACES[name],
            launches=ring_train["launches"][name], library_ms=None,
            library_note=RING_LIBRARY_NOTE, **row))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
