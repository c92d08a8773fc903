"""Flash attention for training: forward and FlashAttention-2 backward.

PyTorch counterpart of the flash half of
``pytorchdistributed_tpu/ops/pallas_attention.py`` (``flash_attention``,
``_flash``, ``_flash_fwd``, ``_flash_bwd``) on ``[B, S, H, D]`` tensors,
with grouped-query attention native: k/v may carry ``H_kv`` heads with
``H % H_kv == 0``, and q head ``h`` reads kv head ``h // (H // H_kv)``.

The forward writes ``O`` and the fp32 row log-sum-exp ``LSE`` (``[B, H,
S]``), the backward's only softmax residual. The backward recomputes
``P = exp(S - LSE)`` block by block and forms ``dS = P * (dO·Vᵀ - Δ) *
scale`` with ``Δ = rowsum(dO * O)`` (the reference leaves Δ to XLA
outside its kernels): on CUDA the dQ kernel forms Δ for its own rows and
writes it for the dK/dV kernel, which launches after it; the plain twin
takes it as a torch op (``_delta``).

Two implementations of each half:

  * three CUDA kernels in ``csrc/flash_attention.cu`` (built with nvcc at
    first use, loaded with ctypes) — what a CUDA tensor gets. They take
    bfloat16 only: a float32 CUDA input is refused with a ``TypeError``
    (there is no non-tensor-core path). ``head_dim`` must be 32, 64 or
    128. The kernels pick their own tiles — the forward 128-row q tiles
    over 64-key K/V tiles; the backward a 64-row CTA side (q rows of dQ,
    keys of dK/dV) over 64-row tiles of the other side — so ``block_q`` /
    ``block_k`` (a VMEM choice on the TPU) do not reach them;
  * ``flash_attention_fwd_plain`` / ``flash_attention_bwd_plain``, the
    same blocked online-softmax recurrence in plain PyTorch, looping over
    ``block_q`` x ``block_k`` blocks — what a CPU tensor gets, and what
    the kernels are held against on the card.

``launches`` counts kernel launches by kernel name (never plain runs), so
a run can show that its attention went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

_NEG_INF = -1e30  # the Pallas kernels' finite -inf: masked rows stay NaN-free
_KERNEL_HEAD_DIMS = (32, 64, 128)

launches = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q, k, v must be [B, S, H, D] with k and v alike; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch, sequence or head_dim")
    if h % k.shape[2]:
        raise ValueError(f"q heads {h} not divisible by kv heads "
                         f"{k.shape[2]}")
    return h // k.shape[2]


def _heads_major(t, group):
    """[B, S, Hx, D] -> [B, Hx*group, S, D]: kv heads repeated so q head
    h sees kv head h // group (plain twin only; the kernels index)."""
    t = t.permute(0, 2, 1, 3)
    return t.repeat_interleave(group, dim=1) if group > 1 else t


def _fwd_blocks(qh, kh, vh, m, lsum, acc, *, causal, scale, bq, bk):
    """The forward kernel's tile loop on heads-major ``[B, H, S, D]``
    operands, folding every k block at or below the diagonal into the fp32
    carry — ``m``, ``lsum`` ``[B, H, S]`` and ``acc`` ``[B, H, S, D]``,
    updated in place. ``_fwd_kernel``'s recurrence, vectorized over batch
    and heads: dots take the inputs' values with fp32 sums, and ``p`` is
    rounded to V's dtype before ``P·V``."""
    s, dev = qh.shape[2], qh.device
    for q0 in range(0, s, bq):
        qs = slice(q0, q0 + bq)
        qb = qh[:, :, qs].float()
        rows = q0 + torch.arange(qb.shape[2], device=dev)
        mb, lb, ab = m[:, :, qs], lsum[:, :, qs], acc[:, :, qs]
        for k0 in range(0, s, bk):
            if causal and q0 + bq - 1 < k0:
                break                      # strictly above the diagonal
            vb = vh[:, :, k0:k0 + bk]
            logits = torch.einsum("bhqd,bhkd->bhqk", qb,
                                  kh[:, :, k0:k0 + bk].float()) * scale
            cols = k0 + torch.arange(logits.shape[-1], device=dev)
            valid = torch.ones(len(rows), len(cols), dtype=torch.bool,
                               device=dev)
            if causal:
                valid = rows[:, None] >= cols[None, :]
            logits = torch.where(valid, logits, _NEG_INF)
            m_new = torch.maximum(mb, logits.amax(dim=-1))
            corr = torch.exp(mb - m_new)
            p = torch.where(valid, torch.exp(logits - m_new[..., None]), 0.0)
            lb = lb * corr + p.sum(dim=-1)
            mb = m_new
            ab = ab * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(vb.dtype).float(), vb.float())
        m[:, :, qs], lsum[:, :, qs], acc[:, :, qs] = mb, lb, ab


def flash_attention_fwd_plain(q, k, v, *, causal: bool = False,
                              scale: float | None = None,
                              block_q: int = 1024, block_k: int = 1024):
    """The forward kernel's function in plain PyTorch: for every q block,
    walk the k blocks with a running (m, l, acc) in fp32 from (-1e30, 0,
    0), skipping blocks strictly above the diagonal under ``causal``
    (``_fwd_blocks``), then normalize.

    Returns ``(O [B, S, H, D] in q's dtype, LSE [B, H, S] fp32)``."""
    group = _check_shapes(q, k, v)
    b, s, h, d = q.shape
    scale = (d ** -0.5) if scale is None else scale
    dev = q.device
    m = torch.full((b, h, s), _NEG_INF, device=dev)
    lsum = torch.zeros(b, h, s, device=dev)
    acc = torch.zeros(b, h, s, d, device=dev)
    _fwd_blocks(_heads_major(q, 1), _heads_major(k, group),
                _heads_major(v, group), m, lsum, acc, causal=causal,
                scale=scale, bq=min(block_q, s), bk=min(block_k, s))
    lsum = lsum.clamp_min(1e-30)
    out = (acc / lsum[..., None]).to(q.dtype)
    return out.permute(0, 2, 1, 3).contiguous(), m + torch.log(lsum)


def _delta(o, do):
    """Δ = rowsum(dO * O) in fp32, ``[B, H, S]`` (the LSE layout)."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _bwd_blocks(qh, kh, vh, doh, lse, delta, dq, dk, dv, *, causal, scale,
                bq, bk):
    """The backward kernels' tile loop on heads-major ``[B, H, S, D]``
    operands (``lse``, ``delta`` ``[B, H, S]``): for every (q block,
    k block) pair at or below the diagonal, rebuild ``P = exp(S - LSE)``
    and ``dS = P * (dO·Vᵀ - Δ) * scale`` (``_recompute_p_ds``) and add
    ``Pᵀ·dO`` to ``dv``, ``dSᵀ·Q`` to ``dk`` and ``dS·K`` to ``dq`` — fp32
    ``[B, H, S, D]`` accumulators updated in place, one per q head — with
    ``p`` and ``dS`` rounded to the inputs' dtype before the dots."""
    s, dev = qh.shape[2], qh.device
    for q0 in range(0, s, bq):
        qs = slice(q0, q0 + bq)
        qb, dob = qh[:, :, qs], doh[:, :, qs]
        rows = q0 + torch.arange(qb.shape[2], device=dev)
        lse_b, delta_b = lse[:, :, qs, None], delta[:, :, qs, None]
        for k0 in range(0, s, bk):
            if causal and q0 + bq - 1 < k0:
                break
            ks = slice(k0, k0 + bk)
            kb, vb = kh[:, :, ks], vh[:, :, ks]
            sblk = torch.einsum("bhqd,bhkd->bhqk", qb.float(),
                                kb.float()) * scale
            cols = k0 + torch.arange(kb.shape[2], device=dev)
            valid = torch.ones(len(rows), len(cols), dtype=torch.bool,
                               device=dev)
            if causal:
                valid = rows[:, None] >= cols[None, :]
            p = torch.where(valid, torch.exp(sblk - lse_b), 0.0)
            dp = torch.einsum("bhqd,bhkd->bhqk", dob.float(), vb.float())
            ds = torch.where(valid, p * (dp - delta_b) * scale, 0.0)
            dv[:, :, ks] += torch.einsum("bhqk,bhqd->bhkd",
                                         p.to(dob.dtype).float(), dob.float())
            dk[:, :, ks] += torch.einsum("bhqk,bhqd->bhkd",
                                         ds.to(qb.dtype).float(), qb.float())
            dq[:, :, qs] += torch.einsum("bhqk,bhkd->bhqd",
                                         ds.to(kb.dtype).float(), kb.float())


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = False,
                              scale: float | None = None,
                              block_q: int = 1024, block_k: int = 1024):
    """The two backward kernels' function in plain PyTorch: ``_bwd_blocks``
    from zero accumulators, then dK/dV summed over each kv head's group of
    q heads.

    Returns ``(dQ like q, dK like k, dV like v)``."""
    group = _check_shapes(q, k, v)
    b, s, h, d = q.shape
    scale = (d ** -0.5) if scale is None else scale
    dev = q.device
    dq, dk, dv = (torch.zeros(b, h, s, d, device=dev) for _ in range(3))
    _bwd_blocks(_heads_major(q, 1), _heads_major(k, group),
                _heads_major(v, group), _heads_major(do, 1), lse,
                _delta(o, do), dq, dk, dv, causal=causal, scale=scale,
                bq=min(block_q, s), bk=min(block_k, s))
    hk = h // group
    dk = dk.view(b, hk, group, s, d).sum(dim=2)
    dv = dv.view(b, hk, group, s, d).sum(dim=2)
    return (dq.permute(0, 2, 1, 3).to(q.dtype).contiguous(),
            dk.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())


# ---------------------------------------------------------------------------
# the CUDA kernels


def _kernel_operand(t):
    """``t`` as the kernels read it: unit last stride, every other stride a
    multiple of 8 elements and a 16-byte aligned base (one 16-byte load per
    8 elements). Views of the fused qkv projection pass as they are; an
    expanded or odd-strided tensor (an autograd ``dO`` of stride 0) is
    copied."""
    if (t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:3])
            or t.data_ptr() % 16):
        t = t.contiguous()
    return t


def _kernel_inputs(*ts):
    """(q, k, v[, dO[, O]]) checked for the kernels and in their
    layout."""
    q = ts[0]
    _check_shapes(*ts[:3])
    for name, t in zip(("dO", "O"), ts[3:]):
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)}")
    for t in ts:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the flash attention kernels take bfloat16 "
                            f"q/k/v/dO/O on CUDA, got {t.dtype} (no "
                            f"float32 kernel path)")
        if t.device != q.device:
            raise ValueError(f"all operands must be on {q.device}; got a "
                             f"tensor on {t.device}")
    if q.shape[-1] not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel head_dim must be 32, 64 or 128, got "
                         f"{q.shape[-1]}")
    return [_kernel_operand(t) for t in ts]


def _strides(*ts):
    vals = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _check(err, name, counts=launches):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    counts[name] += 1


_TYPED: list = []   # the library whose entry points are declared


def _lib():
    from pytorchdistributed_tpu_torch._build import load

    lib = load("flash_attention")
    if _TYPED and _TYPED[0] is lib:
        return lib
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(
        ctypes.c_longlong)
    tail = [ll, i, i, i, i, i, ctypes.c_float, i, vp]
    # the ring's hop entries (ops/ring_attention.py) share the tail
    for fn, pointers in ((lib.ptd_flash_fwd, 5), (lib.ptd_flash_bwd_dkv, 8),
                         (lib.ptd_flash_bwd_dq, 8), (lib.ptd_ring_fwd, 6),
                         (lib.ptd_ring_bwd_dkv, 8), (lib.ptd_ring_bwd_dq, 7)):
        fn.argtypes = [vp] * pointers + tail
        fn.restype = ctypes.c_int
    _TYPED[:] = [lib]
    return lib


def _dims(q, k, scale, causal):
    b, s, h, d = q.shape
    return (b, s, h, k.shape[2], d, ctypes.c_float(scale), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)


def _launch_fwd(q, k, v, causal, scale):
    """The forward kernel: ``(O [B, S, H, D] contiguous, LSE [B, H, S])``."""
    q, k, v = _kernel_inputs(q, k, v)
    lib = _lib()
    b, s, h, _ = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    err = lib.ptd_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), lse.data_ptr(), _strides(q, k, v),
                            *_dims(q, k, scale, causal))
    _check(err, "flash_fwd")
    return o, lse


def _bwd_operands(q, k, v, o, lse, do):
    """The backward kernels' operands ``(q, k, v, dO, O, LSE)``, checked
    and in their layout."""
    q, k, v, do, o = _kernel_inputs(q, k, v, do, o)
    b, s, h, _ = q.shape
    if lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"LSE {tuple(lse.shape)} {lse.dtype} is not the "
                         f"forward's for q {tuple(q.shape)} ([B, H, S] "
                         f"float32)")
    return q, k, v, do, o, lse.contiguous()


def _launch_dq(q, k, v, do, o, lse, causal, scale):
    """The dQ kernel on ``_bwd_operands``: ``(dQ like q, Δ [B, H, S])``,
    Δ formed by the kernel from O and dO."""
    b, s, h, _ = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    err = _lib().ptd_flash_bwd_dq(
        *(t.data_ptr() for t in (q, k, v, do, lse, delta, o)), dq.data_ptr(),
        _strides(q, k, v, do, o), *_dims(q, k, scale, causal))
    _check(err, "flash_bwd_dq")
    return dq, delta


def _launch_dkv(q, k, v, do, lse, delta, causal, scale):
    """The dK/dV kernel on ``_bwd_operands``' q, k, v, dO and LSE, with
    the Δ that ``_launch_dq`` returned: ``(dK, dV)`` like k, v."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    err = _lib().ptd_flash_bwd_dkv(
        *(t.data_ptr() for t in (q, k, v, do, lse, delta)), dk.data_ptr(),
        dv.data_ptr(), _strides(q, k, v, do), *_dims(q, k, scale, causal))
    _check(err, "flash_bwd_dkv")
    return dk, dv


def _launch_bwd(q, k, v, o, lse, do, causal, scale):
    """The two backward kernels, dQ first (it forms Δ, which dK/dV reads):
    ``(dQ, dK, dV)``, each contiguous in its input's layout."""
    q, k, v, do, o, lse = _bwd_operands(q, k, v, o, lse, do)
    dq, delta = _launch_dq(q, k, v, do, o, lse, causal, scale)
    return (dq, *_launch_dkv(q, k, v, do, lse, delta, causal, scale))


def _route(t, what: str = "flash attention") -> bool:
    """True for the kernels (CUDA), False for the plain twins (CPU)."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise RuntimeError(f"{what} runs on CUDA or the CPU, not "
                           f"{t.device}")
    return False


class _FlashAttention(torch.autograd.Function):
    """``_flash``'s custom VJP: forward saves (q, k, v, O, LSE); CUDA
    tensors run the kernels, CPU tensors the plain twins."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k):
        if _route(q):
            o, lse = _launch_fwd(q, k, v, causal, scale)
        else:
            o, lse = flash_attention_fwd_plain(
                q, k, v, causal=causal, scale=scale, block_q=block_q,
                block_k=block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, scale=scale, block_q=block_q,
                        block_k=block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        opts = ctx.opts
        if _route(do):
            grads = _launch_bwd(q, k, v, o, lse, do, opts["causal"],
                                opts["scale"])
        else:
            grads = flash_attention_bwd_plain(q, k, v, o, lse, do, **opts)
        return (*grads, None, None, None, None)


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None, block_q: int = 1024,
                    block_k: int = 1024) -> torch.Tensor:
    """[B, S, H, D] fused flash attention; drop-in for ``dense_attention``
    and differentiable in q, k and v.

    k/v may carry fewer heads than q (``H % H_kv == 0``). A CUDA tensor
    launches the kernels (bfloat16, head_dim 32/64/128, or it raises); a
    CPU tensor runs the plain twins, whose loops ``block_q``/``block_k``
    shape (the kernels choose their own tiles). Returns ``[B, S, H, D]``
    in q's dtype."""
    _check_shapes(q, k, v)
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    return _FlashAttention.apply(q, k, v, causal, float(scale), block_q,
                                 block_k)
