"""Paged decode attention straight over the block pool.

PyTorch counterpart of ``paged_flash_attention`` in
``pytorchdistributed_tpu/ops/pallas_attention.py``. One decode tick's q
(``[slots, heads, head_dim]``) attends each slot's block-table-mapped
K/V pages without first gathering them into a ``[slots, pages *
block_size, ...]`` copy.

Two implementations of one function:

  * the CUDA kernel ``csrc/paged_attention.cu`` (built with nvcc at first
    use, loaded with ctypes) — what a CUDA tensor gets. It splits each
    slot's pages into runs of ``per_split`` pages, one CTA each, and
    merges the runs' partial softmax states in run order; the run length
    comes from the table width and the SM count (``_pages_per_split``),
    never from the lengths, which stay on the device;
  * ``paged_flash_attention_plain``, the same page-by-page online softmax
    in plain PyTorch — what a CPU tensor gets, and what the kernel is
    held against on the card. It never calls ``paged_attention``'s
    gather, so it stays an independent check of the online softmax.
    ``_paged_split_plain`` runs it per run of pages and merges the runs
    as the kernel does, so the CPU tests can hold the split algebra.

``paged_flash_attention.launches`` counts calls that launched the kernel
(one a call, whatever the number of kernels; never plain runs), so a run
can show that its decode ticks went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

_NEG_INF = -1e30  # the Pallas kernel's finite -inf: masked rows stay NaN-free

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _validate(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale,
              sink_tokens, window_tokens):
    slots, h, d = q.shape
    nb, bs, hk, _ = k_pool.shape
    if h % hk:
        raise ValueError(f"q heads {h} not divisible by kv heads {hk}")
    quantized = k_pool.dtype == torch.int8
    if quantized != (k_scale is not None and v_scale is not None):
        raise ValueError(
            "k_scale/v_scale must be provided iff the pool is int8 "
            f"(pool {k_pool.dtype}, k_scale "
            f"{'set' if k_scale is not None else 'None'})")
    if quantized and (tuple(k_scale.shape) != (nb, bs, hk)
                      or tuple(v_scale.shape) != (nb, bs, hk)):
        raise ValueError(
            f"scale planes must be [num_blocks, block_size, kv_heads] = "
            f"{(nb, bs, hk)}; got {tuple(k_scale.shape)} / "
            f"{tuple(v_scale.shape)}")
    if window_tokens < 0 or sink_tokens < 0 or (
            window_tokens and (window_tokens % bs or sink_tokens % bs)):
        raise ValueError(
            f"sink_tokens {sink_tokens} / window_tokens {window_tokens} "
            f"must be non-negative multiples of block_size {bs}")
    if block_tables.shape[0] != slots or lengths.shape != (slots,):
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} / lengths "
            f"{tuple(lengths.shape)} do not match {slots} slots")
    return quantized


def _plain_state(q, k_pool, v_pool, tables, length, k_scale, v_scale,
                 sink_tokens, window_tokens, scale, pages):
    """The Pallas kernel's recurrence over table columns ``pages`` (a
    range), vectorized over slots and kv heads: the running fp32 ``(m,
    l, acc)``, ``[slots, kv_heads, group]`` and ``[..., head_dim]``. A
    page runs iff ``page * block_size <= length`` and, with a window, it
    is not a fully dead middle page; a slot of length 0 runs page 0."""
    slots, h, d = q.shape
    _, bs, hk, _ = k_pool.shape
    group = h // hk
    dev = q.device
    qf = q.reshape(slots, hk, group, d).float()
    m = torch.full((slots, hk, group), _NEG_INF, device=dev)
    lsum = torch.zeros((slots, hk, group), device=dev)
    acc = torch.zeros((slots, hk, group, d), device=dev)
    offs = torch.arange(bs, device=dev)
    for j in pages:
        run = j * bs <= length                                  # [slots]
        if window_tokens:
            dead = (j * bs >= sink_tokens) & (
                (j + 1) * bs <= length - window_tokens + 1)
            run &= ~dead
        blk = tables[:, j]
        k = k_pool[blk]                                   # [slots, bs, hk, d]
        v = v_pool[blk]
        if k_scale is not None:
            k = (k.float() * k_scale[blk][..., None]).to(q.dtype)
            v = (v.float() * v_scale[blk][..., None]).to(q.dtype)
        logits = torch.einsum("sngd,stnd->sngt", qf, k.float()) * scale
        pos = j * bs + offs                                        # [bs]
        valid = pos[None, :] <= length[:, None]                # [slots, bs]
        if window_tokens:
            valid &= ((pos[None, :] < sink_tokens)
                      | (pos[None, :] > (length - window_tokens)[:, None]))
        valid &= run[:, None]
        vmask = valid[:, None, None, :]
        logits = logits.masked_fill(~vmask, _NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.where(vmask, torch.exp(logits - m_new[..., None]), 0.0)
        lsum = lsum * corr + p.sum(dim=-1)
        m = m_new
        # the kernel's PV dot: probabilities cast to V's dtype, fp32 sum
        acc = acc * corr[..., None] + torch.einsum(
            "sngt,stnd->sngd", p.to(v.dtype).float(), v.float())
    return m, lsum, acc


def paged_flash_attention_plain(q, k_pool, v_pool, block_tables, lengths,
                                *, k_scale=None, v_scale=None,
                                sink_tokens: int = 0,
                                window_tokens: int = 0,
                                scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: for every (slot, kv head)
    walk the table page by page with a running (m, l, acc) in fp32 — the
    Pallas kernel's recurrence, vectorized over slots and kv heads."""
    _validate(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale,
              sink_tokens, window_tokens)
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    _, lsum, acc = _plain_state(
        q, k_pool, v_pool, block_tables.long(), lengths.long(), k_scale,
        v_scale, sink_tokens, window_tokens, scale,
        range(block_tables.shape[1]))
    out = acc / lsum.clamp_min(1e-30)[..., None]
    return out.to(q.dtype).reshape(q.shape)


def _paged_split_plain(q, k_pool, v_pool, block_tables, lengths, *,
                       pages_per_split: int, k_scale=None, v_scale=None,
                       sink_tokens: int = 0, window_tokens: int = 0,
                       scale: float | None = None) -> torch.Tensor:
    """The kernel's split algebra in plain PyTorch: the recurrence run
    afresh over each run of ``pages_per_split`` table columns — a run
    that starts past a slot's length stays empty, ``l = 0`` — then the
    runs folded by the log-sum-exp rule in run order, in one pass, as
    ``paged_merge_kernel`` does. Equals ``paged_flash_attention_plain``
    up to fp32 rounding."""
    _validate(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale,
              sink_tokens, window_tokens)
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    pages = block_tables.shape[1]
    tables, length = block_tables.long(), lengths.long()
    mx = lsum = acc = None
    for j in range(0, pages, pages_per_split):
        m, ls, a = _plain_state(q, k_pool, v_pool, tables, length, k_scale,
                                v_scale, sink_tokens, window_tokens, scale,
                                range(j, min(j + pages_per_split, pages)))
        if mx is None:
            mx, lsum, acc = m, ls, a
            continue
        mn = torch.maximum(mx, m)
        f, g = torch.exp(mx - mn), torch.exp(m - mn)
        lsum = lsum * f + ls * g
        acc = acc * f[..., None] + torch.where(
            (ls > 0)[..., None], a * g[..., None], 0.0)
        mx = mn
    out = acc / lsum.clamp_min(1e-30)[..., None]
    return out.to(q.dtype).reshape(q.shape)


_ROWS_PER_CTA = (1, 4, 8)  # the kernel's instantiations of G
_CTAS_PER_SM = 8           # runs aim at this many CTAs an SM
_MIN_PAGES_PER_SPLIT = 8   # two pages for each of a CTA's 4 warps


def _rows_per_cta(group: int) -> int:
    """q rows of the GQA group one CTA holds: the group itself, rounded
    up to 1, 4 or 8; a larger group takes several CTAs of 8."""
    return next((r for r in _ROWS_PER_CTA if r >= group), _ROWS_PER_CTA[-1])


def _pages_per_split(pages: int, ctas_per_split: int, sms: int) -> int:
    """Pages a CTA takes, from the table width, the CTAs that one run
    of pages gives (slots x kv heads x group tiles) and the SM count:
    enough runs for ``_CTAS_PER_SM`` CTAs an SM were every slot at full
    width, with at least ``_MIN_PAGES_PER_SPLIT`` pages each (8 at the
    H100 shapes chip_smoke times, the fastest there). The lengths are
    not read: they stay on the device."""
    splits = min(-(-_CTAS_PER_SM * sms // ctas_per_split),
                 -(-pages // _MIN_PAGES_PER_SPLIT))
    return -(-pages // max(1, splits))


def _default_pages_per_split(q, k_pool, block_tables) -> int:
    """The run length the wrapper launches with for these operands."""
    slots, h, _ = q.shape
    group = h // k_pool.shape[2]
    tiles = -(-group // _rows_per_cta(group))
    return _pages_per_split(block_tables.shape[1],
                            slots * k_pool.shape[2] * tiles,
                            _sm_count(q.device))


_TYPED: list = []   # the library whose entry point is declared
_SMS: dict = {}     # device index -> SM count, queried once


def _lib():
    from pytorchdistributed_tpu_torch._build import load

    lib = load("paged_attention")
    if _TYPED and _TYPED[0] is lib:
        return lib
    vp, i = ctypes.c_void_p, ctypes.c_int
    # 10 pointers; slots, heads, kv_heads, head_dim, block_size, pages,
    # table_stride, per_split, rows, sink, window; scale; q dtype code,
    # int8 flag; stream
    fn = lib.ptd_paged_attention
    fn.argtypes = [vp] * 10 + [i] * 11 + [ctypes.c_float, i, i, vp]
    fn.restype = i
    _TYPED[:] = [lib]
    return lib


def _sm_count(device: torch.device) -> int:
    idx = (torch.cuda.current_device() if device.index is None
           else device.index)
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _launch(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale,
            sink_tokens, window_tokens, scale, pages_per_split=None):
    slots, h, d = q.shape
    _, bs, hk, _ = k_pool.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged attention kernel takes float32/bfloat16 q, "
                        f"got {q.dtype}")
    if k_pool.dtype != torch.int8 and k_pool.dtype != q.dtype:
        raise TypeError(f"pool dtype {k_pool.dtype} must be int8 or q's "
                        f"dtype {q.dtype}")
    if d not in (32, 64, 128):
        raise ValueError(f"kernel head_dim must be 32, 64 or 128, got {d}")
    tensors = [q, k_pool, v_pool, block_tables, lengths]
    if k_scale is not None:
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all operands must be on {q.device}; got a "
                             f"tensor on {t.device}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k_pool, v_pool)):
        raise ValueError("q and both pools must be contiguous and 16-byte "
                         "aligned (the kernel reads 16 bytes a lane)")
    if block_tables.dtype != torch.int32 or block_tables.stride(1) != 1:
        raise ValueError("block_tables must be int32 with unit column "
                         "stride")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous int32 vector")
    if k_scale is not None and not (
            k_scale.dtype == v_scale.dtype == torch.float32
            and k_scale.is_contiguous() and v_scale.is_contiguous()):
        raise ValueError("scale planes must be contiguous float32")
    fn = _lib().ptd_paged_attention
    pages = block_tables.shape[1]
    if pages_per_split is None:
        pages_per_split = _default_pages_per_split(q, k_pool, block_tables)
    if pages_per_split < 1:
        raise ValueError(f"pages_per_split must be >= 1, got "
                         f"{pages_per_split}")
    out = torch.empty_like(q)
    ml = acc = None
    rows = slots * h * -(-pages // pages_per_split)   # (slot, head, split)
    if rows > slots * h:   # more than one run: the partials (m, l), acc
        ml, acc = torch.empty(rows * (2 + d), device=q.device).split(
            [2 * rows, d * rows])
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             k_scale.data_ptr() if k_scale is not None else None,
             v_scale.data_ptr() if v_scale is not None else None,
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             ml.data_ptr() if ml is not None else None,
             acc.data_ptr() if acc is not None else None,
             slots, h, hk, d, bs, pages, block_tables.stride(0),
             pages_per_split, _rows_per_cta(h // hk), int(sink_tokens),
             int(window_tokens),
             float(scale), _DTYPE_CODES[q.dtype],
             int(k_pool.dtype == torch.int8),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_flash_attention.launches += 1
    return out


def paged_flash_attention(q, k_pool, v_pool, block_tables, lengths, *,
                          k_scale=None, v_scale=None,
                          sink_tokens: int = 0, window_tokens: int = 0,
                          scale: float | None = None) -> torch.Tensor:
    """One decode tick of paged attention, pool-native.

    Args:
      q: ``[slots, heads, head_dim]`` — each slot's current-token query
        (its K/V already written into the pool).
      k_pool / v_pool: ``[num_blocks, block_size, kv_heads, head_dim]``,
        q's dtype or int8.
      block_tables: ``[slots, pages]`` int32 physical block ids (entries
        past a slot's live length, and retired window pages, point at the
        trash block 0).
      lengths: ``[slots]`` int32 — the query attends positions <= length.
      k_scale / v_scale: ``[num_blocks, block_size, kv_heads]`` fp32
        dequant scales; required iff the pool is int8.
      sink_tokens / window_tokens: position j is attendable iff ``j <
        sink_tokens or j > length - window_tokens`` (0 = full attention);
        both are multiples of block_size.
      scale: defaults to ``head_dim ** -0.5``.

    Returns ``[slots, heads, head_dim]`` in q's dtype. A CUDA tensor
    launches the kernel (or raises); a CPU tensor runs the plain twin."""
    if q.is_cuda:
        _validate(q, k_pool, v_pool, block_tables, lengths, k_scale,
                  v_scale, sink_tokens, window_tokens)
        scale = (q.shape[-1] ** -0.5) if scale is None else scale
        return _launch(q, k_pool, v_pool, block_tables, lengths, k_scale,
                       v_scale, sink_tokens, window_tokens, scale)
    if q.device.type != "cpu":
        raise RuntimeError(f"paged attention runs on CUDA or the CPU, not "
                           f"{q.device}")
    return paged_flash_attention_plain(
        q, k_pool, v_pool, block_tables, lengths, k_scale=k_scale,
        v_scale=v_scale, sink_tokens=sink_tokens,
        window_tokens=window_tokens, scale=scale)


paged_flash_attention.launches = 0
