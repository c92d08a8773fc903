"""Parity of the port's paged decode attention with the JAX reference.

The port's ``paged_flash_attention`` on a CPU tensor runs its plain
PyTorch twin (the page-by-page online softmax the CUDA kernel computes);
it is held here against two JAX references on the same numpy inputs:
``ops.attention.paged_attention`` (the gather oracle) and the Pallas
``paged_flash_attention`` in interpret mode. fp32 throughout, at the
reference suite's own tolerance (atol = rtol = 2e-5, tests/test_paging.py:
the online softmax reassociates the reduction, so it is not bitwise).
The kernel's split algebra — the recurrence run afresh over each run of
pages, the runs merged by the log-sum-exp rule in run order — is held
here too, through its plain helper ``_paged_split_plain``, over run
lengths 1, 2, 3 and the whole table. The CUDA kernel itself is held
against the plain twin on the card (``test_kernel_matches_plain_on_cuda``
and ``test_kernel_splits_on_cuda``; skipped without a GPU).
"""

import functools

import numpy as np
import pytest
import torch

from pytorchdistributed_tpu_torch.ops.attention import paged_attention
from pytorchdistributed_tpu_torch.ops.paged_attention import (
    _launch,
    _paged_split_plain,
    paged_flash_attention,
    paged_flash_attention_plain,
)
from pytorchdistributed_tpu_torch.ops.quant import kv_quantize

TOL = dict(atol=2e-5, rtol=2e-5)


def _jax():
    """The JAX references, imported here rather than at module level so
    the CUDA case below also collects on a machine without JAX."""
    import jax.numpy as jnp
    from pytorchdistributed_tpu.ops.attention import paged_attention
    from pytorchdistributed_tpu.ops.pallas_attention import (
        paged_flash_attention,
    )
    from pytorchdistributed_tpu.ops.quant import kv_quantize

    return jnp, paged_attention, paged_flash_attention, kv_quantize


def _fixture(lengths, *, bs=8, heads=4, kvh=2, d=16, seed=0):
    """A pool + tables whose gathered content is one dense cache per slot
    (the reference suite's ``_paged_fixture``), as numpy arrays."""
    rng = np.random.default_rng(seed)
    slots, mb = len(lengths), 8
    k_rows = rng.normal(size=(slots, mb * bs, kvh, d)).astype(np.float32)
    v_rows = rng.normal(size=(slots, mb * bs, kvh, d)).astype(np.float32)
    pool_k = np.zeros((slots * mb + 1, bs, kvh, d), np.float32)
    pool_v = np.zeros_like(pool_k)
    tables = np.zeros((slots, mb), np.int32)
    nxt = 1
    for s in range(slots):
        for j in range(mb):
            pool_k[nxt] = k_rows[s, j * bs:(j + 1) * bs]
            pool_v[nxt] = v_rows[s, j * bs:(j + 1) * bs]
            tables[s, j] = nxt
            nxt += 1
    q = rng.normal(size=(slots, heads, d)).astype(np.float32)
    return q, pool_k, pool_v, tables, np.asarray(lengths, np.int32)


def _both(q, pk, pv, tables, lengths, ks=None, vs=None, **kw):
    """(port kernel twin, JAX gather oracle, JAX Pallas interpret) as
    numpy ``[slots, heads, d]``."""
    def t(a):
        return torch.from_numpy(np.array(a))

    port = paged_flash_attention(
        t(q), t(pk), t(pv), t(tables), t(lengths),
        k_scale=None if ks is None else t(ks),
        v_scale=None if vs is None else t(vs), **kw).numpy()
    jnp, jax_paged_attention, jax_paged_flash, _ = _jax()
    j = jnp.asarray
    jk = dict(k_scale=None if ks is None else j(ks),
              v_scale=None if vs is None else j(vs), **kw)
    ref = np.asarray(jax_paged_attention(j(q)[:, None], j(pk), j(pv),
                                         j(tables), j(lengths), **jk))[:, 0]
    pallas = np.asarray(jax_paged_flash(j(q), j(pk), j(pv), j(tables),
                                        j(lengths), **jk))
    return port, ref, pallas


@pytest.mark.parametrize("lengths", [
    (5, 17, 40, 64),       # mixed ragged
    (1, 7, 9, 23),         # every length off the block grid
    (8, 15, 16, 63),       # exact boundary and last rows of blocks
])
def test_plain_matches_jax_references(lengths):
    """GQA (4 q heads over kvh=2) at the reference suite's length sets."""
    port, ref, pallas = _both(*_fixture(lengths, kvh=2))
    np.testing.assert_allclose(port, ref, **TOL)
    np.testing.assert_allclose(port, pallas, **TOL)


def test_plain_mha_and_gather_oracle_match():
    """kvh == heads, and the port's own gather oracle (ops/attention.py)
    against the JAX one on the same pool."""
    q, pk, pv, tbl, lens = _fixture((3, 20, 41), kvh=4)
    port, ref, pallas = _both(q, pk, pv, tbl, lens)
    np.testing.assert_allclose(port, ref, **TOL)
    np.testing.assert_allclose(port, pallas, **TOL)
    t = torch.from_numpy
    oracle = paged_attention(t(q)[:, None], t(pk), t(pv), t(tbl),
                             t(lens)).numpy()[:, 0]
    np.testing.assert_allclose(oracle, ref, **TOL)


def test_int8_pool_matches_jax():
    """Pool quantized by the JAX ``kv_quantize`` and converted: the port
    dequantizes with the same spelling, and its own ``kv_quantize``
    produces the same codes and scales."""
    jnp, _, _, jax_kv_quantize = _jax()
    q, pk, pv, tbl, lens = _fixture((5, 17, 40, 63), kvh=2)
    kc, ks = (np.asarray(a) for a in jax_kv_quantize(jnp.asarray(pk)))
    vc, vs = (np.asarray(a) for a in jax_kv_quantize(jnp.asarray(pv)))
    assert kc.dtype == np.int8 and ks.dtype == np.float32
    port, ref, pallas = _both(q, kc, vc, tbl, lens, ks, vs)
    np.testing.assert_allclose(port, ref, **TOL)
    np.testing.assert_allclose(port, pallas, **TOL)
    tk, tks = kv_quantize(torch.from_numpy(pk))
    np.testing.assert_array_equal(tk.numpy(), kc)
    np.testing.assert_array_equal(tks.numpy(), ks)


def test_sink_window_matches_jax_and_skips_dead_pages():
    """Sink 8 + window 16: only those positions contribute, and a fully
    dead middle page is never read (poisoning it changes nothing)."""
    lengths = (40, 64, 23)
    q, pk, pv, tbl, lens = _fixture(lengths, kvh=2)
    kw = dict(sink_tokens=8, window_tokens=16)
    port, ref, pallas = _both(q, pk, pv, tbl, lens, **kw)
    np.testing.assert_allclose(port, ref, **TOL)
    np.testing.assert_allclose(port, pallas, **TOL)
    full, _, _ = _both(q, pk, pv, tbl, lens)
    assert not np.allclose(full, port, atol=1e-3)  # the mask is real
    bs = pk.shape[1]
    tbl2 = tbl.copy()
    for s, n in enumerate(lengths):
        for bi in range(tbl2.shape[1]):
            if bi * bs >= 8 and (bi + 1) * bs <= n - 16 + 1:
                tbl2[s, bi] = 0  # retire: point at trash
    pk2, pv2 = pk.copy(), pv.copy()
    pk2[0], pv2[0] = 1e6, -1e6
    port2, _, _ = _both(q, pk2, pv2, tbl2, lens, **kw)
    np.testing.assert_allclose(port2, port, **TOL)


def test_dead_slot_length_zero_is_finite():
    """A slot of length 0 still runs page 0 (position 0 attended) and
    gives a finite row equal to the references'."""
    port, ref, pallas = _both(*_fixture((0, 9, 0, 33), kvh=2))
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, ref, **TOL)
    np.testing.assert_allclose(port, pallas, **TOL)


def test_validation_errors():
    q, pk, pv, tbl, lens = (torch.from_numpy(a)
                            for a in _fixture((3, 4), kvh=2))
    with pytest.raises(ValueError, match="iff the pool is int8"):
        paged_flash_attention(q, pk, pv, tbl, lens,
                              k_scale=torch.ones(pk.shape[:3]),
                              v_scale=torch.ones(pk.shape[:3]))
    with pytest.raises(ValueError, match="multiples of block_size"):
        paged_flash_attention(q, pk, pv, tbl, lens, window_tokens=12)
    with pytest.raises(ValueError, match="not divisible"):
        paged_flash_attention(q[:, :3], pk, pv, tbl, lens)


# the split helper's cases: (lengths, fixture and call keywords); the
# fixture's table is 8 pages of 8 rows
SPLIT_CASES = {
    "ragged": ((5, 17, 40, 64), {}),
    "off_grid": ((1, 7, 9, 23), {}),
    "boundary": ((8, 15, 16, 63), {}),
    # sink 8 + window 16: at length 64 pages 1-5 are dead, so runs of 1,
    # 2 or 3 pages lie wholly among them
    "window": ((40, 64, 23), dict(sink_tokens=8, window_tokens=16)),
    "dead_slot": ((0, 9, 0, 33), {}),
    "gqa4": ((5, 17, 40, 63), dict(kvh=1)),
    "mha": ((3, 20, 41), dict(kvh=4)),
    "int8": ((5, 17, 40, 63), dict(int8=True)),
}


@functools.lru_cache(maxsize=None)
def _split_case(name):
    """(inputs, call keywords, JAX gather oracle, JAX Pallas interpret)
    for one ``SPLIT_CASES`` entry, computed once per case."""
    lengths, kw = SPLIT_CASES[name]
    kw = dict(kw)
    kvh, int8 = kw.pop("kvh", 2), kw.pop("int8", False)
    q, pk, pv, tbl, lens = _fixture(lengths, kvh=kvh)
    ks = vs = None
    if int8:
        jnp, _, _, jax_kv_quantize = _jax()
        pk, ks = (np.asarray(a) for a in jax_kv_quantize(jnp.asarray(pk)))
        pv, vs = (np.asarray(a) for a in jax_kv_quantize(jnp.asarray(pv)))
    _, ref, pallas = _both(q, pk, pv, tbl, lens, ks, vs, **kw)
    return (q, pk, pv, tbl, lens, ks, vs), kw, ref, pallas


@pytest.mark.parametrize("pages_per_split", [1, 2, 3, 8])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_merge_matches_jax(case, pages_per_split):
    """The kernel's split algebra: runs of ``pages_per_split`` pages (8 is
    the whole table: one run, no merge), each run's fp32 (m, l, acc)
    merged in run order over the slot's live runs, against the JAX
    gather oracle and the Pallas kernel in interpret mode."""
    (q, pk, pv, tbl, lens, ks, vs), kw, ref, pallas = _split_case(case)

    def t(a):
        return None if a is None else torch.from_numpy(np.array(a))

    got = _paged_split_plain(t(q), t(pk), t(pv), t(tbl), t(lens),
                             pages_per_split=pages_per_split, k_scale=t(ks),
                             v_scale=t(vs), **kw).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


# the card's cases: (q dtype, pool, head_dim, q heads, kv heads, lengths,
# table pages, call keywords)
CUDA_CASES = {
    "bf16": ("bf16", "same", 64, 4, 2, None, 8, {}),
    "int8": ("bf16", "int8", 64, 4, 2, None, 8, {}),
    "window": ("bf16", "same", 64, 4, 2, None, 8,
               dict(sink_tokens=8, window_tokens=16)),
    "gqa4": ("bf16", "same", 64, 4, 1, None, 8, {}),
    "d32": ("bf16", "same", 32, 4, 2, None, 8, {}),
    "d128": ("bf16", "same", 128, 4, 2, None, 8, {}),
    "fp32": ("fp32", "same", 64, 4, 2, None, 8, {}),
    "fp32_int8_d128": ("fp32", "int8", 128, 4, 2, None, 8, {}),
    "gqa8": ("bf16", "same", 64, 16, 2, None, 8, {}),
    "gqa16_two_tiles": ("bf16", "same", 64, 16, 1, None, 8, {}),
    # one slot at the full width of a 64-page table
    "one_slot_full": ("bf16", "same", 64, 12, 12, (511,), 64, {}),
    # a table four times wider than the live pages
    "wide_table": ("bf16", "same", 64, 4, 2, (0, 9, 40, 127), 32, {}),
}
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _cuda_inputs(name, dev):
    qd, pool, d, heads, kvh, lengths, mb, kw = CUDA_CASES[name]
    lengths = lengths or (0, 1, 8, 17, 40, 63)
    q, pk, pv, tbl, lens = _fixture(lengths, kvh=kvh, heads=heads, d=d)
    if mb != tbl.shape[1]:   # widen or narrow the table, live pages first
        rng = np.random.default_rng(1)
        nb = len(lengths) * mb + 1
        pk = rng.normal(size=(nb, *pk.shape[1:])).astype(np.float32)
        pv = rng.normal(size=(nb, *pv.shape[1:])).astype(np.float32)
        tbl = (rng.permutation(nb - 1)[:len(lengths) * mb] + 1).reshape(
            len(lengths), mb).astype(np.int32)
    dt = DTYPES[qd]
    q, pk, pv = (torch.from_numpy(a).to(dev, dt) for a in (q, pk, pv))
    kw = dict(kw)
    if pool == "int8":
        pk, ks = kv_quantize(pk)
        pv, vs = kv_quantize(pv)
        kw.update(k_scale=ks.contiguous(), v_scale=vs.contiguous())
    return (q, pk, pv, torch.from_numpy(tbl).to(dev),
            torch.from_numpy(lens).to(dev)), kw


def _hold(got, want):
    """bf16: outputs round to bf16 (2^-8 relative); fp32: the sums run in
    another order than the plain twin's."""
    tol = 1e-2 if got.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(CUDA_CASES))
def test_kernel_matches_plain_on_cuda(cuda_device, variant):
    """The CUDA kernel against its plain twin on the card, with the run
    length the wrapper picks; one launch counted a call."""
    args, kw = _cuda_inputs(variant, cuda_device)
    n0 = paged_flash_attention.launches
    got = paged_flash_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_flash_attention.launches == n0 + 1
    assert bool(torch.isfinite(got).all())
    _hold(got, paged_flash_attention_plain(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("pages_per_split", [1, 3, 64])
@pytest.mark.parametrize("variant", ["one_slot_full", "int8", "window"])
def test_kernel_splits_on_cuda(cuda_device, variant, pages_per_split):
    """Runs of 1, 3 and 64 pages (64 covers every table: one run, the
    output written directly): each matches the plain twin, and two
    launches give bitwise-equal output."""
    (q, pk, pv, tbl, lens), kw = _cuda_inputs(variant, cuda_device)
    run = functools.partial(
        _launch, q, pk, pv, tbl, lens, kw.get("k_scale"), kw.get("v_scale"),
        kw.get("sink_tokens", 0), kw.get("window_tokens", 0),
        q.shape[-1] ** -0.5, pages_per_split=pages_per_split)
    got, again = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _hold(got, paged_flash_attention_plain(q, pk, pv, tbl, lens, **kw))
