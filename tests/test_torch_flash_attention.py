"""Parity of the port's flash attention with the JAX reference.

The port's ``flash_attention`` on CPU tensors runs its plain PyTorch
twins (the blocked online-softmax forward and the FlashAttention-2
backward the CUDA kernels compute). It is held here against the JAX
package's Pallas ``flash_attention`` in interpret mode on the same numpy
inputs, both at ``block_q = block_k = 16``: the output and all three
gradients, causal and not, grouped-query (8 q heads over 2 kv heads), a
ragged ``S = 37`` and an autograd ``dO`` of stride 0; the forward, its
LSE and the three gradients also at unequal blocks (32, 16) and (16,
32). fp32 runs at the
reference suite's own tolerance (atol 2e-5, tests/test_attention.py).

The CUDA kernels are held against the plain twins on the card by the
``*_cuda`` cases (skipped without a GPU):

    python -m pytest --noconftest tests/test_torch_flash_attention.py -k cuda
"""

import numpy as np
import pytest
import torch

from pytorchdistributed_tpu_torch.ops import flash_attention as fa
from pytorchdistributed_tpu_torch.ops.attention import dense_attention
from pytorchdistributed_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_fwd_plain,
)

ATOL = 2e-5
BLK = dict(block_q=16, block_k=16)


def _jax():
    """The JAX reference, imported here rather than at module level so the
    CUDA cases also collect on a machine without JAX."""
    import jax
    import jax.numpy as jnp
    from pytorchdistributed_tpu.ops.pallas_attention import (
        _flash_fwd,
        flash_attention,
    )

    return jax, jnp, flash_attention, _flash_fwd


def _inputs(b=2, s=64, h=8, hk=8, d=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    do = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v, do


def _jax_fwd_grads(q, k, v, do, causal, dtype=None):
    """JAX Pallas (interpret mode) output and grads of sum(out * do)."""
    jax, jnp, jax_flash, _ = _jax()
    dtype = dtype or jnp.float32
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]

    def loss(q, k, v):
        out = jax_flash(q, k, v, causal=causal, **BLK)
        return (out.astype(jnp.float32) * jnp.asarray(do)).sum(), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(*args)
    return [np.asarray(jnp.asarray(a, jnp.float32)) for a in (out, *grads)]


def _port_fwd_grads(q, k, v, do, causal, dtype=torch.float32):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*ts, causal=causal, **BLK)
    (out.float() * torch.from_numpy(do)).sum().backward()
    return [t.detach().float().numpy() for t in (out, *[x.grad for x in ts])]


def _assert_close(got, want, atol=ATOL, rtol=0.0):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_matches_jax_flash(causal):
    q, k, v, do = _inputs()
    _assert_close(_port_fwd_grads(q, k, v, do, causal),
                  _jax_fwd_grads(q, k, v, do, causal))


@pytest.mark.parametrize("causal", [False, True])
def test_grouped_query_matches_jax_flash(causal):
    """8 q heads over 2 kv heads: dK/dV sum over each group."""
    q, k, v, do = _inputs(h=8, hk=2, seed=7)
    _assert_close(_port_fwd_grads(q, k, v, do, causal),
                  _jax_fwd_grads(q, k, v, do, causal))


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_seq_matches_jax_flash(causal):
    """S = 37: the last block is partial in every loop."""
    q, k, v, do = _inputs(s=37, h=4, hk=4, d=16, seed=3)
    _assert_close(_port_fwd_grads(q, k, v, do, causal),
                  _jax_fwd_grads(q, k, v, do, causal))


def test_lse_matches_jax_flash_fwd():
    """The forward's second output, the fp32 row LSE, against the Pallas
    ``_flash_fwd``'s ``[B·H, S, 1]`` LSE (GQA, causal, ragged)."""
    jax, jnp, _, jax_flash_fwd = _jax()
    q, k, v, _ = _inputs(s=37, h=8, hk=2, d=16, seed=5)
    b, s, h, d = q.shape

    def fold(a):
        return jnp.asarray(a).transpose(0, 2, 1, 3).reshape(-1, s, d)

    _, jlse = jax_flash_fwd(fold(q), fold(k), fold(v), causal=True,
                            scale=d ** -0.5, interpret=True, **BLK)
    _, lse = flash_attention_fwd_plain(*map(torch.from_numpy, (q, k, v)),
                                       causal=True, **BLK)
    np.testing.assert_allclose(lse.numpy().reshape(b * h, s),
                               np.asarray(jlse)[..., 0], atol=ATOL, rtol=0)


@pytest.mark.parametrize("block_q,block_k", [(32, 16), (16, 32)])
def test_unequal_blocks_match_jax_flash(block_q, block_k):
    """q and k blocks of different sizes, as the forward kernel tiles (q
    tiles twice its K/V tiles): under causal a q block then meets two
    partly masked k blocks, or a k block two q blocks. The output and the
    LSE against the Pallas ``flash_attention`` / ``_flash_fwd`` on the
    same blocks (GQA 8 q over 2 kv heads, ragged S = 37)."""
    jax, jnp, jax_flash, jax_flash_fwd = _jax()
    q, k, v, _ = _inputs(s=37, h=8, hk=2, d=16, seed=19)
    b, s, h, d = q.shape
    blk = dict(block_q=block_q, block_k=block_k)

    def fold(a):
        return jnp.asarray(a).transpose(0, 2, 1, 3).reshape(-1, s, d)

    jout = jax_flash(*map(jnp.asarray, (q, k, v)), causal=True, **blk)
    _, jlse = jax_flash_fwd(fold(q), fold(k), fold(v), causal=True,
                            scale=d ** -0.5, interpret=True, **blk)
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    out = flash_attention(*ts, causal=True, **blk)
    _, lse = flash_attention_fwd_plain(*ts, causal=True, **blk)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy().reshape(b * h, s),
                               np.asarray(jlse)[..., 0], atol=ATOL, rtol=0)


@pytest.mark.parametrize("block_q,block_k", [(32, 16), (16, 32)])
def test_unequal_blocks_grads_match_jax_flash(block_q, block_k):
    """The backward at unequal q and k blocks, as the backward kernels may
    tile (a CTA side and a streamed tile of different sizes): under causal
    a q block meets two partly masked k blocks, or a k block two q blocks.
    dQ, dK and dV against ``jax.grad`` of the Pallas ``flash_attention``
    on the same blocks (GQA 8 q over 2 kv heads, ragged S = 37)."""
    jax, jnp, jax_flash, _ = _jax()
    q, k, v, do = _inputs(s=37, h=8, hk=2, d=16, seed=23)
    blk = dict(block_q=block_q, block_k=block_k)

    def loss(*a):
        return (jax_flash(*a, causal=True, **blk) * jnp.asarray(do)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (flash_attention(*ts, causal=True, **blk)
     * torch.from_numpy(do)).sum().backward()
    for name, t, w in zip(("dq", "dk", "dv"), ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0, err_msg=name)


def test_stride_zero_dout_matches_jax():
    """``out.sum().backward()`` hands the backward an expanded dO whose
    strides are all 0."""
    jax, jnp, jax_flash, _ = _jax()
    q, k, v, _ = _inputs(s=37, h=8, hk=2, seed=11)
    grads = jax.grad(lambda *a: jax_flash(*a, causal=True, **BLK).sum(),
                     argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*ts, causal=True, **BLK)
    seen = []
    out.register_hook(lambda g: seen.append(g.stride()))
    out.sum().backward()
    assert seen and set(seen[0]) == {0}
    for t, want in zip(ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)


def test_bf16_matches_jax_flash():
    """bf16 inputs: both sides dot bf16 values with fp32 sums and round
    p and dS to bf16 at the same places, but sum in different orders,
    so a result may land one bf16 rounding step (2^-8 relative) apart:
    atol = rtol = 1e-2."""
    import ml_dtypes

    q, k, v, do = _inputs(s=40, h=8, hk=2, seed=13)
    q, k, v = (a.astype(ml_dtypes.bfloat16).astype(np.float32)
               for a in (q, k, v))
    _, jnp, _, _ = _jax()
    _assert_close(_port_fwd_grads(q, k, v, do, True, torch.bfloat16),
                  _jax_fwd_grads(q, k, v, do, True, jnp.bfloat16),
                  atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_twins_match_dense_attention(causal):
    """The plain twins called directly (blocks 16 and the default 1024)
    against the port's own dense oracle and its autograd grads."""
    q, k, v, do = map(torch.from_numpy, _inputs(s=37, h=8, hk=2, seed=17))
    rep = q.shape[2] // k.shape[2]
    qd, kd, vd = (t.clone().requires_grad_() for t in (q, k, v))
    ref = dense_attention(qd, kd.repeat_interleave(rep, 2),
                          vd.repeat_interleave(rep, 2), causal=causal)
    ref.backward(do)
    for blk in (16, 1024):
        kw = dict(causal=causal, block_q=blk, block_k=blk)
        o, lse = flash_attention_fwd_plain(q, k, v, **kw)
        assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
        np.testing.assert_allclose(o.numpy(), ref.detach().numpy(),
                                   atol=ATOL, rtol=0)
        for got, want in zip(flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                       **kw),
                             (qd.grad, kd.grad, vd.grad)):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       atol=ATOL, rtol=0)


def test_validation_errors():
    q = torch.zeros(1, 8, 6, 16)
    with pytest.raises(ValueError, match="not divisible"):
        flash_attention(q, torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 4, 16))
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(q, torch.zeros(1, 9, 6, 16), torch.zeros(1, 9, 6, 16))


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain twin


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _cuda_case(dev, variant):
    """(q, k, v, dO, causal) bf16 on the card; "fused" takes q/k/v as the
    strided views of one [B, S, 3, H, D] projection output. The forward
    takes 128-row q tiles and 64-key K/V tiles, the backward 64-row CTA
    sides over streamed 64-row tiles: "s64" and "s96" are less than one
    q tile, "s200" ends in a ragged diagonal, "s5" is shorter than one
    16-row chunk, and in "gqa4" and "gqa4_full" the dK/dV kernel's walk
    crosses four q heads at a ragged S."""
    b, s, h, hk, d, causal = {
        "causal": (2, 256, 4, 4, 64, True),
        "full": (2, 256, 4, 4, 64, False),
        "gqa": (1, 192, 8, 2, 128, True),
        "ragged": (2, 100, 4, 4, 32, False),
        "fused": (2, 130, 4, 4, 64, True),
        "s64": (2, 64, 4, 4, 64, True),
        "s96": (2, 96, 4, 4, 64, True),
        "s200": (2, 200, 4, 4, 64, True),
        "d32": (2, 512, 4, 4, 32, True),
        "d128": (2, 512, 4, 4, 128, True),
        "gqa4": (2, 200, 8, 2, 64, True),
        "gqa4_full": (2, 77, 8, 2, 32, False),
        "s5": (2, 5, 4, 4, 64, True),
    }[variant]
    g = torch.Generator().manual_seed(0)
    if variant == "fused":
        qkv = torch.randn(b, s, 3, h, d, generator=g).to(dev, torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = torch.randn(b, s, h, d, generator=g).to(dev, torch.bfloat16)
        k = torch.randn(b, s, hk, d, generator=g).to(dev, torch.bfloat16)
        v = torch.randn(b, s, hk, d, generator=g).to(dev, torch.bfloat16)
    do = torch.randn(b, s, h, d, generator=g).to(dev, torch.bfloat16)
    return q, k, v, do, causal


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["causal", "full", "gqa", "ragged",
                                     "fused", "s64", "s96", "s200", "d32",
                                     "d128", "gqa4", "gqa4_full", "s5"])
def test_kernels_match_plain_on_cuda(cuda_device, variant):
    """Forward (O, LSE) and backward (dQ, dK, dV) kernels against the
    plain twins on the same bf16 inputs: outputs round to bf16 (2^-8
    relative), and the grads sum up to S terms in another order."""
    q, k, v, do, causal = _cuda_case(cuda_device, variant)
    n0 = dict(fa.launches)
    o, lse = fa._launch_fwd(q, k, v, causal, q.shape[-1] ** -0.5)
    grads = fa._launch_bwd(q, k, v, o, lse, do, causal, q.shape[-1] ** -0.5)
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - n0[n] for n in n0} == {
        "flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}
    po, plse = flash_attention_fwd_plain(q, k, v, causal=causal)
    torch.testing.assert_close(o.float(), po.float(), **BF16_TOL)
    torch.testing.assert_close(lse, plse, atol=1e-3, rtol=1e-3)
    want = flash_attention_bwd_plain(q, k, v, po, plse, do, causal=causal)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        assert got.shape == ref.shape and got.is_contiguous(), name
        torch.testing.assert_close(got.float(), ref.float(), **BF16_TOL,
                                   msg=name)


@pytest.mark.cuda
def test_backward_is_deterministic_on_cuda(cuda_device):
    """No atomics: two backward runs give bitwise-equal grads, and an
    expanded dO (stride 0) is taken; "gqa4" crosses q heads in the dK/dV
    walk."""
    for variant in ("gqa", "gqa4"):
        q, k, v, _, causal = _cuda_case(cuda_device, variant)
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        runs = []
        for _ in range(2):
            for t in ts:
                t.grad = None
            flash_attention(*ts, causal=causal).sum().backward()
            runs.append([t.grad.clone() for t in ts])
        for a, b in zip(*runs):
            assert torch.equal(a, b), variant


@pytest.mark.cuda
def test_float32_is_refused_on_cuda(cuda_device):
    q = torch.zeros(1, 16, 2, 64, device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        flash_attention(q, q, q)
