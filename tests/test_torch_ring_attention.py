"""Parity of the port's ring attention with the JAX reference.

The port runs the "seq" axis's shards in one process on one device
(``runtime/mesh.py``); on CPU tensors each hop takes the kernels' blocked
plain versions. Held here against the JAX package on the same numpy
inputs, fp32, at the reference suite's tolerance (atol 2e-5,
tests/test_attention.py):

  * per hop: the port's ``_pallas_fwd_update`` / ``_pallas_bwd_update``
    (plain versions) and ``_xla_*_update`` against the JAX
    ``_pallas_*_update`` in Pallas interpret mode, from non-trivial
    carries, diagonal and fully visible, at block 16 and at block 12
    against S_local 16 (the padded tail); the diagonal forward and
    backward hops also at unequal blocks (32, 16) and (16, 32) over
    S_local 37;
  * the whole op: ``ring_attention_sharded`` under a port mesh ``seq=4``
    against the JAX one under ``create_mesh(data=2, seq=4)`` — output and
    the grads of ``sum(out · dO)``, causal and not, both impls;
  * the autograd Function saves only (q, k, v, o, lse), and its backward
    never reads the ambient mesh;
  * the mesh: ``-1`` resolves, non-``seq`` axes above 1 raise, the ring
    raises without a mesh.

The CUDA kernels are held against the plain versions on the card by the
``*_cuda`` cases (skipped without a GPU):

    python -m pytest --noconftest tests/test_torch_ring_attention.py -k cuda
"""

import numpy as np
import pytest
import torch

from pytorchdistributed_tpu_torch.ops import ring_attention as ring
from pytorchdistributed_tpu_torch.ops.ring_attention import (
    ring_attention_sharded,
)
from pytorchdistributed_tpu_torch.runtime.mesh import (
    Axis,
    Mesh,
    MeshConfig,
    create_mesh,
    get_mesh,
    mesh_shape,
    set_mesh,
)

ATOL = 2e-5
B, S, H, D = 2, 64, 4, 16   # S_local 16 over 4 shards


def _jax():
    """The JAX reference, imported here rather than at module level so the
    CUDA cases also collect on a machine without JAX."""
    import jax
    import jax.numpy as jnp
    from pytorchdistributed_tpu.ops import ring_attention as jring
    from pytorchdistributed_tpu.runtime.mesh import create_mesh as jmesh

    return jax, jnp, jring, jmesh


def _fold(a):
    """numpy [B, S, H, D] -> [B·H, S, D] (the JAX ring's kernel layout)."""
    b, s, h, d = a.shape
    return a.transpose(0, 2, 1, 3).reshape(b * h, s, d)


def _unfold(a, b, h):
    bh, s, d = a.shape
    return a.reshape(b, h, s, d).transpose(0, 2, 1, 3)


def _rows(a):
    """[B, H, S] -> [B·H, S, 1] (the JAX ring's row-statistic layout)."""
    return a.reshape(-1, a.shape[-1], 1)


def _hop_inputs(s=16, seed=0):
    """q, k, v, dO [B, s, H, D] and non-trivial carries: a few rows fresh
    (m -1e30, l 0, acc 0), the rest from a previous hop's range."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, s, H, D)).astype(np.float32)
                   for _ in range(4))
    m = rng.standard_normal((B, H, s)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (B, H, s)).astype(np.float32)
    acc = rng.standard_normal((B, s, H, D)).astype(np.float32)
    m[:, :, :2], l[:, :, :2], acc[:, :2] = -1e30, 0.0, 0.0
    dq, dk, dv = (rng.standard_normal((B, s, H, D)).astype(np.float32)
                  for _ in range(3))
    delta = rng.standard_normal((B, H, s)).astype(np.float32)
    return dict(q=q, k=k, v=v, do=do, m=m, l=l, acc=acc, dq=dq, dk=dk,
                dv=dv, delta=delta)


def _lse(x, causal):
    """This hop's masked row log-sum-exp plus U(0, 1): a valid LSE for the
    rows (p <= 1 over the block), [B, H, S]."""
    logits = np.einsum("bqhd,bkhd->bhqk", x["q"], x["k"]) * D ** -0.5
    if causal:
        s = logits.shape[-1]
        logits = np.where(np.tril(np.ones((s, s), bool)), logits, -np.inf)
    mx = logits.max(-1, keepdims=True)
    lse = (mx + np.log(np.exp(logits - mx).sum(-1, keepdims=True)))[..., 0]
    rng = np.random.default_rng(1)
    return (lse + rng.uniform(0, 1, lse.shape)).astype(np.float32)


def _specs(causal, blk):
    _, _, jring, _ = _jax()
    kw = dict(axis_name=Axis.SEQ, causal=causal, scale=D ** -0.5,
              block_q=blk, block_k=blk)
    return (jring._RingSpec(impl="pallas", interpret=True, **kw),
            ring._RingSpec(impl="pallas", **kw))


HOP_CASES = [("pallas", 16), ("pallas", 12), ("xla", 16)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl,blk", HOP_CASES)
def test_fwd_hop_matches_jax(impl, blk, causal):
    """One forward hop from a carry: (acc, m, l) out, unnormalized."""
    _, jnp, jring, _ = _jax()
    x = _hop_inputs(seed=2)
    jspec, spec = _specs(causal, blk)
    jacc, jm, jl = jring._pallas_fwd_update(
        *(jnp.asarray(_fold(x[n])) for n in ("q", "k", "v", "acc")),
        jnp.asarray(_rows(x["m"])), jnp.asarray(_rows(x["l"])),
        causal=causal, spec=jspec)
    update = (ring._pallas_fwd_update if impl == "pallas"
              else ring._xla_fwd_update)
    t = {n: torch.from_numpy(x[n].copy()) for n in x}
    acc, m, l = update(t["q"], t["k"], t["v"], t["acc"], t["m"], t["l"],
                       causal=causal, spec=spec)
    np.testing.assert_allclose(acc.numpy(), _unfold(np.asarray(jacc), B, H),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm).reshape(B, H, -1),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl).reshape(B, H, -1),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("block_q,block_k", [(32, 16), (16, 32)])
def test_fwd_hop_unequal_blocks_match_jax(block_q, block_k):
    """The diagonal forward hop at unequal q and k blocks, as its kernel
    may tile, over a ragged S_local 37: the plain hop against the JAX
    ``_pallas_fwd_update`` on the same blocks, from the same carry."""
    _, jnp, jring, _ = _jax()
    x = _hop_inputs(s=37, seed=4)
    kw = dict(axis_name=Axis.SEQ, causal=True, scale=D ** -0.5,
              block_q=block_q, block_k=block_k)
    jacc, jm, jl = jring._pallas_fwd_update(
        *(jnp.asarray(_fold(x[n])) for n in ("q", "k", "v", "acc")),
        jnp.asarray(_rows(x["m"])), jnp.asarray(_rows(x["l"])),
        causal=True, spec=jring._RingSpec(impl="pallas", interpret=True,
                                          **kw))
    t = {n: torch.from_numpy(x[n].copy()) for n in x}
    acc, m, l = ring._pallas_fwd_update(
        t["q"], t["k"], t["v"], t["acc"], t["m"], t["l"], causal=True,
        spec=ring._RingSpec(impl="pallas", **kw))
    np.testing.assert_allclose(acc.numpy(), _unfold(np.asarray(jacc), B, H),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm).reshape(B, H, -1),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl).reshape(B, H, -1),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl,blk", HOP_CASES)
def test_bwd_hop_matches_jax(impl, blk, causal):
    """One backward hop into carried dq and co-travelling dk/dv."""
    _, jnp, jring, _ = _jax()
    x = _hop_inputs(seed=3)
    lse = _lse(x, causal)
    jspec, spec = _specs(causal, blk)
    jdq, jdk, jdv = jring._pallas_bwd_update(
        *(jnp.asarray(_fold(x[n])) for n in ("q", "k", "v", "do")),
        jnp.asarray(_rows(lse)), jnp.asarray(_rows(x["delta"])),
        *(jnp.asarray(_fold(x[n])) for n in ("dq", "dk", "dv")),
        causal=causal, spec=jspec)
    update = (ring._pallas_bwd_update if impl == "pallas"
              else ring._xla_bwd_update)
    t = {n: torch.from_numpy(x[n].copy()) for n in x}
    got = update(t["q"], t["k"], t["v"], t["do"], torch.from_numpy(lse),
                 t["delta"], t["dq"], t["dk"], t["dv"], causal=causal,
                 spec=spec)
    for name, a, w in zip(("dq", "dk", "dv"), got, (jdq, jdk, jdv)):
        np.testing.assert_allclose(a.numpy(), _unfold(np.asarray(w), B, H),
                                   atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("block_q,block_k", [(32, 16), (16, 32)])
def test_bwd_hop_unequal_blocks_match_jax(block_q, block_k):
    """The diagonal backward hop at unequal q and k blocks over a ragged
    S_local 37: the plain hop (``ring_bwd_update_plain``) against the JAX
    ``_pallas_bwd_update`` on the same blocks, into the same carries."""
    _, jnp, jring, _ = _jax()
    x = _hop_inputs(s=37, seed=5)
    lse = _lse(x, True)
    kw = dict(axis_name=Axis.SEQ, causal=True, scale=D ** -0.5,
              block_q=block_q, block_k=block_k)
    jdq, jdk, jdv = jring._pallas_bwd_update(
        *(jnp.asarray(_fold(x[n])) for n in ("q", "k", "v", "do")),
        jnp.asarray(_rows(lse)), jnp.asarray(_rows(x["delta"])),
        *(jnp.asarray(_fold(x[n])) for n in ("dq", "dk", "dv")),
        causal=True, spec=jring._RingSpec(impl="pallas", interpret=True,
                                          **kw))
    t = {n: torch.from_numpy(x[n].copy()) for n in x}
    got = ring.ring_bwd_update_plain(
        t["q"], t["k"], t["v"], t["do"], torch.from_numpy(lse), t["delta"],
        t["dq"], t["dk"], t["dv"], causal=True, scale=D ** -0.5,
        block_q=block_q, block_k=block_k)
    for name, a, w in zip(("dq", "dk", "dv"), got, (jdq, jdk, jdv)):
        np.testing.assert_allclose(a.numpy(), _unfold(np.asarray(w), B, H),
                                   atol=ATOL, rtol=0, err_msg=name)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl,blk", [("pallas", 512), ("pallas", 12),
                                      ("xla", 512)])
def test_ring_matches_jax_ring(impl, blk, causal):
    """The whole op and its reverse-ring grads: seq=4 (S_local 16); the
    default block clamps to S_local, block 12 leaves a padded tail."""
    jax, jnp, jring, jmesh = _jax()
    q, k, v, do = _inputs(seed=5)
    kw = dict(causal=causal, impl=impl, block_q=blk, block_k=blk)

    def loss(q, k, v):
        out = jring.ring_attention_sharded(q, k, v, **kw)
        return (out * jnp.asarray(do)).sum(), out

    with jax.set_mesh(jmesh(data=2, seq=4)):
        (_, jout), jgrads = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(
                *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    with set_mesh(create_mesh(seq=4, device="cpu")):
        out = ring_attention_sharded(*ts, **kw)
        (out * torch.from_numpy(do)).sum().backward()
    for name, a, w in zip(("out", "dq", "dk", "dv"),
                          (out, *(t.grad for t in ts)), (jout, *jgrads)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w),
                                   atol=ATOL, rtol=0, err_msg=name)


def test_saved_residuals_are_q_k_v_o_lse():
    """The counterpart of test_ring_grad_residuals_stay_local: the
    Function keeps exactly (q, k, v, o, lse) — nothing with a hop
    dimension, nothing larger than one operand — and no other tensor on
    its context."""
    b, s, h, d = 2, 256, 2, 32
    q, k, v = (torch.randn(b, s, h, d, requires_grad=True) for _ in range(3))
    with set_mesh(create_mesh(seq=4, device="cpu")):
        out = ring_attention_sharded(q, k, v, causal=True)
    node = out.grad_fn
    saved = node.saved_tensors
    assert len(saved) == 5
    for got, want in zip(saved[:3], (q, k, v)):
        assert got.data_ptr() == want.data_ptr() and got.shape == want.shape
    assert saved[3].data_ptr() == out.data_ptr()
    assert saved[4].shape == (b, h, s) and saved[4].dtype == torch.float32
    assert max(t.numel() for t in saved) == q.numel()
    assert not [a for a in vars(node).values() if isinstance(a, torch.Tensor)]
    assert node.n == 4 and node.spec.causal


def test_backward_does_not_read_the_ambient_mesh():
    """The grads come from the mesh of the forward, whatever is ambient
    when ``backward()`` runs — no mesh, or another one."""
    q, k, v, do = map(torch.from_numpy, _inputs(seed=7))
    grads = []
    for later in (None, create_mesh(seq=2, device="cpu")):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        with set_mesh(create_mesh(seq=4, device="cpu")):
            out = ring_attention_sharded(*ts, causal=True)
        if later is None:
            out.backward(do)
        else:
            with set_mesh(later):
                out.backward(do)
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_mesh_resolution_and_ambient_scope():
    mesh = create_mesh(seq=4, device="cpu")
    assert mesh_shape(mesh) == {Axis.DATA: 1, Axis.FSDP: 1, Axis.EXPERT: 1,
                                Axis.PIPE: 1, Axis.SEQ: 4, Axis.TENSOR: 1}
    assert tuple(mesh.shape) == Axis.ALL and mesh.device.type == "cpu"
    assert create_mesh(MeshConfig(data=-1, seq=2), device="cpu").shape[
        Axis.SEQ] == 2
    assert mesh_shape(create_mesh(device="cpu"))[Axis.DATA] == 1
    assert get_mesh() is None
    other = create_mesh(seq=2, device="cpu")
    with set_mesh(mesh):
        assert get_mesh() is mesh
        with set_mesh(other):
            assert get_mesh() is other
        assert get_mesh() is mesh
        with pytest.raises(RuntimeError):
            with set_mesh(other):
                raise RuntimeError("scope ends")
        assert get_mesh() is mesh
    assert get_mesh() is None


@pytest.mark.parametrize("axis", ["data", "fsdp", "expert", "pipe",
                                  "tensor"])
def test_mesh_refuses_axes_across_devices(axis):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        create_mesh(device="cpu", **{axis: 2})
    sizes = {a: 1 for a in Axis.ALL}
    sizes[axis] = 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Mesh(sizes, torch.device("cpu"))


def test_ring_refusals():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="needs a mesh"):
        ring_attention_sharded(q, q, q)
    mesh = create_mesh(seq=4, device="cpu")
    with pytest.raises(ValueError, match="impl"):
        ring_attention_sharded(q, q, q, mesh=mesh, impl="flash")
    with pytest.raises(ValueError, match="divisible"):
        ring_attention_sharded(torch.zeros(1, 6, 2, 16),
                               torch.zeros(1, 6, 2, 16),
                               torch.zeros(1, 6, 2, 16), mesh=mesh)
    kv = torch.zeros(1, 8, 1, 16)
    with pytest.raises(ValueError, match="heads"):
        ring_attention_sharded(q, kv, kv, mesh=mesh)
    with pytest.raises(ValueError, match="mesh on"):
        ring_attention_sharded(q, q, q,
                               mesh=create_mesh(seq=4, device="meta"))
    qb = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="carry"):
        ring._launch_fwd_hop(qb, qb, qb, qb, torch.zeros(1, 2, 8),
                             torch.zeros(1, 2, 8), True, 0.25)


# ---------------------------------------------------------------------------
# on the card: each hop kernel against its plain version, the whole ring
# against the flash kernels


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _cuda_hop(dev, s, seed=0):
    """bf16 (q, k, v, dO) for one hop at [2, s, 4, 64] and fp32 carries
    from a previous visible hop over another K/V block."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev, torch.bfloat16)

    q, k0, v0, k, v, do = (rnd(2, s, 4, 64) for _ in range(6))
    acc = torch.zeros(2, s, 4, 64, device=dev)
    m = torch.full((2, 4, s), -1e30, device=dev)
    l = torch.zeros(2, 4, s, device=dev)
    ring.ring_fwd_update_plain(q, k0, v0, acc, m, l, causal=False,
                               scale=0.125)
    return q, k, v, do, acc, m, l


@pytest.mark.cuda
@pytest.mark.parametrize("s,causal", [(256, True), (256, False),
                                      (250, False), (100, True)])
def test_hop_kernels_match_plain_on_cuda(cuda_device, s, causal):
    """Each hop kernel against its plain version from the same carry
    (cloned: both update in place)."""
    q, k, v, do, acc, m, l = _cuda_hop(cuda_device, s)
    n0 = dict(ring.launches)
    got = ring._launch_fwd_hop(q, k, v, acc.clone(), m.clone(), l.clone(),
                               causal, 0.125)
    want = ring.ring_fwd_update_plain(q, k, v, acc.clone(), m.clone(),
                                      l.clone(), causal=causal, scale=0.125)
    lse = want[1] + torch.log(want[2])
    o = (want[0] / want[2].transpose(1, 2)[..., None]).to(q.dtype)
    delta = ring._delta(o, do)
    carries = [torch.randn(q.shape, device=cuda_device) for _ in range(3)]
    ops = ring._bwd_hop_operands(q, k, v, do, lse, delta)
    bgot = (ring._launch_dq_hop(ops, carries[0].clone(), causal, 0.125),
            *ring._launch_dkv_hop(ops, carries[1].clone(),
                                  carries[2].clone(), causal, 0.125))
    bwant = ring.ring_bwd_update_plain(q, k, v, do, lse, delta,
                                       *(c.clone() for c in carries),
                                       causal=causal, scale=0.125)
    torch.cuda.synchronize()
    assert {n: ring.launches[n] - n0[n] for n in n0} == {
        "ring_fwd": 1, "ring_bwd_dq": 1, "ring_bwd_dkv": 1}
    # the unnormalized acc (a sum of bf16-rounded p·v, p <= 1) rounds at
    # the scale of l: it is held as acc / l, the output it normalizes to
    got = (got[0] / got[2].transpose(1, 2)[..., None], *got[1:])
    want = (want[0] / want[2].transpose(1, 2)[..., None], *want[1:])
    for name, a, w in zip(("acc/l", "m", "l", "dq", "dk", "dv"),
                          (*got, *bgot), (*want, *bwant)):
        torch.testing.assert_close(a, w, **BF16_TOL, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_flash_on_cuda(cuda_device, causal):
    """The whole ring through the hop kernels (q/k/v strided views of one
    fused projection) against the flash kernels on the same inputs."""
    from pytorchdistributed_tpu_torch.ops.flash_attention import (
        flash_attention,
    )

    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(2, 512, 3, 4, 64, generator=g).to(cuda_device,
                                                         torch.bfloat16)
    do = torch.randn(2, 512, 4, 64, generator=g).to(cuda_device,
                                                    torch.bfloat16)
    results = []
    for fn in ("ring", "flash"):
        leaf = qkv.clone().requires_grad_()
        q, k, v = leaf[:, :, 0], leaf[:, :, 1], leaf[:, :, 2]
        if fn == "ring":
            with set_mesh(create_mesh(seq=4, device=cuda_device)):
                out = ring_attention_sharded(q, k, v, causal=causal)
        else:
            out = flash_attention(q, k, v, causal=causal)
        out.backward(do)
        results.append((out.float(), leaf.grad.float()))
    torch.testing.assert_close(results[0][0], results[1][0], **BF16_TOL)
    torch.testing.assert_close(results[0][1], results[1][1], **BF16_TOL)
