"""Hygiene of the PyTorch port: it stands apart from JAX and never runs
on the CPU when asked for the card.

  * no module of ``pytorchdistributed_tpu_torch`` and not
    ``chip_smoke.py`` imports ``jax``, ``flax`` or
    ``pytorchdistributed_tpu`` (checked on the syntax tree, so imports
    inside functions count);
  * the package imports in a fresh interpreter in which ``jax`` cannot
    be imported;
  * asking the engine, the trainer, a mesh or a kernel for CUDA on a
    machine without one raises instead of falling back.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pytorchdistributed_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "pytorchdistributed_tpu"}


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_imports_anywhere_in_the_port():
    files = _sources()
    assert len(files) > 10 and os.path.exists(files[0])
    bad = {os.path.relpath(f, ROOT): sorted(set(_imported_roots(f))
                                             & FORBIDDEN)
           for f in files}
    assert not {f: b for f, b in bad.items() if b}


def test_package_imports_without_jax():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        root = name.split('.')[0]\n"
        "        if root in ('jax', 'jaxlib', 'flax', "
        "'pytorchdistributed_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import pytorchdistributed_tpu_torch.serving\n"
        "import pytorchdistributed_tpu_torch.models.from_jax\n"
        "import pytorchdistributed_tpu_torch.ops.paged_attention\n"
        "import pytorchdistributed_tpu_torch.parallel.precision\n"
        "import pytorchdistributed_tpu_torch.telemetry.events\n"
        "import pytorchdistributed_tpu_torch.ops.flash_attention\n"
        "import pytorchdistributed_tpu_torch.training.trainer\n"
        "import pytorchdistributed_tpu_torch.runtime.mesh\n"
        "import pytorchdistributed_tpu_torch.ops.ring_attention\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_request_raises_without_a_gpu(monkeypatch):
    from pytorchdistributed_tpu_torch import _build
    from pytorchdistributed_tpu_torch.models import GPT2, gpt2_config
    from pytorchdistributed_tpu_torch.ops.paged_attention import (
        _launch,
        paged_flash_attention,
    )
    from pytorchdistributed_tpu_torch.serving import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = GPT2(gpt2_config("test", num_layers=1, max_seq_len=16))
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(model, block_size=8)  # device defaults to "cuda"
    # the kernel path never falls back to the plain twin: with no
    # toolkit it cannot build, and it says so
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "library_path",
                        lambda name: "/nonexistent/lib.so")
    q = torch.zeros(1, 2, 32)
    pool = torch.zeros(2, 8, 2, 32)
    tbl = torch.zeros(1, 1, dtype=torch.int32)
    lens = torch.zeros(1, dtype=torch.int32)
    n0 = paged_flash_attention.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        _launch(q, pool, pool, tbl, lens, None, None, 0, 0, 32 ** -0.5)
    assert paged_flash_attention.launches == n0
    # a tensor that is neither CUDA nor CPU is refused, not computed
    with pytest.raises(RuntimeError, match="CUDA or the CPU"):
        paged_flash_attention(q.to("meta"), pool.to("meta"),
                              pool.to("meta"), tbl.to("meta"),
                              lens.to("meta"))
    assert np.isfinite(paged_flash_attention(q, pool, pool, tbl,
                                             lens).numpy()).all()


def test_trainer_and_flash_refuse_to_fall_back(monkeypatch):
    """The trainer's default device is CUDA, and without a GPU it raises;
    each flash launcher raises without a toolkit and counts nothing; a
    tensor that is neither CUDA nor CPU is refused."""
    from pytorchdistributed_tpu_torch import _build
    from pytorchdistributed_tpu_torch.models import GPT2, gpt2_config
    from pytorchdistributed_tpu_torch.ops import flash_attention as fa
    from pytorchdistributed_tpu_torch.training import (
        Trainer,
        adamw,
        token_cross_entropy_loss,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = GPT2(gpt2_config("test", num_layers=1, attention="pallas"))
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(model, adamw(1e-3), token_cross_entropy_loss)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "library_path",
                        lambda name: "/nonexistent/lib.so")
    q = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 8)
    n0 = dict(fa.launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        fa._launch_fwd(q, q, q, True, 32 ** -0.5)
    with pytest.raises(RuntimeError, match="nvcc"):
        fa._launch_bwd(q, q, q, q, lse, q, True, 32 ** -0.5)
    assert fa.launches == n0
    meta = q.to("meta")
    with pytest.raises(RuntimeError, match="CUDA or the CPU"):
        fa.flash_attention(meta, meta, meta)
    out = fa.flash_attention(q.float(), q.float(), q.float(), causal=True)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())


def test_ring_refuses_to_fall_back(monkeypatch):
    """A mesh's default device is CUDA, and without a GPU it raises; each
    ring hop launcher raises without a toolkit and counts nothing; a
    tensor that is neither CUDA nor CPU is refused."""
    from pytorchdistributed_tpu_torch import _build
    from pytorchdistributed_tpu_torch.ops import ring_attention as ring
    from pytorchdistributed_tpu_torch.runtime.mesh import create_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        create_mesh(seq=4)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "library_path",
                        lambda name: "/nonexistent/lib.so")
    q = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
    acc = torch.zeros(1, 8, 2, 32)
    rows = torch.zeros(1, 2, 8)
    n0 = dict(ring.launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        ring._launch_fwd_hop(q, q, q, acc, rows, rows.clone(), True, 0.125)
    ops = ring._bwd_hop_operands(q, q, q, q, rows, rows.clone())
    with pytest.raises(RuntimeError, match="nvcc"):
        ring._launch_dq_hop(ops, acc, True, 0.125)
    with pytest.raises(RuntimeError, match="nvcc"):
        ring._launch_dkv_hop(ops, acc, acc.clone(), True, 0.125)
    assert ring.launches == n0
    mesh = create_mesh(seq=4, device="cpu")
    meta = q.to("meta")
    with pytest.raises(RuntimeError, match="CUDA or the CPU"):
        ring.ring_attention_sharded(meta, meta, meta, mesh=mesh)
    out = ring.ring_attention_sharded(q.float(), q.float(), q.float(),
                                      causal=True, mesh=mesh)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())


# two paged instantiations that differ only in type arguments (and use a
# substitution), then a flash one, as ``nvcc -Xptxas -v`` reports them
PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__74e6c365_18_paged_attention_cu_b49fea3922paged_attention_kernelI13__nv_bfloat16S1_Li64ELi1EEEvPKT_PKT0_S7_PKfS9_PKiSB_PS2_PfSD_iiiiiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__74e6c365_18_paged_attention_cu_b49fea3922paged_attention_kernelI13__nv_bfloat16S1_Li64ELi1EEEvPKT_PKT0_S7_PKfS9_PKiSB_PS2_PfSD_iiiiiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 1312 bytes smem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__74e6c365_18_paged_attention_cu_b49fea3922paged_attention_kernelI13__nv_bfloat16aLi64ELi1EEEvPKT_PKT0_S7_PKfS9_PKiSB_PS2_PfSD_iiiiiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__74e6c365_18_paged_attention_cu_b49fea3922paged_attention_kernelI13__nv_bfloat16aLi64ELi1EEEvPKT_PKT0_S7_PKfS9_PKiSB_PS2_PfSD_iiiiiiiiif
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 1312 bytes smem
ptxas info    : Compiling entry function '_Z16flash_fwd_kernelILi64ELb0ELi128EEvPK13__nv_bfloat16S2_S2_PS0_Pfiiiiif' for 'sm_90a'
ptxas info    : Function properties for _Z16flash_fwd_kernelILi64ELb0ELi128EEvPK13__nv_bfloat16S2_S2_PS0_Pfiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 254 registers, used 1 barriers
"""


def test_ptxas_report_names_every_instantiation():
    """``chip_smoke.ptxas_kernels`` keys each instantiation by its name
    with its template arguments, type arguments included, so no paged
    instantiation overwrites another."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    got = chip_smoke.ptxas_kernels(PTXAS_REPORT)
    assert got == {
        "paged_attention_kernel<bf16, bf16, 64, 1>":
            {"registers": 72, "spill_bytes": 0},
        "paged_attention_kernel<bf16, int8, 64, 1>":
            {"registers": 80, "spill_bytes": 8},
        "flash_fwd_kernel<64, false, 128>":
            {"registers": 254, "spill_bytes": 0},
    }
    assert chip_smoke.demangle_kernel(
        "_ZN12_GLOBAL__N_122paged_attention_kernelIfaLi128ELi4EEEvPKT_"
    ) == "paged_attention_kernel<float, int8, 128, 4>"
