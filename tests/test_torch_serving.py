"""The port's paged serving engine against the JAX engine.

Same weights (carried with ``params_from_jax``), same fp32 model (2
layers, max_seq_len 64), same engine geometry (block_size 8, 3 slots,
prefill_bucket 16) and the same staggered workload: the port's greedy
token streams must equal the JAX engine's (``paged_attn="gather"``)
EXACTLY, on the port's gather read and on its kernel read
(``paged_attn="pallas"``, the plain twin on the CPU). The pool is sized
so the workload takes a prefix-cache hit and a preemption, and both
engines must agree on those counters too; ``close()`` then runs the
allocator's leak check. Both engines resolve ``paged_attn`` from the
same config, ``PTD_PAGED_ATTN`` setting and argument to the same value.
"""

import json
import os

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
from pytorchdistributed_tpu.models import GPT2 as JaxGPT2
from pytorchdistributed_tpu.models import gpt2_config as jax_gpt2_config
from pytorchdistributed_tpu.serving import ServingEngine as JaxEngine
from pytorchdistributed_tpu_torch.models import GPT2, gpt2_config
from pytorchdistributed_tpu_torch.models.from_jax import params_from_jax
from pytorchdistributed_tpu_torch.serving import (
    SamplingParams,
    ServingEngine,
)

GEOM = dict(num_slots=3, prefill_bucket=16, block_size=8, num_blocks=12)


def _workload():
    """Four staggered requests; the first and last share a 17-token
    system prompt (two full blocks), so the last admits by reference."""
    rng = np.random.default_rng(0)
    system = rng.integers(0, 128, (17,)).astype(np.int32)
    prompts = [rng.integers(0, 128, (n,)).astype(np.int32)
               for n in (5, 9, 3, 13)]
    prompts[0] = np.concatenate([system, prompts[0]])
    prompts[3] = np.concatenate([system, prompts[3]])
    return prompts, [20, 14, 24, 18]


def _drive(engine):
    prompts, news = _workload()
    reqs = []
    for p, n in zip(prompts, news):
        reqs.append(engine.submit(p, max_new_tokens=n))
        engine.step()  # staggered arrivals interleave with decoding
    engine.run_until_idle()
    s = engine.summary()
    return ([list(map(int, r.new_tokens)) for r in reqs],
            s["preemptions"], s["prefix_hit_tokens"])


@pytest.fixture(scope="module")
def jax_run():
    cfg = jax_gpt2_config("test", num_layers=2, max_seq_len=64,
                          scan_layers=False, dtype=jnp.float32)
    model = JaxGPT2(cfg)
    params = nn.meta.unbox(model.init(jax.random.key(1),
                                      jnp.zeros((1, 4), jnp.int32)))
    engine = JaxEngine(model, params, paged_attn="gather", **GEOM)
    out = _drive(engine)
    engine.close()
    return jax.tree.map(np.asarray, params), out


def _port_model(tree):
    cfg = gpt2_config("test", num_layers=2, max_seq_len=64,
                      dtype=torch.float32)
    model = GPT2(cfg)
    model.load_state_dict(params_from_jax(tree, cfg))
    return model


@pytest.mark.parametrize("paged_attn", ["gather", "pallas"])
def test_greedy_streams_equal_jax_engine(jax_run, paged_attn):
    tree, (ref_tokens, ref_preempt, ref_hits) = jax_run
    assert ref_preempt >= 1 and ref_hits > 0  # the workload bites
    engine = ServingEngine(_port_model(tree), paged_attn=paged_attn,
                           device="cpu", **GEOM)
    tokens, preempt, hits = _drive(engine)
    assert tokens == ref_tokens
    assert (preempt, hits) == (ref_preempt, ref_hits)
    assert engine.summary()["paged_attn"] == paged_attn
    engine.close()  # free + resident == pool, then a clean pool


# the model config's paged_attn, PTD_PAGED_ATTN, the engine argument, and
# what the engine resolves them to on the CPU
RESOLUTION_CASES = {
    "config_gather_no_env": ("gather", None, None, "gather"),
    "env_pallas": ("gather", "pallas", None, "pallas"),
    "config_pallas": ("pallas", None, None, "pallas"),
    "config_pallas_over_env": ("pallas", "gather", None, "pallas"),
    "arg_auto": ("gather", None, "auto", "gather"),
    "arg_gather": ("gather", None, "gather", "gather"),
    "arg_gather_over_env": ("gather", "pallas", "gather", "gather"),
}


@pytest.mark.parametrize("case", sorted(RESOLUTION_CASES))
def test_paged_attn_resolves_as_the_jax_engine(jax_run, monkeypatch, case):
    """``paged_attn=None`` takes the model config's value unless it is
    "gather", then ``PTD_PAGED_ATTN``, then "auto" (the kernel on an
    accelerator, the gather read on the CPU): both engines resolve each
    case to the same value, and report it in ``summary()``."""
    cfg_attn, env, arg, want = RESOLUTION_CASES[case]
    tree, _ = jax_run
    if env is None:
        monkeypatch.delenv("PTD_PAGED_ATTN", raising=False)
    else:
        monkeypatch.setenv("PTD_PAGED_ATTN", env)
    paging = dict(paged_attn=cfg_attn, kv_block_size=GEOM["block_size"],
                  kv_blocks=GEOM["num_blocks"],
                  decode_slots=GEOM["num_slots"])
    jcfg = jax_gpt2_config("test", num_layers=2, max_seq_len=64,
                           scan_layers=False, dtype=jnp.float32,
                           decode=True, **paging)
    jengine = JaxEngine(JaxGPT2(jcfg), tree, paged_attn=arg, **GEOM)
    cfg = gpt2_config("test", num_layers=2, max_seq_len=64,
                      dtype=torch.float32, **paging)
    engine = ServingEngine(GPT2(cfg), paged_attn=arg, device="cpu", **GEOM)
    got = (jengine.summary()["paged_attn"], engine.summary()["paged_attn"])
    jengine.close()
    engine.close()
    assert got == (want, want)


def test_paged_attn_kernel_alias_and_unknown_names():
    """The port's earlier name "kernel" reads "pallas" in the config and
    in the engine; an unknown name raises in both."""
    paging = dict(kv_block_size=GEOM["block_size"],
                  kv_blocks=GEOM["num_blocks"],
                  decode_slots=GEOM["num_slots"])
    cfg = gpt2_config("test", num_layers=2, max_seq_len=64,
                      dtype=torch.float32, paged_attn="kernel", **paging)
    assert cfg.paged_attn == "pallas"
    engine = ServingEngine(GPT2(cfg), paged_attn="kernel", device="cpu",
                           **GEOM)
    assert engine.paged_attn == engine.summary()["paged_attn"] == "pallas"
    engine.close()
    with pytest.raises(ValueError, match="'auto', 'gather' or 'pallas'"):
        ServingEngine(GPT2(gpt2_config("test", num_layers=2)),
                      paged_attn="flash", device="cpu", **GEOM)
    with pytest.raises(ValueError, match="unknown paged_attn"):
        gpt2_config("test", paged_attn="flash", **paging)
    with pytest.raises(ValueError, match="requires the paged KV pool"):
        gpt2_config("test", paged_attn="pallas")


def test_sampled_streams_follow_their_own_generator(jax_run):
    """A sampled request's tokens depend on its seed only, not on its
    slot or on who else is resident; greedy requests beside it are
    untouched."""
    tree, _ = jax_run
    rng = np.random.default_rng(7)
    p_s = rng.integers(0, 128, (6,)).astype(np.int32)
    p_g = rng.integers(0, 128, (10,)).astype(np.int32)
    hot = SamplingParams(temperature=1.0, top_k=20, top_p=0.9, seed=5)

    def run(first_greedy):
        engine = ServingEngine(_port_model(tree), device="cpu", **GEOM)
        order = [(p_g, None), (p_s, hot)]
        if not first_greedy:
            order.reverse()
        reqs = {id(pp): engine.submit(pp, max_new_tokens=12, sampling=sp)
                for pp, sp in order}
        engine.run_until_idle()
        engine.close()
        return reqs[id(p_s)].new_tokens, reqs[id(p_g)].new_tokens

    a, ga = run(True)
    b, gb = run(False)
    assert a == b and ga == gb
    assert len(set(a)) > 1  # the sampler really sampled


def test_telemetry_rows_and_spans(jax_run, tmp_path):
    tree, _ = jax_run
    engine = ServingEngine(_port_model(tree), device="cpu",
                           telemetry_dir=str(tmp_path), **GEOM)
    req = engine.submit(np.arange(9, dtype=np.int32), max_new_tokens=4)
    assert list(engine.stream(req)) == req.new_tokens
    engine.close()
    rows = [json.loads(line) for line in
            open(os.path.join(tmp_path, "serve_metrics_rank0.jsonl"))]
    kinds = [r["kind"] for r in rows]
    assert kinds.count("tick") == 3 and "request" in kinds and "pool" in kinds
    spans = json.load(open(os.path.join(tmp_path,
                                        "spans_rank0.trace.json")))
    names = {e["name"] for e in spans["traceEvents"] if e["ph"] == "X"}
    assert {"serve/prefill", "serve/decode_tick"} <= names


@pytest.mark.parametrize("temp,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.8), (0.9, 12, 0.6)])
def test_sampler_distribution_matches_jax(temp, top_k, top_p):
    """The per-slot sampler draws from the reference's filtered
    distribution: the candidate filter matches ``_slot_candidates``, and
    inverse-CDF sampling over an evenly spaced grid of uniforms hits
    each token with the frequency ``slot_filtered_probs`` gives it (to
    the grid's 1/N resolution). Greedy rows are the argmax."""
    from pytorchdistributed_tpu.inference import (
        _slot_candidates as jax_candidates,
        slot_filtered_probs,
    )
    from pytorchdistributed_tpu_torch.inference import (
        _slot_candidates,
        sample_slots,
    )

    rng = np.random.default_rng(11)
    logits = (rng.normal(size=(1, 200)) * 2).astype(np.float32)
    jargs = (jnp.asarray(logits), jnp.full(1, temp, jnp.float32),
             jnp.full(1, top_k, jnp.int32), jnp.full(1, top_p, jnp.float32))
    jvals, jidx = jax_candidates(*jargs, 32)
    t = torch.from_numpy(logits)
    targs = (torch.full((1,), temp), torch.full((1,), top_k),
             torch.full((1,), top_p))
    vals, idx = _slot_candidates(t, *targs, 32)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-6)
    n = 4000
    u = (torch.arange(n, dtype=torch.float32) + 0.5) / n
    rows = t.expand(n, -1)
    toks = sample_slots(rows, u, targs[0].expand(n), targs[1].expand(n),
                        targs[2].expand(n), candidates=32)
    freq = np.bincount(toks.numpy(), minlength=200) / n
    want = np.asarray(slot_filtered_probs(*jargs, candidates=32))[0]
    np.testing.assert_allclose(freq, want, atol=2.0 / n)
    greedy = sample_slots(t, torch.zeros(1), torch.zeros(1),
                          torch.zeros(1, dtype=torch.long), torch.ones(1))
    assert int(greedy[0]) == int(np.argmax(logits))
