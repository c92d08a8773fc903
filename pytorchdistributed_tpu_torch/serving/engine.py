"""Continuous-batching paged serving engine.

PyTorch counterpart of the paged mode of
``pytorchdistributed_tpu/serving/engine.py`` (``ServingEngine(block_size
> 0)``):

  * the engine owns ONE ``PagedKVCache`` — per layer a pool of
    fixed-size K/V blocks shared by every slot — plus a per-slot block
    table, so device memory bounds the tokens actually resident, not
    slots x max_seq_len;
  * ``paged_decode_tick`` advances every slot one token per call: one
    model forward over ``[slots, 1]`` last tokens (each slot at its own
    position, its K/V written into its own blocks) + the per-slot
    sampler. On CUDA the tick's attention is the paged kernel
    (``ops/paged_attention.py``) unless ``paged_attn`` resolves to
    "gather";
  * ``paged_prefill_chunk`` runs one fixed-size prompt chunk of one
    request straight into its blocks, so long admissions interleave with
    decode ticks instead of blocking resident streams;
  * a host radix prefix cache admits shared prompt prefixes by block
    reference, and pool exhaustion preempts the youngest resident
    request (requeued; it resumes by re-prefilling prompt + generated,
    its output stream unchanged).

Both device functions take the cache, tables and lengths explicitly;
the pools are updated in place and all scheduling is host bookkeeping.
Greedy outputs equal the reference engine's token for token
(tests/test_torch_serving.py).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import time

import numpy as np
import torch

from pytorchdistributed_tpu_torch._device import resolve_device
from pytorchdistributed_tpu_torch.inference import (
    kv_cache_bytes,
    sample_slots,
    stop_ids_tuple,
)
from pytorchdistributed_tpu_torch.models.transformer import PagedKVCache
from pytorchdistributed_tpu_torch.serving.paging import (
    BlockAllocator,
    RadixPrefixCache,
)
from pytorchdistributed_tpu_torch.serving.telemetry import ServingTelemetry


@torch.inference_mode()
def paged_decode_tick(model, cache: PagedKVCache, tables, lengths, tokens,
                      uniforms, temperature, top_k, top_p, *,
                      candidates: int):
    """Advance every slot one token: one forward over ``[slots, 1]``
    last tokens at positions ``lengths`` through ``tables`` ([slots,
    kv_pages] int32), then the per-slot sampler. Free slots carry
    all-trash tables and length 0, so their garbage ticks write the
    trash block and can never touch a live request's blocks. Returns
    ``(next_tokens [slots] int32, logits [slots, vocab] fp32)``."""
    logits = model(tokens[:, None], cache=cache, tables=tables,
                   lengths=lengths)[:, 0]
    nxt = sample_slots(logits, uniforms, temperature, top_k, top_p,
                       candidates=candidates)
    return nxt, logits


@torch.inference_mode()
def paged_prefill_chunk(model, cache: PagedKVCache, chunk, start,
                        table_row, true_len: int, uniform, temperature,
                        top_k, top_p, *, candidates: int):
    """One fixed-size prefill chunk of one request, written straight into
    ITS blocks: ``chunk`` is ``[1, C]`` tokens at absolute positions
    ``[start, start + C)`` (right-padded past ``true_len`` — pad K/V lands
    beyond the position mask, or in the trash block past max_seq_len,
    until decode overwrites it); ``table_row`` is the request's
    ``[kv_pages]`` int32 table. Samples the token after position
    ``true_len - 1`` when this chunk holds it (the caller uses only the
    final chunk's sample). Returns ``(token [] int32, logits [vocab])``."""
    dev = chunk.device
    lengths = torch.full((1,), int(start), dtype=torch.int32, device=dev)
    logits = model(chunk, cache=cache, tables=table_row[None],
                   lengths=lengths)
    off = min(max(int(true_len) - 1 - int(start), 0), chunk.shape[1] - 1)
    last = logits[:, off]
    nxt = sample_slots(last, uniform.reshape(1), temperature.reshape(1),
                       top_k.reshape(1), top_p.reshape(1),
                       candidates=candidates)
    return nxt[0], last[0]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs. temperature 0 = greedy; top_k <= 0
    and top_p >= 1 disable their filters; seed starts the request's
    private generator."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0


class Request:
    """One submitted generation: prompt + budget + sampling + stop ids,
    and the engine-filled lifecycle (tokens as they stream, timestamps,
    finish reason). ``generator`` is the request's own random stream:
    one uniform is drawn from it per sampled token, so a request's
    tokens do not depend on which slot or admission order it got."""

    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens: int,
                 sampling: SamplingParams, stop_ids: tuple[int, ...],
                 on_token=None):
        self.id = next(Request._ids)
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = max_new_tokens
        self.sampling = sampling
        self.stop_ids = stop_ids
        self.on_token = on_token
        self.generator = torch.Generator().manual_seed(int(sampling.seed))
        self.new_tokens: list[int] = []
        self.slot: int | None = None
        self.done = False
        self.finish_reason: str | None = None
        self.submit_time: float | None = None
        self.first_token_time: float | None = None
        self.finish_time: float | None = None
        # prompt tokens admitted from the prefix cache instead of prefill
        # compute, chunked-prefill calls paid, and preempt-requeue
        # round-trips survived
        self.prefix_hit_tokens = 0
        self.prefill_chunks = 0
        self.preemptions = 0

    def draw_uniform(self) -> float:
        """The next uniform of this request's stream (greedy requests
        draw nothing)."""
        if self.sampling.temperature <= 0.0:
            return 0.0
        return float(torch.rand((), generator=self.generator))

    @property
    def output_ids(self) -> np.ndarray:
        """prompt + generated continuation (int32 [len])."""
        return np.concatenate(
            [self.prompt, np.asarray(self.new_tokens, np.int32)])

    @property
    def ttft_s(self) -> float | None:
        """Time to first token, queue wait included."""
        if self.first_token_time is None or self.submit_time is None:
            return None
        return self.first_token_time - self.submit_time

    @property
    def decode_tokens_per_s(self) -> float | None:
        """Post-prefill decode rate of this request (None until done or
        when the request finished at its first token)."""
        if self.finish_time is None or self.first_token_time is None:
            return None
        dt = self.finish_time - self.first_token_time
        n = len(self.new_tokens) - 1
        if n <= 0 or dt <= 0:
            return None
        return round(n / dt, 3)


class ServingEngine:
    """The host scheduler over the paged tick / prefill-chunk pair.

    Args:
      model: a ``GPT2`` module holding its weights; it is moved to
        ``device``.
      num_slots: concurrent requests resident in the pool — the tick's
        batch.
      prefill_bucket: default prefill chunk length (clamped to
        max_seq_len).
      candidates: top-k candidate width of the per-slot sampler.
      telemetry / telemetry_dir: a ServingTelemetry (or a run dir to
        build one) for spans + serve-metric JSONL; None = off.
      block_size: tokens per KV block; must divide max_seq_len.
      num_blocks: pool size in blocks (block 0 is the reserved trash
        block). Default = one full context per slot + 1; shrink it to
        oversubscribe — exhaustion first evicts prefix-cache LRU
        entries, then preempts the youngest resident request.
      prefill_chunk: prompts prefill in chunks of this many tokens
        (default prefill_bucket, rounded to a block multiple),
        interleaved with decode ticks.
      prefix_cache: host radix cache over full prompt blocks.
      prefill_chunks_per_step: chunk calls per step() once slots decode.
      kv_dtype: pool storage, "bf16" (the model dtype) or "int8" (codes
        + fp32 per-(token, head) scales). None inherits the model cfg.
      kv_sink_tokens / kv_window_tokens: sink + sliding-window attention
        (block multiples); fully dead middle blocks retire back to the
        allocator mid-stream. None inherits the model cfg.
      paged_attn: the decode tick's read, "pallas" (the paged attention
        kernel; the reference's name, with "kernel" as an alias) or
        "gather"; "auto" is "pallas" on CUDA and "gather" on the CPU.
        None resolves as the reference's engine does: the model cfg's
        value when it is not "gather", else the PTD_PAGED_ATTN env var,
        else "auto". Prefill chunks always gather.
      device: where the model and the pool live; "cuda" by default, and
        asking for CUDA without one raises.
    """

    def __init__(self, model, *, num_slots: int = 4,
                 prefill_bucket: int = 128, candidates: int = 64,
                 telemetry: ServingTelemetry | None = None,
                 telemetry_dir=None, block_size: int = 16,
                 num_blocks: int | None = None,
                 prefill_chunk: int | None = None,
                 prefix_cache: bool = True,
                 prefill_chunks_per_step: int = 1,
                 kv_dtype: str | None = None,
                 kv_sink_tokens: int | None = None,
                 kv_window_tokens: int | None = None,
                 paged_attn: str | None = None, device="cuda"):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {block_size} (this engine "
                f"is the paged one)")
        self.device = resolve_device(device)
        self.num_slots = num_slots
        self.candidates = candidates
        mcfg = model.cfg
        kv_dtype = mcfg.kv_dtype if kv_dtype is None else kv_dtype
        sink = mcfg.kv_sink_tokens if kv_sink_tokens is None \
            else kv_sink_tokens
        window = mcfg.kv_window_tokens if kv_window_tokens is None \
            else kv_window_tokens
        if paged_attn is None:
            paged_attn = (mcfg.paged_attn if mcfg.paged_attn != "gather"
                          else os.environ.get("PTD_PAGED_ATTN", "auto"))
        if paged_attn == "kernel":
            paged_attn = "pallas"
        if paged_attn not in ("auto", "gather", "pallas"):
            raise ValueError(
                f"paged_attn must be 'auto', 'gather' or 'pallas', got "
                f"{paged_attn!r}")
        if paged_attn == "auto":
            # the kernel on the card; the CPU keeps the gather read, the
            # reference's bitwise path
            paged_attn = "pallas" if self.device.type == "cuda" else "gather"
        max_len = mcfg.max_seq_len
        if max_len % block_size:
            raise ValueError(f"block_size {block_size} must divide "
                             f"max_seq_len {max_len}")
        pages = max_len // block_size
        if num_blocks is None:
            num_blocks = num_slots * pages + 1
        if num_blocks < pages + 1:
            raise ValueError(
                f"num_blocks {num_blocks} cannot back even one full-context "
                f"request (need >= {pages + 1}: max_seq_len/block_size + "
                f"the trash block)")
        self.cfg = dataclasses.replace(
            mcfg, decode_slots=num_slots, kv_block_size=block_size,
            kv_blocks=num_blocks, kv_dtype=kv_dtype, kv_sink_tokens=sink,
            kv_window_tokens=window, paged_attn=paged_attn)
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.kv_dtype = kv_dtype
        self.kv_sink_tokens = int(sink)
        self.kv_window_tokens = int(window)
        self.paged_attn = paged_attn
        self.model = model.to(self.device).eval()
        self.cache = PagedKVCache(self.cfg, self.device)
        self.kv_hbm_bytes = kv_cache_bytes(self.cache)
        self.bucket = max(1, min(prefill_bucket, max_len))
        chunk = prefill_chunk if prefill_chunk else self.bucket
        self.chunk = min(self._round_up(chunk, block_size), max_len)
        self._chunks_per_step = max(1, prefill_chunks_per_step)
        self._alloc = BlockAllocator(num_blocks, block_size)
        self._radix = RadixPrefixCache(self._alloc) if prefix_cache else None
        self._tables = np.zeros((num_slots, pages), np.int32)
        self._lengths = np.zeros(num_slots, np.int32)
        self._slot_blocks: list[list[int]] = [[] for _ in range(num_slots)]
        self._admit_order = np.zeros(num_slots, np.int64)
        self._admit_seq = itertools.count(1)
        self._prefilling: dict | None = None
        self._tokens = np.zeros(num_slots, np.int64)
        self._temps = np.zeros(num_slots, np.float32)
        self._top_ks = np.zeros(num_slots, np.int64)
        self._top_ps = np.ones(num_slots, np.float32)
        self._free = list(reversed(range(num_slots)))  # pop() -> slot 0
        self._queue: collections.deque[Request] = collections.deque()
        self._active: dict[int, Request] = {}
        if telemetry is None and telemetry_dir is not None:
            telemetry = ServingTelemetry(telemetry_dir)
        self.telemetry = telemetry
        self.reset_stats()

    # ------------------------------------------------------------------
    # submission

    def submit(self, prompt, *, max_new_tokens: int,
               sampling: SamplingParams | None = None, stop_ids=None,
               on_token=None) -> Request:
        """Queue one request; returns its handle (tokens stream into
        ``handle.new_tokens`` / the on_token callback as the engine
        steps). ``stop_ids`` accepts a single id or a sequence."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must have at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt.size + max_new_tokens > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt_len {prompt.size} + max_new_tokens "
                f"{max_new_tokens} exceeds max_seq_len "
                f"{self.cfg.max_seq_len}")
        req = Request(prompt, max_new_tokens, sampling or SamplingParams(),
                      stop_ids_tuple(stop_ids), on_token)
        req.submit_time = time.perf_counter()
        self._queue.append(req)
        return req

    # ------------------------------------------------------------------
    # the scheduler loop

    def _dev(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    def decode_state(self):
        """The next decode tick's device inputs ``(tables, lengths,
        last_tokens)`` — with ``self.cache`` the whole state a tick reads
        (sampling aside)."""
        return (self._dev(self._tables, torch.int32),
                self._dev(self._lengths, torch.int32),
                self._dev(self._tokens, torch.int64))

    def step(self) -> dict:
        """One scheduler iteration: advance admissions (at most
        ``prefill_chunks_per_step`` chunks once slots are decoding), back
        every active slot's next write with a block, then ONE decode tick
        over all slots; deliver + retire from the synced tokens."""
        admitted = self._paged_admissions()
        decoded = 0
        if self._active:
            self._grow_slots()  # back this tick's write positions
        if self._active:
            uniforms = np.zeros(self.num_slots, np.float32)
            for slot, req in self._active.items():
                uniforms[slot] = req.draw_uniform()
            t0 = time.perf_counter()
            with self._span("serve/decode_tick"):
                nxt, _ = paged_decode_tick(
                    self.model, self.cache, *self.decode_state(),
                    self._dev(uniforms, torch.float32),
                    self._dev(self._temps, torch.float32),
                    self._dev(self._top_ks, torch.int64),
                    self._dev(self._top_ps, torch.float32),
                    candidates=self.candidates)
                toks = nxt.cpu().numpy()  # host sync: streaming delivery
            dt = time.perf_counter() - t0
            st = self._stats
            st["ticks"] += 1
            st["tick_s"] += dt
            st["occupancy_sum"] += len(self._active) / self.num_slots
            used = self._alloc.usable - self._alloc.free_count
            st["block_used_sum"] += used / self._alloc.usable
            st["peak_blocks_used"] = max(st["peak_blocks_used"], used)
            for slot in self._active:
                self._lengths[slot] += 1  # this tick's write landed
            for slot, req in list(self._active.items()):
                self._deliver(req, int(toks[slot]))
                decoded += 1
            st["decode_tokens"] += decoded
            if self.telemetry is not None:
                self.telemetry.tick(
                    tick=st["ticks"], tick_ms=round(dt * 1e3, 3),
                    active=len(self._active), queued=len(self._queue),
                    slot_occupancy=round(decoded / self.num_slots, 4),
                    blocks_used=used, blocks_free=self._alloc.free_count)
        return {"admitted": admitted, "decoded": decoded,
                "active": len(self._active), "queued": len(self._queue)}

    # ------------------------------------------------------------------
    # admission: chunked prefill + prefix reuse + block accounting

    @staticmethod
    def _round_up(n: int, q: int) -> int:
        return -(-n // q) * q

    def _paged_admissions(self) -> int:
        """Advance the admission pipeline: while nothing is decoding,
        push the current prefill to completion and keep admitting; once
        slots are live, spend at most ``prefill_chunks_per_step`` chunk
        calls so resident streams keep ticking between chunks."""
        admitted = chunks = 0
        while True:
            if self._prefilling is None:
                if not (self._queue and self._free):
                    break
                if not self._start_prefill():
                    break  # pool pressure: wait for retirements
            admitted += self._prefill_chunk_step()
            chunks += 1
            if self._active and chunks >= self._chunks_per_step:
                break
        return admitted

    def _alloc_blocks(self, n: int):
        """Allocate n blocks, evicting prefix-cache LRU entries if the
        free list is short — only when eviction can cover the shortfall.
        None when it cannot."""
        fresh = self._alloc.alloc(n)
        if fresh is None and self._radix is not None:
            short = n - self._alloc.free_count
            if self._radix.evictable_count() >= short:
                self._radix.reclaim(short)
                fresh = self._alloc.alloc(n)
        return fresh

    def _start_prefill(self) -> bool:
        """Begin admitting the queue head: match its prompt against the
        radix cache (matched FULL blocks are admitted by reference),
        allocate private blocks for the rest, claim a slot. The last
        prompt token is never taken from the cache: its forward produces
        the logits the first sampled token needs. Returns False when the
        pool cannot back it yet."""
        req = self._queue[0]
        # a preempted request resumes by re-prefilling prompt + what it
        # already generated
        tokens = np.concatenate(
            [req.prompt, np.asarray(req.new_tokens, np.int32)])
        true_len = int(tokens.size)
        bs = self.block_size
        lookup_len = ((true_len - 1) // bs) * bs
        matched = (self._radix.match(tokens[:lookup_len])
                   if self._radix is not None else [])
        for b in matched:  # hold them before eviction can reap them
            self._alloc.incref(b)
        m = len(matched) * bs
        span = min(self._round_up(true_len - m, self.chunk),
                   self.cfg.max_seq_len - m)
        fresh = self._alloc_blocks(self._round_up(span, bs) // bs)
        if fresh is None and not self._active and m:
            # nothing will retire and the shared prefix is squatting the
            # pool: fall back to a full private prefill
            for b in matched:
                self._alloc.decref(b)
            matched, m = [], 0
            if self._radix is not None:
                self._radix.clear()
            span = min(self._round_up(true_len, self.chunk),
                       self.cfg.max_seq_len)
            fresh = self._alloc_blocks(self._round_up(span, bs) // bs)
        if fresh is None:
            for b in matched:
                self._alloc.decref(b)
            return False
        self._queue.popleft()
        if self._radix is not None:  # ONE stat row per landed admission
            self._radix.record_admission(len(matched), lookup_len)
        slot = self._free.pop()
        blocks = matched + fresh
        self._slot_blocks[slot] = blocks
        # the TICK's view of this slot stays all-trash until activation:
        # decode ticks run between prefill chunks, and the mid-prefill
        # slot's garbage tick must write the trash block
        table_row = np.zeros(self.cfg.kv_pages, np.int32)
        table_row[:len(blocks)] = blocks
        req.prefix_hit_tokens += m
        st = self._stats
        st["admissions"] += 1
        st["admitted_tokens"] += true_len
        st["prefix_hit_tokens"] += m
        self._prefilling = dict(req=req, slot=slot, tokens=tokens,
                                true_len=true_len, pos=m,
                                table_row=table_row, first=None)
        return True

    def _prefill_chunk_step(self) -> int:
        """Run ONE chunk of the in-flight admission and, once the prompt
        is covered, activate the slot with the sampled next token.
        Returns 1 on completed admission, else 0."""
        pf = self._prefilling
        req, slot = pf["req"], pf["slot"]
        t0 = time.perf_counter()
        with self._span("serve/prefill"):
            pos = pf["pos"]
            final = pos + self.chunk >= pf["true_len"]
            chunk = np.zeros((1, self.chunk), np.int64)
            n = min(self.chunk, pf["true_len"] - pos)
            chunk[0, :n] = pf["tokens"][pos:pos + n]
            s = req.sampling
            first, _ = paged_prefill_chunk(
                self.model, self.cache, self._dev(chunk, torch.int64), pos,
                self._dev(pf["table_row"], torch.int32), pf["true_len"],
                self._dev(req.draw_uniform() if final else 0.0,
                          torch.float32),
                self._dev(s.temperature, torch.float32),
                self._dev(s.top_k, torch.int64),
                self._dev(s.top_p, torch.float32),
                candidates=self.candidates)
            if final:
                pf["first"] = int(first)  # sync: the TTFT stamp is honest
            pf["pos"] = pos + self.chunk
        now = time.perf_counter()
        st = self._stats
        st["prefill_s"] += now - t0
        st["prefill_chunks"] += 1
        req.prefill_chunks += 1
        if pf["pos"] < pf["true_len"]:
            return 0
        # admission complete: cache the prompt's full blocks, publish the
        # real table to the tick's view, activate the slot
        self._tables[slot, :] = pf["table_row"]
        self._lengths[slot] = pf["true_len"]
        if self._radix is not None:
            nb = pf["true_len"] // self.block_size
            self._radix.insert(pf["tokens"][:nb * self.block_size],
                               self._slot_blocks[slot][:nb])
        self._prefilling = None
        st["prefills"] += 1
        req.slot = slot
        if req.first_token_time is None:
            req.first_token_time = now
            st["ttft_s"].append(now - req.submit_time)
        self._active[slot] = req
        self._admit_order[slot] = next(self._admit_seq)
        self._temps[slot] = req.sampling.temperature
        self._top_ks[slot] = req.sampling.top_k
        self._top_ps[slot] = req.sampling.top_p
        self._deliver(req, pf["first"])
        return 1

    def _grow_slots(self) -> None:
        """Back every active slot's next write position with a physical
        block, oldest admissions first. When the pool is exhausted even
        after prefix-cache eviction, preempt the YOUNGEST resident
        request (free its blocks, requeue it at the front) until the
        older stream can proceed. With a sliding window this is also
        where fully dead middle blocks retire: decref'd back to the
        allocator, their table entry pointed at the trash block and
        their list entry zeroed as a sentinel."""
        bs = self.block_size
        win, sink = self.kv_window_tokens, self.kv_sink_tokens
        for slot in sorted(self._active,
                           key=lambda s: self._admit_order[s]):
            if slot not in self._active:
                continue  # preempted by an older slot's growth
            blocks = self._slot_blocks[slot]
            if win:
                qlo = int(self._lengths[slot])  # this tick's query
                for bi in range(sink // bs, len(blocks)):
                    if (bi + 1) * bs > qlo - win + 1:
                        break  # first live block; younger ones follow
                    if blocks[bi]:
                        self._alloc.decref(blocks[bi])
                        blocks[bi] = 0
                        self._tables[slot, bi] = 0
                        self._stats["retired_blocks"] += 1
            bi = min(int(self._lengths[slot]),
                     self.cfg.max_seq_len - 1) // bs
            while bi >= len(blocks):
                fresh = self._alloc_blocks(1)
                if fresh is not None:
                    self._tables[slot, len(blocks)] = fresh[0]
                    blocks.append(fresh[0])
                    continue
                victim = max(self._active,
                             key=lambda s: self._admit_order[s])
                self._preempt(victim)
                if victim == slot:
                    break  # this very request went back to the queue

    def _preempt(self, slot: int) -> None:
        req = self._active.pop(slot)
        self._release_slot(slot)
        req.slot = None
        req.preemptions += 1
        self._stats["preemptions"] += 1
        self._queue.appendleft(req)

    def _release_slot(self, slot: int) -> None:
        """Return a slot's blocks to the pool (radix-cached blocks
        survive via the cache's own reference) and point its table at
        the trash block. Zero entries are window-retirement sentinels —
        those references were already returned mid-stream."""
        for b in self._slot_blocks[slot]:
            if b:
                self._alloc.decref(b)
        self._slot_blocks[slot] = []
        self._tables[slot, :] = 0
        self._lengths[slot] = 0
        self._free.append(slot)
        self._temps[slot] = 0.0

    # ------------------------------------------------------------------
    # driving helpers

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        """Step until queue, in-flight prefill and slots drain."""
        while self._queue or self._active or self._prefilling is not None:
            if max_steps <= 0:
                raise RuntimeError("serving loop did not drain")
            self.step()
            max_steps -= 1

    def stream(self, req: Request):
        """Iterator over one request's tokens, stepping the engine (and
        every other resident request) as needed."""
        sent = 0
        while True:
            while sent < len(req.new_tokens):
                yield req.new_tokens[sent]
                sent += 1
            if req.done:
                return
            self.step()

    def warmup(self, prompt_lens=None, max_new_tokens: int = 2) -> None:
        """Run dummy requests through each prompt length and the decode
        tick — the kernel's build and load, the first cuBLAS and
        allocator work — then flush the prefix cache and reset stats, so
        the first real TTFT pays none of it."""
        lens = tuple(prompt_lens) if prompt_lens else (self.bucket,)
        for n in lens:
            n = max(1, min(n, self.cfg.max_seq_len - max_new_tokens))
            self.submit(np.zeros(n, np.int32), max_new_tokens=max_new_tokens)
            self.run_until_idle()
        if self._radix is not None:
            self._radix.clear()  # don't serve real traffic warmup zeros
            self._radix.reset_stats()
        self.reset_stats()

    def drain(self) -> list[Request]:
        """Retire EVERY request — queued, mid-prefill, resident — with
        finish_reason "drained" and free their slots/blocks."""
        out: list[Request] = []
        if self._prefilling is not None:
            pf, self._prefilling = self._prefilling, None
            self._release_slot(pf["slot"])
            out.append(pf["req"])
        while self._queue:
            out.append(self._queue.popleft())
        out.extend(self._active.values())
        with self._span("serve/drain"):
            for req in out:
                self._retire(req, "drained")
        return out

    def close(self) -> None:
        """Drain outstanding work, assert the pool's leak invariant
        (free + resident == pool: every retirement path returned its
        blocks), and flush telemetry."""
        self.drain()
        if self.telemetry is not None:
            st = self._stats
            per_block = self.kv_hbm_bytes // self.num_blocks
            self.telemetry.pool(
                kv_hbm_bytes=self.kv_hbm_bytes, block_size=self.block_size,
                num_blocks=self.num_blocks, kv_dtype=self.kv_dtype,
                kv_bytes_resident=st["peak_blocks_used"] * per_block,
                kv_tokens_capacity=self._alloc.usable * self.block_size,
                retired_blocks=st["retired_blocks"],
                prefill_chunks=st["prefill_chunks"],
                preemptions=st["preemptions"],
                prefix_hit_tokens=st["prefix_hit_tokens"],
                admitted_tokens=st["admitted_tokens"],
                **(self._radix.stats() if self._radix is not None else {}))
        cached = self._radix.block_count if self._radix is not None else 0
        self._alloc.check_leaks(expected_resident=cached)
        if self._radix is not None:
            self._radix.clear()
        self._alloc.check_leaks(0)
        if self.telemetry is not None:
            self.telemetry.close()

    # ------------------------------------------------------------------
    # internals

    def _span(self, name: str):
        return (self.telemetry.span(name) if self.telemetry is not None
                else contextlib.nullcontext())

    def _deliver(self, req: Request, tok: int) -> None:
        req.new_tokens.append(tok)
        self._tokens[req.slot] = tok  # next tick's input for this slot
        if req.on_token is not None:
            req.on_token(req, tok)
        if tok in req.stop_ids:
            self._retire(req, "stop")
        elif len(req.new_tokens) >= req.max_new_tokens:
            self._retire(req, "length")

    def _retire(self, req: Request, reason: str) -> None:
        req.done = True
        req.finish_reason = reason
        req.finish_time = time.perf_counter()
        if req.slot is not None and self._active.get(req.slot) is req:
            del self._active[req.slot]
            # EVERY retirement path funnels here: the slot's blocks go
            # back to the pool — close() asserts none leak
            self._release_slot(req.slot)
        self._stats["completed"] += 1
        if self.telemetry is not None:
            self.telemetry.request(req)

    # ------------------------------------------------------------------
    # stats

    def reset_stats(self) -> None:
        self._stats = dict(ticks=0, tick_s=0.0, prefills=0, prefill_s=0.0,
                           decode_tokens=0, occupancy_sum=0.0, completed=0,
                           ttft_s=[], admissions=0, admitted_tokens=0,
                           prefix_hit_tokens=0, prefill_chunks=0,
                           preemptions=0, block_used_sum=0.0,
                           peak_blocks_used=0, retired_blocks=0)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def active_count(self) -> int:
        return len(self._active)

    @property
    def prefilling_count(self) -> int:
        return int(self._prefilling is not None)

    def summary(self) -> dict:
        """Aggregate serving metrics since the last reset_stats():
        decode tokens/s (decoded tokens over tick wall time, prefills
        excluded), TTFT percentiles, mean tick time and slot occupancy,
        and the pool's counters."""
        st = self._stats
        ttfts = np.asarray(st["ttft_s"], np.float64)
        out = {
            "requests_completed": st["completed"],
            "ticks": st["ticks"],
            "prefills": st["prefills"],
            "decode_tokens": st["decode_tokens"],
            "decode_tokens_per_s": (
                round(st["decode_tokens"] / st["tick_s"], 1)
                if st["tick_s"] > 0 else None),
            "tick_ms_mean": (round(st["tick_s"] / st["ticks"] * 1e3, 3)
                             if st["ticks"] else None),
            "slot_occupancy": (
                round(st["occupancy_sum"] / st["ticks"], 4)
                if st["ticks"] else None),
            "prefill_ms_mean": (
                round(st["prefill_s"] / st["prefill_chunks"] * 1e3, 3)
                if st["prefill_chunks"] else None),
        }
        if ttfts.size:
            out["ttft_ms_p50"] = round(
                float(np.percentile(ttfts, 50)) * 1e3, 3)
            out["ttft_ms_p99"] = round(
                float(np.percentile(ttfts, 99)) * 1e3, 3)
        out.update(
            kv_hbm_bytes=self.kv_hbm_bytes, block_size=self.block_size,
            num_blocks=self.num_blocks, kv_dtype=self.kv_dtype,
            kv_tokens_capacity=self._alloc.usable * self.block_size,
            kv_bytes_resident=(st["peak_blocks_used"]
                               * (self.kv_hbm_bytes // self.num_blocks)),
            peak_blocks_used=st["peak_blocks_used"],
            retired_blocks=st["retired_blocks"],
            paged_attn=self.paged_attn,
            prefill_chunks=st["prefill_chunks"],
            preemptions=st["preemptions"],
            block_utilization=(round(st["block_used_sum"] / st["ticks"], 4)
                               if st["ticks"] else None),
            prefix_hit_rate=(round(st["prefix_hit_tokens"]
                                   / st["admitted_tokens"], 4)
                             if st["admitted_tokens"] else None),
            prefix_hit_tokens=st["prefix_hit_tokens"],
            admitted_tokens=st["admitted_tokens"])
        if self.kv_window_tokens:
            out["kv_window_tokens"] = self.kv_window_tokens
            out["kv_sink_tokens"] = self.kv_sink_tokens
        if self._radix is not None:
            out["prefix_cache"] = self._radix.stats()
        return out
