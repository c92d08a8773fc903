"""Transformer core of the port — the GPT-2 dialect, with the paged KV
pool the serving engine decodes from.

PyTorch counterpart of ``pytorchdistributed_tpu/models/transformer.py``,
limited to what GPT-2 uses: pre-LN blocks, LayerNorm computed in fp32,
the GELU MLP, a fused qkv projection, learned positions and tied
embeddings. Parameters live in ``param_dtype`` (fp32) and are cast to the
compute ``dtype`` (bf16 by default) at each use, as the reference does.

Two forward modes, one set of weights:

  * no cache — the plain causal forward over ``[b, s]`` tokens
    (positions 0..s-1), differentiable: the training forward. Its
    attention is ``cfg.attention``: "dense" (``ops.attention``),
    "pallas" (the flash kernels of ``ops.flash_attention``; the name is
    the reference's, so a config carries across unchanged) or "ring"
    (``ops.ring_attention`` over the ambient mesh's "seq" axis);
  * ``cache=PagedKVCache, tables, lengths`` — the serving decode: row r
    sits at absolute positions ``lengths[r] + [0, s)``, its K/V are
    scattered into the pool blocks ``tables[r, pos // block_size]`` at
    offset ``pos % block_size`` (positions past the context go to the
    trash block 0), then attention reads the pool: a single-token tick
    (``s == 1``) on the paged kernel when ``paged_attn == "pallas"``,
    everything else on the gather tail. The pool is updated in place;
    the position counter is the caller's ``lengths``, which the engine
    advances on the host.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from pytorchdistributed_tpu_torch.ops.attention import (
    dense_attention,
    paged_gather,
)

# attention backends of the reference that the port does not run yet,
# with the ROADMAP item that ports them
_NOT_PORTED_ATTENTION = {
    "ulysses": "ROADMAP Queue 1 item 9 (context parallelism: Ulysses)",
}
_ATTENTION = ("dense", "pallas", "ring")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    num_layers: int = 12
    embed_dim: int = 768
    num_heads: int = 12
    mlp_dim: int | None = None          # default 4*embed_dim
    max_seq_len: int = 1024
    causal: bool = True
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32
    norm_eps: float = 1e-6
    # tanh approximation (GPT-2's "gelu_new") vs exact erf
    gelu_approximate: bool = True
    use_bias: bool = True
    tie_embeddings: bool = True
    # Cache-free forward: attention backend ("dense" | "pallas" | "ring",
    # the reference's names) and the flash/ring block size (block_q =
    # block_k; None keeps each kernel's default). Only dropout_rate 0
    # runs.
    attention: str = "dense"
    attn_block: int | None = None
    dropout_rate: float = 0.0
    # Paged serving decode (serving/engine.py). decode_slots is the
    # engine's batch of resident requests; the pool holds kv_blocks
    # blocks of kv_block_size tokens (block 0 is the reserved trash
    # block) stored in the model dtype ("bf16") or as int8 codes with
    # fp32 per-(token, head) scales ("int8"). kv_window_tokens > 0 turns
    # on sink + sliding-window attention: position j is attendable by
    # the query at p iff j < kv_sink_tokens or j > p - kv_window_tokens.
    # paged_attn picks the decode tick's read: "pallas" (the paged
    # attention kernel straight over the pool; the name is the
    # reference's, and "kernel" is accepted as an alias of it) or
    # "gather" (reassemble the pages, then the masked dense tail).
    decode_slots: int = 0
    kv_block_size: int = 0
    kv_blocks: int = 0
    kv_dtype: str = "bf16"              # bf16 | int8
    kv_sink_tokens: int = 0
    kv_window_tokens: int = 0
    paged_attn: str = "gather"          # gather | pallas

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_heads

    @property
    def ffn_dim(self) -> int:
        return self.mlp_dim if self.mlp_dim is not None else 4 * self.embed_dim

    @property
    def kv_pages(self) -> int:
        """Block-table width: blocks backing one full-context slot."""
        if not self.kv_block_size:
            return 0
        return self.max_seq_len // self.kv_block_size

    def __post_init__(self):
        if self.attention in _NOT_PORTED_ATTENTION:
            raise NotImplementedError(
                f"attention={self.attention!r} is not ported yet: "
                f"{_NOT_PORTED_ATTENTION[self.attention]}")
        if self.attention not in _ATTENTION:
            raise ValueError(f"unknown attention backend "
                             f"{self.attention!r}; one of {_ATTENTION}")
        if self.dropout_rate > 0:
            raise NotImplementedError(
                f"dropout_rate {self.dropout_rate} is not ported yet "
                f"(only 0 runs): ROADMAP Queue 1 item 3 (dropout)")
        if self.embed_dim % self.num_heads:
            raise ValueError(f"embed_dim {self.embed_dim} not divisible by "
                             f"num_heads {self.num_heads}")
        if self.decode_slots < 0:
            raise ValueError(f"decode_slots {self.decode_slots} must be >= 0")
        if self.kv_block_size < 0 or self.kv_blocks < 0:
            raise ValueError("kv_block_size / kv_blocks must be >= 0")
        if self.kv_block_size > 0:
            if self.decode_slots < 1:
                raise ValueError(
                    "paged KV (kv_block_size > 0) requires decode_slots >= 1 "
                    "(the serving engine owns the slots)")
            if self.max_seq_len % self.kv_block_size:
                raise ValueError(
                    f"max_seq_len {self.max_seq_len} must be a multiple of "
                    f"kv_block_size {self.kv_block_size}")
            if self.kv_blocks < 2:
                raise ValueError(
                    f"kv_blocks {self.kv_blocks} must be >= 2 (block 0 is "
                    f"the reserved trash block)")
        if self.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r}; "
                             f"one of ('bf16', 'int8')")
        if self.paged_attn == "kernel":
            object.__setattr__(self, "paged_attn", "pallas")
        if self.paged_attn not in ("gather", "pallas"):
            raise ValueError(f"unknown paged_attn {self.paged_attn!r}; "
                             f"one of ('gather', 'pallas')")
        if self.paged_attn == "pallas" and not self.kv_block_size:
            raise ValueError("paged_attn='pallas' requires the paged KV "
                             "pool (kv_block_size > 0)")
        if self.kv_sink_tokens < 0 or self.kv_window_tokens < 0:
            raise ValueError("kv_sink_tokens / kv_window_tokens must be "
                             ">= 0")
        if self.kv_sink_tokens and not self.kv_window_tokens:
            raise ValueError("kv_sink_tokens needs kv_window_tokens > 0")
        if self.kv_window_tokens:
            if not self.kv_block_size:
                raise ValueError("sliding-window KV requires the paged pool "
                                 "(kv_block_size > 0)")
            if (self.kv_window_tokens % self.kv_block_size
                    or self.kv_sink_tokens % self.kv_block_size):
                raise ValueError(
                    f"kv_window_tokens {self.kv_window_tokens} and "
                    f"kv_sink_tokens {self.kv_sink_tokens} must be "
                    f"multiples of kv_block_size {self.kv_block_size}")


class PagedKVCache:
    """The serving engine's KV state: one block pool per layer,
    ``[kv_blocks, kv_block_size, kv_heads, head_dim]`` K and V (model
    dtype, or int8 plus ``[kv_blocks, kv_block_size, kv_heads]`` fp32
    scale planes), and the config whose paging fields the attention
    layers read. Pools carry no slot dimension: which blocks a request
    owns is the caller's block table."""

    def __init__(self, cfg: TransformerConfig, device):
        if not cfg.kv_block_size:
            raise ValueError("PagedKVCache needs cfg.kv_block_size > 0")
        self.cfg = cfg
        shape = (cfg.kv_blocks, cfg.kv_block_size, cfg.kv_heads,
                 cfg.head_dim)
        int8 = cfg.kv_dtype == "int8"
        pool_dtype = torch.int8 if int8 else cfg.dtype

        def zeros(shp, dt):
            return [torch.zeros(shp, dtype=dt, device=device)
                    for _ in range(cfg.num_layers)]

        self.k = zeros(shape, pool_dtype)
        self.v = zeros(shape, pool_dtype)
        self.k_scale = zeros(shape[:-1], torch.float32) if int8 else None
        self.v_scale = zeros(shape[:-1], torch.float32) if int8 else None

    def tensors(self) -> list[torch.Tensor]:
        out = self.k + self.v
        if self.k_scale is not None:
            out += self.k_scale + self.v_scale
        return out

    def clone(self) -> "PagedKVCache":
        """A copy of every pool (comparisons from one cache state)."""
        new = object.__new__(PagedKVCache)
        new.cfg = self.cfg
        new.k = [t.clone() for t in self.k]
        new.v = [t.clone() for t in self.v]
        new.k_scale = (None if self.k_scale is None
                       else [t.clone() for t in self.k_scale])
        new.v_scale = (None if self.v_scale is None
                       else [t.clone() for t in self.v_scale])
        return new


@dataclasses.dataclass
class PagedView:
    """One paged forward call's addressing: the cache, ``tables [b,
    kv_pages]`` int32 and ``lengths [b]`` int32 (the absolute position of
    each row's first token)."""

    cache: PagedKVCache
    tables: torch.Tensor
    lengths: torch.Tensor


class Dense(nn.Linear):
    """nn.Linear whose fp32 parameters are cast to the compute dtype at
    use (the reference's ``kernel.astype(cfg.dtype)``)."""

    def __init__(self, in_features, out_features, *, bias: bool, dtype):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class LayerNorm(nn.Module):
    """LayerNorm normalized in fp32 whatever the compute dtype, with the
    reference's spelling: var = E[x²] - E[x]², (x - mean) * rsqrt(var +
    eps) * scale + bias. Returns fp32."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight.float() + self.bias.float()


def _layer_norm(cfg: TransformerConfig) -> LayerNorm:
    return LayerNorm(cfg.embed_dim, cfg.norm_eps)


class MlpBlock(nn.Module):
    """wi (embed→ffn), GELU, wo (ffn→embed)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.wi = Dense(cfg.embed_dim, cfg.ffn_dim, bias=cfg.use_bias,
                        dtype=cfg.dtype)
        self.wo = Dense(cfg.ffn_dim, cfg.embed_dim, bias=cfg.use_bias,
                        dtype=cfg.dtype)

    def forward(self, x):
        h = F.gelu(self.wi(x),
                   approximate="tanh" if self.cfg.gelu_approximate
                   else "none")
        return self.wo(h)


def _attention_fn(kind: str):
    """The cache-free attention backend ``kind`` names."""
    if kind == "pallas":
        from pytorchdistributed_tpu_torch.ops.flash_attention import (
            flash_attention,
        )

        return flash_attention
    if kind == "ring":
        from pytorchdistributed_tpu_torch.ops.ring_attention import (
            ring_attention_sharded,
        )

        return ring_attention_sharded
    return dense_attention


class SelfAttention(nn.Module):
    """Multi-head self-attention with one fused ``qkv`` projection
    (weight rows ordered q, k, v — each ``heads·head_dim`` wide)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        e = cfg.num_heads * cfg.head_dim
        self.qkv = Dense(cfg.embed_dim, 3 * e, bias=cfg.use_bias,
                         dtype=cfg.dtype)
        self.out = Dense(e, cfg.embed_dim, bias=cfg.use_bias,
                         dtype=cfg.dtype)

    def forward(self, x, layer: int = 0, paged: PagedView | None = None):
        cfg = self.cfg
        b, s, _ = x.shape
        fused = self.qkv(x).view(b, s, 3, cfg.num_heads, cfg.head_dim)
        q, k, v = fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]
        if paged is None:
            rep = cfg.num_heads // cfg.kv_heads
            if rep > 1 and cfg.attention != "pallas":
                # dense and ring take K/V at the full head count; the
                # flash kernels read each group's shared K/V themselves
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            # flash and ring take the block knobs; dense has no blocks
            kw = ({} if cfg.attn_block is None or cfg.attention == "dense"
                  else dict(block_q=cfg.attn_block, block_k=cfg.attn_block))
            out = _attention_fn(cfg.attention)(q, k, v, causal=cfg.causal,
                                               **kw)
        else:
            out = self._paged(q, k, v, layer, paged)
        return self.out(out.reshape(b, s, cfg.num_heads * cfg.head_dim))

    def _paged(self, q, k, v, layer, paged: PagedView):
        cfg = self.cfg
        pc = paged.cache.cfg
        cache = paged.cache
        bs = pc.kv_block_size
        b, s = q.shape[:2]
        dev = q.device
        idx = paged.lengths.long()
        tables = paged.tables
        # scatter each row's s tokens into its table's blocks; positions
        # past the context (padded prefill tails) drop into the trash
        # block 0 instead of clamping onto a live row
        pos = idx[:, None] + torch.arange(s, device=dev)          # [b, s]
        inb = (pos // bs).clamp(0, pc.kv_pages - 1)
        blk = torch.take_along_dim(tables.long(), inb, dim=1)
        blk = torch.where(pos < pc.max_seq_len, blk, 0)
        off = pos % bs
        kc_pool, vc_pool = cache.k[layer], cache.v[layer]
        if pc.kv_dtype == "int8":
            from pytorchdistributed_tpu_torch.ops.quant import kv_quantize

            qk, sk = kv_quantize(k)
            qv, sv = kv_quantize(v)
            kc_pool[blk, off] = qk
            vc_pool[blk, off] = qv
            cache.k_scale[layer][blk, off] = sk
            cache.v_scale[layer][blk, off] = sv
            ks, vs = cache.k_scale[layer], cache.v_scale[layer]
        else:
            kc_pool[blk, off] = k.to(cfg.dtype)
            vc_pool[blk, off] = v.to(cfg.dtype)
            ks = vs = None
        if pc.paged_attn == "pallas" and s == 1:
            # decode tick: q attends the pool straight through the block
            # table; the gathered copy below never materializes
            from pytorchdistributed_tpu_torch.ops.paged_attention import (
                paged_flash_attention,
            )

            return paged_flash_attention(
                q[:, 0].contiguous(), kc_pool, vc_pool, tables,
                paged.lengths, k_scale=ks, v_scale=vs,
                sink_tokens=pc.kv_sink_tokens,
                window_tokens=pc.kv_window_tokens)[:, None].to(cfg.dtype)
        # gather tail: reassemble the attended pages in position order,
        # then the masked dense attention with fp32 softmax
        kc = paged_gather(kc_pool, tables)
        vc = paged_gather(vc_pool, tables)
        if pc.kv_dtype == "int8":
            from pytorchdistributed_tpu_torch.ops.quant import kv_dequantize

            kc = kv_dequantize(kc, paged_gather(ks, tables), cfg.dtype)
            vc = kv_dequantize(vc, paged_gather(vs, tables), cfg.dtype)
        attend = kc.shape[1]
        j = torch.arange(attend, device=dev)
        valid = j <= pos[..., None]                            # [b, s, j]
        if pc.kv_window_tokens:
            valid &= ((j < pc.kv_sink_tokens)
                      | (j > pos[..., None] - pc.kv_window_tokens))
        scores = torch.einsum("bihd,bjhd->bhij", q.float(), kc.float())
        scores = scores / torch.tensor(math.sqrt(cfg.head_dim),
                                       dtype=torch.float32)
        scores = scores.masked_fill(~valid[:, None], float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhij,bjhd->bihd", probs.to(cfg.dtype).float(),
                           vc.float())
        return out.to(cfg.dtype)


class TransformerBlock(nn.Module):
    """Pre-LN block: x + Attn(LN(x)); x + MLP(LN(x))."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _layer_norm(cfg)
        self.attn = SelfAttention(cfg)
        self.ln2 = _layer_norm(cfg)
        self.mlp = MlpBlock(cfg)

    def forward(self, x, layer: int = 0, paged: PagedView | None = None):
        dt = self.cfg.dtype
        x = x + self.attn(self.ln1(x).to(dt), layer, paged)
        return x + self.mlp(self.ln2(x).to(dt))


class TransformerStack(nn.Module):
    """``num_layers`` blocks, unrolled (the reference's
    ``scan_layers=False`` layout: block i is ``blocks.{i}``)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.blocks = nn.ModuleList(
            TransformerBlock(cfg) for _ in range(cfg.num_layers))

    def forward(self, x, paged: PagedView | None = None):
        for i, block in enumerate(self.blocks):
            x = block(x, i, paged)
        return x


class Embedder(nn.Module):
    """Token + learned positional embeddings; ``attend`` is the tied
    logit projection (GPT-2 weight tying)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.tok = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        self.pos = nn.Parameter(torch.zeros(cfg.max_seq_len, cfg.embed_dim))

    def forward(self, tokens, lengths=None):
        """``lengths`` (``[b]``) offsets each row's positions (serving
        decode); None starts every row at 0. Positions past the table
        clamp to its last row, as the reference's gather does."""
        dt = self.cfg.dtype
        x = self.tok.weight[tokens.long()].to(dt)
        s = tokens.shape[1]
        if lengths is None:
            return x + self.pos[:s].to(dt)
        pos = lengths.long()[:, None] + torch.arange(s, device=tokens.device)
        pos = pos.clamp_max(self.cfg.max_seq_len - 1)
        return x + self.pos[pos].to(dt)

    def attend(self, x):
        dt = self.cfg.dtype
        return x.to(dt) @ self.tok.weight.to(dt).T


class LMHead(nn.Module):
    """Untied logit projection ``[embed] → [vocab]``."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.proj = Dense(cfg.embed_dim, cfg.vocab_size, bias=False,
                          dtype=cfg.dtype)

    def forward(self, x):
        return self.proj(x)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random init in the reference's shapes and scales: normal(0,
    0.02) kernels, embeddings and positions, zero biases, unit LayerNorm
    scales. Draws on the CPU, so a seed gives the same weights on any
    device."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if isinstance(_owner(model, name), LayerNorm):
            fill = torch.ones if name.endswith("weight") else torch.zeros
            p.copy_(fill(p.shape))
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.copy_(torch.empty(p.shape).normal_(0.0, 0.02, generator=gen))
    return model


def _owner(model: nn.Module, name: str) -> nn.Module:
    return model.get_submodule(name.rsplit(".", 1)[0]) if "." in name \
        else model
