"""Model assembly: one TransformerLM covering all 10 architectures, in
PyTorch.

Twin of ``repro/models/transformer.py``. The JAX package stacks the
layers as scanned ``units`` of ``unit_spec(cfg)`` blocks (jamba: 8 layers,
7 mamba + 1 attention); here :class:`TransformerLM` holds one
``ParameterDict`` per layer in a ``ModuleList`` and the entry points loop
over it. Layer ``u·P + i`` is block ``i`` of unit ``u`` (``P`` the unit
period). Entry points:

  forward     — the full sequence, no cache: (logits, MoE aux loss)
  prefill     — forward over the prompt + a cache padded to ``max_len``
  decode      — one-token step against the cache (serve_step), in place
  paged_step  — decode or a prefill chunk against the paged pool, in place

A cache is one flat dict of leaves by name, each stacked over the layers
that hold it: attention layers ``{"k", "v"}`` (int8: also ``"k_scale"``,
``"v_scale"``) or MLA's ``{"c_kv", "k_rope"}``, SSM layers ``{"conv",
"state"}``. The dense cache's leaves are (layers_of_kind, batch, ...),
the paged cache's attention leaves (layers_of_kind, num_pages, page_len,
...) and its SSM leaves (layers_of_kind, max_slots + 1, ...). Axis 1 is
the slot axis of every dense leaf and of every slot-resident leaf.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

#: cache leaves whose axis 2 (axis 1 per layer) is the sequence axis; SSM
#: leaves (conv, state) are sequence-length-independent
_SEQ_CACHE_LEAVES = frozenset({"k", "v", "c_kv", "k_rope",
                              "k_scale", "v_scale"})
#: cache leaves that live in the paged pool; the rest are slot-resident
PAGED_LEAVES = frozenset({"k", "v", "c_kv", "k_rope"})

# ---------------------------------------------------------------------------
# layer-stack spec
# ---------------------------------------------------------------------------


def unit_spec(cfg: ModelConfig) -> list[tuple[str, str]]:
    """(block_kind, ffn_kind) for each layer inside one unit."""
    period = cfg.attn_period if cfg.family == "hybrid" else 1
    return list(zip(cfg.layer_kinds()[:period], cfg.ffn_kinds()[:period]))


def num_units(cfg: ModelConfig) -> int:
    period = len(unit_spec(cfg))
    assert cfg.num_layers % period == 0
    return cfg.num_layers // period


def layer_plan(cfg: ModelConfig) -> list[tuple[str, str, int]]:
    """(block_kind, ffn_kind, row) of every layer: ``row`` indexes the
    layer in the cache leaves of its kind."""
    spec = unit_spec(cfg) * num_units(cfg)
    seen = {"attn": 0, "ssm": 0}
    plan = []
    for kind, ffn in spec:
        plan.append((kind, ffn, seen[kind]))
        seen[kind] += 1
    return plan


def _has_ffn(cfg: ModelConfig, kind: str) -> bool:
    """Attention blocks carry an FFN; jamba's SSM blocks do too."""
    return kind == "attn" or cfg.family == "hybrid"


def _leaf_names(cfg: ModelConfig, kind: str) -> tuple[str, ...]:
    if kind == "ssm":
        return ("conv", "state")
    if cfg.use_mla:
        return ("c_kv", "k_rope")
    if cfg.kv_cache_dtype == "int8":
        return ("k", "v", "k_scale", "v_scale")
    return ("k", "v")


class TransformerLM(nn.Module):
    """The parameters: ``embed`` (vocab, d), ``final_norm`` (d,), ``head``
    (d, vocab; None with tied embeddings), the front end's
    ``frontend_w1``/``frontend_b`` (and ``frontend_w2`` for vision) in
    ``frontend``, and ``blocks[i]`` holding layer i's parameters by the
    reference's names. Serving only: no parameter asks for a gradient."""

    def __init__(self, cfg: ModelConfig, *, embed: torch.Tensor,
                 final_norm: torch.Tensor, head: torch.Tensor | None,
                 blocks: list[dict[str, torch.Tensor]],
                 frontend: dict[str, torch.Tensor] | None = None):
        super().__init__()
        if len(blocks) != cfg.num_layers:
            raise ValueError(f"{len(blocks)} blocks for {cfg.num_layers} layers")
        for i, ((kind, ffn, _), b) in enumerate(zip(layer_plan(cfg), blocks)):
            want = block_param_names(cfg, kind, ffn)
            if set(b) != want:
                raise ValueError(f"block {i} ({kind}/{ffn}) holds "
                                 f"{sorted(b)}, not {sorted(want)}")
        if (head is None) != cfg.tie_embeddings:
            raise ValueError("head is None exactly when embeddings are tied")
        frontend = dict(frontend or {})
        if set(frontend) != frontend_param_names(cfg):
            raise ValueError(f"front end holds {sorted(frontend)}, not "
                             f"{sorted(frontend_param_names(cfg))}")
        fixed = lambda t: nn.Parameter(t, requires_grad=False)
        self.embed = fixed(embed)
        self.final_norm = fixed(final_norm)
        self.head = None if head is None else fixed(head)
        self.frontend = nn.ParameterDict(
            {n: fixed(t) for n, t in frontend.items()})
        self.blocks = nn.ModuleList(
            nn.ParameterDict({n: fixed(t) for n, t in b.items()})
            for b in blocks)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_block(cfg: ModelConfig, kind: str, ffn: str, generator,
                device) -> dict[str, torch.Tensor]:
    if kind == "attn":
        p = (L.init_mla(cfg, generator, device) if cfg.use_mla
             else L.init_attention(cfg, generator, device))
    else:
        p = S.init_ssm(cfg, generator, device)
    if _has_ffn(cfg, kind):
        p.update(L.init_moe(cfg, generator, device) if ffn == "moe"
                 else L.init_ffn(cfg, generator, device))
    return p


@functools.lru_cache(maxsize=None)
def block_param_names(cfg: ModelConfig, kind: str, ffn: str) -> frozenset:
    """The parameter names of one block (from ``meta`` tensors)."""
    return frozenset(_init_block(cfg, kind, ffn, None, "meta"))


def frontend_param_names(cfg: ModelConfig) -> frozenset:
    if cfg.frontend is None:
        return frozenset()
    names = {"frontend_w1", "frontend_b"}
    if cfg.frontend == "vision":
        names.add("frontend_w2")
    return frozenset(names)


def init_params(cfg: ModelConfig, generator: torch.Generator | None,
                device: str | torch.device | None = None) -> TransformerLM:
    """Random weights by the JAX package's laws: f32 normal times
    ``scale_dim ** -0.5``, cast to ``param_dtype``; norms are ones, the
    router f32, and the SSM's A_log, D and dt_bias its fixed f32 values.

    Made layer by layer on ``device`` (``cuda`` unless named), so one
    matrix's f32 temporary exists at a time. ``generator`` must live on
    that device (None on ``meta``, which makes only the shapes). The
    numbers differ from ``jax.random``'s: parity tests convert JAX
    weights instead (:func:`repro_torch.models.convert.params_from_jax`)."""
    dev = resolve_device(device)
    pd = cfg.parameter_dtype
    d, vocab = cfg.d_model, cfg.vocab_size
    embed = L._init(generator, (vocab, d), d, pd, dev)
    blocks = [_init_block(cfg, kind, ffn, generator, dev)
              for kind, ffn, _ in layer_plan(cfg)]
    head = (None if cfg.tie_embeddings
            else L._init(generator, (d, vocab), d, pd, dev))
    frontend = {}
    if cfg.frontend is not None:
        frontend["frontend_w1"] = L._init(generator, (cfg.frontend_dim, d),
                                          cfg.frontend_dim, pd, dev)
        frontend["frontend_b"] = torch.zeros((d,), dtype=pd, device=dev)
        if cfg.frontend == "vision":
            frontend["frontend_w2"] = L._init(generator, (d, d), d, pd, dev)
    return TransformerLM(cfg, embed=embed,
                         final_norm=torch.ones((d,), dtype=pd, device=dev),
                         head=head, blocks=blocks, frontend=frontend)


@functools.lru_cache(maxsize=None)
def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters :func:`init_params` makes, counted on the ``meta``
    device (no storage; the JAX package traces its init for this). With
    ``active_only`` an MoE model counts ``max(1, top_k)`` experts, the
    ones a token touches."""
    if active_only and cfg.is_moe:
        cfg = dataclasses.replace(cfg, num_experts=max(1, cfg.top_k))
    return sum(p.numel() for p in init_params(cfg, None, "meta").parameters())


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _apply_block(p, x, cfg: ModelConfig, kind: str, ffn: str, *, positions,
                 cache, cache_index, page_table=None, slot_ids=None,
                 seq_lens=None):
    aux = torch.zeros((), device=x.device)
    if kind == "attn":
        fn = L.apply_mla if cfg.use_mla else L.apply_attention
        x, new_cache = fn(p, x, cfg, positions=positions, cache=cache,
                          cache_index=cache_index, page_table=page_table)
    else:
        x, new_cache = S.apply_ssm(p, x, cfg, cache=cache,
                                   cache_index=cache_index,
                                   slot_ids=slot_ids, seq_lens=seq_lens)
    if _has_ffn(cfg, kind):
        if ffn == "moe":
            x, aux = L.apply_moe_block(p, x, cfg)
        else:
            x = L.apply_dense_block(p, x, cfg)
    return x, new_cache, aux


def _layer_cache(cfg: ModelConfig, cache: dict, kind: str, row: int) -> dict:
    """Views of one layer's leaves (writes land in ``cache``)."""
    return {name: cache[name][row] for name in _leaf_names(cfg, kind)
            if name in cache}


def _embed_inputs(params: TransformerLM, cfg: ModelConfig,
                  batch: dict) -> torch.Tensor:
    """tokens and/or front-end embeddings -> (B, S, d) activations; the
    vision front end's patches come before the text."""
    dev = params.embed.device
    fe = params.frontend

    def project(x):
        """x @ frontend_w1 + frontend_b in the promoted type, as JAX
        promotes (bf16 frames on f32 weights compute in f32)."""
        w = fe["frontend_w1"]
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(device=dev, dtype=dt) @ w.to(dt) + fe["frontend_b"]

    parts = []
    if cfg.frontend == "audio" and "frames" in batch:
        parts.append(project(batch["frames"]).to(cfg.activation_dtype))
    elif cfg.frontend == "vision" and "patches" in batch:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(project(batch["patches"]), approximate="tanh")
        parts.append((h @ fe["frontend_w2"]).to(cfg.activation_dtype))
    if "tokens" in batch:
        parts.append(params.embed[batch["tokens"].to(dev)].to(
            cfg.activation_dtype))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def rms_final(params: TransformerLM, cfg: ModelConfig, x):
    return L.rms_norm(x, params.final_norm, cfg.norm_eps)


def head_logits(params: TransformerLM, cfg: ModelConfig, x):
    """f32 logits from f32 operands (TF32 stays off on CUDA)."""
    w = params.embed.T if cfg.tie_embeddings else params.head
    return x.float() @ w.float()


def forward(params: TransformerLM, cfg: ModelConfig, batch: dict
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The full sequence with no cache. Returns (logits (B, S, V), MoE
    aux loss summed over the layers)."""
    x = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    aux = torch.zeros((), device=x.device)
    for (kind, ffn, _), p in zip(layer_plan(cfg), params.blocks):
        x, _, a = _apply_block(p, x, cfg, kind, ffn, positions=positions,
                               cache=None, cache_index=None)
        aux = aux + a
    x = rms_final(params, cfg, x)
    return head_logits(params, cfg, x), aux


# -- caches ------------------------------------------------------------------


def _layer_counts(cfg: ModelConfig) -> dict[str, int]:
    kinds = [kind for kind, _, _ in layer_plan(cfg)]
    return {kind: kinds.count(kind) for kind in ("attn", "ssm")}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    dt = cfg.activation_dtype
    n = _layer_counts(cfg)
    cache = {}
    if n["attn"]:
        la = n["attn"]
        if cfg.use_mla:
            cache["c_kv"] = torch.zeros((la, batch, max_len, cfg.kv_lora_rank),
                                        dtype=dt, device=dev)
            cache["k_rope"] = torch.zeros((la, batch, max_len,
                                           cfg.qk_rope_dim), dtype=dt,
                                          device=dev)
        else:
            shape = (la, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
            if cfg.kv_cache_dtype == "int8":
                for name in ("k", "v"):
                    cache[name] = torch.zeros(shape, dtype=torch.int8,
                                              device=dev)
                for name in ("k_scale", "v_scale"):
                    cache[name] = torch.zeros(shape[:-1], device=dev)
            else:
                for name in ("k", "v"):
                    cache[name] = torch.zeros(shape, dtype=dt, device=dev)
    if n["ssm"]:
        rows = S.init_ssm_cache(cfg, batch, dt, dev)
        for name, leaf in rows.items():
            cache[name] = leaf[None].repeat(n["ssm"], *([1] * leaf.ndim))
    return cache


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_len: int,
                     max_slots: int,
                     device: str | torch.device | None = None) -> dict:
    """Paged twin of :func:`init_cache`: attention leaves live in a shared
    pool of (layers, num_pages, page_len, ...), whose memory scales with
    ``num_pages``, the pages in circulation, instead of ``max_slots *
    max_len``. SSM leaves stay slot-resident with ``max_slots + 1`` rows:
    row ``max_slots`` is the scratch row, the slot-space twin of scratch
    page 0, which batch rows without a decoding request write. The
    allocator and page tables stay on the host (``serve.paging``)."""
    if cfg.kv_cache_dtype == "int8" and not cfg.is_attention_free:
        raise NotImplementedError(
            "int8 KV cache is not paged yet; use the dense ServeEngine")
    dev = resolve_device(device)
    dt = cfg.activation_dtype
    n = _layer_counts(cfg)
    cache = {}
    if n["attn"]:
        la = n["attn"]
        if cfg.use_mla:
            cache["c_kv"] = torch.zeros((la, num_pages, page_len,
                                         cfg.kv_lora_rank), dtype=dt,
                                        device=dev)
            cache["k_rope"] = torch.zeros((la, num_pages, page_len,
                                           cfg.qk_rope_dim), dtype=dt,
                                          device=dev)
        else:
            shape = (la, num_pages, page_len, cfg.num_kv_heads, cfg.head_dim)
            cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
            cache["v"] = torch.zeros(shape, dtype=dt, device=dev)
    if n["ssm"]:
        rows = S.init_ssm_cache(cfg, max_slots + 1, dt, dev)
        for name, leaf in rows.items():
            cache[name] = leaf[None].repeat(n["ssm"], *([1] * leaf.ndim))
    return cache


def paged_step(params: TransformerLM, cfg: ModelConfig, cache: dict,
               tokens: torch.Tensor, start: torch.Tensor,
               page_tables: torch.Tensor, slot_ids: torch.Tensor,
               seq_lens: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, dict]:
    """One step against a paged cache: decode (S=1) or a prefill chunk.

    tokens (B,S) at absolute positions ``start[b] + j``; page_tables (B,P)
    maps each slot's logical pages to physical pages (scratch page 0 for
    unallocated/inactive entries); slot_ids (B,) selects the rows of the
    slot-resident (SSM) leaves; seq_lens (B,) counts the valid tokens of
    a padded chunk (None = all valid). The cache is updated in place and
    returned with logits for every chunk position, (B, S, vocab)."""
    x = _embed_inputs(params, cfg, {"tokens": tokens})
    b, s, _ = x.shape
    dev = x.device
    start = start.to(device=dev, dtype=torch.long)
    page_tables = page_tables.to(device=dev, dtype=torch.long)
    slot_ids = slot_ids.to(device=dev, dtype=torch.long)
    if seq_lens is not None:
        seq_lens = seq_lens.to(device=dev, dtype=torch.long)
    positions = start[:, None] + torch.arange(s, device=dev)[None, :]
    for (kind, ffn, row), p in zip(layer_plan(cfg), params.blocks):
        x, _, _ = _apply_block(p, x, cfg, kind, ffn, positions=positions,
                               cache=_layer_cache(cfg, cache, kind, row),
                               cache_index=start, page_table=page_tables,
                               slot_ids=slot_ids, seq_lens=seq_lens)
    x = rms_final(params, cfg, x)
    return head_logits(params, cfg, x), cache


def prefill(params: TransformerLM, cfg: ModelConfig, batch: dict, *,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Forward over the prompt (tokens, and frames or patches for the
    front ends), returning last-position logits (B, 1, V) and the cache
    the layers made, its sequence leaves (chosen by name, not by shape)
    zero-padded to ``max_len``. As in the reference, the attention
    leaves are the layers' own K/V in the activation dtype, whatever
    ``kv_cache_dtype`` says."""
    x = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    max_len = max_len or s
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    n = _layer_counts(cfg)
    cache: dict[str, torch.Tensor] = {}
    for (kind, ffn, row), p in zip(layer_plan(cfg), params.blocks):
        x, layer_cache, _ = _apply_block(p, x, cfg, kind, ffn,
                                         positions=positions, cache=None,
                                         cache_index=None)
        for name, leaf in layer_cache.items():
            if name not in cache:
                shape = list(leaf.shape)
                if name in _SEQ_CACHE_LEAVES:
                    shape[1] = max_len
                cache[name] = torch.zeros([n[kind]] + shape, dtype=leaf.dtype,
                                          device=leaf.device)
            cache[name][row, :, :leaf.shape[1]] = leaf
    x = rms_final(params, cfg, x)
    return head_logits(params, cfg, x[:, -1:]), cache


def decode(params: TransformerLM, cfg: ModelConfig, cache: dict,
           tokens: torch.Tensor, cache_index) -> tuple[torch.Tensor, dict]:
    """One decode step: tokens (B, 1) at position ``cache_index``.

    ``cache_index`` may be a scalar (uniform position) or a (B,) vector of
    per-slot positions (continuous batching, repro_torch.serve.engine).
    The cache is updated in place and returned."""
    x = _embed_inputs(params, cfg, {"tokens": tokens})
    b = x.shape[0]
    if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
        cache_index = cache_index.to(device=x.device, dtype=torch.long)
        positions = cache_index[:, None]
    else:
        cache_index = int(cache_index)
        positions = torch.full((b, 1), cache_index, device=x.device)
    for (kind, ffn, row), p in zip(layer_plan(cfg), params.blocks):
        x, _, _ = _apply_block(p, x, cfg, kind, ffn, positions=positions,
                               cache=_layer_cache(cfg, cache, kind, row),
                               cache_index=cache_index)
    x = rms_final(params, cfg, x)
    return head_logits(params, cfg, x), cache
