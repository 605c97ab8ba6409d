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
the slot axis of every dense leaf and of every slot-resident leaf. Under
a serving mesh (``init_paged_cache(mesh=)``) the paged pool's leaves are
``DTensor``s laid out by ``PAGED_CACHE_AXES``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import constrain

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
    reference's names, and ``cfg``. Built for serving, no parameter asks
    for a gradient, so the engines build no autograd graph; the training
    path turns them trainable (``requires_grad_()``, as
    ``repro_torch.train.loop.init_state`` does)."""

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
        self.cfg = cfg
        fixed = lambda t: nn.Parameter(t, requires_grad=False)
        self.embed = fixed(embed)
        self.final_norm = fixed(final_norm)
        self.head = None if head is None else fixed(head)
        self.frontend = nn.ParameterDict(
            {n: fixed(t) for n, t in frontend.items()})
        self.blocks = nn.ModuleList(
            nn.ParameterDict({n: fixed(t) for n, t in b.items()})
            for b in blocks)


def from_named(cfg: ModelConfig, named) -> TransformerLM:
    """A :class:`TransformerLM` holding ``named``'s tensors, keyed as
    ``named_parameters()`` names them (``embed``, ``head``,
    ``frontend.<name>``, ``blocks.<i>.<name>``), without a copy."""
    named = dict(named)
    blocks = [{} for _ in range(cfg.num_layers)]
    frontend = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            blocks[int(parts[1])][parts[2]] = t
        elif parts[0] == "frontend":
            frontend[parts[1]] = t
    return TransformerLM(cfg, embed=named["embed"],
                         final_norm=named["final_norm"],
                         head=named.get("head"), blocks=blocks,
                         frontend=frontend)


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


def param_logical_axes(params: TransformerLM) -> dict[str, tuple]:
    """Logical axes of every parameter, keyed as ``named_parameters()``
    names it (``blocks.<i>.<name>``, ``frontend.<name>``, ``embed``...).
    The reference's stacked leaves carry a leading "layers" axis whose
    rule is None; the port's layers are not stacked, so it has none. A
    name without an entry, or whose entry does not fit the rank, is
    replicated."""
    out = {}
    for name, leaf in params.named_parameters():
        axes = tuple(L.PARAM_AXES.get(name.rsplit(".", 1)[-1],
                                      (None,) * leaf.ndim))
        out[name] = axes if len(axes) == leaf.ndim else (None,) * leaf.ndim
    return out


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


#: each stacked pool ``DTensor`` -> (its local storage's address, its
#: per-layer views), made once a pool and dropped with it
_VIEWS: WeakIdKeyDictionary = WeakIdKeyDictionary()


def _layer_views(leaf):
    """Per-layer views of a stacked ``DTensor`` leaf, each a ``DTensor``
    over a view of the local tensor (so writes land in ``leaf``), made
    without the ``DTensor`` dispatch of indexing. They are made on a
    pool's first step and kept while its local storage stays where it is
    (the engine updates the pool in place)."""
    local = leaf.to_local()
    kept = _VIEWS.get(leaf)
    if kept is not None and kept[0] == local.data_ptr():
        return kept[1]
    from torch.distributed.tensor import DTensor, Shard
    if any(p.is_shard(0) for p in leaf.placements):
        raise ValueError("a pool leaf sharded on its layer axis")
    place = [Shard(p.dim - 1) if p.is_shard() else p
             for p in leaf.placements]
    views = [DTensor.from_local(local[i], leaf.device_mesh, place,
                                run_check=False)
             for i in range(local.shape[0])]
    _VIEWS[leaf] = (local.data_ptr(), views)
    return views


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
        tokens = batch["tokens"].to(dev)
        rows = (L.embed_on_shards(params.embed, tokens)
                if sharding.is_dtensor(params.embed)
                else params.embed[tokens])
        parts.append(rows.to(cfg.activation_dtype))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return constrain(x, "batch", "seq", "embed")


def rms_final(params: TransformerLM, cfg: ModelConfig, x):
    return L.rms_norm(x, params.final_norm, cfg.norm_eps)


def head_logits(params: TransformerLM, cfg: ModelConfig, x):
    """f32 logits from f32 operands (TF32 stays off on CUDA); f64 in a
    model cast up to float64."""
    w = params.embed.T if cfg.tie_embeddings else params.head
    if sharding.is_dtensor(w) and sharding.current() is not None:
        return L.logits_on_shards(L.wide(x), L.wide(w))
    return constrain(L.wide(x) @ L.wide(w), "batch", "seq", "vocab")


def _dots_saveable():
    """The counterpart of ``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable``: a selective checkpoint that keeps
    the outputs of matrix products with no batch dimension (``x @ W``,
    which reaches the dispatcher as ``aten.mm``) and recomputes the rest
    (the batched products of attention, the SSD and the experts among
    it)."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


def forward(params: TransformerLM, cfg: ModelConfig, batch: dict
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The full sequence with no cache. Returns (logits (B, S, V), MoE
    aux loss summed over the layers).

    The layers run a unit (``unit_spec``) at a time, as the reference
    scans them; ``scan_layers`` changes no number, so it stays a loop.
    Under grad mode with ``cfg.remat``, each unit is rematerialized in
    the backward pass (``torch.utils.checkpoint``, non-reentrant, the
    reference's ``jax.checkpoint``): ``remat_policy="full"`` keeps only
    the unit's input, ``"dots"`` also the outputs of its unbatched
    matrix products."""
    x = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    spec = unit_spec(cfg)
    period = len(spec)

    def unit(h, aux, blocks):
        unit_aux = torch.zeros((), device=h.device)
        for (kind, ffn), p in zip(spec, blocks):
            h, _, a = _apply_block(p, h, cfg, kind, ffn, positions=positions,
                                   cache=None, cache_index=None)
            unit_aux = unit_aux + a
        return h, aux + unit_aux

    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), device=x.device)
    for u in range(num_units(cfg)):
        blocks = list(params.blocks[u * period:(u + 1) * period])
        if remat:
            from torch.utils.checkpoint import checkpoint
            kw = ({"context_fn": _dots_saveable}
                  if cfg.remat_policy == "dots" else {})
            # the model draws no random numbers: no RNG state to replay
            x, aux = checkpoint(unit, x, aux, blocks, use_reentrant=False,
                                preserve_rng_state=False, **kw)
        else:
            x, aux = unit(x, aux, blocks)
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
                     device: str | torch.device | None = None, *,
                     mesh=None, rules: dict | None = None) -> dict:
    """Paged twin of :func:`init_cache`: attention leaves live in a shared
    pool of (layers, num_pages, page_len, ...), whose memory scales with
    ``num_pages``, the pages in circulation, instead of ``max_slots *
    max_len``. SSM leaves stay slot-resident with ``max_slots + 1`` rows:
    row ``max_slots`` is the scratch row, the slot-space twin of scratch
    page 0, which batch rows without a decoding request write. The
    allocator and page tables stay on the host (``serve.paging``).

    ``mesh`` (a ``DeviceMesh``, or a prebuilt
    :class:`~repro_torch.parallel.sharding.ShardingCtx`) lays the pool
    leaves out as ``DTensor``s resolved through ``PAGED_CACHE_AXES``: KV
    heads on ``"model"``, pages replicated (or on ``"data"`` by
    ``rules``), each rank holding zeros of its own part on the mesh's
    device (``device`` is then ignored). Slot-resident leaves stay plain
    tensors on that device."""
    if cfg.kv_cache_dtype == "int8" and not cfg.is_attention_free:
        raise NotImplementedError(
            "int8 KV cache is not paged yet; use the dense ServeEngine")
    ctx = None
    if mesh is not None:
        ctx = (mesh if isinstance(mesh, sharding.ShardingCtx)
               else sharding.ShardingCtx(mesh, rules))
        device = sharding.mesh_device(ctx.mesh)
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
    if ctx is not None:
        for name, shd in paged_cache_shardings(cache, ctx).items():
            if name in PAGED_LEAVES:
                cache[name] = sharding.distribute(cache[name], shd)
    return cache


# -- cache sharding metadata -------------------------------------------------

#: logical axes of every leaf of an ``init_cache`` dict, the reference's
#: table over the same leaf names (its leading "layers" axis is the
#: port's stacked layers-of-a-kind axis)
CACHE_AXES: dict[str, tuple[str | None, ...]] = {
    "k": ("layers", "cache_batch", "cache_seq", "cache_kv_heads",
          "cache_head_dim"),
    "v": ("layers", "cache_batch", "cache_seq", "cache_kv_heads",
          "cache_head_dim"),
    "c_kv": ("layers", "cache_batch", "cache_seq", "kv_lora"),
    "k_rope": ("layers", "cache_batch", "cache_seq", None),
    "k_scale": ("layers", "cache_batch", "cache_seq", "cache_kv_heads"),
    "v_scale": ("layers", "cache_batch", "cache_seq", "cache_kv_heads"),
    "conv": ("layers", "cache_batch", None, "inner"),
    "state": ("layers", "cache_batch", "ssm_heads", None, None),
}


def _axes_by_name(table: dict, cache: dict) -> dict[str, tuple]:
    """``table``'s logical axes of every leaf of ``cache``; a leaf without
    an entry, or whose entry does not fit its rank, is replicated."""
    out = {}
    for name, leaf in cache.items():
        axes = table.get(name, (None,) * leaf.ndim)
        out[name] = axes if len(axes) == leaf.ndim else (None,) * leaf.ndim
    return out


def cache_logical_axes(cache: dict) -> dict[str, tuple]:
    """Logical axes of every leaf of an ``init_cache`` dict."""
    return _axes_by_name(CACHE_AXES, cache)


#: paged-pool twin of the reference's CACHE_AXES: attention leaves are
#: (layers, num_pages, page_len, ...) pools whose heads ride the
#: "cache_kv_heads" rule (GQA fallback included) and whose pages ride
#: "cache_pages" (replicated by default, "data" by rule override). The
#: page_len axis is the contiguous gather row and is never sharded.
#: Slot-resident SSM leaves are small O(slots) state; they stay
#: replicated so the scratch-row trick needs no cross-shard reasoning.
PAGED_CACHE_AXES: dict[str, tuple[str | None, ...]] = {
    "k": ("layers", "cache_pages", None, "cache_kv_heads",
          "cache_head_dim"),
    "v": ("layers", "cache_pages", None, "cache_kv_heads",
          "cache_head_dim"),
    "c_kv": ("layers", "cache_pages", None, "kv_lora"),
    "k_rope": ("layers", "cache_pages", None, None),
    "conv": ("layers", None, None, None),
    "state": ("layers", None, None, None, None),
}


def paged_cache_logical_axes(cache: dict) -> dict[str, tuple]:
    """Logical axes of every leaf of an ``init_paged_cache`` dict."""
    return _axes_by_name(PAGED_CACHE_AXES, cache)


def paged_cache_shardings(cache: dict, ctx) -> dict:
    """The :class:`~repro_torch.parallel.sharding.NamedSharding` of every
    leaf of a paged cache, resolved through ``ctx``'s rule table
    (indivisible axes drop per leaf: the GQA replication fallback)."""
    return {name: ctx.named(axes, cache[name].shape)
            for name, axes in paged_cache_logical_axes(cache).items()}


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
    views = {name: _layer_views(leaf) for name, leaf in cache.items()
             if sharding.is_dtensor(leaf)}
    for (kind, ffn, row), p in zip(layer_plan(cfg), params.blocks):
        layer = _layer_cache(cfg, cache, kind, row) if not views else {
            name: (views[name][row] if name in views else cache[name][row])
            for name in _leaf_names(cfg, kind) if name in cache}
        x, _, _ = _apply_block(p, x, cfg, kind, ffn, positions=positions,
                               cache=layer, cache_index=start,
                               page_table=page_tables, slot_ids=slot_ids,
                               seq_lens=seq_lens)
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
                cache[name] = _zeros_stacked(leaf, [n[kind]] + shape)
            if sharding.is_dtensor(leaf):
                # laid out alike, the local parts line up: DTensor's own
                # setitem would gather the stack whole
                cache[name].to_local()[row, :, :leaf.shape[1]] = \
                    leaf.to_local()
            else:
                cache[name][row, :, :leaf.shape[1]] = leaf
    x = rms_final(params, cfg, x)
    return head_logits(params, cfg, x[:, -1:]), cache


def _zeros_stacked(leaf: torch.Tensor, shape: list[int]) -> torch.Tensor:
    """Zeros of ``shape``, a stack of layers of ``leaf``'s kind (its axis
    1, the sequence, possibly longer), on ``leaf``'s device. A ``DTensor``
    leaf (a sharded forward) gets a ``DTensor`` laid out as it is, under
    a leading whole axis, made from this rank's zeros alone: a buffer of
    the global shape would hold every rank's part."""
    if not sharding.is_dtensor(leaf):
        return torch.zeros(shape, dtype=leaf.dtype, device=leaf.device)
    from torch.distributed.tensor import DTensor, Shard
    if any(p.is_shard(1) or p.is_partial() for p in leaf.placements):
        raise ValueError(f"a cache leaf laid out {leaf.placements}: its "
                         "sequence axis must be whole")
    local = leaf.to_local()
    local_shape = [shape[0], *local.shape]
    local_shape[2] = shape[2]
    place = [Shard(p.dim + 1) if p.is_shard() else p
             for p in leaf.placements]
    return DTensor.from_local(
        torch.zeros(local_shape, dtype=leaf.dtype, device=local.device),
        leaf.device_mesh, place, run_check=False, shape=torch.Size(shape),
        stride=sharding.contiguous_strides(shape))


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
