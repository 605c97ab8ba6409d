"""Model assembly of the dense GQA transformer, in PyTorch.

Twin of the dense path of ``repro/models/transformer.py``. The JAX
package stacks the layers as scanned ``units``; here
:class:`TransformerLM` holds one ``ParameterDict`` per layer in a
``ModuleList`` and the entry points loop over it. Entry points:

  prefill     — forward over the prompt + a KV cache padded to ``max_len``
  decode      — one-token step against the cache (serve_step), in place
  paged_step  — decode or a prefill chunk against the paged pool, in place

``forward``, the training path, is not ported yet (ROADMAP.md, queue 1
item 9). The cache is ``{"k", "v"}`` of (layers, batch, max_len, Hkv, D),
the paged pool ``{"k", "v"}`` of (layers, num_pages, page_len, Hkv, D):
the JAX package's ``units/b0`` leaves with the unit axis as the layer axis.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

#: parameter names of one dense block (attention, then the SwiGLU FFN)
BLOCK_PARAMS = frozenset({"attn_norm", "wq", "wk", "wv", "wo",
                          "ffn_norm", "w_gate", "w_up", "w_down"})


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the architectures whose layers the port lacks."""
    if (cfg.family != "dense" or cfg.use_mla or cfg.frontend is not None
            or cfg.is_encoder or cfg.tie_embeddings):
        raise NotImplementedError(f"{cfg.name} ({cfg.family}): {L.NOT_PORTED}")


class TransformerLM(nn.Module):
    """The parameters of the dense stack: ``embed`` (vocab, d),
    ``final_norm`` (d,), ``head`` (d, vocab), and ``blocks[i]`` holding
    layer i's :data:`BLOCK_PARAMS`. Serving only: no parameter asks for a
    gradient."""

    def __init__(self, cfg: ModelConfig, *, embed: torch.Tensor,
                 final_norm: torch.Tensor, head: torch.Tensor,
                 blocks: list[dict[str, torch.Tensor]]):
        super().__init__()
        check_supported(cfg)
        if len(blocks) != cfg.num_layers:
            raise ValueError(f"{len(blocks)} blocks for {cfg.num_layers} layers")
        for i, b in enumerate(blocks):
            if set(b) != BLOCK_PARAMS:
                raise ValueError(f"block {i} holds {sorted(b)}, "
                                 f"not {sorted(BLOCK_PARAMS)}")
        fixed = lambda t: nn.Parameter(t, requires_grad=False)
        self.embed = fixed(embed)
        self.final_norm = fixed(final_norm)
        self.head = fixed(head)
        self.blocks = nn.ModuleList(
            nn.ParameterDict({n: fixed(t) for n, t in b.items()})
            for b in blocks)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters :func:`init_params` makes, counted from the shapes (the
    JAX package traces its init for this). A dense model touches every
    parameter per token, so ``active_only`` changes nothing here."""
    check_supported(cfg)
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    block = 2 * d + d * (hq + 2 * hkv) * hd + hq * hd * d + 3 * d * cfg.d_ff
    return 2 * cfg.vocab_size * d + d + cfg.num_layers * block



def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: str | torch.device | None = None) -> TransformerLM:
    """Random weights by the JAX package's laws: f32 normal times
    ``scale_dim ** -0.5``, cast to ``param_dtype``; norms are ones.

    Made layer by layer on ``device`` (``cuda`` unless named), so one
    matrix's f32 temporary exists at a time. ``generator`` must live on
    that device. The numbers differ from ``jax.random``'s: parity tests
    convert JAX weights instead
    (:func:`repro_torch.models.convert.params_from_jax`)."""
    check_supported(cfg)
    dev = resolve_device(device)
    pd = cfg.parameter_dtype
    d, vocab = cfg.d_model, cfg.vocab_size
    embed = L._init(generator, (vocab, d), d, pd, dev)
    blocks = [{**L.init_attention(cfg, generator, dev),
               **L.init_ffn(cfg, generator, dev)}
              for _ in range(cfg.num_layers)]
    head = L._init(generator, (d, vocab), d, pd, dev)
    return TransformerLM(cfg, embed=embed,
                         final_norm=torch.ones((d,), dtype=pd, device=dev),
                         head=head, blocks=blocks)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _apply_block(p, x, cfg: ModelConfig, *, positions, cache, cache_index,
                 page_table=None):
    x, new_cache = L.apply_attention(p, x, cfg, positions=positions,
                                     cache=cache, cache_index=cache_index,
                                     page_table=page_table)
    return L.apply_dense_block(p, x, cfg), new_cache


def _embed_inputs(params: TransformerLM, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    return params.embed[tokens.to(params.embed.device)].to(
        cfg.activation_dtype)


def rms_final(params: TransformerLM, cfg: ModelConfig, x):
    return L.rms_norm(x, params.final_norm, cfg.norm_eps)


def head_logits(params: TransformerLM, cfg: ModelConfig, x):
    """f32 logits from f32 operands (TF32 stays off on CUDA)."""
    return x.float() @ params.head.float()


# -- caches ------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device | None = None) -> dict:
    check_supported(cfg)
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(f"the int8 KV cache is {L.NOT_PORTED}")
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.activation_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.activation_dtype, device=dev)}


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_len: int,
                     max_slots: int,
                     device: str | torch.device | None = None) -> dict:
    """Paged twin of :func:`init_cache`: attention K/V live in a shared
    pool of (layers, num_pages, page_len, Hkv, D), whose memory scales
    with ``num_pages``, the pages in circulation, instead of
    ``max_slots * max_len``. ``max_slots`` sizes the slot-resident (SSM)
    leaves of the JAX package, which the dense family has none of. The
    allocator and page tables stay on the host (``serve.paging``)."""
    check_supported(cfg)
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(
            "int8 KV cache is not paged yet; use the dense ServeEngine")
    dev = resolve_device(device)
    shape = (cfg.num_layers, num_pages, page_len, cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.activation_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.activation_dtype, device=dev)}


def paged_step(params: TransformerLM, cfg: ModelConfig, cache: dict,
               tokens: torch.Tensor, start: torch.Tensor,
               page_tables: torch.Tensor, slot_ids: torch.Tensor,
               seq_lens: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, dict]:
    """One step against a paged cache: decode (S=1) or a prefill chunk.

    tokens (B,S) at absolute positions ``start[b] + j``; page_tables (B,P)
    maps each slot's logical pages to physical pages (scratch page 0 for
    unallocated/inactive entries); slot_ids (B,) and seq_lens (B,) select
    the rows and valid lengths of the slot-resident (SSM) leaves, which
    the dense family has none of, so they are taken for the JAX
    package's signature and not read. The pool is updated in place and
    returned with logits for every chunk position, (B, S, vocab)."""
    x = _embed_inputs(params, cfg, tokens)
    b, s, _ = x.shape
    start = start.to(device=x.device, dtype=torch.long)
    page_tables = page_tables.to(device=x.device, dtype=torch.long)
    positions = start[:, None] + torch.arange(s, device=x.device)[None, :]
    for i, p in enumerate(params.blocks):
        x, _ = _apply_block(p, x, cfg, positions=positions,
                            cache={"k": cache["k"][i], "v": cache["v"][i]},
                            cache_index=start, page_table=page_tables)
    x = rms_final(params, cfg, x)
    return head_logits(params, cfg, x), cache


def prefill(params: TransformerLM, cfg: ModelConfig, batch: dict, *,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Forward over the prompt, returning last-position logits (B, 1, V)
    and a cache padded with zeros to ``max_len``."""
    x = _embed_inputs(params, cfg, batch["tokens"])
    b, s, _ = x.shape
    max_len = max_len or s
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    cache = init_cache(cfg, b, max_len, device=x.device)
    for i, p in enumerate(params.blocks):
        x, layer_cache = _apply_block(p, x, cfg, positions=positions,
                                      cache=None, cache_index=None)
        cache["k"][i, :, :s] = layer_cache["k"]
        cache["v"][i, :, :s] = layer_cache["v"]
    x = rms_final(params, cfg, x)
    return head_logits(params, cfg, x[:, -1:]), cache


def decode(params: TransformerLM, cfg: ModelConfig, cache: dict,
           tokens: torch.Tensor, cache_index) -> tuple[torch.Tensor, dict]:
    """One decode step: tokens (B, 1) at position ``cache_index``.

    ``cache_index`` may be a scalar (uniform position) or a (B,) vector of
    per-slot positions (continuous batching, repro_torch.serve.engine).
    The cache is updated in place and returned."""
    x = _embed_inputs(params, cfg, tokens)
    b = x.shape[0]
    if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
        cache_index = cache_index.to(device=x.device, dtype=torch.long)
        positions = cache_index[:, None]
    else:
        cache_index = int(cache_index)
        positions = torch.full((b, 1), cache_index, device=x.device)
    for i, p in enumerate(params.blocks):
        x, _ = _apply_block(p, x, cfg, positions=positions,
                            cache={"k": cache["k"][i], "v": cache["v"][i]},
                            cache_index=cache_index)
    x = rms_final(params, cfg, x)
    return head_logits(params, cfg, x), cache
