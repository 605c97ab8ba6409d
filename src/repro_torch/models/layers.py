"""Building blocks shared by all 10 architectures, in PyTorch.

Twin of ``repro/models/layers.py``: ``rms_norm``, ``rotary``, GQA
attention with its five cache branches (none, paged, per-slot vector,
int8 scalar ring, scalar ring) and its chunked variant, the paged scatter
and gather, MLA (naive and absorbed) over the dense, vector-index and
paged caches, the SwiGLU FFN and the capacity-buffered top-k MoE.
Parameters are plain mappings of tensors, as the JAX package's are
dicts. Weights keep JAX's ``(in, out)`` layout and multiply as ``x @ W``,
so a converted JAX pytree needs no transpose.

Parameter logical axes are registered in ``PARAM_AXES`` (resolved by
``repro_torch.parallel.sharding``), and activations carry the reference's
``constrain`` annotations: the identity outside a sharding ctx, and for
plain tensors under one. Under a serving mesh the paged pool's leaves are
``DTensor``s with their KV heads on ``"model"``: the scatter writes each
rank's heads slice in place and the gather all-gathers the heads back.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import constrain

Params = Mapping[str, torch.Tensor]

# logical axes by parameter name (the reference prepends its stacked
# "layers" axis, whose rule is None; the port's layers are not stacked)
PARAM_AXES: dict[str, tuple[str | None, ...]] = {
    "embed":        ("vocab", "embed"),
    "head":         ("embed", "vocab"),
    "final_norm":   ("embed",),
    "frontend_w1":  (None, "embed"),
    "frontend_w2":  ("embed", "embed"),
    "frontend_b":   ("embed",),
    # attention
    "attn_norm":    ("embed",),
    "wq":           ("embed", "q_features"),
    "wk":           ("embed", "kv_features"),
    "wv":           ("embed", "kv_features"),
    "wo":           ("q_features", "embed"),
    # MLA
    "w_dq":         ("embed", None),
    "w_dkv":        ("embed", "kv_lora"),
    "kv_norm":      ("kv_lora",),
    "w_uk":         ("kv_lora", "q_features"),
    "w_uv":         ("kv_lora", "q_features"),
    # FFN
    "ffn_norm":     ("embed",),
    "w_gate":       ("embed", "mlp"),
    "w_up":         ("embed", "mlp"),
    "w_down":       ("mlp", "embed"),
    # MoE
    "router":       ("embed", "experts"),
    "moe_gate":     ("experts", "embed", "mlp"),
    "moe_up":       ("experts", "embed", "mlp"),
    "moe_down":     ("experts", "mlp", "embed"),
    "shared_gate":  ("embed", "mlp"),
    "shared_up":    ("embed", "mlp"),
    "shared_down":  ("mlp", "embed"),
    # SSM (mamba2)
    "ssm_norm":     ("embed",),
    "in_proj":      ("embed", "inner"),
    "conv_w":       ("conv", "inner"),
    "conv_b":       ("inner",),
    "A_log":        (None,),
    "ssm_D":        (None,),
    "dt_bias":      (None,),
    "gate_norm":    ("inner",),
    "out_proj":     ("inner", "embed"),
}


def _init(generator: torch.Generator | None, shape, scale_dim: int, dtype,
          device) -> torch.Tensor:
    """f32 normal times ``scale_dim ** -0.5``, cast to ``dtype``; on the
    ``meta`` device (``generator`` None) only the shape is made."""
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * (scale_dim ** -0.5)).to(dtype)


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x.float()``, but a float64 tensor stays float64: where the
    reference computes in float32, a model cast up to float64 (the
    training check's high-precision twin) computes in float64."""
    return x if x.dtype == torch.float64 else x.float()


def embed_on_shards(table: torch.Tensor, tokens: torch.Tensor
                    ) -> torch.Tensor:
    """``table[tokens]`` for a ``DTensor`` table (vocab, d), on each rank's
    own shards: the table's FSDP split is gathered (as every FSDP weight
    is before use), and where the vocab stays split each rank looks up
    the tokens in its slice, zero elsewhere, and an all-reduce joins the
    slices (Megatron's vocab-parallel embedding). ``DTensor``'s own
    indexing has no sharding rule for its backward, and its embedding op
    mis-masks a vocab split beside a batch split. With the vocab whole on
    the rank it is the unsharded lookup."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    tplace = [Shard(0) if p.is_shard(0) else Replicate()
              for p in table.placements]
    if tuple(table.placements) != tuple(tplace):
        table = table.redistribute(mesh, tplace)
    vocab = [i for i, p in enumerate(tplace) if p.is_shard(0)]
    tok_place = (list(tokens.placements) if sharding.is_dtensor(tokens)
                 else [Replicate()] * mesh.ndim)
    # the batch may be split over mesh dimensions the vocab is not
    rows = [Shard(0) if p.is_shard(0) and i not in vocab else Replicate()
            for i, p in enumerate(tok_place)]
    tl = (tokens.redistribute(mesh, rows).to_local()
          if sharding.is_dtensor(tokens)
          else sharding.local_chunk(tokens, mesh, rows))
    batch = [i for i, p in enumerate(rows) if p.is_shard(0)]
    # this rank's table gradient covers its own batch rows only
    el = sharding.to_local(table, [
        Shard(0) if i in vocab else Partial() if i in batch else Replicate()
        for i in range(mesh.ndim)])
    if math.prod(mesh.size(i) for i in vocab) == 1:
        return DTensor.from_local(el[tl], mesh, rows, run_check=False)
    width = el.shape[0]
    lo = sharding.shard_index(mesh, vocab) * width
    mine = (tl >= lo) & (tl < lo + width)
    part = torch.where(mine[..., None], el[torch.clamp(tl - lo, 0,
                                                       width - 1)], 0)
    share = [Partial() if i in vocab else p for i, p in enumerate(rows)]
    return DTensor.from_local(part, mesh, share, run_check=False
                              ).redistribute(mesh, rows)


def logits_on_shards(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for (B, S, d) activations and a ``DTensor`` (d, V) head,
    laid out as ``constrain(..., "batch", "seq", "vocab")`` resolves, each
    rank multiplying its batch rows by its vocab slice (the head's FSDP
    split gathered first). ``DTensor``'s own choice for this product can
    gather the head whole and hold every rank's logits over the whole
    vocab before the constraint cuts them."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    ctx = sharding.current()
    b, s = x.shape[0], x.shape[1]
    out = sharding.placements(ctx.mesh, ctx.spec(
        ("batch", "seq", "vocab"), (b, s, w.shape[1])),
        any_order=ctx.any_order)
    mesh = ctx.mesh
    xp = [Shard(0) if p.is_shard(0) else Replicate() for p in out]
    wp = [Shard(1) if p.is_shard(2) else Replicate() for p in out]
    x = sharding.on_mesh_of(x, w) if not sharding.is_dtensor(x) else x
    if tuple(x.placements) != tuple(xp):
        x = x.redistribute(mesh, xp)
    if tuple(w.placements) != tuple(wp):
        w = w.redistribute(mesh, wp)
    # each rank's gradients: of x from its vocab slice, of w from its
    # batch rows: shares of sums over the other split
    xl = sharding.to_local(x, [Partial() if p.is_shard(2) else q
                               for p, q in zip(out, xp)])
    wl = sharding.to_local(w, [Partial() if p.is_shard(0) else q
                               for p, q in zip(out, wp)])
    return DTensor.from_local(xl @ wl, mesh, out, run_check=False)


# ---------------------------------------------------------------------------
# norms / rotary
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 statistics; cast to ``x.dtype`` *before* the scale multiply."""
    xf = wide(x)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float
           ) -> torch.Tensor:
    """x: (..., S, H, D) with llama-style half rotation; positions: (..., S)."""
    d = x.shape[-1]
    fdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    freqs = theta ** (-torch.arange(0, d, 2, dtype=fdt, device=x.device) / d)
    angles = positions[..., None].to(fdt) * freqs        # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = wide(x).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA)
# ---------------------------------------------------------------------------


def _is_vector(cache_index) -> bool:
    return isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1


def _decode_valid(t: int, cache_index, device) -> torch.Tensor:
    """(B,t) or (1,t) valid-slot mask; supports per-slot vector indices."""
    ar = torch.arange(t, device=device)[None, :]
    if _is_vector(cache_index):
        return ar <= cache_index[:, None]
    return ar <= cache_index


# -- paged KV cache (repro_torch.serve.paging) --------------------------------


def _paged_scatter_impl(pages: torch.Tensor, page_table: torch.Tensor,
                        positions: torch.Tensor, vals: torch.Tensor) -> None:
    pl = pages.shape[1]
    phys = torch.gather(page_table, 1, positions // pl)
    pages.index_put_((phys, positions % pl), vals.to(pages.dtype),
                     accumulate=False)


def _paged_gather_impl(pages: torch.Tensor, page_table: torch.Tensor
                       ) -> torch.Tensor:
    b, p = page_table.shape
    return pages[page_table].reshape(b, p * pages.shape[1], *pages.shape[2:])


def _paged_shard_axes(pages: torch.Tensor):
    """(ctx, heads mesh axes) when the sharded path applies to this pool
    leaf: an active sharding ctx, a rank-4 ``DTensor`` leaf, and rules
    that put its KV-heads dimension on mesh axes that divide it while
    pages and head_dim stay whole. None -> the plain path: unsharded
    engines, the GQA fallback, MLA's rank-3 compressed leaves, and pages
    on "data"."""
    ctx = sharding.current()
    if ctx is None or pages.ndim != 4 or not sharding.is_dtensor(pages):
        return None
    pages_ax, _, heads_ax, hd_ax = ctx.spec(
        ("cache_pages", None, "cache_kv_heads", "cache_head_dim"),
        pages.shape)
    if not heads_ax or pages_ax or hd_ax:
        return None
    return ctx, heads_ax


def _heads_shard(ctx, heads_ax) -> int:
    """This rank's index among the shards of the heads mesh axes, the
    first axis major as in a JAX spec (and in ``DTensor``'s block order)."""
    axes = (heads_ax,) if isinstance(heads_ax, str) else tuple(heads_ax)
    return sharding.shard_index(
        ctx.mesh, [ctx.mesh.mesh_dim_names.index(a) for a in axes])


@tracing.spanned("attn.kv_write")
def _paged_scatter(pages: torch.Tensor, page_table: torch.Tensor,
                   positions: torch.Tensor, vals: torch.Tensor
                   ) -> torch.Tensor:
    """Write per-token values into the shared page pool, IN PLACE.

    pages: (num_pages, page_len, ...); page_table: (B, P) physical page of
    each logical page; positions: (B, S) absolute token positions; vals:
    (B, S, ...). Inactive slots point at the scratch page (0), so their
    garbage writes can never land in a live request's pages; several of
    them may write the same scratch row in one step, and which one wins
    does not matter (nothing live reads page 0). The serving engine keeps
    ``positions // page_len`` inside the table (tests/test_torch_paged.py
    checks every step), where a CUDA index out of range would be a device
    assert and the JAX gather would clamp.

    Under a serving mesh each rank writes only its own heads slice of
    ``vals`` into its local shard: no collective, no pool copy (the twin
    of the reference's ``shard_map`` over the donated cache). A pool
    ``DTensor`` off that path is written through its local tensor where
    every rank holds it whole, else gathered whole, written and cut back
    to this rank's part."""
    sharded = _paged_shard_axes(pages)
    if sharded is not None:
        ctx, ax = sharded
        local = pages.to_local()
        n = local.shape[2]
        lo = _heads_shard(ctx, ax) * n
        _paged_scatter_impl(local, page_table, positions,
                            vals[:, :, lo:lo + n])
    elif sharding.replicated(pages):
        _paged_scatter_impl(pages.to_local() if sharding.is_dtensor(pages)
                            else pages, page_table, positions, vals)
    else:
        sharding.update_whole(pages, lambda full: _paged_scatter_impl(
            full, page_table, positions, vals))
    return pages


@tracing.spanned("attn.kv_read")
def _paged_gather(pages: torch.Tensor, page_table: torch.Tensor
                  ) -> torch.Tensor:
    """Gather each slot's pages back into a (B, P*page_len, ...) view.

    The sharded path gathers each rank's own heads slice locally (at its
    own partition's bandwidth, the per-partition pricing that
    ``choose_page_len(shards=...)`` models), then all-gathers the heads
    into a plain tensor every rank holds whole: one collective that only
    moves data, so every downstream product sees the same operands at any
    mesh width and the token streams stay bit-identical. The local gather
    keeps the leaf's heads dimension (2), so the leaf's placements lay it
    out; on a 1-device mesh the all-gather is the identity and is skipped."""
    if not sharding.is_dtensor(pages):
        return _paged_gather_impl(pages, page_table)
    mesh, place = pages.device_mesh, pages.placements
    if _paged_shard_axes(pages) is not None:
        return sharding.gather(_paged_gather_impl(pages.to_local(),
                                                  page_table), mesh, place)
    return _paged_gather_impl(sharding.gather(pages.to_local(), mesh, place),
                              page_table)


def _paged_valid(t: int, positions: torch.Tensor) -> torch.Tensor:
    """(B, S, t) causal mask against absolute per-token positions."""
    return (torch.arange(t, device=positions.device)[None, None, :]
            <= positions[:, :, None])


def paged_decode_applies(pool, q) -> bool:
    """Whether a one-token decode step over a GQA page pool ``pool`` with
    queries like ``q`` (or any tensor of the same parameters) takes
    :func:`kops.paged_decode_attention`, which reads each row only up to its
    own position and rows on the scratch page not at all: both are plain
    tensors. A pool or queries of ``DTensor``s, and a model with no GQA
    pool (``pool`` None: MLA's latent pages, no attention), gather every
    row whole."""
    return pool is not None and not (sharding.is_dtensor(pool)
                                     or sharding.is_dtensor(q))


def init_attention(cfg: ModelConfig, generator: torch.Generator,
                   device) -> dict[str, torch.Tensor]:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pd = cfg.parameter_dtype
    return {
        "attn_norm": torch.ones((d,), dtype=pd, device=device),
        "wq": _init(generator, (d, hq * hd), d, pd, device),
        "wk": _init(generator, (d, hkv * hd), d, pd, device),
        "wv": _init(generator, (d, hkv * hd), d, pd, device),
        "wo": _init(generator, (hq * hd, d), hq * hd, pd, device),
    }


@tracing.spanned("attn.core")
def _sdpa(q, k, v, cfg: ModelConfig, *, causal: bool,
          kv_len_mask: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B,S,H,D); k/v: (B,T,Hkv,D).  kv_len_mask: (B,T) valid-slot mask
    (decode against a preallocated cache) or (B,S,T) per-query positional
    mask (paged chunked prefill). A mask always takes the plain branch,
    never flash."""
    if sharding.is_dtensor(q):
        o = _sdpa_on_shards(q, k, v, cfg, causal=causal,
                            kv_len_mask=kv_len_mask)
        if o is not None:
            return o
    b, s, h, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if cfg.attention_impl == "flash" and kv_len_mask is None and s == t:
        qf = q.transpose(1, 2).reshape(b * h, s, dh).contiguous()
        kf = k.transpose(1, 2).reshape(b * hkv, t, dh).contiguous()
        # v keeps its own width: MLA's (q 192, v 128) reaches the
        # kernel's shape check, which raises ValueError
        vf = v.transpose(1, 2).reshape(b * hkv, t, v.shape[-1]).contiguous()
        o = kops.flash_attention(qf, kf, vf, num_q_heads=h, num_kv_heads=hkv,
                                 causal=causal)
        return o.reshape(b, h, s, dh).transpose(1, 2)
    if (cfg.attention_impl == "chunked" and s > cfg.attention_chunk
            and s % cfg.attention_chunk == 0
            and (kv_len_mask is None or kv_len_mask.ndim == 2)):
        return _sdpa_chunked(q, k, v, cfg, causal=causal,
                             kv_len_mask=kv_len_mask)
    group = h // hkv
    qg = sharding.view_heads(q, (b, s, hkv, group, dh), "kv_heads")
    scores = torch.einsum("bskgd,btkd->bkgst", wide(qg),
                          wide(k)) * (dh ** -0.5)
    if causal and s == t:
        mask = torch.ones((s, t), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, -1e30)
    if kv_len_mask is not None:
        m = (kv_len_mask[:, None, None, None, :] if kv_len_mask.ndim == 2
             else kv_len_mask[:, None, None, :, :])
        scores = torch.where(m, scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, wide(v))
    return o.reshape(b, s, h, v.shape[-1]).to(q.dtype)


def _sdpa_on_shards(q, k, v, cfg: ModelConfig, *, causal: bool,
                    kv_len_mask: torch.Tensor | None = None):
    """Attention on each rank's own shards, where the ``DTensor``s q, k
    and v split only over batch and heads: every (batch row, query head)
    is then whole on one rank with the KV head it reads, so the attention
    runs on the local tensors with no communication, as GSPMD partitions
    it, and by the unsharded arithmetic. Query and KV heads split alike,
    or (the GQA fallback: KV heads that do not divide the mesh axes, left
    whole on every rank) each rank takes the KV heads its query heads
    read, whose gradients are then its share of a sum. A plain mask is cut
    to this rank's batch rows. None where the layouts do not allow it (a
    sequence- or head_dim-sharded cache), for the ``DTensor`` path."""
    if not (sharding.is_dtensor(k) and sharding.is_dtensor(v)):
        return None
    from torch.distributed.tensor import DTensor, Partial, Replicate
    qp, kp = tuple(q.placements), tuple(k.placements)
    if tuple(v.placements) != kp or not all(
            p.is_replicate() or p.is_shard(0) or p.is_shard(2)
            for p in qp + kp):
        return None
    if any(a.is_shard(0) != c.is_shard(0) for a, c in zip(qp, kp)):
        return None
    mesh = q.device_mesh
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    group = h // hkv
    heads = [i for i, p in enumerate(qp) if p.is_shard(2)]
    kv_heads = [i for i, p in enumerate(kp) if p.is_shard(2)]
    kl, vl = None, None
    if kv_heads != heads:
        if kv_heads:
            return None
        # KV whole on every rank: this rank's query heads [r·hl, (r+1)·hl)
        # read the KV heads [r·hl // G, ...]
        hl = h // math.prod(mesh.size(i) for i in heads)
        if hl % group and group % hl:
            return None
        lo = sharding.shard_index(mesh, heads) * hl // group
        n = max(1, hl // group)
        shares = [Partial() if i in heads else p for i, p in enumerate(kp)]
        kl = sharding.to_local(k, shares)[:, :, lo:lo + n]
        vl = sharding.to_local(v, shares)[:, :, lo:lo + n]
    if kv_len_mask is not None:
        if sharding.is_dtensor(kv_len_mask):
            return None
        kv_len_mask = sharding.local_chunk(
            kv_len_mask, mesh,
            [p if p.is_shard(0) else Replicate() for p in qp])
    o = _sdpa(sharding.to_local(q),
              sharding.to_local(k) if kl is None else kl,
              sharding.to_local(v) if vl is None else vl, cfg,
              causal=causal, kv_len_mask=kv_len_mask)
    return DTensor.from_local(o, mesh, qp, run_check=False)


def _sdpa_chunked(q, k, v, cfg: ModelConfig, *, causal: bool,
                  kv_len_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Attention one block of ``attention_chunk`` queries at a time, so
    the S×S score matrix never materializes: the reference's ``lax.scan``
    over q blocks as a Python loop (the same math and FLOPs).

    A block's (B, Hkv, G, bq, T) f32 scores are its one large tensor, so
    it holds two at most: the scale and the masks are applied in place,
    and the second product reads the probabilities where they lie. Under
    grad mode each block is checkpointed, keeping only its inputs for the
    backward pass, as a fused kernel recomputes its scores (the values
    are the same; the blocks then do not hold every block's
    probabilities at once)."""
    b, s, h, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    bq = cfg.attention_chunk
    kf, vf = wide(k), wide(v)

    # (B, Hkv, 1, D, T) and (B, Hkv, 1, T, Dv): each KV head's keys and
    # values, broadcast over its query group
    kt = kf.permute(0, 2, 3, 1)[:, :, None]
    vt = vf.permute(0, 2, 1, 3)[:, :, None]

    def block(qi, kt, vt, i):
        # (B, Hkv, G, bq, D) @ (B, Hkv, 1, D, T): the scores are the
        # product's own tensor, not a view of it, so the in-place scale
        # and masks cost autograd no copy
        scores = torch.matmul(wide(qi).permute(0, 2, 3, 1, 4), kt)
        scores.mul_(dh ** -0.5)
        if causal:
            rows = i * bq + torch.arange(bq, device=q.device)
            cols = torch.arange(t, device=q.device)
            scores.masked_fill_(rows[:, None] < cols[None, :], -1e30)
        if kv_len_mask is not None:
            scores.masked_fill_(~kv_len_mask[:, None, None, None, :], -1e30)
        p = torch.softmax(scores, dim=-1)
        del scores
        o = torch.matmul(p, vt)                       # (B, Hkv, G, bq, Dv)
        return o.permute(0, 3, 1, 2, 4).reshape(b, bq, h, v.shape[-1])

    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    blocks = []
    for i in range(s // bq):
        qi = sharding.view_heads(q[:, i * bq:(i + 1) * bq],
                                 (b, bq, hkv, group, dh), "kv_heads")
        if remat:
            from torch.utils.checkpoint import checkpoint
            blocks.append(checkpoint(block, qi, kt, vt, i,
                                     use_reentrant=False,
                                     preserve_rng_state=False))
        else:
            blocks.append(block(qi, kt, vt, i))
    return torch.cat(blocks, dim=1).to(q.dtype)


def _quant_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per (token, head): values and f32 scales."""
    s = torch.clamp(x.abs().amax(dim=-1), min=1e-6) / 127.0
    qx = torch.clamp(torch.round(x / s[..., None]), -127, 127)
    return qx.to(torch.int8), s.float()


def apply_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor,
                    cache: dict | None = None,
                    cache_index: torch.Tensor | int | None = None,
                    page_table: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, dict | None]:
    """``cache=None`` is the full-sequence prefill. With ``page_table``
    (B, P), the ``{"k", "v"}`` cache is one layer's page pool of
    (num_pages, page_len, Hkv, D): this step's K/V are scattered into it
    IN PLACE at ``positions``. A chunked prefill (S>1), or a pool of
    ``DTensor``s, gathers each slot's pages back and attends through the
    masked plain branch; a one-token decode (S=1) on a plain pool reads
    each row's own pages through ``kops.paged_decode_attention``, up to
    its own position (a row on the scratch page reads nothing and gets
    zeros). Otherwise a cache of
    (B, T, Hkv, D) is one decode step, written IN PLACE at
    ``cache_index`` (a (B,) vector of per-slot positions, or one scalar
    position for the whole batch) and returned. An int8 cache (with f32
    ``k_scale``/``v_scale`` of (B, T, Hkv)) is quantized on the scalar
    branch only: as in the reference, the vector branch comes first and
    writes int8 leaves as plain values (ROADMAP.md queue 3)."""
    b, s, d = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xn = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q = sharding.view_heads(xn @ p["wq"], (b, s, hq, hd), "heads")
    k = sharding.view_heads(xn @ p["wk"], (b, s, hkv, hd),
                          "kv_heads")
    v = sharding.view_heads(xn @ p["wv"], (b, s, hkv, hd),
                          "kv_heads")
    q = rotary(q, positions, cfg.rope_theta)
    k = rotary(k, positions, cfg.rope_theta)
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    k = constrain(k, "batch", "seq", "kv_heads", "head_dim")

    if cache is None:
        causal = cfg.causal and not cfg.is_encoder
        o = _sdpa(q, k, v, cfg, causal=causal)
        new_cache = {"k": k, "v": v}
    elif page_table is not None:
        # the scatter comes before the gather, as in the reference: a
        # chunk's queries see the chunk's own keys
        ck = _paged_scatter(cache["k"], page_table, positions, k)
        cv = _paged_scatter(cache["v"], page_table, positions, v)
        if s == 1 and paged_decode_applies(ck, q):
            # one query a row: each row's own pages, where they lie, up to
            # its own position (rows on the scratch page read nothing)
            tracing.count("attn.paged_decode", 1)
            with tracing.span("attn.core"):
                o = kops.paged_decode_attention(q, ck, cv, page_table,
                                                positions)
        else:
            kg = _paged_gather(ck, page_table)
            vg = _paged_gather(cv, page_table)
            o = _sdpa(q, kg, vg, cfg, causal=False,
                      kv_len_mask=_paged_valid(kg.shape[1], positions))
        new_cache = {"k": ck, "v": cv}
    elif cache["k"].dtype == torch.int8 and not _is_vector(cache_index):
        # int8-quantized cache (per token×head symmetric scales): halves
        # the decode memory traffic
        ck, cv = cache["k"], cache["v"]
        cks, cvs = cache["k_scale"], cache["v_scale"]
        sl = slice(cache_index, cache_index + s)
        ck[:, sl], cks[:, sl] = _quant_int8(k.float())
        cv[:, sl], cvs[:, sl] = _quant_int8(v.float())
        kf = (ck.float() * cks[..., None]).to(x.dtype)
        vf = (cv.float() * cvs[..., None]).to(x.dtype)
        valid = _decode_valid(ck.shape[1], cache_index, x.device)
        o = _sdpa(q, kf, vf, cfg, causal=False, kv_len_mask=valid)
        new_cache = {"k": ck, "v": cv, "k_scale": cks, "v_scale": cvs}
    else:
        ck, cv = cache["k"], cache["v"]
        if _is_vector(cache_index):
            # continuous batching: per-slot cache positions (B,)
            b_idx = torch.arange(b, device=x.device)
            ck[b_idx, cache_index] = k[:, 0].to(ck.dtype)
            cv[b_idx, cache_index] = v[:, 0].to(cv.dtype)
        else:
            # one-token decode against a preallocated S_max ring
            ck[:, cache_index:cache_index + s] = k.to(ck.dtype)
            cv[:, cache_index:cache_index + s] = v.to(cv.dtype)
        valid = _decode_valid(ck.shape[1], cache_index, x.device)
        o = _sdpa(q, ck, cv, cfg, causal=False, kv_len_mask=valid)
        new_cache = {"k": ck, "v": cv}
    # whole heads before they merge: a DTensor output of a cache sharded
    # on head_dim cannot be viewed across that split
    o = constrain(o, "batch", "seq", "heads", "head_dim")
    o = o.reshape(b, s, hq * hd)
    o = constrain(o, "batch", "seq", "q_features")
    return x + (o @ p["wo"]).to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# MLA (deepseek-v2): low-rank KV with decoupled RoPE; cache = (c_kv, k_rope)
# ---------------------------------------------------------------------------


def init_mla(cfg: ModelConfig, generator: torch.Generator | None,
             device) -> dict[str, torch.Tensor]:
    d, h = cfg.d_model, cfg.num_heads
    nd, rd, vd, r = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    pd = cfg.parameter_dtype
    return {
        "attn_norm": torch.ones((d,), dtype=pd, device=device),
        "wq": _init(generator, (d, h * (nd + rd)), d, pd, device),
        "w_dkv": _init(generator, (d, r + rd), d, pd, device),
        "kv_norm": torch.ones((r,), dtype=pd, device=device),
        "w_uk": _init(generator, (r, h * nd), r, pd, device),
        "w_uv": _init(generator, (r, h * vd), r, pd, device),
        "wo": _init(generator, (h * vd, d), h * vd, pd, device),
    }


def apply_mla(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, cache: dict | None = None,
              cache_index: torch.Tensor | int | None = None,
              page_table: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, dict | None]:
    """MLA over the same cache branches as :func:`apply_attention`: none,
    paged (``{"c_kv", "k_rope"}`` pools of (num_pages, page_len, r) and
    (num_pages, page_len, rd)), per-slot vector and scalar ring, each
    written IN PLACE. ``cfg.mla_absorbed`` scores against the compressed
    cache directly whenever there is one."""
    b, s, d = x.shape
    h = cfg.num_heads
    nd, rd, vd, r = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    xn = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q = sharding.view_heads(xn @ p["wq"], (b, s, h, nd + rd), "heads")
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = rotary(q_rope, positions, cfg.rope_theta)

    dkv = xn @ p["w_dkv"]                       # (b, s, r + rd)
    c_kv = rms_norm(dkv[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = rotary(dkv[..., r:][:, :, None, :], positions,
                    cfg.rope_theta)[:, :, 0]    # (b, s, rd), shared per head

    paged = cache is not None and page_table is not None
    valid = None
    if paged:
        ckv_pages = _paged_scatter(cache["c_kv"], page_table, positions, c_kv)
        kr_pages = _paged_scatter(cache["k_rope"], page_table, positions,
                                  k_rope)
        new_cache = {"c_kv": ckv_pages, "k_rope": kr_pages}
        c_kv = _paged_gather(ckv_pages, page_table)
        k_rope = _paged_gather(kr_pages, page_table)
        valid = _paged_valid(c_kv.shape[1], positions)
    elif cache is not None:
        ckv, kr = cache["c_kv"], cache["k_rope"]
        if _is_vector(cache_index):     # continuous batching
            b_idx = torch.arange(b, device=x.device)
            ckv[b_idx, cache_index] = c_kv[:, 0].to(ckv.dtype)
            kr[b_idx, cache_index] = k_rope[:, 0].to(kr.dtype)
        else:
            ckv[:, cache_index:cache_index + s] = c_kv.to(ckv.dtype)
            kr[:, cache_index:cache_index + s] = k_rope.to(kr.dtype)
        c_kv, k_rope = ckv, kr
    if not paged:
        new_cache = {"c_kv": c_kv, "k_rope": k_rope}
        if cache is not None:
            valid = _decode_valid(c_kv.shape[1], cache_index, x.device)
    t = c_kv.shape[1]

    if cache is not None and cfg.mla_absorbed:
        # fold W_uk into the query and W_uv into the output, so attention
        # runs against the compressed cache (the same math):
        #   qᵀ(c W_uk) = (q W_ukᵀ)ᵀ c      p (c W_uv) = (p c) W_uv
        with tracing.span("attn.core"):
            w_uk = p["w_uk"].reshape(r, h, nd).float()
            w_uv = p["w_uv"].reshape(r, h, vd).float()
            q_abs = torch.einsum("bshd,rhd->bshr", q_nope.float(), w_uk)
            scale = (nd + rd) ** -0.5
            scores = (torch.einsum("bshr,btr->bhst", q_abs, c_kv.float())
                      + torch.einsum("bshd,btd->bhst", q_rope.float(),
                                     k_rope.float())) * scale
            vm = (valid[:, None, None, :] if valid.ndim == 2
                  else valid[:, None])      # (B,1,S,T) per-query paged mask
            scores = torch.where(vm, scores, -1e30)
            pr = torch.softmax(scores, dim=-1)
            ctx = torch.einsum("bhst,btr->bshr", pr, c_kv.float())
            o = torch.einsum("bshr,rhd->bshd", ctx, w_uv)
        o = constrain(o, "batch", "seq", "heads", "head_dim")
        o = o.reshape(b, s, h * vd).to(x.dtype)
        return x + (o @ p["wo"]).to(x.dtype), new_cache

    # naive MLA: expand the compressed cache to per-head K/V
    k_nope = sharding.view_heads(c_kv @ p["w_uk"], (b, t, h, nd),
                                 "heads")
    vfull = sharding.view_heads(c_kv @ p["w_uv"], (b, t, h, vd),
                                "heads")
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, t, h, rd)],
                       dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    if cache is None:
        o = _sdpa(q_full, k_full, vfull, cfg, causal=True)
    else:
        o = _sdpa(q_full, k_full, vfull, cfg, causal=False, kv_len_mask=valid)
    o = constrain(o, "batch", "seq", "heads", "head_dim")
    o = o.reshape(b, s, h * vd)
    return x + (o @ p["wo"]).to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# dense FFN (SwiGLU)
# ---------------------------------------------------------------------------


def init_ffn(cfg: ModelConfig, generator: torch.Generator | None, device,
             d_ff: int | None = None, prefix: str = ""
             ) -> dict[str, torch.Tensor]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    pd = cfg.parameter_dtype
    out = {
        prefix + "w_gate": _init(generator, (d, f), d, pd, device),
        prefix + "w_up": _init(generator, (d, f), d, pd, device),
        prefix + "w_down": _init(generator, (f, d), f, pd, device),
    }
    if not prefix:
        out["ffn_norm"] = torch.ones((d,), dtype=pd, device=device)
    return out


def apply_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig,
              prefix: str = "") -> torch.Tensor:
    h = F.silu(x @ p[prefix + "w_gate"]) * (x @ p[prefix + "w_up"])
    h = (constrain(h, "batch", "seq", "mlp") if h.ndim == 3
         else constrain(h, "batch", "mlp"))   # shared-expert path: (T, d)
    return (h @ p[prefix + "w_down"]).to(x.dtype)


def apply_dense_block(p: Params, x: torch.Tensor, cfg: ModelConfig
                      ) -> torch.Tensor:
    xn = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    return x + apply_ffn(p, xn, cfg)


# ---------------------------------------------------------------------------
# MoE: top-k token choice, capacity buffers
# ---------------------------------------------------------------------------


def init_moe(cfg: ModelConfig, generator: torch.Generator | None,
             device) -> dict[str, torch.Tensor]:
    d, e, fe = cfg.d_model, cfg.num_experts, cfg.d_ff_expert
    pd = cfg.parameter_dtype
    out = {
        "ffn_norm": torch.ones((d,), dtype=pd, device=device),
        "router": _init(generator, (d, e), d, torch.float32, device),
        "moe_gate": _init(generator, (e, d, fe), d, pd, device),
        "moe_up": _init(generator, (e, d, fe), d, pd, device),
        "moe_down": _init(generator, (e, fe, d), fe, pd, device),
    }
    if cfg.num_shared_experts:
        out.update(init_ffn(cfg, generator, device,
                            d_ff=cfg.num_shared_experts * fe,
                            prefix="shared_"))
    return out


def moe_capacity(tokens: int, cfg: ModelConfig) -> int:
    cap = math.ceil(tokens * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    return max(8, -(-cap // 8) * 8)   # round up to 8 for tiling


def apply_moe_block(p: Params, x: torch.Tensor, cfg: ModelConfig
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (residual_out, router_aux_loss).

    Each token's top-k experts (ties to the lower index, as
    ``jax.lax.top_k``: a stable descending sort) take it into a buffer of
    ``moe_capacity`` rows per expert, in token order; a choice past its
    expert's capacity is dropped. Dropped choices are clamped into the
    buffer and masked, where JAX's gather clamps by itself (a CUDA index
    out of range is a device assert)."""
    b, s, d = x.shape
    xn = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    t = b * s
    xt_sharded = xn.reshape(t, d)
    e, k = cfg.num_experts, cfg.top_k
    dev = x.device

    # on DTensor parameters the routing below (sort, index_add_,
    # index_put_ with accumulate, the clamped gather) runs on whole
    # tensors every rank holds alike: DTensor has no sharding rule for
    # index_add_ into a fresh buffer, and a whole routing keeps the
    # reference's capacity ranks over all tokens. Only the expert
    # products run sharded. Unsharded, both are the tensors themselves.
    with tracing.span("moe.route"):
        logits = sharding.full_tensor(wide(xt_sharded) @ p["router"])  # (T, E)
        xt = sharding.full_tensor(xt_sharded)
        probs = torch.softmax(logits, dim=-1)
        top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_p, top_i = top_p[:, :k], top_i[:, :k]                # (T, k)
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

        # load-balance aux (Switch-style) + router z-loss
        flat_e = top_i.reshape(-1)                               # (T·k,)
        # per-expert counts by index_add_, not bincount (whose CUDA version
        # reads the maximum back to the host, a sync per layer)
        counts = torch.zeros((e,), dtype=torch.long, device=dev).index_add_(
            0, flat_e, torch.ones_like(flat_e))
        me = probs.mean(dim=0)
        ce = counts.float() / (t * k)
        aux = e * torch.sum(me * ce) + cfg.router_z_coef * torch.mean(
            torch.logsumexp(logits, dim=-1) ** 2)

        # capacity dispatch: rank of each (token, choice) within its expert
        cap = moe_capacity(t, cfg)
        order = torch.argsort(flat_e, stable=True)
        starts = torch.cumsum(counts, 0) - counts
        ranks_sorted = torch.arange(t * k, device=dev) - starts[flat_e[order]]
        slot = torch.empty_like(ranks_sorted)
        slot[order] = ranks_sorted
        keep = slot < cap
        tok = torch.arange(t * k, device=dev) // k

        # dropped choices add zeros at (e-1, cap-1), as in the reference
        buf = torch.zeros((e, cap, d), dtype=xt.dtype, device=dev)
        buf.index_put_((torch.where(keep, flat_e, e - 1),
                        torch.where(keep, slot, cap - 1)),
                       torch.where(keep[:, None], xt[tok], 0), accumulate=True)
        buf = constrain(sharding.on_mesh_of(buf, xt_sharded),
                        "experts", "capacity", "embed")

    with tracing.span("moe.experts"):
        h = F.silu(torch.bmm(buf, p["moe_gate"])) * torch.bmm(buf, p["moe_up"])
        h = constrain(h, "experts", "capacity", "mlp")
        out_buf = torch.bmm(h, p["moe_down"])                    # (E, cap, d)
        out_buf = sharding.full_tensor(
            constrain(out_buf, "experts", "capacity", "embed"))
        shared = (apply_ffn(p, xt_sharded, cfg, prefix="shared_")
                  if cfg.num_shared_experts else None)

    with tracing.span("moe.combine"):
        gathered = out_buf[flat_e, torch.clamp(slot, max=cap - 1)]   # (T·k, d)
        gathered = torch.where(keep[:, None], gathered, 0)
        # the k choices of a token are adjacent rows: sum them in order
        y = (gathered * top_p.reshape(-1)[:, None].to(xt.dtype)
             ).reshape(t, k, d).sum(dim=1)

        # the whole-tensor results rejoin the mesh, so that autograd hands
        # their gradients back as plain tensors
        y = sharding.on_mesh_of(y, xt_sharded)
        aux = sharding.on_mesh_of(aux, xt_sharded)
        if shared is not None:
            y = y + shared
    y = constrain(y.reshape(b, s, d), "batch", "seq", "embed")
    return x + y.to(x.dtype), aux
