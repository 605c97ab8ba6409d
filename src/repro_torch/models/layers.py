"""Building blocks of the dense GQA transformer, in PyTorch.

Twin of the dense subset of ``repro/models/layers.py``: ``rms_norm``,
``rotary``, GQA attention with its four cache branches (none, paged,
per-slot vector, scalar ring), the paged scatter and gather, and the
SwiGLU FFN. Parameters are plain mappings of tensors, as the JAX package's are
dicts. Weights keep JAX's ``(in, out)`` layout and multiply as
``x @ W``, so a converted JAX pytree needs no transpose.

Sharding annotations (``constrain``) have no counterpart yet: the port
runs on one card (ROADMAP.md, queue 1 item 9).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig

NOT_PORTED = "not ported to PyTorch yet (ROADMAP.md, queue 1 item 7)"

Params = Mapping[str, torch.Tensor]


def _init(generator: torch.Generator, shape, scale_dim: int, dtype,
          device) -> torch.Tensor:
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * (scale_dim ** -0.5)).to(dtype)


# ---------------------------------------------------------------------------
# norms / rotary
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 statistics; cast to ``x.dtype`` *before* the scale multiply."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float
           ) -> torch.Tensor:
    """x: (..., S, H, D) with llama-style half rotation; positions: (..., S)."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = positions[..., None].float() * freqs        # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
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
    assert and the JAX gather would clamp."""
    pl = pages.shape[1]
    phys = torch.gather(page_table, 1, positions // pl)
    pages.index_put_((phys, positions % pl), vals.to(pages.dtype),
                     accumulate=False)
    return pages


def _paged_gather(pages: torch.Tensor, page_table: torch.Tensor
                  ) -> torch.Tensor:
    """Gather each slot's pages back into a (B, P*page_len, ...) view."""
    b, p = page_table.shape
    return pages[page_table].reshape(b, p * pages.shape[1], *pages.shape[2:])


def _paged_valid(t: int, positions: torch.Tensor) -> torch.Tensor:
    """(B, S, t) causal mask against absolute per-token positions."""
    return (torch.arange(t, device=positions.device)[None, None, :]
            <= positions[:, :, None])


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


def _sdpa(q, k, v, cfg: ModelConfig, *, causal: bool,
          kv_len_mask: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B,S,H,D); k/v: (B,T,Hkv,D).  kv_len_mask: (B,T) valid-slot mask
    (decode against a preallocated cache) or (B,S,T) per-query positional
    mask (paged chunked prefill). A mask always takes the plain branch,
    never flash."""
    b, s, h, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if cfg.attention_impl == "flash" and kv_len_mask is None and s == t:
        qf = q.transpose(1, 2).reshape(b * h, s, dh).contiguous()
        kf = k.transpose(1, 2).reshape(b * hkv, t, dh).contiguous()
        vf = v.transpose(1, 2).reshape(b * hkv, t, dh).contiguous()
        o = kops.flash_attention(qf, kf, vf, num_q_heads=h, num_kv_heads=hkv,
                                 causal=causal)
        return o.reshape(b, h, s, dh).transpose(1, 2)
    if cfg.attention_impl == "chunked":
        raise NotImplementedError(f"attention_impl='chunked' is {NOT_PORTED}")
    group = h // hkv
    qg = q.reshape(b, s, hkv, group, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k.float()) * (dh ** -0.5)
    if causal and s == t:
        mask = torch.ones((s, t), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, -1e30)
    if kv_len_mask is not None:
        m = (kv_len_mask[:, None, None, None, :] if kv_len_mask.ndim == 2
             else kv_len_mask[:, None, None, :, :])
        scores = torch.where(m, scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(b, s, h, v.shape[-1]).to(q.dtype)


def apply_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor,
                    cache: dict | None = None,
                    cache_index: torch.Tensor | int | None = None,
                    page_table: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, dict | None]:
    """``cache=None`` is the full-sequence prefill. With ``page_table``
    (B, P), the ``{"k", "v"}`` cache is one layer's page pool of
    (num_pages, page_len, Hkv, D): this step's K/V are scattered into it
    IN PLACE at ``positions`` and each slot's pages gathered back, for
    one-token decode (S=1) and chunked prefill alike. Otherwise a cache of
    (B, T, Hkv, D) is one decode step, written IN PLACE at
    ``cache_index`` (a (B,) vector of per-slot positions, or one scalar
    position for the whole batch) and returned."""
    b, s, d = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xn = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q = (xn @ p["wq"]).reshape(b, s, hq, hd)
    k = (xn @ p["wk"]).reshape(b, s, hkv, hd)
    v = (xn @ p["wv"]).reshape(b, s, hkv, hd)
    q = rotary(q, positions, cfg.rope_theta)
    k = rotary(k, positions, cfg.rope_theta)

    if cache is None:
        causal = cfg.causal and not cfg.is_encoder
        o = _sdpa(q, k, v, cfg, causal=causal)
        new_cache = {"k": k, "v": v}
    elif page_table is not None:
        # the scatter comes before the gather, as in the reference: a
        # chunk's queries see the chunk's own keys
        ck = _paged_scatter(cache["k"], page_table, positions, k)
        cv = _paged_scatter(cache["v"], page_table, positions, v)
        kg = _paged_gather(ck, page_table)
        vg = _paged_gather(cv, page_table)
        o = _sdpa(q, kg, vg, cfg, causal=False,
                  kv_len_mask=_paged_valid(kg.shape[1], positions))
        new_cache = {"k": ck, "v": cv}
    elif cache["k"].dtype == torch.int8:
        raise NotImplementedError(f"the int8 KV cache is {NOT_PORTED}")
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
    o = o.reshape(b, s, hq * hd)
    return x + (o @ p["wo"]).to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# dense FFN (SwiGLU)
# ---------------------------------------------------------------------------


def init_ffn(cfg: ModelConfig, generator: torch.Generator,
             device) -> dict[str, torch.Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    pd = cfg.parameter_dtype
    return {
        "w_gate": _init(generator, (d, f), d, pd, device),
        "w_up": _init(generator, (d, f), d, pd, device),
        "w_down": _init(generator, (f, d), f, pd, device),
        "ffn_norm": torch.ones((d,), dtype=pd, device=device),
    }


def apply_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return (h @ p["w_down"]).to(x.dtype)


def apply_dense_block(p: Params, x: torch.Tensor, cfg: ModelConfig
                      ) -> torch.Tensor:
    xn = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    return x + apply_ffn(p, xn, cfg)
