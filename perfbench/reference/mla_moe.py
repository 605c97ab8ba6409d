"""Plain reference of a DeepSeek-V2-style decoder (deepseek-v2-lite):
multi-head latent attention (a compressed KV of ``kv_lora_rank`` with a
shared rotary key, no query compression), and a routed MoE with shared
experts, after ``first_k_dense_replace`` dense layers. The attention is
written in its expanded form (keys and values rebuilt per head from the
latent), which the absorbed form equals. Routing is a softmax over the
experts, the top ``num_experts_per_tok`` by a stable descending sort
(ties to the lower index), renormalised where ``norm_topk_prob`` says,
and no token is ever dropped."""

from __future__ import annotations

import torch

from perfbench.reference.common import (Precision, causal_attention,
                                        rms_norm, rotary, swiglu)


def sizes(cfg: dict) -> dict:
    return {"d": cfg["hidden_size"], "h": cfg["num_attention_heads"],
            "nd": cfg["qk_nope_head_dim"], "rd": cfg["qk_rope_head_dim"],
            "vd": cfg["v_head_dim"], "r": cfg["kv_lora_rank"],
            "e": cfg["n_routed_experts"], "k": cfg["num_experts_per_tok"],
            "fe": cfg["moe_intermediate_size"],
            "shared": cfg["n_shared_experts"],
            "f": cfg["intermediate_size"], "vocab": cfg["vocab_size"],
            "layers": cfg["num_hidden_layers"],
            "dense_first": cfg.get("first_k_dense_replace", 0)}


def is_moe(cfg: dict, index: int) -> bool:
    return index >= sizes(cfg)["dense_first"]


def layer_specs(cfg: dict, layer: int) -> list[tuple]:
    """(name, shape, fan_in) of one layer's weights; fan_in None marks a
    norm scale, "router" the float32 router."""
    z = sizes(cfg)
    d, h, nd, rd, vd, r = z["d"], z["h"], z["nd"], z["rd"], z["vd"], z["r"]
    specs = [("attn_norm", (d,), None), ("wq", (d, h * (nd + rd)), d),
             ("w_dkv", (d, r + rd), d), ("kv_norm", (r,), None),
             ("w_uk", (r, h * nd), r), ("w_uv", (r, h * vd), r),
             ("wo", (h * vd, d), h * vd), ("ffn_norm", (d,), None)]
    if not is_moe(cfg, layer):
        f = z["f"]
        return specs + [("w_gate", (d, f), d), ("w_up", (d, f), d),
                        ("w_down", (f, d), f)]
    e, fe, sf = z["e"], z["fe"], z["shared"] * z["fe"]
    specs += [("router", (d, e), "router"),
              ("moe_gate", (e, d, fe), d), ("moe_up", (e, d, fe), d),
              ("moe_down", (e, fe, d), fe)]
    if z["shared"]:
        specs += [("shared_w_gate", (d, sf), d), ("shared_w_up", (d, sf), d),
                  ("shared_w_down", (sf, d), sf)]
    return specs


def route(h: torch.Tensor, router: torch.Tensor, cfg: dict
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(weights (T, k), experts (T, k)) of tokens h (T, d)."""
    z = sizes(cfg)
    probs = torch.softmax(h @ router, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, : z["k"]], idx[:, : z["k"]]
    if cfg.get("norm_topk_prob"):
        w = w / w.sum(-1, keepdim=True)
    return w * cfg.get("routed_scaling_factor", 1), idx


def moe(p: dict, h: torch.Tensor, cfg: dict, prec: Precision
        ) -> torch.Tensor:
    w, idx = route(h, p["router"], cfg)
    out = torch.zeros_like(h)
    for e in torch.unique(idx).tolist():
        tok, slot = (idx == e).nonzero(as_tuple=True)
        y = swiglu(h[tok], p["moe_gate"][e], p["moe_up"][e],
                   p["moe_down"][e], prec)
        out = out.index_add(0, tok, y * w[tok, slot][:, None])
    if "shared_w_gate" in p:
        out = out + swiglu(h, p["shared_w_gate"], p["shared_w_up"],
                           p["shared_w_down"], prec)
    return out


def layer(p: dict, x: torch.Tensor, cfg: dict, positions: torch.Tensor,
          prec: Precision, index: int) -> torch.Tensor:
    """One decoder layer over one sequence x (S, d), float32."""
    z = sizes(cfg)
    s = x.shape[0]
    h, nd, rd, vd, r = z["h"], z["nd"], z["rd"], z["vd"], z["r"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    hn = rms_norm(x, p["attn_norm"], eps)
    q = prec.mm(hn, p["wq"]).view(s, h, nd + rd)
    q = torch.cat([q[..., :nd], rotary(q[..., nd:], positions, theta)], -1)
    dkv = prec.mm(hn, p["w_dkv"])
    c = rms_norm(dkv[:, :r], p["kv_norm"], eps)
    k_rope = rotary(dkv[:, None, r:], positions, theta)      # (S, 1, rd)
    k_nope = prec.mm(c, p["w_uk"]).view(s, h, nd)
    v = prec.mm(c, p["w_uv"]).view(s, h, vd)
    k = torch.cat([k_nope, k_rope.expand(s, h, rd)], -1)
    o = causal_attention(q, k, v, (nd + rd) ** -0.5, prec)
    x = x + prec.mm(o.reshape(s, h * vd), p["wo"])
    hn = rms_norm(x, p["ffn_norm"], eps)
    if is_moe(cfg, index):
        return x + moe(p, hn, cfg, prec)
    return x + swiglu(hn, p["w_gate"], p["w_up"], p["w_down"], prec)
