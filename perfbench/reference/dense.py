"""Plain reference of a llama-style dense decoder (granite-8b): RMSNorm,
grouped-query attention with rotary positions, a SwiGLU MLP, a final
norm and an untied head. Sizes come from the configuration file's
published keys; weights are named as the benchmark makes them."""

from __future__ import annotations

import torch

from perfbench.reference.common import (Precision, causal_attention,
                                        rms_norm, rotary, swiglu)


def sizes(cfg: dict) -> dict:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"d": d, "h": h, "hkv": cfg["num_key_value_heads"],
            "hd": cfg.get("head_dim") or d // h,
            "f": cfg["intermediate_size"], "vocab": cfg["vocab_size"],
            "layers": cfg["num_hidden_layers"]}


def layer_specs(cfg: dict, layer: int) -> list[tuple]:
    """(name, shape, fan_in) of one layer's weights; fan_in None marks a
    norm scale."""
    z = sizes(cfg)
    d, h, hkv, hd, f = z["d"], z["h"], z["hkv"], z["hd"], z["f"]
    return [("attn_norm", (d,), None),
            ("wq", (d, h * hd), d), ("wk", (d, hkv * hd), d),
            ("wv", (d, hkv * hd), d), ("wo", (h * hd, d), h * hd),
            ("ffn_norm", (d,), None),
            ("w_gate", (d, f), d), ("w_up", (d, f), d),
            ("w_down", (f, d), f)]


def layer(p: dict, x: torch.Tensor, cfg: dict, positions: torch.Tensor,
          prec: Precision, index: int) -> torch.Tensor:
    """One decoder layer over one sequence x (S, d), float32."""
    z = sizes(cfg)
    s = x.shape[0]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    hn = rms_norm(x, p["attn_norm"], eps)
    q = prec.mm(hn, p["wq"]).view(s, z["h"], z["hd"])
    k = prec.mm(hn, p["wk"]).view(s, z["hkv"], z["hd"])
    v = prec.mm(hn, p["wv"]).view(s, z["hkv"], z["hd"])
    q, k = rotary(q, positions, theta), rotary(k, positions, theta)
    group = z["h"] // z["hkv"]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    o = causal_attention(q, k, v, z["hd"] ** -0.5, prec)
    x = x + prec.mm(o.reshape(s, z["h"] * z["hd"]), p["wo"])
    hn = rms_norm(x, p["ffn_norm"], eps)
    return x + swiglu(hn, p["w_gate"], p["w_up"], p["w_down"], prec)
