"""The work a step needs, counted from shapes, and the chip's peaks.

The counts follow the configuration file's published sizes through the
reference's weight list, never the program, so a roofline share reads
the same work whatever implements it. Useful work only: a token's
products with the weights it uses (2 FLOPs a weight; the embedding is a
lookup), attention over the live context and never the padded one, each
weight byte read once a step, the live keys and values read once and the
new ones written once.
"""

from __future__ import annotations

import math

from perfbench.reference import model as ref

#: NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s, HBM3 bytes/s
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}
EXPERT_WEIGHTS = ("moe_gate", "moe_up", "moe_down")


def _layers(cfg: dict):
    for group, specs in ref.specs(cfg):
        if group.startswith("layer."):
            yield specs


def _is_matrix(fan) -> bool:
    return fan is not None


def expert_layers(cfg: dict) -> int:
    return sum(any(n.rsplit(".", 1)[1] in EXPERT_WEIGHTS for n, _, _ in s)
               for s in _layers(cfg))


def counts(cfg: dict) -> dict[str, int]:
    """Weights by kind: ``embed`` (the lookup table), ``shared`` (every
    other matrix every token uses, the head and the router included),
    ``norms`` (the norm scales), ``expert`` (one routed expert of one
    layer) and ``total``."""
    out = {"embed": 0, "shared": 0, "norms": 0, "expert": 0, "total": 0}
    routed = 0
    for _, specs in ref.specs(cfg):
        for name, shape, fan in specs:
            n = math.prod(shape)
            out["total"] += n
            if name == "embed":
                out["embed"] += n
            elif name.rsplit(".", 1)[-1] in EXPERT_WEIGHTS:
                routed += n
            elif _is_matrix(fan):
                out["shared"] += n
            else:
                out["norms"] += n
    if routed:
        out["expert"] = routed // (cfg["n_routed_experts"]
                                   * expert_layers(cfg))
    return out


def active_matmul_weights(cfg: dict) -> int:
    """Matrix weights one token multiplies by: every shared matrix, the
    head and the router included, and ``num_experts_per_tok`` routed
    experts in each expert layer."""
    c = counts(cfg)
    k = cfg.get("num_experts_per_tok", 0)
    return c["shared"] + k * c["expert"] * expert_layers(cfg)


def kv_bytes_per_token(cfg: dict) -> int:
    """Cache bytes one token keeps over all layers."""
    item = ITEMSIZE[cfg["dtype"]]
    layers = cfg["num_hidden_layers"]
    if cfg["reference"] == "mla_moe":
        return layers * (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]) * item
    hd = cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]
    return layers * 2 * cfg["num_key_value_heads"] * hd * item


def attention_flops_per_pair(cfg: dict) -> int:
    """FLOPs of one (query, key) pair in one layer's forward: GQA's two
    products over the head dim; MLA's against the latent in its absorbed
    form (scores over kv_lora_rank + qk_rope, values over kv_lora_rank),
    the cheapest form a decode step can take."""
    h = cfg["num_attention_heads"]
    if cfg["reference"] == "mla_moe":
        return 2 * h * (2 * cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"])
    hd = cfg.get("head_dim") or cfg["hidden_size"] // h
    return 4 * h * hd


def experts_touched(cfg: dict, tokens: int) -> float:
    """Expected routed experts a layer reads for ``tokens`` tokens, under
    uniform routing: E (1 - (1 - k/E) ** tokens)."""
    e = cfg.get("n_routed_experts", 0)
    if not e or not tokens:
        return 0.0
    return e * (1 - (1 - cfg["num_experts_per_tok"] / e) ** tokens)


def serve_tick(cfg: dict, decode_ctx: list[int],
               chunks: list[tuple[int, int]]) -> tuple[float, float]:
    """(FLOPs, bytes) of one engine tick: decode tokens that attend to
    ``decode_ctx[i]`` positions each, and prefill chunks covering
    positions ``[a, b)`` of their prompt, each position attending to
    itself and the ones before it."""
    tokens = len(decode_ctx) + sum(b - a for a, b in chunks)
    if not tokens:
        return 0.0, 0.0
    pairs = sum(decode_ctx) + sum((b * (b + 1) - a * (a + 1)) // 2
                                  for a, b in chunks)
    layers = cfg["num_hidden_layers"]
    flops = (2.0 * active_matmul_weights(cfg) * tokens
             + attention_flops_per_pair(cfg) * layers * pairs)
    item = ITEMSIZE[cfg["dtype"]]
    c = counts(cfg)
    weights = (c["shared"] + c["norms"]
               + experts_touched(cfg, tokens) * c["expert"]
               * expert_layers(cfg)) * item
    weights += tokens * cfg["hidden_size"] * item          # embedding rows
    kv = kv_bytes_per_token(cfg)
    kv_read = kv * (sum(decode_ctx) + sum(b for _, b in chunks))
    return flops, weights + kv_read + kv * tokens


def train_step(cfg: dict, batch: int, seq: int,
               moment_bytes: int = 4) -> tuple[float, float]:
    """(FLOPs, bytes) of one training step on (batch, seq) tokens:
    forward and backward, 6 FLOPs a multiplied weight a token, attention
    over the causal pairs only, three times its forward; bytes: the
    parameters and both AdamW moments read once and written once."""
    tokens = batch * seq
    pairs = batch * seq * (seq + 1) // 2
    flops = (6.0 * active_matmul_weights(cfg) * tokens
             + 3.0 * attention_flops_per_pair(cfg)
             * cfg["num_hidden_layers"] * pairs)
    per_weight = ITEMSIZE[cfg["dtype"]] + 2 * moment_bytes
    return flops, 2.0 * per_weight * counts(cfg)["total"]


def least_seconds(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time of the work at the peaks, and which peak bounds."""
    t_f, t_b = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (t_f, "flops") if t_f >= t_b else (t_b, "bytes")
