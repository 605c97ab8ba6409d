"""The whole-model references, layer by layer in float32 (or in the
control's fp8): the served logits of whole sequences, and the loss, the
gradients and AdamW of a training step.

The family's module (``dense`` or ``mla_moe``, named by the
configuration file's ``reference`` key) gives each layer's weights and
its float32 forward; this module adds the embedding, the final norm, the
head, the loss and the backward pass, which recomputes one layer at a
time from its saved input. Weights come as the benchmark made them, a
dict by name; each layer's are widened to float32 only while it runs.
"""

from __future__ import annotations

import importlib

import torch
import torch.nn.functional as F

from perfbench.reference.common import Precision, rms_norm


def family(cfg: dict):
    return importlib.import_module(f"perfbench.reference.{cfg['reference']}")


def specs(cfg: dict) -> list[tuple[str, list[tuple]]]:
    """The model's weights in groups, in the order they are made: (group,
    [(name, shape, fan_in)]). Groups: ``embed``, ``layer.<i>`` (names
    ``blocks.<i>.<name>``), ``final``."""
    fam = family(cfg)
    d, vocab = cfg["hidden_size"], cfg["vocab_size"]
    out = [("embed", [("embed", (vocab, d), d)])]
    for i in range(cfg["num_hidden_layers"]):
        out.append((f"layer.{i}", [(f"blocks.{i}.{n}", shape, fan)
                                   for n, shape, fan in fam.layer_specs(cfg, i)]))
    final = [("final_norm", (d,), None)]
    if not cfg.get("tie_word_embeddings"):
        final.append(("head", (d, vocab), d))
    out.append(("final", final))
    return out


def layer_weights(weights: dict, i: int, dtype=torch.float32) -> dict:
    pre = f"blocks.{i}."
    return {k[len(pre):]: w.to(dtype) for k, w in weights.items()
            if k.startswith(pre)}


def head(weights: dict) -> torch.Tensor:
    return weights["head"] if "head" in weights else weights["embed"].T


@torch.no_grad()
def served_logits(weights: dict, cfg: dict, seqs: list[torch.Tensor],
                  rows: list[torch.Tensor], prec: Precision) -> list:
    """Float32 logits (len(rows_i), vocab) at positions ``rows_i`` of each
    whole sequence ``seqs_i`` (token ids (S_i,)), every position seeing
    itself and the positions before it. Layer by layer over all
    sequences, so each layer's weights are widened once."""
    fam = family(cfg)
    xs = [weights["embed"][s].float() for s in seqs]
    pos = [torch.arange(len(s), device=s.device) for s in seqs]
    for i in range(cfg["num_hidden_layers"]):
        p = layer_weights(weights, i)
        xs = [fam.layer(p, x, cfg, ps, prec, i) for x, ps in zip(xs, pos)]
        del p
    norm, w = weights["final_norm"].float(), head(weights).float()
    return [prec.mm(rms_norm(x[r], norm, cfg["rms_norm_eps"]), w)
            for x, r in zip(xs, rows)]


def _sequences(fam, p, x, cfg, pos, prec, i):
    return torch.stack([fam.layer(p, x[b], cfg, pos, prec, i)
                        for b in range(x.shape[0])])


def loss(weights: dict, cfg: dict, tokens: torch.Tensor,
         labels: torch.Tensor, prec: Precision, grads: bool = True):
    """Mean next-token cross entropy of tokens (B, S) against labels
    (B, S), and with ``grads`` its float32 gradient for every weight by
    name. The backward pass recomputes each layer from its saved input,
    from the last layer to the first, so one layer's activations exist
    at a time."""
    fam = family(cfg)
    n = cfg["num_hidden_layers"]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    with torch.no_grad():
        x = weights["embed"][tokens].float()
        saved = []
        for i in range(n):
            saved.append(x)
            x = _sequences(fam, layer_weights(weights, i), x, cfg, pos,
                           prec, i)
    norm = weights["final_norm"].float().detach().requires_grad_(grads)
    w = head(weights).float().detach().requires_grad_(grads)
    x = x.requires_grad_(grads)
    with torch.set_grad_enabled(grads):
        logits = prec.mm(rms_norm(x, norm, cfg["rms_norm_eps"]), w)
        value = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                labels.reshape(-1))
    if not grads:
        return value.detach(), None
    out = {}
    g_norm, g_head, g_x = torch.autograd.grad(value, [norm, w, x])
    del logits
    out["final_norm"] = g_norm
    if "head" in weights:
        out["head"] = g_head
    for i in reversed(range(n)):
        p = {k: t.detach().requires_grad_(True)
             for k, t in layer_weights(weights, i).items()}
        xi = saved.pop().requires_grad_(True)
        with torch.enable_grad():
            y = _sequences(fam, p, xi, cfg, pos, prec, i)
        names = list(p)
        got = torch.autograd.grad(y, [xi] + [p[k] for k in names], g_x)
        g_x = got[0]
        for k, g in zip(names, got[1:]):
            out[f"blocks.{i}.{k}"] = g
        del p, xi, y, got
    g_embed = torch.zeros(weights["embed"].shape, dtype=torch.float32,
                          device=g_x.device)
    g_embed.index_add_(0, tokens.reshape(-1),
                       g_x.reshape(-1, g_x.shape[-1]))
    if "head" not in weights:
        g_embed += g_head.T
    out["embed"] = g_embed
    return value.detach(), out
