"""Gradient compression with error feedback (distributed-optimization trick).

Twin of ``repro/parallel/compression.py``. int8 symmetric quantization per
leaf: the all-reduce wire traffic drops 4x (f32) / 2x (bf16). The
quantization residual is carried in an error-feedback buffer and re-added
next step, which preserves SGD/Adam convergence (1-bit Adam / EF-SGD).
Leaves are tensors in dicts by parameter name.
"""

from __future__ import annotations

import torch


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-12) / 127.0


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = _scale(torch.max(torch.abs(x)))
    return _quantize(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(scale.dtype) * scale


def compress_leaf(g: torch.Tensor, ef: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize (g + residual); return (dequantized grad, new residual)."""
    g32 = g.to(ef.dtype) + ef
    q, scale = quantize_int8(g32)
    deq = dequantize_int8(q, scale)
    return deq.to(g.dtype), g32 - deq


def compress_tree(grads: dict, ef_state: dict, groups: dict
                  ) -> tuple[dict, dict]:
    """:func:`compress_leaf` over the leaves by name, where ``groups``
    maps each name to a group key and the leaves of one group share one
    scale, from the max over all of them. The reference stacks the
    layers of a unit position into one leaf (``units/b{i}/<name>``) and
    quantizes that stacked leaf as one, which the port's per-layer leaves
    match by grouping (``repro_torch.train.loop.stacked_leaf``)."""
    g32 = {k: g.to(ef_state[k].dtype) + ef_state[k]
           for k, g in grads.items()}
    amax: dict = {}
    for k, x in g32.items():
        m = torch.max(torch.abs(x))
        key = groups[k]
        amax[key] = m if key not in amax else torch.maximum(amax[key], m)
    new_g, new_ef = {}, {}
    for k, x in g32.items():
        scale = _scale(amax[groups[k]])
        deq = dequantize_int8(_quantize(x, scale), scale)
        new_g[k], new_ef[k] = deq.to(grads[k].dtype), x - deq
    return new_g, new_ef
