"""AdamW + global-norm clip + cosine schedule, on tensors by name.

Twin of ``repro/optim/adamw.py``. Parameters, gradients and moments are
dicts of tensors keyed by parameter name (``TransformerLM``'s
``named_parameters()``); the update is a plain loop over the leaves, as
the reference's is, with its order of operations: the clip scale from
the global norm, then the moments, the bias corrections, the decay and
the step, all in float32, cast back at the end. ``torch.optim.AdamW``
orders its clip, decay and bias corrections otherwise, so it is not used.

``moment_dtype="bfloat16"`` halves optimizer memory; moments are widened
to float32 for the update math (a float64 run keeps float64).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch

from repro_torch import tracing

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

Tensors = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def _wide(x: torch.Tensor) -> torch.Tensor:
    """float32, or float64 where the tensor already is."""
    return x if x.dtype == torch.float64 else x.float()


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """``lr(step)``: a float32 0-d tensor on ``step``'s device (a Python
    int goes to the CPU), computed as the reference's ``jnp`` arithmetic
    computes it."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32,
                                     device=step.device)
        warm = f32(base_lr) * step / max(1, warmup)
        t = torch.clamp((step - warmup) / max(1, total - warmup), 0, 1)
        cos = f32(0.5 * base_lr) * (1 + torch.cos(f32(math.pi) * t))
        return torch.where(step < warmup, warm, cos)
    return lr


def adamw_init(params: Tensors, cfg: AdamWConfig) -> dict:
    """Zero moments in ``moment_dtype`` beside each parameter, and a 0-d
    int32 ``count`` on the parameters' device."""
    dt = _DT[cfg.moment_dtype]
    # zeros_like: a DTensor parameter gets moments laid out as it is
    zeros = lambda p: torch.zeros_like(p, dtype=dt)
    dev = next(iter(params.values())).device
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Tensors) -> torch.Tensor:
    total = None
    for x in tree.values():
        sq = torch.sum(torch.square(_wide(x)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@tracing.spanned("optim.adamw")
@torch.no_grad()
def adamw_update(grads: Tensors, state: dict, params: Tensors,
                 cfg: AdamWConfig, lr, *, in_place: bool = False
                 ) -> tuple[dict, dict, dict]:
    """Returns (new_params, new_state, metrics), each a dict by name.

    By default the inputs are left as they are and every output is a new
    tensor. ``in_place=True`` writes the new parameters, moments and
    count into the tensors of ``params`` and ``state`` and returns those
    same tensors (what ``jax.jit(..., donate_argnums=0)`` lets XLA do):
    no second copy of the state exists, which is what lets a full-width
    model train on one card. ``lr`` is a float or a 0-d tensor."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    wide = torch.float64 if gnorm.dtype == torch.float64 else torch.float32
    # 1 - b ** count, in float32 as jnp computes it from a weak float
    c1 = 1 - torch.tensor(cfg.b1, dtype=wide, device=count.device) ** count
    c2 = 1 - torch.tensor(cfg.b2, dtype=wide, device=count.device) ** count
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        g = _wide(grads[k]) * scale
        m32 = _wide(m) * cfg.b1 + (1 - cfg.b1) * g
        v32 = _wide(v) * cfg.b2 + (1 - cfg.b2) * g * g
        step = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        step = step + cfg.weight_decay * _wide(p)
        newp = _wide(p) - lr * step
        if in_place:
            p.copy_(newp)
            m.copy_(m32)
            v.copy_(v32)
            new_p[k], new_m[k], new_v[k] = p, m, v
        else:
            new_p[k] = newp.to(p.dtype)
            new_m[k], new_v[k] = m32.to(m.dtype), v32.to(v.dtype)
        del g, m32, v32, step, newp
    if in_place:
        state["count"].copy_(count)
        count = state["count"]
    return (new_p, {"m": new_m, "v": new_v, "count": count},
            {"grad_norm": gnorm, "clip_scale": scale})
