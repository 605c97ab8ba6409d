"""Plain float32 pieces of the references: the norm, rotary, attention,
the SwiGLU MLP, and the matrix product in the precision a run asks for.

Nothing here imports the program. Weights are ``(in, out)`` matrices
multiplied as ``x @ W``, the layout the benchmark makes them in. On CUDA
the product runs in full float32: TF32 is switched off by
:func:`full_f32` before a reference runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: the largest finite float8 e4m3 value (OCP FP8, "e4m3fn")
E4M3_MAX = 448.0


def full_f32() -> None:
    """Full float32 products on CUDA (TF32 off), as a float32 reference
    needs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale (its
    absolute maximum maps to 448) and brought back to float32: what an
    fp8 product's operand holds."""
    amax = x.abs().amax().clamp(min=1e-12)
    scale = E4M3_MAX / amax
    q = (x.float() * scale).to(torch.float8_e4m3fn)
    return q.float() / scale


class Precision:
    """How a reference multiplies: ``"f32"`` (the reference), ``"fp8"``
    (the control: every product's two operands rounded to e4m3 first) or
    ``"bf16"`` (a witness of the configuration's own precision: the
    operands rounded to bfloat16, the products accumulated in float32)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8", "bf16"):
            raise ValueError(f"precision {name!r}: f32, fp8 or bf16")
        self.name = name

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            return fp8(x)
        if self.name == "bf16":
            return x.to(torch.bfloat16).float()
        return x

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.cast(a) @ self.cast(w)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float
           ) -> torch.Tensor:
    """x (..., S, H, D), positions (S,): the two halves of the last axis
    rotated by ``positions * theta ** (-2i / D)``."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=x.device) / d)
    ang = (positions.to(torch.float64)[:, None] * inv).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, prec: Precision) -> torch.Tensor:
    """q (S, H, Dk), k (S, H, Dk), v (S, H, Dv) of one sequence; every
    query attends to itself and the keys before it. One head group at a
    time, so the (S, S) scores of a few heads exist at once."""
    s, h, _ = q.shape
    out = torch.empty((s, h, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    q, k, v = prec.cast(q), prec.cast(k), prec.cast(v)
    step = max(1, (1 << 27) // max(1, s * s))
    for h0 in range(0, h, step):
        qh = q[:, h0:h0 + step].transpose(0, 1)
        kh = k[:, h0:h0 + step].transpose(0, 1)
        vh = v[:, h0:h0 + step].transpose(0, 1)
        scores = (qh @ kh.transpose(1, 2)) * scale
        scores = scores.masked_fill(~mask, float("-inf"))
        out[:, h0:h0 + step] = (torch.softmax(scores, -1) @ vh
                                ).transpose(0, 1)
    return out


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
           down: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(x, gate)) * prec.mm(x, up), down)
