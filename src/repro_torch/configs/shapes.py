"""The four assigned input shapes, per-cell applicability and input specs.

Twin of ``repro/configs/shapes.py``. Shapes:
  train_4k     seq 4,096   global_batch 256   (training      -> train_step)
  prefill_32k  seq 32,768  global_batch 32    (inference     -> prefill_step)
  decode_32k   seq 32,768  global_batch 128   (decode        -> serve_step)
  long_500k    seq 524,288 global_batch 1     (long decode   -> serve_step)

long_500k needs sub-quadratic mixing (SSM/hybrid only); encoder-only
architectures have no decode step. ``input_specs`` returns tensors on
torch's ``meta`` device, the reference's shapes and dtypes with no
storage, where the reference returns ``jax.ShapeDtypeStruct``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.kind == "decode" and cfg.is_encoder:
        return False, "encoder-only architecture has no decode step"
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, ("full quadratic attention at 512K context; "
                       "long_500k requires sub-quadratic mixing (SSM/hybrid)")
    return True, ""


def supported_cells(cfg: ModelConfig) -> list[ShapeSpec]:
    return [s for s in SHAPES.values() if cell_supported(cfg, s)[0]]


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                scale: int = 1) -> dict[str, torch.Tensor]:
    """Step-function inputs for the cell, as ``meta`` tensors (divide
    batch/seq by ``scale`` for reduced smoke runs)."""
    b = max(1, shape.global_batch // scale)
    s = max(128, shape.seq_len // scale) if scale > 1 else shape.seq_len
    i32 = torch.int32
    f = cfg.activation_dtype

    if shape.kind in ("train", "prefill"):
        specs: dict[str, torch.Tensor] = {}
        if cfg.frontend == "vision":
            patches = min(cfg.num_patches, s // 2)
            specs["patches"] = _spec((b, patches, cfg.frontend_dim), f)
            specs["tokens"] = _spec((b, s - patches), i32)
        elif cfg.frontend == "audio":
            specs["frames"] = _spec((b, s, cfg.frontend_dim), f)
        else:
            specs["tokens"] = _spec((b, s), i32)
        if shape.kind == "train":
            specs["labels"] = _spec((b, s), i32)
        return specs

    # decode: one new token against an S-slot cache (the caller sizes the
    # cache; it is a step argument)
    return {"tokens": _spec((b, 1), i32), "cache_index": _spec((), i32)}
