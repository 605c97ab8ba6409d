"""internvl2-2b [vlm] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 — InternLM2 backbone; the InternViT frontend is a STUB
(input_specs supplies precomputed 1024-dim patch embeddings, 256 patches
prepended to the text sequence) [arXiv:2404.16821; hf]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    d_ff=8192,
    vocab_size=92553,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    frontend="vision",
    frontend_dim=1024,
    num_patches=256,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, d_ff=128, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, frontend_dim=48,
        num_patches=8, dtype="float32", param_dtype="float32")
