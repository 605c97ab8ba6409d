"""mistral-large-123b [dense] — 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768 [hf:mistralai/Mistral-Large-Instruct-2407]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    d_ff=28672,
    vocab_size=32768,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=1e6,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, d_ff=128, vocab_size=256,
        num_heads=8, num_kv_heads=2, head_dim=8, dtype="float32",
        param_dtype="float32")
