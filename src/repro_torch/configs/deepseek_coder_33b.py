"""deepseek-coder-33b [dense] — 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256 — llama-arch [arXiv:2401.14196; hf]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    d_ff=19200,
    vocab_size=32256,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=56, d_ff=128, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=14, dtype="float32",
        param_dtype="float32")
