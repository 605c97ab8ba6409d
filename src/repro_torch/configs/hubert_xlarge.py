"""hubert-xlarge [audio] — 48L d_model=1280 16H d_ff=5120 vocab=504 —
encoder-only; the conv feature extractor is a STUB (input_specs supplies
precomputed 512-dim frame embeddings) per the assignment
[arXiv:2106.07447]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    d_ff=5120,
    vocab_size=504,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    is_encoder=True,
    causal=False,
    frontend="audio",
    frontend_dim=512,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, d_ff=128, vocab_size=64,
        num_heads=4, num_kv_heads=4, head_dim=16, frontend_dim=32,
        dtype="float32", param_dtype="float32")
