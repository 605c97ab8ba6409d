"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16e top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    d_ff=6400,
    vocab_size=32064,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    num_experts=16,
    top_k=2,
    d_ff_expert=6400,
    rope_theta=1e4,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, d_ff=128, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, num_experts=4, top_k=2,
        d_ff_expert=64, dtype="float32", param_dtype="float32")
