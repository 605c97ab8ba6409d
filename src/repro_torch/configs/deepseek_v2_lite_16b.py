"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408 vocab=102400,
MoE 64e top-6, MLA kv_lora=512, 2 shared experts [arXiv:2405.04434; hf]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    d_ff=1408,
    vocab_size=102400,
    num_heads=16,
    num_kv_heads=16,
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    head_dim=128,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    d_ff_expert=1408,
    rope_theta=1e4,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, d_ff=96, vocab_size=256,
        num_heads=4, num_kv_heads=4, kv_lora_rank=32, qk_nope_dim=16,
        qk_rope_dim=8, v_head_dim=16, head_dim=16, num_experts=8, top_k=2,
        num_shared_experts=1, d_ff_expert=48, dtype="float32",
        param_dtype="float32")
