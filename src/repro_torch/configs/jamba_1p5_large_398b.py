"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 — Mamba+attention 1:7 interleave
(one attention layer per 8), MoE every 2nd layer [arXiv:2403.19887; hf].

Note (DESIGN.md §7): Jamba's Mamba-1 block is realized with the SSD
(mamba2) block at the same state size/expansion — the duality-equivalent
formulation this framework implements.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    d_ff=24576,
    vocab_size=65536,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    num_experts=16,
    top_k=2,
    d_ff_expert=24576,
    attn_period=8,
    moe_period=2,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_groups=1,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=8, d_model=64, d_ff=128, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, num_experts=4, top_k=2,
        d_ff_expert=64, ssm_state=8, ssm_head_dim=16, ssm_chunk=16,
        dtype="float32", param_dtype="float32")
