"""mamba2-1.3b [ssm] — 48L d_model=2048 (attn-free) vocab=50280,
ssm_state=128, SSD (state-space duality) [arXiv:2405.21060]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_groups=1,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, vocab_size=256, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=16, dtype="float32",
        param_dtype="float32")
