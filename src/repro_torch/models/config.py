"""One config schema for all 10 assigned architectures.

A copy of ``repro/models/config.py``'s ``ModelConfig`` with every field,
so that config files copy over verbatim; only the dtype table maps to
torch. The port assembles every family from it. The JAX package's
accounting methods are copied (the cost model prices with them).
"""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int

    # -- attention (0 heads = attention-free) --
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 1e4
    causal: bool = True

    # -- MLA (deepseek-v2) --
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mla_absorbed: bool = False      # absorbed-matmul decode (§Perf): score
                                    # against c_kv directly, no re-expansion

    # -- MoE --
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0            # per-expert hidden dim
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3

    # -- SSM (mamba2 / SSD) --
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_groups: int = 1             # B/C groups (like GQA for SSM)

    # -- hybrid (jamba) --
    attn_period: int = 0            # one attention layer per `attn_period`
    moe_period: int = 1             # MoE every `moe_period` layers (jamba: 2)

    # -- modality frontends (stubs per assignment) --
    is_encoder: bool = False        # hubert: bidirectional, no decode
    frontend: str | None = None     # "audio" | "vision"
    frontend_dim: int = 0           # precomputed frame/patch embedding dim
    num_patches: int = 0            # vision: patches prepended to text

    # -- numerics / execution --
    dtype: str = "bfloat16"         # activation/compute dtype
    param_dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"   # "int8": quantized KV cache (decode)
    norm_eps: float = 1e-6
    remat: bool = True
    remat_policy: str = "full"      # full | dots (save matmul outputs)
    attention_impl: str = "ref"     # "ref" | "chunked" (q blocks) | "flash" (CUDA)
    attention_chunk: int = 1024     # q-block for the chunked impl
    scan_layers: bool = True
    tie_embeddings: bool = False

    # ------------------------------------------------------------------

    def __post_init__(self):
        if self.num_heads and not self.head_dim and not self.use_mla:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def activation_dtype(self):
        return _DTYPES[self.dtype]

    @property
    def parameter_dtype(self):
        return _DTYPES[self.param_dtype]

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.num_heads == 0

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k: SSM or hybrid (attention is 1/period)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return not self.is_encoder

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def layer_kinds(self) -> list[str]:
        """Per-layer block kind, e.g. jamba's 1:7 attention:mamba pattern."""
        kinds = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                kinds.append("ssm")
            elif self.family == "hybrid":
                # jamba period of 8: attention at position 4 (1:7 ratio)
                kinds.append("attn" if (i % self.attn_period) ==
                             self.attn_period // 2 else "ssm")
            else:
                kinds.append("attn")
        return kinds

    def ffn_kinds(self) -> list[str]:
        kinds = []
        for i in range(self.num_layers):
            if self.is_moe and (i % self.moe_period) == (self.moe_period - 1):
                kinds.append("moe")
            else:
                kinds.append("dense")
        return kinds

    # -- parameter / FLOP accounting (the cost model's) --------------------

    def param_count(self) -> int:
        """Exact parameter count of the assembled model."""
        from repro_torch.models.transformer import count_params  # lazy: cycle
        return count_params(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared experts only)."""
        from repro_torch.models.transformer import count_params
        return count_params(self, active_only=True)

    def model_flops_per_token(self) -> float:
        """6·N_active — the §Roofline MODEL_FLOPS convention."""
        return 6.0 * self.active_param_count()
