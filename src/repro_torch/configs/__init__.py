"""Architecture registry of the port: ``--arch <id>`` resolves here.

All ten architectures of ``repro.configs``, in its order; each module's
``CONFIG`` is a field-for-field copy of the reference's.
"""

from repro_torch.configs import (
    deepseek_coder_33b,
    deepseek_v2_lite_16b,
    granite_8b,
    hubert_xlarge,
    internvl2_2b,
    jamba_1p5_large_398b,
    mamba2_1p3b,
    minitron_8b,
    mistral_large_123b,
    phi35_moe_42b,
)
from repro_torch.configs.shapes import (  # noqa: F401
    SHAPES, ShapeSpec, cell_supported, input_specs, supported_cells,
)

_MODULES = {
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b,
    "mamba2-1.3b": mamba2_1p3b,
    "mistral-large-123b": mistral_large_123b,
    "minitron-8b": minitron_8b,
    "granite-8b": granite_8b,
    "deepseek-coder-33b": deepseek_coder_33b,
    "hubert-xlarge": hubert_xlarge,
    "internvl2-2b": internvl2_2b,
    "jamba-1.5-large-398b": jamba_1p5_large_398b,
}


def list_archs() -> list[str]:
    return list(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list_archs()}")
    return _MODULES[arch]


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()
