"""Architecture registry of the port: ``--arch <id>`` resolves here.

The plain dense GQA family is ported; the other architectures of
``repro.configs`` raise ``KeyError`` until their layers are ported
(ROADMAP.md, queue 1 item 7).
"""

from repro_torch.configs import (
    deepseek_coder_33b,
    granite_8b,
    minitron_8b,
    mistral_large_123b,
)

_MODULES = {
    "mistral-large-123b": mistral_large_123b,
    "minitron-8b": minitron_8b,
    "granite-8b": granite_8b,
    "deepseek-coder-33b": deepseek_coder_33b,
}

#: archs of the JAX package that the port does not assemble yet
NOT_PORTED = ("deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b", "mamba2-1.3b",
              "hubert-xlarge", "internvl2-2b", "jamba-1.5-large-398b")


def list_archs() -> list[str]:
    return list(_MODULES)


def _module(arch: str):
    if arch in NOT_PORTED:
        raise KeyError(f"arch {arch!r} is not ported to PyTorch yet "
                       f"(ROADMAP.md, queue 1 item 7); ported: {list_archs()}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list_archs()}")
    return _MODULES[arch]


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()
