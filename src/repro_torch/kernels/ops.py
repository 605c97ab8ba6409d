"""Public entry points for the port's kernels.

Twin of ``repro/kernels/ops.py`` for the kernels ported so far. There is
no ``interpret`` switch: each wrapper runs its plain PyTorch version on
CPU tensors and its CUDA kernel on CUDA tensors. Model code calls
:func:`attention`, which picks the flash kernel or the materialized
reference per config (``attention_impl``).
"""

from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref


def flash_attention(q, k, v, *, num_q_heads: int, num_kv_heads: int,
                    causal: bool = True, scale: float | None = None,
                    block_q: int = 256, block_k: int = 256):
    return _fa.flash_attention(
        q, k, v, num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
        causal=causal, scale=scale, block_q=block_q, block_k=block_k)


def attention(q, k, v, *, num_q_heads: int, num_kv_heads: int,
              causal: bool = True, scale: float | None = None,
              impl: str = "ref", **kw):
    """Dispatch: 'flash' (the hand-written kernel) or 'ref' (plain)."""
    if impl == "flash":
        return flash_attention(q, k, v, num_q_heads=num_q_heads,
                               num_kv_heads=num_kv_heads, causal=causal,
                               scale=scale, **kw)
    return ref.attention_ref(q, k, v, num_q_heads=num_q_heads,
                             num_kv_heads=num_kv_heads, causal=causal,
                             scale=scale)
