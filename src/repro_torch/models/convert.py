"""Carry the JAX package's parameters into the port.

The weight layout is JAX's own: every matrix stays ``(in, out)`` and the
port multiplies ``x @ W``, so nothing is transposed. The JAX pytree
stacks layer ``i``'s parameters at index ``i`` of ``units/b0/<name>``;
here they become ``blocks[i][<name>]``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import TransformerLM


def _tensor(a) -> torch.Tensor:
    """A CPU tensor that owns a copy of ``a``. numpy arrays of JAX's
    bfloat16 (an ``ml_dtypes`` type, which ``torch.from_numpy`` refuses)
    go through their raw 16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree_np: dict, cfg: ModelConfig) -> TransformerLM:
    """``tree_np``: the JAX ``init_params`` pytree with every leaf already
    a numpy array (``jax.tree.map(np.asarray, params)``). Returns the
    port's module on the CPU; move it with ``.to(device)``."""
    units = tree_np["units"]
    if set(units) != {"b0"}:
        raise ValueError(f"dense stacks have one block per unit, not "
                         f"{sorted(units)}")
    stacked = units["b0"]
    blocks = [{name: _tensor(arr[i]) for name, arr in stacked.items()}
              for i in range(cfg.num_layers)]
    return TransformerLM(cfg, embed=_tensor(tree_np["embed"]),
                         final_norm=_tensor(tree_np["final_norm"]),
                         head=_tensor(tree_np["head"]), blocks=blocks)
