"""Carry the JAX package's parameters and caches into the port.

The weight layout is JAX's own: every matrix stays ``(in, out)`` and the
port multiplies ``x @ W``, so nothing is transposed. The JAX pytree
stacks unit ``u``'s block ``i`` at index ``u`` of ``units/b{i}/<name>``;
here it is layer ``u·P + i`` (``P`` the unit period), ``blocks[u·P + i]
[<name>]``. The front end's leaves and the f32 router come across as
they are.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (TransformerLM, _leaf_names,
                                            frontend_param_names, layer_plan,
                                            unit_spec)


def _tensor(a) -> torch.Tensor:
    """A CPU tensor that owns a copy of ``a``. numpy arrays of JAX's
    bfloat16 (an ``ml_dtypes`` type, which ``torch.from_numpy`` refuses)
    go through their raw 16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _layers(cfg: ModelConfig):
    """(layer, unit, block) of every layer."""
    period = len(unit_spec(cfg))
    return [(i, i // period, i % period) for i in range(cfg.num_layers)]


def params_from_jax(tree_np: dict, cfg: ModelConfig) -> TransformerLM:
    """``tree_np``: the JAX ``init_params`` pytree with every leaf already
    a numpy array (``jax.tree.map(np.asarray, params)``). Returns the
    port's module on the CPU; move it with ``.to(device)``."""
    units = tree_np["units"]
    period = len(unit_spec(cfg))
    if set(units) != {f"b{i}" for i in range(period)}:
        raise ValueError(f"{cfg.name} has {period} blocks a unit, not "
                         f"{sorted(units)}")
    blocks = [{name: _tensor(arr[u]) for name, arr in units[f"b{i}"].items()}
              for _, u, i in _layers(cfg)]
    head = None if cfg.tie_embeddings else _tensor(tree_np["head"])
    return TransformerLM(
        cfg, embed=_tensor(tree_np["embed"]),
        final_norm=_tensor(tree_np["final_norm"]), head=head, blocks=blocks,
        frontend={n: _tensor(tree_np[n]) for n in frontend_param_names(cfg)})


def cache_from_jax(tree_np: dict, cfg: ModelConfig) -> dict:
    """The reference's cache (``init_cache``, ``init_paged_cache`` or what
    ``prefill`` returns, leaves as numpy, ``units/b{i}/<name>`` of
    (units, ...)) in the port's layout: each leaf stacked over the layers
    that hold it, in layer order."""
    per_leaf: dict[str, list] = {}
    for (layer, u, i), (kind, _, _) in zip(_layers(cfg), layer_plan(cfg)):
        block = tree_np[f"b{i}"]
        for name in _leaf_names(cfg, kind):
            if name in block:
                per_leaf.setdefault(name, []).append(_tensor(block[name][u]))
    return {name: torch.stack(rows) for name, rows in per_leaf.items()}


def state_from_jax(tree_np, cfg: ModelConfig):
    """The reference's whole ``TrainState`` in the port's: ``tree_np`` is
    it with every leaf a numpy array (``jax.tree.map(np.asarray,
    state)``). Parameters, the AdamW moments ``m``/``v`` and the error
    feedback ``ef_state`` (or None) all cross by :func:`params_from_jax`'s
    ``units/b{i}`` mapping, so they are keyed by the port's parameter
    names and compare leaf for leaf; ``count`` and ``step`` are 0-d int32
    tensors. Returns the state on the CPU, its parameters trainable; move
    it with ``TrainState.to(device)``."""
    from repro_torch.train.loop import TrainState

    def by_name(tree) -> dict:
        return {k: p.detach()
                for k, p in params_from_jax(tree, cfg).named_parameters()}

    opt, ef = tree_np.opt_state, tree_np.ef_state
    return TrainState(
        params=params_from_jax(tree_np.params, cfg).requires_grad_(True),
        opt_state={"m": by_name(opt["m"]), "v": by_name(opt["v"]),
                   "count": _tensor(opt["count"]).to(torch.int32)},
        step=_tensor(tree_np.step).to(torch.int32),
        ef_state=None if ef is None else by_name(ef))
