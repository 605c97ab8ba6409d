"""Checkpointing: one ``.npz`` per step plus a JSON manifest.

Twin of ``repro/train/checkpoint.py``. Leaves are saved by flattened path
(``params//blocks.0.wq``, ``opt_state//m//embed``, ``step``, ...) into
one ``.npz`` per checkpoint step, with a manifest of each leaf's shape
and dtype (bfloat16 leaves travel as their raw 16 bits, which numpy
holds as uint16). Writes are atomic (tmp + rename) and a retention
policy keeps the newest ``keep`` steps. ``restore`` builds a new tree
shaped like its template, on the template's devices and in its dtypes,
and never writes into the template.

Checkpoints are mesh-agnostic: ``save`` of ``DTensor`` leaves writes the
full tensors (every rank joins the gathers, rank 0 writes, and all wait
for the files), and ``restore(shardings=)`` lays each leaf out on its
:class:`~repro_torch.parallel.sharding.NamedSharding`, which is the
elasticity path: a checkpoint written on one mesh restores onto whatever
mesh is alive.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch
from torch import nn

from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as sh
from repro_torch.train.loop import TrainState

_SEP = "//"
_FIELDS = ("params", "opt_state", "step", "ef_state")


def leaves(tree, prefix: str = ""):
    """(path, tensor) of every leaf of a state, module or nested dict, in
    a fixed order; None is no leaf."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    if isinstance(tree, TrainState):
        children = ((f, getattr(tree, f)) for f in _FIELDS)
    elif isinstance(tree, nn.Module):
        children = tree.named_parameters()
    elif isinstance(tree, dict):
        children = tree.items()
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__}")
    for key, child in children:
        yield from leaves(child, f"{prefix}{_SEP}{key}" if prefix else key)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = sh.full_tensor(t.detach()).cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(tree) -> tuple[dict[str, np.ndarray], dict[str, str], bool]:
    """The leaves as numpy by path, their dtypes, and whether any was a
    ``DTensor`` (gathered whole: a collective of its mesh)."""
    flat, dtypes, meshed = {}, {}, False
    for key, t in leaves(tree):
        meshed |= sh.is_dtensor(t)
        flat[key] = _to_numpy(t)
        dtypes[key] = str(t.dtype).removeprefix("torch.")
    return flat, dtypes, meshed


def _sub(shardings, k):
    """The part of a shardings mirror that belongs to child ``k``."""
    if shardings is None:
        return None
    if isinstance(shardings, TrainState):
        return getattr(shardings, k)
    return shardings.get(k)


def _rebuild(template, flat: dict[str, np.ndarray], prefix: str = "",
             shardings=None):
    """A new tree shaped like ``template``, each leaf from ``flat`` on the
    template leaf's device and in its dtype, or laid out by its entry in
    ``shardings`` (a mirror of the template: a ``NamedSharding`` or None
    per leaf, keyed as the template is)."""
    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        arr = flat[prefix]
        if arr.dtype == np.uint16 and template.dtype == torch.bfloat16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        t = t.to(dtype=template.dtype)
        if shardings is not None:
            return sh.distribute(t, shardings)
        return t.to(device=template.device)
    key = lambda k: f"{prefix}{_SEP}{k}" if prefix else k
    if isinstance(template, TrainState):
        return TrainState(*(_rebuild(getattr(template, f), flat, key(f),
                                     _sub(shardings, f))
                            for f in _FIELDS))
    if isinstance(template, T.TransformerLM):
        named = {k: _rebuild(p.detach(), flat, key(k), _sub(shardings, k))
                 for k, p in template.named_parameters()}
        trainable = any(p.requires_grad for p in template.parameters())
        return T.from_named(template.cfg, named).requires_grad_(trainable)
    if isinstance(template, dict):
        return {k: _rebuild(v, flat, key(k), _sub(shardings, k))
                for k, v in template.items()}
    raise TypeError(f"cannot restore into a {type(template).__name__}")


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Write ``tree`` as step ``step``; returns the ``.npz`` path. With
    ``DTensor`` leaves every rank calls it: the leaves are gathered whole,
    rank 0 writes, and every rank returns once the files are there."""
    flat, dtypes, meshed = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step-{step:08d}.npz")
    if meshed:
        import torch.distributed as dist
        if dist.get_rank() == 0:
            _write(ckpt_dir, step, flat, dtypes, keep)
        dist.barrier()
        return final
    _write(ckpt_dir, step, flat, dtypes, keep)
    return final


def _write(ckpt_dir: str, step: int, flat: dict, dtypes: dict,
           keep: int) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}.npz")
    final = os.path.join(ckpt_dir, f"step-{step:08d}.npz")
    np.savez(tmp, **flat)
    os.replace(tmp, final)
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                   for k, v in flat.items()},
    }
    mtmp = os.path.join(ckpt_dir, f".tmp-{step}.json")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(ckpt_dir, f"step-{step:08d}.json"))
    _retain(ckpt_dir, keep)


def _retain(ckpt_dir: str, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep else []:
        for ext in (".npz", ".json"):
            p = os.path.join(ckpt_dir, f"step-{s:08d}{ext}")
            if os.path.exists(p):
                os.remove(p)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step-(\d+)\.npz", name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, template, *, step: int | None = None,
            shardings=None):
    """Load a checkpoint into a new tree of the template's structure,
    resharded onto ``shardings`` if given: a mirror of the template
    (a dict by parameter name for a model, as ``param_shardings`` of
    ``param_logical_axes`` gives, a ``TrainState`` or dict by field for
    a state) holding a ``NamedSharding`` or None for each leaf. Leaves
    with a sharding come back as ``DTensor``s on its mesh, each rank
    holding its part; every rank of that mesh calls ``restore``.
    Returns (tree, step)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    with np.load(os.path.join(ckpt_dir, f"step-{step:08d}.npz")) as z:
        flat = {k: z[k] for k in z.files}
    return _rebuild(template, flat, shardings=shardings), step
