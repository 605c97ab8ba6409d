"""The weights of a run, made on the device from ``--seed``.

One generator per group of weights (the embedding, each layer, the final
norm and head), seeded from the run's seed and the group's index, fills
one float32 buffer for the whole group in one call; each matrix is its
slice times ``fan_in ** -0.5``, cast to the configuration's dtype. Norm
scales are ``1 + 0.1 * N(0, 1)``; the router stays float32, as the
program computes routing in float32. A group can be made again alone,
which is how the training check finds the weights a step started from.
The names are the ones the program's ``from_named`` takes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import model as ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of a run's seed."""
    ss = np.random.SeedSequence([seed % (1 << 64), *stream])
    return int(ss.generate_state(1, np.uint64)[0] & ((1 << 63) - 1))


def make_group(specs: list[tuple], seed: int, index: int, dtype,
               device) -> dict[str, torch.Tensor]:
    total = sum(math.prod(shape) for _, shape, _ in specs)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 1, index))
    flat = torch.randn(total, generator=gen, dtype=torch.float32,
                       device=device)
    out, at = {}, 0
    for name, shape, fan in specs:
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        if fan is None:
            out[name] = (1 + 0.1 * x).to(dtype)
        elif fan == "router":
            out[name] = (x * shape[0] ** -0.5).clone()
        else:
            out[name] = (x * fan ** -0.5).to(dtype)
    return out


def make(cfg: dict, seed: int, device, groups: set[str] | None = None
         ) -> dict[str, torch.Tensor]:
    """Every weight of configuration ``cfg`` by name (or those of
    ``groups`` alone), in the configuration's dtype."""
    dtype = DTYPES[cfg["dtype"]]
    out = {}
    for index, (group, specs) in enumerate(ref.specs(cfg)):
        if groups is None or group in groups:
            out.update(make_group(specs, seed, index, dtype, device))
    return out

