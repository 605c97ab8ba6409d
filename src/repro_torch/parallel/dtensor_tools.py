"""The private and experimental ``torch.distributed`` pieces the port uses,
imported here and nowhere else.

``torch.testing._internal.distributed.fake_pg`` (a process group of any
size in one process, whose collectives move nothing),
``torch.distributed.tensor.experimental.implicit_replication`` and the
flop formulas of ``torch.utils.flop_counter`` live in modules that may
move between torch releases. :func:`require` imports every one and
raises ``RuntimeError`` naming those that are missing, so a caller that
needs them (the dry-run, the card's tooling phase) fails loudly before
it starts.
"""

from __future__ import annotations

import contextlib
import importlib
from datetime import timedelta

#: (module, attribute) of every private or experimental piece used
PIECES = (
    ("torch.testing._internal.distributed.fake_pg", "FakeStore"),
    ("torch.distributed.tensor.experimental", "implicit_replication"),
    ("torch.utils.flop_counter", "flop_registry"),
)

#: the fake group's rendezvous and collectives give up after this
FAKE_TIMEOUT_S = 60


def _get(module: str, attr: str):
    return getattr(importlib.import_module(module), attr)


def require() -> dict[str, object]:
    """Every piece of :data:`PIECES` by attribute name; ``RuntimeError``
    naming each one this torch lacks."""
    got, missing = {}, []
    for module, attr in PIECES:
        try:
            got[attr] = _get(module, attr)
        except (ImportError, AttributeError) as e:
            missing.append(f"{module}.{attr} ({type(e).__name__}: {e})")
    if missing:
        import torch
        raise RuntimeError(f"torch {torch.__version__} lacks "
                           + "; ".join(missing))
    return got


_REPLICATING: list[bool] = []


@contextlib.contextmanager
def implicit_replication():
    """Let plain tensors meet ``DTensor``s as replicated ones (torch's
    ``implicit_replication``), nestable: torch's own context turns the
    switch off on any exit, so only the outermost entry here enters it."""
    if _REPLICATING:
        yield
        return
    ctx = _get("torch.distributed.tensor.experimental",
               "implicit_replication")
    _REPLICATING.append(True)
    try:
        with ctx():
            yield
    finally:
        _REPLICATING.pop()


@contextlib.contextmanager
def fake_world(world: int):
    """A default process group of ``world`` fake ranks in this process,
    this process rank 0, destroyed on exit. Collectives on it complete
    without moving data, so a mesh of any size can be traced on one host.
    Refuses to run where a default group already stands: a real group
    must never be replaced by a fake one, nor a fake one left behind."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists; a fake "
                           "world needs a process without one")
    store = _get("torch.testing._internal.distributed.fake_pg", "FakeStore")
    dist.init_process_group("fake", store=store(), rank=0, world_size=world,
                            timeout=timedelta(seconds=FAKE_TIMEOUT_S))
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
