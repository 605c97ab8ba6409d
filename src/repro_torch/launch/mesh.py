"""Production and serving meshes, and the CPU ranks that stand for devices.

Twin of ``repro/launch/mesh.py``. The reference is one process that sees
N devices; PyTorch runs one process (rank) per device in a
``torch.distributed`` group, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over those ranks. So a mesh
needs as many ranks as it has devices:

* A 1-device mesh needs no launcher: where no group exists,
  :func:`make_serve_mesh` creates a world-1 group itself (NCCL and gloo
  on ``cuda``, gloo on ``cpu``, over an in-memory store) and
  :func:`release_world` destroys it.
* An N-device mesh needs N ranks, e.g. ``torchrun --nproc-per-node N``
  (the group is then made from its environment), or, for CPU meshes,
  :func:`run_ranks`, which spawns N gloo ranks that rendezvous through a
  file store under a temporary directory. Groups that it spawns on one
  host take turns (a lock file in the temporary directory), so that two
  groups never share the host's cores.

As in the reference, a mesh of fewer devices than the world takes the
first ranks; the others take part in building it (a collective) and see
``get_coordinate()`` return None.
"""

from __future__ import annotations

import contextlib
import fcntl
import math
import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta

import torch

#: every rendezvous and collective of a group made here gives up after this
GROUP_TIMEOUT_S = 60
#: :func:`run_ranks`'s default wall limit for the whole group
RANKS_TIMEOUT_S = 180.0

#: the world-1 group :func:`ensure_world` created, while it stands (empty
#: where the group came from elsewhere, or there is none)
_OWN_WORLD: list = []


def _dist():
    import torch.distributed as dist
    if not dist.is_available():
        raise RuntimeError("this torch build has no torch.distributed")
    return dist


def world_size(device_type: str = "cuda") -> int:
    """Ranks in the default group: its size where one exists, else the
    ``torchrun`` environment's (initializing the group from it), else 1."""
    dist = _dist()
    if dist.is_initialized():
        return dist.get_world_size()
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(_backend(device_type), init_method="env://",
                                timeout=timedelta(seconds=GROUP_TIMEOUT_S))
        return dist.get_world_size()
    return 1


def _backend(device_type: str) -> str:
    return "cpu:gloo,cuda:nccl" if device_type == "cuda" else "gloo"


def ensure_world(device_type: str = "cuda") -> None:
    """A default group to build meshes on: a world-1 group of this process
    (over an in-memory store) where there is none."""
    dist = _dist()
    if world_size(device_type) == 1 and not dist.is_initialized():
        if device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh asked for, but torch sees no "
                               "CUDA card; pass device_type='cpu'")
        dist.init_process_group(_backend(device_type), store=dist.HashStore(),
                                rank=0, world_size=1,
                                timeout=timedelta(seconds=GROUP_TIMEOUT_S))
        _OWN_WORLD.append(dist.group.WORLD)


def release_world() -> None:
    """Destroy the world-1 group :func:`ensure_world` created, if it still
    stands (meshes built on it are then dead)."""
    dist = _dist()
    if _OWN_WORLD and dist.is_initialized() \
            and dist.group.WORLD is _OWN_WORLD[-1]:
        dist.destroy_process_group()
    _OWN_WORLD.clear()


def _mesh(device_type: str, shape: tuple[int, ...], axes: tuple[str, ...],
          what: str):
    from torch.distributed.device_mesh import DeviceMesh
    need = math.prod(shape)
    have = world_size(device_type)
    if have < need:
        raise RuntimeError(
            f"{what} {shape} needs {need} devices, have {have} — launch "
            f"{need} ranks, one process per device (torchrun "
            f"--nproc-per-node {need}, or launch.mesh.run_ranks for a CPU "
            "mesh)")
    ensure_world(device_type)
    return DeviceMesh(device_type, torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         shape: tuple[int, ...] | None = None,
                         axes: tuple[str, ...] | None = None,
                         device_type: str = "cuda", fake: bool = False):
    """The training mesh: ``("data", "model")``, or ``("pod", "data",
    "model")`` for three dimensions; one pod is 16 x 16 (two with
    ``multi_pod``) unless ``shape`` says otherwise.

    ``fake=True`` is the dry-run's mesh: a ``cpu`` mesh over the fake
    ranks of ``parallel.dtensor_tools.fake_world``, which must stand,
    traced as rank 0 (the reference's forced host devices). No serving
    or training entry point asks for it: a real mesh needs real ranks."""
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    if axes is None:
        axes = (("pod", "data", "model") if len(shape) == 3
                else ("data", "model"))
    if fake:
        dist = _dist()
        if not dist.is_initialized() or dist.get_backend() != "fake":
            raise RuntimeError("a fake mesh is built inside "
                               "parallel.dtensor_tools.fake_world(n)")
        device_type = "cpu"
    return _mesh(device_type, tuple(shape), tuple(axes), "mesh")


def make_serve_mesh(shape: "int | tuple[int, ...] | None" = None, *,
                    axes: tuple[str, ...] | None = None,
                    device_type: str = "cuda"):
    """Serving-shaped mesh over the ranks there are, no 256-device floor.

    ``N`` (or ``(N,)``) is N devices on ``("model",)``; ``(D, M)`` is
    ``("data", "model")``; ``shape=None`` takes every rank on
    ``"model"``. Raises ``ValueError`` for a bad shape and
    ``RuntimeError``, naming how many ranks to launch, when the world is
    short."""
    if shape is None:
        shape = (world_size(device_type),)
    elif isinstance(shape, int):
        shape = (shape,)
    else:
        shape = tuple(shape)
    if not shape or any(s < 1 for s in shape):
        raise ValueError(f"bad serve-mesh shape {shape}")
    if axes is None:
        if len(shape) > 2:
            raise ValueError(
                f"serve meshes are 1-D or 2-D, got shape {shape}; pass "
                "axes= explicitly for exotic topologies")
        axes = ("model",) if len(shape) == 1 else ("data", "model")
    return _mesh(device_type, shape, tuple(axes), "serve mesh")


# -- CPU ranks ------------------------------------------------------------------


def _rank_main(fn, rank: int, world: int, init: str, results, args) -> None:
    dist = _dist()
    torch.set_num_threads(1)           # the ranks share the host's cores
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=GROUP_TIMEOUT_S))
        results.put((rank, True, fn(*args)))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@contextlib.contextmanager
def _host_turn(timeout: float):
    """Hold the host's lock on spawned rank groups, waiting at most
    ``timeout`` seconds for it (``RuntimeError`` past that)."""
    deadline = time.monotonic() + timeout
    path = os.path.join(tempfile.gettempdir(), "repro_torch_ranks.lock")
    with open(path, "a") as f:
        while True:
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"another group of ranks held {path} for more "
                        f"than {timeout:.0f} s") from None
                time.sleep(0.2)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def run_ranks(fn, world: int, *args, timeout: float = RANKS_TIMEOUT_S
              ) -> list:
    """``fn(*args)`` on ``world`` spawned CPU ranks of one gloo group;
    returns each rank's result, by rank.

    ``fn`` must be importable by name (a module-level function) and its
    results picklable. The ranks meet through a file store in a temporary
    directory. The group first waits its turn on the host, at most
    ``timeout`` seconds, then gets ``timeout`` seconds to run; a rank
    that raises, or the group running out of time, kills every rank left
    and raises ``RuntimeError`` with the first traceback."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    with _host_turn(timeout), tempfile.TemporaryDirectory(
            prefix="repro_torch_ranks_") as d:
        deadline = time.monotonic() + timeout
        init = "file://" + os.path.join(d, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, init, results, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        got: dict[int, object] = {}
        failure = None
        try:
            while len(got) < world and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failure = (f"{world - len(got)} of {world} ranks did not "
                               f"finish within {timeout:.0f} s")
                    break
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode}")
                    continue
                if ok:
                    got[rank] = out
                else:
                    failure = f"rank {rank} raised:\n{out}"
            for p in procs:
                p.join(timeout=max(0.0, deadline - time.monotonic())
                       if failure is None else 0.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
            results.close()
        if failure is not None:
            raise RuntimeError(f"run_ranks({fn.__name__}, {world}): "
                               f"{failure}")
        return [got[r] for r in range(world)]
