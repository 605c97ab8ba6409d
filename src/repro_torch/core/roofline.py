"""Three-term roofline from one traced step.

Twin of ``repro/core/roofline.py``. For every (architecture × shape ×
mesh) cell the dry-run runs the step once, as one rank of the mesh, and
prices

  compute term    = flops      / (chips × peak_FLOP/s)
  memory term     = bytes      / (chips × HBM_bw)
  collective term = wire_bytes / (chips × ICI_bw)

The reference reads flops and bytes from XLA's ``cost_analysis()`` of
the compiled program and the collectives from its HLO text. The port
compiles nothing through XLA, so :class:`StepCounter` records them while
the step runs: a dispatch mode that sees every aten op the ``DTensor``
layer runs on this rank's local tensors, and

* flops: ``torch.utils.flop_counter``'s formulas (products, attention,
  convolutions) applied to the **local** operands, so one rank's share.
  (``FlopCounterMode`` around ``DTensor`` ops counts the global product.)
  Elementwise work is not counted, as those formulas do not count it;
* bytes: the inputs and outputs of each local op that is not a view.
  This is unfused, so it counts more than XLA's ``bytes accessed``,
  which charges a fused chain once;
* the payload bytes of each ``c10d_functional`` collective, from its
  result's local shape, under the reference's kind names. A backend
  without an all-to-all gathers instead, and that counts as all-gather;
* the peak of live bytes the step allocates beyond its arguments (the
  twin of XLA's ``temp_size_in_bytes``).

The reference's ``shape_bytes`` and ``collective_bytes`` parse HLO text
and have no torch subject; they are left out. ``wire_bytes``,
:class:`RooflineReport` and :func:`dump` are the reference's arithmetic
as it is.
"""

from __future__ import annotations

import dataclasses
import json
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core import profile
from repro_torch.core.devices import TPU_V5E

#: ``c10d_functional`` op name (its prefix) -> the reference's kind name
_FUNCOL_KINDS = (
    ("all_gather", "all-gather"),
    ("all_reduce", "all-reduce"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_to_all", "all-to-all"),
    ("permute", "collective-permute"),
    ("broadcast", "collective-permute"),
)


def wire_bytes(coll: dict[str, int]) -> float:
    """Estimated ICI traffic.  Ring all-reduce ≈ 2× payload
    (reduce-scatter + all-gather phases); everything else ≈ 1×."""
    total = 0.0
    for kind, nbytes in coll.items():
        total += nbytes * (2.0 if kind == "all-reduce" else 1.0)
    return total


@dataclasses.dataclass
class RooflineReport:
    name: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_payload: dict[str, int]
    wire_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float | None = None      # 6·N·D (or 6·N_active·D for MoE)
    # peak of the spec the report was priced against — the fraction below
    # must use the SAME roof as the terms, not a module-level constant
    peak_bf16_flops: float = 0.0
    spec_name: str = ""

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Lower-bound step time: the max term (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful compute / ideal step budget: how close the *useful* work
        runs to the hardware roof if the dominant term is fully utilized."""
        if not self.model_flops:
            return 0.0
        peak = self.peak_bf16_flops or TPU_V5E.peak_bf16_flops
        ideal = self.model_flops / (self.chips * peak)
        return ideal / self.step_s if self.step_s else 0.0

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs — catches remat/redundancy waste."""
        if not self.model_flops or not self.hlo_flops:
            return 0.0
        return self.model_flops / self.hlo_flops

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        d["step_s"] = self.step_s
        d["roofline_fraction"] = self.roofline_fraction
        d["useful_flops_ratio"] = self.useful_flops_ratio
        return d

    def summary(self) -> str:
        mf = (f" useful={self.useful_flops_ratio:.2f}"
              if self.model_flops else "")
        rf = (f" roofline={self.roofline_fraction:.1%}"
              if self.model_flops else "")
        return (f"{self.name}: compute={self.compute_s*1e3:.2f}ms "
                f"memory={self.memory_s*1e3:.2f}ms "
                f"collective={self.collective_s*1e3:.2f}ms "
                f"dominant={self.dominant}{mf}{rf}")


def analyze(name: str, *, cost: dict, collectives: dict[str, int],
            chips: int, spec=None, model_flops: float | None = None,
            per_device_module: bool = True) -> RooflineReport:
    """Build the report from a cost dict (``flops``, ``bytes accessed``)
    and collective payloads by kind, as :class:`StepCounter` records them.

    ``per_device_module=True`` (the SPMD dry-run case): the cost and the
    payloads describe ONE device's program, so they are already per-chip;
    stored ``hlo_flops``/``hlo_bytes`` are normalized to global (×chips).
    ``model_flops`` is always global.
    """
    spec = profile.resolve_spec(spec)
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    if per_device_module:
        flops_per_chip, bytes_per_chip = flops, nbytes
        flops_global, bytes_global = flops * chips, nbytes * chips
    else:
        flops_per_chip, bytes_per_chip = flops / chips, nbytes / chips
        flops_global, bytes_global = flops, nbytes
    coll = dict(collectives)
    wb = wire_bytes(coll)          # per-device wire traffic (ring estimate)
    if not per_device_module:
        wb = wb / chips
    return RooflineReport(
        name=name, chips=chips,
        hlo_flops=flops_global, hlo_bytes=bytes_global,
        coll_payload=coll, wire_bytes=wb,
        compute_s=flops_per_chip / spec.peak_bf16_flops,
        memory_s=bytes_per_chip / spec.hbm_bytes_per_s,
        collective_s=wb / spec.ici_bytes_per_s,
        model_flops=model_flops,
        peak_bf16_flops=spec.peak_bf16_flops,
        spec_name=spec.name,
    )


def dump(reports: list[RooflineReport], path: str) -> None:
    with open(path, "w") as f:
        json.dump([r.to_json() for r in reports], f, indent=2)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------


def collective_kind(func) -> str | None:
    """The reference's kind name of a functional collective op, else None
    (``wait_tensor`` and every other op)."""
    if func.namespace not in ("_c10d_functional", "c10d_functional"):
        return None
    name = func._opname
    for prefix, kind in _FUNCOL_KINDS:
        if name.startswith(prefix):
            return kind
    return None


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _is_view(func) -> bool:
    """The op returns an alias it does not write (a view): it moves no
    bytes and allocates nothing."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class StepCounter(TorchDispatchMode):
    """Flops, bytes, collective payloads and the temp peak of what runs
    under it, counted on this rank's local tensors (see the module
    docstring). ``arguments`` (tensors, ``DTensor``s or containers of
    them) are the step's inputs: their storage is never counted as temp.
    Works on ``meta`` tensors, where nothing is allocated."""

    def __init__(self, arguments=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        for t in _tensors(arguments):
            local = t.to_local() if hasattr(t, "to_local") else t
            self._seen[local.untyped_storage()] = 0
        from repro_torch.parallel.dtensor_tools import require
        self._flop_registry = require()["flop_registry"]

    def cost(self) -> dict:
        """The reference's ``cost_analysis()`` keys."""
        return {"flops": float(self.flops),
                "bytes accessed": float(self.bytes)}

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        # a DTensor op: let DTensor run, and see the local ops and the
        # collectives it turns into (as CommDebugMode does)
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        # DTensor's sharding propagation runs each new op once on fake
        # tensors of the global shapes, to learn its output's metadata:
        # that is no work of this rank
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out
        kind = collective_kind(func)
        if kind is not None:
            self.collectives[kind] = self.collectives.get(kind, 0) + sum(
                t.nbytes for t in _tensors(out))
            self._track(out)
            return out
        if func.namespace == "_c10d_functional" or _is_view(func):
            return out
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += self._flop_registry[packet](*args, **kwargs,
                                                      out_val=out)
        self.bytes += sum(t.nbytes for t in _tensors((args, kwargs)))
        self.bytes += sum(t.nbytes for t in _tensors(out))
        self._track(out)
        return out
