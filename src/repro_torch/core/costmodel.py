"""Analytic per-cell cost model: FLOPs, HBM traffic, ICI traffic.

A copy of ``repro/core/costmodel.py`` for the port: numpy and the
standard library only, nothing of ``repro``.

Why analytic: XLA's ``cost_analysis()`` counts ``while`` bodies ONCE, so any
scanned program (layers-scan, chunked attention, grad accumulation)
under-reports by the trip count (verified empirically — see
tests/test_costmodel.py, which also validates this model against XLA on
scan-free unrolled configs).  The dry-run keeps the compiled artifact for
memory/sharding/collective-schedule evidence; the roofline *terms* come
from here.  This module is also the napkin-math engine for §Perf: every
hillclimb hypothesis is priced against it first.

Conventions: dot = 2mnk FLOPs; causal attention halves score/PV work;
MoE compute follows the capacity actually dispatched (T·k·cf tokens).
Traffic models are first-order (params + major activations + caches;
ring-collective wire bytes).
"""

from __future__ import annotations

import dataclasses
import itertools

from repro_torch.core import profile
from repro_torch.core.devices import TpuSpec
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class ParallelismPlan:
    dp: int          # data-parallel ways (pod × data)
    tp: int          # tensor/expert-parallel ways (model)
    fsdp: bool = True
    remat: bool = True
    # serving weight strategy: "gather" re-gathers FSDP-sharded weights each
    # step; "resident" keeps them 2D-TP-sharded (activation collectives only)
    serving_weights: str = "gather"
    kv_cache_bytes: int = 2          # 2 = bf16, 1 = int8-quantized cache

    @property
    def chips(self) -> int:
        return self.dp * self.tp


#: unique spec-mix dedup tags for CellCosts constructed without a name
_ANON_CELLS = itertools.count()


@dataclasses.dataclass
class CellCost:
    name: str
    global_flops: float            # true executed FLOPs (whole step)
    model_flops: float             # 6·N_active·tokens (2· for fwd-only)
    flops_per_chip: float
    hbm_bytes_per_chip: float
    ici_bytes_per_chip: float
    breakdown: dict

    def _resolve(self, spec) -> TpuSpec:
        """One resolution path for every pricing method (the former
        per-method ``spec=TPU_V5E`` defaults silently let one cell be
        priced against two different specs).  The first resolved spec is
        pinned to this cell; pricing it against a different one later
        warns once (``profile.SpecMixWarning``).  Compared by full value
        — every field, name included — not by name alone: a dissected
        ``tpu_v5e`` profile shares the built-in constant's name while
        disagreeing with its numbers, exactly the mix that must not pass
        silently."""
        spec = profile.resolve_spec(spec)
        prior = getattr(self, "_spec_used", None)
        if prior is None:
            self._spec_used = spec
        elif prior != spec:
            # dedup key: the cell's name, or a per-INSTANCE tag for
            # unnamed cells — a shared "cell" fallback would let the
            # first unnamed cell's warning silence every later one's
            key = getattr(self, "_warn_key", None)
            if key is None:
                key = self._warn_key = (self.name
                                        or f"cell#{next(_ANON_CELLS)}")
            profile.warn_spec_mix(key, prior, spec)
        return spec

    def terms(self, spec=None) -> dict:
        spec = self._resolve(spec)
        return {
            "compute_s": self.flops_per_chip / spec.peak_bf16_flops,
            "memory_s": self.hbm_bytes_per_chip / spec.hbm_bytes_per_s,
            "collective_s": self.ici_bytes_per_chip / spec.ici_bytes_per_s,
        }

    def dominant(self, spec=None) -> str:
        t = self.terms(spec)
        return max(t, key=t.get)[: -len("_s")]

    def step_s(self, spec=None) -> float:
        return max(self.terms(spec).values())

    def roofline_fraction(self, spec=None) -> float:
        """Useful-FLOPs time at peak / bound step time (MFU upper bound)."""
        spec = self._resolve(spec)
        chips = self.global_flops / max(self.flops_per_chip, 1e-30)
        ideal = self.model_flops / (chips * spec.peak_bf16_flops)
        return ideal / self.step_s(spec)

    def useful_ratio(self) -> float:
        return self.model_flops / max(self.global_flops, 1e-30)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(self.terms())
        d["dominant"] = self.dominant()
        d["step_s"] = self.step_s()
        d["roofline_fraction"] = self.roofline_fraction()
        d["useful_ratio"] = self.useful_ratio()
        return d


# ---------------------------------------------------------------------------
# per-layer forward FLOPs per token
# ---------------------------------------------------------------------------


def _attn_proj_flops(cfg: ModelConfig) -> float:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return 2 * d * (hq * hd + 2 * hkv * hd) + 2 * hq * hd * d


def _mla_proj_flops(cfg: ModelConfig, kv_len: float) -> float:
    """Per-token projection + per-token cache-expansion FLOPs.

    The naive MLA decode re-expands the whole compressed cache each step:
    expansion costs 2·r·h·(nd+vd) per *cache entry* per step — kv_len=1 for
    train/prefill (amortized), kv_len=T for decode.  (The absorbed-matmul
    variant removes the T factor — a §Perf optimization.)
    """
    d, h = cfg.d_model, cfg.num_heads
    nd, rd, vd, r = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    proj = (2 * d * h * (nd + rd) + 2 * d * (r + rd) + 2 * h * vd * d)
    if cfg.mla_absorbed and kv_len > 1:
        # absorbed decode: per-token q/out absorption, no cache expansion
        absorb = 2 * h * (nd * r + r * vd)
        return proj + absorb
    expand = 2 * r * h * (nd + vd) * kv_len
    return proj + expand


def _attn_score_flops(cfg: ModelConfig, kv_len: float,
                      causal_factor: float) -> float:
    hq = cfg.num_heads
    if cfg.use_mla:
        if cfg.mla_absorbed and causal_factor == 1.0:
            # decode against the compressed cache: r+rd score dims, r ctx
            qk = cfg.kv_lora_rank + cfg.qk_rope_dim
            vd = cfg.kv_lora_rank
        else:
            qk = cfg.qk_nope_dim + cfg.qk_rope_dim
            vd = cfg.v_head_dim
    else:
        qk = vd = cfg.head_dim
    return 2 * hq * (qk + vd) * kv_len * causal_factor


def _ffn_flops(cfg: ModelConfig, kind: str) -> float:
    d = cfg.d_model
    if kind == "dense":
        return 2 * 3 * d * cfg.d_ff
    routed = 2 * 3 * d * cfg.d_ff_expert * cfg.top_k * cfg.capacity_factor
    shared = 2 * 3 * d * cfg.num_shared_experts * cfg.d_ff_expert
    router = 2 * d * cfg.num_experts
    return routed + shared + router


def _ssm_flops(cfg: ModelConfig, decode: bool) -> float:
    d, di = cfg.d_model, cfg.d_inner
    h, p, g, n = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
                  cfg.ssm_state)
    conv_dim = di + 2 * g * n
    proj = 2 * d * (2 * di + 2 * g * n + h) + 2 * di * d
    conv = 2 * cfg.ssm_conv * conv_dim
    if decode:
        ssd = 2 * h * n * p * 2                      # state update + readout
    else:
        L = cfg.ssm_chunk
        # intra-chunk: C·Bᵀ scores (L·n per token) + apply (L·p); causal ½
        intra = (2 * h * n * L + 2 * h * p * L) * 0.5
        # inter-chunk state: B xᵀ outer products + C·h readout
        inter = 2 * h * n * p * 2
        ssd = intra + inter
    return proj + conv + ssd


def forward_flops_per_token(cfg: ModelConfig, *, kv_len: float,
                            causal_factor: float = 0.5,
                            decode: bool = False) -> float:
    total = 0.0
    kinds = cfg.layer_kinds()
    ffns = cfg.ffn_kinds()
    for kind, ffn in zip(kinds, ffns):
        if kind == "attn":
            if cfg.use_mla:
                total += _mla_proj_flops(cfg, kv_len if decode else 1.0)
            else:
                total += _attn_proj_flops(cfg)
            total += _attn_score_flops(cfg, kv_len,
                                       1.0 if decode else causal_factor)
            total += _ffn_flops(cfg, ffn)
        else:
            total += _ssm_flops(cfg, decode)
            if cfg.family == "hybrid":
                total += _ffn_flops(cfg, ffn)
    total += 2 * cfg.d_model * cfg.vocab_size        # head
    return total


# ---------------------------------------------------------------------------
# cell-level accounting
# ---------------------------------------------------------------------------


def _param_bytes(cfg: ModelConfig) -> float:
    return cfg.param_count() * {"float32": 4, "bfloat16": 2}[cfg.param_dtype]


def kv_bytes_per_token_layer(cfg: ModelConfig, dt: int | None = None) -> int:
    """Bytes one token's K/V occupies in ONE attention layer's cache.

    This is the quantum the paged serving allocator deals in
    (``repro.serve.paging``): a page is ``page_len`` of these per layer.
    """
    if dt is None:
        dt = 2 if cfg.dtype == "bfloat16" else 4
    if cfg.use_mla:
        return (cfg.kv_lora_rank + cfg.qk_rope_dim) * dt
    return 2 * cfg.num_kv_heads * cfg.head_dim * dt


def kv_bytes_per_token(cfg: ModelConfig, dt: int | None = None) -> int:
    """Per-token attention-cache bytes across all layers (SSM state is
    O(1) per sequence, so it never scales with generated length)."""
    return kv_bytes_per_token_layer(cfg, dt) * cfg.layer_kinds().count("attn")


def _cache_bytes(cfg: ModelConfig, batch: int, seq: int,
                 dt: int | None = None) -> float:
    by = 0.0
    if dt is None:
        dt = 2 if cfg.dtype == "bfloat16" else 4
    for kind in cfg.layer_kinds():
        if kind == "attn":
            by += batch * seq * kv_bytes_per_token_layer(cfg, dt)
        else:
            by += batch * (cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim
                           * 4 +
                           (cfg.ssm_conv - 1) *
                           (cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state)
                           * dt)
    return by


def train_cell_cost(cfg: ModelConfig, *, global_batch: int, seq: int,
                    plan: ParallelismPlan, name: str = "") -> CellCost:
    tokens = global_batch * seq
    fwd = forward_flops_per_token(cfg, kv_len=seq) * tokens
    if not plan.remat:
        mult = 3.0                         # fwd + 2×bwd
    elif cfg.remat_policy == "dots":
        mult = 3.35                        # matmul outputs saved: only the
                                           # cheap elementwise work recomputes
    else:
        mult = 4.0                         # full remat: +1 forward recompute
    gflops = fwd * mult
    model_flops = 6.0 * cfg.active_param_count() * tokens
    chips = plan.chips

    p_bytes = _param_bytes(cfg)
    # params: fwd read + bwd read (remat re-read) + grad write + adam m/v r/w
    n = cfg.param_count()
    param_traffic = p_bytes * (3 if plan.remat else 2) + n * 4 + n * 2 * 2 * 2
    d = cfg.d_model
    act_dt = 2 if cfg.dtype == "bfloat16" else 4
    units = max(1, cfg.num_layers //
                (cfg.attn_period if cfg.family == "hybrid" else 1))
    # saved scan carries (remat saves one activation per unit) r/w ×2
    act_traffic = 4 * units * tokens * d * act_dt
    logits_traffic = 2 * tokens * cfg.vocab_size * 4 / 1  # fwd write + bwd read
    hbm_per_chip = (param_traffic + act_traffic + logits_traffic) / chips

    # ICI: FSDP param AG (fwd + bwd) + grad reduce-scatter, sharded over dp
    # after tp split; TP activation all-reduces 2/layer fwd + 2 bwd.
    ici = 0.0
    if plan.fsdp and plan.dp > 1:
        ici += 3 * p_bytes / plan.tp          # 2×AG(bf16) + RS(grads bf16)
    if plan.tp > 1:
        per_ar = (tokens / plan.dp) * d * act_dt
        ici += 2 * 4 * cfg.num_layers * per_ar / 1  # ring AR ≈ 2× payload
    if cfg.is_moe:
        ici += 2 * 2 * (tokens / plan.dp) * cfg.top_k * d * act_dt
    ici_per_chip = ici
    return CellCost(name, gflops, model_flops, gflops / chips, hbm_per_chip,
                    ici_per_chip,
                    breakdown={"fwd_flops": fwd, "param_bytes": p_bytes,
                               "param_traffic": param_traffic,
                               "act_traffic": act_traffic,
                               "logits_traffic": logits_traffic})


def prefill_cell_cost(cfg: ModelConfig, *, global_batch: int, seq: int,
                      plan: ParallelismPlan, name: str = "") -> CellCost:
    tokens = global_batch * seq
    gflops = forward_flops_per_token(cfg, kv_len=seq) * tokens
    model_flops = 2.0 * cfg.active_param_count() * tokens
    chips = plan.chips
    p_bytes = _param_bytes(cfg)
    act_dt = 2 if cfg.dtype == "bfloat16" else 4
    act_traffic = 2 * cfg.num_layers * tokens * cfg.d_model * act_dt
    cache_traffic = _cache_bytes(cfg, global_batch, seq)
    hbm_per_chip = (p_bytes + act_traffic + cache_traffic) / chips
    ici = 0.0
    if plan.fsdp and plan.dp > 1:
        ici += p_bytes / plan.tp
    if plan.tp > 1:
        ici += 2 * 2 * cfg.num_layers * (tokens / plan.dp) * cfg.d_model * act_dt
    if cfg.is_moe:
        ici += 2 * 2 * (tokens / plan.dp) * cfg.top_k * cfg.d_model * act_dt
    return CellCost(name, gflops, model_flops, gflops / chips, hbm_per_chip,
                    ici,
                    breakdown={"param_bytes": p_bytes,
                               "cache_bytes": cache_traffic})


def decode_cell_cost(cfg: ModelConfig, *, global_batch: int, seq: int,
                     plan: ParallelismPlan, name: str = "") -> CellCost:
    tokens = global_batch                     # one new token per sequence
    gflops = forward_flops_per_token(cfg, kv_len=seq, decode=True) * tokens
    model_flops = 2.0 * cfg.active_param_count() * tokens
    chips = plan.chips
    p_bytes = _param_bytes(cfg)
    cache = _cache_bytes(cfg, global_batch, seq, dt=plan.kv_cache_bytes)
    # every step reads all params + the whole live cache, writes one slot
    hbm_per_chip = (p_bytes + cache) / chips
    act_dt = 2 if cfg.dtype == "bfloat16" else 4
    ici = 0.0
    if plan.serving_weights == "gather" and plan.fsdp and plan.dp > 1:
        ici += p_bytes / plan.tp              # per-step param AG (serving)
    if plan.tp > 1 or plan.serving_weights == "resident":
        # resident weights: per-layer activation all-reduces instead
        ici += 2 * 2 * cfg.num_layers * (tokens / max(1, plan.dp)) * \
            cfg.d_model * act_dt
    return CellCost(name, gflops, model_flops, gflops / chips, hbm_per_chip,
                    ici,
                    breakdown={"param_bytes": p_bytes, "cache_bytes": cache})


def cell_cost(cfg: ModelConfig, shape, plan: ParallelismPlan) -> CellCost:
    name = f"{cfg.name}__{shape.name}"
    if shape.kind == "train":
        return train_cell_cost(cfg, global_batch=shape.global_batch,
                               seq=shape.seq_len, plan=plan, name=name)
    if shape.kind == "prefill":
        return prefill_cell_cost(cfg, global_batch=shape.global_batch,
                                 seq=shape.seq_len, plan=plan, name=name)
    return decode_cell_cost(cfg, global_batch=shape.global_batch,
                            seq=shape.seq_len, plan=plan, name=name)
