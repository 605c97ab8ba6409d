"""Mamba2 / SSD block (state-space duality, arXiv:2405.21060), in PyTorch.

Twin of ``repro/models/ssm.py``. Training and prefill run the chunked SSD
algorithm: an intra-chunk attention-like term plus an inter-chunk state,
carried here by a Python loop over the chunks where the reference scans
(``lax.scan``; no Pallas kernel). Decode runs the O(1) per-token
recurrence on the (heads, state, head_dim) SSM state plus a rolling
depthwise-conv window.

x/B/C share one input projection and one depthwise conv; A is scalar per
head; a gated RMSNorm comes before the output projection. The SSM state
is float32 in every dtype. Cache writes are IN PLACE.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _init, rms_norm, wide
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import constrain


def _dims(cfg: ModelConfig) -> tuple[int, int, int, int, int]:
    return (cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
            cfg.ssm_state)


def conv_dim(cfg: ModelConfig) -> int:
    d_in, _, _, g, n = _dims(cfg)
    return d_in + 2 * g * n


def init_ssm(cfg: ModelConfig, generator: torch.Generator | None,
             device) -> dict[str, torch.Tensor]:
    d = cfg.d_model
    d_in, h, _, g, n = _dims(cfg)
    pd = cfg.parameter_dtype
    f32 = torch.float32
    proj_out = 2 * d_in + 2 * g * n + h          # z, x, B, C, dt
    return {
        "ssm_norm": torch.ones((d,), dtype=pd, device=device),
        "in_proj": _init(generator, (d, proj_out), d, pd, device),
        "conv_w": _init(generator, (cfg.ssm_conv, conv_dim(cfg)),
                        cfg.ssm_conv, pd, device),
        "conv_b": torch.zeros((conv_dim(cfg),), dtype=pd, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32,
                                          device=device)),
        "ssm_D": torch.ones((h,), dtype=f32, device=device),
        "dt_bias": torch.full((h,), -4.0, dtype=f32, device=device),
        "gate_norm": torch.ones((d_in,), dtype=pd, device=device),
        "out_proj": _init(generator, (d_in, d), d_in, pd, device),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    d_in, h, _, _, _ = _dims(cfg)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + conv_dim(cfg)]
    dt = zxbcdt[..., -h:]
    return z, xbc, dt


def _split_xbc(xbc: torch.Tensor, cfg: ModelConfig):
    d_in, _, _, g, n = _dims(cfg)
    return (xbc[..., :d_in], xbc[..., d_in:d_in + g * n],
            xbc[..., d_in + g * n:])


def _pad_seq(t: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Zero-pad axis 1 of ``t``."""
    return F.pad(t, [0, 0] * (t.ndim - 2) + [before, after])


def ssd_chunked(x, dt, a_log, b, c, d_skip, chunk: int, initial_state=None):
    """x: (B,S,H,P); dt: (B,S,H) (post-softplus); b/c: (B,S,G,N).
    Returns y: (B,S,H,P) and the final state (B,H,N,P).

    ``initial_state`` (B,H,N,P) carries the recurrence across chunked
    prefill steps; ``None`` is a zero state."""
    if sharding.is_dtensor(x):
        return _ssd_on_shards(x, dt, a_log, b, c, d_skip, chunk,
                              initial_state)
    s_orig = x.shape[1]
    if s_orig % chunk:
        # pad to a chunk multiple: dt=0 ⇒ decay 1 and zero input, so padded
        # steps are state-neutral
        pad = chunk - s_orig % chunk
        x, dt, b, c = (_pad_seq(t, 0, pad) for t in (x, dt, b, c))
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    nc = s // chunk
    a = -torch.exp(a_log)                                  # (H,) negative

    la = dt * a                                            # (B,S,H) log decay
    xb = x * dt[..., None]

    def ch(t):                                             # (B,nc,L,...)
        return t.reshape(bs, nc, chunk, *t.shape[2:])

    xc, lc, bc_, cc = ch(xb), ch(la), ch(b), ch(c)
    lcum = torch.cumsum(lc, dim=2)                         # (B,nc,L,H)
    ltot = lcum[:, :, -1]                                  # (B,nc,H)

    bh = bc_.repeat_interleave(rep, dim=3) if rep > 1 else bc_  # (B,nc,L,H,N)
    chh = cc.repeat_interleave(rep, dim=3) if rep > 1 else cc

    # intra-chunk (the "attention-like" SSD term)
    sc = torch.einsum("bclhn,bcmhn->bchlm", wide(chh), wide(bh))
    # decay D[l,m] = exp(lcum[l] - lcum[m]) for l >= m; the entries above
    # the diagonal are masked to exp(-inf) = 0 before the exp, which
    # changes no value the mask keeps, but keeps their exp(+large) from
    # overflowing to inf, whose 0 * inf would be NaN in the backward pass
    ll = lcum.permute(0, 1, 3, 2)                          # (B,nc,H,L)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    dmat = torch.exp(torch.where(mask, ll[..., :, None] - ll[..., None, :],
                                 -torch.inf))              # (B,nc,H,L,M)
    m_ = torch.where(mask, sc * dmat, 0.0)
    y_diag = torch.einsum("bchlm,bcmhp->bclhp", m_, wide(xc))

    # per-chunk state contribution: sum_m exp(ltot - lcum[m]) B_m x_m^T
    wt = torch.exp(ltot[:, :, None] - lcum)                # (B,nc,L,H)
    hc = torch.einsum("bclhn,bclh,bclhp->bchnp", wide(bh), wt,
                      wide(xc))                            # (B,nc,H,N,P)

    # inter-chunk recurrence, one chunk at a time
    hstate = (wide(initial_state) if initial_state is not None
              else hc.new_zeros((bs, h, n, p)))
    hprevs = []
    for i in range(nc):
        hprevs.append(hstate)
        hstate = hstate * torch.exp(ltot[:, i])[..., None, None] + hc[:, i]
    hprev = torch.stack(hprevs, dim=1)                     # (B,nc,H,N,P)

    y_off = torch.einsum("bclhn,bclh,bchnp->bclhp", wide(chh),
                         torch.exp(lcum), hprev)
    y = (y_diag + y_off).reshape(bs, s, h, p)
    y = y + d_skip[None, None, :, None] * wide(x)
    return y[:, :s_orig].to(x.dtype), hstate


def _ssd_on_shards(x, dt, a_log, b, c, d_skip, chunk: int,
                   initial_state=None):
    """:func:`ssd_chunked` on each rank's own batch rows, where ``x`` is
    a ``DTensor``: the scan runs along the sequence within each (row,
    head), so with x laid out as the reference constrains it (batch
    sharded, the rest whole) and the other inputs alike, every rank runs
    the unsharded arithmetic on its rows with no communication, where a
    ``DTensor`` op per chunk step would dispatch thousands of times. The
    results rejoin the mesh by the same batch placements."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    x = constrain(x, "batch", "seq", None, None)
    mesh, place = x.device_mesh, tuple(x.placements)
    if not all(p.is_replicate() or p.is_shard(0) for p in place):
        raise ValueError(f"an SSD input laid out {place}: only its batch "
                         "axis may be sharded")
    whole = [Replicate()] * mesh.ndim
    # the per-head parameters' local gradients cover this rank's batch
    # rows only: a share of the sum over the ranks that split the batch
    shares = [Partial() if p.is_shard(0) else Replicate() for p in place]

    def local(t, lay, grad=None):
        if t is None:
            return None
        if not sharding.is_dtensor(t):
            t = sharding.on_mesh_of(t, x)
        if tuple(t.placements) != tuple(lay):
            t = t.redistribute(mesh, lay)
        return sharding.to_local(t, grad)

    y, state = ssd_chunked(local(x, place), local(dt, place),
                           local(a_log, whole, shares), local(b, place),
                           local(c, place), local(d_skip, whole, shares),
                           chunk, local(initial_state, place))
    return (DTensor.from_local(y, mesh, place, run_check=False),
            DTensor.from_local(state, mesh, place, run_check=False))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s own formula, log(exp(x) + 1), with no
    threshold (``F.softplus`` returns x above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def apply_ssm(params, xres: torch.Tensor, cfg: ModelConfig, *,
              cache: dict | None = None, cache_index=None,
              slot_ids: torch.Tensor | None = None,
              seq_lens: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, dict | None]:
    """Full mamba2 block with residual. cache = {conv (B,W-1,Cd), state
    (B,H,N,P)} for one-token decode, updated IN PLACE.

    Paged serving: ``slot_ids`` (B,) selects the cache rows to read and
    update (the SSM state is slot-resident: O(1) per sequence, never
    paged); a row whose ``cache_index`` is 0 starts fresh (first prefill
    chunk). With s>1 this is one chunked-prefill step: the SSD recurrence
    carries the cached state, and ``seq_lens`` (B,) masks the chunk's
    padded tail (dt=0 ⇒ state-neutral, kept out of the conv window)."""
    bs, s, _ = xres.shape
    d_in, h, p, g, n = _dims(cfg)
    width = cfg.ssm_conv
    xn = rms_norm(xres, params["ssm_norm"], cfg.norm_eps)
    zxbcdt = xn @ params["in_proj"]
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    dt = _softplus(wide(dt) + params["dt_bias"])

    w = wide(params["conv_w"])                             # (W, Cd)
    conv_b = wide(params["conv_b"])
    if cache is None:
        # causal depthwise conv over the sequence
        pad = _pad_seq(wide(xbc), width - 1, 0)
        xbc_c = sum(pad[:, i:i + s] * w[i] for i in range(width))
        xbc_c = F.silu(xbc_c + conv_b)
        x, bmat, cmat = _split_xbc(xbc_c.to(xres.dtype), cfg)
        x = constrain(x.reshape(bs, s, h, p), "batch", "seq", None, None)
        y, state = ssd_chunked(x, dt, params["A_log"],
                               bmat.reshape(bs, s, g, n),
                               cmat.reshape(bs, s, g, n), params["ssm_D"],
                               min(cfg.ssm_chunk, s))
        conv_tail = _pad_seq(xbc, width - 1, 0)[:, -(width - 1):]
        new_cache = {"conv": conv_tail.to(xres.dtype), "state": state}
    else:
        conv_prev, state_prev = cache["conv"], cache["state"]
        if slot_ids is not None:
            conv_prev = conv_prev[slot_ids]
            state_prev = state_prev[slot_ids]
            # a row starting at position 0 is a fresh request: its slot may
            # hold a previous occupant's state, which must not leak in
            fresh = cache_index == 0
            conv_prev = torch.where(fresh[:, None, None], 0.0, conv_prev)
            state_prev = torch.where(fresh[:, None, None, None], 0.0,
                                     state_prev)
        if s == 1:
            # O(1) decode: roll the conv window, one recurrence step
            window = torch.cat([conv_prev, xbc.to(xres.dtype)], dim=1)
            xbc_c = torch.einsum("bwc,wc->bc", window.float(), w)
            xbc_c = F.silu(xbc_c + conv_b)
            x, bmat, cmat = _split_xbc(xbc_c[:, None].to(xres.dtype), cfg)
            x = x.reshape(bs, h, p)
            a = -torch.exp(params["A_log"])
            decay = torch.exp(dt[:, 0] * a)                # (B,H)
            bh = bmat.reshape(bs, g, n).repeat_interleave(h // g, dim=1)
            chh = cmat.reshape(bs, g, n).repeat_interleave(h // g, dim=1)
            xb = (x * dt[:, 0, :, None]).float()           # (B,H,P)
            new_state = (state_prev * decay[..., None, None]
                         + torch.einsum("bhn,bhp->bhnp", bh.float(), xb))
            y = torch.einsum("bhn,bhnp->bhp", chh.float(), new_state)
            y = y + params["ssm_D"][None, :, None] * x.float()
            y = y[:, None].to(xres.dtype)
            new_conv = window[:, 1:]
        else:
            # chunked prefill: one multi-token step carrying the cached
            # state; padded chunk-tail tokens are state-neutral (dt=0)
            if seq_lens is None:
                seq_lens = torch.full((bs,), s, dtype=torch.long,
                                      device=xres.device)
            steps = torch.arange(s, device=xres.device)
            tok_valid = steps[None, :] < seq_lens[:, None]
            dt = torch.where(tok_valid[:, :, None], dt, 0.0)
            window_f = torch.cat([conv_prev.float(), xbc.float()], dim=1)
            xbc_c = sum(window_f[:, i:i + s] * w[i] for i in range(width))
            xbc_c = F.silu(xbc_c + conv_b)
            x, bmat, cmat = _split_xbc(xbc_c.to(xres.dtype), cfg)
            y, new_state = ssd_chunked(
                x.reshape(bs, s, h, p), dt, params["A_log"],
                bmat.reshape(bs, s, g, n), cmat.reshape(bs, s, g, n),
                params["ssm_D"], min(cfg.ssm_chunk, s),
                initial_state=state_prev)
            # conv window = the last (W-1) inputs ending at the last VALID
            # token, so the padded tail never reaches the next step
            win_src = torch.cat([conv_prev, xbc.to(xres.dtype)], dim=1)
            rows = seq_lens.long()[:, None] + torch.arange(
                width - 1, device=xres.device)[None, :]
            new_conv = win_src[torch.arange(bs, device=xres.device)[:, None],
                               rows]
        conv, state = cache["conv"], cache["state"]
        if slot_ids is not None:
            conv[slot_ids] = new_conv.to(conv.dtype)
            state[slot_ids] = new_state
        else:
            conv.copy_(new_conv)
            state.copy_(new_state)
        new_cache = {"conv": conv, "state": state}

    y = y.reshape(bs, s, d_in)
    y = rms_norm(y * F.silu(wide(z)).to(y.dtype), params["gate_norm"],
                 cfg.norm_eps)
    y = constrain(y, "batch", "seq", "inner")
    return xres + (y @ params["out_proj"]).to(xres.dtype), new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    d_in, h, p, g, n = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim(cfg)),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, h, n, p), dtype=torch.float32,
                             device=device),
    }
