"""GPipe-style pipeline parallelism over a mesh axis.

Twin of ``repro/parallel/pipeline.py``. At the assigned scale FSDP x TP
covers the memory budget, so the production meshes reserve no stage axis;
this module is the composable pipeline primitive for larger deployments,
where a ("stage", "data", "model") mesh holds one stack of layer units
per stage.

The reference runs under ``shard_map`` with ``lax.ppermute`` between
stages. Here every rank of the ``stage`` axis runs :func:`pipeline_apply`
(SPMD): it applies its own stage, and activations move to the next stage
by point-to-point send/recv, M + S - 1 ticks for M microbatches over S
stages (fill and drain). The last stage collects the outputs and a sum
over the stages hands them to every stage. It is differentiable: the
send/recv is a ``torch.autograd.Function`` whose backward sends the
gradient upstream, so the same primitive backs training.
"""

from __future__ import annotations

import torch


def _p2p(send: torch.Tensor | None, dst: int | None, recv_like: torch.Tensor,
         src: int | None, group) -> torch.Tensor:
    """Send ``send`` to group rank ``dst`` and receive a tensor like
    ``recv_like`` from ``src`` at once (zeros where ``src`` is None)."""
    import torch.distributed as dist
    out = torch.zeros_like(recv_like)
    ops = []
    if send is not None and dst is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), dst, group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out, src, group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def _neighbours(stage: int, stages: int, group):
    """(global rank of the next stage or None, of the previous or None)."""
    import torch.distributed as dist
    ranks = dist.get_process_group_ranks(group)
    nxt = ranks[stage + 1] if stage + 1 < stages else None
    prv = ranks[stage - 1] if stage > 0 else None
    return nxt, prv


class _ShiftDown(torch.autograd.Function):
    """The ppermute (i -> i+1): this stage's ``y`` goes to the next stage,
    the previous stage's arrives (zeros at stage 0). The backward sends
    the gradient of what arrived back upstream and takes the gradient of
    ``y`` from downstream (zeros at the last stage)."""

    @staticmethod
    def forward(ctx, y, stage, stages, group):
        nxt, prv = _neighbours(stage, stages, group)
        ctx.links = (nxt, prv, group)
        return _p2p(y, nxt, y, prv, group)

    @staticmethod
    def backward(ctx, grad):
        nxt, prv, group = ctx.links
        return _p2p(grad, prv, grad, nxt, group), None, None, None


class _StageSum(torch.autograd.Function):
    """The sum over the stage axis (the reference's ``psum``) of the
    collected outputs, which only the last stage holds. Every stage then
    computes the same loss from the same sum, so its backward hands each
    stage the gradient of its own copy, unchanged. ``tie`` (the last
    activation that arrived) joins the graph with a zero gradient, so
    every stage's backward walks its whole chain of sends and receives,
    in the same order on every stage."""

    @staticmethod
    def forward(ctx, part, tie, group):
        import torch.distributed as dist
        out = part.clone()
        dist.all_reduce(out, group=group)
        ctx.tie = (tie.shape, tie.dtype, tie.device)
        return out

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.tie
        return grad, torch.zeros(shape, dtype=dtype, device=device), None


class _Tie(torch.autograd.Function):
    """``x`` unchanged, with ``anchor`` in the graph at zero gradient."""

    @staticmethod
    def forward(ctx, x, anchor):
        ctx.anchor = (anchor.shape, anchor.dtype, anchor.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.anchor
        return grad, torch.zeros(shape, dtype=dtype, device=device)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(stage_fn, stage_params, x_micro: torch.Tensor, *, mesh,
                   stage_axis: str = "stage") -> torch.Tensor:
    """Run ``y = stage_S-1(...stage_0(x))`` as a microbatched pipeline.

    Every rank of ``mesh``'s ``stage_axis`` calls it with the same
    arguments. stage_params: a tensor or a dict/list tree of them, stacked
    on a leading stage axis of size S (each stage uses its own slice; a
    ``DTensor`` sharded on that axis gives its local one). x_micro: (M,
    micro_batch, ...) microbatched input. Returns (M, micro_batch, ...),
    the outputs in stage order, on every stage."""
    from repro_torch.parallel.sharding import is_dtensor
    dim = mesh.mesh_dim_names.index(stage_axis)
    stages = mesh.size(dim)
    stage = mesh.get_coordinate()[dim]
    group = mesh.get_group(stage_axis)
    num_micro = x_micro.shape[0]
    ticks = num_micro + stages - 1
    params = _tree_map(lambda t: t.to_local()[0] if is_dtensor(t)
                       else t[stage], stage_params)

    state = torch.zeros_like(x_micro[0])
    outputs = [None] * num_micro
    for t in range(ticks):
        # stage 0 injects microbatch t (if still filling); tying the
        # arrival it ignores keeps its backward's receives in step
        cur = (_Tie.apply(x_micro[min(t, num_micro - 1)], state)
               if stage == 0 else state)
        y = stage_fn(params, cur)
        # collect at the last stage once the pipe is full
        if stage == stages - 1 and t >= stages - 1:
            outputs[t - (stages - 1)] = y
        # ship activations downstream
        state = _ShiftDown.apply(y, stage, stages, group)
    part = (torch.stack(outputs) if stage == stages - 1
            else torch.zeros_like(x_micro))
    return _StageSum.apply(part, state, group)


def stack_stages(unit_params, num_stages: int):
    """Regroup a (units, ...) stack of unit parameters (a tensor or a tree
    of them) into (stages, units/stages, ...) for pipeline placement."""

    def regroup(leaf):
        u = leaf.shape[0]
        assert u % num_stages == 0, f"{u} units across {num_stages} stages"
        return leaf.reshape(num_stages, u // num_stages, *leaf.shape[1:])

    return _tree_map(regroup, unit_params)
