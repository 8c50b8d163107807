"""Pipeline parallelism over a 'pp' mesh axis: the GPipe forward schedule
(the port of ``repro/distributed/pipeline.py``).

Each rank of the 'pp' axis is one stage and holds only its own stage's
parameters. The schedule runs n_micro + n_stages - 1 ticks: at tick t
stage 0 takes microbatch t, every other stage the activation its
predecessor sent at tick t - 1; a stage runs while 0 <= t - stage <
n_micro and sends its output to the next stage (``isend`` / ``irecv``
over the 'pp' group, where the reference's ``ppermute`` rings); the last
stage records the microbatches it finishes. The bubble is n_stages - 1
microbatch slots at fill and drain, GPipe's cost. At the end the outputs
reach every stage as a broadcast from the last one (the reference's
``psum`` of the last stage's outputs over the axis).
"""
from __future__ import annotations

import torch


def pipeline_forward(stage_fn, stage_params, x_microbatches, mesh, *,
                     axis: str = "pp"):
    """GPipe forward.

    stage_fn(stage_params, x) -> y: one stage's computation, y shaped as
    x. stage_params: this rank's stage's parameters. x_microbatches
    (n_micro, mb, ...): the inputs, which stage 0 reads. Returns the
    (n_micro, mb, ...) outputs of the last stage on every rank.
    """
    import torch.distributed as dist

    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    n_micro = x_microbatches.shape[0]
    assert n_micro >= n_stages, "need >= n_stages microbatches to fill the pipe"
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(axis)
    prev = dist.get_global_rank(group, stage - 1) if stage else None
    nxt = (dist.get_global_rank(group, stage + 1)
           if stage < n_stages - 1 else None)
    outs = torch.zeros_like(x_microbatches)
    sends = []
    for t in range(n_micro + n_stages - 1):
        if not 0 <= t - stage < n_micro:
            continue
        if stage == 0:
            x_in = x_microbatches[t]
        else:             # a fresh buffer: a sent output may alias it
            x_in = torch.empty_like(x_microbatches[0])
            dist.irecv(x_in, src=prev, group=group).wait()
        y = stage_fn(stage_params, x_in)
        if nxt is not None:
            sends.append(dist.isend(y.contiguous(), dst=nxt, group=group))
        else:
            outs[t - stage] = y
    for s in sends:
        s.wait()
    dist.broadcast(outs, src=dist.get_global_rank(group, n_stages - 1),
                   group=group)
    return outs
