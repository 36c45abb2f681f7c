"""Pipeline parallelism over a mesh axis: the GPipe schedule.

The port of the reference package's ``train/pipeline_parallel.py``. The
layer stack is split into ``n_stages`` equal stages, one a device along the
stage axis (``pod`` by default); microbatches stream through, and an
activation hops from stage s to stage s + 1. The schedule takes M + S - 1
steps for M microbatches over S stages, so the bubble is (S - 1) / (M + S -
1). The reference runs one ``shard_map`` program whose activations move
by ``ppermute``; the port is single-controller: at each step it launches
every busy stage's work on that stage's device, and an activation moves
by ``Tensor.to`` (a peer copy between cards). On different cards the
stages' launches overlap in time; stages dealt onto one card run one after
another. Autograd runs through the schedule, so a loss on the outputs
trains every stage.

This is the ``pod``-axis alternative to pure data parallelism when a
model's layer stack does not fit one pod's memory, even fully sharded.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.launch.mesh import Mesh


def pipeline_forward(stage_fn: Callable, stage_params: Sequence,
                     microbatches: torch.Tensor, *, mesh: Mesh,
                     axis: str = "pod") -> torch.Tensor:
    """Run microbatches (M, ...) through the stages along ``axis``.

    ``stage_fn(params, x) -> y`` is one stage's computation (y shaped as x);
    ``stage_params[s]`` is stage s's parameters, on its device
    (``mesh.along(axis)[s]``). At step t stage 0 takes microbatch t while t
    < M, and stage s > 0 takes what stage s - 1 produced at step t - 1.
    Returns the last stage's M outputs (M, ...) on its device."""
    devices = mesh.along(axis)
    n_stages, m = len(devices), microbatches.shape[0]
    if len(stage_params) != n_stages:
        raise ValueError(f"{len(stage_params)} stage parameter sets for the "
                         f"{n_stages} stages of {axis!r}")
    state: list[torch.Tensor | None] = [None] * n_stages  # in flight
    outputs: list[torch.Tensor | None] = [None] * m
    for t in range(m + n_stages - 1):
        produced = [None] * n_stages
        for s, dev in enumerate(devices):
            if not 0 <= t - s < m:
                continue                       # this stage idles (bubble)
            x = microbatches[t] if s == 0 else state[s - 1]
            produced[s] = stage_fn(stage_params[s], x.to(dev))
        if produced[-1] is not None:
            outputs[t - (n_stages - 1)] = produced[-1]
        # the hop to the next stage's device
        state = [None if y is None else y.to(devices[min(s + 1,
                                                         n_stages - 1)])
                 for s, y in enumerate(produced)]
    return torch.stack(outputs)


def make_pipelined_apply(layer_fn: Callable, n_layers: int, n_stages: int,
                         axis: str = "pod"):
    """A per-layer function as a pipeline over ``n_stages`` stages of
    ``n_layers / n_stages`` consecutive layers each. Returns ``(apply,
    layers_per_stage)``: ``apply(layer_params, microbatches, mesh)`` takes
    the ``n_layers`` layers' parameters (a list), deals stage s the layers
    [s L/S, (s+1) L/S) (``stage_partition_spec``'s split of the layer
    axis) and runs :func:`pipeline_forward`; ``layer_fn(params, x) ->
    y``."""
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} "
                         f"stages")
    per = n_layers // n_stages

    def stage_fn(params_local, x):
        for p_l in params_local:
            x = layer_fn(p_l, x)
        return x

    def apply(layer_params: Sequence, microbatches: torch.Tensor,
              mesh: Mesh) -> torch.Tensor:
        stages = [list(layer_params[s * per:(s + 1) * per])
                  for s in range(n_stages)]
        return pipeline_forward(stage_fn, stages, microbatches, mesh=mesh,
                                axis=axis)

    return apply, per


def stage_partition_spec(axis: str = "pod") -> tuple:
    """The spec of stacked layer parameters: the layer axis over the stage
    axis."""
    return (axis,)
