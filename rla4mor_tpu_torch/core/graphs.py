"""CUDA-graph replay of a fixed operator.

An operator applied many times on one shape, built of many small kernels
(the V-cycle: thousands of launches a call on a 1025^2 grid, each a few
microseconds of device work), spends its time launching. :func:`graphed`
captures one call in a CUDA graph and replays it: one launch a call, the
same kernels in the same order, so the values are the eager call's. On a
CPU tensor it returns the function itself.
"""

from __future__ import annotations

from typing import Callable

import torch


def graphed(fn: Callable[[torch.Tensor], torch.Tensor], example: torch.Tensor,
            warmup: int = 2) -> Callable[[torch.Tensor], torch.Tensor]:
    """``fn`` (a tensor -> tensor function of fixed shapes with no host
    synchronisation) replayed from a CUDA graph captured on ``example``'s
    shape, dtype and device; ``fn`` itself on the CPU. The warm-up calls run
    before the capture, on a side stream, so that caches ``fn`` fills (masks,
    workspaces) are allocated outside the graph's pool. Each call copies its
    input into the captured buffer, replays, and returns a copy of the
    captured output (the next replay overwrites it)."""
    if example.device.type != "cuda":
        return fn
    device = example.device
    static_in = example.clone()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn(static_in)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = fn(static_in)

    def call(x: torch.Tensor) -> torch.Tensor:
        static_in.copy_(x)
        graph.replay()
        return static_out.clone()

    call.graph = graph  # the graph lives as long as the callable
    return call
