"""Capture a step into a CUDA graph.

The JAX package compiles a scan of its step into one program; the port
captures one step, whose inputs and outputs are static tensors that the
step updates in place, and replays it.  A captured step must read nothing
on the host: no ``.item()``, no tensor built from Python data on the card,
no branch on a device value.
"""

from __future__ import annotations

import torch


def capture(step, warmup, device) -> torch.cuda.CUDAGraph:
    """Run ``warmup()`` once on a side stream (library handles, workspaces,
    the allocator's first blocks; it must leave the static buffers as they
    are), then capture ``step()`` into a graph and return it."""
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        warmup()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    return graph
