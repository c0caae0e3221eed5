"""Phase timers, RTF tracking and a hierarchical profiler.

Counterpart of ``chrono_tpu/utils/timers.py`` (the reference's step timers
and ``CH_PROFILE``): host wall timers around device calls — synchronised
with the card where the work ran there, so an asynchronous launch does not
end the timing early — a real-time-factor accumulator, and a hook into
``torch.profiler`` for device traces.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def _sync(result) -> None:
    """Wait until the tensors of ``result`` (a tensor, or a tuple, list,
    dict or dataclass of them) are computed on their CUDA devices."""
    stack, devices = [result], set()
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                devices.add(v.device)
        elif isinstance(v, (tuple, list)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif hasattr(v, "__dataclass_fields__"):
            stack.extend(getattr(v, f) for f in v.__dataclass_fields__)
    for d in devices:
        torch.cuda.synchronize(d)


class PhaseTimers:
    """Named accumulating wall timers + RTF (the ChSystem timer surface)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.sim_time = 0.0
        self.wall_time = 0.0

    @contextlib.contextmanager
    def phase(self, name: str, sync_result=None):
        """Time the block; with ``sync_result`` (the block's output, or a
        container of it), wait for its tensors' cards before stopping."""
        t0 = time.perf_counter()
        yield
        if sync_result is not None:
            _sync(sync_result)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def add_sim_time(self, dt: float, wall: float):
        self.sim_time += dt
        self.wall_time += wall

    @property
    def rtf(self) -> float:
        """Real-time factor: wall seconds per simulated second."""
        return self.wall_time / self.sim_time if self.sim_time > 0 else 0.0

    def report(self) -> str:
        lines = [f"{'phase':<24}{'total[s]':>10}{'calls':>8}{'mean[ms]':>10}"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:<24}{t:>10.3f}{c:>8}{1e3 * t / c:>10.3f}")
        if self.sim_time > 0:
            lines.append(f"RTF = {self.rtf:.2f} (wall/sim)")
        return "\n".join(lines)


class Profiler:
    """Hierarchical scoped profiler (CH_PROFILE analogue)::

        prof = Profiler()
        with prof("advance"):
            with prof("collision"):
                ...
        print(prof.report())
    """

    def __init__(self):
        self.stack = []
        self.nodes = defaultdict(lambda: [0.0, 0])  # path -> [total, count]

    @contextlib.contextmanager
    def __call__(self, name: str):
        self.stack.append(name)
        path = "/".join(self.stack)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            node = self.nodes[path]
            node[0] += dt
            node[1] += 1
            self.stack.pop()

    def report(self) -> str:
        lines = []
        for path in sorted(self.nodes):
            total, count = self.nodes[path]
            depth = path.count("/")
            name = path.split("/")[-1]
            lines.append(f"{'  ' * depth}{name:<{30 - 2 * depth}}"
                         f"{total:>10.4f}s {count:>7}x")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the block with ``torch.profiler`` (host, and the card where
    there is one) and write a Chrome trace to ``logdir/trace.json``;
    yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
