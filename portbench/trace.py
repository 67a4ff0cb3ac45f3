"""What a `--trace 1` run reads from the card: kernel records of
torch.profiler sessions, the host wall each session covers, and the port's
own kernel names. Nothing here imports the port.

One session covers one unit of the port's work (a render chunk's program,
or a train step), so no session holds the tens of thousands of records
that a whole replayed pass makes: on the H100 such a session now and then
lost some of them.
"""

from __future__ import annotations

import re
import time
from contextlib import contextmanager
from pathlib import Path

import torch

# A kernel of the port's csrc/*.cu: `__global__ void [__launch_bounds__(..)] name(`
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def csrc_kernels(package_dir: Path) -> frozenset:
    """The names of the kernels defined in the port's csrc/*.cu."""
    names = set()
    for src in sorted((package_dir / "csrc").glob("*.cu")):
        names.update(_GLOBAL.findall(src.read_text()))
    return frozenset(names)


def base_name(kernel: str) -> str:
    """The function name of a profiler's demangled kernel name: "void
    curry::(anonymous namespace)::small_kernel<false, false>(float const*,
    ...)" → "small_kernel"."""
    s = kernel.replace("(anonymous namespace)", "")
    s = s[5:] if s.startswith("void ") else s
    return re.split(r"[<(]", s, maxsplit=1)[0].split("::")[-1].strip()


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Sessions:
    """Device records of profiler sessions: `with sessions.unit():` wraps
    one unit of work, synchronised at its end. Keeps each device record's
    (name, duration µs) and, per session, the union of the records'
    intervals (busy) and the host's wall of the unit (window)."""

    def __init__(self, device):
        self.device = device
        self.records = []  # (name, µs)
        self.busy_s = 0.0
        self.window_s = 0.0
        self.units = 0

    @contextmanager
    def unit(self):
        torch.cuda.synchronize(self.device)  # nothing of the work before runs inside
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize(self.device)
            self.window_s += time.perf_counter() - t0
        spans = []
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            self.records.append((e.name, e.time_range.end - e.time_range.start))
            spans.append((e.time_range.start, e.time_range.end))
        self.busy_s += union_us(spans) / 1e6
        self.units += 1

    def summary(self):
        """→ the record for the readers: records, busy and window seconds,
        units; and the 10 device operations that took most time, [name,
        seconds]."""
        return dict(records=self.records, busy_s=self.busy_s, window_s=self.window_s,
                    units=self.units), top_ops(op_seconds(self.records))


def op_seconds(records) -> dict:
    """{name: seconds} of (name, µs) device records."""
    by_name = {}
    for name, us in records:
        by_name[name] = by_name.get(name, 0.0) + us / 1e6
    return by_name


def top_ops(by_name: dict, n: int = 10) -> list:
    """The n operations that took most time, [[name, seconds], ...]."""
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]
