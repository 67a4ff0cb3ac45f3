"""The port's spans and stage boundaries: where a render pass or a train
step spends its host time, and where a chunk spends its device time.

Spans (`span(name)`) time coarse host work, a dozen a pass or a step, and
are always on: each keeps its name, parent and start and end on
`time.perf_counter_ns`. Spans live in memory: totals by name since the
process started, and a ring of the last RING top-level span trees. While a
`torch.profiler` session records ("tracing"), each span also enters
`torch.profiler.record_function(name)`, so the profile shows it on the
kernels' clock.

    render_plan                    a pass (render.render_plan)
        prepare                    params copy, pixel arrays, programs.begin
        chunk                      one pixel chunk
            eager | record | replay
            splat                  the tent film's splat
        readback                   the image to the host
    record                         a chunk program's recording (under chunk)
    render_sharded                 a sharded render (parallel/mesh.py)
        slab                       this rank's pieces, a `chunk` each
        gather                     the film rows of every rank onto this one
    train_step                     a step (parallel/mesh.py)
        forward, backward          each sub-chunk's
        allreduce                  the sharded step's gradient average
        optimizer

Stages split one render chunk's device work. `with stages(device):` opens
a chunk; each `stage(label)` inside ends the open stage and opens the
next, and the chunk's end closes the last: the stages partition the chunk.
Labels: sample (Halton), intersect (closest hit, attributes, emission,
material lookup), shade (lobes, BSDF sample, continuation, Russian
roulette), nee (next-event estimation), film (camera rays, the film's
reduction or taps), and launch (a replay's static-input copies and graph
launch, from ChunkPrograms.run).

  - Inside a chunk program's recording (`recording()`), a boundary on the
    card records a persistent `torch.cuda.Event(enable_timing=True,
    external=True)`: the capture makes it an event node, which every
    replay records again, traced or not. The program keeps the timeline.
  - In eager code a boundary does anything only while tracing: an event on
    the card, the host clock on the CPU (which runs ops synchronously).
    Such timelines are read when their stages are asked for.
  - ChunkPrograms.run, while tracing on the card, notes an event before
    the replay (`device_mark`), synchronises after it and reads the
    program's timeline into the replay span (`replayed`).
  - A span timed on the card as a whole (`slab`, `gather`) gets the time
    between two such events as its `device_ms` (`timed`).

Counters (`count(name, n)`) add to the open span's `counts`: a sharded
render counts this rank's real and padding rows of the film and the bytes
of the film it gathers; each next-event estimation call counts the path it
took, `nee_kernel` or `nee_plain`, where the call is made (an eager chunk,
a recording, a train step's forward). `count_totals()` sums them by span.

With tracing off nothing is read and nothing synchronises.

An operator's view: run the work under `torch.profiler.profile(...)`
(record_function ranges name the spans in its trace) and print
`summary()`: span totals, counters and stage milliseconds.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Optional

import torch

RING = 256  # top-level span trees kept


def tracing() -> bool:
    """True while a torch.profiler session records."""
    return torch._C._autograd._profiler_enabled()


@dataclass(eq=False)
class Span:
    name: str
    parent: Optional["Span"]
    start_ns: int
    end_ns: int = 0
    children: list = field(default_factory=list)
    stages: list = field(default_factory=list)  # [(label, ms)] read under this span, in order
    device_ms: Optional[float] = None  # the span's time on the card, where it was timed
    counts: dict = field(default_factory=dict)  # {name: n} counted under this span

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def walk(self):
        """This span and every span under it, depth first."""
        yield self
        for c in self.children:
            yield from c.walk()

    def stage_ms(self) -> dict:
        """{label: ms} of the stages read under this span and its children."""
        out = {}
        for s in self.walk():
            for label, ms in s.stages:
                out[label] = out.get(label, 0.0) + ms
        return out


class _Timeline:
    """One chunk's boundaries: [(label, mark)], the last label None. A mark
    is a CUDA event on the card, a perf_counter_ns reading on the CPU."""

    def __init__(self, device: torch.device, persistent: bool):
        self.device = device
        self.persistent = persistent
        self.marks = []

    def mark(self, label: Optional[str]) -> None:
        self.marks.append((label, _mark(self.device, self.persistent)))

    @property
    def labels(self) -> list:
        return [label for label, _ in self.marks]


def _mark(device: torch.device, external: bool = False):
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True, external=external)
        ev.record()
        return ev
    return time.perf_counter_ns()


def _ms(a, b) -> float:
    return (b - a) / 1e6 if isinstance(a, int) else a.elapsed_time(b)


def _intervals(marks) -> list:
    """[(label, ms)] between consecutive marks; a None label opens none."""
    return [(la, _ms(a, b)) for (la, a), (_, b) in zip(marks, marks[1:]) if la is not None]


class _Record:
    """What the process has traced: span totals, the ring of top-level
    trees, stage totals and eager timelines not read yet."""

    def __init__(self):
        self.lock = threading.Lock()
        self.totals = {}  # name -> [count, ns]
        self.counts = {}  # (span name, counter) -> n, from the closed spans
        self.ring = deque(maxlen=RING)
        self.stages = {}  # label -> ms
        self.pending = []  # [(span or None, _Timeline)]

    def close(self, node: Span) -> None:
        with self.lock:
            t = self.totals.setdefault(node.name, [0, 0])
            t[0] += 1
            t[1] += node.end_ns - node.start_ns
            for counter, n in node.counts.items():
                key = (node.name, counter)
                self.counts[key] = self.counts.get(key, 0) + n
            if node.parent is None:
                self.ring.append(node)

    def add(self, node: Optional[Span], intervals) -> None:
        with self.lock:
            if node is not None:
                node.stages += intervals
            for label, ms in intervals:
                self.stages[label] = self.stages.get(label, 0.0) + ms

    def settle(self) -> None:
        """Read the eager timelines not read yet (a card's wait for their
        last event)."""
        with self.lock:
            pending, self.pending = self.pending, []
        for node, tl in pending:
            last = tl.marks[-1][1]
            if not isinstance(last, int):
                last.synchronize()
            self.add(node, _intervals(tl.marks))


_record = _Record()
_local = threading.local()


def _thread():
    t = _local
    if not hasattr(t, "stack"):
        t.stack = []  # open spans
        t.timeline = None  # the open chunk's boundaries
        t.captured = None  # timelines of the recording in progress
    return t


def reset() -> None:
    """Forget every span, stage and pending timeline (the open spans of
    this thread are kept open)."""
    global _record
    _record = _Record()


@contextmanager
def span(name: str):
    """Times the block as a span of `name` under the open span; yields the
    Span (its `seconds` once the block ends)."""
    t = _thread()
    parent = t.stack[-1] if t.stack else None
    node = Span(name, parent, time.perf_counter_ns())
    if parent is not None:
        parent.children.append(node)
    t.stack.append(node)
    try:
        with torch.profiler.record_function(name) if tracing() else nullcontext():
            yield node
    finally:
        node.end_ns = time.perf_counter_ns()
        t.stack.pop()
        _record.close(node)


@contextmanager
def recording():
    """The block records a chunk program: yields the list that receives
    the timelines its chunks capture."""
    t = _thread()
    outer, t.captured = t.captured, []
    try:
        yield t.captured
    finally:
        t.captured = outer


@contextmanager
def stages(device):
    """One chunk's stage boundaries on `device` (see the module's
    docstring); the block's end closes the last stage."""
    t = _thread()
    if t.captured is not None:
        tl = _Timeline(torch.device(device), persistent=True)
    elif tracing():
        tl = _Timeline(torch.device(device), persistent=False)
    else:
        yield
        return
    outer, t.timeline = t.timeline, tl
    try:
        yield
        tl.mark(None)
    finally:
        t.timeline = outer
    if tl.persistent:
        t.captured.append(tl)
    else:
        with _record.lock:
            _record.pending.append((t.stack[-1] if t.stack else None, tl))


def stage(label: str) -> None:
    """A boundary: the open chunk's stage `label` starts here."""
    tl = getattr(_local, "timeline", None)
    if tl is not None:
        tl.mark(label)


def device_mark(device):
    """An event on the card while tracing, else None: before a program's
    replay it opens the `launch` stage; around a span, `timed` reads two."""
    device = torch.device(device)
    if device.type != "cuda" or not tracing():
        return None
    return _mark(device)


def replayed(start, timelines) -> None:
    """After a replay that began at `start` (device_mark) has finished on
    the card: the program's captured timelines, led by `launch`, read into
    the open span and the stage totals."""
    marks = [("launch", start)] + [m for tl in timelines for m in tl.marks]
    t = _thread()
    _record.add(t.stack[-1] if t.stack else None, _intervals(marks))


def timed(node: Span, start, end) -> None:
    """The card's milliseconds from the event `start` to the event `end`
    (device_mark's, None when not tracing) into node.device_ms; waits for
    `end`."""
    if start is None or end is None:
        return
    end.synchronize()
    node.device_ms = start.elapsed_time(end)


def count(name: str, n: int) -> None:
    """Adds n to the open span's counter `name`."""
    t = _thread()
    if t.stack:
        node = t.stack[-1]
        node.counts[name] = node.counts.get(name, 0) + n


def totals() -> dict:
    """{span name: (count, seconds)} since the process started."""
    with _record.lock:
        return {k: (n, ns / 1e9) for k, (n, ns) in _record.totals.items()}


def count_totals() -> dict:
    """{(span name, counter): n} summed over the spans closed since the
    process started (or the last reset)."""
    with _record.lock:
        return dict(_record.counts)


def total_s(name: str) -> float:
    return totals().get(name, (0, 0.0))[1]


def stage_totals() -> dict:
    """{stage label: ms} since the process started."""
    _record.settle()
    with _record.lock:
        return dict(_record.stages)


def trees(name: Optional[str] = None) -> list:
    """The ring's top-level spans (of `name`), oldest first, with their
    eager stages read."""
    _record.settle()
    with _record.lock:
        return [s for s in _record.ring if name is None or s.name == name]


def fully_replayed(node: Span) -> bool:
    """A render_plan pass whose every chunk replayed a program and did
    nothing else (no eager chunk, no recording)."""
    chunks = [c for c in node.children if c.name == "chunk"]
    return bool(chunks) and all([g.name for g in c.children if g.name != "splat"] == ["replay"]
                                for c in chunks)


def traced_pass_ms() -> Optional[dict]:
    """{stage label: ms} (the card's device ms) of the last fully replayed
    render_plan pass whose every replay was traced; None where there is
    none."""
    for node in reversed(trees("render_plan")):
        replays = [s for s in node.walk() if s.name == "replay"]
        if fully_replayed(node) and all(s.stages for s in replays):
            return node.stage_ms()
    return None


def summary() -> str:
    """Span totals, counters by span and stage milliseconds, one line
    each."""
    lines = [f"{'span':<12} {'count':>7} {'total s':>11} {'mean ms':>10}"]
    for name, (n, s) in sorted(totals().items(), key=lambda kv: -kv[1][1]):
        lines.append(f"{name:<12} {n:>7} {s:>11.4f} {1e3 * s / n:>10.3f}")
    counts = count_totals()
    if counts:
        lines.append(f"{'counter':<12} {'span':<12} {'n':>10}")
        for (name, counter), n in sorted(counts.items(), key=lambda kv: (kv[0][1], kv[0][0])):
            lines.append(f"{counter:<12} {name:<12} {n:>10}")
    st = stage_totals()
    if st:
        lines.append(f"{'stage':<12} {'ms':>11} {'share':>7}")
        whole = sum(st.values())
        for label, ms in sorted(st.items(), key=lambda kv: -kv[1]):
            lines.append(f"{label:<12} {ms:>11.3f} {ms / whole:>7.1%}")
    return "\n".join(lines)
