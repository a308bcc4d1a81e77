"""Spans and counters of the port, and their place on a profiler trace's clock.

One switch for the whole process: ``enable(level=1)``, ``disable()``,
``enabled()``, ``level()``. Every call site reads it when it runs, so
tracing can be turned on between two steps of a running loop. Off,
``span(...)`` returns one shared no-op context, records nothing and
allocates nothing, ``mark`` returns its tensor and ``backward`` is
``loss.backward()``: the step's autograd graph is the same as without
tracing.

* **Levels**: a span or mark made with ``level=2`` records only when
  tracing is on at level 2. Level 1 (``enable()``) gives the step's spans
  and the encoders' backward phases; level 2 adds the voxel encoder's
  stages (``forward.voxel.tiles`` / ``.dense``, whose backward phases
  ``backward.voxel.dense`` and ``backward.voxel.tiles`` take the place of
  ``backward.voxel``) and the per-batch counter moves that pair the
  loader's active tiles with the encoder's tile rows.

* **Spans** (``span(name, request=None)``): name, parent (the innermost
  open span of the thread), the request they serve (``batch``: the loader's
  ``(epoch, index)``; ``step``: the trainer's global step; the thread's
  current ones, ``set_batch`` / ``set_step``, else the parent's),
  the native id of the thread, and start and end on one monotonic clock
  (``time.perf_counter_ns``). Finished spans stay in memory (``spans()``,
  ``clear()``) until they are written out.
* **Backward phases**: ``mark(x, name)`` puts an identity node on an
  encoder's output, and ``backward(loss)`` runs the backward under a
  ``backward`` span; each mark's node opens its phase span (``backward.<x>``)
  when the autograd engine reaches it, on the engine's thread, and the phase
  ends where the next begins or where the backward returns.
* **Counters** (``count(name, n=1)``): always on, an integer add under a
  lock (the native sweeps count from several threads). ``counter``,
  ``counts(prefix)`` and ``reset_counts(prefix)`` read and reset them.
  ``span(..., counters=prefix)`` records in the span how much each counter
  of that prefix moved while it was open.
* **Timers**: ``span(..., totals=d)`` adds its seconds to ``d[name]``
  whether tracing is on or not (the trainer's phases).
* **The trace's clock**: while a ``torch.profiler`` runs, each root span
  (and ``anchor()``) opens an anchor ``record_function`` on its thread and
  reads its own clock as the anchor ends. ``merge_into(chrome_trace)`` takes the median offset
  of the anchors found in the exported trace and writes every span of every
  thread into it, on the trace's clock, as complete events of category
  ``program_span``. (A ``record_function`` in a thread that started before
  the profiler, such as the loader's prefetch thread, does not reach the
  trace; the merged spans do.)
"""

from __future__ import annotations

import itertools
import os
import statistics
import threading
import time

import torch

CATEGORY = "program_span"
ANCHOR = "tracing.anchor#"

_level = 0  # 0: off
_lock = threading.Lock()
_counts: dict[str, int] = {}
_spans: list = []
_anchors: list = []  # (anchor name, own clock as the anchor ended)
_threads: dict[int, str] = {}
_ids = itertools.count(1)
_local = threading.local()
_backward = None  # the running ``backward`` span, whose phases the marks open

clock = time.perf_counter_ns


def enable(level: int = 1) -> None:
    global _level
    if level not in (1, 2):
        raise ValueError(f"tracing level must be 1 or 2, got {level!r}")
    _level = level


def disable() -> None:
    global _level
    _level = 0


def enabled() -> bool:
    return _level > 0


def level() -> int:
    """The level tracing is on at; 0 when it is off."""
    return _level


# ------------------------------------------------------------------ counters


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counter(name: str) -> int:
    return _counts.get(name, 0)


def counts(prefix: str = "") -> dict[str, int]:
    """The counters whose name starts with ``prefix``, by the rest of it."""
    with _lock:
        return {k[len(prefix):]: v for k, v in _counts.items() if k.startswith(prefix)}


def reset_counts(prefix: str = "") -> None:
    with _lock:
        for key in [k for k in _counts if k.startswith(prefix)]:
            del _counts[key]


# ------------------------------------------------------------------ spans


class Span:
    """One span; ``start`` and ``end`` in ns of ``clock``."""

    __slots__ = ("name", "id", "parent", "thread", "batch", "step", "start", "end", "args",
                 "phase", "_totals", "_counters", "_base")

    def __init__(self, name, parent=None, batch=None, totals=None, counters=None):
        self.name, self.id, self.parent = name, next(_ids), parent
        self.thread = threading.get_native_id()
        self.batch, self.step = batch, None
        self.start = self.end = None
        self.args = self.phase = None
        self._totals, self._counters, self._base = totals, counters, None

    def open(self, start=None) -> "Span":
        self.start = clock() if start is None else start
        stack = _stack()
        if self.parent is None and stack:
            self.parent = stack[-1]
        parent = self.parent
        if self.batch is None:
            self.batch = getattr(_local, "batch", None)
            if self.batch is None and parent is not None:
                self.batch = parent.batch
        self.step = getattr(_local, "step", None)
        if self.step is None and parent is not None:
            self.step = parent.step
        if parent is None:
            anchor()
        if self.thread not in _threads:
            _threads[self.thread] = threading.current_thread().name
        if self._counters is not None:
            self._base = counts(self._counters)
        return self

    def close(self, end=None) -> None:
        self.end = clock() if end is None else end
        if self._counters is not None:
            now = counts(self._counters)
            self.args = {self._counters + k: v - self._base.get(k, 0) for k, v in now.items()
                         if v != self._base.get(k, 0)}
        if self._totals is not None:
            self._totals[self.name] += (self.end - self.start) / 1e9
        _spans.append(self)

    def __enter__(self) -> "Span":
        self.open()
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        _stack().pop()
        self.close()

    @property
    def parent_id(self):
        return None if self.parent is None else self.parent.id


class _Off:
    """The shared context of a span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        return None


class _Timer:
    """A ``totals`` span while tracing is off: its seconds, no record."""

    __slots__ = ("name", "totals", "start")

    def __init__(self, name, totals):
        self.name, self.totals = name, totals

    def __enter__(self):
        self.start = clock()

    def __exit__(self, *exc) -> None:
        self.totals[self.name] += (clock() - self.start) / 1e9


_OFF = _Off()


def span(name: str, request=None, totals=None, counters: str | None = None, level: int = 1):
    """A context that records the span ``name`` while tracing is on at
    ``level`` or above. ``request``: the batch it serves (else its parent's
    or the thread's); ``totals``: a mapping that takes its seconds under
    ``name``, on or off; ``counters``: a counter prefix whose moves the span
    records."""
    if _level < level:
        return _OFF if totals is None else _Timer(name, totals)
    return Span(name, batch=request, totals=totals, counters=counters)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def set_batch(batch) -> None:
    """The batch this thread now serves: the request of its later root
    spans and of the span open now (the loader's wait that took it)."""
    if not _level:
        return
    _local.batch = batch
    stack = _stack()
    if stack:
        stack[-1].batch = batch


def set_step(step: int) -> None:
    """The global step of this thread's later root spans."""
    if _level:
        _local.step = step


def spans() -> list:
    """The finished spans, in the order they ended."""
    return list(_spans)


def clear() -> None:
    """Forget the finished spans and the anchors."""
    _spans.clear()
    _anchors.clear()


# ------------------------------------------------------------------ backward phases


class _Mark(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        _phase(ctx.name)
        return grad, None


def mark(x: torch.Tensor, name: str, level: int = 1) -> torch.Tensor:
    """``x``, with (tracing on at ``level`` or above, ``x`` in a graph) a
    node whose backward opens the phase ``name`` of the running
    ``backward``."""
    if _level < level or not x.requires_grad:
        return x
    return _Mark.apply(x, name)


def _phase(name: str) -> None:
    run = _backward
    if run is None:
        return
    now = clock()
    if run.phase is not None:
        run.phase.close(now)
    run.phase = Span(name, parent=run).open(now)


def backward(loss: torch.Tensor) -> None:
    """``loss.backward()``; tracing on, under a ``backward`` span split into
    ``backward.loss`` and the phases that ``mark`` put on the graph. One
    backward at a time in the process."""
    global _backward
    if not _level:
        loss.backward()
        return
    with span("backward") as run:
        _backward = run
        try:
            mark(loss, "backward.loss").backward()
        finally:
            _backward = None
            if run.phase is not None:
                run.phase.close()


# ------------------------------------------------------------------ the trace's clock


def anchor() -> None:
    """One anchor: a ``record_function`` whose end in the trace is matched
    with this clock (a no-op unless a profiler runs)."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return
    name = f"{ANCHOR}{next(_ids)}"
    with torch.autograd.profiler.record_function(name):
        inside = clock()
    _anchors.append((name, (inside + clock()) // 2))


def _offset_ns(trace: dict) -> float | None:
    """Trace ns (``ts``·1000 + ``baseTimeNanoseconds``) minus own ns: the
    median over the anchors the trace holds; None without one."""
    base = trace.get("baseTimeNanoseconds", 0)
    ends = {e["name"]: e["ts"] + e["dur"] for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("name", "").startswith(ANCHOR)}
    found = [ends[name] * 1e3 + base - own for name, own in _anchors if name in ends]
    return statistics.median(found) if found else None


def merge_into(trace: dict) -> int:
    """Writes the finished spans that fall inside ``trace`` (a parsed
    Chrome trace of ``torch.profiler``) into it as ``program_span`` events
    on its clock, with thread names for threads it lacks; the number
    written. Raises ValueError when the trace holds no anchor."""
    offset = _offset_ns(trace)
    if offset is None:
        raise ValueError("the trace holds no tracing anchor: was tracing on under the profiler?")
    events = trace["traceEvents"]
    base = trace.get("baseTimeNanoseconds", 0)
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    lo = min(e["ts"] for e in timed)
    hi = max(e["ts"] + e["dur"] for e in timed)
    pid = os.getpid()
    named = {e.get("tid") for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"}
    written, threads = 0, set()
    for s in spans():
        ts = (s.start + offset - base) / 1e3
        end = (s.end + offset - base) / 1e3
        if end < lo or ts > hi:
            continue
        batch = list(s.batch) if isinstance(s.batch, tuple) else s.batch
        args = {"span": s.id, "parent": s.parent_id, "batch": batch, "step": s.step}
        if s.args:
            args.update(s.args)
        events.append({"ph": "X", "cat": CATEGORY, "name": s.name, "pid": pid, "tid": s.thread,
                       "ts": ts, "dur": end - ts, "args": args})
        threads.add(s.thread)
        written += 1
    for tid in sorted(threads - named):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": _threads.get(tid, str(tid))}})
    return written
