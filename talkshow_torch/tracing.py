"""The program's own spans and counters: where the host's time goes in a
request or a training step, how often the host waits for the card, and
how many times each kernel ran.

- `span(name, **attrs)`: a context manager around one phase of a request
  or a step.  Spans nest; the outermost open span of a thread is a root,
  and every span under it carries the root's id.
- `counts`: the one counter of the program.  Kernel wrappers add their
  launches (``counts["ar_decode"]``; `talkshow_torch.kernels.counts` is
  this object), `to_host` and `to_device` add ``counts["host_sync"]``.
  Counters always count; while a root is open, each increment is also
  charged to that root, so a reader can take counts per request or step.
- `to_host(t)`: the program's one way to read a tensor on its traced
  paths (``.cpu().numpy()``; ``float(to_host(t))`` and
  ``bool(to_host(t))`` in place of ``float(t)``, ``bool(t)``,
  ``t.item()``).  `to_device(x, device)`: its one way to copy host data to
  the card there.  On the card both block the host until the card has
  finished the work queued before them (a copy from pageable host memory
  synchronises the stream), so each counts one ``host_sync`` and, while
  recording, is a ``device_wait`` span.  A read counts on any device, so
  the CPU path counts the reads the card's path makes; a copy to the CPU
  is no copy and counts nothing.

Recording is on while a `torch.profiler` session is active, or between
`enable()` and `disable()`.  Off, `span` costs one flag check and returns
a shared object that does nothing.  On, a span opens
``torch.profiler.record_function("span:<name>")`` when the profiler is
active, so it sits in the profiler's trace beside the kernels, and it is
kept in memory: its name, start and end (`time.perf_counter_ns`), its
parent, its root's id and its attributes.  Memory is bounded: aggregates
per span path (count, total ns, self ns, which is total minus the time of
the child spans), the counts charged to the roots of each name, and the
last `RECENT` roots whole.  `snapshot()` returns them; `reset()` clears
them (the counts stay; ``counts.clear()`` clears those).

A Chrome trace of a block, the program's spans included:
`talkshow_torch.utils.trace(log_dir)`.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import Counter, deque

import numpy as np
import torch

#: roots kept whole, with the spans under them, in `snapshot()["recent"]`
RECENT = 32
#: spans kept per root there; more are only aggregated
SPANS_PER_ROOT = 256

_profiler_on = torch.autograd._profiler_enabled
_forced = False
_local = threading.local()
_lock = threading.Lock()
_ids = itertools.count(1)


def enable() -> None:
    """Record spans whether or not a profiler session is active."""
    global _forced
    _forced = True


def disable() -> None:
    """Record spans only while a profiler session is active (the default)."""
    global _forced
    _forced = False


def recording() -> bool:
    """Whether spans record now: a profiler session is active, or `enable()`
    was called."""
    return _forced or _profiler_on()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Counts(Counter):
    """A Counter whose increments are also charged to this thread's open
    root span."""

    def __setitem__(self, key, value):
        stack = getattr(_local, "stack", None)
        if stack:
            stack[0].counts[key] += value - self.get(key, 0)
        super().__setitem__(key, value)


counts: Counter = _Counts()


class _Off:
    """The span while recording is off: shared, does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class Span:
    """One recorded span; `set(**attrs)` adds attributes known only inside it."""
    __slots__ = ("name", "attrs", "id", "parent", "root", "path", "start", "end",
                 "child_ns", "children", "counts", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = parent
        self.child_ns = 0
        if parent is None:
            self.root, self.path = self, self.name
            self.children, self.counts = [], Counter()
        else:
            self.root, self.path = parent.root, f"{parent.path}/{self.name}"
        self._rf = None
        if _profiler_on():
            self._rf = torch.profiler.record_function(f"span:{self.name}")
            self._rf.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        _stack().pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _recorder.close(self)
        return False

    def record(self) -> dict:
        return {"id": self.id, "parent": None if self.parent is None else self.parent.id,
                "root": self.root.id, "name": self.name, "start_ns": self.start,
                "end_ns": self.end, "attrs": self.attrs}


def span(name: str, **attrs):
    """A span named `name` with attributes `attrs` (cheap values: sizes,
    flags), or the shared no-op while recording is off."""
    if not (_forced or _profiler_on()):
        return _OFF
    return Span(name, attrs)


class _Recorder:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.paths: dict = {}       # path -> [count, total_ns, self_ns]
        self.roots: dict = {}       # root name -> [count, Counter charged]
        self.recent: deque = deque(maxlen=RECENT)

    def close(self, sp: Span) -> None:
        total = sp.end - sp.start
        with _lock:
            if sp.parent is not None:
                sp.parent.child_ns += total
            agg = self.paths.get(sp.path)
            if agg is None:
                agg = self.paths[sp.path] = [0, 0, 0]
            agg[0] += 1
            agg[1] += total
            agg[2] += total - sp.child_ns
            if sp.parent is None:
                root = self.roots.get(sp.name)
                if root is None:
                    root = self.roots[sp.name] = [0, Counter()]
                root[0] += 1
                root[1].update(sp.counts)
                self.recent.append({**sp.record(), "counts": dict(sp.counts),
                                    "spans": sp.children})
            elif len(sp.root.children) < SPANS_PER_ROOT:
                sp.root.children.append(sp.record())

    def snapshot(self) -> dict:
        with _lock:
            return {"spans": {p: {"count": c, "total_ns": t, "self_ns": s}
                              for p, (c, t, s) in self.paths.items()},
                    "roots": {n: {"count": c, "counts": dict(k)}
                              for n, (c, k) in self.roots.items()},
                    "recent": list(self.recent),
                    "counts": dict(counts)}


_recorder = _Recorder()


def snapshot() -> dict:
    """What was recorded since the last `reset()`:

    - ``spans``: {path: {count, total_ns, self_ns}}, a path being the
      names from the root down joined by "/" ("generate/body_stage");
    - ``roots``: {root name: {count, counts: the counts charged to them}};
    - ``recent``: the last `RECENT` roots, each {id, parent (None), root,
      name, start_ns, end_ns, attrs, counts, spans: the records of up to
      `SPANS_PER_ROOT` spans under it, in the order they closed};
    - ``counts``: `counts` as it stands."""
    return _recorder.snapshot()


def reset() -> None:
    """Forget the recorded spans and charged counts."""
    _recorder.reset()


def to_host(t: torch.Tensor) -> np.ndarray:
    """`t` as a numpy array on the host (see the module docstring)."""
    counts["host_sync"] += 1
    if not recording():
        return t.detach().cpu().numpy()
    with Span("device_wait", {"bytes": t.numel() * t.element_size()}):
        return t.detach().cpu().numpy()


def to_device(x, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)`` for host data `x`
    (a numpy array or a CPU tensor); see the module docstring."""
    device = torch.device(device)
    if device.type == "cpu" or (torch.is_tensor(x) and x.device.type != "cpu"):
        return torch.as_tensor(x, dtype=dtype, device=device)
    counts["host_sync"] += 1
    if not recording():
        return torch.as_tensor(x, dtype=dtype, device=device)
    nbytes = x.numel() * x.element_size() if torch.is_tensor(x) else np.asarray(x).nbytes
    with Span("device_wait", {"bytes": int(nbytes)}):
        return torch.as_tensor(x, dtype=dtype, device=device)
