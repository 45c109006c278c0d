"""The traced run's instruments, all from the benchmark's own files.

`Spans` wraps calls into the program's layers, attributes of a module or
of an instance, for the traced run only: each call is timed by a pair of
CUDA events (the device's clock, so an asynchronous call counts the work it
queued) and named in the profiler's trace by `record_function`.

`Profile` runs `torch.profiler` over a steady part of the window and
reduces its trace: device busy time as the union of the intervals of every
kernel, copy and fill (overlaps counted once), kernel time by name,
launches, and the idle gaps by what the host was doing.  `WindowProfile`
holds the traced run's two profiled parts."""
from __future__ import annotations

import bisect
import functools
import json
import os
import time
from collections import defaultdict

import torch


class Spans:
    """Per-request span times: `begin_request()` opens a request's record,
    `end_request()` returns {span: ms} of it; `notes` holds what `note`
    functions took from this request's calls (shapes a reader needs)."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda           # False (CPU tests): the host clock times the spans
        self._patched: list = []
        self._open: list = []      # (name, start, end) of this request
        self.notes: list[dict] = []

    def wrap(self, owner, attr: str, name: str, note=None) -> None:
        """Time `owner.attr` as span `name`; `note(args, kwargs)` -> dict is
        kept per call when given."""
        fn = getattr(owner, attr)
        spans = self

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with torch.profiler.record_function(f"span:{name}"):
                if spans.cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = fn(*args, **kwargs)
                    end.record()
                else:
                    start = time.perf_counter()
                    out = fn(*args, **kwargs)
                    end = time.perf_counter()
            spans._open.append((name, start, end))
            if note is not None:
                spans.notes.append(note(args, kwargs))
            return out

        had = attr in vars(owner) if not isinstance(owner, type) else attr in owner.__dict__
        self._patched.append((owner, attr, fn if had else None))
        setattr(owner, attr, timed)

    def begin_request(self) -> None:
        self._open = []
        self.notes = []

    def end_request(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
        rec: dict = defaultdict(float)
        for name, s, e in self._open:
            rec[name] += s.elapsed_time(e) if self.cuda else (e - s) * 1e3
        self._open = []
        return dict(rec)

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._patched):
            if fn is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)
        self._patched = []


#: trace categories that occupy the device
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Profile:
    """torch.profiler over part of the window: `start()`, `stop()`,
    `export()`, then `reduce(path)` reads the exported trace.  `host`: record the host's
    operations too (CPU activity), which costs each operation some
    microseconds of host time."""

    def __init__(self, cuda: bool = True, host: bool = True):
        acts = []
        if host or not cuda:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.cuda = cuda
        self.prof = torch.profiler.profile(activities=acts)
        self.window_s = 0.0
        self.on = False
        self._t0 = 0.0

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        self._sync()
        self.prof.start()
        self.on = True
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()
        self.on = False

    def export(self, directory: str, name: str) -> str:
        """Write the trace of the session just stopped; returns its path."""
        path = os.path.join(directory, f"trace-{name}.json")
        self.prof.export_chrome_trace(path)
        return path

    @staticmethod
    def reduce(path: str) -> dict:
        """{busy_s, kernels: {name: s}, launches, idle_by_host: {label: s}} of
        the trace at `path` (removed once read)."""
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return reduce_events(events)


class WindowProfile:
    """The traced run's two profiled parts of a window of `seconds`: the
    device part (from a quarter of the way in, up to 3 s; device activity
    only, so the host runs at its untraced pace) gives the busy time, the
    kernels and the launches; the host part (from 60 % of the way in, up to
    2 s; host operations recorded too) gives the idle time by what the host
    was doing.  `tick(elapsed)` between requests or steps starts and stops
    them and says whether the device part is on.  Each part's trace is
    written when it stops (a later session clears the profiler's buffers);
    `paused_s` is the time that took, which the window does not count."""

    def __init__(self, seconds: float, cuda: bool, directory: str):
        self.parts = [(0.25 * seconds, min(3.0, 0.25 * seconds), Profile(cuda, host=False)),
                      (0.6 * seconds, min(2.0, 0.2 * seconds), Profile(cuda, host=True))]
        self.paths: list = [None, None]
        self.directory = directory
        self.paused_s = 0.0

    def _stop(self, i: int) -> None:
        t = time.perf_counter()
        prof = self.parts[i][2]
        prof.stop()
        self.paths[i] = prof.export(self.directory, str(i))
        self.paused_s += time.perf_counter() - t

    def tick(self, elapsed: float) -> bool:
        for i, (start, length, prof) in enumerate(self.parts):
            if prof.on and elapsed >= start + length:
                self._stop(i)
            elif not prof.on and self.paths[i] is None and elapsed >= start:
                prof.start()
        return self.parts[0][2].on

    def finish(self) -> dict | None:
        """{window_s, busy_s, kernels, launches} of the device part and
        idle_by_host of the host part; None when the device part never ran."""
        for i, (_, _, prof) in enumerate(self.parts):
            if prof.on:
                self._stop(i)
        if self.paths[0] is None:
            return None
        out = Profile.reduce(self.paths[0])
        out["window_s"] = self.parts[0][2].window_s
        out["idle_by_host"] = ({} if self.paths[1] is None
                               else Profile.reduce(self.paths[1])["idle_by_host"])
        return out


def reduce_events(events: list) -> dict:
    """The reduction of `Profile.reduce` on a list of chrome-trace events."""
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                 if e.get("cat") in _DEVICE_CATS and e.get("ph") == "X")
    kernels: dict = defaultdict(float)
    for s, e, name in dev:
        kernels[name] += (e - s) * 1e-6
    launches = sum(1 for e in events if e.get("cat") == "kernel" and e.get("ph") == "X")
    # union of device intervals and the gaps between them
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                  if e.get("cat") in ("user_annotation", "cpu_op") and e.get("ph") == "X")
    label = _HostLabels(host)
    idle: dict = defaultdict(float)
    for gs, ge in gaps:
        idle[label((gs + ge) / 2)] += (ge - gs) * 1e-6
    return {"busy_s": busy * 1e-6, "kernels": dict(kernels), "launches": launches,
            "idle_by_host": dict(idle), "device_sum_s": sum(kernels.values())}


class _HostLabels:
    """What the host was in at a time t (µs): the innermost span and the
    innermost operation that contain t, e.g. "span:body_stage/aten::conv1d";
    "outside any span or operation" when none.  Operations are looked for
    among the 32 that started last before t (they nest shallowly)."""

    def __init__(self, host: list):
        self.spans = [h for h in host if h[2].startswith("span:")]
        self.ops = [h for h in host if not h[2].startswith("span:")]
        self.span_starts = [h[0] for h in self.spans]
        self.op_starts = [h[0] for h in self.ops]

    @staticmethod
    def _inner(items, starts, t, lookback):
        i = bisect.bisect_right(starts, t) - 1
        best = None
        for j in range(i, max(-1, i - lookback), -1):
            s, e, name = items[j]
            if e >= t and (best is None or e - s < best[0]):
                best = (e - s, name)
        return None if best is None else best[1]

    def __call__(self, t: float) -> str:
        span = self._inner(self.spans, self.span_starts, t, 8)
        op = self._inner(self.ops, self.op_starts, t, 32)
        parts = [p for p in (span, op) if p]
        return "/".join(parts) if parts else "outside any span or operation"
