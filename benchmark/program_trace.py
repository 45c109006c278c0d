"""Per-layer numbers from the program's own spans and counters
(`talkshow_torch.tracing`), for the readers in `metrics/` that name
``program_span`` or ``program_counter`` as their source.

The program records while a torch.profiler session is active, so in a
``--trace 1`` run these numbers cover the two profiled parts of the window
(`trace.WindowProfile`) and nothing of the warm-up or the check.  A value
"per request" or "per step" divides by the count of the cell's entry root:
``generate`` (entry `Pipeline.generate`), ``body_stage`` (entry
`get_mfcc` + `Pipeline.generate_body`, whose ``mfcc`` roots count in the
totals) or ``train_step``.  Each reader returns None where no entry root
was recorded: a run without ``--trace 1``, or a program without the
tracing module."""
from __future__ import annotations

#: the root spans of one request or step of each entry, the entry's first
ROOTS = {"generate": ("generate",), "body_stage": ("body_stage", "mfcc"),
         "train_step": ("train_step",)}


def _snapshot():
    try:
        from talkshow_torch import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def _per_root(entry: str, value):
    """value(snapshot, root names) over the count of `entry` roots, or None."""
    snap = _snapshot()
    if snap is None:
        return None
    n = snap["roots"].get(entry, {}).get("count", 0)
    if not n:
        return None
    return value(snap, ROOTS[entry]) / n


def _ns(snap, roots, keep) -> int:
    """Total ns of the spans under `roots` (their paths' first name) whose
    path `keep(path)` accepts."""
    return sum(a["total_ns"] for path, a in snap["spans"].items()
               if path.split("/", 1)[0] in roots and keep(path))


def _last(path: str) -> str:
    return path.rsplit("/", 1)[-1]


def host_syncs(entry: str):
    """``host_sync`` counts charged to the entry's roots, per entry root."""
    return _per_root(entry, lambda s, roots: sum(
        s["roots"].get(r, {}).get("counts", {}).get("host_sync", 0) for r in roots))


def host_ms(entry: str):
    """The host's own time, ms per entry root: the roots' time minus the
    ``device_wait`` spans under them (the reads and copies that wait for the
    card)."""
    return _per_root(entry, lambda s, roots: 1e-6 * (
        _ns(s, roots, lambda p: "/" not in p)
        - _ns(s, roots, lambda p: "/" in p and _last(p) == "device_wait")))


def audio_io_ms(entry: str):
    """``wav_read`` + ``resample``, every occurrence, ms per entry root."""
    return _per_root(entry, lambda s, roots: 1e-6 * _ns(
        s, roots, lambda p: _last(p) in ("wav_read", "resample")))


def optimizer_ms(entry: str):
    """The ``optimizer`` spans minus their ``device_wait`` children, ms per
    entry root: the optimizer's host time."""
    return _per_root(entry, lambda s, roots: 1e-6 * (
        _ns(s, roots, lambda p: _last(p) == "optimizer")
        - _ns(s, roots, lambda p: p.endswith("/optimizer/device_wait"))))
