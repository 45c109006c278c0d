"""A train step's device work replayed from a captured CUDA graph
(`torch.cuda.CUDAGraph`): the host launches one graph a step in place of
each of the step's kernels.

`StepGraph` keeps one graph of one train state, under a signature the
step computes: what the captured kernels hold as constants (the inputs'
shapes and dtypes, the hyper-parameters, the addresses of the tensors
written in place).  Following PyTorch's whole-network recipe:

- a call with a signature other than the graph's drops the graph and runs
  the work eagerly on the graph's side stream (the warm-up: it makes the
  optimizer's moments, loads the kernels and the libraries' handles for
  that stream);
- the next call with that signature copies its inputs into static
  tensors, captures the work on that stream into a graph with a memory
  pool of its own, the gradients set to None first so that backward makes
  them in the pool, and replays it;
- every later call with it copies its inputs into the static tensors
  (device to device, on the current stream) and replays.

The parameters' ``.grad`` are the gradients of the step that ran last,
eager or replayed.  `clear()` drops the graph (a load that replaces the
state's tensors).  ``counts["train_graph_capture"]`` counts the captures,
``counts["train_graph_replay"]`` the replays of the calls that captured
nothing (`talkshow_torch.tracing`).  The kernel counters keep counting
launches on the card: a replay adds again what its capture added (one
``adam_apply`` a step, replayed or not).

`replayable` says where capture holds: on a CUDA device, with no mesh
(whose collectives a graph of one process does not hold), and with no
hook on the modules or their parameters (a replay runs a hook's device
work as captured and none of its Python, so a step with a hook runs
eagerly)."""
from __future__ import annotations

import torch

from talkshow_torch.tracing import counts


_GLOBAL_HOOKS = ("_global_forward_pre_hooks", "_global_forward_hooks",
                 "_global_backward_pre_hooks", "_global_backward_hooks")


def _hooked(modules) -> bool:
    if any(getattr(torch.nn.modules.module, name, None) for name in _GLOBAL_HOOKS):
        return True
    for m in modules:
        if any(mod._forward_pre_hooks or mod._forward_hooks or mod._backward_pre_hooks
               or mod._backward_hooks for mod in m.modules()):
            return True
        if any(p._backward_hooks or p._post_accumulate_grad_hooks for p in m.parameters()):
            return True
    return False


def replayable(device, mesh, modules=()) -> bool:
    """Whether a step's work on `modules` may be captured (see the module
    doc)."""
    return torch.device(device).type == "cuda" and mesh is None and not _hooked(modules)


class StepGraph:
    """The captured graph of one train state (see the module doc)."""

    def __init__(self):
        self._key = None           # the signature of the graph, or of the last warm-up
        self._graph = None
        self._stream = None

    def clear(self) -> None:
        self._key = self._graph = None

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def run(self, signature, inputs: tuple, work, params: list) -> tuple:
        """work(*inputs) -> a tuple of tensors, eagerly, or from the graph;
        returns that tuple, each tensor new (a replay's are copied out of
        the graph's outputs).  `signature()` is the key of the graph; it is
        taken again after a warm-up, which may have made tensors it names."""
        key = signature()
        if key != self._key:
            self.clear()
            out = self._warm_up(work, inputs)
            self._key = signature()
            return out
        if self._graph is None:
            self._capture(inputs, work, params)
            counts["train_graph_capture"] += 1
        else:
            for static, x in zip(self._inputs, inputs):
                static.copy_(x)
            for name, n in self._launched.items():
                counts[name] += n
            counts["train_graph_replay"] += 1
        for p, g in zip(params, self._grads):
            p.grad = g
        self._graph.replay()
        return tuple(t.clone() for t in self._outputs)

    def _side(self, device) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def _warm_up(self, work, inputs: tuple) -> tuple:
        current = torch.cuda.current_stream(inputs[0].device)
        side = self._side(inputs[0].device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = work(*inputs)
        current.wait_stream(side)
        return out

    def _capture(self, inputs: tuple, work, params: list) -> None:
        self._inputs = tuple(x.clone(memory_format=torch.contiguous_format) for x in inputs)
        for p in params:
            p.grad = None
        before = dict(counts)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._side(inputs[0].device)):
            self._outputs = work(*self._inputs)
        self._launched = {k: n - before.get(k, 0) for k, n in counts.items()
                          if n != before.get(k, 0)}
        self._grads = [p.grad for p in params]
        self._graph = graph
