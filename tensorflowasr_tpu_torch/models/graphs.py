"""Leaf model stages replayed as CUDA graphs, one a stage and input
signature.

A stage (the Conformer's stack, its CTC head, its translator) is a module
whose forward runs one body of many small kernels. On the card, in
inference, the host's enqueue of those kernels takes several times their
device time, so :class:`StageGraphs` runs the body as a captured
``torch.cuda.CUDAGraph`` wherever :func:`may_replay` allows it and the
input signature (the shapes, dtypes and device of the body's tensor
inputs) repeats:

- the first call of a signature runs the body eagerly;
- the second runs it eagerly too, as the capture's warm-up, then captures
  it on static copies of its inputs. A shape seen once (a server's odd file
  length) so costs no capture and holds no graph memory;
- every later call of that signature copies its inputs into the static
  ones, replays the graph and returns a clone of the static output, so no
  caller holds memory that the next replay overwrites. Copy-in, replay and
  clone happen under one lock a stage (a server calls a model from one
  thread a connection), on the caller's stream, after the stage's previous
  replay on whichever stream it ran;
- anything else (training, gradients, the CPU, ``torch.export`` and
  ``torch.compile``, a capture already in progress) runs the body eagerly,
  as it would without this module.

The stage's span (``utils/telemetry.py``) holds the eager body, or the
copy-in, replay and clone. An eager body's range in a profiler's trace is
the leaf ``tasr::<stage>``, credited with the device time of the kernels
its ops launch; a replay's is ``tasr.<stage>`` (``linked=False``): a trace
links all but a few of a replayed graph's kernels to the graph's launch
and to no op, and crediting the few (or the copies) would read as the
stage's device time.

Weights changed in place (an optimizer step, ``load_state_dict``) keep
their addresses, so a replay reads them. Going to training mode or moving
the module (``to``, ``cuda``, ``half``: anything through ``_apply``) drops
the stage's graphs and what it has seen. A stage keeps at most
``MAX_SIGNATURES`` graphs, which hold their memory until then; a further
signature runs eagerly. A stage's graphs share one memory pool. Cached
constants the body reads (``layers.tensor_cache``: position tables) are
kept alive with the graph that reads them.

Each call of a stage records the counter ``COUNTER`` (``telemetry.count``)
with 1 on a replay and 0 on an eager body, the warm-up included.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from tensorflowasr_tpu_torch.models.layers import collect_constants
from tensorflowasr_tpu_torch.utils import telemetry

MAX_SIGNATURES = 16     # graphs a stage keeps; a further signature is eager
MAX_SEEN = 1024         # signatures a stage remembers having run once
COUNTER = "conformer.graph"


def may_replay(module: nn.Module, x: torch.Tensor) -> bool:
    """Whether ``module``'s stage may run as a graph on its input ``x``: a
    CUDA input, no gradient recorded, the module in eval mode, nothing
    traced or compiled (``torch.export`` sets the same flag), and no
    capture in progress on the current stream."""
    return (x.is_cuda and not torch.is_grad_enabled()
            and not module.training
            and not torch.compiler.is_compiling()
            and not torch.cuda.is_current_stream_capturing())


def _span(name: str, linked: bool = True):
    return telemetry.span(name, leaf=True, shared=True, linked=linked)


class _Graph:
    """One signature's graph: its static inputs and output, and what it
    reads beyond its module's parameters and buffers."""

    __slots__ = ("graph", "inputs", "output", "held")

    def __init__(self, graph, inputs, output, held):
        self.graph = graph
        self.inputs = inputs
        self.output = output
        self.held = held

    def run(self, name: str, inputs: Sequence[torch.Tensor],
            done: torch.cuda.Event) -> torch.Tensor:
        """Copy-in, replay and clone inside the span ``name``, with its
        record of ``COUNTER``, on the current stream, after ``done`` (the
        stage's previous replay), which then marks this one."""
        with _span(name, linked=False):
            telemetry.count(COUNTER, 1, shared=True)
            torch.cuda.current_stream().wait_event(done)
            for static, x in zip(self.inputs, inputs):
                static.copy_(x)
            self.graph.replay()
            out = self.output.clone()
            done.record()
        return out


class StageGraphs:
    """One stage's graphs by input signature, the signatures it has run
    once, its lock, its memory pool and the event of its last replay.
    Copied or pickled, it starts empty."""

    def __init__(self):
        self.lock = threading.Lock()
        self.graphs: Dict[Tuple, _Graph] = {}
        self.seen: Dict[Tuple, None] = {}     # run once, oldest first
        self.pool = None
        self.done: Optional[torch.cuda.Event] = None

    def __reduce__(self):
        return StageGraphs, ()

    def clear(self) -> None:
        with self.lock:
            self.graphs.clear()
            self.seen.clear()
            self.pool = self.done = None

    def __call__(self, module: nn.Module, name: str, body: Callable,
                 inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        """``body(*inputs)`` of ``module``'s stage, inside the span
        ``name``: replayed, or eager (and then captured on a signature's
        second call)."""
        again = False
        if may_replay(module, inputs[0]):
            key = tuple((t.shape, t.dtype, t.device) for t in inputs)
            with self.lock:
                graph = self.graphs.get(key)
                if graph is not None:
                    return graph.run(name, inputs, self.done)
                again = self._again(key)
        with _span(name):
            telemetry.count(COUNTER, 0, shared=True)
            out = body(*inputs)
        if again:
            with self.lock:
                if key not in self.graphs and \
                        len(self.graphs) < MAX_SIGNATURES:
                    self.graphs[key] = self._capture(body, inputs)
        return out

    def _again(self, key: Tuple) -> bool:
        """Whether ``key``'s call is its second, to be captured; a first
        call is remembered (the oldest forgotten beyond ``MAX_SEEN``)."""
        if len(self.graphs) >= MAX_SIGNATURES:
            return False
        if key in self.seen:
            del self.seen[key]
            return True
        if len(self.seen) >= MAX_SEEN:
            del self.seen[next(iter(self.seen))]
        self.seen[key] = None
        return False

    def _capture(self, body: Callable, inputs: Sequence[torch.Tensor]
                 ) -> _Graph:
        # ordinary tensors even under inference mode, so that a replay
        # under plain no_grad may copy into them
        with torch.inference_mode(False):
            static = [t.clone() for t in inputs]
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.done = torch.cuda.Event()
        graph = torch.cuda.CUDAGraph()
        with collect_constants() as held, torch.cuda.graph(
                graph, pool=self.pool, capture_error_mode="thread_local"):
            output = body(*static)
        return _Graph(graph, static, output, held)


class GraphedStage(nn.Module):
    """A module with one stage that :class:`StageGraphs` runs
    (``self.stage_graphs(self, span_name, body, inputs)``); training mode
    and moves drop its graphs."""

    def __init__(self):
        super().__init__()
        self.stage_graphs = StageGraphs()

    def train(self, mode: bool = True):
        if mode:
            self.stage_graphs.clear()
        return super().train(mode)

    def _apply(self, fn, recurse=True):
        self.stage_graphs.clear()
        return super()._apply(fn, recurse)
