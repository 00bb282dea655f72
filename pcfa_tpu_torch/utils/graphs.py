"""CUDA-graph replay of a flow network's forward and backward, for a network
whose spec declares `capturable` (`runtime.make_flow_fn` on the card).

`GraphedNetwork(module, dtype, name)(x1, x2)` gives the flow of
`module(x1.to(dtype), x2.to(dtype))`, from captured graphs, as
`torch.cuda.make_graphed_callables` does: the inputs are cast into static
buffers and one graph replays the forward; where the call records a
gradient, the backward copies the cotangent into a static buffer and
replays a second graph, `torch.autograd.grad` from the flow to the inputs
that need a gradient (the cotangent handed in by `_Cotangent`). The flow
is the forward's output, or the last element of the tuple it returns
(RAFT's (flow_lr, flow_up)): the graph computes the whole tuple, and only
the flow is kept, returned and differentiated. A call that records none
replays a forward-only graph. The graphs are keyed by the inputs' shapes
and dtypes and by which inputs need a gradient; the graphs of one input
signature (shapes and dtypes) share a memory pool, and `MAX_SIGNATURES`
signatures are kept: a new one drops the least recently used, which is
captured again if it returns.

A module with a method `graph_capturable(shape1, shape2, dtype)` says,
once per input signature, whether its forward and backward can be
captured on inputs of those shapes cast to `dtype` (RAFT: not under
remat, split over ranks or off the materialized correlation path); a
signature it refuses runs the module eagerly at every call, and counts no
capture and no replay. That is decided before any capture, from what the
module observes, and is no fallback.

A key's first call warms the module up eagerly on a side stream (the
small conv's packed weights, the kernels' plans, cuDNN's choices fill
there), then captures, then replays. A failed capture raises, naming the
forward's failing torch operator (of a backward, only the graph: autograd
runs its operators on a thread of its own); nothing falls back to eager.
A replay runs none of the module's Python, so it advances the host
counters (`utils/profiling.count`) and the `.launches` of the kernel
wrappers `profiling.launch_counted` marked by exactly what its capture
recorded, and the capture, which runs no kernel, takes back what it
counted. The module's own spans open only while a capture runs.
A graph replays the addresses its capture saw: the module owns its
parameters, the graphs' pool what the capture allocated, and an op whose
kernel reads a tensor that the op's own cache owns (the small conv's
packed weights) passes it to `hold`, which the capture keeps with its
graphs.
Counted here: `flow.graph_captures` (keys captured; a closure's forward
and backward graphs are one) and `flow.graph_replays` (calls answered by
a replay).

The output and the input gradients are fresh tensors, never a graph's
static buffers. A backward must follow its own forward before the next
replay of the same signature, whose forward overwrites the activations
the backward reads; otherwise it raises.
"""

from __future__ import annotations

import collections
import contextlib

import torch
from torch.autograd.function import once_differentiable
from torch.overrides import TorchFunctionMode

from pcfa_tpu_torch.utils import profiling

#: input signatures whose graphs one `GraphedNetwork` keeps (a batch and
#: the CLIs' short last batch)
MAX_SIGNATURES = 2

#: while a capture runs, the list `hold` appends to
_holding: list | None = None


def hold(t: torch.Tensor) -> None:
    """Keeps `t` alive as long as the graphs being captured, if a capture
    runs: for a tensor a kernel reads that the op's own cache, not the
    caller, owns (a replay reads its address, after any eviction)."""
    if _holding is not None:
        _holding.append(t)


def _tally() -> dict:
    """The host counters, by name, and the kernel wrappers' launches, by
    wrapper."""
    out: dict = profiling.counters()
    for fn in profiling.launch_counted_wrappers():
        out[fn] = fn.launches
    return out


def _advance(delta: tuple, sign: int = 1) -> None:
    """Add `sign` × each (counter, n) of `delta` to its counter."""
    for counter, n in delta:
        if isinstance(counter, str):
            profiling.count(counter, sign * n)
        else:
            counter.launches += sign * n


class _LastOp(TorchFunctionMode):
    """Keeps the name of the first torch operator that raised under it,
    else of the last one called, on this thread only (a function mode: a
    dispatch mode would import the compiler stack, seconds of set-up)."""

    op, failed = "no operator", False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if not self.failed:
            self.op = getattr(func, "__qualname__", str(func))
        try:
            return func(*args, **(kwargs or {}))
        except Exception:
            self.failed = True
            raise


class _Cotangent(torch.autograd.Function):
    """A scalar whose backward hands `g` to `out`: `autograd.grad` from it
    is `autograd.grad(out, inputs, g)` without the check of a given
    cotangent's shape, whose first call imports sympy (seconds of set-up)."""

    @staticmethod
    def forward(ctx, out, g):
        ctx.g = g
        return out.new_empty(())

    @staticmethod
    def backward(ctx, _):
        return ctx.g, None


class _Key:
    """The graphs of one signature and one pattern of needed gradients."""

    def __init__(self, needs: tuple[bool, bool]):
        self.needs = needs
        self.fwd = self.bwd = None
        self.inputs = self.out = self.grad_out = self.grads = None
        self.fwd_counts = self.bwd_counts = ()
        #: what the graphs read that others own (`hold`)
        self.held: list = []


class _Signature:
    """The keys of one input signature, their shared memory pool, and the
    number of forward replays so far (a backward checks it); `captured`
    False: the module refused the signature, which runs eagerly."""

    def __init__(self, captured: bool):
        self.captured = captured
        self.pool = torch.cuda.graph_pool_handle() if captured else None
        self.keys: dict = {}
        self.forwards = 0


def _flow(out):
    """The flow of a forward's output: the output, or a tuple's last
    element."""
    return out[-1] if isinstance(out, tuple) else out


class _Replay(torch.autograd.Function):
    """A closure's forward and backward graphs under autograd."""

    @staticmethod
    def forward(ctx, sig, key, x1, x2):
        _replay_forward(sig, key, x1, x2)
        ctx.sig, ctx.key, ctx.forwards = sig, key, sig.forwards
        ctx.dtypes = (x1.dtype, x2.dtype)
        return key.out.detach()

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        sig, key = ctx.sig, ctx.key
        if sig.forwards != ctx.forwards:
            raise RuntimeError(
                "graphed network: another forward of the same input "
                "signature replayed between this call's forward and its "
                "backward and overwrote the activations the backward reads")
        key.grad_out.copy_(g)
        key.bwd.replay()
        _advance(key.bwd_counts)
        grads = iter(key.grads)
        return (None, None, *(next(grads).to(dt, copy=True) if need else None
                              for need, dt in zip(key.needs, ctx.dtypes)))


def _replay_forward(sig: _Signature, key: _Key, x1, x2) -> None:
    with torch.no_grad():
        key.inputs[0].copy_(x1)
        key.inputs[1].copy_(x2)
    key.fwd.replay()
    _advance(key.fwd_counts)
    sig.forwards += 1
    profiling.count("flow.graph_replays")


class GraphedNetwork:
    """`module`'s forward and backward replayed from CUDA graphs, on
    inputs cast to `dtype` (None: the inputs' own); `name` names the
    network in errors."""

    def __init__(self, module: torch.nn.Module, dtype: torch.dtype | None,
                 name: str):
        self.module, self.dtype, self.name = module, dtype, name
        self.signatures: collections.OrderedDict = collections.OrderedDict()
        #: the stream the warm-ups and captures run on
        self.stream = None

    def __call__(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        grad = torch.is_grad_enabled()
        needs = (grad and x1.requires_grad, grad and x2.requires_grad)
        sig = self._signature(x1, x2)
        if not sig.captured:
            if self.dtype is not None:
                x1, x2 = x1.to(self.dtype), x2.to(self.dtype)
            return _flow(self.module(x1, x2))
        key = sig.keys.get(needs)
        if key is None:
            key = sig.keys[needs] = self._capture(sig, needs, x1, x2)
        if any(needs):
            return _Replay.apply(sig, key, x1, x2).clone()
        _replay_forward(sig, key, x1, x2)
        return key.out.clone()

    def _signature(self, x1, x2) -> _Signature:
        s = (tuple(x1.shape), tuple(x2.shape), x1.dtype, x2.dtype, x1.device)
        sig = self.signatures.get(s)
        if sig is not None:
            self.signatures.move_to_end(s)
            return sig
        if len(self.signatures) >= MAX_SIGNATURES:
            self.signatures.popitem(last=False)
        ask = getattr(self.module, "graph_capturable", None)
        sig = self.signatures[s] = _Signature(
            ask is None or ask(s[0], s[1], self.dtype or x1.dtype))
        return sig

    def _capture(self, sig: _Signature, needs, x1, x2) -> _Key:
        key, grad, dev = _Key(needs), any(needs), x1.device
        key.inputs = tuple(
            torch.empty(x.shape, dtype=self.dtype or x.dtype, device=dev)
            for x in (x1, x2))
        with torch.no_grad():
            for s, x in zip(key.inputs, (x1, x2)):
                s.copy_(x)
        for s, need in zip(key.inputs, needs):
            s.requires_grad_(need)
        wrt = [s for s, need in zip(key.inputs, needs) if need]

        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream), torch.set_grad_enabled(grad):
            out = _flow(self.module(*key.inputs))
            if grad:
                torch.autograd.grad(
                    _Cotangent.apply(out, torch.ones_like(out)), wrt)
            del out
        torch.cuda.current_stream(dev).wait_stream(self.stream)

        key.fwd = torch.cuda.CUDAGraph()
        with self._capturing(key, key.fwd, sig.pool, "forward") as counts, \
                torch.set_grad_enabled(grad):
            key.out = _flow(self.module(*key.inputs))
        key.fwd_counts = tuple(counts)
        if grad:
            key.grad_out = torch.empty_like(key.out)
            key.bwd = torch.cuda.CUDAGraph()
            with self._capturing(key, key.bwd, sig.pool,
                                 "backward") as counts:
                key.grads = torch.autograd.grad(
                    _Cotangent.apply(key.out, key.grad_out), wrt)
            key.bwd_counts = tuple(counts)
            key.out = key.out.detach()
        profiling.count("flow.graph_captures")
        return key

    @contextlib.contextmanager
    def _capturing(self, key: _Key, graph, pool, what: str):
        """Captures the block into `graph` on the side stream, as
        `torch.cuda.graph` does less its garbage collection, keeping on
        `key` what the block `hold`s: yields a list that receives the
        (counter, n) the capture counted, which are taken back. A failure
        raises, naming for the forward the first torch operator that
        raised, else the last one called; a backward's operators run on
        autograd's thread, which the mode does not see."""
        global _holding
        before, counts, last = _tally(), [], _LastOp()
        torch.cuda.synchronize(self.stream.device)
        # the pool can take what the eager cache held
        torch.cuda.empty_cache()
        try:
            _holding = key.held
            with torch.cuda.stream(self.stream), last:
                graph.capture_begin(pool)
                try:
                    yield counts
                finally:
                    graph.capture_end()
        except RuntimeError as e:
            at = f" at {last.op}" if what == "forward" else ""
            raise RuntimeError(f"{self.name}: capturing the {what} CUDA graph "
                               f"failed{at}: {e}") from e
        finally:
            _holding = None
        after = _tally()
        counts.extend((k, v - before.get(k, 0)) for k, v in after.items()
                      if v != before.get(k, 0))
        _advance(tuple(counts), -1)
