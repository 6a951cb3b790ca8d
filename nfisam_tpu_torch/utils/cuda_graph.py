"""Replaying a tensor function from a CUDA graph.

The samplers call one function (a batch of ``loglike(ptform(u))``, or a
log density and its gradient) tens of thousands of times at a fixed
shape; eagerly, each call issues hundreds of small kernels and the host's
time to issue them is the cost.  ``CudaGraphed`` captures the function
once per input shape and replays it: the same kernels in the same order,
so the same numbers.  CPU tensors, and a function that launches the
port's own AR-inverse kernel (whose launches are counted where it is
called), run eagerly.
"""
from __future__ import annotations

import warnings
from collections import Counter
from typing import Callable, Dict, Tuple

import torch

# calls of one shape before it is captured: the first ones fill the
# factors' device constants and show whether the function is capturable
CAPTURE_AFTER = 2


class CudaGraphed:
    """``fn(*tensors) -> tensor or tuple of tensors``, replayed from a CUDA
    graph per input shape once that shape has been called
    ``CAPTURE_AFTER`` times.  Outputs are fresh tensors."""

    def __init__(self, fn: Callable) -> None:
        self.fn = fn
        self._seen: Counter = Counter()
        self._graphs: Dict[Tuple, object] = {}

    def __call__(self, *args):
        if not args[0].is_cuda:
            return self.fn(*args)
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        entry = self._graphs.get(key)
        if entry is None:
            self._seen[key] += 1
            if self._seen[key] <= CAPTURE_AFTER:
                return self._eager(key, args)
            entry = self._graphs[key] = self._capture(args)
        if entry is False:
            return self.fn(*args)
        graph, static_in, static_out = entry
        for s, a in zip(static_in, args):
            s.copy_(a)
        graph.replay()
        if isinstance(static_out, tuple):
            return tuple(o.clone() for o in static_out)
        return static_out.clone()

    def _eager(self, key, args):
        from ..flows.ar_inverse import ar_inverse_kernel

        before = ar_inverse_kernel.launches
        out = self.fn(*args)
        if ar_inverse_kernel.launches != before:
            self._graphs[key] = False
        return out

    def _capture(self, args):
        static_in = [a.detach().clone() for a in args]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        try:
            with torch.cuda.stream(side):
                self.fn(*static_in)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                static_out = self.fn(*static_in)
        except RuntimeError as e:
            torch.cuda.synchronize()
            warnings.warn(f"CUDA graph capture failed, running eagerly: "
                          f"{e}")
            return False
        return graph, static_in, static_out
