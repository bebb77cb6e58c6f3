"""CUDA graphs of the port's device cores.

A core whose launches depend only on its planes' shapes and the switches
in force runs eagerly once a key (on a side stream, which fills every
constant cache it reads) and is then captured over static copies of its
planes; every later call with that key copies its planes in, replays the
graph on the current stream and gets copies of the outputs.  A replay is
one launch where the eager core is hundreds of PyTorch ops, each paid for
in host dispatch.
"""

from __future__ import annotations

import torch

from ..ops.cuda import kernels as K


class Cache:
    """The graphs of one core, by key, and how its calls on the GPU ran:
    "captured" calls captured a graph (answered by the eager run before
    the capture), "replayed" calls replayed one, "eager" calls had no key
    and ran the body as it is (the caller counts those)."""

    def __init__(self):
        self.counts = {"captured": 0, "replayed": 0, "eager": 0}
        self.graphs: dict = {}

    def run(self, key, body, planes):
        """body(*planes), a tuple of tensors, through the graph of `key`
        (its first element the device): the first call with a key answers
        from an eager run on a side stream, then captures."""
        with torch.cuda.device(key[0]):
            graph = self.graphs.get(key)
            if graph is not None:
                self.counts["replayed"] += 1
                return graph.replay(planes)
            out = _side_stream(body, planes)
            self.graphs[key] = Captured(body, planes)
            self.counts["captured"] += 1
            return out


def _side_stream(body, planes):
    """body(*planes) on a side stream, ordered after the current stream's
    work and before its later work."""
    current = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = body(*planes)
    current.wait_stream(side)
    for t in out:
        t.record_stream(current)
    return out


class Captured:
    """body(*planes) captured over static copies of `planes` (a None plane
    stays None), with the kernel launches and launch shapes that one
    replay runs: the capture's own counts are taken back out of
    `K.LAUNCHES` and `K.SHAPES`, since it runs nothing, and each replay
    adds them."""

    def __init__(self, body, planes):
        self.planes = [None if t is None else torch.empty_like(t)
                       for t in planes]
        launches, shapes = dict(K.LAUNCHES), dict(K.SHAPES)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                self.out = body(*self.planes)
            self.launches = {k: n - launches[k]
                             for k, n in K.LAUNCHES.items()
                             if n != launches[k]}
            self.shapes = {k: n - shapes.get(k, 0)
                           for k, n in K.SHAPES.items()
                           if n != shapes.get(k, 0)}
        finally:
            K.LAUNCHES.update(launches)
            K.SHAPES.clear()
            K.SHAPES.update(shapes)

    def replay(self, planes):
        for static, t in zip(self.planes, planes):
            if static is not None:
                static.copy_(t)
        self.graph.replay()
        for k, n in self.launches.items():
            K.LAUNCHES[k] += n
        for k, n in self.shapes.items():
            K.SHAPES[k] = K.SHAPES.get(k, 0) + n
        return tuple(t.clone() for t in self.out)


def plane_width(planes, rows: int = 32):
    """The common width B of planes that are all contiguous uint8
    [rows, B] on one CUDA device (None planes skipped), else None: the
    eager wrappers raise for the others, so they get no graph."""
    first = planes[0]
    if first.device.type != "cuda":
        return None
    width = first.shape[-1]
    for t in planes:
        if t is not None and (t.device != first.device
                              or t.dtype != torch.uint8
                              or tuple(t.shape) != (rows, width)
                              or not t.is_contiguous()):
            return None
    return width
