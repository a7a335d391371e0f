"""Every kernel wrapper's launch count, read and advanced together, and the
capture of a CUDA graph that counts the kernels it holds.

A wrapper adds one to its count where it launches its kernel, and nothing
while the stream is being captured into a CUDA graph (``_build.launch``).
What a replayed graph launches is added here instead: ``capture`` reads the
hand-written kernel nodes of the graph it captured, by the name of their
``__global__`` function, and ``add`` adds them once for each replay
(``tools.graph_ms``, ``engine/programs.py``)."""

from __future__ import annotations

import ctypes
import re

import torch

from apsu_tpu_torch.ops import behz, ctr_mod, ntt, polyeval, roofline
from apsu_tpu_torch.utils.stopwatch import GLOBAL


def _fn(name: str, general: bool = False) -> str:
    """A ``__global__`` function in a mangled kernel name (its length, its
    name, then its template arguments or the end of its scope), or its
    general build: the third template argument ``false``."""
    return f"{len(name)}{name}" + (r"ILi\d+ELi\d+ELb0E" if general else "[IE]")


# every counter, as (module, name, the kernels it counts: a regular
# expression over a graph's mangled kernel names)
COUNTERS = ((ntt, "launches", _fn("ntt_kernel")),
            (polyeval, "launches", _fn("ps_inner_kernel")),
            (polyeval, "dot_launches", _fn("eval_dot_kernel")),
            (roofline, "loop_launches", _fn("vpu_loop_kernel")),
            (roofline, "add_launches", _fn("add_one_kernel")),
            (behz, "lift_launches",
             _fn("behz_lift_kernel") + "|" + _fn("behz_lift_kernel_digits_scale")),
            (behz, "mac_launches", _fn("mont_mac_kernel")),
            (behz, "scaledown_launches", _fn("behz_scaledown_kernel")),
            (behz, "divround_launches", _fn("rns_divround_kernel")),
            (behz, "lift_general_launches", _fn("behz_lift_kernel", general=True)),
            (behz, "scaledown_general_launches", _fn("behz_scaledown_kernel", general=True)),
            (ctr_mod, "launches", _fn("ctr_mod_kernel")),
            (behz, "scale_add_launches", _fn("scale_add_kernel")))


def read() -> list:
    """The counters' values, in ``COUNTERS``' order."""
    return [getattr(mod, name) for mod, name, _ in COUNTERS]


def since(before: list) -> list:
    """The launches each counter gained since ``before = read()``."""
    return [a - b for a, b in zip(read(), before)]


def add(per_call: list, times: int = 1) -> None:
    """Add ``times`` calls' launches (``per_call``, from ``since`` or
    ``capture``) to the counters."""
    for (mod, name, _), n in zip(COUNTERS, per_call):
        setattr(mod, name, getattr(mod, name) + n * times)


_cuda = None


def _libcuda():
    """``libcuda``, with the graph calls ``kernel_names`` makes."""
    global _cuda
    if _cuda is None:
        cu = ctypes.CDLL("libcuda.so.1")
        vp, out = ctypes.c_void_p, ctypes.POINTER
        cu.cuGraphGetNodes.argtypes = [vp, vp, out(ctypes.c_size_t)]
        cu.cuGraphNodeGetType.argtypes = [vp, out(ctypes.c_int)]
        cu.cuGraphKernelNodeGetParams_v2.argtypes = [vp, vp]
        cu.cuFuncGetName.argtypes = [out(ctypes.c_char_p), vp]
        _cuda = cu
    return _cuda


def _check(err: int, call: str) -> None:
    if err:
        raise RuntimeError(f"{call} failed: CUresult {err}")


def kernel_names(graph: torch.cuda.CUDAGraph) -> list:
    """The mangled name of each kernel node of ``graph``, captured with
    ``keep_graph=True`` (read through ``libcuda``: ``cuGraphGetNodes``,
    ``cuGraphKernelNodeGetParams``, ``cuFuncGetName``)."""
    cu, h = _libcuda(), ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(h, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(cu.cuGraphGetNodes(h, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = []
    params = (ctypes.c_uint64 * 16)()   # CUDA_KERNEL_NODE_PARAMS_v2, its CUfunction first
    for node in nodes:
        kind = ctypes.c_int()
        _check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:   # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        _check(cu.cuGraphKernelNodeGetParams_v2(node, params), "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        _check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params[0])), "cuFuncGetName")
        names.append(name.value.decode())
    return names


def in_graph(names: list) -> list:
    """The launches of each counter among a graph's ``kernel_names``."""
    return [sum(1 for k in names if re.search(pattern, k)) for *_, pattern in COUNTERS]


def capture(fn, reps: int = 1):
    """``fn()``, ``reps`` times over, captured into one CUDA graph on the
    current device: ``(graph, outs of the last call, per_replay)``.

    ``fn`` runs once eagerly on a side stream first, which fills every lazy
    cache and builds every kernel before the capture, and its launches are
    counted.  ``per_replay`` is what the graph holds, each counter's kernel
    nodes, and a replay launches exactly these: a capture whose kernels
    differ from ``reps`` times the eager call's raises.  The graph is
    instantiated before it returns, so that its first replay only launches.
    Spans: ``capture.warmup`` (the eager call), ``capture.record`` (the
    Python pass under capture), ``capture.instantiate``."""
    stream = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(stream)
    before = read()
    with GLOBAL.span("capture.warmup"), torch.cuda.stream(side):
        fn()
    eager = [n * reps for n in since(before)]
    stream.wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with GLOBAL.span("capture.record"):
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            for _ in range(reps):
                outs = fn()
    per_replay = in_graph(kernel_names(graph))
    if per_replay != eager:
        raise RuntimeError(f"a captured graph holds the launches {per_replay}, "
                           f"its eager calls made {eager} ({[c for _, c, _ in COUNTERS]})")
    with GLOBAL.span("capture.instantiate"):
        graph.instantiate()
    return graph, outs, per_replay
