"""Which kernels one call launches, as the CUDA driver records them.

The call is captured into a CUDA graph, which records its launches without
running them, and the graph's kernel nodes are read back through the
driver API (``libcuda``): each node's function and its name.  chip_smoke.py
and the ``gpu`` tests hold a wrapper's launches to its plan with this; the
port's own paths never call it.  The driver is loaded at the first call,
never at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

_KERNEL_NODE = 0     # CU_GRAPH_NODE_TYPE_KERNEL


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of the driver API."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


@functools.cache
def _driver() -> ctypes.CDLL:
    cu = ctypes.CDLL("libcuda.so.1")
    ptr = ctypes.POINTER
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ptr(ctypes.c_void_p),
                                   ptr(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ptr(ctypes.c_int)]
    cu.cuGraphKernelNodeGetParams_v2.argtypes = [ctypes.c_void_p,
                                                 ptr(_KernelNodeParams)]
    for f in (cu.cuKernelGetName, cu.cuFuncGetName):
        f.argtypes = [ptr(ctypes.c_char_p), ctypes.c_void_p]
    return cu


def _ok(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUresult {rc}")


def function_name(mangled: str) -> str:
    """The function's own name in an Itanium-mangled symbol, without its
    scopes and template arguments: ``ssd_chunk_cb`` for
    ``_ZN42_GLOBAL__N__95661dc2_10_ssd_fwd_cu_ssd_fwd12ssd_chunk_cbILi16EEEvNS_6ParamsE``.
    A name that is not mangled comes back as it is."""
    if not mangled.startswith("_Z"):
        return mangled
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    return name


def launched_kernels(fn) -> list[str]:
    """The names (``function_name``) of the kernels that one ``fn()`` on
    the current CUDA device launches, in the order of the graph's nodes.
    ``fn`` must be capturable: a call of it has run before, so its lazy
    set-up is done."""
    cu = _driver()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _ok(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _ok(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        _ok(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
            "cuGraphNodeGetType")
        if kind.value != _KERNEL_NODE:
            continue
        params = _KernelNodeParams()
        _ok(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
            "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params.kern:
            _ok(cu.cuKernelGetName(ctypes.byref(name), params.kern),
                "cuKernelGetName")
        else:
            _ok(cu.cuFuncGetName(ctypes.byref(name), params.func),
                "cuFuncGetName")
        names.append(function_name(name.value.decode()))
    del graph
    return names
