"""Recording CUDA graphs: the one helper behind the executor's segment and
whole-program graphs and the native bootstrap's graphs.

`record` is what `torch.cuda.graph` does, with the graph kept until it is
instantiated: so the recording and the instantiation are timed apart, the
graph's nodes are counted, and a recording that stops early
(UploadUnderCapture: a device cache would have filled under capture,
crypto/params.upload) is dropped without being instantiated.
"""

import ctypes
import time
import warnings

import torch

_libcuda = None


def _node_count(graph):
    """Nodes of a kept graph, by libcuda's cuGraphGetNodes."""
    global _libcuda
    if _libcuda is None:
        _libcuda = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    rc = _libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                                  ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {rc}")
    return int(n.value)


def record(body, stream, pool=None, capture_error_mode="global"):
    """Record body() on `stream` into a new graph in memory pool `pool` (a
    graph_pool_handle; None: a pool of its own). If body raises, the
    capture is ended, the graph dropped and the error raised. Returns
    dict(graph, out (body's return), capture_s, instantiate_s, nodes). The
    card is synchronized and the device's and the pinned host memory's
    caches emptied first, as torch.cuda.graph does (a pool whose graphs
    were all dropped must be emptied before the next capture into it)."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch._C._host_emptyCache()
    t0 = time.perf_counter()
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode=capture_error_mode)
        try:
            out = body()
        except BaseException:
            with warnings.catch_warnings():
                # a recording stopped before its first kernel is empty
                warnings.simplefilter("ignore")
                graph.capture_end()
            raise
        graph.capture_end()
    t1 = time.perf_counter()
    nodes = _node_count(graph)
    graph.instantiate()
    return dict(graph=graph, out=out, capture_s=t1 - t0,
                instantiate_s=time.perf_counter() - t1, nodes=nodes)
