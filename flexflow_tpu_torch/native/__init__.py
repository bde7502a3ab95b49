"""ctypes bindings for the native search engines — a copy of
flexflow_tpu/native/__init__.py over the same sources.

The reference implements its graph core, search inner loop and
simulator in C++ (reference: src/runtime/graph.cc, simulator.cc); the
JAX package binds its C++ equivalents in ``native/src/*.cpp``, and the
port binds the same files (read, never edited): the graph algorithms
(``graph_algos.cpp``), the simulation engine (``sim_engine.cpp``) and
the DP engine (``dp_engine.cpp``) are host-side search code, not device
kernels; the data loader's threaded row gather (``dataloader.cpp``,
``gather_rows``) is host-side loading code.  At first use they are compiled with ``g++`` into one shared
library under ``flexflow_tpu_torch/_build/native/`` (git-ignored), named
by a hash of the sources and flags, so an edited source builds anew
and a second process reuses the library; several processes building at
once each write a file of their own and rename it into place.  Every
caller keeps the reference's pure-Python path; set
``FLEXFLOW_TPU_NO_NATIVE=1`` to force it (the tests compare both
paths).  ``get_lib`` is None when the switch is set or no compiler is
found.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native", "src")
BUILD_DIR = os.path.join(_PKG_DIR, "_build", "native")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib = None
_lib_tried = False


def _configure(lib) -> None:
    c_i32, c_f64 = ctypes.c_int32, ctypes.c_double
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_f64 = ctypes.POINTER(ctypes.c_double)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_void = ctypes.c_void_p

    lib.ffn_sim_create.restype = p_void
    lib.ffn_sim_create.argtypes = [c_i32, c_i32]
    lib.ffn_sim_destroy.argtypes = [p_void]
    lib.ffn_sim_add_view.argtypes = [p_void, c_i32, c_f64, c_f64, c_f64,
                                     c_f64, p_i32, c_i32, p_i32, c_i32, c_i32]
    lib.ffn_sim_set_mem_cap.argtypes = [p_void, c_f64]
    lib.ffn_sim_set_default_view.argtypes = [p_void, c_i32, c_i32]
    lib.ffn_sim_add_edge.argtypes = [p_void, c_i32, c_i32, p_f64, c_i32]
    lib.ffn_sim_simulate.restype = c_f64
    lib.ffn_sim_simulate.argtypes = [p_void, p_i32, c_i32]
    lib.ffn_sim_brute_force.restype = c_f64
    lib.ffn_sim_brute_force.argtypes = [p_void, p_i32, c_i32, p_i32, c_i32]
    lib.ffn_sim_greedy.restype = c_f64
    lib.ffn_sim_greedy.argtypes = [p_void, p_u8, p_i32, p_i32, c_i32]

    p_u64 = ctypes.POINTER(ctypes.c_uint64)
    lib.ffn_dp_create.restype = p_void
    lib.ffn_dp_create.argtypes = [c_i32, c_i32, c_f64, c_i32, c_i32, c_i32]
    lib.ffn_dp_destroy.argtypes = [p_void]
    lib.ffn_dp_add_view.argtypes = [p_void, c_i32, c_f64, c_f64, c_f64,
                                    c_f64, c_i32, c_i32]
    lib.ffn_dp_set_views.argtypes = [p_void, p_i32, p_f64, p_f64, p_f64,
                                     p_f64, p_i32, p_u8]
    lib.ffn_dp_set_node_meta.argtypes = [p_void, p_i32, p_i32, p_i32]
    lib.ffn_dp_set_budgets.argtypes = [p_void, p_i32, c_i32, p_i32, c_i32]
    lib.ffn_dp_set_lists.argtypes = [p_void, p_i32, p_i32, c_i32, p_i32,
                                     p_i32, c_i32, p_i32]
    lib.ffn_dp_add_edge.argtypes = [p_void, c_i32, c_i32, c_i32, p_f64]
    lib.ffn_dp_graph_cost.restype = c_f64
    lib.ffn_dp_graph_cost.argtypes = [p_void, p_u64, p_i32, p_i32, c_i32,
                                      c_i32, p_i32]
    lib.ffn_dp_greedy_hits.restype = c_i32
    lib.ffn_dp_greedy_hits.argtypes = [p_void]

    lib.ffn_graph_topo.restype = c_i32
    lib.ffn_graph_topo.argtypes = [c_i32, p_i32, c_i32, p_i32]
    lib.ffn_graph_bottlenecks.restype = c_i32
    lib.ffn_graph_bottlenecks.argtypes = [c_i32, p_i32, c_i32, p_i32]
    lib.ffn_graph_components.restype = c_i32
    lib.ffn_graph_components.argtypes = [c_i32, p_i32, c_i32, p_i32]

    p_i64 = ctypes.POINTER(ctypes.c_int64)
    lib.ffn_gather_rows.argtypes = [p_u8, p_u8, p_i64, ctypes.c_int64,
                                    ctypes.c_int64, c_i32]


def _sources() -> List[str]:
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cpp")))


def library_path() -> str:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR,
                        f"libflexflow_native-{h.hexdigest()[:16]}.so")


def build() -> Optional[str]:
    """Compile ``native/src/*.cpp`` unless already built; the library
    path, or None when there is no compiler or no source."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    srcs = _sources()
    if cxx is None or not srcs:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *CXX_FLAGS, *srcs, "-lpthread", "-o", tmp],
                       check=True, capture_output=True, timeout=300)
    except (subprocess.SubprocessError, OSError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None
    os.replace(tmp, path)
    return path


def get_lib():
    """The loaded native library, built on first use; None when
    disabled or unbuildable."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if os.environ.get("FLEXFLOW_TPU_NO_NATIVE"):
        return None
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    _configure(lib)
    _lib = lib
    return _lib


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


# ---------------------------------------------------------------------------
# Dataloader gather
# ---------------------------------------------------------------------------


def gather_rows(src: np.ndarray, indices: np.ndarray,
                n_threads: int = 0) -> Optional[np.ndarray]:
    """``src[indices]`` along the first dim through the threaded native
    gather (``ffn_gather_rows``); None when the library is unavailable
    (the caller takes numpy's).  Indices must lie in ``[0, len(src))``:
    the native copy checks none, so they are checked here."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= src.shape[0]):
        raise IndexError(f"gather_rows: indices outside [0, {src.shape[0]})")
    out = np.empty((len(idx),) + src.shape[1:], dtype=src.dtype)
    row_bytes = int(src.dtype.itemsize
                    * np.prod(src.shape[1:], dtype=np.int64))
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.ffn_gather_rows(out.ctypes.data_as(u8), src.ctypes.data_as(u8),
                        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                        len(idx), row_bytes, n_threads)
    return out


# ---------------------------------------------------------------------------
# Simulation engine
# ---------------------------------------------------------------------------


class NativeSimGraph:
    """A digested (graph, candidate views) instance on the native engine.

    Node ids must be dense 0..n-1 in topological order. Per node, views
    are registered in order; ``add_edge`` takes the row-major
    [src_views x dst_views] xfer-seconds matrix.
    """

    def __init__(self, num_nodes: int, num_devices: int):
        self.lib = get_lib()
        assert self.lib is not None, "native library unavailable"
        self.num_nodes = num_nodes
        self._g = self.lib.ffn_sim_create(num_nodes, num_devices)

    def __del__(self):
        if getattr(self, "_g", None):
            self.lib.ffn_sim_destroy(self._g)
            self._g = None

    def add_view(self, node: int, fwd: float, full: float, sync: float,
                 devices: Sequence[int], comm_devices: Sequence[int] = (),
                 mem: float = 0.0, valid: bool = True) -> None:
        d = np.asarray(list(devices), dtype=np.int32)
        c = np.asarray(list(comm_devices), dtype=np.int32)
        self.lib.ffn_sim_add_view(self._g, node, float(fwd), float(full),
                                  float(sync), float(mem), _i32(d), len(d),
                                  _i32(c), len(c), int(valid))

    def set_mem_cap(self, cap: float) -> None:
        self.lib.ffn_sim_set_mem_cap(self._g, float(cap))

    def set_default_view(self, node: int, view: int) -> None:
        self.lib.ffn_sim_set_default_view(self._g, node, view)

    def add_edge(self, src: int, dst: int, xfer: np.ndarray,
                 has_grad: bool = True) -> None:
        x = np.ascontiguousarray(xfer, dtype=np.float64)
        self.lib.ffn_sim_add_edge(
            self._g, src, dst,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), int(has_grad)
        )

    def simulate(self, assignment: Sequence[int], include_update=True) -> float:
        a = np.asarray(list(assignment), dtype=np.int32)
        return self.lib.ffn_sim_simulate(self._g, _i32(a), int(include_update))

    def brute_force(self, free_nodes: Sequence[int], base: Sequence[int],
                    include_update=True) -> Tuple[float, np.ndarray]:
        """Returns (best_cost, best_assignment)."""
        f = np.asarray(list(free_nodes), dtype=np.int32)
        a = np.asarray(list(base), dtype=np.int32)
        cost = self.lib.ffn_sim_brute_force(self._g, _i32(f), len(f), _i32(a),
                                            int(include_update))
        return cost, a

    def greedy(self, is_free: Sequence[bool], enum_counts: Sequence[int],
               base: Sequence[int], include_update=True) -> Tuple[float, np.ndarray]:
        m = np.asarray(list(is_free), dtype=np.uint8)
        e = np.asarray(list(enum_counts), dtype=np.int32)
        a = np.asarray(list(base), dtype=np.int32)
        cost = self.lib.ffn_sim_greedy(
            self._g, m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            _i32(e), _i32(a), int(include_update))
        return cost, a


# ---------------------------------------------------------------------------
# Graph algorithms
# ---------------------------------------------------------------------------


def _edges_array(edges: Sequence[Tuple[int, int]]) -> np.ndarray:
    if len(edges) == 0:
        return np.empty((0, 2), dtype=np.int32)
    return np.asarray(edges, dtype=np.int32)


def graph_bottlenecks(n: int, edges: Sequence[Tuple[int, int]]) -> Optional[List[int]]:
    """Native bottleneck finding; None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    e = _edges_array(edges)
    out = np.empty(max(n, 1), dtype=np.int32)
    cnt = lib.ffn_graph_bottlenecks(n, _i32(e), len(e), _i32(out))
    if cnt < 0:
        raise ValueError("graph has a cycle")
    return [int(x) for x in out[:cnt]]


def graph_components(n: int, edges: Sequence[Tuple[int, int]]) -> Optional[List[int]]:
    lib = get_lib()
    if lib is None:
        return None
    e = _edges_array(edges)
    labels = np.empty(max(n, 1), dtype=np.int32)
    lib.ffn_graph_components(n, _i32(e), len(e), _i32(labels))
    return [int(x) for x in labels[:n]]


def graph_topo(n: int, edges: Sequence[Tuple[int, int]]) -> Optional[List[int]]:
    lib = get_lib()
    if lib is None:
        return None
    e = _edges_array(edges)
    out = np.empty(max(n, 1), dtype=np.int32)
    rc = lib.ffn_graph_topo(n, _i32(e), len(e), _i32(out))
    if rc < 0:
        raise ValueError("graph has a cycle")
    return [int(x) for x in out[:n]]


# ---------------------------------------------------------------------------
# Dataloader gather
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# DP search engine (native graph_cost recursion)
# ---------------------------------------------------------------------------


class NativeDPGraph:
    """A digested (graph, union candidate views) instance on the native
    DP engine (native/src/dp_engine.cpp) — the full graph_cost
    recursion runs in C++ over node bitmasks.  Node ids must be dense
    0..n-1 in topological order."""

    MAX_NODES = 256

    def __init__(self, num_nodes: int, num_devices: int, mem_cap: float,
                 include_update: bool, leaf_threshold: int = 4,
                 max_tries: int = 2):
        self.lib = get_lib()
        assert self.lib is not None, "native library unavailable"
        assert num_nodes <= self.MAX_NODES
        self.num_nodes = num_nodes
        self._g = self.lib.ffn_dp_create(
            num_nodes, num_devices, float(mem_cap), int(include_update),
            leaf_threshold, max_tries)
        assert self._g, "ffn_dp_create failed"

    def __del__(self):
        if getattr(self, "_g", None):
            self.lib.ffn_dp_destroy(self._g)
            self._g = None

    def add_view(self, node: int, fwd: float, full: float, sync: float,
                 mem: float, parts: int, valid: bool) -> None:
        self.lib.ffn_dp_add_view(self._g, node, float(fwd), float(full),
                                 float(sync), float(mem), int(parts),
                                 int(valid))

    def set_views(self, node_off, fwd, full, sync, mem, parts,
                  valid) -> None:
        """Bulk per-node view upload; node_off is an n+1 prefix array
        into the flat per-view arrays."""
        off = np.ascontiguousarray(node_off, dtype=np.int32)
        f = np.ascontiguousarray(fwd, dtype=np.float64)
        u = np.ascontiguousarray(full, dtype=np.float64)
        s = np.ascontiguousarray(sync, dtype=np.float64)
        m = np.ascontiguousarray(mem, dtype=np.float64)
        p = np.ascontiguousarray(parts, dtype=np.int32)
        v = np.ascontiguousarray(valid, dtype=np.uint8)
        pf = ctypes.POINTER(ctypes.c_double)
        self.lib.ffn_dp_set_views(
            self._g, _i32(off), f.ctypes.data_as(pf), u.ctypes.data_as(pf),
            s.ctypes.data_as(pf), m.ctypes.data_as(pf), _i32(p),
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))

    def set_node_meta(self, fixed_view, trivial_idx, guid_rank) -> None:
        f = np.ascontiguousarray(fixed_view, dtype=np.int32)
        t = np.ascontiguousarray(trivial_idx, dtype=np.int32)
        g = np.ascontiguousarray(guid_rank, dtype=np.int32)
        self.lib.ffn_dp_set_node_meta(self._g, _i32(f), _i32(t), _i32(g))

    def set_budgets(self, budgets, cands) -> None:
        b = np.ascontiguousarray(budgets, dtype=np.int32)
        c = np.ascontiguousarray(cands, dtype=np.int32)
        self.lib.ffn_dp_set_budgets(self._g, _i32(b), len(b), _i32(c), len(c))

    def set_lists(self, cand_off, cand_idx, bview_off, bview_idx,
                  default_idx) -> None:
        co = np.ascontiguousarray(cand_off, dtype=np.int32)
        ci = np.ascontiguousarray(cand_idx, dtype=np.int32)
        bo = np.ascontiguousarray(bview_off, dtype=np.int32)
        bi = np.ascontiguousarray(bview_idx, dtype=np.int32)
        di = np.ascontiguousarray(default_idx, dtype=np.int32)
        self.lib.ffn_dp_set_lists(self._g, _i32(co), _i32(ci), len(ci),
                                  _i32(bo), _i32(bi), len(bi), _i32(di))

    def add_edge(self, src: int, dst: int, has_grad: bool,
                 xfer: np.ndarray) -> None:
        x = np.ascontiguousarray(xfer, dtype=np.float64)
        self.lib.ffn_dp_add_edge(
            self._g, src, dst, int(has_grad),
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))

    def graph_cost(self, node_indices: Sequence[int],
                   fixed: Dict[int, int], budget: int):
        """(cost, assign[num_nodes]) for the subgraph given by
        ``node_indices`` with ``fixed`` {node: view_idx} pinned."""
        # python-int bit ops: numpy scalar shifts here were a measured
        # per-call hotspot (this runs once per popped search candidate)
        words = [0, 0, 0, 0]
        for i in node_indices:
            words[i >> 6] |= 1 << (i & 63)
        mask = np.array(words, dtype=np.uint64)
        fn = np.ascontiguousarray(sorted(fixed), dtype=np.int32)
        fv = np.ascontiguousarray([fixed[k] for k in sorted(fixed)],
                                  dtype=np.int32)
        out = np.full(self.num_nodes, -1, dtype=np.int32)
        cost = self.lib.ffn_dp_graph_cost(
            self._g, mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            _i32(fn), _i32(fv), len(fn), int(budget), _i32(out))
        return cost, out

    def greedy_hits(self) -> int:
        return int(self.lib.ffn_dp_greedy_hits(self._g))
