"""ctypes loader for the native topology builders (counterpart of
`thinshelllab_tpu/native/__init__.py`).

Compiles thinshelllab_torch/native/topology.cpp with `g++ -O2 -fPIC
-shared` into thinshelllab_torch/_build/libtsl_topology.so at first use
(again when the source is newer than the library). A failed build raises
with the compiler's message. Set TSL_NO_NATIVE=1 to take the numpy paths
of core/topology.py and core/builder.py instead: each function here then
returns None.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "topology.cpp")
_SO = os.path.join(_PKG, "_build", "libtsl_topology.so")
_lib = None


def build() -> str:
    """Compile topology.cpp when the library is missing or older than the
    source. Returns the library path."""
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_SO))
    os.close(fd)
    try:
        res = subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-o", tmp,
                              _SRC], capture_output=True, text=True,
                             timeout=120)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}) on {_SRC}:\n"
                               f"{res.stderr}")
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _SO


def get_lib():
    """The loaded library, or None under TSL_NO_NATIVE."""
    global _lib
    if os.environ.get("TSL_NO_NATIVE"):
        return None
    if _lib is None:
        lib = ctypes.CDLL(build())
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.tsl_cloth_mesh_tables.argtypes = [
            ctypes.c_int, ctypes.c_int, i32p, i32p, i32p, i32p]
        lib.tsl_cloth_mesh_tables.restype = None
        lib.tsl_build_hinges.argtypes = [
            ctypes.c_int, i32p, i32p, i32p, f64p, i32p, i32p, u8p]
        lib.tsl_build_hinges.restype = None
        lib.tsl_cube_tets.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, i32p]
        lib.tsl_cube_tets.restype = None
        _lib = lib
    return _lib


def cloth_mesh_tables(N: int, M: int):
    """(f2v, counter_face, counter_point, indices) of the N x M cloth grid
    (core/topology.cloth_tables_numpy), or None under TSL_NO_NATIVE."""
    lib = get_lib()
    if lib is None:
        return None
    NF = 2 * N * M
    f2v = np.zeros((NF, 3), np.int32)
    cf = np.zeros((NF, 3), np.int32)
    cp = np.zeros((NF, 3), np.int32)
    indices = np.zeros(NF * 3, np.int32)
    lib.tsl_cloth_mesh_tables(N, M, f2v, cf, cp, indices)
    return f2v, cf, cp, indices


def build_hinges(f2v, cf, cp, init_pos):
    """(hinge_verts, stencils, mask) of one cloth
    (core/builder.build_hinges_numpy), or None under TSL_NO_NATIVE."""
    lib = get_lib()
    if lib is None:
        return None
    NF = len(f2v)
    init_pos = np.ascontiguousarray(init_pos, np.float64)
    if init_pos.ndim != 2 or init_pos.shape[1] != 3:
        raise ValueError(f"init_pos has shape {init_pos.shape}")
    f2v = np.ascontiguousarray(f2v, np.int32)
    if f2v.size and (f2v.min() < 0 or f2v.max() >= len(init_pos)):
        raise ValueError("f2v indexes outside init_pos")
    hv = np.zeros((NF * 3, 4), np.int32)
    st = np.zeros((NF * 3, 4), np.int32)
    mask = np.zeros(NF * 3, np.uint8)
    lib.tsl_build_hinges(NF, f2v, np.ascontiguousarray(cf, np.int32),
                         np.ascontiguousarray(cp, np.int32), init_pos, hv, st,
                         mask)
    return hv, st, mask.astype(bool)


def cube_tets(nx, ny, nz):
    """(5 (nx-1)(ny-1)(nz-1), 4) int32 tets of the cube lattice
    (core/topology.cube_tets_numpy), or None under TSL_NO_NATIVE."""
    lib = get_lib()
    if lib is None:
        return None
    n = 5 * (nx - 1) * (ny - 1) * (nz - 1)
    tets = np.zeros((n, 4), np.int32)
    lib.tsl_cube_tets(nx, ny, nz, tets)
    return tets
