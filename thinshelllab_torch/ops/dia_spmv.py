"""The hybrid-DIA SpMV (every operator apply of the forward CG and the
adjoint GMRES) and the smoothed block-Jacobi preconditioner of the forward
CG: CUDA kernel wrappers, their plain PyTorch versions and launch
counters.

These replace the two Pallas TPU kernels of
`thinshelllab_tpu/ops/dia_spmv.py` (`dia_spmv`, `dia_precond`). The CUDA
source is `thinshelllab_torch/csrc/dia_spmv.cu`; it is compiled with nvcc
for sm_90a into `thinshelllab_torch/_build/` at first use (rebuilt when the
source is newer than the library) and loaded with ctypes.

A wrapper runs its kernel on a CUDA tensor and its plain version on a CPU
tensor; a failed build or launch raises. `LAUNCHES` counts kernel launches
(one per CUDA kernel launched, so a `dia_precond` call with `sweeps` sweeps
counts sweeps + 1).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "dia_spmv.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
_LIB_PATH = os.path.join(BUILD_DIR, "libtsl_dia.so")

LAUNCHES = {"dia_spmv": 0, "dia_precond": 0}
_lib = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the DIA kernels cannot be built")


def build(verbose=False) -> str:
    """Compile csrc/dia_spmv.cu into _build/libtsl_dia.so when the library
    is missing or older than the source. Returns the library path."""
    if (os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)):
        return _LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", tmp, _SRC]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        if verbose:
            print(res.stderr.strip())
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _LIB_PATH


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"tsl_dia_spmv_{suffix}")
            fn.argtypes = [p, p, p, i, i, p, p]
            fn.restype = i
            fn = getattr(lib, f"tsl_dia_precond_sweep_{suffix}")
            fn.argtypes = [p, p, p, p, p, p, p, i, i, d, i, p]
            fn.restype = i
        _lib = lib
    return _lib


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(name, t, shape, dtype, device):
    if t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                         f"{dtype} on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _offsets_table(offsets, offsets_t, device):
    if offsets_t is None:
        offsets_t = torch.tensor(offsets, dtype=torch.int32, device=device)
    _check("offsets_t", offsets_t, (len(offsets),), torch.int32, device)
    return offsets_t


# --------------------------------------------------------------------------
# dia_spmv
# --------------------------------------------------------------------------


def dia_spmv_plain(dia, x2, offsets):
    """y[i, n] = sum_o sum_j dia[o, i, j, n] * x2[j, n + o], x2 read as zero
    outside [0, NVp): the padded-slices einsum of the JAX package's XLA
    path (elements.hvp_dia_static_T)."""
    NVp = x2.shape[1]
    P = max(abs(o) for o in offsets)
    z = x2.new_zeros((3, P))
    xpad = torch.cat([z, x2, z], dim=1)
    shifted = torch.stack([xpad[:, P + o : P + o + NVp] for o in offsets],
                          dim=1)  # (3, n_off, NVp)
    return torch.einsum("oijn,jon->in", dia, shifted)


def dia_spmv(dia, x2, offsets, offsets_t=None):
    """DIA SpMV y = A x on the (3, NVp) layout: the CUDA kernel for CUDA
    tensors, dia_spmv_plain for CPU tensors.

    dia: (n_off, 3, 3, NVp); x2: (3, NVp); offsets: the plan's offsets;
    offsets_t: the same as an int32 tensor on x2's device (the kernel's
    table; made here when not given)."""
    if not x2.is_cuda:
        return dia_spmv_plain(dia, x2, offsets)
    n_off, NVp = len(offsets), x2.shape[1]
    dev, dt = x2.device, x2.dtype
    if dt not in _SUFFIX:
        raise ValueError(f"dia_spmv kernel takes float32/float64, not {dt}")
    _check("dia", dia, (n_off, 3, 3, NVp), dt, dev)
    _check("x2", x2, (3, NVp), dt, dev)
    offsets_t = _offsets_table(offsets, offsets_t, dev)
    y = torch.empty_like(x2)
    fn = getattr(_load(), f"tsl_dia_spmv_{_SUFFIX[dt]}")
    err = fn(dia.data_ptr(), x2.data_ptr(), offsets_t.data_ptr(), n_off, NVp,
             y.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "dia_spmv launch")
    LAUNCHES["dia_spmv"] += 1
    return y


# --------------------------------------------------------------------------
# dia_precond
# --------------------------------------------------------------------------


def dia_precond_plain(dia_pre, r2, unf2, dinv, offsets, w, sweeps):
    """The damped block-Jacobi polynomial the kernel computes:
    z_0 = w D^-1 r; z_{k+1} = z_k + w D^-1 (r - unf * A' z_k) for k < sweeps,
    with A' = dia_pre (off-band DIA + the full block diagonal D folded into
    the offset-0 lane). dinv: (3, 3, NVp) per-row D^-1."""
    def dmul(v):
        return torch.einsum("ijn,jn->in", dinv, v)

    z = w * dmul(r2)
    for _ in range(sweeps):
        z = z + w * dmul(r2 - unf2 * dia_spmv_plain(dia_pre, z, offsets))
    return z


def dia_precond(dia_pre, r2, unf2, dinv, offsets, w, sweeps, offsets_t=None):
    """Smoothed block-Jacobi preconditioner z = M^-1 r: the CUDA kernels for
    CUDA tensors (one launch for sweep 0, one per later sweep, z ping-ponged
    between two buffers), dia_precond_plain for CPU tensors."""
    if not r2.is_cuda:
        return dia_precond_plain(dia_pre, r2, unf2, dinv, offsets, w, sweeps)
    n_off, NVp = len(offsets), r2.shape[1]
    dev, dt = r2.device, r2.dtype
    if dt not in _SUFFIX:
        raise ValueError(f"dia_precond kernel takes float32/float64, not {dt}")
    _check("dia_pre", dia_pre, (n_off, 3, 3, NVp), dt, dev)
    _check("r2", r2, (3, NVp), dt, dev)
    _check("unf2", unf2, (3, NVp), dt, dev)
    _check("dinv", dinv, (3, 3, NVp), dt, dev)
    offsets_t = _offsets_table(offsets, offsets_t, dev)
    fn = getattr(_load(), f"tsl_dia_precond_sweep_{_SUFFIX[dt]}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    z_in, z_out = torch.empty_like(r2), torch.empty_like(r2)
    for k in range(sweeps + 1):
        err = fn(dia_pre.data_ptr(), r2.data_ptr(), unf2.data_ptr(),
                 dinv.data_ptr(), z_in.data_ptr(), z_out.data_ptr(),
                 offsets_t.data_ptr(), n_off, NVp, float(w), int(k == 0),
                 stream)
        _raise_on(err, f"dia_precond sweep {k} launch")
        LAUNCHES["dia_precond"] += 1
        z_in, z_out = z_out, z_in
    return z_in
