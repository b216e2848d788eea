"""The hybrid-DIA SpMV (every operator apply of the forward CG and the
adjoint GMRES) and the smoothed block-Jacobi preconditioner of the forward
CG: CUDA kernel wrappers, their plain PyTorch versions and launch
counters.

These replace the two Pallas TPU kernels of
`thinshelllab_tpu/ops/dia_spmv.py` (`dia_spmv`, `dia_precond`). The CUDA
source is `thinshelllab_torch/csrc/dia_spmv.cu`; it is compiled with nvcc
for sm_90a into `thinshelllab_torch/_build/` at first use (rebuilt when the
source is newer than the library) and loaded with ctypes.

The preconditioner is one persistent cooperative launch per call. The TPU
kernel ran its sweeps as one grid whose sequential order was the barrier
between them; on the card every CTA stays resident, a grid-wide barrier
(`grid.sync()`) separates the sweeps, and each CTA keeps its rows' slice of
the store in shared memory, so the store is read from HBM once per call
instead of once per sweep. `precond_plan` sizes that launch (rows per CTA,
grid, threads, staged lanes, shared memory); where a slice does not fit,
the kernel reads the lanes past the staged ones from global memory in
every sweep.

A wrapper runs its kernel on a CUDA tensor and its plain version on a CPU
tensor; a failed build, occupancy query or launch raises. `LAUNCHES`
counts kernel launches: one per `dia_spmv` and one per `dia_precond` call.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
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
                       "the CUDA kernels cannot be built")


def build_library(src, lib_path, compiler, verbose=False) -> str:
    """Compile `src` into the shared library `lib_path` with the command
    `compiler` (its flags, without -o and the source) when the library is
    missing or older than the source, through a temporary file, so that
    processes building at once never load a half-written library. Returns
    the library path."""
    if (os.path.exists(lib_path)
            and os.path.getmtime(lib_path) >= os.path.getmtime(src)):
        return lib_path
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib_path))
    os.close(fd)
    try:
        res = subprocess.run([*compiler, "-o", tmp, src], capture_output=True,
                             text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler[0])} failed "
                               f"({res.returncode}) on {src}:\n{res.stderr}")
        if verbose:
            print(res.stderr.strip())
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib_path


def nvcc_flags():
    """nvcc and its flags for a shared library of sm_90a kernels with a
    plain C interface."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def build(verbose=False) -> str:
    """Compile csrc/dia_spmv.cu into _build/libtsl_dia.so when the library
    is missing or older than the source. Returns the library path."""
    return build_library(_SRC, _LIB_PATH, nvcc_flags(), verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        ip = ctypes.POINTER(ctypes.c_int)
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"tsl_dia_spmv_{suffix}")
            fn.argtypes = [p, p, p, i, i, p, p]
            fn.restype = i
            fn = getattr(lib, f"tsl_dia_precond_{suffix}")
            fn.argtypes = [p, p, p, p, p, p, p, i, i, d, i, i, i, i, i, i, i,
                           i, p]
            fn.restype = i
            fn = getattr(lib, f"tsl_dia_precond_occupancy_{suffix}")
            fn.argtypes = [i, i, ip]
            fn.restype = i
        lib.tsl_device_limits.argtypes = [i, ip, ip]
        lib.tsl_device_limits.restype = i
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


@dataclasses.dataclass(frozen=True)
class PrecondPlan:
    """Launch geometry of the preconditioner kernel. CTA b owns rows
    [b * rows, min((b + 1) * rows, NVp)); its thread item (row, g) sums
    offset lanes g, g + groups, ... of that row; lanes below `staged` are
    held in shared memory, the rest read from global memory every sweep."""
    rows: int        # R, a multiple of 4 (16-byte row slices)
    grid: int        # CTAs, all co-resident
    groups: int      # offset groups per row
    threads: int     # per CTA, whole warps
    staged: int      # leading offset lanes held in shared memory
    max_off: int     # P: a CTA's z window is rows + 2 P rows
    smem_bytes: int  # dynamic shared memory per CTA


# thread items (row, offset group) a CTA aims for
TARGET_THREADS = 512


def precond_smem_bytes(rows, groups, staged, max_off, n_off, itemsize):
    """Shared memory of one CTA (precond_layout in the .cu): the staged
    store [staged * 9][rows], r, unf and D^-1 of its rows [15][rows], the
    groups' partial sums [3][groups][rows], the z window
    [3][rows + 2 max_off] and the offset table (int32)."""
    n_t = (9 * staged * rows + 15 * rows + 3 * groups * rows
           + 3 * (rows + 2 * max_off))
    return n_t * itemsize + 4 * n_off


def precond_plan(NVp, n_off, itemsize, sms, smem_limit, max_abs_off,
                 blocks_per_sm=1):
    """The preconditioner's launch geometry for a store of n_off lanes over
    NVp rows of `itemsize`-byte values, on a card of `sms` SMs whose blocks
    may use `smem_limit` bytes of shared memory, holding `blocks_per_sm`
    CTAs that claim that much (1 on Hopper).

    Rows per CTA: the smallest multiple of 4 for which ceil(NVp / R) CTAs
    fit on the card at once (one persistent CTA per SM at the bench; fewer,
    larger CTAs also re-read fewer halo rows of z). Staged lanes: as many as
    the budget left after the CTA's other shared arrays holds."""
    if NVp <= 0 or NVp % 4:
        raise ValueError(f"NVp {NVp}: the kernel takes a positive multiple "
                         "of 4 rows")
    slots = sms * blocks_per_sm
    if slots <= 0:
        raise ValueError(f"{sms} SMs x {blocks_per_sm} CTAs: no CTA fits")
    rows = 4 * -(-NVp // (4 * slots))
    groups = max(1, min(n_off, TARGET_THREADS // rows))
    threads = min(1024, 32 * -(-(rows * groups) // 32))

    def smem(staged):
        return precond_smem_bytes(rows, groups, staged, max_abs_off, n_off,
                                  itemsize)

    if smem(0) > smem_limit:
        raise ValueError(f"a CTA of {rows} rows with a window of "
                         f"{rows + 2 * max_abs_off} rows needs {smem(0)} "
                         f"bytes of shared memory, over {smem_limit}")
    staged = min(n_off, (smem_limit - smem(0)) // (9 * rows * itemsize))
    return PrecondPlan(rows=rows, grid=-(-NVp // rows), groups=groups,
                       threads=threads, staged=staged, max_off=max_abs_off,
                       smem_bytes=smem(staged))


def _int_out(fn, *args):
    out = [ctypes.c_int(0) for _ in range(fn.argtypes.count(
        ctypes.POINTER(ctypes.c_int)))]
    _raise_on(fn(*args, *(ctypes.byref(v) for v in out)), fn.__name__)
    return [v.value for v in out]


@functools.lru_cache(maxsize=None)
def device_precond_plan(device_index, NVp, offsets, dtype):
    """precond_plan for the card `device_index`, from its SM count and
    shared-memory limit, with the occupancy of a CTA that claims the whole
    per-block budget as CUDA reports it."""
    lib = _load()
    it = torch.empty((), dtype=dtype).element_size()
    with torch.cuda.device(device_index):
        sms, smem_limit = _int_out(lib.tsl_device_limits, device_index)
        occ, = _int_out(getattr(lib, f"tsl_dia_precond_occupancy_"
                                     f"{_SUFFIX[dtype]}"),
                        TARGET_THREADS, smem_limit)
    return precond_plan(NVp, len(offsets), it, sms, smem_limit,
                        max(abs(int(o)) for o in offsets), blocks_per_sm=occ)


def dia_precond(dia_pre, r2, unf2, dinv, offsets, w, sweeps, offsets_t=None):
    """Smoothed block-Jacobi preconditioner z = M^-1 r: one cooperative
    launch of the CUDA kernel for CUDA tensors (z ping-ponged between two
    buffers inside it), dia_precond_plain for CPU tensors."""
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
    plan = device_precond_plan(dev.index if dev.index is not None
                               else torch.cuda.current_device(), NVp,
                               tuple(offsets), dt)
    return _precond_launch(plan, dia_pre, r2, unf2, dinv, offsets_t, w,
                           sweeps)


def _precond_launch(plan, dia_pre, r2, unf2, dinv, offsets_t, w, sweeps):
    """One launch of the preconditioner kernel with the geometry `plan`;
    raises on any CUDA error (a grid that cannot be co-resident included)."""
    n_off, NVp = dia_pre.shape[0], r2.shape[1]
    fn = getattr(_load(), f"tsl_dia_precond_{_SUFFIX[r2.dtype]}")
    za, zb = torch.empty_like(r2), torch.empty_like(r2)
    err = fn(dia_pre.data_ptr(), r2.data_ptr(), unf2.data_ptr(),
             dinv.data_ptr(), za.data_ptr(), zb.data_ptr(),
             offsets_t.data_ptr(), n_off, NVp, float(w), int(sweeps),
             plan.rows, plan.groups, plan.staged, plan.max_off, plan.grid,
             plan.threads, plan.smem_bytes,
             torch.cuda.current_stream(r2.device).cuda_stream)
    _raise_on(err, f"dia_precond launch ({plan})")
    LAUNCHES["dia_precond"] += 1
    return zb if sweeps % 2 else za
