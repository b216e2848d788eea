"""The element kernels' source (thinshelllab_torch/csrc/elements.cu) built
with g++ for the host: the same per-item functions in plain loops
(tsl_element_{eval,fuse}_host_{f32,f64}(args*)), so that the CPU tests can
hold the kernels' arithmetic and layouts without a card.

`groups` runs the card route of engine/elements.all_groups(with_hess=True)
with these host loops in place of the two launches. The library is built
into thinshelllab_torch/_build/libtsl_elements_host.so at first use."""
import ctypes
import os

from thinshelllab_torch.ops import dia_spmv, spd
from thinshelllab_torch.ops import element_kernels as ek

LIB_PATH = os.path.join(dia_spmv.BUILD_DIR, "libtsl_elements_host.so")
_lib = []


def library():
    """The g++ build of csrc/elements.cu, loaded once."""
    if not _lib:
        path = dia_spmv.build_library(
            ek._SRC, LIB_PATH, ["g++", "-x", "c++", "-std=c++17", "-O2",
                                "-fPIC", "-shared", "-Wno-unknown-pragmas"])
        lib = ctypes.CDLL(path)
        for name, args in (("eval", ek.EvalArgs), ("fuse", ek.FuseArgs)):
            for sfx in ek._SUFFIX.values():
                fn = getattr(lib, f"tsl_element_{name}_host_{sfx}")
                fn.argtypes = [ctypes.POINTER(args)]
                fn.restype = ctypes.c_int
        _lib.append(lib)
    return _lib[0]


def groups(spec, params, pos, ref_angle, contact, spd_on):
    """all_groups' card route on CPU tensors through the host loops:
    (fused group, element_eval's blocks before projection)."""
    lib = library()
    sfx = ek._SUFFIX[pos.dtype]
    a, blocks = ek.eval_args(spec, params, pos, ref_angle, contact, spd_on)
    if getattr(lib, f"tsl_element_eval_host_{sfx}")(ctypes.byref(a)) != 0:
        raise RuntimeError("tsl_element_eval_host failed")
    raw = dict(blocks)
    if spd_on:
        for name in ek.PSD_BLOCKS:
            if blocks[name].shape[0]:
                blocks[name] = spd.project_psd_method(
                    blocks[name], spec.spd_method).contiguous()
    f, fused = ek.fuse_args(spec, contact, blocks)
    if getattr(lib, f"tsl_element_fuse_host_{sfx}")(ctypes.byref(f)) != 0:
        raise RuntimeError("tsl_element_fuse_host failed")
    return fused, raw
