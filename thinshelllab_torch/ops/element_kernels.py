"""The element layer on the card: every family's energy, gradient and
Hessian block in one launch (`element_eval`), and the fused padded block
group of `engine/elements.all_groups` in another (`element_fuse`), with the
batched eigh projection (ops/spd) between them in the caller.

The CUDA source is `thinshelllab_torch/csrc/elements.cu` (its note gives
the design and the layouts); it is compiled with nvcc for sm_90a into
`thinshelllab_torch/_build/` at first use, as `ops/dia_spmv` builds its
library, and loaded with ctypes. No TPU kernel is replaced: the JAX package
evaluates the elements with XLA's vmap(jacfwd(grad)). The plain version is
the torch.func code of engine/elements, which every CPU tensor takes.

`eval_args` and `fuse_args` check the inputs (no autograd input, one
float dtype, int64 indices, bool masks, contiguous, the shapes of one
scene on one device) and lay out the argument structs the kernels take
(the CPU tests give the same structs to the source's host build).

`LAUNCHES` counts kernel launches: one `element_eval` and one
`element_fuse` for each all_groups(with_hess=True) call on the card.
"""
from __future__ import annotations

import ctypes
import os

import torch

from . import dia_spmv as _dia

_SRC = os.path.join(_dia._PKG, "csrc", "elements.cu")
_LIB_PATH = os.path.join(_dia.BUILD_DIR, "libtsl_elements.so")

LAUNCHES = {"element_eval": 0, "element_fuse": 0}
_lib = []

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# the field order of EvalArgs / FuseArgs in csrc/elements.cu; every field
# is 8 bytes wide
_I, _D, _P = ctypes.c_int64, ctypes.c_double, ctypes.c_void_p
EVAL_FIELDS = (
    [(n, _I) for n in ("nv", "nf", "nh", "nn", "nt", "nc", "spd")]
    + [(n, _D) for n in ("k_contact", "eps_contact", "eh")]
    + [(n, _P) for n in (
        "pos", "f2v", "cloth_id", "l0", "rest_area", "kl", "ka",
        "hinge_verts", "hinge_sel", "hinge_mask", "canon", "ref_angle",
        "hinge_coef", "hinge_cloth", "kb",
        "neo_tets", "neo_B", "neo_W", "neo_group", "neo_mu", "neo_lam",
        "tact_tets", "tact_B", "tact_W", "tact_group", "tact_mu", "tact_lam",
        "cidx", "cw", "cdx0", "ct", "ck",
        "Hm", "gm", "em", "Hb", "gb", "eb", "Hn", "Gn", "en", "Ht", "Gt",
        "et", "Hr", "Gr", "ec", "g1f", "h1f", "ef")]
    + [("block_end", _I * 6)])
FUSE_FIELDS = (
    [(n, _I) for n in ("nv", "nf", "nh", "nn", "nt", "nc")]
    + [(n, _P) for n in (
        "f2v", "hinge_verts", "neo_tets", "tact_tets", "cidx", "active", "cw",
        "Hm", "gm", "Hb", "gb", "Hn", "Gn", "Ht", "Gt", "Hr", "Gr", "g1f",
        "h1f", "idx_out", "g_out", "H_out")]
    + [("blocks", _I)])


class EvalArgs(ctypes.Structure):
    _fields_ = EVAL_FIELDS


class FuseArgs(ctypes.Structure):
    _fields_ = FUSE_FIELDS


# the blocks element_eval writes: name -> (family size key, trailing shape)
EVAL_OUTPUTS = {
    "Hm": ("nf", (9, 9)), "gm": ("nf", (3, 3)), "em": ("nf", ()),
    "Hb": ("nh", (12, 12)), "gb": ("nh", (4, 3)), "eb": ("nh", ()),
    "Hn": ("nn", (9, 9)), "Gn": ("nn", (3, 3)), "en": ("nn", ()),
    "Ht": ("nt", (9, 9)), "Gt": ("nt", (3, 3)), "et": ("nt", ()),
    "Hr": ("nc", (9, 9)), "Gr": ("nc", (3, 3)), "ec": ("nc", ()),
    "g1f": ("nc", (3,)), "h1f": ("nc", (3, 3)), "ef": ("nc", ()),
}
# the eigh-projected blocks, in the plain route's order of project_psd calls
PSD_BLOCKS = ("Hm", "Hb", "Hn", "Ht", "Hr")


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose=False) -> str:
    """Compile csrc/elements.cu with nvcc into _build/libtsl_elements.so
    when the library is missing or older than the source."""
    return _dia.build_library(_SRC, _LIB_PATH, _dia.nvcc_flags(), verbose)


def _load():
    if not _lib:
        lib = ctypes.CDLL(build())
        for name, args in (("eval", EvalArgs), ("fuse", FuseArgs)):
            for sfx in _SUFFIX.values():
                fn = getattr(lib, f"tsl_element_{name}_{sfx}")
                fn.argtypes = [ctypes.POINTER(args), ctypes.c_void_p]
                fn.restype = ctypes.c_int
        _lib.append(lib)
    return _lib[0]


# --------------------------------------------------------------------------
# argument checks and layout
# --------------------------------------------------------------------------


class _Checker:
    """Checks every tensor the kernels read against one scene: no autograd
    input, the float dtype of pos, int64 indices, bool masks, contiguous,
    the expected shape, pos's device."""

    def __init__(self, pos):
        if pos.dtype not in _SUFFIX:
            raise ValueError(f"the element kernels take float32/float64 "
                             f"positions, not {pos.dtype}")
        self.dtype, self.device = pos.dtype, pos.device

    def __call__(self, name, t, shape, kind="float"):
        if t.requires_grad:
            raise ValueError(f"{name} requires grad: the element kernels "
                             "build no autograd graph")
        want = {"float": self.dtype, "index": torch.int64,
                "mask": torch.bool}[kind]
        if t.dtype != want:
            raise ValueError(f"{name}: {t.dtype}, expected {want}")
        if t.device != self.device:
            raise ValueError(f"{name} is on {t.device}, pos on {self.device}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if t.dim() != 1 and shape is None:
            raise ValueError(f"{name}: {t.dim()} dimensions, expected 1")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        return t.data_ptr()


def eval_args(spec, params, pos, ref_angle, contact, spd):
    """(EvalArgs, outputs): the checked element_eval arguments of one
    all_groups(with_hess=True) call and its freshly allocated output blocks
    (EVAL_OUTPUTS). Raises ValueError on an input the kernels do not take.
    The struct holds raw pointers: keep the inputs and outputs alive while
    it is used."""
    chk = _Checker(pos)
    c = spec.cloth
    NV = spec.NV
    nf, nh = c.f2v.shape[0], c.hinge_verts.shape[0]
    nc = contact.idx.shape[0]
    a = EvalArgs(nv=NV, nf=nf, nh=nh, nc=nc, spd=int(bool(spd)),
                 k_contact=spec.k_contact, eps_contact=spec.eps_contact,
                 eh=spec.eps_v * spec.dt)
    a.pos = chk("pos", pos, (NV, 3))
    a.f2v = chk("cloth.f2v", c.f2v, (nf, 3), "index")
    a.cloth_id = chk("cloth.cloth_id", c.cloth_id, (nf,), "index")
    a.l0 = chk("cloth.l0", c.l0, (nf, 3))
    a.rest_area = chk("cloth.rest_area", c.rest_area, (nf,))
    a.kl = chk("params.kl", params.kl, None)
    a.ka = chk("params.ka", params.ka, None)
    a.hinge_verts = chk("cloth.hinge_verts", c.hinge_verts, (nh, 4), "index")
    a.hinge_sel = chk("cloth.hinge_sel", c.hinge_sel, (nh, 4, 4))
    a.hinge_mask = chk("cloth.hinge_mask", c.hinge_mask, (nh,), "mask")
    a.canon = chk("dev.canon", spec.dev.canon, (4, 3))
    a.ref_angle = chk("ref_angle", ref_angle, (nh,))
    a.hinge_coef = chk("cloth.hinge_coef", c.hinge_coef, (nh,))
    a.hinge_cloth = chk("cloth.hinge_cloth", c.hinge_cloth, (nh,), "index")
    a.kb = chk("params.kb", params.kb, None)
    for fam, soup, mu, lam in (("neo", spec.neo, params.neo_mu,
                                params.neo_lam),
                               ("tact", spec.tact, params.tact_mu,
                                params.tact_lam)):
        n = soup.tets.shape[0]
        setattr(a, "nn" if fam == "neo" else "nt", n)
        if not n:
            continue
        setattr(a, f"{fam}_tets", chk(f"{fam}.tets", soup.tets, (n, 4),
                                      "index"))
        setattr(a, f"{fam}_B", chk(f"{fam}.B", soup.B, (n, 3, 3)))
        setattr(a, f"{fam}_W", chk(f"{fam}.W", soup.W, (n,)))
        setattr(a, f"{fam}_group", chk(f"{fam}.group", soup.group, (n,),
                                       "index"))
        setattr(a, f"{fam}_mu", chk(f"params.{fam}_mu", mu, None))
        setattr(a, f"{fam}_lam", chk(f"params.{fam}_lam", lam, None))
    a.cidx = chk("contact.idx", contact.idx, (nc, 4), "index")
    a.cw = chk("contact.w", contact.w, (nc, 3))
    a.cdx0 = chk("contact.dx0", contact.dx0, (nc, 3))
    a.ct = chk("contact.T", contact.T, (nc, 2, 3))
    a.ck = chk("contact.k", contact.k, (nc,))
    sizes = dict(nf=nf, nh=nh, nn=a.nn, nt=a.nt, nc=nc)
    out = {name: torch.empty((sizes[key], *shape), dtype=pos.dtype,
                             device=pos.device)
           for name, (key, shape) in EVAL_OUTPUTS.items()}
    for name, t in out.items():
        setattr(a, name, t.data_ptr())
    return a, out


def fuse_args(spec, contact, blocks):
    """(FuseArgs, fused): the checked element_fuse arguments for the blocks
    of element_eval (each eigh-projected or not) and the fused group's
    freshly allocated idx (E, 4), g (E, 4, 3) and H (E, 4, 4, 3, 3)."""
    pos_like = blocks["gm"]
    chk = _Checker(pos_like)
    c = spec.cloth
    n_of = {key: blocks[name].shape[0] for key, name in (
        ("nf", "gm"), ("nh", "gb"), ("nn", "Gn"), ("nt", "Gt"), ("nc", "Gr"))}
    nf, nh, nn, nt, nc = n_of.values()
    a = FuseArgs(nv=spec.NV, **n_of)
    a.f2v = chk("cloth.f2v", c.f2v, (nf, 3), "index")
    a.hinge_verts = chk("cloth.hinge_verts", c.hinge_verts, (nh, 4), "index")
    if nn:
        a.neo_tets = chk("neo.tets", spec.neo.tets, (nn, 4), "index")
    if nt:
        a.tact_tets = chk("tact.tets", spec.tact.tets, (nt, 4), "index")
    a.cidx = chk("contact.idx", contact.idx, (nc, 4), "index")
    a.active = chk("contact.active", contact.active, (nc,), "mask")
    a.cw = chk("contact.w", contact.w, (nc, 3))
    for name in ("Hm", "gm", "Hb", "gb", "Hn", "Gn", "Ht", "Gt", "Hr", "Gr",
                 "g1f", "h1f"):
        key, shape = EVAL_OUTPUTS[name]
        setattr(a, name, chk(name, blocks[name], (n_of[key], *shape)))
    E = nf + nh + nn + nt + nc
    dt, dev = pos_like.dtype, pos_like.device
    fused = {"idx": torch.empty((E, 4), dtype=torch.int64, device=dev),
             "g": torch.empty((E, 4, 3), dtype=dt, device=dev),
             "H": torch.empty((E, 4, 4, 3, 3), dtype=dt, device=dev)}
    a.idx_out, a.g_out, a.H_out = (fused[k].data_ptr()
                                   for k in ("idx", "g", "H"))
    return a, fused


# --------------------------------------------------------------------------
# the card's route
# --------------------------------------------------------------------------


def _launch(name, args, dtype, device):
    if device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, not "
                         f"{device} (the CPU takes engine/elements' "
                         "torch.func route)")
    fn = getattr(_load(), f"tsl_{name}_{_SUFFIX[dtype]}")
    err = fn(ctypes.byref(args), torch.cuda.current_stream(device).cuda_stream)
    _dia._raise_on(err, f"{name} launch")
    LAUNCHES[name] += 1


def element_eval(spec, params, pos, ref_angle, contact, spd):
    """Every family's blocks (EVAL_OUTPUTS) at pos, one launch on the
    card. spd: the friction's 2x2 projection (the eigh projection of the
    other blocks is the caller's). Raises on CPU tensors."""
    a, out = eval_args(spec, params, pos, ref_angle, contact, spd)
    _launch("element_eval", a, pos.dtype, pos.device)
    return out


def element_fuse(spec, contact, blocks):
    """The fused group {idx, g, H} of all_groups from element_eval's blocks,
    one launch on the card. Raises on CPU tensors."""
    a, fused = fuse_args(spec, contact, blocks)
    _launch("element_fuse", a, fused["g"].dtype, fused["g"].device)
    return fused
