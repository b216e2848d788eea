"""The port's host-side scene build against the JAX package's: every numpy
leaf of bench_scene.make equal exactly (DIA plan, pull slots, contact
table, soups, gripper), the static fields equal, the converter carrying a
JAX-built scene across unchanged, and the port importing no JAX."""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinshelllab_tpu.scenes import bench_scene as jbench
from thinshelllab_torch.core import convert
from thinshelllab_torch.io import tetfile
from thinshelllab_torch.scenes import bench_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(cloth_N=8, table_n=4, solver="cg", hess_refresh=8,
             max_newton_iter=4)
BENCH = dict(cloth_N=70, table_n=12, hess_refresh=8, fwd_tol=1e-3,
             max_newton_iter=8)  # bench.py:85-100


def _leaves(obj, path=""):
    """(path, value) of every dataclass leaf, nested dataclasses expanded."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        p = f"{path}.{f.name}"
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, p)
        else:
            yield p, v


def _assert_same(ours, ref):
    """Every array leaf equal in dtype, shape and value; every static field
    equal (the dtype and the SpMV route compared under the port's names).
    The port's spec has one field more, `dev`, empty on the host spec."""
    got, want = dict(_leaves(ours)), dict(_leaves(ref))
    assert got.pop(".dev", None) is None and want.pop(".dev", None) is None
    assert got.keys() == want.keys()
    n_arrays = 0
    for p, w in want.items():
        g = got[p]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), p
            assert g.dtype == w.dtype and g.shape == w.shape, (
                p, g.dtype, w.dtype, g.shape, w.shape)
            np.testing.assert_array_equal(g, w, err_msg=p)
            n_arrays += 1
        elif p.endswith(".dtype"):
            assert g == convert.torch_dtype(w), p
        elif p.endswith(".spmv"):
            assert g == {"auto": "auto", "pallas": "kernel",
                         "xla": "plain"}[w], p
        else:
            assert g == w, (p, g, w)
    return n_arrays


@pytest.mark.parametrize("kw", [SMALL, BENCH], ids=["cloth8", "bench70"])
def test_builder_leaves_match_jax(kw):
    ours = bench_scene.make(dtype=torch.float64, **kw)
    ref = jbench.make(dtype=jnp.float64, **kw)
    for a, b in ((ours.spec, ref.spec), (ours.state0, ref.state0),
                 (ours.params, ref.params)):
        assert _assert_same(a, b) > 0
    assert ours.spec.dia is not None and ours.spec.hvp_slots is not None


def test_bench_scene_size():
    """The full bench scene's sizes (bench.py's configuration)."""
    s = bench_scene.make(dtype=torch.float32, **BENCH).spec
    assert s.NV == 5605 and s.faces.shape[0] == 10572
    assert s.dia.NVp == 6144 and len(s.dia.offsets) == 71
    assert s.dia.max_abs_off == 142
    assert s.hvp_slots.row_ids.shape[0] == 276 and s.hvp_slots.D == 78
    assert s.contact.capacity == 10752
    assert s.cloth.hinge_verts.shape[0] == 29400
    assert s.neo.tets.shape[0] + s.tact.tets.shape[0] == 605 + 1365
    assert (s.precond_smooth, s.precond_omega, s.spd_method) == (3, 0.8,
                                                                 "shift")
    assert (s.solver, s.cg_max_iter, s.fwd_tol, s.hess_refresh) == (
        "cg", 200, 1e-3, 8)
    # every contact pair takes the dense broadphase
    assert all(nf < s.contact.hash_min_faces
               for (_c, _n, _f, nf, _s) in s.contact.pair_desc)


def test_convert_carries_a_jax_scene_across():
    ours = bench_scene.make(dtype=torch.float64, **SMALL)
    ref = jbench.make(dtype=jnp.float64, **SMALL)
    for a, b in ((ours.spec, ref.spec), (ours.state0, ref.state0),
                 (ours.params, ref.params)):
        c = convert.from_reference(b)
        assert type(c) is type(a)
        assert _assert_same(c, b) > 0
        assert _assert_same(c, a) > 0
    spec = convert.from_reference(ref.spec).to("cpu")
    assert spec.mass.dtype == torch.float64 and spec.dev.offsets_t.dtype == \
        torch.int32
    assert spec.dia.rows.dtype == torch.int64 and spec.frozen.dtype == \
        torch.bool

    @dataclasses.dataclass
    class ContactSpec:  # a reference class with a field the port lacks
        bogus: int = 0

    with pytest.raises(TypeError, match="bogus"):
        convert.from_reference(ContactSpec())


def test_moved_spec_holds_device_tensors():
    sc = bench_scene.make(dtype=torch.float32, **SMALL)
    spec, state, params = sc.to("cpu", torch.float64)
    assert spec.dtype == torch.float64 and spec.dev is not None
    for p, v in _leaves(spec):
        assert not isinstance(v, np.ndarray), p
    assert state.pos.dtype == params.kl.dtype == torch.float64
    assert sc.spec.dev is None  # the host spec is left as it was


def test_tetfile_reads_the_shared_mesh_files():
    n, nodes = tetfile.read_node(tetfile.data_path("tactile.node"))
    m, tets = tetfile.read_ele(tetfile.data_path("tactile.ele"))
    assert n == nodes.shape[0] > 0 and nodes.dtype == np.float64
    assert m == tets.shape[0] > 0 and tets.dtype == np.int32
    assert 0 <= tets.min() and tets.max() < n


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import thinshelllab_torch as t\n"
        "names = [m.name for m in pkgutil.walk_packages(t.__path__, "
        "'thinshelllab_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'thinshelllab_tpu'))\n"
        "assert len(names) > 20 and not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('ok', len(names))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_reward_and_seed_loss_match_jax():
    ours = bench_scene.make(dtype=torch.float64, **SMALL)
    ref = jbench.make(dtype=jnp.float64, **SMALL)
    pos = np.load(os.path.join(ROOT, "tests", "data",
                               "bench8_golden.npz"))["pos"]
    got = ours.reward({"pos": torch.as_tensor(pos)})
    np.testing.assert_allclose(float(got),
                               float(ref.reward({"pos": jnp.asarray(pos)})),
                               rtol=1e-14)
    for g, w in zip(ours.seed_loss({"pos": torch.as_tensor(pos)}),
                    ref.seed_loss({"pos": jnp.asarray(pos)})):
        assert g.dtype == torch.float64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
