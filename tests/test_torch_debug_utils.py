"""The port's debug and host utilities against the JAX package's (f64,
CPU): `contact_forces` and `check_differential` at the lifting scene's
golden state moved off equilibrium (the JAX runs are stored in
tests/data/debug_golden.npz, made by scripts/make_debug_bend_goldens.py:
about 80 s of eager JAX), the debug plots, `zero_params`,
`body_of_vertex`, `rotmat_to_quat`, the GelSight projections and readers,
the PLY writer, `get_score`, and the profiling helpers.
"""
import json
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from thinshelllab_tpu.core import spec as jspec
from thinshelllab_tpu.io import tetfile as jtetfile
from thinshelllab_tpu.scenes import folding as jfolding
from thinshelllab_tpu.scenes import registry as jregistry
from thinshelllab_tpu.utils import gelsight as jgelsight
from thinshelllab_tpu.utils import profiling as jprofiling
from thinshelllab_tpu.utils import quaternion as jquat
from thinshelllab_torch.core import spec
from thinshelllab_torch.engine.debug import check_differential
from thinshelllab_torch.io import tetfile
from thinshelllab_torch.render import debug_plots
from thinshelllab_torch.scenes import folding, registry
from thinshelllab_torch.utils import gelsight, profiling, quaternion
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "debug_golden.npz")
# contact forces: the largest is ~0.3 N; both packages sum the same terms
# in another order
FORCE_RTOL = 1e-12
# check_differential's energy differences, relative (the same arithmetic
# in another order; the differences are ~2e-5 J of energies ~1 J)
DE_RTOL = 1e-9
# elementwise helpers on the same inputs
HOST_ATOL = 1e-14


@pytest.fixture(scope="module")
def lifting():
    """The port's lifting scene on the CPU at the golden state."""
    gold = np.load(GOLDEN)
    sc = registry.make_scene("lifting")
    sp, s0, params = sc.to("cpu")
    st = s0.replace(pos=torch.as_tensor(gold["pos"]))
    return sp, params, st, gold


def test_contact_forces_match_jax(lifting):
    sp, params, st, gold = lifting
    f = debug_plots.contact_forces(sp, params, st).numpy()
    want = gold["contact_forces"]
    big = np.abs(want).max()
    assert big > 0
    assert np.count_nonzero(np.abs(f).max(axis=1)) > 0
    np.testing.assert_allclose(f, want, rtol=0, atol=FORCE_RTOL * big)


def test_check_differential_matches_jax(lifting):
    sp, params, st, gold = lifting
    out = check_differential(sp, params, st, verbose=False)
    assert set(out) == {"dE_fd", "dE_analytic", "grad_rel_err",
                        "hess_rel_err"}
    for k in ("dE_fd", "dE_analytic"):
        assert abs(out[k] - float(gold[k])) <= DE_RTOL * abs(float(gold[k])), k
    # the reference's own thresholds (tests/test_collision.py)
    assert out["grad_rel_err"] < 1e-4 and out["hess_rel_err"] < 1e-3
    assert abs(out["hess_rel_err"] - float(gold["hess_rel_err"])) <= 1e-6


def test_debug_plots_write_images(tmp_path):
    """The three reference diagnostics write decodable images with
    something drawn, from a scene moved to the CPU."""
    sc = folding.make(table_n=4, max_newton_iter=2)
    sp, s0, params = sc.to("cpu")
    pad = sp.n_bodies - 1
    paths = [
        debug_plots.debug_plot(sp, s0.pos, 0, str(tmp_path / "dbg.png"),
                               normals=True),
        debug_plots.plot_contact_force(sp, params, s0, pad,
                                       str(tmp_path / "cf.png")),
        debug_plots.plot_normal(sp, s0.pos, pad, str(tmp_path / "nrm.png")),
    ]
    for p in paths:
        img = np.asarray(Image.open(p).convert("RGB"))
        assert img.shape == (480, 640, 3)
    assert (np.asarray(Image.open(paths[0])) != 255).any()
    assert (np.asarray(Image.open(paths[2]))[..., 1] == 0).any()  # red
    assert np.isfinite(debug_plots.contact_forces(sp, params, s0).numpy()).all()


def test_zero_params_and_body_of_vertex():
    jsc = jfolding.make(table_n=4)
    sc = folding.make(table_n=4)
    want = jspec.zero_params(jsc.spec)
    got = spec.zero_params(sc.spec)
    for name in ("kl", "ka", "kb", "neo_mu", "neo_lam", "tact_mu",
                 "tact_lam", "mu_pairs"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=HOST_ATOL)
    for i in (0, 5, sc.spec.NV // 2, sc.spec.NV - 1):
        assert spec.body_of_vertex(sc.spec, i) == jspec.body_of_vertex(
            jsc.spec, i)
    with pytest.raises(ValueError):
        spec.body_of_vertex(sc.spec, sc.spec.NV)


def test_rotmat_to_quat_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((16, 4))
    q[:, 0] = np.abs(q[:, 0]) + 0.5
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    m = np.array(jquat.quat_to_rotmat(jnp.asarray(q)))
    got = quaternion.rotmat_to_quat(torch.as_tensor(m)).numpy()
    np.testing.assert_allclose(got, np.asarray(jquat.rotmat_to_quat(
        jnp.asarray(m))), rtol=0, atol=HOST_ATOL)
    np.testing.assert_allclose(got, q, rtol=0, atol=1e-12)


def test_gelsight_matches_jax():
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((40, 3)) * 0.01
    pts[:, 2] = np.abs(pts[:, 2]) + 0.005
    pts[0, :2] = 0.0  # on the optical axis
    kw = dict(f=2.0, center=(0.1, -0.2))
    uv = gelsight.fisheye_project(torch.as_tensor(pts), **kw).numpy()
    np.testing.assert_allclose(
        uv, np.asarray(jgelsight.fisheye_project(jnp.asarray(pts), **kw)),
        rtol=0, atol=HOST_ATOL)
    back = gelsight.fisheye_unproject(torch.as_tensor(uv), 0.01, **kw).numpy()
    np.testing.assert_allclose(
        back, np.asarray(jgelsight.fisheye_unproject(jnp.asarray(uv), 0.01,
                                                     **kw)),
        rtol=0, atol=HOST_ATOL)
    idx = np.array([0, 3, 7, 11])
    after = pts + 1e-4 * rng.standard_normal(pts.shape)
    got = gelsight.marker_displacements(torch.as_tensor(idx),
                                        torch.as_tensor(pts),
                                        torch.as_tensor(after)).numpy()
    np.testing.assert_allclose(got, np.asarray(jgelsight.marker_displacements(
        jnp.asarray(idx), jnp.asarray(pts), jnp.asarray(after))), rtol=0,
        atol=HOST_ATOL)


def test_ply_readers_and_score(tmp_path):
    rng = np.random.default_rng(2)
    pos = rng.standard_normal((7, 3))
    faces = rng.integers(0, 7, (5, 3))
    tetfile.save_cloth_mesh_ply(torch.as_tensor(pos), faces,
                                str(tmp_path / "t.ply"))
    jtetfile.save_cloth_mesh_ply(pos, faces, str(tmp_path / "j.ply"))
    assert ((tmp_path / "t.ply").read_bytes()
            == (tmp_path / "j.ply").read_bytes())

    h5 = str(tmp_path / "cap.h5")
    with h5py.File(h5, "w") as f:
        f["force_measure"] = rng.standard_normal((6, 3))
        f["tool_pose"] = rng.standard_normal((6, 7))
    np.testing.assert_array_equal(tetfile.read_gelsight_force(h5),
                                  jtetfile.read_gelsight_force(h5))
    np.testing.assert_array_equal(tetfile.read_gelsight_pose(h5),
                                  jtetfile.read_gelsight_pose(h5))

    npy = str(tmp_path / "plot_data.npy")
    np.save(npy, rng.standard_normal(9))
    for step, cm in ((5, False), (9, True)):
        assert tetfile.get_score(npy, step, cm) == jtetfile.get_score(
            npy, step, cm)


def test_profiling_helpers(tmp_path):
    """compiled_stats counts a (64, 32) @ (32, 16) product as 65,536 flops,
    as XLA's cost analysis does; PhaseTimer reports like the JAX one; the
    trace is written as Chrome JSON."""
    a, b = np.ones((64, 32)), np.ones((32, 16))
    got = profiling.compiled_stats(torch.matmul, torch.as_tensor(a),
                                   torch.as_tensor(b))
    want = jprofiling.compiled_stats(jnp.matmul, jnp.asarray(a),
                                     jnp.asarray(b))["cost"]
    want = want[0] if isinstance(want, list) else want
    assert got["cost"]["flops"] == 65536 == int(want["flops"])
    assert got["memory"]["peak_bytes"] is None

    pt, jpt = profiling.PhaseTimer(), jprofiling.PhaseTimer()
    x = torch.ones(3)
    with pt.phase("a", sync=(x, x)):
        pass
    with jpt.phase("a", sync=jnp.ones(3)):
        pass
    assert pt.counts == jpt.counts and len(pt.report().split(":")) == 2

    with profiling.device_trace(str(tmp_path / "tr")):
        torch.ones(64).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_jax_reference_state_is_lifting():
    """The golden's input is lifting.pos[-1] of scenes_golden.npz plus the
    seeded 2e-4 m noise on the unfrozen rows (the golden script's rule)."""
    gold = np.load(GOLDEN)
    scenes = np.load(os.path.join(os.path.dirname(__file__), "data",
                                  "scenes_golden.npz"))
    frozen = np.asarray(jregistry.make_scene("lifting").spec.frozen)
    d = gold["pos"] - scenes["lifting.pos"][-1]
    assert (d[frozen] == 0).all()
    assert 1e-5 < np.abs(d[~frozen]).max() < 2e-3
    assert jax.config.jax_enable_x64
