"""The port's spatial-hash broadphase and self-contact against the JAX
package's, in f64 on the CPU.

  * the hash's grid and candidate tables on seeded random centroids;
  * the hash projection on `bench_scene.make(cloth_N=32, solver="cg")`
    (2,048 cloth faces, forced onto the hash with hash_min_faces=0) at the
    rest, settled and wrinkled states of the JAX package's
    tests/test_collision.py::test_spatial_hash_broadphase_matches_dense,
    against the exhaustive dense sweep (top_k = max_src_faces), by that
    test's criterion: flags and directions equal, projection distances on
    the hash pairs' found rows within 1.01e-5 m (exact ties inside the 1e-5
    near-window may pick another face at the same distance), at most
    max(5, 2%) of those rows on another face; and against the JAX
    package's hash projection by the same criterion less its count. Which
    face of a tie wins depends on the last bit of the face scores, so the
    count differs between any two roundings: at the settled state the JAX
    package's own jitted and eager projections already differ on more
    than 2% of the found rows, each pick within the window;
  * the per-cell cap at grid_h=0.02 (tests/test_collision.py:312);
  * the self-contact hairpin (scenes/hairpin.py, the scene of
    tests/test_collision.py:226): the spec leaf by leaf, and against the
    JAX package's run kept in tests/data/hairpin_golden.npz (its implicit
    step's compile takes most of a minute): flags, faces and weights
    equal, the energy gradient within 1e-12 of its largest entry, one
    implicit step within 1e-9 m. chip_smoke.py's [self-contact] phase
    reads the same file (the card's machine has no JAX).

tests/data/hash40k_golden.npz keeps the JAX package's hash projection of
the 40k-triangle bench (`bench_scene.make(cloth_N=140, table_n=12)`, f64,
its initial positions, unlatched flags) for chip_smoke.py's [bench-40k]
phase. Regenerate both files (after a deliberate change of the
reference):

    PYTHONPATH=. python tests/test_torch_collision_hash.py
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinshelllab_tpu.core.builder import SceneBuilder as JSceneBuilder
from thinshelllab_tpu.engine import elements as jelements
from thinshelllab_tpu.engine import stepper as jstepper
from thinshelllab_tpu.ops import collision as jcollision
from thinshelllab_tpu.scenes import bench_scene as jbench
from thinshelllab_torch.ops import collision
from thinshelllab_torch.scenes import bench_scene, hairpin
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "hairpin_golden.npz")
# the JAX test's criterion (tests/test_collision.py:181-222)
DIST_ATOL = 1.01e-5


def test_hash_tables_match_jax():
    """_hash_grid (origin, stable-sorted cell ids, permutation) and
    _hash_candidates (candidate faces and their mask, the duplicate cells
    of clamped neighbourhoods masked) equal the JAX package's on seeded
    random centroids with many shared cells, and at grid edges."""
    rng = np.random.default_rng(0)
    cent = rng.random((3000, 3)) * [0.1, 0.1, 0.01]
    q = np.concatenate([rng.random((200, 3)) * [0.12, 0.12, 0.02] - 0.01,
                        cent[:50]])
    cutoff, G, cap = 6e-3, (12, 14, 4), 48
    jgrid = jcollision._hash_grid(jnp.asarray(cent), cutoff, G)
    grid = collision._hash_grid(torch.as_tensor(cent), cutoff, G)
    for got, want in zip(grid, jgrid):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jc, jok = jcollision._hash_candidates(*jgrid, jnp.asarray(q), cutoff, G,
                                          cap)
    c, ok = collision._hash_candidates(*grid, torch.as_tensor(q), cutoff, G,
                                       cap)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(c.numpy()[ok.numpy()],
                                  np.asarray(jc)[np.asarray(jok)])
    assert ok.numpy().any(axis=1).all()


def _bench_specs():
    """The port's and the JAX package's bench cloth_N=32 specs on the hash
    (hash_min_faces=0), and the JAX spec of the exhaustive oracle."""
    jsc = jbench.make(cloth_N=32, dtype=jnp.float64, solver="cg")
    sc = bench_scene.make(cloth_N=32, dtype=torch.float64, solver="cg")
    jcon = dataclasses.replace(jsc.spec.contact, hash_min_faces=0)
    jspec = dataclasses.replace(jsc.spec, contact=jcon)
    spec, s0, _ = sc.to("cpu")
    spec = spec.replace(contact=spec.contact.replace(hash_min_faces=0))
    oracle = spec.replace(contact=spec.contact.replace(
        hash_desc=(None,) * len(jcon.hash_desc), top_k=jcon.max_src_faces))
    return jspec, spec, oracle, np.asarray(jsc.state0.pos, np.float64)


@pytest.fixture(scope="module")
def bench32():
    jspec, spec, oracle, pos0 = _bench_specs()
    C = spec.contact.capacity
    jz = jnp.zeros((C,), jnp.int32)
    jproject = jax.jit(lambda x: jcollision.projection_query(
        jspec, x, jcollision.vertex_normals(x, jspec.faces, jspec.NV),
        jz, jz))
    return jproject, spec, oracle, pos0


def _trial_pos(pos0, trial):
    pos = pos0.copy()
    if trial == 1:  # settled: the cloth dropped onto the table
        pos[:, 2] -= 0.4 * (pos[:, 2] - pos[:, 2].min())
    if trial == 2:  # wrinkled: a smooth low-frequency warp
        pos += 2e-3 * np.stack(
            [np.sin(7 * pos[:, 0] + i) * np.cos(5 * pos[:, 1] - i)
             for i in range(3)], axis=1)
    return pos


def _hash_rows(con):
    rows = np.zeros(con.capacity, bool)
    for hd, (cqs, cnt, _, _, _) in zip(con.hash_desc, con.pair_desc):
        if hd is not None:
            rows[cqs : cqs + cnt] = True
    return rows


def assert_hash_criterion(con, pos, got, want, what, count=True):
    """The JAX test's criterion between two projections (flag, dir, tri,
    w) of the same positions (without the bound on the count of faces
    that differ, unless `count`): returns (the count of found hash rows on
    another face, the count of found hash rows)."""
    f1, d1, t1, w1 = (np.asarray(a) for a in got)
    f2, d2, t2, w2 = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(f1, f2, err_msg=f"{what} flag")
    np.testing.assert_array_equal(d1, d2, err_msg=f"{what} dir")
    m = f1.astype(bool) & _hash_rows(con)
    q = pos[np.asarray(con.cq_vert)[m]]

    def dist(t, w):
        return np.linalg.norm(q - np.einsum("ck,cki->ci", w[m], pos[t[m]]),
                              axis=1)

    np.testing.assert_allclose(dist(t1, w1), dist(t2, w2), rtol=0,
                               atol=DIST_ATOL, err_msg=f"{what} distance")
    n_mis = int((~(t1[m] == t2[m]).all(axis=1)).sum())
    assert not count or n_mis <= max(5, 0.02 * max(int(m.sum()), 1)), (
        f"{what}: {n_mis} faces differ of {int(m.sum())}")
    return n_mis, int(m.sum())


@pytest.mark.parametrize("trial", [0, 1, 2], ids=["rest", "settled",
                                                  "wrinkled"])
def test_hash_projection_matches_oracle_and_jax(bench32, trial):
    jproject, spec, oracle, pos0 = bench32
    assert sum(h is not None for h in spec.contact.hash_desc) == 2
    pos = _trial_pos(pos0, trial)
    p = torch.as_tensor(pos)
    vn = collision.vertex_normals(p, spec.faces, spec.NV)
    C = spec.contact.capacity
    z = torch.zeros((C,), dtype=torch.int64)
    got = collision.projection_query(spec, p, vn, z, z)
    ref = collision.projection_query(oracle, p, vn, z, z)
    jgot = jproject(jnp.asarray(pos))
    _, found = assert_hash_criterion(spec.contact, pos, got, ref, "oracle")
    assert found > 0 or trial == 0
    assert_hash_criterion(spec.contact, pos, got, jgot, "JAX hash",
                          count=False)


def test_hash_cap_honors_occupancy_margin():
    """At grid_h=0.02 one cell spans many faces: the port's descriptors are
    the JAX builder's, and the cap follows the 4x occupancy margin past 64
    with no clamp."""
    sc = bench_scene.make(cloth_N=32, dtype=torch.float64, solver="cg",
                          grid_h=0.02)
    jsc = jbench.make(cloth_N=32, dtype=jnp.float64, solver="cg",
                      grid_h=0.02)
    descs = [h for h in sc.spec.contact.hash_desc if h is not None]
    assert tuple(sc.spec.contact.hash_desc) == tuple(
        jsc.spec.contact.hash_desc)
    assert descs and all(cap >= 16 and cap % 8 == 0
                         for (_gx, _gy, _gz, cap) in descs)
    assert max(d[3] for d in descs) > 64, descs


@pytest.fixture(scope="module")
def hairpins():
    """The port's hairpin (built, and moved to the CPU) and the JAX
    package's build."""
    port = hairpin.make(torch.float64)
    return port, hairpin.make(jnp.float64, JSceneBuilder)


def _jax_hairpin(jspec, js0, jparams):
    """The JAX package's hairpin: projection, contact-set energy gradient
    at the initial state, and one implicit step."""
    p = jnp.asarray(js0.pos)
    C = jspec.contact.capacity
    z = jnp.zeros((C,), jnp.int32)
    vn = jcollision.vertex_normals(p, jspec.faces, jspec.NV)
    flag, pdir, tri, w = jcollision.projection_query(jspec, p, vn, z, z)
    contact, _, _ = jstepper.build_contacts(jspec, jparams, p, p, z, z)

    def en_of(pp):
        return jelements.total_energy(jspec, jparams, pp, p,
                                      jnp.zeros_like(p),
                                      jnp.asarray(js0.ref_angle), contact)

    g = jax.grad(en_of)(p * 1.0)
    action = (jnp.zeros((0, 3)), jnp.zeros((0, 3)), jnp.zeros((0,)))
    st1 = jax.jit(lambda s: jstepper.time_step(jspec, jparams, s, action)[0])(
        jax.tree.map(jnp.asarray, js0))
    return {"flag": np.asarray(flag), "dir": np.asarray(pdir),
            "tri": np.asarray(tri), "w": np.asarray(w),
            "active": np.asarray(contact.active), "grad": np.asarray(g),
            "pos1": np.asarray(st1.pos)}


def test_self_contact_hairpin_matches_jax(hairpins):
    spec, s0, params = (a.to("cpu") for a in hairpins[0])
    assert bool(spec.contact.cq_self.any())
    assert not any(spec.contact.frozen_src)
    got = hairpin.probe(spec, s0, params)
    want = np.load(GOLDEN)
    found = got["flag"].numpy().astype(bool)
    assert found.sum() > 0 and int(got["active"].sum()) > 0
    for k in ("flag", "dir", "tri", "active"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(got["w"].numpy(), want["w"], rtol=0,
                               atol=1e-12)
    # face-interior only, never on a face incident to the query vertex
    wf = got["w"].numpy()[found]
    assert (wf > 1e-9).all() and (wf < 1 - 1e-9).all()
    qf = spec.contact.cq_vert.numpy()[found]
    assert not (got["tri"].numpy()[found] == qf[:, None]).any()
    g = got["grad"].numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    scale = np.abs(want["grad"]).max()
    assert np.abs(g - want["grad"]).max() <= 1e-12 * scale
    np.testing.assert_allclose(got["pos1"].numpy(), want["pos1"], rtol=0,
                               atol=1e-9)
    top = got["pos1"].numpy()[(hairpin.M + 1) * (hairpin.N // 2 + 1):, 2]
    assert top.min() > -1e-4, "the top layer passed through the bottom"


def test_hairpin_build_matches_jax(hairpins):
    """The hairpin's spec, state and parameters, leaf by leaf: one
    self-contact pair over the cloth's own 288 faces."""
    from test_torch_scenes import _assert_close

    for a, b in zip(*hairpins):
        _assert_close(a, b)
    spec = hairpins[0][0]
    assert spec.contact.pair_desc == ((0, 169, 0, 288, True),)
    assert bool(np.asarray(hairpins[1][0].contact.cq_self).any())


def _jax_hash40k():
    """The JAX package's projection of the 40k bench's initial positions
    (f64; its two cloth-source pairs take the hash)."""
    sc = jbench.make(cloth_N=140, table_n=12, dtype=jnp.float64)
    spec = sc.spec
    p = jnp.asarray(sc.state0.pos)
    z = jnp.zeros((spec.contact.capacity,), jnp.int32)
    flag, pdir, tri, w = jax.jit(lambda x: jcollision.projection_query(
        spec, x, jcollision.vertex_normals(x, spec.faces, spec.NV), z,
        z))(p)
    return {"flag": np.asarray(flag), "dir": np.asarray(pdir),
            "tri": np.asarray(tri), "w": np.asarray(w)}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    np.savez_compressed(GOLDEN, **_jax_hairpin(
        *hairpin.make(jnp.float64, JSceneBuilder)))
    np.savez_compressed(GOLDEN.replace("hairpin", "hash40k"),
                        **_jax_hash40k())
