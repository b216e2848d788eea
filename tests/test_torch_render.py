"""The port's render modules against the JAX package's, on the CPU: the
numpy mesh operations and OBJ files, the LuisaScript export of the folding
scene, the procedural asset pack and the crease texture, and the preview
raster against matplotlib's own projection (the port draws its images
itself: `render/raster.py`, no matplotlib, PIL or imageio). The tests
decode its images with PIL and imageio.
"""
import os
import re

import imageio.v2 as imageio
import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

from thinshelllab_tpu.render import gen_assets as jgen
from thinshelllab_tpu.render import mesh_ops as jmesh
from thinshelllab_tpu.render import preview as jpreview
from thinshelllab_tpu.render import textures as jtextures
from thinshelllab_tpu.render.engine import Renderer as JRenderer
from thinshelllab_tpu.scenes import folding as jfolding
from thinshelllab_torch import cli
from thinshelllab_torch.render import gen_assets, mesh_ops, preview, raster
from thinshelllab_torch.render import textures
from thinshelllab_torch.render.engine import Renderer
from thinshelllab_torch.scenes import folding
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from mpl_toolkits.mplot3d import proj3d  # noqa: E402

# the projection against matplotlib's (float64 matrix products in another
# order)
PROJ_ATOL = 1e-9


def _decode(path):
    return np.asarray(Image.open(path).convert("RGB"))


def _sheet(n=3, m=4, seed=0):
    """A jittered n x m grid sheet, two triangles a quad."""
    rng = np.random.default_rng(seed)
    ii, jj = np.meshgrid(np.arange(n + 1), np.arange(m + 1), indexing="ij")
    verts = np.stack([ii.ravel() * 0.01, jj.ravel() * 0.01,
                      np.zeros(ii.size)], axis=1)
    verts += 1e-3 * rng.standard_normal(verts.shape)
    faces = []
    for i in range(n):
        for j in range(m):
            a = i * (m + 1) + j
            faces += [[a, a + 1, a + m + 2], [a, a + m + 2, a + m + 1]]
    return verts, np.asarray(faces, np.int64)


@pytest.fixture(scope="module")
def scenes():
    return (jfolding.make(table_n=4, max_newton_iter=2),
            folding.make(table_n=4, max_newton_iter=2))


def test_mesh_ops_match_jax(tmp_path):
    verts, faces = _sheet()
    np.testing.assert_array_equal(mesh_ops.vertex_normals(verts, faces),
                                  jmesh.vertex_normals(verts, faces))
    np.testing.assert_array_equal(mesh_ops.boundary_loop_edges(faces),
                                  jmesh.boundary_loop_edges(faces))
    for fn, args in ((mesh_ops.thicken_cloth, (verts, faces, 5e-4)),
                     (mesh_ops.subdivide, (verts, faces)),
                     (mesh_ops.process_cloth, (verts, faces, 5e-4, 2))):
        got, want = fn(*args), getattr(jmesh, fn.__name__)(*args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    uv = verts[:, :2] * 10
    for name, kw in (("plain", {}), ("uv", {"uv": uv})):
        mesh_ops.export_obj(str(tmp_path / f"t_{name}.obj"), verts, faces, **kw)
        jmesh.export_obj(str(tmp_path / f"j_{name}.obj"), verts, faces, **kw)
        assert ((tmp_path / f"t_{name}.obj").read_bytes()
                == (tmp_path / f"j_{name}.obj").read_bytes())


def test_luisa_export_matches_jax(scenes, tmp_path):
    """The folding scene's LuisaScript frame and its OBJ files are
    byte-equal to the JAX package's, apart from the two save directories
    and the two packages' asset directories; the crease-painted texture
    PNGs decode to the same pixels."""
    jsc, sc = scenes
    pos = np.asarray(jsc.state0.pos)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    jr = JRenderer(jsc, "folding", option="LuisaScript", save_dir=dj)
    tr = Renderer(sc, "folding", option="LuisaScript", save_dir=dt)
    pj, pt = jr.render("0", pos=pos), tr.render("0", pos=torch.as_tensor(pos))
    aj, at = jtextures.default_asset_dir(), textures.default_asset_dir()
    assert at.startswith(os.path.dirname(os.path.dirname(
        os.path.abspath(textures.__file__))))
    tj = open(pj).read().replace(dj, "<save>").replace(aj, "<assets>")
    tt = open(pt).read().replace(dt, "<save>").replace(at, "<assets>")
    assert "shape cloth_0" in tt and "crease_mix_0.png" in tt
    assert tt == tj
    refs = re.findall(r'file \{ "([^"]+)" \}', open(pt).read())
    for ref in refs:
        if ref.endswith(".png"):
            assert os.path.exists(ref if os.path.isabs(ref)
                                  else os.path.join(dt, ref)), ref
    objs = sorted(os.listdir(os.path.join(dj, "models_0")))
    assert objs == sorted(os.listdir(os.path.join(dt, "models_0")))
    assert len(objs) == jsc.spec.n_bodies
    for name in objs:
        with open(os.path.join(dj, "models_0", name), "rb") as a, \
                open(os.path.join(dt, "models_0", name), "rb") as b:
            assert a.read() == b.read(), name
    np.testing.assert_array_equal(_decode(os.path.join(dt, "crease_mix_0.png")),
                                  _decode(os.path.join(dj, "crease_mix_0.png")))


def test_gen_assets_match_jax(tmp_path):
    """Each stand-in asset is the JAX package's image, pixel for pixel, and
    so are the PNGs the port's writer makes of them and the copies in the
    port's data directory."""
    assert list(gen_assets.ASSETS) == list(jgen.ASSETS)
    data = os.path.join(os.path.dirname(os.path.abspath(gen_assets.__file__)),
                        os.pardir, "data", "assets")
    for rel, fn in gen_assets.ASSETS.items():
        img = fn()
        np.testing.assert_array_equal(img, jgen.ASSETS[rel]())
        p = gen_assets._save(img, str(tmp_path / rel))
        want = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(_decode(p), want)
        np.testing.assert_array_equal(_decode(os.path.join(data, rel)), want)


def test_mix_texture_matches_jax(tmp_path):
    def judge(pij):
        row = pij // 4
        return "up" if row == 7 else "down" if row == 8 else None

    img = textures.get_mix_texture(15, 3, judge, img_size=256)
    np.testing.assert_array_equal(
        img, jtextures.get_mix_texture(15, 3, judge, img_size=256))
    p = textures.save_png(img, str(tmp_path / "mix.png"))
    np.testing.assert_array_equal(_decode(p), img)


def test_projection_matches_matplotlib():
    """raster's projection and pixel mapping are matplotlib's for the
    preview's axes (6x6 in at 100 dpi, the JAX preview's limits and
    view), and for matplotlib's default 640x480 figure."""
    rng = np.random.default_rng(3)
    for size, lims, (elev, azim) in (
            ((6, 6), ((-0.08, 0.08), (-0.08, 0.08), (-0.03, 0.06)), (20, -60)),
            ((6.4, 4.8), ((-0.2, 0.1), (0.0, 0.3), (-0.01, 0.02)), (30, -60))):
        fig = plt.figure(figsize=size, dpi=100)
        ax = fig.add_subplot(projection="3d")
        ax.set_xlim(*lims[0])
        ax.set_ylim(*lims[1])
        ax.set_zlim(*lims[2])
        ax.view_init(elev=elev, azim=azim)
        ax.set_axis_off()
        fig.canvas.draw()
        M = ax.get_proj()
        pts = np.stack([rng.uniform(lo, hi, 50) for lo, hi in lims], axis=1)
        xs, ys, zs = proj3d.proj_transform(pts[:, 0], pts[:, 1], pts[:, 2], M)
        disp = ax.transData.transform(np.stack([xs, ys], axis=1))
        W, H = fig.canvas.get_width_height()
        plt.close(fig)
        view = raster.Axes3DView(lims, elev, azim, W, H)
        np.testing.assert_allclose(view.M, M, rtol=0, atol=PROJ_ATOL)
        got = [v.numpy() for v in view.project(torch.as_tensor(pts))]
        for g, w in zip(got, (xs, ys, zs)):
            np.testing.assert_allclose(g, w, rtol=0, atol=PROJ_ATOL)
        px = view.to_pixels(torch.as_tensor(pts)).numpy()
        np.testing.assert_allclose(px[:, 0], disp[:, 0], rtol=0, atol=PROJ_ATOL)
        np.testing.assert_allclose(px[:, 1], H - disp[:, 1], rtol=0,
                                   atol=PROJ_ATOL)


def test_preview_order_colors_and_gif(scenes, tmp_path):
    """The preview's colours are the JAX package's, and its painter order is
    the one the JAX package's figure paints: JAX's own order, which
    matplotlib's Poly3DCollection sorts again by depth as it draws (the
    collection's 2-D paths in drawn order against the port's projected
    faces in its order). Its frames go to PNGs and a GIF that decodes
    (imageio and raster.read_gif) to those PNGs exactly, with a 2/100 s
    delay."""
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    jsc, sc = scenes
    np.testing.assert_array_equal(preview.default_colors(sc.spec),
                                  jpreview.default_colors(jsc.spec))
    pos = np.asarray(jsc.state0.pos)
    pos = pos + 1e-3 * np.random.default_rng(0).standard_normal(pos.shape)
    faces = np.asarray(jsc.spec.faces)
    cam = np.asarray((-0.2, 0.2, 0.05))
    want = np.argsort(-np.linalg.norm(pos[faces].mean(axis=1) - cam, axis=1))
    lims = ((-0.08, 0.08), (-0.08, 0.08), (-0.03, 0.06))
    fig = plt.figure(figsize=(6, 6), dpi=100)
    ax = fig.add_subplot(projection="3d")
    coll = Poly3DCollection(pos[faces][want], edgecolors="none")
    ax.add_collection3d(coll)
    ax.set_xlim(*lims[0])
    ax.set_ylim(*lims[1])
    ax.set_zlim(*lims[2])
    ax.view_init(elev=20, azim=-60)
    ax.set_axis_off()
    fig.canvas.draw()
    drawn = np.stack([p.vertices[:3] for p in coll.get_paths()])
    plt.close(fig)
    view = raster.Axes3DView(lims)
    order = preview.painter_order(pos, faces, cam, view.M)
    assert sorted(order) == list(range(len(faces)))
    xs, ys, _ = view.project(torch.as_tensor(pos))
    got = np.stack([xs.numpy(), ys.numpy()], axis=1)[faces[order]]
    np.testing.assert_allclose(got, drawn, rtol=0, atol=PROJ_ATOL)

    r = Renderer(sc, "folding", option="Preview", save_dir=str(tmp_path))
    pos = np.asarray(jsc.state0.pos)
    pos2 = pos.copy()
    pos2[:, 2] += 0.002
    paths = [r.render("0", pos=torch.as_tensor(pos)),
             r.render("1", pos=torch.as_tensor(pos2))]
    gif = r.end_rendering(0)
    pngs = [_decode(p) for p in paths]
    assert pngs[0].shape == (600, 600, 3)
    assert not np.array_equal(pngs[0], pngs[1])
    # the table's and the pad's colours are drawn
    rgb = raster.to_uint8(preview.default_colors(sc.spec))
    for c in {tuple(x) for x in rgb} - {(255, 255, 255)}:
        assert (pngs[0] == np.asarray(c)).all(axis=2).any(), c
    frames = imageio.mimread(gif)
    assert len(frames) == 2
    for f, p in zip(frames, pngs):
        np.testing.assert_array_equal(np.asarray(f)[..., :3], p)
    mine, delays = raster.read_gif(gif)
    assert delays == [2, 2]
    for f, p in zip(mine, pngs):
        np.testing.assert_array_equal(f, p)
    np.testing.assert_array_equal(raster.read_png(paths[0]), pngs[0])


def test_gif_many_colours(tmp_path):
    """LZW with code-table resets (noise over 256 colours) and the colour
    cube past 256 colours both decode with PIL as written."""
    rng = np.random.default_rng(0)
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    frames = [pal[rng.integers(0, 256, (64, 80))] for _ in range(2)]
    p = raster.write_gif(str(tmp_path / "a.gif"), frames)
    for k, f in enumerate(imageio.mimread(p)):
        np.testing.assert_array_equal(np.asarray(f)[..., :3], frames[k])
    np.testing.assert_array_equal(raster.read_gif(p)[0][1], frames[1])
    many = rng.integers(0, 256, (40, 30, 3)).astype(np.uint8)
    p = raster.write_gif(str(tmp_path / "b.gif"), [many])
    cube = (np.floor(many / 51 + 0.5) * 51).astype(np.uint8)
    np.testing.assert_array_equal(
        np.asarray(Image.open(p).convert("RGB")), cube)


def test_fill_triangles_painter_order():
    """Later triangles paint over earlier ones; a pixel is covered when its
    centre lies in the triangle (edges included); the box clips."""
    tri = torch.tensor([[[0.0, 0.0], [8.0, 0.0], [0.0, 8.0]],
                        [[2.0, 2.0], [10.0, 2.0], [2.0, 10.0]],
                        [[1.0, 1.0], [1.0, 1.0], [5.0, 5.0]]],
                       dtype=torch.float64)
    rank = raster.fill_triangles(tri, 12, 12).numpy()
    assert rank[0, 0] == 0 and rank[2, 2] == 1 and rank[11, 11] == -1
    # pixel (r, c) centre (c + 0.5, r + 0.5): x + y <= 8 for the first
    assert rank[0, 7] == 0 and rank[0, 8] == -1
    assert (rank == 2).sum() == 0  # degenerate
    clipped = raster.fill_triangles(tri, 12, 12, box=(0, 0, 4, 4)).numpy()
    assert (clipped[:, 4:] == -1).all() and (clipped[4:] == -1).all()
    img = raster.paint(torch.as_tensor(rank), np.array(
        [[255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8)).numpy()
    np.testing.assert_array_equal(img[2, 2], [0, 255, 0])
    np.testing.assert_array_equal(img[11, 11], [255, 255, 255])


def test_cli_render_and_trajopt_render_every(tmp_path):
    """`cli render` writes frames 0..T and GIF_0.gif (Preview) or a script
    and OBJ files a frame (LuisaScript); `cli trajopt --render_every`
    renders the optimised rollout."""
    common = ["--platform", "cpu", "--env", "folding", "--max_newton_iter",
              "2"]
    d = str(tmp_path / "p")
    cli.main(["render", *common, "--frames", "1", "--save_dir", d])
    assert sorted(os.listdir(d)) == ["0.png", "1.png", "GIF_0.gif"]
    d = str(tmp_path / "l")
    cli.main(["render", *common, "--frames", "1", "--save_dir", d,
              "--render_option", "LuisaScript"])
    assert {"scene_0.luisa", "scene_1.luisa", "models_0",
            "models_1"} <= set(os.listdir(d))
    d = str(tmp_path / "t")
    cli.main(["trajopt", *common, "--tot_step", "2", "--iter", "1",
              "--render_every", "1", "--save_dir", d])
    assert {"0.png", "1.png", "GIF_0.gif"} <= set(os.listdir(d))
    assert len(imageio.mimread(os.path.join(d, "GIF_0.gif"))) == 2

