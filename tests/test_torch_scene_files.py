"""The port's own data files and its default device, on the CPU."""
import filecmp
import os

import pytest
import torch

from thinshelllab_torch.io import tetfile
from thinshelllab_torch.scenes import bench_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("ext", ["node", "ele", "face"])
def test_tactile_mesh_is_the_reference_copy(ext):
    """The port reads the tactile pad from its own data/ directory; the
    files are byte for byte those of the JAX package."""
    mine = tetfile.data_path(f"tactile.{ext}")
    assert os.path.dirname(mine) == os.path.join(ROOT, "thinshelllab_torch",
                                                 "data")
    ref = os.path.join(ROOT, "thinshelllab_tpu", "data", f"tactile.{ext}")
    assert filecmp.cmp(mine, ref, shallow=False)


@pytest.fixture(scope="module")
def small_scene():
    return bench_scene.make(cloth_N=8, table_n=4, dtype=torch.float64)


def test_default_device_without_a_card_raises(small_scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        small_scene.to()
    with pytest.raises(RuntimeError, match="CUDA"):
        small_scene.to(dtype=torch.float32)


def test_cpu_on_request(small_scene):
    spec, s0, params = small_scene.to("cpu")
    assert s0.pos.device.type == "cpu" and s0.pos.dtype == torch.float64
    assert spec.dev.unf2.device.type == "cpu"
