"""The launch geometry of the preconditioner kernel
(thinshelllab_torch.ops.dia_spmv.precond_plan), on the CPU.

The kernel itself runs only on the card (test_torch_kernels_cuda.py); here
the plan is checked at the bench scene's DIA plans (cloth_N 8, 24, 70) in
f32 and f64 for an H100 (132 SMs, 232,448 bytes of shared memory a block,
one CTA per SM at that budget), and a blocked model of the kernel, built
from the plan (per-CTA windows of z, staged and global lanes, ping-pong),
is held against the plain polynomial.
"""
import dataclasses

import numpy as np
import pytest
import torch

from thinshelllab_torch.ops import dia_spmv as K
from thinshelllab_torch.scenes import bench_scene

SMS, SMEM_LIMIT = 132, 232448


@pytest.fixture(scope="module", params=[8, 24, 70], ids=lambda n: f"N{n}")
def dia_plan(request):
    N = request.param
    return bench_scene.make(cloth_N=N, table_n=12 if N == 70 else 4).spec.dia


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
def test_plan_covers_rows_and_fits(dia_plan, itemsize):
    NVp, n_off = dia_plan.NVp, len(dia_plan.offsets)
    plan = K.precond_plan(NVp, n_off, itemsize, SMS, SMEM_LIMIT,
                          dia_plan.max_abs_off)
    assert plan.rows % 4 == 0 and plan.rows > 0
    # every row belongs to exactly one CTA, and no CTA is empty
    owned = [np.arange(b * plan.rows, min((b + 1) * plan.rows, NVp))
             for b in range(plan.grid)]
    assert np.array_equal(np.concatenate(owned), np.arange(NVp))
    assert min(len(o) for o in owned) > 0
    # the grid is co-resident: at most one CTA per SM at this budget
    assert plan.grid <= SMS
    # staged lanes and the CTA's other arrays fit the per-block budget
    assert 0 <= plan.staged <= n_off
    assert plan.smem_bytes == K.precond_smem_bytes(
        plan.rows, plan.groups, plan.staged, plan.max_off, n_off, itemsize)
    assert plan.smem_bytes <= SMEM_LIMIT
    if plan.staged < n_off:  # one lane more would not fit
        assert K.precond_smem_bytes(plan.rows, plan.groups, plan.staged + 1,
                                    plan.max_off, n_off,
                                    itemsize) > SMEM_LIMIT
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert plan.rows * plan.groups <= plan.threads
    assert plan.max_off == dia_plan.max_abs_off


def test_f32_bench_store_is_held_whole():
    plan = bench_scene.make(cloth_N=70, table_n=12).spec.dia
    f32 = K.precond_plan(plan.NVp, len(plan.offsets), 4, SMS, SMEM_LIMIT,
                         plan.max_abs_off)
    assert (plan.NVp, len(plan.offsets), plan.max_abs_off) == (6144, 71, 142)
    assert (f32.rows, f32.grid, f32.staged) == (48, 128, 71)
    # the f64 store (31.4 MB) is more than the card's shared memory
    f64 = K.precond_plan(plan.NVp, len(plan.offsets), 8, SMS, SMEM_LIMIT,
                         plan.max_abs_off)
    assert 0 < f64.staged < 71


def test_more_ctas_per_sm_shrink_the_rows():
    plan = K.precond_plan(6144, 71, 4, SMS, SMEM_LIMIT, 142, blocks_per_sm=2)
    assert plan.grid <= 2 * SMS and plan.rows == 24


@pytest.mark.parametrize("args", [
    dict(NVp=6002),                     # rows not in 16-byte slices
    dict(max_abs_off=40000),            # the z window alone overflows
    dict(sms=0),                        # no CTA fits
])
def test_plan_refuses(args):
    kw = dict(NVp=6144, n_off=71, itemsize=4, sms=SMS,
              smem_limit=SMEM_LIMIT, max_abs_off=142)
    kw.update(args)
    with pytest.raises(ValueError):
        K.precond_plan(**kw)


def _blocked_precond(dia, r, unf, dinv, offsets, w, sweeps, plan):
    """The kernel's decomposition in numpy: CTA b owns rows
    [b R, (b + 1) R), reads z through its window [b R - P, (b + 1) R + P)
    (zero outside the rows), staged lanes from its copy of the store, the
    rest from the store itself, and ping-pongs z between two buffers."""
    n_off, _, _, NVp = dia.shape
    R, P, G = plan.rows, plan.max_off, plan.groups
    held = plan.staged if sweeps else 0
    bufs = [np.full((3, NVp), np.nan), np.full((3, NVp), np.nan)]
    bufs[0][:] = w * np.einsum("ijn,jn->in", dinv, r)
    copies = [dia[:held, :, :, b * R:(b + 1) * R].copy()
              for b in range(plan.grid)]
    for k in range(1, sweeps + 1):
        zin, zout = bufs[(k + 1) % 2], bufs[k % 2]
        new = np.empty_like(zout)
        for b in range(plan.grid):
            rows = np.arange(b * R, min((b + 1) * R, NVp))
            m = np.arange(b * R - P, (b + 1) * R + P)
            win = np.zeros((3, m.size))
            ok = (m >= 0) & (m < NVp)
            win[:, ok] = zin[:, m[ok]]
            part = np.zeros((G, 3, rows.size))
            for o in range(n_off):
                d = (copies[b][o] if o < held
                     else dia[o][:, :, rows])[:, :, :rows.size]
                x = win[:, rows - b * R + P + offsets[o]]
                part[o % G] += np.einsum("ijn,jn->in", d, x)
            s = r[:, rows] - unf[:, rows] * part.sum(0)
            new[:, rows] = win[:, P:P + rows.size] + w * np.einsum(
                "ijn,jn->in", dinv[:, :, rows], s)
        zout[:] = new
    return bufs[sweeps % 2]


@pytest.mark.parametrize("sweeps", [0, 1, 2, 3])
@pytest.mark.parametrize("NVp,staged", [(1024, None), (1012, 5)],
                         ids=["held_whole", "ragged_spill"])
def test_blocked_model_matches_plain(sweeps, NVp, staged):
    """The plan's geometry carries the whole polynomial: windows wide
    enough, every row updated once, the staged/global split exact."""
    rng = np.random.default_rng(0)
    offsets = (-57, -30, -1, 0, 1, 29, 57)
    n_off = len(offsets)
    dia = rng.normal(size=(n_off, 3, 3, NVp))
    dinv = 0.1 * rng.normal(size=(3, 3, NVp))
    unf = (rng.random((3, NVp)) > 0.1).astype(float)
    r = rng.normal(size=(3, NVp)) * unf
    plan = K.precond_plan(NVp, n_off, 8, SMS, SMEM_LIMIT, 57)
    if staged is not None:
        plan = dataclasses.replace(plan, staged=staged)
    got = _blocked_precond(dia, r, unf, dinv, offsets, 0.8, sweeps, plan)
    want = K.dia_precond_plain(*(torch.as_tensor(a) for a in
                                 (dia, r, unf, dinv)),
                               offsets, 0.8, sweeps).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
