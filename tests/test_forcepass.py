"""The dense cell-layout pair pass: the layout's cell counts and the row
blocking of the pair math."""

import jax.numpy as jnp
import numpy as np
import pytest

from pedoni_tpu.ops import forcepass
from pedoni_tpu.ops.neighbor import CellGrid, compute_cell_ids
from pedoni_tpu.physics import Physics

GRID = CellGrid(unit=1.4, nx=9, ny=7)


def _agents(kind: str, n: int = 300, seed: int = 0):
    rng = np.random.default_rng(seed)
    w, h = GRID.nx * GRID.unit, GRID.ny * GRID.unit
    if kind == "clustered":
        pos = rng.normal((w / 3, h / 2), 0.8, (n, 2))
    else:
        pos = rng.uniform(0.0, (w, h), (n, 2))
    active = np.ones(n, bool)
    if kind == "with_dead":
        active[::3] = False  # inactive slots
        pos[1::7] = (-5.0, 2.0)  # off the grid
    return pos.astype(np.float32), active


def _layout(pos, active, k):
    cid = compute_cell_ids(jnp.asarray(pos), jnp.asarray(active), GRID)
    order = jnp.argsort(cid, stable=True)
    cid_sorted = cid[order]
    return forcepass.build_layout(cid_sorted, jnp.asarray(active)[order],
                                  GRID, k), np.asarray(cid)


@pytest.mark.parametrize("kind", ["uniform", "clustered", "with_dead"])
def test_max_demand_matches_bincount(kind):
    """max_count is the fullest cell's population (whatever K is), and
    n_overflow the agents past K — both as a NumPy bincount says."""
    pos, active = _agents(kind)
    k = 6
    layout, cid = _layout(pos, active, k)
    counts = np.bincount(cid[cid < GRID.n_cells], minlength=GRID.n_cells)
    assert int(layout.max_count) == counts.max()
    assert int(layout.n_overflow) == np.maximum(counts - k, 0).sum()
    assert int(np.asarray(layout.valid).sum()) == np.minimum(counts, k).sum()


def _vel_e(n, seed=1):
    rng = np.random.default_rng(seed)
    vel = rng.normal(0.0, 0.5, (n, 2)).astype(np.float32)
    e = rng.normal(0.0, 1.0, (n, 2)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    return jnp.asarray(vel), jnp.asarray(e)


@pytest.mark.parametrize("row_block", [1, 2, 3, 5])
def test_row_blocking_is_exact(row_block):
    """Every row-block size gives the one-block result: blocks only
    split the cell rows (7 rows, so 2, 3 and 5 also pad).  The compiled
    reduction order may change with the block shape, so agreement is to
    f32 rounding of the largest force."""
    pos, active = _agents("clustered")
    k = 24
    layout, _ = _layout(pos, active, k)
    order = np.argsort(np.asarray(compute_cell_ids(
        jnp.asarray(pos), jnp.asarray(active), GRID)), kind="stable")
    vel, e = _vel_e(len(pos))
    data = forcepass.scatter_cell_data(layout, GRID, k,
                                       jnp.asarray(pos[order]), vel, e)
    phys = Physics()
    ref = forcepass.dense_pairwise(data, GRID, k, phys, row_block=GRID.ny)
    got = forcepass.dense_pairwise(data, GRID, k, phys, row_block=row_block)
    scale = float(jnp.abs(ref).max())
    assert scale > 0.0
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=0, atol=1e-6 * scale)
