"""Uniform-grid neighbor search, on device.

The reference re-bins all agents into a cell list every step on the host
(neighbor_grid.rs:22-36) and counting-sorts them into a cell-major CSR layout
(sfm.rs:58-77).  The device-resident equivalent keeps everything on device with
static shapes:

1. cell id per agent (inactive / out-of-grid agents get the sentinel id
   ``n_cells`` so they sort to the end — the reference silently drops
   out-of-grid agents, neighbor_grid.rs:29);
2. a stable argsort by cell id (the counting sort analog);
3. CSR offsets via ``searchsorted`` (``neighbor_grid_indices`` analog,
   sfm.rs:61-77);
4. a dense [n_cells, K] cell->agent table (capacity K per cell) that turns
   the reference's variable-length CSR row scans (sfm.rs:122-128) into
   fixed-shape gathers — the shape XLA/Pallas want.  Cells holding more than
   K agents drop the overflow; the per-step ``n_overflow`` metric reports it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp


class CellGrid(NamedTuple):
    """Static description of the neighbor grid (neighbor_grid.rs:14-20)."""

    unit: float
    nx: int  # columns
    ny: int  # rows

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny

    @classmethod
    def for_size(cls, size: tuple[float, float], unit: float) -> "CellGrid":
        return cls(
            unit=unit,
            nx=int(math.ceil(size[0] / unit)),
            ny=int(math.ceil(size[1] / unit)),
        )


class NeighborData(NamedTuple):
    """Per-step neighbor structure over the *sorted* agent arrays."""

    order: jnp.ndarray  # [N] permutation that cell-sorts the agents
    cell_ids: jnp.ndarray  # [N] sorted cell ids (sentinel n_cells at end)
    csr: jnp.ndarray  # [n_cells + 1] CSR offsets into sorted arrays
    table: jnp.ndarray  # [n_cells, K] agent index per slot, N = sentinel
    n_overflow: jnp.ndarray  # scalar i32: agents dropped from full cells


def compute_cell_ids(pos: jnp.ndarray, active: jnp.ndarray,
                     grid: CellGrid) -> jnp.ndarray:
    """Cell id per agent; sentinel ``n_cells`` for inactive or out-of-grid."""
    cx = jnp.floor(pos[:, 0] / grid.unit).astype(jnp.int32)
    cy = jnp.floor(pos[:, 1] / grid.unit).astype(jnp.int32)
    in_grid = (cx >= 0) & (cx < grid.nx) & (cy >= 0) & (cy < grid.ny)
    ok = active & in_grid
    return jnp.where(ok, cy * grid.nx + cx, grid.n_cells).astype(jnp.int32)


def build_neighbor_data(cell_ids_sorted: jnp.ndarray, grid: CellGrid,
                        table_capacity: int) -> NeighborData:
    """Build CSR offsets and the dense cell table from already-sorted ids.

    ``cell_ids_sorted`` must be ascending (output of the step's sort phase).
    """
    n = cell_ids_sorted.shape[0]
    csr = jnp.searchsorted(
        cell_ids_sorted,
        jnp.arange(grid.n_cells + 1, dtype=jnp.int32),
        side="left",
    ).astype(jnp.int32)

    # Rank of each agent within its cell; slot = (cell, rank).
    idx = jnp.arange(n, dtype=jnp.int32)
    starts = jnp.take(csr, jnp.clip(cell_ids_sorted, 0, grid.n_cells), mode="clip")
    rank = idx - starts
    valid = (cell_ids_sorted < grid.n_cells) & (rank < table_capacity)
    # Invalid writes target an out-of-bounds slot and are dropped.
    slot = jnp.where(valid, cell_ids_sorted * table_capacity + rank,
                     grid.n_cells * table_capacity)

    table = jnp.full((grid.n_cells * table_capacity,), n, dtype=jnp.int32)
    table = table.at[slot].set(idx, mode="drop")
    n_overflow = jnp.sum((cell_ids_sorted < grid.n_cells) & ~valid)

    return NeighborData(
        order=idx,  # caller applied the sort already; identity here
        cell_ids=cell_ids_sorted,
        csr=csr,
        table=table.reshape(grid.n_cells, table_capacity),
        n_overflow=n_overflow.astype(jnp.int32),
    )


def gather_candidates(cell_ids_sorted: jnp.ndarray, table: jnp.ndarray,
                      grid: CellGrid) -> jnp.ndarray:
    """For each agent, the agent indices in its 3x3 cell neighborhood.

    Returns [N, 9 * K] of indices into the sorted arrays; invalid entries are
    the sentinel N.  The 3x3 window is masked (not clamped) at the grid edge
    so no cell is double counted — the reference achieves the same with
    clamped *ranges* (sfm.rs:117-120).
    """
    n = cell_ids_sorted.shape[0]
    k = table.shape[1]
    cid = jnp.minimum(cell_ids_sorted, grid.n_cells - 1)
    cx = cid % grid.nx
    cy = cid // grid.nx

    offsets = jnp.array(
        [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)], dtype=jnp.int32
    )  # [9, 2]
    ncx = cx[:, None] + offsets[None, :, 1]  # [N, 9]
    ncy = cy[:, None] + offsets[None, :, 0]
    cell_ok = (ncx >= 0) & (ncx < grid.nx) & (ncy >= 0) & (ncy < grid.ny)
    ncell = jnp.where(cell_ok, ncy * grid.nx + ncx, 0)

    cand = jnp.take(table, ncell, axis=0, mode="clip")  # [N, 9, K]
    cand = jnp.where(cell_ok[:, :, None], cand, n)
    return cand.reshape(n, 9 * k)
