"""Dense cell-layout pairwise force pass.

The reference's hot loop walks variable-length CSR neighbor lists per agent
(sfm.rs:122-156).  Here agents are scattered once into a **dense cell grid**
``D[ny+2, nx+2, K, 8]`` (cell-major, K slots per cell, 1-cell zero ring) and
the 3x3 neighborhood of every cell is materialized by NINE SHIFTED SLICES.
The pair math then runs as dense [K, 9K] elementwise arithmetic plus one
reduction, which XLA fuses into a few kernels with no per-pair index
traffic.

Channels: pos.x, pos.y, vel.x, vel.y, e.x, e.y (goal direction, needed for
the FOV anisotropy, sfm.rs:149-151), active flag, padding.

Trade-offs vs. the reference semantics:
- cells hold at most K agents; overflow agents (reported per step) neither
  exert nor receive pairwise forces that step.  The reference's ThinVec
  cells are unbounded; K=16 covers ~6 agents/m^2 peaks at the default
  1.4 m cell, and the Simulator grows K from ``max_count`` before a cell
  fills, so overflow needs a cell to jump past K within one step.
- empty cell slots compute masked garbage lanes — the price of density.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..physics import Physics
from .forces import EPS, safe_norm
from .neighbor import CellGrid

N_CH = 8

_OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
_SELF_BLOCK = _OFFSETS.index((0, 0))  # candidate block holding the center cell


class CellLayout(NamedTuple):
    slot: jnp.ndarray  # [N] flat index into the padded (ny+2, nx+2, K) grid
    valid: jnp.ndarray  # [N] has a cell slot (in grid, active, rank < K)
    n_overflow: jnp.ndarray  # scalar i32
    max_count: jnp.ndarray  # scalar i32: agents in the fullest cell


def build_layout(cid_sorted: jnp.ndarray, active: jnp.ndarray,
                 grid: CellGrid, k: int) -> CellLayout:
    """Assign each cell-sorted agent its (cell, rank) slot in the padded grid.

    Rank within the cell comes from a cummax scan over run starts (no CSR
    offsets, no gathers): rank[i] = i - (index of the first agent with the
    same cell id).  ``max_count`` is the largest cell population, K or
    not: the Simulator grows K before it is reached.
    """
    n = cid_sorted.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    in_grid = cid_sorted < grid.n_cells
    cid = jnp.minimum(cid_sorted, grid.n_cells - 1)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), cid_sorted[1:] != cid_sorted[:-1]]
    )
    run_start = jax.lax.cummax(jnp.where(is_start, idx, 0))
    rank = idx - run_start
    ok = in_grid & active & (rank < k)
    cy = cid // grid.nx
    cx = cid % grid.nx
    slot = ((cy + 1) * (grid.nx + 2) + (cx + 1)) * k + rank
    n_cells_padded = (grid.ny + 2) * (grid.nx + 2)
    slot = jnp.where(ok, slot, n_cells_padded * k)  # dropped by scatter
    placed = in_grid & active
    n_overflow = jnp.sum(placed & (rank >= k)).astype(jnp.int32)
    max_count = jnp.max(jnp.where(placed, rank + 1, 0)).astype(jnp.int32)
    return CellLayout(slot=slot, valid=ok, n_overflow=n_overflow,
                      max_count=max_count)


def scatter_cell_data(layout: CellLayout, grid: CellGrid, k: int,
                      pos: jnp.ndarray, vel: jnp.ndarray,
                      e: jnp.ndarray) -> jnp.ndarray:
    """One scatter of the packed agent channels into the padded cell grid."""
    n = pos.shape[0]
    channels = jnp.concatenate(
        [
            pos,
            vel,
            e,
            layout.valid[:, None].astype(jnp.float32),
            jnp.zeros((n, 1), jnp.float32),
        ],
        axis=1,
    )  # [N, 8]
    flat = jnp.zeros(((grid.ny + 2) * (grid.nx + 2) * k + 1, N_CH), jnp.float32)
    flat = flat.at[layout.slot].set(channels, mode="drop")
    return flat[:-1].reshape(grid.ny + 2, grid.nx + 2, k, N_CH)


def _pair_block(center: jnp.ndarray, cand: jnp.ndarray, k: int,
                phys: Physics) -> jnp.ndarray:
    """Pairwise forces for one row block.

    center: [rb, nx, K, 8]; cand: [rb, nx, 9K, 8] -> acc [rb, nx, K, 2].
    Faithful to sfm.rs:129-153 (elliptical Helbing repulsion, 2 m cutoff,
    FOV damping); every division guarded for the masked garbage lanes.
    """
    dt = phys.delta_time
    cpos = center[..., 0:2]
    cvel = center[..., 2:4]
    ce = center[..., 4:6]
    mpos = cand[..., 0:2]
    mvel = cand[..., 2:4]
    mact = cand[..., 6]

    # Self-exclusion: candidate j is the center slot itself iff
    # j == SELF_BLOCK * K + k.
    iota_k = jax.lax.broadcasted_iota(jnp.int32, (k, 9 * k), 0)
    iota_j = jax.lax.broadcasted_iota(jnp.int32, (k, 9 * k), 1)
    not_self = iota_j != _SELF_BLOCK * k + iota_k  # [K, 9K]

    diff = cpos[..., :, None, :] - mpos[..., None, :, :]  # [rb, nx, K, 9K, 2]
    d2 = jnp.sum(diff * diff, axis=-1)
    valid = (mact[..., None, :] > 0.5) & (d2 <= phys.cutoff_sq) & not_self

    d = jnp.sqrt(jnp.maximum(d2, EPS))
    direction = diff / d[..., None]
    t1 = diff - mvel[..., None, :, :] * dt
    t1_len = safe_norm(t1)
    t2 = d + t1_len
    vlen = safe_norm(mvel)[..., None, :]
    b = jnp.sqrt(jnp.maximum(t2 * t2 - (vlen * dt) ** 2, EPS)) * 0.5

    nabla_b = t2[..., None] * (direction + t1 / t1_len[..., None]) / (4.0 * b[..., None])
    force = phys.ped_strength * jnp.exp(-b / phys.ped_range)[..., None] * nabla_b

    f_len = safe_norm(force)
    in_front = jnp.sum(ce[..., :, None, :] * (-force), axis=-1) >= f_len * phys.cos_phi
    force = jnp.where(in_front[..., None], force, force * phys.fov_damping)
    force = jnp.where(valid[..., None], force, 0.0)
    return jnp.sum(force, axis=-2)  # [rb, nx, K, 2]


def dense_pairwise(data: jnp.ndarray, grid: CellGrid, k: int, phys: Physics,
                   row_block: int = 4) -> jnp.ndarray:
    """Pairwise accelerations for every cell slot.

    ``data`` is the padded [ny+2, nx+2, K, 8] grid; returns the flat
    [ (ny+2)*(nx+2)*K, 2 ] acceleration array in the same padded layout
    (so callers can gather per agent by their ``slot``).  The grid runs
    in blocks of ``row_block`` cell rows, in order, under ``lax.map``:
    XLA materialises the [rows, nx, K, 9K] pair intermediates, so one
    block over the whole 1M-agent grid needs 26 GB of temporaries and
    runs 1.9x slower on an H100 than blocks of 4 rows (PERF.md).
    """
    ny, nx = grid.ny, grid.nx
    rb = min(row_block, ny)
    nb = -(-ny // rb)
    ny_pad = nb * rb

    # Pad rows so blocks tile evenly; zero rows are inert (active = 0).
    d = jnp.pad(data, ((0, ny_pad - ny), (0, 0), (0, 0), (0, 0)))

    # Overlapping row windows [nb, rb+2, nx+2, K, 8]: bulk row copies.
    row_idx = (
        jnp.arange(nb, dtype=jnp.int32)[:, None] * rb
        + jnp.arange(rb + 2, dtype=jnp.int32)[None, :]
    )
    row_idx = jnp.minimum(row_idx, ny_pad + 1)
    blocks = jnp.take(d, row_idx, axis=0, mode="clip")

    def block_fn(block):
        center = block[1 : rb + 1, 1 : nx + 1]
        cand = jnp.concatenate(
            [
                block[1 + dy : 1 + dy + rb, 1 + dx : 1 + dx + nx]
                for dy, dx in _OFFSETS
            ],
            axis=2,
        )
        return _pair_block(center, cand, k, phys)

    if nb == 1:
        acc = block_fn(blocks[0])[None]
    else:
        acc = jax.lax.map(block_fn, blocks)  # [nb, rb, nx, K, 2]

    acc = acc.reshape(ny_pad, nx, k, 2)[:ny]
    # Back to the padded layout for slot-based gather.
    acc = jnp.pad(acc, ((1, 1), (1, 1), (0, 0), (0, 0)))
    return acc.reshape(-1, 2)


def gather_pair_acc(acc_flat: jnp.ndarray, layout: CellLayout) -> jnp.ndarray:
    """Per-agent pairwise acceleration: one [N]-gather by slot."""
    slot = jnp.minimum(layout.slot, acc_flat.shape[0] - 1)
    acc = jnp.take(acc_flat, slot, axis=0, mode="clip")
    return jnp.where(layout.valid[:, None], acc, 0.0)
