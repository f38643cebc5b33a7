"""Device-side field sampling (JAX).

Runtime counterpart of the reference's per-agent field queries
(field.rs:235-258 + util.rs:44-75).  All maps are pre-padded with PAD rings
of the out-of-bounds value 1e12 (see pedoni_tpu/field.py); gradients read
pre-convolved Sobel maps instead of 8 bilinear taps per agent per map.

Layout: one fat row per map cell — (potential, pot_gx, pot_gy,
obstacle_distance, dist_gx, dist_gy, 0, 0), with the obstacle channels
duplicated into every waypoint plane — and each agent performs exactly FOUR
row gathers (the bilinear taps), each delivering all 6 physical channels.
That replaces the reference's 64+ scalar map reads per agent (sfm.rs:107,
188-190 via util.rs:61-75) with 4 indexed 32-byte reads.

Coordinates: world position ``pos`` (meters) maps to unpadded grid coords
``pos / unit - 0.5`` (field.rs:236 half-cell offset); add PAD for the padded
arrays.  Out-of-range positions clamp into the 1e12 ring, reproducing the
reference's OOB semantics for any excursion up to PAD-1 cells (beyond that
the agent has already been despawned for leaving the neighbor grid).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..field import PAD, FieldMaps


class FieldSample(NamedTuple):
    potential: jnp.ndarray  # [N] destination potential (despawn + goal)
    pot_grad: jnp.ndarray  # [N, 2] Sobel of the potential (downhill)
    obs_dist: jnp.ndarray  # [N] obstacle distance
    obs_grad: jnp.ndarray  # [N, 2] Sobel of the distance map (downhill)


class DeviceField(NamedTuple):
    """Packed, padded field maps: one [n_wp * Hp * Wp, 8] row-major array,
    channels (pot, pot_gx, pot_gy, dist, dist_gx, dist_gy, 0, 0); the
    obstacle channels are replicated into every waypoint plane so a single
    4-tap pass samples everything."""

    rows: jnp.ndarray
    hp: int
    wp_cols: int

    @classmethod
    def from_maps(cls, maps: FieldMaps) -> "DeviceField":
        n_wp, hp, wp_cols = maps.pot.shape
        zeros = np.zeros_like(maps.dist)
        obs = np.stack([maps.dist, maps.dist_gx, maps.dist_gy, zeros, zeros],
                       axis=-1)  # [Hp, Wp, 5]
        rows = np.concatenate(
            [
                np.stack([maps.pot, maps.pot_gx, maps.pot_gy], axis=-1),
                np.broadcast_to(obs[None], (n_wp, hp, wp_cols, 5)),
            ],
            axis=-1,
        ).astype(np.float32)  # [n_wp, Hp, Wp, 8]
        return cls(
            rows=jnp.asarray(rows.reshape(n_wp * hp * wp_cols, 8)),
            hp=hp,
            wp_cols=wp_cols,
        )


def sample_field(flat: jnp.ndarray, hp: int, wp: int, dest: jnp.ndarray,
                 pos: jnp.ndarray, unit: float) -> FieldSample:
    """Bilinear-sample all field channels at world positions: 4 row
    gathers per agent (util.rs:44-58 semantics via 1e12 padding +
    clamping).  ``flat`` is DeviceField.rows; ``hp``/``wp`` static dims."""
    px = jnp.clip(pos[:, 0] / unit - 0.5 + PAD, 0.0, wp - 1.001)
    py = jnp.clip(pos[:, 1] / unit - 0.5 + PAD, 0.0, hp - 1.001)
    bx = jnp.floor(px)
    by = jnp.floor(py)
    tx = (px - bx)[:, None]
    ty = (py - by)[:, None]
    base = (dest * hp + by.astype(jnp.int32)) * wp + bx.astype(jnp.int32)

    v00 = jnp.take(flat, base, axis=0, mode="clip")
    v01 = jnp.take(flat, base + 1, axis=0, mode="clip")
    v10 = jnp.take(flat, base + wp, axis=0, mode="clip")
    v11 = jnp.take(flat, base + wp + 1, axis=0, mode="clip")

    top = v00 + tx * (v01 - v00)
    bot = v10 + tx * (v11 - v10)
    v = top + ty * (bot - top)  # [N, 8]
    return FieldSample(
        potential=v[:, 0],
        pot_grad=v[:, 1:3],
        obs_dist=v[:, 3],
        obs_grad=v[:, 4:6],
    )
