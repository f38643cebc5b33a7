"""Independent scalar f64 oracle of the reference SFM step.

A per-agent-loop NumPy transliteration of the reference physics
(/root/reference/pedoni-simulator/src/models/sfm.rs:91-255 and
util.rs:44-75), written ONLY from the reference — it shares no code with
pedoni_tpu's vectorized implementations.  Purpose (test pyramid): the
single-device and sharded steps are checked against each other and
against hand-derived unit cases, but those chains share one Python
reading of the physics; a shared misreading (a sign convention, the
half-cell sampling offset, the FOV inequality direction) would pass
everything.  This oracle de-correlates implementation and referee:
tests/test_oracle.py and chip_smoke.py run trajectories through it and
through the real step and compare.

Semantics mirrored here, with sources:
- field sampling at ``pos/unit - 0.5`` with out-of-bounds taps = 1e12
  (field.rs:235-259, util.rs:44-58);
- Sobel gradient as 8 bilinear taps at +-1 cell offsets
  (util.rs:61-75) — NOT a convolution of the map;
- goal force (e * speed - vel) / 0.5 with e = normalize(sobel)
  (sfm.rs:106-109);
- pairwise elliptical repulsion with 2 m cutoff, t1 = diff - v_j * dt,
  b = sqrt(t2^2 - (|v_j| dt)^2)/2, magnitude (2.1/0.3) exp(-b/0.3),
  nabla_b direction, FOV half-weighting when e . (-f) < |f| cos(100 deg)
  (sfm.rs:126-153), restricted to the 3x3 neighbor-cell window
  (sfm.rs:111-125);
- obstacle force 10 * 0.2 * exp(-d/0.2) along -normalize(sobel(dist))
  (sfm.rs:188-192);
- despawn when potential <= 0.25 (sfm.rs:69) or out of the grid
  (neighbor_grid.rs:29), BEFORE forces, so a despawning agent exerts no
  force that tick;
- integration vel += acc*0.1, clamp |vel| <= 1.3*speed, trapezoidal
  pos += (vel + vel_prev)*0.05 (sfm.rs:245-254);
- the two debug modes: all-pairs with the SAME 2 m cutoff
  (sfm.rs:158-184, ``use_neighbor_grid=False``) and per-segment obstacle
  geometry (sfm.rs:194-237 + util.rs:92-103: widen each obstacle line to
  a 4-edge rectangle, clamped point-to-edge distances, zero force
  strictly inside, else 10 * 0.2 * exp(-d_min/0.2) along the nearest
  edge's offset vector; ``obstacles=[(x0, y0, x1, y1, width), ...]``).
"""

from __future__ import annotations

import math

import numpy as np

FMAX = 1e12
COS_PHI = -0.17364817766693036  # cos(100 deg), sfm.rs:16
DT = 0.1
RELAX = 0.5
PED_STRENGTH = 2.1
PED_RANGE = 0.3
OBS_STRENGTH = 10.0
OBS_RANGE = 0.2
MAX_SPEED_FACTOR = 1.3
DESPAWN_POTENTIAL = 0.25
CUTOFF_SQ = 4.0
EPS = 1e-12


def _bilinear(grid: np.ndarray, x: float, y: float) -> float:
    """util.rs:44-58: floor-based bilinear; any tap outside the raw map
    (including negative indices) reads 1e12."""
    bx, by = math.floor(x), math.floor(y)
    tx, ty = x - bx, y - by
    h, w = grid.shape

    def get(ix: int, iy: int) -> float:
        if 0 <= ix < w and 0 <= iy < h:
            return float(grid[iy, ix])
        return FMAX

    return ((1 - ty) * (1 - tx) * get(bx, by)
            + (1 - ty) * tx * get(bx + 1, by)
            + ty * (1 - tx) * get(bx, by + 1)
            + ty * tx * get(bx + 1, by + 1))


def _sobel(grid: np.ndarray, x: float, y: float) -> tuple[float, float]:
    """util.rs:61-75: Sobel from 8 bilinear taps at +-1 cell offsets.
    Positive component points toward LOWER values (downhill)."""
    u00 = _bilinear(grid, x - 1, y - 1)
    u01 = _bilinear(grid, x, y - 1)
    u02 = _bilinear(grid, x + 1, y - 1)
    u10 = _bilinear(grid, x - 1, y)
    u12 = _bilinear(grid, x + 1, y)
    u20 = _bilinear(grid, x - 1, y + 1)
    u21 = _bilinear(grid, x, y + 1)
    u22 = _bilinear(grid, x + 1, y + 1)
    gx = u00 + 2 * u10 + u20 - u02 - 2 * u12 - u22
    gy = u00 + 2 * u01 + u02 - u20 - 2 * u21 - u22
    return gx, gy


def _sample_pos(pos, unit: float):
    # field.rs:236: position / unit - 0.5
    return pos[0] / unit - 0.5, pos[1] / unit - 0.5


def _normalize(vx: float, vy: float) -> tuple[float, float]:
    n = math.sqrt(max(vx * vx + vy * vy, EPS))
    return vx / n, vy / n


def _segment_force(px: float, py: float, obstacles) -> tuple[float, float]:
    """Per-segment obstacle force, sfm.rs:194-237 in f64: widen each line
    to a 4-edge rectangle (normal = normalize(dy, -dx) * w/2), take the
    clamped point-to-edge distance vectors (util.rs:92-103), skip the
    obstacle when strictly inside all four bands, else push along the
    nearest edge's offset with 10 * 0.2 * exp(-d_min/0.2)."""
    ax = ay = 0.0
    for (x0, y0, x1, y1, w) in obstacles:
        dx_, dy_ = x1 - x0, y1 - y0
        h = math.sqrt(dx_ * dx_ + dy_ * dy_)
        if h > 0.0:
            nx_, ny_ = dy_ / h * (w * 0.5), -dx_ / h * (w * 0.5)
        else:
            nx_ = ny_ = 0.0  # normalize_or_zero, sfm.rs:198
        edges = (
            ((x0 + nx_, y0 + ny_), (x0 - nx_, y0 - ny_)),
            ((x1 + nx_, y1 + ny_), (x1 - nx_, y1 - ny_)),
            ((x0 + nx_, y0 + ny_), (x1 + nx_, y1 + ny_)),
            ((x0 - nx_, y0 - ny_), (x1 - nx_, y1 - ny_)),
        )
        ds, vecs = [], []
        for (qx0, qy0), (qx1, qy1) in edges:
            bx, by = qx1 - qx0, qy1 - qy0
            b2 = bx * bx + by * by
            if b2 == 0.0:
                vx, vy = px - 2 * qx0, py - 2 * qy0  # a - line[0], util.rs:97-98
            else:
                t = min(max(((px - qx0) * bx + (py - qy0) * by) / b2, 0.0), 1.0)
                vx, vy = px - (qx0 + t * bx), py - (qy0 + t * by)
            ds.append(math.sqrt(vx * vx + vy * vy))
            vecs.append((vx, vy))
        if ds[0] < w and ds[1] < w and ds[2] < h and ds[3] < h:
            continue  # strictly inside: no force, sfm.rs:210-216
        mi = min(range(4), key=lambda e: ds[e])
        dmin = max(ds[mi], math.sqrt(EPS))
        c = OBS_STRENGTH * OBS_RANGE * math.exp(-dmin / OBS_RANGE) / dmin
        ax += c * vecs[mi][0]
        ay += c * vecs[mi][1]
    return ax, ay


def oracle_step(field, pos: np.ndarray, vel: np.ndarray, speed: np.ndarray,
                dest: np.ndarray, active: np.ndarray, size, unit: float,
                use_neighbor_grid: bool = True, obstacles=None):
    """One reference tick in f64 over flat agent arrays.

    ``field``: pedoni_tpu.field.Field (raw unpadded maps — shared INPUT
    DATA only; all sampling math here is independent).  ``size``: world
    (w, h); ``unit``: neighbor-cell size.  ``use_neighbor_grid=False`` =
    the reference's all-pairs branch (sfm.rs:158-184, same cutoff);
    ``obstacles`` = list of (x0, y0, x1, y1, width) segments — when given,
    the per-segment force replaces the distance map (sfm.rs:194-237).
    Returns new (pos, vel, active); inactive rows pass through unchanged.
    """
    pos = pos.astype(np.float64).copy()
    vel = vel.astype(np.float64).copy()
    n = pos.shape[0]
    w, h = float(size[0]), float(size[1])
    fu = float(field.unit)
    dist_map = np.asarray(field.distance_map, np.float64)
    pot_maps = [np.asarray(m, np.float64) for m in field.potential_maps]

    # --- despawn (sfm.rs:69 + neighbor_grid.rs:29), before forces ---
    act = active.copy()
    for i in range(n):
        if not act[i]:
            continue
        sx, sy = _sample_pos(pos[i], fu)
        potential = _bilinear(pot_maps[int(dest[i])], sx, sy)
        in_grid = 0.0 <= pos[i, 0] < w and 0.0 <= pos[i, 1] < h
        if potential <= DESPAWN_POTENTIAL or not in_grid:
            act[i] = False

    # --- neighbor cell lists (neighbor_grid.rs:22-36) ---
    nx = int(np.ceil(w / unit))
    ny = int(np.ceil(h / unit))
    cells: dict[tuple[int, int], list[int]] = {}
    alive = [i for i in range(n) if act[i]]
    for i in alive:
        cx = int(math.floor(pos[i, 0] / unit))
        cy = int(math.floor(pos[i, 1] / unit))
        cells.setdefault((cy, cx), []).append(i)

    new_pos = pos.copy()
    new_vel = vel.copy()
    for i in range(n):
        if not act[i]:
            continue
        px, py = pos[i]
        sx, sy = _sample_pos(pos[i], fu)

        # goal force (sfm.rs:106-109)
        gx, gy = _sobel(pot_maps[int(dest[i])], sx, sy)
        ex, ey = _normalize(gx, gy)
        ax = (ex * speed[i] - vel[i, 0]) / RELAX
        ay = (ey * speed[i] - vel[i, 1]) / RELAX

        # pairwise (sfm.rs:111-184): 3x3 cell window — or every agent in
        # the all-pairs branch — with the same 2 m cutoff either way
        if use_neighbor_grid:
            cy0 = int(math.floor(py / unit))
            cx0 = int(math.floor(px / unit))
            cands = (j for cy in range(max(cy0 - 1, 0), min(cy0 + 1, ny - 1) + 1)
                     for cx in range(max(cx0 - 1, 0), min(cx0 + 1, nx - 1) + 1)
                     for j in cells.get((cy, cx), ()))
        else:
            cands = iter(alive)
        for j in cands:
            if j == i:
                continue
            dx = px - pos[j, 0]
            dy = py - pos[j, 1]
            d2 = dx * dx + dy * dy
            if d2 > CUTOFF_SQ:
                continue
            d = math.sqrt(max(d2, EPS))
            dirx, diry = dx / d, dy / d
            t1x = dx - vel[j, 0] * DT
            t1y = dy - vel[j, 1] * DT
            t1l = math.sqrt(max(t1x * t1x + t1y * t1y, EPS))
            t2 = d + t1l
            vj2 = vel[j, 0] ** 2 + vel[j, 1] ** 2
            b = 0.5 * math.sqrt(max(t2 * t2 - vj2 * DT * DT, EPS))
            # nabla_b = t2 (dir + t1/|t1|) / (4b); force =
            # (strength/range) exp(-b/range) nabla_b
            c = (PED_STRENGTH / PED_RANGE) * math.exp(-b / PED_RANGE) \
                * t2 / (4.0 * b)
            fx = c * (dirx + t1x / t1l)
            fy = c * (diry + t1y / t1l)
            # FOV (sfm.rs:149-151): damp when e.(-f) < |f| cos phi
            flen = math.sqrt(fx * fx + fy * fy)
            if -(ex * fx + ey * fy) < flen * COS_PHI:
                fx *= 0.5
                fy *= 0.5
            ax += fx
            ay += fy

        # obstacle force: distance map (sfm.rs:188-192) or per-segment
        # geometry (sfm.rs:194-237)
        if obstacles is None:
            od = _bilinear(dist_map, sx, sy)
            ogx, ogy = _sobel(dist_map, sx, sy)
            onx, ony = _normalize(ogx, ogy)
            mag = OBS_STRENGTH * OBS_RANGE * math.exp(-od / OBS_RANGE)
            ax -= mag * onx
            ay -= mag * ony
        else:
            ofx, ofy = _segment_force(px, py, obstacles)
            ax += ofx
            ay += ofy

        # integrate (sfm.rs:245-254)
        nvx = vel[i, 0] + ax * DT
        nvy = vel[i, 1] + ay * DT
        vmax = speed[i] * MAX_SPEED_FACTOR
        vlen = math.sqrt(nvx * nvx + nvy * nvy)
        if vlen > vmax:
            nvx *= vmax / vlen
            nvy *= vmax / vlen
        new_vel[i] = (nvx, nvy)
        new_pos[i, 0] = px + (nvx + vel[i, 0]) * (DT * 0.5)
        new_pos[i, 1] = py + (nvy + vel[i, 1]) * (DT * 0.5)

    return new_pos, new_vel, act


def oracle_run(field, pos, vel, speed, dest, active, size, unit: float,
               n_steps: int, **modes):
    """``n_steps`` oracle ticks; returns the final (pos, active)."""
    p, v, a = pos, vel, np.asarray(active).copy()
    sp = np.asarray(speed, np.float64)
    for _ in range(n_steps):
        p, v, a = oracle_step(field, p, v, sp, dest, a, size, unit, **modes)
    return p, a


def tagged_errors(tags, o_pos, o_act, b_pos, b_act, b_tags) -> np.ndarray:
    """Per-agent position difference (max over x, y) between a run under
    test and the oracle, agents matched by a unique tag (``tags[i]`` is
    oracle agent i's; ``b_tags`` the tested run's, in its own slot order).
    Raises AssertionError when the two runs keep different agents."""
    o_ids = {float(t): i for i, t in enumerate(np.asarray(tags, np.float32))}
    b_tags = np.asarray(b_tags, np.float32)
    errs = []
    for bi in np.flatnonzero(b_act):
        oi = o_ids[float(b_tags[bi])]
        assert o_act[oi], f"agent {oi} active in the tested run, not oracle"
        errs.append(float(np.abs(b_pos[bi] - o_pos[oi]).max()))
    assert len(errs) == int(np.sum(o_act)), (
        f"tested run kept {len(errs)} agents, oracle {int(np.sum(o_act))}")
    return np.asarray(errs)


def max_tagged_error(tags, o_pos, o_act, b_pos, b_act, b_tags) -> float:
    """Largest of :func:`tagged_errors` (0.0 when no agent is left)."""
    errs = tagged_errors(tags, o_pos, o_act, b_pos, b_act, b_tags)
    return float(errs.max()) if errs.size else 0.0
