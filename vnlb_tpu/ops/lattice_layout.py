"""Compressed layouts of the strided-query (coverage-lattice) search.

The coverage lattice (ops/mask.py, reference lib/vnlb/search_mask/mask.py:
315-358) queries only ~1/step_s of rows AND ~1/step_s of columns per row.
The strided search (ops/search_dense) therefore keeps, per spatial offset,
only the candidate distances at lattice positions, in a compact
``(F, n_rows, n_cols)`` layout.  This module plans that layout (static
numpy, or traced for halo tiles whose global row offset is data) and maps
every lattice site to its slot.

Row layout ("c-major"): the lattice's column phase advances by one per
query row (phase_w = (phase_h + k) % step, mask.py:67).  Query rows are
grouped BY COLUMN PHASE — block g holds the rows whose column lattice has
phase g — so every row of a block shares one column slot list: slot 0 =
x 0, slot 1 = x wp-1, slot 2+m = g + m*step.  The always-on border rows
(frame rows 0 and hp-1, lattice first_h/last_h) ride two spare slots: row
0 uses column phase phase_h (block phase_h); row hp-1 uses column phase 0
(block 0).

Each layout comes with ``sel``: the flat index into the
``(F*H'*W')``-flattened all-pixels distance plane of every slot (unused
slots point at position 0 and are never addressed by the site mappings).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def smat_layout(hp: int, wp: int, step: int):
    """Static level-0 layout.  Returns (gmax, n_rows, n_cols): gmax slots
    per column-phase block (row slots + first_h + last_h spares)."""
    nqmax = -(-hp // step)
    gmax = -(-nqmax // step) + 2
    return gmax, step * gmax, 2 + -(-wp // step)


def _block_cols(wp: int, step: int, n_cols: int) -> np.ndarray:
    """(step, n_cols) column of each slot of each column-phase block."""
    cols = np.zeros((step, n_cols), np.int32)
    for g in range(step):
        cols[g, 1] = wp - 1
        m_cnt = (wp - 1 - g) // step + 1
        cols[g, 2:2 + m_cnt] = g + np.arange(m_cnt) * step
    return cols


def smat_sel_indices(qrow0, hp: int, wp: int, step: int) -> np.ndarray:
    """Static (F, n_rows, n_cols) int32 flat plane index of every level-0
    slot (layout of ``smat_layout`` / ``site_rows_smat``)."""
    gmax, n_rows, n_cols = smat_layout(hp, wp, step)
    cols = _block_cols(wp, step, n_cols)
    sel = np.zeros((len(qrow0), n_rows, n_cols), np.int32)
    for f, ph0 in enumerate(qrow0):
        ph = int(ph0) % step
        for row in range(n_rows):
            g, j = row // gmax, row % gmax        # block g = column phase
            if j == gmax - 2:                     # first_h spare (block ph)
                if g != ph:
                    continue
                y = 0
            elif j == gmax - 1:                   # last_h spare (block 0)
                if g != 0:
                    continue
                y = hp - 1
            else:
                y = ph + ((g - ph) % step + j * step) * step
                if y > hp - 1:
                    continue
            sel[f, row] = f * (hp * wp) + y * wp + cols[g]
    return sel


def site_rows_smat(sites, qrow0, step: int, hp: int, wp: int):
    """Flat index of each LATTICE site into the (F, n_rows, n_cols)-
    flattened level-0 layout.  Every site must lie on the coverage lattice
    (ops/mask.lattice_mask)."""
    gmax, n_rows, n_cols = smat_layout(hp, wp, step)
    ts, ys, xs = sites[:, 0], sites[:, 1], sites[:, 2]
    qrow_arr = jnp.asarray([int(p) % step for p in qrow0], jnp.int32)
    ph = qrow_arr[jnp.clip(ts, 0, qrow_arr.shape[0] - 1)]

    is_last = ys == hp - 1
    on_row = ((ys % step) == ph) & ~is_last
    k = jnp.where(on_row, (ys - ph) // step, 0)
    g = (ph + k) % step                       # block = column phase
    row_main = g * gmax + k // step
    row_e0 = ph * gmax + (gmax - 2)           # first_h: block phase_h
    row_e1 = 0 * gmax + (gmax - 1)            # last_h: block 0
    row = jnp.where(is_last, row_e1, jnp.where(on_row, row_main, row_e0))

    # column phase of the row the site landed on (lattice phase_w)
    c_row = jnp.where(is_last, 0, jnp.where(on_row, (ph + k) % step, ph))
    on_col = (xs % step) == c_row
    col = jnp.where(on_col, 2 + (xs - c_row) // step,
                    jnp.where(xs == 0, 0, 1))
    return ts * (n_rows * n_cols) + row * n_cols + col


def coarse_plan(qrow0, lvl: int, hp0: int, wp0: int, h_l: int, w_l: int,
                ps: int, w_s: int, step: int):
    """Static layout of the strided-query COARSE (needle-pyramid) search.

    Level-``lvl`` query positions are the full-res lattice positions scaled
    and CLAMPED into the clamp-free band (ops/search_dense._site_rows):
    yc = clip(y >> lvl, half, h_l - ps - half), same for columns.  The
    scaled positions are not one arithmetic stride in general (stride 6 at
    level 2 alternates +1/+2), so the plan keeps one block per FULL-RES
    column phase: block g holds the rows whose lattice column phase is g,
    its column slots are the deduplicated clamped scalings of {0, wp0-1,
    g, g+step, ...}, and clamp-collided rows/cols share slots.

    Returns a dict of static numpy arrays:
      gmax, n_rows, n_cols                     — layout numbers
      row_slot (F, hp0) int32, row_block (F, hp0) int32 — full-res lattice
         row y -> its layout row / block (garbage at non-lattice rows)
      col_slot (step, wp0) int32               — block, full-res lattice
         col x -> column slot (garbage at non-lattice cols)
      sel (F, n_rows, n_cols) int32            — flat (F*hp_l*wp_l) plane
         index per slot (unused slots -> 0)
    """
    half = (w_s - 1) // 2
    lo = half
    hi_r = max(h_l - ps - lo, 0)
    hi_c = max(w_l - ps - lo, 0)
    hp_l, wp_l = h_l - ps + 1, w_l - ps + 1
    f_cnt = len(qrow0)

    def cl_r(v):
        return min(max(v, lo), hi_r)

    def cl_c(v):
        return min(max(v, lo), hi_c)

    # --- per-block canonical column slots (frame-independent) ---
    col_vals = []                           # per block: coarse cols
    col_lut = {}                            # (g, x_fullres) -> slot
    for g in range(step):
        vals = []
        seen = {}
        for x in sorted({0, wp0 - 1} | set(range(g, wp0, step))):
            xc = cl_c(x >> lvl)
            if xc not in seen:
                seen[xc] = len(vals)
                vals.append(xc)
            col_lut[(g, x)] = seen[xc]
        col_vals.append(vals)
    n_cols = max(len(v) for v in col_vals)

    def lattice_rows(ph):
        """(y, block) of every lattice row of a frame with row phase ph."""
        for y in sorted({0, hp0 - 1} | set(range(ph, hp0, step))):
            yield y, 0 if y == hp0 - 1 else (ph + y // step) % step

    # --- per-frame row slots, grouped by column phase ---
    rows_fb = []                            # [f][g] -> list of coarse yc
    for f in range(f_cnt):
        blocks = [[] for _ in range(step)]
        for y, g in lattice_rows(int(qrow0[f]) % step):
            yc = cl_r(y >> lvl)
            if yc not in blocks[g]:
                blocks[g].append(yc)
        rows_fb.append(blocks)
    gmax = max(len(b) for blocks in rows_fb for b in blocks)
    n_rows = step * gmax

    row_slot = np.zeros((f_cnt, hp0), np.int32)
    row_block = np.zeros((f_cnt, hp0), np.int32)
    col_slot = np.zeros((step, wp0), np.int32)
    sel = np.zeros((f_cnt, n_rows, n_cols), np.int32)
    for (g, x), slot in col_lut.items():
        col_slot[g, x] = slot
    for f in range(f_cnt):
        for y, g in lattice_rows(int(qrow0[f]) % step):
            row_slot[f, y] = g * gmax + rows_fb[f][g].index(cl_r(y >> lvl))
            row_block[f, y] = g
        for g in range(step):
            xcs = np.asarray(col_vals[g], np.int32)
            for j, yc in enumerate(rows_fb[f][g]):
                sel[f, g * gmax + j, :len(xcs)] = (f * (hp_l * wp_l)
                                                   + yc * wp_l + xcs)

    return dict(gmax=gmax, n_rows=n_rows, n_cols=n_cols, row_slot=row_slot,
                row_block=row_block, col_slot=col_slot, sel=sel)


def site_rows_coarse(sites, plan):
    """Flat index of each full-res LATTICE site into the (F, n_rows,
    n_cols)-flattened coarse layout (device-side; the plan's lookup tables
    are trace-time constants)."""
    ts, ys, xs = sites[:, 0], sites[:, 1], sites[:, 2]
    r = jnp.asarray(plan["row_slot"])[ts, ys]
    g = jnp.asarray(plan["row_block"])[ts, ys]
    c = jnp.asarray(plan["col_slot"])[g, xs]
    return ts * (plan["n_rows"] * plan["n_cols"]) + r * plan["n_cols"] + c


# ---------------------------------------------------------------------------
# Halo tiles.  Inside a shard_map'd halo strip the global row of tile row 0
# (``base_row = strip_index*strip_h - halo``) is a traced per-device scalar,
# so the lattice's tile-coordinate row set — and therefore the selection
# and the site->slot mapping — varies per device.  Every layout SHAPE is
# static and device-uniform; only the slot contents are traced.
# ---------------------------------------------------------------------------

def tile_smat_layout(hp_t: int, wp: int, step: int):
    """Static layout for a halo tile of hp_t query-corner rows.

    Tile rows of one column-phase block are step^2 apart, so the in-block
    slot of tile row y is ``y // step^2`` — a purely LOCAL quantity; blocks
    (column phases) come from global coordinates at run time.
    Returns (gmax, n_rows, n_cols)."""
    gmax = (hp_t - 1) // (step * step) + 3      # j-slots + e0 + e1 spares
    return gmax, step * gmax, 2 + -(-wp // step)


def _tile_row_slots(qrow0, base_row, hp_t: int, hp_g: int, step: int,
                    gmax: int, n_rows: int):
    """Traced per-frame row->slot mapping for a halo tile.

    Returns (F, hp_t) int32: layout row of each tile query row (n_rows =
    dropped/no slot).  Mirrors ``site_rows_smat``'s global logic: lattice
    rows (global phase match, not the last row) go to block
    ``(ph + k_g) % step`` slot ``y_t // step^2``; the global first/last
    rows ride the e0/e1 spare slots of blocks ph/0."""
    y_t = jnp.arange(hp_t, dtype=jnp.int32)
    y_g = y_t + base_row
    in_frame = (y_g >= 0) & (y_g <= hp_g - 1)
    is_last = (y_g == hp_g - 1) & in_frame
    is_first = (y_g == 0) & in_frame
    j = y_t // (step * step)
    rows = []
    for ph0 in qrow0:
        ph = int(ph0) % step
        on_row = ((y_g % step) == ph) & ~is_last & in_frame
        k_g = jnp.where(on_row, (y_g - ph) // step, 0)
        g = (ph + k_g) % step
        row = jnp.where(
            on_row, g * gmax + j,
            jnp.where(is_last, 0 * gmax + (gmax - 1),
                      jnp.where(is_first, ph * gmax + (gmax - 2),
                                n_rows)))
        rows.append(row)
    return jnp.stack(rows)


def tile_sel_indices(qrow0, base_row, hp_t: int, hp_g: int, wp: int,
                     step: int):
    """Traced (F, n_rows, n_cols) int32 flat indices into the
    (F*hp_t*wp)-flattened all-pixels tile planes (layout of
    ``tile_smat_layout``; unused slots -> 0, never addressed by
    ``site_rows_smat_tile``)."""
    gmax, n_rows, n_cols = tile_smat_layout(hp_t, wp, step)
    slots = _tile_row_slots(qrow0, base_row, hp_t, hp_g, step, gmax, n_rows)
    y_t = jnp.arange(hp_t, dtype=jnp.int32)
    f_cnt = len(qrow0)
    yrow = jnp.zeros((f_cnt, n_rows + 1), jnp.int32)
    fidx = jnp.arange(f_cnt, dtype=jnp.int32)[:, None]
    yrow = yrow.at[fidx, slots].set(y_t[None, :])[:, :n_rows]
    colx = jnp.asarray(_block_cols(wp, step, n_cols)
                       [np.arange(n_rows) // gmax % step])   # (n_rows, nc)
    base = (jnp.arange(f_cnt, dtype=jnp.int32) * (hp_t * wp))[:, None, None]
    return base + yrow[:, :, None] * wp + colx[None]


def site_rows_smat_tile(sites_local, gy, qrow0, step: int, hp_t: int,
                        hp_g: int, wp: int):
    """Flat index of each lattice site into the (F, n_rows, n_cols)-
    flattened TILE layout.  ``sites_local`` are tile coordinates; ``gy``
    the global rows (for phase / first / last classification).  Mirrors
    ``site_rows_smat`` with the tile slot rule of ``_tile_row_slots``."""
    gmax, n_rows, n_cols = tile_smat_layout(hp_t, wp, step)
    ts, yt, xs = sites_local[:, 0], sites_local[:, 1], sites_local[:, 2]
    qrow_arr = jnp.asarray([int(p) % step for p in qrow0], jnp.int32)
    ph = qrow_arr[jnp.clip(ts, 0, qrow_arr.shape[0] - 1)]
    is_last = gy == hp_g - 1
    on_row = ((gy % step) == ph) & ~is_last
    k = jnp.where(on_row, (gy - ph) // step, 0)
    g = (ph + k) % step
    row_main = g * gmax + yt // (step * step)
    row = jnp.where(is_last, 0 * gmax + (gmax - 1),
                    jnp.where(on_row, row_main, ph * gmax + (gmax - 2)))
    c_row = jnp.where(is_last, 0, jnp.where(on_row, g, ph))
    on_col = (xs % step) == c_row
    col = jnp.where(on_col, 2 + (xs - c_row) // step,
                    jnp.where(xs == 0, 0, 1))
    return ts * (n_rows * n_cols) + row * n_cols + col
