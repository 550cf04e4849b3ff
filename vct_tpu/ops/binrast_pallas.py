"""Raster-style binned raycast: screen-space triangle binning (XLA) + a
Pallas-Triton kernel that walks each screen strip's triangle segment.

The reference gets primary visibility from the HARDWARE RASTERIZER
(main.cpp:77-94, VoxelConeTracing.vs + fixed-function raster + depth
test): per-frame work scales with triangles, not rays x scene.  The brute
force (render/gbuffer.py) tests every ray against every triangle; this
module earns raster scaling with the raster's own structure:

  1. Project every triangle to GNOMONIC screen coordinates
     (u, v) = (p.ex / p.f, p.ey / p.f) for a frame (ex, ey, f) built
     from the actual ray grid.  Gnomonic projection maps great circles
     to straight lines, so a triangle's screen-space AABB is exactly the
     AABB of its (clipped) vertices, and a 16x64-pixel STRIP's bound is
     exactly the AABB of its own rays' (u, v) — conservative for ANY
     central camera, no pinhole matrix needed.
  2. Bin each triangle to the strips its AABB overlaps (searchsorted
     over monotone column/row envelopes).  Triangles crossing the
     near plane are clipped against z = ZEPS first; fully-behind
     triangles drop (no forward ray can hit them).
  3. Sort (bin, tri) pairs by bin and gather each bin's triangle
     constants into one contiguous SLICE-aligned segment of a transposed
     (10, NP) table.  Per-strip work is proportional to the triangles
     that actually project onto the strip (mean ~190 per strip at 287k
     triangles and 1080p, vs all 287k for the brute force).
  4. Bins come in TWO granularities sharing the one sort: per-STRIP
     segments for triangles covering <= KB strips, and per-COLUMN
     segments for wide ones (near-plane straddlers legitimately span
     many rows of a few columns).  Each strip walks its own segment then
     its column's, as one loop.

The kernel runs a (strip, ray block) grid: each program loads its strip's
four segment scalars, then loops over SLICE-triangle slices of the
segment — a data-dependent trip count that XLA could only express by
materialising padded (rays x max segment) arrays.  Best t and triangle id
ride the loop carry.

Testing a SUPERSET of a strip's overlapping triangles is always safe:
the kernel takes the min-t winner, and extra candidates can only move
the result toward the brute-force answer.  That makes every budget/
margin decision here conservative-by-construction, and lets segment
reads run over into the next bin's rows instead of special-casing the
tail.

Per (ray, triangle) the math is render/gbuffer.intersect_chunk_pinhole's
(Moller-Trumbore with the shared origin folded into per-triangle
constants, conditions multiplied through by |det|), and ties at equal t
go to the lowest triangle id, as the oracle's argmin does.  The kernel
reports only (t, triangle id); barycentrics and attributes come from
gbuffer.hits_to_gbuffer, so gradients w.r.t. materials, light and
radiance flow through XLA exactly as in renderer.render_rays.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from vct_tpu.render.gbuffer import DeviceScene, PinholeConstants

Array = jax.Array

STRIP_H = 16         # strip rows
STRIP_W = 64         # strip columns; the padded frame is a multiple of both
STRIPE = STRIP_H * STRIP_W   # rays per strip (contiguous in strip order)
SLICE = 32           # triangles per kernel loop iteration; segments are
                     # padded to a multiple of it
RAYS = 64            # rays per kernel program (STRIPE % RAYS == 0)
NUM_WARPS = 4
NUM_STAGES = 2
KA = 4               # slots per triangle in the dense emission (covers
                     # AABBs up to 4 strips — ~60% of tris at Sponza scale)
KB = 16              # slots per triangle in the medium emission
KC = 32              # slots per triangle in the per-column emission
                     # (caps the strip-grid width: 2048-pixel frames)
ZEPS = 1e-3          # near-plane clip distance (world units)
NROWS = 10           # table rows: a (3), b (3), c (3), k (1)
EPS = 1e-7           # |det| floor (gbuffer.intersect_chunk_pinhole)
TMIN_EPS = 1e-4      # t > 1e-4, multiplied through by |det|


def _budgets(t_real: int):
    """Static emission budgets, scaled with the scene so the medium and
    column tiers cannot overflow at Sponza-class counts (counted at 287k
    tris / 1080p: ~10.6k medium, ~0.2k column; medium overflow falls back
    to the column tier, so only the column budget is load-bearing)."""
    nb_med = min(max(16384, t_real // 12), t_real)
    nb_col = min(max(8192, t_real // 32), t_real)
    return nb_med, nb_col


def strip_order(img: Array) -> Array:
    """(hp, wp, ...) padded image -> strip-major (hp*wp, ...): each
    16x64-pixel strip's rays contiguous, strips in row-major order."""
    hp, wp = img.shape[:2]
    c = img.shape[2:]
    x = img.reshape((hp // STRIP_H, STRIP_H, wp // STRIP_W, STRIP_W) + c)
    x = jnp.moveaxis(x, 2, 1)
    return x.reshape((hp * wp,) + c)


def strip_unorder(flat: Array, hp: int, wp: int) -> Array:
    """Inverse of strip_order."""
    c = flat.shape[1:]
    x = flat.reshape((hp // STRIP_H, wp // STRIP_W, STRIP_H, STRIP_W) + c)
    x = jnp.moveaxis(x, 2, 1)
    return x.reshape((hp, wp) + c)


def _gnomonic_frame(dimg: Array):
    """Orthonormal (ex, ey, f): f = the frustum axis (the sum of the four
    corner rays — edge padding keeps the frame's own corners), ex along
    the image x axis.  A mean over the padded rays would lean toward the
    replicated edges and leave rays grazing the projection plane."""
    f = dimg[0, 0] + dimg[0, -1] + dimg[-1, 0] + dimg[-1, -1]
    f = f / jnp.maximum(jnp.linalg.norm(f), 1e-12)
    ex = jnp.sum(dimg[:, -1] - dimg[:, 0], axis=0)
    ex = ex - jnp.dot(ex, f) * f
    ex = ex / jnp.maximum(jnp.linalg.norm(ex), 1e-12)
    ey = jnp.cross(f, ex)
    return ex, ey, f


def bin_triangles(ds: DeviceScene, origin: Array, dflat: Array,
                  dimg: Array) -> Tuple[Array, Array, Array]:
    """Screen-space binning -> per-strip contiguous triangle segments.

    dflat: (ns*STRIPE, 3) unit rays in strip order (strip_order); dimg:
    the same rays as the padded (hp, wp, 3) image (hp % 16 == 0,
    wp % 64 == 0).

    Returns (scal (4, ns) int32 [strip-segment row offset, strip slices,
    column-segment row offset, column slices], tri_p (NP,) int32 triangle
    id of every table row, n_col_total).  Budgets overflow
    conservatively: medium overflow joins the column tier; column
    overflow beyond NB_COL is dropped from binning (check the returned
    n_col_total <= NB_COL to rule that out for a camera).
    """
    hp, wp = dimg.shape[:2]
    assert hp % STRIP_H == 0 and wp % STRIP_W == 0, (hp, wp)
    srows, scols = hp // STRIP_H, wp // STRIP_W
    assert scols <= KC, (scols, "raise KC for frames wider than 2048px")
    ns = srows * scols
    n = dflat.shape[0]
    assert n == ns * STRIPE, (n, ns)

    ex, ey, f = _gnomonic_frame(dimg)

    def mv(a, b):
        # exact f32 matvec a (..., 3) . b (3,) as multiply-adds: a TF32
        # matmul would shift projections by a sizeable part of a strip
        return a[..., 0] * b[0] + a[..., 1] * b[1] + a[..., 2] * b[2]

    # --- strip rects from their own rays (+ one-pixel margin) ---
    z = mv(dflat, f)
    u = mv(dflat, ex) / z
    v = mv(dflat, ey) / z
    pu = (jnp.max(u) - jnp.min(u)) / wp
    pv = (jnp.max(v) - jnp.min(v)) / hp
    us = u.reshape(ns, STRIPE)
    vs = v.reshape(ns, STRIPE)
    # sign so strip-grid columns ascend in u and rows ascend in v
    ucol = jnp.mean(us, axis=1).reshape(srows, scols)
    vrow = jnp.mean(vs, axis=1).reshape(srows, scols)
    su = jnp.where(ucol[0, 0] <= ucol[0, -1], 1.0, -1.0)
    sv = jnp.where(vrow[0, 0] <= vrow[-1, 0], 1.0, -1.0)
    us = us * su
    vs = vs * sv
    s_ulo = jnp.min(us, axis=1) - pu
    s_uhi = jnp.max(us, axis=1) + pu
    s_vlo = jnp.min(vs, axis=1) - pv
    s_vhi = jnp.max(vs, axis=1) + pv

    # monotone column/row envelopes (conservative for near-separable
    # grids: prefix-max his, suffix-min los)
    col_hi = jax.lax.cummax(jnp.max(s_uhi.reshape(srows, scols), axis=0))
    row_hi = jax.lax.cummax(jnp.max(s_vhi.reshape(srows, scols), axis=1))
    col_lo = jax.lax.cummin(jnp.min(s_ulo.reshape(srows, scols), axis=0),
                            reverse=True)
    row_lo = jax.lax.cummin(jnp.min(s_vlo.reshape(srows, scols), axis=1),
                            reverse=True)

    # --- triangle screen AABBs with near-plane clipping ---
    t_real = ds.v0.shape[0]
    verts = jnp.stack([ds.v0, ds.v0 + ds.e1, ds.v0 + ds.e2],
                      axis=1) - origin[None, None, :]      # (T, 3, 3)
    vz = mv(verts, f)                                       # (T, 3)
    front = vz > ZEPS
    all_behind = ~jnp.any(front, axis=1)
    # candidates: the 3 vertices (where in front) + the 3 edge crossings
    # of z = ZEPS (where the edge straddles the plane)
    e_a = verts
    e_b = jnp.roll(verts, -1, axis=1)
    za = vz
    zb = jnp.roll(vz, -1, axis=1)
    cross = front ^ jnp.roll(front, -1, axis=1)
    w = (ZEPS - za) / jnp.where(jnp.abs(zb - za) < 1e-20, 1e-20, zb - za)
    pcross = e_a + w[..., None] * (e_b - e_a)
    cand = jnp.concatenate([e_a, pcross], axis=1)           # (T, 6, 3)
    cval = jnp.concatenate([front, cross], axis=1)          # (T, 6)
    cz = jnp.maximum(mv(cand, f), ZEPS)
    cu = mv(cand, ex) / cz * su
    cv = mv(cand, ey) / cz * sv
    t_ulo = jnp.min(jnp.where(cval, cu, jnp.inf), axis=1)
    t_uhi = jnp.max(jnp.where(cval, cu, -jnp.inf), axis=1)
    t_vlo = jnp.min(jnp.where(cval, cv, jnp.inf), axis=1)
    t_vhi = jnp.max(jnp.where(cval, cv, -jnp.inf), axis=1)

    jmin = jnp.clip(jnp.searchsorted(col_hi, t_ulo, side="left"),
                    0, scols - 1)
    jmax = jnp.searchsorted(col_lo, t_uhi, side="right") - 1
    imin = jnp.clip(jnp.searchsorted(row_hi, t_vlo, side="left"),
                    0, srows - 1)
    imax = jnp.searchsorted(row_lo, t_vhi, side="right") - 1
    nw = jnp.maximum(jmax - jmin + 1, 0)
    nh = jnp.maximum(imax - imin + 1, 0)
    area = jnp.where(all_behind, 0, nw * nh)

    # three emission tiers: strip slots (dense + budgeted medium) and
    # per-column slots for the wide tail
    nb_med, nb_col = _budgets(t_real)
    is_a = (area >= 1) & (area <= KA)
    is_m0 = (area > KA) & (area <= KB)
    rank_m = jnp.cumsum(is_m0.astype(jnp.int32))
    m_over = is_m0 & (rank_m > nb_med)
    is_m = is_m0 & ~m_over
    is_c0 = ((area > KB) | m_over) & ~all_behind & (nw >= 1) & (nh >= 1)
    rank_c = jnp.cumsum(is_c0.astype(jnp.int32))
    is_c = is_c0 & (rank_c <= nb_col)
    n_col_total = jnp.sum(is_c0.astype(jnp.int32))

    def emit(slots, jmn, jmx, imn, tri_ids, valid, cap, col_tier):
        kk = jnp.arange(cap, dtype=jnp.int32)[None, :]
        if col_tier:             # bins [ns, ns+scols): one per column
            binid = ns + jmn[:, None] + kk
        else:
            ww = jnp.maximum(jmx - jmn + 1, 1)[:, None]
            binid = ((imn[:, None] + kk // ww) * scols
                     + jmn[:, None] + kk % ww)
        ok = valid[:, None] & (kk < slots[:, None])
        binid = jnp.where(ok, binid, ns + scols).astype(jnp.int32)
        tri = jnp.broadcast_to(tri_ids[:, None], binid.shape).astype(
            jnp.int32)
        return binid.reshape(-1), tri.reshape(-1)

    tri_ids = jnp.arange(t_real, dtype=jnp.int32)
    ta, ra = emit(area, jmin, jmax, imin, tri_ids, is_a, KA, False)
    # ONE argsort selects both budgeted tiers at dynamic offsets
    key3 = jnp.where(is_m, 0, jnp.where(is_c, 1, 2)).astype(jnp.int32)
    order = jnp.argsort(key3, stable=True)
    n_m = jnp.sum(is_m.astype(jnp.int32))
    tmax_ = order.shape[0]
    m_sel = jax.lax.dynamic_slice(order, (0,), (nb_med,))
    c_sel = jax.lax.dynamic_slice(
        order, (jnp.minimum(n_m, tmax_ - nb_col),), (nb_col,))
    tm, rm = emit(area[m_sel], jmin[m_sel], jmax[m_sel], imin[m_sel],
                  m_sel.astype(jnp.int32), is_m[m_sel], KB, False)
    tc, rc = emit(nw[c_sel], jmin[c_sel], jmax[c_sel], imin[c_sel],
                  c_sel.astype(jnp.int32), is_c[c_sel], KC, True)
    bins_all = jnp.concatenate([ta, tm, tc])
    tris_all = jnp.concatenate([ra, rm, rc])
    if t_real < (1 << 19):
        # pack (bin, tri) into one int32 word and sort values (one key
        # instead of a two-operand stable sort); sentinel 0x7FFFFFFF
        # lands last
        nbins_pk = ns + scols
        words = jnp.where(bins_all >= nbins_pk, jnp.int32(0x7FFFFFFF),
                          (bins_all << 19) | tris_all)
        sw = jnp.sort(words)
        sorted_bin = jnp.where(sw == 0x7FFFFFFF, nbins_pk, sw >> 19)
        sorted_tri = jnp.where(sw == 0x7FFFFFFF, 0, sw & 0x7FFFF)
    else:
        sorted_bin, sorted_tri = jax.lax.sort(
            (bins_all, tris_all), dimension=0, num_keys=1, is_stable=True)

    # per-bin segments (strips then columns), SLICE-aligned in the
    # padded table
    nbins = ns + scols
    bounds = jnp.searchsorted(sorted_bin,
                              jnp.arange(nbins + 1, dtype=jnp.int32),
                              side="left").astype(jnp.int32)
    c_i = bounds[1:] - bounds[:-1]
    p_i = -(-c_i // SLICE) * SLICE
    pad_off = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(p_i)])     # (nbins+1,)
    slots_total = bins_all.shape[0]
    np_rows = slots_total + SLICE * (nbins + 1)            # static bound

    # dest row -> source slot: src = dest - (pad_off[bin] - bounds[bin]),
    # a piecewise-constant shift, built by scattering per-boundary deltas
    # and cumsumming.  No validity mask is needed: a padding row's src
    # points at the NEXT bin's entries (or a sentinel slot whose tri id is
    # still a real triangle), and testing extra real triangles is
    # conservative by construction (see module header).
    bnd = pad_off[1:nbins]                   # first row of bins 1..
    def stepped(vals):                       # vals (nbins,) -> (NP,)
        base = jnp.zeros((np_rows,), jnp.int32).at[bnd].add(
            vals[1:] - vals[:-1])
        return jnp.cumsum(base) + vals[0]
    padmb = stepped(pad_off[:nbins] - bounds[:nbins])
    src = jnp.clip(jnp.arange(np_rows, dtype=jnp.int32) - padmb,
                   0, slots_total - 1)
    tri_p = sorted_tri[src]

    nseg = p_i[:ns] // SLICE
    col_of = ns + jnp.arange(ns, dtype=jnp.int32) % scols
    scal = jnp.stack([pad_off[:ns], nseg, pad_off[col_of],
                      p_i[col_of] // SLICE], axis=0)        # (4, ns)
    return scal, tri_p, n_col_total


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Bins:
    """One camera's binned triangle table (bin_scene)."""

    scal: Array      # (4, ns) int32 per-strip segment offsets/lengths
    table: Array     # (NROWS, NP) f32 intersection constants, binned
    tri: Array       # (NP,) int32 triangle id of each table column


def bin_scene(ds: DeviceScene, pc: PinholeConstants, origin: Array,
              dflat: Array, dimg: Array) -> Bins:
    """bin_triangles + the gathered constant table the kernel streams.
    Depends on the camera only, so alpha re-casts reuse it."""
    scal, tri_p, _ = bin_triangles(ds, origin, dflat, dimg)
    tbl = jnp.concatenate([pc.a, pc.b, pc.c, pc.k[:, None]], axis=1)
    return Bins(scal=scal, table=tbl[tri_p].T, tri=tri_p)


def _kernel(scal_ref, dirs_ref, tmin_ref, tbl_ref, tri_ref, t_ref, id_ref):
    """One RAYS-ray block of one strip against the strip's segment, then
    its column's: per-slice min t (ties -> lowest triangle id), carried
    best (t, id)."""
    s = pl.program_id(0)
    rays = pl.ds(s * STRIPE + pl.program_id(1) * RAYS, RAYS)
    dx = dirs_ref[0, rays][:, None]
    dy = dirs_ref[1, rays][:, None]
    dz = dirs_ref[2, rays][:, None]
    tmin = tmin_ref[rays]
    seg, nseg = scal_ref[0, s], scal_ref[1, s]
    col, ncol = scal_ref[2, s], scal_ref[3, s]
    # a block whose rays are all retired (tmin = +inf: the alpha re-cast's
    # unmasked pixels) has nothing to find
    total = jnp.where(jnp.min(tmin) == jnp.inf, 0, nseg + ncol)
    tmin = tmin[:, None]
    big = jnp.iinfo(jnp.int32).max

    def body(p, carry):
        tb, ib = carry
        base = jnp.where(p < nseg, seg + p * SLICE,
                         col + (p - nseg) * SLICE)
        tris = pl.ds(pl.multiple_of(base, SLICE), SLICE)

        def row(r):
            return tbl_ref[r, tris][None, :]

        # exact-f32 K=3 contractions as multiply-adds (a dot could run in
        # TF32 and flip `valid` under the cancellation in the
        # origin-folded constants)
        def dot3(r):
            return dx * row(r) + dy * row(r + 1) + dz * row(r + 2)

        det = dot3(0)
        ud = dot3(3)
        vd = dot3(6)
        kk = row(9)
        sg = jnp.sign(det)
        ad = jnp.abs(det)
        tval = (sg * kk) / jnp.maximum(ad, EPS)
        valid = ((ad > EPS) & (sg * ud >= 0) & (sg * vd >= 0)
                 & (sg * (ud + vd) <= ad) & (sg * kk > TMIN_EPS * ad)
                 & (tval > tmin))
        tc = jnp.where(valid, tval, jnp.inf)
        tm = jnp.min(tc, axis=1)
        im = jnp.min(jnp.where(tc == tm[:, None], tri_ref[tris][None, :],
                               big), axis=1)
        better = (tm < tb) | ((tm == tb) & (im < ib))
        return jnp.where(better, tm, tb), jnp.where(better, im, ib)

    tb, ib = jax.lax.fori_loop(
        0, total, body, (jnp.full((RAYS,), jnp.inf, jnp.float32),
                         jnp.full((RAYS,), big, jnp.int32)))
    t_ref[rays] = tb
    id_ref[rays] = jnp.where(tb < jnp.inf, ib, 0)


@functools.partial(jax.jit, static_argnames=("interpret",))
def raycast_binned(bins: Bins, dflat: Array, tmin: Array,
                   interpret: bool = False) -> Tuple[Array, Array]:
    """Closest hit of (n, 3) strip-ordered rays from the binned table:
    (t (n,) with +inf on a miss, tri (n,) int32, 0 on a miss).  Only hits
    with t > tmin (n,) count; tmin = +inf retires a ray."""
    n = dflat.shape[0]
    assert n % STRIPE == 0 and STRIPE % RAYS == 0, n
    ns = n // STRIPE
    assert bins.scal.shape == (4, ns), bins.scal.shape
    t, tri = pl.pallas_call(
        _kernel,
        grid=(ns, STRIPE // RAYS),
        out_shape=(jax.ShapeDtypeStruct((n,), jnp.float32),
                   jax.ShapeDtypeStruct((n,), jnp.int32)),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="binned_raycast",
    )(bins.scal, dflat.T, tmin, bins.table, bins.tri)
    return jax.lax.stop_gradient(t), tri
