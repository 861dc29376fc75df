"""Wide-halo (march-inward) barotropic subcycle — the production
shard_map path.

The reference widens the barotropic solver's halos so each rank marches
many substeps without communicating, exchanging once per cycle
(BT_HALO_SIZE / BTHALO, src/core/MOM_barotropic.F90:2506-2518,5450 and
the march-inward valid-range bookkeeping at :2505-2520).  Under GSPMD,
XLA instead inserts a CollectivePermute per shifted operand per substep
— at pod scale that is nstep x ~8 collective rounds per baroclinic step
of a few-microsecond kernel each, and latency dominates.  This module
is the shard_map equivalent of the reference's scheme:

* every 2-D field the substep body reads is padded with a ``W``-cell
  rim and filled from its mesh neighbors with ``jax.lax.ppermute``
  (x phase, then y phase so corners ride along, then the tripolar-fold
  phase for the top shard row);
* each shard then marches ``E = W // halo_per_substep`` substeps with
  PURE LOCAL rolls (the stencil kit of barotropic.local_kit) — rim
  corruption moves inward ``halo_per_substep`` cells per substep and
  never reaches the core between exchanges (the per-substep dependency
  radius of the forward-backward body is exactly 2: the deepest chain
  is eta_corr <- vhbt_new <- cor_v <- ubt_new <- pf/cor of the entry
  fields, two one-sided shifts);
* the evolving fields (ubt, vbt, eta, uhbt, vhbt) are re-exchanged
  every E substeps; static fields are filled once.  Each exchange
  stacks all participating fields into ONE array per transfer, so a
  rim refresh costs ~7 small collectives regardless of field count.

Topology lives entirely in the rim content: x wrap is a periodic
ppermute (REENTRANT_X), walls are zeroed rims (matching the dense
path's masked wrap reads, which are zero because the masked fields are
zero in the wrap rows), and the tripolar fold is the mirrored partner
exchange with the staggering shifts of framework.stencil.fold_ghost.
BT_cont curves cross the fold with their east/west (north/south) roles
swapped and velocity thresholds sign-flipped, matching the 180-degree
rotation (find_uhbt(-u, mirrored curves) == -find_uhbt(u, curves)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mom6_tpu.core.barotropic import (BTFields, _acc_add, _acc_zero,
                                      _make_half_step, local_kit)

__all__ = ["run_subcycle_widehalo", "FIELD_KINDS"]

# staggering kind of every BTFields leaf (see framework.stencil.jp1):
#   h  cell-center scalar          u  u-face x-vector (fold sign flip)
#   us u-face scalar               v  v-face y-vector (fold sign flip)
#   vs v-face scalar               q  corner scalar
FIELD_KINDS = dict(
    eta_PF="h", gtot="h", IareaT="h", dyn_coef="h",
    bt_force_u="u", cor_ref_u="u", uhbt0="u",
    bt_force_v="v", cor_ref_v="v", vhbt0="v",
    tot_hu="us", rem_u="us", drag_u="us", mask_u="us", IdxCu="us",
    Datu="us",
    tot_hv="vs", rem_v="vs", drag_v="vs", mask_v="vs", IdyCv="vs",
    Datv="vs",
    q_f="q",
    # OBC fields (never combined with a fold: OBC segments live on open
    # regional boundaries, tripolar grids are global)
    obc_mask_u="us", obc_mask_v="vs", obc_mask_cell="h",
    obc_sign_u="us", obc_sign_v="vs", obc_uvel_ext="u",
    obc_vvel_ext="v", obc_eta_ext="h", obc_c_fl_u="us", obc_c_fl_v="vs",
)
# BT_cont components swap roles across the fold (E<->W, N<->S) with the
# velocity thresholds changing sign: (kind, fold-source partner)
BTC_KINDS = dict(
    FA_u_W0=("us", "FA_u_E0"), FA_u_E0=("us", "FA_u_W0"),
    FA_u_WW=("us", "FA_u_EE"), FA_u_EE=("us", "FA_u_WW"),
    uBT_WW=("u", "uBT_EE"), uBT_EE=("u", "uBT_WW"),
    uh_crvW=("us", "uh_crvE"), uh_crvE=("us", "uh_crvW"),
    FA_v_S0=("vs", "FA_v_N0"), FA_v_N0=("vs", "FA_v_S0"),
    FA_v_SS=("vs", "FA_v_NN"), FA_v_NN=("vs", "FA_v_SS"),
    vBT_SS=("v", "vBT_NN"), vBT_NN=("v", "vBT_SS"),
    vh_crvS=("vs", "vh_crvN"), vh_crvN=("vs", "vh_crvS"),
)
EVOLVE_KINDS = ("u", "v", "h", "u", "v")    # ubt, vbt, eta, uhbt, vhbt


def _pull(block, ax, toward, n):
    """ppermute translation: every shard sends ``block`` to its
    neighbor at index+``toward`` along mesh axis ``ax`` (periodic;
    ``n`` is the static mesh extent along ``ax``)."""
    if n == 1:
        return block
    perm = [(i, (i + toward) % n) for i in range(n)]
    return jax.lax.ppermute(block, ax, perm)


def _fold_ghost_rows(recv, kind, W):
    """Ghost rows above the fold from the partner's top (W+1) core rows
    ``recv`` ((W+1, nxp), bottom-to-top, x rims FRESH, not mirrored —
    this flips).  Returns (W, nxp) rows ordered bottom-to-top (ghost
    row k = k cells above the fold mirrors partner row ny-k for on-fold
    kinds, ny-1-k for kinds whose top row lies ON the fold), the W-row
    generalization of framework.stencil.fold_ghost.  The x roll of the
    face/corner kinds wraps at the padded edge — one garbage column,
    repaired by the caller's post-fold x phase."""
    m = recv[::-1, ::-1]                # x mirror + top-to-bottom
    if kind in ("h", "dh"):
        rows = m[:W]                    # rows ny-1, ny-2, ... ny-W
    elif kind in ("u", "us"):
        rows = jnp.roll(m[:W], -1, axis=-1)
    elif kind in ("v", "vs"):
        rows = m[1:W + 1]               # rows ny-2 ... ny-1-W
    elif kind in ("q", "qv"):
        rows = jnp.roll(m[1:W + 1], -1, axis=-1)
    else:                               # pragma: no cover
        raise ValueError(kind)
    if kind in ("u", "v", "qv", "dh"):
        rows = -rows
    return rows


def _make_exchange(W: int, fold: bool, reentrant_x: bool,
                   my: int, mx: int):
    """Build the stacked rim-refresh functions for padded local arrays
    ``zs`` of shape (F, nyp, nxp).

    Order inside ``exchange``: x phase (full-height columns), y phase
    (full-width rows — senders' x rims are already fresh, so corners
    arrive correct), wall zeroing, the fold phase for the top shard
    row, then one more x phase restricted to the top rim rows (repairs
    the fold kinds' roll-wrapped outermost column; a value-preserving
    no-op for non-top shards)."""

    def xphase(zs):
        xi = jax.lax.axis_index("x")
        right = _pull(zs[..., :, W:2 * W], "x", -1, mx)
        left = _pull(zs[..., :, -2 * W:-W], "x", +1, mx)
        zs = zs.at[..., :, -W:].set(right).at[..., :, :W].set(left)
        if not reentrant_x:
            # global x walls: zero the outermost shards' outer rims
            # (dense-path wrap reads are zero there because the masked
            # fields are zero in the wrap rows)
            zs = jnp.where(xi == 0, zs.at[..., :, :W].set(0.0), zs)
            zs = jnp.where(xi == mx - 1, zs.at[..., :, -W:].set(0.0), zs)
        return zs

    def yphase(zs):
        yi = jax.lax.axis_index("y")
        top = _pull(zs[..., W:2 * W, :], "y", -1, my)
        bot = _pull(zs[..., -2 * W:-W, :], "y", +1, my)
        zs = zs.at[..., -W:, :].set(top).at[..., :W, :].set(bot)
        # global south is always a wall; north is a wall unless fold
        zs = jnp.where(yi == 0, zs.at[..., :W, :].set(0.0), zs)
        if not fold:
            zs = jnp.where(yi == my - 1, zs.at[..., -W:, :].set(0.0), zs)
        return zs

    def foldphase(zs, kinds, src):
        """Fill the top-shard-row rim from the mirrored fold partner.
        ``src`` is the stacked fold SOURCE per field (x rims fresh) —
        ``zs`` itself except for BT_cont, whose E/W (N/S) partners
        swap."""
        yi = jax.lax.axis_index("y")
        blk = src[..., -2 * W - 1:-W, :]        # (F, W+1, nxp) top core
        if mx > 1:
            perm = [(i, mx - 1 - i) for i in range(mx)]
            blk = jax.lax.ppermute(blk, "x", perm)
        ghost = jnp.stack([_fold_ghost_rows(blk[f], k, W)
                           for f, k in enumerate(kinds)])
        zs = jnp.where(yi == my - 1, zs.at[..., -W:, :].set(ghost), zs)
        # repair the roll-wrapped outermost column of the face/corner
        # ghost rows: the x neighbors' ghost rows are samples of the
        # same global ghost function, so a plain x refresh of the top
        # rim rows restores it (and re-sends already-valid data on
        # non-top shards — harmless)
        tr = zs[..., -W:, :]
        r = _pull(tr[..., :, W:2 * W], "x", -1, mx)
        l = _pull(tr[..., :, -2 * W:-W], "x", +1, mx)
        tr = tr.at[..., :, -W:].set(r).at[..., :, :W].set(l)
        return zs.at[..., -W:, :].set(tr)

    def exchange(zs, kinds, fold_src=None):
        zs = xphase(zs)
        src = zs if fold_src is None else fold_src
        zs = yphase(zs)
        if fold:
            zs = foldphase(zs, kinds, src)
        return zs

    return xphase, exchange


def run_subcycle_widehalo(F: BTFields, consts: dict, evolve0, wt_trans,
                          wt_vel, nstep: int, nfilter: int,
                          first_u_leads: bool, params, G):
    """Run the btstep subcycle in wide-halo shard_map form; returns the
    same carry dict as the dense runner (filtered averages + finals,
    core shards only)."""
    mesh = params.mesh
    W = int(params.wide_halo)
    R = max(1, int(params.halo_per_substep))
    E = max(2, (W // R) // 2 * 2)       # even substeps per exchange
    if E * R > W:
        raise ValueError(
            f"wide_halo={W} too small for halo_per_substep={R}: "
            f"need wide_halo >= {2 * R}")
    fold = bool(getattr(G, "fold_north", False))
    reentrant_x = bool(getattr(G, "cyclic_x", False))
    if fold and F.obc_mask_u is not None:
        raise ValueError("wide-halo OBC + tripolar fold is unsupported")
    my = mesh.shape["y"]
    mx = mesh.shape["x"]
    ny, nx = F.eta_PF.shape[-2:]
    if min(ny // my, nx // mx) < W:
        raise ValueError(
            f"wide_halo={W} exceeds a {ny // my}x{nx // mx} shard")
    n_tot = nstep + nfilter
    n_blocks = n_tot // E
    n_rem = n_tot - n_blocks * E

    spec2d = P("y", "x")
    f_specs = jax.tree.map(lambda _: spec2d, F)
    e_specs = tuple(spec2d for _ in evolve0)
    acc_spec = {k: spec2d for k in
                ("uhbt_av", "vhbt_av", "ubt_av", "vbt_av", "eta_av",
                 "u_acc", "v_acc", "ubt", "vbt", "eta")}

    def shard_fn(Fs: BTFields, evolve, wts_blocks, wts_rem):
        xphase, exchange = _make_exchange(W, fold, reentrant_x, my, mx)

        def pad(z):
            return jnp.pad(z, W)

        # ---- static fields: pad + one stacked rim fill -------------------
        names = [n for n in FIELD_KINDS if getattr(Fs, n) is not None]
        stack = jnp.stack([pad(getattr(Fs, n)) for n in names])
        stack = exchange(stack, [FIELD_KINDS[n] for n in names])
        fd = dict({n: None for n in FIELD_KINDS},
                  **{n: stack[i] for i, n in enumerate(names)})
        btc = None
        if Fs.btc is not None:
            keys = list(BTC_KINDS)
            bs = xphase(jnp.stack([pad(getattr(Fs.btc, k))
                                   for k in keys]))
            idx = {k: i for i, k in enumerate(keys)}
            src = bs[jnp.array([idx[BTC_KINDS[k][1]] for k in keys])] \
                if fold else None
            bs = exchange(bs, [BTC_KINDS[k][0] for k in keys],
                          fold_src=src)
            btc = type(Fs.btc)(**{k: bs[i] for i, k in enumerate(keys)})
        Fp = BTFields(**dict(fd, btc=btc))
        half_step = _make_half_step(Fp, consts, local_kit())

        def refresh(ev):
            s = exchange(jnp.stack(ev), EVOLVE_KINDS)
            return tuple(s[i] for i in range(len(ev)))

        def march(ev, acc, w_t, w_v, n_sub, parity0):
            """n_sub unrolled substeps after one rim refresh."""
            ev = refresh(ev)
            ubt, vbt, eta, uhbt, vhbt = ev
            for k in range(n_sub):
                u_leads = parity0 if k % 2 == 0 else not parity0
                o = half_step(ubt, vbt, eta, uhbt, vhbt, u_leads)
                acc = _acc_add(acc, w_t[k], w_v[k], o)
                ubt, vbt, eta, uhbt, vhbt = o[:5]
            return (ubt, vbt, eta, uhbt, vhbt), acc

        ev = tuple(pad(z) for z in evolve)
        acc = _acc_zero(ev[0], ev[1], ev[2])

        if n_blocks:
            def block(carry, wts):
                ev, acc = carry
                w_t, w_v = wts
                ev, acc = march(ev, acc, w_t, w_v, E, first_u_leads)
                return (ev, acc), None
            (ev, acc), _ = jax.lax.scan(block, (ev, acc), wts_blocks)
        if n_rem:
            # trailing partial block (E does not divide n_tot); parity
            # continues the global alternation since E is even
            w_t, w_v = wts_rem
            ev, acc = march(ev, acc, w_t, w_v, n_rem, first_u_leads)

        core = (slice(W, -W), slice(W, -W))
        out = {k: v[core] for k, v in acc.items()}
        out["ubt"], out["vbt"], out["eta"] = (
            ev[0][core], ev[1][core], ev[2][core])
        return out

    wts_blocks = (
        wt_trans[:n_blocks * E].reshape(n_blocks, E),
        wt_vel[:n_blocks * E].reshape(n_blocks, E))
    wts_rem = (wt_trans[n_blocks * E:], wt_vel[n_blocks * E:])

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(f_specs, e_specs, (P(), P()), (P(), P())),
        out_specs=acc_spec)
    return fn(F, evolve0, wts_blocks, wts_rem)
