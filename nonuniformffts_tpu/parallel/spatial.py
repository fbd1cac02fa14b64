"""Grid-sharded multi-device NUFFT: the oversampled grid split into slabs.

The reference is single-device (SURVEY.md section 2: no distributed layer
exists there); this module scales one transform over the devices of a 1-D
mesh so that per-device grid memory is O(grid / n_devices):

- the OVERSAMPLED grid is sharded along dim 0: device r owns the planes
  [r*L, (r+1)*L) with L = N0~/n;
- non-uniform points arrive sharded along Np in arbitrary order;
  ``set_points`` routes each point to its owner device with one
  capacity-bounded ``all_to_all`` (bin by destination slab -> sort -> pad
  each (src, dst) lane to a static capacity; overflow is detected and
  reported, never silently dropped);
- spreading scatters into the device's slab extended by the 2M-1 halo
  planes; the halos travel to the neighbouring slabs by ``ppermute`` — the
  device-level version of the reference's ghost-cell merge
  (src/spreading/cpu_blocked.jl:3-36); interpolation receives its halo
  planes the same way;
- the FFT is distributed: dims 1..D-1 transform locally, one tiled
  ``all_to_all`` moves the sharding from dim 0 to dim 1, and the dim-0 FFT
  runs locally.  Truncation/padding and the deconvolution factors are
  applied along the way (dim-1 factors sliced per device).

Everything runs inside one ``shard_map`` over the mesh; XLA hands the
collectives to NCCL on GPUs.

Spectrum layout: with ``spectrum='replicated'`` (default) every device
holds the full (C, 2) + spectral_shape array.  ``spectrum='sharded'``
keeps it sharded along spectral dim 1, the layout the distributed FFT
produces anyway, so the final all_gather (type 1) and the initial slice
(type 2) disappear and per-device memory is O(N^D / n) end to end.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..blocking import cells_and_fracs
from ..ops.deconvolve import pad_axis, truncate_axis
from ..ops.interpolation import interpolate_cells
from ..ops.spreading import spread_cells
from ..plan import PlanNUFFT, _canonicalise_points, _identity
from ..utils.pytree import data_field, register_pytree_dataclass, static_field


@register_pytree_dataclass
class SpatialPoints:
    """Routed point state, one leading mesh axis (device) on every leaf."""

    send_idx: jnp.ndarray = data_field(default=None)  # (n, S) local pt idx
    send_valid: jnp.ndarray = data_field(default=None)  # (n, S) bool
    send_pos: jnp.ndarray = data_field(default=None)  # (n, Npl) slot in send buf
    recv_valid: jnp.ndarray = data_field(default=None)  # (n, S) bool
    cells: jnp.ndarray = data_field(default=None)  # (n, D, S) slab-local cells
    fracs: jnp.ndarray = data_field(default=None)  # (n, D, S)
    num_points: int = static_field(default=0)  # global Np


class SpatialNUFFT:
    """Grid-sharded NUFFT over a 1-D device mesh.

    Channel-form API: values/spectra are real arrays with a (C, 2, ...)
    layout for complex dtypes, (C, ...) for real ones.

    Parameters mirror :func:`PlanNUFFT`; additionally ``mesh`` (a 1-D
    ``jax.sharding.Mesh``), ``capacity_factor`` (routing slack: each
    (src device -> dst device) lane holds up to ``capacity_factor *
    Np_local/n`` points; heavier skew raises a ValueError at set_points)
    and ``spectrum`` ('replicated' or 'sharded', see the module notes).
    """

    def __init__(
        self,
        dtype,
        shape,
        *,
        mesh: Mesh,
        axis_name: Optional[str] = None,
        capacity_factor: float = 4.0,
        spectrum: str = "replicated",
        **plan_kw,
    ):
        if len(mesh.axis_names) != 1:
            raise ValueError("SpatialNUFFT expects a 1-D mesh")
        if spectrum not in ("replicated", "sharded"):
            raise ValueError(f"unknown spectrum layout {spectrum!r}")
        self.mesh = mesh
        self.axis_name = axis_name or mesh.axis_names[0]
        self.n = mesh.shape[self.axis_name]
        self.capacity_factor = float(capacity_factor)
        self.spectrum = spectrum
        plan_kw["spread_method"] = "reference"
        base = PlanNUFFT(dtype, shape, **plan_kw)
        if base.ndim < 2:
            raise ValueError("spatial sharding needs >= 2 dimensions")
        n = self.n
        if base.shape_over[0] % n or base.shape_over[0] // n < base.m:
            raise ValueError(
                f"oversampled dim-0 size {base.shape_over[0]} must split into "
                f"{n} slabs of at least M={base.m} planes"
            )
        if base.spectral_shape[1] % n:
            raise ValueError(
                f"spectral dim-1 size {base.spectral_shape[1]} must divide by "
                f"the mesh size {n}"
            )
        self.base = base
        self.slab = base.shape_over[0] // n

    # -- set_points -----------------------------------------------------------
    def _capacity(self, np_local: int) -> int:
        cap = int(math.ceil(self.capacity_factor * np_local / self.n))
        return max(-(-cap // 8) * 8, 8)

    def set_points(self, points) -> SpatialPoints:
        """Route points to their owner devices.

        ``points``: any format :func:`set_points` accepts; the Np axis must
        divide evenly by the mesh size (shard it beforehand or let this
        place it).
        """
        pts = _canonicalise_points(points, self.base.ndim, self.base.real_dtype)
        np_total = int(pts.shape[1])
        if np_total % self.n:
            raise ValueError(
                f"number of points {np_total} must divide by mesh size {self.n}"
            )
        cap = self._capacity(np_total // self.n)
        ax = self.axis_name

        @partial(
            jax.shard_map,
            mesh=self.mesh,
            in_specs=(P(), P(None, ax)),
            out_specs=(P(ax),) * 7,
        )
        def body(plan, pts_l):
            out = _route(plan, pts_l, self.n, cap, self.slab, ax)
            return tuple(x[None] for x in out)

        (send_idx, send_valid, send_pos, recv_valid, cells, fracs,
         overflow) = jax.jit(body)(self.base, pts)
        if bool(jnp.any(overflow)):
            raise ValueError(
                "point routing overflow: a (src, dst) device lane exceeded its "
                f"capacity ({cap} points). The point distribution is too "
                "skewed for capacity_factor="
                f"{self.capacity_factor}; increase it."
            )
        return SpatialPoints(
            send_idx=send_idx, send_valid=send_valid, send_pos=send_pos,
            recv_valid=recv_valid, cells=cells, fracs=fracs,
            num_points=np_total,
        )

    # -- transforms -----------------------------------------------------------
    def _spectrum_pspec(self):
        """PartitionSpec of the channel-form spectrum (C, 2) + spectral_shape
        under the configured layout."""
        if self.spectrum == "replicated":
            return P()
        return P(None, None, None, self.axis_name)

    def _state_specs(self, num_points):
        ax = self.axis_name
        return SpatialPoints(
            send_idx=P(ax), send_valid=P(ax), send_pos=P(ax),
            recv_valid=P(ax), cells=P(ax), fracs=P(ax),
            num_points=num_points,
        )

    def exec_type1(self, state: SpatialPoints, v_ch) -> jnp.ndarray:
        """Distributed type 1.  ``v_ch``: (C, 2, Np) channel values (complex
        plans) or (C, Np) (real plans).  Returns the channel-form spectrum
        (C, 2) + spectral_shape — replicated, or sharded along spectral dim
        1 when ``spectrum='sharded'``."""
        base = self.base
        ax = self.axis_name
        v_ch = jnp.asarray(v_ch, base.real_dtype)
        vspec = P(*([None] * (v_ch.ndim - 1) + [ax]))

        @partial(
            jax.shard_map,
            mesh=self.mesh,
            check_vma=False,
            in_specs=(P(), self._state_specs(state.num_points), vspec),
            out_specs=self._spectrum_pspec(),
        )
        def body(plan, st, v_l):
            return _exec_type1_body(self, plan, _unlead(st), v_l)

        return jax.jit(body)(base, state, v_ch)

    def exec_type2(self, state: SpatialPoints, uhat_ch) -> jnp.ndarray:
        """Distributed type 2.  ``uhat_ch``: channel-form spectrum (C, 2) +
        spectral_shape in the configured layout.  Returns (C, 2, Np) / (C,
        Np) channel values in the caller's original point order."""
        base = self.base
        ax = self.axis_name
        uhat_ch = jnp.asarray(uhat_ch, base.real_dtype)
        out_spec = P(None, ax) if base.is_real else P(None, None, ax)

        @partial(
            jax.shard_map,
            mesh=self.mesh,
            in_specs=(
                P(), self._state_specs(state.num_points),
                self._spectrum_pspec(),
            ),
            out_specs=out_spec,
        )
        def body(plan, st, u):
            return _exec_type2_body(self, plan, _unlead(st), u)

        return jax.jit(body)(base, state, uhat_ch)

    def collective_bytes(self) -> dict:
        """Estimated bytes one device sends per transform, by collective:
        the halo planes, the all_to_all transpose of the (dims >= 1
        truncated) grid and, for the replicated layout, the spectrum
        gather."""
        base = self.base
        n = self.n
        isz = np.dtype(base.complex_dtype).itemsize
        C = base.ntransforms
        plane = int(np.prod(base.shape_over[1:]))
        spec = int(np.prod(base.spectral_shape))
        transposed = base.shape_over[0] * int(np.prod(base.spectral_shape[1:]))
        out = {"spectrum": self.spectrum, "n": n}
        out["halo_ppermute"] = C * (2 * base.m - 1) * plane * isz
        out["transpose_all_to_all"] = int(C * transposed * isz * (n - 1) / n / n)
        out["spectrum_all_gather"] = (
            0 if self.spectrum == "sharded"
            else int(C * spec * isz * (n - 1) / n)
        )
        return out


def _unlead(st: SpatialPoints):
    """Strip the leading per-device axis (size 1 inside shard_map)."""
    return jax.tree.map(lambda a: a[0], st)


# ---------------------------------------------------------------------------
# shard_map bodies
# ---------------------------------------------------------------------------


def _route(plan, pts_l, n, cap, slab, ax):
    """Per device: bin local points by destination slab, pad each (src,
    dst) lane to ``cap``, exchange the cell split with one all_to_all."""
    D, npl = pts_l.shape
    if plan.point_transform is not _identity:
        pts_l = plan.point_transform(pts_l)
    cells, fracs = cells_and_fracs(plan.kernel_data, pts_l)
    dest = jnp.clip(cells[0] // slab, 0, n - 1).astype(jnp.int32)

    iota = jnp.arange(npl, dtype=jnp.int32)
    sdest, perm = jax.lax.sort_key_val(dest, iota)
    dstarts = jnp.searchsorted(
        sdest, jnp.arange(n + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    counts = dstarts[1:] - dstarts[:-1]
    overflow = jnp.any(counts > cap)

    S = n * cap
    slot = jnp.arange(S, dtype=jnp.int32)
    d_of = slot // cap
    sidx = jnp.take(dstarts, d_of) + slot % cap
    send_valid = sidx < jnp.take(dstarts, d_of + 1)
    send_idx = jnp.take(perm, jnp.clip(sidx, 0, max(npl - 1, 0)))

    rank = iota - jnp.take(dstarts, sdest)
    pos_sorted = jnp.where(rank < cap, sdest * cap + rank, -1)
    _, send_pos = jax.lax.sort_key_val(perm, pos_sorted)

    def exchange(x):  # (R, Npl) -> (R, S) at the owner devices
        xs = jnp.take(x, send_idx, axis=1).reshape(x.shape[0], n, cap)
        xr = jax.lax.all_to_all(xs, ax, split_axis=1, concat_axis=1)
        return xr.reshape(x.shape[0], S)

    recv_valid = jax.lax.all_to_all(
        send_valid.reshape(n, cap), ax, split_axis=0, concat_axis=0
    ).reshape(S)
    cells_r = exchange(cells)
    fracs_r = exchange(fracs)
    me = jax.lax.axis_index(ax).astype(jnp.int32)
    # Slab-local dim-0 cells; invalid (padding) lanes sit at plane 0 and
    # carry zero values / discarded outputs.
    c0 = jnp.where(recv_valid, cells_r[0] - me * slab, 0)
    cells_r = cells_r.at[0].set(c0)
    return send_idx, send_valid, send_pos, recv_valid, cells_r, fracs_r, overflow


def _route_values(v_flat, send_idx, send_valid, n, cap, ax):
    """(CR, Npl) original-order values -> (CR, S) routed to owner devices."""
    vs = jnp.take(v_flat, send_idx, axis=1) * send_valid[None, :].astype(
        v_flat.dtype
    )
    vs = vs.reshape(v_flat.shape[0], n, cap)
    vr = jax.lax.all_to_all(vs, ax, split_axis=1, concat_axis=1)
    return vr.reshape(v_flat.shape[0], n * cap)


def _unroute_values(r_flat, send_pos, n, cap, ax):
    """(CR, S) values at owner devices -> (CR, Npl) back in original order."""
    rs = r_flat.reshape(r_flat.shape[0], n, cap)
    rb = jax.lax.all_to_all(rs, ax, split_axis=1, concat_axis=1)
    rb = rb.reshape(r_flat.shape[0], n * cap)
    pos = jnp.clip(send_pos, 0, n * cap - 1)
    return jnp.take(rb, pos, axis=1)


def _local_geometry(sp: SpatialNUFFT, plan):
    """Kernel data and cell offset of the halo-extended local slab: dim 0
    spans L + 2M - 1 planes with local plane c + M - 1 holding slab cell c,
    so no stencil ever wraps along dim 0."""
    ext = sp.slab + 2 * plan.m - 1
    kd = (dataclasses.replace(plan.kernel_data[0], n=ext),) + tuple(
        plan.kernel_data[1:]
    )
    return kd, (ext,) + plan.shape_over[1:]


def _ring(n, step):
    return [(i, (i + step) % n) for i in range(n)]


def _exec_type1_body(sp: SpatialNUFFT, plan, st, v_l):
    ax, n, m, L = sp.axis_name, sp.n, plan.m, sp.slab
    cap = st.send_idx.shape[0] // n
    D = plan.ndim
    C = v_l.shape[0]
    v_r = _route_values(v_l.reshape(-1, v_l.shape[-1]), st.send_idx,
                        st.send_valid, n, cap, ax)
    if plan.is_real:
        vals = v_r.astype(plan.dtype)
    else:
        v_r = v_r.reshape(C, 2, -1)
        vals = jax.lax.complex(v_r[:, 0], v_r[:, 1]).astype(plan.dtype)

    kd, ext_shape = _local_geometry(sp, plan)
    cells = st.cells.at[0].add(m - 1)
    g = spread_cells(kd, plan.evalmode, ext_shape, cells, st.fracs, vals,
                     chunk_size=plan.chunk_size)
    # Halo merge: the first M-1 planes belong to the previous slab's tail,
    # the last M planes to the next slab's head.
    core = g[:, m - 1 : m - 1 + L]
    head = jax.lax.ppermute(g[:, m - 1 + L :], ax, _ring(n, 1))
    core = core.at[:, :m].add(head)
    if m > 1:
        tail = jax.lax.ppermute(g[:, : m - 1], ax, _ring(n, -1))
        core = core.at[:, L - (m - 1) :].add(tail)

    # ---- distributed forward FFT + truncation + deconvolution ----
    rngs = plan.index_ranges
    x = core
    if plan.is_real:
        x = jnp.fft.rfft(x, axis=-1)
    else:
        x = jnp.fft.fft(x, axis=-1)
    x = truncate_axis(x, D, rngs[D - 1])
    for d in range(D - 2, 0, -1):
        x = truncate_axis(jnp.fft.fft(x, axis=1 + d), 1 + d, rngs[d])
    # Transpose the sharding dim0 <-> dim1 and do the dim-0 FFT locally.
    x = jax.lax.all_to_all(x, ax, split_axis=2, concat_axis=1, tiled=True)
    x = truncate_axis(jnp.fft.fft(x, axis=1), 1, rngs[0])
    x = x * jnp.asarray(plan.normfactor, x.real.dtype)
    x = _scale_phihat(x, plan, jax.lax.axis_index(ax))
    if sp.spectrum == "replicated":
        x = jax.lax.all_gather(x, ax, axis=2, tiled=True)
    return jnp.stack([x.real, x.imag], axis=1).astype(plan.real_dtype)


def _scale_phihat(x, plan, me):
    """Multiply by the per-dim deconvolution factors; dim 1 is sharded."""
    for d in range(plan.ndim):
        ph = plan.phihat_inv[d]
        if d == 1:
            k = x.shape[2]
            ph = jax.lax.dynamic_slice_in_dim(ph, me * k, k)
        shape = [1] * x.ndim
        shape[1 + d] = ph.shape[0]
        x = x * ph.reshape(shape)
    return x


def _exec_type2_body(sp: SpatialNUFFT, plan, st, u):
    ax, n, m, L = sp.axis_name, sp.n, plan.m, sp.slab
    cap = st.send_idx.shape[0] // n
    D = plan.ndim
    me = jax.lax.axis_index(ax)
    rngs = plan.index_ranges
    x = jax.lax.complex(u[:, 0], u[:, 1]).astype(plan.complex_dtype)
    C = x.shape[0]
    if sp.spectrum == "replicated":
        k1 = x.shape[2] // n
        x = jax.lax.dynamic_slice_in_dim(x, me * k1, k1, axis=2)
    x = _scale_phihat(x, plan, me)

    # Dim 0: pad + unnormalised backward FFT locally (full axis present),
    # then transpose the sharding back to dim 0.
    n0 = plan.shape_over[0]
    x = jnp.fft.ifft(pad_axis(x, 1, rngs[0], n0), axis=1) * n0
    x = jax.lax.all_to_all(x, ax, split_axis=1, concat_axis=2, tiled=True)
    for d in range(1, D - 1):
        nd = plan.shape_over[d]
        x = jnp.fft.ifft(pad_axis(x, 1 + d, rngs[d], nd), axis=1 + d) * nd
    nl = plan.shape_over[D - 1]
    if plan.is_real:
        x = pad_axis(x, D, rngs[D - 1], nl // 2 + 1)
        grid = jnp.fft.irfft(x, n=nl, axis=-1) * nl
    else:
        grid = jnp.fft.ifft(pad_axis(x, D, rngs[D - 1], nl), axis=-1) * nl

    # Halo gather: the previous slab's last M-1 planes, then this slab,
    # then the next slab's first M planes.
    parts = [grid, jax.lax.ppermute(grid[:, :m], ax, _ring(n, -1))]
    if m > 1:
        parts.insert(0, jax.lax.ppermute(grid[:, L - (m - 1) :], ax, _ring(n, 1)))
    ext = jnp.concatenate(parts, axis=1)

    kd, _ = _local_geometry(sp, plan)
    cells = st.cells.at[0].add(m - 1)
    vals = interpolate_cells(kd, plan.evalmode, ext, cells, st.fracs,
                             plan.normfactor, chunk_size=plan.chunk_size)
    if plan.is_real:
        flat = vals.real.astype(plan.real_dtype)
    else:
        flat = jnp.stack([vals.real, vals.imag], axis=1).reshape(2 * C, -1)
    flat = flat * st.recv_valid[None, :].astype(flat.dtype)
    back = _unroute_values(flat, st.send_pos, n, cap, ax)
    return back if plan.is_real else back.reshape(C, 2, -1)
