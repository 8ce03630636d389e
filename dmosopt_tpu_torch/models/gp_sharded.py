"""Mesh-sharded exact-GP fit: a tiled, right-looking blocked Cholesky
over row slabs.

Port of ``dmosopt_tpu/models/gp_sharded.py:97-627`` (after the tiled
Cholesky designs of GPRat and HPX-GPU, PAPERS.md). The JAX package
writes these stages as ``shard_map`` programs in XLA, not in Pallas; here
each rank of the mesh's axis (one process per device,
`parallel.mesh`) runs the same code on its own slab with the
collectives written out, and the panel factor, the triangular solves
and the trailing products are ``torch.linalg.cholesky_ex``,
``torch.linalg.solve_triangular`` and ``torch.matmul``:

- **The factor** (`_Programs.chol`): the (P, P) masked, regularized
  kernel lives row-sharded, rank p owning rows [p·P/n, (p+1)·P/n). Each
  B-wide panel step broadcasts the panel's B rows (each rank scatters
  the rows it owns into a zero (B, P) block, one ``all_reduce(SUM)`` of
  disjoint contributions), every rank factors the B×B diagonal block the
  same way, solves its own slab's column block against it, gathers the
  (P, B) panel column (one ``all_gather``) and applies the rank-B
  trailing update to its own rows. Work a rank is P³/n; no rank holds
  the whole matrix.
- **The whitening factor** W = L⁻¹ (`_Programs.whiten`) by a
  column-sharded blocked forward substitution over the same broadcast
  panels: rank p solves its own P/n identity columns. Then ``u = W y``
  (one ``all_reduce``), ``alpha = Wᵀu`` (one ``all_gather``) and the
  log-determinant (one ``all_reduce``) give the NMLL.
- **The NMLL's backward pass** (`_ShardedNMLL`, a
  ``torch.autograd.Function``) uses dNMLL/dK = ½(K⁻¹ − ααᵀ): K⁻¹ = WᵀW
  is assembled row-sharded by a ring of send/recv stages over W's
  column slabs (`parallel.mesh.ring_shift`), and chained into the
  hyperparameters through autograd of this rank's kernel rows, the
  partial gradients summed over the ranks. No reverse pass runs through
  the panel loop.

`fit_gp_sharded` is `models.gp.fit_gp_batch` with every NMLL and its
gradient computed this way: the same restart grid (the same draws from
the same generator), the same bounded reparameterization, the same
Adam numerics and convergence stop (`gp._minimize`). Its (S, d) grid is
walked one cell at a time, as the JAX package walks it with
``lax.map``: the sharded path serves large archives, where one slab
set a rank is the memory budget. Every scalar a decision reads (the
NMLL, the gradients) is the same on every rank after its collective, so
the ranks stay in lockstep.

The fit's result is replicated: the final factor L is gathered (one
``all_gather`` per objective), so every consumer (the solve and matmul
predictors, a rank-k update, the refit controller, `interop`) sees
ordinary tensors on every rank; the whitening factor W is gathered too
unless the caller will not read it (``gather_whitened``: `models.gp`
skips it for the ``solve`` predictor), and a matmul predictor adopts W
without rebuilding it. Only the fit's working set is sharded: a rank
holds O(P²/n) of it (its kernel rows, its L rows, its W columns, its
K⁻¹ rows and one (P, B) panel column), where `gp.fit_gp_batch` holds
the (S, d) grid's kernels and their autograd buffers at once, several
S·d·P² floats. Every rank ends holding the d·P² floats of L (2·d·P²
with W), so the route serves archives whose dense factors fit on one
device but whose batched dense fit does not. The JAX package leaves L
and W row-sharded arrays, which XLA gathers on use.

Routing lives in `GPR_Matern` (``surrogate_mesh``, `models.gp`): opt-in,
gated by the archive size (``min_points``) and a finite probe of the
fit's NMLL, which discards a non-finite sharded fit for the
single-device fit on the same device (the JAX package's numerical
routing, counted in ``gp_shard_fallbacks_total``). A routed fit records
``gp_shard_*`` telemetry through the process hook
(`set_gp_shard_telemetry`, `record_sharded_fit`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dmosopt_tpu_torch.models.gp import (
    _JITTER,
    _KERNELS,
    _LOG2PI,
    GPFit,
    _cholesky_or_nan,
    _default_rel_jitter,
    _fit_bounds,
    _minimize,
    _resolve_convergence_defaults,
    _restart_grid,
)
from dmosopt_tpu_torch.parallel.mesh import (
    all_gather,
    all_reduce,
    axis_index,
    axis_size,
    ring_shift,
)

# the run's telemetry, set by `run()` for its duration (None: no calls)
_TELEMETRY = None


def set_gp_shard_telemetry(tel) -> None:
    """Attach a `telemetry.Telemetry` (or None) to the sharded-fit layer
    (``dmosopt_tpu/models/gp_sharded.py:87``): routed sharded fits then
    record ``gp_shard_fits_total``, ``gp_shard_fallbacks_total``, the
    ``gp_shard_devices`` / ``gp_shard_tile_size`` gauges and the
    ``gp_shard_fit_seconds`` histogram. Process-wide; `run()` sets it
    for the run and clears it after."""
    global _TELEMETRY
    _TELEMETRY = tel


def record_sharded_fit(
    ok: bool, wall_s: float, n_devices: int, tile: int, n_train: int,
    bucket: int, d: int,
) -> None:
    """Host-side accounting of one routed sharded fit (called by the
    routing layer in `models.gp` around the fit)."""
    tel = _TELEMETRY
    if not tel:
        return
    tel.inc("gp_shard_fits_total")
    if not ok:
        tel.inc("gp_shard_fallbacks_total")
    tel.gauge("gp_shard_devices", float(n_devices))
    tel.gauge("gp_shard_tile_size", float(tile))
    tel.observe("gp_shard_fit_seconds", float(wall_s))
    tel.event(
        "gp_shard_fit", ok=bool(ok), n_devices=int(n_devices),
        tile=int(tile), n_train=int(n_train), bucket=int(bucket),
        n_objectives=int(d), wall_s=round(float(wall_s), 6),
    )


def default_chol_tile(P: int) -> int:
    """Panel width of the tiled Cholesky: the largest power of two
    <= 512 that divides ``P`` (bucket sizes are multiples of 64, so this
    is >= 64 on every routed shape)."""
    b = 1
    while b * 2 <= min(P, 512) and P % (b * 2) == 0:
        b *= 2
    return b


def mesh_compatible(mesh, axis: str, P: int) -> bool:
    """True when `fit_gp_sharded` can serve (mesh, axis, P): the axis
    exists and P splits into whole per-rank row slabs."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return False
    n_sh = axis_size(mesh, axis)
    return n_sh >= 1 and P % n_sh == 0 and (P // n_sh) >= 1


class _Programs:
    """The sharded stages for one (mesh, axis, P, tile, kernel,
    rel_jitter): this rank's slab rows of the kernel, the blocked
    Cholesky, the whitening solve and the NMLL pieces. ``y`` must be
    zero on masked rows (`gp._nmll`'s contract)."""

    def __init__(self, mesh, axis: str, P: int, B: int, kernel: str, rel_jitter: float):
        n_sh = axis_size(mesh, axis)
        if P % n_sh or P % B:
            raise ValueError(
                f"sharded GP fit needs P divisible by both the mesh axis "
                f"({n_sh}) and the tile ({B}); got P={P}"
            )
        self.mesh, self.axis, self.P, self.B = mesh, axis, P, B
        self.kernel_fn = _KERNELS[kernel]
        self.rel_jitter = float(rel_jitter)
        self.n_sh = n_sh
        self.L_loc = P // n_sh
        self.p = axis_index(mesh, axis)
        self.lo = self.p * self.L_loc

    def _gidx(self, dev):
        return self.lo + torch.arange(self.L_loc, device=dev)

    def k_rows(self, amp, ls, noise, X, m):
        """This rank's (L_loc, P) rows of the masked, regularized kernel,
        the matrix `gp._apply_train_mask(gp._regularized_kernel(...))`
        builds dense."""
        P = self.P
        gidx = self._gidx(X.device)
        sl = slice(self.lo, self.lo + self.L_loc)
        m_loc = m[sl]
        K = self.kernel_fn(X[sl], X, ls, amp) * (m_loc[:, None] * m[None, :])
        jitter = _JITTER + self.rel_jitter * amp
        eye = (torch.arange(P, device=X.device)[None, :] == gidx[:, None]).to(X.dtype)
        return K + eye * ((noise + jitter) * m_loc[:, None] + (1.0 - m_loc[:, None]))

    def _panel(self, A_loc, off):
        """Rows [off, off+B) of the row-sharded matrix on every rank: each
        scatters the rows it owns into a zero (B, P) block and one
        ``all_reduce(SUM)`` of the disjoint blocks assembles the panel."""
        B = self.B
        a, b = max(off, self.lo), min(off + B, self.lo + self.L_loc)
        contrib = torch.zeros((B, A_loc.shape[1]), dtype=A_loc.dtype, device=A_loc.device)
        if a < b:
            contrib[a - off:b - off] = A_loc[a - self.lo:b - self.lo]
        return all_reduce(contrib, self.mesh, self.axis)

    def chol(self, K_loc):
        """Right-looking blocked Cholesky over P/B panel steps; returns
        this rank's (L_loc, P) rows of L. A diagonal block that is not
        positive definite gives a NaN factor, as `gp._cholesky_or_nan`."""
        B, P = self.B, self.P
        dev, dt = K_loc.device, K_loc.dtype
        gidx = self._gidx(dev)
        A = K_loc.clone()
        for off in range(0, P, B):
            panel = self._panel(A, off)  # (B, P)
            Ljj = _cholesky_or_nan(panel[:, off:off + B])  # the replicated panel factor
            C = A[:, off:off + B]
            # panel triangular solve: L[i, off:off+B] = A[i, ..] Ljj⁻ᵀ
            Lcol = torch.linalg.solve_triangular(Ljj, C.mT, upper=False).mT
            rel = gidx - off
            in_panel = (rel >= 0) & (rel < B)
            trailing = gidx >= off + B
            newcol = torch.where(in_panel[:, None], Ljj[rel.clamp(0, B - 1)], Lcol)
            A[:, off:off + B] = torch.where((in_panel | trailing)[:, None], newcol, C)
            # rank-B trailing update of this rank's rows, after one gather
            # of the (P, B) panel column (rows outside the trailing block
            # zeroed, so finished columns are never touched)
            Lfull = all_gather(torch.where(trailing[:, None], Lcol, 0.0),
                               self.mesh, self.axis, dim=0)
            A = A - torch.matmul(Lcol, Lfull.mT) * trailing[:, None].to(dt)
        # the upper triangle holds stale Schur values
        return A * (torch.arange(P, device=dev)[None, :] <= gidx[:, None]).to(dt)

    def whiten(self, L_slab):
        """This rank's (P, L_loc) column slab of W = L⁻¹ by blocked
        forward substitution over the broadcast panels."""
        B, P = self.B, self.P
        dev, dt = L_slab.device, L_slab.dtype
        mycols = self._gidx(dev)
        ar = torch.arange(P, device=dev)
        Wc = torch.zeros((P, self.L_loc), dtype=dt, device=dev)
        for off in range(0, P, B):
            panel = self._panel(L_slab, off)
            Ljj = panel[:, off:off + B]
            rhs = ((off + torch.arange(B, device=dev))[:, None] == mycols[None, :]).to(dt)
            rhs = rhs - torch.matmul(panel * (ar < off).to(dt)[None, :], Wc)
            Wc[off:off + B] = torch.linalg.solve_triangular(Ljj, rhs, upper=False)
        return Wc

    def stats(self, Wc, L_slab, m, y):
        """(alpha (P,), nmll ()) from the factored pieces."""
        sl = slice(self.lo, self.lo + self.L_loc)
        u = all_reduce(torch.matmul(Wc, y[sl]), self.mesh, self.axis)  # W y
        alpha = all_gather(torch.matmul(Wc.mT, u), self.mesh, self.axis)
        diag = L_slab[torch.arange(self.L_loc, device=L_slab.device), self._gidx(L_slab.device)]
        logdet = all_reduce(torch.sum(torch.log(diag)), self.mesh, self.axis)
        nmll = 0.5 * torch.dot(y, alpha) + logdet + 0.5 * torch.sum(m) * _LOG2PI
        return alpha, nmll

    def factor(self, amp, ls, noise, X, m, y):
        L_slab = self.chol(self.k_rows(amp, ls, noise, X, m))
        Wc = self.whiten(L_slab)
        alpha, nmll = self.stats(Wc, L_slab, m, y)
        return nmll, Wc, alpha, L_slab

    def kinv_rows(self, Wc):
        """This rank's (L_loc, P) rows of K⁻¹ = WᵀW: a ring of n stages,
        each multiplying this rank's column slab by the visiting one."""
        Kinv = torch.empty((self.L_loc, self.P), dtype=Wc.dtype, device=Wc.device)
        block = Wc
        for s in range(self.n_sh):
            q = (self.p - s) % self.n_sh  # owner of the visiting slab
            Kinv[:, q * self.L_loc:(q + 1) * self.L_loc] = torch.matmul(Wc.mT, block)
            if s + 1 < self.n_sh:
                block = ring_shift(block, self.mesh, self.axis)
        return Kinv


class _ShardedNMLL(torch.autograd.Function):
    """The scalar exact NMLL of one objective's GP, differentiable with
    respect to (amp, ls, noise) through dNMLL/dK = ½(K⁻¹ − ααᵀ) and
    with respect to y (alpha); X and the mask get no gradient."""

    @staticmethod
    def forward(ctx, amp, ls, noise, X, m, y, prog):
        nmll, Wc, alpha, _ = prog.factor(amp, ls, noise, X, m, y)
        ctx.prog = prog
        ctx.save_for_backward(amp, ls, noise, X, m, Wc, alpha)
        return nmll

    @staticmethod
    def backward(ctx, g):
        amp, ls, noise, X, m, Wc, alpha = ctx.saved_tensors
        prog = ctx.prog
        sl = slice(prog.lo, prog.lo + prog.L_loc)
        G = 0.5 * (prog.kinv_rows(Wc) - alpha[sl, None] * alpha[None, :])
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (amp, ls, noise)]
            K_loc = prog.k_rows(*leaves, X, m)
            grads = torch.autograd.grad(K_loc, leaves, grad_outputs=G)
        ga, gl, gn = (all_reduce(gr, prog.mesh, prog.axis) for gr in grads)
        return g * ga, g * gl, g * gn, None, None, g * alpha, None


def _programs(mesh, shard_axis, P, tile, kernel, rel_jitter, dtype):
    if rel_jitter is None:
        rel_jitter = _default_rel_jitter(dtype)
    B = int(tile) if tile is not None else default_chol_tile(P)
    return _Programs(mesh, shard_axis, P, B, kernel, rel_jitter)


def nmll_sharded(
    amp, ls, noise, X, train_mask, y, *, mesh, shard_axis: str = "pop",
    tile: Optional[int] = None, kernel: str = "matern52",
    rel_jitter: Optional[float] = None,
):
    """Scalar exact NMLL of one objective's GP, computed mesh-sharded and
    differentiable with respect to (amp, ls, noise, y) through the
    analytic backward pass (``dmosopt_tpu/models/gp_sharded.py:438``).
    ``y`` must be zero on masked rows; the dense oracle is `gp._nmll`."""
    prog = _programs(mesh, shard_axis, X.shape[0], tile, kernel, rel_jitter, X.dtype)
    return _ShardedNMLL.apply(amp, ls, noise, X, train_mask.to(X.dtype), y, prog)


def _posterior(prog, X, tm, amp, ls, noise, Ym, gather_whitened=True):
    """(L, W, alpha, nmll) of d objectives, L and W gathered: ((d, P, P),
    (d, P, P), (d, P), (d,)); W is None without ``gather_whitened``."""
    Ls, Ws, alphas, nmlls = [], [], [], []
    for k in range(Ym.shape[1]):
        nmll, Wc, alpha, L_slab = prog.factor(amp[k], ls[k], noise[k], X, tm, Ym[:, k])
        Ls.append(all_gather(L_slab, prog.mesh, prog.axis, dim=0))
        if gather_whitened:
            Ws.append(all_gather(Wc, prog.mesh, prog.axis, dim=1))
        del Wc
        alphas.append(alpha)
        nmlls.append(nmll)
    W = torch.stack(Ws) if gather_whitened else None
    return torch.stack(Ls), W, torch.stack(alphas), torch.stack(nmlls)


@torch.no_grad()
def posterior_sharded(
    X: torch.Tensor,  # (P, n)
    Yn: torch.Tensor,  # (P, d) standardized targets
    train_mask: torch.Tensor,  # (P,)
    amp: torch.Tensor,  # (d,)
    ls: torch.Tensor,  # (d, L)
    noise: torch.Tensor,  # (d,)
    kernel: str = "matern52",
    rel_jitter: Optional[float] = None,
    *,
    mesh,
    shard_axis: str = "pop",
    tile: Optional[int] = None,
):
    """Masked factorization at fixed hyperparameters, mesh-sharded
    (``dmosopt_tpu/models/gp_sharded.py:457``): the distributed analogue
    of `gp.posterior_from_params`, its oracle. Returns ``(L, W, alpha,
    nmll)`` of shapes ((d, P, P), (d, P, P), (d, P), (d,)), replicated."""
    prog = _programs(mesh, shard_axis, X.shape[0], tile, kernel, rel_jitter, X.dtype)
    tm = train_mask.to(X.dtype)
    return _posterior(prog, X, tm, amp, ls, noise, Yn * tm[:, None])


def fit_gp_sharded(
    generator: torch.Generator,
    X: torch.Tensor,  # (P, n) unit box (possibly bucket-padded)
    Y: torch.Tensor,  # (P, d) standardized targets
    lengthscale_bounds: Tuple[float, float] = (1e-3, 100.0),
    amplitude_bounds: Tuple[float, float] = (1e-4, 1e3),
    noise_bounds: Tuple[float, float] = (1e-9, 1e-2),
    kernel: str = "matern52",
    n_starts: int = 8,
    n_iter: int = 200,
    learning_rate: float = 0.1,
    ard: bool = False,
    rel_jitter: Optional[float] = None,
    train_mask: Optional[torch.Tensor] = None,
    mesh=None,
    shard_axis: str = "pop",
    tile: Optional[int] = None,
    convergence_tol="auto",
    convergence_check_every: Optional[int] = None,
    warm_start: Optional[Tuple] = None,
    gather_whitened: bool = True,
) -> GPFit:
    """`gp.fit_gp_batch` with the N-axis work mesh-sharded
    (``dmosopt_tpu/models/gp_sharded.py:492-627``): the same restart grid
    from the same generator draws, the same bounded reparameterization,
    Adam and convergence stop, every NMLL and gradient by the sharded
    stages, the (S, d) grid walked cell by cell. Returns a `GPFit` whose
    ``whitened`` holds W = L⁻¹ (d, P, P), replicated like ``L`` (None
    without ``gather_whitened``, which spares every rank d·P² floats).
    Parity with `fit_gp_batch` is to reduction order, not bitwise."""
    if mesh is None:
        raise ValueError("fit_gp_sharded requires a mesh")
    P, n = X.shape
    dt, dev = X.dtype, X.device
    tm = (torch.ones(P, dtype=dt, device=dev) if train_mask is None
          else train_mask.to(dt))
    Y = Y * tm[:, None]
    d = Y.shape[1]
    convergence_tol, convergence_check_every = _resolve_convergence_defaults(
        d, convergence_tol, convergence_check_every
    )
    Lls = n if ard else 1
    prog = _programs(mesh, shard_axis, P, tile, kernel, rel_jitter, dt)
    bounds3 = _fit_bounds(lengthscale_bounds, amplitude_bounds, noise_bounds, dt, dev)
    b_amp, b_ls, b_noise = bounds3
    params = _restart_grid(generator, (), n_starts, d, Lls, bounds3, warm_start, dt, dev)

    def loss(u_amp, u_ls, u_noise):
        amp, ls, noise = b_amp.forward(u_amp), b_ls.forward(u_ls), b_noise.forward(u_noise)
        vals = [
            [_ShardedNMLL.apply(amp[s, k], ls[s, k], noise[s, k], X, tm, Y[:, k], prog)
             for k in range(d)]
            for s in range(n_starts)
        ]
        return torch.stack([torch.stack(row) for row in vals])

    best_params, final, n_steps = _minimize(
        params, loss, (n_starts, d), learning_rate, n_iter, convergence_tol,
        convergence_check_every, lambda v: torch.amin(v, dim=0),
    )
    best = torch.argmin(final, dim=0)  # (d,)
    ar = torch.arange(d, device=dev)
    amp = b_amp.forward(best_params[0][best, ar])
    ls = b_ls.forward(best_params[1][best, ar])
    noise = b_noise.forward(best_params[2][best, ar])
    with torch.no_grad():
        L, W, alpha, _ = _posterior(prog, X, tm, amp, ls, noise, Y, gather_whitened)
    return GPFit(
        X=X, L=L, alpha=alpha, amp=amp, ls=ls, noise=noise,
        y_mean=torch.zeros(d, dtype=dt, device=dev),
        y_std=torch.ones(d, dtype=dt, device=dev),
        nmll=torch.amin(final, dim=0), train_mask=tm, n_steps=n_steps,
        best_start=best, whitened=W,
    )
