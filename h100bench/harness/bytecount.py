"""Bytes the fused offspring step must move: each input byte it needs
read once, each output byte written once.

A frozen copy of the count in ``chip_smoke.py`` (``_offspring_work``,
the bucket rows of ``_check_bucket``) and of the pair-index rule of
``ops/variation.py`` (``_pair_indices``), kept here so that a change to
the program cannot change the yardstick: each pair's three uniforms, the
gene uniforms its operator uses (one on a crossover slot, two on a
mutation slot), the distinct pool slots and population rows it gathers,
the per-gene vectors and rates once, the offspring and tags written
once."""

import torch


def _pair_indices(r, pool_n, shift_hi):
    pool_n, shift_hi = pool_n.unsqueeze(-1), shift_hi.unsqueeze(-1)
    i1 = (r[..., 0, :] * pool_n).long()
    shift = 1 + (r[..., 1, :] * (shift_hi - 1)).long()
    return i1, (i1 + shift) % pool_n


def offspring_bytes_one(parm, pool_idx, r, u, pool_n, shift_hi, is_x):
    """Bytes of one population's step: ``parm`` (pop, n), ``pool_idx``
    (poolsize,), ``r`` (3, npairs), ``u`` (3, npairs, n), 0-d pool
    size and shift, the (npairs,) operator tags the step returned."""
    npairs, n = u.shape[1], u.shape[2]
    i1, i2 = _pair_indices(r, pool_n, shift_hi)
    slots = torch.unique(torch.cat([i1, i2]))
    rows = torch.unique(pool_idx[slots]).numel()
    nx = int(is_x.sum())
    nm = npairs - nx
    return (4 * r.numel()                  # pair uniforms
            + 4 * n * (nx + 2 * nm)        # gene uniforms used
            + 8 * slots.numel()            # pool slots
            + 4 * n * rows                 # population rows
            + 4 * 4 * n + 3 * 4            # per-gene vectors and rates
            + 4 * 2 * npairs * n + npairs)  # offspring and tags


def offspring_bytes(args, is_x):
    """Bytes of one launch of ``launch_offspring(*args)`` that returned
    tags ``is_x``: one population, or the sum over a bucket's tenants."""
    parm, pool_idx, r, u, pool_n, shift_hi = args[:6]
    if parm.dim() == 2:
        return offspring_bytes_one(parm, pool_idx, r, u, pool_n, shift_hi, is_x)
    return sum(
        offspring_bytes_one(parm[t], pool_idx[t], r[t], u[t], pool_n[t], shift_hi[t], is_x[t])
        for t in range(parm.shape[0]))
