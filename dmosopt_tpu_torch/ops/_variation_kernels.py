"""Triton kernels for NSGA-II variation on Hopper.

`launch_mutation` and `launch_sbx` replace the two Pallas TPU kernels of
the JAX package, ``dmosopt_tpu/ops/variation.py:72`` (`_mutation_pallas`)
and ``:90`` (`_sbx_pallas`), and compute what those compute: the
variation math over uniforms drawn outside the kernel. They stay the
CUDA route of the public `polynomial_mutation` and `sbx_crossover`.

`launch_offspring` is the redesign of both for this card. NSGA-II's
generation (``dmosopt_tpu/optimizers/nsga2.py:161-192``) picks two
parents per pair slot from the mating pool, runs SBX on them and
mutates each, and keeps the SBX pair or the two mutants as the slot's
operator draw says. Built from the two standalone kernels plus torch
ops that is some 26 launches of a few microseconds each, and at the
main path's (100 pairs, 30 genes) every one of them is launch latency.
`launch_offspring` is the whole step in one launch: it derives the pair
indices from the pair uniforms, gathers both parents' genes straight
from the population rows, computes the SBX pair and both mutants, and
writes the (2·npairs, n) offspring block and the per-slot operator tag.
The problem-batched core (`tenants.py`) steps a bucket of T tenants'
stacked NSGA-II states at once, as the JAX package's ``jax.vmap`` of
the generation runs both Pallas kernels with a leading tenants axis
(``dmosopt_tpu/tenants.py:433-467``): the grid's third axis is the
tenant, each program offsets every pointer by its tenant's stride, and
a bucket's generation is one launch whatever T. Per-tenant scalars
(pool size, operator rates) are (T,) device tensors read through
pointers like the single population's 0-d ones. A single population
launches the kernel compiled without the tenant offsets (``BUCKET``
False): at 65536 x 256 the offsets' 64-bit pointer arithmetic cost 11%
(169.24 against 152.73 us, H100 80GB HBM3, 700 W).

What bounds them: each is one elementwise pass with no reuse (a handful
of flops per element against 12-28 bytes of traffic), so on an H100 the
floor is device-memory bandwidth at large shapes and launch latency at
the main path's. The designs move the least they can. The standalone
kernels run one flat 1-D grid over the elements, each program a
contiguous BLOCK of them (coalesced, vectorised loads). The fused kernel
runs 2-D tiles of OFFSPRING_TILE elements, (pairs) x (genes of a row):
the per-pair work (index math, pool gather, operator draw) is done once
per pair, and a gathered row's genes are contiguous along the tile's
second axis, so the parent gathers, the uniform reads and the stores
are vector accesses even though the row is a loaded value. A tile of
512 elements on 4 warps (4 elements a thread) keeps enough tiles
resident to hide the chain of dependent loads (pair uniform -> pool
index -> parent row) at the large shape and gives the main path's 3000
genes 7 tiles. It loads only the uniforms its slot's operator uses (the
SBX uniform for a crossover slot, the two mutation uniforms otherwise),
so at the default rates it reads about one uniform per gene instead of
three. What still keeps it at about half of its byte bound at 65536 x
256 is the gather: each pool row is read once per reference, about
twice, and the gathered rows outgrow the 50 MB L2. The per-gene vectors
(``di``, ``xlb``, ``xub``) are read at their column, with a stride
argument, instead of being broadcast to (B, n) as Mosaic wanted on the
TPU, so they cost n words, not B*n. Device scalars (the adaptive
mutation rate, the operator probabilities and, under an adaptive
population size, the live pool size) are read through pointers to 0-d
tensors, neither constexprs nor host values, so a changing value never
recompiles a kernel nor syncs the host. Powers are
``exp2(pw * log2(x))``, which gives exactly 0 at x == 0 for pw > 0. The
operator draw compares against ``2pc / (2pc + pm)`` divided with IEEE
rounding (``div_rn``), so the kernel's operator tags are bit-equal to
the plain version's; the pair indices are the same float32 product
truncated to an integer.

Triton is imported, and the kernels compiled, only inside `launch_*`:
the CPU build of the package imports this module without triton. The
compile cache goes to ``dmosopt_tpu_torch/_build/triton`` unless
``TRITON_CACHE_DIR`` says otherwise, so a checkout builds everything it
runs from its own sources.

`KERNEL_LAUNCHES` counts each kernel's launches: a `launch_*` adds one
(`_count_launch`, under a lock, since the service's scheduler launches
from worker threads) right after it queues its kernel, and nowhere
else.
"""

from __future__ import annotations

import os
import threading

import torch

BLOCK = 1024
NUM_WARPS = 4
# elements of one offspring tile: (pairs) x (genes, up to all of a row)
OFFSPRING_TILE = 512
_KERNELS = None
KERNEL_LAUNCHES = {"mutation": 0, "sbx": 0, "offspring": 0}
# the service's scheduler launches from several worker threads at once:
# one lock guards the counts, another the one-time definition
_COUNT_LOCK = threading.Lock()
_BUILD_LOCK = threading.Lock()


def _count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` to `KERNEL_LAUNCHES`."""
    with _COUNT_LOCK:
        KERNEL_LAUNCHES[name] += 1


def _build():
    """The jitted kernels, defined once per process; triton compiles
    each at its first launch."""
    global _KERNELS
    if _KERNELS is None:
        with _BUILD_LOCK:
            if _KERNELS is None:
                _KERNELS = _define_kernels()
    return _KERNELS


def _define_kernels():
    os.environ.setdefault(
        "TRITON_CACHE_DIR",
        os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build", "triton"),
    )
    import triton
    import triton.language as tl

    @triton.jit
    def mutation_kernel(
        u_ptr, p_ptr, di_ptr, lb_ptr, ub_ptr, rate_ptr, out_ptr,
        total, n, s_di, s_lb, s_ub,
        BLOCK: tl.constexpr,
    ):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = offs < total
        col = offs % n
        u = tl.load(u_ptr + offs, mask=m, other=0.5)
        p = tl.load(p_ptr + offs, mask=m, other=0.0)
        di = tl.load(di_ptr + col * s_di, mask=m, other=1.0)
        lb = tl.load(lb_ptr + col * s_lb, mask=m, other=0.0)
        ub = tl.load(ub_ptr + col * s_ub, mask=m, other=1.0)
        rate = tl.load(rate_ptr)
        pw = 1.0 / (di + 1.0)
        delta_lo = tl.exp2(pw * tl.log2(2.0 * u)) - 1.0
        delta_hi = 1.0 - tl.exp2(pw * tl.log2(2.0 * (1.0 - u)))
        delta = tl.where(u < rate, delta_lo, delta_hi)
        child = p + (ub - lb) * delta
        child = tl.minimum(tl.maximum(child, lb), ub)
        tl.store(out_ptr + offs, child, mask=m)

    @triton.jit
    def sbx_kernel(
        u_ptr, p1_ptr, p2_ptr, di_ptr, lb_ptr, ub_ptr, c1_ptr, c2_ptr,
        total, n, s_di, s_lb, s_ub,
        BLOCK: tl.constexpr,
    ):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = offs < total
        col = offs % n
        u = tl.load(u_ptr + offs, mask=m, other=0.5)
        p1 = tl.load(p1_ptr + offs, mask=m, other=0.0)
        p2 = tl.load(p2_ptr + offs, mask=m, other=0.0)
        di = tl.load(di_ptr + col * s_di, mask=m, other=1.0)
        lb = tl.load(lb_ptr + col * s_lb, mask=m, other=0.0)
        ub = tl.load(ub_ptr + col * s_ub, mask=m, other=1.0)
        pw = 1.0 / (di + 1.0)
        base = tl.where(u <= 0.5, 2.0 * u, 1.0 / (2.0 * (1.0 - u)))
        beta = tl.exp2(pw * tl.log2(base))
        c1 = 0.5 * ((1.0 - beta) * p1 + (1.0 + beta) * p2)
        c2 = 0.5 * ((1.0 + beta) * p1 + (1.0 - beta) * p2)
        c1 = tl.minimum(tl.maximum(c1, lb), ub)
        c2 = tl.minimum(tl.maximum(c2, lb), ub)
        tl.store(c1_ptr + offs, c1, mask=m)
        tl.store(c2_ptr + offs, c2, mask=m)

    @triton.jit
    def offspring_kernel(
        parm_ptr, pool_ptr, r_ptr, u_ptr, pool_n_ptr, shift_hi_ptr,
        pc_ptr, pm_ptr, rate_ptr, dix_ptr, dim_ptr, lb_ptr, ub_ptr,
        out_ptr, isx_ptr,
        npairs, n, s_parm, s_u, s_out, s_dix, s_dim, s_lb, s_ub,
        t_parm, t_pool, t_r, t_u, t_pn, t_sh, t_pc, t_pm, t_rate,
        t_dix, t_dim, t_lb, t_ub,
        BLOCK_P: tl.constexpr, BLOCK_N: tl.constexpr, BUCKET: tl.constexpr,
    ):
        # a (BLOCK_P pairs, BLOCK_N genes) tile; per-pair values are
        # (BLOCK_P,) vectors broadcast along the genes. In a bucket the
        # tile is tenant program_id(2)'s: every pointer moves to its rows
        # (a single population compiles without the offsets)
        if BUCKET:
            t = tl.program_id(2).to(tl.int64)
            parm_ptr += t * t_parm
            pool_ptr += t * t_pool
            r_ptr += t * t_r
            u_ptr += t * t_u
            out_ptr += t * 2 * s_out
            isx_ptr += t * npairs
            dix_ptr += t * t_dix
            dim_ptr += t * t_dim
            lb_ptr += t * t_lb
            ub_ptr += t * t_ub
            pool_n_ptr += t * t_pn
            shift_hi_ptr += t * t_sh
            pc_ptr += t * t_pc
            pm_ptr += t * t_pm
            rate_ptr += t * t_rate
        pairs = tl.program_id(0) * BLOCK_P + tl.arange(0, BLOCK_P)
        cols = tl.program_id(1) * BLOCK_N + tl.arange(0, BLOCK_N)
        mp = pairs < npairs
        mc = cols < n
        pool_n = tl.load(pool_n_ptr).to(tl.int32)
        shift_hi = tl.load(shift_hi_ptr).to(tl.int32)
        # per pair slot: first parent, shift to the second, operator draw
        r0 = tl.load(r_ptr + pairs, mask=mp, other=0.0)
        r1 = tl.load(r_ptr + npairs + pairs, mask=mp, other=0.0)
        r2 = tl.load(r_ptr + 2 * npairs + pairs, mask=mp, other=1.0)
        i1 = (r0 * pool_n.to(tl.float32)).to(tl.int32)
        shift = 1 + (r1 * (shift_hi - 1).to(tl.float32)).to(tl.int32)
        i2 = (i1 + shift) % pool_n
        row1 = tl.load(pool_ptr + i1, mask=mp, other=0)
        row2 = tl.load(pool_ptr + i2, mask=mp, other=0)
        pc = tl.load(pc_ptr)
        pm = tl.load(pm_ptr)
        is_x = r2 < tl.math.div_rn(2.0 * pc, 2.0 * pc + pm)
        tl.store(isx_ptr + pairs, is_x.to(tl.int8), mask=mp & (tl.program_id(1) == 0))

        m = mp[:, None] & mc[None, :]
        mx = m & is_x[:, None]
        mm = m & (is_x == 0)[:, None]
        c = cols[None, :]
        p1 = tl.load(parm_ptr + row1[:, None] * s_parm + c, mask=m, other=0.0)
        p2 = tl.load(parm_ptr + row2[:, None] * s_parm + c, mask=m, other=0.0)
        lb = tl.load(lb_ptr + cols * s_lb, mask=mc, other=0.0)[None, :]
        ub = tl.load(ub_ptr + cols * s_ub, mask=mc, other=1.0)[None, :]
        g = pairs[:, None] * n + c  # gene offset within one (npairs, n) block
        # SBX pair, from the crossover uniform (read on crossover slots)
        ux = tl.load(u_ptr + g, mask=mx, other=0.5)
        pw = 1.0 / (tl.load(dix_ptr + cols * s_dix, mask=mc, other=1.0) + 1.0)[None, :]
        base = tl.where(ux <= 0.5, 2.0 * ux, 1.0 / (2.0 * (1.0 - ux)))
        beta = tl.exp2(pw * tl.log2(base))
        c1 = 0.5 * ((1.0 - beta) * p1 + (1.0 + beta) * p2)
        c2 = 0.5 * ((1.0 + beta) * p1 + (1.0 - beta) * p2)
        # both mutants, from the mutation uniforms (read on mutation slots)
        u1 = tl.load(u_ptr + s_u + g, mask=mm, other=0.5)
        u2 = tl.load(u_ptr + 2 * s_u + g, mask=mm, other=0.5)
        rate = tl.load(rate_ptr)
        pw = 1.0 / (tl.load(dim_ptr + cols * s_dim, mask=mc, other=1.0) + 1.0)[None, :]
        d1 = tl.where(
            u1 < rate,
            tl.exp2(pw * tl.log2(2.0 * u1)) - 1.0,
            1.0 - tl.exp2(pw * tl.log2(2.0 * (1.0 - u1))),
        )
        d2 = tl.where(
            u2 < rate,
            tl.exp2(pw * tl.log2(2.0 * u2)) - 1.0,
            1.0 - tl.exp2(pw * tl.log2(2.0 * (1.0 - u2))),
        )
        m1 = p1 + (ub - lb) * d1
        m2 = p2 + (ub - lb) * d2
        x = is_x[:, None]
        o1 = tl.minimum(tl.maximum(tl.where(x, c1, m1), lb), ub)
        o2 = tl.minimum(tl.maximum(tl.where(x, c2, m2), lb), ub)
        tl.store(out_ptr + g, o1, mask=m)
        tl.store(out_ptr + s_out + g, o2, mask=m)

    return (triton.cdiv, mutation_kernel, sbx_kernel, offspring_kernel)


def _check(name, t, shape=None, ndim=None):
    if not t.is_cuda or t.dtype != torch.float32:
        raise TypeError(f"{name}: the Triton kernel takes float32 CUDA tensors")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d, got {t.dim()}-d")


def launch_mutation(u, parents, di, xlb, xub, mutation_rate):
    """Polynomial mutation on CUDA; all operands float32 on one device:
    ``u``/``parents`` (B, n) contiguous, ``di``/``xlb``/``xub`` (n,) of any
    stride, ``mutation_rate`` a 0-d tensor. Returns the (B, n) children."""
    cdiv, mutation_kernel, _, _ = _build()
    _check("u", u, ndim=2)
    B, n = u.shape
    _check("parents", parents, shape=(B, n))
    _check("mutation_rate", mutation_rate, shape=())
    _check("di", di, shape=(n,))
    _check("xlb", xlb, shape=(n,))
    _check("xub", xub, shape=(n,))
    u, parents = u.contiguous(), parents.contiguous()
    out = torch.empty_like(parents)
    total = B * n
    if total:
        mutation_kernel[(cdiv(total, BLOCK),)](
            u, parents, di, xlb, xub, mutation_rate, out,
            total, n, di.stride(0), xlb.stride(0), xub.stride(0),
            BLOCK=BLOCK, num_warps=NUM_WARPS,
        )
        _count_launch("mutation")
    return out


def launch_sbx(u, parents1, parents2, di, xlb, xub):
    """SBX crossover on CUDA; operands as in `launch_mutation`. Returns
    the two (B, n) children."""
    cdiv, _, sbx_kernel, _ = _build()
    _check("u", u, ndim=2)
    B, n = u.shape
    _check("parents1", parents1, shape=(B, n))
    _check("parents2", parents2, shape=(B, n))
    _check("di", di, shape=(n,))
    _check("xlb", xlb, shape=(n,))
    _check("xub", xub, shape=(n,))
    u = u.contiguous()
    parents1, parents2 = parents1.contiguous(), parents2.contiguous()
    c1 = torch.empty_like(parents1)
    c2 = torch.empty_like(parents2)
    total = B * n
    if total:
        sbx_kernel[(cdiv(total, BLOCK),)](
            u, parents1, parents2, di, xlb, xub, c1, c2,
            total, n, di.stride(0), xlb.stride(0), xub.stride(0),
            BLOCK=BLOCK, num_warps=NUM_WARPS,
        )
        _count_launch("sbx")
    return c1, c2


def launch_offspring(
    parm, pool_idx, r, u, pool_n, shift_hi, crossover_prob, mutation_prob,
    mutation_rate, di_crossover, di_mutation, xlb, xub,
):
    """One NSGA-II offspring step on CUDA, as `variation._offspring_core`
    computes it, for one population or for a bucket of T tenants' at
    once. One population: ``parm`` (pop, n) float32 with unit column
    stride, ``pool_idx`` (poolsize,) int64, ``r`` (3, npairs) and ``u``
    (3, npairs, n) float32 uniforms, ``pool_n``/``shift_hi`` 0-d
    int32/int64 tensors (read on the device, so an adaptive pool size
    costs no host sync), the three rates 0-d float32 tensors, and the
    per-gene vectors (n,) float32 of any stride. A bucket: every operand
    gains a leading (T,) axis (``parm`` (T, pop, n), ``pool_idx`` (T,
    poolsize), ``r`` (T, 3, npairs), ``u`` (T, 3, npairs, n), the pool
    sizes and rates (T,), the per-gene vectors (T, n) of any strides),
    and the grid a third axis over the tenants: one launch for the
    bucket, whatever T. Returns the (2*npairs, n) offspring and the
    (npairs,) bool operator tags (True: the slot's pair came from SBX),
    each with the leading (T,) axis of a bucket."""
    cdiv, _, _, offspring_kernel = _build()
    from triton import next_power_of_2
    single = parm.dim() == 2
    args = [parm, pool_idx, r, u, pool_n, shift_hi, crossover_prob,
            mutation_prob, mutation_rate, di_crossover, di_mutation, xlb, xub]
    if single:
        # today's launch: a bucket of one tenant
        args = [a.unsqueeze(0) if isinstance(a, torch.Tensor) else a for a in args]
    (parm, pool_idx, r, u, pool_n, shift_hi, crossover_prob, mutation_prob,
     mutation_rate, di_crossover, di_mutation, xlb, xub) = args
    _check("parm", parm, ndim=3)
    T, _, n = parm.shape
    _check("r", r, ndim=3)
    npairs = r.shape[2]
    _check("r", r, shape=(T, 3, npairs))
    _check("u", u, shape=(T, 3, npairs, n))
    for name, t in (("crossover_prob", crossover_prob),
                    ("mutation_prob", mutation_prob),
                    ("mutation_rate", mutation_rate)):
        _check(name, t, shape=(T,))
    for name, t in (("di_crossover", di_crossover), ("di_mutation", di_mutation),
                    ("xlb", xlb), ("xub", xub)):
        _check(name, t, shape=(T, n))
    if (not pool_idx.is_cuda or pool_idx.dtype != torch.int64 or pool_idx.dim() != 2
            or pool_idx.shape[0] != T):
        raise TypeError("pool_idx: the Triton kernel takes a (T, poolsize) int64 CUDA tensor")
    for name, t in (("pool_n", pool_n), ("shift_hi", shift_hi)):
        if (not isinstance(t, torch.Tensor) or not t.is_cuda or tuple(t.shape) != (T,)
                or t.dtype not in (torch.int32, torch.int64)):
            raise TypeError(f"{name}: the Triton kernel takes a 0-d (or, for a "
                            f"bucket, (T,)) int CUDA tensor")
    if parm.stride(2) != 1:
        parm = parm.contiguous()
    if pool_idx.stride(1) != 1:
        pool_idx = pool_idx.contiguous()
    # each tenant's uniforms may be a view of its own draw: only the rows
    # within a tenant must be packed
    if r.stride(2) != 1 or r.stride(1) != npairs:
        r = r.contiguous()
    if u.stride(3) != 1 or u.stride(2) != n:
        u = u.contiguous()
    out = torch.empty((T, 2 * npairs, n), dtype=parm.dtype, device=parm.device)
    is_x = torch.empty((T, npairs), dtype=torch.int8, device=parm.device)
    if T * npairs * n:
        block_n = min(next_power_of_2(n), OFFSPRING_TILE)
        block_p = OFFSPRING_TILE // block_n
        offspring_kernel[(cdiv(npairs, block_p), cdiv(n, block_n), T)](
            parm, pool_idx, r, u, pool_n, shift_hi,
            crossover_prob, mutation_prob, mutation_rate,
            di_crossover, di_mutation, xlb, xub, out, is_x,
            npairs, n, parm.stride(1), u.stride(1), npairs * n,
            di_crossover.stride(1), di_mutation.stride(1), xlb.stride(1),
            xub.stride(1),
            parm.stride(0), pool_idx.stride(0), r.stride(0), u.stride(0),
            pool_n.stride(0), shift_hi.stride(0), crossover_prob.stride(0),
            mutation_prob.stride(0), mutation_rate.stride(0),
            di_crossover.stride(0), di_mutation.stride(0), xlb.stride(0),
            xub.stride(0), BLOCK_P=block_p, BLOCK_N=block_n, BUCKET=not single,
            num_warps=NUM_WARPS,
        )
        _count_launch("offspring")
    if single:
        out, is_x = out[0], is_x[0]
    return out, is_x.view(torch.bool)
