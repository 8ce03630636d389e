"""Triton kernels for polynomial mutation and SBX crossover on Hopper.

They replace the two Pallas TPU kernels of the JAX package,
``dmosopt_tpu/ops/variation.py:72`` (`_mutation_pallas`) and ``:90``
(`_sbx_pallas`), and compute what those compute: the variation math over
uniforms drawn outside the kernel.

What bounds them: each is one elementwise pass over (B, n) float32 blocks
with no reuse (a handful of flops per element against 12-16 bytes of
traffic), so on an H100 the floor is device-memory bandwidth at large
shapes and launch latency at the main path's (100, 30). The design does
the least traffic it can: one flat 1-D grid over the B*n elements, each
program a contiguous BLOCK of them (coalesced, vectorised loads); the
per-gene vectors (``di``, ``xlb``, ``xub``) are read at ``col = idx % n``
instead of being broadcast to (B, n) as Mosaic wanted on the TPU, so
they cost n words, not B*n. The adaptive mutation rate is read through a
pointer to a 0-d device tensor, neither a constexpr nor a host value, so
a changing rate never recompiles the kernel nor syncs the host. Powers
are ``exp2(pw * log2(x))``, which gives exactly 0 at x == 0 for pw > 0.

Triton is imported, and the kernels compiled, only inside `launch_*`:
the CPU build of the package imports this module without triton. The
compile cache goes to ``dmosopt_tpu_torch/_build/triton`` unless
``TRITON_CACHE_DIR`` says otherwise, so a checkout builds everything it
runs from its own sources.

`KERNEL_LAUNCHES` counts each kernel's launches: a `launch_*` adds one
right after it queues its kernel, and nowhere else.
"""

from __future__ import annotations

import os

import torch

BLOCK = 1024
NUM_WARPS = 4
_KERNELS = None
KERNEL_LAUNCHES = {"mutation": 0, "sbx": 0}


def _build():
    """Define (once per process) the jitted kernels; triton compiles each
    at its first launch."""
    global _KERNELS
    if _KERNELS is not None:
        return _KERNELS
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

    _KERNELS = (triton.cdiv, mutation_kernel, sbx_kernel)
    return _KERNELS


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
    cdiv, mutation_kernel, _ = _build()
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
        KERNEL_LAUNCHES["mutation"] += 1
    return out


def launch_sbx(u, parents1, parents2, di, xlb, xub):
    """SBX crossover on CUDA; operands as in `launch_mutation`. Returns
    the two (B, n) children."""
    cdiv, _, sbx_kernel = _build()
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
        KERNEL_LAUNCHES["sbx"] += 1
    return c1, c2
