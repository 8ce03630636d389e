"""The port's hypervolume stack and indicators against the JAX package.

The exact paths are numpy in both packages (the WFG recursion, the
local-upper-bound box decomposition, the host 2-D sweep) and must agree
to 1e-9. The torch versions of the jitted functions get the same
inputs and the same random draws: the Monte Carlo uniforms and the
FPRAS box and position uniforms are drawn from the JAX keys and handed
to the port, the QMC block gets the JAX shift bits. Their float32
results must be allclose (rtol 1e-6; counts exact). EHVI is float32
arithmetic on the same boxes (rtol 1e-5, atol 1e-7).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu import hv as jax_hv
from dmosopt_tpu import indicators as jax_ind
from dmosopt_tpu import sampling as jax_sampling
from dmosopt_tpu_torch import hv as port_hv
from dmosopt_tpu_torch import indicators as port_ind


def _front(n, d, seed, on_sphere=True):
    rng = np.random.default_rng(seed)
    v = np.abs(rng.standard_normal((n, d))) + 0.05
    if on_sphere:
        v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v


def _f32(a):
    return torch.as_tensor(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("d", [2, 3, 4])
def test_exact_hypervolume_matches_jax(d):
    P = np.vstack([_front(25, d, d), _front(10, d, d + 1, on_sphere=False) + 0.3])
    ref = np.full(d, 1.5)
    want = jax_hv.hypervolume_exact(P, ref)
    assert abs(port_hv.hypervolume_exact(P, ref) - want) <= 1e-9 * want
    assert abs(port_hv._hypervolume_wfg(P, ref) - want) <= 1e-9 * want
    lo, up = port_hv.dominated_boxes(P, ref)
    jlo, jup = jax_hv.dominated_boxes(P, ref)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(up, jup)
    box = port_hv.HyperVolumeBoxDecomposition(ref, device="cpu")
    assert abs(box.compute_hypervolume(P) - want) <= 1e-9 * want
    if d == 2:
        got64 = float(port_hv.hypervolume_2d(torch.as_tensor(P), torch.as_tensor(ref)))
        assert abs(got64 - want) <= 1e-9 * want
        got32 = float(port_hv.hypervolume_2d(_f32(P), _f32(ref)))
        want32 = float(jax_hv.hypervolume_2d(jnp.asarray(P, jnp.float32),
                                             jnp.asarray(ref, jnp.float32)))
        assert got32 == pytest.approx(want32, rel=1e-6)


def test_monte_carlo_with_the_jax_uniforms_matches_jax():
    P = _front(30, 4, 7)
    ref = np.full(4, 1.2)
    key, n = jax.random.PRNGKey(5), 10_000
    want = jax_hv.hypervolume_mc(P, ref, n_samples=n, key=key, return_ci=True)
    keys = jax.random.split(key, -(-n // 4096))
    u = np.stack([np.asarray(jax.random.uniform(k, (4096, 4), jnp.float32)) for k in keys])
    got = port_hv.hypervolume_mc(P, ref, n_samples=n, return_ci=True, device="cpu",
                                 uniforms=torch.as_tensor(u))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    est, ci = port_hv.hypervolume_mc(P, ref, n_samples=n, return_ci=True, device="cpu")
    exact = jax_hv.hypervolume_exact(P, ref)
    assert abs(est - exact) < 4 * ci / 1.96


def test_fpras_blocks_with_the_jax_draws_match_jax():
    d, block = 4, 512
    pts = _front(12, d, 3).astype(np.float32)
    ref = np.full(d, 1.2, np.float32)
    log_v = np.sum(np.log(ref - pts), axis=1)
    v = np.exp(log_v - log_v.max())
    cdf = np.cumsum(v / v.sum()).astype(np.float32)
    chunks = np.concatenate(
        [pts, np.full((port_hv._COVER_CHUNK - len(pts), d), np.inf, np.float32)]
    ).reshape(-1, port_hv._COVER_CHUNK, d)
    jargs = tuple(jnp.asarray(a) for a in (pts, chunks, ref, cdf))
    targs = tuple(_f32(a) for a in (pts, chunks, ref, cdf))
    key = jax.random.PRNGKey(2)

    want = jax_hv._fpras_block(key, *jargs, block=block)
    k_box, k_pos = jax.random.split(key)
    u_box = np.asarray(jax.random.uniform(k_box, (block,)))
    u_pos = np.asarray(jax.random.uniform(k_pos, (block, d)))
    got = port_hv._fpras_block(*targs, _f32(u_box), _f32(u_pos))
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want],
                               rtol=1e-6)

    sv = jax_sampling.sobol_direction_numbers(d + 1)
    want_q = jax_hv._fpras_block_qmc(key, *jargs, jnp.asarray(sv), block=block)
    bits = np.asarray(jax.random.bits(key, (d + 1,), jnp.uint32)).astype(np.int64)
    got_q = port_hv._fpras_block_qmc(*targs, sv, torch.as_tensor(bits), block)
    assert float(got_q) == pytest.approx(float(want_q), rel=1e-6)

    # hypervolume_fpras gives a front below a chunk one chunk of its own
    # size: the same cover counts as the padded chunk, and JAX's on the
    # same draws
    own = pts.reshape(1, len(pts), d)
    targs_own = (targs[0], _f32(own), targs[2], targs[3])
    got_own = port_hv._fpras_block(*targs_own, _f32(u_box), _f32(u_pos))
    for a, b in zip(got_own, got):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    want_own = jax_hv._fpras_block(key, jargs[0], jnp.asarray(own), *jargs[2:], block=block)
    np.testing.assert_allclose([float(g) for g in got_own],
                               [float(w) for w in want_own], rtol=1e-6)
    got_q_own = port_hv._fpras_block_qmc(*targs_own, sv, torch.as_tensor(bits), block)
    assert torch.equal(torch.as_tensor(got_q_own), torch.as_tensor(got_q))
    want_q_own = jax_hv._fpras_block_qmc(key, jargs[0], jnp.asarray(own), *jargs[2:],
                                         jnp.asarray(sv), block=block)
    assert float(got_q_own) == pytest.approx(float(want_q_own), rel=1e-6)


def test_fpras_and_the_facade_hold_the_exact_value():
    P = _front(40, 4, 9)
    ref = np.full(4, 1.2)
    exact = port_hv.hypervolume_exact(P, ref)
    for qmc in (True, False):
        est, (ci, n) = port_hv.hypervolume_fpras(
            P, ref, epsilon=0.05, qmc=qmc, return_info=True, device="cpu",
            batch=2048, max_samples=32_768,
        )
        assert abs(est - exact) < 3 * ci, (qmc, est, exact, ci)
    facade = port_hv.AdaptiveHyperVolume(ref, exact_size_threshold=10, epsilon=0.05,
                                         max_mc_samples=32_768, device="cpu")
    est, ci = facade.compute_hypervolume_with_confidence(P)
    assert facade.last_method == "fpras" and abs(est - exact) < 3 * ci
    small = port_hv.AdaptiveHyperVolume(ref)  # exact: no device needed
    assert small(P) == pytest.approx(exact, rel=1e-12) and small.last_method == "exact"
    # above 2048 points the prune runs on the device, in chunks
    crowd = np.vstack([P, P[np.arange(2100) % len(P)] * 1.01 + 0.01])
    est, (ci, _) = port_hv.hypervolume_fpras(
        crowd, ref, epsilon=0.05, return_info=True, device="cpu",
        batch=2048, max_samples=32_768,
    )
    assert abs(est - exact) < 3 * ci, (est, exact, ci)
    # the chunked dominance prune is the JAX package's
    Pm = np.random.default_rng(1).random((300, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        port_hv._dominated_mask_chunked(torch.as_tensor(Pm), chunk=64).numpy(),
        np.asarray(jax_hv._dominated_mask_chunked(jnp.asarray(Pm), chunk=64)),
    )


def test_ehvi_and_candidate_selection_match_jax():
    P = _front(15, 3, 4)
    ref = np.full(3, 1.3)
    rng = np.random.default_rng(6)
    means = rng.random((9, 3)) * 1.2
    var = rng.random((9, 3)) * 0.05
    lo, up = jax_hv.dominated_boxes(P, ref)
    want = np.asarray(jax_hv.ehvi_batch(
        *(jnp.asarray(a, jnp.float32) for a in (lo, up, means, var, ref))))
    got = port_hv.ehvi_batch(*(_f32(a) for a in (lo, up, means, var, ref))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    sel_w, sc_w = jax_hv.HyperVolumeBoxDecomposition(ref).select_candidates(
        P, means, var, n_select=3)
    sel_g, sc_g = port_hv.HyperVolumeBoxDecomposition(ref, device="cpu").select_candidates(
        P, means, var, n_select=3)
    np.testing.assert_array_equal(sel_g, sel_w)
    np.testing.assert_allclose(sc_g, sc_w, rtol=1e-5, atol=1e-7)


def test_the_four_indicators_match_jax():
    pf = _front(30, 3, 11)
    F = np.vstack([_front(12, 3, 12) * 1.05, _front(6, 3, 13) * 1.3])
    assert port_ind.IGD(pf).do(F) == pytest.approx(jax_ind.IGD(pf).do(F), rel=1e-12)
    assert port_ind.IGD(pf, zero_to_one=True).do(F) == pytest.approx(
        jax_ind.IGD(pf, zero_to_one=True).do(F), rel=1e-12)
    ref = np.full(3, 1.5)
    for nds in (False, True):
        assert port_ind.Hypervolume(ref_point=ref, nds=nds).do(F) == pytest.approx(
            jax_ind.Hypervolume(ref_point=ref, nds=nds).do(F), rel=1e-12)
    means = np.random.default_rng(2).random((8, 3))
    var = np.full((8, 3), 0.01)
    np.testing.assert_array_equal(
        port_ind.HypervolumeImprovement(ref_point=ref, nds=True, device="cpu").do(
            F, means, var, 3),
        jax_ind.HypervolumeImprovement(ref_point=ref, nds=True).do(F, means, var, 3),
    )
    rank = np.array([0] * 12 + [1] * 6)
    got = port_ind.PopulationDiversity().do(rank, F)
    want = jax_ind.PopulationDiversity().do(rank, F)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    w_port, w_jax = port_ind.SlidingWindow(3), jax_ind.SlidingWindow(3)
    for v in range(5):
        w_port.append(v)
        w_jax.append(v)
    assert list(w_port) == list(w_jax) == [2, 3, 4] and w_port.is_full()
