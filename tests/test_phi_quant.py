"""Int16-quantized Φ storage (PhiQuant).

The default f32 Markov production path stores the materialized feature
matrix int16-quantized with one scale per feature row
(ops/markov_phi.py:PhiQuant): the per-iteration read of Φ halves and
the ONLY approximation anywhere is the storage rounding — the scales are
folded exactly into the score-GEMM weights and un-folded from the stats
GEMM, so these tests pin (a) the rounding bound, (b) iteration-level
agreement of the folded kernels with the wide-Φ kernels, and (c) the
verdict-level contract: TRAIN-level agreement (assignments, status,
parameters) between the quantized default and wide storage.  f64 runs
always stay wide (bit-exact parity trajectories) — also pinned here.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from multimodal_trajectory_modeling_tpu.models import em
from multimodal_trajectory_modeling_tpu.ops import markov as mops
from multimodal_trajectory_modeling_tpu.ops import markov_phi as pm

from test_em_engine import _make_mixture_data, _random_init_params


def _f32_suffix_data(seed=3, n=400, T=6, choices=(3, 5, 6)):
    z, x, labels, true = _make_mixture_data(seed=seed, n=n, T=T)
    rng = np.random.default_rng(seed + 100)
    lens = rng.choice(list(choices), size=n)
    tmask = np.arange(T)[:, None] < lens[None, :]
    z[~tmask] = np.nan
    x[~tmask] = np.nan
    return (
        jnp.asarray(z, jnp.float32),
        jnp.asarray(x, jnp.float32),
        jnp.asarray(lens, jnp.int32),
        rng,
    )


def _f32_params(rng, C, d, l):
    p = _random_init_params(rng, C, d, l)
    return em.MixtureParams(*(leaf.astype(jnp.float32) for leaf in p))


def test_quantize_roundtrip_bound():
    rng = np.random.default_rng(0)
    phi = rng.normal(size=(24, 512)) * rng.uniform(
        0.01, 100.0, size=(24, 1)
    )
    phi[7] = 0.0  # layout padding row: must reconstruct exactly
    phi = jnp.asarray(phi, jnp.float32)
    pq = pm.quantize_phi(phi)
    deq = pm.dequantize_phi(pq)
    err = np.abs(np.asarray(deq) - np.asarray(phi))
    bound = 0.51 * np.asarray(pq.scale)[:, None]
    assert (err <= bound).all()
    assert pq.q.dtype == jnp.int16
    np.testing.assert_array_equal(np.asarray(deq[7]), 0.0)


def test_resolve_phi_store_contract(monkeypatch):
    monkeypatch.delenv("MTM_MARKOV_PHI", raising=False)
    monkeypatch.delenv("MTM_MARKOV_PHI_BF16", raising=False)
    assert em._resolve_phi_store(jnp.float32) == "i16"
    assert em._resolve_phi_store(jnp.float64) is None
    monkeypatch.setenv("MTM_MARKOV_PHI_BF16", "1")
    assert em._resolve_phi_store(jnp.float32) == jnp.bfloat16
    monkeypatch.setenv("MTM_MARKOV_PHI", "wide")
    assert em._resolve_phi_store(jnp.float32) is None
    monkeypatch.setenv("MTM_MARKOV_PHI", "i16")
    assert em._resolve_phi_store(jnp.float64) == "i16"
    monkeypatch.setenv("MTM_MARKOV_PHI", "nonsense")
    with pytest.raises(ValueError):
        em._resolve_phi_store(jnp.float32)


def _wide_and_quant_phi(z, x, lens, T, d, l):
    u, phi_w, layout = em._markov_features(
        z, x, lens, T=T, d=d, l=l, phi_store=None
    )
    _, phi_q, layout_q = em._markov_features(
        z, x, lens, T=T, d=d, l=l, phi_store="i16"
    )
    assert layout == layout_q
    assert isinstance(phi_q, pm.PhiQuant)
    return phi_w, phi_q, layout


def test_from_features_quantized_iteration_close():
    """One EM iteration from PhiQuant ≈ the wide-Φ iteration: identical
    assignments/counts on separated data, stats to quantization noise."""
    z, x, lens, rng = _f32_suffix_data()
    T, n, d = z.shape
    l = x.shape[-1]
    C = 2
    params = _f32_params(rng, C, d, l)
    phi_w, phi_q, layout = _wide_and_quant_phi(z, x, lens, T, d, l)

    Wg = mops.markov_em_weights(
        params.m, params.S, params.A, params.G, params.H, params.L
    )
    Wg = Wg.at[:, -1].add(jnp.log(params.pi))
    prev = jnp.zeros((n,), jnp.int32)
    a_w, c_w, s_w, g_w, o_w = pm.markov_em_from_features(
        phi_w, lens, prev, Wg, T=T, d=d, l=l, layout=layout,
    )
    a_q, c_q, s_q, g_q, o_q = pm.markov_em_from_features(
        phi_q, lens, prev, Wg, T=T, d=d, l=l, layout=layout,
    )
    np.testing.assert_array_equal(np.asarray(a_w), np.asarray(a_q))
    np.testing.assert_array_equal(np.asarray(c_w), np.asarray(c_q))
    np.testing.assert_allclose(
        np.asarray(g_w), np.asarray(g_q), rtol=2e-3, atol=2e-3
    )
    np.testing.assert_allclose(
        float(o_w), float(o_q), rtol=1e-3, atol=1e-2
    )


def test_from_features_multi_quantized_iteration_close():
    z, x, lens, rng = _f32_suffix_data(seed=5, n=256)
    T, n, d = z.shape
    l = x.shape[-1]
    C, R = 2, 3
    phi_w, phi_q, layout = _wide_and_quant_phi(z, x, lens, T, d, l)

    Wgs = []
    for _ in range(R):
        p = _f32_params(rng, C, d, l)
        Wg = mops.markov_em_weights(p.m, p.S, p.A, p.G, p.H, p.L)
        Wgs.append(Wg.at[:, -1].add(jnp.log(p.pi)))
    Wg = jnp.stack(Wgs)
    prev = jnp.zeros((R, n), jnp.int32)
    outs_w = pm.markov_em_from_features_multi(
        phi_w, lens, prev, Wg, T=T, d=d, l=l, layout=layout,
    )
    outs_q = pm.markov_em_from_features_multi(
        phi_q, lens, prev, Wg, T=T, d=d, l=l, layout=layout,
    )
    np.testing.assert_array_equal(
        np.asarray(outs_w[0]), np.asarray(outs_q[0])
    )
    np.testing.assert_array_equal(
        np.asarray(outs_w[1]), np.asarray(outs_q[1])
    )
    np.testing.assert_allclose(
        np.asarray(outs_w[3]), np.asarray(outs_q[3]), rtol=2e-3, atol=2e-3
    )


def test_train_em_markov_i16_default_matches_wide(monkeypatch):
    """The VERDICT contract: the quantized DEFAULT trains to the same
    assignments/status/iteration count as wide f32 storage, parameters
    to quantization noise — at train level, not feature level."""
    z, x, lens, rng = _f32_suffix_data()
    C, d, l = 2, z.shape[2], x.shape[2]
    params0 = _f32_params(rng, C, d, l)
    assign0 = jnp.asarray(
        np.random.default_rng(2).integers(0, C, size=z.shape[1]),
        jnp.int32,
    )

    monkeypatch.setenv("MTM_MARKOV_PHI", "wide")
    p_w, a_w, it_w, st_w = em.train_em_markov(
        params0, assign0, z, x, lens, n_steps=50
    )
    monkeypatch.delenv("MTM_MARKOV_PHI", raising=False)
    assert em._resolve_phi_store(z.dtype) == "i16"  # the default
    p_q, a_q, it_q, st_q = em.train_em_markov(
        params0, assign0, z, x, lens, n_steps=50
    )
    assert int(st_w) == int(st_q)
    assert int(it_w) == int(it_q)
    np.testing.assert_array_equal(np.asarray(a_w), np.asarray(a_q))
    for fw, fq in zip(p_w, p_q):
        np.testing.assert_allclose(
            np.asarray(fw), np.asarray(fq), rtol=5e-3, atol=5e-3
        )


def test_train_em_markov_i16_longT_canonical(monkeypatch):
    """T past the packed gate routes the canonical grid materializer —
    quantization must compose with that layout too."""
    z, x, labels, true = _make_mixture_data(seed=5, n=160, T=20)
    rng = np.random.default_rng(7)
    lens = rng.choice([10, 16, 20], size=160)
    tmask = np.arange(20)[:, None] < lens[None, :]
    z[~tmask] = np.nan
    x[~tmask] = np.nan
    z = jnp.asarray(z, jnp.float32)
    x = jnp.asarray(x, jnp.float32)
    lens = jnp.asarray(lens, jnp.int32)
    C, d, l = 2, z.shape[2], x.shape[2]
    params0 = _f32_params(rng, C, d, l)
    assign0 = jnp.asarray(rng.integers(0, C, size=160), jnp.int32)

    monkeypatch.setenv("MTM_MARKOV_PHI", "wide")
    p_w, a_w, it_w, st_w = em.train_em_markov(
        params0, assign0, z, x, lens, n_steps=40
    )
    monkeypatch.setenv("MTM_MARKOV_PHI", "i16")
    p_q, a_q, it_q, st_q = em.train_em_markov(
        params0, assign0, z, x, lens, n_steps=40
    )
    assert int(st_w) == int(st_q)
    assert int(it_w) == int(it_q)
    np.testing.assert_array_equal(np.asarray(a_w), np.asarray(a_q))
    for fw, fq in zip(p_w, p_q):
        np.testing.assert_allclose(
            np.asarray(fw), np.asarray(fq), rtol=5e-3, atol=5e-3
        )


def test_train_em_markov_multi_i16(monkeypatch):
    """R-restart trainer under the quantized default ≡ wide at train
    level, per restart."""
    z, x, lens, rng = _f32_suffix_data(seed=11, n=240)
    C, d, l = 2, z.shape[2], x.shape[2]
    R = 3
    stack = [_f32_params(rng, C, d, l) for _ in range(R)]
    params0 = em.MixtureParams(
        *(jnp.stack([getattr(p, f) for p in stack]) for f in params_fields())
    )
    assign0 = jnp.asarray(
        rng.integers(0, C, size=(R, z.shape[1])), jnp.int32
    )
    monkeypatch.setenv("MTM_MARKOV_PHI", "wide")
    p_w, a_w, it_w, st_w = em.train_em_markov_multi(
        params0, assign0, z, x, lens, n_steps=40
    )
    monkeypatch.setenv("MTM_MARKOV_PHI", "i16")
    p_q, a_q, it_q, st_q = em.train_em_markov_multi(
        params0, assign0, z, x, lens, n_steps=40
    )
    np.testing.assert_array_equal(np.asarray(st_w), np.asarray(st_q))
    np.testing.assert_array_equal(np.asarray(it_w), np.asarray(it_q))
    np.testing.assert_array_equal(np.asarray(a_w), np.asarray(a_q))
    for fw, fq in zip(p_w, p_q):
        np.testing.assert_allclose(
            np.asarray(fw), np.asarray(fq), rtol=5e-3, atol=5e-3
        )


def params_fields():
    return em.MixtureParams._fields


def test_train_em_markov_f64_unaffected_by_default(monkeypatch):
    """f64 parity batches never quantize under the default: trajectories
    are bit-identical whether MTM_MARKOV_PHI is unset or 'wide'."""
    z, x, labels, true = _make_mixture_data(seed=3, n=200, T=6)
    rng = np.random.default_rng(2)
    lens = rng.choice([3, 5, 6], size=200)
    tmask = np.arange(6)[:, None] < lens[None, :]
    z[~tmask] = np.nan
    x[~tmask] = np.nan
    z, x = jnp.asarray(z), jnp.asarray(x)
    lens = jnp.asarray(lens, jnp.int32)
    params0 = _random_init_params(rng, 2, 2, 3)
    assign0 = jnp.asarray(rng.integers(0, 2, size=200), jnp.int32)

    monkeypatch.delenv("MTM_MARKOV_PHI", raising=False)
    p_a, a_a, it_a, st_a = em.train_em_markov(
        params0, assign0, z, x, lens, n_steps=50
    )
    monkeypatch.setenv("MTM_MARKOV_PHI", "wide")
    p_b, a_b, it_b, st_b = em.train_em_markov(
        params0, assign0, z, x, lens, n_steps=50
    )
    assert int(st_a) == int(st_b) and int(it_a) == int(it_b)
    np.testing.assert_array_equal(np.asarray(a_a), np.asarray(a_b))
    for fa, fb in zip(p_a, p_b):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))


def test_outofcore_i16_close_to_incore(monkeypatch):
    """OOC chunks quantize per chunk (per-chunk scales) — train-level
    outcome still matches the in-core quantized run on separated data."""
    z, x, lens, rng = _f32_suffix_data(seed=13, n=300)
    C, d, l = 2, z.shape[2], x.shape[2]
    params0 = _f32_params(rng, C, d, l)
    assign0 = np.random.default_rng(4).integers(0, C, size=300)

    monkeypatch.setenv("MTM_MARKOV_PHI", "i16")
    p_i, a_i, it_i, st_i = em.train_em_markov(
        params0, jnp.asarray(assign0, jnp.int32), z, x, lens, n_steps=50
    )
    p_o, a_o, it_o, st_o = em.train_em_markov_outofcore(
        params0,
        assign0,
        np.asarray(z),
        np.asarray(x),
        np.asarray(lens),
        n_steps=50,
        chunk_cols=128,
    )
    assert int(st_i) == int(st_o)
    np.testing.assert_array_equal(np.asarray(a_i), np.asarray(a_o))
    for fi, fo in zip(p_i, p_o):
        np.testing.assert_allclose(
            np.asarray(fi), np.asarray(fo), rtol=5e-3, atol=5e-3
        )
