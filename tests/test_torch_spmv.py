"""The port's spmv (variant dp, then the α/β fold) against the JAX
package's spmv on the same seeded inputs, for every ported variant; plus
the fold's saturation clamp and the auto chain."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparseharness_tpu.formats as jf
from sparseharness_tpu.ops import build_operand as jax_build, spmv as jax_spmv
from sparseharness_tpu.ops.jnp_ops import fold_dp as jax_fold_dp
from sparseharness_tpu.semiring import get_semiring as jax_semiring
import sparseharness_tpu_torch.formats as tf
from sparseharness_tpu_torch.gold import spmv_abs_bound
from sparseharness_tpu_torch.ops import (
    AUTO_CHAIN, build_operand, build_operand_auto, fold_dp, get_variant, spmv,
)
from sparseharness_tpu_torch.ops.interop import ell_operand_from_numpy
from sparseharness_tpu_torch.semiring import REGISTRY, get_semiring

NAMES = sorted(REGISTRY)

# non-static α/β per semiring, passed as 0-d tensors (no short-circuit)
_ALPHA_BETA = {
    "plus_times": (2.0, 0.5), "min_plus": (1.5, 0.25), "or_and": (True, True),
    "max_min": (0.75, 0.5), "max_times": (0.5, 2.0), "max_right": (3, 7),
    "min_right": (3, 7),
}


def _inputs(sr, make):
    coo_t, coo_j = make(tf), make(jf)
    if sr.dtype == torch.bool:
        coo_t = coo_t.with_values(coo_t.vals != 0)
        coo_j = coo_j.with_values(coo_j.vals != 0)
    rng = np.random.default_rng(21)
    n, c = coo_t.shape
    if sr.dtype == torch.bool:
        x, y = rng.random(c) < 0.3, rng.random(n) < 0.3
    elif sr.dtype == torch.int32:
        x, y = (rng.integers(0, 50, k).astype(np.int32) for k in (c, n))
    else:
        x, y = (rng.uniform(0.1, 1.0, k).astype(np.float32) for k in (c, n))
    return coo_t, coo_j, x, y


def _assert_match(sr, port, ref, coo, x):
    port, ref = port.numpy(), np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype
    if sr.name == "plus_times":
        # another summation order: within 1e-5 · max(1, |ref|, Σ|a·x|),
        # scaled by the α/β magnitudes used (≤ 2)
        scale = 2.0 * np.maximum(np.maximum(1.0, np.abs(ref)), spmv_abs_bound(coo, x))
        assert np.all(np.abs(port - ref.astype(np.float64)) <= 1e-5 * scale)
    else:
        np.testing.assert_array_equal(port, ref)


# bsr_fused runs its Pallas kernel in interpret mode on the JAX side, which
# takes seconds a call; it has its own cases below
VARIANTS = ["ell", "bsr_band", "bsr_ell", "bsr_pallas", "coo_seg", "dense", "dia"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", NAMES)
def test_spmv_matches_jax(name, variant):
    sr, jsr = get_semiring(name), jax_semiring(name)
    coo_t, coo_j, x, y = _inputs(sr, lambda m: m.banded_coo(700, 20, seed=5))
    op = build_operand(coo_t, sr, variant, device="cpu")
    jop = jax_build(coo_j, jsr, variant)
    n = coo_t.shape[0]
    tx, ty, jx, jy = torch.from_numpy(x), torch.from_numpy(y), jnp.asarray(x), jnp.asarray(y)
    a, b = _ALPHA_BETA[name]
    dt = sr.np_dtype
    cases = [
        ((None, None), (None, None)),                      # defaults
        ((sr.one, sr.zero), (jsr.one, jsr.zero)),          # static constants
        ((torch.tensor(np.asarray(a, dt)), torch.tensor(np.asarray(b, dt))),
         (jnp.asarray(np.asarray(a, dt)), jnp.asarray(np.asarray(b, dt)))),
    ]
    for (ta, tb), (ja, jb) in cases:
        port = spmv(op, tx, ty, sr=sr, variant=variant, n_rows=n, alpha=ta, beta=tb)
        ref = jax_spmv(jop, jx, jy, sr=jsr, variant=variant, n_rows=n, alpha=ja, beta=jb)
        _assert_match(sr, port, ref, coo_t, x)


@pytest.mark.parametrize("name", ["plus_times", "min_plus", "or_and", "max_right"])
def test_bsr_fused_spmv_matches_jax(name):
    """The α/β fold over bsr_fused, with non-static α and β."""
    sr, jsr = get_semiring(name), jax_semiring(name)
    coo_t, coo_j, x, y = _inputs(sr, lambda m: m.banded_coo(700, 20, seed=5))
    op = build_operand(coo_t, sr, "bsr_fused", device="cpu")
    jop = jax_build(coo_j, jsr, "bsr_fused")
    a, b = _ALPHA_BETA[name]
    dt = sr.np_dtype
    port = spmv(op, torch.from_numpy(x), torch.from_numpy(y), sr=sr, variant="bsr_fused",
                n_rows=coo_t.shape[0], alpha=torch.tensor(np.asarray(a, dt)),
                beta=torch.tensor(np.asarray(b, dt)))
    ref = jax_spmv(jop, jnp.asarray(x), jnp.asarray(y), sr=jsr, variant="bsr_fused",
                   n_rows=coo_t.shape[0], alpha=jnp.asarray(np.asarray(a, dt)),
                   beta=jnp.asarray(np.asarray(b, dt)))
    _assert_match(sr, port, ref, coo_t, x)


def test_ell_operand_from_jax_arrays_matches_port_build():
    sr, jsr = get_semiring("max_right"), jax_semiring("max_right")
    coo_t, coo_j, _, _ = _inputs(sr, lambda m: m.random_graph_coo(200, 3.0, seed=1))
    jop = jax_build(coo_j, jsr, "ell")
    carried = ell_operand_from_numpy(np.asarray(jop.cols), np.asarray(jop.vals), device="cpu")
    built = build_operand(coo_t, sr, "ell", device="cpu")
    assert torch.equal(carried.cols, built.cols) and torch.equal(carried.vals, built.vals)


def test_fold_dp_clamps_min_plus_overflow():
    """min_plus pads overflow FLT_MAX + FLT_MAX to +inf; the fold's ⊕ with
    the semiring zero clamps them back to FLT_MAX, as in JAX."""
    sr, jsr = get_semiring("min_plus"), jax_semiring("min_plus")
    dp = np.asarray([np.inf, 1.5, np.finfo(np.float32).max, 0.0], np.float32)
    port = fold_dp(torch.from_numpy(dp), None, sr, None, None)
    ref = jax_fold_dp(jnp.asarray(dp), None, jsr, None, None)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert np.isfinite(port.numpy()).all()


def test_auto_chain_picks_band_then_fused():
    """The port's chain is the JAX package's, sell2 included, with dia
    after bsr_band: a band and a random matrix resolve as in JAX, and a
    27-point stencil past bsr_band's window takes dia, where JAX takes
    bsr_fused."""
    from sparseharness_tpu.ops import build_operand_auto as jax_auto
    from sparseharness_tpu.ops.registry import AUTO_CHAIN as JAX_AUTO_CHAIN
    from sparseharness_tpu.semiring import get_semiring as jax_semiring
    from test_torch_dia import stencil27

    sr = get_semiring("plus_times")
    assert JAX_AUTO_CHAIN == ("bsr_band", "bsr_fused", "sell2", "bsr_ell", "ell")
    assert AUTO_CHAIN == JAX_AUTO_CHAIN[:1] + ("dia",) + JAX_AUTO_CHAIN[1:]
    name, _ = build_operand_auto(tf.banded_coo(600, 10, seed=1), sr, device="cpu")
    assert name == "bsr_band"
    name, _ = build_operand_auto(tf.random_coo(2048, 2048, 3000, seed=1), sr,
                                 device="cpu")
    assert name == "bsr_fused"
    stencil = stencil27(24, 24, 24)
    name, _ = build_operand_auto(stencil, sr, device="cpu")
    assert name == "dia"
    jcoo = jf.coo_from_arrays(stencil.rows, stencil.cols, stencil.vals, stencil.shape)
    assert jax_auto(jcoo, jax_semiring("plus_times"))[0] == "bsr_fused"
    assert get_variant("sell2").name == "sell2"  # registered


def test_spmv_gold_reference_quirk_matches_jax():
    """The model of the reference's quirky gold (transposed rows, values
    truncated to int, beta·y[val]) gives JAX's bits."""
    from sparseharness_tpu.gold import spmv_gold_reference_quirk as jax_quirk
    from sparseharness_tpu_torch.gold import spmv_gold_reference_quirk

    coo_t, coo_j = tf.random_coo(60, 50, 300, seed=2), jf.random_coo(60, 50, 300, seed=2)
    coo_t = coo_t.with_values(coo_t.vals * 9)
    coo_j = coo_j.with_values(coo_j.vals * 9)
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, 60).astype(np.float32)
    y = rng.uniform(-1, 1, 17).astype(np.float32)
    got = spmv_gold_reference_quirk(coo_t, x, y, 1.5, 0.25, 2.0)
    want = jax_quirk(coo_j, x, y, 1.5, 0.25, 2.0)
    assert got.dtype == np.float32 and got.shape == (50,)
    np.testing.assert_array_equal(got, want)
