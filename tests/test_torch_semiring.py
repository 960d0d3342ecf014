"""The port's semirings against the JAX package's, bit for bit, on edge
values (±FLT_MAX pads, INT_MIN/INT_MAX pads, overflow to inf)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparseharness_tpu.ops.pallas_bsr import _carrier as jax_carrier
from sparseharness_tpu.semiring import get_semiring as jax_semiring
from sparseharness_tpu_torch.semiring import REGISTRY, get_semiring
from sparseharness_tpu_torch.semiring.core import _carrier

FLT_MAX = float(np.finfo(np.float32).max)
INT_MIN = int(np.iinfo(np.int32).min)
INT_MAX = int(np.iinfo(np.int32).max)

NAMES = sorted(REGISTRY)

# non-static α/β per semiring (passed as tensors, so no short-circuit)
_ALPHA_BETA = {
    "plus_times": (2.0, 0.5), "min_plus": (1.5, 0.25), "or_and": (True, True),
    "max_min": (0.75, 0.5), "max_times": (0.5, 2.0), "max_right": (3, 7),
    "min_right": (3, 7),
}


def _edge_values(sr):
    if sr.dtype == torch.bool:
        return np.asarray([True, False])
    if sr.dtype == torch.int32:
        return np.asarray([INT_MIN, INT_MAX, 0, 1, -5, 7], np.int32)
    return np.asarray([0.0, 0.5, 1.0, FLT_MAX, -FLT_MAX, 3.5, -2.0, 1e-30],
                      np.float32)


def _pairs(sr):
    v = _edge_values(sr)
    a, b = zip(*itertools.product(v, v))
    return np.asarray(a, v.dtype), np.asarray(b, v.dtype)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same(port: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(_bits(port.numpy()), _bits(np.asarray(ref)))


def test_registry_matches_jax():
    from sparseharness_tpu.semiring import REGISTRY as JAX_REGISTRY

    assert sorted(JAX_REGISTRY) == NAMES
    for name in NAMES:
        sr, jsr = get_semiring(name), jax_semiring(name)
        assert sr.np_dtype == np.dtype(jsr.dtype)
        assert sr.exact_convergence == jsr.exact_convergence
        assert _bits(sr.np_zero()) == _bits(jsr.np_zero())
        dt = sr.np_dtype
        assert _bits(np.asarray(sr.one, dt)) == _bits(np.asarray(jsr.one, dt))


@pytest.mark.parametrize("name", NAMES)
def test_add_mul_reduce_bit_exact(name):
    sr, jsr = get_semiring(name), jax_semiring(name)
    a, b = _pairs(sr)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _same(sr.add(ta, tb), jsr.add(jnp.asarray(a), jnp.asarray(b)))
    _same(sr.mul(ta, tb), jsr.mul(jnp.asarray(a), jnp.asarray(b)))
    m = a.reshape(len(_edge_values(sr)), -1)
    _same(sr.add_reduce(torch.from_numpy(m), dim=1),
          jsr.add_reduce(jnp.asarray(m), axis=1))


@pytest.mark.parametrize("name", NAMES)
def test_scale_and_fold_axby_bit_exact(name):
    sr, jsr = get_semiring(name), jax_semiring(name)
    dp, y = _pairs(sr)
    tdp, ty = torch.from_numpy(dp), torch.from_numpy(y)
    jdp, jy = jnp.asarray(dp), jnp.asarray(y)
    alpha, beta = _ALPHA_BETA[name]
    dt = sr.np_dtype
    # static constants short-circuit in both packages
    assert sr.scale(sr.one, tdp) is tdp
    assert sr.fold_axby(sr.one, tdp, sr.zero, ty) is tdp
    # non-static α/β: 0-d tensors on each side
    ta, tb = torch.tensor(np.asarray(alpha, dt)), torch.tensor(np.asarray(beta, dt))
    ja, jb = jnp.asarray(np.asarray(alpha, dt)), jnp.asarray(np.asarray(beta, dt))
    _same(sr.scale(ta, tdp), jsr.scale(ja, jdp))
    _same(sr.fold_axby(ta, tdp, tb, ty), jsr.fold_axby(ja, jdp, jb, jy))
    # python-scalar α that is not the identity takes the op, as in JAX
    _same(sr.fold_axby(alpha, tdp, beta, ty), jsr.fold_axby(alpha, jdp, beta, jy))


@pytest.mark.parametrize("name", NAMES)
def test_carrier_matches_jax(name):
    sr, jsr = get_semiring(name), jax_semiring(name)
    dtype, add, mul, reduce_, zero, as_int = _carrier(sr)
    jdtype, jadd, jmul, jreduce, jzero, jas_int = jax_carrier(jsr)
    assert as_int == jas_int
    assert np.dtype(str(dtype).replace("torch.", "")) == np.dtype(jdtype)
    assert _bits(np.asarray(zero, np.dtype(jdtype))) == _bits(jzero)
    a, b = _pairs(sr)
    npdt = np.dtype(jdtype)
    a, b = a.astype(npdt), b.astype(npdt)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _same(add(ta, tb), jadd(jnp.asarray(a), jnp.asarray(b)))
    _same(mul(ta, tb), jmul(jnp.asarray(a), jnp.asarray(b)))
    _same(reduce_(ta.reshape(2, -1), dim=1), jreduce(jnp.asarray(a).reshape(2, -1), axis=1))
