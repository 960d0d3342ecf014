"""The port's bsr_band build and plain dp against the JAX package's
build and Pallas kernel (interpret mode on the CPU).

The build must reproduce the JAX strips, c0 and k_win exactly. The dp
comparisons feed both packages the same strips (through ops.interop), so a
difference is a dp fault, not a layout fault. Six semirings reduce with
min, max or or over a single-rounded ⊗ and must match bit for bit;
plus_times sums in another order and is held within
1e-5 · max(1, |dp|, Σ|a·x|) per row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparseharness_tpu.formats as jf
import sparseharness_tpu.ops.pallas_bsr_band as jbb
from sparseharness_tpu.semiring import get_semiring as jax_semiring
import sparseharness_tpu_torch.formats as tf
from sparseharness_tpu_torch.gold import spmv_abs_bound
from sparseharness_tpu_torch.ops import bsr_band as tbb
from sparseharness_tpu_torch.ops.interop import bsr_band_operand_from_numpy
from sparseharness_tpu_torch.semiring import REGISTRY, get_semiring

NAMES = sorted(REGISTRY)
PT_DELTA = 1e-5

# makers taking a formats module; they cover k_win = 1, k_win > 1 with
# right-edge clamping, and a wide matrix whose window ≪ c_blocks
MATRICES = {
    "band_k1": lambda m: m.banded_coo(500, 4, seed=11),
    "band_edge": lambda m: m.banded_coo(1200, 130, seed=12),
    "wide": lambda m: m.random_coo(96, 700, 400, seed=13),
}
# (semiring, strip dtype) cases: bf16 strips only for float semirings
DP_CASES = [(n, vd) for n in NAMES for vd in ("float32", "bfloat16")
            if vd == "float32" or get_semiring(n).dtype == torch.float32]


def _np_strips(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _port_strips(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _x(sr, n, seed):
    rng = np.random.default_rng(seed)
    if sr.dtype == torch.bool:
        return rng.random(n) < 0.3
    if sr.dtype == torch.int32:
        return rng.integers(0, 50, n).astype(np.int32)
    return rng.uniform(0.1, 1.0, n).astype(np.float32)


def _assert_dp_match(name, port_dp, jax_dp, coo, x):
    """Bit-exact, or plus_times within the stated bound on the logical rows."""
    port_dp, jax_dp = port_dp.numpy(), np.asarray(jax_dp)
    assert port_dp.shape == jax_dp.shape and port_dp.dtype == jax_dp.dtype
    if name != "plus_times":
        np.testing.assert_array_equal(port_dp, jax_dp)
        return
    n = coo.shape[0]
    scale = np.maximum(np.maximum(1.0, np.abs(jax_dp[:n])), spmv_abs_bound(coo, x))
    assert np.all(np.abs(port_dp[:n] - jax_dp[:n].astype(np.float64)) <= PT_DELTA * scale)
    np.testing.assert_array_equal(port_dp[n:], jax_dp[n:])  # padded rows


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_build_matches_jax(name, value_dtype):
    sr, jsr = get_semiring(name), jax_semiring(name)
    for make in MATRICES.values():
        jop = jbb.build_bsr_band(make(jf), jsr, value_dtype=value_dtype)
        op = tbb.build_bsr_band(make(tf), sr, value_dtype=value_dtype, device="cpu")
        assert (op.c0, op.k_win, op.n_cols) == (jop.c0, jop.k_win, jop.n_cols)
        assert _port_strips(op.strips).dtype == _np_strips(jop.strips).dtype
        np.testing.assert_array_equal(_port_strips(op.strips), _np_strips(jop.strips))


def test_build_refuses_what_jax_refuses():
    sr, jsr = get_semiring("plus_times"), jax_semiring("plus_times")
    wide = (lambda m: m.random_coo(2048, 2048, 3000, seed=1))
    with pytest.raises(NotImplementedError):
        jbb.build_bsr_band(wide(jf), jsr)
    with pytest.raises(NotImplementedError):
        tbb.build_bsr_band(wide(tf), sr, device="cpu")


@pytest.mark.parametrize("windowed", [False, True], ids=["staged", "streamed"])
@pytest.mark.parametrize("name,value_dtype", DP_CASES)
def test_plain_dp_matches_jax_kernel(name, value_dtype, windowed):
    """dp_bsr_band_plain (and dp_bsr_band on CPU tensors, which takes it)
    against the JAX Pallas kernel on the same strips, for both paths."""
    sr, jsr = get_semiring(name), jax_semiring(name)
    coo = MATRICES["band_edge"](tf)
    jop = jbb.build_bsr_band(MATRICES["band_edge"](jf), jsr, value_dtype=value_dtype)
    op = bsr_band_operand_from_numpy(np.asarray(jop.strips), jop.c0, jop.k_win,
                                     jop.n_cols, device="cpu")
    x = _x(sr, coo.shape[1], seed=14)
    n = coo.shape[0]
    jax_dp = jbb.dp_bsr_band(jop, jnp.asarray(x), jsr, n_rows=n, windowed=windowed)
    plain = tbb.dp_bsr_band_plain(op, torch.from_numpy(x), sr, n_rows=n,
                                  windowed=windowed)
    _assert_dp_match(name, plain, jax_dp, coo, x)
    routed = tbb.dp_bsr_band(op, torch.from_numpy(x), sr, n_rows=n, windowed=windowed)
    assert torch.equal(routed, plain)


@pytest.mark.parametrize("name", ["plus_times", "min_plus", "or_and"])
def test_streamed_kchunk_matches_jax(name, monkeypatch):
    """A small per-group byte cap splits the window into kc-slot chunks in
    both packages (k_win = 5 → kc = 1, 5 chunks)."""
    monkeypatch.setattr(jbb, "_MAX_GROUP_BYTES", 64 * 1024)
    monkeypatch.setattr(tbb, "_MAX_GROUP_BYTES", 64 * 1024)
    sr, jsr = get_semiring(name), jax_semiring(name)
    coo = MATRICES["band_edge"](tf)
    jop = jbb.build_bsr_band(MATRICES["band_edge"](jf), jsr)
    op = bsr_band_operand_from_numpy(np.asarray(jop.strips), jop.c0, jop.k_win,
                                     jop.n_cols, device="cpu")
    assert tbb.chunk_slots(op, staged=False) == 1 < op.k_win
    x = _x(sr, coo.shape[1], seed=15)
    jax_dp = jbb.dp_bsr_band(jop, jnp.asarray(x), jsr, n_rows=coo.shape[0],
                             windowed=True)
    plain = tbb.dp_bsr_band_plain(op, torch.from_numpy(x), sr,
                                  n_rows=coo.shape[0], windowed=True)
    _assert_dp_match(name, plain, jax_dp, coo, x)


def test_path_rule_and_operand_override():
    """windowed=None stages x whenever its window fits in shared memory;
    the operand's windowed field, then the call's argument, override it."""
    sr = get_semiring("plus_times")
    op = tbb.build_bsr_band(MATRICES["band_edge"](tf), sr, device="cpu")
    x2d = tbb.pad_x(op, torch.zeros(op.n_cols), sr)
    assert x2d.shape == (max(-(-op.n_cols // 128), op.k_win), 128)
    assert tbb._staged(op, x2d, None)
    streamed = tbb.BsrBandOperand(op.strips, op.c0, op.k_win, op.n_cols, windowed=True)
    assert not tbb._staged(streamed, x2d, None)
    assert tbb._staged(streamed, x2d, False)
    assert tbb.chunk_slots(op, staged=True) == op.k_win


def test_kernel_wrapper_refuses_cpu_tensors():
    """band_dp_cuda launches or raises: it never runs the plain version."""
    sr = get_semiring("min_plus")
    op = tbb.build_bsr_band(MATRICES["band_k1"](tf), sr, device="cpu")
    x2d = tbb.pad_x(op, torch.zeros(op.n_cols), sr)
    before = dict(tbb.LAUNCHES)
    with pytest.raises(ValueError):
        tbb.band_dp_cuda(op.strips, x2d, sr, c0=op.c0, k_win=op.k_win,
                         stage_x=True, kc=op.k_win)
    assert tbb.LAUNCHES == before
