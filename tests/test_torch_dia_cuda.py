"""The diagonal kernel (``csrc/dia.cu``) against the plain version on the
same CUDA tensors, for the seven semirings and both value types: bit for
bit, plus_times within 1e-5 · max(1, |plain|, Σ|a·x|). Matrices: a 24³
27-point stencil, a band, and a hand-made operand of 1,000 rows (not a
multiple of the 256-row block) with an empty diagonal and offsets past
both ends. The kernel's fold against ``fold_dp`` over the plain dp. An
SpMV through the registry runs one kernel on the card, the dia launch. They
skip without a card; run them on one with

    python -m pytest tests/test_torch_dia_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from sparseharness_tpu_torch.formats import banded_coo
from sparseharness_tpu_torch.ops import LAUNCHES, Geometry, build_operand, dia, spmv
from sparseharness_tpu_torch.ops.interop import dia_operand_from_numpy
from sparseharness_tpu_torch.ops.torch_ops import fold_dp
from sparseharness_tpu_torch.semiring import REGISTRY, PLUS_TIMES, get_semiring
from test_torch_dia import stencil27

# (semiring, value dtype): bf16 values only for the float semirings
CASES = [(n, vd) for n in sorted(REGISTRY) for vd in ("float32", "bfloat16")
         if vd == "float32" or get_semiring(n).dtype == torch.float32]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _x(sr, n, seed):
    rng = np.random.default_rng(seed)
    if sr.dtype == torch.bool:
        x = rng.random(n) < 0.3
    elif sr.dtype == torch.int32:
        x = rng.integers(0, 50, n).astype(np.int32)
    else:
        x = rng.uniform(0.1, 1.0, n).astype(np.float32)
    return torch.from_numpy(x)


def _hand_made(sr, value_dtype, device):
    """1,000 rows; diagonals −1,003 and 1,005 lie wholly off the matrix,
    diagonal 2 holds only 0̄, and 999 reaches one row."""
    n, offsets = 1000, (-1003, -7, 0, 2, 999, 1005)
    rng = np.random.default_rng(5)
    if sr.dtype == torch.bool:
        vals = rng.random((len(offsets), n)) < 0.6
    elif sr.dtype == torch.int32:
        vals = rng.integers(-20, 20, (len(offsets), n)).astype(np.int32)
    else:
        vals = rng.uniform(0.1, 1.0, (len(offsets), n)).astype(np.float32)
    vals[3] = sr.np_zero()
    op = dia_operand_from_numpy(vals, offsets, device=device)
    if value_dtype == "bfloat16":
        op = dia.DiaOperand(op.vals.to(torch.bfloat16), op.offsets)
    return op, n


MATRICES = {
    "stencil": lambda: stencil27(24, 24, 24, seed=1),
    "band": lambda: banded_coo(3000, 5, seed=2),
}


def _assert_matches(sr, got, ref, op, x, n):
    assert got.dtype == ref.dtype == sr.dtype and got.shape == ref.shape == (n,)
    if sr.name != "plus_times":
        assert torch.equal(got, ref)
        return
    vals = op.vals.float().abs()
    absx = x.abs()
    wide = dia.DiaOperand(vals, op.offsets)
    bound = dia.dp_dia_plain(wide, absx, sr, n_rows=n)
    tol = 1e-5 * torch.clamp(torch.maximum(ref.abs(), bound), min=1.0)
    assert bool(((got - ref).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("matrix", sorted(MATRICES) + ["hand_made"])
@pytest.mark.parametrize("name, value_dtype", CASES)
def test_kernel_matches_plain(name, value_dtype, matrix, cuda):
    sr = get_semiring(name)
    if matrix == "hand_made":
        op, n = _hand_made(sr, value_dtype, cuda)
    else:
        coo = MATRICES[matrix]()
        if sr.dtype == torch.bool:
            coo = coo.with_values(coo.vals != 0)
        op = build_operand(coo, sr, "dia", Geometry(value_dtype=value_dtype), device=cuda)
        n = coo.shape[0]
    want = torch.bfloat16 if value_dtype == "bfloat16" else sr.dtype
    assert op.vals.dtype == want and op.vals.is_cuda
    x = _x(sr, n, seed=9).to(cuda)
    got = dia.dia_dp_cuda(op, x, sr, n_rows=n)
    again = dia.dp_dia(op, x, sr, n_rows=n)
    ref = dia.dp_dia_plain(op, x, sr, n_rows=n)
    torch.cuda.synchronize()
    _assert_matches(sr, got, ref, op, x, n)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("name, value_dtype", CASES)
def test_kernel_fold_matches_plain_fold(name, value_dtype, cuda):
    """The kernel's fold against fold_dp over the plain dp, on the operand
    whose diagonals fall off both ends (min_plus' +inf rows) and on the
    stencil through the registry's spmv."""
    sr = get_semiring(name)
    op, n = _hand_made(sr, value_dtype, cuda)
    coo = stencil27(24, 24, 24, seed=3)
    if sr.dtype == torch.bool:
        coo = coo.with_values(coo.vals != 0)
    sop = build_operand(coo, sr, "dia", Geometry(value_dtype=value_dtype), device=cuda)
    for o, rows, x in ((op, n, _x(sr, n, seed=6).to(cuda)),
                       (sop, coo.shape[0], _x(sr, coo.shape[0], seed=8).to(cuda))):
        ref = fold_dp(dia.dp_dia_plain(o, x, sr, n_rows=rows), None, sr, None, None)
        got = dia.dia_dp_cuda(o, x, sr, n_rows=rows, fold=True)
        via = spmv(o, x, sr=sr, variant="dia", n_rows=rows)
        torch.cuda.synchronize()
        _assert_matches(sr, got, ref, o, x, rows)
        assert torch.equal(got, via)


@pytest.mark.cuda
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_spmv_launches_dia_once(value_dtype, cuda):
    """One kernel on the card a call: the dia launch, with the fold in it."""
    from torch.profiler import ProfilerActivity, profile

    coo = stencil27(24, 24, 24, seed=4)
    op = build_operand(coo, PLUS_TIMES, "dia", Geometry(value_dtype=value_dtype), device=cuda)
    x = _x(PLUS_TIMES, coo.shape[1], seed=4).to(cuda)
    spmv(op, x, sr=PLUS_TIMES, variant="dia", n_rows=coo.shape[0])
    torch.cuda.synchronize()
    before = dict(LAUNCHES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = spmv(op, x, sr=PLUS_TIMES, variant="dia", n_rows=coo.shape[0])
        torch.cuda.synchronize()
    assert LAUNCHES["dia"] == before["dia"] + 1
    assert sum(LAUNCHES.values()) == sum(before.values()) + 1
    assert y.is_cuda and y.shape == (coo.shape[0],)
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "dia_dp_kernel" in kernels[0], kernels


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["min_plus", "or_and"])
def test_chained_calls_read_the_prior_output(name, cuda):
    """Each call's x is the call before's output, every launch back to back:
    a launch that read x before the one before it had written it would
    differ from the chain of plain steps."""
    sr = get_semiring(name)
    coo = stencil27(24, 24, 24, seed=5)
    if sr.dtype == torch.bool:
        coo = coo.with_values(coo.vals != 0)
    op = build_operand(coo, sr, "dia", device=cuda)
    n = coo.shape[0]
    x = torch.full((n,), sr.zero, dtype=sr.dtype, device=cuda)
    x[n // 2] = sr.one
    chain = [x]
    for _ in range(30):
        chain.append(spmv(op, chain[-1], sr=sr, variant="dia", n_rows=n))
    torch.cuda.synchronize()
    want = x
    for step, got in enumerate(chain[1:]):
        want = fold_dp(dia.dp_dia_plain(op, want, sr, n_rows=n), None, sr, None, None)
        assert torch.equal(got, want), f"step {step}"
