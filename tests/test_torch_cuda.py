"""Kernel tests that need an NVIDIA GPU and nvcc (marker ``cuda``): the
bsr_band kernel's staged and streamed paths against the plain version on
the same CUDA tensors. They skip without a card; run them on one with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the shared conftest imports JAX, which a machine with
only the port need not have.)
"""

import numpy as np
import pytest
import torch

from sparseharness_tpu_torch.formats import banded_coo, random_coo
from sparseharness_tpu_torch.ops import LAUNCHES, bsr_band, spmv
from sparseharness_tpu_torch.semiring import REGISTRY, PLUS_TIMES, get_semiring

# (semiring, strip dtype): bf16 strips only for the float semirings
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


@pytest.mark.cuda
@pytest.mark.parametrize("name,value_dtype", CASES)
def test_kernel_paths_match_plain(name, value_dtype, cuda):
    sr = get_semiring(name)
    for coo in (banded_coo(1200, 130, seed=12), random_coo(96, 700, 400, seed=13)):
        op = bsr_band.build_bsr_band(coo, sr, value_dtype=value_dtype, device=cuda)
        x = _x(sr, coo.shape[1], seed=3).to(cuda)
        x2d = bsr_band.pad_x(op, x, sr)
        for stage_x, kc in ((True, op.k_win), (False, op.k_win), (False, 1)):
            got = bsr_band.band_dp_cuda(op.strips, x2d, sr, c0=op.c0, k_win=op.k_win,
                                        stage_x=stage_x, kc=kc)
            torch.cuda.synchronize()
            ref = bsr_band.band_dp_plain(op.strips, x2d, sr, c0=op.c0,
                                         k_win=op.k_win, kc=kc)
            if name == "plus_times":
                bound = bsr_band.band_dp_plain(op.strips.abs(), x2d.abs(), PLUS_TIMES,
                                               c0=op.c0, k_win=op.k_win, kc=kc)
                tol = 1e-5 * torch.clamp(torch.maximum(ref.abs(), bound), min=1.0)
                assert bool(((got - ref).abs() <= tol).all())
            else:
                assert torch.equal(got, ref)


@pytest.mark.cuda
def test_spmv_launches_kernel(cuda):
    coo = banded_coo(2000, 30, seed=1)
    op = bsr_band.build_bsr_band(coo, PLUS_TIMES, device=cuda)
    x = _x(PLUS_TIMES, coo.shape[1], seed=4).to(cuda)
    before = dict(LAUNCHES)
    y = spmv(op, x, sr=PLUS_TIMES, variant="bsr_band", n_rows=coo.shape[0])
    torch.cuda.synchronize()
    assert LAUNCHES["staged"] == before["staged"] + 1
    assert y.is_cuda and y.shape == (coo.shape[0],)
