"""The port's bsr_band build and plain dp against the JAX package's
build and Pallas kernel (interpret mode on the CPU).

The build must reproduce the JAX strips, c0 and k_win exactly. The dp
comparisons feed both packages the same strips (through ops.interop), so a
difference is a dp fault, not a layout fault. Six semirings reduce with
min, max or or over a single-rounded ⊗ and must match bit for bit;
plus_times sums in another order and is held within
1e-5 · max(1, |dp|, Σ|a·x|) per row.

The CUDA kernel reads only each row's occupied span of the strips and takes
the pads' products from scans of the x window. ``_kernel_model`` is that
computation in torch; it is held against the plain version and the JAX
kernel here, on x that makes the pads matter (±inf, ±FLT_MAX, ±0 and, under
max_times, negative values), and the kernel against it on the card
(tests/test_torch_cuda.py).
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
from sparseharness_tpu_torch.harness import variant_bytes
from sparseharness_tpu_torch.ops import bsr_band as tbb
from sparseharness_tpu_torch.ops.interop import bsr_band_operand_from_numpy
from sparseharness_tpu_torch.semiring import PLUS_TIMES, REGISTRY, get_semiring
from sparseharness_tpu_torch.semiring.core import INT_MAX, INT_MIN, _carrier

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
                         stage_x=True, kc=op.k_win, spans=op.spans)
    assert tbb.LAUNCHES == before


# ------------------------------------------------------------ span kernel


def _random_band(m):
    """A random matrix that fits the band rule: 3,000 entries at most 150
    columns from their row, with values of both signs."""
    rng = np.random.default_rng(21)
    rows = rng.integers(0, 700, 3000)
    cols = np.clip(rows + rng.integers(-150, 151, 3000), 0, 699)
    key = np.unique(rows * 700 + cols)
    vals = rng.uniform(-1.0, 1.0, key.size).astype(np.float32)
    return m.coo_from_arrays(key // 700, key % 700, vals, (700, 700))


SPAN_MATRICES = {"band_k1": MATRICES["band_k1"], "band_edge": MATRICES["band_edge"],
                 "random_band": _random_band}
X_KINDS = tbb.X_KINDS


#: ⊕'s identity in the carrier, as csrc/semiring.cuh:Op<SR>::identity
IDENTITY = {"plus_times": 0.0, "min_plus": float("inf"), "max_min": float("-inf"),
            "max_times": float("-inf"), "or_and": INT_MIN, "max_right": INT_MIN,
            "min_right": INT_MAX}


def _kernel_model(op, x2d, sr, kc):
    """The span kernel's dp in torch: per row, ⊕ of ⊗(x, strip) over the
    lanes of its span chunks [lo, hi), in ⊕-partials of kc·bn lanes, then ⊕
    the pad products ⊗(x_l, 0̄) of the window lanes before lo (``pre[lo]``)
    and from hi on (``suf[hi]``), with 0̄ as the strips store it."""
    r_rows, bm, kbn = op.strips.shape
    k = op.k_win
    bn = kbn // k
    n_groups = r_rows * bm // bn
    spans = op.spans
    assert spans.strips is op.strips
    carrier = _carrier(sr)[0]
    base = (torch.arange(n_groups) + op.c0).clamp(0, max(x2d.shape[0] - k, 0))
    win = x2d[base[:, None] + torch.arange(k)].reshape(n_groups, 1, kbn)
    st = op.strips.reshape(n_groups, bn, kbn)
    st = st.float() if st.dtype == torch.bfloat16 else st
    lane = torch.arange(kbn)
    cw = spans.chunk_lanes
    lo = spans.table[:, 0].long().view(n_groups, bn, 1) * cw
    hi = spans.table[:, 1].long().view(n_groups, bn, 1) * cw
    inside = (lane >= lo) & (lane < hi)
    ident = torch.tensor(IDENTITY[sr.name], dtype=carrier)
    prod = torch.where(inside, tbb.ieee_mul(sr, win, st), ident)
    part = tbb.ieee_reduce(sr, prod.view(n_groups, bn, k // kc, kc * bn), -1)
    span_dp = tbb.ieee_reduce(sr, part, -1)
    pad = torch.tensor(spans.pad, dtype=carrier)
    pads = tbb.ieee_mul(sr, win, pad).expand(n_groups, bn, kbn)
    before = tbb.ieee_reduce(sr, torch.where(lane < lo, pads, ident), -1)
    after = tbb.ieee_reduce(sr, torch.where(lane >= hi, pads, ident), -1)
    return tbb.ieee_reduce(sr, torch.stack((span_dp, before, after)), 0).reshape(-1)


def _same_bits(got, ref, zero_sign_free):
    """NaN where NaN, else the same bits; with ``zero_sign_free`` two zeros
    of either sign also match: torch's amax and amin leave the sign of a ±0
    tie to their reduction order, which the plain version inherits."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if got.dtype != np.float32:
        np.testing.assert_array_equal(got, ref)
        return
    nan = np.isnan(got)
    np.testing.assert_array_equal(nan, np.isnan(ref))
    same = got.view(np.int32) == ref.view(np.int32)
    if zero_sign_free:
        same |= (got == 0) & (ref == 0)
    assert bool(same[~nan].all()), f"{int((~same & ~nan).sum())} rows differ"


def _assert_model_matches(name, model, ref, bound, zero_sign_free):
    """Bit for bit (NaN as NaN); plus_times within PT_DELTA of the scale on
    rows whose Σ|a·x| is finite, NaN where it is NaN (a pad meets ±inf:
    0·inf). Where Σ|a·x| overflows, the sum's value depends on its order
    and the row is not checked. Returns the rows held to the tolerance (0
    for the other semirings)."""
    if name != "plus_times":
        _same_bits(model, ref, zero_sign_free)
        return 0
    model, ref, bound = (np.asarray(t, np.float64) for t in (model, ref, bound))
    np.testing.assert_array_equal(np.isnan(model[np.isnan(bound)]), True)
    np.testing.assert_array_equal(np.isnan(ref[np.isnan(bound)]), True)
    fin = np.isfinite(bound)
    scale = np.maximum(np.maximum(1.0, np.abs(ref[fin])), bound[fin])
    assert np.all(np.abs(model[fin] - ref[fin]) <= PT_DELTA * scale)
    return int(fin.sum())


def _abs_bound(op, x2d, kc):
    return tbb.band_dp_plain(op.strips.abs(), x2d.abs(), PLUS_TIMES, c0=op.c0,
                             k_win=op.k_win, kc=kc)


@pytest.mark.parametrize("kind", X_KINDS)
@pytest.mark.parametrize("matrix", sorted(SPAN_MATRICES))
@pytest.mark.parametrize("name,value_dtype", DP_CASES)
def test_kernel_model_matches_plain(name, value_dtype, matrix, kind):
    """The span computation equals band_dp_plain over every strip slot, with
    the whole window per partial (kc = K) and one slot per partial (kc = 1)."""
    sr = get_semiring(name)
    coo = SPAN_MATRICES[matrix](tf)
    op = tbb.build_bsr_band(coo, sr, value_dtype=value_dtype, device="cpu")
    x = tbb.band_x(sr, coo.shape[1], kind, np.random.default_rng(31))
    x2d = tbb.pad_x(op, torch.from_numpy(x), sr)
    for kc in (op.k_win, 1):
        plain = tbb.band_dp_plain(op.strips, x2d, sr, c0=op.c0, k_win=op.k_win, kc=kc)
        checked = _assert_model_matches(name, _kernel_model(op, x2d, sr, kc), plain,
                                        _abs_bound(op, x2d, kc), zero_sign_free=True)
        assert checked > 0 or name != "plus_times"


@pytest.mark.parametrize("kind", ["specials", "negative"])
@pytest.mark.parametrize("name,value_dtype", DP_CASES)
def test_kernel_model_matches_jax_kernel(name, value_dtype, kind):
    """The span computation against the JAX Pallas kernel on the same strips,
    zero signs included: XLA's min and max are IEEE's, as the kernel's."""
    sr, jsr = get_semiring(name), jax_semiring(name)
    coo = MATRICES["band_edge"](tf)
    jop = jbb.build_bsr_band(MATRICES["band_edge"](jf), jsr, value_dtype=value_dtype)
    op = bsr_band_operand_from_numpy(np.asarray(jop.strips), jop.c0, jop.k_win,
                                     jop.n_cols, device="cpu", sr=sr)
    x = tbb.band_x(sr, coo.shape[1], kind, np.random.default_rng(32))
    jax_dp = np.asarray(jbb.dp_bsr_band(jop, jnp.asarray(x), jsr, n_rows=coo.shape[0],
                                        windowed=False))
    x2d = tbb.pad_x(op, torch.from_numpy(x), sr)
    model = _kernel_model(op, x2d, sr, op.k_win)
    model = (model > 0).numpy() if sr.dtype == torch.bool else model.numpy()
    checked = _assert_model_matches(name, model, jax_dp, _abs_bound(op, x2d, op.k_win),
                                    zero_sign_free=False)
    assert checked > 0 or name != "plus_times"


@pytest.mark.parametrize("name,value_dtype", DP_CASES)
def test_span_table_of_jax_strips(name, value_dtype):
    """The table of a port-built operand equals the one made from the JAX
    package's strips carried across by interop; spans cover every stored
    value and start and end on one."""
    sr, jsr = get_semiring(name), jax_semiring(name)
    for make in MATRICES.values():
        op = tbb.build_bsr_band(make(tf), sr, value_dtype=value_dtype, device="cpu")
        jop = jbb.build_bsr_band(make(jf), jsr, value_dtype=value_dtype)
        iop = bsr_band_operand_from_numpy(np.asarray(jop.strips), jop.c0, jop.k_win,
                                          jop.n_cols, device="cpu", sr=sr)
        assert torch.equal(op.spans.table, iop.spans.table)
        assert (op.spans.lanes, op.spans.pad_bits) == (iop.spans.lanes, iop.spans.pad_bits)
        assert op.spans.table.dtype == torch.int16
        rows = op.strips.shape[0] * op.strips.shape[1]
        bits = op.strips.reshape(rows, -1).view({4: torch.int32, 2: torch.int16}[
            op.strips.element_size()])
        held = bits != torch.tensor(op.spans.pad, dtype=op.strips.dtype).view(bits.dtype)
        lane = torch.arange(bits.shape[1]) // op.spans.chunk_lanes
        lo, hi = op.spans.table[:, :1].long(), op.spans.table[:, 1:].long()
        assert not bool((held & ((lane < lo) | (lane >= hi))).any())
        ends = held.any(1)
        assert bool((lo[~ends] == hi[~ends]).all())
        first = held.int().argmax(1)[ends] // op.spans.chunk_lanes
        assert torch.equal(first, lo[ends, 0])


def test_bf16_min_plus_pad_is_inf():
    """bf16(FLT_MAX) rounds to +inf: that is the stored pad, and what the
    table and the pad term take."""
    op = tbb.build_bsr_band(MATRICES["band_k1"](tf), get_semiring("min_plus"),
                            value_dtype="bfloat16", device="cpu")
    assert op.spans.pad == float("inf") and op.spans.pad_bits == 0x7F800000
    op = tbb.build_bsr_band(MATRICES["band_k1"](tf), get_semiring("max_min"),
                            value_dtype="bfloat16", device="cpu")
    assert op.spans.pad == float("-inf")


@pytest.mark.parametrize("name", ["plus_times", "min_plus", "max_times", "max_right"])
def test_empty_rows_and_stored_zero_at_span_edge(name):
    """Row 5 is empty and padded rows have no span (lo = hi = 0); row 11's
    first stored value (column 7, chunk 1) equals 0̄, so its span starts at
    its next value's chunk (column 8, chunk 2): the product is the pad's,
    and the dp is the plain version's all the same."""
    sr = get_semiring(name)
    rng = np.random.default_rng(41)
    n = 300
    rows = np.repeat(np.arange(n), 9)
    cols = np.clip(rows + np.tile(np.arange(-4, 5), n), 0, n - 1)
    key = np.unique(rows * n + cols)
    rows, cols = key // n, key % n
    keep = rows != 5
    rows, cols = rows[keep], cols[keep]
    vals = rng.uniform(0.1, 1.0, rows.size).astype(np.float32)
    edge = np.flatnonzero(rows == 11)[0]
    vals[edge] = np.float32(sr.zero)  # INT_MIN is exact in float32
    coo = tf.coo_from_arrays(rows, cols, vals, (n, n))
    op = tbb.build_bsr_band(coo, sr, device="cpu")
    table, cw = op.spans.table, op.spans.chunk_lanes
    assert op.c0 <= 0 and op.strips.shape[0] * op.strips.shape[1] > n  # window at x[0]
    assert table[5].tolist() == [0, 0]
    assert bool((table[n:] == 0).all())  # padded rows
    assert (cols[edge], cw) == (7, 4)
    assert table[11].tolist() == [2, 15 // cw + 1]
    for kind in X_KINDS:
        x = tbb.band_x(sr, n, kind, np.random.default_rng(42))
        x2d = tbb.pad_x(op, torch.from_numpy(x), sr)
        plain = tbb.band_dp_plain(op.strips, x2d, sr, c0=op.c0, k_win=op.k_win, kc=op.k_win)
        _assert_model_matches(name, _kernel_model(op, x2d, sr, op.k_win), plain,
                              _abs_bound(op, x2d, op.k_win), zero_sign_free=True)


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_variant_bytes_is_the_hand_sum(value_dtype):
    """variant_bytes: each row's values from its first to its last stored
    one, x once and the output once. band_traffic: the span chunks, the
    4-byte table rows, the padded x and the padded output."""
    for make in SPAN_MATRICES.values():
        coo = make(tf)
        op = tbb.build_bsr_band(coo, PLUS_TIMES, value_dtype=value_dtype, device="cpu")
        item = op.strips.element_size()
        _, bm, kbn = op.strips.shape
        rows = op.strips.reshape(-1, kbn)
        lanes = chunks = 0
        for row in rows:
            held = torch.nonzero(row.view({4: torch.int32, 2: torch.int16}[item]) != 0)
            if held.numel():
                first, last = int(held[0]), int(held[-1])
                lanes += last - first + 1
                chunks += last // (16 // item) - first // (16 // item) + 1
        x_bytes, out_bytes = coo.shape[1] * 4, coo.shape[0] * 4
        assert variant_bytes("bsr_band", op, x_bytes, out_bytes) == (
            lanes * item + x_bytes + out_bytes)
        traffic = tbb.band_traffic(op)
        bn = kbn // op.k_win
        c_pad = max(-(-coo.shape[1] // bn) * bn, kbn)
        assert traffic == {"chunk_bytes": chunks * 16, "table_bytes": rows.shape[0] * 4,
                           "x_bytes": c_pad * 4, "out_bytes": rows.shape[0] * 4,
                           "bytes": chunks * 16 + rows.shape[0] * 8 + c_pad * 4}


def test_kernel_wrapper_refuses_stale_spans():
    """A span table made for other strips, or none, is refused before any
    launch: the kernel never reads a table that is not its strips'."""
    sr = get_semiring("min_plus")
    op = tbb.build_bsr_band(MATRICES["band_k1"](tf), sr, device="cpu")
    other = tbb.with_spans(op, sr)
    x2d = tbb.pad_x(op, torch.zeros(op.n_cols), sr)
    before = dict(tbb.LAUNCHES)
    for spans, says in ((None, "no span table"), (tbb.band_spans(op.strips.clone(), sr),
                                                    "other strips")):
        with pytest.raises(ValueError, match=says):
            tbb.band_dp_cuda(op.strips, x2d, sr, c0=op.c0, k_win=op.k_win,
                             stage_x=True, kc=op.k_win, spans=spans)
    assert other.spans.strips is op.strips
    assert tbb.LAUNCHES == before
