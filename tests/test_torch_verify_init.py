"""The port's operand-initialization check (ops/verify.py) against
tests/test_verify_init.py: every slot of every operand tensor is a real
entry, a ⊕-folded entry or the semiring's padding, and index leaves are in
bounds. Beyond the JAX test: every tensor field of every registered
variant's operand has a contract, and the check refuses a stray 0.0 or 1.0
slot in a float operand, which the JAX package's check lets pass."""

import dataclasses
import fnmatch

import numpy as np
import pytest
import torch

import sparseharness_tpu.formats as jf
from sparseharness_tpu.ops import build_operand as jax_build
from sparseharness_tpu.ops import verify_operand_initialized as jax_verify
from sparseharness_tpu.ops.jnp_ops import EllOperand as JaxEllOperand
from sparseharness_tpu.semiring import get_semiring as jax_semiring
import sparseharness_tpu_torch.formats as tf
from sparseharness_tpu_torch.ops import (
    VARIANTS, EllOperand, Geometry, OperandInitError, build_operand, build_operand_auto,
    verify, verify_operand_initialized,
)
from sparseharness_tpu_torch.semiring import MAX_RIGHT, MIN_PLUS, OR_AND, PLUS_TIMES

CHECK_SEMIRINGS = [PLUS_TIMES, MIN_PLUS, OR_AND, MAX_RIGHT]


def _matrix(sr):
    coo = tf.random_coo(96, 96, 400, seed=11)
    if sr.dtype != torch.float32:
        # int and bool semirings: integral values, so the comparison is exact
        coo = coo.with_values(np.arange(1, coo.nnz + 1, dtype=np.float32))
    return coo


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("sr", CHECK_SEMIRINGS, ids=lambda s: s.name)
def test_builders_pass_init_check(variant, sr):
    coo = _matrix(sr)
    op = build_operand(coo, sr, variant, device="cpu")
    verify_operand_initialized(coo, sr, op, variant)


@pytest.mark.parametrize("variant", ["bsr_band", "bsr_fused", "sell2"])
def test_bf16_operands_pass_init_check(variant):
    coo = tf.banded_coo(600, 9, seed=4)
    for sr in (PLUS_TIMES, MIN_PLUS):
        op = build_operand(coo, sr, variant, Geometry(8, 128, "bfloat16"), device="cpu")
        verify_operand_initialized(coo, sr, op, variant)


def test_init_check_graph_matrix_sell2():
    # power-law structure exercises sell2's packer and virtual chunks
    coo = tf.random_graph_coo(300, 4.0, seed=3)
    op = build_operand(coo, MIN_PLUS, "sell2", device="cpu")
    verify_operand_initialized(coo, MIN_PLUS, op, "sell2")


def test_seeded_garbage_value_is_caught():
    # an empty-allocated builder: one padding slot holds heap garbage
    coo = tf.random_coo(40, 40, 120, seed=5)
    op = build_operand(coo, PLUS_TIMES, "ell", device="cpu")
    vals = op.vals.clone()
    pads = torch.nonzero(vals == 0.0)
    assert len(pads), "expected padded slots"
    vals[tuple(pads[0])] = 1.2345678e19  # garbage no entry can equal
    with pytest.raises(OperandInitError, match="vals"):
        verify_operand_initialized(coo, PLUS_TIMES, EllOperand(op.cols, vals), "ell")


def test_seeded_out_of_bounds_index_is_caught():
    coo = tf.random_coo(40, 40, 120, seed=6)
    op = build_operand(coo, PLUS_TIMES, "ell", device="cpu")
    cols = op.cols.clone()
    cols.view(-1)[3] = 10**7  # garbage index far past any padded width
    with pytest.raises(OperandInitError, match="cols"):
        verify_operand_initialized(coo, PLUS_TIMES, EllOperand(cols, op.vals), "ell")


def test_seeded_blocked_tile_garbage_is_caught():
    coo = tf.random_coo(64, 64, 200, seed=7)
    op = build_operand(coo, PLUS_TIMES, "bsr_ell", device="cpu")
    tiles = op.tiles.clone()
    pads = torch.nonzero(tiles == 0.0)
    assert len(pads), "expected padded tile slots"
    tiles[tuple(pads[0])] = -7.7e11
    with pytest.raises(OperandInitError, match="tiles"):
        verify_operand_initialized(coo, PLUS_TIMES, type(op)(tiles, op.tile_cols), "bsr_ell")


def test_env_var_wires_check_into_build(monkeypatch):
    # SPARSEHARNESS_TPU_CHECK_INIT=1 makes build_operand and
    # build_operand_auto verify; a poisoned builder then raises
    coo = tf.random_coo(32, 32, 90, seed=8)
    for name in ("ell", "bsr_band"):
        good = VARIANTS[name]

        def bad_build(c, sr, geom, device, good=good):
            op = good.build(c, sr, geom, device)
            if isinstance(op, EllOperand):
                vals = op.vals.clone()
                vals.view(-1)[-1] = 3.14159e33
                return EllOperand(op.cols, vals)
            strips = op.strips.clone()
            strips.view(-1)[-1] = 3.14159e33
            return dataclasses.replace(op, strips=strips, spans=None)

        monkeypatch.setitem(VARIANTS, name, dataclasses.replace(good, build=bad_build))
    monkeypatch.setenv("SPARSEHARNESS_TPU_CHECK_INIT", "0")
    build_operand(coo, PLUS_TIMES, "ell", device="cpu")  # unchecked: passes silently
    assert build_operand_auto(coo, PLUS_TIMES, device="cpu")[0] == "bsr_band"
    monkeypatch.setenv("SPARSEHARNESS_TPU_CHECK_INIT", "1")
    with pytest.raises(OperandInitError):
        build_operand(coo, PLUS_TIMES, "ell", device="cpu")
    with pytest.raises(OperandInitError, match="bsr_band"):
        build_operand_auto(coo, PLUS_TIMES, device="cpu")


def _light_chunks():
    """4 chunks of 16,384 columns, each with 2 occupied blocks of 16 entries:
    light enough that sell2 regroups their blocks into virtual chunks."""
    rng = np.random.default_rng(9)
    ch = np.repeat(np.arange(4), 32)
    blk = np.repeat(np.tile(np.arange(2), 4), 16)
    cols = ch * 16384 + blk * 128 + rng.integers(0, 128, ch.size)
    return tf.coo_from_arrays(rng.integers(0, 2048, ch.size), cols,
                              rng.uniform(0.1, 1.0, ch.size).astype(np.float32),
                              (2048, 4 * 16384))


def _scattered(coo):
    """coo with its columns relabelled at random, so that the most read
    columns lie scattered over x."""
    perm = np.random.default_rng(10).permutation(coo.shape[1])
    return tf.coo_from_arrays(coo.rows, perm[coo.cols], coo.vals, coo.shape)


# every registered variant on matrices that bring out its optional fields:
# split rows and virtual chunks (sell2), levels (sell), a band's span table,
# x in degree order (sell2, under an L1 of 256 columns)
COVERAGE = {
    "random": lambda: tf.random_coo(300, 300, 1500, seed=2),
    "band": lambda: tf.banded_coo(1200, 20, seed=1),
    "zipf": lambda: tf.power_law_coo(3000, 20000, seed=4),
    "zipf_scattered": lambda: _scattered(tf.power_law_coo(3000, 40000, alpha=1.2, seed=4)),
    "virtual": lambda: _light_chunks(),
    "hub": lambda: tf.coo_from_arrays(
        np.r_[np.full(600, 7), np.arange(600)], np.r_[np.arange(600), np.arange(600)],
        np.linspace(0.1, 1.0, 1200).astype(np.float32), (600, 600)),
}


def test_contract_table_names_every_leaf(monkeypatch):
    """Every tensor leaf of every registered variant's operand has a
    contract, and every contract names a leaf that some operand has. Under
    an L1 of 256 columns the scattered power law's sell2 plan gathers x in
    degree order, so it holds a col_perm."""
    from sparseharness_tpu_torch.ops import sell2

    monkeypatch.setattr(sell2, "L1_COLS", 256)
    used = set()
    built = set()
    for variant in sorted(VARIANTS):
        for matrix, make in sorted(COVERAGE.items()):
            if variant == "dense" and matrix == "virtual":
                continue  # 512 MB dense: nothing the other matrices lack
            coo = make()
            try:
                op = build_operand(coo, MIN_PLUS, variant, device="cpu")
            except NotImplementedError:
                continue
            built.add(variant)
            op_type = type(op).__name__
            for path, _ in verify.tensor_leaves(op):
                contract = verify.contract_for(op_type, path)
                assert contract is not None, (variant, path)
                assert contract.kind in ("value", "index") or contract.reason, (variant, path)
                used.add((op_type, next(p for p in verify.CONTRACTS[op_type]
                                        if fnmatch.fnmatchcase(path, p))))
            verify_operand_initialized(coo, MIN_PLUS, op, variant)
    assert built == set(VARIANTS)
    declared = {(t, p) for t, table in verify.CONTRACTS.items() for p in table}
    assert declared == used, declared - used


def test_leaf_without_a_contract_is_refused():
    @dataclasses.dataclass(frozen=True)
    class EllOperand:  # the type's name, with one field more
        cols: torch.Tensor
        vals: torch.Tensor
        extra: torch.Tensor

    coo = tf.random_coo(40, 40, 120, seed=5)
    op = build_operand(coo, PLUS_TIMES, "ell", device="cpu")
    with pytest.raises(OperandInitError, match="no contract"):
        verify_operand_initialized(coo, PLUS_TIMES, EllOperand(op.cols, op.vals,
                                                               torch.zeros(3)), "ell")
    with pytest.raises(OperandInitError, match="no contracts"):
        verify_operand_initialized(coo, PLUS_TIMES, (op.cols, op.vals), "ell")


@pytest.mark.parametrize("name,garbage", [("min_plus", 0.0), ("plus_times", 1.0),
                                          ("min_plus", 1.0)])
def test_zero_and_one_slots_refused_where_jax_passes_them(name, garbage):
    """The JAX check admits 0.0, 1.0 and 1̄ for every semiring, so a padding
    slot that holds zero-bit heap garbage passes it even where 0̄ is FLT_MAX.
    The port admits {0, 1} only for the int {0, 1} carrier and 1̄ only as an
    entry, so it refuses the same poisoned operand."""
    coo_t = tf.random_coo(40, 40, 120, seed=5)
    coo_j = jf.random_coo(40, 40, 120, seed=5)
    assert not np.isin(coo_t.vals, [0.0, 1.0]).any()
    sr = {"min_plus": MIN_PLUS, "plus_times": PLUS_TIMES}[name]
    op = build_operand(coo_t, sr, "ell", device="cpu")
    jop = jax_build(coo_j, jax_semiring(name), "ell")
    pad = float(np.finfo(np.float32).max) if name == "min_plus" else 0.0
    vals = op.vals.clone()
    slot = tuple(torch.nonzero(vals == pad)[0].tolist())
    vals[slot] = garbage
    jvals = np.asarray(jop.vals).copy()
    assert jvals[slot] == pad
    jvals[slot] = garbage
    jax_verify(coo_j, jax_semiring(name), JaxEllOperand(cols=jop.cols, vals=jvals), "ell")
    with pytest.raises(OperandInitError, match="vals"):
        verify_operand_initialized(coo_t, sr, EllOperand(op.cols, vals), "ell")


def test_int_carrier_admits_zero_and_one_only():
    coo = _matrix(OR_AND)
    op = build_operand(coo, OR_AND, "bsr_fused", device="cpu")
    assert op.strips.dtype == torch.int32
    verify_operand_initialized(coo, OR_AND, op, "bsr_fused")
    strips = op.strips.clone()
    strips.view(-1)[0] = 2
    with pytest.raises(OperandInitError, match="strips"):
        verify_operand_initialized(coo, OR_AND, type(op)(strips, op.cols), "bsr_fused")
