"""The port's command-line commands against the JAX package's, with
``--device cpu``: the non-mesh CLI cases of tests/test_harness.py and the
--reorder case of tests/test_reorder.py. On the same .mtx each command
returns JAX's code, and the records that --jsonl and --sql write equal
JAX's in every field but the times and what derives from them (gflops,
gnnz_per_s, roofline_frac), the host and the device; so do the distributed
flags (--mesh, --devices, --frontier, --sharded-mode), whose port ranks run
over gloo."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import sparseharness_tpu.cli.main as jcli
import sparseharness_tpu.formats as jf
import sparseharness_tpu_torch.cli.main as tcli

REPO = Path(__file__).resolve().parents[1]
#: fields that differ between two runs of the same solve, or between hosts
VOLATILE = {"time_ns", "gflops", "gnnz_per_s", "roofline_frac", "host", "device"}
#: SQL columns: time, correct, kernel, global, local, host, device, matrix,
#: iteration, trial, statistic, experiment_id
SQL_VOLATILE = (0, 5, 6)


@pytest.fixture(scope="module")
def mtx(tmp_path_factory):
    d = tmp_path_factory.mktemp("mtx")
    paths = {}
    g = jf.random_graph_coo(80, 2.0, seed=4)
    paths["graph"] = g
    roots = jf.random_graph_coo(60, 3.0, seed=31)
    paths["roots"] = roots.with_values(np.abs(roots.vals) + 0.1)
    paths["small"] = jf.random_coo(60, 60, 200, seed=3)
    # positive values: the solve converges at the same step in both packages
    # (their norms round differently in the last bit, so a |Δ| at delta
    # could fall either side)
    eig = jf.random_coo(48, 48, 300, seed=9)
    paths["eig"] = eig.with_values(np.abs(eig.vals) + 0.1)
    rng = np.random.default_rng(7)
    band = jf.banded_coo(80, 2, seed=7)
    perm = rng.permutation(80)
    inv = np.argsort(perm)
    paths["shuffled"] = jf.coo_from_arrays(inv[band.rows], inv[band.cols],
                                           np.abs(band.vals) + 0.1, band.shape)
    out = {}
    for name, coo in paths.items():
        out[name] = str(d / f"{name}.mtx")
        jf.write_mtx(out[name], coo)
    return out


def _run_both(command, argv, tmp_path, capsys):
    """(port rc, JAX rc, port records, JAX records, port SQL, JAX SQL)."""
    res = []
    for pkg, extra in ((tcli, ["--device", "cpu"]), (jcli, [])):
        tag = "port" if pkg is tcli else "jax"
        jsonl, sql = tmp_path / f"{tag}.jsonl", tmp_path / f"{tag}.sql"
        rc = getattr(pkg, command)(argv + extra + ["--jsonl", str(jsonl), "--sql", str(sql)])
        capsys.readouterr()
        rows = [json.loads(line) for line in jsonl.read_text().splitlines()] \
            if jsonl.exists() else []
        sqls = sql.read_text().splitlines() if sql.exists() else []
        res.append((rc, rows, sqls))
    (prc, prows, psql), (jrc, jrows, jsql) = res
    return prc, jrc, prows, jrows, psql, jsql


def _stable(row):
    return {k: v for k, v in row.items() if k not in VOLATILE}


def _sql_fields(line):
    values = line[line.index("VALUES (") + 8:-2].split(", ")
    return [v for i, v in enumerate(values) if i not in SQL_VOLATILE]


def _assert_same_records(prows, jrows, psql, jsql):
    assert len(prows) == len(jrows) > 0
    for a, b in zip(prows, jrows):
        assert sorted(a) == sorted(b)
        assert _stable(a) == _stable(b)
    assert [_sql_fields(s) for s in psql] == [_sql_fields(s) for s in jsql]


# (command, argv): -n 2 keeps both trials whatever the timeout ratchet does
# (a trial's row is written before the ratchet can stop the next one)
RECORD_CASES = {
    "spmv_ell": ("spmv_main", ["-m", "{small}", "-k", "ell", "-n", "2"]),
    "spmv_sell": ("spmv_main", ["-m", "{small}", "-k", "sell", "-n", "2", "-e", "x1"]),
    "sssp": ("sssp_main", ["-m", "{graph}", "-n", "2", "--root", "0"]),
    "sssp_sell": ("sssp_main", ["-m", "{graph}", "-n", "1", "--root", "3", "-k", "sell"]),
    "sssp_stepped": ("sssp_main", ["-m", "{graph}", "-n", "1", "--root", "0", "--stepped"]),
    "bfs_roots": ("bfs_main", ["-m", "{roots}", "--roots", "0,5", "-n", "1", "-k", "bsr_ell"]),
    "sssp_roots": ("sssp_main", ["-m", "{roots}", "--roots", "0,5,9", "-n", "1"]),
    "pr": ("pr_main", ["-m", "{graph}", "-n", "1", "-f", "label", "--hostname", "h1"]),
    "scc": ("scc_main", ["-m", "{graph}", "-n", "1"]),
    "scc_full": ("scc_main", ["-m", "{graph}", "-n", "1", "--full"]),
    "eigenvector": ("eigenvector_main", ["-m", "{eig}", "-n", "1"]),
    "eigenvector_cut": ("eigenvector_main", ["-m", "{eig}", "-n", "1", "--max-iter", "1"]),
    "cc": ("cc_main", ["-m", "{graph}", "-n", "1"]),
    "widest_path": ("widest_path_main", ["-m", "{graph}", "-n", "1", "--root", "2"]),
    "sssp_reorder": ("sssp_main", ["-m", "{shuffled}", "--root", "0", "-k", "auto", "-n", "1",
                                   "--reorder", "rcm"]),
    "spmv_reorder": ("spmv_main", ["-m", "{shuffled}", "-k", "auto", "-n", "2",
                                   "--reorder", "rcm"]),
    "sssp_no_gold": ("sssp_main", ["-m", "{graph}", "-n", "1", "--no-gold"]),
}


@pytest.mark.parametrize("case", sorted(RECORD_CASES))
def test_command_matches_jax(case, mtx, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("SPARSEHARNESS_TPU_NATIVE", "0")  # JAX's NumPy RCM, which the port copies
    command, argv = RECORD_CASES[case]
    argv = [a.format(**mtx) for a in argv]
    prc, jrc, prows, jrows, psql, jsql = _run_both(command, argv, tmp_path, capsys)
    assert prc == jrc
    assert prc == (1 if case == "eigenvector_cut" else 0)
    _assert_same_records(prows, jrows, psql, jsql)


def test_spmv_runfile_matches_jax(mtx, tmp_path, capsys):
    rf = tmp_path / "runfile.csv"
    rf.write_text("524288,1,1,128,1,1,\n16384,1,1,64,1,1,\n")
    argv = ["-m", mtx["small"], "-k", "ell", "-n", "2", "-r", str(rf)]
    prc, jrc, prows, jrows, psql, jsql = _run_both("spmv_main", argv, tmp_path, capsys)
    assert prc == jrc == 0
    _assert_same_records(prows, jrows, psql, jsql)


def test_spmv_sweep_checks_every_variant(mtx, tmp_path, capsys):
    jsonl = tmp_path / "sweep.jsonl"
    rc = tcli.spmv_main(["-m", mtx["small"], "--sweep", "-n", "1", "--device", "cpu",
                         "--jsonl", str(jsonl)])
    out = capsys.readouterr().out
    assert rc == 0 and "BEST " in out
    rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert {r["kernel"] for r in rows} >= {"sell", "sell2", "bsr_fused", "ell", "coo_seg"}
    assert all(r["correctness"] == "correct" for r in rows)


def test_spmv_summary_and_jsonl(mtx, tmp_path, capsys):
    jsonl = tmp_path / "out.jsonl"
    rc = tcli.spmv_main(["-m", mtx["small"], "-k", "ell", "-n", "2", "--jsonl", str(jsonl),
                         "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Gnnz/s" in out and "correct" in out
    lines = jsonl.read_text().strip().splitlines()
    assert len(lines) == 3  # 2 raw + 1 median
    assert json.loads(lines[0])["kernel"] == "ell"


def test_profile_writes_trace(mtx, tmp_path):
    prof = tmp_path / "prof"
    assert tcli.spmv_main(["-m", mtx["small"], "-k", "ell", "-n", "1", "--device", "cpu",
                           "--profile", str(prof)]) == 0
    assert (prof / "trace.json").stat().st_size > 0
    assert tcli.sssp_main(["-m", mtx["graph"], "-n", "1", "--device", "cpu",
                           "--profile", str(prof / "s")]) == 0
    events = json.loads((prof / "s" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "program" and e["name"] == "fixpoint.solve" for e in events)


def test_trace_flag_emits_profiling_lines(mtx, capfd, monkeypatch):
    monkeypatch.setenv("SPARSEHARNESS_TPU_TRACE", "0")  # restored after the test
    assert tcli.spmv_main(["-m", mtx["small"], "-n", "1", "--device", "cpu", "--trace"]) == 0
    assert 'PROFILING_DATUM("executeKernel", "benchmark_spmv"' in capfd.readouterr().err


def test_just_parser(mtx, capsys):
    for kernel in ("ell", "sell"):
        assert tcli.just_parser_main(["-m", mtx["small"], "-k", kernel, "-n", "2",
                                      "--device", "cpu", "--no-native"]) == 0
        assert jcli.just_parser_main(["-m", mtx["small"], "-k", kernel, "-n", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count("encode[sell]") == 4


#: the distributed flags, each run by both packages on the same .mtx (the
#: port on --device cpu, its ranks over gloo; JAX on the conftest's virtual
#: devices): the same exit code and the same records. JAX's spmv refuses
#: --mesh with --sweep, and its cc and widest_path have no sharded solve,
#: so those three stop with JAX's parser error in both.
DISTRIBUTED_CASES = [
    ("spmv_main", ["--mesh", "2"]),
    ("spmv_main", ["--devices", "2,3"]),
    ("spmv_main", ["--mesh", "2", "--sweep"]),
    ("sssp_main", ["--mesh", "2"]),
    ("sssp_main", ["--frontier"]),
    ("bfs_main", ["--frontier", "--budget", "64"]),
    ("sssp_main", ["--sharded-mode", "band"]),
    ("pr_main", ["--devices", "0"]),
    ("scc_main", ["--mesh", "4", "--full"]),
    ("eigenvector_main", ["--sharded-mode", "gather"]),
    ("cc_main", ["--mesh", "2"]),
    ("widest_path_main", ["--devices", "4,5"]),
]
PARSER_ERRORS = {("spmv_main", "--mesh_2_--sweep"), ("cc_main", "--mesh_2"),
                 ("widest_path_main", "--devices_4,5")}


@pytest.mark.parametrize("command,argv", DISTRIBUTED_CASES,
                         ids=lambda v: v if isinstance(v, str) else "_".join(v))
def test_distributed_flags_match_jax(command, argv, mtx, tmp_path, capsys):
    argv = ["-m", mtx["graph"], "-n", "1"] + argv
    if (command, "_".join(argv[4:])) in PARSER_ERRORS:
        for pkg, extra in ((tcli, ["--device", "cpu"]), (jcli, [])):
            with pytest.raises(SystemExit) as e:
                getattr(pkg, command)(argv + extra)
            assert e.value.code == 2
        return
    prc, jrc, prows, jrows, psql, jsql = _run_both(command, argv, tmp_path, capsys)
    assert prc == jrc == 0
    _assert_same_records(prows, jrows, psql, jsql)


@pytest.mark.parametrize("command,argv", [
    ("sssp_main", ["--roots", "0,1", "--stepped"]),
    ("pr_main", ["--roots", "0,1"]),
    ("scc_main", ["--reorder", "rcm"]),
])
def test_parser_refusals_match_jax(command, argv, mtx):
    for pkg, extra in ((tcli, ["--device", "cpu"]), (jcli, [])):
        with pytest.raises(SystemExit) as e:
            getattr(pkg, command)(["-m", mtx["graph"], "-n", "1"] + argv + extra)
        assert e.value.code == 2


def test_module_entry_point(mtx, tmp_path):
    """python -m sparseharness_tpu_torch.cli <app> as a user runs it."""
    jsonl = tmp_path / "m.jsonl"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "sparseharness_tpu_torch.cli", "spmv", "-m", mtx["small"],
         "-k", "sell", "-n", "2", "--device", "cpu", "--jsonl", str(jsonl)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert all(json.loads(line)["kernel"] == "sell" for line in jsonl.read_text().splitlines())
    bad = subprocess.run([sys.executable, "-m", "sparseharness_tpu_torch.cli", "nope"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert bad.returncode == 2 and "usage" in bad.stderr


def test_every_jax_command_has_a_port():
    jax_commands = {n for n in dir(jcli) if n.endswith("_main") and not n.startswith("_")}
    assert {f"{name}_main" for name in tcli.COMMANDS} == jax_commands
