"""The port's bench entry (`fast_monte_carlo_tpu_torch/bench.py`) on the CPU.

The counterparts of `tests/test_bench_surface.py`'s four tests of
`bench.py` (the one-line JSON contract, the budget's best-so-far, `--shard`
in a world of one and over two gloo ranks, a budget too small to measure),
run on the repo's own inputs: the fixture SP+ sheet and the fixture heads.
The run's `SimConfig` is held to the one `bench.py` builds from the same
flags, field by field, and the bench's workload to the JAX package's on the
same inputs within Monte-Carlo error (the streams differ: ROADMAP.md's
divergences)."""
import ast
import dataclasses
import json
import os
import re
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fast_monte_carlo_tpu_torch import api, bench, cli, fixtures
from fast_monte_carlo_tpu_torch.ops import table_lookup

from test_torch_support import jax_readable_copy
from test_torch_support import table_cache_off  # noqa: F401 (autouse)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
BENCH_PY = (REPO / "bench.py").read_text()
# the directory bench.py reads its sheet and heads from
REFERENCE_DIR = re.search(r'^REFERENCE_DIR = "(.+)"$', BENCH_PY, re.M).group(1)
ENV = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
PORT_META = {"backend", "device", "card", "inputs", "table_cache", "launches", "ignored"}


def bench_py_meta_keys() -> set:
    """The keys of the `meta` dict that bench.py prints."""
    for node in ast.walk(ast.parse(BENCH_PY)):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "meta" in keys:
                meta = node.values[keys.index("meta")]
                return {k.value for k in meta.keys}
    raise AssertionError("bench.py prints no meta dict")


def _run(*extra, timeout=60, torchrun=0):
    cmd = [sys.executable, "-m", "fast_monte_carlo_tpu_torch.bench", "--smoke", *extra]
    if torchrun:
        cmd[1:2] = ["-m", "torch.distributed.run", "--standalone",
                    f"--nproc_per_node={torchrun}", "-m"]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=REPO,
                          env=ENV)


def _one_json_line(proc) -> dict:
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    assert len(lines) == 1, f"expected ONE json line on stdout, got: {lines}"
    return json.loads(lines[0])


def test_bench_smoke_json_contract():
    """`--smoke` prints one JSON line with bench.py's contract on the CPU:
    the five keys, vs_baseline = value / 40, every meta key bench.py
    prints and the port's own, the fixture inputs; the sanity line on
    stderr."""
    proc = _run("--repeats", "1")
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = _one_json_line(proc)
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "meta"}
    assert rec["metric"] == "full_game_sims_per_sec_single_chip_analytic_summary"
    assert rec["unit"] == "games/sec" and rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / 40.0, 1)
    meta = rec["meta"]
    assert bench_py_meta_keys() | PORT_META <= set(meta)
    assert meta["emit"] == "complete" and len(meta["runs"]) >= 1
    assert meta["n_games"] == 2048 and meta["mode"] == "analytic" and meta["rng"] == "rbg"
    assert meta["backend"] == "torch" and meta["card"] is None
    assert meta["device"] == {"platform": "cpu", "kind": meta["device"]["kind"], "count": 1}
    assert meta["inputs"]["team_a"] == "Team A" and meta["inputs"]["team_b"] == "Team B"
    assert meta["inputs"]["sp_source"].startswith("fixtures.write_sp_sheet(")
    assert meta["launches"] == {"philox_draws": 0, "forest_eval": 0, "nano_game": 0,
                                "score_moments": 0}   # plain versions here
    assert meta["ignored"] == {"unroll": 0, "tail_chunk": 0, "tail_after": 144}
    assert "sanity" in proc.stderr


def test_bench_budget_expiry_emits_best_so_far():
    """A budget that expires mid-refinement still prints the JSON line (rc
    0, the best measurement so far)."""
    proc = _run("--repeats", "500", "--budget", "12")
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = _one_json_line(proc)
    assert rec["value"] > 0
    assert rec["meta"]["emit"] in ("budget_expired", "complete")
    assert (rec["meta"]["emit"] == "budget_expired"
            or "skipping full-shape repeat" in proc.stderr)
    assert len(rec["meta"]["runs"]) < 500


@pytest.mark.parametrize("ranks", [1, 2])
def test_bench_shard_smoke(ranks):
    """`--shard` in a world of one, and over two gloo ranks under torchrun:
    rank 0 alone prints one line, the metric marked sharded, ndev the
    world size and each launch twice the chunk's games."""
    proc = _run("--repeats", "1", "--shard", "-n", "512", "--chunk", "128",
                torchrun=ranks if ranks > 1 else 0)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = _one_json_line(proc)
    assert rec["metric"].endswith("_sharded")
    meta = rec["meta"]
    assert meta["sharded"] is True and meta["ndev"] == ranks
    assert meta["chunk_games_configured"] == 128 * ranks
    assert proc.stderr.count("# sanity") == 1


def test_bench_shard_budget_ends_every_rank():
    """A budget that expires while two ranks play a sharded refinement ends
    both at its deadline, each on its own (no launcher kills a rank left
    behind): rank 0 prints the best so far (or, with none yet, exits 3
    as rank 1 does), rank 1 prints nothing, and neither waits in a
    collective."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # the budget outlasts the set-up and expires in the first run or the
    # next: a run is 32 sharded launches (--chunk 32), so that two runs take
    # several budgets even on a fast host, and the bench never ends its
    # repeats by its own estimate (emit "complete") before the deadline
    budget = 8.0
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fast_monte_carlo_tpu_torch.bench", "--smoke", "--shard",
         "--repeats", "500", "-n", "4096", "--chunk", "32", "--budget", str(budget)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(ENV, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))) for r in range(2)]
    ends, outs = [], []
    for p in procs:
        outs.append(p.communicate(timeout=budget + 30))
        ends.append(time.perf_counter() - t0)
    rcs = [p.returncode for p in procs]
    assert all(rc in (0, 3) for rc in rcs), (rcs, [e[-1500:] for _, e in outs])
    assert max(ends) < budget + 10, ends
    assert not outs[1][0].strip()
    if rcs[0] == 0:
        rec = json.loads(outs[0][0])
        assert rec["meta"]["emit"] == "budget_expired" and rec["meta"]["ndev"] == 2
    else:
        assert not outs[0][0].strip()
        assert "budget expired before ANY measurement" in outs[0][1]


def test_bench_budget_too_small_is_loud():
    """A budget that expires before any measurement exits 3 with nothing on
    stdout and says so on stderr."""
    proc = _run("--repeats", "1", "--budget", "0.5")
    assert proc.returncode == 3, (proc.returncode, proc.stderr[-500:])
    assert not proc.stdout.strip()
    assert "budget expired before ANY measurement" in proc.stderr


FLAG_SETS = {
    "defaults": [],
    "threefry": ["--rng", "threefry"],
    "pallas_chunk antithetic": ["--rng", "pallas_chunk", "--antithetic"],
    "play chunk": ["--play-chunk", "12", "--rng", "pallas"],
    "ignored knobs": ["--unroll", "8", "--tail-chunk", "6", "--tail-after", "120"],
}


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_sim_config_is_bench_pys(name):
    """`bench.sim_config` equals, field by field, the SimConfig that
    bench.py's own lines build from the same flags (run on the JAX
    package's SimConfig); the knobs the port ignores are kept in its
    config as given and named in meta.ignored."""
    from fast_monte_carlo_tpu.config import SimConfig as JaxSimConfig

    args = bench.parse_args(FLAG_SETS[name])
    src = BENCH_PY[BENCH_PY.index("    cfg = SimConfig()\n"):BENCH_PY.index("    sp = load_sp_flex(")]
    ns = {"SimConfig": JaxSimConfig, "dataclasses": dataclasses, "args": args}
    exec(textwrap.dedent(src), ns)
    want, got = ns["cfg"], bench.sim_config(args)
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if dataclasses.is_dataclass(w):
            for sub in dataclasses.fields(w):
                assert getattr(g, sub.name) == getattr(w, sub.name), (f.name, sub.name)
        else:
            assert g == w, f.name


@pytest.fixture(scope="module")
def sheet(tmp_path_factory):
    d = tmp_path_factory.mktemp("bench_inputs")
    return {"sp": fixtures.write_sp_sheet(d / "sp.csv", 136, 0),
            "jax_art": jax_readable_copy(fixtures.ARTIFACT_DIR, d / "art")}


@pytest.mark.parametrize("mode", ["analytic", "table"])
def test_bench_workload_agrees_with_jax(mode, sheet):
    """The bench's summary workload on its default inputs (the fixture
    sheet's Team A and Team B, the fixture heads, each loaded by its own
    package's loaders) against the JAX package's `run_pairs_summary` with
    bench.py's config: 8,192 games each, win rates and mean points within
    4 standard errors, and the contexts equal."""
    import fast_monte_carlo_tpu.api as japi
    from fast_monte_carlo_tpu.config import SimConfig as JaxSimConfig
    from fast_monte_carlo_tpu.data import build_team_context_from_sp_flex, load_sp_flex
    from fast_monte_carlo_tpu.models.heads import load_heads

    pairs = 4096
    args = bench.parse_args(["--device", "cpu", "--mode", mode, "-n", str(2 * pairs)])
    sp, a, b, heads = bench.load_inputs(args, sheet["sp"])
    runner = api.MatchupRunner(a, b, heads, bench.sim_config(args), mode=mode, device="cpu")
    run, sanity = bench.workload(runner, args, pairs)
    got = run(0, pairs)
    mean, win_a = sanity(got)
    assert float(got.n) == 2 * pairs and mean.tolist() == got.mean_pts.tolist()

    jcfg = JaxSimConfig()
    # scan_unroll only unrolls the compiled loop (same games), and 1 compiles fastest
    jcfg = jcfg.replace(engine=dataclasses.replace(jcfg.engine, rng_impl="rbg", scan_unroll=1))
    jsp = load_sp_flex(sheet["sp"])
    ja = build_team_context_from_sp_flex("Team A", 2025, 1, jsp)
    jb = build_team_context_from_sp_flex("Team B", 2025, 1, jsp)
    assert (a.sp_rating, a.sp_offense, b.sp_defense) == (ja.sp_rating, ja.sp_offense,
                                                         jb.sp_defense)
    jheads = load_heads(sheet["jax_art"]) if mode == "table" else None
    want = japi.MatchupRunner(ja, jb, jheads, jcfg, mode=mode, table_quality="nano"
                              ).run_pairs_summary(pairs, seed=0, chunk_pairs=pairs)
    n = 2 * pairs
    for i in range(2):
        se = np.hypot(got.sd_pts[i], float(want.sd_pts[i])) / np.sqrt(n)
        assert abs(got.mean_pts[i] - float(want.mean_pts[i])) <= 4 * se, i
        p = (got.win_rate[i] + float(want.win_rate[i])) / 2
        assert abs(got.win_rate[i] - float(want.win_rate[i])) <= 4 * np.sqrt(2 * p * (1 - p) / n)
        assert 10 < got.mean_pts[i] < 50


def test_bench_lanes_record_a_failure(monkeypatch, capsys):
    """In table mode the lanes run after the main result: the sheet's top
    teams by rating through `simulate_slate_summary_rows` (one matchup
    here, the sheet's top two, whose tables the main run built); a lane
    that fails is recorded in meta.lanes with its error, and the result
    is still printed."""
    top = fixtures.sp_sheet_rows(136, 0)[:2]
    monkeypatch.setattr(bench, "LANE_GAMES", 1)
    monkeypatch.setattr(bench, "LANES", (("slate_loop", 64, 0.0), ("sweep3", 96, 0.0)))
    monkeypatch.setattr(table_lookup, "TABLE_CACHE_DIR", table_lookup.TABLE_CACHE_DIR)
    real = api.simulate_slate_summary_rows

    def second_lane_fails(games, **kw):
        if kw["n_pairs"] == 96:
            raise MemoryError("no room for the sweep")
        return real(games, **kw)

    monkeypatch.setattr(api, "simulate_slate_summary_rows", second_lane_fails)
    rc = bench.main(["--device", "cpu", "-n", "256", "--repeats", "1", "--budget", "0",
                     "--team-a", top[0]["Current SP+"], "--team-b", top[1]["Current SP+"]])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out)
    lanes = rec["meta"]["lanes"]
    assert rec["meta"]["mode"] == "table" and rec["meta"]["emit"] == "complete"
    assert [lane["lane"] for lane in lanes] == ["slate_loop", "sweep3"]
    assert lanes[0]["n_games"] == 128 and lanes[0]["matchups"] == 1
    assert lanes[1] == {"lane": "sweep3", "error": "MemoryError: no room for the sweep"}


def test_cli_bench_runs_the_entry(capfd, monkeypatch):
    """`cli bench --device cpu --mode analytic -n 512` runs the entry in a
    subprocess: exit 0 and one JSON line."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the subprocess's torch threads
    assert cli.main(["bench", "--device", "cpu", "--mode", "analytic", "-n", "512"]) == 0
    out, err = capfd.readouterr()
    lines = [line for line in out.splitlines() if line.strip()]
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert rec["meta"]["n_games"] == 512 and rec["meta"]["mode"] == "analytic"
    assert "sanity" in err


def test_bench_reads_nothing_of_bench_pys_directory(tmp_path):
    """A smoke run opens no file under bench.py's reference directory and
    its inputs are the repo's own."""
    code = textwrap.dedent(f"""
        import runpy, sys
        def hook(event, args):
            if event == "open" and str(args[0]).startswith({REFERENCE_DIR!r}):
                raise RuntimeError(f"opened {{args[0]}}")
        sys.addaudithook(hook)
        sys.argv = ["bench", "--smoke", "--repeats", "1", "-n", "256"]
        runpy.run_module("fast_monte_carlo_tpu_torch.bench", run_name="__main__")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=60, cwd=REPO, env=ENV)
    assert proc.returncode == 0, proc.stderr[-2000:]
    inputs = _one_json_line(proc)["meta"]["inputs"]
    assert not inputs["sp"].startswith(REFERENCE_DIR)
    assert bench.parse_args([]).artifacts == fixtures.ARTIFACT_DIR
