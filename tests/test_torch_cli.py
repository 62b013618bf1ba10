"""The port's command line (`python -m fast_monte_carlo_tpu_torch.cli`) on the
CPU (`--device cpu`, analytic mode), held to the JAX package's CLI on the
same SP+ sheet (`fixtures.write_sp_sheet`) and trained-head fixture
directory: every ported subcommand prints the JAX command's lines once the
numbers are masked, and its numbers agree within Monte-Carlo error (the two
packages draw different streams).  The JAX CLI runs with its scan unrolled
once, which shapes only XLA's loop, so that its programs compile in
seconds.  Over the same saved sim files `edges` and `prop` print the JAX
CLI's lines exactly; `edges --device` keeps the JAX CLI's branches and
launch shapes.  `sim --sd-mode cachewarm` plays its oracle warm-up and
reads it back from the disk cache.  `--shard` runs in a world of one
and prints what the same command prints without it, and under two gloo
ranks only rank 0 prints.  The subcommands not ported raise
NotImplementedError naming their ROADMAP.md queue item before any game is
played; `serve` binds and answers /health."""
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import threading
import time
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch

from fast_monte_carlo_tpu_torch import api, cli, fixtures, serve
from fast_monte_carlo_tpu_torch.ops import game
from fast_monte_carlo_tpu_torch.parallel import mesh

from test_torch_support import jax_readable_copy, run_ranks, within, write_focus
from test_torch_support import table_cache_off  # noqa: F401 (autouse)

torch.set_num_threads(1)

ART = fixtures.ARTIFACT_DIR
NUM = re.compile(r"[-+]?\$?[-+]?\d[\d,]*(\.\d+)?(e[-+]?\d+)?")
LEGS = json.dumps([{"kind": "moneyline", "team": "Team A"},
                   {"kind": "total", "side": "over", "line": 40.5},
                   {"kind": "spread", "team": "Team B", "line": 6.5}])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    games, one, lines = d / "games.csv", d / "one.csv", d / "lines.csv"
    games.write_text("team_a,team_b\nTeam A,Team B\nTeam 000,Team 001\n")
    one.write_text("team_a,team_b\nTeam A,Team B\n")
    lines.write_text("team_a,spread,total\nTeam A,-3.5,44.5\nTeam 000,,40.5\n")
    fixtures.write_csv(d / "props.csv", fixtures.prop_rows(4), fixtures.PROP_COLS)
    return {"sp": fixtures.write_sp_sheet(d / "sp.csv", 136, 0), "games": str(games),
            "one": str(one), "lines": str(lines), "props": str(d / "props.csv"),
            "focus": str(write_focus(d / "focus.csv")),
            "jart": jax_readable_copy(ART, d / "jart"), "dir": d}


@pytest.fixture(scope="module")
def saved(files, tmp_path_factory):
    """The directory `sim --save --players` (the port, focus rosters,
    analytic mode) wrote scores_ and players_teama_teamb_wk1_sims.csv to."""
    d = tmp_path_factory.mktemp("saved")
    here = os.getcwd()
    os.chdir(d)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(["sim", "Team A", "Team B", "--sp", files["sp"], "--artifacts", ART,
                             "--mode", "analytic", "-n", "512", "--players", "--save",
                             "--focus", files["focus"], "--device", "cpu"]) == 0
    finally:
        os.chdir(here)
    return str(d)


@pytest.fixture
def jax_main(monkeypatch):
    """The JAX CLI's main, its default SimConfig's scan unrolled once and
    its persistent compile cache left off."""
    from fast_monte_carlo_tpu import api as japi
    from fast_monte_carlo_tpu import cli as jcli
    from fast_monte_carlo_tpu.config import SimConfig as JaxSimConfig

    c = JaxSimConfig()
    cfg1 = c.replace(engine=dataclasses.replace(c.engine, scan_unroll=1))
    monkeypatch.setattr(japi, "SimConfig", lambda: cfg1)
    monkeypatch.setattr(jcli, "_enable_compile_cache", lambda: None)
    return jcli.main


def _out(main, argv, capsys) -> str:
    assert main(argv) == 0
    return capsys.readouterr().out


def _masked(text: str) -> list:
    return [" ".join(NUM.sub("#", line).split()) for line in text.splitlines()]


def _both(jax_main, capsys, argv, files, port_only=()):
    """(port output, JAX output) of one subcommand, the masked lines equal."""
    base = ["--sp", files["sp"], "--mode", "analytic"]
    port = _out(cli.main, argv + base + ["--artifacts", ART, "--device", "cpu", *port_only],
                capsys)
    jax = _out(jax_main, argv + base + ["--artifacts", files["jart"]], capsys)
    assert _masked(port) == _masked(jax), (port, jax)
    return port, jax


def _line(text: str, start: str) -> str:
    return next(x for x in text.splitlines() if x.strip().startswith(start))


def _floats(line: str) -> list:
    return [float(m.group(0).replace(",", "").replace("$", "")) for m in NUM.finditer(line)]


def test_sim_lines_and_numbers_equal_jax(jax_main, capsys, files, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    n = 1024
    port, jax = _both(jax_main, capsys, ["sim", "Team A", "Team B", "-n", str(n), "--save"],
                      files)
    for team in ("Team A", "Team B"):
        got, want = _floats(_line(port, team)), _floats(_line(jax, team))
        assert within(got[4], want[4], want[4], n), team           # win_rate
        for i in (0, 2):                                           # mean pts, opp
            assert abs(got[i] - want[i]) <= 4 * want[i + 1] * math.sqrt(2 / n), (team, i)
    assert _line(port, "saved").split() == [
        "saved", "scores_teama_teamb_wk1_sims.csv", "/", "players_teama_teamb_wk1_sims.csv"]
    assert len(open(tmp_path / "scores_teama_teamb_wk1_sims.csv").readlines()) == 2 * n + 1


def test_live_lines_and_numbers_equal_jax(jax_main, capsys, files):
    n = 4096
    port, jax = _both(jax_main, capsys, [
        "live", "Team A", "Team B", "--ytg", "40", "--quarter", "4", "--clock", "05:00",
        "--down", "2", "--dist", "7", "--score", "21-17", "-n", str(n), "--spread", "-3.5",
        "--total", "45.5"], files)
    got, want = _floats(_line(port, "win:")), _floats(_line(jax, "win:"))
    assert got[3] == want[3] == n
    for g, w in zip(got[:3], want[:3]):
        assert within(g, w, w, n)
    got, want = _floats(_line(port, "proj:")), _floats(_line(jax, "proj:"))
    assert all(abs(g - w) <= 0.6 for g, w in zip(got, want)), (got, want)


def test_fourth_lines_and_numbers_equal_jax(jax_main, capsys, files):
    n = 2048
    port, jax = _both(jax_main, capsys, [
        "fourth", "Team A", "Team B", "--ytg", "33", "--dist", "2", "--clock", "07:00",
        "--score", "14-10", "-n", str(n)], files)
    for choice in ("policy", "go", "fg", "punt"):
        g = float(re.search(r"win\(Team A\) (\S+)", _line(port, choice)).group(1))
        w = float(re.search(r"win\(Team A\) (\S+)", _line(jax, choice)).group(1))
        assert within(g, w, w, n), choice


def test_parlay_lines_json_and_numbers_equal_jax(jax_main, capsys, files):
    n = 1024
    port, jax = _both(jax_main, capsys, [
        "parlay", "Team A", "Team B", "--legs", LEGS, "-n", str(n), "--price", "450",
        "--corr", "--rr", "1,2", "--json"], files)
    for start in ("P(all legs win)", "Team A ML", "Over 40.5", "Team B +6.5"):
        assert within(_floats(_line(port, start))[-1 if start[0] == "P" else 0],
                      _floats(_line(jax, start))[-1 if start[0] == "P" else 0], 0.5, 2 * n), \
            start
    got, want = json.loads(port.splitlines()[-1]), json.loads(jax.splitlines()[-1])
    assert list(got) == list(want) and list(got["round_robin"]) == list(want["round_robin"])
    assert [list(r) for r in got["leg_corr"]] == [list(r) for r in want["leg_corr"]]


def test_season_lines_and_numbers_equal_jax(jax_main, capsys, files):
    n = 1024
    port, jax = _both(jax_main, capsys, ["season", "Team A", "--opponents", "Team B,Team 000",
                                         "-n", str(n), "--line", "1.5"], files)
    for start in ("vs Team B", "vs Team 000"):
        g = float(re.search(r"p_win (\S+)", _line(port, start)).group(1))
        w = float(re.search(r"p_win (\S+)", _line(jax, start)).group(1))
        assert within(g, w, w, 2 * n), start


@pytest.mark.parametrize("lines", [False, True])
def test_slate_lines_and_numbers_equal_jax(jax_main, capsys, files, lines):
    """The default branch (a score frame a game) and --lines (the summary
    loop, and the slate's market edges)."""
    n = 1024
    port, jax = _both(jax_main, capsys, ["slate", "--games", files["games"], "-n", str(n)]
                      + (["--lines", files["lines"]] if lines else []), files)
    for start in ("Team A", "Team 000"):
        got, want = _floats(_line(port, start))[-7:], _floats(_line(jax, start))[-7:]
        assert got[-1] == want[-1] == 2 * n
        for i in (2, 3):                                          # win_a, win_b
            assert within(got[i], want[i], want[i], 2 * n), (start, i)
    if lines:
        assert "Spread Team A -3.5" in port and "Total 40.5" in port


def test_sim_reconstructed_runs_in_table_mode(capsys, files, monkeypatch):
    """`sim --reconstructed` (the ML play policy) in table mode, the
    default: the runner reads P(pass) from a play-policy table built beside
    the nano tables.  The reconstructed heads are the small fixture heads
    here (`load_reconstructed_heads` patched), which keeps the build short."""
    from fast_monte_carlo_tpu_torch.models import heads as mheads

    monkeypatch.setattr(mheads, "load_reconstructed_heads",
                        lambda artifact_dir=None: fixtures.heads(0, "small"))
    made, post_init = [], api.MatchupRunner.__post_init__

    def spy(self):
        post_init(self)
        made.append(self)

    monkeypatch.setattr(api.MatchupRunner, "__post_init__", spy)
    n = 256
    out = _out(cli.main, ["sim", "Team A", "Team B", "--sp", files["sp"], "--artifacts", ART,
                          "-n", str(n), "--reconstructed", "--device", "cpu"], capsys)
    runner, = made
    assert runner.mode == "table" and runner.cfg.model.use_play_model
    th = runner.heads_state
    assert th.nano is not None and th.play is not None and th.play.has_sd
    for team in ("Team A", "Team B"):
        assert 0.0 <= _floats(_line(out, team))[4] <= 1.0          # win_rate
    assert f"| {n} sims" in _line(out, "Timing")


def test_sim_sd_mode_cachewarm_runs_on_the_cpu(capsys, files, monkeypatch, tmp_path):
    """`sim --sd-mode cachewarm` in table mode: the CPU oracle's warm-up
    games (8 here: SimConfig patched), then the nano tables collapsed at
    their first-visit score diffs (one sd bin).  A second call reads the
    warm-up and the tables from the disk cache and prints the same
    summary line."""
    from fast_monte_carlo_tpu_torch import config
    from fast_monte_carlo_tpu_torch.ops import table_lookup as ttl

    c = config.SimConfig()
    monkeypatch.setattr(config, "SimConfig", lambda: c.replace(
        engine=dataclasses.replace(c.engine, cachewarm_games=8)))
    monkeypatch.setattr(ttl, "TABLE_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(ttl, "_TABLE_MEMO", {})
    monkeypatch.setattr(api, "_RUNNER_MEMO", {})
    made, post_init = [], api.MatchupRunner.__post_init__

    def spy(self):
        post_init(self)
        made.append(self)

    monkeypatch.setattr(api.MatchupRunner, "__post_init__", spy)
    n = 256
    argv = ["sim", "Team A", "Team B", "--sp", files["sp"], "--artifacts", ART, "-n", str(n),
            "--sd-mode", "cachewarm", "--device", "cpu"]
    out = _out(cli.main, argv, capsys)
    runner, = made
    th = runner.heads_state
    assert runner.cfg.engine.sd_mode == "cachewarm" and runner.cfg.engine.cachewarm_games == 8
    assert th.nano is not None and th.nano_nsd == 1 and not th.cache_hit and not th.warm_hit
    assert f"| {n} sims" in _line(out, "Timing")
    assert sorted(p.name.split("_")[0] for p in tmp_path.iterdir()) == ["tables", "warm"]
    ttl._TABLE_MEMO.clear()
    api._RUNNER_MEMO.clear()
    again = _out(cli.main, argv, capsys)
    assert made[1].heads_state.cache_hit and made[1].heads_state.warm_hit
    assert _line(again, "Team A") == _line(out, "Team A")


def test_slate_game_shard_and_batched_branches(capsys, files):
    """--shard game (SlateRunner(game_shard=True) on nano tables built from
    the fixture heads) with --lines, and --batched (one launch): the
    default branch's table, line for line once the numbers are masked."""
    n = 256
    base = ["slate", "--games", files["one"], "--sp", files["sp"], "--artifacts", ART,
            "-n", str(n), "--device", "cpu"]
    plain = _masked(_out(cli.main, base + ["--mode", "analytic"], capsys))
    shard = _out(cli.main, base + ["--shard", "game", "--lines", files["lines"]], capsys)
    batched = _out(cli.main, base + ["--batched"], capsys)
    for out in (shard, batched):
        assert _masked(out)[:4] == plain[:4]
        assert _floats(_line(out, "Team A"))[-1] == 2 * n
    assert "Spread Team A -3.5" in shard
    code = cli.main(base + ["--batched", "--lines", files["lines"]])
    assert code == 2 and "no simulation run" in capsys.readouterr().out


# the subcommands that play no game here: `train` is not ported and raises;
# `bench` (ported) asks for the card by default, and on a host without one
# its subprocess refuses before any game, with no fallback to the CPU
NOT_PORTED = {
    "bench": (["bench", "--mode", "analytic", "-n", "512"], "never falls back to the CPU"),
    "train": (["train", "--data", "d.csv", "--out", "o"], "outside the port's scope"),
}


@pytest.mark.parametrize("name", list(NOT_PORTED))
def test_unported_subcommands_raise_before_any_game(name, files, monkeypatch, capfd):
    def launched(*a, **k):
        raise AssertionError("a game was played")

    monkeypatch.setattr(api, "simulate_games", launched)
    monkeypatch.setattr(game, "simulate_games", launched)
    monkeypatch.setattr(mesh, "simulate_games", launched)
    argv, item = NOT_PORTED[name]
    argv = [{"SP": files["sp"], "GAMES": files["games"]}.get(a, a) for a in argv]
    if name == "bench":
        if torch.cuda.is_available():
            pytest.skip("this host has a card: the bench would run on it")
        assert cli.main(argv) != 0
        out, err = capfd.readouterr()
        assert not out.strip() and item in err and "Traceback" in err
        return
    with pytest.raises(NotImplementedError, match=re.escape(item)):
        cli.main(argv)


# each --shard command beside the same command without it (for `slate
# --shard trial`, the summary loop that --lines routes the default to): in a
# world of one both print the same lines, once timings are left out
SHARDED = {
    "slate --shard trial": (["slate", "--games", "GAMES", "--shard", "trial"],
                            ["slate", "--games", "GAMES", "--lines", "LINES"]),
    "sim --shard": (["sim", "Team A", "Team B", "--shard"], ["sim", "Team A", "Team B"]),
    "live --shard": (["live", "Team A", "Team B", "--ytg", "40", "--shard"],
                     ["live", "Team A", "Team B", "--ytg", "40"]),
    "parlay --shard": (["parlay", "Team A", "Team B", "--legs", LEGS, "--corr", "--shard"],
                       ["parlay", "Team A", "Team B", "--legs", LEGS, "--corr"]),
    "season --shard": (["season", "Team A", "--opponents", "Team B", "--shard"],
                       ["season", "Team A", "--opponents", "Team B"]),
}
TIMED = re.compile(r"Timing:|games in |games/s|\] *$")


def _untimed(text: str, n_lines=None) -> list:
    return [x for x in text.splitlines()[:n_lines] if not TIMED.search(x)]


@pytest.mark.parametrize("name", list(SHARDED) + ["serve --shard"])
def test_shard_flags_run_in_a_world_of_one(name, files, capsys):
    """Each --shard flag runs in a world of one (no process group) and
    prints what the same command prints unsharded: the sharded games are
    the unsharded ones bit for bit.  A server started with --shard answers
    a request that leaves "shard" to it (a sharded run) as it answers
    "shard": false."""
    if name == "serve --shard":
        return _serve_shard_equals_unsharded(files)
    rest = ["--sp", files["sp"], "--artifacts", ART, "--mode", "analytic", "-n", "256",
            "--device", "cpu"]
    sub = {"GAMES": files["games"], "LINES": files["lines"]}
    sharded, plain = ([sub.get(a, a) for a in argv] + rest for argv in SHARDED[name])
    got, want = _out(cli.main, sharded, capsys), _out(cli.main, plain, capsys)
    # slate: the rows' table (--lines prints the markets after it)
    n = 3 if name.startswith("slate") else None
    assert _untimed(got, n) == _untimed(want, n) and _untimed(got, n), (got, want)


def _serve_shard_equals_unsharded(files):
    made = []
    real = serve.make_server

    def capture(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    rc = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serve, "make_server", capture)
        t = threading.Thread(target=lambda: rc.append(cli.main([
            "serve", "--sp", files["sp"], "--artifacts", ART, "--mode", "analytic",
            "--port", "0", "--device", "cpu", "--shard"])))
        t.start()
        try:
            t0 = time.perf_counter()
            while not made and time.perf_counter() - t0 < 60:
                time.sleep(0.02)
            url = f"http://127.0.0.1:{made[0].server_address[1]}/sim"
            answers = []
            for extra in ({}, {"shard": False}):
                body = json.dumps({"team_a": "Team A", "team_b": "Team B", "n_pairs": 256,
                                   "spread": -3.5, **extra}).encode()
                req = urllib.request.Request(url, data=body,
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    answers.append({k: v for k, v in json.loads(r.read()).items()
                                    if k != "elapsed_s"})
        finally:
            if made:
                made[0].shutdown()
            t.join(timeout=60)
    assert rc == [0]
    assert answers[0] == answers[1] and answers[0]["summary"]["n_games"] == 512


def test_sim_shard_over_two_ranks_prints_on_rank_0(files, tmp_path):
    """`sim --shard` under two gloo ranks on the CPU: every rank runs the
    command, only rank 0 prints, and what it prints (the summary and the
    saved file's name) is what one process prints; only rank 0 writes the
    files."""
    argv = ["sim", "Team A", "Team B", "--sp", files["sp"], "--artifacts", ART, "--mode",
            "analytic", "-n", "256", "--device", "cpu", "--shard", "--save"]
    code = ("import contextlib, io, os\n"
            "from fast_monte_carlo_tpu_torch import cli\n"
            f"os.chdir(os.path.join({str(tmp_path)!r}, str(RANK)))\n"
            f"assert cli.main({argv!r}) == 0\n")
    for r in (0, 1):
        (tmp_path / str(r)).mkdir()
    outs = run_ranks(code, 2, tmp_path)
    assert outs[1] == "" and "Timing:" in outs[0]
    assert os.listdir(tmp_path / "0") == ["scores_teama_teamb_wk1_sims.csv"]
    assert os.listdir(tmp_path / "1") == []
    here = os.getcwd()
    os.chdir(tmp_path)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as one:
            assert cli.main([a for a in argv if a != "--shard"]) == 0
    finally:
        os.chdir(here)
    assert _untimed(outs[0]) == _untimed(one.getvalue())


def test_device_defaults_to_the_card(files):
    """Without --device a subcommand asks for the card; without one it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="never falls back to the CPU"):
        cli.main(["live", "Team A", "Team B", "--sp", files["sp"], "--artifacts", ART,
                  "--mode", "analytic", "--ytg", "40", "-n", "64"])


def test_serve_binds_warms_and_answers_health(files, capsys, monkeypatch):
    made = []
    real = serve.make_server

    def capture(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    monkeypatch.setattr(serve, "make_server", capture)
    rc = []
    t = threading.Thread(target=lambda: rc.append(cli.main([
        "serve", "--sp", files["sp"], "--artifacts", ART, "--mode", "analytic", "--port", "0",
        "--device", "cpu", "--warm", files["one"], "--max-games", "4"])))
    t.start()
    try:
        t0 = time.perf_counter()
        while not made and time.perf_counter() - t0 < 60:
            time.sleep(0.02)
        port = made[0].server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=60) as r:
            h = json.loads(r.read())
        assert h["platform"] == "cpu" and h["config"]["device"] == "cpu"
        assert h["config"]["max_games"] == 4 and h["config"]["mode"] == "analytic"
        while "warming" not in capsys.readouterr().out and time.perf_counter() - t0 < 60:
            time.sleep(0.05)
    finally:
        if made:
            made[0].shutdown()
        t.join(timeout=60)
    assert rc == [0]


def test_csv_readers_and_table_equal_pandas(files, tmp_path):
    """The games and lines readers read what pandas reads; the table
    printer prints what pandas' to_string prints."""
    assert cli._read_games(files["games"]) == [
        tuple(r) for r in pd.read_csv(files["games"]).iloc[:, :2].itertuples(index=False)]
    got = cli._read_rows(files["lines"])
    want = pd.read_csv(files["lines"]).to_dict("records")
    assert [list(r) for r in got] == [list(r) for r in want]
    assert serve.jsonable(got) == serve.jsonable(want)
    rows = [{"team": "Team A", "x": 42.71875, "y": 1.0, "n": 3, "s": "a"},
            {"team": "T", "x": 40.875, "y": np.nan, "n": 4, "z": 0.25}]
    df = pd.DataFrame(rows)
    assert cli._rows_text(rows) == df.to_string(index=False)
    ix = df.set_index("team")
    text = cli._frame_text({c: ix[c].tolist() for c in ix.columns}, index=ix.index,
                           index_name="team")
    assert text == ix.to_string()


EDGES = {
    "full": ["--base", "teama_teamb_wk1_sims.csv", "--spread", "-3.5", "--total", "44.5",
             "--props", "PROPS", "--alt", "--alt-width", "3", "--mid-spread=-3.5,7.5",
             "--mid-total", "40.5,47.5"],
    "no lines": ["--props", "PROPS"],
    "middles only": ["--mid-total", "41,46", "--mid-spread", "2.5,6.5"],
}


@pytest.mark.parametrize("name", list(EDGES))
def test_edges_over_saved_files_prints_what_jax_prints(name, jax_main, capsys, files, saved):
    argv = ["edges", "--team-a", "Team A", "--team-b", "Team B", "--dir", saved] + [
        files["props"] if a == "PROPS" else a for a in EDGES[name]]
    port = _out(cli.main, argv, capsys)
    assert port == _out(jax_main, argv, capsys)
    assert ("— Player Props value" in port) == ("--props" in argv)


PROPS = {
    "pass_yds ladder": ["Team A", "Team A Passer 1", "pass_yds", "230.5", "--ladder"],
    "rec ladder": ["Team B", "Team B Receiver 1", "rec", "4", "--ladder", "--width", "2",
                   "--step", "1", "--price", "-120", "--base", "teama_teamb_wk1_sims.csv"],
    "rush_yds": ["Team B", "Team B Rusher 1", "rush_yds", "40.5", "--role", "Rusher"],
}


@pytest.mark.parametrize("name", list(PROPS))
def test_prop_prints_what_jax_prints(name, jax_main, capsys, saved):
    argv = ["prop", *PROPS[name], "--dir", saved]
    port = _out(cli.main, argv, capsys)
    assert port == _out(jax_main, argv, capsys)
    assert ("Alternate lines" in port) == ("--ladder" in argv)


def test_edges_device_cpu_prices_markets(jax_main, capsys, files):
    """`edges --device cpu` simulates and prices in process: the markets'
    lines as the JAX CLI's `edges --device` prints them once the numbers are
    masked, the prop table of the same games, the games counted on cpu."""
    n = 512
    argv = ["edges", "--team-a", "Team A", "--team-b", "Team B", "--sp", files["sp"],
            "--mode", "analytic", "-n", str(n), "--spread", "-3.5", "--total", "44.5",
            "--alt", "--alt-width", "2", "--mid-spread=-3.5,7.5", "--props", files["props"],
            "--focus", files["focus"]]
    port = _out(cli.main, argv + ["--device", "cpu", "--artifacts", ART], capsys)
    jax = _out(jax_main, argv + ["--device", "--artifacts", files["jart"]], capsys)
    cut = "\n— Player Props value"

    def sides(text):   # a ladder row's better side may differ within MC error
        return [re.sub(r"\b(Over|Under|Team A|Team B) #", "SIDE #", x)
                for x in _masked(text.split(cut)[0])]

    assert sides(port) == sides(jax)
    assert port.splitlines()[-1].startswith(f"[{2 * n} games simulated + reduced on cpu in")
    got = _floats(_line(port, "Cover:"))[0] / 100
    assert within(got, _floats(_line(jax, "Cover:"))[0] / 100, got, 2 * n)
    assert port.count("n=1024)") > 10


@pytest.mark.parametrize("props", [False, True])
def test_edges_device_launch_shapes(props, files, capsys, monkeypatch):
    """As the JAX CLI launches: a market-only scan above 65,536 pairs goes
    through run_pairs_summary(n) (whole launches); with --props, one
    run_pairs with players and no box score."""
    calls = []

    def summary(self, n, seed=0, **kw):
        calls.append(("run_pairs_summary", n, seed))
        return real_summary(self, 64, seed=seed)

    def pairs(self, n, seed=0, **kw):
        if n != 64:        # not the small summary's own launch
            calls.append(("run_pairs", n, seed, kw))
        return real_pairs(self, 64, seed=seed, **kw)

    real_summary, real_pairs = api.MatchupRunner.run_pairs_summary, api.MatchupRunner.run_pairs
    monkeypatch.setattr(api.MatchupRunner, "run_pairs_summary", summary)
    monkeypatch.setattr(api.MatchupRunner, "run_pairs", pairs)
    argv = ["edges", "--team-a", "Team A", "--team-b", "Team B", "--sp", files["sp"],
            "--artifacts", ART, "--mode", "analytic", "-n", "70000", "--seed", "3",
            "--spread", "1.5", "--device", "cpu"]
    out = _out(cli.main, argv + (["--props", files["props"], "--focus", files["focus"]]
                                 if props else []), capsys)
    if props:
        assert calls == [("run_pairs", 70000, 3,
                          {"collect_players": True, "collect_stats": False})]
        assert "— Player Props value" in out
    else:
        assert calls == [("run_pairs_summary", 70000, 3)]
    assert out.splitlines()[-1].startswith("[128 games simulated")


def test_edges_device_refusals(files, monkeypatch, capsys):
    """`edges --device cpu --shard` runs in a world of one and prints what
    `edges --device cpu` prints; a bare `--device` (with --shard too) asks
    for the card, which raises where there is none, before any game;
    without --sp nothing runs (exit 2)."""
    argv = ["edges", "--team-a", "Team A", "--team-b", "Team B", "--sp", files["sp"],
            "--artifacts", ART, "--spread", "1.5", "--mode", "analytic", "-n", "256"]
    got = _out(cli.main, argv + ["--shard", "--device", "cpu"], capsys)
    want = _out(cli.main, argv + ["--device", "cpu"], capsys)
    assert _untimed(got) == _untimed(want) and "Spread" in got

    def launched(*a, **k):
        raise AssertionError("a game was played")

    monkeypatch.setattr(api, "simulate_games", launched)
    monkeypatch.setattr(game, "simulate_games", launched)
    monkeypatch.setattr(mesh, "simulate_games", launched)
    if not torch.cuda.is_available():
        for extra in (["--device"], ["--device", "--shard"]):
            with pytest.raises(RuntimeError, match="never falls back to the CPU"):
                cli.main(argv + extra)
    assert cli.main(["edges", "--team-a", "A", "--team-b", "B", "--device", "cpu"]) == 2
    assert "needs --sp" in capsys.readouterr().err


def test_slate_props_prints_the_prop_table(files, capsys):
    """`slate --props --device cpu`: the slate's table, then the prop table
    of `api.simulate_slate_prop_rows` on the same arguments."""
    argv = ["slate", "--games", files["one"], "--sp", files["sp"], "--artifacts", ART,
            "--mode", "analytic", "-n", "64", "--props", files["props"], "--props-n", "256",
            "--focus", files["focus"], "--min-edge", "0", "--device", "cpu"]
    out = _out(cli.main, argv, capsys)
    rows = api.simulate_slate_prop_rows([("Team A", "Team B")], sp_path=files["sp"],
                                        props_csv=files["props"], n_pairs=256, mode="analytic",
                                        artifact_dir=ART, focus_csv=files["focus"],
                                        min_abs_edge_pct=0, device="cpu")
    from fast_monte_carlo_tpu_torch.edge import print_prop_table
    print_prop_table(rows)
    table = capsys.readouterr().out
    assert len(rows) == 33 and out.endswith(table) and "[Passing]" in table


def test_backtest_prints_a_well_formed_report(files, tmp_path, capsys):
    """`backtest --device cpu` over finals in both orientations and a tie:
    the report's header, win, margin, total and PIT lines; results without
    the score columns exit 2 before any game."""
    finals = tmp_path / "finals.csv"
    finals.write_text("team_a,team_b,score_a,score_b\nTeam B,Team A,20,27\n"
                      "Team 000,Team 001,17,17\nTeam 002,Team 003,35,10\n")
    out = _out(cli.main, ["backtest", "--results", str(finals), "--sp", files["sp"],
                          "--artifacts", ART, "--mode", "analytic", "-n", "256", "--bins", "4",
                          "--device", "cpu"], capsys)
    lines = out.strip().splitlines()
    assert lines[0] == "=== Backtest: 3 games (2 with a winner) ==="
    brier = float(re.search(r"brier (\S+)", lines[1]).group(1))
    assert 0 <= brier <= 1
    assert _line(out, "margin").strip().startswith("margin   : bias")
    assert _line(out, "total").strip().startswith("total    : bias")
    ks = [float(x) for x in re.findall(r"(?:margin|total) (\S+) \(mean", _line(out, "PIT"))]
    assert len(ks) == 2 and all(0 <= k <= 1 for k in ks)
    bad = tmp_path / "bad.csv"
    bad.write_text("team_a,team_b,pts\nTeam A,Team B,3\n")
    assert cli.main(["backtest", "--results", str(bad), "--sp", files["sp"],
                     "--device", "cpu"]) == 2
    assert "--results needs columns" in capsys.readouterr().out
