"""The port's command line (`python -m fast_monte_carlo_tpu_torch.cli`) on the
CPU (`--device cpu`, analytic mode), held to the JAX package's CLI on the
same SP+ sheet (`fixtures.write_sp_sheet`) and trained-head fixture
directory: every ported subcommand prints the JAX command's lines once the
numbers are masked, and its numbers agree within Monte-Carlo error (the two
packages draw different streams).  The JAX CLI runs with its scan unrolled
once, which shapes only XLA's loop, so that its programs compile in
seconds.  The subcommands not ported raise NotImplementedError naming their
ROADMAP.md queue item before any game is played; `serve` binds and answers
/health."""
import dataclasses
import json
import math
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

from test_torch_support import jax_readable_copy, within

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
    return {"sp": fixtures.write_sp_sheet(d / "sp.csv", 136, 0), "games": str(games),
            "one": str(one), "lines": str(lines),
            "jart": jax_readable_copy(ART, d / "jart"), "dir": d}


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


NOT_PORTED = {
    "edges": (["edges", "--team-a", "A", "--team-b", "B"], "queue 1 item 2"),
    "edges --device": (["edges", "--team-a", "A", "--team-b", "B", "--device"],
                       "queue 1 item 2"),
    "prop": (["prop", "Team A", "P", "pass_yds", "200.5"], "queue 1 item 2"),
    "backtest": (["backtest", "--results", "r.csv", "--sp", "SP"], "queue 1 item 5"),
    "bench": (["bench"], "queue 1 item 1"),
    "train": (["train", "--data", "d.csv", "--out", "o"], "outside the port's scope"),
    "slate --props": (["slate", "--games", "GAMES", "--sp", "SP", "--props", "p.csv"],
                      "queue 1 item 2"),
    "slate --shard trial": (["slate", "--games", "GAMES", "--sp", "SP", "--shard", "trial"],
                            "queue 1 item 6"),
    "sim --shard": (["sim", "Team A", "Team B", "--sp", "SP", "--shard"], "queue 1 item 6"),
    "live --shard": (["live", "Team A", "Team B", "--sp", "SP", "--ytg", "40", "--shard"],
                     "queue 1 item 6"),
    "parlay --shard": (["parlay", "Team A", "Team B", "--sp", "SP", "--legs", LEGS,
                        "--shard"], "queue 1 item 6"),
    "season --shard": (["season", "Team A", "--opponents", "Team B", "--sp", "SP",
                        "--shard"], "queue 1 item 6"),
    "serve --shard": (["serve", "--sp", "SP", "--shard"], "queue 1 item 6"),
    "sim --sd-mode cachewarm": (["sim", "Team A", "Team B", "--sp", "SP", "--sd-mode",
                                 "cachewarm"], "queue 1 item 4"),
}


@pytest.mark.parametrize("name", list(NOT_PORTED))
def test_unported_subcommands_raise_before_any_game(name, files, monkeypatch):
    def launched(*a, **k):
        raise AssertionError("a game was played")

    monkeypatch.setattr(api, "simulate_games", launched)
    monkeypatch.setattr(game, "simulate_games", launched)
    argv, item = NOT_PORTED[name]
    argv = [{"SP": files["sp"], "GAMES": files["games"]}.get(a, a) for a in argv]
    with pytest.raises(NotImplementedError, match=re.escape(item)):
        cli.main(argv + (["--device", "cpu"] if name.split()[0] not in
                         ("edges", "prop", "backtest", "bench", "train") else []))


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
    printer prints pandas' cells and columns (spacing aside)."""
    assert cli._read_games(files["games"]) == [
        tuple(r) for r in pd.read_csv(files["games"]).iloc[:, :2].itertuples(index=False)]
    got = cli._read_rows(files["lines"])
    want = pd.read_csv(files["lines"]).to_dict("records")
    assert [list(r) for r in got] == [list(r) for r in want]
    assert serve.jsonable(got) == serve.jsonable(want)
    rows = [{"team": "Team A", "x": 42.71875, "y": 1.0, "n": 3, "s": "a"},
            {"team": "T", "x": 40.875, "y": np.nan, "n": 4, "z": 0.25}]
    df = pd.DataFrame(rows)
    assert cli._rows_text(rows).split() == df.to_string(index=False).split()
    ix = df.set_index("team")
    text = cli._frame_text({c: ix[c].tolist() for c in ix.columns}, index=ix.index,
                           index_name="team")
    assert [x.split() for x in text.splitlines()] == [x.split() for x in str(ix).splitlines()]
