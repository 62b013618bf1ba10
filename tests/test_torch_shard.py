"""Trial sharding of the PyTorch port (`parallel/mesh.py`) on the CPU.

Ranks are child processes in a gloo group that meets through a FileStore
(`test_torch_support.run_ranks`).  A sharded run is held to the unsharded
run of the same key bit for bit: rank r plays global games r*n/W ..
(r+1)*n/W - 1 and draws their Philox rows (`philox_draws(row0=)`), and the
moments sum over the ranks as exact integers.  The same holds in a world of
one (no process group), in this process.  Against the JAX package's
8-device `MatchupRunner(shard=True)` (conftest's CPU mesh) the port's
2-rank run agrees within 4 standard errors: the JAX package folds a key per
device, so the two streams differ."""
import json
import time

import numpy as np
import pytest
import torch

from fast_monte_carlo_tpu_torch.ops import rng
from fast_monte_carlo_tpu_torch.parallel import mesh

from test_torch_support import jax_analytic_runner, jax_teams, run_ranks, within
from test_torch_support import table_cache_off  # noqa: F401 (autouse)

torch.set_num_threads(1)

# the cases, the runner each plays on and the games it checks: rank RANK of
# the group `tg` plays its shard; `check` holds the whole GameState to one
# unsharded simulate_games of the same key (on rank 0; every field equal)
CASES = ("table", "analytic", "exact", "antithetic", "slate")
CASE_CODE = '''
import dataclasses
import hashlib
import torch
from fast_monte_carlo_tpu_torch import fixtures
from fast_monte_carlo_tpu_torch.api import MatchupRunner, SlateRunner
from fast_monte_carlo_tpu_torch.config import SimConfig
from fast_monte_carlo_tpu_torch.ops.game import simulate_games
from fast_monte_carlo_tpu_torch.parallel import mesh
from fast_monte_carlo_tpu_torch.parallel.aggregate import score_moments

KEY = 0x5EED5EED12345678


def runner(case):
    cfg = SimConfig()
    if case == "antithetic":
        cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, antithetic=True))
    a, b = fixtures.teams()
    if case == "exact":
        return MatchupRunner(a, b, fixtures.heads(0), cfg, mode="exact", device="cpu")
    if case == "analytic":
        return MatchupRunner(a, b, None, cfg, mode="analytic", device="cpu")
    if case == "slate":
        matchups, tables = fixtures.slate(3, 8)
        return SlateRunner(matchups, nano_tables=tables, device="cpu")
    return MatchupRunner(a, b, None, cfg, mode="table", nano_tables=fixtures.nano_tables(7),
                         device="cpu")


def games(case):
    """(n, first_offense, game_id): 96 games; the slate's 3 matchups 32
    each, game ids with them; antithetic 128 (n / world a multiple of 4)."""
    n = 128 if case == "antithetic" else 96
    t = torch.arange(n, dtype=torch.int32)
    return n, t % 2, (t // 32 if case == "slate" else 0)


def digest(m):
    return hashlib.sha256(b"".join(f.cpu().numpy().tobytes() for f in m)).hexdigest()


def check(case, tg):
    r = runner(case)
    n, fo, gid = games(case)
    got = mesh.simulate_games_sharded(r.pack, r.cfg, r.heads_fn, r.heads_state, KEY, n, fo,
                                      tg, collect_players=case != "slate", game_id=gid)
    m = mesh.simulate_moments_sharded(r.pack, r.cfg, r.heads_fn, r.heads_state, KEY, n, fo,
                                      tg, game_id=gid)
    if tg.rank == 0:
        want = simulate_games(r.pack, r.cfg, r.heads_fn, r.heads_state, KEY, n, fo,
                              collect_players=case != "slate", game_id=gid)
        for f in want._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), (case, f)
        plain = simulate_games(r.pack, r.cfg, r.heads_fn, r.heads_state, KEY, n, fo,
                               collect_players=False, game_id=gid, collect_stats=False)
        assert all(torch.equal(x, y) for x, y in zip(m, score_moments(plain.score))), case
        assert int((got.sec > 0).sum()) == 0 and len(set(got.gid.tolist())) == (
            3 if case == "slate" else 1)
    return digest(m)
'''


def _ns() -> dict:
    ns = {}
    exec(CASE_CODE, ns)
    return ns


@pytest.mark.parametrize("case", CASES)
def test_world_of_one_equals_unsharded(case):
    """(i, ii) No process group: a world of one, where the sharded games
    and moments are the unsharded ones."""
    tg = mesh.trial_group("cpu")
    assert (tg.rank, tg.world, tg.group) == (0, 1, None)
    _ns()["check"](case, tg)


@pytest.mark.parametrize("cases", [("table", "analytic"), ("antithetic", "slate"), ("exact",)])
def test_two_ranks_equal_unsharded(cases, tmp_path):
    """(i, ii, vi) Over 2 gloo ranks every GameState field equals the
    unsharded run's, in table, analytic and exact mode, with antithetic
    draws and on a slate's game ids; the all-reduced moments equal
    score_moments of the unsharded scores and every rank holds the same
    ones; a rank imports neither jax, pandas, sklearn nor the JAX
    package."""
    code = CASE_CODE + (
        "import sys\n"
        "tg = mesh.trial_group('cpu')\n"
        "assert (tg.rank, tg.world, tg.backend) == (RANK, 2, 'gloo')\n"
        f"print(json.dumps([check(c, tg) for c in {cases!r}]))\n"
        "bad = [m for m in ('jax', 'pandas', 'sklearn', 'fast_monte_carlo_tpu')"
        " if m in sys.modules]\n"
        "assert not bad, bad\n")
    outs = run_ranks("import json\n" + code, 2, tmp_path)
    digests = [json.loads(o) for o in outs]
    assert digests[0] == digests[1] and len(digests[0]) == len(cases)


def test_runner_rounds_up_raises_and_runs_live(tmp_path):
    """(iii) Over 3 ranks, as the JAX package's shard=True does on its mesh:
    run_pairs raises where the world does not divide 2*n_pairs;
    run_pairs_summary rounds an odd chunk up to a multiple of the world
    (101 -> 102 pairs) and equals the unsharded summary of the rounded
    count bit for bit; run_live rounds its chunk likewise and equals the
    unsharded run_live; run_live_batch runs whole on each rank."""
    code = CASE_CODE + '''
import json
from fast_monte_carlo_tpu_torch.ops.game import Situation
r = runner("table")
rs = dataclasses.replace(r, shard=True)
assert rs.group.world == 3 and rs.group.rank == RANK
try:
    rs.run_pairs(1)
    raise AssertionError("run_pairs(1) ran over 3 ranks")
except ValueError as e:
    assert "n=2 not divisible by 3 ranks" in str(e)
got = rs.run_pairs_summary(101, seed=4, chunk_pairs=101)
assert float(got.n) == 204.0
q4 = Situation(offense=1, sec=300, down=2, dist=7.0, ytg=40.0, score_a=21, score_b=17)
live = rs.run_live(q4, n_games=500, seed=2, chunk_games=500)
assert float(live.n) == 501.0
if RANK == 0:
    want = r.run_pairs_summary(102, seed=4, chunk_pairs=102)
    assert all(torch.equal(x, y) or bool(torch.isnan(x).all() and torch.isnan(y).all())
               for x, y in zip(got, want))
    want = r.run_live(q4, n_games=501, seed=2, chunk_games=501)
    assert all(torch.equal(x, y) or bool(torch.isnan(x).all() and torch.isnan(y).all())
               for x, y in zip(live, want))
    batch = rs.run_live_batch([q4, q4._replace(sec=60)], n_games_per=64, seed=1)
    assert all(torch.equal(x, y) or bool(torch.isnan(x).all() and torch.isnan(y).all())
               for x, y in zip(batch, r.run_live_batch([q4, q4._replace(sec=60)],
                                                       n_games_per=64, seed=1)))
print(json.dumps([digest(got), digest(live)]))
'''
    outs = run_ranks(code, 3, tmp_path)
    assert len({o for o in outs}) == 1


SLATE_CODE = '''
import dataclasses
import hashlib
import json
import numpy as np
from fast_monte_carlo_tpu_torch import api, fixtures
from fast_monte_carlo_tpu_torch.config import SimConfig


def slate(g, anti):
    cfg = SimConfig()
    if anti:
        cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, antithetic=True))
    matchups, tables = fixtures.slate(g, 8)
    return matchups, tables, cfg


def slate_digest(per_game):
    return hashlib.sha256(b"".join(np.asarray(f).tobytes() for s in per_game
                                   for f in s)).hexdigest()
'''


@pytest.mark.parametrize("g,anti,chunk", [(4, False, 16), (5, False, 16), (5, True, 1),
                                          (6, True, 1)],
                         ids=["4", "5", "5-antithetic-odd-chunk", "6-antithetic-odd-chunk"])
def test_game_layout_over_two_ranks_equals_one_card(g, anti, chunk, tmp_path):
    """(iv) SlateRunner(game_shard=True) over 2 ranks equals the one-card
    run_summary_rows bit for bit, G = 5 too (blocks that do not divide),
    and under antithetic draws with an odd chunk, where a block's own game
    count would choose otherwise than the whole launch (G = 5: 10 games a
    launch, plain draws; G = 6: 12, antithetic, blocks of an even number
    of matchups).  Each rank built and holds only its block's tables;
    layout='auto' picks the game layout where there are several ranks and
    returns the same rows."""
    code = SLATE_CODE + f'''
from fast_monte_carlo_tpu_torch.parallel import mesh
matchups, tables, cfg = slate({g}, {anti})
sr = api.SlateRunner(matchups, None, cfg, nano_tables=tables, device="cpu", game_shard=True)
whole = api.SlateRunner(matchups, None, cfg, nano_tables=tables, device="cpu")
blk = -(-{g} // 2)
blk += blk % 2 if {anti} else 0
g0, g1 = min({g}, RANK * blk), min({g}, RANK * blk + blk)
assert sr.group.world == 2 and sr.block == (g0, g1) and whole.group.world == 1
assert sr.heads_state.nbytes * {g} == whole.heads_state.nbytes * (g1 - g0)
rows, per_game = sr.run_summary_rows(4, seed=3, chunk_pairs={chunk},
                                     mesh=mesh.game_group("cpu"))
games = [(a.name, b.name) for a, b in matchups]
auto, _ = api.simulate_slate_summary_rows(games, contexts=matchups, nano_tables=tables,
                                          cfg=cfg, n_pairs=4, chunk_pairs={chunk}, seed=3,
                                          device="cpu")
assert auto == rows
print(json.dumps([rows, slate_digest(per_game)]))
'''
    outs = run_ranks(code, 2, tmp_path)
    ns = {}
    exec(SLATE_CODE, ns)
    matchups, tables, cfg = ns["slate"](g, anti)
    from fast_monte_carlo_tpu_torch import api

    one = api.SlateRunner(matchups, None, cfg, nano_tables=tables, device="cpu",
                          game_shard=True)
    assert one.group.world == 1 and one.block == (0, g)
    rows, per_game = one.run_summary_rows(4, seed=3, chunk_pairs=chunk)
    assert outs[0] == outs[1]
    assert json.loads(outs[0]) == json.loads(json.dumps([rows, ns["slate_digest"](per_game)]))


def test_a_failure_on_one_rank_fails_every_rank(tmp_path):
    """A sharded launch that fails on rank 1 alone (a kernel that does not
    build, an out-of-memory) raises on both ranks, rank 0 saying how many
    ranks failed, instead of leaving rank 0 in the moments' all_reduce;
    the ranks go on to the next launch together.  Where rank 1's block of
    the game layout fails to build, every rank's layout='auto' takes the
    loop, which returns its rows."""
    code = CASE_CODE + SLATE_CODE + '''
from fast_monte_carlo_tpu_torch.parallel import mesh as mesh_mod
tg = mesh.trial_group("cpu")
r = runner("table")
n, fo, gid = games("table")
real = mesh_mod.simulate_games
if RANK == 1:
    def broken(*a, **k):
        raise RuntimeError("the card ran out of memory")
    mesh_mod.simulate_games = broken
try:
    mesh.simulate_moments_sharded(r.pack, r.cfg, r.heads_fn, r.heads_state, KEY, n, fo, tg)
    raise AssertionError("the launch passed")
except RuntimeError as e:
    assert str(e) == ("the card ran out of memory" if RANK else "1 of 2 ranks failed this call")
mesh_mod.simulate_games = real
after = digest(mesh.simulate_moments_sharded(r.pack, r.cfg, r.heads_fn, r.heads_state, KEY,
                                              n, fo, tg))
matchups, tables, cfg = slate(4, False)
if RANK == 1:
    api.pack_tables_multi = lambda *a, **k: (_ for _ in ()).throw(MemoryError("no room"))
games4 = [(a.name, b.name) for a, b in matchups]
auto, _ = api.simulate_slate_summary_rows(games4, contexts=matchups, nano_tables=tables,
                                          n_pairs=4, chunk_pairs=4, seed=3, device="cpu")
print(json.dumps([after, auto]))
'''
    outs = [json.loads(o) for o in run_ranks(code, 2, tmp_path)]
    assert outs[0] == outs[1]
    ns = _ns()
    exec(SLATE_CODE, ns)
    matchups, tables, _ = ns["slate"](4, False)
    from fast_monte_carlo_tpu_torch import api

    loop, _ = api.simulate_slate_summary_rows([(a.name, b.name) for a, b in matchups],
                                              contexts=matchups, nano_tables=tables, n_pairs=4,
                                              chunk_pairs=4, seed=3, device="cpu",
                                              layout="loop")
    assert outs[0][1] == json.loads(json.dumps(loop))


# a host set-up that fails on rank 1 alone, case by case: a sharded runner's
# table build, a route's heads, a slate route's sheet, a command's input file
SETUP_FAILURE_CODE = '''
import json
import time
from fast_monte_carlo_tpu_torch import api, cli, fixtures
from fast_monte_carlo_tpu_torch.ops import table_lookup

table_lookup.TABLE_CACHE_DIR = None
sheet = fixtures.write_sp_sheet(f"sp{RANK}.csv", 136, 0)
fixtures.write_csv(f"games{RANK}.csv", [{"team_a": "Team A", "team_b": "Team B"}],
                   ("team_a", "team_b"))
missing = "absent.csv" if RANK else sheet
route = dict(artifact_dir=fixtures.ARTIFACT_DIR, mode="analytic", shard=True, device="cpu")
q4 = api.situation_from_fields(ytg=40, quarter=4, clock="05:00")


def broken(what):
    def fail(*a, **k):
        raise RuntimeError(what)
    return fail


cases = {
    "runner build": (lambda: setattr(api, "build_table_heads", broken("table build failed")),
                     lambda: api.MatchupRunner(*fixtures.teams(), fixtures.heads(0),
                                               shard=True, device="cpu")),
    "route heads": (lambda: setattr(api, "load_heads", broken("no heads on this host")),
                    lambda: api.simulate_live_game("Team A", "Team B", q4,
                                                   sp_path=sheet, n_games=512, **route)),
    "slate sheet": (lambda: None,
                    lambda: api.simulate_slate_summary_rows(
                        [("Team A", "Team B")], sp_path=missing, n_pairs=256, **route)),
    "cli games file": (lambda: None,
                       lambda: cli.main(["season", "Team A", "--games",
                                         "absent.csv" if RANK else f"games{RANK}.csv",
                                         "--sp", sheet, "--artifacts", fixtures.ARTIFACT_DIR,
                                         "--mode", "analytic", "-n", "256", "--device", "cpu",
                                         "--shard"])),
}
real = {"build_table_heads": api.build_table_heads, "load_heads": api.load_heads}
out = []
for name, (breakit, call) in cases.items():
    if RANK == 1:
        breakit()
    t0 = time.perf_counter()
    try:
        call()
        got = "passed"
    except Exception as e:
        got = f"{type(e).__name__}: {e}"
    out.append([name, got, time.perf_counter() - t0])
    for k, v in real.items():
        setattr(api, k, v)
row, _ = api.simulate_live_game("Team A", "Team B", q4, sp_path=sheet, n_games=512, **route)
print(json.dumps([out, row]))
'''


def test_a_set_up_failure_on_one_rank_fails_every_rank(tmp_path):
    """A host set-up that raises on rank 1 alone, before any launch (a
    sharded runner's table build, a route's heads, a slate route's SP+
    sheet, a command's games file), raises on both ranks within seconds:
    rank 1 its own error, rank 0 that 1 of 2 ranks failed.  No rank waits
    in a collective for the group's timeout, and the ranks go on together
    (a sharded live query after them equal on both)."""
    t0 = time.perf_counter()
    outs = [json.loads(o) for o in run_ranks(SETUP_FAILURE_CODE, 2, tmp_path, timeout=30)]
    assert time.perf_counter() - t0 < 30
    want = {"runner build": "RuntimeError: table build failed",
            "route heads": "RuntimeError: no heads on this host",
            "slate sheet": "FileNotFoundError",
            "cli games file": "FileNotFoundError"}
    for rank, (cases, _) in enumerate(outs):
        assert [c[0] for c in cases] == list(want)
        for name, got, secs in cases:
            assert got.startswith(want[name] if rank else
                                  "RuntimeError: 1 of 2 ranks failed this call"), (rank, got)
            assert secs < 10, (rank, name, secs)
    assert outs[0][1] == outs[1][1]


def test_two_rank_runs_agree_with_jax_sharded_within_mc_error(tmp_path):
    """(v) The port's 2-rank run_pairs_summary against the JAX package's
    MatchupRunner(shard=True) on its 8-device CPU mesh, on the fixture
    teams in analytic mode: win rates and mean points within 4 standard
    errors of the difference (the streams differ: JAX folds a key per
    device)."""
    n = 4096
    code = f'''
import json
from fast_monte_carlo_tpu_torch import fixtures
from fast_monte_carlo_tpu_torch.api import MatchupRunner
from fast_monte_carlo_tpu_torch.config import SimConfig
r = MatchupRunner(*fixtures.teams(), None, SimConfig(), mode="analytic", device="cpu",
                  shard=True)
s = r.run_pairs_summary({n // 2}, seed=11, chunk_pairs=1024)
print(json.dumps({{"win": s.win_rate.tolist(), "mean": s.mean_pts.tolist(),
                  "sd": s.sd_pts.tolist(), "n": float(s.n)}}))
'''
    port = json.loads(run_ranks(code, 2, tmp_path)[0])
    import jax

    from fast_monte_carlo_tpu.api import MatchupRunner as JaxRunner

    assert jax.device_count() == 8
    jr = jax_analytic_runner()
    want = JaxRunner(*jax_teams(), None, jr.cfg, mode="analytic", shard=True).run_pairs_summary(
        n // 2, seed=11, chunk_pairs=1024)
    assert port["n"] == float(want.n) == n
    for i in (0, 1):
        w = float(np.asarray(want.win_rate)[i])
        assert within(port["win"][i], w, w, n), (i, port, want)
        sd = float(np.asarray(want.sd_pts)[i])
        assert abs(port["mean"][i] - float(np.asarray(want.mean_pts)[i])) <= \
            4 * sd * np.sqrt(2 / n), (i, port, want)


def test_server_of_two_ranks_answers_sharded_requests(tmp_path):
    """The resident server over 2 gloo ranks: rank 0 answers HTTP, rank 1
    follows it (`SimService.follow`), running each call rank 0 sends; a
    sharded /sim and /live answer 200 with what their unsharded requests
    answer; a call that fails on rank 1 alone answers 500 and the server
    goes on; closing rank 0 releases rank 1."""
    code = '''
import json, threading, urllib.error, urllib.request
from fast_monte_carlo_tpu_torch import fixtures, serve
sp = fixtures.write_sp_sheet("sp.csv", 136, 0) if RANK == 0 else None
obj = [sp]
dist.broadcast_object_list(obj, src=0)
svc = serve.SimService(serve.ServeConfig(sp_path=obj[0], artifact_dir=fixtures.ARTIFACT_DIR,
                                         mode="analytic", device="cpu"))
assert svc.rank == RANK and svc.group.world == 2
if RANK == 1:
    from fast_monte_carlo_tpu_torch import api
    api.evaluate_fourth_down = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("rank 1's card ran out of memory"))
    svc.follow()
else:
    srv = serve.make_server(svc, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(path, body):
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            return {k: v for k, v in json.loads(r.read()).items() if k != "elapsed_s"}

    ab = {"team_a": "Team A", "team_b": "Team B"}
    try:
        post("/fourth", {**ab, "offense": "A", "quarter": 4, "clock": "07:00", "down": 4,
                         "dist": 2, "ytg": 35, "score_a": 14, "score_b": 10, "n_games": 64})
        raise AssertionError("/fourth answered although rank 1 failed")
    except urllib.error.HTTPError as e:
        assert e.code == 500 and "1 of 2 ranks failed" in e.read().decode()
    live = {**ab, "offense": "B", "quarter": 4, "clock": "07:00", "down": 2, "dist": 7,
            "ytg": 35, "score_a": 14, "score_b": 10, "n_games": 256}
    for path, body in (("/sim", {**ab, "n_pairs": 128, "spread": -3.5}), ("/live", live)):
        got, want = post(path, {**body, "shard": True}), post(path, {**body, "shard": False})
        assert got == want, (path, got, want)
    print(json.dumps(got))
    srv.shutdown()
    svc.close()
'''
    outs = run_ranks(code, 2, tmp_path)
    assert outs[1] == "" and json.loads(outs[0])["live"]["n_games"] == 256


@pytest.mark.parametrize("row0", [0, 1, 255, 4093])
def test_philox_row_offset_draws_the_rows_of_a_wider_launch(row0):
    """philox_draws(row0=r) draws rows r.. of a launch from row 0: the plain
    version and the CPU wrapper, whole chunks and single steps."""
    key, ch, n = rng.fold_in(rng.root_key(3), 7), 3, 300
    wide_u, wide_z = rng.philox_draws_reference(key, 24, ch, row0 + n, "cpu")
    u, z = rng.philox_draws_reference(key, 24, ch, n, "cpu", row0=row0)
    assert torch.equal(u, wide_u[:, row0:]) and torch.equal(z, wide_z[:, row0:])
    cu, cz = rng.chunk_draws(key, 24, ch, n, "cpu", row0=row0)
    assert torch.equal(cu, u) and torch.equal(cz, z)
    su, sz = rng.step_draws(key, 25, n, "cpu", row0=row0)
    assert torch.equal(su, u[1]) and torch.equal(sz, z[1])
    with pytest.raises(ValueError, match="row counter"):
        rng.philox_draws(key, 0, 1, 8, "cpu", row0=2 ** 32 - 4)


def test_trial_group_devices_and_spans(monkeypatch):
    """A world of one outside any group (JAX's mesh of one); a rank's
    default card is cuda:{LOCAL_RANK}, which must exist (no CPU instead);
    n must divide over the world, each rank taking a contiguous block."""
    tg = mesh.trial_group("cpu")
    assert tg.backend is None and mesh.shard_span(10, tg) == (0, 10)
    three = mesh.TrialGroup(2, 3, None, torch.device("cpu"))
    assert mesh.shard_span(12, three) == (8, 12)
    with pytest.raises(ValueError, match="not divisible by 3 ranks"):
        mesh.shard_span(10, three)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="never falls back to the CPU"):
            mesh.trial_group()
        with pytest.raises(RuntimeError, match="never falls back to the CPU"):
            mesh._rank_device("cuda", 1)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert mesh.world_size() == 4 and mesh.process_rank() == 2
