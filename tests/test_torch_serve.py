"""The port's resident HTTP server (`fast_monte_carlo_tpu_torch/serve.py`) on
the CPU, through a real ThreadingHTTPServer on a loopback port.

The cases of `tests/test_serve.py` on the fixture SP+ sheet
(`fixtures.write_sp_sheet`, 136 teams) and the trained-head fixture directory
(`fixtures.ARTIFACT_DIR`), mostly in analytic mode at a few hundred pairs;
one table-mode server on the fixture heads.  Against the JAX package's
server on the same sheet: the same response keys, recursively, win
probabilities and means within Monte-Carlo error (the two packages draw
different streams), and the pricing fields equal given the same summary.
Coalesced /sim answers equal solo ones bit for bit, and a server response
equals the direct `api` call."""
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fast_monte_carlo_tpu_torch import api, fixtures
from fast_monte_carlo_tpu_torch.edge import (alt_line_rows_from_summary,
                                             market_odds_from_summary, summary_moneyline)
from fast_monte_carlo_tpu_torch.serve import (ServeConfig, SimService, _frame_records,
                                              jsonable, make_server)

from test_torch_support import jax_readable_copy, within, write_focus
from test_torch_support import table_cache_off  # noqa: F401 (autouse)

torch.set_num_threads(1)

ART = fixtures.ARTIFACT_DIR
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AB = {"team_a": "Team A", "team_b": "Team B"}
Q4 = {**AB, "offense": "B", "quarter": 4, "clock": "07:00", "down": 2, "dist": 7, "ytg": 35,
      "score_a": 21, "score_b": 17}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    return {"sp": fixtures.write_sp_sheet(d / "sp.csv", 136, 0),
            "focus": str(write_focus(d / "focus.csv")), "dir": d}


def _start(cfg):
    service = SimService(cfg)
    srv = make_server(service, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}", service


def _stop(srv):
    srv.shutdown()
    srv.server_close()


def _cfg(files, **kw):
    return ServeConfig(**{**dict(sp_path=files["sp"], artifact_dir=ART, mode="analytic",
                                 max_n_pairs=4096, max_games=2, device="cpu"), **kw})


@pytest.fixture(scope="module")
def server(files):
    srv, base, service = _start(_cfg(files))
    yield base, service
    _stop(srv)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _bare(out):
    """A response without its own timing."""
    return {k: v for k, v in out.items() if k != "elapsed_s"}


def test_health(server):
    base, _ = server
    code, out = _get(base + "/health")
    assert code == 200
    assert out["status"] == "ok"
    assert out["platform"] == "cpu" and out["device_count"] == 0
    assert out["device_name"] == "cpu"
    assert out["config"]["mode"] == "analytic" and out["config"]["device"] == "cpu"
    assert out["config"]["aot_dir"] is None


def test_cuda_service_raises_at_construction_without_a_card(files):
    """A service asked for the card fails when it is built, not at its
    first request, where CUDA is absent; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="never falls back to the CPU"):
        SimService(_cfg(files, device="cuda"))


def test_sim_with_markets(server):
    base, _ = server
    code, out = _post(base + "/sim", {**AB, "n_pairs": 256, "spread": -3.5, "total": 55.5})
    assert code == 200, out
    s = out["summary"]
    assert s["team_a"] == "Team A" and s["n_games"] == 512
    assert 0.0 < s["win_a"] < 1.0
    ml = out["moneyline"]
    assert ml["team"]["p_win"] + ml["opp"]["p_win"] <= 1.0 + 1e-9
    mk = out["markets"]
    assert {"spread", "total"} <= set(mk)
    assert isinstance(mk["spread"], dict) and isinstance(mk["total"], dict)


def test_sim_alt_ladders(server):
    base, _ = server
    code, out = _post(base + "/sim", {**AB, "n_pairs": 256, "spread": -3.5, "total": 55.5,
                                      "alt": {"width": 3, "step": 1}})
    assert code == 200, out
    alt = out["alt"]
    assert {"spread", "total"} <= set(alt)
    assert len(alt["spread"]) == 7 and len(alt["total"]) == 7
    mk = out["markets"]
    mid = next(r for r in alt["spread"] if r["spread"] == -3.5)
    assert mid["p_cover"] == pytest.approx(mk["spread"]["p_cover"])
    covers = [r["p_cover"] for r in alt["spread"]]
    assert covers == sorted(covers)  # more points = easier cover


def test_sim_alt_ladder_cap_is_400(server):
    base, _ = server
    code, out = _post(base + "/sim", {**AB, "n_pairs": 256, "spread": -3.5,
                                      "alt": {"width": 500, "step": 0.5}})
    assert code == 400
    assert "capped" in out["error"]


def test_slate_with_lines(server):
    """Lines for one game of two: both market rows carry every column, the
    unpriced game's lines null, as the JAX module's DataFrame records."""
    base, _ = server
    code, out = _post(base + "/slate", {
        "games": [["Team A", "Team B"], ["Team 000", "Team 001"]], "n_pairs": 256,
        "lines": [{"team_a": "Team A", "spread": -3.5, "total": 55.5}]})
    assert code == 200, out
    assert len(out["summaries"]) == 2 and len(out["markets"]) == 2
    row, other = out["markets"]
    assert row["team_a"] == "Team A" and np.isfinite(row["p_win_a"])
    assert list(other) == list(row) and other["spread"] is None and other["total_bet"] is None
    assert out["elapsed_s"] > 0


def test_warm_state_reused_across_requests(server):
    """Repeat requests hit the warm path: the runner built for a matchup
    serves the next request on it, and the heads loaded for a live query
    stay in their memo.  (An analytic slate reads no heads, where the JAX
    package loads them anyway.)"""
    base, service = server
    _post(base + "/sim", {**AB, "n_pairs": 256})
    runners = dict(api._RUNNER_MEMO)
    _post(base + "/sim", {**AB, "n_pairs": 256, "seed": 1})
    assert api._RUNNER_MEMO == runners
    _post(base + "/live", {**Q4, "n_games": 64})
    code, h = _get(base + "/health")
    assert code == 200
    assert h["heads_memo"] >= 1
    assert h["requests"] >= 3
    assert service._requests == h["requests"]


def test_props_inline_rows(files):
    """The fixture prop sheet as JSON rows on a server with the focus
    rosters: every resolvable row priced, equal to the direct call."""
    srv, base, _ = _start(_cfg(files, focus_csv=files["focus"]))
    try:
        props = fixtures.prop_rows(4)
        code, out = _post(base + "/props", {"games": [["Team A", "Team B"]], "n_pairs": 64,
                                            "seed": 3, "props": props})
        assert code == 200, out
        assert len(out["props"]) == 33
        want = api.simulate_slate_prop_rows(
            [("Team A", "Team B")], props_csv=props, sp_path=files["sp"], artifact_dir=ART,
            focus_csv=files["focus"], n_pairs=64, seed=3, min_abs_edge_pct=0.0,
            mode="analytic", device="cpu")
        assert out["props"] == jsonable(_frame_records(want))
    finally:
        _stop(srv)


def test_live_endpoint(server):
    base, _ = server
    body = {**Q4, "n_games": 512, "spread": -3.5, "total": 55.5}
    code, out = _post(base + "/live", body)
    assert code == 200, out
    row = out["live"]
    assert row["n_games"] == 512
    assert row["offense"] == 1 and row["sec"] == 7 * 60
    assert 0.0 <= row["win_a"] <= 1.0
    assert row["mean_a"] >= 21.0 and row["mean_b"] >= 17.0
    assert {"spread", "total"} <= set(out["markets"])
    assert out["moneyline"]["team"]["name"] == "Team A"
    code, out2 = _post(base + "/live", {**body, "sec": 420})
    assert code == 200 and out2["live"]["sec"] == 420
    for bad in ({"offense": "C"}, {"quarter": 5, "clock": "1:00"},
                {"n_games": 10**9}, {"ytg": 0}):
        code, err = _post(base + "/live", {**body, **bad})
        assert code == 400, (bad, err)


def test_parlay_endpoint(server):
    base, _ = server
    body = {**AB, "n_pairs": 256, "price": 260,
            "legs": [{"kind": "moneyline", "team": "Team A"},
                     {"kind": "total", "side": "over", "line": 39.5}]}
    code, out = _post(base + "/parlay", {**body, "correlations": True})
    assert code == 200, out
    res = out["parlay"]
    assert res["n"] == 512
    assert len(res["leg_corr"]) == 2 and set(res["leg_corr"][0]) == {"Team A ML", "Over 39.5"}
    assert 0.0 <= res["p_all_win"] <= min(leg["p_win"] for leg in res["legs"]) + 1e-9
    assert {"fair_american", "correlation_mult", "ev_$100"} <= set(res)
    for bad_legs in ([], [{"kind": "moneyline", "team": "Team A"}] * 21,
                     [{"kind": "moneyline", "team": "Team 005"}],
                     [{"kind": "teaser", "team": "Team A"}],
                     ["moneyline"]):
        code, err = _post(base + "/parlay", {**body, "legs": bad_legs})
        assert code == 400, (bad_legs, err)
    code, out = _post(base + "/parlay", {**body, "round_robin": [1, 2]})
    assert code == 200, out
    rr = out["parlay"]["round_robin"]
    assert rr["n_tickets"] == 3 and rr["by"] == [1, 2]
    assert all("ev_$100" in t for t in rr["tickets"])
    for bad_rr in ("2", [0], [9], True, [2.5], [], [2, True]):
        code, err = _post(base + "/parlay", {**body, "round_robin": bad_rr})
        assert code == 400, (bad_rr, err)


def test_season_endpoint(server):
    base, _ = server
    body = {"team": "Team A", "opponents": ["Team B", "Team 000"], "n_pairs": 256,
            "line": 1.5}
    code, out = _post(base + "/season", body)
    assert code == 200, out
    res = out["season"]
    assert res["games"] == 2 and len(res["pmf"]) == 3
    # each of the pmf's entries is rounded to 6 places
    assert abs(sum(res["pmf"]) - 1.0) <= len(res["pmf"]) * 5e-7 + 1e-12
    assert res["p_at_least"][0] == 1.0
    assert {"p_over", "p_under", "american_over", "best"} <= set(res)
    assert len(res["schedule"]) == 2
    assert [r["p_win_team"] for r in res["schedule"]] == res["p_wins"]
    code, err = _post(base + "/season", {"opponents": ["Team B"]})
    assert code == 400 and "team" in err["error"]
    code, err = _post(base + "/season", {"team": "Team A"})
    assert code == 400
    code, err = _post(base + "/season", {**body, "games": [["Team A", "Team B"]]})
    assert code == 400
    code, err = _post(base + "/season", {**body, "opponents": ["a", "b", "c"]})
    assert code == 400 and "opponents" in err["error"]
    code, err = _post(base + "/season", {"team": "Team A", "n_pairs": 64,
                                         "games": [["Team 000", "Team 001"]]})
    assert code == 400 and "include" in err["error"]


def test_bad_body_and_unknown_route(server):
    base, _ = server
    code, out = _post(base + "/slate", {"n_pairs": 64})  # missing games
    assert code == 400 and "error" in out
    code, out = _post(base + "/nope", {})
    assert code == 404
    req = urllib.request.Request(base + "/sim", data=b"[1, 2]", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400 and "JSON object" in json.loads(e.value.read())["error"]
    code, out = _post(base + "/sim", {**AB, "n_pairs": 10**9})
    assert code == 400 and "n_pairs" in out["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/metrics", timeout=60)
    assert e.value.code == 404


def test_request_cost_guards(server):
    base, _ = server
    code, out = _post(base + "/sim", {**AB, "n_pairs": 64, "mode": "exact"})
    assert code == 400 and "mode" in out["error"]
    code, out = _post(base + "/slate", {"games": [["A", "B"], ["C", "D"], ["E", "F"]],
                                        "n_pairs": 64})
    assert code == 400 and "games list" in out["error"]


@pytest.mark.parametrize("route", ["/sim", "/slate", "/live", "/season", "/parlay"])
def test_shard_requests_raise_not_ported(server, route):
    """shard=true, which raised before trial sharding was ported, now runs
    the sharded route in the server's world of one (no process group) and
    answers 200 with what "shard": false answers, bit for bit."""
    base, _ = server
    body = {"/sim": AB, "/slate": {"games": [["Team A", "Team B"]]},
            "/live": {**Q4, "n_games": 64}, "/season": {"team": "Team A",
                                                        "opponents": ["Team B"]},
            "/parlay": {**AB, "legs": [{"kind": "moneyline", "team": "Team A"}]}}[route]
    answers = []
    for shard in (True, False):
        code, out = _post(base + route, {**body, "n_pairs": 64, "shard": shard})
        assert code == 200, out
        answers.append(_bare(out))
    assert answers[0] == answers[1]


def test_concurrent_requests_serialize_cleanly(server):
    import concurrent.futures as cf

    base, _ = server
    body = {**AB, "n_pairs": 128}
    with cf.ThreadPoolExecutor(4) as ex:
        outs = list(ex.map(lambda i: _post(base + "/sim", {**body, "seed": i}), range(4)))
    for code, out in outs:
        assert code == 200
        assert 0.0 < out["summary"]["win_a"] < 1.0


def test_warm_precompiles(server):
    _, service = server
    out = service.warm([("Team A", "Team B")], n_pairs=32)
    assert out["heads"] == "loaded"
    assert "1 matchups" in out["compiled"]


def test_jsonable_handles_numpy_and_nan():
    """numpy scalars, NaN and inf as the JAX module's jsonable converts
    them; rows laid out as a DataFrame's records, as its jsonable gives a
    DataFrame."""
    import pandas as pd

    from fast_monte_carlo_tpu.serve import jsonable as jax_jsonable

    out = jsonable({"a": np.float32(1.5), "b": np.int64(2),
                    "c": float("nan"), "d": np.array([1.0, 2.0]).tolist(),
                    "f": [np.float64(np.inf), 3.0], "g": (np.int32(4),)})
    assert out == {"a": 1.5, "b": 2, "c": None, "d": [1.0, 2.0], "f": [None, 3.0], "g": [4]}
    json.dumps(out)
    rows = [{"x": 1, "y": "a"}, {"x": 2, "z": 0.5}, {"y": "b", "x": np.int64(3)}]
    assert jsonable(_frame_records(rows)) == jax_jsonable(pd.DataFrame(rows))


def test_live_curve_endpoint(server):
    base, _ = server
    body = {**AB, "n_games_per": 256,
            "situations": [
                {"offense": "A", "sec": 2400, "ytg": 75, "score_a": 7, "score_b": 7},
                {"offense": "B", "quarter": 4, "clock": "05:00", "down": 3,
                 "dist": 4, "ytg": 55, "score_a": 14, "score_b": 17}]}
    code, out = _post(base + "/live", body)
    assert code == 200, out
    curve = out["curve"]
    assert len(curve) == 2
    assert curve[0]["sec"] == 2400 and curve[1]["sec"] == 300
    for row in curve:
        assert row["n_games"] == 256
        assert 0.0 <= row["win_a"] <= 1.0
    for bad in ({"situations": []},
                {"situations": body["situations"], "n_games_per": 10**8}):
        code, err = _post(base + "/live", {**body, **bad})
        assert code == 400, (bad, err)


def test_fourth_endpoint(server):
    base, _ = server
    body = {**AB, "offense": "A", "quarter": 4, "clock": "04:00", "dist": 2, "ytg": 30,
            "score_a": 20, "score_b": 21, "n_games": 512}
    code, out = _post(base + "/fourth", body)
    assert code == 200, out
    res = out["fourth"]
    assert set(res["choices"]) == {"policy", "go", "fg", "punt"}
    assert res["best"] in ("go", "fg", "punt")
    assert res["situation"]["down"] == 4
    for bad in ({"down": 2}, {"n_games": 10**9}):
        code, err = _post(base + "/fourth", {**body, **bad})
        assert code == 400, (bad, err)


def test_deadline_guard_and_latency(files):
    srv, base, service = _start(_cfg(files, deadline_s=0.2))
    try:
        body = {**AB, "n_pairs": 64}
        code, out = _post(base + "/sim", body)
        assert code == 200, out
        n_ok = service._requests
        with service._lock:   # a long-running device request
            t0 = time.perf_counter()
            code, err = _post(base + "/sim", body)
            waited = time.perf_counter() - t0
        assert code == 503 and "deadline" in err["error"]
        assert 0.15 <= waited < 5.0          # shed at ~deadline, not hang
        assert service._requests == n_ok     # shed before device work
        code, h = _get(base + "/health")
        assert code == 200
        lat = h["latency"]["sim"]
        assert lat["n"] == 1                 # only the completed request
        assert lat["p95_ms"] >= lat["p50_ms"] > 0
    finally:
        _stop(srv)


def _wait_for_waiters(service, n, timeout=30.0):
    t0 = time.perf_counter()
    got = 0
    while time.perf_counter() - t0 < timeout:
        with service._batch_lock:
            got = sum(it.waiters for b in service._sim_batches.values()
                      for it in b.items.values())
        if got >= n:
            return got
        time.sleep(0.02)
    raise AssertionError(f"only {got}/{n} requests registered")


def _held_posts(base, service, bodies):
    """`bodies` posted to /sim concurrently while the device lock is held;
    released once all registered in open batches.  Returns the answers."""
    outs = [None] * len(bodies)

    def go(i):
        outs[i] = _post(base + "/sim", bodies[i])

    service._lock.acquire()
    held = True
    try:
        ts = [threading.Thread(target=go, args=(i,)) for i in range(len(bodies))]
        for t in ts:
            t.start()
        _wait_for_waiters(service, len(bodies))
        service._lock.release()
        held = False
        for t in ts:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        if held:
            service._lock.release()
    return outs


def _counted_slates(monkeypatch):
    calls = []
    real = api.simulate_slate_summary_rows

    def counted(games, *a, **k):
        calls.append(tuple(games))
        return real(games, *a, **k)

    monkeypatch.setattr(api, "simulate_slate_summary_rows", counted)
    return calls


def test_sim_coalescing_identical_requests(server, monkeypatch):
    """Four identical /sim requests queued behind the lock share ONE launch,
    and the shared answer equals the solo answer bitwise."""
    base, service = server
    calls = _counted_slates(monkeypatch)
    body = {**AB, "n_pairs": 128, "seed": 77, "spread": -2.5}
    before = service._coalesced
    outs = _held_posts(base, service, [body] * 4)
    assert [o[0] for o in outs] == [200] * 4, outs
    assert calls == [(("Team A", "Team B"),)]
    code, solo = _post(base + "/sim", body)
    assert code == 200 and all(_bare(o[1]) == _bare(solo) for o in outs)
    _, h = _get(base + "/health")
    assert h["coalesced"] - before >= 3


def test_sim_coalescing_distinct_matchups_equal_solo(server, monkeypatch):
    """Distinct matchups queued in one (n, mode, shard, seed) group: each
    answered as a slate of one under the solo request's key, so every
    coalesced answer equals its solo answer bitwise (all fields but
    elapsed_s), whatever else was in flight.  The JAX module keys matchup
    gi of the batch by its position instead (serve.py:438-456): that
    answer differs."""
    base, service = server
    calls = _counted_slates(monkeypatch)
    games = [("Team A", "Team B"), ("Team 000", "Team 001"), ("Team 002", "Team 003"),
             ("Team 001", "Team 000")]
    bodies = [{"team_a": a, "team_b": b, "n_pairs": 128, "seed": 78, "total": 41.5}
              for a, b in games]
    before = service._coalesced
    outs = _held_posts(base, service, bodies)
    assert [o[0] for o in outs] == [200] * 4, outs
    assert sorted(calls) == sorted((g,) for g in games)   # one slate of one each
    _, h = _get(base + "/health")
    assert h["coalesced"] - before >= 3
    for body, (_, out) in zip(bodies, outs):
        code, solo = _post(base + "/sim", body)
        assert code == 200 and _bare(out) == _bare(solo), body
        assert out["summary"]["team_a"] == body["team_a"]
    rows, _ = api.simulate_slate_summary_rows(games, sp_path=service.cfg.sp_path,
                                              artifact_dir=ART, n_pairs=128, seed=78,
                                              mode="analytic", device="cpu")
    assert jsonable(rows[1]) != outs[1][1]["summary"]


def test_stress_every_request_counted_once(files):
    """24 threads (more than the cores) post /sim and /live bodies over 3
    distinct ones each, with the interpreter switching threads every
    microsecond: every request is answered, each answer equals its body's
    solo answer, and each was counted once, as a device admission or as
    an answer shared from another's launch (a lost update of either
    count breaks the sum)."""
    srv, base, service = _start(_cfg(files))
    bodies = [("/sim", {**AB, "n_pairs": 64, "seed": 200 + i % 3}) if i % 2 else
              ("/live", {**Q4, "n_games": 64, "seed": 300 + i % 3}) for i in range(24)]
    outs = [None] * len(bodies)

    def go(i):
        outs[i] = _post(base + bodies[i][0], bodies[i][1])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=go, args=(i,)) for i in range(len(bodies))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    try:
        assert [o[0] for o in outs] == [200] * len(bodies), outs
        assert service._requests + service._coalesced == len(bodies)
        with service._lat_lock:
            assert sum(len(r) for r in service._latency.values()) == len(bodies)
        for (path, body), (_, out) in zip(bodies, outs):
            code, solo = _post(base + path, body)
            assert code == 200 and _bare(out) == _bare(solo), (path, body)
    finally:
        _stop(srv)


def test_sim_batch_bad_matchup_fails_alone(server):
    base, service = server
    bodies = [{**AB, "n_pairs": 128, "seed": 79},
              {"team_a": "Nowhere University", "team_b": "Team B", "n_pairs": 128,
               "seed": 79}]
    outs = _held_posts(base, service, bodies)
    by_team = {b["team_a"]: o for b, o in zip(bodies, outs)}
    assert by_team["Team A"][0] == 200, by_team
    assert by_team["Nowhere University"][0] == 400
    assert "no SP+ row matches" in by_team["Nowhere University"][1]["error"]


def test_sim_coalescing_deadline_sheds_followers(files):
    srv, base, service = _start(_cfg(files, deadline_s=0.6, max_games=80))
    try:
        body = {**AB, "n_pairs": 64}
        outs = [None] * 2

        def go(i):
            outs[i] = _post(base + "/sim", body)

        service._lock.acquire()
        try:
            ts = [threading.Thread(target=go, args=(i,)) for i in range(2)]
            for t in ts:
                t.start()
            _wait_for_waiters(service, 2)
            time.sleep(1.0)    # past the 0.6s deadline
        finally:
            service._lock.release()
        for t in ts:
            t.join(timeout=60)
        assert [o[0] for o in outs] == [503, 503], outs
        code, out = _post(base + "/sim", body)   # lock free: serves again
        assert code == 200, out
    finally:
        _stop(srv)


def test_sim_calibration_body_field(server):
    base, _ = server
    body = {**AB, "n_pairs": 256, "spread": -3.5, "total": 44.5, "seed": 5}
    code, plain = _post(base + "/sim", body)
    assert code == 200, plain
    code, calib = _post(base + "/sim", {**body, "calibration": {"total_shift": -10.0}})
    assert code == 200, calib
    assert calib["markets"]["total"]["mean_total"] == pytest.approx(
        plain["markets"]["total"]["mean_total"] - 10.0, abs=1e-6)
    assert calib["markets"]["total"]["p_over"] < plain["markets"]["total"]["p_over"]
    assert calib["markets"]["spread"]["p_cover"] == plain["markets"]["spread"]["p_cover"]
    assert calib["moneyline"] == plain["moneyline"]
    code, out = _post(base + "/sim", {**body, "alt": {"width": 2, "step": 1},
                                      "calibration": {"total_shift": -10.0}})
    assert code == 200, out
    row = [r for r in out["alt"]["total"] if r["total"] == pytest.approx(44.5)][0]
    assert row["p_over"] == pytest.approx(out["markets"]["total"]["p_over"], abs=1e-9)
    code, out = _post(base + "/sim", {**body, "calibration": {"nope": 1}})
    assert code == 400 and "unknown calibration fields" in out["error"]
    code, out = _post(base + "/sim", {**body, "calibration": {"total_scale": -1}})
    assert code == 400


def test_live_single_flight_identical_requests(server, monkeypatch):
    base, service = server
    body = {**Q4, "clock": "06:30", "n_games": 512, "seed": 91}
    calls = []
    real = api.simulate_live_game

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(api, "simulate_live_game", counted)
    outs = [None] * 3

    def go(i):
        outs[i] = _post(base + "/live", body)

    service._lock.acquire()
    held = True
    try:
        ts = [threading.Thread(target=go, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 30:
            with service._batch_lock:
                if sum(it.waiters for it in service._inflight.values()) >= 3:
                    break
            time.sleep(0.02)
        service._lock.release()
        held = False
        for t in ts:
            t.join(timeout=120)
    finally:
        if held:
            service._lock.release()
    assert [o[0] for o in outs] == [200] * 3, outs
    rows = [o[1]["live"] for o in outs]
    assert rows[1] == rows[0] and rows[2] == rows[0]
    assert len(calls) == 1                      # ONE computation for three
    code, solo = _post(base + "/live", body)
    assert code == 200 and len(calls) == 2 and _bare(solo) == _bare(outs[0][1])


def test_sim_response_equals_direct_api_call(server):
    """The /sim answer is the direct call's: the slate of one's summary row
    and the markets priced off its summary, bitwise."""
    base, service = server
    body = {**AB, "n_pairs": 256, "seed": 12, "spread": -1.5, "total": 42.5,
            "alt": {"width": 2, "step": 1}}
    code, out = _post(base + "/sim", body)
    assert code == 200, out
    rows, (s,) = api.simulate_slate_summary_rows(
        [("Team A", "Team B")], sp_path=service.cfg.sp_path, artifact_dir=ART, n_pairs=256,
        seed=12, mode="analytic", device="cpu")
    assert out["summary"] == jsonable(rows[0])
    assert out["moneyline"] == jsonable(summary_moneyline(s, "Team A", "Team B"))
    assert out["markets"] == jsonable(market_odds_from_summary(s, "Team A", "Team B",
                                                               spread=-1.5, total=42.5))
    assert out["alt"] == jsonable(alt_line_rows_from_summary(
        s, "Team A", "Team B", spread=-1.5, total=42.5, width=2.0, step=1.0))


def test_table_mode_server_on_fixture_heads(files):
    """A table-mode server on the fixture artifacts: nano tables built from
    the loaded heads on the first /sim and kept (device_tables), the answer
    equal to the direct table-mode call; mode='analytic' still allowed per
    request, 'exact' refused."""
    srv, base, service = _start(_cfg(files, mode="table"))
    try:
        body = {**AB, "n_pairs": 128, "seed": 4, "spread": -3.5}
        code, out = _post(base + "/sim", body)
        assert code == 200, out
        rows, (s,) = api.simulate_slate_summary_rows(
            [("Team A", "Team B")], sp_path=files["sp"], artifact_dir=ART, n_pairs=128,
            seed=4, device="cpu")
        assert out["summary"] == jsonable(rows[0])
        assert out["markets"] == jsonable(market_odds_from_summary(s, "Team A", "Team B",
                                                                   spread=-3.5))
        code, h = _get(base + "/health")
        assert h["device_tables"] >= 1 and h["config"]["mode"] == "table"
        code, out = _post(base + "/sim", {**body, "mode": "analytic"})
        assert code == 200
        code, out = _post(base + "/sim", {**body, "mode": "exact"})
        assert code == 400 and "mode" in out["error"]
    finally:
        _stop(srv)


def test_server_runs_with_pandas_blocked(files):
    """The server module in a process where pandas (and jax, sklearn)
    cannot be imported answers every endpoint."""
    code = f"""
import json, sys, threading, urllib.request
for m in ("pandas", "jax", "sklearn", "joblib"):
    sys.modules[m] = None
from fast_monte_carlo_tpu_torch import fixtures
from fast_monte_carlo_tpu_torch.serve import ServeConfig, SimService, make_server
svc = SimService(ServeConfig(sp_path={files['sp']!r}, artifact_dir=fixtures.ARTIFACT_DIR,
                             focus_csv={files['focus']!r}, mode="analytic", device="cpu"))
srv = make_server(svc, port=0)
threading.Thread(target=srv.serve_forever, daemon=True).start()
base = "http://127.0.0.1:%d" % srv.server_address[1]
ab = {{"team_a": "Team A", "team_b": "Team B"}}
q4 = {{**ab, "quarter": 4, "clock": "05:00", "down": 2, "dist": 7, "ytg": 40,
      "score_a": 21, "score_b": 17}}
reqs = [("/sim", {{**ab, "n_pairs": 64, "spread": -3.5, "total": 41.5, "alt": True}}),
        ("/slate", {{"games": [["Team A", "Team B"]], "n_pairs": 64,
                    "lines": [{{"team_a": "Team A", "spread": -3.5}}]}}),
        ("/live", {{**q4, "n_games": 128, "total": 41.5}}),
        ("/live", {{**ab, "n_games_per": 64, "situations": [q4, {{**q4, "sec": 900}}]}}),
        ("/fourth", {{**q4, "down": 4, "dist": 2, "ytg": 33, "n_games": 128}}),
        ("/parlay", {{**ab, "n_pairs": 64, "correlations": True, "round_robin": 2,
                     "legs": [{{"kind": "moneyline", "team": "Team A"}},
                              {{"kind": "total", "side": "over", "line": 40.5}}]}}),
        ("/season", {{"team": "Team A", "opponents": ["Team B"], "n_pairs": 64,
                     "line": 0.5}}),
        ("/props", {{"games": [["Team A", "Team B"]], "n_pairs": 32,
                    "props": fixtures.prop_rows(4)}})]
for path, body in reqs:
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200, path
with urllib.request.urlopen(base + "/health", timeout=60) as r:
    assert json.loads(r.read())["requests"] == len(reqs)
srv.shutdown()
bad = [m for m in ("pandas", "jax", "sklearn", "fast_monte_carlo_tpu")
       if sys.modules.get(m) is not None]
print("ok", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0 and out.stdout.strip() == "ok []", (out.stdout, out.stderr)


# ---- against the JAX package's server ------------------------------------------

def _keys(o):
    """The key structure of a JSON value: dicts by key, lists by their
    first element (rows share their keys)."""
    if isinstance(o, dict):
        return {k: _keys(v) for k, v in o.items()}
    if isinstance(o, list):
        return [_keys(o[0])] if o and isinstance(o[0], (dict, list)) else []
    return None


@pytest.fixture(scope="module")
def jax_server(files, tmp_path_factory):
    """The JAX package's server on the same sheet (analytic mode; its scan
    unrolled once so that its programs compile in seconds: scan_unroll
    shapes only XLA's loop)."""
    from fast_monte_carlo_tpu import api as japi
    from fast_monte_carlo_tpu.config import SimConfig as JaxSimConfig
    from fast_monte_carlo_tpu.serve import ServeConfig as JaxServeConfig
    from fast_monte_carlo_tpu.serve import SimService as JaxSimService
    from fast_monte_carlo_tpu.serve import make_server as jax_make_server

    jdir = jax_readable_copy(ART, tmp_path_factory.mktemp("jaxserve") / "art")
    c = JaxSimConfig()
    cfg1 = c.replace(engine=dataclasses.replace(c.engine, scan_unroll=1))
    real = japi.SimConfig
    japi.SimConfig = lambda: cfg1
    service = JaxSimService(JaxServeConfig(sp_path=files["sp"], artifact_dir=jdir,
                                           mode="analytic", max_n_pairs=4096, max_games=2))
    srv = jax_make_server(service, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    _stop(srv)
    japi.SimConfig = real


N_CMP = 2048   # pairs: 4,096 games a side


def test_sim_and_health_agree_with_jax(server, jax_server):
    base, _ = server
    body = {**AB, "n_pairs": N_CMP, "spread": -2.5, "total": 41.5,
            "alt": {"width": 2, "step": 1}}
    (code, got), (jcode, want) = _post(base + "/sim", body), _post(jax_server + "/sim", body)
    assert code == jcode == 200, (got, want)
    assert _keys(got) == _keys(want)
    n = 2 * N_CMP
    for k in ("win_a", "win_b"):
        assert within(got["summary"][k], want["summary"][k], want["summary"][k], n), k
    for k in ("mean_a", "mean_b", "mean_total"):
        assert abs(got["summary"][k] - want["summary"][k]) <= 4 * 12 * np.sqrt(2 / n), k
    for k in ("spread", "total"):
        p = {"spread": "p_cover", "total": "p_over"}[k]
        assert within(got["markets"][k][p], want["markets"][k][p], want["markets"][k][p], n)
    _, h = _get(base + "/health")
    _, jh = _get(jax_server + "/health")
    assert set(h) == set(jh) | {"device_name"}
    assert set(h["config"]) == set(jh["config"]) | {"device"}


def test_live_and_slate_agree_with_jax(server, jax_server):
    base, _ = server
    live = {**Q4, "n_games": 2 * N_CMP, "spread": 1.5, "total": 45.5}
    curve = {**AB, "n_games_per": 1024, "situations": [Q4, {**Q4, "sec": 1500}]}
    slate = {"games": [["Team A", "Team B"], ["Team 000", "Team 001"]], "n_pairs": 1024,
             "lines": [{"team_a": "Team 000", "spread": -2.5, "total": 40.5}]}
    for path, body, key, n in (("/live", live, "live", 2 * N_CMP),
                               ("/live", curve, "curve", 1024),
                               ("/slate", slate, "summaries", 2048)):
        (code, got), (jcode, want) = _post(base + path, body), _post(jax_server + path, body)
        assert code == jcode == 200, (path, got, want)
        assert _keys(got) == _keys(want), path
        g_rows = got[key] if isinstance(got[key], list) else [got[key]]
        w_rows = want[key] if isinstance(want[key], list) else [want[key]]
        for g, w in zip(g_rows, w_rows):
            for k in ("win_a", "win_b"):
                assert within(g[k], w[k], w[k], n), (path, k)
    assert [r["spread"] is None for r in got["markets"]] == \
        [r["spread"] is None for r in want["markets"]] == [True, False]


def test_pricing_equals_jax_on_the_same_summary(server):
    """Given the port's summary, the JAX package's pricing functions give
    the server's moneyline, markets and ladders exactly."""
    from fast_monte_carlo_tpu import edge as jedge
    from fast_monte_carlo_tpu.serve import jsonable as jax_jsonable

    base, service = server
    body = {**AB, "n_pairs": 256, "seed": 21, "spread": 2.5, "total": 43.0,
            "alt": {"width": 3, "step": 0.5}, "calibration": {"margin_shift": -1.0}}
    code, out = _post(base + "/sim", body)
    assert code == 200, out
    _, (s,) = api.simulate_slate_summary_rows(
        [("Team A", "Team B")], sp_path=service.cfg.sp_path, artifact_dir=ART, n_pairs=256,
        seed=21, mode="analytic", device="cpu")
    cal = jedge.MarketCalibration(margin_shift=-1.0)
    assert out["moneyline"] == jax_jsonable(jedge.summary_moneyline(s, "Team A", "Team B",
                                                                    calibration=cal))
    assert out["markets"] == jax_jsonable(jedge.market_odds_from_summary(
        s, "Team A", "Team B", spread=2.5, total=43.0, calibration=cal))
    assert out["alt"] == {k: jax_jsonable(v) for k, v in jedge.alt_lines_from_summary(
        s, "Team A", "Team B", spread=2.5, total=43.0, width=3.0, step=0.5,
        calibration=cal).items()}
