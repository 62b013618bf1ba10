#!/usr/bin/env python3
"""One-card smoke run of the PyTorch port (fast_monte_carlo_tpu_torch).

Runs from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py              # every phase; exits 0 only if all pass
    python3 chip_smoke.py --profile DIR  # also writes torch.profiler
                                         # kernel tables of one launch to
                                         # DIR/profile_launch.txt, of the
                                         # props path to DIR/profile_props.txt
                                         # of two live queries to
                                         # DIR/profile_live.txt, of a
                                         # slate launch to
                                         # DIR/profile_slate.txt and of a
                                         # parlay query to
                                         # DIR/profile_parlay.txt

Phases, in order (any failure raises and exits non-zero):
 1. versions, `nvidia-smi` name and power limit; exit 1 without CUDA;
 2. build every kernel source (csrc/philox_draws.cu, fused_step.cu,
    row_gather.cu, forest_eval.cu, nano_game.cu, score_moments.cu) with
    nvcc, one process each, all started together;
 3. the kernel against its plain version on the card at the main path's
    shape (ch=24 plays x 65,536 games) and at ragged ones (ch 1, 3, 24 x
    n 1, 255, 257, 65,573) for 3 keys: uniforms bitwise, normals within
    1e-5, chunked == per-step, moments and coverage; from a row offset
    (a rank's first game: 65,536, 2^31 + 7, 2^32 - 255) against the plain
    version, and half a launch drawn alone from its row == those rows of
    the whole launch; an output buffer off a 16-byte boundary raises;
    kernel (ch 24 and 1, from row 65,536) and plain version timed, beside
    the launch gap (a held near-empty kernel);
 4. one play step at 65,536 states with injected draws, on CUDA and on the
    CPU: integer state equal, floats allclose(rtol=1e-5, atol=1e-5);
 5. the main path: MatchupRunner(mode="table", rng_impl="pallas_chunk",
    device="cuda") with the fixture nano table, `run_pairs_summary` over
    524,288 games in 65,536-game launches (262,144 if the warm-up
    launch predicts more than 60 s; 4,194,304 before phase 14 came,
    2,097,152 before phase 17, 1,048,576 before phase 19);
    summary checks; games/s; since phase 21 each launch is one K1 launch
    (nano_game) and one K2 (score_moments), and philox_draws is launched
    no time (`--profile`: the launch's device kernels, a play of the eager
    loop on the same games, and the busy share);
 6. the fused play-step kernels (B1 fused_step, B2 fused_step_tab) against
    their plain versions at B = 131,072 for 3 keys: one step equal on
    integer state and within 1e-5 on floats, a 24-step chunk equal to 24
    one-step launches, and, for the first key (all 3 before the smoke
    outgrew its limit), 360-step runs equal in at least 99.9% of final
    scores with means and side-A win rate within 4 MC standard errors;
    fused_step_tab also at B = 1, 127, 129 and 131,073 with heads of
    stride 7 and 1, and 24 launches back to back equal to the same chain
    synchronised between launches; both timed against their plain
    versions; then the probes path (`probes.step_arith.time_structures`):
    the five structures, 360 steps;
 7. the row gathers (row_gather, row_gather_sum) against their plain
    versions, which clip indices as the kernels do: row_gather_sum at
    widths 1, 3, 5, 8, 127, 128, 129 and 1,000, both on a table one float
    past a 16-byte boundary and with indices outside the table; B3's
    360-launch loop, and a 24-launch chain that sums the previous output,
    back to back equal to the same launches synchronised one by one; then
    at the B3-B6 probes' shapes: gathers bitwise, row sums within 1e-6
    relative; kernel, plain and torch.index_select timed; then the gather
    probes path (`probes.gather.run_probes`);
 8. the props path: MatchupRunner(mode="table", rng_impl="pallas_chunk",
    device="cuda") with the focus-roster fixture teams, `run_pairs(8,192,
    collect_players=True, collect_stats=True)` (16,384 games, the JAX
    package's `simulate_slate_props` default): one K1 launch with both
    collectors and no philox_draws launch; points equal the score,
    box-score and player identities, no NaN; 4,096 games on CUDA and on the
    CPU agree in >= 99.5% of games on integer state and every count, yards
    allclose; the prop reduction on the card against the CPU; a scan of the
    fixture prop sheet prices every resolvable row; 65,536-game launches of
    the props path and of score-only `run_pairs` timed in turns, with peak
    device memory, one K1 launch each and no philox_draws launch (device
    kernels a launch with --profile);
 9. the live path: MatchupRunner(mode="table", device="cuda") with the
    fixture nano table and the default SimConfig() (rng_impl "threefry",
    which the port draws from its Philox stream, as "rbg" too): the kickoff
    situation's starting state on the card equals one built field by field
    from the config (sec = game_seconds, down 1, ytg = kickoff_spot, period
    1, no red-zone trip, 0-0); 8,192 games from it equal a kickoff start
    with the same key on every field (a smoke of the `situation=` route:
    `initial_state` is the kickoff situation, so this holds no more than
    the plumbing; the CPU tests hold both against the JAX package); 4,096 games from a Q4 05:00, 2nd-and-7, 21-17
    situation agree between CUDA and the CPU in >= 99.5% of games on
    integer state; a forced field goal with 5 s left at the 20 over 65,536
    games wins within 4 standard errors of the kick's make probability,
    ties otherwise, and launches no play chunk after the forced play;
    `run_live_batch` over 16 situations x 8,192 games, n exact, every
    fourth row (each before the smoke outgrew its limit) within 4 standard
    errors of `run_live` of its situation alone;
    65,536 antithetic games finish with a mean margin within 4 standard
    errors of the plain run's; threefry, rbg and pallas_chunk play the same
    scores for one key; the Q4 summary prices a spread, a total and the
    moneyline (`edge`).  Then `run_live` (65,536 games, from Q4 05:00 and
    from the kickoff), `run_live_batch` (16 x 8,192) and
    `run_fourth_decision` (65,536 games x 4 choices) timed, 1 call each
    after a warm-up (3 before phase 16, then 2), with the engine's launches
    (K4 play chunks, K1 launches, K3 forced plays; `engine_launches`).  The
    launch counts are set to 0 just before these queries, so the live
    path's launches are the queries' own (warm-ups included), not those of
    the checks before them;
10. the slate path: a 60-matchup fixture slate (`fixtures.slate`, the
    default SimConfig()) through `SlateRunner(game_shard=True)
    .run_summary_rows` at BASELINE.md config #3's size, 98,304 games a
    matchup in 3 launches of 16,384 pairs a matchup (1 launch if the
    warm-up launch predicts more than 60 s); each game's n exact, win +
    win + tie = 1, mean points in (10, 50), histograms summing to n, no
    NaN; games/s and peak device memory; one launch at the JAX default
    chunk_pairs 32,768 with its peak memory; the philox_draws kernel at
    that launch's shape (24 x 3,932,160) against its plain version on
    three slices of rows; a 3 x 4,096-game slate on CUDA and on the CPU
    equal in >= 99.5% of games on integer state; the loop layout
    (`simulate_slate_summary_rows(layout="loop")`) at 2 matchups x 16,384
    games, each game within 4 standard errors of the one-launch layout,
    both timed; `edge.slate_market_rows` prices all 60 games against
    `fixtures.slate_lines`, by name and by position alike (`--profile`
    adds `DIR/profile_slate.txt`: device kernels and device ms a play of
    one slate launch, and the busy share);
11. the multi-leg, season and slate-props path, default SimConfig():
    `simulate_parlay` on the focus-roster teams at the JAX default n_pairs
    32,768 (65,536 games, player stats, no box score), six legs (a spread,
    the moneyline, a whole and a half-point total, two props), priced at
    +600 with correlations and a round robin by 2/3; on a run of the same
    seed its counts on the card equal numpy's on the host exactly, the
    same games reduced on the CPU price the same dict, the correlations
    are within 1e-6 of numpy's corrcoef, every ticket equals parlay_odds
    of its legs, a 6-point teaser wins no leg less often, and a 2-block
    cross-game teaser equals the blocks' products; `project_season` over a
    2-game fixture schedule (`fixtures.season`, cut from a 12-game season;
    4 games before the smoke outgrew its limit) at the JAX defaults
    (n_pairs 50,000, chunk_pairs 32,768: 131,072 games a game, the second
    launch ragged), its p_wins equal to its slate summary rows, the pmf
    summing
    to 1; `simulate_slate_props` over `fixtures.focus_slate(5, 6)` with
    `slate_prop_rows` at the JAX default n_pairs 8,192 (16,384 games a
    launch): exactly 3 launches a scan, each matchup's reduction of the
    scan's own games on the card equal to the CPU's on counts (floats
    within 1e-5) and to the scan's rows, matchup 3 played under its slate
    index, every resolvable row priced.  The three queries run first, each
    a warm-up and 1 timed call (3 before phase 16, then 2; the season its
    one call alone since the smoke outgrew its limit), between setting the
    launch
    counts to 0 and reading them, and each call must launch K1 and no
    philox_draws (every launch of games on K1);
    the checks run after, on each warm-up's result (`--profile` adds
    `DIR/profile_parlay.txt`);
12. exact mode and tables from heads, on `fixtures.heads(0, "reference")`
    (stage 1 of 188 trees, stage 2, nine quantile forests of 400 trees,
    fumble, play): K5 (`forest_eval`) against its plain walk on the card for
    every forest at B = 65,536 feature rows of `fixtures.play_states` and at
    ragged B = 1, 255, 257, 65,573, within rtol=1e-5, atol=1e-4, and how
    many launches were bitwise equal; K5 held ms per forest and per play
    (the default config's 11 forests), the plain walk's ms and the bound
    counted on the walks the rows take (`forest_bound`: a record read, a
    compare and a child step a node visited, a feature read a numeric one,
    an add a (row, tree)); a forest of 65 numerics, whose packed records
    would overflow the row slot, raises ValueError with no launch; one
    exact-mode play step at 4,096 states (16,384 before phase 18, 65,536
    before phase 16) on CUDA
    and on the CPU, integer state equal in >= 99.5%; K1's exact
    instantiation alone on these heads at a 65,536-game launch (the 11
    forests' 21 tiles, most forests over two), held ms beside its bound on
    the launch's plays (the walks a row of the K5 rows above, the 11
    forests a play: the exact JSON row's ms and bound); K1 against
    `nano_game_plain` from the same start at 4,096 games
    (`--exact-plain-games`; the plain time by events is the row's
    plain_ms) and, at 512 games, `simulate_games` (one K1 launch) against
    the eager loop, 0 differing games allowed in either (the row's
    max|d|); the nano tables built from the same heads
    (`MatchupRunner(mode="table", heads=)`, host seconds); then
    `run_pairs_summary` of `MatchupRunner(mode="exact")`, of that table
    runner and of `MatchupRunner(mode="analytic")` in turns (exact, table,
    analytic; exact, table, table, exact before the smoke outgrew its
    limit), each turn 65,536-game launches, as many as fill about 6 s of
    exact mode after a warm-up (at most 2), each with the summary checks;
    every launch one K1 launch (exact and analytic ones counted), no K5 or
    philox_draws launch, the plain walk never called; the three games/s
    side by side;
13. inputs from files: a schema-B SP+ sheet of 136 teams
    (`fixtures.write_sp_sheet`) and the focus sheet written to a temporary
    directory; the SP+ load, `load_heads(fixtures.ARTIFACT_DIR)` cold and
    warm (the memo) and `load_reconstructed_heads` (the committed
    sklearn-1.9 overlay) timed on the host, and in a subprocess where
    sklearn, joblib and pandas cannot be imported the same loads succeed
    and none of them enters sys.modules; K5 on every loaded forest (stage
    1, stage 2 and the overlay's stage 2, nine quantile forests, fumble,
    play) bitwise equal to its plain walk at B = 65,536, held ms a play
    beside `forest_bound`; the nano build a direction timed; then, between
    setting the counts to 0 and reading them,
    `simulate_upcoming_matchup_columns` (32,768 pairs) in exact mode with
    the focus sheet and in table mode without it, each with the summary
    checks and equal column for column to the same run composed by hand
    (contexts, heads, `MatchupRunner`), games/s of the hand-composed runs;
    the exact route one K1 exact launch, no K5 or philox_draws launch, the
    run composed by hand as many;
    `simulate_live_game` and `evaluate_fourth_down` through `sp_path=`;
    `simulate_slate_summary_rows(sp_path=, layout="game_shard")` over 2
    matchups (`SlateRunner(heads=)`);
14. the resident server: `serve.SimService(ServeConfig(mode="table",
    device="cuda"))` on the 136-team sheet and the fixture artifacts, with
    every memo (heads, tables, runners) emptied first, behind
    `serve.make_server(port=0)` on a thread, spoken to over HTTP with
    urllib: `warm` with two matchups, GET /health (platform cuda, the
    card's name), a cold and a warm /sim (spread, total, alt; 32,768
    pairs; the warm answer equal to the cold), four distinct /sim requests
    posted while the service lock is held (coalesced), /slate with lines
    on 4 matchups, /live and /live with situations, /fourth, /parlay,
    /season; a second server in exact mode with the focus sheet: /sim
    (16,384 pairs, K1's exact instantiation) and /props over the fixture
    prop sheet; every launch on K1, no philox_draws or K5 launch; every
    answer's summary rows checked; then, after the counts are read, the
    first and the last coalesced answer (each before the smoke outgrew its
    limit) equal bitwise to the same request alone, the cold
    /sim equal to `api.simulate_slate_summary_rows` on the card, and K4 at
    that /sim's first launch key and shape against its plain version;
    latencies of each endpoint and /health's p50 and p95 printed;
15. saved sims, bundles and the backtest, in a temporary working directory
    with the 136-team sheet, the focus sheet, the fixture prop sheet and the
    fixture artifacts, on phase 14's table disk cache (its own fresh one
    before the smoke outgrew its limit), each step timed with its K4, K1
    and K5 launches: `cli sim
    --save --players` (exact mode on the focus rosters, 8,192 pairs), then
    `edges` (spread, total, props, ladders, both middles) and `prop
    --ladder` over the saved files, their printed cover, over and win shares
    held to numpy's counts over the CSV rows, `moneyline_from_sims` too;
    `edges --device` market-only at 32,768 pairs (run_pairs_summary), with
    props on the focus rosters (exact mode) and in exact mode at 8,192
    pairs, each summary's n exact, every exact run on K1's exact
    instantiation with no K4 or K5 launch and the plain walk never called,
    `player_stat_probs` on the card equal to numpy
    over the host pstats for every resolved prop row; a small market-only
    query under `utils.profiling.trace_context` (a Chrome trace with kernel
    events); the batched sweep's core (3 chunks of 8,192 pairs, each
    bitwise `simulate_matchup_columns` under its folded key; resumed past
    chunks 0-1 it plays chunk 2 alone); `store.make_signature` of a fixed
    meta against the JAX package's hex; `cli backtest` over the smoke's own
    finals (4 games, a pair in both orientations, a rematch that ties), its
    report well formed and its rows' win_a bitwise
    `api.simulate_slate_summary_rows`; `cli slate --props` on the focus
    teams equal to `api.simulate_slate_prop_rows`; `device_memory_stats`
    and `SimMeter` over the steps;
16. the other table layouts, with every table and runner memo emptied:
    (a) `simulate_upcoming_matchup_columns` in table mode on the 136-team
    sheet, the focus sheet and the small heads (`fixtures.heads(0,
    "small")`, handed to the route as `heads=`; the reference-shape
    artifact heads, whose cold build took 150 s of host numpy, before the
    smoke passed 1,200 s on a slower host), whose splits name the
    rosters' players, so the heads do not fuse and the
    runner builds the per-head tables (cold: each direction's build
    seconds and each table's MB on the card); the summary and player rows
    well formed; 65,536-game launches with both collectors and score-only
    timed; one play step on the per-head tables at 65,536 states on CUDA
    and on the CPU (`TableHeads.to`), integer state equal in >= 99.5%;
    (b) `cli sim --reconstructed` (the ML play policy in table mode) on the
    small heads (`fixtures.heads(0, "small")`, handed to the CLI by its
    loader; the reference-shape heads before phase 18), then
    `MatchupRunner(reconstructed_config())` on the same contexts reusing
    its build: the play table's build seconds a direction and MB, P(pass)
    on the card equal to the CPU's lookup and within the play clip, the
    pass share below with the table filled at play_clip_lo and above at
    play_clip_hi, games/s; (c) each `table_quality` preset (nano for
    comparison, default, coarse, slate, fused, turbo; `LAYOUT_PRESETS`
    names the heads each uses) on the sheet's Team A and Team B: its
    layout, build seconds, MB, games/s of its first launch (of one after a
    warm-up before the smoke outgrew its limit), and
    the heads eval's and a play step's device ms at 65,536 states, the
    per-head tables of (a) too; (d) `SlateRunner(quality="turbo",
    game_shard=True)` and `quality="fused"` on 4 of the sheet's matchups:
    build seconds, games/s, peak memory, the summaries well formed;
17. the table disk cache and sd_mode='cachewarm' (every phase but 15 writes
    its table files to a fresh directory of its own under one temporary
    directory, so every cold build above stays cold): (a) the seconds and
    MB of phase 16 (a)'s cold focus-roster write; (b) a child process runs
    the same `simulate_upcoming_matchup_columns` focus route on phase 16's
    directory: its tables read from disk, their sha256 equal to phase 16's
    packed tables, its summary well formed, no jax imported, its wall
    time beside the cold route's; (c) `MatchupRunner` in 'cachewarm' on
    the reference-shape heads, nano preset, 64 warm-up games: the warm-up's
    and the build's seconds, a second build reading both from disk (the
    same tables), the collapsed table's one sd bin, games/s after axis
    nano's (one turn each; two before the smoke outgrew its limit),
    philox_draws launched and its plain version never called; (d)
    `cli sim --sd-mode cachewarm`; (e) a 4-matchup cachewarm
    `SlateRunner(game_shard=True)` on the small heads (16 warm-up games a
    matchup), built twice, the second time with no table built and no
    oracle game played, then run;
18. trial sharding (`parallel/mesh.py`): (a) in this process a world of one
    over NCCL on cuda:0: `MatchupRunner(shard=True).run_pairs_summary` on
    the main path's fixture runner at 2 launches of 65,536 games equal to
    shard=False on every field, the two timed in turns, and `run_live`
    (65,536 games from Q4 05:00) equal to its unsharded run; (b) two ranks
    as child processes that meet through a FileStore: NCCL on cuda:0 and
    cuda:1 where there are two cards, else gloo with both ranks on cuda:0
    (each launches K4 on the card; only the collectives pass through the
    host): `run_pairs_summary(shard=True)` at 131,072 games, `run_live`,
    and the game layout (`SlateRunner(game_shard=True).run_summary_rows(
    mesh=group)`) over 8 fixture matchups, each rank holding only its
    block's tables; every rank's summaries bitwise equal to this process's
    unsharded runs, each rank launching philox_draws and importing no jax
    or fast_monte_carlo_tpu; (c) `cli sim --shard` (analytic) in a world of
    one printing what `cli sim` prints, and a server's /sim with "shard":
    true answered 200 and equal to "shard": false;
19. the bench entry, each run a subprocess on the card: (a) `python -m
    fast_monte_carlo_tpu_torch.bench -n 131072 --repeats 1 --no-lanes
    --budget 180` (table mode, nano tables built from the fixture heads)
    and (b) `python -m fast_monte_carlo_tpu_torch.cli bench --mode exact -n
    65536`: exactly one stdout line with the contract's keys, device
    platform "gpu", emit "complete", games/s > 0, nano_game and
    score_moments launched and philox_draws and forest_eval none in both
    (exact mode's forests are walked inside K1), the stderr sanity
    line's mean points in (10, 50); the
    bench's games/s printed beside phase 5's;
20. training on the card's host: (a) `python -m fast_monte_carlo_tpu_torch.cli
    train` on a small seeded plays csv in a subprocess, which on a host
    without scikit-learn (the H100 host has pandas, but neither
    scikit-learn nor joblib) exits non-zero naming the missing packages and
    writes nothing (on a host with them it trains; the phase says which
    case ran); (b) `train.build_reconstructed --calibration-only --device
    cuda` on the 136-team sheet's Team A and Team B and the fixture
    artifact directory's heads at 48 oracle games (the JAX script's 96 cut
    in half): calibration.json alone, the play forest's margins walked by
    K5 in one launch; then one exact-mode launch (16,384 games, one K1
    launch, no K5) under `reconstructed_config()` on
    `load_reconstructed_heads`, which reads the port's own overlay; (c)
    K5's margins bitwise equal to the
    plain walk's on the card and to the CPU's, the temperature equal to the
    one fitted on the CPU's margins, the overlay's directory inside the
    port's package; the oracle's seconds and states, K5's launches and
    held ms on the play forest, and the temperature printed;
21. K1 and K2 against their plain versions on the card: K1 (`simulate_games`
    on a covered launch, `ops.game.nano_game`) against the eager loop
    (`simulate_games_eager`) on the same key at 65,536 games from the
    kickoff, antithetic, from a Q4 `Situation`, from an `init_state` after
    a forced go, from row0 65,536 and on nano tables with stage-2 and
    fumble channels (enable_fumbles), and one launch of the 60-matchup
    fixture slate at 16,384 games a matchup; with the collectors (box
    score only, player stats only on the focus roster, both with no tracked
    slot, both on the focus roster, antithetic, and resumed after 40 eager
    plays with both on, its stats nonzero), stats and pstats compared too:
    the games differing on each field printed, none allowed (K1 is bitwise
    equal by design);
    `nano_game_plain` on the card against K1 at 4,096 games, none allowed; K2 (`exact_moments_cuda`) bitwise
    equal to the torch body at (1, 65,536) on K1's scores, (60, 32,768) and
    on scores past every clamp; K1's held ms a 65,536-game launch and a
    slate launch (60 x 32,768 games) beside its bound counted on the
    launch's plays (`nano_bound`), the plain version's and the eager loop's
    times; the props instantiation (both collectors, the focus roster,
    65,536 games) beside its bound on the launch's plays, slots sampled and
    player rows added (`accrual_work`) and the score-only K1's held ms in
    the same call; and K2's held ms, bound and torch body's time.  Then the
    heads that read no table (`phase_k1_heads`): K1's exact instantiation
    (small heads, focus roster: score-only, both collectors with the fumble
    and play heads, a forced go; a 3-matchup slate) and its analytic one
    (score-only, both collectors antithetic, a forced go), each `simulate_games` one K1
    launch, against the eager loop and `nano_game_plain` at 1,024 games,
    none differing, and exact mode on the tiled heads (stage 1 and the
    play head over eight tiles each) with both collectors the same way;
    their registers; the analytic one held at 65,536 games beside its bound
    (the exact one's row is phase 12's).
Every phase prints its seconds, and a line before the JSON lines lists
them with the whole smoke's.
Every kernel's launch count is set to 0 just before each path (5, 6, 7, 8,
9, 10, 11, 12, 13, 14, 15, 16, 17, 20) and read just after it (phase 18
counts the sharded runs' own launches, its ranks' included; phase 19 the
bench's own, from its JSON line); a path that launched one of its kernels
no time fails.  nano_game's and score_moments' launches in the JSON line
are every path's (`PATH_LAUNCHES`), phase 18's and phase 19's; phase 21's
comparisons count none.  nano_game_props is K1's instantiation with both
collectors: its launches are the paths' K1 launches with a collector on;
nano_game_exact's and nano_game_analytic's are the paths' K1 launches of
exact mode and of the analytic heads (phases 12-15, 19, 20).
forest_eval's launches in the JSON line are phase 20's training
temperature's (exact mode walks its forests inside K1: 0 from phases
12-15 and 19); its times are per play (11 launches), the bound too.
The JSON line's philox_draws
launches are the main path's, the live queries', the slate path's, phase
11's, phase 13's, phase 14's, phase 15's, phase 16's, phase 17's (its child
process's included), phase 18's (its ranks' included), phase 19's and
phase 20's.
Kernel times are device time per call: CUDA events around back-to-back
calls that the host enqueued while a spin kernel held the stream
(`probes.kernels.held_ms`; `kernel_times` for philox_draws, the fused
steps and row_gather_sum, which `python -m
fast_monte_carlo_tpu_torch.probes.kernels` prints alone).  Each kernel's
bound is the largest of its bytes and its instructions by class over the
H100's rates (`bound`): the JSON line gives it with `bound_by` ("bytes" or
"operations") and `bound_class`.
The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

CH, N = 24, 65536                  # the main path's draw launch shape
# cut from 4,194,304 for phase 14, from 2,097,152 for phase 17, from
# 1,048,576 for phase 19, whose bench entry times the same workload
GAMES, LAUNCH_GAMES = 524_288, 65_536
CUT_GAMES = 262_144                # used if the full run would pass ~60 s
TABLE_SEED = 7
FOCUS_SEED, PROP_SEED = 3, 4       # fixtures.focus_rows / prop_rows
PROPS_PAIRS = 8192                 # the JAX package's simulate_slate_props n_pairs
CROSS_PAIRS = 2048                 # props path on CUDA against the CPU
PROBE_B, PROBE_STEPS = 131_072, 360   # benchmarks/pallas_step_arith.py's defaults
PROBE_RUN_KEYS = 1                 # keys of the 360-step runs (3 before the smoke passed
                                   # 1,200 s on a slower host)
LIVE_GAMES = 65_536                # the JAX package's run_live / 4th-down default
LIVE_KICK_GAMES = 8192             # kickoff situation against a kickoff start
CURVE_PER = 8192                   # the JAX package's run_live_batch n_games_per
CURVE_ALONE_STEP = 4               # every 4th curve row run alone (each row before the
                                   # smoke passed 1,200 s on a slower host)
LIVE_REPS = 1                      # timed calls of each live query (3 before phase 16,
                                   # 2 before the smoke passed 1,200 s on a slower host)
SLATE_GAMES, SLATE_SEED = 60, 8    # BASELINE.md config #3: a weekly slate of ~60 games
SLATE_PAIRS = 49_152               # 98,304 games a matchup (BASELINE.md #3: 100k)
SLATE_CHUNK = 16_384               # pairs a matchup a launch: 3 launches
SLATE_BIG_CHUNK = 32_768           # the JAX package's default chunk_pairs
SLATE_CUT_S = 60                   # one launch if three would take longer
SLATE_CROSS_GAMES = 3              # matchups on CUDA against the CPU, CROSS_PAIRS each
LOOP_GAMES = 2                     # matchups of the loop layout against one launch (4
                                   # before the smoke passed 1,200 s)
LOOP_PAIRS = 8_192                 # 16,384 games a matchup, one launch each
PARLAY_PAIRS = 32_768              # the JAX package's simulate_parlay n_pairs
PARLAY_PRICE = 600
# six legs on the focus-roster teams: a spread, the moneyline, a whole and a
# half-point total (the whole one pushes) and two prop legs (one by alias)
PARLAY_LEGS = [
    {"kind": "spread", "team": "Team A", "line": 6.5},
    {"kind": "moneyline", "team": "Team A"},
    {"kind": "total", "side": "over", "line": 40},
    {"kind": "total", "side": "under", "line": 70.5},
    {"kind": "prop", "team": "Team A", "player": "Team A Passer 1", "stat": "pass_yds",
     "side": "over", "line": 150.5},
    {"kind": "prop", "team": "Team B", "player": "Team B Receiver 1", "stat": "rec_yards",
     "side": "under", "line": 60.5},
]
SEASON_GAMES, SEASON_SEED = 2, 17  # a 12-game season cut to 2 games (4 before the smoke
                                   # passed 1,200 s on a slower host)
SEASON_PAIRS, SEASON_CHUNK = 50_000, 32_768   # the JAX package's project_season defaults
SLATE_PROPS_GAMES, SLATE_PROPS_SEED = 5, 6    # fixtures.focus_slate / slate_prop_rows
SLATE_PROPS_PAIRS = 8_192          # the JAX package's simulate_slate_props n_pairs
MULTI_REPS = 1                     # timed calls of the parlay and the slate prop scan
                                   # (3 before phase 16, 2 before the smoke passed
                                   # 1,200 s on a slower host)
SEASON_REPS = 0                    # timed calls of the season after its first (1 before
                                   # the smoke passed 1,200 s on a slower host)
K5_BS = (65_536, 1, 255, 257, 65_573)  # K5 against its plain version: the launch, ragged
EXACT_LAUNCH_GAMES = 65_536        # exact mode's games a launch
EXACT_EAGER_GAMES = 512            # K1's exact instantiation against the eager loop on the
                                   # reference-shape heads (some 700 kernels a play there)
EXACT_PLAIN_GAMES = 4_096          # and against nano_game_plain there (--exact-plain-games)
K1_HEADS_GAMES = 1_024             # phase 21's exact and analytic variants, K1 against the eager
                                   # loop and nano_game_plain
K1_HEADS_SEED = 11                 # their small and tiled heads (fixtures.heads)
EXACT_TARGET_S = 6                 # exact mode's timed launches fill about this (12
                                   # before phase 17)
EXACT_MAX_LAUNCHES = 4
EXACT_TURNS = ("exact", "table", "analytic")   # (exact, table, table, exact) before the smoke
                                                # passed; the analytic runner added since
                                   # 1,200 s on a slower host
EXACT_STEP_STATES = 4_096          # the exact play step, CUDA vs CPU (16,384 before phase 18,
                                   # 65,536 before phase 16)
SP_TEAMS, SP_SEED = 136, 0         # the 2025 SP+ sheet's FBS teams (fixtures.write_sp_sheet)
FILE_PAIRS = 32_768                # simulate_upcoming_matchup n (pairs): 65,536 games, one
                                   # launch (2 before the smoke passed 1,200 s)
FILE_LIVE_GAMES = 65_536           # the JAX package's simulate_live_game default
FILE_SLATE_PAIRS = 16_384          # a slate matchup's pairs: one 65,536-game launch
SERVE_PAIRS = 32_768               # /sim n_pairs (the JAX server's default): one launch
SERVE_SLATE_PAIRS = 16_384         # /slate and /season pairs a matchup
SERVE_EXACT_PAIRS = 16_384         # the exact-mode server's /sim
SERVE_PROPS_PAIRS = 4_096          # /props on the exact-mode server
SERVE_LIVE_GAMES = 65_536          # /live and /fourth n_games (the JAX server's default)
SERVE_CURVE_PER = 8_192            # /live situations' n_games_per (its default)
SERVE_SEED = 5
SERVE_WARM = [("Team A", "Team B"), ("Team 000", "Team 001")]
SERVE_COLD = ("Team B", "Team A")    # the fixture teams the other way round: new tables
SERVE_COALESCED = SERVE_WARM + [SERVE_COLD, ("Team 002", "Team 003")]
SERVE_SOLO = (0, 3)                # coalesced answers asked again alone (each before the
                                   # smoke passed 1,200 s on a slower host)
HEALTH_GETS = 50
SAVED_PAIRS = 8_192                # sim --save n (pairs): 16,384 games with player rows
                                   # (16,384 pairs before the smoke passed 1,200 s)
SAVED_SEED = 3
EDGES_PAIRS = 32_768               # edges --device market-only: run_pairs_summary's branch
                                   # (131,072 before the smoke passed 1,200 s)
EDGES_SMALL_PAIRS = 8_192          # edges --device with props, and in exact mode
TRACE_PAIRS = 512                  # the traced market-only edges --device query
SWEEP_PAIRS, SWEEP_CHUNKS, SWEEP_SEED = 8_192, 3, 11   # the batched sweep's chunks
BACKTEST_PAIRS, BACKTEST_SEED = 8_192, 6
# the backtest's finals, drawn from the matchups whose nano tables phase 14
# built (SERVE_COALESCED; phase 15 reads them from phase 14's disk cache):
# Team A and Team B in both orientations, Team 000 and Team 001 met twice, the
# rematch a tie (8 games before the smoke passed 1,200 s on a slower host)
BACKTEST_GAMES = [("Team A", "Team B"), ("Team B", "Team A"), ("Team 000", "Team 001"),
                  ("Team 000", "Team 001")]
SAVED_SLATE_GAMES = [("Team A", "Team B"), ("Team B", "Team A")]   # the focus sheet's teams
# store.make_signature of this meta, as the JAX package's make_signature gives it
SIGNATURE_META = {"teams": ["Team A", "Team B"], "n_pairs": 16384, "seed": 3,
                  "mode": "exact", "cfg": {"rng_impl": "threefry", "play_chunk": 24,
                                           "lines": [-3.5, 44.5]},
                  "note": "saved sims, bundles and the backtest"}
SIGNATURE_HEX = "217959fcfc1d278bd456d5507a3e462578409e07fe800aadce65b98723cd03b7"
LAYOUT_PAIRS = 32_768              # phase 16: 65,536-game launches
LAYOUT_LAUNCHES = 1                # timed launches of each run (2 before the smoke passed
                                   # 1,200 s on a slower host)
LAYOUT_SEED = 16
# phase 16 (c): each preset with the heads its build fits the time limit
# with ("artifact": fixtures.ARTIFACT_DIR's reference-shape heads, "small":
# fixtures.heads(0, "small")), 'nano' first for comparison
LAYOUT_PRESETS = (("nano", "artifact"), ("default", "small"), ("coarse", "small"),
                  ("slate", "artifact"), ("fused", "small"), ("turbo", "artifact"))
PRESET_LAYOUT = {"nano": "nano", "default": "per-head", "coarse": "per-head",
                 "slate": "fused", "fused": "fused", "turbo": "fused"}
LAYOUT_SLATE = [("Team A", "Team B"), ("Team 000", "Team 001"), ("Team 002", "Team 003"),
                ("Team 004", "Team 005")]
# the preset whose tables phase 21 reuses (fused from heads, on the turbo
# profile; the per-head and play tables come from phase 16's own runs)
K1_PRESETS = ("turbo",)
LAYOUT_SLATE_PAIRS = 16_384        # 32,768 games a matchup: one 131,072-game launch
# (quality, game_shard, heads) of phase 16 (d); from the artifact heads
# the coarse fused grid takes about 24 s a matchup to build, turbo 5 s
LAYOUT_SLATE_RUNS = (("turbo", True, "small"), ("fused", False, "small"))
# mean points of the sheet's matchups: Team 003's weak offense scores 5.5
# a game against Team 002 on the nano path too (phase 14's /slate)
LAYOUT_SLATE_BAND = (0, 70)
# phase 17: the 'cachewarm' runner's and CLI's warm-up games (the default),
# and the 4-matchup cachewarm slate's, cut to keep the smoke in its limit
CACHEWARM_GAMES = 64
SLATE_WARM_GAMES = 16
# phase 18: trial sharding; the main path's fixture runner at 2 launches of
# 65,536 games (4 before the smoke passed 1,200 s on a slower host), run_live
# from phase 9's Q4 situation, and the game layout over 8 fixture matchups at
# one launch of 16,384 games a matchup
SHARD_PAIRS, SHARD_CHUNK, SHARD_SEED = 65_536, 32_768, 18
SHARD_LIVE_GAMES = 65_536
SHARD_SLATE_GAMES, SHARD_SLATE_PAIRS = 8, 8_192
SHARD_CLI_PAIRS = 8_192            # cli sim --shard and the server's /sim, analytic
SHARD_CHILD_S = 300                # the two ranks' time limit
# phase 19: the bench entry as a user runs it, each a subprocess
# (table mode at -n 262144 before the smoke passed 1,200 s on a slower host)
BENCH_RUNS = (("table", ["-m", "fast_monte_carlo_tpu_torch.bench", "-n", "131072",
                         "--repeats", "1", "--no-lanes", "--budget", "180"]),
              ("exact", ["-m", "fast_monte_carlo_tpu_torch.cli", "bench", "--mode", "exact",
                         "-n", "65536"]))
BENCH_RUN_S = 300                  # each run's time limit
# build_reconstructed's oracle games: cut from the JAX script's 96, since the
# whole smoke ran past 1,100 s with them on a slow host
TRAIN_GAMES = 48
TRAIN_ROWS, TRAIN_SEED = 400, 20   # the plays csv handed to cli train
TRAIN_CLI_S = 300                  # cli train's time limit
TRAIN_EXACT_PAIRS = 8_192          # the overlay's exact-mode launch: 16,384 games
TRAIN_MODULES = ("pandas", "sklearn", "joblib")   # what cli train needs
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "meta"}
BENCH_SANITY = re.compile(r"# sanity: mean \[([-\d.]+), ([-\d.]+)\] winA ([\d.]+)")
# each kernel of the JSON line and its source in csrc/
# (nano_game_props: K1's instantiation with both collectors, the props path's;
# nano_game_fused and _per_head: K1 on those table layouts, the one-row and
# the per-head instantiation; nano_game_play: K1 reading the play-policy
# table; nano_game_forced: K1 with the 4th-down evaluator's forced first play;
# nano_game_exact and _analytic: K1 under exact mode's forests and under the
# analytic heads)
KERNEL_SOURCES = {"philox_draws": "philox_draws", "fused_step": "fused_step",
                  "fused_step_tab": "fused_step", "row_gather": "row_gather",
                  "row_gather_sum": "row_gather", "forest_eval": "forest_eval",
                  "nano_game": "nano_game", "nano_game_props": "nano_game",
                  "nano_game_fused": "nano_game", "nano_game_per_head": "nano_game",
                  "nano_game_play": "nano_game", "nano_game_forced": "nano_game",
                  "nano_game_exact": "nano_game", "nano_game_analytic": "nano_game",
                  "score_moments": "score_moments"}
# K1's rows past the nano score-only one: the wrapper's count of each
K1_ROWS = {"nano_game_props": "launches_collecting", "nano_game_fused": "launches_fused",
           "nano_game_per_head": "launches_per_head", "nano_game_play": "launches_play",
           "nano_game_forced": "launches_forced", "nano_game_exact": "launches_exact",
           "nano_game_analytic": "launches_analytic"}
SOURCES = tuple(dict.fromkeys(KERNEL_SOURCES.values()))
# the Pallas kernel each replaces (the timed shape's; PERF.md lists them all)
REPLACES = {"philox_draws": "fast_monte_carlo_tpu/ops/rng_pallas.py:94",
            "fused_step": "benchmarks/pallas_step_arith.py:270",
            "fused_step_tab": "benchmarks/pallas_step_arith.py:383",
            "row_gather": "benchmarks/pallas_dma_gather.py:9",
            "row_gather_sum": "benchmarks/pallas_gather_probe.py:33",
            # XLA on the TPU, not Pallas kernels
            "forest_eval": "fast_monte_carlo_tpu/ops/forest_eval.py:96 eval_margin",
            "nano_game": "fast_monte_carlo_tpu/ops/game.py:844 simulate_games",
            "nano_game_props": "fast_monte_carlo_tpu/ops/game.py:844 simulate_games "
                               "(collect_players, collect_stats: :309, :586-653)",
            "nano_game_fused": "fast_monte_carlo_tpu/ops/game.py:844 simulate_games "
                               "(fused heads: ops/table_lookup.py:644 _fused_eval)",
            "nano_game_per_head": "fast_monte_carlo_tpu/ops/game.py:844 simulate_games "
                                  "(per-head heads: ops/table_lookup.py:540-605)",
            "nano_game_play": "fast_monte_carlo_tpu/ops/game.py:844 simulate_games "
                              "(play-policy lookup: ops/table_lookup.py:588-597, :627-639)",
            "nano_game_forced": "fast_monte_carlo_tpu/api.py:481-482 _forced_live_moments_jit "
                                "(ops/game.py:392-415 forced play, then :844 simulate_games)",
            "nano_game_exact": "fast_monte_carlo_tpu/ops/game.py:844 simulate_games (exact heads: "
                               ":145 make_exact_heads_eval, :294 _play_pass_prob, :318 "
                               "_state_features; ops/forest_eval.py:96 eval_margin)",
            "nano_game_analytic": "fast_monte_carlo_tpu/ops/game.py:844 simulate_games "
                                  "(analytic heads: :267 make_analytic_heads_eval)",
            "score_moments": "fast_monte_carlo_tpu/parallel/aggregate.py:76 score_moments"}

# The H100 SXM's rates by class, on 132 SMs at 1.98 GHz: HBM bytes/s
# (NVIDIA's data sheet); per SM and clock, 64 on the ALU pipe (integer
# logic, compares and selects, and the f32 compare, min, max and select),
# 64 IMAD/IMUL (the heavy half of the FMA pipe), 16 MUFU and int<->float
# conversions, and 128 instructions dispatched (4 schedulers x 32 lanes;
# an FMA is one) (CUDA C++ Programming Guide, throughput table for compute
# capability 9.0; the pipes as Nsight Compute's profiling guide names
# them).  A bound is the largest of the class times.
SM_CLOCKS_PER_S = 132 * 1.98e9
RATES = {"bytes": 3.35e12, "alu": 64 * SM_CLOCKS_PER_S, "imad": 64 * SM_CLOCKS_PER_S,
         "mufu_cvt": 16 * SM_CLOCKS_PER_S, "dispatch": 128 * SM_CLOCKS_PER_S}
# Instructions per item by class: what the algorithm needs and never more
# than the built kernel runs.  Counted on the SASS of the built kernels
# (one trip of the step loop, slow paths of division, sqrtf and sincosf
# left out), less moves, branches, parameter and special-register reads,
# predicate spills, work that is the same at every step of a launch, index
# arithmetic and the padded search slots.  Integer adds and shifts, which
# either the ALU or the IMAD pipe may run, count in dispatch only.
# philox_draws, per (step, row): Philox4x32-10's 83 32x32-bit products
# (IMAD.WIDE gives both halves; round 0 is shared by the 5 blocks) and 91
# XORs, 17 masks, and in Box-Muller 30 compares, selects, min and max
# (logf, sincosf's quadrants): 138 ALU, 83 IMAD; 17 int->float, 4
# conversions and 2 F2I in logf and sincosf, 2 rsqrt: 25; with 89 f32, the
# 18-add key schedule and 4 vector stores, 357 dispatched.
DRAW_COUNTS = {"alu": 138, "imad": 83, "mufu_cvt": 25, "dispatch": 357}
# fused_step, per game-step (its draws and step_arith): Philox's 80
# products and 81 XORs (the words no step reads dropped, the row's and
# the key's work hoisted out of the step loop), 13 masks, and the state
# machine's compares, selects, clips and predicate logic over the live
# tables (7 + 4 bucketize edges and 4 FG points, not 8 slots each): 313
# ALU, 85 IMAD; 33 MUFU and conversions (5 divisions, 2 tanhf, logf,
# sqrtf, sincosf, a floor); with 240 f32 and 42 integer adds, 714
# dispatched.
STEP_COUNTS = {"alu": 313, "imad": 85, "mufu_cvt": 33, "dispatch": 714}
# nano_game (K1), per play of a game, on the SASS of its step loop by the
# same rules, and for the timed launches' tables and config: no stage-2 or
# fumble channels (their three loads and the fumble channel's index left
# out, the analytic stage 2's 5 divisions counted), taper, red-zone damping
# and antithetic mirroring off, and the two red-zone finish branches (taken
# on red-zone plays only) left out; also the row's and the go-for-it cell's
# index, the (down, sd) block, a second computation of sd and the loop
# counter.  The rest: Philox's 76 products and 102 XOR and mask LOP3s, the
# decision, punt, pass, sack, INT, run and state machine (the per-direction
# tilts and explosive base come in precomputed), 7 row loads, 20
# int->float conversions, 2 rsqrt, 5 reciprocals, 3 F2I and the punt's
# trunc, less the padded search slots (1 ytg and 4 dist edges, 4 FG
# points).  The SASS evaluates all 8 segments of every profile axis (256
# instructions); binning needs one compare and one select per segment
# boundary of the profile (4 dist, 7 ytg, 7 sec, 0 score-diff at nsd = 3),
# then one evaluation an axis (subtract, multiply, rint, F2I, min, max, the
# base's add): 44 ALU, 8 conversions, 64 dispatched.  In all 334 ALU, 80
# IMAD, 39 MUFU and conversions, 713 dispatched.
NANO_COUNTS = {"alu": 334, "imad": 80, "mufu_cvt": 39, "dispatch": 713}
# score_moments (K2), per game: the pair's load, 3 compares (wins, ties)
# and 8 clamps (ALU 11), 2 squares (IMAD.WIDE), 4 shared-memory atomic
# adds, the 64-bit sums' and the counts' adds and the bins' offsets: 35
# dispatched.
MOMENT_COUNTS = {"alu": 11, "imad": 2, "mufu_cvt": 0, "dispatch": 35}
# K1's collectors, by the same rules, beyond NANO_COUNTS, checked against
# the SASS of the instantiation with both collectors
# (nano_game_kernel<true, true>), which runs more: per play, the team
# stats' 19 f32 adds (18 columns and rz_trips' trip1 + trip2), fourth_conv's
# two yards + 1e-6 adds and two compares, rz_TD's compare, and 4 predicate
# ops to combine them (flags enter as adds of 1.0, so no conversion is
# counted; where the accumulators live, the lane's stripe of shared memory,
# is the design's cost, not the work's, and its loads and stores are left
# out); per slot sampled (the QB and the target on a pass play, the rusher
# on a run), K = 8 share loads, compares and count adds, the clamp, the
# tracked flag's load and test; per player row added (a tracked slot), the
# 24-byte row read and written with 8-byte accesses (3 LDG.64 and 3
# STG.64, as the kernel issues) and its 6 adds.  f32 adds run on the FMA
# pipes at the dispatch rate, so they count in dispatch only, as in
# STEP_COUNTS.  The slot loop's unrolled address arithmetic is index
# arithmetic.
NANO_TEAM_COUNTS = {"alu": 7, "imad": 0, "mufu_cvt": 0, "dispatch": 28}
NANO_SLOT_COUNTS = {"alu": 10, "imad": 0, "mufu_cvt": 0, "dispatch": 27}
NANO_ROW_COUNTS = {"alu": 0, "imad": 0, "mufu_cvt": 0, "dispatch": 12}
# K1 past the nano layout (the one-row and per-head instantiations, the
# play-policy lookup), by the same rules, as NANO_COUNTS with the layout's
# own binning and lookups in place of the nano table's
# (`layout_counts`).  Binning, per profile axis binned: one compare and one
# select a segment boundary and one evaluation (subtract, multiply, rint,
# F2I, min, max, the base's add: 2 ALU, 2 conversions, 7 dispatched;
# `bin_counts`): NANO_COUNTS holds the nano profile's (4, 7, 7 and 0
# boundaries: 44 ALU, 8 conversions, 64 dispatched).  The play-policy
# lookup: the coarse cell's three axes binned, the score diff's bin among
# the 26 edges and the P(pass) load.  The bin counts the least work that
# binning an integer among sorted edges needs, whatever the kernel does: a
# clamp into a table of the integers the edges span (2 ALU) and one load
# from it (PLAY_SEARCH_COUNTS: 3 dispatched; a binary search would take 5
# compares and their selects, the first kernel's scan 26 compares and 26
# adds).  The
# per-head lookups: per slot sampled (QB, target and rusher, every play),
# NANO_SLOT_COUNTS less the tracked flag's load and test; per table read,
# its key and row index clamped (4 ALU), its row-map entry's load and its
# channels' loads, in place of the nano row's 7 loads.  A forced first play
# is a play (the kernel's `plays` count holds it).
PLAY_SEARCH_COUNTS = {"alu": 2, "imad": 0, "mufu_cvt": 0, "dispatch": 3}
HEAD_SLOT_COUNTS = {"alu": 9, "imad": 0, "mufu_cvt": 0, "dispatch": 25}
NANO_ROW_LOADS = 7
# the channels each per-head table's row holds (game.HEAD_TABLES' order)
HEAD_CHANNELS = (1, 2, 2, 2, 2, 1)
# the H100 SXM's L2 and its sector: a matchup's tables larger than the L2
# are read a sector a lookup (a focus roster's per-head tables, 150-620 MB),
# smaller ones once
L2_BYTES, SECTOR_BYTES = 50 * 2 ** 20, 32
# K1's state bytes a game: gid, off, sec, down, dist, ytg, period, the
# two bools and the score read; the same less gid written
NANO_STATE_IN, NANO_STATE_OUT = 38, 34
# K2's histogram bins a matchup (2 x 128 + 256 + 256) and its 8 counts
MOMENT_BINS, MOMENT_FIELDS = 768, 8
# the launches of K1 and K2 in every path window (`read_counts`), summed:
# the JSON line's counts of those two kernels, with phase 18's ranks' and
# phase 19's bench processes' added
PATH_LAUNCHES: dict = {}
# phase 21: the variants at LAUNCH_GAMES (the ragged ones at 1,000 and 4);
# the slate variants at the fixture slate's G matchups x NANO_SLATE_GAMES;
# the resumed collector variant after NANO_RESUMED_PLAYS eager plays
NANO_SLATE_GAMES = 16_384
NANO_RESUMED_PLAYS = 40
# the start of the variants added for the slot-sampling redesign: Q4 10:00,
# 21-17, about a sixth of a game's plays (the eager loop's cost), and of the
# per-head resumed variant after PER_HEAD_RESUMED_PLAYS eager plays from it
Q4_LATE_SITUATION = (0, 600, 1, 10.0, 75.0, 21, 17)
PER_HEAD_RESUMED_PLAYS = 4
# forest_eval (K5): what any walk of this run's rows must do, whatever its
# layout (the plain walk's leaves give each row's path; the same bound
# holds any kernel of the walk): per internal node visited, one
# record read, one compare (ALU) and one child step (an integer add); per
# numeric node visited, the feature read; per (row, tree), one add.
FOREST_VISIT_COUNTS = {"alu": 1, "dispatch": 3}
FOREST_NUMERIC_COUNTS = {"dispatch": 1}
FOREST_TREE_COUNTS = {"dispatch": 1}
# the node table's bytes a node in the bound: a threshold and one 32-bit
# word of the rest, the least a layout can hold (K5's record)
FOREST_NODE_BYTES = 8


def card_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def engine_launches() -> dict:
    """The game engine's launches so far: K4 (philox_draws, a play chunk of
    the eager loop), K1 (nano_game, a whole launch of games) and K3
    (philox_draws at ch = 1, a forced play or a per-step draw)."""
    from fast_monte_carlo_tpu_torch.ops import game, rng

    return {"K4": rng.philox_draws.launches_by_ch[CH], "K1": game.nano_game_cuda.launches,
            "K3": rng.philox_draws.launches_by_ch[1]}


def launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in engine_launches().items()}


def engine_record() -> dict:
    """`engine_launches` with K1's launches on the fused and per-head
    layouts, with the play table, with a forced first play, and of the
    score-only one-row layouts whose options are fixed at compile time."""
    from fast_monte_carlo_tpu_torch.ops import game

    f = game.nano_game_cuda
    return {**engine_launches(), "K1 fused": f.launches_fused,
            "K1 per-head": f.launches_per_head, "K1 play": f.launches_play,
            "K1 forced": f.launches_forced, "K1 options compiled": f.launches_compiled}


def engine_since(before: dict) -> dict:
    """`engine_record` since `before`, the kinds that launched."""
    return {k: v - before[k] for k, v in engine_record().items() if v != before[k]}


def per(counts: dict, items: float) -> dict:
    """Per-item instruction counts of each class times `items`."""
    return {k: v * items for k, v in counts.items()}


def draw_bound(ch: int, n: int) -> dict:
    """`bound` of one philox_draws launch: ch * n * 17 floats written."""
    return bound(ch * n * 17 * 4, per(DRAW_COUNTS, ch * n))


def step_bound(b: int, ch: int, head_bytes: int = 0) -> dict:
    """`bound` of one fused-step launch over b games: 9 state words read and
    written per game, `head_bytes` more read, ch game-steps each."""
    return bound(b * (9 * 4 * 2 + head_bytes), per(STEP_COUNTS, b * ch))


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()                                     # warm-up
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_profile(fn, reps: int, warm: bool = True):
    """(device ms per call, device kernels and copies per call) by
    torch.profiler over `reps` calls after a warm-up (where `warm`: a
    function whose kernels have run before needs none), or None where the
    profiler recorded no device time (it does so now and then)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # the device events as recorded: the same sums as key_averages() gives,
    # without the event tree it builds (seconds for 50,000 kernels)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    ns = sum(e.duration_ns() for e in events)
    return (ns / 1e6 / reps, len(events) / reps) if ns > 0 else None


def times(fn, reps: int):
    """(device ms per call, ms per call by CUDA events around the run, how
    the first was measured).  The device time is `held_ms`; where the hold
    did not cover the enqueue, torch.profiler's summed kernel time, and
    where that recorded nothing, the held run's time, marked host-bound."""
    from fast_monte_carlo_tpu_torch.probes.kernels import held_ms

    ms, held = held_ms(fn, reps)
    how = "held events"
    if not held:
        prof = device_profile(fn, reps)
        ms, how = (prof[0], "profiler") if prof else (ms, "events, host-bound")
    return ms, cuda_ms(fn, reps), how


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}")


def bound(nbytes: float, counts: dict) -> dict:
    """The least time the card could take: bytes over the HBM rate, and
    each class's instructions (`counts`, totals) over its rate; the largest
    binds.  `bound_by` is "bytes" or "operations", `bound_class` the class."""
    ms = {"bytes": nbytes / RATES["bytes"] * 1e3,
          **{k: v / RATES[k] * 1e3 for k, v in counts.items()}}
    cls = max(ms, key=ms.get)
    return {"bound_ms": ms[cls], "bound_by": "bytes" if cls == "bytes" else "operations",
            "bound_class": cls}


def kernel_counts() -> dict:
    """Each kernel of the JSON line: (its wrapper, the wrapper's attribute
    counting its launches)."""
    from fast_monte_carlo_tpu_torch.ops import forest_eval, game, rng
    from fast_monte_carlo_tpu_torch.parallel import aggregate
    from fast_monte_carlo_tpu_torch.probes import gather, step_arith

    fns = {"philox_draws": rng.philox_draws, "fused_step": step_arith.fused_step,
           "fused_step_tab": step_arith.fused_step_tab, "row_gather": gather.row_gather,
           "row_gather_sum": gather.row_gather_sum,
           "forest_eval": forest_eval.eval_margin_cuda,
           "nano_game": game.nano_game_cuda, "score_moments": aggregate.exact_moments_cuda}
    return {**{name: (fn, "launches") for name, fn in fns.items()},
            **{name: (game.nano_game_cuda, attr) for name, attr in K1_ROWS.items()}}


def launch_count(name: str) -> int:
    fn, attr = kernel_counts()[name]
    return getattr(fn, attr)


def zero_counts() -> None:
    for fn, attr in kernel_counts().values():
        setattr(fn, attr, 0)


def read_counts(path: str, needed) -> dict:
    counts = {name: launch_count(name) for name in kernel_counts()}
    print(f"  launches in the {path}: {counts}")
    for name in ("nano_game", *K1_ROWS, "score_moments"):
        PATH_LAUNCHES[name] = PATH_LAUNCHES.get(name, 0) + counts[name]
    for name in needed:
        check(counts[name] > 0, f"{path} launched {name} {counts[name]} times")
    return counts


def phase_kernel(card: str) -> dict:
    import torch
    from fast_monte_carlo_tpu_torch.ops import rng
    from fast_monte_carlo_tpu_torch.probes.draws import RAGGED_KEYS, ragged_shapes
    from fast_monte_carlo_tpu_torch.probes.kernels import kernel_times, launch_gap_ms

    dev = torch.device("cuda")
    worst = 0.0
    for key, base in RAGGED_KEYS:
        # ragged shapes: tiles that end inside a row of uniforms, n below,
        # just above and 37 past a tile multiple
        shapes = ragged_shapes(CH, N)
        equal, err, differ = [], 0.0, []
        for ch, n in shapes:
            u, z = rng.chunk_draws(key, base, ch, n, dev)
            ur, zr = rng.philox_draws_reference(key, base, ch, n, dev)
            equal.append(torch.equal(u, ur))
            err = max(err, float((z - zr).abs().max()))
            if not equal[-1]:
                # where they differ, for a fault that has not come back
                d = (u != ur).nonzero()
                i = tuple(d[0].tolist())
                differ.append(f"({ch}, {n}): {d.shape[0]} differ, first {i} "
                              f"{float(u[i])!r} against {float(ur[i])!r}")
            if (ch, n) == (3, 257):
                per_step = [rng.step_draws(key, base + j, n, dev) for j in range(ch)]
                check(all(torch.equal(us, u[j]) and torch.equal(zs, z[j])
                          for j, (us, zs) in enumerate(per_step)),
                      f"key {key:#x} base {base}: (3, 257) chunk == per-step draws")
        worst = max(worst, err)
        check(all(equal) and err <= 1e-5,
              f"key {key:#x} base {base}: uniforms bitwise at all {len(shapes)} ragged "
              f"shapes ({sum(equal)} equal), normals max|d| {err:.3g} <= 1e-5"
              + "".join(f"; {x}" for x in differ))
        u, z = rng.chunk_draws(key, base, CH, N, dev)
        ur, zr = rng.philox_draws_reference(key, base, CH, N, dev)
        torch.cuda.synchronize()
        err = float((z - zr).abs().max())
        worst = max(worst, err)
        check(torch.equal(u, ur), f"key {key:#x} base {base}: uniforms bitwise equal")
        check(err <= 1e-5, f"key {key:#x} base {base}: normals max|d| {err:.3g} <= 1e-5")
        for j in (0, 11, CH - 1):
            us, zs = rng.step_draws(key, base + j, N, dev)
            check(torch.equal(us, u[j]) and torch.equal(zs, z[j]),
                  f"chunk step {j} == per-step draws at step {base + j}")
        # a row offset (a rank's first global game): against the plain
        # version, and against the rows of a launch from row 0
        for ch, n, r0 in ((CH, N, N), (3, 257, (1 << 31) + 7), (1, 255, (1 << 32) - 255)):
            uo, zo = rng.chunk_draws(key, base, ch, n, dev, row0=r0)
            ur, zr = rng.philox_draws_reference(key, base, ch, n, dev, row0=r0)
            err = float((zo - zr).abs().max())
            worst = max(worst, err)
            check(torch.equal(uo, ur) and err <= 1e-5,
                  f"key {key:#x} base {base}: ({ch}, {n}) from row {r0:,}: uniforms bitwise, "
                  f"normals max|d| {err:.3g} <= 1e-5")
        half = N // 2
        uo, zo = rng.chunk_draws(key, base, CH, half, dev, row0=half)
        check(torch.equal(uo, u[:, half:]) and torch.equal(zo, z[:, half:]),
              f"key {key:#x} base {base}: rows {half:,}.. drawn alone == the same rows of the "
              f"({CH}, {N:,}) launch")
        uf, zf = u.double().reshape(-1), z.double().reshape(-1)
        m = uf.numel()
        check(abs(float(uf.mean()) - 0.5) < 4 * (1 / 12 / m) ** 0.5,
              f"uniform mean {float(uf.mean()):.6f}")
        # s.e. of a sample sd: sqrt((mu4 - var^2) / m) / (2 sd); for U[0,1)
        # sqrt(mu4 - var^2) = sqrt(1/80 - 1/144) = 0.0745 and 2 sd = 0.577
        check(abs(float(uf.std()) - (1 / 12) ** 0.5) < 4 * 0.0745 / m ** 0.5 / 0.577,
              f"uniform sd {float(uf.std()):.6f}")
        check(abs(float(zf.std()) - 1.0) < 4 * (0.5 / zf.numel()) ** 0.5,
              f"normal sd {float(zf.std()):.6f}")
        cover = float((zf.abs() < 1.96).double().mean())
        check(abs(cover - 0.95) < 4 * (0.95 * 0.05 / zf.numel()) ** 0.5,
              f"normal +-1.96 sd coverage {cover:.5f}")

    key = rng.root_key(2)
    buf = (torch.empty((CH, N, 13), device=dev), torch.empty((CH, N, 4), device=dev))
    for i, what in enumerate(("u", "z")):
        flat = torch.empty(buf[i].numel() + 1, device=dev)
        off = list(buf)
        off[i] = flat[1:].view(buf[i].shape)
        try:
            rng.chunk_draws(key, 0, CH, N, dev, out=tuple(off))
            raised = False
        except ValueError:
            raised = True
        check(raised, f"a {what} buffer 4 bytes past a 16-byte boundary raises")
    held = kernel_times(dev, ("philox_draws ch=24", "philox_draws ch=1"))
    # the JSON line reports the main path's ch = 24; ch = 1 is printed too
    for ch in (1, CH):
        ms = held[f"philox_draws ch={ch}"]
        plain_ms, plain_ev, plain_how = times(
            lambda: rng.philox_draws_reference(key, 0, ch, N, dev), 5)
        bd = draw_bound(ch, N)
        print(f"  philox_draws ch={ch} n={N}: kernel {ms:.4f} ms held, plain torch "
              f"{plain_ms:.4f} ms device ({plain_how}; {plain_ev:.4f} by events), bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_class']}), launch gap "
              f"{launch_gap_ms():.4f} ms ({card})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "library_ms": None, **bd}


def phase_step() -> None:
    import torch
    from fast_monte_carlo_tpu_torch import fixtures
    from fast_monte_carlo_tpu_torch.config import SimConfig
    from fast_monte_carlo_tpu_torch.matchup import build_direction
    from fast_monte_carlo_tpu_torch.ops import game, table_lookup
    from fast_monte_carlo_tpu_torch.ops.pack import pack_matchup

    rng = np.random.default_rng(1)
    states = fixtures.play_states(rng, N)
    u, z = fixtures.play_draws(rng, (N,))
    cfg = SimConfig()
    a, b = fixtures.teams()
    outs = {}
    for dev in ("cuda", "cpu"):
        pack = pack_matchup(build_direction(a, b, cfg), build_direction(b, a, cfg), dev)
        th = table_lookup.pack_tables(*fixtures.nano_tables(TABLE_SEED), device=dev)
        s = game.GameState(**{k: torch.tensor(v, device=dev) for k, v in states.items()})
        out = game.play_step(s, (torch.tensor(u, device=dev), torch.tensor(z, device=dev)),
                             pack, cfg, table_lookup.make_table_heads_eval(cfg), th)
        outs[dev] = {f: getattr(out, f).cpu().numpy() for f in game.GameState._fields}
    for f in game.GameState._fields:
        x, y = outs["cuda"][f], outs["cpu"][f]
        if x.dtype.kind == "f":
            check(np.allclose(x, y, rtol=1e-5, atol=1e-5),
                  f"play step {f}: CUDA allclose CPU (max|d| {np.abs(x - y).max():.3g})")
        else:
            check(np.array_equal(x, y),
                  f"play step {f}: CUDA == CPU ({int((x != y).sum())} differ)")


def phase_main_path(card: str, profile_dir: Optional[Path]) -> dict:
    import torch
    from fast_monte_carlo_tpu_torch import fixtures
    from fast_monte_carlo_tpu_torch.api import MatchupRunner
    from fast_monte_carlo_tpu_torch.config import SimConfig

    cfg = SimConfig()
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, rng_impl="pallas_chunk"))
    a, b = fixtures.teams()
    runner = MatchupRunner(a, b, None, cfg, mode="table",
                           nano_tables=fixtures.nano_tables(TABLE_SEED), device="cuda")
    pairs_per_launch = LAUNCH_GAMES // 2

    t0 = time.perf_counter()                 # warm-up: one launch
    # run_pairs_summary runs score-only games (collect_players=False); the
    # box score stays off too
    runner.run_pairs_summary(pairs_per_launch, seed=99, chunk_pairs=pairs_per_launch,
                             collect_stats=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    games = GAMES if warm_s * GAMES / LAUNCH_GAMES <= 60 else CUT_GAMES
    print(f"  warm-up launch {warm_s:.3f} s; timing {games:,} games "
          f"in {games // LAUNCH_GAMES} launches of {LAUNCH_GAMES:,}")

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    summary = runner.run_pairs_summary(games // 2, seed=0, chunk_pairs=pairs_per_launch,
                                       collect_stats=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts("main path", ["nano_game", "score_moments"])
    check(counts["philox_draws"] == 0 and counts["nano_game"] == games // LAUNCH_GAMES,
          f"main path: one K1 launch a launch of games ({counts['nano_game']}), no draw "
          f"buffer: philox_draws {counts['philox_draws']} launches (the eager loop's 8 a "
          "launch before K1)")

    n = float(summary.n)
    wins = summary.win_rate.cpu().numpy()
    tie = float(summary.tie_rate)
    mean = summary.mean_pts.cpu().numpy()
    sd = summary.sd_pts.cpu().numpy()
    check(n == games, f"summary n == {games:,}")
    check(abs(wins.sum() + tie - 1.0) < 1e-5,
          f"win rates {wins.round(5).tolist()} + tie {tie:.5f} == 1")
    check(all(10 < m < 50 for m in mean), f"mean points {mean.round(3).tolist()} in (10, 50)")
    check(int(summary.margin_hist.sum()) == games, "margin histogram sums to n")
    check(int(summary.total_hist.sum()) == games
          and bool((summary.pts_hist.sum(dim=1) == games).all()),
          "total and points histograms sum to n")
    check(all(np.isfinite(x).all() for x in (wins, mean, sd)), "no NaN in the summary")
    gps = games / dt
    launch_ms = 1000 * dt / (games // LAUNCH_GAMES)
    print(f"  main path: {games:,} games in {dt:.3f} s -> {gps:,.0f} games/s, "
          f"{launch_ms:.2f} ms per {LAUNCH_GAMES:,}-game launch ({card})")
    print(f"  summary: mean pts {mean.round(3).tolist()}, sd {sd.round(3).tolist()}, "
          f"win {wins.round(4).tolist()}, tie {tie:.4f}")
    if profile_dir is not None:
        write_profile(runner, pairs_per_launch, card, launch_ms, profile_dir)
    return {"launches": counts, "games_per_s": gps, "seconds": dt}


def probe_states(seed: int, n: int):
    """n random play-start states of the step probe, on the card."""
    from fast_monte_carlo_tpu_torch import fixtures
    from fast_monte_carlo_tpu_torch.probes import step_arith as sa

    d = fixtures.play_states(np.random.default_rng(seed), n)
    return sa.state_from_numpy((d["off"], d["sec"], d["down"], d["dist"], d["ytg"],
                                d["period"], d["in_rz"].astype(np.int32),
                                d["score"][:, 0], d["score"][:, 1]), "cuda")


def same_state(got, want, what: str) -> float:
    """Integer fields equal in every game, floats within 1e-5; max |d|."""
    import torch
    from fast_monte_carlo_tpu_torch.probes import step_arith as sa

    torch.cuda.synchronize()
    worst, bad = 0.0, {}
    for f, x, y in zip(sa.STATE_FIELDS, got, want):
        if x.dtype == torch.float32:
            worst = max(worst, float((x - y).abs().max()))
        else:
            bad[f] = int((x != y).sum())
    check(not any(bad.values()) and worst <= 1e-5,
          f"{what}: integer state equal in all {got[1].numel():,} games "
          f"({sum(bad.values())} differ), floats max|d| {worst:.3g} <= 1e-5")
    return worst


def same_scores(fused, plain, what: str) -> None:
    """Final scores equal in >= 99.9% of games; means and side-A win rate
    within 4 MC standard errors."""
    fa, fb = (x.double().cpu().numpy() for x in fused)
    pa, pb = (x.double().cpu().numpy() for x in plain)
    n = fa.size
    differ = int(((fa != pa) | (fb != pb)).sum())
    check(differ <= n // 1000, f"{what}: final scores equal in {n - differ:,} of {n:,} "
          f"games ({differ} differ, at most {n // 1000})")
    for f, p, side in ((fa, pa, "A"), (fb, pb, "B")):
        se = np.sqrt(f.var() / n + p.var() / n)
        check(abs(f.mean() - p.mean()) <= 4 * se,
              f"{what}: mean points {side} {f.mean():.4f} vs {p.mean():.4f} within 4 s.e. {se:.4f}")
    fw, pw = (fa > fb).mean(), (pa > pb).mean()
    se = np.sqrt(fw * (1 - fw) / n + pw * (1 - pw) / n)
    check(abs(fw - pw) <= 4 * se, f"{what}: win A {fw:.4f} vs {pw:.4f} within 4 s.e. {se:.4f}")


def phase_fused(card: str) -> dict:
    import torch
    from fast_monte_carlo_tpu_torch.ops import rng
    from fast_monte_carlo_tpu_torch.probes import step_arith as sa
    from fast_monte_carlo_tpu_torch.probes.kernels import kernel_times, launch_gap_ms

    dev = torch.device("cuda")
    b = PROBE_B
    values = sa.make_table(dev)
    err = {"fused_step": 0.0, "fused_step_tab": 0.0}
    for ki, key in enumerate((rng.root_key(3), rng.fold_in(rng.root_key(4), 7), (1 << 64) - 1)):
        s0 = probe_states(10 + ki, b)
        for step in (0, 193):
            err["fused_step"] = max(err["fused_step"], same_state(
                sa.fused_step(s0, key, step, 1), sa.fused_step_reference(s0, key, step, 1),
                f"key {ki} step {step}: fused_step vs plain"))
            h = sa.heads_of(s0, values)
            err["fused_step_tab"] = max(err["fused_step_tab"], same_state(
                sa.fused_step_tab(s0, h, key, step),
                sa.fused_step_reference(s0, key, step, 1, h),
                f"key {ki} step {step}: fused_step_tab vs plain"))
        chunk = sa.fused_step(s0, key, 48, sa.CH)
        s = s0
        for j in range(sa.CH):
            s = sa.fused_step(s, key, 48 + j, 1)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(chunk, s)),
              f"key {ki}: fused-chunk24 == 24 fused-step launches in every game")
        if ki >= PROBE_RUN_KEYS:
            continue
        plain = sa.run_structure("eager", b, PROBE_STEPS, key, dev)
        for name in ("fused-step", "fused-chunk24"):
            same_scores(sa.run_structure(name, b, PROBE_STEPS, key, dev), plain,
                        f"key {ki}: {name} vs eager, {PROBE_STEPS} steps")
        same_scores(sa.run_structure("hybrid-tab", b, PROBE_STEPS, key, dev, values),
                    sa.run_structure("eager-tab", b, PROBE_STEPS, key, dev, values),
                    f"key {ki}: hybrid-tab vs eager-tab, {PROBE_STEPS} steps")

    # fused_step_tab at ragged sizes (a block of 1 game, one short of and
    # one past a block, one past the probe's B), heads as the columns of one
    # (B, 7) tensor (stride 7, as table_select gives them) and as seven
    # vectors (stride 1, which the wrapper stacks into one)
    key = rng.root_key(5)
    for bb in (1, 127, 129, b + 1):
        s0 = probe_states(20, bb)
        h7 = sa.heads_of(s0, values)
        h1 = [x.new_empty(x.shape).copy_(x) for x in h7]
        for heads in (h7, h1):
            err["fused_step_tab"] = max(err["fused_step_tab"], same_state(
                sa.fused_step_tab(s0, heads, key, 77),
                sa.fused_step_reference(s0, key, 77, 1, heads),
                f"B={bb:,}, heads stride {heads[0].stride()[0]}: fused_step_tab vs plain"))
    # 24 back-to-back launches, each reading the previous one's state,
    # against the same chain synchronised between launches
    s0 = probe_states(21, b)
    h = sa.heads_of(s0, values)

    def tab_chain(sync: bool):
        s = s0
        for j in range(sa.CH):
            s = sa.fused_step_tab(s, h, key, j)
            if sync:
                torch.cuda.synchronize()
        return s

    check(all(torch.equal(x, y) for x, y in zip(tab_chain(False), tab_chain(True))),
          f"{sa.CH} fused_step_tab launches back to back == synchronised between "
          "launches, in every game")

    key = rng.root_key(8)
    s0 = sa.init_state(b, dev)
    h = sa.heads_of(s0, values)
    held = kernel_times(dev, ("fused_step ch=1", "fused_step ch=24", "fused_step_tab"))
    out = {}
    # the JSON line reports the 24-step chunk launch; ch = 1 is printed too
    for ch in (1, sa.CH):
        ms = held[f"fused_step ch={ch}"]
        plain_ms, plain_ev, plain_how = times(
            lambda: sa.fused_step_reference(s0, key, 0, ch), 2)
        bd = step_bound(b, ch)
        print(f"  fused_step ch={ch} B={b:,}: kernel {ms:.4f} ms held, plain torch "
              f"{plain_ms:.4f} ms device ({plain_how}; {plain_ev:.4f} by events), bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_class']}), launch gap "
              f"{launch_gap_ms():.4f} ms ({card})")
    out["fused_step"] = {"max_abs_err": err["fused_step"], "ms": ms, "plain_ms": plain_ms,
                         "library_ms": None, **bd}
    ms = held["fused_step_tab"]
    plain_ms, plain_ev, plain_how = times(lambda: sa.fused_step_reference(s0, key, 0, 1, h), 5)
    bd = step_bound(b, 1, sa.N_HC * 4)
    print(f"  fused_step_tab B={b:,}: kernel {ms:.4f} ms held, plain torch {plain_ms:.4f} ms "
          f"device ({plain_how}; {plain_ev:.4f} by events), bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_class']}) ({card})")
    out["fused_step_tab"] = {"max_abs_err": err["fused_step_tab"], "ms": ms,
                             "plain_ms": plain_ms, "library_ms": None, **bd}

    def eager_step():
        u, z = rng.step_draws(key, 0, b, dev)
        return sa.step_arith(s0, u, z)

    for what, fn in (("one eager step (step_draws kernel + plain step_arith)", eager_step),
                     ("heads_of (table_select)", lambda: sa.heads_of(s0, values))):
        prof, ev = device_profile(fn, 5), cuda_ms(fn, 5)
        if prof is None:
            print(f"  {what} B={b:,}: torch.profiler recorded no device time; "
                  f"{ev:.4f} ms by events ({card})")
            continue
        ms, kernels = prof
        print(f"  {what} B={b:,}: {kernels:.0f} device kernels, {ms:.4f} ms device "
              f"(profiler), {ev:.4f} ms by events (device busy {ms / ev:.3f}) ({card})")

    print(f"  probes path: probes.step_arith.time_structures(B={b:,}, "
          f"steps={PROBE_STEPS}), one timed pass each")
    torch.cuda.synchronize()
    zero_counts()
    res = sa.time_structures(b, PROBE_STEPS, dev, reps=1)
    counts = read_counts("probes path (step_arith)", ["fused_step", "fused_step_tab"])
    for name, r in res.items():
        check(np.isfinite([r["mean_a"], r["mean_b"]]).all() and 5 < r["mean_a"] < 50,
              f"{name}: mean points {r['mean_a']:.3f}/{r['mean_b']:.3f}")
        print(f"  {name:14s} {r['ms_per_step']:9.4f} ms/step {r['games_per_s']:14,.0f} "
              f"eq-games/s  mean {r['mean_a']:.3f}/{r['mean_b']:.3f} winA {r['win_a']:.4f}  "
              f"{res['eager']['seconds'] / r['seconds']:8.2f}x vs eager ({card})")
    for name in ("fused_step", "fused_step_tab"):
        out[name]["launches"] = counts[name]
    return out


def phase_gather(card: str) -> dict:
    import torch
    from fast_monte_carlo_tpu_torch.probes import gather as ga
    from fast_monte_carlo_tpu_torch.probes.kernels import (RUNS, held_ms, kernel_times,
                                                           launch_gap_ms)

    dev = torch.device("cuda")
    g = np.random.default_rng(11)
    gather_err = sum_err = 0.0

    def same_gather(table, idx, what: str) -> None:
        nonlocal gather_err
        got, want = ga.row_gather(table, idx), ga.row_gather_reference(table, idx)
        torch.cuda.synchronize()
        gather_err = max(gather_err, float((got - want).abs().max()))
        check(torch.equal(got, want), f"{what}: row_gather bitwise equal to the clipping table[idx]")

    def close_sum(table, idx, what: str) -> None:
        nonlocal sum_err
        got, want = ga.row_gather_sum(table, idx), ga.row_gather_sum_reference(table, idx)
        torch.cuda.synchronize()
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        sum_err = max(sum_err, float((got - want).abs().max()))
        check(rel <= 1e-6, f"{what}: row_gather_sum within 1e-6 relative ({rel:.3g})")

    def rand_table(rows: int, cols: int, skip: int = 0):
        """U[0, 1) (rows, cols), starting `skip` floats into its buffer."""
        flat = torch.from_numpy(g.random(rows * cols + skip, dtype=np.float32)).to(dev)
        return flat[skip:].view(rows, cols)

    # the lane groups of both kernels at every width they take: 1-32 lanes,
    # float4 items (width % 4 == 0) and floats, one item per lane, a loop
    # within the warp; 8,193 rows, so the grid's last block is ragged, and
    # for row_gather 37 too
    for cols in (1, 3, 5, 8, 127, 128, 129, 1000):
        idx = torch.from_numpy(g.integers(0, 4096, 8193, dtype=np.int32)).to(dev)
        table = rand_table(4096, cols)
        same_gather(table, idx, f"width {cols}, 8,193 rows")
        close_sum(table, idx, f"width {cols}, 8,193 rows")
        same_gather(table, idx[:37], f"width {cols}, 37 rows")
    # a table one float past a 16-byte boundary takes the scalar path
    for cols in (8, 128):
        table = rand_table(4096, cols, skip=1)
        check(table.data_ptr() % 16 == 4, f"width {cols} table view 4 bytes past 16")
        idx = torch.from_numpy(g.integers(0, 4096, 8193, dtype=np.int32)).to(dev)
        same_gather(table, idx, f"misaligned width {cols}")
        close_sum(table, idx, f"misaligned width {cols}")
    # indices outside the table clip to its first and last rows
    far = [-2 ** 31, -1000, -1, 0, 999, 1000, 1001, 2 ** 31 - 1]
    idx = torch.tensor(far * 1025, dtype=torch.int32, device=dev)
    for cols in (8, 128):
        table = rand_table(1000, cols)
        same_gather(table, idx, f"out-of-range indices, width {cols}")
        close_sum(table, idx, f"out-of-range indices, width {cols}")

    # back-to-back launches against the same launches one at a time: both
    # kernels are launched with PDL, and a read or write placed before their
    # griddepcontrol.wait would show here
    tab3, idx3 = ga.b3_inputs(dev)
    check(torch.equal(ga.b3_loop(ga.row_gather_sum, tab3, idx3),
                      ga.b3_loop(ga.row_gather_sum, tab3, idx3, sync=True)),
          f"B3's {ga.B3_STEPS}-launch loop back to back == synchronised after every launch")
    t0 = rand_table(8192, 8)
    cidx = torch.from_numpy(g.integers(0, 8192, 65536, dtype=np.int32)).to(dev)

    def chain(sync: bool):
        x = t0
        for _ in range(24):
            x = ga.row_gather_sum(x, cidx).view(8192, 8)  # the next launch's table
            if sync:
                torch.cuda.synchronize()
        return x

    check(torch.equal(chain(False), chain(True)),
          "24 launches, each summing the previous one's output as its table: back to "
          "back == synchronised after every launch")
    for rows in ga.B5_ROWS:
        table, idx1 = ga.b5_inputs(rows, dev)
        check(torch.equal(ga.b5_loop(ga.row_gather, table, idx1),
                          ga.b5_loop(ga.row_gather, table, idx1, sync=True)),
              f"B5's {ga.B5_ITERS}-launch loop at R={rows} back to back == synchronised "
              "after every launch")
    for cols in (8, 128):
        t1 = rand_table(8192, cols)

        def gather_chain(sync: bool):
            x = t1
            for _ in range(24):
                x = ga.row_gather(x, cidx[:8192])   # the next launch's table
                if sync:
                    torch.cuda.synchronize()
            return x

        check(torch.equal(gather_chain(False), gather_chain(True)),
              f"24 row_gather launches at width {cols}, each gathering from the previous "
              "one's output: back to back == synchronised after every launch")

    held = kernel_times(dev, [n for n in RUNS if n.startswith("row_gather")])
    out = {}
    for what, table, idx in ga.probe_shapes(dev):
        same_gather(table, idx, what)
        close_sum(table, idx, what)
        rows_touched = int(torch.unique(idx).numel())
        n, c = idx.numel(), table.shape[1]
        gbd = bound(ga.row_gather_bytes(table, idx), {})
        sbd = bound(4 * n + rows_touched * c * 4 + n * 4, {"dispatch": n * c})
        gm, g_ev = {**gbd, "ms": held[f"row_gather {what}"]}, {}
        sm_ms = held.get(f"row_gather_sum {what}")
        if sm_ms is None:        # a shape kernel_times does not take
            sm_ms = held_ms(lambda: ga.row_gather_sum(table, idx), 100)[0]
        sm, sm_ev = {**sbd, "ms": sm_ms, "library_ms": None}, {}
        hows = set()
        for d, ev, key, fn in (
                (gm, g_ev, "plain_ms", lambda: ga.row_gather_reference(table, idx)),
                (gm, g_ev, "library_ms", lambda: torch.index_select(table, 0, idx)),
                (sm, sm_ev, "plain_ms", lambda: ga.row_gather_sum_reference(table, idx))):
            d[key], ev[key], how = times(fn, 100)
            hows.add(how)
        print(f"  {what} table {tuple(table.shape)} x {n:,}, ms device "
              f"({', '.join(sorted(hows))}; by events in brackets): "
              f"row_gather {gm['ms']:.4f} (held only; {gm['ms'] - launch_gap_ms():.4f} above "
              f"the launch gap), plain {gm['plain_ms']:.4f} "
              f"({g_ev['plain_ms']:.4f}), index_select {gm['library_ms']:.4f} "
              f"({g_ev['library_ms']:.4f}), bound {gm['bound_ms']:.4f}; row_gather_sum "
              f"{sm['ms']:.4f} (held only), plain {sm['plain_ms']:.4f} "
              f"({sm_ev['plain_ms']:.4f}), bound {sm['bound_ms']:.4f} "
              f"({sm['bound_ms'] / sm['ms']:.0%} of it, bytes at the HBM rate while the "
              f"table sits in L2), over index_select "
              f"{sm['ms'] / gm['library_ms']:.3f}; launch gap {launch_gap_ms():.4f} ({card})")
        out[what] = (gm, sm)

    print("  gather probes path: probes.gather.run_probes()")
    torch.cuda.synchronize()
    zero_counts()
    res = ga.run_probes("cuda")
    counts = read_counts("probes path (gather)", ["row_gather", "row_gather_sum"])
    for what, r in res.items():
        check(r["correct"], f"{what} probe correct; " + ", ".join(
            f"{k} {v:.4f}" for k, v in r.items() if k != "correct") + f" ({card})")
    # the JSON line reports B6's larger shape for row_gather, B3's for the sum
    return {"row_gather": {"max_abs_err": gather_err, "launches": counts["row_gather"],
                           **out[f"B6 B={ga.B6_BS[-1]}"][0]},
            "row_gather_sum": {"max_abs_err": sum_err, "launches": counts["row_gather_sum"],
                               **out["B3"][1]}}


def phase_props(card: str, profile_dir: Optional[Path]) -> dict:
    import tempfile

    import torch
    from fast_monte_carlo_tpu_torch import edge, fixtures
    from fast_monte_carlo_tpu_torch.api import MatchupRunner
    from fast_monte_carlo_tpu_torch.config import SimConfig
    from fast_monte_carlo_tpu_torch.ops import rng
    from fast_monte_carlo_tpu_torch.stats import (PC_ATT, PC_COMP, PC_TD, PC_YDS, ROLE_LABEL,
                                                  ROLE_PASS, ROLE_REC, ROLE_RUSH,
                                                  TEAM_STAT_FIELDS, TS)

    cfg = SimConfig()
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, rng_impl="pallas_chunk"))
    a, b = fixtures.focus_teams(FOCUS_SEED)
    tables = fixtures.nano_tables(TABLE_SEED)
    runner = MatchupRunner(a, b, None, cfg, mode="table", nano_tables=tables, device="cuda")

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = runner.run_pairs(PROPS_PAIRS, seed=11, collect_players=True, collect_stats=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts("props path", ["nano_game", "nano_game_props"])
    check(counts["nano_game_props"] == 1 and counts["philox_draws"] == 0,
          f"props path: one K1 launch with the collectors ({counts['nano_game_props']}) and "
          f"no philox_draws launch ({counts['philox_draws']})")
    n = 2 * PROPS_PAIRS
    st, ps = out.stats, out.pstats
    print(f"  props path: run_pairs({PROPS_PAIRS:,}) -> {n:,} games in {dt:.3f} s, "
          f"first call ({card})")
    check(tuple(st.shape) == (n, 2, 19) and tuple(ps.shape) == (n, 2, 3, 8, 6),
          f"stats {tuple(st.shape)}, pstats {tuple(ps.shape)}")
    check(torch.equal(st[:, :, TS["points"]], out.score.float()),
          "points column == final score on both sides")
    check(not bool(torch.isnan(st).any() or torch.isnan(ps).any()), "no NaN in stats, pstats")
    check(bool((st[..., TS["comp"]] <= st[..., TS["pass_att"]]).all()), "comp <= pass_att")
    # a sacked pass play is a target in the JAX package (wr_delta's is_pass)
    for role, team, what in ((ROLE_PASS, st[..., TS["pass_att"]], "QB attempts <= pass_att"),
                             (ROLE_RUSH, st[..., TS["rush_att"]], "rush_att <= team rush_att"),
                             (ROLE_REC, st[..., TS["pass_att"]] + st[..., TS["sacks"]],
                              "targets <= pass_att + sacks")):
        check(bool((ps[:, :, role, :, PC_ATT].sum(-1) <= team).all()),
              f"tracked players' {what}")
    for role, td in ((ROLE_PASS, "pass_td"), (ROLE_RUSH, "rush_td"), (ROLE_REC, "pass_td")):
        check(bool((ps[:, :, role, :, PC_TD].sum(-1) <= st[..., TS[td]]).all()),
              f"{ROLE_LABEL[role]} TDs <= team {td}, both teams")
    check(bool((ps[:, :, ROLE_REC, :, PC_ATT] >= ps[:, :, ROLE_REC, :, PC_COMP]).all()),
          "tgt >= rec in every slot")
    check(float(ps[..., PC_ATT].sum()) > 0, "tracked players accrued")
    mean = st.double().mean(0).cpu().numpy()
    print("  mean box score (A; B): " + "; ".join(
        ", ".join(f"{f} {mean[i, TS[f]]:.2f}" for f in TEAM_STAT_FIELDS) for i in (0, 1)))

    # the same games on the card and on the CPU
    cpu = MatchupRunner(a, b, None, cfg, mode="table", nano_tables=tables, device="cpu")
    got, want = (r.run_pairs(CROSS_PAIRS, seed=12) for r in (runner, cpu))
    agree = np.ones(2 * CROSS_PAIRS, bool)
    for f in ("off", "sec", "down", "period", "in_rz", "going", "score", "stats", "pstats"):
        x, y = getattr(got, f).cpu().numpy(), getattr(want, f).numpy()
        if f == "stats":
            x, y = np.delete(x, [TS["pass_yds"], TS["rush_yds"]], -1), \
                np.delete(y, [TS["pass_yds"], TS["rush_yds"]], -1)
        elif f == "pstats":
            x, y = np.delete(x, PC_YDS, -1), np.delete(y, PC_YDS, -1)
        eq = x == y
        agree &= eq.reshape(eq.shape[0], -1).all(1)
    check(agree.mean() >= 0.995, f"CUDA vs CPU, {2 * CROSS_PAIRS:,} games: integer state "
          f"and every count equal in {int(agree.sum()):,} (>= 99.5%)")
    yards = [(got.stats[..., [TS["pass_yds"], TS["rush_yds"]]],
              want.stats[..., [TS["pass_yds"], TS["rush_yds"]]]),
             (got.pstats[..., PC_YDS], want.pstats[..., PC_YDS])]
    worst = max(float((x.cpu()[agree] - y[agree]).abs().max()) for x, y in yards)
    check(all(np.allclose(x.cpu().numpy()[agree], y.numpy()[agree], rtol=1e-5, atol=1e-3)
              for x, y in yards), f"yards allclose there (max|d| {worst:.3g})")

    # the prop reduction on the card against the CPU, over the same pstats
    idx, meta = edge.resolve_prop_rows(a, b, fixtures.prop_rows(PROP_SEED))
    red_g = edge.reduce_props_device(out.pstats, idx)
    red_c = edge.reduce_props_device(out.pstats.cpu(), idx)
    for k in ("p_over", "p_under", "push", "n_active"):
        check(torch.equal(red_g[k].cpu(), red_c[k]), f"reduce_props {k}: card == CPU")
    for k in ("mean", "median", "p75", "p90"):
        x, y = red_g[k].cpu(), red_c[k]
        rel = float(((x - y).abs() / y.abs().clamp_min(1.0)).max())
        check(rel <= 1e-5, f"reduce_props {k}: card vs CPU within 1e-5 ({rel:.3g})")
    with tempfile.TemporaryDirectory() as d:
        sheet = str(Path(d) / "props.csv")
        fixtures.write_csv(sheet, fixtures.prop_rows(PROP_SEED), fixtures.PROP_COLS)
        rows = edge.scan_props_rows(out, a, b, sheet, min_abs_edge_pct=0.0)
    check(len(rows) == len(meta) == len(fixtures.prop_rows(PROP_SEED)) - 3,
          f"scan_props_rows priced all {len(meta)} resolvable rows of the sheet")
    check(all(0 <= r["p_over"] and r["p_over"] + r["p_under"] <= 1 for r in rows),
          "0 <= p_over, p_over + p_under <= 1 in every row")
    top = rows[0]
    print(f"  best prop: {top['player']} {top['stat']} {top['line']} {top['best_side']}, "
          f"p_over {top['p_over']}, edge {top['edge_pct']}%, EV {top['ev_$100']} per $100")

    # 65,536-game launches, props path and score-only in turns
    pairs = LAUNCH_GAMES // 2
    variants = {"props": dict(collect_players=True, collect_stats=True),
                "score-only": dict(collect_players=False, collect_stats=False)}
    secs = {v: [] for v in variants}
    peak = {}
    before = engine_launches()
    for i, v in enumerate(("score-only", "props", "props", "score-only")):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        big = runner.run_pairs(pairs, seed=13, **variants[v])
        torch.cuda.synchronize()
        secs[v].append(time.perf_counter() - t0)
        peak[v] = torch.cuda.max_memory_allocated() / 2 ** 20
        if i == 1:
            # the reduction at 65,536 games: one quantile call (under the
            # 2^24 elements a call at which reduce_props_device splits columns)
            red_g = edge.reduce_props_device(big.pstats, idx)
            red_c = edge.reduce_props_device(big.pstats.cpu(), idx)
            check(all(torch.equal(red_g[k].cpu(), red_c[k]) for k in ("p_over", "n_active")),
                  f"reduce_props at {LAUNCH_GAMES:,} x {len(idx[0])}: p_over, n_active "
                  "card == CPU")
            del red_g, red_c
        del big            # so no launch's peak holds the one before it
    used = launches_since(before)
    check(used == {"K4": 0, "K1": 4, "K3": 0}, f"the timed turns: one K1 launch each and no "
          f"philox_draws launch ({used})")
    # whether torch takes a quantile call past 2^24 elements on the card
    wide = torch.rand(LAUNCH_GAMES, 257, device="cuda")
    try:
        torch.nanquantile(wide, torch.tensor([0.5], device="cuda"), dim=0)
        took = "takes"
    except RuntimeError as e:
        took = f"refuses ({str(e).splitlines()[0]})"
    print(f"  torch.nanquantile {took} a ({LAUNCH_GAMES:,}, 257) = {wide.numel():,}-element "
          f"input on the card")
    gps = {v: [LAUNCH_GAMES / x for x in s] for v, s in secs.items()}
    for v in variants:
        print(f"  {v}: {LAUNCH_GAMES:,}-game launches "
              f"{', '.join(f'{x:,.0f}' for x in gps[v])} games/s, peak device memory "
              f"{peak[v]:,.1f} MiB ({card})")
    ratio = sum(gps["props"]) / sum(gps["score-only"])
    print(f"  props / score-only games/s: {ratio:.3f}")
    res = {"launches": counts["philox_draws"], "games_per_s": gps, "peak_mib": peak}
    if profile_dir is not None:
        lines = [card]
        for v, kw in variants.items():
            launches0 = rng.philox_draws.launches
            k, dev_ms, wall_ms, table = profile_kernels(
                lambda: runner.run_pairs(pairs, seed=14, **kw))
            plays = (rng.philox_draws.launches - launches0) * cfg.engine.play_chunk
            if plays == 0:       # K1, one launch and no play chunk, props too
                lines += [f"{v}: {k} device kernels a launch (K1), {dev_ms:.3f} ms device "
                          f"time, {wall_ms:.3f} ms wall profiled", table]
                print(f"  profile, {v}: {k} device kernels a launch (K1), {dev_ms:.4f} ms "
                      "device time")
                continue
            res[f"kernels_per_play_{v}"] = k / plays
            lines += [f"{v}: {k} device kernels over {plays} plays ({k / plays:.1f} a play), "
                      f"{dev_ms:.3f} ms device time, {wall_ms:.3f} ms wall profiled", table]
            print(f"  profile, {v}: {k / plays:.1f} device kernels per play, "
                  f"{dev_ms / plays:.4f} ms device time per play")
        profile_dir.mkdir(parents=True, exist_ok=True)
        (profile_dir / "profile_props.txt").write_text("\n\n".join(lines) + "\n")
    return res


def phase_live(card: str, profile_dir: Optional[Path]) -> dict:
    import torch
    from fast_monte_carlo_tpu_torch import api, edge, fixtures
    from fast_monte_carlo_tpu_torch.api import MatchupRunner
    from fast_monte_carlo_tpu_torch.config import SimConfig
    from fast_monte_carlo_tpu_torch.models import analytic
    from fast_monte_carlo_tpu_torch.ops import game, rng

    cfg = SimConfig()                      # rng_impl "threefry": the Philox stream
    check(cfg.engine.rng_impl == "threefry", "SimConfig() keeps rng_impl='threefry'")
    a, b = fixtures.teams()
    tables = fixtures.nano_tables(TABLE_SEED)
    runner = MatchupRunner(a, b, None, cfg, mode="table", nano_tables=tables, device="cuda")
    score_only = dict(collect_players=False, collect_stats=False)
    q4 = api.situation_from_fields(ytg=40, offense="A", quarter=4, clock="05:00", down=2,
                                   dist=7, score_a=21, score_b=17)
    kick = game.Situation(0, cfg.clock.game_seconds, 1, cfg.opening_distance,
                          cfg.kickoff_spot, 0, 0)
    fourth = q4._replace(down=4, dist=3.0, ytg=35.0)

    def sim(r, n, key, **kw):
        return game.simulate_games(r.pack, r.cfg, r.heads_fn, r.heads_state, key, n, 0,
                                   **score_only, **kw)

    torch.cuda.synchronize()
    # the kickoff situation's starting state, against one built from the config
    n = LIVE_KICK_GAMES
    start = game.state_from_situation(n, kick, cfg, "cuda", 0, None, **score_only)
    i32 = dict(dtype=torch.int32, device="cuda")

    def full(v, dtype=torch.int32):
        return torch.full((n,), v, dtype=dtype, device="cuda")

    built = game.GameState(
        gid=full(0), fo=full(0), off=full(0), sec=full(cfg.clock.game_seconds), down=full(1),
        dist=full(cfg.opening_distance, torch.float32),
        ytg=full(cfg.kickoff_spot, torch.float32), period=full(1),
        in_rz=full(False, torch.bool), going=full(False, torch.bool),
        score=torch.zeros((n, 2), **i32),
        stats=torch.zeros((n, 1, 1), dtype=torch.float32, device="cuda"),
        pstats=torch.zeros((n, 1, 1, 1, 1), dtype=torch.float32, device="cuda"))
    same = [f for f in game.GameState._fields
            if getattr(start, f).dtype == getattr(built, f).dtype
            and torch.equal(getattr(start, f), getattr(built, f))]
    check(len(same) == len(game.GameState._fields),
          f"kickoff situation, {n:,} games: starting state equal to one built field by field "
          f"from the config ({len(same)} of {len(game.GameState._fields)})")
    # the situation= route plays the games of a kickoff start (a plumbing smoke)
    key = rng.root_key(41)
    got = sim(runner, LIVE_KICK_GAMES, key, situation=kick)
    want = sim(runner, LIVE_KICK_GAMES, key)
    same = [f for f in game.GameState._fields if torch.equal(getattr(got, f), getattr(want, f))]
    check(len(same) == len(game.GameState._fields),
          f"situation=kickoff, {LIVE_KICK_GAMES:,} games: every field equal to a kickoff "
          f"start with the same key ({len(same)} of {len(game.GameState._fields)})")

    # the same live games on the card and on the CPU
    cpu = MatchupRunner(a, b, None, cfg, mode="table", nano_tables=tables, device="cpu")
    key = rng.root_key(42)
    got = sim(runner, CROSS_PAIRS * 2, key, situation=q4)
    want = sim(cpu, CROSS_PAIRS * 2, key, situation=q4)
    agree = np.ones(2 * CROSS_PAIRS, bool)
    for f in ("off", "sec", "down", "period", "in_rz", "going", "score"):
        eq = getattr(got, f).cpu().numpy() == getattr(want, f).numpy()
        agree &= eq.reshape(eq.shape[0], -1).all(1)
    check(agree.mean() >= 0.995, f"Q4 05:00 live games, CUDA vs CPU: integer state equal in "
          f"{int(agree.sum()):,} of {2 * CROSS_PAIRS:,} (>= 99.5%)")

    # the forced field goal with one play left: a closed form
    n = LIVE_GAMES
    before = engine_launches()
    fg = runner.run_fourth_decision(game.Situation(0, 5, 4, 10.0, 20.0, 0, 0), n_games=n,
                                    seed=3, choices=("fg",))["fg"]
    used = launches_since(before)
    p_fg = float(analytic.field_goal_prob(torch.tensor(20.0 + cfg.st.fg_snap_plus_endzone),
                                          cfg))
    win_a, tie = float(fg.win_rate[0]), float(fg.tie_rate)
    se = (p_fg * (1 - p_fg) / n) ** 0.5
    check(abs(win_a - p_fg) < 4 * se, f"forced FG, 5 s left at the 20: win_a {win_a:.5f} vs "
          f"P(make) {p_fg:.4f} within 4 s.e. {se:.5f}")
    check(abs(tie - (1 - win_a)) < 1e-6 and float(fg.mean_pts[1]) == 0.0,
          f"forced FG: tie {tie:.5f} == 1 - win_a, B scores 0")
    check(used == {"K3": 0, "K4": 0, "K1": 1}, f"forced FG: the forced play and the rest of "
          f"the games in one K1 launch, no philox_draws launch ({used})")

    # the win-probability curve against each situation alone
    curve = live_curve_situations(cfg)
    batch = runner.run_live_batch(curve, n_games_per=CURVE_PER, seed=5)
    check(batch.n.tolist() == [float(CURVE_PER)] * len(curve),
          f"run_live_batch: n == {CURVE_PER:,} in each of {len(curve)} rows")
    worst = 0.0
    for i, sit in list(enumerate(curve))[::CURVE_ALONE_STEP]:
        alone = runner.run_live(sit, n_games=CURVE_PER, seed=50 + i)
        gw, aw = float(batch.win_rate[i, 0]), float(alone.win_rate[0])
        se = ((gw * (1 - gw) + aw * (1 - aw)) / CURVE_PER) ** 0.5
        worst = max(worst, abs(gw - aw) / max(se, 1e-9))
        check(abs(gw - aw) <= 4 * se + 1e-9 and float(alone.n) == CURVE_PER,
              f"curve row {i} (sec {sit.sec}, {sit.score_a}-{sit.score_b}): win_a {gw:.4f} "
              f"vs run_live alone {aw:.4f} within 4 s.e. {se:.4f}")
    print(f"  curve rows against run_live: largest gap {worst:.2f} s.e.")

    # antithetic draws: unbiased against the plain run
    anti_cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, antithetic=True))
    anti = MatchupRunner(a, b, None, anti_cfg, mode="table", nano_tables=tables, device="cuda")
    margins = {}
    for what, r in (("antithetic", anti), ("plain", runner)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = r.run_pairs(LIVE_GAMES // 2, seed=7, **score_only)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(bool((out.sec == 0).all()), f"{what}: all {LIVE_GAMES:,} games finished "
              f"in {ms:.1f} ms ({card})")
        margins[what] = (out.score[:, 0] - out.score[:, 1]).double()
    ma, mp = margins["antithetic"], margins["plain"]
    se = float((ma.var() / ma.numel() + mp.var() / mp.numel()) ** 0.5)
    check(abs(float(ma.mean() - mp.mean())) <= 4 * se,
          f"antithetic mean margin {float(ma.mean()):.4f} vs plain {float(mp.mean()):.4f} "
          f"within 4 s.e. {se:.4f}")

    # the rng names: one stream
    scores = {}
    for name in ("threefry", "rbg", "pallas_chunk"):
        c = cfg.replace(engine=dataclasses.replace(cfg.engine, rng_impl=name))
        r = MatchupRunner(a, b, None, c, mode="table", nano_tables=tables, device="cuda")
        scores[name] = r.run_pairs(CROSS_PAIRS, seed=9, **score_only).score
    check(all(torch.equal(x, scores["pallas_chunk"]) for x in scores.values()),
          f"threefry, rbg and pallas_chunk: the same scores for one key "
          f"({2 * CROSS_PAIRS:,} games)")

    # a live market priced from a summary reduced on the card
    s = runner.run_live(q4, n_games=LIVE_GAMES, seed=11)
    book = edge.market_odds_from_summary(s, a.name, b.name, spread=-3.5, total=44.5)
    ml = edge.summary_moneyline(s, a.name, b.name)
    sp, tot = book["spread"], book["total"]
    check(abs(sp["p_cover"] + sp["p_notcover"] + sp["push_rate"] - 1) < 1e-5
          and abs(tot["p_over"] + tot["p_under"] + tot["push_rate"] - 1) < 1e-5
          and abs(ml["team"]["p_win"] - float(s.win_rate[0])) < 1e-5,
          f"Q4 05:00 live market: cover {sp['p_cover']} at -3.5, over {tot['p_over']} at "
          f"44.5, moneyline {ml['team']['ml_fair']}/{ml['opp']['ml_fair']}")

    # timed queries, each after one warm-up of its own
    queries = {
        f"run_live Q4 05:00, {LIVE_GAMES:,} games": lambda: runner.run_live(q4, n_games=LIVE_GAMES),
        f"run_live kickoff, {LIVE_GAMES:,} games": lambda: runner.run_live(kick, n_games=LIVE_GAMES),
        f"run_live_batch {len(curve)} x {CURVE_PER:,}":
            lambda: runner.run_live_batch(curve, n_games_per=CURVE_PER),
        f"run_fourth_decision 4th-and-3 at the 35, {LIVE_GAMES:,} games x 4":
            lambda: runner.run_fourth_decision(fourth, n_games=LIVE_GAMES),
    }
    res = {}
    torch.cuda.synchronize()
    zero_counts()
    for what, fn in queries.items():
        res[what] = timed_query(what, fn, LIVE_REPS, card)[1]
    counts = read_counts("live queries", ["nano_game", "nano_game_forced", "score_moments"])
    check(counts["philox_draws"] == 0 and counts["nano_game_forced"] == 3 * (LIVE_REPS + 1),
          f"live queries: the three forced 4th-down choices ran in K1 "
          f"({counts['nano_game_forced']} forced launches), philox_draws launched "
          f"{counts['philox_draws']} times (0 allowed: no eager forced play)")
    res["launches"] = counts["philox_draws"]
    if profile_dir is not None:
        lines = [card]
        for what, fn in list(queries.items())[:2]:
            before = engine_launches()
            k, dev_ms, wall_ms, table = profile_kernels(fn)
            used = launches_since(before)
            line = (f"{what}: {k} device kernels ({used}), {dev_ms:.3f} ms device time, "
                    f"busy share {dev_ms / min(res[what]['ms']):.4f} "
                    f"of the fastest unprofiled query")
            lines += [line, table]
            print(f"  profile, {line}")
        profile_dir.mkdir(parents=True, exist_ok=True)
        (profile_dir / "profile_live.txt").write_text("\n\n".join(lines) + "\n")
    return res


def check_slate_summaries(per_game, n: int, what: str, band=(10, 50)) -> None:
    """Each matchup's host summary: n exact, win + win + tie = 1, mean
    points inside `band`, every histogram summing to n, no NaN."""
    ns = np.array([float(s.n) for s in per_game])
    win = np.array([s.win_rate for s in per_game], dtype=np.float64)
    tie = np.array([float(s.tie_rate) for s in per_game])
    mean = np.array([s.mean_pts for s in per_game], dtype=np.float64)
    sd = np.array([s.sd_pts for s in per_game], dtype=np.float64)
    g = len(per_game)
    check(bool((ns == n).all()), f"{what}: n == {n:,} in each of {g} matchups")
    check(float(np.abs(win.sum(1) + tie - 1).max()) < 1e-5,
          f"{what}: win + win + tie == 1 in every matchup")
    check(bool(((mean > band[0]) & (mean < band[1])).all()),
          f"{what}: mean points in {band} (from {mean.min():.2f} to {mean.max():.2f})")
    check(all(int(s.margin_hist.sum()) == n and int(s.total_hist.sum()) == n
              and bool((s.pts_hist.sum(axis=1) == n).all()) for s in per_game),
          f"{what}: margin, total and points histograms sum to n in every matchup")
    check(all(np.isfinite(x).all() for x in (win, tie, mean, sd)),
          f"{what}: no NaN in the summaries")


def phase_slate(card: str, profile_dir: Optional[Path]) -> dict:
    import io
    from contextlib import redirect_stdout

    import torch
    from fast_monte_carlo_tpu_torch import api, edge, fixtures
    from fast_monte_carlo_tpu_torch.config import SimConfig
    from fast_monte_carlo_tpu_torch.ops import rng

    cfg = SimConfig()                      # rng_impl "threefry": the Philox stream
    t0 = time.perf_counter()
    matchups, tables = fixtures.slate(SLATE_GAMES, SLATE_SEED)
    sr = api.SlateRunner(matchups, None, cfg, game_shard=True, nano_tables=tables,
                         device="cuda")
    torch.cuda.synchronize()
    table_mb = sr.heads_state.nano_values.numel() * 4 / 1e6
    print(f"  {SLATE_GAMES} matchups built and packed in {time.perf_counter() - t0:.2f} s; "
          f"nano table {tuple(sr.heads_state.nano_values.shape)} f32, {table_mb:,.1f} MB")
    games = [(a.name, b.name) for a, b in matchups]

    t0 = time.perf_counter()               # warm-up: one launch
    sr.run_summary_rows(SLATE_CHUNK, seed=99, chunk_pairs=SLATE_CHUNK)
    warm_s = time.perf_counter() - t0
    pairs = SLATE_PAIRS if warm_s * SLATE_PAIRS / SLATE_CHUNK <= SLATE_CUT_S else SLATE_CHUNK
    launches = -(-pairs // SLATE_CHUNK)
    n = 2 * SLATE_CHUNK * launches
    print(f"  warm-up launch ({SLATE_GAMES} x {2 * SLATE_CHUNK:,} games) {warm_s:.3f} s; "
          f"timing {launches} launch(es), {n:,} games a matchup")

    torch.cuda.synchronize()
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows, per_game = sr.run_summary_rows(pairs, seed=0, chunk_pairs=SLATE_CHUNK)
    dt = time.perf_counter() - t0            # ends in the host copy of the summaries
    counts = read_counts("slate path", ["nano_game", "score_moments"])
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    check_slate_summaries(per_game, n, f"slate, {SLATE_GAMES} x {n:,} games")
    check(all(r["n_games"] == n for r in rows) and len(rows) == SLATE_GAMES,
          f"{SLATE_GAMES} summary rows, n_games {n:,} each")
    gps = SLATE_GAMES * n / dt
    print(f"  slate (one launch a chunk): {SLATE_GAMES * n:,} games in {dt:.3f} s -> "
          f"{gps:,.0f} games/s, {1000 * dt / launches:.1f} ms per "
          f"{SLATE_GAMES * 2 * SLATE_CHUNK:,}-game launch, "
          f"{counts['nano_game'] / launches:.0f} K1 launch(es) a launch, peak device memory "
          f"{peak:,.1f} MiB ({card})")
    res = {"launches": counts["philox_draws"], "games_per_s": gps, "seconds": dt,
           "peak_mib": peak, "launch_ms": 1000 * dt / launches}

    # one launch at the JAX package's default chunk_pairs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, big = sr.run_summary_rows(SLATE_BIG_CHUNK, seed=1, chunk_pairs=SLATE_BIG_CHUNK)
    big_s = time.perf_counter() - t0
    big_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    check_slate_summaries(big, 2 * SLATE_BIG_CHUNK,
                          f"slate, one launch of {SLATE_GAMES} x {2 * SLATE_BIG_CHUNK:,}")
    big_n = SLATE_GAMES * 2 * SLATE_BIG_CHUNK
    print(f"  one launch at chunk_pairs {SLATE_BIG_CHUNK:,}: {big_n:,} games in {big_s:.3f} s "
          f"-> {big_n / big_s:,.0f} games/s, peak device memory {big_peak:,.1f} MiB ({card})")
    res.update(big_games_per_s=big_n / big_s, big_peak_mib=big_peak)
    del big

    # the draw kernel at that launch's shape, on slices of rows
    key, dev = rng.fold_in(rng.root_key(6), 2), torch.device("cuda")
    u, z = rng.chunk_draws(key, 48, CH, big_n, dev)
    worst, w = 0.0, min(4096, big_n // 2)
    for r0 in (0, big_n // 2 - w // 3, big_n - w):
        ur, zr = rng.philox_draws_reference(key, 48, CH, w, dev, row0=r0)
        err = float((z[:, r0:r0 + w] - zr).abs().max())
        worst = max(worst, err)
        check(torch.equal(u[:, r0:r0 + w], ur) and err <= 1e-5,
              f"philox_draws ({CH}, {big_n:,}), rows {r0:,}..{r0 + w - 1:,}: uniforms "
              f"bitwise, normals max|d| {err:.3g} <= 1e-5")
    ms = cuda_ms(lambda: rng.chunk_draws(key, 48, CH, big_n, dev, out=(u, z)), 5)
    bd = draw_bound(CH, big_n)
    print(f"  philox_draws ({CH}, {big_n:,}): {ms:.4f} ms by events, bound "
          f"{bd['bound_ms']:.4f} ms ({bd['bound_class']}; {bd['bound_ms'] / ms:.0%}) ({card})")
    res.update(draw_ms=ms, draw_bound_ms=bd["bound_ms"], draw_err=worst)
    del u, z

    # the same slate games on the card and on the CPU
    sub = slice(0, SLATE_CROSS_GAMES)
    outs = [api.SlateRunner(matchups[sub], None, cfg, nano_tables=tables[sub],
                            device=d).run(CROSS_PAIRS, seed=12) for d in ("cuda", "cpu")]
    agree = np.ones(SLATE_CROSS_GAMES * 2 * CROSS_PAIRS, bool)
    for f in ("gid", "fo", "off", "sec", "down", "period", "in_rz", "going", "score"):
        eq = getattr(outs[0], f).cpu().numpy() == getattr(outs[1], f).numpy()
        agree &= eq.reshape(eq.shape[0], -1).all(1)
    check(agree.mean() >= 0.995, f"slate {SLATE_CROSS_GAMES} x {2 * CROSS_PAIRS:,} games, "
          f"CUDA vs CPU: integer state equal in {int(agree.sum()):,} (>= 99.5%)")
    del outs

    # the loop layout against one launch, on the first LOOP_GAMES matchups
    sub = slice(0, LOOP_GAMES)
    loop_kw = dict(contexts=matchups[sub], nano_tables=tables[sub], n_pairs=LOOP_PAIRS,
                   chunk_pairs=LOOP_PAIRS, layout="loop", device="cuda")
    api.simulate_slate_summary_rows(games[sub], seed=97, **loop_kw)     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, loop = api.simulate_slate_summary_rows(games[sub], seed=3, **loop_kw)
    loop_s = time.perf_counter() - t0
    one = api.SlateRunner(matchups[sub], None, cfg, game_shard=True, nano_tables=tables[sub],
                          device="cuda")
    one.run_summary_rows(LOOP_PAIRS, seed=96, chunk_pairs=LOOP_PAIRS)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, once = one.run_summary_rows(LOOP_PAIRS, seed=4, chunk_pairs=LOOP_PAIRS)
    once_s = time.perf_counter() - t0
    m = 2 * LOOP_PAIRS
    check_slate_summaries(loop, m, f"loop layout, {LOOP_GAMES} x {m:,}")
    gap = 0.0
    for gi, (x, y) in enumerate(zip(loop, once)):
        for side in (0, 1):
            p, q = float(x.win_rate[side]), float(y.win_rate[side])
            se_w = ((p * (1 - p) + q * (1 - q)) / m) ** 0.5
            se_m = ((float(x.sd_pts[side]) ** 2 + float(y.sd_pts[side]) ** 2) / m) ** 0.5
            d_m = abs(float(x.mean_pts[side]) - float(y.mean_pts[side]))
            gap = max(gap, abs(p - q) / se_w, d_m / se_m)
            check(abs(p - q) <= 4 * se_w and d_m <= 4 * se_m,
                  f"matchup {gi} side {side}: loop win {p:.4f} / one launch {q:.4f} within 4 "
                  f"s.e. {se_w:.4f}; mean points {d_m:.3f} apart, 4 s.e. {4 * se_m:.3f}")
    print(f"  loop layout, {LOOP_GAMES} x {m:,} games: {loop_s:.3f} s -> "
          f"{LOOP_GAMES * m / loop_s:,.0f} games/s (a launch a matchup: the rate does not "
          f"depend on the matchup count); one launch of the same games {once_s:.3f} s -> "
          f"{LOOP_GAMES * m / once_s:,.0f} games/s; largest gap {gap:.2f} s.e. ({card})")
    res.update(loop_games_per_s=LOOP_GAMES * m / loop_s,
               one_launch_g4_games_per_s=LOOP_GAMES * m / once_s)

    # the slate's markets, by name and by position
    lines = fixtures.slate_lines(rows, SLATE_SEED)
    t0 = time.perf_counter()
    table = edge.slate_market_rows(matchups, per_game, lines)
    price_ms = (time.perf_counter() - t0) * 1e3
    positional = edge.slate_market_rows(
        matchups, per_game, [{k: v for k, v in r.items() if k != "team_a"} for r in lines])
    check(len(table) == SLATE_GAMES and sum("spread" in r for r in table) == SLATE_GAMES
          and sum("total" in r for r in table) == SLATE_GAMES - 1,
          f"slate_market_rows priced all {SLATE_GAMES} games (spreads {SLATE_GAMES}, totals "
          f"{SLATE_GAMES - 1}: one left out) in {price_ms:.1f} ms on the host")
    check(table == positional, "lines matched by team_a == the same lines by position")
    check(all(abs(r["p_win_a"] - float(s.win_rate[0])) < 1e-6
              and abs(r["p_win_a"] + r["p_win_b"] + float(s.tie_rate) - 1) < 1e-5
              and 0 <= r["p_cover_a"] <= 1 for r, s in zip(table, per_game)),
          "every row: moneyline p_win_a == the summary's win rate, p_win_a + p_win_b + tie "
          "== 1, 0 <= p_cover_a <= 1")
    buf = io.StringIO()
    with redirect_stdout(buf):
        edge.print_slate_edges(table)
    print("\n".join("  | " + x for x in buf.getvalue().strip().splitlines()[:9]))
    res["price_ms"] = price_ms

    if profile_dir is not None:
        before = engine_launches()
        k, dev_ms, wall_ms, tab = profile_kernels(
            lambda: sr.run_summary_rows(SLATE_CHUNK, seed=5, chunk_pairs=SLATE_CHUNK))
        line = (f"one slate launch ({SLATE_GAMES} x {2 * SLATE_CHUNK:,} games): {k} device "
                f"kernels ({launches_since(before)}), {dev_ms:.3f} ms device time, "
                f"{wall_ms:.3f} ms wall profiled, busy share {dev_ms / res['launch_ms']:.4f} "
                f"of an unprofiled launch ({res['launch_ms']:.1f} ms)")
        print(f"  profile, {line}")
        profile_dir.mkdir(parents=True, exist_ok=True)
        (profile_dir / "profile_slate.txt").write_text(f"{card}\n{line}\n\n{tab}\n")
        res.update(kernels_per_launch=k, device_ms=dev_ms, busy=dev_ms / res["launch_ms"])
    return res


def np_settle(score: np.ndarray, pstats: np.ndarray, arrays):
    """(B, L) win and push masks of resolved parlay legs, in numpy float32
    on the host: the settlement rule written out again, to hold the card's
    counts to."""
    src, side, role, slot, col, sgn, drn, thr = arrays
    margin = (score[:, 0] - score[:, 1]).astype(np.float32)
    total = score.sum(axis=1).astype(np.float32)
    game = np.where(src == 0, margin[:, None] * sgn, total[:, None])
    v = np.where(src == 2, pstats[:, side, role, slot, col], game).astype(np.float32)
    win = np.where(drn > 0, v > thr, v < thr)
    return win, np.abs(v - thr) <= np.float32(1e-9)


def timed_query(what: str, fn, reps: int, card: str):
    """One warm-up call of fn, then `reps` timed calls: ms a call on the
    host clock ending in a synchronize, and the engine's launches a call
    (`engine_launches`: K4 play chunks, K1 launches, K3 forced plays; the
    warm-up's where reps is 0).  Fails if any call launched neither K4 nor
    K1.  Returns the warm-up's result and the record."""
    import torch

    torch.cuda.synchronize()
    before, t0 = engine_launches(), time.perf_counter()
    first = fn()
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    calls, ms = [launches_since(before)], []
    for _ in range(reps):
        before, t0 = engine_launches(), time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        calls.append(launches_since(before))
    check(all(c["K4"] + c["K1"] > 0 for c in calls),
          f"{what}: every call launched the engine (K4 or K1) ({calls})")
    timed = (f"{', '.join(f'{x:.1f}' for x in ms)} ms per query after a {warm_ms:.1f} ms "
             "warm-up" if reps else f"one call, {warm_ms:.1f} ms")
    print(f"  {what}: {timed}; engine launches per query {calls[-1]} ({card})")
    return first, {"ms": ms, "warm_ms": warm_ms, "launches": calls[-1]}


def phase_multi(card: str, profile_dir: Optional[Path]) -> dict:
    import itertools

    import torch
    from fast_monte_carlo_tpu_torch import api, edge, fixtures
    from fast_monte_carlo_tpu_torch.api import MatchupRunner
    from fast_monte_carlo_tpu_torch.config import SimConfig
    from fast_monte_carlo_tpu_torch.ops import rng

    cfg = SimConfig()                      # rng_impl "threefry": the Philox stream
    a, b = fixtures.focus_teams(FOCUS_SEED)
    runner = MatchupRunner(a, b, None, cfg, mode="table",
                           nano_tables=fixtures.nano_tables(TABLE_SEED), device="cuda")
    slate, slate_tables = fixtures.focus_slate(SLATE_PROPS_GAMES, SLATE_PROPS_SEED)
    slate_games = [(x.name, y.name) for x, y in slate]
    sheet = fixtures.slate_prop_rows(SLATE_PROPS_GAMES, SLATE_PROPS_SEED)
    season_games, season_ctx, season_tables = fixtures.season(SEASON_GAMES, SEASON_SEED)
    team = season_games[0][0]
    sides = ["a" if ta == team else "b" for ta, _ in season_games]
    n = 2 * PARLAY_PAIRS
    per = 2 * SEASON_CHUNK * -(-SEASON_PAIRS // SEASON_CHUNK)

    pkw = dict(runner=runner, n_pairs=PARLAY_PAIRS, price=PARLAY_PRICE, correlations=True,
               round_robin=(2, 3))
    skw = dict(contexts=season_ctx, nano_tables=season_tables, n_pairs=SEASON_PAIRS,
               chunk_pairs=SEASON_CHUNK, seed=41, device="cuda")
    vkw = dict(contexts=slate, nano_tables=slate_tables, n_pairs=SLATE_PROPS_PAIRS, seed=51,
               min_abs_edge_pct=0.0, device="cuda")
    # each slate prop scan's simulate_games calls: (keyword arguments, output);
    # a runner's launches go through parallel.mesh
    from fast_monte_carlo_tpu_torch.parallel import mesh
    real, scans = mesh.simulate_games, []

    def counted(*args, **kw):
        out = real(*args, **kw)
        scans[-1].append((kw, out))
        return out

    def scan():
        scans.append([])
        mesh.simulate_games = counted
        try:
            return api.simulate_slate_prop_rows(slate_games, props_csv=sheet, **vkw)
        finally:
            mesh.simulate_games = real

    queries = {
        "parlay": (f"simulate_parlay, {len(PARLAY_LEGS)} legs, {n:,} games, correlations, "
                   f"round robin by 2/3", MULTI_REPS,
                   lambda: api.simulate_parlay_core(a.name, b.name, PARLAY_LEGS, seed=31, **pkw)),
        "season": (f"project_season, {SEASON_GAMES} games x {per:,}", SEASON_REPS,
                   lambda: api.project_season_rows(team, games=season_games, line=1.5, **skw)),
        "slate_props": (f"simulate_slate_props, {SLATE_PROPS_GAMES} matchups, 3 x "
                        f"{2 * SLATE_PROPS_PAIRS:,} games", MULTI_REPS, scan),
    }
    # the entry points alone, warm-ups included, between zeroing the counts
    # and reading them; the checks below hold each warm-up's result
    res, first, part_s = {}, {}, {}
    torch.cuda.synchronize()
    zero_counts()
    for key, (what, reps, fn) in queries.items():
        t0 = time.perf_counter()
        first[key], res[key] = timed_query(what, fn, reps, card)
        part_s[key] = time.perf_counter() - t0
    counts = read_counts("multi-leg, season and slate-props queries",
                         ["nano_game", "nano_game_props", "score_moments"])
    # the parlay's and the scan's launches with player stats, and the
    # season's, all on K1: no eager play chunk
    check(counts["philox_draws"] == 0, "the queries launched philox_draws no time "
          f"({counts['philox_draws']}): every launch of games on K1")
    res["launches"] = counts["philox_draws"]
    t_part = time.perf_counter()

    # -- the same-game parlay: the same games run again
    got = first["parlay"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = runner.run_pairs(PARLAY_PAIRS, seed=31, collect_players=True, collect_stats=False)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    check(out.pstats.device.type == "cuda" and tuple(out.pstats.shape) == (n, 2, 3, 8, 6),
          f"parlay run: {n:,} games with player stats on the card")
    t0 = time.perf_counter()
    odds = edge.parlay_odds(out, a, b, PARLAY_LEGS, price=PARLAY_PRICE)
    corr = edge.parlay_correlation_matrix(out, a, b, PARLAY_LEGS)
    rr = edge.round_robin(out, a, b, PARLAY_LEGS, by=(2, 3), price=PARLAY_PRICE)
    settle_ms = (time.perf_counter() - t0) * 1e3
    check({k: v for k, v in got.items() if k not in ("leg_corr", "round_robin")} == odds
          and got["round_robin"] == rr and got["leg_corr"][0] == corr[0]
          and np.array_equal(got["leg_corr"][1], corr[1]),
          "simulate_parlay == parlay_odds, correlations and round robin of run_pairs with "
          "its seed")
    arrays, meta = edge.resolve_parlay_legs(a, b, PARLAY_LEGS)
    card_counts = edge._host_counts(edge.reduce_parlay_device(out.score, out.pstats, arrays))
    score, ps = out.score.cpu().numpy(), out.pstats.cpu().numpy()
    win, push = np_settle(score, ps, arrays)
    lose = ~(win | push)
    host_counts = {"leg_win": win.sum(0), "leg_push": push.sum(0),
                   "all_win": win.all(1).sum(), "no_lose": (~lose.any(1)).sum(),
                   "all_push": push.all(1).sum()}
    check(all(np.array_equal(card_counts[k], v) for k, v in host_counts.items()),
          f"parlay counts on the card == numpy on the host, exactly (all win "
          f"{int(host_counts['all_win']):,}, pushes by leg {host_counts['leg_push'].tolist()})")
    check(0 < odds["p_all_win"] < 1 and all(0 < x["p_win"] < 1 for x in odds["legs"]),
          f"{len(PARLAY_LEGS)} legs, each won and lost; P(all win) {odds['p_all_win']}, fair "
          f"{odds['fair_american']}, correlation x{odds['correlation_mult']}")
    cpu_out = type(out)(*(x.cpu() for x in out))
    check(edge.parlay_odds(cpu_out, a, b, PARLAY_LEGS, price=PARLAY_PRICE) == odds,
          "parlay_odds of the same games reduced on the CPU == on the card")
    for what, want, tol in (
            ("the CPU's on the same games", edge.parlay_correlation_matrix(
                cpu_out, a, b, PARLAY_LEGS)[1], 1e-6),
            ("numpy's float64 corrcoef (float32 rounding)",
             np.corrcoef(win.T.astype(np.float64)), 1e-5)):
        err = float(np.nanmax(np.abs(corr[1] - want)))
        check(np.array_equal(np.isnan(corr[1]), np.isnan(want)) and err <= tol,
              f"leg correlations on the card vs {what}: max|d| {err:.3g} <= {tol:g}")
    combos = [c for k in (2, 3) for c in itertools.combinations(range(len(PARLAY_LEGS)), k)]
    keys = ("p_all_win", "p_lose", "p_void", "p_win_reduced", "p_parlay", "fair_american",
            "edge_pct", "ev_$100", "kelly")
    check(rr["n_tickets"] == len(combos) and all(
        all(t[k] == edge.parlay_odds(out, a, b, [PARLAY_LEGS[j] for j in c],
                                     price=PARLAY_PRICE)[k] for k in keys)
        for t, c in zip(rr["tickets"], combos)),
        f"round robin by 2/3: each of {len(combos)} tickets == parlay_odds of its legs")
    # a teaser of the spread and total legs, and a cross-game ticket of two
    # teased blocks: the second game is matchup 0 of the props slate
    gl = [leg for leg in PARLAY_LEGS if leg["kind"] in ("spread", "total")]
    teased = edge.tease_legs(gl, 6)
    blk1 = edge.parlay_odds(out, a, b, teased, price=PARLAY_PRICE)
    base = edge.parlay_odds(out, a, b, gl)
    check(blk1["p_all_win"] >= base["p_all_win"] and all(
        t["p_win"] >= g["p_win"] for t, g in zip(blk1["legs"], base["legs"])),
        f"6-point teaser of {len(gl)} legs: P(all win) {base['p_all_win']} -> "
        f"{blk1['p_all_win']}, no leg less likely")
    c, d = slate[0]
    other = api._runner_for(c, d, slate_tables[0], cfg, "table", "nano", False, "cuda")
    legs2 = edge.tease_legs([{"kind": "spread", "team": c.name, "line": -2.5},
                             {"kind": "total", "side": "under", "line": 48}], 6)
    blk2 = edge.parlay_odds(other.run_pairs(PARLAY_PAIRS, seed=32, collect_players=False,
                                            collect_stats=False), c, d, legs2)
    cross = edge.cross_game_parlay([blk1, blk2], price=PARLAY_PRICE)
    check(cross["p_all_win"] == round(blk1["p_all_win"] * blk2["p_all_win"], 6)
          and cross["p_lose"] == round(1 - (1 - blk1["p_lose"]) * (1 - blk2["p_lose"]), 6)
          and cross["p_void"] == round(blk1["p_void"] * blk2["p_void"], 6),
          f"2-block cross-game teaser == the blocks' products (P(all win) "
          f"{cross['p_all_win']}, fair {cross['fair_american']})")
    res["parlay"].update(run_ms=run_ms, settle_ms=settle_ms)
    print(f"  parlay pricing on the card's games (parlay_odds, correlations, round robin of "
          f"{len(combos)} tickets): {settle_ms:.1f} ms against {run_ms:.1f} ms for the run "
          f"({card})")

    # -- the season: the warm-up's schedule rows are its slate summary rows
    s = first["season"]
    rows = s["schedule"]
    p_wins = [round(r[f"win_{side}"], 6) for r, side in zip(rows, sides)]
    check(all(r["n_games"] == per and 10 < r["mean_a"] < 50 and 10 < r["mean_b"] < 50
              and r["win_a"] + r["win_b"] <= 1 for r in rows),
          f"season: {SEASON_GAMES} games of {per:,} trials each, mean points in (10, 50), "
          "win + win <= 1")
    check(s["p_wins"] == p_wins and [r["p_win_team"] for r in rows] == p_wins
          and [r["team_side"] for r in rows] == sides,
          f"project_season: p_wins {p_wins} == its slate summary rows' win rates by side")
    check(abs(sum(s["pmf"]) - 1) < 1e-5 and len(s["pmf"]) == SEASON_GAMES + 1,
          f"season pmf sums to 1 ({sum(s['pmf']):.6f}); mean wins {s['mean_wins']}, over "
          f"1.5 {s['p_over']}")

    # -- the slate prop scan: three matchups of five priced, three launches
    scanned = first["slate_props"]
    check(all(len(x) == 3 for x in scans) and all(kw["collect_players"] for kw, _ in scans[0]),
          f"slate props over {SLATE_PROPS_GAMES} matchups: {[len(x) for x in scans]} launches "
          "a scan (matchups 0, 1, 3 have rows), each with player stats")
    n_meta = 0
    for gi, (_, o) in zip((0, 1, 3), scans[0]):
        x, y = slate[gi]
        idx, meta = edge.resolve_prop_rows(x, y, sheet)
        n_meta += len(meta)
        red_g = edge.reduce_props_device(o.pstats, idx)
        red_c = edge.reduce_props_device(o.pstats.cpu(), idx)
        rel = max(float(((red_g[k].cpu() - red_c[k]).abs() / red_c[k].abs().clamp_min(1.0))
                        .max()) for k in ("mean", "median", "p75", "p90"))
        check(all(torch.equal(red_g[k].cpu(), red_c[k])
                  for k in ("p_over", "p_under", "push", "n_active")) and rel <= 1e-5,
              f"matchup {gi}: reduce_props on the card == CPU on counts, floats within 1e-5 "
              f"({rel:.3g}), {len(idx[0])} padded rows")
        label = f"{x.name} vs {y.name}"
        mine = [json.dumps({"matchup": label, **r}, sort_keys=True)
                for r in edge.prop_rows_from_reductions(meta, red_g, 0.0)]
        theirs = [json.dumps(r, sort_keys=True) for r in scanned if r["matchup"] == label]
        check(sorted(mine) == sorted(theirs),
              f"matchup {gi}: the scan's {len(theirs)} rows == its own games, reduced")
    # the matchup after the skipped one plays under its slate index
    x, y = slate[3]
    o = api._runner_for(x, y, slate_tables[3], cfg, "table", "nano", False, "cuda").run_pairs(
        SLATE_PROPS_PAIRS, key=rng.fold_in(rng.root_key(51), 3), collect_players=True)
    check(torch.equal(o.score, scans[0][2][1].score),
          "matchup 3's games in the scan == run_pairs under fold_in(root_key(seed), 3)")
    edges = [abs(r["edge_pct"]) for r in scanned]
    check(len(scanned) == n_meta == len(sheet) - 1 and edges == sorted(edges, reverse=True),
          f"slate props: every resolvable row priced ({len(scanned)} of {len(sheet)}: one "
          f"team is outside the slate), largest |edge| first")
    part_s["checks"] = time.perf_counter() - t_part
    print("  phase 11 by part: " + ", ".join(f"{k} {v:.1f} s" for k, v in part_s.items()))
    res["part_s"] = part_s
    res["settle_share"] = settle_ms / min(res["parlay"]["ms"])
    print(f"  the parlay's pricing: {res['settle_share']:.4f} of the fastest query")

    if profile_dir is not None:
        k, dev_ms, wall_ms, tab = profile_kernels(
            lambda: api.simulate_parlay_core(a.name, b.name, PARLAY_LEGS, seed=34, **pkw))
        line = (f"one simulate_parlay query ({n:,} games, {len(PARLAY_LEGS)} legs, "
                f"correlations, round robin by 2/3; its games one K1 launch): {k} device "
                f"kernels, {dev_ms:.3f} ms device time, {wall_ms:.3f} ms wall profiled, busy "
                f"share {dev_ms / min(res['parlay']['ms']):.4f} of the fastest unprofiled query")
        print(f"  profile, {line}")
        profile_dir.mkdir(parents=True, exist_ok=True)
        (profile_dir / "profile_parlay.txt").write_text(f"{card}\n{line}\n\n{tab}\n")
        res.update(kernels_per_query=k, device_ms_per_query=dev_ms)
    return res


def path_counts(f) -> dict:
    """Per node of FlatForest f, the internal, numeric and categorical nodes
    on the walk from its tree's root to it (the node itself not counted)."""
    n = f.n_nodes
    acc = {k: np.zeros(n, np.int64) for k in ("internal", "numeric", "cat")}
    frontier = np.asarray(f.roots, np.int64)
    for _ in range(f.max_depth):
        frontier = frontier[f.feat[frontier] >= 0]
        if frontier.size == 0:
            break
        is_cat = f.feat[frontier] < f.layout.n_cat
        kids = []
        for child in (f.left[frontier], f.right[frontier]):
            acc["internal"][child] = acc["internal"][frontier] + 1
            acc["numeric"][child] = acc["numeric"][frontier] + ~is_cat
            acc["cat"][child] = acc["cat"][frontier] + is_cat
            kids.append(child)
        frontier = np.concatenate(kids).astype(np.int64)
    return acc


def forest_bound(f, tf, leaves, n_feat: int) -> tuple:
    """(bytes, instruction counts by class) of one K5 launch whose rows
    reach `leaves` (B, T) in FlatForest f (packed as tf): each input read
    once (the feature rows, ids, the node table at FOREST_NODE_BYTES a
    node, tree classes, base margins) and the margins written once; the
    work of the walks those rows take (the FOREST_* counts)."""
    import torch

    b, t = leaves.shape
    g = max(1, len(tf.group_names))
    nbytes = (b * (n_feat + g + tf.n_classes) * 4 + f.n_nodes * FOREST_NODE_BYTES
              + t * 4 + tf.n_classes * 4)
    pc = {k: torch.from_numpy(v).to(leaves.device) for k, v in path_counts(f).items()}
    visits = {k: float(v[leaves].sum()) for k, v in pc.items()}
    counts = {}
    for per, items in ((FOREST_VISIT_COUNTS, visits["internal"]),
                       (FOREST_NUMERIC_COUNTS, visits["numeric"]),
                       (FOREST_TREE_COUNTS, float(b * t))):
        for k, v in per.items():
            counts[k] = counts.get(k, 0.0) + v * items
    return nbytes, counts


def exact_walk_costs(args, per_forest: dict) -> list:
    """The FOREST_* counts of one (row, tree) walk of each forest of
    `args.exact` (K1's order), as this phase's K5 rows of that forest take
    them (`per_forest[name]["counts"]` over K5_BS[0] rows x its trees;
    phase 12's names: stage1, stage2, pq0-pq2, rq0-rq2, sq0-sq2, fumble,
    play)."""
    seen, out = {}, []
    for head, tf, *_ in args.exact.heads:
        i = seen[head] = seen.get(head, -1) + 1
        name = head if head in ("stage1", "stage2", "fumble", "play") else f"{head}{i}"
        out.append({c: v / (K5_BS[0] * tf.n_trees)
                    for c, v in per_forest[name]["counts"].items()})
    return out


def exact_walk(costs: list, walks, plays: int) -> dict:
    """FOREST_* counts a play of walks `walks` (a launch's, forest by
    forest) at `costs` a walk (`exact_walk_costs`) over its `plays`."""
    out = {}
    for cost, w in zip(costs, walks):
        for c, v in cost.items():
            out[c] = out.get(c, 0.0) + v * float(w) / plays
    return out


def phase_exact(card: str, plain_games: int = EXACT_PLAIN_GAMES) -> dict:
    """Exact mode and tables from heads, on fixtures.heads(0, "reference")
    (`probes.kernels.k5_forests`); K1's exact launch held to
    `nano_game_plain` at `plain_games` games."""
    import torch
    from fast_monte_carlo_tpu_torch import fixtures
    from fast_monte_carlo_tpu_torch.api import MatchupRunner
    from fast_monte_carlo_tpu_torch.config import SimConfig
    from fast_monte_carlo_tpu_torch.ops import forest_eval as fe
    from fast_monte_carlo_tpu_torch.ops import game
    from fast_monte_carlo_tpu_torch.ops.pack import build_packs
    from fast_monte_carlo_tpu_torch.probes.kernels import held_ms, k5_args, k5_forests, k5_rows

    dev = torch.device("cuda")
    cfg = SimConfig()
    t0 = time.perf_counter()
    heads, host, packed, play, pack = k5_forests(dev)
    focus = fixtures.focus_teams(FOCUS_SEED)
    print(f"  reference-shape heads, packed, in {time.perf_counter() - t0:.2f} s; K5 tiles "
          + ", ".join(f"{k} {v.kernel.tiles.shape[0]}" for k, v in packed.items()))
    rng = np.random.default_rng(12)

    worst, equal, total = 0.0, 0, 0
    per_forest = {}
    for b in K5_BS:
        x, ids = k5_rows(pack, rng, b, dev)
        for name, tf in packed.items():
            xx, cats = k5_args(tf, x, ids)
            got = fe.eval_margin(tf, xx, cats)
            want = fe.eval_margin_reference(tf, xx, cats)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            equal += int(torch.equal(got, want))
            total += 1
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-4),
                  f"K5 {name} at B={b:,}: within rtol=1e-5, atol=1e-4 of the plain walk "
                  f"(max|d| {err:.3g})")
            if b == K5_BS[0]:
                leaves = fe.walk_leaves(tf, xx, cats)
                ms = held_ms(lambda: fe.eval_margin(tf, xx, cats), 20)[0]
                plain_ms, plain_ev, how = times(lambda: fe.eval_margin_reference(tf, xx, cats), 2)
                nbytes, counts = forest_bound(host[name], tf, leaves, xx.shape[1])
                per_forest[name] = dict(ms=ms, plain_ms=plain_ms, nbytes=nbytes, counts=counts,
                                        **bound(nbytes, counts))
                print(f"  K5 {name} (T={tf.n_trees}, depth {tf.max_depth}, C={tf.n_classes}) "
                      f"at B={b:,}: {ms:.4f} ms held, plain {plain_ms:.3f} ms ({how}; "
                      f"{plain_ev:.3f} by events), bound {per_forest[name]['bound_ms']:.4f} ms "
                      f"({per_forest[name]['bound_class']}, "
                      f"{per_forest[name]['bound_ms'] / ms:.1%} of it), "
                      f"{counts['dispatch'] / 1e6:.1f} M dispatched ({card})")
    print(f"  K5 bitwise equal to the plain walk in {equal} of {total} launches, "
          f"max|d| {worst:.3g}")
    nbytes = sum(per_forest[k]["nbytes"] for k in play)
    counts = {c: sum(per_forest[k]["counts"].get(c, 0.0) for k in play)
              for c in RATES if c != "bytes"}
    row = {"ms": sum(per_forest[k]["ms"] for k in play),
           "plain_ms": sum(per_forest[k]["plain_ms"] for k in play),
           "library_ms": None, "max_abs_err": worst, **bound(nbytes, counts)}
    print(f"  K5 per play ({len(play)} forests, B={K5_BS[0]:,}): {row['ms']:.4f} ms held, "
          f"plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_class']}, {row['bound_ms'] / row['ms']:.1%} of it) ({card})")

    # a forest whose packed records overflow a field: the kernel refuses it
    lay = heads.stage2.layout
    wide = dataclasses.replace(heads.stage2, layout=dataclasses.replace(
        lay, numeric_names=lay.numeric_names + tuple(f"extra{i}" for i in range(48))))
    tw = fe.pack_forest(wide, dev)
    before = fe.eval_margin_cuda.launches
    try:
        fe.eval_margin(tw, torch.zeros((4, 65), device=dev))
        refused = ""
    except ValueError as e:
        refused = str(e)
    check(tw.kernel is None and "numeric features" in refused
          and fe.eval_margin_cuda.launches == before,
          f"K5 refuses a forest of 65 numerics without launching: {refused!r}")

    # one exact-mode play step, the card against the CPU
    n = EXACT_STEP_STATES
    d = fixtures.play_states(np.random.default_rng(13), n)
    u, z = fixtures.play_draws(np.random.default_rng(14), (n,))
    outs = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        pk, hpk = build_packs(*focus, heads, cfg, where, fixtures.COACH_MAP)
        s = game.GameState(**{k: torch.tensor(v, device=where) for k, v in d.items()})
        out = game.play_step(s, (torch.tensor(u, device=where), torch.tensor(z, device=where)),
                             pk, cfg, game.make_exact_heads_eval(cfg), hpk)
        outs[where] = {f: getattr(out, f).cpu().numpy() for f in game.GameState._fields}
        print(f"  exact play step on {where}: {time.perf_counter() - t0:.2f} s")
    bad = np.zeros(n, bool)
    for f in ("off", "sec", "down", "period", "in_rz", "going", "score"):
        m = outs["cuda"][f] != outs["cpu"][f]
        bad |= m.any(axis=1) if m.ndim > 1 else m
    check(bad.mean() <= 0.005, f"exact play step at {n:,} states: integer state equal on "
          f"CUDA and the CPU in {n - bad.sum():,} ({bad.sum()} differ, at most 0.5%)")

    # K1's exact instantiation alone at the main path's launch: held ms beside
    # its bound on the walks this launch's plays read (its walk counter,
    # each (row, tree) walk costing what this phase's K5 rows of the forest
    # take a walk) and beside the bound on every forest's walks a play
    a, b = fixtures.teams()
    pk, hpk = build_packs(a, b, heads, cfg, dev)
    x_args = game.pack_nano_game(pk, cfg, hpk)
    costs = exact_walk_costs(x_args, per_forest)
    check(len(x_args.exact.heads) == len(play),
          f"K1's exact instantiation packs the {len(play)} forests a play may read "
          f"({x_args.exact.tiles.shape[0]} tiles, {x_args.exact.records.shape[0]:,} records), "
          f"phases at forests {x_args.exact.phase_forest}")
    fo = torch.arange(EXACT_LAUNCH_GAMES, dtype=torch.int32, device=dev) % 2
    score_only = dict(collect_players=False, collect_stats=False)
    s0 = game.initial_state(EXACT_LAUNCH_GAMES, fo, cfg, dev, **score_only)
    k1x = _k1_timed(card, "nano_game exact (reference-shape heads, the main path's launch)",
                    x_args, s0, 41, score_only, reps=2, walk_costs=costs,
                    plain=plain_games == EXACT_LAUNCH_GAMES)
    del s0
    if plain_games != EXACT_LAUNCH_GAMES:
        # the plain version walks 11 forests in torch a play: about 18 s
        # at 4,096 games on an H100, 265 s at 65,536; its walk count is held
        # to the kernel's counter
        fp = torch.arange(plain_games, dtype=torch.int32, device=dev) % 2
        held = _k1_timed(card, "nano_game exact (reference-shape heads) against its plain "
                         "version", x_args, game.initial_state(plain_games, fp, cfg, dev,
                                                                **score_only),
                         41, score_only, reps=2, walk_costs=costs)
        k1x.update(plain_ms=held["plain_ms"], max_abs_err=held["max_abs_err"])
    k1x["plain_games"] = plain_games
    # simulate_games (one K1 launch) against the eager loop (K5 a forest a
    # play) on the same heads
    m = EXACT_EAGER_GAMES
    he = game.make_exact_heads_eval(cfg)
    sm = game.initial_state(m, fo[:m], cfg, dev, **score_only)
    before = launch_count("nano_game_exact")
    got = game.simulate_games(pk, cfg, he, hpk, 41, m, 0, init_state=game.GameState(
        *(f.clone() for f in sm)), **score_only)
    check(launch_count("nano_game_exact") == before + 1,
          "exact mode, reference-shape heads: simulate_games on the card was one K1 launch")
    want = game.simulate_games_eager(pk, cfg, he, hpk, 41, m, 0, init_state=game.GameState(
        *(f.clone() for f in sm)), **score_only)
    k1x["max_abs_err"] = max(k1x["max_abs_err"], nano_diff(
        want, got, f"K1 against the eager loop, exact heads, reference shape, {m:,} games"))
    print(f"  K1 exact on the reference-shape heads: 0 differing games against nano_game_plain "
          f"({plain_games:,} games) and the eager loop ({m:,}), max|d| "
          f"{k1x['max_abs_err']:.3g}; the row's ms and bound at {EXACT_LAUNCH_GAMES:,} games, "
          f"its plain_ms at {plain_games:,}")

    # exact mode end to end on K1, the table path built from the same heads
    # and the analytic heads, timed in turns (EXACT_TURNS) on the fixture
    # teams
    runners = {"exact": MatchupRunner(a, b, heads, cfg, mode="exact", device="cuda"),
               "analytic": MatchupRunner(a, b, None, cfg, mode="analytic", device="cuda")}
    t0 = time.perf_counter()
    runners["table"] = MatchupRunner(a, b, heads, cfg, mode="table", device="cuda")
    build_s = time.perf_counter() - t0
    print(f"  nano tables from reference-shape heads: {build_s:.2f} s for both directions "
          f"({build_s / 2:.2f} s a direction, host numpy)")
    pairs = EXACT_LAUNCH_GAMES // 2
    warm = {}
    for what in EXACT_TURNS:
        t0 = time.perf_counter()
        runners[what].run_pairs_summary(pairs, seed=98, chunk_pairs=pairs)
        torch.cuda.synchronize()
        warm[what] = time.perf_counter() - t0
    half = max(1, min(EXACT_MAX_LAUNCHES // 2, int(EXACT_TARGET_S / 2 / warm["exact"])))
    games = half * EXACT_LAUNCH_GAMES
    print(f"  warm-up launches: " + ", ".join(f"{w} {v:.3f} s" for w, v in warm.items())
          + f"; timing {half} launches of {EXACT_LAUNCH_GAMES:,} games a turn, "
          f"{', '.join(EXACT_TURNS)}")
    plain_calls = []
    plain = fe.eval_margin_reference
    fe.eval_margin_reference = lambda *a, **k: plain_calls.append(1) or plain(*a, **k)
    secs = dict.fromkeys(EXACT_TURNS, 0.0)
    try:
        torch.cuda.synchronize()
        zero_counts()
        for i, what in enumerate(EXACT_TURNS):
            t0 = time.perf_counter()
            sm = runners[what].run_pairs_summary(half * pairs, seed=i, chunk_pairs=pairs)
            torch.cuda.synchronize()
            secs[what] += time.perf_counter() - t0
            check_summary(sm, games, f"{what} mode, turn {i + 1}")
            print(f"  {what}: mean pts {sm.mean_pts.cpu().numpy().round(3).tolist()}, "
                  f"win {sm.win_rate.cpu().numpy().round(4).tolist()}")
        counts = read_counts("exact mode, the table path from heads and the analytic heads",
                             ["nano_game", "nano_game_exact", "nano_game_analytic",
                              "score_moments"])
    finally:
        fe.eval_margin_reference = plain
    check(not plain_calls and counts["forest_eval"] == 0 and counts["philox_draws"] == 0
          and counts["nano_game_exact"] == half and counts["nano_game_analytic"] == half
          and counts["nano_game"] == len(EXACT_TURNS) * half,
          f"exact and analytic mode played one K1 launch a launch of games (exact "
          f"{counts['nano_game_exact']}, analytic {counts['nano_game_analytic']}, all K1 "
          f"{counts['nano_game']}), no forest_eval ({counts['forest_eval']}) or philox_draws "
          f"({counts['philox_draws']}) launch, the plain walk called {len(plain_calls)} times")
    gps = {what: games / secs[what] for what in EXACT_TURNS}
    print(f"  exact mode {gps['exact']:,.0f} games/s, table path from heads "
          f"{gps['table']:,.0f}, analytic heads {gps['analytic']:,.0f} games/s; exact at "
          f"{gps['exact'] / gps['table']:.3f} of the table path, {games:,} games each in turns "
          f"({card})")
    return {**row, "launches": counts["forest_eval"], "exact_gps": gps["exact"],
            "table_gps": gps["table"], "analytic_gps": gps["analytic"], "build_s": build_s,
            "k1_exact": k1x}


def _columns_summary(scores, team_a: str, device="cuda"):
    """The ScoreSummary (on the card) of `scores_columns` rows: each game's
    (team A, team B) points."""
    import torch
    from fast_monte_carlo_tpu_torch.parallel.aggregate import score_moments, summary_from_moments

    a_first = scores["team"] == team_a
    sa = np.where(a_first, scores["pts"], scores["opp_pts"])
    sb = np.where(a_first, scores["opp_pts"], scores["pts"])
    score = torch.tensor(np.stack([sa, sb], axis=1).astype(np.int32), device=device)
    return summary_from_moments(score_moments(score))


def _same_columns(got, want, what: str) -> None:
    check(list(got) == list(want) and all(np.array_equal(np.asarray(got[c]),
                                                         np.asarray(want[c])) for c in want),
          f"{what}: every column equal to the run composed by hand "
          f"({len(next(iter(want.values()))):,} rows)")


def phase_files(card: str) -> dict:
    """Inputs from files: a schema-B SP+ sheet and a focus sheet written to
    a temporary directory, the trained-head fixture directory
    (`fixtures.ARTIFACT_DIR`) and the committed overlay read by the
    sklearn-free loaders; K5 on every loaded forest against its plain walk;
    then the routes a user calls, each equal to the run composed by hand."""
    import os
    import tempfile

    import torch
    from fast_monte_carlo_tpu_torch import api, fixtures
    from fast_monte_carlo_tpu_torch.config import SimConfig
    from fast_monte_carlo_tpu_torch.data.context import build_team_context_from_sp_flex
    from fast_monte_carlo_tpu_torch.data.sp import load_sp_flex
    from fast_monte_carlo_tpu_torch.models import heads as heads_mod
    from fast_monte_carlo_tpu_torch.models.tables import nano_profile
    from fast_monte_carlo_tpu_torch.ops import forest_eval as fe
    from fast_monte_carlo_tpu_torch.ops import game
    from fast_monte_carlo_tpu_torch.ops.game import Situation
    from fast_monte_carlo_tpu_torch.ops.pack import build_packs
    from fast_monte_carlo_tpu_torch.ops.table_lookup import build_table_heads
    from fast_monte_carlo_tpu_torch.probes.kernels import held_ms, k5_args, k5_rows

    dev = torch.device("cuda")
    cfg = SimConfig()
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    sp_path = fixtures.write_sp_sheet(os.path.join(tmp.name, "sp.csv"), SP_TEAMS, SP_SEED)
    focus_csv = os.path.join(tmp.name, "focus.csv")
    fixtures.write_csv(focus_csv, fixtures.focus_rows(FOCUS_SEED), fixtures.FOCUS_COLS)
    t0 = time.perf_counter()
    sp = load_sp_flex(sp_path)
    sp_s = time.perf_counter() - t0
    check(len(sp) == SP_TEAMS + 2, f"SP+ sheet: {len(sp)} teams (Current and Past-only)")

    heads_mod._HEADS_MEMO.clear()
    t0 = time.perf_counter()
    heads = heads_mod.load_heads(fixtures.ARTIFACT_DIR)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = heads_mod.load_heads(fixtures.ARTIFACT_DIR)
    warm_s = time.perf_counter() - t0
    check(again is heads, "load_heads warm returns the memoized instance")
    recon = heads_mod.load_reconstructed_heads(fixtures.ARTIFACT_DIR)
    check(recon.stage2.n_trees == 3 and recon.play_temperature == 1.45
          and recon.stage1 is heads.stage1,
          "load_reconstructed_heads: the committed sklearn-1.9 overlay read without sklearn")
    code = ("import sys\n"
            "for m in ('sklearn', 'joblib', 'pandas', 'jax'):\n"
            "    sys.modules[m] = None\n"
            "from fast_monte_carlo_tpu_torch import api, fixtures\n"
            "from fast_monte_carlo_tpu_torch.models import heads\n"
            "h = heads.load_heads(fixtures.ARTIFACT_DIR)\n"
            "r = heads.load_reconstructed_heads(fixtures.ARTIFACT_DIR)\n"
            "assert h.stage1 is not None and r.stage2 is not None\n"
            "print(sorted(m for m in ('sklearn', 'joblib', 'pandas', 'jax', "
            "'fast_monte_carlo_tpu') if sys.modules.get(m) is not None))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0 and out.stdout.strip() == "[]",
          "a process where sklearn, joblib and pandas cannot be imported loads the heads "
          f"and the overlay; none of them (nor jax) in sys.modules ({out.stderr[-300:]!r})")

    # K5 on every loaded forest against its plain walk, bitwise
    forests = {"stage1": heads.stage1, "stage2": heads.stage2, "stage2_overlay": recon.stage2,
               "fumble": heads.fumble, "play": heads.play}
    for kind, trio in (("pq", heads.pass_quants), ("rq", heads.rush_quants),
                       ("sq", heads.sack_quants)):
        forests.update({f"{kind}{i}": f for i, f in enumerate(trio)})
    play = ["stage1", "stage2"] + [f"{k}{i}" for k in ("pq", "rq", "sq") for i in range(3)]
    packed = {k: fe.pack_forest(f, dev) for k, f in forests.items()}
    refused = [k for k, tf in packed.items() if tf.kernel is None]
    check(not refused, f"every loaded forest packs into K5's records (refused: {refused})")
    rng = np.random.default_rng(131)
    pack, _ = build_packs(*fixtures.focus_teams(FOCUS_SEED), heads, cfg, dev,
                          fixtures.COACH_MAP)
    x, ids = k5_rows(pack, rng, K5_BS[0], dev)
    for g in ids:     # ids over the forests' split categories, unseen ones and -1
        used = [f.used_cat_locals(g) for f in forests.values()
                if g in f.layout.cat_group_names]
        size = max(f.layout.cat_group_sizes[f.layout.cat_group_names.index(g)]
                   for f in forests.values() if g in f.layout.cat_group_names)
        pool = np.concatenate([[-1], *used, rng.integers(0, size, 64)])
        ids[g] = torch.tensor(rng.choice(pool, K5_BS[0]).astype(np.int32), device=dev)
    per, equal = {}, 0
    for name, tf in packed.items():
        xx, cats = k5_args(tf, x, ids)
        got = fe.eval_margin(tf, xx, cats)
        want = fe.eval_margin_reference(tf, xx, cats)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        equal += int(same)
        check(same, f"K5 {name} (T={tf.n_trees}, depth {tf.max_depth}, C={tf.n_classes}) on "
              f"the loaded heads at B={K5_BS[0]:,}: bitwise equal to the plain walk "
              f"(max|d| {float((got - want).abs().max()):.3g})")
        if name in play:
            nbytes, counts = forest_bound(forests[name], tf, fe.walk_leaves(tf, xx, cats),
                                          xx.shape[1])
            per[name] = dict(ms=held_ms(lambda: fe.eval_margin(tf, xx, cats), 20)[0],
                             nbytes=nbytes, counts=counts)
    counts = {c: sum(per[k]["counts"].get(c, 0.0) for k in play) for c in RATES if c != "bytes"}
    k5 = {"ms": sum(per[k]["ms"] for k in play),
          **bound(sum(per[k]["nbytes"] for k in play), counts)}
    print(f"  K5 per play on the loaded heads ({len(play)} forests, B={K5_BS[0]:,}): "
          f"{k5['ms']:.4f} ms held, bound {k5['bound_ms']:.4f} ms ({k5['bound_class']}, "
          f"{k5['bound_ms'] / k5['ms']:.1%} of it); stage 2 {per['stage2']['ms']:.4f} ms, "
          f"a quantile forest {per['pq1']['ms']:.4f} ms ({card})")

    a = build_team_context_from_sp_flex("Team A", 2025, 1, sp)
    b = build_team_context_from_sp_flex("Team B", 2025, 1, sp)
    t0 = time.perf_counter()
    build_table_heads(a, b, heads, cfg, nano=nano_profile(), device=dev)
    build_s = (time.perf_counter() - t0) / 2
    print(f"  inputs (host): SP+ sheet of {SP_TEAMS} teams read in {sp_s:.4f} s, load_heads "
          f"cold {cold_s:.3f} s, warm {warm_s * 1e3:.3f} ms, nano build {build_s:.2f} s a "
          f"direction ({card})")

    # the routes alone between the counts' reset and their reading; the runs
    # composed by hand that they are held to come after
    kw = dict(artifact_dir=fixtures.ARTIFACT_DIR, n=FILE_PAIRS, seed=7)
    modes = (("exact", focus_csv), ("table", None))
    live_kw = dict(sp_path=sp_path, artifact_dir=fixtures.ARTIFACT_DIR)
    q4 = Situation(offense=0, sec=300, down=2, dist=7.0, ytg=40.0, score_a=21, score_b=17)
    games = [("Team A", "Team B"), ("Team 000", "Team 001")]
    routes, k1x_route = {}, {}
    plain_calls = []
    plain = fe.eval_margin_reference
    fe.eval_margin_reference = lambda *a, **k: plain_calls.append(1) or plain(*a, **k)
    try:
        torch.cuda.synchronize()
        zero_counts()
        for mode, focus in modes:
            before = game.nano_game_cuda.launches_exact
            routes[mode] = api.simulate_upcoming_matchup_columns(
                "Team A", "Team B", sp_path=sp_path, focus_csv=focus, mode=mode, **kw)
            torch.cuda.synchronize()
            k1x_route[mode] = game.nano_game_cuda.launches_exact - before
        row, _ = api.simulate_live_game("Team A", "Team B", q4, n_games=FILE_LIVE_GAMES,
                                        **live_kw)
        fourth = api.evaluate_fourth_down(
            "Team A", "Team B", Situation(offense=1, sec=420, down=4, dist=2.0, ytg=33.0,
                                          score_a=14, score_b=10),
            n_games=FILE_LIVE_GAMES, **live_kw)
        rows, summs = api.simulate_slate_summary_rows(
            games, sp_path=sp_path, artifact_dir=fixtures.ARTIFACT_DIR,
            n_pairs=FILE_SLATE_PAIRS, chunk_pairs=FILE_SLATE_PAIRS, layout="game_shard")
        torch.cuda.synchronize()
        launches = read_counts("inputs-from-files path",
                               ["nano_game", "nano_game_exact", "score_moments"])
    finally:
        fe.eval_margin_reference = plain
    check(not plain_calls and k1x_route["exact"] == 1 and launches["forest_eval"] == 0
          and launches["philox_draws"] == 0,
          f"the exact route walked its forests in K1: {k1x_route['exact']} exact launch, "
          f"forest_eval {launches['forest_eval']} and philox_draws {launches['philox_draws']} "
          f"launches, the plain walk called {len(plain_calls)} times")
    check(k1x_route["table"] == 0, "the table route (nano tables from the loaded heads) "
          "launched no exact K1")

    gps, warm = {}, {}
    for mode, focus in modes:
        scores, players, summary, _, _, meta = routes[mode]
        n_games = 2 * FILE_PAIRS
        gps[mode] = n_games / meta["sim_time_sec"]
        check_summary(_columns_summary(scores, "Team A"), n_games,
                      f"simulate_upcoming_matchup, mode={mode!r}")
        ha = build_team_context_from_sp_flex("Team A", 2025, 1, sp, focus_csv=focus)
        hb = build_team_context_from_sp_flex("Team B", 2025, 1, sp, focus_csv=focus)
        runner = api.MatchupRunner(ha, hb, heads, cfg, mode)
        before = game.nano_game_cuda.launches_exact
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = runner.run_pairs(FILE_PAIRS, seed=7, collect_players=True)
        want_scores = api.scores_columns(out, "Team A", "Team B")
        warm[mode] = n_games / (time.perf_counter() - t0)
        check(game.nano_game_cuda.launches_exact - before == k1x_route[mode],
              f"mode={mode!r}: the run composed by hand launched exact K1 as often as the "
              f"route ({k1x_route[mode]})")
        _same_columns(scores, want_scores, f"simulate_upcoming_matchup, mode={mode!r}")
        _same_columns(players, api.players_columns(out, ha, hb),
                      f"its player rows, mode={mode!r}")
        print(f"  {mode}: the route {gps[mode]:,.0f} games/s (its sim_time_sec "
              f"{meta['sim_time_sec']:.2f} s, the runner's build included), the same run composed by hand {warm[mode]:,.0f} "
              f"games/s (warm), {n_games:,} games ({card}); mean pts "
              f"{summary['mean_pts'].round(3).tolist()}, win "
              f"{summary['win_rate'].round(4).tolist()}")

    check(row["n_games"] == FILE_LIVE_GAMES and abs(row["win_a"] + row["win_b"] + row["tie"]
                                                    - 1) < 1e-6 and row["win_a"] > 0.5,
          f"simulate_live_game from the sheet: win A {row['win_a']:.4f} up 21-17 at Q4 05:00")
    check(set(fourth["choices"]) == {"fg", "go", "policy", "punt"}
          and fourth["best"] in ("fg", "go", "punt"),
          f"evaluate_fourth_down from the sheet: best {fourth['best']}, "
          f"{ {c: r['win_off'] for c, r in fourth['choices'].items()} }")
    check([(r["team_a"], r["team_b"]) for r in rows] == games
          and all(r["n_games"] == 2 * FILE_SLATE_PAIRS for r in rows),
          "simulate_slate_summary_rows from the sheet (SlateRunner(heads=), game_shard): "
          + ", ".join(f"{r['team_a']} {r['mean_a']:.2f}-{r['mean_b']:.2f}" for r in rows))
    for (ta, tb), sm in zip(games, summs):
        check(int(sm.n) == 2 * FILE_SLATE_PAIRS and abs(float(sm.win_rate.sum())
                                                        + float(sm.tie_rate) - 1) < 1e-5
              and 10 < float(sm.mean_pts.min()) and float(sm.mean_pts.max()) < 50,
              f"slate game {ta} vs {tb}: summary well formed")
    tmp.cleanup()
    print(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s; the routes' own rates: "
          f"exact {gps['exact']:,.0f} and table {gps['table']:,.0f} games/s ({card})")
    return {"launches": launches, "k5": k5, "gps": gps, "warm_gps": warm, "sp_s": sp_s,
            "cold_s": cold_s, "warm_s": warm_s, "build_s": build_s}


def _http(base: str, path: str, body=None):
    """(status, JSON answer, seconds) of one request to the server."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        base + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="GET" if body is None else "POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            code, out = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, out = e.code, json.loads(e.read())
    return code, out, time.perf_counter() - t0


def check_row(row: dict, games: int, what: str) -> None:
    """`check_summary` for an answer's summary row: n, win rates (and the
    tie, where the row has it) summing to 1 at most (exactly with the tie),
    mean points in [0, 100), every number finite.  Not (10, 50): on nano
    tables from the fixture heads the sheet's two weakest teams (Team 002
    and Team 003) score 11 and 5 a game, as the JAX package's tables (the
    same, bitwise) would have them score."""
    wins = row["win_a"] + row["win_b"] + row.get("tie", 0.0)
    nums = [v for v in row.values() if isinstance(v, (int, float))]
    check(row["n_games"] == games and (abs(wins - 1) < 1e-5 if "tie" in row else wins <= 1 + 1e-9)
          and 0 <= row["mean_a"] < 100 and 0 <= row["mean_b"] < 100
          and all(np.isfinite(nums)),
          f"{what}: n {row['n_games']:,}, win {row['win_a']:.4f} / {row['win_b']:.4f}, "
          f"means {row['mean_a']:.2f}-{row['mean_b']:.2f}")


def _bare(out: dict) -> dict:
    return {k: v for k, v in out.items() if k != "elapsed_s"}


def phase_serve(card: str) -> dict:
    """The resident server on the card: a table-mode `SimService` behind a
    `ThreadingHTTPServer` on a free port, started with every memo empty,
    spoken to over HTTP; then an exact-mode one.  The counts cover the
    requests only; the checks that run the path again come after."""
    import os
    import tempfile
    import threading

    import torch
    from fast_monte_carlo_tpu_torch import api, fixtures
    from fast_monte_carlo_tpu_torch.edge import market_odds_from_summary, summary_moneyline
    from fast_monte_carlo_tpu_torch.models import heads as heads_mod
    from fast_monte_carlo_tpu_torch.ops import rng, table_lookup
    from fast_monte_carlo_tpu_torch.serve import ServeConfig, SimService, jsonable, make_server

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    sp_path = fixtures.write_sp_sheet(os.path.join(tmp.name, "sp.csv"), SP_TEAMS, SP_SEED)
    focus_csv = os.path.join(tmp.name, "focus.csv")
    fixtures.write_csv(focus_csv, fixtures.focus_rows(FOCUS_SEED), fixtures.FOCUS_COLS)
    # a fresh process's state: no heads, nano tables or runners memoized
    heads_mod._HEADS_MEMO.clear()
    table_lookup._TABLE_MEMO.clear()
    api._RUNNER_MEMO.clear()

    servers = []

    def start(**kw):
        service = SimService(ServeConfig(sp_path=sp_path, artifact_dir=fixtures.ARTIFACT_DIR,
                                         device="cuda", **kw))
        srv = make_server(service, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
        return f"http://127.0.0.1:{srv.server_address[1]}", service

    ab = {"team_a": "Team A", "team_b": "Team B"}
    q4 = {**ab, "offense": "A", "quarter": 4, "clock": "05:00", "down": 2, "dist": 7,
          "ytg": 40, "score_a": 21, "score_b": 17}
    sim_body = {"team_a": SERVE_COLD[0], "team_b": SERVE_COLD[1], "n_pairs": SERVE_PAIRS,
                "seed": SERVE_SEED, "spread": -3.5, "total": 41.5, "alt": {"width": 6, "step": 1}}
    batch = [{"team_a": a, "team_b": b, "n_pairs": SERVE_PAIRS, "seed": SERVE_SEED + 1,
              "spread": 2.5} for a, b in SERVE_COALESCED]
    ms, ans = {}, {}

    def ask(name, path, body=None):
        code, out, dt = _http(base, path, body)
        check(code == 200, f"{name}: HTTP {code} ({str(out)[:300]})")
        ms[name], ans[name] = 1e3 * dt, out
        return out

    try:
        base, service = start(mode="table")
        torch.cuda.synchronize()
        zero_counts()
        by_ch = dict(rng.philox_draws.launches_by_ch)
        t0 = time.perf_counter()
        warm = service.warm(SERVE_WARM)
        ms["warm"] = 1e3 * (time.perf_counter() - t0)
        health = ask("/health", "/health")
        ask("/sim cold", "/sim", sim_body)
        ask("/sim warm", "/sim", sim_body)

        # four distinct matchups queued while the device lock is held
        outs = [None] * len(batch)

        def post(i):
            outs[i] = _http(base, "/sim", batch[i])

        coalesced0 = service._coalesced
        service._lock.acquire()
        try:
            threads = [threading.Thread(target=post, args=(i,)) for i in range(len(batch))]
            for t in threads:
                t.start()
            t_wait = time.perf_counter()
            while time.perf_counter() - t_wait < 60:
                with service._batch_lock:
                    queued = sum(it.waiters for b in service._sim_batches.values()
                                 for it in b.items.values())
                if queued == len(batch):
                    break
                time.sleep(0.01)
            t0 = time.perf_counter()
        finally:
            service._lock.release()
        for t in threads:
            t.join(timeout=600)
        ms["coalesced batch"] = 1e3 * (time.perf_counter() - t0)
        coalesced = service._coalesced - coalesced0

        ask("/slate", "/slate", {"games": [list(g) for g in SERVE_COALESCED],
                                 "n_pairs": SERVE_SLATE_PAIRS,
                                 "lines": [{"team_a": "Team A", "spread": -3.5, "total": 44.5},
                                           {"team_a": "Team 002", "spread": 1.5}]})
        ask("/live", "/live", {**q4, "n_games": SERVE_LIVE_GAMES, "spread": -3.5,
                               "total": 44.5})
        ask("/live situations", "/live", {**ab, "n_games_per": SERVE_CURVE_PER, "situations": [
            q4, {**q4, "quarter": 3, "clock": "10:00", "score_a": 14},
            {**q4, "quarter": 2, "offense": "B", "down": 1, "dist": 10, "ytg": 75},
            {**q4, "quarter": 1, "clock": "15:00", "down": 1, "dist": 10, "ytg": 75,
             "score_a": 0, "score_b": 0}]})
        ask("/fourth", "/fourth", {**q4, "offense": "B", "clock": "07:00", "down": 4,
                                   "dist": 2, "ytg": 33, "score_a": 14, "score_b": 10,
                                   "n_games": SERVE_LIVE_GAMES})
        ask("/parlay", "/parlay", {**ab, "n_pairs": SERVE_PAIRS, "price": 400,
                                   "correlations": True, "round_robin": 2,
                                   "legs": [{"kind": "moneyline", "team": "Team A"},
                                            {"kind": "total", "side": "over", "line": 40.5},
                                            {"kind": "spread", "team": "Team B", "line": 6.5}]})
        # home and away against Team B: the tables of the warm and the cold /sim
        ask("/season", "/season", {"team": "Team A", "games": [["Team A", "Team B"],
                                                               ["Team B", "Team A"]],
                                   "n_pairs": SERVE_SLATE_PAIRS, "line": 1.5})
        exact_base, _ = start(mode="exact", focus_csv=focus_csv)
        base = exact_base
        ask("/sim exact", "/sim", {**ab, "n_pairs": SERVE_EXACT_PAIRS, "seed": 2})
        ask("/props exact", "/props", {"games": [["Team A", "Team B"]],
                                       "n_pairs": SERVE_PROPS_PAIRS,
                                       "props": fixtures.prop_rows(PROP_SEED)})
        health_ms = [1e3 * _http(exact_base, "/health")[2] for _ in range(HEALTH_GETS)]
        torch.cuda.synchronize()
        launches = read_counts("server path",
                               ["nano_game", "nano_game_exact", "score_moments"])
        k3 = rng.philox_draws.launches_by_ch[1] - by_ch.get(1, 0)
        k4 = rng.philox_draws.launches_by_ch[CH] - by_ch.get(CH, 0)
        check(k3 == 0 and k4 == 0 and launches["forest_eval"] == 0
              and launches["nano_game_forced"] > 0 and launches["nano_game_exact"] >= 2,
              f"server path: every launch on K1 (exact mode's /sim and /props "
              f"{launches['nano_game_exact']} exact launches, /fourth's forced plays "
              f"{launches['nano_game_forced']}); philox_draws ch=24 (K4) {k4}, ch=1 (K3) {k3}, "
              f"forest_eval {launches['forest_eval']} launches (0 allowed)")

        check(warm == {"heads": "loaded", "sp": "loaded", "compiled": "2 matchups @ 256 pairs"},
              f"warm: {warm}")
        check(health["platform"] == "cuda" and health["device_name"] ==
              torch.cuda.get_device_name(0) and health["device_count"] ==
              torch.cuda.device_count() and health["config"]["device"] == "cuda",
              f"/health: platform {health['platform']}, {health['device_name']}, "
              f"{health['device_count']} device(s)")
        cold = ans["/sim cold"]
        check(_bare(cold) == _bare(ans["/sim warm"]), "the warm /sim answers as the cold one")
        check_row(cold["summary"], 2 * SERVE_PAIRS, "/sim")
        check(set(cold["markets"]) == {"spread", "total"} and len(cold["alt"]["spread"]) == 13,
              "/sim priced the spread, the total and 13-line ladders")
        check(all(o is not None and o[0] == 200 for o in outs) and coalesced >= 3,
              f"{len(batch)} distinct /sim requests queued behind the lock: all answered, "
              f"{coalesced} from the leader's batch")
        for body, o in zip(batch, outs):
            check_row(o[1]["summary"], 2 * SERVE_PAIRS, f"coalesced /sim {body['team_a']}")
        for r in ans["/slate"]["summaries"]:
            check_row(r, 2 * SERVE_SLATE_PAIRS, f"/slate {r['team_a']} vs {r['team_b']}")
        mk = ans["/slate"]["markets"]
        check([r["spread"] for r in mk] == [-3.5, None, None, 1.5] and mk[0]["total"] == 44.5,
              "/slate priced the quoted lines of 2 of its 4 games by team A's name")
        check_row(ans["/live"]["live"], SERVE_LIVE_GAMES, "/live")
        for i, r in enumerate(ans["/live situations"]["curve"]):
            check_row(r, SERVE_CURVE_PER, f"/live situation {i}")
        fourth = ans["/fourth"]["fourth"]
        check(set(fourth["choices"]) == {"fg", "go", "policy", "punt"}
              and fourth["best"] in ("fg", "go", "punt"),
              f"/fourth: best {fourth['best']}, "
              f"{ {c: r['win_off'] for c, r in fourth['choices'].items()} }")
        par = ans["/parlay"]["parlay"]
        check(par["n"] == 2 * SERVE_PAIRS and len(par["leg_corr"]) == 3
              and par["round_robin"]["n_tickets"] == 3
              and 0 < par["p_all_win"] <= min(leg["p_win"] for leg in par["legs"]),
              f"/parlay: p_all_win {par['p_all_win']}, fair {par['fair_american']}")
        season = ans["/season"]["season"]
        for r in season["schedule"]:
            check_row(r, 2 * SERVE_SLATE_PAIRS, f"/season vs {r['opponent']} ({r['team_side']})")
        check(abs(sum(season["pmf"]) - 1) <= len(season["pmf"]) * 5e-7 + 1e-12,
              f"/season: pmf {season['pmf']}")
        check_row(ans["/sim exact"]["summary"], 2 * SERVE_EXACT_PAIRS, "/sim, exact mode")
        props = ans["/props exact"]["props"]
        check(len(props) == 33 and all(np.isfinite(r["edge_pct"]) for r in props),
              f"/props (exact mode, focus rosters): {len(props)} rows priced")

        # outside the count window: each coalesced answer against the same
        # request alone, the cold /sim against the direct call, K4 at its key
        base = f"http://127.0.0.1:{servers[0].server_address[1]}"
        for body, o in [(batch[i], outs[i]) for i in SERVE_SOLO]:
            code, solo, _ = _http(base, "/sim", body)
            check(code == 200 and _bare(o[1]) == _bare(solo),
                  f"coalesced /sim {body['team_a']} vs {body['team_b']} == the same request "
                  "alone, bitwise")
        ta, tb = SERVE_COLD
        rows, (s,) = api.simulate_slate_summary_rows(
            [SERVE_COLD], sp_path=sp_path, artifact_dir=fixtures.ARTIFACT_DIR,
            n_pairs=SERVE_PAIRS, seed=SERVE_SEED, device=service.device)
        check(cold["summary"] == jsonable(rows[0])
              and cold["moneyline"] == jsonable(summary_moneyline(s, ta, tb))
              and cold["markets"] == jsonable(market_odds_from_summary(
                  s, ta, tb, spread=-3.5, total=41.5)),
              "/sim == api.simulate_slate_summary_rows on the card and its pricing, bitwise")
        check_summary(type(s)(*(torch.as_tensor(f, device="cuda") for f in s)),
                      2 * SERVE_PAIRS, "the direct call's summary")
        dev = torch.device("cuda")
        key = rng.fold_in(rng.fold_in(rng.root_key(SERVE_SEED), 0), 0)
        u, z = rng.chunk_draws(key, 0, CH, 2 * SERVE_PAIRS, dev)
        ur, zr = rng.philox_draws_reference(key, 0, CH, 2 * SERVE_PAIRS, dev)
        draw_err = float((z - zr).abs().max())
        check(torch.equal(u, ur) and draw_err <= 1e-5,
              f"K4 at the cold /sim's first launch (key {key:#x}, ({CH}, {2 * SERVE_PAIRS:,})): "
              f"uniforms bitwise, normals max|d| {draw_err:.3g} <= 1e-5")
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        tmp.cleanup()

    hq = np.percentile(health_ms, [50, 95])
    print(f"  server latency ({card}): warm (2 matchups, 256 pairs) {ms['warm']:.1f} ms; "
          f"/sim at {2 * SERVE_PAIRS:,} games cold {ms['/sim cold']:.1f} ms, warm "
          f"{ms['/sim warm']:.1f} ms")
    print(f"  coalesced batch of {len(batch)} distinct /sim ({2 * SERVE_PAIRS:,} games each): "
          f"{ms['coalesced batch']:.1f} ms from the lock's release to the last answer ({card})")
    print("  endpoint latency: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in ms.items() if k.startswith("/")) + f" ({card})")
    print(f"  /health over {HEALTH_GETS} requests: p50 {hq[0]:.2f} ms, p95 {hq[1]:.2f} ms ({card})")
    print(f"  phase 14 took {time.perf_counter() - t_phase:.1f} s; launches K4 {k4}, K3 {k3}, "
          f"K5 {launches['forest_eval']} ({card})")
    return {"launches": launches, "k3": k3, "k4": k4, "ms": ms, "health_ms": hq.tolist(),
            "draw_err": draw_err}

def _cli(argv) -> str:
    """What `cli.main(argv)` prints; fails unless it returns 0."""
    import contextlib
    import io

    from fast_monte_carlo_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"cli {' '.join(argv[:3])} ...: exit {rc}")
    return buf.getvalue()


def _printed(fn, *a, **k) -> str:
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a, **k)
    return buf.getvalue()


def _saved_rows(path: str) -> list:
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def phase_saved(card: str) -> dict:
    """Saved sims, bundles and the backtest: `sim --save` on the card, then
    `edges` and `prop --ladder` over the files; `edges --device` three ways;
    the batched sweep's core; a bundle signature; `backtest` and `slate
    --props` through the CLI; trace_context, device_memory_stats and SimMeter.
    The counts cover the steps; the checks that run a path again come after
    they are read."""
    import os
    import tempfile

    import torch
    from fast_monte_carlo_tpu_torch import api, backtest, edge, fixtures, store
    from fast_monte_carlo_tpu_torch.models.heads import load_heads
    from fast_monte_carlo_tpu_torch.ops import forest_eval as fe
    from fast_monte_carlo_tpu_torch.ops import rng
    from fast_monte_carlo_tpu_torch.parallel import player_stat_probs
    from fast_monte_carlo_tpu_torch.utils.profiling import (SimMeter, device_memory_stats,
                                                            trace_context)

    t_phase = time.perf_counter()
    dev = "cuda"      # as the CLI passes it, so the runner memos serve both
    art = fixtures.ARTIFACT_DIR
    tmp = tempfile.TemporaryDirectory()
    home = os.getcwd()
    os.chdir(tmp.name)
    sheet = fixtures.write_sp_sheet("sp.csv", SP_TEAMS, SP_SEED)
    fixtures.write_csv("focus.csv", fixtures.focus_rows(FOCUS_SEED), fixtures.FOCUS_COLS)
    fixtures.write_csv("props.csv", fixtures.prop_rows(PROP_SEED), fixtures.PROP_COLS)
    scores = np.random.default_rng(BACKTEST_SEED).integers(0, 56, (len(BACKTEST_GAMES), 2))
    scores[-1, 1] = scores[-1, 0]
    fixtures.write_csv("finals.csv", [
        {"team_a": a, "team_b": b, "score_a": int(x), "score_b": int(y)}
        for (a, b), (x, y) in zip(BACKTEST_GAMES, scores)],
        ("team_a", "team_b", "score_a", "score_b"))
    fixtures.write_csv("slate.csv", [{"team_a": a, "team_b": b} for a, b in SAVED_SLATE_GAMES],
                       ("team_a", "team_b"))
    src = ["--sp", sheet, "--artifacts", art]
    ab = ["--team-a", "Team A", "--team-b", "Team B"]
    base = api.csv_base_from("Team A", "Team B", 1)
    meter = SimMeter()
    ms, k4, k1, k1x, k5, out_text, step_games = {}, {}, {}, {}, {}, {}, {}
    plain_calls = []
    plain = fe.eval_margin_reference
    fe.eval_margin_reference = lambda *a, **k: plain_calls.append(1) or plain(*a, **k)

    def step(name, fn, games=0):
        """fn() timed on the host clock ending in a synchronize, with its K4
        (philox_draws ch=24), K1 (nano_game; of them exact mode's) and K5
        (forest_eval) launches."""
        torch.cuda.synchronize()
        n4 = rng.philox_draws.launches_by_ch[CH]
        n1 = engine_launches()["K1"]
        n1x = launch_count("nano_game_exact")
        n5 = fe.eval_margin_cuda.launches
        t0 = time.perf_counter()
        if games:     # a simulated step: one "simulate" record with its games
            res = fn()
            torch.cuda.synchronize()
            meter.record_run(games, time.perf_counter() - t0, step=name)
        else:
            with meter.phase(name):
                res = fn()
        ms[name] = 1e3 * (time.perf_counter() - t0)
        step_games[name] = games
        k4[name] = rng.philox_draws.launches_by_ch[CH] - n4
        k1[name] = engine_launches()["K1"] - n1
        k1x[name] = launch_count("nano_game_exact") - n1x
        k5[name] = fe.eval_margin_cuda.launches - n5
        if games:
            check(k4[name] + k1[name] > 0, f"{name}: K4 launched {k4[name]} times, K1 "
                  f"{k1[name]}")
        return res

    try:
        torch.cuda.synchronize()
        zero_counts()
        # 1. saved files on the card, then the markets over them
        out_text["sim"] = step("sim --save", lambda: _cli(
            ["sim", "Team A", "Team B", *src, "--focus", "focus.csv", "--mode", "exact",
             "-n", str(SAVED_PAIRS), "--players", "--save", "--seed", str(SAVED_SEED)]),
            games=2 * SAVED_PAIRS)
        out_text["edges"] = step("edges (saved files)", lambda: _cli(
            ["edges", "--base", base, *ab, "--spread", "-3.5", "--total", "44.5",
             "--props", "props.csv", "--alt", "--mid-spread=-3.5,7.5",
             "--mid-total", "40.5,47.5"]))
        qb = fixtures.roster_name("Team A", "pass", 0)
        out_text["prop"] = step("prop --ladder (saved files)", lambda: _cli(
            ["prop", "Team A", qb, "pass_yds", "240.5", "--base", base, "--ladder"]))
        ml = edge.moneyline_from_sims(base, "Team A", "Team B")

        # 2. edges --device: market-only (run_pairs_summary), props on the
        # focus rosters and market-only in exact mode (focus rosters need exact
        # mode: their heads do not fuse into the nano table)
        out_text["device"] = step("edges --device (market-only)", lambda: _cli(
            ["edges", "--device", *src, *ab, "-n", str(EDGES_PAIRS), "--spread", "-3.5",
             "--total", "44.5", "--alt", "--mid-spread=-3.5,7.5", "--seed", "4"]),
            games=2 * EDGES_PAIRS)
        mem = device_memory_stats()
        props_argv = ["edges", "--device", *src, *ab, "--focus", "focus.csv", "--mode",
                      "exact", "-n", str(EDGES_SMALL_PAIRS), "--spread", "-3.5",
                      "--props", "props.csv", "--seed", "5"]
        out_text["device props"] = step("edges --device (props, exact)",
                                        lambda: _cli(props_argv), games=2 * EDGES_SMALL_PAIRS)
        out_text["device exact"] = step("edges --device (exact)", lambda: _cli(
            ["edges", "--device", *src, *ab, "--mode", "exact", "-n", str(EDGES_SMALL_PAIRS),
             "--spread", "-3.5", "--total", "44.5", "--seed", "6"]),
            games=2 * EDGES_SMALL_PAIRS)
        trace_dir = os.path.join(tmp.name, "trace")
        with trace_context(trace_dir):
            out_text["traced"] = step("edges --device (traced)", lambda: _cli(
                ["edges", "--device", *src, *ab, "-n", str(TRACE_PAIRS), "--spread", "-3.5"]),
                games=2 * TRACE_PAIRS)

        # 3. the batched sweep's core on the card, then resumed past chunks 0-1
        # the market-only query's memoized runner (its nano tables built once)
        runner, a, b, _ = api._prepared_runner(
            "Team A", "Team B", sp_path=sheet, year=2025, week=1, artifact_dir=art,
            focus_csv=None, mode="table", table_quality="nano", cfg=None, shard=False,
            device=dev)
        heads = load_heads(art)
        chunk_k4, chunks = {}, {}

        def sweep(done=()):
            got = {}
            before = engine_launches()
            for ci, cols, _ in api.simulate_matchup_batched_chunks(
                    a, b, heads, SWEEP_CHUNKS * SWEEP_PAIRS, SWEEP_PAIRS, seed=SWEEP_SEED,
                    runner=runner, done=done):
                got[ci] = cols
                used = launches_since(before)
                chunk_k4[(done, ci)] = used["K4"] + used["K1"]
                before = engine_launches()
            return got

        chunks = step("batched sweep (3 chunks)", sweep, games=2 * SWEEP_CHUNKS * SWEEP_PAIRS)
        resumed = step("batched sweep (resumed)", lambda: sweep((0, 1)), games=2 * SWEEP_PAIRS)

        # 4. the content address of a bundle
        sig = store.make_signature(SIGNATURE_META)

        # 5. the backtest of the smoke's own finals, its report kept
        reports = []
        real_print = backtest.print_backtest_readable
        backtest.print_backtest_readable = lambda rep: reports.append(rep) or real_print(rep)
        try:
            out_text["backtest"] = step(f"backtest ({len(BACKTEST_GAMES)} games)", lambda: _cli(
                ["backtest", "--results", "finals.csv", *src, "-n", str(BACKTEST_PAIRS),
                 "--seed", str(BACKTEST_SEED)]), games=2 * BACKTEST_PAIRS * len(BACKTEST_GAMES))
        finally:
            backtest.print_backtest_readable = real_print

        # 6. slate --props on the focus teams (exact mode)
        slate_argv = ["slate", "--games", "slate.csv", *src, "--focus", "focus.csv",
                      "--mode", "exact", "-n", "1024", "--props", "props.csv",
                      "--props-n", str(EDGES_SMALL_PAIRS), "--min-edge", "0"]
        out_text["slate"] = step("slate --props (2 matchups)", lambda: _cli(slate_argv),
                                 games=2 * (1024 + EDGES_SMALL_PAIRS) * len(SAVED_SLATE_GAMES))
        torch.cuda.synchronize()
        launches = read_counts("saved-sims path",
                               ["nano_game", "nano_game_exact", "score_moments"])
    finally:
        fe.eval_margin_reference = plain
        os.chdir(home)

    try:
        os.chdir(tmp.name)
        # 1. the printed shares against numpy over the saved rows
        rows = _saved_rows(f"scores_{base}")
        side = {t: [(int(r["pts"]), int(r["opp_pts"])) for r in rows if r["team"] == t]
                for t in ("Team A", "Team B")}
        pa, pb = (np.array(side[t]) for t in ("Team A", "Team B"))
        check(len(rows) == 2 * SAVED_PAIRS and len(pa) + len(pb) == 2 * SAVED_PAIRS,
              f"sim --save wrote {len(rows):,} score rows")
        p_cover = round(float(np.mean(pa[:, 0] - pa[:, 1] > 3.5)), 6)
        p_over = round(float(np.mean(pa.sum(axis=1) > 44.5)), 6)
        p_win = (round(float(np.mean(pa[:, 0] > pa[:, 1])), 6),
                 round(float(np.mean(pb[:, 0] > pb[:, 1])), 6))
        text = out_text["edges"]
        check(f"Cover:     {100 * p_cover:.1f}%" in text and f"Over:   {100 * p_over:.1f}%"
              in text and f"Team A: {100 * p_win[0]:.2f}%" in text
              and f"Team B: {100 * p_win[1]:.2f}%" in text,
              f"edges over the saved files prints numpy's cover {p_cover}, over {p_over} "
              f"and win shares {p_win}")
        check((ml["team"]["p_win"], ml["opp"]["p_win"]) == p_win,
              f"moneyline_from_sims p_win {ml['team']['p_win']}, {ml['opp']['p_win']} == "
              "numpy's counts")
        check("— Player Props value" in text and "— Alternate Spreads —" in text
              and text.count("=== Middle:") == 2, "edges printed the props, ladders and "
              "both middles")
        prows = [r for r in _saved_rows(f"players_{base}")
                 if r["team"] == "Team A" and r["player"] == qb and r["role"] == "QB"]
        p_qb = round(float(np.mean([float(r["pass_yds"]) > 240.5 for r in prows])), 4)
        check(f"Over:  {p_qb:.1%}" in out_text["prop"]
              and "Alternate lines (same samples as the quote):" in out_text["prop"],
              f"prop {qb} pass_yds 240.5: over {p_qb} as numpy counts {len(prows):,} rows")

        # 2. exact sums and launch shapes of edges --device
        for name, pairs in (("device", EDGES_PAIRS), ("device props", EDGES_SMALL_PAIRS),
                            ("device exact", EDGES_SMALL_PAIRS), ("traced", TRACE_PAIRS)):
            last = [x for x in out_text[name].splitlines() if x.startswith("[")][-1]
            check(last.startswith(f"[{2 * pairs} games simulated + reduced on cuda in"),
                  f"edges --device ({name}): {last}")
        check(k5["edges --device (market-only)"] == 0,
              f"the market-only query (table mode): {k1['edges --device (market-only)']} K1 "
              f"and {k4['edges --device (market-only)']} K4 launches over "
              f"{EDGES_PAIRS // 32_768} launches of 65,536 games, no forest walk")
        for name in ("sim --save", "edges --device (props, exact)", "edges --device (exact)",
                     "slate --props (2 matchups)"):
            check(k1x[name] > 0 and k5[name] == 0 and k4[name] == 0,
                  f"{name} (exact mode): {k1x[name]} of its {k1[name]} K1 launches exact mode's, "
                  f"forest_eval {k5[name]}, philox_draws {k4[name]} (0 allowed)")
        check(not plain_calls, f"exact mode walked its forests in K1 only (the plain walk "
              f"called {len(plain_calls)} times)")
        runner_p, pa_ctx, pb_ctx, _ = api._prepared_runner(
            "Team A", "Team B", sp_path=sheet, year=2025, week=1, artifact_dir=art,
            focus_csv="focus.csv", mode="exact", table_quality="nano", cfg=None, shard=False,
            device=dev)
        out = runner_p.run_pairs(EDGES_SMALL_PAIRS, seed=5, collect_players=True,
                                 collect_stats=False)
        table = _printed(edge.print_prop_table,
                         edge.scan_props_rows(out, pa_ctx, pb_ctx, "props.csv"))
        check(table.strip() in out_text["device props"],
              "edges --device --props printed scan_props_rows of the same games")
        idx, meta = edge.resolve_prop_rows(pa_ctx, pb_ctx, edge.read_prop_sheet("props.csv"))
        pst = out.pstats.cpu().numpy()
        n = pst.shape[0]
        same = 0
        for i in range(len(meta)):
            sd, ro, sl, co = (int(x[i]) for x in idx[:4])
            line = np.float32(idx[4][i])
            got = {k: v.item() for k, v in player_stat_probs(out.pstats, sd, ro, sl, co,
                                                             float(line)).items()}
            v = pst[:, sd, ro, sl, co]
            inv = np.float32(1) / np.float32(n)
            want = {"p_over": np.float32((v > line).sum()) * inv,
                    "p_under": np.float32((v < line).sum()) * inv,
                    "push": np.float32((np.abs(v - line) <= np.float32(1e-9)).sum()) * inv,
                    "mean": np.float32(v.astype(np.float64).sum() / n)}
            same += all(np.float32(got[k]) == want[k] for k in want)
        check(same == len(meta) > 0, f"player_stat_probs on the card == numpy over the host "
              f"pstats, exactly, for {same} of {len(meta)} resolved prop rows")
        stats = mem.get("cuda:0", {})
        check(stats and stats["peak_bytes_in_use"] >= stats["bytes_in_use"] > 0
              and stats["bytes_limit"] > stats["peak_bytes_in_use"],
              f"device_memory_stats: {mem}")
        traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
        check(len(traces) == 1, f"trace_context wrote {len(traces)} file in {trace_dir}")
        trace_mb = os.path.getsize(traces[0]) / 2 ** 20
        with open(traces[0]) as f:
            text = f.read()
        kernels = len(re.findall(r'"cat":\s*"kernel"', text))
        check(text.lstrip().startswith("{") and "traceEvents" in text and kernels > 0,
              f"trace_context wrote a Chrome trace of {trace_mb:.1f} MB, {kernels:,} kernel "
              "events")

        # 3. the sweep's chunks bitwise the keyed runs; the resume ran chunk 2 alone
        for ci, cols in chunks.items():
            want, _, _ = api.simulate_matchup_columns(
                a, b, None, SWEEP_PAIRS, runner=runner,
                key=rng.fold_in(rng.root_key(SWEEP_SEED), ci))
            _same_columns(cols, want, f"sweep chunk {ci} == simulate_matchup_columns(key="
                                      f"fold_in(root_key({SWEEP_SEED}), {ci}))")
        check(sorted(resumed) == [2] and chunk_k4[((0, 1), 2)] == chunk_k4[((), 2)] > 0,
              f"the resumed sweep played chunk 2 alone: {chunk_k4[((0, 1), 2)]} engine "
              f"launches (K4 or K1), as chunk 2 the first time")
        _same_columns(resumed[2], chunks[2], "the resumed chunk 2")

        # 4. the signature
        check(sig == SIGNATURE_HEX, f"make_signature of the fixed meta: {sig}")

        # 5. the report, its rows bitwise the slate's at the same seed
        rep, = reports
        w, pit = rep["win"], rep["pit"]
        check(rep["games"] == len(BACKTEST_GAMES) and w["n"] == len(BACKTEST_GAMES) - 1
              and 0 <= w["brier"] <= 1 and 0 <= pit["margin_ks"] <= 1
              and 0 <= pit["total_ks"] <= 1,
              f"backtest report: {rep['games']} games ({w['n']} with a winner), brier "
              f"{w['brier']}, KS margin {pit['margin_ks']}, total {pit['total_ks']}")
        srows, _ = api.simulate_slate_summary_rows(
            BACKTEST_GAMES, sp_path=sheet, artifact_dir=art, n_pairs=BACKTEST_PAIRS,
            seed=BACKTEST_SEED, device=dev)
        check(all(r["win_a"] == srows[r["_pred_index"]]["win_a"] for r in rep["rows"])
              and [r["_pred_index"] for r in rep["rows"]] == list(range(len(BACKTEST_GAMES)))
              and all((r["actual_a"], r["actual_b"]) == tuple(map(float, scores[i]))
                      for i, r in enumerate(rep["rows"])),
              "the joined rows' win_a == simulate_slate_summary_rows at the same seed, "
              "bitwise; each row its own final, the rematch in order")
        cal, ses = backtest.fit_calibration(rep)
        check(isinstance(cal, edge.MarketCalibration) and np.isfinite(
            [cal.margin_shift, cal.total_shift]).all(),
              f"fit_calibration: {cal} (se {ses})")

        # 6. slate --props == simulate_slate_prop_rows
        prop_rows = api.simulate_slate_prop_rows(
            SAVED_SLATE_GAMES, sp_path=sheet, props_csv="props.csv",
            n_pairs=EDGES_SMALL_PAIRS, mode="exact", artifact_dir=art, focus_csv="focus.csv",
            min_abs_edge_pct=0, device=dev)
        check(prop_rows and out_text["slate"].endswith(_printed(edge.print_prop_table,
                                                                prop_rows)),
              f"slate --props printed simulate_slate_prop_rows' {len(prop_rows)} rows")

        # 7. the meter
        summ = meter.summary()
        runs = [r for r in meter.records if r["phase"] == "simulate"]
        check(len(meter.records) == len(ms)
              and len(runs) == sum(1 for g in step_games.values() if g)
              and summ["games"] == sum(r["games"] for r in runs) and summ["sim_time_sec"] > 0,
              f"SimMeter: {len(meter.records)} records, {len(runs)} simulated steps, "
              f"{summ['games']:,} games")
    finally:
        os.chdir(home)
        tmp.cleanup()

    print("  query latency: " + ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items())
          + f" ({card})")
    print(f"  K4 launches by step: {k4}; K5: {k5} ({card})")
    print(f"  SimMeter: {json.dumps(meter.summary())}")
    print(f"  phase 15 took {time.perf_counter() - t_phase:.1f} s; launches K4 "
          f"{launches['philox_draws']}, K5 {launches['forest_eval']} ({card})")
    return {"launches": launches, "ms": ms, "k4": k4, "k5": k5, "trace_mb": trace_mb}


def _pass_share(out) -> float:
    """Pass attempts over pass and rush attempts in a run's box scores."""
    from fast_monte_carlo_tpu_torch.stats import TS

    p = float(out.stats[:, :, TS["pass_att"]].sum())
    return p / (p + float(out.stats[:, :, TS["rush_att"]].sum()))


def _timed_summary(runner, what: str, card: str, launches: int = LAYOUT_LAUNCHES) -> float:
    """games/s of `launches` score-only launches of LAYOUT_PAIRS pairs
    (`run_pairs_summary`), the summary checked."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = runner.run_pairs_summary(LAYOUT_PAIRS * launches, seed=LAYOUT_SEED,
                                 chunk_pairs=LAYOUT_PAIRS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    games = 2 * LAYOUT_PAIRS * launches
    check_summary(s, games, what)
    return games / dt


def _lookup_ms(runner, th, seed: int) -> tuple:
    """(heads eval ms, play step ms) of `th` at N states on the runner's
    device, in device time (`times`)."""
    import torch
    from fast_monte_carlo_tpu_torch import fixtures
    from fast_monte_carlo_tpu_torch.ops import game

    dev = runner.device
    obs = _lookup_obs(seed, dev)
    rng = np.random.default_rng(seed)
    s = game.GameState(**{k: torch.tensor(v, device=dev)
                          for k, v in fixtures.play_states(rng, N).items()})
    draws = tuple(torch.tensor(x, device=dev) for x in fixtures.play_draws(rng, (N,)))
    eval_ms = times(lambda: runner.heads_fn(th, obs, runner.pack), 20)[0]
    step_ms = times(lambda: game.play_step(s, draws, runner.pack, runner.cfg,
                                           runner.heads_fn, th), 5)[0]
    return eval_ms, step_ms


def phase_layouts(card: str, device: str = "cuda") -> dict:
    """The other table layouts: (a) a focus roster whose players the
    small heads split on, through simulate_upcoming_matchup in table mode
    (the per-head fallback), cold; (b) the ML play policy in
    table mode (`cli sim --reconstructed`, then a runner of
    reconstructed_config()); (c) each other preset of MatchupRunner; (d)
    the SlateRunner's turbo and fused slates.  `device` is the card; a
    rehearsal on the CPU passes "cpu"."""
    import os
    import tempfile

    import torch
    from fast_monte_carlo_tpu_torch import api, fixtures
    from fast_monte_carlo_tpu_torch.config import SimConfig, reconstructed_config
    from fast_monte_carlo_tpu_torch.data.context import build_team_context_from_sp_flex
    from fast_monte_carlo_tpu_torch.data.sp import load_sp_flex
    from fast_monte_carlo_tpu_torch.matchup import build_direction
    from fast_monte_carlo_tpu_torch.models.heads import load_heads, load_reconstructed_heads
    from fast_monte_carlo_tpu_torch.models.tables import nano_profile
    from fast_monte_carlo_tpu_torch.ops import game
    from fast_monte_carlo_tpu_torch.ops import table_lookup as ttl
    from fast_monte_carlo_tpu_torch.ops.pack import pack_matchup

    dev = torch.device(device)
    on = dict(device=dev)
    cfg = SimConfig()
    art = fixtures.ARTIFACT_DIR
    tmp = tempfile.TemporaryDirectory()
    sp_path = fixtures.write_sp_sheet(os.path.join(tmp.name, "sp.csv"), SP_TEAMS, SP_SEED)
    focus_csv = os.path.join(tmp.name, "focus.csv")
    fixtures.write_csv(focus_csv, fixtures.focus_rows(FOCUS_SEED), fixtures.FOCUS_COLS)
    sp = load_sp_flex(sp_path)
    heads = load_heads(art)
    small = fixtures.heads(0, "small")
    ttl._TABLE_MEMO.clear()
    api._RUNNER_MEMO.clear()
    out = {}
    torch.cuda.synchronize()
    zero_counts()

    # (a) the focus-roster fallback: the route cold, its build included
    before = engine_record()
    t0 = time.perf_counter()
    scores, players, summary, ca, cb, meta = api.simulate_upcoming_matchup_columns(
        "Team A", "Team B", sp_path=sp_path, heads=small, focus_csv=focus_csv,
        n=LAYOUT_PAIRS, seed=LAYOUT_SEED, mode="table", **on)
    torch.cuda.synchronize()
    route_s = time.perf_counter() - t0
    th = ttl.build_table_heads(ca, cb, small, cfg, nano=nano_profile(), device=dev)
    check(th.nano is None and th.fused is None and th.stage1 is not None
          and th.stage1.n_slots > 1 and th.pq.n_slots > 1,
          f"focus roster: the heads split on its players, so the runner built per-head tables "
          f"(stage 1 {th.stage1.n_slots} passer rows, pass quantiles {th.pq.n_slots} pairs)")
    check(not th.cache_hit and len(th.build_seconds) == 2,
          "the route built its tables cold: nothing read from the table disk cache")
    check_summary(_columns_summary(scores, "Team A", dev), 2 * LAYOUT_PAIRS,
                  "simulate_upcoming_matchup, focus roster, table mode")
    engines = {"focus route": engine_since(before)}
    check(len(players["sim"]) > 0, f"its player rows: {len(players['sim']):,}")
    mb = {name: t.nbytes / 1e6 for name, t in th.tables()}
    print(f"  (a) focus roster, small heads: the route took {route_s:.1f} s cold, "
          f"its build {th.build_seconds[0]:.1f} s (A on offense) and {th.build_seconds[1]:.1f} s "
          f"(B) of host numpy; tables on the card "
          + ", ".join(f"{k} {v:,.1f} MB" for k, v in mb.items())
          + f", {th.nbytes / 1e6:,.1f} MB in all ({card})")
    runner = api.MatchupRunner(ca, cb, small, cfg, "table", **on)
    check(runner.heads_state is th, "a runner on the same contexts reuses the built tables")
    torch.cuda.synchronize()
    before = engine_record()
    t0 = time.perf_counter()
    for i in range(LAYOUT_LAUNCHES):
        runner.run_pairs(LAYOUT_PAIRS, seed=LAYOUT_SEED + i, collect_players=True,
                         collect_stats=True)
    torch.cuda.synchronize()
    both = 2 * LAYOUT_PAIRS * LAYOUT_LAUNCHES / (time.perf_counter() - t0)
    engines["focus, both collectors"] = engine_since(before)
    before = engine_record()
    score_only = _timed_summary(runner, "focus roster, per-head tables, score-only", card)
    engines["focus, score-only"] = engine_since(before)
    print(f"  (a) per-head tables: {both:,.0f} games/s with both collectors, {score_only:,.0f} "
          f"score-only, {2 * LAYOUT_PAIRS:,}-game launches ({card})")
    out["focus"] = dict(build_s=list(th.build_seconds), mb=mb, both_gps=both,
                        score_gps=score_only, route_s=route_s, write_s=th.cache_seconds,
                        disk_mb=th.cache_bytes / 1e6)
    out["focus_tables"] = th
    # phase 21 holds K1 to the eager loop on these tables and times it on them
    out["k1_inputs"] = {"per-head, focus roster": (runner.pack, th, cfg)}

    # one play step on the per-head tables, CUDA against the CPU
    rng = np.random.default_rng(161)
    states = fixtures.play_states(rng, N)
    u, z = fixtures.play_draws(rng, (N,))
    ends = {}
    for d, t in ((dev, th), ("cpu", th.to("cpu"))):
        pack = pack_matchup(build_direction(ca, cb, cfg, small),
                            build_direction(cb, ca, cfg, small), d)
        st = game.GameState(**{k: torch.tensor(v, device=d) for k, v in states.items()})
        step = game.play_step(st, (torch.tensor(u, device=d), torch.tensor(z, device=d)),
                              pack, cfg, ttl.make_table_heads_eval(cfg), t)
        ends[str(d)] = {f: getattr(step, f).cpu().numpy() for f in game.GameState._fields}
    bad = np.zeros(N, bool)
    for f in ("off", "sec", "down", "period", "in_rz", "going", "score"):
        m = ends[str(dev)][f] != ends["cpu"][f]
        bad |= m.any(axis=1) if m.ndim > 1 else m
    check(bad.mean() <= 0.005, f"per-head play step at {N:,} states, CUDA vs CPU: integer "
          f"state equal in {N - int(bad.sum()):,} (>= 99.5%)")

    # (b) the ML play policy in table mode, on the small heads (their play
    # head at temperature 1.25): the CLI's own flag and route, its loader
    # handing it the small heads.  On the reference-shape heads the play
    # table takes about 54 s of host numpy, room that phase 18 needs.
    from fast_monte_carlo_tpu_torch.models import heads as heads_mod
    check(load_reconstructed_heads(art).play is not None,
          "load_reconstructed_heads reads the artifact heads with the overlay")
    rheads = small
    rcfg = reconstructed_config()
    loader, heads_mod.load_reconstructed_heads = (heads_mod.load_reconstructed_heads,
                                                  lambda *a, **k: small)
    t0 = time.perf_counter()
    try:
        text = _cli(["sim", "Team A", "Team B", "--sp", sp_path, "--artifacts", art, "-n",
                     str(LAYOUT_PAIRS), "--seed", str(LAYOUT_SEED), "--reconstructed",
                     "--device", str(dev)])
    finally:
        heads_mod.load_reconstructed_heads = loader
    cli_s = time.perf_counter() - t0
    check(all(any(line.strip().startswith(t) for line in text.splitlines())
              for t in ("Team A", "Team B", "Timing:")),
          f"cli sim --reconstructed printed its summary and timing in {cli_s:.1f} s: "
          f"{[x for x in text.splitlines() if x.startswith('Timing')]}")
    pa = build_team_context_from_sp_flex("Team A", 2025, 1, sp)
    pb = build_team_context_from_sp_flex("Team B", 2025, 1, sp)
    rr = api.MatchupRunner(pa, pb, rheads, rcfg, mode="table", **on)
    rth = rr.heads_state
    check(rth.nano is not None and rth.play is not None and len(rth.play_seconds) == 2,
          "reconstructed_config() in table mode: the nano tables with the play-policy table "
          f"beside them, {tuple(rth.play.values.shape)} f32 "
          f"(the runner reused the CLI's build: {len(ttl._TABLE_MEMO)} memo entries)")
    pre = _lookup_obs(171, dev)
    ho = rr.heads_fn(rth, pre, rr.pack)
    ho_cpu = rr.heads_fn(rth.to("cpu"), _obs_to(pre, "cpu"), None)
    lo, hi = rcfg.model.play_clip_lo, rcfg.model.play_clip_hi
    check(ho.p_pass_ml is not None and torch.equal(ho.p_pass_ml.cpu(), ho_cpu.p_pass_ml)
          and float(ho.p_pass_ml.min()) >= lo and float(ho.p_pass_ml.max()) <= hi,
          f"p_pass_ml read from the play table at {N:,} states, equal to the CPU's lookup, in "
          f"[{lo}, {hi}] (mean {float(ho.p_pass_ml.mean()):.4f})")
    shares = {}
    for label, fill in (("low", lo), ("table", None), ("high", hi)):
        rr.heads_state = rth if fill is None else dataclasses.replace(
            rth, play=dataclasses.replace(rth.play, values=torch.full_like(rth.play.values,
                                                                           fill)))
        shares[label] = _pass_share(rr.run_pairs(LAYOUT_PAIRS // 2, seed=LAYOUT_SEED,
                                                 collect_players=False))
    rr.heads_state = rth
    out["k1_inputs"]["nano + play table, reconstructed_config()"] = (rr.pack, rth, rcfg)
    check(shares["low"] < shares["table"] < shares["high"],
          f"the pass share moves with the play table: {shares['low']:.4f} with every P(pass) "
          f"at {lo}, {shares['table']:.4f} on the table, {shares['high']:.4f} at {hi}")
    before = engine_record()
    gps = _timed_summary(rr, "reconstructed_config(), table mode", card)
    engines["reconstructed_config()"] = engine_since(before)
    print(f"  (b) play-policy table (small heads): built in {rth.play_seconds[0]:.1f} s and "
          f"{rth.play_seconds[1]:.1f} s of host numpy (directions A, B; each direction's whole "
          f"build {rth.build_seconds[0]:.1f} and {rth.build_seconds[1]:.1f} s), "
          f"{rth.play.nbytes / 1e6:,.1f} MB on the card; {gps:,.0f} games/s score-only ({card})")
    out["play"] = dict(play_s=list(rth.play_seconds), build_s=list(rth.build_seconds),
                       mb=rth.play.nbytes / 1e6, gps=gps, cli_s=cli_s, shares=shares)

    # (c) every preset on the plain teams; the nano one for comparison
    out["presets"] = {}
    for q, which in LAYOUT_PRESETS:
        h = heads if which == "artifact" else small
        t0 = time.perf_counter()
        r = api.MatchupRunner(pa, pb, h, cfg, mode="table", table_quality=q, **on)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        t = r.heads_state
        layout = "nano" if t.nano is not None else "fused" if t.fused is not None else "per-head"
        check(layout == PRESET_LAYOUT[q], f"table_quality={q!r}: the {layout} layout")
        before = engine_record()
        g = _timed_summary(r, f"table_quality={q!r}", card, launches=1)   # its first launch
        engines[f"preset {q}"] = engine_since(before)
        eval_ms, step_ms = _lookup_ms(r, t, 181)
        print(f"  (c) {q} ({which} heads): built in {build_s:.2f} s, {layout} tables "
              f"{t.nbytes / 1e6:,.1f} MB; {g:,.0f} games/s score-only; heads eval "
              f"{eval_ms:.4f} ms and play step {step_ms:.3f} ms of device time at {N:,} "
              f"states ({card})")
        if q in K1_PRESETS:
            out["k1_inputs"][f"preset {q}"] = (r.pack, t, r.cfg)
        out["presets"][q] = dict(heads=which, build_s=build_s, mb=t.nbytes / 1e6, gps=g,
                                 eval_ms=eval_ms, step_ms=step_ms)
    eval_ms, step_ms = _lookup_ms(runner, th, 181)
    print(f"  (c) per-head tables of (a): heads eval {eval_ms:.4f} ms and play step "
          f"{step_ms:.3f} ms of device time at {N:,} states ({card})")
    out["focus"].update(eval_ms=eval_ms, step_ms=step_ms)

    # (d) the SlateRunner's turbo (game_shard) and fused slates
    ms = [tuple(build_team_context_from_sp_flex(x, 2025, 1, sp) for x in pair)
          for pair in LAYOUT_SLATE]
    out["slate"] = {}
    for q, shard, which in LAYOUT_SLATE_RUNS:
        t0 = time.perf_counter()
        sr = api.SlateRunner(ms, heads if which == "artifact" else small, cfg, quality=q,
                             game_shard=shard, **on)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(sr.heads_state.fused is not None and sr.heads_state.nano is None,
              f"SlateRunner(quality={q!r}): fused tables, {sr.heads_state.nbytes / 1e6:,.1f} MB")
        torch.cuda.reset_peak_memory_stats()
        before = engine_record()
        t0 = time.perf_counter()
        if shard:
            rows, per_game = sr.run_summary_rows(LAYOUT_SLATE_PAIRS, seed=LAYOUT_SEED,
                                                 chunk_pairs=LAYOUT_SLATE_PAIRS)
            check_slate_summaries(per_game, 2 * LAYOUT_SLATE_PAIRS,
                                  f"SlateRunner(quality={q!r}, game_shard=True)",
                                  LAYOUT_SLATE_BAND)
        else:
            rows = sr.summary_rows(sr.run(LAYOUT_SLATE_PAIRS, seed=LAYOUT_SEED))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        check([(r["team_a"], r["team_b"]) for r in rows] == LAYOUT_SLATE
              and all(r["n_games"] == 2 * LAYOUT_SLATE_PAIRS
                      and all(LAYOUT_SLATE_BAND[0] < r[m] < LAYOUT_SLATE_BAND[1]
                              for m in ("mean_a", "mean_b"))
                      and abs(r["win_a"] + r["win_b"] - 1) <= 0.1 for r in rows),
              f"SlateRunner(quality={q!r}): {len(rows)} summary rows, "
              f"{2 * LAYOUT_SLATE_PAIRS:,} games each")
        g = len(rows) * 2 * LAYOUT_SLATE_PAIRS / dt
        engines[f"SlateRunner {q}"] = engine_since(before)
        print(f"  (d) SlateRunner(quality={q!r}, game_shard={shard}, {which} heads): built in "
              f"{build_s:.2f} s, "
              f"{len(rows)} x {2 * LAYOUT_SLATE_PAIRS:,} games in {dt:.3f} s -> {g:,.0f} "
              f"games/s, peak device memory {peak:,.1f} MiB ({card})")
        out["slate"][q] = dict(build_s=build_s, gps=g, peak_mib=peak)
    torch.cuda.synchronize()
    for what, used in engines.items():
        print(f"  engine of {what}: {used}")
    if dev.type == "cuda":
        check(all(used.get("K1", 0) > 0 and "K4" not in used for used in engines.values()),
              "every table-mode run of the phase ran on K1 and launched no eager play chunk")
    out["engines"] = engines
    out["launches"] = read_counts("other table layouts",
                                  ["nano_game", "nano_game_fused", "nano_game_per_head",
                                   "nano_game_play", "score_moments"])
    check(out["launches"]["forest_eval"] == 0, "table mode walked no forest on the card")
    check(out["launches"]["philox_draws"] == 0,
          f"the table layouts launched philox_draws {out['launches']['philox_draws']} times "
          "(0 allowed: every table-mode launch on K1)")
    tmp.cleanup()
    return out


def tables_digest(th) -> str:
    """sha256 of every packed table of a TableHeads (values and row maps,
    in table order), read back to the host."""
    import hashlib

    h = hashlib.sha256()
    for name, t in th.tables():
        h.update(name.encode())
        for x in (t.values, t.row_map):
            h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


# phase 17 (b): a second process on the first one's disk cache; prints
# {"summary_s": seconds from its first line to the checked summary,
#  "cache_hit", "digest", "launches"} as its last line
WARM_CHILD = """
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, {repo!r})
import torch
import chip_smoke
from fast_monte_carlo_tpu_torch.utils import cuda_build
if {device!r} == "cuda":
    cuda_build.load_kernel_libraries(*chip_smoke.SOURCES)
from fast_monte_carlo_tpu_torch import api, fixtures
from fast_monte_carlo_tpu_torch.config import SimConfig
from fast_monte_carlo_tpu_torch.models.tables import nano_profile
from fast_monte_carlo_tpu_torch.ops import table_lookup as ttl
ttl.TABLE_CACHE_DIR = {cache!r}
chip_smoke.zero_counts()
heads = fixtures.heads(0, "small")
scores, players, summary, ca, cb, meta = api.simulate_upcoming_matchup_columns(
    "Team A", "Team B", sp_path={sp!r}, heads=heads, focus_csv={focus!r},
    n={pairs}, seed={seed}, mode="table", device={device!r})
chip_smoke.check_summary(chip_smoke._columns_summary(scores, "Team A", {device!r}),
                         2 * {pairs}, "the warm process's route")
summary_s = time.perf_counter() - t0
th = ttl.build_table_heads(ca, cb, heads, SimConfig(), nano=nano_profile(), device={device!r})
bad = [m for m in ("jax", "fast_monte_carlo_tpu") if m in sys.modules]
print(json.dumps(dict(summary_s=summary_s, cache_hit=th.cache_hit,
                      load_s=th.cache_seconds, digest=chip_smoke.tables_digest(th),
                      launches=chip_smoke.launch_count("philox_draws"),
                      k1=chip_smoke.launch_count("nano_game"),
                      k1_per_head=chip_smoke.launch_count("nano_game_per_head"),
                      players=len(players["sim"]), imported=bad)))
"""


def phase_cache(card: str, layouts: dict, phase16_dir: str, cache_root: str,
                device: str = "cuda") -> dict:
    """The table disk cache and sd_mode='cachewarm': (a) what phase 16 (a)'s
    cold focus-roster build wrote (seconds, MB); (b) a second process on
    that cache runs the same route and finds the tables on disk; (c) a
    cachewarm nano runner on the reference-shape heads (warm-up, build,
    the warm-up read back, games/s beside axis nano); (d) `cli sim
    --sd-mode cachewarm`; (e) a 4-matchup cachewarm SlateRunner, built
    twice, the second time from disk alone.  `device` is the card; a
    rehearsal on the CPU passes "cpu"."""
    import tempfile

    import torch
    from fast_monte_carlo_tpu_torch import api, fixtures
    from fast_monte_carlo_tpu_torch.config import SimConfig
    from fast_monte_carlo_tpu_torch.data.context import build_team_context_from_sp_flex
    from fast_monte_carlo_tpu_torch.data.sp import load_sp_flex
    from fast_monte_carlo_tpu_torch.models.heads import load_heads
    from fast_monte_carlo_tpu_torch.ops import rng
    from fast_monte_carlo_tpu_torch.ops import table_lookup as ttl

    out = {}
    on = dict(device=torch.device(device))
    art = fixtures.ARTIFACT_DIR
    tmp = tempfile.TemporaryDirectory()
    sp_path = fixtures.write_sp_sheet(os.path.join(tmp.name, "sp.csv"), SP_TEAMS, SP_SEED)
    focus_csv = os.path.join(tmp.name, "focus.csv")
    fixtures.write_csv(focus_csv, fixtures.focus_rows(FOCUS_SEED), fixtures.FOCUS_COLS)
    focus = layouts["focus"]
    th16 = layouts["focus_tables"]

    # (a) the cold build's files
    files = sorted(os.listdir(phase16_dir))
    check(focus["disk_mb"] > 0 and any(f.startswith("tables_") for f in files),
          f"(a) phase 16 (a)'s cold focus-roster build wrote its tables: {focus['disk_mb']:,.1f} "
          f"MB on disk in {focus['write_s']:.2f} s ({len(files)} files in phase 16's cache)")
    out["write"] = dict(write_s=focus["write_s"], disk_mb=focus["disk_mb"])

    # (b) a warm process: the same route, its tables read from disk
    child = WARM_CHILD.format(repo=str(REPO), cache=phase16_dir, sp=sp_path, focus=focus_csv,
                              pairs=LAYOUT_PAIRS, seed=LAYOUT_SEED,
                              device=device)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", child], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"(b) the warm process exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    check(got["cache_hit"] and got["imported"] == [] and got["players"] > 0,
          f"(b) the warm process read the focus roster's tables from disk in "
          f"{got['load_s']:.2f} s, its summary and {got['players']:,} player rows well formed, "
          "no jax imported")
    check(got["digest"] == tables_digest(th16),
          f"(b) its packed tables equal the cold build's bitwise (sha256 {got['digest'][:16]})")
    check(got["launches"] == 0 and got["k1_per_head"] > 0,
          f"(b) the warm process ran the focus roster on K1's per-head instantiation "
          f"({got['k1_per_head']} launches) and launched philox_draws {got['launches']} times "
          "(0 allowed)")
    for name, key in (("nano_game", "k1"), ("nano_game_per_head", "k1_per_head")):
        PATH_LAUNCHES[name] = PATH_LAUNCHES.get(name, 0) + got[key]
    print(f"  (b) focus roster route: {got['summary_s']:.1f} s from the warm process's start "
          f"to its summary ({wall:.1f} s wall for the whole process), against "
          f"{focus['route_s']:.1f} s cold in phase 16 ({card})")
    out["warm_process"] = dict(summary_s=got["summary_s"], wall_s=wall,
                               load_s=got["load_s"], cold_route_s=focus["route_s"])

    # (c) cachewarm on the reference-shape heads, nano, the default warm-up
    ttl.TABLE_CACHE_DIR = os.path.join(cache_root, "phase17")
    ttl._TABLE_MEMO.clear()
    api._RUNNER_MEMO.clear()
    heads = load_heads(art)
    sp = load_sp_flex(sp_path)
    pa = build_team_context_from_sp_flex("Team A", 2025, 1, sp)
    pb = build_team_context_from_sp_flex("Team B", 2025, 1, sp)
    base = SimConfig()
    cw = base.replace(engine=dataclasses.replace(base.engine, sd_mode="cachewarm",
                                                 cachewarm_games=CACHEWARM_GAMES))
    plain_calls = []
    reference = rng.philox_draws_reference

    def counted_reference(*a, **k):
        plain_calls.append(a)
        return reference(*a, **k)

    torch.cuda.synchronize()
    zero_counts()
    rng.philox_draws_reference = counted_reference
    try:
        t0 = time.perf_counter()
        r = api.MatchupRunner(pa, pb, heads, cw, mode="table", **on)
        cold_s = time.perf_counter() - t0
        th = r.heads_state
        check(th.nano is not None and th.nano_nsd == 1 and not th.warm_hit
              and not th.cache_hit,
              f"(c) cachewarm nano tables, one sd bin ({th.nano_c} channels a (down, sd) "
              f"block), the warm-up played and the tables built")
        ttl._TABLE_MEMO.clear()
        t0 = time.perf_counter()
        again = ttl.build_table_heads(pa, pb, heads, cw, **on, **api.table_profiles("nano"))
        again_s = time.perf_counter() - t0
        check(again.warm_hit and again.cache_hit
              and torch.equal(again.nano.values, th.nano.values),
              "(c) a second build read the warm-up and the tables from disk: the same tables")
        r.run_pairs_summary(LAYOUT_PAIRS, seed=LAYOUT_SEED)      # warm-up launch
        gps_cw = _timed_summary(r, "cachewarm nano", card, launches=1)
        ax = api.MatchupRunner(pa, pb, heads, base, mode="table", **on)
        ax.run_pairs_summary(LAYOUT_PAIRS, seed=LAYOUT_SEED)
        gps_ax = _timed_summary(ax, "axis nano", card, launches=1)
    finally:
        rng.philox_draws_reference = reference
    print(f"  (c) cachewarm, reference-shape heads, {CACHEWARM_GAMES} warm-up games: warm-up "
          f"{th.warm_seconds:.2f} s, build {th.build_seconds[0]:.2f} + "
          f"{th.build_seconds[1]:.2f} s (directions A, B), runner {cold_s:.2f} s in all; a "
          f"second build read the warm-up in {again.warm_seconds:.3f} s and the tables in "
          f"{again.cache_seconds:.3f} s ({again_s:.2f} s in all); {gps_cw:,.0f} games/s "
          f"score-only against {gps_ax:,.0f} for axis nano (ratio {gps_cw / gps_ax:.3f}), "
          f"{2 * LAYOUT_PAIRS:,}-game launches ({card})")
    out["cachewarm"] = dict(warm_s=th.warm_seconds, warm_again_s=again.warm_seconds,
                            build_s=list(th.build_seconds), runner_s=cold_s,
                            load_s=again.cache_seconds, gps=[gps_cw], axis_gps=[gps_ax])

    # (d) the CLI
    t0 = time.perf_counter()
    text = _cli(["sim", "Team A", "Team B", "--sp", sp_path, "--artifacts", art, "-n",
                 str(LAYOUT_PAIRS), "--seed", str(LAYOUT_SEED), "--sd-mode", "cachewarm",
                 "--device", device])
    cli_s = time.perf_counter() - t0
    check(all(any(line.strip().startswith(t) for line in text.splitlines())
              for t in ("Team A", "Team B", "Timing:")),
          f"(d) cli sim --sd-mode cachewarm printed its summary and timing in {cli_s:.1f} s "
          f"(the warm-up and tables of (c) read from disk): "
          f"{[x for x in text.splitlines() if x.startswith('Timing')]}")
    out["cli_s"] = cli_s

    # (e) a 4-matchup cachewarm slate, built twice
    small = fixtures.heads(0, "small")
    ms = [tuple(build_team_context_from_sp_flex(x, 2025, 1, sp) for x in pair)
          for pair in LAYOUT_SLATE]
    scw = base.replace(engine=dataclasses.replace(base.engine, sd_mode="cachewarm",
                                                  cachewarm_games=SLATE_WARM_GAMES))
    t0 = time.perf_counter()
    sr = api.SlateRunner(ms, small, scw, game_shard=True, **on)
    first_s = time.perf_counter() - t0
    calls = []
    build, oracle = ttl.build_fused_table, ttl.OracleMatchup
    ttl.build_fused_table = lambda *a, **k: calls.append("build") or build(*a, **k)
    ttl.OracleMatchup = lambda *a, **k: calls.append("oracle") or oracle(*a, **k)
    try:
        t0 = time.perf_counter()
        sr2 = api.SlateRunner(ms, small, scw, game_shard=True, **on)
        second_s = time.perf_counter() - t0
    finally:
        ttl.build_fused_table, ttl.OracleMatchup = build, oracle
    check(calls == [] and torch.equal(sr2.heads_state.nano.values, sr.heads_state.nano.values)
          and sr.heads_state.nano_nsd == 1,
          f"(e) cachewarm SlateRunner, {len(ms)} matchups: built in {first_s:.2f} s "
          f"({SLATE_WARM_GAMES} warm-up games a matchup), built again in {second_s:.2f} s "
          "from disk alone (no fused table built, no oracle game played), the same tables")
    rows, per_game = sr2.run_summary_rows(LAYOUT_SLATE_PAIRS, seed=LAYOUT_SEED,
                                          chunk_pairs=LAYOUT_SLATE_PAIRS)
    check_slate_summaries(per_game, 2 * LAYOUT_SLATE_PAIRS, "cachewarm SlateRunner",
                          LAYOUT_SLATE_BAND)
    torch.cuda.synchronize()
    out["slate"] = dict(first_s=first_s, second_s=second_s)
    out["launches"] = read_counts("table disk cache and cachewarm",
                                  ["nano_game", "score_moments"])
    check(not plain_calls, "(c) the plain draw path was never taken on the card")
    out["launches"]["philox_draws"] += got["launches"]
    tmp.cleanup()
    return out

def shard_inputs(device, shard: bool):
    """Phase 18's runners on `device`: the main path's MatchupRunner (the
    fixture teams, the seed-7 nano table, pallas_chunk), sharded or not,
    and a game-layout SlateRunner of SHARD_SLATE_GAMES fixture matchups (in
    a group of several ranks, this rank's block) with the device bytes its
    construction took; and phase 9's Q4 05:00 situation."""
    import torch
    from fast_monte_carlo_tpu_torch import api, fixtures
    from fast_monte_carlo_tpu_torch.config import SimConfig

    cfg = SimConfig()
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, rng_impl="pallas_chunk"))
    runner = api.MatchupRunner(*fixtures.teams(), None, cfg, mode="table",
                               nano_tables=fixtures.nano_tables(TABLE_SEED), device=device,
                               shard=shard)
    matchups, tables = fixtures.slate(SHARD_SLATE_GAMES, SLATE_SEED)
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    slate = api.SlateRunner(matchups, nano_tables=tables, device=device, game_shard=True)
    torch.cuda.synchronize(device)
    held = torch.cuda.memory_allocated(device) - before
    q4 = api.situation_from_fields(ytg=40, offense="A", quarter=4, clock="05:00", down=2,
                                   dist=7, score_a=21, score_b=17)
    return runner, slate, q4, held


def summary_digest(s) -> str:
    """sha256 of every field of a ScoreSummary (torch or numpy), in order."""
    import hashlib

    return hashlib.sha256(b"".join(
        (f.detach().cpu().numpy() if hasattr(f, "detach") else np.asarray(f)).tobytes()
        for f in s)).hexdigest()


def shard_runs(runner, slate, q4, group=None) -> dict:
    """Phase 18's three runs on one rank (or unsharded, without `group`):
    the digests of run_pairs_summary, run_live and the game layout's
    per-matchup summaries, and each run's seconds."""
    import torch

    out = {}
    t0 = time.perf_counter()
    s = runner.run_pairs_summary(SHARD_PAIRS, seed=SHARD_SEED, chunk_pairs=SHARD_CHUNK)
    torch.cuda.synchronize()
    out["pairs_s"], out["pairs"] = time.perf_counter() - t0, summary_digest(s)
    check_summary(s, 2 * SHARD_PAIRS, "run_pairs_summary" + (" sharded" if group else ""))
    t0 = time.perf_counter()
    live = runner.run_live(q4, n_games=SHARD_LIVE_GAMES, seed=SHARD_SEED)
    torch.cuda.synchronize()
    out["live_s"], out["live"] = time.perf_counter() - t0, summary_digest(live)
    t0 = time.perf_counter()
    rows, per_game = slate.run_summary_rows(SHARD_SLATE_PAIRS, seed=SHARD_SEED,
                                            chunk_pairs=SHARD_SLATE_PAIRS, mesh=group)
    out["slate_s"] = time.perf_counter() - t0
    out["slate"] = summary_digest([f for s in per_game for f in s])
    check_slate_summaries(per_game, 2 * SHARD_SLATE_PAIRS, "game layout"
                          + (" over the ranks" if group else " on one card"))
    return out


# phase 18 (b): one of the two ranks, started by the smoke with its rank as
# argv[1]; forms the group from a FileStore, builds its runners, waits for
# the smoke's go file, runs `shard_runs` and prints one JSON line
SHARD_CHILD = """
import json, os, sys, time
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
import chip_smoke
from fast_monte_carlo_tpu_torch.utils import cuda_build
rank = int(sys.argv[1])
device = torch.device("cuda", rank if {backend!r} == "nccl" else 0)
torch.cuda.set_device(device)
cuda_build.load_kernel_libraries(*chip_smoke.SOURCES)
dist.init_process_group({backend!r}, store=dist.FileStore({store!r}, 2), rank=rank,
                        world_size=2)
from fast_monte_carlo_tpu_torch.parallel import mesh
group = mesh.trial_group(device)
assert (group.rank, group.world, group.backend) == (rank, 2, {backend!r})
runner, slate, q4, held = chip_smoke.shard_inputs(device, shard=True)
while not os.path.exists({go!r}):
    time.sleep(0.05)
dist.barrier()
chip_smoke.zero_counts()
out = chip_smoke.shard_runs(runner, slate, q4, group)
torch.cuda.synchronize()
bad = [m for m in ("jax", "fast_monte_carlo_tpu") if m in sys.modules]
print(json.dumps(dict(out, rank=rank, block=list(slate.block), held=held, imported=bad,
                      launches={{k: chip_smoke.launch_count(k)
                                 for k in chip_smoke.kernel_counts()}})))
dist.barrier()          # both ranks done before either tears the group down
dist.destroy_process_group()
"""


def phase_shard(card: str) -> dict:
    """Trial sharding on the card: (a) a world of one over NCCL in this
    process, MatchupRunner(shard=True) against shard=False (run_pairs_summary
    at 2 launches of 65,536 games, timed, and run_live) bit for bit; (b) two
    ranks as child processes (NCCL on two cards where there are two, else
    gloo with both on cuda:0, where each rank launches K4 on the card and
    only the collectives pass through the host): run_pairs_summary,
    run_live and the game layout over the ranks, bit for bit the unsharded
    runs, each child launching philox_draws and importing neither jax nor
    the JAX package; (c) `cli sim --shard` in a world of one and a server
    request with "shard": true."""
    import tempfile
    import threading

    import torch
    import torch.distributed as dist
    from fast_monte_carlo_tpu_torch import fixtures
    from fast_monte_carlo_tpu_torch.serve import ServeConfig, SimService, make_server

    out = {}
    tmp = tempfile.TemporaryDirectory()
    counted = ("philox_draws", "nano_game", "score_moments")
    # launches of this process's sharded runs (not the references)
    own = dict.fromkeys(counted, 0)

    def sharded_run(fn):
        before = {k: launch_count(k) for k in counted}
        res = fn()
        for k in counted:
            own[k] += launch_count(k) - before[k]
        return res

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    go = os.path.join(tmp.name, "go")
    child = SHARD_CHILD.format(repo=str(REPO), backend=backend,
                               store=os.path.join(tmp.name, "store"), go=go)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    # the ranks start (torch, the kernels, their runners) while (a) runs,
    # and play once (a) is done, alone on the card
    ranks = [subprocess.Popen([sys.executable, "-c", child, str(r)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        # (a) a world of one over NCCL
        torch.cuda.synchronize()
        zero_counts()
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
        sharded, slate, q4, whole = shard_inputs("cuda:0", shard=True)
        check((sharded.group.world, sharded.group.backend) == (1, "nccl"),
              "(a) MatchupRunner(shard=True) in an NCCL world of one on cuda:0")
        plain, _, _, _ = shard_inputs("cuda:0", shard=False)
        runs = {}
        for name, r in (("unsharded", plain), ("sharded", sharded)):
            t0 = time.perf_counter()
            runs[name] = (sharded_run if r.shard else lambda f: f())(
                lambda: r.run_pairs_summary(SHARD_PAIRS, seed=SHARD_SEED,
                                            chunk_pairs=SHARD_CHUNK))
            torch.cuda.synchronize()
            runs[name + "_s"] = time.perf_counter() - t0
        check(summary_digest(runs["sharded"]) == summary_digest(runs["unsharded"]),
              f"(a) run_pairs_summary(shard=True), {2 * SHARD_PAIRS:,} games in "
              f"{2 * SHARD_PAIRS // (2 * SHARD_CHUNK)} launches: every field bitwise equal to "
              "shard=False")
        check_summary(runs["sharded"], 2 * SHARD_PAIRS, "(a) sharded run_pairs_summary")
        gps = {k: 2 * SHARD_PAIRS / runs[k + "_s"] for k in ("unsharded", "sharded")}
        print(f"  (a) world of one: {gps['sharded']:,.0f} games/s sharded against "
              f"{gps['unsharded']:,.0f} unsharded, one run each in turns ({card})")
        live = sharded_run(lambda: sharded.run_live(q4, n_games=SHARD_LIVE_GAMES,
                                                    seed=SHARD_SEED))
        live0 = plain.run_live(q4, n_games=SHARD_LIVE_GAMES, seed=SHARD_SEED)
        check(summary_digest(live) == summary_digest(live0),
              f"(a) run_live(shard=True), {SHARD_LIVE_GAMES:,} games from Q4 05:00: bitwise "
              "equal to the unsharded run")
        dist.destroy_process_group()
        torch.cuda.synchronize()
        out["world_of_one"] = dict(gps)
        want = dict(pairs=summary_digest(runs["unsharded"]), live=summary_digest(live0))
        del runs, sharded

        # (b) two ranks
        open(go, "w").close()
        t0 = time.perf_counter()
        got = []
        for r, p in enumerate(ranks):
            o, e = p.communicate(timeout=SHARD_CHILD_S)
            check(p.returncode == 0, f"(b) rank {r} exited {p.returncode}"
                  + (f": {e[-3000:]}" if p.returncode else ""))
            got.append(json.loads(o.strip().splitlines()[-1]))
        wall = time.perf_counter() - t0
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.communicate()
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"  (b) two ranks over {backend} ("
          + ("cuda:0 and cuda:1" if backend == "nccl" else "both on cuda:0, the collectives "
             "through the host") + f"), {wall:.1f} s from the go")
    rows, per_game = slate.run_summary_rows(SHARD_SLATE_PAIRS, seed=SHARD_SEED,
                                            chunk_pairs=SHARD_SLATE_PAIRS)
    want["slate"] = summary_digest([f for s in per_game for f in s])
    for what, label in (("pairs", f"run_pairs_summary(shard=True), {2 * SHARD_PAIRS:,} games"),
                        ("live", f"run_live(shard=True), {SHARD_LIVE_GAMES:,} games"),
                        ("slate", f"the game layout over the ranks, {SHARD_SLATE_GAMES} "
                                  f"matchups x {2 * SHARD_SLATE_PAIRS:,} games")):
        check(got[0][what] == got[1][what] == want[what],
              f"(b) {label}: both ranks hold the unsharded run's summaries bitwise "
              f"(sha256 {want[what][:16]})")
    blk = -(-SHARD_SLATE_GAMES // 2)
    check([g["block"] for g in got] == [[0, blk], [blk, SHARD_SLATE_GAMES]]
          and all(0 < g["held"] <= whole * blk / SHARD_SLATE_GAMES + 2 ** 20 for g in got),
          f"(b) each rank built and holds only its block of the slate, matchups "
          f"{got[0]['block']} and {got[1]['block']}: {got[0]['held'] / 1e6:,.1f} and "
          f"{got[1]['held'] / 1e6:,.1f} MB on its card against {whole / 1e6:,.1f} MB for the "
          "whole slate on one card")
    check(all(g["launches"]["nano_game"] > 0 and g["launches"]["score_moments"] > 0
              and g["imported"] == [] for g in got),
          f"(b) each rank launched nano_game ({got[0]['launches']['nano_game']} and "
          f"{got[1]['launches']['nano_game']} times) and score_moments, and imported no jax "
          "or fast_monte_carlo_tpu")
    pair_gps = 2 * SHARD_PAIRS / max(g["pairs_s"] for g in got)
    slate_gps = 2 * SHARD_SLATE_PAIRS * SHARD_SLATE_GAMES / max(g["slate_s"] for g in got)
    print(f"  (b) {backend} pair: run_pairs_summary {pair_gps:,.0f} games/s (the slower rank's "
          f"{max(g['pairs_s'] for g in got):.2f} s), run_live "
          f"{max(g['live_s'] for g in got):.3f} s, the game layout {slate_gps:,.0f} games/s "
          f"({card})")
    out["pair"] = dict(backend=backend, gps=pair_gps, slate_gps=slate_gps,
                       live_s=max(g["live_s"] for g in got), wall_s=wall)

    # (c) the CLI and the server, in a world of one (no process group)
    sp_path = fixtures.write_sp_sheet(os.path.join(tmp.name, "sp.csv"), SP_TEAMS, SP_SEED)
    argv = ["sim", "Team A", "Team B", "--sp", sp_path, "--artifacts", fixtures.ARTIFACT_DIR,
            "--mode", "analytic", "-n", str(SHARD_CLI_PAIRS), "--seed", str(SHARD_SEED),
            "--device", "cuda"]
    texts = [[x for x in (sharded_run if extra else lambda f: f())(
        lambda: _cli(argv + extra)).splitlines() if not x.startswith("Timing")]
        for extra in (["--shard"], [])]
    check(texts[0] == texts[1] and any(x.startswith("Team A") for x in texts[0]),
          "(c) cli sim --shard in a world of one prints what cli sim prints")
    service = SimService(ServeConfig(sp_path=sp_path, artifact_dir=fixtures.ARTIFACT_DIR,
                                     mode="analytic", device="cuda"))
    srv = make_server(service, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    answers = []
    for shard in (True, False):
        code, ans, dt = (sharded_run if shard else lambda f: f())(lambda: _http(
            base, "/sim", {"team_a": "Team A", "team_b": "Team B",
                           "n_pairs": SHARD_CLI_PAIRS, "seed": SHARD_SEED, "shard": shard}))
        check(code == 200, f"(c) /sim with \"shard\": {str(shard).lower()} answered {code} in "
              f"{dt:.2f} s")
        answers.append({k: v for k, v in ans.items() if k != "elapsed_s"})
    srv.shutdown()
    srv.server_close()
    check(answers[0] == answers[1], "(c) the server's sharded /sim equals its unsharded one")
    children = {k: sum(g["launches"][k] for g in got) for k in counted}
    check(own["nano_game"] > 0, f"the sharded runs of this process launched {own} (the ranks "
          f"{children}; the unsharded references not counted)")
    out["launches"] = {k: own[k] + children[k] for k in counted}
    tmp.cleanup()
    return out


def phase_bench(card: str, main_gps: float) -> dict:
    """The bench entry on the card (BENCH_RUNS), each run a subprocess as a
    user starts it: one JSON line with the contract's keys, on the gpu,
    complete, its launches (the bench's own counters over its timed runs)
    and its stderr sanity line checked; its games/s beside phase 5's.
    Returns the runs' philox_draws, forest_eval, nano_game and score_moments
    launches."""
    counts = dict.fromkeys(("philox_draws", "forest_eval", "nano_game", "score_moments"), 0)
    for mode, argv in BENCH_RUNS:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *argv], cwd=REPO, capture_output=True,
                              text=True, timeout=BENCH_RUN_S)
        dt = time.perf_counter() - t0
        what = f"({mode}) {' '.join(argv[1:])}"
        if proc.returncode != 0:
            print(proc.stderr[-3000:])
        check(proc.returncode == 0, f"{what}: exit {proc.returncode} in {dt:.1f} s")
        lines = [line for line in proc.stdout.splitlines() if line.strip()]
        check(len(lines) == 1, f"{what}: one stdout line (got {len(lines)})")
        rec = json.loads(lines[0])
        meta = rec["meta"]
        check(set(rec) == BENCH_KEYS and rec["unit"] == "games/sec" and rec["value"] > 0,
              f"{what}: the contract's keys, {rec['value']:,.1f} games/s > 0")
        check(meta["device"]["platform"] == "gpu" and meta["emit"] == "complete"
              and meta["mode"] == mode,
              f"{what}: on {meta['device']['kind']} ({meta['card']}), emit "
              f"{meta['emit']}, mode {meta['mode']}")
        got = meta["launches"]
        k4, k5, k1 = got["philox_draws"], got["forest_eval"], got["nano_game"]
        # either mode: K1 a launch (exact mode's forests walked inside it), no
        # draw buffer, no forest_eval launch
        check(k1 > 0 and k4 == 0 and k5 == 0 and got["score_moments"] > 0,
              f"{what}: nano_game {k1} launches, score_moments {got['score_moments']}, "
              f"philox_draws {k4}, forest_eval {k5}")
        m = BENCH_SANITY.search(proc.stderr)
        check(m is not None and all(10 < float(v) < 50 for v in m.groups()[:2])
              and 0 < float(m.group(3)) < 1,
              f"{what}: sanity {m.group(0) if m else 'missing'}: mean points in (10, 50)")
        for k in counts:
            counts[k] += got[k]
        print(f"  ({mode}) {rec['metric']}: {rec['value']:,.1f} games/s over "
              f"{meta['n_games']:,} games (runs {meta['runs']}), setup {meta['setup_s']} s, "
              f"compile {meta['compile_s']} s, {dt:.1f} s in all ({card})")
        if mode == "table":
            print(f"  bench table mode {rec['value']:,.1f} games/s beside phase 5's "
                  f"{main_gps:,.1f} (ratio {rec['value'] / main_gps:.3f}; nano tables from "
                  "the fixture heads here, the seed-7 fixture table there)")
    return counts


def write_train_csv(path: str) -> None:
    """TRAIN_ROWS seeded plays in the ml_* columns cli train reads (the
    flags it derives left out)."""
    from fast_monte_carlo_tpu_torch import fixtures

    rng = np.random.default_rng(TRAIN_SEED)
    n = TRAIN_ROWS
    cols = {
        "down": rng.integers(1, 5, n), "distance": rng.integers(1, 16, n),
        "yardsToGoal": rng.integers(1, 100, n), "score_diff": rng.integers(-21, 22, n),
        "seconds_remaining": rng.integers(0, 3601, n), "offenseTimeouts": np.full(n, 3),
        "defenseTimeouts": np.full(n, 3), "sp_rating_off": rng.normal(5, 10, n).round(1),
        "sp_offense_rating_off": rng.normal(30, 7, n).round(1),
        "sp_defense_rating_def": rng.normal(25, 7, n).round(1),
        "sp_rating_def": rng.normal(5, 10, n).round(1),
        "passer_name": rng.choice(["Qb One", "Qb Two"], n),
        "target_name": rng.choice(["Wr One", "Wr Two", "Wr Three"], n),
        "rusher_name": rng.choice(["Rb One", "Rb Two"], n),
        "head_coach": rng.choice(["Coach A", "Coach B"], n),
        "year": rng.choice([2022, 2023, 2024], n),
        "pass_outcome": rng.choice(["complete", "incomplete", "sack", "intercepted"], n,
                                   p=[0.62, 0.28, 0.07, 0.03]),
        "yardsGained": rng.integers(-5, 30, n), "fumble_lost": (rng.random(n) < 0.05).astype(int),
        "play_category": rng.choice(["pass", "run"], n)}
    rows = [{k: v[i] for k, v in cols.items()} for i in range(n)]
    fixtures.write_csv(path, rows, tuple(cols))


def nano_diff(want, got, what: str) -> float:
    """Games whose final state differs between a plain version (`want`: the
    eager loop or `nano_game_plain`) and K1 (`got`), printed by field.  K1
    is bitwise equal to both by design (the same f32 operations in the same
    order, the same Philox stream), so one differing game fails the phase.
    Returns the largest absolute difference on any field."""
    import torch

    n = want.off.shape[0]
    bad = torch.zeros(n, dtype=torch.bool, device=got.off.device)
    by_field, err = {}, 0.0
    for f in ("off", "sec", "down", "dist", "ytg", "period", "in_rz", "going", "score",
              "stats", "pstats"):
        x, y = getattr(want, f), getattr(got, f)
        m = (x != y).reshape(n, -1).any(dim=1)
        by_field[f] = int(m.sum())
        bad |= m
        err = max(err, float((x.double() - y.double()).abs().max()))
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} of {n:,} games differ (0 allowed); "
          f"by field {by_field}")
    return err


def nano_bound(games: int, plays: int, table_bytes: int,
               accrual: Optional[dict] = None) -> dict:
    """`bound` of one K1 launch: the games' state read and written once, the
    nano table read once, NANO_COUNTS a play over the plays the games took;
    with the collectors' work of the launch (`accrual_work`), the team
    stats read and written once and each player row the launch touched
    read and written once, NANO_TEAM_COUNTS a play, NANO_SLOT_COUNTS a slot
    sampled and NANO_ROW_COUNTS a player row added."""
    return _k1_bound(games * (NANO_STATE_IN + NANO_STATE_OUT) + table_bytes,
                     per(NANO_COUNTS, plays), plays, accrual)


def _k1_bound(nbytes: float, counts: dict, plays: int, accrual: Optional[dict]) -> dict:
    """`bound` of a K1 launch's bytes and counts, with the collectors' work
    (`accrual_work`) where given."""
    if accrual is not None:
        nbytes += 2 * (accrual["stats_bytes"] + accrual["rows_touched"] * 6 * 4)
        for cl, items in ((NANO_TEAM_COUNTS, plays), (NANO_SLOT_COUNTS, accrual["sampled"]),
                          (NANO_ROW_COUNTS, accrual["rows_added"])):
            _add(counts, cl, items)
    return bound(nbytes, counts)


def bin_counts(axes) -> dict:
    """The instructions binning takes a play: `axes` holds each binned
    axis's segment count."""
    b, a = sum(max(k - 1, 0) for k in axes), len(axes)
    return {"alu": 2 * b + 2 * a, "imad": 0, "mufu_cvt": 2 * a, "dispatch": 2 * b + 7 * a}


def _add(counts: dict, more: dict, times: float = 1.0) -> None:
    for k, v in more.items():
        counts[k] += v * times


def layout_counts(args, walk: Optional[dict] = None) -> dict:
    """K1's instructions a play on the packed inputs `args` (any layout),
    by LAYOUT rules above: NANO_COUNTS less the nano profile's binning,
    plus the layout's binning and lookups.  The heads that read no table:
    less the row's loads too; in exact mode the three slots sampled and
    `walk`, the FOREST_* counts a play of the walks taken (`exact_walk`)."""
    import math

    def nsegs(g):
        return sum(1 for e in g.enter if not math.isinf(e) or e < 0)

    c, lay = args.consts, args.layout
    counts = dict(NANO_COUNTS)
    _add(counts, bin_counts([5, 8, 8, 1]), -1)
    if args.table_layout in ("analytic", "exact"):
        counts["dispatch"] -= NANO_ROW_LOADS
        if args.table_layout == "exact":
            _add(counts, HEAD_SLOT_COUNTS, 3)
            for k, v in (walk or {}).items():
                counts[k] = counts.get(k, 0.0) + v
        return counts
    sd1 = lay.sd1 if args.kind else c.nsd > 1
    _add(counts, bin_counts([nsegs(c.dist), nsegs(c.ytg), nsegs(c.sec)]
                            + ([nsegs(c.sd)] if sd1 else [])))
    per_head = args.table_layout == "per_head"
    if lay.has_play or per_head:
        coarse_sd = per_head and any(lay.heads[i].has_sd and lay.heads[i].profile
                                     for i, t in enumerate(args.heads) if t is not None)
        _add(counts, bin_counts([nsegs(lay.dist2), nsegs(lay.ytg2), nsegs(lay.sec2)]
                                + ([nsegs(lay.sd2)] if coarse_sd else [])))
    if lay.has_play:
        _add(counts, PLAY_SEARCH_COUNTS)
    if per_head:
        _add(counts, HEAD_SLOT_COUNTS, 3)
        read = [i for i, t in enumerate(args.heads) if t is not None
                and (i != 5 or lay.use_fumble)]
        counts["alu"] += 4 * len(read)
        counts["dispatch"] += (5 * len(read) + sum(HEAD_CHANNELS[i] for i in read)
                               - NANO_ROW_LOADS)
    return counts


def table_read_bytes(args, plays: int) -> float:
    """The table bytes a K1 launch must read, table by table: a table
    whose bytes a matchup fit in the L2 once, a larger one a sector a
    lookup a play (a row of the nano or fused table: the sectors its
    channels span; a per-head table read and the play table: one)."""
    tables = []       # (bytes, sectors a play)
    if args.table_layout in ("analytic", "exact"):
        # no table; the forests' records (read from the L2 a play)
        return args.exact.records.numel() * 4 if args.exact is not None else 0
    if args.table_layout == "per_head":
        tables += [(t[0].numel() * 4 + t[1].numel() * 4, 1) for i, t in enumerate(args.heads)
                   if t is not None and (i != 5 or args.layout.use_fumble)]
    else:
        nch = 7 + 2 * args.consts.has_s2 + args.consts.has_fumble
        tables.append((args.table.numel() * 4, -(-nch * 4 // SECTOR_BYTES)))
    if args.play is not None:
        tables.append((args.play.numel() * 4, 1))
    matchups = args.dirs.shape[0] // 2
    return sum(nbytes if nbytes / matchups <= L2_BYTES else plays * sectors * SECTOR_BYTES
               for nbytes, sectors in tables)


def layout_bound(args, games: int, plays: int, accrual: Optional[dict] = None,
                 walk: Optional[dict] = None) -> dict:
    """`bound` of one K1 launch on any layout (`nano_bound`'s terms with
    `layout_counts` a play, `walk` the walks' counts a play in exact mode,
    and `table_read_bytes`)."""
    return _k1_bound(games * (NANO_STATE_IN + NANO_STATE_OUT) + table_read_bytes(args, plays),
                     per(layout_counts(args, walk), plays), plays, accrual)


def accrual_work(out) -> dict:
    """What K1's collectors did in a launch from zero stats with both on,
    read off its box score and player stats: the slots sampled (the QB and
    the target a pass play, the rusher a run), the player rows added (one
    a tracked slot: a QB row's attempt or sack, a rusher's attempt, a
    target's target each count 1), the distinct player rows touched, and
    the team stats' bytes."""
    from fast_monte_carlo_tpu_torch.stats import PC_ATT, PC_SACKS, ROLE_PASS, TS

    st, ps = out.stats, out.pstats
    pass_plays = float((st[..., TS["pass_att"]] + st[..., TS["sacks"]]).sum())
    return {"sampled": 2 * pass_plays + float(st[..., TS["rush_att"]].sum()),
            "rows_added": float(ps[..., PC_ATT].sum() + ps[:, :, ROLE_PASS, :, PC_SACKS].sum()),
            "rows_touched": int((ps != 0).any(-1).sum()), "stats_bytes": st.numel() * 4}


def moment_bound(groups: int, n: int) -> dict:
    """`bound` of one K2 launch: 8 bytes a game read, the counts and the
    histograms written once, MOMENT_COUNTS a game."""
    return bound(groups * n * 8 + groups * (MOMENT_FIELDS * 8 + MOMENT_BINS * 4),
                 per(MOMENT_COUNTS, groups * n))


def phase_nano_game(card: str, layouts: Optional[dict] = None,
                    exact: Optional[dict] = None) -> dict:
    """K1 (nano_game) against the eager loop (`simulate_games_eager`, its
    plain version at the level of a launch) and against `nano_game_plain`
    on the same start states and keys, in each variant (every branch of
    K1: the default config, antithetic, resumed and forced starts, a row
    offset, stage-2 and fumble channels, the classic config's taper and
    red-zone damping, a collapsed score-diff axis, fumbles without a
    channel, early_exit off, ragged launches; each combination of the
    collectors, antithetic, on the focus roster and from a resumed state
    with nonzero stats; the player-stat instantiations in ragged launches
    of 1,000 and 4 games)
    and over the fixture slate in one launch, plain and antithetic; then
    the other layouts (`phase_k1_layouts`: fused tables with each
    combination of the collectors, the forced first play, fourth.force on
    every play, and on phase 16's tables (`layouts["k1_inputs"]`) the focus
    roster's per-head tables with each combination, ragged and resumed,
    the play-policy table and the
    presets); K2 (score_moments) bit
    for bit against the torch body, ragged shapes too; both kernels timed
    beside their bounds and their plain versions, K1's props instantiation
    (both collectors) and each other layout too.  The comparisons' launches
    are no path's: the counts are not read here."""
    import torch
    from fast_monte_carlo_tpu_torch import api, fixtures
    from fast_monte_carlo_tpu_torch.config import SimConfig, classic_config
    from fast_monte_carlo_tpu_torch.matchup import build_direction
    from fast_monte_carlo_tpu_torch.models.tables import (marginalize_sd, nano_from_fused,
                                                          nano_profile)
    from fast_monte_carlo_tpu_torch.ops import game, rng
    from fast_monte_carlo_tpu_torch.ops import table_lookup as tl
    from fast_monte_carlo_tpu_torch.ops.pack import pack_matchup
    from fast_monte_carlo_tpu_torch.parallel import aggregate as agg

    dev = torch.device("cuda")
    cfg = SimConfig()
    a, b = fixtures.teams()
    pack = pack_matchup(build_direction(a, b, cfg), build_direction(b, a, cfg), dev)
    th = tl.pack_tables(*fixtures.nano_tables(TABLE_SEED), device=dev)
    he = tl.make_table_heads_eval(cfg)
    n = LAUNCH_GAMES
    fo = torch.arange(n, dtype=torch.int32, device=dev) % 2
    score_only = dict(collect_players=False, collect_stats=False)
    anti_cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, antithetic=True))
    fum_cfg = cfg.replace(model=dataclasses.replace(cfg.model, enable_fumbles=True))
    th_s2 = tl.pack_tables(*fixtures.nano_tables(TABLE_SEED, s2_fumble=True), device=dev)
    prof = nano_profile()
    # the tables `sim --sd-mode frozen` plays: the score-diff axis collapsed
    th_nsd1 = tl.pack_tables(*(nano_from_fused(marginalize_sd(t, prof, "frozen"), prof)
                               for t in fixtures.fused_tables(TABLE_SEED)), device=dev)
    check(th_nsd1.nano_nsd == 1, "the frozen tables have one score-diff bin")
    q4 = game.Situation(1, 300, 2, 7.0, 40.0, 17, 21)
    cfg_go = cfg.replace(fourth=dataclasses.replace(cfg.fourth, force="go"))
    forced = game.play_step(
        game.state_from_situation(n, q4._replace(down=4, dist=2.0), cfg, dev, **score_only),
        rng.step_draws(rng.fold_in(rng.root_key(62), 1), 0, n, dev), pack, cfg_go, he, th)
    no_exit = cfg.replace(engine=dataclasses.replace(cfg.engine, early_exit=False))
    # (what, config, tables, games, first offense, start)
    variants = [
        ("kickoff", cfg, th, n, fo, {}),
        ("antithetic", anti_cfg, th, n, fo, {}),
        ("situation Q4 05:00 2nd-and-7", cfg, th, n, 0, dict(situation=q4)),
        ("init_state after a forced go", cfg, th, n, 0, dict(init_state=forced)),
        (f"row0 {n:,}", cfg, th, n, fo, dict(row0=n)),
        ("stage-2 and fumble channels", fum_cfg, th_s2, n, fo, {}),
        ("classic config (taper, red-zone damping)", classic_config(), th, n, fo, {}),
        ("score-diff axis collapsed (nsd 1)", cfg, th_nsd1, n, fo, {}),
        ("fumbles on, no fumble channel", fum_cfg, th, n, fo, {}),
        ("early_exit off, from Q4 05:00", no_exit, th, n, 0, dict(situation=q4)),
        ("ragged, 1,000 games", cfg, th, 1_000, fo[:1_000], {}),
        ("ragged, 4 antithetic games", anti_cfg, th, 4, fo[:4], {}),
    ]
    errs, eager_ms = {}, None
    key = rng.root_key(61)

    def held(what, pk, c, t, games, first, start, timed=False, coll=score_only):
        """K1's launch against the eager loop and against nano_game_plain
        on the same start state (each run on its own copy of a given
        init_state: the collectors add in place; a forced first play on
        the evaluator's stream of `key`); the eager loop's ms by events
        where `timed`."""
        force = start.get("first_play_force")
        fk = rng.fold_in(key, api.FORCED_PLAY_STREAM) if force else None

        def fresh():
            out = dict(start, first_play_key=fk) if force else dict(start)
            if "init_state" in start:
                out["init_state"] = game.GameState(*(f.clone() for f in start["init_state"]))
            return out

        he = tl.make_table_heads_eval(c)
        before = game.nano_game_cuda.launches
        got = game.simulate_games(pk, c, he, t, key, games, first, **coll, **fresh())
        check(game.nano_game_cuda.launches == before + 1, f"{what}: one K1 launch")
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        want = game.simulate_games_eager(pk, c, he, t, key, games, first, **coll, **fresh())
        t1.record()
        row0, st = start.get("row0", 0), fresh()
        s, c2, anti = game._launch_state(pk, c, games, first, coll["collect_players"],
                                         start.get("game_id", 0), coll["collect_stats"],
                                         st.get("situation"), st.get("init_state"), row0, None)
        plain = game.nano_game_plain(game.pack_nano_game(pk, c2, t), s, key, row0, anti,
                                     force=force, force_key=fk, **coll)
        torch.cuda.synchronize()
        errs[what] = max(nano_diff(want, got, f"K1 against the eager loop, {what}"),
                         nano_diff(plain, got, f"K1 against nano_game_plain, {what}"))
        return t0.elapsed_time(t1) if timed else None

    for what, c, t, games, first, start in variants:
        ms = held(what, pack, c, t, games, first, start, timed=eager_ms is None)
        eager_ms = eager_ms or ms                # the kickoff's, K1's timed launch

    # the collectors: each combination, antithetic, the focus roster (whose
    # tracked slots take player rows; the fixture teams track none) and a
    # state resumed after eager plays with both on, its stats nonzero
    fa, fb = fixtures.focus_teams(FOCUS_SEED)
    fpack = pack_matchup(build_direction(fa, fb, cfg), build_direction(fb, fa, cfg), dev)
    both = dict(collect_players=True, collect_stats=True)
    resumed = game.initial_state(n, fo, cfg, dev, **both)
    for j in range(NANO_RESUMED_PLAYS):
        resumed = game.play_step(resumed, rng.step_draws(rng.fold_in(key, 7), j, n, dev), fpack,
                                 cfg, he, th, True, True)
    check(bool((resumed.stats[..., 0] > 0).any(dim=1).all()) and float(resumed.pstats.sum()) > 0,
          f"the resumed start: every game's stats and the player stats nonzero after "
          f"{NANO_RESUMED_PLAYS} plays")
    props_eager_ms, collecting = None, []
    for what, c, pk, start, coll in (
            ("box score only", cfg, pack, {}, dict(collect_players=False, collect_stats=True)),
            ("player stats only, focus roster", cfg, fpack, {},
             dict(collect_players=True, collect_stats=False)),
            ("both collectors, no tracked slot", cfg, pack, {}, both),
            ("both collectors, focus roster", cfg, fpack, {}, both),
            ("both collectors, antithetic, focus roster", anti_cfg, fpack, {}, both),
            (f"both collectors, resumed after {NANO_RESUMED_PLAYS} plays, focus roster", cfg,
             fpack, dict(init_state=resumed), both)):
        ms = held(what, pk, c, th, n, fo, start, timed=what.endswith("collectors, focus roster"),
                  coll=coll)
        props_eager_ms = props_eager_ms or ms
        collecting.append(what)
    # the redesigned player-stat instantiations in ragged launches, late in
    # the game (a variant costs the eager loop's launch rate a play chunk)
    players = dict(collect_players=True, collect_stats=False)
    for what, c, games, coll in (
            ("both collectors, focus roster, 1,000 games from Q4 10:00", cfg, 1_000, both),
            ("player stats only, focus roster, 4 antithetic games from Q4 10:00", anti_cfg, 4,
             players)):
        held(what, fpack, c, th, games, 0, dict(situation=game.Situation(*Q4_LATE_SITUATION)),
             coll=coll)
        collecting.append(what)

    # the fixture slate in the game layout, one launch, plain and antithetic
    matchups, tables = fixtures.slate(SLATE_GAMES, SLATE_SEED)
    sr = api.SlateRunner(matchups, None, cfg, game_shard=True, nano_tables=tables, device=dev)
    g_n = SLATE_GAMES * NANO_SLATE_GAMES
    t = torch.arange(g_n, dtype=torch.int32, device=dev)
    for what, c in (("one slate launch", cfg), ("one antithetic slate launch", anti_cfg)):
        held(f"{what} ({SLATE_GAMES} x {NANO_SLATE_GAMES:,} games)", sr.pack, c,
             sr.heads_state, g_n, t % 2, dict(game_id=t // NANO_SLATE_GAMES))
    args = game.pack_nano_game(pack, cfg, th)
    layout_rows = phase_k1_layouts(card, layouts, held, errs, pack, fpack, th, key)
    layout_rows.update(phase_k1_heads(card, exact))

    # K2 against the torch body, bit for bit
    gen = torch.Generator(device=dev).manual_seed(64)
    k1_scores = game.nano_game_cuda(args, game.initial_state(n, fo, cfg, dev, **score_only),
                                    key).score
    cases = [("(1, 65,536) K1 scores", k1_scores.view(1, n, 2)),
             ("(60, 32,768)", torch.randint(0, 70, (60, 32_768, 2), generator=gen,
                                            device=dev, dtype=torch.int32)),
             ("(3, 4,096) past every clamp", torch.randint(-300, 400, (3, 4_096, 2),
                                                           generator=gen, device=dev,
                                                           dtype=torch.int32)),
             ("(5, 3,001) ragged", torch.randint(0, 70, (5, 3_001, 2), generator=gen,
                                                 device=dev, dtype=torch.int32)),
             ("(1, 100) under one block", torch.randint(0, 70, (1, 100, 2), generator=gen,
                                                        device=dev, dtype=torch.int32)),
             ("(2, 0) no games", torch.zeros((2, 0, 2), device=dev, dtype=torch.int32))]
    k2_err = 0.0
    for what, sc in cases:
        mk, mp = agg.exact_moments_cuda(sc), agg.exact_moments_plain(sc)
        same = [f for f, x, y in zip(agg.ScoreMoments._fields, mk, mp)
                if x.dtype == y.dtype and torch.equal(x, y)]
        k2_err = max([k2_err] + [float((x.double() - y.double()).abs().max())
                                 for x, y in zip(mk, mp)])
        check(len(same) == len(mk), f"K2 {what}: every field bitwise equal to the torch "
              f"body ({len(same)} of {len(mk)})")

    # timing: K1 a 65,536-game launch and a slate launch, K2, their plain
    # versions; K1's lane share (plays over 32 lanes x its warps' loop trips)
    s0 = game.initial_state(n, fo, cfg, dev, **score_only)
    plays = torch.zeros(1, dtype=torch.int64, device=dev)
    iters = torch.zeros(1, dtype=torch.int64, device=dev)
    game.nano_game_cuda(args, s0, key, plays=plays, iters=iters)
    k1_share = int(plays) / (32 * int(iters))
    k1_ms, _, k1_how = times(lambda: game.nano_game_cuda(args, s0, key), 10)
    k1_bd = nano_bound(n, int(plays), th.nano_values.numel() * 4)
    # the plain version is thousands of kernels a play: one profiled call
    # for its device time, one between events for its time on the stream
    prof = device_profile(lambda: game.nano_game_plain(args, s0, key), 1)
    k1_plain, plain_how = (prof[0], "profiler") if prof else (float("nan"), "not recorded")
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    game.nano_game_plain(args, s0, key)
    t1.record()
    torch.cuda.synchronize()
    k1_plain_ev = t0.elapsed_time(t1)
    print(f"  nano_game at {n:,} games ({int(plays):,} plays, {int(plays) / n:.1f} a game, "
          f"lane share {k1_share:.4f}): K1 {k1_ms:.4f} ms ({k1_how}), bound {k1_bd['bound_ms']:.4f} ms "
          f"({k1_bd['bound_class']}; {k1_bd['bound_ms'] / k1_ms:.1%} of it); nano_game_plain "
          f"{k1_plain:.2f} ms device ({plain_how}; {k1_plain_ev:.1f} by events), the eager "
          f"loop {eager_ms:.1f} ms by events ({card})")
    # the props instantiation (both collectors) on the focus roster, from
    # zero stats; its work read off the first launch, before the timed
    # launches add onto the same stats
    fargs = game.pack_nano_game(fpack, cfg, th)
    s_props = game.initial_state(n, fo, cfg, dev, **both)
    plays.zero_()
    first = game.nano_game_cuda(fargs, s_props, key, plays=plays, **both)
    props_bd = nano_bound(n, int(plays), th.nano_values.numel() * 4, accrual_work(first))
    work = accrual_work(first)
    props_ms, _, props_how = times(lambda: game.nano_game_cuda(fargs, s_props, key, **both), 10)
    k1_again, _, _ = times(lambda: game.nano_game_cuda(args, s0, key), 10)
    s_plain = game.initial_state(n, fo, cfg, dev, **both)
    prof = device_profile(lambda: game.nano_game_plain(fargs, s_plain, key, **both), 1)
    props_plain, props_plain_how = (prof[0], "profiler") if prof else (float("nan"),
                                                                        "not recorded")
    print(f"  nano_game props (both collectors, focus roster) at {n:,} games ({int(plays):,} "
          f"plays, {work['sampled']:,.0f} slots sampled, {work['rows_added']:,.0f} player rows "
          f"added, {work['rows_touched']:,} touched): K1 {props_ms:.4f} ms ({props_how}), bound "
          f"{props_bd['bound_ms']:.4f} ms ({props_bd['bound_class']}; "
          f"{props_bd['bound_ms'] / props_ms:.1%} of it); score-only K1 in the same call "
          f"{k1_ms:.4f} and {k1_again:.4f} ms; nano_game_plain {props_plain:.2f} ms device "
          f"({props_plain_how}), the eager loop {props_eager_ms:.1f} ms by events ({card})")
    del s_props, s_plain, first, resumed
    per_slate = 2 * SLATE_CHUNK
    sn = SLATE_GAMES * per_slate
    t = torch.arange(sn, dtype=torch.int32, device=dev)
    s_slate = game.initial_state(sn, t % 2, cfg, dev, t // per_slate, **score_only)
    slate_args = game.pack_nano_game(sr.pack, cfg, sr.heads_state)
    plays.zero_()
    iters.zero_()
    game.nano_game_cuda(slate_args, s_slate, key, plays=plays, iters=iters)
    slate_share = int(plays) / (32 * int(iters))
    slate_ms, _, slate_how = times(lambda: game.nano_game_cuda(slate_args, s_slate, key), 3)
    slate_bd = nano_bound(sn, int(plays), sr.heads_state.nano_values.numel() * 4)
    print(f"  nano_game, one slate launch ({SLATE_GAMES} x {per_slate:,} = {sn:,} games, "
          f"{int(plays):,} plays, lane share {slate_share:.4f}, a "
          f"{sr.heads_state.nano_values.numel() * 4 / 1e6:,.1f} MB table): {slate_ms:.3f} ms ({slate_how}), bound {slate_bd['bound_ms']:.3f} ms "
          f"({slate_bd['bound_class']}; {slate_bd['bound_ms'] / slate_ms:.1%} of it) ({card})")
    del s_slate, slate_args
    sc = k1_scores.view(1, n, 2)
    k2_ms, _, k2_how = times(lambda: agg.exact_moments_cuda(sc), 20)
    k2_plain, _, k2_plain_how = times(lambda: agg.exact_moments_plain(sc), 10)
    k2_bd = moment_bound(1, n)
    sc60 = cases[1][1]
    k2_60, _, _ = times(lambda: agg.exact_moments_cuda(sc60), 20)
    k2_60_plain, _, _ = times(lambda: agg.exact_moments_plain(sc60), 10)
    bd60 = moment_bound(60, 32_768)
    print(f"  score_moments (1, {n:,}): K2 {k2_ms:.4f} ms ({k2_how}; one launch), bound {k2_bd['bound_ms']:.5f} ms ({k2_bd['bound_class']}), "
          f"torch body {k2_plain:.4f} ms ({k2_plain_how}); (60, 32,768): K2 {k2_60:.4f} ms, "
          f"bound {bd60['bound_ms']:.5f} ms ({bd60['bound_class']}), torch body "
          f"{k2_60_plain:.4f} ms ({card})")
    worst = max(errs.values())
    props_err = max(errs[what] for what in collecting)
    return {
        "nano_game": {"max_abs_err": worst, "ms": k1_ms, "plain_ms": k1_plain,
                      "library_ms": None, **k1_bd, "slate_ms": slate_ms, "eager_ms": eager_ms},
        "nano_game_props": {"max_abs_err": props_err, "ms": props_ms, "plain_ms": props_plain,
                            "library_ms": None, **props_bd, "eager_ms": props_eager_ms},
        "score_moments": {"max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain,
                          "library_ms": None, **k2_bd},
        **layout_rows,
    }


def _k1_timed(card: str, what: str, args, s, key: int, coll: dict, force=None, reps: int = 10,
              anti: bool = False, plain: bool = True, walk_costs: Optional[list] = None) -> dict:
    """One K1 launch on the packed inputs `args` from state `s`: held ms
    (`times`, `reps` calls), the bound on this launch's plays
    (`layout_bound`; with both collectors on, from zero stats, their work
    too; in exact mode the walks its plays read, by the kernel's walk
    counter at `walk_costs` a walk, and beside it the bound on every
    forest's walks a play, `bound_all_ms`), the plain version's device time
    (one profiled call, where `plain`; in exact mode, whose plain version
    launches hundreds of thousands of kernels, one call by CUDA events, its
    games held to K1's, `max_abs_err`, and its walk count to the
    counter's), printed beside the card."""
    import torch
    from fast_monte_carlo_tpu_torch import api
    from fast_monte_carlo_tpu_torch.ops import game, rng

    fk = rng.fold_in(key, api.FORCED_PLAY_STREAM) if force else None
    kw = dict(coll, force=force, force_key=fk)
    n = s.off.shape[0]
    exact = args.table_layout == "exact"

    def fresh():
        return game.GameState(*(f.clone() for f in s))

    plays = torch.zeros(1, dtype=torch.int64, device=s.sec.device)
    walks = (torch.zeros(args.exact.forests.shape[0], dtype=torch.int64, device=s.sec.device)
             if exact else None)
    first = game.nano_game_cuda(args, fresh(), key, 0, anti, plays=plays,
                                **(dict(walks=walks) if exact else {}), **kw)
    both = coll.get("collect_players") and coll.get("collect_stats")
    accrual = accrual_work(first) if both else None
    extra, walk_note = {}, ""
    if exact:
        trees = [tf.n_trees for _, tf, *_ in args.exact.heads]
        every = [int(plays) * t for t in trees]
        share = float(walks.sum()) / sum(every)
        check(0 < share < 1, f"{what}: the plays read {int(walks.sum()):,} of every forest's "
              f"{sum(every):,} (row, tree) walks ({share:.1%}), some and not all")
        bd = layout_bound(args, n, int(plays), accrual, exact_walk(walk_costs, walks, int(plays)))
        bd_all = layout_bound(args, n, int(plays), accrual, exact_walk(walk_costs, every,
                                                                         int(plays)))
        extra = {"walks": walks.tolist(), "walk_share": share, "bound_all_ms": bd_all["bound_ms"]}
        walk_note = (f"; {share:.1%} of every forest's walks read, the bound on them all "
                     f"{bd_all['bound_ms']:.4f} ms")
    else:
        bd = layout_bound(args, n, int(plays), accrual)
    start = fresh()
    ms, _, how = times(lambda: game.nano_game_cuda(args, start, key, 0, anti, **kw), reps)
    plain_ms, plain_how, err = float("nan"), "not run", {}
    if plain and exact:
        # one call by events, no warm-up; its games held to K1's first
        # launch's, its walk count (`exact_heads_read`) to the counter's
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start_plain = fresh()
        plain_walks = torch.zeros_like(walks)
        e0.record()
        want = game.nano_game_plain(args, start_plain, key, 0, anti, walks=plain_walks, **kw)
        e1.record()
        torch.cuda.synchronize()
        plain_ms, plain_how = e0.elapsed_time(e1), "events"
        err = {"max_abs_err": nano_diff(want, first, f"K1 against nano_game_plain, {what}, "
                                        f"{n:,} games")}
        check(torch.equal(plain_walks, walks), f"{what}, {n:,} games: K1's walk counter "
              f"equals nano_game_plain's count forest by forest ({walks.tolist()}; plain "
              f"{plain_walks.tolist()})")
        del want, start_plain
    elif plain:
        prof = device_profile(lambda: game.nano_game_plain(args, fresh(), key, 0, anti, **kw), 1,
                              warm=False)     # its kernels ran in phase 21's variants
        plain_ms, plain_how = (prof[0], "profiler") if prof else (float("nan"), "not recorded")
    print(f"  {what} at {n:,} games ({int(plays):,} plays, {int(plays) / n:.1f} a game): K1 "
          f"{ms:.4f} ms ({how}), bound {bd['bound_ms']:.4f} ms ({bd['bound_class']}; "
          f"{bd['bound_ms'] / ms:.1%} of it){walk_note}; nano_game_plain {plain_ms:.2f} ms "
          f"device ({plain_how}) ({card})")
    return {"ms": ms, "plain_ms": plain_ms, "plays": int(plays), **bd, **err, **extra}


def phase_k1_heads(card: str, exact: Optional[dict]) -> dict:
    """Phase 21's heads that read no table: K1's exact instantiation (the
    small heads on the focus roster: score-only, both collectors with the
    fumble and play heads on, the box score alone with the play head, the
    player stats alone with the fumble head in a ragged launch, no stage 2
    in a launch of 37 games, a forced go, a forced punt with both
    collectors; the tiled heads, stage 1 and the play head over eight tiles
    each, with both collectors; a 3-matchup slate with rosters and both
    collectors) and its analytic one (score-only, both collectors
    antithetic, a forced go) against the eager loop (`simulate_games_eager`:
    K5 a forest a play in exact mode) and `nano_game_plain` on the card,
    K1_HEADS_GAMES games each where no other count is named, 0 differing
    allowed; each instantiation's registers and local bytes; then the JSON
    rows: the exact instantiation's from phase 12 (`exact["k1_exact"]`: the
    main path's 65,536-game launch on the reference-shape heads; its plain
    version's time and max|d| from the same heads at EXACT_PLAIN_GAMES and
    EXACT_EAGER_GAMES), the analytic one timed at LAUNCH_GAMES."""
    import torch
    from fast_monte_carlo_tpu_torch import api, fixtures
    from fast_monte_carlo_tpu_torch.config import SimConfig
    from fast_monte_carlo_tpu_torch.matchup import build_direction
    from fast_monte_carlo_tpu_torch.ops import game, rng
    from fast_monte_carlo_tpu_torch.ops.pack import build_packs, pack_heads, pack_matchups

    dev = torch.device("cuda")
    cfg = SimConfig()
    full = cfg.replace(model=dataclasses.replace(cfg.model, enable_fumbles=True,
                                                 use_play_model=True))
    play_only = cfg.replace(model=dataclasses.replace(cfg.model, use_play_model=True))
    fumble_only = cfg.replace(model=dataclasses.replace(cfg.model, enable_fumbles=True))
    anti = cfg.replace(engine=dataclasses.replace(cfg.engine, antithetic=True))
    small = fixtures.heads(K1_HEADS_SEED, "small")
    tiled = fixtures.heads(K1_HEADS_SEED, "tiled")
    focus = fixtures.focus_teams(FOCUS_SEED)
    key = rng.root_key(27)
    n = K1_HEADS_GAMES
    errs = {"exact": 0.0, "analytic": 0.0}
    # (mode, what, config, players, stats, forced first play, heads, games,
    # stage 2 dropped from the HeadsPack): exact mode walks only the
    # forests each play reads, so every choice of heads and collectors,
    # ragged launches and the forced plays are played
    for mode, what, c, players, stats, force, heads, games, no_s2 in (
            ("exact", "score-only", cfg, False, False, None, small, n, False),
            ("exact", "both collectors, fumble and play heads", full, True, True, None, small,
             n, False),
            ("exact", "box score only, play head, no fumble head", play_only, False, True,
             None, small, n, False),
            ("exact", "player stats only, fumble head, no play head, ragged", fumble_only,
             True, False, None, small, 1_000, False),
            ("exact", "no stage 2, play and fumble heads, ragged", full, False, False, None,
             small, 37, True),
            ("exact", "a forced go from 4th and 2", cfg, False, False, "go", small, n, False),
            ("exact", "a forced punt from 4th and 2, both collectors, play head", play_only,
             True, True, "punt", small, 1_000, False),
            ("exact", "tiled heads, both collectors, fumble and play heads", full, True, True,
             None, tiled, n, False),
            ("analytic", "score-only", cfg, False, False, None, small, n, False),
            ("analytic", "both collectors, antithetic", anti, True, True, None, small, n, False),
            ("analytic", "a forced go from 4th and 2", cfg, False, False, "go", small, n, False)):
        pack, hp = build_packs(*focus, heads, c, dev, fixtures.COACH_MAP)
        if no_s2:
            hp = dataclasses.replace(hp, stage2=None)
        hs = hp if mode == "exact" else None
        he = (game.make_exact_heads_eval if mode == "exact" else game.make_analytic_heads_eval)(c)
        coll = dict(collect_players=players, collect_stats=stats)
        fo = torch.arange(games, dtype=torch.int32, device=dev) % 2
        if force:
            s0 = game.state_from_situation(games, game.Situation(fo, 1500, 4, 2.0, 45.0, 10, 14),
                                           c, dev, 0, pack.k, **coll)
        else:
            s0 = game.initial_state(games, fo, c, dev, 0, pack.k, **coll)
        fk = rng.fold_in(key, api.FORCED_PLAY_STREAM) if force else None
        kw = dict(coll, first_play_force=force, first_play_key=fk)
        before = launch_count(f"nano_game_{mode}")
        got = game.simulate_games(pack, c, he, hs, key, games, 0, init_state=game.GameState(
            *(f.clone() for f in s0)), **kw)
        check(launch_count(f"nano_game_{mode}") == before + 1,
              f"{mode}, {what}: simulate_games on the card was one K1 launch")
        want = game.simulate_games_eager(pack, c, he, hs, key, games, 0,
                                         init_state=game.GameState(*(f.clone() for f in s0)),
                                         **kw)
        plain = game.nano_game_plain(game.pack_nano_game(pack, c, hs), game.GameState(
            *(f.clone() for f in s0)), key, 0, c.engine.antithetic and games % 4 == 0,
            force=force, force_key=fk, **coll)
        what = f"{what}, {games:,} games"
        errs[mode] = max(errs[mode], nano_diff(want, got, f"K1 against the eager loop, {mode} "
                                               f"heads, {what}"),
                         nano_diff(plain, got, f"K1 against nano_game_plain, {mode} heads, "
                                   f"{what}"))
    # exact mode over a 3-matchup pack with rosters: game g of matchup g % 3
    fo = torch.arange(n, dtype=torch.int32, device=dev) % 2
    dirs = []
    for x, y in fixtures.focus_slate(3, 11)[0]:
        dirs += [build_direction(x, y, full, small, fixtures.COACH_MAP),
                 build_direction(y, x, full, small, fixtures.COACH_MAP)]
    spack, shp = pack_matchups(dirs, dev), pack_heads(small, dev)
    he = game.make_exact_heads_eval(full)
    s0 = game.initial_state(n, fo, full, dev, torch.arange(n, device=dev).to(torch.int32) % 3,
                            spack.k)
    runs = [fn(spack, full, he, shp, key, n, 0, init_state=game.GameState(
        *(f.clone() for f in s0))) for fn in (game.simulate_games, game.simulate_games_eager)]
    plain = game.nano_game_plain(game.pack_nano_game(spack, full, shp), game.GameState(
        *(f.clone() for f in s0)), key, collect_players=True, collect_stats=True)
    errs["exact"] = max(errs["exact"],
                        nano_diff(runs[1], runs[0], "K1 against the eager loop, exact heads, a "
                                  "3-matchup slate with rosters, both collectors"),
                        nano_diff(plain, runs[0], "K1 against nano_game_plain, exact heads, a "
                                  "3-matchup slate with rosters, both collectors"))
    for mode in ("exact", "analytic"):
        kind = game.LAYOUT_KINDS.index(mode)
        for st, pl in ((False, False), (True, False), (False, True), (True, True)):
            regs, local = game.nano_game_usage(kind, st, pl)
            blocks = game.nano_geometry(dev.index or 0, st, pl, kind,
                                        3 * 2 * pack.k if pl else 0)[0]
            print(f"  nano_game {mode} (stats {int(st)}, players {int(pl)}): {regs} registers, "
                  f"{local} local bytes, {blocks} blocks resident ({card})")
    score_only = dict(collect_players=False, collect_stats=False)
    check(exact is not None and "max_abs_err" in exact.get("k1_exact", {}),
          "phase 12 timed K1's exact instantiation at the main path's launch and held it to "
          "nano_game_plain")
    print(f"  K1's exact and analytic variants at {n:,} games: max|d| exact {errs['exact']:.3g}, "
          f"analytic {errs['analytic']:.3g} (the exact JSON row's is phase 12's)")
    pack, _ = build_packs(*fixtures.teams(), fixtures.heads(0, "reference"), cfg, dev)
    fl = torch.arange(LAUNCH_GAMES, dtype=torch.int32, device=dev) % 2
    rows = {"nano_game_exact": dict(exact["k1_exact"], library_ms=None),
            "nano_game_analytic": _k1_timed(
                card, "nano_game analytic", game.pack_nano_game(pack, cfg, None),
                game.initial_state(LAUNCH_GAMES, fl, cfg, dev, **score_only), key, score_only)}
    rows["nano_game_analytic"].update(max_abs_err=errs["analytic"], library_ms=None)
    return rows


def per_head_resumed(pk, c, t, n: int, key: int):
    """A start with nonzero box scores and player stats on per-head tables:
    n games from Q4 10:00 after PER_HEAD_RESUMED_PLAYS eager plays with
    both collectors on."""
    from fast_monte_carlo_tpu_torch.ops import game, rng
    from fast_monte_carlo_tpu_torch.ops import table_lookup as tl

    dev = t.stage1.values.device
    he = tl.make_table_heads_eval(c)
    s = game.state_from_situation(n, game.Situation(*Q4_LATE_SITUATION), c, dev, 0, pk.k,
                                  collect_players=True, collect_stats=True)
    for j in range(PER_HEAD_RESUMED_PLAYS):
        s = game.play_step(s, rng.step_draws(rng.fold_in(key, 9), j, n, dev), pk, c, he, t,
                           True, True)
    check(bool((s.stats[..., 0] > 0).any(dim=1).all()) and float(s.pstats.sum()) > 0,
          f"the per-head resumed start: every game's stats and the player stats nonzero after "
          f"{PER_HEAD_RESUMED_PLAYS} plays")
    return s


def phase_k1_layouts(card: str, layouts: Optional[dict], held, errs: dict, pack, fpack, th,
                     key: int) -> dict:
    """Phase 21's other layouts: K1 against the eager loop and
    nano_game_plain (`held`, 0 differing games allowed) on fixture fused
    tables (with stage-2 and fumble channels, both collectors on the focus
    roster, antithetic; the player stats alone; the box score alone), the
    forced first play (go, fg
    antithetic, punt with the box score), fourth.force on every play, and on
    phase 16's tables (`layouts["k1_inputs"]`): the focus roster's per-head
    tables (score-only, both collectors in a forced punt antithetic and
    from a resumed start with nonzero stats, the box score alone in 4
    antithetic games, the player stats alone in 1,000 games), the
    play-policy table (and a forced fg beside
    it) and the K1_PRESETS; then each instantiation's
    registers and local bytes, and the JSON rows of the fused, per-head,
    play-table and forced launches timed at LAUNCH_GAMES beside their
    bounds (a 60-matchup fused slate launch too)."""
    import torch
    from fast_monte_carlo_tpu_torch import fixtures
    from fast_monte_carlo_tpu_torch.config import SimConfig
    from fast_monte_carlo_tpu_torch.matchup import build_direction
    from fast_monte_carlo_tpu_torch.models.tables import nano_profile
    from fast_monte_carlo_tpu_torch.ops import game
    from fast_monte_carlo_tpu_torch.ops import table_lookup as tl
    from fast_monte_carlo_tpu_torch.ops.pack import pack_matchups

    dev = torch.device("cuda")
    cfg = SimConfig()
    n = LAUNCH_GAMES
    fo = torch.arange(n, dtype=torch.int32, device=dev) % 2
    score_only = dict(collect_players=False, collect_stats=False)
    both = dict(collect_players=True, collect_stats=True)
    box = dict(collect_players=False, collect_stats=True)

    def with_engine(c, **kw):
        return c.replace(engine=dataclasses.replace(c.engine, **kw))

    anti_cfg = with_engine(cfg, antithetic=True)
    fum_cfg = cfg.replace(model=dataclasses.replace(cfg.model, enable_fumbles=True))
    go_cfg = cfg.replace(fourth=dataclasses.replace(cfg.fourth, force="go"))
    prof = nano_profile()
    fused = tl.pack_tables(*fixtures.fused_tables(TABLE_SEED), device=dev, fused_prof=prof)
    fused_s2 = tl.pack_tables(*fixtures.fused_tables(TABLE_SEED, s2_fumble=True), device=dev,
                              fused_prof=prof)
    fourth = game.Situation(0, 1500, 4, 2.0, 45.0, 10, 14)
    # Q2 10:00, 7-3: about two thirds of a game's plays, the halftime flip
    # among them, for the variants past the first (a variant costs the
    # eager loop's launch rate a play chunk)
    q2 = dict(situation=game.Situation(0, 2400, 1, 10.0, 75.0, 7, 3))
    forced = {"fg": dict(situation=fourth, first_play_force="fg"),
              "go": dict(situation=fourth, first_play_force="go"),
              "punt": dict(situation=fourth, first_play_force="punt")}
    players = dict(collect_players=True, collect_stats=False)
    q4 = dict(situation=game.Situation(*Q4_LATE_SITUATION))
    # (what, row of the JSON line, pack, config, tables, first offense, start, collectors[,
    # games]) (each variant is an eager launch and a plain run, about 5 s of the host's
    # launch rate from Q2 10:00: branches share variants where they can, and those
    # added for the slot-sampling redesign start at Q4 10:00)
    variants = [
        ("fused, fixture tables on the nano profile", "fused", pack, cfg, fused, fo, {},
         score_only),
        ("fused, stage-2 and fumble channels, both collectors, antithetic, focus roster, "
         "from Q2 10:00", "fused", fpack, with_engine(fum_cfg, antithetic=True), fused_s2, 0,
         q2, both),
        ("fused, player stats only, focus roster, from Q4 10:00", "fused", fpack, cfg, fused,
         0, q4, players),
        ("fused, box score only, from Q4 10:00", "fused", pack, cfg, fused, 0, q4, box),
        ("forced go from a 4th-and-2", "forced", pack, cfg, th, 0, forced["go"], score_only),
        ("forced fg, antithetic, box score", "forced", pack, anti_cfg, th, 0, forced["fg"],
         box),
        ("fourth.force go on every play, from Q2 10:00", "forced", pack, go_cfg, th, 0, q2,
         score_only),
    ]
    inputs = (layouts or {}).get("k1_inputs", {})
    for name, (pk, t, c) in inputs.items():
        row = ("per_head" if t.stage1 is not None else "play" if t.play is not None
               else "fused")
        variants.append((f"{name}, from Q2 10:00", row, pk, c, t, 0, q2, score_only))
        if name.startswith("per-head"):
            anti_c = with_engine(c, antithetic=True)
            variants += [
                (f"{name}, forced punt, antithetic, both collectors", row, pk, anti_c, t, 0,
                 forced["punt"], both),
                (f"{name}, box score only, 4 antithetic games from Q4 10:00", row, pk, anti_c,
                 t, 0, q4, box, 4),
                (f"{name}, player stats only, 1,000 games from Q4 10:00", row, pk, c, t, 0, q4,
                 players, 1_000),
                (f"{name}, both collectors, resumed after {PER_HEAD_RESUMED_PLAYS} plays "
                 "from Q4 10:00", row, pk, c, t, 0,
                 dict(init_state=per_head_resumed(pk, c, t, n, key)), both)]
        if row == "play":
            variants.append((f"{name}, forced fg", row, pk, c, t, 0, forced["fg"], score_only))
    by_row = {}
    for what, row, pk, c, t, first, start, coll, *rest in variants:
        held(what, pk, c, t, rest[0] if rest else n, first, start, coll=coll)
        by_row.setdefault(row, []).append(what)
    check({"fused", "per_head", "play", "forced"} <= set(by_row),
          f"K1 held to the eager loop on every layout: {sorted(by_row)} (phase 16's tables "
          f"{sorted(inputs)})")

    # registers and local bytes of every instantiation
    for kind, stats, players in game.NANO_INSTANTIATIONS:
        regs, local = game.nano_game_usage(kind, stats, players)
        print(f"  K1 instantiation {game.LAYOUT_KINDS[kind]}, stats {stats}, players {players}: "
              f"{regs} registers, {local} bytes of local memory a thread (its stack frame and "
              "any spills; ptxas' spill counts: probes.kernels --sass)")

    # timing: each row's launch at LAUNCH_GAMES, and a 60-matchup fused slate
    def state(pk, c, first, start, coll):
        s, c2, anti = game._launch_state(pk, c, n, first, coll["collect_players"], 0,
                                         coll["collect_stats"], start.get("situation"), None,
                                         0, None)
        return s, c2, anti

    rows = {}
    timed = {"fused": ("fused, fixture tables on the nano profile", pack, cfg, fused, fo, {},
                       score_only),
             "forced": ("forced go from the 4th-and-2", pack, cfg, th, 0, forced["go"],
                        score_only)}
    for name, (pk, t, c) in inputs.items():
        row = ("per_head" if t.stage1 is not None else "play" if t.play is not None
               else None)
        if row is not None and row not in timed:
            timed[row] = (name, pk, c, t, fo, {}, score_only)
    for row, (what, pk, c, t, first, start, coll) in timed.items():
        s, c2, anti = state(pk, c, first, start, coll)
        rec = _k1_timed(card, f"nano_game {row}: {what}", game.pack_nano_game(pk, c2, t), s,
                        key, coll, start.get("first_play_force"), anti=anti)
        rows[f"nano_game_{row}"] = {"max_abs_err": max(errs[w] for w in by_row[row]),
                                    "library_ms": None, **rec}
    for name, (pk, t, c) in inputs.items():
        if name.startswith("per-head"):
            s, c2, anti = state(pk, c, fo, {}, both)
            rows["nano_game_per_head"]["both_collectors_ms"] = _k1_timed(
                card, f"nano_game per_head: {name}, both collectors",
                game.pack_nano_game(pk, c2, t), s, key, both, plain=False)["ms"]
        elif name.startswith("preset") and t.fused is not None:
            s, c2, anti = state(pk, c, fo, {}, score_only)
            rows["nano_game_fused"][f"{name} ms"] = _k1_timed(
                card, f"nano_game fused: {name}", game.pack_nano_game(pk, c2, t), s, key,
                score_only, plain=False)["ms"]
    # the fused layout over a 60-matchup slate: one matchup's fixture tables
    # packed 60 times, each matchup a game-layout block
    slate = tl.pack_tables_multi([fixtures.fused_tables(TABLE_SEED)] * SLATE_GAMES, dev,
                                 fused_prof=prof)
    a, b = fixtures.teams()
    spack = pack_matchups([build_direction(a, b, cfg), build_direction(b, a, cfg)] * SLATE_GAMES,
                          dev)
    per_game = 2 * SLATE_CHUNK
    sn = SLATE_GAMES * per_game
    t = torch.arange(sn, dtype=torch.int32, device=dev)
    s = game.initial_state(sn, t % 2, cfg, dev, t // per_game, **score_only)
    rows["nano_game_fused"]["slate_ms"] = _k1_timed(
        card, f"nano_game fused: one slate launch ({SLATE_GAMES} x {per_game:,} games, "
        f"{slate.nbytes / 1e6:,.1f} MB of tables)", game.pack_nano_game(spack, cfg, slate), s,
        key, score_only, reps=3, plain=False)["ms"]
    del slate, s
    return rows


def phase_train(card: str, device: str = "cuda") -> dict:
    """Training on the card's host: (a) `cli train` in a subprocess on a
    small plays csv, which without pandas, scikit-learn or joblib exits
    non-zero naming what is missing and writes nothing (with them, it trains); (b)
    `build_reconstructed --calibration-only --device cuda` on the fixture
    sheet's Team A and Team B and the fixture artifact directory's heads at
    TRAIN_GAMES oracle games, its play forest's margins through K5; then one
    exact-mode launch under reconstructed_config() on the heads with the
    port's own overlay; (c) K5's margins bitwise the plain walk's on the
    card, the temperature equal to the one the CPU's plain walk gives, the
    overlay read from inside the port's package.  Returns the phase's K5
    launches (and K4's, the exact launch's draws) and K5's largest
    difference from its plain walk.  With
    device="cpu" (and `check` printing), a script rehearses it on the CPU."""
    import importlib.util
    import tempfile

    import torch
    from fast_monte_carlo_tpu_torch import fixtures
    from fast_monte_carlo_tpu_torch.api import MatchupRunner
    from fast_monte_carlo_tpu_torch.config import reconstructed_config
    from fast_monte_carlo_tpu_torch.data.context import build_team_context_from_sp_flex
    from fast_monte_carlo_tpu_torch.data.sp import load_sp_flex
    from fast_monte_carlo_tpu_torch.models import heads as heads_mod
    from fast_monte_carlo_tpu_torch.ops import forest_eval as fe
    from fast_monte_carlo_tpu_torch.probes.kernels import held_ms
    from fast_monte_carlo_tpu_torch.train import build_reconstructed as br
    from fast_monte_carlo_tpu_torch.train import pipeline as tp

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    sp_path = fixtures.write_sp_sheet(os.path.join(tmp.name, "sp.csv"), SP_TEAMS, SP_SEED)
    data = os.path.join(tmp.name, "plays.csv")
    write_train_csv(data)
    trained = os.path.join(tmp.name, "trained")
    missing = [m for m in TRAIN_MODULES if importlib.util.find_spec(m) is None]
    # (a) started now, read after (b): it imports torch while the oracle plays
    cli = subprocess.Popen([sys.executable, "-m", "fast_monte_carlo_tpu_torch.cli", "train",
                            "--data", data, "--out", trained, "--device", device], cwd=REPO,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    # (b) and the overlay's exact launch, between the counts set to 0 and read
    sp = load_sp_flex(sp_path)
    a, b = (build_team_context_from_sp_flex(t, 2025, 1, sp) for t in ("Team A", "Team B"))
    out = os.path.join(tmp.name, "overlay")
    argv = ["--sp", sp_path, "--artifacts", fixtures.ARTIFACT_DIR, "--team-a", "Team A",
            "--team-b", "Team B", "--out", out, "--games", str(TRAIN_GAMES), "--device", device,
            "--calibration-only"]
    zero_counts()
    t0 = time.perf_counter()
    rec = br.build(br.parse_args(argv))
    build_s = time.perf_counter() - t0
    cal_k5 = fe.eval_margin_cuda.launches
    recon = heads_mod.load_reconstructed_heads(fixtures.ARTIFACT_DIR)
    runner = MatchupRunner(a, b, recon, reconstructed_config(), mode="exact", device=device,
                           coach_map=fixtures.COACH_MAP)
    t0 = time.perf_counter()
    summary = runner.run_pairs_summary(TRAIN_EXACT_PAIRS, seed=20, chunk_pairs=TRAIN_EXACT_PAIRS)
    if device != "cpu":
        torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    counts = read_counts("training phase (calibration, then one exact launch)",
                         ["forest_eval", "nano_game_exact"])

    check(cal_k5 == 1, f"build_reconstructed --calibration-only walked the play forest in "
          f"{cal_k5} K5 launch")
    check(sorted(os.listdir(out)) == ["calibration.json"],
          "--calibration-only wrote calibration.json alone")
    written = json.loads(Path(out, "calibration.json").read_text())
    check(written["temperature"] == rec["temperature"] and written["note"] == br.CALIBRATION_NOTE,
          f"calibration.json holds the temperature {rec['temperature']} and the JAX note")
    check(0.5 <= rec["temperature"] <= 2.0 and rec["states"] > 10 * TRAIN_GAMES,
          f"{rec['states']} dropback states from {TRAIN_GAMES} oracle games in "
          f"{rec['oracle_s']:.2f} s; temperature {rec['temperature']} on the grid")

    # (c) K5 against the plain walk on the card and the CPU, on the same rows
    play = heads_mod.load_heads(fixtures.ARTIFACT_DIR).play
    tf = fe.pack_forest(play, device)
    x = torch.tensor(rec["x"], device=device)
    cats = {g: torch.tensor(v, device=device) for g, v in rec["cat"].items()}
    plain = fe.eval_margin_reference(tf, x, cats).cpu().numpy()
    err = float(np.abs(rec["margins"] - plain).max())
    check(np.array_equal(rec["margins"], plain) and rec["margins"].shape == (rec["states"], 5),
          f"K5's margins of the play forest ({play.n_trees} trees, "
          f"{rec['margins'].shape}) bitwise equal to the plain walk's on the card")
    cpu = tp.forest_margins(play, rec["x"], rec["cat"], device="cpu")
    t_cpu = tp.temperature_calibrate(cpu.astype(np.float64), rec["y"])
    check(t_cpu == rec["temperature"] and np.array_equal(cpu, rec["margins"]),
          f"the CPU's plain walk gives the same margins and the same temperature ({t_cpu})")
    ms = held_ms(lambda: fe.eval_margin(tf, x, cats), 20)[0] if device != "cpu" else 0.0
    print(f"  K5 on the play forest at B={rec['states']:,}: {ms:.4f} ms held ({card})")

    check(heads_mod.RECONSTRUCTED_DIR.resolve().parent.parent
          == (REPO / "fast_monte_carlo_tpu_torch").resolve()
          and recon.stage2 is not None and recon.play_temperature == 1.45,
          f"the overlay read from the port's own {heads_mod.RECONSTRUCTED_DIR.relative_to(REPO)}: "
          f"stage 2 of {recon.stage2.n_trees} trees, temperature {recon.play_temperature}")
    check_summary(summary, 2 * TRAIN_EXACT_PAIRS, "reconstructed_config() exact launch")
    exact_k5 = counts["forest_eval"] - cal_k5
    check(exact_k5 == 0 and counts["nano_game_exact"] == 1,
          f"the exact launch walked its forests in {counts['nano_game_exact']} K1 launch "
          f"({exact_k5} forest_eval launches) in {exact_s:.2f} s")

    # (a)'s result
    try:
        cli_out, cli_err = cli.communicate(timeout=TRAIN_CLI_S)
    finally:
        if cli.poll() is None:
            cli.kill()
    if missing:
        names = {"pandas": "pandas", "sklearn": "scikit-learn", "joblib": "joblib"}
        check(cli.returncode != 0 and all(names[m] in cli_err for m in missing)
              and not os.path.exists(trained),
              f"cli train without {', '.join(missing)} (absent here) exits {cli.returncode}, "
              f"names them and writes nothing ({cli_err.strip()[-200:]!r})")
    else:
        check(cli.returncode == 0 and os.path.exists(os.path.join(trained, "calibration.json")),
              f"cli train on a host with pandas and scikit-learn trained into {trained} "
              f"(exit {cli.returncode}; {cli_err.strip()[-200:]!r})")
    ran = "none of " + ", ".join(missing) if missing else "pandas and scikit-learn"
    print(f"  cli train ran with {ran}; build_reconstructed --calibration-only {build_s:.2f} s (oracle "
          f"{rec['oracle_s']:.2f} s, {rec['states']:,} states, K5 walk {rec['walk_s']:.3f} s), "
          f"temperature {rec['temperature']}, K5 launches {counts['forest_eval']}, "
          f"phase {time.perf_counter() - t_phase:.1f} s ({card})")
    tmp.cleanup()
    return {"launches": counts["forest_eval"], "k4": counts["philox_draws"], "k5_err": err}


def _lookup_obs(seed: int, dev):
    """N StepObs on `dev` from play_states rows, random slots and score
    differences."""
    import torch
    from fast_monte_carlo_tpu_torch import fixtures
    from fast_monte_carlo_tpu_torch.ops import game

    rng = np.random.default_rng(seed)
    d = {k: torch.tensor(v, device=dev) for k, v in fixtures.play_states(rng, N).items()}
    slots = torch.tensor(rng.integers(0, 8, (3, N)).astype(np.int32), device=dev)
    sd = torch.tensor(rng.integers(-28, 29, N).astype(np.float32), device=dev)
    return game.StepObs(sd=sd, dirx=d["off"], off=d["off"], down=d["down"], dist=d["dist"],
                        ytg=d["ytg"], sec=d["sec"], qb=slots[0], wr=slots[1], rb=slots[2])


def _obs_to(obs, device):
    return type(obs)(*(None if v is None else v.to(device) for v in obs))


def check_summary(summary, games: int, what: str) -> None:
    """n, rates summing to 1, mean points in (10, 50), histograms summing
    to n, no NaN."""
    n = float(summary.n)
    wins = summary.win_rate.cpu().numpy()
    mean = summary.mean_pts.cpu().numpy()
    check(n == games, f"{what}: summary n == {games:,}")
    check(abs(wins.sum() + float(summary.tie_rate) - 1.0) < 1e-5,
          f"{what}: win rates {wins.round(5).tolist()} + tie == 1")
    check(all(10 < m < 50 for m in mean), f"{what}: mean points {mean.round(3).tolist()} "
          "in (10, 50)")
    check(int(summary.margin_hist.sum()) == games and int(summary.total_hist.sum()) == games
          and bool((summary.pts_hist.sum(dim=1) == games).all()),
          f"{what}: histograms sum to n")
    check(all(np.isfinite(v.cpu().numpy()).all() for v in summary), f"{what}: no NaN")


def live_curve_situations(cfg):
    """16 moments of one game, from the kickoff to the last four minutes:
    the clock falling 225 s a step, the score, possession and field moving."""
    from fast_monte_carlo_tpu_torch.ops.game import Situation

    sits = []
    for i in range(16):
        sa, sb = 7 * (i // 3) + 3 * (i // 5), 7 * (i // 4)
        sits.append(Situation(offense=i % 2, sec=cfg.clock.game_seconds - 225 * i,
                              down=1 + i % 4, dist=float(3 + (5 * i) % 9),
                              ytg=float(75 - (13 * i) % 60), score_a=sa, score_b=sb))
    return sits


def torch_fo_alternating(n: int):
    """The runners' first offense of n games on the card: 0, 1, 0, 1, ..."""
    import torch

    return torch.arange(n, dtype=torch.int32, device="cuda") % 2


def profile_kernels(fn):
    """torch.profiler over fn(): (device kernels, device ms, wall ms
    profiled, the kernel table)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in dev), sum(e.self_device_time_total for e in dev) / 1e3,
            wall_ms, events.table(sort_by="self_device_time_total", row_limit=40))


def write_profile(runner, pairs: int, card: str, launch_ms: float,
                  out: Path) -> None:
    """torch.profiler over one launch: device time by kernel, written to
    out/profile_launch.txt.  The profiler slows the host's enqueue
    many times over, so the busy share is the profiled device time over the
    unprofiled wall time of a launch (`launch_ms`).  Kernels a play are the
    launch's over the plays the eager loop runs for the same games (its K4
    launches times the chunk: the longest game's plays, in whole chunks)."""
    from fast_monte_carlo_tpu_torch.ops import game, rng

    n_kernels, dev_ms, wall_ms, table = profile_kernels(
        lambda: runner.run_pairs_summary(pairs, seed=5, chunk_pairs=pairs,
                                         collect_stats=False))
    before = rng.philox_draws.launches_by_ch[CH]
    n = 2 * pairs
    game.simulate_games_eager(runner.pack, runner.cfg, runner.heads_fn, runner.heads_state,
                              rng.fold_in(rng.root_key(5), 0), n,
                              torch_fo_alternating(n), collect_players=False,
                              collect_stats=False)
    plays = (rng.philox_draws.launches_by_ch[CH] - before) * CH
    out.mkdir(parents=True, exist_ok=True)
    summary = (f"{n_kernels} device kernels ({n_kernels / plays:.3f} a play over the eager "
               f"loop's {plays} plays of the same games), {dev_ms:.3f} ms device time; "
               f"wall {wall_ms:.3f} ms profiled, {launch_ms:.3f} ms "
               f"unprofiled (busy share {dev_ms / launch_ms:.4f})")
    (out / "profile_launch.txt").write_text(f"{card}\n{summary}\n\n{table}\n")
    print(f"  profile of one launch: {summary}; table in {out / 'profile_launch.txt'}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=Path, metavar="DIR",
                    help="also profile one launch into DIR/profile_launch.txt")
    ap.add_argument("--exact-plain-games", type=int, default=EXACT_PLAIN_GAMES, metavar="N",
                    help="games of phase 12's exact launch held to nano_game_plain (65536: the "
                         "main path's launch itself, about 265 s more on an H100)")
    args = ap.parse_args()

    t_start = time.perf_counter()
    import torch
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "an NVIDIA card", file=sys.stderr)
        return 1
    card = card_name_and_limit()
    print(f"[1] card: {card}, {torch.cuda.device_count()} device(s)")

    from fast_monte_carlo_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    cuda_build.load_kernel_libraries(*SOURCES)
    secs = {1: t0 - t_start, 2: time.perf_counter() - t0}
    print(f"[2] built and loaded {', '.join(SOURCES)} in {secs[2]:.2f} s")

    # every phase's table disk cache in a fresh directory of its own, so that
    # every cold build stays cold and nothing of an earlier run is read;
    # phase 15 uses phase 14's (the server built its matchups' tables), and
    # phase 17 reads phase 16's
    import tempfile
    from fast_monte_carlo_tpu_torch.ops import table_lookup
    cache_root = tempfile.TemporaryDirectory(prefix="table_cache_")

    def phase(n: int, title: str, fn, *a, cache: Optional[int] = None):
        print(f"[{n}] {title}")
        table_lookup.TABLE_CACHE_DIR = os.path.join(cache_root.name, f"phase{cache or n}")
        t0 = time.perf_counter()
        out = fn(*a)
        secs[n] = time.perf_counter() - t0
        print(f"  phase {n} took {secs[n]:.1f} s")
        return out

    k = phase(3, "philox_draws kernel vs plain torch on the card", phase_kernel, card)
    phase(4, "one play step, CUDA vs CPU", phase_step)
    mp = phase(5, "main path: MatchupRunner.run_pairs_summary on cuda", phase_main_path, card,
               args.profile)
    fused = phase(6, f"fused play-step kernels vs plain torch, B={PROBE_B:,}, then the probes "
                  "path", phase_fused, card)
    gathers = phase(7, "row-gather kernels vs plain torch, then the gather probes path",
                    phase_gather, card)
    props = phase(8, "props path: run_pairs with both collectors, reductions, prop scan",
                  phase_props, card, args.profile)
    live = phase(9, "live and 4th-down: run_live, run_live_batch, run_fourth_decision on "
                 "cuda, SimConfig() (threefry: the Philox stream)", phase_live, card,
                 args.profile)
    slate = phase(10, f"slate path: SlateRunner(game_shard=True).run_summary_rows, "
                  f"{SLATE_GAMES} matchups on cuda, then the loop layout and the slate's "
                  "markets", phase_slate, card, args.profile)
    multi = phase(11, "multi-leg markets, season and slate props: simulate_parlay, "
                  "project_season, simulate_slate_props on cuda", phase_multi, card,
                  args.profile)
    exact = phase(12, "exact mode and tables from heads: K5 (forest_eval) vs plain torch, "
                  "MatchupRunner(mode='exact') and mode='table' with heads on cuda",
                  phase_exact, card, args.exact_plain_games)
    files = phase(13, "inputs from files: an SP+ sheet and the trained-head fixture "
                  "directory through load_heads, simulate_upcoming_matchup and the sp_path= "
                  "routes on cuda", phase_files, card)
    served = phase(14, "the resident server: SimService behind make_server on cuda, over "
                   "HTTP (table mode, then exact mode)", phase_serve, card)
    saved = phase(15, "saved sims, bundles and the backtest: sim --save, edges and prop over "
                  "the files, edges --device, the batched sweep, backtest and slate --props "
                  "on cuda (phase 14's table disk cache)", phase_saved, card, cache=14)
    layouts = phase(16, "the other table layouts: a focus roster's per-head tables, the ML "
                    "play-policy table, the default/coarse/slate/fused/turbo presets and the "
                    "turbo and fused slates on cuda", phase_layouts, card)
    cache = phase(17, "the table disk cache and sd_mode='cachewarm': a warm process on "
                  "phase 16's cache, a cachewarm runner, cli sim --sd-mode cachewarm and a "
                  "cachewarm slate on cuda", phase_cache, card, layouts,
                  os.path.join(cache_root.name, "phase16"), cache_root.name)
    shard = phase(18, "trial sharding on cuda: a world of one over NCCL, two ranks, the game "
                  "layout over them, cli sim --shard and a sharded server request",
                  phase_shard, card)
    benched = phase(19, "the bench entry on cuda: python -m fast_monte_carlo_tpu_torch.bench "
                    "(table mode) and cli bench --mode exact, each a subprocess",
                    phase_bench, card, mp["games_per_s"])
    train = phase(20, "training on the card's host: cli train without scikit-learn, "
                  "build_reconstructed --calibration-only (K5 on the play forest), the port's "
                  "overlay in one exact launch", phase_train, card)
    nano = phase(21, "K1 (nano_game) against the eager loop and nano_game_plain on every "
                 "table layout, the play-policy table, the forced play, exact mode's forests "
                 "and the analytic heads, K2 (score_moments) against the torch body, on cuda; "
                 "both timed", phase_nano_game, card, layouts, exact)
    cache_root.cleanup()
    k["launches"] = mp["launches"]["philox_draws"]
    layout_k4 = layouts["launches"]["philox_draws"]
    del layouts
    print(f"  philox_draws launches: main path {k['launches']}, props path "
          f"{props['launches']}, live queries {live['launches']}, slate path "
          f"{slate['launches']}, multi-leg/season/slate props {multi['launches']}, "
          f"inputs from files {files['launches']['philox_draws']}, server "
          f"{served['launches']['philox_draws']}, saved sims {saved['launches']['philox_draws']}, "
          f"other table layouts {layout_k4}, disk cache and cachewarm "
          f"{cache['launches']['philox_draws']}, trial sharding "
          f"{shard['launches']['philox_draws']}, bench entry {benched['philox_draws']}, "
          f"training {train['k4']} (0 on the main path and every score-only nano launch "
          "since K1: the draws are made in the kernel)")
    for name in ("nano_game", "score_moments"):
        nano[name]["launches"] = (PATH_LAUNCHES[name] + shard["launches"][name]
                                  + benched[name])
        print(f"  {name} launches: the paths' {PATH_LAUNCHES[name]}, trial sharding's "
              f"{shard['launches'][name]}, the bench entry's {benched[name]}")
    # trial sharding and the bench entry run score-only nano launches
    for name, attr in K1_ROWS.items():
        nano[name]["launches"] = PATH_LAUNCHES[name]
        print(f"  {name} launches ({attr}): the paths' {PATH_LAUNCHES[name]}")
        check(PATH_LAUNCHES[name] > 0, f"the paths launched {name}")
    print(f"  forest_eval launches: exact mode {exact['launches']}, inputs from files "
          f"{files['launches']['forest_eval']}, server {served['launches']['forest_eval']}, "
          f"saved sims {saved['launches']['forest_eval']}, bench entry {benched['forest_eval']}, "
          f"training {train['launches']}")
    k["launches"] += (live["launches"] + slate["launches"] + multi["launches"]
                      + files["launches"]["philox_draws"] + served["launches"]["philox_draws"]
                      + saved["launches"]["philox_draws"]
                      + layout_k4 + cache["launches"]["philox_draws"]
                      + shard["launches"]["philox_draws"] + benched["philox_draws"]
                      + train["k4"])
    exact["launches"] += (files["launches"]["forest_eval"] + served["launches"]["forest_eval"]
                          + saved["launches"]["forest_eval"] + benched["forest_eval"]
                          + train["launches"])
    exact["max_abs_err"] = max(exact["max_abs_err"], train["k5_err"])
    k["max_abs_err"] = max(k["max_abs_err"], slate["draw_err"], served["draw_err"])
    print("  seconds by phase: " + ", ".join(f"{n} {v:.1f}" for n, v in sorted(secs.items()))
          + f"; the whole smoke {time.perf_counter() - t_start:.1f} s")

    rows = {"philox_draws": k, **fused, **gathers, "forest_eval": exact, **nano}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"fast_monte_carlo_tpu_torch/csrc/{src}.cu",
         "replaces": REPLACES[name],
         **{key: rows[name][key] for key in ("launches", "max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by", "bound_class",
                                             "library_ms")}}
        for name, src in KERNEL_SOURCES.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
