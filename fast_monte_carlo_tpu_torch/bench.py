"""Benchmark entry of the port: full-game simulations a second on the card.

    python -m fast_monte_carlo_tpu_torch.bench                  # table mode, the card
    python -m fast_monte_carlo_tpu_torch.bench --mode exact     # K5 forests every play
    python -m fast_monte_carlo_tpu_torch.bench --smoke          # a tiny run on the CPU
    python -m torch.distributed.run --standalone --nproc_per_node=W \\
        -m fast_monte_carlo_tpu_torch.bench --shard              # W ranks, one card each

The port of the repo's `bench.py` (BASELINE.md config #2: one matchup, full
play-by-play with every model head active, first offense alternating), on
torch and numpy.  It prints ONE JSON line on stdout,

    {"metric": "...", "value": N, "unit": "games/sec", "vs_baseline": N,
     "meta": {n_games, chunk_games, rng, mode, ..., backend, device, card,
              inputs, table_cache, launches, ignored}}

and everything else on stderr.  Its flags, its `SimConfig` (`sim_config`),
its workloads, its budget watchdog and its metric names are `bench.py`'s;
`vs_baseline` is games/s over the same 40 games/s.

Inputs are the repo's own unless given: the SP+ sheet
`fixtures.write_sp_sheet(<temporary directory>, 136, 0)` (`--sp PATH`), the
teams "Team A" and "Team B" (`--team-a`, `--team-b`) and the heads of
`fixtures.ARTIFACT_DIR`, the trained-shape fixture heads (`--artifacts
DIR`), read by `load_sp_flex`, `build_team_context_from_sp_flex` and
`load_heads`.  With `--sp <the 2025 SP+ sheet> --artifacts <its artifact
directory> --team-a "Kansas State" --team-b "Iowa State"` it runs BASELINE
config #2 as `bench.py` does.  The table disk cache points at a fresh
temporary directory, so `setup_s` is a cold build.

The run is on the card (`--device cuda`, the default, which raises where
there is none) unless the CPU is asked for: `--smoke` (n <= 2,048, table
mode played as analytic) or `--device cpu`.  Nothing falls back: a kernel
that does not build fails the run.  `compile_s`, the first run's seconds,
holds the first-use nvcc build of the kernels (`utils/cuda_build.py`).

`--shard` plays each launch through `MatchupRunner(shard=True)` over the
ranks of `parallel.mesh.trial_group` (a world of one outside `torchrun`),
`chunk` times the world size; rank 0 alone prints.  The ranks share one
budget deadline, so every rank ends when it expires.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import platform
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from . import fixtures, resolve_device
from .config import SimConfig
from .ops.game import RNG_IMPLS

BASELINE_GAMES_PER_SEC = 40.0
# the production lanes: (name, pairs a matchup, warm-up seconds expected);
# each runs the sheet's top 2 * LANE_GAMES teams by rating in LANE_GAMES
# matchups through api.simulate_slate_summary_rows
LANES = (("slate_loop_60x65k", 32768, 240.0), ("sweep3_60x100k", 50000, 90.0))
LANE_GAMES = 60
# the flags `bench.py` takes for knobs of the TPU's compiler, which the
# port's EngineConfig accepts and ignores (ROADMAP.md, "Do not port")
IGNORED = ("unroll", "tail_chunk", "tail_after")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="fast_monte_carlo_tpu_torch.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--budget", type=float,
                    default=float(os.environ.get("FMC_BENCH_BUDGET_S", "540")),
                    help="wall-clock seconds before the watchdog emits the best "
                         "measurement so far and exits (0 = no budget)")
    ap.add_argument("--mode", default="table", choices=["table", "exact", "analytic"])
    ap.add_argument("-n", type=int, default=4194304, help="games per timed run")
    ap.add_argument("--pairs", action="store_true", help="n counts pairs")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny run on the CPU (n <= 2,048; table mode as analytic)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--rng", default="rbg", choices=list(RNG_IMPLS),
                    help="every name draws the one Philox stream (philox_draws); "
                         "'pallas' a play a launch, the others a chunk a launch")
    ap.add_argument("--unroll", type=int, default=0, help="accepted and ignored")
    ap.add_argument("--play-chunk", type=int, default=0,
                    help="plays a draw launch and an early-exit check "
                         "(0 = config default 24)")
    ap.add_argument("--tail-chunk", type=int, default=0, help="accepted and ignored")
    ap.add_argument("--tail-after", type=int, default=144, help="accepted and ignored")
    ap.add_argument("--antithetic", action="store_true",
                    help="mirrored-draw pairs: a play draws half the rows")
    ap.add_argument("--stats", dest="stats", action="store_true", default=False,
                    help="collect box-score accrual (default off: score-only)")
    ap.add_argument("--no-stats", dest="stats", action="store_false", help=argparse.SUPPRESS)
    ap.add_argument("--raw-scores", action="store_false", dest="summary", default=True,
                    help="keep every launch's scores instead of the default "
                         "device-accumulated summary")
    ap.add_argument("--chunk", type=int, default=65536,
                    help="games a launch (0 = one launch)")
    ap.add_argument("--quality", default="nano",
                    choices=["default", "coarse", "slate", "fused", "turbo", "nano"],
                    help="table axis-resolution preset")
    ap.add_argument("--shard", action="store_true",
                    help="split every launch over the ranks (torchrun), chunk "
                         "times their number")
    ap.add_argument("--no-lanes", dest="lanes", action="store_false", default=True,
                    help="skip the slate lanes (60x65k loop, 60x100k sweep) that "
                         "otherwise run after the main result while the budget allows")
    ap.add_argument("--sp", default=None,
                    help="SP+ sheet (default: the fixture sheet, written to a "
                         "temporary directory)")
    ap.add_argument("--team-a", default=fixtures.TEAM_A[0])
    ap.add_argument("--team-b", default=fixtures.TEAM_B[0])
    ap.add_argument("--artifacts", default=fixtures.ARTIFACT_DIR,
                    help="trained heads (default: the repo's fixture heads)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; raises without one) or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        args.device = "cpu"
        args.n = min(args.n, 2048)
        if args.mode == "table":
            args.mode = "analytic"
    return args


def sim_config(args: argparse.Namespace) -> SimConfig:
    """The run's SimConfig, built as `bench.py` builds it from the same flags."""
    cfg = SimConfig()
    if args.rng != "threefry":
        cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, rng_impl=args.rng))
    if args.unroll:
        cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, scan_unroll=args.unroll))
    if args.antithetic:
        cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, antithetic=True))
    if args.play_chunk:
        cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, play_chunk=args.play_chunk))
    if args.tail_chunk:
        cfg = cfg.replace(engine=dataclasses.replace(
            cfg.engine, play_chunk_tail=args.tail_chunk, tail_after=args.tail_after))
    return cfg


def device_meta(dev: torch.device) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": platform.processor() or platform.machine(), "count": 1}


def card_name_and_limit(dev: torch.device):
    """`nvidia-smi`'s name and power limit of the run's card, None on the CPU."""
    if dev.type != "cuda":
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {type(e).__name__}: {e}"
    return out[min(dev.index or 0, len(out) - 1)] if out else None


def kernel_counters() -> dict:
    """The launch counters of the kernels a run can take (`chip_smoke.kernel_counts`):
    which engine ran shows in them (K1 `nano_game` for a table-mode launch,
    else the eager loop's `philox_draws` play chunks)."""
    from .ops import forest_eval, game, rng
    from .parallel import aggregate

    return {"philox_draws": rng.philox_draws, "forest_eval": forest_eval.eval_margin_cuda,
            "nano_game": game.nano_game_cuda, "score_moments": aggregate.exact_moments_cuda}


def load_inputs(args: argparse.Namespace, sp_path: str):
    """(SP+ table, team A's and team B's contexts, the heads or None in
    analytic mode): `bench.py`'s route through the port's loaders."""
    from .data.context import build_team_context_from_sp_flex
    from .data.sp import load_sp_flex
    from .models.heads import load_heads

    sp = load_sp_flex(sp_path)
    a = build_team_context_from_sp_flex(args.team_a, 2025, 1, sp)
    b = build_team_context_from_sp_flex(args.team_b, 2025, 1, sp)
    return sp, a, b, load_heads(args.artifacts) if args.mode != "analytic" else None


def workload(runner, args: argparse.Namespace, chunk_pairs: int):
    """(run(seed, pairs), sanity(result)): the timed workload and its check.
    The summary workload's score-only launches accumulate their moments on
    the device and end in one host copy of the summary (`run` returns it);
    the raw-scores workload enqueues its launches back to back, keeps their
    scores and ends in one host copy and a synchronize.  `sanity` gives
    (mean points of A and B, A's win rate)."""
    from . import api
    from .ops.rng import fold_in, root_key

    if args.summary:
        def run(seed0, pairs):
            s = runner.run_pairs_summary(pairs, seed=seed0, chunk_pairs=min(chunk_pairs, pairs),
                                         collect_stats=args.stats)
            return api.host_summaries(s)[0]

        def sanity(res):
            return np.asarray(res.mean_pts), float(res.win_rate[0])
    else:
        def run(seed0, pairs):
            cp = min(chunk_pairs, pairs)
            root = root_key(seed0)
            outs = [runner.run_pairs(min(cp, pairs - ci * cp), key=fold_in(root, ci),
                                     collect_players=False, collect_stats=args.stats)
                    for ci in range(-(-pairs // cp))]
            _ = outs[-1].score[:16].cpu()
            if runner.device.type == "cuda":
                torch.cuda.synchronize(runner.device)
            return outs

        def sanity(res):
            score = torch.cat([o.score for o in res]).cpu().numpy()
            return score.mean(axis=0), float((score[:, 0] > score[:, 1]).mean())
    return run, sanity


def _min_over_ranks(tg, x: float) -> float:
    """The least of the ranks' `x`: the budget's wall-clock deadline, so
    that every rank's watchdog ends its process at once, and the seconds
    left before a repeat, so that every rank takes the same one and none is
    left alone in a collective."""
    if tg.world == 1:
        return x
    import torch.distributed as dist

    t = torch.tensor([x], dtype=torch.float64,
                     device=tg.device if tg.backend == "nccl" else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=tg.group)
    return float(t.item())


def main(argv=None) -> int:
    t_start = time.time()
    args = parse_args(argv)
    from . import api
    from .ops import table_lookup
    from .parallel.mesh import agree, local_group, trial_group

    resolve_device(args.device)     # raises here for a card that is absent
    tg = (trial_group if args.shard else local_group)(args.device)
    dev, rank = tg.device, tg.rank

    def log(msg: str) -> None:
        if rank == 0:
            print(msg, file=sys.stderr, flush=True)

    deadline = _min_over_ranks(tg, t_start + args.budget) if args.budget > 0 else None
    log(f"# device: {dev} {device_meta(dev)['kind']}")
    cfg = sim_config(args)
    tmp = tempfile.TemporaryDirectory(prefix="fmc_bench_")
    # the table disk cache in a fresh directory: setup_s is a cold build
    table_lookup.TABLE_CACHE_DIR = os.path.join(tmp.name, "table_cache")
    sp_path = args.sp or fixtures.write_sp_sheet(os.path.join(tmp.name, "sp.csv"), 136, 0)

    sp, a, b, heads = agree(tg, lambda: load_inputs(args, sp_path))
    t0 = time.perf_counter()
    runner = api.MatchupRunner(a, b, heads, cfg, mode=args.mode, table_quality=args.quality,
                               shard=args.shard, device=dev)
    build_s = time.perf_counter() - t0
    ndev = tg.world
    log(f"# setup (incl. table build): {build_s:.1f}s"
        + (f" | sharded over {ndev} rank(s)" if args.shard else ""))

    n_pairs = args.n if args.pairs else max(1, args.n // 2)
    stats = args.stats
    chunk_pairs = (args.chunk // 2) if args.chunk else n_pairs
    if args.shard:
        # each rank keeps the 65,536-game launch
        chunk_pairs *= ndev
    chunk_pairs = min(chunk_pairs, n_pairs)
    if args.shard and not args.summary:
        # run_pairs refuses launches that the ranks do not divide: whole
        # sharded launches, as bench.py rounds them
        div = ndev // math.gcd(2, ndev)
        if chunk_pairs % div:
            chunk_pairs = -(-chunk_pairs // div) * div
        rounded = -(-n_pairs // chunk_pairs) * chunk_pairs
        if rounded != n_pairs:
            log(f"# --shard raw-scores: n rounded {2*n_pairs:,} -> {2*rounded:,} games "
                "(whole sharded launches)")
            n_pairs = rounded

    run_workload, sanity = workload(runner, args, chunk_pairs)

    # ---- budget-guarded emission: bench.py's watchdog -----------------
    lock = threading.Lock()
    counters = kernel_counters()
    state = {"best": None, "emitted": False, "compile_s": None, "setup_s": build_s,
             "runs": [], "lanes": [], "launches": None}
    inputs_meta = {"sp": sp_path, "sp_source": "given" if args.sp else
                   "fixtures.write_sp_sheet(<temporary directory>, 136, 0)",
                   "team_a": args.team_a, "team_b": args.team_b,
                   "artifacts": None if args.mode == "analytic" else args.artifacts}
    card = card_name_and_limit(dev)

    def emit(tag):
        """Print the one JSON line (rank 0).  Returns 'now' | 'already' | 'nothing'."""
        with lock:
            if state["emitted"]:
                return "already"
            if state["best"] is None:
                return "nothing"
            state["emitted"] = True
            if rank != 0:
                return "now"
            gps, pairs, eff_chunk_pairs = state["best"]
            launches = state["launches"] or {k: fn.launches for k, fn in counters.items()}
            print(json.dumps({
                "metric": f"full_game_sims_per_sec_single_chip_{args.mode}"
                          + ("_summary" if args.summary else "")
                          + ("_sharded" if args.shard else ""),
                "value": round(gps, 1),
                "unit": "games/sec",
                "vs_baseline": round(gps / BASELINE_GAMES_PER_SEC, 1),
                "meta": {
                    "n_games": 2 * pairs, "chunk_games": 2 * eff_chunk_pairs,
                    "chunk_games_configured": 2 * chunk_pairs,
                    "rng": args.rng, "mode": args.mode,
                    "workload": "summary" if args.summary else "raw_scores",
                    "stats": stats, "quality": args.quality,
                    "ndev": ndev, "sharded": args.shard,
                    "setup_s": round(state["setup_s"], 1),
                    "compile_s": (None if state["compile_s"] is None
                                  else round(state["compile_s"], 1)),
                    "runs": [round(x, 1) for x in state["runs"]],
                    "lanes": state["lanes"],
                    "emit": tag,
                    "backend": "torch",
                    "device": device_meta(dev),
                    "card": card,
                    "inputs": inputs_meta,
                    "table_cache": {"dir": table_lookup.TABLE_CACHE_DIR,
                                    "state": "fresh temporary directory: a cold build"},
                    "launches": launches,
                    "ignored": {k: getattr(args, k) for k in IGNORED},
                },
            }), flush=True)
            return "now"

    def watchdog():
        while True:
            left = deadline - time.time()
            if left <= 0:
                break
            time.sleep(min(left, 5.0))
            with lock:
                if state["emitted"]:
                    return
        got = emit("budget_expired")
        if got == "already":
            return
        if got == "now":
            log("# budget expired: emitted best-so-far")
            os._exit(0)
        log("# budget expired before ANY measurement: the set-up and the first run "
            "(which builds the kernels on first use) took longer than the budget")
        os._exit(3)

    if deadline is not None:
        threading.Thread(target=watchdog, daemon=True).start()

    def timed(seed0, pairs):
        t0 = time.perf_counter()
        res = run_workload(seed0, pairs)
        dt = time.perf_counter() - t0
        gps = 2 * pairs / dt
        with lock:
            state["runs"].append(gps)
            if state["best"] is None or gps > state["best"][0]:
                state["best"] = (gps, pairs, min(chunk_pairs, pairs))
        log(f"# run n={2*pairs:,}: {dt:.3f}s -> {gps:,.0f} games/s")
        return res, dt

    try:
        for fn in counters.values():
            fn.launches = 0
        # the first chunk-sized launch builds the kernels; a quick shape
        # right after it gives a number soon
        quick_pairs = min(n_pairs, max(chunk_pairs, 524288))
        if args.shard and not args.summary:
            quick_pairs = min(n_pairs, -(-quick_pairs // chunk_pairs) * chunk_pairs)
        t0 = time.perf_counter()
        outs = run_workload(args.seed, quick_pairs)
        state["compile_s"] = time.perf_counter() - t0
        log(f"# compile+first run: {state['compile_s']:.1f}s (launches of {2*chunk_pairs:,})")
        # the first run is a valid (slow) measurement until a clean one beats it
        with lock:
            state["best"] = (2 * quick_pairs / state["compile_s"], quick_pairs,
                             min(chunk_pairs, quick_pairs))
        outs, _ = timed(args.seed + 500, quick_pairs)

        full_est = _min_over_ranks(tg, (2 * n_pairs) / max(state["best"][0], 1.0) * 1.5 + 3.0)
        for r in range(args.repeats):
            if n_pairs == quick_pairs and r == 0 and args.repeats == 1:
                break  # the quick run already measured the requested shape once
            left = (_min_over_ranks(tg, deadline - time.time()) if deadline is not None
                    else float("inf"))
            if left < full_est:
                log(f"# budget: skipping full-shape repeat {r} ({left:.0f}s left < "
                    f"{full_est:.0f}s est)")
                break
            outs, _ = timed(args.seed + 1000 * (r + 1), n_pairs)
        with lock:
            state["launches"] = {k: fn.launches for k, fn in counters.items()}
    except Exception:
        # a collective whose peer the shared deadline just ended: this
        # rank's watchdog ends the process too, as the budget says
        if tg.world > 1 and deadline is not None and deadline - time.time() < 5.0:
            time.sleep(max(deadline - time.time(), 0.0) + 30.0)
        raise

    mean, win_a = sanity(outs)
    log(f"# sanity: mean {np.asarray(mean, float).round(2).tolist()} winA {win_a:.4f}")

    if args.lanes and args.mode == "table" and not args.shard:
        run_lanes(args, sp, sp_path, cfg, dev, deadline, state, lock, log)

    emit("complete")
    tmp.cleanup()
    if tg.world > 1:
        import torch.distributed as dist
        dist.barrier()      # every rank done before any tears the group down
        dist.destroy_process_group()
        # leave without the interpreter's teardown, where gloo has aborted a
        # rank after destroy_process_group (rc -6), its line printed
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
    return 0


def run_lanes(args, sp, sp_path: str, cfg: SimConfig, dev, deadline, state, lock,
              log) -> None:
    """The slate lanes after the main result, while the budget allows: the
    sheet's top 2 * LANE_GAMES teams by rating paired in rating order, a
    warm-up call (the tables' build) and a timed call of
    `api.simulate_slate_summary_rows` each.  A lane that fails is recorded
    with its error and the next one runs."""
    from . import api

    order = np.argsort(-np.asarray(sp["RATING"], dtype=float), kind="stable")
    ranked = [sp["team"][i] for i in order]
    games = [(ranked[i], ranked[i + 1]) for i in range(0, 2 * LANE_GAMES, 2)]
    for lane, np_lane, warm_est in LANES:
        left = deadline - time.time() if deadline is not None else float("inf")
        if left < warm_est + 30.0:
            log(f"# lane {lane}: skipped ({left:.0f}s budget left < {warm_est + 30:.0f}s est)")
            break
        kw = dict(sp_path=sp_path, n_pairs=np_lane, chunk_pairs=np_lane,
                  artifact_dir=args.artifacts, mode="table", table_quality=args.quality,
                  seed=args.seed, cfg=cfg, device=dev)
        try:
            t0 = time.perf_counter()
            api.simulate_slate_summary_rows(games, **kw)     # builds the tables
            warm_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            rows, _ = api.simulate_slate_summary_rows(games, **kw)
            dt = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — recorded in meta.lanes
            with lock:
                state["lanes"].append({"lane": lane, "error": f"{type(e).__name__}: {e}"})
            log(f"# lane {lane} failed ({type(e).__name__}: {e})")
            continue
        n_lane = int(sum(r["n_games"] for r in rows))
        gps = n_lane / dt
        with lock:
            state["lanes"].append({"lane": lane, "games_per_sec": round(gps, 1),
                                   "n_games": n_lane, "matchups": len(games),
                                   "warmup_s": round(warm_s, 1), "run_s": round(dt, 3)})
        log(f"# lane {lane}: {gps:,.0f} games/s ({n_lane:,} games in {dt:.2f}s; "
            f"warmup {warm_s:.0f}s)")


if __name__ == "__main__":
    raise SystemExit(main())
