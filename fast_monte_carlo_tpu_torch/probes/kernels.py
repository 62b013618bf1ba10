"""The CUDA kernels alone, timed by held CUDA events.

    python -m fast_monte_carlo_tpu_torch.probes.kernels [--csrc DIR] [--forests-only]

builds the draw, fused-step, row-gather and forest-walk sources of `csrc/`
(or of DIR, a copy of another commit's `csrc/`, so that two versions are
timed in one call, one process each) and prints the device time per call
of each of their kernels at the shapes `chip_smoke.py` times, of a step of
the probe loops that launch fused_step_tab and row_gather_sum, in their own
launch order (`path_times`), and of a near-empty launch
(`torch.cuda._sleep(1)`): the gap between back-to-back kernels that every
held time includes.  K5 (`forest_times`) is timed at the exact-mode play's
shapes: each forest of `fixtures.heads(0, "reference")` on 65,536 rows of
play states, and their sum over the 11 forests a play evaluates at the
default config; a DIR whose forest_eval.cu has the first K5's launcher (one
f32 node table) gets its inputs packed for that launcher.  `--forests-only`
times K5 alone.  The last line is one JSON object of the times.
philox_draws is timed at row offset `DRAW_ROW0` (the rows a second rank
plays); a DIR whose philox_draws.cu predates the row offset (its launcher
takes no row0) has its draws left out.

`held_ms` is the timer, and `kernel_times` the kernel times, that
`chip_smoke.py` reports: CUDA events around back-to-back calls that the
host enqueued while a spin kernel held the stream, so that a call of a few
microseconds is not timed by the host's launch rate.
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..utils import cuda_build
from . import gather

SOURCES = ("philox_draws", "fused_step", "row_gather", "forest_eval")
# what kernel_times times, with the calls of each held run
RUNS = {"philox_draws ch=24": 50, "philox_draws ch=1": 200, "fused_step ch=24": 50,
        "fused_step ch=1": 200, "fused_step_tab": 200, "row_gather_sum B3": 200,
        f"row_gather_sum B6 B={gather.B6_BS[-1]}": 200}
# philox_draws' first row in kernel_times: rank 1's rows of a two-rank
# launch of 131,072 games
DRAW_ROW0 = 65_536
# what path_times times: steps of each probe loop in one held run, about
# 530 and 260 launches, within the card's launch queue
PATH_STEPS = {"hybrid-tab step": 16, "B3 loop step": 64}
# K5's inputs: fixtures.heads(HEADS_SEED, "reference") on the focus-roster
# teams of FOCUS_SEED, K5_B rows a launch, K5_REPS calls a held run
HEADS_SEED, FOCUS_SEED, K5_B, K5_REPS = 0, 3, 65_536, 20


@functools.lru_cache(maxsize=None)
def cycles_per_ms() -> float:
    """Clock cycles of `torch.cuda._sleep` per ms, measured on the card."""
    torch.cuda._sleep(1000)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    torch.cuda._sleep(20_000_000)
    t1.record()
    torch.cuda.synchronize()
    return 20_000_000 / t0.elapsed_time(t1)


# held measurements of a kernel before kernel_times gives up
HELD_TRIES = 3


def held_ms(fn, reps: int):
    """(ms per call, held): CUDA events around `reps` back-to-back calls
    that the host enqueues while a spin kernel holds the stream, so that
    the events time the calls' device work and not the host's time between
    launches, which bounds a call of a few microseconds.  `held` is False
    where the host was still enqueuing when the hold ended (a plain version
    of thousands of kernels fills the launch queue); the time then includes
    the host's."""
    fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(reps):
        fn()
    hold = 2 * (time.perf_counter() - h0) * 1e3 + 1.0
    torch.cuda.synchronize()
    for _ in range(2):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold * cycles_per_ms()))
        t0.record()
        h0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue = (time.perf_counter() - h0) * 1e3
        t1.record()
        held = not t0.query()
        torch.cuda.synchronize()
        if held or enqueue >= hold:          # a longer hold would not help
            break
        hold *= 4
    return t0.elapsed_time(t1) / reps, held


@functools.lru_cache(maxsize=None)
def launch_gap_ms() -> float:
    """Held time of a near-empty kernel (`torch.cuda._sleep(1)`), measured
    once: the card's gap between back-to-back launches, which every held
    time includes."""
    return held_ms(lambda: torch.cuda._sleep(1), 200)[0]


def kernel_times(dev: torch.device, names: Sequence[str] = tuple(RUNS)) -> Dict[str, float]:
    """Held ms per call of each kernel of `names` (keys of RUNS):
    philox_draws at (24, 65,536) into a held buffer and at (1, 65,536),
    from row DRAW_ROW0;
    fused_step at B = 131,072, ch = 24 and 1, from kick-off; fused_step_tab
    at B = 131,072; row_gather_sum at B3's shape and at B6's 8,192 rows of
    128.  Each kernel runs back to back after itself, a launch order no
    probe has (`path_times` times theirs).  Raises where the hold did not
    cover the enqueue in any of HELD_TRIES measurements (a kernel's enqueue
    takes microseconds, so a miss is the host stalling, not the kernel)."""
    from ..ops import rng
    from . import step_arith as sa

    key = rng.root_key(2)
    calls = {}
    if any(n.startswith("philox") for n in names):
        buf = (torch.empty((24, 65536, rng.N_UNIFORMS), device=dev),
               torch.empty((24, 65536, rng.N_NORMALS), device=dev))
        calls["philox_draws ch=24"] = lambda: rng.chunk_draws(key, 0, 24, 65536, dev, out=buf,
                                                              row0=DRAW_ROW0)
        calls["philox_draws ch=1"] = lambda: rng.step_draws(key, 0, 65536, dev, row0=DRAW_ROW0)
    if any(n.startswith("fused") for n in names):
        s0 = sa.init_state(sa.B_DEFAULT, dev)
        heads = sa.heads_of(s0, sa.make_table(dev))
        calls["fused_step ch=24"] = lambda: sa.fused_step(s0, key, 0, sa.CH)
        calls["fused_step ch=1"] = lambda: sa.fused_step(s0, key, 0, 1)
        calls["fused_step_tab"] = lambda: sa.fused_step_tab(s0, heads, key, 0)
    if any(n.startswith("row_gather_sum") for n in names):
        for what, table, idx in gather.probe_shapes(dev):
            if f"row_gather_sum {what}" in RUNS:
                calls[f"row_gather_sum {what}"] = (
                    lambda table=table, idx=idx: gather.row_gather_sum(table, idx))
    out = {}
    for name in names:
        for _ in range(HELD_TRIES):
            ms, held = held_ms(calls[name], RUNS[name])
            if held:
                break
        else:
            raise RuntimeError(f"{name}: the hold did not cover the enqueue")
        out[name] = ms
    return out


def path_times(dev: torch.device) -> Dict[str, float]:
    """Held device ms per step of the two probe loops that launch
    fused_step_tab and row_gather_sum, in the order they launch them: a
    hybrid-tab step at B = 131,072 (`heads_of`'s torch kernels, then
    fused_step_tab on the previous step's state) and a step of B3's loop
    (the index shift in torch, row_gather_sum, the accumulate).  There each
    kernel follows and precedes torch kernels.  Each held run starts anew
    from the same inputs.  Raises where the hold did not cover the
    enqueue."""
    from ..ops import rng
    from . import step_arith as sa

    key, values = rng.root_key(8), sa.make_table(dev)
    s0 = sa.init_state(sa.B_DEFAULT, dev)
    tab, idx = gather.b3_inputs(dev)

    def hybrid():
        s = s0
        for j in range(PATH_STEPS["hybrid-tab step"]):
            s = sa.fused_step_tab(s, sa.heads_of(s, values), key, j)
        return s

    runs = {"hybrid-tab step": hybrid,
            "B3 loop step": lambda: gather.b3_loop(gather.row_gather_sum, tab, idx,
                                                   steps=PATH_STEPS["B3 loop step"])}
    out = {}
    for name, fn in runs.items():
        ms, held = held_ms(fn, 1)
        if not held:
            raise RuntimeError(f"{name}: the hold did not cover the enqueue")
        out[name] = ms / PATH_STEPS[name]
    return out


def k5_forests(dev: torch.device):
    """The reference-shape heads on `dev`: (the ModelHeads, FlatForest by
    name, TorchForest by name, the names a play evaluates at the default
    config (no fumbles, no play policy), the matchup pack of the
    focus-roster teams)."""
    from .. import fixtures
    from ..config import SimConfig
    from ..ops.pack import build_packs

    heads = fixtures.heads(HEADS_SEED, "reference")
    pack, hp = build_packs(*fixtures.focus_teams(FOCUS_SEED), heads, SimConfig(), dev,
                           fixtures.COACH_MAP)
    host = {"stage1": heads.stage1, "stage2": heads.stage2, "fumble": heads.fumble,
            "play": heads.play}
    packed = {"stage1": hp.stage1, "stage2": hp.stage2, "fumble": hp.fumble, "play": hp.play}
    for kind, trio, ptrio in (("pq", heads.pass_quants, hp.pq), ("rq", heads.rush_quants, hp.rq),
                              ("sq", heads.sack_quants, hp.sq)):
        for i in range(3):
            host[f"{kind}{i}"], packed[f"{kind}{i}"] = trio[i], ptrio[i]
    play = [k for k in packed if k not in ("fumble", "play")]
    return heads, host, packed, play, pack


def k5_rows(pack, rng: np.random.Generator, b: int, dev: torch.device):
    """(x (b, 17) f32 ST1 feature rows of `fixtures.play_states`, as exact
    mode builds them, and (b,) int32 ids from -1 over the first few
    categories for each group)."""
    from .. import fixtures
    from ..config import SimConfig
    from ..ops import game

    d = fixtures.play_states(rng, b)
    t = {k: torch.tensor(v, device=dev) for k, v in d.items()}
    sd = (t["score"][:, 0] - t["score"][:, 1]) * (1 - 2 * t["off"])
    x = game._state_features(pack, SimConfig(), t["gid"] * 2 + t["off"], t["down"], t["dist"],
                             t["ytg"], t["sec"], sd)
    return x, {g: torch.tensor(rng.integers(-1, 8, b).astype(np.int32), device=dev)
               for g in ("passer_name", "target_name", "rusher_name", "head_coach")}


def k5_args(tf, x: torch.Tensor, ids: dict):
    """The feature columns and ids forest tf reads: the play head its 12
    numerics."""
    xx = x if x.shape[1] == len(tf.numeric_names) else x[:, :len(tf.numeric_names)].contiguous()
    return xx, {g: ids[g] for g in tf.group_names}


def _node_table_call(lib, tf, x: torch.Tensor, cid: torch.Tensor):
    """A call of the first K5's launcher, `forest_eval_launch` (the (N, 8) f32
    node table, leaves, roots), on the current stream."""
    import ctypes

    fn = lib.forest_eval_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((x.shape[0], tf.n_classes), dtype=torch.float32, device=x.device)

    def call():
        err = fn(tf.nodes.data_ptr(), tf.leaf.data_ptr(), tf.roots.data_ptr(),
                 tf.tree_class.data_ptr(), tf.base_margin.data_ptr(), x.data_ptr(),
                 cid.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], cid.shape[1],
                 tf.n_trees, tf.n_classes, tf.max_depth, int(tf.cmp_lt),
                 int(tf.zero_as_missing), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"forest_eval_launch failed: CUDA error {err}")
        return out
    return call


def forest_times(dev: torch.device, lib) -> Dict[str, float]:
    """Held ms per K5 launch on each reference-shape forest at K5_B rows
    and their sum over a play's forests ("forest_eval a play"; "forest_eval
    play" is the play head), through the forest_eval library `lib`: the
    wrapper's launcher (`forest_eval_packed_launch`) or the first K5's
    (`forest_eval_launch`).  Each
    forest's margins are first held to `eval_margin_reference`
    (rtol=1e-5, atol=1e-4); raises where they are not, or where the hold
    did not cover the enqueue."""
    from ..ops import forest_eval as fe

    *_, packed, play, pack = k5_forests(dev)
    x, ids = k5_rows(pack, np.random.default_rng(12), K5_B, dev)
    out, equal = {}, 0
    for name, tf in packed.items():
        xx, cats = k5_args(tf, x, ids)
        cid = fe.category_matrix(tf, cats, K5_B, dev)
        call = (functools.partial(fe.eval_margin_cuda, tf, xx, cid)
                if hasattr(lib, "forest_eval_packed_launch")
                else _node_table_call(lib, tf, xx, cid))
        got, want = call().clone(), fe.eval_margin_reference(tf, xx, cats)
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-4):
            raise RuntimeError(f"forest_eval {name}: off its plain version by "
                               f"{float((got - want).abs().max()):.3g}")
        equal += int(torch.equal(got, want))
        ms, held = held_ms(call, K5_REPS)
        if not held:
            raise RuntimeError(f"forest_eval {name}: the hold did not cover the enqueue")
        out[f"forest_eval {name}"] = ms
    out["forest_eval a play"] = sum(out[f"forest_eval {k}"] for k in play)
    print(f"  forest_eval bitwise equal to its plain version on {equal} of {len(packed)} forests")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, default=cuda_build.CSRC, metavar="DIR",
                    help="build from DIR instead of the package's csrc/")
    ap.add_argument("--forests-only", action="store_true", help="time K5 alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernels: this probe needs an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    csrc = args.csrc.resolve()
    libs = dict(zip(SOURCES, cuda_build.load_kernel_libraries(*SOURCES, csrc=csrc)))
    dev = torch.device("cuda")
    names = [n for n in RUNS if "row0" in (csrc / "philox_draws.cu").read_text()
             or not n.startswith("philox")]
    times = {} if args.forests_only else {**kernel_times(dev, names), **path_times(dev)}
    times.update(forest_times(dev, libs["forest_eval"]))
    times["launch gap"] = launch_gap_ms()
    for name, ms in times.items():
        print(f"  {name}: {ms:.5f} ms held ({card})")
    print(json.dumps({"csrc": str(csrc), "card": card, "held_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
