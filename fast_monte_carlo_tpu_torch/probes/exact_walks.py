"""The share of every forest's walks that an exact-mode launch reads.

    python -m fast_monte_carlo_tpu_torch.probes.exact_walks [--games N] [--device cpu|cuda]

plays phase 12's exact launch of `chip_smoke.py` (the fixture teams on
`fixtures.heads(0, "reference")`, the default config, key 41, from the
kickoff) with `nano_game_plain` at N games (2,048 by default) and counts the
(row, tree) walks K1's exact instantiation takes (`game.exact_heads_read`,
the rule of its phases) forest by forest, beside the walks of every forest
on every play.  The last line is one JSON object.  The plain version walks
every forest in torch: about 100 s at 2,048 games on one CPU core.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .. import fixtures
from ..config import SimConfig
from ..ops import game
from ..ops.pack import build_packs

KEY, HEADS_SEED = 41, 0


def walk_share(games: int, device: str) -> dict:
    """Plays, each forest's walks read and trees, and the share read."""
    cfg = SimConfig()
    pack, hp = build_packs(*fixtures.teams(), fixtures.heads(HEADS_SEED, "reference"), cfg,
                           device)
    args = game.pack_nano_game(pack, cfg, hp)
    fo = torch.arange(games, dtype=torch.int32, device=device) % 2
    s = game.initial_state(games, fo, cfg, device, collect_players=False, collect_stats=False)
    walks = torch.zeros(args.exact.forests.shape[0], dtype=torch.int64, device=device)
    plays = 0
    step = game._nano_play

    def counted(a, go, st, *rest, **kw):
        nonlocal plays
        plays += int((st.sec > 0).sum())
        return step(a, go, st, *rest, **kw)

    game._nano_play = counted
    try:
        game.nano_game_plain(args, s, KEY, walks=walks)
    finally:
        game._nano_play = step
    trees = [tf.n_trees for _, tf, *_ in args.exact.heads]
    w = walks.tolist()
    return {"games": games, "plays": plays, "heads": [h for h, *_ in args.exact.heads],
            "trees": trees, "walks": w, "share": sum(w) / (plays * sum(trees)),
            "share_by_forest": [x / (plays * t) for x, t in zip(w, trees)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--games", type=int, default=2_048)
    ap.add_argument("--device", default="cpu")
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = walk_share(a.games, a.device)
    print(f"  {out['plays']:,} plays at {a.games:,} games: {out['share']:.2%} of every forest's "
          f"(row, tree) walks read ({time.perf_counter() - t0:.1f} s on {a.device})")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
