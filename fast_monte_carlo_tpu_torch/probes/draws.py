"""philox_draws (K3/K4) against its plain version at ragged shapes, many times.

    python -m fast_monte_carlo_tpu_torch.probes.draws [--rounds 50]
        [--random-keys 50] [--seed 24] [--out DIR]

runs the ragged comparison of `chip_smoke.py` phase 3 (`RAGGED_KEYS`, each
(key, step base) pair at every `ragged_shapes()` launch: step axes of 1, 3
and 24 by 1, 255, 257 and 65,573 rows, so tiles end inside a row of
uniforms, below, just past and 37 past a tile multiple) `--rounds` times,
then once for each of `--random-keys` (key, step base) pairs drawn from
`--seed`.  Each launch of `rng.chunk_draws` on the card is held to
`rng.philox_draws_reference` on the card, uniforms bit for bit and normals
within 1e-5 (the kernel's `logf`/`sincosf` against torch's).  It prints
each differing launch (key, base, shape, the count of differing uniforms,
the first index and both values), and the counts of launches compared and
differing; with `--out` the differing launches' values are kept in
DIR/draws_differ.pt.  The last line is one JSON object of the counts.  Exit
1 where any launch differs.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import rng

# phase 3's (key, step base) pairs: the root key, a folded key past step
# 192, and the largest key with a base whose 24 steps wrap the 32-bit step
RAGGED_KEYS = ((rng.root_key(0), 0), (rng.fold_in(rng.root_key(1), 5), 192),
               ((1 << 64) - 1, (1 << 32) - 12))


def ragged_shapes(ch: int = 24, n: int = 65_536) -> List[Tuple[int, int]]:
    """Phase 3's ragged (steps, rows) launches about the main path's (ch, n)."""
    return [(c, m) for c in (1, 3, ch) for m in (1, 255, 257, n + 37)]


def compare(key: int, base: int, ch: int, n: int, dev: torch.device):
    """(uniforms equal, normals' largest |difference|, a record of the
    difference or None) of one launch against the plain version."""
    u, z = rng.chunk_draws(key, base, ch, n, dev)
    ur, zr = rng.philox_draws_reference(key, base, ch, n, dev)
    err = float((z - zr).abs().max())
    if torch.equal(u, ur):
        return True, err, None
    d = (u != ur).nonzero()
    i = tuple(d[0].tolist())
    return False, err, {"key": key, "base": base, "ch": ch, "n": n, "differ": int(d.shape[0]),
                        "first": i, "kernel": float(u[i]), "plain": float(ur[i]),
                        "where": d.cpu(), "u": u[d.unbind(1)].cpu(), "ur": ur[d.unbind(1)].cpu()}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--random-keys", type=int, default=50)
    ap.add_argument("--seed", type=int, default=24)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("draws: this probe needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = np.random.default_rng(args.seed)
    pairs = [("phase 3", key, base) for _ in range(args.rounds) for key, base in RAGGED_KEYS]
    for _ in range(args.random_keys):
        hi, lo, base = (int(x) for x in gen.integers(0, 1 << 32, size=3))
        pairs.append(("random", hi << 32 | lo, base))
    launches, worst, differ = 0, 0.0, []
    for what, key, base in pairs:
        for ch, n in ragged_shapes():
            same, err, rec = compare(key, base, ch, n, dev)
            launches += 1
            worst = max(worst, err)
            if not same:
                rec["what"] = what
                differ.append(rec)
                print(f"  {what} key {key:#x} base {base} ({ch}, {n}): {rec['differ']} uniforms "
                      f"differ, first {rec['first']} {rec['kernel']!r} against {rec['plain']!r}")
    torch.cuda.synchronize()
    if differ and args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        torch.save(differ, args.out / "draws_differ.pt")
    print(f"  philox_draws against philox_draws_reference: {launches} ragged launches "
          f"({args.rounds} rounds of phase 3's {len(RAGGED_KEYS)} keys, {args.random_keys} "
          f"random keys; {len(ragged_shapes())} shapes each), {len(differ)} differing; normals "
          f"max|d| {worst:.3g} ({torch.cuda.get_device_name(0)})")
    print(json.dumps({"launches": launches, "differing": len(differ),
                      "normals_max_abs_err": worst, "rounds": args.rounds,
                      "random_keys": args.random_keys}))
    return 1 if differ or worst > 1e-5 else 0


if __name__ == "__main__":
    sys.exit(main())
