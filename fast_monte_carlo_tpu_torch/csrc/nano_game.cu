// K1: a whole launch of nano-table games in one kernel launch, score-only or
// with the box score, the player stats or both.
//
// Replaces the compiled game loop of the JAX package (XLA on the TPU, not a
// Pallas kernel): fast_monte_carlo_tpu/ops/game.py:844 simulate_games (its
// while_loop over chunks of a scan over :337 play_step, the draws made
// inside it) with the nano table heads of
// fast_monte_carlo_tpu/ops/table_lookup.py:661 _nano_eval, and its
// collectors: :309 _sample_slot, the team box score (:586-620) and the
// player stats (:622-653).  Its plain version is ops/game.nano_game_plain;
// the eager loop it stands in for on the card is
// ops/game.simulate_games_eager.
//
// One lane plays one game at a time.  The state (off, sec, down, dist, ytg,
// period, in_rz, going, score) stays in registers from the starting state to
// the game's end; gid and the game's two directions' constants are read when
// the lane takes the game.  The lane plays until sec == 0 or the eager
// loop's cap, whole chunks of play_chunk plays (360 at the defaults).  A
// game that has ended is a fixed point of the masked eager step (sec 0,
// period 4, nothing else moves), so stopping it early leaves the state the
// eager loop leaves; a game that starts with sec <= 0 gets the one masked
// step's sec = 0, period = 4 where the eager loop runs a play at all
// (`run_flag`: some game active, or early_exit off).
//
// Each play follows ops/game.play_step's order, operation for operation:
// draw the 13 uniforms and 4 normals of (key, absolute step, row) with
// Philox (philox.cuh, the stream philox_draws writes), mirrored for
// antithetic games (game b plays draw row r0 + 2 (b / 4) + b % 2, as 1 - u
// and -n where b % 4 >= 2); the 4th-down decision, the FG curve, the punt,
// the pass, sack, INT and run branches with their quirks; the nano lookup
// (dist, ytg, sec and score diff binned by _seg_bin's segment arithmetic,
// then the c floats of the state's (down, sd) block of one row), unpacked
// with or without stage-2 and fumble channels (the analytic stage 2 where
// there are none); phases a-c, the halftime flip and the score.  No nano
// head reads a player slot, so the slot draws (QB, target, rusher) are
// sampled only by the instantiation with the player stats, and there only
// for the roles the play involves.  The file is compiled with --fmad=false (utils/cuda_build.py) and
// writes every literal as f32, so each multiply and add rounds on its own as
// the eager step's one torch kernel a operation does.  What the eager step
// computes per direction only (the explosive base, the two red-zone tanh
// tilts, the SP+ yard multiplier and mismatch z) comes in per direction,
// computed on the device by the same torch expressions (ops/game.
// pack_nano_game), so this kernel never evaluates tanhf.  The SimConfig
// constants, the padded go-for-it edges and grid, the FG curve and the
// segments come in NanoConsts, built on the host from the config.
//
// Bound on the H100: the games' state read and written once (40 bytes in,
// 36 out a game) and the nano table read once (6.9 MB a matchup) are far
// under the instructions a play takes, about 713 dispatched (counted on the
// SASS in chip_smoke.NANO_COUNTS), so K1 is bound by issue; with the
// collectors also their stats and the player rows they touch, and the work
// they need: 28 instructions more a play (the team stats' adds and
// fourth_conv's and rz_TD's tests, not the stripe's loads and stores), 27 a
// slot sampled and 12 a player row added (3 8-byte loads, 6 adds, 3
// 8-byte stores; chip_smoke.NANO_TEAM_COUNTS, _SLOT_, _ROW_), still bound by
// issue.  The nano table of one matchup stays in the 50 MB L2; a
// 60-matchup slate's 413 MB does not, and a play's 28-40 bytes are then a
// sector-sized read from HBM.
//
// Design (the first version, 11985e6, ran one thread a game in a grid of
// n / 128 blocks):
// - A persistent grid: as many blocks of kThreads as the card holds at once
//   (the occupancy API x the SMs, asked once by the wrapper), and no more
//   than n games fill.  Lane t takes game t; when games of a warp end, one
//   lane claims as many next games from the launch's work counter with one
//   atomicAdd (the __popc of the warp's ballot of ended games), so a warp
//   stays full until the queue drains.  Games are taken in index order, so
//   a slate's matchups in flight are a few consecutive ones.  A game draws
//   on its own row (r0 + i, or the antithetic map) from absolute step 0,
//   so its result does not depend on the lane that plays it or when.
//   The counter is the stream's (ops/game._nano_work); the last block to
//   finish resets it, so each launch finds it 0 without a fill.
// - Each play bins the state, issues the nano row's loads, then draws its
//   13 uniforms and 4 normals (Philox and Box-Muller) under their latency,
//   and only then plays (the SASS shows the row's LDGs ahead of the
//   Philox IMADs).  Binning counts the segment boundaries a value is past
//   and evaluates that one segment from shared memory: the first version's select over
//   all 8 segments of 4 axes, once moved ahead of the draws, compiled into
//   divergent branches (0.824 ms a 65,536-game launch against the first
//   version's 0.695, on the card below).
// - The go-for-it grid and the segments' values sit in shared memory; the
//   other searches unroll into compares against kernel-parameter constants.
// - Block size, held ms on an NVIDIA H100 80GB HBM3 at 700 W
//   (probes/kernels.py --games-only on copies of this file; a 65,536-game
//   launch / a 60-matchup slate launch of 1,966,080 games; the first version 0.695 /
//   17.30 ms in the same call): 64 threads 0.646 / 15.11 ms (75
//   registers); 128 threads 0.642-0.645 / 15.03 (71); 256 threads 0.627 /
//   15.18 (71; 3 blocks an SM, 24 warps, against 7 of 128 threads, 28
//   warps); __launch_bounds__ with a minimum of blocks capped the
//   registers and spilled or ran slower (128 x 8: 64 registers, 42 bytes
//   spilled, 0.668 / 15.25; 128 x 6: 0.651 / 15.41; 256 x 4: 64 registers,
//   spilled, 0.643 / 15.19).  256 threads, no minimum: the main path's
//   65,536-game launches are the most launched.  At 65,536 games the grid
//   holds every game in its first round (15.5 warps an SM: the games, not
//   the registers, bound the warps), so the queue never refills there.
// - The lane share, plays over 32 lanes x the loop trips of every warp
//   (the `iters` counter): 0.946 at 65,536 games in both layouts, so games
//   of one warp end within about 5% of each other's plays and the first version's gap
//   to the bound was not the warps' spread; on the slate launch 0.979
//   against 0.946 for one game a thread.
// - The collectors: one instantiation a combination (`template <bool kStats,
//   bool kPlayers>`); the score-only one compiles to the same SASS as the
//   kernel before them, instruction for instruction.  Held ms at 65,536
//   games of the focus-roster fixture on an NVIDIA H100 80GB HBM3 at 700 W
//   (probes/kernels.py --games-only --csrc on copies of this file, one
//   process each, each comparison's versions in one call; score-only
//   0.626-0.632 throughout):
//   - Team stats in a stripe of shared memory, 38 floats a lane (38.9 KB a
//     block, dynamic), read when the lane takes its game and written when
//     it ends: box score alone 0.690-0.696 ms.  The same adds read and
//     written in the game's global stats every play: 3.488-3.528 ms (a
//     warp's games 152 bytes apart; props 4.703-4.747 against 1.286-1.296).
//   - Player rows read, added to and written in the game's own pstats (a
//     lane owns its game: no atomics).  With 4-byte accesses, player stats
//     alone 1.216-1.223 ms, props 1.286-1.296; with 8-byte ones 1.157 and
//     1.229; sampling the slots and their flags ahead of the play, the rows
//     read after it: 1.165 and 1.228 (no gain; 10 bytes spilled); the
//     tracked rows read ahead of the play too, into registers (the props
//     instantiation at 128, no spills): 1.063 and 1.129, kept.
// Each thread adds its games' plays to a block count in shared memory and
// one thread a block adds that to `plays`, when given: what the
// measurement's bound counts.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {
constexpr int kSlots = 8;       // go-for-it edges an axis, FG points
constexpr int kSegs = 8;        // segments an axis of the nano profile
constexpr int kGridCells = 81;  // (8 + 1) x (8 + 1) go-for-it cells
constexpr int kDirVals = 5;     // per-direction constants (DirVals)
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTeamStats = 19;  // stats.TEAM_STAT_FIELDS
constexpr int kPoints = 17;     // its "points" column
constexpr int kPlayerStats = 6; // stats.N_PLAYER_STATS
constexpr int kRoles = 3;       // QB, rusher, target: pstats' role axis
}  // namespace

// One axis of _seg_bin (ops/table_lookup.py): segment k maps v to
// base[k] + clamp(rint((v - start[k]) * inv_step[k]), 0, top[k]) where v >
// enter[k].  enter[0] is -inf; segments past the profile's have enter = +inf.
struct Segs {
  float enter[kSegs];
  float start[kSegs];
  float inv_step[kSegs];
  float top[kSegs];
  int base[kSegs];
};

// Field for field as NanoConsts in ops/game.py (the launcher checks the
// size).  Outside the anonymous namespace: the extern "C" launcher takes it.
struct NanoConsts {
  // analytic.go_for_it_prob: edges padded with +inf, the (ytg, dist) grid
  float go_ytg_edges[kSlots];
  float go_dist_edges[kSlots];
  float go_grid[kGridCells];
  int go_row;
  int go_cells;
  int late_seconds;
  float late_leading_scale, late_trailing_long_fg_ytg, late_trailing_go_long,
      late_trailing_go_short, go_multiplier;
  // analytic.field_goal_prob: bounds padded with -inf
  float fg_bounds[kSlots];
  float fg_probs[kSlots];
  float fg_long_prob, fg_snap_plus_endzone, fg_attempt_max_ytg;
  // the punt
  float punt_gross_mean, punt_gross_sd, punt_gross_min, punt_return_mean, punt_return_sd,
      punt_tb_gate_ytg, punt_tb_lo, punt_tb_hi, punt_tb_own_spot, punt_net_min;
  // the analytic stage 2 and its nudge
  float s2_inc, s2_int, s2_sck, stage2_int_scale, stage2_int_add, stage2_sack_scale;
  // analytic.pass_prob_v1
  float heuristic_clip_lo, heuristic_clip_hi;
  int half_seconds;
  // yards
  float pass_clip_lo, rush_clip_lo, sack_clip_lo, sack_clip_hi, int_return_mean,
      int_return_sd, pass_sigma_floor;
  int taper_enabled, rz_pass_damping, enable_fumbles;
  float pass_taper[5];   // t1, t2, r1, r2, t1 + (t2 - t1) * r1 (in double, then f32)
  float rush_taper[5];
  // explosive plays: the gate, explosive_prob's bonuses and clip, and per
  // branch the scale, the boost's low end and span, and the z factor
  float explosive_gate_ytg, explosive_bonus_60, explosive_bonus_40, explosive_lo,
      explosive_hi;
  float explosive_pass[4];
  float explosive_run[4];
  // red-zone finishes: gate, base, slope, down bonus, lo, hi
  float rz_pass[6];
  float rz_run[6];
  // f32 reciprocals of 7, 10, 15, 60
  float r7, r10, r15, r60;
  // the clock: seconds charged by outcome, as f32 (truncated like .to(I32))
  float t_field_goal, t_punt, t_td_pass, t_pass_complete, t_pass_incomplete, t_sack,
      t_interception, t_run;
  int quarter_seconds;
  float kickoff_spot;
  int td_points, fg_points;
  // the nano table: profile segments, (ny, ns) of a row's cell, nsd, c, the
  // row's floats, rows a direction; whether stage-2 and fumble channels exist
  Segs dist, ytg, sec, sd;
  int ny, ns, nsd, c, cols, per_dir;
  int has_s2, has_fumble;
  // plays a game at most: whole play chunks covering max_plays
  int cap;
};

namespace {

// draw slots (ops/game.py U_*, N_*)
constexpr int U_GO = 0, U_FG = 1, U_TB = 2, U_CALL = 3, U_QB = 4, U_WR = 5, U_RB = 6,
              U_COMPLETE = 7, U_EXP = 8, U_BOOST = 9, U_RZ = 10, U_S2 = 11, U_FUM = 12;
constexpr int N_PUNT_GROSS = 0, N_PUNT_RET = 1, N_YARDS = 2, N_INT_RET = 3;

struct Game {
  int off, sec, down, period, sa, sb;
  float dist, ytg;
  bool in_rz;
  int gid;
};

// one direction's constants, DirVals order of ops/game.pack_nano_game
struct DirVals {
  float ymult, mz, tilt_pass, tilt_run, exp_base;
};

struct InPtrs {
  const int* gid;
  const int* off;
  const int* sec;
  const int* down;
  const float* dist;
  const float* ytg;
  const int* period;
  const bool* in_rz;
  const bool* going;
  const int* score;   // (n, 2)
};

// the launch's optional counts (null: not counted)
struct Counters {
  unsigned long long* plays;   // plays of every game
  unsigned long long* iters;   // loop trips of every warp
  int* game_plays;             // plays of each game
};

struct OutPtrs {
  int* off;
  int* sec;
  int* down;
  float* dist;
  float* ytg;
  int* period;
  bool* in_rz;
  bool* going;
  int* score;
};

// The collectors' tensors, read and written in place (null where off).
// cum and tracked hold the pack's per-direction slot tables of the three
// roles in pstats' role order (QB: qb_cum, rusher: rb_cum, target: wr_cum),
// each (2 x n_matchups, k).
struct Accrual {
  float* stats;         // (n, 2, kTeamStats)
  float* pstats;        // (n, 2, kRoles, k, kPlayerStats)
  const float* cum;     // (kRoles, 2 x n_matchups, k) cumulative shares
  const bool* tracked;  // (kRoles, 2 x n_matchups, k)
  int k;
  int dirs;             // 2 x n_matchups
};

// torch.clamp(x, lo, hi): hi where lo > hi
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// What seg_bin reads of a segment once it is chosen, in shared memory
// (indexed by the lane's segment).
struct SegVals {
  float start[kSegs];
  float inv_step[kSegs];
  float top[kSegs];
  int base[kSegs];
};

// ops/table_lookup._seg_bin for one value: the last segment k with v >
// enter[k] bins it.  enter rises along the segments (ops/game._segs checks)
// and enter[0] is -inf, so the segments v enters are 0 .. k: k counts the
// boundaries v is past, and only segment k is evaluated.  (A NaN enters
// none and bins to 0, as segment 0 gives it: base[0] = 0.)
__device__ __forceinline__ int seg_bin(const Segs& g, const SegVals& s, float v) {
  int k = 0;
#pragma unroll
  for (int b = 1; b < kSegs; ++b) k += v > g.enter[b] ? 1 : 0;
  const float local = clip(rintf((v - s.start[k]) * s.inv_step[k]), 0.0f, s.top[k]);
  return static_cast<int>(local) + s.base[k];
}

// analytic.go_for_it_prob; `grid` is NanoConsts::go_grid in shared memory
__device__ __forceinline__ float go_for_it_prob(const NanoConsts& c, const float* grid,
                                                float ytg, float dist, int sd, int sec) {
  int yi = 0, di = 0;   // torch.bucketize(right=False): the edges below x
#pragma unroll
  for (int k = 0; k < kSlots; ++k) yi += ytg > c.go_ytg_edges[k];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) di += dist > c.go_dist_edges[k];
  float p = grid[yi * c.go_row + di];
  const bool late = sec < c.late_seconds;
  p = late && sd > 0 ? p * c.late_leading_scale : p;
  p = late && sd < 0 ? (ytg > c.late_trailing_long_fg_ytg ? c.late_trailing_go_long
                                                           : c.late_trailing_go_short)
                     : p;
  return clip(p, 0.0f, 1.0f);
}

// analytic.field_goal_prob: the first curve point the attempt is under
__device__ __forceinline__ float field_goal_prob(const NanoConsts& c, float attempt) {
  float p = c.fg_long_prob;
#pragma unroll
  for (int k = kSlots - 1; k >= 0; --k) p = attempt < c.fg_bounds[k] ? c.fg_probs[k] : p;
  return p;
}

// analytic.pass_prob_v1
__device__ __forceinline__ float pass_prob_v1(const NanoConsts& c, int down, float dist,
                                              float ytg, int sec, int sd) {
  float base = 0.53f + (down == 1 ? 0.02f + 0.010f * fmaxf(dist - 10.0f, 0.0f) * c.r10 : 0.0f);
  base = base + (down == 2 ? 0.12f + 0.020f * fmaxf(dist - 7.0f, 0.0f) * c.r10 : 0.0f);
  base = base + (down == 3 ? 0.28f + 0.030f * fmaxf(dist - 5.0f, 0.0f) * c.r10 : 0.0f);
  base = base + (down == 4 ? 0.45f + 0.035f * fmaxf(dist - 3.0f, 0.0f) * c.r10 : 0.0f);
  base = base - (ytg <= 10.0f ? 0.05f : 0.0f);
  base = base - (ytg <= 5.0f ? 0.03f : 0.0f);
  // Python's % (sec > 0 on every play K1 runs, so C's % agrees)
  const bool two_min = (sec % c.half_seconds) <= 120;
  base = base + (two_min && sd < 0 ? 0.22f : 0.0f);
  base = base + (sec < 600 && sd < 0 ? 0.06f : 0.0f);
  return clip(base, c.heuristic_clip_lo, c.heuristic_clip_hi);
}

// analytic.explosive_prob with the direction's base
__device__ __forceinline__ float explosive_prob(const NanoConsts& c, float ytg, float base) {
  base = base + (ytg > 60.0f ? c.explosive_bonus_60 : 0.0f);
  base = base + (ytg > 40.0f ? c.explosive_bonus_40 : 0.0f);
  return clip(base, c.explosive_lo, c.explosive_hi);
}

// analytic.rz_finish_prob_pass / _run: m = (gate, base, slope, down bonus,
// lo, hi), the direction's tilt
__device__ __forceinline__ float rz_finish_prob(const NanoConsts& c, const float* m, float ytg,
                                                int down, float tilt) {
  float base = m[1] + m[2] * fmaxf(7.0f - ytg, 0.0f) * c.r7;
  base = base + m[3] * static_cast<float>(max(4 - down, 0));
  return clip(base + tilt, m[4], m[5]);
}

// analytic.stage2_fallback_probs then stage2_nudge: (P(inc), P(inc) + P(sack))
__device__ __forceinline__ void stage2_fallback(const NanoConsts& c, int down, float dist,
                                                float* cum0, float* cum1) {
  const float long_d = fmaxf(dist - 7.0f, 0.0f) * c.r10;
  float p_sck = c.s2_sck * (1.0f + 0.25f * (static_cast<float>(down) >= 3.0f ? 1.0f : 0.0f)
                            + 0.15f * long_d);
  float p_int = c.s2_int * (1.0f + 0.10f * long_d);
  float p_inc = c.s2_inc;
  float s = p_inc + p_int + p_sck;
  p_inc = p_inc / s;
  p_int = p_int / s;
  p_sck = p_sck / s;
  p_inc = fmaxf(p_inc, 0.0f);
  p_int = fmaxf(p_int, 0.0f) * c.stage2_int_scale + c.stage2_int_add;
  p_sck = fmaxf(p_sck, 0.0f) * c.stage2_sack_scale;
  s = p_inc + p_int + p_sck;
  s = s == 0.0f ? 1.0f : s;
  const float inc = p_inc / s;
  *cum0 = inc;
  *cum1 = inc + p_sck / s;
}

// game._taper: t = (t1, t2, r1, r2, t1 + (t2 - t1) * r1)
__device__ __forceinline__ float taper(float y, const float* t) {
  const float mid = t[0] + (y - t[0]) * t[2];
  const float hi = t[4] + (y - t[1]) * t[3];
  return y <= t[0] ? y : (y <= t[1] ? mid : hi);
}

// The nano row a play of state `s` reads: its direction's row at the
// state's (dist, ytg, sec) cell, at the (down, sd) block (ops/table_lookup.
// _nano_eval's index, binned by _seg_bin's segment arithmetic).
__device__ __forceinline__ const float* row_of(const NanoConsts& c, const SegVals* sv,
                                               const float* __restrict__ table, const Game& s) {
  const int sd = (s.sa - s.sb) * (1 - 2 * s.off);
  const int di = seg_bin(c.dist, sv[0], s.dist);
  const int yi = seg_bin(c.ytg, sv[1], s.ytg);
  const int si = seg_bin(c.sec, sv[2], static_cast<float>(s.sec));
  const int dirx = s.gid * 2 + s.off;
  int blk = min(max(s.down - 1, 0), 4) * c.nsd;
  if (c.nsd > 1) blk += seg_bin(c.sd, sv[3], static_cast<float>(sd));
  return table + (static_cast<long long>(dirx) * c.per_dir + (di * c.ny + yi) * c.ns + si) * c.cols
         + blk * c.c;
}

// One play's nano channels: the 7 always there, stage 2's cumulative pair
// and the fumble probability where the table has them (else the analytic
// stage 2 and no fumble, filled in by `play`).
struct Row {
  float p_c, pass_mu, pass_sg, rush_mu, rush_sg, sack_mu, sack_sg, s2c0, s2c1, p_f;
};

__device__ __forceinline__ Row load_row(const NanoConsts& c, const float* h) {
  Row r;
  r.p_c = __ldg(h);
  r.pass_mu = __ldg(h + 1);
  r.pass_sg = __ldg(h + 2);
  r.rush_mu = __ldg(h + 3);
  r.rush_sg = __ldg(h + 4);
  r.sack_mu = __ldg(h + 5);
  r.sack_sg = __ldg(h + 6);
  r.s2c0 = c.has_s2 ? __ldg(h + 7) : 0.0f;
  r.s2c1 = c.has_s2 ? __ldg(h + 8) : 0.0f;
  r.p_f = c.has_fumble ? __ldg(h + (c.has_s2 ? 9 : 7)) : 0.0f;
  return r;
}

// game._sample_slot for one game: the shares of direction `dirx` that u is
// at or past, at most k - 1; one slot reads no share.
__device__ __forceinline__ int sample_slot(const float* __restrict__ cum, int k, int dirx,
                                           float u) {
  if (k == 1) return 0;
  const float* row = cum + static_cast<long long>(dirx) * k;
  int slot = 0;
  for (int j = 0; j < k; ++j) slot += u >= __ldg(row + j) ? 1 : 0;
  return min(slot, k - 1);
}

// A play's sampled slot of each role, in pstats' role order (QB: U_QB,
// rusher: U_RB, target: U_WR), or -1 where that slot is not tracked, and
// the tracked slots' rows of game i's pstats as they were before the play.
struct Slots {
  int slot[kRoles];
  float2 row[kRoles][kPlayerStats / 2];
};

// The three roles' slots of a play of game i by direction `dirx` and
// offense `off`, sampled ahead of the play, and their rows read: the
// shares', flags' and rows' loads are then under the play's latency, and no
// lane waits on them behind a branch of the roles its play involves.  A
// play adds to at most these rows, so they are read as the play starts.
__device__ __forceinline__ Slots sample_slots(const Accrual& a, int dirx, const float* u,
                                              long long i, int off) {
  const float draw[kRoles] = {u[U_QB], u[U_RB], u[U_WR]};
  Slots s;
#pragma unroll
  for (int r = 0; r < kRoles; ++r) {
    const long long dir_row = static_cast<long long>(r) * a.dirs + dirx;
    const int slot = sample_slot(a.cum + static_cast<long long>(r) * a.dirs * a.k, a.k, dirx,
                                 draw[r]);
    s.slot[r] = a.tracked[dir_row * a.k + slot] ? slot : -1;
    if (s.slot[r] >= 0) {
      const float2* cell = reinterpret_cast<const float2*>(
          a.pstats + (((i * 2 + off) * kRoles + r) * a.k + slot) * kPlayerStats);
#pragma unroll
      for (int q = 0; q < kPlayerStats / 2; ++q) s.row[r][q] = cell[q];
    }
  }
  return s;
}

// One role's row of play_step's player deltas added to the sampled slot's
// row `pre` (as `sample_slots` read it) and written back, where that slot
// is tracked (slot >= 0; the eager step's gate of 0 adds +-0.0 elsewhere,
// which leaves the cell as it is).
__device__ __forceinline__ void add_player_row(const Accrual& a, int role, long long i, int off,
                                               int slot, const float (&v)[kPlayerStats],
                                               const float2 (&pre)[kPlayerStats / 2]) {
  if (slot < 0) return;
  // 8-byte loads and stores (a row is 24 bytes, pstats 8-byte aligned): a
  // warp's rows are 32 scattered addresses, so each access instruction
  // costs the load-store unit a pass per row
  float2* cell = reinterpret_cast<float2*>(
      a.pstats + (((i * 2 + off) * kRoles + role) * a.k + slot) * kPlayerStats);
#pragma unroll
  for (int q = 0; q < kPlayerStats / 2; ++q) {
    const float2 x = pre[q];
    cell[q] = make_float2(x.x + v[2 * q], x.y + v[2 * q + 1]);
  }
}

// One play of an active game (sec > 0): game.play_step with the nano heads,
// on the row `row_of` gave for this state.  With kStats the play's 19 team
// stats (less `points`, written when the game ends) are added to the
// offense's side of the lane's stripe `team` (column q of side o at
// (o * kTeamStats + q) * kThreads); with kPlayers each role the play
// involves (QB and target on a pass play, rusher on a run: the roles whose
// eager delta is not all +0.0) adds its row to game i's pstats.
template <bool kStats, bool kPlayers>
__device__ __forceinline__ void play(const NanoConsts& c, const float* grid, const Row& r,
                                     const DirVals& d0, const DirVals& d1, Game& s,
                                     const float* u, const float* n, float* team,
                                     const Accrual& acc, const Slots& sl, long long i) {
  const int off = s.off, down0 = s.down, sec0 = s.sec;
  const float dist0 = s.dist, ytg0 = s.ytg;
  const int sd = (s.sa - s.sb) * (1 - 2 * off);
  // selected by value: a reference to one of two register structs would
  // put both in local memory
  const bool a = off == 0;
  const DirVals d{a ? d0.ymult : d1.ymult, a ? d0.mz : d1.mz, a ? d0.tilt_pass : d1.tilt_pass,
                  a ? d0.tilt_run : d1.tilt_run, a ? d0.exp_base : d1.exp_base};

  // ---- 4th-down decision
  const float p_go = fminf(go_for_it_prob(c, grid, ytg0, dist0, sd, sec0) * c.go_multiplier, 1.0f);
  const bool is4 = down0 == 4;
  const bool go = is4 && u[U_GO] < p_go;
  const bool st_play = is4 && !go;
  const bool fg_att = st_play && ytg0 <= c.fg_attempt_max_ytg;
  const bool punt = st_play && !fg_att;
  const bool scrim = !st_play;

  // FG
  const float p_fg = field_goal_prob(c, ytg0 + c.fg_snap_plus_endzone);
  const bool fg_good = fg_att && u[U_FG] < p_fg;
  const bool fg_miss = fg_att && !fg_good;

  // punt
  const float gross = fmaxf(c.punt_gross_mean + c.punt_gross_sd * n[N_PUNT_GROSS], c.punt_gross_min);
  const float pret = fmaxf(c.punt_return_mean + c.punt_return_sd * n[N_PUNT_RET], 0.0f);
  float net = gross - pret;
  const float tb_p = clip((c.punt_tb_gate_ytg - ytg0) * c.r60, c.punt_tb_lo, c.punt_tb_hi);
  const bool tb = ytg0 <= c.punt_tb_gate_ytg && u[U_TB] < tb_p;
  net = tb ? ytg0 - c.punt_tb_own_spot : net;
  net = truncf(fminf(fmaxf(net, c.punt_net_min), ytg0 - 1.0f));
  const float punt_spot = clip(100.0f - (ytg0 - net), 1.0f, 99.0f);

  // ---- scrimmage play
  const bool trip1 = scrim && !s.in_rz && ytg0 <= 20.0f;

  // the nano heads
  const float p_c = r.p_c;
  float pass_mu = r.pass_mu, pass_sg = r.pass_sg;
  const float rush_mu = r.rush_mu, rush_sg = r.rush_sg;
  const float sack_mu = r.sack_mu, sack_sg = r.sack_sg;
  float s2c0 = r.s2c0, s2c1 = r.s2c1;
  if (!c.has_s2) stage2_fallback(c, down0, dist0, &s2c0, &s2c1);
  const float p_f = r.p_f;

  const float p_pass = pass_prob_v1(c, down0, dist0, ytg0, sec0, sd);
  const bool is_pass = scrim && u[U_CALL] < p_pass;
  const bool is_run = scrim && !is_pass;
  const bool complete = is_pass && u[U_COMPLETE] < p_c;
  const bool notc = is_pass && !complete;
  const float u2 = u[U_S2];
  const bool o_inc = notc && u2 < s2c0;
  const bool o_sck = notc && !o_inc && u2 < s2c1;
  const bool o_int = notc && !o_inc && !o_sck;

  // pass yards (quirk: clip to ytg before the SP+ multiplier)
  if (c.rz_pass_damping) {
    const float rz_scale = ytg0 < 15.0f ? 0.8f + 0.2f * (ytg0 * c.r15) : 1.0f;
    pass_mu = pass_mu * rz_scale;
    pass_sg = fmaxf(pass_sg * rz_scale, c.pass_sigma_floor);
  }
  float py_raw = pass_mu + pass_sg * n[N_YARDS];
  if (c.taper_enabled) py_raw = taper(py_raw, c.pass_taper);
  const float py = fminf(fmaxf(py_raw, c.pass_clip_lo), ytg0);
  float yards_p = py * d.ymult;
  const float ep = explosive_prob(c, ytg0, d.exp_base);
  const bool exp_gate_p = ytg0 > c.explosive_gate_ytg && u[U_EXP] < c.explosive_pass[0] * ep;
  const float boost_p = c.explosive_pass[1] + u[U_BOOST] * c.explosive_pass[2];
  yards_p = exp_gate_p
                ? fminf(yards_p * (1.0f + boost_p * (1.0f + c.explosive_pass[3] * d.mz)), ytg0)
                : yards_p;
  const bool rz_p = ytg0 <= c.rz_pass[0] && down0 <= 3
                    && u[U_RZ] < rz_finish_prob(c, c.rz_pass, ytg0, down0, d.tilt_pass);
  yards_p = rz_p ? ytg0 : yards_p;
  const bool pass_td = complete && yards_p + 1e-9f >= ytg0;
  const bool pass_gain = complete && !pass_td;

  // sack loss (quirk: capped at ytg)
  const float sy = clip(sack_mu + sack_sg * n[N_YARDS], c.sack_clip_lo, c.sack_clip_hi);
  const float loss = fminf(fmaxf(-sy, 0.0f), ytg0);

  // INT return
  const float ret = fminf(fmaxf(c.int_return_mean + c.int_return_sd * n[N_INT_RET], 0.0f), ytg0);
  const float int_spot = 100.0f - (ytg0 - ret);

  // rush yards
  float ry_raw = rush_mu + rush_sg * n[N_YARDS];
  if (c.taper_enabled) ry_raw = taper(ry_raw, c.rush_taper);
  const float ry = fminf(fmaxf(ry_raw, c.rush_clip_lo), ytg0);
  float yards_r = ry * d.ymult;
  const bool exp_gate_r = ytg0 > c.explosive_gate_ytg && u[U_EXP] < c.explosive_run[0] * ep;
  const float boost_r = c.explosive_run[1] + u[U_BOOST] * c.explosive_run[2];
  yards_r = exp_gate_r
                ? fminf(yards_r * (1.0f + boost_r * (1.0f + c.explosive_run[3] * d.mz)), ytg0)
                : yards_r;
  const bool rz_r = ytg0 <= c.rz_run[0] && down0 <= 3
                    && u[U_RZ] < rz_finish_prob(c, c.rz_run, ytg0, down0, d.tilt_run);
  yards_r = rz_r ? ytg0 : yards_r;

  const bool fum = c.enable_fumbles && is_run && u[U_FUM] < p_f;
  const bool run_active = is_run && !fum;
  const bool run_td = run_active && yards_r + 1e-9f >= ytg0;
  const bool run_gain = run_active && !run_td;
  const float fum_spot_ytg = fmaxf(ytg0 - fminf(fmaxf(yards_r, c.rush_clip_lo), ytg0), 0.0f);

  // ---- phase a: pre-tick state updates
  const bool adv = pass_gain || run_gain;
  const float gained = (pass_gain ? yards_p : 0.0f) + (run_gain ? yards_r : 0.0f);
  float ytg_a = adv ? fmaxf(ytg0 - gained, 0.0f) : ytg0;
  const bool first = adv && gained + 1e-6f >= dist0;
  int down_a = adv ? (first ? 1 : down0 + 1) : down0;
  float dist_a = adv ? (first ? 10.0f : dist0 - gained) : dist0;
  const bool downs_to = adv && !first && down_a > 4;
  ytg_a = o_sck ? ytg0 + loss : ytg_a;
  dist_a = o_sck ? dist0 + loss : dist_a;
  down_a = o_sck ? down0 + 1 : down_a;
  down_a = o_inc ? down0 + 1 : down_a;
  const bool flip_a = downs_to || o_int || fum;
  const float spot_a = o_int ? int_spot : (fum ? 100.0f - fum_spot_ytg : 100.0f - ytg_a);
  const int off_a = flip_a ? 1 - off : off;
  ytg_a = flip_a ? spot_a : ytg_a;
  down_a = flip_a ? 1 : down_a;
  dist_a = flip_a ? 10.0f : dist_a;
  const bool in_rz_a = !flip_a && (s.in_rz || trip1);

  // ---- phase b: tick (+ halftime flip); the outcomes are exclusive, so
  // the eager sum of charge x outcome is the one charge
  const float tf = fg_att ? c.t_field_goal
                   : punt ? c.t_punt
                   : pass_td ? c.t_td_pass
                   : pass_gain ? c.t_pass_complete
                   : o_inc ? c.t_pass_incomplete
                   : o_sck ? c.t_sack
                   : o_int ? c.t_interception
                   : (run_td || run_gain || fum) ? c.t_run
                   : 0.0f;
  const int sec_b = max(sec0 - static_cast<int>(tf), 0);
  // sec_b - 1 >= 0, so C's division is the floor division
  const int period_b = sec_b > 0 ? 4 - (sec_b - 1) / c.quarter_seconds : 4;
  const bool halftime = period_b != s.period && period_b == 3;
  const int off_b = halftime ? 1 - off_a : off_a;
  const float ytg_b = halftime ? c.kickoff_spot : ytg_a;
  const int down_b = halftime ? 1 : down_a;
  const float dist_b = halftime ? 10.0f : dist_a;
  const bool in_rz_b = !halftime && in_rz_a;

  // ---- phase c: post-tick possession flips
  const bool flip_c = fg_good || fg_miss || punt || pass_td || run_td;
  const float spot_c = fg_miss ? 100.0f - ytg0 : (punt ? punt_spot : c.kickoff_spot);
  const float ytg_c = flip_c ? spot_c : ytg_b;
  const bool in_rz_c = !flip_c && in_rz_b;
  // run-branch red-zone recheck (quirk: the old offense credited)
  const bool trip2 = run_gain && !in_rz_c && ytg_c <= 20.0f;

  if constexpr (kStats || kPlayers) {
    const float pass_yds = pass_td ? ytg0 : (pass_gain ? yards_p : 0.0f);
    const float rush_yds = run_td ? ytg0 : (run_gain ? yards_r : 0.0f);
    const float pass_att = complete || o_inc || o_int ? 1.0f : 0.0f;
    const auto f = [](bool b) { return b ? 1.0f : 0.0f; };
    if constexpr (kStats) {
      // going_for_it is true on the go play itself only
      const bool conv = go && (pass_td || run_td || (pass_gain && yards_p + 1e-6f >= dist0)
                               || (run_gain && yards_r + 1e-6f >= dist0));
      // TEAM_STAT_FIELDS order; rz_TD counts rushing TDs only (the quirk)
      const float v[kTeamStats] = {
          f(scrim),   pass_att,          f(complete), pass_yds, f(pass_td), f(o_int),
          f(o_sck),   f(is_run),         rush_yds,    f(run_td), f(fg_good), f(fg_att),
          f(punt),    f(trip1) + f(trip2), f(run_td && ytg0 <= 20.0f), f(go), f(conv), 0.0f,
          f(fum)};
      float* t = team + off * kTeamStats * kThreads;
#pragma unroll
      for (int q = 0; q < kTeamStats; ++q) {
        if (q != kPoints) t[q * kThreads] = t[q * kThreads] + v[q];
      }
    }
    if constexpr (kPlayers) {
      // columns att comp yds td INT sacks (stats.PC_*)
      if (is_pass) {
        const float qb[kPlayerStats] = {pass_att, f(complete), pass_yds, f(pass_td), f(o_int),
                                        f(o_sck)};
        const float wr[kPlayerStats] = {1.0f, f(complete), pass_yds, f(pass_td), 0.0f, 0.0f};
        add_player_row(acc, 0, i, off, sl.slot[0], qb, sl.row[0]);
        add_player_row(acc, 2, i, off, sl.slot[2], wr, sl.row[2]);
      } else if (is_run) {
        const float rb[kPlayerStats] = {1.0f, 0.0f, rush_yds, f(run_td), 0.0f, 0.0f};
        add_player_row(acc, 1, i, off, sl.slot[1], rb, sl.row[1]);
      }
    }
  }

  const int pts = (pass_td || run_td) * c.td_points + fg_good * c.fg_points;
  s.off = flip_c ? 1 - off_b : off_b;
  s.sec = sec_b;
  s.down = flip_c ? 1 : down_b;
  s.dist = flip_c ? 10.0f : dist_b;
  s.ytg = ytg_c;
  s.period = period_b;
  s.in_rz = in_rz_c || trip2;
  s.sa += off == 0 ? pts : 0;
  s.sb += off == 1 ? pts : 0;
}

// One lane's game: its index, state, draw row and plays so far.
struct Lane {
  long long i;        // the game; >= n: none
  Game s;
  DirVals d0, d1;
  bool going, live;   // live: plays are left (sec > 0, under the cap)
  int j;              // plays played, the absolute step of the next
  uint32_t row;
  bool mirror;
};

// Lane `g` takes game i: its state and its directions' constants read, and
// what the eager loop does before its first play (`run`: it plays at all);
// with kStats its incoming team stats into the lane's stripe `team`.
template <bool kStats>
__device__ __forceinline__ void start(Lane& g, long long i, const InPtrs& in,
                                      const float* __restrict__ dirs, int n_matchups, uint32_t r0,
                                      int anti, bool run, float* team, const Accrual& acc) {
  g.i = i;
  if constexpr (kStats) {
#pragma unroll
    for (int q = 0; q < 2 * kTeamStats; ++q) team[q * kThreads] = acc.stats[i * 2 * kTeamStats + q];
  }
  // gid clamped into the packed matchups: an out-of-range gid reads no
  // memory outside the inputs
  const int gid = min(max(in.gid[i], 0), n_matchups - 1);
  const float* dv = dirs + gid * 2 * kDirVals;
  g.d0 = DirVals{dv[0], dv[1], dv[2], dv[3], dv[4]};
  g.d1 = DirVals{dv[5], dv[6], dv[7], dv[8], dv[9]};
  g.s = Game{in.off[i], in.sec[i], in.down[i], in.period[i], in.score[2 * i],
             in.score[2 * i + 1], in.dist[i], in.ytg[i], in.in_rz[i]};
  g.s.gid = gid;
  g.going = in.going[i];
  g.j = 0;
  g.live = run && g.s.sec > 0;
  if (run && g.s.sec <= 0) {
    // the masked step of a finished game: sec clamped at 0, period 4
    g.s.sec = 0;
    g.s.period = 4;
  } else if (run) {
    g.going = false;
  }
  const uint32_t b = static_cast<uint32_t>(i);
  g.row = anti ? r0 + 2u * (b >> 2) + (b & 1u) : r0 + b;
  g.mirror = anti && (b & 3u) >= 2u;
}

// Lane `g`'s game written out; with kStats its stripe's team stats, the
// final score in `points` (as the eager loop writes it after its last play).
template <bool kStats>
__device__ __forceinline__ void finish(const Lane& g, const OutPtrs& out, const float* team,
                                       const Accrual& acc) {
  const long long i = g.i;
  if constexpr (kStats) {
#pragma unroll
    for (int q = 0; q < 2 * kTeamStats; ++q) {
      const float pts = static_cast<float>(q < kTeamStats ? g.s.sa : g.s.sb);
      acc.stats[i * 2 * kTeamStats + q] = q % kTeamStats == kPoints ? pts : team[q * kThreads];
    }
  }
  out.off[i] = g.s.off;
  out.sec[i] = g.s.sec;
  out.down[i] = g.s.down;
  out.dist[i] = g.s.dist;
  out.ytg[i] = g.s.ytg;
  out.period[i] = g.s.period;
  out.in_rz[i] = g.s.in_rz;
  out.going[i] = g.going;
  out.score[2 * i] = g.s.sa;
  out.score[2 * i + 1] = g.s.sb;
}

// The persistent grid: lane t of the launch's `lanes` takes game t, then,
// each time its game ends, the next game of the queue (work[0] counts the
// games handed out past the first lanes, one atomicAdd a warp for all its
// lanes whose games ended at that play).  work[1] counts the blocks done;
// the last resets both, so the next launch on the stream finds them 0.
// One instantiation a combination of the collectors; with kStats the block
// holds a stripe of 2 x kTeamStats floats a lane in dynamic shared memory.
template <bool kStats, bool kPlayers>
__global__ void __launch_bounds__(kThreads)
    nano_game_kernel(const NanoConsts c, const float* __restrict__ table,
                     const float* __restrict__ dirs, int n_matchups, const InPtrs in,
                     const OutPtrs out, uint32_t k0, uint32_t k1, uint32_t r0, int anti,
                     const bool* run_flag, unsigned int* work, const Counters cnt,
                     const Accrual acc, int n) {
  extern __shared__ float stripes[];
  float* const team = stripes + threadIdx.x;
  __shared__ float grid[kGridCells];
  __shared__ SegVals sv[4];          // dist, ytg, sec, sd
  __shared__ unsigned long long block_plays, block_iters;
  for (int k = threadIdx.x; k < c.go_cells; k += kThreads) grid[k] = c.go_grid[k];
  if (threadIdx.x == 0) {
    block_plays = 0;
    block_iters = 0;
#pragma unroll
    for (int k = 0; k < kSegs; ++k) {
      sv[0].start[k] = c.dist.start[k], sv[0].inv_step[k] = c.dist.inv_step[k];
      sv[0].top[k] = c.dist.top[k], sv[0].base[k] = c.dist.base[k];
      sv[1].start[k] = c.ytg.start[k], sv[1].inv_step[k] = c.ytg.inv_step[k];
      sv[1].top[k] = c.ytg.top[k], sv[1].base[k] = c.ytg.base[k];
      sv[2].start[k] = c.sec.start[k], sv[2].inv_step[k] = c.sec.inv_step[k];
      sv[2].top[k] = c.sec.top[k], sv[2].base[k] = c.sec.base[k];
      sv[3].start[k] = c.sd.start[k], sv[3].inv_step[k] = c.sd.inv_step[k];
      sv[3].top[k] = c.sd.top[k], sv[3].base[k] = c.sd.base[k];
    }
  }
  __syncthreads();
  const bool run = c.cap > 0 && (run_flag == nullptr || *run_flag);
  const unsigned lane = threadIdx.x & 31u;
  const long long lanes = static_cast<long long>(gridDim.x) * kThreads;
  Lane g;
  g.i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  g.live = false;
  if (g.i < n) start<kStats>(g, g.i, in, dirs, n_matchups, r0, anti, run, team, acc);
  bool open = lanes < n;             // the queue has games to hand out (warp-uniform)
  unsigned long long played = 0;     // plays of this lane's finished games
  unsigned int iters = 0;            // this warp's loop trips
  while (__any_sync(kFull, g.i < n)) {
    ++iters;
    if (g.live) {
      // the row's loads first, the draws under their latency, then the play
      const Row r = load_row(c, row_of(c, sv, table, g.s));
      float u[philox::kUniforms], z[philox::kNormals];
      philox::step_draws(k0, k1, static_cast<uint32_t>(g.j), g.row, u, z);
      if (g.mirror) {
#pragma unroll
        for (int k = 0; k < philox::kUniforms; ++k) u[k] = 1.0f - u[k];
#pragma unroll
        for (int k = 0; k < philox::kNormals; ++k) z[k] = -z[k];
      }
      Slots sl{};
      if constexpr (kPlayers) sl = sample_slots(acc, g.s.gid * 2 + g.s.off, u, g.i, g.s.off);
      play<kStats, kPlayers>(c, grid, r, g.d0, g.d1, g.s, u, z, team, acc, sl, g.i);
      ++g.j;
      g.live = g.s.sec > 0 && g.j < c.cap;
    }
    const bool done = g.i < n && !g.live;
    if (done) {
      finish<kStats>(g, out, team, acc);
      played += static_cast<unsigned long long>(g.j);
      if (cnt.game_plays != nullptr) cnt.game_plays[g.i] = g.j;
    }
    const unsigned m = __ballot_sync(kFull, done);
    if (m != 0u) {
      long long next = n;
      if (open) {
        const int leader = __ffs(static_cast<int>(m)) - 1;
        unsigned int base = 0;
        if (static_cast<int>(lane) == leader) base = atomicAdd(work, static_cast<unsigned int>(__popc(m)));
        base = __shfl_sync(kFull, base, leader);
        next = lanes + base;
        open = next + __popc(m) < n;
      }
      if (done) {
        g.i = next + __popc(m & ((1u << lane) - 1u));
        g.live = false;
        if (g.i < n) start<kStats>(g, g.i, in, dirs, n_matchups, r0, anti, run, team, acc);
      }
    }
  }
  if (cnt.plays != nullptr) atomicAdd(&block_plays, played);
  if (cnt.iters != nullptr && lane == 0) atomicAdd(&block_iters, static_cast<unsigned long long>(iters));
  __syncthreads();
  if (threadIdx.x == 0) {
    if (cnt.plays != nullptr) atomicAdd(cnt.plays, block_plays);
    if (cnt.iters != nullptr) atomicAdd(cnt.iters, block_iters);
    // every claim of this block has returned; the last block resets
    if (atomicAdd(&work[1], 1u) == gridDim.x - 1) {
      atomicExch(&work[0], 0u);
      atomicExch(&work[1], 0u);
    }
  }
}

using KernelFn = void (*)(NanoConsts, const float*, const float*, int, InPtrs, OutPtrs, uint32_t,
                         uint32_t, uint32_t, int, const bool*, unsigned int*, Counters, Accrual,
                         int);

// The instantiation of the collectors `stats` and `players`.
KernelFn kernel_of(bool stats, bool players) {
  if (stats) return players ? nano_game_kernel<true, true> : nano_game_kernel<true, false>;
  return players ? nano_game_kernel<false, true> : nano_game_kernel<false, false>;
}

// Its dynamic shared memory: the lanes' team-stat stripes.
size_t stripe_bytes(bool stats) { return stats ? 2 * kTeamStats * kThreads * sizeof(float) : 0; }

}  // namespace

extern "C" int nano_game_consts_size() { return static_cast<int>(sizeof(NanoConsts)); }

// Threads a block of K1.
extern "C" int nano_game_threads() { return kThreads; }

// Blocks of K1's instantiation for the collectors `stats` and `players`
// (0 or 1) that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current device), or
// minus the CUDA error.
extern "C" int nano_game_blocks_per_sm(int stats, int players) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel_of(stats, players), kThreads, stripe_bytes(stats));
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// The games of one launch to their end.  table: (rows, cols) f32; dirs:
// (2 * n_matchups, 5) f32; in: 10 device pointers (gid, off, sec, down,
// dist, ytg, period, in_rz, going, score), out: 9 (the same less gid), each
// a contiguous vector of n (score (n, 2)) of the GameState's dtype.  Game b
// draws row r0 + b, or r0 + 2 (b / 4) + b % 2 with `anti`.  run_flag: a
// device bool saying whether the eager loop runs a play at all, or null for
// yes.  work: 2 device uint32, 0 before the launch and left 0 after it
// (the stream's own: two launches in flight at once may not share them).
// plays, iters: device uint64s the games' plays and the warps' loop trips
// are added to, or null; game_plays: a device int32 vector of n given each
// game's plays, or null.  The collectors, each on where its tensor is
// given: stats, a contiguous (n, 2, 19) f32 tensor of the games' team
// stats, and pstats, a contiguous (n, 2, 3, k, 6) f32 tensor of their
// player stats, both added to in place; with pstats, cum and tracked, the
// (3, 2 x n_matchups, k) f32 cumulative shares and bool tracked flags of
// the QB, rusher and target slots.  `blocks` blocks of kThreads (at most
// the resident blocks, `nano_game_blocks_per_sm` of the instantiation x
// the SMs).  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int nano_game_launch(const NanoConsts* c, const void* table, const void* dirs,
                                int n_matchups, void* const* in, void* const* out, uint32_t k0,
                                uint32_t k1, uint32_t r0, int anti, const void* run_flag,
                                void* work, void* plays, void* iters, void* game_plays,
                                void* stats, void* pstats, const void* cum, const void* tracked,
                                int k, int n, int blocks, void* stream) {
  if (n <= 0) return 0;
  const InPtrs ip{static_cast<const int*>(in[0]),   static_cast<const int*>(in[1]),
                  static_cast<const int*>(in[2]),   static_cast<const int*>(in[3]),
                  static_cast<const float*>(in[4]), static_cast<const float*>(in[5]),
                  static_cast<const int*>(in[6]),   static_cast<const bool*>(in[7]),
                  static_cast<const bool*>(in[8]),  static_cast<const int*>(in[9])};
  const OutPtrs op{static_cast<int*>(out[0]),   static_cast<int*>(out[1]),
                   static_cast<int*>(out[2]),   static_cast<float*>(out[3]),
                   static_cast<float*>(out[4]), static_cast<int*>(out[5]),
                   static_cast<bool*>(out[6]),  static_cast<bool*>(out[7]),
                   static_cast<int*>(out[8])};
  const Counters cnt{static_cast<unsigned long long*>(plays),
                     static_cast<unsigned long long*>(iters), static_cast<int*>(game_plays)};
  const Accrual acc{static_cast<float*>(stats), static_cast<float*>(pstats),
                    static_cast<const float*>(cum), static_cast<const bool*>(tracked), k,
                    2 * n_matchups};
  const bool with_stats = stats != nullptr, with_players = pstats != nullptr;
  kernel_of(with_stats, with_players)<<<blocks, kThreads, stripe_bytes(with_stats),
                                        static_cast<cudaStream_t>(stream)>>>(
      *c, static_cast<const float*>(table), static_cast<const float*>(dirs), n_matchups, ip,
      op, k0, k1, r0, anti, static_cast<const bool*>(run_flag),
      static_cast<unsigned int*>(work), cnt, acc, n);
  return static_cast<int>(cudaGetLastError());
}
