// K1: a whole launch of nano-table games, score-only, in one kernel launch.
//
// Replaces the compiled game loop of the JAX package (XLA on the TPU, not a
// Pallas kernel): fast_monte_carlo_tpu/ops/game.py:844 simulate_games (its
// while_loop over chunks of a scan over :337 play_step, the draws made
// inside it) with the nano table heads of
// fast_monte_carlo_tpu/ops/table_lookup.py:661 _nano_eval, for score-only
// games (no box score, no player stats).  Its plain version is
// ops/game.nano_game_plain; the eager loop it stands in for on the card is
// ops/game.simulate_games_eager.
//
// One thread per game.  The state (off, sec, down, dist, ytg, period, in_rz,
// going, score) stays in registers from the starting state to the game's
// end; gid and the game's two directions' constants are read once.  The
// thread plays until sec == 0 or the eager loop's cap, whole chunks of
// play_chunk plays (360 at the defaults).  A game that has ended is a fixed
// point of the masked eager step (sec 0, period 4, nothing else moves), so
// stopping it early leaves the state the eager loop leaves; a game that
// starts with sec <= 0 gets the one masked step's sec = 0, period = 4 where
// the eager loop runs a play at all (`run_flag`: some game active, or
// early_exit off).
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
// there are none); phases a-c, the halftime flip and the score.  The slot
// draws (QB, target, rusher) are drawn and not sampled: no nano head and no
// score reads a slot, so the eager step's slot indices are dead on this
// path.  The file is compiled with --fmad=false (utils/cuda_build.py) and
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
// SASS in chip_smoke.NANO_COUNTS), so K1 is bound by issue.  The nano table of one matchup stays in the 50 MB L2; a
// 60-matchup slate's 413 MB does not, and a play's 28-40 bytes are then a
// sector-sized read from HBM.
//
// Design: 128 threads a block, no register cap (__launch_bounds__ only sets
// the block size): a 65,536-game launch is 512 blocks, all resident at once
// on 132 SMs, so the occupancy is the games' and not the registers'.  The
// go-for-it grid, indexed per lane, sits in shared memory; the searches
// over the padded edges, FG points and segments unroll into compares
// against kernel-parameter constants.  Games in a warp end at different
// plays: a warp runs until its longest game ends, its finished lanes idle,
// which costs the spread of game lengths within a warp.  Each thread adds its plays to a block
// count in shared memory and one thread a block adds that to `plays`, when
// given: what the measurement's bound counts.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {
constexpr int kSlots = 8;       // go-for-it edges an axis, FG points
constexpr int kSegs = 8;        // segments an axis of the nano profile
constexpr int kGridCells = 81;  // (8 + 1) x (8 + 1) go-for-it cells
constexpr int kDirVals = 5;     // per-direction constants (DirVals)
constexpr int kThreads = 128;
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
constexpr int U_GO = 0, U_FG = 1, U_TB = 2, U_CALL = 3, U_COMPLETE = 7, U_EXP = 8,
              U_BOOST = 9, U_RZ = 10, U_S2 = 11, U_FUM = 12;
constexpr int N_PUNT_GROSS = 0, N_PUNT_RET = 1, N_YARDS = 2, N_INT_RET = 3;

struct Game {
  int off, sec, down, period, sa, sb;
  float dist, ytg;
  bool in_rz;
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

// torch.clamp(x, lo, hi): hi where lo > hi
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// ops/table_lookup._seg_bin for one value
__device__ __forceinline__ int seg_bin(const Segs& g, float v) {
  int idx = 0;
#pragma unroll
  for (int k = 0; k < kSegs; ++k) {
    const float local = clip(rintf((v - g.start[k]) * g.inv_step[k]), 0.0f, g.top[k]);
    idx = v > g.enter[k] ? static_cast<int>(local) + g.base[k] : idx;
  }
  return idx;
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

// One play of an active game (sec > 0): game.play_step with the nano heads,
// score-only.  `row` is the game's nano table at its direction's first row
// less the direction's offset (table + gid * 2 * per_dir * cols).
__device__ __forceinline__ void play(const NanoConsts& c, const float* grid,
                                     const float* __restrict__ table, int gid, const DirVals& d0,
                                     const DirVals& d1, Game& s, const float* u,
                                     const float* n) {
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

  // the nano heads: bin the state, read the (down, sd) block of one row
  const int di = seg_bin(c.dist, dist0);
  const int yi = seg_bin(c.ytg, ytg0);
  const int si = seg_bin(c.sec, static_cast<float>(sec0));
  const int dirx = gid * 2 + off;
  int blk = min(max(down0 - 1, 0), 4) * c.nsd;
  if (c.nsd > 1) blk += seg_bin(c.sd, static_cast<float>(sd));
  const float* h = table
                   + (static_cast<long long>(dirx) * c.per_dir + (di * c.ny + yi) * c.ns + si)
                         * c.cols
                   + blk * c.c;
  const float p_c = __ldg(h);
  float pass_mu = __ldg(h + 1), pass_sg = __ldg(h + 2);
  const float rush_mu = __ldg(h + 3), rush_sg = __ldg(h + 4);
  const float sack_mu = __ldg(h + 5), sack_sg = __ldg(h + 6);
  float s2c0, s2c1;
  if (c.has_s2) {
    s2c0 = __ldg(h + 7);
    s2c1 = __ldg(h + 8);
  } else {
    stage2_fallback(c, down0, dist0, &s2c0, &s2c1);
  }
  const float p_f = c.has_fumble ? __ldg(h + (c.has_s2 ? 9 : 7)) : 0.0f;

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

__global__ void __launch_bounds__(kThreads)
    nano_game_kernel(const NanoConsts c, const float* __restrict__ table,
                     const float* __restrict__ dirs, int n_matchups, const InPtrs in,
                     const OutPtrs out, uint32_t k0, uint32_t k1, uint32_t r0, int anti,
                     const bool* run_flag, unsigned long long* plays, int n) {
  __shared__ float grid[kGridCells];
  __shared__ unsigned int block_plays;
  for (int k = threadIdx.x; k < c.go_cells; k += kThreads) grid[k] = c.go_grid[k];
  if (threadIdx.x == 0) block_plays = 0;
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) {
    // gid clamped into the packed matchups: an out-of-range gid reads no
    // memory outside the inputs
    const int gid = min(max(in.gid[i], 0), n_matchups - 1);
    const float* dv = dirs + gid * 2 * kDirVals;
    const DirVals d0{dv[0], dv[1], dv[2], dv[3], dv[4]};
    const DirVals d1{dv[5], dv[6], dv[7], dv[8], dv[9]};
    Game s{in.off[i], in.sec[i], in.down[i], in.period[i], in.score[2 * i],
           in.score[2 * i + 1], in.dist[i], in.ytg[i], in.in_rz[i]};
    bool going = in.going[i];
    int played = 0;
    const bool run = c.cap > 0 && (run_flag == nullptr || *run_flag);
    if (run && s.sec <= 0) {
      // the masked step of a finished game: sec clamped at 0, period 4
      s.sec = 0;
      s.period = 4;
    } else if (run) {
      going = false;
      const uint32_t row = anti ? r0 + 2u * (static_cast<uint32_t>(i) >> 2) + (i & 1)
                                : r0 + static_cast<uint32_t>(i);
      const bool mirror = anti && (i & 3) >= 2;
      for (int j = 0; j < c.cap && s.sec > 0; ++j) {
        float u[philox::kUniforms], z[philox::kNormals];
        philox::step_draws(k0, k1, static_cast<uint32_t>(j), row, u, z);
        if (mirror) {
#pragma unroll
          for (int k = 0; k < philox::kUniforms; ++k) u[k] = 1.0f - u[k];
#pragma unroll
          for (int k = 0; k < philox::kNormals; ++k) z[k] = -z[k];
        }
        play(c, grid, table, gid, d0, d1, s, u, z);
        ++played;
      }
    }
    out.off[i] = s.off;
    out.sec[i] = s.sec;
    out.down[i] = s.down;
    out.dist[i] = s.dist;
    out.ytg[i] = s.ytg;
    out.period[i] = s.period;
    out.in_rz[i] = s.in_rz;
    out.going[i] = going;
    out.score[2 * i] = s.sa;
    out.score[2 * i + 1] = s.sb;
    if (plays != nullptr) atomicAdd(&block_plays, static_cast<unsigned int>(played));
  }
  if (plays != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0) atomicAdd(plays, static_cast<unsigned long long>(block_plays));
  }
}

}  // namespace

extern "C" int nano_game_consts_size() { return static_cast<int>(sizeof(NanoConsts)); }

// The games of one launch to their end.  table: (rows, cols) f32; dirs:
// (2 * n_matchups, 5) f32; in: 10 device pointers (gid, off, sec, down,
// dist, ytg, period, in_rz, going, score), out: 9 (the same less gid), each
// a contiguous vector of n (score (n, 2)) of the GameState's dtype.  Game b
// draws row r0 + b, or r0 + 2 (b / 4) + b % 2 with `anti`.  run_flag: a
// device bool saying whether the eager loop runs a play at all, or null for
// yes; plays: a device uint64 the plays are added to, or null.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int nano_game_launch(const NanoConsts* c, const void* table, const void* dirs,
                                int n_matchups, void* const* in, void* const* out, uint32_t k0,
                                uint32_t k1, uint32_t r0, int anti, const void* run_flag,
                                void* plays, int n, void* stream) {
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
  nano_game_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      *c, static_cast<const float*>(table), static_cast<const float*>(dirs), n_matchups, ip,
      op, k0, k1, r0, anti, static_cast<const bool*>(run_flag),
      static_cast<unsigned long long*>(plays), n);
  return static_cast<int>(cudaGetLastError());
}
