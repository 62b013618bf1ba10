// K1: a whole launch of table-mode games in one kernel launch, score-only or
// with the box score, the player stats or both, on any table layout.
//
// Replaces the compiled game loop of the JAX package (XLA on the TPU, not a
// Pallas kernel): fast_monte_carlo_tpu/ops/game.py:844 simulate_games (its
// while_loop over chunks of a scan over :337 play_step, the draws made
// inside it) with the table heads of fast_monte_carlo_tpu/ops/
// table_lookup.py (:661 _nano_eval, :644 _fused_eval with :607
// _unpack_head_row, the per-head lookups :540-605 and the play-policy
// lookup :588-597, :627-639), the forced first play of the 4th-down
// evaluator (game.py:392-415 under fast_monte_carlo_tpu/api.py:478-500
// _forced_live_moments_jit), and its collectors: :309 _sample_slot, the
// team box score (:586-620) and the player stats (:622-653).  Its plain
// version is ops/game.nano_game_plain; the eager loop it stands in for on
// the card is ops/game.simulate_games_eager.
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
// the pass, sack, INT and run branches with their quirks; the heads' lookup;
// phases a-c, the halftime flip and the score.  The file is compiled with
// --fmad=false (utils/cuda_build.py) and writes every literal as f32, so
// each multiply and add rounds on its own as the eager step's one torch
// kernel a operation does.  What the eager step computes per direction only
// (the explosive base, the two red-zone tanh tilts, the SP+ yard multiplier
// and mismatch z) comes in per direction, computed on the device by the
// same torch expressions (ops/game.pack_nano_game), so this kernel never
// evaluates tanhf.  The SimConfig constants, the padded go-for-it edges and
// grid, the FG curve and the segments come in NanoConsts and LayoutConsts,
// built on the host from the config and the tables.
//
// The layouts, one template instantiation each (kLayout) for each
// combination of the collectors:
// - kLayoutNano, the nano table with no play-policy lookup and no forced
//   play (the instantiations the nano path had alone, compiled as before): dist,
//   ytg, sec and score diff binned by _seg_bin's segment arithmetic, then
//   the c floats of the state's (down, sd) block of one row, unpacked with
//   or without stage-2 and fumble channels (the analytic stage 2 where
//   there are none).  No nano head reads a player slot, so the slot draws
//   (QB, target, rusher) are sampled only by the instantiation with the
//   player stats, and there only for the roles the play involves.
// - kLayoutRow, one row a play by strides (LayoutConsts): the fused layout
//   (the row at (down, dist, ytg, sec[, sd]) of the fused profile, clamped
//   into the table as jnp.take's mode="clip"), or the nano layout where the
//   launch has the play-policy table or a forced play.
// - kLayoutHeads, the per-head tables of a focus roster: the state binned
//   on the fine and the coarse profile, the QB, target and rusher slots
//   sampled every play, and each head's block through its row map by slot
//   key (stage 1, the sack quantiles: QB; the rush quantiles and fumble:
//   rusher) or pair key (QB x target: the pass quantiles, and stage 2
//   where its table keys on pairs), each index clamped as _take's.
// - kLayoutRowBare, kLayoutRowPlay, kLayoutRowForced: kLayoutRow score-only
//   with neither the play table nor a forced first play (a fused or slate
//   launch, fourth.force on every play), with the play table, with a forced
//   first play: the launches the paths make past the nano layout
//   (ops/game.nano_kind picks; Opts says what each reads).
// In kLayoutRow and kLayoutHeads the play-policy table (the coach's P(pass)
// on the coarse profile's cell and the score diff's bin among 26 edges) and
// the forced 4th-down decision are branches uniform across the grid: the
// forced first play (force_first, on the forced stream fk0, fk1 at step 0
// of the game's draw row, outside the play cap, as the eager composition
// plays it), then the plays from step 0 of the launch key, each under
// force_every (the config's fourth.force, a uniform code in every layout
// past the nano one).  In the three score-only ones they are fixed at
// compile time.
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
// - The other layouts (held ms at 65,536 games on the same card, in turns
//   with the nano score-only launch at 0.630-0.632; probes/kernels.py
//   --games-only): the layout, the play table and the forced play are
//   template and uniform branches kept out of the kLayoutNano
//   instantiations, whose SASS is the same, instruction for instruction,
//   as before the other layouts came in.  The fused row 0.668-0.669; the
//   nano row with a play table 0.678; a forced go 0.295-0.296 (68.7 plays
//   a game).  Per-head (a focus roster's default-profile tables, about
//   620 MB, so each lookup is a sector from HBM): the slots' Philox block
//   drawn first and the lookups issued under the rest of the draws,
//   1.123-1.126 ms score-only and 1.877-1.878 with both collectors,
//   against 1.162-1.164 and 1.946-1.960 with the lookups after the draws
//   (103 registers against 109).
// - Where a play samples slots (the player stats; the per-head tables) it
//   draws the slots' Philox block first (philox::step_draws_given draws the
//   other four after it, none twice), samples the slots, issues the
//   per-head lookups and the tracked player rows together, then the other
//   draws under their latency.  With the player stats the launch's slot
//   shares and tracked flags are copied into shared memory past the stripe,
//   once a block (240 bytes a matchup at k = 8).  Held ms at 65,536 games,
//   in turns in one call (probes/kernels.py --games-only): props 1.123-1.129
//   before, 1.088-1.095 with the slots' block first, 1.077-1.080 with the
//   shares, flags and per-head row maps staged too; player stats alone
//   1.055-1.062, 0.991-0.997, 0.977-0.981; per-head score-only 1.119-1.126,
//   1.123-1.126, 1.118-1.127, where staging bought nothing, so the kept
//   design stages the shares and flags with the player stats alone (its
//   own times and every design's: PERF.md section 6, PR 24).
//   Tried and dropped, each slower in turns: the player rows in a workspace
//   interleaved by warp ([warp][side][role][slot][pair of stats][lane],
//   props 1.304-1.312) or by lane ([warp][side][role][slot][lane][pair],
//   1.261-1.263), copied in from pstats when a lane takes a game and back
//   when it ends; the next play's slots sampled ahead for both offenses
//   (props 1.323-1.326, per-head 1.499-1.500).
// - The one-row layouts (PR 25; held ms at 65,536 games on an NVIDIA H100
//   80GB HBM3 at 700 W, in turns with the earlier design in one call,
//   probes/kernels.py --games-only; PERF.md section 6): the score-only
//   launches take an instantiation whose play table and forced play are
//   fixed at compile time, so a fused launch compiles to nano's loop with
//   the row's strides (71 registers, 2,168 SASS instructions against the
//   general one-row instantiation's 90 and 2,920); the lane takes its
//   game's two directions' first rows, in the table and in the play table,
//   when it takes the game, and a play picks one by `off` and adds 32-bit
//   strides (no dependent load ahead of P(pass)); the play table's score
//   diff is binned by one load from a table of every integer's bin that the
//   block builds from the edges (`sd_bins`) in place of a 26-edge scan; the
//   forced play's stream and code are the lane's for its game's first play
//   only (kLayoutRowForced; one call site of `play`, not a second inlined
//   copy); past the nano layout the block's segment values are copied a
//   word a thread.  Fused 0.6325-0.6328 ms against 0.6640-0.6692; the play
//   table 0.5868-0.5875 against 0.6727-0.6777; a forced go 0.2761-0.2765
//   against 0.2914-0.2937; the 60-matchup fused slate launch 15.29-15.30 ms
//   against 17.23-17.39 (three blocks an SM at 71 registers, two at 90).
//   The per-head instantiations share the prologue and the play table's
//   bins: score-only 1.0864-1.0913 against 1.1172-1.1260, with both
//   collectors 1.8145-1.8179 against 1.7896-1.7946; a variant keeping the
//   earlier scan and step select for them traded the two (1.1135-1.1142
//   and 1.8051-1.8064, in turns with this design's 1.0901-1.0973 and
//   1.8254-1.8276), so it was not kept.
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
// the layouts (ops/game.LAYOUT_KINDS): the nano table, one row a play with
// the play table and the forced first play read from LayoutConsts, the
// per-head tables; and one row a play, score-only, with neither, with the
// play table, with a forced first play
constexpr int kLayoutNano = 0, kLayoutRow = 1, kLayoutHeads = 2, kLayoutRowBare = 3,
              kLayoutRowPlay = 4, kLayoutRowForced = 5;
constexpr int kHeadTables = 6;  // stage1, stage2, pq, rq, sq, fumble (game.HEAD_TABLES)
constexpr int kPlayEdges = 32;  // the play table's score-diff edges (26), padded
// the play table's score-diff bins, a table of the integer score diffs
// kPlaySdLo .. kPlaySdLo + kPlaySdBins - 1 (game.PLAY_SD_LO, PLAY_SD_BINS)
constexpr int kPlaySdLo = -128, kPlaySdBins = 256;
// fourth.force codes (game.FORCE_CODES)
constexpr int kForceGo = 1, kForceFg = 2;
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

// One per-head table (ops/table_lookup.DeviceTable): its (rows, cols)
// values, its flat row map, the profile its state cell is on (0 the first,
// NanoConsts' segments: fine; 1 the second, LayoutConsts': coarse), whether
// the cell folds the score diff in, and its key (0 the QB slot, 1 the
// rusher slot, 2 the QB x target pair).  values null: the table is absent.
struct HeadTable {
  const float* values;
  const int* row_map;
  int64_t rows;
  int map_len;
  int cols;
  int profile;
  int has_sd;
  int key;
};

// What the layouts past kLayoutNano read, field for field as LayoutConsts
// in ops/game.py (the launcher checks the size).  The pointers are filled
// by the wrapper at launch.
struct LayoutConsts {
  // fourth.force codes of the forced first play and of every other play
  // (0 none, 1 go, 2 fg, 3 punt), and the forced play's stream key
  int force_first, force_every;
  uint32_t fk0, fk1;
  // kLayoutRow: row dirx * per_dir + down_i * s_down + di * s_dist + yi * s_ytg
  // + si * s_sec + sdi * s_sd, clamped into [0, rows); its floats from
  // down_i * b_down + sdi * b_sd; sd1: the first profile bins the score diff
  int64_t rows;
  int s_down, s_dist, s_ytg, s_sec, s_sd, b_down, b_sd, sd1;
  // the first profile's dist axis (kLayoutHeads: fine), the second profile
  // (coarse: per-head tables on it and the play table) and whether it bins
  // the score diff
  int nd1;
  Segs dist2, ytg2, sec2, sd2;
  int nd2, ny2, ns2, nsd2, sd2_on;
  // the play-policy table: (rows, play_cols), each direction's first row,
  // play_nsd score-diff bins at the edges (padded with +inf)
  int has_play, play_nsd, play_cols;
  const float* play;
  const int64_t* play_base;
  int64_t play_rows;
  float play_edges[kPlayEdges];
  // kLayoutHeads: stage1, stage2, pq, rq, sq, fumble; the slots a direction
  // of the tables' keys; whether the fumble head is read
  HeadTable heads[kHeadTables];
  int k_heads, use_fumble;
};

namespace {

// draw slots (ops/game.py U_*, N_*)
constexpr int U_GO = 0, U_FG = 1, U_TB = 2, U_CALL = 3, U_QB = 4, U_WR = 5, U_RB = 6,
              U_COMPLETE = 7, U_EXP = 8, U_BOOST = 9, U_RZ = 10, U_S2 = 11, U_FUM = 12;
constexpr int N_PUNT_GROSS = 0, N_PUNT_RET = 1, N_YARDS = 2, N_INT_RET = 3;
static_assert(U_QB / 4 == U_WR / 4 && U_QB / 4 == U_RB / 4,
              "the slot uniforms share one Philox block (philox::block_uniforms)");

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

// game._sample_slot for one game: the shares of role r and direction dirx
// that u is at or past, at most k - 1; one slot reads no share.  `a.cum` is
// the block's copy in shared memory where kStaged, else global memory.
template <bool kStaged>
__device__ __forceinline__ int sample_slot(const Accrual& a, int r, int dirx, float u) {
  if (a.k == 1) return 0;
  const float* row = a.cum + (static_cast<long long>(r) * a.dirs + dirx) * a.k;
  int slot = 0;
  for (int j = 0; j < a.k; ++j) {
    if constexpr (kStaged) {
      slot += u >= row[j] ? 1 : 0;
    } else {
      slot += u >= __ldg(row + j) ? 1 : 0;
    }
  }
  return min(slot, a.k - 1);
}

// The three roles' slots of a play in pstats' role order (QB, rusher,
// target), as game._sample_slot samples them from their uniforms (U_QB,
// U_RB, U_WR) in the slots' Philox block `w`, mirrored where the game's
// draws are: what the per-head lookups key on and the player rows a play
// may add to.
template <bool kStaged>
__device__ __forceinline__ void sample_roles(const Accrual& a, int dirx,
                                             const float (&w)[4], bool mirror,
                                             int (&slot)[kRoles]) {
  const int word[kRoles] = {U_QB % 4, U_RB % 4, U_WR % 4};
#pragma unroll
  for (int r = 0; r < kRoles; ++r) {
    const float u = mirror ? 1.0f - w[word[r]] : w[word[r]];
    slot[r] = sample_slot<kStaged>(a, r, dirx, u);
  }
}

constexpr int kPairs = kPlayerStats / 2;   // float2s a player row

// The player row (side, role, slot) in `rows`, a game's block of pstats
// ((2, kRoles, k, kPlayerStats) f32, 8-byte aligned) as float2s.
__device__ __forceinline__ float2* player_row(float2* rows, int k, int side, int role, int slot) {
  return rows + ((side * kRoles + role) * k + slot) * kPairs;
}

// Game i's block of pstats as float2s.
__device__ __forceinline__ float2* game_rows(const Accrual& a, long long i) {
  return reinterpret_cast<float2*>(a.pstats) + i * (2 * kRoles * a.k * kPairs);
}

// A play's sampled slot of each role, in pstats' role order, or -1 where
// that slot is not tracked; the game's block of pstats, and the tracked
// slots' rows as they were before the play.
struct Slots {
  int slot[kRoles];
  float2* rows;
  float2 row[kRoles][kPairs];
};

// The play's tracked slots and their rows, read as the play starts (a play
// adds to at most these rows): issued ahead of the play's other draws, so
// their latency is under the draws and no lane waits on them behind a
// branch of the roles its play involves.
__device__ __forceinline__ Slots tracked_rows(const Accrual& a, float2* rows, int dirx,
                                              const int (&slot)[kRoles], int off) {
  Slots s;
  s.rows = rows;
#pragma unroll
  for (int r = 0; r < kRoles; ++r) {
    const bool t = a.tracked[(static_cast<long long>(r) * a.dirs + dirx) * a.k + slot[r]];
    s.slot[r] = t ? slot[r] : -1;
    if (t) {
      const float2* cell = player_row(rows, a.k, off, r, slot[r]);
#pragma unroll
      for (int q = 0; q < kPairs; ++q) s.row[r][q] = cell[q];
    }
  }
  return s;
}

// One role's row of play_step's player deltas added to its slot's row as
// `tracked_rows` read it, and written back, where that slot is tracked
// (slot >= 0; the eager step's gate of 0 adds +-0.0 elsewhere, which leaves
// the cell as it is).  8-byte accesses: a warp's rows are 32 scattered
// addresses, so each access instruction costs the load-store unit a pass
// per row (a workspace interleaving a warp's rows cost more: PERF.md).
__device__ __forceinline__ void add_player_row(const Slots& sl, int k, int role, int off,
                                               const float (&v)[kPlayerStats]) {
  const int slot = sl.slot[role];
  if (slot < 0) return;
  float2* cell = player_row(sl.rows, k, off, role, slot);
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const float2 x = sl.row[role][q];
    cell[q] = make_float2(x.x + v[2 * q], x.y + v[2 * q + 1]);
  }
}

__device__ __forceinline__ long long clamp_index(long long x, long long n) {
  return x < 0 ? 0 : (x >= n ? n - 1 : x);
}

// The state's cells in the layouts past kLayoutNano: the score diff, the
// down's class (down >= 5 is one), the bins on the first profile
// (NanoConsts' segments) and, where `second`, on the second (LayoutConsts').
struct Bins {
  int sd, down_i, di, yi, si, sdi, di2, yi2, si2, sdi2;
};

// `second`: the coarse cell's three axes binned too; `sd2`: its score diff
// too (the per-head tables read it, the play table bins the score diff by
// its own edges).  Both fold away where the caller knows them at compile
// time.
__device__ __forceinline__ Bins bins(const NanoConsts& c, const LayoutConsts& lay,
                                     const SegVals* sv, const Game& s, bool second, bool sd2) {
  Bins b;
  b.sd = (s.sa - s.sb) * (1 - 2 * s.off);
  const float sdf = static_cast<float>(b.sd);
  const float secf = static_cast<float>(s.sec);
  b.down_i = min(max(s.down - 1, 0), 4);
  b.di = seg_bin(c.dist, sv[0], s.dist);
  b.yi = seg_bin(c.ytg, sv[1], s.ytg);
  b.si = seg_bin(c.sec, sv[2], secf);
  b.sdi = lay.sd1 ? seg_bin(c.sd, sv[3], sdf) : 0;
  b.di2 = b.yi2 = b.si2 = b.sdi2 = 0;
  if (second) {
    b.di2 = seg_bin(lay.dist2, sv[4], s.dist);
    b.yi2 = seg_bin(lay.ytg2, sv[5], s.ytg);
    b.si2 = seg_bin(lay.sec2, sv[6], secf);
    b.sdi2 = sd2 ? seg_bin(lay.sd2, sv[7], sdf) : 0;
  }
  return b;
}

// The one-row layouts: the floats of the state's row (table_lookup.
// _fused_eval's index, clamped as _take's; _nano_eval's row and (down, sd)
// block where the strides are the nano table's, the clamp then a no-op),
// from its direction's first row `base`.  The index is 32-bit, as JAX's
// int32 (ops/game.pack_nano_game checks rows < 2^31), widened once.
__device__ __forceinline__ const float* row_at(const NanoConsts& c, const LayoutConsts& lay,
                                               const float* __restrict__ table, const Bins& b,
                                               int base) {
  const int row = base + b.down_i * lay.s_down + b.di * lay.s_dist + b.yi * lay.s_ytg
                  + b.si * lay.s_sec + b.sdi * lay.s_sd;
  const int clamped = min(max(row, 0), static_cast<int>(lay.rows) - 1);
  return table + static_cast<long long>(clamped) * c.cols + (b.down_i * lay.b_down + b.sdi * lay.b_sd);
}

// The state's cell on the second (coarse) profile: table_lookup._state_idx.
__device__ __forceinline__ int cell2(const LayoutConsts& lay, const Bins& b) {
  return ((b.down_i * lay.nd2 + b.di2) * lay.ny2 + b.yi2) * lay.ns2 + b.si2;
}

// The play-policy table's P(pass) of the state (table_lookup.py's play
// lookup): the direction's first row `base`, the coarse cell's play_nsd
// bins and the score diff's bin, clamped (32-bit, as row_at).  The bin,
// the count of edges below the score diff (_bin), is read from the block's
// table `sd_bins` (every integer score diff in kPlaySdLo .. kPlaySdLo +
// kPlaySdBins - 1; one outside takes its nearest end's bin, its own since
// every edge lies inside: pack_nano_game checks).
__device__ __forceinline__ const float* play_at(const LayoutConsts& lay,
                                                const unsigned char* sd_bins, const Bins& b,
                                                int base) {
  const int bin = sd_bins[min(max(b.sd, kPlaySdLo), kPlaySdLo + kPlaySdBins - 1) - kPlaySdLo];
  const int idx = base + cell2(lay, b) * lay.play_nsd + bin;
  const int clamped = min(max(idx, 0), static_cast<int>(lay.play_rows) - 1);
  return lay.play + static_cast<long long>(clamped) * lay.play_cols;
}

// kLayoutHeads: head table t's row of the state (table_lookup._per_head_eval's
// lookup): the block of its key through the row map, plus the state's cell
// on its profile with the score diff folded in where the table has it, each
// index clamped.
__device__ __forceinline__ const float* head_at(const HeadTable& t, long long key, int cell1,
                                                int cell2_, int sdi1, int sdi2, int nsd1,
                                                int nsd2) {
  const int base = __ldg(t.row_map + clamp_index(key, t.map_len));
  int st = t.profile ? cell2_ : cell1;
  if (t.has_sd) st = st * (t.profile ? nsd2 : nsd1) + (t.profile ? sdi2 : sdi1);
  return t.values + clamp_index(static_cast<long long>(base) + st, t.rows) * t.cols;
}

// kLayoutHeads: the play's head channels from the per-head tables, keyed on
// the play's slots (QB, rusher, target): stage 1 (p_c), stage 2's
// cumulative pair where the table exists, the pass, rush and sack
// quantiles' (mu, sigma), the fumble probability where it is read.
__device__ __forceinline__ Row head_rows(const NanoConsts& c, const LayoutConsts& lay, const Bins& b,
                                         int dirx, const int (&slot)[kRoles]) {
  const long long kk = lay.k_heads;
  const long long qb = static_cast<long long>(dirx) * kk + slot[0];
  const long long keys[3] = {qb, static_cast<long long>(dirx) * kk + slot[1], qb * kk + slot[2]};
  const int cell1 = ((b.down_i * lay.nd1 + b.di) * c.ny + b.yi) * c.ns + b.si;
  const int c2 = cell2(lay, b);
  const float* h[kHeadTables];
#pragma unroll
  for (int t = 0; t < kHeadTables; ++t) {
    const HeadTable& ht = lay.heads[t];
    h[t] = ht.values == nullptr ? nullptr
                                : head_at(ht, keys[ht.key], cell1, c2, b.sdi, b.sdi2, c.nsd, lay.nsd2);
  }
  Row r;
  r.p_c = __ldg(h[0]);
  r.s2c0 = c.has_s2 ? __ldg(h[1]) : 0.0f;
  r.s2c1 = c.has_s2 ? __ldg(h[1] + 1) : 0.0f;
  r.pass_mu = __ldg(h[2]);
  r.pass_sg = __ldg(h[2] + 1);
  r.rush_mu = __ldg(h[3]);
  r.rush_sg = __ldg(h[3] + 1);
  r.sack_mu = __ldg(h[4]);
  r.sack_sg = __ldg(h[4] + 1);
  r.p_f = lay.use_fumble ? __ldg(h[5]) : 0.0f;
  return r;
}

// One play of an active game (sec > 0): game.play_step with the nano heads,
// on the row `row_of` gave for this state.  With kStats the play's 19 team
// stats (less `points`, written when the game ends) are added to the
// offense's side of the lane's stripe `team` (column q of side o at
// (o * kTeamStats + q) * kThreads); with kPlayers each role the play
// involves (QB and target on a pass play, rusher on a run: the roles whose
// eager delta is not all +0.0) adds its row to the game's pstats (`sl`).
// With kGeneral (the layouts past kLayoutNano) the 4th-down decision is
// forced where `force` is a fourth.force code, and the play-policy table's
// P(pass) `p_ml` replaces pass_prob_v1 where `use_ml`.
template <bool kStats, bool kPlayers, bool kGeneral = false>
__device__ __forceinline__ void play(const NanoConsts& c, const float* grid, const Row& r,
                                     const DirVals& d0, const DirVals& d1, Game& s,
                                     const float* u, const float* n, float* team,
                                     const Accrual& acc, const Slots& sl, int force = 0,
                                     bool use_ml = false, float p_ml = 0.0f) {
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
  bool go, st_play, fg_att;
  if constexpr (kGeneral) {
    // fourth.force: the decision overridden, the draws used as ever
    const bool forced = force != 0;
    go = forced ? is4 && force == kForceGo : is4 && u[U_GO] < p_go;
    st_play = forced ? is4 && force != kForceGo : is4 && !go;
    fg_att = forced ? st_play && force == kForceFg : st_play && ytg0 <= c.fg_attempt_max_ytg;
  } else {
    go = is4 && u[U_GO] < p_go;
    st_play = is4 && !go;
    fg_att = st_play && ytg0 <= c.fg_attempt_max_ytg;
  }
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

  float p_pass;
  if constexpr (kGeneral) {
    p_pass = use_ml ? p_ml : pass_prob_v1(c, down0, dist0, ytg0, sec0, sd);
  } else {
    p_pass = pass_prob_v1(c, down0, dist0, ytg0, sec0, sd);
  }
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
        add_player_row(sl, acc.k, 0, off, qb);
        add_player_row(sl, acc.k, 2, off, wr);
      } else if (is_run) {
        const float rb[kPlayerStats] = {1.0f, 0.0f, rush_yds, f(run_td), 0.0f, 0.0f};
        add_player_row(sl, acc.k, 1, off, rb);
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
  bool forced;        // the forced first play is next (layouts past kLayoutNano)
  int extra;          // 1 once the forced play is played (outside the cap and j)
  // Opts::bases: the first row of each direction of the game (off 0, 1) in
  // the table and in the play table
  int rb0, rb1, pb0, pb1;
  // kLayoutRowForced: the next play's stream and fourth.force code, the
  // forced play's until it is played, then the launch's
  uint32_t dk0, dk1;
  int code;
};

// What an instantiation past kLayoutNano reads, fixed by its layout: whether
// a play reads one row by strides (else the per-head tables); whether it
// reads the play-policy table and whether a forced first play may come,
// each kNo, kYes or kLaid (as LayoutConsts says, a branch uniform across the
// grid); whether the lane takes its game's row and play bases with the game
// (else a play computes them: the instantiations with collectors, whose
// registers are at the two-blocks-an-SM limit).
constexpr int kNo = 0, kYes = 1, kLaid = 2;

template <int kLayout>
struct Opts {
  static constexpr bool general = kLayout == kLayoutRow || kLayout == kLayoutHeads;
  static constexpr bool row = kLayout != kLayoutHeads;
  static constexpr int play = general ? kLaid : kLayout == kLayoutRowPlay ? kYes : kNo;
  static constexpr int forced = general ? kLaid : kLayout == kLayoutRowForced ? kYes : kNo;
  static constexpr bool bases = !general;
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

// `start`, and in the layouts past kLayoutNano the launch's forced first
// play: a game with sec > 0 plays it outside the cap, one with sec <= 0
// gets its masked step (the forced play_step runs whatever the run flag).
// With Opts::bases the game's two directions' first rows (gid * 2 + off)
// in the table and the play table are taken here, once a game; in
// kLayoutRowForced the first play's stream and code.
template <int kLayout, bool kStats>
__device__ __forceinline__ void take(Lane& g, long long i, const InPtrs& in,
                                     const float* __restrict__ dirs, int n_matchups, uint32_t r0,
                                     int anti, bool run, bool forced, float* team,
                                     const Accrual& acc, const NanoConsts& c,
                                     const LayoutConsts& lay, uint32_t k0, uint32_t k1) {
  if constexpr (kLayout == kLayoutNano) {
    start<kStats>(g, i, in, dirs, n_matchups, r0, anti, run, team, acc);
  } else {
    using O = Opts<kLayout>;
    start<kStats>(g, i, in, dirs, n_matchups, r0, anti, run || forced, team, acc);
    g.forced = forced && g.live;
    g.extra = 0;
    if constexpr (O::bases) {
      const int d0 = g.s.gid * 2;
      g.rb0 = d0 * c.per_dir;
      g.rb1 = g.rb0 + c.per_dir;
      if constexpr (O::play != kNo) {
        g.pb0 = static_cast<int>(__ldg(lay.play_base + d0));
        g.pb1 = static_cast<int>(__ldg(lay.play_base + d0 + 1));
      }
    }
    if constexpr (O::forced == kYes) {
      g.dk0 = g.forced ? lay.fk0 : k0;
      g.dk1 = g.forced ? lay.fk1 : k1;
      g.code = g.forced ? lay.force_first : lay.force_every;
    }
  }
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

// Past kLayoutNano, the block's segment values are copied in parallel, one
// word a thread: word w (of SegVals' 32) of axis a (of `axes`), from its
// Segs (the first profile's four axes in NanoConsts, the second's in
// LayoutConsts), whose words follow `enter`'s 8.
__device__ __forceinline__ void copy_segs(const NanoConsts& c, const LayoutConsts& lay,
                                          SegVals* sv, int axes) {
  constexpr int kWords = sizeof(SegVals) / sizeof(uint32_t);
  static_assert(kWords * 8 == kThreads, "one word of the 8 axes' SegVals a thread");
  const int a = threadIdx.x / kWords, w = threadIdx.x % kWords;
  if (a >= axes) return;
  const Segs& g = a == 0 ? c.dist : a == 1 ? c.ytg : a == 2 ? c.sec : a == 3 ? c.sd
                  : a == 4 ? lay.dist2 : a == 5 ? lay.ytg2 : a == 6 ? lay.sec2 : lay.sd2;
  reinterpret_cast<uint32_t*>(sv + a)[w] = reinterpret_cast<const uint32_t*>(&g)[kSegs + w];
}

// The persistent grid: lane t of the launch's `lanes` takes game t, then,
// each time its game ends, the next game of the queue (work[0] counts the
// games handed out past the first lanes, one atomicAdd a warp for all its
// lanes whose games ended at that play).  work[1] counts the blocks done;
// the last resets both, so the next launch on the stream finds them 0.
// One instantiation a layout and combination of the collectors; with kStats
// the block holds a stripe of 2 x kTeamStats floats a lane in dynamic shared
// memory; with kPlayers the launch's slot shares and tracked flags follow
// it, copied once a block (`dynamic_bytes`).  `lay` is read only past
// kLayoutNano, where Opts<kLayout> says what a play reads: where the play
// table may be read, the block first builds the score diff's bins
// (`sd_bins`, one a thread) from its edges with _bin's compare.
template <int kLayout, bool kStats, bool kPlayers>
__global__ void __launch_bounds__(kThreads)
    nano_game_kernel(const NanoConsts c, const float* __restrict__ table,
                     const float* __restrict__ dirs, int n_matchups, const InPtrs in,
                     const OutPtrs out, uint32_t k0, uint32_t k1, uint32_t r0, int anti,
                     const bool* run_flag, unsigned int* work, const Counters cnt,
                     const Accrual acc, int n, const LayoutConsts lay) {
  constexpr bool kGeneral = kLayout != kLayoutNano;
  using O = Opts<kLayout>;
  constexpr bool kSampled = kPlayers || kLayout == kLayoutHeads;   // plays sample slots
  // the second profile's bins: the per-head tables on it, or the play table
  constexpr bool kSecond = kLayout == kLayoutHeads || O::play != kNo;
  static_assert(kPlaySdBins == kThreads, "one score diff's bin a thread");
  extern __shared__ float stripes[];
  float* const team = stripes + threadIdx.x;
  __shared__ float grid[kGridCells];
  // dist, ytg, sec, sd; with the second profile its four too
  __shared__ SegVals sv[kSecond ? 8 : 4];
  __shared__ unsigned char sd_bins[O::play != kNo ? kPlaySdBins : 1];
  __shared__ unsigned long long block_plays, block_iters;
  for (int k = threadIdx.x; k < c.go_cells; k += kThreads) grid[k] = c.go_grid[k];
  // with the player stats, the slot shares and tracked flags copied past
  // the stripe in coalesced loads: each play's slot samples and flags then
  // read shared memory
  Accrual sa = acc;
  if constexpr (kPlayers) {
    float* const cum = stripes + (kStats ? 2 * kTeamStats * kThreads : 0);
    const int entries = kRoles * acc.dirs * acc.k;
    bool* const tracked = reinterpret_cast<bool*>(cum + entries);
    for (int j = threadIdx.x; j < entries; j += kThreads) {
      cum[j] = acc.cum[j];
      tracked[j] = acc.tracked[j];
    }
    sa.cum = cum;
    sa.tracked = tracked;
  }
  if constexpr (!kGeneral) {
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
  } else {
    if (threadIdx.x == 0) {
      block_plays = 0;
      block_iters = 0;
    }
    copy_segs(c, lay, sv, kSecond ? 8 : 4);
    if constexpr (O::play != kNo) {
      if (O::play == kYes || lay.has_play) {
        const float sdf = static_cast<float>(kPlaySdLo + static_cast<int>(threadIdx.x));
        int bin = 0;
#pragma unroll
        for (int e = 0; e < kPlayEdges; ++e) bin += sdf > lay.play_edges[e] ? 1 : 0;
        sd_bins[threadIdx.x] = static_cast<unsigned char>(bin);
      }
    }
  }
  __syncthreads();
  const bool run = c.cap > 0 && (run_flag == nullptr || *run_flag);
  const bool forced_launch = kGeneral && lay.force_first != 0;
  const unsigned lane = threadIdx.x & 31u;
  const long long lanes = static_cast<long long>(gridDim.x) * kThreads;
  Lane g;
  g.i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  g.live = false;
  if (g.i < n) {
    take<kLayout, kStats>(g, g.i, in, dirs, n_matchups, r0, anti, run, forced_launch, team, acc,
                          c, lay, k0, k1);
  }
  bool open = lanes < n;             // the queue has games to hand out (warp-uniform)
  unsigned long long played = 0;     // plays of this lane's finished games
  unsigned int iters = 0;            // this warp's loop trips
  while (__any_sync(kFull, g.i < n)) {
    ++iters;
    if constexpr (!kGeneral) {
      if (g.live) {
        // the row's loads first; with kPlayers the slots' Philox block, the
        // slots and the tracked rows' loads next; the (other) draws under
        // their latency, then the play
        const Row r = load_row(c, row_of(c, sv, table, g.s));
        float u[philox::kUniforms], z[philox::kNormals];
        Slots sl{};
        if constexpr (kPlayers) {
          const int dirx = g.s.gid * 2 + g.s.off;
          float w[4];
          philox::block_uniforms(k0, k1, static_cast<uint32_t>(g.j), g.row, U_QB / 4, w);
          int slot[kRoles];
          sample_roles<true>(sa, dirx, w, g.mirror, slot);
          sl = tracked_rows(sa, game_rows(acc, g.i), dirx, slot, g.s.off);
          philox::step_draws_given<U_QB / 4>(k0, k1, static_cast<uint32_t>(g.j), g.row, w, u, z);
        } else {
          philox::step_draws(k0, k1, static_cast<uint32_t>(g.j), g.row, u, z);
        }
        if (g.mirror) {
#pragma unroll
          for (int k = 0; k < philox::kUniforms; ++k) u[k] = 1.0f - u[k];
#pragma unroll
          for (int k = 0; k < philox::kNormals; ++k) z[k] = -z[k];
        }
        play<kStats, kPlayers>(c, grid, r, g.d0, g.d1, g.s, u, z, team, acc, sl);
        ++g.j;
        g.live = g.s.sec > 0 && g.j < c.cap;
      }
    } else {
      if (g.live) {
        // the lookups that need no draw issued first (the row, the play
        // table); where the play samples slots, the slots' Philox block,
        // the slots, and the per-head lookups and the tracked player rows
        // keyed on them issued together next; then the play's other draws
        // (the forced play's on its own stream) under their latency, then
        // the play.  The forced play and the first unforced one are both
        // step 0 (j stays 0 over the forced play).
        const int dirx = g.s.gid * 2 + g.s.off;
        const bool a = g.s.off == 0;
        const bool use_ml = O::play == kYes || (O::play == kLaid && lay.has_play);
        const Bins b = bins(c, lay, sv, g.s, kLayout == kLayoutHeads || use_ml,
                            kLayout == kLayoutHeads && lay.sd2_on);
        Row r{};
        if constexpr (O::row) {
          r = load_row(c, row_at(c, lay, table, b, O::bases ? (a ? g.rb0 : g.rb1) : dirx * c.per_dir));
        }
        float p_ml = 0.0f;
        if (use_ml) {
          const int base = O::bases ? (a ? g.pb0 : g.pb1)
                                    : static_cast<int>(__ldg(lay.play_base + dirx));
          p_ml = __ldg(play_at(lay, sd_bins, b, base));
        }
        uint32_t dk0 = k0, dk1 = k1;
        int code = lay.force_every;
        if constexpr (O::forced == kLaid) {
          dk0 = g.forced ? lay.fk0 : k0;
          dk1 = g.forced ? lay.fk1 : k1;
          code = g.forced ? lay.force_first : lay.force_every;
        } else if constexpr (O::forced == kYes) {
          dk0 = g.dk0;
          dk1 = g.dk1;
          code = g.code;
        }
        const uint32_t step = static_cast<uint32_t>(g.j);
        float u[philox::kUniforms], z[philox::kNormals];
        Slots sl{};
        if constexpr (kSampled) {
          float w[4];
          philox::block_uniforms(dk0, dk1, step, g.row, U_QB / 4, w);
          int slot[kRoles];
          sample_roles<kPlayers>(sa, dirx, w, g.mirror, slot);
          if constexpr (kLayout == kLayoutHeads) r = head_rows(c, lay, b, dirx, slot);
          if constexpr (kPlayers) sl = tracked_rows(sa, game_rows(acc, g.i), dirx, slot, g.s.off);
          philox::step_draws_given<U_QB / 4>(dk0, dk1, step, g.row, w, u, z);
        } else {
          philox::step_draws(dk0, dk1, step, g.row, u, z);
        }
        if (g.mirror) {
#pragma unroll
          for (int k = 0; k < philox::kUniforms; ++k) u[k] = 1.0f - u[k];
#pragma unroll
          for (int k = 0; k < philox::kNormals; ++k) z[k] = -z[k];
        }
        play<kStats, kPlayers, true>(c, grid, r, g.d0, g.d1, g.s, u, z, team, acc, sl, code,
                                     use_ml, p_ml);
        if constexpr (O::forced == kNo) {
          ++g.j;
        } else if (g.forced) {
          // the forced play, played: the launch's stream and code from now on
          g.forced = false;
          g.extra = 1;
          if constexpr (O::forced == kYes) {
            g.dk0 = k0;
            g.dk1 = k1;
            g.code = lay.force_every;
          }
        } else {
          ++g.j;
        }
        g.live = g.s.sec > 0 && g.j < c.cap;
      }
    }
    const bool done = g.i < n && !g.live;
    if (done) {
      finish<kStats>(g, out, team, acc);
      if constexpr (!kGeneral || O::forced == kNo) {
        played += static_cast<unsigned long long>(g.j);
        if (cnt.game_plays != nullptr) cnt.game_plays[g.i] = g.j;
      } else {
        // the forced play counts as a play
        played += static_cast<unsigned long long>(g.j + g.extra);
        if (cnt.game_plays != nullptr) cnt.game_plays[g.i] = g.j + g.extra;
      }
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
        if (g.i < n) {
          take<kLayout, kStats>(g, g.i, in, dirs, n_matchups, r0, anti, run, forced_launch, team,
                                acc, c, lay, k0, k1);
        }
      }
    }
  }
  if (cnt.plays != nullptr) atomicAdd(&block_plays, played);
  if (cnt.iters != nullptr && lane == 0) atomicAdd(&block_iters, static_cast<unsigned long long>(iters));
  __syncthreads();
  if (threadIdx.x == 0) {
    if (cnt.plays != nullptr) atomicAdd(cnt.plays, block_plays);
    if (cnt.iters != nullptr) atomicAdd(cnt.iters, block_iters);
    // every claim of this block has returned; the last resets
    if (atomicAdd(&work[1], 1u) == gridDim.x - 1) {
      atomicExch(&work[0], 0u);
      atomicExch(&work[1], 0u);
    }
  }
}

using KernelFn = void (*)(NanoConsts, const float*, const float*, int, InPtrs, OutPtrs, uint32_t,
                         uint32_t, uint32_t, int, const bool*, unsigned int*, Counters, Accrual,
                         int, LayoutConsts);

template <int kLayout>
KernelFn kernel_of_layout(bool stats, bool players) {
  if (stats) {
    return players ? nano_game_kernel<kLayout, true, true> : nano_game_kernel<kLayout, true, false>;
  }
  return players ? nano_game_kernel<kLayout, false, true> : nano_game_kernel<kLayout, false, false>;
}

// The instantiation of the layout and the collectors `stats` and
// `players`; null for an unknown layout, or a score-only one with a
// collector.  The score-only one-row layouts are what the paths launch
// past the nano layout (a fused or slate launch, the play-policy table, a
// forced first play); every other combination takes kLayoutRow's.
KernelFn kernel_of(int layout, bool stats, bool players) {
  const bool score_only = !stats && !players;
  switch (layout) {
    case kLayoutNano: return kernel_of_layout<kLayoutNano>(stats, players);
    case kLayoutRow: return kernel_of_layout<kLayoutRow>(stats, players);
    case kLayoutHeads: return kernel_of_layout<kLayoutHeads>(stats, players);
    case kLayoutRowBare: return score_only ? nano_game_kernel<kLayoutRowBare, false, false> : nullptr;
    case kLayoutRowPlay: return score_only ? nano_game_kernel<kLayoutRowPlay, false, false> : nullptr;
    case kLayoutRowForced:
      return score_only ? nano_game_kernel<kLayoutRowForced, false, false> : nullptr;
    default: return nullptr;
  }
}

// Whether the launch's LayoutConsts are what the layout's instantiation
// reads: the play table and the forced first play present where it reads
// them and absent where it does not.
bool layout_takes(int layout, const LayoutConsts& lay) {
  switch (layout) {
    case kLayoutRowBare: return !lay.has_play && lay.force_first == 0;
    case kLayoutRowPlay: return lay.has_play && lay.force_first == 0;
    case kLayoutRowForced: return !lay.has_play && lay.force_first != 0;
    default: return true;
  }
}

// Its dynamic shared memory: the lanes' team-stat stripes, then with the
// player stats the slot tables of `entries` shares (f32) and as many
// tracked flags (a byte each), in 16-byte units.
size_t dynamic_bytes(bool stats, bool players, int entries) {
  const size_t stripes = stats ? 2 * kTeamStats * kThreads * sizeof(float) : 0;
  const size_t slot_tables = players ? (static_cast<size_t>(entries) * 5 + 15) / 16 * 16 : 0;
  return stripes + slot_tables;
}

// Lets `fn` take `bytes` of dynamic shared memory (past the 48 KB a launch
// may take without asking).
cudaError_t allow_dynamic(KernelFn fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int nano_game_consts_size() { return static_cast<int>(sizeof(NanoConsts)); }

extern "C" int nano_game_layout_size() { return static_cast<int>(sizeof(LayoutConsts)); }

// Threads a block of K1.
extern "C" int nano_game_threads() { return kThreads; }

// Blocks of K1's instantiation for the layout (kLayoutNano .. kLayoutRowForced,
// ops/game.LAYOUT_KINDS) and the collectors `stats` and `players` (0 or 1) that one
// SM holds at once, with the player stats staging slot tables of `entries`
// shares (kRoles x the launch's directions x k)
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current device), or
// minus the CUDA error.
extern "C" int nano_game_blocks_per_sm(int layout, int stats, int players, int entries) {
  const KernelFn fn = kernel_of(layout, stats, players);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = dynamic_bytes(stats, players, entries);
  cudaError_t err = allow_dynamic(fn, bytes);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, bytes);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Registers a thread and local-memory bytes a thread (register spills and
// local arrays) of the instantiation for the layout and collectors, by
// cudaFuncGetAttributes on the current device: 0, or the CUDA error.
extern "C" int nano_game_attributes(int layout, int stats, int players, int* regs,
                                    int* local_bytes) {
  const KernelFn fn = kernel_of(layout, stats, players);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
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
// the QB, rusher and target slots (cum also for kLayoutHeads, whose lookups
// key on the slots).  `layout` picks the instantiation, `lay` its
// LayoutConsts (past kLayoutNano: the force codes and key, the strides, the
// second profile, the play table and the per-head tables); a score-only
// one-row layout takes no collector, and the play table and the forced
// play as it reads them (`layout_takes`), else cudaErrorInvalidValue.  `blocks` blocks
// of kThreads (at most the resident blocks, `nano_game_blocks_per_sm` of the
// instantiation and its slot tables x the SMs).  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int nano_game_launch(const NanoConsts* c, const void* table, const void* dirs,
                                int n_matchups, void* const* in, void* const* out, uint32_t k0,
                                uint32_t k1, uint32_t r0, int anti, const void* run_flag,
                                void* work, void* plays, void* iters, void* game_plays,
                                void* stats, void* pstats, const void* cum, const void* tracked,
                                int k, int layout, const LayoutConsts* lay, int n, int blocks,
                                void* stream) {
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
  const KernelFn fn = kernel_of(layout, with_stats, with_players);
  if (fn == nullptr || !layout_takes(layout, *lay)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = dynamic_bytes(with_stats, with_players, kRoles * acc.dirs * k);
  const cudaError_t err = allow_dynamic(fn, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      *c, static_cast<const float*>(table), static_cast<const float*>(dirs), n_matchups, ip,
      op, k0, k1, r0, anti, static_cast<const bool*>(run_flag),
      static_cast<unsigned int*>(work), cnt, acc, n, *lay);
  return static_cast<int>(cudaGetLastError());
}
