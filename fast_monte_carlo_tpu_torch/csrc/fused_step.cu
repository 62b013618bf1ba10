// Fused score-only play step: draws, heads and state machine in one kernel.
//
// Replaces the Pallas kernels of benchmarks/pallas_step_arith.py:
//   :262 _kernel_step      one step per launch            (fused_step, ch = 1)
//   :270 _kernel_chunk     a 24-step chunk per launch     (fused_step, ch = 24)
//   :383 _kernel_step_tab  one step, 7 head vectors given (fused_step_tab)
// all launched through :284 _pallas_call and :392 make_hybrid_tab.
//
// One thread per game holds the 9 state fields in registers for `ch` steps.
// Each step draws 13 uniforms and 4 normals from Philox (philox.cuh) with
// counter (row, absolute step, block, 0) under the launch key, the stream of
// ops/rng.philox_draws, so a game's draws do not depend on `ch`.  The step is
// the arithmetic of probes/step_arith.step_arith (the port of `rep_arith`,
// :72), written operation for operation in the same order: this file is
// compiled with --fmad=false, so every f32 multiply and add rounds on its own
// as in the eager torch step, and every literal is f32 (a double literal
// would move `py + 1e-9f >= ytg` into double and flip it).  The SimConfig
// constants arrive from the host in StepConsts, so they cannot drift from
// config.py.
//
// Bound on the H100: a launch reads and writes 36 bytes of state per game
// (4.7 MB each way at B = 131,072).  A game-step needs about 714 dispatched
// instructions: 313 on the 64 lanes of the ALU pipe (Philox's XORs, the
// compares, selects and clips of the policies and the state machine), 85
// on the 64 of IMAD (Philox's products), 240 f32 (chip_smoke.py counts
// them by class).  So ch = 24 is bound by dispatch, the ALU close behind;
// ch = 1, one wave of 131,072 threads, by its bytes, which take less time
// than one thread's latency through a step and the gap between launches.
//
// Design: the state stays in registers across the chunk, so device memory
// is touched once per launch.  The step body has no loops: the bucketize
// and FG-curve searches run over all 8 slots of tables padded on the host
// (edges with +inf, FG bounds with -inf), whose entries the compiler then
// reads as constant operands; the go-for-it grid, indexed per lane, sits in
// shared memory, not in the parameter bank, whose loads serialise over a
// warp's distinct addresses.  64 registers at most (__launch_bounds__), so
// that all 1,024 blocks of a 131,072-game launch are resident at once on
// 132 SMs.  Drawing step j + 1's Philox words before step j's arithmetic
// was tried: the 17 words held across the step spilled under that cap and
// ran 2-3% slower than drawing each step's words where they are used.
//
// fused_step_tab runs one step per launch, with the heads as inputs.  Its
// bound is its bytes (13.1 MB at B = 131,072, one wave).  Each thread loads
// 9 state words and 7 heads, draws, steps and stores, and the heads are
// the columns of one (B, 7) tensor: read per thread, they took seven 4-byte
// loads 28 bytes apart.  Design: the launcher takes the heads only as one
// 16-byte-aligned (B, 7) slab (the wrapper stacks them otherwise), and each
// block copies its 128 x 7 floats, 3,584 bytes, into shared memory by
// 16-byte cp.async, which needs no registers.  The copy and the state loads
// are issued first, the Philox draws of (key, step, row) run while they are
// in flight, and one barrier then covers the slab and the go-for-it grid.
// Programmatic dependent launch (pdl.cuh) is not taken: in the probe's own
// order, after table_select's torch kernels, it saved 1% of a step's
// device time on an H100 (PERF.md, PR 4).
#include <cmath>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "philox.cuh"

// Field for field as _StepConsts in probes/step_arith.py.  Outside the
// anonymous namespace: the extern "C" launchers take it and keep external
// linkage.
struct StepConsts {
  float go_ytg_edges[8];
  float go_dist_edges[8];
  float go_grid[81];        // (n_go_ytg + 1) x (n_go_dist + 1), row-major
  int n_go_ytg;
  int n_go_dist;
  int late_seconds;
  float late_leading_scale;
  float late_trailing_long_fg_ytg;
  float late_trailing_go_long;
  float late_trailing_go_short;
  float go_multiplier;
  float fg_bounds[8];
  float fg_probs[8];
  int n_fg;
  float fg_long_prob;
  float s2_inc, s2_int, s2_sck;
  float stage2_int_scale, stage2_int_add, stage2_sack_scale;
  float heuristic_clip_lo, heuristic_clip_hi;
  int half_seconds;
  float rz_pass[7];         // base, slope, down bonus, tilt, 1/tilt denom, lo, hi
  float rz_run[7];
  float explosive[6];       // base, z_k, bonus over 60, bonus over 40, lo, hi
  float r_mismatch, r7, r10, r60;
};

namespace {

constexpr int kSlots = 8;   // the edge and FG arrays of StepConsts

// What the kernels read of StepConsts' searches, built by the launchers:
// every slot filled, so that the searches need no trip count.
struct Tables {
  float go_ytg_edges[kSlots];   // past n_go_ytg: +inf, which no x exceeds
  float go_dist_edges[kSlots];
  float fg_bounds[kSlots];      // past n_fg: -inf, which no attempt is below
  float fg_probs[kSlots];
  int go_row;                   // n_go_dist + 1
  int go_cells;                 // (n_go_ytg + 1) * (n_go_dist + 1)
};

Tables tables_of(const StepConsts& c) {
  Tables t;
  for (int k = 0; k < kSlots; ++k) {
    t.go_ytg_edges[k] = k < c.n_go_ytg ? c.go_ytg_edges[k] : INFINITY;
    t.go_dist_edges[k] = k < c.n_go_dist ? c.go_dist_edges[k] : INFINITY;
    t.fg_bounds[k] = k < c.n_fg ? c.fg_bounds[k] : -INFINITY;
    t.fg_probs[k] = k < c.n_fg ? c.fg_probs[k] : 0.0f;
  }
  t.go_row = c.n_go_dist + 1;
  t.go_cells = (c.n_go_ytg + 1) * t.go_row;
  return t;
}

struct StatePtrs {
  int* off;
  int* sec;
  int* down;
  float* dist;
  float* ytg;
  int* period;
  int* in_rz;
  int* sa;
  int* sb;
};

struct State {
  int off, sec, down;
  float dist, ytg;
  int period, in_rz, sa, sb;
};

struct Heads {
  float p_c, pass_mu, pass_sg, rush_mu, rush_sg, sack_mu, sack_sg;
};

// torch.clamp(x, lo, hi): hi where lo > hi
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ State load(const StatePtrs& p, int i) {
  return State{p.off[i], p.sec[i], p.down[i], p.dist[i], p.ytg[i],
               p.period[i], p.in_rz[i], p.sa[i], p.sb[i]};
}

__device__ __forceinline__ void store(const StatePtrs& p, int i, const State& s) {
  p.off[i] = s.off;
  p.sec[i] = s.sec;
  p.down[i] = s.down;
  p.dist[i] = s.dist;
  p.ytg[i] = s.ytg;
  p.period[i] = s.period;
  p.in_rz[i] = s.in_rz;
  p.sa[i] = s.sa;
  p.sb[i] = s.sb;
}

// models/analytic.py, one game at a time ------------------------------------

// `grid` is StepConsts::go_grid in shared memory
__device__ __forceinline__ float go_for_it_prob(const StepConsts& c, const Tables& t,
                                                const float* grid, float ytg, float dist,
                                                float sd, int sec) {
  int yi = 0, di = 0;  // torch.bucketize(right=False): edges below x
#pragma unroll
  for (int k = 0; k < kSlots; ++k) yi += ytg > t.go_ytg_edges[k];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) di += dist > t.go_dist_edges[k];
  float p = grid[yi * t.go_row + di];
  const bool late = sec < c.late_seconds;
  p = late && sd > 0.0f ? p * c.late_leading_scale : p;
  p = late && sd < 0.0f ? (ytg > c.late_trailing_long_fg_ytg ? c.late_trailing_go_long
                                                             : c.late_trailing_go_short)
                        : p;
  return clip(p, 0.0f, 1.0f);
}

__device__ __forceinline__ float field_goal_prob(const StepConsts& c, const Tables& t,
                                                 float attempt) {
  float p = c.fg_long_prob;
#pragma unroll
  for (int k = kSlots - 1; k >= 0; --k) p = attempt < t.fg_bounds[k] ? t.fg_probs[k] : p;
  return p;
}

__device__ float pass_prob_v1(const StepConsts& c, int down, float dist, float ytg,
                              int sec, float sd) {
  float base = 0.53f + (down == 1 ? 0.02f + 0.010f * fmaxf(dist - 10.0f, 0.0f) * c.r10 : 0.0f);
  base = base + (down == 2 ? 0.12f + 0.020f * fmaxf(dist - 7.0f, 0.0f) * c.r10 : 0.0f);
  base = base + (down == 3 ? 0.28f + 0.030f * fmaxf(dist - 5.0f, 0.0f) * c.r10 : 0.0f);
  base = base + (down == 4 ? 0.45f + 0.035f * fmaxf(dist - 3.0f, 0.0f) * c.r10 : 0.0f);
  base = base - (ytg <= 10.0f ? 0.05f : 0.0f);
  base = base - (ytg <= 5.0f ? 0.03f : 0.0f);
  const bool two_min = (sec % c.half_seconds) <= 120;
  base = base + (two_min && sd < 0.0f ? 0.22f : 0.0f);
  base = base + (sec < 600 && sd < 0.0f ? 0.06f : 0.0f);
  return clip(base, c.heuristic_clip_lo, c.heuristic_clip_hi);
}

__device__ float explosive_prob(const StepConsts& c, float ytg, float off_o, float def_d) {
  const float z = (off_o - def_d) * c.r_mismatch;
  float base = c.explosive[0] + c.explosive[1] * z;
  base = base + (ytg > 60.0f ? c.explosive[2] : 0.0f);
  base = base + (ytg > 40.0f ? c.explosive[3] : 0.0f);
  return clip(base, c.explosive[4], c.explosive[5]);
}

// rz_finish_prob_pass / _run with their constants in `m`
__device__ float rz_finish_prob(const StepConsts& c, const float* m, float ytg, int down,
                                float off_o, float def_d) {
  float base = m[0] + m[1] * fmaxf(7.0f - ytg, 0.0f) * c.r7;
  base = base + m[2] * static_cast<float>(max(4 - down, 0));
  const float tilt = m[3] * tanhf((off_o - def_d) * m[4]);
  return clip(base + tilt, m[5], m[6]);
}

// stage2_fallback_probs then stage2_nudge: (incomplete, sack) shares
__device__ void stage2(const StepConsts& c, int down, float dist, float* inc, float* sck) {
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
  *inc = p_inc / s;
  *sck = p_sck / s;
}

// the analytic stand-in heads of rep_arith
__device__ __forceinline__ Heads analytic_heads(const State& s) {
  const float bias = s.off == 0 ? 0.013f : -0.013f;
  return Heads{clip(0.68f - 0.022f * fmaxf(s.dist - 3.0f, 0.0f) + bias, 0.02f, 0.98f),
               4.5f + 0.45f * s.dist, 7.0f, 4.2f, 4.0f, -6.0f, 2.2f};
}

// probes/step_arith.step_arith for one game -----------------------------------

__device__ __forceinline__ State step_arith(const StepConsts& c, const Tables& tabs,
                                            const float* grid, const State& s,
                                            const float* u, const float* n, const Heads& h) {
  const bool active = s.sec > 0;
  const bool in_rz = s.in_rz != 0;
  const bool is_a = s.off == 0;
  const float ytg = s.ytg, dist = s.dist;
  const int down = s.down;
  const float sd = static_cast<float>(s.sa - s.sb) * (is_a ? 1.0f : -1.0f);

  const float off_o = is_a ? 35.7f : 31.5f;
  const float def_d = is_a ? 20.6f : 20.0f;
  const float ymult = is_a ? 1.01f : 0.99f;
  const float mz = is_a ? 0.11f : -0.11f;

  float s2c1, sck;
  stage2(c, down, dist, &s2c1, &sck);
  const float s2c2 = s2c1 + sck;
  const float p_pass = pass_prob_v1(c, down, dist, ytg, s.sec, sd);
  const float p_go = fminf(go_for_it_prob(c, tabs, grid, ytg, dist, sd, s.sec) * c.go_multiplier, 1.0f);
  const float p_fg = field_goal_prob(c, tabs, ytg + 17.0f);
  const float ep = explosive_prob(c, ytg, off_o, def_d);
  const float rzp = rz_finish_prob(c, c.rz_pass, ytg, down, off_o, def_d);
  const float rzr = rz_finish_prob(c, c.rz_run, ytg, down, off_o, def_d);

  // state machine, score-only
  const bool is4 = down == 4;
  const bool go = active && is4 && u[0] < p_go;
  const bool st_play = active && is4 && !go;
  const bool fg_att = st_play && ytg <= 38.0f;
  const bool punt = st_play && !fg_att;
  const bool scrim = active && !st_play;
  const bool fg_good = fg_att && u[1] < p_fg;
  const bool fg_miss = fg_att && !fg_good;
  const float gross = fmaxf(43.0f + 6.0f * n[0], 30.0f);
  const float pret = fmaxf(6.0f + 3.0f * n[1], 0.0f);
  float net = gross - pret;
  const float tb_p = clip((60.0f - ytg) * c.r60, 0.10f, 0.55f);
  const bool tb = ytg <= 60.0f && u[2] < tb_p;
  net = tb ? ytg - 25.0f : net;
  net = floorf(fminf(fmaxf(net, 15.0f), ytg - 1.0f));
  const float punt_spot = clip(100.0f - (ytg - net), 1.0f, 99.0f);
  const bool trip1 = scrim && !in_rz && ytg <= 20.0f;
  const bool is_pass = scrim && u[3] < p_pass;
  const bool is_run = scrim && !is_pass;
  const bool complete = is_pass && u[7] < h.p_c;
  const bool notc = is_pass && !complete;
  const bool o_inc = notc && u[11] < s2c1;
  const bool o_sck = notc && !o_inc && u[11] < s2c2;
  const bool o_int = notc && !o_inc && !o_sck;
  float py = fminf(fmaxf(h.pass_mu + h.pass_sg * n[2], 0.0f), ytg) * ymult;
  const bool expg = ytg > 25.0f && u[8] < 0.6f * ep;
  const float boost = 0.35f + u[9] * 0.6f;
  py = expg ? fminf(py * (1.0f + boost * (1.0f + 0.5f * mz)), ytg) : py;
  const bool rz_p = ytg <= 12.0f && down <= 3 && u[10] < rzp;
  py = rz_p ? ytg : py;
  const bool pass_td = complete && py + 1e-9f >= ytg;
  const bool pass_gain = complete && !pass_td;
  const float sy = clip(h.sack_mu + h.sack_sg * n[2], -20.0f, 0.0f);
  const float loss = fminf(fmaxf(-sy, 0.0f), ytg);
  const float ret = fminf(fmaxf(6.0f + 5.0f * n[3], 0.0f), ytg);
  const float int_spot = 100.0f - (ytg - ret);
  float ry = fminf(fmaxf(h.rush_mu + h.rush_sg * n[2], -4.0f), ytg) * ymult;
  const bool expr = ytg > 25.0f && u[8] < 0.5f * ep;
  ry = expr ? fminf(ry * (1.0f + boost), ytg) : ry;
  const bool rz_r = ytg <= 9.0f && down <= 3 && u[10] < rzr;
  ry = rz_r ? ytg : ry;
  const bool run_td = is_run && ry + 1e-9f >= ytg;
  const bool run_gain = is_run && !run_td;
  const bool adv = pass_gain || run_gain;
  const float gained = (pass_gain ? py : 0.0f) + (run_gain ? ry : 0.0f);
  float ytg_a = adv ? fmaxf(ytg - gained, 0.0f) : ytg;
  const bool first = adv && gained + 1e-6f >= dist;
  int down_a = adv ? (first ? 1 : down + 1) : down;
  float dist_a = adv ? (first ? 10.0f : dist - gained) : dist;
  const bool downs_to = adv && !first && down_a > 4;
  ytg_a = o_sck ? ytg + loss : ytg_a;
  dist_a = o_sck ? dist + loss : dist_a;
  down_a = (o_sck || o_inc) ? down + 1 : down_a;
  const bool flip_a = downs_to || o_int;
  const float spot_a = o_int ? int_spot : 100.0f - ytg_a;
  const int off_a = flip_a ? 1 - s.off : s.off;
  ytg_a = flip_a ? spot_a : ytg_a;
  down_a = flip_a ? 1 : down_a;
  dist_a = flip_a ? 10.0f : dist_a;
  const bool in_rz_a = !flip_a && (in_rz || trip1);
  const int t = fg_att * 6 + punt * 6 + pass_td * 20 + pass_gain * 26 + o_inc * 10 +
                o_sck * 24 + o_int * 12 + (run_td || run_gain) * 28;
  const int sec_b = max(s.sec - t, 0);
  const int period_b = sec_b > 0 ? 4 - (sec_b - 1) / 900 : 4;
  const bool halftime = active && period_b != s.period && period_b == 3;
  const int off_b = halftime ? 1 - off_a : off_a;
  const float ytg_b = halftime ? 75.0f : ytg_a;
  const int down_b = halftime ? 1 : down_a;
  const float dist_b = halftime ? 10.0f : dist_a;
  const bool in_rz_b = !halftime && in_rz_a;
  const bool flip_c = fg_good || fg_miss || punt || pass_td || run_td;
  const float spot_c = fg_miss ? 100.0f - ytg : (punt ? punt_spot : 75.0f);
  const int pts = (pass_td || run_td) * 7 + fg_good * 3;
  State o;
  o.off = flip_c ? 1 - off_b : off_b;
  o.sec = sec_b;
  o.down = flip_c ? 1 : down_b;
  o.dist = flip_c ? 10.0f : dist_b;
  o.ytg = flip_c ? spot_c : ytg_b;
  o.period = period_b;
  o.in_rz = !flip_c && in_rz_b;
  o.sa = s.sa + (is_a ? pts : 0);
  o.sb = s.sb + (is_a ? 0 : pts);
  return o;
}

// The go-for-it grid into shared memory; every thread of the block calls it
// before any returns.
__device__ __forceinline__ void load_grid(const StepConsts& c, const Tables& t, float* grid) {
  for (int k = threadIdx.x; k < t.go_cells; k += blockDim.x) grid[k] = c.go_grid[k];
  __syncthreads();
}

constexpr int kThreads = 128;
constexpr int kGridCells = 81;   // StepConsts::go_grid

// `in` and `out` may be the same arrays: each thread reads its game before
// it writes it.
__global__ void __launch_bounds__(kThreads, 8)
    fused_step_kernel(const StepConsts c, const Tables t, const StatePtrs in,
                      const StatePtrs out, uint32_t k0, uint32_t k1, uint32_t step_base,
                      int ch, int n) {
  __shared__ float grid[kGridCells];
  load_grid(c, t, grid);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t row = static_cast<uint32_t>(i);
  State s = load(in, i);
  for (int j = 0; j < ch; ++j) {
    float u[philox::kUniforms], z[philox::kNormals];
    philox::step_draws(k0, k1, step_base + static_cast<uint32_t>(j), row, u, z);
    s = step_arith(c, t, grid, s, u, z, analytic_heads(s));
  }
  store(out, i, s);
}

constexpr int kHeads = 7;
constexpr int kSlabFloats = kThreads * kHeads;   // a block's heads, 3,584 bytes
static_assert(kSlabFloats % 4 == 0, "a block's slab starts 16-byte aligned");

// heads: the (n, 7) row-major tensor of the 7 head vectors, 16-byte aligned.
__global__ void __launch_bounds__(kThreads, 8)
    fused_step_tab_kernel(const StepConsts c, const Tables t, const StatePtrs in,
                          const float* __restrict__ heads, const StatePtrs out,
                          uint32_t k0, uint32_t k1, uint32_t step, int n) {
  __shared__ float grid[kGridCells];
  __shared__ float4 slab4[kSlabFloats / 4];
  float* slab = reinterpret_cast<float*>(slab4);
  const int g0 = blockIdx.x * kThreads;
  const int floats = min(n - g0, kThreads) * kHeads;
  const float* src = heads + static_cast<long long>(g0) * kHeads;
  for (int k = threadIdx.x; k < floats / 4; k += kThreads)
    __pipeline_memcpy_async(&slab4[k], reinterpret_cast<const float4*>(src) + k, 16);
  for (int k = floats / 4 * 4 + threadIdx.x; k < floats; k += kThreads)
    __pipeline_memcpy_async(&slab[k], src + k, 4);
  __pipeline_commit();
  for (int k = threadIdx.x; k < t.go_cells; k += kThreads) grid[k] = c.go_grid[k];
  const int i = g0 + threadIdx.x;
  const State s = load(in, min(i, n - 1));   // in flight under the draws
  float u[philox::kUniforms], z[philox::kNormals];
  philox::step_draws(k0, k1, step, static_cast<uint32_t>(i), u, z);
  __pipeline_wait_prior(0);
  __syncthreads();
  if (i >= n) return;
  const float* m = slab + threadIdx.x * kHeads;   // stride 7: no bank conflicts
  const Heads h{m[0], m[1], m[2], m[3], m[4], m[5], m[6]};
  store(out, i, step_arith(c, t, grid, s, u, z, h));
}

StatePtrs state_ptrs(void* const* p) {
  return StatePtrs{static_cast<int*>(p[0]), static_cast<int*>(p[1]),
                   static_cast<int*>(p[2]), static_cast<float*>(p[3]),
                   static_cast<float*>(p[4]), static_cast<int*>(p[5]),
                   static_cast<int*>(p[6]), static_cast<int*>(p[7]),
                   static_cast<int*>(p[8])};
}

}  // namespace

extern "C" int fused_step_consts_size() { return static_cast<int>(sizeof(StepConsts)); }

// `ch` steps of n games from absolute step `step_base`.  in, out: 9 pointers
// each, in STATE_FIELDS order (int32 or float32 vectors of n).  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int fused_step_launch(const StepConsts* c, void* const* in, void* const* out,
                                 uint32_t k0, uint32_t k1, uint32_t step_base, int ch,
                                 int n, void* stream) {
  if (n <= 0) return 0;
  fused_step_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      *c, tables_of(*c), state_ptrs(in), state_ptrs(out), k0, k1, step_base, ch, n);
  return static_cast<int>(cudaGetLastError());
}

// One step with the 7 head vectors given: heads is 7 device pointers, head k
// of game i at heads[k][i * stride].  They must be the columns of one
// 16-byte-aligned (n, 7) tensor (stride 7, heads[k] == heads[0] + k), as
// table_select gives them; else it launches nothing and returns
// cudaErrorInvalidValue.
extern "C" int fused_step_tab_launch(const StepConsts* c, void* const* in,
                                     void* const* heads, int stride, void* const* out,
                                     uint32_t k0, uint32_t k1, uint32_t step, int n,
                                     void* stream) {
  if (n <= 0) return 0;
  const float* h0 = static_cast<const float*>(heads[0]);
  bool slab = stride == kHeads && reinterpret_cast<uintptr_t>(h0) % 16 == 0;
  for (int k = 1; k < kHeads; ++k) slab = slab && heads[k] == h0 + k;
  if (!slab) return static_cast<int>(cudaErrorInvalidValue);
  fused_step_tab_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      *c, tables_of(*c), state_ptrs(in), h0, state_ptrs(out), k0, k1, step, n);
  return static_cast<int>(cudaGetLastError());
}
