// Kernel K2: slice-sampler sweep for general (non-separable) densities.
//
// Replaces the TPU kernel pigeons_tpu/ops/pallas_slice.py:_sweep_kernel. Each
// lane (one replica of the batch) runs ONE asynchronous Neal slice machine,
// ENTER / INIT_R / DOUBLE / SHRINK / CHECK / DONE, through all n_passes * d
// coordinate steps of its sweep, with one density evaluation per loop
// iteration; its state x[d], its 23 machine variables, its own iteration
// counter and the density evaluation (densities.cuh, compiled in and selected
// by the template argument) all stay inside one launch. Two modes, as in the
// TPU kernel: full evaluation (every query costs one O(d) density evaluation
// of the state with coordinate c replaced) and, for a separable density,
// coordinate deltas (a query is answered as base + f_c(query), and the
// density of the final state is recomputed exactly).
//
// Bound on the H100. The kernel reads and writes B * d * 4 B once (123 KB for
// the funnel at B = 3,072, d = 10; 8 MB for the toy MVN at B = 20,480,
// d = 100), so memory is not the limit. The work is the lanes' sequential
// iterations, each a density evaluation and the machine's step: at the
// card's peak rates 0.0007 ms for the funnel sweep and 0.013 ms for the toy
// sweep in delta mode. With one thread per lane the funnel sweep is 96 warps
// on a card with 528 warp schedulers, and it is bound by the latency of one
// thread's dependent chain, some 4,500 cycles per iteration: nine IEEE
// divisions, a Cephes exp and two in-order sums, with nothing to hide them.
//
// What the design does about it. In full mode a lane is worked by a group of
// G threads of one warp (template argument: 1, 8, 16 or 32). All of them hold
// the whole machine and take every step, so nothing is ever broadcast; in a
// query thread g computes the density's terms of coordinates g, g + G, ...
// (densities.cuh: target_term, one division each for the funnel) into the
// group's buffer in shared memory, the group meets at __syncwarp(its mask),
// and every thread runs the short in-order sums over the buffer (finish), in
// the order and with the operations of one thread alone. What the terms need
// of coordinate 0 (prepare: the funnel's exp) is kept for the current state
// and recomputed only for a query of coordinate 0. ENTER's two draws and the
// log are computed at ENTER only, and one more hash an iteration serves
// DOUBLE or SHRINK, whichever the lane is in. The launcher picks G from the density, B and d
// (pick_group): groups only for densities whose terms cost something, the
// smallest group with one term per thread, fewer threads per lane once the
// batch's groups would no longer all be resident. Delta mode keeps one thread
// per lane (a delta query is O(1)), in rounds of iterations (below).
//
// The likelihoods of many terms (kHierarchicalNormal, kLogisticRegression:
// 200 observations each; kMrna: 150; and kEightSchoolsCentered's
// three sums) share more than the terms (ManyTerms). Every
// partial sum that XLA forms is added by a thread of its own, in its own
// order (the hierarchical normal's row partials, library.py: sum_by_rows;
// the logistic regression's windows of 32), the partials meet by
// __shfl_xor_sync / __shfl_sync in XLA's order, and every thread gets the
// total: a lane's critical path is the longest partial (50 or 32 adds), not
// one thread's 200. A lane keeps its current state's terms, each row
// partial's running value after every row, and each prior block's terms, in
// shared memory: a query of theta_trans[g] recomputes row g's terms only
// (without a division for the row's index) and resumes partial g mod P at
// row g; a query of any coordinate recomputes the prior block that holds it
// (resuming that block's sums at the coordinate, with their running values
// kept, was slower: 1.79 against 1.53 ms at 8,192 lanes, 128 registers). The shrink candidate's row, partials and
// block are kept apart and become the lane's when the machine accepts it; a
// coordinate that prepare reads (mu, log tau, log sigma) recomputes all. The
// logistic regression keeps each observation's logit over the coordinates
// before the sweep's coordinate c, one fused multiply-add on at every
// ENTER, and a query runs the chain from c on. mRNA's terms read all five
// parameters, but a query recomputes only its own parameter (one 10^q in
// double, prepare_query) and its prior block; the lane keeps each term's
// level over km0 and its residual, so that a query of km0 or sigma computes no
// exp, and a term before t0 none (its level is 0); its five windows of 32 are
// five threads' sums. Centred eight schools keeps its 3 J terms and each of
// its three sums' running values: a query of theta_j recomputes three terms
// in three threads and resumes each sum at j; its pseudo-prior block is C's
// sum (the same terms). The additions are the same, in the same order, so
// the bits are the twin's, which recomputes everything for every query.
//
// Under a variational reference a lane with G > 1 threads keeps its
// reference's d terms and their in-order sum's running values (RefTerms), on
// every density kind; the funnel and the banana keep their target's terms the
// same way, for the fixed reference too (KeptSums). A query of x_c then
// computes term c of each (one division each, for the funnel) and resumes
// both sums at c, where every thread used to compute all d reference terms
// and every target term; only a query of coordinate 0, which prepare reads,
// computes every target term, shared over the group. pick_group counts the
// reference's d terms with the target's. On the two-leg funnel (B = 768, d =
// 10, 1 pass): 0.1534 ms at the launcher's 32 threads a lane against 0.2214 ms
// for the sources before (tools/torch_kernel_variants.py --variational, in
// turns), and in builds of the same call that left one of them out (their
// switches are gone since) 0.2075 ms without RefTerms and 0.1850 ms without
// KeptSums; at B = 6,144 0.3462 ms (8 threads; 0.3287 ms at 16) against
// 0.5292 ms. Its clock64() split (-DPIGEONS_K2_CLOCKS): the slowest lane's
// 166 iterations take 0.712 us each (1,420 cycles: 27% the machine's steps,
// 23% the reference, 17% the sums, 16% the target's terms, 14% the draw) and
// account for 118 of the launch's 135 us; without RefTerms, 0.857 us (46% the
// sums with the reference's density). Hashing the next iteration's draws ahead while the
// density runs moved it by 1% (0.1517 ms) and took 1% at 6,144 lanes: not
// kept.
//
// Eight schools and unid (kSpeculate, speculated_sweep), the rows of the TPU
// kernel above with these two densities. Their paths launch K2 at 640 lanes
// (10 chains x 64 ladders, 1 pass) with queries of a few terms, some 20
// warps on 132 SMs: the launch lasts as long as the slowest
// lane's chain of dependent iterations, 131 for eight schools and 73 for
// unid at 2.1 us each (tools/torch_kernel_variants.py --speculate, clock64()
// split of the sources before, 278 and 153 us on the device), whatever the
// card's rates. But within a run of the machine (the doublings of a
// coordinate, its shrink rejections, its halvings) the queries do not
// depend on the densities, only where the run stops does: the draws are
// counter-based, hash(4 it + k) of the iteration alone. So a group of G
// threads evaluates the machine's next G queries, one a thread, the group
// shares the draws by a ballot and shuffles, each thread tests the machine's
// end-of-run condition at its own iteration with the densities of those
// before it, and the group takes the iterations up to the first that ends
// the run: the same bits as one thread taking them in turn. The slowest
// lane needs 26 rounds (eight schools, G = 16 or 32) and 5 (unid, G = 32) of
// about 3.2 us each: a query alone in one thread (eight schools' 8
// divisions in series, 65% of a round), the chain of brackets (20-25%), the
// ballots and shuffles. Device times at 640 lanes (NVIDIA H100 80GB HBM3,
// 700.00 W, the same tool and call, sources before in turns): eight schools
// 0.087 / 0.089 ms at G = 16 / 32 against 0.269, unid 0.023 ms at G = 32
// against 0.154; at 8,192 lanes, G = 8: 0.151 against 0.330 and 0.033
// against 0.146. Tried and dropped: slots of 8 threads sharing eight
// schools' 8 terms (0.097 ms at 4 slots, 0.36 at 8,192 lanes), terms kept
// for the current state (slower on both rows: the slowest lane's queries of
// mu and log tau recompute every term), each slot hashing the draws of the
// slots before it (a round 2x as long).
//
// The Bernoulli row (kBernoulli, 640 lanes, d = 1) is bound the same way:
// its slowest lane's 35 iterations of 1.86 us (the Beta block's log terms,
// the 10 adds and the blend in one thread, 63% of them; a sigmoid, log and
// log1p for every query) were 65 of a 69-us launch. On the speculated
// machine it takes 6 / 4 / 3 rounds of 2.5-2.9 us at G = 8 / 16 / 32: 18.8 /
// 14.4 / 13.2 us of device time against 68.1, and at phase 10's 10,000
// lanes 28.1 us at G = 8 against 106.0 (tools/torch_kernel_variants.py
// --speculate --rows bernoulli, NVIDIA H100 80GB HBM3, 700.00 W, the
// sources before in turns).
//
// Delta mode (lookahead_delta_sweep). Its one path, the invariance test,
// launches 10,000 lanes of d = 100 for 3 passes: 79 blocks of 128 threads,
// one warp to a scheduler on 79 of the 132 SMs, and the launch lasts as long
// as the slowest lane's 2,373 iterations, each some 740 cycles of one
// thread's dependent chain (a hash, ENTER's two draws and log whenever any
// lane of the warp enters a coordinate, the selects of every phase, a
// two-operation query). The speculated machine lost here at every G (1.34 /
// 1.55 / 3.41 / 7.24 ms at G = 4 / 8 / 16 / 32 against 0.77): its rounds
// were as few as counted, but with 4 or 8 lanes to a warp the groups'
// phases diverge and the warp runs every branch with its shuffles, and
// above 8 the batch's groups no longer fit at once. So delta mode keeps one
// thread a lane, which takes the lane's run in rounds of kDeltaSlots
// iterations: ENTER's draws and log and the iterations' draws hashed at
// once, then the iterations in turn by selects alone (no hash, no branch: a
// warp of lanes in different phases runs one instruction stream). 0.449 ms
// of device time at 2 iterations a round against 0.864 for the sources
// before (3 / 4 / 1 / 8: 0.450 / 0.511 / 0.561 / 0.631; the same round with
// branches on the phase 1.00-1.27 ms: a warp ran every branch; chains that
// read none of the recorded state, no gain; the same tool, --rows delta
// --delta-slots, in turns); its clock64() split: the slowest lane's 2,373
// iterations in 1,288 rounds of 806 cycles, 44% of them the iterations, 28%
// the hashes and ENTER. NVIDIA H100 80GB HBM3, 700.00 W.
//
// Layout. Input and output are the row-major [B, d] states. With one thread
// per lane a block of 128 lanes loads its contiguous [128, d] tile with
// coalesced reads into shared memory, transposed to [d][128], so that thread
// t reads its coordinate c at tile[c * 128 + t]: bank t whatever c is, hence
// no bank conflicts although every thread walks its own coordinate; the
// block shrinks to 64 or 32 lanes where d * 128 * 4 B would pass the 227 KB a
// block may use (d up to 1,816). With groups a block of 128 threads holds
// 128 / G lanes' states row-major and a term buffer each (d up to 227 G), or
// ManyTerms' buffers (twice the terms, the row partials and the prior blocks).
// Above 48 KB the shared memory is dynamic with the opt-in attribute.
//
// Array inputs. What the TPU kernel receives as hoisted array constants
// comes in DensityInputs, by value: a BayesianModel's prior as a table of
// blocks, its data as device pointers with lengths (DensityArrays), and for
// a variational run the lanes' isvar and the reference's mean, std and active
// as device pointers, so that no launch waits on the host. A block copies
// mean and std (with each coordinate's log norm, computed once) into shared
// memory behind the tile; the data arrays, a few KB that every lane reads,
// are read where they lie, through L1, whatever their size (a block's copy of
// the hierarchical normal's 800 B in shared memory bought nothing: 3.96 ms
// against 3.98 ms). A density's terms are its own range (densities.cuh:
// first_term, end_term): the observations of a BayesianModel, 200 for the
// hierarchical normal, shared out over the group like coordinates.
//
// Times (tools/torch_kernel_variants.py, NVIDIA H100 80GB HBM3, 700.00 W, one
// run). Funnel, B = 3,072, d = 10, 1 pass: G = 8 / 16 / 32 0.231 / 0.205 /
// 0.221 ms, G = 1 0.453 ms, the first version (one thread per lane, all four
// draws in every iteration) 0.446 ms; at B = 20,480 G = 8 / 16 0.481 /
// 0.594 ms against 0.542 ms for G = 1. Toy MVN in full mode, B = 20,480,
// d = 100: G = 1 1.63 ms, G = 32 7.11 ms (its terms are one multiply each).
// Delta mode, same shape: 0.392 ms against 0.410 ms for the first version.
// With the array inputs and ManyTerms (same tool, same card, medians of four
// turns): hierarchical normal, B = 8,192, d = 23: G = 1 / 8 / 16 / 32 10.43 /
// 1.55 / 2.04 / 2.82 ms (3.03 ms at G = 8 while every thread of a group
// repeated the prior and the 200-term sum), at B = 640 8.18 / 1.17 / 0.88 /
// 0.74 ms; logistic regression, 200 observations, d = 11: 15.66 / 2.82 /
// 2.27 / 1.98 ms at B = 8,192, 14.48 / 2.94 / 2.53 / 2.33 ms at B = 10,240,
// 10.91 / 1.82 / 1.02 / 0.63 ms at B = 640 (2.44, 2.78 and 0.74 ms before);
// the funnel at B = 3,072 0.260 ms against 0.238 ms for the sources without
// the variational branch. mRNA at B = 8,192: 1.87 ms at G = 8, 3.29 ms with
// the sources before its ManyTerms form; centred eight schools at B = 640:
// 0.340 against 0.520 ms at G = 32 (the same tool in turns). 53 to 126
// registers (tools/torch_build_report.py), no instance spills.
//
// Numerics follow the JAX kernel as XLA's CPU backend runs it, like kernel K1
// (banded_slice.cu): uniforms from chained murmur3 finalizers, -log(u) with
// the Cephes polynomial, the step-out old - w u and the shrink draw
// Lb + u (Rb - Lb) as fused multiply-adds. Build with --fmad=false so that
// nvcc fuses nothing else; the plain torch twin
// (pigeons_tpu_torch/ops/cuda_slice.py:sweep_reference) then gives the same
// bits.

#include "densities.cuh"

namespace {

using namespace pigeons;

constexpr int kThreads = 128;

// The lanes of warp mask that make up the group of G threads around `tid`.
template <int G>
__device__ __forceinline__ unsigned group_mask(int tid) {
  if constexpr (G == 32) {
    return kFullWarp;
  } else {
    return ((1u << G) - 1u) << ((tid & 31) / G * G);
  }
}

// What a launch hands the density besides the states: its parameters, its
// arrays, the prior table, and for a variational run the lanes' isvar [B], the
// reference's mean [d], std [d] and active [1] (all null otherwise).
struct DensityInputs {
  DensityParams params;
  DensityArrays arrays;
  PriorTable prior;
  const float *isvar, *mean, *std, *active;
};

// The parts of a lane's machine iteration that tools/torch_kernel_variants.py
// times with clock64() in a build with -DPIGEONS_K2_CLOCKS (never the
// product's): the draw (and ENTER's log), prepare, the target's terms, the
// group's __syncwarp, the in-order sums, the reference's density, and the
// machine's steps and branches.
enum ClockPart { kDraw, kPrepare, kTerms, kSync, kSums, kReference, kMachine, kClockParts };

#ifdef PIGEONS_K2_CLOCKS
constexpr int kClockLanes = 8192;
// per lane b < kClockLanes: cycles by part, then the loop's cycles, its
// nanoseconds and its passes (the machine's iterations, or the speculated
// machine's rounds)
constexpr int kClockColumns = kClockParts + 3;
__device__ unsigned long long k2_clocks[kClockLanes][kClockColumns];

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// A lane's reference density, kept term by term in shared memory with G > 1
// threads a lane: the variational reference's d terms for a lane under it
// (gauss), and for kFunnel and kBanana otherwise the fixed path's
// N(0, sigma^2 I), whose sum of squares runs over m_i = x_i / sigma. cur [d]
// holds the current state's terms, run [d] the in-order sum's value after
// each of them. A query of coordinate c computes term c (one division; every
// thread of the group computes it: in a warp that costs what one thread's
// does, and nothing needs to be broadcast) and resumes the sum at c: d - 1 - c
// adds where every thread used to compute d terms and add them. The shrink
// candidate's term is kept apart and becomes the lane's when it is accepted
// (commit). The additions are the twin's, in its order.
struct RefTerms {
  float* cur;
  float* run;
  int d;
  bool gauss;  // the variational reference; else the sum of squares of x / sigma
  VariationalLane var;
  float inv_sigma;
  float cand = 0.0f;  // the term at the last shrink candidate

  __device__ __forceinline__ float term(int i, float u) const {
    if (gauss) return variational_term(var, i, u);
    return u * inv_sigma;
  }
  __device__ __forceinline__ float add(float acc, float r) const {
    return gauss ? acc + r : __fmaf_rn(r, r, acc);
  }
  __device__ __forceinline__ float first(float r) const { return gauss ? r : r * r; }
  __device__ __forceinline__ float density(float acc) const { return gauss ? acc : acc * -0.5f; }

  // cur[i] for i = g, g + G, ...; the group meets at __syncwarp before resume(0)
  template <int G>
  __device__ __forceinline__ void terms(const float* xs, int g) {
    for (int i = g; i < d; i += G) cur[i] = term(i, xs[i]);
  }
  // run from coordinate c on, by every thread of the group alike
  __device__ __forceinline__ void resume(int c) {
    float acc = c == 0 ? first(cur[0]) : add(run[c - 1], cur[c]);
    run[c] = acc;
    for (int i = c + 1; i < d; ++i) run[i] = acc = add(acc, cur[i]);
  }
  __device__ __forceinline__ float total() const { return density(run[d - 1]); }
  // the density with coordinate c at u; slot 1 for the shrink candidate
  __device__ __forceinline__ float query(int c, float u, int slot) {
    const float r = term(c, u);
    if (slot == 1) cand = r;
    float acc = c == 0 ? first(r) : add(run[c - 1], r);
#pragma unroll 4  // the loads issue together; the adds stay in order
    for (int i = c + 1; i < d; ++i) acc = add(acc, cur[i]);
    return density(acc);
  }
  // The shrink candidate of coordinate c is the lane's; no thread of the
  // group may still be reading the kept values (the caller makes sure).
  __device__ __forceinline__ void commit(int c) {
    cur[c] = cand;
    resume(c);
  }
};

// Whether density K with G threads a lane keeps its target's terms (KeptSums).
template <Density K, int G>
constexpr bool kKeptSums = G > 1 && (K == kFunnel || K == kBanana);

// kFunnel and kBanana with G > 1 threads a lane. The target is coordinate 0's
// own term (prepare) plus the in-order sum of the terms of coordinates 1 ..
// d - 1, each a function of its coordinate and of what prepare computes from
// coordinate 0. The lane keeps those terms and the sum's running values for
// its current state, and its reference's (RefTerms): a query of x_c, c >= 1,
// computes term c (the funnel's: one division) and resumes both sums at c; a
// query of coordinate 0 computes every term, shared over the group as before.
// Buffers: tcur [d] the terms (from 1), trun [d] the running sums, tq [d] a
// query of coordinate 0's terms; then the reference's cur [d] and run [d].
template <Density K, int G>
struct KeptSums {
  static constexpr int kFloatsPerCoord = 5;
  float* xs;
  float* buf;
  int d, g;
  unsigned mask;
  RefTerms ref;
  float cand = 0.0f;  // the target's term at the last shrink candidate

  __device__ __forceinline__ float* tcur() const { return buf; }
  __device__ __forceinline__ float* trun() const { return buf + d; }
  __device__ __forceinline__ float* tq() const { return buf + 2 * d; }

  // the target's terms g + 1, g + 1 + G, ... of the state with coordinate c
  // (0, or -1 for none) at q
  __device__ __forceinline__ void target_terms(float* out, int c, float q, const Prepared& pr,
                                               const DensityParams& p) const {
    const LaneView s{xs, 1, c, q};
    for (int t = 1 + g; t < d; t += G) out[t] = target_term<K>(s, t, pr, p, DensityArrays{});
  }
  // trun from term `from` (>= 1) on
  __device__ __forceinline__ void resume(int from) {
    if (d < 2) return;
    float* tcur = this->tcur();
    float* trun = this->trun();
    float acc = from == 1 ? tcur[1] : trun[from - 1] + tcur[from];
    trun[from] = acc;
    for (int t = from + 1; t < d; ++t) trun[t] = acc = acc + tcur[t];
  }
  // finish's blend from the target's in-order sum and the reference's density
  __device__ __forceinline__ float blend(float beta, const Prepared& pr, float sum, float lref) const {
    float ltgt = pr.c + sum;
    if (ref.gauss) ltgt = 0.0f + ltgt;  // the fixed path at beta = 1
    return nan_to_neg_inf(interpolate(beta, lref, ltgt));
  }

  // the lane's current state from scratch (its start)
  __device__ __forceinline__ float init(const Prepared& pr, float beta, const DensityParams& p) {
    target_terms(tcur(), -1, 0.0f, pr, p);
    ref.terms<G>(xs, g);
    __syncwarp(mask);
    resume(1);
    ref.resume(0);
    return blend(beta, pr, d > 1 ? trun()[d - 1] : 0.0f, ref.total());
  }

  // the density with coordinate c at q, pr prepared for that state; slot 1
  // for the shrink candidate
  template <class Mark>
  __device__ __forceinline__ float evaluate(int c, float q, const Prepared& pr, int slot,
                                            float beta, const DensityParams& p,
                                            const Mark& mark) {
    float sum = 0.0f;  // sum_in_order(term, 1, d)
    if (c == 0) {
      float* tq = this->tq();
      target_terms(tq, 0, q, pr, p);
      mark(kTerms);
      __syncwarp(mask);
      mark(kSync);
      if (d > 1) sum = tq[1];
      for (int t = 2; t < d; ++t) sum = sum + tq[t];
    } else {
      const float tc = target_term<K>(LaneView{xs, 1, c, q}, c, pr, p, DensityArrays{});
      if (slot == 1) cand = tc;
      mark(kTerms);
      const float* tcur = this->tcur();
      sum = c == 1 ? tc : trun()[c - 1] + tc;
#pragma unroll 4  // the loads issue together; the adds stay in order
      for (int t = c + 1; t < d; ++t) sum = sum + tcur[t];
    }
    mark(kSums);
    const float lref = ref.query(c, q, slot);
    mark(kReference);
    if (c == 0) __syncwarp(mask);  // all have read tq before the next such query writes it
    return blend(beta, pr, sum, lref);
  }

  // The machine accepted the shrink candidate x_c = cand (pr_cur holds it):
  // it and its terms become the lane's; one of coordinate 0 changes every
  // target term, recomputed over the group. Queries of x_c, c >= 1, meet at
  // no __syncwarp, so a thread may be iterations ahead of another: x_c is
  // stored here, after every thread of the group has left the queries (and
  // ENTER's read of x_c) that read the kept values.
  __device__ __forceinline__ void commit(int c, float cand_x, const Prepared& pr_cur,
                                         const DensityParams& p) {
    __syncwarp(mask);
    xs[c] = cand_x;
    if (c == 0) {
      target_terms(tcur(), -1, 0.0f, pr_cur, p);
      __syncwarp(mask);
      resume(1);
    } else {
      tcur()[c] = cand;
      resume(c);
    }
    ref.commit(c);
  }
};

// Whether density K with G threads per lane runs the shared reduction of
// ManyTerms: the likelihoods of many terms, and centred eight schools' three sums.
template <Density K, int G>
constexpr bool kManyTerms = G > 1 && (K == kHierarchicalNormal || K == kLogisticRegression ||
                                      K == kMrna || K == kEightSchoolsCentered);

// A lane of a many-term density, worked by the G threads of its group: what
// each thread does in a query, and what the lane keeps of its current state
// in shared memory (lane_floats floats from buf):
//   blk [2][kMaxPriorBlocks]  each prior block's BlockTerms (lj, then lp)
//   kHierarchicalNormal       part_cur [n_main] the running value of a row's
//                             partial sum after that row; part_q [2][n_main] a
//                             query's (slot 0 for probes, 1 for the shrink
//                             candidate); row_q [2][n] a row query's terms;
//                             cur [n_terms] the terms; scratch [n_terms] a
//                             query's that changes every term
//   kLogisticRegression       scratch [n_terms] a query's terms; pre [n_terms]
//                             each observation's logit over the coordinates
//                             before the sweep's coordinate
//   kMrna                     scratch [n_terms] a query's terms; shape [2]
//                             [n_terms], resid [2][n_terms] each term's level
//                             over km0 and residual (mrna_shape, mrna_residual)
//                             at the current state (0) and the shrink
//                             candidate (1)
//   kEightSchoolsCentered     cur [3 J] the terms A, B, C; run [3 J] each sum's
//                             running value after each of its terms; scratch
//                             [3 J] a query's A terms
// and under a variational reference the reference's RefTerms, cur [d] and
// run [d], past them (base_floats).
template <Density K, int G>
struct ManyTerms {
  static_assert(kManyTerms<K, G>, "a density without many terms");
  float* xs;
  float* buf;  // blk [2][kMaxPriorBlocks], then the density's buffers
  int d, n_terms, g;
  unsigned mask;
  int n = 0, P = 1, n_main = 0;  // kHierarchicalNormal: a row's terms, the partial sums
                                 // (a power of 2), the rows they add
  BlockTerms cand{0.0f, 0.0f};  // the prior block's terms at the last shrink candidate
  RefTerms ref;                 // the variational reference's, for a lane under it

  static __device__ __host__ int base_floats(int d, int n_terms, const DensityParams& p) {
    if constexpr (K == kHierarchicalNormal) {
      const int R = d - 3, P = row_partials(R);
      return 2 * kMaxPriorBlocks + 3 * (R / P * P) + 2 * (int)p.v[1] + 2 * n_terms;
    }
    if constexpr (K == kEightSchoolsCentered) return 2 * kMaxPriorBlocks + 3 * n_terms;
    if constexpr (K == kMrna) return 2 * kMaxPriorBlocks + 5 * n_terms;
    return 2 * kMaxPriorBlocks + 2 * n_terms;
  }

  static __device__ __host__ int lane_floats(int d, int n_terms, const DensityParams& p,
                                             bool variational) {
    return base_floats(d, n_terms, p) + (variational ? 2 * d : 0);
  }

  __device__ ManyTerms(float* xs_, float* buf_, int d_, int n_terms_, int g_, unsigned mask_,
                       const DensityParams& p, const VariationalLane& var)
      : xs(xs_), buf(buf_), d(d_), n_terms(n_terms_), g(g_), mask(mask_),
        ref{buf_ + base_floats(d_, n_terms_, p), buf_ + base_floats(d_, n_terms_, p) + d_, d_,
            true, var, 0.0f} {
    if constexpr (K == kHierarchicalNormal) {
      n = (int)p.v[1];
      P = row_partials(d - 3);
      n_main = (d - 3) & -P;
    }
  }

  // The buffers, from buf (lane_floats).
  __device__ __forceinline__ float* blk() const { return buf; }
  __device__ __forceinline__ float* part_cur() const { return buf + 2 * kMaxPriorBlocks; }
  __device__ __forceinline__ float* part_q() const { return part_cur() + n_main; }
  __device__ __forceinline__ float* row_q() const { return part_q() + 2 * n_main; }
  __device__ __forceinline__ float* cur() const { return row_q() + 2 * n; }
  __device__ __forceinline__ float* run() const { return cur() + n_terms; }
  __device__ __forceinline__ float* scratch() const {
    if constexpr (K == kHierarchicalNormal) return cur() + n_terms;
    if constexpr (K == kEightSchoolsCentered) return run() + n_terms;
    return buf + 2 * kMaxPriorBlocks;
  }
  __device__ __forceinline__ float* pre() const { return scratch() + n_terms; }
  __device__ __forceinline__ float* shape(int slot) const { return scratch() + (1 + slot) * n_terms; }
  __device__ __forceinline__ float* resid(int slot) const { return scratch() + (3 + slot) * n_terms; }

  // The path's log density with coordinate c holding q (c < 0: the current
  // state, whose terms, partial sums and prior blocks it keeps). slot: 1 for
  // the shrink candidate, which commit() takes over, 0 else.
  __device__ __forceinline__ float evaluate(int c, float q, const Prepared& pr, int slot,
                                            float beta, const DensityInputs& in,
                                            const VariationalLane& var) {
    const LaneView s{xs, 1, c, q};
    const PriorTable& prior = in.prior;
    float* blk = this->blk();
    if (c < 0) {  // block k by thread k mod G; read after the likelihood's __syncwarp
      for (int k = g; k < prior.n; k += G) {
        const BlockTerms t = block_terms(s, prior.block[k]);
        blk[k] = t.lj;
        blk[kMaxPriorBlocks + k] = t.lp;
      }
      if (var.use) ref.terms<G>(xs, g);  // so are the reference's terms
    }
    float lik, sum_c = 0.0f;
    if constexpr (K == kHierarchicalNormal) {
      lik = row_likelihood(s, c, pr, slot, in);
    } else if constexpr (K == kEightSchoolsCentered) {
      lik = centred_likelihood(s, c, pr, in, &sum_c);
    } else if constexpr (K == kMrna) {
      mrna_terms(c, pr, slot, in);
      lik = window_sum();
    } else {
      lik = window_likelihood(s, c, in);
    }
    int kq = -1;
    BlockTerms bq{0.0f, 0.0f};
    if (c >= 0) {  // the query's block, by every thread
      kq = block_of(prior, c);
      if (K == kEightSchoolsCentered && kq == 0) {
        bq = {0.0f, sum_c};  // theta's pseudo-prior: its terms are C's (consistent())
      } else {
        bq = block_terms(s, prior.block[kq]);
      }
      if (slot == 1) cand = bq;
    }
    // finish's blend, with log_prior's sum from the blocks
    float lref = combine_prior(prior, blk, blk + kMaxPriorBlocks, kq, bq);
    float ltgt = lref + lik;
    if (var.use) {
      if (c < 0) ref.resume(0);
      lref = c < 0 ? ref.total() : ref.query(c, q, slot);
      ltgt = 0.0f + ltgt;
    }
    __syncwarp(mask);  // all have read the buffers before the next query writes them
    return nan_to_neg_inf(interpolate(beta, lref, ltgt));
  }

  // sum_by_rows. A query of theta_trans[c] recomputes row c's terms and
  // resumes partial c mod P from its value before row c; a query of a
  // coordinate that prepare reads recomputes every term (c < 0: into cur).
  __device__ __forceinline__ float row_likelihood(const LaneView& s, int c, const Prepared& pr,
                                                  int slot, const DensityInputs& in) {
    const int R = d - 3;
    const bool full = c < 0 || prepare_reads<K>(c, d);
    float* cur = this->cur();
    float* part_cur = this->part_cur();
    float* terms = c < 0 ? cur : scratch();
    float* row = row_q() + slot * n;
    float* parts = c < 0 ? part_cur : part_q() + slot * n_main;
    if (full) {  // term t = r n + j; r and j step on with t, without a division
      const int dr = G / n, dj = G % n;
      for (int t = g, r = g / n, j = g % n; t < n_terms; t += G, r += dr, j += dj) {
        if (j >= n) j -= n, ++r;
        terms[t] = group_term(s, r, t, pr, in.arrays);
      }
    } else {
      for (int j = g; j < n; j += G) row[j] = group_term(s, c, c * n + j, pr, in.arrays);
    }
    __syncwarp(mask);
    // row r's terms at the query
    const auto row_terms = [&](int r) -> const float* {
      return full ? terms + r * n : r == c ? row : cur + r * n;
    };
    // partial g: rows g, g + P, ... below n_main; the current value where none changed
    float mine = 0.0f;
    if (g < P) {
      const int from = full ? g : (c < n_main && (c & (P - 1)) == g) ? c : n_main;
      if (from >= n_main) {
        mine = part_cur[g + ((n_main - 1 - g) & -P)];
      } else {
        float acc = 0.0f;
        int j0 = 0;
        if (from >= P) {
          acc = part_cur[from - P];
        } else {  // the partial's first term
          acc = row_terms(from)[0];
          j0 = 1;
        }
        for (int r = from; r < n_main; r += P, j0 = 0) {
          const float* t = row_terms(r);
          for (int j = j0; j < n; ++j) acc = acc + t[j];
          parts[r] = acc;
        }
        mine = acc;
      }
    }
    // halving: lane l adds lane l + h's partial (the threads past P pair among themselves)
    for (int h = P / 2; h >= 1; h /= 2) mine = mine + __shfl_xor_sync(mask, mine, h, G);
    float acc = __shfl_sync(mask, mine, 0, G);
    for (int r = n_main; r < R; ++r) {
      const float* t = row_terms(r);
      for (int j = 0; j < n; ++j) acc = acc + t[j];
    }
    return acc;
  }

  // (A + B) - C, three in-order sums of J terms (finish), each by a thread
  // of its own (g = 0, 1, 2) from the lane's terms and running values: a
  // query of theta_c recomputes the three terms c, J + c, 2 J + c, and each
  // sum resumes at c; one of mu or log tau recomputes every term of A, whose
  // sum runs again, B's and C's totals stand. c < 0: every term, into cur and
  // run. *sum_c: C's total.
  __device__ __forceinline__ float centred_likelihood(const LaneView& s, int c,
                                                      const Prepared& pr,
                                                      const DensityInputs& in, float* sum_c) {
    const int J = d - 2;
    float* cur = this->cur();
    float* run = this->run();
    float mine = 0.0f;  // thread g < 3: sum g's total
    if (c < 0) {
      for (int t = g; t < n_terms; t += G) cur[t] = target_term<K>(s, t, pr, in.params, in.arrays);
      __syncwarp(mask);
      if (g < 3) {
        float acc = cur[g * J];
        run[g * J] = acc;
        for (int i = 1; i < J; ++i) run[g * J + i] = acc = acc + cur[g * J + i];
        mine = acc;
      }
    } else if (c < J) {
      if (g < 3) {
        const float t = target_term<K>(s, g * J + c, pr, in.params, in.arrays);
        float acc = c == 0 ? t : run[g * J + c - 1] + t;
#pragma unroll 8
        for (int i = c + 1; i < J; ++i) acc = acc + cur[g * J + i];
        mine = acc;
      }
    } else {
      float* scratch = this->scratch();
      for (int t = g; t < J; t += G) scratch[t] = target_term<K>(s, t, pr, in.params, in.arrays);
      __syncwarp(mask);
      if (g == 0) {
        float acc = scratch[0];
        for (int i = 1; i < J; ++i) acc = acc + scratch[i];
        mine = acc;
      } else if (g < 3) {
        mine = run[g * J + J - 1];
      }
    }
    const float a = __shfl_sync(mask, mine, 0, G);
    const float b = __shfl_sync(mask, mine, 1, G);
    *sum_c = __shfl_sync(mask, mine, 2, G);
    return (a + b) - *sum_c;
  }

  // mRNA's terms into scratch. Every term reads every parameter, but a query
  // of km0 (c = 1) leaves each term's shape (its level over km0) as it is, and
  // one of sigma (c = 4) its residual: the lane keeps both for its current
  // state (slot 0) and the shrink candidate (slot 1, which commit() takes
  // over), and such a query recomputes no exp. Thread g keeps the terms g,
  // g + G, ... .
  __device__ __forceinline__ void mrna_terms(int c, const Prepared& pr, int slot,
                                             const DensityInputs& in) {
    const float* ts = in.arrays.ptr[0];
    const float* ys = in.arrays.ptr[1];
    const int n_body = mrna_body(n_terms);
    float* scratch = this->scratch();
    float* shape_cur = shape(0);
    float* resid_cur = resid(0);
    const int keep = c < 0 ? 0 : slot == 1 ? 1 : -1;  // the slot this query's terms go to
    for (int t = g; t < n_terms; t += G) {
      float res;
      if (c == 4) {
        res = resid_cur[t];
      } else {
        const float tmt0 = ts[t] - pr.a;
        float sh = 0.0f;  // the residual before t0 is y, whatever the shape
        if (c == 1) {
          sh = shape_cur[t];
        } else if (!(tmt0 <= 0.0f)) {
          sh = mrna_shape(tmt0, pr);
        }
        res = mrna_residual(t, n_body, ys[t], tmt0, pr.b, sh);
        if (keep >= 0) {
          shape(keep)[t] = sh;
          resid(keep)[t] = res;
        }
      }
      scratch[t] = residual_term(res, pr.c, pr.e);
    }
    __syncwarp(mask);
  }

  // sum_by_windows(32) of scratch: thread w adds window w (w + G, ... where
  // there are more), the windows' sums are added in order.
  __device__ __forceinline__ float window_sum() const {
    const float* scratch = this->scratch();
    constexpr int W = 32;
    const int lead = ((W - n_terms % W) % W) / 2;
    const int n_windows = (n_terms + lead + W - 1) / W;
    float total = 0.0f;
    for (int w0 = 0; w0 < n_windows; w0 += G) {
      float mine = 0.0f;
      const int w = w0 + g;
      if (w < n_windows) {
        const int start = w * W - lead;
        const int end = start + W < n_terms ? start + W : n_terms;
#pragma unroll 8  // the loads of a window issue together; the adds stay in order
        for (int i = start < 0 ? 0 : start; i < end; ++i) mine = mine + scratch[i];
      }
      for (int k = 0; k < G && w0 + k < n_windows; ++k)
        total = total + __shfl_sync(mask, mine, k, G);
    }
    return total;
  }

  // The logistic regression's terms into scratch, then window_sum(). A query
  // of coordinate c runs each logit's chain of fused multiply-adds from c
  // on, from pre.
  __device__ __forceinline__ float window_likelihood(const LaneView& s, int c,
                                                     const DensityInputs& in) {
    const int n_w = d - 1;
    const float* X = in.arrays.ptr[0];
    const float* y = in.arrays.ptr[1];
    float* scratch = this->scratch();
    if (c < 0) {
      for (int t = g; t < n_terms; t += G)
        scratch[t] = target_term<K>(s, t, Prepared{}, in.params, in.arrays);
    } else {
      const float* pre = this->pre();
      for (int t = g; t < n_terms; t += G) {
        const float* row = X + t * n_w;
        float logit = c == 0 ? row[0] * s.q : c < n_w ? __fmaf_rn(row[c], s.q, pre[t]) : pre[t];
        for (int k = c + 1; k < n_w; ++k) logit = __fmaf_rn(row[k], xs[k], logit);
        logit = logit + (c == n_w ? s.q : xs[n_w]);
        scratch[t] = y[t] * logit - softplus(logit);
      }
    }
    __syncwarp(mask);
    return window_sum();
  }

  // At ENTER of coordinate c: pre becomes each logit's chain over the
  // coordinates before c, one step on from c - 1's.
  __device__ __forceinline__ void enter(int c, const DensityInputs& in) {
    if constexpr (K == kLogisticRegression) {
      if (c == 0) return;
      const int n_w = d - 1;
      float* pre = this->pre();
      for (int t = g; t < n_terms; t += G) {
        const float* row = in.arrays.ptr[0] + t * n_w;
        pre[t] = c == 1 ? row[0] * xs[0] : __fmaf_rn(row[c - 1], xs[c - 1], pre[t]);
      }
    }
  }

  // The machine accepted the shrink candidate of coordinate c (xs and pr_cur
  // hold it): its row, partial sums and prior block become the current ones.
  // A coordinate that prepare reads changes every term: recomputed. Centred
  // eight schools recomputes its 3 J terms and sums for any coordinate.
  __device__ __forceinline__ void commit(int c, const Prepared& pr_cur, float beta,
                                         const DensityInputs& in, const VariationalLane& var) {
    if constexpr (K == kEightSchoolsCentered) {
      evaluate(-1, 0.0f, pr_cur, 0, beta, in, var);
      return;
    }
    if constexpr (K == kMrna) {
      if (c != 4) {
        for (int t = g; t < n_terms; t += G) {
          shape(0)[t] = shape(1)[t];
          resid(0)[t] = resid(1)[t];
        }
      }
    }
    if constexpr (K == kHierarchicalNormal) {
      if (prepare_reads<K>(c, d)) {
        evaluate(-1, 0.0f, pr_cur, 0, beta, in, var);
        return;
      }
      float* cur = this->cur();
      float* part_cur = this->part_cur();
      const float* row = row_q() + n;
      const float* parts = part_q() + n_main;
      for (int j = g; j < n; j += G) cur[c * n + j] = row[j];
      for (int r = c + g * P; r < n_main; r += G * P) part_cur[r] = parts[r];
    }
    const int k = block_of(in.prior, c);
    blk()[k] = cand.lj;
    blk()[kMaxPriorBlocks + k] = cand.lp;
    if (var.use) ref.commit(c);
    __syncwarp(mask);
  }
};

// Whether density K with G threads a lane runs the speculated machine
// (speculated_sweep): eight schools, unid and Bernoulli, whose queries are a
// few terms.
template <Density K>
constexpr bool kSpeculated = K == kEightSchools || K == kUnid || K == kBernoulli;
template <Density K, int G>
constexpr bool kSpeculate = G > 1 && kSpeculated<K>;

// Floats of a lane's buffers past its state with G > 1 threads per lane:
// ManyTerms' or KeptSums', none for the speculated machine, else the target's
// terms and, under a variational reference, its RefTerms.
template <Density K, int G>
__device__ __host__ inline int buffer_floats(int d, int n_terms, const DensityParams& p,
                                             bool variational) {
  if constexpr (kSpeculate<K, G>) return 0;
  if constexpr (kManyTerms<K, G>) return ManyTerms<K, G>::lane_floats(d, n_terms, p, variational);
  if constexpr (kKeptSums<K, G>) return KeptSums<K, G>::kFloatsPerCoord * d;
  return G == 1 ? 0 : n_terms + (variational ? 2 * d : 0);
}

// Blocks of kThreads that an SM must be able to hold at once: the compiler
// keeps each thread's registers within 65,536 / (kThreads * kMinBlocks). The
// logistic regression's groups otherwise take 133 registers, four blocks an
// SM, and at 8,192 lanes take 3.03 ms against 2.07 ms with 80 registers
// (tools/torch_kernel_variants.py; 64 registers spill, 0.72 against 0.64 ms
// at 640 lanes); the hierarchical normal's 117 were as fast as 80.
template <Density K, int G>
constexpr int kMinBlocks = kManyTerms<K, G> && K == kLogisticRegression ? 6 : 1;

// What a lane's sweep hands back: its density and its three stats.
struct LaneResult {
  float lp, acc_sum, acc_n, n_evals;
};

// The slice machine of one lane, run by its group of G threads in rounds of
// speculated queries (kSpeculate). A run of the machine's iterations, the
// ENTER + INIT_R + DOUBLE steps of a coordinate, a run of SHRINK rejections
// or one of CHECK halvings, goes on while the density values say so, but its
// queries do not depend on them: iteration it draws hash(4 it + k) whatever
// happened before, a doubling grows the side its own draw names, a rejected
// candidate becomes the bracket's end on its side of old, a halving keeps the
// half that holds cand. So thread s of the group (its slot) computes the
// query the machine would make s iterations on, should none of the
// iterations before it end the run: it draws its own iteration's uniform,
// the group shares them (a ballot of the doublings' sides, a shuffle of each
// shrink draw), and every thread runs the chain of brackets of all G steps
// and keeps its own. The slots evaluate their queries together, a whole
// density each (log_density, the twin's form), each tests the machine's own
// condition for the end of the run at its iteration (with the densities of
// the slots before it, by shuffles), and the group takes the first slot that
// ends it (a ballot), or all of them. Every thread then holds the machine's
// state after that slot's iteration, read from that slot, and the counter
// it, n_evals and acc_n advance by the iterations taken: the same bits as the
// machine of one thread, iteration for iteration, as every query and step
// takes the machine's operations. The slots after the first that ends a run
// are discarded.
template <Density K, int G, class Mark>
__device__ LaneResult speculated_sweep(float* xs, int g, unsigned mask, int d, float beta,
                                       const DensityInputs& in, const VariationalLane& var,
                                       uint32_t hash_base, float W, float narrow_w, int p,
                                       int n_steps, int max_iter, const Mark& mark) {
  const int s = g;  // this thread's slot: iteration it + s of the round
  const int base = (int)(threadIdx.x & 31) - g;  // the group's first lane in its warp
  const DensityParams& params = in.params;
  const auto from = [&](float v, int slot) { return __shfl_sync(mask, v, slot, G); };
  // one bit a slot, from a ballot of the group
  const auto slots = [&](bool v) {
    const unsigned bits = __ballot_sync(mask, v) >> base;
    return G == 32 ? bits : bits & ((1u << G) - 1u);
  };
  // the first slot that ends the run, else the last
  const auto taken = [](unsigned ends) { return ends ? __ffs((int)ends) - 1 : G - 1; };

  Prepared pr_cur = prepare<K>(LaneView{xs, 1, -1, 0.0f}, d, params, in.prior);
  // the density with coordinate c (if any) at q
  const auto density = [&](int c, float q) {
    const LaneView v{xs, 1, c, q};
    const Prepared pr = c >= 0 && prepare_reads<K>(c, d)
                            ? prepare_query<K>(pr_cur, v, d, params, in.prior)
                            : pr_cur;
    return log_density<K>(v, d, beta, pr, params, in.arrays, in.prior, var);
  };
  const auto degenerate = [](float lb, float rb) {
    const float aL = fabsf(lb), aR = fabsf(rb);
    const float mx = (isnan(aL) || isnan(aR)) ? NAN : fmaxf(aL, aR);
    return fabsf(rb - lb) <= mx * 3.5e-4f;
  };

  float lp_cur = density(-1, 0.0f);
  mark(kClockParts);  // the loop's clocks alone
  float old = 0.f, z = 0.f, L = 0.f, R = 0.f, lpL = 0.f, lpR = 0.f, Lb = 0.f, Rb = 0.f;
  float cand = 0.f, lp_cand = 0.f, Lh = 0.f, Rh = 0.f, lpLh = 0.f, lpRh = 0.f;
  float acc_sum = 0.f, acc_n = 0.f, n_evals = 0.f;
  int phase = n_steps > 0 ? ENTER : DONE;
  int j = 0, c = 0, K_dbl = 0, n_shr = 0;  // j: coordinate steps done, c = j % d
  uint32_t it = 0;
  const auto next_coordinate = [&](bool accepted) {
    if (accepted) {
      lp_cur = lp_cand;
      if (prepare_reads<K>(c, d))
        pr_cur = prepare_query<K>(pr_cur, LaneView{xs, 1, c, cand}, d, params, in.prior);
      __syncwarp(mask);  // no thread of the group still reads x_c
      xs[c] = cand;      // every thread stores the same value
      acc_sum += 1.0f;
    }
    j += 1;
    c = c + 1 == d ? 0 : c + 1;
    phase = j >= n_steps ? DONE : ENTER;
  };

  while (phase != DONE) {
    mark(kMachine);
    if (phase == ENTER) {
      const uint32_t ctr = 4u * it;
      old = xs[c];
      z = lp_cur - (-cephes_logf(draw(hash_base, ctr + 1u)));
      L = __fmaf_rn(draw(hash_base, ctr), -W, old);
      R = L + W;
    }
    // This slot's query q. Every thread runs the chain of all slots' steps and
    // keeps its own: lo, hi the bracket after its step (a doubling run, a
    // CHECK run) or before its candidate (a SHRINK run, every candidate before
    // it rejected); last_lo, last_hi the latest steps up to it that set lpL,
    // lpR (lpLh, lpRh); to_left whether its halving keeps the left half.
    const int first = phase;  // ENTER, INIT_R or DOUBLE: the kind of step 0
    float q = 0.0f, lo = 0.0f, hi = 0.0f;
    int last_lo = -1, last_hi = -1;
    bool to_left = false;
    if (phase <= DOUBLE) {
      // step i: ENTER (query L, sets lpL), INIT_R (R, lpR) or DOUBLE (the
      // side its draw names: one draw a slot, the sides by a ballot)
      const int kind_s = min(first + s, DOUBLE);
      const bool left_s =
          kind_s == ENTER || (kind_s == DOUBLE && draw(hash_base, 4u * (it + s) + 2u) <= 0.5f);
      const unsigned lefts = slots(left_s);
      float Li = L, Ri = R;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int kind = min(first + i, DOUBLE);
        const bool left = lefts >> i & 1u;
        const float span = Ri - Li;
        const float qi = kind == DOUBLE ? (left ? Li - span : Ri + span) : kind == ENTER ? Li : Ri;
        if (kind == DOUBLE) {
          if (left) Li = qi;
          else Ri = qi;
        }
        if (i <= s) {
          if (left) last_lo = i;
          else last_hi = i;
        }
        if (i == s) q = qi, lo = Li, hi = Ri;
      }
    } else if (phase == SHRINK) {
      // one draw a slot, shared by shuffles
      const float u = draw(hash_base, 4u * (it + s) + 3u);
      float lbi = Lb, rbi = Rb;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float qi = __fmaf_rn(from(u, i), rbi - lbi, lbi);
        if (i == s) q = qi, lo = lbi, hi = rbi;
        if (qi < old) lbi = qi;
        else rbi = qi;
      }
    } else {  // CHECK: halve towards cand while its half is wider than narrow_w
      float lhi = Lh, rhi = Rh;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float Mi = (lhi + rhi) * 0.5f;
        const bool left = cand < Mi;
        if (left) rhi = Mi;
        else lhi = Mi;
        if (i <= s) {
          if (left) last_hi = i;
          else last_lo = i;
        }
        if (i == s) q = Mi, to_left = left, lo = lhi, hi = rhi;
      }
    }
    mark(kDraw);
    const float lp = density(c, q);
    mark(kTerms);
    // the densities of the latest steps that set each side; every thread
    // takes part in every shuffle
    const float lp_lo = from(lp, max(last_lo, 0)), lp_hi = from(lp, max(last_hi, 0));
    int n_taken;
    if (phase <= DOUBLE) {
      const float lpL_s = last_lo >= 0 ? lp_lo : lpL;
      const float lpR_s = last_hi >= 0 ? lp_hi : lpR;
      const int K_s = first < DOUBLE ? p - (s - (INIT_R - first)) : K_dbl - (s + 1);
      const unsigned ends = slots(min(first + s, DOUBLE) != ENTER &&
                                  !(K_s > 0 && ((z < lpL_s) || (z < lpR_s))));
      n_taken = taken(ends) + 1;
      L = from(lo, n_taken - 1);
      R = from(hi, n_taken - 1);
      lpL = from(lpL_s, n_taken - 1);
      lpR = from(lpR_s, n_taken - 1);
      mark(kSync);
      if (first + n_taken - 1 > ENTER)
        K_dbl = first < DOUBLE ? p - (n_taken - 1 - (INIT_R - first)) : K_dbl - n_taken;
      if (ends) {  // start_shrink
        Lb = L;
        Rb = R;
        n_shr = 0;
        phase = SHRINK;
      } else {
        phase = first + n_taken - 1 == ENTER ? INIT_R : DOUBLE;
      }
    } else if (phase == SHRINK) {
      const bool consider = z < lp;
      if (!consider) {  // the bracket after this slot's rejection
        if (q < old) lo = q;
        else hi = q;
      }
      const bool bail = !consider && (degenerate(lo, hi) || n_shr + s + 1 >= max_iter);
      const unsigned ends = slots(consider || bail);
      n_taken = taken(ends) + 1;
      Lb = from(lo, n_taken - 1);
      Rb = from(hi, n_taken - 1);
      cand = from(q, n_taken - 1);
      lp_cand = from(lp, n_taken - 1);
      mark(kSync);
      n_shr += n_taken;
      if (z < lp_cand) {
        acc_n += 1.0f;
        if ((R - L) <= narrow_w) {
          next_coordinate(true);
        } else {  // to_check
          Lh = L;
          Rh = R;
          lpLh = lpL;
          lpRh = lpR;
          phase = CHECK;
        }
      } else if (ends) {  // bail
        next_coordinate(false);
      }
    } else {
      const bool crossed = (old < q) != to_left;
      const float lpLh_s = last_lo >= 0 ? lp_lo : lpLh;
      const float lpRh_s = last_hi >= 0 ? lp_hi : lpRh;
      const bool chk_rej = crossed && (z >= lpLh_s) && (z >= lpRh_s);
      const unsigned rejects = slots(chk_rej);
      const unsigned ends = slots(chk_rej || !((hi - lo) > narrow_w));
      n_taken = taken(ends) + 1;
      Lh = from(lo, n_taken - 1);
      Rh = from(hi, n_taken - 1);
      lpLh = from(lpLh_s, n_taken - 1);
      lpRh = from(lpRh_s, n_taken - 1);
      mark(kSync);
      if (rejects >> (n_taken - 1) & 1u) {
        if (cand < old) Lb = cand;
        else Rb = cand;
        if (degenerate(Lb, Rb) || n_shr >= max_iter) next_coordinate(false);
        else phase = SHRINK;
      } else if (ends) {
        next_coordinate(true);
      }
    }
    it += (uint32_t)n_taken;
    n_evals += (float)n_taken;
  }
  return {lp_cur, acc_sum, acc_n, n_evals};
}

// Iterations of a run whose draws the delta machine of one thread hashes at
// once (lookahead_delta_sweep; 1, 3, 4 and 8 were slower on the H100).
constexpr int kDeltaSlots = 2;

// The slice machine of one lane in delta mode, by one thread, in rounds of
// up to S iterations of one run (speculated_sweep's runs). A round hashes
// ENTER's two draws, its log and the S draws of the run's next iterations
// at once, whatever the lane's phase, then takes the iterations in turn, up
// to the first that ends the run, with no hash and no branch on the phase in
// the chain: each computes its query and the machine's step of each kind
// (a doubling, a shrink candidate, a halving) and keeps the one of the run.
// An iteration's query is delta_base + (a q) q. The same bits as the machine
// iteration by iteration; the draws of iterations past the run's end are
// discarded. After the sweep the final state's density is recomputed whole.
// Its clock64() parts (PIGEONS_K2_CLOCKS) stand for other work than the
// generic machine's: kDraw is a round's hashes and ENTER's selects, kTerms
// its iterations, kMachine the run's end.
template <int S, class Mark>
__device__ LaneResult lookahead_delta_sweep(float* xs, int stride, int d, float beta,
                                            const DensityInputs& in, const VariationalLane& var,
                                            uint32_t hash_base, float W, float narrow_w, int p,
                                            int n_steps, int max_iter, const Mark& mark) {
  const DensityParams& params = in.params;
  const float a = toy_coord_factor(beta, params.v[0], params.v[1]);
  const auto full_density = [&] {
    const LaneView v{xs, stride, -1, 0.0f};
    return log_density<kToyMvn>(v, d, beta, prepare<kToyMvn>(v, d, params, in.prior), params,
                                in.arrays, in.prior, var);
  };
  const auto degenerate = [](float lb, float rb) {
    const float aL = fabsf(lb), aR = fabsf(rb);
    const float mx = isnan(aL) | isnan(aR) ? NAN : fmaxf(aL, aR);
    return fabsf(rb - lb) <= mx * 3.5e-4f;
  };

  float lp_cur = full_density();
  mark(kClockParts);  // the loop's clocks alone
  float old = 0.f, z = 0.f, L = 0.f, R = 0.f, lpL = 0.f, lpR = 0.f, Lb = 0.f, Rb = 0.f;
  float cand = 0.f, lp_cand = 0.f, Lh = 0.f, Rh = 0.f, lpLh = 0.f, lpRh = 0.f, base = 0.f;
  float acc_sum = 0.f, acc_n = 0.f, n_evals = 0.f;
  int phase = n_steps > 0 ? ENTER : DONE;
  int j = 0, c = 0, K_dbl = 0, n_shr = 0;  // j: coordinate steps done, c = j % d
  uint32_t it = 0;

  while (phase != DONE) {
    mark(kMachine);  // the run's end
    const int first = phase;  // the run's kind: ENTER, INIT_R or DOUBLE, SHRINK, CHECK
    const bool dbl_run = first <= DOUBLE, shr_run = first == SHRINK, chk_run = first == CHECK;
    const uint32_t ctr = 4u * it;
    // ENTER's u_init, u_z and -log u_z, and slot s's doubling side (draw 2)
    // or shrink candidate (draw 3) of iteration it + s
    const float u_init = draw(hash_base, ctr), e_z = -cephes_logf(draw(hash_base, ctr + 1u));
    const uint32_t kind_draw = shr_run ? 3u : 2u;
    float u[S];
#pragma unroll
    for (int s = 0; s < S; ++s) u[s] = draw(hash_base, ctr + 4u * s + kind_draw);
    const bool is_enter = first == ENTER;
    const float xc = xs[c * stride];
    old = is_enter ? xc : old;
    z = is_enter ? lp_cur - e_z : z;
    L = is_enter ? __fmaf_rn(u_init, -W, old) : L;
    R = is_enter ? L + W : R;
    base = is_enter ? lp_cur - quadratic_term(a, old) : base;
    mark(kDraw);  // the hashes and ENTER
    // iteration it + s is the machine's while no iteration before it ended the
    // run; every step below is a select, every test evaluates all its terms
    bool ended = false, considered = false, chk_rejected = false;
    int n_taken = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool take = !ended;
      n_taken = take ? s + 1 : n_taken;
      // a doubling run: ENTER (query L, sets lpL), INIT_R (R, lpR), DOUBLE
      const int kind = min(first + s, DOUBLE);
      const bool left = (kind == ENTER) | ((kind == DOUBLE) & (u[s] <= 0.5f));
      const float span = R - L;
      const float q_dbl = kind == DOUBLE ? (left ? L - span : R + span) : kind == ENTER ? L : R;
      // a shrink run: the candidate; a CHECK run: the halving towards cand
      const float q_shr = __fmaf_rn(u[s], Rb - Lb, Lb);
      const float M = (Lh + Rh) * 0.5f;
      const bool to_left = cand < M;
      const float lp = base + quadratic_term(a, dbl_run ? q_dbl : shr_run ? q_shr : M);

      const bool dbl = take & dbl_run;
      L = dbl & (kind == DOUBLE) & left ? q_dbl : L;
      R = dbl & (kind == DOUBLE) & !left ? q_dbl : R;
      lpL = dbl & left ? lp : lpL;
      lpR = dbl & !left ? lp : lpR;
      K_dbl = !dbl ? K_dbl : kind == INIT_R ? p : kind == DOUBLE ? K_dbl - 1 : K_dbl;
      const bool end_dbl = (kind != ENTER) & !((K_dbl > 0) & ((z < lpL) | (z < lpR)));

      const bool shr = take & shr_run;
      const bool in_slice = z < lp;
      cand = shr ? q_shr : cand;
      lp_cand = shr ? lp : lp_cand;
      considered = shr ? in_slice : considered;
      Lb = shr & !in_slice & (q_shr < old) ? q_shr : Lb;
      Rb = shr & !in_slice & !(q_shr < old) ? q_shr : Rb;
      const bool end_shr = in_slice | degenerate(Lb, Rb) | (n_shr + s + 1 >= max_iter);

      const bool chk = take & chk_run;
      Rh = chk & to_left ? M : Rh;
      Lh = chk & !to_left ? M : Lh;
      lpRh = chk & to_left ? lp : lpRh;
      lpLh = chk & !to_left ? lp : lpLh;
      const bool rej = ((old < M) != to_left) & (z >= lpLh) & (z >= lpRh);
      chk_rejected = chk ? rej : chk_rejected;
      const bool end_chk = rej | !((Rh - Lh) > narrow_w);

      ended = ended | (dbl_run ? end_dbl : shr_run ? end_shr : end_chk);
    }
    mark(kTerms);  // the iterations
    it += (uint32_t)n_taken;
    n_evals += (float)n_taken;
    // the run's end, by selects: a doubling run starts the shrink; a shrink
    // candidate in the slice is accepted or checked; CHECK accepts or rejects
    const bool start_shrink = dbl_run & ended;
    const bool narrow = (R - L) <= narrow_w;
    const bool to_check = shr_run & considered & !narrow;
    const bool rejected = chk_run & chk_rejected;
    const bool accepted = (shr_run & considered & narrow) | (chk_run & ended & !rejected);
    Lb = start_shrink ? L : rejected & (cand < old) ? cand : Lb;
    Rb = start_shrink ? R : rejected & !(cand < old) ? cand : Rb;
    n_shr = start_shrink ? 0 : shr_run ? n_shr + n_taken : n_shr;
    const bool bail = (shr_run & ended & !considered) |
                      (rejected & (degenerate(Lb, Rb) | (n_shr >= max_iter)));
    Lh = to_check ? L : Lh;
    Rh = to_check ? R : Rh;
    lpLh = to_check ? lpL : lpLh;
    lpRh = to_check ? lpR : lpRh;
    acc_n += shr_run & considered ? 1.0f : 0.0f;
    if (accepted) xs[c * stride] = cand;
    lp_cur = accepted ? lp_cand : lp_cur;
    acc_sum += accepted ? 1.0f : 0.0f;
    const bool finish = accepted | bail;
    j += finish ? 1 : 0;
    c = !finish ? c : c + 1 == d ? 0 : c + 1;
    phase = finish    ? (j >= n_steps ? DONE : ENTER)
            : dbl_run ? (ended ? SHRINK : first + n_taken - 1 == ENTER ? INIT_R : DOUBLE)
            : (shr_run & !to_check) | rejected ? SHRINK
                                               : CHECK;
  }
  // the deltas drift by float32 rounding over the sweep: the exactly
  // recomputed density of the final state, as the TPU kernel hands back
  return {full_density(), acc_sum, acc_n, n_evals};
}

template <Density K, bool kDelta, int G>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<K, G>))
slice_sweep_kernel(const float* __restrict__ x, const float* __restrict__ betas,
                   const int64_t* __restrict__ seeds, float* __restrict__ x_out,
                   float* __restrict__ lp_out, float* __restrict__ stats, int B, int d,
                   DensityInputs in, float W, float narrow_w, int p, int n_passes,
                   int max_iter) {
  static_assert(G == 1 || !kDelta, "delta mode runs one thread a lane");
  // G == 1: the states [d][T], coordinate-major. G > 1: the states [T / G][d],
  // then each group's buffers [T / G][lane_floats] (buffer_floats). Then the
  // variational reference's mean, std and log norms [3][d].
  float* shared = dynamic_shared();
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lanes_per_block = T / G;
  const int64_t lane0 = (int64_t)blockIdx.x * lanes_per_block;
  const int n_here = (int)min((int64_t)lanes_per_block, (int64_t)B - lane0);
  const int n_tile = n_here * d;
  const DensityParams& params = in.params;
  const int n_terms = end_term<K>(d, params);
  const bool variational = in.isvar != nullptr;
  const int lane_floats = buffer_floats<K, G>(d, n_terms, params, variational);
  for (int i = tid; i < n_tile; i += T)
    shared[G == 1 ? (i % d) * T + i / d : i] = x[lane0 * d + i];
  float* var_arrays = shared + (G == 1 ? T * d : lanes_per_block * (d + lane_floats));
  if (variational) {
    for (int i = tid; i < d; i += T) {
      const float sd = in.std[i];
      var_arrays[i] = in.mean[i];
      var_arrays[d + i] = sd;
      var_arrays[2 * d + i] = gaussian_log_norm(sd);
    }
  }
  __syncthreads();

  const int group = tid / G;  // the block's lane this thread works for
  const int g = tid % G;      // its place in the group
  if (group < n_here) {
    const int64_t b = lane0 + group;
    float* xs = G == 1 ? shared + tid : shared + group * d;
    const int stride = G == 1 ? T : 1;  // coordinate c of this lane is xs[c * stride]
    [[maybe_unused]] float* terms = shared + lanes_per_block * d + group * lane_floats;
    [[maybe_unused]] const unsigned mask = group_mask<G>(tid);
    const float beta = betas[b];
    const uint32_t hash_base = fmix32((uint32_t)seeds[b] ^ 0x9E3779B9u);
    const VariationalLane var{variational && in.isvar[b] > 0.0f && in.active[0] > 0.0f,
                              var_arrays, var_arrays + d, var_arrays + 2 * d};

#ifdef PIGEONS_K2_CLOCKS
    long long clk_acc[kClockParts] = {};
    long long clk_last = 0, clk0 = 0, clk_passes = 0;
    unsigned long long ns0 = 0;
    // mark(part): the cycles since the last mark go to part (a pass of the
    // loop starts, and the loop ends, with kMachine); mark(kClockParts): the
    // loop starts, and what came before is not counted
    const auto mark = [&](int part) {
      const long long now = clock64();
      if (part == kClockParts) {
        for (int k = 0; k < kClockParts; ++k) clk_acc[k] = 0;
        ns0 = global_ns();
        clk0 = now;
        clk_passes = -1;  // the mark after the loop is no pass
      } else {
        clk_acc[part] += now - clk_last;
        clk_passes += part == kMachine;
      }
      clk_last = now;
    };
#else
    const auto mark = [](int) {};
#endif

    float lp_cur, acc_sum, acc_n, n_evals;
    if constexpr (kDelta) {
      static_assert(K == kToyMvn, "no coordinate term for this density");
      const LaneResult r = lookahead_delta_sweep<kDeltaSlots>(xs, stride, d, beta, in, var,
                                                              hash_base, W, narrow_w, p,
                                                              n_passes * d, max_iter, mark);
      lp_cur = r.lp, acc_sum = r.acc_sum, acc_n = r.acc_n, n_evals = r.n_evals;
    } else if constexpr (kSpeculate<K, G>) {
      const LaneResult r = speculated_sweep<K, G>(xs, g, mask, d, beta, in, var, hash_base, W,
                                                  narrow_w, p, n_passes * d, max_iter, mark);
      lp_cur = r.lp, acc_sum = r.acc_sum, acc_n = r.acc_n, n_evals = r.n_evals;
    } else {
      // kept for the lane's current state, recomputed for a query of a coordinate
      // that prepare reads
      Prepared pr_cur = prepare<K>(LaneView{xs, stride, -1, 0.0f}, d, params, in.prior);
      const auto prepared_from_cur = [&](int c, float q) {
        return prepare_query<K>(pr_cur, LaneView{xs, stride, c, q}, d, params, in.prior);
      };
      [[maybe_unused]] auto many = [&] {
        if constexpr (kManyTerms<K, G>) {
          return ManyTerms<K, G>(xs, terms, d, n_terms, g, mask, params, var);
        } else if constexpr (kKeptSums<K, G>) {
          return KeptSums<K, G>{xs, terms, d, g, mask,
                                RefTerms{terms + 3 * d, terms + 4 * d, d, var.use, var,
                                         params.v[0]}};
        } else {
          return 0;
        }
      }();
      // the other densities' reference terms under a variational reference
      [[maybe_unused]] RefTerms ref{terms + n_terms, terms + n_terms + d, d, true, var, 0.0f};

      // The density of the lane's state with coordinate c (if any) holding q;
      // slot 1 for the shrink candidate (ManyTerms, KeptSums and RefTerms keep
      // its terms). Every thread of the group calls it at the same point and
      // gets the same bits: thread g computes the terms g, g + G, ..., and all
      // of them run the in-order sums over the group's buffer, or ManyTerms
      // shares them out, or KeptSums and RefTerms resume their sums at c.
      auto evaluate = [&](int c, float q, const Prepared& pr, [[maybe_unused]] int slot) {
        const LaneView s{xs, stride, c, q};
        if constexpr (kManyTerms<K, G>) {
          return many.evaluate(c, q, pr, slot, beta, in, var);
        } else if constexpr (kKeptSums<K, G>) {
          return c < 0 ? many.init(pr, beta, params)
                       : many.evaluate(c, q, pr, slot, beta, params, mark);
        } else if constexpr (G == 1) {
          return log_density<K>(s, d, beta, pr, params, in.arrays, in.prior, var);
        } else {
          for (int t = first_term<K> + g; t < n_terms; t += G)
            terms[t] = target_term<K>(s, t, pr, params, in.arrays);
          if (var.use && c < 0) ref.terms<G>(xs, g);
          mark(kTerms);
          __syncwarp(mask);
          mark(kSync);
          const float lp = finish<K>(s, [&](int t) { return terms[t]; }, d, beta, pr, params,
                                     in.prior, var, [&] {
                                       if (c < 0) ref.resume(0);
                                       return c < 0 ? ref.total() : ref.query(c, q, slot);
                                     });
          mark(kSums);
          __syncwarp(mask);  // all have read the terms before the next query overwrites them
          return lp;
        }
      };
      lp_cur = evaluate(-1, 0.0f, pr_cur, 0);
      float old = 0.f, z = 0.f, L = 0.f, R = 0.f, lpL = 0.f, lpR = 0.f, Lb = 0.f, Rb = 0.f;
      float cand = 0.f, lp_cand = 0.f, Lh = 0.f, Rh = 0.f, lpLh = 0.f, lpRh = 0.f;
      acc_sum = 0.f, acc_n = 0.f, n_evals = 0.f;
      const int n_steps = n_passes * d;
      int phase = n_steps > 0 ? ENTER : DONE;
      int j = 0, c = 0, K_dbl = 0, n_shr = 0;  // j: coordinate steps done, c = j % d
      mark(kClockParts);  // the loop's clocks alone

      for (uint32_t it = 0; phase != DONE; ++it) {
        mark(kMachine);
        // draws 4 it + (0: u_init, 1: u_z, 2: u_side, 3: u_shr). ENTER uses the
        // first two and the log, DOUBLE the third, SHRINK the fourth, INIT_R and
        // CHECK none: one hash outside ENTER serves whichever phase the lane is in
        const uint32_t ctr = 4u * it;
        const bool is_enter = phase == ENTER;
        const bool ph_dbl = phase == DOUBLE;
        const bool ph_shr = phase == SHRINK;
        const float xc = xs[c * stride];
        if (is_enter) {
          if constexpr (kManyTerms<K, G>) many.enter(c, in);
          old = xc;
          z = lp_cur - (-cephes_logf(draw(hash_base, ctr + 1u)));
          L = __fmaf_rn(draw(hash_base, ctr), -W, old);
          R = L + W;
        }
        const float u = draw(hash_base, ctr + (ph_dbl ? 2u : 3u));
        const bool grow_left = u <= 0.5f;
        const float span = R - L;
        const float dbl_q = grow_left ? L - span : R + span;
        const float cand_draw = __fmaf_rn(u, Rb - Lb, Lb);
        const float M = (Lh + Rh) * 0.5f;
        const float query = is_enter           ? L
                            : phase == INIT_R  ? R
                            : ph_dbl           ? dbl_q
                            : ph_shr           ? cand_draw
                            : phase == CHECK   ? M
                                               : old;

        mark(kDraw);

        const Prepared pr_q = prepare_reads<K>(c, d) ? prepared_from_cur(c, query) : pr_cur;
        mark(kPrepare);
        const float lp_q = evaluate(c, query, pr_q, ph_shr ? 1 : 0);
        mark(kTerms);
        n_evals += 1.0f;

        if (is_enter) lpL = lp_q;
        const bool ph_initr = phase == INIT_R;
        if (ph_initr) {
          lpR = lp_q;
          K_dbl = p;
        }
        if (ph_dbl) {
          if (grow_left) {
            L = dbl_q;
            lpL = lp_q;
          } else {
            R = dbl_q;
            lpR = lp_q;
          }
          K_dbl -= 1;
        }
        const bool more_dbl = (K_dbl > 0) && ((z < lpL) || (z < lpR));
        const bool start_shrink = (ph_initr || ph_dbl) && !more_dbl;
        if (start_shrink) {
          Lb = L;
          Rb = R;
          n_shr = 0;
        }

        if (ph_shr) {
          cand = cand_draw;
          lp_cand = lp_q;
          n_shr += 1;
        }
        const bool consider = ph_shr && (z < lp_q);
        acc_n += consider ? 1.0f : 0.0f;
        const bool narrow = (R - L) <= narrow_w;
        const bool accept_shr = consider && narrow;
        const bool to_check = consider && !narrow;
        if (to_check) {
          Lh = L;
          Rh = R;
          lpLh = lpL;
          lpRh = lpR;
        }

        const bool ph_chk = phase == CHECK;
        const bool take_left = cand < M;
        const bool crossed = (old < M) != take_left;
        if (ph_chk) {
          if (take_left) {
            Rh = M;
            lpRh = lp_q;
          } else {
            Lh = M;
            lpLh = lp_q;
          }
        }
        const bool chk_rej = ph_chk && crossed && (z >= lpLh) && (z >= lpRh);
        const bool chk_more = ph_chk && !chk_rej && ((Rh - Lh) > narrow_w);
        const bool accept_chk = ph_chk && !chk_rej && !chk_more;

        const bool rejected = (ph_shr && !consider) || chk_rej;
        if (rejected) {
          if (cand < old) Lb = cand;
          else Rb = cand;
        }
        const float aL = fabsf(Lb), aR = fabsf(Rb);
        const float mx = (isnan(aL) || isnan(aR)) ? NAN : fmaxf(aL, aR);
        const bool degenerate = fabsf(Rb - Lb) <= mx * 3.5e-4f;
        const bool bail = rejected && (degenerate || n_shr >= max_iter);

        const bool accepted = accept_shr || accept_chk;
        if (accepted) {
          // every thread of the group stores the same value, and reads it back
          // in its own program order
          lp_cur = lp_cand;
          if (prepare_reads<K>(c, d)) pr_cur = prepared_from_cur(c, cand);
          if constexpr (kKeptSums<K, G>) {
            many.commit(c, cand, pr_cur, params);  // stores x_c once no thread reads it
          } else {
            xs[c * stride] = cand;
            if constexpr (kManyTerms<K, G>) {
              many.commit(c, pr_cur, beta, in, var);
            } else if constexpr (G > 1) {
              // evaluate's last __syncwarp: no thread still reads the kept terms
              if (var.use) ref.commit(c);
            }
          }
        }
        acc_sum += accepted ? 1.0f : 0.0f;

        if (accepted || bail) {
          j += 1;
          c = c + 1 == d ? 0 : c + 1;
          phase = j >= n_steps ? DONE : ENTER;
        } else if (is_enter) {
          phase = INIT_R;
        } else if (more_dbl && (ph_initr || ph_dbl)) {
          phase = DOUBLE;
        } else if (start_shrink || (rejected && !bail)) {
          phase = SHRINK;
        } else if (to_check || chk_more) {
          phase = CHECK;
        }
      }
    }
    if (g == 0) {
      lp_out[b] = lp_cur;
      stats[b] = acc_sum;
      stats[(int64_t)B + b] = acc_n;
      stats[2 * (int64_t)B + b] = n_evals;
    }
#ifdef PIGEONS_K2_CLOCKS
    mark(kMachine);
    if (g == 0 && b < kClockLanes) {
      for (int k = 0; k < kClockParts; ++k) k2_clocks[b][k] = clk_acc[k];
      k2_clocks[b][kClockParts] = clock64() - clk0;
      k2_clocks[b][kClockParts + 1] = global_ns() - ns0;
      k2_clocks[b][kClockParts + 2] = clk_passes;
    }
#endif
  }

  __syncthreads();
  for (int i = tid; i < n_tile; i += T)
    x_out[lane0 * d + i] = shared[G == 1 ? (i % d) * T + i / d : i];
}

// Shared memory of one block, with `extra` floats past the lanes' states (the
// variational reference's 3 d). With one thread per
// lane a state per thread, and the block shrinks to 64 or 32 lanes where 128
// states would not fit (d up to 1,816); with a group per lane a state and its
// lane_floats of buffers (buffer_floats) for each group of a 128-thread
// block. 0: too large.
size_t shared_bytes(int group, int d, int lane_floats, size_t extra, int* threads) {
  *threads = kThreads;
  size_t floats = (size_t)(kThreads / group) * ((size_t)d + lane_floats);
  if (group == 1) {
    while (*threads > 32 && ((size_t)d * *threads + extra) * sizeof(float) > kMaxSharedBytes)
      *threads /= 2;
    floats = (size_t)d * *threads;
  }
  const size_t bytes = (floats + extra) * sizeof(float);
  return bytes > kMaxSharedBytes ? 0 : bytes;
}

struct SweepArgs {
  const float *x, *betas;
  const int64_t* seeds;
  float *x_out, *lp_out, *stats;
  int B, d;
  DensityInputs in;
  float w;
  int p, n_passes, max_iter;
  cudaStream_t stream;
};

template <Density K, bool kDelta, int G>
int launch(SweepArgs a) {
  const bool variational = a.in.isvar != nullptr;
  const int lane_floats =
      buffer_floats<K, G>(a.d, end_term<K>(a.d, a.in.params), a.in.params, variational);
  const size_t var_floats = variational ? (size_t)3 * a.d : 0;
  int threads;
  const size_t shared = shared_bytes(G, a.d, lane_floats, var_floats, &threads);
  if (shared == 0) return -2;  // d too large for a lane's state in shared memory
  auto kernel = slice_sweep_kernel<K, kDelta, G>;
  const cudaError_t err = allow_shared_bytes(kernel, shared);
  if (err != cudaSuccess) return (int)err;
  const int lanes_per_block = threads / G;
  const unsigned blocks = (unsigned)(((int64_t)a.B + lanes_per_block - 1) / lanes_per_block);
  PIGEONS_LAUNCH(kernel, blocks, threads, shared, a.stream, a.x, a.betas, a.seeds, a.x_out,
                 a.lp_out, a.stats, a.B, a.d, a.in, a.w, 1.1f * a.w, a.p, a.n_passes,
                 a.max_iter);
  return (int)cudaGetLastError();
}

// Threads that an H100 keeps resident: 132 SMs of 2,048.
constexpr int64_t kResidentThreads = 132 * 2048;

// Whether a term costs about as much as the rest of a query (a division and a
// few multiply-adds), and not many times that (logistic regression: a dot
// product and a softplus).
template <Density K>
constexpr bool cheap_terms = K != kLogisticRegression;

// Threads per lane in full mode, from the density and the shape. One thread
// where there is nothing to share out: a density whose terms are one multiply
// each (the sums of squares), or a single term. Else the smallest group that
// gives every thread at most one term (32 at most). With cheap terms it is
// halved down to 8 while the batch's groups would fill more than a quarter
// of the card: every thread of a group takes the machine's steps, and
// groups of four lanes to a warp issue them once for four (hierarchical
// normal, tools/torch_kernel_variants.py: B = 8,192: 8 / 16 / 32 threads
// 1.99 / 2.38 / 3.12 ms, B = 640: 1.46 / 1.03 / 0.84 ms), and one thread
// again where even groups of 8 would overfill it. Dear terms keep 32 at any
// batch: a lane's terms are nearly all its work (logistic regression, 8 / 16
// / 32 threads: 1.83 / 1.03 / 0.66 ms at B = 640, 2.96 / 2.33 / 2.04 at
// 8,192, 2.99 / 2.59 / 2.38 at 10,240). mRNA's terms (an exp, an expm1 and
// two divisions) are cheap by this measure: at its path's B = 8,192, 1 / 8 /
// 16 / 32 threads take 11.55 / 1.87 / 2.05 / 2.20 ms (before its ManyTerms
// form 18.17 / 2.75 / 2.87 / 3.19), so the rule's 8 stands; centred eight
// schools at its B = 640 0.861 / 0.424 / 0.379 / 0.340 ms (the rule's 32).
// The two-leg funnel, 9 target
// and 10 reference terms: 1 / 8 / 16 / 32 threads 0.479 / 0.189 / 0.174 /
// 0.153 ms at its B = 768 (the rule's 32), 0.815 / 0.336 / 0.329 / 0.366 ms
// at 6,144 (the rule's 8). (NVIDIA H100 80GB HBM3, 700.00 W.) One thread also
// where the group's buffers do not fit. Eight schools, unid and Bernoulli
// speculate a query a thread: the most threads while the batch's groups fill
// at most a quarter of the card, as above (device times, eight schools, unid
// and Bernoulli at B = 640: 1 / 8 / 16 / 32 threads 0.30 / 0.108 / 0.087 /
// 0.089, 0.154 / 0.037 / 0.026 / 0.023 and 0.0665 / 0.0188 / 0.0144 / 0.0132
// ms; at 8,192, 8 threads 0.151 and 0.033 ms, 32 threads 0.49 and 0.036;
// Bernoulli at 10,000 0.0940 / 0.0281 / 0.0364 / 0.0948 ms). Before it
// speculated, Bernoulli took 0.088 / 0.089 / 0.087 / 0.087 ms at 640.
template <Density K>
int pick_group(int B, int d, const DensityParams& params, bool variational) {
  const int n_all_terms = end_term<K>(d, params);
  const int n_target = n_all_terms - first_term<K>;
  if (kSpeculated<K>) {  // slots of speculated queries
    int group = 32;
    while (group > 8 && (int64_t)B * group > kResidentThreads / 4) group /= 2;
    return (int64_t)B * group > kResidentThreads ? 1 : group;
  }
  if (K == kToyMvn || K == kMvn || n_target <= 1) return 1;
  // a lane under a variational reference has its d terms besides
  const int n_terms = n_target + (variational ? d : 0);
  int group = n_terms <= 8 ? 8 : n_terms <= 16 ? 16 : 32;
  if (cheap_terms<K>) {
    while (group > 8 && (int64_t)B * group > kResidentThreads / 4) group /= 2;
    if ((int64_t)B * group > kResidentThreads) return 1;
  }
  int threads;
  if (shared_bytes(group, d, buffer_floats<K, 8>(d, n_all_terms, params, variational),
                   (size_t)3 * d, &threads) == 0)
    return 1;
  return group;
}

template <Density K>
int launch_full(const SweepArgs& a, int group) {
  if (!group) group = pick_group<K>(a.B, a.d, a.in.params, a.in.isvar != nullptr);
  switch (group) {
    case 1: return launch<K, false, 1>(a);
    case 8: return launch<K, false, 8>(a);
    case 16: return launch<K, false, 16>(a);
    case 32: return launch<K, false, 32>(a);
  }
  return -1;
}

// Whether the state's width, the arrays' lengths and the prior table are what
// density kind `density` reads: the kernel checks no index.
bool consistent(int density, int d, const DensityInputs& in) {
  const int* n = in.arrays.n;
  const bool bayesian = density >= kHierarchicalNormal;
  if (!bayesian) return in.prior.n == 0 && n[0] + n[1] + n[2] + n[3] == 0;
  if (in.prior.n < 1) return false;
  int covered = 0;
  for (int k = 0; k < in.prior.n; ++k) {
    const PriorBlock& b = in.prior.block[k];
    if (b.offset != covered || b.size < 1 || b.dist < kNormal || b.dist > kBeta ||
        (b.dist == kBeta && b.bijector != kInterval) ||
        b.bijector < kIdentity || b.bijector > kInterval)
      return false;
    covered += b.size;
  }
  if (covered != d) return false;
  switch (density) {
    case kHierarchicalNormal: {
      const int per = (int)in.params.v[1];
      return d > 3 && per >= 1 && n[0] == (d - 3) * per && n[1] + n[2] + n[3] == 0;
    }
    case kEightSchools:
      return d > 2 && n[0] == d - 2 && n[1] == d - 2 && n[2] == d - 2 && n[3] == 0;
    case kUnid: return d == 2 && n[0] + n[1] + n[2] + n[3] == 0;
    case kLogisticRegression: {
      const int n_obs = (int)in.params.v[1];
      return d > 1 && n_obs >= 1 && n[0] == n_obs * (d - 1) && n[1] == n_obs && n[2] + n[3] == 0;
    }
    case kBernoulli: {
      const int n_obs = (int)in.params.v[1];
      return d == 1 && n_obs >= 1 && n[0] == n_obs && n[1] + n[2] + n[3] == 0;
    }
    case kEightSchoolsCentered: {  // theta's block first, the pseudo-prior's N(0, 20)
      const PriorBlock& b = in.prior.block[0];
      return d > 2 && n[0] == d - 2 && n[1] == d - 2 && n[2] == d - 2 && n[3] == 0 &&
             b.size == d - 2 && b.dist == kNormal && b.bijector == kIdentity && b.p[0] == 0.0f &&
             b.p[1] == in.params.v[1] && b.p[2] == in.params.v[2];
    }
    case kMrna: {  // five parameters, each on a Uniform block of its own
      const int n_obs = (int)in.params.v[1];
      if (d != 5 || in.prior.n != 5 || n_obs < 1 || n[0] != n_obs || n[1] != n_obs ||
          n[2] + n[3] != 0)
        return false;
      for (int k = 0; k < 5; ++k)
        if (in.prior.block[k].dist != kUniform || in.prior.block[k].bijector != kInterval)
          return false;
      return true;
    }
    default: return false;
  }
}

}  // namespace

#ifdef PIGEONS_K2_CLOCKS
// The last launch's clock64() split of lanes 0 .. n_lanes - 1 (at most
// kClockLanes), copied to the host array out [n_lanes][kClockColumns]:
// cycles by ClockPart, then the loop's cycles, its nanoseconds and its passes.
extern "C" int k2_clock_split(unsigned long long* out, int n_lanes) {
  if (n_lanes > kClockLanes) return -1;
  return (int)cudaMemcpyFromSymbol(out, k2_clocks,
                                   sizeof(unsigned long long) * kClockColumns * n_lanes);
}
#endif

// x, betas, seeds, x_out, lp_out, stats: device pointers of the [B, d] float32
// states, the [B] float32 annealing parameters, the [B] int64 lane seeds
// (uint32 values), the [B, d] float32 output states, the [B] float32 output
// densities and the [3, B] float32 stats (accept_sum, accept_n, n_evals).
// density is a Density of densities.cuh and params its kMaxDensityParams
// float32 parameters in host memory; coord_deltas selects delta mode.
// arrays and array_lens, both in host memory, are the kMaxDensityArrays device
// pointers of the density's float32 arrays and their lengths (null and 0 for
// the ones it does not have); prior, in host memory, is the prior table's
// n_prior rows of 8 floats (offset, size, distribution, bijector, p[0..3]).
// isvar [B], mean [d], std [d] and active [1] are device pointers of a
// variational run's lanes and reference, all null otherwise. group is the
// number of threads per lane in full mode (1, 8, 16 or 32),
// or 0 for the launcher's choice from the density, B and d; delta mode always
// runs one.
// Launches on `stream`. Returns cudaGetLastError(), or -1 for
// a density, mode, group or set of arrays the kernel does not have, -2 for a d
// whose state does not fit.
extern "C" int slice_sweep(const float* x, const float* betas, const int64_t* seeds, float* x_out,
                           float* lp_out, float* stats, int B, int d, int density,
                           int coord_deltas, const float* params, const float* const* arrays,
                           const int* array_lens, const float* prior, int n_prior,
                           const float* isvar, const float* mean, const float* std,
                           const float* active, float w, int p, int n_passes, int max_iter,
                           int group, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (d < 1 || n_prior < 0 || n_prior > kMaxPriorBlocks) return -1;
  const bool variational = isvar != nullptr;
  if (variational != (mean != nullptr) || variational != (std != nullptr) ||
      variational != (active != nullptr))
    return -1;
  SweepArgs a{x, betas, seeds, x_out, lp_out, stats, B, d, {}, w, p, n_passes, max_iter,
              (cudaStream_t)stream};
  for (int i = 0; i < kMaxDensityParams; ++i) a.in.params.v[i] = params[i];
  for (int i = 0; i < kMaxDensityArrays; ++i) {
    a.in.arrays.ptr[i] = arrays ? arrays[i] : nullptr;
    a.in.arrays.n[i] = arrays ? array_lens[i] : 0;
    if (a.in.arrays.n[i] < 0 || (a.in.arrays.n[i] > 0) != (a.in.arrays.ptr[i] != nullptr)) return -1;
  }
  a.in.prior.n = n_prior;
  for (int k = 0; k < n_prior; ++k) {
    const float* row = prior + 8 * k;
    a.in.prior.block[k] = {(int)row[0], (int)row[1], (int)row[2], (int)row[3],
                           {row[4], row[5], row[6], row[7]}};
  }
  a.in.isvar = isvar, a.in.mean = mean, a.in.std = std, a.in.active = active;
  if (!consistent(density, d, a.in)) return -1;
  if (coord_deltas) {
    if (density != kToyMvn || group > 1 || variational) return -1;
    return launch<kToyMvn, true, 1>(a);
  }
  switch (density) {
    case kToyMvn: return launch_full<kToyMvn>(a, group);
    case kFunnel: return launch_full<kFunnel>(a, group);
    case kBanana: return launch_full<kBanana>(a, group);
    case kMvn: return launch_full<kMvn>(a, group);
    case kHierarchicalNormal: return launch_full<kHierarchicalNormal>(a, group);
    case kEightSchools: return launch_full<kEightSchools>(a, group);
    case kUnid: return launch_full<kUnid>(a, group);
    case kLogisticRegression: return launch_full<kLogisticRegression>(a, group);
    case kBernoulli: return launch_full<kBernoulli>(a, group);
    case kEightSchoolsCentered: return launch_full<kEightSchoolsCentered>(a, group);
    case kMrna: return launch_full<kMrna>(a, group);
    default: return -1;
  }
}

// The number of threads a lane that slice_sweep's launcher picks in full mode
// (group = 0) for B lanes of width d of density kind `density` with params
// (host memory), with or without a variational reference; -1 for a kind the
// kernel does not have. A sharded run launches the kernel on its own block of
// lanes, so its launches may run another group than the whole batch's.
extern "C" int slice_sweep_group(int B, int d, int density, const float* params,
                                 int variational) {
  DensityParams v{};
  for (int i = 0; i < kMaxDensityParams; ++i) v.v[i] = params[i];
  const bool var = variational != 0;
  switch (density) {
    case kToyMvn: return pick_group<kToyMvn>(B, d, v, var);
    case kFunnel: return pick_group<kFunnel>(B, d, v, var);
    case kBanana: return pick_group<kBanana>(B, d, v, var);
    case kMvn: return pick_group<kMvn>(B, d, v, var);
    case kHierarchicalNormal: return pick_group<kHierarchicalNormal>(B, d, v, var);
    case kEightSchools: return pick_group<kEightSchools>(B, d, v, var);
    case kUnid: return pick_group<kUnid>(B, d, v, var);
    case kLogisticRegression: return pick_group<kLogisticRegression>(B, d, v, var);
    case kBernoulli: return pick_group<kBernoulli>(B, d, v, var);
    case kEightSchoolsCentered: return pick_group<kEightSchoolsCentered>(B, d, v, var);
    case kMrna: return pick_group<kMrna>(B, d, v, var);
    default: return -1;
  }
}
