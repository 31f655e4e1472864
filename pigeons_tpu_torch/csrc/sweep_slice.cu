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
// per lane (a delta query is O(1)).
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
// level over km0 and its level, so that a query of km0 or sigma computes no
// exp, and a term before t0 none (its level is 0); its five windows of 32 are
// five threads' sums. Centred eight schools keeps its 3 J terms and each of
// its three sums' running values: a query of theta_j recomputes three terms
// in three threads and resumes each sum at j; its pseudo-prior block is C's
// sum (the same terms). The additions are the same, in the same order, so
// the bits are the twin's, which recomputes everything for every query.
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
//                             [n_terms], level [2][n_terms] each term's level
//                             over km0 and level (mrna_shape, mrna_level) at
//                             the current state (0) and the shrink candidate (1)
//   kEightSchoolsCentered     cur [3 J] the terms A, B, C; run [3 J] each sum's
//                             running value after each of its terms; scratch
//                             [3 J] a query's A terms
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

  static __device__ __host__ int lane_floats(int d, int n_terms, const DensityParams& p) {
    if constexpr (K == kHierarchicalNormal) {
      const int R = d - 3, P = row_partials(R);
      return 2 * kMaxPriorBlocks + 3 * (R / P * P) + 2 * (int)p.v[1] + 2 * n_terms;
    }
    if constexpr (K == kEightSchoolsCentered) return 2 * kMaxPriorBlocks + 3 * n_terms;
    if constexpr (K == kMrna) return 2 * kMaxPriorBlocks + 5 * n_terms;
    return 2 * kMaxPriorBlocks + 2 * n_terms;
  }

  __device__ ManyTerms(float* xs_, float* buf_, int d_, int n_terms_, int g_, unsigned mask_,
                       const DensityParams& p)
      : xs(xs_), buf(buf_), d(d_), n_terms(n_terms_), g(g_), mask(mask_) {
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
  __device__ __forceinline__ float* level(int slot) const { return scratch() + (3 + slot) * n_terms; }

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
      lref = variational_log_density(s, d, var);
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
  // one of sigma (c = 4) its level: the lane keeps both for its current state
  // (slot 0) and the shrink candidate (slot 1, which commit() takes over), and
  // such a query recomputes no exp. Thread g keeps the terms g, g + G, ... .
  __device__ __forceinline__ void mrna_terms(int c, const Prepared& pr, int slot,
                                             const DensityInputs& in) {
    const float* ts = in.arrays.ptr[0];
    const float* ys = in.arrays.ptr[1];
    float* scratch = this->scratch();
    float* shape_cur = shape(0);
    float* level_cur = level(0);
    const int keep = c < 0 ? 0 : slot == 1 ? 1 : -1;  // the slot this query's terms go to
    for (int t = g; t < n_terms; t += G) {
      float lvl;
      if (c == 4) {
        lvl = level_cur[t];
      } else {
        const float tmt0 = ts[t] - pr.a;
        float sh = 0.0f;  // the level before t0 is 0, whatever the shape
        if (c == 1) {
          sh = shape_cur[t];
        } else if (!(tmt0 <= 0.0f)) {
          sh = mrna_shape(tmt0, pr);
        }
        lvl = mrna_level(tmt0, pr.b, sh);
        if (keep >= 0) {
          shape(keep)[t] = sh;
          level(keep)[t] = lvl;
        }
      }
      scratch[t] = observation_term(ys[t], lvl, pr.c, pr.e);
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
          level(0)[t] = level(1)[t];
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
    __syncwarp(mask);
  }
};

// Floats of a lane's buffers past its state with G > 1 threads per lane.
template <Density K, int G>
__device__ __host__ inline int buffer_floats(int d, int n_terms, const DensityParams& p) {
  if constexpr (kManyTerms<K, G>) return ManyTerms<K, G>::lane_floats(d, n_terms, p);
  return G == 1 ? 0 : n_terms;
}

// Blocks of kThreads that an SM must be able to hold at once: the compiler
// keeps each thread's registers within 65,536 / (kThreads * kMinBlocks). The
// logistic regression's groups otherwise take 133 registers, four blocks an
// SM, and at 8,192 lanes take 3.03 ms against 2.07 ms with 80 registers
// (tools/torch_kernel_variants.py; 64 registers spill, 0.72 against 0.64 ms
// at 640 lanes); the hierarchical normal's 117 were as fast as 80.
template <Density K, int G>
constexpr int kMinBlocks = kManyTerms<K, G> && K == kLogisticRegression ? 6 : 1;

template <Density K, bool kDelta, int G>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<K, G>))
slice_sweep_kernel(const float* __restrict__ x, const float* __restrict__ betas,
                   const int64_t* __restrict__ seeds, float* __restrict__ x_out,
                   float* __restrict__ lp_out, float* __restrict__ stats, int B, int d,
                   DensityInputs in, float W, float narrow_w, int p, int n_passes,
                   int max_iter) {
  static_assert(G == 1 || !kDelta, "a delta query is O(1): nothing to share out");
  // G == 1: the states [d][T], coordinate-major. G > 1: the states [T / G][d],
  // then each group's buffers [T / G][lane_floats]: its target terms, or
  // ManyTerms' buffers. Then the variational reference's mean, std and log
  // norms [3][d].
  float* shared = dynamic_shared();
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lanes_per_block = T / G;
  const int64_t lane0 = (int64_t)blockIdx.x * lanes_per_block;
  const int n_here = (int)min((int64_t)lanes_per_block, (int64_t)B - lane0);
  const int n_tile = n_here * d;
  const DensityParams& params = in.params;
  const int n_terms = end_term<K>(d, params);
  const int lane_floats = buffer_floats<K, G>(d, n_terms, params);
  for (int i = tid; i < n_tile; i += T)
    shared[G == 1 ? (i % d) * T + i / d : i] = x[lane0 * d + i];
  float* var_arrays = shared + (G == 1 ? T * d : lanes_per_block * (d + lane_floats));
  const bool variational = in.isvar != nullptr;
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

    // kept for the lane's current state, recomputed for a query of a coordinate
    // that prepare reads
    const auto prepared = [&](int c, float q) {
      return prepare<K>(LaneView{xs, stride, c, q}, d, params, in.prior);
    };
    Prepared pr_cur = prepared(-1, 0.0f);
    const auto prepared_from_cur = [&](int c, float q) {
      return prepare_query<K>(pr_cur, LaneView{xs, stride, c, q}, d, params, in.prior);
    };
    [[maybe_unused]] auto many = [&] {
      if constexpr (kManyTerms<K, G>) {
        return ManyTerms<K, G>(xs, terms, d, n_terms, g, mask, params);
      } else {
        return 0;
      }
    }();

    // The density of the lane's state with coordinate c (if any) holding q;
    // slot 1 for the shrink candidate (ManyTerms keeps its terms). Every
    // thread of the group calls it at the same point and gets the same bits:
    // thread g computes the terms g, g + G, ..., and all of them run the
    // in-order sums over the group's buffer, or ManyTerms shares them out.
    auto evaluate = [&](int c, float q, const Prepared& pr, [[maybe_unused]] int slot) {
      const LaneView s{xs, stride, c, q};
      if constexpr (kManyTerms<K, G>) {
        return many.evaluate(c, q, pr, slot, beta, in, var);
      } else if constexpr (G == 1) {
        return log_density<K>(s, d, beta, pr, params, in.arrays, in.prior, var);
      } else {
        for (int t = first_term<K> + g; t < n_terms; t += G)
          terms[t] = target_term<K>(s, t, pr, params, in.arrays);
        __syncwarp(mask);
        const float lp = finish<K>(s, [&](int t) { return terms[t]; }, d, beta, pr, params,
                                   in.prior, var);
        __syncwarp(mask);  // all have read the terms before the next query overwrites them
        return lp;
      }
    };
    float lp_cur = evaluate(-1, 0.0f, pr_cur, 0);
    float old = 0.f, z = 0.f, L = 0.f, R = 0.f, lpL = 0.f, lpR = 0.f, Lb = 0.f, Rb = 0.f;
    float cand = 0.f, lp_cand = 0.f, Lh = 0.f, Rh = 0.f, lpLh = 0.f, lpRh = 0.f, base = 0.f;
    float acc_sum = 0.f, acc_n = 0.f, n_evals = 0.f;
    const int n_steps = n_passes * d;
    int phase = n_steps > 0 ? ENTER : DONE;
    int j = 0, c = 0, K_dbl = 0, n_shr = 0;  // j: coordinate steps done, c = j % d

    for (uint32_t it = 0; phase != DONE; ++it) {
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

      float lp_q;
      if constexpr (kDelta) {
        static_assert(!kDelta || K == kToyMvn, "no coordinate term for this density");
        const float a = toy_coord_factor(beta, params.v[0], params.v[1]);
        if (is_enter) base = lp_cur - quadratic_term(a, xc);
        lp_q = base + quadratic_term(a, query);
      } else {
        lp_q = evaluate(c, query, prepare_reads<K>(c, d) ? prepared_from_cur(c, query) : pr_cur,
                        ph_shr ? 1 : 0);
      }
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
        xs[c * stride] = cand;
        lp_cur = lp_cand;
        if (!kDelta && prepare_reads<K>(c, d)) pr_cur = prepared_from_cur(c, cand);
        if constexpr (kManyTerms<K, G>) many.commit(c, pr_cur, beta, in, var);
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

    // the deltas drift by float32 rounding over the sweep: hand back the
    // exactly recomputed density of the final state, as the TPU kernel does
    if constexpr (kDelta) lp_cur = evaluate(-1, 0.0f, prepared(-1, 0.0f), 0);
    if (g == 0) {
      lp_out[b] = lp_cur;
      stats[b] = acc_sum;
      stats[(int64_t)B + b] = acc_n;
      stats[2 * (int64_t)B + b] = n_evals;
    }
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
  const int lane_floats = buffer_floats<K, G>(a.d, end_term<K>(a.d, a.in.params), a.in.params);
  const size_t var_floats = a.in.isvar != nullptr ? (size_t)3 * a.d : 0;
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
// schools at its B = 640 0.861 / 0.424 / 0.379 / 0.340 ms (the rule's 32),
// Bernoulli 0.088 / 0.089 / 0.087 / 0.087 ms (one term a thread at most:
// the group does not matter; the rule's 16). (NVIDIA H100 80GB HBM3,
// 700.00 W.) One thread also where the group's buffers do not fit.
template <Density K>
int pick_group(int B, int d, const DensityParams& params) {
  const int n_all_terms = end_term<K>(d, params);
  const int n_terms = n_all_terms - first_term<K>;
  if (K == kToyMvn || K == kMvn || n_terms <= 1) return 1;
  int group = n_terms <= 8 ? 8 : n_terms <= 16 ? 16 : 32;
  if (cheap_terms<K>) {
    while (group > 8 && (int64_t)B * group > kResidentThreads / 4) group /= 2;
    if ((int64_t)B * group > kResidentThreads) return 1;
  }
  int threads;
  if (shared_bytes(group, d, buffer_floats<K, 8>(d, n_all_terms, params), (size_t)3 * d,
                   &threads) == 0)
    return 1;
  return group;
}

// kUnid has one term: it is built for one thread per lane only.
template <Density K>
int launch_full(const SweepArgs& a, int group) {
  if (!group) group = pick_group<K>(a.B, a.d, a.in.params);
  if (group == 1) return launch<K, false, 1>(a);
  if constexpr (K != kUnid) {
    switch (group) {
      case 8: return launch<K, false, 8>(a);
      case 16: return launch<K, false, 16>(a);
      case 32: return launch<K, false, 32>(a);
    }
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
// number of threads per lane in full mode (1, 8, 16 or 32; 1 only for kUnid),
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
