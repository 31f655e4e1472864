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
// Layout. Input and output are the row-major [B, d] states. With one thread
// per lane a block of 128 lanes loads its contiguous [128, d] tile with
// coalesced reads into shared memory, transposed to [d][128], so that thread
// t reads its coordinate c at tile[c * 128 + t]: bank t whatever c is, hence
// no bank conflicts although every thread walks its own coordinate; the
// block shrinks to 64 or 32 lanes where d * 128 * 4 B would pass the 227 KB a
// block may use (d up to 1,816). With groups a block of 128 threads holds
// 128 / G lanes' states row-major and a term buffer each (d up to 227 G).
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
// With the array inputs (same tool, same card, one run): hierarchical normal,
// B = 8,192, d = 23: G = 1 / 8 / 16 / 32 10.50 / 3.06 / 3.39 / 4.08 ms (every
// thread of a group repeats the prior and the 200-term sum), at B = 640 8.25 /
// 2.21 / 1.71 / 1.46 ms; logistic regression, 200 observations, d = 11:
// 17.16 / 2.77 / 2.48 / 2.46 ms at B = 8,192, 11.89 / 1.73 / 1.05 / 0.74 ms at
// B = 640; the funnel at B = 3,072 0.260 ms against 0.238 ms for the sources
// without the variational branch. 53 to 96 registers
// (tools/torch_build_report.py); the funnel's and the logistic regression's
// instances spill 4 to 28 bytes, no other instance spills.
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

template <Density K, bool kDelta, int G>
__global__ void __launch_bounds__(kThreads)
slice_sweep_kernel(const float* __restrict__ x, const float* __restrict__ betas,
                   const int64_t* __restrict__ seeds, float* __restrict__ x_out,
                   float* __restrict__ lp_out, float* __restrict__ stats, int B, int d,
                   DensityInputs in, float W, float narrow_w, int p, int n_passes,
                   int max_iter) {
  static_assert(G == 1 || !kDelta, "a delta query is O(1): nothing to share out");
  // G == 1: the states [d][T], coordinate-major. G > 1: the states [T / G][d],
  // then each group's target terms [T / G][n_terms]. Then the variational
  // reference's mean, std and log norms [3][d].
  float* shared = dynamic_shared();
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lanes_per_block = T / G;
  const int64_t lane0 = (int64_t)blockIdx.x * lanes_per_block;
  const int n_here = (int)min((int64_t)lanes_per_block, (int64_t)B - lane0);
  const int n_tile = n_here * d;
  const DensityParams& params = in.params;
  const int n_terms = end_term<K>(d, params);
  for (int i = tid; i < n_tile; i += T)
    shared[G == 1 ? (i % d) * T + i / d : i] = x[lane0 * d + i];
  float* var_arrays = shared + (G == 1 ? T * d : lanes_per_block * (d + n_terms));
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
    [[maybe_unused]] float* terms = shared + lanes_per_block * d + group * n_terms;
    [[maybe_unused]] const unsigned mask = group_mask<G>(tid);
    const float beta = betas[b];
    const uint32_t hash_base = fmix32((uint32_t)seeds[b] ^ 0x9E3779B9u);
    const VariationalLane var{variational && in.isvar[b] > 0.0f && in.active[0] > 0.0f,
                              var_arrays, var_arrays + d, var_arrays + 2 * d};

    // The density of the lane's state with coordinate c (if any) holding q.
    // Every thread of the group calls it at the same point and gets the same
    // bits: thread g computes the terms g, g + G, ..., and all of them run the
    // in-order sums over the group's buffer.
    auto evaluate = [&](int c, float q, const Prepared& pr) {
      const LaneView s{xs, stride, c, q};
      if constexpr (G == 1) {
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
    // what the terms need of the state, with coordinate c (if any) holding q
    auto prepared = [&](int c, float q) { return prepare<K>(LaneView{xs, stride, c, q}, d, params); };

    // kept for the lane's current state, recomputed for a query of a coordinate
    // that prepare reads
    Prepared pr_cur = prepared(-1, 0.0f);
    float lp_cur = evaluate(-1, 0.0f, pr_cur);
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
        lp_q = evaluate(c, query, prepare_reads<K>(c, d) ? prepared(c, query) : pr_cur);
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
        if (!kDelta && prepare_reads<K>(c, d)) pr_cur = prepared(-1, 0.0f);
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
    if constexpr (kDelta) lp_cur = evaluate(-1, 0.0f, prepared(-1, 0.0f));
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
// states would not fit (d up to 1,816); with a group per lane a state and a
// buffer of n_terms terms for each group of a 128-thread block. 0: too large.
size_t shared_bytes(int group, int d, int n_terms, size_t extra, int* threads) {
  *threads = kThreads;
  size_t floats = (size_t)(kThreads / group) * ((size_t)d + n_terms);
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
  const int n_terms = end_term<K>(a.d, a.in.params);
  const size_t var_floats = a.in.isvar != nullptr ? (size_t)3 * a.d : 0;
  int threads;
  const size_t shared = shared_bytes(G, a.d, n_terms, var_floats, &threads);
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

// Whether a term costs about what one summand of the part that every thread
// of a group repeats costs (a division and a few multiply-adds), and not many
// times that (logistic regression: a dot product and a softplus).
template <Density K>
constexpr bool cheap_terms = K != kLogisticRegression;

// Threads per lane in full mode, from the density and the shape. One thread
// where there is nothing to share out: a density whose terms are one multiply
// each (the sums of squares), or a single term. Else the smallest group that
// gives every thread at most one term (32 at most), halved down to 8 while the
// batch's groups would fill the card: a group repeats the machine, the prior
// and the in-order sums in every thread, so once there are threads enough to
// hide each other's latency a smaller group does less work in all. With cheap
// terms that point is a quarter of the resident threads (hierarchical normal,
// B = 8,192: 8 / 16 / 32 threads 3.06 / 3.39 / 4.08 ms, but B = 640: 2.21 /
// 1.71 / 1.46 ms), with dear ones all of them (logistic regression, B = 8,192:
// 2.77 / 2.48 / 2.46 ms). One thread again where even groups of 8 are too many
// or their buffers too large.
template <Density K>
int pick_group(int B, int d, int n_all_terms) {
  const int n_terms = n_all_terms - first_term<K>;
  if (K == kToyMvn || K == kMvn || n_terms <= 1) return 1;
  int group = n_terms <= 8 ? 8 : n_terms <= 16 ? 16 : 32;
  const int64_t full = cheap_terms<K> ? kResidentThreads / 4 : kResidentThreads;
  while (group > 8 && (int64_t)B * group > full) group /= 2;
  int threads;
  if ((int64_t)B * group > kResidentThreads ||
      shared_bytes(group, d, n_all_terms, (size_t)3 * d, &threads) == 0)
    return 1;
  return group;
}

// kUnid has one term: it is built for one thread per lane only.
template <Density K>
int launch_full(const SweepArgs& a, int group) {
  if (!group) group = pick_group<K>(a.B, a.d, end_term<K>(a.d, a.in.params));
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
    if (b.offset != covered || b.size < 1 || b.dist < kNormal || b.dist > kUniform ||
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
    default: return -1;
  }
}
