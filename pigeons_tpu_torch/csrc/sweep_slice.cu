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
// Times (tools/torch_kernel_variants.py, NVIDIA H100 80GB HBM3, 700.00 W, one
// run). Funnel, B = 3,072, d = 10, 1 pass: G = 8 / 16 / 32 0.231 / 0.205 /
// 0.221 ms, G = 1 0.453 ms, the first version (one thread per lane, all four
// draws in every iteration) 0.446 ms; at B = 20,480 G = 8 / 16 0.481 /
// 0.594 ms against 0.542 ms for G = 1. Toy MVN in full mode, B = 20,480,
// d = 100: G = 1 1.63 ms, G = 32 7.11 ms (its terms are one multiply each).
// Delta mode, same shape: 0.392 ms against 0.410 ms for the first version.
// 47 to 70 registers; the flat-prior MVN with G = 1 spills 4 bytes, no other
// instance spills.
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

template <Density K, bool kDelta, int G>
__global__ void __launch_bounds__(kThreads)
slice_sweep_kernel(const float* __restrict__ x, const float* __restrict__ betas,
                   const int64_t* __restrict__ seeds, float* __restrict__ x_out,
                   float* __restrict__ lp_out, float* __restrict__ stats, int B, int d,
                   DensityParams params, float W, float narrow_w, int p, int n_passes,
                   int max_iter) {
  static_assert(G == 1 || !kDelta, "a delta query is O(1): nothing to share out");
  // G == 1: the states [d][T], coordinate-major. G > 1: the states [T / G][d],
  // then each group's target terms [T / G][d].
  float* shared = dynamic_shared();
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lanes_per_block = T / G;
  const int64_t lane0 = (int64_t)blockIdx.x * lanes_per_block;
  const int n_here = (int)min((int64_t)lanes_per_block, (int64_t)B - lane0);
  const int n_tile = n_here * d;
  for (int i = tid; i < n_tile; i += T)
    shared[G == 1 ? (i % d) * T + i / d : i] = x[lane0 * d + i];
  __syncthreads();

  const int group = tid / G;  // the block's lane this thread works for
  const int g = tid % G;      // its place in the group
  if (group < n_here) {
    const int64_t b = lane0 + group;
    float* xs = G == 1 ? shared + tid : shared + group * d;
    const int stride = G == 1 ? T : 1;  // coordinate c of this lane is xs[c * stride]
    [[maybe_unused]] float* terms = shared + (lanes_per_block + group) * d;
    [[maybe_unused]] const unsigned mask = group_mask<G>(tid);
    const float beta = betas[b];
    const uint32_t hash_base = fmix32((uint32_t)seeds[b] ^ 0x9E3779B9u);

    // The density of the lane's state with coordinate c (if any) holding q.
    // Every thread of the group calls it at the same point and gets the same
    // bits: thread g computes the terms of coordinates g, g + G, ..., and all
    // of them run the in-order sums over the group's buffer.
    auto evaluate = [&](int c, float q, const Prepared& pr) {
      const LaneView s{xs, stride, c, q};
      if constexpr (G == 1) {
        return log_density<K>(s, d, beta, pr, params);
      } else {
        for (int i = first_term<K> + g; i < d; i += G) terms[i] = target_term<K>(s(i), pr, params);
        __syncwarp(mask);
        const float lp = finish<K>(s, [&](int i) { return terms[i]; }, d, beta, pr, params);
        __syncwarp(mask);  // all have read the terms before the next query overwrites them
        return lp;
      }
    };

    // what the terms need of coordinate 0, kept for the lane's current state
    Prepared pr_cur = prepare<K>(xs[0], params);
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
        lp_q = evaluate(c, query, c == 0 ? prepare<K>(query, params) : pr_cur);
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
        if (!kDelta && c == 0) pr_cur = prepare<K>(cand, params);
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
    if constexpr (kDelta) lp_cur = evaluate(-1, 0.0f, prepare<K>(xs[0], params));
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

// Shared memory of one block: with one thread per lane a state per thread,
// and the block shrinks to 64 or 32 lanes where 128 states would not fit (d
// up to 1,816); with a group per lane a state and a term buffer for each
// group of a 128-thread block (d up to 227 times the group's size). 0: d is
// too large.
size_t shared_bytes(int group, int d, int* threads) {
  *threads = kThreads;
  size_t bytes = (size_t)2 * (kThreads / group) * d * sizeof(float);
  if (group == 1) {
    while (*threads > 32 && (size_t)d * *threads * sizeof(float) > kMaxSharedBytes) *threads /= 2;
    bytes = (size_t)d * *threads * sizeof(float);
  }
  return bytes > kMaxSharedBytes ? 0 : bytes;
}

struct SweepArgs {
  const float *x, *betas;
  const int64_t* seeds;
  float *x_out, *lp_out, *stats;
  int B, d;
  DensityParams params;
  float w;
  int p, n_passes, max_iter;
  cudaStream_t stream;
};

template <Density K, bool kDelta, int G>
int launch(const SweepArgs& a) {
  int threads;
  const size_t shared = shared_bytes(G, a.d, &threads);
  if (shared == 0) return -2;  // d too large for a lane's state in shared memory
  auto kernel = slice_sweep_kernel<K, kDelta, G>;
  const cudaError_t err = allow_shared_bytes(kernel, shared);
  if (err != cudaSuccess) return (int)err;
  const int lanes_per_block = threads / G;
  const unsigned blocks = (unsigned)(((int64_t)a.B + lanes_per_block - 1) / lanes_per_block);
  PIGEONS_LAUNCH(kernel, blocks, threads, shared, a.stream, a.x, a.betas, a.seeds, a.x_out,
                 a.lp_out, a.stats, a.B, a.d, a.params, a.w, 1.1f * a.w, a.p, a.n_passes,
                 a.max_iter);
  return (int)cudaGetLastError();
}

// Threads that an H100 keeps resident: 132 SMs of 2,048.
constexpr int64_t kResidentThreads = 132 * 2048;

// Threads per lane in full mode, from the density and the shape. One thread
// where there is nothing to share out: a density whose terms are one multiply
// each (the sums of squares), or d = 1. Else the smallest group that gives
// every thread at most one term, halved down to 8 while the batch's groups
// would not all be resident at once: beyond that the card is full either way,
// and a group repeats the machine and the in-order sums in every thread. One
// thread again where even groups of 8 are too many or their buffers too large.
template <Density K>
int pick_group(int B, int d) {
  const int n_terms = d - first_term<K>;
  if (first_term<K> == 0 || n_terms == 0) return 1;
  int group = n_terms <= 8 ? 8 : n_terms <= 16 ? 16 : 32;
  while (group > 8 && (int64_t)B * group > kResidentThreads) group /= 2;
  int threads;
  if ((int64_t)B * group > kResidentThreads || shared_bytes(group, d, &threads) == 0) return 1;
  return group;
}

template <Density K>
int launch_full(const SweepArgs& a, int group) {
  switch (group ? group : pick_group<K>(a.B, a.d)) {
    case 1: return launch<K, false, 1>(a);
    case 8: return launch<K, false, 8>(a);
    case 16: return launch<K, false, 16>(a);
    case 32: return launch<K, false, 32>(a);
    default: return -1;
  }
}

}  // namespace

// x, betas, seeds, x_out, lp_out, stats: device pointers of the [B, d] float32
// states, the [B] float32 annealing parameters, the [B] int64 lane seeds
// (uint32 values), the [B, d] float32 output states, the [B] float32 output
// densities and the [3, B] float32 stats (accept_sum, accept_n, n_evals).
// density is a Density of densities.cuh and params its kMaxDensityParams
// float32 parameters in host memory; coord_deltas selects delta mode. group
// is the number of threads per lane in full mode (1, 8, 16 or 32), or 0 for
// the launcher's choice from the density, B and d; delta mode always runs one.
// Launches on `stream`. Returns cudaGetLastError(), or -1 for a density, mode
// or group the kernel does not have, -2 for a d whose state does not fit.
extern "C" int slice_sweep(const float* x, const float* betas, const int64_t* seeds, float* x_out,
                           float* lp_out, float* stats, int B, int d, int density,
                           int coord_deltas, const float* params, float w, int p, int n_passes,
                           int max_iter, int group, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (d < 1) return -1;
  SweepArgs a{x, betas, seeds, x_out, lp_out, stats, B, d, {}, w, p, n_passes, max_iter,
              (cudaStream_t)stream};
  for (int i = 0; i < kMaxDensityParams; ++i) a.params.v[i] = params[i];
  if (coord_deltas) {
    if (density != kToyMvn || group > 1) return -1;
    return launch<kToyMvn, true, 1>(a);
  }
  switch (density) {
    case kToyMvn: return launch_full<kToyMvn>(a, group);
    case kFunnel: return launch_full<kFunnel>(a, group);
    case kBanana: return launch_full<kBanana>(a, group);
    case kMvn: return launch_full<kMvn>(a, group);
    default: return -1;
  }
}
