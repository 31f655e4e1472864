// Kernel K2: slice-sampler sweep for general (non-separable) densities.
//
// Replaces the TPU kernel pigeons_tpu/ops/pallas_slice.py:_sweep_kernel. Each
// lane (one replica of the batch) runs ONE asynchronous Neal slice machine,
// ENTER / INIT_R / DOUBLE / SHRINK / CHECK / DONE, through all n_passes * d
// coordinate steps of its sweep, with one density evaluation per loop
// iteration. One thread owns one lane for the whole sweep: its state x[d], its
// 23 machine variables, its own iteration counter and the density evaluation
// (densities.cuh, compiled in and selected by the template argument) all stay
// inside one launch. Two modes, as in the TPU kernel: full evaluation (every
// query costs one O(d) density evaluation of the state with coordinate c
// replaced) and, for a separable density, coordinate deltas (a query is
// answered as base + f_c(query), and the density of the final state is
// recomputed exactly).
//
// Layout. Input and output are the row-major [B, d] states. A block of 128
// lanes loads its contiguous [128, d] tile with coalesced reads into shared
// memory, transposed to [d][128], so that thread t reads its coordinate c at
// tile[c * 128 + t]: bank t whatever c is, hence no bank conflicts although
// every thread walks its own coordinate. 128 lanes of d = 100 floats take
// 51,200 B, above the 48 KB static limit, so the tile is dynamic shared
// memory with the opt-in attribute; the block shrinks to 64 or 32 lanes where
// d * 128 * 4 B would pass the 227 KB a block may use (d up to 1,816).
//
// Bound on the H100. The kernel reads and writes B * d * 4 B once (123 KB for
// the funnel at B = 3,072, d = 10; 8 MB for the toy MVN at B = 20,480,
// d = 100), so memory is not the limit. The work is the lanes' sequential
// iterations, each a density evaluation (O(d) with an exp for the funnel)
// and the machine's step; the kernel also draws all four uniforms in every
// iteration, though only ENTER uses two of them and the log, DOUBLE and
// SHRINK one each. Counted by what each phase needs, the card could do the
// funnel sweep in 0.0007 ms and the toy sweep in 0.013 ms; the kernel takes
// 0.48 ms and 0.43 ms (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W). A warp
// runs until its slowest lane is DONE, and at B = 3,072 the launch is 24
// blocks on 132 SMs, one warp per SM sub-partition at most, so it is bound
// by the latency of one thread's dependent chain, not by throughput. The
// design does nothing about either yet: more lanes per launch (more
// ladders) or a lane split over several threads are the next steps.
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

template <Density K, bool kDelta>
__global__ void slice_sweep_kernel(const float* __restrict__ x, const float* __restrict__ betas,
                                   const int64_t* __restrict__ seeds, float* __restrict__ x_out,
                                   float* __restrict__ lp_out, float* __restrict__ stats, int B,
                                   int d, DensityParams params, float W, float narrow_w, int p,
                                   int n_passes, int max_iter) {
  extern __shared__ float tile[];  // [d][T]: coordinate-major
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int64_t lane0 = (int64_t)blockIdx.x * T;
  const int n_here = (int)min((int64_t)T, (int64_t)B - lane0);
  const int n_tile = n_here * d;
  for (int i = tid; i < n_tile; i += T) tile[(i % d) * T + i / d] = x[lane0 * d + i];
  __syncthreads();

  if (tid < n_here) {
    const int64_t b = lane0 + tid;
    float* xs = tile + tid;  // coordinate c of this lane is xs[c * T]
    const float beta = betas[b];
    const uint32_t hash_base = fmix32((uint32_t)seeds[b] ^ 0x9E3779B9u);
    const LaneView current{xs, T, -1, 0.0f};

    float lp_cur = log_density<K>(current, d, beta, params);
    float old = 0.f, z = 0.f, L = 0.f, R = 0.f, lpL = 0.f, lpR = 0.f, Lb = 0.f, Rb = 0.f;
    float cand = 0.f, lp_cand = 0.f, Lh = 0.f, Rh = 0.f, lpLh = 0.f, lpRh = 0.f, base = 0.f;
    float acc_sum = 0.f, acc_n = 0.f, n_evals = 0.f;
    const int n_steps = n_passes * d;
    int phase = n_steps > 0 ? ENTER : DONE;
    int j = 0, c = 0, K_dbl = 0, n_shr = 0;  // j: coordinate steps done, c = j % d

    for (uint32_t it = 0; phase != DONE; ++it) {
      const uint32_t ctr = 4u * it;
      const float u_init = uniform_from_bits(fmix32(hash_base ^ ctr));
      const float u_z = uniform_from_bits(fmix32(hash_base ^ (ctr + 1u)));
      const float u_side = uniform_from_bits(fmix32(hash_base ^ (ctr + 2u)));
      const float u_shr = uniform_from_bits(fmix32(hash_base ^ (ctr + 3u)));

      const bool is_enter = phase == ENTER;
      const float xc = xs[c * T];
      if (is_enter) {
        old = xc;
        z = lp_cur - (-cephes_logf(u_z));
        L = __fmaf_rn(u_init, -W, old);
        R = L + W;
      }
      const bool grow_left = u_side <= 0.5f;
      const float span = R - L;
      const float dbl_q = grow_left ? L - span : R + span;
      const float cand_draw = __fmaf_rn(u_shr, Rb - Lb, Lb);
      const float M = (Lh + Rh) * 0.5f;
      const float query = is_enter           ? L
                          : phase == INIT_R  ? R
                          : phase == DOUBLE  ? dbl_q
                          : phase == SHRINK  ? cand_draw
                          : phase == CHECK   ? M
                                             : old;

      float lp_q;
      if constexpr (kDelta) {
        static_assert(!kDelta || K == kToyMvn, "no coordinate term for this density");
        const float a = toy_coord_factor(beta, params.v[0], params.v[1]);
        if (is_enter) base = lp_cur - coord_term<kToyQuadratic>(a, xc);
        lp_q = base + coord_term<kToyQuadratic>(a, query);
      } else {
        lp_q = log_density<K>(LaneView{xs, T, c, query}, d, beta, params);
      }
      n_evals += 1.0f;

      if (is_enter) lpL = lp_q;
      const bool ph_initr = phase == INIT_R;
      if (ph_initr) {
        lpR = lp_q;
        K_dbl = p;
      }
      const bool ph_dbl = phase == DOUBLE;
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

      const bool ph_shr = phase == SHRINK;
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
        xs[c * T] = cand;
        lp_cur = lp_cand;
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
    if constexpr (kDelta) lp_cur = log_density<K>(current, d, beta, params);
    lp_out[b] = lp_cur;
    stats[b] = acc_sum;
    stats[(int64_t)B + b] = acc_n;
    stats[2 * (int64_t)B + b] = n_evals;
  }

  __syncthreads();
  for (int i = tid; i < n_tile; i += T) x_out[lane0 * d + i] = tile[(i % d) * T + i / d];
}

constexpr size_t kMaxSharedBytes = 232448;  // 227 KB: what one block may use on sm_90

template <Density K, bool kDelta>
int launch(const float* x, const float* betas, const int64_t* seeds, float* x_out, float* lp_out,
           float* stats, int B, int d, const DensityParams& params, float w, int p, int n_passes,
           int max_iter, cudaStream_t stream) {
  int threads = 128;
  while (threads > 32 && (size_t)d * threads * sizeof(float) > kMaxSharedBytes) threads /= 2;
  const size_t shared = (size_t)d * threads * sizeof(float);
  if (shared > kMaxSharedBytes) return -2;  // d too large for a lane's state in shared memory
  auto kernel = slice_sweep_kernel<K, kDelta>;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)(((int64_t)B + threads - 1) / threads);
  kernel<<<blocks, threads, shared, stream>>>(x, betas, seeds, x_out, lp_out, stats, B, d, params,
                                              w, 1.1f * w, p, n_passes, max_iter);
  return (int)cudaGetLastError();
}

}  // namespace

// x, betas, seeds, x_out, lp_out, stats: device pointers of the [B, d] float32
// states, the [B] float32 annealing parameters, the [B] int64 lane seeds
// (uint32 values), the [B, d] float32 output states, the [B] float32 output
// densities and the [3, B] float32 stats (accept_sum, accept_n, n_evals).
// density is a Density of densities.cuh and params its kMaxDensityParams
// float32 parameters in host memory; coord_deltas selects delta mode.
// Launches on `stream`. Returns cudaGetLastError(), or -1 for a density or
// mode the kernel does not have, -2 for a d whose state does not fit.
extern "C" int slice_sweep(const float* x, const float* betas, const int64_t* seeds, float* x_out,
                           float* lp_out, float* stats, int B, int d, int density,
                           int coord_deltas, const float* params, float w, int p, int n_passes,
                           int max_iter, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (d < 1) return -1;
  DensityParams dp;
  for (int i = 0; i < kMaxDensityParams; ++i) dp.v[i] = params[i];
  const cudaStream_t s = (cudaStream_t)stream;
#define PIGEONS_LAUNCH(K, DELTA) \
  launch<K, DELTA>(x, betas, seeds, x_out, lp_out, stats, B, d, dp, w, p, n_passes, max_iter, s)
  if (coord_deltas) return density == kToyMvn ? PIGEONS_LAUNCH(kToyMvn, true) : -1;
  switch (density) {
    case kToyMvn: return PIGEONS_LAUNCH(kToyMvn, false);
    case kFunnel: return PIGEONS_LAUNCH(kFunnel, false);
    case kBanana: return PIGEONS_LAUNCH(kBanana, false);
    case kMvn: return PIGEONS_LAUNCH(kMvn, false);
    default: return -1;
  }
#undef PIGEONS_LAUNCH
}
