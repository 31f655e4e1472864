// Kernel K1: banded slice-sampler sweep for additively separable densities.
//
// Replaces the TPU kernel pigeons_tpu/ops/pallas_slice.py:_banded_sweep_kernel.
// Every (lane, coordinate) element of the row-major [B, d] state runs its own
// one-dimensional Neal slice sampler (ENTER / DOUBLE / SHRINK / CHECK / DONE)
// for n_passes passes: the joint density of a separable path cancels from each
// coordinate's slice test, so the elements are independent. One thread per
// element keeps the element's value and machine state in registers, loops
// until its own machine is DONE, and writes x_out once.
//
// Bound on the H100: each element reads and writes 4 bytes once (8 MB at bench
// config 1), so memory is not the limit; integer hashing, float ALU work and
// warp divergence are, since a warp runs until its slowest element finishes
// (1 to 1000+ iterations). The design does nothing about divergence yet.
//
// Numerics follow the JAX kernel as XLA's CPU backend runs it: the uniforms
// are (bits >> 8) * 2^-24 + 2^-25 of chained murmur3 finalizers, log is the
// Cephes polynomial (common.cuh), the coordinate term comes from
// densities.cuh, and the step-out and shrink draws are fused multiply-adds.
// Build with --fmad=false so that nvcc fuses nothing else; the plain torch twin
// (pigeons_tpu_torch/ops/cuda_slice.py:banded_sweep_reference) then gives the
// same bits.

#include "densities.cuh"

namespace {

using namespace pigeons;

template <CoordTerm kTerm>
__global__ void banded_slice_kernel(const float* __restrict__ x, const float* __restrict__ a,
                                    const int64_t* __restrict__ seeds, float* __restrict__ x_out,
                                    float* __restrict__ stats, int B, int d, float W,
                                    float narrow_w, int p, int n_passes, int max_iter) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)B * d) return;
  const int b = (int)(idx / d);
  const uint32_t c = (uint32_t)(idx % d);
  const float ab = a[b];
  const uint32_t seed = (uint32_t)seeds[b];
  const uint32_t base = fmix32(fmix32(seed ^ (c * 0x85EBCA77u)) ^ 0x9E3779B9u);

  float xv = x[idx];
  float z = 0.f, L = 0.f, R = 0.f, lcL = 0.f, lcR = 0.f, Lb = 0.f, Rb = 0.f, cand = 0.f;
  float Lh = 0.f, Rh = 0.f, lcLh = 0.f, lcRh = 0.f;
  float acc_sum = 0.f, acc_n = 0.f, n_evals = 0.f;
  int phase = n_passes > 0 ? ENTER : DONE;
  int pass_i = 0, K = 0, n_shr = 0;

  for (uint32_t it = 0; phase != DONE; ++it) {
    const float uA = uniform_from_bits(fmix32(base ^ (2u * it)));
    const float uB = uniform_from_bits(fmix32(base ^ (2u * it + 1u)));
    const bool is_enter = phase == ENTER;
    const float old = xv;
    if (is_enter) {
      L = __fmaf_rn(uA, -W, old);
      R = L + W;
    }
    const bool grow_left = uA <= 0.5f;
    const float span = R - L;
    const float dbl_q = grow_left ? L - span : R + span;
    const float cand_draw = __fmaf_rn(uA, Rb - Lb, Lb);
    const float M = (Lh + Rh) * 0.5f;
    const float query = is_enter ? R
                        : phase == DOUBLE ? dbl_q
                        : phase == SHRINK ? cand_draw
                        : phase == CHECK  ? M
                                          : old;
    const float lp_q = coord_term<kTerm>(ab, query);
    n_evals += is_enter ? 2.0f : 1.0f;
    if (is_enter) {
      z = coord_term<kTerm>(ab, old) - (-cephes_logf(uB));
      lcL = coord_term<kTerm>(ab, L);
      lcR = lp_q;
      K = p;
    }

    const bool ph_dbl = phase == DOUBLE;
    if (ph_dbl) {
      if (grow_left) {
        L = dbl_q;
        lcL = lp_q;
      } else {
        R = dbl_q;
        lcR = lp_q;
      }
      K -= 1;
    }
    const bool more_dbl = (K > 0) && ((z < lcL) || (z < lcR));
    const bool start_shrink = (is_enter || ph_dbl) && !more_dbl;
    if (start_shrink) {
      Lb = L;
      Rb = R;
      n_shr = 0;
    }

    const bool ph_shr = phase == SHRINK;
    if (ph_shr) {
      cand = cand_draw;
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
      lcLh = lcL;
      lcRh = lcR;
    }

    const bool ph_chk = phase == CHECK;
    const bool take_left = cand < M;
    const bool crossed = (old < M) != take_left;
    if (ph_chk) {
      if (take_left) {
        Rh = M;
        lcRh = lp_q;
      } else {
        Lh = M;
        lcLh = lp_q;
      }
    }
    const bool chk_rej = ph_chk && crossed && (z >= lcLh) && (z >= lcRh);
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
    if (accepted) xv = cand;
    acc_sum += accepted ? 1.0f : 0.0f;

    if (accepted || bail) {
      pass_i += 1;
      phase = pass_i >= n_passes ? DONE : ENTER;
    } else if ((is_enter || ph_dbl) && more_dbl) {
      phase = DOUBLE;
    } else if (start_shrink || (rejected && !bail)) {
      phase = SHRINK;
    } else if (to_check || chk_more) {
      phase = CHECK;
    }
  }

  x_out[idx] = xv;
  // integer-valued per-lane sums far below 2^24: exact in any order
  atomicAdd(stats + b, acc_sum);
  atomicAdd(stats + B + b, acc_n);
  atomicAdd(stats + 2 * (int64_t)B + b, n_evals);
}

}  // namespace

// x, a, seeds, x_out, stats: device pointers of the [B, d] float32 states, the
// [B] float32 coordinate-term factors, the [B] int64 lane seeds (uint32 values),
// the [B, d] float32 output and the zeroed [3, B] float32 stats (accept_sum,
// accept_n, n_evals). Launches on `stream`; returns cudaGetLastError().
extern "C" int banded_slice_sweep(const float* x, const float* a, const int64_t* seeds,
                                  float* x_out, float* stats, int B, int d, float w, int p,
                                  int n_passes, int max_iter, void* stream) {
  const int64_t n = (int64_t)B * d;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const float narrow_w = 1.1f * w;
  banded_slice_kernel<kToyQuadratic><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      x, a, seeds, x_out, stats, B, d, w, narrow_w, p, n_passes, max_iter);
  return (int)cudaGetLastError();
}
