// Device helpers shared by the slice-sampler kernels (banded_slice.cu,
// sweep_slice.cu): the machines' phase codes, the counter-based random
// numbers of pigeons_tpu/ops/pallas_slice.py (_fmix32, _hash_words,
// _uniform_from_bits), the Cephes float32 log, exp and log1p, softplus and
// sigmoid on top of them, XLA's expm1 and glibc's powf of base 10, the
// kernels' dynamic shared memory and the launch macro.
//
// log and exp follow pigeons_tpu_torch/f32math.py step for step, which in
// turn follows the polynomials XLA's CPU backend emits, with a fused
// multiply-add wherever that backend contracts one. Constants are given by
// their float32 bit patterns. Build with --fmad=false so that nvcc fuses
// nothing else.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

// A kernel launch on a stream. nvcc takes the <<<>>> form; a host compiler
// that rehearses these sources against a stub runtime (tests/cuda_stub)
// defines the macro itself, before this header is read.
#ifndef PIGEONS_LAUNCH
#define PIGEONS_LAUNCH(kernel, grid, block, shared_bytes, stream, ...) \
  kernel<<<grid, block, shared_bytes, stream>>>(__VA_ARGS__)
#endif

namespace pigeons {

constexpr size_t kMaxSharedBytes = 232448;  // 227 KB: what one block may use on sm_90
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// The block's dynamic shared memory. Every kernel takes all its shared
// memory from here, so that the launch alone decides its size.
__device__ __forceinline__ float* dynamic_shared() {
  extern __shared__ float pigeons_dynamic_shared[];
  return pigeons_dynamic_shared;
}

// Sets the opt-in a kernel needs for more than 48 KB of dynamic shared memory.
template <class Kernel>
inline cudaError_t allow_shared_bytes(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

constexpr int ENTER = 0, INIT_R = 1, DOUBLE = 2, SHRINK = 3, CHECK = 4, DONE = 5;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return (float)(bits >> 8) * 5.9604644775390625e-08f + 2.98023223876953125e-08f;
}

// Draw number `counter` of the stream with hash state `base`: a function of
// the two alone, so a draw that no phase uses need not be computed.
__device__ __forceinline__ float draw(uint32_t base, uint32_t counter) {
  return uniform_from_bits(fmix32(base ^ counter));
}

__device__ __forceinline__ float f32(uint32_t bits) { return __uint_as_float(bits); }

__device__ __forceinline__ float nan_to_neg_inf(float v) { return isnan(v) ? -INFINITY : v; }

// Cephes logf, step for step as f32math.log.
__device__ inline float cephes_logf(float y) {
  if (fabsf(y) < FLT_MIN) y = 0.0f;
  const float yc = y > FLT_MIN ? y : FLT_MIN;
  const int32_t bits = __float_as_int(yc);
  float e = (float)((bits >> 23) - 127) + 1.0f;
  const float m = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);
  const bool lt = m < f32(0x3F3504F3u);  // sqrt(1/2)
  e = e - (lt ? 1.0f : 0.0f);
  const float x = (m + -1.0f) + (lt ? m : 0.0f);
  const float z = x * x;
  const float x3 = z * x;
  const float ya = __fmaf_rn(__fmaf_rn(x, f32(0x3D9021BBu), f32(0xBDEBD1B8u)), x, f32(0x3DEF251Au));
  float yb = __fmaf_rn(__fmaf_rn(x, f32(0xBDFE5D4Fu), f32(0x3E11E9BFu)), x, f32(0xBE2AAE50u));
  float yc2 = __fmaf_rn(__fmaf_rn(x, f32(0x3E4CCEACu), f32(0xBE7FFFFCu)), x, f32(0x3EAAAAAAu));
  yb = __fmaf_rn(ya, x3, yb);
  yc2 = __fmaf_rn(yb, x3, yc2);
  float r = __fmaf_rn(yc2, x3, e * f32(0xB95E8083u));    // -2.12194440e-4
  r = __fmaf_rn(e, f32(0x3F318000u), (x - z * 0.5f) + r);  // 0.693359375
  if (y <= 0.0f || isnan(y)) r = NAN;
  if (y == 0.0f) r = -INFINITY;
  if (y == INFINITY) r = INFINITY;
  return r;
}

// Cephes expf, step for step as f32math.exp. The clamps are written as
// comparisons so that a NaN passes through, as it does in torch.clamp.
__device__ inline float cephes_expf(float x) {
  const float lo = f32(0xC2AF999Au), hi = f32(0x42B1999Au);  // -87.8, 88.8
  x = x < lo ? lo : x;
  x = x > hi ? hi : x;
  float fx = floorf(__fmaf_rn(x, f32(0x3FB8AA3Bu), 0.5f));  // log2(e)
  fx = fx < -127.0f ? -127.0f : fx;
  fx = fx > 127.0f ? 127.0f : fx;
  x = __fmaf_rn(-fx, f32(0x3F318000u), x);
  x = __fmaf_rn(-fx, f32(0xB95E8083u), x);
  float y = __fmaf_rn(x, f32(0x39506967u), f32(0x3AB743CEu));
  y = __fmaf_rn(y, x, f32(0x3C088908u));
  y = __fmaf_rn(y, x, f32(0x3D2AA9C1u));
  y = __fmaf_rn(y, x, f32(0x3E2AAAAAu));
  y = __fmaf_rn(y, x, 0.5f);
  y = __fmaf_rn(y, x * x, x) + 1.0f;
  const float pow2 = __int_as_float(((int32_t)fx + 127) << 23);
  const float out = y * pow2;
  return out < FLT_MIN ? 0.0f : out;
}

// Cephes log1pf, step for step as f32math.log1p: a rational approximation
// below sqrt(2) - 1, log(1 + x) above.
__device__ inline float cephes_log1pf(float x) {
  const float x2 = x * x;
  float p = __fmaf_rn(x, f32(0x383DE04Bu), f32(0x3EFF40C5u));
  p = __fmaf_rn(p, x, f32(0x40D284FAu));
  p = __fmaf_rn(p, x, f32(0x41EF4B9Cu));
  p = __fmaf_rn(p, x, f32(0x4273CC76u));
  p = __fmaf_rn(p, x, f32(0x426473ADu));
  p = __fmaf_rn(p, x, f32(0x41A05101u));
  float q = x + f32(0x417101ADu);
  q = __fmaf_rn(q, x, f32(0x42A6185Bu));
  q = __fmaf_rn(q, x, f32(0x435DC32Du));
  q = __fmaf_rn(q, x, f32(0x439A8CA3u));
  q = __fmaf_rn(q, x, f32(0x43586D8Au));
  q = __fmaf_rn(q, x, f32(0x42707982u));
  const float small = x + __fmaf_rn(x2, -0.5f, (x * x2) * (p / q));
  return fabsf(x) < f32(0x3ED413CDu) ? small : cephes_logf(x + 1.0f);
}

// softplus(x) = logaddexp(x, 0) and sigmoid(x) = 1 / (1 + exp(-x)), as
// models/distributions.py writes them after XLA's CPU backend.
__device__ inline float softplus(float x) {
  const float m = x > 0.0f ? x : 0.0f;
  return isnan(x) ? x : m + cephes_log1pf(cephes_expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (cephes_expf(-x) + 1.0f); }

// XLA's float32 tanh, step for step as f32math._tanh: the argument clamped
// to +-7.99881172, an odd over an even polynomial, the argument itself below
// 0.0004, +-1 from 20 on.
__device__ inline float xla_tanhf(float h) {
  const float lim = f32(0x40FFF644u);
  float hc = h < -lim ? -lim : h;
  hc = hc > lim ? lim : hc;
  const float z = hc * hc;
  float p = __fmaf_rn(z, f32(0xA59F25C0u), f32(0x2A61337Eu));
  p = __fmaf_rn(z, p, f32(0xAEBD37FFu));
  p = __fmaf_rn(z, p, f32(0x335C0041u));
  p = __fmaf_rn(z, p, f32(0x3779434Au));
  p = __fmaf_rn(z, p, f32(0x3A270DEDu));
  p = __fmaf_rn(z, p, f32(0x3BA059DCu));
  float q = __fmaf_rn(z, f32(0x35A0D3D8u), f32(0x38F895D6u));
  q = __fmaf_rn(z, q, f32(0x3B14AA05u));
  q = __fmaf_rn(z, q, f32(0x3BA059DDu));
  const float t = fabsf(h) < f32(0x39D1B717u) ? h : (hc * p) / q;
  return fabsf(h) >= 20.0f ? copysignf(1.0f, h) : t;
}

// XLA's float32 expm1, as f32math._expm1: exp(x) - 1 above |x| = 0.5, else
// tanh(x / 2) (exp(x) + 1); x itself where x / 2 is 0.
__device__ inline float xla_expm1f(float x) {
  const float e = cephes_expf(x);
  const float h = x * 0.5f;
  const float out = fabsf(x) > 0.5f ? e - 1.0f : xla_tanhf(h) * (e + 1.0f);
  return h == 0.0f ? x : out;
}

// 2^(i/32), i = 0 .. 31: the exp2 step of glibc_pow10f.
static __constant__ double kPow10Tab[32] = {
    0x1p+0, 0x1.059b0d3158574p+0, 0x1.0b5586cf9890fp+0, 0x1.11301d0125b51p+0,
    0x1.172b83c7d517bp+0, 0x1.1d4873168b9aap+0, 0x1.2387a6e756238p+0, 0x1.29e9df51fdee1p+0,
    0x1.306fe0a31b715p+0, 0x1.371a7373aa9cbp+0, 0x1.3dea64c123422p+0, 0x1.44e086061892dp+0,
    0x1.4bfdad5362a27p+0, 0x1.5342b569d4f82p+0, 0x1.5ab07dd485429p+0, 0x1.6247eb03a5585p+0,
    0x1.6a09e667f3bcdp+0, 0x1.71f75e8ec5f74p+0, 0x1.7a11473eb0187p+0, 0x1.82589994cce13p+0,
    0x1.8ace5422aa0dbp+0, 0x1.93737b0cdc5e5p+0, 0x1.9c49182a3f09p+0, 0x1.a5503b23e255dp+0,
    0x1.ae89f995ad3adp+0, 0x1.b7f76f2fb5e47p+0, 0x1.c199bdd85529cp+0, 0x1.cb720dcef9069p+0,
    0x1.d5818dcfba487p+0, 0x1.dfc97337b9b5fp+0, 0x1.ea4afa2a490dap+0, 0x1.f50765b6e454p+0};

// 10^q in float32 as glibc's powf computes it (f32math._pow10): q log2(10)
// in double, its exp2 by the 32-entry table of 2^(i/32) and a cubic, in
// double without fused multiply-adds, rounded once; subnormal results are
// flushed to 0, as XLA's CPU code flushes them.
__device__ inline float glibc_pow10f(float q) {
  const double shift = 0x1.8p+47;
  const double xd = (double)q * 0x1.a934f0979b22dp+1;
  const double kd = (xd + shift) - shift;
  double kf = kd * 32.0;
  kf = isnan(kf) ? 0.0 : kf;
  kf = kf < -1e5 ? -1e5 : (kf > 1e5 ? 1e5 : kf);
  const long long k = (long long)kf;
  const double r = xd - kd;
  long long e = k >> 5;
  e = e < -1022 ? -1022 : (e > 1023 ? 1023 : e);
  const double s = kPow10Tab[k & 31] * __longlong_as_double((e + 1023) << 52);
  const double y = (0x1.c6af84b912394p-5 * r + 0x1.ebfce50fac4f3p-3) * (r * r) +
                   (0x1.62e42ff0c52d6p-1 * r + 1.0);
  float out = (float)(y * s);
  out = out < FLT_MIN ? 0.0f : out;
  if (isinf(q)) out = q > 0.0f ? q : 0.0f;
  return isnan(q) ? q : out;
}

}  // namespace pigeons
