// Kernel K1: banded slice-sampler sweep for additively separable densities.
//
// Replaces the TPU kernel pigeons_tpu/ops/pallas_slice.py:_banded_sweep_kernel.
// Every (lane, coordinate) element of the row-major [B, d] state runs its own
// one-dimensional Neal slice sampler (ENTER / DOUBLE / SHRINK / CHECK / DONE)
// for n_passes passes: the joint density of a separable path cancels from each
// coordinate's slice test, so the elements are independent.
//
// Bound on the H100: each element reads and writes 4 bytes once (8 MB at bench
// config 1), so memory is not the limit; the elements' iterations are
// (34.7M at config 1, 0.041 ms at the card's peak rates). An element needs
// 17 iterations on average there and 6 to 111, so with one thread per element
// a warp, which runs until its slowest element is DONE, spends 2.3M
// warp-iterations on work that fills 1.08M.
//
// What the design does about it. The grid is sized to the card: the SM count
// times the blocks that stay resident on an SM (asked of the runtime), each
// block with an equal contiguous share of the B * d elements, which it takes
// through shared memory in tiles of at most PIGEONS_K1_CHUNK. The block
// prepares a tile in step (values, hash states, each element's lane) and cuts
// it into one run per warp. A thread keeps one element's value and machine in
// registers until the machine is DONE; once PIGEONS_K1_REFILL of a warp's
// lanes are free, the warp stores the finished values to the tile, adds their
// three counts to per-lane sums in shared memory, and hands the next
// elements of its run to the free lanes, in lane order (a ballot and a
// population count; no exchange between warps, no atomic on a cursor). A lane
// that takes an element starts at iteration 0 with the element's own hash
// state, exactly as a fresh thread would: draws depend on the element and its
// iteration count alone. The second draw and the log are computed at ENTER
// only, and CHECK draws nothing. At the end of a tile the block stores it
// coalesced and adds each lane's sums to `stats` with one atomicAdd per lane
// and row: the sums are counts, exact in float32 in any order, so the output
// is the same bits from run to run. Nothing in device memory outlives the
// launch.
//
// Times (tools/torch_kernel_variants.py, NVIDIA H100 80GB HBM3, 700.00 W, one
// run, B = 20,480, d = 100, 3 passes): 0.407 ms against 0.542 ms for one
// thread per element; tiles of 1,024 / 2,048 / 4,096 / 8,192 elements 0.490 /
// 0.429 / 0.409 / 0.435 ms; refilling at 1 / 2 / 4 / 8 free lanes 0.418 /
// 0.413 / 0.409 / 0.419 ms. 47 registers, no spills. The loop is bound by
// instruction throughput: a warp-iteration runs roughly 215 instructions,
// most of them comparisons, selects and integer operations at half the
// float32 rate, because a warp's lanes are in all four phases at once;
// packing the lanes removes the idle ones, not that.
//
// Numerics follow the JAX kernel as XLA's CPU backend runs it: the uniforms
// are (bits >> 8) * 2^-24 + 2^-25 of chained murmur3 finalizers, log is the
// Cephes polynomial (common.cuh), the coordinate term comes from
// densities.cuh, and the step-out and shrink draws are fused multiply-adds.
// Build with --fmad=false so that nvcc fuses nothing else; the plain torch twin
// (pigeons_tpu_torch/ops/cuda_slice.py:banded_sweep_reference) then gives the
// same bits.

#include "densities.cuh"

// Two compile-time constants, so that variants can be built and timed side by
// side (tools/torch_kernel_variants.py): the most elements a block holds in
// shared memory at a time, and the number of free lanes at which a warp hands
// out new elements.
#ifndef PIGEONS_K1_CHUNK
#define PIGEONS_K1_CHUNK 4096
#endif
#ifndef PIGEONS_K1_REFILL
#define PIGEONS_K1_REFILL 4
#endif

namespace {

using namespace pigeons;

constexpr int kChunk = PIGEONS_K1_CHUNK;
constexpr int kRefill = PIGEONS_K1_REFILL;
constexpr int kThreads = 256;
static_assert(kChunk % 32 == 0 && kChunk <= 65536, "tiles are whole warps' worth of elements");
static_assert(kRefill >= 1 && kRefill <= 32, "a warp has 32 lanes");

// Lanes b that a tile of kChunk consecutive elements of the [B, d] state can touch.
inline int max_tile_lanes(int d) { return min(kChunk, (kChunk - 1) / d + 2); }

// Shared memory of a block: for each element of the tile its value, its hash
// state and the place of its lane b among the tile's lanes; for each of those
// lanes the three sums, the factor a and the seed.
inline size_t shared_bytes(int max_lanes) {
  return (size_t)kChunk * 10 + (size_t)max_lanes * 20;
}

template <CoordTerm kTerm>
__global__ void __launch_bounds__(kThreads)
banded_slice_kernel(const float* __restrict__ x, const float* __restrict__ a,
                    const int64_t* __restrict__ seeds, float* __restrict__ x_out,
                    float* __restrict__ stats, int B, int d, float W, float narrow_w, int p,
                    int n_passes, int max_iter, int share, int max_lanes) {
  float* tile = dynamic_shared();                                      // [kChunk]
  uint32_t* hash = reinterpret_cast<uint32_t*>(tile + kChunk);          // [kChunk]
  int* sums = reinterpret_cast<int*>(hash + kChunk);                    // [3][max_lanes]
  float* lane_a = reinterpret_cast<float*>(sums + 3 * max_lanes);       // [max_lanes]
  uint32_t* lane_seed = reinterpret_cast<uint32_t*>(lane_a + max_lanes);  // [max_lanes]
  uint16_t* lane_of = reinterpret_cast<uint16_t*>(lane_seed + max_lanes);  // [kChunk]
  const int tid = threadIdx.x;
  const unsigned below = (1u << (tid & 31)) - 1u;  // the warp's lanes before this one
  const int64_t n = (int64_t)B * d;

  // the block's share of the elements, cut into equal tiles of at most kChunk
  const int64_t share0 = (int64_t)blockIdx.x * share;
  const int share_len = (int)min((int64_t)share, n - share0);
  const int n_tiles = (share_len + kChunk - 1) / kChunk;
  const int tile_len = ((share_len + n_tiles - 1) / n_tiles + 31) / 32 * 32;

  for (int t = 0; t < n_tiles; ++t) {
    const int64_t start = share0 + (int64_t)t * tile_len;
    const int len = min(tile_len, share_len - t * tile_len);
    const int b0 = (int)(start / d);   // the tile's first lane
    const int c0 = (int)(start % d);   // and the coordinate it starts at
    const int n_lanes = (c0 + len - 1) / d + 1;
    for (int i = tid; i < n_lanes; i += blockDim.x) {
      lane_a[i] = a[b0 + i];
      lane_seed[i] = (uint32_t)seeds[b0 + i];
    }
    for (int i = tid; i < 3 * n_lanes; i += blockDim.x) sums[i] = 0;
    __syncthreads();
    // all threads in step: nothing of an element's start is left to the loop
    // below, where it would hold up the lanes that are in the middle of theirs
    for (int i = tid; i < len; i += blockDim.x) {
      const int bl = (c0 + i) / d;
      const uint32_t c = (uint32_t)((c0 + i) % d);
      tile[i] = x[start + i];
      hash[i] = fmix32(fmix32(lane_seed[bl] ^ (c * 0x85EBCA77u)) ^ 0x9E3779B9u);
      lane_of[i] = (uint16_t)bl;
    }
    __syncthreads();

    // The warp's own run of the tile, handed out in order: no other warp
    // takes from it, so `next` is the same in all its lanes without any
    // exchange. Each thread runs one element's machine at a time, from
    // `taken` (-1: none) to DONE, then waits for the warp to hand out more.
    const int n_warps = (blockDim.x + 31) / 32;
    const int run = ((len + n_warps - 1) / n_warps + 31) / 32 * 32;
    int next = min(tid / 32 * run, len);
    const int run_end = min(next + run, len);
    int taken = -1, bl = 0;
    float ab = 0.f, xv = 0.f;
    uint32_t base = 0u, it = 0u;
    float z = 0.f, L = 0.f, R = 0.f, lcL = 0.f, lcR = 0.f, Lb = 0.f, Rb = 0.f, cand = 0.f;
    float Lh = 0.f, Rh = 0.f, lcLh = 0.f, lcRh = 0.f;
    int acc_sum = 0, acc_n = 0, n_evals = 0;
    int phase = DONE, pass_i = 0, K = 0, n_shr = 0;

    for (;;) {
      // the same in all lanes: the warp hands out elements when enough lanes
      // are free, and puts finished ones back at the latest when none is busy
      const unsigned busy = __ballot_sync(kFullWarp, phase != DONE);
      if (busy == 0u || (next < run_end && 32 - __popc(busy) >= kRefill)) {
        if (taken >= 0 && phase == DONE) {
          tile[taken] = xv;
          atomicAdd(sums + bl, acc_sum);
          atomicAdd(sums + n_lanes + bl, acc_n);
          atomicAdd(sums + 2 * n_lanes + bl, n_evals);
          taken = -1;
        }
        if (next >= run_end) break;  // here only when no lane is busy
        const int mine = next + __popc(~busy & below);
        next += __popc(~busy);
        if (phase == DONE && mine < run_end) {
          taken = mine;
          bl = lane_of[mine];
          ab = lane_a[bl];
          base = hash[mine];
          xv = tile[mine];
          it = 0u;
          acc_sum = acc_n = n_evals = 0;
          pass_i = 0;
          phase = n_passes > 0 ? ENTER : DONE;
        }
      }
      if (phase == DONE) continue;

      // one iteration of the element's machine. Draw 2 it is uA (the step-out
      // offset at ENTER, the side in DOUBLE, the candidate in SHRINK), draw
      // 2 it + 1 is uB (the slice level, ENTER only); CHECK draws nothing.
      const bool is_enter = phase == ENTER;
      const bool ph_chk = phase == CHECK;
      const float uA = ph_chk ? 0.0f : draw(base, 2u * it);
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
                          : ph_chk          ? M
                                            : old;
      const float lp_q = coord_term<kTerm>(ab, query);
      n_evals += is_enter ? 2 : 1;
      if (is_enter) {
        z = coord_term<kTerm>(ab, old) - (-cephes_logf(draw(base, 2u * it + 1u)));
        lcL = coord_term<kTerm>(ab, L);
        lcR = lp_q;
        K = p;
      }
      it += 1u;

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
      acc_n += consider ? 1 : 0;
      const bool narrow = (R - L) <= narrow_w;
      const bool accept_shr = consider && narrow;
      const bool to_check = consider && !narrow;
      if (to_check) {
        Lh = L;
        Rh = R;
        lcLh = lcL;
        lcRh = lcR;
      }

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
      acc_sum += accepted ? 1 : 0;

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

    __syncthreads();
    for (int i = tid; i < len; i += blockDim.x) x_out[start + i] = tile[i];
    // counts per lane, far below 2^24: the float sums are exact in any order
    for (int i = tid; i < 3 * n_lanes; i += blockDim.x)
      atomicAdd(stats + (int64_t)(i / n_lanes) * B + b0 + i % n_lanes, (float)sums[i]);
    __syncthreads();  // before the next tile overwrites this one
  }
}

// The grid that fills the device the current context runs on: its SM count
// times the blocks of `shared` bytes that stay resident on one SM. Asked of
// the runtime once for each device and size.
template <class Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t shared, int* blocks) {
  static int for_device = -1, sm_count = 0, per_sm = 0;
  static size_t for_shared = 0;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != for_device || shared != for_shared) {
    err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, shared);
    if (err != cudaSuccess) return err;
    for_device = device;
    for_shared = shared;
  }
  *blocks = sm_count * per_sm;
  return cudaSuccess;
}

}  // namespace

// x, a, seeds, x_out, stats: device pointers of the [B, d] float32 states, the
// [B] float32 coordinate-term factors, the [B] int64 lane seeds (uint32 values),
// the [B, d] float32 output and the zeroed [3, B] float32 stats (accept_sum,
// accept_n, n_evals). Launches on `stream`; returns cudaGetLastError(), or the
// error of the runtime query that failed.
extern "C" int banded_slice_sweep(const float* x, const float* a, const int64_t* seeds,
                                  float* x_out, float* stats, int B, int d, float w, int p,
                                  int n_passes, int max_iter, void* stream) {
  const int64_t n = (int64_t)B * d;
  if (n == 0) return (int)cudaSuccess;
  auto kernel = banded_slice_kernel<kToyQuadratic>;
  const int max_lanes = max_tile_lanes(d);
  const size_t shared = shared_bytes(max_lanes);
  cudaError_t err = allow_shared_bytes(kernel, shared);
  if (err != cudaSuccess) return (int)err;
  int resident;
  err = resident_blocks(kernel, shared, &resident);
  if (err != cudaSuccess) return (int)err;
  if (resident < 1) return (int)cudaErrorLaunchOutOfResources;
  // equal shares, whole warps' worth, for as many blocks as stay resident
  const int64_t share = ((n + resident - 1) / resident + 31) / 32 * 32;
  if (share > INT32_MAX) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + share - 1) / share);
  PIGEONS_LAUNCH(kernel, blocks, kThreads, shared, (cudaStream_t)stream, x, a, seeds, x_out,
                 stats, B, d, w, 1.1f * w, p, n_passes, max_iter, (int)share, max_lanes);
  return (int)cudaGetLastError();
}
