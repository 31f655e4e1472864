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
// The coordinate term is a template argument (densities.cuh). With
// kVariationalQuadratic the lanes bring beta and isvar besides their factor,
// and the coordinates the reference's mean and std: the lane's are staged with
// the tile's lanes, the coordinate's (with log_norm, computed once for each)
// in a table of min(d, tile) entries, and a thread reads both when it takes an
// element, so the loop itself reads registers only. With kUserCoord, a
// user's two terms compiled from CUDA source into a library of its own
// (user_density.cuh, -DPIGEONS_USER_SOURCE), the lanes bring their beta and
// a thread the coordinate of the element it takes; the hooks read the
// source's arrays where they lie. Staging the arrays of the state's width in
// shared memory once a block bought nothing: L1 already serves those reads
// (device time 0.5749 / 0.6014 / 0.5724 ms staged against 0.5758 / 0.5752 /
// 0.5754 read in place, in turns, B = 20,480, d = 100, 3 passes, NVIDIA H100
// 80GB HBM3, 700.00 W, tools/torch_kernel_variants.py --user; 57 registers
// against 52), so it was not kept. The clock64() split (-DPIGEONS_K1_CLOCKS)
// gives the user's term 1,134 of a thread's 3,324 cycles an iteration
// against the toy term's 589 of 2,605: an IEEE division, two hooks and the
// guarded blend, which the twin's bits need, and not the reads. The toy
// term's kernel is the same instructions as before (47 registers; 63 with
// the variational term, no spills). Side by side
// (tools/torch_kernel_variants.py, NVIDIA H100 80GB HBM3, 700.00 W, d = 100,
// 3 passes, half the lanes variational): toy
// 0.1727 ms and variational 0.2088 ms at B = 5,120, 0.4560 ms and 0.6259 ms
// at B = 20,480. Both terms take as many iterations (8.92 and 8.76 million at
// B = 5,120): the gap is the term, 1,240 SASS instructions in the variational
// instance against 744, 4 blocks of 256 an SM against 5. Tried on it and not
// kept, for no gain beyond the 1-2% by which two builds of one source differ
// in turns (tools/torch_kernel_variants.py --variational): the guarded
// products' weights decided once an element; dividing by std through its
// reciprocal with one remainder correction (the true division's bits for all
// 2^32 numerators at 215 std values); reading the coordinate's table at every
// query (slower); 5 blocks an SM by __launch_bounds__ (48 registers and
// spills: 0.2169 against 0.2064 ms at B = 5,120, and the toy term slower).
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

#include "user_density.cuh"

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

// Entries of the table of coordinate parameters: every coordinate when a tile
// can hold them all (entry = coordinate), else one for each element of the
// tile (entry = place in the tile).
inline __host__ __device__ int coord_table_entries(int d) { return d <= kChunk ? d : kChunk; }

// Shared memory of a block: for each element of the tile its value, its hash
// state and the place of its lane b among the tile's lanes; for each of those
// lanes the three sums, the factor a and the seed. The variational term adds
// each lane's beta and use_var and the table of coordinate parameters (mean,
// std, log_norm); a user's term each lane's beta (and an unused slot).
inline size_t shared_bytes(int max_lanes, CoordTerm term, int d) {
  const size_t toy = (size_t)kChunk * 10 + (size_t)max_lanes * 20;
  if (term == kToyQuadratic) return toy;
  if (term == kUserCoord) return toy + (size_t)max_lanes * 8;
  return toy + (size_t)max_lanes * 8 + (size_t)coord_table_entries(d) * 12;
}

// What the variational term reads besides x, a and seeds: [B] beta and isvar,
// the reference's one-element active flag, its [d] mean and std, and the
// path's factor at beta = 1. Unused (null) with kToyQuadratic; kUserCoord
// reads beta alone.
struct VariationalArgs {
  const float* beta;
  const float* isvar;
  const float* active;
  const float* mean;
  const float* std;
  float a_target;
};

// What a user's term reads besides the state: its parameters and arrays.
struct UserTermArgs {
  DensityParams params;
  DensityArrays arrays;
};

// The parts of a thread's loop that tools/torch_kernel_variants.py --user and
// chip_smoke.py phase 12 time with clock64() in a build with
// -DPIGEONS_K1_CLOCKS (never the product's): the warp's hand-out (its ballot,
// the stores and sums of finished elements, taking the next), the draw and
// the query, the term's evaluations (at ENTER with the slice level's draw and
// log), the rest of the machine's step, and a free thread's wait for its warp.
enum K1ClockPart { kHandOut, kDrawQuery, kTermEval, kStep, kIdle, kK1ClockParts };

#ifdef PIGEONS_K1_CLOCKS
constexpr int kK1ClockThreads = 132 * 8 * 256;
// per thread (blockIdx.x * blockDim.x + threadIdx.x < kK1ClockThreads): cycles
// by part, then the loop's cycles and the iterations the thread ran
constexpr int kK1ClockColumns = kK1ClockParts + 2;
__device__ unsigned long long k1_clocks[kK1ClockThreads][kK1ClockColumns];
int k1_clock_threads = 0;  // the last launch's grid, in threads
#endif

template <CoordTerm kTerm>
__global__ void __launch_bounds__(kThreads)
banded_slice_kernel(const float* __restrict__ x, const float* __restrict__ a,
                    const int64_t* __restrict__ seeds, float* __restrict__ x_out,
                    float* __restrict__ stats, int B, int d, float W, float narrow_w, int p,
                    int n_passes, int max_iter, int share, int max_lanes, VariationalArgs va,
                    UserTermArgs ua) {
  constexpr bool kVariational = kTerm == kVariationalQuadratic;
  constexpr bool kUserTerm = kTerm == kUserCoord;
  constexpr bool kLaneBeta = kVariational || kUserTerm;
  float* tile = dynamic_shared();                                      // [kChunk]
  uint32_t* hash = reinterpret_cast<uint32_t*>(tile + kChunk);          // [kChunk]
  int* sums = reinterpret_cast<int*>(hash + kChunk);                    // [3][max_lanes]
  float* lane_a = reinterpret_cast<float*>(sums + 3 * max_lanes);       // [max_lanes]
  uint32_t* lane_seed = reinterpret_cast<uint32_t*>(lane_a + max_lanes);  // [max_lanes]
  // the variational term's: [max_lanes] beta and use_var, then the table
  float* lane_beta = reinterpret_cast<float*>(lane_seed + max_lanes);
  int* lane_use = reinterpret_cast<int*>(lane_beta + (kLaneBeta ? max_lanes : 0));
  const int n_table = kVariational ? coord_table_entries(d) : 0;
  float* c_mean = reinterpret_cast<float*>(lane_use + (kLaneBeta ? max_lanes : 0));
  float* c_std = c_mean + n_table;
  float* c_log_norm = c_std + n_table;
  uint16_t* lane_of = reinterpret_cast<uint16_t*>(c_log_norm + n_table);  // [kChunk]
  const bool table_by_coord = d <= kChunk;
  const int tid = threadIdx.x;
  const unsigned below = (1u << (tid & 31)) - 1u;  // the warp's lanes before this one
  const int64_t n = (int64_t)B * d;

  // the block's share of the elements, cut into equal tiles of at most kChunk
  const int64_t share0 = (int64_t)blockIdx.x * share;
  const int share_len = (int)min((int64_t)share, n - share0);
  const int n_tiles = (share_len + kChunk - 1) / kChunk;
  const int tile_len = ((share_len + n_tiles - 1) / n_tiles + 31) / 32 * 32;

#ifdef PIGEONS_K1_CLOCKS
  long long clk_acc[kK1ClockParts] = {};
  long long clk_last = clock64(), clk_iterations = 0;
  const long long clk0 = clk_last;
  // mark(part): the cycles since the last mark go to part
  const auto mark = [&](int part) {
    const long long now = clock64();
#pragma unroll
    for (int k = 0; k < kK1ClockParts; ++k)
      if (k == part) clk_acc[k] += now - clk_last;
    clk_last = now;
  };
#else
  const auto mark = [](int) {};
#endif

  bool ref_active = false;
  if constexpr (kVariational) {
    ref_active = va.active[0] > 0.0f;
    if (table_by_coord) {  // once for the block; the first tile's barrier covers it
      for (int c = tid; c < d; c += blockDim.x) {
        c_mean[c] = va.mean[c];
        c_std[c] = va.std[c];
        c_log_norm[c] = gaussian_log_norm(va.std[c]);
      }
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int64_t start = share0 + (int64_t)t * tile_len;
    const int len = min(tile_len, share_len - t * tile_len);
    const int b0 = (int)(start / d);   // the tile's first lane
    const int c0 = (int)(start % d);   // and the coordinate it starts at
    const int n_lanes = (c0 + len - 1) / d + 1;
    for (int i = tid; i < n_lanes; i += blockDim.x) {
      if constexpr (!kUserTerm) lane_a[i] = a[b0 + i];
      lane_seed[i] = (uint32_t)seeds[b0 + i];
      if constexpr (kUserTerm) lane_beta[i] = va.beta[b0 + i];
      if constexpr (kVariational) {
        lane_beta[i] = va.beta[b0 + i];
        lane_use[i] = (ref_active && va.isvar[b0 + i] > 0.0f) ? 1 : 0;
      }
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
      if constexpr (kVariational) {
        if (!table_by_coord) {
          c_mean[i] = va.mean[c];
          c_std[i] = va.std[c];
          c_log_norm[i] = gaussian_log_norm(va.std[c]);
        }
      }
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
    CoordParams cp{0.f, 0.f, 0.f, false, va.a_target, 0.f, 1.f, 0.f, 0};
    const auto term = [&](float v) {
      if constexpr (kUserTerm) return user_coord_term(cp, ua.params.v, ua.arrays, v);
      else return coord_term<kTerm>(cp, v);
    };
    float xv = 0.f;
    uint32_t base = 0u, it = 0u;
    float z = 0.f, L = 0.f, R = 0.f, lcL = 0.f, lcR = 0.f, Lb = 0.f, Rb = 0.f, cand = 0.f;
    float Lh = 0.f, Rh = 0.f, lcLh = 0.f, lcRh = 0.f;
    int acc_sum = 0, acc_n = 0, n_evals = 0;
    int phase = DONE, pass_i = 0, K = 0, n_shr = 0;

    for (;;) {
      mark(phase == DONE ? kIdle : kStep);
      // the same in all lanes: the warp hands out elements when enough lanes
      // are free, and puts finished ones back at the latest when none is busy
      const unsigned busy = __ballot_sync(kFullWarp, phase != DONE);
      mark(phase == DONE ? kIdle : kHandOut);
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
          if constexpr (kUserTerm) {
            cp.beta = lane_beta[bl];
            cp.c = (c0 + mine) % d;
          } else {
            cp.a = lane_a[bl];
          }
          if constexpr (kVariational) {
            cp.beta = lane_beta[bl];
            cp.w0 = 1.0f - cp.beta;
            cp.use_var = lane_use[bl] != 0;
            const int entry = table_by_coord ? (c0 + mine) % d : mine;
            cp.mean = c_mean[entry];
            cp.std = c_std[entry];
            cp.log_norm = c_log_norm[entry];
          }
          base = hash[mine];
          xv = tile[mine];
          it = 0u;
          acc_sum = acc_n = n_evals = 0;
          pass_i = 0;
          phase = n_passes > 0 ? ENTER : DONE;
        }
      }
      mark(kHandOut);
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
      mark(kDrawQuery);
      const float lp_q = term(query);
      n_evals += is_enter ? 2 : 1;
      if (is_enter) {
        z = term(old) - (-cephes_logf(draw(base, 2u * it + 1u)));
        lcL = term(L);
        lcR = lp_q;
        K = p;
      }
      mark(kTermEval);
#ifdef PIGEONS_K1_CLOCKS
      clk_iterations += 1;
#endif
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
#ifdef PIGEONS_K1_CLOCKS
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + tid;
  if (row < kK1ClockThreads) {
    for (int k = 0; k < kK1ClockParts; ++k) k1_clocks[row][k] = clk_acc[k];
    k1_clocks[row][kK1ClockParts] = clock64() - clk0;
    k1_clocks[row][kK1ClockParts + 1] = clk_iterations;
  }
#endif
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

template <CoordTerm kTerm>
int launch_banded(const float* x, const float* a, const int64_t* seeds, float* x_out,
                  float* stats, int B, int d, float w, int p, int n_passes, int max_iter,
                  const VariationalArgs& va, const UserTermArgs& ua, void* stream) {
  const int64_t n = (int64_t)B * d;
  auto kernel = banded_slice_kernel<kTerm>;
  const int max_lanes = max_tile_lanes(d);
  const size_t shared = shared_bytes(max_lanes, kTerm, d);
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
#ifdef PIGEONS_K1_CLOCKS
  k1_clock_threads = (int)blocks * kThreads;
#endif
  PIGEONS_LAUNCH(kernel, blocks, kThreads, shared, (cudaStream_t)stream, x, a, seeds, x_out,
                 stats, B, d, w, 1.1f * w, p, n_passes, max_iter, (int)share, max_lanes, va, ua);
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef PIGEONS_K1_CLOCKS
// The last launch's clock64() split, thread by thread (the grid's threads, at
// most kK1ClockThreads), copied to the host array out [max_threads]
// [kK1ClockColumns]: cycles by K1ClockPart, then the loop's cycles and the
// iterations the thread ran. Returns the number of threads copied, or minus a
// CUDA error.
extern "C" int k1_clock_split(unsigned long long* out, int max_threads) {
  const int n = min(min(k1_clock_threads, kK1ClockThreads), max_threads);
  const cudaError_t err = cudaMemcpyFromSymbol(
      out, k1_clocks, sizeof(unsigned long long) * kK1ClockColumns * (size_t)n);
  return err == cudaSuccess ? n : -(int)err;
}
#endif

#ifdef PIGEONS_USER_SOURCE
// The library of a user's coordinate terms (_build.py: build_user): x, betas,
// seeds, x_out, stats as banded_slice_sweep's, with the lanes' [B] float32
// betas in place of the factors; params (host memory) the user's
// kMaxDensityParams float32 parameters, arrays and array_lens (host memory)
// the kMaxDensityArrays device pointers of the user's float32 arrays and
// their lengths (null and 0 where there are fewer). Launches on `stream`;
// returns cudaGetLastError(), the error of the runtime query that failed, or
// cudaErrorInvalidValue for arrays that do not match their lengths.
extern "C" int banded_slice_sweep_user(const float* x, const float* betas, const int64_t* seeds,
                                       float* x_out, float* stats, int B, int d, float w, int p,
                                       int n_passes, int max_iter, const float* params,
                                       const float* const* arrays, const int* array_lens,
                                       void* stream) {
  if ((int64_t)B * d == 0) return (int)cudaSuccess;
  UserTermArgs ua{};
  for (int i = 0; i < kMaxDensityParams; ++i) ua.params.v[i] = params[i];
  for (int i = 0; i < kMaxDensityArrays; ++i) {
    ua.arrays.ptr[i] = arrays ? arrays[i] : nullptr;
    ua.arrays.n[i] = arrays ? array_lens[i] : 0;
    if (ua.arrays.n[i] < 0 || (ua.arrays.n[i] > 0) != (ua.arrays.ptr[i] != nullptr))
      return (int)cudaErrorInvalidValue;
  }
  const VariationalArgs va{betas, nullptr, nullptr, nullptr, nullptr, 0.0f};
  return launch_banded<kUserCoord>(x, nullptr, seeds, x_out, stats, B, d, w, p, n_passes,
                                   max_iter, va, ua, stream);
}
#else
// x, a, seeds, x_out, stats: device pointers of the [B, d] float32 states, the
// [B] float32 coordinate-term factors, the [B] int64 lane seeds (uint32 values),
// the [B, d] float32 output and the zeroed [3, B] float32 stats (accept_sum,
// accept_n, n_evals). `term` is a CoordTerm; kVariationalQuadratic also reads
// the [B] float32 beta and isvar, the one-element active flag, the [d] float32
// mean and std (device pointers, all null for kToyQuadratic) and a_target.
// Launches on `stream`; returns cudaGetLastError(), or the error of the runtime
// query that failed.
extern "C" int banded_slice_sweep(const float* x, const float* a, const int64_t* seeds,
                                  float* x_out, float* stats, int B, int d, float w, int p,
                                  int n_passes, int max_iter, int term, const float* beta,
                                  const float* isvar, const float* active, const float* mean,
                                  const float* std, float a_target, void* stream) {
  if ((int64_t)B * d == 0) return (int)cudaSuccess;
  const VariationalArgs va{beta, isvar, active, mean, std, a_target};
  const UserTermArgs ua{};
  if (term == kToyQuadratic)
    return launch_banded<kToyQuadratic>(x, a, seeds, x_out, stats, B, d, w, p, n_passes,
                                        max_iter, va, ua, stream);
  if (term != kVariationalQuadratic || !beta || !isvar || !active || !mean || !std)
    return (int)cudaErrorInvalidValue;
  return launch_banded<kVariationalQuadratic>(x, a, seeds, x_out, stats, B, d, w, p, n_passes,
                                              max_iter, va, ua, stream);
}
#endif
