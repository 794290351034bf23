// Inclusive prefix sum of a contiguous 1-D array, y[i] = x[0] + ... + x[i],
// in an order of additions fixed by the index alone, in one launch of one
// block.
//
// Replaces no TPU kernel: the JAX package leaves jnp.cumsum to XLA.  It
// exists because the port's runs must repeat themselves bit for bit (and a
// snapshot resume exactly), so every float sum on the card is taken in a
// fixed order (ops/likelihood.py cumsum0, add_at).  PyTorch's 1-D CUDA
// cumsum combines its tiles in whatever order they finish, and its scan
// along the first axis of an (n, 2) tensor, the fixed-order stand-in this
// kernel takes over, gives each column one thread: n dependent float64
// adds on one thread, each waiting for its own load, ~96 ns an element
// (1.8 ms for the 18,959 sites of the Ebola dataset).
//
// What bounds it on the card: at the main path's lengths (n = 161 nodes,
// 18,959 or 18,960 sites; 29,904 for SARS-CoV-2, 197,210 for mpox) neither
// bytes (16 n for float64: 0.3 MB, 0.1 us at 3.35 TB/s) nor operations, but
// the launch, the latency of the first tile's loads and four block
// barriers a tile.  One block streams at one SM's rate: its loads in
// flight (one tile, 32 KB) over the load latency, tens of GB/s, so beyond
// a few hundred thousand elements the time grows with n well below the HBM
// rate; a multi-block scan in the same fixed order (block totals, their
// scan, the blocks again with their offsets) would be the remedy there.
//
// Design: THREADS = 1024 threads walk the array in tiles of 32 KB (4
// float64 or 8 float32 elements a thread), in order.  A tile is loaded
// striped (element j * THREADS + tid of the tile: neighbouring threads on
// neighbouring addresses), staged in shared memory and read back blocked
// (thread tid owns the run tid * ITEMS .. tid * ITEMS + ITEMS - 1); the
// next tile's striped loads are issued into registers before this tile's
// scan, so their latency overlaps it.  Each thread adds its run in order;
// the warp scans its threads' run totals with shuffles (Kogge-Stone: step
// d adds the value d lanes below), lane 31 writes the warp's total, warp 0
// scans the 32 warp totals the same way, and every thread adds its offset
// (the tiles before, then its warp's and its lane's exclusive offsets) to
// its run, writes it back blocked, and the tile is stored striped
// (coalesced).  Shared memory has one slot of padding after every 128
// bytes, so the blocked reads and writes meet no bank conflict.  The
// running total of the tiles before is carried by every thread, each
// adding the same tile totals in the same order.
//
// Fixed order: each output is ((carry + warp offset) + lane offset) + run,
// each of those a sum whose terms and tree depend on the element's index
// and the tile size alone: no atomic, no look-back at whichever block
// finished first, and one block, so nothing depends on timing.  The same
// input gives the same bits in every launch and under a CUDA graph.  An
// exclusive offset is the inclusive scan of the lane (or warp) below, never
// an inclusive one less the own value, so no subtraction enters.  Elements
// past n are read as zero and not stored.  The rounding differs from the
// sequential scan's (torch.cumsum on the CPU): the additions behind output
// i nest at most ITEMS + 12 + k deep (k = i / TILE, its tile) instead of i
// deep, so its error bound, that depth x the unit roundoff x the sum of
// |x| up to i, is tighter.
//
// Precision: a template on `real` (real.cuh).  delphy_prefix_scan is the
// float64 build, delphy_prefix_scan_f32 the float32 one.
#include "real.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_BYTES = 32 * 1024;
constexpr unsigned FULL = 0xffffffffu;

// inclusive scan of v over the warp's lanes, in the fixed Kogge-Stone tree
template <class real>
__device__ __forceinline__ real warp_inclusive(real v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const real below = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = below + v;
  }
  return v;
}

// the inclusive scan's value of the lane below (0 on lane 0)
template <class real>
__device__ __forceinline__ real lane_below(real incl, int lane) {
  const real below = __shfl_up_sync(FULL, incl, 1);
  return lane == 0 ? real(0) : below;
}

// elements of a 128-byte row of shared memory
template <class real>
__host__ __device__ constexpr int row() {
  return 128 / (int)sizeof(real);
}

// the shared-memory slot of a tile's element i: one slot of padding after
// every row, so a blocked access (stride ITEMS) hits each bank once and a
// striped one (consecutive lanes) stays contiguous
template <class real>
__device__ __forceinline__ int slot(int i) {
  return i + i / row<real>();
}

template <class real>
__global__ void __launch_bounds__(THREADS, 1)
    prefix_scan_kernel(const real* __restrict__ x, real* __restrict__ y,
                       long long n) {
  constexpr int ITEMS = TILE_BYTES / (THREADS * (int)sizeof(real));
  constexpr int TILE = THREADS * ITEMS;
  __shared__ real stage[TILE + TILE / row<real>()];
  __shared__ real warp_offset[WARPS];
  __shared__ real tile_total;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  real ahead[ITEMS];  // the next tile, striped
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = (long long)j * THREADS + tid;
    ahead[j] = i < n ? x[i] : real(0);
  }
  real carry = real(0);
  for (long long base = 0; base < n; base += TILE) {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      stage[slot<real>(j * THREADS + tid)] = ahead[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = base + TILE + (long long)j * THREADS + tid;
      ahead[j] = i < n ? x[i] : real(0);
    }
    real run[ITEMS];
    run[0] = stage[slot<real>(tid * ITEMS)];
#pragma unroll
    for (int j = 1; j < ITEMS; ++j) {
      run[j] = run[j - 1] + stage[slot<real>(tid * ITEMS + j)];
    }
    const real incl = warp_inclusive(run[ITEMS - 1], lane);
    const real lane_off = lane_below(incl, lane);
    if (lane == 31) warp_offset[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const real w = warp_inclusive(warp_offset[lane], lane);
      warp_offset[lane] = lane_below(w, lane);
      if (lane == 31) tile_total = w;
    }
    __syncthreads();
    // each thread writes back over the run it read, then stores striped
    const real off = carry + (warp_offset[warp] + lane_off);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      stage[slot<real>(tid * ITEMS + j)] = off + run[j];
    }
    carry = carry + tile_total;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = base + (long long)j * THREADS + tid;
      if (i < n) y[i] = stage[slot<real>(j * THREADS + tid)];
    }
    // the next tile's staging writes the slots this thread just read, and
    // its first barrier orders every read of warp_offset and tile_total
    // before they are written again
  }
}

template <class real>
int launch(const real* x, real* y, int n, void* stream) {
  prefix_scan_kernel<real><<<1, THREADS, 0, (cudaStream_t)stream>>>(x, y, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int delphy_prefix_scan(const double* x, double* y, int n,
                                  void* stream) {
  return launch(x, y, n, stream);
}

// the float32 build
extern "C" int delphy_prefix_scan_f32(const float* x, float* y, int n,
                                      void* stream) {
  return launch(x, y, n, stream);
}
