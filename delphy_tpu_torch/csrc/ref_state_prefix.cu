// Reference-state prefix tables of a site sequence, in one launch: for
// each key k (the reference state ref[l], or part[l] * 4 + ref[l] under
// the partitioned tables) and each column c = 0..L,
//   nucum[k, c] = sum of nu_l over the sites l < c with key_l == k,
//   cnt[k, c]   = the number of those sites,
// column 0 zero (ops/likelihood.py calc_ref_state_prefix and
// calc_ref_state_prefix_beta).  Both tables come from one read of the
// sites; the one-hot that the plain version scans is never built.
//
// Replaces no TPU kernel: the JAX package builds the one-hot and leaves
// jnp.cumsum to XLA.  It exists because PyTorch's innermost-axis scan of a
// (K, L) tensor gives each row one block, so a 4- or 8-row table occupies
// 4 or 8 of the card's 132 SMs, each walking its row in 1,024-element
// chunks one after another (~0.31 ms a call at 197,209 sites).
//
// What bounds it on the card: bytes.  Each call reads the sites (4 bytes
// of ref, 4 of part where given, 4 or 8 of nu) and writes ROWS = 8 rows
// of L + 1 values (4 keys and both tables, or 8 keys and nucum alone): at
// L = 197,209 in float64 12.6 MB a call, ~25 MB a boundary of the mpox
// model, 3.8 us a call at 3.35 TB/s.  One SM stores ~50 GB/s, so the
// tables need tens of SMs, and few instructions an output: a thread that
// tested every site against every key (ROWS selects and adds a site)
// spent ~20 us a tile of 4,096 sites.
//
// Design.  The sites are cut into tiles of TILE = 2,048; a block of
// THREADS = 512 threads takes a tile at a time, and each of its threads
// owns one row and one chunk of CH = TILE / (THREADS / ROWS) consecutive
// sites (32 for 8 rows): one compare and one predicated add a site.  A
// tile is loaded striped (coalesced) into shared memory, a key a byte,
// the chunks padded so that the threads of a warp, a chunk each, read
// distinct banks.  A thread stages its chunk's running sums, the warp
// scans the chunk totals with shuffles (Kogge-Stone), a row's two or four
// warps add their totals in order, and the tile is stored row by row,
// striped (coalesced), each output the thread's offset plus its staged
// run.  Count rows run the same steps in int32.
//
// Across tiles: G <= 16 blocks form a thread block cluster (8 where the
// card cannot place 16) and C <= 8 clusters split the tiles; each block
// owns a contiguous run of its cluster's tiles.  Two passes, split by the
// cluster's hardware barrier (no atomic, no flag, no look-back): (1) every
// block totals its own tiles and its share of the tiles before its
// cluster's first (so each cluster has every tile total before its tiles,
// and needs nothing of another cluster) into the cluster's workspace; (2)
// after the barrier every block sums the totals of the tiles before its
// first tile, in tile order, and scans and stores its tiles, carrying each
// tile's total into the next.
//
// Fixed order: a tile total is a tree fixed by the site index (chunk runs,
// the warp's Kogge-Stone tree, the row's warps in order), the carry into
// tile t is ((T_0 + T_1) + ...) + T_{t-1} in tile order, and an output is
// (carry + (warp offset + lane offset)) + its run: every output's
// additions depend on its index alone, not on G, C, the block a tile went
// to or which block finished first.  The same input gives the same bits in
// every launch and under a CUDA graph: runs must repeat bit for bit, and a
// snapshot resume exactly, so every float sum on the card is taken in a
// fixed order.  Every entry of cnt is an exact integer, and so is every
// entry of nucum where nu is all ones (below 2**24 in float32): those
// tables equal the sequential scan's bit for bit.  Otherwise an output at
// site index i nests at most CH + 12 + i / TILE additions deep (the
// sequential scan: i), so its error bound, that depth x the unit roundoff
// x the sum of nu up to i, is no worse.
//
// Keys outside 0..K-1 add to no row.  The builds: K = 4 with or without
// cnt, K = 8 without (ROWS <= 8).  Precision: a template on `real`
// (real.cuh); delphy_ref_state_prefix is the float64 build,
// delphy_ref_state_prefix_f32 the float32 one.
#include <cooperative_groups.h>

#include <type_traits>

#include "real.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 512;
constexpr int TILE = 2048;
constexpr int LOADS = TILE / THREADS;   // sites a thread loads a tile
constexpr int MAX_CLUSTER = 16;         // non-portable (8 is portable)
constexpr int MAX_CLUSTERS = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffu;        // a key that matches no row

// inclusive scan of v over the warp's lanes, in the fixed Kogge-Stone tree
template <class T>
__device__ __forceinline__ T warp_inclusive(T v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T below = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = below + v;
  }
  return v;
}

// the inclusive scan's value of the lane below (0 on lane 0)
template <class T>
__device__ __forceinline__ T lane_below(T incl, int lane) {
  const T below = __shfl_up_sync(FULL, incl, 1);
  return lane == 0 ? T(0) : below;
}

// a thread's row and chunk, and the shared-memory layout, for ROWS rows
template <class real, int ROWS>
struct Shape {
  static constexpr int TPR = THREADS / ROWS;    // threads (chunks) a row
  static constexpr int CH = TILE / TPR;         // sites a chunk
  static constexpr int WPR = TPR / 32;          // warps a row
  static constexpr int KEY_WORDS = CH / 4 + 1;  // a chunk's key bytes, padded
  static constexpr int W_STRIDE = CH + 1;       // a chunk's weights, padded
  static constexpr int STAGE_ROW = TPR * W_STRIDE;
  // the staged runs, the weights, the key words, the offsets
  static constexpr size_t stage_bytes = sizeof(real) * ROWS * STAGE_ROW;
  static constexpr size_t w_bytes = sizeof(real) * TPR * W_STRIDE;
  static constexpr size_t key_bytes = sizeof(unsigned) * TPR * KEY_WORDS;
  static constexpr size_t smem_bytes =
      stage_bytes + w_bytes + key_bytes + sizeof(real) * THREADS;
  static_assert(TPR % 32 == 0 && CH % 4 == 0, "rows of whole warps");
};

// a tile's sites as a thread loads them, striped
template <class real>
struct Loaded {
  unsigned key[LOADS];
  real w[LOADS];
};

template <class real, int K>
__device__ __forceinline__ void load_tile(Loaded<real>& s,
                                          const int* __restrict__ ref,
                                          const int* __restrict__ part,
                                          const real* __restrict__ nu,
                                          long long tile, int L, int tid) {
#pragma unroll
  for (int q = 0; q < LOADS; ++q) {
    const long long i = tile * TILE + q * THREADS + tid;
    s.key[q] = NONE;
    s.w[q] = real(0);
    if (i < L) {
      const int key = __ldg(ref + i) + (part ? 4 * __ldg(part + i) : 0);
      s.key[q] = (key >= 0 && key < K) ? (unsigned)key : NONE;
      s.w[q] = __ldg(nu + i);
    }
  }
}

template <class real, int ROWS>
__device__ __forceinline__ void stage_tile(const Loaded<real>& s,
                                           unsigned* key_s, real* w_s,
                                           int tid) {
  using S = Shape<real, ROWS>;
  unsigned char* keys = reinterpret_cast<unsigned char*>(key_s);
#pragma unroll
  for (int q = 0; q < LOADS; ++q) {
    const int site = q * THREADS + tid;
    const int c = site / S::CH, j = site % S::CH;
    keys[c * S::KEY_WORDS * 4 + j] = (unsigned char)s.key[q];
    w_s[c * S::W_STRIDE + j] = s.w[q];
  }
}

// the running sums of this thread's key over its chunk, in site order
// (staged into run_out where STAGE), and their total; T is int for a
// count row, real for a weighted one
template <class T, bool STAGE, class real, int ROWS>
__device__ __forceinline__ T chunk_run(const unsigned* key_s,
                                       const real* w_s, int chunk,
                                       unsigned key, real* run_out) {
  using S = Shape<real, ROWS>;
  T run = T(0);
#pragma unroll
  for (int jw = 0; jw < S::CH / 4; ++jw) {
    const unsigned word = key_s[chunk * S::KEY_WORDS + jw];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = jw * 4 + b;
      if (((word >> (8 * b)) & 0xffu) == key) {
        if constexpr (std::is_integral<T>::value) {
          run += 1;
        } else {
          run = run + w_s[chunk * S::W_STRIDE + j];
        }
      }
      if constexpr (STAGE) run_out[chunk * S::W_STRIDE + j] = (real)run;
    }
  }
  return run;
}

// each row's warp totals: lane 31's inclusive scan of the chunk totals
template <class real, int ROWS>
struct WarpTotals {
  real sum[ROWS][Shape<real, ROWS>::WPR];
  int cnt[ROWS][Shape<real, ROWS>::WPR];
};

// the row's warps below `upto`, added in order (upto = WPR: the row's
// tile total)
template <class T, int ROWS, int WPR>
__device__ __forceinline__ T warps_before(const T (&wt)[ROWS][WPR], int row,
                                          int upto) {
  T s = T(0);
#pragma unroll
  for (int w = 0; w < WPR; ++w) {
    if (w < upto) s = s + wt[row][w];
  }
  return s;
}

template <class real, int K, bool COUNTS>
__global__ void __launch_bounds__(THREADS, 1)
    ref_state_prefix_kernel(const int* __restrict__ ref,
                            const int* __restrict__ part,
                            const real* __restrict__ nu,
                            real* __restrict__ cnt_out,
                            real* __restrict__ nucum_out,
                            real* __restrict__ ws, int L, int clusters) {
  constexpr int ROWS = COUNTS ? 2 * K : K;
  using S = Shape<real, ROWS>;
  constexpr int WPR = S::WPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  real* stage = reinterpret_cast<real*>(smem_raw);
  real* w_s = reinterpret_cast<real*>(smem_raw + S::stage_bytes);
  unsigned* key_s = reinterpret_cast<unsigned*>(smem_raw + S::stage_bytes +
                                                S::w_bytes);
  real* offs = reinterpret_cast<real*>(smem_raw + S::stage_bytes +
                                       S::w_bytes + S::key_bytes);
  __shared__ WarpTotals<real, ROWS> wt;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = tid / S::TPR;
  const int chunk = tid % S::TPR;
  const int wir = chunk / 32;                 // the warp within the row
  const bool counts = row >= K;               // a count row (warp-uniform)
  const unsigned key = counts ? row - K : row;
  const long long n_tiles = ((long long)L + TILE - 1) / TILE;
  const long long width = (long long)L + 1;
  const int G = gridDim.x / clusters;
  const int c = blockIdx.x / G, r = blockIdx.x % G;
  const long long c_begin = n_tiles * c / clusters;
  const long long c_end = n_tiles * (c + 1) / clusters;
  const long long t_begin = c_begin + (c_end - c_begin) * r / G;
  const long long t_end = c_begin + (c_end - c_begin) * (r + 1) / G;
  // this block's share of the tiles before the cluster's first
  const long long p_begin = c_begin * r / G, p_end = c_begin * (r + 1) / G;
  real* const ws_c = ws + (long long)c * n_tiles * ROWS;

  if (blockIdx.x == 0 && tid < ROWS) {
    real* out = tid < K ? nucum_out + tid * width
                        : cnt_out + (tid - K) * width;
    out[0] = real(0);
  }

  // pass 1: the share's and the own tiles' totals into the workspace
  const long long n_share = p_end - p_begin;
  const long long n1 = n_share + (t_end - t_begin);
  Loaded<real> ahead;
  if (n1 > 0) {
    load_tile<real, K>(ahead, ref, part, nu,
                       n_share > 0 ? p_begin : t_begin, L, tid);
  }
  for (long long i = 0; i < n1; ++i) {
    const long long t = i < n_share ? p_begin + i : t_begin + (i - n_share);
    stage_tile<real, ROWS>(ahead, key_s, w_s, tid);
    if (i + 1 < n1) {
      const long long u = i + 1 < n_share ? p_begin + i + 1
                                          : t_begin + (i + 1 - n_share);
      load_tile<real, K>(ahead, ref, part, nu, u, L, tid);
    }
    __syncthreads();
    if (counts) {
      const int v = warp_inclusive(
          chunk_run<int, false, real, ROWS>(key_s, w_s, chunk, key, nullptr),
          lane);
      if (lane == 31) wt.cnt[row][wir] = v;
    } else {
      const real v = warp_inclusive(
          chunk_run<real, false, real, ROWS>(key_s, w_s, chunk, key, nullptr),
          lane);
      if (lane == 31) wt.sum[row][wir] = v;
    }
    __syncthreads();
    if (chunk == 0) {
      ws_c[t * ROWS + row] =
          counts ? (real)warps_before(wt.cnt, row, WPR)
                 : warps_before(wt.sum, row, WPR);
    }
  }
  if (t_begin < t_end) {
    load_tile<real, K>(ahead, ref, part, nu, t_begin, L, tid);
  }

  __threadfence();
  cg::this_cluster().sync();
  if (t_begin >= t_end) return;

  // the carry into the first tile: the row's totals of the tiles before
  // it, in tile order, staged a batch at a time
  real carry = real(0);
  int carry_n = 0;
  constexpr int BATCH = (int)(S::stage_bytes / sizeof(real)) / ROWS;
  for (long long t0 = 0; t0 < t_begin; t0 += BATCH) {
    const int n = (int)(t_begin - t0 < BATCH ? t_begin - t0 : BATCH);
    for (int i = tid; i < n * ROWS; i += THREADS) {
      stage[i] = __ldcg(ws_c + t0 * ROWS + i);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const real v = stage[t * ROWS + row];
      if (counts) {
        carry_n += (int)v;
      } else {
        carry = carry + v;
      }
    }
    __syncthreads();
  }

  // pass 2: scan the tiles and store the rows
  real* const run_out = stage + row * S::STAGE_ROW;
  for (long long t = t_begin; t < t_end; ++t) {
    stage_tile<real, ROWS>(ahead, key_s, w_s, tid);
    if (t + 1 < t_end) {
      load_tile<real, K>(ahead, ref, part, nu, t + 1, L, tid);
    }
    __syncthreads();
    real lane_off = real(0);
    int lane_off_n = 0;
    if (counts) {
      const int v = warp_inclusive(
          chunk_run<int, true, real, ROWS>(key_s, w_s, chunk, key, run_out),
          lane);
      lane_off_n = lane_below(v, lane);
      if (lane == 31) wt.cnt[row][wir] = v;
    } else {
      const real v = warp_inclusive(
          chunk_run<real, true, real, ROWS>(key_s, w_s, chunk, key, run_out),
          lane);
      lane_off = lane_below(v, lane);
      if (lane == 31) wt.sum[row][wir] = v;
    }
    __syncthreads();
    if (counts) {
      offs[tid] =
          (real)(carry_n + (warps_before(wt.cnt, row, wir) + lane_off_n));
      carry_n += warps_before(wt.cnt, row, WPR);
    } else {
      offs[tid] = carry + (warps_before(wt.sum, row, wir) + lane_off);
      carry = carry + warps_before(wt.sum, row, WPR);
    }
    __syncthreads();
    const long long base = t * TILE;
#pragma unroll
    for (int i = 0; i < ROWS * LOADS; ++i) {
      const int ro = i / LOADS;
      const int site = (i % LOADS) * THREADS + tid;
      const int ch = site / S::CH;
      if (base + site < L) {
        real* out = ro < K ? nucum_out + ro * width
                           : cnt_out + (ro - K) * width;
        out[1 + base + site] =
            offs[ro * S::TPR + ch] +
            stage[ro * S::STAGE_ROW + ch * S::W_STRIDE + site % S::CH];
      }
    }
    // the next tile's first barrier orders these reads of stage and offs
    // before they are written again
  }
}

// the cluster size: 16 blocks where the card can place such a cluster of
// this kernel, else the portable 8
template <class real, int K, bool COUNTS>
int max_cluster() {
  static int found = 0;
  if (found == 0) {
    auto kern = ref_state_prefix_kernel<real, K, COUNTS>;
    int n = 0;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    cfg.gridDim = dim3(MAX_CLUSTER);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = Shape<real, COUNTS ? 2 * K : K>::smem_bytes;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = MAX_CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)cfg.dynamicSmemBytes);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    if (e != cudaSuccess) cudaGetLastError();   // clear it: a query
    found = (e == cudaSuccess && n >= 1) ? MAX_CLUSTER : 8;
  }
  return found;
}

template <class real, int K, bool COUNTS>
int launch_k(const int* ref, const int* part, const real* nu, real* cnt,
             real* nucum, real* ws, int L, cudaStream_t stream) {
  auto kern = ref_state_prefix_kernel<real, K, COUNTS>;
  const size_t smem = Shape<real, COUNTS ? 2 * K : K>::smem_bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // G blocks a cluster, up to MAX_CLUSTERS clusters of them
  const long long n_tiles = ((long long)L + TILE - 1) / TILE;
  const int cap = max_cluster<real, K, COUNTS>();
  const int g = (int)(n_tiles < 1 ? 1 : (n_tiles < cap ? n_tiles : cap));
  const long long want = (n_tiles + g - 1) / g;
  const int clusters =
      (int)(want < 1 ? 1 : (want < MAX_CLUSTERS ? want : MAX_CLUSTERS));
  if (g > 8) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(g * clusters);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, ref, part, nu, cnt, nucum, ws, L,
                         clusters);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ws: MAX_CLUSTERS x n_tiles x 8 reals, the clusters' tile totals; part
// and cnt may be null
template <class real>
int launch(const int* ref, const int* part, const real* nu, real* cnt,
           real* nucum, real* ws, int L, int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K == 4 && cnt) {
    return launch_k<real, 4, true>(ref, part, nu, cnt, nucum, ws, L, s);
  }
  if (K == 4) {
    return launch_k<real, 4, false>(ref, part, nu, cnt, nucum, ws, L, s);
  }
  if (K == 8 && !cnt) {
    return launch_k<real, 8, false>(ref, part, nu, cnt, nucum, ws, L, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int delphy_ref_state_prefix(const int* ref, const int* part,
                                       const double* nu, double* cnt,
                                       double* nucum, double* ws, int L, int K,
                                       void* stream) {
  return launch(ref, part, nu, cnt, nucum, ws, L, K, stream);
}

// the float32 build
extern "C" int delphy_ref_state_prefix_f32(const int* ref, const int* part,
                                           const float* nu, float* cnt,
                                           float* nucum, float* ws, int L,
                                           int K, void* stream) {
  return launch(ref, part, nu, cnt, nucum, ws, L, K, stream);
}
