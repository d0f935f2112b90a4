// Fused masked Hamming best/second-best search, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel orb_slam_fusion_tpu/frontend/pallas_match.py:42
// (_match_kernel, reached through masked_match_pallas). For each of M map
// points (rows) it searches N keypoints: Hamming distance over 8 32-bit
// words (XOR + popcount), masked by the pixel window |uv_mp - uv_kp|^2 <=
// r*|r| (an invalid map point carries r = -1, an invalid keypoint sits at
// 1e9) and, with the octave gate on, by |oct_mp - oct_kp| <= 1.5 unless
// oct_mp < 0. Per row it returns (best_idx, best, second) with BIG = 16384
// where masked: the lowest index wins ties, and second is the minimum over
// every column but best_idx, so a tied duplicate gives second == best and
// an all-masked row gives (0, BIG, BIG). This is masked_match_folded_plain
// in frontend/masked_match.py, bit for bit. The mode word ``flags`` holds
// the octave gate (bit 0) and the window's rounding (bit 1): off, du*du +
// dv*dv with each product rounded; on, fmaf(dv, dv, du*du), the single
// rounding XLA:CPU gives the reference's dense sum((uv - kp)**2) (the
// distributed tracker's window).
//
// What bounds it. A dense search does every (row, keypoint) pair: 8 XOR, 8
// popcount and 8 adds plus the window test. On an H100 (compute capability
// 9.0) an SM runs 64 integer adds or logic ops, 16 popcounts and 128 fp32
// adds or multiplies per clock, so a pair costs ~0.87 SM-clocks and M =
// 8192, N = 1024 needs ~28 us on 132 SMs at 1.98 GHz, however the pairs are
// scheduled. But the window masks almost every pair: on the tracking path
// the radius is 9-107 px on a 752x480 image holding 1024 keypoints, so a
// row's window holds 2-100 of them. The work the inputs need is those
// pairs, one to two orders of magnitude fewer popcounts, plus per-row
// overhead and the ~0.5 MB of input. Culled that far, what is left is
// latency: the block's set-up (load, count, scan, scatter, four barriers)
// and the chain of shared-memory loads of each row's few cell runs.
//
// Design (keypoints resident in shared memory, culled by a cell grid):
// * one fat block per SM (1024 threads, persistent: each half-warp walks
//   rows with a grid stride, 16 lanes to a row) loads all N keypoints into
//   dynamic shared memory once (48 B per keypoint: N = 1024 is 48 KB,
//   N <= 4096 fits), holding each thread's first keypoint and each
//   half-warp's first row in registers so their loads overlap the set-up;
// * the keypoints are binned into 32 px cells on a 32 x 32 torus (cell =
//   floor(coordinate / 32) mod 32; the scale is a power of two, so the cell
//   is exact and no bounding box is needed; a 752x480 image does not wrap)
//   by a counting sort with shared-memory atomics, and stored in cell
//   order, word-major, so a warp reads a run of slots without bank
//   conflicts. Keypoints that are not finite within +-2^20 px (the invalid
//   ones at 1e9) go to an overflow list after the last cell. Atomics on
//   one counter serialise, so keypoints piled into one cell cost set-up
//   time, never correctness;
// * a row whose r*|r| is negative or NaN, or whose centre is NaN (or
//   infinite with a finite radius), passes no pair and writes (0, BIG, BIG)
//   at once;
// * any other row visits only the cells within sqrt(r*|r|) of its centre,
//   the radius padded by a relative 1e-6 and 0.5 px, which covers every
//   rounding of the exact test and of the cell bounds: a run of cells per
//   torus row (two where it wraps). It visits the overflow list only when
//   its window reaches +-2^20 px. A window that wraps the whole torus (huge
//   or infinite r) scans every slot: the same exact test, no culling;
// * each lane applies the exact window and octave test, rounded as the
//   plain version rounds it (__fmul_rn/__fadd_rn/__fsub_rn keep nvcc from
//   contracting into FMAs), and only lanes that pass do the popcounts.
//   Lane-local top-2 updates and the merge across a row's lanes compare
//   (dist, index) lexicographically, so cell order gives the same answer
//   as index order; a row whose lanes found no pair skips the merge.
// For N beyond the shared-memory budget the launcher runs a chunked dense
// kernel instead (every pair, keypoints staged in 512-wide chunks).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 14;
constexpr int THREADS = 1024;              // resident kernel: 32 warps
constexpr int WARPS = THREADS / 32;
constexpr int ROW_LANES = 16;              // a half-warp per row
constexpr int ROWS_PER_BLOCK = THREADS / ROW_LANES;
constexpr int GRID = 32;                   // the torus is GRID x GRID cells
constexpr int CELLS = GRID * GRID;         // index CELLS: the overflow list
constexpr float CELL_PX = 32.0f;           // a cell is CELL_PX square
constexpr float INV_CELL = 1.0f / CELL_PX;
constexpr float BOX_LIMIT = 1048576.0f;    // 2^20 px: beyond -> overflow
constexpr float OVERFLOW_REACH = 1048000.0f;  // just below, for rounding
constexpr int MAX_RESIDENT_N = 4096;       // 48 B each: 192 KB + the grid

constexpr int CHUNK_ROWS = 8;              // chunked kernel: warp per row
constexpr int CHUNK_THREADS = 32 * CHUNK_ROWS;
constexpr int KP_CHUNK = 512;

struct Top2 {
  int best;
  int idx;
  int second;
};

__device__ __forceinline__ bool lex_less(int d, int i, int bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__device__ __forceinline__ void push(Top2& t, int d, int i) {
  // t.second is the minimum over every column seen except t.idx
  if (lex_less(d, i, t.best, t.idx)) {
    t.second = min(t.second, t.best);
    t.best = d;
    t.idx = i;
  } else {
    t.second = min(t.second, d);
  }
}

__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  // a and b cover disjoint column sets; the winner's second competes with
  // the loser's best (every loser column differs from the winner's index)
  const bool a_wins = lex_less(a.best, a.idx, b.best, b.idx);
  Top2 w = a_wins ? a : b;
  const Top2 l = a_wins ? b : a;
  w.second = min(w.second, l.best);
  return w;
}

// Merge the top-2 states of the ``width`` lanes (in ``mask``) of a row.
__device__ __forceinline__ Top2 row_merge(Top2 t, unsigned mask, int width) {
  for (int off = width / 2; off > 0; off >>= 1) {
    Top2 o;
    o.best = __shfl_down_sync(mask, t.best, off, width);
    o.idx = __shfl_down_sync(mask, t.idx, off, width);
    o.second = __shfl_down_sync(mask, t.second, off, width);
    t = merge(t, o);
  }
  return t;
}

constexpr int FLAG_OCTAVE = 1;              // the octave gate
constexpr int FLAG_FUSED = 2;               // fmaf(dv, dv, du*du) window

// The window and octave test of masked_match_folded_plain, same rounding.
__device__ __forceinline__ bool passes(float mu, float mv, float r2, float mo,
                                       int flags, float ku, float kv,
                                       float ko) {
  const float du = __fsub_rn(mu, ku);
  const float dv = __fsub_rn(mv, kv);
  const float du2 = __fmul_rn(du, du);
  const float d2 = (flags & FLAG_FUSED) ? __fmaf_rn(dv, dv, du2)
                                        : __fadd_rn(du2, __fmul_rn(dv, dv));
  bool ok = d2 <= r2;
  if (flags & FLAG_OCTAVE)
    ok = ok && (fabsf(__fsub_rn(mo, ko)) <= 1.5f || mo < 0.f);
  return ok;
}

// The cell of a keypoint on the 32 x 32 torus of CELL_PX cells, or the
// overflow list (CELLS) when it is not finite within +-2^20 px. The scale
// by 1/32 is exact, so the cell is exact too.
__device__ __forceinline__ int cell_of(float4 q) {
  if (!(fabsf(q.x) <= BOX_LIMIT && fabsf(q.y) <= BOX_LIMIT)) return CELLS;
  const int cx = static_cast<int>(floorf(q.x * INV_CELL)) & (GRID - 1);
  const int cy = static_cast<int>(floorf(q.y * INV_CELL)) & (GRID - 1);
  return cy * GRID + cx;
}

// The cells [c0, c0 + n) along one axis that hold every coordinate within
// [a - R, a + R] (R already padded); n = GRID when they wrap the torus.
__device__ __forceinline__ void axis_cells(float a, float R, int& c0,
                                           int& n) {
  const float lo = fmaxf((a - R) * INV_CELL, -16777216.f);
  const float hi = fminf((a + R) * INV_CELL, 16777216.f);
  const int l = static_cast<int>(floorf(lo)), h = static_cast<int>(floorf(hi));
  n = min(h - l + 1, GRID);
  c0 = l & (GRID - 1);
}

__global__ void __launch_bounds__(THREADS)
masked_match_resident(const float4* __restrict__ uvr,      // (M) u, v, r, oct
                      const int4* __restrict__ mp_desc,    // (M, 8)
                      const float4* __restrict__ kp_uvo,   // (N) u, v, oct, -
                      const int4* __restrict__ kp_desc,    // (N, 8)
                      int M, int N, int flags,
                      int* __restrict__ best_idx, int* __restrict__ best_out,
                      int* __restrict__ second_out) {
  extern __shared__ int4 smem4[];
  int* s_desc = reinterpret_cast<int*>(smem4);             // [8][N], by slot
  float* s_u = reinterpret_cast<float*>(s_desc + 8 * N);   // [N]
  float* s_v = s_u + N;
  float* s_o = s_v + N;
  int* s_idx = reinterpret_cast<int*>(s_o + N);            // slot -> column
  int* s_start = s_idx + N;                                // [CELLS + 2]
  int* s_cursor = s_start + CELLS + 2;                     // [CELLS + 1]
  __shared__ int s_sum[WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // Loads whose latency the set-up hides: this thread's first keypoint
  // (kept in registers through the set-up) and this half-warp's first row.
  const int hl = lane % ROW_LANES;
  const unsigned hmask = ((1u << ROW_LANES) - 1u) << (lane - hl);
  const int row0 = blockIdx.x * ROWS_PER_BLOCK + tid / ROW_LANES;
  const int stride = gridDim.x * ROWS_PER_BLOCK;
  float4 p = make_float4(0.f, 0.f, -1.f, 0.f);
  int4 da = make_int4(0, 0, 0, 0), db = da;
  if (row0 < M) {
    p = uvr[row0];
    da = mp_desc[2 * row0];
    db = mp_desc[2 * row0 + 1];
  }
  float4 q0 = make_float4(NAN, NAN, 0.f, 0.f);
  int4 ka = make_int4(0, 0, 0, 0), kb = ka;
  if (tid < N) {
    q0 = kp_uvo[tid];
    ka = kp_desc[2 * tid];
    kb = kp_desc[2 * tid + 1];
  }
  for (int c = tid; c <= CELLS; c += THREADS) s_cursor[c] = 0;
  __syncthreads();

  // ---- 1. count per cell -------------------------------------------------
  for (int k = tid; k < N; k += THREADS)
    atomicAdd(&s_cursor[cell_of(k == tid ? q0 : kp_uvo[k])], 1);
  __syncthreads();

  // ---- 2. exclusive scan of the counts (block-wide) ----------------------
  {
    constexpr int PER = (CELLS + 1 + THREADS - 1) / THREADS;
    int cnt[PER];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid * PER + i;
      cnt[i] = c <= CELLS ? s_cursor[c] : 0;
      sum += cnt[i];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) s_sum[warp] = incl;
    __syncthreads();
    int run = incl - sum;
    for (int w = 0; w < warp; ++w) run += s_sum[w];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid * PER + i;
      if (c <= CELLS) {
        s_start[c] = run;
        s_cursor[c] = run;
      }
      run += cnt[i];
    }
    if (tid == 0) s_start[CELLS + 1] = N;
  }
  __syncthreads();

  // ---- 3. scatter the keypoints into their slots, in cell order ----------
  for (int k = tid; k < N; k += THREADS) {
    float4 q = q0;
    int4 a = ka, b = kb;
    if (k != tid) {
      q = kp_uvo[k];
      a = kp_desc[2 * k];
      b = kp_desc[2 * k + 1];
    }
    const int slot = atomicAdd(&s_cursor[cell_of(q)], 1);
    s_u[slot] = q.x;
    s_v[slot] = q.y;
    s_o[slot] = q.z;
    s_idx[slot] = k;
    s_desc[0 * N + slot] = a.x;
    s_desc[1 * N + slot] = a.y;
    s_desc[2 * N + slot] = a.z;
    s_desc[3 * N + slot] = a.w;
    s_desc[4 * N + slot] = b.x;
    s_desc[5 * N + slot] = b.y;
    s_desc[6 * N + slot] = b.z;
    s_desc[7 * N + slot] = b.w;
  }
  __syncthreads();

  // ---- 4. rows: a half-warp per row, grid-stride, next row prefetched ----
  const int overflow0 = s_start[CELLS];
  for (int row = row0; row < M; row += stride) {
    const float mu = p.x, mv = p.y, mo = p.w;
    const float r2 = __fmul_rn(p.z, fabsf(p.z));
    const int md[8] = {da.x, da.y, da.z, da.w, db.x, db.y, db.z, db.w};
    const int next = row + stride;
    if (next < M) {
      p = uvr[next];
      da = mp_desc[2 * next];
      db = mp_desc[2 * next + 1];
    }
    const bool centre_inf = isinf(mu) || isinf(mv);
    if (!(r2 >= 0.f) || isnan(mu) || isnan(mv) || (centre_inf && !isinf(r2))) {
      if (hl == 0) {                           // no pair can pass
        best_idx[row] = 0;
        best_out[row] = BIG;
        second_out[row] = BIG;
      }
      continue;
    }
    Top2 t = {BIG, 0, BIG};                    // as if every column masked

    auto scan = [&](int s0, int s1) {
      for (int s = s0 + hl; s < s1; s += ROW_LANES) {
        if (passes(mu, mv, r2, mo, flags, s_u[s], s_v[s], s_o[s])) {
          int d = 0;
#pragma unroll
          for (int w = 0; w < 8; ++w) d += __popc(md[w] ^ s_desc[w * N + s]);
          push(t, d, s_idx[s]);
        }
      }
    };

    // A pair passes only if |u - ku| and |v - kv| are at most
    // sqrt(r2) * (1 + 2^-22): pad R by a relative 1e-6 and 0.5 px, more than
    // the rounding of R and of the cell bounds below.
    const float R = __fmaf_ru(sqrtf(r2), 1.000001f, 0.5f);
    int cx0, nx, cy0, ny;
    axis_cells(mu, R, cx0, nx);
    axis_cells(mv, R, cy0, ny);
    if (nx == GRID && ny == GRID) {
      scan(0, N);                              // the window covers the torus
    } else {
      const int x1 = cx0 + nx - 1;             // a run, or two if it wraps
      for (int j = 0; j < ny; ++j) {
        const int row_c = ((cy0 + j) & (GRID - 1)) * GRID;
        if (x1 < GRID) {
          scan(s_start[row_c + cx0], s_start[row_c + x1 + 1]);
        } else {
          scan(s_start[row_c + cx0], s_start[row_c + GRID]);
          scan(s_start[row_c], s_start[row_c + x1 - GRID + 1]);
        }
      }
      // an overflow keypoint is finite only beyond +-2^20 px: a window that
      // stays well inside cannot reach it
      if (fabsf(mu) + R >= OVERFLOW_REACH || fabsf(mv) + R >= OVERFLOW_REACH)
        scan(overflow0, N);
    }
    if (!__any_sync(hmask, t.best < BIG)) {
      if (hl == 0) {                           // nothing passed
        best_idx[row] = 0;
        best_out[row] = BIG;
        second_out[row] = BIG;
      }
      continue;
    }
    t = row_merge(t, hmask, ROW_LANES);
    if (hl == 0) {
      best_idx[row] = t.idx;
      best_out[row] = t.best;
      second_out[row] = t.second;
    }
  }
}

// Dense path for N beyond the shared-memory budget: every pair, keypoints
// staged through static shared memory in chunks, a warp per row.
__global__ void __launch_bounds__(CHUNK_THREADS)
masked_match_chunked(const float4* __restrict__ uvr,
                     const int* __restrict__ mp_desc,
                     const float4* __restrict__ kp_uvo,
                     const int* __restrict__ kp_desc, int M, int N,
                     int flags, int* __restrict__ best_idx,
                     int* __restrict__ best_out,
                     int* __restrict__ second_out) {
  __shared__ int s_desc[8][KP_CHUNK];
  __shared__ float s_u[KP_CHUNK];
  __shared__ float s_v[KP_CHUNK];
  __shared__ float s_o[KP_CHUNK];

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * CHUNK_ROWS + (threadIdx.x >> 5);
  const bool live = row < M;

  float mu = 0.f, mv = 0.f, r2 = -1.f, mo = -1.f;
  int md[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) md[w] = 0;
  if (live) {
    const float4 p = uvr[row];
    mu = p.x;
    mv = p.y;
    r2 = __fmul_rn(p.z, fabsf(p.z));
    mo = p.w;
#pragma unroll
    for (int w = 0; w < 8; ++w) md[w] = mp_desc[row * 8 + w];
  }

  Top2 t = {BIG, 0, BIG};
  for (int base = 0; base < N; base += KP_CHUNK) {
    const int n = min(KP_CHUNK, N - base);
    __syncthreads();  // previous chunk fully consumed
    for (int i = threadIdx.x; i < n * 8; i += CHUNK_THREADS) {
      const int k = i >> 3, w = i & 7;     // coalesced global read
      s_desc[w][k] = kp_desc[(base + k) * 8 + w];
    }
    for (int k = threadIdx.x; k < n; k += CHUNK_THREADS) {
      const float4 q = kp_uvo[base + k];
      s_u[k] = q.x;
      s_v[k] = q.y;
      s_o[k] = q.z;
    }
    __syncthreads();
    if (live) {
      for (int k = lane; k < n; k += 32) {
        if (passes(mu, mv, r2, mo, flags, s_u[k], s_v[k], s_o[k])) {
          int d = 0;
#pragma unroll
          for (int w = 0; w < 8; ++w) d += __popc(md[w] ^ s_desc[w][k]);
          push(t, d, base + k);
        }
      }
    }
  }
  t = row_merge(t, 0xffffffffu, 32);
  if (live && lane == 0) {
    best_idx[row] = t.idx;
    best_out[row] = t.best;
    second_out[row] = t.second;
  }
}

size_t resident_smem(int N) {
  return static_cast<size_t>(N) * (8 * 4 + 3 * 4 + 4) +
         static_cast<size_t>(2 * CELLS + 3) * 4;
}

}  // namespace

extern "C" int osf_masked_match(const void* uvr, const void* mp_desc,
                                const void* kp_uvo, const void* kp_desc,
                                int M, int N, int flags, void* best_idx,
                                void* best, void* second, void* stream) {
  if (M <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > MAX_RESIDENT_N) {
    const int blocks = (M + CHUNK_ROWS - 1) / CHUNK_ROWS;
    masked_match_chunked<<<blocks, CHUNK_THREADS, 0, st>>>(
        static_cast<const float4*>(uvr), static_cast<const int*>(mp_desc),
        static_cast<const float4*>(kp_uvo), static_cast<const int*>(kp_desc),
        M, N, flags, static_cast<int*>(best_idx),
        static_cast<int*>(best), static_cast<int*>(second));
    return static_cast<int>(cudaGetLastError());
  }
  // per device: SM count, and blocks per SM for the last shared-memory size
  static int cached_dev = -1, sms = 0, per_sm = 0;
  static size_t cached_smem = 0;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const size_t smem = resident_smem(N);
  if (dev != cached_dev || smem != cached_smem) {
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rc = cudaFuncSetAttribute(masked_match_resident,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, masked_match_resident, THREADS, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    cached_dev = dev;
    cached_smem = smem;
  }
  // every block loads all keypoints: no more blocks than rows need
  const int need = (M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const int blocks = need < sms * per_sm ? need : sms * per_sm;
  masked_match_resident<<<blocks, THREADS, smem, st>>>(
      static_cast<const float4*>(uvr), static_cast<const int4*>(mp_desc),
      static_cast<const float4*>(kp_uvo), static_cast<const int4*>(kp_desc),
      M, N, flags, static_cast<int*>(best_idx), static_cast<int*>(best),
      static_cast<int*>(second));
  return static_cast<int>(cudaGetLastError());
}
