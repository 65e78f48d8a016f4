// Fused correlation build for Hopper (sm_90a).
//
// Three kernels replace the TPU kernel
// smk_tpu/ops/pallas_build.py::_corr_kernel (:179-234), launched by
// _fused_build (:237-327). For each (k, s) matrix of the output they
// compute, per pair (i, j),
//
//   dist = sqrt(sum_c (a[k, i, c] - b[k, j, c])^2)      (c in d order)
//   rho  = CORRELATION_FNS[model](dist, phi[k, s])
//   ZERO_DIAG: dist = 0 on the diagonal i == j (exact unit diagonal)
//   MASKED:    rho = m_i m_j rho + (1 - m_i m_j) [i == j]   (R~ = M R M + I - M)
//   SHIFTED:   rho += shift[k, i] on the diagonal
//   ROW_MASK:  rho = r_i rho              (the kriging cross build's pad rows)
//
// into a contiguous (K, S, MA, MB) tensor of the coordinates' scalar
// type (the TPU kernel takes its dtype from the coordinates,
// pallas_build.py:285, :325). The diagonal is tested on global indices,
// as the TPU kernel does. Each kernel is a template on the scalar type;
// this one source is built twice, into a float32 library (entry point
// smk_fused_corr) and, with -DSMK_FUSED_CORR_F64, a float64 one
// (smk_fused_corr_f64), so that the two builds run in parallel.
//
//   fused_corr_kernel        (layout 0): one block per 32 x 32 output
//                            tile, 256 threads, each thread 4 rows of
//                            one column. The first port's kernel; no
//                            entry point runs it any more, and the other
//                            two are held against it bit for bit, at
//                            both types.
//   fused_corr_sym_kernel    (layout 1, every masked build and square
//                            same-coordinates builds wider than 256):
//                            computes only the tile pairs I <= J and
//                            stores each off-diagonal pair twice, at
//                            (I, J) and mirrored at (J, I). 64 x 64 tiles
//                            at float, 32 x 32 at double (below).
//   fused_corr_narrow_kernel (layout 2, every cross build, pallas_build.py
//                            :387, and square builds of at most 256
//                            columns, such as the kriging test stack
//                            (t, t), :349): whole rows, no shared memory.
//
// Bound on the H100: a build writes S*MA*MB*sizeof(T) bytes per k and
// reads only O((MA + MB) d) coordinates, so it is write-bound: the
// (32, 1, 3906, 3906) build writes 1.95 GB at float, at least 0.58 ms at
// 3.35 TB/s. Its ~15 fp32 operations per element count 0.1 ms at
// 67 TFLOP/s, but IEEE sqrtf, accurate expf, the rounded blend, the
// diagonal and bounds tests and the address arithmetic make issue time
// a second limit. At m = 3906 the symmetric kernel (0.86 ms) meets the
// two about equally: without its stores it takes 0.81 ms, and without
// sqrt, exp and the blend 0.87 ms, against 0.60 ms for a plain fill of
// the same bytes, so its stores alone hold it there (the sector shared
// where one row ends and the next begins, and the scalar stores at the
// row ends). At m = 3904, where every row starts on a sector, issue
// time leads: 0.81 ms without stores, 0.67 ms without the arithmetic
// (H100 80GB HBM3, 700 W; scripts/torch_build_probe.py).
//
// Writes that cover a 32-byte sector only in part cost far more than
// whole ones: with column segments aligned to the 64-column tiles
// instead of to sectors, the symmetric kernel takes 0.80 ms at
// m = 3904 (every row starts on a sector) but 1.82 ms at m = 3906
// (rows start 8 bytes apart mod 32; torch_build_probe.py). The tile
// kernel's 32-element rows share sectors the same way. So the symmetric
// kernel:
//   - writes whole sectors only: each row's column segments start on a
//     sector boundary (shifted left by the row's offset into its
//     sector, below), so a segment is aligned 16-byte stores; only the
//     sector where one row ends and the next begins is shared;
//   - computes one half: an off-diagonal tile pair is computed once,
//     with a one-sector halo, into a shared-memory region, and both its
//     stores, at (I, J) and mirrored at (J, I), read that region, so
//     both are coalesced rows. The output bytes stay the same
//     (cuSOLVER's potrf reads the lower triangle, but the u-draw
//     multiplies by the full matrix). Stores are evict-first (__stcs):
//     the output is ~40 times the 50 MB L2;
//   - compiles d = 2, the fit's only dimension, as a constant, holding
//     a thread's column coordinates and mask in registers (any other d
//     runs a generic instantiation, which at d = 2 takes 0.95 ms at
//     m = 3906 instead of 0.86: 3656 SASS instructions against 2336;
//     torch_build_probe.py generic_d2);
//   - runs persistent blocks: SMs x resident blocks walk the (ks, I, J)
//     work items with a stride; the next item's coordinate panels,
//     mask, shift and phi are loaded into registers before the current
//     item is computed and stored, and land in the other half of a
//     double buffer in shared memory after it.
//
// At double (every float64 build, SMKConfig.dtype="float64") the
// output is twice the bytes, 3.9 GB for (32, 1, 3906, 3906), at least
// 1.17 ms at 3.35 TB/s, and the arithmetic is no longer cheap: exp and
// sqrt of a double are sequences of DFMA and DMUL on the FP64 units
// (17e12 instructions a second on the H100, half the fp32 rate), not
// single instructions, so computing both halves costs about as much
// issue time as the bound itself. The same design applies at 8-byte
// elements: a sector is 4 doubles (the halo), a 16-byte store is a
// double2. Tiles are 32 x 32, not 64 x 64: the 36 x 37 region and the
// double-buffered panels take 21.6 KB of static shared memory (a 64-tile
// region alone would take 37.5 KB and need the dynamic opt-in), and 128
// threads (16 a row segment, 8 rows a pass) then split the region's
// 640 two-element groups evenly, 5 each, as 256 threads split the float
// kernel's 1280 four-element groups; the cost is a halo of 25 % of a
// tile's elements recomputed, against 12.5 % at 64.
//
// The narrow kernel (kriging builds). Its output is MA rows of MB = 64
// elements at the main path's shapes: the cross build (32, 1, 3906, 64)
// writes 32 MB at float, at least 9.5 us at 3.35 TB/s; the test stack
// (32, 1, 64, 64) writes 0.5 MB, 0.16 us, so one kernel launch is its
// floor. Neither suits a square tile: the tile kernel spends a 256-thread
// block, a shared-memory stage and a barrier on every 4 KB it writes, and
// the symmetric kernel's 72 x 72 halo regions cost more than the 64 x 64
// stack itself (0.0078 ms against 0.0063 for the narrow kernel and
// 0.0049 for an empty launch). So the narrow kernel:
//   - gives every row of the output to ceil(MB / V) threads, each of
//     which owns V = 16 / sizeof(T) columns (4 floats, 2 doubles) and
//     keeps their coordinates in registers for as long as its items
//     share them (the whole run when the columns' coordinates are
//     shared over K, as the test sites are); a row's own coordinates,
//     row mask and phi are broadcast loads;
//   - stores each thread's V values of a row as one 16-byte evict-first
//     store where rows start on 16 bytes (MB % V == 0: at MB = 64 a warp
//     writes two whole 256-byte rows at float, one 512-byte row at
//     double), else as V scalar stores whose columns are strided so that
//     each store instruction of a warp covers consecutive columns
//     (MB = 123 and other ragged widths);
//   - needs no shared memory and no barrier: a work item is (ks, a strip
//     of rows); strips are 96 rows, fewer where that would leave SMs
//     idle (the 64 x 64 stack runs 128 items of 16 rows), and the grid
//     is persistent (SMs x resident blocks) only where there are more
//     items than that;
//   - loads the row operands of 4 passes over a strip together, before
//     it computes and stores the first of them;
//   - folds the sampler's row mask into the store (ROW_MASK: the product
//     r_i rho the sampler took as a separate pass over the output);
//   - compiles d = 2 as a constant beside one generic instantiation, as
//     the symmetric kernel does. Rows wider than 256 threads' worth
//     (1024 floats, 512 doubles) are cut into column panels.
// What holds it at the cross build (32, 1, 3906, 64), device time on an
// H100 80GB HBM3 at 700 W (scripts/torch_build_probe.py --narrow):
// with 64-row strips 0.021-0.022 ms, the same without its stores,
// 0.015 ms without sqrt, exp and the row mask, against 0.013 ms for a
// fill of the same bytes: its instruction stream, not its stores. Each
// work item also pays a start: 32-row strips take 0.025 ms, 48-row
// 0.022, 96-row 0.020-0.021, 128-row 0.021 (and 6-13 % slower than 96
// at t = 123). One pass's operands at a time takes 0.022 ms;
// loading the next item's first batch while one is computed (64
// registers instead of 52) was 2 % slower. It beats the tile kernel at
// every cross width measured (t = 123, 1024, 4096: 0.036, 0.191, 0.73
// ms against 0.058, 0.403, 1.57 ms; chip_smoke.py), so it takes every
// cross build.
//
// Guards: every read and write is bounded at the ragged edge: nothing
// outside the inputs is read, nothing outside the output is written.
// Shared memory stays under 48 KB (no opt-in needed); nothing is
// allocated; the entry point returns cudaGetLastError().
//
// Numerics: expf / exp (not __expf), IEEE sqrt and division (no fast
// math), and the distance sum and the mask blend are rounded operation
// by operation (__fmul_rn / __fadd_rn, __dmul_rn / __dadd_rn: no
// contraction into FMA), so the result follows the plain version's
// arithmetic. All three kernels run the same per-pair code, and
// (x - y)^2 == (y - x)^2 and m_i m_j == m_j m_i in IEEE, so the
// symmetric and narrow kernels' outputs are bitwise equal to the tile
// kernel's at either type, and square builds are symmetric bit for bit
// by construction.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS_PER_THREAD = 4;
constexpr int BLOCK_Y = TILE / ROWS_PER_THREAD;  // 8: 256 threads
constexpr int MAX_D = 8;

// The rounded operations of the per-pair arithmetic, by scalar type,
// each rounded on its own (no FMA contraction), in the plain version's
// order; and the 16-byte vector of the type (VEC elements), the widest
// store.
template <typename T>
struct Num;

template <>
struct Num<float> {
  using vec = float4;
  static constexpr int VEC = 4;
  static constexpr float SQRT3 = 1.7320508075688772f;
  static constexpr float SQRT5 = 2.23606797749979f;
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float exp(float a) { return expf(a); }
  static __device__ __forceinline__ float sqrt(float a) { return sqrtf(a); }
  static __device__ __forceinline__ float max(float a, float b) { return fmaxf(a, b); }
  static __device__ __forceinline__ float4 pack(const float* e) {
    return make_float4(e[0], e[1], e[2], e[3]);
  }
  static __device__ __forceinline__ void unpack(float4 v, float* e) {
    e[0] = v.x; e[1] = v.y; e[2] = v.z; e[3] = v.w;
  }
  static __device__ __forceinline__ float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};

template <>
struct Num<double> {
  using vec = double2;
  static constexpr int VEC = 2;
  static constexpr double SQRT3 = 1.7320508075688772;
  static constexpr double SQRT5 = 2.23606797749979;
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double exp(double a) { return ::exp(a); }
  static __device__ __forceinline__ double sqrt(double a) { return ::sqrt(a); }
  static __device__ __forceinline__ double max(double a, double b) { return fmax(a, b); }
  static __device__ __forceinline__ double2 pack(const double* e) { return make_double2(e[0], e[1]); }
  static __device__ __forceinline__ void unpack(double2 v, double* e) { e[0] = v.x; e[1] = v.y; }
  static __device__ __forceinline__ double2 zero() { return make_double2(0.0, 0.0); }
};

template <int MODEL, typename T>
__device__ __forceinline__ T corr(T dist, T phi) {
  using N = Num<T>;
  if (MODEL == 0) {  // exponential
    return N::exp(N::mul(-phi, dist));
  } else if (MODEL == 1) {  // matern32
    const T t = N::mul(N::mul(N::SQRT3, phi), dist);
    return N::mul(N::add(T(1), t), N::exp(-t));
  } else {  // matern52
    const T t = N::mul(N::mul(N::SQRT5, phi), dist);
    const T poly = N::add(N::add(T(1), t), N::mul(t, t) / T(3));
    return N::mul(poly, N::exp(-t));
  }
}

template <typename T>
struct ArgsT {
  const T* ca;
  const T* cb;
  const T* phis;
  const T* mask;
  const T* shift;
  const T* row_mask;
  T* out;
  int K, S, MA, MB, D;
  long long a_kstride, b_kstride;
};

// The per-pair arithmetic after the distance sum, shared by all three
// kernels so that they agree bit for bit (T is deduced).
template <int MODEL, bool MASKED, bool SHIFTED, bool ZERO_DIAG, typename T>
__device__ __forceinline__ T pair_value(T sq, bool diag, T phi, T mi, T mj, T sh) {
  using N = Num<T>;
  T dist = N::sqrt(N::max(sq, T(0)));
  if (ZERO_DIAG && diag) dist = T(0);
  T rho = corr<MODEL>(dist, phi);
  if (MASKED) {
    const T mm = N::mul(mi, mj);
    rho = N::add(N::mul(mm, rho), N::mul(N::sub(T(1), mm), diag ? T(1) : T(0)));
  }
  if (SHIFTED && diag) rho = N::add(rho, sh);
  return rho;
}

// The tile kernel. ROW_MASK multiplies row i by row_mask[k, i] as it is
// stored, as the narrow kernel does.
template <typename T, int MODEL, bool MASKED, bool SHIFTED, bool ZERO_DIAG, bool ROW_MASK>
__global__ void __launch_bounds__(TILE * BLOCK_Y)
fused_corr_kernel(const ArgsT<T> args) {
  using N = Num<T>;
  __shared__ T sa[TILE][MAX_D + 1];
  __shared__ T sb[MAX_D][TILE];
  __shared__ T mrow[TILE];
  __shared__ T mcol[TILE];
  __shared__ T srow[TILE];  // the rows' shift, or (ROW_MASK) their row mask

  const int D = args.D;
  const int MA = args.MA;
  const int MB = args.MB;
  const int ks = blockIdx.z;  // k * S + s
  const int k = ks / args.S;
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TILE + tx;

  // stage the tile's 32 row and 32 column coordinates; consecutive
  // threads read consecutive elements of the (m, d) row-major blocks
  const T* a = args.ca + k * args.a_kstride;
  const T* b = args.cb + k * args.b_kstride;
  for (int e = tid; e < TILE * D; e += TILE * BLOCK_Y) {
    const int r = e / D;
    const int c = e - r * D;
    const int gi = i0 + r;
    const int gj = j0 + r;
    sa[r][c] = gi < MA ? a[(long long)gi * D + c] : T(0);
    sb[c][r] = gj < MB ? b[(long long)gj * D + c] : T(0);
  }
  if (MASKED || SHIFTED || ROW_MASK) {
    if (tid < TILE) {
      const int gi = i0 + tid;
      const int gj = j0 + tid;
      const long long base = (long long)k * MA;  // square builds: MA == MB
      if (MASKED) {
        mrow[tid] = gi < MA ? args.mask[base + gi] : T(0);
        mcol[tid] = gj < MB ? args.mask[base + gj] : T(0);
      }
      if (SHIFTED) srow[tid] = gi < MA ? args.shift[base + gi] : T(0);
      if (ROW_MASK) srow[tid] = gi < MA ? args.row_mask[base + gi] : T(0);
    }
  }
  __syncthreads();

  const int j = j0 + tx;
  if (j >= MB) return;
  const T phi = args.phis[ks];
  T* out = args.out + (long long)ks * MA * MB;
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_THREAD; ++rr) {
    const int r = ty + rr * BLOCK_Y;
    const int i = i0 + r;
    if (i >= MA) break;
    T sq = T(0);
    for (int c = 0; c < D; ++c) {
      const T diff = N::sub(sa[r][c], sb[c][tx]);
      sq = N::add(sq, N::mul(diff, diff));
    }
    T v = pair_value<MODEL, MASKED, SHIFTED, ZERO_DIAG>(
        sq, i == j, phi, MASKED ? mrow[r] : T(0), MASKED ? mcol[tx] : T(0),
        SHIFTED ? srow[r] : T(0));
    if (ROW_MASK) v = N::mul(srow[r], v);
    out[(long long)i * MB + j] = v;
  }
}

// ---- the symmetric kernel ------------------------------------------
//
// Whole sectors: a 32-byte sector of the output is written by one block
// only. Output row i starts `off_i` elements into a sector (its address
// mod 32, over sizeof(T)), and its column segment J is [J*STILE - off_i,
// (J+1)*STILE - off_i), clipped to [0, MB): sector-aligned, so every
// VEC-column group of it is one aligned 16-byte store. Segment J reaches
// up to HALO - 1 columns into tile J - 1, so a pair (I, J) computes the
// region of rows [I*STILE - HALO, I*STILE + STILE) x columns [J*STILE -
// HALO, J*STILE + STILE) of its matrix (all but the HALO x HALO corner,
// which no store reads) into shared memory, once, and stores from it
// both the rows of tile I over segment J and, mirrored, the rows of tile
// J over segment I. There are ceil((MB + HALO - 1) / STILE) tiles and
// segments a side, so the last segment of every row reaches MB.

// Tile edge, threads and resident blocks asked of the compiler, by type.
template <typename T>
struct SymTiles;
template <>
struct SymTiles<float> {
  static constexpr int STILE = 64, THREADS = 256, MIN_BLOCKS = 3;
};
template <>
struct SymTiles<double> {
  static constexpr int STILE = 32, THREADS = 128, MIN_BLOCKS = 4;
};

// What follows from them. A thread serves one VEC-column group of a
// segment (QUADS groups a segment) in RPP rows of every PASSES; the
// region's groups split evenly when RPP == 2 HALO: PASSES groups a thread
// in the rows of tile I, then the HALO rows above them by the first
// HALO * QUADS threads and the HALO-column strip left of them by the
// others, LEFT groups a row.
template <typename T>
struct SymGeom {
  static constexpr int VEC = Num<T>::VEC;
  static constexpr int HALO = 32 / (int)sizeof(T);  // one sector of elements
  static constexpr int STILE = SymTiles<T>::STILE;
  static constexpr int SPAN = STILE + HALO;  // a panel's rows, the region's edge
  static constexpr int THREADS = SymTiles<T>::THREADS;
  static constexpr int QUADS = STILE / VEC;
  static constexpr int RPP = THREADS / QUADS;
  static constexpr int PASSES = STILE / RPP;
  static constexpr int LEFT = HALO / VEC;
  // coordinates a thread stages of the two panels
  static constexpr int STAGE = (2 * SPAN * MAX_D + THREADS - 1) / THREADS;
  static_assert(RPP == 2 * HALO, "the region's groups must split evenly");
  static_assert(3 * SPAN < THREADS, "mask, shift and phi need 3 SPAN + 1 threads");
};

// Work item w -> (ks, I, J) with I <= J: the tile pairs of one (k, s)
// matrix are numbered p = J (J + 1) / 2 + I, so J is the triangular
// root of p (a float square root, then an integer correction; the
// triangular numbers in 64 bits). The entry point keeps w in an int.
__device__ __forceinline__ void decode_item(int w, int pairs, int& ks, int& I,
                                            int& J) {
  ks = w / pairs;
  const long long p = w - ks * pairs;
  long long a = (long long)((sqrtf(8.0f * (float)p + 1.0f) - 1.0f) * 0.5f);
  while (a > 0 && a * (a + 1) / 2 > p) --a;
  while ((a + 1) * (a + 2) / 2 <= p) ++a;
  J = (int)a;
  I = (int)(p - a * (a + 1) / 2);
}

template <typename T>
struct __align__(16) SymShared {
  using G = SymGeom<T>;
  // coordinates of rows [I*STILE - HALO, I*STILE + STILE) and [J*STILE -
  // HALO, J*STILE + STILE), c-major, double buffered
  T pa[2][MAX_D][G::SPAN];
  T pb[2][MAX_D][G::SPAN];
  T ma[2][G::SPAN];  // mask of the pa rows
  T mb[2][G::SPAN];  // mask of the pb rows
  T sh[2][G::SPAN];  // shift of the pa rows
  T phi[2];
  // the region: val[a][b] = rho(pa row a, pb row b); the odd pitch
  // spreads a column's reads over the banks
  T val[G::SPAN][G::SPAN + 1];
};

// One work item as one thread holds it: its (ks, I, J), and what the
// thread fetches of its inputs: up to STAGE coordinates of the two
// panels, one mask or shift value, and (thread 3 SPAN) phi.
template <typename T>
struct Stage {
  int ks, I, J;
  T c[SymGeom<T>::STAGE];
  T ms;
  T phi;
};

template <typename T, bool MASKED, bool SHIFTED>
__device__ __forceinline__ void stage_load(const ArgsT<T>& args, int D, int w,
                                           int pairs, int tid, Stage<T>& st) {
  using G = SymGeom<T>;
  decode_item(w, pairs, st.ks, st.I, st.J);
  const int M = args.MA;
  const int k = st.ks / args.S;
  const T* c = args.ca + k * args.a_kstride;
  const int nd = G::SPAN * D;
#pragma unroll
  for (int q = 0; q < G::STAGE; ++q) {
    const int e = tid + q * G::THREADS;
    T v = T(0);
    if (e < 2 * nd) {
      const int panel = e >= nd;
      const int el = e - panel * nd;
      const int first = (panel ? st.J : st.I) * G::STILE - G::HALO;
      const int row = first + el / D;
      if (row >= 0 && row < M) v = c[(long long)first * D + el];
    }
    st.c[q] = v;
  }
  const long long base = (long long)k * M;
  st.ms = T(0);
  if (MASKED && tid < 2 * G::SPAN) {
    const int row = (tid < G::SPAN ? st.I : st.J) * G::STILE - G::HALO + tid % G::SPAN;
    if (row >= 0 && row < M) st.ms = args.mask[base + row];
  }
  if (SHIFTED && tid >= 2 * G::SPAN && tid < 3 * G::SPAN) {
    const int row = st.I * G::STILE - G::HALO + (tid - 2 * G::SPAN);
    if (row >= 0 && row < M) st.ms = args.shift[base + row];
  }
  if (tid == 3 * G::SPAN) st.phi = args.phis[st.ks];
}

template <typename T, bool MASKED, bool SHIFTED>
__device__ __forceinline__ void stage_store(SymShared<T>& sm, int buf, int D,
                                            int tid, const Stage<T>& st) {
  using G = SymGeom<T>;
  const int nd = G::SPAN * D;
#pragma unroll
  for (int q = 0; q < G::STAGE; ++q) {
    const int e = tid + q * G::THREADS;
    if (e < 2 * nd) {
      const int panel = e >= nd;
      const int el = e - panel * nd;
      const int r = el / D;
      const int c = el - r * D;
      (panel ? sm.pb : sm.pa)[buf][c][r] = st.c[q];
    }
  }
  if (MASKED && tid < 2 * G::SPAN) {
    (tid < G::SPAN ? sm.ma : sm.mb)[buf][tid % G::SPAN] = st.ms;
  }
  if (SHIFTED && tid >= 2 * G::SPAN && tid < 3 * G::SPAN) {
    sm.sh[buf][tid - 2 * G::SPAN] = st.ms;
  }
  if (tid == 3 * G::SPAN) sm.phi[buf] = st.phi;
}

// VEC elements from shared memory at `p` (16-byte aligned), one load
template <typename T>
__device__ __forceinline__ typename Num<T>::vec ldsv(const T* p) {
  return *reinterpret_cast<const typename Num<T>::vec*>(p);
}

// Region columns [b, b + VEC) of row a: the distance sums (pb
// coordinates from `bq` where the caller holds them, else from shared
// memory), then the per-pair tail, into val.
template <typename T, int MODEL, bool MASKED, bool SHIFTED, int DIM>
__device__ __forceinline__ void region_group(SymShared<T>& sm, int buf, int D,
                                             int a, int b,
                                             const typename Num<T>::vec* bq,
                                             typename Num<T>::vec mbq, int ia,
                                             int jb, T phi) {
  using N = Num<T>;
  constexpr int V = N::VEC;
  T sq[V];
#pragma unroll
  for (int cc = 0; cc < V; ++cc) sq[cc] = T(0);
#pragma unroll
  for (int c = 0; c < (DIM > 0 ? DIM : MAX_D); ++c) {
    if (DIM == 0 && c >= D) break;
    const T ai = sm.pa[buf][c][a];
    T bv[V];
    N::unpack(bq != nullptr ? bq[c] : ldsv(&sm.pb[buf][c][b]), bv);
#pragma unroll
    for (int cc = 0; cc < V; ++cc) {
      const T diff = N::sub(ai, bv[cc]);
      sq[cc] = N::add(sq[cc], N::mul(diff, diff));
    }
  }
  const T mi = MASKED ? sm.ma[buf][a] : T(0);
  const T si = SHIFTED ? sm.sh[buf][a] : T(0);
  T mv[V];
  N::unpack(mbq, mv);
#pragma unroll
  for (int cc = 0; cc < V; ++cc) {
    sm.val[a][b + cc] = pair_value<MODEL, MASKED, SHIFTED, true>(
        sq[cc], ia + a == jb + b + cc, phi, mi, mv[cc], si);
  }
}

// Elements from the start of its 32-byte sector to `p`.
template <typename T>
__device__ __forceinline__ int sector_offset(const T* p) {
  return (int)((reinterpret_cast<unsigned long long>(p) / sizeof(T)) &
               (SymGeom<T>::HALO - 1));
}

// Columns [j, j + VEC) of the output row at `row`, those in [0, M) only:
// one 16-byte store where all are in (the address is aligned inside a
// segment), else scalars. Evict-first: the output is ~40 times the L2
// and read back long after.
template <typename T>
__device__ __forceinline__ void storev(T* row, int j, int M, typename Num<T>::vec v) {
  constexpr int V = Num<T>::VEC;
  if (j >= 0 && j + V <= M) {
    __stcs(reinterpret_cast<typename Num<T>::vec*>(row + j), v);
    return;
  }
  T e[V];
  Num<T>::unpack(v, e);
#pragma unroll
  for (int q = 0; q < V; ++q) {
    if (j + q >= 0 && j + q < M) __stcs(row + j + q, e[q]);
  }
}

// DIM: the coordinate dimension where it is known when compiling (2,
// the only one the fit uses), 0 for any other (read from args.D).
template <typename T, int MODEL, bool MASKED, bool SHIFTED, int DIM>
__global__ void __launch_bounds__(SymTiles<T>::THREADS, SymTiles<T>::MIN_BLOCKS)
fused_corr_sym_kernel(const ArgsT<T> args, int pairs, int items) {
  using G = SymGeom<T>;
  using N = Num<T>;
  using vec = typename N::vec;
  __shared__ SymShared<T> sm;

  const int M = args.MA;
  const int D = DIM > 0 ? DIM : args.D;
  const int tid = threadIdx.x;
  // region phase: the thread's VEC columns b = HALO + VEC * quad of rows
  // rsub + RPP k (k < PASSES), then one more group (below); store phase:
  // its VEC columns VEC * quad of a segment, of rows rsub + RPP k
  const int quad = tid % G::QUADS;
  const int rsub = tid / G::QUADS;

  int w = blockIdx.x;
  if (w >= items) return;
  Stage<T> st;
  stage_load<T, MASKED, SHIFTED>(args, D, w, pairs, tid, st);
  stage_store<T, MASKED, SHIFTED>(sm, 0, D, tid, st);
  __syncthreads();

  int buf = 0;
  for (; w < items; w += gridDim.x) {
    const int ks = st.ks;
    const int I = st.I;
    const int J = st.J;
    // the next item's inputs are in flight while this one is computed
    const bool more = w + (int)gridDim.x < items;  // no overflow: items + grid < 2^31
    if (more) stage_load<T, MASKED, SHIFTED>(args, D, w + gridDim.x, pairs, tid, st);

    // The region: all but its HALO x HALO corner. Columns [HALO, SPAN)
    // of rows [0, SPAN) are QUADS x SPAN groups; threads hold their
    // column group's coordinates and mask. Columns [0, HALO) of rows
    // [HALO, SPAN) are the other LEFT x STILE groups.
    const int ia = I * G::STILE - G::HALO;  // global row of pa row 0
    const int jb = J * G::STILE - G::HALO;  // global row of pb row 0
    const T phi = sm.phi[buf];
    const int b1 = G::HALO + G::VEC * quad;
    vec bq[DIM > 0 ? DIM : 1];
#pragma unroll
    for (int c = 0; c < DIM; ++c) bq[c] = ldsv(&sm.pb[buf][c][b1]);
    const vec m1 = MASKED ? ldsv(&sm.mb[buf][b1]) : N::zero();
#pragma unroll
    for (int k = 0; k < G::PASSES; ++k) {
      region_group<T, MODEL, MASKED, SHIFTED, DIM>(
          sm, buf, D, rsub + G::RPP * k, b1, DIM > 0 ? bq : nullptr, m1, ia, jb, phi);
    }
    if (rsub < G::HALO) {
      region_group<T, MODEL, MASKED, SHIFTED, DIM>(
          sm, buf, D, G::STILE + rsub, b1, DIM > 0 ? bq : nullptr, m1, ia, jb, phi);
    } else {
      const int h = tid - G::HALO * G::QUADS;
      const int a = G::HALO + h / G::LEFT;
      const int b = G::VEC * (h % G::LEFT);
      const vec m0 = MASKED ? ldsv(&sm.mb[buf][b]) : N::zero();
      region_group<T, MODEL, MASKED, SHIFTED, DIM>(sm, buf, D, a, b, nullptr, m0,
                                                   ia, jb, phi);
    }
    __syncthreads();

    T* out = args.out + (long long)ks * M * M;
    // rows of tile I over segment J: VEC columns a thread, QUADS a row
#pragma unroll
    for (int r = 0; r < G::PASSES; ++r) {
      const int li = rsub + G::RPP * r;
      const int i = I * G::STILE + li;
      if (i < M) {
        T* row = out + (long long)i * M;
        const int b = G::HALO - sector_offset(row) + G::VEC * quad;
        storev(row, jb + b, M, N::pack(&sm.val[G::HALO + li][b]));
      }
    }
    // rows of tile J over segment I, from the same region (block-uniform)
    if (I != J) {
#pragma unroll
      for (int r = 0; r < G::PASSES; ++r) {
        const int lj = rsub + G::RPP * r;
        const int j = J * G::STILE + lj;
        if (j < M) {
          T* row = out + (long long)j * M;
          const int a = G::HALO - sector_offset(row) + G::VEC * quad;
          T e[G::VEC];
#pragma unroll
          for (int cc = 0; cc < G::VEC; ++cc) e[cc] = sm.val[a + cc][G::HALO + lj];
          storev(row, ia + a, M, N::pack(e));
        }
      }
    }
    if (more) stage_store<T, MASKED, SHIFTED>(sm, buf ^ 1, D, tid, st);
    __syncthreads();
    buf ^= 1;
  }
}

// ---- the narrow kernel ---------------------------------------------
//
// A row of the output is cut into panels of VEC * quads columns (one
// panel where MB <= VEC * NARROW_THREADS); a work item is (ks, a strip
// of `rows` rows, a panel). Thread t of the block serves row t / quads
// of every pass over the strip and VEC columns of the panel: VEC *
// (t % quads) and the next VEC - 1 where rows start on 16 bytes (`vec`),
// else t % quads + quads * c, c < VEC.

constexpr int NARROW_THREADS = 256;
constexpr int NARROW_ROWS = 96;  // rows of a work item, at most
constexpr int NARROW_BATCH = 4;  // passes whose row operands load together

struct NarrowGrid {
  int quads;   // threads a row
  int rows;    // rows of a work item: a multiple of NARROW_THREADS / quads
  int strips;  // ceil(MA / rows)
  int panels;  // column panels a row
  int items;   // K * S * strips * panels
  int vec;     // MB % VEC == 0 and the output on 16 bytes: 16-byte stores
};

template <typename T, int MODEL, bool ROW_MASK, bool ZERO_DIAG, int DIM>
__global__ void __launch_bounds__(NARROW_THREADS)
fused_corr_narrow_kernel(const ArgsT<T> args, const NarrowGrid g) {
  using N = Num<T>;
  constexpr int V = N::VEC;
  constexpr int CD = DIM > 0 ? DIM : MAX_D;  // coordinate registers a column
  const int D = DIM > 0 ? DIM : args.D;
  const int MA = args.MA;
  const int MB = args.MB;
  const int step = NARROW_THREADS / g.quads;  // rows a pass
  const int rsub = threadIdx.x / g.quads;
  const int quad = threadIdx.x - rsub * g.quads;
  if (rsub >= step) return;  // the block has no barrier
  const int jq = g.vec ? V * quad : quad;  // the thread's first column in a panel
  const int js = g.vec ? 1 : g.quads;      // and the stride of its V

  T bc[V][CD];    // the V columns' coordinates
  int held = -1;  // (k of the columns, panel) that bc holds
  for (int w = blockIdx.x; w < g.items; w += gridDim.x) {
    const int panel = w % g.panels;
    const int rest = w / g.panels;
    const int strip = rest % g.strips;
    const int ks = rest / g.strips;
    const int k = ks / args.S;
    const int j0 = panel * V * g.quads + jq;
    const int key = (args.b_kstride == 0 ? 0 : k) * g.panels + panel;
    if (key != held) {
      const T* b = args.cb + k * args.b_kstride;
#pragma unroll
      for (int cc = 0; cc < V; ++cc) {
        const int j = j0 + js * cc;
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          if (DIM == 0 && c >= D) break;
          bc[cc][c] = j < MB ? b[(long long)j * D + c] : T(0);
        }
      }
      held = key;
    }
    const T phi = args.phis[ks];
    const T* a = args.ca + k * args.a_kstride;
    T* out = args.out + (long long)ks * MA * MB;
    const int end = min(MA, (strip + 1) * g.rows);
    // NARROW_BATCH passes at a time: their rows' coordinates and masks
    // are all loaded before the first of them is computed and stored
    // (a row past the strip loads the strip's last row, and is not
    // stored)
    for (int i0 = strip * g.rows + rsub; i0 < end; i0 += NARROW_BATCH * step) {
      T ai[NARROW_BATCH][CD];
      T ri[NARROW_BATCH];
#pragma unroll
      for (int p = 0; p < NARROW_BATCH; ++p) {
        const int i = min(i0 + p * step, end - 1);
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          if (DIM == 0 && c >= D) break;
          ai[p][c] = a[(long long)i * D + c];
        }
        ri[p] = ROW_MASK ? args.row_mask[(long long)k * MA + i] : T(0);
      }
#pragma unroll
      for (int p = 0; p < NARROW_BATCH; ++p) {
        const int i = i0 + p * step;
        if (i >= end) break;
        T v[V];
#pragma unroll
        for (int cc = 0; cc < V; ++cc) {
          T sq = T(0);
#pragma unroll
          for (int c = 0; c < CD; ++c) {
            if (DIM == 0 && c >= D) break;
            const T diff = N::sub(ai[p][c], bc[cc][c]);
            sq = N::add(sq, N::mul(diff, diff));
          }
          v[cc] = pair_value<MODEL, false, false, ZERO_DIAG>(
              sq, i == j0 + js * cc, phi, T(0), T(0), T(0));
          if (ROW_MASK) v[cc] = N::mul(ri[p], v[cc]);
        }
        T* row = out + (long long)i * MB;
        if (g.vec) {
          // MB % V == 0, so a group is inside the row or wholly past it
          if (j0 < MB) __stcs(reinterpret_cast<typename N::vec*>(row + j0), N::pack(v));
        } else {
#pragma unroll
          for (int cc = 0; cc < V; ++cc) {
            if (j0 + js * cc < MB) __stcs(row + j0 + js * cc, v[cc]);
          }
        }
      }
    }
  }
}

int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && cached[dev] > 0) return cached[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  n = n > 0 ? n : 1;
  if (dev >= 0 && dev < 64) cached[dev] = n;
  return n;
}

template <typename T, int MODEL, bool MASKED, bool SHIFTED, int DIM>
cudaError_t launch_sym(const ArgsT<T>& args, cudaStream_t stream) {
  using G = SymGeom<T>;
  const long long nt = (args.MA + G::HALO - 1 + G::STILE - 1) / G::STILE;
  const long long pairs = nt * (nt + 1) / 2;
  const long long items = (long long)args.K * args.S * pairs;
  if (items > INT_MAX / 2) return cudaErrorInvalidValue;  // w + grid stays an int
  static int per_sm_of[64] = {};  // resident blocks per SM, asked once a device
  int dev = 0;
  cudaGetDevice(&dev);
  int per_sm = dev >= 0 && dev < 64 ? per_sm_of[dev] : 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_corr_sym_kernel<T, MODEL, MASKED, SHIFTED, DIM>, G::THREADS, 0);
    if (err != cudaSuccess) return err;
    per_sm = per_sm > 0 ? per_sm : 1;
    if (dev >= 0 && dev < 64) per_sm_of[dev] = per_sm;
  }
  const long long resident = (long long)sm_count() * per_sm;
  const int grid = (int)(items < resident ? items : resident);
  fused_corr_sym_kernel<T, MODEL, MASKED, SHIFTED, DIM>
      <<<grid, G::THREADS, 0, stream>>>(args, (int)pairs, (int)items);
  return cudaSuccess;
}

template <typename T, int MODEL, bool ROW_MASK, bool ZERO_DIAG, int DIM>
cudaError_t launch_narrow(const ArgsT<T>& args, cudaStream_t stream) {
  constexpr int V = Num<T>::VEC;
  NarrowGrid g;
  const int quads = (args.MB + V - 1) / V;
  g.panels = (quads + NARROW_THREADS - 1) / NARROW_THREADS;
  g.quads = (quads + g.panels - 1) / g.panels;
  g.vec = args.MB % V == 0 && (reinterpret_cast<uintptr_t>(args.out) & 15) == 0;
  const int step = NARROW_THREADS / g.quads;
  static int per_sm_of[64] = {};  // resident blocks per SM, asked once a device
  int dev = 0;
  cudaGetDevice(&dev);
  int per_sm = dev >= 0 && dev < 64 ? per_sm_of[dev] : 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_corr_narrow_kernel<T, MODEL, ROW_MASK, ZERO_DIAG, DIM>,
        NARROW_THREADS, 0);
    if (err != cudaSuccess) return err;
    per_sm = per_sm > 0 ? per_sm : 1;
    if (dev >= 0 && dev < 64) per_sm_of[dev] = per_sm;
  }
  // strips of NARROW_ROWS rows, halved while that leaves SMs without an item
  const long long matrices = (long long)args.K * args.S * g.panels;
  int passes = NARROW_ROWS > step ? NARROW_ROWS / step : 1;
  long long strips = 0;
  for (;;) {
    const long long rows = (long long)step * passes;
    strips = (args.MA + rows - 1) / rows;
    if (passes == 1 || matrices * strips >= sm_count()) break;
    passes /= 2;
  }
  const long long items = matrices * strips;
  if (items > INT_MAX / 2) return cudaErrorInvalidValue;  // w + grid stays an int
  g.rows = step * passes;
  g.strips = (int)strips;
  g.items = (int)items;
  const long long resident = (long long)sm_count() * per_sm;
  const int grid = (int)(items < resident ? items : resident);
  fused_corr_narrow_kernel<T, MODEL, ROW_MASK, ZERO_DIAG, DIM>
      <<<grid, NARROW_THREADS, 0, stream>>>(args, g);
  return cudaSuccess;
}

template <typename T, int MODEL, bool ROW_MASK, bool ZERO_DIAG>
cudaError_t dispatch_narrow(const ArgsT<T>& args, cudaStream_t stream) {
  if (args.D == 2) return launch_narrow<T, MODEL, ROW_MASK, ZERO_DIAG, 2>(args, stream);
  return launch_narrow<T, MODEL, ROW_MASK, ZERO_DIAG, 0>(args, stream);
}

template <typename T, int MODEL, bool MASKED, bool SHIFTED, bool ZERO_DIAG, bool ROW_MASK = false>
cudaError_t launch(const ArgsT<T>& args, cudaStream_t stream) {
  const dim3 grid((args.MB + TILE - 1) / TILE, (args.MA + TILE - 1) / TILE,
                  args.K * args.S);
  const dim3 block(TILE, BLOCK_Y);
  fused_corr_kernel<T, MODEL, MASKED, SHIFTED, ZERO_DIAG, ROW_MASK>
      <<<grid, block, 0, stream>>>(args);
  return cudaSuccess;
}

// a zero-diagonal square build on layout 1 (symmetric) or 0 (tile)
template <typename T, int MODEL, bool MASKED, bool SHIFTED>
cudaError_t dispatch_square(const ArgsT<T>& args, int layout, cudaStream_t stream) {
  if (layout == 1) {
    if (args.D == 2) return launch_sym<T, MODEL, MASKED, SHIFTED, 2>(args, stream);
    return launch_sym<T, MODEL, MASKED, SHIFTED, 0>(args, stream);
  }
  return launch<T, MODEL, MASKED, SHIFTED, true>(args, stream);
}

// every flag combination the entry point lets through: layout 2 without
// masked and shifted, layout 1 with zero_diag, a row mask on layout 0
// or 2 with no other flag
template <typename T, int MODEL>
cudaError_t dispatch_flags(const ArgsT<T>& args, int masked, int shifted,
                           int row_masked, int zero_diag, int layout,
                           cudaStream_t stream) {
  if (layout == 2) {
    if (row_masked) return dispatch_narrow<T, MODEL, true, false>(args, stream);
    if (zero_diag) return dispatch_narrow<T, MODEL, false, true>(args, stream);
    return dispatch_narrow<T, MODEL, false, false>(args, stream);
  }
  if (row_masked) return launch<T, MODEL, false, false, false, true>(args, stream);
  if (masked && shifted) return dispatch_square<T, MODEL, true, true>(args, layout, stream);
  if (masked) return dispatch_square<T, MODEL, true, false>(args, layout, stream);
  if (shifted) return dispatch_square<T, MODEL, false, true>(args, layout, stream);
  if (zero_diag) return dispatch_square<T, MODEL, false, false>(args, layout, stream);
  return launch<T, MODEL, false, false, false>(args, stream);
}

// The body of both C entry points (below).
template <typename T>
int fused_corr_entry(const ArgsT<T>& args, int model, int masked, int shifted,
                     int row_masked, int zero_diag, int layout, void* stream) {
  if (args.K < 1 || args.S < 1 || args.MA < 1 || args.MB < 1 || args.D < 1 ||
      args.D > MAX_D || (long long)args.K * args.S > 65535 ||
      (args.MA + TILE - 1) / TILE > 65535 || model < 0 || model > 2 ||
      ((masked || shifted) && (args.MA != args.MB || !zero_diag)) ||
      layout < 0 || layout > 2 ||
      (layout == 1 && (args.ca != args.cb || args.a_kstride != args.b_kstride ||
                       args.MA != args.MB || !zero_diag)) ||
      (layout == 2 && (masked || shifted)) ||
      (row_masked && (masked || shifted || zero_diag || layout == 1 ||
                      args.row_mask == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (model) {
    case 0: err = dispatch_flags<T, 0>(args, masked, shifted, row_masked, zero_diag, layout, s); break;
    case 1: err = dispatch_flags<T, 1>(args, masked, shifted, row_masked, zero_diag, layout, s); break;
    default: err = dispatch_flags<T, 2>(args, masked, shifted, row_masked, zero_diag, layout, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes), one a library: float32, or
// float64 where built with -DSMK_FUSED_CORR_F64. Each launches on
// `stream`, does not synchronise and allocates nothing. `layout` 0 is
// the tile kernel, 1 the symmetric kernel, which takes only square
// same-coordinates zero-diagonal builds (cb == ca, MA == MB), 2 the
// narrow kernel, which takes only builds without `masked` and
// `shifted`; `masked` and `shifted` take only zero-diagonal square
// builds. `row_masked` multiplies row i of every (k, s) matrix by
// row_mask[k, i] (a (K, MA) tensor); it takes layout 0 or 2 and no
// other flag. Returns cudaGetLastError() (0 on success); the caller
// raises on anything else.
#ifndef SMK_FUSED_CORR_F64
extern "C" int smk_fused_corr(const float* ca, const float* cb,
                              const float* phis, const float* mask,
                              const float* shift, const float* row_mask,
                              float* out, int K, int S, int MA, int MB,
                              int D, long long a_kstride,
                              long long b_kstride, int model, int masked,
                              int shifted, int row_masked, int zero_diag,
                              int layout, void* stream) {
  const ArgsT<float> args{ca, cb, phis, mask, shift, row_mask, out, K, S,
                          MA, MB, D, a_kstride, b_kstride};
  return fused_corr_entry(args, model, masked, shifted, row_masked, zero_diag,
                          layout, stream);
}
#else
extern "C" int smk_fused_corr_f64(const double* ca, const double* cb,
                                  const double* phis, const double* mask,
                                  const double* shift, const double* row_mask,
                                  double* out, int K, int S, int MA, int MB,
                                  int D, long long a_kstride,
                                  long long b_kstride, int model, int masked,
                                  int shifted, int row_masked, int zero_diag,
                                  int layout, void* stream) {
  const ArgsT<double> args{ca, cb, phis, mask, shift, row_mask, out, K, S,
                           MA, MB, D, a_kstride, b_kstride};
  return fused_corr_entry(args, model, masked, shifted, row_masked, zero_diag,
                          layout, stream);
}
#endif
