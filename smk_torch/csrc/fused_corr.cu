// Fused correlation build for Hopper (sm_90a).
//
// Replaces the TPU kernel smk_tpu/ops/pallas_build.py::_corr_kernel
// (:179-234), launched by _fused_build (:237-327). For each (k, s)
// matrix of the output it computes, per pair (i, j),
//
//   dist = sqrt(sum_c (a[k, i, c] - b[k, j, c])^2)      (c in d order)
//   rho  = CORRELATION_FNS[model](dist, phi[k, s])
//   ZERO_DIAG: dist = 0 on the diagonal i == j (exact unit diagonal)
//   MASKED:    rho = m_i m_j rho + (1 - m_i m_j) [i == j]   (R~ = M R M + I - M)
//   SHIFTED:   rho += shift[k, i] on the diagonal
//
// into a contiguous fp32 (K, S, MA, MB) tensor. The diagonal is tested
// on global indices, as the TPU kernel does.
//
// Bound on the H100: the kernel writes S*MA*MB*4 bytes per k and reads
// only O((MA + MB) d) coordinates, and it does ~15 fp32 operations per
// element, so it is write-bound: the (32, 1, 3906, 3906) build writes
// 1.95 GB, at least 0.58 ms at 3.35 TB/s, against ~0.1 ms for its
// operations at 67 TFLOP/s. The simple design answers that with
// coalesced stores (each warp stores 32 consecutive floats of one
// row, 128 bytes) and reads each tile's coordinates once, into shared
// memory. Wider stores, writing one symmetric half, or a persistent
// grid are left for later.
//
// Layout: one block per 32 x 32 output tile of one (k, s) matrix, 256
// threads (32 x 8); each thread writes 4 rows of its column. Reads and
// writes are guarded at ragged edges: nothing outside the inputs is
// read, nothing outside the output is written.
//
// Numerics: expf (not __expf), IEEE sqrt and division (no fast math),
// and the distance sum and the mask blend are rounded operation by
// operation (__fmul_rn / __fadd_rn: no contraction into FMA), so the
// result follows the plain version's arithmetic. Because the
// per-pair arithmetic is the same for (i, j) and (j, i), a square
// same-coordinates build is symmetric bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS_PER_THREAD = 4;
constexpr int BLOCK_Y = TILE / ROWS_PER_THREAD;  // 8: 256 threads
constexpr int MAX_D = 8;

constexpr float SQRT3 = 1.7320508075688772f;
constexpr float SQRT5 = 2.23606797749979f;

template <int MODEL>
__device__ __forceinline__ float corr(float dist, float phi) {
  if (MODEL == 0) {  // exponential
    return expf(__fmul_rn(-phi, dist));
  } else if (MODEL == 1) {  // matern32
    const float t = __fmul_rn(__fmul_rn(SQRT3, phi), dist);
    return __fmul_rn(__fadd_rn(1.0f, t), expf(-t));
  } else {  // matern52
    const float t = __fmul_rn(__fmul_rn(SQRT5, phi), dist);
    const float poly = __fadd_rn(__fadd_rn(1.0f, t), __fmul_rn(t, t) / 3.0f);
    return __fmul_rn(poly, expf(-t));
  }
}

struct Args {
  const float* ca;
  const float* cb;
  const float* phis;
  const float* mask;
  const float* shift;
  float* out;
  int K, S, MA, MB, D;
  long long a_kstride, b_kstride;
};

template <int MODEL, bool MASKED, bool SHIFTED, bool ZERO_DIAG>
__global__ void __launch_bounds__(TILE * BLOCK_Y)
fused_corr_kernel(const Args args) {
  __shared__ float sa[TILE][MAX_D + 1];
  __shared__ float sb[MAX_D][TILE];
  __shared__ float mrow[TILE];
  __shared__ float mcol[TILE];
  __shared__ float srow[TILE];

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
  // threads read consecutive floats of the (m, d) row-major blocks
  const float* a = args.ca + k * args.a_kstride;
  const float* b = args.cb + k * args.b_kstride;
  for (int e = tid; e < TILE * D; e += TILE * BLOCK_Y) {
    const int r = e / D;
    const int c = e - r * D;
    const int gi = i0 + r;
    const int gj = j0 + r;
    sa[r][c] = gi < MA ? a[(long long)gi * D + c] : 0.0f;
    sb[c][r] = gj < MB ? b[(long long)gj * D + c] : 0.0f;
  }
  if (MASKED || SHIFTED) {
    if (tid < TILE) {
      const int gi = i0 + tid;
      const int gj = j0 + tid;
      const long long base = (long long)k * MA;  // square builds: MA == MB
      if (MASKED) {
        mrow[tid] = gi < MA ? args.mask[base + gi] : 0.0f;
        mcol[tid] = gj < MB ? args.mask[base + gj] : 0.0f;
      }
      if (SHIFTED) srow[tid] = gi < MA ? args.shift[base + gi] : 0.0f;
    }
  }
  __syncthreads();

  const int j = j0 + tx;
  if (j >= MB) return;
  const float phi = args.phis[ks];
  float* out = args.out + (long long)ks * MA * MB;
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_THREAD; ++rr) {
    const int r = ty + rr * BLOCK_Y;
    const int i = i0 + r;
    if (i >= MA) break;
    float sq = 0.0f;
    for (int c = 0; c < D; ++c) {
      const float diff = __fsub_rn(sa[r][c], sb[c][tx]);
      sq = __fadd_rn(sq, __fmul_rn(diff, diff));
    }
    const bool diag = (i == j);
    float dist = sqrtf(fmaxf(sq, 0.0f));
    if (ZERO_DIAG && diag) dist = 0.0f;
    float rho = corr<MODEL>(dist, phi);
    if (MASKED) {
      const float mm = __fmul_rn(mrow[r], mcol[tx]);
      rho = __fadd_rn(__fmul_rn(mm, rho),
                      __fmul_rn(__fsub_rn(1.0f, mm), diag ? 1.0f : 0.0f));
    }
    if (SHIFTED && diag) rho = __fadd_rn(rho, srow[r]);
    out[(long long)i * MB + j] = rho;
  }
}

template <int MODEL, bool MASKED, bool SHIFTED, bool ZERO_DIAG>
void launch(const Args& args, cudaStream_t stream) {
  const dim3 grid((args.MB + TILE - 1) / TILE, (args.MA + TILE - 1) / TILE,
                  args.K * args.S);
  const dim3 block(TILE, BLOCK_Y);
  fused_corr_kernel<MODEL, MASKED, SHIFTED, ZERO_DIAG>
      <<<grid, block, 0, stream>>>(args);
}

template <int MODEL, bool MASKED, bool SHIFTED>
void dispatch_diag(const Args& args, int zero_diag, cudaStream_t stream) {
  if (zero_diag) {
    launch<MODEL, MASKED, SHIFTED, true>(args, stream);
  } else {
    launch<MODEL, MASKED, SHIFTED, false>(args, stream);
  }
}

template <int MODEL>
void dispatch_flags(const Args& args, int masked, int shifted, int zero_diag,
                    cudaStream_t stream) {
  if (masked && shifted) {
    dispatch_diag<MODEL, true, true>(args, zero_diag, stream);
  } else if (masked) {
    dispatch_diag<MODEL, true, false>(args, zero_diag, stream);
  } else if (shifted) {
    dispatch_diag<MODEL, false, true>(args, zero_diag, stream);
  } else {
    dispatch_diag<MODEL, false, false>(args, zero_diag, stream);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does
// not synchronise and allocates nothing. Returns cudaGetLastError()
// (0 on success); the caller raises on anything else.
extern "C" int smk_fused_corr(const float* ca, const float* cb,
                              const float* phis, const float* mask,
                              const float* shift, float* out, int K, int S,
                              int MA, int MB, int D, long long a_kstride,
                              long long b_kstride, int model, int masked,
                              int shifted, int zero_diag, void* stream) {
  if (K < 1 || S < 1 || MA < 1 || MB < 1 || D < 1 || D > MAX_D ||
      (long long)K * S > 65535 || (MA + TILE - 1) / TILE > 65535 ||
      model < 0 || model > 2 || ((masked || shifted) && MA != MB)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args args{ca, cb, phis, mask, shift, out, K, S,
                  MA, MB, D, a_kstride, b_kstride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (model) {
    case 0: dispatch_flags<0>(args, masked, shifted, zero_diag, s); break;
    case 1: dispatch_flags<1>(args, masked, shifted, zero_diag, s); break;
    default: dispatch_flags<2>(args, masked, shifted, zero_diag, s); break;
  }
  return (int)cudaGetLastError();
}
