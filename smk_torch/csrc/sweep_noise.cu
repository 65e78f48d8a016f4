// Every batch row's sweep noise in one launch (Hopper, sm_90a).
//
// Replaces no TPU kernel: the JAX sampler draws its noise with
// jax.random inside the compiled sweep. The port's default noise source
// (models/probit_gp.GeneratorNoise) gives each batch row a torch CUDA
// generator and draws a sweep's numbers with three calls a row, in this
// order (models/probit_gp.draw_sweep_noise):
//
//   call 0  torch.rand((n_z + q + 1,))   probit: n_z = w m q latent
//           uniforms (kz), then q phi-accept uniforms (kphi) and one
//           A-accept uniform (ka_u); logit: n_z = 0
//   call 1  torch.randn((q p + q + 2 q m + q q [+ q t],))   split into
//           kb, kprop, ku_prior, ku_noise, ka and, on collecting
//           sweeps, kpred
//   call 2  exponential_ on (1, T, m, q), logit only (the Gamma(1, 1)
//           terms of the Polya-Gamma series, kz)
//
// followed by _uniform(u, minval) = clamp(u (1 - minval) + minval,
// min = minval) on kz (probit), kphi and ka_u, and a stack of every
// field over the rows. At 128 rows that is over a thousand small
// launches a sweep, each a few microseconds of device work behind tens
// of microseconds of host time. This kernel draws the same numbers, bit
// for bit, for every (row, call) pair in one launch and writes them
// straight into the stacked fields.
//
// How: a CUDA generator's numbers depend only on its seed, its Philox
// offset and, through torch's launch policy, the call's element count
// (ATen/native/cuda/DistributionTemplates.h: calc_execution_policy and
// distribution_elementwise_grid_stride_kernel). For a call of numel
// elements torch launches blocks of 256 threads on
//   grid = min(SMs * (threads per SM / 256), ceil(numel / 256))
// blocks; thread idx < 256 grid runs curand_init(seed, idx, offset) and
// a grid-stride loop of stride 256 grid over
//   rounded = ((numel - 1) / (stride unroll) + 1) stride unroll
// elements, one curand call an iteration (curand_uniform4 /
// curand_normal4 at float, unroll 4; curand_uniform2_double /
// curand_normal2_double at double, unroll 2), lane ii going to element
// linear_index + stride ii when that is below numel. The generator's
// offset then advances by ((numel - 1) / (256 grid unroll) + 1) * 4.
// Here each (row, call) pair keeps torch's grid and gets that many
// blocks of the one launch: a block finds its row and call from its
// index, and its thread runs exactly torch's thread of that call, with
// the call's offset (the row's offset plus the increments of the row's
// earlier calls, which the wrapper computes with the same policy).
// Where numel exceeds the grid's reach, the later lanes and iterations
// run as in torch.
//
// The transforms are torch's, in torch's order:
//   rand         value = rand * 1 + 0 (exact); value == 1 ? 0 : value
//                (uniform_kernel's reversed bound)
//   randn        rand * 1 + 0 (normal_kernel's std and mean)
//   exponential  -1 / lambda * log, log = val >= 1 - eps / 2 ? -eps / 2
//                : at::log(val) (transformation::exponential for CUDA;
//                at::log is __logf at float on the device, NumericUtils.h,
//                and the accurate log at double)
// then the repo's _uniform on kz, kphi and ka_u, whose multiply, add and
// clamp torch runs as three kernels: __fmul_rn / __fadd_rn keep nvcc
// from fusing them into one FMA. No flag of the build asks for fast
// math (torch's kernels are built without it; the one approximation,
// at::log's __logf, is written out).
//
// Bound on the H100: the output bytes, written once (config4: 128 rows
// of 64 x 1024 x 2 exponentials, 67 MB, at least 20 us at 3.35 TB/s),
// and the Philox rounds, one curand call per element at most. The
// per-row path did the same device work; what it cost was the host's
// time to launch it. The kernel allocates nothing and does not
// synchronise.

#include <curand_kernel.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kBlock = 256;
// kb, kprop, ku_prior, ku_noise, ka, kpred: the fields of call 1
constexpr int kNormalFields = 6;

template <typename T>
struct Draws;

template <>
struct Draws<float> {
  static constexpr int kUnroll = 4;
  __device__ static float4 uniform(curandStatePhilox4_32_10_t* s) { return curand_uniform4(s); }
  __device__ static float4 normal(curandStatePhilox4_32_10_t* s) { return curand_normal4(s); }
  __device__ static float log(float x) { return __logf(x); }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  static constexpr float kEps = FLT_EPSILON;
};

template <>
struct Draws<double> {
  static constexpr int kUnroll = 2;
  __device__ static double2 uniform(curandStatePhilox4_32_10_t* s) {
    return curand_uniform2_double(s);
  }
  __device__ static double2 normal(curandStatePhilox4_32_10_t* s) {
    return curand_normal2_double(s);
  }
  __device__ static double log(double x) { return ::log(x); }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  static constexpr double kEps = DBL_EPSILON;
};

template <typename T>
struct Args {
  const unsigned long long* philox;  // (K, 2): each row's seed and offset
  T* kz;                             // (K, n_z) probit, (K, n_exp) logit
  T* kphi;                           // (K, q)
  T* ka_u;                           // (K,)
  T* normal_out[kNormalFields];      // each (K, normal_size[f])
  long long normal_size[kNormalFields];
  long long numel[3];                // calls 0, 1, 2 (0: not drawn)
  int grid[3];                       // torch's grid of each call
  unsigned long long inc[3];         // each call's Philox increment
  long long n_z;
  int q;
  T z_scale, z_min;                  // _uniform's (1 - minval) and minval
  T u_scale, u_min;                  // for kz, and for kphi and ka_u
};

// _uniform(u, minval): the multiply, the add and the clamp rounded apart
template <typename T>
__device__ __forceinline__ T unit(T u, T scale, T lo) {
  const T x = Draws<T>::add(Draws<T>::mul(u, scale), lo);
  return x < lo ? lo : x;
}

template <typename T>
__device__ __forceinline__ void store(const Args<T>& a, int call, long long row,
                                      long long li, T v) {
  if (call == 0) {
    const T u = v == T(1) ? T(0) : v;
    if (li < a.n_z) {
      a.kz[row * a.n_z + li] = unit(u, a.z_scale, a.z_min);
    } else if (li < a.n_z + a.q) {
      a.kphi[row * a.q + (li - a.n_z)] = unit(u, a.u_scale, a.u_min);
    } else {
      a.ka_u[row] = unit(u, a.u_scale, a.u_min);
    }
  } else if (call == 1) {
    long long j = li;
    int f = 0;
    while (j >= a.normal_size[f]) {
      j -= a.normal_size[f];
      ++f;
    }
    a.normal_out[f][row * a.normal_size[f] + j] =
        Draws<T>::add(Draws<T>::mul(v, T(1)), T(0));
  } else {
    const T half_eps = Draws<T>::kEps / T(2);
    const T lg = v >= T(1) - half_eps ? -half_eps : Draws<T>::log(v);
    a.kz[row * a.numel[2] + li] = -lg;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock) sweep_noise_kernel(const Args<T> a) {
  constexpr int U = Draws<T>::kUnroll;
  const int per_row = a.grid[0] + a.grid[1] + a.grid[2];
  const long long row = blockIdx.x / per_row;
  int blk = blockIdx.x - (int)(row * per_row);
  int call = 0;
  unsigned long long offset = a.philox[2 * row + 1];
  while (blk >= a.grid[call]) {
    blk -= a.grid[call];
    offset += a.inc[call];
    ++call;
  }
  const long long numel = a.numel[call];
  const long long stride = (long long)kBlock * a.grid[call];
  const long long idx = (long long)blk * kBlock + threadIdx.x;
  curandStatePhilox4_32_10_t state;
  curand_init(a.philox[2 * row], idx, offset, &state);
  const long long step = stride * U;
  const long long rounded = ((numel - 1) / step + 1) * step;
  for (long long linear = idx; linear < rounded; linear += step) {
    const auto r = call == 1 ? Draws<T>::normal(&state) : Draws<T>::uniform(&state);
#pragma unroll
    for (int ii = 0; ii < U; ii++) {
      const long long li = linear + stride * ii;
      if (li < numel) store(a, call, row, li, (&r.x)[ii]);
    }
  }
}

template <typename T>
int sweep_noise_entry(const unsigned long long* philox, int K, T* kz, T* kphi, T* ka_u,
                      T* const* normal_out, const long long* normal_size,
                      const long long* numel, const int* grid,
                      const unsigned long long* inc, long long n_z, int q,
                      double z_min, double u_min, void* stream) {
  Args<T> a;
  a.philox = philox;
  a.kz = kz;
  a.kphi = kphi;
  a.ka_u = ka_u;
  long long normal_total = 0;
  for (int f = 0; f < kNormalFields; f++) {
    a.normal_out[f] = normal_out[f];
    a.normal_size[f] = normal_size[f];
    normal_total += normal_size[f];
    if (normal_size[f] < 0 || (normal_size[f] > 0 && normal_out[f] == nullptr)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  long long blocks = 0;
  for (int c = 0; c < 3; c++) {
    a.numel[c] = numel[c];
    a.grid[c] = grid[c];
    a.inc[c] = inc[c];
    if (grid[c] < 0 || (numel[c] > 0) != (grid[c] > 0)) return (int)cudaErrorInvalidValue;
    blocks += grid[c];
  }
  a.n_z = n_z;
  a.q = q;
  a.z_scale = (T)(1.0 - z_min);
  a.z_min = (T)z_min;
  a.u_scale = (T)(1.0 - u_min);
  a.u_min = (T)u_min;
  if (K < 1 || q < 1 || numel[0] != n_z + q + 1 || numel[1] != normal_total ||
      (n_z > 0) == (numel[2] > 0) || kz == nullptr || kphi == nullptr ||
      ka_u == nullptr || blocks * K > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  sweep_noise_kernel<T><<<(unsigned)(blocks * K), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`,
// does not synchronise and allocates nothing. `philox`: (K, 2) uint64 on
// the card, each row's seed and Philox offset before the sweep;
// `normal_out` / `normal_size`: the six fields of call 1 in order (kb,
// kprop, ku_prior, ku_noise, ka, kpred; kpred's size 0 and pointer null
// on a non-collecting sweep); `numel`, `grid`, `inc`: calls 0-2 as torch
// would launch them (call 2's numel 0 under probit, n_z 0 under logit).
// Returns cudaGetLastError() (0 on success); the caller raises on
// anything else.
extern "C" int smk_sweep_noise_f32(const unsigned long long* philox, int K, float* kz,
                                   float* kphi, float* ka_u, float* const* normal_out,
                                   const long long* normal_size, const long long* numel,
                                   const int* grid, const unsigned long long* inc,
                                   long long n_z, int q, double z_min, double u_min,
                                   void* stream) {
  return sweep_noise_entry<float>(philox, K, kz, kphi, ka_u, normal_out, normal_size,
                                  numel, grid, inc, n_z, q, z_min, u_min, stream);
}

extern "C" int smk_sweep_noise_f64(const unsigned long long* philox, int K, double* kz,
                                   double* kphi, double* ka_u, double* const* normal_out,
                                   const long long* normal_size, const long long* numel,
                                   const int* grid, const unsigned long long* inc,
                                   long long n_z, int q, double z_min, double u_min,
                                   void* stream) {
  return sweep_noise_entry<double>(philox, K, kz, kphi, ka_u, normal_out, normal_size,
                                   numel, grid, inc, n_z, q, z_min, u_min, stream);
}
