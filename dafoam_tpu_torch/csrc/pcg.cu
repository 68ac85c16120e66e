// Vector kernels of the device-resident Jacobi-preconditioned CG for Hopper
// (sm_90a), plain C interface.
//
// One iteration of dafoam_tpu_torch.linalg.krylov.dia_pcg is four launches
// on the current stream, and the host reads the exit test once per block of
// iterations:
//
//   (a) Ap = A p                K1, dia_matvec.cu (unchanged)
//   (b) pcg_dot:                alpha = <r,z> / guard(<p,Ap>)
//   (c) pcg_update:             x += alpha p, r -= alpha Ap, z = dinv r;
//                               beta = <r,z>' / guard(<r,z>), rn = ||r||,
//                               it += 1, live = it < max_iters && rn > tol
//   (d) pcg_direction:          p = beta p + z
//
// and once per solve pcg_init: z = dinv r, p = z, <r,z>, r0 = ||r||,
// tol = max(rel_tol r0, abs_tol), it = 0, live = 0 < max_iters && r0 > tol.
//
// What they replace: no TPU kernel. dafoam_tpu ran CG inside
// lax.while_loop and XLA fused its vector algebra; krylov.cg runs it as
// about 22 small torch kernels and one host read per iteration. These are
// that algebra fused into three kernels, with its scalars kept on the card.
//
// The scalars live in a float64 state array on the card (slots S_* below,
// mirrored in ops/pcg_kernels.py). The T-valued ones (<r,z>, alpha, beta)
// hold the exact double of their T value; the exit test is evaluated in
// float64, as krylov.cg's Python floats do (abs_tol 1e-50 underflows in
// float32), with cg's rule: iterate while it < max_iters and rn > tol, so a
// NaN rn ends the solve.
//
// What bounds them on this card: bytes. Per element in float32, (b) reads p
// and Ap (8 B), (c) reads x, r, p, Ap and dinv and writes x, r and z (32 B),
// (d) reads z and p and writes p (12 B), pcg_init reads r and dinv and
// writes z and p (16 B). At 917,504 cells that is 7.3, 29.4 and 11.0 MB, so
// each launch is a few microseconds: the kernels exist to take launches and
// host reads off the iteration, not to move bytes faster.
//
// Design. One thread per element in a grid-stride loop. Reductions are
// deterministic: each thread sums its elements in order, the block sums its
// threads by a fixed tree in shared memory and stores one partial per sum;
// the block that takes the last ticket (an integer atomic; no float atomics)
// sums the partials in a fixed order and forms the scalars. The grid depends
// only on n, so repeated runs give the same bits. Every product, sum,
// division and square root is explicitly rounded (no FMA contraction) and
// formed as krylov.cg forms it, so the elementwise results equal cg's for
// equal scalars; the sums differ from torch.sum's by their order only.
// (b)-(d) return at once when live is 0: iterations enqueued after the exit
// write nothing, so they are exact no-ops.
//
// Each entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

#define PCG_THREADS 256
#define PCG_MAX_BLOCKS 1024  // partials: 2 * PCG_MAX_BLOCKS per state
#define PCG_ELEM_BLOCKS 8192

// state slots (ops/pcg_kernels.py)
#define S_IT 0
#define S_RN 1
#define S_LIVE 2
#define S_R0 3
#define S_TOL 4
#define S_RZ 5
#define S_ALPHA 6
#define S_BETA 7
#define S_MAXIT 8

__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float rroot(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ float rabs(float a) { return fabsf(a); }
__device__ __forceinline__ double rmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double radd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double rsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double rdiv(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double rroot(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ double rabs(double a) { return fabs(a); }

// krylov._guard: v where |v| > tiny, else tiny (a NaN gives tiny)
template <typename T>
__device__ __forceinline__ T guard(T v, T tiny) {
  return rabs(v) > tiny ? v : tiny;
}

// Sums v over the block by a fixed tree; the sums are valid in thread 0.
template <typename T, int N>
__device__ __forceinline__ void block_sum(T (&v)[N], T (*sh)[PCG_THREADS]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < N; ++j) sh[j][t] = v[j];
  __syncthreads();
#pragma unroll
  for (int w = PCG_THREADS / 2; w > 0; w >>= 1) {
    if (t < w) {
#pragma unroll
      for (int j = 0; j < N; ++j) sh[j][t] = radd(sh[j][t], sh[j][t + w]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = sh[j][0];
}

// The grid's N sums of the threads' running sums v. Returns true in the
// threads of the block that finishes last, with the sums in v of its thread
// 0, and resets the ticket for the next launch; false in every other block.
template <typename T, int N>
__device__ bool grid_sum(T (&v)[N], T* __restrict__ part,
                         unsigned int* __restrict__ ticket) {
  __shared__ T sh[N][PCG_THREADS];
  __shared__ bool last;
  block_sum<T, N>(v, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) part[j * gridDim.x + blockIdx.x] = v[j];
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T a = T(0);
    for (unsigned int i = threadIdx.x; i < gridDim.x; i += PCG_THREADS)
      a = radd(a, __ldcg(part + j * gridDim.x + i));
    v[j] = a;
  }
  block_sum<T, N>(v, sh);
  if (threadIdx.x == 0) *ticket = 0u;
  return true;
}

template <typename T>
__global__ void __launch_bounds__(PCG_THREADS)
pcg_init_kernel(const T* __restrict__ r, const T* __restrict__ dinv,
                T* __restrict__ z, T* __restrict__ p, long long n,
                double max_iters, double rel_tol, double abs_tol,
                double* __restrict__ s, T* __restrict__ part,
                unsigned int* __restrict__ ticket) {
  T v[2] = {T(0), T(0)};  // <r, z>, <r, r>
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T ri = r[i];
    const T zi = rmul(dinv[i], ri);
    z[i] = zi;
    p[i] = zi;
    v[0] = radd(v[0], rmul(ri, zi));
    v[1] = radd(v[1], rmul(ri, ri));
  }
  if (!grid_sum<T, 2>(v, part, ticket) || threadIdx.x != 0) return;
  const double r0 = (double)rroot(v[1]);
  const double a = __dmul_rn(rel_tol, r0);
  const double tol = abs_tol > a ? abs_tol : a;  // Python's max(a, abs_tol)
  s[S_IT] = 0.0;
  s[S_RN] = r0;
  s[S_LIVE] = (0.0 < max_iters && r0 > tol) ? 1.0 : 0.0;
  s[S_R0] = r0;
  s[S_TOL] = tol;
  s[S_RZ] = (double)v[0];
  s[S_ALPHA] = 0.0;
  s[S_BETA] = 0.0;
  s[S_MAXIT] = max_iters;
}

template <typename T>
__global__ void __launch_bounds__(PCG_THREADS)
pcg_dot_kernel(const T* __restrict__ p, const T* __restrict__ ap, long long n,
               T tiny, double* __restrict__ s, T* __restrict__ part,
               unsigned int* __restrict__ ticket) {
  if (s[S_LIVE] == 0.0) return;
  T v[1] = {T(0)};  // <p, Ap>
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    v[0] = radd(v[0], rmul(p[i], ap[i]));
  if (!grid_sum<T, 1>(v, part, ticket) || threadIdx.x != 0) return;
  s[S_ALPHA] = (double)rdiv((T)s[S_RZ], guard(v[0], tiny));
}

template <typename T>
__global__ void __launch_bounds__(PCG_THREADS)
pcg_update_kernel(T* __restrict__ x, T* __restrict__ r, T* __restrict__ z,
                  const T* __restrict__ p, const T* __restrict__ ap,
                  const T* __restrict__ dinv, long long n, T tiny,
                  double* __restrict__ s, T* __restrict__ part,
                  unsigned int* __restrict__ ticket) {
  if (s[S_LIVE] == 0.0) return;
  const T alpha = (T)s[S_ALPHA];
  T v[2] = {T(0), T(0)};  // <r, z>, <r, r> of the new residual
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    x[i] = radd(x[i], rmul(alpha, p[i]));
    const T ri = rsub(r[i], rmul(alpha, ap[i]));
    r[i] = ri;
    const T zi = rmul(dinv[i], ri);
    z[i] = zi;
    v[0] = radd(v[0], rmul(ri, zi));
    v[1] = radd(v[1], rmul(ri, ri));
  }
  if (!grid_sum<T, 2>(v, part, ticket) || threadIdx.x != 0) return;
  s[S_BETA] = (double)rdiv(v[0], guard((T)s[S_RZ], tiny));
  s[S_RZ] = (double)v[0];
  const double it = s[S_IT] + 1.0;
  const double rn = (double)rroot(v[1]);
  s[S_IT] = it;
  s[S_RN] = rn;
  s[S_LIVE] = (it < s[S_MAXIT] && rn > s[S_TOL]) ? 1.0 : 0.0;
}

template <typename T>
__global__ void __launch_bounds__(PCG_THREADS)
pcg_direction_kernel(T* __restrict__ p, const T* __restrict__ z, long long n,
                     const double* __restrict__ s) {
  if (s[S_LIVE] == 0.0) return;
  const T beta = (T)s[S_BETA];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    p[i] = radd(rmul(beta, p[i]), z[i]);
}

// at least one block, so a solve on no cells still forms its scalars
static unsigned int sum_grid(long long n) {
  const long long blocks = (n + PCG_THREADS - 1) / PCG_THREADS;
  return (unsigned int)(blocks < 1 ? 1
                        : blocks < PCG_MAX_BLOCKS ? blocks : PCG_MAX_BLOCKS);
}

static unsigned int elem_grid(long long n) {
  const long long blocks = (n + PCG_THREADS - 1) / PCG_THREADS;
  return (unsigned int)(blocks < 1 ? 1
                        : blocks < PCG_ELEM_BLOCKS ? blocks : PCG_ELEM_BLOCKS);
}

#define PCG_ENTRY_POINTS(T, SFX)                                               \
  int pcg_init_##SFX(const T* r, const T* dinv, T* z, T* p, long long n,      \
                     double max_iters, double rel_tol, double abs_tol,        \
                     double* s, T* part, unsigned int* ticket, void* stream) {\
    if (n < 0) return (int)cudaErrorInvalidValue;                             \
    pcg_init_kernel<T><<<sum_grid(n), PCG_THREADS, 0, (cudaStream_t)stream>>>( \
        r, dinv, z, p, n, max_iters, rel_tol, abs_tol, s, part, ticket);      \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  int pcg_dot_##SFX(const T* p, const T* ap, long long n, double tiny,        \
                    double* s, T* part, unsigned int* ticket, void* stream) { \
    if (n < 0) return (int)cudaErrorInvalidValue;                             \
    pcg_dot_kernel<T><<<sum_grid(n), PCG_THREADS, 0, (cudaStream_t)stream>>>(  \
        p, ap, n, (T)tiny, s, part, ticket);                                  \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  int pcg_update_##SFX(T* x, T* r, T* z, const T* p, const T* ap,             \
                       const T* dinv, long long n, double tiny, double* s,    \
                       T* part, unsigned int* ticket, void* stream) {         \
    if (n < 0) return (int)cudaErrorInvalidValue;                             \
    pcg_update_kernel<T><<<sum_grid(n), PCG_THREADS, 0,                       \
                           (cudaStream_t)stream>>>(x, r, z, p, ap, dinv, n,   \
                                                   (T)tiny, s, part, ticket); \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  int pcg_direction_##SFX(T* p, const T* z, long long n, const double* s,     \
                          void* stream) {                                     \
    if (n < 0) return (int)cudaErrorInvalidValue;                             \
    pcg_direction_kernel<T><<<elem_grid(n), PCG_THREADS, 0,                   \
                              (cudaStream_t)stream>>>(p, z, n, s);            \
    return (int)cudaGetLastError();                                           \
  }

extern "C" {
PCG_ENTRY_POINTS(float, f32)
PCG_ENTRY_POINTS(double, f64)
int pcg_max_blocks(void) { return PCG_MAX_BLOCKS; }
}  // extern "C"
