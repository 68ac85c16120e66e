// Banded (DIA) LDU matvec kernels for Hopper (sm_90a), plain C interface.
//
// K1  dia_matvec:        y[i]   = d[i]   * x[i]   + sum_k c[k,i] * x[i + o_k]
// K2  dia_matvec_multi:  y[q,i] = d[q,i] * x[q,i] + sum_k c[k,i] * x[q, i + o_k]
//
// and the reverse rule of the same family (K3), for the cotangent ct of y:
//
// K3a dia_matvec_t:        xbar[q,j] = d[q,j] * ct[q,j]
//                                      + sum_k c[k, j - o_k] * ct[q, j - o_k]
//     (scalar and _multi forms: xbar = A^T ct)
// K3b dia_cotangent:       dbar[i] = ct[i] * x[i],
//                          cbar[k,i] = ct[i] * x[i + o_k]
//     dia_cotangent_multi: cbar[k,i] = sum_q ct[q,i] * x[q, i + o_k], dbar
//                          summed over q for a shared (n,) diagonal and kept
//                          per component (C, n) otherwise
//
// with x[j] = 0 outside [0, n). K1 replaces the Pallas kernels
// dafoam_tpu/ops/pallas_kernels.py:dia_matvec and :dia_matvec_tiled, K2
// replaces :dia_matvec_multi and :dia_matvec_multi_tiled, K3 replaces the
// custom-vjp backward rules :_dia_ad_factory (dia_matvec_ad) and
// :_dia_multi_ad_factory (dia_matvec_multi_ad), which ran the forward kernel
// on a transposed band array (transpose_coef) plus XLA slices for the
// coefficient cotangents. The tiled TPU variants existed only because of
// the TPU's on-chip memory size; one grid-stride kernel per family covers
// every n here.
//
// What bounds them on this card: bytes. K1 in float32 reads (K + 2) * 4 B
// per row (diag, K band coefficients, x) and writes 4 B; the shifted reads
// of x hit the same lines as neighbouring rows and come from L1/L2. K2
// reads each band coefficient once for all C components (the TPU tiled
// variant re-read the bands per component). K3a moves the same bytes as
// K1/K2: it reads c at the shifted row j - o_k directly instead of
// materializing the transposed band array (which would cost one more
// write and read of K * n values). K3b reads ct and x once and writes the
// K + 1 cotangent rows, (K + 3) * 4 B per row in the scalar float32 form.
// At 262,144 cells with K = 6 the working set of one call is 8-16 MB in
// float32, below the 50 MB L2 of an H100, so inside a Krylov or adjoint
// loop launch overhead, not HBM bandwidth, is the expected bound.
//
// Design: one thread per row in a grid-stride loop; coalesced reads of d,
// c and the output; shifted reads through the read-only path with the
// ragged edges masked to zero. The offsets are passed by value in a small
// struct (at most 64, the band count up to which topo.dia() gives a band
// layout), so a call makes no device copy. Every multiply and add is
// explicitly rounded (no FMA contraction), the bands are summed in
// the order the plain torch versions sum them and component sums run
// q = 0..C-1, so each kernel reproduces its plain version in
// dafoam_tpu_torch.ops.dia_kernels bit for bit.
//
// Each entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

#define DIA_MAX_OFFSETS 64
#define DIA_THREADS 256
#define DIA_MAX_BLOCKS 8192

struct DiaOffsets {
  int k;
  int o[DIA_MAX_OFFSETS];
};

__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double rmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double radd(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void dia_matvec_kernel(const T* __restrict__ d,
                                  const T* __restrict__ c,
                                  const DiaOffsets offs,
                                  const T* __restrict__ x,
                                  T* __restrict__ y, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    T acc = rmul(d[i], x[i]);
#pragma unroll
    for (int k = 0; k < DIA_MAX_OFFSETS; ++k) {
      if (k >= offs.k) break;  // static indices into the parameter struct
      const long long j = i + offs.o[k];
      const T xv = (j >= 0 && j < n) ? __ldg(x + j) : T(0);
      acc = radd(acc, rmul(c[(long long)k * n + i], xv));
    }
    y[i] = acc;
  }
}

template <typename T, int C>
__global__ void dia_matvec_multi_kernel(const T* __restrict__ d,
                                        long long d_cstride,
                                        const T* __restrict__ c,
                                        const DiaOffsets offs,
                                        const T* __restrict__ x,
                                        T* __restrict__ y, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    T acc[C];
#pragma unroll
    for (int q = 0; q < C; ++q) acc[q] = rmul(d[q * d_cstride + i], x[q * n + i]);
#pragma unroll
    for (int k = 0; k < DIA_MAX_OFFSETS; ++k) {
      if (k >= offs.k) break;
      const T ck = c[(long long)k * n + i];  // read once for all C
      const long long j = i + offs.o[k];
      const bool in = (j >= 0 && j < n);
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const T xv = in ? __ldg(x + q * n + j) : T(0);
        acc[q] = radd(acc[q], rmul(ck, xv));
      }
    }
#pragma unroll
    for (int q = 0; q < C; ++q) y[q * n + i] = acc[q];
  }
}

// ---------------------------------------------------------------------------
// K3a: transposed matvec xbar = A^T ct (c read at the shifted row)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void dia_matvec_t_kernel(const T* __restrict__ d,
                                    const T* __restrict__ c,
                                    const DiaOffsets offs,
                                    const T* __restrict__ ct,
                                    T* __restrict__ xbar, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    T acc = rmul(d[i], ct[i]);
#pragma unroll
    for (int k = 0; k < DIA_MAX_OFFSETS; ++k) {
      if (k >= offs.k) break;
      const long long j = i - offs.o[k];
      const bool in = (j >= 0 && j < n);
      const T cv = in ? __ldg(c + (long long)k * n + j) : T(0);
      const T tv = in ? __ldg(ct + j) : T(0);
      acc = radd(acc, rmul(cv, tv));
    }
    xbar[i] = acc;
  }
}

template <typename T, int C>
__global__ void dia_matvec_multi_t_kernel(const T* __restrict__ d,
                                          long long d_cstride,
                                          const T* __restrict__ c,
                                          const DiaOffsets offs,
                                          const T* __restrict__ ct,
                                          T* __restrict__ xbar, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    T acc[C];
#pragma unroll
    for (int q = 0; q < C; ++q) acc[q] = rmul(d[q * d_cstride + i], ct[q * n + i]);
#pragma unroll
    for (int k = 0; k < DIA_MAX_OFFSETS; ++k) {
      if (k >= offs.k) break;
      const long long j = i - offs.o[k];
      const bool in = (j >= 0 && j < n);
      const T cv = in ? __ldg(c + (long long)k * n + j) : T(0);  // once for all C
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const T tv = in ? __ldg(ct + q * n + j) : T(0);
        acc[q] = radd(acc[q], rmul(cv, tv));
      }
    }
#pragma unroll
    for (int q = 0; q < C; ++q) xbar[q * n + i] = acc[q];
  }
}

// ---------------------------------------------------------------------------
// K3b: coefficient cotangents, one pass over the rows
// ---------------------------------------------------------------------------

template <typename T>
__global__ void dia_cotangent_kernel(const T* __restrict__ ct,
                                     const T* __restrict__ x,
                                     const DiaOffsets offs,
                                     T* __restrict__ dbar,
                                     T* __restrict__ cbar, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T t = ct[i];
    dbar[i] = rmul(t, x[i]);
#pragma unroll
    for (int k = 0; k < DIA_MAX_OFFSETS; ++k) {
      if (k >= offs.k) break;
      const long long j = i + offs.o[k];
      const T xv = (j >= 0 && j < n) ? __ldg(x + j) : T(0);
      cbar[(long long)k * n + i] = rmul(t, xv);
    }
  }
}

// per_comp: dbar is (C, n) per component; else (n,) summed over q
template <typename T, int C>
__global__ void dia_cotangent_multi_kernel(const T* __restrict__ ct,
                                           const T* __restrict__ x,
                                           const DiaOffsets offs,
                                           T* __restrict__ dbar, int per_comp,
                                           T* __restrict__ cbar, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    T t[C];
#pragma unroll
    for (int q = 0; q < C; ++q) t[q] = ct[q * n + i];
    if (per_comp) {
#pragma unroll
      for (int q = 0; q < C; ++q) dbar[q * n + i] = rmul(t[q], x[q * n + i]);
    } else {
      T acc = rmul(t[0], x[i]);
#pragma unroll
      for (int q = 1; q < C; ++q) acc = radd(acc, rmul(t[q], x[q * n + i]));
      dbar[i] = acc;
    }
#pragma unroll
    for (int k = 0; k < DIA_MAX_OFFSETS; ++k) {
      if (k >= offs.k) break;
      const long long j = i + offs.o[k];
      const bool in = (j >= 0 && j < n);
      T acc = rmul(t[0], in ? __ldg(x + j) : T(0));
#pragma unroll
      for (int q = 1; q < C; ++q)
        acc = radd(acc, rmul(t[q], in ? __ldg(x + q * n + j) : T(0)));
      cbar[(long long)k * n + i] = acc;
    }
  }
}

static bool make_offsets(const int* offsets, int k, DiaOffsets* out) {
  if (k < 0 || k > DIA_MAX_OFFSETS) return false;
  out->k = k;
  for (int i = 0; i < DIA_MAX_OFFSETS; ++i) out->o[i] = i < k ? offsets[i] : 0;
  return true;
}

static unsigned int grid_for(long long n) {
  long long blocks = (n + DIA_THREADS - 1) / DIA_THREADS;
  return (unsigned int)(blocks < DIA_MAX_BLOCKS ? blocks : DIA_MAX_BLOCKS);
}

template <typename T>
static int launch_k1(const T* d, const T* c, const int* offsets, int k,
                     const T* x, T* y, long long n, void* stream) {
  DiaOffsets offs;
  if (!make_offsets(offsets, k, &offs) || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  dia_matvec_kernel<T><<<grid_for(n), DIA_THREADS, 0, (cudaStream_t)stream>>>(
      d, c, offs, x, y, n);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_k2(const T* d, long long d_cstride, const T* c,
                     const int* offsets, int k, const T* x, T* y, int ncomp,
                     long long n, void* stream) {
  DiaOffsets offs;
  if (!make_offsets(offsets, k, &offs) || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const unsigned int g = grid_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  switch (ncomp) {
    case 1:
      dia_matvec_multi_kernel<T, 1><<<g, DIA_THREADS, 0, s>>>(d, d_cstride, c, offs, x, y, n);
      break;
    case 2:
      dia_matvec_multi_kernel<T, 2><<<g, DIA_THREADS, 0, s>>>(d, d_cstride, c, offs, x, y, n);
      break;
    case 3:
      dia_matvec_multi_kernel<T, 3><<<g, DIA_THREADS, 0, s>>>(d, d_cstride, c, offs, x, y, n);
      break;
    case 4:
      dia_matvec_multi_kernel<T, 4><<<g, DIA_THREADS, 0, s>>>(d, d_cstride, c, offs, x, y, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_k3a(const T* d, const T* c, const int* offsets, int k,
                      const T* ct, T* xbar, long long n, void* stream) {
  DiaOffsets offs;
  if (!make_offsets(offsets, k, &offs) || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  dia_matvec_t_kernel<T><<<grid_for(n), DIA_THREADS, 0, (cudaStream_t)stream>>>(
      d, c, offs, ct, xbar, n);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_k3a_multi(const T* d, long long d_cstride, const T* c,
                            const int* offsets, int k, const T* ct, T* xbar,
                            int ncomp, long long n, void* stream) {
  DiaOffsets offs;
  if (!make_offsets(offsets, k, &offs) || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const unsigned int g = grid_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  switch (ncomp) {
    case 1:
      dia_matvec_multi_t_kernel<T, 1><<<g, DIA_THREADS, 0, s>>>(d, d_cstride, c, offs, ct, xbar, n);
      break;
    case 2:
      dia_matvec_multi_t_kernel<T, 2><<<g, DIA_THREADS, 0, s>>>(d, d_cstride, c, offs, ct, xbar, n);
      break;
    case 3:
      dia_matvec_multi_t_kernel<T, 3><<<g, DIA_THREADS, 0, s>>>(d, d_cstride, c, offs, ct, xbar, n);
      break;
    case 4:
      dia_matvec_multi_t_kernel<T, 4><<<g, DIA_THREADS, 0, s>>>(d, d_cstride, c, offs, ct, xbar, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_k3b(const T* ct, const T* x, const int* offsets, int k,
                      T* dbar, T* cbar, long long n, void* stream) {
  DiaOffsets offs;
  if (!make_offsets(offsets, k, &offs) || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  dia_cotangent_kernel<T><<<grid_for(n), DIA_THREADS, 0, (cudaStream_t)stream>>>(
      ct, x, offs, dbar, cbar, n);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_k3b_multi(const T* ct, const T* x, const int* offsets, int k,
                            T* dbar, int per_comp, T* cbar, int ncomp,
                            long long n, void* stream) {
  DiaOffsets offs;
  if (!make_offsets(offsets, k, &offs) || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const unsigned int g = grid_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  switch (ncomp) {
    case 1:
      dia_cotangent_multi_kernel<T, 1><<<g, DIA_THREADS, 0, s>>>(ct, x, offs, dbar, per_comp, cbar, n);
      break;
    case 2:
      dia_cotangent_multi_kernel<T, 2><<<g, DIA_THREADS, 0, s>>>(ct, x, offs, dbar, per_comp, cbar, n);
      break;
    case 3:
      dia_cotangent_multi_kernel<T, 3><<<g, DIA_THREADS, 0, s>>>(ct, x, offs, dbar, per_comp, cbar, n);
      break;
    case 4:
      dia_cotangent_multi_kernel<T, 4><<<g, DIA_THREADS, 0, s>>>(ct, x, offs, dbar, per_comp, cbar, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" {

int dia_matvec_f32(const float* d, const float* c, const int* offsets, int k,
                   const float* x, float* y, long long n, void* stream) {
  return launch_k1<float>(d, c, offsets, k, x, y, n, stream);
}

int dia_matvec_f64(const double* d, const double* c, const int* offsets, int k,
                   const double* x, double* y, long long n, void* stream) {
  return launch_k1<double>(d, c, offsets, k, x, y, n, stream);
}

int dia_matvec_multi_f32(const float* d, long long d_cstride, const float* c,
                         const int* offsets, int k, const float* x, float* y,
                         int ncomp, long long n, void* stream) {
  return launch_k2<float>(d, d_cstride, c, offsets, k, x, y, ncomp, n, stream);
}

int dia_matvec_multi_f64(const double* d, long long d_cstride, const double* c,
                         const int* offsets, int k, const double* x, double* y,
                         int ncomp, long long n, void* stream) {
  return launch_k2<double>(d, d_cstride, c, offsets, k, x, y, ncomp, n, stream);
}

#define DIA_K3_ENTRY_POINTS(T, SFX)                                            \
  int dia_matvec_t_##SFX(const T* d, const T* c, const int* offsets, int k,    \
                         const T* ct, T* xbar, long long n, void* stream) {    \
    return launch_k3a<T>(d, c, offsets, k, ct, xbar, n, stream);               \
  }                                                                            \
  int dia_matvec_multi_t_##SFX(const T* d, long long d_cstride, const T* c,    \
                               const int* offsets, int k, const T* ct,         \
                               T* xbar, int ncomp, long long n,                \
                               void* stream) {                                 \
    return launch_k3a_multi<T>(d, d_cstride, c, offsets, k, ct, xbar, ncomp,   \
                               n, stream);                                     \
  }                                                                            \
  int dia_cotangent_##SFX(const T* ct, const T* x, const int* offsets, int k,  \
                          T* dbar, T* cbar, long long n, void* stream) {       \
    return launch_k3b<T>(ct, x, offsets, k, dbar, cbar, n, stream);            \
  }                                                                            \
  int dia_cotangent_multi_##SFX(const T* ct, const T* x, const int* offsets,   \
                                int k, T* dbar, int per_comp, T* cbar,         \
                                int ncomp, long long n, void* stream) {        \
    return launch_k3b_multi<T>(ct, x, offsets, k, dbar, per_comp, cbar, ncomp, \
                               n, stream);                                     \
  }

DIA_K3_ENTRY_POINTS(float, f32)
DIA_K3_ENTRY_POINTS(double, f64)

}  // extern "C"
