// Banded (DIA) LDU matvec kernels for Hopper (sm_90a), plain C interface.
//
// K1  dia_matvec:        y[i]   = d[i]   * x[i]   + sum_k c[k,i] * x[i + o_k]
// K2  dia_matvec_multi:  y[q,i] = d[q,i] * x[q,i] + sum_k c[k,i] * x[q, i + o_k]
//
// with x[j] = 0 outside [0, n). K1 replaces the Pallas kernels
// dafoam_tpu/ops/pallas_kernels.py:dia_matvec and :dia_matvec_tiled, K2
// replaces :dia_matvec_multi and :dia_matvec_multi_tiled. The tiled TPU
// variants existed only because of the TPU's on-chip memory size; one
// grid-stride kernel per family covers every n here.
//
// What bounds them on this card: bytes. K1 in float32 reads (K + 2) * 4 B
// per row (diag, K band coefficients, x) and writes 4 B; the shifted reads
// of x hit the same lines as neighbouring rows and come from L1/L2. K2
// reads each band coefficient once for all C components (the TPU tiled
// variant re-read the bands per component). At 262,144 cells with K = 6
// the working set of one call is about 8 MB in float32, far below the
// 50 MB L2 of an H100, so inside a Krylov loop launch overhead, not HBM
// bandwidth, is the expected bound.
//
// Design: one thread per row in a grid-stride loop; coalesced reads of d,
// c and the output; x[i + o_k] through the read-only path with the ragged
// edges masked to zero. The offsets are passed by value in a small struct
// (at most 32), so a call makes no device copy. Every multiply and add is
// explicitly rounded (no FMA contraction) and the bands are summed in the
// order the plain torch version sums them, so the kernel reproduces
// dafoam_tpu_torch.ops.dia_kernels.dia_matvec_plain bit for bit.
//
// Each entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

#define DIA_MAX_OFFSETS 32
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
      if (k < offs.k) {  // static indices into the parameter struct
        const long long j = i + offs.o[k];
        const T xv = (j >= 0 && j < n) ? __ldg(x + j) : T(0);
        acc = radd(acc, rmul(c[(long long)k * n + i], xv));
      }
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
      if (k < offs.k) {
        const T ck = c[(long long)k * n + i];  // read once for all C
        const long long j = i + offs.o[k];
        const bool in = (j >= 0 && j < n);
#pragma unroll
        for (int q = 0; q < C; ++q) {
          const T xv = in ? __ldg(x + q * n + j) : T(0);
          acc[q] = radd(acc[q], rmul(ck, xv));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < C; ++q) y[q * n + i] = acc[q];
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

}  // extern "C"
