// Hybrid-DIA SpMV and smoothed block-Jacobi preconditioner sweeps for the
// forward CG loop of thinshelllab_torch, for sm_90a (H100).
//
// Replaces the Pallas TPU kernels of thinshelllab_tpu/ops/dia_spmv.py:
//   tsl_dia_spmv_*          <- dia_spmv    (_kernel, _spmv_acc, _call)
//   tsl_dia_precond_sweep_* <- dia_precond (_precond_kernel)
//
// Layouts (row-major, contiguous):
//   dia  (n_off, 3, 3, NVp)   one 3x3 block per (offset lane o, row n)
//   x, y, r, unf (3, NVp)     transposed DOF vectors, zero past the last row
//   dinv (3, 3, NVp)          per-row 3x3 block inverse
//   offs (n_off,) int32       row offsets, static per scene
//
// y[i, n] = sum_o sum_j dia[o, i, j, n] * x[j, n + offs[o]], with x read as
// zero outside [0, NVp).
//
// What bounds it: memory bandwidth. Each apply streams the whole store
// (9 * n_off * NVp values: 15.7 MB in f32 at 71 offsets x 6144 rows) and
// does 2 flops per value, about 0.25 flop/byte in f32. The design keeps the
// store reads coalesced and the card full: a block is 32 rows x kGroups
// offset groups; the 32 threads of a warp take 32 neighbouring rows n of one
// offset group, so each (o, i, j) plane is read 128 bytes (f32) at a time,
// and each thread sums every kGroups-th offset. The groups' partial sums
// meet in shared memory. With one thread per row instead, 6144 rows fill 24
// blocks, a fifth of the 132 SMs, each thread walking all 71 offsets alone.
// The x reads at n + offs[o] are contiguous across the warp too and hit
// L1/L2 (x is 3 * NVp values, reused by every offset). The offset table is
// read uniformly by all threads of a warp.
//
// The TPU kernel ran the preconditioner's sweeps as one grid whose
// sequential order was the barrier between sweeps. GPU blocks run
// concurrently, so each sweep is its own launch: sweep 0 (z0 = w D^-1 r,
// reads no store), then one launch per later sweep, z ping-ponged between
// two buffers that the caller allocates. A' in the sweeps is the store with
// the full block diagonal folded into the offset-0 lane.
//
// Every entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;    // rows per block: one warp
constexpr int kGroups = 8;   // offset groups per block: one warp each

// The block's 32 rows of A x: thread (tx, ty) sums offsets ty, ty + kGroups,
// ... of row n = blockIdx.x * kRows + tx; the kGroups partial sums are then
// added in shared memory. The sums are valid in the threads with ty == 0.
// Every thread of the block must call it (it holds a barrier).
template <typename T>
__device__ __forceinline__ void dia_rows(const T* __restrict__ dia,
                                         const T* __restrict__ x,
                                         const int* __restrict__ offs,
                                         int n_off, int NVp, int n,
                                         T& a0, T& a1, T& a2) {
  __shared__ T part[3][kGroups][kRows];
  const size_t plane = static_cast<size_t>(NVp);
  const int tx = threadIdx.x, ty = threadIdx.y;
  a0 = T(0);
  a1 = T(0);
  a2 = T(0);
  if (n < NVp) {
    for (int o = ty; o < n_off; o += kGroups) {
      const int m = n + offs[o];
      T x0 = T(0), x1 = T(0), x2 = T(0);
      if (m >= 0 && m < NVp) {
        x0 = x[m];
        x1 = x[plane + m];
        x2 = x[2 * plane + m];
      }
      const T* d = dia + static_cast<size_t>(o) * 9 * plane + n;
      a0 += d[0 * plane] * x0 + d[1 * plane] * x1 + d[2 * plane] * x2;
      a1 += d[3 * plane] * x0 + d[4 * plane] * x1 + d[5 * plane] * x2;
      a2 += d[6 * plane] * x0 + d[7 * plane] * x1 + d[8 * plane] * x2;
    }
  }
  part[0][ty][tx] = a0;
  part[1][ty][tx] = a1;
  part[2][ty][tx] = a2;
  __syncthreads();
  if (ty == 0) {
    for (int g = 1; g < kGroups; ++g) {
      a0 += part[0][g][tx];
      a1 += part[1][g][tx];
      a2 += part[2][g][tx];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kRows * kGroups)
dia_spmv_kernel(const T* __restrict__ dia, const T* __restrict__ x,
                const int* __restrict__ offs, int n_off, int NVp,
                T* __restrict__ y) {
  const int n = blockIdx.x * kRows + threadIdx.x;
  T a0, a1, a2;
  dia_rows(dia, x, offs, n_off, NVp, n, a0, a1, a2);
  if (threadIdx.y != 0 || n >= NVp) return;
  y[n] = a0;
  y[NVp + n] = a1;
  y[2 * NVp + n] = a2;
}

// One damped Jacobi sweep of the smoothing polynomial:
//   first: z_out = w D^-1 r            (reads no store)
//   else:  z_out = z_in + w D^-1 (r - unf * A' z_in)
template <typename T>
__global__ void __launch_bounds__(kRows * kGroups)
precond_sweep_kernel(const T* __restrict__ dia, const T* __restrict__ r,
                     const T* __restrict__ unf, const T* __restrict__ dinv,
                     const T* __restrict__ z_in, T* __restrict__ z_out,
                     const int* __restrict__ offs, int n_off, int NVp, T w,
                     int first) {
  const int n = blockIdx.x * kRows + threadIdx.x;
  T a0 = T(0), a1 = T(0), a2 = T(0);
  if (!first) dia_rows(dia, z_in, offs, n_off, NVp, n, a0, a1, a2);
  if (threadIdx.y != 0 || n >= NVp) return;
  const size_t plane = static_cast<size_t>(NVp);
  T s0 = r[n], s1 = r[plane + n], s2 = r[2 * plane + n];
  if (!first) {
    s0 -= unf[n] * a0;
    s1 -= unf[plane + n] * a1;
    s2 -= unf[2 * plane + n] * a2;
  }
  const T* dv = dinv + n;
  const T d0 = dv[0 * plane] * s0 + dv[1 * plane] * s1 + dv[2 * plane] * s2;
  const T d1 = dv[3 * plane] * s0 + dv[4 * plane] * s1 + dv[5 * plane] * s2;
  const T d2 = dv[6 * plane] * s0 + dv[7 * plane] * s1 + dv[8 * plane] * s2;
  if (first) {
    z_out[n] = w * d0;
    z_out[plane + n] = w * d1;
    z_out[2 * plane + n] = w * d2;
  } else {
    z_out[n] = z_in[n] + w * d0;
    z_out[plane + n] = z_in[plane + n] + w * d1;
    z_out[2 * plane + n] = z_in[2 * plane + n] + w * d2;
  }
}

inline dim3 grid_for(int NVp) { return dim3((NVp + kRows - 1) / kRows); }
inline dim3 block_dims() { return dim3(kRows, kGroups); }

template <typename T>
int launch_spmv(const void* dia, const void* x, const void* offs, int n_off,
                int NVp, void* y, void* stream) {
  dia_spmv_kernel<T><<<grid_for(NVp), block_dims(), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dia), static_cast<const T*>(x),
      static_cast<const int*>(offs), n_off, NVp, static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_sweep(const void* dia, const void* r, const void* unf,
                 const void* dinv, const void* z_in, void* z_out,
                 const void* offs, int n_off, int NVp, double w, int first,
                 void* stream) {
  precond_sweep_kernel<T><<<grid_for(NVp), block_dims(), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dia), static_cast<const T*>(r),
      static_cast<const T*>(unf), static_cast<const T*>(dinv),
      static_cast<const T*>(z_in), static_cast<T*>(z_out),
      static_cast<const int*>(offs), n_off, NVp, static_cast<T>(w), first);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tsl_dia_spmv_f32(const void* dia, const void* x, const void* offs,
                     int n_off, int NVp, void* y, void* stream) {
  return launch_spmv<float>(dia, x, offs, n_off, NVp, y, stream);
}

int tsl_dia_spmv_f64(const void* dia, const void* x, const void* offs,
                     int n_off, int NVp, void* y, void* stream) {
  return launch_spmv<double>(dia, x, offs, n_off, NVp, y, stream);
}

int tsl_dia_precond_sweep_f32(const void* dia, const void* r, const void* unf,
                              const void* dinv, const void* z_in, void* z_out,
                              const void* offs, int n_off, int NVp, double w,
                              int first, void* stream) {
  return launch_sweep<float>(dia, r, unf, dinv, z_in, z_out, offs, n_off, NVp,
                             w, first, stream);
}

int tsl_dia_precond_sweep_f64(const void* dia, const void* r, const void* unf,
                              const void* dinv, const void* z_in, void* z_out,
                              const void* offs, int n_off, int NVp, double w,
                              int first, void* stream) {
  return launch_sweep<double>(dia, r, unf, dinv, z_in, z_out, offs, n_off,
                              NVp, w, first, stream);
}

}  // extern "C"
