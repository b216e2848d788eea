// Hybrid-DIA SpMV and the smoothed block-Jacobi preconditioner of the
// forward CG loop of thinshelllab_torch, for sm_90a (H100).
//
// Replaces the Pallas TPU kernels of thinshelllab_tpu/ops/dia_spmv.py:
//   tsl_dia_spmv_*    <- dia_spmv    (_kernel, _spmv_acc, _call)
//   tsl_dia_precond_* <- dia_precond (_precond_kernel)
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
// The preconditioner z_0 = w D^-1 r, z_{k+1} = z_k + w D^-1 (r - unf * A' z_k)
// (A' = the store with the full block diagonal folded into the offset-0
// lane) is one persistent cooperative launch per call. The TPU kernel ran
// the polynomial as one grid whose sequential order was the barrier between
// sweeps; here every CTA of the grid stays resident and
// cooperative_groups' grid.sync() is that barrier. A launch per sweep reads
// the store from HBM in every sweep that uses it (3 times at the bench), so
// each CTA instead copies its rows' slice of all n_off x 9 planes into
// shared memory once per call, laid out [plane][row] (neighbouring threads
// read neighbouring rows, no bank conflicts), and every sweep reads it
// there. The f32 bench store (15.7 MB) fits in the 132 SMs' shared memory:
// one CTA per SM, 48 rows and 122.7 KB of store each. Where a CTA's slice
// does not fit its budget (f64 at bench size), the leading `staged` lanes
// are copied and the rest are read from global memory in every sweep: one
// code path with a runtime lane count. The copy is 16-byte cp.async by
// every thread: a plane's slice is only R * 4 bytes (192 at the bench), and
// one cp.async.bulk per plane (639 a CTA), completing on mbarriers, made the
// first store-reading sweep about 5x slower on an H100
// (scripts/precond_breakdown.py). The copies run while the CTA does sweep 0
// (z_0 reads no store) and its first barrier. r, unf and D^-1 of the CTA's
// rows are copied first and kept in shared memory for all sweeps. z ping-pongs between two global buffers:
// each sweep a CTA loads its window, rows [r0 - P, r0 + R + P) with
// P = max |offset| (zero outside [0, NVp)), into shared memory with L2-only
// loads (ld.global.cg), because grid.sync() orders the other CTAs' writes
// but would leave this SM's L1 line of the same buffer from two sweeps
// earlier in place. Rows per CTA, offset groups, threads, staged lanes and
// shared memory come from precond_plan in thinshelllab_torch/ops/
// dia_spmv.py; a grid that cannot be co-resident makes the cooperative
// launch fail. What bounds it at the bench is latency, not bytes: each
// sweep is a grid barrier plus a round trip to L2 for the window, a few
// microseconds against the 0.5 us its shared-memory reads take.
//
// Every entry point launches on the given stream and returns a CUDA error
// code (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// dia_precond
// ---------------------------------------------------------------------------

// Byte offsets of the regions of the dynamic shared memory, for R rows,
// G offset groups, a z window of W rows and `staged` lanes held:
//   store [staged * 9][R]  vec [15][R] (r 0-2, unf 3-5, D^-1 6-14)
//   part [3][G][R]  zwin [3][W]  offs [n_off] int
// The store and vec, filled by 16-byte copies, start 16-byte aligned (R is
// a multiple of 4). precond_smem_bytes in ops/dia_spmv.py computes the same
// total.
struct PrecondLayout {
  size_t vec, part, zwin, offs, total;
};

template <typename T>
__host__ __device__ inline PrecondLayout precond_layout(int R, int G, int W,
                                                        int staged,
                                                        int n_off) {
  const size_t it = sizeof(T);
  PrecondLayout l;
  l.vec = static_cast<size_t>(9) * staged * R * it;
  l.part = l.vec + static_cast<size_t>(15) * R * it;
  l.zwin = l.part + static_cast<size_t>(3) * G * R * it;
  l.offs = l.zwin + static_cast<size_t>(3) * W * it;
  l.total = l.offs + 4 * static_cast<size_t>(n_off);
  return l;
}

// 16 (4) bytes from global to shared memory, asynchronously, through L2
// only (through L1).
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// The whole polynomial for rows [blockIdx.x * R, + R) of every sweep: za
// holds z after sweeps 0, 2, ..., zb after sweeps 1, 3, ...; the result is
// in za for even `sweeps`, in zb for odd. Thread items (row, g), item =
// g * R + row, sum lanes g, g + G, ... of their row.
template <typename T>
__global__ void __launch_bounds__(1024)
dia_precond_kernel(const T* __restrict__ dia, const T* __restrict__ r,
                   const T* __restrict__ unf, const T* __restrict__ dinv,
                   T* za, T* zb, const int* __restrict__ offs, int n_off,
                   int NVp, T w, int sweeps, int R, int G, int staged, int P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = R + 2 * P;
  const PrecondLayout lay = precond_layout<T>(R, G, W, staged, n_off);
  T* store = reinterpret_cast<T*>(smem);
  T* part = reinterpret_cast<T*>(smem + lay.part);
  T* zwin = reinterpret_cast<T*>(smem + lay.zwin);
  T* vec = reinterpret_cast<T*>(smem + lay.vec);
  int* soff = reinterpret_cast<int*>(smem + lay.offs);

  const size_t plane = static_cast<size_t>(NVp);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int r0 = blockIdx.x * R;
  const int nrows = min(R, NVp - r0);  // a multiple of 4, >= 4
  // with no store-reading sweep nothing is copied
  const int held = sweeps > 0 ? staged : 0;

  // 1. Asynchronous copies into shared memory, neighbouring threads on
  // neighbouring 16 bytes of a plane's row slice: first the CTA's rows of
  // r, unf and D^-1 and the offset table, read once for all sweeps, then
  // the store slice, which runs on while the CTA does sweep 0 and is
  // waited for before the first store-reading sweep. Shared rows past NVp
  // (in the last CTA) are never read.
  constexpr int kPer16 = 16 / sizeof(T);
  const int per_plane = nrows / kPer16;
  for (int i = tid; i < 15 * per_plane; i += nt) {
    const int q = i / per_plane, v = (i - q * per_plane) * kPer16;
    const T* src = q < 3 ? r + q * plane
                   : q < 6 ? unf + (q - 3) * plane
                           : dinv + (q - 6) * plane;
    copy16_async(vec + q * R + v, src + r0 + v);
  }
  for (int i = tid; i < n_off; i += nt) copy4_async(soff + i, offs + i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = tid; i < 9 * held * per_plane; i += nt) {
    const int p = i / per_plane, v = (i - p * per_plane) * kPer16;
    copy16_async(store + static_cast<size_t>(p) * R + v,
                 dia + static_cast<size_t>(p) * plane + r0 + v);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // all but the store
  __syncthreads();
  const T* rv = vec;
  const T* uv = vec + 3 * R;
  const T* dv = vec + 6 * R;

  // 3. Sweep 0: z_0 = w D^-1 r (reads no store).
  for (int row = tid; row < nrows; row += nt) {
    const T s0 = rv[row], s1 = rv[R + row], s2 = rv[2 * R + row];
    const size_t n = static_cast<size_t>(r0 + row);
    __stcg(za + n, w * (dv[0 * R + row] * s0 + dv[1 * R + row] * s1 +
                        dv[2 * R + row] * s2));
    __stcg(za + plane + n, w * (dv[3 * R + row] * s0 + dv[4 * R + row] * s1 +
                                dv[5 * R + row] * s2));
    __stcg(za + 2 * plane + n,
           w * (dv[6 * R + row] * s0 + dv[7 * R + row] * s1 +
                dv[8 * R + row] * s2));
  }

  // 4. Sweeps 1..sweeps, each behind a grid-wide barrier.
  cg::grid_group grid = cg::this_grid();
  for (int k = 1; k <= sweeps; ++k) {
    grid.sync();
    const T* zin = (k & 1) ? za : zb;
    T* zout = (k & 1) ? zb : za;
    for (int j = tid; j < W; j += nt) {  // three loads in flight a thread
      const int m = r0 - P + j;
      T v0 = T(0), v1 = T(0), v2 = T(0);
      if (m >= 0 && m < NVp) {
        v0 = __ldcg(zin + m);
        v1 = __ldcg(zin + plane + m);
        v2 = __ldcg(zin + 2 * plane + m);
      }
      zwin[j] = v0;
      zwin[W + j] = v1;
      zwin[2 * W + j] = v2;
    }
    if (k == 1) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    for (int item = tid; item < R * G; item += nt) {
      const int g = item / R, row = item - g * R;
      T a0 = T(0), a1 = T(0), a2 = T(0);
      if (row < nrows) {
        const T* x = zwin + row + P;
        int o = g;
        for (; o < held; o += G) {
          const int m = soff[o];
          const T x0 = x[m], x1 = x[W + m], x2 = x[2 * W + m];
          const T* d = store + static_cast<size_t>(o) * 9 * R + row;
          a0 += d[0 * R] * x0 + d[1 * R] * x1 + d[2 * R] * x2;
          a1 += d[3 * R] * x0 + d[4 * R] * x1 + d[5 * R] * x2;
          a2 += d[6 * R] * x0 + d[7 * R] * x1 + d[8 * R] * x2;
        }
        const size_t n = static_cast<size_t>(r0 + row);
        for (; o < n_off; o += G) {  // lanes past the staged ones
          const int m = soff[o];
          const T x0 = x[m], x1 = x[W + m], x2 = x[2 * W + m];
          const T* d = dia + static_cast<size_t>(o) * 9 * plane + n;
          a0 += __ldg(d) * x0 + __ldg(d + plane) * x1 + __ldg(d + 2 * plane) * x2;
          a1 += __ldg(d + 3 * plane) * x0 + __ldg(d + 4 * plane) * x1 +
                __ldg(d + 5 * plane) * x2;
          a2 += __ldg(d + 6 * plane) * x0 + __ldg(d + 7 * plane) * x1 +
                __ldg(d + 8 * plane) * x2;
        }
      }
      part[g * R + row] = a0;
      part[(G + g) * R + row] = a1;
      part[(2 * G + g) * R + row] = a2;
    }
    __syncthreads();

    // the groups' partial sums, one thread per (component, row), into the
    // slot of group 0
    for (int i = tid; i < 3 * nrows; i += nt) {
      const int c = i / nrows, row = i - c * nrows;
      T* pc = part + static_cast<size_t>(c) * G * R + row;
      T a = T(0);
      for (int g = 0; g < G; ++g) a += pc[g * R];
      pc[0] = a;
    }
    __syncthreads();

    for (int row = tid; row < nrows; row += nt) {
      const T a0 = part[row], a1 = part[G * R + row],
              a2 = part[2 * G * R + row];
      const T s0 = rv[row] - uv[row] * a0;
      const T s1 = rv[R + row] - uv[R + row] * a1;
      const T s2 = rv[2 * R + row] - uv[2 * R + row] * a2;
      const T* zc = zwin + P + row;
      const size_t n = static_cast<size_t>(r0 + row);
      __stcg(zout + n, zc[0] + w * (dv[0 * R + row] * s0 +
                                    dv[1 * R + row] * s1 +
                                    dv[2 * R + row] * s2));
      __stcg(zout + plane + n, zc[W] + w * (dv[3 * R + row] * s0 +
                                            dv[4 * R + row] * s1 +
                                            dv[5 * R + row] * s2));
      __stcg(zout + 2 * plane + n, zc[2 * W] + w * (dv[6 * R + row] * s0 +
                                                    dv[7 * R + row] * s1 +
                                                    dv[8 * R + row] * s2));
    }
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

// Lets dia_precond_kernel<T> take `smem_bytes` of dynamic shared memory on
// the current device; the attribute is set when a launch needs more than
// before, not on every launch.
template <typename T>
cudaError_t allow_smem(int smem_bytes) {
  constexpr int kDevices = 64;
  static int allowed[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && allowed[dev] >= smem_bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(dia_precond_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err == cudaSuccess && dev < kDevices) allowed[dev] = smem_bytes;
  return err;
}

template <typename T>
int precond_occupancy(int threads, int smem_bytes, int* blocks) {
  cudaError_t err = allow_smem<T>(smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, dia_precond_kernel<T>, threads, smem_bytes);
  return static_cast<int>(err);
}

template <typename T>
int launch_precond(const void* dia, const void* r, const void* unf,
                   const void* dinv, void* za, void* zb, const void* offs,
                   int n_off, int NVp, double w, int sweeps, int rows,
                   int groups, int staged, int max_off, int grid, int threads,
                   int smem_bytes, void* stream) {
  const PrecondLayout lay =
      precond_layout<T>(rows, groups, rows + 2 * max_off, staged, n_off);
  // the 16-byte copies need aligned row slices: the store, r, unf and
  // D^-1 16-byte aligned, R and NVp multiples of 4; whole warps; the grid covers every
  // row and no CTA is empty
  if ((reinterpret_cast<uintptr_t>(dia) | reinterpret_cast<uintptr_t>(r) |
       reinterpret_cast<uintptr_t>(unf) |
       reinterpret_cast<uintptr_t>(dinv)) % 16 != 0 || rows <= 0 ||
      rows % 4 != 0 || NVp % 4 != 0 || groups <= 0 || staged < 0 ||
      staged > n_off || max_off < 0 || threads <= 0 || threads % 32 != 0 ||
      threads > 1024 || sweeps < 0 || grid <= 0 ||
      static_cast<long long>(grid) * rows < NVp ||
      static_cast<long long>(grid - 1) * rows >= NVp ||
      static_cast<size_t>(smem_bytes) < lay.total)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem<T>(smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* dia_p = static_cast<const T*>(dia);
  const T* r_p = static_cast<const T*>(r);
  const T* unf_p = static_cast<const T*>(unf);
  const T* dinv_p = static_cast<const T*>(dinv);
  T* za_p = static_cast<T*>(za);
  T* zb_p = static_cast<T*>(zb);
  const int* offs_p = static_cast<const int*>(offs);
  T w_t = static_cast<T>(w);
  void* args[] = {&dia_p, &r_p,   &unf_p, &dinv_p, &za_p,   &zb_p,
                  &offs_p, &n_off, &NVp,  &w_t,    &sweeps, &rows,
                  &groups, &staged, &max_off};
  // refused (cudaErrorCooperativeLaunchTooLarge) when the grid cannot be
  // co-resident
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(dia_precond_kernel<T>), dim3(grid),
      dim3(threads), args, static_cast<size_t>(smem_bytes),
      static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
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

// The device's SM count and the shared memory (bytes) a block may opt in
// to.
int tsl_device_limits(int device, int* sms, int* smem_block_optin) {
  cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        smem_block_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return static_cast<int>(err);
}

// CTAs of the preconditioner kernel one SM holds at `threads` threads and
// `smem_bytes` of dynamic shared memory, on the current device.
int tsl_dia_precond_occupancy_f32(int threads, int smem_bytes, int* blocks) {
  return precond_occupancy<float>(threads, smem_bytes, blocks);
}

int tsl_dia_precond_occupancy_f64(int threads, int smem_bytes, int* blocks) {
  return precond_occupancy<double>(threads, smem_bytes, blocks);
}

int tsl_dia_precond_f32(const void* dia, const void* r, const void* unf,
                        const void* dinv, void* za, void* zb,
                        const void* offs, int n_off, int NVp, double w,
                        int sweeps, int rows, int groups, int staged,
                        int max_off, int grid, int threads, int smem_bytes,
                        void* stream) {
  return launch_precond<float>(dia, r, unf, dinv, za, zb, offs, n_off, NVp, w,
                               sweeps, rows, groups, staged, max_off, grid,
                               threads, smem_bytes, stream);
}

int tsl_dia_precond_f64(const void* dia, const void* r, const void* unf,
                        const void* dinv, void* za, void* zb,
                        const void* offs, int n_off, int NVp, double w,
                        int sweeps, int rows, int groups, int staged,
                        int max_off, int grid, int threads, int smem_bytes,
                        void* stream) {
  return launch_precond<double>(dia, r, unf, dinv, za, zb, offs, n_off, NVp,
                                w, sweeps, rows, groups, staged, max_off, grid,
                                threads, smem_bytes, stream);
}

}  // extern "C"
