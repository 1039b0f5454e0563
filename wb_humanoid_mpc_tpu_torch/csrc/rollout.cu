// K3: the closed-loop linear forward rollout of the LQ subproblem in one
// launch, given the Riccati gains:
//   du_k = K_k dx_k + k_k,   dx_{k+1} = A_k dx_k + B_k du_k + d_k,
// returning dxs [N+1, nx] and dus [N, nu]. One thread block per problem
// instance; the grid is the batch.
//
// Replaces `wb_humanoid_mpc_tpu/ops/rollout.py::_rollout_kernel`, the Pallas
// TPU kernel behind `pallas_forward_rollout`.
//
// Design. The block walks the N stages in order; only dx (double-buffered)
// and du live in shared memory, 2 nx + nu values. Each stage's A, B and K are
// streamed from global memory and never staged whole, so no shape of the
// repo needs the opt-in above 48 KB (one stage's A, B, K at (58, 35) in f64
// is 59 KB). Per stage:
//   1. one warp per row of K: a coalesced, lane-strided dot product with dx,
//      a shuffle reduction, + k  -> du (and dus);
//   2. barrier;
//   3. one warp per row of [A | B] against [dx; du], + d  -> the next dx;
//   4. barrier, swap the dx buffers.
// With 1024 threads (32 warps) a warp holds at most two of the 58 rows.
// Sums are taken in the input type (f32 or f64); there is no TF32 anywhere.
//
// Bound. The rollout reads each stage's A, B, d, K, k once and writes dxs and
// dus once: at (N, nx, nu) = (28, 58, 35) in f32 that is 213,196 values
// (852.8 KB), 0.255 us at 3.35 TB/s, against about 0.42 MFLOP (6 ns at
// 67 TFLOP/s): bytes bound. One block walking 28 dependent stages with two
// barriers each is latency bound by construction (tens of us); prefetching
// stage i+1 (cp.async or TMA) while stage i reduces, and several instances
// per block, are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarp = 32;

template <typename T>
__device__ inline T warp_sum(T v) {
  for (int off = kWarp / 2; off > 0; off /= 2) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void forward_rollout_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                                       const T* __restrict__ d, const T* __restrict__ K,
                                       const T* __restrict__ k, const T* __restrict__ dx0,
                                       T* __restrict__ dxs, T* __restrict__ dus, int N, int nx,
                                       int nu) {
  const size_t inst = blockIdx.x;
  const size_t nxx = static_cast<size_t>(nx) * nx, nxu = static_cast<size_t>(nx) * nu;
  A += inst * N * nxx;
  Bm += inst * N * nxu;
  d += inst * N * static_cast<size_t>(nx);
  K += inst * N * nxu;
  k += inst * N * static_cast<size_t>(nu);
  dx0 += inst * nx;
  dxs += inst * (N + 1) * static_cast<size_t>(nx);
  dus += inst * N * static_cast<size_t>(nu);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* dx = reinterpret_cast<T*>(smem_raw);  // [nx], the current state deviation
  T* dxn = dx + nx;                        // [nx], the next one
  T* du = dxn + nx;                        // [nu]
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int n_warps = blockDim.x / kWarp;

  for (int r = tid; r < nx; r += blockDim.x) dx[r] = dx0[r];
  __syncthreads();

  for (int s = 0; s < N; ++s) {
    const T* As = A + s * nxx;
    const T* Bs = Bm + s * nxu;
    const T* Ks = K + s * nxu;
    // dxs[s] = dx, and du = K dx + k (one warp per row of K)
    for (int r = tid; r < nx; r += blockDim.x) dxs[static_cast<size_t>(s) * nx + r] = dx[r];
    for (int r = warp; r < nu; r += n_warps) {
      T acc = T(0);
      for (int c = lane; c < nx; c += kWarp) acc += Ks[static_cast<size_t>(r) * nx + c] * dx[c];
      acc = warp_sum(acc);
      if (lane == 0) {
        acc += k[static_cast<size_t>(s) * nu + r];
        du[r] = acc;
        dus[static_cast<size_t>(s) * nu + r] = acc;
      }
    }
    __syncthreads();
    // dx_next = A dx + B du + d (one warp per row of [A | B])
    for (int r = warp; r < nx; r += n_warps) {
      T acc = T(0);
      for (int c = lane; c < nx; c += kWarp) acc += As[static_cast<size_t>(r) * nx + c] * dx[c];
      for (int m = lane; m < nu; m += kWarp) acc += Bs[static_cast<size_t>(r) * nu + m] * du[m];
      acc = warp_sum(acc);
      if (lane == 0) dxn[r] = acc + d[static_cast<size_t>(s) * nx + r];
    }
    __syncthreads();
    T* tmp = dx;
    dx = dxn;
    dxn = tmp;
  }
  for (int r = tid; r < nx; r += blockDim.x) dxs[static_cast<size_t>(N) * nx + r] = dx[r];
}

template <typename T>
int launch_rollout(const T* A, const T* B, const T* d, const T* K, const T* k, const T* dx0,
                   T* dxs, T* dus, int batch, int N, int nx, int nu, void* stream) {
  if (batch <= 0 || N <= 0 || nx <= 0 || nu <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (2 * static_cast<size_t>(nx) + nu) * sizeof(T);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  forward_rollout_kernel<T><<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, B, d, K, k, dx0, dxs, dus, N, nx, nu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int wbmpc_forward_rollout_f32(const float* A, const float* B, const float* d,
                                         const float* K, const float* k, const float* dx0,
                                         float* dxs, float* dus, int batch, int N, int nx, int nu,
                                         void* stream) {
  return launch_rollout<float>(A, B, d, K, k, dx0, dxs, dus, batch, N, nx, nu, stream);
}

extern "C" int wbmpc_forward_rollout_f64(const double* A, const double* B, const double* d,
                                         const double* K, const double* k, const double* dx0,
                                         double* dxs, double* dus, int batch, int N, int nx,
                                         int nu, void* stream) {
  return launch_rollout<double>(A, B, d, K, k, dx0, dxs, dus, batch, N, nx, nu, stream);
}
