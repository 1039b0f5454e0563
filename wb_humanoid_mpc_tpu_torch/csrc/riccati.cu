// K1: the whole LQ solve of one multiple-shooting problem in one launch: the
// backward Riccati recursion over N stages, then the closed-loop forward
// rollout. One thread block per problem instance; the grid is the batch.
//
// Replaces `wb_humanoid_mpc_tpu/ops/riccati.py::_riccati_kernel` (with
// `_gj_solve`), the Pallas TPU kernel behind `pallas_riccati_rollout`.
//
// Convention (see solver/riccati.py of the PyTorch port):
//   dx_{k+1} = A_k dx_k + B_k du_k + d_k
//   stage cost 1/2 dx'Qxx dx + 1/2 du'Quu du + du'Qux dx + qx'dx + qu'du
//   terminal   1/2 dx'QN dx + qN'dx,   du = K dx + k.
// Per stage, backwards: Quu_h = Quu + B'PB is damped by reg * max(max diag, 1)
// on its diagonal and symmetrized (the rule of ops/riccati.py:97-103), then
// [Quu_h | Qux_h, Qu] is reduced by Gauss-Jordan without pivoting (Quu_h is
// SPD after the damping), which yields K and k directly; P and p are updated
// and P symmetrized. The forward rollout then reads K and k back from global
// memory (written by this block before a __syncthreads).
//
// Design. P and p stay in shared memory across the sequential N loop, with
// PA = P A, PB = P B, the augmented block and Qux_h; each stage's A, B, Qxx,
// Quu, Qux, qx, qu and d are read from global memory (L1/L2 resident). nx and
// nu are runtime arguments and the shared memory is sized dynamically
// (`smem_elems`): 2 nx^2 + 2 nx nu + nu w + 4 nx + nu + w + 1 elements with
// w = nu + nx + 1, about 44 KB at nx = 58, nu = 21 in f32; f64 or the unprojected nu = 35 case need
// the opt-in above 48 KB, and more than 227 KB is refused.
//
// Bound. At (N, nx, nu) = (28, 58, 21) the recursion does about 1.33 MFLOP a
// stage (P A, A'PA, P B, B'PB, B'PA, the 21-pivot elimination, Qux_h'K), about
// 37 MFLOP in all, and moves about 1.2 MB (each stage's data read once, K, k,
// dxs, dus written once): 0.55 us at 67 TFLOP/s f32, 0.36 us at 3.35 TB/s, so
// about 0.6 us is the least the card could take. A single block on one SM is
// latency bound by construction: each stage is a chain of dependent
// reductions separated by block barriers. A faster design (several instances
// per block, warp-level tiles or tensor-core mma for the 58x58 products) is
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a block may opt in to on sm_90

__host__ __device__ inline size_t smem_elems(int nx, int nu) {
  const size_t w = static_cast<size_t>(nu + nx + 1);
  return 2 * static_cast<size_t>(nx) * nx          // P, PA
         + static_cast<size_t>(nx) * nu            // PB
         + static_cast<size_t>(nu) * w             // augmented [Quu_h | Qux_h Qu]
         + static_cast<size_t>(nu) * nx            // Qux_h
         + 4 * static_cast<size_t>(nx)             // p, Pd+p, Qx, dx_next
         + static_cast<size_t>(nu) + w + 1;        // pivot column, pivot row, scale
}

template <typename T>
__global__ void riccati_rollout_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                                       const T* __restrict__ d, const T* __restrict__ Qxx,
                                       const T* __restrict__ Quu, const T* __restrict__ Qux,
                                       const T* __restrict__ qx, const T* __restrict__ qu,
                                       const T* __restrict__ QN, const T* __restrict__ qN,
                                       const T* __restrict__ dx0, T* __restrict__ K,
                                       T* __restrict__ k, T* __restrict__ dxs,
                                       T* __restrict__ dus, int N, int nx, int nu, T reg) {
  const size_t inst = blockIdx.x;
  const size_t nxx = static_cast<size_t>(nx) * nx, nxu = static_cast<size_t>(nx) * nu;
  A += inst * N * nxx;
  Bm += inst * N * nxu;
  d += inst * N * nx;
  Qxx += inst * N * nxx;
  Quu += inst * N * static_cast<size_t>(nu) * nu;
  Qux += inst * N * nxu;
  qx += inst * N * nx;
  qu += inst * N * nu;
  QN += inst * nxx;
  qN += inst * nx;
  dx0 += inst * nx;
  K += inst * N * nxu;
  k += inst * N * nu;
  dxs += inst * (N + 1) * static_cast<size_t>(nx);
  dus += inst * N * nu;

  const int w = nu + nx + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* P = reinterpret_cast<T*>(smem_raw);
  T* PA = P + nxx;
  T* PB = PA + nxx;
  T* Aug = PB + nxu;
  T* Quxh = Aug + static_cast<size_t>(nu) * w;
  T* p = Quxh + nxu;
  T* Pdp = p + nx;
  T* Qx = Pdp + nx;
  T* dxn = Qx + nx;
  T* fac = dxn + nx;
  T* prow = fac + nu;
  T* scale = prow + w;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < nx * nx; i += nt) P[i] = QN[i];
  for (int i = tid; i < nx; i += nt) p[i] = qN[i];
  __syncthreads();

  // ---- backward Riccati recursion ----
  for (int t = 0; t < N; ++t) {
    const int s = N - 1 - t;
    const T* As = A + s * nxx;
    const T* Bs = Bm + s * nxu;
    const T* ds = d + static_cast<size_t>(s) * nx;

    // Pd + p, P A, P B (the last reads of P)
    for (int r = tid; r < nx; r += nt) {
      T acc = p[r];
      for (int c = 0; c < nx; ++c) acc += P[r * nx + c] * ds[c];
      Pdp[r] = acc;
    }
    for (int e = tid; e < nx * nx; e += nt) {
      const int r = e / nx, c = e % nx;
      T acc = T(0);
      for (int m = 0; m < nx; ++m) acc += P[r * nx + m] * As[m * nx + c];
      PA[e] = acc;
    }
    for (int e = tid; e < nx * nu; e += nt) {
      const int r = e / nu, c = e % nu;
      T acc = T(0);
      for (int m = 0; m < nx; ++m) acc += P[r * nx + m] * Bs[m * nu + c];
      PB[e] = acc;
    }
    __syncthreads();

    // Qx = qx + A'(Pd+p); Qu = qu + B'(Pd+p) -> last column of Aug
    for (int r = tid; r < nx; r += nt) {
      T acc = qx[static_cast<size_t>(s) * nx + r];
      for (int m = 0; m < nx; ++m) acc += As[m * nx + r] * Pdp[m];
      Qx[r] = acc;
    }
    for (int r = tid; r < nu; r += nt) {
      T acc = qu[static_cast<size_t>(s) * nu + r];
      for (int m = 0; m < nx; ++m) acc += Bs[m * nu + r] * Pdp[m];
      Aug[r * w + nu + nx] = acc;
    }
    // Quu_h = Quu + B'PB -> Aug[:, :nu]
    const T* Quus = Quu + static_cast<size_t>(s) * nu * nu;
    for (int e = tid; e < nu * nu; e += nt) {
      const int r = e / nu, c = e % nu;
      T acc = Quus[e];
      for (int m = 0; m < nx; ++m) acc += Bs[m * nu + r] * PB[m * nu + c];
      Aug[r * w + c] = acc;
    }
    // Qux_h = Qux + B'PA -> Quxh and Aug[:, nu:nu+nx]
    const T* Quxs = Qux + s * nxu;
    for (int e = tid; e < nu * nx; e += nt) {
      const int r = e / nx, c = e % nx;
      T acc = Quxs[e];
      for (int m = 0; m < nx; ++m) acc += Bs[m * nu + r] * PA[m * nx + c];
      Quxh[e] = acc;
      Aug[r * w + nu + c] = acc;
    }
    // P <- Qxx_h = Qxx + A'PA
    const T* Qxxs = Qxx + s * nxx;
    for (int e = tid; e < nx * nx; e += nt) {
      const int r = e / nx, c = e % nx;
      T acc = Qxxs[e];
      for (int m = 0; m < nx; ++m) acc += As[m * nx + r] * PA[m * nx + c];
      P[e] = acc;
    }
    __syncthreads();

    // relative Levenberg damping of Quu_h, then symmetrize
    if (tid == 0) {
      T mx = Aug[0];
      for (int r = 1; r < nu; ++r) mx = Aug[r * w + r] > mx ? Aug[r * w + r] : mx;
      scale[0] = reg * (mx > T(1) ? mx : T(1));
    }
    __syncthreads();
    for (int e = tid; e < nu * nu; e += nt) {
      const int r = e / nu, c = e % nu;
      if (r == c) {
        Aug[r * w + r] += scale[0];
      } else if (r < c) {
        const T m = T(0.5) * (Aug[r * w + c] + Aug[c * w + r]);
        Aug[r * w + c] = m;
        Aug[c * w + r] = m;
      }
    }
    __syncthreads();

    // Gauss-Jordan on [Quu_h | Qux_h, Qu]: the right block becomes Quu_h^-1 [Qux_h, Qu]
    for (int j = 0; j < nu; ++j) {
      const T piv = Aug[j * w + j];
      for (int c = tid; c < w; c += nt) prow[c] = Aug[j * w + c] / piv;
      for (int r = tid; r < nu; r += nt) fac[r] = Aug[r * w + j];
      __syncthreads();
      for (int e = tid; e < nu * w; e += nt) {
        const int r = e / w, c = e % w;
        Aug[e] = (r == j) ? prow[c] : Aug[e] - fac[r] * prow[c];
      }
      __syncthreads();
    }

    // K = -sol[:, :nx], k = -sol[:, nx]
    T* Ks = K + s * nxu;
    for (int e = tid; e < nu * nx; e += nt) Ks[e] = -Aug[(e / nx) * w + nu + (e % nx)];
    for (int r = tid; r < nu; r += nt) k[static_cast<size_t>(s) * nu + r] = -Aug[r * w + nu + nx];
    // P = Qxx_h + Qux_h' K,  p = Qx + Qux_h' k
    for (int e = tid; e < nx * nx; e += nt) {
      const int r = e / nx, c = e % nx;
      T acc = P[e];
      for (int m = 0; m < nu; ++m) acc -= Quxh[m * nx + r] * Aug[m * w + nu + c];
      P[e] = acc;
    }
    for (int r = tid; r < nx; r += nt) {
      T acc = Qx[r];
      for (int m = 0; m < nu; ++m) acc -= Quxh[m * nx + r] * Aug[m * w + nu + nx];
      p[r] = acc;
    }
    __syncthreads();
    for (int e = tid; e < nx * nx; e += nt) {
      const int r = e / nx, c = e % nx;
      if (r < c) {
        const T m = T(0.5) * (P[r * nx + c] + P[c * nx + r]);
        P[r * nx + c] = m;
        P[c * nx + r] = m;
      }
    }
    __syncthreads();
  }

  // ---- forward rollout of the closed loop ----
  T* dx = Pdp;
  T* du = fac;
  for (int r = tid; r < nx; r += nt) dx[r] = dx0[r];
  __syncthreads();
  for (int s = 0; s < N; ++s) {
    const T* Ks = K + s * nxu;
    for (int r = tid; r < nu; r += nt) {
      T acc = k[static_cast<size_t>(s) * nu + r];
      for (int c = 0; c < nx; ++c) acc += Ks[r * nx + c] * dx[c];
      du[r] = acc;
      dus[static_cast<size_t>(s) * nu + r] = acc;
    }
    for (int r = tid; r < nx; r += nt) dxs[static_cast<size_t>(s) * nx + r] = dx[r];
    __syncthreads();
    const T* As = A + s * nxx;
    const T* Bs = Bm + s * nxu;
    for (int r = tid; r < nx; r += nt) {
      T acc = d[static_cast<size_t>(s) * nx + r];
      for (int c = 0; c < nx; ++c) acc += As[r * nx + c] * dx[c];
      for (int m = 0; m < nu; ++m) acc += Bs[r * nu + m] * du[m];
      dxn[r] = acc;
    }
    __syncthreads();
    for (int r = tid; r < nx; r += nt) dx[r] = dxn[r];
    __syncthreads();
  }
  for (int r = tid; r < nx; r += nt) dxs[static_cast<size_t>(N) * nx + r] = dx[r];
}

template <typename T>
int launch_riccati(const T* A, const T* B, const T* d, const T* Qxx, const T* Quu, const T* Qux,
                   const T* qx, const T* qu, const T* QN, const T* qN, const T* dx0, T* K, T* k,
                   T* dxs, T* dus, int batch, int N, int nx, int nu, double reg, void* stream) {
  if (batch <= 0 || N <= 0 || nx <= 0 || nu <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_elems(nx, nu) * sizeof(T);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        riccati_rollout_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  riccati_rollout_kernel<T><<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, B, d, Qxx, Quu, Qux, qx, qu, QN, qN, dx0, K, k, dxs, dus, N, nx, nu, static_cast<T>(reg));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" size_t wbmpc_riccati_smem_bytes(int nx, int nu, int elem_size) {
  return smem_elems(nx, nu) * static_cast<size_t>(elem_size);
}

extern "C" int wbmpc_riccati_rollout_f32(const float* A, const float* B, const float* d,
                                         const float* Qxx, const float* Quu, const float* Qux,
                                         const float* qx, const float* qu, const float* QN,
                                         const float* qN, const float* dx0, float* K, float* k,
                                         float* dxs, float* dus, int batch, int N, int nx, int nu,
                                         double reg, void* stream) {
  return launch_riccati<float>(A, B, d, Qxx, Quu, Qux, qx, qu, QN, qN, dx0, K, k, dxs, dus, batch,
                               N, nx, nu, reg, stream);
}

extern "C" int wbmpc_riccati_rollout_f64(const double* A, const double* B, const double* d,
                                         const double* Qxx, const double* Quu, const double* Qux,
                                         const double* qx, const double* qu, const double* QN,
                                         const double* qN, const double* dx0, double* K, double* k,
                                         double* dxs, double* dus, int batch, int N, int nx, int nu,
                                         double reg, void* stream) {
  return launch_riccati<double>(A, B, d, Qxx, Quu, Qux, qx, qu, QN, qN, dx0, K, k, dxs, dus,
                                batch, N, nx, nu, reg, stream);
}

extern "C" const char* wbmpc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
