// K2: the FK + velocity/bias tree pass of a floating-base robot, one thread per
// batch element.
//
// Replaces `wb_humanoid_mpc_tpu/ops/fkvel.py::_fkvel_kernel` (the Pallas TPU
// kernel behind `pallas_fkvel`). Per element it builds the base rotation from
// ZYX Euler angles, E(theta) and dE/dt theta_dot, then walks the joints in
// topological order (parents before children, body b = joint j + 1): the
// Rodrigues rotation, child pose, twist (v_o, omega), bias accelerations
// (a_o seeded with +g z, domega) and the world joint axis. Outputs are in the
// JAX wrapper's public layout: R [B,n_b,3,3], p [B,n_b,3], vb [B,n_b,4,3]
// (rows v_o, omega, a_o, domega), axes [B,n_j,3], E [B,3,3].
//
// Design. The TPU kernel folds the URDF joint constants into straight-line
// code at trace time, a Mosaic-specific trick; this kernel is table driven
// instead: the joint tables (order, parent body, joint R, joint p, axis) are
// small read-only device arrays that each block copies into shared memory.
// Each thread keeps nothing per body in registers: it writes every body's
// state to the outputs and reads its parent's state back (same thread, so
// program order makes it visible; the lines stay in L1).
//
// Bound. At n_j = 23 an element writes 24*(9+3+12)+23*3+9 = 654 values
// (2.6 KB in f32) and reads 58; at B = 28 that is about 75 KB, some 22 ns at
// 3.35 TB/s, and about 5 kFLOP per element (0.14 MFLOP at B = 28, 2 ns at
// 67 TFLOP/s). Launch latency (a few microseconds) dominates by far, and
// only ceil(B/128) blocks run, so specialising the kernel per robot or
// spreading an element over a warp is later work.

#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ void sin_cos(T x, T* s, T* c);

template <>
__device__ __forceinline__ void sin_cos<float>(float x, float* s, float* c) { sincosf(x, s, c); }

template <>
__device__ __forceinline__ void sin_cos<double>(double x, double* s, double* c) { sincos(x, s, c); }

template <typename T>
__device__ __forceinline__ void matmul33(const T* A, const T* B, T* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l)
      C[i * 3 + l] = A[i * 3 + 0] * B[0 * 3 + l] + A[i * 3 + 1] * B[1 * 3 + l] + A[i * 3 + 2] * B[2 * 3 + l];
}

template <typename T>
__device__ __forceinline__ void matvec3(const T* A, const T* x, T* y) {
#pragma unroll
  for (int i = 0; i < 3; ++i) y[i] = A[i * 3 + 0] * x[0] + A[i * 3 + 1] * x[1] + A[i * 3 + 2] * x[2];
}

template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename T>
__global__ void fkvel_kernel(const T* __restrict__ q, const T* __restrict__ v, int B, int n_j,
                             const int* __restrict__ order, const int* __restrict__ parent,
                             const T* __restrict__ jR, const T* __restrict__ jp,
                             const T* __restrict__ axis, T gravity, T* __restrict__ R_out,
                             T* __restrict__ p_out, T* __restrict__ vb_out,
                             T* __restrict__ ax_out, T* __restrict__ E_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_jR = reinterpret_cast<T*>(smem_raw);
  T* s_jp = s_jR + 9 * n_j;
  T* s_ax = s_jp + 3 * n_j;
  int* s_order = reinterpret_cast<int*>(s_ax + 3 * n_j);
  int* s_parent = s_order + n_j;
  for (int i = threadIdx.x; i < 9 * n_j; i += blockDim.x) s_jR[i] = jR[i];
  for (int i = threadIdx.x; i < 3 * n_j; i += blockDim.x) {
    s_jp[i] = jp[i];
    s_ax[i] = axis[i];
  }
  for (int i = threadIdx.x; i < n_j; i += blockDim.x) {
    s_order[i] = order[i];
    s_parent[i] = parent[i];
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int nq = 6 + n_j;
  const int n_b = n_j + 1;
  const T* qb = q + static_cast<size_t>(b) * nq;
  const T* vel = v + static_cast<size_t>(b) * nq;
  T* R = R_out + static_cast<size_t>(b) * n_b * 9;
  T* P = p_out + static_cast<size_t>(b) * n_b * 3;
  T* VB = vb_out + static_cast<size_t>(b) * n_b * 12;
  T* AX = ax_out + static_cast<size_t>(b) * n_j * 3;
  T* E = E_out + static_cast<size_t>(b) * 9;

  // ----- base frame -----
  T sz, cz, sy, cy, sx, cx;
  sin_cos(qb[3], &sz, &cz);
  sin_cos(qb[4], &sy, &cy);
  sin_cos(qb[5], &sx, &cx);
  R[0] = cz * cy;
  R[1] = cz * sy * sx - sz * cx;
  R[2] = cz * sy * cx + sz * sx;
  R[3] = sz * cy;
  R[4] = sz * sy * sx + cz * cx;
  R[5] = sz * sy * cx - cz * sx;
  R[6] = -sy;
  R[7] = cy * sx;
  R[8] = cy * cx;
  P[0] = qb[0];
  P[1] = qb[1];
  P[2] = qb[2];
  const T tzd = vel[3], tyd = vel[4];
  const T Eb[9] = {T(0), -sz, cz * cy, T(0), cz, sz * cy, T(1), T(0), -sy};
  const T dE[9] = {T(0), -cz * tzd, -sz * tzd * cy - cz * sy * tyd,
                   T(0), -sz * tzd, cz * tzd * cy - sz * sy * tyd,
                   T(0), T(0), -cy * tyd};
#pragma unroll
  for (int i = 0; i < 9; ++i) E[i] = Eb[i];
  matvec3(Eb, vel + 3, VB + 3);  // omega_0 = E theta_dot
  matvec3(dE, vel + 3, VB + 9);  // domega_0 = dE theta_dot (theta_ddot = 0)
  VB[0] = vel[0];
  VB[1] = vel[1];
  VB[2] = vel[2];
  VB[6] = T(0);
  VB[7] = T(0);
  VB[8] = gravity;  // RNEA gravity seed

  // ----- joint recursion, topological order -----
  for (int t = 0; t < n_j; ++t) {
    const int j = s_order[t];
    const int pb = s_parent[j];
    const T* Rp = R + pb * 9;
    const T* pp = P + pb * 3;
    const T* vp = VB + pb * 12;
    const T* wp = vp + 3;
    const T* ap = vp + 6;
    const T* dwp = vp + 9;
    const T* ax = s_ax + 3 * j;
    const T* jRj = s_jR + 9 * j;

    T s, c;
    sin_cos(qb[6 + j], &s, &c);
    const T Km[9] = {T(0), -ax[2], ax[1], ax[2], T(0), -ax[0], -ax[1], ax[0], T(0)};
    T KK[9];
    matmul33(Km, Km, KK);
    T rod[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) rod[i] = (i % 4 == 0 ? T(1) : T(0)) + s * Km[i] + (T(1) - c) * KK[i];
    T M_l[9];
    matmul33(jRj, rod, M_l);
    const int bc = j + 1;  // child body of joint j
    matmul33(Rp, M_l, R + bc * 9);
    T r[3], ax_c[3], axis_w[3];
    matvec3(Rp, s_jp + 3 * j, r);
    matvec3(jRj, ax, ax_c);
    matvec3(Rp, ax_c, axis_w);

    const T qd = vel[6 + j];
    T wxr[3], dwxr[3], wxwxr[3], wxa[3];
    cross3(wp, r, wxr);
    cross3(dwp, r, dwxr);
    cross3(wp, wxr, wxwxr);
    cross3(wp, axis_w, wxa);
    T* pc = P + bc * 3;
    T* vc = VB + bc * 12;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pc[i] = pp[i] + r[i];
      vc[i] = vp[i] + wxr[i];
      vc[3 + i] = wp[i] + axis_w[i] * qd;
      vc[6 + i] = ap[i] + dwxr[i] + wxwxr[i];
      vc[9 + i] = dwp[i] + wxa[i] * qd;
      AX[3 * j + i] = axis_w[i];
    }
  }
}

template <typename T>
int launch_fkvel(const T* q, const T* v, const int* order, const int* parent, const T* jR,
                 const T* jp, const T* axis, double gravity, T* R, T* p, T* vb, T* ax, T* E,
                 int B, int n_j, void* stream) {
  if (B <= 0 || n_j <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  const size_t smem = static_cast<size_t>(15 * n_j) * sizeof(T) + 2 * n_j * sizeof(int);
  fkvel_kernel<T><<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, v, B, n_j, order, parent, jR, jp, axis, static_cast<T>(gravity), R, p, vb, ax, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int wbmpc_fkvel_f32(const float* q, const float* v, const int* order,
                               const int* parent, const float* jR, const float* jp,
                               const float* axis, double gravity, float* R, float* p,
                               float* vb, float* ax, float* E, int B, int n_j, void* stream) {
  return launch_fkvel<float>(q, v, order, parent, jR, jp, axis, gravity, R, p, vb, ax, E, B, n_j,
                             stream);
}

extern "C" int wbmpc_fkvel_f64(const double* q, const double* v, const int* order,
                               const int* parent, const double* jR, const double* jp,
                               const double* axis, double gravity, double* R, double* p,
                               double* vb, double* ax, double* E, int B, int n_j, void* stream) {
  return launch_fkvel<double>(q, v, order, parent, jR, jp, axis, gravity, R, p, vb, ax, E, B, n_j,
                              stream);
}
