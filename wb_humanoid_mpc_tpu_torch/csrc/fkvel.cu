// K2: the FK + velocity/bias tree pass of a floating-base robot, level by level.
//
// Replaces `wb_humanoid_mpc_tpu/ops/fkvel.py::_fkvel_kernel` (the Pallas TPU
// kernel behind `pallas_fkvel`). Per element it builds the base rotation from
// ZYX Euler angles, E(theta) and dE/dt theta_dot, then walks the joints
// parents before children (body b = joint j + 1): the Rodrigues rotation,
// child pose, twist (v_o, omega), bias accelerations (a_o seeded with +g z,
// domega) and the world joint axis. Outputs are in the JAX wrapper's public
// layout: R [B,n_b,3,3], p [B,n_b,3], vb [B,n_b,4,3] (rows v_o, omega, a_o,
// domega), axes [B,n_j,3], E [B,3,3].
//
// Bound. At n_j = 23 an element reads 58 values, writes 654 (2.8 KB in f32)
// and does about 6.5 kFLOP: some 80 KB at B = 28 (0.024 us at 3.35 TB/s)
// and 640 KB at B = 224 (0.19 us). On this card every launch is far above
// that: an empty kernel queued back to back takes about 1.9 us, and what
// bounds K2 beyond it is the latency of one warp's dependent chain, since
// each element is a short serial computation that no other warp hides. The
// tree of the 23-joint humanoid is 7 levels deep, so the chain is 7 levels
// of a few shared-memory loads and short FMA chains, between one round trip
// to memory for the inputs and the stores of the outputs.
//
// Design: one element per block of one warp, so that B = 28 runs on 28 SMs
// and B = 224 on 132, and no block carries more than one chain.
// - Copies in: the joint tables and the element's q and v go to shared
//   memory by cp.async, all in flight at once: one round trip.
// - Sin and cos of all n_j + 3 angles, one a lane, off the chain.
// - Everything that needs no parent, one joint a lane: the joint's rotation
//   in its parent, M = jR rot(axis, q), folded at run time as the TPU kernel
//   folds it at trace time. The host gives each joint an axis code (+-x,
//   +-y, +-z or general) and a flag for an identity joint_R; for an
//   axis-aligned joint M is jR with two columns turned by (cos, sin) (for
//   jR = I, the 2x2 block itself), so no Rodrigues matrix and no 3x3 product;
//   a general axis builds the Rodrigues matrix and skips jR rod where jR = I.
//   Two more lanes build the base body.
// - The tree walk, level by level (`models/kinematics.py::_tree_levels`):
//   the joints of one level go to different lanes; each reads its parent's
//   R, p and twist/bias vectors from shared memory, computes its child's
//   without a branch (R = R_parent M) and writes it there. A block barrier
//   ends the level. The tree state never goes through device memory.
// - The state is kept in shared memory in the output layout, so the block
//   ends with five straight copies, neighbouring lanes on neighbouring
//   addresses.
// Measured (tools/compare_k2.py, NVIDIA H100 80GB HBM3, 700 W): about 5.8 us
// at B = 28 and 5.9 us at B = 224 in f32, 6.4 and 6.5 us in f64, against 54
// and 143 us (f32) for the first design, one thread per element walking the
// joints through device memory. Block 0's SM cycles (`--phases`, f32): copies
// in 1.5k, sin/cos 0.3k, rotations and base 1.4k, the walk 3.6k (about 520 a
// level), copies out 1.4k. Two variants were slower: 16-byte stores in the
// copies out (6.25 us), and each chain's state kept in one lane's registers
// with the next slot's data loaded before the barrier (the walk 4.4k cycles).
// sincosf keeps its 32-byte stack frame (the slow path for |x| > 1e5, never
// taken for joint angles), and f64 sincos its 40 bytes.
//
// The tables (built by `ops/fkvel.py::_tables`, in level order): `joints`
// holds four ints per joint slot (joint index, parent body, axis code,
// flags), then the level offsets (n_levels + 1: level l is slots
// [off[l], off[l+1])); `geo` holds kGeo values per slot (jR, jp, axis,
// jR axis).

#include <cuda_runtime.h>

#include <cstddef>

#ifdef WBMPC_K2_PHASE_CLOCK
// Phase clock, for `tools/compare_k2.py --phases` only (built with
// -DWBMPC_K2_PHASE_CLOCK): every thread reads clock64() after each block
// barrier and keeps the cycles of each phase in registers; at the end thread 0
// of block 0 adds them to the slots. 0: the copies in; 1: sin and cos; 2: the
// joint rotations and the base body; 3: the tree walk; 4: the copies out
// (issued; their drain to memory is not seen).
__device__ unsigned long long k2_phase_cycles[5];
#define K2_CLOCK_START        \
  long long k2_last_ = clock64(); \
  long long k2_acc_[5] = {}
#define K2_MARK(k)                      \
  {                                     \
    const long long now_ = clock64();   \
    k2_acc_[k] += now_ - k2_last_;      \
    k2_last_ = now_;                    \
  }
#define K2_END                                                                   \
  if (threadIdx.x == 0 && blockIdx.x == 0) {                                     \
    for (int k_ = 0; k_ < 5; ++k_) k2_phase_cycles[k_] += k2_acc_[k_];          \
  }
#else
#define K2_CLOCK_START
#define K2_MARK(k)
#define K2_END
#endif

namespace {

constexpr int kThreads = 32;          // one warp per block, one element per block
constexpr int kGeo = 18;              // per slot: jR (9), jp (3), axis (3), jR axis (3)
constexpr int kJointInts = 4;         // per slot: joint index, parent body, axis code, flags
constexpr int kGeneralAxis = 3;       // axis codes 0, 1, 2: +-x, +-y, +-z
constexpr int kIdentityR = 1;         // flag: joint_R is the identity
constexpr int kNegativeAxis = 2;      // flag: the axis is -x, -y or -z
constexpr size_t kMaxSmem = 232448;   // 227 KB: the most a block may opt in to on sm_90

__host__ __device__ inline int round_up(int n, int a) { return (n + a - 1) / a * a; }

// Offsets, in values of T, of the block's shared arrays; each starts 16-byte aligned.
struct Layout {
  int geo, q, v, sc, M, R, p, vb, ax, E, ints;
  size_t bytes;
};

template <typename T>
__host__ __device__ inline Layout smem_layout(int n_j, int n_levels) {
  const int a = 16 / static_cast<int>(sizeof(T));
  const int nq = n_j + 6, n_b = n_j + 1;
  Layout L;
  int o = 0;
  L.geo = o;
  o += round_up(kGeo * n_j, a);
  L.q = o;
  o += round_up(nq, a);
  L.v = o;
  o += round_up(nq, a);
  L.sc = o;
  o += round_up(2 * (n_j + 3), a);
  L.M = o;
  o += round_up(9 * n_j, a);
  L.R = o;
  o += round_up(9 * n_b, a);
  L.p = o;
  o += round_up(3 * n_b, a);
  L.vb = o;
  o += round_up(12 * n_b, a);
  L.ax = o;
  o += round_up(3 * n_j, a);
  L.E = o;
  o += round_up(9, a);
  L.ints = o;
  L.bytes = static_cast<size_t>(o) * sizeof(T) + (kJointInts * n_j + n_levels + 1) * sizeof(int);
  return L;
}

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

// The Rodrigues matrix of a general unit axis, in the TPU kernel's form
// (I + KK) + s K - c KK with K = skew(axis).
template <typename T>
__device__ __forceinline__ void rodrigues(const T* ax, T s, T c, T* rod) {
  const T K[9] = {T(0), -ax[2], ax[1], ax[2], T(0), -ax[0], -ax[1], ax[0], T(0)};
  T KK[9];
  matmul33(K, K, KK);
#pragma unroll
  for (int i = 0; i < 9; ++i) rod[i] = ((i % 4 == 0 ? T(1) : T(0)) + KK[i]) + s * K[i] - c * KK[i];
}

template <typename T>
__device__ inline void cp_async(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async copies 4 or 8 bytes here");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(static_cast<int>(sizeof(T))));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying n values from device src to shared dst by the whole block,
// one value a copy.
template <typename T>
__device__ __forceinline__ void copy_in(T* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) cp_async(dst + i, src + i);
}

// n values from shared src to device dst by the whole block, neighbouring
// lanes on neighbouring addresses. (16-byte stores, where dst allows them,
// were slower here: tools/compare_k2.py.)
template <typename T>
__device__ __forceinline__ void store_out(T* __restrict__ dst, const T* __restrict__ src, int n) {
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fkvel_kernel(const T* __restrict__ q, const T* __restrict__ v, const int* __restrict__ joints,
                 const T* __restrict__ geo, T gravity, T* __restrict__ R_out,
                 T* __restrict__ p_out, T* __restrict__ vb_out, T* __restrict__ ax_out,
                 T* __restrict__ E_out, int n_j, int n_levels) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L = smem_layout<T>(n_j, n_levels);
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* s_geo = sm + L.geo;
  T* s_q = sm + L.q;
  T* s_v = sm + L.v;
  T* s_sc = sm + L.sc;
  T* s_M = sm + L.M;
  T* s_R = sm + L.R;
  T* s_p = sm + L.p;
  T* s_vb = sm + L.vb;
  T* s_ax = sm + L.ax;
  T* s_E = sm + L.E;
  int* s_jt = reinterpret_cast<int*>(sm + L.ints);
  const int* s_lv = s_jt + kJointInts * n_j;
  const int nq = n_j + 6, n_b = n_j + 1;
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;   // the batch element
  K2_CLOCK_START;

  // ----- 1. the tables and the element's q and v: every copy in flight at once
  // (cp.async), so the block waits for one round trip to memory -----
  copy_in(s_geo, geo, kGeo * n_j);
  copy_in(s_jt, joints, kJointInts * n_j + n_levels + 1);
  copy_in(s_q, q + b * nq, nq);
  copy_in(s_v, v + b * nq, nq);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  K2_MARK(0);

  // ----- 2. sin and cos of every angle, one a lane: angle k is q[3 + k] for the
  // base (k < 3) and joint slot k - 3's q[6 + j] -----
  for (int k = lane; k < n_j + 3; k += kThreads) {
    const int qi = k < 3 ? 3 + k : 6 + s_jt[kJointInts * (k - 3)];
    sin_cos(s_q[qi], &s_sc[2 * k], &s_sc[2 * k + 1]);
  }
  __syncthreads();
  K2_MARK(1);

  // ----- 3. what needs no parent: lane t < n_j the rotation of slot t's joint
  // in its parent, M = jR rot(axis, q), folded by axis code and flags; lane n_j
  // the base body's R, p, v_o, a_o; lane n_j + 1 its E, omega, domega -----
  for (int k = lane; k < n_j + 2; k += kThreads) {
    if (k < n_j) {
      const int* jt = s_jt + kJointInts * k;
      const int code = jt[2], flags = jt[3];
      const T* jR = s_geo + kGeo * k;
      const T c = s_sc[2 * (3 + k) + 1];
      const T s = (flags & kNegativeAxis) ? -s_sc[2 * (3 + k)] : s_sc[2 * (3 + k)];
      T* M = s_M + 9 * k;
      if (code != kGeneralAxis) {
        // jR rot_code: jR's column `code` stays, columns a and c2 (the other
        // two, in cyclic order) turn in their plane: the 2x2 (cos, sin) block,
        // no product with jR (for jR = I, exactly the block)
        const int a = code == 2 ? 0 : code + 1, c2 = code == 0 ? 2 : code - 1;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          M[3 * i + code] = jR[3 * i + code];
          M[3 * i + a] = jR[3 * i + a] * c + jR[3 * i + c2] * s;
          M[3 * i + c2] = jR[3 * i + c2] * c - jR[3 * i + a] * s;
        }
      } else if (flags & kIdentityR) {
        rodrigues(jR + 12, s, c, M);
      } else {
        T rod[9];
        rodrigues(jR + 12, s, c, rod);
        matmul33(jR, rod, M);
      }
    } else if (k == n_j) {
      const T sz = s_sc[0], cz = s_sc[1], sy = s_sc[2], cy = s_sc[3], sx = s_sc[4],
              cx = s_sc[5];
      s_R[0] = cz * cy;
      s_R[1] = cz * sy * sx - sz * cx;
      s_R[2] = cz * sy * cx + sz * sx;
      s_R[3] = sz * cy;
      s_R[4] = sz * sy * sx + cz * cx;
      s_R[5] = sz * sy * cx - cz * sx;
      s_R[6] = -sy;
      s_R[7] = cy * sx;
      s_R[8] = cy * cx;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        s_p[i] = s_q[i];
        s_vb[i] = s_v[i];
      }
      s_vb[6] = T(0);
      s_vb[7] = T(0);
      s_vb[8] = gravity;  // RNEA gravity seed
    } else {
      const T sz = s_sc[0], cz = s_sc[1], sy = s_sc[2], cy = s_sc[3];
      const T tzd = s_v[3], tyd = s_v[4];
      const T Eb[9] = {T(0), -sz, cz * cy, T(0), cz, sz * cy, T(1), T(0), -sy};
      const T dE[9] = {T(0), -cz * tzd, -sz * tzd * cy - cz * sy * tyd,
                       T(0), -sz * tzd, cz * tzd * cy - sz * sy * tyd,
                       T(0), T(0), -cy * tyd};
#pragma unroll
      for (int i = 0; i < 9; ++i) s_E[i] = Eb[i];
      matvec3(Eb, s_v + 3, s_vb + 3);  // omega_0 = E theta_dot
      matvec3(dE, s_v + 3, s_vb + 9);  // domega_0 = dE theta_dot (theta_ddot = 0)
    }
  }
  __syncthreads();
  K2_MARK(2);

  // ----- 4. the tree, level by level, a level's joints over the lanes: each
  // reads its parent's state and writes its child's, in shared memory -----
  int t_begin = s_lv[0];
  for (int l = 0; l < n_levels; ++l) {
    const int t_end = s_lv[l + 1];
    for (int t = t_begin + lane; t < t_end; t += kThreads) {
      const int j = s_jt[kJointInts * t], pb = s_jt[kJointInts * t + 1];
      const T* gj = s_geo + kGeo * t;
      T Rp[9], pp[3], vp[12];
#pragma unroll
      for (int i = 0; i < 9; ++i) Rp[i] = s_R[pb * 9 + i];
#pragma unroll
      for (int i = 0; i < 3; ++i) pp[i] = s_p[pb * 3 + i];
#pragma unroll
      for (int i = 0; i < 12; ++i) vp[i] = s_vb[pb * 12 + i];
      const T* wp = vp + 3;
      const T* ap = vp + 6;
      const T* dwp = vp + 9;
      T Rc[9], r[3], axis_w[3];
      matmul33(Rp, s_M + 9 * t, Rc);
      matvec3(Rp, gj + 9, r);         // jp
      matvec3(Rp, gj + 15, axis_w);   // jR axis
      const T qd = s_v[6 + j];
      T wxr[3], dwxr[3], wxwxr[3], wxa[3];
      cross3(wp, r, wxr);
      cross3(dwp, r, dwxr);
      cross3(wp, wxr, wxwxr);
      cross3(wp, axis_w, wxa);
      const int bc = j + 1;   // child body of joint j
#pragma unroll
      for (int i = 0; i < 9; ++i) s_R[bc * 9 + i] = Rc[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        s_p[bc * 3 + i] = pp[i] + r[i];
        s_vb[bc * 12 + i] = vp[i] + wxr[i];
        s_vb[bc * 12 + 3 + i] = wp[i] + axis_w[i] * qd;
        s_vb[bc * 12 + 6 + i] = ap[i] + dwxr[i] + wxwxr[i];
        s_vb[bc * 12 + 9 + i] = dwp[i] + wxa[i] * qd;
        s_ax[3 * j + i] = axis_w[i];
      }
    }
    t_begin = t_end;
    __syncthreads();
  }
  K2_MARK(3);

  // ----- 5. the element's outputs, each one contiguous range of device memory -----
  store_out(R_out + b * n_b * 9, s_R, n_b * 9);
  store_out(p_out + b * n_b * 3, s_p, n_b * 3);
  store_out(vb_out + b * n_b * 12, s_vb, n_b * 12);
  store_out(ax_out + b * n_j * 3, s_ax, n_j * 3);
  store_out(E_out + b * 9, s_E, 9);
  K2_MARK(4);
  K2_END;
}

template <typename T>
int launch_fkvel(const T* q, const T* v, const int* joints, const T* geo, double gravity, T* R,
                 T* p, T* vb, T* ax, T* E, int B, int n_j, int n_levels, void* stream) {
  if (B <= 0 || n_j <= 0 || n_levels <= 0 || n_levels > n_j) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_layout<T>(n_j, n_levels).bytes;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fkvel_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fkvel_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, v, joints, geo, static_cast<T>(gravity), R, p, vb, ax, E, n_j, n_levels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#ifdef WBMPC_K2_PHASE_CLOCK
// the phase clock's five slots, summed over the launches since the last reset
extern "C" int wbmpc_fkvel_phase_cycles(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k2_phase_cycles, sizeof(k2_phase_cycles));
  if (err == cudaSuccess && reset) {
    const unsigned long long zeros[5] = {};
    err = cudaMemcpyToSymbol(k2_phase_cycles, zeros, sizeof(zeros));
  }
  return static_cast<int>(err);
}
#endif

extern "C" int wbmpc_fkvel_f32(const float* q, const float* v, const int* joints,
                               const float* geo, double gravity, float* R, float* p, float* vb,
                               float* ax, float* E, int B, int n_j, int n_levels, void* stream) {
  return launch_fkvel<float>(q, v, joints, geo, gravity, R, p, vb, ax, E, B, n_j, n_levels,
                             stream);
}

extern "C" int wbmpc_fkvel_f64(const double* q, const double* v, const int* joints,
                               const double* geo, double gravity, double* R, double* p,
                               double* vb, double* ax, double* E, int B, int n_j, int n_levels,
                               void* stream) {
  return launch_fkvel<double>(q, v, joints, geo, gravity, R, p, vb, ax, E, B, n_j, n_levels,
                              stream);
}
