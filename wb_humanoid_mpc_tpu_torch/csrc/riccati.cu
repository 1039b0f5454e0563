// K1: the whole LQ solve of one multiple-shooting problem in one launch: the
// backward Riccati recursion over N stages, then the closed-loop forward
// rollout. One thread block of 512 threads per problem instance; the grid is
// the batch.
//
// Replaces `wb_humanoid_mpc_tpu/ops/riccati.py::_riccati_kernel` (with
// `_gj_solve`), the Pallas TPU kernel behind `pallas_riccati_rollout`.
//
// Convention (see solver/riccati.py of the PyTorch port):
//   dx_{k+1} = A_k dx_k + B_k du_k + d_k
//   stage cost 1/2 dx'Qxx dx + 1/2 du'Quu du + du'Qux dx + qx'dx + qu'du
//   terminal   1/2 dx'QN dx + qN'dx,   du = K dx + k.
//
// What it computes, as `_riccati_kernel` does. Per stage, backwards, with
// M = [B | A | d] (nx x w, w = nu + nx + 1) and the symmetric P:
//   PM = P M + [0 | 0 | p]                                  (P B, P A, P d + p)
//   W  = M'PM + [[Quu, Qux, qu], [Qux', Qxx, qx]]
//      = [[Quu_h, Qux_h, Qu], [Qux_h', Qxx_h, Qx]]           (upper triangle only)
// The stage costs' square blocks enter as (Q + Q')/2, so Quu_h and Qxx_h are
// taken symmetric; Quu_h is damped by reg * max(max diag, 1) on its diagonal
// (the rule of ops/riccati.py:97-103). The upper Cholesky factor of W's first
// nu rows, [Quu_h | Qux_h | Qu] -> [U | Y | y] with U'U = Quu_h, gives
//   K = -U^-1 Y,  k = -U^-1 y   (back substitution),
//   P <- Qxx_h - Y'Y = Qxx_h + Qux_h' K,   p <- Qx - Y'y = Qx + Qux_h' k,
// the Schur complement, symmetric by construction (its upper triangle is
// computed and mirrored). P_N is (QN + QN')/2. The rollout then reads K and k
// back. Every sum is taken in the input type (f32 or f64): no TF32 anywhere.
// `_riccati_kernel`'s docstring allows either this Cholesky route or its
// Gauss-Jordan elimination; the two agree to roundoff.
//
// Bound. At (N, nx, nu) = (28, 58, 21) in f32 the solve does 38.0 MFLOP and
// moves 1.25 MB (`chip_smoke.riccati_work`): 0.567 us at 67 TFLOP/s, the
// card-wide bound. The 28 stages depend on each other and this design runs
// them on one SM, whose share of the peak (67 / 132 = 0.51 TFLOP/s) makes
// 75 us the one-SM floor (105 us at nu = 35, 147 us in f64).
//
// Design (one block, 16 warps, a stage's working set in shared memory):
// 1. Stage data one stage ahead: stage s-1's M is copied into the second of
//    two shared buffers with cp.async while stage s computes. Quu, Qux, Qxx,
//    qu and qx are read from global memory once, their loads issued before
//    the product they join and added to its sum at the end: where B is
//    small beside the input weights the stage cost dwarfs the nx products,
//    and a sum started from it rounds each product at its scale (in float32
//    that puts K five times further from float64 than the plain version on
//    the whole-body LQ, `tests/test_torch_kernel_emulation.py`).
// 2. Register-tiled products: each thread accumulates a 4 x 4 tile of X'Y
//    from 16-byte shared loads: PM = P'M (P symmetric), then only the upper
//    tiles of W = M'PM, then only the upper tiles of Y'Y, mirrored on the
//    write into P.
// 3. No block-wide barrier per pivot. The warps that own one column each of
//    [Quu_h | Qux_h | Qu] run a left-looking Cholesky blocked by four pivots,
//    with one named barrier (`bar.sync 1, n`) among themselves per block;
//    each of them takes the damping's max with shuffles. At the same time
//    two other warps back-substitute the previous stage's K and k (its
//    Cholesky rows sit in a second buffer), and the remaining warps issue the
//    next stage's copy.
// 4. A rollout with one warp per row of [K | k] and of M, lane-strided over
//    the row, rows loaded into registers at the top of each stage and a
//    warp's rows reduced together with interleaved shuffles.
// Shared memory (`make_layout`): 84 KB at (58, 21) in f32, 217 KB at (58, 35)
// in f64, the largest case the port has; a shape beyond 227 KB is refused.
//
// What still holds it back (tools/profile_k1.py, which reads a phase clock
// compiled in with -DWBMPC_K1_PHASE_CLOCK; PERF.md has the numbers). At
// (28, 58, 21) f32 a stage takes about 31k SM cycles, 6x its share of the
// one-SM floor: the two big products (phases 1 and 2) a little over half,
// the blocked Cholesky a third, the P update the rest; the rollout adds
// about an eighth of the launch. The products run at a third of the FMA
// rate: any other memory traffic in the same phase (the stage-cost loads, a
// cp.async copy) slows them, and wider 4 x 8 tiles (fewer loads per FMA,
// half the warps) were slower still. The
// Cholesky is a chain of ceil(nu / 4) dependent blocks (six at nu = 21),
// each a barrier, a dot product over the rows above and a 4 x 4
// factorization. The rollout is bound by how fast one SM pulls each stage's
// 23.5 KB from L2.

#include <cuda_runtime.h>

#ifdef WBMPC_K1_PHASE_CLOCK
// Phase clock, for tools/profile_k1.py only (built with -DWBMPC_K1_PHASE_CLOCK):
// thread 0 of block 0 reads clock64() after each block barrier and adds the
// cycles since its last reading to that phase's slot. 0: the P update of the
// stage before and the wait for this stage's M; 1, 2, 3: phases (1), (2),
// (3); 4: the last P update and stage 0's back substitution; 5: the rollout.
__device__ unsigned long long k1_phase_cycles[6];
#define K1_CLOCK_START long long k1_last_ = clock64()
#define K1_MARK(k)                                                            \
  if (threadIdx.x == 0 && blockIdx.x == 0) {                                  \
    const long long now_ = clock64();                                         \
    k1_phase_cycles[k] += static_cast<unsigned long long>(now_ - k1_last_);   \
    k1_last_ = now_;                                                          \
  }
#define K1_END   \
  __syncthreads(); \
  K1_MARK(5)
#else
#define K1_CLOCK_START
#define K1_MARK(k)
#define K1_END
#endif

namespace {

constexpr int kThreads = 512;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a block may opt in to on sm_90

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

struct Layout {
  int w, wp, ldp;                                  // w = nu + nx + 1; wp, ldp: w, nx + 1 to 4s
  size_t pbuf, chol, pm, mbuf, vec, total;         // element offsets and size
};

__host__ __device__ inline Layout make_layout(int nx, int nu) {
  Layout L;
  L.w = nu + nx + 1;
  L.wp = round_up(L.w, 4);
  L.ldp = round_up(nx + 1, 4);
  const size_t x = static_cast<size_t>(nx), u = static_cast<size_t>(nu);
  const size_t pm = x * L.wp > u * L.ldp ? x * L.wp : u * L.ldp;  // PM, then K, k columns
  L.pbuf = 0;                                      // [P | p]            nx x ldp
  L.chol = L.pbuf + x * L.ldp;                     // [Quu_h|Qux_h|Qu]   2 x nu x wp
  L.pm = L.chol + 2 * u * L.wp;                    // PM                 nx x wp
  L.mbuf = L.pm + pm;                              // M = [B | A | d]    2 x nx x wp
  L.vec = L.mbuf + 2 * x * L.wp;                   // 1/U_ii (2); z, z' = [du | dx | 1]
  L.total = L.vec + 2 * static_cast<size_t>(round_up(nu, 4)) + 2 * static_cast<size_t>(L.wp);
  return L;
}

// ---- small device helpers ----

__device__ inline void ld4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ inline void ld4(const double* p, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <typename T>
__device__ inline void ld4_scalar(const T* p, T (&v)[4]) {
  v[0] = p[0]; v[1] = p[1]; v[2] = p[2]; v[3] = p[3];
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

// a barrier among the first n threads of the block (n a multiple of 32)
__device__ inline void named_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// the warp sums of n values at once, their shuffles interleaved
template <int n, typename T>
__device__ inline void warp_sums(T (&v)[n]) {
  for (int off = kWarp / 2; off > 0; off /= 2) {
#pragma unroll
    for (int j = 0; j < n; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
  }
}

template <typename T>
__device__ inline T warp_max(T v) {
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const T o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// acc[i][j] += sum_m X[m][r0 + i] Y[m][c0 + j], m < depth: a 4 x 4 tile of X'Y.
// Vec: both operand rows are 16-byte aligned at r0 and c0.
template <bool Vec, typename T>
__device__ inline void tile_xty(const T* X, int ldx, const T* Y, int ldy, int depth, int r0,
                                int c0, T (&acc)[4][4]) {
#pragma unroll 2
  for (int m = 0; m < depth; ++m) {
    T a[4], b[4];
    if (Vec) {
      ld4(X + static_cast<size_t>(m) * ldx + r0, a);
      ld4(Y + static_cast<size_t>(m) * ldy + c0, b);
    } else {
      ld4_scalar(X + static_cast<size_t>(m) * ldx + r0, a);
      ld4_scalar(Y + static_cast<size_t>(m) * ldy + c0, b);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
  }
}

// (R, C) of the t-th tile with C >= R, row by row, in a grid of n_cols tile columns
__device__ inline void upper_tile(int t, int n_cols, int& R, int& C) {
  R = 0;
  while (t >= n_cols - R) {
    t -= n_cols - R;
    ++R;
  }
  C = R + t;
}

__device__ inline int upper_tile_count(int n_rows, int n_cols) {
  return n_rows * n_cols - n_rows * (n_rows - 1) / 2;
}

// copy stage s's M = [B | A | d] into dst (nx x wp) with cp.async, a warp per
// row, by the n_warps warps from first_warp on (the caller's among them)
template <typename T>
__device__ inline void load_stage(T* dst, const T* A, const T* B, const T* d, int nx, int nu,
                                  int wp, int first_warp, int n_warps) {
  const int lane = threadIdx.x % kWarp;
  for (int m = threadIdx.x / kWarp - first_warp; m < nx; m += n_warps) {
    T* row = dst + m * wp;
    for (int c = lane; c < nu; c += kWarp) cp_async(row + c, B + m * nu + c);
    for (int c = lane; c < nx; c += kWarp) cp_async(row + nu + c, A + m * nx + c);
    if (lane == 0) cp_async(row + nu + nx, d + m);
  }
}

// the two addresses whose mean is entry (v1, v2), v1 <= v2, of the stage cost
// [[Quu, Qux, qu], [Qux', Qxx, qx]] (the square blocks taken symmetric; other
// entries name one address twice)
template <typename T>
__device__ inline void stage_cost_at(int v1, int v2, const T* Qxx, const T* Quu, const T* Qux,
                                     const T* qx, const T* qu, int nx, int nu, const T*& p1,
                                     const T*& p2) {
  if (v1 < nu) {
    if (v2 < nu) {
      p1 = Quu + v1 * nu + v2;
      p2 = Quu + v2 * nu + v1;
    } else {
      p1 = p2 = v2 < nu + nx ? Qux + v1 * nx + (v2 - nu) : qu + v1;
    }
  } else if (v2 < nu + nx) {
    p1 = Qxx + (v1 - nu) * nx + (v2 - nu);
    p2 = Qxx + (v2 - nu) * nx + (v1 - nu);
  } else {
    p1 = p2 = qx + (v1 - nu);
  }
}

__device__ inline float rsqrt_t(float x) { return rsqrtf(x); }
__device__ inline double rsqrt_t(double x) { return rsqrt(x); }

// pivots per step of the blocked Cholesky and back substitution
constexpr int kPiv = 4;

// The upper Cholesky factor of the nu rows [Quu_h | Qux_h | Qu] in Ch (upper
// triangle), damped by damp on the diagonal: Ch's rows become [U | Y | y]
// with 1/U_ii in invd, and U's diagonal is not stored. Left-looking and
// blocked by kPiv rows: a thread per column c (every column < w has one),
// one named barrier among the n_sync threads per block. Each thread factors
// the kPiv x kPiv diagonal block itself, from the rows above it, and solves
// its column's kPiv entries. The owner of a diagonal-block column writes its
// entries one block late, after the others have read them.
template <typename T>
__device__ inline void cholesky_rows(T* Ch, T* invd, int wp, int nu, int w, T damp, int c,
                                     int n_sync) {
  T pend[kPiv];
  int pend_j0 = 0, pend_n = 0;
  for (int j0 = 0; j0 < nu; j0 += kPiv) {
    named_sync(n_sync);   // the rows above j0 are final
#pragma unroll
    for (int a = 0; a < kPiv; ++a) {
      if (a < pend_n) Ch[(pend_j0 + a) * wp + c] = pend[a];
    }
    pend_n = 0;
    if (c < j0 || c >= w) continue;
    const int bs = nu - j0 < kPiv ? nu - j0 : kPiv;
    T G[kPiv][kPiv], S[kPiv];   // the block's rows and column c, less the rows above
#pragma unroll
    for (int a = 0; a < kPiv; ++a) {
      S[a] = T(0);
#pragma unroll
      for (int b = 0; b < kPiv; ++b) G[a][b] = T(0);
    }
#pragma unroll 4
    for (int l = 0; l < j0; ++l) {
      T u[kPiv];
      ld4(Ch + l * wp + j0, u);   // row l, the block's columns (16-byte aligned)
      const T v = Ch[l * wp + c];
#pragma unroll
      for (int a = 0; a < kPiv; ++a) {
        S[a] -= u[a] * v;
#pragma unroll
        for (int b = a; b < kPiv; ++b) G[a][b] -= u[a] * u[b];
      }
    }
    T R[kPiv][kPiv], inv[kPiv];   // the block's factor, above its diagonal; 1 / diagonal
#pragma unroll
    for (int a = 0; a < kPiv; ++a) {
      if (a >= bs) break;
      T dd = G[a][a] + Ch[(j0 + a) * wp + j0 + a] + damp;
#pragma unroll
      for (int k = 0; k < a; ++k) dd -= R[k][a] * R[k][a];
      inv[a] = rsqrt_t(dd);
#pragma unroll
      for (int b = a + 1; b < kPiv; ++b) {
        if (b >= bs) break;
        T x = G[a][b] + Ch[(j0 + a) * wp + j0 + b];
#pragma unroll
        for (int k = 0; k < a; ++k) x -= R[k][a] * R[k][b];
        R[a][b] = x * inv[a];
      }
    }
    const int cb = c - j0;
    if (cb < bs) {   // a column of the diagonal block
#pragma unroll
      for (int b = 0; b < kPiv; ++b) {
        if (b != cb) continue;
        invd[c] = inv[b];
#pragma unroll
        for (int a = 0; a < b; ++a) pend[a] = R[a][b];
      }
      pend_j0 = j0;
      pend_n = cb;
    } else {
      T x[kPiv];
#pragma unroll
      for (int a = 0; a < kPiv; ++a) {
        if (a >= bs) break;
        T y = S[a] + Ch[(j0 + a) * wp + c];
#pragma unroll
        for (int k = 0; k < a; ++k) y -= R[k][a] * x[k];
        x[a] = y * inv[a];
        Ch[(j0 + a) * wp + c] = x[a];
      }
    }
  }
  named_sync(n_sync);   // the last block's diagonal entries were read
#pragma unroll
  for (int a = 0; a < kPiv; ++a) {
    if (a < pend_n) Ch[(pend_j0 + a) * wp + c] = pend[a];
  }
}

// K = -U^-1 Y, k = -U^-1 y for one stage, from its Cholesky rows Ch = [U | Y | y]
// and invd = 1/U_ii: back substitution by blocks of kPiv rows from the bottom,
// a thread per column of [Y | y] (thread t of n_threads), each solution
// column kept in X (nu x ldp)
template <typename T>
__device__ inline void back_substitute(const T* Ch, const T* invd, T* X, T* Ks, T* ks, int nx,
                                       int nu, int wp, int ldp, int t, int n_threads) {
  for (int c = t; c <= nx; c += n_threads) {
    for (int j1 = nu; j1 > 0; j1 -= kPiv) {
      const int j0 = j1 > kPiv ? j1 - kPiv : 0;
      const int bs = j1 - j0;
      T S[kPiv];
#pragma unroll
      for (int a = 0; a < kPiv; ++a) S[a] = a < bs ? Ch[(j0 + a) * wp + nu + c] : T(0);
#pragma unroll 4
      for (int l = j1; l < nu; ++l) {
        const T xl = X[l * ldp + c];
#pragma unroll
        for (int a = 0; a < kPiv; ++a) {
          if (a < bs) S[a] -= Ch[(j0 + a) * wp + l] * xl;
        }
      }
      T x[kPiv];
#pragma unroll
      for (int a = kPiv - 1; a >= 0; --a) {
        if (a >= bs) continue;
        T y = S[a];
#pragma unroll
        for (int b = a + 1; b < kPiv; ++b) {
          if (b < bs) y -= Ch[(j0 + a) * wp + j0 + b] * x[b];
        }
        x[a] = y * invd[j0 + a];
        X[(j0 + a) * ldp + c] = x[a];
        if (c < nx) {
          Ks[(j0 + a) * nx + c] = -x[a];
        } else {
          ks[j0 + a] = -x[a];
        }
      }
    }
  }
}

// rows of [K | k] and of M that one warp holds in registers in the rollout
// (3 x 2 and 4 x 3 values a lane: nu <= 48, nx <= 63, w <= 96); rows and
// columns beyond are read from global memory where they are used
constexpr int kRowsK = 3, kColsK = 2, kRowsM = 4, kColsM = 3;

template <typename T>
__device__ inline T stage_m(const T* A, const T* B, const T* d, int s, int r, int c, int nx,
                            int nu) {
  const size_t nxx = static_cast<size_t>(nx) * nx, nxu = static_cast<size_t>(nx) * nu;
  if (c < nu) return B[s * nxu + r * nu + c];
  if (c < nu + nx) return A[s * nxx + r * nx + (c - nu)];
  return d[static_cast<size_t>(s) * nx + r];
}

template <typename T>
__device__ inline T stage_k(const T* K, const T* k, int s, int i, int c, int nx, int nu) {
  const size_t nxu = static_cast<size_t>(nx) * nu;
  return c < nx ? K[s * nxu + i * nx + c] : k[static_cast<size_t>(s) * nu + i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    riccati_rollout_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                           const T* __restrict__ d, const T* __restrict__ Qxx,
                           const T* __restrict__ Quu, const T* __restrict__ Qux,
                           const T* __restrict__ qx, const T* __restrict__ qu,
                           const T* __restrict__ QN, const T* __restrict__ qN,
                           const T* __restrict__ dx0, T* __restrict__ K, T* __restrict__ k,
                           T* __restrict__ dxs, T* __restrict__ dus, int N, int nx, int nu,
                           T reg) {
  const size_t inst = blockIdx.x;
  const size_t nxx = static_cast<size_t>(nx) * nx, nxu = static_cast<size_t>(nx) * nu;
  const size_t nuu = static_cast<size_t>(nu) * nu;
  A += inst * N * nxx;
  Bm += inst * N * nxu;
  d += inst * N * nx;
  Qxx += inst * N * nxx;
  Quu += inst * N * nuu;
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

  const Layout L = make_layout(nx, nu);
  const int w = L.w, wp = L.wp, ldp = L.ldp;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* Pb = sm + L.pbuf;     // [P | p]: P full and symmetric, p in column nx
  T* C0 = sm + L.chol;     // [Quu_h | Qux_h | Qu] (upper), then [U | Y | y]: two buffers,
  T* C1 = C0 + static_cast<size_t>(nu) * wp;   // one per stage in turn
  T* PM = sm + L.pm;       // P M + [0 | 0 | p]; then the back substitution's columns
  T* M0 = sm + L.mbuf;     // M = [B | A | d], two buffers
  T* M1 = M0 + static_cast<size_t>(nx) * wp;
  T* D0 = sm + L.vec;      // 1 / U_ii, one buffer per Cholesky buffer
  T* D1 = D0 + round_up(nu, 4);
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  K1_CLOCK_START;
  // Roles in the elimination phase: warps [0, e_warps) eliminate, a thread per
  // column of [Quu_h | Qux_h | Qu]; the next b_warps back-substitute the stage
  // before, a thread per column of [K | k]; the other c_warps (at least one,
  // see launch_riccati) copy in the next stage's M.
  const int e_warps = round_up(w, kWarp) / kWarp, n_elim = e_warps * kWarp;
  const int b_warps = round_up(nx + 1, kWarp) / kWarp;
  const int c_warps = kWarps - e_warps - b_warps;

  load_stage(M0, A + (N - 1) * nxx, Bm + (N - 1) * nxu, d + static_cast<size_t>(N - 1) * nx,
             nx, nu, wp, 0, kWarps);
  cp_async_commit();
  for (int e = tid; e < nx * nx; e += kThreads) {
    const int r = e / nx, c = e - r * nx;
    Pb[r * ldp + c] = T(0.5) * (QN[r * nx + c] + QN[c * nx + r]);
  }
  for (int r = tid; r < nx; r += kThreads) Pb[r * ldp + nx] = qN[r];

  // ---- backward Riccati recursion ----
  for (int t = 0; t < N; ++t) {
    const int s = N - 1 - t;
    const T* Mc = (t & 1) ? M1 : M0;
    T* Ch = (t & 1) ? C1 : C0;       // this stage's Cholesky rows
    T* invd = (t & 1) ? D1 : D0;
    cp_async_wait_all();
    __syncthreads();   // this stage's M has landed; the last stage's P update is done
    K1_MARK(0);

    // (1) PM = P'M + [0 | 0 | p]   (P symmetric: P'M = P [B | A | d])
    {
      const int n_cols = wp / 4, n_tiles = round_up(nx, 4) / 4 * n_cols;
      for (int tt = tid; tt < n_tiles; tt += kThreads) {
        const int r0 = tt / n_cols * 4, c0 = tt % n_cols * 4;
        T acc[4][4] = {};
        tile_xty<true>(Pb, ldp, Mc, wp, nx, r0, c0, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + i;
          if (r >= nx) break;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            PM[r * wp + c0 + j] = acc[i][j] + (c0 + j == w - 1 ? Pb[r * ldp + nx] : T(0));
          }
        }
      }
    }
    __syncthreads();
    K1_MARK(1);

    // (2) W = M'PM + stage cost, upper tiles only: rows < nu into Ch, the rest
    //     ([Qxx_h | Qx]) into Pb, whose P was last read in (1)
    {
      const T* Qxxs = Qxx + s * nxx;
      const T* Quus = Quu + s * nuu;
      const T* Quxs = Qux + s * nxu;
      const T* qxs = qx + static_cast<size_t>(s) * nx;
      const T* qus = qu + static_cast<size_t>(s) * nu;
      const int n_rows = round_up(nu + nx, 4) / 4, n_cols = wp / 4;
      const int n_tiles = upper_tile_count(n_rows, n_cols);
      for (int tt = tid; tt < n_tiles; tt += kThreads) {
        int R, C;
        upper_tile(tt, n_cols, R, C);
        const int r0 = 4 * R, c0 = 4 * C;
        // the stage cost's 32 loads go out together, before the product;
        // its sum starts from zero, and the cost joins it at the end
        T q1[4][4], q2[4][4], acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int v1 = r0 + i, v2 = c0 + j;
            const T* p1 = qus;
            const T* p2 = qus;
            if (v1 < nu + nx && v2 < w && v2 >= v1) {
              stage_cost_at(v1, v2, Qxxs, Quus, Quxs, qxs, qus, nx, nu, p1, p2);
            }
            q1[i][j] = *p1;
            q2[i][j] = *p2;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            q1[i][j] = T(0.5) * (q1[i][j] + q2[i][j]);
            acc[i][j] = T(0);
          }
        }
        tile_xty<true>(Mc, wp, PM, wp, nx, r0, c0, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int v1 = r0 + i, v2 = c0 + j;
            if (v1 >= nu + nx || v2 >= w || v2 < v1) continue;
            const T val = acc[i][j] + q1[i][j];
            if (v1 < nu) {
              Ch[v1 * wp + v2] = val;
            } else {
              Pb[(v1 - nu) * ldp + (v2 - nu)] = val;
            }
          }
        }
      }
    }
    __syncthreads();
    K1_MARK(2);

    // (3) Three roles side by side.
    if (warp < e_warps) {
      // Damping (every eliminating warp takes the max itself), then the
      // Cholesky of [Quu_h | Qux_h | Qu]
      T mx = Ch[0];
      for (int i = lane; i < nu; i += kWarp) mx = Ch[i * wp + i] > mx ? Ch[i * wp + i] : mx;
      mx = warp_max(mx);
      cholesky_rows(Ch, invd, wp, nu, w, reg * (mx > T(1) ? mx : T(1)), tid, n_elim);
    } else if (warp < e_warps + b_warps) {
      // K, k of the stage before (s + 1), from its Cholesky buffer
      if (t > 0) {
        back_substitute((t & 1) ? C0 : C1, (t & 1) ? D0 : D1, PM, K + (s + 1) * nxu,
                        k + static_cast<size_t>(s + 1) * nu, nx, nu, wp, ldp,
                        tid - n_elim, b_warps * kWarp);
      }
    } else if (s > 0) {
      load_stage((t & 1) ? M0 : M1, A + (s - 1) * nxx, Bm + (s - 1) * nxu,
                 d + static_cast<size_t>(s - 1) * nx, nx, nu, wp, e_warps + b_warps, c_warps);
      cp_async_commit();
    }
    __syncthreads();
    K1_MARK(3);

    // (4) [P | p] <- [Qxx_h | Qx] - Y'[Y | y], upper tiles, mirrored into the
    //     lower triangle of P
    {
      const int n_rows = round_up(nx, 4) / 4, n_cols = round_up(nx + 1, 4) / 4;
      const int n_tiles = upper_tile_count(n_rows, n_cols);
      for (int tt = tid; tt < n_tiles; tt += kThreads) {
        int R, C;
        upper_tile(tt, n_cols, R, C);
        const int r0 = 4 * R, c0 = 4 * C;
        T acc[4][4] = {};
        tile_xty<false>(Ch + nu, wp, Ch + nu, wp, nu, r0, c0, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = r0 + i, c = c0 + j;
            if (r >= nx || c > nx || c < r) continue;
            const T val = Pb[r * ldp + c] - acc[i][j];
            Pb[r * ldp + c] = val;
            if (c < nx && c != r) Pb[c * ldp + r] = val;
          }
        }
      }
    }
  }
  // K, k of stage 0
  if (tid < b_warps * kWarp) {
    back_substitute(((N - 1) & 1) ? C1 : C0, ((N - 1) & 1) ? D1 : D0, PM, K, k, nx, nu, wp, ldp,
                    tid, b_warps * kWarp);
  }
  __syncthreads();   // every K, k written
  K1_MARK(4);

  // ---- forward rollout of the closed loop ----
  // z = [du | dx | 1], so that du = [K | k] z[nu:] and dx_next = M z. Each warp
  // loads its rows of stage s's [K | k] and M into registers at the top of
  // the stage, all at once, and reduces its rows together.
  T* z = D0 + 2 * round_up(nu, 4);
  T* zn = z + wp;
  for (int r = tid; r < nx; r += kThreads) {
    z[nu + r] = dx0[r];
    dxs[r] = dx0[r];
  }
  if (tid == 0) {
    z[nu + nx] = T(1);
    zn[nu + nx] = T(1);
  }
  __syncthreads();
  for (int s = 0; s < N; ++s) {
    T mreg[kRowsM][kColsM], kreg[kRowsK][kColsK];
#pragma unroll
    for (int j = 0; j < kRowsK; ++j) {
#pragma unroll
      for (int q = 0; q < kColsK; ++q) {
        const int i = warp + kWarps * j, c = lane + kWarp * q;
        kreg[j][q] = (i < nu && c <= nx) ? stage_k(K, k, s, i, c, nx, nu) : T(0);
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsM; ++j) {
#pragma unroll
      for (int q = 0; q < kColsM; ++q) {
        const int r = warp + kWarps * j, c = lane + kWarp * q;
        mreg[j][q] = (r < nx && c < w) ? stage_m(A, Bm, d, s, r, c, nx, nu) : T(0);
      }
    }
    // du = [K | k] [dx; 1]: one warp per row
    {
      T acc[kRowsK];
#pragma unroll
      for (int j = 0; j < kRowsK; ++j) {
        const int i = warp + kWarps * j;
        acc[j] = T(0);
#pragma unroll
        for (int q = 0; q < kColsK; ++q) {
          const int c = lane + kWarp * q;
          acc[j] += kreg[j][q] * z[nu + (c <= nx ? c : 0)];
        }
        if (i < nu) {
          for (int c = lane + kWarp * kColsK; c <= nx; c += kWarp) {
            acc[j] += stage_k(K, k, s, i, c, nx, nu) * z[nu + c];
          }
        }
      }
      warp_sums(acc);
#pragma unroll
      for (int j = 0; j < kRowsK; ++j) {
        const int i = warp + kWarps * j;
        if (lane == 0 && i < nu) {
          z[i] = acc[j];
          dus[static_cast<size_t>(s) * nu + i] = acc[j];
        }
      }
    }
    for (int i0 = warp + kWarps * kRowsK; i0 < nu; i0 += kWarps * kRowsK) {
      T acc[kRowsK];
#pragma unroll
      for (int j = 0; j < kRowsK; ++j) {
        const int i = i0 + kWarps * j;
        acc[j] = T(0);
        if (i < nu) {
          for (int c = lane; c <= nx; c += kWarp) acc[j] += stage_k(K, k, s, i, c, nx, nu) * z[nu + c];
        }
      }
      warp_sums(acc);
#pragma unroll
      for (int j = 0; j < kRowsK; ++j) {
        const int i = i0 + kWarps * j;
        if (lane == 0 && i < nu) {
          z[i] = acc[j];
          dus[static_cast<size_t>(s) * nu + i] = acc[j];
        }
      }
    }
    __syncthreads();
    // dx_next = [B | A | d] [du; dx; 1]: one warp per row
    {
      T acc[kRowsM];
#pragma unroll
      for (int j = 0; j < kRowsM; ++j) {
        const int r = warp + kWarps * j;
        acc[j] = T(0);
#pragma unroll
        for (int q = 0; q < kColsM; ++q) {
          const int c = lane + kWarp * q;
          acc[j] += mreg[j][q] * z[c < w ? c : 0];
        }
        if (r < nx) {
          for (int c = lane + kWarp * kColsM; c < w; c += kWarp) {
            acc[j] += stage_m(A, Bm, d, s, r, c, nx, nu) * z[c];
          }
        }
      }
      warp_sums(acc);
#pragma unroll
      for (int j = 0; j < kRowsM; ++j) {
        const int r = warp + kWarps * j;
        if (lane == 0 && r < nx) {
          zn[nu + r] = acc[j];
          dxs[static_cast<size_t>(s + 1) * nx + r] = acc[j];
        }
      }
    }
    for (int r0 = warp + kWarps * kRowsM; r0 < nx; r0 += kWarps * kRowsM) {
      T acc[kRowsM];
#pragma unroll
      for (int j = 0; j < kRowsM; ++j) {
        const int r = r0 + kWarps * j;
        acc[j] = T(0);
        if (r < nx) {
          for (int c = lane; c < w; c += kWarp) acc[j] += stage_m(A, Bm, d, s, r, c, nx, nu) * z[c];
        }
      }
      warp_sums(acc);
#pragma unroll
      for (int j = 0; j < kRowsM; ++j) {
        const int r = r0 + kWarps * j;
        if (lane == 0 && r < nx) {
          zn[nu + r] = acc[j];
          dxs[static_cast<size_t>(s + 1) * nx + r] = acc[j];
        }
      }
    }
    __syncthreads();
    T* tmp = z;
    z = zn;
    zn = tmp;
  }
  K1_END;
}

template <typename T>
int launch_riccati(const T* A, const T* B, const T* d, const T* Qxx, const T* Quu, const T* Qux,
                   const T* qx, const T* qu, const T* QN, const T* qN, const T* dx0, T* K, T* k,
                   T* dxs, T* dus, int batch, int N, int nx, int nu, double reg, void* stream) {
  if (batch <= 0 || N <= 0 || nx <= 0 || nu <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = make_layout(nx, nu).total * sizeof(T);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // the elimination phase's three roles (see the kernel) need a warp each at
  // least; every shape that fits in shared memory leaves seven or more for the copy
  if (round_up(nu + nx + 1, kWarp) + round_up(nx + 1, kWarp) > kThreads - kWarp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  return make_layout(nx, nu).total * static_cast<size_t>(elem_size);
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

#ifdef WBMPC_K1_PHASE_CLOCK
// the phase clock's six slots, summed over the launches since the last reset
extern "C" int wbmpc_riccati_phase_cycles(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k1_phase_cycles, sizeof(k1_phase_cycles));
  if (err == cudaSuccess && reset) {
    const unsigned long long zeros[6] = {};
    err = cudaMemcpyToSymbol(k1_phase_cycles, zeros, sizeof(zeros));
  }
  return static_cast<int>(err);
}
#endif

extern "C" const char* wbmpc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
