// K3: the closed-loop linear forward rollout of the LQ subproblem in one
// launch, given the Riccati gains:
//   du_k = K_k dx_k + k_k,   dx_{k+1} = A_k dx_k + B_k du_k + d_k,
// returning dxs [N+1, nx] and dus [N, nu]. One thread-block cluster of C
// CTAs per problem instance; the grid is batch x C.
//
// Replaces `wb_humanoid_mpc_tpu/ops/rollout.py::_rollout_kernel`, the Pallas
// TPU kernel behind `pallas_forward_rollout`.
//
// Bound. The rollout reads each stage's A, B, d, K, k once and writes dxs and
// dus once: at (N, nx, nu) = (28, 58, 35) in f32 that is 213,196 values
// (852.8 KB), 0.255 us at 3.35 TB/s, against about 0.42 MFLOP (6 ns at
// 67 TFLOP/s): bytes bound on paper. In practice it is bound by the chain:
// N dependent stages, each some dependent shared-memory loads, shuffles and
// block barriers. The first design (one 1024-thread block streaming every
// stage from global memory, about 103 us at that shape on an H100) drew all
// 852.8 KB through one SM, which takes 5-16 B/cycle from L2.
//
// Design. The stages are cut into C <= min(8, N) contiguous ranges, rank r of
// the cluster owning stages [r N / C, (r + 1) N / C), at least one each. At
// entry lane 0 of warp i of each CTA issues its stage i: one bulk (TMA) copy
// per array (A, B, K, d, k) into the stage's slot of shared memory, the few
// bytes at either end that are not 16-byte aligned by 4- or 8-byte cp.async,
// all completing on the stage's own mbarrier. So C SMs load at once, and the stage matrices never leave the SM
// that loaded them. A range longer than the slots that fit in 227 KB streams
// through a ring: stage i + S is copied into stage i's slot once stage i is
// walked.
//
// Rank r > 0 waits on a second mbarrier until rank r - 1 has walked its range
// and written dx (nx values) into rank r's shared memory through distributed
// shared memory, each lane of its warp 0 arriving on that mbarrier with
// release semantics at cluster scope; only the nx-vector crosses SMs. Before
// it waits, it folds the closed loops of the first stages in its slots in
// place, A <- A + B K and d <- d + B k (a 4 x 4 register tile a thread): at
// most s0 - 1 of them, s0 being the stages before its range, whose walk is
// all the time it has. A folded stage is then one pass on the chain, dx' =
// A dx + d, with du = K dx + k in the same pass; a stage not folded (rank
// 0's, those past that count or streamed in later by a ring) takes two, du =
// K dx + k, then dx' = A dx + B du + d, in the order of the Pallas kernel.
// Which stages are folded depends on the plan alone, never on when dx comes,
// so a launch's result is bit-reproducible. A pass
// gives kGroup threads to a row (four strided partial sums each, then xor
// shuffles) and ends with a block barrier. The fold rounds otherwise than the
// Pallas kernel; both stay within its tolerances (tests, chip_smoke.py).
// Each rank keeps the dx and du of its stages in shared memory and writes
// them out, coalesced, after its hand-off; the last rank also writes dxs[N].
// A cluster barrier after the mbarrier init (before any remote arrive) and
// one at the end (no CTA exits while a peer may still write into its shared
// memory) close it. Sums are taken in the input type (f32 or f64); there is
// no TF32 and no tensor core anywhere.
//
// Measured (tools/compare_k3.py on an H100 80GB HBM3 at 700 W; the times are
// in PERF.md): about a third of the first design's time at (28, 58, 35) f32,
// and far above the launch floor of an empty kernel of the same cluster grid.
// A walked stage costs about 1.5k SM cycles folded and 2.7k not, and a
// hand-off about 0.5 us (`--phases`): the chain, not the bytes, bounds it.
//
// An mbarrier wait that lasts kWaitLimitNs (10 s of the global timer) can
// only be a fault of the kernel: it traps rather than hangs the card. A trap
// is a sticky launch failure: the CUDA context is unusable afterwards, and
// every later CUDA call of the process fails.
//
// The card-only primitives (cluster rank, the DSMEM mapping, the mbarriers,
// the cluster barrier, the bulk and async copies, the cluster launch) sit in
// one marked block below, which tests/test_torch_kernel_emulation_rollout.py
// replaces by name to run this source on the CPU.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 384;                       // a pass covers nx + nu <= 96 rows
constexpr int kWarp = 32;
constexpr int kGroup = 4;                           // threads summing one row
constexpr int kRowsPerPass = kThreads / kGroup;
constexpr int kMaxCluster = 8;                      // the portable maximum
constexpr size_t kMinCtaBytes = 16384;              // the plan gives no CTA less stage data
constexpr size_t kMaxSmem = 232448;                 // 227 KB: a block's opt-in maximum on sm_90
constexpr int kArrays = 5;                          // A, B, K, d, k
constexpr unsigned long long kWaitLimitNs = 10000000000ull;   // an mbarrier wait past this traps

__host__ __device__ inline int round_up(int n, int a) { return (n + a - 1) / a * a; }

#ifdef WBMPC_K3_PHASE_CLOCK
// Phase clock, for `tools/compare_k3.py --phases` only (built with
// -DWBMPC_K3_PHASE_CLOCK): thread 0 of each CTA of the first cluster reads
// clock64() at each mark and adds the SM cycles of each phase to its rank's
// slots: 0 the mbarrier init and the copies issued; 1 the folds before the
// hand-off and its wait (or dx0's load); 2 the waits for stages not folded;
// 3 the walk's passes; 4 the ring's refills issued; 5 the hand-off sent;
// 6 the outputs and the closing cluster barrier. It also keeps, from the last
// launch, the global timer (ns) at its entry, at the start and at the end of
// its walk (the timer's reads are left out of the phases).
__device__ unsigned long long k3_phase_cycles[kMaxCluster][7];
__device__ unsigned long long k3_phase_ns[kMaxCluster][3];
#define K3_CLOCK_START                                                        \
  unsigned long long k3_ns_[3] = {globaltimer_ns(), 0, 0};                    \
  long long k3_last_ = clock64();                                             \
  long long k3_acc_[7] = {}
#define K3_MARK(k)                    \
  {                                   \
    const long long now_ = clock64(); \
    k3_acc_[k] += now_ - k3_last_;    \
    k3_last_ = now_;                  \
  }
#define K3_STAMP(j)              \
  {                              \
    k3_ns_[j] = globaltimer_ns(); \
    k3_last_ = clock64();        \
  }
#define K3_CLOCK_END                                                          \
  if (threadIdx.x == 0 && blockIdx.x < static_cast<unsigned>(n_ranks)) {     \
    for (int k_ = 0; k_ < 7; ++k_) k3_phase_cycles[rank][k_] += k3_acc_[k_];  \
    for (int j_ = 0; j_ < 3; ++j_) k3_phase_ns[rank][j_] = k3_ns_[j_];        \
  }
#else
#define K3_CLOCK_START
#define K3_MARK(k)
#define K3_STAMP(j)
#define K3_CLOCK_END
#endif

// Offsets, in values of T, of the CTA's shared arrays; each starts 16-byte aligned.
// [mbarriers: the hand-off's and one per slot | xa (nx) | its stages' dx (most nx) and
//  du (most nu) | S slots of (A, B, K, d, k)]; `most` is the longest range of stages a
// rank owns. In a slot each array has 16 bytes of room, for it starts at the offset
// mod 16 that it has in global memory (the bulk copies move 16-byte-aligned blocks).
struct Layout {
  int xa;                    // dx after the CTA's last stage
  int ox, ou;                // dx and du at each of the CTA's stages, written out after its walk
  int arr[kArrays], slot;    // offsets of the arrays inside a slot, and a slot's length
  int slots;                 // where the slots start
  int total;
};

template <typename T>
__host__ __device__ inline Layout smem_layout(int nx, int nu, int n_slots, int most) {
  const int a = 16 / static_cast<int>(sizeof(T));
  const int lens[kArrays] = {nx * nx, nx * nu, nu * nx, nx, nu};
  Layout L;
  L.xa = round_up((1 + n_slots) * 8, 16) / static_cast<int>(sizeof(T));   // after the mbarriers
  L.ox = L.xa + round_up(nx, a);
  L.ou = L.ox + round_up(most * nx, a);
  L.slots = L.ou + round_up(most * nu, a);
  int off = 0;
  for (int i = 0; i < kArrays; ++i) {
    L.arr[i] = off;
    off += round_up(lens[i], a) + a;
  }
  L.slot = off;
  L.total = L.slots + n_slots * L.slot;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    forward_rollout_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                           const T* __restrict__ d, const T* __restrict__ K,
                           const T* __restrict__ k, const T* __restrict__ dx0,
                           T* __restrict__ dxs, T* __restrict__ dus, int N, int nx, int nu,
                           int n_ranks, int n_slots);

// ---- card-only primitives (replaced by name in the CPU emulation test) ----

// this CTA's rank in its cluster
__device__ inline unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the address of *p in the shared memory of the cluster's CTA `rank`
template <typename T>
__device__ inline T* peer_shared(T* p, unsigned rank) {
  unsigned long long out;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(p), "r"(rank));
  return reinterpret_cast<T*>(out);
}

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// one thread: an mbarrier expecting `count` arrivals; then, after the last
// init, make them visible to the cluster
__device__ inline void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ inline void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive on the mbarrier at bar's offset in CTA `rank`, releasing this
// thread's earlier writes (into that CTA's shared memory) at cluster scope
__device__ inline void mbar_arrive_peer(unsigned long long* bar, unsigned rank) {
  asm volatile(
      "{\n .reg .b32 remote;\n mapa.shared::cluster.u32 remote, %0, %1;\n"
      " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// arrive on a local mbarrier and expect `bytes` more of bulk copies in this phase
__device__ inline void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// the card's global timer, in ns
__device__ inline unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// wait until the mbarrier's phase `phase` has completed, with acquire
// semantics at CTA scope (Cluster: at cluster scope, for a peer's writes); a
// wait past kWaitLimitNs traps (see the header), not a hang
#define WBMPC_MBAR_WAIT(name, scope)                                                    \
  __device__ inline void name(unsigned long long* bar, unsigned phase) {                \
    unsigned long long since = 0;                                                       \
    for (;;) {                                                                          \
      unsigned done;                                                                    \
      asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire." scope        \
                   ".shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"         \
                   : "=r"(done)                                                         \
                   : "r"(smem_addr(bar)), "r"(phase)                                    \
                   : "memory");                                                         \
      if (done) return;                                                                 \
      const unsigned long long now = globaltimer_ns();                                  \
      if (since == 0) since = now;                                                      \
      else if (now - since > kWaitLimitNs) __trap();                                    \
    }                                                                                   \
  }
WBMPC_MBAR_WAIT(mbar_wait, "cta")
WBMPC_MBAR_WAIT(mbar_wait_cluster, "cluster")
#undef WBMPC_MBAR_WAIT

// the two halves of a cluster barrier, every thread: the arrive orders
// nothing (the mbarrier init has its own fence, a hand-off its own release),
// the wait acquires
__device__ inline void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ inline void cluster_wait() { asm volatile("barrier.cluster.wait;\n" ::: "memory"); }

// a bulk (TMA) copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to this CTA's shared memory, completing on `bar`
__device__ inline void bulk_copy(void* dst, const void* src, unsigned bytes,
                                 unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename T>
__device__ inline void cp_async(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async copies 4 or 8 bytes here");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"(static_cast<int>(sizeof(T))));
}

// arrive on `bar` once this thread's cp.async copies so far have landed (the
// arrival is counted in the barrier's init count)
__device__ inline void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// order this thread's earlier generic accesses to shared memory before its
// later bulk copies into it (a ring slot is refilled after it was read)
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the kernel's attribute for `smem` bytes of shared memory
template <typename T>
cudaError_t prepare_kernel(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(forward_rollout_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int n_clusters, int n_ranks,
                                         size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_clusters * n_ranks), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(n_ranks);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// how many clusters of this shape the card can hold at once (0: none)
template <typename T>
cudaError_t max_active_clusters(int n_ranks, size_t smem, int* out) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, 1, n_ranks, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(out, forward_rollout_kernel<T>, &cfg);
}

template <typename T>
cudaError_t launch_clusters(int n_clusters, int n_ranks, size_t smem, cudaStream_t stream,
                            const T* A, const T* B, const T* d, const T* K, const T* k,
                            const T* dx0, T* dxs, T* dus, int N, int nx, int nu, int n_slots) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, n_clusters, n_ranks, smem, stream);
  return cudaLaunchKernelEx(&cfg, forward_rollout_kernel<T>, A, B, d, K, k, dx0, dxs, dus, N,
                            nx, nu, n_ranks, n_slots);
}

// ---- end of card-only primitives ----

template <typename T>
__device__ inline T group_sum(T v) {
  for (int off = kGroup / 2; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the values of T an array starts into its slot region: its address mod 16
template <typename T>
__device__ inline int lead_of(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

// one thread: copy stage s's arrays into `slot`, completing on `full`: the
// 16-byte-aligned middle of each array by one bulk copy, the ends by cp.async
template <typename T>
__device__ inline void issue_stage(T* slot, unsigned long long* full, const Layout& L,
                                   const T* const (&src)[kArrays], const int (&len)[kArrays]) {
  unsigned tx = 0;
  uintptr_t lo[kArrays], hi[kArrays];
#pragma unroll
  for (int a = 0; a < kArrays; ++a) {
    const uintptr_t g = reinterpret_cast<uintptr_t>(src[a]), end = g + len[a] * sizeof(T);
    lo[a] = (g + 15) & ~uintptr_t(15);
    hi[a] = end & ~uintptr_t(15);
    if (hi[a] <= lo[a]) lo[a] = hi[a] = end;   // too short for a bulk copy: all by cp.async
    tx += static_cast<unsigned>(hi[a] - lo[a]);
  }
  mbar_expect_tx(full, tx);
#pragma unroll
  for (int a = 0; a < kArrays; ++a) {
    const uintptr_t g = reinterpret_cast<uintptr_t>(src[a]), end = g + len[a] * sizeof(T);
    T* dst = slot + L.arr[a] + lead_of(src[a]);   // dst and src agree mod 16
    if (hi[a] > lo[a])
      bulk_copy(dst + (lo[a] - g) / sizeof(T), reinterpret_cast<const void*>(lo[a]),
                static_cast<unsigned>(hi[a] - lo[a]), full);
    for (uintptr_t p = g; p < lo[a]; p += sizeof(T))
      cp_async(dst + (p - g) / sizeof(T), reinterpret_cast<const T*>(p));
    for (uintptr_t p = hi[a]; p < end; p += sizeof(T))
      cp_async(dst + (p - g) / sizeof(T), reinterpret_cast<const T*>(p));
  }
  cp_async_arrive(full);
}

// sum over c = part, part + kGroup, ... < n of row[c] x[c], four partial sums
template <typename T>
__device__ inline T strided_dot(const T* row, const T* x, int n, int part) {
  T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
  int c = part;
  for (; c + 3 * kGroup < n; c += 4 * kGroup) {
    a0 += row[c] * x[c];
    a1 += row[c + kGroup] * x[c + kGroup];
    a2 += row[c + 2 * kGroup] * x[c + 2 * kGroup];
    a3 += row[c + 3 * kGroup] * x[c + 3 * kGroup];
  }
  for (; c < n; c += kGroup) a0 += row[c] * x[c];
  return (a0 + a1) + (a2 + a3);
}

// One stage's arrays in its slot (each at its lead: see issue_stage).
template <typename T>
struct Stage {
  T *A, *B, *K, *d, *k;
};

// All threads: fold the stage's closed loop in place, A <- A + B K and
// d <- d + B k, so that dx' = A dx + d. Each thread sums a 4 x 4 tile of
// [A | d] over the nu columns of B: rows 4 tr .. 4 tr + 3 and the columns
// tc + n_tc q, q < 4 (column nx is d, fed by k); a row or column past the
// end reads a valid entry and is not written. Ends with a block barrier.
template <typename T>
__device__ inline void fold_stage(const Stage<T>& st, int nx, int nu) {
  const int n_tr = (nx + 3) / 4, n_tc = (nx + 1 + 3) / 4;
  for (int t = threadIdx.x; t < n_tr * n_tc; t += kThreads) {
    const int r0 = (t / n_tc) * 4, tc = t % n_tc;
    const T* bp[4];
    const T* kp[4];
    int ks[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      bp[p] = st.B + (r0 + p < nx ? r0 + p : nx - 1) * nu;
      const int c = tc + n_tc * p;
      kp[p] = c < nx ? st.K + c : st.k;
      ks[p] = c < nx ? nx : 1;
    }
    T acc[4][4] = {};
#pragma unroll 2
    for (int m = 0; m < nu; ++m) {
      T b[4], kk[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        b[p] = bp[p][m];
        kk[p] = kp[p][m * ks[p]];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] += b[p] * kk[q];
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int r = r0 + p;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = tc + n_tc * q;
        if (r < nx && c < nx) st.A[r * nx + c] += acc[p][q];
        if (r < nx && c == nx) st.d[r] += acc[p][q];
      }
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    forward_rollout_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                           const T* __restrict__ d, const T* __restrict__ K,
                           const T* __restrict__ k, const T* __restrict__ dx0,
                           T* __restrict__ dxs, T* __restrict__ dus, int N, int nx, int nu,
                           int n_ranks, int n_slots) {
  K3_CLOCK_START;
  const unsigned rank = cluster_rank();
  const size_t inst = blockIdx.x / n_ranks;
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
  const int most = (N + n_ranks - 1) / n_ranks;
  const Layout L = smem_layout<T>(nx, nu, n_slots, most);
  T* sm = reinterpret_cast<T*>(smem_raw);
  unsigned long long* hand = reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned long long* full = hand + 1;   // one per slot
  T* ox = sm + L.ox;   // row i: dx at this rank's stage i; row 0 is the hand-off target
  T* ou = sm + L.ou;   // row i: du at stage i
  T* slots = sm + L.slots;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int len[kArrays] = {nx * nx, nx * nu, nu * nx, nx, nu};

  // this rank's stages (at least one: the plan keeps C <= N)
  const int s0 = static_cast<int>((static_cast<long long>(rank) * N) / n_ranks);
  const int s1 = static_cast<int>((static_cast<long long>(rank + 1) * N) / n_ranks);
  const int n_s = s1 - s0;
  const bool receives = rank > 0, sends = rank + 1 < static_cast<unsigned>(n_ranks);
  auto stage_src = [&](int s, const T* (&src)[kArrays]) {
    src[0] = A + s * nxx;
    src[1] = Bm + s * nxu;
    src[2] = K + s * nxu;
    src[3] = d + static_cast<size_t>(s) * nx;
    src[4] = k + static_cast<size_t>(s) * nu;
  };
  auto issue = [&](int i) {   // local stage i into slot i % n_slots
    const T* src[kArrays];
    stage_src(s0 + i, src);
    issue_stage(slots + (i % n_slots) * L.slot, full + i % n_slots, L, src, len);
  };
  auto stage = [&](int i) {
    const T* src[kArrays];
    stage_src(s0 + i, src);
    T* st = slots + (i % n_slots) * L.slot;
    return Stage<T>{st + L.arr[0] + lead_of(src[0]), st + L.arr[1] + lead_of(src[1]),
                    st + L.arr[2] + lead_of(src[2]), st + L.arr[3] + lead_of(src[3]),
                    st + L.arr[4] + lead_of(src[4])};
  };
  auto wait_loaded = [&](int i) {
    mbar_wait(full + i % n_slots, static_cast<unsigned>((i / n_slots) & 1));
  };

  if (tid == 0) {
    mbar_init(hand, kWarp);
    for (int j = 0; j < n_slots; ++j) mbar_init(full + j, 2);   // expect_tx + cp.async arrivals
    mbar_init_fence();
  }
  __syncthreads();    // the mbarriers are initialised before any thread here waits on them
  cluster_arrive();   // ... and (after the cluster wait) before any peer arrives on one
  const int first = n_s < n_slots ? n_s : n_slots;
  if (lane == 0)
    for (int i = warp; i < first; i += kThreads / kWarp) issue(i);   // warp w issues stage w
  K3_MARK(0);

  // A rank that waits for dx first folds stages in its slots, but only as
  // many as fit before dx comes: dx reaches it once the s0 stages before its
  // range are walked, so it folds at most s0 - 1 (folding more delays the
  // chain: PERF.md). The other stages are walked unfolded.
  const int folded = receives ? (first < s0 - 1 ? first : s0 - 1) : 0;
  if (receives) {
    for (int i = 0; i < folded; ++i) {
      wait_loaded(i);
      fold_stage(stage(i), nx, nu);
    }
    mbar_wait_cluster(hand, 0);
  } else {
    for (int r = tid; r < nx; r += kThreads) ox[r] = dx0[r];
    __syncthreads();
  }
  K3_MARK(1);
  K3_STAMP(1);
  cluster_wait();   // every peer's mbarrier is initialised (before the hand-off below)

  // The walk. A folded stage takes one pass, dx' = A dx + d, and in the
  // same pass du = K dx + k (off the chain); one not folded takes two, du =
  // K dx + k, then dx' = A dx + B du + d.
  const int part = tid % kGroup, row = tid / kGroup;
  for (int i = 0; i < n_s; ++i) {
    const Stage<T> st = stage(i);
    const T* cur = ox + i * nx;
    T* du = ou + i * nu;
    T* nxt = i + 1 < n_s ? ox + (i + 1) * nx : sm + L.xa;
    if (i < folded) {
      for (int r0 = 0; r0 < nx + nu; r0 += kRowsPerPass) {
        const int r = r0 + row;
        const bool x_row = r < nx, u_row = !x_row && r < nx + nu;
        T acc = T(0);
        if (x_row || u_row)
          acc = strided_dot(x_row ? st.A + r * nx : st.K + (r - nx) * nx, cur, nx, part);
        acc = group_sum(acc);
        if (part == 0 && x_row) nxt[r] = acc + st.d[r];
        if (part == 0 && u_row) du[r - nx] = acc + st.k[r - nx];
      }
      __syncthreads();
    } else {
      wait_loaded(i);
      K3_MARK(2);
      for (int r0 = 0; r0 < nu; r0 += kRowsPerPass) {
        const int r = r0 + row;
        T acc = r < nu ? strided_dot(st.K + r * nx, cur, nx, part) : T(0);
        acc = group_sum(acc);
        if (r < nu && part == 0) du[r] = acc + st.k[r];
      }
      __syncthreads();
      for (int r0 = 0; r0 < nx; r0 += kRowsPerPass) {
        const int r = r0 + row;
        T acc = T(0);
        if (r < nx)
          acc = strided_dot(st.A + r * nx, cur, nx, part) +
                strided_dot(st.B + r * nu, du, nu, part);
        acc = group_sum(acc);
        if (r < nx && part == 0) nxt[r] = acc + st.d[r];
      }
      __syncthreads();
    }
    K3_MARK(3);
    if (tid == 0 && i + n_slots < n_s) {   // this slot is read: copy the stage S ahead into it
      fence_proxy_async();
      issue(i + n_slots);
    }
    K3_MARK(4);
  }
  K3_STAMP(2);
  const T* last = sm + L.xa;   // dx after this rank's stages

  if (sends && tid < kWarp) {
    T* peer_x = peer_shared(ox, rank + 1);
    for (int r = tid; r < nx; r += kWarp) peer_x[r] = last[r];
    mbar_arrive_peer(hand, rank + 1);
  }
  K3_MARK(5);

  // the outputs of this rank's stages, coalesced, after the hand-off
  for (int i = tid; i < n_s * nx; i += kThreads) dxs[static_cast<size_t>(s0) * nx + i] = ox[i];
  for (int i = tid; i < n_s * nu; i += kThreads) dus[static_cast<size_t>(s0) * nu + i] = ou[i];
  if (rank + 1 == static_cast<unsigned>(n_ranks))
    for (int r = tid; r < nx; r += kThreads) dxs[static_cast<size_t>(N) * nx + r] = last[r];
  cluster_arrive();   // no CTA exits while a peer may still write into it
  cluster_wait();
  K3_MARK(6);
  K3_CLOCK_END;
}

// C and the slots per CTA for a shape, where n_ranks or n_slots is 0: C =
// min(8, N, the stage data over 16 KB), since a hand-off costs more than
// loading a few KB (a small instance runs in one CTA); as many slots as the
// longest range has stages, or as fit in 227 KB. A caller's own choice must
// have 1 <= C <= min(8, N) and 1 <= slots <= the longest range.
template <typename T>
int make_plan(int N, int nx, int nu, int& n_ranks, int& n_slots, size_t& smem) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0 || nx <= 0 || nu <= 0 || n_ranks < 0 || n_slots < 0) return bad;
  if (n_ranks == 0) {
    const Layout one = smem_layout<T>(nx, nu, 1, 1);
    const size_t data = sizeof(T) * one.slot * static_cast<size_t>(N);
    const int by_bytes = static_cast<int>((data + kMinCtaBytes - 1) / kMinCtaBytes);
    n_ranks = N < kMaxCluster ? N : kMaxCluster;
    if (by_bytes < n_ranks) n_ranks = by_bytes;
  }
  if (n_ranks > kMaxCluster || n_ranks > N) return bad;   // every rank owns a stage
  const int most = (N + n_ranks - 1) / n_ranks;   // the longest range of the floor split
  if (n_slots == 0) {
    n_slots = most;
    while (n_slots > 1 && sizeof(T) * smem_layout<T>(nx, nu, n_slots, most).total > kMaxSmem)
      --n_slots;
  }
  if (n_slots > most) return bad;
  smem = sizeof(T) * smem_layout<T>(nx, nu, n_slots, most).total;
  return smem > kMaxSmem ? bad : 0;
}

template <typename T>
int launch_rollout(const T* A, const T* B, const T* d, const T* K, const T* k, const T* dx0,
                   T* dxs, T* dus, int batch, int N, int nx, int nu, int n_ranks, int n_slots,
                   void* stream) {
  if (batch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  const int bad = make_plan<T>(N, nx, nu, n_ranks, n_slots, smem);
  if (bad) return bad;
  cudaError_t err = prepare_kernel<T>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_clusters<T>(batch, n_ranks, smem, static_cast<cudaStream_t>(stream), A, B, d, K,
                           k, dx0, dxs, dus, N, nx, nu, n_slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int plan_rollout(int N, int nx, int nu, int* out) {
  int n_ranks = 0, n_slots = 0;
  size_t smem = 0;
  const int bad = make_plan<T>(N, nx, nu, n_ranks, n_slots, smem);
  if (bad) return bad;
  cudaError_t err = prepare_kernel<T>(smem);
  int clusters = 0;
  if (err == cudaSuccess) err = max_active_clusters<T>(n_ranks, smem, &clusters);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = n_ranks;
  out[1] = n_slots;
  out[2] = static_cast<int>(smem);
  out[3] = clusters;
  out[4] = kThreads;
  return 0;
}

}  // namespace

extern "C" int wbmpc_forward_rollout_f32(const float* A, const float* B, const float* d,
                                         const float* K, const float* k, const float* dx0,
                                         float* dxs, float* dus, int batch, int N, int nx, int nu,
                                         void* stream) {
  return launch_rollout<float>(A, B, d, K, k, dx0, dxs, dus, batch, N, nx, nu, 0, 0, stream);
}

extern "C" int wbmpc_forward_rollout_f64(const double* A, const double* B, const double* d,
                                         const double* K, const double* k, const double* dx0,
                                         double* dxs, double* dus, int batch, int N, int nx,
                                         int nu, void* stream) {
  return launch_rollout<double>(A, B, d, K, k, dx0, dxs, dus, batch, N, nx, nu, 0, 0, stream);
}

// the same with the cluster size and the slots per CTA chosen by the caller
// (0: the plan's), for the tests' geometries that no shape's plan takes
extern "C" int wbmpc_forward_rollout_ex_f32(const float* A, const float* B, const float* d,
                                            const float* K, const float* k, const float* dx0,
                                            float* dxs, float* dus, int batch, int N, int nx,
                                            int nu, int n_ranks, int n_slots, void* stream) {
  return launch_rollout<float>(A, B, d, K, k, dx0, dxs, dus, batch, N, nx, nu, n_ranks, n_slots,
                               stream);
}

extern "C" int wbmpc_forward_rollout_ex_f64(const double* A, const double* B, const double* d,
                                            const double* K, const double* k, const double* dx0,
                                            double* dxs, double* dus, int batch, int N, int nx,
                                            int nu, int n_ranks, int n_slots, void* stream) {
  return launch_rollout<double>(A, B, d, K, k, dx0, dxs, dus, batch, N, nx, nu, n_ranks, n_slots,
                                stream);
}

#ifdef WBMPC_K3_PHASE_CLOCK
// the phase clock: cycles [8][7] summed over the launches since the last
// reset, and the last launch's global-timer stamps [8][3]
extern "C" int wbmpc_rollout_phase_clock(unsigned long long* cycles, unsigned long long* ns,
                                         int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(cycles, k3_phase_cycles, sizeof(k3_phase_cycles));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(ns, k3_phase_ns, sizeof(k3_phase_ns));
  if (err == cudaSuccess && reset) {
    const unsigned long long zeros[kMaxCluster][7] = {};
    err = cudaMemcpyToSymbol(k3_phase_cycles, zeros, sizeof(zeros));
  }
  return static_cast<int>(err);
}
#endif

// out = {cluster size, slots per CTA, shared bytes per CTA, cudaOccupancyMaxActiveClusters,
// threads per CTA} of the plan for a shape (itemsize 4 or 8)
extern "C" int wbmpc_forward_rollout_plan(int N, int nx, int nu, int itemsize, int* out) {
  if (itemsize == 4) return plan_rollout<float>(N, nx, nu, out);
  if (itemsize == 8) return plan_rollout<double>(N, nx, nu, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
