// Native MRT runtime core (C++17, no external deps).
//
// Re-provides the reference's C++ robot_runtime hot path natively
// (reference: `robot_core/ThreadSafe.h:6-30` thread-safe value exchange,
// `robot_model/RobotHWInterfaceBase.h:13-45` double-buffered state/action
// hand-off, `RobotJointAction.h:8-16` PD+feed-forward torque law, and
// `MRT_BASE::evaluatePolicy` time interpolation consumed at 500 Hz by
// `CentroidalMpcRobotSim.cpp:141-159`).
//
// The TPU solver produces policies as flat arrays; this module gives the
// 500 Hz-class control loop a C-speed path for policy interpolation and
// torque computation, plus a seqlock buffer for lock-free cross-thread state
// exchange (writer never blocks, readers retry on seq mismatch).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Policy evaluation: piecewise-linear state, zero-order-hold input.
// xs: [N+1, nx], us: [N, nu]; t relative to policy start t0, node spacing dt.
// ---------------------------------------------------------------------------
void mrt_evaluate_policy(const double* xs, const double* us, int N, int nx,
                         int nu, double t0, double dt, double t,
                         double* x_out, double* u_out) {
  double s = (t - t0) / dt;
  if (s < 0.0) s = 0.0;
  double smax = static_cast<double>(N);
  if (s > smax) s = smax;
  int k = static_cast<int>(s);
  if (k > N - 1) k = N - 1;
  double a = s - static_cast<double>(k);
  if (a < 0.0) a = 0.0;
  if (a > 1.0) a = 1.0;

  const double* x0 = xs + static_cast<size_t>(k) * nx;
  const double* x1 = xs + static_cast<size_t>(k + 1) * nx;
  for (int i = 0; i < nx; ++i) x_out[i] = (1.0 - a) * x0[i] + a * x1[i];

  const double* u0 = us + static_cast<size_t>(k) * nu;
  for (int i = 0; i < nu; ++i) u_out[i] = u0[i];
}

// ---------------------------------------------------------------------------
// PD + feed-forward joint torque (reference `getTotalFeedbackTorque`).
// ---------------------------------------------------------------------------
void mrt_joint_torques(const double* q_des, const double* qd_des,
                       const double* kp, const double* kd, const double* ff,
                       const double* q, const double* qd, int n,
                       double* tau_out) {
  for (int i = 0; i < n; ++i) {
    tau_out[i] = kp[i] * (q_des[i] - q[i]) + kd[i] * (qd_des[i] - qd[i]) + ff[i];
  }
}

// ---------------------------------------------------------------------------
// Seqlock double-buffer: lock-free latest-value exchange between a single
// writer (solver thread) and any number of readers (control thread).
// ---------------------------------------------------------------------------
struct TsBuf {
  std::atomic<uint64_t> seq{0};
  std::vector<double> data;
};

void* tsbuf_create(int n) {
  auto* b = new TsBuf();
  b->data.assign(static_cast<size_t>(n), 0.0);
  return b;
}

void tsbuf_destroy(void* h) { delete static_cast<TsBuf*>(h); }

void tsbuf_write(void* h, const double* src, int n) {
  auto* b = static_cast<TsBuf*>(h);
  uint64_t s = b->seq.load(std::memory_order_relaxed);
  b->seq.store(s + 1, std::memory_order_release);  // odd: write in progress
  std::memcpy(b->data.data(), src, sizeof(double) * static_cast<size_t>(n));
  b->seq.store(s + 2, std::memory_order_release);  // even: stable
}

// returns the sequence number of the snapshot (even), spinning on writers
uint64_t tsbuf_read(void* h, double* dst, int n) {
  auto* b = static_cast<TsBuf*>(h);
  while (true) {
    uint64_t s0 = b->seq.load(std::memory_order_acquire);
    if (s0 & 1ull) continue;  // writer active
    std::memcpy(dst, b->data.data(), sizeof(double) * static_cast<size_t>(n));
    uint64_t s1 = b->seq.load(std::memory_order_acquire);
    if (s0 == s1) return s1;
  }
}

// ---------------------------------------------------------------------------
// Fused 500 Hz control tick: evaluate policy, map MPC joints into the full
// robot joint vector, compute torques — one call per control step.
// mpc_joint_idx: [n_mpc] indices into the full joint vector.
// Layout assumptions (both formulations): joint angles of the policy state
// start at `q_off`, joint velocity reference comes from `qd_src` (0: policy
// state at `qd_off`; 1: policy input at `qd_off`).
// ---------------------------------------------------------------------------
void mrt_control_tick(const double* xs, const double* us, int N, int nx, int nu,
                      double t0, double dt, double t, int q_off, int qd_src,
                      int qd_off, const int* mpc_joint_idx, int n_mpc,
                      const double* ff, double kp, double kd, double kp_fixed,
                      double kd_fixed, const double* q_full,
                      const double* qd_full, int n_full, double* tau_out) {
  std::vector<double> x(static_cast<size_t>(nx));
  std::vector<double> u(static_cast<size_t>(nu));
  mrt_evaluate_policy(xs, us, N, nx, nu, t0, dt, t, x.data(), u.data());

  // fixed joints: hold zero with soft gains
  for (int j = 0; j < n_full; ++j) {
    tau_out[j] = kp_fixed * (0.0 - q_full[j]) + kd_fixed * (0.0 - qd_full[j]);
  }
  const double* qd_ref_base = (qd_src == 0) ? x.data() : u.data();
  for (int i = 0; i < n_mpc; ++i) {
    int j = mpc_joint_idx[i];
    double q_des = x[static_cast<size_t>(q_off + i)];
    double qd_des = qd_ref_base[static_cast<size_t>(qd_off + i)];
    tau_out[j] = kp * (q_des - q_full[j]) + kd * (qd_des - qd_full[j]) +
                 (ff ? ff[i] : 0.0);
  }
}

}  // extern "C"
