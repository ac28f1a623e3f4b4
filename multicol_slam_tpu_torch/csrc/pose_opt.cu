// Tracking's pose-only Gauss-Newton, both robust rounds in one launch, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's `pose_only_solve`
// (multicol_slam_tpu/optim/lm.py) is fused by XLA under `jit`. The port
// ran it eagerly, two rounds of 10 iterations of ~770 small kernels each,
// four solves a tracked frame: ~31,000 launches whose dispatch held the
// host for ~0.5 s a frame while the card idled. This kernel computes what
// `optim/ba.pose_optimization_plain` computes:
//
//   round 1: pose_only_solve(pose0, rows) -> pose1, chi2 [O]
//            inlier = valid & chi2 < gate
//   round 2: pose_only_solve(pose1, rows with valid = inlier) -> pose2, chi2
//            inlier = chi2 < gate, n_inliers = its sum
//
// each round 10 damped Gauss-Newton (Levenberg) iterations on the Huber
// cost: r = uv - pi(intr_c, (M_t M_c)^-1 X), e2 = |r|^2 inv_sigma2, IRLS
// weights inv_sigma2 min(1, delta / e), H = sum w J^T J, g = -sum w J^T r,
// step = solve(H + lam diag(H) + 1e-8 I, g); a step is kept when it does
// not raise the robust cost (lam halves), else lam grows tenfold; the
// round stops once a kept step moves no component by 1e-6. The Jacobian is
// `optim/problem._jacobians`'s closed form (pose block), the projection
// `models/camera.world_to_img` (Horner over the inverse polynomial).
// Float32 throughout, as the configuration states.
//
// What bounds it. One call is ~1,200 rows (3 cameras x 400 features) and
// 6 unknowns: per pass over the rows ~1,200 x ~400 flops, and ~50 KB read
// once a launch (15 ns at 3.35 TB/s). The work is a chain of up to 2 x (1 + 10)
// dependent passes: each needs the previous pass's 6x6 solve, and each
// ends in a block-wide reduction of 28 sums. So a launch is bound by that
// chain's latency (a row's dependent arithmetic, the reduction's shuffles
// and barriers, a serial 6x6 LU), microseconds a pass, and not by bytes
// or flops; PERF.md gives the measured time beside that bound.
//
// Design.
//  a. One block a call, a block-stride loop over the rows, so any O and L:
//     the rows are gathered once (X[pt], uv, inv_sigma2, camera, valid)
//     into shared memory, or into the caller's scratch in device memory
//     when they do not fit (mcslam_pose_opt_scratch_bytes says which).
//     Each thread owns the same rows in every pass, so per-row state (the
//     chi2 at the current pose and at the candidate) needs no barrier.
//  b. One pass an iteration. A pass at a candidate pose gives its robust
//     cost, H and g and each row's chi2 together; the pass at the start
//     pose does so for the current one. On accept the candidate's are
//     taken; on reject the pose has not moved, so the held H and g are the
//     ones the plain version recomputes (a deterministic pass gives the
//     same sums at the same pose), and only lam changes. The round's final
//     chi2 is the current pose's, kept from its pass.
//  c. Per pass, thread c computes camera c's transform at the pose
//     ((R Rc)^T, its translation, Rc^T dR_k^T for the three Cayley
//     derivatives) into shared memory; rows then read their camera's.
//  d. Deterministic sums, no atomics: each thread adds its rows in order,
//     each warp reduces by shuffles, then threads j < 28 add the warps'
//     partials in warp order. Every thread then solves the same 6x6 system
//     (LU with partial pivoting) from the same sums and takes the same
//     accept, lam and stop decisions, so control flow stays uniform. Two
//     launches on the same inputs give bitwise-equal outputs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 28;        // 21 upper-triangular entries of H, 6 of g, the robust cost
constexpr int kCost = 27;
constexpr int kPolOffset = 10;   // intr: c, d, e, u0, v0, 5 pol, 12 invpol
constexpr int kInvPol = 12;
constexpr int kIntr = 22;
constexpr size_t kRowBytes = 36; // float4 (X, inv_sigma2), float2 uv, int camera, 2 float chi2
constexpr size_t kMaxShared = 200 * 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Cam {                     // camera c at one body pose
  float Rinv[9];                 // (R Rc)^T, world -> camera
  float tinv[3];
  float G[27];                   // G_k = Rc^T dR_k^T: dXc/dc_k = G_k (X - t)
  float cde[3], pp[2], invpol[kInvPol];
};

struct Args {
  const float* pose0;            // [6]
  const float* X;                // [L, 3]
  int L;
  const long long* pt;           // [O]
  const long long* cam;          // [O]
  const float* uv;               // [O, 2]
  const float* inv_sigma2;       // [O]
  const unsigned char* valid;    // [O] bool
  int O;
  const float* mc6;              // [C, 6]
  const float* intr;             // [C, 22]
  int C;
  int n_iters;
  float delta, gate, lam0;
  float* pose_out;               // [6]
  unsigned char* inlier;         // [O] bool
  long long* n_inliers;          // []
  int* iters;                    // [2]: iterations run before the stop, a round
  unsigned char* rows;           // the rows in device memory, or null
};

struct Rows {
  float4* xs;                    // X, inv_sigma2
  float2* uv;
  int* cam;                      // camera, -1 when the row is left out
  float* chi2;                   // [2][O]: e2, inf when left out or behind the camera
};

__host__ __device__ size_t fixed_bytes(int C) {
  const size_t b = C * sizeof(Cam) + (kWarps + 2) * kSums * sizeof(float) + kWarps * sizeof(int);
  return (b + 15) / 16 * 16;
}

__device__ Rows rows_at(unsigned char* base, int O) {
  return Rows{reinterpret_cast<float4*>(base), reinterpret_cast<float2*>(base + 16 * (size_t)O),
              reinterpret_cast<int*>(base + 24 * (size_t)O), reinterpret_cast<float*>(base + 28 * (size_t)O)};
}

__device__ void cayley_rot(float c1, float c2, float c3, float R[9]) {
  const float c1s = c1 * c1, c2s = c2 * c2, c3s = c3 * c3;
  const float s = 1.0f + c1s + c2s + c3s;
  R[0] = (1.0f + c1s - c2s - c3s) / s;
  R[1] = 2.0f * (c1 * c2 - c3) / s;
  R[2] = 2.0f * (c1 * c3 + c2) / s;
  R[3] = 2.0f * (c1 * c2 + c3) / s;
  R[4] = (1.0f - c1s + c2s - c3s) / s;
  R[5] = 2.0f * (c2 * c3 - c1) / s;
  R[6] = 2.0f * (c1 * c3 - c2) / s;
  R[7] = 2.0f * (c2 * c3 + c1) / s;
  R[8] = (1.0f - c1s - c2s + c3s) / s;
}

// Camera c's transform at body pose q (optim/problem._jacobians: Xc =
// Rc^T (R^T (X - t) - tc), dXc/dc_k = Rc^T dR_k^T (X - t), dXc/dt = -Rc^T R^T).
__device__ void camera_at(const float q[6], const float* mc, const float* intr, Cam& k) {
  float R[9], Rc[9], Rm[9], tm[3];
  cayley_rot(q[0], q[1], q[2], R);
  cayley_rot(mc[0], mc[1], mc[2], Rc);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) Rm[3 * i + j] = R[3 * i] * Rc[j] + R[3 * i + 1] * Rc[3 + j] + R[3 * i + 2] * Rc[6 + j];
    tm[i] = R[3 * i] * mc[3] + R[3 * i + 1] * mc[4] + R[3 * i + 2] * mc[5] + q[3 + i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) k.Rinv[3 * i + j] = Rm[3 * j + i];
    k.tinv[i] = -(Rm[i] * tm[0] + Rm[3 + i] * tm[1] + Rm[6 + i] * tm[2]);
  }
  // dR/dc_k = (dA_k - 2 c_k R) / s (optim/problem._cayley_rot_jac)
  const float c1 = q[0], c2 = q[1], c3 = q[2];
  const float s = 1.0f + c1 * c1 + c2 * c2 + c3 * c3;
  const float dA[27] = {2 * c1, 2 * c2, 2 * c3, 2 * c2, -2 * c1, -2.0f, 2 * c3, 2.0f, -2 * c1,
                        -2 * c2, 2 * c1, 2.0f, 2 * c1, 2 * c2, 2 * c3, -2.0f, 2 * c3, -2 * c2,
                        -2 * c3, -2.0f, 2 * c1, 2.0f, -2 * c3, 2 * c2, 2 * c1, 2 * c2, 2 * c3};
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) {
    float dR[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) dR[e] = (dA[9 * kk + e] - 2.0f * q[kk] * R[e]) / s;
    // G_k[i][m] = sum_j Rc[j][i] dR_k[m][j]
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int m = 0; m < 3; ++m)
        k.G[9 * kk + 3 * i + m] = Rc[i] * dR[3 * m] + Rc[3 + i] * dR[3 * m + 1] + Rc[6 + i] * dR[3 * m + 2];
    }
  }
  k.cde[0] = intr[0]; k.cde[1] = intr[1]; k.cde[2] = intr[2];
  k.pp[0] = intr[3]; k.pp[1] = intr[4];
#pragma unroll
  for (int i = 0; i < kInvPol; ++i) k.invpol[i] = intr[kPolOffset + i];
}

// One row at body translation t: its chi2 (inf when left out), and, when
// it counts, its robust cost, w J^T J and -w J^T r added to acc.
__device__ float row_pass(const Cam& k, float4 a, float2 m, const float t[3], float delta, float acc[kSums]) {
  const float x = k.Rinv[0] * a.x + k.Rinv[1] * a.y + k.Rinv[2] * a.z + k.tinv[0];
  const float y = k.Rinv[3] * a.x + k.Rinv[4] * a.y + k.Rinv[5] * a.z + k.tinv[1];
  const float z = k.Rinv[6] * a.x + k.Rinv[7] * a.y + k.Rinv[8] * a.z + k.tinv[2];
  if (!(z > 0.0f)) return INFINITY;
  // models/camera.world_to_img and optim/problem._project_jac
  const float n = fmaxf(sqrtf(x * x + y * y), 1e-14f);
  const float theta = atan2f(-z, n);
  float rho = k.invpol[kInvPol - 1];
  float drho = (kInvPol - 1) * k.invpol[kInvPol - 1];
#pragma unroll
  for (int i = kInvPol - 2; i >= 0; --i) rho = rho * theta + k.invpol[i];
#pragma unroll
  for (int i = kInvPol - 2; i >= 1; --i) drho = drho * theta + i * k.invpol[i];
  const float ux = x / n, uy = y / n;
  const float uu = ux * rho, vv = uy * rho;
  const float r0 = m.x - (uu * k.cde[0] + vv * k.cde[1] + k.pp[0]);
  const float r1 = m.y - (uu * k.cde[2] + vv + k.pp[1]);
  const float e2 = (r0 * r0 + r1 * r1) * a.w;
  const float e = sqrtf(e2 + 1e-18f);
  acc[kCost] += e <= delta ? e2 : 2.0f * delta * e - delta * delta;
  const float w = a.w * fminf(delta / e, 1.0f);

  const float q = n * n + z * z;
  const float dth[3] = {z * x / (n * q), z * y / (n * q), -n / q};
  const float n3 = n * n * n;
  const float dux[3] = {y * y / n3, -x * y / n3, 0.0f};
  const float duy[3] = {-x * y / n3, x * x / n3, 0.0f};
  const float ax = x / n * drho, ay = y / n * drho;
  float dP0[3], dP1[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float duu = rho * dux[j] + ax * dth[j];
    const float dvv = rho * duy[j] + ay * dth[j];
    dP0[j] = k.cde[0] * duu + k.cde[1] * dvv;
    dP1[j] = k.cde[2] * duu + dvv;
  }
  // J = -dP [dXc/dc | dXc/dt], dXc/dt = -Rinv
  const float D[3] = {a.x - t[0], a.y - t[1], a.z - t[2]};
  float J0[6], J1[6];
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) {
    float col[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      col[i] = k.G[9 * kk + 3 * i] * D[0] + k.G[9 * kk + 3 * i + 1] * D[1] + k.G[9 * kk + 3 * i + 2] * D[2];
    J0[kk] = -(dP0[0] * col[0] + dP0[1] * col[1] + dP0[2] * col[2]);
    J1[kk] = -(dP1[0] * col[0] + dP1[1] * col[1] + dP1[2] * col[2]);
    J0[3 + kk] = dP0[0] * k.Rinv[kk] + dP0[1] * k.Rinv[3 + kk] + dP0[2] * k.Rinv[6 + kk];
    J1[3 + kk] = dP1[0] * k.Rinv[kk] + dP1[1] * k.Rinv[3 + kk] + dP1[2] * k.Rinv[6 + kk];
  }
  const float wr0 = -(w * r0), wr1 = -(w * r1);
  int h = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    acc[21 + i] += J0[i] * wr0 + J1[i] * wr1;
#pragma unroll
    for (int j = i; j < 6; ++j) acc[h++] += w * (J0[i] * J0[j] + J1[i] * J1[j]);
  }
  return e2;
}

// Deterministic block sum of acc into out[kSums]: shuffles within each warp,
// then the warps' partials in warp order. Ends with a barrier.
__device__ void block_sum(float acc[kSums], float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kSums; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    if (lane == 0) red[warp * kSums + j] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = red[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s += red[w * kSums + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// The pass at pose q: camera tables, every row, the block sums into out;
// each row's chi2 into chi2[r].
__device__ void pass(const Args& g, const float q[6], Cam* cams, const Rows& rows, float* chi2, float* red,
                     float* out) {
  for (int c = threadIdx.x; c < g.C; c += kThreads) camera_at(q, g.mc6 + 6 * c, g.intr + kIntr * c, cams[c]);
  __syncthreads();
  float acc[kSums];
#pragma unroll
  for (int j = 0; j < kSums; ++j) acc[j] = 0.0f;
  const float t[3] = {q[3], q[4], q[5]};
  for (int i = threadIdx.x; i < g.O; i += kThreads) {
    const int c = rows.cam[i];
    chi2[i] = c < 0 ? INFINITY : row_pass(cams[c], rows.xs[i], rows.uv[i], t, g.delta, acc);
  }
  block_sum(acc, red, out);
}

// solve(H + lam diag(H) + 1e-8 I, g) by LU with partial pivoting (the
// first largest pivot), as torch.linalg.solve_ex; each non-finite component
// of the step becomes 0.
__device__ void damped_step(const float* s, float lam, float dx[6]) {
  float A[6][6], b[6];
  int h = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      A[i][j] = s[h];
      A[j][i] = s[h];
      ++h;
    }
    b[i] = s[21 + i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) A[i][i] = A[i][i] + lam * fmaxf(A[i][i], 1e-8f) + 1e-8f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (fabsf(A[i][k]) > best) {
        best = fabsf(A[i][k]);
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (i == p) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float tmp = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = tmp;
        }
        const float tmp = b[k];
        b[k] = b[i];
        b[i] = tmp;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] -= l * A[k][j];
      b[i] -= l * b[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float v = b[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) v -= A[i][j] * dx[j];
    dx[i] = v / A[i][i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) dx[i] = isfinite(dx[i]) ? dx[i] : 0.0f;
}

__global__ void __launch_bounds__(kThreads, 1) pose_gn_kernel(Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  Cam* cams = reinterpret_cast<Cam*>(smem);
  float* red = reinterpret_cast<float*>(smem + g.C * sizeof(Cam));
  float* sums = red + kWarps * kSums;                 // [2][kSums]: at the pose, at the candidate
  int* redi = reinterpret_cast<int*>(sums + 2 * kSums);
  const Rows rows = rows_at(g.rows != nullptr ? g.rows : smem + fixed_bytes(g.C), g.O);

  for (int i = threadIdx.x; i < g.O; i += kThreads) {
    const long long p = g.pt[i], c = g.cam[i];
    const bool ok = g.valid[i] && p >= 0 && p < g.L && c >= 0 && c < g.C;
    rows.cam[i] = ok ? (int)c : -1;
    if (ok) {
      rows.xs[i] = make_float4(g.X[3 * p], g.X[3 * p + 1], g.X[3 * p + 2], g.inv_sigma2[i]);
      rows.uv[i] = make_float2(g.uv[2 * i], g.uv[2 * i + 1]);
    }
  }
  float p[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) p[j] = g.pose0[j];
  int cb = 0;                                         // the chi2 buffer at the pose

  for (int round = 0; round < 2; ++round) {
    if (round == 1) {                                 // keep the rows under the gate
      for (int i = threadIdx.x; i < g.O; i += kThreads)
        if (!(rows.chi2[cb * g.O + i] < g.gate)) rows.cam[i] = -1;
    }
    int hs = 0;                                       // the sums at the pose
    pass(g, p, cams, rows, rows.chi2 + cb * g.O, red, sums);
    float cost = sums[kCost], lam = g.lam0;
    bool done = false;
    int n_run = 0;
    for (int it = 0; it < g.n_iters && !done; ++it) {
      ++n_run;
      float dx[6], cand[6];
      damped_step(sums + hs * kSums, lam, dx);
      float dmax = 0.0f;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        cand[j] = p[j] + dx[j];
        dmax = fmaxf(dmax, fabsf(dx[j]));
      }
      pass(g, cand, cams, rows, rows.chi2 + (1 - cb) * g.O, red, sums + (1 - hs) * kSums);
      const float new_cost = sums[(1 - hs) * kSums + kCost];
      const bool accept = isfinite(new_cost) && new_cost <= cost;
      if (accept) {
#pragma unroll
        for (int j = 0; j < 6; ++j) p[j] = cand[j];
        cost = new_cost;
        hs = 1 - hs;
        cb = 1 - cb;
      }
      lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 10.0f, 1e-6f), 1e4f);
      done = accept && dmax < 1e-6f;
    }
    if (threadIdx.x == 0) g.iters[round] = n_run;
  }

  int n = 0;
  for (int i = threadIdx.x; i < g.O; i += kThreads) {
    const bool in = rows.chi2[cb * g.O + i] < g.gate;
    g.inlier[i] = in ? 1 : 0;
    n += in ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) n += __shfl_down_sync(kFull, n, off);
  if ((threadIdx.x & 31) == 0) redi[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += redi[w];
    *g.n_inliers = total;
#pragma unroll
    for (int j = 0; j < 6; ++j) g.pose_out[j] = p[j];
  }
}

bool rows_fit(int O, int C) { return fixed_bytes(C) + kRowBytes * (size_t)O <= kMaxShared; }

}  // namespace

// Bytes of device scratch mcslam_pose_opt needs for O rows of C cameras: 0
// when the rows fit in shared memory.
extern "C" size_t mcslam_pose_opt_scratch_bytes(int O, int C) {
  return rows_fit(O, C) ? 0 : kRowBytes * (size_t)O;
}

// Plain C entry point, loaded with ctypes: both robust rounds of the
// pose-only solve of one body pose (see the note at the top). pt and cam
// are int64, valid and inlier bool (one byte), n_inliers int64, iters two
// int32; scratch holds mcslam_pose_opt_scratch_bytes(O, C) bytes (null when
// that is 0). Launches on `stream`; returns the launch's cudaError_t.
extern "C" int mcslam_pose_opt(
    const void* pose0, const void* X, int L, const void* pt, const void* cam, const void* uv,
    const void* inv_sigma2, const void* valid, int O, const void* mc6, const void* intr, int C,
    int n_iters, float huber_delta, float chi2_gate, float lam0,
    void* pose_out, void* inlier, void* n_inliers, void* iters, void* scratch, void* stream) {
  if (C <= 0 || O < 0 || L < 0 || n_iters < 0 || fixed_bytes(C) > kMaxShared) return (int)cudaErrorInvalidValue;
  const bool in_device = !rows_fit(O, C);
  if (in_device && scratch == nullptr) return (int)cudaErrorInvalidValue;
  Args g{static_cast<const float*>(pose0), static_cast<const float*>(X), L,
         static_cast<const long long*>(pt), static_cast<const long long*>(cam),
         static_cast<const float*>(uv), static_cast<const float*>(inv_sigma2),
         static_cast<const unsigned char*>(valid), O, static_cast<const float*>(mc6),
         static_cast<const float*>(intr), C, n_iters, huber_delta, chi2_gate, lam0,
         static_cast<float*>(pose_out), static_cast<unsigned char*>(inlier),
         static_cast<long long*>(n_inliers), static_cast<int*>(iters),
         in_device ? static_cast<unsigned char*>(scratch) : nullptr};
  const size_t smem = fixed_bytes(C) + (in_device ? 0 : kRowBytes * (size_t)O);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(pose_gn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pose_gn_kernel<<<1, kThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}
