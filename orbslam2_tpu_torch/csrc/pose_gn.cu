// K2: the whole robust pose-only Gauss-Newton schedule in one launch.
//
// Replaces the TPU kernel orbslam2_tpu/solvers/pallas_pose_opt.py
// (_make_kernel and pose_optimize_pallas). The math is that of
// orbslam2_tpu/solvers/pose_opt.py:pose_optimize, the kernel's plain
// version (ORB-SLAM2's PoseOptimization): mono (u, v) and stereo (u, v, uR)
// reprojection residuals with analytic SE(3) Jacobians, Huber weights in
// rounds 0-1, the 6x6 normal equations damped by 1e-5 (tr/6 + 1e-6), a
// Cholesky solve, a left-multiplied se(3) exp update that rejects
// non-finite or zero-gradient steps, and chi2 inlier reclassification
// (5.991 mono, 7.815 stereo) from the initial mask after every round.
//
// The rotational Jacobian columns use camera-frame coordinates, as
// pose_opt._residuals_jacobians does; the Pallas kernel used the world
// point's x and y there.
//
// What bounds it on an H100: latency, not bytes or FLOPs. A problem is at
// most feature_slots (1024) observations of 36 bytes and a schedule runs at
// most 40 dependent iterations, each needing a block-wide sum and a 6x6
// solve. So one thread block of 256 threads owns one problem for the whole
// schedule: observations are strided across the threads, each thread
// accumulates its share of the 27 sums (21 H + 6 b) in registers, a warp
// shuffle + shared-memory reduction combines them, thread 0 solves and
// updates the pose in registers and broadcasts the 12 pose scalars through
// shared memory. One launch replaces the ~60 small kernels per iteration
// of the plain version. Slots outside the current inlier set are skipped,
// never multiplied by zero: padded slots may hold NaN.
//
// Later work (not here): batch the independent problems of one frame into
// one launch (one block each).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;  // 21 upper-triangular H entries + 6 b entries
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;

struct Obs {
  float x, y, z;    // camera-frame point
  float iz, iz2;
  bool valid;       // z > 1e-3
  bool stereo;      // ur >= 0
  float r0, r1, r2; // residuals (r2 = 0 for mono)
};

__device__ __forceinline__ Obs residuals(const float* T, const float* pw,
                                         const float* uv, const float* ur,
                                         int i, float fx, float fy, float cx,
                                         float cy, float bf) {
  Obs o;
  const float px = pw[3 * i], py = pw[3 * i + 1], pz = pw[3 * i + 2];
  o.x = T[0] * px + T[1] * py + T[2] * pz + T[9];
  o.y = T[3] * px + T[4] * py + T[5] * pz + T[10];
  o.z = T[6] * px + T[7] * py + T[8] * pz + T[11];
  o.valid = o.z > 1e-3f;
  const float zs = o.valid ? o.z : 1.0f;
  o.iz = 1.0f / zs;
  o.iz2 = o.iz * o.iz;
  const float u = fx * o.x * o.iz + cx;
  const float v = fy * o.y * o.iz + cy;
  const float urm = ur[i];
  o.stereo = urm >= 0.0f;
  o.r0 = uv[2 * i] - u;
  o.r1 = uv[2 * i + 1] - v;
  o.r2 = o.stereo ? urm - (u - bf * o.iz) : 0.0f;
  return o;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Solve H x = rhs for a damped SPD 6x6 (mirrors pose_opt.solve6_spd).
__device__ void chol6_solve(const float H[6][6], const float rhs[6], float x[6]) {
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = H[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    const float d = sqrtf(fmaxf(s, 1e-12f));
    L[j][j] = d;
    const float inv_d = 1.0f / d;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = H[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t * inv_d;
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// se(3) exp of dx = (rho, phi) -> R (row-major 3x3), t; the same Taylor
// switches as geometry/se3.exp_se3.
__device__ void exp_se3(const float dx[6], float R[9], float t[3]) {
  const float wx = dx[3], wy = dx[4], wz = dx[5];
  const float t2 = wx * wx + wy * wy + wz * wz;
  const float th = sqrtf(fmaxf(t2, 1e-8f));
  const bool small = t2 < 1e-4f;
  const float a = small ? 1.0f - t2 / 6.0f : sinf(th) / th;
  const float b = small ? 0.5f - t2 / 24.0f : (1.0f - cosf(th)) / t2;
  const float c = small ? 1.0f / 6.0f - t2 / 120.0f : (1.0f - a) / t2;
  const float W[9] = {0.0f, -wz, wy, wz, 0.0f, -wx, -wy, wx, 0.0f};
  float W2[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      W2[3 * i + j] = W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j] + W[3 * i + 2] * W[6 + j];
  float V[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float e = (k % 4 == 0) ? 1.0f : 0.0f;
    R[k] = e + a * W[k] + b * W2[k];
    V[k] = e + b * W[k] + c * W2[k];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    t[i] = V[3 * i] * dx[0] + V[3 * i + 1] * dx[1] + V[3 * i + 2] * dx[2];
}

__global__ void __launch_bounds__(kThreads)
pose_gn_kernel(const float* __restrict__ pw, const float* __restrict__ uv,
               const float* __restrict__ ur, const float* __restrict__ isig,
               const bool* __restrict__ mask0, const float* __restrict__ kp,
               const float* __restrict__ T0, int n, int rounds, int iters,
               float* __restrict__ T_out, bool* __restrict__ inl,
               float* __restrict__ chi2_out) {
  __shared__ float s_T[12];  // r00..r22 row-major, tx, ty, tz
  __shared__ float s_part[kWarps][kSums];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float fx = kp[0], fy = kp[1], cx = kp[2], cy = kp[3], bf = kp[4];
  const float delta_mono = sqrtf(kChi2Mono);
  const float delta_stereo = sqrtf(kChi2Stereo);

  if (tid < 12) s_T[tid] = tid < 9 ? T0[(tid / 3) * 4 + tid % 3] : T0[(tid - 9) * 4 + 3];
  // the working inlier mask lives in the output; each thread owns the
  // slots i = tid (mod kThreads) for the whole schedule
  for (int i = tid; i < n; i += kThreads) inl[i] = mask0[i];
  __syncthreads();

  for (int rnd = 0; rnd < rounds; ++rnd) {
    const bool huber = rnd < 2;
    for (int it = 0; it < iters; ++it) {
      float T[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) T[k] = s_T[k];
      float acc[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;

      for (int i = tid; i < n; i += kThreads) {
        if (!inl[i]) continue;
        const Obs o = residuals(T, pw, uv, ur, i, fx, fy, cx, cy, bf);
        if (!o.valid) continue;
        const float isg = isig[i];
        float w = isg;
        if (huber) {
          const float chi2 = (o.r0 * o.r0 + o.r1 * o.r1 + o.r2 * o.r2) * isg;
          const float en = sqrtf(fmaxf(chi2, 1e-12f));
          const float delta = o.stereo ? delta_stereo : delta_mono;
          if (en > delta) w *= delta / en;
        }
        // J = -d(u, v, uR)/d(xi) for pc' = exp(xi) pc: rows du, dv, dur
        // times [I | -hat(pc)], negated
        const float a = fx * o.iz;
        const float c = -fx * o.x * o.iz2;
        const float b = fy * o.iz;
        const float c2 = -fy * o.y * o.iz2;
        const float c3 = c + bf * o.iz2;
        const float J0[6] = {-a, 0.0f, -c, -c * o.y, -(a * o.z - c * o.x), a * o.y};
        const float J1[6] = {0.0f, -b, -c2, b * o.z - c2 * o.y, c2 * o.x, -b * o.x};
        const float s = o.stereo ? 1.0f : 0.0f;
        const float J2[6] = {-a * s, 0.0f, -c3 * s, -c3 * o.y * s,
                             -(a * o.z - c3 * o.x) * s, a * o.y * s};
        int k = 0;
#pragma unroll
        for (int j = 0; j < 6; ++j) {
#pragma unroll
          for (int l = j; l < 6; ++l) {
            acc[k++] += w * (J0[j] * J0[l] + J1[j] * J1[l] + J2[j] * J2[l]);
          }
        }
#pragma unroll
        for (int j = 0; j < 6; ++j) acc[21 + j] += w * (J0[j] * o.r0 + J1[j] * o.r1 + J2[j] * o.r2);
      }

#pragma unroll
      for (int k = 0; k < kSums; ++k) {
        const float v = warp_sum(acc[k]);
        if (lane == 0) s_part[warp][k] = v;
      }
      __syncthreads();
      if (tid == 0) {
        float sum[kSums];
#pragma unroll
        for (int k = 0; k < kSums; ++k) {
          float v = 0.0f;
#pragma unroll
          for (int q = 0; q < kWarps; ++q) v += s_part[q][k];
          sum[k] = v;
        }
        float H[6][6];
        int k = 0;
#pragma unroll
        for (int j = 0; j < 6; ++j) {
#pragma unroll
          for (int l = j; l < 6; ++l) {
            H[j][l] = sum[k];
            H[l][j] = sum[k];
            ++k;
          }
        }
        float negb[6];
        float b2 = 0.0f;
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          negb[j] = -sum[21 + j];
          b2 += sum[21 + j] * sum[21 + j];
        }
        const float tr = H[0][0] + H[1][1] + H[2][2] + H[3][3] + H[4][4] + H[5][5];
        const float damp = 1e-5f * (tr / 6.0f + 1e-6f);
#pragma unroll
        for (int j = 0; j < 6; ++j) H[j][j] += damp;
        float dx[6];
        chol6_solve(H, negb, dx);
        bool ok = b2 > 1e-20f;
#pragma unroll
        for (int j = 0; j < 6; ++j) ok = ok && isfinite(dx[j]);
        if (!ok) {
#pragma unroll
          for (int j = 0; j < 6; ++j) dx[j] = 0.0f;
        }
        float Rd[9], td[3];
        exp_se3(dx, Rd, td);
        float Tn[12];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = 0; j < 3; ++j)
            Tn[3 * i + j] = Rd[3 * i] * T[j] + Rd[3 * i + 1] * T[3 + j] + Rd[3 * i + 2] * T[6 + j];
          Tn[9 + i] = Rd[3 * i] * T[9] + Rd[3 * i + 1] * T[10] + Rd[3 * i + 2] * T[11] + td[i];
        }
#pragma unroll
        for (int q = 0; q < 12; ++q) s_T[q] = Tn[q];
      }
      __syncthreads();
    }

    // chi2 reclassification from the initial mask at the round's pose
    float T[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) T[k] = s_T[k];
    for (int i = tid; i < n; i += kThreads) {
      bool keep = false;
      if (mask0[i]) {
        const Obs o = residuals(T, pw, uv, ur, i, fx, fy, cx, cy, bf);
        const float chi2 = (o.r0 * o.r0 + o.r1 * o.r1 + o.r2 * o.r2) * isig[i];
        keep = o.valid && chi2 <= (o.stereo ? kChi2Stereo : kChi2Mono);
      }
      inl[i] = keep;
    }
  }

  // final chi2 at the solution, zero outside the initial mask
  float T[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = s_T[k];
  for (int i = tid; i < n; i += kThreads) {
    float chi2 = 0.0f;
    if (mask0[i]) {
      const Obs o = residuals(T, pw, uv, ur, i, fx, fy, cx, cy, bf);
      chi2 = (o.r0 * o.r0 + o.r1 * o.r1 + o.r2 * o.r2) * isig[i];
    }
    chi2_out[i] = chi2;
  }
  if (tid < 16) {
    const int r = tid / 4, c = tid % 4;
    float v;
    if (r == 3) {
      v = c == 3 ? 1.0f : 0.0f;
    } else {
      v = c < 3 ? T[3 * r + c] : T[9 + r];
    }
    T_out[tid] = v;
  }
}

}  // namespace

// C interface (loaded with ctypes). One problem per launch; launches on
// `stream`, does not synchronise, returns the cudaError_t of the launch.
extern "C" int pose_gn(const float* pw, const float* uv, const float* ur,
                       const float* isig, const bool* mask0, const float* kp,
                       const float* T0, int n, int rounds, int iters,
                       float* T_out, bool* inl, float* chi2, void* stream) {
  pose_gn_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pw, uv, ur, isig, mask0, kp, T0, n, rounds, iters, T_out, inl, chi2);
  return static_cast<int>(cudaGetLastError());
}
