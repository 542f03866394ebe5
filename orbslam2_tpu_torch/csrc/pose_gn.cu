// K2: the whole robust pose-only Gauss-Newton schedule in one launch.
//
// Replaces the TPU kernel orbslam2_tpu/solvers/pallas_pose_opt.py:242
// (pose_optimize_pallas, body _make_kernel at :100). The math is that of
// orbslam2_tpu/solvers/pose_opt.py:pose_optimize, the kernel's plain
// version (ORB-SLAM2's PoseOptimization): mono (u, v) and stereo (u, v, uR)
// reprojection residuals with analytic SE(3) Jacobians, Huber weights in
// rounds 0-1, the 6x6 normal equations damped by 1e-5 (tr/6 + 1e-6), a
// Cholesky solve, a left-multiplied se(3) exp update that rejects
// non-finite or zero-gradient steps, and chi2 inlier reclassification
// (5.991 mono, 7.815 stereo) from the initial mask after every round.
// The rotational Jacobian columns use camera-frame coordinates, as
// pose_opt._residuals_jacobians does; the Pallas kernel used the world
// point's x and y there.
//
// What bounds it on an H100: latency. A problem is at most a few thousand
// observations of 29 bytes (35 KB at 1024 slots, 0.01 us of memory) and
// about 200 flops per observation and iteration (4.9 MFLOP for 4 x 6
// iterations at 1024 slots, 0.07 us at 67 TFLOP/s), but the iterations
// depend on each other, each needing a block-wide sum and a 6x6 solve, and
// the path's problems depend on each other too (pass 2 starts from pass
// 1), so one block owns one problem and the chain of iterations is the
// time. The design shortens that chain:
// - Observations in registers: each thread loads its slots
//   i = tid + k * kThreads (k < kPer, a template parameter chosen from the
//   slot count) once, with their initial-mask and inlier bits. The
//   iteration loop reads no global memory; the inlier flags and chi2 are
//   written once at the end.
// - One reduction pass: the 27 sums (21 H + 6 b) of a warp are reduced by
//   a reduce-scatter over the lanes (31 shuffles, lane j ends with sum j),
//   and each warp's 27 partials go to shared memory.
// - One barrier per iteration: after it lane j of every warp adds the
//   warps' partials j (the 27 lanes in parallel, the warps in a fixed
//   order), 27 shuffles hand every lane all 27 sums, and every thread
//   computes the same damped solve and se(3) update in registers, so every
//   thread holds the same pose and no broadcast or second barrier is
//   needed. The partials are double
//   buffered, so the next iteration's writes cannot meet a slow thread's
//   reads of this one.
// - One launch per call: the kernel also writes num_inliers (int64, 0-d),
//   and the intrinsics come packed in one [5] tensor made once per
//   Intrinsics.
// - 256 threads a block: 128, 512 and 1024 timed slower on an H100
//   (fewer threads serialise the slots, more repeat the solve and the
//   partial sums; PERF.md).
// Slots outside the current inlier set are skipped, never multiplied by
// zero: padded slots may hold NaN.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPer = 10;  // slots per thread: at most 10 * kThreads slots
constexpr int kSums = 27;   // 21 upper-triangular H entries + 6 b entries
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;

struct Cam {
  float fx, fy, cx, cy, bf;
};

struct Res {
  float x, y, z, iz, iz2;
  bool valid;        // z > 1e-3
  float r0, r1, r2;  // residuals (r2 = 0 for mono)
};

__device__ __forceinline__ Res residuals(const float (&T)[12], float px, float py, float pz,
                                         float u_obs, float v_obs, float ur, const Cam& k) {
  Res o;
  o.x = T[0] * px + T[1] * py + T[2] * pz + T[9];
  o.y = T[3] * px + T[4] * py + T[5] * pz + T[10];
  o.z = T[6] * px + T[7] * py + T[8] * pz + T[11];
  o.valid = o.z > 1e-3f;
  o.iz = 1.0f / (o.valid ? o.z : 1.0f);
  o.iz2 = o.iz * o.iz;
  const float u = k.fx * o.x * o.iz + k.cx;
  const float v = k.fy * o.y * o.iz + k.cy;
  o.r0 = u_obs - u;
  o.r1 = v_obs - v;
  o.r2 = ur >= 0.0f ? ur - (u - k.bf * o.iz) : 0.0f;
  return o;
}

// Solve H x = rhs for a damped SPD 6x6 (mirrors pose_opt.solve6_spd). The
// factor's diagonal comes from one rsqrt each, and the eliminations and
// substitutions multiply by its reciprocal where the plain version
// divides: no division on the iteration's critical path, a few ulp apart.
__device__ __forceinline__ void chol6_solve(const float (&H)[6][6], const float (&rhs)[6],
                                            float (&x)[6]) {
  float L[6][6], inv_diag[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = H[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    const float sc = fmaxf(s, 1e-12f);
    const float inv_d = rsqrtf(sc);
    L[j][j] = sc * inv_d;
    inv_diag[j] = inv_d;
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
    y[i] = s * inv_diag[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s * inv_diag[i];
  }
}

// se(3) exp of dx = (rho, phi) -> R (row-major 3x3), t; the same Taylor
// switches as geometry/se3.exp_se3.
__device__ __forceinline__ void exp_se3(const float (&dx)[6], float (&R)[9], float (&t)[3]) {
  const float wx = dx[3], wy = dx[4], wz = dx[5];
  const float t2 = wx * wx + wy * wy + wz * wz;
  const float th = sqrtf(fmaxf(t2, 1e-8f));
  const bool small = t2 < 1e-4f;
  float sn, cs;
  sincosf(th, &sn, &cs);
  const float inv_th = __frcp_rn(th), inv_t2 = __frcp_rn(t2);
  const float a = small ? 1.0f - t2 * (1.0f / 6.0f) : sn * inv_th;
  const float b = small ? 0.5f - t2 * (1.0f / 24.0f) : (1.0f - cs) * inv_t2;
  const float c = small ? 1.0f / 6.0f - t2 * (1.0f / 120.0f) : (1.0f - a) * inv_t2;
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

// One step of the warp reduce-scatter: a lane keeps the half of v[0..2O)
// that its lane bit O selects and adds its partner's copy of that half.
template <int O>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[32], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const float send = upper ? v[k] : v[k + O];
    const float keep = upper ? v[k + O] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// Reduce-scatter of v[0..31] over the warp in 31 shuffles: lane j ends
// with the warp's sum of entry j.
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[32], int lane) {
  reduce_scatter_step<16>(v, lane);
  reduce_scatter_step<8>(v, lane);
  reduce_scatter_step<4>(v, lane);
  reduce_scatter_step<2>(v, lane);
  reduce_scatter_step<1>(v, lane);
  return v[0];
}

template <int kPer>
__global__ void __launch_bounds__(kThreads)
pose_gn_kernel(const float* __restrict__ pw, const float2* __restrict__ uv,
               const float* __restrict__ ur, const float* __restrict__ isig,
               const bool* __restrict__ mask0, const float* __restrict__ kp,
               const float* __restrict__ T0, int n, int rounds, int iters,
               float* __restrict__ T_out, bool* __restrict__ inl_out,
               float* __restrict__ chi2_out, long long* __restrict__ num_inliers) {
  __shared__ float s_part[2][kWarps][kSums];
  __shared__ int s_count[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Cam cam{kp[0], kp[1], kp[2], kp[3], kp[4]};
  const float delta_mono = sqrtf(kChi2Mono);
  const float delta_stereo = sqrtf(kChi2Stereo);

  // this thread's slots, once
  float opx[kPer], opy[kPer], opz[kPer], ou[kPer], ov[kPer], our[kPer], osg[kPer];
  unsigned m0 = 0u;  // bit k: slot k is in the initial mask
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = tid + k * kThreads;
    const bool in = i < n;
    opx[k] = in ? pw[3 * i] : 0.0f;
    opy[k] = in ? pw[3 * i + 1] : 0.0f;
    opz[k] = in ? pw[3 * i + 2] : 0.0f;
    const float2 q = in ? uv[i] : make_float2(0.0f, 0.0f);
    ou[k] = q.x;
    ov[k] = q.y;
    our[k] = in ? ur[i] : -1.0f;
    osg[k] = in ? isig[i] : 0.0f;
    if (in && mask0[i]) m0 |= 1u << k;
  }
  unsigned inl = m0;
  float T[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = k < 9 ? T0[(k / 3) * 4 + k % 3] : T0[(k - 9) * 4 + 3];

  int buf = 0;
  for (int rnd = 0; rnd < rounds; ++rnd) {
    const bool huber = rnd < 2;
    for (int it = 0; it < iters; ++it) {
      float acc[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (!(inl >> k & 1u)) continue;
        const Res o = residuals(T, opx[k], opy[k], opz[k], ou[k], ov[k], our[k], cam);
        if (!o.valid) continue;
        const bool stereo = our[k] >= 0.0f;
        float w = osg[k];
        if (huber) {
          const float chi2 = (o.r0 * o.r0 + o.r1 * o.r1 + o.r2 * o.r2) * osg[k];
          const float en = sqrtf(fmaxf(chi2, 1e-12f));
          const float delta = stereo ? delta_stereo : delta_mono;
          if (en > delta) w *= delta / en;
        }
        // J = -d(u, v, uR)/d(xi) for pc' = exp(xi) pc: rows du, dv, dur
        // times [I | -hat(pc)], negated
        const float a = cam.fx * o.iz;
        const float c = -cam.fx * o.x * o.iz2;
        const float b = cam.fy * o.iz;
        const float c2 = -cam.fy * o.y * o.iz2;
        const float c3 = c + cam.bf * o.iz2;
        const float J0[6] = {-a, 0.0f, -c, -c * o.y, -(a * o.z - c * o.x), a * o.y};
        const float J1[6] = {0.0f, -b, -c2, b * o.z - c2 * o.y, c2 * o.x, -b * o.x};
        const float s = stereo ? 1.0f : 0.0f;
        const float J2[6] = {-a * s, 0.0f, -c3 * s, -c3 * o.y * s,
                             -(a * o.z - c3 * o.x) * s, a * o.y * s};
        // J0[1] = J1[0] = J2[1] = 0: those products are left out (adding
        // an exact 0 changes no sum), and H[0][1] stays 0
        int q = 0;
#pragma unroll
        for (int j = 0; j < 6; ++j) {
#pragma unroll
          for (int l = j; l < 6; ++l, ++q) {
            if (j == 0 && l == 1) continue;
            const float h = j == 0   ? J0[0] * J0[l] + J2[0] * J2[l]
                            : j == 1 ? J1[1] * J1[l]
                                     : J0[j] * J0[l] + J1[j] * J1[l] + J2[j] * J2[l];
            acc[q] += w * h;
          }
        }
        acc[21] += w * (J0[0] * o.r0 + J2[0] * o.r2);
        acc[22] += w * (J1[1] * o.r1);
#pragma unroll
        for (int j = 2; j < 6; ++j) acc[21 + j] += w * (J0[j] * o.r0 + J1[j] * o.r1 + J2[j] * o.r2);
      }

      const float part = warp_reduce_scatter(acc, lane);
      if (lane < kSums) s_part[buf][warp][lane] = part;
      __syncthreads();
      // lane j of every warp adds the warps' partials j in warp order, and
      // the warp shares the 27 sums by shuffles: every thread of the block
      // ends with the same bits
      float mine = 0.0f;
      if (lane < kSums) {
        mine = s_part[buf][0][lane];
#pragma unroll
        for (int wp = 1; wp < kWarps; ++wp) mine += s_part[buf][wp][lane];
      }
      buf ^= 1;
      float sum[kSums];
#pragma unroll
      for (int q = 0; q < kSums; ++q) sum[q] = __shfl_sync(0xffffffffu, mine, q);

      float H[6][6];
      int q = 0;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
#pragma unroll
        for (int l = j; l < 6; ++l) {
          H[j][l] = sum[q];
          H[l][j] = sum[q];
          ++q;
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
      for (int k = 0; k < 12; ++k) T[k] = Tn[k];
    }

    // chi2 reclassification from the initial mask at the round's pose
    inl = 0u;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (!(m0 >> k & 1u)) continue;
      const Res o = residuals(T, opx[k], opy[k], opz[k], ou[k], ov[k], our[k], cam);
      const float chi2 = (o.r0 * o.r0 + o.r1 * o.r1 + o.r2 * o.r2) * osg[k];
      if (o.valid && chi2 <= (our[k] >= 0.0f ? kChi2Stereo : kChi2Mono)) inl |= 1u << k;
    }
  }

  // outputs: final chi2 (zero outside the initial mask), inlier flags,
  // their count, the pose
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = tid + k * kThreads;
    if (i >= n) continue;
    float chi2 = 0.0f;
    if (m0 >> k & 1u) {
      const Res o = residuals(T, opx[k], opy[k], opz[k], ou[k], ov[k], our[k], cam);
      chi2 = (o.r0 * o.r0 + o.r1 * o.r1 + o.r2 * o.r2) * osg[k];
    }
    chi2_out[i] = chi2;
    inl_out[i] = inl >> k & 1u;
  }
  const int count = __reduce_add_sync(0xffffffffu, __popc(inl));
  if (lane == 0) s_count[warp] = count;
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int r = q / 4, c = q % 4;
      T_out[q] = r == 3 ? (c == 3 ? 1.0f : 0.0f) : (c < 3 ? T[3 * r + c] : T[9 + r]);
    }
    long long total = 0;
    for (int wp = 0; wp < kWarps; ++wp) total += s_count[wp];
    *num_inliers = total;
  }
}

template <int kPer>
cudaError_t launch(const float* pw, const float* uv, const float* ur, const float* isig,
                   const bool* mask0, const float* kp, const float* T0, int n, int rounds,
                   int iters, float* T_out, bool* inl, float* chi2, long long* num_inliers,
                   cudaStream_t stream) {
  pose_gn_kernel<kPer><<<1, kThreads, 0, stream>>>(
      pw, reinterpret_cast<const float2*>(uv), ur, isig, mask0, kp, T0, n, rounds, iters,
      T_out, inl, chi2, num_inliers);
  return cudaGetLastError();
}

}  // namespace

// The most observation slots one launch takes (kernels.POSE_GN_MAX_SLOTS).
extern "C" int pose_gn_max_slots() { return kMaxPer * kThreads; }

// C interface (loaded with ctypes). One problem per launch: pw [n, 3],
// uv [n, 2], ur, isig [n] float32, mask0 [n] bool, kp [5] = fx, fy, cx,
// cy, bf, T0 [4, 4]; writes T_out [4, 4], inl [n], chi2 [n] and
// num_inliers (one int64). Launches on `stream`, does not synchronise,
// returns the cudaError_t of the launch (cudaErrorInvalidValue for more
// than pose_gn_max_slots() slots).
extern "C" int pose_gn(const float* pw, const float* uv, const float* ur,
                       const float* isig, const bool* mask0, const float* kp,
                       const float* T0, int n, int rounds, int iters,
                       float* T_out, bool* inl, float* chi2, long long* num_inliers,
                       void* stream) {
  const int per = n <= kThreads ? 1 : (n + kThreads - 1) / kThreads;
  const auto s = static_cast<cudaStream_t>(stream);
#define K2_CASE(P) \
  case P:          \
    return static_cast<int>(launch<P>(pw, uv, ur, isig, mask0, kp, T0, n, rounds, iters, T_out, inl, chi2, num_inliers, s));
  switch (per) {
    K2_CASE(1)
    K2_CASE(2)
    K2_CASE(3)
    K2_CASE(4)
    K2_CASE(5)
    K2_CASE(6)
    K2_CASE(7)
    K2_CASE(8)
    K2_CASE(9)
    K2_CASE(10)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K2_CASE
}
