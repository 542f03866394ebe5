// K1: all-pairs Hamming distance between packed 256-bit ORB descriptors.
//
// Replaces the TPU kernel orbslam2_tpu/ops/pallas_hamming.py (_kernel and
// distance_matrix_pallas): a [N, 8] x [M, 8] uint32 -> [N, M] int32 tile
// product of XOR + popcount.
//
// What bounds it on an H100: the output. At the main path's largest call
// (4096 local map points x 1024 frame features) it writes a 16 MB int32
// matrix while its inputs are about 160 KB, and each output costs only
// 8 XOR + 8 __popc. So the design keeps the writes coalesced: a block owns a
// 32 x 32 output tile, each warp writes 32 consecutive int32 of a row (one
// 128-byte transaction), and the two descriptor tiles are staged once per
// block in shared memory (the B tile padded to 9 words a row so the 32
// lanes of a warp read 32 different banks). The ragged edge is masked in
// the kernel; nothing is padded to whole tiles.
//
// Later work (not here): fuse the gate mask and the best/second-best
// reduction of ops/match.py:_masked_best2 so the [N, M] matrix never
// reaches device memory; the reduction must keep its tie-breaking.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;
constexpr int kTileM = 32;      // columns (B rows) per block = threads in x
constexpr int kTileN = 32;      // rows (A rows) per block
constexpr int kThreadsY = 8;    // each thread computes kTileN / kThreadsY rows

__global__ void hamming_kernel(const uint32_t* __restrict__ a,
                               const uint32_t* __restrict__ b,
                               int32_t* __restrict__ out, int n, int m) {
  __shared__ uint32_t sa[kTileN][kWords];
  __shared__ uint32_t sb[kTileM][kWords + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int row0 = blockIdx.y * kTileN;
  const int col0 = blockIdx.x * kTileM;
  const int t = ty * kTileM + tx;  // 0 .. 255

  // 256 threads stage 32 x 8 words of A and 32 x 8 words of B.
  {
    const int r = t / kWords;
    const int w = t % kWords;
    const int ga = row0 + r;
    const int gb = col0 + r;
    sa[r][w] = ga < n ? a[static_cast<size_t>(ga) * kWords + w] : 0u;
    sb[r][w] = gb < m ? b[static_cast<size_t>(gb) * kWords + w] : 0u;
  }
  __syncthreads();

  const int col = col0 + tx;
  if (col >= m) return;
  uint32_t bw[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) bw[w] = sb[tx][w];
#pragma unroll
  for (int i = 0; i < kTileN / kThreadsY; ++i) {
    const int r = ty + i * kThreadsY;
    const int row = row0 + r;
    if (row < n) {
      int acc = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) acc += __popc(sa[r][w] ^ bw[w]);
      out[static_cast<size_t>(row) * m + col] = acc;
    }
  }
}

}  // namespace

// C interface (loaded with ctypes). Launches on `stream`, does not
// synchronise, returns the cudaError_t of the launch.
extern "C" int hamming_distance_matrix(const uint32_t* a, const uint32_t* b,
                                       int32_t* out, int n, int m,
                                       void* stream) {
  const dim3 block(kTileM, kThreadsY);
  const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN);
  hamming_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, n, m);
  return static_cast<int>(cudaGetLastError());
}
