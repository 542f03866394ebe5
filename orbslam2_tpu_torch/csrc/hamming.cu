// K1: all-pairs Hamming distance between packed 256-bit ORB descriptors.
//
// Replaces the TPU kernel orbslam2_tpu/ops/pallas_hamming.py:55
// (distance_matrix_pallas, body _kernel at :38): a [N, 8] x [M, 8] uint32
// -> [N, M] int32 tile product of XOR + popcount.
//
// What bounds it on an H100: the output. It reads 32 (N + M) bytes and
// writes 4 N M: at the main path's largest call (4096 local map points x
// 1024 frame features) 16.9 MB, 5.06 us at 3.35 TB/s. As a +-1 product it
// needs 2 * 256 * N * M operations, 1.09 us on the int8 tensor cores at
// their wgmma rate; as XOR + popcount, 8 __popc per output at 16 a clock
// per SM, about 8 us, so a popcount kernel cannot reach the output bound.
//
// The design:
// - Arithmetic on the int8 tensor cores: with s = 1 - 2 bit,
//   d = (256 - <sa, sb>) / 2, exact in s32 (the dot lies in [-256, 256]).
//   Word s of a descriptor is k-step s of a k32 product.
// - wgmma, not mma.sync: one warpgroup (4 warps, 16 rows each) owns a
//   64 x 32 output tile and runs eight wgmma.m64n32k32.s8 on it. The
//   mma.sync.m16n8k32 route was slower than the earlier popcount kernel at
//   1024 x 1024 (PERF.md): without its global stores it took as long as
//   the whole kernel, so its products (128 mma.sync a warp, one block of
//   4 warps an SM, the stores after them) were the kernel's time.
// - A from registers: each lane loads the packed words of its two rows
//   and expands the bits its fragment needs in registers. A fragment
//   register holds 4 k of one row, and the k -> bit map puts bits p, p + 8,
//   p + 16, p + 24 of the word there (p = lane % 4 + 4 h for register half
//   h): one shift puts them on the byte sign bits and one prmt replicates
//   each sign over its byte, 3 instructions for 4 s8.
// - B from shared memory: the block expands its 32 descriptors once, with
//   the same map, into the no-swizzle K-major layout wgmma reads (8 x 16
//   byte core matrices, the two of a k-step 128 bytes apart, the four
//   8-row groups 256 bytes apart), 8 KB.
// - Small tiles, many blocks: 64 x 32 gives 512 blocks of 128 threads at
//   1024 x 1024 (4 an SM), so one block's stores overlap another's loads
//   and products. 64 x 16, 64 x 64 and 64 x 128 tiles were slower at every
//   path shape (PERF.md).
// - Every global load is issued before any expansion, so their latencies
//   overlap.
// - Epilogue for the write bound: after the products the B region holds
//   each warp's 16 x 32 results (16-byte chunks swizzled by row, so the
//   eight rows an int2 write touches fall in different banks), and 8
//   lanes store each 128-byte row as 16-byte vectors. Rows with M not a
//   multiple of 4 take scalar stores.
// - Ragged edges are masked in the kernel: rows and columns past N and M
//   are neither read (zero-filled) nor written.
//
// Later work (not here): fuse the gate mask and the best/second-best
// reduction of ops/match.py:_masked_best2 so the [N, M] matrix never
// reaches device memory; the reduction must keep its tie-breaking.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;                // output rows per block: one warpgroup
constexpr int kBN = 32;                // output columns per block
constexpr int kThreads = 128;
constexpr int kStepBytes = kBN * 32;   // one k-step of the expanded B tile

// bits p, p + 8, p + 16, p + 24 of w -> 4 s8 lanes: -1 where the bit is
// set, +1 where it is clear
__device__ __forceinline__ uint32_t expand_pm1(uint32_t w, int p) {
  const uint32_t x = w << (7 - p);
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(x), "r"(0u), "r"(0xBA98u));
  return d | 0x01010101u;
}

// shared-memory matrix descriptor: no swizzle, leading (k) byte offset
// 128, stride (8-row group) byte offset 256
__device__ __forceinline__ uint64_t b_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr >> 4) & 0x3FFFu) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// d (+)= A (4 s8 registers a lane) x B (the descriptor's 32 x 32 tile)
__device__ __forceinline__ void wgmma_n32(int (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__global__ void __launch_bounds__(kThreads)
hamming_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
               int32_t* __restrict__ out, int n, int m) {
  __shared__ __align__(128) uint8_t sb[8 * kStepBytes];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // loads: this lane's A rows g and g + 8 of its warp, and one half of
  // one B row (threads 0..63)
  const int rlo = row0 + 16 * warp + g, rhi = rlo + 8;
  uint4 lo[2], hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lo[h] = rlo < n ? a[static_cast<size_t>(rlo) * 2 + h] : zero;
    hi[h] = rhi < n ? a[static_cast<size_t>(rhi) * 2 + h] : zero;
  }
  const int br = tid >> 1, bh = tid & 1;
  const bool b_unit = tid < 2 * kBN;
  const uint4 bv = b_unit && col0 + br < m ? b[static_cast<size_t>(col0 + br) * 2 + bh] : zero;

  // B: words 4 bh .. 4 bh + 3 of row br, each k-step's 32 s8 as two core
  // matrix rows of 16
  if (b_unit) {
    const uint32_t w[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint8_t* p = sb + (4 * bh + j) * kStepBytes + (br >> 3) * 256 + (br & 7) * 16;
      *reinterpret_cast<uint4*>(p) = make_uint4(expand_pm1(w[j], 0), expand_pm1(w[j], 1),
                                                expand_pm1(w[j], 2), expand_pm1(w[j], 3));
      *reinterpret_cast<uint4*>(p + 128) = make_uint4(expand_pm1(w[j], 4), expand_pm1(w[j], 5),
                                                      expand_pm1(w[j], 6), expand_pm1(w[j], 7));
    }
  }
  // the generic-proxy writes above must be visible to wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  // A fragments of the eight k-steps: rows g, g + 8; k 4t.., 16 + 4t..
  const uint32_t wl[8] = {lo[0].x, lo[0].y, lo[0].z, lo[0].w, lo[1].x, lo[1].y, lo[1].z, lo[1].w};
  const uint32_t wh[8] = {hi[0].x, hi[0].y, hi[0].z, hi[0].w, hi[1].x, hi[1].y, hi[1].z, hi[1].w};
  uint32_t af[8][4];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    af[s][0] = expand_pm1(wl[s], t);
    af[s][1] = expand_pm1(wh[s], t);
    af[s][2] = expand_pm1(wl[s], t + 4);
    af[s][3] = expand_pm1(wh[s], t + 4);
  }
  __syncthreads();

  int d[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = 0;
  const uint32_t sb_addr = static_cast<uint32_t>(__cvta_generic_to_shared(sb));
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < 8; ++s) wgmma_n32(d, af[s], b_desc(sb_addr + s * kStepBytes), s > 0);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  __syncthreads();  // every warp's products have read the B tile

  // epilogue: d = (256 - dot) / 2; d[4j..4j+3] are rows g, g + 8 and
  // columns 8j + 2t, + 1 of this warp's 16 x 32. Staged in the B region,
  // 16-byte chunk c of row r at c ^ (r & 7).
  int32_t* st = reinterpret_cast<int32_t*>(sb) + warp * 16 * kBN;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int off = (((2 * j + (t >> 1)) ^ g) << 2) + (t & 1) * 2;
    *reinterpret_cast<int2*>(&st[g * kBN + off]) =
        make_int2((256 - d[4 * j]) >> 1, (256 - d[4 * j + 1]) >> 1);
    *reinterpret_cast<int2*>(&st[(g + 8) * kBN + off]) =
        make_int2((256 - d[4 * j + 2]) >> 1, (256 - d[4 * j + 3]) >> 1);
  }
  __syncwarp();
  const bool vec = (m & 3) == 0;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int r = it * 4 + (lane >> 3), c4 = (lane & 7) * 4;
    const int row = row0 + 16 * warp + r, col = col0 + c4;
    if (row < n && col < m) {
      const int4 v = *reinterpret_cast<const int4*>(&st[r * kBN + (((c4 >> 2) ^ (r & 7)) << 2)]);
      int32_t* dst = out + static_cast<size_t>(row) * m + col;
      if (vec) {
        *reinterpret_cast<int4*>(dst) = v;
      } else {
        dst[0] = v.x;
        if (col + 1 < m) dst[1] = v.y;
        if (col + 2 < m) dst[2] = v.z;
        if (col + 3 < m) dst[3] = v.w;
      }
    }
  }
}

}  // namespace

// C interface (loaded with ctypes). a [n, 8] and b [m, 8] uint32 words,
// out [n, m] int32, n and m >= 1. Launches on `stream`, does not
// synchronise, returns the cudaError_t of the launch.
extern "C" int hamming_distance_matrix(const uint32_t* a, const uint32_t* b,
                                       int32_t* out, int n, int m,
                                       void* stream) {
  const dim3 grid((m + kBN - 1) / kBN, (n + kBM - 1) / kBM);
  hamming_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(a), reinterpret_cast<const uint4*>(b), out, n, m);
  return static_cast<int>(cudaGetLastError());
}
