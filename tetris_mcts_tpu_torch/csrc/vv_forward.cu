// The VV net's forward straight from bit-packed boards, hand-written for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (tetris_mcts_tpu_torch/ops/build.py, ops/vv_forward.py).
//
// Replaces the Pallas TPU kernel of tetris_mcts_tpu/ops/vv_forward.py
// (`_kernel` -> `_forward_block`, launched by `vv_forward_packed`):
//
//   packed u32[20] -> image {0, 1 locked, -1 piece}   (the piece bit wins)
//   -> conv 3x3 1->32 + ReLU   20x10 -> 18x8
//   -> conv 3x3 32->32 + ReLU  18x8  -> 16x6
//   -> conv 3x3 32->32 + ReLU  16x6  -> 14x4
//   -> FC 1792 -> 256 + ReLU -> FC 256 -> 2 -> sigmoid * ubound + lbound
//
// Weights are the port's VVNet (models/nets.py) as they are: conv weights
// OIHW, fc weights (out, in), and fc1's input in the NCHW flatten order
// (c, y, x) that `params_from_jax` gives them.
//
// What bounds it on this card: operations. A board takes 1,901,568
// multiply-adds (3.8 MFLOP) and moves 80 bytes in and 8 out; the weights are
// 1.9 MB. Float32 throughout, on the FMA units (TF32 would not hold VVNet's
// tolerance). Two launches:
//
// 1. vv_conv_kernel, the conv ladder. A block of 256 threads stages the
//    three conv kernels once, transposed to [c_in][tap][c_out] (through a
//    padded copy, so neither the loads nor the stores share a bank), and runs
//    its boards one after another; the host picks boards per block so that
//    one wave of blocks covers the SMs. Where two blocks a board still fit
//    in the SMs (n <= 66 on the H100), each of the two computes half of
//    conv3's rows and the conv1/conv2 rows under them. Each thread computes
//    a register tile of P positions x 8 output channels (P = 4, 3, 2 for
//    conv1-3 on whole boards, the best of the tiles timed on the H100;
//    4, 2, 1 on half boards, which have fewer positions): per (c_in, tap) it
//    loads P activations (CHW layout, so the warp's lanes read consecutive
//    positions) and 8 weights as two float4 (the warp's lanes share them: a
//    broadcast), for 8P multiply-adds. 104 KB of shared memory a block, so
//    two blocks share an SM. conv3 writes each board's 1792 features, in
//    fc1's (c, y, x) order, to a scratch tensor (n x 7 KB, it stays in L2).
// 2. vv_fc_kernel, FC1 + FC2 over tiles of 16 boards. A cluster of 8 blocks
//    takes a tile; block r computes hidden units 32r..32r+31, streaming its
//    rows of wf1 through shared memory in chunks of 256 inputs (the next
//    chunk's loads in flight in registers while the current one is
//    multiplied), so the 1.8 MB of wf1 is read once a tile. A lane holds
//    8 boards x 2 units (two weights and two float4 of features feed 16
//    multiply-adds); each of the block's 16 warps takes a slice of every
//    chunk, and the warps' sums are added at the end. The tile's 256 hidden
//    units stay in the cluster's shared memory; block 0 reads them through
//    distributed shared memory and runs FC2, the sigmoid and
//    * ubound + lbound as the epilogue.
//
// What holds it above its bound (chip_smoke.py on the H100): at 64 boards a
// block's one board (or half board) is a chain of dependent shared-memory
// loads and FMAs with few warps to hide them (one board alone takes ~0.02 ms
// in each kernel); at 448 and more, the FC's 1792-long sums over 16-board
// tiles, in 83 registers a thread, leave one 512-thread block an SM.
//
// Built without --fmad=false: its contract is a tolerance, not
// bit-exactness (ops/build.py).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace tmt_vv {

constexpr int kC = 32;  // conv channels
constexpr int kH0 = 20, kW0 = 10;
constexpr int kH1 = 18, kW1 = 8;
constexpr int kH2 = 16, kW2 = 6;
constexpr int kH3 = 14, kW3 = 4;
constexpr int kFeat = kC * kH3 * kW3;  // 1792
constexpr int kHid = 256;
constexpr int kOut = 2;

// ---- the conv ladder --------------------------------------------------------
constexpr int kConvThreads = 256;
constexpr int kCoTile = 8;  // output channels a thread
// shared memory, in floats: w2T, w3T, w1T, image, a1, a2 (float4-aligned);
// image, a1 and a2 are contiguous and hold 16 padded weight rows while the
// weights are staged
constexpr int kSmW = kC * 9 * kC;
constexpr int kSmW1 = 9 * kC;
constexpr int kSmImg = kH0 * kW0;
constexpr int kSmA1 = kC * kH1 * kW1;
constexpr int kSmA2 = kC * kH2 * kW2;
constexpr int kConvSmBytes = (2 * kSmW + kSmW1 + kSmImg + kSmA1 + kSmA2) * 4;
static_assert(kSmImg + kSmA1 + kSmA2 >= (kC / 2) * (kC * 9 + 1), "staging room");

// One 3x3 VALID conv, Ci -> 32 channels, + bias + ReLU, on Ho output rows
// of width Wo. in is channel-major with rows of Wi and InCS floats a
// channel; wT is [ci * 9 + tap][co]; out is channel-major with OutCS floats
// a channel (shared memory, or the global features). A thread takes
// positions g, g + NG, ..., g + (P-1) NG of one group of 8 output channels;
// g runs fastest over the threads, so a warp reads consecutive positions and
// shares its weights.
template <int Ci, int InCS, int Wi, int Ho, int Wo, int OutCS, int P>
__device__ __forceinline__ void conv_layer(const float* in, const float* wT,
                                           const float* __restrict__ bias,
                                           float* out) {
  constexpr int NP = Ho * Wo;
  static_assert(NP % P == 0, "positions must split into P groups");
  constexpr int NG = NP / P;
  constexpr int kItems = NG * (kC / kCoTile);
  for (int item = threadIdx.x; item < kItems; item += kConvThreads) {
    const int g = item % NG, c0 = (item / NG) * kCoTile;
    int off[P];
    float acc[P][kCoTile];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int p = g + k * NG;
      off[k] = (p / Wo) * Wi + p % Wo;
#pragma unroll
      for (int e = 0; e < kCoTile; ++e) acc[k][e] = bias[c0 + e];
    }
#pragma unroll 2
    for (int ci = 0; ci < Ci; ++ci) {
      const float* a = in + ci * InCS;
      const float* w = wT + ci * 9 * kC + c0;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float4 wa = *reinterpret_cast<const float4*>(w + tap * kC);
        const float4 wb = *reinterpret_cast<const float4*>(w + tap * kC + 4);
        const float wv[kCoTile] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
        const int shift = (tap / 3) * Wi + tap % 3;
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const float av = a[off[k] + shift];
#pragma unroll
          for (int e = 0; e < kCoTile; ++e) acc[k][e] += av * wv[e];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
      for (int e = 0; e < kCoTile; ++e)
        out[(c0 + e) * OutCS + g + k * NG] = fmaxf(acc[k][e], 0.0f);
  }
}

// Stage a 32 -> 32 OIHW conv kernel into shared memory as [ci * 9 + tap][co].
// A direct transposing copy would have the warp's lanes (consecutive taps of
// one output channel) store 32 words apart, all to one bank. So each half of
// the output channels is first copied row by row into tmp with rows padded
// to 289 words (coalesced loads, consecutive banks), then read down the
// columns, where the padding puts the lanes on different banks.
__device__ __forceinline__ void stage_transposed(const float* __restrict__ w,
                                                 float* wT, float* tmp) {
  constexpr int kR = kC * 9, kPad = kR + 1, kHalf = kC / 2;
  for (int h = 0; h < 2; ++h) {
    const float* src = w + h * kHalf * kR;
    for (int i = threadIdx.x; i < kHalf * kR; i += kConvThreads) {
      const int co = i / kR;
      tmp[co * kPad + i - co * kR] = src[i];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kHalf * kR; i += kConvThreads) {
      const int co = i % kHalf, r = i / kHalf;
      wT[r * kC + h * kHalf + co] = tmp[co * kPad + r];
    }
    __syncthreads();
  }
}

// The conv ladder for kRows3 of conv3's 14 output rows: 14 (a block takes
// whole boards) or 7 (two blocks share a board, each computing the conv1
// and conv2 rows its half needs, 2 rows of halo a layer). Register tiles
// P1-P3 of the three layers follow the rows: the split keeps enough work
// items a layer for the block's threads.
template <int kRows3, int P1, int P2, int P3>
__global__ void __launch_bounds__(kConvThreads)
vv_conv_kernel(const uint32_t* __restrict__ packed, int n, int per_block,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ w2, const float* __restrict__ b2,
               const float* __restrict__ w3, const float* __restrict__ b3,
               float* __restrict__ feat) {
  constexpr int kParts = kH3 / kRows3;
  constexpr int kRows2 = kRows3 + 2, kRows1 = kRows3 + 4, kRows0 = kRows3 + 6;
  static_assert(kParts * kRows3 == kH3, "conv3 rows split evenly");
  extern __shared__ __align__(16) float sm[];
  float* w2T = sm;
  float* w3T = w2T + kSmW;
  float* w1T = w3T + kSmW;
  float* img = w1T + kSmW1;
  float* a1 = img + kSmImg;
  float* a2 = a1 + kSmA1;
  const int tid = threadIdx.x;
  const int row0 = (blockIdx.x % kParts) * kRows3;  // first conv3 row (and input row)

  // weights: OIHW (co, ci, dy, dx) -> [ci * 9 + dy * 3 + dx][co], through
  // the activation buffers (free until the first board)
  stage_transposed(w2, w2T, img);
  stage_transposed(w3, w3T, img);
  for (int i = tid; i < kSmW1; i += kConvThreads) {
    const int co = i / 9, tap = i - co * 9;
    w1T[tap * kC + co] = w1[i];
  }

  const int first = blockIdx.x / kParts * per_block;
  const int last = min(first + per_block, n);
  for (int bd = first; bd < last; ++bd) {
    __syncthreads();  // weights staged; the last board's conv3 has read a2
    for (int i = tid; i < kRows0 * kW0; i += kConvThreads) {
      const int r = i / kW0, col = i - r * kW0;
      const uint32_t w = packed[(size_t)bd * kH0 + row0 + r];
      img[i] = ((w >> (col + 10)) & 1u) ? -1.0f : (float)((w >> col) & 1u);
    }
    __syncthreads();
    conv_layer<1, 0, kW0, kRows1, kW1, kRows1 * kW1, P1>(img, w1T, b1, a1);
    __syncthreads();
    conv_layer<kC, kRows1 * kW1, kW1, kRows2, kW2, kRows2 * kW2, P2>(a1, w2T, b2, a2);
    __syncthreads();
    // conv3 rows row0.. straight into fc1's (c, y, x) order
    conv_layer<kC, kRows2 * kW2, kW2, kRows3, kW3, kH3 * kW3, P3>(
        a2, w3T, b3, feat + (size_t)bd * kFeat + row0 * kW3);
  }
}

// Launch one form of the conv ladder: kRows3 = kH3 for whole boards a
// block, kH3 / 2 for half a board a block.
template <int kRows3, int P1, int P2, int P3>
cudaError_t launch_conv(int grid, int per_block, cudaStream_t stream,
                        const uint32_t* packed, int n, const float* w1,
                        const float* b1, const float* w2, const float* b2,
                        const float* w3, const float* b3, float* feat) {
  cudaError_t err = cudaFuncSetAttribute(vv_conv_kernel<kRows3, P1, P2, P3>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kConvSmBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(vv_conv_kernel<kRows3, P1, P2, P3>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  vv_conv_kernel<kRows3, P1, P2, P3><<<grid, kConvThreads, kConvSmBytes, stream>>>(
      packed, n, per_block, w1, b1, w2, b2, w3, b3, feat);
  return cudaGetLastError();
}

// ---- FC1 + FC2 ----------------------------------------------------------------
constexpr int kFcBoards = 16;  // boards a tile
constexpr int kFcUnits = 32;   // hidden units a block
constexpr int kFcCluster = kHid / kFcUnits;  // 8 blocks a tile
constexpr int kFcThreads = 512;
constexpr int kFcWarps = kFcThreads / 32;  // each on a slice of every chunk
constexpr int kKc = 256;                   // inputs a chunk
constexpr int kKw = kKc / kFcWarps;        // inputs a warp, a chunk
static_assert(kFeat % kKc == 0 && kKc % kFcWarps == 0, "chunks split evenly");
static_assert((kFcUnits * kKc / 4) % kFcThreads == 0 &&
                  (kFcBoards * kKc / 4) % kFcThreads == 0,
              "every thread loads whole float4s of each chunk");
constexpr int kWsStride = kFcUnits + 1;
// shared memory, in floats: fs [k][board], ws [k][unit] (padded), hid
// [board][unit]; after the last chunk fs and ws hold each warp's sums
constexpr int kFcSmBytes =
    (kKc * kFcBoards + kKc * kWsStride + kFcBoards * kFcUnits) * 4;
static_assert(kKc * (kFcBoards + kWsStride) >= kFcWarps * kFcBoards * kFcUnits,
              "room for the warps' sums");

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __cluster_dims__(kFcCluster, 1, 1) __launch_bounds__(kFcThreads)
vv_fc_kernel(const float* __restrict__ feat, int n,
             const float* __restrict__ wf1, const float* __restrict__ bf1,
             const float* __restrict__ wf2, const float* __restrict__ bf2,
             const float* __restrict__ ubound, const float* __restrict__ lbound,
             float* __restrict__ out) {
  extern __shared__ __align__(16) float fc_sm[];
  float* fs = fc_sm;                             // [k][board]
  float* ws = fs + kKc * kFcBoards;              // [k][unit]
  float* hid = ws + kKc * kWsStride;             // [board][unit]
  float* red = fc_sm;                            // [warp][board][unit], at the end
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int j0 = rank * kFcUnits;
  const int b0 = blockIdx.y * kFcBoards;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // a lane's tile: units u and u + 16 of the block, boards 8h .. 8h + 7
  const int u = lane & 15, h = lane >> 4;

  // chunk loads: each thread moves kWLoads float4 of wf1 rows and kFLoads
  // of features a chunk; the next chunk's loads are in flight while the
  // current chunk is multiplied
  constexpr int kWLoads = kFcUnits * kKc / 4 / kFcThreads;
  constexpr int kFLoads = kFcBoards * kKc / 4 / kFcThreads;
  float4 wreg[kWLoads], freg[kFLoads];
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int i = tid + j * kFcThreads;
      const int uu = i / (kKc / 4), q = i % (kKc / 4);
      wreg[j] = *reinterpret_cast<const float4*>(
          wf1 + (size_t)(j0 + uu) * kFeat + k0 + 4 * q);
    }
#pragma unroll
    for (int j = 0; j < kFLoads; ++j) {
      const int i = tid + j * kFcThreads;
      const int bb = i % kFcBoards, q = i / kFcBoards;
      freg[j] = b0 + bb < n ? *reinterpret_cast<const float4*>(
                                  feat + (size_t)(b0 + bb) * kFeat + k0 + 4 * q)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };

  float acc[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.0f;
  load_chunk(0);
  for (int k0 = 0; k0 < kFeat; k0 += kKc) {
    __syncthreads();  // the last chunk's products have read ws and fs
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int i = tid + j * kFcThreads;
      const int uu = i / (kKc / 4), q = i % (kKc / 4);
      ws[(4 * q + 0) * kWsStride + uu] = wreg[j].x;
      ws[(4 * q + 1) * kWsStride + uu] = wreg[j].y;
      ws[(4 * q + 2) * kWsStride + uu] = wreg[j].z;
      ws[(4 * q + 3) * kWsStride + uu] = wreg[j].w;
    }
#pragma unroll
    for (int j = 0; j < kFLoads; ++j) {
      const int i = tid + j * kFcThreads;
      const int bb = i % kFcBoards, q = i / kFcBoards;
      fs[(4 * q + 0) * kFcBoards + bb] = freg[j].x;
      fs[(4 * q + 1) * kFcBoards + bb] = freg[j].y;
      fs[(4 * q + 2) * kFcBoards + bb] = freg[j].z;
      fs[(4 * q + 3) * kFcBoards + bb] = freg[j].w;
    }
    __syncthreads();
    if (k0 + kKc < kFeat) load_chunk(k0 + kKc);
#pragma unroll 4
    for (int kk = warp * kKw; kk < (warp + 1) * kKw; ++kk) {
      const float w0 = ws[kk * kWsStride + u];
      const float w1 = ws[kk * kWsStride + u + 16];
      const float4 fa = *reinterpret_cast<const float4*>(fs + kk * kFcBoards + 8 * h);
      const float4 fb = *reinterpret_cast<const float4*>(fs + kk * kFcBoards + 8 * h + 4);
      const float f[8] = {fa.x, fa.y, fa.z, fa.w, fb.x, fb.y, fb.z, fb.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        acc[0][e] += w0 * f[e];
        acc[1][e] += w1 * f[e];
      }
    }
  }
  __syncthreads();  // the products are done with fs and ws: they hold red now
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      red[(warp * kFcBoards + 8 * h + e) * kFcUnits + u + 16 * i] = acc[i][e];
  __syncthreads();
  for (int o = tid; o < kFcBoards * kFcUnits; o += kFcThreads) {
    float sum = red[o];
#pragma unroll
    for (int w = 1; w < kFcWarps; ++w) sum += red[w * kFcBoards * kFcUnits + o];
    hid[o] = fmaxf(sum + bf1[j0 + o % kFcUnits], 0.0f);
  }
  cluster.sync();  // every block's hidden units are written

  if (rank == 0) {  // FC2 + sigmoid * ubound + lbound: a warp per output
    for (int q = warp; q < kFcBoards * kOut; q += kFcWarps) {
      const int bb = q / kOut, o = q % kOut;
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < kFcCluster; ++r) {
        const float* hr = cluster.map_shared_rank(hid, r);
        s += wf2[o * kHid + r * kFcUnits + lane] * hr[bb * kFcUnits + lane];
      }
      s = warp_sum(s);
      if (lane == 0 && b0 + bb < n) {
        const float z = s + bf2[o];
        out[(size_t)(b0 + bb) * kOut + o] = 1.0f / (1.0f + expf(-z)) * ubound[o] + lbound[o];
      }
    }
  }
  cluster.sync();  // block 0 has read the others' shared memory
}

}  // namespace tmt_vv

using namespace tmt_vv;

extern "C" {

// out (n, 2) float32 = [value, variance] per board; feat is an (n, 1792)
// float32 scratch.
int vv_forward(const void* packed, const void* w1, const void* b1,
               const void* w2, const void* b2, const void* w3, const void* b3,
               const void* wf1, const void* bf1, const void* wf2,
               const void* bf2, const void* ubound, const void* lbound,
               void* feat, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* pk = (const uint32_t*)packed;
  const float *cw1 = (const float*)w1, *cb1 = (const float*)b1;
  const float *cw2 = (const float*)w2, *cb2 = (const float*)b2;
  const float *cw3 = (const float*)w3, *cb3 = (const float*)b3;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (2 * n <= sms) {  // two blocks a board still fit in the SMs
    err = launch_conv<kH3 / 2, 4, 2, 1>(2 * n, 1, st, pk, n, cw1, cb1, cw2, cb2, cw3,
                                        cb3, (float*)feat);
  } else {  // whole boards, as few a block as keep the grid in one wave
    err = cudaFuncSetAttribute(vv_conv_kernel<kH3, 4, 3, 2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kConvSmBytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, vv_conv_kernel<kH3, 4, 3, 2>, kConvThreads, kConvSmBytes);
    if (err != cudaSuccess) return (int)err;
    const int slots = max(sms * per_sm, 1);
    const int per_block = (n + slots - 1) / slots;
    err = launch_conv<kH3, 4, 3, 2>((n + per_block - 1) / per_block, per_block, st, pk, n,
                                    cw1, cb1, cw2, cb2, cw3, cb3, (float*)feat);
  }
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(vv_fc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kFcSmBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 fc_grid(kFcCluster, (n + kFcBoards - 1) / kFcBoards);
  vv_fc_kernel<<<fc_grid, kFcThreads, kFcSmBytes, (cudaStream_t)stream>>>(
      (const float*)feat, n, (const float*)wf1, (const float*)bf1,
      (const float*)wf2, (const float*)bf2, (const float*)ubound,
      (const float*)lbound, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
