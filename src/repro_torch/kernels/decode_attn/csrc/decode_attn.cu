// Contiguous GQA flash decode for Hopper (sm_90a): one new token per row
// against a (B, S, KV, hd) KV cache at one scalar position.
//
// Replaces the TPU kernel repro/kernels/decode_attn/kernel.py:_kernel
// (entered through decode_attn_pallas). Same function: for each row b
// and KV head, the G = H / KV query heads of the group attend over the
// cache slots that the scalar position pos makes valid, with the masks of
// kernel.py:52-58:
//   kv_pos = ring ? pos - ((pos - slot) mod S) : slot
//   valid  = kv_pos >= 0 && kv_pos <= pos && slot < S
//            && (window <= 0 || pos - kv_pos < window)
// Online softmax in fp32 with NEG = -2^30, l clamped to >= 1e-30, fp32
// output (B, H, hd).
//
// Design. The TPU grid carries (m, l, acc) in VMEM scratch across a
// sequential S-tile axis. Hopper blocks run in no set order, so here one
// thread block owns one (row b, KV head, tile of up to 16 query heads)
// and walks the S tiles (kTileS slots each) itself, through the tile
// loop shared with the paged kernel (../../csrc/attn_tile.cuh); the
// group's query heads share each K/V tile. The mask gates every slot: a
// slot that is not valid is never loaded (it reads as zero), scores NEG
// and adds exactly 0 to l and acc, so stale or non-finite data past pos
// in a reused or compacted cache cannot reach the sum. Outside ring mode
// only the tiles between the window's first slot and pos are walked.
//
// Bound on this card: decode reads each valid K/V slot once per (row,
// KV head) and does ~2 G FLOPs per byte read, far below the H100's ~295
// bf16 FLOP/byte ridge, so the bound is the bytes of the valid K/V slots
// over 3.35 TB/s. This first kernel does not reach it: the tiles are
// loaded and consumed in turn with nothing overlapped (no cp.async or
// TMA), the products run on the CUDA cores, and a (B, KV) grid fills a
// few of the 132 SMs at serving batch sizes. Splitting S across blocks
// with a combine step, TMA and wgmma are later work.

#include <algorithm>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace {

using attn_tile::kRowTile;
using attn_tile::kThreads;

constexpr int kTileS = 64;              // cache slots a shared-memory tile

static_assert(attn_tile::smem_floats(128, kTileS) * sizeof(float)
                  <= attn_tile::kSmemLimit,
              "the S tile must fit a block's shared memory at hd 128");

// The TPU kernel's mask (kernel.py:52-58) for one cache slot.
__device__ __forceinline__ bool slot_valid(int slot, int pos, int S,
                                           int window, bool ring) {
  int kv_pos = slot;
  if (ring) {
    int d = (pos - slot) % S;   // floor mod, as jnp.mod: 0 <= d < S
    if (d < 0) d += S;
    kv_pos = pos - d;
  }
  bool ok = kv_pos >= 0 && kv_pos <= pos && slot < S;
  if (window > 0) ok = ok && (pos - kv_pos) < window;
  return ok;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q,       // (B, H, HD)
                   const T* __restrict__ k,       // (B, S, KV, HD)
                   const T* __restrict__ v,       // (B, S, KV, HD)
                   float* __restrict__ out,       // (B, H, HD)
                   int S, int H, int KV, int pos, int window, int ring,
                   int tile_lo, int tile_hi, float scale) {
  const int G = H / KV;
  const int b = blockIdx.z;
  const int kv = blockIdx.y;
  const int r0 = blockIdx.x * kRowTile;
  const bool is_ring = ring != 0;
  // query row r is head kv * G + r0 + r
  auto row_off = [=](int r) {
    return ((long long)b * H + kv * G + r0 + r) * HD;
  };

  extern __shared__ float smem[];
  attn_tile::Block<HD> blk(smem, kTileS, min(kRowTile, G - r0), q, row_off);
  for (int tile = tile_lo; tile <= tile_hi; ++tile) {
    const int s0 = tile * kTileS;
    auto slot_off = [=](int t) -> long long {
      if (!slot_valid(s0 + t, pos, S, window, is_ring)) return -1;
      return (((long long)b * S + s0 + t) * KV + kv) * HD;
    };
    auto valid = [=](int, int j) {
      return slot_valid(s0 + j, pos, S, window, is_ring);
    };
    blk.step(k, v, kTileS, scale, slot_off, valid);
  }
  blk.store(out, row_off);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, float* out, int B,
           int S, int H, int KV, int pos, int window, int ring,
           cudaStream_t stream) {
  const int smem = attn_tile::smem_floats(HD, kTileS) * (int)sizeof(float);
  auto kernel = decode_attn_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // tiles holding a valid slot: in ring mode any slot may be; otherwise
  // the slots from the window's first position up to pos
  int tile_lo = 0, tile_hi = (S - 1) / kTileS;
  if (!ring) {
    const int lo = window > 0 ? std::max(0, pos - window + 1) : 0;
    tile_lo = lo / kTileS;
    tile_hi = std::min(pos, S - 1) / kTileS;
  }
  const int G = H / KV;
  dim3 grid((G + kRowTile - 1) / kRowTile, KV, B);
  const float scale = 1.0f / sqrtf((float)HD);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, S, H, KV, pos, window, ring, tile_lo,
      tile_hi, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Error codes below cudaSuccess's range are the wrapper's own refusals.
constexpr int kErrUnsupported = -1;

extern "C" {

// Cache slots one shared-memory tile holds (the S tile).
int decode_attn_tile_s() { return kTileS; }

const char* decode_attn_error_string(int code) {
  if (code == kErrUnsupported)
    return "unsupported dtype / head dim (bf16 or fp32, hd 64 or 128)";
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = fp32, 1 = bf16 (q, k and v share it); ring: 0 or 1. Returns
// 0 on a successful launch, else a CUDA error code or a negative refusal.
int decode_attn_fwd(const void* q, const void* k, const void* v, void* out,
                    int B, int S, int H, int KV, int hd, int pos, int window,
                    int ring, int dtype, void* stream) {
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, S, H, KV, pos, window,
                                      ring, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, S, H, KV, pos, window,
                                     ring, s);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, o, B, S, H, KV, pos, window, ring, s);
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, o, B, S, H, KV, pos, window, ring, s);
  return kErrUnsupported;
}

}  // extern "C"
