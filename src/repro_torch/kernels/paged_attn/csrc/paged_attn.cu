// Paged GQA flash attention for Hopper (sm_90a), decode and chunk prefill.
//
// Replaces the TPU kernel repro/kernels/decode_attn/kernel.py:_paged_kernel
// (entered through paged_decode_attn_pallas, C = 1, and
// paged_prefill_attn_pallas, C tokens). Same function: for each row b and
// KV head, R = C * G query rows (row r is chunk token r / G, head
// kv * G + r % G, at absolute position pos0[b] + r / G) attend over the
// pages named by block_tables[b, :] with the mask kv_pos <= qpos; online
// softmax in fp32 with NEG = -2^30, all-masked tiles guarded, l clamped to
// >= 1e-30; fp32 output.
//
// Design. The TPU grid walks pages sequentially and carries (m, l, acc) in
// VMEM scratch; here one thread block owns one (row b, KV head, tile of 16
// query rows) and loops over the pages itself, one page a tile of the
// loop shared with the contiguous decode kernel (../../csrc/attn_tile.cuh).
// The block reads its own block-table row and pos0 (no scalar prefetch).
// It stops at the page holding the tile's last query position: later
// pages are fully masked on the TPU anyway, so the result is the same and
// pruned or unowned capacity is never read. Tokens past that position
// inside the last page are not loaded either.
//
// Bound on this card: decode and chunk prefill at serving shapes read
// each K/V page once per (row, KV head) and do ~2 * R FLOPs per byte, far
// below the H100's ~295 bf16 FLOP/byte ridge, so the bound is the bytes
// of K + V pages actually read over 3.35 TB/s. This first kernel does
// not reach it: no cp.async/TMA pipelining, no wgmma, and a (B, KV) grid
// that leaves most SMs idle at small decode batches. Split-K over pages,
// TMA and wgmma are later work.

#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace {

using attn_tile::kRowTile;
using attn_tile::kThreads;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q,             // (B, C, H, HD)
                  const T* __restrict__ k_pages,       // (P, ps, KV, HD)
                  const T* __restrict__ v_pages,       // (P, ps, KV, HD)
                  const int* __restrict__ block_tables,  // (B, MP)
                  const int* __restrict__ pos0,        // (B,)
                  float* __restrict__ out,             // (B, C, H, HD)
                  int C, int H, int KV, int P, int ps, int MP, float scale) {
  const int G = H / KV;
  const int R = C * G;
  const int b = blockIdx.z;
  const int kv = blockIdx.y;
  const int r0 = blockIdx.x * kRowTile;
  const int nrows = min(kRowTile, R - r0);
  // query row r: chunk token (r0 + r) / G, head kv * G + (r0 + r) % G
  auto row_off = [=](int r) {
    const int row = r0 + r;
    return ((long long)(b * C + row / G) * H + kv * G + row % G) * HD;
  };

  const int p0 = pos0[b];
  const int qmax = p0 + (r0 + nrows - 1) / G;   // tile's last query position
  const int n_pages = min(MP, qmax / ps + 1);

  extern __shared__ float smem[];
  attn_tile::Block<HD> blk(smem, ps, nrows, q, row_off);
  for (int lp = 0; lp < n_pages; ++lp) {
    const int phys = block_tables[b * MP + lp];
    const bool page_ok = phys >= 0 && phys < P;  // out-of-range: read nothing
    // tokens past the tile's last query position are not read
    auto slot_off = [=](int t) -> long long {
      if (!page_ok || lp * ps + t > qmax) return -1;
      return ((long long)(phys * ps + t) * KV + kv) * HD;
    };
    auto valid = [=](int r, int j) {
      return lp * ps + j <= p0 + (r0 + r) / G;
    };
    blk.step(k_pages, v_pages, ps, scale, slot_off, valid);
  }
  blk.store(out, row_off);
}

template <typename T, int HD>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* block_tables, const int* pos0, float* out, int B,
           int C, int H, int KV, int P, int ps, int MP, cudaStream_t stream) {
  const int smem = attn_tile::smem_floats(HD, ps) * (int)sizeof(float);
  auto kernel = paged_attn_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int R = C * (H / KV);
  dim3 grid((R + kRowTile - 1) / kRowTile, KV, B);
  const float scale = 1.0f / sqrtf((float)HD);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), block_tables, pos0, out, C, H, KV, P,
      ps, MP, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Error codes below cudaSuccess's range are the wrapper's own refusals.
constexpr int kErrUnsupported = -1;
constexpr int kErrSmem = -2;

extern "C" {

// Shared memory one block of the kernel needs for head dim hd and page
// size ps (the wrapper checks it against the 227 KB limit).
int paged_attn_smem_bytes(int hd, int ps) {
  return attn_tile::smem_floats(hd, ps) * (int)sizeof(float);
}

const char* paged_attn_error_string(int code) {
  if (code == kErrUnsupported)
    return "unsupported dtype / head dim (bf16 or fp32, hd 64 or 128)";
  if (code == kErrSmem) return "page size needs more than 227 KB of shared memory";
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = fp32, 1 = bf16 (q and both page pools share it). Returns 0
// on a successful launch, else a CUDA error code or a negative refusal.
int paged_attn_fwd(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_tables, const void* pos0, void* out,
                   int B, int C, int H, int KV, int hd, int P, int ps, int MP,
                   int dtype, void* stream) {
  if (paged_attn_smem_bytes(hd, ps) > attn_tile::kSmemLimit) return kErrSmem;
  const int* bt = static_cast<const int*>(block_tables);
  const int* p0 = static_cast<const int*>(pos0);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k_pages, v_pages, bt, p0, o, B, C,
                                      H, KV, P, ps, MP, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k_pages, v_pages, bt, p0, o, B, C, H,
                                     KV, P, ps, MP, s);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k_pages, v_pages, bt, p0, o, B, C, H, KV, P,
                              ps, MP, s);
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k_pages, v_pages, bt, p0, o, B, C, H, KV, P,
                             ps, MP, s);
  return kErrUnsupported;
}

}  // extern "C"
