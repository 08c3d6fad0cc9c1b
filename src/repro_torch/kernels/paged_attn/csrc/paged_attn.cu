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
// query rows) and loops over the pages itself, keeping (m, l) in shared
// memory and acc in registers. The block reads its own block-table row
// and pos0 (no scalar prefetch). It stops at the page holding the tile's
// last query position: later pages are fully masked on the TPU anyway, so
// the result is the same and pruned or unowned capacity is never read.
// Tokens past that position inside the last page are not loaded either.
// K and V pages go to shared memory as fp32 through coalesced 16-byte
// loads (K rows padded by one float so the score loop is free of bank
// conflicts); QK^T and PV accumulate in fp32 on the CUDA cores.
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

namespace {

constexpr int kThreads = 128;
constexpr int kRowTile = 16;
constexpr float kNeg = -1073741824.0f;  // -2^30, as the TPU kernel
constexpr int kSmemLimit = 232448;      // 227 KB a block may use on H100

__device__ __forceinline__ void unpack(const uint4& u, float* dst,
                                       const float*) {
  dst[0] = __uint_as_float(u.x);
  dst[1] = __uint_as_float(u.y);
  dst[2] = __uint_as_float(u.z);
  dst[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float* dst,
                                       const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // bf16 is the high half of an fp32: widening is a 16-bit shift
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__host__ __device__ constexpr int smem_floats(int hd, int ps) {
  return kRowTile * hd          // q tile
         + ps * (hd + 1)        // K page, rows padded by one float
         + ps * hd              // V page
         + kRowTile * ps        // scores / probabilities
         + 3 * kRowTile;        // m, l, rescale
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q,             // (B, C, H, HD)
                  const T* __restrict__ k_pages,       // (P, ps, KV, HD)
                  const T* __restrict__ v_pages,       // (P, ps, KV, HD)
                  const int* __restrict__ block_tables,  // (B, MP)
                  const int* __restrict__ pos0,        // (B,)
                  float* __restrict__ out,             // (B, C, H, HD)
                  int C, int H, int KV, int P, int ps, int MP, float scale) {
  constexpr int kVec = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int kVecPerRow = HD / kVec;
  constexpr int kGroups = kThreads / HD;        // row groups in the PV loop
  constexpr int kAccRows = kRowTile / kGroups;

  const int G = H / KV;
  const int R = C * G;
  const int b = blockIdx.z;
  const int kv = blockIdx.y;
  const int r0 = blockIdx.x * kRowTile;
  const int nrows = min(kRowTile, R - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                         // [kRowTile][HD]
  float* k_s = q_s + kRowTile * HD;          // [ps][HD + 1]
  float* v_s = k_s + ps * (HD + 1);          // [ps][HD]
  float* s_s = v_s + ps * HD;                // [kRowTile][ps]
  float* m_s = s_s + kRowTile * ps;          // [kRowTile]
  float* l_s = m_s + kRowTile;               // [kRowTile]
  float* a_s = l_s + kRowTile;               // [kRowTile]

  const int p0 = pos0[b];
  const int qmax = p0 + (r0 + nrows - 1) / G;   // tile's last query position
  const int n_pages = min(MP, qmax / ps + 1);

  // q tile: row r -> chunk token (r0 + r) / G, head kv * G + (r0 + r) % G
  for (int i = tid; i < nrows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow, c = i % kVecPerRow;
    const int row = r0 + r;
    const int h = kv * G + row % G;
    const T* src = q + ((size_t)(b * C + row / G) * H + h) * HD + c * kVec;
    unpack(*reinterpret_cast<const uint4*>(src), q_s + r * HD + c * kVec,
           src);
  }
  if (tid < kRowTile) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[kAccRows];
#pragma unroll
  for (int i = 0; i < kAccRows; ++i) acc[i] = 0.f;
  const int d = tid % HD;
  const int rg = tid / HD;

  for (int lp = 0; lp < n_pages; ++lp) {
    const int phys = block_tables[b * MP + lp];
    const bool page_ok = phys >= 0 && phys < P;  // out-of-range: read nothing
    // K / V page of this KV head to shared memory (16-byte coalesced
    // loads); tokens past the tile's last query position stay zero
    for (int i = tid; i < ps * kVecPerRow; i += kThreads) {
      const int t = i / kVecPerRow, c = i % kVecPerRow;
      float kf[kVec], vf[kVec];
      if (page_ok && lp * ps + t <= qmax) {
        const size_t off = ((size_t)(phys * ps + t) * KV + kv) * HD + c * kVec;
        unpack(*reinterpret_cast<const uint4*>(k_pages + off), kf, k_pages);
        unpack(*reinterpret_cast<const uint4*>(v_pages + off), vf, v_pages);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        k_s[t * (HD + 1) + c * kVec + e] = kf[e];
        v_s[t * HD + c * kVec + e] = vf[e];
      }
    }
    __syncthreads();

    // scores s[r][j] = (q_r . k_j) * scale, masked to NEG
    for (int e = tid; e < nrows * ps; e += kThreads) {
      const int r = e / ps, j = e % ps;
      const float* qr = q_s + r * HD;
      const float* kj = k_s + j * (HD + 1);
      float dot = 0.f;
#pragma unroll 16
      for (int x = 0; x < HD; ++x) dot = fmaf(qr[x], kj[x], dot);
      const bool valid = lp * ps + j <= p0 + (r0 + r) / G;
      s_s[r * ps + j] = valid ? dot * scale : kNeg;
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < nrows; r += kThreads / 32) {
      const int qpos = p0 + (r0 + r) / G;
      float mx = kNeg;
      for (int j = lane; j < ps; j += 32) mx = fmaxf(mx, s_s[r * ps + j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < ps; j += 32) {
        const bool valid = lp * ps + j <= qpos;
        const float p = valid ? expf(s_s[r * ps + j] - m_new) : 0.f;
        s_s[r * ps + j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc[r][d] = acc[r][d] * alpha_r + sum_j p[r][j] * v[j][d]
#pragma unroll
    for (int i = 0; i < kAccRows; ++i) {
      const int r = rg + i * kGroups;
      if (r < nrows) {
        float sacc = 0.f;
        const float* pr = s_s + r * ps;
        for (int j = 0; j < ps; ++j) sacc = fmaf(pr[j], v_s[j * HD + d], sacc);
        acc[i] = acc[i] * a_s[r] + sacc;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kAccRows; ++i) {
    const int r = rg + i * kGroups;
    if (r < nrows) {
      const int row = r0 + r;
      const int h = kv * G + row % G;
      out[((size_t)(b * C + row / G) * H + h) * HD + d] =
          acc[i] / fmaxf(l_s[r], 1e-30f);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* block_tables, const int* pos0, float* out, int B,
           int C, int H, int KV, int P, int ps, int MP, cudaStream_t stream) {
  const int smem = smem_floats(HD, ps) * (int)sizeof(float);
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
  return smem_floats(hd, ps) * (int)sizeof(float);
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
  if (paged_attn_smem_bytes(hd, ps) > kSmemLimit) return kErrSmem;
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
