// Device code shared by the port's attention kernels (decode_attn.cu and
// paged_attn.cu): one thread block owns one (row b, KV head, tile of up
// to kRowTile query rows) and walks its K/V tiles in turn, keeping (m, l)
// in shared memory and acc in registers. The kernels differ only in how a
// query row and a K/V slot are addressed and in the mask; they pass both
// in as functors:
//   row_off(r)   element offset of query row r in q (and in out)
//   slot_off(t)  element offset of tile slot t's K/V vector, or -1 when
//                the slot is not read (it then stays zero)
//   valid(r, j)  whether row r may attend to tile slot j
// Each K/V tile goes to shared memory as fp32 through coalesced 16-byte
// loads (K rows padded by one float, so the score loop is free of bank
// conflicts). Scores and the PV product run in fp32 on the CUDA cores;
// the online softmax uses NEG = -2^30 as the TPU kernels do, and a slot
// that is not valid adds exactly 0 to l and acc (gated, never multiplied
// by a mask), so stale or non-finite data cannot reach the sum.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attn_tile {

constexpr int kThreads = 128;
constexpr int kRowTile = 16;            // query rows a block
constexpr float kNeg = -1073741824.0f;  // -2^30, as the TPU kernels
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

// Shared memory of one block, in floats, for head dim hd and n K/V slots
// a tile.
__host__ __device__ constexpr int smem_floats(int hd, int n) {
  return kRowTile * hd          // q tile
         + n * (hd + 1)         // K tile, rows padded by one float
         + n * hd               // V tile
         + kRowTile * n         // scores / probabilities
         + 3 * kRowTile;        // m, l, rescale
}

template <int HD>
struct Block {
  // Accumulator rows a thread holds: thread tid owns column tid % HD of
  // rows tid / HD, tid / HD + kThreads / HD, ...
  static constexpr int kAccRows = kRowTile / (kThreads / HD);

  float* q;   // [kRowTile][HD]
  float* k;   // [n][HD + 1]
  float* v;   // [n][HD]
  float* s;   // [kRowTile][n]
  float* m;   // [kRowTile]
  float* l;   // [kRowTile]
  float* a;   // [kRowTile]
  float acc[kAccRows];
  int nrows;

  // Carves shared memory for n slots a tile, loads the block's query
  // rows and zeroes the softmax state.
  template <typename T, typename RowOff>
  __device__ __forceinline__ Block(float* smem, int n, int nrows_,
                                   const T* __restrict__ qg, RowOff row_off)
      : nrows(nrows_) {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kVecPerRow = HD / kVec;
    q = smem;
    k = q + kRowTile * HD;
    v = k + n * (HD + 1);
    s = v + n * HD;
    m = s + kRowTile * n;
    l = m + kRowTile;
    a = l + kRowTile;
    const int tid = threadIdx.x;
    for (int i = tid; i < nrows * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow, c = i % kVecPerRow;
      const T* src = qg + row_off(r) + c * kVec;
      unpack(*reinterpret_cast<const uint4*>(src), q + r * HD + c * kVec,
             src);
    }
    if (tid < kRowTile) {
      m[tid] = kNeg;
      l[tid] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kAccRows; ++i) acc[i] = 0.f;
  }

  // Loads one tile of n K/V slots, then runs scores, the online softmax
  // and the PV product over it. Every thread of the block calls it.
  template <typename T, typename SlotOff, typename Valid>
  __device__ __forceinline__ void step(const T* __restrict__ kg,
                                       const T* __restrict__ vg, int n,
                                       float scale, SlotOff slot_off,
                                       Valid valid) {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kVecPerRow = HD / kVec;
    constexpr int kGroups = kThreads / HD;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    for (int i = tid; i < n * kVecPerRow; i += kThreads) {
      const int t = i / kVecPerRow, c = i % kVecPerRow;
      float kf[kVec], vf[kVec];
      const long long off = slot_off(t);
      if (off >= 0) {
        const size_t o = (size_t)off + c * kVec;
        unpack(*reinterpret_cast<const uint4*>(kg + o), kf, kg);
        unpack(*reinterpret_cast<const uint4*>(vg + o), vf, vg);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        k[t * (HD + 1) + c * kVec + e] = kf[e];
        v[t * HD + c * kVec + e] = vf[e];
      }
    }
    __syncthreads();

    // scores s[r][j] = (q_r . k_j) * scale, masked to NEG
    for (int e = tid; e < nrows * n; e += kThreads) {
      const int r = e / n, j = e % n;
      const float* qr = q + r * HD;
      const float* kj = k + j * (HD + 1);
      float dot = 0.f;
#pragma unroll 16
      for (int x = 0; x < HD; ++x) dot = fmaf(qr[x], kj[x], dot);
      s[r * n + j] = valid(r, j) ? dot * scale : kNeg;
    }
    __syncthreads();

    // online softmax, one warp per row; masked slots add exactly 0
    for (int r = warp; r < nrows; r += kThreads / 32) {
      float mx = kNeg;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, s[r * n + j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = valid(r, j) ? expf(s[r * n + j] - m_new) : 0.f;
        s[r * n + j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l[r] = l[r] * alpha + sum;
        a[r] = alpha;
        m[r] = m_new;
      }
    }
    __syncthreads();

    // acc[r][d] = acc[r][d] * alpha_r + sum_j p[r][j] * v[j][d]
    const int d = tid % HD;
#pragma unroll
    for (int i = 0; i < kAccRows; ++i) {
      const int r = tid / HD + i * kGroups;
      if (r < nrows) {
        float sacc = 0.f;
        const float* pr = s + r * n;
#pragma unroll 8
        for (int j = 0; j < n; ++j) sacc = fmaf(pr[j], v[j * HD + d], sacc);
        acc[i] = acc[i] * a[r] + sacc;
      }
    }
    __syncthreads();
  }

  // out row r = acc_r / max(l_r, 1e-30), at the query rows' offsets.
  template <typename RowOff>
  __device__ __forceinline__ void store(float* __restrict__ out,
                                        RowOff row_off) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < kAccRows; ++i) {
      const int r = tid / HD + i * (kThreads / HD);
      if (r < nrows) out[row_off(r) + tid % HD] = acc[i] / fmaxf(l[r], 1e-30f);
    }
  }
};

}  // namespace attn_tile
