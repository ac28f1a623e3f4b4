// Fused masked-Hamming best match over a rig of cameras, for Hopper (sm_90a).
//
// Replaces two TPU kernels of multicol_slam_tpu/ops/pallas_match.py:
//   mcslam_best_match         masked_best_match_pallas_cams (:200, bodies
//                             `kernel` and `kernel_masked`, :305-340);
//   mcslam_best_match_single  masked_best_match_pallas (:113, body
//                             `_match_kernel`): one camera, no masks, no
//                             col_best: the same kernel with COLS = false.
// Per camera c and query q, over the targets t that pass
//     |u_q - u_t| <= r, |v_q - v_t| <= r with r = min(rad_q, rad_t)
//     (a negative radius disables), and |oct_q - lvl_t| <= level_tol,
// it returns best, second (min over every column but the argmin), idx (the
// first argmin, or -1) and col_best[c, t] (min over queries). The distance
// is popc(a ^ b), or (popc(x & m_q) + popc(x & m_t)) / 2 with masks; the
// kernel keeps it doubled, as an exact integer.
//
// What bounds it. The TPU kernel computes every pair as a +-1 product on
// its matrix unit: 2 x 3 x 400 x 4096 x 256 = 2.52 G operations at the
// tracking shape, 1.27 us at the int8 tensor-core peak (1,979 TOP/s); the
// bootstrap shape (3 x 800 x 800) 0.50 us, K2 (800 x 800) 0.17 us. The
// bytes (~0.45 MB at the tracking shape) take 0.13 us at 3.35 TB/s, and
// the products of only the pairs that pass the window (0.03-0.3 % of them
// in tracking, 23 % in the bootstrap) take less. So the function is bound
// at a microsecond or less: what costs time on this card is latency, i.e.
// too few blocks, a serial walk over targets and loads that do not
// overlap work.
//
// Design.
//  a. The grid is (query tiles of 64, target chunks, cameras): each block
//     covers 64 queries x one chunk of 64-256 targets, 4 warps of 16 query
//     rows each. The wrapper picks the largest chunk that still gives 528
//     blocks, 4 for each of the H100's 132 SMs (about 8 fit on one): 672
//     blocks of 128 targets at the tracking shape, 507 of 64 at the
//     bootstrap shape.
//  b. Each block writes its partial (best, second, idx) per query into a
//     scratch [3, C, S, Q] that the wrapper allocates. The last block of a
//     (camera, query tile) to finish (an atomic ticket after a
//     __threadfence) merges the S partials in increasing chunk order with
//     the TPU kernel's tile merge (pallas_match.py:282-284): the result does
//     not depend on the order in which blocks finish. col_best is an
//     atomicMin on the bits of a non-negative float, after a reduction over
//     the block's 64 queries: one atomic per target per block.
//  c. Target tiles of 64 (descriptors, masks, positions, radii, levels) are
//     staged in a ring of 3 shared-memory stages by the bulk async copy
//     (cp.async.bulk, TMA 1-D) with one mbarrier per stage for "full" and
//     one for "empty": loads of later tiles overlap work on this one, and
//     no __syncthreads runs inside the walk. The copies cover the 16-byte
//     aligned blocks around each range (a 16-byte block never straddles a
//     page, so the few bytes outside the tensor are mapped).
//  d. Distances on the tensor cores: mma.sync m16n8k256 b1 with AND+POPC
//     gives popc(a & b) for 16 queries x 8 targets x 256 bits;
//         popc(a ^ b) = popc(a & ~b) + popc(~a & b),
//         popc((a ^ b) & m) = popc((a & m) & ~b) + popc((~a & m) & b),
//     so a pair costs two products (four with masks) and no per-row or
//     per-column popcounts. 16-byte descriptors pad k with zeros, 64-byte
//     ones take two k-steps. Before the product each lane tests the window
//     of its 4 pairs; a warp skips the 16 x 8 tile when no lane's window
//     admits a pair. The epilogue works on the accumulator fragment (rows
//     lane/4 and lane/4 + 8, columns 2 (lane % 4) + {0, 1}): each lane keeps
//     (best, second, idx) of its two rows over its own columns in increasing
//     t (a strict < keeps the lowest t), and a (d, t)-lexicographic shuffle
//     over the 4 lanes of a row merges them at the end of the chunk.
// The same design with 8 CUDA-core popcounts a pair instead of the products
// was slower at both main-path shapes on the H100 (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kQueryTile = 16 * kWarps;  // 16 rows of an mma tile per warp
constexpr int kTile = 64;                // targets per shared-memory stage
constexpr int kStages = 3;
constexpr int kMaxChunk = 256;
constexpr unsigned kNone = 0x7fffffffu;  // "no candidate" doubled distance
constexpr int kNoIdx = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e9f;

__device__ __forceinline__ float min_nan(float a, float b) {
  // jnp.minimum / torch.minimum propagate NaN; fminf would not
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// The 16-byte aligned span around [p, p + bytes): its start and length.
__device__ __forceinline__ uintptr_t span_lo(const void* p) {
  return reinterpret_cast<uintptr_t>(p) & ~uintptr_t(15);
}
__device__ __forceinline__ unsigned span_len(const void* p, int bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return static_cast<unsigned>(((a + bytes + 15) & ~uintptr_t(15)) - (a & ~uintptr_t(15)));
}
__device__ __forceinline__ int span_off(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(span_lo(src)), "r"(span_len(src, bytes)), "r"(smem_u32(bar))
      : "memory");
}

// D += popc(A & B) for A 16 x 256 bits (row), B 256 x 8 bits (col).
__device__ __forceinline__ void mma_and_popc(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One target tile in shared memory, each array with 32 bytes of slack for
// the aligned span around it.
template <int NW, bool MASKED>
struct Stage {
  static constexpr int kDesc = kTile * NW * 4 + 32;
  alignas(16) unsigned char desc[kDesc];
  alignas(16) unsigned char mask[MASKED ? kDesc : 16];
  alignas(16) unsigned char uv[kTile * 8 + 32];
  alignas(16) unsigned char rad[kTile * 4 + 32];
  alignas(16) unsigned char lvl[kTile * 4 + 32];
};

struct Args {
  const uint32_t *dq, *mq;
  const float *uvq, *octq, *radq;
  const uint32_t *dt, *mt;
  long long stride;  // target rows per camera: T, or 0 when desc_t is shared
  const float *uvt, *radt, *lvlt;
  int Q, T;
  float tol;
  float *best, *second;
  int* idx;
  float* colb;
  unsigned* part;     // [3, C, S, Q]: best, second, idx of each chunk
  unsigned* tickets;  // [C, query tiles]
  int chunk, S, q_tiles;
};

__device__ __forceinline__ void keep(unsigned d, int t, unsigned& best, unsigned& second, int& bi) {
  if (d < best) {
    second = best;
    best = d;
    bi = t;
  } else if (d < second) {
    second = d;
  }
}

// Merge another lane's (best, second, idx) of the same row: the lower
// (d, t) wins, second is the min over both sets but the winner's column.
__device__ __forceinline__ void merge_lane(unsigned& best, unsigned& second, int& bi, int x) {
  const unsigned ob = __shfl_xor_sync(kFull, best, x);
  const unsigned os = __shfl_xor_sync(kFull, second, x);
  const int oi = __shfl_xor_sync(kFull, bi, x);
  second = min(max(best, ob), min(second, os));
  if (ob < best || (ob == best && oi < bi)) bi = oi;
  best = min(best, ob);
}

__global__ void prep_kernel(float* __restrict__ col_best, long long n_col, unsigned* __restrict__ tickets,
                            int n_tickets) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_col) col_best[i] = kBig;
  if (i < n_tickets) tickets[i] = 0u;
}

template <int NW, bool MASKED, bool COLS>
__global__ void __launch_bounds__(kThreads) best_match_kernel(const Args g) {
  constexpr int KS = NW > 8 ? NW / 8 : 1;  // k-steps of 256 bits
  __shared__ Stage<NW, MASKED> st[kStages];
  __shared__ uint64_t full[kStages], empty[kStages];
  __shared__ unsigned s_col[kWarps][COLS ? kMaxChunk : 1];
  __shared__ int s_last;

  const int qt = blockIdx.x, split = blockIdx.y, c = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const int T = g.T, Q = g.Q;
  const int t_begin = split * g.chunk;
  const int n_chunk = max(0, min(g.chunk, T - t_begin));
  const int n_tiles = (n_chunk + kTile - 1) / kTile;
  const uint32_t* dt = g.dt + (long long)c * g.stride * NW;
  const uint32_t* mt = MASKED ? g.mt + (long long)c * g.stride * NW : nullptr;
  const long long tc = (long long)c * T;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  // one thread issues the bulk copies of tile k into its stage
  auto issue = [&](int k) {
    Stage<NW, MASKED>& s = st[k % kStages];
    uint64_t* bar = &full[k % kStages];
    const int t0 = t_begin + k * kTile;
    const int n = min(kTile, T - t0);
    const uint32_t* d = dt + (long long)t0 * NW;
    const float* uv = g.uvt + 2 * (tc + t0);
    const float* rad = g.radt + tc + t0;
    const float* lvl = g.lvlt + tc + t0;
    unsigned bytes = span_len(d, n * NW * 4) + span_len(uv, n * 8) + span_len(rad, n * 4) +
                     span_len(lvl, n * 4);
    if constexpr (MASKED) bytes += span_len(mt + (long long)t0 * NW, n * NW * 4);
    mbar_expect_tx(bar, bytes);
    bulk_load(s.desc, d, n * NW * 4, bar);
    if constexpr (MASKED) bulk_load(s.mask, mt + (long long)t0 * NW, n * NW * 4, bar);
    bulk_load(s.uv, uv, n * 8, bar);
    bulk_load(s.rad, rad, n * 4, bar);
    bulk_load(s.lvl, lvl, n * 4, bar);
  };
  if (threadIdx.x == 0) {
    for (int k = 0; k < min(kStages, n_tiles); ++k) issue(k);
  }

  // this lane's two query rows: gr and gr + 8 of the warp's 16
  const int q0 = qt * kQueryTile + warp * 16 + gr;
  int qrow[2] = {q0, q0 + 8};
  float uq[2], vq[2], oq[2], rq[2];
  bool act[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    act[r] = qrow[r] < Q;
    const long long qi = (long long)c * Q + qrow[r];
    uq[r] = act[r] ? g.uvq[2 * qi] : 0.f;
    vq[r] = act[r] ? g.uvq[2 * qi + 1] : 0.f;
    oq[r] = act[r] ? g.octq[qi] : 0.f;
    rq[r] = act[r] ? g.radq[qi] : -1.f;
  }
  // the A operands: for k-step ks, half h (k-lo / k-hi 128 bits), row r,
  // descriptor word ks * 8 + h * 4 + tg (zero beyond NW)
  uint32_t xa[KS][2][2], xn[KS][2][2], xam[KS][2][2], xnm[KS][2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long qi = (long long)c * Q + qrow[r];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int w = ks * 8 + h * 4 + tg;
        const bool in = act[r] && w < NW;
        const uint32_t a = in ? g.dq[qi * NW + w] : 0u;
        const uint32_t m = (MASKED && in) ? g.mq[qi * NW + w] : 0u;
        xa[ks][h][r] = a;
        xn[ks][h][r] = in ? ~a : 0u;
        xam[ks][h][r] = a & m;
        xnm[ks][h][r] = ~a & m;
      }
    }
  }

  unsigned best[2] = {kNone, kNone}, second[2] = {kNone, kNone};
  int bi[2] = {kNoIdx, kNoIdx};

  for (int k = 0; k < n_tiles; ++k) {
    const int slot = k % kStages;
    if (threadIdx.x == 0 && k >= 1 && k - 1 + kStages < n_tiles) {
      mbar_wait(&empty[(k - 1) % kStages], ((k - 1) / kStages) & 1);
      issue(k - 1 + kStages);
    }
    __syncwarp();
    mbar_wait(&full[slot], (k / kStages) & 1);
    const Stage<NW, MASKED>& s = st[slot];
    const int t0 = t_begin + k * kTile;
    const int n = min(kTile, T - t0);
    const uint32_t* sd = reinterpret_cast<const uint32_t*>(s.desc + span_off(dt + (long long)t0 * NW));
    const uint32_t* sm =
        MASKED ? reinterpret_cast<const uint32_t*>(s.mask + span_off(mt + (long long)t0 * NW)) : nullptr;
    const float* su = reinterpret_cast<const float*>(s.uv + span_off(g.uvt + 2 * (tc + t0)));
    const float* sr = reinterpret_cast<const float*>(s.rad + span_off(g.radt + tc + t0));
    const float* sl = reinterpret_cast<const float*>(s.lvl + span_off(g.lvlt + tc + t0));

    const int n_groups = (n + 7) >> 3;
#pragma unroll 2
    for (int j = 0; j < n_groups; ++j) {
      // window and band of the lane's 4 pairs (rows r, columns e)
      bool ok[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tl = j * 8 + 2 * tg + e;
        const bool valid = tl < n;
        const float ut = su[2 * tl], vt = su[2 * tl + 1], rt = sr[tl], lt = sl[tl];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float rr = min_nan(rq[r], rt);
          ok[r][e] = valid && fabsf(uq[r] - ut) <= rr && fabsf(vq[r] - vt) <= rr &&
                     fabsf(oq[r] - lt) <= g.tol;
        }
      }
      unsigned d[2][2] = {{kNone, kNone}, {kNone, kNone}};
      if (__any_sync(kFull, ok[0][0] || ok[0][1] || ok[1][0] || ok[1][1])) {
        // f: popc(a ^ b), or popc(x & m_q) + popc(x & m_t) with masks, of
        // rows (gr, gr + 8) x columns (2 tg, 2 tg + 1); this lane supplies
        // column gr of the 8-target tile, target j * 8 + gr
        int f[4] = {0, 0, 0, 0};
        const uint32_t* bt = sd + (j * 8 + gr) * NW;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int w0 = ks * 8 + tg, w1 = ks * 8 + 4 + tg;
          const uint32_t b0 = bt[w0], b1 = w1 < NW ? bt[w1] : 0u;
          if constexpr (MASKED) {
            const uint32_t* bm = sm + (j * 8 + gr) * NW;
            const uint32_t m0 = bm[w0], m1 = w1 < NW ? bm[w1] : 0u;
            mma_and_popc(f, xam[ks][0][0], xam[ks][0][1], xam[ks][1][0], xam[ks][1][1], ~b0, ~b1);
            mma_and_popc(f, xnm[ks][0][0], xnm[ks][0][1], xnm[ks][1][0], xnm[ks][1][1], b0, b1);
            mma_and_popc(f, xa[ks][0][0], xa[ks][0][1], xa[ks][1][0], xa[ks][1][1], m0 & ~b0, m1 & ~b1);
            mma_and_popc(f, xn[ks][0][0], xn[ks][0][1], xn[ks][1][0], xn[ks][1][1], m0 & b0, m1 & b1);
          } else {
            mma_and_popc(f, xa[ks][0][0], xa[ks][0][1], xa[ks][1][0], xa[ks][1][1], ~b0, ~b1);
            mma_and_popc(f, xn[ks][0][0], xn[ks][0][1], xn[ks][1][0], xn[ks][1][1], b0, b1);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (ok[r][e]) d[r][e] = (unsigned)(MASKED ? f[2 * r + e] : 2 * f[2 * r + e]);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int e = 0; e < 2; ++e) keep(d[r][e], t0 + j * 8 + 2 * tg + e, best[r], second[r], bi[r]);
        }
        if constexpr (COLS) {
          unsigned v0 = min(d[0][0], d[1][0]), v1 = min(d[0][1], d[1][1]);
#pragma unroll
          for (int x = 4; x < 32; x <<= 1) {
            v0 = min(v0, __shfl_xor_sync(kFull, v0, x));
            v1 = min(v1, __shfl_xor_sync(kFull, v1, x));
          }
          if (gr == 0) {
            s_col[warp][k * kTile + j * 8 + 2 * tg] = v0;
            s_col[warp][k * kTile + j * 8 + 2 * tg + 1] = v1;
          }
        }
      } else if constexpr (COLS) {
        if (gr == 0) {
          s_col[warp][k * kTile + j * 8 + 2 * tg] = kNone;
          s_col[warp][k * kTile + j * 8 + 2 * tg + 1] = kNone;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }

  // the chunk's (best, second, idx) of each row, over the 4 lanes of the row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    merge_lane(best[r], second[r], bi[r], 1);
    merge_lane(best[r], second[r], bi[r], 2);
  }
  const long long pq = (long long)c * g.S * Q + (long long)split * Q;
  const long long plane = (long long)gridDim.z * g.S * Q;
  if (tg == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (act[r]) {
        g.part[pq + qrow[r]] = best[r];
        g.part[plane + pq + qrow[r]] = second[r];
        g.part[2 * plane + pq + qrow[r]] = static_cast<unsigned>(bi[r]);
      }
    }
  }

  if constexpr (COLS) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_chunk; i += kThreads) {
      unsigned m = s_col[0][i];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) m = min(m, s_col[w][i]);
      if (m != kNone) {
        atomicMin(reinterpret_cast<int*>(g.colb + tc + t_begin + i), __float_as_int(0.5f * (float)m));
      }
    }
  }

  // the last block of this (camera, query tile) merges the S partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(&g.tickets[c * g.q_tiles + qt], 1u) == static_cast<unsigned>(g.S - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < kQueryTile; i += kThreads) {
    const int q = qt * kQueryTile + i;
    if (q >= Q) break;
    const long long base = (long long)c * g.S * Q + q;
    unsigned r1 = kNone, r2 = kNone;
    int ri = -1;
#pragma unroll 8
    for (int s = 0; s < g.S; ++s) {
      const unsigned t1 = __ldcg(g.part + base + (long long)s * Q);
      const unsigned t2 = __ldcg(g.part + plane + base + (long long)s * Q);
      const int ti = static_cast<int>(__ldcg(g.part + 2 * plane + base + (long long)s * Q));
      r2 = min(max(r1, t1), min(r2, t2));
      if (t1 < r1) ri = ti;
      r1 = min(r1, t1);
    }
    const long long o = (long long)c * Q + q;
    g.best[o] = r1 == kNone ? kBig : 0.5f * (float)r1;
    g.second[o] = r2 == kNone ? kBig : 0.5f * (float)r2;
    g.idx[o] = r1 == kNone ? -1 : ri;
  }
}

template <int NW>
void launch(const Args& g, dim3 grid, cudaStream_t s) {
  if (g.colb == nullptr) {
    best_match_kernel<NW, false, false><<<grid, kThreads, 0, s>>>(g);
  } else if (g.mq != nullptr) {
    best_match_kernel<NW, true, true><<<grid, kThreads, 0, s>>>(g);
  } else {
    best_match_kernel<NW, false, true><<<grid, kThreads, 0, s>>>(g);
  }
}

// The split (S chunks, the tickets after the partials in the scratch),
// prep (col_best = BIG, tickets = 0), then the match grid; each launch's
// error is checked
int run(Args g, int C, int desc_bytes, cudaStream_t s) {
  if (g.chunk <= 0 || g.chunk % kTile != 0 || g.chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  if (desc_bytes != 16 && desc_bytes != 32 && desc_bytes != 64) return (int)cudaErrorInvalidValue;
  if (C <= 0) return 0;
  g.S = max(1, (g.T + g.chunk - 1) / g.chunk);
  g.q_tiles = (g.Q + kQueryTile - 1) / kQueryTile;
  g.tickets = g.part + 3LL * C * g.S * g.Q;
  const long long n_col = g.colb == nullptr ? 0 : (long long)C * g.T;
  const long long n_prep = max(n_col, (long long)C * g.q_tiles);
  if (n_prep > 0) {
    prep_kernel<<<(unsigned)((n_prep + 255) / 256), 256, 0, s>>>(g.colb, n_col, g.tickets, C * g.q_tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (g.Q > 0) {
    const dim3 grid(g.q_tiles, g.S, C);
    switch (desc_bytes) {
      case 16: launch<4>(g, grid, s); break;
      case 32: launch<8>(g, grid, s); break;
      default: launch<16>(g, grid, s); break;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. They launch on `stream` and
// return the cudaError_t of the launches (0 on success). desc_bytes is 16,
// 32 or 64; chunk (targets a block, a multiple of 64 up to 256) is the
// wrapper's; scratch holds 3 C S Q + C ceil(Q / 64) words, S = ceil(T /
// chunk). mask_q / mask_t are null for the plain distance.
extern "C" int mcslam_best_match(
    const void* desc_q, const void* mask_q, const void* uv_q, const void* oct_q,
    const void* rad_q, const void* desc_t, const void* mask_t, int shared_targets,
    const void* uv_t, const void* rad_t, const void* lvl_t,
    int C, int Q, int T, int desc_bytes, float level_tol, int chunk,
    void* best, void* second, void* idx, void* col_best, void* scratch, void* stream) {
  Args g{static_cast<const uint32_t*>(desc_q), static_cast<const uint32_t*>(mask_q),
         static_cast<const float*>(uv_q), static_cast<const float*>(oct_q),
         static_cast<const float*>(rad_q), static_cast<const uint32_t*>(desc_t),
         static_cast<const uint32_t*>(mask_t), shared_targets ? 0LL : (long long)T,
         static_cast<const float*>(uv_t), static_cast<const float*>(rad_t),
         static_cast<const float*>(lvl_t), Q, T, level_tol, static_cast<float*>(best),
         static_cast<float*>(second), static_cast<int*>(idx), static_cast<float*>(col_best),
         static_cast<unsigned*>(scratch), nullptr, chunk, 0, 0};
  return run(g, C, desc_bytes, reinterpret_cast<cudaStream_t>(stream));
}

// One camera, no masks, no col_best (masked_best_match_pallas): best,
// second and idx of the [Q, T] window- and level-masked Hamming matrix.
extern "C" int mcslam_best_match_single(
    const void* desc_q, const void* uv_q, const void* oct_q, const void* rad_q,
    const void* desc_t, const void* uv_t, const void* rad_t, const void* lvl_t,
    int Q, int T, int desc_bytes, float level_tol, int chunk,
    void* best, void* second, void* idx, void* scratch, void* stream) {
  Args g{static_cast<const uint32_t*>(desc_q), nullptr,
         static_cast<const float*>(uv_q), static_cast<const float*>(oct_q),
         static_cast<const float*>(rad_q), static_cast<const uint32_t*>(desc_t),
         nullptr, 0LL, static_cast<const float*>(uv_t), static_cast<const float*>(rad_t),
         static_cast<const float*>(lvl_t), Q, T, level_tol, static_cast<float*>(best),
         static_cast<float*>(second), static_cast<int*>(idx), nullptr,
         static_cast<unsigned*>(scratch), nullptr, chunk, 0, 0};
  return run(g, 1, desc_bytes, reinterpret_cast<cudaStream_t>(stream));
}
