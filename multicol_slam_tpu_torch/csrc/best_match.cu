// Fused masked-Hamming best match over a rig of cameras, for Hopper (sm_90a).
//
// Replaces two TPU kernels of multicol_slam_tpu/ops/pallas_match.py:
//   mcslam_best_match         masked_best_match_pallas_cams (:200, bodies
//                             `kernel` and `kernel_masked`);
//   mcslam_best_match_single  masked_best_match_pallas (:113, body
//                             `_match_kernel`): one camera, no masks, no
//                             col_best. The same kernel with COLS = false
//                             compiles the column work out.
// Per camera c and query q, over the targets t that pass
//     |u_q - u_t| <= r, |v_q - v_t| <= r with r = min(rad_q, rad_t)
//     (a negative radius disables), and |oct_q - lvl_t| <= level_tol,
// it returns best, second (min over every column but the argmin), idx (the
// first argmin, or -1) and col_best[c, t] (min over queries). The distance
// is popc(a ^ b), or (popc(x & m_q) + popc(x & m_t)) / 2 with masks.
//
// Design: a block covers one (camera, tile of 128 queries); each thread owns
// a query and keeps best / second / idx in registers, as doubled integer
// distances. The block walks the targets in tiles staged in shared memory,
// in increasing t, so a strict `<` gives ties to the lowest t. Every lane of
// a warp looks at the same target at once: the warp's min over queries is
// one redux.sync, folded into a shared per-tile column min, then into
// col_best with an atomicMin on the bits of the non-negative float. Ragged
// query and target edges are masked here; a shared desc_t / mask_t comes in
// with a camera stride of 0.
//
// What bounds it: 8 popcounts (16 masked) and a compare chain per pair, and
// one pass over 32 B per target per query tile. At the tracking shape (3
// cameras x 400 queries x 4096 targets, 4.9 M pairs) the grid is 12 blocks
// on 132 SMs: each warp walks all 4096 targets in sequence, so the kernel
// is latency-bound, not bandwidth- or issue-bound. Splitting the targets
// across blocks (with a merge of the partial best / second / idx) is the
// way to fill the card. The bootstrap's window match (3 x 800 x 800) is 21
// blocks; the single-camera entry at 800 x 800 is 7: latency-bound alike.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQueryTile = 128;   // threads per block, one query each
constexpr int kTargetTile = 128;  // targets staged per shared-memory tile
constexpr unsigned kNone = 0x7fffffffu;  // "no candidate" doubled distance
constexpr float kBig = 1e9f;

__device__ __forceinline__ float min_nan(float a, float b) {
  // jnp.minimum / torch.minimum propagate NaN; fminf would not
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__global__ void fill_kernel(float* __restrict__ out, long long n, float v) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = v;
}

template <int NW, bool MASKED, bool COLS>
__global__ void __launch_bounds__(kQueryTile) best_match_kernel(
    const uint32_t* __restrict__ desc_q, const uint32_t* __restrict__ mask_q,
    const float* __restrict__ uv_q, const float* __restrict__ oct_q,
    const float* __restrict__ rad_q,
    const uint32_t* __restrict__ desc_t, const uint32_t* __restrict__ mask_t,
    long long t_cam_stride,  // in descriptor rows: T, or 0 when shared
    const float* __restrict__ uv_t, const float* __restrict__ rad_t,
    const float* __restrict__ lvl_t,
    int Q, int T, float level_tol,
    float* __restrict__ best_out, float* __restrict__ second_out,
    int* __restrict__ idx_out, float* __restrict__ col_best) {
  __shared__ uint32_t s_desc[kTargetTile * NW];
  __shared__ uint32_t s_mask[MASKED ? kTargetTile * NW : 1];
  __shared__ float s_u[kTargetTile], s_v[kTargetTile];
  __shared__ float s_rad[kTargetTile], s_lvl[kTargetTile];
  __shared__ unsigned s_col[COLS ? kTargetTile : 1];

  const int c = blockIdx.y;
  const int q = blockIdx.x * kQueryTile + threadIdx.x;
  const bool active = q < Q;
  const long long qrow = (long long)c * Q + q;

  uint32_t a[NW], am[NW];
  float uq = 0.f, vq = 0.f, oq = 0.f, rq = -1.f;
  if (active) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      a[w] = desc_q[qrow * NW + w];
      am[w] = MASKED ? mask_q[qrow * NW + w] : 0u;
    }
    uq = uv_q[2 * qrow];
    vq = uv_q[2 * qrow + 1];
    oq = oct_q[qrow];
    rq = rad_q[qrow];
  } else {
#pragma unroll
    for (int w = 0; w < NW; ++w) a[w] = am[w] = 0u;
  }

  const uint32_t* dt = desc_t + (long long)c * t_cam_stride * NW;
  const uint32_t* mt = MASKED ? mask_t + (long long)c * t_cam_stride * NW : nullptr;
  const long long tbase = (long long)c * T;
  unsigned best = kNone, second = kNone;
  int bi = -1;

  for (int t0 = 0; t0 < T; t0 += kTargetTile) {
    const int n = min(kTargetTile, T - t0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < n * NW; i += kQueryTile) {
      s_desc[i] = dt[(long long)t0 * NW + i];
      if (MASKED) s_mask[i] = mt[(long long)t0 * NW + i];
    }
    for (int i = threadIdx.x; i < n; i += kQueryTile) {
      const long long tt = tbase + t0 + i;
      s_u[i] = uv_t[2 * tt];
      s_v[i] = uv_t[2 * tt + 1];
      s_rad[i] = rad_t[tt];
      s_lvl[i] = lvl_t[tt];
      if (COLS) s_col[i] = kNone;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float r = min_nan(rq, s_rad[j]);
      const bool ok = active && fabsf(uq - s_u[j]) <= r && fabsf(vq - s_v[j]) <= r &&
                      fabsf(oq - s_lvl[j]) <= level_tol;
      unsigned d = kNone;
      if (ok) {
        int pc = 0;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const uint32_t x = a[w] ^ s_desc[j * NW + w];
          if (MASKED) {
            pc += __popc(x & am[w]) + __popc(x & s_mask[j * NW + w]);
          } else {
            pc += 2 * __popc(x);
          }
        }
        d = (unsigned)pc;
      }
      if (d < best) {
        second = best;
        best = d;
        bi = t0 + j;
      } else if (d < second) {
        second = d;
      }
      if (COLS) {
        const unsigned m = __reduce_min_sync(0xffffffffu, d);
        if ((threadIdx.x & 31) == 0 && m != kNone) atomicMin(&s_col[j], m);
      }
    }
    if (COLS) {
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += kQueryTile) {
        const unsigned m = s_col[i];
        if (m != kNone) {
          atomicMin(reinterpret_cast<int*>(col_best + tbase + t0 + i),
                    __float_as_int(0.5f * (float)m));
        }
      }
    }
  }

  if (active) {
    best_out[qrow] = best == kNone ? kBig : 0.5f * (float)best;
    second_out[qrow] = second == kNone ? kBig : 0.5f * (float)second;
    idx_out[qrow] = best == kNone ? -1 : bi;
  }
}

struct Args {
  const uint32_t *dq, *mq;
  const float *uvq, *octq, *radq;
  const uint32_t *dt, *mt;
  long long stride;
  const float *uvt, *radt, *lvlt;
  int Q, T;
  float tol;
  float *best, *second;
  int* idx;
  float* colb;
};

template <int NW, bool MASKED, bool COLS>
void launch_variant(const Args& g, dim3 grid, cudaStream_t s) {
  best_match_kernel<NW, MASKED, COLS><<<grid, kQueryTile, 0, s>>>(
      g.dq, g.mq, g.uvq, g.octq, g.radq, g.dt, g.mt, g.stride, g.uvt, g.radt, g.lvlt,
      g.Q, g.T, g.tol, g.best, g.second, g.idx, g.colb);
}

template <int NW>
void launch(const Args& g, dim3 grid, cudaStream_t s) {
  if (g.colb == nullptr) {
    launch_variant<NW, false, false>(g, grid, s);
  } else if (g.mq != nullptr) {
    launch_variant<NW, true, true>(g, grid, s);
  } else {
    launch_variant<NW, false, true>(g, grid, s);
  }
}

int launch_bytes(const Args& g, dim3 grid, int desc_bytes, cudaStream_t s) {
  switch (desc_bytes) {
    case 16: launch<4>(g, grid, s); break;
    case 32: launch<8>(g, grid, s); break;
    case 64: launch<16>(g, grid, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream`; returns the
// cudaError_t of the launches (0 on success). desc_bytes is 16, 32 or 64;
// mask_q / mask_t are null for the plain distance.
extern "C" int mcslam_best_match(
    const void* desc_q, const void* mask_q, const void* uv_q, const void* oct_q,
    const void* rad_q, const void* desc_t, const void* mask_t, int shared_targets,
    const void* uv_t, const void* rad_t, const void* lvl_t,
    int C, int Q, int T, int desc_bytes, float level_tol,
    void* best, void* second, void* idx, void* col_best, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long n_col = (long long)C * T;
  if (n_col > 0) {
    fill_kernel<<<(unsigned)((n_col + 255) / 256), 256, 0, s>>>(
        static_cast<float*>(col_best), n_col, kBig);
  }
  if (C > 0 && Q > 0) {
    const dim3 grid((Q + kQueryTile - 1) / kQueryTile, C);
    const Args g{static_cast<const uint32_t*>(desc_q), static_cast<const uint32_t*>(mask_q),
                 static_cast<const float*>(uv_q), static_cast<const float*>(oct_q),
                 static_cast<const float*>(rad_q), static_cast<const uint32_t*>(desc_t),
                 static_cast<const uint32_t*>(mask_t), shared_targets ? 0LL : (long long)T,
                 static_cast<const float*>(uv_t), static_cast<const float*>(rad_t),
                 static_cast<const float*>(lvl_t), Q, T, level_tol, static_cast<float*>(best),
                 static_cast<float*>(second), static_cast<int*>(idx),
                 static_cast<float*>(col_best)};
    const int err = launch_bytes(g, grid, desc_bytes, s);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

// One camera, no masks, no col_best (masked_best_match_pallas): best,
// second and idx of the [Q, T] window- and level-masked Hamming matrix.
extern "C" int mcslam_best_match_single(
    const void* desc_q, const void* uv_q, const void* oct_q, const void* rad_q,
    const void* desc_t, const void* uv_t, const void* rad_t, const void* lvl_t,
    int Q, int T, int desc_bytes, float level_tol,
    void* best, void* second, void* idx, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (Q > 0) {
    const dim3 grid((Q + kQueryTile - 1) / kQueryTile, 1);
    const Args g{static_cast<const uint32_t*>(desc_q), nullptr,
                 static_cast<const float*>(uv_q), static_cast<const float*>(oct_q),
                 static_cast<const float*>(rad_q), static_cast<const uint32_t*>(desc_t),
                 nullptr, 0LL, static_cast<const float*>(uv_t), static_cast<const float*>(rad_t),
                 static_cast<const float*>(lvl_t), Q, T, level_tol, static_cast<float*>(best),
                 static_cast<float*>(second), static_cast<int*>(idx), nullptr};
    const int err = launch_bytes(g, grid, desc_bytes, s);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}
