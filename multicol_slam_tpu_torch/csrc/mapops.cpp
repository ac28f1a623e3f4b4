// Host-side map-table scans of the MultiCol-SLAM map store (a copy of the
// reference's native/mapops.cpp, keeping the scans the port calls).
//
// The map is flat arrays: kf_point[K, F] holds the map point of each
// (keyframe, feature) slot, BAD_ID = -1 when none. These scans are the hot
// loops of the bookkeeping layer (covisibility, the tracker's local-map vote,
// keyframe redundancy, the observation gather). Plain C ABI over raw buffers,
// bound with ctypes by multicol_slam_tpu_torch/native.py, which keeps a numpy
// version of each function beside it.
//
// Build: g++ -O3 -shared -fPIC mapops.cpp -o libmapops.so

#include <cstdint>
#include <cstring>
#include <unordered_set>
#include <vector>

extern "C" {

// counts[j] = number of slots of keyframe j whose point keyframe k also
// observes; 0 for k itself and for invalid keyframes. Membership is a hash
// probe, so no point-id capacity is needed (covisibility_counts2 below is
// the bitmap scan the map store calls).
void covisibility_counts(const int32_t* kf_point, const uint8_t* kf_valid,
                         int64_t K, int64_t F, int64_t k,
                         int32_t* counts /* [K] out */) {
  std::unordered_set<int32_t> pts;
  const int32_t* row_k = kf_point + k * F;
  for (int64_t f = 0; f < F; ++f)
    if (row_k[f] >= 0) pts.insert(row_k[f]);
  for (int64_t j = 0; j < K; ++j) {
    counts[j] = 0;
    if (j == k || !kf_valid[j]) continue;
    const int32_t* row = kf_point + j * F;
    int32_t c = 0;
    for (int64_t f = 0; f < F; ++f)
      if (row[f] >= 0 && pts.count(row[f])) ++c;
    counts[j] = c;
  }
}

// counts[j] = number of slots of keyframe j whose point keyframe k also
// observes (the covisibility weights, cMultiKeyFrame.cpp:412-500); 0 for k
// itself and for invalid keyframes. P is the point-id capacity: membership
// is a dense bitmap.
void covisibility_counts2(const int32_t* kf_point, const uint8_t* kf_valid,
                          int64_t K, int64_t F, int64_t k, int64_t P,
                          int32_t* counts /* [K] out */) {
  std::vector<uint8_t> mask((size_t)P, 0);
  const int32_t* row_k = kf_point + k * F;
  for (int64_t f = 0; f < F; ++f) {
    int32_t p = row_k[f];
    if (p >= 0 && p < P) mask[p] = 1;
  }
  for (int64_t j = 0; j < K; ++j) {
    counts[j] = 0;
    if (j == k || !kf_valid[j]) continue;
    const int32_t* row = kf_point + j * F;
    int32_t c = 0;
    for (int64_t f = 0; f < F; ++f) {
      int32_t p = row[f];
      if (p >= 0 && p < P && mask[p]) ++c;
    }
    counts[j] = c;
  }
}

// n_obs[i] = number of slots of valid keyframes observing pt_ids[i] (ids
// unique and >= 0; a repeated id counts at its last position only).
void count_observations(const int32_t* kf_point, const uint8_t* kf_valid,
                        int64_t K, int64_t F,
                        const int32_t* pt_ids, int64_t n_pts,
                        int32_t* n_obs /* [n_pts] out */) {
  int32_t max_id = -1;
  for (int64_t i = 0; i < n_pts; ++i)
    if (pt_ids[i] > max_id) max_id = pt_ids[i];
  std::vector<int32_t> lut((size_t)max_id + 1, -1);
  for (int64_t i = 0; i < n_pts; ++i) lut[pt_ids[i]] = (int32_t)i;
  std::memset(n_obs, 0, sizeof(int32_t) * (size_t)n_pts);
  for (int64_t j = 0; j < K; ++j) {
    if (!kf_valid[j]) continue;
    const int32_t* row = kf_point + j * F;
    for (int64_t f = 0; f < F; ++f) {
      int32_t p = row[f];
      if (p >= 0 && p <= max_id && lut[p] >= 0) ++n_obs[lut[p]];
    }
  }
}

// For keyframe culling (cLocalMapping.cpp:520-597): for every feature slot
// g of keyframe j with a map point, the number of slots of OTHER valid
// keyframes observing the same point at octave <= octave(j, g) + 1.
void redundancy_counts_fast(const int32_t* kf_point, const int32_t* kf_octave,
                            const uint8_t* kf_valid, int64_t K, int64_t F,
                            int64_t j, int32_t* redundant /* [F] out */) {
  const int32_t* row_j = kf_point + j * F;
  const int32_t* oct_j = kf_octave + j * F;
  std::memset(redundant, 0, sizeof(int32_t) * (size_t)F);
  int32_t max_id = -1;
  for (int64_t g = 0; g < F; ++g)
    if (row_j[g] > max_id) max_id = row_j[g];
  if (max_id < 0) return;
  // head/next linked lists over j's slots sharing a point
  std::vector<int32_t> head((size_t)max_id + 1, -1), next((size_t)F, -1);
  for (int64_t g = 0; g < F; ++g) {
    int32_t p = row_j[g];
    if (p >= 0) { next[g] = head[p]; head[p] = (int32_t)g; }
  }
  for (int64_t k = 0; k < K; ++k) {
    if (k == j || !kf_valid[k]) continue;
    const int32_t* row = kf_point + k * F;
    const int32_t* oct = kf_octave + k * F;
    for (int64_t f = 0; f < F; ++f) {
      int32_t p = row[f];
      if (p < 0 || p > max_id || head[p] < 0) continue;
      for (int32_t g = head[p]; g >= 0; g = next[g])
        if (oct[f] <= oct_j[g] + 1) ++redundant[g];
    }
  }
}

// votes[j] = number of feature slots of valid keyframe j whose point id is
// flagged in seed_mask (the tracker's local-map vote, cTracking.cpp:961-1130
// UpdateReferenceKeyFrames).
void vote_counts(const int32_t* kf_point, const uint8_t* kf_valid,
                 int64_t K, int64_t F,
                 const uint8_t* seed_mask, int64_t P,
                 int32_t* votes /* [K] out */) {
  for (int64_t j = 0; j < K; ++j) {
    votes[j] = 0;
    if (!kf_valid[j]) continue;
    const int32_t* row = kf_point + j * F;
    int32_t c = 0;
    for (int64_t f = 0; f < F; ++f) {
      int32_t p = row[f];
      if (p >= 0 && p < P && seed_mask[p]) ++c;
    }
    votes[j] = c;
  }
}

// Every (keyframe, feature) slot of a valid keyframe whose point id is
// flagged in mask, in row-major order. Writes up to max_out hits into
// (out_k, out_f, out_p) and returns the TOTAL hit count (callers size
// max_out from the store's observation counts and call again with a larger
// buffer if it undershoots).
int64_t find_slots(const int32_t* kf_point, const uint8_t* kf_valid,
                   int64_t K, int64_t F,
                   const uint8_t* mask, int64_t P,
                   int32_t* out_k, int32_t* out_f, int32_t* out_p,
                   int64_t max_out) {
  int64_t n = 0;
  for (int64_t j = 0; j < K; ++j) {
    if (!kf_valid[j]) continue;
    const int32_t* row = kf_point + j * F;
    for (int64_t f = 0; f < F; ++f) {
      int32_t p = row[f];
      if (p >= 0 && p < P && mask[p]) {
        if (n < max_out) {
          out_k[n] = (int32_t)j;
          out_f[n] = (int32_t)f;
          out_p[n] = p;
        }
        ++n;
      }
    }
  }
  return n;
}

}  // extern "C"
