// Native greedy PAF assembler: the host decode's fast backend.
//
// The port's own copy of the JAX package's native/pafdecode.cpp: the code
// from the first #include on is the original's, character for character
// (tests/test_torch_decode_host.py holds them equal), so the "native"
// backend gives the JAX package's people on the same peaks and PAFs. A
// functional equivalent of the reference's pafprocess
// (reference lib/pafprocess/pafprocess.cpp:22-194), redesigned:
//
//  - pure function with caller-owned buffers: no global mutable state, so
//    it is thread-safe (the reference keeps results in module-level
//    vectors, pafprocess.cpp:12-13);
//  - samples the low-resolution PAF directly through the stride
//    (the x8 INTER_NEAREST upsample of the reference reduces to integer
//    division of the sample coordinate, so the 64x-larger upsampled map is
//    never materialized);
//  - C ABI for ctypes (the reference uses SWIG + a vendored numpy.i).
//
// Semantics are pinned to the reference, including its quirks: peak
// coordinates truncated to int, the found==1 merge branch never filling
// the src slot, the disjointness test treating cid 0 as absent, >2 row
// matches dropping the connection, and the last limb pair being barred
// from creating new rows. Out-of-range samples are clamped (the reference
// reads out of bounds there).
//
// Built with g++ at first use by native/__init__.py; runs on the host.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr int kNumParts = 18;
constexpr int kNumPairs = 19;
constexpr int kRowLen = 20;  // 18 part cids + score + count

// (part_a, part_b) per limb pair — reference lib/pafprocess/pafprocess.h:21-24
constexpr int kPairs[kNumPairs][2] = {
    {1, 2}, {1, 5}, {2, 3}, {3, 4}, {5, 6}, {6, 7}, {1, 8}, {8, 9}, {9, 10},
    {1, 11}, {11, 12}, {12, 13}, {1, 0}, {0, 14}, {14, 16}, {0, 15}, {15, 17},
    {2, 16}, {5, 17}};

// (x_channel, y_channel) per limb pair — reference pafprocess.h:16-19
constexpr int kPairChannels[kNumPairs][2] = {
    {12, 13}, {20, 21}, {14, 15}, {16, 17}, {22, 23}, {24, 25}, {0, 1},
    {2, 3}, {4, 5}, {6, 7}, {8, 9}, {10, 11}, {28, 29}, {30, 31}, {34, 35},
    {32, 33}, {36, 37}, {18, 19}, {26, 27}};

struct PeakRec {
  int x, y;     // truncated upsampled-frame coords
  float score;
  int gid;      // global id == row index in the flat peaks array
};

struct Candidate {
  float score;
  int ia, ib;
};

inline int round_half_up(float v) { return static_cast<int>(v + 0.5f); }

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" {

// peaks: [n_peaks, 5] float rows (x, y, score, gid, part_id) in the
//        upsampled (input image) frame, as produced by NMS.
// pafs:  [h, w, 38] float32 low-resolution PAF.
// out_subset: [max_people, 20] float buffer.
// Returns the number of people written, or -1 on bad arguments.
int pafdecode_process(const float* peaks, int n_peaks,
                      const float* pafs, int h, int w,
                      int stride, int n_steps,
                      float thresh_paf, int thresh_vector_cnt1,
                      float thresh_part_cnt, float thresh_human_score,
                      float* out_subset, int max_people) {
  if (n_peaks < 0 || h <= 0 || w <= 0 || stride <= 0 || n_steps <= 0 ||
      max_people <= 0) {
    return -1;
  }
  const int up_h = h * stride;

  std::vector<PeakRec> by_part[kNumParts];
  std::vector<float> score_by_gid(static_cast<size_t>(n_peaks), 0.0f);
  for (int i = 0; i < n_peaks; ++i) {
    const float* row = peaks + 5 * i;
    int part = static_cast<int>(row[4]);
    if (part < 0 || part >= kNumParts) continue;
    PeakRec rec;
    rec.x = static_cast<int>(row[0]);
    rec.y = static_cast<int>(row[1]);
    rec.score = row[2];
    rec.gid = static_cast<int>(row[3]);
    if (rec.gid >= 0 && rec.gid < n_peaks) score_by_gid[rec.gid] = rec.score;
    by_part[part].push_back(rec);
  }

  // ---- per-pair candidate scoring + greedy matching ----
  struct Conn {
    int cid1, cid2;
    float score;
  };
  std::vector<Conn> conns_per_pair[kNumPairs];
  std::vector<Candidate> candidates;
  std::vector<char> used_a, used_b;
  for (int pair = 0; pair < kNumPairs; ++pair) {
    const auto& list_a = by_part[kPairs[pair][0]];
    const auto& list_b = by_part[kPairs[pair][1]];
    if (list_a.empty() || list_b.empty()) continue;
    const int ch_x = kPairChannels[pair][0];
    const int ch_y = kPairChannels[pair][1];

    candidates.clear();
    for (int ia = 0; ia < static_cast<int>(list_a.size()); ++ia) {
      const PeakRec& a = list_a[ia];
      for (int ib = 0; ib < static_cast<int>(list_b.size()); ++ib) {
        const PeakRec& b = list_b[ib];
        const float dx = static_cast<float>(b.x - a.x);
        const float dy = static_cast<float>(b.y - a.y);
        const float norm = std::sqrt(dx * dx + dy * dy);
        if (norm < 1e-12f) continue;
        const float ux = dx / norm, uy = dy / norm;

        float total = 0.0f;
        int above = 0;
        const float step_x = dx / static_cast<float>(n_steps);
        const float step_y = dy / static_cast<float>(n_steps);
        for (int s = 0; s < n_steps; ++s) {
          const int lx = round_half_up(a.x + s * step_x);
          const int ly = round_half_up(a.y + s * step_y);
          const int gx = clampi(lx / stride, 0, w - 1);
          const int gy = clampi(ly / stride, 0, h - 1);
          const float* cell = pafs + (static_cast<size_t>(gy) * w + gx) * 38;
          const float dot = ux * cell[ch_x] + uy * cell[ch_y];
          total += dot;
          if (dot > thresh_paf) ++above;
        }
        const float score =
            total / n_steps +
            std::min(0.0f, 0.5f * up_h / norm - 1.0f);
        if (above > thresh_vector_cnt1 && score > 0.0f) {
          candidates.push_back({score, ia, ib});
        }
      }
    }

    std::stable_sort(candidates.begin(), candidates.end(),
                     [](const Candidate& x, const Candidate& y) {
                       return x.score > y.score;
                     });
    used_a.assign(list_a.size(), 0);
    used_b.assign(list_b.size(), 0);
    for (const Candidate& c : candidates) {
      if (used_a[c.ia] || used_b[c.ib]) continue;
      used_a[c.ia] = used_b[c.ib] = 1;
      conns_per_pair[pair].push_back(
          {list_a[c.ia].gid, list_b[c.ib].gid, c.score});
    }
  }

  // ---- sequential person-row merging ----
  std::vector<std::array<float, kRowLen>> subset;
  for (int pair = 0; pair < kNumPairs; ++pair) {
    const int p1 = kPairs[pair][0];
    const int p2 = kPairs[pair][1];
    for (const Conn& conn : conns_per_pair[pair]) {
      int match1 = -1, match2 = -1, found = 0;
      for (int si = 0; si < static_cast<int>(subset.size()); ++si) {
        if (subset[si][p1] == static_cast<float>(conn.cid1) ||
            subset[si][p2] == static_cast<float>(conn.cid2)) {
          if (found == 0) match1 = si;
          if (found == 1) match2 = si;
          ++found;
        }
      }
      if (found == 1) {
        auto& row = subset[match1];
        if (row[p2] != static_cast<float>(conn.cid2)) {
          row[p2] = static_cast<float>(conn.cid2);
          row[19] += 1.0f;
          row[18] += score_by_gid[conn.cid2] + conn.score;
        }
      } else if (found == 2) {
        auto& row1 = subset[match1];
        auto& row2 = subset[match2];
        bool overlap = false;
        for (int j = 0; j < kNumParts; ++j) {
          if (row1[j] > 0 && row2[j] > 0) overlap = true;
        }
        if (!overlap) {
          for (int j = 0; j < kNumParts; ++j) row1[j] += row2[j] + 1.0f;
          row1[18] += row2[18] + conn.score;
          row1[19] += row2[19];
          subset.erase(subset.begin() + match2);
        } else {
          row1[p2] = static_cast<float>(conn.cid2);
          row1[19] += 1.0f;
          row1[18] += score_by_gid[conn.cid2] + conn.score;
        }
      } else if (found == 0 && pair < kNumPairs - 1) {
        std::array<float, kRowLen> row;
        row.fill(-1.0f);
        row[p1] = static_cast<float>(conn.cid1);
        row[p2] = static_cast<float>(conn.cid2);
        row[19] = 2.0f;
        row[18] =
            score_by_gid[conn.cid1] + score_by_gid[conn.cid2] + conn.score;
        subset.push_back(row);
      }
      // found > 2: connection dropped (reference behavior)
    }
  }

  // ---- final filter + write out ----
  int n_out = 0;
  for (const auto& row : subset) {
    if (row[19] < thresh_part_cnt || row[18] / row[19] < thresh_human_score) {
      continue;
    }
    if (n_out >= max_people) break;
    std::memcpy(out_subset + static_cast<size_t>(n_out) * kRowLen, row.data(),
                kRowLen * sizeof(float));
    ++n_out;
  }
  return n_out;
}

}  // extern "C"
