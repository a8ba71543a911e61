// Native host-side ranking postprocess engine (a copy of
// vqwild_tpu/native/engine.cpp; host C++, no device code).
//
// Replaces the reference's fork-based multiprocessing eval pool
// (dataloader_baseline.py:1223-1366) for the moment-retrieval hot path:
// per-query full ranking -> per-video clustering -> temporal NMS (ignored
// moments participate) -> grouped-order AP (sklearn tie semantics + the
// robust-mAP quirk) and R@N. The GPU produces the [Q, G] score matrix (kernel
// K1); this engine consumes it on the host with a std::thread pool, one
// query per task.
//
// Exported C ABI (ctypes): vq_temporal_nms, vq_moment_batch, vq_version.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

int vq_version() { return 1; }

// Greedy 1-D temporal NMS with the +1 length convention
// (utils_models.py:153-174). dets: [n,3] rows (start, end, score).
// keep_out receives kept row indices in descending-score order; returns count.
int vq_temporal_nms(const float* dets, int n, float thresh, int* keep_out) {
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return dets[a * 3 + 2] > dets[b * 3 + 2];
  });
  std::vector<char> suppressed(n, 0);
  int count = 0;
  for (int oi = 0; oi < n; ++oi) {
    int i = order[oi];
    if (suppressed[i]) continue;
    keep_out[count++] = i;
    float x1 = dets[i * 3], x2 = dets[i * 3 + 1];
    float len_i = x2 - x1 + 1.0f;
    for (int oj = oi + 1; oj < n; ++oj) {
      int j = order[oj];
      if (suppressed[j]) continue;
      float y1 = dets[j * 3], y2 = dets[j * 3 + 1];
      float inter = std::max(0.0f, std::min(x2, y2) - std::max(x1, y1) + 1.0f);
      float iou = inter / (len_i + (y2 - y1 + 1.0f) - inter);
      if (iou >= thresh) suppressed[j] = 1;
    }
  }
  return count;
}

namespace {

// sklearn average_precision_score for binary labels incl. tie handling:
// precision evaluated at each distinct-score group boundary.
double average_precision(const std::vector<char>& y_true,
                         const std::vector<float>& y_score) {
  const int n = static_cast<int>(y_true.size());
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return y_score[a] > y_score[b];
  });
  double npos = 0;
  for (char t : y_true) npos += t;
  if (npos == 0) return 0.0;

  // forward pass: cumulative tp; boundary = last index of a tie group
  std::vector<double> prec(n);
  double cum_tp = 0;
  for (int i = 0; i < n; ++i) {
    cum_tp += y_true[order[i]];
    prec[i] = cum_tp / (i + 1);
  }
  // backward fill of group-boundary precision
  std::vector<double> group_prec(n);
  double current = prec[n - 1];
  for (int i = n - 1; i >= 0; --i) {
    if (i == n - 1 || y_score[order[i]] != y_score[order[i + 1]]) {
      current = prec[i];
    }
    group_prec[i] = current;
  }
  double ap = 0;
  for (int i = 0; i < n; ++i) {
    if (y_true[order[i]]) ap += group_prec[i] / npos;
  }
  return ap;
}

struct QueryTask {
  const float* scores;       // [n]
  const int* video_idx;      // [n]
  const float* start;        // [n]
  const float* end;          // [n]
  const int* hit_label;      // [n]
  const float* hit_iou;      // [n]
  int q_label;
  const int* ignore_vids;    // [max_ig], -1 padded (video indices)
  int max_ig;
  int n;
  float nms_thresh, tiou_thresh;
  const int* rn;
  int n_rn;
  int robust;
  double* ap_out;            // scalar
  double* recalls_out;       // [n_rn]
};

void run_query(const QueryTask& t) {
  const int n = t.n;
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return t.scores[a] > t.scores[b];
  });

  // cluster by video in ranked order (first-appearance order of videos)
  std::unordered_map<int, int> video_to_cluster;
  std::vector<std::vector<int>> clusters;
  video_to_cluster.reserve(n / 4);
  for (int oi = 0; oi < n; ++oi) {
    int g = order[oi];
    auto it = video_to_cluster.find(t.video_idx[g]);
    if (it == video_to_cluster.end()) {
      video_to_cluster.emplace(t.video_idx[g], (int)clusters.size());
      clusters.emplace_back();
      clusters.back().push_back(g);
    } else {
      clusters[it->second].push_back(g);
    }
  }

  // NMS per cluster (members already descending by score); ignored moments
  // participate and can suppress valid ones (dataloader:1283-1314)
  std::vector<int> grouped;
  grouped.reserve(n / 2);
  std::vector<char> sup;
  for (auto& members : clusters) {
    const int m = (int)members.size();
    sup.assign(m, 0);
    for (int i = 0; i < m; ++i) {
      if (sup[i]) continue;
      int gi = members[i];
      grouped.push_back(gi);
      float x1 = t.start[gi], x2 = t.end[gi];
      float len_i = x2 - x1 + 1.0f;
      for (int j = i + 1; j < m; ++j) {
        if (sup[j]) continue;
        int gj = members[j];
        float inter = std::max(
            0.0f, std::min(x2, t.end[gj]) - std::max(x1, t.start[gj]) + 1.0f);
        float iou = inter / (len_i + (t.end[gj] - t.start[gj] + 1.0f) - inter);
        if (iou >= t.nms_thresh) sup[j] = 1;
      }
    }
  }

  // drop ignored (grouped order preserved), assign tp
  std::vector<char> y_true;
  std::vector<float> kept_scores;
  y_true.reserve(grouped.size());
  kept_scores.reserve(grouped.size());
  for (int g : grouped) {
    bool ignored = false;
    for (int k = 0; k < t.max_ig; ++k) {
      if (t.ignore_vids[k] < 0) break;
      if (t.ignore_vids[k] == t.video_idx[g]) {
        ignored = true;
        break;
      }
    }
    if (ignored) continue;
    bool tp = (t.hit_label[g] == t.q_label) && (t.hit_iou[g] >= t.tiou_thresh);
    y_true.push_back(tp ? 1 : 0);
    kept_scores.push_back(t.scores[g]);
  }
  if (y_true.empty()) {
    *t.ap_out = 0.0;
    for (int k = 0; k < t.n_rn; ++k) t.recalls_out[k] = 0.0;
    return;
  }
  // R@N on the unmodified labels, grouped order (dataloader:393-401)
  double npos = 0;
  for (char v : y_true) npos += v;
  for (int k = 0; k < t.n_rn; ++k) {
    int lim = std::min<int>(t.rn[k], (int)y_true.size());
    double hits = 0;
    for (int i = 0; i < lim; ++i) hits += y_true[i];
    t.recalls_out[k] = hits / (npos + 1e-10);
  }
  // robust-mAP quirk: flip the last grouped item for AP only (dataloader:389)
  if (t.robust) y_true.back() = 1;
  *t.ap_out = average_precision(y_true, kept_scores);
}

}  // namespace

// Batch moment postprocess over Q queries with a thread pool.
int vq_moment_batch(const float* scores,      // [Q, n]
                    const int* video_idx,     // [n]
                    const float* start,       // [n]
                    const float* end,         // [n]
                    const int* hit_label,     // [n]
                    const float* hit_iou,     // [n]
                    const int* q_label,       // [Q]
                    const int* ignore_vids,   // [Q, max_ig], -1 padded
                    int max_ig, int Q, int n, float nms_thresh,
                    float tiou_thresh, const int* rn, int n_rn, int robust,
                    int n_threads, double* ap_out, double* recalls_out) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int q = next.fetch_add(1);
      if (q >= Q) break;
      QueryTask t{scores + (size_t)q * n,
                  video_idx,
                  start,
                  end,
                  hit_label,
                  hit_iou,
                  q_label[q],
                  ignore_vids + (size_t)q * max_ig,
                  max_ig,
                  n,
                  nms_thresh,
                  tiou_thresh,
                  rn,
                  n_rn,
                  robust,
                  ap_out + q,
                  recalls_out + (size_t)q * n_rn};
      run_query(t);
    }
  };
  int nt = std::max(1, std::min(n_threads, Q));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int i = 0; i < nt; ++i) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
