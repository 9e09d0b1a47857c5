// ctc_beam.cc: merged-prefix CTC beam search (host decoder), the port's own
// copy of the JAX package's csrc/ctc_beam.cc.
//
// Native implementation of the same algorithm as
// srf_tpu_torch/ops/ctc_decode.py:prefix_beam_search (blank/non-blank probability
// split per prefix, Hannun-style), replacing the C++ decoder the reference
// delegated to via tf.nn.ctc_beam_search_decoder
// (reference: tfsr/trainer_sr.py:110-112). Exposed via ctypes.
//
// Built with g++ at first use by srf_tpu_torch/utils/native.py into
// srf_tpu_torch/_build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kLogZero = -1e30;

inline double LogSumExp(double a, double b) {
  if (a <= kLogZero) return b;
  if (b <= kLogZero) return a;
  double m = a > b ? a : b;
  return m + std::log(std::exp(a - m) + std::exp(b - m));
}

struct Hyp {
  double p_b;
  double p_nb;
};

}  // namespace

extern "C" {

// logits: [T, K] row-major (pre-softmax). Returns hypothesis length, writes
// ids into out_ids (capacity max_out). blank < K. prune_logp: skip extension
// symbols whose frame log-prob is below (max - prune_logp); <= 0 disables
// pruning (exact). Returns -1 on error.
int64_t srf_ctc_beam_search_pruned(const float* logits, int64_t T, int64_t K,
                                   int64_t beam_width, int64_t blank,
                                   double prune_logp, int32_t* out_ids,
                                   int64_t max_out) {
  if (T < 0 || K <= 0 || beam_width <= 0 || blank < 0 || blank >= K) return -1;

  // prefix trie
  std::vector<int32_t> parent{-1};
  std::vector<int32_t> symbol{-1};
  std::unordered_map<uint64_t, int32_t> children;

  auto child_of = [&](int32_t node, int32_t sym) -> int32_t {
    uint64_t key = (static_cast<uint64_t>(node) << 32) |
                   static_cast<uint32_t>(sym);
    auto it = children.find(key);
    if (it != children.end()) return it->second;
    int32_t id = static_cast<int32_t>(parent.size());
    parent.push_back(node);
    symbol.push_back(sym);
    children.emplace(key, id);
    return id;
  };

  std::unordered_map<int32_t, Hyp> beams;
  beams.emplace(0, Hyp{0.0, kLogZero});

  std::vector<double> lp(K);
  std::vector<std::pair<int32_t, Hyp>> scored;

  for (int64_t t = 0; t < T; ++t) {
    const float* row = logits + t * K;
    double mx = -std::numeric_limits<double>::infinity();
    for (int64_t k = 0; k < K; ++k) mx = std::max(mx, double(row[k]));
    double denom = 0.0;
    for (int64_t k = 0; k < K; ++k) denom += std::exp(double(row[k]) - mx);
    double log_denom = mx + std::log(denom);
    for (int64_t k = 0; k < K; ++k) lp[k] = double(row[k]) - log_denom;
    double floor = (prune_logp > 0) ? (mx - log_denom) - prune_logp : -1e300;

    std::unordered_map<int32_t, Hyp> next;
    next.reserve(beams.size() * 4);
    auto acc = [&](int32_t node, bool is_blank, double value) {
      auto it = next.emplace(node, Hyp{kLogZero, kLogZero}).first;
      if (is_blank)
        it->second.p_b = LogSumExp(it->second.p_b, value);
      else
        it->second.p_nb = LogSumExp(it->second.p_nb, value);
    };

    for (const auto& kv : beams) {
      int32_t node = kv.first;
      double p_b = kv.second.p_b, p_nb = kv.second.p_nb;
      double p_tot = LogSumExp(p_b, p_nb);
      int32_t last = symbol[node];
      for (int64_t k = 0; k < K; ++k) {
        double lpk = lp[k];
        if (k != blank && lpk < floor) continue;
        if (k == blank) {
          acc(node, true, p_tot + lpk);
        } else if (static_cast<int32_t>(k) == last) {
          acc(node, false, p_nb + lpk);
          acc(child_of(node, k), false, p_b + lpk);
        } else {
          acc(child_of(node, k), false, p_tot + lpk);
        }
      }
    }

    scored.assign(next.begin(), next.end());
    std::sort(scored.begin(), scored.end(),
              [](const std::pair<int32_t, Hyp>& a,
                 const std::pair<int32_t, Hyp>& b) {
                return LogSumExp(a.second.p_b, a.second.p_nb) >
                       LogSumExp(b.second.p_b, b.second.p_nb);
              });
    if (static_cast<int64_t>(scored.size()) > beam_width)
      scored.resize(beam_width);
    beams.clear();
    for (const auto& kv : scored) beams.emplace(kv.first, kv.second);
  }

  int32_t best = 0;
  double best_score = -std::numeric_limits<double>::infinity();
  for (const auto& kv : beams) {
    double s = LogSumExp(kv.second.p_b, kv.second.p_nb);
    if (s > best_score) {
      best_score = s;
      best = kv.first;
    }
  }

  std::vector<int32_t> rev;
  for (int32_t node = best; node > 0; node = parent[node])
    rev.push_back(symbol[node]);
  int64_t n = static_cast<int64_t>(rev.size());
  if (n > max_out) return -1;
  for (int64_t i = 0; i < n; ++i) out_ids[i] = rev[n - 1 - i];
  return n;
}

// Exact (unpruned) variant — the scoring path's default.
int64_t srf_ctc_beam_search(const float* logits, int64_t T, int64_t K,
                            int64_t beam_width, int64_t blank,
                            int32_t* out_ids, int64_t max_out) {
  return srf_ctc_beam_search_pruned(logits, T, K, beam_width, blank, 0.0,
                                    out_ids, max_out);
}

}  // extern "C"
