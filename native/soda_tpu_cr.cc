// soda-tpu-cr: native computation-reuse scheduler.
//
// Drop-in for the reference's external `soda-cr` binary (invoked from
// soda_tpu.optimization.cr_schedules.ExternalSchedules over the same
// JSON protocol as reference computation_reuse.py:1692-1743):
//
//   stdin : {"rattrs": [int...], "aattrs": [int...],
//            "num_pruned": int,
//            "linearizer": {"maxs": [...], "mins": [...],
//                           "sizes": [...]}?}
//   stdout: schedule tree {"left": <tree|int>, "right": <tree|int>,
//           "distance": int}, leaves = aattr values.
//
// Algorithm: the same greedy pairwise-reuse search as the in-process
// Python scheduler (conflict-group parity handling, dimension-aligned
// filtering, beam of num_pruned), with cost = (unique operation count,
// reuse-distance upper bound from the max-production-offset feasible
// point of the distance LP). Being native, it sustains a much wider
// beam than the Python fallback for large windows.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <chrono>
#include <map>
#include <memory>
#include <set>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

using std::int64_t;
using Clock = std::chrono::steady_clock;

// ---------------------------------------------------------------- JSON in
struct Parser {
  const std::string& s;
  size_t pos = 0;
  explicit Parser(const std::string& str) : s(str) {}

  void skip() {
    while (pos < s.size() && std::isspace(static_cast<unsigned char>(s[pos])))
      ++pos;
  }
  bool consume(char c) {
    skip();
    if (pos < s.size() && s[pos] == c) { ++pos; return true; }
    return false;
  }
  void expect(char c) {
    if (!consume(c)) {
      std::fprintf(stderr, "parse error: expected '%c' at %zu\n", c, pos);
      std::exit(1);
    }
  }
  int64_t parse_int() {
    skip();
    char* end = nullptr;
    int64_t v = std::strtoll(s.c_str() + pos, &end, 10);
    pos = static_cast<size_t>(end - s.c_str());
    return v;
  }
  std::string parse_string() {
    expect('"');
    std::string out;
    while (pos < s.size() && s[pos] != '"') out.push_back(s[pos++]);
    expect('"');
    return out;
  }
  std::vector<int64_t> parse_int_array() {
    std::vector<int64_t> out;
    expect('[');
    if (consume(']')) return out;
    do {
      out.push_back(parse_int());
    } while (consume(','));
    expect(']');
    return out;
  }
};

struct Input {
  std::vector<int64_t> rattrs, aattrs;
  std::vector<int64_t> lin_maxs, lin_mins, lin_sizes;
  int num_pruned = 5;
  bool has_linearizer = false;
};

Input parse_input(const std::string& text) {
  Input in;
  Parser p(text);
  p.expect('{');
  if (p.consume('}')) return in;
  do {
    std::string key = p.parse_string();
    p.expect(':');
    if (key == "rattrs") {
      in.rattrs = p.parse_int_array();
    } else if (key == "aattrs") {
      in.aattrs = p.parse_int_array();
    } else if (key == "num_pruned") {
      in.num_pruned = static_cast<int>(p.parse_int());
    } else if (key == "linearizer") {
      in.has_linearizer = true;
      p.expect('{');
      if (!p.consume('}')) {
        do {
          std::string lk = p.parse_string();
          p.expect(':');
          auto arr = p.parse_int_array();
          if (lk == "maxs") in.lin_maxs = arr;
          else if (lk == "mins") in.lin_mins = arr;
          else if (lk == "sizes") in.lin_sizes = arr;
        } while (p.consume(','));
        p.expect('}');
      }
    } else {
      std::fprintf(stderr, "unknown key: %s\n", key.c_str());
      std::exit(1);
    }
  } while (p.consume(','));
  p.expect('}');
  return in;
}

// ------------------------------------------------------------- linearizer
struct Linearizer {
  std::vector<int64_t> mins, sizes, weights;
  bool valid = false;

  void init(const Input& in) {
    if (!in.has_linearizer || in.lin_mins.empty()) return;
    mins = in.lin_mins;
    sizes = in.lin_sizes;
    weights.assign(mins.size(), 1);
    for (size_t d = 1; d < mins.size(); ++d)
      weights[d] = weights[d - 1] * sizes[d - 1];
    valid = true;
  }
  std::vector<int64_t> restore(int64_t x) const {
    std::vector<int64_t> out(mins.size());
    for (size_t i = mins.size(); i-- > 0;) {
      int64_t v = x / weights[i];
      x -= v * weights[i];
      out[i] = mins[i] + v;
    }
    return out;
  }
  // Signed per-dimension delta of a RELATIVE linear offset, BALANCED
  // decode (centered residue per radix) — floor/truncating decode
  // misreads mixed-sign deltas like (dx=-1, dy=+1) as an axis-aligned
  // (size-1, 0), exactly the Python-side _axis_aligned defect fixed in
  // review pass 7 (soda_tpu/optimization/computation_reuse.py delta()).
  std::vector<int64_t> delta(int64_t offset) const {
    std::vector<int64_t> out(mins.size());
    for (size_t d = 0; d + 1 < mins.size(); ++d) {
      int64_t radix = sizes[d];
      int64_t digit =
          ((offset + radix / 2) % radix + radix) % radix - radix / 2;
      out[d] = digit;
      offset = (offset - digit) / radix;
    }
    out[mins.size() - 1] = offset;
    return out;
  }
  // distance aligns with dim iff the delta is nonzero only in that dim
  bool aligns(int64_t dis, size_t dim) const {
    auto dl = delta(dis);
    for (size_t d = 0; d < dl.size(); ++d) {
      if (d == dim) {
        if (dl[d] == 0) return false;
      } else {
        if (dl[d] != 0) return false;
      }
    }
    return true;
  }
};

// ------------------------------------------------------------- schedules
// Payload: leaf aattr value (kLeafBase + value-id) or expr id.
constexpr int64_t kLeafBase = INT64_C(1) << 40;

struct Expr;
using ExprPtr = std::shared_ptr<const Expr>;

struct Expr {
  // child payload: either leaf aattr VALUE or subtree
  int64_t left_leaf = 0, right_leaf = 0;
  ExprPtr left, right;
  int64_t distance;
  // canonical identity: sorted (offset, payload-id) multiset
  std::vector<std::pair<int64_t, int64_t>> attrs;
  int64_t id = -1;  // interned id
};

struct Interner {
  std::map<std::vector<std::pair<int64_t, int64_t>>, int64_t> ids;
  int64_t next = 0;
  int64_t intern(const std::vector<std::pair<int64_t, int64_t>>& attrs) {
    auto it = ids.find(attrs);
    if (it != ids.end()) return it->second;
    ids.emplace(attrs, next);
    return next++;
  }
};

Interner g_interner;

ExprPtr make_expr(ExprPtr l, int64_t lleaf, ExprPtr r, int64_t rleaf,
                  int64_t distance) {
  auto e = std::make_shared<Expr>();
  e->left = std::move(l);
  e->right = std::move(r);
  e->left_leaf = lleaf;
  e->right_leaf = rleaf;
  e->distance = distance;
  // build attr multiset
  if (e->left) {
    for (auto& a : e->left->attrs) e->attrs.push_back(a);
  } else {
    e->attrs.emplace_back(0, kLeafBase + lleaf);
  }
  if (e->right) {
    for (auto& a : e->right->attrs)
      e->attrs.emplace_back(a.first + distance, a.second);
  } else {
    e->attrs.emplace_back(distance, kLeafBase + rleaf);
  }
  std::sort(e->attrs.begin(), e->attrs.end());
  const_cast<Expr*>(e.get())->id = g_interner.intern(e->attrs);
  return e;
}

void collect_ops(const ExprPtr& e, std::set<int64_t>* ops) {
  ops->insert(e->id);
  if (e->left) collect_ops(e->left, ops);
  if (e->right) collect_ops(e->right, ops);
}

int num_ops(const ExprPtr& e) {
  std::set<int64_t> ops;
  collect_ops(e, &ops);
  return static_cast<int>(ops.size());
}

// Reuse-distance upper bound: feasible point of the distance LP
// (reference ILP #3) with all production offsets maximized
// (shortest-path over the difference constraints).
int64_t distance_bound(const ExprPtr& top) {
  // unique exprs + use counts
  std::unordered_map<int64_t, ExprPtr> uniq;
  std::unordered_map<int64_t, int> count;
  std::vector<ExprPtr> stack{top};
  while (!stack.empty()) {
    ExprPtr e = stack.back();
    stack.pop_back();
    ++count[e->id];
    uniq.emplace(e->id, e);
    if (e->left) stack.push_back(e->left);
    if (e->right) stack.push_back(e->right);
  }
  // vars = top + exprs used more than once; var 0 = input leaf space
  std::unordered_map<int64_t, int> var_of;  // expr id -> var id
  var_of[top->id] = 1;
  std::vector<ExprPtr> var_exprs{nullptr, top};
  for (auto& kv : uniq) {
    if (count[kv.first] > 1 && !var_of.count(kv.first)) {
      var_of[kv.first] = static_cast<int>(var_exprs.size());
      var_exprs.push_back(kv.second);
    }
  }
  int n = static_cast<int>(var_exprs.size());
  // dependees[dst][src] = (min_offset, max_offset)
  std::vector<std::map<int, std::pair<int64_t, int64_t>>> dependees(n);

  struct Frame { const Expr* e; int64_t off; };
  for (int dst = 1; dst < n; ++dst) {
    std::vector<Frame> todo{{var_exprs[dst].get(), 0}};
    bool is_root = true;
    while (!todo.empty()) {
      auto [e, off] = todo.back();
      todo.pop_back();
      auto it = var_of.find(e->id);
      int src = -1;
      if (!is_root && it != var_of.end()) {
        src = it->second;
      }
      is_root = false;
      if (src >= 0) {
        auto cur = dependees[dst].find(src);
        if (cur == dependees[dst].end())
          dependees[dst][src] = {off, off};
        else {
          cur->second.first = std::min(cur->second.first, off);
          cur->second.second = std::max(cur->second.second, off);
        }
        continue;
      }
      if (e->left) todo.push_back({e->left.get(), off});
      else {
        auto cur = dependees[dst].find(0);
        if (cur == dependees[dst].end()) dependees[dst][0] = {off, off};
        else {
          cur->second.first = std::min(cur->second.first, off);
          cur->second.second = std::max(cur->second.second, off);
        }
      }
      if (e->right) todo.push_back({e->right.get(), off + e->distance});
      else {
        int64_t o = off + e->distance;
        auto cur = dependees[dst].find(0);
        if (cur == dependees[dst].end()) dependees[dst][0] = {o, o};
        else {
          cur->second.first = std::min(cur->second.first, o);
          cur->second.second = std::max(cur->second.second, o);
        }
      }
    }
  }
  // p_src <= mn + p_dst; maximize p via Bellman-Ford (p_0 = p_1 = 0)
  const int64_t INF = INT64_C(1) << 60;
  std::vector<int64_t> p(n, INF);
  p[0] = 0;
  p[1] = 0;
  for (int iter = 0; iter < n + 1; ++iter) {
    bool changed = false;
    for (int dst = 1; dst < n; ++dst) {
      if (p[dst] == INF) continue;
      for (auto& kv : dependees[dst]) {
        int64_t bound = kv.second.first + p[dst];
        if (bound < p[kv.first]) {
          p[kv.first] = bound;
          changed = true;
        }
      }
    }
    if (!changed) break;
  }
  // clamp pinned vars (p_0/p_1 may have been driven negative: the LP
  // would shift; for an upper bound just renormalize)
  for (int v = 0; v < n; ++v)
    if (p[v] == INF) p[v] = 0;
  int64_t total = 0;
  std::vector<int64_t> q(n, -INF);
  for (int dst = 1; dst < n; ++dst)
    for (auto& kv : dependees[dst])
      q[kv.first] = std::max(q[kv.first], kv.second.second + p[dst]);
  for (int v = 0; v < n; ++v) {
    if (q[v] == -INF) continue;
    if (v == 1) continue;
    total += q[v] - p[v];
  }
  return total;
}

struct Operand {
  int64_t rattr;
  int64_t leaf;     // aattr value if payload == nullptr
  ExprPtr payload;  // nested schedule or null
  int64_t pid() const { return payload ? payload->id : kLeafBase + leaf; }
};

ExprPtr linearize(const std::vector<Operand>& ops) {
  ExprPtr sched =
      make_expr(ops[0].payload, ops[0].leaf, ops[1].payload, ops[1].leaf,
                ops[1].rattr - ops[0].rattr);
  for (size_t i = 2; i < ops.size(); ++i)
    sched = make_expr(sched, 0, ops[i].payload, ops[i].leaf,
                      ops[i].rattr - ops[0].rattr);
  return sched;
}

// Comparison key: the reference (num_ops, distance) tuple.
using CostKey = std::tuple<int, int64_t>;

struct Candidate {
  std::vector<Operand> ops;
  bool conflict = false;
  // comparison key: cost of the linear schedule over the operands
  CostKey key;
};

CostKey cost_of(const ExprPtr& e) {
  return {num_ops(e), distance_bound(e)};
}

struct Greedy {
  const Linearizer* lin;
  int beam;
  Clock::time_point deadline;
  ExprPtr best;
  CostKey best_cost{INT32_MAX, INT64_MAX};

  void consider(const ExprPtr& e) {
    auto c = cost_of(e);
    if (c < best_cost) {
      best_cost = c;
      best = e;
    }
  }

  void search(const std::vector<Operand>& operands) {
    if (Clock::now() > deadline) return;
    if (operands.size() == 1) {
      if (operands[0].payload) consider(operands[0].payload);
      return;
    }
    // count candidate operations (distance, payload pair)
    struct Reuse {
      std::vector<std::pair<int, int>> pairs;
      bool conflict = false;
    };
    std::map<std::tuple<int64_t, int64_t, int64_t>, Reuse> reuses;
    std::map<std::pair<int64_t, int64_t>, int> attr_map;
    for (size_t i = 0; i < operands.size(); ++i)
      attr_map[{operands[i].rattr, operands[i].pid()}] =
          static_cast<int>(i);
    for (size_t i = 0; i < operands.size(); ++i) {
      for (size_t j = i + 1; j < operands.size(); ++j) {
        int64_t distance = operands[j].rattr - operands[i].rattr;
        auto op_key = std::make_tuple(distance, operands[i].pid(),
                                      operands[j].pid());
        if (reuses.count(op_key)) continue;
        Reuse reuse;
        // conflict groups
        std::vector<std::vector<std::pair<int, int>>> groups;
        std::map<int, int> group_of;
        for (size_t l = 0; l < operands.size(); ++l) {
          if (operands[l].pid() != operands[i].pid()) continue;
          auto it = attr_map.find(
              {operands[l].rattr + distance, operands[j].pid()});
          if (it == attr_map.end() ||
              it->second == static_cast<int>(l))
            continue;
          int r = it->second;
          int gid;
          auto g1 = group_of.find(static_cast<int>(l));
          auto g2 = group_of.find(r);
          if (g1 != group_of.end()) gid = g1->second;
          else if (g2 != group_of.end()) gid = g2->second;
          else {
            gid = static_cast<int>(groups.size());
            groups.emplace_back();
          }
          groups[gid].emplace_back(static_cast<int>(l), r);
          group_of[static_cast<int>(l)] = gid;
          group_of[r] = gid;
        }
        for (auto& g : groups)
          if (g.size() > 1) reuse.conflict = true;
        for (auto& g : groups)
          if (g.size() % 2 != 0)
            for (size_t k = 0; k < g.size(); k += 2)
              reuse.pairs.push_back(g[k]);
        int min_l = INT32_MAX, max_l = INT32_MIN;
        for (auto& pr : reuse.pairs) {
          min_l = std::min(min_l, pr.first);
          max_l = std::max(max_l, pr.first);
        }
        if (reuse.pairs.empty()) { min_l = 0; max_l = -1; }
        for (auto& g : groups) {
          if (g.size() % 2 != 0 || g.empty()) continue;
          auto span = [&](size_t start) {
            int lo = static_cast<int>(g[start].first);
            int hi = static_cast<int>(g[g.size() - 2 + start].first);
            // ALWAYS clamp (defaults min 0 / max -1), exactly like the
            // Python/reference greedy (cr_schedules.py:486-493,
            // reference computation_reuse.py:1209-1220): with no odd
            // pairs this pins lo to 0 and leaves hi, making span_1 >=
            // span_0 and the even-side pick deterministic
            lo = std::min(lo, min_l);
            hi = std::max(hi, max_l);
            return operands[hi].rattr - operands[lo].rattr;
          };
          size_t start = span(1) < span(0) ? 1 : 0;
          for (size_t k = start; k < g.size(); k += 2)
            reuse.pairs.push_back(g[k]);
        }
        std::sort(reuse.pairs.begin(), reuse.pairs.end());
        if (reuse.pairs.size() > 1) reuses.emplace(op_key, reuse);
      }
    }
    if (reuses.empty()) {
      consider(linearize(operands));
      return;
    }
    // dimension-aligned filtering
    if (lin && lin->valid && reuses.size() > operands.size()) {
      for (size_t d = lin->mins.size(); d-- > 0;) {
        bool any = false;
        for (auto& kv : reuses)
          if (lin->aligns(std::get<0>(kv.first), d)) { any = true; break; }
        if (!any) continue;
        std::map<std::tuple<int64_t, int64_t, int64_t>, Reuse> filtered;
        for (auto& kv : reuses) {
          if (!lin->aligns(std::get<0>(kv.first), d)) continue;
          filtered.emplace(kv.first, kv.second);
        }
        reuses = std::move(filtered);
        break;
      }
    }
    // one candidate per operation, beam of `beam`
    std::vector<Candidate> candidates;
    for (auto& kv : reuses) {
      std::map<int, Operand> new_ops;
      for (size_t i = 0; i < operands.size(); ++i)
        new_ops[static_cast<int>(i)] = operands[i];
      std::set<int> used;
      auto apply = [&](const std::tuple<int64_t, int64_t, int64_t>& key,
                       const Reuse& r) {
        std::vector<std::pair<int, int>> avail;
        for (auto& pr : r.pairs)
          if (!used.count(pr.first) && !used.count(pr.second))
            avail.push_back(pr);
        if (avail.size() > 1) {
          for (auto& pr : avail) {
            const Operand& l = operands[pr.first];
            const Operand& rr = operands[pr.second];
            ExprPtr sub = make_expr(l.payload, l.leaf, rr.payload, rr.leaf,
                                    std::get<0>(key));
            new_ops[pr.first] =
                Operand{l.rattr, 0, sub};
            new_ops.erase(pr.second);
            used.insert(pr.first);
            used.insert(pr.second);
          }
        }
      };
      apply(kv.first, kv.second);
      // then other operations, most pairs first, shortest distance next
      std::vector<const decltype(reuses)::value_type*> rest;
      for (auto& other : reuses) rest.push_back(&other);
      std::sort(rest.begin(), rest.end(), [](auto* a, auto* b) {
        if (a->second.pairs.size() != b->second.pairs.size())
          return a->second.pairs.size() > b->second.pairs.size();
        return std::get<0>(a->first) < std::get<0>(b->first);
      });
      for (auto* other : rest) apply(other->first, other->second);
      Candidate cand;
      cand.conflict = kv.second.conflict;
      for (auto& kv2 : new_ops) cand.ops.push_back(kv2.second);
      cand.key = cost_of(linearize(cand.ops));
      candidates.push_back(std::move(cand));
    }
    std::sort(candidates.begin(), candidates.end(),
              [](const Candidate& a, const Candidate& b) {
                if (a.conflict != b.conflict) return !a.conflict;
                return a.key < b.key;
              });
    if (static_cast<int>(candidates.size()) > beam)
      candidates.resize(beam);
    for (auto& cand : candidates) search(cand.ops);
  }
};

// ---------------------------------------------------------------- JSON out
void emit(const ExprPtr& e, std::string* out) {
  out->append("{\"distance\": ");
  out->append(std::to_string(e->distance));
  out->append(", \"left\": ");
  if (e->left) emit(e->left, out);
  else out->append(std::to_string(e->left_leaf));
  out->append(", \"right\": ");
  if (e->right) emit(e->right, out);
  else out->append(std::to_string(e->right_leaf));
  out->append("}");
}

}  // namespace

int main() {
  std::string text, line;
  {
    char buf[1 << 16];
    size_t n;
    while ((n = std::fread(buf, 1, sizeof buf, stdin)) > 0)
      text.append(buf, n);
  }
  Input in = parse_input(text);
  if (in.rattrs.size() < 2 || in.rattrs.size() != in.aattrs.size()) {
    std::fprintf(stderr, "need >= 2 operands with matching aattrs\n");
    return 1;
  }
  Linearizer lin;
  lin.init(in);

  std::vector<Operand> operands(in.rattrs.size());
  for (size_t i = 0; i < in.rattrs.size(); ++i)
    operands[i] = Operand{in.rattrs[i], in.aattrs[i], nullptr};
  std::sort(operands.begin(), operands.end(),
            [](const Operand& a, const Operand& b) {
              return a.rattr < b.rattr;
            });

  Greedy g;
  g.lin = &lin;
  g.beam = std::max(1, in.num_pruned);
  g.deadline = Clock::now() + std::chrono::seconds(60);
  g.consider(linearize(operands));
  g.search(operands);

  std::string out;
  emit(g.best, &out);
  out.push_back('\n');
  std::fwrite(out.data(), 1, out.size(), stdout);
  return 0;
}
