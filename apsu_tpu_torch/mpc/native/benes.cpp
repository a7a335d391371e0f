// Arbitrary-size Benes (AS-Waksman) network: topology + switch programming.
//
// The port's own copy of apsu_tpu/mpc/native/benes.cpp, the same code: the
// role of the C++ reference's Benes router (its permute/apsu_benes.cpp:112
// onward). Built on first use by apsu_tpu_torch/ops/_build.py:build_host.
// Given a permutation of n elements, compute the
// straight/cross setting of every switch of a 2*ceil(log2 n)-1 level
// network, for ANY n >= 2 (small base cases), so a 6552-column PEQT
// routes no 8192-wide network (~25% fewer switches, OTs and corrections
// in the 16M-4096 endgame than a power-of-two router).
//
// Construction (Beauquier–Darrot arbitrary-size Waksman, Benes-complete
// output layer): size-k node = floor(k/2) input switches on local wire
// pairs (2i, 2i+1) + two recursive children + floor(k/2) output switches.
// Upper child rides the even local positions, lower child the odd ones;
// for odd k the last wire bypasses both switch layers and joins the LOWER
// child on both sides (the classical convention that makes the routing
// 2-coloring always consistent).  Base cases: k=2 one switch, k=3 the
// 3-switch bubble network (levels mid-1, mid, mid+1).
//
// Routing = 2-coloring of the union of two matchings on the k output
// wires (out-pair edges + in-pair edges).  Components are even cycles or
// a single path joining the two lone-wire constraints, whose edge types
// strictly alternate — so the forced colors at its two ends never
// conflict; a defensive check returns -1 anyway if they ever would.
//
// Emission order of switches is deterministic and permutation-independent
// (input layer, upper child, lower child, output layer), so the OSN's two
// parties — only one of whom knows the permutation — agree on the OT index
// of every switch by construction.

#include <cstdint>
#include <utility>
#include <vector>

typedef int64_t i64;

namespace {

struct Ctx {
  // topology sinks (may be null)
  i64 *level, *a, *b;
  // settings sink (null in topology-only mode => perm ignored)
  uint8_t *set;
  i64 count;
  bool ok;

  void emit(i64 lv, i64 wa, i64 wb, int s) {
    if (level) level[count] = lv;
    if (a) a[count] = wa;
    if (b) b[count] = wb;
    if (set) set[count] = (uint8_t)s;
    count++;
  }
};

void route(const std::vector<i64> &wires, const std::vector<i64> &perm,
           i64 lin, i64 lout, Ctx &c) {
  const i64 k = (i64)wires.size();
  if (k <= 1 || !c.ok) return;
  const i64 mid = (lin + lout) / 2;
  const bool rm = c.set != nullptr;

  if (k == 2) {
    c.emit(mid, wires[0], wires[1], rm ? (perm[0] != 0) : 0);
    return;
  }
  if (k == 3) {
    int bits = 0;
    if (rm) {
      for (bits = 0; bits < 8; bits++) {
        i64 v[3] = {0, 1, 2};
        if (bits & 1) std::swap(v[0], v[1]);
        if (bits & 2) std::swap(v[1], v[2]);
        if (bits & 4) std::swap(v[0], v[1]);
        if (v[0] == perm[0] && v[1] == perm[1] && v[2] == perm[2]) break;
      }
      if (bits == 8) {  // not a permutation of 3
        c.ok = false;
        return;
      }
    }
    c.emit(mid - 1, wires[0], wires[1], bits & 1);
    c.emit(mid, wires[1], wires[2], (bits >> 1) & 1);
    c.emit(mid + 1, wires[0], wires[1], (bits >> 2) & 1);
    return;
  }

  const i64 h = k / 2;
  const bool odd = (k & 1) != 0;

  std::vector<int8_t> color;
  std::vector<i64> inv;
  if (rm) {
    inv.assign(k, 0);
    for (i64 o = 0; o < k; o++) inv[perm[o]] = o;
    color.assign(k, -1);
    // force(o, cl): propagate must-differ constraints (out-pair o^1 unless
    // o is the lone output; in-pair inv[perm[o]^1] unless perm[o] is the
    // lone input)
    std::vector<std::pair<i64, int8_t>> stack;
    auto force = [&](i64 start, int8_t cl) {
      stack.push_back({start, cl});
      while (!stack.empty()) {
        auto [o, col] = stack.back();
        stack.pop_back();
        if (color[o] != -1) {
          if (color[o] != col) c.ok = false;
          continue;
        }
        color[o] = col;
        if (!(odd && o == k - 1)) stack.push_back({o ^ 1, (int8_t)(1 - col)});
        i64 s = perm[o];
        if (!(odd && s == k - 1))
          stack.push_back({inv[s ^ 1], (int8_t)(1 - col)});
      }
    };
    if (odd) {
      force(k - 1, 1);        // lone output rides the lower child
      force(inv[k - 1], 1);   // lone input's path rides the lower child
    }
    for (i64 o = 0; o < k; o++)
      if (color[o] == -1) force(o, 0);
    if (!c.ok) return;
  }

  // children: upper = even positions, lower = odd positions (+ lone wire)
  std::vector<i64> uw(h), lw(h + (odd ? 1 : 0));
  for (i64 i = 0; i < h; i++) {
    uw[i] = wires[2 * i];
    lw[i] = wires[2 * i + 1];
  }
  if (odd) lw[h] = wires[k - 1];

  std::vector<i64> up, lo;
  if (rm) {
    up.resize(h);
    lo.resize(h + (odd ? 1 : 0));
    for (i64 j = 0; j < h; j++) {
      i64 o_up = (color[2 * j] == 0) ? 2 * j : 2 * j + 1;
      i64 o_lo = o_up ^ 1;
      up[j] = perm[o_up] >> 1;  // lone input never colored upper
      i64 s = perm[o_lo];
      lo[j] = (odd && s == k - 1) ? h : (s >> 1);
    }
    if (odd) {
      i64 s = perm[k - 1];
      lo[h] = (s == k - 1) ? h : (s >> 1);
    }
  }

  // input layer: switch i crosses iff wire 2i's path is colored lower
  for (i64 i = 0; i < h; i++)
    c.emit(lin, wires[2 * i], wires[2 * i + 1],
           rm ? (color[inv[2 * i]] == 1) : 0);
  route(uw, up, lin + 1, lout - 1, c);
  route(lw, lo, lin + 1, lout - 1, c);
  // output layer: switch j crosses iff output 2j comes from the lower child
  for (i64 j = 0; j < h; j++)
    c.emit(lout, wires[2 * j], wires[2 * j + 1],
           rm ? (color[2 * j] == 1) : 0);
}

i64 ceil_log2(i64 n) {
  i64 m = 0;
  while (((i64)1 << m) < n) m++;
  return m;
}

}  // namespace

extern "C" {

// Topology of the n-wire network (permutation-independent): fills
// level/a/b (caller-allocated, capacity >= (2*ceil(log2 n)-1)*ceil(n/2))
// in the canonical emission order; returns the switch count.
i64 benes_any_topology(i64 n, i64 *level, i64 *a, i64 *b) {
  Ctx c{level, a, b, nullptr, 0, true};
  std::vector<i64> wires(n);
  for (i64 i = 0; i < n; i++) wires[i] = i;
  route(wires, {}, 0, 2 * ceil_log2(n) - 2, c);
  return c.count;
}

// Switch settings realizing perm (perm[out] = in), aligned to the
// benes_any_topology emission order.  Returns the switch count, or -1 if
// perm is not a permutation / a routing conflict occurred (impossible for
// valid input; defensive).
i64 benes_any_route(const i64 *perm, i64 n, uint8_t *settings) {
  Ctx c{nullptr, nullptr, nullptr, settings, 0, true};
  std::vector<i64> wires(n), p(perm, perm + n);
  for (i64 i = 0; i < n; i++) wires[i] = i;
  route(wires, p, 0, 2 * ceil_log2(n) - 2, c);
  return c.ok ? c.count : -1;
}

}  // extern "C"
