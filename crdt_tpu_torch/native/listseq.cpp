// listseq — native sequence-CRDT engine: dense identifier allocation +
// ordered-sequence maintenance for the List/GList types.
//
// This is the host-side hot loop of BASELINE config 5 (automerge-perf
// style edit traces, SURVEY.md §4.5): identifier allocation is inherently
// sequential per edit trace (each op's identifier depends on the current
// neighbor identifiers), so it cannot ride the TPU — the reference runs
// it as native Rust; here it is native C++ behind a ctypes boundary
// (crdt_tpu/native/__init__.py), with the batched multi-replica op
// application done on device (crdt_tpu/models/list.py).
//
// Semantics mirror crdt_tpu/pure/identifier.py `between` exactly
// (LSEQ/Logoot-style (index, marker) tree paths, BASE = 2^31, markers =
// OrdDot(actor, counter) compared lexicographically) — the parity suite
// (tests/test_native_list.py) asserts bit-identical identifiers against
// the pure oracle. Reference: src/identifier.rs, src/list.rs.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr int64_t BASE = int64_t(1) << 31;

struct Comp {
  int64_t idx;
  int32_t actor;   // marker: OrdDot.actor (dense interned id)
  uint64_t ctr;    // marker: OrdDot.counter
};

inline int cmp_comp(const Comp& a, const Comp& b) {
  if (a.idx != b.idx) return a.idx < b.idx ? -1 : 1;
  if (a.actor != b.actor) return a.actor < b.actor ? -1 : 1;
  if (a.ctr != b.ctr) return a.ctr < b.ctr ? -1 : 1;
  return 0;
}

using Path = std::vector<Comp>;

// Lexicographic path comparison; a strict prefix sorts before its
// extensions (Python tuple semantics).
inline int cmp_path(const Path& a, const Path& b) {
  size_t n = a.size() < b.size() ? a.size() : b.size();
  for (size_t i = 0; i < n; ++i) {
    int c = cmp_comp(a[i], b[i]);
    if (c) return c;
  }
  if (a.size() != b.size()) return a.size() < b.size() ? -1 : 1;
  return 0;
}

// Mirror of pure/identifier.py `between` — see that file for the
// invariant notes. lo/hi may be null (-inf/+inf bounds).
Path between(const Path* lo, const Path* hi, int32_t actor, uint64_t ctr) {
  Path prefix;
  bool lo_active = lo && !lo->empty();
  bool hi_active = hi && !hi->empty();
  size_t d = 0;
  for (;;) {
    const Comp* l =
        (lo_active && d < lo->size()) ? &(*lo)[d] : nullptr;
    const Comp* h =
        (hi_active && d < hi->size()) ? &(*hi)[d] : nullptr;
    int64_t h_idx = h ? h->idx : BASE;

    if (l) {
      if (h_idx - l->idx > 1) {
        prefix.push_back({(l->idx + h_idx) / 2, actor, ctr});
        return prefix;
      }
      prefix.push_back(*l);
      if (!h || cmp_comp(*l, *h) < 0) hi_active = false;
    } else {
      if (h_idx >= 2) {
        prefix.push_back({h_idx / 2, actor, ctr});
        return prefix;
      }
      if (h_idx == 1) {
        prefix.push_back({0, actor, ctr});
        hi_active = false;
      } else {
        prefix.push_back(*h);
      }
    }
    ++d;
  }
}

struct Engine {
  std::vector<Path> ids;        // identifier arena; handle = index
  std::vector<int32_t> vals;    // value id per handle
  std::vector<uint8_t> alive;   // liveness per handle
  std::vector<int64_t> seq;     // handles of live identifiers, in order
  std::unordered_map<int32_t, uint64_t> clock;  // actor -> max counter
};

}  // namespace

extern "C" {

void* ls_new() { return new Engine(); }

void ls_free(void* e) { delete static_cast<Engine*>(e); }

// Apply a local edit trace. kinds[i]: 0 = insert, 1 = delete. For
// inserts, idx[i] is the insert position in [0, len] and vals[i] the
// value id; for deletes, idx[i] is the victim position in [0, len).
// actors[i] mints the op's dot. out_handle[i] receives the op's
// identifier handle (the stable device slot). Returns the number of ops
// applied, or -(i+1) if op i had an out-of-range index.
int64_t ls_apply_trace(void* ep, const uint8_t* kinds, const int64_t* idx,
                       const int32_t* vals, const int32_t* actors,
                       int64_t n, int64_t* out_handle) {
  Engine& e = *static_cast<Engine*>(ep);
  for (int64_t i = 0; i < n; ++i) {
    int64_t p = idx[i];
    uint64_t ctr = ++e.clock[actors[i]];
    if (kinds[i] == 0) {
      if (p < 0 || p > int64_t(e.seq.size())) return -(i + 1);
      const Path* lo = p > 0 ? &e.ids[e.seq[p - 1]] : nullptr;
      const Path* hi =
          p < int64_t(e.seq.size()) ? &e.ids[e.seq[p]] : nullptr;
      Path ident = between(lo, hi, actors[i], ctr);
      int64_t handle = int64_t(e.ids.size());
      e.ids.push_back(std::move(ident));
      e.vals.push_back(vals[i]);
      e.alive.push_back(1);
      e.seq.insert(e.seq.begin() + p, handle);
      out_handle[i] = handle;
    } else {
      if (p < 0 || p >= int64_t(e.seq.size())) return -(i + 1);
      int64_t handle = e.seq[p];
      e.alive[handle] = 0;
      e.seq.erase(e.seq.begin() + p);
      out_handle[i] = handle;
    }
  }
  return n;
}

// Apply a remote op stream by identifier (CmRDT apply — reference:
// src/list.rs CmRDT::apply). kinds[i]: 0 = insert (identifier given by
// handle into a FOREIGN engine's arena is meaningless here, so remote
// ops are described by their full identifier paths): paths are passed
// flattened — comp_counts[i] components for op i, drawn sequentially
// from (cidx, cactor, cctr). Inserts carry vals[i]; duplicate inserts
// and deletes of absent identifiers are no-ops (idempotent delivery).
// out_handle[i] = local handle of the identifier. Returns n or -(i+1).
int64_t ls_apply_remote(void* ep, const uint8_t* kinds,
                        const int64_t* comp_counts, const int64_t* cidx,
                        const int32_t* cactor, const uint64_t* cctr,
                        const int32_t* vals, int64_t n,
                        int64_t* out_handle) {
  Engine& e = *static_cast<Engine*>(ep);
  int64_t off = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (comp_counts[i] <= 0) return -(i + 1);  // malformed wire input
    Path ident;
    ident.reserve(comp_counts[i]);
    for (int64_t c = 0; c < comp_counts[i]; ++c)
      ident.push_back({cidx[off + c], cactor[off + c], cctr[off + c]});
    off += comp_counts[i];
    // Binary search for the identifier's rank in the live sequence.
    int64_t lo = 0, hi = int64_t(e.seq.size());
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (cmp_path(e.ids[e.seq[mid]], ident) < 0)
        lo = mid + 1;
      else
        hi = mid;
    }
    bool present = lo < int64_t(e.seq.size()) &&
                   cmp_path(e.ids[e.seq[lo]], ident) == 0;
    // Track causality: the op's dot is the final component's marker.
    const Comp& last = ident.back();
    uint64_t& top = e.clock[last.actor];
    if (last.ctr > top) top = last.ctr;
    if (kinds[i] == 0) {
      if (!present) {
        int64_t handle = int64_t(e.ids.size());
        e.ids.push_back(std::move(ident));
        e.vals.push_back(vals[i]);
        e.alive.push_back(1);
        e.seq.insert(e.seq.begin() + lo, handle);
        out_handle[i] = handle;
      } else {
        out_handle[i] = e.seq[lo];
      }
    } else {
      if (present) {
        int64_t handle = e.seq[lo];
        e.alive[handle] = 0;
        e.seq.erase(e.seq.begin() + lo);
        out_handle[i] = handle;
      } else {
        out_handle[i] = -1;
      }
    }
  }
  return n;
}

int64_t ls_len(void* ep) {
  return int64_t(static_cast<Engine*>(ep)->seq.size());
}

int64_t ls_total_ids(void* ep) {
  return int64_t(static_cast<Engine*>(ep)->ids.size());
}

// Live sequence: handles (device slots) and value ids, in order.
void ls_read(void* ep, int64_t* out_handles, int32_t* out_vals) {
  Engine& e = *static_cast<Engine*>(ep);
  for (size_t i = 0; i < e.seq.size(); ++i) {
    out_handles[i] = e.seq[i];
    if (out_vals) out_vals[i] = e.vals[e.seq[i]];
  }
}

// Rank of every allocated identifier in the TOTAL identifier order
// (live or dead) — the device order-maintenance permutation: a read is
// a gather of alive values through this order.
void ls_total_order(void* ep, int64_t* out_rank) {
  Engine& e = *static_cast<Engine*>(ep);
  std::vector<int64_t> order(e.ids.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = int64_t(i);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return cmp_path(e.ids[a], e.ids[b]) < 0;
  });
  for (size_t r = 0; r < order.size(); ++r) out_rank[order[r]] = int64_t(r);
}

// Identifier introspection (for the parity suite): path length, then
// the components of handle's path.
int64_t ls_id_len(void* ep, int64_t handle) {
  Engine& e = *static_cast<Engine*>(ep);
  if (handle < 0 || handle >= int64_t(e.ids.size())) return -1;
  return int64_t(e.ids[handle].size());
}

void ls_id_path(void* ep, int64_t handle, int64_t* out_idx,
                int32_t* out_actor, uint64_t* out_ctr) {
  Engine& e = *static_cast<Engine*>(ep);
  const Path& p = e.ids[handle];
  for (size_t i = 0; i < p.size(); ++i) {
    out_idx[i] = p[i].idx;
    out_actor[i] = p[i].actor;
    out_ctr[i] = p[i].ctr;
  }
}

int64_t ls_clock_get(void* ep, int32_t actor) {
  Engine& e = *static_cast<Engine*>(ep);
  auto it = e.clock.find(actor);
  return it == e.clock.end() ? 0 : int64_t(it->second);
}

// Actor-clock persistence (checkpoint/resume): deletes consume mint
// counters that no surviving identifier path records, so restoring an
// engine from identifier paths alone would re-mint spent dots. The
// checkpoint dumps the clock map and re-seeds it after re-ingestion.
int64_t ls_clock_count(void* ep) {
  Engine& e = *static_cast<Engine*>(ep);
  return int64_t(e.clock.size());
}

void ls_clock_dump(void* ep, int32_t* out_actors, uint64_t* out_ctrs) {
  Engine& e = *static_cast<Engine*>(ep);
  size_t i = 0;
  for (const auto& kv : e.clock) {
    out_actors[i] = kv.first;
    out_ctrs[i] = kv.second;
    ++i;
  }
}

void ls_clock_seed(void* ep, int32_t actor, uint64_t ctr) {
  Engine& e = *static_cast<Engine*>(ep);
  uint64_t& top = e.clock[actor];
  if (ctr > top) top = ctr;
}

}  // extern "C"
