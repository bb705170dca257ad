// Native host-side table generation: level extraction and interface
// enumeration for large meshes.
//
// This is the TPU framework's "graph builder" runtime: it turns the
// refinement tree into the flat patch/interface index tables the device
// kernels consume.  The Python implementations in domain.py / iface.py
// are the reference semantics (and remain as fallback); this C++ path
// makes setup O(seconds) for multi-million-patch meshes where Python
// loops would take minutes.  Semantics must match domain.extract_level
// (reference ThundereggDomGen.h:127-222) and iface.build_iface_tables
// (reference SchurInfo.h:141-405) exactly — the test suite diffs the two.
//
// Exposed via a C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Tables {
  // patch tables
  std::vector<int64_t> ids, parent_id, nbr_slot, fine_nbr_slots;
  std::vector<double> starts, spacings;
  std::vector<int32_t> refine_level, orth_on_parent, coarse_orth;
  std::vector<int8_t> nbr_type;
  std::vector<uint8_t> neumann;
  int64_t P = 0;
  // iface tables
  int64_t num_ifaces = 0;
  std::vector<int32_t> iface_side_idx;
  std::vector<uint8_t> iface_side_mask;
  std::vector<int32_t> contrib_patch, contrib_side, contrib_iface, contrib_case;
};

constexpr int8_t NBR_NONE = 0, NBR_NORMAL = 1, NBR_COARSE = 2, NBR_FINE = 3;

inline int side_opposite(int s) { return s ^ 1; }
inline bool side_is_lower(int s) { return (s & 1) == 0; }

// geometry.orthants_on_side (reference Side.h:346-362)
static void orthants_on_side(int s, int D, int* out) {
  int bit = s / 2;
  int set_bit = side_is_lower(s) ? 0 : 1;
  unsigned lower_mask = ~((~0u) << bit);
  unsigned upper_mask = (~0u) << (bit + 1);
  int half = 1 << (D - 1);
  for (int i = 0; i < half; i++) {
    unsigned v = ((unsigned(i) << 1) & upper_mask) | (unsigned(i) & lower_mask) |
                 (unsigned(set_bit) << bit);
    out[i] = int(v);
  }
}

struct TreeView {
  int64_t N;
  int D;
  const int64_t* ids;
  const int32_t* level;
  const int64_t* parent;
  const double* starts;   // [N, D]
  const double* lengths;  // [N, D]
  const int64_t* nbr_id;  // [N, 2D], node ids
  const int64_t* child_id;  // [N, 2^D], node ids
  std::unordered_map<int64_t, int64_t> idx_of;  // id -> dense node index

  bool has_children(int64_t i) const { return child_id[i * (1 << D)] != -1; }
  int64_t nbr(int64_t i, int s) const { return nbr_id[i * 2 * D + s]; }
  int64_t child(int64_t i, int o) const { return child_id[i * (1 << D) + o]; }
};

static void extract_level_impl(const TreeView& t, int tree_level, int n,
                               bool neumann_bc, Tables& out) {
  const int D = t.D, S = 2 * D, half = 1 << (D - 1);
  // members: nodes at tree_level, plus coarser leaves (ThundereggDomGen.h)
  std::vector<int64_t> members;  // dense node indices, sorted by id
  {
    std::vector<int64_t> mids;
    for (int64_t i = 0; i < t.N; i++) {
      if (t.level[i] == tree_level ||
          (t.level[i] < tree_level && !t.has_children(i)))
        mids.push_back(t.ids[i]);
    }
    std::sort(mids.begin(), mids.end());
    for (int64_t id : mids) members.push_back(t.idx_of.at(id));
  }
  const int64_t P = members.size();
  std::unordered_map<int64_t, int64_t> slot_of;  // node id -> patch slot
  for (int64_t p = 0; p < P; p++) slot_of[t.ids[members[p]]] = p;

  out.P = P;
  out.ids.resize(P);
  out.starts.resize(P * D);
  out.spacings.resize(P * D);
  out.refine_level.resize(P);
  out.parent_id.resize(P);
  out.orth_on_parent.assign(P, -1);
  out.neumann.assign(P * S, 0);
  out.nbr_type.assign(P * S, NBR_NONE);
  out.nbr_slot.assign(P * S, -1);
  out.coarse_orth.assign(P * S, -1);
  out.fine_nbr_slots.assign(P * S * half, -1);

  std::vector<int> octs(half);
  for (int64_t p = 0; p < P; p++) {
    const int64_t i = members[p];
    out.ids[p] = t.ids[i];
    for (int a = 0; a < D; a++) {
      out.starts[p * D + a] = t.starts[i * D + a];
      out.spacings[p * D + a] = t.lengths[i * D + a] / n;
    }
    out.refine_level[p] = t.level[i];
    if (t.level[i] < tree_level) {
      out.parent_id[p] = t.ids[i];  // pass-through: own parent
    } else {
      out.parent_id[p] = t.parent[i];
      if (t.parent[i] != -1) {
        const int64_t par = t.idx_of.at(t.parent[i]);
        for (int o = 0; o < (1 << D); o++)
          if (t.child(par, o) == t.ids[i]) {
            out.orth_on_parent[p] = o;
            break;
          }
      }
    }
    for (int s = 0; s < S; s++) {
      const int64_t nid = t.nbr(i, s);
      const int64_t par = t.parent[i] == -1 ? -1 : t.idx_of.at(t.parent[i]);
      if (nid == -1 && par != -1 && t.nbr(par, s) != -1) {
        // coarser neighbor
        const int64_t nbr = t.idx_of.at(t.nbr(par, s));
        orthants_on_side(s, D, octs.data());
        int quad = -1;
        for (int q = 0; q < half; q++)
          if (t.child(par, octs[q]) == t.ids[i]) {
            quad = q;
            break;
          }
        out.nbr_type[p * S + s] = NBR_COARSE;
        out.nbr_slot[p * S + s] = slot_of.at(t.ids[nbr]);
        out.coarse_orth[p * S + s] = quad;
      } else if (t.level[i] < tree_level && nid != -1 &&
                 t.has_children(t.idx_of.at(nid))) {
        // finer neighbors
        const int64_t nbr = t.idx_of.at(nid);
        orthants_on_side(side_opposite(s), D, octs.data());
        out.nbr_type[p * S + s] = NBR_FINE;
        for (int q = 0; q < half; q++)
          out.fine_nbr_slots[(p * S + s) * half + q] =
              slot_of.at(t.child(nbr, octs[q]));
      } else if (nid != -1) {
        out.nbr_type[p * S + s] = NBR_NORMAL;
        out.nbr_slot[p * S + s] = slot_of.at(nid);
      } else if (neumann_bc) {
        out.neumann[p * S + s] = 1;
      }
    }
  }
}

// case ids must match iface.case_templates ordering:
//   0 normal, 1 c2c, 2 f2f, 3..3+half-1 f2c(q), 3+half.. c2f(q)
static void build_iface_impl(int D, Tables& tb) {
  const int S = 2 * D, half = 1 << (D - 1);
  const int64_t P = tb.P;
  std::unordered_map<int64_t, int32_t> iface_slot;
  auto slot = [&](int64_t iface_id) -> int32_t {
    auto it = iface_slot.find(iface_id);
    if (it != iface_slot.end()) return it->second;
    int32_t v = int32_t(iface_slot.size());
    iface_slot.emplace(iface_id, v);
    return v;
  };
  tb.iface_side_idx.assign(P * S, 0);
  tb.iface_side_mask.assign(P * S, 0);
  for (int64_t p = 0; p < P; p++) {
    const int64_t pid = tb.ids[p];
    for (int s = 0; s < S; s++) {
      const int8_t type = tb.nbr_type[p * S + s];
      if (type == NBR_NONE) continue;
      if (type == NBR_NORMAL) {
        const int64_t nbr_pid = tb.ids[tb.nbr_slot[p * S + s]];
        const int64_t own = side_is_lower(s)
                                ? pid * S + s
                                : nbr_pid * S + side_opposite(s);
        const int32_t i = slot(own);
        tb.iface_side_idx[p * S + s] = i;
        tb.iface_side_mask[p * S + s] = 1;
        tb.contrib_patch.push_back(int32_t(p));
        tb.contrib_side.push_back(s);
        tb.contrib_iface.push_back(i);
        tb.contrib_case.push_back(0);  // normal
      } else if (type == NBR_COARSE) {
        const int64_t nbr_pid = tb.ids[tb.nbr_slot[p * S + s]];
        const int32_t i_own = slot(pid * S + s);
        const int32_t i_coarse = slot(nbr_pid * S + side_opposite(s));
        tb.iface_side_idx[p * S + s] = i_own;
        tb.iface_side_mask[p * S + s] = 1;
        const int q = tb.coarse_orth[p * S + s];
        tb.contrib_patch.push_back(int32_t(p));
        tb.contrib_side.push_back(s);
        tb.contrib_iface.push_back(i_own);
        tb.contrib_case.push_back(2);  // f2f
        tb.contrib_patch.push_back(int32_t(p));
        tb.contrib_side.push_back(s);
        tb.contrib_iface.push_back(i_coarse);
        tb.contrib_case.push_back(3 + q);  // f2c(q)
      } else {  // NBR_FINE
        const int32_t i_own = slot(pid * S + s);
        tb.iface_side_idx[p * S + s] = i_own;
        tb.iface_side_mask[p * S + s] = 1;
        tb.contrib_patch.push_back(int32_t(p));
        tb.contrib_side.push_back(s);
        tb.contrib_iface.push_back(i_own);
        tb.contrib_case.push_back(1);  // c2c
        for (int q = 0; q < half; q++) {
          const int64_t fine_pid =
              tb.ids[tb.fine_nbr_slots[(p * S + s) * half + q]];
          const int32_t i_fine = slot(fine_pid * S + side_opposite(s));
          tb.contrib_patch.push_back(int32_t(p));
          tb.contrib_side.push_back(s);
          tb.contrib_iface.push_back(i_fine);
          tb.contrib_case.push_back(3 + half + q);  // c2f(q)
        }
      }
    }
  }
  tb.num_ifaces = int64_t(iface_slot.size());
}

}  // namespace

extern "C" {

// Build everything for one level; returns an opaque handle.
void* pps_build_level(int64_t num_nodes, int32_t D, int32_t n,
                      const int64_t* ids, const int32_t* level,
                      const int64_t* parent, const double* starts,
                      const double* lengths, const int64_t* nbr_id,
                      const int64_t* child_id, int32_t tree_level,
                      int32_t neumann) {
  TreeView t;
  t.N = num_nodes;
  t.D = D;
  t.ids = ids;
  t.level = level;
  t.parent = parent;
  t.starts = starts;
  t.lengths = lengths;
  t.nbr_id = nbr_id;
  t.child_id = child_id;
  t.idx_of.reserve(num_nodes * 2);
  for (int64_t i = 0; i < num_nodes; i++) t.idx_of[ids[i]] = i;
  auto* out = new Tables();
  extract_level_impl(t, tree_level, n, neumann != 0, *out);
  build_iface_impl(D, *out);
  return out;
}

int64_t pps_num_patches(void* h) { return static_cast<Tables*>(h)->P; }
int64_t pps_num_ifaces(void* h) { return static_cast<Tables*>(h)->num_ifaces; }
int64_t pps_num_contribs(void* h) {
  return int64_t(static_cast<Tables*>(h)->contrib_patch.size());
}

// Copy-out functions: caller allocates numpy buffers of the right size.
#define COPY_FN(NAME, FIELD, TYPE)                            \
  void NAME(void* h, TYPE* dst) {                             \
    auto& v = static_cast<Tables*>(h)->FIELD;                 \
    std::memcpy(dst, v.data(), v.size() * sizeof(TYPE));      \
  }
COPY_FN(pps_copy_ids, ids, int64_t)
COPY_FN(pps_copy_starts, starts, double)
COPY_FN(pps_copy_spacings, spacings, double)
COPY_FN(pps_copy_refine_level, refine_level, int32_t)
COPY_FN(pps_copy_parent_id, parent_id, int64_t)
COPY_FN(pps_copy_orth_on_parent, orth_on_parent, int32_t)
COPY_FN(pps_copy_neumann, neumann, uint8_t)
COPY_FN(pps_copy_nbr_type, nbr_type, int8_t)
COPY_FN(pps_copy_nbr_slot, nbr_slot, int64_t)
COPY_FN(pps_copy_coarse_orth, coarse_orth, int32_t)
COPY_FN(pps_copy_fine_nbr_slots, fine_nbr_slots, int64_t)
COPY_FN(pps_copy_iface_side_idx, iface_side_idx, int32_t)
COPY_FN(pps_copy_iface_side_mask, iface_side_mask, uint8_t)
COPY_FN(pps_copy_contrib_patch, contrib_patch, int32_t)
COPY_FN(pps_copy_contrib_side, contrib_side, int32_t)
COPY_FN(pps_copy_contrib_iface, contrib_iface, int32_t)
COPY_FN(pps_copy_contrib_case, contrib_case, int32_t)
#undef COPY_FN

void pps_free(void* h) { delete static_cast<Tables*>(h); }

}  // extern "C"
