// Minimal mock of the GROMACS API surface used by
// molar_tpu/native/gromacs_plugin.cpp, checked into tests so the plugin —
// which otherwise only compiles against a full GROMACS source+build tree —
// gets a syntax check AND a runnable mock build in CI (round-1 review item 9).
//
// The mock read_tpx_state/read_checkpoint_trxframe ignore the path and
// synthesize a deterministic 3-atom water; tests/test_gromacs_plugin.py
// asserts the ctypes round-trip reproduces exactly these constants.
#pragma once

#include <array>
#include <cstdint>
#include <cstring>
#include <filesystem>
#include <vector>

typedef float rvec[3];
typedef float matrix[3][3];

struct t_inputrec {};

struct t_atom {
  int type = 0;
  int atomnumber = 0;
  float q = 0.0f;
  float m = 0.0f;
};

struct t_atoms {
  int nr = 0;
};

struct InteractionList {
  std::vector<int> iatoms;  // [ftype-param, a1, a2, ...] groups
  int size() const { return (int)iatoms.size(); }
};

#define IF_CHEMBOND 1

struct t_interaction_function {
  int flags;
  int nratoms;
};

enum { F_BONDS = 0, F_SETTLE = 1, F_NRE = 2 };

inline const t_interaction_function interaction_function[F_NRE] = {
    {IF_CHEMBOND, 2},  // F_BONDS: 2 atoms per interaction
    {0, 3},            // F_SETTLE: not a chemical bond in this mock
};

struct gmx_moltype_t {
  t_atoms atoms;
  std::array<InteractionList, F_NRE> ilist;
};

struct gmx_molblock_t {
  int type = 0;
  int nmol = 0;
};

struct gmx_mtop_t {
  int natoms = 0;
  std::vector<gmx_molblock_t> molblock;
  std::vector<gmx_moltype_t> moltype;
};

struct t_state {
  std::vector<std::array<float, 3>> x;
  matrix box;
};

// -- mock topology constants (mirrored in tests/test_gromacs_plugin.py) ------

namespace gmx_stub {
inline const char* kNames[3] = {"OW", "HW1", "HW2"};
inline const char* kTypeNames[3] = {"opls116", "opls117", "opls117"};
inline const int kTypeIds[3] = {5, 6, 6};
inline const int kAtomNumbers[3] = {8, 1, -1};  // -1 exercises the <=0 clamp
inline const float kCharges[3] = {-0.8f, 0.4f, 0.4f};
inline const float kMasses[3] = {15.999f, 1.008f, 1.008f};
inline const float kCoords[9] = {0.1f, 0.2f, 0.3f, 0.2f, 0.2f,
                                 0.3f, 0.1f, 0.3f, 0.3f};
inline const float kBoxDiag[3] = {1.5f, 1.6f, 1.7f};
}  // namespace gmx_stub

// -- AtomRange / AtomProxy (topology/mtop_util.h in real GROMACS) ------------

class AtomProxy {
 public:
  AtomProxy(const gmx_mtop_t* mtop, int i) : mtop_(mtop), i_(i) {
    atom_.type = gmx_stub::kTypeIds[i % 3];
    atom_.atomnumber = gmx_stub::kAtomNumbers[i % 3];
    atom_.q = gmx_stub::kCharges[i % 3];
    atom_.m = gmx_stub::kMasses[i % 3];
  }
  const t_atom& atom() const { return atom_; }
  const char* atomName() const { return gmx_stub::kNames[i_ % 3]; }
  const char* residueName() const { return "SOL"; }
  const char* atomType() const { return gmx_stub::kTypeNames[i_ % 3]; }
  int residueNumber() const { return i_ / 3 + 1; }

 private:
  const gmx_mtop_t* mtop_;
  int i_;
  t_atom atom_;
};

class AtomRange {
 public:
  explicit AtomRange(const gmx_mtop_t& mtop) : mtop_(&mtop) {}
  class iterator {
   public:
    iterator(const gmx_mtop_t* mtop, int i) : mtop_(mtop), i_(i) {}
    AtomProxy operator*() const { return AtomProxy(mtop_, i_); }
    iterator& operator++() {
      ++i_;
      return *this;
    }
    bool operator!=(const iterator& o) const { return i_ != o.i_; }

   private:
    const gmx_mtop_t* mtop_;
    int i_;
  };
  iterator begin() const { return iterator(mtop_, 0); }
  iterator end() const { return iterator(mtop_, mtop_->natoms); }

 private:
  const gmx_mtop_t* mtop_;
};

// -- mock readers ------------------------------------------------------------

inline void read_tpx_state(const char* /*path*/, t_inputrec* /*ir*/,
                           t_state* state, gmx_mtop_t* mtop) {
  mtop->natoms = 3;
  gmx_moltype_t mt;
  mt.atoms.nr = 3;
  // Two O-H bonds via F_BONDS: [param, a1, a2] groups.
  mt.ilist[F_BONDS].iatoms = {0, 0, 1, 0, 0, 2};
  // A SETTLE entry that must NOT become a bond (no IF_CHEMBOND flag).
  mt.ilist[F_SETTLE].iatoms = {0, 0, 1, 2};
  mtop->moltype.push_back(mt);
  gmx_molblock_t mb;
  mb.type = 0;
  mb.nmol = 1;
  mtop->molblock.push_back(mb);

  state->x.resize(3);
  for (int k = 0; k < 3; ++k)
    for (int d = 0; d < 3; ++d) state->x[k][d] = gmx_stub::kCoords[k * 3 + d];
  std::memset(state->box, 0, sizeof(matrix));
  for (int d = 0; d < 3; ++d) state->box[d][d] = gmx_stub::kBoxDiag[d];
}

// -- trajectory frame (trajectory/trajectoryframe.h + fileio/checkpoint.h) --

struct t_trxframe {
  int natoms;
  double time;
  int64_t step;
  bool bX, bV, bF;
  rvec *x, *v, *f;
  matrix box;
};

inline void read_checkpoint_trxframe(const std::filesystem::path& /*path*/,
                                     t_trxframe* fr) {
  static rvec sx[3];
  static rvec sv[3];
  for (int k = 0; k < 3; ++k)
    for (int d = 0; d < 3; ++d) {
      sx[k][d] = gmx_stub::kCoords[k * 3 + d] + 1.0f;
      sv[k][d] = 0.01f * (k * 3 + d);
    }
  fr->natoms = 3;
  fr->time = 123.5;
  fr->step = 42;
  fr->bX = true;
  fr->x = sx;
  fr->bV = true;
  fr->v = sv;
  fr->bF = false;
  fr->f = nullptr;
  std::memset(fr->box, 0, sizeof(matrix));
  for (int d = 0; d < 3; ++d) fr->box[d][d] = gmx_stub::kBoxDiag[d] + 0.5f;
}
