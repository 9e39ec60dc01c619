// The launch plan and workspace layout of the flash-attention backward
// (flash_attn_bwd.cu, which includes this file once and ties its kernels'
// tiles to the constants below with static_asserts). This file alone owns
// the plan: the caller writes the plan's inputs (the shape and strides),
// flash_attn_bwd_plan fills the rest and returns the workspace bytes, and
// the caller allocates that workspace and hands the same plan to the
// entries. Host code only, no CUDA header: the CPU tests build this file
// alone with the host C++ compiler (tests/test_torch_port_flash_bwd_plan.py).

#pragma once

namespace bwdplan {

constexpr int kChunkBytes = 128;   // a packed row of a chunk of K (wgmma.cuh)
constexpr int kTokenPad = 128;     // rows (or columns) of tokens padded to it
constexpr int kOnePassMax = 32;    // d and dv at most this: the one pass
constexpr int kOnePassRows = 64;   // rows of a one-pass block
constexpr int kScoreRows = 128;    // query rows of a scores block
constexpr int kGemmTile = 128;     // rows and columns of a GEMM output tile
constexpr int kMaxSplits = 32;     // dQ's key splits, at most

// columns of K in one chunk: 32 fp32, 64 bf16 (also the one-pass kernels'
// column tile)
constexpr int chunk_cols(bool bf16) { return kChunkBytes / (bf16 ? 2 : 4); }
// keys a tile of the scores kernel: 128 at bf16; 64 at fp32, whose S keeps
// its small terms apart in registers
constexpr int score_key_tile(bool bf16) { return bf16 ? 128 : 64; }
constexpr bool is_one_pass(long long d, long long dv) {
  return d <= kOnePassMax && dv <= kOnePassMax;
}

// The plan: the inputs (ops/kernels/flash_attn_bwd.py PLAN_FIELDS, in this
// order), then what flash_attn_bwd_plan fills (PLAN_OUTPUTS there)
enum PlanField : int {
  kB, kH, kLq, kLk, kD, kDv, kValidAll,
  kQsb, kQsl, kKsb, kKsl, kVsb, kVsl,
  kOutSb, kOutSl,   // out's batch and row strides (elements)
  kForm,        // 0: one pass (d, dv <= 32), 1: two passes
  kSplits,      // dQ's key splits
  kSlab,        // two passes: query rows a slab (a multiple of 128)
  kGroups,      // two passes: key-tile groups of the scores kernel
  kDqPart,      // workspace byte offset of dQ's fp32 partials, or -1
  kAcc,         // workspace byte offset of the bf16 slabs' fp32 sums, or -1
  kDelta,       // workspace byte offset of D (B*h, Lq), fp32
  kWorkspace,   // workspace bytes
  kArrays       // then 4 fields for each packed array: hi and lo byte
                // offsets in the workspace (lo -1 for bf16), rows, columns
};
enum Array : int { aQ, aK, aV, aDO, aQT, aKT, aDOT, aPT, aDST, aDS,
                   kNumArrays };
constexpr int kPlanLen = kArrays + 4 * kNumArrays;

inline long long up(long long x, long long m) { return (x + m - 1) / m * m; }
inline long long cdiv(long long x, long long m) { return (x + m - 1) / m; }
inline long long lmin(long long a, long long b) { return a < b ? a : b; }
inline long long lmax(long long a, long long b) { return a > b ? a : b; }

// Key splits that bring a grid of `blocks` toward `slots` (the blocks the
// card holds at once) without passing it: 1 from `slots` on, at most
// `most`
inline long long split_count(long long blocks, long long slots,
                             long long most) {
  return blocks >= slots ? 1 : lmax(1, lmin(most, slots / blocks));
}

// Fills the plan's fields from kForm on for a card of `sms`
// multiprocessors: the form, dQ's splits, the slab (as many query rows,
// a multiple of 128, as keep each kept array of B*h*slab*Lk_p elements
// within `slab_floats`, at least 128, no more than Lq needs) and the
// scores kernel's groups; then the workspace, each region on 128 bytes:
// the packed arrays (rows of tokens padded to 128, columns to whole
// chunks; two copies at fp32), dQ's partials, the bf16 slabs' fp32 sums
// and D. Returns the workspace bytes, or -1 for a shape it does not take.
inline long long fill(long long* p, bool bf16, int sms,
                      long long slab_floats) {
  const long long b = p[kB], h = p[kH], lq = p[kLq], lk = p[kLk], d = p[kD],
                  dv = p[kDv];
  if (b < 1 || h < 1 || lq < 1 || lk < 1 || d < 1 || dv < 1 || sms < 1 ||
      slab_floats < 1)
    return -1;
  const long long elem = bf16 ? 2 : 4, kc = chunk_cols(bf16);
  const bool one_pass = is_one_pass(d, dv);
  const long long lqp = up(lq, kTokenPad), lkp = up(lk, kTokenPad);
  long long rows[kNumArrays], cols[kNumArrays];
  auto shape = [&](int i, long long r, long long c) {
    rows[i] = r;
    cols[i] = c;
  };
  shape(aQ, lqp, up(d, kc));
  shape(aK, lkp, up(d, kc));
  shape(aV, lkp, up(dv, kc));
  shape(aDO, lqp, up(dv, kc));
  long long slab = 0, splits, groups = 0;
  if (one_pass) {
    // the transposed tiles: 32 channel rows
    shape(aQT, kOnePassMax, lqp);
    shape(aKT, kOnePassMax, lkp);
    shape(aDOT, kOnePassMax, lqp);
    shape(aPT, 0, 0);
    shape(aDST, 0, 0);
    shape(aDS, 0, 0);
    splits = split_count(b * h * cdiv(lq, kOnePassRows), 2LL * sms,
                         cdiv(lk, kc));
  } else {
    slab = lmax(kTokenPad, slab_floats / (b * h * lkp) / kTokenPad *
                               kTokenPad);
    slab = lmin(slab, lqp);
    // the second pass's right operands: whole output tiles of channels
    shape(aQT, up(d, kGemmTile), lqp);
    shape(aKT, up(d, kGemmTile), lkp);
    shape(aDOT, up(dv, kGemmTile), lqp);
    shape(aPT, lkp, slab);
    shape(aDST, lkp, slab);
    shape(aDS, slab, lkp);
    const long long slab_rows = lmin(slab, lq);
    // dQ's summation over the keys split to about the length of dV's over
    // the slab's queries, which share its launch
    splits = lmax(1, lmin(kMaxSplits, cdiv(lkp, kc) / cdiv(slab_rows, kc)));
    groups = split_count(b * h * cdiv(slab_rows, kScoreRows), 2LL * sms,
                         cdiv(lk, score_key_tile(bf16)));
  }
  long long at = 0;
  for (int i = 0; i < kNumArrays; ++i) {
    long long* f = p + kArrays + 4 * i;
    const long long size = up(b * h * rows[i] * cols[i] * elem, 128);
    f[0] = at;
    at += size;
    f[1] = -1;
    if (!bf16) {
      f[1] = at;
      at += size;
    }
    f[2] = rows[i];
    f[3] = cols[i];
  }
  p[kDqPart] = -1;
  if (splits > 1) {
    p[kDqPart] = at;
    at += up(splits * b * lq * h * d * 4, 128);
  }
  p[kAcc] = -1;
  if (!one_pass && bf16 && lq > slab) {
    p[kAcc] = at;
    at += up(b * lk * h * (dv + d) * 4, 128);
  }
  p[kDelta] = at;
  at += up(b * h * lq * 4, 128);
  p[kForm] = one_pass ? 0 : 1;
  p[kSplits] = splits;
  p[kSlab] = slab;
  p[kGroups] = groups;
  p[kWorkspace] = at;
  return at;
}

}  // namespace bwdplan

// Plain C entries, bound with ctypes. flash_attn_bwd_plan: `plan` holds
// flash_attn_bwd_plan_len() integers, the inputs (kB to kOutSl) written;
// fills the rest for fp32 (bf16 0) or bf16 (1) operands and returns the
// workspace bytes, or -1.
extern "C" long long flash_attn_bwd_plan(long long* plan, int bf16, int sms,
                                         long long slab_floats) {
  return bwdplan::fill(plan, bf16 != 0, sms, slab_floats);
}

extern "C" int flash_attn_bwd_plan_len() { return bwdplan::kPlanLen; }
