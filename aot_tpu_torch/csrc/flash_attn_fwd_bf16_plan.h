// The launch plan and shared-memory layout of the bf16 flash-attention
// forward (flash_attn_fwd_bf16.cu, which includes this file and ties its
// tiles to the constants below with static_asserts). This file alone owns
// the plan: the caller writes the plan's inputs (the shape), fwd_bf16_plan
// fills the rest and returns the workspace bytes, and the caller allocates
// that workspace and hands the same plan to the entry. Host code only, no
// CUDA header: the CPU tests build this file alone with the host C++
// compiler (tests/test_torch_port_bf16_fwd.py).

#pragma once

namespace fwdplan {

constexpr int kWgRows = 64;        // query rows of a warpgroup (wgmma's M)
constexpr int kWarpgroups = 2;     // consumer warpgroups a block
constexpr int kBlockRows = kWgRows * kWarpgroups;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kKeyTile = 64;       // keys a tile: S is one m64n64 product
constexpr int kMaxD = 256;         // q/k channels
constexpr int kMaxSmem = 232448;   // shared memory a block may use
constexpr int kMaxStages = 4;
constexpr int kBarBytes = 64;      // the ring's mbarriers and the q tile's
constexpr int kAlign = 1024;       // tiles start on a 1 KB swizzle atom

// q/k channels staged (zero beyond d): 32, 128 or 256
constexpr int d_pad(long long d) {
  return d <= 32 ? 32 : d <= 128 ? 128 : 256;
}
// value columns a block (one wgmma accumulator of 64 x VT a warpgroup):
// 32, 128 or 256; dv = 1024 in four value tiles; 128 at d > 128, whose
// 256-column tiles would leave room for two ring stages only
constexpr int value_tile(long long dv, int dp) {
  return dv <= 32 ? 32 : dv <= 128 || dp > 128 ? 128 : 256;
}
// The channels (or value columns) of a tile's copy box: 64 (128-byte
// swizzle) or 32 (64-byte swizzle) where every box lies inside one head's
// channels and value columns, else 8 (no swizzle)
constexpr int box_cols(long long d, long long dv, int dp, int vt) {
  return d % 64 == 0 && dv % 64 == 0 && dp >= 64 && vt >= 64 ? 64
         : d % 32 == 0 && dv % 32 == 0                        ? 32
                                                              : 8;
}
// blocks a multiprocessor holds: the 64 x 256 fp32 accumulator takes half
// a warpgroup's registers, so one block; two below
constexpr int blocks_per_sm(int vt) { return vt <= 128 ? 2 : 1; }
// bytes of a q or k tile of `rows` rows, of a v tile
constexpr long long qk_tile_bytes(long long rows, int dp) {
  return rows * dp * 2;
}
constexpr long long v_tile_bytes(int vt) {
  return (long long)kKeyTile * vt * 2;
}
constexpr long long stage_bytes(int dp, int vt) {
  return qk_tile_bytes(kKeyTile, dp) + v_tile_bytes(vt);
}
// the ring: as many stages (three or four) as fit beside the q tile; the
// kernel loads a tile kS - 1 tiles ahead
constexpr int stages(int dp, int vt) {
  return kAlign + qk_tile_bytes(kBlockRows, dp) + 4 * stage_bytes(dp, vt) +
                     kBarBytes <=
                 kMaxSmem
             ? 4
             : 3;
}
constexpr long long smem_bytes(int dp, int vt) {
  return kAlign + qk_tile_bytes(kBlockRows, dp) +
         stages(dp, vt) * stage_bytes(dp, vt) + kBarBytes;
}

// The plan: the inputs (ops/kernels/flash_attn.py BF16_PLAN_FIELDS, in
// this order), then what fwd_bf16_plan fills (BF16_PLAN_OUTPUTS there)
enum PlanField : int {
  kB, kH, kLq, kLk, kD, kDv,
  kDPad,          // d_pad
  kValueTile,     // value_tile
  kValueTiles,    // value tiles of dv
  kQTiles,        // 128-row query tiles
  kSplits,        // key splits (their partials merged in order)
  kTilesPerSplit, // key tiles a split
  kStages,        // ring stages
  kSmem,          // shared-memory bytes
  kBlocks,        // the grid: B*h x query tiles x value tiles x splits
  kPartOut,       // workspace byte offset of the splits' out partials, or -1
  kPartLse,       // ... of their lse partials, or -1
  kWorkspace,     // workspace bytes
  kBoxCols,       // box_cols
  kPlanLen
};

inline long long cdiv(long long x, long long m) { return (x + m - 1) / m; }
inline long long lmin(long long a, long long b) { return a < b ? a : b; }
inline long long lmax(long long a, long long b) { return a > b ? a : b; }

// Fills the plan from kDPad on for a card of `sms` multiprocessors: the
// key loop is split where the grid is under the blocks the card holds at
// once (blocks_per_sm a multiprocessor), toward them without passing them
// and at most one key tile a split; the splits write fp32 partials of out
// and lse to the workspace. Returns the workspace bytes, or -1 for a shape
// the kernel does not take (d, dv multiples of 8: 16-byte copies).
inline long long fill(long long* p, int sms) {
  const long long b = p[kB], h = p[kH], lq = p[kLq], lk = p[kLk], d = p[kD],
                  dv = p[kDv];
  if (b < 1 || h < 1 || lq < 1 || lk < 0 || d < 8 || d > kMaxD ||
      d % 8 != 0 || dv < 8 || dv % 8 != 0 || b * h > 2147483647LL ||
      sms < 1)
    return -1;
  const int dp = d_pad(d), vt = value_tile(dv, dp);
  p[kDPad] = dp;
  p[kValueTile] = vt;
  p[kValueTiles] = cdiv(dv, vt);
  p[kQTiles] = cdiv(lq, kBlockRows);
  const long long key_tiles = lmax(1, cdiv(lk, kKeyTile));
  const long long base = b * h * p[kQTiles] * p[kValueTiles];
  const long long slots = (long long)blocks_per_sm(vt) * sms;
  const long long splits =
      base >= slots ? 1 : lmax(1, lmin(key_tiles, slots / base));
  p[kTilesPerSplit] = cdiv(key_tiles, splits);
  p[kSplits] = cdiv(key_tiles, p[kTilesPerSplit]);   // none empty by count
  p[kStages] = stages(dp, vt);
  p[kSmem] = smem_bytes(dp, vt);
  p[kBlocks] = base * p[kSplits];
  long long at = 0;
  p[kPartOut] = p[kPartLse] = -1;
  if (p[kSplits] > 1) {
    p[kPartOut] = 0;
    at = p[kSplits] * b * lq * h * dv * 4;
    p[kPartLse] = at;
    at += p[kSplits] * b * h * lq * 4;
  }
  p[kWorkspace] = at;
  p[kBoxCols] = box_cols(d, dv, dp, vt);
  return p[kSmem] <= kMaxSmem ? at : -1;
}

}  // namespace fwdplan

// Plain C entries, bound with ctypes. fwd_bf16_plan: `plan` holds
// fwd_bf16_plan_len() integers, the inputs (kB to kDv) written; fills the
// rest and returns the workspace bytes, or -1.
extern "C" long long fwd_bf16_plan(long long* plan, int sms) {
  return fwdplan::fill(plan, sms);
}

extern "C" int fwd_bf16_plan_len() { return fwdplan::kPlanLen; }
