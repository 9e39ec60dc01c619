// The launch plan and shared-memory layout of the bf16 local-window kernel
// (local_window_attn_bf16.cu, which includes this file and ties its tiles
// to the constants below with static_asserts). This file alone owns the
// plan: the caller writes the plan's inputs (the shape), lwa_bf16_plan fills
// the rest, and the caller hands the same plan to the entry. The kernel
// reads its shared-memory layout from the plan. Host code only, no CUDA
// header: the CPU tests build this file alone with the host C++ compiler
// (tests/test_torch_port_bf16_fwd.py).

#pragma once

namespace lwaplan {

constexpr int kTileX = 16;       // queries a tile row: the mma tile's 16 rows
constexpr int kHalo = 32;        // halo keys a row (16 + 2 * max_dis <= 30)
constexpr int kMaxRadius = 7;   // max_dis at most
constexpr int kMaxD = 512;       // q/k channels
constexpr int kTileChannels = 512;  // q/k channels x rows of a tile at most
constexpr int kKStep = 16;       // channels (keys) a k-step of m16n8k16
constexpr int kMaxSmem = 232448; // shared memory a block may use
constexpr int kMaxThreads = 256;

// The value columns a block holds: 32 at the AOT head (dv = 32), 128 up to
// dv = 128, else 256 (DeAOT's dv = 1024 in four value tiles); 128 for a
// narrow head above 128 q/k channels, whose k ring takes two halo rows a
// stage (chunk_rows)
constexpr int value_tile(long long dv, long long dpad) {
  return dv <= 32 && dpad <= 128 ? 32 : dv <= 128 ? 128 : 256;
}
// warps sharing a query row: 2 in a 4-row tile, else 4
constexpr int warps_per_row(long long rows) { return rows == 4 ? 2 : 4; }
// halo rows a ring stage holds: four of the AOT head's 32-column rows, else
// two
constexpr int chunk_rows(int vt) { return vt == 32 ? 4 : 2; }
// bf16 elements a copy moves: 8 (16 bytes) where every q, k and v row
// offset is a multiple of 8, else 4
constexpr int copy_elems(long long d, long long dv) {
  return d % 8 == 0 && dv % 8 == 0 ? 8 : 4;
}

// The plan: the inputs (ops/kernels/local_window_attn.py BF16_PLAN_FIELDS,
// in this order), then what lwa_bf16_plan fills (BF16_PLAN_OUTPUTS there)
enum PlanField : int {
  kB, kH, kHeight, kWidth, kD, kDv, kMaxDis, kRelV,
  kRows,        // query rows a tile: 4, 2 or 1
  kValueTile,   // value columns a block (value_tile)
  kWarps,       // warps a block: rows x warps_per_row
  kTilesX,      // 16-pixel tiles across a row
  kTiles,       // tiles of the image
  kValueTiles,  // value tiles of dv (the grid's z)
  kBlocks,      // the grid: tiles x B*h x value tiles
  kDPad,        // q/k channels staged: d rounded up to a k-step
  kLdS,         // fp32 score rows: >= win2, = 9 mod 32
  kLdQ,         // bf16 q and k rows: dpad + 8
  kLdV,         // bf16 value rows: value tile + 8
  kLdRv,        // fp32 rel_v rows: win2 rounded up to 8, + 4
  kQOff,        // shared-memory byte offsets: the q tile
  kRegionOff,   // ... the k and v rings, or a rel_v chunk
  kSmem,        // shared-memory bytes
  kCopy,        // bf16 elements a copy (copy_elems)
  kPlanLen
};

inline long long up(long long x, long long m) { return (x + m - 1) / m * m; }
inline long long cdiv(long long x, long long m) { return (x + m - 1) / m; }

// Shared-memory bytes of a block: the fp32 score block (rows x 16 queries
// of ld_s), the q tile (rows x 16 of ld_q bf16) and one region that holds
// in turn the k ring, the v ring (two stages of chunk_rows halo rows each)
// and an fp32 rel_v chunk of 32 value columns. Fills the offsets.
inline long long layout(long long* p) {
  const long long rows = p[kRows], vt = p[kValueTile];
  const long long chunk = chunk_rows((int)vt);
  const long long sc = 4 * rows * kTileX * p[kLdS];
  const long long q = 2 * rows * kTileX * p[kLdQ];
  const long long ring_k = 2 * 2 * chunk * kHalo * p[kLdQ];
  const long long ring_v = 2 * 2 * chunk * kHalo * p[kLdV];
  const long long rv = p[kRelV] ? 4 * 32 * p[kLdRv] : 0;
  long long u = ring_k > ring_v ? ring_k : ring_v;
  u = u > rv ? u : rv;
  p[kQOff] = up(sc, 128);
  p[kRegionOff] = up(p[kQOff] + q, 128);
  p[kSmem] = p[kRegionOff] + u;
  return p[kSmem];
}

// Fills the plan from kRows on for a card of `sms` multiprocessors. The
// tile is the tallest (4 rows where the value tile is 32 columns, else 2,
// then 1) whose grid still gives every multiprocessor a block (a taller
// tile stages fewer halo rows a query row), or 1 row where none does; a
// tile holds at most kTileChannels q/k channels x rows, and its shared
// memory fits a block. Returns the shared-memory bytes, or -1 for a shape
// the kernel does not take.
inline long long fill(long long* p, int sms) {
  const long long b = p[kB], h = p[kH], hgt = p[kHeight], wid = p[kWidth],
                  d = p[kD], dv = p[kDv], m = p[kMaxDis];
  if (b < 1 || h < 1 || hgt < 1 || wid < 1 || d < 4 || d > kMaxD ||
      d % 4 != 0 || dv < 4 || dv % 4 != 0 || m < 0 || m > kMaxRadius ||
      b * h > 65535 || sms < 1)
    return -1;
  const long long win2 = (2 * m + 1) * (2 * m + 1);
  p[kDPad] = up(d, kKStep);
  const int vt = value_tile(dv, p[kDPad]);
  p[kValueTile] = vt;
  p[kTilesX] = cdiv(wid, kTileX);
  p[kValueTiles] = cdiv(dv, vt);
  p[kLdS] = win2 + ((9 - win2) % 32 + 32) % 32;
  p[kLdQ] = p[kDPad] + 8;
  p[kLdV] = vt + 8;
  p[kLdRv] = up(win2, 8) + 4;
  const long long heights[3] = {vt == 32 ? 4 : 2, 2, 1};
  long long chosen = 0;
  for (long long rows : heights) {
    if (rows * p[kDPad] > kTileChannels && rows > 1) continue;
    p[kRows] = rows;
    if (layout(p) > kMaxSmem && rows > 1) continue;
    chosen = rows;
    if (p[kTilesX] * cdiv(hgt, rows) * b * h * p[kValueTiles] >= sms) break;
  }
  p[kRows] = chosen;
  p[kCopy] = copy_elems(d, dv);
  p[kWarps] = chosen * warps_per_row(chosen);
  p[kTiles] = p[kTilesX] * cdiv(hgt, chosen);
  p[kBlocks] = p[kTiles] * b * h * p[kValueTiles];
  const long long smem = layout(p);
  return smem <= kMaxSmem ? smem : -1;
}

}  // namespace lwaplan

// Plain C entries, bound with ctypes. lwa_bf16_plan: `plan` holds
// lwa_bf16_plan_len() integers, the inputs (kB to kRelV) written; fills the
// rest and returns the shared-memory bytes, or -1.
extern "C" long long lwa_bf16_plan(long long* plan, int sms) {
  return lwaplan::fill(plan, sms);
}

extern "C" int lwa_bf16_plan_len() { return lwaplan::kPlanLen; }
