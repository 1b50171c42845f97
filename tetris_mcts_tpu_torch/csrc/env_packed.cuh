// Device twins of tetris_mcts_tpu_torch/ops/env_packed.py: the Tetris step
// on one packed 44-word state (the engine.pack_state layout) run by one
// thread. Each function mirrors the torch helper of the same name; the
// torch forms are held bit-exact against the JAX engine in the tests, and
// chip_smoke.py holds the select kernel (which calls packed_step) against
// its plain torch version on the card.
//
// The state is passed by pointer and updated in place; the select kernel
// keeps it in shared memory. No helper keeps an array of its own that is
// indexed at run time (the lock merges and compacts the rows in place, the
// bag decode tracks used pieces in a bit mask), so nothing of the step
// lives in local memory.
//
// Layout: w[0:20] rows, 20 piece, 21 rot, 22 px, 23 py, 24:31 bag,
// 31 bag_pos, 32 k0, 33 k1, 34 ctr, 35 gravity, 36 score, 37 combo,
// 38 lines, 39:43 line_stats, 43 end. Int fields are two's-complement.
#pragma once
#include <stdint.h>

namespace tmt {

constexpr int kBoardH = 20;
constexpr int kBoardW = 10;
constexpr uint32_t kFullRow = 0x3FF;
constexpr int kSpawnX = 3;
constexpr int kSpawnY = 0;
constexpr int kWords = 44;

// PIECE_CELLS reshaped (28, 4, 2): combo = piece * 4 + rot.
__constant__ int8_t kCellY[28 * 4] = {
    1,1,1,1,0,1,2,3,2,2,2,2,0,1,2,3,1,1,2,2,1,1,2,2,1,1,2,2,1,1,2,2,
    1,1,1,2,1,2,2,3,1,2,2,2,0,1,1,2,1,1,2,2,1,2,2,3,1,1,2,2,0,1,1,2,
    1,1,2,2,1,2,2,3,1,1,2,2,0,1,1,2,1,1,1,2,1,1,2,3,1,2,2,2,0,1,2,2,
    1,1,1,2,1,2,3,3,1,2,2,2,0,0,1,2};
__constant__ int8_t kCellX[28 * 4] = {
    0,1,2,3,1,1,1,1,0,1,2,3,2,2,2,2,1,2,1,2,1,2,1,2,1,2,1,2,1,2,1,2,
    0,1,2,1,1,1,2,1,2,1,2,3,2,1,2,2,1,2,0,1,1,1,2,2,2,3,1,2,1,1,2,2,
    0,1,1,2,2,1,2,1,1,2,2,3,2,1,2,1,0,1,2,2,1,2,1,1,1,1,2,3,2,2,1,2,
    0,1,2,0,1,1,1,2,3,1,2,3,1,2,2,2};
__constant__ int kClearScore[5] = {0, 100, 300, 500, 800};
constexpr int kComboScore = 50;

// _cells: absolute cells of combo at (px, py).
__device__ __forceinline__ void cells(int combo, int px, int py, int ys[4],
                                      int xs[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ys[i] = py + kCellY[combo * 4 + i];
    xs[i] = px + kCellX[combo * 4 + i];
  }
}

// _collides: any cell off the board or over the stack.
__device__ __forceinline__ bool collides(const uint32_t* rows, const int ys[4],
                                         const int xs[4]) {
  bool hit = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (xs[i] < 0 || xs[i] >= kBoardW || ys[i] < 0 || ys[i] >= kBoardH)
      hit = true;
    else if (rows[ys[i]] & (1u << xs[i]))
      hit = true;
  }
  return hit;
}

// _max_drop: largest d >= 0 with the piece free at py + d.
__device__ __forceinline__ int max_drop(const uint32_t* rows, const int ys[4],
                                        const int xs[4]) {
  int limit = kBoardH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int y = ys[i];
    int xc = min(max(xs[i], 0), kBoardW - 1);
    int first = kBoardH;
    for (int r = max(y + 1, 0); r < kBoardH; ++r) {
      if ((rows[r] >> xc) & 1u) {
        first = r;
        break;
      }
    }
    int lim = first < kBoardH ? first - y - 1 : kBoardH - 1 - y;
    limit = min(limit, lim);
  }
  return max(limit, 0);
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// _threefry: threefry2x32 lane 0 of counter (c0, 0) under key (k0, k1).
__device__ __forceinline__ uint32_t threefry(uint32_t k0, uint32_t k1,
                                             uint32_t c0) {
  const int rot_a[4] = {13, 15, 26, 6};
  const int rot_b[4] = {17, 29, 16, 24};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = c0 + k0;
  uint32_t x1 = k1;
#pragma unroll
  for (int outer = 0; outer < 5; ++outer) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int r = (outer % 2 == 0) ? rot_a[j] : rot_b[j];
      x0 = x0 + x1;
      x1 = rotl(x1, r) ^ x0;
    }
    x0 = x0 + ks[(outer + 1) % 3];
    x1 = x1 + ks[(outer + 2) % 3] + (uint32_t)(outer + 1);
  }
  return x0;
}

// _mod_const: u32 word mod m (integer division is native here).
__device__ __forceinline__ int mod_const(uint32_t word, uint32_t m) {
  return (int)(word % m);
}

// _perm7_decode: lexicographic permutation #r of 0..6 (the factorial
// number system picks the d-th smallest element still unused), written to
// bag[0:7].
__device__ __forceinline__ void perm7_decode(int r, uint32_t* bag) {
  const int fact[7] = {720, 120, 24, 6, 2, 1, 1};
  unsigned used = 0u;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    int d = r / fact[i];
    r -= d * fact[i];
    int seen = 0, pick = 0;
#pragma unroll
    for (int e = 0; e < 7; ++e) {
      if ((used >> e) & 1u) continue;
      if (seen == d) pick = e;
      ++seen;
    }
    used |= 1u << pick;
    bag[i] = (uint32_t)pick;
  }
}

// _draw_piece: next piece per the randomizer; advances ctr when it draws.
__device__ __forceinline__ int draw_piece(uint32_t* w, int randomizer) {
  uint32_t ctr = w[34];
  if (randomizer == 1) {
    w[34] = ctr + 1u;
    return mod_const(threefry(w[32], w[33], ctr), 7u);
  }
  int pos = (int)w[31];
  if (pos >= 7) {
    perm7_decode(mod_const(threefry(w[32], w[33], ctr), 5040u), w + 24);
    pos = 0;
    w[34] = ctr + 1u;
  }
  w[31] = (uint32_t)(pos + 1);
  return (int)w[24 + pos];
}

// packed_obs: rows | piece rows << 10, written to out[0:20].
__device__ __forceinline__ void packed_obs(const uint32_t* w, uint32_t* out) {
  int ys[4], xs[4];
  cells((int)w[20] * 4 + (int)w[21], (int)w[22], (int)w[23], ys, xs);
  for (int r = 0; r < kBoardH; ++r) out[r] = w[r];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (xs[i] >= 0 && xs[i] < kBoardW && ys[i] >= 0 && ys[i] < kBoardH)
      out[ys[i]] |= (1u << xs[i]) << 10;
}

// packed_step: engine.step on one packed state, in place. act outside 0..6
// acts as a lateral no-op, as in the torch form.
__device__ __forceinline__ void packed_step(uint32_t* w, int act, int app, int scoring,
                            int randomizer) {
  if (w[43] != 0u) return;
  int piece = (int)w[20], rot = (int)w[21], px = (int)w[22], py = (int)w[23];
  int dx = act == 1 ? -1 : (act == 2 ? 1 : 0);
  int drot = act == 4 ? 1 : (act == 5 ? 3 : 0);
  int npx = px + dx, nrot = (rot + drot) & 3;
  int ys[4], xs[4];
  cells(piece * 4 + nrot, npx, py, ys, xs);
  if (!collides(w, ys, xs)) {
    px = npx;
    rot = nrot;
  }
  bool hard = act == 6, soft = act == 3;
  bool lateral = !hard && !soft;
  int g_next = (int)w[35] + 1;
  bool grav_fires = app > 0 && lateral && g_next >= app;
  int g_keep = app > 0 ? g_next : 0;
  cells(piece * 4 + rot, px, py, ys, xs);
  int md = max_drop(w, ys, xs);
  bool want_down = soft || grav_fires;
  int drop_n = hard ? md : (want_down ? min(md, 1) : 0);
  bool lock_now = hard || (want_down && md == 0);
  int score = (int)w[36];
  if (scoring == 0) score += hard ? 2 * md : (soft ? min(md, 1) : 0);
  int gravity = (hard || soft || grav_fires) ? 0 : g_keep;
  if (!lock_now) {
    w[21] = (uint32_t)rot;
    w[22] = (uint32_t)px;
    w[23] = (uint32_t)(py + drop_n);
    w[35] = (uint32_t)gravity;
    w[36] = (uint32_t)score;
    return;
  }
  // lock: merge, clear full rows (survivors keep their order at the
  // bottom), score, spawn the next piece. Merge and compaction run in place:
  // a survivor moves down to dst = r + (full rows below it) >= r, onto a row
  // the bottom-up pass has already read.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int y = ys[i] + drop_n;
    if (xs[i] >= 0 && xs[i] < kBoardW && y >= 0 && y < kBoardH)
      w[y] |= 1u << xs[i];
  }
  int n = 0, dst = kBoardH - 1;
  for (int r = kBoardH - 1; r >= 0; --r) {
    const uint32_t row = w[r];
    if (row == kFullRow)
      ++n;
    else
      w[dst--] = row;
  }
  for (; dst >= 0; --dst) w[dst] = 0u;
  int combo = (int)w[37];
  int gained = scoring == 0 ? (n > 0 ? kClearScore[n] + kComboScore * combo : 0)
                            : n;
  w[36] = (uint32_t)(score + gained);
  w[37] = (uint32_t)(n > 0 ? combo + 1 : 0);
  w[38] = (uint32_t)((int)w[38] + n);
  if (n > 0) w[39 + n - 1] = (uint32_t)((int)w[39 + n - 1] + 1);
  int next = draw_piece(w, randomizer);
  w[20] = (uint32_t)next;
  w[21] = 0u;
  w[22] = (uint32_t)kSpawnX;
  w[23] = (uint32_t)kSpawnY;
  w[35] = 0u;
  cells(next * 4, kSpawnX, kSpawnY, ys, xs);
  if (collides(w, ys, xs)) w[43] = 1u;
}

// ---------------------------------------------------------------------------
// packed_step_warp: packed_step on the state w (in shared memory) run by a
// whole warp, for a walk that has a warp to itself. Lane r < 20 holds row r
// in a register: the collision tests are __any_sync votes, the drop is a
// __reduce_min_sync over the rows, and the line clear is a __ballot_sync of
// the full rows with a popc prefix giving each survivor its new row. The
// scalar tail of a lock (score, lines, the next piece) runs in lane 0 as in
// packed_step. Integer work only, so it equals packed_step bit for bit.
// Every lane must call it with the same arguments.
// ---------------------------------------------------------------------------
constexpr unsigned kWarpAll = 0xffffffffu;

__device__ __forceinline__ bool collides_warp(uint32_t row, int lane,
                                              const int ys[4], const int xs[4]) {
  bool off = false, hit = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (xs[i] < 0 || xs[i] >= kBoardW || ys[i] < 0 || ys[i] >= kBoardH)
      off = true;
    else if (ys[i] == lane && ((row >> xs[i]) & 1u))
      hit = true;
  }
  return off || __any_sync(kWarpAll, hit);
}

// max_drop: the least over the cells of (first stack row below the cell) -
// y - 1, or 19 - y where the column is free below it; a row below a cell
// gives lane - y - 1, and 19 - y never undercuts a cell's own first row.
__device__ __forceinline__ int max_drop_warp(uint32_t row, int lane,
                                             const int ys[4], const int xs[4]) {
  int limit = kBoardH, below = kBoardH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = ys[i];
    const int xc = min(max(xs[i], 0), kBoardW - 1);
    limit = min(limit, kBoardH - 1 - y);
    if (lane < kBoardH && lane >= max(y + 1, 0) && ((row >> xc) & 1u))
      below = min(below, lane - y - 1);
  }
  return max(min(limit, __reduce_min_sync(kWarpAll, below)), 0);
}

__device__ __forceinline__ void packed_step_warp(uint32_t* w, int act, int app,
                                                 int scoring, int randomizer,
                                                 int lane) {
  if (w[43] != 0u) return;
  const int piece = (int)w[20];
  int rot = (int)w[21], px = (int)w[22];
  const int py = (int)w[23];
  const int g_next = (int)w[35] + 1;
  int score = (int)w[36];
  const int combo = (int)w[37];
  const uint32_t row = lane < kBoardH ? w[lane] : 0u;
  __syncwarp();  // every lane has read the state before any lane writes it
  int dx = act == 1 ? -1 : (act == 2 ? 1 : 0);
  int drot = act == 4 ? 1 : (act == 5 ? 3 : 0);
  int npx = px + dx, nrot = (rot + drot) & 3;
  int ys[4], xs[4];
  cells(piece * 4 + nrot, npx, py, ys, xs);
  if (!collides_warp(row, lane, ys, xs)) {
    px = npx;
    rot = nrot;
  }
  bool hard = act == 6, soft = act == 3;
  bool lateral = !hard && !soft;
  bool grav_fires = app > 0 && lateral && g_next >= app;
  int g_keep = app > 0 ? g_next : 0;
  cells(piece * 4 + rot, px, py, ys, xs);
  int md = max_drop_warp(row, lane, ys, xs);
  bool want_down = soft || grav_fires;
  int drop_n = hard ? md : (want_down ? min(md, 1) : 0);
  bool lock_now = hard || (want_down && md == 0);
  if (scoring == 0) score += hard ? 2 * md : (soft ? min(md, 1) : 0);
  int gravity = (hard || soft || grav_fires) ? 0 : g_keep;
  if (!lock_now) {
    if (lane == 0) {
      w[21] = (uint32_t)rot;
      w[22] = (uint32_t)px;
      w[23] = (uint32_t)(py + drop_n);
      w[35] = (uint32_t)gravity;
      w[36] = (uint32_t)score;
    }
    __syncwarp();
    return;
  }
  // lock: merge into the lanes' rows, then each survivor moves down by the
  // full rows below it; the n rows freed at the top are zeroed
  uint32_t merged = row;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int y = ys[i] + drop_n;
    if (xs[i] >= 0 && xs[i] < kBoardW && y == lane && y < kBoardH)
      merged |= 1u << xs[i];
  }
  const bool full = lane < kBoardH && merged == kFullRow;
  const unsigned fm = __ballot_sync(kWarpAll, full);
  const int n = __popc(fm);
  if (lane < kBoardH) {
    if (!full) w[lane + __popc(fm >> (lane + 1))] = merged;
    if (lane < n) w[lane] = 0u;
  }
  __syncwarp();
  if (lane == 0) {
    int gained = scoring == 0 ? (n > 0 ? kClearScore[n] + kComboScore * combo : 0)
                              : n;
    w[36] = (uint32_t)(score + gained);
    w[37] = (uint32_t)(n > 0 ? combo + 1 : 0);
    w[38] = (uint32_t)((int)w[38] + n);
    if (n > 0) w[39 + n - 1] = (uint32_t)((int)w[39 + n - 1] + 1);
    int next = draw_piece(w, randomizer);
    w[20] = (uint32_t)next;
    w[21] = 0u;
    w[22] = (uint32_t)kSpawnX;
    w[23] = (uint32_t)kSpawnY;
    w[35] = 0u;
  }
  __syncwarp();
  const uint32_t new_row = lane < kBoardH ? w[lane] : 0u;
  cells((int)w[20] * 4, kSpawnX, kSpawnY, ys, xs);
  const bool end = collides_warp(new_row, lane, ys, xs);
  __syncwarp();
  if (lane == 0 && end) w[43] = 1u;
  __syncwarp();
}

}  // namespace tmt
