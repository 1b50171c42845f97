// The MCTS walk kernels of the search, and the walk of the TPU
// micro-benchmark, hand-written for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (tetris_mcts_tpu_torch/ops/build.py,
// ops/tree_walk.py, ops/bench_walk.py).
//
// Each replaces a Pallas TPU kernel:
//   select_walk     <- _select_kernel (tetris_mcts_tpu/ops/tree_walk.py)
//   insert7_walk    <- _insert7_kernel (same file)
//   lp_backup_walk  <- _lp_backup_kernel (same file)
//   backup_walk     <- _backup_kernel (same file)
//   bench_walk      <- walk_kernel (scripts/microbench_pallas_walk.py)
//
// What bounds them on this card: every walk is a chain of dependent loads
// (a node's child base, its 7 children, their obs statistics, then the next
// level; a probe slot, then the next), so a tree's time is a sum of memory
// latencies and of the serial work between them; the bytes moved are a few
// hundred per level, far under the card's bandwidth (the 34 MB of tree
// state at B=64 stays L2-resident). So the designs cut the number of
// dependent round trips, with a warp per tree: select loads a level's
// children (in lanes 0-6), their statistics and their child bases in two
// round trips and steps the env in shared memory; insert resolves all 7
// keys of a probe round in one round trip, with the claims settled in
// registers; both backups share one walk (warp_welford_walk) that loads up
// to 32 levels of the trace at once (a level a lane) and walks them by
// shuffles, so its round trips are counted per chunk of 32 levels, not per
// level. Updates keep the order of the levels (one trace can hold the same
// obs twice, so Welford updates must not be reordered), and the first index
// wins every exact tie. The bench walk is bound by bytes instead, and
// copies on every SM. The Mosaic workarounds of the TPU kernels (iota-mask
// gathers, i1 widening, VMEM block fitting, alias toggles) have no
// counterpart here. Every loop is bounded: select by D levels, insert by
// kInsertRounds rounds, the backups by the trace length.
//
// Float arithmetic is written in the order of the plain torch versions and
// compiled with --fmad=false, so both round alike.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "env_packed.cuh"

namespace tmt {

constexpr int kActions = 7;
constexpr int kInsertRounds = 128;  // the TPU kernel's _INSERT_ROUNDS

// Indexed by the position of the policy's name in ops/tree_walk.py POLICIES:
// the two orders must match (tests/test_torch_search.py checks it).
enum Policy { kClt = 0, kBayes, kGauss, kUcbv, kMc, kRandom, kGreedy };

// float32(log 2), float32(log 22), float32(log 41), as the torch form uses.
constexpr float kLog2 = 0.6931471824645996f;
constexpr float kLog22 = 3.0910425186157227f;
constexpr float kLog41 = 3.7135720252990723f;

__device__ __forceinline__ float norm_quantile(float t) {
  t = fmaxf(t, 2.0f);
  float alpha = 1.0f - 1.0f / t;
  return 10.0f * logf(1.0f - logf(-logf(alpha) / kLog2) / kLog22) / kLog41;
}

__device__ __forceinline__ float std_quantile2(float nu, float t) {
  nu = fmaxf(nu, 1.0f);
  t = fmaxf(t, 2.0f);
  float alpha = 2.0f / t;
  float f_nu = 1.0f / (nu + 1.0f);
  float g_alpha = 1.0f / sqrtf(-logf(alpha * (2.0f - alpha)));
  float h = powf(2.0f * alpha * sqrtf(nu), 1.0f / nu);
  float t_inv = -0.0953f - 0.631f * f_nu + 0.81f * g_alpha + 0.076f * h;
  return 1.0f / t_inv;
}

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// select: walk + inline env stepping + the leaf's 7 child steps.
//
// A warp per tree, kSelectWarps trees a block. Lanes 0-6 hold the 7
// children of the current node: each loads its child's obs id, score, obs
// statistics and gumbel, computes its own kept flag (against the others
// through shuffles) and its own candidate; the max is a warp reduction with
// the serial loop's NaN rule, and the lowest lane holding it wins
// (__ballot_sync + __ffs), so the first index still wins every exact tie.
// n_total is a shuffle sum: visit counts are small integers, so any order
// gives the same float. Each child's lane also fetches that child's own
// child base, so a level costs two dependent loads (children, then their
// statistics), not three. Each tree's 44-word env and its 7 children's live
// in shared memory; the whole warp steps the walk's env at each descent (a
// board row a lane: packed_step_warp), lanes 0-6 step the 7 children at
// once (packed_step, a child a lane) and all lanes write them out
// coalesced. Levels stay strictly sequential, bounded by D. Every float
// expression is the plain version's, per child, in its order.
// ---------------------------------------------------------------------------
constexpr int kSelectWarps = 2;

struct SelectSmem {
  uint32_t w[kWords];                // the walk's env
  uint32_t ch[kActions][kWords];     // the leaf's 7 children
  uint32_t pk[kActions][kBoardH];    // their packed boards
};

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

__global__ void __launch_bounds__(kSelectWarps * 32)
select_kernel(const int* __restrict__ cbase, const float* __restrict__ nstat,
              const float* __restrict__ visits,
              const float* __restrict__ values,
              const float* __restrict__ vars, const int* __restrict__ root,
              const uint32_t* __restrict__ env0,
              const float* __restrict__ gumbels,
              const float* __restrict__ rnd, int* traces, int* lengths,
              int* leafs, uint32_t* leaf_env, uint32_t* child_packed,
              int* child_score, int* child_end, int B, int N, int M, int D,
              int policy, int low, int app, int scoring, int randomizer) {
  __shared__ SelectSmem smem[kSelectWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kSelectWarps + warp;
  if (b >= B) return;  // the whole warp leaves together
  SelectSmem& sm = smem[warp];
  const int* cb = cbase + (size_t)b * N;
  const float* score = nstat + (size_t)b * 2 * N;
  const float* obs_id = score + N;
  const float* vis = visits + (size_t)b * M;
  const float* val = values + (size_t)b * M;
  const float* var_ = vars + (size_t)b * M;
  int* tr = traces + (size_t)b * D;
  const bool child = lane < kActions;
  const bool need_rnd = policy == kMc || policy == kRandom;

  for (int i = lane; i < kWords; i += 32) sm.w[i] = env0[(size_t)b * kWords + i];
  __syncwarp();

  int idx = root[b];
  float sc = score[idx];
  int c = cb[idx];
  int len = D, leaf = idx;
  for (int depth = 0; depth < D; ++depth) {
    if (lane == 0) tr[depth] = idx;
    leaf = idx;
    const size_t plane = ((size_t)b * D + depth) * kActions + lane;
    const float g = child ? gumbels[plane] : 0.0f;
    const float rn = child && need_rnd ? rnd[plane] : 0.0f;
    const bool valid = c != 0;
    const int obs = valid && child ? (int)obs_id[c + lane] : -1;
    const float sck = valid && child ? score[c + lane] : 0.0f;
    // each child's own child base, fetched with its obs id and score, so
    // the next level needs no load of its own
    const int c_child = valid && child ? cb[c + lane] : 0;
    // unique children by obs: keep the earliest child of each obs group
    // with the group's max score
    bool kept = valid && child;
#pragma unroll
    for (int j = 0; j < kActions; ++j) {
      const int oj = __shfl_sync(kFull, obs, j);
      const float sj = __shfl_sync(kFull, sck, j);
      const bool beats = sck > sj || (sck == sj && lane <= j);
      if (oj == obs && !beats) kept = false;
    }
    if (__ballot_sync(kFull, kept) == 0u) {
      len = depth + 1;
      break;
    }
    float vi = 0.0f, va = 0.0f, vr = 0.0f;
    if (kept) {
      vi = vis[obs];
      va = val[obs];
      vr = var_[obs];
    }
    float n_total = vi;  // exact: visit counts are small integers
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      n_total += __shfl_xor_sync(kFull, n_total, off);
    const bool is_low = kept && vi < (float)low;
    const bool any_low = __any_sync(kFull, is_low);
    float cand;
    if (!kept) {
      cand = -INFINITY;
    } else if (any_low) {
      cand = is_low ? g : -INFINITY;
    } else {
      float q_base = va + sck - sc;
      float var = fmaxf(vr, 0.0f);
      float nv = fmaxf(vi, 1.0f);
      float explore;
      switch (policy) {
        case kClt: explore = norm_quantile(n_total) * sqrtf(var / nv); break;
        case kBayes:
          explore = fminf(fmaxf(std_quantile2(nv - 1.0f, n_total), 0.0f), 1e3f)
                    * sqrtf(var / fmaxf(nv - 1.0f, 1.0f));
          break;
        case kGauss: explore = norm_quantile(n_total) * sqrtf(var); break;
        case kUcbv: explore = sqrtf(var * logf(fmaxf(n_total, 2.0f))); break;
        case kMc: explore = rn * sqrtf(var); break;
        case kRandom: explore = rn * 1e9f - q_base; break;
        default: explore = 0.0f; break;
      }
      cand = q_base + explore;
    }
    // the max, NaN if any candidate is NaN (then no lane matches it, as in
    // torch); lanes 7-31 hold -inf
    float cmax = cand;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cmax = nan_max(cmax, __shfl_xor_sync(kFull, cmax, off));
    const unsigned hit = __ballot_sync(kFull, child && cand == cmax);
    const int choice = hit ? __ffs(hit) - 1 : kActions;
    const float sc_pick = __shfl_sync(kFull, sck, choice & 31);
    const int c_pick = __shfl_sync(kFull, c_child, choice & 31);
    // descend steps the carried env (the whole warp, a row a lane), except
    // on the last level of a depth-capped walk
    if (depth < D - 1) packed_step_warp(sm.w, choice, app, scoring, randomizer, lane);
    idx = choice < kActions ? c + choice : 0;
    sc = choice < kActions ? sc_pick : 0.0f;
    c = choice < kActions ? c_pick : cb[0];
  }
  // the leaf is the last node recorded; the rest of the trace is 0
  for (int d = len + lane; d < D; d += 32) tr[d] = 0;
  if (lane == 0) {
    lengths[b] = len;
    leafs[b] = leaf;
  }
  for (int i = lane; i < kWords; i += 32) leaf_env[(size_t)b * kWords + i] = sm.w[i];
  if (child) {
    uint32_t* ch = sm.ch[lane];
    for (int i = 0; i < kWords; ++i) ch[i] = sm.w[i];
    packed_step(ch, lane, app, scoring, randomizer);
    packed_obs(ch, sm.pk[lane]);
    child_score[b * kActions + lane] = (int)ch[36];
    child_end[b * kActions + lane] = (int)ch[43];
  }
  __syncwarp();
  const uint32_t* pk = &sm.pk[0][0];
  for (int i = lane; i < kActions * kBoardH; i += 32)
    child_packed[(size_t)b * kActions * kBoardH + i] = pk[i];
}

// ---------------------------------------------------------------------------
// insert: hash the 7 child boards, find-or-create their obs ids in the
// tree's open-addressing table, write the fresh ids' obs rows.
//
// What bounds it is a chain of dependent loads: the boards, then one probe
// round after another. A warp per tree, kWalkWarps trees a block; lane a
// (0-6) owns action a, so a round costs one round trip. The warp copies the 7 x 20 board words into shared memory in one
// coalesced round trip, with ok and n_obs; lane a hashes its row from
// there (a wrapping u32 sum, so any order gives the same key). The group
// representative is the lowest lane of its __match_any_sync group on the
// 64-bit key. Each probe round is one round trip: every unplaced lane loads
// tobs/th1/th2 at its slot at once. When distinct keys contend for one slot
// the LAST contending action's key survives (the plain version writes
// action by action, as the TPU kernel's unrolled writes do): that is the
// highest lane of the __match_any_sync group of attempting lanes on the
// slot, found in registers with no read-back of th1/th2.
// Ids are n_obs + the winners below the lane (a popcount of the ballot),
// kept only while < M; the winner writes the key (always) and the id (when
// kept). Losers see the winner's key on the next round's load. Stores of
// one round reach the next round's loads through __syncwarp. The fresh
// representatives' obs_bits rows (140 words at most) are written by the
// whole warp from shared memory.
// ---------------------------------------------------------------------------
constexpr int kWalkWarps = 2;           // trees a block: insert and both backups
constexpr unsigned kActionLanes = (1u << kActions) - 1;

__constant__ uint32_t kHK1[20] = {
    0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du, 0x27D4EB2Fu, 0x165667B1u,
    0xD3A2646Du, 0xFD7046C5u, 0xB55A4F09u, 0x94D049BBu, 0xBF58476Du,
    0x2545F491u, 0x708ED7D7u, 0x9E6C63D1u, 0xA3B19535u, 0x8DA6B343u,
    0xD8163841u, 0xCB9E59B1u, 0x6295C58Du, 0x2F6BBB77u, 0x452821E7u};
__constant__ uint32_t kHK2[20] = {
    0x38495AB5u, 0xA4093823u, 0x299F31D1u, 0x082EFA99u, 0xEC4E6C89u,
    0x452821E7u, 0x38D01377u, 0xBE5466CFu, 0x34E90C6Du, 0xC97C50DDu,
    0x3F84D5B5u, 0xB5470917u, 0x9216D5D9u, 0x8979FB1Bu, 0xD1310BA7u,
    0x98DFB5ADu, 0x2FFD72DBu, 0xD01ADFB7u, 0xB8E1AFEDu, 0x6A267E97u};

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  return h ^ (h >> 16);
}

struct InsertSmem {
  uint32_t pk[kActions * kBoardH];  // the 7 boards, action-major
  int fresh[kActions];              // the fresh id of each action, or -1
};

__global__ void __launch_bounds__(kWalkWarps * 32)
insert7_kernel(const uint32_t* __restrict__ packed7,
               const bool* __restrict__ end7, const bool* __restrict__ ok,
               uint32_t* tbl_h1, uint32_t* tbl_h2, int* tbl_obs, int* n_obs,
               bool* obs_end, uint32_t* obs_bits, int* obs7, int B, int T,
               int M, int probe_double) {
  __shared__ InsertSmem smem[kWalkWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWalkWarps + warp;
  if (b >= B) return;  // the whole warp leaves together
  InsertSmem& sm = smem[warp];
  const uint32_t* pk = packed7 + (size_t)b * kActions * kBoardH;
  uint32_t* th1 = tbl_h1 + (size_t)b * T;
  uint32_t* th2 = tbl_h2 + (size_t)b * T;
  int* tobs = tbl_obs + (size_t)b * T;
  const uint32_t mask = (uint32_t)(T - 1);

  for (int i = lane; i < kActions * kBoardH; i += 32) sm.pk[i] = pk[i];
  const bool okb = ok[b];
  const int nobs0 = n_obs[b];
  __syncwarp();
  if (lane < kActions) {
    uint32_t s1 = 0u, s2 = 0u;
#pragma unroll
    for (int r = 0; r < kBoardH; ++r) {
      const uint32_t w = sm.pk[lane * kBoardH + r];
      s1 += w * kHK1[r];
      s2 += w * kHK2[r];
    }
    const uint32_t h1 = mix32(s1), h2 = mix32(s2);
    // double hashing steps by h2 | 1 (odd, so coprime with the
    // power-of-two table: the sequence visits every slot), else by 1
    const uint32_t step = probe_double ? (h2 | 1u) : 1u;
    const unsigned same =
        __match_any_sync(kActionLanes, ((unsigned long long)h2 << 32) | h1);
    const bool rep = __ffs(same) - 1 == lane;  // lowest action of its key
    uint32_t slot = h1 & mask;
    bool placed = !okb;
    int obs = 0, nobs = nobs0;
    for (int round = 0; round < kInsertRounds; ++round) {
      if (__ballot_sync(kActionLanes, !placed) == 0u) break;
      int tid = 0;
      uint32_t k1 = 0u, k2 = 0u;
      if (!placed) {
        tid = tobs[slot];
        k1 = th1[slot];
        k2 = th2[slot];
      }
      const bool occ = tid != 0;
      const bool match = occ && k1 == h1 && k2 == h2;
      if (!placed && match) {
        obs = tid;
        placed = true;
      }
      const bool full = nobs >= M;
      const bool at_empty = !placed && !occ;
      if (at_empty && full) placed = true;  // pool exhausted: obs 0
      const bool attempt = at_empty && !full && rep;
      // the highest attempting lane on a slot is the last contending action,
      // whose key the serial claim in action order leaves in the table
      const unsigned on_slot =
          __match_any_sync(kActionLanes, attempt ? (int)slot : -1 - lane);
      const bool claims = attempt && lane == 31 - __clz(on_slot);
      const unsigned claimed = __ballot_sync(kActionLanes, claims);
      const int id = nobs + __popc(claimed & ((1u << lane) - 1u));
      const bool won = claims && id < M;
      if (claims) {
        th1[slot] = h1;
        th2[slot] = h2;
      }
      if (won) {
        tobs[slot] = id;
        obs = id;
        placed = true;
      }
      nobs += __popc(__ballot_sync(kActionLanes, won));
      if (!placed && occ && !match) slot = (slot + step) & mask;
      __syncwarp(kActionLanes);  // this round's stores before the next loads
    }
    if (lane == 0) n_obs[b] = nobs;
    obs7[b * kActions + lane] = obs;
    const bool fresh = okb && obs >= nobs0 && rep;
    if (fresh) obs_end[(size_t)b * M + obs] = end7[b * kActions + lane];
    sm.fresh[lane] = fresh ? obs : -1;
  }
  __syncwarp();
  for (int i = lane; i < kActions * kBoardH; i += 32) {
    const int a = i / kBoardH;
    const int o = sm.fresh[a];
    if (o >= 0) obs_bits[((size_t)b * kBoardH + (i - a * kBoardH)) * M + o] = sm.pk[i];
  }
}

// ---------------------------------------------------------------------------
// The reverse Welford + gamma walk up one tree's trace, a warp per tree:
// the walk of both backups (lp_backup_kernel and backup_kernel), as the TPU
// kernels share _reverse_welford_walk, so a fix reaches both.
//
// Levels run len-1 .. 0 in order: a trace can hold the same obs twice, and
// each visit must see the earlier ones' updates. A first visit sets (v_rel, var0); later ones run the Welford
// mean/var update. Then v <- gamma * v_rel + node score. What bounds the
// walk is its chain of dependent loads (trace entry -> node -> obs
// statistics, a level at a time), so it takes up to 32 levels at once, lane
// l on level top-l of the chunk that starts at level `top`: one round trip
// for every level's trace entry, one for the nodes' score/obs, one for the
// statistics. The rest is arithmetic and shuffles, in two passes:
//   1. v, level by level: each step broadcasts the level's score and every
//      lane computes the same next v (the only serial chain), and the
//      level's lane keeps its v_rel;
//   2. the statistics, every lane its own level at once. The levels of one
//      obs in the chunk are a __match_any_sync group; its k-th level (k-th
//      lane from the lowest, k = 0, 1, ...) is final in round k, which
//      starts from the (k-1)-th level's result, shuffled to it at the end
//      of round k-1. So there are as many rounds as the largest group has
//      levels (1 when no obs repeats in the chunk).
// The group's last level (its highest lane) stores, once per distinct obs.
// A later chunk loads after the previous chunk's stores and a __syncwarp,
// so obs repeated across chunks see the earlier updates. Lanes past the
// trace (t < 0) key their group by -1 - lane, so they join none. Every
// float operation is the plain version's, in its order.
//
// When `loaded`, the caller has already fetched the first chunk's levels
// (s, o, and the obs statistics n/va/vr; o = -1 off the trace), together
// with loads of its own; otherwise the walk fetches them.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void warp_welford_walk(
    const int* tr, int len, const float* score, const float* obs_id,
    float* vis, float* val, float* var_, bool loaded, float s, int o, float n,
    float va, float vr, float v, float var0, float gamma, int lane) {
  for (int top = len - 1; top >= 0; top -= 32) {
    const int t = top - lane;
    const bool live = t >= 0;
    if (top != len - 1 || !loaded) {
      const int idx = live ? tr[t] : 0;
      s = live ? score[idx] : 0.0f;
      o = live ? (int)obs_id[idx] : -1;
      n = live ? vis[o] : 0.0f;
      va = live ? val[o] : 0.0f;
      vr = live ? var_[o] : 0.0f;
    }
    // 1. the serial v chain; every lane holds the same v
    const int steps = min(top + 1, 32);
    float v_rel = 0.0f;
    for (int i = 0; i < steps; ++i) {
      const float s_i = __shfl_sync(kFull, s, i);
      const float d = v - s_i;
      if (lane == i) v_rel = d;
      v = gamma * d + s_i;
    }
    // 2. the statistics, a round per visit of the most repeated obs
    const unsigned grp = __match_any_sync(kFull, live ? o : -1 - lane);
    const unsigned before = grp & ((1u << lane) - 1u);  // earlier visits
    const int prev = before ? 31 - __clz(before) : lane;
    const unsigned rank = __popc(before);
    const unsigned rounds = __reduce_max_sync(kFull, rank);
    float n1, va1, vr1;
    for (unsigned r = 0;; ++r) {
      const bool first = n == 0.0f;
      const float delta = v_rel - va;
      va1 = first ? v_rel : va + delta / (n + 1.0f);
      const float delta2 = v_rel - va1;
      vr1 = first ? var0 : vr + (delta * delta2 - vr) / (n + 1.0f);
      n1 = n + 1.0f;
      if (r == rounds) break;
      // the next visit of each obs starts from this round's result
      const float pn = __shfl_sync(kFull, n1, prev);
      const float pva = __shfl_sync(kFull, va1, prev);
      const float pvr = __shfl_sync(kFull, vr1, prev);
      if (rank == r + 1) {
        n = pn;
        va = pva;
        vr = pvr;
      }
    }
    if (live && lane == 31 - __clz(grp)) {  // the obs's last visit stores
      vis[o] = n1;
      val[o] = va1;
      var_[o] = vr1;
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// LP backup: seed the leaf's fresh unique children, average, then the
// reverse Welford + gamma walk up the trace (warp_welford_walk).
//
// A warp per tree, kWalkWarps trees a block. What bounds it is the chain of
// dependent loads, so the seed's loads share the round trips of the walk's
// first chunk, lane l on level len-1-l: lengths, then every level's trace
// entry, then its node's score/obs (lanes 0-6 fetch the leaf's child base
// in the same round trip), then the 7 children (lanes 0-6), then the
// statistics of the children and of every level at once.
// Lanes 0-6 seed their fresh kept children, and every lane sums the kept
// children in action order through a serial shuffle chain, so v and var0
// are the plain version's floats, the same in every lane. A level whose obs
// is a seeded child's takes the seeded statistics from that lane. Then the
// walk runs from those loaded levels.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kWalkWarps * 32)
lp_backup_kernel(const int* __restrict__ traces,
                 const int* __restrict__ lengths,
                 const float* __restrict__ v_nn,
                 const float* __restrict__ var_nn,
                 const bool* __restrict__ expanded,
                 const int* __restrict__ cbase,
                 const float* __restrict__ nstat,
                 const bool* __restrict__ end, float* visits, float* values,
                 float* vars, int B, int N, int M, int D, float gamma) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWalkWarps + warp;
  if (b >= B) return;  // the whole warp leaves together
  const int* tr = traces + (size_t)b * D;
  const float* score = nstat + (size_t)b * 2 * N;
  const float* obs_id = score + N;
  float* vis = visits + (size_t)b * M;
  float* val = values + (size_t)b * M;
  float* var_ = vars + (size_t)b * M;
  const bool child = lane < kActions;

  const int len = min(lengths[b], D);
  const bool exp_ = expanded[b];
  const float vnn = child ? v_nn[b * kActions + lane] : 0.0f;
  const float varnn = child ? var_nn[b * kActions + lane] : 0.0f;
  // the first chunk's levels; lane 0 always reads the leaf, tr[max(len-1, 0)]
  const int t = len - 1 - lane;
  const bool live = t >= 0;
  const int idx = live || lane == 0 ? tr[max(t, 0)] : 0;
  const int leaf = __shfl_sync(kFull, idx, 0);
  const float s = live || lane == 0 ? score[idx] : 0.0f;
  const int o = live ? (int)obs_id[idx] : -1;
  const int c = child ? cbase[(size_t)b * N + leaf] : 0;
  const float leaf_score = __shfl_sync(kFull, s, 0);
  // the leaf's children, a child a lane (c is 0 off lanes 0-6)
  const bool has_kids = c != 0;
  const int ko = has_kids ? (int)obs_id[c + lane] : -1;
  const float ksc = has_kids ? score[c + lane] : 0.0f;
  const bool kend = has_kids && end[(size_t)b * N + c + lane];
  // unique children by obs: keep the earliest child of each obs group with
  // the group's max score
  bool kept = has_kids && exp_;
#pragma unroll
  for (int j = 0; j < kActions; ++j) {
    const int oj = __shfl_sync(kFull, ko, j);
    const float sj = __shfl_sync(kFull, ksc, j);
    const bool beats = ksc > sj || (ksc == sj && lane <= j);
    if (oj == ko && !beats) kept = false;
  }
  float kvi = 0.0f, kva = 0.0f, kvr = 0.0f;
  if (kept) {
    kvi = vis[ko];
    kva = val[ko];
    kvr = var_[ko];
  }
  float n = 0.0f, va = 0.0f, vr = 0.0f;
  if (live) {
    n = vis[o];
    va = val[o];
    vr = var_[o];
  }
  __syncwarp();  // every load above comes before the seed's stores
  const bool seed = kept && kvi == 0.0f;
  if (seed) {
    kvi = kvi + 1.0f;
    kva = kend ? 0.0f : vnn;
    kvr = kend ? 0.0f : varnn;
    vis[ko] = kvi;
    val[ko] = kva;
    var_[ko] = kvr;
  }
  // the kept children's sums in action order, the same chain in every lane
  const float term = ksc + gamma * kva;
  const unsigned kept_mask = __ballot_sync(kFull, kept);
  const unsigned seed_mask = __ballot_sync(kFull, seed);
  float v_sum = 0.0f, var_sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kActions; ++j) {
    const float tj = __shfl_sync(kFull, term, j);
    const float rj = __shfl_sync(kFull, kvr, j);
    const int oj = __shfl_sync(kFull, ko, j);
    const float aj = __shfl_sync(kFull, kva, j);
    if (kept_mask >> j & 1u) {
      v_sum = v_sum + tj;
      var_sum = var_sum + rj;
    }
    // a level holding a seeded child's obs takes the seeded statistics
    if ((seed_mask >> j & 1u) && live && oj == o) {
      n = 1.0f;
      va = aj;
      vr = rj;
    }
  }
  const float kf = (float)max(__popc(kept_mask), 1);
  const float v = exp_ ? v_sum / kf : leaf_score;
  const float var0 = exp_ ? var_sum * gamma * gamma / kf : 0.0f;
  __syncwarp();  // the seed's stores come before the walk's

  warp_welford_walk(tr, len, score, obs_id, vis, val, var_, true, s, o, n, va, vr,
                    v, var0, gamma, lane);
}

// ---------------------------------------------------------------------------
// backup: the reverse Welford + gamma walk from given (v0, var0) per lane
// (the leaf and rollout evaluators' backup).
//
// A warp per tree, kWalkWarps trees a block: lengths, v0 and var0 in one
// round trip, then warp_welford_walk, which fetches its chunks itself.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kWalkWarps * 32)
backup_kernel(const int* __restrict__ traces, const int* __restrict__ lengths,
              const float* __restrict__ v0, const float* __restrict__ var0,
              const float* __restrict__ nstat, float* visits, float* values,
              float* vars, int B, int N, int M, int D, float gamma) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWalkWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const float* score = nstat + (size_t)b * 2 * N;
  warp_welford_walk(traces + (size_t)b * D, min(lengths[b], D), score, score + N,
                    visits + (size_t)b * M, values + (size_t)b * M,
                    vars + (size_t)b * M, false, 0.0f, -1, 0.0f, 0.0f, 0.0f,
                    v0[b], var0[b], gamma, lane);
}

// ---------------------------------------------------------------------------
// bench walk: the TPU micro-benchmark's walk over (M, B) statistics, lanes
// minor: copy the three statistics to fresh outputs, then each of B lanes
// walks L levels, a Welford update of row idxs[t, b] of its column toward
// acc a level, then acc *= 0.999.
//
// What bounds it is bytes: the copy moves 2 x 3 x M x B x 4 bytes, the
// walk a few hundred bytes a lane. So the copy runs on every SM: block j
// owns rows [j R, (j+1) R) of the three arrays, a flat run of R x B floats
// in each, which its threads copy kBenchBatch 16-byte loads of each array
// at a time before their stores (4-byte loads where B is not a multiple of
// 4 or a pointer is not 16-byte aligned). A level's update touches only its
// own entry (row, lane), and acc after t levels is the same in every lane,
// so the walk splits by rows as well: each block walks, a thread a lane,
// the levels whose row it owns, and needs no order with any other block. A
// thread loads its lane's L idxs before the copy (one round trip), the
// input statistics of its levels after it (independent loads, one round
// trip), runs the updates in registers in level order, a level on a row
// already walked taking the latest earlier level's result, and after the
// __syncthreads that puts the block's copy first, stores the last result of
// each distinct row once. The TPU kernel's one-hot masks over all M rows
// become direct indexing.
// ---------------------------------------------------------------------------
constexpr int kBenchThreads = 256;
constexpr int kBenchBatch = 4;    // loads of each array a thread has in flight
constexpr int kBenchLevels = 16;  // the script's walk depth, the kernel's most
// the floats of each array a block copies, about: R = max(1, this / B)
constexpr int kBenchRun = kBenchThreads * 4 * kBenchBatch;

// Copy n elements of three arrays, kBenchBatch loads a thread in flight.
template <typename T>
__device__ __forceinline__ void copy3(const T* __restrict__ a, const T* __restrict__ b,
                                      const T* __restrict__ c, T* __restrict__ x,
                                      T* __restrict__ y, T* __restrict__ z, size_t n) {
  for (size_t i = threadIdx.x; i < n; i += kBenchThreads * kBenchBatch) {
    T va[kBenchBatch], vb[kBenchBatch], vc[kBenchBatch];
#pragma unroll
    for (int k = 0; k < kBenchBatch; ++k) {
      const size_t j = i + k * kBenchThreads;
      if (j < n) {
        va[k] = a[j];
        vb[k] = b[j];
        vc[k] = c[j];
      }
    }
#pragma unroll
    for (int k = 0; k < kBenchBatch; ++k) {
      const size_t j = i + k * kBenchThreads;
      if (j < n) {
        x[j] = va[k];
        y[j] = vb[k];
        z[j] = vc[k];
      }
    }
  }
}

// Lane b's walk over the rows [m0, m1): m[t] is level t's row (-1 past L).
// Loads the inputs of the owned levels and leaves each level's result in
// (n, a, r); returns the mask of the levels that store (the last level on
// each owned row).
__device__ __forceinline__ unsigned bench_lane(
    const int (&m)[kBenchLevels], int b, int B, int m0, int m1,
    const float* __restrict__ visit_in, const float* __restrict__ value_in,
    const float* __restrict__ var_in, float (&n)[kBenchLevels],
    float (&a)[kBenchLevels], float (&r)[kBenchLevels]) {
  unsigned own = 0;
#pragma unroll
  for (int t = 0; t < kBenchLevels; ++t) {
    n[t] = a[t] = r[t] = 0.0f;
    if (m[t] >= m0 && m[t] < m1) {
      own |= 1u << t;
      const size_t i = (size_t)m[t] * B + b;
      n[t] = visit_in[i];
      a[t] = value_in[i];
      r[t] = var_in[i];
    }
  }
  unsigned store = 0;
  float acc = 1.0f;
#pragma unroll
  for (int t = 0; t < kBenchLevels; ++t) {
    if (own >> t & 1u) {
      float vi = n[t], va = a[t], vr = r[t];
#pragma unroll
      for (int u = 0; u < t; ++u) {
        if (m[u] == m[t]) {  // the row's latest earlier level, already walked
          vi = n[u];
          va = a[u];
          vr = r[u];
        }
      }
      const float x = acc - va;
      n[t] = vi + 1.0f;
      a[t] = va + x / (vi + 1.0f);
      r[t] = vr + x * x / (vi + 1.0f);
      bool last = true;
#pragma unroll
      for (int u = t + 1; u < kBenchLevels; ++u) last = last && m[u] != m[t];
      if (last) store |= 1u << t;
    }
    acc = acc * 0.999f;
  }
  return store;
}

__device__ __forceinline__ void bench_store(
    unsigned store, const int (&m)[kBenchLevels], int b, int B,
    const float (&n)[kBenchLevels], const float (&a)[kBenchLevels],
    const float (&r)[kBenchLevels], float* visit, float* value, float* var) {
#pragma unroll
  for (int t = 0; t < kBenchLevels; ++t) {
    if (store >> t & 1u) {
      const size_t i = (size_t)m[t] * B + b;
      visit[i] = n[t];
      value[i] = a[t];
      var[i] = r[t];
    }
  }
}

__device__ __forceinline__ void bench_rows(const int* __restrict__ idxs, int b, int B,
                                           int L, int (&m)[kBenchLevels]) {
#pragma unroll
  for (int t = 0; t < kBenchLevels; ++t) m[t] = t < L ? idxs[t * B + b] : -1;
}

__global__ void __launch_bounds__(kBenchThreads)
bench_walk_kernel(const int* __restrict__ idxs,
                  const float* __restrict__ visit_in,
                  const float* __restrict__ value_in,
                  const float* __restrict__ var_in, float* visit,
                  float* value, float* var, int B, int M, int L, int R,
                  bool vec) {
  const int m0 = blockIdx.x * R, m1 = min(M, m0 + R);
  int m[kBenchLevels];
  float n[kBenchLevels], a[kBenchLevels], r[kBenchLevels];
  int b = threadIdx.x;  // the thread's first lane
  if (b < B) bench_rows(idxs, b, B, L, m);
  const size_t lo = (size_t)m0 * B, cnt = (size_t)(m1 - m0) * B;
  if (vec)
    copy3((const float4*)(visit_in + lo), (const float4*)(value_in + lo),
          (const float4*)(var_in + lo), (float4*)(visit + lo), (float4*)(value + lo),
          (float4*)(var + lo), cnt / 4);
  else
    copy3(visit_in + lo, value_in + lo, var_in + lo, visit + lo, value + lo, var + lo,
          cnt);
  unsigned store = 0;
  if (b < B) store = bench_lane(m, b, B, m0, m1, visit_in, value_in, var_in, n, a, r);
  __syncthreads();  // the block's copy of its rows lands before the walk's
  if (b < B) bench_store(store, m, b, B, n, a, r, visit, value, var);
  for (b += kBenchThreads; b < B; b += kBenchThreads) {  // lanes past the block
    bench_rows(idxs, b, B, L, m);
    store = bench_lane(m, b, B, m0, m1, visit_in, value_in, var_in, n, a, r);
    bench_store(store, m, b, B, n, a, r, visit, value, var);
  }
}

}  // namespace tmt

using namespace tmt;

extern "C" {

int select_walk(const void* cbase, const void* nstat, const void* visits,
                const void* values, const void* vars, const void* root,
                const void* env0, const void* gumbels, const void* rnd,
                void* traces, void* lengths, void* leafs, void* leaf_env,
                void* child_packed, void* child_score, void* child_end, int B,
                int N, int M, int D, int policy, int low, int app, int scoring,
                int randomizer, void* stream) {
  const int grid = (B + kSelectWarps - 1) / kSelectWarps;
  select_kernel<<<grid, kSelectWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int*)cbase, (const float*)nstat, (const float*)visits,
      (const float*)values, (const float*)vars, (const int*)root,
      (const uint32_t*)env0, (const float*)gumbels, (const float*)rnd,
      (int*)traces, (int*)lengths, (int*)leafs, (uint32_t*)leaf_env,
      (uint32_t*)child_packed, (int*)child_score, (int*)child_end, B, N, M, D,
      policy, low, app, scoring, randomizer);
  return (int)cudaGetLastError();
}

int insert7_walk(const void* packed7, const void* end7, const void* ok,
                 void* tbl_h1, void* tbl_h2, void* tbl_obs, void* n_obs,
                 void* obs_end, void* obs_bits, void* obs7, int B, int T,
                 int M, int probe_double, void* stream) {
  const int grid = (B + kWalkWarps - 1) / kWalkWarps;
  insert7_kernel<<<grid, kWalkWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)packed7, (const bool*)end7, (const bool*)ok,
      (uint32_t*)tbl_h1, (uint32_t*)tbl_h2, (int*)tbl_obs, (int*)n_obs,
      (bool*)obs_end, (uint32_t*)obs_bits, (int*)obs7, B, T, M, probe_double);
  return (int)cudaGetLastError();
}

int lp_backup_walk(const void* traces, const void* lengths, const void* v_nn,
                   const void* var_nn, const void* expanded, const void* cbase,
                   const void* nstat, const void* end, void* visits,
                   void* values, void* vars, int B, int N, int M, int D,
                   float gamma, void* stream) {
  const int grid = (B + kWalkWarps - 1) / kWalkWarps;
  lp_backup_kernel<<<grid, kWalkWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int*)traces, (const int*)lengths, (const float*)v_nn,
      (const float*)var_nn, (const bool*)expanded, (const int*)cbase,
      (const float*)nstat, (const bool*)end, (float*)visits, (float*)values,
      (float*)vars, B, N, M, D, gamma);
  return (int)cudaGetLastError();
}

int backup_walk(const void* traces, const void* lengths, const void* v0,
                const void* var0, const void* nstat, void* visits,
                void* values, void* vars, int B, int N, int M, int D,
                float gamma, void* stream) {
  const int grid = (B + kWalkWarps - 1) / kWalkWarps;
  backup_kernel<<<grid, kWalkWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int*)traces, (const int*)lengths, (const float*)v0,
      (const float*)var0, (const float*)nstat, (float*)visits,
      (float*)values, (float*)vars, B, N, M, D, gamma);
  return (int)cudaGetLastError();
}

// idxs (L, B) int32 in [0, M), L <= 16; stats and outputs (M, B) float32.
int bench_walk(const void* idxs, const void* visit_in, const void* value_in,
               const void* var_in, void* visit, void* value, void* var, int B,
               int M, int L, void* stream) {
  if (L > kBenchLevels) return (int)cudaErrorInvalidValue;
  const int R = max(1, kBenchRun / max(B, 1));
  const int grid = (M + R - 1) / R;
  // 16-byte copies need B % 4 == 0 and every array 16-byte aligned
  const uintptr_t ptrs = (uintptr_t)visit_in | (uintptr_t)value_in |
                         (uintptr_t)var_in | (uintptr_t)visit | (uintptr_t)value |
                         (uintptr_t)var;
  const bool vec = B % 4 == 0 && ptrs % 16 == 0;
  bench_walk_kernel<<<grid, kBenchThreads, 0, (cudaStream_t)stream>>>(
      (const int*)idxs, (const float*)visit_in, (const float*)value_in,
      (const float*)var_in, (float*)visit, (float*)value, (float*)var, B, M, L, R,
      vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
