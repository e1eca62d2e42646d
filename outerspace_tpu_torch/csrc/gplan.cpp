// Native planner core for the windowed-gather expand pipeline
// (sched/gplanner.py), a copy of the JAX package's csrc/gplan.cpp. The
// two sequential host loops that dominate plan time, greedy
// product-space subtile cuts and super-window group packing, are
// O(P/1024) Python iterations; here both run as tight O(nk + nsub)
// passes with ROLLING pointers instead of per-cut binary searches (both
// searched keys are monotone across cuts: the owner pointer follows p,
// and the B-window limit follows the non-decreasing anchors).
//
// The host prepares the task tables; the card consumes them (K1,
// csrc/gexpand.cu). Semantics are EXACTLY the Python loops
// sched/gplanner.py:_cut_subtiles_loop / _pack_groups_loop, kept
// bit-identical and cross-checked by tests/test_torch_gplan.py. Plain
// C++ (no CUDA): runtime/build.py builds it with g++ at first use.
#include <cstdint>

extern "C" {

// Greedy subtile cuts over the product stream.
//   cum:  int64[nk+1] exclusive product prefix (cum[nk] = p_real)
//   jb:   int64[nk]   flat-B start per element (non-decreasing)
//   jend: int64[nk]   flat-B end per element (non-decreasing)
// Writes (p0, owner, banchor) per subtile; returns nsub, or -1 if the
// caller's `cap` is too small (caller falls back to the Python loop).
long long osp_plan_subtiles(
    const long long* cum, const long long* jb, const long long* jend,
    long long nk, long long b_win, long long a_win, long long sub_p,
    long long blk, long long cap,
    long long* out_p0, long long* out_owner, long long* out_banchor) {
  const long long p_real = cum[nk];
  long long nsub = 0;
  long long s = 0;  // owner pointer: last element with cum[s] <= p
  long long f = 0;  // window pointer: first element with jend[f] > limit
  long long p = 0;
  while (p < p_real) {
    while (s + 1 <= nk && cum[s + 1] <= p) ++s;
    const long long anchor_blk = jb[s] / blk;
    const long long limit_b = (anchor_blk + b_win) * blk;
    // limit_b is non-decreasing across cuts (jb[s] monotone), so f only
    // advances. side="right": first f with jend[f] > limit_b.
    while (f < nk && jend[f] <= limit_b) ++f;
    long long q_b;
    if (f < nk) {
      long long extra = limit_b - jb[f];
      if (extra < 0) extra = 0;
      q_b = cum[f] + extra;
    } else {
      q_b = p_real;
    }
    const long long ea = (s / blk + a_win) * blk;
    const long long q_a = (ea < nk) ? cum[ea] : p_real;
    long long q = p + sub_p;
    if (q_b < q) q = q_b;
    if (q_a < q) q = q_a;
    if (p_real < q) q = p_real;
    if (q <= p) return -2;  // cannot happen for valid inputs
    if (nsub >= cap) return -1;
    out_p0[nsub] = p;
    out_owner[nsub] = s;
    out_banchor[nsub] = anchor_blk;
    ++nsub;
    p = q;
  }
  return nsub;
}

// Super-window group packing: consecutive subtiles share a group while
// (a) the group holds < group_subs subtiles, (b) the A window fits the
// SUPER_A refs from the FIRST subtile's 8-block base, (c) the B window
// fits the SUPER_B refs, and (d) the B anchor does not dip below the
// first subtile's base (product-space cuts make anchors locally
// non-monotone). Writes a non-decreasing group id per subtile; returns
// the group count.
long long osp_pack_groups(
    const long long* a_blk, const long long* b_blk, long long nsub,
    long long b_win, long long a_win, long long group_subs,
    long long super_a, long long super_b, int* out_gid) {
  if (nsub == 0) return 0;
  long long gid = 0;
  long long cur = 0;       // subtiles in the current group
  long long a0 = 0, b0 = 0;  // first subtile's anchors
  for (long long t = 0; t < nsub; ++t) {
    const long long al = a_blk[t];
    const long long bl = b_blk[t];
    if (cur > 0) {
      const bool fits =
          cur < group_subs &&
          al + a_win <= (a0 / 8) * 8 + 8 * super_a &&
          bl + b_win <= (b0 / 8) * 8 + 8 * super_b &&
          bl >= (b0 / 8) * 8;
      if (!fits) {
        ++gid;
        cur = 0;
      }
    }
    if (cur == 0) {
      a0 = al;
      b0 = bl;
    }
    out_gid[t] = static_cast<int>(gid);
    ++cur;
  }
  return gid + 1;
}

}  // extern "C"
