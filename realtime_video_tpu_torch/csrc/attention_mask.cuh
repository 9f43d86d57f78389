// Key and query ranges of the attention kernels' masks, shared by the forward
// (csrc/attention_sm90.cu) and the backward (csrc/attention_bwd_sm90.cu).
//
// Teacher forcing (mode 2) runs over the sequence [clean | noisy], each half L
// tokens in blocks of B tokens (L a multiple of B), the mask of the JAX
// package's ops/attention.py::teacher_forcing_mask:
//   * a clean query of block j sees the clean keys [0, (j + 1) B);
//   * a noisy query of block j sees the clean keys of the earlier blocks,
//     [0, j B), and its own noisy block, [L + j B, L + (j + 1) B).
// The diagonal lies inside both rules. A query tile walks the union of two
// key ranges and never touches the gap between them; a key tile of the
// backward walks the transpose: a clean key of block b is seen by the clean
// queries [b B, L) and the noisy queries [L + (b + 1) B, 2L), a noisy key of
// block b by the noisy queries [L + b B, L + (b + 1) B) alone.
#pragma once

namespace rtv_mask {

constexpr int MODE_TEACHER_FORCING = 2;

// planted faults for the checks that must catch them (kernel arguments)
constexpr int FAULT_TF_LEAK = 4;          // a noisy block also sees its own clean block
constexpr int FAULT_TF_SHORT = 5;         // the noisy range ends 16 keys short
constexpr int FAULT_TF_DROP_CLEAN = 6;    // noisy blocks j >= 1 see no clean keys
constexpr int FAULT_TF_SKIP_NOISY_Q = 7;  // backward: a clean key's dK/dV skips the
                                          // noisy queries of the later blocks

// The live keys of one query row: [0, a_hi) and [b_lo, b_hi).
struct TfRow {
  int a_hi, b_lo, b_hi;
};

__device__ __forceinline__ TfRow tf_row(int q, int L, int B, int fault) {
  if (q < L) return {(q / B + 1) * B, 0, 0};
  const int j = (q - L) / B;
  TfRow r = {j * B, L + j * B, L + (j + 1) * B};
  if (fault == FAULT_TF_LEAK) r.a_hi += B;
  if (fault == FAULT_TF_SHORT) r.b_hi -= 16;
  if (fault == FAULT_TF_DROP_CLEAN && j >= 1) r.a_hi = 0;
  return r;
}

// The queries that see key k: [c_lo, c_hi) and [n_lo, n_hi), the transpose of
// tf_row (under the same faults; FAULT_TF_SKIP_NOISY_Q drops a clean key's
// noisy queries).
struct TfCol {
  int c_lo, c_hi, n_lo, n_hi;
};

__device__ __forceinline__ TfCol tf_col(int k, int L, int B, int fault) {
  if (k < L) {
    const int b = k / B;
    TfCol c = {b * B, L, 0, 0};
    if (fault != FAULT_TF_DROP_CLEAN && fault != FAULT_TF_SKIP_NOISY_Q) {
      c.n_lo = L + (fault == FAULT_TF_LEAK ? b : b + 1) * B;
      c.n_hi = 2 * L;
    }
    return c;
  }
  const int b = (k - L) / B;
  if (fault == FAULT_TF_SHORT && k >= L + (b + 1) * B - 16) return {0, 0, 0, 0};
  return {0, 0, L + b * B, L + (b + 1) * B};
}

// Every pair of query rows [q0, q0 + nq) and keys [k0, k0 + nk) is live (the
// tile needs no per-element mask). Conservative where a query tile straddles
// L: those tiles take the mask.
__device__ __forceinline__ bool tf_full(int q0, int nq, int k0, int nk, int L, int B,
                                        int fault) {
  const int q1 = q0 + nq - 1;
  if (q1 < L) return k0 + nk <= tf_row(q0, L, B, fault).a_hi;  // the first row's end is least
  if (q0 < L) return false;
  const TfRow f = tf_row(q0, L, B, fault), l = tf_row(q1, L, B, fault);
  return k0 + nk <= f.a_hi || (k0 >= l.b_lo && k0 + nk <= f.b_hi);
}

// The tiles of `bn` rows a block walks: n1 of them from row begin1, then the
// rest from row begin2.
struct Tiles {
  int begin1, n1, begin2, n;
  __device__ __forceinline__ int row(int it, int bn) const {
    return it < n1 ? begin1 + it * bn : begin2 + (it - n1) * bn;
  }
};

// The tiles that cover rows [lo1, hi1) and then [lo2, hi2) (lo2 >= hi1), each
// range from a tile-aligned start; a tile of the second range that the first
// already holds is not walked twice. An empty range is lo >= hi.
__device__ __forceinline__ Tiles two_ranges(int lo1, int hi1, int lo2, int hi2, int bn) {
  Tiles t;
  t.begin1 = (max(lo1, 0) / bn) * bn;
  t.n1 = hi1 > t.begin1 ? (hi1 - t.begin1 + bn - 1) / bn : 0;
  t.begin2 = (max(lo2, 0) / bn) * bn;
  if (t.n1 > 0) t.begin2 = max(t.begin2, t.begin1 + t.n1 * bn);
  t.n = t.n1 + (hi2 > lo2 && hi2 > t.begin2 ? (hi2 - t.begin2 + bn - 1) / bn : 0);
  return t;
}

// The key tiles of the query rows [q_first, q_last]: the clean keys up to the
// largest end among the rows, then the noisy keys from the first noisy row's
// block to the last one's.
__device__ __forceinline__ Tiles tf_key_tiles(int q_first, int q_last, int L, int B, int fault,
                                              int bn) {
  int e1 = 0, s2 = 0, e2 = 0;
  if (q_first < L) e1 = tf_row(min(q_last, L - 1), L, B, fault).a_hi;
  if (q_last >= L) {
    const TfRow f = tf_row(max(q_first, L), L, B, fault), l = tf_row(q_last, L, B, fault);
    e1 = max(e1, l.a_hi);
    s2 = f.b_lo;
    e2 = l.b_hi;
  }
  return two_ranges(0, e1, s2, e2, bn);
}

// The query tiles that see the keys [k_first, k_last]: the first clean key's
// queries (its block is seen by the most), then the noisy queries of the noisy
// keys' own blocks.
__device__ __forceinline__ Tiles tf_query_tiles(int k_first, int k_last, int L, int B,
                                                int fault, int bn) {
  int s1 = 0, e1 = 0, s2 = 2 * L, e2 = 0;
  if (k_first < L) {
    const TfCol c = tf_col(k_first, L, B, fault);
    s1 = c.c_lo;
    e1 = c.c_hi;
    if (c.n_hi > c.n_lo) s2 = c.n_lo, e2 = c.n_hi;
  }
  if (k_last >= L) {
    s2 = min(s2, L + ((max(k_first, L) - L) / B) * B);
    e2 = max(e2, L + ((k_last - L) / B + 1) * B);
  }
  return two_ranges(s1, e1, s2, e2, bn);
}

}  // namespace rtv_mask
