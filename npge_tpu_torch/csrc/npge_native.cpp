// mirrors native/npge_native.cpp
// npge_native — C++ host-runtime kernels for the TPU-native pangenome engine.
//
// The reference (NPGe) is an all-C++ program; its TPU-native successor keeps
// the *compute* path in JAX/XLA/Pallas and reimplements the host-side hot
// paths natively here (SURVEY.md §2.6): FASTA ingest + base encoding
// (Sequence readers ⚠[B]), the occupancy/interval primitives backing
// Rest/OverlapsResolver ⚠[B], overlap resolution and short global
// alignments.
//
// C ABI only (consumed via ctypes — no pybind11 in this image). All buffers
// are caller-allocated numpy arrays; functions return element counts or
// negative error codes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// base codes: A=0 C=1 G=2 T=3 N=4 (matches npge_tpu.util.codes)
struct CodeTable {
    unsigned char t[256];
    CodeTable() {
        std::memset(t, 4, sizeof(t));
        t[(unsigned char)'A'] = 0; t[(unsigned char)'a'] = 0;
        t[(unsigned char)'C'] = 1; t[(unsigned char)'c'] = 1;
        t[(unsigned char)'G'] = 2; t[(unsigned char)'g'] = 2;
        t[(unsigned char)'T'] = 3; t[(unsigned char)'t'] = 3;
        t[(unsigned char)'-'] = 5;
    }
};
const CodeTable kCodes;

}  // namespace

extern "C" {

// One-pass FASTA parser.
//   data/n:        raw file bytes
//   codes_out:     caller buffer (>= n bytes); sequence codes, concatenated
//   seq_offsets:   [max_seqs+1]; seq_offsets[i]..seq_offsets[i+1] in codes_out
//   hdr_starts/hdr_ends: [max_seqs]; byte ranges of each header's first word
// Returns number of sequences parsed, or -1 if max_seqs exceeded.
int64_t npge_fasta_encode(const char* data, int64_t n,
                          unsigned char* codes_out, int64_t* seq_offsets,
                          int64_t* hdr_starts, int64_t* hdr_ends,
                          int64_t max_seqs) {
    int64_t nseq = 0;
    int64_t w = 0;
    int64_t i = 0;
    bool in_seq = false;
    seq_offsets[0] = 0;
    while (i < n) {
        if (data[i] == '>') {
            if (nseq >= max_seqs) return -1;
            if (in_seq) seq_offsets[nseq] = w;
            ++i;
            int64_t hs = i;
            while (i < n && data[i] != '\n' && data[i] != ' ' &&
                   data[i] != '\t' && data[i] != '\r')
                ++i;
            hdr_starts[nseq] = hs;
            hdr_ends[nseq] = i;
            while (i < n && data[i] != '\n') ++i;  // rest of header line
            ++nseq;
            in_seq = true;
        } else {
            char c = data[i];
            if (c != '\n' && c != '\r' && c != ' ' && c != '\t') {
                codes_out[w++] = kCodes.t[(unsigned char)c];
            }
            ++i;
        }
        if (in_seq) seq_offsets[nseq] = w;
    }
    return nseq;
}

// Occupancy: set occ[start[k] .. start[k]+len[k]) for every interval.
void npge_mark_intervals(unsigned char* occ, int64_t occ_len,
                         const int32_t* start, const int32_t* len,
                         int64_t n_intervals) {
    for (int64_t k = 0; k < n_intervals; ++k) {
        int64_t a = start[k];
        int64_t b = a + len[k];
        if (a < 0) a = 0;
        if (b > occ_len) b = occ_len;
        for (int64_t i = a; i < b; ++i) occ[i] = 1;
    }
}

// Maximal zero-runs of occ -> (starts, ends). Returns count (<= max_runs)
// or -1 on overflow.
int64_t npge_uncovered_runs(const unsigned char* occ, int64_t n,
                            int32_t* starts, int32_t* ends,
                            int64_t max_runs) {
    int64_t cnt = 0;
    int64_t i = 0;
    while (i < n) {
        if (!occ[i]) {
            int64_t j = i;
            while (j < n && !occ[j]) ++j;
            if (cnt >= max_runs) return -1;
            starts[cnt] = (int32_t)i;
            ends[cnt] = (int32_t)j;
            ++cnt;
            i = j;
        } else {
            ++i;
        }
    }
    return cnt;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Greedy overlap resolution — the host hot loop of the pipeline
// (algo/overlaps.py resolve_overlaps). One call admits every eligible
// candidate, in the global admission order, against one occupancy buffer,
// with the exact semantics of the reference's
// npge_tpu/algo/overlaps.py:_admit_python (tested against it).
// Admission slices each candidate to its free column runs, re-checks the
// good-block predicate (identity as exact integer rational; identical
// first/last min_end columns), extracts the longest good slice when a run
// fails, and marks occupancy.
//
// A candidate takes one of two paths, by what it holds:
//   - gapless, every fragment inside its sequence: the streaming path,
//     which reads codes and occupancy straight from the arena;
//   - gapped (an alignment matrix of codes, GAP = 5) or wrapping (a
//     fragment past the end of a circular sequence): the general path.
//     A row's sequence positions come from a running count of its non-gap
//     cells, taken modulo the sequence length; a piece drops the rows with
//     no base in its columns, as Block.slice does.

namespace {

constexpr unsigned char kGap = 5;

struct GoodSliceResult { int64_t c0, c1; bool ok; };

// Longest [c0,c1) window of good_col with: all-good m-prefix and m-suffix,
// length >= min_len, and sum(den*good - num) >= 0. Mirrors
// algo/filter.best_good_slice (ties -> leftmost).
GoodSliceResult best_good_slice(const unsigned char* good, int64_t n,
                                int64_t m, int64_t min_len,
                                int64_t num, int64_t den) {
    if (m < 1) m = 1;
    if (min_len < m) min_len = m;
    if (n < min_len) return {0, 0, false};
    // wall[i] = good[i..i+m-1] all true, i in [0, n-m]
    int64_t nw = n - m + 1;
    // allocate per call (n small); simple heap buffers
    int64_t* P = new int64_t[n + 1];
    P[0] = 0;
    for (int64_t i = 0; i < n; ++i) P[i + 1] = P[i] + (den * (good[i] ? 1 : 0) - num);
    // prefix count of good for window-all test
    int64_t* G = new int64_t[n + 1];
    G[0] = 0;
    for (int64_t i = 0; i < n; ++i) G[i + 1] = G[i] + (good[i] ? 1 : 0);
    // start candidates l (wall true), with prefix running-min of P[l]
    int64_t* starts = new int64_t[nw];
    int64_t* prefmin = new int64_t[nw];
    int64_t ns = 0;
    for (int64_t l = 0; l < nw; ++l) {
        if (G[l + m] - G[l] == m) {
            starts[ns] = l;
            prefmin[ns] = ns ? (P[l] < prefmin[ns - 1] ? P[l] : prefmin[ns - 1]) : P[l];
            ++ns;
        }
    }
    GoodSliceResult best{0, 0, false};
    int64_t best_len = 0;
    if (ns) {
        for (int64_t e = 0; e < nw; ++e) {
            if (G[e + m] - G[e] != m) continue;
            int64_t r = e + m - 1;  // inclusive end
            int64_t max_l = r - min_len + 1;
            if (max_l < starts[0]) continue;
            // hi = count of starts <= max_l (binary search)
            int64_t lo = 0, hi = ns;
            while (lo < hi) { int64_t mid = (lo + hi) / 2; if (starts[mid] <= max_l) lo = mid + 1; else hi = mid; }
            int64_t cnt = lo;
            if (!cnt) continue;
            int64_t target = P[r + 1];
            // first j in [0, cnt) with prefmin[j] <= target (prefmin non-increasing)
            lo = 0; hi = cnt;
            while (lo < hi) { int64_t mid = (lo + hi) / 2; if (prefmin[mid] <= target) hi = mid; else lo = mid + 1; }
            if (lo >= cnt) continue;
            int64_t l = starts[lo];
            int64_t length = r - l + 1;
            if (length > best_len) { best_len = length; best = {l, r + 1, true}; }
        }
    }
    delete[] P; delete[] G; delete[] starts; delete[] prefmin;
    return best;
}

// model/stats.is_good_block's end test on the n columns of good:
// good[:m].all() and good[-m:].all() with m = min(min_end, n), read by
// Python's slice rules (m == 0 makes the second slice the whole array)
bool ends_good(const unsigned char* good, int64_t n, int64_t min_end) {
    int64_t m = min_end < n ? min_end : n;
    int64_t h1 = m >= 0 ? m : (n + m > 0 ? n + m : 0);
    int64_t t0 = m > 0 ? n - m : (m == 0 ? 0 : (-m < n ? -m : n));
    for (int64_t i = 0; i < h1; ++i) if (!good[i]) return false;
    for (int64_t i = t0; i < n; ++i) if (!good[i]) return false;
    return true;
}

// occ[st, st+ln) of one sequence of length L, wrapping past its end as
// model/fragments.frag_spans splits a wrap fragment
void mark_span(unsigned char* oc, int64_t L, int64_t st, int64_t ln) {
    int64_t end = st + ln;
    if (end <= L) {
        if (ln > 0 && st >= 0) memset(oc + st, 1, (size_t)ln);
        return;
    }
    if (st < L) memset(oc + st, 1, (size_t)(L - st));
    memset(oc, 1, (size_t)(end - L < L ? end - L : L));
}

struct Span { int64_t seq, a0, a1; };

// The admitted pieces: fragment rows in CSR by piece (each with its row in
// the source candidate), and for each piece its source candidate, its
// columns [c0, c1) and whether it is the candidate admitted as it is.
struct Pieces {
    int64_t* offsets;
    int32_t *seq, *start, *len, *ori, *row;
    int64_t *src, *c0, *c1;
    unsigned char* whole;
    int64_t max_blocks, max_frags;
    int64_t nb = 0, nf = 0;

    bool room(int64_t F) const { return nb < max_blocks && nf + F <= max_frags; }
    void frag(int64_t s, int64_t st, int64_t ln, int64_t o, int64_t r) {
        seq[nf] = (int32_t)s; start[nf] = (int32_t)st; len[nf] = (int32_t)ln;
        ori[nf] = (int32_t)o; row[nf] = (int32_t)r;
        ++nf;
    }
    void close(int64_t ci, int64_t a0, int64_t a1, bool w) {
        src[nb] = ci; c0[nb] = a0; c1[nb] = a1; whole[nb] = w ? 1 : 0;
        ++nb;
        offsets[nb] = nf;
    }
};

// scratch reused across candidates
struct Scratch {
    std::vector<unsigned char> freec, goodc, mnc, mxc, rows, keep;
    std::vector<int32_t> cum;
    std::vector<Span> spans;

    void cols(int64_t n) {
        if ((int64_t)freec.size() < n) {
            freec.resize(2 * n); goodc.resize(2 * n);
            mnc.resize(2 * n); mxc.resize(2 * n);
        }
    }
};

// A gapless candidate whose fragments lie inside their sequences. Returns
// false on output overflow. Both admit_* stay out of line: inlined into
// the dispatch loop, this one's streaming loops ran about 1.5x slower.
__attribute__((noinline)) bool admit_gapless(
    const unsigned char* codes, const int64_t* seq_offsets, unsigned char* occ,
    const int64_t* f_seq, const int64_t* f_start, const int64_t* f_len,
    const int64_t* f_ori, int64_t ci, int64_t fa, int64_t fb, int64_t n_cols,
    int64_t min_length, int64_t min_end, int64_t ident_num, int64_t ident_den,
    Scratch& sc, Pieces& out) {
    int64_t F = fb - fa;
    // self-overlap check (O(F^2); F is small)
    for (int64_t i = fa; i < fb; ++i)
        for (int64_t j = i + 1; j < fb; ++j)
            if (f_seq[i] == f_seq[j]) {
                int64_t a1 = f_start[i], b1 = a1 + f_len[i];
                int64_t a2 = f_start[j], b2 = a2 + f_len[j];
                if (a1 < b2 && a2 < b1) return true;
            }
    sc.cols(n_cols);
    unsigned char* freec = sc.freec.data();
    unsigned char* goodc = sc.goodc.data();
    unsigned char* mnc = sc.mnc.data();
    unsigned char* mxc = sc.mxc.data();
    // free mask + per-column identity, accumulated FRAGMENT-major:
    // each fragment's span is read with unit stride (streaming,
    // prefetch-friendly) instead of hopping across F distant genome
    // regions per column — the column-major form was the resolve
    // stage's dominant cost at 17 Mbp (cache miss per access)
    memset(freec, 1, (size_t)n_cols);
    memset(mnc, 255, (size_t)n_cols);
    memset(mxc, 0, (size_t)n_cols);
    for (int64_t i = fa; i < fb; ++i) {
        const unsigned char* cd = codes + seq_offsets[f_seq[i]];
        const unsigned char* oc = occ + seq_offsets[f_seq[i]];
        int64_t st = f_start[i];
        if (f_ori[i] == 1) {
            for (int64_t c = 0; c < n_cols; ++c) {
                unsigned char ch = cd[st + c];
                freec[c] &= (unsigned char)(oc[st + c] == 0);
                if (ch < mnc[c]) mnc[c] = ch;
                if (ch > mxc[c]) mxc[c] = ch;
            }
        } else {
            int64_t last = st + f_len[i] - 1;
            for (int64_t c = 0; c < n_cols; ++c) {
                unsigned char ch = cd[last - c];
                freec[c] &= (unsigned char)(oc[last - c] == 0);
                if (ch < 4) ch = (unsigned char)(3 - ch);
                if (ch < mnc[c]) mnc[c] = ch;
                if (ch > mxc[c]) mxc[c] = ch;
            }
        }
    }
    for (int64_t c = 0; c < n_cols; ++c)
        goodc[c] = (mnc[c] == mxc[c] && mxc[c] < 4) ? 1 : 0;
    // maximal free runs
    int64_t c = 0;
    while (c < n_cols) {
        if (!freec[c]) { ++c; continue; }
        int64_t r0 = c;
        while (c < n_cols && freec[c]) ++c;
        int64_t r1 = c;
        if (r1 - r0 < min_length) continue;
        // goodness of the whole run
        int64_t gsum = 0;
        for (int64_t x = r0; x < r1; ++x) gsum += goodc[x];
        int64_t L = r1 - r0;
        int64_t m = min_end < L ? min_end : L;
        bool ends_ok = true;  // m<=0: no ends requirement
        for (int64_t x = 0; x < m; ++x)
            if (!goodc[r0 + x] || !goodc[r1 - 1 - x]) { ends_ok = false; break; }
        int64_t a0 = r0, a1 = r1;
        bool ok = ends_ok && gsum * ident_den >= ident_num * L;
        if (!ok) {
            GoodSliceResult gs = best_good_slice(
                goodc + r0, L, min_end, min_length, ident_num, ident_den);
            if (!gs.ok) continue;
            a0 = r0 + gs.c0;
            a1 = r0 + gs.c1;
        }
        // accept slice [a0, a1)
        if (!out.room(F)) return false;
        for (int64_t i = fa; i < fb; ++i) {
            int64_t st, ln = a1 - a0;
            if (f_ori[i] == 1) st = f_start[i] + a0;
            else st = f_start[i] + f_len[i] - a1;
            out.frag(f_seq[i], st, ln, f_ori[i], i - fa);
            memset(occ + seq_offsets[f_seq[i]] + st, 1, (size_t)ln);
        }
        out.close(ci, a0, a1, a0 == 0 && a1 == n_cols);
    }
    return true;
}

// A gapped or wrapping candidate (aln: its [F, n] codes, or null for a
// gapless one). Returns false on output overflow.
__attribute__((noinline)) bool admit_general(
    const unsigned char* codes, const int64_t* seq_offsets, unsigned char* occ,
    const int64_t* f_seq, const int64_t* f_start, const int64_t* f_len,
    const int64_t* f_ori, const unsigned char* aln, int64_t ci, int64_t fa,
    int64_t fb, int64_t n,
    int64_t min_length, int64_t min_end, int64_t ident_num, int64_t ident_den,
    Scratch& sc, Pieces& out) {
    int64_t F = fb - fa;
    auto seq_len = [&](int64_t i) {
        return seq_offsets[f_seq[i] + 1] - seq_offsets[f_seq[i]];
    };
    // reject a candidate whose own fragments overlap, wrap spans included:
    // the (seq, a0, a1) spans in order, each against the next
    sc.spans.clear();
    for (int64_t i = fa; i < fb; ++i) {
        int64_t L = seq_len(i), st = f_start[i], end = st + f_len[i];
        if (end <= L) {
            sc.spans.push_back({f_seq[i], st, end});
        } else {
            sc.spans.push_back({f_seq[i], st, L});
            sc.spans.push_back({f_seq[i], 0, end - L});
        }
    }
    std::sort(sc.spans.begin(), sc.spans.end(), [](const Span& x, const Span& y) {
        if (x.seq != y.seq) return x.seq < y.seq;
        if (x.a0 != y.a0) return x.a0 < y.a0;
        return x.a1 < y.a1;
    });
    for (size_t k = 0; k + 1 < sc.spans.size(); ++k)
        if (sc.spans[k].seq == sc.spans[k + 1].seq &&
            sc.spans[k + 1].a0 < sc.spans[k].a1)
            return true;
    const int64_t w = n + 1;
    sc.cols(n);
    if ((int64_t)sc.cum.size() < F * w) sc.cum.resize(2 * F * w);
    if ((int64_t)sc.keep.size() < F) sc.keep.resize(2 * F);
    unsigned char* freec = sc.freec.data();
    unsigned char* goodc = sc.goodc.data();
    unsigned char* mnc = sc.mnc.data();
    unsigned char* mxc = sc.mxc.data();
    unsigned char* keep = sc.keep.data();
    int32_t* cum = sc.cum.data();
    if (!aln) {
        // a gapless wrapping candidate: its rows are its fragments' texts
        if ((int64_t)sc.rows.size() < F * n) sc.rows.resize(2 * F * n);
        unsigned char* rows = sc.rows.data();
        for (int64_t r = 0; r < F; ++r) {
            int64_t i = fa + r, L = seq_len(i), st = f_start[i];
            const unsigned char* cd = codes + seq_offsets[f_seq[i]];
            for (int64_t c = 0; c < n; ++c) {
                int64_t p = (f_ori[i] == 1 ? st + c : st + f_len[i] - 1 - c) % L;
                if (p < 0) p += L;
                unsigned char ch = cd[p];
                if (f_ori[i] != 1 && ch < 4) ch = (unsigned char)(3 - ch);
                rows[r * n + c] = ch;
            }
        }
        aln = rows;
    }
    // free mask, and each row's count of non-gap cells before each column
    memset(freec, 1, (size_t)n);
    for (int64_t r = 0; r < F; ++r) {
        int64_t i = fa + r, L = seq_len(i), st = f_start[i];
        const unsigned char* oc = occ + seq_offsets[f_seq[i]];
        const unsigned char* row = aln + r * n;
        int32_t* cr = cum + r * w;
        int64_t k = 0;
        cr[0] = 0;
        for (int64_t c = 0; c < n; ++c) {
            if (row[c] != kGap) {
                int64_t p = (f_ori[i] == 1 ? st + k : st + f_len[i] - 1 - k) % L;
                if (p < 0) p += L;
                if (oc[p]) freec[c] = 0;
                ++k;
            }
            cr[c + 1] = (int32_t)k;
        }
    }
    int64_t c = 0;
    while (c < n) {
        if (!freec[c]) { ++c; continue; }
        int64_t r0 = c;
        while (c < n && freec[c]) ++c;
        int64_t r1 = c;
        if (r1 - r0 < min_length) continue;
        // the piece's rows: all of them for the whole candidate, else those
        // with a base in the run (a run with none makes no block)
        bool whole = r0 == 0 && r1 == n;
        int64_t S = 0;
        for (int64_t r = 0; r < F; ++r) {
            keep[r] = whole || cum[r * w + r1] > cum[r * w + r0];
            S += keep[r];
        }
        if (!S) continue;
        int64_t a0 = r0, a1 = r1;
        bool ok = true;  // a piece of one row is exempt
        if (S >= 2) {
            int64_t L = r1 - r0;
            memset(mnc + r0, 255, (size_t)L);
            memset(mxc + r0, 0, (size_t)L);
            for (int64_t r = 0; r < F; ++r) {
                if (!keep[r]) continue;
                const unsigned char* row = aln + r * n;
                for (int64_t x = r0; x < r1; ++x) {
                    unsigned char ch = row[x];
                    if (ch < mnc[x]) mnc[x] = ch;
                    if (ch > mxc[x]) mxc[x] = ch;
                }
            }
            // identical and gapless: every row holds the same real base
            int64_t gsum = 0;
            for (int64_t x = r0; x < r1; ++x) {
                goodc[x] = (mnc[x] == mxc[x] && mxc[x] < 4) ? 1 : 0;
                gsum += goodc[x];
            }
            ok = ends_good(goodc + r0, L, min_end) &&
                 gsum * ident_den >= ident_num * L;
            if (!ok) {
                GoodSliceResult gs = best_good_slice(
                    goodc + r0, L, min_end, min_length, ident_num, ident_den);
                if (!gs.ok) continue;
                // a good column has a base in every kept row, so the
                // slice keeps them all
                a0 = r0 + gs.c0;
                a1 = r0 + gs.c1;
            }
        }
        if (!out.room(S)) return false;
        bool as_is = whole && ok;
        for (int64_t r = 0; r < F; ++r) {
            if (!keep[r]) continue;
            int64_t i = fa + r, L = seq_len(i);
            int64_t st = f_start[i], ln = f_len[i];
            if (!as_is) {
                int64_t t0 = cum[r * w + a0], t1 = cum[r * w + a1];
                st = f_ori[i] == 1 ? st + t0 : st + ln - t1;
                ln = t1 - t0;
            }
            if (st >= L) st -= L;  // blocks.normalize_wrap_starts
            out.frag(f_seq[i], st, ln, f_ori[i], r);
            mark_span(occ + seq_offsets[f_seq[i]], L, st, ln);
        }
        out.close(ci, a0, a1, as_is);
    }
    return true;
}

}  // namespace

extern "C" {

// Admits candidates order[0..n_cand) in that order. Candidate ci has the
// fragments [cand_offsets[ci], cand_offsets[ci+1]), n_cols[ci] columns and,
// where aln_ptrs[ci] is not 0, the address of its C-contiguous uint8
// alignment [F, n_cols]. Writes the admitted pieces (see Pieces) and
// returns their number, or -1 where the outputs would overflow.
int64_t npge_resolve_overlaps(
    const unsigned char* codes, const int64_t* seq_offsets,
    unsigned char* occ,  // [total_len] concatenated per-seq occupancy
    const int64_t* cand_offsets, const int64_t* f_seq, const int64_t* f_start,
    const int64_t* f_len, const int64_t* f_ori, const int64_t* n_cols,
    const uint64_t* aln_ptrs, const int64_t* order, int64_t n_cand,
    int64_t min_length, int64_t min_end, int64_t ident_num, int64_t ident_den,
    int64_t* out_offsets, int32_t* o_seq, int32_t* o_start, int32_t* o_len,
    int32_t* o_ori, int32_t* o_row, int64_t* o_src, int64_t* o_c0,
    int64_t* o_c1, unsigned char* o_whole,
    int64_t max_out_blocks, int64_t max_out_frags) {
    Pieces out{out_offsets, o_seq, o_start, o_len, o_ori, o_row,
               o_src, o_c0, o_c1, o_whole, max_out_blocks, max_out_frags};
    out_offsets[0] = 0;
    Scratch sc;
    for (int64_t oi = 0; oi < n_cand; ++oi) {
        int64_t ci = order[oi];
        int64_t fa = cand_offsets[ci], fb = cand_offsets[ci + 1];
        int64_t n = n_cols[ci];
        if (fb - fa < 2 || n < min_length) continue;
        const unsigned char* aln = reinterpret_cast<const unsigned char*>(
            static_cast<uintptr_t>(aln_ptrs[ci]));
        bool inside = true;
        for (int64_t i = fa; i < fb && inside; ++i)
            inside = f_start[i] + f_len[i] <=
                     seq_offsets[f_seq[i] + 1] - seq_offsets[f_seq[i]];
        bool fits = (!aln && inside)
            ? admit_gapless(codes, seq_offsets, occ, f_seq, f_start, f_len,
                            f_ori, ci, fa, fb, n, min_length, min_end,
                            ident_num, ident_den, sc, out)
            : admit_general(codes, seq_offsets, occ, f_seq, f_start, f_len,
                            f_ori, aln, ci, fa, fb, n, min_length, min_end,
                            ident_num, ident_den, sc, out);
        if (!fits) return -1;
    }
    return out.nb;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Global Needleman-Wunsch with linear gaps — exact mirror of
// npge_tpu.algo.similar.nw_align (values AND traceback tie-breaks:
// diag > up > left). The Python version pays ~0.2 ms of numpy call
// overhead per (short) gap-patch alignment; the Joiner runs thousands per
// build. out_a/out_b must hold n+m bytes; the alignment is written to the
// FINAL L bytes (returned), exactly as the Python reversed-list build.

extern "C" {

int64_t npge_nw_align(const unsigned char* a, int64_t n,
                      const unsigned char* b, int64_t m,
                      int64_t match, int64_t mismatch, int64_t gap,
                      unsigned char gap_code,
                      unsigned char* out_a, unsigned char* out_b) {
    int64_t w = m + 1;
    int64_t* H = new int64_t[(n + 1) * w];
    for (int64_t j = 0; j <= m; ++j) H[j] = j * gap;
    for (int64_t i = 1; i <= n; ++i) {
        int64_t* cur = H + i * w;
        const int64_t* prev = cur - w;
        cur[0] = i * gap;
        unsigned char ai = a[i - 1];
        for (int64_t j = 1; j <= m; ++j) {
            int64_t best = prev[j - 1] + (b[j - 1] == ai ? match : mismatch);
            int64_t up = prev[j] + gap;
            if (up > best) best = up;
            int64_t left = cur[j - 1] + gap;
            if (left > best) best = left;
            cur[j] = best;
        }
    }
    int64_t i = n, j = m, p = n + m;
    while (i > 0 || j > 0) {
        int64_t cur = H[i * w + j];
        if (i > 0 && j > 0 &&
            cur == H[(i - 1) * w + (j - 1)] +
                       (a[i - 1] == b[j - 1] ? match : mismatch)) {
            --p;
            out_a[p] = a[--i];
            out_b[p] = b[--j];
        } else if (i > 0 && cur == H[(i - 1) * w + j] + gap) {
            --p;
            out_a[p] = a[--i];
            out_b[p] = gap_code;
        } else {
            --p;
            out_a[p] = gap_code;
            out_b[p] = b[--j];
        }
    }
    delete[] H;
    return n + m - p;
}

}  // extern "C"
