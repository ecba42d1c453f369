// Exact fp64 cosine scorer for candidate pairs of ELL-encoded TF-IDF rows.
//
// Native host-side counterpart of the reference's sparse_dot_topn C++ kernel
// (reference string_grouper/string_grouper.py:12, :725-746): where the
// reference computes the full sparse-sparse product on CPU threads, the TPU
// build does candidate *selection* on the TPU MXU (hashed upper-bound filter,
// ops/matcher.py) and only the surviving (row, col) pairs are scored here --
// a merge-intersection over the two rows' ascending term ids, accumulating
// in ascending-term order exactly like a CSR row-times-row kernel, in
// float64.  OpenMP-parallel over pairs.
//
// Built as a shared library by native/build.py; loaded with ctypes
// (no pybind11 dependency).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

#include <omp.h>

namespace {

// Round-to-nearest-even float32 -> bfloat16 (bit pattern).
inline uint16_t f32_to_bf16(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    uint32_t lsb = (x >> 16) & 1u;
    x += 0x7fffu + lsb;
    return static_cast<uint16_t>(x >> 16);
}

}  // namespace

extern "C" {

// Feature-hashed dense projection of ELL rows (ops/hashing.py semantics:
// Knuth multiplicative hash of the term id into [0, 2^log2_dim), values
// accumulated per bucket in float32, emitted as bfloat16 bit patterns).
// Host-side replacement for the device scatter-add, which is slow for
// corpus-sized row counts; computed once per corpus and transferred.
void hash_project_bf16(
    const int32_t* ids, const float* vals, int64_t n_rows, int64_t width,
    int64_t log2_dim, uint16_t* out)
{
    const int64_t dim = int64_t(1) << log2_dim;
    const uint32_t shift = 32 - static_cast<uint32_t>(log2_dim);
#pragma omp parallel
    {
        std::vector<float> acc(dim);
#pragma omp for schedule(static)
        for (int64_t r = 0; r < n_rows; ++r) {
            std::memset(acc.data(), 0, dim * sizeof(float));
            const int32_t* idr = ids + r * width;
            const float* vr = vals + r * width;
            for (int64_t k = 0; k < width; ++k) {
                int32_t t = idr[k];
                if (t < 0) break;  // padding: ids ascend, -1 tail
                uint32_t b = (static_cast<uint32_t>(t) * 2654435761u) >> shift;
                acc[b] += vr[k];
            }
            uint16_t* o = out + r * dim;
            for (int64_t j = 0; j < dim; ++j) o[j] = f32_to_bf16(acc[j]);
        }
    }
}

// a_ids/b_ids: ELL term-id rows, -1 padded, ascending per row.
// a_vals/b_vals: matching float64 TF-IDF values (0 on padding).
// rows/cols index into the left/right ELL matrices; out receives the exact
// float64 dot product of each pair.
void score_pairs_f64(
    const int32_t* a_ids, const double* a_vals, int64_t a_width,
    const int32_t* b_ids, const double* b_vals, int64_t b_width,
    const int64_t* rows, const int64_t* cols, int64_t n_pairs,
    double* out)
{
#pragma omp parallel for schedule(static)
    for (int64_t p = 0; p < n_pairs; ++p) {
        const int32_t* ai = a_ids + rows[p] * a_width;
        const double*  av = a_vals + rows[p] * a_width;
        const int32_t* bi = b_ids + cols[p] * b_width;
        const double*  bv = b_vals + cols[p] * b_width;
        double acc = 0.0;
        int64_t i = 0, j = 0;
        while (i < a_width && j < b_width) {
            int32_t ta = ai[i], tb = bi[j];
            if (ta < 0 || tb < 0) break;  // padding: row exhausted
            if (ta == tb) {
                acc += av[i] * bv[j];
                ++i; ++j;
            } else if (ta < tb) {
                ++i;
            } else {
                ++j;
            }
        }
        out[p] = acc;
    }
}

// float32-accumulation twin of score_pairs_f64: the reference's
// sp_matmul_topn accumulates in the MATRIX dtype (float for
// tfidf_matrix_dtype=float32; its dense column accumulator receives
// contributions in ascending shared-term order, the same order as this
// merge), so float32 configurations must round at every add.  Values
// arrive as float64 holding exactly-representable float32s; out is their
// exact float64 promotion.
void score_pairs_f32_acc(
    const int32_t* a_ids, const double* a_vals, int64_t a_width,
    const int32_t* b_ids, const double* b_vals, int64_t b_width,
    const int64_t* rows, const int64_t* cols, int64_t n_pairs,
    double* out)
{
#pragma omp parallel for schedule(static)
    for (int64_t p = 0; p < n_pairs; ++p) {
        const int32_t* ai = a_ids + rows[p] * a_width;
        const double*  av = a_vals + rows[p] * a_width;
        const int32_t* bi = b_ids + cols[p] * b_width;
        const double*  bv = b_vals + cols[p] * b_width;
        float acc = 0.0f;
        int64_t i = 0, j = 0;
        while (i < a_width && j < b_width) {
            int32_t ta = ai[i], tb = bi[j];
            if (ta < 0 || tb < 0) break;
            if (ta == tb) {
                acc += float(av[i]) * float(bv[j]);
                ++i; ++j;
            } else if (ta < tb) {
                ++i;
            } else {
                ++j;
            }
        }
        out[p] = double(acc);
    }
}

// Wire-format packing of ELL rows for the phase-1 upload
// (ops/matcher.py pack_hash_inputs semantics): slot = (bucket << 16) | qval
// with bucket the Knuth multiplicative hash of the term id into
// [0, 2^log2_dim) and qval = ceil(value * 65535) clipped to uint16 (upward
// quantization preserves the upper-bound property).  Rows are emitted in
// ``order`` so the two-tier (narrow/wide) upload needs no host-side
// fancy-index reorder of the 100s-of-MB ELL arrays -- numpy's version of
// this pack was the single largest host cost at corpus scale.
void pack_hash_rows(
    const int32_t* ids, const double* vals, int64_t width,
    const int32_t* order, int64_t n_order, int64_t out_width,
    int64_t log2_dim, int32_t* out)
{
    const uint32_t shift = 32 - static_cast<uint32_t>(log2_dim);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_order; ++i) {
        const int64_t r = order[i];
        const int32_t* idr = ids + r * width;
        const double* vr = vals + r * width;
        int32_t* o = out + i * out_width;
        // Clamp reads to the SOURCE width: out_width > width would
        // otherwise read the next row's slots (or past the array).
        const int64_t kw = out_width < width ? out_width : width;
        for (int64_t k = kw; k < out_width; ++k) o[k] = 0;
        for (int64_t k = 0; k < kw; ++k) {
            const int32_t t = idr[k];
            if (t < 0) { o[k] = 0; continue; }
            const uint32_t b = (static_cast<uint32_t>(t) * 2654435761u) >> shift;
            double q = std::ceil(vr[k] * 65535.0);
            if (q > 65535.0) q = 65535.0;
            if (q < 0.0) q = 0.0;
            o[k] = static_cast<int32_t>((b << 16) | static_cast<uint32_t>(q));
        }
    }
}

// Row-wise dot of two equal-length ELL matrices (reference dot(),
// string_grouper.py:433-440).
void row_dot_f64(
    const int32_t* a_ids, const double* a_vals, int64_t a_width,
    const int32_t* b_ids, const double* b_vals, int64_t b_width,
    int64_t n_rows, double* out)
{
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n_rows; ++r) {
        const int32_t* ai = a_ids + r * a_width;
        const double*  av = a_vals + r * a_width;
        const int32_t* bi = b_ids + r * b_width;
        const double*  bv = b_vals + r * b_width;
        double acc = 0.0;
        int64_t i = 0, j = 0;
        while (i < a_width && j < b_width) {
            int32_t ta = ai[i], tb = bi[j];
            if (ta < 0 || tb < 0) break;
            if (ta == tb) { acc += av[i] * bv[j]; ++i; ++j; }
            else if (ta < tb) { ++i; }
            else { ++j; }
        }
        out[r] = acc;
    }
}

// Per-row threshold + top-n selection over scored pairs (ops/matcher.py
// _select_topn semantics): qualify = sim > 0 && sim >= min_sim; within a row
// order by (sim desc, col asc); keep the first max_n; row_cut[r] = sim of the
// max_n-th kept pair or -inf.  Emits *indices into the input arrays* ordered
// (row asc, sim desc, col asc); returns the selected count.  kept_q gets the
// per-row qualified count.  Replaces a 3-key numpy lexsort over every scored
// pair -- rows are short, so per-row std::sort beats a global sort by >10x.
int64_t select_topn_f64(
    const int64_t* rows, const int64_t* cols, const double* sims,
    int64_t n_pairs, int64_t n_left, double min_sim, int64_t max_n,
    int64_t* out_idx, int64_t* kept_q, double* row_cut)
{
    std::vector<int64_t> offs(n_left + 1, 0);
    for (int64_t r = 0; r < n_left; ++r) kept_q[r] = 0;
    for (int64_t p = 0; p < n_pairs; ++p) {
        const double s = sims[p];
        if (s > 0.0 && s >= min_sim) kept_q[rows[p]]++;
    }
    for (int64_t r = 0; r < n_left; ++r) offs[r + 1] = offs[r] + kept_q[r];
    std::vector<int64_t> bucket(offs[n_left]);
    std::vector<int64_t> fill(n_left, 0);
    for (int64_t p = 0; p < n_pairs; ++p) {
        const double s = sims[p];
        if (s > 0.0 && s >= min_sim) {
            const int64_t r = rows[p];
            bucket[offs[r] + fill[r]++] = p;
        }
    }
    std::vector<int64_t> out_offs(n_left + 1, 0);
    for (int64_t r = 0; r < n_left; ++r) {
        const int64_t q = kept_q[r];
        out_offs[r + 1] = out_offs[r] + (q < max_n ? q : max_n);
    }
#pragma omp parallel for schedule(dynamic, 4096)
    for (int64_t r = 0; r < n_left; ++r) {
        int64_t* b = bucket.data() + offs[r];
        const int64_t q = kept_q[r];
        const int64_t keep = q < max_n ? q : max_n;
        auto cmp = [&](int64_t x, int64_t y) {
            if (sims[x] != sims[y]) return sims[x] > sims[y];
            return cols[x] < cols[y];
        };
        if (keep < q) {
            std::partial_sort(b, b + keep, b + q, cmp);
        } else {
            std::sort(b, b + q, cmp);
        }
        row_cut[r] = (keep == max_n && keep > 0)
                         ? sims[b[keep - 1]]
                         : -std::numeric_limits<double>::infinity();
        int64_t* o = out_idx + out_offs[r];
        for (int64_t k = 0; k < keep; ++k) o[k] = b[k];
    }
    return out_offs[n_left];
}

// Connected components over an undirected edge list: union-find with path
// halving, roots ordered by minimum member, so the emitted label of every
// component is its smallest node index -- identical to the device kernel's
// labels (ops/connected_components.py).  ~9M edges resolve in ~0.2 s on one
// core; the TPU label-propagation kernel needs ~14 s at that size because
// scatter-min rounds serialize on the device, so this is the default path
// for host-resident match lists.
void connected_components_i64(
    const int64_t* a, const int64_t* b, int64_t n_edges, int64_t n,
    int64_t* labels)
{
    std::vector<int64_t> parent(n);
    for (int64_t i = 0; i < n; ++i) parent[i] = i;
    auto find = [&](int64_t x) {
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];  // path halving
            x = parent[x];
        }
        return x;
    };
    for (int64_t e = 0; e < n_edges; ++e) {
        const int64_t ra = find(a[e]);
        const int64_t rb = find(b[e]);
        if (ra == rb) continue;
        // Union by minimum root: the surviving root is always the smaller
        // index, so every component's final root is its minimum member.
        if (ra < rb) parent[rb] = ra; else parent[ra] = rb;
    }
    for (int64_t i = 0; i < n; ++i) labels[i] = find(i);
}

// Self-join fix-ups (ops/matcher.py apply_self_join_fixups semantics,
// reference string_grouper.py:419-427,:954-964): drop the diagonal, emit
// each surviving pair in both directions (scores are symmetric bitwise --
// the merge-scorer's accumulation order is direction-invariant), force an
// exact-1.0 diagonal for every row, order (row asc, col asc).  Outputs must
// be sized 2 * n_pairs + n; returns the final count.
int64_t selfjoin_fixups_f64(
    const int64_t* rows, const int64_t* cols, const double* sims,
    int64_t n_pairs, int64_t n,
    int64_t* out_rows, int64_t* out_cols, double* out_sims)
{
    // Parallel counting sort: per-SLICE row histograms, per-(slice, row)
    // exclusive prefix, then each slice scatters its own pair range -- no
    // atomics, deterministic output (the per-row dedupe below sorts by
    // column anyway).  Slices are distributed with `omp for`, so every
    // slice is processed no matter how many threads the runtime actually
    // delivers (OMP_DYNAMIC / thread limits must not drop pairs); the
    // slice count is capped so the histogram block stays bounded on
    // high-core hosts.
    const int64_t T = std::max<int64_t>(
        1, std::min<int64_t>(omp_get_max_threads(), 16));
    const int64_t chunk = (n_pairs + T - 1) / T;
    std::vector<int64_t> lc((size_t)T * n, 0);
#pragma omp parallel for schedule(static, 1)
    for (int64_t t = 0; t < T; ++t) {
        int64_t* h = lc.data() + (size_t)t * n;
        const int64_t lo = t * chunk;
        const int64_t hi = std::min(n_pairs, lo + chunk);
        for (int64_t p = lo; p < hi; ++p) {
            if (rows[p] == cols[p]) continue;
            h[rows[p]]++;
            h[cols[p]]++;
        }
    }
    std::vector<int64_t> cnt(n + 1, 0);
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n; ++r) {
        int64_t s = 1;  // +1: diagonal
        for (int64_t t = 0; t < T; ++t) s += lc[(size_t)t * n + r];
        cnt[r + 1] = s;
    }
    for (int64_t r = 0; r < n; ++r) cnt[r + 1] += cnt[r];
    const int64_t total = cnt[n];
    std::vector<int64_t> bcol(total);
    std::vector<double> bsim(total);
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n; ++r) {  // diagonal first; dedupe keeps it
        bcol[cnt[r]] = r;
        bsim[cnt[r]] = 1.0;
        int64_t run = cnt[r] + 1;
        for (int64_t t = 0; t < T; ++t) {
            const int64_t c = lc[(size_t)t * n + r];
            lc[(size_t)t * n + r] = run;
            run += c;
        }
    }
#pragma omp parallel for schedule(static, 1)
    for (int64_t t = 0; t < T; ++t) {
        int64_t* h = lc.data() + (size_t)t * n;
        const int64_t lo = t * chunk;
        const int64_t hi = std::min(n_pairs, lo + chunk);
        for (int64_t p = lo; p < hi; ++p) {
            const int64_t r = rows[p], c = cols[p];
            if (r == c) continue;
            bcol[h[r]] = c; bsim[h[r]] = sims[p]; h[r]++;
            bcol[h[c]] = r; bsim[h[c]] = sims[p]; h[c]++;
        }
    }
    // Per-row: sort by col (stable on equal cols keeps the diagonal's 1.0
    // first), dedupe adjacent.  Write counts, then compact serially.
    std::vector<int64_t> ucnt(n);
#pragma omp parallel
    {
        std::vector<int64_t> perm;
        std::vector<int64_t> tc;
        std::vector<double> ts;
#pragma omp for schedule(dynamic, 4096)
        for (int64_t r = 0; r < n; ++r) {
            const int64_t beg = cnt[r], end = cnt[r + 1];
            const int64_t m = end - beg;
            perm.resize(m); tc.resize(m); ts.resize(m);
            for (int64_t k = 0; k < m; ++k) perm[k] = k;
            std::stable_sort(perm.begin(), perm.end(), [&](int64_t x, int64_t y) {
                return bcol[beg + x] < bcol[beg + y];
            });
            int64_t u = 0;
            for (int64_t k = 0; k < m; ++k) {
                const int64_t c = bcol[beg + perm[k]];
                if (u && tc[u - 1] == c) continue;  // duplicate direction
                tc[u] = c; ts[u] = bsim[beg + perm[k]]; ++u;
            }
            for (int64_t k = 0; k < u; ++k) {
                bcol[beg + k] = tc[k]; bsim[beg + k] = ts[k];
            }
            ucnt[r] = u;
        }
    }
    std::vector<int64_t> oo(n + 1, 0);
    for (int64_t r = 0; r < n; ++r) oo[r + 1] = oo[r] + ucnt[r];
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n; ++r) {
        const int64_t beg = cnt[r];
        int64_t w = oo[r];
        for (int64_t k = 0; k < ucnt[r]; ++k, ++w) {
            out_rows[w] = r;
            out_cols[w] = bcol[beg + k];
            out_sims[w] = bsim[beg + k];
        }
    }
    return oo[n];
}

// Clean-equality duplicate grouping of the collapse layer, in the canonical
// form of ops/matcher.py _group_positions(_clean_refined_codes(src)), bit
// for bit: rows group by (row_hash, length); every member is byte-verified
// against its group's minimum-position row, and a mismatch (a hash
// collision) becomes a singleton group.  Group ids ascend by first
// occurrence: first_out[g] is group g's minimum position, and its positions,
// ascending, are perm_out[starts_out[g] .. starts_out[g] + counts_out[g]).
// The canonical form depends only on the partition, so the partition may be
// built in any order of work.
//   1. Partition: a parallel scatter of (hash, length, position) keys into
//      buckets by the top bits of the mixed hash (equal hashes share a
//      bucket), then, bucket by bucket in parallel, a sort and a memcmp
//      sweep that writes each row's group representative into codes_out.
//   2. Relabel: one walk over the positions; a row that is its own
//      representative opens the next group id, any other row takes its
//      representative's (a smaller position, already relabeled).
//   3. Positions: exclusive prefix sum of the counts, then a scatter in
//      position order.
// codes_out and perm_out hold n values; first_out, starts_out and
// counts_out need room for n (the group count is returned).
int64_t clean_group_positions(
    const uint8_t* flat, const int64_t* coff, const uint64_t* hashes,
    int64_t n, int64_t* codes_out, int32_t* first_out, int64_t* perm_out,
    int64_t* starts_out, int64_t* counts_out)
{
    if (n <= 0) return 0;
    struct Key { uint64_t h; int64_t len; int64_t idx; };
    int bits = 0;  // ~64 keys a bucket, at most 2^16 buckets
    while (bits < 16 && (int64_t(64) << (bits + 1)) <= n) ++bits;
    const int64_t nb = int64_t(1) << bits;
    auto bucket_of = [bits](uint64_t h) -> int64_t {
        return bits ? int64_t((h * 0x9E3779B97F4A7C15ull) >> (64 - bits)) : 0;
    };
    std::vector<Key> keys(n);
    std::vector<int64_t> bstart(nb + 1);
    std::vector<int64_t> hist;
#pragma omp parallel
    {
        const int team = omp_get_num_threads();
        const int t = omp_get_thread_num();
#pragma omp single
        hist.assign(size_t(team) * nb, 0);
        const int64_t lo = n * t / team, hi = n * (t + 1) / team;
        int64_t* mine = hist.data() + size_t(t) * nb;
        for (int64_t i = lo; i < hi; ++i) ++mine[bucket_of(hashes[i])];
#pragma omp barrier
#pragma omp single
        {
            int64_t s = 0;
            for (int64_t b = 0; b < nb; ++b) {
                bstart[b] = s;
                for (int tt = 0; tt < team; ++tt) {
                    const int64_t c = hist[size_t(tt) * nb + b];
                    hist[size_t(tt) * nb + b] = s;
                    s += c;
                }
            }
            bstart[nb] = s;
        }
        for (int64_t i = lo; i < hi; ++i) {
            keys[mine[bucket_of(hashes[i])]++] =
                Key{hashes[i], coff[i + 1] - coff[i], i};
        }
#pragma omp barrier
#pragma omp for schedule(dynamic, 16)
        for (int64_t b = 0; b < nb; ++b) {
            Key* kb = keys.data() + bstart[b];
            Key* ke = keys.data() + bstart[b + 1];
            std::sort(kb, ke, [](const Key& x, const Key& y) {
                if (x.h != y.h) return x.h < y.h;
                if (x.len != y.len) return x.len < y.len;
                return x.idx < y.idx;
            });
            int64_t rep = -1;
            for (Key* k = kb; k < ke; ++k) {
                if (k == kb || k->h != k[-1].h || k->len != k[-1].len) {
                    rep = k->idx;
                    codes_out[k->idx] = rep;
                } else if (k->len == 0 ||
                           std::memcmp(flat + coff[k->idx], flat + coff[rep],
                                       size_t(k->len)) == 0) {
                    codes_out[k->idx] = rep;
                } else {
                    codes_out[k->idx] = k->idx;  // a collision: a singleton
                }
            }
        }
    }
    int64_t u = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t rep = codes_out[i];
        if (rep == i) {
            first_out[u] = int32_t(i);
            counts_out[u] = 1;
            codes_out[i] = u++;
        } else {
            const int64_t g = codes_out[rep];
            codes_out[i] = g;
            ++counts_out[g];
        }
    }
    int64_t s = 0;
    for (int64_t g = 0; g < u; ++g) {
        starts_out[g] = s;
        s += counts_out[g];
    }
    std::vector<int64_t> cur(starts_out, starts_out + u);
    for (int64_t i = 0; i < n; ++i) perm_out[cur[codes_out[i]]++] = i;
    return u;
}

// Thread-count plumbing for the reference's ``number_of_processes`` knob
// (reference string_grouper.py:22, :731 routes it to sp_matmul_topn's
// n_threads): every OpenMP-parallel kernel in this library honors the
// current omp thread limit set here.
void set_num_threads(int64_t n) {
    if (n > 0) omp_set_num_threads(static_cast<int>(n));
}

int64_t get_max_threads() { return omp_get_max_threads(); }

}  // extern "C"

// ===========================================================================
// Native TF-IDF encoder: the ASCII + char-class-regex + ngram<=3 fast path of
// corpus/tfidf.py (sklearn TfidfVectorizer semantics, reference
// string_grouper.py:305-308,:685-707).  The numpy implementation remains the
// general path and the bitwise oracle (tests/test_native_encode.py).
//
// Design: cleaned bytes pack each n-gram window into a <=24-bit key, so the
// vocabulary builds by direct-address presence table -- no sorts, no hash
// maps.  Per-row unique(term)+tf by local insertion (rows are short).  All
// scratch lives in grow-only process buffers: repeated fits touch no new
// pages, which matters on this VM where first-touch faults can run at
// 5-40 MB/s (docs/performance.md).
//
// Call sequence (caller holds the GIL throughout, so no locking):
//   encode_fit_phase1 / encode_transform_phase1  -> [vocab, width, nnz]
//   encode_get_vocab_df (fit only)
//   encode_phase2(idf)                            -> ELL ids/vals64
// ===========================================================================

#include <atomic>

namespace {

struct EncState {
    std::vector<uint8_t>  clean;   // cleaned bytes, rows concatenated
    std::vector<int64_t>  coff;    // cleaned row offsets (n_rows + 1)
    std::vector<int32_t>  table;   // key -> vocab id (1 << (8 * ngram))
    std::vector<int32_t>  wid;     // per-row unique vocab ids (at coff[r])
    std::vector<int32_t>  wtf;     // matching tf counts
    std::vector<int32_t>  ucnt;    // per-row unique count
    std::vector<uint32_t> vocab;   // vocab keys, ascending
    std::vector<int32_t>  df;      // per-term document frequency (fit)
    int64_t n_rows = 0;
};

EncState g_enc;

// Clean raw bytes through keep/map LUTs into g_enc.clean/coff.
void clean_rows(const uint8_t* raw, const int64_t* roff, int64_t n_rows,
                const uint8_t* keep_lut, const uint8_t* map_lut)
{
    EncState& S = g_enc;
    S.n_rows = n_rows;
    S.coff.resize(n_rows + 1);
    S.coff[0] = 0;
    std::vector<int64_t> kept(n_rows);
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n_rows; ++r) {
        int64_t c = 0;
        for (int64_t i = roff[r]; i < roff[r + 1]; ++i) c += keep_lut[raw[i]];
        kept[r] = c;
    }
    for (int64_t r = 0; r < n_rows; ++r) S.coff[r + 1] = S.coff[r] + kept[r];
    S.clean.resize(S.coff[n_rows]);
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n_rows; ++r) {
        uint8_t* o = S.clean.data() + S.coff[r];
        for (int64_t i = roff[r]; i < roff[r + 1]; ++i) {
            uint8_t b = raw[i];
            if (keep_lut[b]) *o++ = map_lut[b];
        }
    }
}

// Shared phase-1 body after the vocab table is in place: per-row unique+tf
// into the workspace; optional df accumulation.  Returns (max_width, nnz).
// Unknown keys (table[key] < 0) are dropped -- transform's out-of-vocabulary
// semantics; in fit mode every key is present by construction.
std::pair<int64_t, int64_t> rows_unique_tf(int64_t ngram, bool count_df)
{
    EncState& S = g_enc;
    const int64_t n_rows = S.n_rows;
    S.wid.resize(S.clean.size() ? S.clean.size() : 1);
    S.wtf.resize(S.wid.size());
    S.ucnt.assign(n_rows, 0);
    std::atomic<int32_t>* df =
        count_df ? reinterpret_cast<std::atomic<int32_t>*>(S.df.data())
                 : nullptr;
    int64_t max_w = 0, nnz = 0;
#pragma omp parallel reduction(max : max_w) reduction(+ : nnz)
    {
        // Local (id, tf) insertion buffers; rows are guarded to <= 4096
        // chars by the Python caller, so windows fit.
        std::vector<int32_t> lid(4096), ltf(4096);
#pragma omp for schedule(dynamic, 1024)
        for (int64_t r = 0; r < n_rows; ++r) {
            const int64_t beg = S.coff[r], end = S.coff[r + 1];
            const int64_t nwin = end - beg - ngram + 1;
            int32_t u = 0;
            for (int64_t p = 0; p < nwin; ++p) {
                const uint8_t* c = S.clean.data() + beg + p;
                uint32_t key = c[0];
                for (int64_t j = 1; j < ngram; ++j) key = (key << 8) | c[j];
                int32_t id = S.table[key];
                if (id < 0) continue;  // OOV (transform)
                // binary search in the sorted local prefix
                int32_t lo = 0, hi = u;
                while (lo < hi) {
                    int32_t mid = (lo + hi) >> 1;
                    if (lid[mid] < id) lo = mid + 1; else hi = mid;
                }
                if (lo < u && lid[lo] == id) {
                    ltf[lo]++;
                } else {
                    for (int32_t k = u; k > lo; --k) {
                        lid[k] = lid[k - 1]; ltf[k] = ltf[k - 1];
                    }
                    lid[lo] = id; ltf[lo] = 1; ++u;
                }
            }
            int32_t* wi = S.wid.data() + beg;
            int32_t* wt = S.wtf.data() + beg;
            for (int32_t k = 0; k < u; ++k) {
                wi[k] = lid[k]; wt[k] = ltf[k];
                if (df) df[lid[k]].fetch_add(1, std::memory_order_relaxed);
            }
            S.ucnt[r] = u;
            if (u > max_w) max_w = u;
            nnz += u;
        }
    }
    return {max_w, nnz};
}

}  // namespace

extern "C" {

// Fit: clean + vocabulary build + per-row unique/tf + df.
// out_info: [vocab_size, max_row_width, total_nnz].
void encode_fit_phase1(
    const uint8_t* raw, const int64_t* roff, int64_t n_rows,
    const uint8_t* keep_lut, const uint8_t* map_lut,
    int64_t ngram, int64_t* out_info)
{
    EncState& S = g_enc;
    clean_rows(raw, roff, n_rows, keep_lut, map_lut);

    const int64_t tbl = int64_t(1) << (8 * ngram);
    const int64_t words = tbl >> 6;
    std::vector<uint64_t> present(words, 0);
#pragma omp parallel
    {
        std::vector<uint64_t> local(words, 0);
#pragma omp for schedule(static)
        for (int64_t r = 0; r < n_rows; ++r) {
            const int64_t beg = S.coff[r];
            const int64_t nwin = S.coff[r + 1] - beg - ngram + 1;
            for (int64_t p = 0; p < nwin; ++p) {
                const uint8_t* c = S.clean.data() + beg + p;
                uint32_t key = c[0];
                for (int64_t j = 1; j < ngram; ++j) key = (key << 8) | c[j];
                local[key >> 6] |= uint64_t(1) << (key & 63);
            }
        }
#pragma omp critical
        for (int64_t w = 0; w < words; ++w) present[w] |= local[w];
    }

    S.table.assign(tbl, -1);
    S.vocab.clear();
    for (int64_t w = 0; w < words; ++w) {
        uint64_t bits = present[w];
        while (bits) {
            int b = __builtin_ctzll(bits);
            bits &= bits - 1;
            uint32_t key = uint32_t((w << 6) + b);
            S.table[key] = int32_t(S.vocab.size());
            S.vocab.push_back(key);
        }
    }
    S.df.assign(S.vocab.size(), 0);

    auto [max_w, nnz] = rows_unique_tf(ngram, /*count_df=*/true);
    out_info[0] = int64_t(S.vocab.size());
    out_info[1] = max_w;
    out_info[2] = nnz;
}

// Transform against a fixed vocabulary (corpus-reuse path).
void encode_transform_phase1(
    const uint8_t* raw, const int64_t* roff, int64_t n_rows,
    const uint8_t* keep_lut, const uint8_t* map_lut,
    int64_t ngram, const uint32_t* vocab, int64_t vocab_n, int64_t* out_info)
{
    EncState& S = g_enc;
    clean_rows(raw, roff, n_rows, keep_lut, map_lut);
    const int64_t tbl = int64_t(1) << (8 * ngram);
    S.table.assign(tbl, -1);
    S.vocab.assign(vocab, vocab + vocab_n);
    for (int64_t i = 0; i < vocab_n; ++i) S.table[vocab[i]] = int32_t(i);
    auto [max_w, nnz] = rows_unique_tf(ngram, /*count_df=*/false);
    out_info[0] = vocab_n;
    out_info[1] = max_w;
    out_info[2] = nnz;
}

void encode_get_vocab_df(uint32_t* keys_out, int32_t* df_out)
{
    EncState& S = g_enc;
    std::memcpy(keys_out, S.vocab.data(), S.vocab.size() * 4);
    std::memcpy(df_out, S.df.data(), S.df.size() * 4);
}

// Fill the final ELL arrays: ids (int32, -1 padded) and L2-normalized
// float64 tf-idf values.  Rounding order matches corpus/tfidf.py _encode
// exactly: w = double(tf) * idf[t]; norm = sqrt(sum w*w in ascending-term
// order); inv = 1.0 / norm; val = w * inv.
void encode_phase2(
    const double* idf, int64_t width, int32_t* out_ids, double* out_vals)
{
    EncState& S = g_enc;
    const int64_t n_rows = S.n_rows;
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n_rows; ++r) {
        const int64_t beg = S.coff[r];
        const int32_t u = S.ucnt[r];
        int32_t* oi = out_ids + r * width;
        double*  ov = out_vals + r * width;
        double sumsq = 0.0;
        for (int32_t k = 0; k < u; ++k) {
            const double w = double(S.wtf[beg + k]) * idf[S.wid[beg + k]];
            ov[k] = w;
            sumsq += w * w;
        }
        const double norm = std::sqrt(sumsq);
        const double inv = norm > 0.0 ? 1.0 / norm : 0.0;
        for (int32_t k = 0; k < u; ++k) {
            oi[k] = S.wid[beg + k];
            ov[k] = ov[k] * inv;
        }
        for (int64_t k = u; k < width; ++k) { oi[k] = -1; ov[k] = 0.0; }
    }
}

// ---------------------------------------------------------------------------
// Device-encode payload (corpus/tfidf.py DeviceEncodeSrc): the cleaned byte
// stream + per-row inverse L2 norms let the TPU build its hashed projection
// directly from ~1 byte per character instead of 4 bytes per nonzero slot
// (ops/matcher.py _device_hash_codes) -- the host-device link is the scarce
// resource (docs/performance.md).  Valid between a phase1 call and the next
// encode (g_enc is per-process scratch); the Python caller copies eagerly.
// ---------------------------------------------------------------------------

// Size of the cleaned byte stream, for caller-side allocation.
int64_t encode_clean_total() { return int64_t(g_enc.clean.size()); }

// Copy the cleaned byte stream and row offsets (n_rows + 1 entries).
void encode_get_clean(uint8_t* out_flat, int64_t* out_coff)
{
    EncState& S = g_enc;
    std::memcpy(out_flat, S.clean.data(), S.clean.size());
    std::memcpy(out_coff, S.coff.data(), (S.n_rows + 1) * sizeof(int64_t));
}

// Per-row FNV-1a hash of the CLEANED byte stream: rows with equal cleaned
// content (case/punctuation variants of the same string) hash equal, which
// feeds the duplicate-collapse layer's clean-equality grouping
// (ops/matcher.py _clean_dup_codes; groups are byte-verified there, so a
// hash collision costs nothing but the verification).
void encode_row_hashes(uint64_t* out)
{
    EncState& S = g_enc;
    const int64_t n_rows = S.n_rows;
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n_rows; ++r) {
        uint64_t h = 1469598103934665603ull;  // FNV offset basis
        for (int64_t i = S.coff[r]; i < S.coff[r + 1]; ++i) {
            h ^= uint64_t(S.clean[i]);
            h *= 1099511628211ull;  // FNV prime
        }
        out[r] = h;
    }
}

// Per-row inverse L2 norm of the tf-idf vector (0 for empty rows), float32.
// Same accumulation as encode_phase2: w = tf * idf in ascending-term order,
// float64 sum of squares.
void encode_row_norms(const double* idf, float* out_inv)
{
    EncState& S = g_enc;
    const int64_t n_rows = S.n_rows;
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n_rows; ++r) {
        const int64_t beg = S.coff[r];
        const int32_t u = S.ucnt[r];
        double sumsq = 0.0;
        for (int32_t k = 0; k < u; ++k) {
            const double w = double(S.wtf[beg + k]) * idf[S.wid[beg + k]];
            sumsq += w * w;
        }
        out_inv[r] = sumsq > 0.0 ? float(1.0 / std::sqrt(sumsq)) : 0.0f;
    }
}

// Stateless: gather ragged code rows into a dense (m x width) uint8 matrix,
// 0-padded.  order[i] selects the source row; rows longer than width are
// truncated (the caller routes long rows to a wider tier).
void fill_code_rows(
    const uint8_t* flat, const int64_t* coff, const int32_t* order,
    int64_t m, int64_t width, uint8_t* out)
{
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < m; ++i) {
        const int64_t r = order[i];
        const int64_t len0 = coff[r + 1] - coff[r];
        const int64_t len = len0 < width ? len0 : width;
        uint8_t* o = out + i * width;
        std::memcpy(o, flat + coff[r], size_t(len));
        std::memset(o + len, 0, size_t(width - len));
    }
}

// Ragged row gather: out_flat receives the selected rows' byte runs
// back-to-back (caller precomputes out_coff = exclusive prefix sum of the
// selected lengths).  One memcpy per row -- the numpy repeat/arange gather
// built several gather-index temporaries the size of the payload and
// page-faulted for seconds at corpus scale.
void gather_rows_u8(
    const uint8_t* flat, const int64_t* coff, const int64_t* rows,
    int64_t m, const int64_t* out_coff, uint8_t* out_flat)
{
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < m; ++i) {
        const int64_t r = rows[i];
        std::memcpy(out_flat + out_coff[i], flat + coff[r],
                    size_t(coff[r + 1] - coff[r]));
    }
}

// fill_code_rows fused with the 6-bit pack (codes < 64: 5 per uint32 word,
// zero-padded): one pass, no corpus-sized dense intermediate -- the numpy
// shift/or chain built ~6 temporaries of the matrix size and page-faulted
// for tens of seconds on wide (long-string) corpora.
void fill_code_rows6(
    const uint8_t* flat, const int64_t* coff, const int32_t* order,
    int64_t m, int64_t width, uint32_t* out)
{
    const int64_t wp = (width + 4) / 5;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < m; ++i) {
        const int64_t r = order[i];
        const int64_t len0 = coff[r + 1] - coff[r];
        const int64_t len = len0 < width ? len0 : width;
        const uint8_t* src = flat + coff[r];
        uint32_t* o = out + i * wp;
        for (int64_t w = 0; w < wp; ++w) {
            uint32_t word = 0;
            const int64_t base = w * 5;
            const int64_t hi = (base + 5 < len) ? base + 5 : len;
            for (int64_t k = base; k < hi; ++k)
                word |= uint32_t(src[k] & 63u) << (6 * (k - base));
            o[w] = word;
        }
    }
}

}  // extern "C"

// ===========================================================================
// Fused duplicate-collapse expansion (ops/matcher.py _expand_dedup):
// unique-level pairs -> per-unique-row top-n over the group-EXPANDED
// candidate set -> replication to every original left row.  The numpy
// implementation (the oracle, tests/test_dedup_collapse.py) materializes
// ~7 corpus-sized temporaries via np.repeat chains -- the most
// page-fault-exposed host stage after assembly; this computes the same
// output in two passes with per-thread grow-only scratch and NO
// materialized expansion: a group's position list (perm_r, ascending) is
// already in output order, so only runs of EQUAL similarity need a gather
// + sort to interleave their groups' columns (the tie case the expansion
// proof in _expand_dedup's docstring is about).
//
// Call sequence: expand_dedup_phase1 -> total + true_max, then
// expand_dedup_phase2 fills caller-allocated output arrays.  ctypes
// RELEASES the GIL during both calls, so the Python caller serializes the
// two-call window with a module-level lock (ops/matcher.py _EXPAND_LOCK);
// the state is process-global grow-only scratch, deliberately retained
// across fits (first-touch page faults on this VM run at 5-40 MB/s --
// see the encoder's EncState note above).
// ===========================================================================

namespace {

struct ExpState {
    std::vector<int64_t> offs;   // per-unique-row CAPACITY offsets (u+1)
    std::vector<int64_t> cnt;    // per-unique-row selected count
    std::vector<int64_t> cols;   // selected original col ids (at offs[r])
    std::vector<double>  sims;   // matching similarities
    int64_t u_left = 0;
};

ExpState g_exp;

}  // namespace

extern "C" {

int64_t expand_dedup_phase1(
    const int64_t* rows_u, const int64_t* cols_u, const double* sims_u,
    int64_t n_pairs,
    const int64_t* perm_r, const int64_t* starts_r, const int64_t* counts_r,
    int64_t u_left,
    const int64_t* codes_l, int64_t n_left,
    double min_sim, int64_t max_n,
    int64_t* out_true_max)
{
    ExpState& S = g_exp;
    S.u_left = u_left;
    // Bucket pair indices by unique left row (counting sort), tracking the
    // per-row selection capacity min(max_n, expanded qualified count).
    std::vector<int64_t> poffs(u_left + 1, 0);
    for (int64_t p = 0; p < n_pairs; ++p) poffs[rows_u[p] + 1]++;
    for (int64_t r = 0; r < u_left; ++r) poffs[r + 1] += poffs[r];
    std::vector<int64_t> bucket(n_pairs);
    {
        std::vector<int64_t> fill(poffs.begin(), poffs.end() - 1);
        for (int64_t p = 0; p < n_pairs; ++p)
            bucket[fill[rows_u[p]]++] = p;
    }
    S.offs.assign(u_left + 1, 0);
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < u_left; ++r) {
        int64_t exp_q = 0;
        for (int64_t k = poffs[r]; k < poffs[r + 1]; ++k) {
            const int64_t p = bucket[k];
            const double s = sims_u[p];
            if (s > 0.0 && s >= min_sim) exp_q += counts_r[cols_u[p]];
        }
        S.offs[r + 1] = exp_q < max_n ? exp_q : max_n;
    }
    for (int64_t r = 0; r < u_left; ++r) S.offs[r + 1] += S.offs[r];
    S.cnt.assign(u_left, 0);
    S.cols.resize(S.offs[u_left]);
    S.sims.resize(S.offs[u_left]);

#pragma omp parallel
    {
        std::vector<int64_t> pp;    // this row's qualified pair indices
        std::vector<int64_t> tmp;   // equal-sim run column gather
#pragma omp for schedule(dynamic, 1024)
        for (int64_t r = 0; r < u_left; ++r) {
            pp.clear();
            for (int64_t k = poffs[r]; k < poffs[r + 1]; ++k) {
                const int64_t p = bucket[k];
                const double s = sims_u[p];
                if (s > 0.0 && s >= min_sim) pp.push_back(p);
            }
            if (pp.empty()) continue;
            // similarity descending; intra-run pair order is irrelevant
            // (runs merge by column below), but keep it deterministic.
            std::sort(pp.begin(), pp.end(), [&](int64_t x, int64_t y) {
                if (sims_u[x] != sims_u[y]) return sims_u[x] > sims_u[y];
                return cols_u[x] < cols_u[y];
            });
            int64_t* oc = S.cols.data() + S.offs[r];
            double* os = S.sims.data() + S.offs[r];
            int64_t have = 0;
            for (size_t i = 0; i < pp.size() && have < max_n;) {
                size_t j = i + 1;
                while (j < pp.size() && sims_u[pp[j]] == sims_u[pp[i]]) ++j;
                const double s = sims_u[pp[i]];
                const int64_t room = max_n - have;
                if (j == i + 1) {
                    // single group: perm_r slice is already col-ascending
                    const int64_t h = cols_u[pp[i]];
                    const int64_t c = counts_r[h];
                    const int64_t take = c < room ? c : room;
                    const int64_t* src = perm_r + starts_r[h];
                    for (int64_t k = 0; k < take; ++k) oc[have + k] = src[k];
                    for (int64_t k = 0; k < take; ++k) os[have + k] = s;
                    have += take;
                } else {
                    // tie across groups: interleave by original column
                    tmp.clear();
                    for (size_t t = i; t < j; ++t) {
                        const int64_t h = cols_u[pp[t]];
                        const int64_t* src = perm_r + starts_r[h];
                        tmp.insert(tmp.end(), src, src + counts_r[h]);
                    }
                    std::sort(tmp.begin(), tmp.end());
                    const int64_t take =
                        (int64_t)tmp.size() < room ? (int64_t)tmp.size() : room;
                    for (int64_t k = 0; k < take; ++k) oc[have + k] = tmp[k];
                    for (int64_t k = 0; k < take; ++k) os[have + k] = s;
                    have += take;
                }
                i = j;
            }
            S.cnt[r] = have;
        }
    }
    int64_t true_max = 0, total = 0;
    for (int64_t r = 0; r < u_left; ++r)
        if (S.cnt[r] > true_max) true_max = S.cnt[r];
    for (int64_t l = 0; l < n_left; ++l) total += S.cnt[codes_l[l]];
    *out_true_max = true_max;
    return total;
}

void expand_dedup_phase2(
    const int64_t* codes_l, int64_t n_left,
    int64_t* out_rows, int64_t* out_cols, double* out_sims)
{
    ExpState& S = g_exp;
    std::vector<int64_t> offs(n_left + 1, 0);
    for (int64_t l = 0; l < n_left; ++l)
        offs[l + 1] = offs[l] + S.cnt[codes_l[l]];
#pragma omp parallel for schedule(static)
    for (int64_t l = 0; l < n_left; ++l) {
        const int64_t r = codes_l[l];
        const int64_t c = S.cnt[r];
        const int64_t* sc = S.cols.data() + S.offs[r];
        const double* ss = S.sims.data() + S.offs[r];
        int64_t* orow = out_rows + offs[l];
        int64_t* ocol = out_cols + offs[l];
        double* osim = out_sims + offs[l];
        for (int64_t k = 0; k < c; ++k) orow[k] = l;
        std::memcpy(ocol, sc, c * sizeof(int64_t));
        std::memcpy(osim, ss, c * sizeof(double));
    }
}

}  // extern "C"
