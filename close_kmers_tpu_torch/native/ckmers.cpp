// Copied from close_kmers_tpu/native/ckmers.cpp.
// Native runtime for close_kmers_tpu_torch: the sequential scoring state machine,
// best-call reduction, family-score accumulation, and a single-core
// reference-architecture probe used as the benchmark baseline.
//
// Semantics parity (see the reference close_kmers sources):
//   * score state machine  — kguts.cc:734-877 (gather_hits run/gap/two-hit
//     rules, process_set_of_hits, the run-reseed quirk, the buffer cap)
//   * best-call reduction  — kguts.cc:1008-1199 (collapse, bridge-merge,
//     per-function totals, libstdc++ partial_sort top-2)
//   * family accumulation  — lookup_request.cc:446-469 (1/N weights over a
//     kmer's distinct families, float32 adds in hit order)
//   * probe                — kguts.cc:585-602 semantics on the sorted
//     two-level index (same layout the TPU kernel uses)
//
// The Python package loads this via ctypes (close_kmers_tpu_torch/native/api.py).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <unordered_map>
#include <map>
#include <utility>

extern "C" {

// ---------------------------------------------------------------------------
// Scoring state machine
// ---------------------------------------------------------------------------

struct Hit {
    int32_t pos;
    int32_t fi;
    int32_t oi;
    int32_t avg_off;
    float wt;
};

struct ScoreParams {
    int32_t order_constraint;
    int32_t min_hits;
    int32_t min_weighted_hits;
    int32_t max_gap;
    int32_t hit_buffer_cap;  // MAX_HITS_PER_SEQ - 2
};

// Replay the gather-hits state machine over one sequence's hits (sorted by
// position).  Emits calls and per-hit OTU vote flags.
// Returns the number of calls (truncated at max_calls).
static int score_one(const Hit* hits, int n, const ScoreParams& p,
                     int32_t* call_start, int32_t* call_end,
                     int32_t* call_count, int32_t* call_fi, float* call_wt,
                     int max_calls, uint8_t* vote /* [n] out, may be null */) {
    int n_calls = 0;
    // buffer holds indices into hits[]
    std::vector<int> buf;
    buf.reserve(64);
    int num_hits = 0;
    int32_t current_fi = 0;

    auto process_set = [&]() {
        // kguts.cc:734-781
        int fi_count = 0;
        float weighted = 0.0f;
        int last_hit = 0;
        for (int i = 0; i < num_hits; i++) {
            if (hits[buf[i]].fi == current_fi) {
                last_hit = i;
                fi_count++;
                weighted += hits[buf[i]].wt;
            }
        }
        if (num_hits > 0 && fi_count >= p.min_hits &&
            weighted >= (float)p.min_weighted_hits) {
            if (n_calls < max_calls) {
                call_start[n_calls] = hits[buf[0]].pos;
                call_end[n_calls] = hits[buf[last_hit]].pos + 7;
                call_count[n_calls] = fi_count;
                call_fi[n_calls] = current_fi;
                call_wt[n_calls] = weighted;
                n_calls++;
            }
            if (vote) {
                for (int i = 0; i <= last_hit; i++)
                    if (hits[buf[i]].fi == current_fi)
                        vote[buf[i]] = 1;
            }
        }
        // run-reseed quirk (kguts.cc:772-777)
        if (num_hits >= 2 &&
            hits[buf[num_hits - 2]].fi != current_fi &&
            hits[buf[num_hits - 2]].fi == hits[buf[num_hits - 1]].fi) {
            current_fi = hits[buf[num_hits - 1]].fi;
            int a = buf[num_hits - 2], b = buf[num_hits - 1];
            buf[0] = a;
            if ((int)buf.size() < 2) buf.push_back(b); else buf[1] = b;
            num_hits = 2;
        } else {
            num_hits = 0;
        }
    };

    for (int h = 0; h < n; h++) {
        const Hit& hit = hits[h];
        // gap flush (kguts.cc:821-831)
        if (num_hits > 0 &&
            hits[buf[num_hits - 1]].pos + p.max_gap < hit.pos) {
            if (num_hits >= p.min_hits) process_set();
            else num_hits = 0;
        }
        if (num_hits == 0) current_fi = hit.fi;
        bool admit = true;
        if (p.order_constraint && num_hits > 0) {
            const Hit& prev = hits[buf[num_hits - 1]];
            // unsigned-wrap semantics: admission iff 0 <= drift <= 20
            // (kguts.cc:838-842)
            long drift = (long)(hit.pos - prev.pos) -
                         (long)(prev.avg_off - hit.avg_off);
            admit = (hit.fi == prev.fi) && drift >= 0 && drift <= 20;
        }
        if (admit) {
            if (num_hits < (int)buf.size()) buf[num_hits] = h;
            else buf.push_back(h);
            if (num_hits < p.hit_buffer_cap) num_hits++;
            if (num_hits > 1 && current_fi != hit.fi &&
                hits[buf[num_hits - 2]].fi == hits[buf[num_hits - 1]].fi) {
                process_set();
            }
        }
    }
    if (num_hits >= p.min_hits) process_set();
    return n_calls;
}

// Batch scoring: hits for all sequences concatenated; row_off[i]..row_off[i+1]
// delimit sequence i.  Outputs flattened calls plus per-sequence call counts.
void ck_score_batch(const int32_t* pos, const int32_t* fi, const int32_t* oi,
                    const int32_t* avg_off, const float* wt,
                    const int64_t* row_off, int n_seqs,
                    int32_t order_constraint, int32_t min_hits,
                    int32_t min_weighted_hits, int32_t max_gap,
                    int32_t hit_buffer_cap,
                    int32_t* n_calls_out,      // [n_seqs]
                    int32_t* call_start, int32_t* call_end,
                    int32_t* call_count, int32_t* call_fi, float* call_wt,
                    int32_t max_calls_per_seq,
                    uint8_t* vote_out /* [total hits] or null */) {
    ScoreParams p{order_constraint, min_hits, min_weighted_hits, max_gap,
                  hit_buffer_cap};
    (void)oi;
    for (int s = 0; s < n_seqs; s++) {
        int64_t a = row_off[s], b = row_off[s + 1];
        int n = (int)(b - a);
        std::vector<Hit> hits(n);
        for (int i = 0; i < n; i++)
            hits[i] = Hit{pos[a + i], fi[a + i], oi ? oi[a + i] : 0,
                          avg_off[a + i], wt[a + i]};
        if (vote_out) std::memset(vote_out + a, 0, n);
        n_calls_out[s] = score_one(
            hits.data(), n, p,
            call_start + (int64_t)s * max_calls_per_seq,
            call_end + (int64_t)s * max_calls_per_seq,
            call_count + (int64_t)s * max_calls_per_seq,
            call_fi + (int64_t)s * max_calls_per_seq,
            call_wt + (int64_t)s * max_calls_per_seq,
            max_calls_per_seq,
            vote_out ? vote_out + a : nullptr);
    }
}

// ---------------------------------------------------------------------------
// find_best_call top-3 reduction (kguts.cc:1008-1152).  The final decision
// (>= 5 offset, " ?? " naming with lexicographic swap) needs function name
// strings, so it stays host-side; this returns the sorted top entries.
// Output per sequence: n_funcs (clamped to 3) and 3 x (fi, count, weighted).
// ---------------------------------------------------------------------------

void ck_best_call_batch(const int32_t* n_calls, const int32_t* call_start,
                        const int32_t* call_end, const int32_t* call_count,
                        const int32_t* call_fi, const float* call_wt,
                        int32_t max_calls_per_seq, int n_seqs,
                        int32_t* out_nfuncs,   // [n_seqs]
                        int32_t* out_fi,       // [n_seqs*3]
                        int32_t* out_count,    // [n_seqs*3]
                        float* out_wt) {       // [n_seqs*3]
    (void)call_start;
    for (int s = 0; s < n_seqs; s++) {
        int64_t base = (int64_t)s * max_calls_per_seq;
        int n = n_calls[s];
        // collapse adjacent same-function (kguts.cc:1023-1040)
        std::vector<int32_t> cfi, ccnt;
        std::vector<float> cwt;
        for (int i = 0; i < n;) {
            int32_t f = call_fi[base + i];
            int cnt = call_count[base + i];
            float w = call_wt[base + i];
            i++;
            while (i < n && call_fi[base + i] == f) {
                cnt += call_count[base + i];
                w += call_wt[base + i];
                i++;
            }
            cfi.push_back(f); ccnt.push_back(cnt); cwt.push_back(w);
        }
        // bridge-merge (kguts.cc:1063-1086)
        std::vector<int32_t> mfi, mcnt;
        std::vector<float> mwt;
        size_t i = 0;
        while (i < cfi.size()) {
            int32_t f = cfi[i];
            int cnt = ccnt[i];
            float w = cwt[i];
            i++;
            while (i < cfi.size() && i + 1 < cfi.size() && f == cfi[i + 1] &&
                   ccnt[i] < 5 && cnt + ccnt[i + 1] >= 10) {
                cnt += ccnt[i + 1];
                w += cwt[i + 1];
                i += 2;
            }
            mfi.push_back(f); mcnt.push_back(cnt); mwt.push_back(w);
        }
        // per-function totals, ascending fi (std::map, kguts.cc:1108-1131)
        std::vector<std::pair<int32_t, std::pair<int, float>>> vec;
        for (size_t k = 0; k < mfi.size(); k++) {
            bool found = false;
            for (auto& e : vec)
                if (e.first == mfi[k]) {
                    e.second.first += mcnt[k];
                    e.second.second += mwt[k];
                    found = true;
                    break;
                }
            if (!found) vec.push_back({mfi[k], {mcnt[k], mwt[k]}});
        }
        // ascending-fi order like std::map iteration
        for (size_t a1 = 0; a1 + 1 < vec.size(); a1++)
            for (size_t b1 = a1 + 1; b1 < vec.size(); b1++)
                if (vec[b1].first < vec[a1].first) std::swap(vec[a1], vec[b1]);
        // libstdc++ partial_sort(first, first+2) replica with
        // comp(a,b) = a.weighted > b.weighted (kguts.cc:1134-1139)
        if (vec.size() > 1) {
            auto comp = [](const decltype(vec)::value_type& x,
                           const decltype(vec)::value_type& y) {
                return x.second.second > y.second.second;
            };
            // __make_heap on 2
            {
                auto value = vec[0];
                vec[0] = vec[1];
                if (comp(vec[0], value)) { vec[1] = vec[0]; vec[0] = value; }
                else vec[1] = value;
            }
            for (size_t k = 2; k < vec.size(); k++) {
                if (comp(vec[k], vec[0])) {
                    auto value = vec[k];
                    vec[k] = vec[0];
                    vec[0] = vec[1];
                    if (comp(vec[0], value)) { vec[1] = vec[0]; vec[0] = value; }
                    else vec[1] = value;
                }
            }
            std::swap(vec[0], vec[1]);
        }
        int nf = (int)vec.size();
        out_nfuncs[s] = nf;
        for (int k = 0; k < 3; k++) {
            if (k < nf) {
                out_fi[s * 3 + k] = vec[k].first;
                out_count[s * 3 + k] = vec[k].second.first;
                out_wt[s * 3 + k] = vec[k].second.second;
            } else {
                out_fi[s * 3 + k] = -1;
                out_count[s * 3 + k] = 0;
                out_wt[s * 3 + k] = 0.0f;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Family-score accumulation (lookup_request.cc:446-469).
// CSR: keys (sorted int64), offs int64[nk+1], vals int32.
// For each sequence, accumulate {fam: (hit_count, weighted)} in
// first-insertion order; emit flattened results.
// ---------------------------------------------------------------------------

static inline int64_t csr_find(const int64_t* keys, int64_t nk, int64_t code) {
    int64_t lo = 0, hi = nk;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (keys[mid] < code) lo = mid + 1; else hi = mid;
    }
    return (lo < nk && keys[lo] == code) ? lo : -1;
}

// Returns total number of (seq, family) entries written.
int64_t ck_family_scores(const int64_t* codes,  // [total hits]
                         const int64_t* row_off, int n_seqs,
                         const int64_t* keys, const int64_t* offs,
                         const int32_t* vals, int64_t nk,
                         int32_t* out_n,        // [n_seqs]
                         int32_t* out_fam,      // [cap]
                         int32_t* out_hits,     // [cap]
                         float* out_weight,     // [cap]
                         int64_t cap) {
    int64_t w = 0;
    std::unordered_map<int32_t, int64_t> slot;  // fam -> out index
    for (int s = 0; s < n_seqs; s++) {
        slot.clear();
        int64_t first = w;
        for (int64_t h = row_off[s]; h < row_off[s + 1]; h++) {
            int64_t ki = csr_find(keys, nk, codes[h]);
            if (ki < 0) continue;
            int64_t a = offs[ki], b = offs[ki + 1];
            float weight = 1.0f / (float)(b - a);
            for (int64_t v = a; v < b; v++) {
                int32_t fam = vals[v];
                auto it = slot.find(fam);
                if (it == slot.end()) {
                    if (w >= cap) return -1;  // caller re-allocates
                    slot.emplace(fam, w);
                    out_fam[w] = fam;
                    out_hits[w] = 1;
                    out_weight[w] = weight;
                    w++;
                } else {
                    out_hits[it->second] += 1;
                    out_weight[it->second] += weight;
                }
            }
        }
        out_n[s] = (int32_t)(w - first);
    }
    return w;
}

// ---------------------------------------------------------------------------
// Single-core reference-architecture pipeline: encode + probe + score.
// This is the benchmark baseline standing in for the reference's
// one-thread-per-request engine (threadpool.cc:18-45).
// ---------------------------------------------------------------------------

// two-level probe identical to the TPU kernel's semantics
static inline int64_t probe_one(const int32_t* bucket_start,
                                const int32_t* lo_arr, int32_t hi, int32_t lo) {
    int32_t a = bucket_start[hi], b = bucket_start[hi + 1];
    while (a < b) {
        int32_t mid = (a + b) >> 1;
        if (lo_arr[mid] < lo) a = mid + 1; else b = mid;
    }
    if (a < bucket_start[hi + 1] && lo_arr[a] == lo) return a;
    return -1;
}

// Encode+probe one aa-offset sequence; returns number of hits found.
// Scans positions p < len-8 with validity skipping, matching
// gather_hits' window iteration (kguts.cc:783-877).
int ck_probe_seq(const int32_t* bucket_start, const int32_t* lo_arr,
                 const int32_t* fi_arr, const int32_t* oi_arr,
                 const int32_t* off_arr, const float* wt_arr,
                 const uint8_t* pI, int len,
                 int32_t* hit_pos, int32_t* hit_fi, int32_t* hit_oi,
                 int32_t* hit_off, float* hit_wt, int64_t* hit_code,
                 int max_hits) {
    int n = 0;
    int bound = len - 8;
    int p = 0;
    while (p < bound) {
        // find next valid window
        bool ok = true;
        for (int j = 7; j >= 0; j--) {
            if (pI[p + j] >= 20) { p += j + 1; ok = false; break; }
        }
        if (!ok) continue;
        // hi/lo split must match params.HI_DIGITS (5/3)
        int32_t hi = (((pI[p] * 20 + pI[p + 1]) * 20 + pI[p + 2]) * 20
                      + pI[p + 3]) * 20 + pI[p + 4];
        int32_t lo = (pI[p + 5] * 20 + pI[p + 6]) * 20 + pI[p + 7];
        int64_t where = probe_one(bucket_start, lo_arr, hi, lo);
        if (where >= 0 && n < max_hits) {
            hit_pos[n] = p;
            hit_fi[n] = fi_arr[where];
            hit_oi[n] = oi_arr[where];
            hit_off[n] = off_arr[where];
            hit_wt[n] = wt_arr[where];
            hit_code[n] = (int64_t)hi * 8000 + lo;
            n++;
        }
        p++;
    }
    return n;
}

// ---------------------------------------------------------------------------
// Reference-architecture baseline: the open-addressed linear-probe hash
// exactly as kguts uses it — 24-byte sig_kmer_t entries keyed by
// encodedK % size_hash with +1 wraparound probing (kguts.cc:585-602,
// kmer_image.h:17-23), table sized to the first prime > 3*n
// (build_signature_kmers.cc:862-884).  This is what a faithful port of
// the reference would run per CPU core; bench.py uses it as vs_baseline.
// ---------------------------------------------------------------------------

struct SigKmer {
    uint64_t which_kmer;
    int32_t otu_index;
    uint16_t avg_from_end;
    int32_t function_index;
    float function_wt;
} __attribute__((packed, aligned(8)));

static const uint64_t kMaxEncoded = 25600000000ULL;  // 20^8

// Build the hash image from sorted arrays; returns malloc'd table.
void* ck_hash_build(const int64_t* keys, const int32_t* fi,
                    const int32_t* oi, const int32_t* off, const float* wt,
                    int64_t n, int64_t size_hash) {
    SigKmer* tab = (SigKmer*)malloc(sizeof(SigKmer) * size_hash);
    for (int64_t i = 0; i < size_hash; i++)
        tab[i].which_kmer = kMaxEncoded + 1;
    for (int64_t i = 0; i < n; i++) {
        int64_t h = keys[i] % size_hash;
        while (tab[h].which_kmer <= kMaxEncoded) h = (h + 1) % size_hash;
        tab[h].which_kmer = (uint64_t)keys[i];
        tab[h].otu_index = oi[i];
        tab[h].avg_from_end = (uint16_t)off[i];
        tab[h].function_index = fi[i];
        tab[h].function_wt = wt[i];
    }
    return tab;
}

void ck_hash_free(void* tab) { free(tab); }

static inline int64_t hash_lookup(const SigKmer* tab, int64_t size_hash,
                                  uint64_t encodedK) {
    int64_t h = encodedK % size_hash;
    while (tab[h].which_kmer != encodedK && tab[h].which_kmer <= kMaxEncoded)
        h = (h + 1) % size_hash;
    return tab[h].which_kmer > kMaxEncoded ? -1 : h;
}

// Single-core pipeline over a padded batch using the reference hash
// layout: rolling-window encode + linear-probe lookup + scoring.
void ck_pipeline_hash(const void* tab_v, int64_t size_hash,
                      const uint8_t* seqs, const int32_t* lens,
                      int n_seqs, int stride,
                      int32_t min_hits, int32_t max_gap,
                      int32_t* n_calls_out) {
    const SigKmer* tab = (const SigKmer*)tab_v;
    std::vector<Hit> hits;
    hits.reserve(4096);
    std::vector<int32_t> cs(256), ce(256), cc(256), cf(256);
    std::vector<float> cw(256);
    ScoreParams p{0, min_hits, 0, max_gap, 39998};
    for (int s = 0; s < n_seqs; s++) {
        const uint8_t* pI = seqs + (int64_t)s * stride;
        int len = lens[s];
        int bound = len - 8;
        hits.clear();
        int ppos = 0;
        while (ppos < bound) {
            bool ok = true;
            for (int j = 7; j >= 0; j--)
                if (pI[ppos + j] >= 20) { ppos += j + 1; ok = false; break; }
            if (!ok) continue;
            uint64_t enc = pI[ppos];
            for (int j = 1; j < 8; j++) enc = enc * 20 + pI[ppos + j];
            // rolling scan like gather_hits (kguts.cc:798-871)
            while (ppos < bound) {
                int64_t where = hash_lookup(tab, size_hash, enc);
                if (where >= 0 && (int)hits.size() < 4096) {
                    hits.push_back(Hit{ppos, tab[where].function_index,
                                       tab[where].otu_index,
                                       (int32_t)tab[where].avg_from_end,
                                       tab[where].function_wt});
                }
                ppos++;
                if (ppos < bound) {
                    if (pI[ppos + 7] < 20) {
                        enc = (enc % 1280000000ULL) * 20 + pI[ppos + 7];
                    } else {
                        ppos += 8;
                        break;  // rescan validity from the top
                    }
                }
            }
        }
        n_calls_out[s] = score_one(hits.data(), (int)hits.size(), p,
                                   cs.data(), ce.data(), cc.data(),
                                   cf.data(), cw.data(), 256, nullptr);
    }
}

// Full single-core pipeline over a padded batch: probe + score, returning
// per-seq call counts only (throughput measurement).  Used by bench.py as
// the single-CPU-core baseline.
void ck_pipeline_batch(const int32_t* bucket_start, const int32_t* lo_arr,
                       const int32_t* fi_arr, const int32_t* oi_arr,
                       const int32_t* off_arr, const float* wt_arr,
                       const uint8_t* seqs, const int32_t* lens,
                       int n_seqs, int stride,
                       int32_t min_hits, int32_t max_gap,
                       int32_t* n_calls_out) {
    std::vector<int32_t> hp(4096), hf(4096), ho(4096), hoff(4096);
    std::vector<float> hw(4096);
    std::vector<int64_t> hc(4096);
    std::vector<int32_t> cs(256), ce(256), cc(256), cf(256);
    std::vector<float> cw(256);
    ScoreParams p{0, min_hits, 0, max_gap, 39998};
    for (int s = 0; s < n_seqs; s++) {
        int n = ck_probe_seq(bucket_start, lo_arr, fi_arr, oi_arr, off_arr,
                             wt_arr, seqs + (int64_t)s * stride, lens[s],
                             hp.data(), hf.data(), ho.data(), hoff.data(),
                             hw.data(), hc.data(), 4096);
        std::vector<Hit> hits(n);
        for (int i = 0; i < n; i++)
            hits[i] = Hit{hp[i], hf[i], ho[i], hoff[i], hw[i]};
        n_calls_out[s] = score_one(hits.data(), n, p, cs.data(), ce.data(),
                                   cc.data(), cf.data(), cw.data(), 256,
                                   nullptr);
    }
}


// ---------------------------------------------------------------------------
// /matrix single-core reference baseline (matrix_request.cc:83-161):
// per protein, per signature-kmer hit, walk the kmer->peg list and bump a
// std::map<(this,other),int> for every already-registered matrix protein —
// the reference's O(P^2)-pair design on the reference hash layout.  The
// kmer->peg mapping preloads untimed (the reference holds it resident,
// kmer.h:77-101); the timed loop is probe + map walk + pair map.
// ---------------------------------------------------------------------------

struct PegMap {
    std::unordered_map<uint64_t, std::pair<int64_t, int32_t>> idx;
    std::vector<int64_t> vals;
};

void* ck_pegmap_build(const int64_t* keys, const int64_t* offs,
                      const int64_t* vals, int64_t n_keys) {
    PegMap* m = new PegMap();
    m->idx.reserve((size_t)n_keys * 2);
    int64_t total = offs[n_keys];
    m->vals.assign(vals, vals + total);
    for (int64_t i = 0; i < n_keys; i++)
        m->idx.emplace((uint64_t)keys[i],
                       std::make_pair(offs[i], (int32_t)(offs[i + 1] - offs[i])));
    return m;
}

void ck_pegmap_free(void* m) { delete (PegMap*)m; }

// Returns the number of distinct pairs; *total_shared = sum of counts.
int64_t ck_matrix_hash(const void* tab_v, int64_t size_hash,
                       const void* pegmap_v,
                       const uint8_t* seqs, const int32_t* lens,
                       int n_seqs, int stride, int64_t* total_shared) {
    const SigKmer* tab = (const SigKmer*)tab_v;
    const PegMap* pm = (const PegMap*)pegmap_v;
    std::vector<uint8_t> member;   // eid = s in [0, n_seqs); vals may
    member.assign(2 * (size_t)n_seqs + 2, 0);  // exceed — treat as absent
    std::map<std::pair<int32_t, int32_t>, int32_t> distance;
    int64_t shared = 0;
    for (int s = 0; s < n_seqs; s++) {
        member[s] = 1;             // registered before its hits process
        const uint8_t* pI = seqs + (int64_t)s * stride;
        int len = lens[s];
        int bound = len - 8;
        int ppos = 0;
        while (ppos < bound) {
            bool ok = true;
            for (int j = 7; j >= 0; j--)
                if (pI[ppos + j] >= 20) { ppos += j + 1; ok = false; break; }
            if (!ok) continue;
            uint64_t enc = pI[ppos];
            for (int j = 1; j < 8; j++) enc = enc * 20 + pI[ppos + j];
            while (ppos < bound) {
                int64_t where = hash_lookup(tab, size_hash, enc);
                if (where >= 0) {
                    auto it = pm->idx.find(enc);
                    if (it != pm->idx.end()) {
                        int64_t off = it->second.first;
                        int32_t cnt = it->second.second;
                        for (int32_t k = 0; k < cnt; k++) {
                            int64_t o = pm->vals[off + k];
                            if (o != s && (size_t)o < member.size()
                                && member[o]) {
                                distance[{(int32_t)s, (int32_t)o}]++;
                                shared++;
                            }
                        }
                    }
                }
                ppos++;
                if (ppos < bound) {
                    if (pI[ppos + 7] < 20) {
                        enc = (enc % 1280000000ULL) * 20 + pI[ppos + 7];
                    } else {
                        ppos += 8;
                        break;
                    }
                }
            }
        }
    }
    *total_shared = shared;
    return (int64_t)distance.size();
}

}  // extern "C"
