// Native SED2012 metadata scanner: the data-loader tier of the native
// runtime (the reference's slowest I/O is its full-corpus XML DOM parse,
// reference data_loader.py:130-178; SURVEY.md §3.1).
//
// This is NOT a general XML parser: the corpus schema is fixed
// (<photo attrs><location .../><title/><description/><tags><tag/>...</tags>
// </photo>) and this scanner walks the byte stream once, extracting exactly
// those fields.  Entity references (&amp; &lt; &gt; &quot; &apos; &#NN;
// &#xHH;) and CDATA sections are decoded so output text matches Python's
// ElementTree byte-for-byte; all higher-level semantics (clean_text, float
// parsing with NaN fallback, label derivation) stay in Python so the two
// loaders share one behavior definition (data/sed2012.py) and the parity
// test can assert identical DataFrames.
//
// ABI (plain C, ctypes): COLUMN-oriented so Python decodes without a
// per-field loop (the v1 length-prefixed-record layout cost ~1 s of Python
// framing at 50k records).  One malloc'd blob:
//   u64 n_records
//   n x f64 latitude   (strtod with NaN fallback, = Python float()-or-NaN)
//   n x f64 longitude
//   6 string columns (id, dateTaken, dateUploaded, username, title,
//     description), each:  u64 byte_len + NUL-separated UTF-8 items (n of
//     them) — Python decodes a column with ONE .decode + ONE .split('\0')
//   n x u32 tag counts
//   u64 byte_len + NUL-separated tag texts (sum(counts) items)
// Decoded XML text cannot contain NUL (numeric refs <= 0 are dropped), so
// the separator is safe.  A missing attribute/element yields an empty item;
// a missing <location> yields NaN lat/lon.  Tags with no text are skipped
// (ElementTree's `.text is None` convention).
//
// Build: at first use, by mused_tpu_torch/native/__init__.py (host c++).

#include <atomic>
#include <charconv>
#include <system_error>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <utility>
#include <vector>

namespace {

// growable column stores for the column-oriented output blob
struct Columns {
    std::vector<double> lat, lon;
    std::string strs[6];           // NUL-separated: id, taken, uploaded,
                                   // username, title, description
    size_t str_items[6] = {0, 0, 0, 0, 0, 0};
    std::vector<uint32_t> tag_counts;
    std::string tag_blob;          // NUL-separated tag texts
    size_t tag_items = 0;

    void str_item(int col, const std::string& s) {
        if (str_items[col]++) strs[col].push_back('\0');
        strs[col].append(s);
    }
    void tag_item(const std::string& s) {
        if (tag_items++) tag_blob.push_back('\0');
        tag_blob.append(s);
    }
    bool empty() const {
        if (!lat.empty() || !lon.empty() || !tag_counts.empty() || tag_items)
            return false;
        for (size_t c : str_items)
            if (c) return false;
        return true;
    }

    // splice another chunk's columns onto this one (the parallel-scan
    // stitch): pure byte appends, no per-record work.  Takes ownership —
    // the first splice into an empty store is a move, later ones append
    // then release o's buffers, so peak transient memory is one extra
    // chunk, not a second copy of the whole corpus.
    void append(Columns&& o) {
        if (empty()) {
            *this = std::move(o);
            return;
        }
        lat.insert(lat.end(), o.lat.begin(), o.lat.end());
        lon.insert(lon.end(), o.lon.begin(), o.lon.end());
        o.lat = std::vector<double>();
        o.lon = std::vector<double>();
        for (int c = 0; c < 6; c++) {
            if (o.str_items[c]) {
                if (str_items[c]) strs[c].push_back('\0');
                strs[c].append(o.strs[c]);
                str_items[c] += o.str_items[c];
            }
            o.strs[c] = std::string();
        }
        tag_counts.insert(tag_counts.end(), o.tag_counts.begin(),
                          o.tag_counts.end());
        o.tag_counts = std::vector<uint32_t>();
        if (o.tag_items) {
            if (tag_items) tag_blob.push_back('\0');
            tag_blob.append(o.tag_blob);
            tag_items += o.tag_items;
        }
        o.tag_blob = std::string();
    }
};

// Exact reimplementation of data/sed2012.clean_text (reference
// data_loader.py:180-185).  The Python pipeline is three regex passes —
// strip <.*?> (non-greedy, '.' excludes '\n'), replace [^a-zA-Z0-9\s] with
// space, collapse \s+ — then strip().lower().  Because EVERY character that
// is not ASCII alphanumeric (punctuation, Unicode anything, whitespace of
// any flavor, UTF-8 continuation bytes) ends up as collapsing whitespace,
// the composition is exactly: remove <...> spans (acting as separators),
// then emit lowercased ASCII-alnum runs joined by single spaces.  Byte-wise
// implementable with no Unicode tables; the parity tests pin equality with
// the Python reference implementation.
std::string clean_text_ref(const std::string& in) {
    std::string out;
    out.reserve(in.size());
    size_t i = 0, n = in.size();
    bool pending_sep = false;
    while (i < n) {
        unsigned char c = in[i];
        if (c == '<') {
            // match <.*?> — nearest '>' with no '\n' in between
            size_t j = i + 1;
            while (j < n && in[j] != '>' && in[j] != '\n') j++;
            if (j < n && in[j] == '>') {
                i = j + 1;
                pending_sep = !out.empty();
                continue;
            }
            // no closing '>': '<' is punctuation -> separator
            pending_sep = !out.empty();
            i++;
            continue;
        }
        bool alnum = (c >= '0' && c <= '9') || (c >= 'a' && c <= 'z')
            || (c >= 'A' && c <= 'Z');
        if (alnum) {
            if (pending_sep) out.push_back(' ');
            pending_sep = false;
            out.push_back(static_cast<char>(
                (c >= 'A' && c <= 'Z') ? c + 32 : c));
        } else {
            pending_sep = !out.empty();
        }
        i++;
    }
    return out;
}

double parse_double_or_nan(const std::string& s) {
    // locale-INDEPENDENT float parse (review r5): strtod honors LC_NUMERIC
    // — an embedding app calling setlocale() under a decimal-comma locale
    // would silently turn every lat/lon into NaN on the native path only —
    // and accepts hex floats Python float() rejects.  std::from_chars
    // (general format) matches Python float() semantics for the decimal
    // corpus values: no locale, no hex, no leading whitespace.
    if (s.empty()) return __builtin_nan("");
    size_t b = 0, e = s.size();
    while (b < e && isspace(static_cast<unsigned char>(s[b]))) b++;
    while (e > b && isspace(static_cast<unsigned char>(s[e - 1]))) e--;
    if (b == e) return __builtin_nan("");
    double v = 0.0;
    auto res = std::from_chars(s.data() + b, s.data() + e, v);
    if (res.ec != std::errc() || res.ptr != s.data() + e)
        return __builtin_nan("");         // junk: float() would raise
    return v;
}

// decode XML entity references and numeric character refs into UTF-8
void decode_entities(const char* s, size_t len, std::string& out) {
    out.clear();
    out.reserve(len);
    size_t i = 0;
    while (i < len) {
        if (s[i] != '&') { out.push_back(s[i++]); continue; }
        // find ';' within a short window
        size_t j = i + 1, end = (i + 12 < len) ? i + 12 : len;
        while (j < end && s[j] != ';') j++;
        if (j >= len || s[j] != ';') { out.push_back(s[i++]); continue; }
        std::string ent(s + i + 1, j - i - 1);
        if (ent == "amp") out.push_back('&');
        else if (ent == "lt") out.push_back('<');
        else if (ent == "gt") out.push_back('>');
        else if (ent == "quot") out.push_back('"');
        else if (ent == "apos") out.push_back('\'');
        else if (!ent.empty() && ent[0] == '#') {
            long cp = (ent.size() > 1 && (ent[1] == 'x' || ent[1] == 'X'))
                ? strtol(ent.c_str() + 2, nullptr, 16)
                : strtol(ent.c_str() + 1, nullptr, 10);
            if (cp <= 0 || cp > 0x10FFFF) { i = j + 1; continue; }
            // encode code point as UTF-8
            if (cp < 0x80) out.push_back(static_cast<char>(cp));
            else if (cp < 0x800) {
                out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
                out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
            } else if (cp < 0x10000) {
                out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
                out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
                out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
            } else {
                out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
                out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
                out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
                out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
            }
        } else { out.push_back(s[i++]); continue; }  // unknown entity: literal
        i = j + 1;
    }
}

// element text between pos and the closing tag, with CDATA + entity decode;
// ElementTree's .text semantics: only the text BEFORE the first child tag
// (our schema has no children inside title/description/tag).
// Returns decoded text; *found=false when no closing tag before limit.
std::string element_text(const char* data, size_t pos, size_t limit,
                         const char* close_tag, bool* found) {
    std::string out, seg;
    size_t close_len = strlen(close_tag);
    *found = false;
    size_t i = pos, seg_start = pos;
    auto flush_segment = [&](size_t end) {
        // entity references decode only OUTSIDE CDATA (CDATA is literal)
        decode_entities(data + seg_start, end - seg_start, seg);
        out.append(seg);
    };
    while (i < limit) {
        if (data[i] == '<') {
            if (i + 9 <= limit && memcmp(data + i, "<![CDATA[", 9) == 0) {
                flush_segment(i);
                size_t j = i + 9;
                while (j + 3 <= limit && memcmp(data + j, "]]>", 3) != 0) j++;
                out.append(data + i + 9, j - (i + 9));
                i = (j + 3 <= limit) ? j + 3 : limit;
                seg_start = i;
                continue;
            }
            if (i + 4 <= limit && memcmp(data + i, "<!--", 4) == 0) {
                // ElementTree's parser DISCARDS comments, merging the text
                // around them ("foo <!-- c --> bar" -> "foo  bar"); the
                // old scan stopped at the first '<' and truncated
                flush_segment(i);
                size_t j = i + 4;
                while (j + 3 <= limit && memcmp(data + j, "-->", 3) != 0) j++;
                i = (j + 3 <= limit) ? j + 3 : limit;
                seg_start = i;
                continue;
            }
            // closing tag or unexpected child: ElementTree .text stops here
            *found = true;
            (void)close_len;
            break;
        }
        i++;
    }
    flush_segment(i);
    return out;
}

// attribute value by name within a start tag spanning [pos, tag_end).
// QUOTE-AWARE (review r5): tokenizes name="value" pairs left to right and
// skips quoted values wholesale, so a `name=` pattern INSIDE an earlier
// attribute's value (legal XML: single quotes inside double-quoted values)
// can never be matched as the attribute — the old substring scan returned
// the embedded impostor while ElementTree returned the real value, with no
// framing error to trigger the iterparse fallback.
std::string attr_value(const char* data, size_t pos, size_t tag_end,
                       const char* name, bool* present) {
    size_t nlen = strlen(name);
    *present = false;
    size_t i = pos;
    if (i < tag_end && data[i] == '<') i++;
    while (i < tag_end && !isspace(static_cast<unsigned char>(data[i]))
           && data[i] != '>' && data[i] != '/')
        i++;                                   // skip the tag name
    while (i < tag_end) {
        while (i < tag_end && isspace(static_cast<unsigned char>(data[i])))
            i++;
        if (i >= tag_end || data[i] == '>' || data[i] == '/') break;
        size_t ns = i;                         // attribute name token
        while (i < tag_end && data[i] != '='
               && !isspace(static_cast<unsigned char>(data[i]))
               && data[i] != '>' && data[i] != '/')
            i++;
        size_t ne = i;
        while (i < tag_end && isspace(static_cast<unsigned char>(data[i])))
            i++;
        if (i >= tag_end || data[i] != '=')
            continue;                          // valueless token: keep going
        i++;
        while (i < tag_end && isspace(static_cast<unsigned char>(data[i])))
            i++;
        if (i >= tag_end || (data[i] != '"' && data[i] != '\''))
            continue;                          // malformed: resync at ws
        char q = data[i++];
        size_t vs = i;
        while (i < tag_end && data[i] != q) i++;
        size_t ve = i;
        if (i < tag_end) i++;                  // past the closing quote
        if (ne - ns == nlen && memcmp(data + ns, name, nlen) == 0) {
            std::string out;
            decode_entities(data + vs, ve - vs, out);
            *present = true;
            return out;
        }
    }
    return "";
}

size_t find(const char* data, size_t pos, size_t limit, const char* pat) {
    size_t plen = strlen(pat);
    if (plen == 0 || limit < plen || pos + plen > limit) return limit;
    const char* cur = data + pos;
    const char* end = data + limit - plen + 1;
    while (cur < end) {
        const char* hit = static_cast<const char*>(
            memchr(cur, pat[0], end - cur));
        if (!hit) return limit;
        if (memcmp(hit, pat, plen) == 0)
            return static_cast<size_t>(hit - data);
        cur = hit + 1;
    }
    return limit;
}

// like find(), but skips <![CDATA[ ... ]]> sections — markup-looking text
// inside another element's CDATA must not terminate/begin our elements
size_t find_markup(const char* data, size_t pos, size_t limit,
                   const char* pat) {
    size_t i = pos;
    while (i < limit) {
        size_t hit = find(data, i, limit, pat);
        if (hit >= limit) return limit;
        // only need to know whether a CDATA section or an XML comment
        // OPENS before the hit — bound the probes there (an unbounded
        // probe made the whole scan O(file^2) on CDATA-free corpora).
        // Comments matter (review r5): ElementTree discards them, so a
        // pattern inside <!-- ... --> must not count as markup.
        size_t bound = hit + 9 < limit ? hit + 9 : limit;
        size_t cd = find(data, i, bound, "<![CDATA[");
        size_t cm = find(data, i, bound, "<!--");
        if (hit < cd && hit < cm) return hit;
        if (cm < cd) {
            size_t close = find(data, cm + 4, limit, "-->");
            i = (close >= limit) ? limit : close + 3;
        } else {
            size_t close = find(data, cd + 9, limit, "]]>");
            i = (close >= limit) ? limit : close + 3;
        }
    }
    return limit;
}

// end of a start tag: first '>' OUTSIDE quoted attribute values (a literal
// '>' inside username="a>b" is legal XML); *self_closed reports a '/'
// immediately before it (also quote-aware)
size_t tag_close(const char* data, size_t pos, size_t limit,
                 bool* self_closed) {
    char q = 0;
    size_t last_nonspace = pos;
    for (size_t i = pos; i < limit; i++) {
        char c = data[i];
        if (q) {
            if (c == q) q = 0;
            continue;
        }
        if (c == '"' || c == '\'') { q = c; continue; }
        if (c == '>') {
            *self_closed = data[last_nonspace] == '/';
            return i;
        }
        if (!isspace(static_cast<unsigned char>(c))) last_nonspace = i;
    }
    *self_closed = false;
    return limit;
}

// Parse every photo record whose "<photo" START lies in [from, claim_end)
// into `cols`; record BODIES may extend past claim_end (bounded by n) — the
// chunk that owns a record's start owns the whole record.  `spans` (when
// non-null) records each written record's (start, resume) byte positions,
// which the parallel stitch uses to detect chunk-boundary conflicts.
// skip/max follow the sequential semantics (the parallel driver only calls
// with skip=0/max=-1).  Returns the number of records written.
int64_t scan_range(const char* data, size_t n, size_t from, size_t claim_end,
                   bool clean, int64_t skip_records, int64_t max_records,
                   Columns& cols,
                   std::vector<std::pair<size_t, size_t>>* spans) {
    int64_t seen = 0, written = 0;
    size_t pos = from;
    while (pos < claim_end) {
        // find_markup: a "<photo" inside an XML comment or CDATA section
        // must not fabricate a record (ElementTree ignores both)
        size_t p = find_markup(data, pos, n, "<photo");
        if (p >= claim_end) break;
        size_t after = p + 6;
        if (after < n && data[after] != ' ' && data[after] != '\t'
                && data[after] != '\n' && data[after] != '\r'
                && data[after] != '>' && data[after] != '/') {
            pos = after;           // e.g. "<photos>" — not a photo element
            continue;
        }
        bool self_closed = false;
        size_t tag_end = tag_close(data, after, n, &self_closed);
        if (tag_end >= n) break;
        size_t photo_end = find_markup(data, tag_end, n, "</photo>");
        size_t body_end = self_closed ? tag_end : photo_end;
        size_t resume = self_closed ? tag_end : photo_end + 8;

        seen++;
        if (seen <= skip_records) {
            pos = resume;
            continue;
        }
        if (max_records >= 0 && written >= max_records) break;

        bool present;
        cols.str_item(0, attr_value(data, p, tag_end, "id", &present));
        cols.str_item(1, attr_value(data, p, tag_end, "dateTaken", &present));
        cols.str_item(2, attr_value(data, p, tag_end, "dateUploaded",
                                    &present));
        cols.str_item(3, attr_value(data, p, tag_end, "username", &present));

        std::string lat, lon;
        size_t loc = find_markup(data, tag_end, body_end, "<location");
        if (loc < body_end) {
            bool loc_sc = false;
            size_t loc_end = tag_close(data, loc + 9, body_end, &loc_sc);
            lat = attr_value(data, loc, loc_end, "latitude", &present);
            if (!present) lat.clear();
            lon = attr_value(data, loc, loc_end, "longitude", &present);
            if (!present) lon.clear();
        }
        cols.lat.push_back(parse_double_or_nan(lat));
        cols.lon.push_back(parse_double_or_nan(lon));

        bool found;
        std::string title, desc;
        size_t t = find_markup(data, tag_end, body_end, "<title>");
        if (t < body_end)
            title = element_text(data, t + 7, body_end, "</title>", &found);
        size_t d = find_markup(data, tag_end, body_end, "<description>");
        if (d < body_end)
            desc = element_text(data, d + 13, body_end, "</description>",
                                &found);
        cols.str_item(4, clean ? clean_text_ref(title) : title);
        cols.str_item(5, clean ? clean_text_ref(desc) : desc);

        uint32_t tag_count = 0;
        size_t tp = tag_end;
        while (true) {
            tp = find_markup(data, tp, body_end, "<tag>");
            if (tp >= body_end) break;
            std::string txt = element_text(data, tp + 5, body_end, "</tag>",
                                           &found);
            if (!txt.empty()) {    // ElementTree: empty element -> text None
                // clean AFTER the emptiness check: a tag whose cleaned text
                // is empty stays in the list (Python cleans post-filter)
                cols.tag_item(clean ? clean_text_ref(txt) : txt);
                tag_count++;
            }
            tp += 5;
        }
        cols.tag_counts.push_back(tag_count);

        written++;
        if (spans) spans->emplace_back(p, resume);
        pos = resume;
    }
    return written;
}

// Implementation behind the extern "C" entry (which adds the catch-all:
// no exception — thread-spawn system_error, bad_alloc — may cross the
// ctypes boundary; the ABI contract is "return -1 on failure").
//
// Returns the number of records written (>= 0), or -1 on I/O failure.
// *out_blob receives a malloc'd buffer (caller frees via mused_free_blob);
// *out_len its byte length.
//
// `threads` splits the scan across chunks cut at "<photo" starts
// (0 = auto: hardware_concurrency clamped to [1, 16]).  Records are owned
// by the chunk containing their start; a cut that lands on markup-looking
// text inside another record's CDATA makes that chunk's first spans overlap
// the previous chunk's last record, which the stitch detects by byte
// position and repairs with an exact sequential reparse of the gap — so
// the threaded output is byte-identical to threads=1 on any input.
// skip/max bounded scans stay sequential (their record counting is a
// whole-file prefix walk by definition).  A failed threaded attempt
// (thread limits, worker allocation failure) falls back to the
// sequential scan rather than erroring.
int64_t parse_sed2012_impl(const char* path, int64_t skip_records,
                           int64_t max_records, int64_t clean,
                           int64_t threads, char** out_blob,
                           int64_t* out_len) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    if (size < 0) { fclose(f); return -1; }
    std::vector<char> body(static_cast<size_t>(size));
    if (size > 0 && fread(body.data(), 1, size, f) != static_cast<size_t>(size)) {
        fclose(f);
        return -1;
    }
    fclose(f);
    // XML line-ending normalization (XML 1.0 §2.11): literal "\r\n" and
    // lone "\r" in the input become "\n" at parse time, BEFORE entity
    // decoding ("&#13;" still yields a real '\r').  ElementTree does this;
    // it changes clean_text results because regex '.' excludes '\n' only —
    // a span like "<\r...>" matches on raw bytes but not post-parse.
    {
        size_t w = 0, r = 0, len = body.size();
        while (r < len) {
            char c = body[r++];
            if (c == '\r') {
                if (r < len && body[r] == '\n') r++;
                c = '\n';
            }
            body[w++] = c;
        }
        body.resize(w);
    }
    const char* data = body.data();
    size_t n = body.size();

    size_t T;
    if (threads > 0) {
        T = static_cast<size_t>(threads > 64 ? 64 : threads);
    } else {
        unsigned t_auto = std::thread::hardware_concurrency();
        T = t_auto ? (t_auto > 16 ? 16 : t_auto) : 1;
        if (n < (4u << 20)) T = 1;   // tiny files don't amortize spawns
    }
    // bounded scans count a whole-file record prefix: sequential by
    // definition
    if (skip_records > 0 || max_records >= 0) T = 1;

    Columns cols;
    int64_t written = 0;
    bool done = false;
    if (T > 1) {
        try {
            // cut at "<photo" starts near the equal-byte splits; cuts are
            // nondecreasing (find may return the same position twice -> an
            // empty chunk, which the stitch skips)
            std::vector<size_t> cuts(T + 1, 0);
            cuts[T] = n;
            for (size_t t = 1; t < T; t++) {
                size_t c = find(data, n * t / T, n, "<photo");
                cuts[t] = c < cuts[t - 1] ? cuts[t - 1] : c;
            }
            std::vector<Columns> parts(T);
            std::vector<std::vector<std::pair<size_t, size_t>>> spans(T);
            std::atomic<bool> failed{false};
            std::vector<std::thread> pool;
            try {
                for (size_t t = 0; t < T; t++)
                    pool.emplace_back([&, t] {
                        try {
                            scan_range(data, n, cuts[t], cuts[t + 1],
                                       clean != 0, 0, -1, parts[t],
                                       &spans[t]);
                        } catch (...) {
                            failed.store(true);
                        }
                    });
            } catch (...) {
                failed.store(true);   // spawn limit hit; join what started
            }
            for (auto& th : pool) th.join();

            if (!failed.load()) {
                // stitch in order; `resume` = byte end of the last kept
                // record.  A chunk whose first record starts before resume
                // began inside the previous record (a "<photo" inside
                // CDATA): reparse the gap sequentially — exactness over
                // the (never-observed) hostile case.
                size_t resume = 0;
                for (size_t t = 0; t < T; t++) {
                    if (spans[t].empty()) continue;
                    if (spans[t].front().first >= resume) {
                        written += static_cast<int64_t>(spans[t].size());
                        resume = spans[t].back().second;
                        cols.append(std::move(parts[t]));
                    } else {
                        size_t from = resume > cuts[t] ? resume : cuts[t];
                        Columns re;
                        std::vector<std::pair<size_t, size_t>> rs;
                        written += scan_range(data, n, from, cuts[t + 1],
                                              clean != 0, 0, -1, re, &rs);
                        cols.append(std::move(re));
                        if (!rs.empty()) resume = rs.back().second;
                    }
                }
                done = true;
            }
        } catch (...) {
            // fall through to the sequential scan
        }
        if (!done) {
            cols = Columns();
            written = 0;
        }
    }
    if (!done)
        written = scan_range(data, n, 0, n, clean != 0, skip_records,
                             max_records, cols, nullptr);

    // pack the column-oriented blob (see ABI comment above)
    std::string out_s;
    uint64_t nrec = static_cast<uint64_t>(written);
    out_s.append(reinterpret_cast<const char*>(&nrec), 8);
    out_s.append(reinterpret_cast<const char*>(cols.lat.data()),
                 cols.lat.size() * 8);
    out_s.append(reinterpret_cast<const char*>(cols.lon.data()),
                 cols.lon.size() * 8);
    for (int c = 0; c < 6; c++) {
        uint64_t len = cols.strs[c].size();
        out_s.append(reinterpret_cast<const char*>(&len), 8);
        out_s.append(cols.strs[c]);
    }
    out_s.append(reinterpret_cast<const char*>(cols.tag_counts.data()),
                 cols.tag_counts.size() * 4);
    uint64_t tlen = cols.tag_blob.size();
    out_s.append(reinterpret_cast<const char*>(&tlen), 8);
    out_s.append(cols.tag_blob);

    char* out = static_cast<char*>(malloc(out_s.size()));
    if (!out && !out_s.empty()) return -1;
    memcpy(out, out_s.data(), out_s.size());
    *out_blob = out;
    *out_len = static_cast<int64_t>(out_s.size());
    return written;
}

}  // namespace

extern "C" {

int64_t mused_parse_sed2012(const char* path, int64_t skip_records,
                            int64_t max_records, int64_t clean,
                            int64_t threads, char** out_blob,
                            int64_t* out_len) {
    try {
        return parse_sed2012_impl(path, skip_records, max_records, clean,
                                  threads, out_blob, out_len);
    } catch (...) {   // bad_alloc etc.: the ABI promises -1, never an abort
        return -1;
    }
}

void mused_free_blob(char* blob) { free(blob); }

}  // extern "C"
