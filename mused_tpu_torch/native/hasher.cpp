// Native host-side featurization: tokenizing + hashing text/tags into
// fixed-width count/multi-hot vectors.
//
// This is the host hot loop of the ingest path (the equivalent of the
// reference's per-window TfidfVectorizer / tag-set construction,
// reference matrix_operations.py:84-89, 102-105): for a 2000-row window it
// touches every byte of every title/description/tag.  The Python fallback
// (data/features.py) does the same work ~30x slower.
//
// Hash = CRC32 (zlib polynomial), bit-for-bit identical to the Python
// fallback's zlib.crc32, so both paths produce identical tensors and the
// parity tests can assert exact equality.
//
// The port's copy of mused_tpu/native/hasher.cpp (same code, same ABI).
// Built at first use by mused_tpu_torch/native/__init__.py with the host C++
// compiler into mused_tpu_torch/_build/; plain C ABI, consumed via ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// CRC table built ONCE at dlopen time (dynamic init of a namespace-scope
// const — dlopen serializes initializers): the previous lazy build behind a
// plain bool flag raced the two documented featurize prefetch threads
// (ctypes releases the GIL), risking silently wrong hashes on first use
// (review r5)
struct CrcTable {
    uint32_t t[256];
    CrcTable() {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i;
            for (int k = 0; k < 8; k++)
                c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
            t[i] = c;
        }
    }
};
const CrcTable kCrc;
const uint32_t* const crc_table = kCrc.t;

inline uint32_t crc32_bytes(const char* data, size_t len) {
    uint32_t c = 0xFFFFFFFFu;
    for (size_t i = 0; i < len; i++)
        c = crc_table[(c ^ static_cast<unsigned char>(data[i])) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

inline bool is_token_char(char ch) {
    return (ch >= 'a' && ch <= 'z') || (ch >= '0' && ch <= '9');
}

inline char to_lower_ascii(char ch) {
    return (ch >= 'A' && ch <= 'Z') ? char(ch + 32) : ch;
}

}  // namespace

extern "C" {



// Sparse emitters: per row, up to T distinct hashed token ids (+ counts for
// text).  A tiny open-addressing table dedups within the row.  Overflowing
// rows drop extra DISTINCT tokens (rare: T is sized above realistic token
// counts); out_ids is pre-filled with -1 by the caller.

static const int kProbe = 2;   // linear probing stride



// ---------------------------------------------------------------------------
// Packed-blob ABI (v2): one NUL-separated UTF-8 blob for all n rows instead
// of an array of n C-string pointers.  The per-string ctypes c_char_p
// marshalling (a Python object + pointer per row) dominated the v1 call cost
// at window scale; here Python does ONE join + ONE encode and passes two
// scalars and one buffer.  Row walk: rows are separated by '\0' (n rows,
// n-1 separators; the caller guarantees no embedded NULs).
// ---------------------------------------------------------------------------

namespace {

// advance to the end of the current row: [*pos, end) of blob
inline int64_t row_end(const char* blob, int64_t blob_len, int64_t start) {
    int64_t p = start;
    while (p < blob_len && blob[p] != '\0') p++;
    return p;
}

}  // namespace

void mused_hash_text_counts_packed(const char* blob, int64_t blob_len,
                                   int64_t n, int64_t dim, float* out) {
    int64_t pos = 0;
    for (int64_t i = 0; i < n; i++) {
        const int64_t end = row_end(blob, blob_len, pos);
        float* row = out + i * dim;
        uint32_t crc = 0xFFFFFFFFu;
        size_t tok_len = 0;
        for (int64_t p = pos; p <= end; p++) {
            char ch = (p < end) ? to_lower_ascii(blob[p]) : '\0';
            if (ch && is_token_char(ch)) {
                crc = crc_table[(crc ^ static_cast<unsigned char>(ch)) & 0xFF]
                      ^ (crc >> 8);
                tok_len++;
            } else {
                if (tok_len >= 2)
                    row[(crc ^ 0xFFFFFFFFu) % dim] += 1.0f;
                crc = 0xFFFFFFFFu;
                tok_len = 0;
            }
        }
        pos = end + 1;
    }
}

void mused_multihot_tags_packed(const char* blob, int64_t blob_len,
                                int64_t n, int64_t dim, float* out) {
    int64_t pos = 0;
    for (int64_t i = 0; i < n; i++) {
        const int64_t end = row_end(blob, blob_len, pos);
        float* row = out + i * dim;
        int64_t start = pos;
        for (int64_t p = pos; p <= end; p++) {
            if (p == end || blob[p] == '\x1f') {
                if (p > start)
                    row[crc32_bytes(blob + start, size_t(p - start)) % dim]
                        = 1.0f;
                start = p + 1;
            }
        }
        pos = end + 1;
    }
}

void mused_hash_text_sparse_packed(const char* blob, int64_t blob_len,
                                   int64_t n, int64_t dim, int64_t t_cap,
                                   int32_t* out_ids, uint16_t* out_cnt)
try {
    // no exception may cross the ctypes boundary (same rule as the
    // parser); on the ~unreachable alloc failure the pre-filled -1/-0
    // outputs stand (an empty window's features), not a process abort
    const int64_t tab_size = t_cap * 4;
    std::vector<int32_t> tab_id_v(tab_size), tab_slot_v(tab_size);
    int32_t* tab_id = tab_id_v.data();
    int32_t* tab_slot = tab_slot_v.data();
    int64_t pos = 0;
    for (int64_t i = 0; i < n; i++) {
        const int64_t end = row_end(blob, blob_len, pos);
        int32_t* ids = out_ids + i * t_cap;
        uint16_t* cnt = out_cnt + i * t_cap;
        for (int64_t q = 0; q < tab_size; q++) tab_id[q] = -1;
        int64_t used = 0;
        uint32_t crc = 0xFFFFFFFFu;
        size_t tok_len = 0;
        for (int64_t p = pos; p <= end; p++) {
            char ch = (p < end) ? to_lower_ascii(blob[p]) : '\0';
            if (ch && is_token_char(ch)) {
                crc = crc_table[(crc ^ static_cast<unsigned char>(ch)) & 0xFF]
                      ^ (crc >> 8);
                tok_len++;
            } else {
                if (tok_len >= 2) {
                    int32_t id = int32_t((crc ^ 0xFFFFFFFFu) % uint32_t(dim));
                    int64_t h = (uint32_t(id) * 2654435761u) % tab_size;
                    for (;;) {
                        if (tab_id[h] == id) {
                            if (cnt[tab_slot[h]] < 65535) cnt[tab_slot[h]]++;
                            break;
                        }
                        if (tab_id[h] == -1) {
                            if (used < t_cap) {
                                tab_id[h] = id;
                                tab_slot[h] = int32_t(used);
                                ids[used] = id;
                                cnt[used] = 1;
                                used++;
                            }
                            break;
                        }
                        h = (h + kProbe) % tab_size;
                    }
                }
                crc = 0xFFFFFFFFu;
                tok_len = 0;
            }
        }
        pos = end + 1;
    }
} catch (...) {
    return;
}

void mused_multihot_tags_sparse_packed(const char* blob, int64_t blob_len,
                                       int64_t n, int64_t dim, int64_t t_cap,
                                       int32_t* out_ids) {
    int64_t pos = 0;
    for (int64_t i = 0; i < n; i++) {
        const int64_t end = row_end(blob, blob_len, pos);
        int32_t* ids = out_ids + i * t_cap;
        int64_t used = 0;
        int64_t start = pos;
        for (int64_t p = pos; p <= end; p++) {
            if (p == end || blob[p] == '\x1f') {
                if (p > start && used < t_cap) {
                    int32_t id = int32_t(
                        crc32_bytes(blob + start, size_t(p - start))
                        % uint32_t(dim));
                    bool dup = false;
                    for (int64_t q = 0; q < used; q++)
                        if (ids[q] == id) { dup = true; break; }
                    if (!dup) ids[used++] = id;
                }
                start = p + 1;
            }
        }
        pos = end + 1;
    }
}

}  // extern "C"
