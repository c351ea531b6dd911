// Byte-trie tokenizer core for the RWKV world vocabulary.
//
// Native counterpart of rwkv_tts_tpu_torch/tokenizer/rwkv_tokenizer.py (the
// PyTorch port's own copy of native/rwkv_trie.cpp) — the
// reference's tokenizer runs inside the Rust web-rwkv crate; here the hot
// greedy-longest-match loop is C++ behind a ctypes boundary (the Python
// implementation remains as a portable fallback and as the behavioral
// oracle in tests).
//
// Vocab blob format (little-endian), built by rwkv_tts_tpu_torch/utils/native.py:
//   u32 n_entries
//   n_entries × { u32 token_id; u32 byte_len; u8 bytes[byte_len] }
// Entries are streamed in ascending id order; on duplicate byte sequences
// the later (higher) id overwrites — identical to the Python trie.
//
// Build: g++ -O2 -shared -fPIC -o librwkv_trie.so rwkv_trie.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Node {
    // Sparse child table: parallel arrays sorted by byte, linear/binary mix.
    std::vector<uint8_t> keys;
    std::vector<int32_t> children;
    int32_t token_id = -1;

    int32_t find(uint8_t b) const {
        // vocab fan-out is small except at the root; linear scan wins for
        // short arrays, binary search for longer ones
        const size_t n = keys.size();
        if (n <= 8) {
            for (size_t i = 0; i < n; ++i)
                if (keys[i] == b) return children[i];
            return -1;
        }
        size_t lo = 0, hi = n;
        while (lo < hi) {
            size_t mid = (lo + hi) / 2;
            if (keys[mid] < b) lo = mid + 1;
            else hi = mid;
        }
        return (lo < n && keys[lo] == b) ? children[lo] : -1;
    }

    // register a NEW edge b -> child_idx (caller already knows find(b)
    // missed and has allocated child_idx in the pool)
    void add_child(uint8_t b, int32_t child_idx) {
        size_t lo = 0, hi = keys.size();
        while (lo < hi) {
            size_t mid = (lo + hi) / 2;
            if (keys[mid] < b) lo = mid + 1;
            else hi = mid;
        }
        keys.insert(keys.begin() + lo, b);
        children.insert(children.begin() + lo, child_idx);
    }
};

struct Trie {
    std::vector<Node> nodes;

    Trie() { nodes.emplace_back(); }

    void insert(const uint8_t* bytes, uint32_t len, int32_t id) {
        int32_t cur = 0;
        for (uint32_t i = 0; i < len; ++i) {
            int32_t nxt = nodes[cur].find(bytes[i]);
            if (nxt < 0) {
                int32_t allocated = static_cast<int32_t>(nodes.size());
                // register the edge BEFORE growing the pool (emplace_back
                // may reallocate and invalidate node references)
                nodes[cur].add_child(bytes[i], allocated);
                nodes.emplace_back();
                nxt = allocated;
            }
            cur = nxt;
        }
        nodes[cur].token_id = id;  // later ids overwrite (parity w/ Python)
    }

    int64_t encode(const uint8_t* data, size_t len, int32_t* out,
                   size_t out_cap) const {
        size_t i = 0, n_out = 0;
        while (i < len) {
            int32_t node = 0;
            int32_t best_id = -1;
            size_t best_len = 0;
            size_t j = i;
            while (j < len) {
                node = nodes[node].find(data[j]);
                if (node < 0) break;
                ++j;
                const int32_t tid = nodes[node].token_id;
                if (tid >= 0) {
                    best_id = tid;
                    best_len = j - i;
                }
            }
            if (best_id < 0) {
                ++i;  // unrepresentable byte: skip (total function, parity)
                continue;
            }
            if (n_out >= out_cap) return -static_cast<int64_t>(n_out) - 1;
            out[n_out++] = best_id;
            i += best_len;
        }
        return static_cast<int64_t>(n_out);
    }
};

}  // namespace

extern "C" {

void* rwkv_trie_create(const uint8_t* blob, size_t blob_len) {
    if (blob_len < 4) return nullptr;
    auto* t = new Trie();
    size_t pos = 0;
    uint32_t n;
    std::memcpy(&n, blob + pos, 4);
    pos += 4;
    for (uint32_t e = 0; e < n; ++e) {
        if (pos + 8 > blob_len) { delete t; return nullptr; }
        uint32_t id, len;
        std::memcpy(&id, blob + pos, 4);
        std::memcpy(&len, blob + pos + 4, 4);
        pos += 8;
        if (pos + len > blob_len) { delete t; return nullptr; }
        t->insert(blob + pos, len, static_cast<int32_t>(id));
        pos += len;
    }
    return t;
}

void rwkv_trie_destroy(void* trie) { delete static_cast<Trie*>(trie); }

int64_t rwkv_trie_encode(const void* trie, const uint8_t* text, size_t len,
                         int32_t* out, size_t out_cap) {
    return static_cast<const Trie*>(trie)->encode(text, len, out, out_cap);
}

}  // extern "C"
