// Native key→slot table: the host-side hot path of the tick engine.
//
// The engine's device kernel is fast; what bounds end-to-end throughput is
// the per-request host work of resolving string keys to table slots (the
// role the reference's Go map + worker hash routing plays, lrucache.go /
// workers.go:180-184).  This is that path in C++: an open-addressing hash
// table (fnv1a, linear probing, tombstones) over a fixed slot arena, with a
// batch API so one C call resolves a whole tick's keys.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int64_t kEmpty = -1;
constexpr int64_t kTomb = -2;

inline uint64_t fnv1a(const char* data, int64_t len) {
  uint64_t h = 0xcbf29ce484222325ULL;
  for (int64_t i = 0; i < len; ++i) {
    h ^= static_cast<unsigned char>(data[i]);
    h *= 0x100000001b3ULL;
  }
  return h;
}

inline uint64_t next_pow2(uint64_t v) {
  v--;
  v |= v >> 1; v |= v >> 2; v |= v >> 4;
  v |= v >> 8; v |= v >> 16; v |= v >> 32;
  return v + 1;
}

struct SlotMap {
  int64_t capacity;              // number of slots
  uint64_t mask;                 // hash table size - 1 (pow2, ≥ 2*capacity)
  std::vector<int64_t> table;    // hash bucket → slot | kEmpty | kTomb
  std::vector<uint64_t> hashes;  // per-bucket cached hash (valid when slot ≥ 0)
  std::vector<std::string> keys; // per-slot key (empty = unassigned)
  std::vector<int64_t> free_list;
  int64_t count = 0;
  int64_t tombs = 0;

  explicit SlotMap(int64_t cap) : capacity(cap) {
    uint64_t tsize = next_pow2(static_cast<uint64_t>(cap) * 2 + 16);
    mask = tsize - 1;
    table.assign(tsize, kEmpty);
    hashes.assign(tsize, 0);
    keys.resize(cap);
    free_list.reserve(cap);
    for (int64_t s = cap - 1; s >= 0; --s) free_list.push_back(s);
  }

  // Find the bucket holding key, or the first insertable bucket.
  // Returns (bucket, found).
  std::pair<uint64_t, bool> probe(const char* key, int64_t len,
                                  uint64_t h) const {
    uint64_t idx = h & mask;
    uint64_t first_tomb = UINT64_MAX;
    for (;;) {
      int64_t s = table[idx];
      if (s == kEmpty) {
        return {first_tomb != UINT64_MAX ? first_tomb : idx, false};
      }
      if (s == kTomb) {
        if (first_tomb == UINT64_MAX) first_tomb = idx;
      } else if (hashes[idx] == h &&
                 keys[s].size() == static_cast<size_t>(len) &&
                 std::memcmp(keys[s].data(), key, len) == 0) {
        return {idx, true};
      }
      idx = (idx + 1) & mask;
    }
  }

  void maybe_rehash() {
    // Tombstone buildup degrades probes; rebuild in place when they
    // outnumber live entries.
    if (tombs < static_cast<int64_t>(mask / 4)) return;
    std::fill(table.begin(), table.end(), kEmpty);
    tombs = 0;
    for (int64_t s = 0; s < capacity; ++s) {
      if (keys[s].empty()) continue;
      uint64_t h = fnv1a(keys[s].data(), keys[s].size());
      uint64_t idx = h & mask;
      while (table[idx] >= 0) idx = (idx + 1) & mask;
      table[idx] = s;
      hashes[idx] = h;
    }
  }

  int64_t get(const char* key, int64_t len) const {
    auto [idx, found] = probe(key, len, fnv1a(key, len));
    return found ? table[idx] : -1;
  }

  int64_t assign(const char* key, int64_t len) {
    uint64_t h = fnv1a(key, len);
    auto [idx, found] = probe(key, len, h);
    if (found) return table[idx];
    if (free_list.empty()) return -1;
    int64_t s = free_list.back();
    free_list.pop_back();
    if (table[idx] == kTomb) --tombs;
    table[idx] = s;
    hashes[idx] = h;
    keys[s].assign(key, len);
    ++count;
    return s;
  }

  void release(int64_t slot) {
    if (slot < 0 || slot >= capacity || keys[slot].empty()) return;
    uint64_t h = fnv1a(keys[slot].data(), keys[slot].size());
    auto [idx, found] = probe(keys[slot].data(), keys[slot].size(), h);
    if (found) {
      table[idx] = kTomb;
      ++tombs;
    }
    keys[slot].clear();
    free_list.push_back(slot);
    --count;
    maybe_rehash();
  }
};

}  // namespace

extern "C" {

void* guber_slotmap_new(int64_t capacity) { return new SlotMap(capacity); }

void guber_slotmap_free(void* p) { delete static_cast<SlotMap*>(p); }

int64_t guber_slotmap_get(void* p, const char* key, int64_t len) {
  return static_cast<SlotMap*>(p)->get(key, len);
}

int64_t guber_slotmap_assign(void* p, const char* key, int64_t len) {
  return static_cast<SlotMap*>(p)->assign(key, len);
}

void guber_slotmap_release(void* p, int64_t slot) {
  static_cast<SlotMap*>(p)->release(slot);
}

int64_t guber_slotmap_size(void* p) { return static_cast<SlotMap*>(p)->count; }

// Copy slot's key into buf (≤ buflen bytes); returns key length or -1.
int64_t guber_slotmap_key_of(void* p, int64_t slot, char* buf, int64_t buflen) {
  auto* m = static_cast<SlotMap*>(p);
  if (slot < 0 || slot >= m->capacity || m->keys[slot].empty()) return -1;
  const std::string& k = m->keys[slot];
  int64_t n = static_cast<int64_t>(k.size());
  if (n > buflen) return -1;
  std::memcpy(buf, k.data(), n);
  return n;
}

// Batch resolve: keys arrive as one concatenated blob with n+1 offsets.
// out_slots[i] = slot (or -1 when the table is full); out_known[i] = 1 when
// the key already had a mapping.  One call per tick replaces n dict lookups.
void guber_slotmap_resolve_batch(void* p, const char* blob,
                                 const int64_t* offsets, int64_t n,
                                 int64_t* out_slots, uint8_t* out_known) {
  auto* m = static_cast<SlotMap*>(p);
  for (int64_t i = 0; i < n; ++i) {
    const char* key = blob + offsets[i];
    int64_t len = offsets[i + 1] - offsets[i];
    int64_t existing = m->get(key, len);
    if (existing >= 0) {
      out_slots[i] = existing;
      out_known[i] = 1;
    } else {
      out_slots[i] = m->assign(key, len);
      out_known[i] = 0;
    }
  }
}

// Batch lookup without assignment: out_slots[i] = the key's slot, or -1
// when the key has none (lease windows skip keys that are not resident).
void guber_slotmap_lookup_batch(void* p, const char* blob,
                                const int64_t* offsets, int64_t n,
                                int64_t* out_slots) {
  auto* m = static_cast<SlotMap*>(p);
  for (int64_t i = 0; i < n; ++i) {
    out_slots[i] = m->get(blob + offsets[i], offsets[i + 1] - offsets[i]);
  }
}

// Fill out[slot] = 1 for every slot that currently has a key (the engine's
// reclaim scan wants the live-slot mask as one array).
void guber_slotmap_mapped(void* p, uint8_t* out) {
  auto* m = static_cast<SlotMap*>(p);
  for (int64_t s = 0; s < m->capacity; ++s) out[s] = !m->keys[s].empty();
}

// Release a batch of slots in one call (reclaim's victim free list; the
// per-slot ctypes round trip dominates at 10M-slot scale otherwise).
void guber_slotmap_release_batch(void* p, const int64_t* slots, int64_t n) {
  auto* m = static_cast<SlotMap*>(p);
  for (int64_t i = 0; i < n; ++i) m->release(slots[i]);
}

// Copy the keys of n slots into one concatenated blob + n+1 offsets
// (snapshot export).  Returns total bytes required; when that exceeds
// blob_cap nothing is written and the caller retries with a bigger buffer.
// Unassigned slots contribute zero-length spans.
int64_t guber_slotmap_keys_batch(void* p, const int64_t* slots, int64_t n,
                                 char* blob, int64_t blob_cap,
                                 int64_t* offsets) {
  auto* m = static_cast<SlotMap*>(p);
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t s = slots[i];
    if (s >= 0 && s < m->capacity) total += m->keys[s].size();
  }
  if (total > blob_cap) return total;
  int64_t off = 0;
  for (int64_t i = 0; i < n; ++i) {
    offsets[i] = off;
    int64_t s = slots[i];
    if (s >= 0 && s < m->capacity && !m->keys[s].empty()) {
      std::memcpy(blob + off, m->keys[s].data(), m->keys[s].size());
      off += m->keys[s].size();
    }
  }
  offsets[n] = off;
  return total;
}

// Assign a batch of keys (snapshot restore); out_slots[i] = slot or -1 when
// the table is full.
void guber_slotmap_assign_batch(void* p, const char* blob,
                                const int64_t* offsets, int64_t n,
                                int64_t* out_slots) {
  auto* m = static_cast<SlotMap*>(p);
  for (int64_t i = 0; i < n; ++i) {
    out_slots[i] = m->assign(blob + offsets[i], offsets[i + 1] - offsets[i]);
  }
}

// CRC-32 (ISO-HDLC: poly 0xEDB88320, init and xorout 0xFFFFFFFF) of each key
// of a packed blob, bit-identical to Python's zlib.crc32, which defines the
// mesh engine's key -> shard route.  One call replaces a per-key Python
// loop on the columnar submit path.
static uint32_t crc32_table[256];
static bool crc32_init_done = [] {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc32_table[i] = c;
  }
  return true;
}();

void guber_crc32_batch(const char* blob, const int64_t* offsets, int64_t n,
                       uint32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t c = 0xFFFFFFFFu;
    for (int64_t j = offsets[i]; j < offsets[i + 1]; ++j) {
      c = crc32_table[(c ^ static_cast<uint8_t>(blob[j])) & 0xFFu] ^ (c >> 8);
    }
    out[i] = c ^ 0xFFFFFFFFu;
  }
}

}  // extern "C"
