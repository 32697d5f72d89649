// Native protobuf wire codec of the serving path (the port's copy of
// the JAX package's native/wirecodec.cc, built by _build.py with c++).
//
// It parses a serialized GetRateLimitsReq straight into int64 columns and
// a packed key blob (the ReqColumns layout, ops/reqcols.py) and writes
// the GetRateLimitsResp wire bytes straight from the (5, n) response
// matrix, with no protobuf message objects on either side.
//
// Wire contract (gubernator.proto; field numbers preserved from the
// reference's python/gubernator/gubernator.proto):
//
//   GetRateLimitsReq:  1 repeated RateLimitReq (len-delimited)
//   RateLimitReq:      1 name (string), 2 unique_key (string),
//                      3 hits, 4 limit, 5 duration (varint int64),
//                      6 algorithm, 7 behavior (varint enum),
//                      8 burst (varint int64), 9 metadata (map),
//                      10 created_at (optional varint int64)
//   GetRateLimitsResp: 1 repeated RateLimitResp (len-delimited)
//   RateLimitResp:     1 status (varint enum), 2 limit, 3 remaining,
//                      4 reset_time (varint int64), 5 error (string),
//                      6 metadata (map)
//
// Unknown fields are skipped by wire type (forward compatibility, the
// same guarantee protobuf gives).  Malformed input returns a negative
// count.

#include <cstdint>
#include <cstring>

namespace {

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end && shift < 64) {
      uint8_t b = *p++;
      v |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
    ok = false;
    return 0;
  }

  // Skip one field of the given wire type; groups (3/4) and unknown
  // types are malformed here.
  void skip(uint32_t wt) {
    switch (wt) {
      case 0: varint(); break;
      case 1: if (end - p < 8) ok = false; else p += 8; break;
      case 2: {
        uint64_t n = varint();
        if (!ok || static_cast<uint64_t>(end - p) < n) { ok = false; break; }
        p += n;
        break;
      }
      case 5: if (end - p < 4) ok = false; else p += 4; break;
      default: ok = false;
    }
  }
};

struct Writer {
  uint8_t* p;
  uint8_t* end;
  bool ok = true;

  void varint(uint64_t v) {
    while (true) {
      if (p >= end) { ok = false; return; }
      if (v < 0x80) { *p++ = static_cast<uint8_t>(v); return; }
      *p++ = static_cast<uint8_t>(v) | 0x80;
      v >>= 7;
    }
  }

  void bytes(const uint8_t* src, int64_t n) {
    if (end - p < n) { ok = false; return; }
    std::memcpy(p, src, n);
    p += n;
  }
};

inline int varint_size(uint64_t v) {
  int n = 1;
  while (v >= 0x80) { v >>= 7; ++n; }
  return n;
}

}  // namespace

extern "C" {

// Flag bits in out_flags.
enum : uint8_t {
  kNameEmpty = 1,
  kKeyEmpty = 2,
  kHasMetadata = 4,
  kHasCreatedAt = 8,
};

// Count the repeated field-1 submessages of a GetRateLimitsReq /
// GetRateLimitsResp (identical outer shape).  Returns -1 on malformed
// input.
int64_t guber_wire_count(const uint8_t* buf, int64_t len) {
  Reader r{buf, buf + len};
  int64_t n = 0;
  while (r.p < r.end) {
    uint64_t tag = r.varint();
    if (!r.ok) return -1;
    if (tag == ((1u << 3) | 2)) {
      uint64_t sz = r.varint();
      if (!r.ok || static_cast<uint64_t>(r.end - r.p) < sz) return -1;
      r.p += sz;
      ++n;
    } else {
      r.skip(tag & 7);
      if (!r.ok) return -1;
    }
  }
  return n;
}

// Parse a serialized GetRateLimitsReq into columns.
//
//   key_blob   caller buffer of at least len + n bytes ("name_unique");
//   key_off    (n+1) int64 offsets into key_blob;
//   name_len   n int64: byte length of the name part of each key (the
//              '_' splitter position — lets an encoder reconstruct the
//              two wire fields from the packed key);
//   cols       7 arrays of n int64: hits, limit, duration, algorithm,
//              behavior, burst, created_at (created_at left as-is where
//              absent — caller pre-fills the sentinel);
//   out_flags  n uint8 of kNameEmpty/kKeyEmpty/kHasMetadata/kHasCreatedAt.
//
// Returns the number of requests parsed (== guber_wire_count) or -1 on
// malformed input.  Metadata contents are NOT decoded (the caller routes
// metadata-bearing batches to the object path, which re-parses with
// protobuf); only presence is recorded.
int64_t guber_parse_req(const uint8_t* buf, int64_t len,
                        uint8_t* key_blob, int64_t key_cap,
                        int64_t* key_off, int64_t* name_len_out,
                        int64_t* hits, int64_t* limit, int64_t* duration,
                        int64_t* algorithm, int64_t* behavior,
                        int64_t* burst, int64_t* created_at,
                        uint8_t* out_flags) {
  Reader outer{buf, buf + len};
  int64_t n = 0;
  int64_t blob_at = 0;
  key_off[0] = 0;
  while (outer.p < outer.end) {
    uint64_t tag = outer.varint();
    if (!outer.ok) return -1;
    if (tag != ((1u << 3) | 2)) {
      outer.skip(tag & 7);
      if (!outer.ok) return -1;
      continue;
    }
    uint64_t sz = outer.varint();
    if (!outer.ok || static_cast<uint64_t>(outer.end - outer.p) < sz)
      return -1;
    Reader r{outer.p, outer.p + sz};
    outer.p += sz;

    const uint8_t* name_p = nullptr;
    int64_t name_n = 0;
    const uint8_t* key_p = nullptr;
    int64_t key_n = 0;
    uint8_t flags = 0;
    while (r.p < r.end) {
      uint64_t t = r.varint();
      if (!r.ok) return -1;
      uint32_t field = static_cast<uint32_t>(t >> 3);
      uint32_t wt = t & 7;
      if (wt == 2 && (field == 1 || field == 2 || field == 9)) {
        uint64_t fn = r.varint();
        if (!r.ok || static_cast<uint64_t>(r.end - r.p) < fn) return -1;
        if (field == 1) { name_p = r.p; name_n = fn; }
        else if (field == 2) { key_p = r.p; key_n = fn; }
        else flags |= kHasMetadata;
        r.p += fn;
      } else if (wt == 0 && field >= 3 && field <= 10 && field != 9) {
        uint64_t v = r.varint();
        if (!r.ok) return -1;
        int64_t sv = static_cast<int64_t>(v);
        switch (field) {
          case 3: hits[n] = sv; break;
          case 4: limit[n] = sv; break;
          case 5: duration[n] = sv; break;
          case 6: algorithm[n] = sv; break;
          case 7: behavior[n] = sv; break;
          case 8: burst[n] = sv; break;
          case 10: created_at[n] = sv; flags |= kHasCreatedAt; break;
        }
      } else {
        r.skip(wt);
        if (!r.ok) return -1;
      }
    }
    if (name_n == 0) flags |= kNameEmpty;
    if (key_n == 0) flags |= kKeyEmpty;
    name_len_out[n] = name_n;
    if (!(flags & (kNameEmpty | kKeyEmpty))) {
      if (blob_at + name_n + 1 + key_n > key_cap) return -1;
      std::memcpy(key_blob + blob_at, name_p, name_n);
      blob_at += name_n;
      key_blob[blob_at++] = '_';
      std::memcpy(key_blob + blob_at, key_p, key_n);
      blob_at += key_n;
    }
    out_flags[n] = flags;
    ++n;
    key_off[n] = blob_at;
  }
  return n;
}

// Parse a serialized GetRateLimitsResp (or GetPeerRateLimitsResp — same
// shape, field 1 repeated RateLimitResp) into a (5, n) column block:
// status, limit, remaining, reset_time, and a has-error flag (1 when the
// item carries a non-empty error string or metadata — the caller
// re-parses those rare items with protobuf for the strings).
// Returns n or -1 on malformed input.
int64_t guber_parse_resp(const uint8_t* buf, int64_t len,
                         int64_t* status, int64_t* limit,
                         int64_t* remaining, int64_t* reset_time,
                         uint8_t* special) {
  Reader outer{buf, buf + len};
  int64_t n = 0;
  while (outer.p < outer.end) {
    uint64_t tag = outer.varint();
    if (!outer.ok) return -1;
    if (tag != ((1u << 3) | 2)) {
      outer.skip(tag & 7);
      if (!outer.ok) return -1;
      continue;
    }
    uint64_t sz = outer.varint();
    if (!outer.ok || static_cast<uint64_t>(outer.end - outer.p) < sz)
      return -1;
    Reader r{outer.p, outer.p + sz};
    outer.p += sz;
    status[n] = limit[n] = remaining[n] = reset_time[n] = 0;
    special[n] = 0;
    while (r.p < r.end) {
      uint64_t t = r.varint();
      if (!r.ok) return -1;
      uint32_t field = static_cast<uint32_t>(t >> 3);
      uint32_t wt = t & 7;
      if (wt == 0 && field >= 1 && field <= 4) {
        uint64_t v = r.varint();
        if (!r.ok) return -1;
        int64_t sv = static_cast<int64_t>(v);
        switch (field) {
          case 1: status[n] = sv; break;
          case 2: limit[n] = sv; break;
          case 3: remaining[n] = sv; break;
          case 4: reset_time[n] = sv; break;
        }
      } else if (wt == 2 && (field == 5 || field == 6)) {
        uint64_t fn = r.varint();
        if (!r.ok || static_cast<uint64_t>(r.end - r.p) < fn) return -1;
        if (fn > 0) special[n] = 1;
        r.p += fn;
      } else {
        r.skip(wt);
        if (!r.ok) return -1;
      }
    }
    ++n;
  }
  return n;
}

// Serialize a GetRateLimitsReq (or GetPeerRateLimitsReq — same shape)
// from columns.  Key blob carries "name_unique" per request with the
// SPLIT position given separately (name_len[i]); proto3 zero-valued
// scalar fields are omitted; created_at is written when has_created[i]
// (optional presence).  Returns bytes written, or -needed when the
// buffer is too small (caller retries with a bigger one), or -1 on
// internal error.
int64_t guber_encode_req(const uint8_t* key_blob, const int64_t* key_off,
                         const int64_t* name_len,
                         const int64_t* hits, const int64_t* limit,
                         const int64_t* duration, const int64_t* algorithm,
                         const int64_t* behavior, const int64_t* burst,
                         const int64_t* created_at,
                         const uint8_t* has_created,
                         int64_t n, uint8_t* out, int64_t out_cap) {
  // Sizing pass.
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t nm = name_len[i];
    int64_t uk = key_off[i + 1] - key_off[i] - nm - 1;
    if (uk < 0) return -1;
    int64_t sz = 0;
    if (nm) sz += 1 + varint_size(nm) + nm;
    if (uk) sz += 1 + varint_size(uk) + uk;
    if (hits[i]) sz += 1 + varint_size(static_cast<uint64_t>(hits[i]));
    if (limit[i]) sz += 1 + varint_size(static_cast<uint64_t>(limit[i]));
    if (duration[i])
      sz += 1 + varint_size(static_cast<uint64_t>(duration[i]));
    if (algorithm[i])
      sz += 1 + varint_size(static_cast<uint64_t>(algorithm[i]));
    if (behavior[i])
      sz += 1 + varint_size(static_cast<uint64_t>(behavior[i]));
    if (burst[i]) sz += 1 + varint_size(static_cast<uint64_t>(burst[i]));
    if (has_created[i])
      sz += 1 + varint_size(static_cast<uint64_t>(created_at[i]));
    total += 1 + varint_size(sz) + sz;
  }
  if (total > out_cap) return -total;

  Writer w{out, out + out_cap};
  for (int64_t i = 0; i < n; ++i) {
    int64_t nm = name_len[i];
    int64_t uk = key_off[i + 1] - key_off[i] - nm - 1;
    const uint8_t* base = key_blob + key_off[i];
    int64_t sz = 0;
    if (nm) sz += 1 + varint_size(nm) + nm;
    if (uk) sz += 1 + varint_size(uk) + uk;
    if (hits[i]) sz += 1 + varint_size(static_cast<uint64_t>(hits[i]));
    if (limit[i]) sz += 1 + varint_size(static_cast<uint64_t>(limit[i]));
    if (duration[i])
      sz += 1 + varint_size(static_cast<uint64_t>(duration[i]));
    if (algorithm[i])
      sz += 1 + varint_size(static_cast<uint64_t>(algorithm[i]));
    if (behavior[i])
      sz += 1 + varint_size(static_cast<uint64_t>(behavior[i]));
    if (burst[i]) sz += 1 + varint_size(static_cast<uint64_t>(burst[i]));
    if (has_created[i])
      sz += 1 + varint_size(static_cast<uint64_t>(created_at[i]));

    w.varint((1u << 3) | 2);
    w.varint(sz);
    if (nm) { w.varint((1u << 3) | 2); w.varint(nm); w.bytes(base, nm); }
    if (uk) {
      w.varint((2u << 3) | 2);
      w.varint(uk);
      w.bytes(base + nm + 1, uk);
    }
    if (hits[i]) {
      w.varint((3u << 3) | 0);
      w.varint(static_cast<uint64_t>(hits[i]));
    }
    if (limit[i]) {
      w.varint((4u << 3) | 0);
      w.varint(static_cast<uint64_t>(limit[i]));
    }
    if (duration[i]) {
      w.varint((5u << 3) | 0);
      w.varint(static_cast<uint64_t>(duration[i]));
    }
    if (algorithm[i]) {
      w.varint((6u << 3) | 0);
      w.varint(static_cast<uint64_t>(algorithm[i]));
    }
    if (behavior[i]) {
      w.varint((7u << 3) | 0);
      w.varint(static_cast<uint64_t>(behavior[i]));
    }
    if (burst[i]) {
      w.varint((8u << 3) | 0);
      w.varint(static_cast<uint64_t>(burst[i]));
    }
    if (has_created[i]) {
      w.varint((10u << 3) | 0);
      w.varint(static_cast<uint64_t>(created_at[i]));
    }
    if (!w.ok) return -1;
  }
  return w.p - out;
}

// Serialize a GetRateLimitsResp from the engine's (5, n) response
// matrix rows (status, limit, remaining, reset_time; row 4 over_limit is
// not a wire field).  Proto3 zero-omission matches the protobuf library
// byte for byte for items with no error/metadata.  Returns bytes
// written or -needed when out_cap is too small.
int64_t guber_encode_resp(const int64_t* status, const int64_t* limit,
                          const int64_t* remaining,
                          const int64_t* reset_time,
                          int64_t n, uint8_t* out, int64_t out_cap) {
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t sz = 0;
    if (status[i]) sz += 1 + varint_size(static_cast<uint64_t>(status[i]));
    if (limit[i]) sz += 1 + varint_size(static_cast<uint64_t>(limit[i]));
    if (remaining[i])
      sz += 1 + varint_size(static_cast<uint64_t>(remaining[i]));
    if (reset_time[i])
      sz += 1 + varint_size(static_cast<uint64_t>(reset_time[i]));
    total += 1 + varint_size(sz) + sz;
  }
  if (total > out_cap) return -total;
  Writer w{out, out + out_cap};
  for (int64_t i = 0; i < n; ++i) {
    int64_t sz = 0;
    if (status[i]) sz += 1 + varint_size(static_cast<uint64_t>(status[i]));
    if (limit[i]) sz += 1 + varint_size(static_cast<uint64_t>(limit[i]));
    if (remaining[i])
      sz += 1 + varint_size(static_cast<uint64_t>(remaining[i]));
    if (reset_time[i])
      sz += 1 + varint_size(static_cast<uint64_t>(reset_time[i]));
    w.varint((1u << 3) | 2);
    w.varint(sz);
    if (status[i]) {
      w.varint((1u << 3) | 0);
      w.varint(static_cast<uint64_t>(status[i]));
    }
    if (limit[i]) {
      w.varint((2u << 3) | 0);
      w.varint(static_cast<uint64_t>(limit[i]));
    }
    if (remaining[i]) {
      w.varint((3u << 3) | 0);
      w.varint(static_cast<uint64_t>(remaining[i]));
    }
    if (reset_time[i]) {
      w.varint((4u << 3) | 0);
      w.varint(static_cast<uint64_t>(reset_time[i]));
    }
    if (!w.ok) return -1;
  }
  return w.p - out;
}

}  // extern "C"
