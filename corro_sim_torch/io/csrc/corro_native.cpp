// corro_native: host-side hot paths in C++.
//
// The reference's native layer is the CR-SQLite C extension plus SQLite
// itself (SURVEY §2.1); the byte-level pk codec (pack_columns /
// unpack_columns, corro-types/src/pubsub.rs:2388-2536) is the contract
// between that native layer and every changeset that crosses the wire.
// Replaying a large trace decodes one pk blob per change row — a pure
// byte-crunching loop with no tensor math, i.e. exactly the kind of work
// that belongs in native code next to the device compute path.
//
// C ABI (ctypes-friendly, no C++ types across the boundary):
//   cn_unpack   — decode one blob into parallel tagged output arrays
//   cn_pack     — encode one tuple from parallel tagged input arrays
//   cn_unpack_batch — decode many concatenated blobs in one call
//
// Wire format (must match corro_sim_torch/io/columns.py bit for bit):
//   [num_columns: u8] then per column [type_byte: u8][payload…]
//   type_byte = (int_len << 3) | column_type; ints big-endian signed,
//   minimal-width with the reference's sign-extension quirk on read;
//   floats 8-byte BE IEEE-754; text/blob minimal-int length then bytes
//   (lengths decoded unsigned — see columns.py docstring).

#include <cstdint>
#include <cstring>

namespace {

constexpr uint8_t TYPE_INTEGER = 1;
constexpr uint8_t TYPE_FLOAT = 2;
constexpr uint8_t TYPE_TEXT = 3;
constexpr uint8_t TYPE_BLOB = 4;
constexpr uint8_t TYPE_NULL = 5;

// error codes (negative returns)
constexpr int64_t ERR_TRUNCATED = -1;
constexpr int64_t ERR_BAD_TYPE = -2;
constexpr int64_t ERR_CAPACITY = -3;
constexpr int64_t ERR_TOO_MANY = -4;

inline int min_int_len(uint64_t bits, int max_bytes) {
  for (int n = max_bytes; n > 1; --n) {
    if (bits & (0xFFull << ((n - 1) * 8))) return n;
  }
  return bits ? 1 : 0;
}

inline void put_be(uint8_t* dst, uint64_t v, int n) {
  for (int i = 0; i < n; ++i) dst[i] = (uint8_t)(v >> (8 * (n - 1 - i)));
}

// signed big-endian read with sign extension (bytes crate get_int)
inline int64_t get_be_signed(const uint8_t* p, int n) {
  if (n == 0) return 0;
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v = (v << 8) | p[i];
  int shift = 64 - 8 * n;
  return (int64_t)(v << shift) >> shift;  // arithmetic shift extends
}

}  // namespace

extern "C" {

// Decode one blob.
//   data/len       — the packed bytes
//   cap            — capacity of the output arrays (columns)
//   arena/arena_cap— byte arena receiving text/blob payloads
// Outputs (parallel, one entry per column):
//   types[i]  — TYPE_* tag
//   ints[i]   — integer value (TYPE_INTEGER)
//   floats[i] — double value (TYPE_FLOAT)
//   offs[i], lens_out[i] — arena slice (TEXT/BLOB)
// Returns number of columns decoded, or a negative error code.
int64_t cn_unpack(const uint8_t* data, uint64_t len, uint64_t cap,
                  uint8_t* types, int64_t* ints, double* floats,
                  uint64_t* offs, uint64_t* lens_out, uint8_t* arena,
                  uint64_t arena_cap, uint64_t* arena_used_io) {
  if (len < 1) return ERR_TRUNCATED;
  uint64_t num = data[0];
  if (num > cap) return ERR_CAPACITY;
  uint64_t pos = 1;
  uint64_t arena_used = *arena_used_io;
  for (uint64_t i = 0; i < num; ++i) {
    if (pos >= len) return ERR_TRUNCATED;
    uint8_t tb = data[pos++];
    uint8_t ctype = tb & 0x07;
    int ilen = tb >> 3;
    types[i] = ctype;
    ints[i] = 0;
    floats[i] = 0.0;
    offs[i] = 0;
    lens_out[i] = 0;
    switch (ctype) {
      case TYPE_NULL:
        break;
      case TYPE_INTEGER: {
        if (ilen > 8) return ERR_BAD_TYPE;  // no valid encoder emits >8
        if (pos + (uint64_t)ilen > len) return ERR_TRUNCATED;
        ints[i] = get_be_signed(data + pos, ilen);
        pos += ilen;
        break;
      }
      case TYPE_FLOAT: {
        if (pos + 8 > len) return ERR_TRUNCATED;
        uint64_t bits = 0;
        for (int b = 0; b < 8; ++b) bits = (bits << 8) | data[pos + b];
        double d;
        std::memcpy(&d, &bits, 8);
        floats[i] = d;
        pos += 8;
        break;
      }
      case TYPE_TEXT:
      case TYPE_BLOB: {
        if (ilen > 8) return ERR_BAD_TYPE;  // no valid encoder emits >8
        if (pos + (uint64_t)ilen > len) return ERR_TRUNCATED;
        int64_t sl = get_be_signed(data + pos, ilen);
        // lengths are unsigned on decode (columns.py fidelity note);
        // ilen == 8 reads the full word as unsigned (no shift by 64)
        uint64_t l = (uint64_t)sl;
        if (sl < 0 && ilen < 8) l = (uint64_t)sl + (1ull << (8 * ilen));
        pos += ilen;
        if (pos + l > len) return ERR_TRUNCATED;
        if (arena_used + l > arena_cap) return ERR_CAPACITY;
        std::memcpy(arena + arena_used, data + pos, l);
        offs[i] = arena_used;
        lens_out[i] = l;
        arena_used += l;
        pos += l;
        break;
      }
      default:
        return ERR_BAD_TYPE;
    }
  }
  *arena_used_io = arena_used;
  return (int64_t)num;
}

// Encode one tuple from parallel tagged arrays. Returns bytes written
// into out (capacity out_cap) or a negative error code.
int64_t cn_pack(uint64_t num, const uint8_t* types, const int64_t* ints,
                const double* floats, const uint8_t* payload,
                const uint64_t* offs, const uint64_t* lens,
                uint8_t* out, uint64_t out_cap) {
  if (num > 0xFF) return ERR_TOO_MANY;
  uint64_t pos = 0;
  if (out_cap < 1) return ERR_CAPACITY;
  out[pos++] = (uint8_t)num;
  for (uint64_t i = 0; i < num; ++i) {
    switch (types[i]) {
      case TYPE_NULL: {
        if (pos + 1 > out_cap) return ERR_CAPACITY;
        out[pos++] = TYPE_NULL;
        break;
      }
      case TYPE_INTEGER: {
        uint64_t bits = (uint64_t)ints[i];
        int n = min_int_len(bits, 8);
        if (pos + 1 + (uint64_t)n > out_cap) return ERR_CAPACITY;
        out[pos++] = (uint8_t)((n << 3) | TYPE_INTEGER);
        put_be(out + pos, bits, n);
        pos += n;
        break;
      }
      case TYPE_FLOAT: {
        if (pos + 9 > out_cap) return ERR_CAPACITY;
        out[pos++] = TYPE_FLOAT;
        uint64_t bits;
        std::memcpy(&bits, &floats[i], 8);
        put_be(out + pos, bits, 8);
        pos += 8;
        break;
      }
      case TYPE_TEXT:
      case TYPE_BLOB: {
        uint64_t l = lens[i];
        uint64_t lbits = l & 0xFFFFFFFFull;  // 32-bit length space
        int n = min_int_len(lbits, 4);
        if (pos + 1 + (uint64_t)n + l > out_cap) return ERR_CAPACITY;
        out[pos++] = (uint8_t)((n << 3) | types[i]);
        put_be(out + pos, lbits, n);
        pos += n;
        std::memcpy(out + pos, payload + offs[i], l);
        pos += l;
        break;
      }
      default:
        return ERR_BAD_TYPE;
    }
  }
  return (int64_t)pos;
}

// Decode `n_blobs` blobs laid out back to back. blob_offs has n_blobs+1
// entries (prefix offsets into data). Per-blob column counts land in
// col_counts; per-column outputs append into the shared arrays (capacity
// cap columns / arena_cap bytes). Returns total columns decoded or a
// negative error code (the index of the failing blob is written to
// *err_blob).
int64_t cn_unpack_batch(const uint8_t* data, const uint64_t* blob_offs,
                        uint64_t n_blobs, uint64_t cap, uint8_t* types,
                        int64_t* ints, double* floats, uint64_t* offs,
                        uint64_t* lens_out, uint8_t* arena,
                        uint64_t arena_cap, int64_t* col_counts,
                        uint64_t* err_blob) {
  uint64_t total = 0;
  uint64_t arena_used = 0;
  for (uint64_t b = 0; b < n_blobs; ++b) {
    const uint8_t* blob = data + blob_offs[b];
    uint64_t blen = blob_offs[b + 1] - blob_offs[b];
    int64_t rc =
        cn_unpack(blob, blen, cap - total, types + total, ints + total,
                  floats + total, offs + total, lens_out + total, arena,
                  arena_cap, &arena_used);
    if (rc < 0) {
      *err_blob = b;
      return rc;
    }
    col_counts[b] = rc;
    total += (uint64_t)rc;
  }
  return (int64_t)total;
}

int cn_abi_version() { return 1; }

}  // extern "C"
