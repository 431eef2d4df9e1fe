// Checkpoint codec: the host-side decoding that reading the reference's
// orbax checkpoints needs (models/orbax.py binds it through ctypes).
//
// - A Zstandard frame decoder, written from RFC 8878: frame and block
//   headers, raw / RLE / compressed blocks, literals (raw, RLE, Huffman
//   with one or four streams, treeless), sequences (predefined, RLE,
//   FSE-compressed and repeat modes; the repeat offsets), skippable
//   frames, several frames in a row, and the XXH64 content checksum,
//   verified when the frame's flag is set. A frame that asks for a
//   dictionary is refused. Every read of the input and every write and
//   match copy into the output is bounds-checked: a damaged frame returns
//   a negative error code and never reads or writes out of bounds.
// - CRC-32C (Castagnoli, reflected polynomial 0x82F63B78), which the
//   OCDBT manifests and B+tree nodes carry.
//
// Built on first use by ops/_build.py (load_codec) with the host C++
// compiler into build/codec/libcheckpoint_codec.so.

#include <cstdint>
#include <cstring>
#include <new>

namespace {

enum : int64_t {
  kTruncated = -1,       // the input ends inside a frame
  kBadMagic = -2,        // not a zstd or skippable frame
  kCorrupt = -3,         // an invalid header, table or stream
  kDstTooSmall = -4,     // the output does not fit the capacity
  kDictionary = -5,      // the frame needs a dictionary
  kChecksum = -6,        // the content checksum does not match
  kReserved = -7,        // a reserved bit or block type is set
  kContentSize = -8,     // the frame's content size does not match
  kHuffman = -9,         // a bad Huffman table or stream
  kFse = -10,            // a bad FSE table or stream
  kOffset = -11,         // a match reaches before the frame's output
  kNoTable = -12,        // a repeat mode with no earlier table
};

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;
constexpr size_t kBlockMax = 128 * 1024;

inline uint32_t ReadLE32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}

inline uint64_t ReadLE64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // the host is little-endian (x86-64, aarch64)
}

inline int HighBit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// -- bit readers ------------------------------------------------------------

// A forward bit reader (FSE table descriptions): bits LSB-first. A peek past
// the end reads zeros; consuming past the end is an error.
struct ForwardBits {
  const uint8_t* p;
  size_t size;
  uint64_t pos = 0;  // bits consumed

  uint32_t Peek(int n) const {  // n <= 32
    uint64_t byte = pos >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 5 && byte + i < size; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    return uint32_t((v >> (pos & 7)) & ((uint64_t(1) << n) - 1));
  }
  bool Skip(int n) {
    pos += n;
    return pos <= 8 * uint64_t(size);
  }
};

// A backward bit reader (Huffman and FSE streams): the stream is one
// little-endian integer read from its top bit down, after the last byte's
// padding (its highest set bit). Reading past the start gives zeros and
// leaves `left` negative (the FSE streams' end condition).
struct BackwardBits {
  const uint8_t* p = nullptr;
  size_t size = 0;
  int64_t left = 0;  // bits not yet consumed

  bool Init(const uint8_t* src, size_t n) {
    if (n == 0) return false;
    uint8_t last = src[n - 1];
    if (last == 0) return false;  // no end marker
    p = src;
    size = n;
    left = int64_t(8 * n) - (8 - HighBit(last));
    return true;
  }
  // The `n` (<= 56) bits below position `at`, zeros below the start.
  uint64_t Bits(int64_t at, int n) const {
    if (n == 0) return 0;
    int64_t lo = at - n;
    if (lo >= 0) {
      uint64_t byte = uint64_t(lo) >> 3;
      uint64_t v;
      if (byte + 8 <= size) {
        v = ReadLE64(p + byte);
      } else {
        v = 0;
        for (uint64_t i = 0; byte + i < size && i < 8; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
      }
      return (v >> (lo & 7)) & ((uint64_t(1) << n) - 1);
    }
    if (at <= 0) return 0;
    uint64_t v = 0;
    for (size_t i = 0; i < size && i < 8; ++i) v |= uint64_t(p[i]) << (8 * i);
    v &= (uint64_t(1) << at) - 1;
    return v << (-lo);
  }
  uint64_t Peek(int n) const { return Bits(left, n); }
  void Skip(int n) { left -= n; }
  uint64_t Read(int n) {
    uint64_t v = Bits(left, n);
    left -= n;
    return v;
  }
};

// -- FSE ----------------------------------------------------------------------

struct FseEntry {
  uint16_t base;    // the next state's baseline
  uint8_t symbol;
  uint8_t bits;     // bits read for the next state
};

struct FseTable {
  int log = 0;            // accuracy log; 0 with one symbol (RLE)
  FseEntry cells[512];    // 1 << log entries (max log 9)
};

// Normalized counts -> decoding table (RFC 8878 4.1.1).
bool BuildFse(FseTable* t, const int16_t* norm, int nsym, int log) {
  int size = 1 << log;
  int high = size - 1;
  uint16_t next[256];
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t->cells[high--].symbol = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t->cells[pos].symbol = uint8_t(s);
      do pos = (pos + step) & mask; while (pos > high);
    }
  }
  if (pos != 0) return false;
  for (int u = 0; u < size; ++u) {
    int s = t->cells[u].symbol;
    uint32_t state = next[s]++;
    if (state == 0) return false;
    int bits = log - HighBit(state);
    if (bits < 0) return false;
    t->cells[u].bits = uint8_t(bits);
    t->cells[u].base = uint16_t((state << bits) - size);
  }
  t->log = log;
  return true;
}

// An FSE table description (forward bitstream) -> table. Returns the bytes
// it took, or a negative error.
int64_t ReadFseTable(FseTable* t, const uint8_t* src, size_t n, int max_log, int max_sym) {
  if (n < 1) return kTruncated;
  ForwardBits in{src, n};
  int log = int(in.Peek(4)) + 5;
  in.Skip(4);
  if (log > max_log) return kFse;
  int16_t norm[256];
  int remaining = (1 << log) + 1, threshold = 1 << log, bits = log + 1, sym = 0;
  bool previous0 = false;
  while (remaining > 1 && sym <= max_sym) {
    if (previous0) {
      int repeat;
      do {
        repeat = int(in.Peek(2));
        if (!in.Skip(2)) return kTruncated;
        for (int i = 0; i < repeat; ++i) {
          if (sym > max_sym) return kFse;
          norm[sym++] = 0;
        }
      } while (repeat == 3);
      if (sym > max_sym) return kFse;
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t v = in.Peek(bits);
    if (int(v & (threshold - 1)) < max) {
      count = int(v & (threshold - 1));
      if (!in.Skip(bits - 1)) return kTruncated;
    } else {
      count = int(v & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      if (!in.Skip(bits)) return kTruncated;
    }
    count -= 1;  // -1 is a "less than one" probability
    remaining -= count < 0 ? -count : count;
    norm[sym++] = int16_t(count);
    previous0 = count == 0;
    while (remaining < threshold && threshold > 1) {
      --bits;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || sym > max_sym + 1) return kFse;
  if (!BuildFse(t, norm, sym, log)) return kFse;
  return int64_t((in.pos + 7) >> 3);
}

void RleFse(FseTable* t, uint8_t symbol) {
  t->log = 0;
  t->cells[0] = FseEntry{0, symbol, 0};
}

// -- Huffman ------------------------------------------------------------------

struct HufEntry {
  uint8_t symbol;
  uint8_t bits;
};

struct HufTable {
  int log = 0;              // the longest code; 0 = no table yet
  HufEntry cells[1 << 11];
};

// The Huffman tree description (RFC 8878 4.2.1). Returns the bytes it took.
int64_t ReadHuffman(HufTable* t, const uint8_t* src, size_t n) {
  if (n < 1) return kTruncated;
  uint8_t weights[256];
  int count = 0;
  size_t used;
  int header = src[0];
  if (header >= 128) {
    count = header - 127;
    used = 1 + size_t((count + 1) / 2);
    if (used > n) return kTruncated;
    for (int i = 0; i < count; ++i) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
  } else {
    used = 1 + size_t(header);
    if (used > n || header == 0) return header == 0 ? kHuffman : kTruncated;
    // FSE-compressed weights: a table (accuracy log <= 6), then two
    // interleaved states over a backward stream.
    FseTable fse;
    int64_t took = ReadFseTable(&fse, src + 1, header, 6, 255);
    if (took < 0) return took;
    if (took >= header) return kHuffman;
    BackwardBits bits;
    if (!bits.Init(src + 1 + took, size_t(header - took))) return kHuffman;
    uint32_t s1 = uint32_t(bits.Read(fse.log)), s2 = uint32_t(bits.Read(fse.log));
    if (bits.left < 0) return kHuffman;
    for (;;) {
      if (count > 253) return kHuffman;
      const FseEntry& e1 = fse.cells[s1];
      weights[count++] = e1.symbol;
      s1 = e1.base + uint32_t(bits.Read(e1.bits));
      if (bits.left < 0) {
        weights[count++] = fse.cells[s2].symbol;
        break;
      }
      const FseEntry& e2 = fse.cells[s2];
      weights[count++] = e2.symbol;
      s2 = e2.base + uint32_t(bits.Read(e2.bits));
      if (bits.left < 0) {
        weights[count++] = fse.cells[s1].symbol;
        break;
      }
    }
  }
  // The last weight is implied: the total must reach a power of two.
  uint32_t total = 0;
  for (int i = 0; i < count; ++i) {
    if (weights[i] > 11) return kHuffman;
    if (weights[i]) total += uint32_t(1) << (weights[i] - 1);
  }
  if (total == 0) return kHuffman;
  int log = HighBit(total) + 1;
  if (log > 11) return kHuffman;
  uint32_t left = (uint32_t(1) << log) - total;
  if (left == 0 || (left & (left - 1))) return kHuffman;
  if (count >= 256) return kHuffman;
  weights[count++] = uint8_t(HighBit(left) + 1);
  // Fill the table: weight 1 (the longest codes) first, symbols in order.
  uint32_t rank[13] = {0};
  for (int i = 0; i < count; ++i) rank[weights[i]]++;
  uint32_t next[13] = {0}, start = 0;
  for (int w = 1; w <= log; ++w) {
    next[w] = start;
    start += rank[w] << (w - 1);
  }
  if (start != (uint32_t(1) << log)) return kHuffman;
  for (int s = 0; s < count; ++s) {
    int w = weights[s];
    if (!w) continue;
    uint32_t len = uint32_t(1) << (w - 1);
    for (uint32_t i = 0; i < len; ++i)
      t->cells[next[w] + i] = HufEntry{uint8_t(s), uint8_t(log + 1 - w)};
    next[w] += len;
  }
  t->log = log;
  return int64_t(used);
}

// One Huffman stream into `out[0, n)` (a single-stream section: at most
// 1023 literals); the stream must end exactly.
bool DecodeHufStream(const HufTable& t, const uint8_t* src, size_t size, uint8_t* out, size_t n) {
  BackwardBits bits;
  if (!bits.Init(src, size)) return false;
  for (size_t i = 0; i < n; ++i) {
    const HufEntry& e = t.cells[bits.Peek(t.log)];
    out[i] = e.symbol;
    bits.Skip(e.bits);
    if (bits.left < 0) return false;
  }
  return bits.left == 0;
}

// Four Huffman streams into `out` (stream k at k * q, `counts[k]` symbols):
// while every stream has four symbols to go and 57 bits below its position,
// one 64-bit load a stream gives its next four symbols, the four streams
// interleaved (independent work for the core); the rest one stream at a
// time. Each stream must end exactly.
bool DecodeHuf4(const HufTable& t, const uint8_t* const* src, const size_t* size,
                uint8_t* out, size_t q, const size_t* counts) {
  BackwardBits bits[4];
  size_t done[4] = {0, 0, 0, 0};
  for (int k = 0; k < 4; ++k)
    if (!bits[k].Init(src[k], size[k])) return false;
  const int log = t.log;
  for (;;) {
    bool ready = true;
    for (int k = 0; k < 4; ++k)
      ready &= done[k] + 4 <= counts[k] && bits[k].left > 56;
    if (!ready) break;
    for (int k = 0; k < 4; ++k) {
      int64_t b = ((bits[k].left + 7) >> 3) - 8;
      uint64_t c = ReadLE64(src[k] + b);
      int top = int(bits[k].left - 8 * b);
      uint8_t* o = out + k * q + done[k];
      for (int j = 0; j < 4; ++j) {
        const HufEntry& e = t.cells[(c << (64 - top)) >> (64 - log)];
        o[j] = e.symbol;
        top -= e.bits;
      }
      bits[k].left = 8 * b + top;
      done[k] += 4;
    }
  }
  for (int k = 0; k < 4; ++k) {
    BackwardBits& r = bits[k];
    for (size_t i = done[k]; i < counts[k]; ++i) {
      const HufEntry& e = t.cells[r.Peek(log)];
      out[k * q + i] = e.symbol;
      r.Skip(e.bits);
      if (r.left < 0) return false;
    }
    if (r.left != 0) return false;
  }
  return true;
}

// -- sequences ----------------------------------------------------------------

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10,  11,
                              12, 13, 14, 15, 16, 18, 20, 22, 24, 28, 32, 40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// The state that lives across the blocks of one frame.
struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
  uint8_t literals[kBlockMax];
};

// One sequence table's description in `mode` (0 predefined, 1 RLE, 2 FSE,
// 3 repeat). Returns the bytes it took.
int64_t ReadSeqTable(FseTable* t, bool* have, int mode, const uint8_t* src, size_t n,
                     const int16_t* defaults, int ndefault, int default_log, int max_log,
                     int max_sym) {
  switch (mode) {
    case 0:
      BuildFse(t, defaults, ndefault, default_log);
      *have = true;
      return 0;
    case 1:
      if (n < 1) return kTruncated;
      if (src[0] > max_sym) return kFse;
      RleFse(t, src[0]);
      *have = true;
      return 1;
    case 2: {
      int64_t took = ReadFseTable(t, src, n, max_log, max_sym);
      if (took >= 0) *have = true;
      return took;
    }
    default:
      return *have ? int64_t(0) : int64_t(kNoTable);
  }
}

// The literals section of a compressed block into `st->literals`. Returns
// the bytes it took; `*count` gets the literals' count.
int64_t ReadLiterals(FrameState* st, const uint8_t* src, size_t n, size_t* count) {
  if (n < 1) return kTruncated;
  int type = src[0] & 3, format = (src[0] >> 2) & 3;
  size_t regen, comp = 0, head;
  if (type < 2) {
    if (format == 0 || format == 2) {
      head = 1;
      regen = src[0] >> 3;
    } else if (format == 1) {
      head = 2;
      if (n < 2) return kTruncated;
      regen = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else {
      head = 3;
      if (n < 3) return kTruncated;
      regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
    if (regen > kBlockMax) return kCorrupt;
    if (type == 0) {
      if (head + regen > n) return kTruncated;
      std::memcpy(st->literals, src + head, regen);
      *count = regen;
      return int64_t(head + regen);
    }
    if (head + 1 > n) return kTruncated;
    std::memset(st->literals, src[head], regen);
    *count = regen;
    return int64_t(head + 1);
  }
  bool four = format != 0;
  if (format < 2) {
    head = 3;
    if (n < 3) return kTruncated;
    uint32_t h = src[0] | uint32_t(src[1]) << 8 | uint32_t(src[2]) << 16;
    regen = (h >> 4) & 0x3FF;
    comp = (h >> 14) & 0x3FF;
  } else if (format == 2) {
    head = 4;
    if (n < 4) return kTruncated;
    uint32_t h = ReadLE32(src);
    regen = (h >> 4) & 0x3FFF;
    comp = (h >> 18) & 0x3FFF;
  } else {
    head = 5;
    if (n < 5) return kTruncated;
    uint64_t h = ReadLE32(src) | uint64_t(src[4]) << 32;
    regen = (h >> 4) & 0x3FFFF;
    comp = (h >> 22) & 0x3FFFF;
  }
  if (regen > kBlockMax) return kCorrupt;
  if (head + comp > n) return kTruncated;
  const uint8_t* p = src + head;
  size_t left = comp;
  if (type == 2) {
    int64_t took = ReadHuffman(&st->huf, p, left);
    if (took < 0) return took;
    p += took;
    left -= size_t(took);
  } else if (st->huf.log == 0) {
    return kNoTable;
  }
  if (!four) {
    if (!DecodeHufStream(st->huf, p, left, st->literals, regen)) return kHuffman;
  } else {
    // Four streams need six literals (as libzstd rules): with fewer, the
    // fourth stream's count, regen - 3 * q, would wrap below zero.
    if (regen < 6) return kCorrupt;
    if (left < 6) return kHuffman;
    size_t s1 = p[0] | size_t(p[1]) << 8, s2 = p[2] | size_t(p[3]) << 8,
           s3 = p[4] | size_t(p[5]) << 8;
    if (6 + s1 + s2 + s3 > left) return kHuffman;
    size_t s4 = left - 6 - s1 - s2 - s3;
    size_t q = (regen + 3) / 4;
    const uint8_t* in = p + 6;
    const uint8_t* starts[4] = {in, in + s1, in + s1 + s2, in + s1 + s2 + s3};
    size_t sizes[4] = {s1, s2, s3, s4};
    size_t counts[4] = {q, q, q, regen - 3 * q};
    if (!DecodeHuf4(st->huf, starts, sizes, st->literals, q, counts)) return kHuffman;
  }
  *count = regen;
  return int64_t(head + comp);
}

// Copy a match of `len` bytes from `offset` back; `out` is the write
// position, `frame` the frame output's start.
inline bool CopyMatch(uint8_t* frame, uint8_t* out, uint64_t offset, size_t len) {
  if (offset == 0 || offset > uint64_t(out - frame)) return false;
  const uint8_t* from = out - offset;
  if (offset >= len) {
    std::memcpy(out, from, len);
  } else {
    for (size_t i = 0; i < len; ++i) out[i] = from[i];
  }
  return true;
}

// One compressed block into `*out`, which may not pass `end`. Returns 0 or
// a negative error.
int64_t DecodeCompressedBlock(FrameState* st, const uint8_t* src, size_t n, uint8_t* frame,
                              uint8_t** out, uint8_t* end) {
  size_t nlit = 0;
  int64_t took = ReadLiterals(st, src, n, &nlit);
  if (took < 0) return took;
  const uint8_t* p = src + took;
  size_t left = n - size_t(took);
  if (left < 1) return kTruncated;
  uint32_t nseq;
  int b0 = p[0];
  if (b0 == 0) {
    if (left != 1) return kCorrupt;
    if (size_t(end - *out) < nlit) return kDstTooSmall;
    std::memcpy(*out, st->literals, nlit);
    *out += nlit;
    return 0;
  } else if (b0 < 128) {
    nseq = b0;
    p += 1, left -= 1;
  } else if (b0 < 255) {
    if (left < 2) return kTruncated;
    nseq = ((b0 - 128) << 8) + p[1];
    p += 2, left -= 2;
  } else {
    if (left < 3) return kTruncated;
    nseq = p[1] + (uint32_t(p[2]) << 8) + 0x7F00;
    p += 3, left -= 3;
  }
  if (left < 1) return kTruncated;
  int modes = p[0];
  if (modes & 3) return kReserved;
  p += 1, left -= 1;
  int64_t t;
  t = ReadSeqTable(&st->ll, &st->have_ll, modes >> 6, p, left, kLLDefault, 36, 6, 9, 35);
  if (t < 0) return t;
  p += t, left -= size_t(t);
  t = ReadSeqTable(&st->of, &st->have_of, (modes >> 4) & 3, p, left, kOFDefault, 29, 5, 8, 31);
  if (t < 0) return t;
  p += t, left -= size_t(t);
  t = ReadSeqTable(&st->ml, &st->have_ml, (modes >> 2) & 3, p, left, kMLDefault, 53, 6, 9, 52);
  if (t < 0) return t;
  p += t, left -= size_t(t);

  BackwardBits bits;
  if (!bits.Init(p, left)) return kCorrupt;
  uint32_t sll = uint32_t(bits.Read(st->ll.log));
  uint32_t sof = uint32_t(bits.Read(st->of.log));
  uint32_t sml = uint32_t(bits.Read(st->ml.log));
  if (bits.left < 0) return kCorrupt;
  const uint8_t* lit = st->literals;
  const uint8_t* lit_end = st->literals + nlit;
  uint64_t* rep = st->rep;
  for (uint32_t i = 0; i < nseq; ++i) {
    const FseEntry& ell = st->ll.cells[sll];
    const FseEntry& eof = st->of.cells[sof];
    const FseEntry& eml = st->ml.cells[sml];
    int ofcode = eof.symbol;
    if (ofcode > 31 || ell.symbol > 35 || eml.symbol > 52) return kCorrupt;
    uint64_t ofvalue = (uint64_t(1) << ofcode) + bits.Read(ofcode);
    size_t ml = kMLBase[eml.symbol] + size_t(bits.Read(kMLBits[eml.symbol]));
    size_t ll = kLLBase[ell.symbol] + size_t(bits.Read(kLLBits[ell.symbol]));
    uint64_t offset;
    if (ofvalue > 3) {
      offset = ofvalue - 3;
      rep[2] = rep[1], rep[1] = rep[0], rep[0] = offset;
    } else {
      uint64_t idx = ofvalue - 1 + (ll == 0);  // 0..3
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = idx == 3 ? rep[0] - 1 : rep[idx];
        if (offset == 0) return kOffset;
        if (idx != 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (i + 1 < nseq) {  // the last sequence reads no state update
      sll = ell.base + uint32_t(bits.Read(ell.bits));
      sml = eml.base + uint32_t(bits.Read(eml.bits));
      sof = eof.base + uint32_t(bits.Read(eof.bits));
    }
    if (bits.left < 0) return kCorrupt;
    if (size_t(lit_end - lit) < ll) return kCorrupt;
    if (size_t(end - *out) < ll || size_t(end - *out) - ll < ml) return kDstTooSmall;
    std::memcpy(*out, lit, ll);
    *out += ll;
    lit += ll;
    if (!CopyMatch(frame, *out, offset, ml)) return kOffset;
    *out += ml;
  }
  if (bits.left != 0) return kCorrupt;
  size_t rest = size_t(lit_end - lit);
  if (size_t(end - *out) < rest) return kDstTooSmall;
  std::memcpy(*out, lit, rest);
  *out += rest;
  return 0;
}

// -- XXH64 --------------------------------------------------------------------

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;

inline uint64_t Rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t XRound(uint64_t acc, uint64_t in) { return Rotl(acc + in * P2, 31) * P1; }
inline uint64_t XMerge(uint64_t acc, uint64_t v) { return (acc ^ XRound(0, v)) * P1 + P4; }

uint64_t Xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = XRound(v1, ReadLE64(p));
      v2 = XRound(v2, ReadLE64(p + 8));
      v3 = XRound(v3, ReadLE64(p + 16));
      v4 = XRound(v4, ReadLE64(p + 24));
      p += 32;
    } while (p <= limit);
    h = Rotl(v1, 1) + Rotl(v2, 7) + Rotl(v3, 12) + Rotl(v4, 18);
    h = XMerge(h, v1), h = XMerge(h, v2), h = XMerge(h, v3), h = XMerge(h, v4);
  } else {
    h = seed + P5;
  }
  h += uint64_t(n);
  for (; p + 8 <= end; p += 8) h = Rotl(h ^ XRound(0, ReadLE64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = Rotl(h ^ (uint64_t(ReadLE32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = Rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33, h *= P2, h ^= h >> 29, h *= P3, h ^= h >> 32;
  return h;
}

// -- frames -------------------------------------------------------------------

// One zstd frame at `src` into `dst`. Returns the bytes of input it took
// (`*written` the output), or a negative error.
int64_t DecodeFrame(FrameState* st, const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                    size_t* written) {
  if (n < 5) return kTruncated;
  uint8_t fhd = src[4];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
      dict_flag = fhd & 3;
  if (fhd & 8) return kReserved;
  size_t pos = 5;
  uint64_t window = 0;
  if (!single) {
    if (pos + 1 > n) return kTruncated;
    int wd = src[pos++];
    int exponent = wd >> 3, mantissa = wd & 7;
    uint64_t base = uint64_t(1) << (10 + exponent);
    window = base + (base / 8) * mantissa;
  }
  static const int kDictBytes[4] = {0, 1, 2, 4};
  int db = kDictBytes[dict_flag];
  if (pos + db > n) return kTruncated;
  uint32_t dict = 0;
  for (int i = 0; i < db; ++i) dict |= uint32_t(src[pos + i]) << (8 * i);
  pos += db;
  if (dict != 0) return kDictionary;
  static const int kFcsBytes[4] = {0, 2, 4, 8};
  int fb = fcs_flag == 0 ? (single ? 1 : 0) : kFcsBytes[fcs_flag];
  if (pos + fb > n) return kTruncated;
  bool have_fcs = fb > 0;
  uint64_t fcs = 0;
  for (int i = 0; i < fb; ++i) fcs |= uint64_t(src[pos + i]) << (8 * i);
  if (fb == 2) fcs += 256;
  pos += fb;
  if (single) window = fcs;
  size_t block_max = window < kBlockMax ? size_t(window) : kBlockMax;
  if (have_fcs && fcs > cap) return kDstTooSmall;

  st->huf.log = 0;
  st->have_ll = st->have_of = st->have_ml = false;
  st->rep[0] = 1, st->rep[1] = 4, st->rep[2] = 8;
  uint8_t* out = dst;
  uint8_t* end = dst + cap;
  for (;;) {
    if (pos + 3 > n) return kTruncated;
    uint32_t bh = src[pos] | uint32_t(src[pos + 1]) << 8 | uint32_t(src[pos + 2]) << 16;
    pos += 3;
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) return kReserved;
    if (type == 1) {                      // RLE: one byte, `size` times
      if (size > block_max) return kCorrupt;
      if (pos + 1 > n) return kTruncated;
      if (size_t(end - out) < size) return kDstTooSmall;
      std::memset(out, src[pos], size);
      out += size;
      pos += 1;
    } else {
      if (size > block_max) return kCorrupt;
      if (pos + size > n) return kTruncated;
      if (type == 0) {
        if (size_t(end - out) < size) return kDstTooSmall;
        std::memcpy(out, src + pos, size);
        out += size;
      } else {
        uint8_t* block_end = size_t(end - out) > block_max ? out + block_max : end;
        int64_t r = DecodeCompressedBlock(st, src + pos, size, dst, &out, block_end);
        if (r == kDstTooSmall && block_end != end) r = kCorrupt;  // over the block's limit
        if (r < 0) return r;
      }
      pos += size;
    }
    if (last) break;
  }
  size_t produced = size_t(out - dst);
  if (have_fcs && produced != fcs) return kContentSize;
  if (checksum) {
    if (pos + 4 > n) return kTruncated;
    uint32_t want = ReadLE32(src + pos);
    if (uint32_t(Xxh64(dst, produced, 0)) != want) return kChecksum;
    pos += 4;
  }
  *written = produced;
  return int64_t(pos);
}

uint32_t kCrcTable[256];
bool kCrcReady = [] {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0);
    kCrcTable[i] = c;
  }
  return true;
}();

}  // namespace

extern "C" {

// Decode every frame of `src[0, n)` (zstd frames and skippable frames, in
// any number and order) into `dst[0, cap)`. Returns the bytes written, or a
// negative error (pk_codec_error names it). Thread-safe: the frame state
// lives on the heap of each call.
int64_t pk_zstd_decompress(const uint8_t* src, uint64_t n, uint8_t* dst, uint64_t cap) {
  FrameState* st = new (std::nothrow) FrameState;
  if (st == nullptr) return kCorrupt;
  uint64_t pos = 0, total = 0;
  int64_t result = 0;
  while (pos < n) {
    if (n - pos < 4) {
      result = kTruncated;
      break;
    }
    uint32_t magic = ReadLE32(src + pos);
    if ((magic & kSkippableMask) == kSkippableMagic) {
      if (n - pos < 8) {
        result = kTruncated;
        break;
      }
      uint64_t skip = ReadLE32(src + pos + 4);
      if (n - pos - 8 < skip) {
        result = kTruncated;
        break;
      }
      pos += 8 + skip;
      continue;
    }
    if (magic != kMagic) {
      result = kBadMagic;
      break;
    }
    size_t written = 0;
    int64_t took = DecodeFrame(st, src + pos, size_t(n - pos), dst + total,
                               size_t(cap - total), &written);
    if (took < 0) {
      result = took;
      break;
    }
    pos += uint64_t(took);
    total += written;
  }
  delete st;
  return result < 0 ? result : int64_t(total);
}

// CRC-32C of `p[0, n)`, continuing from `crc` (0 to start).
uint32_t pk_crc32c(const uint8_t* p, uint64_t n, uint32_t crc) {
  crc = ~crc;
  for (uint64_t i = 0; i < n; ++i) crc = kCrcTable[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

const char* pk_codec_error(int64_t code) {
  switch (code) {
    case kTruncated: return "truncated input";
    case kBadMagic: return "not a zstd frame (bad magic number)";
    case kCorrupt: return "corrupt frame";
    case kDstTooSmall: return "output larger than its capacity";
    case kDictionary: return "frame needs a dictionary (not supported)";
    case kChecksum: return "content checksum mismatch";
    case kReserved: return "reserved bit or block type set";
    case kContentSize: return "frame content size mismatch";
    case kHuffman: return "corrupt Huffman table or stream";
    case kFse: return "corrupt FSE table or stream";
    case kOffset: return "match offset before the frame's output";
    case kNoTable: return "repeat mode with no earlier table";
    default: return "unknown error";
  }
}

}  // extern "C"
