// srf_io.cc: the host data plane's native kernels for srf_tpu_torch (the
// port's own copy of the JAX package's csrc/srf_io.cc).
//
// CRC-32C (Castagnoli, slicing-by-8; the SSE4.2 instruction where the
// build host has it and utils/native.py passes -msse4.2) and TFRecord
// framing scans, called through ctypes by data/tfrecord.py. They replace
// the C++ tf.data runtime the reference delegates to (reference:
// tfsr/data/load_speech_data.py:43-46).
//
// Built with csrc/host/ctc_beam.cc into one library by utils/native.py.

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;  // reversed Castagnoli

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (int i = 0; i < 256; ++i) {
      uint32_t crc = static_cast<uint32_t>(i);
      for (int k = 0; k < 8; ++k) crc = (crc >> 1) ^ ((crc & 1) ? kPoly : 0);
      t[0][i] = crc;
    }
    for (int s = 1; s < 8; ++s)
      for (int i = 0; i < 256; ++i)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Tables kTables;

uint32_t crc32c_sw(const uint8_t* p, size_t n, uint32_t crc) {
  const uint32_t (*t)[256] = kTables.t;
  while (n >= 8) {
    crc ^= static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
           (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
    crc = t[7][crc & 0xFF] ^ t[6][(crc >> 8) & 0xFF] ^ t[5][(crc >> 16) & 0xFF] ^
          t[4][(crc >> 24) & 0xFF] ^ t[3][p[4]] ^ t[2][p[5]] ^ t[1][p[6]] ^ t[0][p[7]];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ t[0][(crc ^ *p++) & 0xFF];
  return crc;
}

#if defined(__SSE4_2__)
uint32_t crc32c_hw(const uint8_t* p, size_t n, uint32_t crc) {
  uint64_t c = crc;
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    c = _mm_crc32_u64(c, v);
    p += 8;
    n -= 8;
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  while (n--) c32 = _mm_crc32_u8(c32, *p++);
  return c32;
}
#endif

}  // namespace

extern "C" {

uint32_t srf_crc32c(const uint8_t* data, size_t n) {
  uint32_t crc = 0xFFFFFFFFu;
#if defined(__SSE4_2__)
  crc = crc32c_hw(data, n, crc);
#else
  crc = crc32c_sw(data, n, crc);
#endif
  return crc ^ 0xFFFFFFFFu;
}

// Scan TFRecord framing: fills offsets[i], lengths[i] for each record payload.
// Returns the number of records found, or -1 on framing error.
// max_records bounds the output arrays.
int64_t srf_tfrecord_scan(const uint8_t* data, size_t size, int64_t max_records,
                          int64_t* offsets, int64_t* lengths) {
  size_t pos = 0;
  int64_t count = 0;
  while (pos < size && count < max_records) {
    if (size - pos < 12) return -1;
    uint64_t len;
    std::memcpy(&len, data + pos, 8);
    pos += 12;
    // overflow-safe framing check: a corrupt/malicious length near 2^64
    // would wrap `pos + len + 4` and pass a naive comparison, producing
    // an out-of-bounds record span
    if (len > size - pos || size - pos - len < 4) return -1;
    offsets[count] = static_cast<int64_t>(pos);
    lengths[count] = static_cast<int64_t>(len);
    pos += len + 4;
    ++count;
  }
  return count;
}

}  // extern "C"
