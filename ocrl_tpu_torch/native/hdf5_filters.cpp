// The HDF5 reader's byte-level work (ocrl_tpu_torch/data/hdf5_format.py):
// Jenkins' lookup3 checksum of HDF5's version-2 metadata, the fletcher32
// filter's checksum and h5py's LZF filter (liblzf's decompressor). Each runs
// over every byte of a chunk or a metadata block, which Python does at a few
// MB/s.
//
// Build: g++ -O3 -shared -fPIC, at first use (ocrl_tpu_torch/native/__init__.py)
// ABI: plain C, consumed via ctypes (which releases the GIL for the call).

#include <cstddef>
#include <cstdint>

namespace {

inline uint32_t rot(uint32_t x, int k) { return (x << k) | (x >> (32 - k)); }

inline void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a -= c; a ^= rot(c, 4);  c += b;
  b -= a; b ^= rot(a, 6);  a += c;
  c -= b; c ^= rot(b, 8);  b += a;
  a -= c; a ^= rot(c, 16); c += b;
  b -= a; b ^= rot(a, 19); a += c;
  c -= b; c ^= rot(b, 4);  b += a;
}

inline void final_mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  c ^= b; c -= rot(b, 14);
  a ^= c; a -= rot(c, 11);
  b ^= a; b -= rot(a, 25);
  c ^= b; c -= rot(b, 16);
  a ^= c; a -= rot(c, 4);
  b ^= a; b -= rot(a, 14);
  c ^= b; c -= rot(b, 24);
}

}  // namespace

extern "C" {

// hashlittle() of lookup3.c, byte by byte, as HDF5's H5_checksum_lookup3.
uint32_t hdf5_lookup3(const uint8_t* k, size_t length, uint32_t initval) {
  uint32_t a, b, c;
  a = b = c = 0xdeadbeef + static_cast<uint32_t>(length) + initval;
  while (length > 12) {
    a += k[0] + (uint32_t(k[1]) << 8) + (uint32_t(k[2]) << 16) + (uint32_t(k[3]) << 24);
    b += k[4] + (uint32_t(k[5]) << 8) + (uint32_t(k[6]) << 16) + (uint32_t(k[7]) << 24);
    c += k[8] + (uint32_t(k[9]) << 8) + (uint32_t(k[10]) << 16) + (uint32_t(k[11]) << 24);
    mix(a, b, c);
    length -= 12;
    k += 12;
  }
  switch (length) {
    case 12: c += uint32_t(k[11]) << 24; [[fallthrough]];
    case 11: c += uint32_t(k[10]) << 16; [[fallthrough]];
    case 10: c += uint32_t(k[9]) << 8; [[fallthrough]];
    case 9: c += k[8]; [[fallthrough]];
    case 8: b += uint32_t(k[7]) << 24; [[fallthrough]];
    case 7: b += uint32_t(k[6]) << 16; [[fallthrough]];
    case 6: b += uint32_t(k[5]) << 8; [[fallthrough]];
    case 5: b += k[4]; [[fallthrough]];
    case 4: a += uint32_t(k[3]) << 24; [[fallthrough]];
    case 3: a += uint32_t(k[2]) << 16; [[fallthrough]];
    case 2: a += uint32_t(k[1]) << 8; [[fallthrough]];
    case 1: a += k[0]; break;
    case 0: return c;
  }
  final_mix(a, b, c);
  return c;
}

// H5_checksum_fletcher32: 16-bit big-endian words, both sums folded every
// 360 words, an odd last byte as the high byte of a word.
uint32_t hdf5_fletcher32(const uint8_t* data, size_t n) {
  size_t len = n / 2;
  uint32_t sum1 = 0, sum2 = 0;
  while (len) {
    size_t tlen = len > 360 ? 360 : len;
    len -= tlen;
    do {
      sum1 += (uint32_t(data[0]) << 8) | uint32_t(data[1]);
      data += 2;
      sum2 += sum1;
    } while (--tlen);
    sum1 = (sum1 & 0xffff) + (sum1 >> 16);
    sum2 = (sum2 & 0xffff) + (sum2 >> 16);
  }
  if (n % 2) {
    sum1 += uint32_t(*data) << 8;
    sum2 += sum1;
    sum1 = (sum1 & 0xffff) + (sum1 >> 16);
    sum2 = (sum2 & 0xffff) + (sum2 >> 16);
  }
  sum1 = (sum1 & 0xffff) + (sum1 >> 16);
  sum2 = (sum2 & 0xffff) + (sum2 >> 16);
  return (sum2 << 16) | sum1;
}

// lzf_decompress of liblzf 3.6: literal runs of ctrl + 1 bytes (ctrl < 32)
// and back references of (ctrl >> 5) + 2 bytes (7: one more length byte) at
// ((ctrl & 31) << 8) + next byte + 1 behind. Returns the bytes written, or
// -1 where the input is cut short, the output would overflow or a reference
// points before the output's start.
int64_t hdf5_lzf_decompress(const uint8_t* ip, size_t in_len, uint8_t* out, size_t out_len) {
  const uint8_t* const in_end = ip + in_len;
  uint8_t* op = out;
  uint8_t* const out_end = out + out_len;
  while (ip < in_end) {
    uint32_t ctrl = *ip++;
    if (ctrl < (1u << 5)) {
      ctrl++;
      if (static_cast<size_t>(out_end - op) < ctrl || static_cast<size_t>(in_end - ip) < ctrl)
        return -1;
      for (uint32_t i = 0; i < ctrl; ++i) *op++ = *ip++;
    } else {
      uint32_t len = ctrl >> 5;
      size_t back = (size_t(ctrl & 0x1f) << 8) + 1;
      if (ip >= in_end) return -1;
      if (len == 7) {
        len += *ip++;
        if (ip >= in_end) return -1;
      }
      back += *ip++;
      len += 2;
      if (static_cast<size_t>(out_end - op) < len || static_cast<size_t>(op - out) < back)
        return -1;
      const uint8_t* ref = op - back;
      for (uint32_t i = 0; i < len; ++i) *op++ = *ref++;
    }
  }
  return op - out;
}

}  // extern "C"
