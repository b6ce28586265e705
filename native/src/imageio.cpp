// Native image IO: zlib-backed PNG encoder for the film display path.
//
// The reference displays through CUDA-GL interop (src/opengl/*); headless
// accelerator hosts write PNGs instead, and the pure-Python row-filter loop is the
// bottleneck at 1080p (~1s).  This encodes RGBA8/RGB8 with Paeth-free
// (filter 0) rows through zlib at memory speed.

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline void put_be32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back(v >> 24);
  out.push_back((v >> 16) & 0xFF);
  out.push_back((v >> 8) & 0xFF);
  out.push_back(v & 0xFF);
}

void chunk(std::vector<uint8_t>& out, const char tag[4],
           const uint8_t* payload, size_t len) {
  put_be32(out, static_cast<uint32_t>(len));
  size_t start = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), payload, payload + len);
  uint32_t crc = crc32(0, out.data() + start, static_cast<uInt>(4 + len));
  put_be32(out, crc);
}

}  // namespace

extern "C" {

// Encode (h, w, c) uint8 (c = 3 or 4) into PNG bytes.
// out must have capacity out_cap; returns bytes written or -1.
int64_t prt_encode_png(const uint8_t* img, int64_t h, int64_t w, int64_t c,
                       int level, uint8_t* out, int64_t out_cap) {
  if (c != 3 && c != 4) return -1;
  const size_t stride = static_cast<size_t>(w) * c;

  // Raw scanlines with filter byte 0.
  std::vector<uint8_t> raw(static_cast<size_t>(h) * (stride + 1));
  for (int64_t y = 0; y < h; ++y) {
    raw[y * (stride + 1)] = 0;
    std::memcpy(&raw[y * (stride + 1) + 1], img + y * stride, stride);
  }

  uLongf zcap = compressBound(static_cast<uLong>(raw.size()));
  std::vector<uint8_t> z(zcap);
  if (compress2(z.data(), &zcap, raw.data(), static_cast<uLong>(raw.size()),
                level) != Z_OK)
    return -1;

  std::vector<uint8_t> png;
  png.reserve(zcap + 128);
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  png.insert(png.end(), sig, sig + 8);

  uint8_t ihdr[13];
  ihdr[0] = (w >> 24) & 0xFF; ihdr[1] = (w >> 16) & 0xFF;
  ihdr[2] = (w >> 8) & 0xFF;  ihdr[3] = w & 0xFF;
  ihdr[4] = (h >> 24) & 0xFF; ihdr[5] = (h >> 16) & 0xFF;
  ihdr[6] = (h >> 8) & 0xFF;  ihdr[7] = h & 0xFF;
  ihdr[8] = 8;                       // bit depth
  ihdr[9] = (c == 3) ? 2 : 6;        // color type
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  chunk(png, "IHDR", ihdr, 13);
  chunk(png, "IDAT", z.data(), zcap);
  chunk(png, "IEND", nullptr, 0);

  if (static_cast<int64_t>(png.size()) > out_cap) return -1;
  std::memcpy(out, png.data(), png.size());
  return static_cast<int64_t>(png.size());
}

}  // extern "C"
