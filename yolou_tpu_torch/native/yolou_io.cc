// yolou_io: the port's PNG decoder, built with g++ and loaded through ctypes.
//
// What `cv2.imread(path, IMREAD_UNCHANGED)` gives for the PNGs of the
// BraTS-style datasets: the signature, the chunk walk, IHDR, the IDAT
// stream inflated with zlib, the five scanline filters (Paeth among them),
// and the R <-> B swap of cv2's channel order. Supported: 8-bit gray,
// gray+alpha, RGB and RGBA, not interlaced; `yio_png_header` reports any
// other kind so that the caller can name it. The counterpart of the JAX
// package's native decoder, kept as this package's own copy.
//
// C interface (every entry returns 0 on success, a negative code else):
//   yio_version()                      -> the ABI version
//   yio_png_header(path, info[5])      -> width, height, bit depth, colour
//                                         type, interlace method
//   yio_decode_png_file(path, out, n)  -> HWC uint8 pixels into out[n]

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>

namespace {

enum Error {
  kOpen = -1, kRead = -2, kSignature = -3, kChunk = -4, kHeader = -5,
  kUnsupported = -6, kInflate = -7, kFilter = -8, kBuffer = -9,
};

const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

int read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return kOpen;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n < 0) {
    fclose(f);
    return kRead;
  }
  out->resize(size_t(n));
  size_t rd = n ? fread(out->data(), 1, size_t(n), f) : 0;
  fclose(f);
  return rd == size_t(n) ? 0 : kRead;
}

struct Header {
  int w = 0, h = 0, bit_depth = 0, color_type = 0, interlace = 0;
};

int channels_of(int color_type) {
  switch (color_type) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 4: return 2;  // gray+alpha
    case 6: return 4;  // RGBA
    default: return 0; // palette and undefined types
  }
}

// IHDR is the first chunk of every PNG.
int parse_header(const uint8_t* buf, size_t len, Header* hd) {
  if (len < 33 || memcmp(buf, kSig, 8) != 0) return kSignature;
  if (be32(buf + 8) != 13 || memcmp(buf + 12, "IHDR", 4) != 0) return kHeader;
  const uint8_t* d = buf + 16;
  hd->w = int(be32(d));
  hd->h = int(be32(d + 4));
  hd->bit_depth = d[8];
  hd->color_type = d[9];
  hd->interlace = d[12];
  return hd->w > 0 && hd->h > 0 ? 0 : kHeader;
}

bool supported(const Header& hd) {
  return hd.bit_depth == 8 && hd.interlace == 0 &&
         channels_of(hd.color_type) > 0;
}

int decode_png(const uint8_t* buf, size_t len, uint8_t* out, size_t out_len) {
  Header hd;
  int rc = parse_header(buf, len, &hd);
  if (rc) return rc;
  if (!supported(hd)) return kUnsupported;
  const int bpp = channels_of(hd.color_type);  // bytes per pixel at 8 bits
  const size_t stride = size_t(hd.w) * bpp;
  if (out_len != stride * size_t(hd.h)) return kBuffer;

  std::vector<uint8_t> idat;
  size_t pos = 8;
  while (pos + 12 <= len) {
    const uint32_t chunk_len = be32(buf + pos);
    const uint8_t* type = buf + pos + 4;
    if (chunk_len > len - pos - 12) return kChunk;
    if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), buf + pos + 8, buf + pos + 8 + chunk_len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + size_t(chunk_len);
  }

  std::vector<uint8_t> raw((stride + 1) * size_t(hd.h));
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size()) {
    return kInflate;
  }
  for (int y = 0; y < hd.h; ++y) {
    const uint8_t filter = raw[(stride + 1) * y];
    const uint8_t* src = raw.data() + (stride + 1) * y + 1;
    uint8_t* dst = out + stride * y;
    const uint8_t* up = y > 0 ? out + stride * (y - 1) : nullptr;
    if (filter > 4) return kFilter;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= size_t(bpp)) ? up[x - bpp] : 0;
      int v = src[x];
      switch (filter) {
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: break;
      }
      dst[x] = uint8_t(v);
    }
  }
  // cv2's channel order: B, G, R(, A)
  if (bpp >= 3) {
    for (size_t i = 0; i < out_len; i += bpp) std::swap(out[i], out[i + 2]);
  }
  return 0;
}

}  // namespace

extern "C" {

int yio_version() { return 1; }

int yio_png_header(const char* path, int* info) {
  FILE* f = fopen(path, "rb");
  if (!f) return kOpen;
  uint8_t buf[33];
  size_t rd = fread(buf, 1, sizeof(buf), f);
  fclose(f);
  Header hd;
  int rc = parse_header(buf, rd, &hd);
  if (rc) return rc;
  info[0] = hd.w;
  info[1] = hd.h;
  info[2] = hd.bit_depth;
  info[3] = hd.color_type;
  info[4] = hd.interlace;
  return 0;
}

int yio_decode_png_file(const char* path, uint8_t* out, size_t out_len) {
  std::vector<uint8_t> buf;
  int rc = read_file(path, &buf);
  if (rc) return rc;
  return decode_png(buf.data(), buf.size(), out, out_len);
}

}  // extern "C"
