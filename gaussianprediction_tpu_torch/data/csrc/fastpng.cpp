// fastpng: a minimal PNG decoder for the dataset loaders' host path.
//
// The port's copy of the JAX package's csrc/fastpng.cpp. It decodes 8-bit
// non-interlaced gray, gray+alpha, RGB, RGBA and palette PNGs (the formats
// the datasets use) straight into a caller's float32 HWC buffer in [0, 1].
// Unsupported variants return an error, and the Python side
// (gaussianprediction_tpu_torch/data/image_io.py) decodes them with PIL.
// Each byte becomes byte / 255.0f, the correctly rounded quotient that
// PIL's path computes (numpy's float32 division), so the two decoders give
// the same floats; the JAX copy multiplies by 1.0f / 255.0f, one ulp away
// on 126 of the 256 byte values.
//
// Built by gaussianprediction_tpu_torch/data/native.py at first use
// (g++ -O3 -shared -fPIC, linking the system zlib).
// API (extern "C", ctypes-friendly):
//   fastpng_probe(path, &w, &h, &channels) -> 0 on success
//   fastpng_decode(path, out_f32, w, h, channels) -> 0 on success
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

struct Chunk {
  uint32_t length;
  char type[5];
  const uint8_t* data;
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

struct PngInfo {
  uint32_t width = 0, height = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
  int channels = 0;  // output channels (palette -> 3)
};

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize(size_t(n));
  size_t got = fread(out.data(), 1, size_t(n), f);
  fclose(f);
  return got == size_t(n);
}

int channels_for(int color_type) {
  switch (color_type) {
    case 0: return 1;  // gray
    case 2: return 3;  // rgb
    case 3: return 3;  // palette (expanded)
    case 4: return 2;  // gray+alpha
    case 6: return 4;  // rgba
  }
  return 0;
}

// Parse header + collect IDAT; returns false on malformed/unsupported.
bool parse(const std::vector<uint8_t>& buf, PngInfo* info,
           std::vector<uint8_t>* idat, std::vector<uint8_t>* palette) {
  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (buf.size() < 8 || memcmp(buf.data(), magic, 8) != 0) return false;
  size_t pos = 8;
  bool saw_ihdr = false;
  while (pos + 8 <= buf.size()) {
    uint32_t len = be32(&buf[pos]);
    char type[5] = {0};
    memcpy(type, &buf[pos + 4], 4);
    if (pos + 12 + len > buf.size()) return false;
    const uint8_t* data = &buf[pos + 8];
    if (strcmp(type, "IHDR") == 0) {
      if (len != 13) return false;
      info->width = be32(data);
      info->height = be32(data + 4);
      info->bit_depth = data[8];
      info->color_type = data[9];
      info->interlace = data[12];
      info->channels = channels_for(info->color_type);
      saw_ihdr = true;
    } else if (strcmp(type, "PLTE") == 0) {
      palette->assign(data, data + len);
    } else if (strcmp(type, "IDAT") == 0) {
      idat->insert(idat->end(), data, data + len);
    } else if (strcmp(type, "IEND") == 0) {
      break;
    }
    pos += 12 + len;
  }
  return saw_ihdr && !idat->empty();
}

bool supported(const PngInfo& info) {
  if (info.interlace != 0) return false;   // Adam7 not needed for datasets
  if (info.bit_depth != 8) return false;
  return info.channels > 0;
}

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  if (pb <= pc) return uint8_t(b);
  return uint8_t(c);
}

// Decode into float32 HWC [0,1]; out must hold width*height*out_channels.
bool decode_impl(const char* path, float* out, uint32_t exp_w,
                 uint32_t exp_h, int exp_c) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return false;
  PngInfo info;
  std::vector<uint8_t> idat, palette;
  if (!parse(buf, &info, &idat, &palette)) return false;
  if (!supported(info)) return false;
  if (info.width != exp_w || info.height != exp_h) return false;
  int raw_c = (info.color_type == 3) ? 1 : info.channels;

  const size_t stride = size_t(info.width) * raw_c;
  std::vector<uint8_t> raw(info.height * (stride + 1));
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK)
    return false;
  if (raw_len != raw.size()) return false;

  // per-row unfilter (in place, rows become contiguous pixel data)
  std::vector<uint8_t> prev(stride, 0);
  std::vector<uint8_t> cur(stride);
  const int bpp = raw_c;
  for (uint32_t y = 0; y < info.height; ++y) {
    const uint8_t* src = &raw[y * (stride + 1)];
    uint8_t filter = src[0];
    const uint8_t* line = src + 1;
    for (size_t x = 0; x < stride; ++x) {
      int a = (x >= size_t(bpp)) ? cur[x - bpp] : 0;
      int b = prev[x];
      int c = (x >= size_t(bpp)) ? prev[x - bpp] : 0;
      uint8_t v = line[x];
      switch (filter) {
        case 0: cur[x] = v; break;
        case 1: cur[x] = uint8_t(v + a); break;
        case 2: cur[x] = uint8_t(v + b); break;
        case 3: cur[x] = uint8_t(v + ((a + b) >> 1)); break;
        case 4: cur[x] = uint8_t(v + paeth(a, b, c)); break;
        default: return false;
      }
    }
    // emit floats
    float* dst = out + size_t(y) * info.width * exp_c;
    if (info.color_type == 3) {  // palette expand
      if (palette.empty()) return false;
      for (uint32_t x = 0; x < info.width; ++x) {
        int idx = cur[x] * 3;
        if (size_t(idx) + 2 >= palette.size()) return false;
        for (int ch = 0; ch < exp_c && ch < 3; ++ch)
          dst[x * exp_c + ch] = palette[idx + ch] / 255.0f;
        if (exp_c == 4) dst[x * exp_c + 3] = 1.0f;
      }
    } else if (raw_c == 2) {  // gray+alpha -> (g,g,g[,a])
      for (uint32_t x = 0; x < info.width; ++x) {
        float g = cur[x * 2] / 255.0f;
        for (int ch = 0; ch < exp_c && ch < 3; ++ch) dst[x * exp_c + ch] = g;
        if (exp_c == 4) dst[x * exp_c + 3] = cur[x * 2 + 1] / 255.0f;
      }
    } else {
      for (uint32_t x = 0; x < info.width; ++x) {
        for (int ch = 0; ch < exp_c; ++ch) {
          int s = (ch < raw_c) ? cur[x * raw_c + ch]
                               : (ch == 3 ? 255 : cur[x * raw_c]);
          dst[x * exp_c + ch] = s / 255.0f;
        }
      }
    }
    std::swap(prev, cur);
  }
  return true;
}

}  // namespace

extern "C" {

int fastpng_probe(const char* path, int* w, int* h, int* channels) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return -1;
  PngInfo info;
  std::vector<uint8_t> idat, palette;
  if (!parse(buf, &info, &idat, &palette)) return -2;
  if (!supported(info)) return -3;
  *w = int(info.width);
  *h = int(info.height);
  *channels = info.channels;
  return 0;
}

int fastpng_decode(const char* path, float* out, int w, int h, int c) {
  return decode_impl(path, out, uint32_t(w), uint32_t(h), c) ? 0 : -1;
}

}  // extern "C"
