// cnr_native: native runtime components for cudaneuralrender.
//
// Equivalents of the reference renderer's native runtime pieces:
//   * PNG encode/decode  — replaces the vendored lodepng
//     (reference src/common/lodepng.{h,cpp}) with a small zlib-backed codec.
//   * Async frame writer — replaces the CUDA-GL PBO write-back path
//     (reference src/main.cpp:130-205): a worker-thread pool that encodes and
//     writes frames off the render thread, so turntable/animation rendering
//     overlaps disk I/O instead of serializing on it.
//
// Exposed as a C ABI consumed from Python via ctypes (no pybind11 in the
// image). All buffers are 8-bit RGBA (or RGB/gray via the channels arg).
//
// Build: make -C native   ->  native/libcnr_native.so

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// PNG primitives
// ---------------------------------------------------------------------------

constexpr uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t crc_table[256];
bool crc_ready = false;

void init_crc() {
  if (crc_ready) return;
  for (uint32_t n = 0; n < 256; n++) {
    uint32_t c = n;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
    crc_table[n] = c;
  }
  crc_ready = true;
}

uint32_t crc32_update(uint32_t crc, const uint8_t* buf, size_t len) {
  init_crc();
  uint32_t c = crc ^ 0xffffffffu;
  for (size_t i = 0; i < len; i++) c = crc_table[(c ^ buf[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

void put_u32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back((v >> 24) & 0xff);
  out.push_back((v >> 16) & 0xff);
  out.push_back((v >> 8) & 0xff);
  out.push_back(v & 0xff);
}

uint32_t read_u32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) |
         uint32_t(p[3]);
}

void write_chunk(std::vector<uint8_t>& out, const char type[4],
                 const uint8_t* data, size_t len) {
  put_u32(out, static_cast<uint32_t>(len));
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  if (len) out.insert(out.end(), data, data + len);
  uint32_t crc = crc32_update(0, out.data() + start, len + 4);
  put_u32(out, crc);
}

bool zlib_deflate(const std::vector<uint8_t>& in, std::vector<uint8_t>& out,
                  int level) {
  uLongf bound = compressBound(in.size());
  out.resize(bound);
  int rc = compress2(out.data(), &bound, in.data(), in.size(), level);
  if (rc != Z_OK) return false;
  out.resize(bound);
  return true;
}

bool zlib_inflate(const uint8_t* in, size_t in_len, std::vector<uint8_t>& out,
                  size_t expected) {
  out.resize(expected);
  uLongf dst = expected;
  int rc = uncompress(out.data(), &dst, in, in_len);
  if (rc != Z_OK || dst != expected) return false;
  return true;
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Encode 8-bit image (channels = 1, 3 or 4) into a PNG byte stream.
bool encode_png_mem(const uint8_t* pixels, uint32_t w, uint32_t h, int channels,
                    std::vector<uint8_t>& png, int level) {
  if (!(channels == 1 || channels == 3 || channels == 4)) return false;
  uint8_t color_type = channels == 1 ? 0 : (channels == 3 ? 2 : 6);

  // raw scanlines with filter byte 0
  size_t stride = size_t(w) * channels;
  std::vector<uint8_t> raw((stride + 1) * h);
  for (uint32_t y = 0; y < h; y++) {
    raw[y * (stride + 1)] = 0;
    memcpy(&raw[y * (stride + 1) + 1], pixels + y * stride, stride);
  }
  std::vector<uint8_t> idat;
  if (!zlib_deflate(raw, idat, level)) return false;

  png.clear();
  png.insert(png.end(), kPngSig, kPngSig + 8);
  uint8_t ihdr[13];
  ihdr[0] = (w >> 24) & 0xff; ihdr[1] = (w >> 16) & 0xff;
  ihdr[2] = (w >> 8) & 0xff;  ihdr[3] = w & 0xff;
  ihdr[4] = (h >> 24) & 0xff; ihdr[5] = (h >> 16) & 0xff;
  ihdr[6] = (h >> 8) & 0xff;  ihdr[7] = h & 0xff;
  ihdr[8] = 8;           // bit depth
  ihdr[9] = color_type;  // color type
  ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  write_chunk(png, "IHDR", ihdr, 13);
  write_chunk(png, "IDAT", idat.data(), idat.size());
  write_chunk(png, "IEND", nullptr, 0);
  return true;
}

// Unfilter PNG scanlines (raw = h * (stride+1) bytes with a leading filter
// byte each) into a contiguous pixel buffer. `bpp` is the filter's byte
// distance (bytes per complete pixel, min 1 — for sub-byte palette indices
// the spec fixes it at 1).
static bool unfilter_scanlines(const std::vector<uint8_t>& raw, uint32_t h,
                               size_t stride, int bpp,
                               std::vector<uint8_t>& pix) {
  pix.resize(stride * h);
  for (uint32_t y = 0; y < h; y++) {
    uint8_t filter = raw[y * (stride + 1)];
    const uint8_t* src = &raw[y * (stride + 1) + 1];
    uint8_t* dst = &pix[y * stride];
    const uint8_t* up = y ? &pix[(y - 1) * stride] : nullptr;
    for (size_t x = 0; x < stride; x++) {
      int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= size_t(bpp)) ? up[x - bpp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return false;
      }
      dst[x] = uint8_t(v);
    }
  }
  return true;
}

// Adam7 pass grids: x/y origins and strides per pass (PNG spec 8.2).
constexpr uint32_t kA7x0[7] = {0, 4, 0, 2, 0, 1, 0};
constexpr uint32_t kA7y0[7] = {0, 0, 4, 0, 2, 0, 1};
constexpr uint32_t kA7dx[7] = {8, 8, 4, 4, 2, 2, 1};
constexpr uint32_t kA7dy[7] = {8, 8, 8, 4, 4, 2, 2};

// Decode a PNG to 8-bit RGBA. Full flavor coverage (parity with the
// vendored lodepng the reference shipped, lodepng.h:129-138): color types
// gray / RGB / palette / gray+alpha / RGBA, bit depths 1/2/4/8/16 where
// the spec allows them, tRNS alpha for palette images, and both
// interlace methods (none / Adam7). 16-bit samples reduce to their high
// byte (the standard 16->8 conversion).
bool decode_png_mem(const uint8_t* data, size_t len, std::vector<uint8_t>& rgba,
                    uint32_t* out_w, uint32_t* out_h) {
  if (len < 8 || memcmp(data, kPngSig, 8) != 0) return false;
  size_t pos = 8;
  uint32_t w = 0, h = 0;
  int bit_depth = 0, color_type = -1, interlace = 0;
  std::vector<uint8_t> idat, palette, trns;

  while (pos + 8 <= len) {
    uint32_t clen = read_u32(data + pos);
    const char* type = reinterpret_cast<const char*>(data + pos + 4);
    const uint8_t* cdata = data + pos + 8;
    if (pos + 12 + clen > len) return false;
    if (memcmp(type, "IHDR", 4) == 0) {
      if (clen != 13) return false;
      w = read_u32(cdata);
      h = read_u32(cdata + 4);
      bit_depth = cdata[8];
      color_type = cdata[9];
      interlace = cdata[12];
    } else if (memcmp(type, "PLTE", 4) == 0) {
      if (clen % 3 || clen > 256 * 3) return false;
      palette.assign(cdata, cdata + clen);
    } else if (memcmp(type, "tRNS", 4) == 0) {
      trns.assign(cdata, cdata + clen);
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), cdata, cdata + clen);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + clen;
  }
  if (!w || !h || (interlace != 0 && interlace != 1)) return false;

  // Samples per pixel and legal bit depths per color type (PNG spec 11.2.2).
  int channels;
  switch (color_type) {
    case 0: channels = 1; break;  // gray: depths 1/2/4/8/16
    case 2: channels = 3; break;  // rgb: 8/16
    case 3: channels = 1; break;  // palette index: 1/2/4/8
    case 4: channels = 2; break;  // gray+alpha: 8/16
    case 6: channels = 4; break;  // rgba: 8/16
    default: return false;
  }
  bool sub_byte_ok = (color_type == 0 || color_type == 3);
  bool sixteen_ok = (color_type != 3);
  if (bit_depth == 16 && !sixteen_ok) return false;
  if ((bit_depth == 1 || bit_depth == 2 || bit_depth == 4) && !sub_byte_ok)
    return false;
  if (!(bit_depth == 1 || bit_depth == 2 || bit_depth == 4 || bit_depth == 8 ||
        bit_depth == 16))
    return false;
  if (color_type == 3 && palette.empty()) return false;

  size_t bits_pp = size_t(channels) * bit_depth;
  int bpp = int((bits_pp + 7) / 8);  // filter byte distance, min 1
  if (bpp < 1) bpp = 1;

  // Pass geometry: one full pass, or the 7 Adam7 sub-grids.
  int n_passes = interlace ? 7 : 1;
  uint32_t pw[7], ph[7];
  size_t pstride[7], expected = 0;
  for (int p = 0; p < n_passes; p++) {
    if (interlace) {
      pw[p] = w > kA7x0[p] ? (w - kA7x0[p] + kA7dx[p] - 1) / kA7dx[p] : 0;
      ph[p] = h > kA7y0[p] ? (h - kA7y0[p] + kA7dy[p] - 1) / kA7dy[p] : 0;
    } else {
      pw[p] = w;
      ph[p] = h;
    }
    pstride[p] = (size_t(pw[p]) * bits_pp + 7) / 8;
    if (pw[p] && ph[p]) expected += (pstride[p] + 1) * ph[p];
  }

  std::vector<uint8_t> raw;
  if (!zlib_inflate(idat.data(), idat.size(), raw, expected)) return false;

  size_t n_entries = palette.size() / 3;
  // Gray sub-8 scale factor: v * 255 / (2^d - 1).
  int gray_scale = bit_depth < 8 ? 255 / ((1 << bit_depth) - 1) : 1;
  int sample_bytes = bit_depth == 16 ? 2 : 1;

  rgba.assign(size_t(w) * h * 4, 0);
  size_t off = 0;
  for (int p = 0; p < n_passes; p++) {
    if (!pw[p] || !ph[p]) continue;
    std::vector<uint8_t> sub(raw.begin() + off,
                             raw.begin() + off + (pstride[p] + 1) * ph[p]);
    off += (pstride[p] + 1) * ph[p];
    std::vector<uint8_t> pix;
    if (!unfilter_scanlines(sub, ph[p], pstride[p], bpp, pix)) return false;

    for (uint32_t j = 0; j < ph[p]; j++) {
      const uint8_t* row = &pix[j * pstride[p]];
      for (uint32_t i = 0; i < pw[p]; i++) {
        uint32_t x = interlace ? kA7x0[p] + i * kA7dx[p] : i;
        uint32_t y = interlace ? kA7y0[p] + j * kA7dy[p] : j;
        uint8_t* d = &rgba[(size_t(y) * w + x) * 4];
        if (bit_depth < 8) {
          uint32_t bitpos = i * bit_depth;
          uint32_t v = (row[bitpos >> 3] >> (8 - bit_depth - (bitpos & 7))) &
                       ((1u << bit_depth) - 1);
          if (color_type == 3) {
            if (v >= n_entries) return false;
            d[0] = palette[v * 3];
            d[1] = palette[v * 3 + 1];
            d[2] = palette[v * 3 + 2];
            d[3] = v < trns.size() ? trns[v] : 255;
          } else {  // sub-8 gray
            uint8_t g = uint8_t(v * gray_scale);
            d[0] = d[1] = d[2] = g;
            d[3] = 255;
          }
          continue;
        }
        // 8/16-bit samples: take the high byte of each (16->8 standard).
        const uint8_t* s = &row[size_t(i) * channels * sample_bytes];
        uint8_t c0 = s[0];
        uint8_t c1 = channels > 1 ? s[1 * sample_bytes] : 0;
        uint8_t c2 = channels > 2 ? s[2 * sample_bytes] : 0;
        uint8_t c3 = channels > 3 ? s[3 * sample_bytes] : 0;
        switch (color_type) {
          case 0: d[0] = d[1] = d[2] = c0; d[3] = 255; break;
          case 3:
            if (c0 >= n_entries) return false;
            d[0] = palette[c0 * 3];
            d[1] = palette[c0 * 3 + 1];
            d[2] = palette[c0 * 3 + 2];
            d[3] = c0 < trns.size() ? trns[c0] : 255;
            break;
          case 4: d[0] = d[1] = d[2] = c0; d[3] = c1; break;
          case 2: d[0] = c0; d[1] = c1; d[2] = c2; d[3] = 255; break;
          case 6: d[0] = c0; d[1] = c1; d[2] = c2; d[3] = c3; break;
        }
      }
    }
  }
  *out_w = w;
  *out_h = h;
  return true;
}

bool write_file(const char* path, const uint8_t* data, size_t len) {
  FILE* f = fopen(path, "wb");
  if (!f) return false;
  size_t n = fwrite(data, 1, len, f);
  fclose(f);
  return n == len;
}

// ---------------------------------------------------------------------------
// Async frame writer (worker pool)
// ---------------------------------------------------------------------------

struct FrameJob {
  std::string path;
  std::vector<uint8_t> pixels;
  uint32_t w, h;
  int channels;
};

class FrameWriter {
 public:
  explicit FrameWriter(int n_threads) : stop_(false), errors_(0), pending_(0) {
    for (int i = 0; i < n_threads; i++)
      workers_.emplace_back([this] { worker(); });
  }

  ~FrameWriter() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  void enqueue(FrameJob&& job) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      jobs_.push_back(std::move(job));
      pending_++;
    }
    cv_.notify_one();
  }

  void flush() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return pending_ == 0; });
  }

  int errors() const { return errors_.load(); }

 private:
  void worker() {
    for (;;) {
      FrameJob job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
        if (jobs_.empty()) {
          if (stop_) return;
          continue;
        }
        job = std::move(jobs_.front());
        jobs_.pop_front();
      }
      std::vector<uint8_t> png;
      bool ok = encode_png_mem(job.pixels.data(), job.w, job.h, job.channels,
                               png, Z_DEFAULT_COMPRESSION) &&
                write_file(job.path.c_str(), png.data(), png.size());
      if (!ok) errors_++;
      {
        std::unique_lock<std::mutex> lk(mu_);
        if (--pending_ == 0) done_cv_.notify_all();
      }
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  std::deque<FrameJob> jobs_;
  std::vector<std::thread> workers_;
  bool stop_;
  std::atomic<int> errors_;
  int pending_;
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Returns 0 on success. Encodes and writes synchronously.
int cnr_encode_png(const char* path, const uint8_t* pixels, uint32_t w,
                   uint32_t h, int channels, int level) {
  std::vector<uint8_t> png;
  if (!encode_png_mem(pixels, w, h, channels, png, level)) return 1;
  return write_file(path, png.data(), png.size()) ? 0 : 2;
}

// Two-phase decode: first call with rgba_out=null to get dimensions, then
// call again with a w*h*4 buffer.
int cnr_decode_png(const uint8_t* data, size_t len, uint8_t* rgba_out,
                   uint32_t* w, uint32_t* h) {
  std::vector<uint8_t> rgba;
  if (!decode_png_mem(data, len, rgba, w, h)) return 1;
  if (rgba_out) memcpy(rgba_out, rgba.data(), rgba.size());
  return 0;
}

void* cnr_writer_create(int n_threads) {
  return new FrameWriter(n_threads > 0 ? n_threads : 2);
}

void cnr_writer_enqueue(void* writer, const char* path, const uint8_t* pixels,
                        uint32_t w, uint32_t h, int channels) {
  FrameJob job;
  job.path = path;
  job.pixels.assign(pixels, pixels + size_t(w) * h * channels);
  job.w = w;
  job.h = h;
  job.channels = channels;
  static_cast<FrameWriter*>(writer)->enqueue(std::move(job));
}

int cnr_writer_flush(void* writer) {
  auto* fw = static_cast<FrameWriter*>(writer);
  fw->flush();
  return fw->errors();
}

void cnr_writer_destroy(void* writer) {
  delete static_cast<FrameWriter*>(writer);
}

}  // extern "C"
