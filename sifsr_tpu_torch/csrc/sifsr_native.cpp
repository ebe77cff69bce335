// sifsr_native: host-side raster I/O runtime for the SIF-SR framework.
//
// The reference's data loader is a Python torch Dataset that re-opens and
// GDAL-decodes both GeoTIFFs of a pair on every __getitem__
// (reference dataset.py:124-125) — the training hot loop is bounded by
// single-threaded host decode. This library provides the native equivalent:
// a minimal classic-TIFF decoder (strips, compression none/deflate, float/int
// samples) and a pthread-pool batch loader that decodes + normalises many
// patches concurrently into one contiguous float32 batch ready for
// device upload.
//
// Exposed C ABI (consumed via ctypes from sifsr_tpu_torch.data.native_loader):
//   int sifsr_tiff_info(const char* path, int32_t* height, int32_t* width);
//   int sifsr_tiff_read_f32(const char* path, float* out, int64_t capacity);
//   int sifsr_load_batch_f32(const char** paths, int32_t n,
//                            int32_t height, int32_t width,
//                            float mean, float inv_std,
//                            float* out, int32_t n_threads);
// Return codes: 0 ok, negative = error (see SIFSR_ERR_*).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <pthread.h>
#include <vector>
#include <zlib.h>

#define SIFSR_ERR_OPEN -1
#define SIFSR_ERR_FORMAT -2
#define SIFSR_ERR_UNSUPPORTED -3
#define SIFSR_ERR_SIZE -4
#define SIFSR_ERR_DECODE -5

namespace {

struct Buf {
  std::vector<uint8_t> data;
  bool big_endian = false;

  uint16_t u16(size_t off) const {
    if (off + 2 > data.size()) return 0;
    return big_endian ? (data[off] << 8) | data[off + 1]
                      : (data[off + 1] << 8) | data[off];
  }
  uint32_t u32(size_t off) const {
    if (off + 4 > data.size()) return 0;
    return big_endian
               ? ((uint32_t)data[off] << 24) | ((uint32_t)data[off + 1] << 16) |
                     ((uint32_t)data[off + 2] << 8) | data[off + 3]
               : ((uint32_t)data[off + 3] << 24) | ((uint32_t)data[off + 2] << 16) |
                     ((uint32_t)data[off + 1] << 8) | data[off];
  }
};

static int read_file(const char* path, Buf* buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return SIFSR_ERR_OPEN;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  buf->data.resize(size);
  size_t got = fread(buf->data.data(), 1, size, f);
  fclose(f);
  return got == (size_t)size ? 0 : SIFSR_ERR_OPEN;
}

struct TiffMeta {
  uint32_t width = 0, height = 0;
  uint16_t bits = 8, compression = 1, sample_format = 1, samples = 1;
  uint32_t rows_per_strip = 0;
  bool tiled = false;
  std::vector<uint32_t> strip_offsets, strip_counts;
};

static const int TYPE_SIZE[13] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8};


class Tiff {
 public:
  Buf buf;
  TiffMeta meta;

  int open(const char* path) {
    int rc = read_file(path, &buf);
    if (rc) return rc;
    if (buf.data.size() < 8) return SIFSR_ERR_FORMAT;
    if (buf.data[0] == 'I' && buf.data[1] == 'I') buf.big_endian = false;
    else if (buf.data[0] == 'M' && buf.data[1] == 'M') buf.big_endian = true;
    else return SIFSR_ERR_FORMAT;
    if (buf.u16(2) != 42) return SIFSR_ERR_FORMAT;
    uint32_t ifd = buf.u32(4);
    uint16_t n = buf.u16(ifd);
    // the IFD promises n 12-byte entries: a file that cannot hold them is
    // truncated (u16/u32 would silently read the lost entries as zeros,
    // dropping tags like SampleFormat and decoding garbage without error)
    if (n == 0 || (size_t)ifd + 2 + 12 * (size_t)n > buf.data.size())
      return SIFSR_ERR_FORMAT;
    meta.rows_per_strip = 0;
    for (uint16_t i = 0; i < n; i++) {
      size_t e = ifd + 2 + 12 * (size_t)i;
      uint16_t tag = buf.u16(e), type = buf.u16(e + 2);
      uint32_t count = buf.u32(e + 4);
      size_t vsize = (type < 13 ? TYPE_SIZE[type] : 1) * (size_t)count;
      size_t voff = vsize <= 4 ? e + 8 : buf.u32(e + 8);
      // a conforming tag's value block lies inside the file; a lying
      // count/offset otherwise drives an unbounded resize + O(count) loop
      // below (a 4-byte field must not size a 15 GB allocation)
      if (voff > buf.data.size() || vsize > buf.data.size() - voff)
        return SIFSR_ERR_FORMAT;
      auto val = [&](uint32_t idx) -> uint32_t {
        int ts = type < 13 ? TYPE_SIZE[type] : 1;
        return type == 3 ? buf.u16(voff + idx * ts) : buf.u32(voff + idx * ts);
      };
      switch (tag) {
        case 256: meta.width = val(0); break;
        case 257: meta.height = val(0); break;
        case 258: meta.bits = val(0); break;
        case 259: meta.compression = val(0); break;
        case 277: meta.samples = val(0); break;
        case 278: meta.rows_per_strip = val(0); break;
        case 339: meta.sample_format = val(0); break;
        case 273:
          meta.strip_offsets.resize(count);
          for (uint32_t k = 0; k < count; k++) meta.strip_offsets[k] = val(k);
          break;
        case 322: case 324:  // TileWidth / TileOffsets
          meta.tiled = true;
          break;
        case 279:
          meta.strip_counts.resize(count);
          for (uint32_t k = 0; k < count; k++) meta.strip_counts[k] = val(k);
          break;
        default: break;
      }
    }
    if (meta.rows_per_strip == 0) meta.rows_per_strip = meta.height;
    if (meta.samples != 1) return SIFSR_ERR_UNSUPPORTED;
    if (meta.compression != 1 && meta.compression != 8 && meta.compression != 32946)
      return SIFSR_ERR_UNSUPPORTED;
    // a valid-but-tiled TIFF is unsupported here, not corrupt: the caller
    // can route it to the pure-python reader (which handles tiles)
    if (meta.tiled) return SIFSR_ERR_UNSUPPORTED;
    if (meta.strip_offsets.empty() || meta.strip_offsets.size() != meta.strip_counts.size())
      return SIFSR_ERR_FORMAT;
    // reject hostile/corrupt geometry before any size arithmetic: zero dims,
    // sample widths convert() doesn't handle, and products that overflow the
    // int64 pixel math (MODIS granules are <=4800^2; 2^40 px is generous)
    if (meta.width == 0 || meta.height == 0) return SIFSR_ERR_FORMAT;
    // exactly the (sample_format, bits) combos convert() implements — any
    // other valid TIFF (e.g. GDAL Int32) must fall back to the python
    // reader, not silently decode to zeros
    switch ((meta.sample_format << 8) | meta.bits) {
      case (3 << 8) | 32: case (3 << 8) | 64:
      case (1 << 8) | 8:  case (1 << 8) | 16:
      case (2 << 8) | 16:
        break;
      default:
        return SIFSR_ERR_UNSUPPORTED;
    }
    if ((uint64_t)meta.width * (uint64_t)meta.height > (1ull << 40))
      return SIFSR_ERR_FORMAT;
    return 0;
  }

  // decode into float32 row-major (height*width)
  int decode(float* out, int64_t capacity) const {
    const int64_t total = (int64_t)meta.width * meta.height;
    if (capacity < total) return SIFSR_ERR_SIZE;
    const size_t sample_bytes = meta.bits / 8;
    const size_t row_bytes = (size_t)meta.width * sample_bytes;
    std::vector<uint8_t> scratch;

    uint32_t row = 0;
    for (size_t s = 0; s < meta.strip_offsets.size(); s++) {
      uint32_t rows = meta.rows_per_strip;
      if (row + rows > meta.height) rows = meta.height - row;
      // strip table values come from the file: bound them to the buffer
      // before forming the pointer (a lying offset/count would otherwise
      // read past the mapped file copy)
      if ((size_t)meta.strip_offsets[s] > buf.data.size() ||
          (size_t)meta.strip_counts[s] > buf.data.size() - meta.strip_offsets[s])
        return SIFSR_ERR_FORMAT;
      const uint8_t* src = buf.data.data() + meta.strip_offsets[s];
      size_t src_len = meta.strip_counts[s];
      size_t want = row_bytes * rows;
      const uint8_t* strip;
      if (meta.compression == 1) {
        if (src_len < want) return SIFSR_ERR_DECODE;
        strip = src;
      } else {  // deflate
        scratch.resize(want);
        uLongf dst_len = want;
        if (uncompress(scratch.data(), &dst_len, src, src_len) != Z_OK || dst_len != want)
          return SIFSR_ERR_DECODE;
        strip = scratch.data();
      }
      float* dst = out + (int64_t)row * meta.width;
      convert(strip, dst, (size_t)rows * meta.width);
      row += rows;
    }
    return 0;
  }

 private:
  void convert(const uint8_t* src, float* dst, size_t n) const {
    const bool be = buf.big_endian;
    switch ((meta.sample_format << 8) | meta.bits) {
      case (3 << 8) | 32: {  // float32
        if (!be) {
          memcpy(dst, src, n * 4);
        } else {
          for (size_t i = 0; i < n; i++) {
            uint32_t v = ((uint32_t)src[4 * i] << 24) | ((uint32_t)src[4 * i + 1] << 16) |
                         ((uint32_t)src[4 * i + 2] << 8) | src[4 * i + 3];
            memcpy(dst + i, &v, 4);
          }
        }
        break;
      }
      case (3 << 8) | 64: {  // float64
        for (size_t i = 0; i < n; i++) {
          uint64_t v = 0;
          for (int b = 0; b < 8; b++)
            v |= (uint64_t)src[8 * i + b] << (be ? (56 - 8 * b) : (8 * b));
          double d;
          memcpy(&d, &v, 8);
          dst[i] = (float)d;
        }
        break;
      }
      case (1 << 8) | 8:
        for (size_t i = 0; i < n; i++) dst[i] = src[i];
        break;
      case (1 << 8) | 16:
        for (size_t i = 0; i < n; i++)
          dst[i] = be ? (uint16_t)((src[2 * i] << 8) | src[2 * i + 1])
                      : (uint16_t)((src[2 * i + 1] << 8) | src[2 * i]);
        break;
      case (2 << 8) | 16:
        for (size_t i = 0; i < n; i++) {
          uint16_t v = be ? (uint16_t)((src[2 * i] << 8) | src[2 * i + 1])
                          : (uint16_t)((src[2 * i + 1] << 8) | src[2 * i]);
          dst[i] = (int16_t)v;
        }
        break;
      default:
        for (size_t i = 0; i < n; i++) dst[i] = 0.0f;
    }
  }
};

struct BatchJob {
  const char** paths;
  int32_t n;
  int32_t height, width;
  float mean, inv_std;
  float* out;
  int32_t next;          // work index
  int rc;                // first error
  pthread_mutex_t lock;
};

static void* batch_worker(void* arg) {
  BatchJob* job = (BatchJob*)arg;
  for (;;) {
    pthread_mutex_lock(&job->lock);
    int32_t i = job->next++;
    pthread_mutex_unlock(&job->lock);
    if (i >= job->n) break;

    Tiff t;
    int rc = t.open(job->paths[i]);
    if (rc == 0 && ((int32_t)t.meta.height != job->height ||
                    (int32_t)t.meta.width != job->width))
      rc = SIFSR_ERR_SIZE;
    int64_t plane = (int64_t)job->height * job->width;
    if (rc == 0) rc = t.decode(job->out + i * plane, plane);
    if (rc == 0 && (job->mean != 0.0f || job->inv_std != 1.0f)) {
      float* p = job->out + i * plane;
      for (int64_t k = 0; k < plane; k++) p[k] = (p[k] - job->mean) * job->inv_std;
    }
    if (rc != 0) {
      pthread_mutex_lock(&job->lock);
      if (job->rc == 0) job->rc = rc;
      pthread_mutex_unlock(&job->lock);
    }
  }
  return nullptr;
}

}  // namespace

extern "C" {

int sifsr_tiff_info(const char* path, int32_t* height, int32_t* width) {
  Tiff t;
  int rc = t.open(path);
  if (rc) return rc;
  *height = t.meta.height;
  *width = t.meta.width;
  return 0;
}

int sifsr_tiff_read_f32(const char* path, float* out, int64_t capacity) {
  Tiff t;
  int rc = t.open(path);
  if (rc) return rc;
  return t.decode(out, capacity);
}

int sifsr_load_batch_f32(const char** paths, int32_t n, int32_t height,
                         int32_t width, float mean, float inv_std, float* out,
                         int32_t n_threads) {
  if (n <= 0) return 0;
  BatchJob job{paths, n, height, width, mean, inv_std, out, 0, 0,
               PTHREAD_MUTEX_INITIALIZER};
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::vector<pthread_t> threads(n_threads);
  for (int i = 0; i < n_threads; i++)
    pthread_create(&threads[i], nullptr, batch_worker, &job);
  for (int i = 0; i < n_threads; i++) pthread_join(threads[i], nullptr);
  return job.rc;
}

}  // extern "C"
