// Native data loader for libstacker_tpu.
//
// Host counterpart of the reference's decode path: the Rust crate
// delegates image IO to OpenCV imgcodecs (C++) and fans file decodes out
// over Rayon threads (reference src/utils.rs:111-144, src/lib.rs:188).
// Here: libjpeg/libpng decode on a std::thread pool, writing RGB8 frames
// directly into one caller-owned batched [N,H,W,3] buffer — the staging
// buffer for a single host->HBM transfer.  Exposed via a C ABI consumed
// with ctypes (libstacker_tpu/utils/native_loader.py).
//
// Build: make -C native   (produces libstacker_io.so)

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <tiffio.h>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

constexpr int kOk = 0;
constexpr int kErrOpen = 1;
constexpr int kErrDecode = 2;
constexpr int kErrSize = 3;
constexpr int kErrFormat = 4;

bool has_suffix(const std::string& s, const char* suf) {
  std::string lower(s);
  for (auto& c : lower) c = (char)tolower(c);
  std::string t(suf);
  return lower.size() >= t.size() &&
         lower.compare(lower.size() - t.size(), t.size(), t) == 0;
}

// --- JPEG ---------------------------------------------------------------

int decode_jpeg(FILE* f, uint8_t* out, int64_t want_h, int64_t want_w,
                int64_t* got_h, int64_t* got_w, bool probe_only) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return kErrDecode;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *got_h = cinfo.output_height;
  *got_w = cinfo.output_width;
  if (probe_only) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return kOk;
  }
  if ((int64_t)cinfo.output_height != want_h ||
      (int64_t)cinfo.output_width != want_w ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return kErrSize;
  }
  const int64_t stride = want_w * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + (int64_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return kOk;
}

// --- PNG ----------------------------------------------------------------

int decode_png(FILE* f, uint8_t* out, int64_t want_h, int64_t want_w,
               int64_t* got_h, int64_t* got_w, bool probe_only) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return kErrDecode;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return kErrDecode;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrDecode;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  *got_h = png_get_image_height(png, info);
  *got_w = png_get_image_width(png, info);
  if (probe_only) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kOk;
  }
  if (*got_h != want_h || *got_w != want_w) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrSize;
  }
  // normalise to 8-bit RGB
  png_byte color_type = png_get_color_type(png, info);
  png_byte bit_depth = png_get_bit_depth(png, info);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color_type & PNG_COLOR_MASK_ALPHA ||
      png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  png_read_update_info(png, info);

  const int64_t stride = want_w * 3;
  std::vector<png_bytep> rows(want_h);
  for (int64_t y = 0; y < want_h; ++y) rows[y] = out + y * stride;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return kOk;
}

// --- TIFF ---------------------------------------------------------------

int decode_tiff(const char* path, uint8_t* out, int64_t want_h,
                int64_t want_w, int64_t* got_h, int64_t* got_w,
                bool probe_only) {
  TIFFSetWarningHandler(nullptr);  // silence tag warnings on the pool
  TIFF* tif = TIFFOpen(path, "r");
  if (!tif) return kErrDecode;
  uint32_t w32 = 0, h32 = 0;
  TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &w32);
  TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &h32);
  *got_h = (int64_t)h32;
  *got_w = (int64_t)w32;
  if (probe_only) {
    TIFFClose(tif);
    return kOk;
  }
  if ((int64_t)h32 != want_h || (int64_t)w32 != want_w) {
    TIFFClose(tif);
    return kErrSize;
  }
  // The RGBA convenience path handles every TIFF flavour (incl. 16-bit,
  // which libtiff scales to 8 bits) at the cost of one extra buffer.
  std::vector<uint32_t> rgba((size_t)w32 * (size_t)h32);
  if (!TIFFReadRGBAImageOriented(tif, w32, h32, rgba.data(),
                                 ORIENTATION_TOPLEFT, 0)) {
    TIFFClose(tif);
    return kErrDecode;
  }
  TIFFClose(tif);
  const int64_t npx = (int64_t)w32 * (int64_t)h32;
  for (int64_t i = 0; i < npx; ++i) {
    const uint32_t px = rgba[(size_t)i];
    out[i * 3 + 0] = (uint8_t)TIFFGetR(px);
    out[i * 3 + 1] = (uint8_t)TIFFGetG(px);
    out[i * 3 + 2] = (uint8_t)TIFFGetB(px);
  }
  return kOk;
}

// --- 16-bit decode (full-depth path) -------------------------------------
//
// Counterpart of imread(..., IMREAD_UNCHANGED | IMREAD_COLOR) for 16-bit
// sources: PNG decodes natively (libpng expand_16 promotes 8-bit content
// by x257, the exact range expansion), 16-bit contiguous TIFF decodes by
// scanline, everything else decodes at 8 bits and expands.  Output is
// native-endian uint16 RGB [h, w, 3].

int decode_png16(FILE* f, uint16_t* out, int64_t want_h, int64_t want_w,
                 int64_t* got_h, int64_t* got_w) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return kErrDecode;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return kErrDecode;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrDecode;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  *got_h = png_get_image_height(png, info);
  *got_w = png_get_image_width(png, info);
  if (*got_h != want_h || *got_w != want_w) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrSize;
  }
  png_byte color_type = png_get_color_type(png, info);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_expand_16(png);  // 8-bit (and lower) samples -> x257
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color_type & PNG_COLOR_MASK_ALPHA ||
      png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  const uint16_t probe = 1;
  if (*reinterpret_cast<const uint8_t*>(&probe) == 1)
    png_set_swap(png);  // big-endian file samples -> native
  png_read_update_info(png, info);

  std::vector<png_bytep> rows(want_h);
  for (int64_t y = 0; y < want_h; ++y)
    rows[y] = (png_bytep)(out + y * want_w * 3);
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return kOk;
}

int decode_tiff16(const char* path, uint16_t* out, int64_t want_h,
                  int64_t want_w, int64_t* got_h, int64_t* got_w) {
  TIFFSetWarningHandler(nullptr);
  TIFF* tif = TIFFOpen(path, "r");
  if (!tif) return kErrDecode;
  uint32_t w32 = 0, h32 = 0;
  uint16_t bits = 0, samples = 0, planar = PLANARCONFIG_CONTIG;
  uint16_t photometric = PHOTOMETRIC_MINISBLACK, format = SAMPLEFORMAT_UINT;
  TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &w32);
  TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &h32);
  TIFFGetFieldDefaulted(tif, TIFFTAG_BITSPERSAMPLE, &bits);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLESPERPIXEL, &samples);
  TIFFGetFieldDefaulted(tif, TIFFTAG_PLANARCONFIG, &planar);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLEFORMAT, &format);
  TIFFGetField(tif, TIFFTAG_PHOTOMETRIC, &photometric);
  *got_h = (int64_t)h32;
  *got_w = (int64_t)w32;
  if ((int64_t)h32 != want_h || (int64_t)w32 != want_w) {
    TIFFClose(tif);
    return kErrSize;
  }
  const bool native16 =
      bits == 16 && (samples == 1 || samples == 3 || samples == 4) &&
      planar == PLANARCONFIG_CONTIG && format == SAMPLEFORMAT_UINT &&
      (photometric == PHOTOMETRIC_MINISBLACK ||
       photometric == PHOTOMETRIC_RGB) &&
      !TIFFIsTiled(tif);
  if (native16) {
    std::vector<uint16_t> row((size_t)w32 * samples);
    for (int64_t y = 0; y < want_h; ++y) {
      if (TIFFReadScanline(tif, row.data(), (uint32_t)y) < 0) {
        TIFFClose(tif);
        return kErrDecode;
      }
      uint16_t* dst = out + y * want_w * 3;
      if (samples == 1) {
        for (int64_t x = 0; x < want_w; ++x)
          dst[x * 3 + 0] = dst[x * 3 + 1] = dst[x * 3 + 2] = row[x];
      } else {
        for (int64_t x = 0; x < want_w; ++x) {
          dst[x * 3 + 0] = row[x * samples + 0];
          dst[x * 3 + 1] = row[x * samples + 1];
          dst[x * 3 + 2] = row[x * samples + 2];
        }
      }
    }
    TIFFClose(tif);
    return kOk;
  }
  // everything else: RGBA8 convenience path, expand x257
  std::vector<uint32_t> rgba((size_t)w32 * (size_t)h32);
  if (!TIFFReadRGBAImageOriented(tif, w32, h32, rgba.data(),
                                 ORIENTATION_TOPLEFT, 0)) {
    TIFFClose(tif);
    return kErrDecode;
  }
  TIFFClose(tif);
  const int64_t npx = (int64_t)w32 * (int64_t)h32;
  for (int64_t i = 0; i < npx; ++i) {
    const uint32_t px = rgba[(size_t)i];
    out[i * 3 + 0] = (uint16_t)(TIFFGetR(px) * 257);
    out[i * 3 + 1] = (uint16_t)(TIFFGetG(px) * 257);
    out[i * 3 + 2] = (uint16_t)(TIFFGetB(px) * 257);
  }
  return kOk;
}

int decode_one16(const char* path, uint16_t* out, int64_t want_h,
                 int64_t want_w, int64_t* got_h, int64_t* got_w) {
  std::string p(path);
  if (has_suffix(p, ".tif") || has_suffix(p, ".tiff"))
    return decode_tiff16(path, out, want_h, want_w, got_h, got_w);
  if (has_suffix(p, ".png")) {
    FILE* f = fopen(path, "rb");
    if (!f) return kErrOpen;
    int rc = decode_png16(f, out, want_h, want_w, got_h, got_w);
    fclose(f);
    return rc;
  }
  if (has_suffix(p, ".jpg") || has_suffix(p, ".jpeg")) {
    // JPEG is 8-bit; decode and expand x257
    FILE* f = fopen(path, "rb");
    if (!f) return kErrOpen;
    std::vector<uint8_t> tmp((size_t)(want_h * want_w * 3));
    int rc = decode_jpeg(f, tmp.data(), want_h, want_w, got_h, got_w, false);
    fclose(f);
    if (rc != kOk) return rc;
    const int64_t n = want_h * want_w * 3;
    for (int64_t i = 0; i < n; ++i) out[i] = (uint16_t)(tmp[i] * 257);
    return kOk;
  }
  return kErrFormat;
}

int decode_one(const char* path, uint8_t* out, int64_t want_h, int64_t want_w,
               int64_t* got_h, int64_t* got_w, bool probe_only) {
  std::string p(path);
  if (has_suffix(p, ".tif") || has_suffix(p, ".tiff")) {
    // libtiff opens by path (its own IO layer)
    return decode_tiff(path, out, want_h, want_w, got_h, got_w, probe_only);
  }
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  int rc;
  if (has_suffix(p, ".png")) {
    rc = decode_png(f, out, want_h, want_w, got_h, got_w, probe_only);
  } else if (has_suffix(p, ".jpg") || has_suffix(p, ".jpeg")) {
    rc = decode_jpeg(f, out, want_h, want_w, got_h, got_w, probe_only);
  } else {
    rc = kErrFormat;
  }
  fclose(f);
  return rc;
}

}  // namespace

extern "C" {

// Probe image dimensions. Returns 0 on success.
int stacker_probe(const char* path, int64_t* h, int64_t* w) {
  return decode_one(path, nullptr, 0, 0, h, w, /*probe_only=*/true);
}

// Decode n files into out[n, h, w, 3] (uint8 RGB, C-contiguous) using a
// thread pool. statuses[n] receives a per-file status code (0 = ok).
// Returns the number of failed files.
int stacker_decode_batch(const char** paths, int64_t n, uint8_t* out,
                         int64_t h, int64_t w, int threads,
                         int* statuses) {
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  if (threads <= 0) threads = 1;
  if (threads > n) threads = (int)n;
  std::atomic<int64_t> next(0);
  std::atomic<int> failures(0);
  const int64_t frame_bytes = h * w * 3;

  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      int64_t gh = 0, gw = 0;
      int rc = decode_one(paths[i], out + i * frame_bytes, h, w, &gh, &gw,
                          false);
      statuses[i] = rc;
      if (rc != kOk) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return failures.load();
}

// Full-depth batch decode: n files into out[n, h, w, 3] native-endian
// uint16 RGB.  16-bit PNG/TIFF decode at depth; 8-bit sources expand
// x257 (the exact range expansion).  Same pool/status contract as
// stacker_decode_batch.
int stacker_decode_batch16(const char** paths, int64_t n, uint16_t* out,
                           int64_t h, int64_t w, int threads,
                           int* statuses) {
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  if (threads <= 0) threads = 1;
  if (threads > n) threads = (int)n;
  std::atomic<int64_t> next(0);
  std::atomic<int> failures(0);
  const int64_t frame_px = h * w * 3;

  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      int64_t gh = 0, gw = 0;
      int rc = decode_one16(paths[i], out + i * frame_px, h, w, &gh, &gw);
      statuses[i] = rc;
      if (rc != kOk) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return failures.load();
}

// Write a 16-bit RGB PNG from a C-contiguous native-endian uint16
// [h, w, 3] buffer.  Stacked outputs carry more than 8 bits of depth
// (a 100-frame mean has ~log2(100) extra bits); the reference's example
// can only save 8-bit PNGs (imgcodecs imwrite of an 8-bit Mat).
// Returns 0 on success.
int stacker_write_png16(const char* path, const uint16_t* rgb, int64_t h,
                        int64_t w) {
  FILE* f = fopen(path, "wb");
  if (!f) return kErrOpen;
  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr,
                              nullptr);
  if (!png) {
    fclose(f);
    return kErrDecode;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    fclose(f);
    return kErrDecode;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    fclose(f);
    return kErrDecode;
  }
  png_init_io(png, f);
  png_set_IHDR(png, info, (png_uint_32)w, (png_uint_32)h, 16,
               PNG_COLOR_TYPE_RGB, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  const uint16_t probe = 1;
  if (*reinterpret_cast<const uint8_t*>(&probe) == 1)
    png_set_swap(png);  // PNG samples are big-endian; buffer is native
  std::vector<png_bytep> rows((size_t)h);
  for (int64_t y = 0; y < h; ++y)
    rows[(size_t)y] = (png_bytep)(rgb + y * w * 3);
  png_write_image(png, rows.data());
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  fclose(f);
  return kOk;
}

// Fixed-point Rec.601 grayscale of a batch (same arithmetic as the
// device path: (9798 R + 19235 G + 3735 B + 2^14) >> 15).
void stacker_rgb_to_gray(const uint8_t* rgb, uint8_t* gray, int64_t npx,
                         int threads) {
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  if (threads <= 0) threads = 1;
  int64_t chunk = (npx + threads - 1) / threads;
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* p = rgb + i * 3;
      gray[i] = (uint8_t)((9798 * p[0] + 19235 * p[1] + 3735 * p[2] +
                           (1 << 14)) >> 15);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk, hi = std::min(npx, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(worker, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
