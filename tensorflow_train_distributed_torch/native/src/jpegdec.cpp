// Native JPEG decode stage for the input pipeline (the PyTorch port's
// copy of the JAX package's decoder).
//
// The reference's image input runs tf.image's C++ JPEG kernels inside
// tf.data (SURVEY §2.1 "tf.data input pipelines" / §2.3 dataset
// kernels); the rebuild's Python path decodes through PIL, which holds
// the GIL for part of each decode and caps one process at ~one core.
// This unit is the native analog: libjpeg decode behind a plain C ABI,
// with
//
//   - a thread-pool batch entry point (ttd_jpeg_decode_batch) that
//     decodes N records concurrently while Python has released the GIL
//     in the ctypes call — host decode scales with cores, not processes;
//   - DCT-domain downscaling (scale_denom in {1,2,4,8}): libjpeg
//     reconstructs at 1/2, 1/4, 1/8 resolution for a fraction of the
//     IDCT + color-convert work — the cheap first step when the model
//     only needs a 224px crop from a multi-megapixel JPEG.
//
// Built as a SEPARATE shared library (libttd_jpeg.so, linked -ljpeg) so
// the main native library keeps zero external dependencies; environments
// without libjpeg decode through PIL where the caller allows it
// (native/jpeg.py raises where the native path was asked for).  Color handling: grayscale and YCbCr convert to RGB in
// libjpeg; exotic spaces (CMYK/YCCK) return an error and the Python
// caller falls back to PIL.

#include <cstddef>
#include <cstdio>  // jpeglib.h uses FILE/size_t without including them

#include <jpeglib.h>

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorTrap {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  ErrorTrap* trap = reinterpret_cast<ErrorTrap*>(cinfo->err);
  longjmp(trap->jump, 1);
}

void silence(j_common_ptr, int) {}
void silence_msg(j_common_ptr) {}

// Shared decode core.  mode 0: dims only.  mode 1: full decode into out.
// Returns 0 ok, -1 corrupt/unsupported, -2 out buffer too small.
int decode_impl(const uint8_t* data, uint64_t len, int scale_denom,
                uint8_t* out, uint64_t cap, int* w, int* h, int mode) {
  if (data == nullptr || len == 0) return -1;
  if (scale_denom != 1 && scale_denom != 2 && scale_denom != 4 &&
      scale_denom != 8)
    return -1;
  jpeg_decompress_struct cinfo;
  ErrorTrap trap;
  cinfo.err = jpeg_std_error(&trap.mgr);
  trap.mgr.error_exit = on_error;
  trap.mgr.emit_message = silence;
  trap.mgr.output_message = silence_msg;
  if (setjmp(trap.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = static_cast<unsigned>(scale_denom);
  cinfo.out_color_space = JCS_RGB;  // converts grayscale/YCbCr; not CMYK
  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;  // caller falls back to PIL
  }
  jpeg_calc_output_dimensions(&cinfo);
  if (w) *w = static_cast<int>(cinfo.output_width);
  if (h) *h = static_cast<int>(cinfo.output_height);
  if (mode == 0) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  const uint64_t row_bytes = 3ull * cinfo.output_width;
  if (cap < row_bytes * cinfo.output_height) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_start_decompress(&cinfo);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + row_bytes * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // namespace

extern "C" {

// Output dimensions at scale_denom WITHOUT decoding pixel data.
int ttd_jpeg_dims(const uint8_t* data, uint64_t len, int scale_denom,
                  int* w, int* h) {
  return decode_impl(data, len, scale_denom, nullptr, 0, w, h, 0);
}

// Decode to tightly-packed RGB8 rows. Returns 0 / -1 / -2 (see above).
int ttd_jpeg_decode_rgb(const uint8_t* data, uint64_t len, int scale_denom,
                        uint8_t* out, uint64_t cap, int* w, int* h) {
  return decode_impl(data, len, scale_denom, out, cap, w, h, 1);
}

// Thread-pool batch decode: element i of datas/lens decodes into outs[i]
// (capacity caps[i]); ws/hs receive dims; rcs (optional) per-image codes.
// Returns the number of failed images.
int ttd_jpeg_decode_batch(int n, const uint8_t* const* datas,
                          const uint64_t* lens, int scale_denom,
                          uint8_t* const* outs, const uint64_t* caps,
                          int* ws, int* hs, int* rcs, int num_threads) {
  if (n <= 0) return 0;
  if (num_threads < 1) num_threads = 1;
  if (num_threads > n) num_threads = n;
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int rc = decode_impl(datas[i], lens[i], scale_denom,
                           outs[i], caps[i], ws ? ws + i : nullptr,
                           hs ? hs + i : nullptr, 1);
      if (rcs) rcs[i] = rc;
      if (rc != 0) failures.fetch_add(1);
    }
  };
  if (num_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(num_threads);
    for (int t = 0; t < num_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

}  // extern "C"
