// Host JPEG decoder of the data loader (libjpeg) into caller-owned
// buffers, with cv2's channel order.
//
// Copy of the two JPEG functions of `hrfuser_tpu/data/_native/loader.cpp`
// that the JAX loader calls (`jpeg_shape`, `decode_jpeg_bgr`); PNG files
// are read by `hrfuser_tpu_torch/data/png.py`. It runs on the host, not
// on the card: the loader reads files on the CPU, and the card's machine
// has no `cv2`. Exposed through a C ABI for ctypes (hrfuser_tpu_torch/
// data/native.py), which builds it with
//
//   g++ -O3 -shared -fPIC loader.cpp -o libhrfuser_loader.so -ljpeg
//
// Every function returns 0 on success: 1 if the file cannot be opened,
// 2 if the library reports an error, 3 if the file's size is not the
// size the caller allocated for.

#include <csetjmp>
#include <cstdint>
#include <cstdio>

#include <jpeglib.h>

extern "C" {

struct JErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void jerr_exit(j_common_ptr cinfo) {
  JErr* e = reinterpret_cast<JErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// JPEG: its height, width and component count.
int jpeg_shape(const char* path, int* h, int* w, int* c) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  jpeg_decompress_struct cinfo;
  JErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jerr_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  *c = cinfo.num_components;
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return 0;
}

// JPEG into uint8 BGR HWC (libjpeg-turbo's JCS_EXT_BGR), as cv2 gives it.
int decode_jpeg_bgr(const char* path, uint8_t* out, int h, int w) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  jpeg_decompress_struct cinfo;
  JErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jerr_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_EXT_BGR;
  jpeg_start_decompress(&cinfo);
  if ((int)cinfo.output_height != h || (int)cinfo.output_width != w) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return 3;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + (size_t)cinfo.output_scanline * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return 0;
}

}  // extern "C"
