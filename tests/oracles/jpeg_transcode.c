/* A JPEG transcoder built on the system's libjpeg, for testing decoders.

     jpeg_transcode progressive|arith|arith-progressive [restart]
                    < in.jpg > out.jpg
     jpeg_transcode cmyk|ycck WIDTH HEIGHT QUALITY < pixels > out.jpg

The first form reads a JPEG's quantised coefficients and writes them back
unchanged (as jpegtran does) with libjpeg's progressive script
(jpeg_simple_progression), arithmetic coding, or both, and an optional
restart interval in MCUs. The second compresses WIDTH x HEIGHT
interleaved CMYK bytes into a 4-component JPEG, stored as CMYK or as
YCCK, with the Adobe marker libjpeg writes for both. Exit status 0, or
1 with libjpeg's message on stderr.

Built by the JPEG decoder's tests with `cc ... -ljpeg`; they skip the
cases that need it where it does not build. */

#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

struct err {
  struct jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void fail(j_common_ptr cinfo) {
  (*cinfo->err->output_message)(cinfo);
  longjmp(((struct err *)cinfo->err)->jb, 1);
}

static unsigned char *slurp(size_t *n) {
  size_t cap = 1 << 16;
  unsigned char *buf = malloc(cap);
  *n = 0;
  for (;;) {
    size_t got = fread(buf + *n, 1, cap - *n, stdin);
    *n += got;
    if (*n < cap) return buf;
    cap *= 2;
    buf = realloc(buf, cap);
  }
}

int main(int argc, char **argv) {
  struct jpeg_compress_struct out;
  struct jpeg_decompress_struct in;
  struct err e;
  size_t n;
  unsigned char *data, *obuf = NULL;
  unsigned long olen = 0;
  const char *mode = argc > 1 ? argv[1] : "";
  int four = !strcmp(mode, "cmyk") || !strcmp(mode, "ycck");

  if (argc < 2 || (four && argc != 5)) {
    fprintf(stderr, "usage: see the source\n");
    return 2;
  }
  data = slurp(&n);
  out.err = in.err = jpeg_std_error(&e.mgr);
  e.mgr.error_exit = fail;
  if (setjmp(e.jb)) return 1;
  jpeg_create_compress(&out);
  jpeg_mem_dest(&out, &obuf, &olen);
  if (four) {
    int w = atoi(argv[2]), h = atoi(argv[3]);
    if ((size_t)w * h * 4 != n) {
      fprintf(stderr, "expected %d bytes of CMYK\n", w * h * 4);
      return 2;
    }
    out.image_width = w;
    out.image_height = h;
    out.input_components = 4;
    out.in_color_space = JCS_CMYK;
    jpeg_set_defaults(&out);
    jpeg_set_colorspace(&out, mode[0] == 'c' ? JCS_CMYK : JCS_YCCK);
    jpeg_set_quality(&out, atoi(argv[4]), TRUE);
    jpeg_start_compress(&out, TRUE);
    while (out.next_scanline < out.image_height) {
      JSAMPROW row = data + (size_t)out.next_scanline * w * 4;
      jpeg_write_scanlines(&out, &row, 1);
    }
    jpeg_finish_compress(&out);
  } else {
    jvirt_barray_ptr *coefs;
    jpeg_create_decompress(&in);
    jpeg_mem_src(&in, data, n);
    jpeg_read_header(&in, TRUE);
    coefs = jpeg_read_coefficients(&in);
    jpeg_copy_critical_parameters(&in, &out);
    if (strstr(mode, "progressive")) jpeg_simple_progression(&out);
    out.arith_code = strncmp(mode, "arith", 5) == 0;
    out.optimize_coding = FALSE;
    if (argc > 2) out.restart_interval = atoi(argv[2]);
    jpeg_write_coefficients(&out, coefs);
    jpeg_finish_compress(&out);
    jpeg_finish_decompress(&in);
    jpeg_destroy_decompress(&in);
  }
  jpeg_destroy_compress(&out);
  fwrite(obuf, 1, olen, stdout);
  return 0;
}
