// Native image decode + threaded prefetch for the data pipeline.
//
// The port's own copy of nerficg_tpu/native/image_io.cpp, byte for byte in
// its decoding (reference equivalent: the torch.multiprocessing
// image-loading pools of src/Datasets/utils.py:115-149 and the preload
// pre-callback, src/Methods/Base/Trainer.py:122-161). Decoding is C++
// (libpng / libjpeg) with an std::thread worker pool behind a plain C ABI
// bound with ctypes (nerficg_torch/native/__init__.py); the decode threads
// run outside the GIL.
//
// API (all functions return 0 on success, negative error codes otherwise):
//   decode_image(path, &data, &h, &w, &c)   float32 HWC in [0,1], malloc'd
//   decode_batch(paths, n, n_threads, datas, hs, ws, cs, rcs)
//   free_buffer(ptr)
// Codes: -1 the file does not open, -2 not a PNG, -3 out of memory in
// libpng, -4 a libpng/libjpeg error (a damaged file), -5 malloc failed,
// -10 neither .png nor .jpg/.jpeg.
//
// Formats are normalised as the JAX package's decoder does: palette -> RGB
// (tRNS -> alpha), gray below 8 bits -> 8, 16 bits kept. 8-bit channels
// are multiplied by 1/255, 16-bit PNG channels by 1/65535.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <atomic>
#include <thread>
#include <vector>

#include <png.h>
#include <jpeglib.h>
#include <csetjmp>

extern "C" {

static int decode_png_file(const char* path, float** out, int* h, int* w,
                           int* c) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp) return -1;
    unsigned char header[8];
    if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
        std::fclose(fp);
        return -2;
    }
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    if (!png) { std::fclose(fp); return -3; }
    png_infop info = png_create_info_struct(png);
    if (!info) {
        png_destroy_read_struct(&png, nullptr, nullptr);
        std::fclose(fp);
        return -3;
    }
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        std::fclose(fp);
        return -4;
    }
    png_init_io(png, fp);
    png_set_sig_bytes(png, 8);
    png_read_info(png, info);

    png_uint_32 width = png_get_image_width(png, info);
    png_uint_32 height = png_get_image_height(png, info);
    int bit_depth = png_get_bit_depth(png, info);
    int color_type = png_get_color_type(png, info);

    // Normalize exotic formats: palette -> RGB, gray<8 -> 8, keep 16-bit.
    if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
        png_set_expand_gray_1_2_4_to_8(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    if (bit_depth == 16) png_set_swap(png);  // little-endian u16
    png_read_update_info(png, info);

    int channels = png_get_channels(png, info);
    bit_depth = png_get_bit_depth(png, info);
    size_t row_bytes = png_get_rowbytes(png, info);
    std::vector<unsigned char> raw((size_t)height * row_bytes);
    std::vector<png_bytep> rows(height);
    for (png_uint_32 y = 0; y < height; ++y)
        rows[y] = raw.data() + (size_t)y * row_bytes;
    png_read_image(png, rows.data());
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);

    size_t n = (size_t)height * width * channels;
    float* data = (float*)std::malloc(n * sizeof(float));
    if (!data) return -5;
    if (bit_depth == 16) {
        const uint16_t* src = (const uint16_t*)raw.data();
        const float s = 1.0f / 65535.0f;
        for (size_t i = 0; i < n; ++i) data[i] = src[i] * s;
    } else {
        const unsigned char* src = raw.data();
        const float s = 1.0f / 255.0f;
        for (size_t i = 0; i < n; ++i) data[i] = src[i] * s;
    }
    *out = data;
    *h = (int)height;
    *w = (int)width;
    *c = channels;
    return 0;
}

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jump;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* err = (JpegErr*)cinfo->err;
    longjmp(err->jump, 1);
}

static int decode_jpeg_file(const char* path, float** out, int* h, int* w,
                            int* c) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp) return -1;
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        std::fclose(fp);
        return -4;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, fp);
    jpeg_read_header(&cinfo, TRUE);
    jpeg_start_decompress(&cinfo);
    int width = cinfo.output_width;
    int height = cinfo.output_height;
    int channels = cinfo.output_components;
    size_t row_stride = (size_t)width * channels;
    std::vector<unsigned char> raw((size_t)height * row_stride);
    while ((int)cinfo.output_scanline < height) {
        unsigned char* rowp = raw.data() +
            (size_t)cinfo.output_scanline * row_stride;
        jpeg_read_scanlines(&cinfo, &rowp, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);

    size_t n = (size_t)height * row_stride;
    float* data = (float*)std::malloc(n * sizeof(float));
    if (!data) return -5;
    const float s = 1.0f / 255.0f;
    for (size_t i = 0; i < n; ++i) data[i] = raw[i] * s;
    *out = data;
    *h = height;
    *w = width;
    *c = channels;
    return 0;
}

static bool has_suffix(const char* path, const char* suf) {
    size_t lp = std::strlen(path), ls = std::strlen(suf);
    if (ls > lp) return false;
    for (size_t i = 0; i < ls; ++i) {
        char a = path[lp - ls + i], b = suf[i];
        if (a >= 'A' && a <= 'Z') a += 32;
        if (a != b) return false;
    }
    return true;
}

int decode_image(const char* path, float** out, int* h, int* w, int* c) {
    if (has_suffix(path, ".png")) return decode_png_file(path, out, h, w, c);
    if (has_suffix(path, ".jpg") || has_suffix(path, ".jpeg"))
        return decode_jpeg_file(path, out, h, w, c);
    return -10;  // unsupported container
}

int decode_batch(const char** paths, int n, int n_threads, float** outs,
                 int* hs, int* ws, int* cs, int* rcs) {
    std::atomic<int> next(0);
    int workers = n_threads > 0 ? n_threads : 1;
    if (workers > n) workers = n;
    std::vector<std::thread> pool;
    pool.reserve(workers);
    for (int t = 0; t < workers; ++t) {
        pool.emplace_back([&]() {
            for (;;) {
                int i = next.fetch_add(1);
                if (i >= n) return;
                rcs[i] = decode_image(paths[i], &outs[i], &hs[i], &ws[i],
                                      &cs[i]);
            }
        });
    }
    for (auto& th : pool) th.join();
    for (int i = 0; i < n; ++i)
        if (rcs[i] != 0) return rcs[i];
    return 0;
}

void free_buffer(float* ptr) { std::free(ptr); }

}  // extern "C"
