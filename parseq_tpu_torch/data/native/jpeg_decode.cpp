// JPEG decode + PIL-exact bicubic resize to a fixed STR input size.
//
// Replaces the eval path's PIL pipeline (Image.open/draft/convert/resize,
// strhub transform parity per strhub/data/module.py:68-82)
// for the common case — baseline/progressive JPEG, grayscale or YCbCr —
// with one tight C call per image. PIL links the same libjpeg-turbo this
// links, so the decode bytes are identical; the resize reimplements
// Pillow's fixed-point convolution resampling (Resample.c) exactly:
// horizontal pass then vertical pass, uint8 intermediate, Catmull-Rom
// bicubic (a = -0.5, support 2), per-window coefficient normalization in
// double, coefficients quantized to 1<<22 fixed point, accumulate in
// int64 with pre-added rounding bias, clamp to [0, 255].
//
// Anything unusual (CMYK/YCCK, decode errors) returns nonzero and the
// Python caller falls back to PIL.
//
// The port's copy of parseq_tpu/data/native/jpeg_decode.cpp, with one entry
// point more (parseq_jpeg_lib_version: the libjpeg this was built against,
// for comparing with the one Pillow bundles). Built by utils/native_build.py
// into build/native/libjpeg_decode.so.

#include <algorithm>
#include <csetjmp>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

constexpr int PRECISION_BITS = 32 - 8 - 2;  // Pillow Resample.c

struct ErrMgr {
    jpeg_error_mgr pub;
    jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
    ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
    longjmp(e->jb, 1);
}

double bicubic(double x) {
    // Pillow's bicubic filter, a = -0.5
    constexpr double a = -0.5;
    if (x < 0) x = -x;
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}

// Pillow precompute_coeffs: per output pixel, window [bound0, bound1) and
// normalized fixed-point coefficients.
void precompute(int in_size, int out_size, std::vector<int>& bounds,
                std::vector<int>& sizes, std::vector<int>& coeffs, int& kmax) {
    constexpr double support_base = 2.0;  // bicubic
    double scale = static_cast<double>(in_size) / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = support_base * filterscale;
    kmax = static_cast<int>(std::ceil(support)) * 2 + 1;
    bounds.resize(out_size);
    sizes.resize(out_size);
    coeffs.assign(static_cast<size_t>(out_size) * kmax, 0);
    std::vector<double> k(kmax);
    for (int xx = 0; xx < out_size; xx++) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = static_cast<int>(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = static_cast<int>(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        for (int x = 0; x < xmax; x++) {
            double w = bicubic((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        for (int x = 0; x < xmax; x++)
            if (ww != 0.0) k[x] /= ww;
        int* kk = &coeffs[static_cast<size_t>(xx) * kmax];
        for (int x = 0; x < xmax; x++) {
            double v = k[x] * (1 << PRECISION_BITS);
            kk[x] = static_cast<int>(v < 0 ? v - 0.5 : v + 0.5);
        }
        bounds[xx] = xmin;
        sizes[xx] = xmax;
    }
}

inline uint8_t clip8(int64_t v) {
    v >>= PRECISION_BITS;
    if (v < 0) return 0;
    if (v > 255) return 255;
    return static_cast<uint8_t>(v);
}

// Horizontal then vertical pass over interleaved 3-channel rows.
void resample(const uint8_t* in, int in_w, int in_h, int out_w, int out_h,
              uint8_t* out) {
    std::vector<int> xb, xs, xk, yb, ys, yk;
    int xkmax, ykmax;
    precompute(in_w, out_w, xb, xs, xk, xkmax);
    precompute(in_h, out_h, yb, ys, yk, ykmax);

    const int64_t bias = 1LL << (PRECISION_BITS - 1);
    std::vector<uint8_t> tmp(static_cast<size_t>(in_h) * out_w * 3);
    for (int y = 0; y < in_h; y++) {
        const uint8_t* row = in + static_cast<size_t>(y) * in_w * 3;
        uint8_t* trow = tmp.data() + static_cast<size_t>(y) * out_w * 3;
        for (int x = 0; x < out_w; x++) {
            const int* kk = &xk[static_cast<size_t>(x) * xkmax];
            int x0 = xb[x], n = xs[x];
            int64_t s0 = bias, s1 = bias, s2 = bias;
            const uint8_t* p = row + static_cast<size_t>(x0) * 3;
            for (int i = 0; i < n; i++, p += 3) {
                s0 += static_cast<int64_t>(p[0]) * kk[i];
                s1 += static_cast<int64_t>(p[1]) * kk[i];
                s2 += static_cast<int64_t>(p[2]) * kk[i];
            }
            trow[x * 3 + 0] = clip8(s0);
            trow[x * 3 + 1] = clip8(s1);
            trow[x * 3 + 2] = clip8(s2);
        }
    }
    // vertical pass: accumulate row-sequentially (cache-friendly,
    // auto-vectorizable) instead of walking each output column down the
    // strided intermediate. Integer math identical either way.
    const int w3 = out_w * 3;
    std::vector<int64_t> acc(w3);
    for (int y = 0; y < out_h; y++) {
        const int* kk = &yk[static_cast<size_t>(y) * ykmax];
        int y0 = yb[y], n = ys[y];
        uint8_t* orow = out + static_cast<size_t>(y) * w3;
        std::fill(acc.begin(), acc.end(), bias);
        for (int i = 0; i < n; i++) {
            const uint8_t* r = tmp.data() + static_cast<size_t>(y0 + i) * w3;
            const int64_t k = kk[i];
            for (int x = 0; x < w3; x++) acc[x] += static_cast<int64_t>(r[x]) * k;
        }
        for (int x = 0; x < w3; x++) orow[x] = clip8(acc[x]);
    }
}

}  // namespace

extern "C" {

// Decode `data` and bicubic-resize to (out_w, out_h) RGB uint8 into `out`
// (out_h*out_w*3 bytes, caller-allocated). fast_decode mirrors PIL
// Image.draft: DCT-scaled decode at the largest 1/s, s in {8,4,2}, with
// s <= min(W/out_w, H/out_h) (integer division). Returns 0 on success;
// 1 = decode error, 2 = unsupported color space (caller falls back).
int parseq_jpeg_decode_resize(const unsigned char* data, size_t len,
                              int out_w, int out_h, int fast_decode,
                              unsigned char* out) {
    jpeg_decompress_struct cinfo;
    ErrMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = err_exit;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, len);
    jpeg_read_header(&cinfo, TRUE);

    if (cinfo.jpeg_color_space == JCS_CMYK || cinfo.jpeg_color_space == JCS_YCCK) {
        jpeg_destroy_decompress(&cinfo);
        return 2;  // PIL applies its own CMYK handling; fall back
    }
    cinfo.out_color_space = JCS_RGB;

    if (fast_decode) {
        int sw = static_cast<int>(cinfo.image_width) / out_w;
        int sh = static_cast<int>(cinfo.image_height) / out_h;
        int smax = sw < sh ? sw : sh;
        int s = 1;
        while (s * 2 <= smax && s < 8) s *= 2;
        cinfo.scale_num = 1;
        cinfo.scale_denom = static_cast<unsigned>(s);
    }

    jpeg_start_decompress(&cinfo);
    int w = static_cast<int>(cinfo.output_width);
    int h = static_cast<int>(cinfo.output_height);
    if (cinfo.output_components != 3) {
        jpeg_destroy_decompress(&cinfo);
        return 2;
    }
    std::vector<uint8_t> buf(static_cast<size_t>(w) * h * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = buf.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);

    if (w == out_w && h == out_h)
        std::memcpy(out, buf.data(), buf.size());
    else
        resample(buf.data(), w, h, out_w, out_h, out);
    return 0;
}

// Resize an RGB uint8 image with the PIL-exact bicubic (exposed for parity
// tests against Image.resize and for non-JPEG sources already in memory).
void parseq_bicubic_u8(const unsigned char* in, int in_w, int in_h,
                       int out_w, int out_h, unsigned char* out) {
    resample(in, in_w, in_h, out_w, out_h, out);
}

// Header-only probe: full-resolution dimensions of a JPEG stream.
// Returns 0 and fills (*w, *h) on success; nonzero on parse error or a
// color space the decode path would reject (caller falls back to PIL).
int parseq_jpeg_dims(const unsigned char* data, size_t len, int* w, int* h) {
    jpeg_decompress_struct cinfo;
    ErrMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = err_exit;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, len);
    jpeg_read_header(&cinfo, TRUE);
    if (cinfo.jpeg_color_space == JCS_CMYK || cinfo.jpeg_color_space == JCS_YCCK) {
        jpeg_destroy_decompress(&cinfo);
        return 2;
    }
    *w = static_cast<int>(cinfo.image_width);
    *h = static_cast<int>(cinfo.image_height);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// Full-resolution decode into a caller buffer of W*H*3 bytes (from
// parseq_jpeg_dims), RGB interleaved — the TRAINING-path entry, where
// RandAugment must see the full-resolution image before any resize
// (reference transform order, strhub/data/module.py:68-82), so the fused
// decode+resize above doesn't apply. Same fallback contract: 0 = ok,
// 1 = decode error, 2 = unsupported color space.
int parseq_jpeg_decode(const unsigned char* data, size_t len,
                       unsigned char* out) {
    jpeg_decompress_struct cinfo;
    ErrMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = err_exit;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, len);
    jpeg_read_header(&cinfo, TRUE);
    if (cinfo.jpeg_color_space == JCS_CMYK || cinfo.jpeg_color_space == JCS_YCCK) {
        jpeg_destroy_decompress(&cinfo);
        return 2;
    }
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    if (cinfo.output_components != 3) {
        jpeg_destroy_decompress(&cinfo);
        return 2;
    }
    const int w = static_cast<int>(cinfo.output_width);
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = out + static_cast<size_t>(cinfo.output_scanline) * w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// The libjpeg API version this was compiled against (JPEG_LIB_VERSION, e.g.
// 62), and libjpeg-turbo's version string ("" for another libjpeg).
#define PARSEQ_STR2(x) #x
#define PARSEQ_STR(x) PARSEQ_STR2(x)
int parseq_jpeg_lib_version(const char** turbo) {
#ifdef LIBJPEG_TURBO_VERSION
    *turbo = PARSEQ_STR(LIBJPEG_TURBO_VERSION);
#else
    *turbo = "";
#endif
    return JPEG_LIB_VERSION;
}

}  // extern "C"
