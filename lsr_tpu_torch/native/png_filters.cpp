// Native PNG scanline unfiltering (the hot loop of io/png.read_png; copied
// from lsr_tpu's native/png_filters.cpp for lsr_tpu_torch/io/png.py).
//
// The PNG filter reconstruction (Sub/Up/Average/Paeth, RFC 2083 §6) is a
// byte-serial recurrence along each scanline — a pure-Python loop takes
// ~100s for six 2048^2 faces; this C version does the same work in tens of
// milliseconds.  Exposed via ctypes; the port's tests hold it against
// lsr_tpu's Python decoder.
//
// Layout contract: `raw` is the zlib-inflated stream, h scanlines of
// (1 filter byte + stride bytes); `out` receives h*stride unfiltered bytes.
// Returns 0 on success, or the filter byte of the first row whose filter
// type is unknown (5-255).

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" int png_unfilter(const uint8_t* raw, int64_t h, int64_t stride,
                            int64_t channels, uint8_t* out) {
    const uint8_t* prev = nullptr;
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* src = raw + y * (stride + 1);
        uint8_t ftype = src[0];
        ++src;
        uint8_t* cur = out + y * stride;
        switch (ftype) {
            case 0:  // None
                std::memcpy(cur, src, stride);
                break;
            case 1:  // Sub
                for (int64_t i = 0; i < stride; ++i) {
                    uint8_t a = i >= channels ? cur[i - channels] : 0;
                    cur[i] = (uint8_t)(src[i] + a);
                }
                break;
            case 2:  // Up
                for (int64_t i = 0; i < stride; ++i) {
                    uint8_t b = prev ? prev[i] : 0;
                    cur[i] = (uint8_t)(src[i] + b);
                }
                break;
            case 3:  // Average
                for (int64_t i = 0; i < stride; ++i) {
                    int a = i >= channels ? cur[i - channels] : 0;
                    int b = prev ? prev[i] : 0;
                    cur[i] = (uint8_t)(src[i] + ((a + b) >> 1));
                }
                break;
            case 4:  // Paeth
                for (int64_t i = 0; i < stride; ++i) {
                    int a = i >= channels ? cur[i - channels] : 0;
                    int b = prev ? prev[i] : 0;
                    int c = (prev && i >= channels) ? prev[i - channels] : 0;
                    int p = a + b - c;
                    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
                    int pred = (pa <= pb && pa <= pc) ? a
                               : (pb <= pc ? b : c);
                    cur[i] = (uint8_t)(src[i] + pred);
                }
                break;
            default:
                return ftype;
        }
        prev = cur;
    }
    return 0;
}
