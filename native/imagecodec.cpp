// Native host-side image codec + buffer marshalling for lqr_tpu.
//
// This is the framework's replacement for the reference's pixel I/O
// bridge (GIMP tile/pixel-region plumbing, /root/reference/src/
// io_functions.c:29-68 rgb_buffer_from_layer and friends): the host work
// of getting u8 pixel buffers in and out of files and into the layouts
// the device wants, in C++ on the data path (the reference's equivalent
// layer is C).
//
// Exposed via ctypes (lqr_tpu/utils/image_io.py). Scope:
//   - PNG decode (8-bit gray / gray+alpha / RGB / RGBA, all 5 scanline
//     filters, non-interlaced; anything else returns a code and the
//     Python layer falls back to PIL)
//   - PNG encode (filter "sub" + zlib deflate)
//   - PNM (PPM/PGM binary) encode/decode
//   - interleave/deinterleave and offset sub-rect placement (the
//     update_bias/set_rigmask mask-placement law,
//     /root/reference/src/io_functions.c:70-131)
//
// Build: g++ -O2 -shared -fPIC -o libimagecodec.so imagecodec.cpp -lz

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>
#include <zlib.h>

namespace {

constexpr uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};

uint32_t be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

void put_be32(uint8_t* p, uint32_t v) {
    p[0] = uint8_t(v >> 24); p[1] = uint8_t(v >> 16);
    p[2] = uint8_t(v >> 8); p[3] = uint8_t(v);
}

int channels_of(int color_type) {
    switch (color_type) {
        case 0: return 1;   // gray
        case 2: return 3;   // rgb
        case 4: return 2;   // gray+alpha
        case 6: return 4;   // rgba
        default: return 0;  // palette / unsupported
    }
}

int color_type_of(int c) {
    switch (c) {
        case 1: return 0;
        case 2: return 4;
        case 3: return 2;
        case 4: return 6;
        default: return -1;
    }
}

uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return uint8_t(a);
    if (pb <= pc) return uint8_t(b);
    return uint8_t(c);
}

// Unfilter one scanline in place. prev is the unfiltered previous line
// (nullptr on the first line). bpp = bytes per pixel.
int unfilter(uint8_t* line, const uint8_t* prev, int nbytes, int bpp,
             int ftype) {
    switch (ftype) {
        case 0: return 0;
        case 1:
            for (int i = bpp; i < nbytes; i++) line[i] += line[i - bpp];
            return 0;
        case 2:
            if (prev) for (int i = 0; i < nbytes; i++) line[i] += prev[i];
            return 0;
        case 3:
            for (int i = 0; i < nbytes; i++) {
                int a = i >= bpp ? line[i - bpp] : 0;
                int b = prev ? prev[i] : 0;
                line[i] += uint8_t((a + b) >> 1);
            }
            return 0;
        case 4:
            for (int i = 0; i < nbytes; i++) {
                int a = i >= bpp ? line[i - bpp] : 0;
                int b = prev ? prev[i] : 0;
                int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                line[i] += paeth(a, b, c);
            }
            return 0;
        default: return -1;
    }
}

}  // namespace

extern "C" {

// ---- PNG ------------------------------------------------------------

// Parse header only. Returns 0 ok; 1 not a PNG; 2 unsupported (16-bit,
// palette, interlaced); 3 corrupt.
int lqr_png_info(const uint8_t* data, long len, int* h, int* w, int* c) {
    if (len < 33 || memcmp(data, kSig, 8) != 0) return 1;
    const uint8_t* p = data + 8;
    if (be32(p) != 13 || memcmp(p + 4, "IHDR", 4) != 0) return 3;
    uint32_t W = be32(p + 8), H = be32(p + 12);
    int depth = p[16], ctype = p[17], interlace = p[20];
    int C = channels_of(ctype);
    if (depth != 8 || C == 0 || interlace != 0) return 2;
    *h = int(H); *w = int(W); *c = C;
    return 0;
}

// Decode into out (h*w*c bytes, caller-allocated after lqr_png_info).
// Returns 0 ok; negative on error.
int lqr_png_decode(const uint8_t* data, long len, uint8_t* out) {
    int h, w, c;
    int rc = lqr_png_info(data, len, &h, &w, &c);
    if (rc != 0) return -rc;

    // concatenate IDAT payloads
    std::vector<uint8_t> zdata;
    const uint8_t* p = data + 8;
    const uint8_t* end = data + len;
    while (p + 12 <= end) {
        uint32_t n = be32(p);
        if (p + 12 + n > end) return -3;
        if (memcmp(p + 4, "IDAT", 4) == 0)
            zdata.insert(zdata.end(), p + 8, p + 8 + n);
        if (memcmp(p + 4, "IEND", 4) == 0) break;
        p += 12 + n;
    }
    if (zdata.empty()) return -3;

    long stride = long(w) * c;
    std::vector<uint8_t> raw((stride + 1) * (size_t)h);
    uLongf rawlen = raw.size();
    if (uncompress(raw.data(), &rawlen, zdata.data(), zdata.size()) != Z_OK
        || rawlen != raw.size())
        return -4;

    uint8_t* prev = nullptr;
    for (int y = 0; y < h; y++) {
        uint8_t* line = raw.data() + (size_t)y * (stride + 1);
        int ftype = line[0];
        if (unfilter(line + 1, prev, (int)stride, c, ftype) != 0) return -5;
        memcpy(out + (size_t)y * stride, line + 1, stride);
        prev = line + 1;
    }
    return 0;
}

// Encode img (h*w*c, c in 1..4) into out (capacity cap). Writes the PNG
// byte length to *out_len. Returns 0 ok, -1 bad args, -2 cap too small,
// -3 zlib failure.
int lqr_png_encode(const uint8_t* img, int h, int w, int c,
                   uint8_t* out, long cap, long* out_len) {
    int ctype = color_type_of(c);
    if (ctype < 0 || h <= 0 || w <= 0) return -1;
    long stride = long(w) * c;

    // filter "sub" per scanline (cheap, compresses natural images well)
    std::vector<uint8_t> raw((stride + 1) * (size_t)h);
    for (int y = 0; y < h; y++) {
        uint8_t* line = raw.data() + (size_t)y * (stride + 1);
        const uint8_t* src = img + (size_t)y * stride;
        line[0] = 1;  // sub
        for (long i = 0; i < stride; i++)
            line[1 + i] = uint8_t(src[i] - (i >= c ? src[i - c] : 0));
    }

    uLongf zcap = compressBound(raw.size());
    std::vector<uint8_t> zbuf(zcap);
    if (compress2(zbuf.data(), &zcap, raw.data(), raw.size(), 6) != Z_OK)
        return -3;

    long need = 8 + (12 + 13) + (12 + (long)zcap) + 12;
    if (cap < need) return -2;

    uint8_t* o = out;
    memcpy(o, kSig, 8); o += 8;

    auto chunk = [&](const char* tag, const uint8_t* payload, uint32_t n) {
        put_be32(o, n);
        memcpy(o + 4, tag, 4);
        if (n) memcpy(o + 8, payload, n);
        uint32_t crc = crc32(0L, Z_NULL, 0);
        crc = crc32(crc, o + 4, n + 4);
        put_be32(o + 8 + n, crc);
        o += 12 + n;
    };

    uint8_t ihdr[13];
    put_be32(ihdr, (uint32_t)w);
    put_be32(ihdr + 4, (uint32_t)h);
    ihdr[8] = 8; ihdr[9] = uint8_t(ctype);
    ihdr[10] = ihdr[11] = ihdr[12] = 0;
    chunk("IHDR", ihdr, 13);
    chunk("IDAT", zbuf.data(), (uint32_t)zcap);
    chunk("IEND", nullptr, 0);
    *out_len = long(o - out);
    return 0;
}

// ---- PNM (binary PPM/PGM) --------------------------------------------

static int pnm_parse(const uint8_t* data, long len, int* h, int* w, int* c,
                     long* payload_off) {
    if (len < 10 || data[0] != 'P') return 1;
    int kind = data[1] - '0';
    if (kind != 5 && kind != 6) return 2;
    *c = kind == 5 ? 1 : 3;
    long i = 2;
    int vals[3], nv = 0;
    while (nv < 3 && i < len) {
        while (i < len && (data[i] == ' ' || data[i] == '\t' ||
                           data[i] == '\n' || data[i] == '\r')) i++;
        if (i < len && data[i] == '#') {
            while (i < len && data[i] != '\n') i++;
            continue;
        }
        int v = 0;
        bool got = false;
        while (i < len && data[i] >= '0' && data[i] <= '9') {
            v = v * 10 + (data[i] - '0'); i++; got = true;
        }
        if (!got) return 3;
        vals[nv++] = v;
    }
    if (nv < 3 || vals[2] != 255) return 2;
    if (i >= len) return 3;
    i++;                        // exactly one whitespace byte after maxval
    *w = vals[0]; *h = vals[1];
    if (payload_off) *payload_off = i;
    return 0;
}

int lqr_pnm_info(const uint8_t* data, long len, int* h, int* w, int* c) {
    return pnm_parse(data, len, h, w, c, nullptr);
}

int lqr_pnm_decode(const uint8_t* data, long len, uint8_t* out) {
    int h, w, c;
    long off;
    int rc = pnm_parse(data, len, &h, &w, &c, &off);
    if (rc != 0) return -rc;
    long need = (long)h * w * c;
    if (off + need > len) return -3;
    memcpy(out, data + off, need);
    return 0;
}

int lqr_pnm_encode(const uint8_t* img, int h, int w, int c,
                   uint8_t* out, long cap, long* out_len) {
    if (c != 1 && c != 3) return -1;
    char head[64];
    int n = snprintf(head, sizeof head, "P%d\n%d %d\n255\n",
                     c == 1 ? 5 : 6, w, h);
    long need = n + (long)h * w * c;
    if (cap < need) return -2;
    memcpy(out, head, n);
    memcpy(out + n, img, (size_t)h * w * c);
    *out_len = need;
    return 0;
}

// ---- buffer marshalling ----------------------------------------------

// interleaved [h, w, c] -> planar c x [h, w]
void lqr_deinterleave(const uint8_t* img, int h, int w, int c,
                      uint8_t* out) {
    for (int k = 0; k < c; k++) {
        uint8_t* plane = out + (size_t)k * h * w;
        const uint8_t* src = img + k;
        for (long i = 0; i < (long)h * w; i++) plane[i] = src[i * c];
    }
}

void lqr_interleave(const uint8_t* planes, int h, int w, int c,
                    uint8_t* out) {
    for (int k = 0; k < c; k++) {
        const uint8_t* plane = planes + (size_t)k * h * w;
        uint8_t* dst = out + k;
        for (long i = 0; i < (long)h * w; i++) dst[i * c] = plane[i];
    }
}

// Mask strength field placed at an offset: the update_bias / set_rigmask
// placement law (/root/reference/src/io_functions.c:70-131 and SPEC.md
// §3): out[y, x] += strength(mask[y-oy, x-ox]) * factor for overlapping
// pixels, strength = mean(color channels)/255 * alpha.
void lqr_place_mask(const uint8_t* mask, int mh, int mw, int mc,
                    int ox, int oy, float factor,
                    float* out, int H, int W) {
    int has_alpha = (mc == 2 || mc == 4);
    int nc = mc - has_alpha;
    for (int my = 0; my < mh; my++) {
        int y = my + oy;
        if (y < 0 || y >= H) continue;
        const uint8_t* row = mask + (size_t)my * mw * mc;
        for (int mx = 0; mx < mw; mx++) {
            int x = mx + ox;
            if (x < 0 || x >= W) continue;
            const uint8_t* p = row + (size_t)mx * mc;
            float s = 0.f;
            for (int k = 0; k < nc; k++) s += p[k];
            s *= 1.0f / (255.0f * nc);
            if (has_alpha) s *= p[mc - 1] * (1.0f / 255.0f);
            out[(size_t)y * W + x] += s * factor;
        }
    }
}

// Batched wave staging (round 5, VERDICT r4 #5): synthesize a wave of
// cyclically-rolled variants of a base image DIRECTLY into the padded
// [n, out_h, out_w, c] batch buffer the device consumes — replacing the
// per-image NumPy roll + python-list + np.stack + pad-copy chain on the
// timed cfg4/cfg5 staging path (each u8 byte is now touched exactly
// once on the host). out[i, y, x] = base[(y - dy[i]) % h, (x - dx[i]) % w]
// for x < w; pad columns/rows are zeroed. Two worker threads: the host
// has 2 cores and this is pure memcpy bandwidth.
void lqr_stage_wave(const uint8_t* base, int h, int w, int c,
                    const int* dys, const int* dxs, int n,
                    uint8_t* out, int out_h, int out_w) {
    const size_t row_out = (size_t)out_w * c;
    const size_t img_out = (size_t)out_h * row_out;
    auto work = [&](int lo, int hi) {
        for (int i = lo; i < hi; i++) {
            int dy = ((dys[i] % h) + h) % h;
            int dx = ((dxs[i] % w) + w) % w;
            uint8_t* dst_img = out + (size_t)i * img_out;
            for (int y = 0; y < h; y++) {
                const uint8_t* src =
                    base + (size_t)((y - dy + h) % h) * w * c;
                uint8_t* dst = dst_img + (size_t)y * row_out;
                // out_row[0:dx] = src[w-dx:w]; out_row[dx:w] = src[0:w-dx]
                memcpy(dst, src + (size_t)(w - dx) * c, (size_t)dx * c);
                memcpy(dst + (size_t)dx * c, src, (size_t)(w - dx) * c);
                if (out_w > w)
                    memset(dst + (size_t)w * c, 0, (size_t)(out_w - w) * c);
            }
            for (int y = h; y < out_h; y++)
                memset(dst_img + (size_t)y * row_out, 0, row_out);
        }
    };
    if (n >= 2) {
        std::thread t(work, 0, n / 2);
        work(n / 2, n);
        t.join();
    } else {
        work(0, n);
    }
}

}  // extern "C"
