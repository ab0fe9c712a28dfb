// Native FLAC decoder and token edit distance (C ABI, loaded via ctypes):
// the port's own copy of caiman_asr_tpu/native/src/flac_decoder.cpp.
//
// The reference stack decodes FLAC through NVIDIA DALI's C++ pipeline
// (data/dali/pipeline.py audio decode). Implements the full FLAC subset in
// practice: CONSTANT / VERBATIM / FIXED(0-4) / LPC(<=32) subframes,
// 4- and 5-bit partitioned Rice residuals, wasted bits, left/right/mid-side
// stereo decorrelation, 8/16/24-bit samples. CRCs are not verified (decode
// speed); the STREAMINFO MD5 is exposed so callers can verify payload
// integrity end-to-end.
//
// Built with serialize.cpp and staging.cpp by caiman_asr_tpu_torch/native.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

struct BitReader {
    const uint8_t* data;
    size_t size;
    size_t byte = 0;
    int bit = 0;  // bits consumed of current byte (0..7)
    bool error = false;

    bool at_end() const { return byte >= size; }

    inline uint32_t read_bit() {
        if (byte >= size) { error = true; return 0; }
        uint32_t v = (data[byte] >> (7 - bit)) & 1u;
        if (++bit == 8) { bit = 0; ++byte; }
        return v;
    }

    inline uint64_t read_bits(int n) {
        uint64_t v = 0;
        // fast path: byte-aligned whole bytes
        while (n >= 8 && bit == 0) {
            if (byte >= size) { error = true; return 0; }
            v = (v << 8) | data[byte++];
            n -= 8;
        }
        for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
        return v;
    }

    inline int64_t read_signed(int n) {
        uint64_t v = read_bits(n);
        if (n == 0) return 0;
        uint64_t sign = 1ull << (n - 1);
        return (v & sign) ? (int64_t)(v - (sign << 1)) : (int64_t)v;
    }

    inline uint32_t read_unary() {
        uint32_t q = 0;
        // scan for the terminating 1-bit
        while (true) {
            if (byte >= size) { error = true; return q; }
            uint8_t cur = (uint8_t)(data[byte] << bit);
            if (cur == 0) { q += 8 - bit; byte++; bit = 0; continue; }
            int lead = __builtin_clz((uint32_t)cur << 24);
            q += lead;
            bit += lead + 1;
            if (bit >= 8) { bit -= 8; byte++; }
            return q;
        }
    }

    inline int64_t read_rice(int param) {
        uint32_t q = read_unary();
        uint64_t r = read_bits(param);
        uint64_t v = ((uint64_t)q << param) | r;
        // zigzag decode
        return (v & 1) ? -((int64_t)(v >> 1)) - 1 : (int64_t)(v >> 1);
    }

    void align() { if (bit) { bit = 0; ++byte; } }
};

const int FIXED_ORDERS[5][4] = {
    {},           // order 0: e
    {1},          // order 1: s[i-1]
    {2, -1},      // order 2
    {3, -3, 1},   // order 3
    {4, -6, 4, -1},
};

bool decode_subframe(BitReader& br, int64_t* out, int block_size, int bps) {
    if (br.read_bit() != 0) return false;  // subframe sync must be 0
    int type = (int)br.read_bits(6);
    int wasted = 0;
    if (br.read_bit()) {  // wasted bits flag: unary count
        wasted = 1 + (int)br.read_unary();
        bps -= wasted;
    }

    auto read_residual = [&](int order) -> bool {
        int method = (int)br.read_bits(2);
        if (method > 1) return false;
        int plen = method == 0 ? 4 : 5;
        int escape = method == 0 ? 15 : 31;
        int porder = (int)br.read_bits(4);
        int nparts = 1 << porder;
        int idx = order;
        for (int p = 0; p < nparts; ++p) {
            int n = (block_size >> porder) - (p == 0 ? order : 0);
            int param = (int)br.read_bits(plen);
            if (param == escape) {
                int raw = (int)br.read_bits(5);
                for (int i = 0; i < n; ++i) out[idx++] = br.read_signed(raw);
            } else {
                for (int i = 0; i < n; ++i) out[idx++] = br.read_rice(param);
            }
        }
        return !br.error;
    };

    if (type == 0) {  // CONSTANT
        int64_t v = br.read_signed(bps);
        for (int i = 0; i < block_size; ++i) out[i] = v;
    } else if (type == 1) {  // VERBATIM
        for (int i = 0; i < block_size; ++i) out[i] = br.read_signed(bps);
    } else if (type >= 8 && type <= 12) {  // FIXED order 0-4
        int order = type - 8;
        for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
        if (!read_residual(order)) return false;
        for (int i = order; i < block_size; ++i) {
            int64_t pred = 0;
            for (int j = 0; j < order; ++j)
                pred += (int64_t)FIXED_ORDERS[order][j] * out[i - 1 - j];
            out[i] += pred;
        }
    } else if (type >= 32) {  // LPC, order = (type & 31) + 1
        int order = (type & 31) + 1;
        for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
        int precision = (int)br.read_bits(4) + 1;
        if (precision == 16) return false;  // 0b1111 invalid
        int shift = (int)br.read_signed(5);
        if (shift < 0) return false;
        int64_t coefs[32];
        for (int i = 0; i < order; ++i) coefs[i] = br.read_signed(precision);
        if (!read_residual(order)) return false;
        for (int i = order; i < block_size; ++i) {
            int64_t pred = 0;
            for (int j = 0; j < order; ++j) pred += coefs[j] * out[i - 1 - j];
            out[i] += pred >> shift;
        }
    } else {
        return false;  // reserved
    }
    if (wasted) {
        for (int i = 0; i < block_size; ++i) out[i] <<= wasted;
    }
    return !br.error;
}

uint64_t read_utf8(BitReader& br) {
    uint32_t b = (uint32_t)br.read_bits(8);
    int extra = 0;
    uint64_t v;
    if (b < 0x80) return b;
    else if ((b & 0xE0) == 0xC0) { v = b & 0x1F; extra = 1; }
    else if ((b & 0xF0) == 0xE0) { v = b & 0x0F; extra = 2; }
    else if ((b & 0xF8) == 0xF0) { v = b & 0x07; extra = 3; }
    else if ((b & 0xFC) == 0xF8) { v = b & 0x03; extra = 4; }
    else if ((b & 0xFE) == 0xFC) { v = b & 0x01; extra = 5; }
    else if (b == 0xFE) { v = 0; extra = 6; }
    else { br.error = true; return 0; }
    for (int i = 0; i < extra; ++i) v = (v << 6) | (br.read_bits(8) & 0x3F);
    return v;
}

}  // namespace

extern "C" {

// Decodes a whole FLAC stream. Returns 0 on success.
// out: caller frees with caiman_free. Samples are interleaved int32.
int flac_decode(const uint8_t* data, size_t size, int32_t** out,
                int64_t* n_samples, int* channels, int* sample_rate,
                int* bits_per_sample, uint8_t md5_out[16]) {
    if (size < 42 || memcmp(data, "fLaC", 4) != 0) return 1;
    size_t pos = 4;
    int64_t total_samples = 0;
    int sr = 0, nch = 0, bps = 0;
    bool have_streaminfo = false;

    // metadata blocks
    while (pos + 4 <= size) {
        uint8_t hdr = data[pos];
        bool last = hdr & 0x80;
        int type = hdr & 0x7F;
        uint32_t len = ((uint32_t)data[pos + 1] << 16) |
                       ((uint32_t)data[pos + 2] << 8) | data[pos + 3];
        pos += 4;
        if (type == 0 && len >= 34) {  // STREAMINFO
            const uint8_t* si = data + pos;
            sr = ((int)si[10] << 12) | ((int)si[11] << 4) | (si[12] >> 4);
            nch = ((si[12] >> 1) & 0x7) + 1;
            bps = (((si[12] & 1) << 4) | (si[13] >> 4)) + 1;
            total_samples = ((int64_t)(si[13] & 0x0F) << 32) |
                            ((int64_t)si[14] << 24) | ((int64_t)si[15] << 16) |
                            ((int64_t)si[16] << 8) | si[17];
            if (md5_out) memcpy(md5_out, si + 18, 16);
            have_streaminfo = true;
        }
        pos += len;
        if (last) break;
    }
    if (!have_streaminfo || sr == 0 || nch < 1 || nch > 8) return 2;

    // allocate (grow if total unknown)
    int64_t cap = total_samples > 0 ? total_samples : 1 << 20;
    int32_t* pcm = (int32_t*)malloc((size_t)cap * nch * sizeof(int32_t));
    if (!pcm) return 3;
    int64_t written = 0;

    static const int BLOCK_SIZES[16] = {0, 192, 576, 1152, 2304, 4608, -1, -2,
                                        256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
    static const int SAMPLE_RATES[16] = {0, 88200, 176400, 192000, 8000, 16000,
                                         22050, 24000, 32000, 44100, 48000, 96000,
                                         -1, -2, -3, 0};

    BitReader br{data, size, pos, 0, false};
    int64_t ch_buf_cap = 0;
    int64_t* ch_buf[8] = {nullptr};

    while (true) {
        br.align();
        // scan for frame sync 0xFFF8/0xFFF9
        while (br.byte + 2 <= size &&
               !(data[br.byte] == 0xFF && (data[br.byte + 1] & 0xFE) == 0xF8))
            ++br.byte;
        if (br.byte + 16 > size) break;

        br.read_bits(14);  // sync
        br.read_bit();     // reserved
        br.read_bit();     // blocking strategy
        int bs_code = (int)br.read_bits(4);
        int sr_code = (int)br.read_bits(4);
        int ch_code = (int)br.read_bits(4);
        int bps_code = (int)br.read_bits(3);
        br.read_bit();  // reserved
        read_utf8(br);  // frame/sample number

        int block_size;
        if (bs_code == 6) block_size = (int)br.read_bits(8) + 1;
        else if (bs_code == 7) block_size = (int)br.read_bits(16) + 1;
        else if (BLOCK_SIZES[bs_code] > 0) block_size = BLOCK_SIZES[bs_code];
        else { continue; }  // invalid; rescan

        if (sr_code == 12) br.read_bits(8);
        else if (sr_code == 13 || sr_code == 14) br.read_bits(16);

        int fbps = bps;
        static const int BPS_TABLE[8] = {0, 8, 12, 0, 16, 20, 24, 32};
        if (bps_code != 0 && BPS_TABLE[bps_code]) fbps = BPS_TABLE[bps_code];

        br.read_bits(8);  // header CRC-8 (unverified)
        if (br.error) break;

        int frame_ch = nch;
        int stereo_mode = 0;  // 0=independent 1=left/side 2=right/side 3=mid/side
        if (ch_code < 8) frame_ch = ch_code + 1;
        else if (ch_code == 8) { frame_ch = 2; stereo_mode = 1; }
        else if (ch_code == 9) { frame_ch = 2; stereo_mode = 2; }
        else if (ch_code == 10) { frame_ch = 2; stereo_mode = 3; }
        else continue;
        if (frame_ch != nch) continue;  // channel mismatch; rescan

        if (block_size > ch_buf_cap) {
            for (int c = 0; c < nch; ++c) {
                free(ch_buf[c]);
                ch_buf[c] = (int64_t*)malloc(sizeof(int64_t) * block_size);
            }
            ch_buf_cap = block_size;
        }

        bool ok = true;
        for (int c = 0; c < frame_ch && ok; ++c) {
            int sub_bps = fbps;
            if ((stereo_mode == 1 && c == 1) || (stereo_mode == 2 && c == 0) ||
                (stereo_mode == 3 && c == 1))
                sub_bps += 1;  // side channel carries one extra bit
            ok = decode_subframe(br, ch_buf[c], block_size, sub_bps);
        }
        if (!ok) break;
        br.align();
        br.read_bits(16);  // frame CRC-16 (unverified)

        // stereo decorrelation
        if (stereo_mode == 1) {  // left/side: right = left - side
            for (int i = 0; i < block_size; ++i)
                ch_buf[1][i] = ch_buf[0][i] - ch_buf[1][i];
        } else if (stereo_mode == 2) {  // right/side: left = right + side
            for (int i = 0; i < block_size; ++i) {
                int64_t side = ch_buf[0][i];
                ch_buf[0][i] = ch_buf[1][i] + side;
            }
        } else if (stereo_mode == 3) {  // mid/side
            for (int i = 0; i < block_size; ++i) {
                int64_t mid = ch_buf[0][i], side = ch_buf[1][i];
                mid = (mid << 1) | (side & 1);
                ch_buf[0][i] = (mid + side) >> 1;
                ch_buf[1][i] = (mid - side) >> 1;
            }
        }

        if (written + block_size > cap) {
            cap = (written + block_size) * 2;
            int32_t* np = (int32_t*)realloc(pcm, (size_t)cap * nch * sizeof(int32_t));
            if (!np) { free(pcm); for (auto* b : ch_buf) free(b); return 3; }
            pcm = np;
        }
        for (int i = 0; i < block_size; ++i)
            for (int c = 0; c < nch; ++c)
                pcm[(written + i) * nch + c] = (int32_t)ch_buf[c][i];
        written += block_size;
        if (total_samples > 0 && written >= total_samples) break;
    }
    for (auto* b : ch_buf) free(b);

    if (total_samples > 0 && written > total_samples) written = total_samples;
    *out = pcm;
    *n_samples = written;
    *channels = nch;
    *sample_rate = sr;
    *bits_per_sample = bps;
    return written > 0 ? 0 : 4;
}

void caiman_free(void* p) { free(p); }

// Levenshtein distance over token-id sequences (replacement for the
// reference's levenshtein_rs pip dep, evaluate/metrics.py:21).
int64_t levenshtein_i64(const int64_t* a, int64_t na, const int64_t* b, int64_t nb) {
    if (na == 0) return nb;
    if (nb == 0) return na;
    int64_t* prev = (int64_t*)malloc(sizeof(int64_t) * (nb + 1));
    int64_t* cur = (int64_t*)malloc(sizeof(int64_t) * (nb + 1));
    for (int64_t j = 0; j <= nb; ++j) prev[j] = j;
    for (int64_t i = 1; i <= na; ++i) {
        cur[0] = i;
        for (int64_t j = 1; j <= nb; ++j) {
            int64_t cost = a[i - 1] == b[j - 1] ? 0 : 1;
            int64_t d = prev[j - 1] + cost;
            if (prev[j] + 1 < d) d = prev[j] + 1;
            if (cur[j - 1] + 1 < d) d = cur[j - 1] + 1;
            cur[j] = d;
        }
        int64_t* t = prev; prev = cur; cur = t;
    }
    int64_t res = prev[nb];
    free(prev); free(cur);
    return res;
}

}  // extern "C"
