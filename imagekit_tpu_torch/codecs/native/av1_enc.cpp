// First-party AV1 entropy engine — native twin of av1_entropy.py's
// MsacEncoder + av1_intra.py's encode_txb hot loop.
//
// Byte-exactness contract: this implements EXACTLY the Python model
// (arbitrary-precision `low`, libaom od_ec direct-domain intervals,
// od_ec_enc_done termination). The Python encoder keeps `low` as a big
// int; here `low` is a 64-bit window plus a pre-carry chunk list: each
// emitted chunk holds 9 bits (8 payload + a possible carry out of the
// window, bounded by the per-renorm-epoch growth argument: between two
// renormalizations low grows by < 2^15 total, so low < 2^(wbits+1)
// always and a chunk never exceeds 0x1FF). Carries resolve right-to-
// left in done(), reproducing big-int addition bit-for-bit.
// tests/test_av1_native.py pins byte equality against the Python
// encoder over random symbol streams and full frames; the dav1d
// conformance gates run on top.
//
// snapshot/restore — the RD search's trial mechanism — is a full
// clone/assign of the encoder (struct + chunk vector): the search
// restores FORWARD to sibling-trial states whose chunk prefixes
// diverge, so truncation tricks are not sound; the vectors are a few
// KB, so clones are microseconds.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#define IK_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int EC_PROB_SHIFT = 6;
constexpr int EC_MIN_PROB = 4;

inline uint32_t interval(uint32_t rng, uint32_t f, int pos_from_end) {
    return (((rng >> 8) * (f >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT))
        + EC_MIN_PROB * pos_from_end;
}

struct MsacEnc {
    uint64_t low = 0;
    int wbits = 15;          // bits of the conceptual big `low` in-window
    uint32_t rng = 0x8000;
    int64_t nbits = 15;      // total conceptual bits (Python `nbits`)
    std::vector<uint16_t> chunks;  // 9-bit pre-carry chunks, oldest first

    void reset() {
        low = 0; wbits = 15; rng = 0x8000; nbits = 15; chunks.clear();
    }

    inline void renorm_and_flush() {
        while (rng < 0x8000) { rng <<= 1; low <<= 1; ++wbits; ++nbits; }
        while (wbits >= 48) {
            chunks.push_back((uint16_t)(low >> (wbits - 8)));
            low &= (1ULL << (wbits - 8)) - 1;
            wbits -= 8;
        }
    }

    inline void symbol(int sym, const uint16_t* icdf, int n) {
        uint32_t r = rng;
        uint32_t u = (sym == 0) ? r : interval(r, icdf[sym - 1], n - sym);
        uint32_t f = (sym == n - 1) ? 0 : icdf[sym];
        uint32_t v = interval(r, f, n - 1 - sym);
        low += r - u;
        rng = u - v;
        renorm_and_flush();
    }

    inline void boolbit(int b) {       // equiprobable bypass bit
        static const uint16_t half[1] = {1 << 14};
        symbol(b, half, 2);
    }

    inline void literal(uint32_t value, int bits) {
        for (int i = bits - 1; i >= 0; --i) boolbit((value >> i) & 1);
    }

    inline void golomb(uint32_t value) {   // spec read_golomb inverse
        uint32_t x = value + 1;
        int length = 32 - __builtin_clz(x);
        literal(0, length - 1);
        literal(x, length);
    }

    int done(uint8_t* out, int cap) const {
        int64_t keep = nbits - 14;
        if (keep <= 0) {
            if (cap < 1) return -1;
            out[0] = 0x40;
            return 1;
        }
        uint64_t e = ((low + 0x3FFF) & ~0x3FFFULL) | 0x4000;
        int pad = (int)((8 - (keep % 8)) % 8);
        uint64_t ew = (e >> 14) << pad;
        int wb = wbits - 14 + pad;                // window bits, mult of 8
        size_t nch = chunks.size();
        size_t n = nch + (size_t)(wb / 8);
        if ((int64_t)n * 8 != keep + pad) return -2;  // invariant breach
        if ((size_t)cap < n) return -1;
        std::vector<uint32_t> tmp(n);
        for (size_t i = 0; i < nch; ++i) tmp[i] = chunks[i];
        for (int i = 0; i < wb / 8; ++i)
            tmp[nch + i] = (uint32_t)((ew >> (wb - 8 * (i + 1)))
                                      & (i == 0 ? 0x3FFu : 0xFFu));
        for (size_t i = n - 1; i >= 1; --i) {
            tmp[i - 1] += tmp[i] >> 8;
            tmp[i] &= 0xFF;
        }
        if (tmp[0] > 0xFF) return -3;             // invariant breach
        for (size_t i = 0; i < n; ++i) out[i] = (uint8_t)tmp[i];
        return (int)n;
    }
};

// ---------------------------------------------------------------------------
// Bound default-CDF tables (shapes asserted by the Python binding layer)

struct Av1Tables {
    const uint16_t* txb_skip;      // (4,5,13,3)
    const uint16_t* ext_tx2;       // (4,13,6)
    const uint16_t* eob_pt[4];     // 16/64/256/1024: (4,2,2,nsyms+1)
    const uint16_t* eob_extra;     // (4,5,2,9,3)
    const uint16_t* base_eob;      // (4,5,2,4,4)
    const uint16_t* base;          // (4,5,2,42,5)
    const uint16_t* br;            // (4,5,2,21,5)
    const uint16_t* dc_sign;       // (4,2,3,3)
    const int16_t* scan[4];        // 4x4/8x8/16x16/32x32
};

Av1Tables g_tab;
bool g_bound = false;

constexpr int EOB_NSYMS[4] = {5, 7, 9, 11};   // last dim - 1

// spec 8.3.2 / aom update_cdf: rows are [icdf 0..n-2, 0, count].
// Entries below the coded symbol move toward 32768, entries at/above
// it decay toward 0 — BOTH via floor shifts of the positive quantity.
// speed term: 1 for n<=3, 2 above (dav1d's 4+(count>>4)+(nsym>2)
// under its size = n-1 convention); certified by the dav1d gate —
// a wrong rate or rounding desyncs within a few repeated symbols.
constexpr int NSYMBS2SPEED[17] = {0, 0, 1, 1, 2, 2, 2, 2, 2,
                                  2, 2, 2, 2, 2, 2, 2, 2};

inline void update_cdf(uint16_t* cdf, int val, int n) {
    const int count = cdf[n];
    const int rate = 3 + (count > 15) + (count > 31) + NSYMBS2SPEED[n];
    for (int i = 0; i < n - 1; ++i) {
        // BOTH sides floor-shift the positive quantity (the arithmetic
        // shift of (0 - cdf) rounds the decay up and desyncs dav1d)
        if (i < val)
            cdf[i] = (uint16_t)(cdf[i] + ((32768 - cdf[i]) >> rate));
        else
            cdf[i] = (uint16_t)(cdf[i] - (cdf[i] >> rate));
    }
    cdf[n] = (uint16_t)(count + (count < 32));
}

}  // namespace

IK_EXPORT MsacEnc* ik_msac_new() { return new MsacEnc(); }
IK_EXPORT void ik_msac_free(MsacEnc* e) { delete e; }
IK_EXPORT void ik_msac_reset(MsacEnc* e) { e->reset(); }

IK_EXPORT void ik_msac_symbol(MsacEnc* e, const uint16_t* icdf, int n,
                              int sym) {
    e->symbol(sym, icdf, n);
}
IK_EXPORT void ik_msac_symbol_adapt(MsacEnc* e, uint16_t* cdf, int n,
                                    int sym) {
    e->symbol(sym, cdf, n);
    update_cdf(cdf, sym, n);
}
IK_EXPORT void ik_msac_literal(MsacEnc* e, uint32_t value, int bits) {
    e->literal(value, bits);
}
IK_EXPORT void ik_msac_golomb(MsacEnc* e, uint32_t value) {
    e->golomb(value);
}
IK_EXPORT long long ik_msac_nbits(const MsacEnc* e) { return e->nbits; }
IK_EXPORT int ik_msac_done(const MsacEnc* e, uint8_t* out, int cap) {
    return e->done(out, cap);
}
IK_EXPORT MsacEnc* ik_msac_clone(const MsacEnc* e) {
    return new MsacEnc(*e);
}
IK_EXPORT void ik_msac_assign(MsacEnc* dst, const MsacEnc* src) {
    *dst = *src;
}

IK_EXPORT void ik_av1_bind_tables(
        const uint16_t* txb_skip, const uint16_t* ext_tx2,
        const uint16_t* eob16, const uint16_t* eob64,
        const uint16_t* eob256, const uint16_t* eob1024,
        const uint16_t* eob_extra, const uint16_t* base_eob,
        const uint16_t* base, const uint16_t* br, const uint16_t* dc_sign,
        const int16_t* scan4, const int16_t* scan8,
        const int16_t* scan16, const int16_t* scan32) {
    g_tab.txb_skip = txb_skip;
    g_tab.ext_tx2 = ext_tx2;
    g_tab.eob_pt[0] = eob16; g_tab.eob_pt[1] = eob64;
    g_tab.eob_pt[2] = eob256; g_tab.eob_pt[3] = eob1024;
    g_tab.eob_extra = eob_extra;
    g_tab.base_eob = base_eob;
    g_tab.base = base;
    g_tab.br = br;
    g_tab.dc_sign = dc_sign;
    g_tab.scan[0] = scan4; g_tab.scan[1] = scan8;
    g_tab.scan[2] = scan16; g_tab.scan[3] = scan32;
    g_bound = true;
}

// One transform block (mirror of av1_intra.TileEncoder.encode_txb).
// quant: side*side int32 raster levels (side = 1 << txsz_log2 <= 32).
// skip_ctx / dc_sign_ctx are derived from the per-plane entropy context
// rows by the Python caller (they live in TileEncoder state).
// Returns the new entropy-context value (cul_level | dc_cat << 6),
// or -100 on misuse.
IK_EXPORT int ik_av1_txb(MsacEnc* e, int plane, int qctx, int txsz_log2,
                         const int32_t* quant, int skip_ctx,
                         int dc_sign_ctx, int ymode, int txtype_sym,
                         uint16_t* const* tabs, int adapt) {
    if (!g_bound || txsz_log2 < 2 || txsz_log2 > 5) return -100;
    // adaptation REQUIRES caller-owned mutable tables: without them the
    // const_casts below would mutate the process-global defaults that
    // every static-CDF encoder shares
    if (adapt && !tabs) return -100;
    const int q = qctx;
    const int ptype = plane ? 1 : 0;
    const int txs_ctx = txsz_log2 - 2;
    const int side = 1 << txsz_log2;
    const int nc = side * side;            // side <= 32 always
    const int log_idx = txsz_log2 - 2;     // scan + eob table index

    // per-tile mutable tables (CDF adaptation) or the bound defaults;
    // order mirrors ik_av1_bind_tables (minus the scans)
    const uint16_t* t_txb_skip = tabs ? tabs[0] : g_tab.txb_skip;
    const uint16_t* t_ext = tabs ? tabs[1] : g_tab.ext_tx2;
    const uint16_t* t_eob = tabs ? tabs[2 + log_idx] : g_tab.eob_pt[log_idx];
    const uint16_t* t_eob_extra = tabs ? tabs[6] : g_tab.eob_extra;
    const uint16_t* t_base_eob = tabs ? tabs[7] : g_tab.base_eob;
    const uint16_t* t_base = tabs ? tabs[8] : g_tab.base;
    const uint16_t* t_br = tabs ? tabs[9] : g_tab.br;
    const uint16_t* t_dc = tabs ? tabs[10] : g_tab.dc_sign;
    auto code = [&](const uint16_t* row, int n_, int s) {
        e->symbol(s, row, n_);
        if (adapt) update_cdf(const_cast<uint16_t*>(row), s, n_);
    };

    // txb_skip (all_zero): (4,5,13,3) -> row stride 3
    const uint16_t* skip_row =
        t_txb_skip + ((q * 5 + txs_ctx) * 13 + skip_ctx) * 3;
    bool any = false;
    for (int i = 0; i < nc; ++i) if (quant[i]) { any = true; break; }
    if (!any) {
        code(skip_row, 2, 1);
        return 0;
    }
    code(skip_row, 2, 0);
    if (plane == 0 && txsz_log2 < 5) {
        // tx_type in TX_SET_INTRA_2 {IDTX=0, DCT_DCT=1, ADST_ADST=2,
        // ADST_DCT=3, DCT_ADST=4}: (4,13,6) -> row stride 6
        code(t_ext + (txs_ctx * 13 + ymode) * 6, 5, txtype_sym);
    }
    const int16_t* scan = g_tab.scan[log_idx];
    int eob = 0;
    for (int c = nc - 1; c >= 0; --c) {
        if (quant[scan[c]]) { eob = c + 1; break; }
    }
    // eob_pt + extra bits
    int eob_pt;
    if (eob <= 2) eob_pt = eob;
    else eob_pt = (32 - __builtin_clz((unsigned)(eob - 1))) + 1;
    const int nsyms = EOB_NSYMS[log_idx];
    const uint16_t* eob_row =
        t_eob + ((q * 2 + ptype) * 2 + 0) * (nsyms + 1);
    code(eob_row, nsyms, eob_pt - 1);
    if (eob_pt >= 3) {
        int rem = eob - 1 - (1 << (eob_pt - 2));
        const uint16_t* ex_row = t_eob_extra
            + (((q * 5 + txs_ctx) * 2 + ptype) * 9 + (eob_pt - 3)) * 3;
        code(ex_row, 2, (rem >> (eob_pt - 3)) & 1);
        for (int i = eob_pt - 4; i >= 0; --i) e->boolbit((rem >> i) & 1);
    }
    // reverse scan: base magnitudes + br increments
    const int bwl = txsz_log2;             // side <= 32 -> min(.,5) == txsz
    const int stride = (1 << bwl) + 4;     // TX_PAD_HOR
    int32_t levels[(32 + 4) * (32 + 4) + 16];
    std::memset(levels, 0, sizeof(int32_t) * ((side + 4) * stride + 16));
    const uint16_t* base_eob_tab = t_base_eob
        + ((q * 5 + txs_ctx) * 2 + ptype) * 4 * 4;
    const uint16_t* base_tab = t_base
        + ((q * 5 + txs_ctx) * 2 + ptype) * 42 * 5;
    const uint16_t* br_tab = t_br
        + ((q * 5 + (txs_ctx < 3 ? txs_ctx : 3)) * 2 + ptype) * 21 * 5;
    for (int c = eob - 1; c >= 0; --c) {
        const int pos = scan[c];
        const int32_t qv = quant[pos];
        const int alevel = qv < 0 ? -qv : qv;
        const int level = alevel < 15 ? alevel : 15;
        const int row = pos >> bwl, col = pos & ((1 << bwl) - 1);
        const int lp = row * stride + col;
        if (c == eob - 1) {
            int bctx;
            if (c == 0) bctx = 0;
            else if (c <= nc / 8) bctx = 1;
            else if (c <= nc / 4) bctx = 2;
            else bctx = 3;
            code(base_eob_tab + bctx * 4, 3, (level < 3 ? level : 3) - 1);
        } else {
            auto cap3 = [&](int v) { return v < 3 ? v : 3; };
            int mag = cap3(levels[lp + 1]) + cap3(levels[lp + stride])
                + cap3(levels[lp + stride + 1]) + cap3(levels[lp + 2])
                + cap3(levels[lp + 2 * stride]);
            int bctx = (mag + 1) >> 1;
            if (bctx > 4) bctx = 4;
            if (pos == 0) bctx = 0;
            else if (row + col < 2) bctx += 1;
            else if (row + col < 4) bctx += 6;
            else bctx += 21;
            code(base_tab + bctx * 5, 4, level < 3 ? level : 3);
        }
        if (level > 2) {
            auto cap15 = [&](int v) { return v < 15 ? v : 15; };
            int mag = cap15(levels[lp + 1]) + cap15(levels[lp + stride])
                + cap15(levels[lp + stride + 1]);
            int brctx = (mag + 1) >> 1;
            if (brctx > 6) brctx = 6;
            if (pos != 0) brctx += (row < 2 && col < 2) ? 7 : 14;
            int remaining = level - 3;
            for (int k = 0; k < 4; ++k) {
                int sym = remaining < 3 ? remaining : 3;
                code(br_tab + brctx * 5, 4, sym);
                remaining -= sym;
                if (sym < 3) break;
            }
        }
        levels[lp] = level;
    }
    // forward pass: signs + exp-Golomb residues, then context value
    int64_t cul = 0;
    for (int c = 0; c < eob; ++c) {
        const int pos = scan[c];
        const int32_t v = quant[pos];
        if (!v) continue;
        const int sign = v < 0 ? 1 : 0;
        const int av = v < 0 ? -v : v;
        cul += av;
        if (c == 0) {
            const uint16_t* ds_row = t_dc
                + ((q * 2 + ptype) * 3 + dc_sign_ctx) * 3;
            code(ds_row, 2, sign);
        } else {
            e->boolbit(sign);
        }
        if (av > 14) e->golomb((uint32_t)(av - 15));
    }
    if (cul > 63) cul = 63;
    const int32_t dc = quant[0];
    const int cat = dc ? (dc < 0 ? 1 : 2) : 0;
    return (int)(cul | (cat << 6));
}

// ---------------------------------------------------------------------------
// Leaf evaluation: forward DCT/identity + quantize + exact integer
// reconstruction + SSE in one call (the RD search's distortion pipeline).
// The inverse transforms are a 1:1 port of av1_itx.py (spec 7.13), which
// is probe-certified bit-exact against libdav1d; a unit test pins this
// port against the Python module on random level sets.

namespace {

inline int64_t hb(int64_t w0, int64_t x0, int64_t w1, int64_t x1) {
    return (w0 * x0 + w1 * x1 + 2048) >> 12;
}

struct Cos128 {
    int64_t c[64];
    Cos128() {
        for (int k = 0; k < 64; ++k)
            c[k] = (int64_t)(4096.0 * std::cos(k * M_PI / 128.0) + 0.5);
    }
};
const Cos128 CC;
#define C_ CC.c

void idct4v(const int64_t* in, int64_t* out, int stride) {
    int64_t i0 = in[0], i1 = in[stride], i2 = in[2 * stride],
            i3 = in[3 * stride];
    int64_t t0 = hb(C_[32], i0, C_[32], i2);
    int64_t t1 = hb(C_[32], i0, -C_[32], i2);
    int64_t t2 = hb(C_[48], i1, -C_[16], i3);
    int64_t t3 = hb(C_[16], i1, C_[48], i3);
    out[0] = t0 + t3; out[1] = t1 + t2; out[2] = t1 - t2; out[3] = t0 - t3;
}

void idct8v(const int64_t* in, int64_t* out, int stride) {
    int64_t ev[4], evin[4];
    for (int k = 0; k < 4; ++k) evin[k] = in[2 * k * stride];
    idct4v(evin, ev, 1);
    int64_t x1 = in[stride], x3 = in[3 * stride], x5 = in[5 * stride],
            x7 = in[7 * stride];
    int64_t t4 = hb(C_[56], x1, -C_[8], x7);
    int64_t t7 = hb(C_[8], x1, C_[56], x7);
    int64_t t5 = hb(C_[24], x5, -C_[40], x3);
    int64_t t6 = hb(C_[40], x5, C_[24], x3);
    int64_t s4 = t4 + t5, s5 = t4 - t5, s6 = -t6 + t7, s7 = t6 + t7;
    int64_t u5 = hb(-C_[32], s5, C_[32], s6);
    int64_t u6 = hb(C_[32], s5, C_[32], s6);
    int64_t o[4] = {s4, u5, u6, s7};
    for (int k = 0; k < 4; ++k) {
        out[k] = ev[k] + o[3 - k];
        out[7 - k] = ev[k] - o[3 - k];
    }
}

int bitrev(int j, int bits) {
    int out = 0;
    for (int b = 0; b < bits; ++b) { out = (out << 1) | (j & 1); j >>= 1; }
    return out;
}

void idct16v(const int64_t* in, int64_t* out, int stride) {
    int64_t ev[8], evin[8];
    for (int k = 0; k < 8; ++k) evin[k] = in[2 * k * stride];
    idct8v(evin, ev, 1);
    int64_t s[8];
    for (int j = 0; j < 8; ++j) s[j] = in[(2 * bitrev(j, 3) + 1) * stride];
    static const int ang[4] = {60, 28, 44, 12};
    int64_t t[8];
    for (int j = 0; j < 4; ++j) {
        int a = ang[j];
        int64_t lo = s[j], hi = s[7 - j];
        t[j] = hb(C_[a], lo, -C_[64 - a], hi);
        t[7 - j] = hb(C_[64 - a], lo, C_[a], hi);
    }
    int64_t u[8] = {t[0] + t[1], t[0] - t[1], -t[2] + t[3], t[2] + t[3],
                    t[4] + t[5], t[4] - t[5], -t[6] + t[7], t[6] + t[7]};
    int64_t v[8];
    for (int k = 0; k < 8; ++k) v[k] = u[k];
    v[1] = hb(-C_[16], u[1], C_[48], u[6]);
    v[6] = hb(C_[48], u[1], C_[16], u[6]);
    v[2] = hb(-C_[48], u[2], -C_[16], u[5]);
    v[5] = hb(-C_[16], u[2], C_[48], u[5]);
    int64_t w[8] = {v[0] + v[3], v[1] + v[2], v[1] - v[2], v[0] - v[3],
                    -v[4] + v[7], -v[5] + v[6], v[5] + v[6], v[4] + v[7]};
    int64_t o[8];
    for (int k = 0; k < 8; ++k) o[k] = w[k];
    o[2] = hb(-C_[32], w[2], C_[32], w[5]);
    o[5] = hb(C_[32], w[2], C_[32], w[5]);
    o[3] = hb(-C_[32], w[3], C_[32], w[4]);
    o[4] = hb(C_[32], w[3], C_[32], w[4]);
    for (int k = 0; k < 8; ++k) {
        out[k] = ev[k] + o[7 - k];
        out[8 + k] = ev[7 - k] - o[k];
    }
}

void idct32v(const int64_t* in, int64_t* out, int stride) {
    int64_t ev[16], evin[16];
    for (int k = 0; k < 16; ++k) evin[k] = in[2 * k * stride];
    idct16v(evin, ev, 1);
    int64_t s[16];
    for (int j = 0; j < 16; ++j) s[j] = in[(2 * bitrev(j, 4) + 1) * stride];
    static const int ang[8] = {62, 30, 46, 14, 54, 22, 38, 6};
    int64_t t[16];
    for (int j = 0; j < 8; ++j) {
        int a = ang[j];
        int64_t lo = s[j], hi = s[15 - j];
        t[j] = hb(C_[a], lo, -C_[64 - a], hi);
        t[15 - j] = hb(C_[64 - a], lo, C_[a], hi);
    }
    int64_t u[16];
    for (int g = 0; g < 8; ++g) {
        int64_t a = t[2 * g], b = t[2 * g + 1];
        if (g % 2 == 0) { u[2 * g] = a + b; u[2 * g + 1] = a - b; }
        else { u[2 * g] = -a + b; u[2 * g + 1] = a + b; }
    }
    int64_t v[16];
    for (int k = 0; k < 16; ++k) v[k] = u[k];
    v[1] = hb(-C_[8], u[1], C_[56], u[14]);
    v[14] = hb(C_[56], u[1], C_[8], u[14]);
    v[2] = hb(-C_[56], u[2], -C_[8], u[13]);
    v[13] = hb(-C_[8], u[2], C_[56], u[13]);
    v[5] = hb(-C_[40], u[5], C_[24], u[10]);
    v[10] = hb(C_[24], u[5], C_[40], u[10]);
    v[6] = hb(-C_[24], u[6], -C_[40], u[9]);
    v[9] = hb(-C_[40], u[6], C_[24], u[9]);
    int64_t w[16];
    for (int k = 0; k < 16; ++k) w[k] = v[k];
    for (int g = 0; g < 4; ++g) {
        int b0 = 4 * g;
        int64_t a0 = v[b0], a1 = v[b0 + 1], a2 = v[b0 + 2], a3 = v[b0 + 3];
        if (g % 2 == 0) {
            w[b0] = a0 + a3; w[b0 + 1] = a1 + a2;
            w[b0 + 2] = a1 - a2; w[b0 + 3] = a0 - a3;
        } else {
            w[b0] = -a0 + a3; w[b0 + 1] = -a1 + a2;
            w[b0 + 2] = a1 + a2; w[b0 + 3] = a0 + a3;
        }
    }
    int64_t y[16];
    for (int k = 0; k < 16; ++k) y[k] = w[k];
    y[2] = hb(-C_[16], w[2], C_[48], w[13]);
    y[13] = hb(C_[48], w[2], C_[16], w[13]);
    y[3] = hb(-C_[16], w[3], C_[48], w[12]);
    y[12] = hb(C_[48], w[3], C_[16], w[12]);
    y[4] = hb(-C_[48], w[4], -C_[16], w[11]);
    y[11] = hb(-C_[16], w[4], C_[48], w[11]);
    y[5] = hb(-C_[48], w[5], -C_[16], w[10]);
    y[10] = hb(-C_[16], w[5], C_[48], w[10]);
    int64_t z[16];
    for (int k = 0; k < 16; ++k) z[k] = y[k];
    for (int k = 0; k < 4; ++k) {
        z[k] = y[k] + y[7 - k];
        z[7 - k] = y[k] - y[7 - k];
    }
    for (int k = 0; k < 4; ++k) {
        z[8 + k] = -y[8 + k] + y[15 - k];
        z[15 - k] = y[8 + k] + y[15 - k];
    }
    int64_t o[16];
    for (int k = 0; k < 16; ++k) o[k] = z[k];
    for (int k = 4; k < 8; ++k) {
        int m = 15 - k;
        o[k] = hb(-C_[32], z[k], C_[32], z[m]);
        o[m] = hb(C_[32], z[k], C_[32], z[m]);
    }
    for (int k = 0; k < 16; ++k) {
        out[k] = ev[k] + o[15 - k];
        out[16 + k] = ev[15 - k] - o[k];
    }
}

inline int64_t identity_pass(int64_t x, int n) {
    if (n == 4) return (x * 5793 + 2048) >> 12;
    if (n == 8) return x * 2;
    if (n == 16) return (x * 2 * 5793 + 2048) >> 12;
    return x * 4;
}

// 2-D inverse (row pass + shift0 + clamp, col pass + >>4), matching
// av1_itx.inverse_tx2d exactly. tx_type: 0 = DCT_DCT, 1 = IDTX.
void inverse_tx2d_c(const int64_t* coefs, int n, int tx_type,
                    int64_t* res) {
    const int shift0 = (n == 4) ? 0 : (n == 8) ? 1 : 2;
    int64_t rows[32 * 32];
    if (tx_type == 1) {
        for (int i = 0; i < n * n; ++i) {
            int64_t v = identity_pass(coefs[i], n);
            if (shift0) v = (v + (1 << (shift0 - 1))) >> shift0;
            if (v < -32768) v = -32768;
            if (v > 32767) v = 32767;
            rows[i] = v;
        }
        for (int i = 0; i < n * n; ++i)
            res[i] = (identity_pass(rows[i], n) + 8) >> 4;
        return;
    }
    void (*f)(const int64_t*, int64_t*, int) =
        (n == 4) ? idct4v : (n == 8) ? idct8v : (n == 16) ? idct16v
                                                          : idct32v;
    int64_t tmp[32];
    for (int i = 0; i < n; ++i) {
        f(coefs + i * n, tmp, 1);
        for (int k = 0; k < n; ++k) {
            int64_t v = tmp[k];
            if (shift0) v = (v + (1 << (shift0 - 1))) >> shift0;
            if (v < -32768) v = -32768;
            if (v > 32767) v = 32767;
            rows[i * n + k] = v;
        }
    }
    for (int j = 0; j < n; ++j) {
        f(rows + j, tmp, n);
        for (int k = 0; k < n; ++k) res[k * n + j] = (tmp[k] + 8) >> 4;
    }
}

struct DctMats {
    double m4[4 * 4], m8[8 * 8], m16[16 * 16], m32[32 * 32];
    DctMats() {
        double* ms[4] = {m4, m8, m16, m32};
        int ns[4] = {4, 8, 16, 32};
        for (int t = 0; t < 4; ++t) {
            int n = ns[t];
            for (int k = 0; k < n; ++k)
                for (int x = 0; x < n; ++x) {
                    double v = std::cos(M_PI * k * (2 * x + 1) / (2 * n))
                        * std::sqrt(2.0 / n);
                    if (k == 0) v *= std::sqrt(0.5);
                    ms[t][k * n + x] = v;
                }
        }
    }
    const double* get(int n) const {
        return (n == 4) ? m4 : (n == 8) ? m8 : (n == 16) ? m16 : m32;
    }
};
const DctMats DM;

}  // namespace

// Dequant (spec 7.13.3) + inverse tx + clip(pred + res): recon from
// levels, the byte-true decoder model.  quant: int32 n*n raster.
IK_EXPORT void ik_av1_recon(const int32_t* quant, const uint8_t* pred,
                            int n, int dcq, int acq, int tx_type,
                            uint8_t* out) {
    const int dq_denom = (n == 32) ? 2 : 1;
    int64_t coefs[32 * 32];
    bool any = false;
    for (int i = 0; i < n * n; ++i) {
        int64_t lv = quant[i];
        if (!lv) { coefs[i] = 0; continue; }
        any = true;
        int64_t q = (i == 0) ? dcq : acq;
        int64_t av = ((lv < 0 ? -lv : lv) * q & 0xFFFFFF) / dq_denom;
        if (lv > 0) coefs[i] = av < 32767 ? av : 32767;
        else coefs[i] = -(av < 32768 ? av : 32768);
    }
    if (!any) { std::memcpy(out, pred, (size_t)n * n); return; }
    int64_t res[32 * 32];
    inverse_tx2d_c(coefs, n, tx_type, res);
    for (int i = 0; i < n * n; ++i) {
        int64_t v = pred[i] + res[i];
        out[i] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    }
}

// Forward transform + quantize + recon + SSE for one RD candidate.
// tx_type 0 = DCT (float orthonormal forward, matching av1_image.fdct2),
// 1 = IDTX (forward = residual).  Returns SSE(src, recon); out_nnz
// counts nonzero levels.
IK_EXPORT long long ik_av1_leaf_eval(const uint8_t* src,
                                     const uint8_t* pred, int n,
                                     int dcq, int acq, int tx_type,
                                     int32_t* out_quant,
                                     uint8_t* out_recon, int* out_nnz) {
    double res[32 * 32];
    for (int i = 0; i < n * n; ++i)
        res[i] = (double)src[i] - (double)pred[i];
    double coefs[32 * 32];
    if (tx_type == 1) {
        std::memcpy(coefs, res, sizeof(double) * n * n);
    } else {
        const double* m = DM.get(n);
        double tmp[32 * 32];
        // tmp = M @ res
        for (int k = 0; k < n; ++k)
            for (int x = 0; x < n; ++x) {
                double acc = 0;
                for (int j = 0; j < n; ++j)
                    acc += m[k * n + j] * res[j * n + x];
                tmp[k * n + x] = acc;
            }
        // coefs = tmp @ M^T
        for (int k = 0; k < n; ++k)
            for (int x = 0; x < n; ++x) {
                double acc = 0;
                for (int j = 0; j < n; ++j)
                    acc += tmp[k * n + j] * m[x * n + j];
                coefs[k * n + x] = acc;
            }
    }
    const double step_ac = acq / 8.0, step_dc = dcq / 8.0;
    int nnz = 0;
    for (int i = 0; i < n * n; ++i) {
        double c = coefs[i];
        double step = (i == 0) ? step_dc : step_ac;
        double lv = std::floor(std::fabs(c) / step + 0.5);
        if (lv > 4096) lv = 4096;
        int32_t q = (int32_t)(c < 0 ? -lv : lv);
        out_quant[i] = q;
        if (q) ++nnz;
    }
    *out_nnz = nnz;
    if (!nnz) {
        std::memcpy(out_recon, pred, (size_t)n * n);
    } else {
        ik_av1_recon(out_quant, pred, n, dcq, acq, tx_type, out_recon);
    }
    long long sse = 0;
    for (int i = 0; i < n * n; ++i) {
        long long d = (long long)src[i] - (long long)out_recon[i];
        sse += d * d;
    }
    return sse;
}
