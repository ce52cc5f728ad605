"""AV1 integer inverse DCT + dequantization (spec 7.13) — the in-process
reconstruction path of the first-party AV1 encoder.

Implements the spec's multiply-free-structured butterfly networks
(cos128 Q12 weights, Round2 after every rotation) for the square DCT_DCT
sizes the encoder emits (4x4 .. 32x32), plus the 2-D row/column wrapper
with its per-size shifts and the quantizer scaling process.

Correctness contract: tools/av1_itx_probe.py drives EVERY basis vector
(and dense random coefficient sets) of every size through libdav1d via
real encoded streams and requires bit-exact agreement with this module —
the module is certified empirically against the production decoder, not
against a transcription of the spec text.  av1_image.py uses it as the
reconstruction model (replacing the per-block decode oracle), and the
full-frame dav1d conformance gate (tests/test_av1_native.py) re-verifies
end to end.

The port's copy of ``imagekit_tpu/codecs/av1_itx.py``, unchanged.
"""

from __future__ import annotations

import math

import numpy as np

# cos128 lookup, Q12 (spec 7.13.2.10): cospi[k] = round(4096*cos(k*pi/128))
_C = [int(4096 * math.cos(k * math.pi / 128) + 0.5) for k in range(64)]


def _r2(x: int) -> int:
    """Round2(x, 12) with arithmetic shift semantics."""
    return (x + 2048) >> 12


def _hb(w0: int, x0: int, w1: int, x1: int) -> int:
    """half_btf: Round2(w0*x0 + w1*x1, 12)."""
    return (w0 * x0 + w1 * x1 + 2048) >> 12


def _bitrev(j: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (j & 1)
        j >>= 1
    return out


def idct4(x):
    in0, in1, in2, in3 = x
    t0 = _hb(_C[32], in0, _C[32], in2)
    t1 = _hb(_C[32], in0, -_C[32], in2)
    t2 = _hb(_C[48], in1, -_C[16], in3)
    t3 = _hb(_C[16], in1, _C[48], in3)
    return [t0 + t3, t1 + t2, t1 - t2, t0 - t3]


def idct8(x):
    e = idct4(x[0::2])
    x1, x3, x5, x7 = x[1], x[3], x[5], x[7]
    # stage 2 rotations on bitrev-ordered odds (x1, x5, x3, x7)
    t4 = _hb(_C[56], x1, -_C[8], x7)
    t7 = _hb(_C[8], x1, _C[56], x7)
    t5 = _hb(_C[24], x5, -_C[40], x3)
    t6 = _hb(_C[40], x5, _C[24], x3)
    # stage 3 add/sub
    s4 = t4 + t5
    s5 = t4 - t5
    s6 = -t6 + t7
    s7 = t6 + t7
    # stage 4 rotation
    t5 = _hb(-_C[32], s5, _C[32], s6)
    t6 = _hb(_C[32], s5, _C[32], s6)
    o = [s4, t5, t6, s7]
    return [e[0] + o[3], e[1] + o[2], e[2] + o[1], e[3] + o[0],
            e[3] - o[0], e[2] - o[1], e[1] - o[2], e[0] - o[3]]


def idct16(x):
    e = idct8(x[0::2])
    o_in = x[1::2]
    s = [o_in[_bitrev(j, 3)] for j in range(8)]  # x1,x9,x5,x13,x3,x11,x7,x15
    # stage 2 rotations, pairs (j, 15-j), angles 60,28,44,12
    ang = [60, 28, 44, 12]
    t = [0] * 8
    for j in range(4):
        a = ang[j]
        lo, hi = s[j], s[7 - j]
        t[j] = _hb(_C[a], lo, -_C[64 - a], hi)
        t[7 - j] = _hb(_C[64 - a], lo, _C[a], hi)
    # stage 3 add/sub
    u = [t[0] + t[1], t[0] - t[1], -t[2] + t[3], t[2] + t[3],
         t[4] + t[5], t[4] - t[5], -t[6] + t[7], t[6] + t[7]]
    # stage 4 rotations on slots 1,2 (with mirrors 6,5)
    v = list(u)
    v[1] = _hb(-_C[16], u[1], _C[48], u[6])
    v[6] = _hb(_C[48], u[1], _C[16], u[6])
    v[2] = _hb(-_C[48], u[2], -_C[16], u[5])
    v[5] = _hb(-_C[16], u[2], _C[48], u[5])
    # stage 5 add/sub (groups of 4)
    w = [v[0] + v[3], v[1] + v[2], v[1] - v[2], v[0] - v[3],
         -v[4] + v[7], -v[5] + v[6], v[5] + v[6], v[4] + v[7]]
    # stage 6 c32 rotations on (2,5) and (3,4)
    o = list(w)
    o[2] = _hb(-_C[32], w[2], _C[32], w[5])
    o[5] = _hb(_C[32], w[2], _C[32], w[5])
    o[3] = _hb(-_C[32], w[3], _C[32], w[4])
    o[4] = _hb(_C[32], w[3], _C[32], w[4])
    return [e[k] + o[7 - k] for k in range(8)] + \
           [e[7 - k] - o[k] for k in range(8)]


def idct32(x):
    e = idct16(x[0::2])
    o_in = x[1::2]
    s = [o_in[_bitrev(j, 4)] for j in range(16)]
    # stage 2 rotations, pairs (j, 15-j), angles 62,30,46,14,54,22,38,6
    ang = [62, 30, 46, 14, 54, 22, 38, 6]
    t = [0] * 16
    for j in range(8):
        a = ang[j]
        lo, hi = s[j], s[15 - j]
        t[j] = _hb(_C[a], lo, -_C[64 - a], hi)
        t[15 - j] = _hb(_C[64 - a], lo, _C[a], hi)
    # stage 3 add/sub (pairs, alternating sign pattern)
    u = []
    for g in range(8):
        a, b = t[2 * g], t[2 * g + 1]
        if g % 2 == 0:
            u += [a + b, a - b]
        else:
            u += [-a + b, a + b]
    # stage 4 rotations on slots 1,2 / 5,6 (mirrors 14,13 / 10,9)
    v = list(u)
    v[1] = _hb(-_C[8], u[1], _C[56], u[14])
    v[14] = _hb(_C[56], u[1], _C[8], u[14])
    v[2] = _hb(-_C[56], u[2], -_C[8], u[13])
    v[13] = _hb(-_C[8], u[2], _C[56], u[13])
    v[5] = _hb(-_C[40], u[5], _C[24], u[10])
    v[10] = _hb(_C[24], u[5], _C[40], u[10])
    v[6] = _hb(-_C[24], u[6], -_C[40], u[9])
    v[9] = _hb(-_C[40], u[6], _C[24], u[9])
    # stage 5 add/sub (groups of 4)
    w = list(v)
    for g in range(4):
        b0 = 4 * g
        a0, a1, a2, a3 = v[b0], v[b0 + 1], v[b0 + 2], v[b0 + 3]
        if g % 2 == 0:
            w[b0] = a0 + a3
            w[b0 + 1] = a1 + a2
            w[b0 + 2] = a1 - a2
            w[b0 + 3] = a0 - a3
        else:
            w[b0] = -a0 + a3
            w[b0 + 1] = -a1 + a2
            w[b0 + 2] = a1 + a2
            w[b0 + 3] = a0 + a3
    # stage 6 rotations on slots 2,3 / 4,5 (mirrors 13,12 / 11,10)
    y = list(w)
    y[2] = _hb(-_C[16], w[2], _C[48], w[13])
    y[13] = _hb(_C[48], w[2], _C[16], w[13])
    y[3] = _hb(-_C[16], w[3], _C[48], w[12])
    y[12] = _hb(_C[48], w[3], _C[16], w[12])
    y[4] = _hb(-_C[48], w[4], -_C[16], w[11])
    y[11] = _hb(-_C[16], w[4], _C[48], w[11])
    y[5] = _hb(-_C[48], w[5], -_C[16], w[10])
    y[10] = _hb(-_C[16], w[5], _C[48], w[10])
    # stage 7 add/sub (groups of 8)
    z = list(y)
    for g in range(2):
        b0 = 8 * g
        if g == 0:
            for k in range(4):
                z[b0 + k] = y[b0 + k] + y[b0 + 7 - k]
                z[b0 + 7 - k] = y[b0 + k] - y[b0 + 7 - k]
        else:
            for k in range(4):
                z[b0 + k] = -y[b0 + k] + y[b0 + 7 - k]
                z[b0 + 7 - k] = y[b0 + k] + y[b0 + 7 - k]
    # stage 8 c32 rotations on (4,11),(5,10),(6,9),(7,8)
    o = list(z)
    for k in range(4, 8):
        m = 15 - k
        o[k] = _hb(-_C[32], z[k], _C[32], z[m])
        o[m] = _hb(_C[32], z[k], _C[32], z[m])
    return [e[k] + o[15 - k] for k in range(16)] + \
           [e[15 - k] - o[k] for k in range(16)]


_IDCT = {4: idct4, 8: idct8, 16: idct16, 32: idct32}


def _identity_pass(x: np.ndarray, n: int) -> np.ndarray:
    """One inverse-identity pass (spec 7.13.4 identity transforms):
    4: Round2(x*5793, 12) (sqrt2, Q12); 8: x*2;
    16: Round2(x*2*5793, 12); 32: x*4."""
    if n == 4:
        return (x * 5793 + 2048) >> 12
    if n == 8:
        return x * 2
    if n == 16:
        return (x * 2 * 5793 + 2048) >> 12
    return x * 4


def inverse_tx2d(coefs: np.ndarray, shift0: int | None = None,
                 shift1: int = 4, tx_type: str = "DCT") -> np.ndarray:
    """2-D inverse DCT_DCT (or IDTX) of a square dequantized block.

    Row transforms, Round2 by the per-size row shift, column transforms,
    Round2 by 4 — the residual to add to the prediction.  Intermediate
    values are clamped to the 8-bit profile's 16-bit column range
    (spec 7.13.4).

    The butterfly networks are pure {+, -, half_btf} chains, so each
    pass runs VECTORIZED: the idctN function receives a list of n int64
    vectors (element k across every row/column) and numpy broadcasts
    the whole pass at once — int64 `>>` is an arithmetic shift, exactly
    the scalar semantics (probe-certified bit-exact either way)."""
    n = coefs.shape[0]
    if shift0 is None:
        shift0 = {4: 0, 8: 1, 16: 2, 32: 2}[n]
    c = coefs.astype(np.int64)
    if tx_type == "IDTX":
        rows = _identity_pass(c, n)
        if shift0:
            rows = (rows + (1 << (shift0 - 1))) >> shift0
        rows = np.clip(rows, -32768, 32767)
        return (_identity_pass(rows, n) + 8) >> 4
    f = _IDCT[n]
    rows = np.stack(f([c[:, k] for k in range(n)]), axis=1)
    if shift0:
        rows = (rows + (1 << (shift0 - 1))) >> shift0
    rows = np.clip(rows, -32768, 32767)
    res = np.stack(f([rows[k, :] for k in range(n)]), axis=0)
    return (res + 8) >> 4


def dequant(quant, n: int, dc_q: int, ac_q: int) -> np.ndarray:
    """Quantized levels (int (n, n) raster array, or legacy {pos: level}
    dict) -> dequantized coefficient block (spec 7.13.3: abs-multiply
    masked to 24 bits, divided by the size's dqDenom, then sign)."""
    dq_denom = 2 if n == 32 else 1
    if isinstance(quant, dict):
        lv = np.zeros((n, n), dtype=np.int64)
        for pos, v in quant.items():
            lv[pos // n, pos % n] = v
    else:
        lv = np.asarray(quant, dtype=np.int64)
    q = np.full((n, n), ac_q, dtype=np.int64)
    q[0, 0] = dc_q
    av = ((np.abs(lv) * q) & 0xFFFFFF) // dq_denom
    return np.where(lv > 0, np.minimum(av, 32767),
                    np.where(lv < 0, -np.minimum(av, 32768), 0))


def recon_block(pred: np.ndarray, quant: dict, dc_q: int,
                ac_q: int, tx_type: str = "DCT") -> np.ndarray:
    """clip(pred + inverse_tx(dequant(levels))) — the decoder's output."""
    n = pred.shape[0]
    empty = (not quant) if isinstance(quant, dict) else not quant.any()
    if empty:
        return pred.astype(np.uint8)
    res = inverse_tx2d(dequant(quant, n, dc_q, ac_q), tx_type=tx_type)
    return np.clip(pred.astype(np.int64) + res, 0, 255).astype(np.uint8)
