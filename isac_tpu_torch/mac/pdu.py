"""MAC PDU multiplexing per TS 38.321 §6.1.2 + BSR control elements §6.1.3.1.

Ref: macMultiplex.m, macSubPDU.m, macPDUParser.m, macBSRParser.m,
macPaddingSubPDU.m (SURVEY §2.5). Byte-level numpy codecs (host control plane).

Subheader: R/F/LCID/L — F=0: 8-bit L; F=1: 16-bit L. Padding subPDU: LCID 63,
no L. BSR: short (LCID 61): LCG(3b)+buffer-size index(5b); long (LCID 62):
LCG bitmap byte + one 8-bit size index per set LCG.
"""

from __future__ import annotations

import numpy as np

LCID_CCCH = 0
LCID_PADDING = 63
LCID_SHORT_BSR = 61
LCID_LONG_BSR = 62

# TS 38.321 Table 6.1.3.1-1 (5-bit buffer size levels, bytes) — exponential grid
BSR_TABLE_5BIT = np.array(
    [0, 10, 14, 20, 28, 38, 53, 74, 102, 142, 198, 276, 384, 535, 745, 1038,
     1446, 2014, 2806, 3909, 5446, 7587, 10570, 14726, 20516, 28581, 39818,
     55474, 77284, 107669, 150000, 300000]
)


def bsr_index(n_bytes: int) -> int:
    """Smallest level >= n_bytes (31 = max)."""
    return int(np.searchsorted(BSR_TABLE_5BIT, min(n_bytes, BSR_TABLE_5BIT[-1]), "left"))


def bsr_bytes(idx: int) -> int:
    return int(BSR_TABLE_5BIT[min(idx, 31)])


def subpdu(lcid: int, payload: bytes) -> bytes:
    """R/F/LCID/L subheader + payload."""
    n = len(payload)
    if n < 256:
        hdr = bytes([lcid & 0x3F, n])
    else:
        hdr = bytes([0x40 | (lcid & 0x3F), (n >> 8) & 0xFF, n & 0xFF])
    return hdr + payload


def short_bsr(lcg: int, n_bytes: int) -> bytes:
    ce = bytes([((lcg & 0x7) << 5) | (bsr_index(n_bytes) & 0x1F)])
    return bytes([LCID_SHORT_BSR, len(ce)]) + ce


def long_bsr(lcg_bytes: dict) -> bytes:
    """lcg_bytes: lcg id -> bytes pending."""
    bitmap = 0
    body = []
    for lcg in sorted(lcg_bytes):
        bitmap |= 1 << lcg
        body.append(min(bsr_index(lcg_bytes[lcg]) * 8 // 8, 254))
    ce = bytes([bitmap] + body)
    return bytes([LCID_LONG_BSR, len(ce)]) + ce


def build_mac_pdu(sdus: list, pdu_size: int, control: list = ()) -> bytes:
    """Multiplex control CEs + (lcid, sdu_bytes) list, pad to pdu_size
    (macMultiplex.m / constructMACPDU, macEntity.m:319-357)."""
    out = bytearray()
    for ce in control:
        out += ce
    for lcid, sdu in sdus:
        out += subpdu(lcid, sdu)
    if len(out) > pdu_size:
        raise ValueError(f"MAC PDU overflow: {len(out)} > {pdu_size}")
    pad = pdu_size - len(out)
    if pad == 1:
        out += bytes([LCID_PADDING])
    elif pad >= 2:
        out += bytes([LCID_PADDING, 0]) + bytes(pad - 2)
    return bytes(out)


def parse_mac_pdu(pdu: bytes) -> dict:
    """-> {'sdus': [(lcid, bytes)], 'bsr': [(lcg, bytes_level)], 'padding': n}."""
    out = {"sdus": [], "bsr": [], "padding": 0}
    i = 0
    n = len(pdu)
    while i < n:
        b0 = pdu[i]
        lcid = b0 & 0x3F
        f = (b0 >> 6) & 1
        if lcid == LCID_PADDING:
            out["padding"] = n - i
            break
        if f:
            length = (pdu[i + 1] << 8) | pdu[i + 2]
            i += 3
        else:
            length = pdu[i + 1]
            i += 2
        body = pdu[i : i + length]
        i += length
        if lcid == LCID_SHORT_BSR:
            lcg = (body[0] >> 5) & 0x7
            out["bsr"].append((lcg, bsr_bytes(body[0] & 0x1F)))
        elif lcid == LCID_LONG_BSR:
            bitmap = body[0]
            j = 1
            for lcg in range(8):
                if bitmap & (1 << lcg):
                    out["bsr"].append((lcg, bsr_bytes(body[j])))
                    j += 1
        else:
            out["sdus"].append((lcid, bytes(body)))
    return out
