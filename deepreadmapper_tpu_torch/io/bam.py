# Copied from deepreadmapper_tpu/io/bam.py, the JAX-free host layer; kept in step with it.
"""BAM output: convert a finished SAM into BGZF-compressed binary BAM.

The reference emits SAM text only; every downstream consumer (samtools
index/view, IGV, variant callers) wants BAM.  This is a self-contained
encoder of the BAM v1 spec (htslib SAMv1.pdf): BGZF framing (gzip members
carrying the BSIZE extra subfield + the fixed EOF block), the binary
header (magic, SAM-header text, reference dictionary), and per-record
encoding (4-bit packed SEQ, uint32 CIGAR ops, Phred-33-decoded QUAL,
reg2bin interval bins, Z-type tags passed through).  Written as a
post-pass over the SAM file we just wrote — one code path serves batch,
paired, and long-read outputs alike.

Validated by tests/test_bam.py's independent decoder (gzip.decompress
handles the member concatenation, then records are re-parsed field by
field against the SAM source).
"""

from __future__ import annotations

import struct
import zlib

_CIGAR_OPS = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6,
              "=": 7, "X": 8}
_SEQ_NIBBLE = {
    "=": 0, "A": 1, "C": 2, "M": 3, "G": 4, "R": 5, "S": 6, "V": 7,
    "T": 8, "W": 9, "Y": 10, "H": 11, "K": 12, "D": 13, "B": 14, "N": 15,
}
_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _bgzf_block(data: bytes) -> bytes:
    """One BGZF block: a gzip member whose extra field carries BSIZE."""
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    # total block = header(10) + xlen(2) + extra(6) + comp + crc(4) +
    # isize(4); the BSIZE extra subfield stores total - 1
    bsize = len(comp) + 25
    header = (
        b"\x1f\x8b\x08\x04" + b"\x00" * 6
        + struct.pack("<H", 6)            # XLEN
        + b"BC" + struct.pack("<HH", 2, bsize)
    )
    return (
        header + comp
        + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                      len(data) & 0xFFFFFFFF)
    )


class _BgzfWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._buf = bytearray()
        self._coffset = 0  # compressed bytes of flushed blocks

    def voffset(self) -> int:
        """BGZF virtual offset of the next byte: (compressed offset of the
        containing block) << 16 | (offset inside its uncompressed data).
        The block payload cap (0xFF00) keeps the low half within 16 bits."""
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= 0xFF00:
            blk = _bgzf_block(bytes(self._buf[:0xFF00]))
            self._f.write(blk)
            self._coffset += len(blk)
            del self._buf[:0xFF00]

    def close(self) -> None:
        if self._buf:
            self._f.write(_bgzf_block(bytes(self._buf)))
        self._f.write(_BGZF_EOF)
        self._f.close()


def reg2bin(beg: int, end: int) -> int:
    """UCSC binning scheme (SAMv1 spec, section 5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _parse_cigar(cigar: str):
    ops = []
    ref_span = 0
    if cigar == "*":
        return ops, 0
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            ln = int(num)
            num = ""
            ops.append((ln << 4) | _CIGAR_OPS[ch])
            if ch in "MDN=X":
                ref_span += ln
    return ops, ref_span


def _encode_record(fields: list[str], ref_ids: dict[str, int]):
    (qname, flag, rname, pos, mapq, cigar, rnext, pnext, tlen, seq,
     qual) = fields[:11]
    flag = int(flag)
    pos0 = int(pos) - 1
    ref_id = ref_ids.get(rname, -1)
    cig_ops, ref_span = _parse_cigar(cigar)
    if rnext == "=":
        next_ref = ref_id
    else:
        next_ref = ref_ids.get(rnext, -1)
    next_pos = int(pnext) - 1
    l_seq = 0 if seq == "*" else len(seq)
    end = pos0 + (ref_span if ref_span else 1)
    bin_ = reg2bin(max(pos0, 0), max(end, pos0 + 1)) if ref_id >= 0 else 4680
    name_b = qname.encode() + b"\x00"
    out = bytearray()
    out += struct.pack(
        "<iiBBHHHiiii",
        ref_id, pos0, len(name_b), int(mapq), bin_, len(cig_ops), flag,
        l_seq, next_ref, next_pos, int(tlen),
    )
    out += name_b
    for op in cig_ops:
        out += struct.pack("<I", op)
    if l_seq:
        for i in range(0, l_seq - 1, 2):
            out.append(
                (_SEQ_NIBBLE.get(seq[i].upper(), 15) << 4)
                | _SEQ_NIBBLE.get(seq[i + 1].upper(), 15)
            )
        if l_seq & 1:
            out.append(_SEQ_NIBBLE.get(seq[-1].upper(), 15) << 4)
        if qual == "*":
            out += b"\xff" * l_seq
        else:
            out += bytes((min(max(ord(c) - 33, 0), 93) for c in qual))
    # optional tags: Z-typed pass-through (SA:Z etc.)
    for tag in fields[11:]:
        parts = tag.split(":", 2)
        if len(parts) == 3 and parts[1] == "Z":
            out += parts[0].encode()[:2] + b"Z" + parts[2].encode() + b"\x00"
    return (
        struct.pack("<i", len(out)) + bytes(out),
        ref_id, pos0, max(end, pos0 + 1),
    )


def sam_to_bam(sam_path: str, bam_path: str,
               bai_path: str | None = None) -> int:
    """Convert our SAM dialect to BAM; returns the record count.

    bai_path: also write the BAI index (UCSC binning + 16 kb linear
    index over BGZF virtual offsets) — only meaningful when the SAM is
    coordinate-sorted (--sort); together the pair drops straight into
    samtools/IGV without an external indexing step."""
    with open(sam_path) as f:
        lines = f.readlines()
    header_lines = [l for l in lines if l.startswith("@")]
    body = [l for l in lines if not l.startswith("@")]
    refs: list[tuple[str, int]] = []
    for h in header_lines:
        if h.startswith("@SQ"):
            name = ln = None
            for fld in h.rstrip("\n").split("\t"):
                if fld.startswith("SN:"):
                    name = fld[3:]
                elif fld.startswith("LN:"):
                    ln = int(fld[3:])
            if name is not None:
                refs.append((name, ln or 0))
    ref_ids = {name: i for i, (name, _l) in enumerate(refs)}

    w = _BgzfWriter(bam_path)
    text = "".join(header_lines).encode()
    w.write(b"BAM\x01" + struct.pack("<i", len(text)) + text)
    w.write(struct.pack("<i", len(refs)))
    for name, ln in refs:
        nb = name.encode() + b"\x00"
        w.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln))
    n = 0
    # BAI accumulators: per ref, bin -> [chunk (beg, end) voffsets] and a
    # 16 kb linear index of minimal record voffsets
    bins = [dict() for _ in refs]
    linear = [dict() for _ in refs]
    for line in body:
        blob, ref_id, pos0, end = _encode_record(
            line.rstrip("\n").split("\t"), ref_ids
        )
        v0 = w.voffset()
        w.write(blob)
        v1 = w.voffset()
        n += 1
        if bai_path is not None and ref_id >= 0:
            b = reg2bin(max(pos0, 0), end)
            chunks = bins[ref_id].setdefault(b, [])
            if chunks and chunks[-1][1] == v0:
                chunks[-1] = (chunks[-1][0], v1)  # merge adjacent
            else:
                chunks.append((v0, v1))
            lin = linear[ref_id]
            for iv in range(max(pos0, 0) >> 14, ((end - 1) >> 14) + 1):
                if iv not in lin or v0 < lin[iv]:
                    lin[iv] = v0
    w.close()
    if bai_path is not None:
        with open(bai_path, "wb") as f:
            f.write(b"BAI\x01" + struct.pack("<i", len(refs)))
            for r in range(len(refs)):
                f.write(struct.pack("<i", len(bins[r])))
                for b in sorted(bins[r]):
                    chunks = bins[r][b]
                    f.write(struct.pack("<Ii", b, len(chunks)))
                    for beg, endv in chunks:
                        f.write(struct.pack("<QQ", beg, endv))
                n_intv = (max(linear[r]) + 1) if linear[r] else 0
                f.write(struct.pack("<i", n_intv))
                last = 0
                for iv in range(n_intv):
                    # empty intervals inherit the previous offset
                    # (standard practice so lookups never rewind)
                    last = linear[r].get(iv, last)
                    f.write(struct.pack("<Q", last))
    return n
