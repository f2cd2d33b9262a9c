# Copied from deepreadmapper_tpu/io/sam.py, the JAX-free host layer; kept in step with it.
"""SAM output (reference: write_sam / write_sam_streaming,
src/utils/utils.cpp:336-503).

Per (query, candidate j<k) line: QNAME = fastq id, FLAG = (0 primary / 256
secondary) | 16 when the candidate id is odd (reverse strand), POS =
seq_id // 2 + 1 (1-based), MAPQ = 60 pseudo, CIGAR = "<len>M" pseudo, SEQ =
query with '<'/'>' wrapping stripped, QUAL = '*'.
"""

from __future__ import annotations

from typing import Iterable

import re

import numpy as np

PREFIX_LEN = 1
POSTFIX_LEN = 1

_COMP = str.maketrans("ACGTNacgtn", "TGCANtgcan")


def _clean_query(q: str) -> str:
    if len(q) > PREFIX_LEN + POSTFIX_LEN:
        return q[PREFIX_LEN : len(q) - POSTFIX_LEN]
    return q


def _revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def _pg_line(pg: str | None) -> str:
    """@PG provenance line (standard SAM practice; the reference emits
    none).  `pg` is the command-line summary for the CL field."""
    if pg is None:
        return ""
    from deepreadmapper_tpu_torch import __version__

    return (
        "@PG\tID:deepreadmapper_tpu\tPN:deepreadmapper_tpu"
        f"\tVN:{__version__}\tCL:{pg}\n"
    )


def parse_read_group(rg: str | None) -> tuple[str, str]:
    """--read-group string -> (@RG header line, RG id).

    Accepts tab-separated fields (real tabs or bwa-style literal "\\t"
    escapes: 'ID:x\\tSM:y'), falling back to comma-separated when no tab
    is present ("ID:s1,SM:sampleA,PL:ONT" — use the tab form when a value
    itself contains a comma).  Every field must be TAG:VALUE; ID: is
    required (it is what every alignment line's RG:Z references — the
    GATK-class tools refuse BAMs without it)."""
    if not rg:
        return "", ""
    rg = rg.replace("\\t", "\t")
    sep = "\t" if "\t" in rg else ","
    fields = [f.strip() for f in rg.split(sep) if f.strip()]
    bad = [f for f in fields
           if not re.fullmatch(r"[A-Za-z][A-Za-z0-9]:.+", f)]
    if bad:
        raise ValueError(
            f"--read-group fields must be TAG:VALUE; malformed: {bad} "
            "(a value containing a comma needs the tab-separated form, "
            "e.g. 'ID:x\\tDS:lane 7, repeat 2')"
        )
    rid = next((f[3:] for f in fields if f.startswith("ID:")), None)
    if not rid:
        raise ValueError(
            f"--read-group needs an ID: field (got {rg!r}); e.g. "
            "'ID:run1,SM:sampleA'"
        )
    return "@RG\t" + "\t".join(fields) + "\n", rid


def sam_header(ref_name: str, ref_len: int, pg: str | None = None,
               rg: str | None = None) -> str:
    return (
        f"@HD\tVN:1.0\tSO:unsorted\n@SQ\tSN:{ref_name}\tLN:{ref_len}\n"
        + parse_read_group(rg)[0]
        + _pg_line(pg)
    )


def sam_header_multi(
    record_names: list[str], record_lens: list[int], pg: str | None = None,
    rg: str | None = None,
) -> str:
    """Proper per-chromosome @SQ lines (beyond the reference's single
    hard-coded SN:ref) for multi-record references."""
    sq = "".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in zip(record_names, record_lens)
    )
    return (
        "@HD\tVN:1.0\tSO:unsorted\n" + sq + parse_read_group(rg)[0]
        + _pg_line(pg)
    )




_MD_COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}


def alignment_tags(a, b, a0, b0, runs, reverse=False):
    """NM:i / MD:Z / AS:i values from one local alignment.

    a/b: query/reference byte rows (np.uint8) in the ALIGNMENT's
    orientation; a0/b0: alignment span starts; runs: [(count, 'M'|'I'|'D')]
    op runs (soft clips excluded).  reverse=True re-expresses MD in the
    opposite orientation (reversed event order, complemented bases): the
    short-read aligner works in sequenced-read-vs-strand-matched-window
    space while SAM's MD walks the FORWARD reference.  NM and AS are
    orientation-invariant.  AS uses the reference scoring (+1 match /
    -1 mismatch / -1 per gap base, metrics.cpp:17-43).  The reference
    emits no tags at all (utils.cpp:336-404); NM/MD let samtools calmd /
    variant callers consume the alignments without the reference genome.
    """
    import numpy as np_

    i, j = int(a0), int(b0)
    nm = 0
    matches = 0
    events = []  # ("=", n) | ("X", ref_base) | ("D", ref_bases)
    for n, op in runs:
        if op == "M":
            qa = np_.asarray(a[i : i + n])
            rb = np_.asarray(b[j : j + n])
            mism = np_.nonzero(qa != rb)[0]
            prev = 0
            for t in mism.tolist():
                if t > prev:
                    events.append(("=", t - prev))
                events.append(("X", chr(int(rb[t]))))
                prev = t + 1
            if n > prev:
                events.append(("=", n - prev))
            nm += len(mism)
            matches += n - len(mism)
            i += n
            j += n
        elif op == "I":
            nm += n
            i += n
        elif op == "D":
            events.append(
                ("D", bytes(np_.asarray(b[j : j + n])).decode("ascii"))
            )
            nm += n
            j += n
    if reverse:
        events.reverse()
        events = [
            (kind, val) if kind == "="
            else (kind, "".join(_MD_COMP.get(c, "N") for c in reversed(val)))
            for kind, val in events
        ]
    md = []
    run = 0
    for kind, val in events:
        if kind == "=":
            run += val
        else:
            md.append(str(run))
            run = 0
            md.append(val if kind == "X" else "^" + val)
    md.append(str(run))
    as_ = matches - nm
    return nm, "".join(md), as_


def format_sam_records(
    query_seqs: list[str],
    query_ids: list[str],
    cand_ids: Iterable[int],
    k: int,
    ref_name: str,
    query_offset: int = 0,
    record_names: list[str] | None = None,
    dense_off: np.ndarray | None = None,
    primary_cigars: list[str] | None = None,
    primary_pos_off: np.ndarray | None = None,
    mapq: np.ndarray | None = None,
    supplementary: dict | None = None,
    quals: list[str] | None = None,
    mate: dict | None = None,
    primary_tags: list[str] | None = None,
    rg_id: str = "",
) -> Iterable[str]:
    """Yield SAM lines for queries [query_offset, query_offset+len(query_seqs))
    whose flattened candidate ids are ``cand_ids`` ([nq * k], row-major).

    With record_names + dense_off (cumulative stride-1 window counts per
    record), global window ids resolve to per-chromosome RNAME and 1-based
    record-local POS; otherwise the reference's single-ref convention
    (POS = id//2 + 1) is emitted.

    primary_cigars/primary_pos_off (per query, already in REFERENCE
    orientation): real SW-traceback CIGARs + alignment-start offsets for
    each query's PRIMARY line; secondaries keep the pseudo <len>M.

    Invalid candidate ids (-1, from padded/starved candidate lists): the
    reference throws on them (reranker.cpp:26-29); here a -1 primary emits a
    proper FLAG-4 unmapped record (RNAME *, POS 0, MAPQ 0, CIGAR *) and -1
    secondaries are dropped — the SAM stays consumable instead of carrying
    POS-0 garbage lines.

    SEQ orientation: pseudo-CIGAR lines keep SEQ as sequenced even under
    FLAG 16 (reference-parity quirk, utils.cpp:336-404).  When a REAL CIGAR
    is attached to a reverse-strand primary, SEQ is reverse-complemented so
    the reference-orientation CIGAR describes the emitted sequence base by
    base (what samtools expects).

    mapq (per GLOBAL query, like primary_cigars): real mapping qualities
    for primary lines; secondaries then carry 0 (they are by definition
    not the best placement).  Default None keeps the reference's
    constant 60 everywhere (utils.cpp:336-404).

    quals (per GLOBAL query): base-quality strings to emit in QUAL
    (reversed whenever SEQ is reverse-complemented, so bases and
    qualities stay paired).  Default None keeps the reference's '*'.

    mate (paired-end): {global_query: (flag_extra, rnext, pnext, tlen)} —
    primary lines OR the extra paired FLAG bits (0x1/0x2/0x20/0x40/0x80/
    0x8) and fill RNEXT/PNEXT/TLEN; secondary lines get only the
    flag_extra bits masked to 0x1|0x40|0x80 (mate fields stay '*').

    supplementary: {global_query: [(seq_id, cigar, mapq)]} — FLAG-2048
    split-read segments (long-read chimera halves); their soft-clip
    CIGARs mark the read interval each segment aligns, SEQ follows the
    same orientation rule as real-CIGAR primaries.  Primary and
    supplementary lines of a split read cross-reference through standard
    SA:Z tags (rname,pos,strand,CIGAR,mapQ,NM;) so samtools/SV callers
    can reassemble the chimera; NM is 0 (edit distance not computed).

    primary_tags (per GLOBAL query): preformatted tag suffix (e.g.
    "\tNM:i:2\tMD:Z:49A100\tAS:i:144" from alignment_tags) appended to
    the PRIMARY line when its real CIGAR is attached.

    rg_id: read-group id — every line (incl. unmapped/secondary/
    supplementary) gets RG:Z:<id>, matching the header's @RG."""
    rg_tag = f"\tRG:Z:{rg_id}" if rg_id else ""
    cand_ids = np.asarray(list(cand_ids), dtype=np.int64)
    if record_names is not None:
        # one vectorized lookup for every line (not one searchsorted per
        # candidate inside the loop)
        from deepreadmapper_tpu_torch.io.fasta import record_of

        rec, loc = record_of(cand_ids >> 1, dense_off)
        all_pos = loc + 1
    else:
        rec = None
        all_pos = (cand_ids >> 1) + 1
    for i, qseq in enumerate(query_seqs):
        clean = _clean_query(qseq)
        gq = query_offset + i
        qname = (
            query_ids[gq]
            if gq < len(query_ids) and query_ids[gq]
            else f"S1/{gq + 1}/0"
        )
        pseudo = f"{len(clean)}M"
        qual_fwd = (
            quals[gq] if quals is not None and gq < len(quals) else "*"
        ) or "*"
        qual_rev = qual_fwd[::-1] if qual_fwd != "*" else "*"
        # resolve supplementary (split-read) fields up front: the primary
        # line's SA:Z tag references them, and theirs references it
        supp_fields = []
        for seq_id, cig, q in (supplementary or {}).get(gq, ()):
            if record_names is not None:
                from deepreadmapper_tpu_torch.io.fasta import record_of

                rec_s, loc_s = record_of(
                    np.asarray([seq_id >> 1]), dense_off
                )
                rname_s = record_names[int(rec_s[0])]
                pos_s = int(loc_s[0]) + 1
            else:
                rname_s = ref_name
                pos_s = (seq_id >> 1) + 1
            supp_fields.append((seq_id, cig, q, rname_s, pos_s))
        sa_primary = "".join(
            f"{rn},{p},{'-' if sid % 2 else '+'},{cg},{q},0;"
            for sid, cg, q, rn, p in supp_fields
        )
        primary_desc = ""
        for j in range(k):
            idx = i * k + j
            if idx >= cand_ids.size:
                break
            seq_id = int(cand_ids[idx])
            if seq_id < 0:
                if j == 0:
                    uflag = 4
                    if mate is not None and gq in mate:
                        uflag |= mate[gq][0] & 0xE9  # paired bits + mate info
                    yield (
                        f"{qname}\t{uflag}\t*\t0\t0\t*\t*\t0\t0\t{clean}\t"
                        f"{qual_fwd}{rg_tag}\n"
                    )
                continue  # drop -1 secondaries
            rname = record_names[rec[idx]] if rec is not None else ref_name
            pos = int(all_pos[idx])
            cigar = pseudo
            seq_out = clean
            if j == 0 and primary_cigars is not None and primary_cigars[gq]:
                cigar = primary_cigars[gq]
                pos += int(primary_pos_off[gq])
                if seq_id % 2 == 1:
                    seq_out = _revcomp(clean)
            flag = (0 if j == 0 else 256) | (16 if seq_id % 2 == 1 else 0)
            if mapq is None:
                q = 60
            else:
                q = int(mapq[gq]) if j == 0 else 0
            tag = ""
            if (
                j == 0
                and primary_tags is not None
                and cigar is not pseudo
                and primary_tags[gq]
            ):
                tag += primary_tags[gq]
            if j == 0 and supp_fields:
                primary_desc = (
                    f"{rname},{pos},{'-' if seq_id % 2 else '+'},"
                    f"{cigar},{q},0;"
                )
                tag += f"\tSA:Z:{sa_primary}"
            rnext, pnext, tlen = "*", 0, 0
            if mate is not None and gq in mate:
                mflag, mrnext, mpnext, mtlen = mate[gq]
                if j == 0:
                    flag |= mflag
                    rnext, pnext, tlen = mrnext, mpnext, mtlen
                else:
                    flag |= mflag & 0xC1  # paired + first/second only
            qual_out = qual_rev if seq_out is not clean else qual_fwd
            yield (
                f"{qname}\t{flag}\t{rname}\t{pos}\t{q}\t{cigar}\t"
                f"{rnext}\t{pnext}\t{tlen}\t"
                f"{seq_out}\t{qual_out}{tag}{rg_tag}\n"
            )
        for seq_id, cig, q, rname_s, pos_s in supp_fields:
            flag = 2048 | (16 if seq_id % 2 == 1 else 0)
            rev = seq_id % 2 == 1
            seq_out = _revcomp(clean) if rev else clean
            qual_out = qual_rev if rev else qual_fwd
            tag = f"\tSA:Z:{primary_desc}" if primary_desc else ""
            yield (
                f"{qname}\t{flag}\t{rname_s}\t{pos_s}\t{q}\t{cig}\t*\t0\t0\t"
                f"{seq_out}\t{qual_out}{tag}{rg_tag}\n"
            )


def sort_sam_file(path: str) -> None:
    """Coordinate-sort a written SAM in place (samtools sort order: @SQ
    reference order, then 1-based POS; unmapped records last) and stamp
    the @HD line SO:coordinate.  Post-pass over the finished file so every
    write path — batch, paired, long-read — sorts identically; variant
    callers and `samtools index` expect this ordering.

    The whole file is buffered in memory (like the BAM conversion): fine
    up to multi-100MB SAMs; for runs past host RAM, leave --sort off and
    pipe through `samtools sort`, which external-merge-sorts."""
    with open(path) as f:
        lines = f.readlines()
    header = [l for l in lines if l.startswith("@")]
    body = [l for l in lines if not l.startswith("@")]
    order = {}
    for h in header:
        if h.startswith("@SQ"):
            for fld in h.split("\t"):
                if fld.startswith("SN:"):
                    order[fld[3:].strip()] = len(order)

    def key(line):
        f = line.split("\t", 4)
        rname = f[2]
        if rname == "*":
            return (1, 0, 0)
        return (0, order.get(rname, len(order)), int(f[3]))

    body.sort(key=key)
    header = [
        l.replace("SO:unsorted", "SO:coordinate") if l.startswith("@HD")
        else l
        for l in header
    ]
    with open(path, "w") as f:
        f.writelines(header)
        f.writelines(body)


def mark_duplicates(path: str) -> int:
    """Mark PCR/optical duplicates (FLAG 0x400) in a written SAM —
    `samtools markdup`'s core rule: primary alignments sharing the same
    (RNAME, POS, strand[, TLEN for paired]) are one molecule; the
    highest-MAPQ copy stays unmarked, the rest get 0x400.  Secondary /
    supplementary / unmapped lines are left untouched.  Returns the
    number of lines marked.  The reference has no duplicate handling."""
    with open(path) as f:
        lines = f.readlines()
    groups: dict[tuple, list[int]] = {}
    for i, line in enumerate(lines):
        if line.startswith("@"):
            continue
        f_ = line.split("\t")
        flag = int(f_[1])
        if flag & 0x904 or f_[2] == "*":
            continue  # only mapped primaries define molecules
        key = (f_[2], int(f_[3]), flag & 0x10,
               int(f_[8]) if flag & 0x1 else None,
               flag & 0xC0)  # first/second-in-pair kept separate
        groups.setdefault(key, []).append(i)
    n_marked = 0
    for idxs in groups.values():
        if len(idxs) < 2:
            continue
        best = max(idxs, key=lambda i: int(lines[i].split("\t")[4]))
        for i in idxs:
            if i == best:
                continue
            f_ = lines[i].split("\t")
            f_[1] = str(int(f_[1]) | 0x400)
            lines[i] = "\t".join(f_)
            n_marked += 1
    with open(path, "w") as f:
        f.writelines(lines)
    return n_marked


def write_sam(
    query_seqs: list[str],
    query_ids: list[str],
    cand_ids: Iterable[int],
    ref_name: str,
    ref_len: int,
    k: int,
    output_file: str,
    append: bool = False,
    write_header: bool = True,
    query_offset: int = 0,
    record_names: list[str] | None = None,
    record_lens: list[int] | None = None,
    dense_off: np.ndarray | None = None,
    primary_cigars: list[str] | None = None,
    primary_pos_off: np.ndarray | None = None,
    mapq: np.ndarray | None = None,
    supplementary: dict | None = None,
    pg: str | None = None,
    quals: list[str] | None = None,
    mate: dict | None = None,
    primary_tags: list[str] | None = None,
    rg: str | None = None,
) -> None:
    mode = "a" if append else "w"
    rg_id = parse_read_group(rg)[1]
    with open(output_file, mode) as f:
        if write_header:
            if record_names is not None:
                f.write(sam_header_multi(record_names, record_lens, pg, rg))
            else:
                f.write(sam_header(ref_name, ref_len, pg, rg))
        for line in format_sam_records(
            query_seqs, query_ids, cand_ids, k, ref_name, query_offset,
            record_names, dense_off, primary_cigars, primary_pos_off,
            mapq, supplementary, quals, mate, primary_tags, rg_id,
        ):
            f.write(line)
