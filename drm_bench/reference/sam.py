"""Plain reference of the SAM alignment lines the mapper writes for one
read (the reference mapper's utils.cpp:336-404, as the port keeps it for a
one-record reference without CIGAR, MAPQ or quality options): one line a
candidate, the first primary (FLAG 0 or 16), the rest secondary (FLAG 256
or 272); RNAME the reference's "ref", POS = window // 2 + 1, MAPQ 60, the
pseudo CIGAR <read length>M, SEQ as sequenced, QUAL "*".  A missing
primary is an unmapped line; missing secondaries are left out."""

from __future__ import annotations


def read_lines(name: str, seq: str, ids) -> list[str]:
    out = []
    for j, wid in enumerate(int(x) for x in ids):
        if wid < 0:
            if j == 0:
                out.append(f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t*\n")
            continue
        flag = (0 if j == 0 else 256) | (16 if wid % 2 else 0)
        out.append(f"{name}\t{flag}\tref\t{wid // 2 + 1}\t60\t{len(seq)}M\t*\t0\t0\t{seq}\t*\n")
    return out


def lines_by_read(path: str) -> dict[str, list[str]]:
    """A SAM file's alignment lines grouped by QNAME, in file order."""
    out: dict[str, list[str]] = {}
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            out.setdefault(line.split("\t", 1)[0], []).append(line)
    return out


def ids_of(lines: list[str]) -> list[int] | None:
    """The window ids a read's lines name, in order (2 x (POS - 1), + 1
    on the reverse strand; an unmapped line names none); None when a line
    cannot be read."""
    out = []
    try:
        for line in lines:
            f = line.split("\t")
            flag = int(f[1])
            if not flag & 4:
                out.append(2 * (int(f[3]) - 1) + (1 if flag & 16 else 0))
    except (IndexError, ValueError):
        return None
    return out


def unequal(names: list[str], seqs: list[str], got: list, final) -> list[bool]:
    """For each read, whether its lines (got, None if absent) differ from
    those the ids final [n, k] give."""
    return [got[w] != read_lines(names[w], seqs[w], final[w]) for w in range(len(names))]
