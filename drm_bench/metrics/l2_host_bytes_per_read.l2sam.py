"""The bytes of window rows the host builds for the L2 re-embed's upload a
read: the program's host_bytes on its post.l2.pack spans, summed over the
window's requests, over their reads (48 a re-embedded window on the wire
path).  A fetch of the windows by id on the card takes it toward 0.  None
where no span carries the counter (a program without it, or no traced
window)."""

from drm_bench.metrics import _program


def read(ctx):
    by = _program.requests(ctx)
    if by is None:
        return None
    got = [s.attrs["host_bytes"] for spans in by.values() for s in spans
           if s.name == "post.l2.pack" and s.attrs and "host_bytes" in s.attrs]
    if not got:
        return None
    return sum(got) / _program.reads(ctx, by)
