"""The share of the window's Smith-Waterman pairs whose window bytes #3 read
by id from the device's copy of the genome: the program's ``pairs_by_id``
on its ``post.sw.score`` spans, summed over the window's requests, over
the requests' reads x the candidate slots a read (k at stride 1, as the
pipeline takes k_clusters = k there; k_clusters x (2 stride - 1) past it),
in %.  None where no span carries the attribute (a program without the
by-id path, or no traced window)."""

from drm_bench.metrics import _program


def _slots(ctx) -> int:
    req = {"k_clusters": ctx.config["k_clusters"], **ctx.traffic["request"]}
    stride = int(ctx.config["stride"])
    return int(req["k"]) if stride == 1 else int(req["k_clusters"]) * (2 * stride - 1)


def read(ctx):
    by = _program.requests(ctx)
    if by is None:
        return None
    pairs = [s.attrs["pairs_by_id"] for spans in by.values() for s in spans
             if s.name == "post.sw.score" and s.attrs and "pairs_by_id" in s.attrs]
    if not pairs:
        return None
    return 100.0 * sum(pairs) / (_program.reads(ctx, by) * _slots(ctx))
