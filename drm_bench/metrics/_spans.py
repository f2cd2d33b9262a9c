"""Sums over the window's completed requests, shared by the metric files."""


def reads(ctx) -> int:
    return sum(r["reads"] for r in ctx.replies if r["ok"])


def ms_per_kread(ctx, span: str):
    """A span of run_pipeline (t_embed, t_search or t_post: its host clock
    at layer boundaries, each ending in a host fetch), summed over the
    window's requests, in ms a 1,000 reads; None without a request."""
    n = reads(ctx)
    if not n:
        return None
    return 1e3 * sum(r[span] for r in ctx.replies if r["ok"]) / (n / 1e3)
