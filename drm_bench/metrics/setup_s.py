"""Process start to the first timed request: imports, the genome and the
request pool, the index build, the warm-up."""


def read(ctx):
    return ctx.setup_s
