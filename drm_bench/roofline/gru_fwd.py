"""Work of the encoder (kernel #1, gru_fwd): the model's own matrix
products, counted once: two bidirectional GRU layers over 123 steps, each
step an input product (din x 3H) and a recurrent one (H x 3H) a direction;
din 64 in layer 1, 128 in layer 2, H 64.  247.6 GFLOP for 8,192 reads.
The bytes (tokens in, 128 fp32 out a read, the weights) are far below the
operations' time."""

from drm_bench.roofline import peaks

STEPS, HIDDEN, DIN = 123, 64, (64, 128)
KERNEL = "gru_fwd"


def flops_per_read() -> int:
    g = 3 * HIDDEN
    return sum(2 * STEPS * 2 * (din * g + HIDDEN * g) for din in DIN)


def least_s(reads: int) -> float:
    nbytes = reads * (STEPS * 2 + 128 * 4)
    return peaks.least_s(reads * flops_per_read(), peaks.TF32_FLOPS_S, nbytes)
