"""Port parity: the torch device tokenizer and the wire packer against the
JAX package, exact, on fixture reads and edge cases."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepreadmapper_tpu import native
from deepreadmapper_tpu import tokenizer as tok
from deepreadmapper_tpu import tokenizer_device as jtd
from deepreadmapper_tpu_torch import tokenizer_device as ttd
from jax_native_guard import _jax_native_loaded  # noqa: F401  (module fixture)


def _edge_reads():
    rng = np.random.default_rng(0)
    reads = ["".join(rng.choice(list("ACGT"), size=n)) for n in
             (1, 2, 3, 50, 119, 120, 121, 122, 123, 150, 300)]
    reads += ["ACGNNTTACGNA" * 10, "N" * 150, "NACGT", "acgtN" * 30]
    return [f"<{s}>" for s in reads] + ["<A>", "<>"]


def _wire(seqs):
    mat, lengths = tok.strings_to_bytes(seqs)
    return mat, lengths


@pytest.mark.parametrize("source", ["fixture", "edge"])
def test_tokens_from_packed_matches_jax(data_dir, source):
    if source == "fixture":
        from deepreadmapper_tpu.io.fastq import parse_fastq_bytes

        mat, lengths, _ = parse_fastq_bytes(str(data_dir / "test_data.fastq"))
    else:
        mat, lengths = _wire(_edge_reads())
    wire = ttd.pack_wrapped_numpy(mat, lengths)
    want = np.asarray(jtd.tokens_from_packed(jnp.asarray(wire)))
    got = ttd.tokens_from_packed(torch.as_tensor(wire, device="cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    # and both equal the host tokenizer on wrapped input
    np.testing.assert_array_equal(got, tok.tokenize_bytes(mat, lengths))


def test_pack_wrapped_numpy_matches_jax_and_native():
    mat, lengths = _wire(_edge_reads())
    got = ttd.pack_wrapped_numpy(mat, lengths)
    np.testing.assert_array_equal(got, jtd.pack_wrapped_numpy(mat, lengths))
    if native.available():
        np.testing.assert_array_equal(got, native.pack_wrapped(mat, lengths))
    np.testing.assert_array_equal(ttd.pack_wrapped(mat, lengths), got)
