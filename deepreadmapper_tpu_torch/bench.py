"""Benchmark twin of the repository's ``bench.py``: ecoli_150 dense pipeline
end-to-end queries/s on one card.

    python -m deepreadmapper_tpu_torch.bench [--reps 100] [--device cpu]

Prints ONE JSON line with ``bench.py``'s keys: metric, value, unit,
vs_baseline, device_qps, qps_median, device_qps_median, e2e_trials_s,
device_trials_s, stage_s {upload, compute, fetch}.

The same work as ``bench.py``: the 1,702 windows of tests/data/ecoli_150.fna
embedded once as the index; the 150 fixture reads tiled ``reps`` times
(15,000 at the default) packed into the 48-byte wire on the host; on the
device the wire tokenizer, the bi-GRU (kernel #1 on a card), the exact L2
top-128 and the nibble id pack; the packed ids downloaded and unpacked on
the host.  Times are host clocks around ``torch.cuda.synchronize`` (or the
download that ends a pass).  vs_baseline is the ratio to the same fixed
nominal of 1000 q/s as ``bench.py``.  The card is used unless
device="cpu"; without one it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np
import torch

NOMINAL_BASELINE_QPS = 1000.0
METRIC = "ecoli150_dense_e2e_qps"
K = 128
# A run that has not answered in this long reports an error record instead
# of hanging (a card that does not come up, or a build that stalls).
_WATCHDOG_S = 600

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "tests", "data")


def _watchdog():
    print(json.dumps({
        "metric": METRIC, "value": 0.0, "unit": "queries/s", "vs_baseline": 0.0,
        "error": f"bench exceeded {_WATCHDOG_S}s: the CUDA device is unreachable "
                 "or degraded, or a kernel build stalled",
    }), flush=True)
    os._exit(2)


def bench(reps: int = 100, device=None, trials: int = 5) -> tuple[dict, np.ndarray]:
    """Run the benchmark; returns (the JSON record, the unpacked ids [Q, 128]
    of the last end-to-end pass)."""
    from deepreadmapper_tpu_torch import resolve_device
    from deepreadmapper_tpu_torch.io import fasta as fasta_io
    from deepreadmapper_tpu_torch.io.fastq import parse_fastq_bytes
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer
    from deepreadmapper_tpu_torch.ops.pack import bits_needed, pack_ids_device, unpack_ids_host
    from deepreadmapper_tpu_torch.ops.topk import l2_topk
    from deepreadmapper_tpu_torch.pipeline.build import embed_fasta_windows
    from deepreadmapper_tpu_torch.tokenizer_device import pack_wrapped

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # the index: the 1,702 genome windows, embedded once, on the device
    records = fasta_io.parse_fasta_records(os.path.join(_DATA, "ecoli_150.fna"))
    vec = Vectorizer(device_batch=4096, device=dev)
    ref = embed_fasta_windows(records, 150, 1, vec, device_out=True)
    assert ref.shape == (1702, 128)

    # the query stream: the fixture reads tiled to a steady-state batch
    mat, lengths, _ = parse_fastq_bytes(os.path.join(_DATA, "test_data.fastq"))
    mat = np.tile(mat, (reps, 1))
    lengths = np.tile(lengths, reps)
    nq = mat.shape[0]
    nbits = bits_needed(ref.shape[0])  # 12 bits an id for 1,702 vectors

    def fused(wire):
        emb = vec.encoder.encode_packed(wire)
        _, ids = l2_topk(emb, ref, K)
        return pack_ids_device(ids, nbits).reshape(-1)

    def run_once():
        wire = pack_wrapped(mat, lengths)
        out = fused(torch.from_numpy(wire).to(dev))
        ids = unpack_ids_host(out.cpu().numpy().reshape(nq, -1), K, nbits)
        assert ids.shape == (nq, K)
        return ids

    run_once()  # warm-up (kernel builds, allocator)
    e2e = []
    for _ in range(trials):
        t0 = time.perf_counter()
        ids = run_once()
        e2e.append(time.perf_counter() - t0)

    # device time: the same compute on a wire already uploaded
    wire_host = pack_wrapped(mat, lengths)
    wire_dev = torch.from_numpy(wire_host).to(dev)
    out = fused(wire_dev)
    sync()
    dev_times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        out = fused(wire_dev)
        sync()
        dev_times.append(time.perf_counter() - t0)

    # per-stage split: upload / device compute / download
    t0 = time.perf_counter()
    torch.from_numpy(wire_host).to(dev)
    sync()
    t_upload = time.perf_counter() - t0
    t0 = time.perf_counter()
    out.cpu()
    t_fetch = time.perf_counter() - t0

    qps = nq / min(e2e)
    record = {
        "metric": METRIC,
        "value": round(qps, 1),
        "unit": "queries/s",
        "vs_baseline": round(qps / NOMINAL_BASELINE_QPS, 3),
        "device_qps": round(nq / min(dev_times), 1),
        "qps_median": round(nq / float(np.median(e2e)), 1),
        "device_qps_median": round(nq / float(np.median(dev_times)), 1),
        "e2e_trials_s": [round(x, 3) for x in e2e],
        "device_trials_s": [round(x, 4) for x in dev_times],
        "stage_s": {
            "upload": round(t_upload, 3),
            "compute": round(float(np.median(dev_times)), 4),
            "fetch": round(t_fetch, 3),
        },
    }
    return record, ids


def main(reps: int = 100, device=None) -> int:
    """Print the benchmark's one JSON line; 0 on success."""
    t = threading.Timer(_WATCHDOG_S, _watchdog)
    t.daemon = True
    t.start()
    try:
        record, _ = bench(reps=reps, device=device)
    finally:
        t.cancel()  # a slow teardown must not print the watchdog's record too
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="python -m deepreadmapper_tpu_torch.bench")
    ap.add_argument("--reps", type=int, default=100,
                    help="times the 150 fixture reads are tiled (default 100)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: the CUDA device")
    a = ap.parse_args()
    sys.exit(main(reps=a.reps, device=a.device))
