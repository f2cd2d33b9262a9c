"""The entry points of ``__graft_entry__.py``, on torch.

Counterpart of the repository's ``__graft_entry__.py`` (JAX), with its calls
and its asserts:

``entry(device=None)``
    -> (forward, (tokens,)): the bi-GRU read encoder under the shipped
    weights, on 256 x 123 tokens; ``forward(tokens)`` gives [256, 128] fp32
    embeddings.  On the card it runs the ``gru_fwd`` kernel.

``dryrun_multichip(n_devices, device=None)``
    builds an ('data', 'shard') grid for n devices, runs one data-parallel
    training step, the sharded search of every engine (exact FLAT,
    HNSWFLAT, HNSWPQ, INT8FLAT, IVFINT8, IVFPQ, PQFLAT + OPQ) against
    oracles, and a sharded FASTQ -> SAM pass, a paired pass and a long-read
    pass on the fixture; prints the JAX function's summary line and
    returns its readings.

The shards go round-robin over the visible cards (``parallel/mesh.py``), so
several shards may share one card; on the CPU every shard is on the CPU.
The training step runs over the ``torch.distributed`` group when one is up
(each rank its contiguous slice of the global batch), and in one process
otherwise; every rank runs the searches and the fixture passes itself.
Both functions run on the card unless the caller passes ``device``
(``"cpu"`` in the tests); without a card they raise.

    python -c "from deepreadmapper_tpu_torch import graft_entry as g; \\
               g.dryrun_multichip(4, device='cpu')"
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FIXTURE = os.path.join(_ROOT, "tests", "data")


def entry(device=None):
    """(forward, (tokens,)): the encoder forward under the shipped weights
    and 256 x 123 int32 tokens on the device (default: the card)."""
    from deepreadmapper_tpu_torch import resolve_device
    from deepreadmapper_tpu_torch.models.encoder import Encoder, load_params

    dev = resolve_device(device)
    encoder = Encoder(load_params()).to(dev)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(
        rng.integers(7542, 7638, size=(256, 123)).astype(np.int32)).to(dev)

    def forward(tokens):
        return encoder.encode_tokens(tokens)

    return forward, (tokens,)


def _shard_count(n_devices: int) -> int:
    """The widest shard axis the device count allows: 8, 4, 2, then 1."""
    if n_devices % 8 == 0 and n_devices >= 8:
        return 8
    if n_devices % 4 == 0 and n_devices >= 4:
        return 4
    if n_devices % 2 == 0:
        return 2
    return 1


def _train_step(n_devices: int, dev, rng) -> float:
    """One step at global batch 4 n on rng's reads and windows; over the
    group when one is up (this rank's contiguous slice)."""
    from deepreadmapper_tpu_torch.models.encoder import load_params, torch_params
    from deepreadmapper_tpu_torch.parallel import distributed as dist_
    from deepreadmapper_tpu_torch.parallel.train import make_optimizer, train_step

    params = torch_params(load_params(), dev, requires_grad=True)
    optimizer = make_optimizer(params)
    b = 4 * n_devices  # tiny per-device batch
    reads = rng.integers(7542, 7638, size=(b, 123)).astype(np.int32)
    wins = rng.integers(7542, 7638, size=(b, 123)).astype(np.int32)
    world, r = dist_.world_size(), dist_.rank()
    if b % world:
        raise ValueError(f"global batch {b} does not split over {world} ranks")
    lo, hi = r * b // world, (r + 1) * b // world
    loss = float(train_step(params, optimizer, torch.from_numpy(reads[lo:hi]).to(dev),
                            torch.from_numpy(wins[lo:hi]).to(dev)))
    assert np.isfinite(loss), f"non-finite training loss {loss}"
    return loss


def _search_checks(mesh, n_shard: int, rng) -> dict:
    """The sharded search of every engine against its oracle."""
    from deepreadmapper_tpu_torch.config import BuildConfig
    from deepreadmapper_tpu_torch.ops.topk import l2_topk
    from deepreadmapper_tpu_torch.parallel.sharded_ann import (
        ShardedANNIndex,
        compose_global_ids,
    )
    from deepreadmapper_tpu_torch.parallel.sharded_search import sharded_l2_topk

    # --- index-sharded exact search with a top-k merge ---
    n_rows = n_shard * 512  # enough rows a shard to train 256-centroid PQ
    q = rng.standard_normal((mesh.shape["data"] * 4, 128)).astype(np.float32)
    r = rng.standard_normal((n_rows, 128)).astype(np.float32)
    d, i = sharded_l2_topk(q, r, k=8, mesh=mesh)
    d, i = d.numpy(), i.numpy()
    assert d.shape == (q.shape[0], 8) and np.all(np.isfinite(d))
    d_ref, i_ref = l2_topk(q, r, 8, device=mesh.shard_device(0))
    i_ref = i_ref.cpu().numpy()
    np.testing.assert_allclose(d, d_ref.cpu().numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(i, i_ref)

    # --- graph engines sharded: HNSWFLAT + HNSWPQ (beam search + merge) ---
    idx = ShardedANNIndex.build(r, mesh, BuildConfig(m_hnsw=8), index_type="HNSWFLAT")
    ids, _ = idx.search(q, 4, ef=16)
    assert ids.shape == (q.shape[0], 4)
    assert ids.min() >= 0 and ids.max() < r.shape[0]
    idxpq = ShardedANNIndex.build(r, mesh, BuildConfig(m_hnsw=8, m_pq=8, nbits=8),
                                  index_type="HNSWPQ")
    idspq, _ = idxpq.search(q, 4, ef=16)
    assert idspq.shape == (q.shape[0], 4)
    assert idspq.min() >= 0 and idspq.max() < r.shape[0]

    # --- the production scan engine sharded (int8) ---
    idx8 = ShardedANNIndex.build(r, mesh, index_type="INT8FLAT")
    ids8, _ = idx8.search(q, 4)
    assert ids8.shape == (q.shape[0], 4)
    assert ids8.min() >= 0 and ids8.max() < r.shape[0]
    match = float(np.mean(ids8[:, 0] == i_ref[:, 0]))
    assert match >= 0.9, f"sharded INT8 top-1 vs oracle only {match:.2f}"

    # --- IVFINT8 sharded at full probe: an exhaustive int8 scan, so its
    # top-1 must match the int8 sharded engine's ---
    idxivf = ShardedANNIndex.build(r, mesh, BuildConfig(), index_type="IVFINT8")
    full_probe = max(s.centroids.shape[0] for s in idxivf.subs)
    idsivf, _ = idxivf.search(q, 4, ef=full_probe)
    assert idsivf.shape == (q.shape[0], 4)
    assert idsivf.min() >= 0 and idsivf.max() < r.shape[0]
    match_ivf = float(np.mean(idsivf[:, 0] == ids8[:, 0]))
    assert match_ivf >= 0.9, f"sharded IVF top-1 vs INT8FLAT only {match_ivf:.2f}"

    # --- IVFPQ sharded at full probe, against the merged per-shard oracle ---
    idxivfpq = ShardedANNIndex.build(r, mesh, BuildConfig(), index_type="IVFPQ")
    full_probe_pq = max(s.centroids.shape[0] for s in idxivfpq.subs)
    idsivfpq, _ = idxivfpq.search(q, 4, ef=full_probe_pq)
    assert idsivfpq.shape == (q.shape[0], 4)
    assert idsivfpq.min() >= 0 and idsivfpq.max() < r.shape[0]
    n_loc_pq = idxivfpq.n_local
    cand_i, cand_d = [], []
    for si, sub in enumerate(idxivfpq.subs):
        i_s, d_s = sub.search(q, 4, ef=full_probe_pq)
        cand_i.append(np.where(i_s >= 0, i_s + si * n_loc_pq, -1))
        cand_d.append(np.where(i_s >= 0, d_s, np.inf))
    cand_i = np.concatenate(cand_i, axis=1)
    cand_d = np.concatenate(cand_d, axis=1)
    order = np.argsort(cand_d, axis=1, kind="stable")[:, :1]
    want1 = np.take_along_axis(cand_i, order, axis=1)[:, 0]
    match_ivfpq = float(np.mean(idsivfpq[:, 0] == want1))
    assert match_ivfpq >= 0.9, f"sharded IVFPQ top-1 vs per-shard oracle only {match_ivfpq:.2f}"

    # --- PQFLAT + per-shard OPQ rotations, against the same engines
    # searched one by one (exact) and merged on the host ---
    idxp = ShardedANNIndex.build(r, mesh, BuildConfig(m_pq=8, nbits=8, opq=True),
                                 index_type="PQFLAT")
    assert all(s.rot is not None for s in idxp.subs), "OPQ rotation missing"
    k = 8
    idsp, _ = idxp.search(q, k)
    assert idsp.shape == (q.shape[0], k)
    assert idsp.min() >= 0 and idsp.max() < r.shape[0]
    per = idxp.n_local
    d_all, i_all = [], []
    for si, sub in enumerate(idxp.subs):
        il, dl = sub.search(q, k, exact=True)
        i_all.append(compose_global_ids(il.astype(np.int32),
                                        np.full_like(il, si, dtype=np.int32), per))
        d_all.append(dl)
    dm = np.concatenate(d_all, 1)
    im = np.concatenate(i_all, 1)
    order = np.argsort(dm, axis=1, kind="stable")[:, :k]
    im = np.take_along_axis(im, order, axis=1)
    top1 = float(np.mean(idsp[:, 0] == im[:, 0]))
    overlap = float(np.mean([len(set(idsp[row]) & set(im[row])) / k
                             for row in range(q.shape[0])]))
    assert top1 >= 0.9, f"sharded PQFLAT+OPQ top-1 vs per-shard oracle {top1}"
    assert overlap >= 0.9, f"sharded PQFLAT+OPQ top-{k} overlap {overlap}"
    return {"int8_top1": match, "ivfint8_top1": match_ivf, "ivfpq_top1": match_ivfpq,
            "pqflat_opq_top1": top1, "pqflat_opq_overlap": overlap}


def _fixture_passes(n_shard: int, dev) -> dict:
    """build-index --shards -> the pipeline (k 16), a paired pass and a
    long-read pass over the same sharded index, on the fixture."""
    from deepreadmapper_tpu_torch.io import fasta as fasta_io
    from deepreadmapper_tpu_torch.models.encoder import Vectorizer
    from deepreadmapper_tpu_torch.pipeline.build import build_index
    from deepreadmapper_tpu_torch.pipeline.search import run_pipeline, run_pipeline_paired

    ref = os.path.join(_FIXTURE, "ecoli_150.fna")
    fastq = os.path.join(_FIXTURE, "test_data.fastq")
    vec = Vectorizer(device_batch=2048, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "idx")
        build_index(ref, prefix, 150, stride=1, index_type="INT8FLAT", vectorizer=vec,
                    n_shards=n_shard, device=dev)
        out_dir = os.path.join(tmp, "out")
        run_pipeline(prefix, fastq, ref, k=16, output_dir=out_dir, vectorizer=vec,
                     device=dev)
        sam = os.path.join(out_dir, "results.sam")
        assert os.path.exists(sam), "sharded pipeline wrote no SAM"
        with open(sam) as f:
            n_lines = sum(1 for ln in f if not ln.startswith("@"))
        assert n_lines == 150 * 16, n_lines
        # wgsim-style read names encode the true position
        idx_np = np.load(os.path.join(out_dir, "indices.npy")).astype(np.int64)
        with open(fastq) as f:
            names = f.read().splitlines()[0::4]
        hits = sum(
            bool(np.any(np.abs((idx_np[row] // 2) - (int(nm.split("_")[1]) - 1)) <= 2))
            for row, nm in enumerate(names))
        assert hits >= 135, f"sharded e2e truth hits only {hits}/150"

        # --- paired ends over the same sharded index ---
        genome = fasta_io.parse_fasta_records(ref)[0].tobytes().decode()
        comp = str.maketrans("ACGT", "TGCA")
        isize, read_len = 400, 150
        f1 = os.path.join(tmp, "r1.fastq")
        f2 = os.path.join(tmp, "r2.fastq")
        with open(f1, "w") as a, open(f2, "w") as b:
            for i, s in enumerate((0, 100, 200, 400)):
                a.write(f"@q{i}\n{genome[s:s + read_len]}\n+\n{'I' * read_len}\n")
                m = genome[s + isize - read_len:s + isize].translate(comp)[::-1]
                b.write(f"@q{i}\n{m}\n+\n{'I' * read_len}\n")
        pres = run_pipeline_paired(prefix, f1, f2, ref, k=8, vectorizer=vec,
                                   output_dir=os.path.join(tmp, "pout"), device=dev)
        assert pres["n_proper"] == 4, pres["n_proper"]

        # --- long reads over the same sharded index: 600 bp reads chunk
        # into ~7 votes each; both strands chain to their planted starts ---
        flr = os.path.join(tmp, "lr.fastq")
        lr_starts, lr_strands, lr_len = (50, 300), (0, 1), 600
        with open(flr, "w") as f:
            for i, (s, st) in enumerate(zip(lr_starts, lr_strands)):
                seq = genome[s:s + lr_len]
                if st:
                    seq = seq.translate(comp)[::-1]
                f.write(f"@lr{i}\n{seq}\n+\n{'I' * lr_len}\n")
        lres = run_pipeline(prefix, flr, ref, k=4, vectorizer=vec, long_reads=True,
                            mapq=True, output_dir=os.path.join(tmp, "lrout"), device=dev)
        lids = np.asarray(lres["final_ids"]).astype(np.int64)
        for row, (s, st) in enumerate(zip(lr_starts, lr_strands)):
            got_s, got_r = int(lids[row, 0]) >> 1, int(lids[row, 0]) & 1
            assert abs(got_s - s) <= 5 and got_r == st, (
                f"sharded long-read {row}: got ({got_s},{got_r}), want ({s},{st})")
    return {"hits": hits, "n_proper": pres["n_proper"], "long_reads_placed": len(lr_starts)}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The JAX dry run's calls and asserts on an n-device grid of torch
    devices (several shards may share one).  Returns its readings: the
    grid, the training loss, the search top-1s, the truth hits and the
    proper pairs."""
    from deepreadmapper_tpu_torch.parallel.mesh import make_mesh

    n_shard = _shard_count(n_devices)
    # no device: every visible card (make_mesh raises without one)
    mesh = make_mesh(n_data=n_devices // n_shard, n_shard=n_shard,
                     devices=None if device is None else [device])
    dev = mesh.shard_device(0)
    rng = np.random.default_rng(0)
    loss = _train_step(n_devices, dev, rng)
    readings = {"n_devices": n_devices, "n_data": mesh.shape["data"], "n_shard": n_shard,
                "devices": sorted({str(d) for d in mesh.devices.ravel()}), "loss": loss,
                **_search_checks(mesh, n_shard, rng), **_fixture_passes(n_shard, dev)}
    print(
        f"dryrun_multichip({n_devices}): mesh data={mesh.shape['data']} x "
        f"shard={n_shard}; train loss {loss:.4f}; sharded exact + "
        f"HNSWFLAT + HNSWPQ + INT8FLAT + IVFINT8 + IVFPQ + PQFLAT/OPQ "
        f"verified vs oracles; sharded FASTQ->SAM e2e {readings['hits']}/150 truth "
        f"hits; paired 4/4 proper + long-read chunk->chain 2/2 over the sharded index")
    return readings
