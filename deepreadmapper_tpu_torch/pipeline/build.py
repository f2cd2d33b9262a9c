"""Index build: ref input -> window stream -> 2-bit wire -> encoder ->
(int8 quantization or PQ encoding on the device) -> engine -> config.txt +
engine files.

Counterpart of ``deepreadmapper_tpu/pipeline/build.py`` for the FLAT,
INT8FLAT, PQFLAT, IVFINT8, IVFPQ, HNSWPQ and HNSWFLAT engines.  The on-disk
result is the JAX package's: either package loads an index the other built.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from deepreadmapper_tpu_torch import native
from deepreadmapper_tpu_torch import tokenizer as tok
from deepreadmapper_tpu_torch.config import BuildConfig
from deepreadmapper_tpu_torch.io import fasta as fasta_io
from deepreadmapper_tpu_torch.io.configstore import save_config
from deepreadmapper_tpu_torch.io.fastq import parse_fastq_bytes
from deepreadmapper_tpu_torch.io.fileio import true_ext
from deepreadmapper_tpu_torch.io.npy_stream import NpyStreamWriter
from deepreadmapper_tpu_torch.io.readers import FASTA_EXTS, FASTQ_EXTS, read_txt
from deepreadmapper_tpu_torch.io.results import load_embeddings_npy
from deepreadmapper_tpu_torch.utils.memory import estimate_index_memory, estimate_window_count
from deepreadmapper_tpu_torch.utils.progress import Progress
from deepreadmapper_tpu_torch import resolve_device
from deepreadmapper_tpu_torch.index.flat import FlatIndex
from deepreadmapper_tpu_torch.index.hnsw import HNSWFlatIndex, HNSWPQIndex
from deepreadmapper_tpu_torch.index.int8_flat import Int8FlatIndex, quantize
from deepreadmapper_tpu_torch.index.ivf_int8 import IVFInt8Index
from deepreadmapper_tpu_torch.index.ivf_pq import IVFPQIndex
from deepreadmapper_tpu_torch.index.pq_flat import PQFlatIndex
from deepreadmapper_tpu_torch.index.registry import engine_class
from deepreadmapper_tpu_torch.models.encoder import OUT_SIZE, Vectorizer, load_params, named_leaves
from deepreadmapper_tpu_torch.ops import pq as pq_ops
from deepreadmapper_tpu_torch.parallel import distributed as dist_
from deepreadmapper_tpu_torch.parallel.mesh import make_mesh
from deepreadmapper_tpu_torch.parallel.sharded_ann import ShardedANNIndex, split_shard_rows
from deepreadmapper_tpu_torch.tokenizer_device import pack_wrapped_numpy

_PQ_ENGINES = ("PQFLAT", "IVFPQ")
_INT8_ENGINES = ("INT8FLAT", "IVFINT8")
_HNSW_ENGINES = ("HNSWPQ", "HNSWFLAT")
INT8_SCALE = 1.0 / 127.0  # encoder outputs are tanh-bounded in [-1, 1]


def _resolve_weights(weights: str | None, vectorizer: Vectorizer | None,
                     device: torch.device) -> Vectorizer:
    """Resolve the (weights=, vectorizer=) pair of a build; counterpart of
    build._resolve_weights.  Both are allowed only when they agree EXACTLY
    (a mismatched pair would embed windows with one encoder while recording
    another for query time; near-identical fine-tunes are still different
    encoders)."""
    if weights is None:
        return vectorizer or Vectorizer(device=device)
    tuned = load_params(weights)
    if vectorizer is None:
        return Vectorizer(tuned, device=device)
    pairs = zip(named_leaves(vectorizer.encoder.params()), named_leaves(tuned))
    if not all(np.array_equal(a.cpu().numpy(), b) for (_, a), (_, b) in pairs):
        raise ValueError(
            "vectorizer= params do not match weights= — pass one, "
            "or load the vectorizer from the same npz"
        )
    return vectorizer


def window_wire(rec: np.ndarray, ref_len: int, stride: int, first: int,
                n: int) -> np.ndarray:
    """Interleaved (fwd, revcomp) wire rows [2n, 48] for windows
    [first, first+n) of one record: the native fused packer when the
    library builds, else numpy windowing + pack_wrapped_numpy."""
    if native.available():
        return native.pack_windows(rec, ref_len, stride, first, n)
    positions = (first + np.arange(n, dtype=np.int64)) * stride
    mat, lengths = fasta_io.window_byte_matrix(rec, positions, ref_len, tok.MAX_LEN)
    return pack_wrapped_numpy(mat, lengths)


def _embed_record_windows(rec, ref_len: int, stride: int, first: int, n: int,
                          vectorizer: Vectorizer, transform=None,
                          device_out: bool = False):
    """Embed windows [first, first+n) of ONE record -> [2n, 128]
    (interleaved fwd/rev, row = 2*window + strand).  transform (e.g. int8
    quantization) applies on the device before any download."""
    if vectorizer.max_len == tok.MAX_LEN:
        emb = vectorizer.vectorize_wire(
            window_wire(rec, ref_len, stride, first, n), device_out=True
        )
    else:  # the wire holds MAX_LEN tokens: other lengths tokenize on the host
        if native.available():
            tokens = native.tokenize_windows(rec, ref_len, stride, first, n,
                                             vectorizer.max_len)
        else:
            positions = (first + np.arange(n, dtype=np.int64)) * stride
            mat, lengths = fasta_io.window_byte_matrix(rec, positions, ref_len,
                                                       vectorizer.max_len)
            tokens = tok.tokenize_bytes(mat, lengths, vectorizer.max_len)
        emb = vectorizer.vectorize_tokens(tokens, device_out=True)
    if transform is not None:
        emb = transform(emb)
    return emb if device_out else emb.cpu().numpy()


def embed_fasta_windows(
    records: list[np.ndarray],
    ref_len: int,
    stride: int,
    vectorizer: Vectorizer,
    window_chunk: int = 65536,
    device_out: bool = False,
    chunk_transform=None,
):
    """Embed every (fwd, revcomp) window of every record, streamed in chunks
    so genome-scale inputs never materialize all window bytes at once.
    device_out=True returns a tensor on the vectorizer's device;
    chunk_transform applies to each device chunk before collection."""
    outs = []
    total = 2 * sum(fasta_io.num_windows(len(r), ref_len, stride) for r in records)
    with Progress(total, "[BUILD] embed windows") as prog:
        for rec in records:
            nw = fasta_io.num_windows(len(rec), ref_len, stride)
            for start in range(0, nw, window_chunk):
                n = min(window_chunk, nw - start)
                outs.append(
                    _embed_record_windows(
                        rec, ref_len, stride, start, n, vectorizer,
                        transform=chunk_transform, device_out=True,
                    )
                )
                prog.update(2 * n)
    if outs:
        out = torch.cat(outs) if len(outs) > 1 else outs[0]
    else:
        out = torch.zeros((0, OUT_SIZE), dtype=torch.float32,
                          device=vectorizer.device)
        if chunk_transform is not None:
            out = chunk_transform(out)
    return out if device_out else out.cpu().numpy()


def stream_codes_resumable(
    records: list[np.ndarray],
    ref_len: int,
    stride: int,
    vectorizer: Vectorizer,
    transform,
    cache_path: str,
    n_cols: int,
    dtype: str,
    window_chunk: int = 65536,
) -> np.ndarray:
    """Embed every (fwd, rev) window, appending each chunk, transformed on
    the device (quantized or PQ-encoded), to a resumable npy on disk; chunks
    already there are skipped without an embed.  The chunk grid is fixed
    (record order x window_chunk), so after a crash the stream truncates
    back to the last whole chunk and goes on from there.  Returns the code
    matrix, memory-mapped copy-on-write.  Counterpart of build.stream_codes_resumable."""
    total = 2 * sum(fasta_io.num_windows(len(r), ref_len, stride) for r in records)
    w = NpyStreamWriter.resume(cache_path, total, n_cols, dtype)
    if w.rows_written:
        print(f"[BUILD INDEX] resuming embed stream: {w.rows_written}/{total} "
              "rows already on disk")
    cursor = 0
    with Progress(total, "[BUILD] embed windows") as prog:
        for rec in records:
            nw = fasta_io.num_windows(len(rec), ref_len, stride)
            for start in range(0, nw, window_chunk):
                n = min(window_chunk, nw - start)
                if w.rows_written >= cursor + 2 * n:
                    cursor += 2 * n  # chunk fully on disk from an earlier run
                    prog.update(2 * n)
                    continue
                if w.rows_written > cursor:
                    w.truncate_to(cursor)  # half-written chunk: redo it
                w.append(_embed_record_windows(rec, ref_len, stride, start, n,
                                               vectorizer, transform=transform))
                cursor += 2 * n
                prog.update(2 * n)
    w.close()
    # copy-on-write: writable for torch.from_numpy, the file never changes
    return np.load(cache_path, mmap_mode="c")


def _resume_cache(index_prefix: str, params: dict, resume: bool):
    """Open (or validate) the crash-resume cache of a streaming build: the
    cache dir, or None when resume is off.  Its state file pins every
    parameter that shapes the embed stream; a mismatch means the partial
    codes on disk describe another index, so the build is refused."""
    if not resume:
        return None
    cache = os.path.join(index_prefix, ".build_cache")
    os.makedirs(cache, exist_ok=True)
    state_path = os.path.join(cache, "state.json")
    if os.path.exists(state_path):
        with open(state_path) as f:
            old = json.load(f)
        if old != params:
            raise ValueError(
                f"--resume: cached build state {old} does not match "
                f"requested {params}; delete {cache} to restart"
            )
    else:
        with open(state_path, "w") as f:
            json.dump(params, f)
    return cache


def _drop_cache(cache) -> None:
    """Remove the resume cache once the index is saved (an open mmap of its
    codes stays valid)."""
    if cache:
        shutil.rmtree(cache, ignore_errors=True)


def stream_embed_fasta_to_npy(fasta_path: str, out_path: str, ref_len: int,
                              stride: int, vectorizer: Vectorizer,
                              window_chunk: int = 65536) -> int:
    """Embed every window of a FASTA straight into a pre-headered npy, a
    chunk at a time (the ``inference`` subcommand): memory stays bounded
    whatever the genome's size.  Returns the rows written."""
    records = fasta_io.parse_fasta_records(fasta_path)
    total = sum(2 * fasta_io.num_windows(len(r), ref_len, stride) for r in records)
    with NpyStreamWriter(out_path, total, OUT_SIZE) as w, \
            Progress(total, "[INFERENCE] embed windows") as prog:
        for rec in records:
            nw = fasta_io.num_windows(len(rec), ref_len, stride)
            for start in range(0, nw, window_chunk):
                n = min(window_chunk, nw - start)
                w.append(_embed_record_windows(rec, ref_len, stride, start, n,
                                               vectorizer))
                prog.update(2 * n)
    return total


def stream_embed_seqs_to_npy(path: str, out_path: str, vectorizer: Vectorizer,
                             batch: int = 65536) -> int:
    """Embed a sequence file (FASTQ or txt: one embedding per read) in
    batches of ``batch`` straight into a pre-headered npy (the
    ``inference`` subcommand's batch_size).  Returns the rows written."""
    if true_ext(path) in FASTQ_EXTS:
        mat, lengths, _ = parse_fastq_bytes(path)

        def embed_slice(s, e):
            return vectorizer.vectorize_wrapped_bytes(mat[s:e], lengths[s:e])

        total = mat.shape[0]
    else:
        seqs = read_txt(path)

        def embed_slice(s, e):
            return vectorizer.vectorize(seqs[s:e])

        total = len(seqs)
    with NpyStreamWriter(out_path, total, OUT_SIZE) as w, \
            Progress(total, "[INFERENCE] embed reads") as prog:
        for s in range(0, total, batch):
            e = min(s + batch, total)
            w.append(embed_slice(s, e))
            prog.update(e - s)
    return total


def embed_input_file(path: str, ref_len: int, stride: int,
                     vectorizer: Vectorizer) -> np.ndarray:
    """Embeddings of a reference input: .npy as is, FASTA windows, or one
    embedding per FASTQ / txt sequence."""
    ext = true_ext(path)
    if ext == ".npy":
        return load_embeddings_npy(path)
    if ext in FASTA_EXTS:
        records = fasta_io.parse_fasta_records(path)
        return embed_fasta_windows(records, ref_len, stride, vectorizer)
    if ext in FASTQ_EXTS:
        mat, lengths, _ = parse_fastq_bytes(path)
        return vectorizer.vectorize_wrapped_bytes(mat, lengths)
    if ext == ".txt":
        return vectorizer.vectorize(read_txt(path))
    raise ValueError(f"Unsupported reference input: {path}")


def _pq_stream_encode(records, ref_len: int, stride: int, cfg: BuildConfig,
                      vectorizer: Vectorizer, cache: str | None = None):
    """Two-pass stream-encode of a FASTA reference for PQFLAT and IVFPQ.

    Pass A embeds an evenly spaced window sample (the reference trains on a
    50% evenly spaced sample; capped at 262,144 vectors, ample for 8 x 256
    centroids, so the [m, n_train, ksub] fp32 assignment tensor stays ~2 GB)
    and trains PQ or OPQ on the device.  Pass B re-streams every window and
    encodes each embedding chunk to codes on the device, so only the
    8 B/window codes reach the host.  With a resume cache, the trained
    codebook is saved there and reused by a rerun, and pass B streams into
    the cache.  Returns (codes [N, m] uint8, codebook, rotation or None)."""
    cb_path = cache and os.path.join(cache, "codebook.npz")
    if cb_path and os.path.exists(cb_path):
        # pass A ran before the crash: reuse its codebook
        with np.load(cb_path) as z:
            cb = pq_ops.PQCodebook(torch.from_numpy(z["centroids"]).to(vectorizer.device))
            rot = z["rot"] if "rot" in z.files else None
        print("[BUILD INDEX] resume: reusing trained PQ codebook")
    else:
        nv_est = sum(2 * fasta_io.num_windows(len(r), ref_len, stride) for r in records)
        target = max(1, min(int(nv_est * cfg.sample_rate), 262_144))
        # the sample counts both strands like nv_est; ceil so it never
        # exceeds ~target (floor could double it)
        step = max(1, -(-nv_est // target))
        train = embed_fasta_windows(records, ref_len, stride * step, vectorizer,
                                    device_out=True)
        if train.shape[0] == 0:
            raise ValueError("No sequences found in the reference")
        rot = None
        if cfg.opq:
            cb, rot = pq_ops.train_opq(train, m=cfg.m_pq, nbits=cfg.nbits,
                                       iters=cfg.opq_iters, seed=cfg.seed,
                                       device=vectorizer.device)
        else:
            cb = pq_ops.train_pq(train, m=cfg.m_pq, nbits=cfg.nbits,
                                 iters=cfg.kmeans_iters, seed=cfg.seed)
        del train
        if cb_path:
            extra = {} if rot is None else {"rot": np.asarray(rot)}
            np.savez(cb_path, centroids=cb.centroids.cpu().numpy(), **extra)
    rot_dev = None if rot is None else torch.from_numpy(rot).to(vectorizer.device)

    def encode(e):
        return pq_ops.encode_device(e, cb, rot_dev)

    if cache:
        codes = stream_codes_resumable(records, ref_len, stride, vectorizer, encode,
                                       os.path.join(cache, "codes.npy"), cfg.m_pq, "|u1")
    else:
        codes = embed_fasta_windows(records, ref_len, stride, vectorizer,
                                    chunk_transform=encode)
    return codes, cb, rot


def _sharded_or_one(rows: np.ndarray, n_shards: int, index_type: str, device,
                    timings: dict, make_sub):
    """make_sub(rows, timings) over all the rows, or with n_shards > 1 over
    each shard's rows (split_shard_rows) into a ShardedANNIndex; the
    shards' build timings add up."""
    if n_shards <= 1:
        return make_sub(rows, timings)
    subs = []
    for part in split_shard_rows(rows, n_shards):
        tm = {}
        subs.append(make_sub(part, tm))
        for key, val in tm.items():
            timings[key] = timings.get(key, 0.0) + val
    return ShardedANNIndex(subs, make_mesh(n_shard=n_shards, devices=[device]),
                           rows.shape[0], index_type)


def build_index(
    ref_file: str,
    index_prefix: str,
    ref_len: int,
    stride: int = 1,
    index_type: str = "INT8FLAT",
    build_cfg: BuildConfig | None = None,
    device: torch.device | str | None = None,
    timings: dict | None = None,
    weights: str | None = None,
    vectorizer: Vectorizer | None = None,
    resume: bool = False,
    n_shards: int = 1,
) -> dict:
    """Build + persist an index directory; returns the saved config.
    device defaults to the CUDA device (raises without one).  timings, when
    a dict, gets the seconds of each build phase (embed, the IVF engines'
    kmeans / assign / split_pack, the HNSW engines' graph and pq and the
    kNN build's levels / exact_knn / prune / reverse_rank / upper_levels,
    save).  build_cfg.build_mode (insert | knn) and build_cfg.level_mode
    (rng | centroid) choose the HNSW graph builder and level assignment.
    weights: a fine-tuned encoder npz
    (``finetune`` output); the windows are embedded with it and it is
    copied to ``<prefix>/encoder.npz``, which the pipeline then loads for
    the queries.  vectorizer: an encoder already loaded (it must equal
    weights= when both are given).  resume=True makes the streaming builds
    from FASTA (INT8FLAT, IVFINT8, PQFLAT, IVFPQ) crash-resumable: the code
    chunks append to ``<prefix>/.build_cache/`` as they leave the device,
    and a rerun with the same arguments skips what is already there.
    n_shards > 1 writes a sharded index (``parallel/sharded_ann.py``:
    ``shard_i/`` directories + ``sharded.txt``) with the JAX package's
    conventions: the rows pad by repeating the last one to a shard
    multiple; streamed INT8FLAT / IVFINT8 shards share the fixed int8
    scale, streamed PQFLAT / IVFPQ shards one PQ codebook (and OPQ
    rotation), IVF shards have their own coarse quantizers, and shards of
    embeddings (FLAT, HNSW, non-FASTA inputs) are built apart."""
    engine_class(index_type)  # an unknown index type raises here, before any work
    device = resolve_device(device)
    t = timings if timings is not None else {}
    cfg = build_cfg or BuildConfig(stride=stride)
    if cfg.opq and index_type not in _PQ_ENGINES:
        print(f"[BUILD INDEX] WARNING: --opq only applies to PQFLAT/IVFPQ; "
              f"ignored for {index_type}")
    vectorizer = _resolve_weights(weights, vectorizer, device)
    ext = true_ext(ref_file)
    if ext in FASTA_EXTS:
        nv = estimate_window_count(ref_file, ref_len, stride)  # both strands
        if index_type == "PQFLAT":
            total = nv * cfg.m_pq + (1 << cfg.nbits) * OUT_SIZE * 4
            detail = f"pq codes {nv * cfg.m_pq / 1e6:.1f}"
        elif index_type == "INT8FLAT":
            total = nv * OUT_SIZE
            detail = f"int8 codes {total / 1e6:.1f}"
        elif index_type == "IVFINT8":
            total = int(nv * OUT_SIZE / 0.8)  # slab fill ~0.8 (the JAX package's)
            detail = f"int8 slabs {total / 1e6:.1f}"
        elif index_type == "IVFPQ":
            # packed codes + fp32 recon norms, over the ~0.8 slab fill
            total = int(nv * (cfg.m_pq + 4) / 0.8)
            detail = f"pq slabs {total / 1e6:.1f}"
        elif index_type in _HNSW_ENGINES:  # PQ codes or fp32 vectors + graph
            est = estimate_index_memory(nv, m_pq=cfg.m_pq, nbits=cfg.nbits,
                                        m_hnsw=cfg.m_hnsw,
                                        n_train=int(nv * cfg.sample_rate))
            total = est["total"]
            if index_type == "HNSWFLAT":
                total += nv * OUT_SIZE * 4 - est["pq_codes"]
            detail = f"graph {est['hnsw_graph'] / 1e6:.1f}"
        else:
            total = nv * OUT_SIZE * 4
            detail = f"fp32 vectors {total / 1e6:.1f}"
        print(f"[BUILD INDEX] ~{nv} vectors; estimated index memory "
              f"{total / 1e6:.1f} MB ({detail})")

    cache = _resume_cache(
        index_prefix,
        {"ref_file": os.path.abspath(ref_file), "ref_len": ref_len, "stride": stride,
         "index_type": index_type, "m_pq": cfg.m_pq, "nbits": cfg.nbits,
         "opq": bool(cfg.opq and index_type in _PQ_ENGINES), "seed": cfg.seed},
        resume and ext in FASTA_EXTS and index_type in _PQ_ENGINES + _INT8_ENGINES,
    )
    t0 = time.perf_counter()
    if index_type in _PQ_ENGINES and ext in FASTA_EXTS:
        records = fasta_io.parse_fasta_records(ref_file)
        codes, cb, rot = _pq_stream_encode(records, ref_len, stride, cfg, vectorizer,
                                           cache)
        t["embed"] = time.perf_counter() - t0
        if codes.shape[0] == 0:
            raise ValueError(f"No sequences found in file: {ref_file}")
        if index_type == "IVFPQ":
            engine = _sharded_or_one(
                codes, n_shards, "IVFPQ", device, t,
                lambda c, tm: IVFPQIndex.build_from_codes(c, cb, cfg, rot=rot,
                                                          device=device, timings=tm))
        else:
            engine = _sharded_or_one(
                codes, n_shards, "PQFLAT", device, t,
                lambda c, tm: PQFlatIndex(c, cb, c.shape[0], rot, device))
        n_vects, dim = codes.shape[0], OUT_SIZE  # codes, not embeddings
    elif index_type in _INT8_ENGINES and ext in FASTA_EXTS:
        # Quantize every embedding chunk on the device before collection:
        # only the 128 B/window codes are downloaded.  Encoder outputs are
        # tanh-bounded, so the fixed 1/127 scale is what build() would derive.
        records = fasta_io.parse_fasta_records(ref_file)
        if cache:
            codes = stream_codes_resumable(
                records, ref_len, stride, vectorizer,
                lambda e: quantize(e, INT8_SCALE),
                os.path.join(cache, "codes.npy"), OUT_SIZE, "|i1",
            )
        else:
            codes = embed_fasta_windows(
                records, ref_len, stride, vectorizer,
                chunk_transform=lambda e: quantize(e, INT8_SCALE),
            )
        t["embed"] = time.perf_counter() - t0
        if codes.shape[0] == 0:
            raise ValueError(f"No sequences found in file: {ref_file}")
        if index_type == "IVFINT8":
            engine = _sharded_or_one(
                codes, n_shards, "IVFINT8", device, t,
                lambda c, tm: IVFInt8Index.build_from_codes(c, INT8_SCALE, cfg,
                                                            device=device, timings=tm))
        else:
            engine = _sharded_or_one(
                codes, n_shards, "INT8FLAT", device, t,
                lambda c, tm: Int8FlatIndex(c, INT8_SCALE, c.shape[0], device))
        n_vects, dim = codes.shape
    else:
        embeddings = embed_input_file(ref_file, ref_len, stride, vectorizer)
        t["embed"] = time.perf_counter() - t0
        if embeddings.shape[0] == 0:
            raise ValueError(f"No sequences found in file: {ref_file}")
        if n_shards > 1:
            engine = ShardedANNIndex.build(embeddings, make_mesh(n_shard=n_shards,
                                                                 devices=[device]),
                                           cfg, index_type)
        elif index_type in _HNSW_ENGINES:
            cls = HNSWPQIndex if index_type == "HNSWPQ" else HNSWFlatIndex
            engine = cls.build(embeddings, cfg, device, timings=t)
        elif index_type in ("PQFLAT", "IVFPQ", "IVFINT8"):
            cls = {"PQFLAT": PQFlatIndex, "IVFPQ": IVFPQIndex,
                   "IVFINT8": IVFInt8Index}[index_type]
            engine = cls.build(embeddings, cfg, device)
        else:
            cls = Int8FlatIndex if index_type == "INT8FLAT" else FlatIndex
            engine = cls.build(embeddings, device)
        n_vects, dim = embeddings.shape

    basename = os.path.basename(os.path.normpath(index_prefix))
    config = {
        "index_type": index_type,
        "stride": stride,
        "ref_len": ref_len,
        "n_vects": int(n_vects),
        "dim": int(dim),
        "M_hnsw": cfg.m_hnsw,
        "EFC": cfg.efc,
        "M_pq": cfg.m_pq,
        "nbits": cfg.nbits,
        "index_file": os.path.join(index_prefix, basename + ".index"),
    }
    if weights is not None:
        config["weights"] = "encoder.npz"
    t0 = time.perf_counter()
    os.makedirs(index_prefix, exist_ok=True)
    if weights is not None:
        shutil.copyfile(weights, os.path.join(index_prefix, "encoder.npz"))
    engine.save(index_prefix)
    save_config(config, index_prefix)  # last: config.txt marks a complete build
    _drop_cache(cache)
    t["save"] = time.perf_counter() - t0
    return config


def make_fasta_embed_rows(fasta_path: str, ref_len: int, stride: int,
                          vectorizer: Vectorizer, window_chunk: int = 65536,
                          transform=None):
    """embed_rows(start, end) for per-process builds
    (``parallel.distributed.build_own_shards``): embeds exactly the global
    VECTOR-row range [start, end) of the FASTA's interleaved (fwd, rev)
    window stream, record-aware, so a process reads only the genome bytes
    its shards cover.  transform applies on the device before the download
    (int8 quantization ships 128 B a row).  embed_rows.n_vectors is the row
    count.  Counterpart of build.make_fasta_embed_rows."""
    records = fasta_io.parse_fasta_records(fasta_path)
    nwins = [fasta_io.num_windows(len(r), ref_len, stride) for r in records]
    bounds = np.concatenate([[0], np.cumsum([2 * n for n in nwins])]).astype(np.int64)

    def embed_rows(start: int, end: int) -> np.ndarray:
        outs = []
        for ri, rec in enumerate(records):
            lo = int(max(start, bounds[ri]))
            hi = int(min(end, bounds[ri + 1]))
            if lo >= hi:
                continue
            # covering window range (rows are 2*window + strand)
            rlo, rhi = lo - int(bounds[ri]), hi - int(bounds[ri])
            w0, w1 = rlo // 2, (rhi + 1) // 2
            parts = [
                _embed_record_windows(rec, ref_len, stride, ws,
                                      min(window_chunk, w1 - ws), vectorizer,
                                      transform=transform)
                for ws in range(w0, w1, window_chunk)
            ]
            emb = parts[0] if len(parts) == 1 else np.concatenate(parts)
            outs.append(emb[rlo - 2 * w0: rhi - 2 * w0])
        if not outs:
            return np.zeros((0, OUT_SIZE), np.int8 if transform is not None else np.float32)
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    embed_rows.n_vectors = int(bounds[-1])
    return embed_rows


def build_index_distributed(
    ref_file: str,
    index_prefix: str,
    ref_len: int,
    stride: int = 1,
    index_type: str = "INT8FLAT",
    build_cfg: BuildConfig | None = None,
    vectorizer: Vectorizer | None = None,
    n_shards: int = 1,
    weights: str | None = None,
    device: torch.device | str | None = None,
) -> dict:
    """Per-process sharded build: every rank of the group embeds and
    persists ONLY its own shards (its slice of the genome's window rows);
    rank 0 writes the manifest and config.txt, and every rank waits for
    the others before it returns, so the index is whole on return.  One
    process builds every shard -- the layout of build_index(n_shards=...).
    INT8FLAT / IVFINT8 shards take the fixed int8 scale (quantized on the
    device); the other engines build each shard apart (PQ: a codebook per
    shard), as in the JAX package."""
    engine_class(index_type)  # an unknown index type raises here, before any work
    device = resolve_device(device)
    cfg = build_cfg or BuildConfig()
    vectorizer = _resolve_weights(weights, vectorizer, device)
    codes_scale = transform = None
    if index_type in _INT8_ENGINES:
        codes_scale = INT8_SCALE
        transform = lambda e: quantize(e, INT8_SCALE)  # noqa: E731
    embed_rows = make_fasta_embed_rows(ref_file, ref_len, stride, vectorizer,
                                       transform=transform)
    n_vectors = embed_rows.n_vectors
    dist_.build_own_shards(embed_rows, n_vectors, n_shards, index_prefix, cfg=cfg,
                           index_type=index_type, codes_scale=codes_scale, device=device)
    config = {
        "index_type": index_type,
        "stride": stride,
        "ref_len": ref_len,
        "n_vects": n_vectors,
        "dim": OUT_SIZE,
        "M_hnsw": cfg.m_hnsw,
        "EFC": cfg.efc,
        "M_pq": cfg.m_pq,
        "nbits": cfg.nbits,
        "index_file": "sharded",
    }
    if weights is not None:
        config["weights"] = "encoder.npz"
    if dist_.is_main():
        if weights is not None:
            os.makedirs(index_prefix, exist_ok=True)
            shutil.copyfile(weights, os.path.join(index_prefix, "encoder.npz"))
        save_config(config, index_prefix)
    dist_.barrier()
    return config
