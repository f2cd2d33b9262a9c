"""Index build: ref input -> window stream -> 2-bit wire -> encoder ->
(int8 quantization or PQ encoding on the device) -> engine -> config.txt +
engine files.

Counterpart of ``deepreadmapper_tpu/pipeline/build.py`` for the FLAT,
INT8FLAT, PQFLAT, IVFINT8 and IVFPQ engines.  The on-disk result is the JAX package's:
either package loads an index the other built.
"""

from __future__ import annotations

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
from deepreadmapper_tpu_torch.io.readers import FASTA_EXTS, FASTQ_EXTS, read_txt
from deepreadmapper_tpu_torch.io.results import load_embeddings_npy
from deepreadmapper_tpu_torch.utils.memory import estimate_window_count
from deepreadmapper_tpu_torch.utils.progress import Progress
from deepreadmapper_tpu_torch import not_ported, resolve_device
from deepreadmapper_tpu_torch.index.flat import FlatIndex
from deepreadmapper_tpu_torch.index.int8_flat import Int8FlatIndex, quantize
from deepreadmapper_tpu_torch.index.ivf_int8 import IVFInt8Index
from deepreadmapper_tpu_torch.index.ivf_pq import IVFPQIndex
from deepreadmapper_tpu_torch.index.pq_flat import PQFlatIndex
from deepreadmapper_tpu_torch.models.encoder import OUT_SIZE, Vectorizer, load_params, named_leaves
from deepreadmapper_tpu_torch.ops import pq as pq_ops
from deepreadmapper_tpu_torch.tokenizer_device import pack_wrapped_numpy

PORTED_ENGINES = ("INT8FLAT", "FLAT", "PQFLAT", "IVFINT8", "IVFPQ")
_PQ_ENGINES = ("PQFLAT", "IVFPQ")
_INT8_ENGINES = ("INT8FLAT", "IVFINT8")
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
    emb = vectorizer.vectorize_wire(
        window_wire(rec, ref_len, stride, first, n), device_out=True
    )
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
                      vectorizer: Vectorizer):
    """Two-pass stream-encode of a FASTA reference for PQFLAT and IVFPQ.

    Pass A embeds an evenly spaced window sample (the reference trains on a
    50% evenly spaced sample; capped at 262,144 vectors, ample for 8 x 256
    centroids, so the [m, n_train, ksub] fp32 assignment tensor stays ~2 GB)
    and trains PQ or OPQ on the device.  Pass B re-streams every window and
    encodes each embedding chunk to codes on the device, so only the
    8 B/window codes reach the host.  Returns (codes [N, m] uint8,
    codebook, rotation or None)."""
    nv_est = sum(2 * fasta_io.num_windows(len(r), ref_len, stride) for r in records)
    target = max(1, min(int(nv_est * cfg.sample_rate), 262_144))
    # the sample counts both strands like nv_est; ceil so it never exceeds
    # ~target (floor could double it)
    step = max(1, -(-nv_est // target))
    train = embed_fasta_windows(records, ref_len, stride * step, vectorizer,
                                device_out=True)
    if train.shape[0] == 0:
        raise ValueError("No sequences found in the reference")
    rot = rot_dev = None
    if cfg.opq:
        cb, rot = pq_ops.train_opq(train, m=cfg.m_pq, nbits=cfg.nbits,
                                   iters=cfg.opq_iters, seed=cfg.seed,
                                   device=vectorizer.device)
        rot_dev = torch.from_numpy(rot).to(vectorizer.device)
    else:
        cb = pq_ops.train_pq(train, m=cfg.m_pq, nbits=cfg.nbits,
                             iters=cfg.kmeans_iters, seed=cfg.seed)
    del train
    codes = embed_fasta_windows(
        records, ref_len, stride, vectorizer,
        chunk_transform=lambda e: pq_ops.encode_device(e, cb, rot_dev),
    )
    return codes, cb, rot


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
) -> dict:
    """Build + persist an index directory; returns the saved config.
    device defaults to the CUDA device (raises without one).  timings, when
    a dict, gets the seconds of each build phase (embed, the IVF engines'
    kmeans / assign / split_pack, save).  weights: a fine-tuned encoder npz
    (``finetune`` output); the windows are embedded with it and it is
    copied to ``<prefix>/encoder.npz``, which the pipeline then loads for
    the queries.  vectorizer: an encoder already loaded (it must equal
    weights= when both are given)."""
    if index_type not in PORTED_ENGINES:
        raise not_ported(f"index type {index_type}")
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
        else:
            total = nv * OUT_SIZE * 4
            detail = f"fp32 vectors {total / 1e6:.1f}"
        print(f"[BUILD INDEX] ~{nv} vectors; estimated index memory "
              f"{total / 1e6:.1f} MB ({detail})")

    t0 = time.perf_counter()
    if index_type in _PQ_ENGINES and ext in FASTA_EXTS:
        records = fasta_io.parse_fasta_records(ref_file)
        codes, cb, rot = _pq_stream_encode(records, ref_len, stride, cfg, vectorizer)
        t["embed"] = time.perf_counter() - t0
        if codes.shape[0] == 0:
            raise ValueError(f"No sequences found in file: {ref_file}")
        if index_type == "IVFPQ":
            engine = IVFPQIndex.build_from_codes(codes, cb, cfg, rot=rot, device=device,
                                                 timings=t)
        else:
            engine = PQFlatIndex(codes, cb, codes.shape[0], rot, device)
        n_vects, dim = codes.shape[0], OUT_SIZE  # codes, not embeddings
    elif index_type in _INT8_ENGINES and ext in FASTA_EXTS:
        # Quantize every embedding chunk on the device before collection:
        # only the 128 B/window codes are downloaded.  Encoder outputs are
        # tanh-bounded, so the fixed 1/127 scale is what build() would derive.
        records = fasta_io.parse_fasta_records(ref_file)
        codes = embed_fasta_windows(
            records, ref_len, stride, vectorizer,
            chunk_transform=lambda e: quantize(e, INT8_SCALE),
        )
        t["embed"] = time.perf_counter() - t0
        if codes.shape[0] == 0:
            raise ValueError(f"No sequences found in file: {ref_file}")
        if index_type == "IVFINT8":
            engine = IVFInt8Index.build_from_codes(codes, INT8_SCALE, cfg, device=device,
                                                   timings=t)
        else:
            engine = Int8FlatIndex(codes, INT8_SCALE, codes.shape[0], device)
        n_vects, dim = codes.shape
    else:
        embeddings = embed_input_file(ref_file, ref_len, stride, vectorizer)
        t["embed"] = time.perf_counter() - t0
        if embeddings.shape[0] == 0:
            raise ValueError(f"No sequences found in file: {ref_file}")
        if index_type in ("PQFLAT", "IVFPQ", "IVFINT8"):
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
    t["save"] = time.perf_counter() - t0
    return config
