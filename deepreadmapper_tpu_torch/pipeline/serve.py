"""Serving daemon: one resident index and encoder, many mapping requests.

Counterpart of ``deepreadmapper_tpu/pipeline/serve.py``, with its protocol.
``serve`` loads the engine and the index-matched encoder once (on the card
unless device="cpu"), then answers requests over line-delimited JSON on
stdin/stdout, so a warm request pays for its embed, search and SAM only.

Protocol (one JSON object per line):

  request:  {"fastq": "/path/reads.fastq", "output_dir": "/path/out",
             "id": "r1",                       # optional echo tag
             "ef": 128, "k": 128, "k_clusters": 5,   # optional overrides
             "rerank": "l2", "dense_rerank": false,
             "cigar": false, "mapq": false, "write_sam": true, ...,
             "search_stats": false}   # true -> effort counters in the
                                      # response (IVF engines)
  response: {"id": "r1", "ok": true, "num_queries": 150,
             "t_embed": ..., "t_search": ..., "t_post": ...}
  error:    {"id": "r1", "ok": false, "error": "..."}   (daemon stays up)
  shutdown: {"cmd": "quit"}  ->  {"ok": true, "quit": true}

Paired-end requests ("fastq2") and "long_reads" are not ported yet: they
get an error reply naming ROADMAP.md, and the daemon stays up.  Anything
the pipeline prints goes to stderr while serving, so the protocol stream
stays parseable.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

from deepreadmapper_tpu_torch import not_ported, resolve_device
from deepreadmapper_tpu_torch.config import SearchConfig
from deepreadmapper_tpu_torch.index.registry import load_index
from deepreadmapper_tpu_torch.pipeline.search import run_pipeline, vectorizer_for_index

# request keys forwarded to run_pipeline verbatim (the JAX package's list)
_REQ_KEYS = (
    "ef", "k", "k_clusters", "output_dir", "use_dynamic", "use_streaming",
    "rerank", "dense_rerank", "write_sam", "cigar", "mapq", "long_reads",
    "qual", "sort", "bam", "mark_dups", "read_group",
)


def serve(
    index_prefix: str,
    ref_file: str,
    in_stream=None,
    out_stream=None,
    search_cfg: SearchConfig | None = None,
    defaults: dict | None = None,
    device=None,
) -> int:
    """Blocking serve loop; returns the number of requests answered."""
    in_stream = in_stream if in_stream is not None else sys.stdin
    out_stream = out_stream if out_stream is not None else sys.stdout
    defaults = defaults or {}

    def reply(obj):
        out_stream.write(json.dumps(obj) + "\n")
        out_stream.flush()

    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):
        device = resolve_device(device)
        engine, config = load_index(index_prefix, device)
        vectorizer = vectorizer_for_index(index_prefix, config, device=device)
    reply({
        "ok": True,
        "ready": True,
        "index_type": config.get("index_type"),
        "n_vects": int(config.get("n_vects", 0)),
        "stride": int(config.get("stride", 1)),
        "t_load": round(time.time() - t0, 3),
    })

    served = 0
    for line in in_stream:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            reply({"ok": False, "error": f"bad request json: {e}"})
            continue
        tag = {"id": req["id"]} if "id" in req else {}
        if req.get("cmd") == "quit":
            reply({**tag, "ok": True, "quit": True})
            break
        if "fastq" not in req:
            reply({**tag, "ok": False, "error": "missing 'fastq'"})
            continue
        kwargs = {**defaults}
        kwargs.update({k: req[k] for k in _REQ_KEYS if k in req})
        stats = {} if req.get("search_stats") else None
        try:
            with contextlib.redirect_stdout(sys.stderr):
                if "fastq2" in req:
                    raise not_ported("paired-end requests (fastq2)")
                res = run_pipeline(
                    index_prefix, req["fastq"], ref_file,
                    vectorizer=vectorizer, search_cfg=search_cfg,
                    preloaded=(engine, config), search_stats=stats,
                    device=device, **kwargs,
                )
            served += 1
            resp = {
                **tag,
                "ok": True,
                "num_queries": res["num_queries"],
                "t_embed": round(res["t_embed"], 3),
                "t_search": round(res["t_search"], 3),
                "t_post": round(res["t_post"], 3),
            }
            if stats:
                resp["search_stats"] = stats
            reply(resp)
        except Exception as e:  # the daemon survives a bad request
            reply({**tag, "ok": False, "error": f"{type(e).__name__}: {e}"})
    return served
