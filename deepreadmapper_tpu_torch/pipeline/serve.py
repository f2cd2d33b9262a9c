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
             "long_reads": false,     # true -> chunk -> search -> chain
             "fastq2": "/path/r2.fastq",        # optional: paired-end, R2
             "max_isize": 1000, "min_isize": 0, "rescue": true,  # paired
             "search_stats": false}   # true -> effort counters in the
                                      # response (IVF engines; single-end)
  response: {"id": "r1", "ok": true, "num_queries": 150,
             "t_embed": ..., "t_search": ..., "t_post": ...}
  error:    {"id": "r1", "ok": false, "error": "..."}   (daemon stays up)
  shutdown: {"cmd": "quit"}  ->  {"ok": true, "quit": true}

A request with "fastq2" maps the pair (R1 = fastq) through
run_pipeline_paired; one with "long_reads" through run_pipeline's
long-read path.  Anything the pipeline prints goes to stderr while
serving, so the protocol stream stays parseable.

Each line runs in a ``serve.request`` span (utils.trace; recorded while a
torch profiler runs) from its arrival to its reply written, with the
request id of the line's "id" (else the line's serial number): children
``serve.parse``, run_pipeline's spans, ``serve.reply``.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

from deepreadmapper_tpu_torch import resolve_device
from deepreadmapper_tpu_torch.config import SearchConfig
from deepreadmapper_tpu_torch.index.registry import load_index
from deepreadmapper_tpu_torch.pipeline.search import (
    run_pipeline,
    run_pipeline_paired,
    vectorizer_for_index,
)
from deepreadmapper_tpu_torch.utils import trace

# request keys forwarded to run_pipeline verbatim (the JAX package's list)
_REQ_KEYS = (
    "ef", "k", "k_clusters", "output_dir", "use_dynamic", "use_streaming",
    "rerank", "dense_rerank", "write_sam", "cigar", "mapq", "long_reads",
    "qual", "sort", "bam", "mark_dups", "read_group",
)
# what a paired request takes besides: run_pipeline_paired's own keys
_PAIRED_KEYS = ("max_isize", "min_isize", "rescue")


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
    for serial, line in enumerate(in_stream):
        with trace.span("serve.request", request=str(serial)) as root:
            with trace.span("serve.parse"):
                req, resp = _parse(line)
                if req is not None and "id" in req:
                    root.request = str(req["id"])
            if req is not None and resp is None:
                # `res` stays referenced until the next request's replaces
                # it: freeing a result's arrays at once lets the allocator
                # return their pages, which the next request faults in again
                resp, res = _map(req, index_prefix, ref_file, engine, config, vectorizer,
                                 search_cfg, defaults, device)
                served += 1 if resp["ok"] else 0
            if resp is not None:
                with trace.span("serve.reply"):
                    reply(resp)
        if resp is not None and resp.get("quit"):
            break
    return served


def _parse(line: str):
    """(request, None) for a mapping request; (request or None, reply) for
    a line answered at once (bad JSON, no fastq, quit); (None, None) for a
    blank line."""
    line = line.strip()
    if not line:
        return None, None
    try:
        req = json.loads(line)
    except json.JSONDecodeError as e:
        return None, {"ok": False, "error": f"bad request json: {e}"}
    tag = {"id": req["id"]} if "id" in req else {}
    if req.get("cmd") == "quit":
        return req, {**tag, "ok": True, "quit": True}
    if "fastq" not in req:
        return req, {**tag, "ok": False, "error": "missing 'fastq'"}
    return req, None


def _map(req: dict, index_prefix, ref_file, engine, config, vectorizer, search_cfg,
         defaults, device) -> tuple[dict, dict | None]:
    """Map one request: (its reply, the pipeline's result); an error reply
    and None when the pipeline raises (the daemon survives a bad
    request)."""
    tag = {"id": req["id"]} if "id" in req else {}
    kwargs = {**defaults}
    kwargs.update({k: req[k] for k in _REQ_KEYS if k in req})
    stats = {} if req.get("search_stats") else None
    try:
        with contextlib.redirect_stdout(sys.stderr):
            if "fastq2" in req:
                # every request key but use_dynamic, which
                # run_pipeline_paired has no parameter for
                pkw = {kk: vv for kk, vv in kwargs.items() if kk != "use_dynamic"}
                pkw.update({kk: req[kk] for kk in _PAIRED_KEYS if kk in req})
                res = run_pipeline_paired(
                    index_prefix, req["fastq"], req["fastq2"], ref_file,
                    vectorizer=vectorizer, search_cfg=search_cfg,
                    preloaded=(engine, config), device=device, **pkw,
                )
            else:
                res = run_pipeline(
                    index_prefix, req["fastq"], ref_file,
                    vectorizer=vectorizer, search_cfg=search_cfg,
                    preloaded=(engine, config), search_stats=stats,
                    device=device, **kwargs,
                )
    except Exception as e:  # the daemon survives a bad request
        return {**tag, "ok": False, "error": f"{type(e).__name__}: {e}"}, None
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
    return resp, res
