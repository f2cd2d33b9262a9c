"""The comparison that decides a run's `correct`.

What is judged is what the timed path produced: the index the set-up built
(its codes; for PQFLAT its codebook and codes) and, for a sample of the
window's reads drawn from the seed, the files their requests wrote
(indices.npy, distances.npy and, where the traffic writes one, the SAM
lines).  The plain reference works all of it out again from the same genome
and reads: the window and read embeddings (reference/encoder.py), the int8
codes or the PQ codebook and codes at the configuration's stride, the
scan, the rerank's order and the SAM lines.

The index.  The code that judges an index sits in a file of its own a
type, ``reference/index_<index_type>.py``, found by the configuration's
index_type (``index_kind``): the INT8FLAT codes, the PQFLAT codebook and
codes.  Each rebuilds the index the reference scans from its own
embeddings, taking the program's choice only where a value lies within
``eps`` of a rounding boundary.

The rerank.  What judges a rerank's order, counts its work and writes the
control's SAM lines sits in a file of its own a rerank,
``reference/rerank_<rerank>.py``, found by the request's rerank or by
"l2", the pipeline's default, when it names none (``rerank_kind``); a
rerank with no file is refused.  The npy rows hold k columns at stride 1
and the k_clusters sparse hits past it; the rerank file turns them into
the read's final ids.

The reads.  A read's own codes are not in any file, so for a read whose
row differs, the reference finds the choices at the read's values within
``eps`` of a boundary that give the program's distances to its ids, scans
those, and the read is right when one gives the program's row bit for
bit.  A PQ request's query scale is its largest |value| / 127, which
rounding may move by an ulp: the reference takes the scale, among those
within eps of its own, that gives the most of the program's distances over
the whole rows of up to 64 probe reads (error-free reads' top distances
alone can read alike at two scales).

Numbers compared, each with its limit in the configuration file:

* index_gap: the widest rounding gap of the index codes, in code steps
  (PQ: of the distance to the boundary between the given centroid and the
  nearest, in steps of 1/127).
* kmeans_excess (PQ): the program's codebook's k-means objective over the
  reference's training sample, relative to the reference's own, less one.
* reads_wrong: sampled reads whose npy row or SAM lines no rounding choice
  explains, or whose rows are not of the shape the stride gives.
* what a rerank file adds past stride 1 (rerank_l2: l2_gap), with the
  limit the file gives (``limits``).
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from drm_bench.reference import encoder as ref_enc
from drm_bench.reference import sam as ref_sam
from drm_bench.reference import scan as ref_scan

MAX_AMBIGUOUS = 16  # values of one read next to a boundary whose choices are tried


def _load_rows(out_dir: str):
    return ref_scan.load_ids(out_dir), np.load(f"{out_dir}/distances.npy").astype(np.float32)


def sample_reads(sizes: list[int], n_check: int, seed: int) -> list[tuple[int, int]]:
    """(request, read) pairs to check: the largest request's reads (up to
    half of n_check), the rest uniformly from the others."""
    rng = np.random.default_rng([seed, 3])
    big = int(np.argmax(sizes))
    others = sum(sizes) - sizes[big]
    own = [(big, i) for i in range(min(sizes[big], max(n_check // 2, n_check - others)))]
    rest = [(j, i) for j, n in enumerate(sizes) if j != big for i in range(n)]
    take = min(len(rest), n_check - len(own))
    pick = rng.choice(len(rest), size=take, replace=False) if take > 0 else []
    return sorted(own + [rest[p] for p in pick])


def _by_name(kind: str, value) -> object:
    name = f"drm_bench.reference.{kind}_{str(value).lower()}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        what = "index_type" if kind == "index" else kind
        raise ValueError(f"no judge for {what} {value!r}: "
                         f"{name.replace('.', '/')}.py is missing") from None


def index_kind(cfg: dict):
    """The module that judges the configuration's index type,
    reference/index_<index_type>.py."""
    return _by_name("index", cfg["index_type"])


def rerank_kind(keys: dict):
    """The module of a request's rerank (keys: the request's own keys),
    reference/rerank_<rerank>.py, "l2" where it names none."""
    return _by_name("rerank", keys.get("rerank") or "l2")


def limits(cfg: dict, traffic: dict) -> dict:
    """Each number's limit: the configuration's and, where the requests
    write SAM lines, those their rerank adds."""
    req = traffic["request"]
    return {**cfg["limits"],
            **(rerank_kind(req).limits(cfg) if req.get("write_sam", True) else {})}


def rerank_env(cfg: dict, keys: dict, enc, genome: torch.Tensor) -> dict:
    """What a rerank file reads: the encoder, the genome on its device, and
    the request's sizes (bound: 2 x the genome's dense windows)."""
    ref_len = int(cfg["ref_len"])
    return {"enc": enc, "genome": genome, "ref_len": ref_len, "stride": int(cfg["stride"]),
            "k": int(keys["k"]),
            "bound": 2 * ref_scan.num_windows(genome.numel(), ref_len)}


def verdict(numbers: dict, limits: dict) -> tuple[dict, bool]:
    """(each number compared beside its limit, whether all are within)."""
    checks = {name: {"value": numbers[name], "limit": lim} for name, lim in limits.items()}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def _infer_scale(emb: np.ndarray, sc: float, idx: ref_scan.Index, prog_ids, prog_d,
                 windowed: bool, eps: float) -> np.float32:
    """The query scale the program used for one request (see the module
    doc): the candidate that gives the most of its distances over the
    probes' whole rows."""
    qmax = np.float32(np.max(np.abs(emb))) if emb.size else np.float32(0)
    span = eps * max(float(np.float32(sc)), float(qmax) / 127.0)
    cands, v = {}, qmax
    for direction in (1, -1):
        v = qmax
        while abs(float(v) - float(qmax)) <= span and len(cands) < 4096:
            sq, _ = ref_scan.query_scale_ratio(v, sc)
            cands.setdefault(float(sq), abs(float(v) - float(qmax)))
            v = np.nextafter(v, np.float32(direction * np.inf), dtype=np.float32)
    if len(cands) == 1:
        return np.float32(next(iter(cands)))
    probe = np.arange(min(64, emb.shape[0]))
    pid = torch.from_numpy(np.maximum(prog_ids[probe], 0)).to(idx.codes.device)
    r8 = idx.rows_at(pid)  # [probes, columns, 128]
    best, best_hits = None, -1
    # nearest first: the reference's own scale is tried first and most often right
    for sq in sorted(cands, key=cands.get):
        sq = np.float32(sq)
        ratio = np.float32(sq / np.float32(sc))
        q8 = ref_scan.quantize_host(emb[probe], sq)
        s = ref_scan.score_rows(torch.from_numpy(q8).to(r8.device), r8, ratio, windowed)
        d = ref_scan.distances(s.cpu().numpy(), q8, np.full(len(probe), ratio), sc, windowed)
        hits = int((d == prog_d[probe]).sum())
        if hits > best_hits:
            best, best_hits = sq, hits
        if hits == d.size:
            break
    return best


def judge(view: dict, device, seed: int, eps: float, n_check: int) -> tuple[dict, dict]:
    """Numbers and diagnostics of one run.  view: {"genome" (uint8 ACGT),
    "config", "traffic", "index" (the index type's program_state),
    "requests" ([{"reads", "names", "out"}]), "windowed"}."""
    cfg, traffic = view["config"], view["traffic"]
    req_keys = traffic["request"]
    rerank = rerank_kind(req_keys)
    cols = ref_scan.search_columns(cfg, req_keys)
    dev = torch.device(device)
    numbers: dict = {}
    info: dict = {}
    split: dict = {}
    info["check_split_s"] = split
    t = time.monotonic()
    with ref_enc.precision(tf32=False):
        enc = ref_enc.Encoder(dev)
        genome = torch.from_numpy(view["genome"]).to(dev)
        idx = index_kind(cfg).judge(enc, genome, cfg, view["index"], eps, numbers, info)
        split["index"] = time.monotonic() - t
        t = time.monotonic()
        windowed = bool(view["windowed"])
        reqs = view["requests"]
        pairs = sample_reads([len(r["names"]) for r in reqs], n_check, seed)
        by_req: dict[int, list[int]] = {}
        for j, i in pairs:
            by_req.setdefault(j, []).append(i)
        order = sorted(by_req)
        emb_all = ref_enc.embed_reads(enc, np.concatenate([reqs[j]["reads"] for j in order]))
        emb_all = emb_all.cpu().numpy()
        q_emb, ratios, rows_p, d_p, who, off = [], [], [], [], [], 0
        for j in order:
            r = reqs[j]
            n = len(r["names"])
            emb = emb_all[off : off + n]
            off += n
            ids_p, dist_p = _load_rows(r["out"])
            if ids_p.shape != (n, cols) or dist_p.shape != (n, cols):
                # rows of another shape than the stride gives: no row is right
                info.setdefault("rows_malformed", []).append(
                    {"request": j, "indices": list(ids_p.shape), "want": [n, cols]})
                ids_p = np.full((n, cols), -2, np.int64)
                dist_p = np.full((n, cols), np.nan, np.float32)
            sq = _infer_scale(emb, idx.scale, idx, ids_p, dist_p, windowed, eps)
            sel = np.asarray(by_req[j])
            q_emb.append(emb[sel])
            ratios.append(np.full(sel.size, np.float32(sq / np.float32(idx.scale))))
            rows_p.append(ids_p[sel])
            d_p.append(dist_p[sel])
            who += [(j, i, sq) for i in by_req[j]]
        q_emb = np.concatenate(q_emb)
        ratio = np.concatenate(ratios)
        ids_p = np.concatenate(rows_p)
        dist_p = np.concatenate(d_p)
        sqs = np.array([w[2] for w in who], np.float32)
        q8 = np.stack([ref_scan.quantize_host(q_emb[i], sqs[i]) for i in range(len(who))]) \
            if len(who) else np.zeros((0, 128), np.int8)

        def run(q8_rows, ratio_rows):
            s, ids = ref_scan.scan(torch.from_numpy(q8_rows).to(dev), idx.rows,
                                   idx.ntotal, idx.ntotal, ratio_rows, cols, windowed)
            d = ref_scan.distances(s.cpu().numpy(), q8_rows, ratio_rows, idx.scale, windowed)
            return ids.cpu().numpy(), d

        split["reads"] = time.monotonic() - t
        t = time.monotonic()
        ids_r, d_r = run(q8, ratio)
        split["scan"] = time.monotonic() - t
        t = time.monotonic()
        same = np.all(ids_r == ids_p, axis=1) & np.all(d_r == dist_p, axis=1)
        # A row no plain rounding explains: find the choices at the read's
        # values next to a boundary that give the program's distances to its
        # own ids, then scan those choices in full.
        var_q, var_of = [], []
        for i in np.flatnonzero(~same):
            alt, near = ref_scan.alternative_codes(q_emb[i], sqs[i], eps)
            amb = np.flatnonzero(near)
            if not 0 < amb.size <= MAX_AMBIGUOUS:
                continue
            bits = (np.arange(1, 1 << amb.size)[:, None] >> np.arange(amb.size)[None, :]) & 1
            vq = np.repeat(q8[i][None, :], bits.shape[0], axis=0)
            vq[:, amb] = np.where(bits == 1, alt[amb][None, :], vq[:, amb])
            r8 = idx.rows_at(torch.from_numpy(np.maximum(ids_p[i], 0)).to(dev))
            vr = np.full(bits.shape[0], ratio[i], np.float32)
            sv = ref_scan.score_rows(torch.from_numpy(vq).to(dev), r8, vr, windowed)
            dv = ref_scan.distances(sv.cpu().numpy(), vq, vr, idx.scale, windowed)
            for v in np.flatnonzero(np.all(dv == dist_p[i][None, :], axis=1))[:4]:
                var_q.append(vq[v])
                var_of.append(i)
        info["variants_scanned"] = len(var_q)
        if var_q:
            vi, vd = run(np.stack(var_q), ratio[var_of])
            for v, i in enumerate(var_of):
                if not same[i] and np.array_equal(vi[v], ids_p[i]) and np.array_equal(vd[v], dist_p[i]):
                    same[i] = True
                    ids_r[i] = vi[v]
        info["rows_unexplained"] = int((~same).sum())
        info["unexplained"] = [
            {"request": int(who[i][0]), "read": int(who[i][1]), "ids": ids_p[i].tolist(),
             "d": dist_p[i].tolist(), "ref_ids": ids_r[i].tolist(), "ref_d": d_r[i].tolist(),
             "near_boundary": int(ref_scan.alternative_codes(q_emb[i], sqs[i], eps)[1].sum())}
            for i in np.flatnonzero(~same)[:3]]
        split["variants"] = time.monotonic() - t
        t = time.monotonic()
        wrong = ~same
        if req_keys.get("write_sam", True):
            sams = {j: ref_sam.lines_by_read(f"{reqs[j]['out']}/results.sam") for j in by_req}
            names = [reqs[j]["names"][i] for j, i, _ in who]
            reads = np.stack([reqs[j]["reads"][i] for j, i, _ in who])
            bad, extra, more = rerank.judge_sam(
                rerank_env(cfg, req_keys, enc, genome), ids_r, reads, q_emb, names,
                [r.tobytes().decode() for r in reads],
                [sams[j].get(name) for (j, _, _), name in zip(who, names)])
            numbers.update(extra)
            info.update(more)
            info["sam_reads_unequal"] = int(bad.sum())
            wrong |= bad
        split["rerank_sam"] = time.monotonic() - t
        numbers["reads_wrong"] = int(wrong.sum())
        info["reads_checked"] = len(who)
    return numbers, info
