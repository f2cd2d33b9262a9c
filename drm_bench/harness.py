"""One run of one cell of BENCHMARK.json: set-up, the measured window, the
metrics, and the comparison that decides `correct`.

Everything about a cell is data found by name: its configuration file (the
`file` of its entry in `configs`), its traffic file
(``drm_bench/traffic/<traffic>.json``, read by ``gen``) and one file a
metric (``drm_bench/metrics/<name>.py``).  The harness drives the port's
resident daemon, ``deepreadmapper_tpu_torch.pipeline.serve.serve``, in
process: set-up builds the engine through the port's build path
(``pipeline.build.build_index``, with the engine's files kept in memory
rather than written) and hands it to ``serve`` in place of its index load;
the request lines come from an iterator that yields the next line only
after the reply to the last one (a closed loop, one caller).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from unittest import mock

import numpy as np

from drm_bench import gen

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "deepreadmapper_tpu")
_QT = 512  # the scan pads a request's reads to this multiple: one shape a bucket


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_spec(bench: dict, name: str, root: str = ROOT):
    """(cell, configuration dict, traffic dict) of a cell by name."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "drm_bench", "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return cell, cfg, traffic


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metric entries a run of the cell reports: its end-to-end ones, or
    with trace its per-layer ones."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]


def load_metric(name: str, root: str = ROOT):
    path = os.path.join(root, "drm_bench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "drm_bench.metrics._" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Context:
    """What a metric reads."""
    replies: list
    window_s: float
    setup_s: float
    peak_mem_bytes: int | None
    trace: object
    config: dict
    traffic: dict
    ntotal: int


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


class Loop:
    """The closed loop: request lines (warm-up, then the window) and the
    sink serve() writes its replies to."""

    def __init__(self, requests: list[dict], warm: list[dict], seconds: float,
                 out_root: str, on_start, on_end):
        self.requests, self.warm, self.seconds = requests, warm, seconds
        self.out_root = out_root
        self.on_start, self.on_end = on_start, on_end
        self.replies: list[dict] = []
        self.warm_replies: list[dict] = []
        self.pending = None
        self.t0 = self.t1 = None

    def lines(self):
        for req in self.warm:
            self.pending = {"warm": True}
            yield json.dumps(req)
        self.pending = None
        self.on_start()
        self.t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - self.t0 < self.seconds:
            j = i % len(self.requests)
            req = self.requests[j]
            out = os.path.join(self.out_root, str(i))
            self.pending = {"pool": j, "out": out, "reads": req["reads"],
                            "sent": time.perf_counter()}
            yield json.dumps({**req["line"], "id": str(i), "output_dir": out})
            i += 1
        self.pending = None
        self.t1 = self.replies[-1]["replied"] if self.replies else time.perf_counter()
        self.on_end()
        yield json.dumps({"cmd": "quit"})

    def write(self, s: str) -> None:
        now = time.perf_counter()
        obj = json.loads(s)
        if self.pending is None:
            return
        if self.pending.get("warm"):
            self.warm_replies.append(obj)
        else:
            self.replies.append({**self.pending, "replied": now, "ok": bool(obj.get("ok")),
                                 "error": obj.get("error"),
                                 **{k: float(obj.get(k, 0.0)) for k in
                                    ("t_embed", "t_search", "t_post")}})
        self.pending = None

    def flush(self) -> None:
        pass


def build_engine(ref_file: str, prefix: str, cfg: dict, device):
    """The port's build path (pipeline.build.build_index) with the engine's
    files and config.txt kept in memory: returns (engine, config)."""
    from deepreadmapper_tpu_torch.config import BuildConfig
    from deepreadmapper_tpu_torch.index.registry import engine_class
    from deepreadmapper_tpu_torch.pipeline import build as pbuild

    kept = {}
    bcfg = BuildConfig(stride=int(cfg["stride"]), m_pq=int(cfg.get("m_pq", 8)),
                       nbits=int(cfg.get("nbits", 8)),
                       sample_rate=float(cfg.get("sample_rate", 0.5)),
                       kmeans_iters=int(cfg.get("kmeans_iters", 25)),
                       seed=int(cfg.get("pq_seed", 1234)))
    with mock.patch.object(engine_class(cfg["index_type"]), "save",
                           lambda self, p: kept.setdefault("engine", self)), \
            mock.patch.object(pbuild, "save_config", lambda c, p: None):
        config = pbuild.build_index(ref_file, prefix, int(cfg["ref_len"]),
                                    int(cfg["stride"]), cfg["index_type"],
                                    build_cfg=bcfg, device=device)
    return kept["engine"], config


def _warm(pool: list[dict], requests: list[dict], warm_root: str) -> list[dict]:
    """One request of each shape the window sends: the largest of each bucket
    of the scan's query padding."""
    best: dict[int, int] = {}
    for j, r in enumerate(requests):
        b = -(-r["reads"] // _QT)
        if b not in best or r["reads"] > requests[best[b]]["reads"]:
            best[b] = j
    out = []
    for b, j in sorted(best.items()):
        line = dict(requests[j]["line"])
        line["output_dir"] = os.path.join(warm_root, str(b))
        line["id"] = f"warm{b}"
        out.append(line)
    return out


def _checked(done: list[dict], seed: int, most: int = 16) -> list[dict]:
    """The window's requests whose files the check reads: the first of the
    largest and others drawn from the seed, at most `most` in all."""
    if not done:
        return []
    big = max(range(len(done)), key=lambda i: done[i]["reads"])
    rest = [i for i in range(len(done)) if i != big]
    pick = np.random.default_rng([seed, 4]).choice(
        len(rest), size=min(len(rest), most - 1), replace=False) if rest else []
    return [done[big]] + [done[rest[p]] for p in sorted(pick)]


def io_bytes() -> dict:
    """This process's /proc/self/io counters (write_bytes: what reached the
    disk; wchar: what went through write calls)."""
    try:
        with open("/proc/self/io") as f:
            return {k: int(v) for k, v in (ln.split(": ") for ln in f.read().splitlines())}
    except OSError:
        return {}


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, root: str = ROOT, tmp: str | None = None) -> tuple[dict, dict]:
    """One run: returns (the result line's object, diagnostics for standard
    error)."""
    import torch

    from deepreadmapper_tpu_torch.pipeline import serve as pserve
    from drm_bench.reference import judge as ref_judge
    from drm_bench.reference import scan as ref_scan
    from drm_bench.trace import WindowTrace, request_phases

    bench = load_bench(root)
    _, cfg, traffic = cell_spec(bench, cell_name, root)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    work = tempfile.mkdtemp(prefix="drm_bench_", dir=tmp)
    split: dict = {"imports": time.monotonic() - t_start}
    state: dict = {"trace": WindowTrace() if trace and cuda else None}
    try:
        t = time.monotonic()
        genome = gen.make_genome(int(cfg["genome_bp"]), seed)
        ref_file = os.path.join(work, "ref.fna")
        gen.write_fasta(ref_file, genome)
        pool = gen.make_pool(work, genome, traffic, seed)
        keys = {"ef": int(cfg["ef"]), "k_clusters": int(cfg["k_clusters"]),
                **traffic["request"]}
        requests = [{"reads": len(p["names"]), "line": {"fastq": p["fastq"], **keys}}
                    for p in pool]
        split["inputs"] = time.monotonic() - t
        t = time.monotonic()
        engine, config = build_engine(ref_file, os.path.join(work, "index"), cfg, dev)
        split["index_build"] = time.monotonic() - t
        state["warm_from"] = time.monotonic()
        ntotal = int(engine.ntotal)

        def on_start():
            state["setup_s"] = time.monotonic() - t_start
            split["warm_up"] = time.monotonic() - state["warm_from"]
            if cuda:
                torch.cuda.synchronize()
                state["setup_peak"] = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            if state["trace"] is not None:
                state["trace"].start()

        def on_end():
            if cuda:
                torch.cuda.synchronize()
                state["peak"] = torch.cuda.max_memory_allocated()
            if state["trace"] is not None:
                state["trace"].stop()

        loop = Loop(requests, _warm(pool, requests, os.path.join(work, "warm")),
                    seconds, os.path.join(work, "out"), on_start, on_end)
        with mock.patch.object(pserve, "load_index",
                               lambda prefix, device=None: (engine, config)):
            pserve.serve(os.path.join(work, "index"), ref_file, in_stream=loop.lines(),
                         out_stream=loop, device=dev)
        bad_warm = [r for r in loop.warm_replies if not r.get("ok")]
        if bad_warm:
            raise RuntimeError(f"a warm-up request failed: {bad_warm[0]}")

        # the program's state as the judge reads it; then free the card
        index = ref_judge.index_kind(cfg).program_state(engine)
        del engine, config
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        done = [r for r in loop.replies if r["ok"]]
        view = {"genome": genome, "config": cfg, "traffic": traffic, "index": index,
                "windowed": cuda and ntotal >= ref_scan.FUSED_MIN_ROWS,
                "requests": [{"reads": pool[r["pool"]]["reads"], "names": pool[r["pool"]]["names"],
                              "out": r["out"]} for r in _checked(done, seed)]}
        t = time.monotonic()
        numbers, info = ref_judge.judge(view, dev, seed, float(cfg["limits"]["index_gap"]),
                                        int(traffic["check_reads"]))
        info["check_s"] = time.monotonic() - t
        info["setup_split_s"] = split
        checks, correct = ref_judge.verdict(numbers, ref_judge.limits(cfg, traffic))
        failed = sum(1 for r in loop.replies if not r["ok"])
        ctx = Context(replies=loop.replies, window_s=loop.t1 - loop.t0,
                      setup_s=state["setup_s"], peak_mem_bytes=state.get("peak"),
                      trace=state["trace"], config=cfg, traffic=traffic, ntotal=ntotal)
        metrics = {}
        for m in metrics_of(bench, cell_name, trace):
            value = load_metric(m["name"], root).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device_info = {
            "platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
            "count": 1,
            "memory_peak_bytes": int(max(state.get("setup_peak", 0), state.get("peak") or 0)),
        }
        result = {"correct": bool(correct and failed == 0), "attempted": len(loop.replies),
                  "failed": failed, "metrics": metrics, "device": device_info}
        tr = state["trace"]
        if tr is not None:
            device_info["busy_s"] = tr.busy_s
            device_info["window_s"] = tr.window_s
            result["breakdown"] = {"device_ops": tr.device_ops(),
                                   "idle_gaps": tr.idle_gaps(request_phases(loop.replies))}
        result["checks"] = checks
        info["window_requests"] = len(loop.replies)
        info["requests_checked"] = len(view["requests"])
        lat = np.array([r["replied"] - r["sent"] for r in loop.replies]) * 1e3
        if lat.size:
            info["latency_ms_p50_p90_p95_p99_max"] = [
                round(float(x), 2) for x in np.percentile(lat, [50, 90, 95, 99, 100])]
        if failed:
            info["first_error"] = next(r["error"] for r in loop.replies if not r["ok"])
        return result, info
    finally:
        shutil.rmtree(work, ignore_errors=True)
