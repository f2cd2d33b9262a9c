"""The harness is driven by data: a configuration file, a traffic file, a
metric file and a BENCHMARK.json entry added to a copy are found and run,
with no file of the copy edited."""

import hashlib
import json
import os
import subprocess
import sys

from drm_bench.tests.conftest import REPO, SPARSE_CELL, add_sparse_cell, make_tiny_root

_CHILD = """
import json, sys, time
from drm_bench import harness
res = {cell: harness.run_cell(cell, 8, 1.0, True, "cpu", time.monotonic(), tmp=sys.argv[1])[0]
       for cell in sys.argv[2:]}
print(json.dumps(res))
"""


def _digest(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "drm_bench")):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_added_files_are_found(tmp_path):
    root = make_tiny_root(str(tmp_path / "copy"), code=True)
    before = _digest(root)
    dd = os.path.join(root, "drm_bench")
    with open(os.path.join(dd, "configs", "ecoli_int8flat.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny_b", genome_bp=2500)
    with open(os.path.join(dd, "configs", "tiny_b.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(dd, "traffic", "npy_small.json"), "w") as f:
        json.dump({"name": "npy_small", "read_len": 150, "sub_rate": 0.02,
                   "request_reads": {"kind": "fixed", "reads": 40}, "pool_requests": 2,
                   "request": {"k": 5, "write_sam": True}, "check_reads": 60}, f)
    with open(os.path.join(dd, "metrics", "requests_done.py"), "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx.replies))\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_b", "source": "a test", "file":
                             "drm_bench/configs/tiny_b.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_b.npy_small", "config": "tiny_b",
                               "traffic": "npy_small", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("tiny_b.npy_small")
    bench["per_layer"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "a test",
                               "moves": "reads_per_s", "workloads": ["tiny_b.npy_small"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    # a stride-4 INT8FLAT configuration and an L2-rerank SAM traffic file
    add_sparse_cell(root, reads=40)
    after = _digest(root)
    assert all(after[p] == h for p, h in before.items())  # nothing edited, only added
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, REPO]))
    out = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path), "tiny_b.npy_small",
                          SPARSE_CELL], cwd=root, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    res = got["tiny_b.npy_small"]
    assert res["correct"] is True
    assert res["metrics"]["requests_done"]["value"] == res["attempted"] >= 1
    sparse = got[SPARSE_CELL]
    assert sparse["correct"] is True and "l2_gap" in sparse["checks"]


def test_an_unknown_index_type_or_rerank_is_refused():
    """What belongs to an index type is found by name, and a type with no
    file of its own is refused rather than judged or counted as another."""
    import types

    import pytest

    from drm_bench.metrics import _work
    from drm_bench.reference import judge

    assert judge.index_kind({"index_type": "PQFLAT"}).__name__.endswith("index_pqflat")
    with pytest.raises(ValueError, match="index_ivfint8.py is missing"):
        judge.index_kind({"index_type": "IVFINT8"})
    ctx = types.SimpleNamespace(replies=[{"ok": True, "reads": 8}], ntotal=1000,
                                config={"scan_kernel": "ivf_chunk", "ref_len": 150},
                                traffic={"request": {"k": 10}, "read_len": 150})
    with pytest.raises(ModuleNotFoundError):
        _work.least_s(ctx)
    ctx.config["scan_kernel"] = "int8_winmin"
    ctx.traffic["request"]["rerank"] = "nw"
    with pytest.raises(ValueError, match="rerank_nw.py is missing"):
        _work.least_s(ctx)
    with pytest.raises(ValueError, match="rerank_nw.py is missing"):
        judge.rerank_kind(ctx.traffic["request"])
    assert judge.rerank_kind({"k": 10}).__name__.endswith("rerank_l2")
