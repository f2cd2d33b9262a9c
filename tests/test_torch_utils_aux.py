"""The port's copies of the JAX package's small host modules, held to the
originals on the same inputs: the OpenVINO IR loader (on a synthetic IR
built here, and the shipped npz), the id map, the stage tracer, the prefix
logger, and ``device_trace`` on ``torch.profiler``."""

import json
import os

import numpy as np
import pytest

from deepreadmapper_tpu.io import idmap as jidmap
from deepreadmapper_tpu.models import ir_loader as jir
from deepreadmapper_tpu.utils import logging as jlog
from deepreadmapper_tpu.utils import trace as jtrace
from deepreadmapper_tpu_torch.io import idmap as tidmap
from deepreadmapper_tpu_torch.models import ir_loader as tir
from deepreadmapper_tpu_torch.utils import logging as tlog
from deepreadmapper_tpu_torch.utils import trace as ttrace

# role -> (element type, shape) of the synthetic IR's seven weights
_SYNTH = {
    "embedding": ("f16", (11, 4)),
    "gru1_W": ("f16", (2, 6, 4)),
    "gru1_R": ("f32", (2, 6, 2)),
    "gru1_B": ("f16", (2, 8)),
    "gru2_W": ("i64", (2, 6, 4)),
    "gru2_R": ("f32", (2, 6, 2)),
    "gru2_B": ("f16", ()),
}
_NP = {"f16": np.float16, "f32": np.float32, "i64": np.int64}


def _write_ir(tmp_path, drop: str | None = None):
    """An IR pair with the seven named Consts (in the bin in a shuffled
    order, with gaps), two decoy Consts and a non-Const layer that carries
    a weight's name; drop leaves one weight out.  Returns (xml path,
    {role: array})."""
    rng = np.random.default_rng(7)
    name_of = {role: name for name, role in jir._WEIGHT_NAMES.items()}
    arrays = {}
    for role, (et, shape) in _SYNTH.items():
        if et == "i64":
            arrays[role] = rng.integers(-2**40, 2**40, shape, dtype=np.int64)
        else:
            arrays[role] = rng.standard_normal(shape).astype(_NP[et])
    blob, layers = bytearray(), []

    def const(lid, name, et, shape, data):
        blob.extend(b"\xab" * 3)  # a gap before each tensor
        off = len(blob)
        blob.extend(data.tobytes())
        layers.append(
            f'<layer id="{lid}" name="{name}" type="Const" version="opset1">'
            f'<data element_type="{et}" shape="{",".join(map(str, shape))}" '
            f'offset="{off}" size="{data.nbytes}"/></layer>')

    lid = 0
    const(lid, "decoy_weight", "f32", (3,), rng.standard_normal(3).astype(np.float32))
    for role in ("gru2_B", "gru1_R", "embedding", "gru2_W", "gru1_B", "gru2_R", "gru1_W"):
        if role == drop:
            continue
        lid += 1
        et, shape = _SYNTH[role]
        const(lid, name_of[role], et, shape, arrays[role])
    const(lid + 1, "Concat_999_compressed", "i64", (2,), np.array([5, 6], np.int64))
    layers.append(f'<layer id="{lid + 2}" name="onnx::GRU_397_compressed" type="Parameter" '
                  'version="opset1"><data element_type="f32" shape="9,9"/></layer>')
    xml = tmp_path / "model.xml"
    xml.write_text('<?xml version="1.0"?>\n<net name="synthetic" version="11"><layers>'
                   + "".join(layers) + "</layers><edges/></net>\n")
    (tmp_path / "model.bin").write_bytes(bytes(blob))
    return str(xml), arrays


def _same_weights(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


def test_ir_loader_matches_jax_on_a_synthetic_ir(tmp_path):
    """load_ir_weights: the seven roles, each with its IR dtype and shape,
    equal to the JAX loader's and to the arrays written into the bin; the
    decoys and the non-Const layer are skipped; an explicit bin path reads
    the same."""
    xml, arrays = _write_ir(tmp_path)
    got, want = tir.load_ir_weights(xml), jir.load_ir_weights(xml)
    _same_weights(got, want)
    _same_weights(got, arrays)
    assert got["gru2_B"].shape == () and got["gru2_W"].dtype == np.int64
    _same_weights(tir.load_ir_weights(xml, str(tmp_path / "model.bin")), want)


def test_ir_loader_missing_weight_raises_like_jax(tmp_path):
    xml, _ = _write_ir(tmp_path, drop="gru1_R")
    with pytest.raises(ValueError) as jerr:
        jir.load_ir_weights(xml)
    with pytest.raises(ValueError) as terr:
        tir.load_ir_weights(xml)
    assert str(terr.value) == str(jerr.value) == "IR missing expected weights: ['gru1_R']"


def test_convert_ir_to_npz_read_by_both_packages(tmp_path):
    """The port's npz and the JAX package's hold the same arrays, and each
    package's load_npz_weights reads both equal."""
    xml, arrays = _write_ir(tmp_path)
    tnpz, jnpz = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tir.convert_ir_to_npz(xml, tnpz)
    jir.convert_ir_to_npz(xml, jnpz)
    for path in (tnpz, jnpz):
        _same_weights(tir.load_npz_weights(path), arrays)
        _same_weights(jir.load_npz_weights(path), arrays)


def test_ir_loader_main_writes_where_asked(tmp_path):
    """``python -m ...ir_loader model.xml -o out``: a bare file name lands in
    the working directory, a nested one makes its directory; without -o it
    refuses, and the shipped npz is never written."""
    import subprocess
    import sys

    xml, arrays = _write_ir(tmp_path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    shipped = os.stat(tir.DEFAULT_NPZ).st_mtime_ns

    def run(*argv):
        return subprocess.run([sys.executable, "-m", "deepreadmapper_tpu_torch.models.ir_loader",
                               xml, *argv], cwd=tmp_path, env=env, capture_output=True,
                              text=True, timeout=120)

    for out in ("tuned.npz", os.path.join("nested", "dir", "tuned.npz")):
        done = run("-o", out)
        assert done.returncode == 0, done.stderr
        assert done.stdout.strip() == f"wrote {out}"
        _same_weights(tir.load_npz_weights(str(tmp_path / out)), arrays)
    done = run()
    assert done.returncode == 2 and "-o/--out" in done.stderr
    assert os.stat(tir.DEFAULT_NPZ).st_mtime_ns == shipped


def test_shipped_npz_loads_equal_through_both():
    assert os.path.samefile(tir.DEFAULT_NPZ, jir.DEFAULT_NPZ)
    got = tir.load_npz_weights()
    _same_weights(got, jir.load_npz_weights())
    assert got["embedding"].shape == (7638, 64) and got["embedding"].dtype == np.float16


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_id_map_round_trips_across_packages(tmp_path, writer):
    labels = np.array([0, 1, 4, 5, 2**40, 2**64 - 1], dtype=np.uint64)
    save, load = ((tidmap.save_id_map, jidmap.load_id_map) if writer == "torch"
                  else (jidmap.save_id_map, tidmap.load_id_map))
    path = save(labels, str(tmp_path / "sub"), "ids.bin")
    assert path == os.path.join(str(tmp_path / "sub"), "ids.bin")
    got = load(path)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, labels)


def test_id_map_size_error_matches_jax(tmp_path):
    path = tmp_path / "bad.bin"
    path.write_bytes(b"\x00" * 12)
    with pytest.raises(ValueError) as jerr:
        jidmap.load_id_map(str(path))
    with pytest.raises(ValueError) as terr:
        tidmap.load_id_map(str(path))
    assert str(terr.value) == str(jerr.value)


def _fake_clock(monkeypatch, module):
    """time.time -> 100.0, 100.25, 100.5, ... for the next calls."""
    ticks = iter(100.0 + 0.25 * i for i in range(1000))
    monkeypatch.setattr(module.time, "time", lambda: next(ticks))


def _traced(trace_mod, monkeypatch) -> tuple[str, str]:
    _fake_clock(monkeypatch, trace_mod)
    t = trace_mod.Tracer()
    with t.span("embed"):
        with t.span("tokenize"):
            pass
    with t.span("search"):
        pass
    t.count("dist_evals", 42)
    t.count("beam_nodes")
    t.count("dist_evals", 8)
    g = trace_mod.global_tracer()
    n = len(g.spans)
    with trace_mod.stage("write"):
        pass
    assert len(g.spans) == n + 1 and g.spans[-1] == ("write", 0.25)
    return t.summary(), trace_mod.Tracer().summary()


def test_tracer_summary_matches_jax(monkeypatch):
    """The same spans and counters give the same summary string, the
    shares and the empty table included."""
    want = _traced(jtrace, monkeypatch)
    got = _traced(ttrace, monkeypatch)
    assert got == want
    assert "dist_evals" in got[0] and "50" in got[0] and "tokenize" in got[0]


def _logged(log_mod, capsys, monkeypatch) -> tuple[str, str]:
    monkeypatch.setattr(log_mod, "_T0", 50.0)
    monkeypatch.setattr(log_mod.time, "time", lambda: 61.125)
    capsys.readouterr()
    log_mod.log("MAIN", "built 1702 windows")
    log_mod.log_timed("BATCH", "batch 3 of 9")
    log_mod.set_verbose(False)
    log_mod.log("MAIN", "silent")
    log_mod.log_timed("BATCH", "silent")
    log_mod.set_verbose(True)
    log_mod.log("POST-PROCESS", "done")
    out = capsys.readouterr()
    return out.out, out.err


def test_logging_matches_jax(capsys, monkeypatch):
    want = _logged(jlog, capsys, monkeypatch)
    got = _logged(tlog, capsys, monkeypatch)
    assert got == want
    assert got == ("", "[MAIN] built 1702 windows\n[BATCH] +   11.12s batch 3 of 9\n"
                       "[POST-PROCESS] done\n")


def test_utils_reexports():
    from deepreadmapper_tpu_torch import utils

    assert utils.Tracer is ttrace.Tracer and utils.stage is ttrace.stage
    assert utils.log is tlog.log and utils.set_verbose is tlog.set_verbose


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    """device_trace on the CPU: a Chrome trace in logdir naming the ops
    the block ran."""
    import torch

    logdir = str(tmp_path / "prof")
    with ttrace.device_trace(logdir, cuda=False) as path:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert path == os.path.join(logdir, "device.pt.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in str(e.get("name", "")) for e in events)
