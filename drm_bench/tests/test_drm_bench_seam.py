"""The seam: a run loads nothing of JAX or of the JAX package (compared by
the whole top-level module name: the port's name begins with the JAX
package's), and the plain reference imports nothing of the port."""

import ast
import json
import os
import subprocess
import sys

from drm_bench import harness
from drm_bench.tests.conftest import REPO

_CHILD = """
import json, sys, time
from drm_bench import harness
res, _ = harness.run_cell("ecoli_int8flat.npy8k", 5, 1.0, False, "cpu", time.monotonic(),
                          root=sys.argv[1], tmp=sys.argv[2])
print(json.dumps({"correct": res["correct"],
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_a_run_loads_no_jax(tiny_root, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", _CHILD, tiny_root, str(tmp_path)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert "deepreadmapper_tpu_torch" in got["top"]
    assert not set(got["top"]) & set(harness.BANNED)


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(REPO, "drm_bench", "reference")
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in ("deepreadmapper_tpu_torch",) + harness.BANNED, \
                    f"{name} imports {m}"
    code = ("import sys, drm_bench.reference.judge, drm_bench.control; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    top = set(eval(out.stdout))
    assert not top & {"deepreadmapper_tpu_torch", *harness.BANNED}
