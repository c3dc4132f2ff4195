"""The port's examples (``examples/torch/``) on the CPU.

* ``quickstart.py --device cpu`` prints the JAX example's table
  (``examples/quickstart.py``, run in a subprocess): the four modes' outer
  counts exactly (sync 59, pfait 72, nfais2 66, nfais5 70), the detected
  and exact residuals within the solver parity bar (rel 1e-5,
  ``tests/test_torch_solver.py``) plus one unit of the third printed
  digit, and every row under ε̃.
* ``shard_runtime_demo.py --device cpu`` (the stacked transport over 4
  shards) runs to its end, every reduction's exact residual under ε̃.
"""
import math
import os
import runpy
import subprocess
import sys
from pathlib import Path


ROOT = Path(__file__).resolve().parents[1]
QUICKSTART_OUTER = {"sync": 59, "pfait": 72, "nfais2": 66, "nfais5": 70}
PARITY_RTOL = 1e-5


def _run_example(name, monkeypatch, capsys) -> str:
    monkeypatch.setattr(sys, "argv", [name, "--device", "cpu"])
    runpy.run_path(str(ROOT / "examples" / "torch" / name), run_name="__main__")
    return capsys.readouterr().out


def _rows(out: str, first: set) -> dict:
    return {line.split()[0]: line.split() for line in out.splitlines()
            if line.split() and line.split()[0] in first}


def _close(got: str, want: str) -> bool:
    """Printed residuals within the parity bar plus one unit of the third
    printed digit (``:.2e``)."""
    g, w = float(got), float(want)
    unit = 10.0 ** (math.floor(math.log10(w)) - 2)
    return abs(g - w) <= PARITY_RTOL * w + unit


def test_quickstart_prints_jax_table(monkeypatch, capsys):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    jax_out = subprocess.run([sys.executable, str(ROOT / "examples" / "quickstart.py")],
                             env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert jax_out.returncode == 0, jax_out.stderr[-4000:]
    want = _rows(jax_out.stdout, set(QUICKSTART_OUTER))
    got = _rows(_run_example("quickstart.py", monkeypatch, capsys), set(QUICKSTART_OUTER))
    assert set(got) == set(want) == set(QUICKSTART_OUTER)
    for mode, outer in QUICKSTART_OUTER.items():
        # mode, ε used, outer, detected r, exact r*, verdict
        g, w = got[mode], want[mode]
        assert int(g[2]) == int(w[2]) == outer, (mode, g, w)
        assert g[1] == w[1] and g[5] == w[5] == "yes", (mode, g, w)
        assert _close(g[3], w[3]) and _close(g[4], w[4]), (mode, g, w)


def test_shard_runtime_demo_runs_on_cpu(monkeypatch, capsys):
    rows = _rows(_run_example("shard_runtime_demo.py", monkeypatch, capsys),
                 {"blocking", "nonblocking", "rdoubling"})
    assert set(rows) == {"blocking", "nonblocking", "rdoubling"}
    for name, row in rows.items():
        assert row[-1] == "yes", row
        assert len(row[3].split("/")) == 4, row
