"""The reference engine's observability report on the port:
``tools/obs_report_torch.py --fused --device cpu`` (the q5 smoke pipeline
on the port's fused plane, its keyed state on the CPU) prints what
``tools/obs_report.py --fused`` prints on the same simulated run: the
critical-path stage table, the hint quality, the evictions and the fused
hot path's rollup, line for line.  Short runs (1 s of simulated stream
after 0.5 s of warm-up)."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--fused", "--duration", "1.0", "--warmup", "0.5"]


def start_tool(name, args, env):
    return subprocess.Popen([sys.executable, str(ROOT / "tools" / name),
                             *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)


def output(proc) -> str:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-2000:]
    return out


def test_fused_report_on_the_port_is_the_references():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    procs = [start_tool("obs_report.py", ARGS, env),     # side by side
             start_tool("obs_report_torch.py", ARGS + ["--device", "cpu"],
                        env)]
    ref, port = (output(p) for p in procs)
    assert "critical-path stages" in ref and "fused hot path:" in ref
    assert "batch-fill" in ref
    assert port.splitlines() == ref.splitlines()
