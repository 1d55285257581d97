"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of ``repro``, and the modules the port copies
from the reference package have not drifted from it."""
import difflib
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

# copied verbatim, with only ``repro.`` rewritten to ``repro_torch.``
VERBATIM = [
    "streaming/windows.py", "streaming/events.py", "streaming/backend.py",
    "streaming/shards.py", "streaming/synthetic.py", "streaming/joins.py",
    "streaming/sessions.py", "streaming/recovery.py", "streaming/chaos.py",
    "core/tac.py", "core/hints.py", "core/cms.py", "core/prefetch.py",
    "core/policies.py", "core/hint_filter.py", "core/__init__.py",
    "obs/__init__.py", "obs/registry.py", "obs/quality.py", "obs/trace.py",
    "obs/timeseries.py", "obs/health.py", "obs/export.py",
    "serving/__init__.py", "serving/store.py", "serving/metrics.py",
    "configs/__init__.py", "configs/base.py", "configs/registry.py",
    "configs/codeqwen1_5_7b.py", "configs/command_r_35b.py",
    "configs/deepseek_v2_236b.py", "configs/gemma_7b.py",
    "configs/llava_next_mistral_7b.py", "configs/qwen2_5_32b.py",
    "configs/qwen3_moe_30b_a3b.py", "configs/rwkv6_3b.py",
    "configs/seamless_m4t_large_v2.py", "configs/zamba2_2_7b.py",
]
# copied, then edited only to take a ``device`` for the fused plane
EDITED = ["streaming/engine.py", "streaming/nexmark.py", "streaming/ysb.py"]
# copied, then edited only by these replacements (after the two-line header
# that names the edit): page blocks are torch tensors, not jax/numpy arrays
REPLACED = {
    "serving/scheduler.py": [
        ("import jax.numpy as jnp\nimport numpy as np\n",
         "import numpy as np\nimport torch\n"),
        ("jnp.stack([jnp.asarray(d[p])", "torch.stack([torch.as_tensor(d[p])"),
    ],
    "serving/router.py": [
        ("import jax\nimport numpy as np\n", "import numpy as np\nimport torch\n"),
        ("jax.Array", "torch.Tensor"),
        ("rows = np.zeros((n, *shape), dtype)",
         "rows = torch.zeros((n, *shape), dtype=dtype)"),
        ("rows[idx] = np.asarray(blk[name])",
         "rows[torch.from_numpy(idx)] = blk[name]"),
        ("{name: np.asarray(blk)[idx]\n",
         "{name: torch.as_tensor(blk)[\n"
         "                                     torch.from_numpy(idx)]\n"),
        ("Dict[str, np.ndarray]]:", "Dict[str, torch.Tensor]]:"),
        ("List[np.ndarray]] = {}", "List[torch.Tensor]] = {}"),
        ("append(np.asarray(blk))", "append(blk)"),
        ("np.concatenate(parts)", "torch.cat(parts)"),
    ],
    # the supervisor's only jax import is unused
    "runtime/supervisor.py": [
        ("import jax\nimport numpy as np\n", "import numpy as np\n"),
    ],
}

# the port's twins of the reference's tests: the same file after the
# rewrite, under a one-line header
TWINS = ["joins", "sessions", "recovery", "chaos"]

FORBIDDEN = re.compile(r"^\s*(import jax\b|from jax\b|import repro\b|"
                       r"from repro[. ])", re.M)


def rewrite(text: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.", text)


def port_modules():
    return sorted(".".join(p.relative_to(SRC).with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def test_every_module_imports_with_jax_and_repro_blocked():
    blocker = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"sys.path.insert(0, {str(SRC)!r})\n"
        "import importlib\n"
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'repro')\n"
        "               for k in sys.modules)\n"
        "print('imported', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", blocker], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_the_import_scan_covers_every_port_package():
    packages = {m.split(".")[1] for m in port_modules() if "." in m}
    assert {"checkpoint", "core", "data", "kernels", "launch", "models",
            "obs", "optim", "runtime", "serving", "streaming"} <= packages
    assert "repro_torch.checkpoint.manager" in port_modules()
    assert {"repro_torch.optim.adamw", "repro_torch.data.pipeline",
            "repro_torch.launch.steps", "repro_torch.launch.train",
            "repro_torch.runtime.supervisor"} <= set(port_modules())


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
           for p in files for m in FORBIDDEN.finditer(p.read_text())]
    assert not bad, bad


def test_the_scans_backward_wrappers_stand_alone():
    """K7's and K8's backward (the ``autograd.Function``s, the plain and
    kernel backwards) live in the scan wrappers that the import scan above
    blocks ``jax`` and ``repro`` for, and bind only the port's own CUDA
    sources."""
    mods = {"repro_torch.kernels.mamba2_scan.mamba2_scan":
            ("Mamba2Scan", "mamba2_scan_backward",
             "mamba2_scan_backward_plain", "mamba2_scan_bwd"),
            "repro_torch.kernels.rwkv6_scan.rwkv6_scan":
            ("RWKV6Scan", "rwkv6_scan_backward",
             "rwkv6_scan_backward_plain", "rwkv6_scan_bwd")}
    assert set(mods) <= set(port_modules())
    for mod, names in mods.items():
        path = SRC / (mod.replace(".", "/") + ".py")
        text = path.read_text()
        assert not FORBIDDEN.search(text), mod
        for name in names[:3]:
            assert re.search(rf"^(class|def) {name}\b", text, re.M), name
        assert f'cuda_build.load("{names[3]}")' in text
        assert (PORT / "csrc" / f"{names[3]}.cu").exists()


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_has_not_drifted(rel):
    ref = (SRC / "repro" / rel).read_text()
    assert (PORT / rel).read_text() == rewrite(ref), \
        f"repro_torch/{rel} drifted from repro/{rel}; copy it again"


@pytest.mark.parametrize("name", TWINS)
def test_twin_tests_have_not_drifted(name):
    ref = (ROOT / "tests" / f"test_{name}.py").read_text()
    first, twin = (ROOT / "tests" / f"test_torch_{name}.py").read_text() \
        .split("\n", 1)
    assert first.startswith(f"# The port's twin of tests/test_{name}.py")
    assert twin == rewrite(ref), \
        f"tests/test_torch_{name}.py drifted from tests/test_{name}.py"


def strip_device(text: str) -> str:
    """Undo the copy's edits: the ``device`` parameter, its forwarding
    and the attribute that holds it."""
    text = re.sub(r",\s*device(: str)?\s*=\s*(\"cuda\"|self\.device|device)",
                  "", text)
    text = text.replace(", device)", ")")
    return text.replace("        self.device = device\n", "")


@pytest.mark.parametrize("rel", EDITED)
def test_edited_copy_differs_only_in_device(rel):
    ref = rewrite((SRC / "repro" / rel).read_text())
    first, port = (PORT / rel).read_text().split("\n", 1)
    assert first.startswith(f"# Copy of repro/{rel}; differs only in")
    assert "`device`" in first
    assert "device" in port
    diff = "".join(difflib.unified_diff(
        ref.splitlines(True), strip_device(port).splitlines(True), n=0))
    assert not diff, f"repro_torch/{rel} drifted beyond `device`:\n{diff}"


@pytest.mark.parametrize("rel", sorted(REPLACED))
def test_replaced_copy_differs_only_in_listed_edits(rel):
    ref = rewrite((SRC / "repro" / rel).read_text())
    for old, new in REPLACED[rel]:
        assert old in ref, f"edit {old!r} no longer applies to repro/{rel}"
        ref = ref.replace(old, new)
    first, _, port = (PORT / rel).read_text().split("\n", 2)
    assert first.startswith(f"# Copy of repro/{rel}; differs only")
    diff = "".join(difflib.unified_diff(ref.splitlines(True),
                                        port.splitlines(True), n=0))
    assert not diff, f"repro_torch/{rel} drifted beyond its edits:\n{diff}"


def test_shard_owner_map_copy_has_not_drifted():
    from repro.launch import sharding as ref
    from repro_torch.launch import sharding as port
    assert inspect.getsource(port.shard_owner_map) == \
        inspect.getsource(ref.shard_owner_map)


@pytest.mark.parametrize("name", ["delta_encode_keys", "delta_decode_keys",
                                  "hint_batch_nbytes"])
def test_codec_copy_has_not_drifted(name):
    from repro.runtime import compression as ref
    from repro_torch.runtime import compression as port
    assert inspect.getsource(getattr(port, name)) == \
        inspect.getsource(getattr(ref, name))
    assert port._ESCAPE == ref._ESCAPE and port._U64_MAX == ref._U64_MAX
