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
    "streaming/shards.py",
    "core/tac.py", "core/hints.py", "core/cms.py", "core/prefetch.py",
    "core/policies.py", "core/hint_filter.py", "core/__init__.py",
    "obs/__init__.py", "obs/registry.py", "obs/quality.py", "obs/trace.py",
    "obs/timeseries.py", "obs/health.py", "obs/export.py",
]
# copied, then edited only to take a ``device`` for the fused plane
EDITED = ["streaming/engine.py", "streaming/nexmark.py", "streaming/ysb.py"]

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


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
           for p in files for m in FORBIDDEN.finditer(p.read_text())]
    assert not bad, bad


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_has_not_drifted(rel):
    ref = (SRC / "repro" / rel).read_text()
    assert (PORT / rel).read_text() == rewrite(ref), \
        f"repro_torch/{rel} drifted from repro/{rel}; copy it again"


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


@pytest.mark.parametrize("name", ["delta_encode_keys", "delta_decode_keys",
                                  "hint_batch_nbytes"])
def test_codec_copy_has_not_drifted(name):
    from repro.runtime import compression as ref
    from repro_torch.runtime import compression as port
    assert inspect.getsource(getattr(port, name)) == \
        inspect.getsource(getattr(ref, name))
    assert port._ESCAPE == ref._ESCAPE and port._U64_MAX == ref._U64_MAX
