"""The port imports torch and never jax or the JAX package: checked in a
fresh interpreter, and on the package's sources."""

import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "scalellm_tpu_torch"


def test_import_loads_no_jax():
    code = (
        "import json, sys\n"
        "import scalellm_tpu_torch\n"
        "from scalellm_tpu_torch import LLM\n"
        "import scalellm_tpu_torch.llm, scalellm_tpu_torch.engine.llm_engine\n"
        "import scalellm_tpu_torch.models, scalellm_tpu_torch.ops.attention\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('jaxlib') or m == 'scalellm_tpu'\n"
        "       or m.startswith('scalellm_tpu.')]\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_name_no_jax_import():
    sources = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 20
    for path in sources:
        text = path.read_text()
        assert "import jax" not in text, path
        assert "scalellm_tpu." not in text, path
