"""The port imports torch and never jax, the JAX package, ml_dtypes or
safetensors (the card's machine has none of them): checked in a fresh
interpreter, and on the package's sources."""

import json
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "scalellm_tpu_torch"
BANNED = ("jax", "jaxlib", "scalellm_tpu", "ml_dtypes", "safetensors")


def test_import_loads_no_jax():
    code = (
        "import json, sys\n"
        "import scalellm_tpu_torch\n"
        "from scalellm_tpu_torch import LLM\n"
        "import scalellm_tpu_torch.llm, scalellm_tpu_torch.engine.llm_engine\n"
        "import scalellm_tpu_torch.models, scalellm_tpu_torch.ops.attention\n"
        "import scalellm_tpu_torch.ops.quant_matmul\n"
        "import scalellm_tpu_torch.quantization.formats\n"
        "import scalellm_tpu_torch.quantization.linear\n"
        "import scalellm_tpu_torch.quantization.runtime\n"
        "import scalellm_tpu_torch.ops.mla_attention, scalellm_tpu_torch.ops.grouped_matmul\n"
        "import scalellm_tpu_torch.layers.moe, scalellm_tpu_torch.models.deepseek\n"
        "import scalellm_tpu_torch.ops.moe_quant, scalellm_tpu_torch.models.common\n"
        "import scalellm_tpu_torch.ops.quant_mlp, scalellm_tpu_torch.ops._build\n"
        "import scalellm_tpu_torch.models.mixtral, scalellm_tpu_torch.models.qwen2_moe\n"
        "import scalellm_tpu_torch.models.qwen2, scalellm_tpu_torch.models.mistral\n"
        "import scalellm_tpu_torch.constrained, scalellm_tpu_torch.constrained.fsm\n"
        "import scalellm_tpu_torch.constrained.guided, scalellm_tpu_torch.constrained.json_schema\n"
        "import scalellm_tpu_torch.constrained.tokenmap, scalellm_tpu_torch.utils.tools\n"
        "import scalellm_tpu_torch.utils.args_override, scalellm_tpu_torch.utils.collect_env\n"
        "import scalellm_tpu_torch.llm_engine\n"
        "from scalellm_tpu_torch import AsyncLLMEngine, OutputStream, OutputAsyncStream\n"
        f"banned = {BANNED!r}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in banned]\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_name_no_jax_import():
    sources = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 24
    names = {p.relative_to(REPO).as_posix() for p in sources}
    assert {"scalellm_tpu_torch/ops/quant_matmul.py",
            "scalellm_tpu_torch/quantization/formats.py",
            "scalellm_tpu_torch/quantization/linear.py",
            "scalellm_tpu_torch/quantization/runtime.py",
            "scalellm_tpu_torch/ops/mla_attention.py",
            "scalellm_tpu_torch/ops/grouped_matmul.py",
            "scalellm_tpu_torch/layers/moe.py",
            "scalellm_tpu_torch/models/deepseek.py",
            "scalellm_tpu_torch/ops/moe_quant.py",
            "scalellm_tpu_torch/ops/quant_mlp.py",
            "scalellm_tpu_torch/models/mixtral.py",
            "scalellm_tpu_torch/models/qwen2_moe.py",
            "scalellm_tpu_torch/models/qwen2.py",
            "scalellm_tpu_torch/models/mistral.py",
            "scalellm_tpu_torch/constrained/__init__.py",
            "scalellm_tpu_torch/constrained/fsm.py",
            "scalellm_tpu_torch/constrained/guided.py",
            "scalellm_tpu_torch/constrained/json_schema.py",
            "scalellm_tpu_torch/constrained/tokenmap.py",
            "scalellm_tpu_torch/utils/tools.py",
            "scalellm_tpu_torch/utils/args_override.py",
            "scalellm_tpu_torch/utils/collect_env.py",
            "scalellm_tpu_torch/llm_engine.py"} <= names
    banned = re.compile(r"^\s*(?:import|from)\s+(" + "|".join(BANNED) + r")\b", re.M)
    for path in sources:
        text = path.read_text()
        assert banned.search(text) is None, path
        assert "scalellm_tpu." not in text, path
