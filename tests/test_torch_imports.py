"""The port stands alone: no JAX, nothing of ``repro``, and no silent CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "examples" /
                                         "train_e2e_torch.py"]


def test_every_module_imports_with_jax_and_repro_blocked():
    code = "\n".join([
        "import sys, importlib",
        "sys.modules['jax'] = None",
        "sys.modules['repro'] = None",
        *(f"importlib.import_module({m!r})" for m in _port_modules()),
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))",
        "               for m, v in sys.modules.items() if v is not None)",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ,
                                   PYTHONPATH=str(ROOT / "src")),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_cuda_is_required_unless_cpu_is_asked_for():
    from repro_torch.device import resolve_device
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
        from repro_torch.launch import serve
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(["--reduced"])
        from repro_torch.launch import train
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--reduced"])


def test_full_width_qwen3_8b_param_count_from_shapes():
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import model_defs
    from repro_torch.models.params import param_count
    cfg = get_config("qwen3-8b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size) == (36, 4096, 32, 8, 12_288, 151_936)
    assert param_count(model_defs(cfg)) == 8_190_735_360


def test_unported_archs_raise_and_name_the_roadmap():
    """Every arch of the JAX package is ported (zamba2-7b and whisper-medium
    last): the registry holds all thirteen, and only an arch or a family
    the JAX package does not have either is refused."""
    from repro_torch.configs import get_config, list_configs
    from repro_torch.models.model_zoo import model_defs
    assert list_configs() == [
        "granite-20b", "granite-moe-3b-a800m", "paper-llama-12b",
        "paper-mixtral-8x7b", "paper-tmoe-25b", "pixtral-12b", "qwen3-32b",
        "qwen3-8b", "qwen3-moe-30b-a3b", "rwkv6-3b", "whisper-medium",
        "yi-9b", "zamba2-7b"]
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
    moe = get_config("qwen3-8b").replace(family="moe", num_experts=8,
                                         experts_per_token=2)
    assert set(model_defs(moe)["layers"]) == {"attn_norm", "attn",
                                              "mlp_norm", "moe"}
    assert set(model_defs(get_config("zamba2-7b"))) == {
        "embed", "blocks", "shared_attn", "final_norm", "unembed", "tail"}
    assert set(model_defs(get_config("whisper-medium"))) == {
        "embed", "enc_layers", "enc_norm", "dec_layers", "final_norm",
        "unembed"}
    with pytest.raises(ValueError, match="unknown family"):
        model_defs(get_config("qwen3-8b").replace(family="diffusion"))
