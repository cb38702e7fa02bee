"""Port hygiene: no JAX, no reference package, the card by default.

  * no module under ``src/repro_torch/`` (nor ``chip_smoke.py``) imports
    ``jax`` or ``repro`` — checked on the AST and by importing every port
    module with both blocked;
  * entry points (the engine, the serve and train drivers,
    ``init_quantized``, ``interop``, ``init_decode_cache``,
    ``build_rope_table``, ``make_train_step``, ``init_mamba_state``)
    default to ``device="cuda"`` and raise on a host without a card instead of
    falling back to the CPU;
  * each CUDA source carries its note (TPU kernel replaced, bound, design);
  * ``chip_smoke.py`` alone, or without a card, exits non-zero and prints
    no result line.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_every_port_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in {m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None}\n"
        "print(len(names))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 20


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")


def test_entry_points_default_to_the_card(no_gpu):
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    from repro_torch.quant import convert
    from repro_torch.serving import ServingEngine
    cfg = M.reduce_config(get_config("llama3-8b"), dtype="float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.init_quantized(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_params(cfg)
    qp, plans = convert.init_quantized(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(qp, plans, cfg, batch_size=2, cache_len=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced", "--requests", "1", "--max-new", "2"])
    reqs = serve.main(["--reduced", "--requests", "2", "--max-new", "3",
                       "--device", "cpu", "--cache-len", "32"])
    assert all(len(r.out_tokens) == 3 for r in reqs)


def test_model_helpers_default_to_the_card(no_gpu):
    """The decode caches and the RoPE table are built on the card unless
    the caller asks for the CPU."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import intlayers as il
    from repro_torch.models import inttransformer as it
    from repro_torch.models import model as M
    from repro_torch.serving.kvcache import CacheLayout
    cfg = M.reduce_config(get_config("llama3-8b"), dtype="float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        it.init_decode_cache(cfg, CacheLayout.fit(2, 32, 16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        it.init_decode_cache(cfg, batch=2, cache_len=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        il.build_rope_table(33, cfg.hd, cfg.rope_theta)
    cache = it.init_decode_cache(cfg, batch=2, cache_len=32, device="cpu")
    cos, _ = il.build_rope_table(33, cfg.hd, cfg.rope_theta, device="cpu")
    assert cache[0]["k8"].device.type == cos.device.type == "cpu"


def test_interop_defaults_to_the_card(no_gpu):
    """Weights carried over from the reference land on the card unless the
    caller asks for the CPU, as at every other entry point."""
    import numpy as np
    from repro_torch.interop import from_reference, qparams_from_reference
    tree = {"w": np.ones((2, 3), dtype=np.int8), "b": [np.zeros(3)]}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qparams_from_reference(tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_reference(tree, None)
    qp, plans = from_reference(tree, None, device="cpu")
    assert qp["w"].device.type == "cpu" and qp["b"][0].device.type == "cpu"
    assert plans is None


def test_training_entry_points_default_to_the_card(no_gpu, tmp_path):
    """The train driver, the train step, the float Mamba state and the
    float params carried over from the reference are on the card unless
    the caller asks for the CPU."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.interop import params_from_reference
    from repro_torch.launch import steps, train
    from repro_torch.models import mamba as mb
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--reduced", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])
    assert not any(tmp_path.iterdir())
    cfg = M.reduce_config(get_config("llama3-8b"), dtype="float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.make_train_step(cfg, AdamWConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mb.init_mamba_state(M.reduce_config(get_config("mamba2-130m")), 2)
    tree = {"w": np.ones((2, 3), dtype=np.float32), "b": [np.zeros(3)]}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_reference(tree)
    out = params_from_reference(tree, device="cpu")
    assert out["w"].device.type == "cpu" and out["w"].dtype == torch.float32


def test_default_backend_is_cuda():
    from repro_torch.ops import resolve_ops
    assert resolve_ops().name == "cuda"
    assert resolve_ops("torch_ref").name == "torch_ref"


@pytest.mark.parametrize("src", sorted((PORT / "csrc").glob("*.cu")),
                         ids=lambda p: p.name)
def test_kernel_sources_carry_their_note(src):
    head = src.read_text()[:3000]
    assert "Replaces the TPU kernel" in head
    assert "repro/kernels/" in head
    assert "bound" in head and "Design" in head


def test_build_dir_is_ignored():
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "src/repro_torch/build/" in ignored


def test_chip_smoke_alone_fails_without_result(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
