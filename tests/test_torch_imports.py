"""The port and its examples import neither JAX nor anything of the JAX
package."""

import _torch_threads  # noqa: F401  (first: one torch thread)
import ast
import importlib
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
# the port's examples (beside the reference's, which import the reference)
EXAMPLES = [ROOT / "examples" / f"torch_{name}.py"
            for name in ("train_lm", "fault_tolerant_training", "quickstart",
                         "co_inference_serve", "decode_serve",
                         "speculative_serve", "adaptive_serve",
                         "fleet_serve")]


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_pulls_in_no_jax():
    mods = list(_modules())
    for m in ("repro_torch.runtime.serve_engine", "repro_torch.kernels.flash",
              "repro_torch.optim", "repro_torch.optim.adamw",
              "repro_torch.optim.grad_compress", "repro_torch.data.loader",
              "repro_torch.runtime.train_loop", "repro_torch.launch.train",
              "repro_torch.obs", "repro_torch.obs.trace",
              "repro_torch.obs.metrics", "repro_torch.obs.report",
              "repro_torch.core.distortion",
              "repro_torch.core.rate_distortion",
              "repro_torch.core.mixed_precision", "repro_torch.models.fcdnn",
              "repro_torch.configs.fcdnn16", "repro_torch.configs.blip2_proxy",
              "repro_torch.configs.git_proxy", "repro_torch.env",
              "repro_torch.env.environment", "repro_torch.env.processes",
              "repro_torch.env.faults", "repro_torch.env.presets",
              "repro_torch.runtime.speculative",
              "repro_torch.runtime.adaptive", "repro_torch.core.fleet",
              "repro_torch.runtime.fleet_engine",
              "repro_torch.runtime.supervisor",
              "repro_torch.runtime.fault_tolerance",
              "repro_torch.checkpoint", "repro_torch.checkpoint.store",
              "repro_torch.configs.stablelm_3b", "repro_torch.models.moe",
              "repro_torch.configs.granite_34b",
              "repro_torch.configs.internlm2_20b",
              "repro_torch.configs.llava_next_mistral_7b",
              "repro_torch.configs.qwen3_moe_235b_a22b",
              "repro_torch.configs.kimi_k2_1t_a32b",
              "repro_torch.data", "repro_torch.data.synthetic",
              "repro_torch.models.ssm", "repro_torch.models.xlstm_model",
              "repro_torch.models.hybrid", "repro_torch.models.encdec",
              "repro_torch.models.registry",
              "repro_torch.configs.xlstm_350m",
              "repro_torch.configs.jamba_1_5_large_398b",
              "repro_torch.configs.seamless_m4t_large_v2",
              "repro_torch.launch.mesh", "repro_torch.parallel",
              "repro_torch.parallel.sharding",
              "repro_torch.launch.dryrun", "repro_torch.launch.opcount",
              "repro_torch.launch.roofline",
              "repro_torch.kernels.tc_gemm"):
        assert m in mods, m
    code = ("import importlib, runpy, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            f"for path in {[str(p) for p in EXAMPLES]!r}:\n"
            "    runpy.run_path(path, run_name='not_main')\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_jax_or_reference_import_in_source():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)\b"
                     r"(?!_torch))", re.MULTILINE)
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if pat.search(p.read_text(encoding="utf-8"))]
    offenders += [str(p.relative_to(ROOT))
                  for p in [ROOT / "chip_smoke.py", *EXAMPLES]
                  if p.is_file() and pat.search(p.read_text("utf-8"))]
    assert offenders == []
    assert all(p.is_file() for p in EXAMPLES)


def test_core_exports_the_reference_core_api():
    """``repro_torch.core`` exports every name ``repro/core/__init__.py``
    imports, each the object of the port's module of the same name."""
    tree = ast.parse((ROOT / "src" / "repro" / "core" / "__init__.py")
                     .read_text("utf-8"))
    names = [(node.module, a.name) for node in tree.body
             if isinstance(node, ast.ImportFrom) for a in node.names]
    assert len(names) > 50
    core = importlib.import_module("repro_torch.core")
    for module, name in names:
        mod = importlib.import_module(f"repro_torch.core.{module}")
        assert getattr(core, name) is getattr(mod, name), name
        assert name in core.__all__
    assert sorted(core.__all__) == sorted(n for _, n in names)
