"""``python -m repro_torch.launch.serve`` on the CPU: the sequential kernel
path runs, prints the b̂ that the reference's SCA gives for the same
problem, the batched engine (the default, eager and ``--compiled``) prints
the reference's lines, the decode mode prints the reference's lines and
passes its own parity check, and every mode not ported yet exits 2 with
one line."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

from repro.configs import get_smoke
from repro.core import codesign as jcd
from repro.core.cost_model import SystemParams
from repro_torch.launch.serve import main

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_module_entry_point_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--engine", "sequential", "--path", "kernel", "--device", "cpu",
         "--batch", "2", "--seq", "16"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "agent_path=" in out.stdout


def test_sequential_kernel_path_prints_reference_b_hat(capsys):
    # a deadline tight enough for the smoke model's FLOPs that (P1)
    # lands on b̂ = 8, which the kernel path serves int8-resident
    rc = main(["--smoke", "--engine", "sequential", "--path", "kernel",
               "--device", "cpu", "--t0", "0.00027", "--e0", "1.0"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    lam = float(re.search(r"lambda_hat=([0-9.]+)", out.out).group(1))
    b_hat = int(re.search(r"codesign: b_hat=(\d+)", out.out).group(1))
    cfg = get_smoke("qwen2-0.5b")
    per_layer = cfg.active_param_count() / cfg.n_layers
    tokens = 4 * 64
    sysp = SystemParams(
        n_flop_agent=2.0 * per_layer * cfg.split_layer * tokens,
        n_flop_server=2.0 * per_layer * (cfg.n_layers - cfg.split_layer)
        * tokens)
    sol = jcd.solve_sca(lam, sysp, 0.00027, 1.0, b_max=16, b_emb=8)
    assert b_hat == sol.b_hat == 8
    assert "agent_path=kernel-int8" in out.out
    assert "served batch (4, 64): logits (4, 64, 512)" in out.out


def test_decode_mode_runs_with_parity_check():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--decode", "--device", "cpu", "--max-new", "4", "--requests", "4",
         "--parity-check"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("arch=qwen2-0.5b-smoke split=1/4 ")
    assert "engine=decode max_batch=4 max_new=4 admission=continuous" \
        in lines[0]
    assert lines[1] == "warmup: 0 decode variants compiled in 0.0s"
    assert re.match(r"  class realtime +\(T0=1\.17s, E0=1\.00J\): b_hat=\d+ "
                    r"b_kv=(4|8|16) ", lines[2])
    assert lines[3].startswith("  class interactive  (T0=3.50s, E0=2.00J)")
    assert "served 4 requests, 16 tokens in " in out.stdout
    assert re.search(r"  \[realtime    \] n=2 b_kv=\d+ ttft=", out.stdout)
    assert "decode report: throughput=" in out.stdout
    assert "compile cache: 0 variants, 0 hits / 0 misses" in out.stdout
    assert lines[-1] == ("parity: all 4 requests bitwise-match the "
                         "sequential reference")


@pytest.mark.parametrize("args", [
    ("--mixed-precision",), ("--engine", "sequential", "--env-trace",
                             "wifi-markov"),
    ("--decode", "--speculative"),
    ("--engine", "sequential", "--fleet", "spec.json"),
])
def test_unported_modes_exit_2(capsys, args):
    assert main(["--smoke", "--device", "cpu", *args]) == 2
    err = capsys.readouterr().err
    assert "not yet ported" in err
    assert len(err.strip().splitlines()) == 1


def test_unported_arch_exits_2(capsys):
    assert main(["--arch", "stablelm-3b", "--engine", "sequential",
                 "--device", "cpu", "--smoke"]) == 2
    assert "not yet ported" in capsys.readouterr().err


@pytest.mark.parametrize("compiled", [False, True])
def test_batched_mode_prints_reference_lines(capsys, compiled):
    """The default engine, batched, on the kernel path: the reference's
    lines, and with --compiled every batch after warm-up a cache hit."""
    rc = main(["--smoke", "--device", "cpu", "--path", "kernel",
               "--requests", "6"] + (["--compiled"] if compiled else []))
    out = capsys.readouterr()
    assert rc == 0, out.err
    lines = out.out.splitlines()
    assert lines[0].startswith("arch=qwen2-0.5b-smoke split=1/4 ")
    assert (f"path=kernel engine=batched max_batch=4 mixed_precision=False "
            f"compiled={compiled} device=cpu") in lines[0]
    if compiled:
        assert re.match(r"warmup: \d+ forward variants compiled in ",
                        lines[1])
        lines.pop(1)
    assert re.match(r"  class realtime +\(T0=1\.17s, E0=1\.00J\): b_hat=",
                    lines[1])
    assert lines[4].startswith("served 6 requests in ")
    assert re.search(r"  \[realtime    \] n=2 b_hat=\s*\d+ \(", out.out)
    assert "report: mean_batch=" in out.out
    assert "codesign cache: 3 (P1) solves for 6 requests (0 hits)" in out.out
    if compiled:
        m = re.search(r"compile cache: (\d+) variants, (\d+) hits / (\d+) "
                      r"misses", out.out)
        assert m and int(m.group(3)) == int(m.group(1)) > 0
