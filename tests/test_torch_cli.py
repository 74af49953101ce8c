"""``python -m repro_torch.launch.serve`` on the CPU: the sequential kernel
path runs, prints the b̂ that the reference's SCA gives for the same
problem, the batched engine (the default, eager and ``--compiled``) prints
the reference's lines, the decode and speculative modes print the
reference's lines (a non-zero warm-up) and pass their own parity check,
the adaptive mode runs under each policy, the fleet mode serves
``examples/fleet_spec.json``, ``--chaos-trace`` runs the batched, decode
and fleet modes under the serving supervisor (and bare), every mode writes
a loadable ``--trace-out`` and ``--metrics-out``, and each of the
reference's exit-2 contracts exits 2 with one line (the xLSTM, hybrid and
encoder-decoder families in every mode, with the reference's own
lines)."""

import _torch_threads  # noqa: F401  (first: one torch thread)
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

from repro.configs import get_smoke
from repro.core import codesign as jcd
from repro.core import mixed_precision as jmp
from repro.core.cost_model import SystemParams
from repro_torch.launch.serve import main
from repro_torch.obs import validate_chrome_trace

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
    # per class at --seq 64 --max-new 4: four token steps (cache buckets
    # 16..128) and nine (prompt, cache) prefill pairs
    m = re.match(r"warmup: (\d+) decode variants compiled in ", lines[1])
    assert m and int(m.group(1)) == 2 * (4 + 9)
    n_warm = int(m.group(1))
    assert re.match(r"  class realtime +\(T0=1\.17s, E0=1\.00J\): b_hat=\d+ "
                    r"b_kv=(4|8|16) ", lines[2])
    assert lines[3].startswith("  class interactive  (T0=3.50s, E0=2.00J)")
    assert "served 4 requests, 16 tokens in " in out.stdout
    assert re.search(r"  \[realtime    \] n=2 b_kv=\d+ ttft=", out.stdout)
    assert "decode report: throughput=" in out.stdout
    # after warm-up the traffic only hits (the parity check's batch-1
    # oracle shares the engine's cache but runs after this line)
    m = re.search(r"compile cache: (\d+) variants, (\d+) hits / (\d+) "
                  r"misses", out.stdout)
    assert m and int(m.group(1)) == int(m.group(3)) == n_warm
    assert int(m.group(2)) > 0
    assert lines[-1] == ("parity: all 4 requests bitwise-match the "
                         "sequential reference")


def reference_refusal(arch, compiled=False, decode=False,
                      speculative=False):
    """The reference serve CLI's one-line refusal of ``arch`` for an
    invocation (its ``unsupported_model_reason`` on its own model, which
    is the line its CLI prints after ``error: ``), or None."""
    from repro.launch.serve import unsupported_model_reason
    from repro.models.registry import build_model
    return unsupported_model_reason(build_model(get_smoke(arch)), arch,
                                    compiled, decode=decode,
                                    speculative=speculative)


@pytest.mark.parametrize("case", ["fleet-unported-arch",
                                  "chaos-sequential"])
def test_unported_modes_exit_2(capsys, tmp_path, case):
    """The fleet and chaos modes are ported; what exits 2 with one line,
    as in the reference: a fleet agent of a family the serving engines do
    not take (xlstm-350m: the reference's own refusal, no ``run_layers``),
    and ``--chaos-trace`` with ``--engine sequential`` (no queue to
    supervise)."""
    if case == "fleet-unported-arch":
        spec = tmp_path / "fleet.json"
        spec.write_text(json.dumps({"agents": [
            {"name": "drone", "arch": "qwen2-0.5b"},
            {"name": "big", "arch": "xlstm-350m"}]}))
        args, needle = ("--fleet", str(spec)), \
            f"error: fleet agent 'big': {reference_refusal('xlstm-350m')}"
        assert "XLSTMModel lacks run_layers" in needle
    else:
        args, needle = ("--engine", "sequential", "--chaos-trace",
                        str(ROOT / "examples" / "chaos_spec.json")), \
            "--chaos-trace needs a queued engine"
    assert main(["--smoke", "--device", "cpu", *args]) == 2
    err = capsys.readouterr().err
    assert needle in err, err
    assert len(err.strip().splitlines()) == 1


def test_speculative_mode_runs_with_parity_check(capsys):
    """``--decode --speculative``: the reference's lines (the class's draft
    schedule, the ``speculative:`` report), a warm-up of one draft and one
    verify step per cache bucket and the prefill pairs per class, no
    capture while serving, and its own parity check."""
    rc = main(["--smoke", "--decode", "--speculative", "--device", "cpu",
               "--max-new", "4", "--requests", "4", "--parity-check"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    lines = out.out.splitlines()
    assert "engine=speculative max_batch=4 max_new=4 admission=continuous" \
        in lines[0]
    # per class at --seq 64 --max-new 4: 2 x 4 cache buckets + 9 pairs
    m = re.match(r"warmup: (\d+) decode variants compiled in ", lines[1])
    assert m and int(m.group(1)) == 2 * (2 * 4 + 9)
    for line, name in zip(lines[2:4], ("realtime", "interactive")):
        assert re.match(rf"  class {name} +\(T0=\d+\.\d\ds, "
                        r"E0=\d+\.\d\dJ\): b_hat=\d+ b_kv=(4|8|16) f=.* "
                        r"b_draft=4 k=4$", line), line
    assert "served 4 requests, 16 tokens in " in out.out
    m = re.search(r"compile cache: (\d+) variants, (\d+) hits / (\d+) "
                  r"misses", out.out)
    assert m and int(m.group(1)) == int(m.group(3)) == 34
    assert re.search(r"^speculative: \d+ rounds, acceptance=\d\.\d\d, "
                     r"accepted/round=\d+\.\d\d, tokens/round=\d+\.\d\d$",
                     out.out, re.MULTILINE)
    assert lines[-1] == ("parity: all 4 requests bitwise-match the "
                         "sequential reference")


@pytest.mark.parametrize("policy", ["static", "adaptive", "oracle"])
def test_env_trace_mode_runs_under_each_policy(capsys, policy):
    """``--env-trace wifi-markov``: the reference's lines; the static
    controller never replans, the others log each replan."""
    rc = main(["--smoke", "--device", "cpu", "--env-trace", "wifi-markov",
               "--adaptive-policy", policy])
    out = capsys.readouterr()
    assert rc == 0, out.err
    lines = out.out.splitlines()
    assert lines[0] == ("arch=qwen2-0.5b-smoke env=wifi-markov (seed 0, "
                        f"120 x 0.5s) policy={policy} engine=adaptive")
    assert re.match(r"  class realtime +\(T0=1\.17s, E0=1\.00J\): "
                    r"b_hat=\d+ f=", lines[1])
    assert lines[3] == "served 12 requests in 12 batches:"
    m = re.search(r"^adaptive report: replans=(\d+) \(switches=\d+, "
                  r"degraded=\d+\) deadline violations=\d+/12 "
                  r"weight variants=\d+ env keys=(\d+)$", out.out,
                  re.MULTILINE)
    assert m
    events = [x for x in lines if re.match(r"  t= *\d+\.\d\ds \[", x)]
    assert len(events) == int(m.group(1))
    if policy == "static":
        assert m.group(1) == "0" and m.group(2) == "1"
    else:
        assert int(m.group(1)) >= 1


@pytest.mark.parametrize("args,needle", [
    (("--draft-bits", "3"), "draft ladder"),
    (("--lookahead", "0"), "--lookahead"),
])
def test_speculative_bad_schedule_exits_2(capsys, args, needle):
    assert main(["--smoke", "--device", "cpu", "--speculative", *args]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and needle in err
    assert len(err.strip().splitlines()) == 1


def test_speculative_without_decode_protocol_exits_2(capsys, monkeypatch):
    """A model whose decode state is not the [L, B, T, KV, dh] cache:
    ``--speculative`` names itself and the arch in one line."""
    from repro_torch.launch import serve
    from repro_torch.models.lm import DecoderLM

    class NoKVCache(DecoderLM):
        def cache_axes(self):
            return {"state": ("layers", "batch", "d_model")}

    monkeypatch.setattr(serve, "build_model", NoKVCache)
    assert main(["--smoke", "--device", "cpu", "--speculative"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error: --speculative does not support arch "
                          "qwen2-0.5b: decode state is not the ")
    assert len(err.strip().splitlines()) == 1


def test_mixed_precision_sequential_prints_reference_line(capsys):
    """``--mixed-precision`` in the sequential mode: the reference's
    ``mixed codesign`` line; the smoke model has one agent layer, so the
    allocation is the best uniform width the reference's frontier gives."""
    rc = main(["--smoke", "--engine", "sequential", "--path", "kernel",
               "--device", "cpu", "--t0", "0.00027", "--e0", "1.0",
               "--mixed-precision"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    m = re.search(r"^mixed codesign: bits=\[(\d+)\] \(mean (\d+\.\d\d), "
                  r"uniform best b_hat=(\d+)\) f=\d+\.\d\dGHz "
                  r"f~=\d+\.\d\dGHz bound=\S+ \(uniform \S+\) "
                  r"T=\d+\.\d{3}s E=\d+\.\d{3}J agent_path=(\S+)$",
                  out.out, re.MULTILINE)
    assert m, out.out
    cfg = get_smoke("qwen2-0.5b")
    per_layer = cfg.active_param_count() / cfg.n_layers
    sysp = SystemParams(
        n_flop_agent=2.0 * per_layer * cfg.split_layer * 4 * 64,
        n_flop_server=2.0 * per_layer * (cfg.n_layers - cfg.split_layer)
        * 4 * 64)
    want = jmp.best_uniform_bits(sysp, 0.00027, 1.0, b_emb=8)
    assert int(m.group(1)) == int(m.group(3)) == want == 8
    assert m.group(2) == "8.00" and m.group(4) == "kernel-int8"
    assert "served batch (4, 64): logits (4, 64, 512)" in out.out


def test_mixed_precision_batched_compiled_prints_reference_lines(capsys):
    """The batched engine with ``--mixed-precision --compiled``: the
    reference's per-class allocation lines and per-batch bit lists; the
    interactive class's one-layer plan at 6 bits stays a kernel plan."""
    rc = main(["--smoke", "--device", "cpu", "--path", "kernel",
               "--requests", "6", "--compiled", "--mixed-precision",
               "--t0", "0.00022", "--e0", "0.02"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    lines = out.out.splitlines()
    assert ("path=kernel engine=batched max_batch=4 mixed_precision=True "
            "compiled=True device=cpu") in lines[0]
    assert re.match(r"warmup: \d+ forward variants compiled in ", lines[1])
    for line, name in zip(lines[2:5], ("realtime", "interactive", "batch")):
        assert re.match(rf"  class {name} +\(T0=\d+\.\d\ds, E0=\d+\.\d\dJ\): "
                        r"bits=\[\d+(, \d+)*\] \(mean \d+\.\d\d\) "
                        r"f=\d+\.\d\dGHz f~=\d+\.\d\dGHz bound=\S+ "
                        r"\(uniform b_hat=\d+: \S+\)$", line), line
    assert "bits=[6] (mean 6.00)" in lines[3]
    assert re.search(r"  \[interactive \] n=2 b_hat=6 \(kernel-mixed\[6\]\) ",
                     out.out)
    assert "codesign cache: 3 (P1) solves for 6 requests (0 hits)" in out.out
    m = re.search(r"compile cache: (\d+) variants, (\d+) hits / (\d+) "
                  r"misses", out.out)
    assert m and int(m.group(3)) == int(m.group(1)) > 0


def test_mixed_precision_decode_passes_its_parity_check(capsys):
    rc = main(["--smoke", "--decode", "--device", "cpu", "--max-new", "4",
               "--requests", "4", "--parity-check", "--mixed-precision"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    lines = out.out.splitlines()
    assert re.match(r"  class realtime +\(T0=1\.17s, E0=1\.00J\): "
                    r"b_hat=\d+(/\d+)* b_kv=(4|8|16) f=", lines[2])
    assert lines[-1] == ("parity: all 4 requests bitwise-match the "
                         "sequential reference")


@pytest.mark.parametrize("arch", ["blip2-proxy", "git-proxy"])
def test_paper_proxies_serve_mixed_precision(capsys, arch):
    rc = main(["--arch", arch, "--smoke", "--engine", "sequential",
               "--path", "kernel", "--device", "cpu", "--batch", "2",
               "--seq", "16", "--mixed-precision"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    assert out.out.startswith(f"arch={arch} split=1/")
    assert "mixed codesign: bits=[" in out.out
    assert "served batch (2, 16): logits (2, 16, 512)" in out.out


def test_fcdnn_arch_exits_2(capsys):
    assert main(["--arch", "fcdnn-16", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "has no servable model config" in err
    assert len(err.strip().splitlines()) == 1


def test_unported_arch_exits_2(capsys):
    """xlstm-350m is registered, but co-inference needs ``run_layers``:
    the sequential engine refuses it with the reference's own line; an
    arch name the registry does not know exits 2 too."""
    assert main(["--arch", "xlstm-350m", "--engine", "sequential",
                 "--device", "cpu", "--smoke"]) == 2
    err = capsys.readouterr().err
    assert err == f"error: {reference_refusal('xlstm-350m')}\n"
    assert main(["--arch", "xlstm-350m-v0", "--device", "cpu",
                 "--smoke"]) == 2
    err = capsys.readouterr().err
    assert "unknown arch 'xlstm-350m-v0'" in err
    assert len(err.strip().splitlines()) == 1


NEW_FAMILIES = ("xlstm-350m", "jamba-1.5-large-398b",
                "seamless-m4t-large-v2")


@pytest.mark.parametrize("mode", ["sequential", "batched", "decode",
                                  "speculative", "compiled"])
@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_new_families_refused_with_the_references_line(capsys, arch, mode):
    """The serving engines take ``DecoderLM`` only, as the reference's:
    the xLSTM, hybrid and encoder-decoder models lack ``run_layers``, the
    decode protocol (``decode_step_q``) and the compiled path's hooks, and
    every mode exits 2 with the reference's own line for it."""
    flags = {"sequential": ["--engine", "sequential"], "batched": [],
             "decode": ["--decode"],
             "speculative": ["--decode", "--speculative"],
             "compiled": ["--compiled"]}[mode]
    assert main(["--arch", arch, "--smoke", "--device", "cpu",
                 *flags]) == 2
    want = reference_refusal(arch, compiled=mode == "compiled",
                             decode=mode in ("decode", "speculative"),
                             speculative=mode == "speculative")
    assert want is not None
    assert capsys.readouterr().err == f"error: {want}\n"


def test_stablelm_serves(capsys):
    """stablelm-3b is registered: its smoke config serves on the kernel
    path (LayerNorm, 4 heads of 16 over 4 KV heads)."""
    assert main(["--arch", "stablelm-3b", "--engine", "sequential",
                 "--path", "kernel", "--device", "cpu", "--smoke",
                 "--batch", "2", "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("arch=stablelm-3b-smoke split=1/4 ")


FLEET_SPEC = str(ROOT / "examples" / "fleet_spec.json")
CHAOS_SPEC = str(ROOT / "examples" / "chaos_spec.json")


@pytest.mark.parametrize("allocator", [None, "equal"])
def test_fleet_mode_prints_reference_lines(capsys, allocator):
    """``--fleet examples/fleet_spec.json``: the reference's lines, one per
    agent (share, b̂, the environment of the adaptive member), every
    agent's six requests served, shares summing to one."""
    extra = ["--allocator", allocator] if allocator else []
    assert main(["--fleet", FLEET_SPEC, "--smoke", "--device", "cpu",
                 *extra]) == 0
    out = capsys.readouterr().out
    want = allocator or "joint"
    assert f"fleet: 3 agents, allocator={want} max_batch=4 path=fake" in out
    shares = [float(x) for x in re.findall(r"share=([0-9.]+) ", out)]
    assert len(shares) == 3 and abs(sum(shares) - 1.0) < 2e-3
    assert re.search(r"  agent kiosk .* env=Environment", out)
    for name in ("drone", "monitor", "kiosk"):
        assert re.search(rf"  agent {name}\s+n=6 batches=\d+ ", out), name
    assert "served 18 requests in " in out
    assert "shared codesign cache: " in out


@pytest.mark.parametrize("mode", ["batched", "decode", "fleet"])
@pytest.mark.parametrize("bare", [False, True])
def test_chaos_trace_modes(capsys, mode, bare):
    """``--chaos-trace examples/chaos_spec.json``: the mode's own lines,
    then the reference's resilience line; supervised runs deliver or shed
    every request and lose no decode token; ``--chaos-bare`` reports the
    bare baseline."""
    args = {"batched": ["--path", "kernel"],
            "decode": ["--decode", "--max-new", "4", "--requests", "4",
                       "--seq", "16"],
            "fleet": ["--fleet", FLEET_SPEC]}[mode]
    assert main(["--smoke", "--device", "cpu", "--chaos-trace", CHAOS_SPEC,
                 *args] + (["--chaos-bare"] if bare else [])) == 0
    out = capsys.readouterr().out
    m = re.search(r"resilience \[(\w+)\]: delivered (\d+)/(\d+) \(failed "
                  r"(\d+), shed (\d+)\) .* tokens lost/dup=(\d+)/(\d+) "
                  r"goodput=", out)
    assert m, out
    kind, got, total, failed, shed, lost, dup = m.groups()
    assert kind == ("bare" if bare else "supervised")
    assert int(got) + int(failed) + int(shed) == int(total) > 0
    assert int(dup) == 0
    if not bare:
        assert int(failed) == 0 and int(lost) == 0


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


@pytest.mark.parametrize("mode,spans", [
    (("--path", "kernel", "--requests", "4", "--compiled"),
     {"batch.assemble", "batch.forward", "forward.capture"}),
    (("--engine", "sequential", "--path", "kernel", "--compiled", "--batch",
      "2", "--seq", "16"), {"forward.capture"}),
    (("--decode", "--max-new", "3", "--requests", "3", "--seq", "16"),
     {"decode.admit", "decode.prefill", "decode.chunk", "decode.retire",
      "forward.capture"}),
    (("--speculative", "--max-new", "3", "--requests", "3", "--seq", "16"),
     {"decode.admit", "decode.prefill", "decode.spec_round",
      "decode.retire", "forward.capture"}),
])
def test_trace_and_metrics_out(capsys, tmp_path, mode, spans):
    """Every ported mode writes a schema-valid Chrome trace and a metrics
    snapshot, and prints the reference's two lines for them."""
    trace, snap = tmp_path / "t.json", tmp_path / "m.json"
    rc = main(["--smoke", "--device", "cpu", *mode, "--trace-out",
               str(trace), "--metrics-out", str(snap)])
    out = capsys.readouterr()
    assert rc == 0, out.err
    obj = json.loads(trace.read_text(encoding="utf-8"))
    assert validate_chrome_trace(obj) == []
    assert spans <= {e["name"] for e in obj["traceEvents"]}
    metrics = json.loads(snap.read_text(encoding="utf-8"))
    assert "compile.cache_misses" in metrics
    n = len(obj["traceEvents"])
    assert f"trace: {n} events -> {trace}" in out.out
    assert out.out.splitlines()[-1] == f"metrics -> {snap}"
    if "--decode" in mode or "--speculative" in mode:
        assert re.search(r"warmup: [1-9]\d* decode variants", out.out)
        assert sum(r["value"] for r in metrics["decode.tokens"]["series"]) \
            == 9
