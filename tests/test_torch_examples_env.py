"""``examples/torch_adaptive_serve.py`` and ``examples/torch_fleet_serve.py``
run in-process on the CPU: each returns cleanly, prints the original
example's lines in the original's order (patterns written from its
``print`` calls), and its host-math lines agree with the reference's own
functions.  The examples keep the originals' constants; nothing is
monkeypatched.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import re

import torch

from _torch_examples import load, match, printed_close, run
from repro.configs import get_smoke as jget_smoke
from repro.core import cost_model as jcm
from repro.core import fleet as jfl
from repro_torch.configs import get_smoke
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve_engine import fit_lambda

NUM = r"([-\d.]+)"


def test_adaptive_serve(capsys):
    """Lines held against the reference: T0 is 0.78 x the full-precision
    request time at full clocks of the smoke model's FLOP split, from its
    config and ``SystemParams`` (E0 2 mJ); 24 requests served per policy;
    the static plan never replans; one event line per replan; the
    violations lie between the batches marked '!' and four times that
    (a marked batch holds 1-4 late requests, max_batch 4)."""
    mod = load("adaptive_serve")
    lines = run(mod, capsys)
    cell = r"b̂=\s*\d+@[\d.]+GHz[! ]"
    block = [
        (r"policy=(static|adaptive):", 1),
        (r"   " + cell + r"(  " + cell + r")*", "+"),
        (r"  -> violations (\d+)/(\d+), replans (\d+) \(plan switches "
         r"(\d+)\), degraded batches (\d+)", 1),
        (r"     t=\s*" + NUM + r"ms (\S+): b̂ (\d+) -> (\d+)"
         r"( \(degraded\))?", "*")]
    m = match(lines, [
        (r"arch=(\S+); trace: f_max 2\.0 -> 0\.6 -> 2\.0 GHz \(Table I "
         r"profiles\), Wi-Fi 2e8 <-> 4e7 B/s \(Markov\); T0=" + NUM
         + r"us E0=" + NUM + "mJ", 1)] + block + block + [
        (r"same requests, same physics \('!' marks a missed deadline\): "
         r".*", 1)])
    jcfg = jget_smoke("qwen2-0.5b")
    assert m[0][0].group(1) == jcfg.name
    per_layer = jcfg.active_param_count() / jcfg.n_layers
    n_a = 2.0 * per_layer * jcfg.split_layer * mod.SEQ
    n_s = 2.0 * per_layer * (jcfg.n_layers - jcfg.split_layer) * mod.SEQ
    p = jcm.SystemParams(n_flop_agent=n_a, n_flop_server=n_s)
    t_ref = n_a / (p.c_agent * p.f_max) + n_s / (p.c_server * p.f_server_max)
    t0, e0 = m[0][0].groups()[1:]
    assert printed_close(t0, 0.78 * t_ref * 1e6) and e0 == "2.0"
    for k, policy in zip((1, 5), ("static", "adaptive")):
        assert m[k][0].group(1) == policy
        grid = " ".join(r.group(0) for r in m[k + 1])
        marks = len(re.findall(r"GHz!", grid))
        viol, served, replans, switches, _ = map(int, m[k + 2][0].groups())
        assert served == mod.N_REQUESTS
        assert marks <= viol <= 4 * marks
        assert len(m[k + 3]) == replans
        if policy == "static":
            assert replans == switches == 0


def _fleet_lams():
    """Each agent's λ: fitted on the example's seeded weights."""
    lams = {}
    for arch in ("qwen2-0.5b", "stablelm-3b"):
        cfg = get_smoke(arch)
        params = build_model(cfg).init(torch.Generator().manual_seed(0))
        lams[arch] = fit_lambda(params, cfg.split_layer)
    return lams


def test_fleet_serve(capsys):
    """Lines held against the reference: under each allocator every
    agent's share, b̂ and bound, and the aggregate bound, from its
    ``solve_equal_split`` / ``solve_fleet`` over ``FleetAgent``s at the
    engines' λ (b_emb 8, the example's budgets); the codesign cache line
    counts the three agents."""
    mod = load("fleet_serve")
    lines = run(mod, capsys)
    block = [
        (r"allocator=(equal|joint)  aggregate bound=(\S+)", 1),
        (r"agent\s+share\s+b_hat\s+bound\s+distortion\s+occup", 1),
        (r"(\S+)\s+" + NUM + r"\s+(\d+)\s+(\S+)\s+" + NUM + r"\s+" + NUM, 3),
        (r"shared codesign cache: (\d+) solves / (\d+) hits across (\d+) "
         r"agents", 1)]
    m = match(lines, block + block + [
        (r"same budgets, same streams — only the server split differs: .*",
         1)])
    lams = _fleet_lams()
    sysp = jcm.SystemParams(n_flop_agent=6.4e10, n_flop_server=1.92e11)
    agents = [jfl.FleetAgent(name=name, lam=lams[arch], sysp=sysp, t0=t0,
                             e0=e0, weight=w, b_emb=8)
              for name, arch, t0, e0, w in mod.AGENTS]
    for k, (allocator, solve) in zip((0, 4), (
            ("equal", jfl.solve_equal_split), ("joint", jfl.solve_fleet))):
        assert m[k][0].group(1) == allocator
        sol = solve(agents)
        assert printed_close(m[k][0].group(2), sol.aggregate_bound)
        for row, a, share, s in zip(m[k + 2], agents, sol.shares,
                                    sol.solutions):
            name, sh, b_hat, bound = row.groups()[:4]
            assert name == a.name and int(b_hat) == s.b_hat
            assert printed_close(sh, share)
            assert printed_close(bound, a.weight * s.objective)
        assert int(m[k + 3][0].group(3)) == len(agents)
