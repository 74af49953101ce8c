"""``examples/torch_decode_serve.py`` and ``examples/torch_speculative_serve
.py`` run in-process on the CPU: each returns cleanly with its in-script
assertion held (every response bitwise the batch-1
``greedy_decode_reference``), prints the original example's lines in the
original's order (patterns written from its ``print`` calls), and its
host-math lines agree with the reference's own functions.  The examples
keep the originals' constants; nothing is monkeypatched.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import torch

from _torch_examples import load, load_reference, match, printed_close, run
from repro.configs import get_smoke as jget_smoke
from repro.core import codesign as jcd
from repro_torch.configs import get_smoke
from repro_torch.models.registry import build_model
from repro_torch.runtime import fit_kv_lambda
from repro_torch.runtime.serve_engine import fit_lambda

NUM = r"([-\d.]+)"
ARCH = r"arch=(\S+): 10 staggered prompts, max_batch=3, 8 new tokens each"
ALL_MATCH = r"  -> all (\d+) responses bitwise-match the non-batched reference"


def _lams():
    """The engines' λ and λ_kv: fitted on the example's seeded weights."""
    cfg = get_smoke("qwen2-0.5b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    return fit_lambda(params, cfg.split_layer), fit_kv_lambda(model, params)


# the examples' two classes, (T0, E0)
CLASSES = {"realtime": (1.2, 1.0), "interactive": (3.5, 2.0)}


def test_decode_serve(capsys):
    """Lines held against the reference: each class's (b̂, b_kv) from its
    ``solve_decode`` at the engine's λ and λ_kv over the reference
    example's own ``make_sysp``; five requests a class, the same tokens
    under both admissions; the closing ratio from the two printed
    throughputs, at their printed precision."""
    mod = load("decode_serve")
    lines = run(mod, capsys)
    block = [
        (r"admission=(barrier|continuous):", 1),
        (r"  \[(\S+)\s*\] n=(\d+) b̂=(\d+) b_kv=(\d+) ttft=\s*" + NUM
         + r"ms \(max\s*" + NUM + r"ms\) itl=\s*" + NUM + "ms", 2),
        (r"  -> (\d+) tokens in (\d+) rounds, " + NUM + r" tok/s "
         r"\(modeled\), kv cache " + NUM + r"x of full precision", 1),
        (ALL_MATCH, 1)]
    m = match(lines, [(ARCH, 1)] + block + block + [
        (r"continuous admission: " + NUM + r"x the barrier's modeled "
         r"throughput on the same stream, .*", 1)])
    assert m[0][0].group(1) == jget_smoke("qwen2-0.5b").name
    lam, lam_kv = _lams()
    sysp = load_reference("decode_serve").make_sysp(jget_smoke("qwen2-0.5b"))
    tps, tokens = [], []
    for k, admission in zip((1, 5), ("barrier", "continuous")):
        assert m[k][0].group(1) == admission
        for row in m[k + 1]:
            qos, n, b_hat, b_kv = row.groups()[:4]
            t0, e0 = CLASSES[qos]
            sol = jcd.solve_decode(lam, lam_kv, sysp, t0, e0, b_max=16)
            assert (int(b_hat), int(b_kv)) == (sol.b_hat, sol.b_kv)
            assert int(n) == 5
        tokens.append(int(m[k + 2][0].group(1)))
        tps.append(m[k + 2][0].group(3))
        assert int(m[k + 3][0].group(1)) == mod.N_REQUESTS
    assert tokens[0] == tokens[1]
    speedup = m[9][0].group(1)
    lo = (float(tps[1]) - 0.05) / (float(tps[0]) + 0.05)
    hi = (float(tps[1]) + 0.05) / (float(tps[0]) - 0.05)
    assert lo - 0.005 <= float(speedup) <= hi + 0.005


def test_speculative_serve(capsys):
    """Lines held against the reference: each plain-decode class's (b̂,
    b_kv) from its ``solve_decode`` and each speculative class's (b̂, b_kv,
    b_draft, k) from its ``solve_speculative`` (the engine's menus), at
    the engine's λ and λ_kv over the reference example's ``make_sysp``;
    the same tokens in both modes; the closing line's round counts are
    the two printed ones and their ratio at its printed precision."""
    mod = load("speculative_serve")
    lines = run(mod, capsys)
    row = (r"  \[(\S+)\s*\] n=(\d+) b̂=(\d+) b_kv=(\d+)")
    tail = r" ttft=\s*" + NUM + r"ms itl=\s*" + NUM + "ms"
    rounds = (r"  -> (\d+) tokens in (\d+) rounds, " + NUM
              + r" tok/s \(modeled\)")
    m = match(lines, [
        (ARCH, 1),
        (r"mode=decode:", 1), (row + tail, 2), (rounds, 1), (ALL_MATCH, 1),
        (r"mode=speculative:", 1),
        (row + r" b_draft=(\d+) k=(\d+)" + tail, 2), (rounds, 1),
        (r"  -> acceptance=" + NUM + r", accepted/round=" + NUM
         + r", tokens/round=" + NUM, 1),
        (ALL_MATCH, 1),
        (r"speculative rounds: (\d+) -> (\d+) decode rounds for the same "
         r"stream \(" + NUM + r"x fewer server round-trips\), .*", 1)])
    lam, lam_kv = _lams()
    sysp = load_reference("speculative_serve").make_sysp(
        jget_smoke("qwen2-0.5b"))
    for r in m[2]:
        qos, n, b_hat, b_kv = r.groups()[:4]
        t0, e0 = CLASSES[qos]
        sol = jcd.solve_decode(lam, lam_kv, sysp, t0, e0, b_max=16)
        assert (int(b_hat), int(b_kv), int(n)) == (sol.b_hat, sol.b_kv, 5)
    for r in m[6]:
        qos, n, b_hat, b_kv, b_draft, k = r.groups()[:6]
        t0, e0 = CLASSES[qos]
        sol = jcd.solve_speculative(lam, lam_kv, sysp, t0, e0, b_max=16,
                                    draft_ladder=(2, 4, 8),
                                    lookahead=(2, 4, 8))
        assert (int(b_hat), int(b_kv), int(b_draft), int(k), int(n)) == \
            (sol.b_hat, sol.b_kv, sol.b_draft, sol.k, 5)
    assert int(m[3][0].group(1)) == int(m[7][0].group(1))
    for k in (4, 9):
        assert int(m[k][0].group(1)) == mod.N_REQUESTS
    alpha, per_round, tokens_per_round = map(float, m[8][0].groups())
    assert 0.0 <= alpha <= 1.0 and per_round <= tokens_per_round
    dec_rounds, spec_rounds, ratio = m[10][0].groups()
    assert (int(dec_rounds), int(spec_rounds)) == (
        int(m[3][0].group(2)), int(m[7][0].group(2)))
    assert printed_close(ratio, int(dec_rounds) / max(int(spec_rounds), 1))
