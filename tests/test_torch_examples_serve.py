"""``examples/torch_quickstart.py`` and ``examples/torch_co_inference_serve
.py`` (plain, ``--mixed-precision``, ``--compiled``) run in-process on the
CPU: each returns cleanly, prints the original example's lines in the
original's order (the patterns below are written from its ``print``
calls), and every line that is host math on a value the run fixed agrees
with the reference's own function on that value, at the printed
precision.  The examples keep the originals' constants; nothing is
monkeypatched but a spy on ``exponential_mle`` that records the λ the
quickstart prints.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import pytest
import torch

from _torch_examples import load, match, printed_close, run
from repro.configs import get_smoke as jget_smoke
from repro.core import codesign as jcd
from repro.core import cost_model as jcm
from repro.core import mixed_precision as jmp
from repro.core import rate_distortion as jrd
from repro_torch.configs import get_smoke
from repro_torch.core.mixed_precision import decoder_layer_stats
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve_engine import fit_lambda

NUM = r"([-\d.]+)"
SYSP = dict(n_flop_agent=6.4e10, n_flop_server=1.92e11)


def test_quickstart(capsys, monkeypatch):
    """Lines held against the reference: [2]'s four D^L/D^U intervals at
    the printed λ (the spy's value), [3]'s (b̂, f, f̃, T, E, iterations) from
    its ``solve_sca`` at that λ, [4]'s T and E per b̂ from its cost model
    at the engine's operating point (f_max, f̃_max, b_emb = 16, 2 x 16
    tokens), the auto-configured b̂ from ``solve_sca`` with the engine's
    b_max and b_emb.  The measured distortion falls with b̂."""
    mod = load("quickstart")
    seen = []

    def spy(mags):
        out = real(mags)
        seen.append(float(out))
        return out
    real = mod.exponential_mle
    monkeypatch.setattr(mod, "exponential_mle", spy)
    lines = run(mod, capsys)
    m = match(lines, [
        (r"model: (\S+)  layers=(\d+)  split at (\d+) \(agent\|server\)", 1),
        (r"\[1\] exponential fit: lambda_hat = " + NUM, 1),
        (r"\[2\] distortion-rate interval per bit-width \(rate = b-1\):", 1),
        (r"    b=(\d):  D in \[(\S+), (\S+)\]", 4),
        (r"\[3\] Algorithm 1 under \(T0=1\.3s, E0=1\.5J\): b_hat=(\d+), "
         r"f=" + NUM + r" GHz, f~=" + NUM + r" GHz", 1),
        (r"    realized T=" + NUM + r"s E=" + NUM + r"J \((\d+) SCA "
         r"iterations\)", 1),
        (r"\[4\] measured output distortion through the split:", 1),
        (r"    b_hat=\s*(\d+): \|\|f - f_hat\|\|_1 = \s*" + NUM
         + r"   T=\s*" + NUM + r" ms  E=\s*" + NUM + r" J", 4),
        (r"    auto-configured to b_hat=(\d+) for the QoS class", 1),
    ])
    jcfg = jget_smoke("stablelm-3b")
    assert m[0][0].groups() == (jcfg.name, str(jcfg.n_layers),
                                str(jcfg.split_layer))
    (lam,) = seen
    assert m[1][0].group(1) == f"{lam:.1f}"
    for row, b in zip(m[3], (2, 4, 6, 8)):
        assert row.group(1) == str(b)
        assert printed_close(row.group(2), float(
            jrd.distortion_lower_bound(b - 1, lam)))
        assert printed_close(row.group(3), float(
            jrd.distortion_upper_bound(b - 1, lam)))
    sysp = jcm.SystemParams(**SYSP)
    sol = jcd.solve_sca(lam, sysp, t0=1.3, e0=1.5)
    b_hat, f, fs = m[4][0].groups()
    assert int(b_hat) == sol.b_hat
    assert printed_close(f, sol.f / 1e9)
    assert printed_close(fs, sol.f_server / 1e9)
    t, e, iters = m[5][0].groups()
    assert printed_close(t, sol.delay) and printed_close(e, sol.energy)
    assert int(iters) == sol.iterations
    # [4]: the engine bills 2 x 16 tokens at (f_max, f~_max), b_emb = 16:
    # each row ships 16 x d_model float32 values
    per_layer = jcfg.active_param_count() / jcfg.n_layers
    n_a = 2.0 * per_layer * jcfg.split_layer * 32
    n_s = 2.0 * per_layer * (jcfg.n_layers - jcfg.split_layer) * 32
    p = dataclasses.replace(sysp, n_flop_agent=n_a, n_flop_server=n_s,
                            emb_bytes_full=float(2 * 16 * jcfg.d_model * 4))
    dists = []
    for row, b in zip(m[7], (16, 8, 4, 2)):
        assert int(row.group(1)) == b
        t = (jcm.agent_delay(b, p.f_max, p)
             + jcm.server_delay(p.f_server_max, p)
             + jcm.transport_delay(16, p))
        e = (jcm.agent_energy(b, p.f_max, p)
             + jcm.server_energy(p.f_server_max, p)
             + jcm.transport_energy(16, p))
        assert printed_close(row.group(3), float(t) * 1e3)
        assert printed_close(row.group(4), float(e))
        dists.append(float(row.group(2)))
    assert dists == sorted(dists)
    auto = jcd.solve_sca(lam, sysp, 1.3, 1.5, b_max=16, b_emb=16)
    assert int(m[8][0].group(1)) == auto.b_hat


def _co_inference_spec(compiled: bool):
    spec = []
    if compiled:
        spec.append((r"warmup: (\d+) compiled forward variants", 1))
    spec += [
        (r"class\s+bits\s+f GHz\s+f~ GHz\s+T \(model\)\s+E \(model\)", 1),
        (r"(realtime|interactive|batch)\s+(\S+)\s+" + NUM + r"\s+" + NUM
         + r"\s+" + NUM + r"s\s+" + NUM + "J", 3),
        (r"served (\d+) requests in (\d+) single-class batches:", 1),
        (r"  \[(\S+)\s*\] n=(\d+) b_hat=\s*(\S+) \((\S+)\) occupancy=" + NUM
         + r" amortized T=\s*" + NUM + r"ms/req E=" + NUM + r"J/req uplink="
         + NUM + "KiB", "+"),
        (r"class\s+requests\s+distortion", 1),
        (r"(realtime|interactive|batch)\s+(\d+)\s+" + NUM, 3),
        (r"report: mean_batch=" + NUM + r" occupancy=" + NUM
         + r" modeled throughput=(\d+) req/s; codesign cache: (\d+) solves, "
         r"(\d+) hits", 1)]
    if compiled:
        spec.append((r"compile cache: (\d+) variants, (\d+) hits / (\d+) "
                     r"misses", 1))
    spec.append((r"tighter QoS -> smaller b_hat -> more distortion; "
                 r"batching amortizes .*", 1))
    return spec


@pytest.mark.parametrize("flag", ("", "--mixed-precision", "--compiled"))
def test_co_inference_serve(capsys, flag):
    """Lines held against the reference: each class row's (bits, f, f̃, T,
    E) from its ``solve_sca`` at the engine's λ (uniform; the classes land
    on b̂ = 4 / 8 / 16 as the original's comment says) or from its
    ``allocate_bits`` over the engine's ``LayerStats`` (mixed); each batch
    line's bits and agent path follow its class row; every class serves
    its 8 requests; the report's mean batch and codesign counts follow the
    batch lines; the compile cache holds the variants warmup printed."""
    mod = load("co_inference_serve")
    lines = run(mod, capsys, *([flag] if flag else []))
    compiled, mixed = flag == "--compiled", flag == "--mixed-precision"
    m = match(lines, _co_inference_spec(compiled))
    if compiled:
        variants = int(m[0][0].group(1))
        m = m[1:]
    cfg = get_smoke("stablelm-3b")
    if mixed:
        cfg = dataclasses.replace(cfg, split_layer=2)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    sysp = jcm.SystemParams(**SYSP)
    bits = {}
    for row, qos in zip(m[1], mod.CLASSES):
        name, bdesc, f, fs, t, e = row.groups()
        assert name == qos.name
        if mixed:
            st = decoder_layer_stats(params, cfg.split_layer)
            sol = jmp.allocate_bits(jmp.LayerStats(lam=st.lam, sens=st.sens),
                                    sysp, qos.t0, qos.e0, b_max=16, b_emb=8)
            assert bdesc == "/".join(map(str, sol.bits))
        else:
            sol = jcd.solve_sca(fit_lambda(params, cfg.split_layer), sysp,
                                qos.t0, qos.e0, b_max=16, b_emb=8)
            assert bdesc == str(sol.b_hat)
        bits[name] = bdesc
        assert printed_close(f, sol.f / 1e9)
        assert printed_close(fs, sol.f_server / 1e9)
        assert printed_close(t, sol.delay) and printed_close(e, sol.energy)
    if not mixed:
        assert [bits[c.name] for c in mod.CLASSES] == ["4", "8", "16"]
    served, n_batches = map(int, m[2][0].groups())
    assert served == mod.N_REQUESTS and n_batches == len(m[3])
    assert sum(int(b.group(2)) for b in m[3]) == served
    for b in m[3]:
        qos, _, bdesc, path = b.groups()[:4]
        want = bits[qos]
        if mixed and len(set(want.split("/"))) == 1:
            want = want.split("/")[0]
        assert bdesc == want
        if want == "16":
            assert path == "fake"
        elif mixed:
            assert path == f"kernel-mixed[{want}]"
        else:
            assert path == f"kernel-int{want}"
    assert [int(r.group(2)) for r in m[5]] == [8, 8, 8]
    mean_batch, _, _, solves, hits = m[6][0].groups()
    assert printed_close(mean_batch, served / n_batches)
    assert (int(solves), int(hits)) == (3, 0)
    if compiled:
        assert int(m[7][0].group(1)) == variants
