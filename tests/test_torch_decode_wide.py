"""The port's decode engine past 16 slots, against its batch-1 reference
and the JAX engine, on the CPU.

The card's ``row_gemm`` once raised past 16 rows, the decode slot
block's width, so ``DecodeEngine`` failed at ``max_batch`` 17 on the
card; the reference takes any width.  Here, on the smoke config with the
kernels' plain versions:

* ``DecodeEngine`` at ``max_batch`` 20 over 22 ragged prompts returns
  every response bitwise equal to ``greedy_decode_reference`` at batch 1
  (port on port: every per-row op of the step is row-independent);
* its tokens equal the JAX engine's at the same width, on the same
  weights (bridged from the reference's ``PRNGKey(0)`` init) and traffic;
* the norms (``layers.apply_norm``, through ``F.rms_norm`` and
  ``F.layer_norm``: ``torch.mean``'s reduction on the card splits a row
  by the row count) agree with the JAX reference's within 1e-6 and give
  each row alone bitwise its batched bits, for RMSNorm and LayerNorm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core.cost_model import SystemParams as JSystemParams
from repro.models import layers as jL
from repro.models.registry import build_model
from repro.runtime import CompiledForwardCache
from repro.runtime import DecodeEngine as JDecodeEngine
from repro.runtime import QosClass as JQosClass
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.core.cost_model import SystemParams
from repro_torch.models import layers as L
from repro_torch.models.lm import DecoderLM
from repro_torch.runtime import (DecodeEngine, QosClass,
                                 greedy_decode_reference)

SYSP = dict(n_flop_agent=6.4e10, n_flop_server=1.92e11)
QOS = ("interactive", 3.5, 2.0)
SLOTS, PROMPTS = 20, 22


def _traffic(vocab, n, seed):
    """n prompts of 4-12 tokens, 1-4 new tokens each: one prompt bucket
    and one cache bucket (16), so each engine compiles its step once."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(4, 13))).astype(
        np.int32), int(rng.integers(1, 5))) for _ in range(n)]


def _serve(eng, traffic):
    rids = {eng.submit(toks, QOS[0], max_new_tokens=n, arrival_s=0.0): i
            for i, (toks, n) in enumerate(traffic)}
    return {rids[r.request_id]: r.tokens for r in eng.drain()}


@pytest.fixture(scope="module")
def served():
    jmodel = build_model(jget_smoke("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = DecoderLM(get_smoke("qwen2-0.5b"))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    traffic = _traffic(tmodel.cfg.vocab_size, PROMPTS, seed=7)
    out = {}
    for name, Engine, Sysp, Qos, model, params, kw in (
            ("jax", JDecodeEngine, JSystemParams, JQosClass, jmodel,
             jparams, dict(compile_cache=CompiledForwardCache())),
            ("port", DecodeEngine, SystemParams, QosClass, tmodel, tparams,
             dict(device="cpu"))):
        eng = Engine(model, params, Sysp(**SYSP), classes=[Qos(*QOS)],
                     auto=False, max_batch=SLOTS, max_new_tokens=4, **kw)
        eng.set_operating_point(QOS[0], 8, 8)
        out[name] = (eng, _serve(eng, traffic))
    return tmodel, traffic, out


def test_wide_engine_equals_batch1_reference(served):
    tmodel, traffic, out = served
    eng, got = out["port"]
    assert len(got) == PROMPTS and eng.report().requests_served == PROMPTS
    w = eng.class_params(QOS[0])
    for i, (toks, n) in enumerate(traffic):
        want = greedy_decode_reference(tmodel, w, toks, n, b_kv=8,
                                       device="cpu")
        np.testing.assert_array_equal(got[i], want)


def test_wide_engine_tokens_equal_the_jax_engine(served):
    _, traffic, out = served
    (_, want), (_, got) = out["jax"], out["port"]
    assert sorted(want) == sorted(got) == list(range(PROMPTS))
    for i in range(PROMPTS):
        np.testing.assert_array_equal(got[i], np.asarray(want[i]))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "stablelm-3b"])
def test_decode_norms_rows_alone(arch):
    cfg = get_smoke(arch)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((40, 1, cfg.d_model)).astype(
        np.float32))
    p = {n: torch.from_numpy(rng.standard_normal(cfg.d_model).astype(
        np.float32)) for n in ("scale", "bias")}
    got = L.apply_norm(cfg, x, p)
    want = jL.apply_norm(cfg, jnp.asarray(x.numpy()),
                         {n: jnp.asarray(a.numpy()) for n, a in p.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    for i in range(x.shape[0]):
        assert torch.equal(L.apply_norm(cfg, x[i:i + 1], p)[0], got[i])
