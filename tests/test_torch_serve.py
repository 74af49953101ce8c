"""The port's co-inference engine (kernel path, plain kernel versions on the
CPU) against the JAX reference engine on one unpadded request.

The config is qwen2-0.5b cut to 3 layers at widths that reach the
reference's Pallas kernels (K and N multiples of 128, K % 256 == 0 for
int4) rather than its jnp fallback.  Logits agree at rtol = atol = 1e-4;
the discrete results (agent path, wire bytes) are equal.  Batching and
padding are then checked port against port.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.qwen2_0_5b import FULL as JFULL
from repro.core.cost_model import SystemParams as JSystemParams
from repro.core.quantization import QuantPlan as JQuantPlan
from repro.models.registry import build_model
from repro.runtime import CoInferenceEngine as JEngine
from repro.runtime.serve_engine import fit_lambda as jfit_lambda
from repro_torch import kernels as tk
from repro_torch.bridge import params_from_jax
from repro_torch.configs.qwen2_0_5b import FULL
from repro_torch.core.cost_model import SystemParams
from repro_torch.core.quantization import QuantPlan
from repro_torch.models.lm import DecoderLM
from repro_torch.runtime import CoInferenceEngine
from repro_torch.runtime.serve_engine import fit_lambda

CUT = dict(n_layers=3, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
           d_ff=512, vocab_size=512, split_layer=2)
SYSP = dict(n_flop_agent=6.4e10, n_flop_server=1.92e11)
TOL = dict(rtol=1e-4, atol=1e-4)
S = 24


@pytest.fixture(scope="module")
def engines():
    jcfg = dataclasses.replace(JFULL, **CUT)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jeng = JEngine(jmodel, jparams, JSystemParams(**SYSP), path="kernel",
                   cache_weights=True)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    teng = CoInferenceEngine(DecoderLM(dataclasses.replace(FULL, **CUT)),
                             params, SystemParams(**SYSP), path="kernel",
                             device="cpu")
    tokens = np.random.default_rng(0).integers(0, CUT["vocab_size"],
                                               (1, S)).astype(np.int32)
    return jeng, jparams, teng, tokens


# (kind, bits, the agent path both engines must report)
CASES = [("uniform", 8, "kernel-int8"), ("uniform", 4, "kernel-int4"),
         ("uniform", 16, "fake"), ("plan", (4, 8), "kernel-mixed[4/8]"),
         ("plan", (6, 12), "kernel-mixed[6/12]")]


@pytest.mark.parametrize("kind,bits,path", CASES)
def test_engine_matches_reference(engines, kind, bits, path):
    jeng, _, teng, tokens = engines
    if kind == "plan":
        jeng.configure(JQuantPlan.from_layer_bits(bits))
        teng.configure(QuantPlan.from_layer_bits(bits))
    else:
        jeng.configure(bits)
        teng.configure(bits)
    assert teng.agent_path == jeng.agent_path == path
    want, jstats = jeng.serve_batch({"tokens": jnp.asarray(tokens)})
    tk.reset_launch_counts()
    got, tstats = teng.serve_batch({"tokens": tokens})
    assert tk.launch_counts() == {"group_quantize": 0, "qmm": 0,
                                  "qmm_int4": 0,
                                  "quantized_decode_attention": 0,
                                  "flash_attention_fwd": 0,
                                  "row_gemm": 0, "tc_gemm": 0}  # CPU: plain
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tstats.emb_bytes == jstats.emb_bytes
    assert tstats.emb_row_bytes == jstats.emb_row_bytes
    assert tstats.plan_bits == jstats.plan_bits
    assert tstats.b_hat == jstats.b_hat
    np.testing.assert_allclose(tstats.total_delay_s, jstats.total_delay_s,
                               rtol=1e-12)


def test_fit_lambda_matches_reference(engines):
    _, jparams, teng, _ = engines
    want = jfit_lambda(jparams, CUT["split_layer"])
    np.testing.assert_allclose(fit_lambda(teng.params, CUT["split_layer"]),
                               want, rtol=1e-6)
    np.testing.assert_allclose(teng.lam, want, rtol=1e-6)


@pytest.mark.parametrize("bits", [8, 4])
def test_batched_equals_sequential(engines, bits):
    """Port against port: three requests of different lengths served as
    one right-padded batch (with ``lengths``) equal each served alone.

    Lengths 20, 27 and 32 share the sequence bucket 32, so attention runs
    the same blocks in both cases, padded keys are masked to exact zeros,
    and the uplink scale is per request over its real positions: the rows
    are bitwise equal."""
    _, _, teng, _ = engines
    teng.configure(bits)
    rng = np.random.default_rng(1)
    lens = [20, 27, 32]
    toks = np.zeros((3, 32), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, CUT["vocab_size"], n)
    batched, stats = teng.serve_batch({"tokens": toks}, lengths=lens)
    for i, n in enumerate(lens):
        alone, st = teng.serve_batch({"tokens": toks[i:i + 1, :n]})
        np.testing.assert_array_equal(batched[i, :n].numpy(),
                                      alone[0].numpy())
        assert st.emb_row_bytes[0] == stats.emb_row_bytes[i]


def test_entry_points_need_a_device_when_cuda_is_missing(engines):
    _, _, teng, _ = engines
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        CoInferenceEngine(teng.model, teng.params, teng.sysp, path="kernel")
