"""The port's model layers and dense decoder against the JAX reference.

Inputs come from a numpy seed; the reference's parameters cross through
``repro_torch.bridge.params_from_jax``.  Layers agree at rtol = atol =
1e-5 (same float32 math, other summation orders); whole-model logits at
1e-4 (the error of four layers of such sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import layers as jL
from repro.models.registry import build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.models import layers as tL
from repro_torch.models.lm import DecoderLM

TOL5 = dict(rtol=1e-5, atol=1e-5)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_apply_rope_matches_reference():
    x = _normal(0, (2, 24, 4, 16))
    pos = np.broadcast_to(np.arange(24), (2, 24)) + np.array([[0], [5]])
    want = jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1.0e6)
    got = tL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                        1.0e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL5)


def test_rmsnorm_matches_reference():
    x, g = _normal(1, (3, 7, 64)), _normal(2, (64,))
    want = jL.rmsnorm(jnp.asarray(x), jnp.asarray(g))
    got = tL.rmsnorm(torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL5)


@pytest.mark.parametrize("s,window,blocks", [
    (24, 0, {}),                        # S off the bucket ladder (pads to 32)
    (40, 8, {}),                        # sliding window
    (40, 0, dict(q_block=16, kv_block=16)),   # several blocks each way
    (33, 5, dict(q_block=16, kv_block=16)),
])
def test_blockwise_attention_matches_reference(s, window, blocks):
    q = _normal(3, (2, s, 4, 16))
    k, v = _normal(4, (2, s, 2, 16)), _normal(5, (2, s, 2, 16))
    want = jL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True,
                                  window=window, **blocks)
    got = tL.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=True,
                                 window=window, **blocks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL5)


def test_decoder_lm_logits_match_reference():
    jcfg = jget_smoke("qwen2-0.5b")
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 20))
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})

    model = DecoderLM(get_smoke("qwen2-0.5b"))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    got, _ = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_init_matches_reference_structure():
    """The port's parameter dict has the reference's keys and shapes."""
    jcfg = jget_smoke("qwen2-0.5b")
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                     build_model(jcfg).param_structs())
    params = DecoderLM(get_smoke("qwen2-0.5b")).init(
        torch.Generator().manual_seed(0))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return tuple(t.shape)
    assert shapes(params) == jshapes
