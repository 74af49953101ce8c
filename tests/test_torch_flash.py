"""Flash attention: the port's plain version against the reference, and the
port's bitwise properties.

On the CPU ``flash_attention_fwd`` runs its plain version
(``ref.flash_attention_ref``); the reference runs its Pallas kernel in
interpret mode, as its own tests do.  Inputs come from numpy seeds.
Tolerances are the reference's own (``tests/test_flash.py``): rtol = atol
= 2e-5 in f32 (the same tile schedule, sums in another order), 3e-2 for
bf16 inputs, 2e-4 for gradients.  Port against port it is bitwise: a row
alone equals the row in a batch, and right-padding inside the bucket
changes no bit of the real positions.  Non-causal attention over a length
that is not a multiple of its block is held against the numpy oracle
``_np_attention_fwd``: the reference's blockwise path lets the padded keys
into the softmax there (ROADMAP C), the port masks them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash as jflash
from repro.models import layers as jL
from repro_torch import kernels as tk
from repro_torch.kernels import ref
from repro_torch.kernels.flash import flash_attention, flash_attention_fwd
from repro_torch.models import layers as tL

TOL = dict(rtol=2e-5, atol=2e-5)

# the reference's CASES (tests/test_flash.py) plus qwen2-0.5b's heads
CASES = [
    # B, H, KV, S, dh, causal, window, bq, bk
    (2, 4, 4, 256, 64, True, 0, 128, 128),
    (1, 8, 2, 512, 64, True, 0, 256, 256),      # GQA 4:1
    (2, 4, 1, 128, 32, True, 0, 64, 64),        # MQA
    (1, 4, 4, 256, 64, False, 0, 128, 128),     # bidirectional
    (1, 4, 4, 256, 64, True, 64, 128, 128),     # sliding window
    (1, 2, 2, 384, 128, True, 0, 128, 128),     # dh=128, 3 blocks
    (2, 14, 2, 64, 64, True, 0, 512, 512),      # qwen2-0.5b, serve shape
    (1, 14, 2, 128, 64, True, 0, 512, 512),     # qwen2-0.5b, train shape
]


@pytest.fixture(autouse=True)
def _no_launches():
    tk.reset_launch_counts()
    yield
    assert tk.flash_attention_fwd.launches == 0      # CPU: plain only


def _qkv(seed, b, h, kv, s, dh, t=None):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    return (rng.standard_normal((b, h, s, dh)).astype(np.float32),
            rng.standard_normal((b, kv, t, dh)).astype(np.float32),
            rng.standard_normal((b, kv, t, dh)).astype(np.float32))


def _t(*arrs):
    return tuple(torch.from_numpy(a) for a in arrs)


@pytest.mark.parametrize("b,h,kv,s,dh,causal,win,bq,bk", CASES)
def test_flash_fwd_matches_reference_kernel(b, h, kv, s, dh, causal, win,
                                            bq, bk):
    q, k, v = _qkv(b * s + h, b, h, kv, s, dh)
    want = jflash.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=win, block_q=bq, block_k=bk, interpret=True)
    got = flash_attention_fwd(*_t(q, k, v), causal=causal, window=win,
                              block_q=bq, block_k=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_bf16_matches_reference_kernel():
    q, k, v = (a.astype(jnp.bfloat16) for a in _qkv(0, 1, 4, 4, 256, 64))
    want = jflash.flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True,
                                      interpret=True)
    got = flash_attention_fwd(*(torch.from_numpy(a.astype(np.float32))
                                .to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)])
def test_flash_grad_matches_reference_custom_vjp(causal, window):
    """Gradients of the port's autograd Function against ``jax.grad``
    through the reference's ``flash_attention`` (its custom_vjp)."""
    q, k, v = _qkv(1, 1, 4, 2, 128, 32)

    def f(q, k, v):
        return jnp.sum(jflash.flash_attention(q, k, v, causal, window,
                                              True) ** 2)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [x.requires_grad_(True) for x in _t(q, k, v)]
    out = flash_attention(*leaves, causal, window)
    got = torch.autograd.grad(torch.sum(out ** 2), leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("s,window", [(64, 0), (100, 0), (130, 32)])
def test_dispatching_blockwise_matches_reference(s, window):
    """The model's call site ([B, S, H, dh] layout) against the
    reference's ``blockwise_attention``; on the CPU it is the plain
    blockwise loop, on the card the kernel (tests/test_torch_cuda.py)."""
    q, k, v = (a.transpose(0, 2, 1, 3).copy()
               for a in _qkv(s, 2, 14, 2, s, 64))
    want = jL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True,
                                  window=window)
    got = tL.blockwise_attention(*_t(q, k, v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s", [100, 37])
def test_noncausal_padding_is_masked(s):
    """Bidirectional attention over a length off the block grid, against
    the numpy oracle: the padded keys never enter the softmax."""
    q, k, v = (a.transpose(0, 2, 1, 3).copy()
               for a in _qkv(s, 2, 4, 2, s, 16))
    want, _ = jL._np_attention_fwd(q, k, v, False, 0)
    got = tL.blockwise_attention(*_t(q, k, v), causal=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the reference's blockwise path, by contrast, attends the zero keys
    # padded onto its last block (ROADMAP C: a caveat of the reference)
    faulty = jL.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                    causal=False)
    assert np.abs(np.asarray(faulty) - want).max() > 1e-2
    got_fwd = flash_attention_fwd(
        *(x.transpose(1, 2) for x in _t(q, k, v)), causal=False)
    np.testing.assert_allclose(got_fwd.transpose(1, 2).numpy(), want, **TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (False, 0)])
def test_rows_alone_equal_the_batch(causal, window):
    q, k, v = _t(*_qkv(7, 3, 14, 2, 100, 64))
    lens = torch.tensor([100, 61, 9])
    out = flash_attention_fwd(q, k, v, causal=causal, window=window,
                              kv_len=lens)
    for i in range(3):
        alone = flash_attention_fwd(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                    causal=causal, window=window,
                                    kv_len=lens[i:i + 1])
        assert torch.equal(alone[0], out[i]), f"row {i}"


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,padded", [(100, 128), (600, 1000)])
def test_padding_inside_the_bucket_is_invisible(causal, s, padded):
    q, k, v = _t(*_qkv(8, 1, 4, 2, padded, 32))
    short = flash_attention_fwd(q[:, :, :s], k[:, :, :s], v[:, :, :s],
                                causal=causal)
    long = flash_attention_fwd(q, k, v, causal=causal,
                               kv_len=None if causal else s)
    assert torch.equal(long[:, :, :s], short)
    # the model's plain blockwise loop too (default positions)
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    if causal:
        assert torch.equal(
            tL.blockwise_attention(qs, ks, vs, causal=True)[:, :s],
            tL.blockwise_attention(qs[:, :s], ks[:, :s], vs[:, :s],
                                   causal=True))


def test_ref_attention_matches_reference_oracle():
    q, k, v = _qkv(9, 2, 6, 2, 48, 16)
    for causal, window in ((True, 0), (True, 8), (False, 0)):
        want = jflash._ref_attention(*map(jnp.asarray, (q, k, v)), causal,
                                     window)
        got = ref.ref_attention(*_t(q, k, v), causal, window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrapper_rejects_what_it_cannot_run():
    q, k, v = _t(*_qkv(10, 1, 6, 4, 16, 8))
    with pytest.raises(ValueError, match="group"):
        flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_fwd(*(x[:, :2].to("meta") for x in (q, k, v)))


def test_blockwise_attention_runs_the_loop_on_the_cpu_only():
    """Off the CPU the model's call site goes to the flash wrapper, which
    launches the kernel or raises: the plain loop never runs on another
    device."""
    q, k, v = (x.transpose(1, 2).to("meta")
               for x in _t(*_qkv(12, 1, 4, 2, 16, 8)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tL.blockwise_attention(q, k, v, causal=True)
