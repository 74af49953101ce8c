"""The wide dense decoders (granite-34b, internlm2-20b,
llava-next-mistral-7b) and the MoE decoders (qwen3-moe-235b-a22b,
kimi-k2-1t-a32b) in the port against the JAX reference, on the CPU, at
their smoke configs.

The reference's parameters cross through ``repro_torch.bridge``; inputs
come from a numpy seed (llava's stub vision embeds too).  Forward logits,
prefill, ``decode_step``/``decode_step_q`` and the loss with its
gradients agree at rtol = atol = 1e-4 (float32 sums in another order
through four layers; the MoE layers route the same tokens to the same
experts), greedy token streams are equal, and the kernel-path engine of
the dense three (plain kernel versions here) agrees with the JAX engine at
b̂ = 8 and 4.  Port on port, the decode and speculative engines equal the
batch-1 reference (the MoE smoke configs' 8 experts take the dense path).
The registry holds each config field for field, and each arch serves and
trains through the CLIs.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.core.cost_model import SystemParams as JSystemParams
from repro.models.registry import build_model
from repro.runtime import CoInferenceEngine as JEngine
from repro.runtime import greedy_decode_reference as jgreedy
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.cost_model import SystemParams
from repro_torch.models.lm import DecoderLM
from repro_torch.runtime import (CoInferenceEngine, DecodeEngine, QosClass,
                                 greedy_decode_reference)

DENSE = ("granite-34b", "internlm2-20b", "llava-next-mistral-7b")
MOE = ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b")
ARCHS = DENSE + MOE
TOL = dict(rtol=1e-4, atol=1e-4)
SYSP = dict(n_flop_agent=6.4e10, n_flop_server=1.92e11)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke models' ops are too small to share among threads, and
    the suite runs several test processes side by side: intra-op threads
    would only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg = jget_smoke(arch)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return arch, jmodel, jparams, DecoderLM(get_smoke(arch)), tparams


def _batch(cfg, seed, b=2, s=24, labels=False):
    """Tokens (and, for the vision stub, 8 embed rows ahead of them) from
    a numpy seed, as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.frontend != "none":
        out["embeds"] = rng.standard_normal((b, 8, cfg.d_model)).astype(
            np.float32)
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_forward_matches_reference(pair):
    arch, jmodel, jparams, tmodel, tparams = pair
    batch = _batch(tmodel.cfg, 1)
    want, jaux = jmodel.forward(jparams, _j(batch))
    got, taux = tmodel.forward(tparams, _t(batch))
    assert got.shape == (2, 24 + (8 if "embeds" in batch else 0),
                         tmodel.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4,
                               atol=1e-7)
    if arch in MOE:
        assert float(taux) > 0


def test_loss_and_grads_match_reference(pair):
    """``loss`` (CE + 0.01 x the MoE aux loss) and its gradient for every
    parameter, within rtol 1e-4 of the gradient's scale."""
    _, jmodel, jparams, tmodel, tparams = pair
    batch = _batch(tmodel.cfg, 2, labels=True)
    want, jgrads = jax.value_and_grad(jmodel.loss)(jparams, _j(batch))
    leaves = {}

    def walk(t, path=()):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        leaf = t.clone().requires_grad_(True)
        leaves[path] = leaf
        return leaf
    params = walk(tparams)
    got = tmodel.loss(params, _t(batch))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=1e-4)
    flat = {tuple(k.key for k in path): g for path, g in
            jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert set(flat) == set(leaves)
    for path, leaf in leaves.items():
        g = np.asarray(flat[path])
        scale = max(float(np.abs(g).max()), 1e-12)
        np.testing.assert_allclose(leaf.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=str(path))


def test_prefill_and_decode_match_reference(pair):
    """``prefill`` (last-index logits and the cache), then one
    ``decode_step`` over the full-precision cache and one
    ``decode_step_q`` at b_kv = 8 and 4 over the quantized cache, from the
    same state: logits at 1e-4, positions equal."""
    from repro.kernels.quantize import kv_quantize as jkv_quantize
    _, jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    toks = _batch(cfg, 3, b=3, s=20)["tokens"]
    last = np.array([19, 11, 6], np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            last_index=jnp.asarray(last))
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                            last_index=torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    pos = last + 1
    # a cache of 32 positions holding the prefill's 20
    kv = {n: np.zeros((cfg.n_layers, 3, 32, cfg.n_kv_heads, cfg.head_dim),
                      np.float32) for n in ("k", "v")}
    for n in ("k", "v"):
        kv[n][:, :, :20] = np.asarray(jc[n])
    jl2, _ = jmodel.decode_step(
        jparams, {"k": jnp.asarray(kv["k"]), "v": jnp.asarray(kv["v"]),
                  "len": jnp.asarray(pos)},
        {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)})
    tl2, tc2 = tmodel.decode_step(
        tparams, {"k": torch.from_numpy(kv["k"].copy()),
                  "v": torch.from_numpy(kv["v"].copy()),
                  "len": torch.from_numpy(pos.copy())},
        {"token": torch.from_numpy(tok), "pos": torch.from_numpy(pos)})
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)
    np.testing.assert_array_equal(tc2["len"].numpy(), pos + 1)
    for b_kv in (8, 4):
        qc = {}
        for n in ("k", "v"):
            c, s = jkv_quantize(jnp.asarray(kv[n]), b_kv)
            qc[f"{n}_codes"], qc[f"{n}_scales"] = np.asarray(c), \
                np.asarray(s)
        jl3, _ = jmodel.decode_step_q(
            jparams, {**{n: jnp.asarray(a) for n, a in qc.items()},
                      "len": jnp.asarray(pos)},
            {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)}, b_kv=b_kv)
        tl3, _ = tmodel.decode_step_q(
            tparams, {**{n: torch.from_numpy(a.copy())
                         for n, a in qc.items()},
                      "len": torch.from_numpy(pos.copy())},
            {"token": torch.from_numpy(tok), "pos": torch.from_numpy(pos)},
            b_kv=b_kv)
        np.testing.assert_allclose(tl3.numpy(), np.asarray(jl3), **TOL)


@pytest.mark.parametrize("b_kv", [8, 4])
def test_greedy_decode_matches_reference(pair, b_kv):
    """``greedy_decode_reference`` (prefill, quantized cache, 8 greedy
    steps) gives the JAX oracle's tokens from the same weights."""
    _, jmodel, jparams, tmodel, tparams = pair
    prompt = np.random.default_rng(4).integers(
        0, tmodel.cfg.vocab_size, 13).astype(np.int32)
    want = jgreedy(jmodel, jparams, prompt, 8, b_kv=b_kv)
    got = greedy_decode_reference(tmodel, tparams, prompt, 8, b_kv=b_kv,
                                  device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))


def test_decode_engine_equals_batch_one(pair):
    """``DecodeEngine`` (3 slots, four prompts of ragged lengths, pinned at
    (b̂, b_kv) = (8, 8)) returns every stream bitwise its batch-1
    reference: every op of the step is row-independent, the MoE smoke
    configs' 8 experts on the dense path one token at a time."""
    _, _, _, tmodel, tparams = pair
    cfg = tmodel.cfg
    assert cfg.n_experts <= 8
    eng = DecodeEngine(tmodel, tparams, SystemParams(**SYSP),
                       classes=[QosClass("interactive", 3.5, 2.0)],
                       auto=False, max_batch=3, max_new_tokens=5,
                       device="cpu")
    eng.set_operating_point("interactive", 8, 8)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(3, 30, 4)]
    rids = {eng.submit(p, "interactive", max_new_tokens=5,
                       arrival_s=0.0): i for i, p in enumerate(prompts)}
    w = eng.class_params("interactive")
    responses = eng.drain()
    assert len(responses) == 4
    for r in responses:
        want = greedy_decode_reference(tmodel, w, prompts[rids[r.request_id]],
                                       5, b_kv=8, device="cpu")
        np.testing.assert_array_equal(r.tokens, want)


def test_speculative_engine_equals_batch_one(pair):
    """``SpeculativeDecodeEngine`` (drafts at 4 bits, lookahead 2, 2 slots,
    three prompts) delivers every stream bitwise the batch-1 reference of
    the target weights: speculative decode runs the dense and MoE decoders
    as the reference's does."""
    from repro_torch.runtime import SpeculativeDecodeEngine
    _, _, _, tmodel, tparams = pair
    cfg = tmodel.cfg
    eng = SpeculativeDecodeEngine(tmodel, tparams, SystemParams(**SYSP),
                                  classes=[QosClass("interactive", 3.5,
                                                    2.0)],
                                  auto=False, max_batch=2, max_new_tokens=4,
                                  device="cpu")
    eng.set_operating_point("interactive", 8, 8, b_draft=4, k=2)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(3, 20, 3)]
    rids = {eng.submit(p, "interactive", max_new_tokens=4,
                       arrival_s=0.0): i for i, p in enumerate(prompts)}
    w = eng.class_params("interactive")
    responses = eng.drain()
    assert len(responses) == 3
    for r in responses:
        want = greedy_decode_reference(tmodel, w, prompts[rids[r.request_id]],
                                       4, b_kv=8, device="cpu")
        np.testing.assert_array_equal(r.tokens, want)


def test_kernel_engine_matches_reference(pair):
    """The kernel-path ``CoInferenceEngine`` at b̂ = 8 and 4 (the dense
    three; an MoE model runs its agent on the fake path in both packages)
    against the JAX engine on one request: the agent path, logits at
    1e-4, wire bytes equal."""
    arch, jmodel, jparams, tmodel, tparams = pair
    jeng = JEngine(jmodel, jparams, JSystemParams(**SYSP), path="kernel",
                   cache_weights=True)
    teng = CoInferenceEngine(tmodel, tparams, SystemParams(**SYSP),
                             path="kernel", device="cpu")
    batch = _batch(tmodel.cfg, 6, b=1)
    for bits in (8, 4):
        jeng.configure(bits)
        teng.configure(bits)
        want_path = "fake" if arch in MOE else f"kernel-int{bits}"
        assert teng.agent_path == jeng.agent_path == want_path
        want, jstats = jeng.serve_batch(_j(batch))
        got, tstats = teng.serve_batch(batch)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert tstats.emb_bytes == jstats.emb_bytes


def test_registry_is_the_references(pair):
    """``get_config``/``get_smoke`` return the reference's configs field
    for field."""
    arch = pair[0]
    for ours, ref in ((get_config(arch), jget_config(arch)),
                      (get_smoke(arch), jget_smoke(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_and_trains(capsys, arch):
    """``launch.serve`` (the kernel path, the sequential engine) and
    ``launch.train`` take the arch with ``--smoke`` on the CPU, as the
    reference's CLIs do."""
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    assert serve_main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--path", "kernel", "--engine", "sequential",
                       "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert f"arch={get_smoke(arch).name}" in out
    assert train_main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "3", "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"arch={get_smoke(arch).name} ")
    assert "step     1 loss" in out and "loss " in out.splitlines()[-1]


@pytest.mark.parametrize("host,hosts", [(0, 1), (1, 2)])
def test_caption_proxy_dataset_is_the_references(host, hosts):
    """``CaptionProxyDataset`` (llava's data: visual embeds and noisy
    captions) draws the reference's batches and references bitwise: numpy
    streams only."""
    from repro.data.synthetic import CaptionProxyConfig as JConfig
    from repro.data.synthetic import CaptionProxyDataset as JDataset
    from repro_torch.data import CaptionProxyConfig, CaptionProxyDataset
    kw = dict(vocab_size=512, seq_len=12, d_model=64, n_vis=8,
              batch_size=3, n_images=50)
    ours = CaptionProxyDataset(CaptionProxyConfig(**kw), host, hosts)
    ref = JDataset(JConfig(**kw), host, hosts)
    for step in (0, 1, 7):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b) == ["embeds", "image_id", "labels",
                                          "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(ours.references(a["image_id"]),
                                      ref.references(b["image_id"]))
