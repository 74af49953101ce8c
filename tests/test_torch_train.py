"""The training path of the port against the JAX reference, on the CPU.

Parity tests start the port and the reference from one state carried
across by ``repro_torch.bridge`` (the reference's parameters, AdamW state
and error-feedback residuals as numpy arrays) and feed both the same
Markov-chain batches.  The reference runs its training arithmetic inside a
jitted step, so the port is held against ``jax.jit`` of each piece:

* loss and gradients of ``DecoderLM.loss`` at rtol 1e-4 (f32 sums in
  another order through four layers and their backward);
* ``AdamW.update`` at 1e-6;
* the schedules bitwise, except where XLA's and torch's float32 cosines
  differ in the last bit (then within two ulps of the cosine term);
* int8 error-feedback codes and residuals, and the STE forward, bitwise;
* ``Trainer.fit`` loss histories over 3 steps at rtol 1e-4.

The learning tests mirror ``tests/test_runtime.py``; then the CLI and the
paths that are not ported (exit code 2 or an exception).
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core import quantization as jq
from repro.data import MarkovLMConfig as JMarkovConfig
from repro.data import MarkovLMDataset as JMarkovDataset
from repro.data import ShardedLoader as JLoader
from repro.launch.mesh import make_host_mesh
from repro.models import layers as jL
from repro.models.registry import build_model
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.runtime import TrainConfig as JTrainConfig
from repro.runtime import Trainer as JTrainer
from repro.runtime.qat import fake_quantize_agent as jfake_quantize_agent
import torch.distributed as dist
from _torch_ranks import join_world, start_world
from repro_torch.bridge import params_from_jax, train_state_from_jax
from repro_torch.launch.mesh import init_ranks, make_mesh
from repro_torch.configs import get_smoke
from repro_torch.core import quantization as tq
from repro_torch.data import MarkovLMConfig, MarkovLMDataset, ShardedLoader
from repro_torch.launch.train import main as train_main
from repro_torch.models import layers as tL
from repro_torch.models.lm import DecoderLM, tree_leaves, tree_map
from repro_torch.optim import (AdamW, AdamWState, compress_tree,
                               compression_ratio, cosine_schedule,
                               global_norm, init_error_state,
                               linear_schedule)
from repro_torch.optim import grad_compress as tgc
from repro_torch.runtime import TrainConfig, Trainer
from repro_torch.runtime.qat import fake_quantize_agent

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH = "qwen2-0.5b"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    """The leaves of a nested dict in sorted-key order, as numpy."""
    return [leaf.detach().numpy() if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf) for leaf in tree_leaves(tree)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke model's ops are too small to share among threads, and
    the suite runs several test processes side by side: intra-op threads
    would only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_model():
    jcfg = jget_smoke(ARCH)
    jmodel = build_model(jcfg)
    return jmodel, _np(jmodel.init(jax.random.PRNGKey(0)))


def _batch(seq=32, batch=4, step=0):
    return MarkovLMDataset(MarkovLMConfig(
        vocab_size=get_smoke(ARCH).vocab_size, seq_len=seq,
        batch_size=batch)).batch_at(step)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_reference(ref_model, remat):
    jmodel, jparams = ref_model
    b = _batch()
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})
    params = tree_map(lambda p: p.requires_grad_(True),
                      params_from_jax(jparams, device="cpu"))
    loss = DecoderLM(get_smoke(ARCH)).loss(
        params, {k: torch.from_numpy(v) for k, v in b.items()}, remat=remat)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    got = _flat(tree_map(lambda p: p.grad, params))
    for g, w in zip(got, _flat(_np(jgrads))):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))


@pytest.mark.parametrize("chunk,mask", [(16, False), (16, True),
                                        (256, True)])
def test_chunked_cross_entropy_matches_reference(ref_model, chunk, mask):
    _, jparams = ref_model
    cfg = get_smoke(ARCH)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    m = (rng.random((2, 64)) > 0.3).astype(np.float32) if mask else None
    want = jL.chunked_cross_entropy(
        jget_smoke(ARCH), jnp.asarray(x), jparams["embed"],
        jnp.asarray(labels), None if m is None else jnp.asarray(m),
        chunk=chunk)
    emb = params_from_jax(jparams["embed"], device="cpu")
    got = tL.chunked_cross_entropy(
        cfg, torch.from_numpy(x), emb, torch.from_numpy(labels),
        None if m is None else torch.from_numpy(m), chunk=chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# optimizer, schedules, gradient compression
# ---------------------------------------------------------------------------

def test_adamw_update_matches_reference(ref_model):
    _, jparams = ref_model
    rng = np.random.default_rng(4)

    def like(scale):
        return jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape) * scale).astype(
                np.float32), jparams)

    grads, m, v = like(1e-2), like(1e-3), _np(jax.tree_util.tree_map(
        lambda a: np.abs(a), like(1e-4)))
    jopt = jadamw.AdamW(learning_rate=jadamw.cosine_schedule(3e-3, 5, 40))
    jstate = jadamw.AdamWState(step=jnp.int32(6), m=m, v=v)
    jp, js, jmet = jax.jit(jopt.update)(grads, jstate, jparams)

    topt = AdamW(learning_rate=cosine_schedule(3e-3, 5, 40))
    tparams, tstate, _ = train_state_from_jax(jparams, (6, m, v), 0.0,
                                              device="cpu")
    tp, ts, tmet = topt.update(params_from_jax(grads, device="cpu"), tstate,
                               tparams)
    assert int(ts.step) == int(js.step) == 7
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for g, w in zip(_flat(got), _flat(_np(want))):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-6)


def test_adamw_decays_only_matrices():
    p = {"w": torch.ones((2, 3)), "b": torch.ones((3,))}
    g = {"w": torch.zeros((2, 3)), "b": torch.zeros((3,))}
    opt = AdamW(learning_rate=0.1, weight_decay=0.5)
    new, state, met = opt.update(g, opt.init(p), p)
    assert torch.allclose(new["w"], torch.full((2, 3), 0.95))
    assert torch.equal(new["b"], p["b"])
    assert int(state.step) == 1 and float(met["grad_norm"]) == 0.0
    assert float(global_norm({"a": torch.full((4,), 2.0)})) == 4.0


@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 20, 137),
                                               (1e-3, 7, 1000),
                                               (3e-3, 0, 100)])
def test_schedules_match_jitted_reference(peak, warmup, total):
    steps = np.arange(0, 2 * total, dtype=np.int32)
    want = np.asarray(jax.jit(jadamw.linear_schedule(peak, warmup, total))(
        jnp.asarray(steps)))
    got = linear_schedule(peak, warmup, total)(torch.from_numpy(steps))
    np.testing.assert_array_equal(got.numpy(), want)

    want = np.asarray(jax.jit(jadamw.cosine_schedule(peak, warmup, total))(
        jnp.asarray(steps)))
    got = cosine_schedule(peak, warmup, total)(torch.from_numpy(steps))
    got = got.numpy()
    warm = steps < warmup
    np.testing.assert_array_equal(got[warm], want[warm])
    # the decay: XLA's and torch's cosf may differ in the last bit, which
    # the schedule scales by 0.45 * peak
    assert np.abs(got - want).max() <= peak * 2.0 ** -22


@pytest.mark.parametrize("shape,scale", [((64, 48), 1e-3),
                                         ((3, 96, 128), 1.0),
                                         ((151, 7), 1e-6), ((5,), 0.0)])
def test_compress_decompress_bitwise_vs_jitted_reference(shape, scale):
    rng = np.random.default_rng(int(np.prod(shape)))
    g = (rng.standard_normal(shape) * scale).astype(np.float32)
    err = (rng.standard_normal(shape) * scale * 1e-2).astype(np.float32)
    jh, je = jax.jit(jgc.compress_decompress)(g, err)
    th, te = tgc.compress_decompress(torch.from_numpy(g),
                                     torch.from_numpy(err))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    # the codes themselves
    jcodes, jscale = jax.jit(jgc._quantize_leaf)(g + err)
    tcodes, tscale = tgc._quantize_leaf(torch.from_numpy(g + err))
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    assert float(tscale) == float(jscale)


def test_compress_tree_and_error_state(ref_model):
    _, jparams = ref_model
    rng = np.random.default_rng(5)
    grads = jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 1e-2).astype(np.float32),
        jparams)
    jerr = jgc.init_error_state(jparams)
    jh, je = jax.jit(jgc.compress_tree)(grads, jerr)
    terr = init_error_state(params_from_jax(jparams, device="cpu"))
    th, te = compress_tree(params_from_jax(grads, device="cpu"), terr)
    for got, want in ((th, jh), (te, je)):
        for g, w in zip(_flat(got), _flat(_np(want))):
            np.testing.assert_array_equal(g, w)
    assert compression_ratio() == jgc.compression_ratio() == 4.0


# ---------------------------------------------------------------------------
# QAT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("gran", ["per-channel", "per-tensor", "per-group"])
def test_ste_forward_bitwise_vs_jitted_reference(bits, gran):
    w = np.random.default_rng(bits).standard_normal((96, 40)).astype(
        np.float32)
    w[:, 3] = 0.0                                   # an all-zero channel
    want = jax.jit(lambda x: jq.qat_quantize(
        x, jq.QuantConfig(bits=bits, granularity=gran, group_size=32)))(w)
    x = torch.from_numpy(w).requires_grad_(True)
    got = tq.qat_quantize(x, tq.QuantConfig(bits=bits, granularity=gran,
                                            group_size=32))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    # straight-through: the gradient is the identity
    up = torch.from_numpy(np.random.default_rng(9).standard_normal(
        w.shape).astype(np.float32))
    (grad,) = torch.autograd.grad(got, x, up)
    assert torch.equal(grad, up)


def test_fake_quantize_agent_ste_masks_agent_partition_only(ref_model):
    jmodel, jparams = ref_model
    cfg = get_smoke(ARCH)                       # split_layer = 1 of 4
    model = DecoderLM(cfg)
    qcfg = tq.QuantConfig(bits=4)
    params = tree_map(lambda p: p.requires_grad_(True),
                      params_from_jax(jparams, device="cpu"))
    q = fake_quantize_agent(params, model.logical_axes(), cfg, qcfg)
    wq, wq_q = params["layers"]["attn"]["wq"], q["layers"]["attn"]["wq"]
    assert not torch.equal(wq[0], wq_q[0])      # the agent layer
    for i in range(cfg.split_layer, cfg.n_layers):
        assert torch.equal(wq[i], wq_q[i])
    assert torch.equal(params["embed"]["tok"], q["embed"]["tok"])
    # bitwise the jitted reference's, and an identity gradient
    want = jax.jit(lambda p: jfake_quantize_agent(
        p, jmodel.logical_axes(), jget_smoke(ARCH),
        jq.QuantConfig(bits=4)))(jparams)
    for g, w in zip(_flat(q), _flat(_np(want))):
        np.testing.assert_array_equal(g, w)
    (grad,) = torch.autograd.grad(wq_q.sum(), wq)
    assert torch.equal(grad, torch.ones_like(wq))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _loaders(seq=32, batch=8):
    cfg = get_smoke(ARCH)
    jl = JLoader(JMarkovDataset(JMarkovConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch)))
    tl = ShardedLoader(MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch)),
        device="cpu")
    return jl, tl


@pytest.mark.parametrize("tc", [{}, dict(qat_bits=8,
                                         grad_compression="int8_ef")])
def test_fit_histories_match_reference(tc):
    jtr = JTrainer(build_model(jget_smoke(ARCH)),
                   jadamw.AdamW(learning_rate=3e-3), make_host_mesh(),
                   JTrainConfig(log_every=1, **tc))
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    state = train_state_from_jax(*_np(jstate), device="cpu")
    jl, tl = _loaders()
    _, jhist = jtr.fit(jl, 3, state=jstate)
    tr = Trainer(DecoderLM(get_smoke(ARCH)), AdamW(learning_rate=3e-3),
                 "cpu", TrainConfig(log_every=1, **tc))
    (params, opt_state, err), hist = tr.fit(tl, 3, state=state)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] \
        == [1, 2, 3]
    for h, jh in zip(hist, jhist):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(h[key], jh[key], rtol=1e-4)
    assert isinstance(opt_state, AdamWState) and int(opt_state.step) == 3
    assert tr.step == 3 and tl.step == 3


def _mk(**tc):
    cfg = get_smoke(ARCH)
    loader = ShardedLoader(MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=32, batch_size=8)),
        device="cpu")
    tr = Trainer(DecoderLM(cfg), AdamW(learning_rate=3e-3), "cpu",
                 TrainConfig(log_every=5, **tc))
    return tr, loader


def test_loss_decreases_on_markov_data():
    tr, loader = _mk()
    _, hist = tr.fit(loader, 40)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.1, hist


def test_qat_training_runs_and_learns():
    tr, loader = _mk(qat_bits=8)
    _, hist = tr.fit(loader, 30)
    assert np.isfinite(hist[-1]["loss"])
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_int8_ef_compression_training():
    tr, loader = _mk(grad_compression="int8_ef")
    (_, _, err), hist = tr.fit(loader, 30)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert any(bool((e != 0).any()) for e in tree_leaves(err))


def test_loader_places_batches_and_seeks():
    _, tl = _loaders(seq=16, batch=2)
    struct = tl.peek_structure()
    assert {k: (tuple(v.shape), v.dtype) for k, v in struct.items()} == {
        "tokens": ((2, 16), torch.int32), "labels": ((2, 16), torch.int32)}
    first = next(tl)
    tl.seek(0)
    assert torch.equal(next(tl)["tokens"], first["tokens"])
    assert tl.step == 1 and first["tokens"].device.type == "cpu"


# ---------------------------------------------------------------------------
# the CLI and what is not ported yet
# ---------------------------------------------------------------------------

def test_cli_smoke_improves():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "20"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("arch=qwen2-0.5b-smoke params=")
    assert "step     1 loss" in out.stdout and "step    20 loss" in out.stdout
    assert out.stdout.rstrip().endswith("(improved)"), out.stdout


@pytest.mark.parametrize("argv,what", [
    (["--arch", "xlstm-350m-v0"], "xlstm-350m"),
    (["--data", "3"], "--data 3")])
def test_cli_exits_2_on_what_is_not_ported(capsys, argv, what):
    """``--ckpt-dir`` is ported (see below), every arch of the reference
    (xlstm-350m trains: ``tests/test_torch_cli.py``) and data parallelism
    over ranks (``tests/test_torch_parallel.py``); an arch name the
    registry does not know, and a ``--data`` that does not divide the
    ranks (3 on this one rank), exit 2 with one line."""
    assert train_main(["--smoke", "--device", "cpu", *argv]) == 2
    err = capsys.readouterr().err
    assert what in err and len(err.strip().splitlines()) == 1
    assert ("unknown arch 'xlstm-350m-v0'" in err) == (argv[0] == "--arch")
    assert ("does not divide the 1 ranks" in err) == (argv[0] == "--data")
    assert not dist.is_initialized()       # the CLI left no group behind


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-1.5-large-398b"])
def test_cli_trains_the_recurrent_families(capsys, arch):
    """The CLI builds the model through ``models.registry.build_model``:
    the xLSTM and the hybrid train on its Markov data, as the reference's
    CLI trains them."""
    assert train_main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "3", "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"arch={get_smoke(arch).name} params=")
    assert "step     1 loss" in out
    assert out.splitlines()[-1].startswith("loss ")


def test_cli_refuses_the_encoder_decoder(capsys):
    """seamless-m4t-large-v2's loss needs frame embeddings that the CLI's
    Markov data does not give (the reference's CLI dies on a KeyError
    there): one line, exit 2.  ``Trainer`` trains it from batches that
    hold them (``tests/test_torch_encdec.py``)."""
    assert train_main(["--arch", "seamless-m4t-large-v2", "--smoke",
                       "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert len(err.strip().splitlines()) == 1
    assert "encoder-decoder" in err and "frame embeddings" in err


def test_cli_ckpt_dir_resumes(capsys, tmp_path):
    """``--ckpt-dir`` saves every ``--ckpt-every`` steps and a second run
    resumes from the newest checkpoint (its first logged step is 11)."""
    d = str(tmp_path / "ckpt")
    args = ["--smoke", "--device", "cpu", "--ckpt-dir", d,
            "--ckpt-every", "5"]
    assert train_main([*args, "--steps", "10"]) == 0
    assert "step    10 loss" in capsys.readouterr().out
    assert sorted(os.listdir(d)) == ["step_10", "step_5"]
    assert train_main([*args, "--steps", "5"]) == 0
    out = capsys.readouterr().out
    assert "step    11 loss" in out and "step     1 loss" not in out
    assert sorted(os.listdir(d)) == ["step_10", "step_15", "step_5"]


def test_trainer_raises_on_what_is_not_ported(tmp_path):
    """Interleaved MoE belongs to the hybrid model, whose MoE trainer over
    data-parallel ranks raises (ROADMAP A.7.2(b)); a decoder LM's MoE
    trainer at dp = 2 constructs, with its ranks' ``DataParallel``.
    Training over a mesh and compression over ``pod`` are ported: a mesh
    of one rank here (``axis_name="pod"`` over it is the one-device
    compression, bitwise), a mesh of two ranks in two processes."""
    model, opt = DecoderLM(get_smoke(ARCH)), AdamW()
    moe = dataclasses.replace(get_smoke(ARCH), n_experts=4,
                              experts_per_token=2, moe_every=2)
    with pytest.raises(ValueError, match="moe_every=1"):
        DecoderLM(moe)
    moe = DecoderLM(dataclasses.replace(moe, moe_every=1))
    Trainer(moe, opt, "cpu")
    world = start_world(2, [("mesh_of_two", {})], str(tmp_path), "two")
    init_ranks("cpu")
    try:
        if not torch.cuda.is_available():   # no device: the card, or raise
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make_mesh((1, 1, 1), ("pod", "data", "model"))
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"),
                         device="cpu")
        tr = Trainer(model, opt, mesh=mesh,
                     train_cfg=TrainConfig(grad_compression="int8_ef"))
        assert tr.device.type == "cpu" and tr.podwise
        Trainer(moe, opt, mesh=mesh)           # one rank: the MoE trains
        with pytest.raises(ValueError, match="axes"):
            Trainer(model, opt,
                    mesh=make_mesh((1,), ("data",), device="cpu"))
        g = {"a": torch.linspace(-1.0, 0.7, 9)}
        e = {"a": torch.full((9,), 1e-3)}
        want = compress_tree(g, e)
        got = compress_tree(g, e, axis_name="pod", mesh=mesh)
        for w, x in zip(tree_leaves(want), tree_leaves(got)):
            assert torch.equal(w, x)
        with pytest.raises(ValueError, match="a mesh with that axis"):
            compress_tree(g, e, axis_name="pod")
    finally:
        dist.destroy_process_group()
    (a,), (b,) = join_world(world)
    assert a["moe"] == (2, 0) and b["moe"] == (2, 1)
    assert a["hybrid"] == b["hybrid"] and "MoE training over 2 " \
        "data-parallel ranks is ported for the decoder-only LM, not " \
        "HybridLM" in a["hybrid"]
    assert [h["step"] for h in a["hist"]] == [1, 2]
    assert [h["loss"] for h in a["hist"]] == [h["loss"] for h in b["hist"]]
    for x, y in zip(a["params"], b["params"]):
        np.testing.assert_array_equal(x, y)
